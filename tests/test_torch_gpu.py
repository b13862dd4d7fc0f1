"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present (the ``cuda`` fixture decides, at run time).  The file imports
neither JAX nor the JAX package, so it runs on a machine with a GPU and
PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the conv kernels ``rtol 1e-4`` (float32 sums in another
order than cuBLAS's; at the wide shapes, images past 224 pixels and
weights past a block's shared memory, 1e-4 of each output's largest),
their backward bitwise on repeat; the HieAvg mix and the coefficient aggregates ``rtol 1e-5,
atol 1e-6`` (FMA contraction); a narrow (bfloat16 or float8_e4m3fn)
history one unit in the last place of its dtype (the float32 value it
rounds differs by the FMA's rounding); the float8 edge values, the SGD
update, zero-coefficient slots and the correct-counts exactly.  Flash
attention: float32 ``atol 2e-5`` (``tests/test_kernels.py``'s bound),
bfloat16 one unit in the last place beyond that bound (both versions
widen, sum in float32, which may differ by 2e-5 where a sum cancels to
near 0, and round once), rows that see no key exactly 0, at unit-scale and
at sharp (q scaled by 24) logits; each row's log-sum-exp of both designs
``rtol = atol = 1e-5`` of the plain version's (+inf where a row sees no
key), the output bitwise the same with or without it; at head dims no
kernel is built for (24, 40, 100: zero-padded to the next built one) the
same bounds, forward and backward, and a smoke MLA prefill (head dim 24)
through the kernel within ``3e-4`` of the plain logits.  The flash
backward: float32 ``rel 1e-4`` of each gradient's largest magnitude,
bfloat16 ``2^-7`` of it (one bfloat16 ulp at the top: both sum in float32
and round once), a row that sees no key dq exactly 0, bitwise on
repeat; float32 at head dim 256 too (its 32-row tiles).  The multi-leaf SGD update is bitwise
the plain version, one launch a call, with one scale or one a row; a
bfloat16 operand that breaks a TMA precondition raises before any
launch.  The multi-leaf HieAvg mix is
one launch a call at the bounds of the one-leaf one, and so are the
multi-leaf coefficient aggregates, bitwise on repeat.  The correct-count
at any number of classes equals the plain count up to the rows whose two
largest logits lie within float32 reach (``rel 1e-4``) of each other, and
is the same on repeat.  The conv wrapper splits more devices than the
grid's z extent across launches, at the conv bounds.  A TINY mixed sweep
with the kernels is within the engine-parity bounds of its plain run.  A
smoke-width llama-vision and seamless prefill (random memory, gates 0.5)
launches the flash kernel once a self-attention, cross-attention and
encoder layer, its logits within ``3e-4`` of their largest magnitude of
the plain version's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.hieavg import to_history_dtype  # noqa: E402
from repro_torch.fl.engine import train_epoch_body  # noqa: E402
from repro_torch.kernels.coef_agg import (coef_agg,  # noqa: E402
                                          coef_agg_many, coef_agg_pair,
                                          coef_agg_pair_many)
from repro_torch.kernels.conv3x3 import (MAX_DEVICES,  # noqa: E402
                                         conv3x3_bwd, conv3x3_fwd)
from repro_torch.kernels.eval_head import eval_head  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.ref import flash_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.hieavg_agg import (hieavg_agg,  # noqa: E402
                                            hieavg_agg_many)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.sgd_update import (MAX_LEAVES,  # noqa: E402
                                            sgd_update, sgd_update_many)
from repro_torch.models import cnn_specs, stack_params  # noqa: E402
from repro_torch.models.spec import init_params  # noqa: E402

pytestmark = pytest.mark.gpu

L_TAILS = [1, 7, 2047, 2049]


def t(a):
    return torch.from_numpy(np.asarray(a))


def np32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _hieavg_inputs(rng, n, length):
    w, prev = np32(rng, n, length), np32(rng, n, length)
    dmean = np32(rng, n, length, scale=0.1)
    mask = rng.random(n) > 0.4
    cp = rng.random(n).astype(np.float32)
    ce = ((1.0 - cp) * 0.3).astype(np.float32)
    nobs = np.arange(n, dtype=np.float32)
    return w, prev, dmean, mask, cp, ce, nobs


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: (D, B, H, W, Cin, Cout): tails of the tiling, a non-square image and a
#: channel count across the 4-channel chunk and 8-channel group edges
CONV_TAILS = ((1, 1, 5, 5, 1, 3), (2, 2, 12, 12, 4, 8), (1, 2, 16, 16, 3, 7),
              (1, 3, 7, 9, 5, 6), (1, 2, 10, 10, 33, 65))


def _conv_inputs(cuda, g, d, b, h, wd, cin, cout):
    x = torch.randn((d, b, h, wd, cin), generator=g, device=cuda)
    w = torch.randn((d, 3, 3, cin, cout), generator=g, device=cuda) \
        * (9 * cin) ** -0.5
    bias = torch.randn((d, cout), generator=g, device=cuda) * 0.1
    dy = torch.randn((d, b, h, wd, cout), generator=g, device=cuda)
    return x, w, bias, dy


def test_gpu_conv_kernels_match_plain(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    for shape in CONV_TAILS:
        x, w, b, dy = _conv_inputs(cuda, g, *shape)
        y = conv3x3_fwd(x, w, b, "cuda")
        want = conv3x3_fwd(x, w, b, "torch")
        torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)
        for need_dx in (True, False):
            got = conv3x3_bwd(x, w, want, dy, need_dx, "cuda")
            ref = conv3x3_bwd(x, w, want, dy, need_dx, "torch")
            assert (got[0] is None) == (not need_dx)
            for a, r in zip(got, ref):
                if r is not None:
                    torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


def test_gpu_conv_backward_is_bitwise_on_repeat(cuda):
    """No atomics: the same inputs give the same dx, dW and db bits."""
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    x, w, b, dy = _conv_inputs(cuda, g, 3, 8, 28, 28, 32, 64)
    y = conv3x3_fwd(x, w, b, "cuda")
    first = conv3x3_bwd(x, w, y, dy, True, "cuda")
    for _ in range(3):
        again = conv3x3_bwd(x, w, y, dy, True, "cuda")
        assert all(torch.equal(a, b_) for a, b_ in zip(first, again))


def test_gpu_local_step_launches_each_conv_kernel_once_a_layer(cuda):
    """One local SGD step of the engine: the forward and the backward
    kernel once per conv layer, one SGD update."""
    specs = cnn_specs(28, 1, 10, c1=32, c2=64)
    params = stack_params(init_params(specs, torch.Generator().manual_seed(0),
                                      device=cuda), 4)
    images = torch.rand((4, 1, 8, 28, 28, 1), device=cuda)
    labels = torch.randint(0, 10, (4, 1, 8), device=cuda)
    build.reset_launch_counts()
    train_epoch_body(params, images, labels, 0.01, "auto")
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"conv3x3_fwd": 2, "conv3x3_bwd": 2,
                                    "sgd_update": 1}


def test_gpu_elementwise_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    for length in L_TAILS:
        w, g = t(np32(rng, 3, length)).to(cuda), t(np32(rng, 3, length)).to(cuda)
        assert torch.equal(sgd_update(w, g, 0.37, "cuda"),
                           sgd_update(w, g, 0.37, "torch"))
        args = [t(a)[None].to(cuda) for a in _hieavg_inputs(rng, 5, length)]
        for got, ref in zip(hieavg_agg(*args, mode="cuda"),
                            hieavg_agg(*args, mode="torch")):
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
        c = t(rng.random((1, 5)).astype(np.float32)).to(cuda)
        torch.testing.assert_close(coef_agg(args[0], c, "cuda"),
                                   coef_agg(args[0], c, "torch"),
                                   rtol=1e-5, atol=1e-6)


def test_gpu_eval_head_matches_plain(cuda):
    rng = np.random.default_rng(1)
    for m in (1, 257, 1000):
        feats = t(rng.random((m, 12544), dtype=np.float32)).to(cuda)
        wmat = t(np32(rng, 12544, 10, scale=0.01)).to(cuda)
        bias = t(np32(rng, 10, scale=0.1)).to(cuda)
        labels = t(rng.integers(-1, 10, m).astype(np.int32)).to(cuda)
        assert int(eval_head(feats, wmat, bias, labels, "cuda")) == \
            int(eval_head(feats, wmat, bias, labels, "torch"))


def test_gpu_coef_agg_pair_matches_plain(cuda):
    rng = np.random.default_rng(2)
    for b, length in ((1, 1), (5, 7), (5, 2047), (1, 2049), (5, 18432)):
        w, aux = (t(np32(rng, b, 5, length)).to(cuda) for _ in range(2))
        m = rng.random((b, 5)) > 0.4
        c = rng.random((b, 5)).astype(np.float32)
        ca, cb = t(c * m).to(cuda), t(c * ~m).to(cuda)
        torch.testing.assert_close(coef_agg_pair(w, aux, ca, cb, "cuda"),
                                   coef_agg_pair(w, aux, ca, cb, "torch"),
                                   rtol=1e-5, atol=1e-6)
    # a zero-coefficient slot adds exactly nothing, whatever it holds
    w, aux = (t(np32(rng, 1, 5, 300)).to(cuda) for _ in range(2))
    ca = torch.tensor([[0.5, 0.0, 0.2, 0.0, 0.0]], device=cuda)
    cb = torch.tensor([[0.0, 0.3, 0.0, 0.0, 0.0]], device=cuda)
    w2, aux2 = w.clone(), aux.clone()
    w2[:, [1, 3, 4]] = 1e6
    aux2[:, [0, 2, 3, 4]] = 1e6
    assert torch.equal(coef_agg_pair(w, aux, ca, cb, "cuda"),
                       coef_agg_pair(w2, aux2, ca, cb, "cuda"))


#: mantissa bits and least normal exponent of the narrow history dtypes
NARROW = {torch.bfloat16: (7, -126), torch.float8_e4m3fn: (3, -6)}


def _ulps(got, want, dtype, atol=0.0):
    """max (|got - want| - atol) in ulps of ``dtype`` at the larger
    magnitude."""
    g, w = got.float(), want.float()
    mant, emin = NARROW[dtype]
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** emin)
    return (((g - w).abs() - atol).clamp(min=0.0)
            / torch.exp2(torch.floor(torch.log2(mag)) - mant)).max().item()


@pytest.mark.parametrize("dtype", list(NARROW), ids=["bf16", "f8"])
def test_gpu_hieavg_agg_narrow_history_matches_plain(cuda, dtype):
    rng = np.random.default_rng(3)
    for length in L_TAILS:
        args = [t(a)[None].to(cuda) for a in _hieavg_inputs(rng, 5, length)]
        args[1], args[2] = (to_history_dtype(a, dtype) for a in args[1:3])
        got = hieavg_agg(*args, mode="cuda")
        want = hieavg_agg(*args, mode="torch")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == dtype
            assert _ulps(g, w, dtype) <= 1.0
    # a present slot stores w itself: the kernel rounds the float8 edge
    # values as the cast helper (and jnp.astype) does, NaN past 464
    edges = torch.tensor([448.0, 464.0, 464.01, -464.01, 480.0, float("inf"),
                          float("-inf"), float("nan"), 2.0 ** -9, 2.0 ** -10,
                          3 * 2.0 ** -11, 7 * 2.0 ** -10], device=cuda)
    zero = to_history_dtype(torch.zeros((1, 1, len(edges)), device=cuda),
                            dtype)
    one = torch.ones((1, 1), device=cuda)
    _, nprev, ndmean = hieavg_agg(edges[None, None], zero, zero, one > 0, one,
                                  one * 0, one * 0, mode="cuda")
    want = to_history_dtype(edges, dtype).float()
    for got in (nprev, ndmean):
        g = got.float()[0, 0]
        assert bool(((g == want) | (g.isnan() & want.isnan())).all()), \
            (g.tolist(), want.tolist())


#: (Sq, Skv), Dh, (H, Hkv), causal, window: the tile tails of every head
#: dim the kernels are built for (float32: 64-row tiles; bfloat16: 128 query
#: rows a block, 128 kv rows a tile, a ring of two stages), GQA groups 1 to
#: 4, q read through strides in every case
FLASH_CASES = [((1, 256), 64, (4, 4), True, None),
               ((300, 300), 80, (8, 2), True, 100),
               ((65, 129), 128, (4, 1), False, None),
               ((512, 1000), 32, (4, 2), True, 256),
               ((300, 300), 80, (8, 2), False, 64),
               # one past a bf16 block and tile, each head dim
               ((129, 129), 32, (2, 2), True, None),
               ((129, 129), 64, (4, 2), False, None),
               ((129, 129), 80, (4, 1), True, 100),
               ((129, 129), 128, (2, 1), False, 64),
               # one query row, a long kv
               ((1, 1000), 80, (8, 2), True, 4096),
               ((1, 129), 128, (2, 2), False, None),
               # kv of 3 and 5 tiles: not a whole number of ring stages
               ((100, 384), 80, (4, 2), True, None),
               ((200, 640), 64, (4, 1), False, 300),
               # the cross-attention and encoder shapes at reduced lengths
               # (chip_smoke.py's FLASH_MODEL): llama-vision's Dh 128,
               # G 4, kv 1601 -> 257; seamless's Dh 64, G 1, 1500 -> 129
               ((300, 257), 128, (8, 2), False, None),
               ((129, 129), 64, (4, 4), False, None),
               ((200, 129), 64, (4, 4), False, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_matches_plain(cuda, dtype):
    rng = np.random.default_rng(4)
    for (sq, skv), dh, (h, hkv), causal, window in FLASH_CASES:
        # q is a slice of a wider tensor: the kernel reads it by strides
        q = t(np32(rng, 2, sq, 2 * h, dh)).to(cuda, dtype)[:, :, :h]
        k, v = (t(np32(rng, 2, skv, hkv, dh)).to(cuda, dtype)
                for _ in range(2))
        kw = dict(causal=causal, window=window,
                  q_offset=skv - sq if causal else 0)
        got = flash_attention(q, k, v, mode="cuda", **kw)
        want = flash_attention(q, k, v, mode="torch", **kw)
        assert got.dtype == dtype and got.shape == (2, sq, h, dh)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        else:
            assert _ulps(got, want, dtype, atol=2e-5) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_sharp_logits_match_plain(cuda, dtype):
    """Logits in the hundreds (q scaled by 24, as the serving model's random
    weights make them), where a few ulps of a logit move the output: the
    same bounds as above."""
    rng = np.random.default_rng(7)
    for (sq, skv), dh, (h, hkv), causal, window in FLASH_CASES[1:6]:
        q = t(np32(rng, 2, sq, h, dh, scale=24.0)).to(cuda, dtype)
        k, v = (t(np32(rng, 2, skv, hkv, dh)).to(cuda, dtype)
                for _ in range(2))
        kw = dict(causal=causal, window=window,
                  q_offset=skv - sq if causal else 0)
        got = flash_attention(q, k, v, mode="cuda", **kw)
        want = flash_attention(q, k, v, mode="torch", **kw)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        else:
            assert _ulps(got, want, dtype, atol=2e-5) <= 1.0


def test_gpu_flash_attention_bf16_refuses_what_tma_cannot_load(cuda):
    """An operand that breaks a TMA precondition raises before any launch:
    q whose storage is offset by one element (2 bytes), and k whose
    sequence stride is no multiple of 16 bytes."""
    q = torch.zeros(2 * 64 * 4 * 80 + 1, device=cuda,
                    dtype=torch.bfloat16)[1:].view(2, 64, 4, 80)
    k = torch.zeros(2, 64, 2, 84, device=cuda, dtype=torch.bfloat16)
    k = k[..., :80]
    good = torch.zeros(2, 64, 2, 80, device=cuda, dtype=torch.bfloat16)
    before = build.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, good, good, mode="cuda")
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_attention(q.clone(), k, good, mode="cuda")
    assert build.LAUNCHES["flash_attention"] == before


def test_gpu_flash_attention_bwd_bf16_refuses_what_tma_cannot_load(cuda):
    """The bfloat16 backward loads q, k, v and do by TMA too: a q or a
    contiguous do offset by one element raises before any launch."""
    def offset(*shape):
        n = int(np.prod(shape))
        return torch.zeros(n + 1, device=cuda,
                           dtype=torch.bfloat16)[1:].view(*shape)
    q, do = (torch.zeros(2, 64, 4, 80, device=cuda, dtype=torch.bfloat16)
             for _ in range(2))
    k = torch.zeros(2, 64, 2, 80, device=cuda, dtype=torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, k, lse=True, mode="cuda")
    before = build.LAUNCHES["flash_attention_bwd"]
    for qq, dd in ((offset(2, 64, 4, 80), do), (q, offset(2, 64, 4, 80))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention_bwd(qq, k, k, o, lse, dd, mode="cuda")
    assert build.LAUNCHES["flash_attention_bwd"] == before


#: the paper's CNN leaves at DEFAULT width (c1 32, c2 64, 10 classes,
#: 28x28), D = 25 devices: 144266 parameters in six leaves
CNN_LEAVES = [(25, 3, 3, 1, 32), (25, 32), (25, 3, 3, 32, 64), (25, 64),
              (25, 12544, 10), (25, 10)]


def test_gpu_sgd_update_per_row_scale_is_one_bitwise_launch(cuda):
    """One scale a leading row (a sweep's points x devices): bitwise the
    plain version, one launch, a zero row exactly its w whatever its
    gradient, a leaf of 10 columns a row (b3) and of 1 among them."""
    g = torch.Generator(device=cuda)
    g.manual_seed(9)
    leaves = [(50,) + s[1:] for s in CNN_LEAVES] + [(50, 1), (50, 7)]
    ws = [torch.randn(s, generator=g, device=cuda) for s in leaves]
    gs = [torch.randn(s, generator=g, device=cuda) * 1e3 for s in leaves]
    scale = torch.rand((50,), generator=g, device=cuda) * 0.01
    scale[::3] = 0.0
    before = dict(build.LAUNCHES)
    got = sgd_update_many(ws, gs, scale, "cuda")
    assert build.LAUNCHES["sgd_update[rows]"] == \
        before.get("sgd_update[rows]", 0) + 1
    assert build.LAUNCHES["sgd_update"] == before.get("sgd_update", 0)
    for a, b, w in zip(got, sgd_update_many(ws, gs, scale, "torch"), ws):
        assert a.shape == w.shape and torch.equal(a, b)
        assert torch.equal(a[::3], w[::3])
    # one scale in every row is the host-float launch, bitwise
    same = sgd_update_many(ws, gs, torch.full((50,), 0.00095238,
                                              device=cuda), "cuda")
    for a, b in zip(same, sgd_update_many(ws, gs, 0.00095238, "cuda")):
        assert torch.equal(a, b)


def test_gpu_mixed_sweep_kernels_match_plain(cuda):
    """A TINY sweep mixing HieAvg, delayed-gradient and FedAvg points with
    ragged round counts and a point of its own lr, on the card with the
    kernels and with the plain versions: the engine-parity bounds, clock
    and energy equal, and every kernel of the path launched (the SGD
    update with one scale a row among them)."""
    import dataclasses

    from repro_torch.configs import REDUCED
    from repro_torch.fl import run_sweep
    tiny = dataclasses.replace(REDUCED, t_global_rounds=3, n_edges=3,
                               j_per_edge=3, image_hw=8)
    ovs = [{"aggregation": a, "straggler_frac": f}
           for a in ("hieavg", "delayed_grad", "fedavg") for f in (0.2, 0.4)]
    ovs += [{"t_global_rounds": 4, "j_per_edge": [1, 2, 3]}, {"lr0": 0.05}]
    kw = dict(n_train=300, n_test=100, steps_per_epoch=2,
              bucket_cost="proxy", device="cuda")
    build.reset_launch_counts()
    got = run_sweep(tiny, overrides=ovs, kernel_mode="auto", **kw)
    launches = dict(build.LAUNCHES)
    ref = run_sweep(tiny, overrides=ovs, kernel_mode="torch", **kw)
    for k in ("conv3x3_fwd", "conv3x3_bwd", "sgd_update", "sgd_update[rows]",
              "hieavg_agg", "coef_agg", "coef_agg_pair", "eval_head"):
        assert launches.get(k, 0) > 0, (k, launches)
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=0.02)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm, rtol=0.01,
                               atol=1e-4)
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)


def test_gpu_sgd_update_many_is_one_bitwise_launch(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(6)
    ws = [torch.randn(s, generator=g, device=cuda) for s in CNN_LEAVES]
    gs = [torch.randn(s, generator=g, device=cuda) for s in CNN_LEAVES]
    before = build.LAUNCHES["sgd_update"]
    got = sgd_update_many(ws, gs, 0.00095238, "cuda")
    assert build.LAUNCHES["sgd_update"] == before + 1
    for a, b, w in zip(got, sgd_update_many(ws, gs, 0.00095238, "torch"),
                       ws):
        assert a.shape == w.shape and torch.equal(a, b)
    # scale 0 is an exact identity, whatever the gradient holds
    same = sgd_update_many(ws, [x * 1e30 for x in gs], 0.0, "cuda")
    assert all(torch.equal(a, w) for a, w in zip(same, ws))
    assert build.LAUNCHES["sgd_update"] == before + 2
    # one launch takes at most MAX_LEAVES leaves, refused before launching
    many = [ws[1]] * (MAX_LEAVES + 1)
    with pytest.raises(ValueError, match="at most"):
        sgd_update_many(many, many, 0.1, "cuda")
    assert build.LAUNCHES["sgd_update"] == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_rows_without_keys_are_zero(cuda, dtype):
    rng = np.random.default_rng(5)
    q, k, v = (t(np32(rng, 1, 40, 2, 80)).to(cuda, dtype) for _ in range(3))
    got = flash_attention(q, k, v, causal=True, q_offset=-10, mode="cuda")
    want = flash_attention(q, k, v, causal=True, q_offset=-10, mode="torch")
    assert torch.equal(got[:, :10], torch.zeros_like(got[:, :10]))
    assert torch.equal(want[:, :10], got[:, :10])
    assert got[:, 10:].abs().max().item() > 0.1


@pytest.mark.parametrize("dtype", [torch.float32, *NARROW],
                         ids=["f32", "bf16", "f8"])
def test_gpu_hieavg_agg_many_is_one_launch_for_every_leaf(cuda, dtype):
    """The CNN's six leaves at DEFAULT width (B = n = 5), the tile tails and
    leaves whose rows miss the 16-byte path (odd lengths, an address one
    element off) in one launch, each leaf within the one-leaf bounds."""
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    lead = (5, 5)
    shapes = [s[1:] for s in CNN_LEAVES] + [(L,) for L in L_TAILS] + \
        [(33,), (3, 3, 3), (4, 2)]
    ws, prevs, dmeans = [], [], []
    for s in shapes:
        ws.append(torch.randn(lead + s, generator=g, device=cuda))
        prevs.append(to_history_dtype(
            torch.randn(lead + s, generator=g, device=cuda), dtype))
        dmeans.append(to_history_dtype(
            torch.randn(lead + s, generator=g, device=cuda) * 0.1, dtype))
    # an operand one element off 16 bytes takes the one-column path
    base = torch.randn(5 * 5 * 8 + 1, generator=g, device=cuda)
    ws[-1] = base[1:].view(lead + (4, 2))
    mask = torch.rand(lead, generator=g, device=cuda) > 0.4
    coef = torch.rand(lead, generator=g, device=cuda)
    nobs = torch.floor(torch.rand(lead, generator=g, device=cuda) * 6)
    args = (ws, prevs, dmeans, mask, coef * mask, coef * ~mask, nobs)
    before = build.LAUNCHES["hieavg_agg"]
    got = hieavg_agg_many(*args, mode="cuda")
    assert build.LAUNCHES["hieavg_agg"] == before + 1
    want = hieavg_agg_many(*args, mode="torch")
    for k, w in enumerate(ws):
        assert got[0][k].shape == want[0][k].shape == lead[:1] + w.shape[2:]
        torch.testing.assert_close(got[0][k], want[0][k], rtol=1e-5,
                                   atol=1e-6)
        for a, b in ((got[1][k], want[1][k]), (got[2][k], want[2][k])):
            assert a.shape == w.shape and a.dtype == dtype
            if dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            else:
                assert _ulps(a, b, dtype) <= 1.0
    # each output kind is views of one allocation
    for outs in got:
        assert len({o.untyped_storage().data_ptr() for o in outs}) == 1


@pytest.mark.parametrize("lead", [(5, 5), (5,)], ids=["edges", "global"])
@pytest.mark.parametrize("kind", ["single", "pair"])
def test_gpu_coef_agg_many_is_one_launch_for_every_leaf(cuda, kind, lead):
    """The CNN's six leaves at DEFAULT width (B = n = 5 at the edge layer,
    B = 1, n = 5 at the global one), the tile tails and leaves whose rows
    miss the 16-byte path (odd lengths, an address one element off) in one
    launch, each leaf within the one-leaf bounds, bitwise on repeat."""
    g = torch.Generator(device=cuda)
    g.manual_seed(8)
    shapes = [s[1:] for s in CNN_LEAVES] + [(L,) for L in L_TAILS] + \
        [(33,), (3, 3, 3), (4, 2)]
    ops_ = [[torch.randn(lead + s, generator=g, device=cuda) for s in shapes]
            for _ in range(1 if kind == "single" else 2)]
    # an operand one element off 16 bytes takes the one-column path
    base = torch.randn(5 * 5 * 8 + 1, generator=g, device=cuda)
    ops_[-1][-1] = base[1:1 + 8 * int(np.prod(lead))].view(lead + (4, 2))
    c = torch.rand(lead, generator=g, device=cuda)
    m = torch.rand(lead, generator=g, device=cuda) > 0.4
    if kind == "single":
        fn, coefs, name = coef_agg_many, (c,), "coef_agg"
    else:
        fn, coefs, name = coef_agg_pair_many, (c * m, c * ~m), "coef_agg_pair"
    before = build.LAUNCHES[name]
    got = fn(*ops_, *coefs, mode="cuda")
    assert build.LAUNCHES[name] == before + 1
    want = fn(*ops_, *coefs, mode="torch")
    for k, w in enumerate(ops_[0]):
        assert got[k].shape == want[k].shape == lead[:-1] + w.shape[len(lead):]
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
    # the outputs are views of one allocation, and the same on repeat
    assert len({o.untyped_storage().data_ptr() for o in got}) == 1
    assert all(torch.equal(a, b)
               for a, b in zip(got, fn(*ops_, *coefs, mode="cuda")))


@pytest.mark.parametrize("c", [1, 10, 16, 17, 100, 1000])
def test_gpu_eval_head_any_classes_matches_plain(cuda, c):
    """The count at any C equals the plain one up to the ambiguous rows,
    and is bitwise the same on repeat (no float atomics)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(c)
    f = 12544
    wmat = torch.randn((f, c), generator=g, device=cuda) * f ** -0.5
    bias = torch.randn((c,), generator=g, device=cuda) * 0.1
    for m in (1, 7, 257, 1000, 10000):
        feats = torch.rand((m, f), generator=g, device=cuda)
        labels = torch.randint(-1, c, (m,), generator=g, device=cuda)
        z = feats.double() @ wmat.double() + bias.double()
        labels[::3] = torch.argmax(z, -1)[::3]   # a third of them right
        if c > 1:
            top = torch.topk(z, 2, dim=-1).values
            amb = int(((top[:, 0] - top[:, 1])
                       <= 1e-4 * z.abs().amax(-1)).sum())
        else:
            amb = 0
        got = eval_head(feats, wmat, bias, labels, "cuda")
        assert got.dtype == torch.int64 and got.dim() == 0
        want = int(eval_head(feats, wmat, bias, labels, "torch"))
        assert abs(int(got) - want) <= amb, (m, int(got), want, amb)
        for _ in range(2):
            assert torch.equal(eval_head(feats, wmat, bias, labels, "cuda"),
                               got)


def test_gpu_conv_splits_devices_past_the_grid_limit(cuda):
    """D = MAX_DEVICES + 2 on a tiny image: two launches a pass, each
    device's result that of the plain version."""
    g = torch.Generator(device=cuda)
    g.manual_seed(8)
    x, w, b, dy = _conv_inputs(cuda, g, MAX_DEVICES + 2, 1, 3, 3, 1, 4)
    before = dict(build.LAUNCHES)
    y = conv3x3_fwd(x, w, b, "cuda")
    torch.testing.assert_close(y, conv3x3_fwd(x, w, b, "torch"), rtol=1e-4,
                               atol=1e-5)
    got = conv3x3_bwd(x, w, y, dy, True, "cuda")
    for a, r in zip(got, conv3x3_bwd(x, w, y, dy, True, "torch")):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    for name in ("conv3x3_fwd", "conv3x3_bwd"):
        assert build.LAUNCHES[name] == before.get(name, 0) + 2


def _conv_matches_plain(cuda, seed, shape):
    """The forward and the backward (with dx) at ``shape`` within ``rel
    1e-4`` of the plain versions: max |got - want| at most 1e-4 of
    max |want| (``chip_smoke.py``'s bound; at 128 -> 256 channels a dW
    entry sums 3136 products, whose cancellation leaves a few entries near
    0 where an elementwise ``rtol`` reads the summation order)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    x, w, b, dy = _conv_inputs(cuda, g, *shape)
    y = conv3x3_fwd(x, w, b, "cuda")
    want = conv3x3_fwd(x, w, b, "torch")
    got = (y, *conv3x3_bwd(x, w, want, dy, True, "cuda"))
    ref = (want, *conv3x3_bwd(x, w, want, dy, True, "torch"))
    for a, r in zip(got, ref):
        err = (a - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), (shape, err)


def test_gpu_conv_runs_images_wider_than_224(cuda):
    """225 and 256 pixels a row: each row split into column segments of at
    most 32 groups of 7 pixels, each with its own halo columns; one input
    channel (the first layer's streamed CK-1 instance) among them."""
    for shape in ((1, 1, 3, 225, 2, 4), (2, 3, 5, 256, 8, 16),
                  (2, 3, 5, 256, 1, 8)):
        _conv_matches_plain(cuda, 9, shape)


def test_gpu_conv_runs_weights_too_wide_for_shared_memory(cuda):
    """4096 input channels: a block's [9 * Cin, 64] slice of w is 9.4 MB,
    streamed a chunk of channels a stage; and the paper's second layer
    at 128 -> 256 channels (its dx and dW past a block's resident limit)."""
    for shape in ((1, 1, 3, 3, 4096, 64), (2, 4, 28, 28, 128, 256)):
        _conv_matches_plain(cuda, 10, shape)


def test_gpu_conv_wide_backward_is_bitwise_on_repeat(cuda):
    """The wide shapes' backward (column segments, streamed weights, the
    dW pass's channel windows and row segments): no atomics, the same dx,
    dW and db bits on repeat."""
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    for shape in ((2, 4, 96, 96, 32, 64), (2, 4, 28, 28, 128, 256),
                  (1, 2, 9, 230, 3, 5), (1, 1, 3, 3, 4096, 64),
                  (2, 3, 5, 256, 1, 8)):
        x, w, b, dy = _conv_inputs(cuda, g, *shape)
        y = conv3x3_fwd(x, w, b, "cuda")
        first = conv3x3_bwd(x, w, y, dy, True, "cuda")
        again = conv3x3_bwd(x, w, y, dy, True, "cuda")
        assert all(torch.equal(a, b_) for a, b_ in zip(first, again)), shape


#: the backward's cases: ((Sq, Skv), Dh, (H, Hkv), causal, window,
#: q_offset): every head dim, tails of the 64-row tiles and, at Dh 80 with
#: G = 4, of the bf16 design's 64- and 128-row tiles (127, 129, 257) under
#: windows that are no multiple of a tile, GQA groups 1 and 4, a chunked
#: prefill's offset and rows that see no key, before and after the ones
#: that do (chip_smoke.py's FLASH_BWD_CASES)
FLASH_BWD_CASES = [((100, 100), 32, (4, 4), True, None, 0),
                   ((129, 129), 64, (8, 2), True, 50, 0),
                   ((65, 130), 80, (4, 1), False, None, 0),
                   ((130, 130), 128, (2, 2), False, 64, 0),
                   ((70, 200), 80, (8, 2), True, 40, 130),
                   ((64, 64), 80, (4, 1), True, None, -10),
                   ((1, 300), 64, (4, 1), True, 100, 299),
                   ((127, 127), 80, (8, 2), True, None, 0),
                   ((129, 129), 80, (8, 2), True, 100, 0),
                   ((257, 257), 80, (8, 2), True, 150, 0),
                   ((129, 257), 80, (8, 2), True, 100, 128),
                   ((257, 129), 80, (4, 1), False, 90, 0),
                   ((257, 127), 80, (8, 2), True, 70, 5),
                   ((300, 257), 128, (8, 2), False, None, 0),
                   ((129, 129), 64, (4, 4), False, None, 0),
                   ((200, 129), 64, (4, 4), False, None, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_lse_matches_plain(cuda, dtype):
    """Both forward designs' lse against the plain version's, +inf on rows
    that see no key; the output bitwise the same without lse."""
    rng = np.random.default_rng(11)
    for (sq, skv), dh, (h, hkv), causal, window, off in FLASH_BWD_CASES:
        q, k, v = (t(np32(rng, 2, n, hh, dh)).to(cuda, dtype)
                   for n, hh in ((sq, h), (skv, hkv), (skv, hkv)))
        kw = dict(causal=causal, window=window, q_offset=off)
        o, lse = flash_attention_fwd(q, k, v, lse=True, mode="cuda", **kw)
        _, want = flash_attention_fwd(q, k, v, lse=True, mode="torch", **kw)
        assert lse.shape == (2, h, sq) and lse.dtype == torch.float32
        assert torch.equal(torch.isinf(lse), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(lse[fin], want[fin], rtol=1e-5, atol=1e-5)
        assert torch.equal(o, flash_attention(q, k, v, mode="cuda", **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_bwd_matches_plain(cuda, dtype):
    rng = np.random.default_rng(12)
    for (sq, skv), dh, (h, hkv), causal, window, off in FLASH_BWD_CASES:
        q = t(np32(rng, 2, sq, 2 * h, dh)).to(cuda, dtype)[:, :, :h]
        k, v = (t(np32(rng, 2, skv, hkv, dh)).to(cuda, dtype)
                for _ in range(2))
        do = t(np32(rng, 2, sq, h, dh)).to(cuda, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        o, lse = flash_attention_fwd(q, k, v, lse=True, mode="cuda", **kw)
        before = build.LAUNCHES["flash_attention_bwd"]
        got = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        assert build.LAUNCHES["flash_attention_bwd"] == before + 3
        # the plain backward gets the plain forward's output and lse, so
        # that a wrong lse cannot scale both sides alike
        o_ref, lse_ref = flash_attention_fwd(q, k, v, lse=True,
                                             mode="torch", **kw)
        want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            err = (g.float() - w.float()).abs().max().item()
            assert err <= rel * w.float().abs().max().item(), \
                ((sq, skv, dh, h, hkv, causal, window, off), err)
        unseen = torch.isinf(lse_ref).permute(0, 2, 1)  # rows that see no key
        assert bool((got[0][unseen] == 0).all())
        again = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gpu_flash_attention_function_runs_the_kernels(cuda):
    """Autograd through ``ops.flash_attention``: one forward and three
    backward launches, the gradients those of the backward wrapper."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(13)
    q, k, v = (t(np32(rng, 1, 96, n, 64)).to(cuda, torch.bfloat16)
               .requires_grad_() for n in (8, 2, 2))
    do = t(np32(rng, 1, 96, 8, 64)).to(cuda, torch.bfloat16)
    build.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=32)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert dict(build.LAUNCHES) == {"flash_attention": 1,
                                    "flash_attention_bwd": 3}
    o, lse = flash_attention_fwd(q.detach(), k.detach(), v.detach(),
                                 causal=True, window=32, lse=True)
    want = flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                               do, causal=True, window=32)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


@pytest.mark.parametrize("arch,want", [("llama-3.2-vision-11b", 5),
                                       ("seamless-m4t-large-v2", 4)])
def test_gpu_cross_attention_prefill_launches_the_flash_kernel(cuda, arch,
                                                               want):
    """A smoke-width prefill with random memory and gates 0.5 on the card:
    one flash launch for every self-attention, cross-attention and
    encoder layer (llama-vision 4 + 1; seamless 1 + 1 and its encoder's
    2), logits within 3e-4 of their largest magnitude of the plain
    version's (``tests/test_torch_serve.py``'s bound)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.inputs import memory_shape
    from repro_torch.models import cache_specs, init_from_specs, param_specs
    from repro_torch.models.transformer import prefill
    cfg = get_smoke(arch)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    params = init_from_specs(param_specs(cfg), g, cuda)
    for unit in params["unit"].values():
        if "xattn_gate" in unit["mixer"]:
            unit["mixer"]["xattn_gate"].fill_(0.5)
    mem = torch.randn((2,) + memory_shape(cfg), generator=g, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=cuda)
    out = {}
    for mode in ("cuda", "torch"):
        caches = init_from_specs(cache_specs(cfg, 2, 40, torch.float32),
                                 None, cuda)
        build.reset_launch_counts()
        out[mode] = prefill(params, tokens, cfg, caches, memory_embeds=mem,
                            kernel_mode=mode)[0]
        launches = dict(build.LAUNCHES)
        assert launches == ({"flash_attention": want} if mode == "cuda"
                            else {}), launches
    want_l = out["torch"]
    assert (out["cuda"] - want_l).abs().max().item() \
        <= 3e-4 * want_l.abs().max().item()


#: multi-head latent attention's head dims (minicpm3 64 + 32, deepseek-v2
#: 128 + 64; the bf16 forward takes 64-row kv tiles above Dh 128, the bf16
#: backward's dk/dv a dV and a dK pass) and grok's group of 6: query and kv
#: lengths no multiple of a tile, causal and not, a window, a chunked
#: prefill's offset and rows that see no key (chip_smoke.py's
#: FLASH_MLA_CASES)
FLASH_MLA_CASES = [((300, 300), 96, (8, 8), True, None, 0),
                   ((129, 257), 96, (4, 4), False, None, 0),
                   ((257, 129), 96, (8, 2), True, 70, 5),
                   ((257, 127), 128, (12, 2), True, None, 130),
                   ((65, 130), 192, (4, 1), False, None, 0),
                   ((300, 300), 192, (4, 4), True, None, 0),
                   ((129, 257), 192, (8, 2), True, 100, 128),
                   ((64, 64), 192, (4, 1), True, None, -10),
                   ((1, 300), 192, (4, 1), True, None, 299)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_mla_head_dims_match_plain(cuda, dtype):
    """The forward (output, lse) and the backward at head dims 96 and 192
    and at G = 6, at the bounds of the cases above, in float32 (the FMA
    kernels' shared memory fits at both: 164608 bytes forward, 231424 the
    dk/dv kernel, under the 232448 a block may have, so no float32 case is
    refused) and in bfloat16; the padded value columns of an MLA call
    exactly 0; the backward bitwise on repeat, three launches a call."""
    rng = np.random.default_rng(13)
    for (sq, skv), dh, (h, hkv), causal, window, off in FLASH_MLA_CASES:
        q = t(np32(rng, 2, sq, 2 * h, dh)).to(cuda, dtype)[:, :, :h]
        k = t(np32(rng, 2, skv, hkv, dh)).to(cuda, dtype)
        v = t(np32(rng, 2, skv, hkv, dh))
        v[..., dh * 2 // 3:] = 0.0          # MLA's zero-padded v
        v = v.to(cuda, dtype)
        do = t(np32(rng, 2, sq, h, dh)).to(cuda, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        case = ((sq, skv), dh, (h, hkv), causal, window, off)
        o, lse = flash_attention_fwd(q, k, v, lse=True, mode="cuda", **kw)
        o_ref, lse_ref = flash_attention_fwd(q, k, v, lse=True,
                                             mode="torch", **kw)
        if dtype == torch.float32:
            torch.testing.assert_close(o, o_ref, rtol=0, atol=2e-5)
        else:
            assert _ulps(o, o_ref, dtype, atol=2e-5) <= 1.0, case
        assert not o[..., dh * 2 // 3:].any(), case
        assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
        fin = torch.isfinite(lse_ref)
        torch.testing.assert_close(lse[fin], lse_ref[fin], rtol=1e-5,
                                   atol=1e-5)
        before = build.LAUNCHES["flash_attention_bwd"]
        got = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        assert build.LAUNCHES["flash_attention_bwd"] == before + 3
        want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max().item()
            assert err <= rel * w.float().abs().max().item(), (case, err)
        again = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


#: head dims no kernel is built for (smoke MLA's 16 + 8 = 24, and two
#: more), each run zero-padded to the next built one (32, 64, 128): query
#: and kv lengths across a tile's edge, causal and not, a window, GQA, a
#: chunked prefill's offset and rows that see no key
FLASH_PADDED_CASES = [((129, 129), 24, (4, 4), True, None, 0),
                      ((65, 130), 24, (8, 2), False, None, 0),
                      ((64, 64), 24, (4, 1), True, 20, -10),
                      ((200, 257), 40, (8, 2), True, 100, 57),
                      ((130, 97), 40, (4, 4), False, None, 0),
                      ((257, 127), 100, (8, 2), True, 70, 5),
                      ((129, 129), 100, (2, 2), False, 64, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_pads_unbuilt_head_dims(cuda, dtype):
    """At a head dim no kernel is built for, the forward (output, lse) and
    the backward run the kernels on operands zero-padded to the next built
    head dim, at the scale of the true one: within the flash bounds of the
    cases above, one forward and three backward launches a call, the
    backward bitwise on repeat.  Above 256 both raise before any
    launch."""
    rng = np.random.default_rng(24)
    for (sq, skv), dh, (h, hkv), causal, window, off in FLASH_PADDED_CASES:
        q = t(np32(rng, 2, sq, 2 * h, dh)).to(cuda, dtype)[:, :, :h]
        k, v = (t(np32(rng, 2, skv, hkv, dh)).to(cuda, dtype)
                for _ in range(2))
        do = t(np32(rng, 2, sq, h, dh)).to(cuda, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        case = ((sq, skv), dh, (h, hkv), causal, window, off)
        before = build.LAUNCHES["flash_attention"]
        o, lse = flash_attention_fwd(q, k, v, lse=True, mode="cuda", **kw)
        assert build.LAUNCHES["flash_attention"] == before + 1
        o_ref, lse_ref = flash_attention_fwd(q, k, v, lse=True,
                                             mode="torch", **kw)
        assert o.shape == (2, sq, h, dh) and o.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(o, o_ref, rtol=0, atol=2e-5)
        else:
            assert _ulps(o, o_ref, dtype, atol=2e-5) <= 1.0, case
        assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
        fin = torch.isfinite(lse_ref)
        torch.testing.assert_close(lse[fin], lse_ref[fin], rtol=1e-5,
                                   atol=1e-5)
        before = build.LAUNCHES["flash_attention_bwd"]
        got = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        assert build.LAUNCHES["flash_attention_bwd"] == before + 3
        want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            err = (g.float() - w.float()).abs().max().item()
            assert err <= rel * w.float().abs().max().item(), (case, err)
        again = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    q = torch.zeros((1, 64, 4, 264), device=cuda, dtype=dtype)
    lse = torch.zeros((1, 4, 64), device=cuda)
    build.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim 264"):
        flash_attention(q, q, q, mode="cuda")
    with pytest.raises(ValueError, match="head dim 264"):
        flash_attention_bwd(q, q, q, q, lse, q, mode="cuda")
    assert not build.LAUNCHES


def test_gpu_smoke_mla_prefill_runs_the_flash_kernel(cuda):
    """A smoke minicpm3 prefill (MLA at head dim 24, padded to 32) on the
    card under "auto" and "cuda": one flash launch a layer, logits within
    3e-4 of their largest magnitude of the plain version's
    (``tests/test_torch_serve.py``'s bound); none under "torch"."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import cache_specs, init_from_specs, param_specs
    from repro_torch.models.transformer import prefill
    cfg = get_smoke("minicpm3-4b")
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    params = init_from_specs(param_specs(cfg), g, cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=cuda)
    out = {}
    for mode in ("auto", "cuda", "torch"):
        caches = init_from_specs(cache_specs(cfg, 2, 40, torch.float32),
                                 None, cuda)
        build.reset_launch_counts()
        out[mode] = prefill(params, tokens, cfg, caches, kernel_mode=mode)[0]
        launches = dict(build.LAUNCHES)
        assert launches == ({} if mode == "torch" else
                            {"flash_attention": cfg.n_layers}), launches
    want = out["torch"]
    assert bool(torch.isfinite(want).all())
    for mode in ("auto", "cuda"):
        assert (out[mode] - want).abs().max().item() \
            <= 3e-4 * want.abs().max().item(), mode


#: recurrentgemma's local attention at head dim 256 (32-row kv tiles in the
#: bf16 forward, 32-row streamed tiles in its backward): its group of 16
#: query heads over one kv head and others, windows, lengths across the
#: 32-row tiles' edges, a chunked prefill's offset and rows that see no
#: key (chip_smoke.py's FLASH_RG_CASES)
FLASH_RG_CASES = [((300, 300), (16, 1), True, 100, 0),
                  ((33, 65), (4, 1), False, None, 0),
                  ((129, 257), (16, 1), True, 40, 128),
                  ((31, 31), (2, 2), True, None, 0),
                  ((64, 64), (16, 1), True, 20, -10),
                  ((257, 127), (8, 2), True, 70, 5),
                  ((130, 97), (16, 1), False, None, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_head_dim_256_matches_plain(cuda, dtype):
    """The forward (output, lse) at head dim 256 in float32 (the FMA
    kernel's 213760 bytes of shared memory fit) and bfloat16, and the
    backward, at the flash bounds over the cases above (float32 on its
    32-row tiles); the backward bitwise on repeat, three launches a
    call."""
    rng = np.random.default_rng(256)
    for (sq, skv), (h, hkv), causal, window, off in FLASH_RG_CASES:
        q = t(np32(rng, 2, sq, 2 * h, 256)).to(cuda, dtype)[:, :, :h]
        k, v = (t(np32(rng, 2, skv, hkv, 256)).to(cuda, dtype)
                for _ in range(2))
        do = t(np32(rng, 2, sq, h, 256)).to(cuda, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        case = ((sq, skv), (h, hkv), causal, window, off)
        o, lse = flash_attention_fwd(q, k, v, lse=True, mode="cuda", **kw)
        o_ref, lse_ref = flash_attention_fwd(q, k, v, lse=True,
                                             mode="torch", **kw)
        if dtype == torch.float32:
            torch.testing.assert_close(o, o_ref, rtol=0, atol=2e-5)
        else:
            assert _ulps(o, o_ref, dtype, atol=2e-5) <= 1.0, case
        assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
        fin = torch.isfinite(lse_ref)
        torch.testing.assert_close(lse[fin], lse_ref[fin], rtol=1e-5,
                                   atol=1e-5)
        before = build.LAUNCHES["flash_attention_bwd"]
        got = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        assert build.LAUNCHES["flash_attention_bwd"] == before + 3
        want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max().item()
            assert err <= rel * w.float().abs().max().item(), (case, err)
        again = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gpu_flash_attention_bwd_f32_head_dim_256_matches_plain(cuda):
    """The float32 backward at recurrentgemma's local attention (G 16 over
    one kv head, window 2048 at a cut length of 2304 tokens): within
    ``rel 1e-4`` of each gradient's largest, the plain version fed the
    plain forward's output and lse; rows that see no key dq exactly 0."""
    rng = np.random.default_rng(2048)
    q = t(np32(rng, 1, 2304, 16, 256)).to(cuda)
    k, v = (t(np32(rng, 1, 2304, 1, 256)).to(cuda) for _ in range(2))
    do = t(np32(rng, 1, 2304, 16, 256)).to(cuda)
    kw = dict(causal=True, window=2048)
    o, lse = flash_attention_fwd(q, k, v, lse=True, mode="cuda", **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, mode="cuda", **kw)
    o_ref, lse_ref = flash_attention_fwd(q, k, v, lse=True, mode="torch",
                                         **kw)
    want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), err


@pytest.mark.parametrize("kind", ["rec", "ssd"])
def test_gpu_recurrent_layer_on_the_card_matches_the_cpu(cuda, kind):
    """An RG-LRU and an SSD layer of the smoke configs (float32, TF32 off)
    in train, prefill and decode mode on the card against the same layer
    on the CPU: outputs and caches within ``atol 1e-4`` (the same float32
    ops, summed in another order); no kernel launched."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import rglru, ssd, transformer
    from repro_torch.models.spec import init_from_specs
    cfg = get_smoke("recurrentgemma-9b" if kind == "rec" else "mamba2-130m")
    specs, cache_spec = (rglru.rglru_specs, rglru.rglru_cache_spec) \
        if kind == "rec" else (ssd.ssd_specs, ssd.ssd_cache_spec)
    fns = dict(zip(("train", "prefill", "decode"),
                   transformer.RECURRENT[kind]))
    g = torch.Generator()
    g.manual_seed(0)
    p_cpu = init_from_specs(specs(cfg, None), g)
    p_gpu = {k: v.to(cuda) for k, v in p_cpu.items()}
    rng = np.random.default_rng(7)
    x = t(np32(rng, 2, 300, cfg.d_model))
    build.reset_launch_counts()
    torch.testing.assert_close(fns["train"](p_gpu, x.to(cuda), cfg).cpu(),
                               fns["train"](p_cpu, x, cfg), rtol=0,
                               atol=1e-4)
    caches = {d: init_from_specs(cache_spec(cfg, 2, None), None, d)
              for d in ("cpu", cuda)}
    for mode, xs in (("prefill", x), ("decode", x[:, :1])):
        want = fns[mode](p_cpu, xs, cfg, caches["cpu"])[0]
        got = fns[mode](p_gpu, xs.to(cuda), cfg, caches[cuda])[0]
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
        for k in caches["cpu"]:
            torch.testing.assert_close(caches[cuda][k].cpu(),
                                       caches["cpu"][k], rtol=0, atol=1e-4)
    assert not build.LAUNCHES


def test_gpu_one_rank_mesh_sweep_is_bitwise_the_meshless_sweep(cuda):
    """A world of one (``make_sweep_mesh()``, ``placement="auto"``): every
    bucket runs whole, and the rows are bitwise those of the same plan run
    with no mesh, on the card with the kernels."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import REDUCED
    from repro_torch.fl import plan_sweep, run_plan
    from repro_torch.launch.mesh import make_sweep_mesh
    tiny = dataclasses.replace(REDUCED, t_global_rounds=3, n_edges=3,
                               j_per_edge=3, image_hw=8)
    ovs = [{"straggler_frac": f} for f in (0.0, 0.2, 0.4)] + [
        {"j_per_edge": 2}]
    plan = plan_sweep(tiny, overrides=ovs, n_train=300, n_test=100,
                      steps_per_epoch=2, bucket_cost="proxy", device="cuda")
    started = not dist.is_initialized()
    try:
        got = run_plan(plan, mesh=make_sweep_mesh(), placement="auto",
                       donate=False)
    finally:
        if started:
            dist.destroy_process_group()
    ref = run_plan(plan, donate=False)
    for k in ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


def test_gpu_census_is_the_bytes_the_card_allocates(cuda):
    """danube-smoke at a serve shape and a train line (E = 1, C = 2): the
    census of ``input_specs`` on a one-card mesh (every placement
    ``Replicate``) against the bytes the drivers' own code asks the
    caching allocator for (``requested_bytes``) when it places the
    parameters, caches and histories, within 512 bytes a tensor; the
    allocator's blocks (``memory_allocated``) at most 1 MiB a tensor above
    them (a large block keeps its segment's tail of 1 MiB or less).  The
    leader's history, which ``init_fl_histories`` keeps in float32 where
    the stand-ins keep the parameters' dtype (as the reference's do), at
    its float32 size."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.configs import get_smoke
    from repro_torch.launch import inputs, make_debug_mesh
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.serve import make_caches, make_params
    from repro_torch.launch.steps import init_fl_histories
    from repro_torch.models.config import InputShape

    started = not dist.is_initialized()
    mesh = make_debug_mesh()
    try:
        cfg = get_smoke("h2o-danube-1.8b")
        specs = inputs.input_specs(cfg, InputShape("s", 256, 2, "prefill"),
                                   mesh)
        for t in inputs.leaves(specs):
            assert all(isinstance(p, Replicate) for p in t.placements)
            assert shd.placements(t.spec, mesh) == t.placements
        base = _bytes()
        params = make_params(cfg, 0, cuda)
        # the caches in the parameters' dtype, as the stand-ins hold them
        caches = make_caches(cfg, 2, 256, cuda,
                             smoke=cfg.param_dtype == "float32")
        _held(_bytes() - base, inputs.census(specs["params"], mesh)
              + inputs.census(specs["caches"], mesh),
              len(inputs.leaves([specs["params"], specs["caches"]])))
        del params, caches

        tcfg = dataclasses.replace(cfg, clients_per_pod=2)
        specs = inputs.input_specs(tcfg, InputShape("t", 256, 4, "train"),
                                   mesh)
        base = _bytes()
        one = make_params(tcfg, 0, cuda)
        params = _stack_slots(one, 1, 2)
        del one
        mid = _bytes()
        dev_hist, glob_hist = init_fl_histories(params)
        hist = _bytes() - mid
        _held(mid - base, inputs.census(specs["params"], mesh),
              len(inputs.leaves(specs["params"])))
        item = tcfg.torch_param_dtype.itemsize
        want = inputs.census(specs["dev_hist"], mesh) + (
            inputs.census(specs["glob_hist"], mesh)
            - inputs.census([specs["glob_hist"].n_obs,
                             specs["glob_hist"].miss_count], mesh)) \
            * 4 // item + inputs.census([specs["glob_hist"].n_obs,
                                         specs["glob_hist"].miss_count],
                                        mesh)
        _held(hist, want, len(inputs.leaves([specs["dev_hist"],
                                             specs["glob_hist"]])))
    finally:
        if started:
            dist.destroy_process_group()


def _bytes():
    """(allocated, requested) bytes of the caching allocator now."""
    torch.cuda.synchronize()
    return np.array([torch.cuda.memory_allocated(),
                     torch.cuda.memory_stats()["requested_bytes.all.current"]])


def _held(grown, want: int, n: int) -> None:
    """Requested within 512 bytes a tensor of ``want``; the blocks
    allocated at most 1 MiB a tensor above the bytes requested."""
    assert abs(int(grown[1]) - want) <= 512 * n, (grown, want)
    assert 0 <= grown[0] - grown[1] <= (1 << 20) * n, (grown, want)


def _stack_slots(tree, e, c):
    """Every leaf broadcast into [E, C] client slots, as ``train.run``
    places them."""
    if isinstance(tree, dict):
        return {k: _stack_slots(v, e, c) for k, v in tree.items()}
    return tree[None, None].expand((e, c) + tuple(tree.shape)).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_sharded_flash_on_one_rank_is_the_kernel(cuda, dtype):
    """The flash forward and backward through the DTensor entry
    (``kernels.ops.flash_attention_sharded``, as a mesh step enters it) on
    a one-rank mesh with q, k and v split on their heads equal the kernels
    on the whole tensors, bitwise, and launch them."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.kernels import ops
    from repro_torch.launch import make_debug_mesh
    started = not dist.is_initialized()
    try:
        mesh = make_debug_mesh(model=1)["model"]
        g = torch.Generator(device=cuda).manual_seed(5)
        q, k, v, do = (torch.randn(shape, generator=g, device=cuda)
                       .to(dtype) for shape in ((2, 256, 8, 80),
                                                (2, 256, 2, 80),
                                                (2, 256, 2, 80),
                                                (2, 256, 8, 80)))
        kw = dict(causal=True, window=100, q_offset=0, mode="cuda")
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        want = ops.flash_attention(*leaves, **kw)
        want_g = torch.autograd.grad(want, leaves, do)
        dts = [DTensor.from_local(x.clone(), mesh, [Shard(2)])
               .requires_grad_() for x in (q, k, v)]
        build.reset_launch_counts()
        got = ops.flash_attention(*dts, **kw)
        got_g = torch.autograd.grad(got, dts, DTensor.from_local(
            do, mesh, [Shard(2)]))
        assert build.LAUNCHES["flash_attention"] == 1
        assert build.LAUNCHES["flash_attention_bwd"] == 3
        assert torch.equal(got.to_local(), want)
        for a, b in zip(got_g, want_g):
            assert torch.equal(a.to_local(), b)
    finally:
        if started:
            dist.destroy_process_group()
