"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present (the ``cuda`` fixture decides, at run time).  The file imports
neither JAX nor the JAX package, so it runs on a machine with a GPU and
PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the conv kernels ``rtol 1e-4`` (float32 sums in another
order than cuBLAS's), their backward bitwise on repeat; the HieAvg mix and the coefficient aggregates ``rtol 1e-5,
atol 1e-6`` (FMA contraction); a narrow (bfloat16 or float8_e4m3fn)
history one unit in the last place of its dtype (the float32 value it
rounds differs by the FMA's rounding); the float8 edge values, the SGD
update, zero-coefficient slots and the correct-counts exactly.  Flash
attention: float32 ``atol 2e-5`` (``tests/test_kernels.py``'s bound),
bfloat16 one unit in the last place beyond that bound (both versions
widen, sum in float32, which may differ by 2e-5 where a sum cancels to
near 0, and round once), rows that see no key exactly 0, at unit-scale and
at sharp (q scaled by 24) logits.  The multi-leaf SGD update is bitwise
the plain version, one launch a call; a bfloat16 operand that breaks a
TMA precondition raises before any launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.hieavg import to_history_dtype  # noqa: E402
from repro_torch.fl.engine import train_epoch_body  # noqa: E402
from repro_torch.kernels.coef_agg import coef_agg, coef_agg_pair  # noqa: E402
from repro_torch.kernels.conv3x3 import conv3x3_bwd, conv3x3_fwd  # noqa: E402
from repro_torch.kernels.eval_head import eval_head  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.hieavg_agg import hieavg_agg  # noqa: E402
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
               ((200, 640), 64, (4, 1), False, 300)]


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


#: the paper's CNN leaves at DEFAULT width (c1 32, c2 64, 10 classes,
#: 28x28), D = 25 devices: 144266 parameters in six leaves
CNN_LEAVES = [(25, 3, 3, 1, 32), (25, 32), (25, 3, 3, 32, 64), (25, 64),
              (25, 12544, 10), (25, 10)]


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
