"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version, which must match
the JAX kernel run through the Pallas interpreter (``interpret=True``, as
``tests/test_kernel_plane.py`` runs it) on the same numpy inputs, at the
tile-tail shapes of that file.  Tolerances: the conv forward and its
gradients in x, w and b ``rtol = atol = 1e-5`` (float32 sums of up to
9*Cin terms in another order); the elementwise kernels ``rtol = 1e-6``
with ``atol = 1e-7`` (one float32 rounding, and a possible FMA
contraction on one side), and ``atol = 1e-6`` where a value is a sum over
participants that may cancel.  Exact: ``scale = 0`` in SGD, zero-
coefficient slots, label ``-1`` rows and the correct-counts.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels.coef_agg import coef_agg as jax_coef_agg  # noqa: E402
from repro.kernels.conv3x3 import \
    conv3x3_bias_relu as jax_conv  # noqa: E402
from repro.kernels.eval_head import eval_head as jax_eval_head  # noqa: E402
from repro.kernels.hieavg_agg import hieavg_agg as jax_hieavg_agg  # noqa: E402
from repro.kernels.sgd_update import sgd_update as jax_sgd  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.kernels.coef_agg import coef_agg  # noqa: E402
from repro_torch.kernels.conv3x3 import (conv3x3_bias_relu,  # noqa: E402
                                         conv3x3_bwd, conv3x3_fwd)
from repro_torch.kernels.eval_head import eval_head  # noqa: E402
from repro_torch.kernels.hieavg_agg import hieavg_agg  # noqa: E402
from repro_torch.kernels.sgd_update import (sgd_update,  # noqa: E402
                                            sgd_update_many)

pytestmark = pytest.mark.kernel_oracle

L_TAILS = [1, 7, 2047, 2049]


def t(a):
    return torch.from_numpy(np.asarray(a))


def np32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------- conv
#: (D, B, H, W, Cin, Cout); D 0 is the single-model form, D > 0 the stacked
#: one, held against ``jax.vmap`` of the Pallas conv and of its VJP
CONV_SHAPES = [(0, 1, 5, 5, 1, 3),     # M = 25 < one tile
               (0, 2, 12, 12, 4, 8),   # M = 288: a tile and a tail
               (0, 2, 16, 16, 3, 7),   # M = 512: whole tiles, odd Cout
               (0, 2, 7, 9, 5, 6),     # a non-square image
               (0, 3, 8, 8, 1, 4),     # layer 1's single input channel
               (3, 2, 6, 6, 2, 4)]     # stacked devices


@pytest.mark.parametrize("d,b,h,wd,cin,cout", CONV_SHAPES)
def test_conv3x3_forward_and_grads_match_pallas(d, b, h, wd, cin, cout):
    rng = np.random.default_rng(d * 1000 + b * 100 + h * 10 + wd)
    lead = (d,) if d else ()
    x = np32(rng, *lead, b, h, wd, cin)
    w = np32(rng, *lead, 3, 3, cin, cout, scale=0.3)
    bias = np32(rng, *lead, cout, scale=0.3)
    dy = np32(rng, *lead, b, h, wd, cout)

    def conv(x, w, bb):
        return jax_conv(x, w, bb, interpret=True)

    if d:
        conv = jax.vmap(conv)

    def loss(x, w, bb):
        return jnp.sum(conv(x, w, bb) * dy)

    ref_y = conv(x, w, bias)
    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(x, w, bias)

    tx, tw, tb = (t(a).requires_grad_(True) for a in (x, w, bias))
    y = conv3x3_bias_relu(tx, tw, tb)
    assert tuple(y.shape) == ref_y.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               rtol=1e-5, atol=1e-5)
    (y * t(dy)).sum().backward()
    for got, want in ((tx.grad, gx), (tw.grad, gw), (tb.grad, gb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_conv3x3_stacked_devices_are_independent():
    """The stacked [D, ...] form is the single-model form per device."""
    rng = np.random.default_rng(3)
    x, w = t(np32(rng, 3, 2, 6, 6, 2)), t(np32(rng, 3, 3, 3, 2, 4))
    bias = t(np32(rng, 3, 4))
    y = conv3x3_bias_relu(x, w, bias)
    for d in range(3):
        torch.testing.assert_close(y[d], conv3x3_bias_relu(x[d], w[d],
                                                           bias[d]),
                                   rtol=0, atol=0)


def test_conv3x3_skips_dx_when_x_needs_no_grad():
    rng = np.random.default_rng(4)
    x, w = t(np32(rng, 2, 3, 5, 6, 1)), t(np32(rng, 2, 3, 3, 1, 5))
    y = conv3x3_fwd(x, w, t(np32(rng, 2, 5)))
    dx, dw, db = conv3x3_bwd(x, w, y, torch.ones_like(y), need_dx=False)
    assert dx is None and dw.shape == (2, 3, 3, 1, 5) and db.shape == (2, 5)
    # through autograd: images need no gradient, so the backward asks for
    # none, and dW and db are those of the backward that computes dx too
    tw = w.clone().requires_grad_(True)
    tb = torch.zeros(2, 5, requires_grad=True)
    conv3x3_bias_relu(x, tw, tb).sum().backward()
    want = conv3x3_bwd(x, w, conv3x3_fwd(x, w, torch.zeros(2, 5)),
                       torch.ones_like(y), need_dx=True)
    torch.testing.assert_close(tw.grad, want[1], rtol=0, atol=0)
    torch.testing.assert_close(tb.grad, want[2], rtol=0, atol=0)


def test_conv3x3_saves_x_and_never_patches():
    """The autograd function keeps x, w and y for the backward: no
    [D, M, 9*Cin] im2col tensor."""
    rng = np.random.default_rng(5)
    d, b, h, wd, cin, cout = 2, 3, 6, 7, 4, 5
    x = t(np32(rng, d, b, h, wd, cin)).requires_grad_(True)
    w = t(np32(rng, d, 3, 3, cin, cout)).requires_grad_(True)
    bias = t(np32(rng, d, cout)).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda a: saved.append(tuple(a.shape)) or a, lambda a: a):
        conv3x3_bias_relu(x, w, bias)
    assert sorted(saved) == sorted([(d, b, h, wd, cin), (d, 3, 3, cin, cout),
                                    (d, b, h, wd, cout)])
    assert all(s[-1] != 9 * cin for s in saved)


# ------------------------------------------------------------------- sgd
@pytest.mark.parametrize("n", [1, 4, 9])
@pytest.mark.parametrize("length", L_TAILS)
def test_sgd_update_matches_pallas(n, length):
    rng = np.random.default_rng(n * 7 + length)
    w, g = np32(rng, n, length), np32(rng, n, length)
    ref = jax_sgd(w, g, jnp.float32(0.37), interpret=True)
    got = sgd_update(t(w), t(g), float(np.float32(0.37)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_sgd_update_zero_scale_is_exact_identity():
    rng = np.random.default_rng(0)
    w, g = t(np32(rng, 4, 333)), t(np32(rng, 4, 333, scale=1e3))
    assert torch.equal(sgd_update(w, g, 0.0), w)


def test_sgd_update_wants_a_host_scale():
    w = torch.zeros(2, 3)
    with pytest.raises(TypeError, match="host float"):
        sgd_update(w, w, torch.tensor(0.1))


#: a ragged set of leaves: the CNN's kinds of shape at small widths, a
#: one-element leaf and an empty one
RAGGED = {"conv1_w": (3, 3, 3, 1, 4), "conv1_b": (3, 4), "fc_w": (3, 37, 10),
          "fc_b": (3, 10), "one": (1,), "empty": (3, 0)}


@pytest.mark.parametrize("scale", [0.37, 0.0])
def test_fused_sgd_update_matches_pallas_per_leaf(scale):
    """The one-launch-per-step path (``ops.fused_sgd_update`` through
    ``sgd_update_many``) is the JAX kernel leaf by leaf; a strided gradient
    is taken as autograd hands it over."""
    rng = np.random.default_rng(11)
    params = {k: np32(rng, *shp) for k, shp in RAGGED.items()}
    grads = {k: np32(rng, *shp, scale=1e3) for k, shp in RAGGED.items()}
    tgrads = {k: t(g) for k, g in grads.items()}
    tgrads["fc_w"] = t(np.ascontiguousarray(grads["fc_w"].transpose(0, 2, 1))
                       ).transpose(1, 2)                     # strided view
    got = ops.fused_sgd_update({k: t(w) for k, w in params.items()}, tgrads,
                               float(np.float32(scale)))
    assert list(got) == list(RAGGED)
    for k, w in params.items():
        # the JAX kernel on the leaf as one [1, L] row (an empty leaf has
        # nothing to update)
        ref = np.asarray(jax_sgd(w.reshape(1, -1), grads[k].reshape(1, -1),
                                 jnp.float32(scale), interpret=True)
                         ).reshape(w.shape) if w.size else w
        assert got[k].shape == w.shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-6, atol=1e-7)
        if scale == 0.0:
            assert torch.equal(got[k], t(w))


def test_sgd_update_many_checks_its_leaves():
    w = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="2 leaves, 1 grads"):
        sgd_update_many([w, w], [w], 0.1)
    assert sgd_update_many([], [], 0.1) == []
    with pytest.raises(ValueError, match="CUDA tensors"):
        sgd_update_many([w], [w], 0.1, mode="cuda")


# ------------------------------------------------------------- hieavg_agg
def _hieavg_inputs(rng, n, length):
    w, prev = np32(rng, n, length), np32(rng, n, length)
    dmean = np32(rng, n, length, scale=0.1)
    mask = rng.random(n) > 0.4
    cp = rng.random(n).astype(np.float32)
    ce = ((1.0 - cp) * 0.3).astype(np.float32)
    nobs = np.arange(n, dtype=np.float32)
    return w, prev, dmean, mask, cp, ce, nobs


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("length", L_TAILS)
def test_hieavg_agg_matches_pallas(n, length):
    args = _hieavg_inputs(np.random.default_rng(n + length), n, length)
    ref = jax_hieavg_agg(*args, interpret=True)
    got = hieavg_agg(*(t(a)[None] for a in args))
    for g_, r_, atol in zip(got, ref, (1e-6, 1e-7, 1e-7)):
        np.testing.assert_allclose(g_[0].numpy(), np.asarray(r_),
                                   rtol=1e-6, atol=atol)


def test_hieavg_agg_zero_coefficient_slots_add_exactly_nothing():
    rng = np.random.default_rng(1)
    w, prev, dmean, mask, cp, ce, nobs = _hieavg_inputs(rng, 4, 300)
    cp[3] = ce[3] = 0.0
    junk = [a.copy() for a in (w, prev, dmean)]
    for a in junk:
        a[3] = 1e6
    a0 = hieavg_agg(*(t(a)[None] for a in (w, prev, dmean, mask, cp, ce,
                                            nobs)))[0]
    a1 = hieavg_agg(*(t(a)[None] for a in (*junk, mask, cp, ce, nobs)))[0]
    assert torch.equal(a0, a1)


# --------------------------------------------------------------- coef_agg
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("length", L_TAILS)
def test_coef_agg_matches_pallas(n, length):
    rng = np.random.default_rng(10 * n + length)
    w = np32(rng, n, length)
    coef = rng.random(n).astype(np.float32)
    coef /= coef.sum()
    ref = jax_coef_agg(w, coef, interpret=True)
    got = coef_agg(t(w)[None], t(coef)[None])[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_coef_agg_zero_coefficient_slots_add_exactly_nothing():
    rng = np.random.default_rng(6)
    live = np32(rng, 3, 500)
    pad = np.concatenate([live, np.full((2, 500), 1e6, np.float32)])
    zero = np.concatenate([live, np.zeros((2, 500), np.float32)])
    coef = t(np.asarray([[0.5, 0.3, 0.2, 0.0, 0.0]], np.float32))
    assert torch.equal(coef_agg(t(pad)[None], coef),
                       coef_agg(t(zero)[None], coef))


# -------------------------------------------------------------- eval_head
@pytest.mark.parametrize("m", [1, 100, 256, 257, 400])
def test_eval_head_count_equals_pallas(m):
    rng = np.random.default_rng(m)
    f, c = 33, 10
    feats, wmat = np32(rng, m, f), np32(rng, f, c, scale=0.1)
    bias = np32(rng, c, scale=0.1)
    labels = rng.integers(-1, c, m).astype(np.int32)   # -1 never counts
    ref = jax_eval_head(feats, wmat, bias, labels, interpret=True)
    got = eval_head(t(feats), t(wmat), t(bias), t(labels))
    assert int(got) == int(ref)


def test_eval_head_label_minus_one_never_counts():
    rng = np.random.default_rng(2)
    feats, wmat = t(np32(rng, 50, 12)), t(np32(rng, 12, 4))
    labels = torch.full((50,), -1, dtype=torch.int32)
    assert int(eval_head(feats, wmat, torch.zeros(4), labels)) == 0


# ------------------------------------------------- dispatch recipes + modes
def test_cold_aggregate_recipes_match_jax_dispatch():
    """The 1e-12 floors: an all-invalid edge aggregates to exact zeros;
    both cold means match the JAX dispatch's interpret path."""
    rng = np.random.default_rng(5)
    w = {"a": np32(rng, 3, 4, 5, 2), "b": np32(rng, 3, 4, 7)}
    valid = np.asarray([[1, 1, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1]], bool)
    ref = jax_dispatch.edge_aggregate_cold_batched(w, valid,
                                                   mode="interpret")
    got = dispatch.edge_aggregate_cold_batched(
        {k: t(v) for k, v in w.items()}, t(valid))
    j = np.asarray([3.0, 0.0, 4.0], np.float32)
    gref = jax_dispatch.global_aggregate_cold(w, j, mode="interpret")
    ggot = dispatch.global_aggregate_cold({k: t(v) for k, v in w.items()},
                                          t(j))
    for k in w:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)
        assert not got[k][1].any()
        np.testing.assert_allclose(ggot[k].numpy(), np.asarray(gref[k]),
                                   rtol=1e-6, atol=1e-6)


def test_kernel_modes():
    w = torch.zeros(2, 3)
    assert build.use_kernel("auto", w) is False
    assert build.use_kernel("torch", w) is False
    with pytest.raises(ValueError, match="cuda"):
        build.use_kernel("cuda", w)
    with pytest.raises(ValueError, match="kernel_mode"):
        build.use_kernel("pallas", w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sgd_update(w, w, 0.1, mode="cuda")
