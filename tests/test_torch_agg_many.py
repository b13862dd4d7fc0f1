"""The multi-leaf ``hieavg_agg_many`` and the any-class ``eval_head``
against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions, which must match
the JAX kernels run through the Pallas interpreter (``interpret=True``) on
the same numpy inputs:

  * ``hieavg_agg_many`` over the paper's CNN's six leaves at a TINY width,
    two edges of five participants, with float32, bfloat16 and
    float8_e4m3fn history, against ``jax.vmap`` of the Pallas
    ``hieavg_agg`` over the edges, leaf by leaf.  Tolerances of
    ``tests/test_torch_kernels.py::test_hieavg_agg_matches_pallas``: the
    aggregate ``rtol 1e-6, atol 1e-6`` (a sum over participants that may
    cancel), a float32 history ``rtol 1e-6, atol 1e-7``; a narrow history
    bitwise (both round the same float32 value once).  A zero-coefficient
    slot adds exactly nothing.
  * ``eval_head`` at 10 and 100 classes: the count equals the Pallas
    kernel's.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.eval_head import eval_head as jax_eval_head  # noqa: E402
from repro.kernels.hieavg_agg import hieavg_agg as jax_hieavg_agg  # noqa: E402
from repro_torch.kernels.eval_head import eval_head  # noqa: E402
from repro_torch.kernels.hieavg_agg import hieavg_agg_many  # noqa: E402
from repro_torch.models import cnn_specs  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.kernel_oracle

#: the paper's CNN's leaves at a TINY width (8x8 images, c1 4, c2 8)
LEAVES = [tuple(s.shape) for s in cnn_specs(8, 1, 10, c1=4, c2=8).values()]
#: two edges of five participants
LEAD = (2, 5)
#: history dtype -> (torch dtype, JAX dtype, the width of its bits)
HISTORY = {"f32": (torch.float32, jnp.float32, None),
           "bf16": (torch.bfloat16, jnp.bfloat16, np.uint16),
           "f8": (torch.float8_e4m3fn, jnp.float8_e4m3fn, np.uint8)}


def t(a):
    return torch.from_numpy(np.array(a))


def np32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(rng, jdt):
    """Per leaf w, prev, dmean [2, 5, *leaf] (history rounded to ``jdt`` as
    numpy arrays of JAX's dtype) and the [2, 5] coefficient vectors."""
    ws = [np32(rng, *LEAD, *s) for s in LEAVES]
    prevs = [np.asarray(jnp.asarray(np32(rng, *LEAD, *s)).astype(jdt))
             for s in LEAVES]
    dmeans = [np.asarray(jnp.asarray(np32(rng, *LEAD, *s, scale=0.1))
                         .astype(jdt)) for s in LEAVES]
    mask = rng.random(LEAD) > 0.4
    cp = (rng.random(LEAD) * mask).astype(np.float32)
    ce = (rng.random(LEAD) * 0.3 * ~mask).astype(np.float32)
    nobs = rng.integers(0, 6, LEAD).astype(np.float32)
    return ws, prevs, dmeans, (mask, cp, ce, nobs)


def _torch_history(a, tdt, width):
    return t(a) if width is None else t(a.view(width)).view(tdt)


def _bits(x, width):
    if isinstance(x, torch.Tensor):
        return x.view({np.uint16: torch.uint16,
                       np.uint8: torch.uint8}[width]).numpy()
    return np.asarray(x).view(width)


@pytest.mark.parametrize("hist", list(HISTORY))
def test_hieavg_agg_many_matches_pallas_per_leaf(hist):
    tdt, jdt, width = HISTORY[hist]
    rng = np.random.default_rng(7)
    ws, prevs, dmeans, vecs = _inputs(rng, jdt)
    got = hieavg_agg_many([t(w) for w in ws],
                          [_torch_history(p, tdt, width) for p in prevs],
                          [_torch_history(d, tdt, width) for d in dmeans],
                          *(t(v) for v in vecs))
    pallas = jax.vmap(functools.partial(jax_hieavg_agg, interpret=True))
    for k, shape in enumerate(LEAVES):
        flat = LEAD + (int(np.prod(shape)),)
        want = pallas(ws[k].reshape(flat), prevs[k].reshape(flat),
                      dmeans[k].reshape(flat), *vecs)
        agg, nprev, ndmean = (x[k] for x in got)
        assert tuple(agg.shape) == LEAD[:1] + shape
        assert nprev.shape == ndmean.shape == ws[k].shape
        assert agg.dtype == torch.float32
        assert nprev.dtype == ndmean.dtype == tdt
        np.testing.assert_allclose(agg.numpy().reshape(LEAD[0], -1),
                                   np.asarray(want[0]), rtol=1e-6,
                                   atol=1e-6)
        for g, w_ in zip((nprev, ndmean), want[1:]):
            if width is None:
                np.testing.assert_allclose(g.numpy().reshape(flat),
                                           np.asarray(w_), rtol=1e-6,
                                           atol=1e-7)
            else:
                np.testing.assert_array_equal(
                    _bits(g, width).reshape(flat), _bits(w_, width))


def test_hieavg_agg_many_zero_coefficient_slot_adds_exactly_nothing():
    rng = np.random.default_rng(8)
    ws, prevs, dmeans, (mask, cp, ce, nobs) = _inputs(rng, jnp.float32)
    cp[1, 3] = ce[1, 3] = 0.0
    vecs = [t(v) for v in (mask, cp, ce, nobs)]
    clean = hieavg_agg_many([t(w) for w in ws], [t(p) for p in prevs],
                            [t(d) for d in dmeans], *vecs)[0]
    junk = []
    for leaves in (ws, prevs, dmeans):
        junk.append([t(a) for a in leaves])
        for a in junk[-1]:
            a[1, 3] = 1e6
    assert all(torch.equal(a, b) for a, b in
               zip(clean, hieavg_agg_many(*junk, *vecs)[0]))


def test_hieavg_agg_many_checks_its_leaves():
    w = torch.zeros(1, 2, 3)
    m = torch.ones(1, 2)
    with pytest.raises(ValueError, match="2 leaves, 1 prev"):
        hieavg_agg_many([w, w], [w], [w, w], m, m, m, m)
    assert hieavg_agg_many([], [], [], m, m, m, m) == ([], [], [])
    with pytest.raises(ValueError, match="CUDA tensors"):
        hieavg_agg_many([w], [w], [w], m, m, m, m, mode="cuda")


@pytest.mark.parametrize("c", [10, 100])
def test_eval_head_count_equals_pallas_at_many_classes(c):
    rng = np.random.default_rng(c)
    m, f = 300, 600
    feats, wmat = np32(rng, m, f), np32(rng, f, c, scale=f ** -0.5)
    bias = np32(rng, c, scale=0.1)
    labels = rng.integers(-1, c, m).astype(np.int32)   # -1 never counts
    # a third of the rows are right, so the count is not near 0
    pred = np.argmax(feats @ wmat + bias, axis=-1)
    labels[::3] = pred[::3]
    ref = jax_eval_head(feats, wmat, bias, labels, interpret=True)
    got = eval_head(t(feats), t(wmat), t(bias), t(labels))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(ref) >= m // 3 - 5
