"""The multi-leaf ``coef_agg_many`` and ``coef_agg_pair_many`` against the
JAX package's Pallas kernels, and their wrappers' host path.

On the CPU the wrappers run their plain PyTorch versions, which must match
the JAX kernels run through the Pallas interpreter (``interpret=True``) on
the same numpy inputs: the paper's CNN's six leaves at a TINY width, at
the edge layer's lead (two edges of five participants, against
``jax.vmap`` of the Pallas kernel over the edges, leaf by leaf) and at the
global layer's (five edges), ``rtol 1e-6, atol 1e-6`` (a sum over
participants that may cancel; the bounds of
``tests/test_torch_kernels.py::test_coef_agg_matches_pallas``).  A
zero-coefficient slot adds exactly nothing.

The host path (what the wrapper hands its launcher) runs here with
``build.use_kernel`` forced on and a stub in place of the built library:
one launch per aggregate, the column and start tables, the 16-byte flags
and the output views.  The CUDA kernel itself is held against the plain
versions on the card by ``tests/test_torch_gpu.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels.coef_agg import coef_agg as jax_coef_agg  # noqa: E402
from repro.kernels.coef_agg import coef_agg_pair as jax_coef_agg_pair  # noqa: E402,E501
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.coef_agg import (coef_agg_many,  # noqa: E402
                                          coef_agg_pair_many)
from repro_torch.models import cnn_specs  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.kernel_oracle

#: the paper's CNN's leaves at a TINY width (8x8 images, c1 4, c2 8)
LEAVES = [tuple(s.shape) for s in cnn_specs(8, 1, 10, c1=4, c2=8).values()]
#: the edge layer's lead (two edges of five) and the global layer's
LEADS = [(2, 5), (5,)]
KINDS = ["single", "pair"]


def t(a):
    return torch.from_numpy(np.array(a))


def np32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(rng, kind, lead):
    """Per leaf w (and aux) ``[*lead, *leaf]`` and the coefficients
    ``[*lead]``: one vector, or a delayed-gradient mix (present slots
    weigh w, missing ones aux)."""
    ws = [np32(rng, *lead, *s) for s in LEAVES]
    c = rng.random(lead).astype(np.float32)
    if kind == "single":
        return ws, None, (c,)
    mask = rng.random(lead) > 0.4
    return ws, [np32(rng, *lead, *s) for s in LEAVES], (c * mask, c * ~mask)


def _run(kind, ws, auxes, coefs, mode="auto"):
    if kind == "single":
        return coef_agg_many(ws, *coefs, mode=mode)
    return coef_agg_pair_many(ws, auxes, *coefs, mode=mode)


@pytest.mark.parametrize("lead", LEADS, ids=["edges", "global"])
@pytest.mark.parametrize("kind", KINDS)
def test_coef_agg_many_matches_pallas_per_leaf(kind, lead):
    rng = np.random.default_rng(len(lead) + 3 * KINDS.index(kind))
    ws, auxes, coefs = _inputs(rng, kind, lead)
    got = _run(kind, [t(w) for w in ws], auxes and [t(a) for a in auxes],
               [t(c) for c in coefs])
    fn = jax_coef_agg if kind == "single" else jax_coef_agg_pair
    pallas = functools.partial(fn, interpret=True)
    if len(lead) > 1:
        pallas = jax.vmap(pallas)
    assert len(got) == len(LEAVES)
    for k, shape in enumerate(LEAVES):
        flat = lead + (int(np.prod(shape)),)
        operands = [ws[k].reshape(flat)]
        if auxes:
            operands.append(auxes[k].reshape(flat))
        want = np.asarray(pallas(*operands, *coefs))
        assert tuple(got[k].shape) == lead[:-1] + shape
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy().reshape(want.shape), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_coef_agg_many_zero_coefficient_slot_adds_exactly_nothing(kind):
    rng = np.random.default_rng(11)
    ws, auxes, coefs = _inputs(rng, kind, (2, 5))
    for c in coefs:
        c[1, 3] = 0.0
    clean = _run(kind, [t(w) for w in ws], auxes and [t(a) for a in auxes],
                 [t(c) for c in coefs])
    junk = [[t(a) for a in leaves] for leaves in (ws, auxes) if leaves]
    for leaves in junk:
        for a in leaves:
            a[1, 3] = 1e6
    got = _run(kind, junk[0], junk[1] if auxes else None,
               [t(c) for c in coefs])
    assert all(torch.equal(a, b) for a, b in zip(clean, got))


class _StubLibrary:
    """In place of the built library: each launcher records what it was
    handed and returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(build, "use_kernel", lambda mode, w: True)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream", lambda: 0)
    return lib


def _table(arr, k):
    return [arr[i] for i in range(k)]


@pytest.mark.parametrize("lead", LEADS, ids=["edges", "global"])
@pytest.mark.parametrize("kind", KINDS)
def test_coef_agg_many_host_path_is_one_launch_per_aggregate(stub, kind,
                                                            lead):
    rng = np.random.default_rng(5)
    ws, auxes, coefs = _inputs(rng, kind, lead)
    names = [f"leaf{k}" for k in range(len(LEAVES))]
    stacked = {k: t(w) for k, w in zip(names, ws)}
    # the dense leaf a view one float off 16 bytes, as a leaf of an
    # earlier flat output may be
    base = torch.zeros(int(np.prod(ws[-2].shape)) + 1)
    stacked[names[-2]] = base[1:].view(ws[-2].shape)
    stacked[names[-2]].copy_(t(ws[-2]))
    name = "coef_agg" if kind == "single" else "coef_agg_pair"
    before = build.LAUNCHES[name]
    if kind == "single":
        out = ops.fused_coef_aggregate(stacked, t(coefs[0]))
    else:
        aux = {k: t(a) for k, a in zip(names, auxes)}
        out = ops.fused_coef_aggregate_pair(stacked, aux, *map(t, coefs))
    assert [c[0] for c in stub.calls] == [f"{name}_launch"]
    assert build.LAUNCHES[name] == before + 1
    ptrs, cols, starts, vec, k, coef, flat, B, n, stream = stub.calls[0][1]
    assert k == len(LEAVES)
    L = [int(np.prod(s)) for s in LEAVES]
    assert _table(cols, k) == L
    want_starts = np.concatenate([[0], np.cumsum(-(-np.array(L) // 4) * 4)])
    assert _table(starts, k) == list(want_starts[:-1])
    assert all(s % 4 == 0 for s in _table(starts, k))
    assert (B, n) == (int(np.prod(lead[:-1])), lead[-1])
    operands = [stacked[m] for m in names]
    if kind == "pair":
        operands = [x for m in names for x in (stacked[m], aux[m])]
    assert _table(ptrs, len(operands)) == [x.data_ptr() for x in operands]
    # 16 bytes where the leaf's rows allow it: not for the 10-column bias,
    # nor for the view one float off
    flags = _table(vec, k)
    assert flags[-1] == 0 and flags[-2] == 0
    assert flags[:-2] == [int(x % 4 == 0) for x in L[:-2]]
    # the outputs: views of one flat [B, total] allocation, leaf k at
    # column start[k] of each row block
    assert list(out) == names
    for j, m in enumerate(names):
        o = out[m]
        assert tuple(o.shape) == lead[:-1] + LEAVES[j]
        assert o.is_contiguous()
        assert o.storage_offset() == B * want_starts[j]
        assert o.untyped_storage().data_ptr() == flat
    assert out[names[-1]].untyped_storage().nbytes() == 4 * B * want_starts[-1]
    assert stream == 0 and isinstance(coef, int)


@pytest.mark.parametrize("kind", KINDS)
def test_coef_agg_many_checks_its_leaves(stub, kind):
    w = torch.zeros(2, 5, 3)
    c = torch.ones(2, 5)

    def call(ws, coef=c, **kw):
        if kind == "single":
            return coef_agg_many(ws, coef, **kw)
        return coef_agg_pair_many(ws, ws, coef, coef, **kw)

    with pytest.raises(ValueError, match="at most 64"):
        call([w] * 65)
    with pytest.raises(ValueError, match="does not lead"):
        call([torch.zeros(5, 2, 3)])
    with pytest.raises(TypeError, match="float32"):
        call([w.double()])
    with pytest.raises(ValueError, match="coefficients on meta"):
        call([w], coef=c.to("meta"))
    assert not stub.calls
    assert call([]) == []
    call([w, torch.zeros(2, 5, 4, 4)])
    assert len(stub.calls) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_coef_agg_many_plain_path_checks_its_leaves(kind):
    w, c = torch.zeros(5, 2, 3), torch.ones(2, 5)
    with pytest.raises(ValueError, match="does not lead"):
        if kind == "single":
            coef_agg_many([w], c)
        else:
            coef_agg_pair_many([w], [w], c, c)
    with pytest.raises(ValueError, match="CUDA tensors"):
        coef_agg_many([torch.zeros(2, 5, 3)], c, mode="cuda")
    with pytest.raises(ValueError, match="1 leaves, 2 aux"):
        coef_agg_pair_many([w], [w, w], c, c)
