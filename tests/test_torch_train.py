"""The port's LLM training path (``repro_torch.launch.train`` and what it
stands on) against the JAX package, on the CPU.

Weights are the reference's own (``init_from_specs`` of its
``param_specs``), carried over with ``transformer.params_from_numpy``;
tokens, labels and gradients are made with numpy from a seed.  The JAX
side attends through its XLA path (``USE_FLASH_KERNEL`` off, its
default on the CPU): the Pallas flash kernel has no backward, so
``_sdpa``'s autodiff is the reference's only attention gradient.  The
port runs its plain versions (``FlashAttentionFn`` with
``ref.flash_attention_bwd_ref``).  All at danube-smoke (2 layers,
d_model 128, head dim 32, float32) unless a case says otherwise.

Tolerances (float32):
  * the flash backward ``rtol 1e-5``, ``atol 1e-6`` times the gradient's
    largest magnitude (at least 1): dk and dv sum up to G x Sq = 4096
    products, and at S = 1024, G = 4 both packages lie 3e-6 to 5e-6 from a
    float64 run of the same case (largest |dk| 6.4).  The plain backward
    takes delta = rowsum(do o) in float64, so that a row whose
    probabilities are one key's (p = 1) gets dq = 0 as JAX's softmax
    autodiff does, not the float32 rounding of do v - delta;
  * ``loss_fn`` ``rtol 1e-5``; its gradients ``rtol 1e-4`` and ``atol``
    1e-3 times the leaf's largest gradient.  The reference's random
    weights give sharp attention, whose softmax backward amplifies float32
    rounding: the reference's own jit and eager evaluations of this loss
    differ by up to 2.0e-4 of a leaf's largest gradient (embed/tok at
    S = 64), the port by up to 3.3e-4.  A bfloat16 model is held by its
    loss alone (``rtol 1e-3``; 1.7e-4 measured): its gradients differ by
    5-10% of a leaf's largest, where the reference's jit and eager differ
    by 0.2-2%, because XLA and PyTorch round the bfloat16 intermediates
    at other places and the sharp attention amplifies that;
  * danube-smoke deepened to 24 layers: the loss ``rtol 1e-2`` and the
    largest gradient within 30x of a float64 run of the reference's (the
    rounding amplified through 24 layers leaves nothing tighter to hold);
  * the optimizers ``rtol 1e-6`` (one float32 rounding a step), bfloat16
    leaves within one bfloat16 ulp (the cast of a float32 result that may
    differ in its last bit);
  * the HieAvg train step, two steps from the cold boot: the loss
    ``rtol 1e-5``; every parameter and history leaf ``rtol 1e-5`` and
    ``atol`` 1e-6 plus 5e-3 times the leaf's largest change since the cold
    boot (the gradients' spread above, carried by the update: at most
    2.0e-3 of the change measured, the reference's jit against its eager
    1.7e-3).  With bfloat16 parameters both steps are handed the same
    seeded gradients (the bfloat16 gradients differ, see above), which
    holds the SGD's and HieAvg's order of casts: bfloat16 leaves within
    one bfloat16 ulp of the element, taken at no less than 2^-16 of the
    leaf's largest (below that an element is a float32 cancellation
    residue of the aggregate, e.g. 4.7e-10 against 4.4e-10 in a leaf of
    0.2), the leader's float32 history ``rtol 1e-5, atol 1e-6``;
  * ``train.run``: masks, batch indices and tokens bitwise, ``sim_clock``
    equal; the first global round's loss within the engine-parity loss
    bound (``rtol = atol = 1e-3``, ``tests/test_engine_parity.py``), the
    later rounds' within ``rtol 2e-2``: training these random weights is
    chaotic, and the reference's own jit and eager steps on these inputs
    end the third round at losses 9.6e-3 apart (6.6498 and 6.7137).

Rows of attention that see no key are held to the autodiff of a dense
out-of-place softmax, not to JAX, whose oracle gives the mean of v there.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
import repro.models.attention as jatt
from repro import optim as joptim
from repro.configs import get_smoke as j_get_smoke
from repro.launch.steps import init_fl_histories as j_init_hist
from repro.launch.steps import make_hfl_train_step as j_make_hfl
from repro.launch.steps import make_train_step as j_make_train
from repro.models import init_from_specs as j_init
from repro.models import loss_fn as j_loss_fn
from repro.models import param_specs as j_param_specs
from repro_torch import optim as toptim
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.launch import (init_fl_histories, make_hfl_train_step,
                                make_train_step)
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import flatten, unflatten
from repro_torch.models import loss_fn, transformer

ARCH = "h2o-danube-1.8b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread a test worker (the suite runs
    six workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _bf16_ulps(got, want, floor: float = 2.0 ** -126) -> float:
    """max |got - want| in bfloat16 ulps at the larger magnitude, taken
    at least ``floor``."""
    g, w = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), floor)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(g - w) / ulp).max()) if g.size else 0.0


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _ref_base(param_dtype: str) -> dict:
    """The reference's danube-smoke weights from seed 0 (numpy; read
    only), drawn once a dtype."""
    cfg = dataclasses.replace(j_get_smoke(ARCH), param_dtype=param_dtype)
    return _np(j_init(j_param_specs(cfg), jax.random.key(0),
                      param_dtype=getattr(jnp, param_dtype)))


def _ref_params(cfg):
    """The reference's weights (numpy) and the port's copy of them."""
    base = _ref_base(cfg.param_dtype)
    return base, transformer.params_from_numpy(base)


# ------------------------------------------------------- flash backward
BWD = [  # (Sq, Skv, H, Hkv, causal, window, q_offset)
    (40, 40, 4, 4, True, None, 0),
    (40, 40, 8, 2, True, 16, 0),
    (40, 40, 8, 2, False, None, 0),
    (40, 100, 8, 2, True, 30, 60),
    (1024, 1024, 4, 4, True, 300, 0),
    (1024, 1024, 8, 2, True, None, 0),
]


@pytest.mark.parametrize("sq,skv,h,hkv,causal,window,off", BWD)
def test_flash_bwd_ref_matches_jax_vjp_of_sdpa(sq, skv, h, hkv, causal,
                                               window, off):
    rng = np.random.default_rng(sq + h + (window or 0) + off)
    q, do = (rng.standard_normal((2, sq, h, 32)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, skv, hkv, 32)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=off)
    def vjp(a, b, c, d):
        out, back = jax.vjp(lambda *x: jatt._sdpa(*x, **kw), a, b, c)
        return out, back(d)

    out, want = jax.jit(vjp)(q, k, v, do)
    o, lse = ref.flash_attention_fwd_ref(_t(q), _t(k), _t(v), **kw)
    _close(o, out, 1e-5, 1e-6, "o")
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do),
                                      **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, 1e-5, 1e-6 * max(1.0, float(np.abs(w).max())), name)
    # the autograd Function takes the same plain backward on the CPU
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    fn = torch.autograd.grad(ops.flash_attention(qt, kt, vt, **kw),
                             (qt, kt, vt), _t(do))
    for g, f in zip(got, fn):
        assert torch.equal(g, f)


def _dense(q, k, v, causal, window, off):
    """Out-of-place dense GQA softmax attention; a row that sees no key
    gives 0."""
    g = q.shape[2] // k.shape[2]
    kk, vv = (x.repeat_interleave(g, dim=2) for x in (k, v))
    t = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(q.shape[-1])
    qpos = torch.arange(q.shape[1])[:, None] + off
    kpos = torch.arange(k.shape[1])[None, :]
    ok = torch.ones(t.shape[-2:], dtype=torch.bool)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    t = t.masked_fill(~ok, -math.inf)
    m = t.amax(-1, keepdim=True)
    p = torch.exp(t - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0, 1.0, l)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv), ok.any(-1)


@pytest.mark.parametrize("sq,skv,window,off", [(30, 30, None, -7),
                                               (20, 10, 4, 5)])
def test_flash_bwd_rows_that_see_no_key(sq, skv, window, off):
    """dq is exactly 0 on a row that sees no key, its do adds nothing to
    dk and dv, and the rest is the dense softmax's autodiff (float64)."""
    rng = np.random.default_rng(3)
    q, do = (rng.standard_normal((2, sq, 8, 32)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, skv, 2, 32)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=off)
    o, lse = ref.flash_attention_fwd_ref(_t(q), _t(k), _t(v), **kw)
    dq, dk, dv = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse,
                                             _t(do), **kw)
    qd, kd, vd = (_t(x).double().requires_grad_() for x in (q, k, v))
    out, seen = _dense(qd, kd, vd, True, window, off)
    want = torch.autograd.grad(out, (qd, kd, vd), _t(do).double())
    assert (~seen).any() and seen.any()
    assert bool((dq[:, ~seen] == 0).all())
    assert torch.isinf(lse[:, :, ~seen]).all()
    for g, w in zip((dq, dk, dv), want):
        _close(g, w, 1e-5, 1e-6)
    do0 = _t(do).clone()
    do0[:, ~seen] = 0.0
    _, dk0, dv0 = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse,
                                              do0, **kw)
    assert torch.equal(dk0, dk) and torch.equal(dv0, dv)


# --------------------------------------------------------------- loss_fn
def _tokens_labels(vocab, s, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (2, s)).astype(np.int32)
    lab = rng.integers(0, vocab, (2, s)).astype(np.int32)
    lab[0, :9] = -1
    lab[1, -3:] = -1
    return tok, lab


@pytest.mark.parametrize("s", [64, 1024], ids=["S64", "S1024_chunked"])
def test_loss_fn_and_its_gradients_match_jax(s):
    cfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    base, params = _ref_params(cfg)
    tok, lab = _tokens_labels(cfg.vocab, s, s)
    want_loss, want = jax.jit(jax.value_and_grad(functools.partial(
        j_loss_fn, cfg=cfg, remat=True)))(base, tok, lab)
    want = flatten(_np(want))
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in flatten(params).items()}
        loss = loss_fn(unflatten(leaves), _t(tok).long(), _t(lab).long(),
                       tcfg, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _close(loss, want_loss, 1e-5, 0.0, f"loss remat={remat}")
        assert want.keys() == leaves.keys()
        for k, g in zip(leaves, grads):
            _close(g, want[k], 1e-4, 1e-3 * float(np.abs(want[k]).max()),
                   f"{k} remat={remat}")


def test_loss_fn_bf16_matches_jax():
    cfg = dataclasses.replace(j_get_smoke(ARCH), param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke(ARCH), param_dtype="bfloat16")
    base, params = _ref_params(cfg)
    tok, lab = _tokens_labels(cfg.vocab, 64, 1)
    want = jax.jit(functools.partial(j_loss_fn, cfg=cfg))(base, tok, lab)
    with torch.no_grad():
        got = loss_fn(params, _t(tok).long(), _t(lab).long(), tcfg)
    assert got.dtype == torch.float32
    _close(got, want, 1e-3, 0.0)


def test_loss_fn_gradients_grow_with_depth_as_in_jax(monkeypatch):
    """danube-smoke deepened to 24 layers, the reference's weights (its
    ``init_from_specs``, jitted): the largest gradient grows with depth in
    the reference as in the port (16.7 at 2 layers, about 1e6 here), so a
    model deep enough is thrown off by one SGD step at the paper's lr with
    either package.  At this depth float32 rounding is amplified through
    the layers: the reference's own float32 gradients lie up to 2.6 times
    a leaf's largest value from a float64 run of it (its weights and
    activations widened), the port's 1.5 times, so the port is held to the
    float64 run only in the largest gradient, within 30x (1.21e6 against
    4.25e6 measured; the reference's float32 5.45e6), not leaf by leaf.
    The loss is held to ``rtol 1e-2`` (6.5e-4 measured)."""
    n = 24
    cfg = dataclasses.replace(j_get_smoke(ARCH), n_layers=n)
    base = _np(jax.jit(functools.partial(j_init, j_param_specs(cfg)))(
        jax.random.key(0)))
    tok, lab = _tokens_labels(cfg.vocab, 64, 1)

    def ref(cfg_, base_):
        loss, g = jax.jit(jax.value_and_grad(functools.partial(
            j_loss_fn, cfg=cfg_, remat=True)))(base_, tok, lab)
        return float(loss), flatten(_np(g))

    def largest(g):
        return max(float(np.abs(_f32(x)).max()) for x in g.values())

    def worst_leaf(g, want):
        return max(float(np.abs(_f32(g[k]) - want[k]).max()
                         / np.abs(want[k]).max()) for k in want)

    want_loss, want32 = ref(cfg, base)
    # the reference in float64: its config names no float64 dtype, so the
    # one property that maps the name is widened for this call
    jdt = type(cfg).jnp_param_dtype
    monkeypatch.setattr(type(cfg), "jnp_param_dtype", property(
        lambda c: jnp.float64 if c.param_dtype == "float64" else jdt.fget(c)))
    with jax.enable_x64(True):
        _, want64 = ref(dataclasses.replace(cfg, param_dtype="float64"),
                        jax.tree.map(lambda x: x.astype(np.float64), base))
    leaves = {k: v.clone().requires_grad_() for k, v in
              flatten(transformer.params_from_numpy(base)).items()}
    loss = loss_fn(unflatten(leaves), _t(tok).long(), _t(lab).long(),
                   dataclasses.replace(get_smoke(ARCH), n_layers=n),
                   remat=True)
    got = dict(zip(leaves, torch.autograd.grad(loss,
                                               list(leaves.values()))))
    print(f"\n{n} layers, largest gradient: reference float32 "
          f"{largest(want32):.4g}, float64 {largest(want64):.4g}, port "
          f"float32 {largest(got):.4g}; worst leaf against the float64 "
          f"run: reference float32 {worst_leaf(want32, want64):.3g}, port "
          f"{worst_leaf(got, want64):.3g}; loss {loss.item():.6g} against "
          f"{want_loss:.6g}")
    _close(loss, want_loss, 1e-2, 0.0)
    sizes = [largest(want32), largest(want64), largest(got)]
    assert all(math.isfinite(x) and x >= 1e3 for x in sizes), sizes
    assert sizes[1] / 30 <= sizes[2] <= sizes[1] * 30, sizes


# ------------------------------------------------------------ optimizers
def _opt_tree(rng, dtype):
    return {"a": rng.standard_normal((4, 5)).astype(dtype),
            "b": {"c": rng.standard_normal((7,)).astype(dtype)}}


def _opt_close(got, want, dtype):
    for k, w in flatten(_np(want)).items():
        g = flatten(got)[k]
        if dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            assert _bf16_ulps(g, w) <= 1.0, k
        else:
            _close(g, w, 1e-6, 0.0, k)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_sgd_and_adam_match_jax(dtype):
    rng = np.random.default_rng(0)
    p = _opt_tree(rng, np.float32)
    p = jax.tree.map(lambda x: jnp.asarray(x, dtype), p)
    tp = transformer.params_from_numpy(_np(p))
    lr = np.float32(0.05)
    for momentum in (0.0, 0.9):
        jp, js, tq, ts = p, joptim.sgd_init(p), tp, toptim.sgd_init(tp)
        for i in range(3):
            g = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                             _opt_tree(np.random.default_rng(i + 1),
                                       np.float32))
            jp, js = joptim.sgd_step(jp, g, js, jnp.float32(lr), momentum)
            tq, ts = toptim.sgd_step(tq, transformer.params_from_numpy(
                _np(g)), ts, lr, momentum)
            _opt_close(tq, jp, dtype)
        assert ts.count == int(js.count) == 3
    jp, js, tq, ts = p, joptim.adam_init(p), tp, toptim.adam_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                         _opt_tree(np.random.default_rng(i + 7), np.float32))
        jp, js = joptim.adam_step(jp, g, js, jnp.float32(lr))
        tq, ts = toptim.adam_step(tq, transformer.params_from_numpy(_np(g)),
                                  ts, lr)
        _opt_close(tq, jp, dtype)
        for mine, theirs in ((ts.mu, js.mu), (ts.nu, js.nu)):
            for k, w in flatten(_np(theirs)).items():
                _close(flatten(mine)[k], w, 1e-6, 0.0, k)


# ------------------------------------------------------ the train steps
STEPS = [  # (E, do_global, normalize, n_micro, param_dtype)
    (2, True, False, 2, "float32"),
    (1, False, True, 1, "float32"),
    (2, True, True, 1, "bfloat16"),
]


def _state(params, dev, glob, dev_flat: bool) -> dict:
    """{name: float32 numpy} of the parameters and both histories (the
    port's histories are flat already)."""
    out = {"params/" + k: _f32(v) for k, v in flatten(_np_or(params)).items()}
    for name, h in (("dev", dev), ("glob", glob)):
        for fld in ("prev_w", "delta_mean"):
            tree = getattr(h, fld)
            flat = tree if dev_flat else flatten(_np(tree))
            out.update({f"{name}.{fld}/{k}": _f32(v)
                        for k, v in flat.items()})
        for fld in ("n_obs", "miss_count"):
            out[f"{name}.{fld}"] = _f32(getattr(h, fld))
    return out


def _np_or(tree):
    return tree if isinstance(next(iter(flatten(tree).values())),
                              torch.Tensor) else _np(tree)


class _Grads:
    """The same seeded losses and gradients for every client on both
    sides: the reference's ``_per_client_grad`` ([E, C] at once) and the
    port's ``_client_grads`` (client by client, in (e, c) order)."""

    def __init__(self, flat_params, e, c, seed):
        rng = np.random.default_rng(seed)
        self.loss = rng.random((e, c)).astype(np.float32) + 6.0
        self.grads = {k: (rng.standard_normal(v.shape) * 0.3).astype(
            np.float32).astype(v.dtype) for k, v in flat_params.items()}
        self.calls = 0
        self.c = c

    def jax(self, *args, **kw):
        return jnp.asarray(self.loss), unflatten(
            {k: jnp.asarray(v) for k, v in self.grads.items()})

    def torch(self, *args, **kw):
        e, c = divmod(self.calls, self.c)
        self.calls += 1
        return (torch.tensor(self.loss[e, c]),
                {k: transformer.params_from_numpy({"g": v[e, c]})["g"]
                 for k, v in self.grads.items()})


@pytest.mark.parametrize("e,do_global,normalize,n_micro,dt", STEPS)
def test_hfl_train_step_matches_jax(monkeypatch, e, do_global, normalize,
                                    n_micro, dt):
    """Two steps from the cold boot (all present, then stragglers at both
    layers): parameters, both histories (counts exactly) and the loss."""
    import repro.launch.steps as jsteps
    import repro_torch.launch.steps as tsteps
    cfg = dataclasses.replace(j_get_smoke(ARCH), param_dtype=dt)
    tcfg = dataclasses.replace(get_smoke(ARCH), param_dtype=dt)
    c, bf16 = 2, dt == "bfloat16"
    base, _ = _ref_params(cfg)
    jp = jax.tree.map(lambda x: jnp.broadcast_to(x, (e, c) + x.shape), base)
    jd, jg = j_init_hist(jp)
    tp = transformer.params_from_numpy(_np(jp))
    td, tg = init_fl_histories(tp)
    init = _state(jp, jd, jg, False)
    kw = dict(gamma0=0.9, lam=0.9, do_global=do_global, normalize=normalize,
              n_micro=n_micro)
    jstep = jax.jit(j_make_hfl(cfg, **kw))
    tstep = make_hfl_train_step(tcfg, **kw)
    rng = np.random.default_rng(e * 10 + n_micro)
    masks = [(np.ones((e, c), bool), np.ones((e,), bool)),
             (np.array([[True, False], [False, False]])[:e],
              np.array([False, True])[:e])]
    for i, (dm, em) in enumerate(masks):
        if bf16:
            grads = _Grads(flatten(_np(jp)), e, c, i)
            monkeypatch.setattr(jsteps, "_per_client_grad", grads.jax)
            monkeypatch.setattr(tsteps, "_client_grads", grads.torch)
            jstep = jax.jit(j_make_hfl(cfg, **kw))   # traced anew: new grads
        tok = rng.integers(0, cfg.vocab, (e, c, 2, 40)).astype(np.int32)
        lab = rng.integers(0, cfg.vocab, (e, c, 2, 40)).astype(np.int32)
        lab[..., :3] = -1
        lr = np.float32(0.05 / (i + 1))
        jp, jd, jg, jloss = jstep(jp, jd, jg, {"tokens": tok, "labels": lab},
                                  dm, em, jnp.float32(lr))
        tp, td, tg, tloss = tstep(
            tp, td, tg, {"tokens": _t(tok).long(), "labels": _t(lab).long()},
            _t(dm), _t(em), lr)
        want, got = _state(jp, jd, jg, False), _state(tp, td, tg, True)
        assert want.keys() == got.keys()
        for key, w in want.items():
            g = got[key]
            assert g.shape == w.shape, key
            if key.endswith(("n_obs", "miss_count")):
                np.testing.assert_array_equal(g, w, err_msg=key)
            elif bf16 and not key.startswith("glob."):
                assert _bf16_ulps(g, w, 2.0 ** -16 * np.abs(w).max()) \
                    <= 1.0, (i, key)
            else:
                change = 0.0 if bf16 else float(np.abs(w - init[key]).max())
                _close(g, w, 1e-5, 1e-6 + 5e-3 * change, f"step {i} {key}")
        _close(tloss, jloss, 1e-5, 0.0, f"loss {i}")
    # the device histories keep the parameters' dtype, the leader's float32
    assert td.prev_w["embed/tok"].dtype == getattr(torch, dt)
    assert tg.prev_w["embed/tok"].dtype == torch.float32


def test_train_step_matches_jax():
    cfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    base, params = _ref_params(cfg)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    want, wloss = jax.jit(j_make_train(cfg))(base, tok, lab,
                                             jnp.float32(0.1))
    got, loss = make_train_step(tcfg)(params, _t(tok).long(),
                                      _t(lab).long(), np.float32(0.1))
    _close(loss, wloss, 1e-5, 0.0)
    for k, w in flatten(_np(want)).items():
        change = float(np.abs(w - flatten(base)[k]).max())
        _close(flatten(got)[k], w, 1e-5, 1e-6 + 5e-3 * change, k)


# ------------------------------------------------------------- train.run
class _Recorder:
    """Wraps the drivers' host-plane entry points and records what they
    hand out: the straggler masks, the batch draws and the token table."""

    def __init__(self, module, monkeypatch):
        self.masks, self.draws, self.data = [], [], []
        strag, stream_rng, lm_tokens = (module.straggler, module.stream_rng,
                                        module.lm_tokens)
        rec = self

        class Straggler:
            @staticmethod
            def from_fraction(*a, **k):
                out = strag.from_fraction(*a, **k)
                rec.masks.append(np.array(out))
                return out

        class Rng:
            def __init__(self, g):
                self.g = g

            def integers(self, *a, **k):
                out = self.g.integers(*a, **k)
                rec.draws.append(np.array(out))
                return out

        def tokens(*a, **k):
            out = lm_tokens(*a, **k)
            rec.data.append(np.array(out))
            return out

        monkeypatch.setattr(module, "straggler", Straggler)
        monkeypatch.setattr(module, "stream_rng",
                            lambda *a, **k: Rng(stream_rng(*a, **k)))
        monkeypatch.setattr(module, "lm_tokens", tokens)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "loop"])
def test_train_run_matches_jax(monkeypatch, fused):
    cfg = j_get_smoke(ARCH)
    kw = dict(smoke=True, steps=3, k_edge=2, progress=False, fused=fused)
    jrec = _Recorder(jtrain, monkeypatch)
    want = jtrain.run(ARCH, **kw)
    trec = _Recorder(ttrain, monkeypatch)
    seen = []
    make = ttrain.make_hfl_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def wrapped(params, dh, gh, batch, dm, em, lr):
            seen.append((batch["tokens"].clone(), batch["labels"].clone(),
                         dm.clone(), em.clone()))
            return step(params, dh, gh, batch, dm, em, lr)
        return wrapped

    monkeypatch.setattr(ttrain, "make_hfl_train_step", recording)
    got = ttrain.run(ARCH, device="cpu", init_params=_ref_base("float32"),
                     **kw)

    for a, b in ((trec.masks, jrec.masks), (trec.draws, jrec.draws),
                 (trec.data, jrec.data)):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    data, dms = jrec.data[0], jrec.masks[0]
    e, c = 1, 2
    assert len(seen) == 6
    for r, (tk, lb, dm, em) in enumerate(seen):
        chunk = data[jrec.draws[r]].reshape(e, c, 4, 65)
        np.testing.assert_array_equal(tk.numpy(), chunk[..., :-1])
        np.testing.assert_array_equal(lb.numpy(), chunk[..., 1:])
        np.testing.assert_array_equal(dm.numpy(), dms[r].reshape(e, c))
        np.testing.assert_array_equal(em.numpy(), jrec.masks[1][r // 2])
    assert got.keys() == want.keys()
    if fused:
        np.testing.assert_array_equal(got["sim_clock"], want["sim_clock"])
    assert (got["blocks"], got["chain_valid"]) == (want["blocks"],
                                                   want["chain_valid"])
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-2)


def test_train_run_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        ttrain.run(ARCH, steps=1, k_edge=1, progress=False)
    with pytest.raises(ValueError, match="kernel_mode"):
        ttrain.run(ARCH, steps=1, k_edge=1, device="cpu", kernel_mode="x")
