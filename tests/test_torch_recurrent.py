"""The recurrent layer kinds of the port against the JAX package, on the
CPU: Mamba-2's SSD (``ssd``: mamba2-130m) and RG-LRU with its local
attention and its (rec, rec) tail (``rec``: recurrentgemma-9b), at the
reference's smoke widths (mamba2-smoke: 2 layers, d 128, d_state 16,
head dim 32, chunk 16; recurrentgemma-smoke: 5 layers = one unit and the
tail, head dim 32, window 16, lru width 128; float32).

The reference's weights are carried over leaf for leaf
(``transformer.params_from_numpy``); every other input is made with numpy
from a seed.

Bounds.  The port runs the reference's recurrences in another order: the
chunks' states in a loop where the reference scans them associatively,
``linear_scan`` as a doubling scan where the reference runs
``jax.lax.associative_scan``, ``cumsum`` sequentially where XLA's CPU
backend scans associatively.  So ``ssd_core`` and ``linear_scan`` are held
to ``SCAN_FACTOR`` (4) times the reference's own distance to a float64
sequential recurrence on the same inputs, measured in each test, plus
``SCAN_FLOOR`` (4 float32 ulps) of the float64 result's largest magnitude
(at one step both sides compute ``a h + g``, which XLA may contract into
one FMA).  Measured: the port's distance to the reference was 1.4-2.1
times the reference's own to float64.  ``ssd_core``'s gradients are held
the same way, the float64 anchor the port's own algorithm in float64.
``_segsum`` is held bitwise on inputs whose every partial sum is exact in
float32 (multiples of 1/64), where no order of the sums can differ.
Layers, models, caches and gradients take the bounds of
``tests/test_torch_mla_moe.py``: a layer's output ``atol 3e-4``; logits,
caches and decode logits ``3e-4`` times their largest magnitude (at least
1); ``loss_fn`` ``rtol 1e-5`` and its gradients ``rtol 1e-4`` with
``atol`` 1e-3 times the leaf's largest gradient (measured: 4.7e-6 of a
leaf's largest at mamba2-smoke, 1.3e-4 at recurrentgemma-smoke's ``lam``);
the HieAvg step ``rtol 1e-5, atol 1e-6``.  The plain flash version at
head dim 256 against the reference's ``_sdpa``: ``atol 2e-5``, the
reference's flash bound (``tests/test_kernels.py``).
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as jsteps
import repro.models.attention as jatt
import repro.models.rglru as jrg
import repro.models.ssd as jssd
import repro.models.transformer as jtr
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.launch.steps import init_fl_histories as j_init_hist
from repro.launch.steps import make_hfl_train_step as j_make_hfl
from repro.models import cache_specs as j_cache_specs
from repro.models import count_params as j_count_params
from repro.models import init_from_specs as j_init
from repro.models import param_specs as j_param_specs
from repro.models.spec import ParamSpec as JParamSpec
from repro_torch import configs as tconfigs
from repro_torch.configs import get_smoke
from repro_torch.kernels import build, ops
from repro_torch.launch import (init_fl_histories, make_hfl_train_step,
                                make_prefill_step, make_serve_step, serve,
                                train)
from repro_torch.launch import steps as tsteps
from repro_torch.launch.steps import flatten, unflatten
from repro_torch.models import ParamSpec, count_params, rglru, ssd, \
    transformer
from repro_torch.models.spec import init_from_specs

#: the flash kernels' module (``repro_torch.kernels.flash_attention`` is
#: the re-exported function)
tflash = importlib.import_module("repro_torch.kernels.flash_attention")
ATOL = 3e-4
ARCHS = ("mamba2-130m", "recurrentgemma-9b")
B = 2
SCAN_FACTOR, SCAN_FLOOR = 4.0, 4 * 2.0 ** -23


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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=0.0, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _close_scaled(got, want, msg=""):
    """``ATOL`` times the largest magnitude of ``want`` (at least 1)."""
    want = np.asarray(want)
    _close(got, want, atol=ATOL * max(1.0, np.abs(want).max()), msg=msg)


def _scan_close(got, want, exact, msg=""):
    """The port within SCAN_FACTOR times the reference's own distance to
    the float64 ``exact``, plus SCAN_FLOOR of exact's largest magnitude."""
    got, want = (np.asarray(x.detach().numpy() if isinstance(
        x, torch.Tensor) else x, np.float64) for x in (got, want))
    own = np.abs(want - exact).max()
    bound = SCAN_FACTOR * own + SCAN_FLOOR * np.abs(exact).max()
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= bound, \
        f"{msg}: {err} > {bound} (the reference's own distance {own})"


@functools.lru_cache(maxsize=None)
def _ref_base(arch: str) -> dict:
    """Weights for the reference's smoke specs, drawn with numpy from seed
    0 by the reference's rule (N(0, 1) / sqrt(fan_in), ones, zeros), as
    float32 numpy (read only)."""
    rng = np.random.default_rng(0)

    def draw(spec):
        if spec.init in ("ones", "zeros"):
            return getattr(np, spec.init)(spec.shape, np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return (rng.standard_normal(spec.shape)
                / np.sqrt(max(fan_in, 1))).astype(np.float32)

    return jax.tree.map(draw, j_param_specs(j_get_smoke(arch)),
                        is_leaf=lambda x: isinstance(x, JParamSpec))


def _setup(arch):
    """(cfg, the port's cfg, JAX params, the port's params)."""
    base = _ref_base(arch)
    return (j_get_smoke(arch), get_smoke(arch),
            jax.tree.map(jnp.asarray, base),
            transformer.params_from_numpy(base))


def _shapes(tree, leaf_type):
    return {k: tuple(v.shape) for k, v in flatten(tree).items()
            if isinstance(v, leaf_type)}


def _x(cfg, s, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------ configs and specs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_specs_and_caches_match_jax(arch):
    """FULL and smoke configs field for field, ``param_specs`` (the tail's
    unstacked leaves, SSD's missing ``ffn``) and ``cache_specs`` names and
    shapes at both widths; the recurrent states float32 beside bfloat16 KV
    caches."""
    for get, jget in ((tconfigs.get_config, j_get_config),
                      (tconfigs.get_smoke, j_get_smoke)):
        cfg, tcfg = jget(arch), get(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        assert _shapes(transformer.param_specs(tcfg), ParamSpec) == \
            _shapes(j_param_specs(cfg), JParamSpec)
        for batch, max_len in ((2, 8224), (1, 64)):
            assert _shapes(transformer.cache_specs(tcfg, batch, max_len),
                           ParamSpec) == \
                _shapes(j_cache_specs(cfg, batch, max_len), JParamSpec)
    dtypes = {k: v.dtype for k, v in flatten(transformer.cache_specs(
        tcfg, 1, 64, dtype=torch.bfloat16)).items()}
    for k, dt in dtypes.items():
        assert dt == (torch.bfloat16 if k.endswith(("/k", "/v"))
                      else torch.float32), k
    if arch == "recurrentgemma-9b":
        assert set(transformer.param_specs(tcfg)["tail"]) == {"0", "1"}
        assert {"tail/0/h", "tail/1/conv", "unit/2/k"} <= set(dtypes)
    else:
        assert "ffn" not in transformer.param_specs(tcfg)["unit"]["0"]


@pytest.mark.parametrize("arch,count", [("recurrentgemma-9b", 9396088832),
                                        ("mamba2-130m", 128940480)])
def test_full_param_counts_match_jax(arch, count):
    cfg = tconfigs.get_config(arch)
    n = count_params(transformer.param_specs(cfg))
    assert n == j_count_params(j_param_specs(j_get_config(arch))) == count


# --------------------------------------------------------------- the SSD
def test_segsum_is_the_references_exactly():
    """Bitwise on multiples of 1/64 (every partial sum exact in float32,
    so no order of the sums can differ), -inf above the diagonal in the
    same places; on random inputs within 4 ulps of the largest."""
    rng = np.random.default_rng(0)
    a = (-rng.integers(0, 64, (2, 3, 16, 4)) / 64.0).astype(np.float32)
    want = np.asarray(jssd._segsum(jnp.asarray(a)))
    got = ssd._segsum(_t(a)).numpy()
    assert got.shape == want.shape == (2, 3, 4, 16, 16)
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[..., 0, 1]).all() and (got[..., 3, 3] == 0).all()
    a = -rng.random((2, 3, 16, 4)).astype(np.float32)
    want = np.asarray(jssd._segsum(jnp.asarray(a)))
    got = ssd._segsum(_t(a)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    assert np.abs(got[fin] - want[fin]).max() <= 4 * 2.0 ** -23 * \
        np.abs(want[fin]).max()


def _ssd_inputs(s, with_h0, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, 4, 8)).astype(np.float32)
    a = -rng.random((B, s, 4)).astype(np.float32)
    Bm, C = (rng.standard_normal((B, s, 6)).astype(np.float32)
             for _ in range(2))
    h0 = rng.standard_normal((B, 4, 8, 6)).astype(np.float32) \
        if with_h0 else None
    return x, a, Bm, C, h0


def _ssd_f64(x, a, Bm, C, h0):
    """The recurrence one step at a time in float64."""
    x, a, Bm, C = (v.astype(np.float64) for v in (x, a, Bm, C))
    h = np.zeros(x.shape[:1] + x.shape[2:] + Bm.shape[-1:]) if h0 is None \
        else h0.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        h = np.exp(a[:, t])[..., None, None] * h \
            + x[:, t][..., None] * Bm[:, t][:, None, None, :]
        ys.append(np.einsum("bn,bhpn->bhp", C[:, t], h))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [5, 32, 37])
def test_ssd_core_matches_jax(s, with_h0):
    """S shorter than the chunk (16), two whole chunks, and a ragged S,
    from zero and from a given state: the output and the final state."""
    x, a, Bm, C, h0 = _ssd_inputs(s, with_h0)
    jy, jh = jax.jit(jssd.ssd_core, static_argnums=4)(
        *map(jnp.asarray, (x, a, Bm, C)), 16,
        None if h0 is None else jnp.asarray(h0))
    ty, th = ssd.ssd_core(*map(_t, (x, a, Bm, C)), 16,
                          None if h0 is None else _t(h0))
    fy, fh = _ssd_f64(x, a, Bm, C, h0)
    _scan_close(ty, jy, fy, "y")
    _scan_close(th, jh, fh, "final state")


def test_ssd_core_gradients_match_jax():
    """``jax.grad`` of a seeded projection of (y, final state) against
    ``torch.autograd`` through the port's ``ssd_core``, every input's
    gradient (x, a_log, B, C, h0; S 37, ragged over chunks of 16): finite,
    and within SCAN_FACTOR of the reference's distance to the port's
    algorithm in float64."""
    x, a, Bm, C, h0 = _ssd_inputs(37, True, seed=2)
    rng = np.random.default_rng(3)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    wh = rng.standard_normal(h0.shape).astype(np.float32)

    def jloss(*args):
        y, h = jssd.ssd_core(*args[:4], 16, args[4])
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *map(jnp.asarray, (x, a, Bm, C, h0)))

    def grads(dtype):
        ins = [_t(v).to(dtype).requires_grad_() for v in (x, a, Bm, C, h0)]
        y, h = ssd.ssd_core(*ins[:4], 16, ins[4])
        loss = (y * _t(wy).to(dtype)).sum() + (h * _t(wh).to(dtype)).sum()
        return torch.autograd.grad(loss, ins)

    for name, g, w, e in zip(("x", "a_log", "B", "C", "h0"),
                             grads(torch.float32), want,
                             grads(torch.float64)):
        _scan_close(g, w, e.numpy(), f"d{name}")


# ------------------------------------------------------------ the RG-LRU
def _scan_f64(a, g, h0):
    h = h0.astype(np.float64)
    out = []
    for t in range(a.shape[1]):
        h = a[:, t].astype(np.float64) * h + g[:, t]
        out.append(h)
    return np.stack(out, 1), h


@pytest.mark.parametrize("case,s,lo,hi,chunk", [
    ("one_step", 1, 0.5, 1.0, 4), ("under_a_chunk", 3, 0.5, 1.0, 4),
    ("ragged_chunks", 21, 0.3, 1.0, 4), ("a_near_0", 21, 0.0, 1e-6, 4),
    ("a_near_1", 21, 0.999, 1.0, 4), ("default_chunk", 600, 0.0, 1.0, 256)])
def test_linear_scan_matches_jax(case, s, lo, hi, chunk):
    """One step, fewer steps than a chunk, ragged chunks, a near 0 (its
    products underflow to 0) and near 1, and the default chunk over three
    chunks: h at every step and the final h, from a given h0."""
    rng = np.random.default_rng(s)
    a = rng.uniform(lo, hi, (B, s, 8)).astype(np.float32)
    g = rng.standard_normal((B, s, 8)).astype(np.float32)
    h0 = rng.standard_normal((B, 8)).astype(np.float32)
    jh, jf = jax.jit(jrg.linear_scan, static_argnames="chunk")(
        *map(jnp.asarray, (a, g, h0)), chunk=chunk)
    th, tf = rglru.linear_scan(*map(_t, (a, g, h0)), chunk=chunk)
    fh, ff = _scan_f64(a, g, h0)
    _scan_close(th, jh, fh, f"{case}: h")
    _scan_close(tf, jf, ff, f"{case}: final h")


# --------------------------------------------------------------- layers
_J_MODES = {"rec": (jrg.rglru_train, jrg.rglru_prefill, jrg.rglru_decode),
            "ssd": (jssd.ssd_train, jssd.ssd_prefill, jssd.ssd_decode)}
_SPECS = {"rec": (jrg.rglru_cache_spec, rglru.rglru_cache_spec),
          "ssd": (jssd.ssd_cache_spec, ssd.ssd_cache_spec)}


def _layer_setup(kind, random_cache, seed=6):
    """(cfg, the port's cfg, the layer's JAX and port mixer params, and a
    cache: zeros or N(0, 1) numpy)."""
    arch = "recurrentgemma-9b" if kind == "rec" else "mamba2-130m"
    cfg, tcfg, params, tparams = _setup(arch)
    jp = jax.tree.map(lambda v: v[0], params["unit"]["0"]["mixer"])
    tp = transformer._index(tparams["unit"]["0"]["mixer"], 0)
    rng = np.random.default_rng(seed)
    cache = {k: (rng.standard_normal(v.shape) if random_cache
                 else np.zeros(v.shape)).astype(np.float32)
             for k, v in _SPECS[kind][0](cfg, B, None).items()}
    return cfg, tcfg, jp, tp, cache


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("kind", ["rec", "ssd"])
def test_layer_matches_jax(kind, mode):
    """One RG-LRU or SSD layer over a seeded x (40 tokens; one in decode,
    from a random cache): its output and, where it keeps one, the cache it
    writes (the port's in place)."""
    cfg, tcfg, jp, tp, cache = _layer_setup(kind, mode == "decode")
    train_, prefill_, decode_ = _J_MODES[kind]
    tmod = transformer.RECURRENT[kind]
    x = _x(cfg, 1 if mode == "decode" else 40)
    if mode == "train":
        _close(tmod[0](tp, _t(x), tcfg), jax.jit(functools.partial(
            train_, cfg=cfg))(jp, jnp.asarray(x)))
        return
    jfn, tfn = (prefill_, tmod[1]) if mode == "prefill" \
        else (decode_, tmod[2])
    want, jc = jax.jit(functools.partial(jfn, cfg=cfg))(
        jp, jnp.asarray(x), cache=jax.tree.map(jnp.asarray, cache))
    tc = {k: _t(v) for k, v in cache.items()}
    got, tc2 = tfn(tp, _t(x), tcfg, tc)
    _close(got, want)
    for k in cache:
        assert tc2[k] is tc[k]     # written in place
        _close_scaled(tc[k], jc[k], k)


@pytest.mark.parametrize("kind", ["rec", "ssd"])
def test_prefill_from_a_nonzero_cache_keeps_the_references_quirks(kind):
    """Prefill over a cache that holds N(0, 1) values: RG-LRU starts its
    recurrence from the cached ``h`` but its conv from zeros, SSD starts
    both from zeros (the cache ignored): the port as the reference, and
    each as its quirk says (the same output as from a zeroed cache in
    the part it ignores)."""
    cfg, tcfg, jp, tp, cache = _layer_setup(kind, True)
    prefill_ = _J_MODES[kind][1]
    tprefill = transformer.RECURRENT[kind][1]
    x = _x(cfg, 40, seed=7)
    want, jc = jax.jit(functools.partial(prefill_, cfg=cfg))(
        jp, jnp.asarray(x), cache=jax.tree.map(jnp.asarray, cache))
    got, _ = tprefill(tp, _t(x), tcfg, {k: _t(v) for k, v in
                                        cache.items()})
    _close(got, want)
    zero_conv = {k: (v if k == "h" else np.zeros_like(v))
                 for k, v in cache.items()}
    same, _ = tprefill(tp, _t(x), tcfg, {k: _t(v) for k, v in
                                         zero_conv.items()})
    assert torch.equal(same, got)           # the conv window is ignored
    zeros, _ = tprefill(tp, _t(x), tcfg, {k: _t(np.zeros_like(v))
                                          for k, v in cache.items()})
    assert torch.equal(zeros, got) == (kind == "ssd")   # h: used by rec


# --------------------------------------------------------------- models
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    cfg, tcfg, params, tparams = _setup(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, 48))
    want, _ = jax.jit(functools.partial(jtr.forward_train, cfg=cfg))(
        params, jnp.asarray(toks))
    got, aux = transformer.forward_train(tparams, _t(toks).long(), tcfg)
    _close_scaled(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_jax(arch):
    """A 40-token prompt (past recurrentgemma-smoke's window of 16), then
    ``decode_step`` fed the reference's greedy tokens: the logits at every
    step, and every cache (the tail's included) at the end."""
    cfg, tcfg, params, tparams = _setup(arch)
    prompt, steps = 40, 6
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, prompt)).astype(np.int32)
    jc = j_init(j_cache_specs(cfg, B, prompt + steps, dtype=jnp.float32),
                jax.random.key(1))
    tc = init_from_specs(transformer.cache_specs(
        tcfg, B, prompt + steps, dtype=torch.float32), None)
    logits, jc = jax.jit(functools.partial(jtr.prefill, cfg=cfg))(
        params, jnp.asarray(prompts), caches=jc)
    got, tc = make_prefill_step(tcfg)(tparams, _t(prompts).long(), tc)
    _close_scaled(got, logits, "prefill")
    jdec = jax.jit(functools.partial(jtr.decode_step, cfg=cfg))
    tdec = make_serve_step(tcfg)
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    for i in range(steps - 1):
        want, jc = jdec(params, jnp.asarray(tok)[:, None],
                        jnp.asarray(prompt + i, jnp.int32), caches=jc)
        got, tc = tdec(tparams, _t(tok).long()[:, None], prompt + i, tc,
                       None)
        _close_scaled(got, want, f"step {i}")
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    want = flatten(_np(jc))
    assert flatten(tc).keys() == want.keys()
    for k, w in want.items():
        _close_scaled(flatten(tc)[k], w, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_its_gradients_match_jax(arch):
    """The loss and every leaf's gradient (the tail's included), the
    reference under ``remat``, the port with it and without."""
    cfg, tcfg, params, tparams = _setup(arch)
    rng = np.random.default_rng(9)
    tok = rng.integers(0, cfg.vocab, (B, 64)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, 64)).astype(np.int32)
    lab[0, :5] = -1
    want_loss, want = jax.jit(jax.value_and_grad(functools.partial(
        jtr.loss_fn, cfg=cfg, remat=True)))(params, tok, lab)
    want = flatten(_np(want))
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in flatten(tparams).items()}
        loss = transformer.loss_fn(unflatten(leaves), _t(tok).long(),
                                   _t(lab).long(), tcfg, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _close(loss, want_loss, 1e-5, 0.0, f"loss remat={remat}")
        assert want.keys() == leaves.keys()
        for k, g in zip(leaves, grads):
            assert np.abs(want[k]).max() > 0, k
            _close(g, want[k], 1e-4, 1e-3 * float(np.abs(want[k]).max()),
                   f"{k} remat={remat}")


def test_hfl_step_aggregates_the_tail_whole_and_matches_jax(monkeypatch):
    """recurrentgemma-smoke, one edge of two clients, one step from the
    cold boot: the HieAvg walk takes each ``tail/...`` leaf whole and each
    stacked leaf one unit at a time; both sides handed the same seeded
    gradients (``loss_fn``'s are held above), the parameters and both
    histories within ``rtol 1e-5, atol 1e-6``, and the loss."""
    arch, e, c = "recurrentgemma-9b", 1, 2
    cfg, tcfg, params, _ = _setup(arch)
    jp = jax.tree.map(lambda x: jnp.broadcast_to(x, (e, c) + x.shape),
                      params)
    jd, jg = j_init_hist(jp)
    tp = transformer.params_from_numpy(_np(jp))
    td, tg = init_fl_histories(tp)
    pieces = tsteps._pieces(flatten(tp), 2)
    tail = [k for k, _ in pieces if k.startswith("tail/")]
    assert sorted(tail) == sorted(k for k in flatten(tp)
                                  if k.startswith("tail/"))
    assert sum(k.startswith("unit/") for k, _ in pieces) == \
        sum(k.startswith("unit/") for k in flatten(tp)) * cfg.n_units
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab, (e, c, 2, 32)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (e, c, 2, 32)).astype(np.int32)
    loss = rng.random((e, c)).astype(np.float32) + 6.0
    grads = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
             for k, v in flatten(_np(jp)).items()}
    seen = []

    def port_grads(slot, tokens, labels, cfg_, **kw):
        ec = divmod(len(seen), c)
        seen.append(ec)
        assert torch.equal(tokens, _t(tok[ec]).long()), ec
        return (torch.tensor(loss[ec]),
                {k: _t(v[ec]) for k, v in grads.items()})

    monkeypatch.setattr(jsteps, "_per_client_grad", lambda *a, **k: (
        jnp.asarray(loss), unflatten({k: jnp.asarray(v)
                                      for k, v in grads.items()})))
    monkeypatch.setattr(tsteps, "_client_grads", port_grads)
    dm, em, lr = np.array([[True, False]]), np.array([True]), 0.05
    jp, jd, jg, jloss = jax.jit(j_make_hfl(cfg))(
        jp, jd, jg, {"tokens": tok, "labels": lab}, dm, em, jnp.float32(lr))
    tp, td, tg, tloss = make_hfl_train_step(tcfg)(
        tp, td, tg, {"tokens": _t(tok).long(), "labels": _t(lab).long()},
        _t(dm), _t(em), lr)
    assert seen == [(0, 0), (0, 1)]
    _close(tloss, jloss, 1e-5, 0.0, "loss")
    for name, got, want in (
            ("params", flatten(tp), flatten(_np(jp))),
            ("dev.prev_w", td.prev_w, flatten(_np(jd.prev_w))),
            ("dev.delta_mean", td.delta_mean, flatten(_np(jd.delta_mean))),
            ("glob.prev_w", tg.prev_w, flatten(_np(jg.prev_w))),
            ("glob.delta_mean", tg.delta_mean,
             flatten(_np(jg.delta_mean)))):
        assert got.keys() == want.keys()
        assert any(k.startswith("tail/") for k in want)
        for k, w in want.items():
            _close(got[k], w, 1e-5, 1e-6, f"{name} {k}")


def test_hfl_step_in_row_blocks_is_bitwise_the_whole_leaf_step(monkeypatch):
    """With ``PIECE_ELEMS`` cut to 1000 the HieAvg walk takes the
    embedding and the tail's matrices in blocks of rows (as it takes
    recurrentgemma's 256000 x 4096 embedding at full width): the step's
    parameters, histories and loss are bitwise those of the walk over
    whole leaves (the math is elementwise)."""
    _, tcfg, _, tparams = _setup("recurrentgemma-9b")
    rng = np.random.default_rng(6)
    tok = _t(rng.integers(0, tcfg.vocab, (1, 2, 2, 16))).long()
    batch = {"tokens": tok, "labels": tok.roll(-1, -1)}
    out = []
    for elems in (tsteps.PIECE_ELEMS, 1000):
        monkeypatch.setattr(tsteps, "PIECE_ELEMS", elems)
        pieces = tsteps._pieces(flatten(tparams), 0)
        assert (sum(k == "embed/tok" for k, _ in pieces) > 1) \
            == (elems == 1000)
        tp = unflatten({k: v[None, None].expand(
            (1, 2) + tuple(v.shape)).contiguous()
            for k, v in flatten(tparams).items()})
        td, tg = init_fl_histories(tp)
        out.append(make_hfl_train_step(tcfg)(
            tp, td, tg, batch, torch.tensor([[True, False]]),
            torch.tensor([True]), 0.05))
    (p0, d0, g0, l0), (p1, d1, g1, l1) = out
    assert torch.equal(l0, l1)
    for a, b in ((flatten(p0), flatten(p1)), (d0.prev_w, d1.prev_w),
                 (d0.delta_mean, d1.delta_mean), (g0.prev_w, g1.prev_w),
                 (g0.delta_mean, g1.delta_mean)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_run_on_the_cpu(arch):
    """``serve.run`` at smoke width: greedy tokens, finite logits, the
    prefill's logits those of the port's ``forward_train`` at the last
    position; ``train.run``: finite losses, a valid chain, one block a
    global round."""
    res = serve.run(arch, device="cpu", batch=2, prompt_len=24, gen=4,
                    progress=False)
    assert res["tokens"].shape == (2, 4)
    assert np.isfinite(res["logits"]).all()
    cfg = get_smoke(arch)
    params = serve.make_params(cfg, 0, torch.device("cpu"))
    from repro_torch.data import lm_tokens
    prompts = torch.as_tensor(lm_tokens(2, 24, cfg.vocab, seed=0)).long()
    want = transformer.forward_train(params, prompts, cfg)[0][:, -1]
    _close_scaled(res["logits"][:, 0], want.detach().numpy())
    out = train.run(arch, device="cpu", steps=2, k_edge=1, batch=2, seq=32,
                    progress=False)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["blocks"] == 2 and out["chain_valid"]


# ---------------------------------------------- the flash kernel at 256
def test_plain_flash_at_head_dim_256_matches_jax():
    """The port's flash front end (plain version) at recurrentgemma's full
    head dim 256, its group of 16 query heads over one kv head and a
    window, over 40 rows (a window of 16), against the reference's
    ``_sdpa``."""
    rng = np.random.default_rng(256)
    q = rng.standard_normal((1, 40, 16, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 1, 256)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(functools.partial(jatt._sdpa, causal=True, window=16))(
        *map(jnp.asarray, (q, k, v)))
    got = ops.flash_attention(*map(_t, (q, k, v)), causal=True, window=16)
    _close(got, want, atol=2e-5)


def test_kernels_are_built_at_256_and_the_float32_backward_refuses_it(
        monkeypatch):
    """Head dim 256 is built for both kernels; the float32 backward is not
    (its FP32 tiles do not fit in a block's shared memory): with the kernel
    route forced on, it raises before any launch or device check."""
    assert 256 in tflash.HEAD_DIMS and 256 not in tflash.F32_BWD_HEAD_DIMS
    q = torch.zeros((1, 8, 4, 256))
    k = torch.zeros((1, 8, 1, 256))
    lse = torch.zeros((1, 4, 8))
    monkeypatch.setattr(build, "use_kernel", lambda mode, t: True)
    with pytest.raises(ValueError, match="float32 kernels are built for"):
        tflash.flash_attention_bwd(q, k, k, q, lse, q)
    with pytest.raises(ValueError, match="operand on cpu"):
        tflash.flash_attention_bwd(*(t.bfloat16() for t in (q, k, k, q)),
                                   lse, q.bfloat16())
