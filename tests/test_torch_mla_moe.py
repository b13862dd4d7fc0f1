"""Multi-head latent attention and mixture-of-experts layers of the port
against the JAX package, on the CPU: minicpm3-4b (``mla``),
deepseek-v2-lite-16b (``mla_moe``) and grok-1-314b (``attn_moe``), at the
reference's smoke widths (MLA head dim 16 + 8 = 24, v 16; 4 experts, top
2; float32).

The reference's weights are carried over leaf for leaf
(``transformer.params_from_numpy``); activations, tokens and router
probabilities are made with numpy from a seed.  The JAX side attends
through its XLA path (its chunked branch past 512 query rows); the port
runs its plain versions.  The smoke configs' ``capacity_factor`` 16 is
drop-free; the capacity cases also run at a factor that drops over 10% of
the (token, k) assignments.

Bounds, those of ``tests/test_torch_serve.py`` and
``tests/test_torch_train.py``: one layer's output ``atol 3e-4``; logits,
caches and decode logits ``3e-4`` times their largest magnitude (at least
1); the aux loss ``rtol 1e-5``; ``loss_fn`` ``rtol 1e-5`` and its
gradients ``rtol 1e-4`` with ``atol`` 1e-3 times the leaf's largest
gradient; one HieAvg step (each side's own gradients) ``rtol 1e-5``
and ``atol`` 1e-6 plus 5e-3 times the leaf's largest change; the routing (expert index, buffer position, keep)
bitwise.  The plain flash version at head dims 96 and 192 (MLA's at full
width) against the reference's ``_sdpa`` ``atol 2e-5``, the reference's
flash bound (``tests/test_kernels.py``).
"""
import ctypes
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jatt
import repro.models.mla as jmla
import repro.models.moe as jmoe
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
from repro_torch.kernels import ops
from repro_torch.launch import (init_fl_histories, make_hfl_train_step,
                                make_prefill_step, make_serve_step)
from repro_torch.launch.steps import flatten, unflatten
from repro_torch.models import ParamSpec, count_params, mla, moe, \
    transformer
from repro_torch.models.layers import rms_norm
from repro_torch.models.spec import init_from_specs

#: the flash kernels' module (``repro_torch.kernels.flash_attention`` is
#: the re-exported function)
tflash = importlib.import_module("repro_torch.kernels.flash_attention")
ATOL = 3e-4
ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b", "grok-1-314b")
MLA_ARCHS = ARCHS[:2]
MOE_ARCHS = ARCHS[1:]
B, PROMPT, STEPS = 2, 600, 6


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


@functools.lru_cache(maxsize=None)
def _ref_base(arch: str) -> dict:
    """The reference's smoke weights from seed 0 (numpy; read only)."""
    return _np(jax.jit(functools.partial(
        j_init, j_param_specs(j_get_smoke(arch))))(jax.random.key(0)))


def _setup(arch):
    """(cfg, the port's cfg, JAX params, the port's params)."""
    base = _ref_base(arch)
    return (j_get_smoke(arch), get_smoke(arch),
            jax.tree.map(jnp.asarray, base),
            transformer.params_from_numpy(base))


def _shapes(tree, leaf_type):
    return {k: tuple(v.shape) for k, v in flatten(tree).items()
            if isinstance(v, leaf_type)}


def _layer(params, tparams, part="mixer"):
    """Unit 0's ``part`` leaves: the reference's and the port's."""
    return (jax.tree.map(lambda a: a[0], params["unit"]["0"][part]),
            transformer._index(tparams["unit"]["0"][part], 0))


def _x(cfg, s, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------ configs and specs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_specs_and_caches_match_jax(arch):
    """FULL and smoke configs field for field, ``param_specs`` and
    ``cache_specs`` names and shapes at both widths (nothing allocated):
    MLA keeps the compressed ``c_kv``/``k_rope`` and no ``k``; grok's GQA
    a KV cache."""
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
    leaves = set(transformer.cache_specs(tcfg, 1, 64)["unit"]["0"])
    assert leaves == ({"c_kv", "k_rope"} if tcfg.mla else {"k", "v"})


@pytest.mark.parametrize("arch,billions", [
    ("minicpm3-4b", 4.07), ("deepseek-v2-lite-16b", 16.21),
    ("grok-1-314b", 316.49)])
def test_full_param_counts_match_jax(arch, billions):
    cfg = tconfigs.get_config(arch)
    n = count_params(transformer.param_specs(cfg))
    assert n == j_count_params(j_param_specs(j_get_config(arch)))
    assert round(n / 1e9, 2) == billions


def test_recurrent_archs_still_raise():
    """The recurrent archs resolve now; what still raises is a depth their
    pattern cannot reach: ``cut_depth`` keeps whole units and the tail
    (recurrentgemma: 3u + 2 layers) and refuses any other count by name,
    where ``ArchConfig.n_units`` would die in a bare assert."""
    for arch in ("recurrentgemma-9b", "mamba2-130m"):
        assert tconfigs.get_config(arch).name == j_get_config(arch).name
        assert tconfigs.get_smoke(arch).name == j_get_smoke(arch).name
    rg = tconfigs.get_config("recurrentgemma-9b")
    assert tconfigs.cut_depth(rg, 5).n_units == 1
    for n in (1, 2, 4, 6, 37):
        with pytest.raises(ValueError, match=r"3u \+ 2 layers.*5, 8, 11"):
            tconfigs.cut_depth(rg, n)
    assert tconfigs.cut_depth(tconfigs.get_config("mamba2-130m"),
                              3).n_units == 3


# ------------------------------------------------------------- the MLA
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_train_matches_jax(arch):
    """One MLA layer over a seeded x of 40 tokens: with (minicpm3) and
    without (deepseek) the low-rank q projection."""
    cfg, tcfg, params, tparams = _setup(arch)
    jp, tp = _layer(params, tparams)
    assert ("w_dq" in tp) == bool(cfg.mla.q_lora_rank)
    x = _x(cfg, 40)
    _close(mla.mla_train(tp, _t(x), tcfg),
           jmla.mla_train(jp, jnp.asarray(x), cfg))


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_prefill_and_decode_layer_match_jax(arch):
    """One MLA layer: a 40-token prefill into a cache of 43, then two
    absorbed decode steps; the outputs, and the cache after each (the
    slots past the written ones still 0).  (The 600-token prefill, the
    reference's chunked ``_sdpa`` branch, is ``test_prefill_matches_jax``.)
    """
    cfg, tcfg, params, tparams = _setup(arch)
    jp, tp = _layer(params, tparams)
    prompt = 40
    x = _x(cfg, prompt + 2, seed=5)
    jc = j_init(jmla.mla_cache_spec(cfg, B, prompt + 3, None,
                                    dtype=jnp.float32), jax.random.key(1))
    tc = init_from_specs(mla.mla_cache_spec(tcfg, B, prompt + 3, None,
                                            dtype=torch.float32), None)
    want, jc = jmla.mla_prefill(jp, jnp.asarray(x[:, :prompt]), cfg, jc)
    got, tc = mla.mla_prefill(tp, _t(x[:, :prompt]), tcfg, tc)
    _close(got, want)
    for i in range(2):
        pos = prompt + i
        want, jc = jmla.mla_decode(jp, jnp.asarray(x[:, pos:pos + 1]), cfg,
                                   jc, jnp.asarray(pos, jnp.int32))
        got, tc = mla.mla_decode(tp, _t(x[:, pos:pos + 1]), tcfg, tc, pos)
        _close(got, want, msg=f"decode {i}")
        for k in ("c_kv", "k_rope"):
            _close_scaled(tc[k], jc[k], f"{k} after decode {i}")
    assert not tc["c_kv"][:, prompt + 2:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """The whole model over a 600-token prompt: last-position logits and
    every cache leaf."""
    cfg, tcfg, params, tparams = _setup(arch)
    prompts = np.asarray(jax.random.randint(jax.random.key(2), (B, PROMPT),
                                            0, cfg.vocab))
    jc = j_init(j_cache_specs(cfg, B, PROMPT + 1, dtype=jnp.float32),
                jax.random.key(1))
    tc = init_from_specs(transformer.cache_specs(tcfg, B, PROMPT + 1,
                                                 dtype=torch.float32), None)
    want, want_c = jax.jit(functools.partial(jtr.prefill, cfg=cfg))(
        params, jnp.asarray(prompts), caches=jc)
    got, got_c = make_prefill_step(tcfg, "torch")(tparams,
                                                  _t(prompts).long(), tc)
    _close_scaled(got, want)
    got_c, want_c = flatten(got_c), flatten(_np(want_c))
    assert got_c.keys() == want_c.keys()
    for k in want_c:
        _close_scaled(got_c[k], want_c[k], k)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax_and_the_forward(arch):
    """Prefill, then ``decode_step`` fed the reference's greedy tokens:
    logits at every step and the caches at the end against the
    reference's, and every step's logits against the port's own
    ``forward_train`` of the whole sequence."""
    cfg, tcfg, params, tparams = _setup(arch)
    prompt = 40
    prompts = np.asarray(jax.random.randint(jax.random.key(4), (B, prompt),
                                            0, cfg.vocab))
    jc = j_init(j_cache_specs(cfg, B, prompt + STEPS, dtype=jnp.float32),
                jax.random.key(1))
    tc = init_from_specs(transformer.cache_specs(tcfg, B, prompt + STEPS,
                                                 dtype=torch.float32), None)
    logits, jc = jax.jit(functools.partial(jtr.prefill, cfg=cfg))(
        params, jnp.asarray(prompts), caches=jc)
    first, tc = make_prefill_step(tcfg)(tparams, _t(prompts).long(), tc)
    _close_scaled(first, logits)
    jdec = jax.jit(functools.partial(jtr.decode_step, cfg=cfg))
    tdec = make_serve_step(tcfg)
    toks, seen = [np.asarray(jnp.argmax(logits, -1)).astype(np.int32)], \
        [first]
    for i in range(STEPS - 1):
        pos = prompt + i
        want, jc = jdec(params, jnp.asarray(toks[-1])[:, None],
                        jnp.asarray(pos, jnp.int32), caches=jc)
        got, tc = tdec(tparams, _t(toks[-1]).long()[:, None], pos, tc)
        _close_scaled(got, want, f"step {i}")
        seen.append(got)
        toks.append(np.asarray(jnp.argmax(want, -1)).astype(np.int32))
    for k, w in flatten(_np(jc)).items():
        _close_scaled(flatten(tc)[k], w, k)
    full = np.concatenate([prompts, np.stack(toks[:-1], 1)], 1)
    fwd, _ = transformer.forward_train(tparams, _t(full).long(), tcfg)
    _close_scaled(torch.stack(seen, 1), fwd[:, prompt - 1:].numpy())


# ------------------------------------------------------------- the MoE
def _probs_cases():
    """Router probabilities [b, ns, blk, E] for ``route``: seeded
    softmaxes, and a crafted block with ties and exact zeros (a one-hot
    row, a row of equal values, rows with two equal maxima, zeros)."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 3, 16, 4)).astype(np.float32) * 3
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    crafted = np.array([[1, 0, 0, 0], [0, 0, 0, 1], [.25, .25, .25, .25],
                        [.5, .5, 0, 0], [0, .5, 0, .5], [0, 0, 1, 0],
                        [.4, .2, .2, .2], [0, 0, .5, .5], [1, 0, 0, 0],
                        [0, 1, 0, 0], [.5, 0, .5, 0], [0, 0, 0, 1]],
                       np.float32)[None, None]
    return {"softmax": soft, "ties": crafted}


def _route_oracle(probs, top_k, cap):
    """``jax.lax.top_k`` and a numpy cumsum over the flattened (token, k)
    order of each block."""
    vals, idx = jax.lax.top_k(jnp.asarray(probs), top_k)
    idx = np.asarray(idx)
    pos = np.zeros_like(idx)
    for blk in np.ndindex(idx.shape[:-2]):
        count = np.zeros(probs.shape[-1], int)
        for t in range(idx.shape[-2]):
            for j in range(top_k):
                e = idx[blk + (t, j)]
                pos[blk + (t, j)] = count[e]
                count[e] += 1
    vals = np.asarray(vals)
    return vals / vals.sum(-1, keepdims=True), idx, pos, pos < cap


@pytest.mark.parametrize("case", ["softmax", "ties"])
@pytest.mark.parametrize("top_k,cap", [(2, 3), (2, 16), (3, 2)])
def test_route_matches_top_k_and_a_cumsum_oracle_bitwise(case, top_k, cap):
    """Expert index, buffer position and keep bitwise, ties in JAX's order
    (the lower expert index first), the gates renormalised."""
    probs = _probs_cases()[case]
    gates, idx, pos, keep = _route_oracle(probs, top_k, cap)
    tg, tidx, tpos, tkeep, oh = moe.route(_t(probs), top_k, cap)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(oh.argmax(-1).numpy(), idx)
    _close(tg, gates, 1e-6, 0.0)
    if case == "ties" and top_k == 2:
        assert tidx[0, 0, 0].tolist() == [0, 1]    # a zero picked second
        assert tidx[0, 0, 2].tolist() == [0, 1]    # four equal values
        assert tidx[0, 0, 4].tolist() == [1, 3]
        assert not keep.all() if cap == 3 else keep.all()


def _moe_cfg(arch, cf):
    cfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    if cf is not None:
        cfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in (cfg, tcfg))
    return cfg, tcfg


@pytest.mark.parametrize("cf", [None, 0.75])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, cf):
    """One MoE layer over 64 tokens: the smoke capacity factor 16
    (drop-free) and 0.75 (over 10% of the assignments dropped, counted
    from ``route``); output and aux loss."""
    _, _, params, tparams = _setup(arch)
    cfg, tcfg = _moe_cfg(arch, cf)
    jp, tp = _layer(params, tparams, "ffn")
    x = _x(cfg, 64, seed=8)
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    got, aux = moe.moe_apply(tp, _t(x), tcfg)
    _close(got, want)
    _close(aux, want_aux, 1e-5, 0.0, "aux")
    h = rms_norm(_t(x), tp["norm"], cfg.norm_eps)
    probs = torch.softmax(h @ tp["router"], -1)[:, None]
    keep = moe.route(probs, cfg.moe.top_k, moe._capacity(64, cfg.moe))[3]
    dropped = 1.0 - keep.float().mean().item()
    assert (dropped > 0.1) if cf else dropped == 0.0


def test_moe_block_size_invariance():
    """As the reference's ``test_moe_block_size_invariance``: blocks of 8,
    16, or the whole sequence (999 does not divide it) give the same
    grok-smoke logits (drop-free)."""
    _, tcfg, _, tparams = _setup("grok-1-314b")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 32))).long()
    old, out = moe.MOE_BLOCK, []
    try:
        for blk in (8, 16, 999):
            moe.MOE_BLOCK = blk
            out.append(transformer.forward_train(tparams, toks, tcfg)[0])
    finally:
        moe.MOE_BLOCK = old
    _close(out[1], out[0].numpy(), atol=2e-5)
    _close(out[2], out[0].numpy(), atol=2e-5)


# --------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    """Logits and the aux loss (0 without MoE layers)."""
    cfg, tcfg, params, tparams = _setup(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, 48))
    want, want_aux = jtr.forward_train(params, jnp.asarray(toks), cfg)
    got, aux = transformer.forward_train(tparams, _t(toks).long(), tcfg)
    _close_scaled(got, want)
    _close(aux, want_aux, 1e-5, 0.0, "aux")
    assert (float(aux) > 0.0) == (arch in MOE_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_its_gradients_match_jax(arch):
    """The loss (the aux loss in it) and every leaf's gradient, the
    routers' included, the reference under ``remat``, the port with it
    and without."""
    cfg, tcfg, params, tparams = _setup(arch)
    rng = np.random.default_rng(9)
    tok = rng.integers(0, cfg.vocab, (B, 64)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, 64)).astype(np.int32)
    lab[0, :5] = -1
    want_loss, want = jax.jit(jax.value_and_grad(functools.partial(
        jtr.loss_fn, cfg=cfg, remat=True)))(params, tok, lab)
    want = flatten(_np(want))
    for k in want:
        if k.endswith("ffn/router"):
            assert np.abs(want[k]).max() > 0, k
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in flatten(tparams).items()}
        loss = transformer.loss_fn(unflatten(leaves), _t(tok).long(),
                                   _t(lab).long(), tcfg, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _close(loss, want_loss, 1e-5, 0.0, f"loss remat={remat}")
        assert want.keys() == leaves.keys()
        for k, g in zip(leaves, grads):
            _close(g, want[k], 1e-4, 1e-3 * float(np.abs(want[k]).max()),
                   f"{k} remat={remat}")


def _hfl(arch, e=1, c=2):
    cfg, tcfg, params, _ = _setup(arch)
    jp = jax.tree.map(lambda x: jnp.broadcast_to(x, (e, c) + x.shape),
                      params)
    jd, jg = j_init_hist(jp)
    tp = transformer.params_from_numpy(_np(jp))
    td, tg = init_fl_histories(tp)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab, (e, c, 2, 32)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (e, c, 2, 32)).astype(np.int32)
    return cfg, tcfg, (jp, jd, jg), (tp, td, tg), tok, lab


def _hfl_compare(out_j, out_t, tol):
    (jp, jd, jg), (tp, td, tg) = out_j, out_t
    for name, got, want in (
            ("params", flatten(tp), flatten(_np(jp))),
            ("dev.prev_w", td.prev_w, flatten(_np(jd.prev_w))),
            ("dev.delta_mean", td.delta_mean, flatten(_np(jd.delta_mean))),
            ("glob.prev_w", tg.prev_w, flatten(_np(jg.prev_w))),
            ("glob.delta_mean", tg.delta_mean,
             flatten(_np(jg.delta_mean)))):
        assert got.keys() == want.keys()
        for k, w in want.items():
            _close(got[k], w, 1e-5, tol(name, k), f"{name} {k}")


def test_hfl_step_over_mla_and_moe_leaves_matches_jax():
    """deepseek-smoke (MLA and MoE leaves, the expert axis after the unit
    axis), one edge of two clients, one step from the cold boot: each
    client's ``loss_fn`` gradient (the aux loss in it), the in-place SGD
    and the per-unit HieAvg, against the reference's step: the loss, the
    parameters and both histories within 5e-3 of each leaf's largest
    change."""
    cfg, tcfg, jstate, tstate, tok, lab = _hfl("deepseek-v2-lite-16b")
    assert tstate[0]["unit"]["0"]["ffn"]["gate"].shape[:4] == (
        1, 2, cfg.n_units, cfg.moe.n_experts)
    base = {k: v.clone() for k, v in flatten(tstate[0]).items()}
    dm, em, lr = np.array([[True, False]]), np.array([True]), 0.05
    *jout, jloss = jax.jit(j_make_hfl(cfg))(
        *jstate, {"tokens": tok, "labels": lab}, dm, em, jnp.float32(lr))
    *tout, tloss = make_hfl_train_step(tcfg)(
        *tstate, {"tokens": _t(tok).long(), "labels": _t(lab).long()},
        _t(dm), _t(em), lr)
    _close(tloss, jloss, 1e-5, 0.0, "loss")
    change = {k: float(np.abs(np.asarray(v) - base[k].numpy()).max())
              for k, v in flatten(_np(jout[0])).items()}
    _hfl_compare(jout, tout, lambda name, k: 1e-6 + 5e-3 * change.get(
        k, change.get(k.split("/", 1)[-1], 0.0)))


# ---------------------------------------------- the flash kernel's dims
@pytest.mark.parametrize("dh", [96, 192])
def test_plain_flash_at_mla_head_dims_matches_jax(dh):
    """The port's flash front end (plain version) at MLA's full-width
    head dims, v zero-padded as ``mla_train`` pads it, against the
    reference's ``_sdpa`` (its chunked branch past 512 rows): the output
    within 2e-5 and its padded columns exactly 0."""
    rng = np.random.default_rng(dh)
    q, k, v = (rng.standard_normal((1, 520, 4, dh)).astype(np.float32)
               for _ in range(3))
    v[..., dh * 2 // 3:] = 0.0
    want = jatt._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    _close(got, want, atol=2e-5)
    assert not got[..., dh * 2 // 3:].any()


class _ReadingLibrary:
    """Stands in for the built library: records each launcher call, and
    copies what its first operands point at while the call lasts (the
    operands are temporaries; on the CPU a pointer is host memory)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launcher(*args):
            self.calls.append((name, args, self.read(name, args)))
            return 0
        return launcher

    @staticmethod
    def read(name, args):
        """q, k, v (and do) of a flash launcher, as float32 arrays of the
        launcher's shapes ([B, S, H, Dh] contiguous)."""
        if name == "flash_attention_launch":
            (B, H, Hkv, Sq, Skv, D), ptrs = args[5:11], args[:3]
        elif name == "flash_attention_bwd_delta_launch":
            return None
        else:
            at = 8 if "dkdv" in name else 7
            (B, H, Hkv, Sq, Skv, D), ptrs = args[at:at + 6], args[:4]
        bf16 = args[-2] == 1
        out = []
        for ptr, (s, h) in zip(ptrs, ((Sq, H), (Skv, Hkv), (Skv, Hkv),
                                      (Sq, H))):
            n = B * s * h * D
            buf = ((ctypes.c_uint16 if bf16 else ctypes.c_float) * n
                   ).from_address(ptr)
            raw = np.frombuffer(buf, np.uint16 if bf16 else np.float32)
            if bf16:                      # bfloat16 bits -> float32
                raw = (raw.astype(np.uint32) << 16).view(np.float32)
            out.append(raw.copy().reshape(B, s, h, D))
        return out


def test_kernel_refuses_the_smoke_mla_head_dim(monkeypatch):
    """Smoke-width MLA attends at head dim 16 + 8 = 24, which no kernel is
    built for: no longer refused, it is padded.  The host path (``build.use_kernel`` forced on, a stub in
    place of the library, the device check passed over: no card here)
    takes it: the forward and the backward hand their launchers the built
    head dim 32, operands zero-padded to it and the scale ``1/sqrt(24)``
    of the true head dim, and give back outputs of head dim 24.  A built
    head dim (96) goes as it is, unpadded; a head dim above 256 is refused
    before any launch.  In float32 and in bfloat16."""
    for dtype in (torch.float32, torch.bfloat16):
        _padded_launches(monkeypatch, dtype)


def _padded_launches(monkeypatch, dtype):
    lib = _ReadingLibrary()
    monkeypatch.setattr(tflash.build, "use_kernel", lambda mode, t: True)
    monkeypatch.setattr(tflash.build, "library", lambda: lib)
    monkeypatch.setattr(tflash.build, "stream", lambda: 0)
    checked = []
    monkeypatch.setattr(tflash, "_check_kernel_args",
                        lambda name, window, *ts: checked.append(
                            [t.shape[-1] for t in ts]))
    rng = np.random.default_rng(24)

    def operands(dh, n=4):
        return [torch.from_numpy(rng.standard_normal(
            (1, 8, 4, dh)).astype(np.float32)).to(dtype) for _ in range(n)]

    q, k, v, do = operands(24)
    o, lse = tflash.flash_attention_fwd(q, k, v, lse=True)
    assert o.shape == q.shape and lse.shape == (1, 4, 8)
    grads = tflash.flash_attention_bwd(q, k, v, o, lse, do)
    assert [g.shape for g in grads] == [q.shape] * 3
    assert [c[0] for c in lib.calls] == [
        "flash_attention_launch", "flash_attention_bwd_delta_launch",
        "flash_attention_bwd_dkdv_launch", "flash_attention_bwd_dq_launch"]
    assert checked == [[32] * 3, [32] * 5]
    scale = 1.0 / np.sqrt(24.0)
    fwd, delta, dkdv, dq = lib.calls
    assert fwd[1][10] == 32 and fwd[1][-3] == scale
    assert delta[1][6] == 32                      # o and do, padded alike
    assert dkdv[1][13] == dq[1][12] == 32
    assert dkdv[1][-3] == dq[1][-3] == scale
    for call, given in ((fwd, (q, k, v)), (dkdv, (q, k, v, do)),
                        (dq, (q, k, v, do))):
        for seen, x in zip(call[2], given):
            np.testing.assert_array_equal(seen[..., :24], x.float().numpy())
            assert not seen[..., 24:].any()
    # a built head dim goes unpadded: the launcher reads the tensors' own
    lib.calls.clear()
    q, k, v = operands(96, 3)
    tflash.flash_attention_fwd(q, k, v)
    args = lib.calls[0][1]
    assert args[:3] == tuple(x.data_ptr() for x in (q, k, v))
    assert args[10] == 96 and args[-3] == 1.0 / np.sqrt(96.0)
    lib.calls.clear()
    q = operands(264, 1)[0]
    with pytest.raises(ValueError, match="head dim 264"):
        tflash.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="head dim 264"):
        tflash.flash_attention_bwd(q, q, q, q, torch.zeros((1, 4, 8)), q)
    assert not lib.calls
    assert {96, 192} <= set(tflash.HEAD_DIMS) and 24 not in tflash.HEAD_DIMS
