"""Cross-attention and the encoder stack of the port against the JAX
package, on the CPU: llama-3.2-vision-11b (every fifth layer a gated
cross-attention layer over patch embeddings) and seamless-m4t-large-v2 (a
non-causal encoder stack over frame embeddings, decoder layers alternating
self- and cross-attention), both at smoke width.

The reference's weights are carried over leaf for leaf
(``transformer.params_from_numpy``).  The reference initialises every
``xattn_gate`` to zero and its drivers feed zero memory, which leaves the
path inert (the output is multiplied by ``tanh(gate)``, and ``encode(0)``
is 0): so every case but one sets the gates to 0.5 on both sides and
feeds seeded N(0, 1) memory made with numpy.  The JAX side attends
through its XLA path, and in one prefill case through its Pallas flash
kernel in interpret mode; the port runs its plain versions.

Bounds, those of ``tests/test_torch_serve.py`` and
``tests/test_torch_train.py``: one layer's output ``atol 3e-4``; logits,
encoder output, caches and decode logits ``3e-4`` times their largest
magnitude (3.98 and 4.53 for the forward's logits).  The whole models'
logits take the scaled form of the bound, not the dense smokes' ``atol
3e-4``: at five layers (llama-vision) and with the encoder's output under
sharp cross-attention (seamless) the reference's own logits move by
8.6e-4 and 1.5e-3 when its weights are perturbed by one float32 ulp, and
the port lies 4.9e-4 and 9.4e-4 from them (4.5e-4 at llama-vision's zero
gate: its depth, not the cross-attention).  The loss ``rtol 1e-5``, its
gradients ``rtol 1e-4`` and ``atol`` 1e-3 times the leaf's largest
gradient (the encoder's leaves and the gates included); the HieAvg step
(both sides handed the same seeded gradients) ``rtol 1e-5``.

llama-vision's five layers of random weights amplify float32 rounding
five- to tenfold a layer under their sharp attention: over a 600-token
prompt its layer-0 keys lie 2.2e-5 of their largest from the reference's
(RoPE's cos and sin of positions up to 600; the reference's own jit and
eager runs differ there by 6.8e-4), its fourth layer's 5.3e-3, and its
gradients up to 4.2e-2 of a leaf's largest at 64 tokens, where the
reference's own float32 gradients lie 7.9e-2 from a float64 run of it.  So
the 600-token prefill and the gradients of llama-vision run on its smoke
config cut to one unit of one self-attention and one cross-attention
layer (``CUT``); the five-layer model is held in ``forward_train`` and
the teacher-forced decode (48 and 40 tokens).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jatt
import repro.models.transformer as jtr
from repro.configs import get_smoke as j_get_smoke
from repro.launch.steps import init_fl_histories as j_init_hist
from repro.launch.steps import make_hfl_train_step as j_make_hfl
from repro.models import cache_specs as j_cache_specs
from repro.models import init_from_specs as j_init
from repro.models import param_specs as j_param_specs
from repro.models.spec import ParamSpec as JParamSpec
from repro_torch.configs import get_smoke
from repro_torch.data import lm_tokens
from repro_torch.launch import (encode, init_fl_histories,
                                make_hfl_train_step, make_prefill_step,
                                make_serve_step)
from repro_torch.launch import steps as tsteps
from repro_torch.launch.inputs import memory_shape
from repro_torch.launch.steps import flatten, unflatten
from repro_torch.models import ParamSpec, attention as att, transformer
from repro_torch.models.spec import init_from_specs

ATOL = 3e-4
ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
#: the cross-attention position of each smoke unit
XATTN = {"llama-3.2-vision-11b": "4", "seamless-m4t-large-v2": "1"}
B, PROMPT, STEPS, GATE = 2, 600, 6, 0.5


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


def _cfgs(arch: str, cut: bool = False):
    """(the reference's smoke config, the port's), cut by ``CUT``."""
    cfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    if cut and arch in CUT:
        cfg, tcfg = (dataclasses.replace(c, **CUT[arch]) for c in (cfg, tcfg))
    return cfg, tcfg


@functools.lru_cache(maxsize=None)
def _ref_base(arch: str, cut: bool = False) -> dict:
    """The reference's smoke weights from seed 0 (numpy; read only)."""
    return _np(jax.jit(functools.partial(
        j_init, j_param_specs(_cfgs(arch, cut)[0])))(jax.random.key(0)))


#: llama-vision's smoke config cut to one self- and one cross-attention
#: layer, for the 600-token prefill and the gradients (module docstring)
CUT = {"llama-3.2-vision-11b": dict(n_layers=2,
                                    block_pattern=("attn", "xattn"))}


def _gated(tree: dict, gate) -> dict:
    """A copy of a numpy tree with every ``xattn_gate`` leaf set to
    ``gate`` (None: as it is)."""
    return {k: _gated(v, gate) if isinstance(v, dict)
            else (np.full_like(v, gate) if k == "xattn_gate"
                  and gate is not None else v)
            for k, v in tree.items()}


def _setup(arch, gate=GATE, cut=False):
    """(cfg, the port's cfg, JAX params, the port's params)."""
    base = _gated(_ref_base(arch, cut), gate)
    return (*_cfgs(arch, cut), jax.tree.map(jnp.asarray, base),
            transformer.params_from_numpy(base))


def _memory(cfg, seed=7, batch=B, zero=False):
    """Seeded N(0, 1) raw memory [batch, *memory shape] (float32)."""
    shape = (batch,) + memory_shape(cfg)
    if zero:
        return np.zeros(shape, np.float32)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _shapes(tree, leaf_type):
    return {k: tuple(v.shape) for k, v in flatten(tree).items()
            if isinstance(v, leaf_type)}


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_and_keep_no_cross_attention_cache(arch):
    cfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    specs = transformer.param_specs(tcfg)
    assert _shapes(specs, ParamSpec) == _shapes(j_param_specs(cfg),
                                                JParamSpec)
    gate = specs["unit"][XATTN[arch]]["mixer"]["xattn_gate"]
    assert gate.shape == (tcfg.n_units, 1) and gate.init == "zeros"
    caches = transformer.cache_specs(tcfg, B, 64)
    assert _shapes(caches, ParamSpec) == _shapes(
        j_cache_specs(cfg, B, 64), JParamSpec)
    assert XATTN[arch] not in caches["unit"]
    if tcfg.encoder:
        enc = specs["encoder"]["unit"]["0"]["mixer"]["wq"]
        assert enc.shape[0] == tcfg.encoder.n_layers


# ---------------------------------------------------------- the layers
@pytest.mark.parametrize("arch", ARCHS)
def test_xattn_train_and_decode_match_jax(arch):
    """One cross-attention layer (its mixer) over seeded x and memory, a
    full sequence and a single query row."""
    cfg, tcfg, params, tparams = _setup(arch)
    i = XATTN[arch]
    jp = jax.tree.map(lambda a: a[0], params["unit"][i]["mixer"])
    tp = transformer._index(tparams["unit"][i]["mixer"], 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 40, cfg.d_model)).astype(np.float32)
    mem = _memory(cfg)
    want = jatt.xattn_train(jp, jnp.asarray(x), jnp.asarray(mem), cfg)
    got = att.xattn_train(tp, _t(x), _t(mem), tcfg)
    _close(got, want)
    want = jatt.xattn_decode(jp, jnp.asarray(x[:, :1]), jnp.asarray(mem),
                             cfg)
    got = att.xattn_decode(tp, _t(x[:, :1]), _t(mem), tcfg)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_matches_jax(arch):
    """seamless: the encoder stack, every one of its ``encoder.n_layers``
    layers; llama-vision: the patch embeddings as they are."""
    cfg, tcfg, params, tparams = _setup(arch)
    mem = _memory(cfg)
    want = np.asarray(jtr.encode(params, jnp.asarray(mem), cfg))
    got = encode(tparams, _t(mem), tcfg)
    _close_scaled(got, want)
    if not tcfg.encoder:
        assert torch.equal(got, _t(mem))


@pytest.mark.parametrize("case", ["gated", "inert"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch, case):
    """Gates 0.5 and random memory; and the reference's own zero gate and
    zero memory, where the layers are identities."""
    inert = case == "inert"
    cfg, tcfg, params, tparams = _setup(arch, None if inert else GATE)
    toks = lm_tokens(B, 48, cfg.vocab, seed=5)
    mem = _memory(cfg, zero=inert)
    want, _ = jtr.forward_train(params, jnp.asarray(toks), cfg,
                                memory_embeds=jnp.asarray(mem))
    got, aux = transformer.forward_train(tparams, _t(toks).long(), tcfg,
                                         memory_embeds=_t(mem))
    _close_scaled(got, want)
    assert float(aux) == 0.0


# ---------------------------------------------------------------- serving
def _caches(cfg, tcfg, max_len):
    jc = j_init(j_cache_specs(cfg, B, max_len, dtype=jnp.float32),
                jax.random.key(1))
    tc = init_from_specs(transformer.cache_specs(tcfg, B, max_len,
                                                 dtype=torch.float32), None)
    return jc, tc


@pytest.mark.parametrize("arch,flash", [
    ("llama-3.2-vision-11b", True), ("llama-3.2-vision-11b", False),
    ("seamless-m4t-large-v2", False)])
def test_prefill_matches_jax(arch, flash):
    """A prompt of 600 tokens: the reference's cross-attention takes its
    chunked non-causal branch (past 512 query rows), or with ``flash`` its
    Pallas kernel (interpret mode).  Last-position logits and caches
    (llama-vision cut by ``CUT``)."""
    cfg, tcfg, params, tparams = _setup(arch, cut=True)
    prompts = lm_tokens(B, PROMPT, cfg.vocab, seed=0)
    mem = _memory(cfg)
    jc, tc = _caches(cfg, tcfg, PROMPT + 1)
    jatt.USE_FLASH_KERNEL = flash
    try:
        want, want_c = jax.jit(functools.partial(jtr.prefill, cfg=cfg))(
            params, jnp.asarray(prompts), caches=jc,
            memory_embeds=jnp.asarray(mem))
    finally:
        jatt.USE_FLASH_KERNEL = False
    got, got_c = make_prefill_step(tcfg, "torch")(
        tparams, _t(prompts).long(), tc, _t(mem))
    _close_scaled(got, want)
    got_c, want_c = flatten(got_c), flatten(_np(want_c))
    assert got_c.keys() == want_c.keys()
    for k in want_c:
        _close_scaled(got_c[k], want_c[k], k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_of_raw_memory_is_prefill_of_the_encoded(arch):
    """``prefill(memory_embeds=m)`` is bitwise ``prefill(memory=encode(m))``,
    caches and logits; both at once raise."""
    _, tcfg, _, tparams = _setup(arch)
    prompts = _t(lm_tokens(B, 40, tcfg.vocab, seed=2)).long()
    mem = _t(_memory(tcfg))
    out = []
    for kw in (dict(memory_embeds=mem),
               dict(memory=encode(tparams, mem, tcfg))):
        tc = _caches(j_get_smoke(arch), tcfg, 41)[1]
        out.append(transformer.prefill(tparams, prompts, tcfg, tc, **kw))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(flatten(out[0][1]).values(),
                    flatten(out[1][1]).values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not both"):
        transformer.prefill(tparams, prompts, tcfg, tc, memory_embeds=mem,
                            memory=mem)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(arch):
    """Prefill, then ``decode_step`` fed the same tokens, the reference fed
    ``encode(memory)`` explicitly (its ``decode_step`` takes the encoded
    memory): logits at every step and the caches at the end."""
    cfg, tcfg, params, tparams = _setup(arch)
    prompt = 40
    prompts = lm_tokens(B, prompt, cfg.vocab, seed=4)
    mem = _memory(cfg)
    jc, tc = _caches(cfg, tcfg, prompt + STEPS)
    jmem = jtr.encode(params, jnp.asarray(mem), cfg)
    logits, jc = jax.jit(functools.partial(jtr.prefill, cfg=cfg))(
        params, jnp.asarray(prompts), caches=jc, memory_embeds=jnp.asarray(
            mem))
    tmem = encode(tparams, _t(mem), tcfg)
    make_prefill_step(tcfg)(tparams, _t(prompts).long(), tc, memory=tmem)
    jdec = jax.jit(functools.partial(jtr.decode_step, cfg=cfg))
    tdec = make_serve_step(tcfg)
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    for i in range(STEPS - 1):
        pos = prompt + i
        want, jc = jdec(params, jnp.asarray(tok)[:, None],
                        jnp.asarray(pos, jnp.int32), caches=jc, memory=jmem)
        got, tc = tdec(tparams, _t(tok).long()[:, None], pos, tc, tmem)
        _close_scaled(got, want, f"step {i}")
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    for k, w in flatten(_np(jc)).items():
        _close_scaled(flatten(tc)[k], w, k)


def test_reference_decode_fed_raw_memory_is_off_its_own_forward():
    """The reference's ``serve.run`` hands its decode steps the raw frame
    embeddings (``launch/serve.py:51-53``), where ``decode_step`` takes the
    encoded memory.  On seamless-smoke with gates 0.5 and random memory its
    decode logits, teacher-forced, lie off a full forward of the same
    tokens by more than 1 (4.70 here) fed the raw memory, and within
    ``3e-4 x max`` fed ``encode(memory)``.  The port's serve wiring
    (``encode`` once, ``prefill(memory=...)``, every decode step the
    encoded memory) agrees with its own forward within ``3e-4 x max``."""
    arch = "seamless-m4t-large-v2"
    cfg, tcfg, params, tparams = _setup(arch)
    prompt, gen = 24, 4
    toks = lm_tokens(B, prompt + gen, cfg.vocab, seed=6)
    mem = _memory(cfg)
    jmem = jnp.asarray(mem)
    full, _ = jax.jit(functools.partial(jtr.forward_train, cfg=cfg))(
        params, jnp.asarray(toks), memory_embeds=jmem)
    want = np.asarray(full)[:, prompt - 1:prompt + gen - 1]
    pre = jax.jit(functools.partial(jtr.prefill, cfg=cfg))
    dec = jax.jit(functools.partial(jtr.decode_step, cfg=cfg))

    def jax_run(dec_mem):
        jc = j_init(j_cache_specs(cfg, B, prompt + gen, dtype=jnp.float32),
                    jax.random.key(1))
        lg, jc = pre(params, jnp.asarray(toks[:, :prompt]), caches=jc,
                     memory_embeds=jmem)
        out = [lg]
        for i in range(gen - 1):
            lg, jc = dec(params, jnp.asarray(toks[:, prompt + i:prompt + i
                                                  + 1]),
                         jnp.asarray(prompt + i, jnp.int32), caches=jc,
                         memory=dec_mem)
            out.append(lg)
        return np.stack([np.asarray(x) for x in out], 1)

    raw = jax_run(jmem)
    print(f"\nraw memory: {np.abs(raw - want).max():.4g} off")
    assert np.abs(raw - want).max() > 1.0
    _close_scaled(jax_run(jtr.encode(params, jmem, cfg)), want)

    tc = init_from_specs(transformer.cache_specs(tcfg, B, prompt + gen,
                                                 dtype=torch.float32), None)
    tmem = encode(tparams, _t(mem), tcfg)
    lg, tc = make_prefill_step(tcfg)(tparams, _t(toks[:, :prompt]).long(),
                                     tc, memory=tmem)
    out, dec = [lg], make_serve_step(tcfg)
    for i in range(gen - 1):
        lg, tc = dec(tparams, _t(toks[:, prompt + i:prompt + i + 1]).long(),
                     prompt + i, tc, tmem)
        out.append(lg)
    got = torch.stack(out, 1)
    tfull, _ = transformer.forward_train(tparams, _t(toks).long(), tcfg,
                                         memory_embeds=_t(mem))
    _close_scaled(got, tfull[:, prompt - 1:prompt + gen - 1].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_run_decodes_from_the_encoded_memory(arch, monkeypatch):
    """``serve.run`` itself, its zero memory swapped for seeded N(0, 1)
    memory at its ``encode`` call and its gates set to 0.5 as its weights
    are made: its prefill and greedy decode logits agree with the port's
    ``forward_train`` of the prompt and the tokens it picked, fed the same
    memory, within ``3e-4 x max``.  A ``serve.run`` that handed ``prefill``
    or the decode steps the raw (zero) memory would lie off it."""
    from repro_torch.launch import serve
    cfg = get_smoke(arch)
    prompt, gen = 24, 6
    mem = _t(_memory(cfg))
    made, make_params, real_encode = {}, serve.make_params, serve.encode

    def gated(cfg_, seed, device):
        made["params"] = p = make_params(cfg_, seed, device)
        for unit in p["unit"].values():
            if "xattn_gate" in unit["mixer"]:
                unit["mixer"]["xattn_gate"].fill_(GATE)
        return p

    def encode_random(params, raw, cfg_, **kw):
        assert raw.shape == mem.shape and not raw.any()
        return real_encode(params, mem.to(raw.dtype), cfg_, **kw)

    monkeypatch.setattr(serve, "make_params", gated)
    monkeypatch.setattr(serve, "encode", encode_random)
    out = serve.run(arch, batch=B, prompt_len=prompt, gen=gen, device="cpu",
                    progress=False)
    toks = torch.cat([_t(lm_tokens(B, prompt, cfg.vocab, seed=0)).long(),
                      _t(out["tokens"][:, :-1]).long()], 1)
    full, _ = transformer.forward_train(made["params"], toks, cfg,
                                        memory_embeds=mem)
    _close_scaled(out["logits"], full[:, prompt - 1:].numpy())


# --------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_its_gradients_match_jax(arch):
    """Every leaf's gradient, the encoder's and ``xattn_gate`` included,
    the reference under ``remat``, the port with it and without
    (llama-vision cut by ``CUT``)."""
    cfg, tcfg, params, tparams = _setup(arch, cut=True)
    rng = np.random.default_rng(9)
    tok = rng.integers(0, cfg.vocab, (B, 64)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, 64)).astype(np.int32)
    lab[0, :5] = -1
    mem = _memory(cfg, seed=11)
    want_loss, want = jax.jit(jax.value_and_grad(functools.partial(
        jtr.loss_fn, cfg=cfg, remat=True)))(params, tok, lab,
                                            memory_embeds=jnp.asarray(mem))
    want = flatten(_np(want))
    gate = f"unit/{cfg.block_pattern.index('xattn')}/mixer/xattn_gate"
    assert np.abs(want[gate]).max() > 0
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in flatten(tparams).items()}
        loss = transformer.loss_fn(unflatten(leaves), _t(tok).long(),
                                   _t(lab).long(), tcfg,
                                   memory_embeds=_t(mem), remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _close(loss, want_loss, 1e-5, 0.0, f"loss remat={remat}")
        assert want.keys() == leaves.keys()
        for k, g in zip(leaves, grads):
            _close(g, want[k], 1e-4, 1e-3 * float(np.abs(want[k]).max()),
                   f"{k} remat={remat}")


def _hfl_inputs(cfg, e, c):
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab, (e, c, 2, 32)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (e, c, 2, 32)).astype(np.int32)
    mem = rng.standard_normal((e, c, 2) + memory_shape(cfg)).astype(
        np.float32)
    return tok, lab, mem


def test_hfl_train_step_with_memory_matches_jax(monkeypatch):
    """seamless-smoke, one edge of two clients, random memory in the batch
    (``batch["memory"]`` [E, C, b, frames, D]), one step from the cold
    boot.  Each client's gradient is taken of its own slice of the memory
    (recorded); both sides are then handed the same seeded gradients (as
    ``tests/test_torch_train.py`` does for bfloat16: ``loss_fn``'s
    gradients are held above), which holds the SGD and HieAvg over the
    encoder's leaves: parameters, both histories and the loss."""
    import repro.launch.steps as jsteps
    arch, e, c = "seamless-m4t-large-v2", 1, 2
    cfg, tcfg, params, _ = _setup(arch)
    jp = jax.tree.map(lambda x: jnp.broadcast_to(x, (e, c) + x.shape),
                      params)
    jd, jg = j_init_hist(jp)
    tp = transformer.params_from_numpy(_np(jp))
    td, tg = init_fl_histories(tp)
    tok, lab, mem = _hfl_inputs(cfg, e, c)
    rng = np.random.default_rng(4)
    loss = rng.random((e, c)).astype(np.float32) + 6.0
    grads = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
             for k, v in flatten(_np(jp)).items()}
    seen = []

    def port_grads(slot, tokens, labels, cfg_, *, memory, **kw):
        ec = divmod(len(seen), c)
        seen.append(ec)
        assert torch.equal(memory, _t(mem[ec])), ec
        assert torch.equal(tokens, _t(tok[ec]).long()), ec
        return (torch.tensor(loss[ec]),
                {k: _t(v[ec]) for k, v in grads.items()})

    monkeypatch.setattr(jsteps, "_per_client_grad", lambda *a, **k: (
        jnp.asarray(loss), unflatten({k: jnp.asarray(v)
                                      for k, v in grads.items()})))
    monkeypatch.setattr(tsteps, "_client_grads", port_grads)
    dm, em, lr = np.array([[True, False]]), np.array([True]), 0.05
    jp, jd, jg, jloss = jax.jit(j_make_hfl(cfg))(
        jp, jd, jg, {"tokens": tok, "labels": lab, "memory": mem}, dm, em,
        jnp.float32(lr))
    tp, td, tg, tloss = make_hfl_train_step(tcfg)(
        tp, td, tg, {"tokens": _t(tok).long(), "labels": _t(lab).long(),
                     "memory": _t(mem)}, _t(dm), _t(em), lr)
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
        for k, w in want.items():
            _close(got[k], w, 1e-5, 1e-6, f"{name} {k}")


def test_hfl_step_splits_encoder_leaves_per_layer_bitwise():
    """The HieAvg step aggregates ``encoder/unit/...`` leaves one layer at
    a time: bitwise the same as whole-leaf aggregation (the math is
    elementwise), on seamless-smoke with random memory."""
    arch, e, c = "seamless-m4t-large-v2", 1, 2
    _, tcfg, _, tparams = _setup(arch)
    tok, lab, mem = _hfl_inputs(tcfg, e, c)
    batch = {"tokens": _t(tok).long(), "labels": _t(lab).long(),
             "memory": _t(mem)}
    pieces = tsteps._pieces(flatten(
        {"encoder": tparams["encoder"]}), 0)
    assert len(pieces) == len(flatten(tparams["encoder"])) \
        * tcfg.encoder.n_layers
    out = []
    for stacked in (tsteps.STACKED, ("unit/",)):
        tp = {k: v[None, None].expand((e, c) + tuple(v.shape)).contiguous()
              for k, v in flatten(tparams).items()}
        tp = unflatten(tp)
        td, tg = init_fl_histories(tp)
        old, tsteps.STACKED = tsteps.STACKED, stacked
        try:
            out.append(make_hfl_train_step(tcfg)(
                tp, td, tg, batch, torch.tensor([[True, False]]),
                torch.tensor([True]), 0.05))
        finally:
            tsteps.STACKED = old
    (p0, d0, g0, l0), (p1, d1, g1, l1) = out
    assert torch.equal(l0, l1)
    for a, b in ((flatten(p0), flatten(p1)), (d0.prev_w, d1.prev_w),
                 (d0.delta_mean, d1.delta_mean), (g0.prev_w, g1.prev_w),
                 (g0.delta_mean, g1.delta_mean)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_train_run_reads_zero_memory_and_cuts_the_encoder_with_the_decoder():
    """``train.run`` on seamless-smoke with ``n_layers=4`` (its own depth
    is 2): every batch holds zero memory of the frontend's shape, and the
    encoder has 4 layers too; the losses are finite."""
    from repro_torch.launch import train as ttrain
    seen = []
    make = ttrain.make_hfl_train_step

    def recording(cfg, **k):
        seen.append(cfg)
        step = make(cfg, **k)

        def wrapped(params, dh, gh, batch, dm, em, lr):
            seen.append((batch["memory"].clone(),
                         params["encoder"]["unit"]["0"]["mixer"]["wq"]
                         .shape))
            return step(params, dh, gh, batch, dm, em, lr)
        return wrapped

    orig, ttrain.make_hfl_train_step = ttrain.make_hfl_train_step, recording
    try:
        out = ttrain.run("seamless-m4t-large-v2", device="cpu", steps=1,
                         k_edge=2, batch=2, seq=16, n_layers=4,
                         progress=False)
    finally:
        ttrain.make_hfl_train_step = orig
    cfg = seen[0]
    assert cfg.n_layers == 4 and cfg.encoder.n_layers == 4
    assert len(seen) == 3 and np.isfinite(out["losses"]).all()
    for memory, wq in seen[1:]:
        assert memory.shape == (1, 2, 2, 16, 128)
        assert not memory.any() and wq[2] == 4


def test_a_cross_attention_layer_without_memory_raises():
    _, tcfg, _, tparams = _setup("llama-3.2-vision-11b")
    with pytest.raises(ValueError, match="needs the memory"):
        transformer.forward_train(tparams, torch.zeros((1, 4), dtype=int),
                                  tcfg)
