"""The port's serving path (``repro_torch.launch.serve`` and the dense LLM
zoo under it) against the JAX package, on the CPU.

For ``h2o-danube-1.8b``, ``deepseek-7b`` and ``qwen3-14b`` at smoke width
the JAX package's weights are carried over leaf for leaf
(``transformer.params_from_numpy``), the prompts come from ``lm_tokens``
(bitwise the reference's), and both packages prefill and decode.  The
JAX prefill runs with its flash kernel on (interpret mode) and off; the
port's with the plain version of its kernel.  Logits: ``atol 3e-4``
(``tests/test_kernels.py``'s end-to-end flash bound).  Caches, and the
decode logits that read them: ``3e-4`` times their largest magnitude
(25 to 34 for the caches, 3 to 5 for the logits).  The second layer's keys
and values carry the first layer's float32 rounding, amplified by the
sharp softmax of random weights: both packages' float32 caches lie 1.3e-3
to 2.3e-3 from a float64 run of the same model, and 1.4e-4 to 3.3e-4 from
each other.  The prompt of 600
tokens is longer than one attention chunk (512) and than danube-smoke's
16-slot ring, and 18 decode steps wrap that ring once more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.attention as jatt
from repro.data import lm_tokens as j_lm_tokens
from repro.launch.steps import make_prefill_step as j_make_prefill
from repro.launch.steps import make_serve_step as j_make_serve
from repro.models import cache_specs as j_cache_specs
from repro.models import forward_train as j_forward_train
from repro.models import init_from_specs as j_init
from repro.models import param_specs as j_param_specs
from repro.models.spec import ParamSpec as JParamSpec
from repro_torch import configs as tcfgs
from repro_torch.data import lm_tokens
from repro_torch.launch import make_prefill_step, make_serve_step, serve
from repro_torch.models import ParamSpec, transformer
from repro_torch.models.spec import init_from_specs
from _torch_threads import one_thread  # noqa: F401

ATOL = 3e-4
DENSE = ("h2o-danube-1.8b", "deepseek-7b", "qwen3-14b")
B, PROMPT, STEPS = 2, 600, 18


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close_scaled(got, want, msg=""):
    """``ATOL`` times the largest magnitude of ``want`` (at least 1)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _close_caches(got: dict, want: dict):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        _close_scaled(got[k], want[k], k)


def _setup(arch, prompt=PROMPT, gen=STEPS + 1, seed=0):
    """(cfg, the port's cfg, JAX params, the port's params, prompts)."""
    cfg, tcfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    params = j_init(j_param_specs(cfg), jax.random.key(seed))
    tparams = transformer.params_from_numpy(_np_tree(params))
    prompts = lm_tokens(B, prompt, cfg.vocab, seed=seed)
    return cfg, tcfg, params, tparams, prompts


def _caches(cfg, tcfg, max_len):
    jc = j_init(j_cache_specs(cfg, B, max_len, dtype=jnp.float32),
                jax.random.key(1))
    tc = init_from_specs(transformer.cache_specs(tcfg, B, max_len,
                                                 dtype=torch.float32), None)
    return jc, tc


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "xla"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_jax(arch, flash):
    """Last-position logits and the filled caches (ring placement for
    danube's window) against JAX ``prefill``."""
    cfg, tcfg, params, tparams, prompts = _setup(arch)
    jc, tc = _caches(cfg, tcfg, PROMPT + STEPS + 1)
    jatt.USE_FLASH_KERNEL = flash
    try:
        want, want_c = j_make_prefill(cfg)(params, jnp.asarray(prompts), jc)
    finally:
        jatt.USE_FLASH_KERNEL = False
    got, got_c = make_prefill_step(tcfg, "torch")(
        tparams, torch.as_tensor(prompts).long(), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _close_caches(got_c, _np_tree(want_c))


@pytest.mark.parametrize("arch", DENSE)
def test_teacher_forced_decode_matches_jax(arch):
    """``decode_step`` fed the same tokens for 18 steps (danube-smoke's
    ring of 16 wraps): logits at every step, and the caches at the end."""
    cfg, tcfg, params, tparams, prompts = _setup(arch)
    jc, tc = _caches(cfg, tcfg, PROMPT + STEPS + 1)
    logits, jc = jax.jit(j_make_prefill(cfg))(params, jnp.asarray(prompts),
                                              jc)
    _, tc = make_prefill_step(tcfg)(tparams, torch.as_tensor(prompts).long(),
                                    tc)
    jdec, tdec = jax.jit(j_make_serve(cfg)), make_serve_step(tcfg)
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    for i in range(STEPS):
        pos = PROMPT + i
        want, jc = jdec(params, jnp.asarray(tok)[:, None],
                        jnp.asarray(pos, jnp.int32), jc)
        got, tc = tdec(tparams, torch.as_tensor(tok).long()[:, None], pos, tc)
        _close_scaled(got.numpy(), want, f"step {i}")
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    _close_caches(tc, _np_tree(jc))


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_loop_matches_jax(arch):
    """The greedy prefill-and-decode loop of ``serve.run``, built from both
    packages' ``make_prefill_step`` / ``make_serve_step``: equal tokens."""
    prompt, gen = 40, 8
    cfg, tcfg, params, tparams, prompts = _setup(arch, prompt, seed=3)
    jc, tc = _caches(cfg, tcfg, prompt + gen)
    jpre, jdec = jax.jit(j_make_prefill(cfg)), jax.jit(j_make_serve(cfg))
    tpre, tdec = make_prefill_step(tcfg), make_serve_step(tcfg)
    lj, jc = jpre(params, jnp.asarray(prompts), jc)
    lt, tc = tpre(tparams, torch.as_tensor(prompts).long(), tc)
    jt, tt = [jnp.argmax(lj, -1)], [torch.argmax(lt, -1)]
    for i in range(gen - 1):
        lj, jc = jdec(params, jt[-1][:, None].astype(jnp.int32),
                      jnp.asarray(prompt + i, jnp.int32), jc)
        lt, tc = tdec(tparams, tt[-1][:, None], prompt + i, tc)
        jt.append(jnp.argmax(lj, -1))
        tt.append(torch.argmax(lt, -1))
    np.testing.assert_array_equal(torch.stack(tt, 1).numpy(),
                                  np.stack([np.asarray(t) for t in jt], 1))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_jax(arch):
    cfg, tcfg, params, tparams, _ = _setup(arch)
    toks = lm_tokens(1, 48, cfg.vocab, seed=5)
    want, _ = j_forward_train(params, jnp.asarray(toks), cfg)
    got, aux = transformer.forward_train(tparams, torch.as_tensor(toks).long(),
                                         tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("n,length,vocab,seed", [
    (2, 600, 512, 0), (3, 33, 32000, 7), (1, 100, 50, 1)])
def test_lm_tokens_bitwise(n, length, vocab, seed):
    got, want = lm_tokens(n, length, vocab, seed), \
        j_lm_tokens(n, length, vocab, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _shapes(tree, leaf_type):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()
            if isinstance(v, leaf_type)}


@pytest.mark.parametrize("arch", DENSE + ("llama-3.2-vision-11b",
                                           "seamless-m4t-large-v2"))
def test_full_configs_and_specs_match_jax(arch):
    """The FULL configs field for field, and ``param_specs`` /
    ``cache_specs`` names and shapes (nothing is allocated)."""
    cfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.torch_param_dtype == torch.bfloat16
    assert dataclasses.asdict(tcfgs.get_smoke(arch)) == \
        dataclasses.asdict(jcfgs.get_smoke(arch))
    assert _shapes(transformer.param_specs(tcfg), ParamSpec) == \
        _shapes(j_param_specs(cfg), JParamSpec)
    for batch, max_len in ((2, 8224), (1, 64)):
        assert _shapes(transformer.cache_specs(tcfg, batch, max_len),
                       ParamSpec) == \
            _shapes(j_cache_specs(cfg, batch, max_len), JParamSpec)


def test_registry_knows_every_arch():
    """Every id of the reference resolves to its config, full and smoke
    (the port runs all ten); an unknown id raises."""
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    for arch in tcfgs.ARCH_IDS:
        assert tcfgs.get_config(arch).name == jcfgs.get_config(arch).name
        assert tcfgs.get_smoke(arch).name == jcfgs.get_smoke(arch).name
    with pytest.raises(KeyError):
        tcfgs.get_config("gpt-2")


def test_init_draws_in_the_config_dtype_with_the_fan_in_rule():
    """Normal leaves ``N(0, 1) / sqrt(shape[-2])`` (``wq [L, d, H, Dh]``:
    1/sqrt(H)), norms ones, in the requested dtype; a seed repeats."""
    cfg = tcfgs.get_smoke("h2o-danube-1.8b")
    cfg = dataclasses.replace(cfg, d_model=256, n_layers=4)
    specs = transformer.param_specs(cfg)

    def draw(seed, dtype):
        g = torch.Generator()
        g.manual_seed(seed)
        return init_from_specs(specs, g, "cpu", dtype)

    p = draw(0, torch.bfloat16)
    wq = p["unit"]["0"]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (4, 256, 4, 64)
    assert abs(wq.float().std().item() * 2.0 - 1.0) < 0.05
    assert torch.equal(p["unit"]["0"]["ffn"]["norm"],
                       torch.ones((4, 256), dtype=torch.bfloat16))
    q = draw(0, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in
               zip(_flat(p).values(), _flat(q).values()))


def test_serve_run_on_the_cpu_and_its_device_rule(monkeypatch):
    """``run`` on the CPU at smoke width: greedy tokens, logits whose argmax
    they are, and a seed that repeats.  Without a GPU, ``device=None`` raises."""
    kw = dict(batch=2, prompt_len=24, gen=5, device="cpu", progress=False)
    a = serve.run("qwen3-14b", **kw)
    assert a["tokens"].shape == (2, 5) and a["tokens"].dtype == np.int32
    assert a["logits"].shape == (2, 5, 512)
    np.testing.assert_array_equal(a["tokens"], a["logits"].argmax(-1))
    b = serve.run("qwen3-14b", kernel_mode="torch", **kw)
    np.testing.assert_array_equal(a["logits"], b["logits"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run("h2o-danube-1.8b")
    with pytest.raises(ValueError, match="kernel_mode"):
        serve.run("h2o-danube-1.8b", device="cpu", kernel_mode="cuda")
