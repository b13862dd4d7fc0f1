"""HieAvg history storage in bfloat16 and float8_e4m3fn (``history_dtype``)
against the JAX package.

  * ``core.hieavg.to_history_dtype`` against ``jnp.astype``: the stored
    bits equal, bitwise, on the float8 edge values (448, 464, 464.01, 480,
    +-inf, NaN, the subnormals) and on random values over the whole range;
    a NaN is a NaN on both sides (bfloat16 NaN payloads differ between the
    frameworks, float8's are bitwise).  ``Tensor.to`` alone saturates
    where JAX gives NaN; the helper must not.
  * ``core.hieavg``'s cold-boot ``update_history`` and warm ``aggregate``,
    and the plain ``hieavg_agg``, against ``repro.core.hieavg`` and the
    Pallas ``hieavg_agg(interpret=True)``: the new histories bitwise (both
    round the same float32 values once), the aggregate at ``rtol 1e-5``,
    ``atol 1e-6`` (float32 sums in another order).
  * Whole TINY runs with the JAX run's initial weights carried over: bf16
    history at the engine-parity bounds of ``tests/test_engine_parity.py``
    (accuracy ``atol 0.02``, loss ``rtol = atol = 1e-3``, delta ``rtol
    0.01``), f8 history at the bound of ``tests/test_sweep_fabric.py``'s
    f8 test (loss ``rtol 0.2, atol 0.05``, accuracy ``atol 0.02``); clock,
    energy and blocks equal.  Measured on the CPU: the f8 run's loss rows
    differ from JAX's f8 run by at most 9.5e-7, its delta rows by 1.2e-7
    and its accuracy rows by 1.5e-8 (the same counts, divided in another
    order), as the bf16 run's do.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.core import hieavg as jax_hieavg  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.kernels.hieavg_agg import hieavg_agg as jax_agg  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.core import hieavg  # noqa: E402
from repro_torch.fl import BHFLSimulator  # noqa: E402
from repro_torch.kernels.hieavg_agg import hieavg_agg  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16, np.uint16),
          "f8": (torch.float8_e4m3fn, jnp.float8_e4m3fn, np.uint8)}

TINY = dataclasses.replace(REDUCED, t_global_rounds=4, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=4, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)

EDGES = np.array([0.0, -0.0, 1.0, 448.0, -448.0, 450.0, 464.0, -464.0,
                  np.nextafter(np.float32(464), np.float32(500)), 464.01,
                  -464.01, 480.0, 1e30, np.inf, -np.inf, np.nan, -np.nan,
                  2.0 ** -6, 2.0 ** -9, -2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11,
                  2.0 ** -11, 1.5 * 2.0 ** -9, 7 * 2.0 ** -10], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def bits(x) -> np.ndarray:
    """A narrow tensor's (or JAX array's) stored bits."""
    if isinstance(x, torch.Tensor):
        width = {torch.bfloat16: torch.uint16,
                 torch.float8_e4m3fn: torch.uint8}[x.dtype]
        return x.view(width).numpy()
    a = np.asarray(x)
    return a.view({2: np.uint16, 1: np.uint8}[a.dtype.itemsize])


@pytest.mark.parametrize("name", list(DTYPES))
def test_history_cast_is_jnp_astype(name):
    tdt, jdt, _ = DTYPES[name]
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal(20000)
            * np.exp(rng.uniform(-14, 8, 20000))).astype(np.float32)
    for x in (EDGES, wide):
        got = hieavg.to_history_dtype(t(x), tdt)
        want = jnp.asarray(x).astype(jdt)
        assert got.dtype == tdt
        wf = np.asarray(want.astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), wf)
        keep = ~np.isnan(wf) if name == "bf16" else slice(None)
        np.testing.assert_array_equal(bits(got)[keep], bits(want)[keep])
    if name == "f8":    # what the helper is for: the bare cast saturates
        inf = t(np.array([np.inf], np.float32))
        assert float(inf.to(tdt).float()) == 448.0
        assert np.isnan(float(hieavg.to_history_dtype(inf, tdt).float()))


def _history_inputs(seed, n=5, length=2049):
    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal((n, length)).astype(np.float32)
    w1 = (w0 + 0.1 * rng.standard_normal((n, length))).astype(np.float32)
    w2 = (w1 + 0.1 * rng.standard_normal((n, length))).astype(np.float32)
    return (w0, w1, w2, np.array([1, 0, 1, 1, 0], bool),
            np.array([0, 1, 1, 0, 1], bool))


def _assert_history_equal(got: hieavg.History, want):
    for field in ("prev_w", "delta_mean"):
        g, w = getattr(got, field)["a"], getattr(want, field)["a"]
        assert g.dtype != torch.float32
        np.testing.assert_array_equal(bits(g), bits(w), err_msg=field)
    np.testing.assert_array_equal(got.n_obs.numpy(), np.asarray(want.n_obs))
    np.testing.assert_array_equal(got.miss_count.numpy(),
                                  np.asarray(want.miss_count))


@pytest.mark.parametrize("name", list(DTYPES))
def test_cold_and_warm_history_updates_match_jax(name):
    """The cold-boot update rounds the estimate to the storage dtype before
    it is mixed, the warm one keeps it in float32: both as the reference."""
    tdt, jdt, _ = DTYPES[name]
    w0, w1, w2, m1, m2 = _history_inputs(1)
    jh = jax_hieavg.init_history({"a": w0}, jdt)
    th = hieavg.init_history({"a": t(w0)}, tdt)
    _assert_history_equal(th, jh)
    jh = jax_hieavg.update_history(jh, {"a": w1}, m1)
    th = hieavg.update_history(th, {"a": t(w1)}, t(m1))
    _assert_history_equal(th, jh)
    pw = np.full(5, 0.2, np.float32)
    ja, jh = jax_hieavg.aggregate({"a": w2}, m2, jh, pw, 0.9, 0.9)
    ta, th = hieavg.aggregate({"a": t(w2)}, t(m2), th, t(pw), 0.9, 0.9)
    _assert_history_equal(th, jh)
    np.testing.assert_allclose(ta["a"].numpy(), np.asarray(ja["a"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.kernel_oracle
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("length", [1, 7, 2047, 2049])
def test_hieavg_agg_narrow_history_matches_pallas(name, length):
    """The plain ``hieavg_agg`` with narrow history operands against the
    Pallas kernel, with an estimate past float8's range in one slot."""
    tdt, jdt, _ = DTYPES[name]
    rng = np.random.default_rng(length)
    n = 5
    w = rng.standard_normal((n, length)).astype(np.float32)
    prev = np.array(jnp.asarray(rng.standard_normal((n, length)) * 4)
                     .astype(jdt))
    dmean = np.array(jnp.asarray(rng.standard_normal((n, length)) * 0.1)
                     .astype(jdt))
    prev[1, 0] = dmean[1, 0] = np.asarray(jnp.float32(300).astype(jdt))
    mask = np.array([1, 0, 1, 0, 1], bool)
    cp = (rng.random(n) * mask).astype(np.float32)
    ce = (rng.random(n) * ~mask).astype(np.float32)
    nobs = np.arange(n, dtype=np.float32)
    want = jax_agg(w, prev, dmean, mask, cp, ce, nobs, interpret=True)

    def narrow(a):
        return t(bits(a)).view(tdt)[None]

    got = hieavg_agg(t(w)[None], narrow(prev), narrow(dmean), t(mask)[None],
                     t(cp)[None], t(ce)[None], t(nobs)[None])
    assert got[0].dtype == torch.float32
    assert got[1].dtype == got[2].dtype == tdt
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(bits(g[0]), bits(w_))


# -------------------------------------------------------------- whole runs
@pytest.fixture(scope="module", params=list(DTYPES))
def pair(request):
    tdt, jdt, _ = DTYPES[request.param]
    sim = JaxSim(TINY, "hieavg", "temporary", "temporary", kernel_mode="xla",
                 history_dtype=jdt, **KW)
    w0 = {k: np.asarray(v) for k, v in
          init_from_specs(sim.specs, jax.random.key(sim.seed)).items()}
    ref = sim.run()
    got = BHFLSimulator(PORT_TINY, "hieavg", "temporary", "temporary",
                        device="cpu", init_params=w0, history_dtype=tdt,
                        **KW).run()
    return request.param, ref, got


def test_narrow_history_run_matches_jax(pair):
    name, ref, got = pair
    loss_rtol, loss_atol = (1e-3, 1e-3) if name == "bf16" else (0.2, 0.05)
    assert np.isfinite(got.loss).all() and np.isfinite(got.accuracy).all()
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=0.02)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=loss_rtol,
                               atol=loss_atol)
    if name == "bf16":
        np.testing.assert_allclose(got.grad_norm, ref.grad_norm, rtol=0.01,
                                   atol=1e-4)
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    assert got.blocks == ref.blocks and got.chain_valid


def test_narrow_history_changes_the_run():
    """The storage dtype reaches the run: f8 history gives another
    trajectory than float32 history."""
    a = BHFLSimulator(PORT_TINY, device="cpu", **KW).run()
    b = BHFLSimulator(PORT_TINY, device="cpu",
                      history_dtype=torch.float8_e4m3fn, **KW).run()
    assert not np.array_equal(a.loss, b.loss)
