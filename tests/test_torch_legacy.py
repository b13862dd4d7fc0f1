"""The port's ``run_legacy`` (the reference's per-edge loop, in plain
PyTorch) against the JAX package's, and against the port's own ``run()``.

At TINY (``REDUCED`` with T = 4, N = J = 3, 8x8 images, 300 training and
100 test images, 2 steps an epoch, as ``tests/test_engine_parity.py``),
on the CPU, the reference's initial weights carried over:

  * the single-model HieAvg entry points (``edge_aggregate``,
    ``global_aggregate``, ``aggregate``, ``edge_aggregate_cold``,
    ``global_aggregate_cold``) against the reference's at float32;
  * the shifted-sum model (``conv3x3_same_shifted``, ``cnn_loss_shifted``,
    ``cnn_accuracy_shifted``) against the reference's ``cnn_apply``,
    ``cnn_loss`` and ``cnn_accuracy``;
  * ``run_legacy`` for every aggregator (and HieAvg under a leader
    crash) within the engine-parity bounds (accuracy ``atol
    0.02``, loss ``rtol = atol = 1e-3``, delta ``rtol 0.01``) of the
    reference's ``run_legacy`` and of the port's ``run()``, blocks equal,
    chains valid;
  * its refusals of population mode and of stochastic faults.
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
from repro.models import cnn as jax_cnn  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.core import hieavg  # noqa: E402
from repro_torch.fl import BHFLSimulator, FaultSpec  # noqa: E402
from repro_torch.models import (cnn_accuracy_shifted,  # noqa: E402
                                cnn_loss_shifted, conv3x3_same_shifted)
from _torch_threads import one_thread  # noqa: E402,F401

TINY = dataclasses.replace(REDUCED, t_global_rounds=4, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=4, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)
ACC_TOL, LOSS_TOL, DELTA_RTOL = 0.02, 1e-3, 0.01


def _t(x) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


def _np(x) -> dict:
    return {k: np.asarray(v) for k, v in x.items()}


# ------------------------------------------- single-model HieAvg entries
def _histories(n: int, rng):
    """The same history on both sides: initialised from one submission,
    then two rounds of random submissions and masks folded in."""
    shapes = {"a": (n, 7), "b": (n, 2, 3)}
    w = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    ref, got = jax_hieavg.init_history(
        {k: jnp.asarray(v) for k, v in w.items()}), hieavg.init_history(_t(w))
    for _ in range(2):
        w = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        m = rng.random(n) < 0.6
        ref = jax_hieavg.update_history(
            ref, {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(m))
        got = hieavg.update_history(got, _t(w), torch.from_numpy(m))
    w = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    m = rng.random(n) < 0.6
    m[0] = False
    return w, m, ref, got


def _hist_close(got, ref):
    for f in ("prev_w", "delta_mean"):
        for k, v in getattr(ref, f).items():
            np.testing.assert_allclose(getattr(got, f)[k].numpy(),
                                       np.asarray(v), rtol=1e-6, atol=1e-7)
    for f in ("n_obs", "miss_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))


@pytest.mark.parametrize("normalize", [False, True])
def test_single_model_hieavg_entries_match_jax(normalize):
    rng = np.random.default_rng(3)
    w, m, ref_h, got_h = _histories(5, rng)
    wj, wt = {k: jnp.asarray(v) for k, v in w.items()}, _t(w)
    mj, mt = jnp.asarray(m), torch.from_numpy(m)
    j = np.array([2.0, 3.0, 1.0, 4.0, 2.0], np.float32)

    ra, rh = jax_hieavg.edge_aggregate(wj, mj, ref_h, gamma0=0.8, lam=0.7,
                                       normalize=normalize)
    ga, gh = hieavg.edge_aggregate(wt, mt, got_h, gamma0=0.8, lam=0.7,
                                   normalize=normalize)
    for k in w:
        np.testing.assert_allclose(ga[k].numpy(), np.asarray(ra[k]),
                                   rtol=1e-6, atol=1e-6)
    _hist_close(gh, rh)

    ra, rh = jax_hieavg.global_aggregate(wj, mj, ref_h, jnp.asarray(j),
                                         gamma0=0.8, lam=0.7,
                                         normalize=normalize)
    ga, gh = hieavg.global_aggregate(wt, mt, got_h, torch.from_numpy(j),
                                     gamma0=0.8, lam=0.7,
                                     normalize=normalize)
    for k in w:
        np.testing.assert_allclose(ga[k].numpy(), np.asarray(ra[k]),
                                   rtol=1e-6, atol=1e-6)
    _hist_close(gh, rh)

    pw = j / j.sum()
    ra, rh = jax_hieavg.aggregate(wj, mj, ref_h, jnp.asarray(pw), 0.8, 0.7,
                                  normalize)
    ga, gh = hieavg.aggregate(wt, mt, got_h, torch.from_numpy(pw), 0.8, 0.7,
                              normalize)
    for k in w:
        np.testing.assert_allclose(ga[k].numpy(), np.asarray(ra[k]),
                                   rtol=1e-6, atol=1e-6)
    _hist_close(gh, rh)

    for ref_c, got_c in (
            (jax_hieavg.edge_aggregate_cold(wj),
             hieavg.edge_aggregate_cold(wt)),
            (jax_hieavg.global_aggregate_cold(wj, jnp.asarray(j)),
             hieavg.global_aggregate_cold(wt, torch.from_numpy(j)))):
        for k in w:
            np.testing.assert_allclose(got_c[k].numpy(), np.asarray(ref_c[k]),
                                       rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- shifted-sum model
def test_shifted_sum_model_matches_jax():
    sim = JaxSim(TINY, **KW)
    w0 = _np(init_from_specs(sim.specs, jax.random.key(1)))
    rng = np.random.default_rng(0)
    x = rng.random((2, 6, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, (2, 6)).astype(np.int32)
    wk = rng.standard_normal((2, 3, 3, 4, 5)).astype(np.float32)
    xk = rng.standard_normal((2, 6, 8, 8, 4)).astype(np.float32)
    ref_conv = jax.vmap(jax_cnn._conv3x3_same)(jnp.asarray(xk),
                                               jnp.asarray(wk))
    np.testing.assert_allclose(
        conv3x3_same_shifted(torch.from_numpy(xk), torch.from_numpy(wk))
        .numpy(), np.asarray(ref_conv), rtol=1e-5, atol=1e-5)

    stacked = {k: np.stack([v, v * 0.5]) for k, v in w0.items()}
    ref_loss = jax.vmap(jax_cnn.cnn_loss)(
        {k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(x),
        jnp.asarray(y))
    got_loss = cnn_loss_shifted(_t(stacked), torch.from_numpy(x),
                                torch.from_numpy(y))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(ref_loss),
                               rtol=1e-5, atol=1e-6)

    xt = rng.random((50, 8, 8, 1)).astype(np.float32)
    yt = rng.integers(0, 10, 50).astype(np.int32)
    ref_acc = float(jax_cnn.cnn_accuracy(
        {k: jnp.asarray(v) for k, v in w0.items()}, jnp.asarray(xt),
        jnp.asarray(yt)))
    got_acc = cnn_accuracy_shifted(_t(w0), torch.from_numpy(xt),
                                   torch.from_numpy(yt))
    assert got_acc.dim() == 0 and float(got_acc) == ref_acc


# ------------------------------------------------------------ whole runs
CASES = {
    "hieavg": dict(agg="hieavg"),
    "t_fedavg": dict(agg="t_fedavg"),
    "d_fedavg": dict(agg="d_fedavg"),
    "delayed_grad": dict(agg="delayed_grad"),
    "fedavg": dict(agg="fedavg", strag="none"),
    "hieavg_leader_crash": dict(agg="hieavg", kw=dict(fail_leader_at=3)),
}


@pytest.fixture(scope="module", params=list(CASES))
def legacy(request):
    """(reference run_legacy, port run_legacy, port run) of one case."""
    case = CASES[request.param]
    strag = case.get("strag", "temporary")
    args = (case["agg"], strag, strag)
    kw = dict(KW, **case.get("kw", {}))
    sim = JaxSim(TINY, *args, kernel_mode="xla", **kw)
    w0 = _np(init_from_specs(sim.specs, jax.random.key(sim.seed)))
    ref = sim.run_legacy()
    got = BHFLSimulator(PORT_TINY, *args, device="cpu", init_params=w0,
                        **kw).run_legacy()
    run = BHFLSimulator(PORT_TINY, *args, device="cpu", init_params=w0,
                        **kw).run()
    return ref, got, run


def _within(got, ref):
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=ACC_TOL)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm,
                               rtol=DELTA_RTOL, atol=1e-4)
    assert got.blocks == ref.blocks
    assert got.chain_valid and ref.chain_valid


def test_run_legacy_matches_jax(legacy):
    """Within the bounds; the largest differences are printed (``-rP``
    shows them)."""
    ref, got, _ = legacy
    print({k: float(np.abs(getattr(got, k) - getattr(ref, k)).max())
           for k in ("accuracy", "loss", "grad_norm")})
    _within(got, ref)
    assert got.sim_clock is None and got.sim_energy is None
    assert got.sim_latency == ref.sim_latency


def test_run_legacy_matches_run(legacy):
    _, got, run = legacy
    print({k: float(np.abs(getattr(got, k) - getattr(run, k)).max())
           for k in ("accuracy", "loss", "grad_norm")})
    _within(got, run)


def test_run_legacy_repeats_and_advances_the_chain():
    """A fresh batch stream a call: two calls give the same rows; the chain
    advances by T blocks a call, as the reference's does."""
    sim = BHFLSimulator(PORT_TINY, device="cpu", **KW)
    a, b = sim.run_legacy(), sim.run_legacy()
    np.testing.assert_array_equal(a.accuracy, b.accuracy)
    np.testing.assert_array_equal(a.loss, b.loss)
    assert (a.blocks, b.blocks) == (4, 8) and b.chain_valid


def test_run_legacy_refuses_faults_and_population():
    faulty = BHFLSimulator(PORT_TINY, device="cpu",
                           faults=FaultSpec(edge_fail_rate=0.2,
                                            edge_recover_rate=0.5), **KW)
    with pytest.raises(ValueError, match="fault injection .* engine path"):
        faulty.run_legacy()
    pop = BHFLSimulator(PORT_TINY, device="cpu", population=50, j_cohort=3,
                        **KW)
    with pytest.raises(ValueError, match="population mode runs on the "
                                         "engine path only"):
        pop.run_legacy()
