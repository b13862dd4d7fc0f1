"""The port's population mode against the JAX package's.

At TINY (``REDUCED`` with T = 4, N = J = 3, 8x8 images, 300 training and
100 test images, 2 steps an epoch, a store of 200 devices and a cohort of
3 a edge, as ``tests/test_population.py``), on the CPU (the plain PyTorch
versions), the reference's initial weights carried over:

  * the store (``repro_torch.fl.population``) is bitwise the reference's:
    profiles, ``cohort_ids`` under every resample policy, ``subset``, and
    ``as_population``'s coercions and errors;
  * whole population runs of HieAvg, delayed-gradient (``resample=
    "round"``: the churn reset fires) and T-FedAvg are within the
    engine-parity bounds of ``repro.fl.BHFLSimulator(..., population=...)
    .run()`` (accuracy ``atol 0.02``, loss ``rtol = atol = 1e-3``, delta
    ``rtol 0.01``), the clock and energy rows equal;
  * a gathered cohort runs bitwise as ``store.subset`` of its rows, a run
    cut and resumed through ``run_checkpointed`` is bitwise the
    uninterrupted one, and a population sweep matches the reference's
    ``run_sweep(population=..., placement="vmap")`` and its own standalone
    runs;
  * the refusals of population mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.fl import run_sweep as jax_run_sweep  # noqa: E402
from repro.fl import population as jax_pop  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.fl import (BHFLSimulator, DevicePopulation,  # noqa: E402
                            PopulationSpec, as_population, build_inputs,
                            run_sweep)
from repro_torch.fl import engine  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TINY = dataclasses.replace(REDUCED, t_global_rounds=4, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=4, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)
POP = 200
ACC_TOL, LOSS_TOL, DELTA_RTOL = 0.02, 1e-3, 0.01


def _weights() -> dict:
    sim = JaxSim(TINY, **KW)
    return {k: np.asarray(v) for k, v in
            init_from_specs(sim.specs, jax.random.key(sim.seed)).items()}


W0 = None


def _w0() -> dict:
    global W0
    if W0 is None:
        W0 = _weights()
    return W0


def _port(agg="hieavg", population=POP, j_cohort=3, strag="temporary",
          **kw):
    return BHFLSimulator(PORT_TINY, agg, strag, strag, population=population,
                         j_cohort=j_cohort, device="cpu", init_params=_w0(),
                         **KW, **kw)


def _close(got, ref):
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=ACC_TOL)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm,
                               rtol=DELTA_RTOL, atol=1e-4)
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)


def _same(a, b):
    for k in ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


# ------------------------------------------------------------ the store
@pytest.mark.parametrize("spec", [
    dict(size=500, j_cohort=3), dict(size=100, j_cohort=4, resample="static"),
    dict(size=8, j_cohort=4, resample="full"),
    dict(size=50, j_cohort=2, miss_frac=0.0, speed_sigma=0.0),
    dict(size=50, j_cohort=2, miss_frac=1.0, miss_conc=3.0)],
    ids=["round", "static", "full", "no_miss_no_spread", "all_miss"])
def test_store_is_bitwise_the_reference(spec):
    ref = jax_pop.DevicePopulation(jax_pop.PopulationSpec(**spec),
                                   n_classes=10, max_classes=2, seed=7)
    got = DevicePopulation(PopulationSpec(**spec), n_classes=10,
                           max_classes=2, seed=7)
    for f in ("classes", "miss_prob", "time_scale"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    ids = ref.cohort_ids(6, 2, seed=3)
    np.testing.assert_array_equal(got.cohort_ids(6, 2, seed=3), ids)
    rs, gs = ref.subset(ids[-1]), got.subset(ids[-1])
    assert gs.spec.resample == "full" and gs.size == ids[-1].size
    for f in ("classes", "miss_prob", "time_scale"):
        np.testing.assert_array_equal(getattr(gs, f), getattr(rs, f))
    np.testing.assert_array_equal(gs.cohort_ids(3, 2, seed=0),
                                  rs.cohort_ids(3, 2, seed=0))


def test_cohort_policies_and_full_size_error():
    got = DevicePopulation(PopulationSpec(size=100, j_cohort=4),
                           n_classes=10, seed=0).cohort_ids(6, 2, seed=3)
    assert got.shape == (6, 2, 4) and not np.array_equal(got[0], got[1])
    st = DevicePopulation(PopulationSpec(size=100, j_cohort=4,
                                         resample="static"),
                          n_classes=10, seed=0).cohort_ids(6, 2, seed=3)
    assert np.array_equal(st[0], st[-1])
    full = DevicePopulation(PopulationSpec(size=8, j_cohort=4,
                                           resample="full"),
                            n_classes=10, seed=0)
    with pytest.raises(ValueError, match="population == N"):
        full.cohort_ids(6, 3, seed=3)


def test_as_population_coercions_and_errors():
    for fn in (jax_pop.as_population, as_population):
        with pytest.raises(ValueError, match="explicit j_cohort"):
            fn(100, None, n_classes=10, max_classes=1, seed=0)
        pop = fn(100, 4, n_classes=10, max_classes=1, seed=0)
        assert pop.size == 100 and pop.spec.j_cohort == 4
        assert fn(pop, None, n_classes=10, max_classes=1, seed=1) is pop
        assert fn(pop, 4, n_classes=10, max_classes=1, seed=1) is pop
        with pytest.raises(ValueError, match="conflicts with the population"):
            fn(pop, 5, n_classes=10, max_classes=1, seed=0)
        spec = type(pop.spec)(size=30, j_cohort=2, resample="static")
        with pytest.raises(ValueError, match="conflicts with spec"):
            fn(spec, 3, n_classes=10, max_classes=1, seed=0)
    a = jax_pop.as_population(jax_pop.PopulationSpec(size=30, j_cohort=2),
                              None, n_classes=10, max_classes=1, seed=5)
    b = as_population(PopulationSpec(size=30, j_cohort=2), None,
                      n_classes=10, max_classes=1, seed=5)
    np.testing.assert_array_equal(b.miss_prob, a.miss_prob)


@pytest.mark.parametrize("kw,err", [
    (dict(size=0, j_cohort=1), "population size"),
    (dict(size=5, j_cohort=0), "j_cohort"),
    (dict(size=5, j_cohort=1, resample="daily"), "resample"),
    (dict(size=5, j_cohort=1, miss_frac=1.5), "miss_frac")],
    ids=["size", "j_cohort", "resample", "miss_frac"])
def test_spec_errors(kw, err):
    with pytest.raises(ValueError, match=err):
        jax_pop.PopulationSpec(**kw)
    with pytest.raises(ValueError, match=err):
        PopulationSpec(**kw)


# ------------------------------------------------------- whole runs
@pytest.fixture(scope="module", params=["hieavg", "delayed_grad",
                                        "t_fedavg"])
def runs(request):
    """(reference run, port run, churn resets the port applied, host
    plane's count of occupant changes) of one aggregator."""
    agg = request.param
    ref = JaxSim(TINY, agg, "temporary", "temporary", population=POP,
                 j_cohort=3, kernel_mode="xla", **KW).run()
    engine.CHURN_RESETS.clear()
    got = _port(agg).run()
    resets = engine.CHURN_RESETS["slots"]
    changes = int(build_inputs(_port(agg)).cohort_change.sum())
    return ref, got, resets, changes, agg


def test_population_run_matches_jax(runs):
    ref, got, *_ = runs
    _close(got, ref)
    assert got.blocks == ref.blocks and got.chain_valid


def test_churn_resets_fire_under_delayed_grad_only(runs):
    _, _, resets, changes, agg = runs
    assert changes > 0
    assert resets == (changes if agg == "delayed_grad" else 0)


def test_gathered_cohort_is_bitwise_its_subset():
    """A static cohort out of the 200-device store runs bitwise as the
    materialized ``subset`` of its rows (a "full" population)."""
    spec = PopulationSpec(size=POP, j_cohort=3, resample="static")
    big = _port("delayed_grad", population=spec, j_cohort=None)
    small = _port("delayed_grad", population=big.pop.subset(
        big.cohort_ids[0]), j_cohort=None)
    _same(big.run(), small.run())


def test_population_resumes_bitwise(tmp_path):
    """Cut after its first chunk and resumed from a fresh simulator: bitwise
    the uninterrupted checkpointed run (the churn plane is an input, the
    pending store and its ages are in the carry), close to ``run()``."""
    full = _port("delayed_grad").run_checkpointed(str(tmp_path / "a"),
                                                  every=2)
    _port("delayed_grad").run_checkpointed(str(tmp_path / "b"), every=2)
    last = max((tmp_path / "b").glob("step_*.npz"))
    last.unlink()
    last.with_suffix(".json").unlink()
    resumed = _port("delayed_grad").run_checkpointed(str(tmp_path / "b"),
                                                     every=2)
    _same(resumed, full)
    one = _port("delayed_grad").run()
    np.testing.assert_allclose(full.loss, one.loss, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(full.sim_clock, one.sim_clock)


def test_population_sweep_matches_jax_and_standalone():
    """HieAvg and delayed-gradient over one shared store as one "switched"
    stack: each point within the engine-parity bounds of the reference's
    ``run_sweep(population=...)`` and of its own standalone run."""
    ovs = [{"aggregation": "hieavg"},
           {"aggregation": "delayed_grad", "staleness_discount": 0.5}]
    ref = jax_run_sweep(
        TINY, seeds=(0,), overrides=ovs, placement="vmap",
        bucket_cost="proxy",
        population=jax_pop.DevicePopulation(
            jax_pop.PopulationSpec(size=POP, j_cohort=3),
            n_classes=TINY.n_classes, seed=0), **KW)
    store = DevicePopulation(PopulationSpec(size=POP, j_cohort=3),
                             n_classes=TINY.n_classes, seed=0)
    got = run_sweep(PORT_TINY, seeds=(0,), overrides=ovs,
                    bucket_cost="proxy", population=store, device="cpu",
                    init_params=_w0(), **KW)
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    for p, ov in enumerate(ovs):
        np.testing.assert_allclose(got.accuracy[p], ref.accuracy[p],
                                   atol=ACC_TOL)
        np.testing.assert_allclose(got.loss[p], ref.loss[p], rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        setting = dataclasses.replace(
            PORT_TINY, **{k: v for k, v in ov.items() if k != "aggregation"})
        alone = BHFLSimulator(setting, ov["aggregation"], population=store,
                              device="cpu", init_params=_w0(), **KW).run()
        np.testing.assert_allclose(got.accuracy[p], alone.accuracy,
                                   atol=1e-6)
        np.testing.assert_allclose(got.loss[p], alone.loss, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got.sim_clock[p], alone.sim_clock)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("kw,err", [
    (dict(j_per_edge=[3, 3, 3]), "j_cohort instead of j_per_edge"),
    (dict(device_rates=[1.0] * 9), "device_rates only"),
    (dict(strag="permanent"), "'temporary' or 'none'")],
    ids=["j_per_edge", "device_rates", "permanent"])
def test_population_refusals(kw, err):
    with pytest.raises(ValueError, match=err):
        _port(**kw)


def test_population_needs_every_assigned_class():
    """13 training images of seed 0 hold every class but 8."""
    with pytest.raises(ValueError, match="every assigned class"):
        BHFLSimulator(PORT_TINY, population=POP, j_cohort=3, device="cpu",
                      n_train=13, n_test=4, steps_per_epoch=1)
