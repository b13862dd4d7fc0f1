"""The port's sweep fabric (``repro_torch.fl.sweep``) against the JAX
package's, and against its own standalone runs.

At TINY (``REDUCED`` with T = 3, N = J = 3, 8x8 images, 300 training and
100 test images, 2 steps an epoch, as ``tests/test_sweep_fabric.py``):

  * every point of the port's ``run_sweep`` (on the CPU: the plain PyTorch
    versions) against the reference's ``run_sweep(placement="vmap")`` with
    the reference's initial weights carried over, both planned with
    ``bucket_cost="proxy"``: the engine-parity bounds of
    ``tests/test_engine_parity.py`` (accuracy ``atol 0.02``, loss
    ``rtol = atol = 1e-3``, delta ``rtol 0.01``), the clock and energy rows
    equal; over an N x J x K grid, ragged ``t_global_rounds``, varying
    steps per epoch, a ragged ``j_per_edge`` list, a mixed ``aggregation``
    grid (the ``"switched"`` engine) and a two-seed grid;
  * every point of the port's sweep against the port's standalone run of
    it, at the reference's own sweep-vs-standalone tolerances
    (``test_sweep_fabric._check_point``);
  * padding is a numeric no-op, padded planes are inert and bitwise the
    reference's, the proxy bucket plans are the reference's, and the
    reference's error paths raise with its messages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.fl import build_inputs as jax_build_inputs  # noqa: E402
from repro.fl import plan_sweep as jax_plan_sweep  # noqa: E402
from repro.fl import run_sweep as jax_run_sweep  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.fl import (BHFLSimulator, build_inputs,  # noqa: E402
                            plan_sweep, run_engine, run_plan, run_sweep)
from repro_torch.fl.sweep import SweepResult  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TINY = dataclasses.replace(REDUCED, t_global_rounds=3, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=3, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)
CPU = dict(device="cpu")

ACC_TOL, LOSS_TOL, DELTA_RTOL = 0.02, 1e-3, 0.01

#: the grids: (overrides, seeds, simulator kwargs)
GRIDS = {
    "topology": ([{"n_edges": n, "j_per_edge": j, "k_edge_rounds": k}
                  for n in (2, 3) for j in (2, 3) for k in (1, 2)],
                 (0,), KW),
    "ragged_rounds": ([{"t_global_rounds": 2}, {"t_global_rounds": 4}],
                      (0,), KW),
    "steps_per_epoch": ([{"j_per_edge": 2}, {"j_per_edge": 3}], (0,),
                        dict(KW, steps_per_epoch=None)),
    "ragged_j_list": ([{"j_per_edge": [1, 2, 3]}, {}], (0,), KW),
    "switched": ([{"aggregation": a, "straggler_frac": f}
                  for a in ("hieavg", "delayed_grad", "fedavg")
                  for f in (0.2, 0.4)], (0,), KW),
    "two_seeds": ([{}, {"straggler_frac": 0.4, "gamma0": 0.5}], (0, 1), KW),
}


def _jax_weights(seed: int) -> dict:
    """The reference's initial model of ``seed`` (what its sweep draws)."""
    sim = JaxSim(TINY, seed=seed, **KW)
    return {k: np.asarray(v) for k, v in
            init_from_specs(sim.specs, jax.random.key(seed)).items()}


@pytest.fixture(scope="module", params=list(GRIDS))
def sweeps(request):
    """(reference sweep, port sweep, grid name) of one grid."""
    overrides, seeds, kw = GRIDS[request.param]
    ref = jax_run_sweep(TINY, seeds, overrides=overrides, placement="vmap",
                        bucket_cost="proxy", **kw)
    got = run_sweep(PORT_TINY, seeds, overrides=overrides,
                    bucket_cost="proxy",
                    init_params={s: _jax_weights(s) for s in seeds},
                    **CPU, **kw)
    return ref, got, request.param


def test_sweep_matches_jax_point_by_point(sweeps):
    ref, got, _ = sweeps
    assert got.points == ref.points
    np.testing.assert_array_equal(got.t_valid, ref.t_valid)
    assert got.accuracy.shape == ref.accuracy.shape
    for p in range(len(ref.points)):
        np.testing.assert_allclose(got.accuracy[p], ref.accuracy[p],
                                   atol=ACC_TOL, err_msg=f"point {p}")
        np.testing.assert_allclose(got.loss[p], ref.loss[p], rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=f"point {p}")
        np.testing.assert_allclose(got.grad_norm[p], ref.grad_norm[p],
                                   rtol=DELTA_RTOL, atol=1e-4,
                                   err_msg=f"point {p}")


def test_sweep_clock_energy_and_chain_equal_jax(sweeps):
    ref, got, _ = sweeps
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    np.testing.assert_array_equal(got.blocks, ref.blocks)
    np.testing.assert_array_equal(got.sim_latency, ref.sim_latency)


def _check_point(sw, p, r):
    """The reference's sweep-vs-standalone tolerances."""
    tv = int(sw.t_valid[p])
    np.testing.assert_allclose(sw.accuracy[p, :tv], r.accuracy, atol=1e-6)
    np.testing.assert_allclose(sw.loss[p, :tv], r.loss, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sw.grad_norm[p, :tv], r.grad_norm, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(sw.sim_clock[p, :tv], r.sim_clock, rtol=1e-5)
    np.testing.assert_array_equal(sw.sim_energy[p, :tv], r.sim_energy)


def _standalone(ov: dict, seed: int, kw: dict, w0):
    ov = dict(ov)
    agg = ov.pop("aggregation", "hieavg")
    jpe = ov.pop("j_per_edge", None)
    sim_kw = dict(kw)
    if isinstance(jpe, list):
        sim_kw["j_per_edge"] = jpe
    elif jpe is not None:
        ov["j_per_edge"] = jpe
    return BHFLSimulator(dataclasses.replace(PORT_TINY, **ov), agg,
                         "temporary", "temporary", seed=seed, init_params=w0,
                         **CPU, **sim_kw).run()


def test_sweep_matches_its_standalone_runs(sweeps):
    _, got, name = sweeps
    kw = GRIDS[name][2]
    for p, (ov, seed) in enumerate(got.points):
        _check_point(got, p, _standalone(ov, seed, kw, _jax_weights(seed)))


def test_ragged_rounds_tail_convention(sweeps):
    """Past a point's own rounds: accuracy, clock and energy repeat the
    final valid value, loss and delta are 0."""
    _, got, name = sweeps
    for p in range(len(got.points)):
        tv = int(got.t_valid[p])
        np.testing.assert_array_equal(got.accuracy[p, tv:],
                                      got.accuracy[p, tv - 1])
        np.testing.assert_array_equal(got.sim_clock[p, tv:],
                                      got.sim_clock[p, tv - 1])
        np.testing.assert_array_equal(got.sim_energy[p, tv:],
                                      got.sim_energy[p, tv - 1])
        assert not got.loss[p, tv:].any() and not got.grad_norm[p, tv:].any()
        acc, loss, gn = got.trajectory(p)
        assert acc.shape == loss.shape == gn.shape == (tv,)
    if name == "ragged_rounds":
        assert got.accuracy.shape == (2, 4)


# ------------------------------------------------------ padding invariants
PAD = dict(t_max=5, k_max=4, n_max=5, j_max=6, steps_max=4)


def test_padded_inputs_are_bitwise_the_references():
    """The padded host plane, field by field, is the reference's (the
    initial weights aside: the port draws its own)."""
    got = build_inputs(BHFLSimulator(PORT_TINY, **CPU, **KW), **PAD)
    ref = jax_build_inputs(JaxSim(TINY, **KW), **PAD)
    for f in dataclasses.fields(got):
        if f.name == "init_w":
            continue
        want = np.asarray(getattr(ref, f.name))
        have = np.asarray(getattr(got, f.name))
        assert have.shape == want.shape, f.name
        assert have.dtype == want.dtype, f.name
        np.testing.assert_array_equal(have, want, err_msg=f.name)


def test_padded_inputs_are_inert():
    pad = build_inputs(BHFLSimulator(PORT_TINY, **CPU, **KW), **PAD)
    N, K, T, S = PORT_TINY.n_edges, PORT_TINY.k_edge_rounds, \
        PORT_TINY.t_global_rounds, 2
    assert (int(pad.n_valid), int(pad.k_valid), int(pad.t_valid),
            int(pad.s_valid)) == (N, K, T, S)
    np.testing.assert_array_equal(pad.j_arr[N:], 0.0)
    assert not pad.valid[N:].any() and not pad.valid[:, 3:].any()
    assert not pad.dev_masks[T:].any() and not pad.dev_masks[:, K:].any()
    assert not pad.edge_masks[:, N:].any()
    np.testing.assert_array_equal(pad.lr[T:], 0.0)
    np.testing.assert_array_equal(pad.lr[:, K:], 0.0)
    assert not pad.has_data[N:].any()
    assert not pad.batch_idx[:, :, :, :, S:].any()


def test_padding_is_a_numeric_noop():
    """A deployment run through padding to larger extents matches its
    unpadded self; its clock and energy rows exactly."""
    inp = build_inputs(BHFLSimulator(PORT_TINY, **CPU, **KW))
    pad = build_inputs(BHFLSimulator(PORT_TINY, **CPU, **KW), **PAD)
    a = run_engine(inp, **CPU)
    b = run_engine(pad, **CPU)
    T = PORT_TINY.t_global_rounds
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(y[:T], x, rtol=1e-5, atol=1e-6)
    for x, y in zip(a[3:], b[3:]):
        np.testing.assert_array_equal(y[:T], x)
        np.testing.assert_array_equal(y[T:], x[-1])


def test_build_inputs_rejects_undersized_pad_targets():
    with pytest.raises(ValueError, match="pad targets"):
        build_inputs(BHFLSimulator(PORT_TINY, **CPU, **KW), j_max=2)
    with pytest.raises(ValueError, match="pad targets"):
        build_inputs(BHFLSimulator(PORT_TINY, **CPU, **KW), t_max=1)


# ----------------------------------------------------------------- planner
#: grids whose proxy plans are held to the reference's
PLANS = {
    "mixed_shapes": (dict(overrides=[
        {"n_edges": 2}, {"n_edges": 4}, {"j_per_edge": 2},
        {"k_edge_rounds": 1}, {"t_global_rounds": 2}, {}],
        max_buckets=3, bucket_waste=1.0), KW),
    "fig3": (dict(overrides=[{f: v} for f, vs in (
        ("j_per_edge", (3, 5, 8)), ("n_edges", (3, 5, 8)),
        ("k_edge_rounds", (1, 2, 4)), ("straggler_frac", (0.2, 0.4)))
        for v in vs]), dict(KW, steps_per_epoch=None)),
    "single_bucket": (dict(overrides=[{"n_edges": 2, "k_edge_rounds": 2},
                                      {"n_edges": 4, "j_per_edge": 2}],
                           max_buckets=1), KW),
    "seeds_by_shape": (dict(seeds=(0, 1), overrides=[
        {}, {"n_edges": 2, "k_edge_rounds": 1}], max_buckets=2,
        bucket_waste=1.0), KW),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_proxy_bucket_plan_equals_the_references(name):
    plan_kw, kw = PLANS[name]
    plan_kw = dict(plan_kw)
    seeds = plan_kw.pop("seeds", (0,))
    ref = jax_plan_sweep(TINY, seeds, bucket_cost="proxy", **plan_kw, **kw)
    got = plan_sweep(PORT_TINY, seeds, bucket_cost="proxy", **plan_kw,
                     **CPU, **kw)
    assert [b.point_ids for b in got.buckets] == \
        [b.point_ids for b in ref.buckets]
    assert [b.grid_max for b in got.buckets] == \
        [b.grid_max for b in ref.buckets]
    assert got.grid_max == ref.grid_max and got.n_seeds == ref.n_seeds
    assert got.padding_stats() == ref.padding_stats()
    assert got.describe() == ref.describe()
    for gb, rb in zip(got.buckets, ref.buckets):
        np.testing.assert_array_equal(np.asarray(gb.inputs.seed_idx),
                                      np.asarray(rb.inputs.seed_idx))
        assert gb.inputs.dev_masks.shape == rb.inputs.dev_masks.shape
        # one data plane, the same arrays in every bucket
        assert gb.inputs.train_x is got.buckets[0].inputs.train_x
        assert gb.inputs.train_x.shape[0] == got.n_seeds


def test_measured_plan_runs_the_step_and_is_monotone():
    """``bucket_cost="measured"`` times the train step on the plan's device
    per device count; the cached cost grows strictly with the count."""
    from repro_torch.fl import sweep
    ovs = [{"n_edges": 2}, {"n_edges": 3}, {"j_per_edge": 2}]
    plan = plan_sweep(PORT_TINY, overrides=ovs, **CPU, **KW)
    assert sorted(i for b in plan.buckets for i in b.point_ids) == [0, 1, 2]
    geom = (8, PORT_TINY.batch_size, PORT_TINY.cnn_c1, PORT_TINY.cnn_c2,
            PORT_TINY.n_classes, "auto", "cpu")
    costs = [sweep._measured_step_time(d, geom) for d in (4, 6, 9)]
    assert all(b > a for a, b in zip(costs, costs[1:]))


def test_measured_bucket_cost_skips_padded_rounds_and_prices_the_stack(
        monkeypatch):
    """A measured bucket costs the steps the engine runs: at (t, k) only
    the points still running, as one stack of ``Pa·n·j`` devices, over the
    bucket's steps; padded rounds cost nothing."""
    from repro_torch.fl import sweep
    monkeypatch.setattr(sweep, "_measured_step_time",
                        lambda d, geom: 10.0 + d)
    exts = [dict(t=2, k=1, n=2, j=3, steps=4),
            dict(t=1, k=2, n=2, j=3, steps=4),
            dict(t=2, k=2, n=2, j=3, steps=5)]
    cost = sweep._measured_bucket_cost_fn(None, exts)
    # alone: t*k rounds of 5 steps at D = 6
    assert cost([2], exts[2]) == 5 * 4 * (10.0 + 6)
    # stacked under the envelope t=2, k=2, steps=5: (t0, k0) runs all
    # three points, (t0, k1) points 1 and 2, (t1, k0) points 0 and 2,
    # (t1, k1) point 2
    env = dict(t=2, k=2, n=2, j=3, steps=5)
    assert cost([0, 1, 2], env) == 5 * ((10 + 18) + 2 * (10 + 12)
                                        + (10 + 6))


def test_measured_planner_merges_only_what_is_faster_stacked():
    """With a bucket cost, a merge the bucket cap does not force happens
    only where the stack costs less than its parts: a step's host time
    shared by the stack pays for merging, device time spent on padding
    does not."""
    from repro_torch.fl import sweep
    exts = [dict(t=2, k=1, n=n, j=3, steps=2) for n in (2, 3, 5)]

    def priced(host):
        def cost(ids, ext):
            return ext["t"] * ext["k"] * ext["steps"] * (
                host + len(ids) * ext["n"] * ext["j"])
        return cost

    # device-bound: padding only costs, nothing merges unforced ...
    got = sweep._bucket_points(exts, 8, 1.25, bucket_cost_fn=priced(0.0))
    assert [b["ids"] for b in got] == [[0], [1], [2]]
    # ... and a cap of 2 forces the cheapest merge (the nearest shapes)
    got = sweep._bucket_points(exts, 2, 1.25, bucket_cost_fn=priced(0.0))
    assert [b["ids"] for b in got] == [[0, 1], [2]]
    # host-bound: one stack beats three runs
    got = sweep._bucket_points(exts, 8, 1.25, bucket_cost_fn=priced(100.0))
    assert [b["ids"] for b in got] == [[0, 1, 2]]
    assert got[0]["ext"]["n"] == 5


def test_measured_plan_is_uncapped_by_default(monkeypatch):
    """``max_buckets=None`` caps a proxy plan at the reference's 4 and a
    measured plan not at all: with device-bound step times no merge saves
    time, so every distinct shape keeps its bucket unless a cap forces
    one."""
    from repro_torch.fl import sweep
    monkeypatch.setattr(sweep, "_measured_step_time",
                        lambda d, geom: float(d))
    ovs = [{"n_edges": n} for n in (1, 2, 3, 4, 5)]
    assert len(plan_sweep(PORT_TINY, overrides=ovs, **CPU, **KW).buckets) \
        == 5
    assert len(plan_sweep(PORT_TINY, overrides=ovs, max_buckets=2, **CPU,
                          **KW).buckets) == 2
    assert len(plan_sweep(PORT_TINY, overrides=ovs, bucket_cost="proxy",
                          **CPU, **KW).buckets) <= 4


def test_identical_shapes_share_one_bucket():
    plan = plan_sweep(PORT_TINY, overrides=[{"straggler_frac": f}
                                            for f in (0.0, 0.2, 0.4)],
                      max_buckets=4, bucket_waste=1.0, **CPU, **KW)
    assert len(plan.buckets) == 1
    assert plan.padding_stats()["padded_flop_frac"] == 0.0
    assert plan.inputs.batch_idx.shape[0] == 3
    assert np.ndim(plan.inputs.seed_idx) == 0


def test_switched_points_run_in_branch_order_and_come_back_in_point_order():
    """Points listed across aggregators (not neighbours) give the same rows
    as the same points listed aggregator by aggregator."""
    a = [{"aggregation": g, "straggler_frac": 0.3}
         for g in ("fedavg", "hieavg", "delayed_grad", "hieavg")]
    b = [a[i] for i in (1, 3, 2, 0)]
    ra = run_sweep(PORT_TINY, overrides=a, bucket_cost="proxy", **CPU, **KW)
    rb = run_sweep(PORT_TINY, overrides=b, bucket_cost="proxy", **CPU, **KW)
    for i, j in enumerate((1, 3, 2, 0)):
        np.testing.assert_array_equal(rb.accuracy[i], ra.accuracy[j])
        np.testing.assert_array_equal(rb.loss[i], ra.loss[j])


# ------------------------------------------------------------ error paths
def test_unsupported_field_raises_naming_it():
    with pytest.raises(ValueError, match="image_hw"):
        run_sweep(PORT_TINY, overrides=[{"image_hw": 10}], **CPU, **KW)
    with pytest.raises(ValueError, match="batch_size"):
        run_sweep(PORT_TINY, overrides=[{"batch_size": 8}], **CPU, **KW)


def test_unknown_field_and_aggregation_raise_naming_them():
    with pytest.raises(ValueError, match="not_a_field"):
        run_sweep(PORT_TINY, overrides=[{"not_a_field": 1}], **CPU, **KW)
    with pytest.raises(ValueError, match="fedprox"):
        run_sweep(PORT_TINY, overrides=[{"aggregation": "fedprox"}], **CPU,
                  **KW)
    with pytest.raises(ValueError, match="traced-switched"):
        plan_sweep(PORT_TINY, overrides=[{"aggregation": "t_fedavg"},
                                         {"aggregation": "hieavg"}],
                   **CPU, **KW)


def test_mismatched_ragged_j_per_edge_raises():
    with pytest.raises(ValueError, match="n_edges"):
        run_sweep(PORT_TINY, overrides=[{"n_edges": 2,
                                         "j_per_edge": [3, 4, 5]}],
                  **CPU, **KW)


def test_forced_shard_raises_clearly_on_one_device():
    with pytest.raises(ValueError, match="placement='shard'"):
        run_sweep(PORT_TINY, overrides=[{}, {"straggler_frac": 0.4}],
                  placement="shard", bucket_cost="proxy", **CPU, **KW)
    with pytest.raises(ValueError, match="placement"):
        run_sweep(PORT_TINY, placement="mesh", bucket_cost="proxy", **CPU,
                  **KW)


def test_bad_bucket_knobs_raise():
    with pytest.raises(ValueError, match="max_buckets"):
        plan_sweep(PORT_TINY, overrides=[{"n_edges": 2}, {}], max_buckets=0,
                   bucket_cost="proxy", **CPU, **KW)
    with pytest.raises(ValueError, match="bucket_cost"):
        plan_sweep(PORT_TINY, bucket_cost="guess", **CPU, **KW)


def test_consumed_plan_raises_and_kept_plan_reruns():
    ovs = [{}, {"straggler_frac": 0.4}]
    kept = plan_sweep(PORT_TINY, overrides=ovs, bucket_cost="proxy", **CPU,
                      **KW)
    a = run_plan(kept, donate=False)
    b = run_plan(kept, donate=False)
    np.testing.assert_array_equal(a.accuracy, b.accuracy)
    np.testing.assert_array_equal(a.loss, b.loss)
    run_plan(kept)                                   # donated: consumed
    assert kept.buckets[0].inputs is None
    with pytest.raises(ValueError, match="consumed"):
        run_plan(kept)
    with pytest.raises(ValueError, match="consumed"):
        kept.inputs


def test_sweep_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan_sweep(PORT_TINY, bucket_cost="proxy", **KW)


# ------------------------------------------------------- K* selector
def _fake_result(accs, clocks):
    accs = np.asarray(accs, np.float32)
    clocks = np.asarray(clocks, np.float32)
    P, T = accs.shape
    zeros = np.zeros_like(accs)
    return SweepResult(points=[({}, 0)] * P, accuracy=accs, loss=zeros,
                       grad_norm=zeros, sim_clock=clocks, sim_energy=zeros,
                       sim_latency=np.zeros(P), blocks=np.zeros(P),
                       t_valid=np.full(P, T))


def test_time_to_accuracy_and_k_star_empirical():
    sw = _fake_result([[0.2, 0.4, 0.6], [0.5, 0.7, 0.8], [0.1, 0.2, 0.3]],
                      [[5.0, 10.0, 15.0], [8.0, 16.0, 24.0],
                       [1.0, 2.0, 3.0]])
    assert sw.time_to_accuracy(0, 0.4) == 10.0
    assert sw.time_to_accuracy(2, 0.95) == float("inf")
    best, times = sw.k_star_empirical(0.5)
    assert best == 1
    np.testing.assert_allclose(times, [15.0, 8.0, np.inf])
    best, times = sw.k_star_empirical(0.99)
    assert best is None and not np.isfinite(times).any()
    clock, energy = sw.energy_trajectory(0)
    assert clock.shape == energy.shape == (3,)
