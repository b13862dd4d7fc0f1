"""The port's sweep drivers (``examples_torch/sweep_grid.py``,
``sweep_topology.py``, ``latency_pareto.py``) against the reference's
sweep API, as ``tests/test_torch_examples.py`` holds the others.

Each driver's ``main`` runs on the CPU with the plain PyTorch versions at
``REDUCED`` with T = 2, 400 training and 100 test images, 2 steps an
epoch, the reference's initial weights carried over, beside the
reference's ``run_sweep``/``plan_sweep`` on its ``vmap`` path, both
planned with ``bucket_cost="proxy"``: the points, the plan (its
description and padding statistics), the clock, energy, latency and
block rows equal; accuracy within ``atol 0.02`` (the engine-parity
bound); the Pareto front the port computes from the reference's
accuracies the reference's own.  The grids are cut to keep the file
under a minute, each keeping its shape-changing or data-batched axis:
the topology grid to N, J in (2, 3) at K = 1 (two buckets, the devices
padded; the K axis is padded in the latency walkthrough's sweep and the
Pareto grid), the Pareto grid's K to (1, 2) at the multiplier 40 (where
the consensus protocol moves the clock).
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.fl import plan_sweep as j_plan_sweep  # noqa: E402
from repro.fl import run_plan as j_run_plan  # noqa: E402
from repro.fl import run_sweep as j_run_sweep  # noqa: E402

from _torch_examples import (ACC_TOL, CPU, KW,  # noqa: E402, F401
                             _one_torch_thread, close_sweep, driver,
                             ref_weights)
from _torch_threads import one_thread  # noqa: E402,F401


def test_sweep_grid_matches_the_reference():
    setting = dataclasses.replace(REDUCED, t_global_rounds=2)
    seeds, fractions = (0, 1), (0.2, 0.4)
    ref = j_run_sweep(setting, seeds=seeds,
                      overrides=[{"straggler_frac": f} for f in fractions],
                      normalize=True, placement="vmap", bucket_cost="proxy",
                      **KW)
    got = driver("sweep_grid").main(
        t_global_rounds=2, seeds=seeds, fractions=fractions,
        bucket_cost="proxy",
        init_params={s: ref_weights(setting, s) for s in seeds}, **KW, **CPU)
    close_sweep(got["sweep"], ref)
    assert got["blocks"] == int(ref.blocks.sum())
    np.testing.assert_allclose(got["best_acc"], ref.accuracy.max(axis=1),
                               atol=ACC_TOL)


def test_sweep_topology_matches_the_reference():
    """The plan (its description, its padding statistics) is the
    reference's, and so are the latency rows of every point."""
    setting = dataclasses.replace(REDUCED, t_global_rounds=2)
    edges, devices, k_grid = (2, 3), (2, 3), (1,)
    plan = j_plan_sweep(setting, overrides=[
        {"n_edges": n, "j_per_edge": j, "k_edge_rounds": k}
        for n, j, k in itertools.product(edges, devices, k_grid)],
        normalize=True, bucket_cost="proxy", **KW)
    described, stats = plan.describe(), plan.padding_stats()
    ref = j_run_plan(plan, placement="vmap")
    got = driver("sweep_topology").main(
        t_global_rounds=2, edges=edges, devices=devices, k_grid=k_grid,
        bucket_cost="proxy", init_params={0: ref_weights(setting)}, **KW,
        **CPU)
    assert got["describe"] == described
    assert got["padding_stats"] == stats
    assert got["buckets"] == len(plan.buckets) > 1
    close_sweep(got["sweep"], ref)


def _ref_front(cands: list) -> list:
    """The reference driver's Pareto front (``examples/latency_pareto.py``),
    written out: no other point both faster and at least as accurate."""
    front = [c for c in cands
             if not any(s2 < c[0] and a2 >= c[1] or (s2 <= c[0] and a2 > c[1])
                        for s2, a2, _, _ in cands)]
    return sorted(front, key=lambda c: (c[0], c[1]))


def test_latency_pareto_matches_the_reference():
    """The latency and energy trajectories of every point equal; the front
    the port computes from the reference's accuracies is the reference's
    front."""
    setting = dataclasses.replace(REDUCED, t_global_rounds=2)
    mod = driver("latency_pareto")
    mults, k_grid = (40.0,), (1, 2)
    overrides = [{"consensus": c, "consensus_mult": m, "k_edge_rounds": k}
                 for c, m, k in itertools.product(mod.CONSENSUS, mults,
                                                  k_grid)]
    ref = j_run_sweep(setting, overrides=overrides, normalize=True,
                      placement="vmap", bucket_cost="proxy", **KW)
    got = mod.main(t_global_rounds=2, cons_mults=mults, k_grid=k_grid,
                   bucket_cost="proxy", init_params={0: ref_weights(setting)},
                   **KW, **CPU)
    sw = got["sweep"]
    close_sweep(sw, ref)
    for p in range(len(ref.points)):
        for a, b in zip(sw.latency_trajectory(p)[:1] + sw.energy_trajectory(p),
                        ref.latency_trajectory(p)[:1]
                        + ref.energy_trajectory(p)):
            np.testing.assert_array_equal(a, b)
    ref_cands = [(float(ref.sim_clock[p, -1]), float(ref.accuracy[p].max()),
                  float(ref.sim_energy[p, -1]), ov)
                 for p, (ov, _) in enumerate(ref.points)]
    assert [c[0] for c in got["candidates"]] == [c[0] for c in ref_cands]
    assert [c[2] for c in got["candidates"]] == [c[2] for c in ref_cands]
    mixed = [(s, a_ref, e, ov) for (s, _, e, ov), (_, a_ref, _, _)
             in zip(got["candidates"], ref_cands)]
    assert mod.pareto_front(mixed) == _ref_front(ref_cands)
    np.testing.assert_allclose([c[1] for c in got["candidates"]],
                               [c[1] for c in ref_cands], atol=ACC_TOL)
