"""The port's example drivers (``examples_torch/``) against the reference API,
and the reference's public kernel and config names in the port.

Each driver's ``main`` runs on the CPU with the plain PyTorch versions
(``device="cpu", kernel_mode="torch"``) at a test size, beside the
reference's own API called directly at the same size (its drivers in
``examples/`` run at import, at full size, so they are not imported).
Here the first three (the sweeps: ``tests/test_torch_examples_sweep.py``;
serving and training: ``tests/test_torch_examples_llm.py``):

  * quickstart and leader failover at ``REDUCED`` with T = 3, 400
    training and 100 test images, 2 steps an epoch, the reference's
    initial weights carried over: the simulated clock and energy, the
    blocks, the chain's validity, the failover's new leader and surviving
    edges and the K* solve equal; accuracy within ``atol 0.02`` (the
    engine-parity bound of ``tests/test_engine_parity.py``);
  * the latency walkthrough: its closed-form section equal the
    reference's in float64, its dense-K table equal but for the
    convergence bound, within one float32 ulp (XLA fuses its arithmetic
    in its own order); its sweep (T = 3, K in (1, 2), the reference's
    ``vmap`` path, both planned with ``bucket_cost="proxy"``) with the
    clock equal and the same empirical K* at the reference's target.

Every driver raises without a GPU under its default device, and none
imports JAX, the JAX package or ``examples/``.  The public names:
``fused_edge_aggregate`` against the reference's in interpret mode at
``rtol 1e-5``, ``all_configs``, ``resolve_kernel_mode`` and
``fused_phase_coverage`` on a CPU and a faked CUDA device, the
re-exports, and an import that builds nothing.
"""
import ast
import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels as jkernels  # noqa: E402
from repro.configs import all_configs as j_all_configs  # noqa: E402
from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.core import (BoundParams, LatencyParams, RaftParams,  # noqa: E402
                        edge_window_k, expected_consensus_latency,
                        omega_bound, omega_bound_k, optimize_k,
                        optimize_k_masked, total_latency_k)
from repro.core import hieavg as jhieavg  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.fl import run_sweep as j_run_sweep  # noqa: E402
from repro.kernels.ops import \
    fused_edge_aggregate as j_fused_edge_aggregate  # noqa: E402
import repro_torch.kernels as tkernels  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.core.hieavg import History  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

from _torch_examples import (ACC_TOL, CPU, EXAMPLES, KW, ROOT,  # noqa: E402, F401
                             _one_torch_thread, driver, ref_weights)
from _torch_threads import one_thread  # noqa: E402,F401

DRIVERS = ("quickstart", "leader_failover", "latency_optimization",
           "latency_pareto", "sweep_grid", "sweep_topology", "serve_batched",
           "train_bhfl_llm")
#: float32 eps: XLA fuses the convergence bound's arithmetic in its own
#: order, one ulp off the port's at some K
F32_ULP = float(np.finfo(np.float32).eps)


# ------------------------------------------------------------ the drivers
def test_drivers_import_neither_jax_nor_the_reference():
    """Every driver the reference has, by its name, importing only the
    port (an AST walk: no ``jax``, ``repro`` or ``examples`` import)."""
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(DRIVERS)
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) \
        == sorted(DRIVERS)
    for name in DRIVERS:
        tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, name
                mods.add(node.module)
        tops = {m.split(".")[0] for m in mods}
        assert not tops & {"jax", "jaxlib", "repro", "examples"}, (name, mods)
        assert "repro_torch" in tops, name


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, name):
    """Under its default device a driver raises where no GPU is present:
    nothing carries on on the CPU unless asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        driver(name).main()


def _close_run(got: dict, ref) -> None:
    np.testing.assert_array_equal(got["sim_clock"], ref.sim_clock)
    np.testing.assert_array_equal(got["sim_energy"], ref.sim_energy)
    assert (got["blocks"], got["chain_valid"]) == (ref.blocks,
                                                   ref.chain_valid)
    np.testing.assert_allclose(got["accuracy"], ref.accuracy, atol=ACC_TOL)


def test_quickstart_matches_the_reference():
    setting = dataclasses.replace(REDUCED, t_global_rounds=3)
    sim = JaxSim(setting, aggregator="hieavg", device_stragglers="temporary",
                 edge_stragglers="temporary", normalize=True, **KW)
    ref = sim.run()
    lbc = sim.chain.consensus_latency()
    k_ref = optimize_k(LatencyParams(), lambda k: omega_bound(k, BoundParams()),
                       omega_bar=25.0, consensus_latency=lbc)
    got = driver("quickstart").main(t_global_rounds=3,
                                    init_params=ref_weights(setting), **KW,
                                    **CPU)
    _close_run(got, ref)
    assert got["chain_latency"] == lbc
    assert (got["k_star"], got["k_latency"]) == (k_ref.k_star,
                                                 k_ref.latency)


def test_leader_failover_matches_the_reference():
    setting = dataclasses.replace(REDUCED, t_global_rounds=3)
    sim = JaxSim(setting, "hieavg", "temporary", "temporary", normalize=True,
                 fail_leader_at=1, **KW)
    ref = sim.run()
    got = driver("leader_failover").main(
        t_global_rounds=3, fail_leader_at=1,
        init_params=ref_weights(setting), **KW, **CPU)
    _close_run(got, ref)
    assert got["leader"] == int(sim.chain.leader)
    assert got["alive"] == int(sim.chain.alive.sum())
    assert got["edges"] == sim.N and got["alive"] < got["edges"]


def test_latency_optimization_matches_the_reference():
    """Sections 1 and 3 (the host's solves) equal the reference's; section
    2's sweep has the reference's clock and its empirical K* at the
    reference's target."""
    bp, lp = BoundParams(), LatencyParams()
    k_grid = (1, 2)
    setting = dataclasses.replace(REDUCED, t_global_rounds=3)
    ref = j_run_sweep(setting, overrides=[{"k_edge_rounds": k}
                                          for k in k_grid],
                      normalize=True, placement="vmap", bucket_cost="proxy",
                      **KW)
    mod = driver("latency_optimization")
    got = mod.main(t_global_rounds=3, k_grid=k_grid, bucket_cost="proxy",
                   init_params={0: ref_weights(setting)}, **KW, **CPU)
    # 1) closed-form Raft latency -> K*
    want = []
    for link in mod.LINKS:
        lbc = expected_consensus_latency(RaftParams(link_latency=link), lp.N)
        res = optimize_k(lp, lambda k: omega_bound(k, bp), omega_bar=25.0,
                         consensus_latency=lbc)
        want.append((lbc, res and res.k_star, res and res.latency))
    assert got["theory"] == want
    # 2) the sweep
    sw = got["sweep"]
    assert sw.points == ref.points
    np.testing.assert_array_equal(sw.sim_clock, ref.sim_clock)
    np.testing.assert_allclose(sw.accuracy, ref.accuracy, atol=ACC_TOL)
    target = 0.6 * float(ref.accuracy.max())
    best, times = sw.k_star_empirical(target)
    best_ref, times_ref = ref.k_star_empirical(target)
    assert best == best_ref
    np.testing.assert_array_equal(times, times_ref)
    lbc = expected_consensus_latency(
        RaftParams(link_latency=setting.link_latency), setting.n_edges)
    assert got["k_star_theory"] == optimize_k(
        LatencyParams(T=3), lambda k: omega_bound(k, bp), omega_bar=25.0,
        consensus_latency=lbc).k_star
    # 3) the dense-K table
    lat, win, om = (total_latency_k(lp, 10), edge_window_k(lp, 10),
                    omega_bound_k(bp, 10))
    k_star, _, feas = optimize_k_masked(lat, om, win, 25.0, 0.45)
    np.testing.assert_array_equal(got["table_latency"], np.asarray(lat))
    np.testing.assert_array_equal(got["table_window"], np.asarray(win))
    np.testing.assert_allclose(got["table_omega"], np.asarray(om),
                               rtol=F32_ULP)
    np.testing.assert_array_equal(got["table_feasible"], np.asarray(feas))
    assert got["k_star_table"] == int(k_star)


# -------------------------------------------------- the public names
@pytest.mark.parametrize("normalize", [False, True])
def test_fused_edge_aggregate_matches_the_reference(normalize):
    """The single-edge API (uniform 1/n part weights) against the
    reference's Pallas kernel in interpret mode, f32 ``rtol 1e-5``."""
    rng = np.random.default_rng(7)
    n = 5
    w = {"a": rng.standard_normal((n, 13, 7)).astype(np.float32),
         "b": rng.standard_normal((n, 40)).astype(np.float32)}
    prev = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in w.items()}
    dmean = {k: 0.05 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in w.items()}
    n_obs = np.full((n,), 3.0, np.float32)
    miss = np.array([0.0, 1.0, 0.0, 2.0, 0.0], np.float32)
    mask = np.array([True, False, True, False, True])
    jh = jhieavg.History(
        prev_w={k: jnp.asarray(v) for k, v in prev.items()},
        delta_mean={k: jnp.asarray(v) for k, v in dmean.items()},
        n_obs=jnp.asarray(n_obs), miss_count=jnp.asarray(miss))
    want, wh = j_fused_edge_aggregate(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(mask), jh,
        gamma0=0.8, lam=0.7, normalize=normalize, interpret=True)
    th = History(prev_w={k: torch.from_numpy(v) for k, v in prev.items()},
                 delta_mean={k: torch.from_numpy(v) for k, v in dmean.items()},
                 n_obs=torch.from_numpy(n_obs),
                 miss_count=torch.from_numpy(miss))
    got, gh = tkernels.fused_edge_aggregate(
        {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(mask), th, gamma0=0.8, lam=0.7, normalize=normalize)
    for k in w:
        for g, r in ((got[k], want[k]), (gh.prev_w[k], wh.prev_w[k]),
                     (gh.delta_mean[k], wh.delta_mean[k])):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_array_equal(gh.n_obs.numpy(), np.asarray(wh.n_obs))
    np.testing.assert_array_equal(gh.miss_count.numpy(),
                                  np.asarray(wh.miss_count))


def test_all_configs_are_the_references():
    got, want = all_configs(), j_all_configs()
    assert list(got) == list(want)
    for arch, cfg in got.items():
        assert cfg.name == want[arch].name
        assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (
            want[arch].n_layers, want[arch].d_model, want[arch].vocab)


@pytest.mark.parametrize("mode", list(build.KERNEL_MODES))
def test_resolve_kernel_mode_agrees_with_use_kernel(monkeypatch, mode):
    """On a CPU device ``"auto"`` resolves to the plain versions and on a
    CUDA device (faked: no card here) to the kernels; explicit modes pass
    through; the phase coverage follows; ``build.use_kernel`` takes the
    kernel exactly where the mode resolves to ``"cuda"``."""
    cpu = torch.zeros(1)
    want_cpu = "torch" if mode == "auto" else mode
    assert tkernels.resolve_kernel_mode(mode, "cpu") == want_cpu
    assert tkernels.resolve_kernel_mode(mode, cpu.device) == want_cpu
    if mode == "cuda":
        with pytest.raises(ValueError, match="CUDA tensors"):
            build.use_kernel(mode, cpu)
    else:
        assert build.use_kernel(mode, cpu) is (want_cpu == "cuda")
    want_gpu = "cuda" if mode == "auto" else mode
    assert tkernels.resolve_kernel_mode(mode, torch.device("cuda")) \
        == want_gpu
    for avail, want in ((False, want_cpu), (True, want_gpu)):
        monkeypatch.setattr(torch.cuda, "is_available", lambda a=avail: a)
        assert tkernels.resolve_kernel_mode(mode) == want
        cov = tkernels.fused_phase_coverage(mode)
        assert list(cov) == list(tkernels.ROUND_PHASES)
        assert set(cov.values()) == {want == "cuda"}
    assert tkernels.fused_phase_coverage(mode, "cuda") == {
        p: want_gpu == "cuda" for p in tkernels.ROUND_PHASES}


def test_resolve_kernel_mode_refuses_unknown_modes():
    with pytest.raises(ValueError, match="expected one of"):
        tkernels.resolve_kernel_mode("pallas")
    with pytest.raises(ValueError, match="expected one of"):
        tkernels.fused_phase_coverage("xla", "cpu")


def test_kernels_export_the_references_public_names():
    """Every name of the reference's ``__all__`` but the JAX-only
    ``default_interpret``; the phases are the reference's; importing the
    package builds nothing and needs no nvcc (a fresh process with an
    empty PATH)."""
    want = set(jkernels.__all__) - {"default_interpret"}
    assert want <= set(tkernels.__all__)
    assert all(callable(getattr(tkernels, n)) or n.isupper()
               for n in tkernels.__all__)
    assert tkernels.ROUND_PHASES == jkernels.ROUND_PHASES
    code = ("import repro_torch, repro_torch.kernels as k\n"
            "from repro_torch.kernels import build\n"
            "assert build._LIB is None and callable(k.flash_attention)\n"
            "print(len(k.__all__))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == len(tkernels.__all__)
