"""The port's slice as a whole: ``BHFLSimulator(...).run()`` against the JAX
package's, and the port's rules.

A whole TINY run of the port (on the CPU: the plain PyTorch versions) with
the JAX run's initial weights carried over must match
``repro.fl.BHFLSimulator(..., kernel_mode="xla").run()`` within the
tolerances of ``tests/test_engine_parity.py`` (accuracy ``atol 0.02``,
loss ``rtol = atol = 1e-3``, delta ``rtol 0.01``), with the clock and the
energy rows, the block count and the chain's validity equal.  Each JAX
reference run is shared by a module-scoped fixture.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.fl import BHFLSimulator  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TINY = dataclasses.replace(REDUCED, t_global_rounds=4, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=4, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)

ACC_TOL = 0.02
LOSS_TOL = 1e-3

CASES = {
    "faithful": dict(strag="temporary", normalize=False, kw={}),
    "normalized": dict(strag="temporary", normalize=True, kw={}),
    "permanent_ragged": dict(strag="permanent", normalize=True,
                             kw=dict(j_per_edge=[3, 2, 3])),
    "leader_crash": dict(strag="temporary", normalize=False,
                         kw=dict(fail_leader_at=3)),
}


def _settings(name):
    if name == "permanent_ragged":
        return (dataclasses.replace(TINY, permanent_stop_round=1),
                dataclasses.replace(PORT_TINY, permanent_stop_round=1))
    return TINY, PORT_TINY


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    case = CASES[request.param]
    s_jax, s_port = _settings(request.param)
    args = ("hieavg", case["strag"], case["strag"])
    sim = JaxSim(s_jax, *args, normalize=case["normalize"],
                 kernel_mode="xla", **KW, **case["kw"])
    w0 = {k: np.asarray(v) for k, v in
          init_from_specs(sim.specs, jax.random.key(sim.seed)).items()}
    ref = sim.run()
    got = BHFLSimulator(s_port, *args, normalize=case["normalize"],
                        device="cpu", init_params=w0, **KW,
                        **case["kw"]).run()
    return ref, got


def test_run_matches_jax(pair):
    ref, got = pair
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=ACC_TOL)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm, rtol=0.01,
                               atol=1e-4)


def test_clock_energy_and_chain_are_equal(pair):
    ref, got = pair
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    assert got.blocks == ref.blocks
    assert got.chain_valid == ref.chain_valid is True
    assert got.sim_latency == ref.sim_latency


def test_kernel_mode_torch_is_the_cpu_auto_run():
    """On the CPU "auto" takes the plain versions: bitwise "torch"."""
    a = BHFLSimulator(PORT_TINY, device="cpu", kernel_mode="auto", **KW).run()
    b = BHFLSimulator(PORT_TINY, device="cpu", kernel_mode="torch",
                      **KW).run()
    for x, y in ((a.accuracy, b.accuracy), (a.loss, b.loss),
                 (a.grad_norm, b.grad_norm), (a.sim_clock, b.sim_clock)):
        np.testing.assert_array_equal(x, y)
    assert np.isfinite(a.loss).all() and a.accuracy.shape == (4,)


# ------------------------------------------------------------------ rules
def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, and chip_smoke.py, imports with ``jax`` and
    ``repro`` blocked."""
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {str(ROOT / "src")!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in names:
    importlib.import_module(name)
import importlib.util
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
importlib.util.module_from_spec(spec)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m, v in sys.modules.items() if v is not None)
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_simulator_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BHFLSimulator(PORT_TINY, **KW)
    with pytest.raises(RuntimeError, match="no GPU"):
        BHFLSimulator(PORT_TINY, device="cuda", **KW)
    assert BHFLSimulator(PORT_TINY, device="cpu", **KW).device.type == "cpu"
    with pytest.raises(ValueError, match="kernel_mode"):
        BHFLSimulator(PORT_TINY, device="cpu", kernel_mode="cuda", **KW)
    with pytest.raises(ValueError, match="kernel_mode"):
        BHFLSimulator(PORT_TINY, device="cpu", kernel_mode="pallas", **KW)


@pytest.mark.parametrize("kw", [
    dict(population=100, j_cohort=3, j_per_edge=[3, 3, 3]),
    dict(population=100, j_cohort=3, device_rates=[1.0] * 9)])
def test_later_slices_raise(kw):
    """Population mode refuses a ragged device list and per-device rates
    with the reference's messages (the occupants' profiles set both)."""
    with pytest.raises(ValueError, match="j_cohort instead|device_rates "
                                         "only applies"):
        BHFLSimulator(PORT_TINY, device="cpu", **KW, **kw)


def test_switched_run_matches_jax():
    """``aggregator="switched"`` standalone: the aggregator its ``agg_sel``
    names (HieAvg), as the reference's traced tri-select runs it; within
    the engine-parity bounds, the clock and energy equal."""
    args = ("switched", "temporary", "temporary")
    sim = JaxSim(TINY, *args, kernel_mode="xla", **KW)
    w0 = {k: np.asarray(v) for k, v in
          init_from_specs(sim.specs, jax.random.key(sim.seed)).items()}
    ref = sim.run()
    got = BHFLSimulator(PORT_TINY, *args, device="cpu", init_params=w0,
                        **KW).run()
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=ACC_TOL)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm, rtol=0.01,
                               atol=1e-4)
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    assert got.blocks == ref.blocks


@pytest.mark.parametrize("entry", ["run_legacy"])
def test_later_entry_points_raise(entry):
    """``run_legacy`` refuses population mode, as the reference does."""
    sim = BHFLSimulator(PORT_TINY, device="cpu", population=100, j_cohort=3,
                        **KW)
    with pytest.raises(ValueError, match="engine path only"):
        getattr(sim, entry)()


@pytest.mark.parametrize("kw", [
    dict(aggregator="fedavg"), dict(aggregator="t_fedavg"),
    dict(aggregator="d_fedavg"), dict(aggregator="delayed_grad"),
    dict(history_dtype=torch.bfloat16),
    dict(history_dtype=torch.float8_e4m3fn)],
    ids=["fedavg", "t_fedavg", "d_fedavg", "delayed_grad", "bf16", "f8"])
def test_slice_two_options_are_accepted(kw):
    sim = BHFLSimulator(PORT_TINY, device="cpu", **KW, **kw)
    assert sim.aggregator == kw.get("aggregator", "hieavg")
    assert sim.history_dtype == kw.get("history_dtype")


@pytest.mark.parametrize("kw,err", [
    (dict(aggregator="fedprox"), "aggregator"),
    (dict(history_dtype=torch.float16), "history_dtype"),
    (dict(history_dtype=torch.float32), "history_dtype")],
    ids=["aggregator", "float16_history", "float32_history"])
def test_unknown_options_raise(kw, err):
    with pytest.raises(ValueError, match=err):
        BHFLSimulator(PORT_TINY, device="cpu", **KW, **kw)
