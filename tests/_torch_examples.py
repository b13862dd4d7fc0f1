"""Shared by the tests of the port's example drivers
(``tests/test_torch_examples*.py``): a driver loaded as a module, the
reference's initial weights, and the test size."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
#: the test size of the CNN drivers, on the CPU's plain path
KW = dict(n_train=400, n_test=100, steps_per_epoch=2)
CPU = dict(device="cpu", kernel_mode="torch")
#: the engine-parity accuracy bound (tests/test_engine_parity.py)
ACC_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread a test worker (the suite runs
    six workers on eight cores).  Autouse in each test module that
    imports it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def driver(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_weights(setting, seed: int = 0) -> dict:
    """The reference's initial CNN of ``seed`` at ``setting`` (what its
    runs draw), as numpy arrays for ``init_params``."""
    import jax

    from repro.fl import BHFLSimulator
    from repro.models import init_from_specs
    sim = BHFLSimulator(setting, seed=seed, **KW)
    return {k: np.asarray(v) for k, v in
            init_from_specs(sim.specs, jax.random.key(seed)).items()}


def close_sweep(got, ref) -> None:
    """A port sweep against the reference's: the points, their round
    counts, clock, energy, latency and block rows equal; accuracy within
    ``ACC_TOL``."""
    assert got.points == ref.points
    np.testing.assert_array_equal(got.t_valid, ref.t_valid)
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    np.testing.assert_array_equal(got.sim_latency, ref.sim_latency)
    np.testing.assert_array_equal(got.blocks, ref.blocks)
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=ACC_TOL)
