"""The port's HieAvg train step on a multi-rank mesh against its meshless
step and the JAX package's one-device step (the harness and the
tolerances are ``tests/test_torch_mesh_steps.py``'s): h2o-danube-1.8b,
deepseek-v2-lite-16b (MLA heads and experts split over ``model``, the
all-to-all) and grok-1-314b as its own config, one client a pod under
``TRAIN_RULES_FL1`` (``embed`` and the batch rows over ``data``: FSDP, its
weights gathered at use and their gradients reduce-scattered), on a
(data=2, model=2) mesh of four ``gloo`` ranks on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import TrainCases, hold_step  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

CASES = TrainCases({"h2o-danube-1.8b": ("h2o-danube-1.8b", 2, (2, 2)),
                    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", 2,
                                             (2, 2)),
                    "grok-1-314b/fl1": ("grok-1-314b", 1, (2, 2))},
                   seed=400)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return CASES.run(tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES.cases))
def test_mesh_train_step_is_the_meshless_step(ranks, name):
    hold_step(ranks[name], CASES.meshless(name), CASES.cold(name), name)


@pytest.mark.parametrize("name", list(CASES.cases))
def test_mesh_train_step_against_the_references_step(ranks, name):
    hold_step(ranks[name], CASES.reference(name), CASES.cold(name), name)
