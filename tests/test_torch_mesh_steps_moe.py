"""The port's HieAvg train step on a multi-rank mesh against its meshless
step: the multi-head latent attention, mixture-of-experts and recurrent
archs (the harness, the tolerances and the dense archs are in
``tests/test_torch_mesh_steps.py``; deepseek-v2-lite and grok as one
client a pod in ``tests/test_torch_mesh_steps_ref.py``).

On a (data=2, model=2) mesh of four ``gloo`` ranks on the CPU: minicpm3
(MLA heads split), grok with two clients a pod (experts split over
``model``, the dispatched buffers moved by an all-to-all), and
recurrentgemma and mamba2 (their mixers over the gathered sequence, the
SSD scan per head, the RG-LRU scan per channel).  The placement of
``embed`` under one client a pod (FSDP over ``data``) is checked here.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import TrainCases, hold_step  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

ARCHS = ("minicpm3-4b", "grok-1-314b", "recurrentgemma-9b", "mamba2-130m")
CASES = TrainCases({a: (a, 2, (2, 2)) for a in ARCHS}, seed=100)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return CASES.run(tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES.cases))
def test_mesh_train_step_is_the_meshless_step(ranks, name):
    hold_step(ranks[name], CASES.meshless(name), CASES.cold(name), name)


def test_fl1_splits_embed_over_data():
    """One client a pod: the data axis splits ``embed`` (FSDP) where two
    clients a pod put the clients there."""
    import types

    from _torch_mesh import port_cfg
    from repro_torch.launch import sharding as shd
    from repro_torch.models import param_specs
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    for c, want in ((1, (None, None, "model", "data")),
                    (2, (None, "data", "model"))):
        spec = shd.shard_specs(param_specs(port_cfg("grok-1-314b", c)),
                               shd.train_rules(c), mesh,
                               prefix=((1, "fl_pods"), (c, "fl_clients")))
        assert spec["embed"]["tok"] == want, c
