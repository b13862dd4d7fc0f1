"""The port's HieAvg train step on a multi-rank mesh
(``repro_torch.launch.steps.make_hfl_train_step`` with ``mesh=``) against
its meshless step and the JAX package's one-device step: the dense,
cross-attention and GQA archs (the MLA, MoE and recurrent ones are in
``tests/test_torch_mesh_steps_moe.py``, the three held to the JAX
package's step too in ``tests/test_torch_mesh_steps_ref.py``).

Each case takes one step (E = 1 edge of C = 2 clients, 2 rows of 24
tokens a client, client 1 a straggler; ``tests/_torch_mesh.py``) on a
(data=2, model=2) mesh of four ``gloo`` ranks on the CPU: the clients
split over ``data``, each client slot a DTensor on ``model``
(tensor-parallel weights, the residual stream's sequence split, the
reference's hints as explicit redistributions, the flash attention's
plain version on each rank's shard).  qwen3-smoke also runs on
(model=3), where its 4 q heads do not divide: K/V gathered once a layer,
query rows split, each rank's causal mask offset by its rows.
mamba2-smoke cut to d_model 96 runs on (model=4), which splits its inner
width (192) but not its 6 SSD heads, as the production mesh splits
mamba2-130m's 1536 but not its 24 heads over 16: the heads' gradient
made whole before the view back from [..., H * P].  The ranks
of a mesh start in one subprocess group; rank 0 saves the outputs
gathered whole.  Weights are drawn with numpy by the reference's rule
(client c scaled by 1 + c/100), tokens and labels numpy from a seed.

Tolerances (float32, the HieAvg step's own in
``tests/test_torch_train.py``): the loss ``rtol 1e-5``; every parameter
and history leaf ``rtol 1e-5`` and ``atol`` 1e-6 plus 5e-3 times the
leaf's largest change in the step; the counts exactly.  The split
matmuls' and the all-reduces' reordered float32 sums move the gradients
by up to 2e-5 of a leaf's largest, which the update carries; the
leader's ``delta_mean`` is the difference of two nearly equal models and
holds that rounding at up to 4e-3 of its largest (recurrentgemma's
tail), where the reference's jit and eager steps differ by 1.7e-3.  The
hints are the reference's ``_set_moe_hint`` choices for every arch.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import TrainCases, hold_step  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

DENSE = ("deepseek-7b", "seamless-m4t-large-v2", "qwen3-14b",
         "llama-3.2-vision-11b")
CASES = TrainCases({**{a: (a, 2, (2, 2)) for a in DENSE},
                    "qwen3-14b/model3": ("qwen3-14b", 2, (1, 3)),
                    "mamba2-130m/6heads": ("mamba2-130m", 2, (1, 4),
                                           {"d_model": 96})})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return CASES.run(tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES.cases))
def test_mesh_train_step_is_the_meshless_step(ranks, name):
    hold_step(ranks[name], CASES.meshless(name), CASES.cold(name), name)


@pytest.mark.parametrize("model", [2, 3, 4, 16])
def test_the_hints_are_the_references_choices(model):
    """``steps.hint_flags`` against what the reference's ``_set_moe_hint``
    sets on a ``model`` axis of that extent, for every arch."""
    from jax.sharding import AbstractMesh

    import repro.launch.steps as jsteps
    import repro.models.attention as jatt
    import repro.models.moe as jmoe
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import hint_flags
    mesh = AbstractMesh((1, model), ("data", "model"))
    saved = jatt.HEAD_SPEC, jatt.KV_GATHER_SPEC, jmoe.EXPERT_PARALLEL_SPEC
    try:
        for arch in ARCH_IDS:
            jsteps._set_moe_hint(jget(arch), mesh)
            want = {"heads": jatt.HEAD_SPEC is not None,
                    "kv_gather": jatt.KV_GATHER_SPEC is not None,
                    "experts": jmoe.EXPERT_PARALLEL_SPEC is not None}
            assert hint_flags(get_config(arch), model) == want, arch
    finally:
        jatt.HEAD_SPEC, jatt.KV_GATHER_SPEC, jmoe.EXPERT_PARALLEL_SPEC = \
            saved
