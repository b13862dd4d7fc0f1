"""The port's prefill and decode steps on a multi-rank mesh
(``repro_torch.launch.steps.make_prefill_step`` / ``make_serve_step`` with
``mesh=``) against its meshless steps and the JAX package's: the dense,
cross-attention and GQA archs (the MLA, MoE and recurrent ones are in
``tests/test_torch_mesh_serve_moe.py``).

Each arch prefills 2 rows of 24 tokens and decodes two teacher-forced
tokens on a (data=2, model=2) mesh of four ``gloo`` ranks on the CPU
(``tests/_torch_mesh.py``), its inputs placed by
``launch.inputs.serve_input_specs``: the batch over ``data``, ``embed``
over ``data`` (gathered at use), heads, experts and the vocab over
``model``, and a cache over ``model`` by its kv heads or, where they do
not divide (MLA's latents, recurrentgemma's one kv head), by its
positions, each rank writing the slots it holds.  A model with
cross-attention gets raw memory, encoded on the mesh once.  Rank 0 saves
every step's logits and the caches at the end, gathered whole.

Tolerances (float32): the logits and every cache leaf ``rtol 1e-5`` and
``atol`` 3e-4 of their largest magnitude against the meshless steps.  The
split matmuls and the all-reduces sum in another order, which these
random smoke models amplify: a 3e-7 relative change of their weights
(two float32 ulps) moves the meshless logits by up to 2.2e-4 of the
largest (llama-3.2-vision, whose five random layers amplify float32
rounding 5-10x each), 1.9e-5 elsewhere; the mesh steps measured up to
1.05e-4 (llama-vision's logits).  Against the reference, the existing
LLM bounds (``tests/test_torch_mla_moe.py``): ``atol 3e-4`` on the
logits, 3e-4 of the largest on the caches.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import ServeCases, hold_serve  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

REL, REF_ATOL = 3e-4, 3e-4
CASES = ServeCases(("deepseek-7b", "seamless-m4t-large-v2", "qwen3-14b",
                    "llama-3.2-vision-11b", "h2o-danube-1.8b"), seed=200)
JAX_ANCHORED = ("h2o-danube-1.8b",)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return CASES.run(tmp_path_factory)


@pytest.mark.parametrize("arch", CASES.archs)
def test_mesh_prefill_and_decode_are_the_meshless_steps(ranks, arch):
    hold_serve(ranks[arch], CASES.meshless(arch), REL, arch)


@pytest.mark.parametrize("arch", JAX_ANCHORED)
def test_mesh_prefill_and_decode_against_the_references(ranks, arch):
    hold_serve(ranks[arch], CASES.reference(arch), REF_ATOL, arch,
               logits_atol=REF_ATOL)
