"""The port's prefill and decode steps on a multi-rank mesh against its
meshless steps and the JAX package's: the multi-head latent attention,
mixture-of-experts and recurrent archs (the harness and the tolerances
are ``tests/test_torch_mesh_serve.py``'s).

On a (data=2, model=2) mesh of four ``gloo`` ranks on the CPU:
minicpm3 and deepseek-v2-lite (MLA heads split, the compressed caches
split by position, each rank writing its own slots; deepseek's experts
split over ``model`` behind the all-to-all), grok (GQA 4 over 2 heads,
experts split), recurrentgemma (one kv head: its window cache split by
position; the recurrent states split by width) and mamba2.  deepseek and
grok are also held to the JAX package's steps.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import ServeCases, hold_serve  # noqa: E402

REL, REF_ATOL = 3e-4, 3e-4
CASES = ServeCases(("minicpm3-4b", "deepseek-v2-lite-16b", "grok-1-314b",
                    "recurrentgemma-9b", "mamba2-130m"), seed=300)
JAX_ANCHORED = ("deepseek-v2-lite-16b", "grok-1-314b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
