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
grok are also held to the JAX package's steps.  minicpm3 also runs on
(data=2, model=3), which does not divide its 4 MLA heads, into caches of
36 positions, which it splits: the absorbed decode's sum over the
positions is pending on each rank, and is reduced before the view over
the heads, which would otherwise scatter it over them.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import ServeCases, hold_serve  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

REL, REF_ATOL = 3e-4, 3e-4
CASES = ServeCases(("minicpm3-4b", "deepseek-v2-lite-16b", "grok-1-314b",
                    "recurrentgemma-9b", "mamba2-130m"), seed=300)
JAX_ANCHORED = ("deepseek-v2-lite-16b", "grok-1-314b")
#: heads that (model=3) does not divide, cache positions that it does
UNEVEN = ServeCases(("minicpm3-4b",), seed=310, mesh=(2, 3), cache_len=36)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return CASES.run(tmp_path_factory)


@pytest.mark.parametrize("arch", CASES.archs)
def test_mesh_prefill_and_decode_are_the_meshless_steps(ranks, arch):
    hold_serve(ranks[arch], CASES.meshless(arch), REL, arch)


@pytest.fixture(scope="module")
def uneven_ranks(tmp_path_factory):
    return UNEVEN.run(tmp_path_factory)


@pytest.mark.parametrize("arch", UNEVEN.archs)
def test_mesh_steps_where_heads_do_not_divide_the_mesh(uneven_ranks, arch):
    hold_serve(uneven_ranks[arch], UNEVEN.meshless(arch), REL, arch)


@pytest.mark.parametrize("arch", JAX_ANCHORED)
def test_mesh_prefill_and_decode_against_the_references(ranks, arch):
    hold_serve(ranks[arch], CASES.reference(arch), REF_ATOL, arch,
               logits_atol=REF_ATOL)
