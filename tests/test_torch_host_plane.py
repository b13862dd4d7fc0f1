"""The port's host plane is bitwise the JAX package's.

``repro_torch.fl.engine.build_inputs`` must emit, for every field it
builds, the array ``repro.fl.engine.build_inputs`` emits for the same
deployment — same dtypes, shapes and bits — except ``init_w``, which the
port draws from its own ``torch.Generator`` (or takes carried over).  The
population cases (``resample`` "round", "static" and "full") hold the
cohort's batch draw, its occupants' time scales and the ``cohort_change``
plane the same way.  The
numpy helpers it stands on (``paper_lr``, ``class_images``) are pinned the
same way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.data import class_images as jax_class_images  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.fl.engine import build_inputs as jax_build_inputs  # noqa: E402
from repro.fl.population import PopulationSpec as JaxSpec  # noqa: E402
from repro.optim import paper_lr as jax_paper_lr  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.data import class_images  # noqa: E402
from repro_torch.fl import BHFLSimulator, PopulationSpec  # noqa: E402
from repro_torch.fl.engine import build_inputs, host_clock  # noqa: E402
from repro_torch.models import cnn_specs, init_params  # noqa: E402
from repro_torch.optim import paper_lr  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TINY = dataclasses.replace(REDUCED, t_global_rounds=4, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=4, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)


def _pair(pop=None, **kw):
    """Both host planes; ``pop``: ``(size, resample)`` of a population of
    cohorts of 3, each side with its own ``PopulationSpec``."""
    ref_kw, got_kw = dict(kw), dict(kw)
    if pop is not None:
        ref_kw["population"] = JaxSpec(size=pop[0], j_cohort=3,
                                       resample=pop[1])
        got_kw["population"] = PopulationSpec(size=pop[0], j_cohort=3,
                                              resample=pop[1])
    ref = jax_build_inputs(JaxSim(TINY, "hieavg", "temporary", "temporary",
                                  **KW, **ref_kw))
    got = build_inputs(BHFLSimulator(PORT_TINY, "hieavg", "temporary",
                                     "temporary", device="cpu", **KW,
                                     **got_kw))
    return ref, got


@pytest.mark.parametrize("kw", [{}, {"j_per_edge": [3, 2, 3]},
                                {"fail_leader_at": 3},
                                {"pop": (200, "round")},
                                {"pop": (200, "static")},
                                {"pop": (9, "full")}],
                         ids=["tiny", "ragged", "leader_crash", "pop_round",
                              "pop_static", "pop_full"])
def test_build_inputs_is_bitwise_the_reference(kw):
    ref, got = _pair(**kw)
    names = [f.name for f in dataclasses.fields(got)]
    ref_names = [f.name for f in dataclasses.fields(ref)]
    assert [n for n in ref_names if n in names] == names
    for name in names:
        if name == "init_w":
            continue
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert sorted(got.init_w) == sorted(ref.init_w)
    for k, v in ref.init_w.items():
        assert got.init_w[k].shape == v.shape and got.init_w[k].dtype == v.dtype


def test_ragged_and_crash_planes_are_not_trivial():
    """The parametrized cases exercise what they claim: padded slots and a
    crashed leader's edge masked out from the crash round on."""
    _, ragged = _pair(j_per_edge=[3, 2, 3])
    assert not ragged.valid.all() and ragged.has_data[1, 2] == 0
    _, crash = _pair(fail_leader_at=3)
    assert (~crash.edge_masks[2:]).any(axis=0).any()


def test_population_planes_are_not_trivial():
    """The population cases exercise what they claim: churn every round
    under "round" and none under "static", occupants' time scales in the
    latency draws, every slot with data."""
    _, rnd = _pair(pop=(200, "round"))
    _, static = _pair(pop=(200, "static"))
    _, fixed = _pair()
    assert rnd.cohort_change[1:].any() and not rnd.cohort_change[0].any()
    assert not static.cohort_change.any() and not fixed.cohort_change.any()
    assert rnd.has_data.all() and rnd.valid.all()
    assert not np.array_equal(rnd.dev_time, fixed.dev_time)


def test_host_clock_is_bitwise_the_reference_engine_clock():
    """The clock/energy rows computed on the host equal the reference
    engine's device-side float32 rows exactly."""
    from repro.fl.engine import run_engine
    ref, got = _pair(j_per_edge=[3, 2, 3])
    _, _, _, clock, energy = run_engine(ref, kernel_mode="xla")
    c, e = host_clock(got)
    np.testing.assert_array_equal(c, np.asarray(clock))
    np.testing.assert_array_equal(e, np.asarray(energy))


def test_paper_lr_is_bitwise():
    import jax.numpy as jnp
    steps = np.arange(400)
    for eta0, decay in ((1e-3, 0.9), (0.02, 0.3), (0.05, 0.0)):
        a = np.asarray(jax_paper_lr(jnp.arange(400), eta0, decay))
        b = paper_lr(steps, eta0, decay)
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a)


def test_class_images_is_bitwise():
    a = jax_class_images(64, seed=7, hw=8, n_classes=10)
    b = class_images(64, seed=7, hw=8, n_classes=10)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)


def test_init_params_matches_the_reference_distribution():
    """N(0, 1)/sqrt(fan_in) weights and zero biases, seeded."""
    specs = cnn_specs(28, 1, 10, c1=32, c2=64)
    g = torch.Generator()
    g.manual_seed(0)
    w = init_params(specs, g)
    for name, spec in specs.items():
        assert tuple(w[name].shape) == spec.shape
    for name in ("b1", "b2", "b3"):
        assert not w[name].any()
    fan_in = specs["dense"].shape[-2]
    std = float(w["dense"].std()) * np.sqrt(fan_in)
    assert abs(std - 1.0) < 0.01 and abs(float(w["dense"].mean())) < 1e-3
    g2 = torch.Generator()
    g2.manual_seed(0)
    assert torch.equal(init_params(specs, g2)["conv2"], w["conv2"])
