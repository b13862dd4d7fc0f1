"""The port's benchmark aggregators (FedAvg, T-FedAvg, D-FedAvg,
delayed-gradient) and the ``coef_agg_pair`` kernel against the JAX
package.

  * ``repro_torch.core.baselines`` against ``repro.core.baselines`` on the
    same numpy inputs, one set of participants and a batch of edges (the
    JAX side ``vmap``-ed, as its engine runs them): ``rtol 1e-5``,
    ``atol 1e-6`` (float32 sums over a few participants).  An all-missing
    ``t_fedavg`` set aggregates to exact zeros on both sides.
  * ``dispatch.fedavg``/``delayed_grad`` and the plain ``coef_agg_pair``
    against ``repro.kernels.dispatch`` with ``mode="interpret"`` and the
    Pallas ``coef_agg_pair(interpret=True)``, at the tile tails of
    ``tests/test_kernel_plane.py``: ``rtol 1e-5``, ``atol 1e-6``; the
    pending store and the ages exactly; zero-coefficient slots bitwise.
  * Whole TINY runs of the port (on the CPU: the plain PyTorch versions)
    against ``repro.fl.BHFLSimulator(..., kernel_mode="xla").run()`` with
    the initial weights carried over, at the bounds of
    ``tests/test_engine_parity.py`` (accuracy ``atol 0.02``, loss ``rtol =
    atol = 1e-3``, delta ``rtol 0.01``), with the clock, the energy, the
    block count and the chain's validity equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.fl.simulator import \
    run_comparison as jax_run_comparison  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels.coef_agg import coef_agg_pair as jax_pair  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.fl import BHFLSimulator, run_comparison  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.kernels.coef_agg import coef_agg_pair  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
L_TAILS = [1, 7, 2047, 2049]

TINY = dataclasses.replace(REDUCED, t_global_rounds=4, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=4, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)
ACC_TOL = 0.02
LOSS_TOL = 1e-3


def t(a):
    return torch.from_numpy(np.array(a))


def np32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got: dict, want, exact=False):
    for k, v in got.items():
        w = np.asarray(want[k])
        if exact:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def _inputs(rng, lead):
    """Two leaves stacked over ``lead`` = (n,) or (N, n), masks with a
    straggler in every set, ages up to 2 and part weights with a padded
    (zero) slot."""
    w = {"a": np32(rng, *lead, 3, 4), "b": np32(rng, *lead, 11)}
    aux = {k: np32(rng, *v.shape) for k, v in w.items()}
    mask = rng.random(lead) > 0.4
    mask[..., 0], mask[..., 1] = True, False
    age = rng.integers(0, 3, lead).astype(np.float32)
    pw = rng.random(lead).astype(np.float32) + 0.5
    pw[..., -1] = 0.0
    return w, aux, mask, age, pw


# ---------------------------------------------------------------- baselines
def _jax_and_port(fn_jax, fn_port, args, batched):
    """The JAX function (vmapped when batched) and the port's on the same
    numpy arguments."""
    jfn = jax.vmap(fn_jax) if batched else fn_jax
    return jfn(*args), fn_port(*[
        {k: t(x) for k, x in a.items()} if isinstance(a, dict) else t(a)
        for a in args])


@pytest.mark.parametrize("lead", [(5,), (3, 5)], ids=["set", "edges"])
def test_baselines_match_jax(lead):
    rng = np.random.default_rng(len(lead))
    w, aux, mask, age, pw = _inputs(rng, lead)
    batched = len(lead) == 2
    want, got = _jax_and_port(jax_baselines.fedavg, baselines.fedavg,
                              (w, pw), batched)
    _close(got, want)
    want, got = _jax_and_port(jax_baselines.t_fedavg, baselines.t_fedavg,
                              (w, mask, pw), batched)
    _close(got, want)
    want, got = _jax_and_port(jax_baselines.d_fedavg, baselines.d_fedavg,
                              (w, mask, aux, pw), batched)
    _close(got[0], want[0])
    _close(got[1], want[1], exact=True)          # the store is a select
    beta, delta = np.float32(0.9), np.float32(2.0)

    def jdg(w_, m_, p_, a_, pw_):
        return jax_baselines.delayed_grad(w_, m_, p_, a_, beta, delta, pw_)

    def tdg(w_, m_, p_, a_, pw_):
        return baselines.delayed_grad(w_, m_, p_, a_, float(beta),
                                      float(delta), pw_)

    want, got = _jax_and_port(jdg, tdg, (w, mask, aux, age, pw), batched)
    _close(got[0], want[0])
    _close(got[1], want[1], exact=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_baselines_without_part_weights_and_all_missing_set():
    """Uniform part weights when none are given; a t_fedavg set with no
    one present aggregates to exact zeros, as the reference does."""
    rng = np.random.default_rng(3)
    w, aux, mask, age, _ = _inputs(rng, (4,))
    tw = {k: t(v) for k, v in w.items()}
    _close(baselines.fedavg(tw), jax_baselines.fedavg(w))
    _close(baselines.t_fedavg(tw, t(mask)), jax_baselines.t_fedavg(w, mask))
    got = baselines.t_fedavg(tw, torch.zeros(4, dtype=torch.bool))
    want = jax_baselines.t_fedavg(w, np.zeros(4, bool))
    for k, v in got.items():
        assert not v.any()
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    got = baselines.d_fedavg(tw, t(mask), {k: t(v) for k, v in aux.items()})
    _close(got[0], jax_baselines.d_fedavg(w, mask, aux)[0])
    got = baselines.delayed_grad(tw, t(mask), {k: t(v) for k, v in
                                               aux.items()}, t(age), 0.9, 1.0)
    _close(got[0], jax_baselines.delayed_grad(w, mask, aux, age,
                                              np.float32(0.9),
                                              np.float32(1.0))[0])


# ------------------------------------------------------- the pair kernel
@pytest.mark.kernel_oracle
@pytest.mark.parametrize("length", L_TAILS)
def test_coef_agg_pair_matches_pallas(length):
    rng = np.random.default_rng(length)
    n = 5
    w, aux = np32(rng, n, length), np32(rng, n, length)
    ca = rng.random(n).astype(np.float32)
    cb = (rng.random(n) * (ca < 0.5)).astype(np.float32)
    want = jax_pair(w, aux, ca, cb, interpret=True)
    got = coef_agg_pair(t(w)[None], t(aux)[None], t(ca)[None], t(cb)[None])
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, length)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.kernel_oracle
def test_coef_agg_pair_zero_coefficient_slots_are_exact_noops():
    """A slot whose coefficient is zero adds exactly nothing, bitwise,
    whatever it holds (1e6 here), on both sides."""
    rng = np.random.default_rng(5)
    w, aux = np32(rng, 5, 500), np32(rng, 5, 500)
    ca = np.array([0.5, 0.0, 0.2, 0.0, 0.0], np.float32)
    cb = np.array([0.0, 0.3, 0.0, 0.0, 0.0], np.float32)
    junk_w, junk_aux = w.copy(), aux.copy()
    junk_w[[1, 3, 4]] = 1e6
    junk_aux[[0, 2, 3, 4]] = 1e6
    for fn in (lambda a, b: np.asarray(jax_pair(a, b, ca, cb,
                                                interpret=True)),
               lambda a, b: coef_agg_pair(t(a)[None], t(b)[None],
                                          t(ca)[None], t(cb)[None]).numpy()):
        np.testing.assert_array_equal(fn(w, aux), fn(junk_w, junk_aux))


@pytest.mark.kernel_oracle
@pytest.mark.parametrize("length", L_TAILS)
def test_dispatch_fedavg_and_delayed_grad_match_interpret(length):
    """``dispatch.fedavg``/``delayed_grad`` (one set and a batch of edges)
    against the reference's kernel-routed entries run through the Pallas
    interpreter (vmapped over the edges as its engine does)."""
    rng = np.random.default_rng(length + 1)
    for lead in ((5,), (3, 5)):
        w = {"p": np32(rng, *lead, length), "q": np32(rng, *lead, 2, 3)}
        pending = {k: v * 0.9 + 0.05 for k, v in w.items()}
        mask = rng.random(lead) > 0.5
        age = rng.integers(0, 5, lead).astype(np.float32)
        pw = rng.random(lead).astype(np.float32)
        pw[..., -1] = 0.0
        beta, delta = np.float32(0.5), np.float32(3.0)
        tw = {k: t(v) for k, v in w.items()}
        tp = {k: t(v) for k, v in pending.items()}

        def jfed(w_, pw_):
            return jax_dispatch.fedavg(w_, pw_, mode="interpret")

        def jdg(w_, m_, p_, a_, pw_):
            return jax_dispatch.delayed_grad(w_, m_, p_, a_, beta, delta,
                                             pw_, mode="interpret")

        if len(lead) == 2:
            jfed, jdg = jax.vmap(jfed), jax.vmap(jdg)
        _close(dispatch.fedavg(tw, t(pw)), jfed(w, pw))
        got = dispatch.delayed_grad(tw, t(mask), tp, t(age), float(beta),
                                    float(delta), t(pw))
        want = jdg(w, mask, pending, age, pw)
        _close(got[0], want[0])
        _close(got[1], want[1], exact=True)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_dispatch_entries_run_the_pair_and_coef_kernels_on_cuda_tensors(
        monkeypatch):
    """With the kernel route forced, ``fedavg`` reaches ``coef_agg`` and
    ``delayed_grad`` reaches ``coef_agg_pair``: one launch per aggregate
    over every leaf, with the shapes, dtypes and contiguity the launchers
    take."""
    seen = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: seen.append(name) or 0

    monkeypatch.setattr(build, "use_kernel", lambda mode, x: True)
    monkeypatch.setattr(build, "library", lambda: Lib())
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(build, "expect", lambda *a, **k: None)
    build.reset_launch_counts()
    w = {"p": torch.ones(3, 4, 6), "q": torch.ones(3, 4, 2, 5)}
    m = torch.tensor([[True, False, True, True]] * 3)
    pw = torch.ones(3, 4)
    out = dispatch.fedavg(w, pw)
    assert {k: tuple(v.shape) for k, v in out.items()} == \
        {"p": (3, 6), "q": (3, 2, 5)}
    dispatch.delayed_grad(w, m, w, torch.zeros(3, 4), 0.9, 1.0, pw)
    assert seen == ["coef_agg_launch", "coef_agg_pair_launch"]
    assert build.LAUNCHES == {"coef_agg": 1, "coef_agg_pair": 1}
    build.reset_launch_counts()


# -------------------------------------------------------------- whole runs
#: name -> aggregator, straggler kind, setting overrides, simulator kwargs
CASES = {
    "t_fedavg": dict(agg="t_fedavg", strag="temporary", s={}, kw={}),
    "d_fedavg": dict(agg="d_fedavg", strag="temporary", s={}, kw={}),
    "delayed_grad": dict(agg="delayed_grad", strag="temporary", s={},
                         kw={}),
    "fedavg": dict(agg="fedavg", strag="none", s={}, kw={}),
    "delayed_grad_permanent_ragged": dict(
        agg="delayed_grad", strag="permanent",
        s=dict(permanent_stop_round=1), kw=dict(j_per_edge=[3, 2, 3])),
    # the paper's eq. (4) over many warm rounds (TINY's four rounds hold
    # two) on the DEFAULT topology of 5 edges of 5 devices, with permanent
    # stragglers from round 6, so the estimates extrapolate for ten rounds
    "hieavg_permanent_long": dict(
        agg="hieavg", strag="permanent",
        s=dict(t_global_rounds=16, n_edges=5, j_per_edge=5,
               permanent_stop_round=6),
        kw=dict(n_train=1000, n_test=200, steps_per_epoch=3)),
}


def _settings(name):
    s = CASES[name]["s"]
    return (dataclasses.replace(TINY, **s),
            dataclasses.replace(PORT_TINY, **s))


def carried_weights(sim):
    """The JAX simulator's initial model as numpy, for ``init_params``."""
    return {k: np.asarray(v) for k, v in
            init_from_specs(sim.specs, jax.random.key(sim.seed)).items()}


def assert_runs_agree(got, ref):
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=ACC_TOL)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm, rtol=0.01,
                               atol=1e-4)
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    assert got.blocks == ref.blocks
    assert got.chain_valid == ref.chain_valid is True
    assert got.sim_latency == ref.sim_latency


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    case = CASES[request.param]
    s_jax, s_port = _settings(request.param)
    args = (case["agg"], case["strag"], case["strag"])
    kw = {**KW, **case["kw"]}
    sim = JaxSim(s_jax, *args, kernel_mode="xla", **kw)
    w0 = carried_weights(sim)
    ref = sim.run()
    got = BHFLSimulator(s_port, *args, device="cpu", init_params=w0,
                        **kw).run()
    return ref, got


def test_run_matches_jax(pair):
    ref, got = pair
    assert_runs_agree(got, ref)


def test_aggregators_differ_under_stragglers():
    """The cases above exercise different code: with the same stragglers,
    the four aggregators give four different trajectories."""
    w0 = carried_weights(JaxSim(TINY, **KW))
    losses = [BHFLSimulator(PORT_TINY, agg, device="cpu", init_params=w0,
                            **KW).run().loss
              for agg in ("hieavg", "t_fedavg", "d_fedavg", "delayed_grad")]
    for i in range(len(losses)):
        for j in range(i):
            assert not np.array_equal(losses[i], losses[j])


def test_run_comparison_matches_jax():
    """The Fig. 2 set: FedAvg without stragglers, then each aggregator."""
    ref = jax_run_comparison(TINY, kinds=("t_fedavg",), kernel_mode="xla",
                             **KW)
    w0 = carried_weights(JaxSim(TINY, **KW))
    got = run_comparison(PORT_TINY, kinds=("t_fedavg",), device="cpu",
                         init_params=w0, **KW)
    assert list(got) == list(ref) == ["wo_stragglers", "t_fedavg"]
    for k in got:
        assert_runs_agree(got[k], ref[k])
