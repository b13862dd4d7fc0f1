"""The port's latency K* solvers and convergence bound against the JAX
package's.

  * The dense K axis (``k_axis``, ``total_latency_k``, ``edge_window_k``,
    ``omega_bound_k``) and the masked-argmin ``optimize_k_masked``, with
    the parameters as tensors of a grid's batch shape, against
    ``jax.vmap`` of the reference's ``jnp`` functions over the same
    float32 values: ``rtol 1e-6`` (float32 products in the same order),
    +inf where the reference has it, ``k_star`` and the feasibility masks
    equal.
  * The host float64 forms (``optimize_k``, ``omega_bound``,
    ``BoundParams.from_trace``, the Shannon-rate helpers) equal to the
    reference's, and ``optimize_k``'s ``ValueError``s as
    ``tests/test_latency_fabric.py`` pins them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import convergence as jconv  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro_torch.core import (BoundParams, KOptResult,  # noqa: E402
                              LatencyParams, comm_latency, compute_latency,
                              edge_window_k, k_axis, omega_bound,
                              omega_bound_k, optimize_k, optimize_k_masked,
                              shannon_rate, total_latency_k)
from _torch_threads import one_thread  # noqa: E402,F401

RTOL = 1e-6
K_MAX = 64
G = 12                      # grid points of a batched solve

#: LatencyParams fields batched over the grid, and their ranges
LAT_FIELDS = {"lm_device": (0.05, 2.5), "lp_device": (0.3, 4.0),
              "lm_edge": (0.01, 0.5)}
#: BoundParams fields batched over the grid (eta down to where the
#: denominator is <= 0 for small K, so +inf appears)
BOUND_FIELDS = {"L": (2.0, 20.0), "eta": (0.02, 0.3), "gamma0": (0.5, 1.0),
                "s_frac": (0.0, 0.6), "j_ratio": (0.05, 0.5),
                "f_gap": (0.5, 4.0)}


def _grid(rng, fields):
    return {k: rng.uniform(lo, hi, G).astype(np.float32)
            for k, (lo, hi) in fields.items()}


def _close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def _lat_ref(vals: dict, T, N, J, k_max):
    def one(lm, lp, le):
        p = dataclasses.replace(jlat.LatencyParams(T=T, N=N, J=J),
                                lm_device=lm, lp_device=lp, lm_edge=le)
        return jlat.total_latency_k(p, k_max), jlat.edge_window_k(p, k_max)
    return jax.vmap(one)(vals["lm_device"], vals["lp_device"],
                         vals["lm_edge"])


def _lat_port(vals: dict, T, N, J):
    return dataclasses.replace(
        LatencyParams(T=T, N=N, J=J),
        **{k: torch.from_numpy(v) for k, v in vals.items()})


def _bound_ref(vals: dict, T, k_max):
    def one(*xs):
        p = dataclasses.replace(jconv.BoundParams(T=T),
                                **dict(zip(BOUND_FIELDS, xs)))
        return jconv.omega_bound_k(p, k_max)
    return jax.vmap(one)(*(vals[k] for k in BOUND_FIELDS))


def _bound_port(vals: dict, T):
    return dataclasses.replace(
        BoundParams(T=T), **{k: torch.from_numpy(v) for k, v in vals.items()})


# ------------------------------------------------------------ dense K axis
@pytest.mark.parametrize("k_max", [1, 7, K_MAX])
def test_k_axis_matches_jax(k_max):
    _close(k_axis(k_max), jlat.k_axis(k_max), rtol=0)


@pytest.mark.parametrize("T,N,J", [(50, 5, 5), (3, 2, 8), (100, 8, 3)])
def test_latency_k_batched_matches_jax_vmap(T, N, J):
    vals = _grid(np.random.default_rng(T + N + J), LAT_FIELDS)
    lat_ref, win_ref = _lat_ref(vals, T, N, J, K_MAX)
    p = _lat_port(vals, T, N, J)
    _close(total_latency_k(p, K_MAX), lat_ref)
    _close(edge_window_k(p, K_MAX), win_ref)


def test_latency_k_scalar_params_match_jax():
    for p in (LatencyParams(), LatencyParams(T=7, N=3, J=4, lm_device=0.2)):
        jp = jlat.LatencyParams(**{f.name: getattr(p, f.name)
                                   for f in dataclasses.fields(p)})
        _close(total_latency_k(p, K_MAX), jlat.total_latency_k(jp, K_MAX))
        _close(edge_window_k(p, K_MAX), jlat.edge_window_k(jp, K_MAX))


@pytest.mark.parametrize("T", [10, 50])
def test_omega_bound_k_batched_matches_jax_vmap(T):
    vals = _grid(np.random.default_rng(T), BOUND_FIELDS)
    ref = np.asarray(_bound_ref(vals, T, K_MAX))
    assert np.isinf(ref).any() and np.isfinite(ref).any()
    _close(omega_bound_k(_bound_port(vals, T), K_MAX), ref)


def test_omega_bound_k_scalar_params_match_jax():
    for p in (BoundParams(), BoundParams(eta=0.05), BoundParams(L=3.0)):
        jp = jconv.BoundParams(**dataclasses.asdict(p))
        _close(omega_bound_k(p, K_MAX), jconv.omega_bound_k(jp, K_MAX))


@pytest.mark.parametrize("omega_bar,cons", [(25.0, 3.0), (8.0, 0.5),
                                            (1e-3, 0.0), (25.0, 1e4)],
                         ids=["paper", "tight", "no_omega", "no_window"])
def test_optimize_k_masked_batched_matches_jax_vmap(omega_bar, cons):
    """A grid of K* solves in one call: latency params, bound params and
    per-point omega_bar / consensus latency batched together."""
    rng = np.random.default_rng(7)
    lv, bv = _grid(rng, LAT_FIELDS), _grid(rng, BOUND_FIELDS)
    bars = (omega_bar * rng.uniform(0.5, 1.5, G)).astype(np.float32)
    conss = (cons * rng.uniform(0.5, 1.5, G)).astype(np.float32)
    lat_ref, win_ref = _lat_ref(lv, 50, 5, 5, K_MAX)
    om_ref = _bound_ref(bv, 50, K_MAX)
    k_ref, l_ref, f_ref = jax.vmap(jlat.optimize_k_masked)(
        lat_ref, om_ref, win_ref, bars, conss)
    p = _lat_port(lv, 50, 5, 5)
    k, l, f = optimize_k_masked(
        total_latency_k(p, K_MAX), omega_bound_k(_bound_port(bv, 50), K_MAX),
        edge_window_k(p, K_MAX), torch.from_numpy(bars),
        torch.from_numpy(conss))
    assert k.dtype == torch.int32 and k.shape == (G,)
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))
    _close(l, l_ref)


def test_optimize_k_masked_scalar_matches_jax_and_host():
    lp, bp = LatencyParams(), BoundParams()
    k, l, f = optimize_k_masked(total_latency_k(lp, 32),
                                omega_bound_k(bp, 32),
                                edge_window_k(lp, 32), 25.0, 3.0)
    jlp, jbp = jlat.LatencyParams(), jconv.BoundParams()
    kr, lr, fr = jlat.optimize_k_masked(
        jlat.total_latency_k(jlp, 32), jconv.omega_bound_k(jbp, 32),
        jlat.edge_window_k(jlp, 32), 25.0, 3.0)
    assert int(k) == int(kr)
    np.testing.assert_array_equal(f.numpy(), np.asarray(fr))
    _close(l, lr)
    host = optimize_k(lp, lambda kk: omega_bound(kk, bp), 25.0, 3.0, 32)
    assert int(k) == host.k_star
    np.testing.assert_allclose(float(l), host.latency, rtol=RTOL)


def test_optimize_k_masked_infeasible_is_minus_one_and_inf():
    lp, bp = LatencyParams(), BoundParams()
    k, l, f = optimize_k_masked(total_latency_k(lp, 8), omega_bound_k(bp, 8),
                                edge_window_k(lp, 8), 1e-6, 1e6)
    assert int(k) == -1 and float(l) == float("inf") and not f.any()


# ------------------------------------------------------ host float64 forms
@pytest.mark.parametrize("bp_kw", [{}, {"eta": 0.05}, {"L": 3.0, "T": 20},
                                   {"s_frac": 0.6, "gamma0": 1.0}])
def test_omega_bound_equals_jax(bp_kw):
    bp, jbp = BoundParams(**bp_kw), jconv.BoundParams(**bp_kw)
    for K in range(1, K_MAX + 1):
        assert omega_bound(K, bp) == jconv.omega_bound(K, jbp)


@pytest.mark.parametrize("omega_bar,cons,k_max", [
    (25.0, 3.0, 64), (25.0, 0.5, 32), (8.0, 12.0, 64), (1e-3, 0.5, 16)],
    ids=["paper", "small_window", "tight", "infeasible"])
def test_optimize_k_equals_jax(omega_bar, cons, k_max):
    lp, bp = LatencyParams(lm_device=0.3), BoundParams()
    jlp, jbp = jlat.LatencyParams(lm_device=0.3), jconv.BoundParams()
    got = optimize_k(lp, lambda k: omega_bound(k, bp), omega_bar, cons,
                     k_max)
    ref = jlat.optimize_k(jlp, lambda k: jconv.omega_bound(k, jbp),
                          omega_bar, cons, k_max)
    if ref is None:
        assert got is None
        return
    assert isinstance(got, KOptResult)
    assert (got.k_star, got.latency) == (ref.k_star, ref.latency)
    for f in ("feasible", "latencies", "omegas"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


def test_bound_params_from_trace_equals_jax():
    rng = np.random.default_rng(3)
    trace = dict(losses=rng.uniform(0.5, 2.5, 9),
                 grad_norms=rng.uniform(0.1, 1.0, 9),
                 weight_deltas=rng.uniform(0.01, 0.2, 9),
                 eta=0.1, gamma0=0.9, s_frac=0.2, j_ratio=0.2, T=30)
    got = BoundParams.from_trace(**trace)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconv.BoundParams.from_trace(**trace))
    short = dict(trace, losses=[1.0], grad_norms=[0.5], weight_deltas=[])
    assert dataclasses.asdict(BoundParams.from_trace(**short)) == \
        dataclasses.asdict(jconv.BoundParams.from_trace(**short))


def test_link_helpers_equal_jax():
    assert shannon_rate(1e6, 0.2, 1e-3, 1e-4) == \
        jlat.shannon_rate(1e6, 0.2, 1e-3, 1e-4)
    assert comm_latency(5e5, 2e6) == jlat.comm_latency(5e5, 2e6)
    assert compute_latency(3e9, 1.5e9) == jlat.compute_latency(3e9, 1.5e9)


# ---------------------------------------------------- input validation
def test_optimize_k_rejects_bad_k_max():
    lp, bp = LatencyParams(), BoundParams()
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError, match="k_max"):
            optimize_k(lp, lambda k: omega_bound(k, bp), omega_bar=25.0,
                       consensus_latency=0.5, k_max=bad)


def test_optimize_k_rejects_non_finite_inputs():
    lp, bp = LatencyParams(), BoundParams()
    for bad in (float("inf"), float("nan")):
        with pytest.raises(ValueError, match="omega_bar"):
            optimize_k(lp, lambda k: omega_bound(k, bp), omega_bar=bad,
                       consensus_latency=0.5)
        with pytest.raises(ValueError, match="consensus_latency"):
            optimize_k(lp, lambda k: omega_bound(k, bp), omega_bar=25.0,
                       consensus_latency=bad)
    with pytest.raises(ValueError, match="consensus_latency"):
        optimize_k(lp, lambda k: omega_bound(k, bp), omega_bar=25.0,
                   consensus_latency=-1.0)


def test_quickstart_k_star_solve():
    """``examples/quickstart.py``'s solve: K* under the paper's defaults
    with the chain's consensus latency, on both packages."""
    from repro_torch.core import make_chain
    from repro.core import make_chain as jmake_chain
    lat_c = make_chain("raft", 5, seed=0).consensus_latency()
    assert lat_c == jmake_chain("raft", 5, seed=0).consensus_latency()
    got = optimize_k(LatencyParams(),
                     lambda k: omega_bound(k, BoundParams()), 25.0, lat_c)
    ref = jlat.optimize_k(jlat.LatencyParams(),
                          lambda k: jconv.omega_bound(k, jconv.BoundParams()),
                          25.0, lat_c)
    assert (got.k_star, got.latency) == (ref.k_star, ref.latency)
    assert jnp.isfinite(ref.latency)
