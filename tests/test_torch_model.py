"""The port's CNN and HieAvg against the JAX package's.

* The CNN loss and its gradients at TINY widths against
  ``repro.models.cnn.cnn_loss_fast(kernel_mode="xla")``, the weights carried
  over with ``params_from_numpy``; the max-pool's tie rule; the accuracy.
* ``repro_torch.core.hieavg`` against ``repro.core.hieavg``, with
  ``normalize`` both ways, and the port's kernel route
  (``repro_torch.kernels.ops``, plain versions on the CPU) against its own
  reference path.

Tolerances: loss and HieAvg outputs ``rtol = atol = 1e-5``; gradients
``rtol = 1e-4, atol = 1e-5`` (float32 sums over the batch and 9*Cin in
another order than XLA's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hieavg as jh  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.core import hieavg as th  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (cnn_accuracy, cnn_loss,  # noqa: E402
                                cnn_specs, params_from_numpy)
from repro_torch.models.cnn import _pool_flatten  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_params(hw=8, c1=8, c2=16, seed=0):
    specs = jcnn.cnn_specs(hw, 1, 10, c1=c1, c2=c2)
    params = init_from_specs(specs, jax.random.key(seed))
    # non-zero biases so their gradients and the ReLU masks are exercised
    rng = np.random.default_rng(seed)
    for k in ("b1", "b2", "b3"):
        params[k] = jnp.asarray(
            rng.standard_normal(params[k].shape).astype(np.float32) * 0.1)
    return {k: np.array(v) for k, v in params.items()}


def _batch(n=16, hw=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((n, hw, hw, 1), dtype=np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def test_cnn_specs_match_the_reference():
    a = jcnn.cnn_specs(28, 1, 10, c1=32, c2=64)
    b = cnn_specs(28, 1, 10, c1=32, c2=64)
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}


def test_cnn_loss_and_grads_match_jax():
    params = _jax_params()
    x, y = _batch()
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: jcnn.cnn_loss_fast(p, x, y, kernel_mode="xla"))(params)
    tp = {k: v[None].requires_grad_(True)
          for k, v in params_from_numpy(params).items()}
    loss = cnn_loss(tp, torch.from_numpy(x)[None], torch.from_numpy(y)[None])
    assert loss.shape == (1,)
    np.testing.assert_allclose(float(loss[0].detach()), float(loss_ref),
                               **TOL)
    loss.sum().backward()
    for k in params:
        np.testing.assert_allclose(tp[k].grad[0].numpy(),
                                   np.asarray(g_ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_cnn_loss_per_device_is_independent():
    """Stacked devices get their own losses and their own gradients from
    the gradient of the summed loss."""
    p0, p1 = _jax_params(seed=0), _jax_params(seed=5)
    x, y = _batch()
    both = {k: torch.from_numpy(np.stack([p0[k], p1[k]])).requires_grad_(True)
            for k in p0}
    xs = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    ys = torch.from_numpy(np.stack([y, y[::-1].copy()]))
    loss = cnn_loss(both, xs, ys)
    loss.sum().backward()
    for d, p in enumerate((p0, p1)):
        single = {k: torch.from_numpy(v)[None].requires_grad_(True)
                  for k, v in p.items()}
        ls = cnn_loss(single, xs[d:d + 1], ys[d:d + 1])
        ls.sum().backward()
        torch.testing.assert_close(loss[d], ls[0], rtol=0, atol=0)
        for k in p:
            torch.testing.assert_close(both[k].grad[d], single[k].grad[0],
                                       rtol=1e-6, atol=1e-7)


def test_pool_splits_tied_gradients_like_jax():
    """Tied maxima share the gradient evenly, as JAX's max reduction does
    (``amax``; ``max(dim)`` would send it to one element)."""
    rng = np.random.default_rng(2)
    x = np.round(rng.random((2, 4, 4, 3)) * 2).astype(np.float32)  # ties
    r = rng.standard_normal((2, 2 * 2 * 3)).astype(np.float32)
    g_ref = jax.grad(lambda a: jnp.sum(jcnn._pool_flatten(a) * r))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    (_pool_flatten(tx) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(g_ref))


def test_cnn_accuracy_matches_jax():
    params = _jax_params()
    x, y = _batch(n=64)
    ref = jcnn.cnn_accuracy_fast(params, x, y, kernel_mode="xla")
    got = cnn_accuracy(params_from_numpy(params), torch.from_numpy(x),
                       torch.from_numpy(y))
    assert float(got) == float(ref)


# ----------------------------------------------------------------- hieavg
def _tree(rng, lead):
    return {"a": (rng.standard_normal(lead + (5, 3))).astype(np.float32),
            "b": (rng.standard_normal(lead + (17,))).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close_tree(got, ref):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def _close_hist(got, ref):
    _close_tree(got.prev_w, ref.prev_w)
    _close_tree(got.delta_mean, ref.delta_mean)
    np.testing.assert_array_equal(got.n_obs.numpy(), np.asarray(ref.n_obs))
    np.testing.assert_array_equal(got.miss_count.numpy(),
                                  np.asarray(ref.miss_count))


def _hist_pair(w0, w1, mask, batched):
    init_j = jh.init_history_batched if batched else jh.init_history
    init_t = th.init_history_batched if batched else th.init_history
    upd_j = jh.update_history_batched if batched else jh.update_history
    upd_t = th.update_history_batched if batched else th.update_history
    hj = upd_j(init_j(w0), w1, mask)
    ht = upd_t(init_t(_t(w0)), _t(w1), torch.from_numpy(mask))
    _close_hist(ht, hj)
    return hj, ht


@pytest.mark.parametrize("normalize", [False, True])
def test_global_layer_matches_jax(normalize):
    rng = np.random.default_rng(0)
    n = 4
    w0, w1, w2 = (_tree(rng, (n,)) for _ in range(3))
    hj, ht = _hist_pair(w0, w1, np.asarray([1, 0, 1, 1], bool), False)
    hj = jh.update_history(hj, w2, np.asarray([1, 0, 0, 1], bool))
    ht = th.update_history(ht, _t(w2), torch.tensor([1, 0, 0, 1]).bool())
    _close_hist(ht, hj)
    mask = np.asarray([True, False, True, False])
    j = np.asarray([3.0, 2.0, 4.0, 1.0], np.float32)
    pw = j / j.sum()
    aj, nj = jh.aggregate(w2, mask, hj, pw, jnp.float32(0.9),
                          jnp.float32(0.8), normalize)
    at, nt = th.aggregate(_t(w2), torch.from_numpy(mask), ht,
                          torch.from_numpy(pw), 0.9, 0.8, normalize)
    _close_tree(at, aj)
    _close_hist(nt, nj)
    # the kernel route (plain versions on the CPU) is the reference path
    ot, on = ops.fused_mix_and_update(_t(w2), torch.from_numpy(mask), ht,
                                      torch.from_numpy(pw), 0.9, 0.8,
                                      normalize)
    _close_tree(ot, aj)
    _close_hist(on, nj)


@pytest.mark.parametrize("normalize", [False, True])
def test_edge_layer_batched_matches_jax(normalize):
    """All N edges at once on a ragged layout, garbage in the padded
    slots (zero part weight: they must add nothing)."""
    rng = np.random.default_rng(1)
    lead = (3, 4)
    w0, w1 = _tree(rng, lead), _tree(rng, lead)
    valid = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]], bool)
    for tree in (w0, w1):
        for v in tree.values():
            v[~valid] = 1e3
    hj, ht = _hist_pair(w0, w1, valid, True)
    mask = (rng.random(lead) > 0.4) & valid
    aj, nj = jh.edge_aggregate_batched(w1, mask, hj, valid, jnp.float32(0.9),
                                       jnp.float32(0.8), normalize)
    args = (_t(w1), torch.from_numpy(mask), ht, torch.from_numpy(valid),
            0.9, 0.8, normalize)
    at, nt = th.edge_aggregate_batched(*args)
    _close_tree(at, aj)
    _close_hist(nt, nj)
    ot, on = ops.fused_edge_aggregate_batched(*args)
    _close_tree(ot, aj)
    _close_hist(on, nj)


def test_cold_boot_means_match_jax():
    rng = np.random.default_rng(2)
    w = _tree(rng, (3, 4))
    valid = np.asarray([[1, 1, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1]], bool)
    _close_tree(th.edge_aggregate_cold_batched(_t(w), torch.from_numpy(valid)),
                jh.edge_aggregate_cold_batched(w, valid))
    wg = _tree(rng, (3,))
    j = np.asarray([3.0, 2.0, 4.0], np.float32)
    _close_tree(th.global_aggregate_cold(_t(wg), torch.from_numpy(j)),
                jh.global_aggregate_cold(wg, j))

