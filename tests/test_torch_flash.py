"""The port's flash attention (``repro_torch.kernels``) against the JAX
package's, on the CPU.

The JAX side runs the Pallas kernel ``flash_attention_1h`` in interpret
mode, as ``tests/test_kernels.py`` runs it, and its GQA front-end
``repro.kernels.ops.flash_attention``; the port's side is the plain
version ``ref.flash_attention_ref`` that its wrapper takes for CPU
tensors.  Inputs are made with numpy from a seed and handed to both.

Tolerances are ``tests/test_kernels.py``'s: float32 ``atol 2e-5``,
bfloat16 ``atol 3e-2``.  A query row that sees no key is 0 in the Pallas
kernel and in the port; the reference's oracle
``repro.kernels.ref.flash_attention_ref`` gives the mean of v there (a
fault of the oracle, pinned below, not fixed).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jatt
from repro.kernels.flash_attention import flash_attention_1h
from repro.kernels.ops import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention as twrapper
from repro_torch.kernels.ref import FLASH_Q_CHUNK, flash_attention_ref
from repro_torch.models import attention as tatt
from _torch_threads import one_thread  # noqa: F401

F32_ATOL = 2e-5      # tests/test_kernels.py, float32 flash cases
BF16_ATOL = 3e-2     # tests/test_kernels.py, bfloat16 flash case


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _one_head(q, k, v, **kw):
    """The port's plain version on one head: [S, D] -> [1, S, 1, D]."""
    out = flash_attention_ref(_t(q)[None, :, None], _t(k)[None, :, None],
                              _t(v)[None, :, None], **kw)
    return out[0, :, 0].numpy()


# the grid of tests/test_kernels.py::test_flash_1h_matches_ref: every
# (Sq, Skv) pair, causal and not, the head dims in turn (the tile tails:
# 300 rows is not a multiple of either side's block)
GRID = [(sq, skv, (64, 80, 128)[i % 3], causal) for i, (sq, skv, causal)
        in enumerate(itertools.product((1, 128, 300, 512), (256, 300, 512),
                                       (True, False)))]


@pytest.mark.parametrize("sq,skv,d,causal", GRID)
def test_plain_matches_pallas_kernel(sq, skv, d, causal):
    if causal and sq > skv:
        sq = skv
    rng = np.random.default_rng(sq * 7 + skv + d)
    q, k, v = _np(rng, sq, d), _np(rng, skv, d), _np(rng, skv, d)
    off = skv - sq if causal else 0
    want = np.asarray(flash_attention_1h(q, k, v, causal=causal,
                                         q_offset=off, interpret=True))
    got = _one_head(q, k, v, causal=causal, q_offset=off)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("window", [32, 100, 256])
def test_plain_sliding_window_matches_pallas_kernel(window):
    rng = np.random.default_rng(window)
    q, k, v = _np(rng, 512, 64), _np(rng, 512, 64), _np(rng, 512, 64)
    want = np.asarray(flash_attention_1h(q, k, v, causal=True, window=window,
                                         interpret=True))
    got = _one_head(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("h,hkv,window,q_offset", [
    (8, 2, None, 0), (8, 2, 100, 0), (4, 4, 64, 0), (8, 2, None, 84)])
def test_gqa_front_end_matches_jax(h, hkv, window, q_offset):
    """``ops.flash_attention`` against the JAX front-end over the Pallas
    kernel, and against ``_sdpa`` with the kernel switched off (the
    reference's chunked path; ``q_offset`` > 0 is a chunked prefill, which
    ``_sdpa`` does not take)."""
    rng = np.random.default_rng(h + hkv)
    sq = 384 - q_offset
    q, k, v = _np(rng, 2, sq, h, 64), _np(rng, 2, 384, hkv, 64), \
        _np(rng, 2, 384, hkv, 64)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                               window=window, q_offset=q_offset).numpy()
    want = np.asarray(jflash(q, k, v, causal=True, window=window,
                             q_offset=q_offset, interpret=True))
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    if q_offset == 0:
        assert not jatt.USE_FLASH_KERNEL
        sdpa = np.asarray(jatt._sdpa(q, k, v, causal=True, window=window))
        np.testing.assert_allclose(got, sdpa, atol=F32_ATOL)


def test_plain_chunks_long_sequences_like_sdpa():
    """More query rows than one chunk of the plain version (and of the
    reference's ``_sdpa``), with the window crossing chunk edges."""
    rng = np.random.default_rng(3)
    s = FLASH_Q_CHUNK + 300
    q, k, v = _np(rng, 1, s, 4, 32), _np(rng, 1, s, 2, 32), \
        _np(rng, 1, s, 2, 32)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                               window=200).numpy()
    want = np.asarray(jatt._sdpa(q, k, v, causal=True, window=200))
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_bf16_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(_np(rng, 1, 256, 4, 64), jnp.bfloat16)
               for _ in range(3))
    want = np.asarray(jatt._sdpa(q, k, v, causal=True, window=None),
                      np.float32)
    tq, tk, tv = (_t(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


def test_rows_that_see_no_key_are_zero_as_in_the_pallas_kernel():
    """q_offset = -10: the first ten rows sit before every key.  The Pallas
    kernel writes 0 there, and so does the port; the reference's oracle
    gives the mean of v (uniform softmax over -2^30), which the port does
    not copy.  The other rows agree with both."""
    rng = np.random.default_rng(0)
    q, k, v = _np(rng, 40, 80), _np(rng, 40, 80), _np(rng, 40, 80)
    kernel = np.asarray(flash_attention_1h(q, k, v, causal=True,
                                           q_offset=-10, interpret=True))
    oracle = np.asarray(jflash_ref(q, k, v, causal=True, q_offset=-10))
    got = _one_head(q, k, v, causal=True, q_offset=-10)
    assert np.all(got[:10] == 0.0) and np.all(kernel[:10] == 0.0)
    np.testing.assert_allclose(oracle[:10], np.broadcast_to(
        v.mean(0), (10, 80)), atol=1e-5)
    assert np.abs(oracle[:10]).max() > 0.1
    np.testing.assert_allclose(got[10:], kernel[10:], atol=F32_ATOL)
    np.testing.assert_allclose(got[10:], oracle[10:], atol=F32_ATOL)


def test_sdpa_routes_full_sequences_to_the_flash_front_end(monkeypatch):
    """``_sdpa`` sends ``sq > 1`` without a bias to ``ops.flash_attention``
    with its kernel mode; a bias (decode) goes to ``_sdpa_block``."""
    calls = []
    real = tops.flash_attention

    def spy(*a, **kw):
        calls.append(kw["mode"])
        return real(*a, **kw)

    monkeypatch.setattr(tatt._ops, "flash_attention", spy)
    rng = np.random.default_rng(1)
    q, k = _t(_np(rng, 1, 20, 4, 32)), _t(_np(rng, 1, 20, 2, 32))
    tatt._sdpa(q, k, k, causal=True, window=8, kernel_mode="torch")
    assert calls == ["torch"]
    bias = torch.zeros((1, 20))
    tatt._sdpa(q[:, :1], k, k, causal=False, bias=bias, kernel_mode="auto")
    assert calls == ["torch"]


def test_wrapper_modes_and_checks():
    """CPU tensors take the plain version under "auto" and "torch"; "cuda"
    raises for them, and the front-end refuses shapes the kernel does not
    take.  No launch is counted."""
    rng = np.random.default_rng(2)
    q, k = _t(_np(rng, 1, 8, 4, 32)), _t(_np(rng, 1, 8, 2, 32))
    build.reset_launch_counts()
    a = twrapper(q, k, k, mode="auto")
    assert torch.equal(a, twrapper(q, k, k, mode="torch"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        twrapper(q, k, k, mode="cuda")
    with pytest.raises(ValueError):
        tops.flash_attention(q, _t(_np(rng, 1, 8, 3, 32)),
                             _t(_np(rng, 1, 8, 3, 32)))
    assert build.LAUNCHES["flash_attention"] == 0
