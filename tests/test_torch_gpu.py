"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present (the ``cuda`` fixture decides, at run time).  The file imports
neither JAX nor the JAX package, so it runs on a machine with a GPU and
PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the GEMMs ``rtol 1e-4`` (float32 sums in another order than
cuBLAS's); the HieAvg mix and the coefficient aggregate ``rtol 1e-5,
atol 1e-6`` (FMA contraction); the SGD update and the correct-counts
exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.coef_agg import coef_agg  # noqa: E402
from repro_torch.kernels.conv3x3 import (matmul_bias_relu_bwd,  # noqa: E402
                                         matmul_bias_relu_fwd)
from repro_torch.kernels.eval_head import eval_head  # noqa: E402
from repro_torch.kernels.hieavg_agg import hieavg_agg  # noqa: E402
from repro_torch.kernels.sgd_update import sgd_update  # noqa: E402

pytestmark = pytest.mark.gpu

L_TAILS = [1, 7, 2047, 2049]


def t(a):
    return torch.from_numpy(np.asarray(a))


def np32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _hieavg_inputs(rng, n, length):
    w, prev = np32(rng, n, length), np32(rng, n, length)
    dmean = np32(rng, n, length, scale=0.1)
    mask = rng.random(n) > 0.4
    cp = rng.random(n).astype(np.float32)
    ce = ((1.0 - cp) * 0.3).astype(np.float32)
    nobs = np.arange(n, dtype=np.float32)
    return w, prev, dmean, mask, cp, ce, nobs


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_gpu_conv_kernels_match_plain(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    for d, m, k, n in ((1, 25, 9, 3), (2, 288, 36, 8), (3, 2049, 288, 64)):
        cols = torch.rand((d, m, k), generator=g, device=cuda)
        w = torch.randn((d, k, n), generator=g, device=cuda) * k ** -0.5
        b = torch.randn((d, n), generator=g, device=cuda) * 0.1
        y = matmul_bias_relu_fwd(cols, w, b, "cuda")
        want = matmul_bias_relu_fwd(cols, w, b, "torch")
        torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)
        dy = torch.randn((d, m, n), generator=g, device=cuda)
        for got, ref in zip(matmul_bias_relu_bwd(cols, w, want, dy, True,
                                                 "cuda"),
                            matmul_bias_relu_bwd(cols, w, want, dy, True,
                                                 "torch")):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_gpu_elementwise_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    for length in L_TAILS:
        w, g = t(np32(rng, 3, length)).to(cuda), t(np32(rng, 3, length)).to(cuda)
        assert torch.equal(sgd_update(w, g, 0.37, "cuda"),
                           sgd_update(w, g, 0.37, "torch"))
        args = [t(a)[None].to(cuda) for a in _hieavg_inputs(rng, 5, length)]
        for got, ref in zip(hieavg_agg(*args, mode="cuda"),
                            hieavg_agg(*args, mode="torch")):
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
        c = t(rng.random((1, 5)).astype(np.float32)).to(cuda)
        torch.testing.assert_close(coef_agg(args[0], c, "cuda"),
                                   coef_agg(args[0], c, "torch"),
                                   rtol=1e-5, atol=1e-6)


def test_gpu_eval_head_matches_plain(cuda):
    rng = np.random.default_rng(1)
    for m in (1, 257, 1000):
        feats = t(rng.random((m, 12544), dtype=np.float32)).to(cuda)
        wmat = t(np32(rng, 12544, 10, scale=0.01)).to(cuda)
        bias = t(np32(rng, 10, scale=0.1)).to(cuda)
        labels = t(rng.integers(-1, 10, m).astype(np.int32)).to(cuda)
        assert int(eval_head(feats, wmat, bias, labels, "cuda")) == \
            int(eval_head(feats, wmat, bias, labels, "torch"))
