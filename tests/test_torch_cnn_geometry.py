"""The paper's experiment at CNN geometries past the conv kernels' old
limits: images wider than 224 pixels, a stage of every channel of a row
past a block's shared memory, weights too wide to stay resident.

The port's plain simulator (the CPU runs the plain versions) with the
reference's initial weights carried over against
``repro.fl.BHFLSimulator(..., kernel_mode="xla").run()`` (its standalone
``vmap`` path) at small versions of the three settings that the card used
to refuse: a 96-pixel image, a 230-pixel one, and wide convs (160 -> 192
channels), each 2 edges x 2 devices, T = 2, one local step an edge round;
within the engine-parity bounds of ``tests/test_engine_parity.py``
(accuracy ``atol 0.02``, loss ``rtol = atol = 1e-3``, delta ``rtol
0.01``), the clock and energy rows equal.  Then the conv wrappers' kernel
route with a stub in place of the built library (each launcher records
what it is handed and returns 0): at W = 256, 4096 input channels and the
second layer at 128 -> 256 channels on 28 x 28, no ``ValueError`` and the
launcher gets the shape.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.fl import BHFLSimulator  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv3x3 import (ROWS_PER_PARTIAL,  # noqa: E402
                                         conv3x3_bias_relu, conv3x3_bwd,
                                         conv3x3_fwd)
from _torch_threads import one_thread  # noqa: E402,F401

ACC_TOL, LOSS_TOL, DELTA_RTOL, DELTA_ATOL = 0.02, 1e-3, 0.01, 1e-4
BASE = dict(t_global_rounds=2, n_edges=2, j_per_edge=2, batch_size=4)
KW = dict(n_train=64, n_test=16, steps_per_epoch=1)
#: the settings' geometry: (image_hw, cnn_c1, cnn_c2); the first two the
#: card's S1 and S3 cut in width, the last S2's channels at TINY's image
GEOMETRIES = {"image_96": (96, 8, 16), "image_230": (230, 4, 8),
              "convs_160_192": (8, 160, 192)}


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def pair(request):
    hw, c1, c2 = GEOMETRIES[request.param]
    geom = dict(BASE, image_hw=hw, cnn_c1=c1, cnn_c2=c2)
    args = ("hieavg", "temporary", "temporary")
    sim = JaxSim(dataclasses.replace(REDUCED, **geom), *args,
                 kernel_mode="xla", **KW)
    w0 = {k: np.asarray(v) for k, v in
          init_from_specs(sim.specs, jax.random.key(sim.seed)).items()}
    ref = sim.run()
    got = BHFLSimulator(dataclasses.replace(PORT_REDUCED, **geom), *args,
                        device="cpu", init_params=w0, **KW).run()
    return ref, got


def test_geometry_run_matches_jax(pair):
    ref, got = pair
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=ACC_TOL)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm,
                               rtol=DELTA_RTOL, atol=DELTA_ATOL)
    assert np.isfinite(got.loss).all()


def test_geometry_clock_and_energy_are_equal(pair):
    ref, got = pair
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    assert got.blocks == ref.blocks


class _StubLibrary:
    """In place of the built library: each launcher records what it was
    handed and returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.fixture
def stub(monkeypatch):
    """The kernel route on CPU tensors: a stub library, and ``expect``
    without its device check."""
    lib = _StubLibrary()

    def host_expect(t, name, shape, dtype=torch.float32, device=None):
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}")
    monkeypatch.setattr(build, "use_kernel", lambda mode, t: True)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(build, "expect", host_expect)
    return lib


#: (D, B, H, W, Cin, Cout): 256 pixels a row (two column segments), 4096
#: input channels (weights streamed; the dW pass's channel windows), and
#: the paper's second layer at 128 -> 256 channels on 28 x 28
STUB_SHAPES = ((1, 2, 3, 256, 2, 4), (1, 1, 3, 3, 4096, 64),
               (2, 2, 28, 28, 128, 256))


@pytest.mark.parametrize("shape", STUB_SHAPES,
                         ids=["w256", "ck4096", "c128_256"])
def test_conv_wrappers_hand_wide_shapes_to_the_launchers(stub, shape):
    d, b, h, w, ci, co = shape
    x = torch.zeros((d, b, h, w, ci))
    wt = torch.zeros((d, 3, 3, ci, co))
    y = conv3x3_fwd(x, wt, torch.zeros((d, co)), "cuda")
    assert y.shape == (d, b, h, w, co)
    dx, dw, db = conv3x3_bwd(x, wt, y.zero_(), torch.zeros_like(y), True,
                             "cuda")
    assert (dx.shape, dw.shape, db.shape) == (x.shape, wt.shape, (d, co))
    (f, fargs), (g, gargs) = stub.calls
    assert f == "conv3x3_fwd_launch"
    assert fargs[4:10] == (d, b * h, h, w, ci, co)
    assert g == "conv3x3_bwd_launch" and gargs[6:13] == (
        d, b * h, h, w, ci, co, ROWS_PER_PARTIAL)


def test_conv_autograd_takes_the_kernel_route_at_wide_shapes(stub):
    """The CNN block's autograd function at 256 pixels a row, 4096 input
    channels and 128 -> 256 channels: one forward and one backward launch
    each, the image's dx skipped only where x needs none."""
    for d, b, h, w, ci, co in STUB_SHAPES:
        x = torch.zeros((d, b, h, w, ci), requires_grad=True)
        wt = torch.zeros((d, 3, 3, ci, co), requires_grad=True)
        bias = torch.zeros((d, co), requires_grad=True)
        conv3x3_bias_relu(x, wt, bias).sum().backward()
    names = [c[0] for c in stub.calls]
    assert names == ["conv3x3_fwd_launch", "conv3x3_bwd_launch"] * 3
    assert all(c[1][4] != 0 for c in stub.calls[1::2])  # dx asked for
