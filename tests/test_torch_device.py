"""Every kernel wrapper launches on the card that holds its tensors.

A launcher runs on the current CUDA device and on the stream it is handed,
so a wrapper that read the current device while its tensors lay on
``cuda:1`` would launch there on the wrong card.  Each wrapper launches
inside ``build.on_device(t)`` on its first operand, which makes that card
the current device for the launch and restores the one before after it;
``build.stream()`` inside reads that card's stream.

No card here: ``torch.cuda``'s device functions and the raw stream reader
are stubs that keep a current device of their own, every tensor reports
the stub's card through ``get_device``, the kernel route is forced on with
a stub library whose launchers record the current device and the stream
they were handed, and the device checks are passed over."""
import importlib

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro_torch.kernels import build
from repro_torch.kernels import coef_agg, conv3x3, hieavg_agg, sgd_update

fa = importlib.import_module("repro_torch.kernels.flash_attention")
eh = importlib.import_module("repro_torch.kernels.eval_head")

#: the card the tensors lie on, and the current device before each call
CARD, HOME = 3, 0


def stream_of(index: int) -> int:
    return 1000 + index


class FakeCuda:
    """The current device of a fake host: ``_exchange_device`` makes an
    index current and returns the one before (-1 changes nothing, as in
    torch), ``_maybe_exchange_device`` sets it back."""

    def __init__(self):
        self.current = HOME
        self.exchanges = []

    def exchange(self, index: int) -> int:
        self.exchanges.append(index)
        if index < 0:
            return -1
        prev, self.current = self.current, index
        return prev

    def maybe_exchange(self, index: int) -> int:
        if index < 0:
            return -1
        prev, self.current = self.current, index
        return prev


class RecordingLibrary:
    """Every ``*_launch`` records (name, current device, its last argument:
    the stream) and returns 0."""

    def __init__(self, cuda: FakeCuda):
        self.cuda, self.calls = cuda, []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launcher(*args):
            self.calls.append((name, self.cuda.current, args[-1]))
            return 0
        return launcher


@pytest.fixture
def card(monkeypatch):
    cuda = FakeCuda()
    lib = RecordingLibrary(cuda)
    monkeypatch.setattr(torch.cuda, "_exchange_device", cuda.exchange)
    monkeypatch.setattr(torch.cuda, "_maybe_exchange_device",
                        cuda.maybe_exchange)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: cuda.current)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", stream_of,
                        raising=False)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: CARD)
    monkeypatch.setattr(build, "use_kernel", lambda mode, t: True)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "expect", lambda *a, **k: None)
    monkeypatch.setattr(fa, "_check_kernel_args", lambda *a: None)
    return lib


def test_on_device_makes_the_tensors_card_current_for_the_block(card):
    """Inside ``on_device(t)`` the current device is ``t``'s card and
    ``stream()`` is that card's stream; after it, the device before."""
    t = torch.zeros(2)
    assert build.stream() == stream_of(HOME)
    with build.on_device(t):
        assert torch.cuda.current_device() == CARD
        assert build.stream() == stream_of(CARD)
    assert torch.cuda.current_device() == HOME
    assert card.cuda.exchanges == [CARD]


def test_on_device_restores_the_device_when_the_launch_raises(card):
    with pytest.raises(RuntimeError, match="cudaError"):
        with build.on_device(torch.zeros(2)):
            build.check(1, "a launch")
    assert torch.cuda.current_device() == HOME


def test_on_device_of_a_cpu_tensor_changes_nothing(monkeypatch):
    """A CPU tensor's index is -1: torch's exchange returns at once, with
    no card to touch (this runs on the real functions of a CPU build)."""
    t = torch.zeros(2)
    assert t.get_device() == -1
    with build.on_device(t) as guard:
        assert guard.prev == -1


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _wrapper_calls():
    """(label, call) for every kernel wrapper, on small CPU tensors."""
    rng = np.random.default_rng(0)
    x = _f32(rng, 2, 1, 6, 6, 3)
    w = _f32(rng, 2, 3, 3, 3, 4)
    b = _f32(rng, 2, 4)
    y = _f32(rng, 2, 1, 6, 6, 4)
    leaves = [_f32(rng, 2, 3, 5), _f32(rng, 2, 3, 7)]
    mask = torch.ones(2, 3)
    coef = _f32(rng, 2, 3)
    q = _f32(rng, 1, 8, 4, 32)
    kv = _f32(rng, 1, 8, 2, 32)
    lse = torch.zeros(1, 4, 8)
    return [
        ("conv3x3_fwd", lambda: conv3x3.conv3x3_fwd(x, w, b)),
        ("conv3x3_bwd", lambda: conv3x3.conv3x3_bwd(x, w, y, y)),
        ("sgd_update", lambda: sgd_update.sgd_update_many(
            leaves, leaves, 0.5)),
        ("hieavg_agg", lambda: hieavg_agg.hieavg_agg_many(
            leaves, leaves, leaves, mask, mask, mask, mask)),
        ("coef_agg", lambda: coef_agg.coef_agg_many(leaves, coef)),
        ("coef_agg_pair", lambda: coef_agg.coef_agg_pair_many(
            leaves, leaves, coef, coef)),
        ("eval_head", lambda: eh.eval_head(
            _f32(rng, 5, 6), _f32(rng, 6, 3), _f32(rng, 3),
            torch.zeros(5, dtype=torch.int32))),
        ("flash_attention", lambda: fa.flash_attention_fwd(q, kv, kv)),
        ("flash_attention_bwd", lambda: fa.flash_attention_bwd(
            q, kv, kv, q, lse, q)),
    ]


@pytest.mark.parametrize("label", [label for label, _ in _wrapper_calls()])
def test_each_wrapper_launches_on_its_tensors_card(card, label):
    """Each wrapper's every launch runs with its tensors' card current and
    that card's stream, and the current device is the one before after
    the call."""
    call = dict(_wrapper_calls())[label]
    call()
    assert card.calls, f"{label}: no launch"
    assert all(dev == CARD and st == stream_of(CARD)
               for _, dev, st in card.calls), card.calls
    assert torch.cuda.current_device() == HOME
