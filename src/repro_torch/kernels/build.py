"""Build, load and launch bookkeeping for the port's CUDA kernels.

The sources in ``csrc/*.cu`` expose plain ``extern "C"`` launchers.  At
first use ``library()`` compiles each source to an object with its own
``nvcc`` process, all started together, links them into one shared
library ``build/libbhfl_kernels-<hash>.so`` at the root of the checkout,
and loads it with ``ctypes``.  The hash covers every source and the flags,
so a changed source rebuilds and an unchanged one is loaded as it is.

Every launcher takes its pointers and the stream as ``void*`` and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.  Each wrapper
adds one to ``LAUNCHES[name]`` where it calls its launcher, and nowhere
else, so a run can show which kernels its main path went through.

``use_kernel`` is the one place that reads ``kernel_mode``:

  * ``"auto"``  — the CUDA kernel for CUDA tensors, the plain PyTorch
                  version for CPU tensors;
  * ``"cuda"``  — the CUDA kernel; CPU tensors raise;
  * ``"torch"`` — the plain PyTorch version on any device.

Nothing catches a failed build or launch and falls back to the plain
version.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

KERNEL_MODES = ("auto", "cuda", "torch")

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``build/`` at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: launcher-call counts per kernel, bumped by the wrappers
LAUNCHES: collections.Counter = collections.Counter()

_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: argtypes of every launcher in csrc/, by symbol
SIGNATURES = {
    # x, w, b, y, D, B*H rows, H, W, Cin, Cout, stream
    "conv3x3_fwd_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w, y, dy, dx (may be null), dw_part, D, B*H rows, H, W, Cin, Cout,
    # rows per partial, stream
    "conv3x3_bwd_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    # host arrays of the leaves' w and g pointers and of their element
    # counts, the number of leaves, the flat output, scale, the row scales
    # (may be null), rows, stream
    "sgd_update_launch": (_P, _P, _P, _I, _P, _F, _P, _L, _P),
    # host arrays of the leaves' (w, prev, dmean) pointers, of their
    # columns and of their first output columns, the number of leaves, the
    # host array of the four coefficient vectors, agg, nprev, ndmean, B, n,
    # history type, stream
    "hieavg_agg_launch": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    # host arrays of the leaves' w pointers (the pair: w and aux of each
    # leaf), of their columns, of their first output columns and of their
    # 16-byte flags, the number of leaves, coef [B, n] (the pair:
    # [B, 2, n]), out, B, n, stream
    "coef_agg_launch": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _P),
    "coef_agg_pair_launch": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _P),
    # feats, wmat, bias, labels, partial logits, count, M, F, C, stream
    "eval_head_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # q, k, v, out, lse (may be null), B, H, Hkv, Sq, Skv, Dh (a built
    # one), the batch, sequence and head strides of q, k and v, causal,
    # window (-1: none), q_offset, scale, dtype code, stream
    "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L,
                               _I, _I, _I, _F, _I, _P),
    # the backward's three kernels.  delta: o, do, delta, B, H, Sq, Dh,
    # dtype code, stream
    "flash_attention_bwd_delta_launch": (_P, _P, _P, _I, _I, _I, _I, _I,
                                         _P),
    # dkdv: q, k, v, do, lse, delta, dk, dv, B, H, Hkv, Sq, Skv, Dh, the
    # strides of q, k and v, causal, window, q_offset, scale, dtype code,
    # stream
    "flash_attention_bwd_dkdv_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I,
                                        _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                        _I, _I, _I, _F, _I, _P),
    # dq: as dkdv with one output, dq
    "flash_attention_bwd_dq_launch": (_P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I,
                                      _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                      _I, _I, _I, _F, _I, _P),
}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def use_kernel(mode: str, t: torch.Tensor) -> bool:
    """True when ``mode`` asks for the CUDA kernel on tensor ``t``."""
    if mode not in KERNEL_MODES:
        raise ValueError(
            f"unknown kernel_mode {mode!r}; expected one of {KERNEL_MODES}")
    if mode == "torch":
        return False
    if t.is_cuda:
        return True
    if mode == "cuda":
        raise ValueError("kernel_mode='cuda' needs CUDA tensors, got a "
                         f"tensor on {t.device}")
    return False


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def compile_library() -> Path:
    """Compile csrc/*.cu into the hashed shared library, unless it exists.
    One nvcc per source, run in parallel, then one link."""
    out = BUILD_DIR / f"libbhfl_kernels-{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, errors = [], []
        for src, obj, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_so, out)          # atomic: concurrent builds agree
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(compile_library()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream() -> int:
    """The current CUDA stream of the current device, as an int: the value
    of ``torch.cuda.current_stream().cuda_stream``, read without building
    a ``Stream`` object, which costs a host-bound wrapper more than the
    rest of its launch.  Inside ``on_device(t)`` that is ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


class on_device:
    """``with on_device(t):`` around a launch makes the card that holds
    ``t`` the current device (a launcher runs on the current one, and
    ``stream()`` reads its stream), and the device before current again
    after.  A tensor on the CPU (index -1) changes nothing.  Each wrapper
    launches inside one, on its first operand, which it has checked to lie
    on the same card as the others."""
    __slots__ = ("index", "prev")

    def __init__(self, t: torch.Tensor):
        self.index = t.get_device()

    def __enter__(self) -> "on_device":
        self.prev = torch.cuda._exchange_device(self.index)
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda._maybe_exchange_device(self.prev)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")


def expect(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32,
           device: Optional[torch.device] = None) -> None:
    """Check what a launcher takes: dtype, shape, contiguity, device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on "
                         f"{device or 'a CUDA device'}, got {t.device}")
