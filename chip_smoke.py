#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--full]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds every kernel against its plain PyTorch version on the card (at the
paper's DEFAULT shapes and at tile-tail shapes; the conv kernels at
every shape of the main path, the backward with and without dx, timed
beside a grouped ``conv2d`` and the im2col GEMM; ``hieavg_agg`` also with
bfloat16 and float8_e4m3fn history; ``sgd_update`` as one launch over
the CNN's six leaves; ``flash_attention`` over a grid of lengths, head
dims, masks and GQA groups in float32 and bfloat16, at unit-scale and at
sharp logits, and at the serving shape of h2o-danube-1.8b in bfloat16
and float32, after a line that names the kernel each input type launched
and its HGMMA count) and times both.  Then it runs the
paper's experiment at the full width of its CNN (DEFAULT cut to T = 4:
5 SGD steps per edge round, 2 cold-boot and 2 warm global rounds) under
every single-run aggregator: ``hieavg`` (float32, bfloat16 and float8
history) and ``t_fedavg``, ``d_fedavg``, ``delayed_grad`` with temporary
stragglers, ``fedavg`` without.  Each runs once with the kernels
(``kernel_mode="auto"``) and once with the plain versions (``"torch"``),
and the two must agree.  Last, ``run_checkpointed(every=2)`` is cut
after its first chunk and resumed from a fresh simulator: the result
must be bitwise the uninterrupted checkpointed run's.  Last, the LLM
serving path: ``repro_torch.launch.serve.run`` on h2o-danube-1.8b at full
width (24 layers, bfloat16, batch 2, a prompt of 8192 tokens, twice the
sliding window, 32 greedy tokens), with the flash kernel and with its
plain version on the same seeded weights, and the parity of the two,
layer by layer (see ``serve_parity``).

Output, one line each: the card as ``nvidia-smi`` names it, then JSON
objects: the build, one per kernel check (with ``flash_design`` before
the flash line), one per run (each HieAvg-path run launches
``sgd_update`` once per local step), one parity line
per configuration, the resume checks, one per serve run, the serve
parity, the ``kernels`` summary, and last ``{"ok": true, "device":
{...}}``.  ``--profile`` adds one more HieAvg run under ``torch.profiler``
and a line of device time per kernel; ``--full`` adds the paper's whole
DEFAULT HieAvg run (T = 50) per mode, its Fig. 2 set (``run_comparison``
under temporary and permanent stragglers, with HieAvg's eq. (4) as
written and normalized), and a serve run with a prompt of 32768 tokens.
Any failed phase raises and exits non-zero; without a CUDA device it
exits 2 and prints nothing on stdout.  Imports nothing of JAX or of the
JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks: HBM3 bandwidth, dense FP32 and bf16
# tensor-core rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

# the paper's DEFAULT widths: D = 5 x 5 devices, B = 32, 28x28, c1 = 32,
# c2 = 64, 10 classes, n_test = 1000
D, B, HW, C1, C2, NCLS, NTEST = 25, 32, 28, 32, 64, 10, 1000
FEAT = (HW // 2) ** 2 * C2
#: the conv kernels' check shapes (D, B, H, W, Cin, Cout): the main path's
#: (train and eval, layers 2 and 1; the first is timed) and tails of the
#: tiling: one tile, tails, odd channels, a non-square image, channels
#: across the 4-channel chunk and 8-channel group edges
CONV_SHAPES = ((D, B, HW, HW, C1, C2), (D, B, HW, HW, 1, C1),
               (1, NTEST, HW, HW, 1, C1), (1, NTEST, HW, HW, C1, C2),
               (1, 1, 5, 5, 1, 3), (2, 2, 12, 12, 4, 8), (1, 2, 16, 16, 3, 7),
               (1, 3, 7, 9, 5, 6), (1, 2, 10, 10, 33, 65))

REPLACES = {
    "conv3x3_fwd": "src/repro/kernels/conv3x3.py:83",
    "conv3x3_bwd": "src/repro/kernels/conv3x3.py:105",
    "sgd_update": "src/repro/kernels/sgd_update.py:40",
    "hieavg_agg": "src/repro/kernels/hieavg_agg.py:60",
    "coef_agg": "src/repro/kernels/coef_agg.py:62",
    "coef_agg_pair": "src/repro/kernels/coef_agg.py:88",
    "eval_head": "src/repro/kernels/eval_head.py:48",
    "flash_attention": "src/repro/kernels/flash_attention.py:77",
}
SOURCE = {
    "conv3x3_fwd": "src/repro_torch/kernels/csrc/conv3x3.cu",
    "conv3x3_bwd": "src/repro_torch/kernels/csrc/conv3x3.cu",
    "sgd_update": "src/repro_torch/kernels/csrc/sgd_update.cu",
    "hieavg_agg": "src/repro_torch/kernels/csrc/hieavg_agg.cu",
    "coef_agg": "src/repro_torch/kernels/csrc/coef_agg.cu",
    "coef_agg_pair": "src/repro_torch/kernels/csrc/coef_agg.cu",
    "eval_head": "src/repro_torch/kernels/csrc/eval_head.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}

# engine-parity tolerances of tests/test_engine_parity.py
ACC_TOL, LOSS_TOL, DELTA_RTOL, DELTA_ATOL = 0.02, 1e-3, 0.01, 1e-4

#: the runs at DEFAULT width, T = 4: label -> (aggregator, stragglers at
#: both layers, history dtype name or None)
RUNS = {
    "hieavg": ("hieavg", "temporary", None),
    "t_fedavg": ("t_fedavg", "temporary", None),
    "d_fedavg": ("d_fedavg", "temporary", None),
    "delayed_grad": ("delayed_grad", "temporary", None),
    "fedavg": ("fedavg", "none", None),
    "hieavg_bf16": ("hieavg", "temporary", "bfloat16"),
    "hieavg_f8": ("hieavg", "temporary", "float8_e4m3fn"),
}
#: kernels every run launches, and those only some runs do
EVERY_RUN = ("conv3x3_fwd", "conv3x3_bwd", "sgd_update", "eval_head")
RUN_KERNELS = {"hieavg": ("hieavg_agg", "coef_agg"),
               "delayed_grad": ("coef_agg_pair",),
               "fedavg": ("coef_agg",),
               "hieavg_bf16": ("hieavg_agg", "coef_agg"),
               "hieavg_f8": ("hieavg_agg", "coef_agg")}
#: the run whose launches the ``kernels`` line reports, where not "hieavg"
LAUNCHES_FROM = {"coef_agg_pair": "delayed_grad"}
#: the configurations whose checkpointed run is cut and resumed
RESUMED = ("delayed_grad", "hieavg_bf16")
ROWS = ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy")

#: the serve cell: h2o-danube-1.8b at full width, batch 2, a prompt of
#: twice its sliding window, 32 greedy tokens; ``--full`` adds a prompt of
#: PREFILL_32K's length at batch 1
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = \
    "h2o-danube-1.8b", 2, 8192, 32
SERVE_LONG_PROMPT = 32768
#: auto-vs-torch bound on each layer's output and on the logits, relative
#: to their largest magnitude: 4 bfloat16 ulps at the top binade.  The two
#: flash versions differ by one ulp in a few elements; the layer's bf16
#: products after attention (wo, the MLP) carry that to a few ulps of the
#: layer's largest value.  The layers are compared fed the same input: the
#: random-weight model is chaotic, so free-running outputs diverge
#: (PERF.md, section 6).
SERVE_REL_TOL = 2.0 ** -5
#: the flash kernel's check grid: query and kv lengths (the serving
#: prompt's kv length among them), head dims, windows, (H, Hkv)
FLASH_SQ, FLASH_SKV = (1, 300, 512), (256, 300, 8192)
FLASH_DH, FLASH_WINDOWS = (32, 64, 80, 128), (None, 100, 4096)
FLASH_HEADS = ((2, 2), (8, 2))
#: sharp attention: (Sq, Skv, Dh, causal, window, q scale); q scaled up so
#: that logits reach the hundreds, as in the serving model's random
#: weights, where the order of the float32 sums decides the output
FLASH_SHARP = ((300, 8192, 80, True, 4096, 24.0), (129, 129, 128, False, None,
                                                   24.0),
               (512, 1000, 32, True, 256, 24.0), (300, 300, 64, True, 100,
                                                  60.0))
#: the reference's float32 flash bound (tests/test_kernels.py)
FLASH_F32_ATOL = 2e-5

#: mantissa bits and least normal exponent of the narrow history dtypes
NARROW = {"bfloat16": (7, -126), "float8_e4m3fn": (3, -6)}
#: float32 values at the edges of float8_e4m3fn: the largest finite value
#: 448, the round-to-448 midpoint 464, what lies past it (NaN, as JAX casts),
#: infinities, NaN, and the subnormals and their rounding midpoints
F8_EDGES = (448.0, -448.0, 450.0, 464.0, -464.0, 464.01, -464.01, 465.0,
            480.0, 1e30, float("inf"), float("-inf"), float("nan"), 1.0,
            0.0, 2.0 ** -6, 2.0 ** -9, -2.0 ** -9, 2.0 ** -10,
            3 * 2.0 ** -11, 2.0 ** -11, 1.5 * 2.0 ** -9, 7 * 2.0 ** -10)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the FLOPs' time at
    ``flop_rate``, the card's peak for the inputs' type."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def timed_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, symbols, iters: int = 20):
    """Device time per call of ``fn`` spent in the kernels whose names hold
    one of ``symbols``, read from ``torch.profiler``: the kernels' own time,
    without the host's launch cost that ``timed_ms`` includes.  None when
    the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if str(ev.device_type) == "DeviceType.CUDA"
             and any(sym in ev.key for sym in symbols))
    return us / 1e3 / iters if us > 0 else None


def check(name: str, ok: bool, detail: str) -> None:
    if not ok:
        raise AssertionError(f"{name}: {detail}")


#: device-side kernel names -> the port's kernels (the rest is PyTorch's)
KERNEL_SYMBOLS = (("conv3x3_fwd_kernel", "conv3x3_fwd"),
                  ("conv3x3_dx_kernel", "conv3x3_bwd dx"),
                  ("conv3x3_dw_kernel", "conv3x3_bwd dW/db"),
                  ("sgd_update_kernel", "sgd_update"),
                  ("hieavg_agg_kernel", "hieavg_agg"),
                  ("coef_agg_kernel", "coef_agg"),
                  ("coef_agg_pair_kernel", "coef_agg_pair"),
                  ("eval_head_kernel", "eval_head"),
                  ("flash_attention_kernel", "flash_attention"),
                  ("flash_attention_wgmma_kernel", "flash_attention"))


def symbols_of(kernel: str) -> tuple:
    return tuple(k for k, v in KERNEL_SYMBOLS
                 if v == kernel or v.startswith(kernel + " "))


def profile_run(torch, fn) -> dict:
    """``fn()`` (one more ``kernel_mode="auto"`` run) under
    ``torch.profiler``: device time per kernel (the port's by name,
    PyTorch's own summed per name) and the device's busy share of the run's
    wall time.  Only with ``--profile``; the profiler's host overhead
    lengthens the wall time, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name: dict = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us <= 0 or str(ev.device_type) != "DeviceType.CUDA":
            continue
        name = next((v for k, v in KERNEL_SYMBOLS if k in ev.key),
                    "torch: " + ev.key[:60])
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + ev.count, t + us / 1e3)
    busy = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3),
            "kernels": [{"name": k, "count": n, "device_ms": t}
                        for k, (n, t) in top]}


def full_runs(torch, simulator, setting) -> dict:
    """The paper's whole DEFAULT run (T = 50 global rounds) once per kernel
    mode, in turns (auto, torch, auto, torch): wall seconds, rounds per
    second and the final accuracy.  Only with ``--full``."""
    out: dict = {"t_global_rounds": setting.t_global_rounds}
    for mode in ("auto", "torch", "auto", "torch"):
        sim = simulator(setting, "hieavg", "temporary", "temporary",
                        device="cuda", kernel_mode=mode)
        torch.cuda.synchronize()
        res = sim.run()
        torch.cuda.synchronize()
        out.setdefault(mode, []).append({
            "wall_s": res.wall_time,
            "rounds_per_s": setting.t_global_rounds / res.wall_time,
            "final_accuracy": float(res.accuracy[-1]),
            "final_loss": float(res.loss[-1]),
            "final_clock_s": float(res.sim_clock[-1])})
    return out


def fig2_runs(run_comparison, setting) -> dict:
    """The paper's Fig. 2 set at DEFAULT (T = 50), ``kernel_mode="auto"``:
    ``run_comparison`` (FedAvg without stragglers, HieAvg, T-FedAvg,
    D-FedAvg) under temporary and permanent stragglers, with HieAvg's
    eq. (4) as the paper writes it (``normalize=False``, the simulator's
    default) and normalized (``normalize=True``, as the reference's own
    Fig. 2 driver ``benchmarks/fig2_convergence.py`` runs it).  Wall
    seconds, final and best accuracy per run.  Only with ``--full``."""
    out: dict = {"t_global_rounds": setting.t_global_rounds}
    for normalize in (False, True):
        for kind in ("temporary", "permanent"):
            res = run_comparison(setting, straggler_kind=kind, device="cuda",
                                 kernel_mode="auto", normalize=normalize)
            key = f"{kind}_normalized" if normalize else kind
            out[key] = {name: {"wall_s": r.wall_time,
                               "final_accuracy": float(r.accuracy[-1]),
                               "best_accuracy": float(r.accuracy.max()),
                               "final_loss": float(r.loss[-1])}
                        for name, r in res.items()}
    return out


def bf16_ulps(got, want, atol: float = 0.0) -> float:
    """max (|got - want| - atol) in bfloat16 ulps at the larger magnitude of
    the two (ulp 2^(e - 7) for a value in [2^e, 2^(e+1)))."""
    import torch
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() - atol).clamp(min=0.0).div(ulp).max().item())


def flash_pairs(sq: int, skv: int, causal: bool, window, q_offset=0) -> int:
    """(query, key) pairs the masks keep, per head: the work this call's
    data needs (the kernel skips whole tiles outside them)."""
    pairs = 0
    for i in range(sq):
        qpos = q_offset + i
        hi = min(skv, qpos + 1) if causal else skv
        lo = max(0, qpos - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    return pairs


def kernel_key(name: str) -> str:
    """``flash_attention_wgmma_kernel<80>`` from a mangled
    (``..._kernelILi80E...``) or a demangled (``..._kernel<80, ...>``)
    kernel name: its name and first template argument."""
    m = re.search(r"([a-z_]+_kernel)(?:ILi|<)(\d+)", name)
    return f"{m.group(1)}<{m.group(2)}>" if m else name


def hgmma_counts(library: Path) -> dict:
    """HGMMA (wgmma) instructions per kernel in the built library's SASS,
    by ``cuobjdump -sass``: which kernels run on the tensor cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = kernel_key(line.split("Function : ")[1].strip())
            counts.setdefault(fn, 0)
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def flash_designs(torch, flash_attention, designs, randn, library) -> dict:
    """Which kernel each input type launched, read from the profiler's
    kernel names, beside its design and its HGMMA count: bfloat16 must run
    the wgmma kernel at Dh 80 (the serving head dim), float32 the FMA one
    with no HGMMA."""
    from torch.profiler import ProfilerActivity, profile
    hgmma = hgmma_counts(library)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (randn(1, 256, 2, 80).to(dtype) for _ in range(3))
        flash_attention(q, k, v, causal=True, mode="cuda")   # warm-up
        names = []
        for calls in (3, 20):   # a short window may record no kernel
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    flash_attention(q, k, v, causal=True, mode="cuda")
                torch.cuda.synchronize()
            names = sorted({kernel_key(ev.key) for ev in prof.key_averages()
                            if "flash_attention" in ev.key})
            if names:
                break
        count = sum(hgmma.get(name, 0) for name in names)
        out[str(dtype).split(".")[-1]] = {"design": designs[dtype],
                                          "kernels": names, "hgmma": count}
    check("flash_attention", out["bfloat16"]["kernels"]
          == ["flash_attention_wgmma_kernel<80>"]
          and out["bfloat16"]["hgmma"] > 0
          and out["float32"]["kernels"] == ["flash_attention_kernel<80>"]
          and out["float32"]["hgmma"] == 0, f"designs launched: {out}")
    out["hgmma_per_kernel"] = {f: n for f, n in hgmma.items() if n}
    emit({"flash_design": out})
    return out


def flash_phase(torch, cfg, flash_attention, randn, record) -> dict:
    """The flash kernel against its plain version: a grid of Sq x Skv x Dh
    x masks x GQA groups in float32 (atol 2e-5, the reference's bound) and
    bfloat16 (one ulp beyond that bound: both versions sum in float32,
    which may differ by 2e-5 where a sum cancels to near 0, and round once),
    q read through strides and a chunked prefill's ``q_offset``, and the
    same bounds at sharp attention (``FLASH_SHARP``); rows that see no key
    exactly 0; then the serving shape of h2o-danube-1.8b, checked and
    timed."""
    worst = {"float32_abs": 0.0, "bfloat16_ulp": 0.0, "cases": 0}
    grid = [(sq, skv, dh, causal, window, hh, 1.0, dtype)
            for sq, skv, dh, causal, window, hh, dtype in itertools.product(
                FLASH_SQ, FLASH_SKV, FLASH_DH, (True, False), FLASH_WINDOWS,
                FLASH_HEADS, (torch.float32, torch.bfloat16))]
    grid += [(sq, skv, dh, causal, window, (8, 2), qs, dtype)
             for sq, skv, dh, causal, window, qs in FLASH_SHARP
             for dtype in (torch.float32, torch.bfloat16)]
    for sq, skv, dh, causal, window, (h, hkv), qs, dtype in grid:
        q = randn(2, sq, 2 * h, dh, scale=qs).to(dtype)[:, :, :h]  # strided
        k, v = (randn(2, skv, hkv, dh).to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window,
                  q_offset=skv - sq if causal and skv > sq else 0)
        got = flash_attention(q, k, v, mode="cuda", **kw)
        want = flash_attention(q, k, v, mode="torch", **kw)
        case = f"{(sq, skv, dh, causal, window, h, hkv, qs, dtype)}"
        if dtype == torch.float32:
            err = (got - want).abs().max().item()
            check("flash_attention", err <= FLASH_F32_ATOL, f"{case}: {err}")
            worst["float32_abs"] = max(worst["float32_abs"], err)
        else:
            u = bf16_ulps(got, want, FLASH_F32_ATOL)
            check("flash_attention", u <= 1.0, f"{case}: {u} ulp")
            worst["bfloat16_ulp"] = max(worst["bfloat16_ulp"], u)
        worst["cases"] += 1
    for dtype, off in itertools.product((torch.float32, torch.bfloat16),
                                        (-10, -100)):
        q, k, v = (randn(1, 300, 4, 80).to(dtype) for _ in range(3))
        got = flash_attention(q, k, v, causal=True, q_offset=off, mode="cuda")
        want = flash_attention(q, k, v, causal=True, q_offset=off,
                               mode="torch")
        n = -off
        check("flash_attention", bool((got[:, :n] == 0).all())
              and bool((want[:, :n] == 0).all()),
              f"rows that see no key are not 0 (q_offset {off})")
        worst["cases"] += 1

    # the serving shape: the prefill of ``cfg`` (h2o-danube-1.8b), bf16
    b, s, h, hkv, dh, win = SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, \
        cfg.n_kv_heads, cfg.resolved_head_dim, cfg.sliding_window
    q = randn(b, s, h, dh).to(torch.bfloat16)
    k, v = (randn(b, s, hkv, dh).to(torch.bfloat16) for _ in range(2))
    got = flash_attention(q, k, v, causal=True, window=win, mode="cuda")
    want = flash_attention(q, k, v, causal=True, window=win, mode="torch")
    u = bf16_ulps(got, want, FLASH_F32_ATOL)
    check("flash_attention", u <= 1.0, f"serving shape: {u} ulp")
    qpos = torch.arange(s, device=q.device)
    mask = (qpos[None, :] <= qpos[:, None]) & \
        (qpos[None, :] > qpos[:, None] - win)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err = (library().transpose(1, 2).float() - want.float()).abs().max()
    flops = 4.0 * dh * b * h * flash_pairs(s, s, True, win)
    record("flash_attention", (got.float() - want.float()).abs().max().item(),
           2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7),
           lambda: flash_attention(q, k, v, causal=True, window=win,
                                   mode="cuda"),
           timed_ms(torch, lambda: flash_attention(
               q, k, v, causal=True, window=win, mode="torch"), iters=5),
           timed_ms(torch, library, iters=5),
           2.0 * (2 * b * s * h * dh + 2 * b * s * hkv * dh), flops,
           {"shape": {"q": [b, s, h, dh], "kv": [b, s, hkv, dh],
                      "dtype": "bfloat16", "causal": True, "window": win},
            "max_ulp_beyond_atol": u, "max_ulp": bf16_ulps(got, want),
            "tolerance": f"1 bf16 ulp beyond atol {FLASH_F32_ATOL}",
            "flops": flops, "bound_flop_rate": BF16_TC_FLOP_PER_S,
            "bound_fp32_ms": flops / FP32_FLOP_PER_S * 1e3,
            "bound_qk_bf16_pv_fp32_ms": flops / 2 / BF16_TC_FLOP_PER_S * 1e3
            + flops / 2 / FP32_FLOP_PER_S * 1e3,
            "library_call": "scaled_dot_product_attention(attn_mask=causal "
                            "& window, enable_gqa=True)",
            "library_max_abs_diff": float(lib_err), "grid": worst},
           flop_rate=BF16_TC_FLOP_PER_S)

    # the float32 instantiation (off the serving path) at the same shape,
    # against its FP32 bound and the library call on float32 inputs
    q, k, v = (t_.float() for t_ in (q, k, v))
    got = flash_attention(q, k, v, causal=True, window=win, mode="cuda")
    want = flash_attention(q, k, v, causal=True, window=win, mode="torch")
    err = (got - want).abs().max().item()
    check("flash_attention", err <= FLASH_F32_ATOL,
          f"float32 serving shape: {err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    del got, want
    record("flash_attention_f32", err, FLASH_F32_ATOL,
           lambda: flash_attention(q, k, v, causal=True, window=win,
                                   mode="cuda"),
           timed_ms(torch, lambda: flash_attention(
               q, k, v, causal=True, window=win, mode="torch"), iters=5),
           timed_ms(torch, library, iters=5),
           4.0 * (2 * b * s * h * dh + 2 * b * s * hkv * dh), flops,
           {"shape": {"q": [b, s, h, dh], "kv": [b, s, hkv, dh],
                      "dtype": "float32", "causal": True, "window": win},
            "library_call": "scaled_dot_product_attention(attn_mask=causal "
                            "& window, enable_gqa=True), float32"},
           kernel="flash_attention")
    return worst


def serve_runs(torch, serve, build, n_layers: int) -> dict:
    """``serve.run`` at full width with the kernels and with the plain
    versions, on the same seeded weights, each decoding its own greedy
    tokens: the launch counts are set to 0 just before each run and read
    just after.  A short run first takes the first-call costs."""
    kw = dict(smoke=False, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              gen=SERVE_GEN, device="cuda", progress=False)
    serve.run(SERVE_ARCH, **{**kw, "prompt_len": 512, "gen": 2})
    runs = {}
    for mode in ("auto", "torch"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        res = serve.run(SERVE_ARCH, kernel_mode=mode, **kw)
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check("serve", res["tokens"].shape == (SERVE_BATCH, SERVE_GEN)
              and bool(np.isfinite(res["logits"]).all()),
              f"{mode}: tokens {res['tokens'].shape}, logits not finite")
        runs[mode] = (res, launches)
        emit({"serve": {
            "arch": SERVE_ARCH, "kernel_mode": mode, "layers": n_layers,
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
            "prefill_s": res["t_prefill"], "decode_s": res["t_decode"],
            "decode_tokens_per_s": SERVE_GEN * SERVE_BATCH / res["t_decode"],
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT
            / res["t_prefill"],
            "peak_memory_gb": peak / 1e9, "launches": launches}})
    check("launches", runs["auto"][1].get("flash_attention", 0) == n_layers,
          f"auto: {runs['auto'][1]}, expected {n_layers} flash launches")
    check("launches", not runs["torch"][1],
          f"torch mode launched {runs['torch'][1]}")
    return runs


def serve_parity(torch, serve, runs) -> dict:
    """Auto against torch on the same inputs.  Every layer of the prefill
    is fed the auto run's input in both modes (the kernel's one-ulp
    differences would otherwise flip the sharp attention of random weights
    and the runs diverge).  Per layer, the attention output itself (before
    ``wo`` and the residual) within one bf16 ulp beyond ``FLASH_F32_ATOL``
    times the layer's largest ``|v|``: the flash phase's bound, scaled as
    the float32 error of a convex combination of v's rows scales; the
    kernel on the model's own activations.  The layer's output and the
    last position's logits of the two last layers within ``SERVE_REL_TOL``
    of their largest magnitude.  Then torch mode's
    decode from its caches of that pass, fed the auto run's tokens, against
    the auto run's decode logits: decode launches no kernel and the caches
    hold k and v from before attention, so this checks only that the
    decode is deterministic.  The free-running runs' own differences and
    greedy-token agreement are reported, not checked."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_tokens
    from repro_torch.launch import make_serve_step
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed_apply, rms_norm, \
        unembed_apply

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    cfg = get_config(SERVE_ARCH)
    dev = torch.device("cuda")
    auto = {k: torch.as_tensor(v, device=dev)
            for k, v in runs["auto"][0].items() if k in ("tokens", "logits")}
    params = serve.make_params(cfg, 0, dev)
    prompts = torch.as_tensor(lm_tokens(SERVE_BATCH, SERVE_PROMPT, cfg.vocab,
                                        seed=0), device=dev).long()
    caches = {m: serve.make_caches(cfg, SERVE_BATCH,
                                   SERVE_PROMPT + SERVE_GEN, dev, smoke=False)
              for m in ("auto", "torch")}
    x = embed_apply(params["embed"], prompts, cfg.torch_param_dtype)
    pos = torch.arange(SERVE_PROMPT, device=dev)
    layers, attn_ulp, attn_rel = [], [], []
    for u in range(cfg.n_units):
        up = T._index(params["unit"], u)
        mp = up["0"]["mixer"]
        q, k, v = A._qkv(mp, rms_norm(x, mp["norm"], cfg.norm_eps), cfg)
        q, k = (A.apply_rope(t, pos, cfg.rope_theta) for t in (q, k))
        a = {m: A._sdpa(q, k, v, causal=True, window=cfg.sliding_window,
                        kernel_mode=m) for m in ("auto", "torch")}
        attn_ulp.append(bf16_ulps(a["auto"], a["torch"], FLASH_F32_ATOL
                                  * v.float().abs().max().item()))
        attn_rel.append(rel(a["auto"], a["torch"]))
        del q, k, v, a
        y = {m: T._apply_layer("attn", up["0"], x, cfg, mode="prefill",
                               cache=T._index(c["unit"], u)["0"], pos=None,
                               kernel_mode=m) for m, c in caches.items()}
        layers.append(rel(y["torch"], y["auto"]))
        x = y["auto"]
    logits = {m: unembed_apply(params["embed"], y[m][:, -1:], cfg)[:, 0]
              for m in y}
    decode = make_serve_step(cfg)
    c, steps = caches["torch"], []
    for i in range(SERVE_GEN - 1):
        lg, c = decode(params, auto["tokens"][:, i:i + 1].long(),
                       SERVE_PROMPT + i, c)
        steps.append(lg.float())
    torch_run = runs["torch"][0]
    out = {
        "tolerance_rel": SERVE_REL_TOL,
        "attn_tolerance": f"1 bf16 ulp beyond atol {FLASH_F32_ATOL} "
                          "x max|v|",
        "attn_ulp": attn_ulp, "attn_rel": attn_rel,
        "layer_rel": layers,
        "prefill_logits_rel": rel(logits["torch"], logits["auto"]),
        "forced_auto_vs_run_rel": rel(logits["auto"], auto["logits"][:, 0]),
        "decode_logits_rel": rel(torch.stack(steps, 1),
                                 auto["logits"][:, 1:]),
        "free_running": {
            "prefill_logits_max_abs_diff": float(np.abs(
                torch_run["logits"][:, 0] - runs["auto"][0]["logits"][:, 0]
            ).max()),
            "decode_logits_max_abs_diff": float(np.abs(
                torch_run["logits"][:, 1:] - runs["auto"][0]["logits"][:, 1:]
            ).max()),
            "max_abs_logit": float(np.abs(runs["auto"][0]["logits"]).max()),
            "greedy_token_agreement": float(np.mean(
                torch_run["tokens"] == runs["auto"][0]["tokens"]))}}
    emit({"serve_parity": out})
    bad = {k: out[k] for k in ("prefill_logits_rel", "forced_auto_vs_run_rel",
                               "decode_logits_rel")
           if out[k] > SERVE_REL_TOL}
    worst_layer = max(layers)
    check("serve_parity", not bad and worst_layer <= SERVE_REL_TOL,
          f"over {SERVE_REL_TOL}: {bad}, worst layer {worst_layer}")
    check("serve_parity", max(attn_ulp) <= 1.0,
          f"attention output over 1 bf16 ulp: {attn_ulp}")
    return out


def resume_check(np_run, make_sim) -> dict:
    """``run_checkpointed(every=2)`` run through, then run again, its last
    step file deleted and resumed from a fresh simulator: the resumed
    result must be bitwise the uninterrupted one, and close to ``run()``
    (``np_run``; the same operations in the same order, rtol 1e-5).  The
    checkpoints go to ``build/`` in the checkout and are removed."""
    base = ROOT / "build" / "smoke_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    try:
        full = make_sim().run_checkpointed(str(base / "a"), every=2)
        make_sim().run_checkpointed(str(base / "b"), every=2)
        last = max((base / "b").glob("step_*.npz"))
        last.unlink()
        last.with_suffix(".json").unlink()
        resumed = make_sim().run_checkpointed(str(base / "b"), every=2)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    bitwise = all(np.array_equal(getattr(resumed, r), getattr(full, r))
                  for r in ROWS) and resumed.blocks == full.blocks
    close = all(np.allclose(getattr(full, r), getattr(np_run, r), rtol=1e-5,
                            atol=1e-6) for r in ROWS)
    return {"deleted": last.name, "resumed_bitwise": bitwise,
            "close_to_run": close,
            "max_abs_diff_to_run": {r: float(np.abs(getattr(full, r)
                                                    - getattr(np_run, r))
                                             .max()) for r in ROWS}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import DEFAULT, get_config
    from repro_torch.core.hieavg import to_history_dtype
    from repro_torch.fl import BHFLSimulator, run_comparison
    from repro_torch.kernels import build
    from repro_torch.kernels.coef_agg import coef_agg, coef_agg_pair
    from repro_torch.kernels.conv3x3 import conv3x3_bwd, conv3x3_fwd
    from repro_torch.kernels.eval_head import eval_head
    from repro_torch.kernels.flash_attention import DESIGNS as FLASH_DESIGNS
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hieavg_agg import hieavg_agg
    from repro_torch.kernels.ref import im2col3x3
    from repro_torch.kernels.sgd_update import sgd_update, sgd_update_many
    from repro_torch.launch import serve
    from repro_torch.models import cnn_specs
    from repro_torch.models.spec import count_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t0 = time.time()
    build.library()
    emit({"build": {"seconds": time.time() - t0,
                    "library": build.compile_library().name,
                    "flags": " ".join(build.NVCC_FLAGS)}})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    results = {}

    def record(name, err, tol, fn, plain_ms, library_ms, nbytes, flops,
               extra=None, kernel=None, flop_rate=FP32_FLOP_PER_S):
        """``fn`` launches the kernel (``kernel``, default ``name``) at the
        timed shape: ``ms`` is its wall time per call through the wrapper
        (CUDA events), ``device_ms`` its kernels' own device time
        (profiler).  The bound counts ``flops`` at ``flop_rate``."""
        bms, by = bound_ms(nbytes, flops, flop_rate)
        line = {"kernel": name, "max_abs_err": err, "tolerance": tol,
                "ms": timed_ms(torch, fn),
                "device_ms": device_ms(torch, fn, symbols_of(kernel or name)),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bms, "bound_by": by, **(extra or {})}
        emit(line)
        results[name] = line

    def gemm_err(got, want, rel=1e-4):
        """max |got - want| and its tolerance rel * max|want| (FP32 sums in
        another order than cuBLAS's)."""
        err = (got - want).abs().max().item()
        return err, rel * max(want.abs().max().item(), 1e-30)

    # ------------------------------------------------- conv3x3_fwd and _bwd
    # every shape the main path gives the kernels (train and eval, both
    # layers) and the tiling's tails, the backward with and without dx;
    # layer 2 at the train shape is timed
    worst_f = worst_b = 0.0
    for shape in CONV_SHAPES:
        d, b_, h, wd, ci, co = shape
        x, w = rand(d, b_, h, wd, ci), randn(d, 3, 3, ci, co,
                                             scale=(9 * ci) ** -0.5)
        b = randn(d, co, scale=0.1)
        want = conv3x3_fwd(x, w, b, "torch")
        err, tol = gemm_err(conv3x3_fwd(x, w, b, "cuda"), want)
        check("conv3x3_fwd", err <= tol, f"{shape}: {err} > {tol}")
        worst_f = max(worst_f, err / max(tol, 1e-30))
        dy = randn(d, b_, h, wd, co)
        for need in (True, False):
            got = conv3x3_bwd(x, w, want, dy, need, "cuda")
            for g_, w_ in zip(got, conv3x3_bwd(x, w, want, dy, need,
                                               "torch")):
                if w_ is None:
                    check("conv3x3_bwd", g_ is None, "dx where none asked")
                    continue
                err, tol = gemm_err(g_, w_)
                check("conv3x3_bwd", err <= tol,
                      f"{shape} need_dx={need}: {err} > {tol}")
                worst_b = max(worst_b, err / max(tol, 1e-30))
        del x, w, b, want, dy, got
    d, b_, h, wd, ci, co = CONV_SHAPES[0]
    m = b_ * h * wd
    x, w = rand(d, b_, h, wd, ci), randn(d, 3, 3, ci, co,
                                         scale=(9 * ci) ** -0.5)
    b = randn(d, co, scale=0.1)
    y = conv3x3_fwd(x, w, b, "torch")
    dy = randn(d, b_, h, wd, co)
    # the yardsticks: one grouped conv2d over the D devices (NCHW, TF32
    # off), its convolution_backward given dz, and the im2col GEMM on
    # patches built beforehand
    xn = x.permute(1, 0, 4, 2, 3).reshape(b_, d * ci, h, wd).contiguous()
    wn = w.permute(0, 4, 3, 1, 2).reshape(d * co, ci, 3, 3).contiguous()
    bn = b.reshape(-1)
    dzn = (dy * (y > 0)).permute(1, 0, 4, 2, 3).reshape(
        b_, d * co, h, wd).contiguous()
    cols = im2col3x3(x).reshape(d, m, 9 * ci)
    wmat = w.reshape(d, 9 * ci, co)

    def lib_fwd():
        return torch.nn.functional.conv2d(xn, wn, bn, padding=1, groups=d)

    def lib_bwd():
        return torch.ops.aten.convolution_backward(
            dzn, xn, wn, [d * co], [1, 1], [1, 1], [1, 1], False, [0, 0], d,
            [True, True, True])

    lib_diff = (torch.relu(lib_fwd()).reshape(b_, d, co, h, wd)
                .permute(1, 0, 3, 4, 2) - y).abs().max().item()
    err, tol = gemm_err(conv3x3_fwd(x, w, b, "cuda"), y)
    flops = 2.0 * d * m * 9 * ci * co
    record("conv3x3_fwd", err, tol, lambda: conv3x3_fwd(x, w, b, "cuda"),
           timed_ms(torch, lambda: conv3x3_fwd(x, w, b, "torch")),
           timed_ms(torch, lib_fwd),
           4.0 * (d * m * ci + d * 9 * ci * co + d * co + d * m * co), flops,
           {"shape": [d, b_, h, wd, ci, co], "worst_err_over_tol": worst_f,
            "library_call": "conv2d(groups=D), no ReLU",
            "library_max_abs_diff": lib_diff,
            "library_cols_ms": timed_ms(torch, lambda: torch.baddbmm(
                b[:, None, :], cols, wmat)),
            "library_cols_call": "baddbmm on im2col patches built before"})
    del cols, wmat
    got = conv3x3_bwd(x, w, y, dy, True, "cuda")
    errs = [gemm_err(g_, w_) for g_, w_ in
            zip(got, conv3x3_bwd(x, w, y, dy, True, "torch"))]
    check("conv3x3_bwd", all(e <= t_ for e, t_ in errs), f"{errs}")
    record("conv3x3_bwd", max(e for e, _ in errs), max(t_ for _, t_ in errs),
           lambda: conv3x3_bwd(x, w, y, dy, True, "cuda"),
           timed_ms(torch, lambda: conv3x3_bwd(x, w, y, dy, True, "torch")),
           timed_ms(torch, lib_bwd),
           4.0 * (2 * d * m * ci + 2 * d * 9 * ci * co + 2 * d * m * co
                  + d * co), 2 * flops + d * m * co,
           {"shape": [d, b_, h, wd, ci, co], "worst_err_over_tol": worst_b,
            "library_call": "convolution_backward of conv2d(groups=D), "
                            "given dz",
            "library_cols_ms": None,
            "bitwise_on_repeat": all(torch.equal(a_, b2) for a_, b2 in zip(
                got, conv3x3_bwd(x, w, y, dy, True, "cuda")))})
    del x, w, b, y, dy, got, xn, wn, bn, dzn

    # ------------------------------------------------ the model's leaves
    specs = cnn_specs(HW, 1, NCLS, c1=C1, c2=C2)
    P = count_params(specs)
    leaf_sizes = [math.prod(s.shape) for s in specs.values()]

    # ----------------------------------------------------------- sgd_update
    # one launch per local step over every leaf: bitwise the plain version
    # per leaf, scale 0 an exact identity, one launch counted per call
    ws = [randn(D, L) for L in leaf_sizes]
    gs = [randn(D, L) for L in leaf_sizes]
    s = 0.00095238
    err = 0.0
    for L in (1, 7, 2047, 2049):
        w1, g1 = randn(3, L), randn(3, L)
        e = (sgd_update(w1, g1, s, "cuda")
             - sgd_update(w1, g1, s, "torch")).abs().max().item()
        err = max(err, e)
        check("sgd_update", torch.equal(sgd_update(w1, g1 * 1e3, 0.0, "cuda"),
                                        w1), "scale 0 is not an identity")
    before = build.LAUNCHES["sgd_update"]
    got = sgd_update_many(ws, gs, s, "cuda")
    check("sgd_update", build.LAUNCHES["sgd_update"] == before + 1,
          f"{len(ws)} leaves took {build.LAUNCHES['sgd_update'] - before} "
          "launches")
    for g_, w_ in zip(got, sgd_update_many(ws, gs, s, "torch")):
        err = max(err, (g_ - w_).abs().max().item())
    check("sgd_update", err == 0.0, f"not bitwise the plain version: {err}")
    check("sgd_update", all(torch.equal(a, w_) for a, w_ in zip(
        sgd_update_many(ws, [g * 1e3 for g in gs], 0.0, "cuda"), ws)),
        "scale 0 is not an identity")
    record("sgd_update", err, 0.0,
           lambda: sgd_update_many(ws, gs, s, "cuda"),
           timed_ms(torch, lambda: sgd_update_many(ws, gs, s, "torch")),
           timed_ms(torch, lambda: torch._foreach_add(ws, gs, alpha=-s)),
           12.0 * D * P, 2.0 * D * P,
           {"shape": [D, P], "leaves": len(ws), "launches_per_call": 1})
    del ws, gs, got

    # ----------------------------------------------------------- hieavg_agg
    def hieavg_inputs(nb, n, L):
        mask = rand(nb, n) > 0.3
        coef = rand(nb, n)
        return (randn(nb, n, L), randn(nb, n, L), randn(nb, n, L, scale=0.1),
                mask, coef * mask, coef * ~mask,
                torch.floor(rand(nb, n) * 6))

    def agg_err(got, want):
        err = max((g_ - w_).abs().max().item() for g_, w_ in zip(got, want))
        tol = 1e-5 * max(w_.abs().max().item() for w_ in want)
        return err, tol

    nb, n = 5, 5                                  # N = 5 edges of J = 5
    err, tol = 0.0, 0.0
    for (nb2, n2, L) in ((1, 3, 1), (2, 5, 7), (5, 5, 2047), (1, 5, 2049)):
        args = hieavg_inputs(nb2, n2, L)
        e, t = agg_err(hieavg_agg(*args, mode="cuda"),
                       hieavg_agg(*args, mode="torch"))
        check("hieavg_agg", e <= t, f"{(nb2, n2, L)}: {e} > {t}")
    leaves = [hieavg_inputs(nb, n, L) for L in leaf_sizes]
    for args in leaves:
        e, t = agg_err(hieavg_agg(*args, mode="cuda"),
                       hieavg_agg(*args, mode="torch"))
        check("hieavg_agg", e <= t, f"DEFAULT leaf: {e} > {t}")
        err, tol = max(err, e), max(tol, t)
    # a zero-coefficient slot adds exactly nothing, whatever it holds
    a = hieavg_inputs(1, 4, 999)
    junk = [x.clone() for x in a[:3]]
    for x in junk:
        x[:, 3] = 1e6
    cp, ce = a[4].clone(), a[5].clone()
    cp[:, 3] = ce[:, 3] = 0.0
    check("hieavg_agg", torch.equal(
        hieavg_agg(*a[:3], a[3], cp, ce, a[6], mode="cuda")[0],
        hieavg_agg(*junk, a[3], cp, ce, a[6], mode="cuda")[0]),
        "a zero-coefficient slot changed the aggregate")
    record("hieavg_agg", err, tol,
           lambda: [hieavg_agg(*x, mode="cuda") for x in leaves],
           timed_ms(torch, lambda: [hieavg_agg(*x, mode="torch")
                                    for x in leaves]),
           None, 4.0 * (5 * nb * n * P + nb * P + 4 * nb * n * len(leaves)),
           17.0 * nb * n * P, {"shape": [nb, n, P], "leaves": len(leaves),
                               "history": "float32"})
    del leaves

    # ------------------------------- hieavg_agg with narrow history storage
    def ulps(got, want, dtype_name):
        """max |got - want| in units in the last place of the storage dtype
        at the larger magnitude, compared in float32; NaN against NaN is 0,
        NaN against a number is NaN (fails every bound)."""
        g, w_ = got.float(), want.float()
        mant, emin = NARROW[dtype_name]
        mag = torch.maximum(g.abs(), w_.abs()).clamp(min=2.0 ** emin)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
        r = torch.where(g.isnan() & w_.isnan(), 0.0, (g - w_).abs() / ulp)
        return float(torch.nan_to_num(r, nan=float("inf")).max().item())

    for hname in NARROW:
        hdt = getattr(torch, hname)
        label = f"hieavg_agg[{hname}]"

        def narrow_inputs(nb2, n2, L):
            a = list(hieavg_inputs(nb2, n2, L))
            a[1], a[2] = to_history_dtype(a[1], hdt), to_history_dtype(a[2], hdt)
            return a

        err, tol, worst_ulp = 0.0, 0.0, 0.0
        shapes = [(1, 3, 1), (2, 5, 7), (5, 5, 2047), (1, 5, 2049)]
        shapes += [(b_, n, L) for b_ in (nb, 1) for L in leaf_sizes]
        for shape in shapes:
            args = narrow_inputs(*shape)
            got = hieavg_agg(*args, mode="cuda")
            want = hieavg_agg(*args, mode="torch")
            check(label, got[1].dtype == got[2].dtype == hdt,
                  f"history came back as {got[1].dtype}")
            e, t = agg_err(got[:1], want[:1])
            check(label, e <= t, f"{shape} agg: {e} > {t}")
            u = max(ulps(g_, w_, hname) for g_, w_ in zip(got[1:], want[1:]))
            check(label, u <= 1.0, f"{shape} history: {u} ulp")
            err, tol = max(err, e), max(tol, t)
            worst_ulp = max(worst_ulp, u)
        # a present slot stores w itself: the kernel's rounding of the edge
        # values against the cast helper's (which casts as jnp.astype)
        edges = torch.tensor(F8_EDGES, device=dev)
        one = torch.ones((1, 1), device=dev)
        zero_h = to_history_dtype(torch.zeros((1, 1, len(F8_EDGES)),
                                              device=dev), hdt)
        ebits = {}
        for mode in ("cuda", "torch"):
            _, p_, d_ = hieavg_agg(edges[None, None], zero_h, zero_h,
                                   one > 0, one, one * 0, one * 0, mode=mode)
            ebits[mode] = (p_.float()[0, 0], d_.float()[0, 0])
        want = to_history_dtype(edges, hdt).float()

        def same(a_, b_):
            return bool(((a_ == b_) | (a_.isnan() & b_.isnan())).all())

        check(label, all(same(x, want) for x in ebits["cuda"] + ebits["torch"]),
              f"edge values: {ebits['cuda'][0].tolist()} != {want.tolist()}")
        hleaves = [narrow_inputs(nb, n, L) for L in leaf_sizes]
        s = 2 if hname == "bfloat16" else 1
        record(label, err, tol,
               lambda: [hieavg_agg(*x, mode="cuda") for x in hleaves],
               timed_ms(torch, lambda: [hieavg_agg(*x, mode="torch")
                                        for x in hleaves]),
               None, (4.0 + 4.0 * s) * nb * n * P + 4.0 * nb * P
               + 16.0 * nb * n * len(hleaves),
               17.0 * nb * n * P,
               {"shape": [nb, n, P], "leaves": len(hleaves), "history": hname,
                "history_max_ulp": worst_ulp, "history_tolerance_ulp": 1.0,
                "edge_values": dict(zip(map(str, F8_EDGES),
                                        ebits["cuda"][0].tolist()))},
               kernel="hieavg_agg")
        del hleaves

    # ------------------------------------------------------------- coef_agg
    err, tol = 0.0, 0.0
    for (nb2, n2, L) in ((1, 3, 1), (2, 5, 7), (5, 5, 2047), (1, 5, 2049)):
        w2, c2 = randn(nb2, n2, L), rand(nb2, n2)
        e, t = agg_err([coef_agg(w2, c2, "cuda")], [coef_agg(w2, c2, "torch")])
        check("coef_agg", e <= t, f"{(nb2, n2, L)}: {e} > {t}")
    cleaves = [(randn(nb, n, L), rand(nb, n)) for L in leaf_sizes]
    for w2, c2 in cleaves:
        e, t = agg_err([coef_agg(w2, c2, "cuda")], [coef_agg(w2, c2, "torch")])
        check("coef_agg", e <= t, f"DEFAULT leaf: {e} > {t}")
        err, tol = max(err, e), max(tol, t)
    w2, c2 = randn(1, 5, 500), torch.tensor([[0.5, 0.3, 0.2, 0.0, 0.0]],
                                            device=dev)
    w3 = w2.clone()
    w3[:, 3:] = 1e6
    check("coef_agg", torch.equal(coef_agg(w2, c2, "cuda"),
                                  coef_agg(w3, c2, "cuda")),
          "a zero-coefficient slot changed the aggregate")
    record("coef_agg", err, tol,
           lambda: [coef_agg(x, c, "cuda") for x, c in cleaves],
           timed_ms(torch, lambda: [coef_agg(x, c, "torch")
                                    for x, c in cleaves]),
           timed_ms(torch, lambda: [torch.einsum("bn,bnl->bl", c, x)
                                    for x, c in cleaves]),
           4.0 * (nb * n * P + nb * P + nb * n * len(cleaves)),
           2.0 * nb * n * P, {"shape": [nb, n, P], "leaves": len(cleaves)})
    del cleaves

    # -------------------------------------------------------- coef_agg_pair
    def pair_inputs(nb2, n2, L):
        """a delayed-gradient mix: present slots weigh w, missing ones aux"""
        m = rand(nb2, n2) > 0.4
        c = rand(nb2, n2)
        return randn(nb2, n2, L), randn(nb2, n2, L), c * m, c * ~m

    err, tol = 0.0, 0.0
    shapes = [(1, 3, 1), (2, 5, 7), (5, 5, 2047), (1, 5, 2049)]
    shapes += [(b_, n, L) for b_ in (nb, 1) for L in leaf_sizes]
    for shape in shapes:
        args = pair_inputs(*shape)
        e, t = agg_err([coef_agg_pair(*args, mode="cuda")],
                       [coef_agg_pair(*args, mode="torch")])
        check("coef_agg_pair", e <= t, f"{shape}: {e} > {t}")
        err, tol = max(err, e), max(tol, t)
    w2, a2 = randn(1, 5, 500), randn(1, 5, 500)
    ca = torch.tensor([[0.5, 0.0, 0.2, 0.0, 0.0]], device=dev)
    cb = torch.tensor([[0.0, 0.3, 0.0, 0.0, 0.0]], device=dev)
    w3, a3 = w2.clone(), a2.clone()
    w3[:, [1, 3, 4]] = 1e6
    a3[:, [0, 2, 3, 4]] = 1e6
    check("coef_agg_pair", torch.equal(coef_agg_pair(w2, a2, ca, cb, "cuda"),
                                       coef_agg_pair(w3, a3, ca, cb, "cuda")),
          "a zero-coefficient slot changed the aggregate")
    pleaves = [pair_inputs(nb, n, L) for L in leaf_sizes]
    record("coef_agg_pair", err, tol,
           lambda: [coef_agg_pair(*x, mode="cuda") for x in pleaves],
           timed_ms(torch, lambda: [coef_agg_pair(*x, mode="torch")
                                    for x in pleaves]),
           timed_ms(torch, lambda: [
               torch.einsum("bn,bnl->bl", ca_, w_).add_(
                   torch.einsum("bn,bnl->bl", cb_, a_))
               for w_, a_, ca_, cb_ in pleaves]),
           4.0 * (2 * nb * n * P + nb * P + 2 * nb * n * len(pleaves)),
           4.0 * nb * n * P,
           {"shape": [nb, n, P], "leaves": len(pleaves),
            "library_calls": "two einsum calls per leaf, summed in place"})
    del pleaves

    # ------------------------------------------------------------ eval_head
    def margin_rows(feats, wmat, bias):
        """rows whose two largest logits are within float32 reach of each
        other: their argmax may differ between two summation orders"""
        z = feats.double() @ wmat.double() + bias.double()
        top = torch.topk(z, 2, dim=-1).values
        return int(((top[:, 0] - top[:, 1])
                    <= 1e-4 * z.abs().amax(-1)).sum().item())

    ambiguous, err = 0, 0
    for m_ in (1, 7, 257, NTEST):
        f_ = rand(m_, FEAT)
        wm, bb = randn(FEAT, NCLS, scale=FEAT ** -0.5), randn(NCLS, scale=0.1)
        lab = torch.randint(-1, NCLS, (m_,), generator=gen, device=dev)
        got = int(eval_head(f_, wm, bb, lab, "cuda").item())
        want = int(eval_head(f_, wm, bb, lab, "torch").item())
        amb = margin_rows(f_, wm, bb)
        check("eval_head", abs(got - want) <= amb,
              f"M={m_}: count {got} vs {want}, {amb} ambiguous rows")
        ambiguous, err = ambiguous + amb, max(err, abs(got - want))
    record("eval_head", float(err), float(ambiguous),
           lambda: eval_head(f_, wm, bb, lab, "cuda"),
           timed_ms(torch, lambda: eval_head(f_, wm, bb, lab, "torch")),
           None, 4.0 * (NTEST * FEAT + FEAT * NCLS + NCLS + NTEST
                        + -(-NTEST // 8)),
           2.0 * NTEST * FEAT * NCLS, {"shape": [NTEST, FEAT, NCLS]})
    del f_, wm

    # ------------------------------------------------------ flash_attention
    serve_cfg = get_config(SERVE_ARCH)
    flash_designs(torch, flash_attention, FLASH_DESIGNS, randn,
                  build.compile_library())
    flash_phase(torch, serve_cfg, flash_attention, randn, record)

    # ----------------------------------------------------------- the runs
    # every configuration with the kernels and with the plain versions; the
    # launch counts are set to 0 just before each run and read just after
    setting = dataclasses.replace(DEFAULT, t_global_rounds=4)
    T = setting.t_global_rounds

    def make_sim(label, mode):
        agg, strag, hname = RUNS[label]
        return BHFLSimulator(setting, agg, strag, strag, device="cuda",
                             kernel_mode=mode,
                             history_dtype=hname and getattr(torch, hname))

    runs, steps_of = {}, {}
    for label in RUNS:
        for mode in ("auto", "torch"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            sim = make_sim(label, mode)
            res = sim.run()
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            runs[label, mode] = (res, dict(build.LAUNCHES))
            steps_of[label] = sim.steps
            for key in ROWS:
                row = getattr(res, key)
                check("run", row.shape == (T,) and bool(np.isfinite(row).all()),
                      f"{label} {mode} {key}: {row}")
            check("run", res.blocks == T and res.chain_valid,
                  f"{label} {mode}: chain {res.blocks}")
            emit({"run": {"config": label, "kernel_mode": mode,
                          "wall_s": res.wall_time,
                          "steps_per_epoch": sim.steps, "devices": sim.D,
                          "blocks": res.blocks,
                          "chain_valid": res.chain_valid,
                          **{k: [float(v) for v in getattr(res, k)]
                             for k in ROWS},
                          "launches": runs[label, mode][1],
                          "peak_memory_gb": peak_gb}})
        a, launches = runs[label, "auto"]
        p, plain_launches = runs[label, "torch"]
        check("run", not plain_launches,
              f"{label}: torch mode launched {plain_launches}")
        missing = [k for k in EVERY_RUN + RUN_KERNELS.get(label, ())
                   if launches.get(k, 0) == 0]
        check("launches", not missing,
              f"{label}: never launched {missing} ({launches})")
        steps = T * setting.k_edge_rounds * steps_of[label]
        check("launches", launches.get("sgd_update", 0) == steps,
              f"{label}: {launches.get('sgd_update', 0)} sgd_update "
              f"launches for {steps} local steps")
        parity = {
            "accuracy": bool(np.allclose(a.accuracy, p.accuracy, rtol=0,
                                         atol=ACC_TOL)),
            "loss": bool(np.allclose(a.loss, p.loss, rtol=LOSS_TOL,
                                     atol=LOSS_TOL)),
            "delta": bool(np.allclose(a.grad_norm, p.grad_norm,
                                      rtol=DELTA_RTOL, atol=DELTA_ATOL)),
            "clock_equal": bool(np.array_equal(a.sim_clock, p.sim_clock)),
            "energy_equal": bool(np.array_equal(a.sim_energy, p.sim_energy)),
            "blocks_equal": a.blocks == p.blocks,
        }
        emit({"parity": {"config": label, "auto_vs_torch": parity,
                         "max_abs_diff": {
                             "accuracy": float(np.abs(a.accuracy
                                                      - p.accuracy).max()),
                             "loss": float(np.abs(a.loss - p.loss).max()),
                             "delta": float(np.abs(a.grad_norm
                                                   - p.grad_norm).max())},
                         "tolerances": {"accuracy_atol": ACC_TOL,
                                        "loss_rtol_atol": LOSS_TOL,
                                        "delta_rtol": DELTA_RTOL,
                                        "delta_atol": DELTA_ATOL}}})
        check("parity", all(parity.values()), f"{label}: {parity}")

    # ------------------------------------------------- the resumed runs
    for label in RESUMED:
        line = resume_check(runs[label, "auto"][0],
                            lambda: make_sim(label, "auto"))
        emit({"resume": {"config": label, "every": 2, **line}})
        check("resume", line["resumed_bitwise"] and line["close_to_run"],
              f"{label}: {line}")

    # --------------------------------------------------- the serving path
    served = serve_runs(torch, serve, build, serve_cfg.n_layers)
    serve_parity(torch, serve, served)

    if "--profile" in sys.argv[1:]:
        emit({"profile": profile_run(torch, lambda: BHFLSimulator(
            setting, "hieavg", "temporary", "temporary", device="cuda",
            kernel_mode="auto").run())})
        for label, gen in (("prefill", 1), ("decode", SERVE_GEN)):
            # gen 1 is the prefill alone; the decode's share is the rest
            emit({"profile_serve": {"part": label, **profile_run(
                torch, lambda: serve.run(
                    SERVE_ARCH, smoke=False, batch=SERVE_BATCH,
                    prompt_len=SERVE_PROMPT, gen=gen, device="cuda",
                    progress=False))}})
    if "--full" in sys.argv[1:]:
        emit({"full_run": full_runs(torch, BHFLSimulator, DEFAULT)})
        emit({"fig2": fig2_runs(run_comparison, DEFAULT)})
        torch.cuda.reset_peak_memory_stats()
        res = serve.run(SERVE_ARCH, smoke=False, batch=1,
                        prompt_len=SERVE_LONG_PROMPT, gen=SERVE_GEN,
                        device="cuda", progress=False)
        check("serve", bool(np.isfinite(res["logits"]).all()),
              "long prompt: logits not finite")
        emit({"serve_long": {
            "arch": SERVE_ARCH, "batch": 1, "prompt": SERVE_LONG_PROMPT,
            "gen": SERVE_GEN, "prefill_s": res["t_prefill"],
            "decode_tokens_per_s": SERVE_GEN / res["t_decode"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}})

    launches = {k: runs[LAUNCHES_FROM.get(k, "hieavg"), "auto"][1].get(k, 0)
                for k in REPLACES if k != "flash_attention"}
    launches["flash_attention"] = served["auto"][1].get("flash_attention", 0)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE[k],
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k]["library_ms"]} for k in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
