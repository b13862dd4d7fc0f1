#!/usr/bin/env python3
"""What the kernel wrappers' device guard costs the host, on one GPU.

    python3 tools/guard_cost.py

Every kernel wrapper launches inside ``build.on_device(t)``, which makes
the card of its tensors the current device for the launch.  In one
process this times:

  * the guard alone, ``with build.on_device(t): pass``: host microseconds
    a use, the best of 5 runs of 100000;
  * ``hieavg_agg_many`` over the paper's CNN's six leaves at DEFAULT width
    (B = n = 5, float32 history: PERF.md's row 4, a host-bound wrapper) in
    three arms: with the guard, with a stand-in that does nothing, and
    with that stand-in again (an A/A control, which shows what the design
    reads where nothing differs).  ``BLOCKS`` rounds each time ``CALLS``
    calls of every arm (the device idle before each), the arms in a
    rotating order.  Per arm: the median host ms a call over the blocks.
    Per pair (guard - none, none again - none): the median of the
    per-block differences and its 95% bootstrap interval.

Prints one JSON line.  Needs a CUDA device; exits 2 without one.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BLOCKS, CALLS = 1000, 20
ARMS = ("guard", "none", "none again")


class NoGuard:
    """``build.on_device``'s stand-in: the launch on the current device."""

    def __init__(self, t):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def median_ci(d: np.ndarray, seed: int = 0, draws: int = 4000) -> list:
    """The median of ``d`` and its 95% bootstrap interval."""
    rng = np.random.default_rng(seed)
    meds = np.median(rng.choice(d, (draws, d.size)), axis=1)
    return [float(np.median(d)), float(np.quantile(meds, 0.025)),
            float(np.quantile(meds, 0.975))]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("guard_cost: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.hieavg_agg import hieavg_agg_many
    from repro_torch.models import cnn_specs

    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    nb, n = 5, 5
    shapes = [tuple(s.shape) for s in cnn_specs(28, 1, 10, c1=32,
                                                   c2=64).values()]
    ws = [torch.randn((nb, n) + s, generator=gen, device=dev)
          for s in shapes]
    hist = [torch.randn(w.shape, generator=gen, device=dev) for w in ws]
    c = torch.rand((nb, n), generator=gen, device=dev)
    m = (torch.rand((nb, n), generator=gen, device=dev) > 0.4).float()

    def call():
        return hieavg_agg_many(ws, hist, hist, m, c * m, c * (1 - m), c,
                               mode="cuda")

    t = ws[0]
    alone = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(100000):
            with build.on_device(t):
                pass
        alone.append((time.perf_counter() - t0) / 100000 * 1e6)
    guard = build.on_device
    for _ in range(50):
        call()
    times = {a: np.empty(BLOCKS) for a in ARMS}
    for r in range(BLOCKS):
        for j in range(len(ARMS)):
            arm = ARMS[(r + j) % len(ARMS)]
            build.on_device = guard if arm == "guard" else NoGuard
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                call()
            times[arm][r] = (time.perf_counter() - t0) / CALLS * 1e3
    torch.cuda.synchronize()
    build.on_device = guard
    base = times["none"]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "blocks": BLOCKS, "calls_a_block": CALLS,
        "guard_alone_us": min(alone),
        "hieavg_agg_host_ms": {a: float(np.median(v))
                               for a, v in times.items()},
        "hieavg_agg_host_ms_iqr": {a: [float(q) for q in
                                       np.quantile(v, [0.25, 0.75])]
                                   for a, v in times.items()},
        "diff_us_median_ci95": {
            "guard - none": [1e3 * x for x in
                             median_ci(times["guard"] - base)],
            "none again - none": [1e3 * x for x in
                                  median_ci(times["none again"] - base)]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
