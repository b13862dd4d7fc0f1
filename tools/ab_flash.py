#!/usr/bin/env python3
"""The float32 flash backward of two trees of the port, side by side on one
GPU.

    python3 tools/ab_flash.py --parent DIR [--change DIR]

``DIR`` is the root of a checkout (``--change`` defaults to the one that
holds this script).  One process per tree, in turns (parent, change,
change, parent: ``ab_conv.in_turns``), each importing that tree's
``repro_torch`` and building its kernels, times ``flash_attention_bwd`` in
float32 at PERF.md's rows 8r (a rank's danube shard: q [2, 2048, 16, 80],
k/v [2, 2048, 4, 80], causal, window 4096) and 8s (recurrentgemma's local
attention: q [2, 8192, 16, 256], k/v [2, 8192, 1, 256], causal, window
2048), random data from a seed:

  * the wall time per call (CUDA events, the median of 3 timings) and each
    launch's device time (``chip_smoke.launch_ms``: delta, dk/dv, dq);
  * the kernel instances it launches (``torch.profiler``) and the largest
    distance of each gradient from the plain version's (``rel``, of each
    gradient's largest magnitude, the plain version fed the plain
    forward's output and lse);
  * a digest of the gradients.

Prints one JSON line per process, then a summary: each time per tree, the
instances, and whether the gradients are bitwise the same in the processes
of each tree.  Needs one CUDA device; exits 2 without one.  Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import hashlib
import importlib
import json
import re
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ab_conv import ROOT, in_turns, trees_of  # noqa: E402

#: label -> (B, S, H, Hkv, Dh, window): PERF.md's rows 8r and 8s
SHAPES = {"8r": (2, 2048, 16, 4, 80, 4096),
          "8s": (2, 8192, 16, 1, 256, 2048)}


def kernels(torch, fn) -> list:
    """The flash backward kernels ``fn()`` launches, by profiler name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({m.group(1) for ev in prof.key_averages()
                   for m in [re.search(r"(flash_bwd_\w+<[^>]*>)", ev.key)]
                   if m})


def one() -> dict:
    """The measurements of the tree on ``PYTHONPATH``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import launch_ms, timed_ms
    from repro_torch.kernels import build, ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out: dict = {"device": torch.cuda.get_device_name(0)}
    for label, (b, s, h, hkv, dh, win) in SHAPES.items():
        q, do = (torch.randn((b, s, h, dh), generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev)
                for _ in range(2))
        kw = dict(causal=True, window=win)
        o, lse = fa.flash_attention_fwd(q, k, v, lse=True, mode="cuda", **kw)

        def fn():
            return fa.flash_attention_bwd(q, k, v, o, lse, do, mode="cuda",
                                          **kw)
        got = fn()
        o_ref, lse_ref = ref.flash_attention_fwd_ref(q, k, v, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        digest = hashlib.sha256()
        for g in got:
            digest.update(g.cpu().numpy().tobytes())
        out[label] = {
            "ms": float(np.median([timed_ms(torch, fn, iters=3 if dh > 128
                                            else 20) for _ in range(3)])),
            "launch_ms": launch_ms(torch, build, fn, iters=3),
            "kernels": kernels(torch, fn),
            "rel": max((g - w).abs().max().item() / w.abs().max().item()
                       for g, w in zip(got, want)),
            "sha256": digest.hexdigest()}
        del q, k, v, do, o, lse, got, want, o_ref, lse_ref
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if "--one" in sys.argv[1:]:
        import torch
        if not torch.cuda.is_available():
            print("ab_flash: no CUDA device is available", file=sys.stderr)
            return 2
        print(json.dumps(one()), flush=True)
        return 0
    lines = in_turns(Path(__file__).resolve(), trees_of(sys.argv[1:]))
    if isinstance(lines, int):
        return lines
    summary: dict = {"order": [x["side"] for x in lines]}
    for label in SHAPES:
        summary[label] = {side: {k: [x[label][k] for x in lines
                                     if x["side"] == side]
                                 for k in ("ms", "launch_ms", "rel")}
                          for side in ("parent", "change")}
        for side in ("parent", "change"):
            mine = [x[label] for x in lines if x["side"] == side]
            summary[label][side]["kernels"] = mine[0]["kernels"]
            summary[label][side]["bitwise_on_repeat"] = \
                len({m["sha256"] for m in mine}) == 1
    print(json.dumps({"ab_flash": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
