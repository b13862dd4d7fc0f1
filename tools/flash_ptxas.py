#!/usr/bin/env python3
"""Registers, spills and shared memory of the flash kernels, per kernel
instance, as ``ptxas -v`` reports them (needs the CUDA toolkit's nvcc):

    python3 tools/flash_ptxas.py [--dh 256] [--out build/ptxas]
    python3 tools/flash_ptxas.py --source conv3x3.cu --every

Compiles ``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_bwd_fma.cu`` (or the ``--source`` files of ``csrc/``) with
the port's own flags plus ``-Xptxas -v``, in parallel, and prints one
JSON line per kernel instance at the asked head dims (every instance
with ``--every``): its name (with the template arguments: the head dim,
and the dk/dv kernel's pass, 0 both, 1 dV alone, 2 dK alone), registers
a thread, spill stores and loads in bytes, and static shared memory.
The whole ptxas log of each source goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "flash_bwd_fma.cu")


def kernel_name(mangled: str) -> str:
    """``flash_bwd_dkdv_wgmma_kernel<256, 1>`` from a mangled name."""
    m = re.search(r"([a-z][a-z0-9_]*_kernel)I((?:Li\d+E)+)", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def parse(log: str) -> list:
    """One dict per entry function of a ``ptxas -v`` log."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": kernel_name(m.group(1))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_store_bytes"] = int(m.group(1))
            cur["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out


def main() -> int:
    from repro_torch.kernels import build
    ap = argparse.ArgumentParser()
    ap.add_argument("--dh", type=int, nargs="*", default=[256])
    ap.add_argument("--out", default=str(ROOT / "build" / "ptxas"))
    ap.add_argument("--source", nargs="*", default=list(SOURCES))
    ap.add_argument("--every", action="store_true")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(build.CSRC), "-c", str(build.CSRC / src), "-o",
             str(Path(tmp) / (src + ".o"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for src in args.source]
        rc = 0
        for src, p in procs:
            log, _ = p.communicate()
            (out / f"{src}.log").write_text(log)
            rc |= p.returncode
            for k in parse(log):
                dims = re.findall(r"\d+", k["kernel"].split("<")[-1])
                if args.every or dims and int(dims[0]) in args.dh:
                    print(json.dumps({"source": src, **k}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
