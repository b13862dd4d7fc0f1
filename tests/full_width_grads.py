#!/usr/bin/env python3
"""Full-width training against the reference on the CPU: ``loss_fn`` and
its gradients in both packages at h2o-danube-1.8b's full width (d_model
2560, 32 heads, 8 kv heads, d_ff 6912, vocab 32000), cut to 2 layers,
float32, on 2 rows of 256 tokens.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/full_width_grads.py \\
        [--layers 2] [--seq 256] [--rows 2] [--out FILE]

The weights are the reference's own (its ``init_from_specs`` from key 0),
carried over with ``params_from_numpy``; tokens and labels are drawn with
numpy from seed 0.  The reference takes ``jax.value_and_grad`` of its
``loss_fn`` under ``jax.jit`` (its XLA attention on the CPU); the port
takes ``torch.autograd.grad`` of its ``loss_fn`` with its plain versions
(``kernel_mode="torch"``), in float32 and, as the yardstick of float32
rounding, in float64 (the same weights widened).  Prints one JSON line:
both losses, each package's largest gradient, the worst leaf (its
largest difference over the leaf's largest reference gradient) of the
port against the reference, and of each float32 package against the
port's float64.  A script, not a test: a run takes a few minutes and
some 10 GB of host memory.  It imports both packages, as the tests do;
the port itself imports nothing of the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time

import jax
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_from_specs as j_init
from repro.models import loss_fn as j_loss_fn
from repro.models import param_specs as j_param_specs
from repro_torch.configs import cut_depth, get_config
from repro_torch.launch.steps import flatten, unflatten
from repro_torch.models import loss_fn
from repro_torch.models.transformer import params_from_numpy

ARCH = "h2o-danube-1.8b"


def port_grads(base: dict, cfg, tok, lab, dtype) -> tuple[float, dict]:
    """The port's loss and flat gradients (numpy) in ``dtype``."""
    leaves = {k: v.to(dtype).requires_grad_()
              for k, v in flatten(params_from_numpy(base)).items()}
    loss = loss_fn(unflatten(leaves), torch.from_numpy(tok).long(),
                   torch.from_numpy(lab).long(),
                   dataclasses.replace(cfg, param_dtype=str(dtype)[6:]),
                   remat=True, kernel_mode="torch")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.detach().numpy()
                                  for k, g in zip(leaves, grads)}


def worst(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's largest difference over its largest ``want``."""
    return max((float(np.abs(got[k].astype(np.float64) - want[k]).max()
                      / np.abs(want[k]).max()), k) for k in want)


def largest(g: dict) -> float:
    return max(float(np.abs(v).max()) for v in g.values())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    jcfg = dataclasses.replace(j_get_config(ARCH), n_layers=args.layers,
                               param_dtype="float32")
    cfg = dataclasses.replace(cut_depth(get_config(ARCH), args.layers),
                              param_dtype="float32")
    base = jax.tree.map(np.asarray, j_init(j_param_specs(jcfg),
                                           jax.random.key(0),
                                           param_dtype=np.float32))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (args.rows, args.seq)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (args.rows, args.seq)).astype(np.int32)
    t0 = time.time()
    jloss, jg = jax.jit(jax.value_and_grad(functools.partial(
        j_loss_fn, cfg=jcfg, remat=True)))(base, tok, lab)
    jg = flatten(jax.tree.map(np.asarray, jg))
    t_ref = time.time() - t0
    t0 = time.time()
    loss, g = port_grads(base, cfg, tok, lab, torch.float32)
    t_port = time.time() - t0
    loss64, g64 = port_grads(base, cfg, tok, lab, torch.float64)
    rec = {"arch": ARCH, "layers": args.layers, "rows": args.rows,
           "seq": args.seq, "dtype": "float32", "leaves": len(jg),
           "loss_reference": float(jloss), "loss_port": loss,
           "loss_port_float64": loss64,
           "largest_grad_reference": largest(jg),
           "largest_grad_port": largest(g),
           "port_vs_reference": worst(g, jg),
           "port_vs_float64": worst(g, g64),
           "reference_vs_float64": worst(jg, g64),
           "seconds_reference": t_ref, "seconds_port": t_port}
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
