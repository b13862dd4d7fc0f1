"""End-to-end hierarchical BHFL training driver for the LLM zoo, on one GPU.

Port of ``repro.launch.train``: K edge rounds per global round, HieAvg at
both layers, the Raft chain's latency accounting, straggler schedules,
checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 20 --batch 4 --seq 64 [--no-smoke] [--device cpu]

The host plane consumes the reference's RNG streams in its order
(``dev_masks``, ``edge_masks``, ``chain``, ``data``, ``batches``), so the
masks, the batch indices, the chain and the simulated clock are bitwise
the reference's.  The weights are drawn from ``seed`` on the device in the
config's ``param_dtype`` (the reference's ``run`` leaves them float32),
unless ``init_params`` carries the reference's own across.  With ``fused``
(the default) every batch is drawn and the chain replayed up front, which
gives ``sim_clock``, then the T x K steps run; without it, the per-round
loop with a checkpoint every 10 global rounds.  Both call the same step
(``make_hfl_train_step``), whose full-sequence attention runs the flash
kernels, forward and backward, under ``kernel_mode="auto"`` on the card.
A model with cross-attention gets zero memory of the stubbed frontend's
shape (``inputs.memory_shape``) in the parameters' dtype with every
edge-round batch, as the reference's driver feeds it.

On a mesh (``--mesh data=D,model=M[,pod=P]``, one process a rank):

  python -m torch.distributed.run --nproc-per-node 4 -m \\
      repro_torch.launch.train --mesh data=1,model=4 --backend auto ...

each rank builds only its shard of the state (``mesh_state``), computes
the same host plane, and runs ``make_hfl_train_step(mesh=...)`` over
``--backend``'s group (``launch.mesh.start_group``: NCCL with a card a
rank, or ``gloo`` through host memory where ranks share a card or run on
the CPU; ``auto`` chooses, and the first line says which).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, cut_depth, get_config, get_smoke
from repro_torch.core import (LatencyParams, RaftChain, RaftParams,
                              straggler, stream_rng, stream_seed)
from repro_torch.data import lm_tokens
from repro_torch.fl.simulator import resolve_device
from repro_torch.kernels.build import KERNEL_MODES
from repro_torch.launch import sharding as shd
from repro_torch.launch.inputs import memory_shape, train_input_specs
from repro_torch.launch.mesh import (BACKENDS, group_backend,
                                     make_debug_mesh, mesh_shape,
                                     start_group)
from repro_torch.launch.serve import draw_params, make_params
from repro_torch.launch.steps import (flatten, init_fl_histories,
                                      make_hfl_train_step, place_fl_state,
                                      unflatten)
from repro_torch.models.config import InputShape
from repro_torch.models.transformer import leaf_from_numpy, params_from_numpy
from repro_torch.optim import paper_lr
from repro_torch.optim.sgd import tree_map


def run(arch: str, *, smoke: bool = True, steps: int = 20, k_edge: int = 2,
        n_clients: int = 2, batch: int = 4, seq: int = 64,
        straggler_frac: float = 0.2, gamma0: float = 0.9, lam: float = 0.9,
        normalize: bool = True, ckpt_dir: Optional[str] = None,
        seed: int = 0, progress: bool = True, fused: bool = True,
        kernel_mode: str = "auto",
        lat_params: Optional[LatencyParams] = None, device=None,
        init_params: Optional[dict] = None, n_layers: Optional[int] = None,
        n_edges: Optional[int] = None, param_dtype: Optional[str] = None,
        mesh=None) -> dict:
    """Train ``arch`` for ``steps`` global rounds of ``k_edge`` edge rounds.

    ``device=None`` means ``"cuda"`` and raises without a GPU.
    ``init_params``: the reference's initial weights (``base``, a nested
    dict of numpy arrays), carried over by ``params_from_numpy``.
    ``n_layers`` cuts the config's depth (None: its own; for a config with
    an encoder, the encoder's depth too, to the same count: one knob) and
    ``n_edges`` its number of edges E (None: the reference's, 1 at smoke
    and 2 else), for the card's smoke run; ``param_dtype`` sets the
    weights' dtype (None: the config's).  Returns the reference's keys:
    ``losses`` (each global round's last edge-round loss), ``wall``
    (seconds, the device synchronized), ``blocks``, ``chain_valid`` and,
    when fused, ``sim_clock``.

    ``mesh``: a ``DeviceMesh`` of ``launch.mesh`` over the running group
    (``start_group``), one process a rank.  Each rank then builds only its
    shard of the state (``mesh_state``: a whole leaf at a time, never the
    model), computes the same host plane from ``seed`` (bitwise the
    one-card plane), and runs ``make_hfl_train_step(mesh=mesh)`` on each
    round's batch placed over the batch axes; the losses are the
    replicated ones, every rank returns the same dict with ``backend``
    (``launch.mesh.group_backend``) and ``mesh`` ({axis: extent}) added,
    and with ``ckpt_dir`` rank 0 writes the global model, gathered one
    leaf at a time, in the one-card file's format.  E must be a multiple
    of the mesh's ``pod`` extent, C of its ``data`` extent (with one
    client an edge, the batch rows), and the ranks on CUDA compute on
    their current device."""
    dev = resolve_device(device)
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"unknown kernel_mode {kernel_mode!r}; expected one "
                         f"of {KERNEL_MODES}")
    cfg = get_smoke(arch) if smoke else get_config(arch)
    if n_layers is not None:
        cfg = cut_depth(cfg, n_layers)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    e = (1 if smoke else 2) if n_edges is None else n_edges
    c = n_clients

    ms = memory_shape(cfg)
    if mesh is None:
        if init_params is None:
            base = make_params(cfg, seed, dev)
        else:
            base = tree_map(lambda x: x.to(cfg.torch_param_dtype),
                            params_from_numpy(init_params, dev))
        params = tree_map(lambda x: x[None, None].expand(
            (e, c) + tuple(x.shape)).contiguous(), base)
        del base
        dev_hist, glob_hist = init_fl_histories(params)
        put = _placer(dev)
    else:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        cfg = dataclasses.replace(cfg, clients_per_pod=c)
        specs = mesh_specs(cfg, mesh, edges=e, clients=c, batch=batch,
                           seq=seq)
        params, dev_hist, glob_hist = mesh_state(
            cfg, mesh, specs, seed=seed, init_params=init_params,
            device=dev)
        put = _placer(dev, mesh, specs)
        progress = progress and dist.get_rank() == 0
        if progress:
            print(f"mesh {mesh_shape(mesh)} on backend {group_backend()}, "
                  f"ranks {dist.get_world_size()}, rank 0 on {dev}")
    step = make_hfl_train_step(cfg, gamma0=gamma0, lam=lam,
                               normalize=normalize, kernel_mode=kernel_mode,
                               mesh=mesh)
    if ms is not None:
        step = _with_memory(step, put("memory", torch.zeros(
            (e, c, batch) + ms, dtype=cfg.torch_param_dtype, device=dev)))

    # straggler schedules + Raft chain: each consumer on its own stream
    dev_masks = straggler.from_fraction(steps * k_edge + 1, e * c,
                                        straggler_frac,
                                        seed=stream_seed(seed, "dev_masks"))
    edge_masks = straggler.from_fraction(steps + 1, e, straggler_frac,
                                         seed=stream_seed(seed, "edge_masks"))
    lp = lat_params or LatencyParams(T=steps, N=e, J=c)
    chain = RaftChain(max(e, 1), RaftParams(),
                      seed=stream_seed(seed, "chain"))
    data = lm_tokens(e * c * batch * 4, seq + 1, cfg.vocab,
                     seed=stream_seed(seed, "data"))
    rng = stream_rng(seed, "batches")

    state = dict(params=params, dev_hist=dev_hist, glob_hist=glob_hist)
    kw = dict(steps=steps, k_edge=k_edge, e=e, c=c, batch=batch, seq=seq,
              progress=progress, dev=dev, put=put)
    t0 = time.perf_counter()
    if fused:
        out = _run_fused(step, state, chain, dev_masks, edge_masks, data,
                         rng, lp, **kw)
        if ckpt_dir:
            _save(ckpt_dir, steps, state, chain, mesh)
    else:
        out = _run_loop(step, state, chain, dev_masks, edge_masks, data,
                        rng, ckpt_dir=ckpt_dir, mesh=mesh, **kw)
    _sync(dev)
    out = {**out, "wall": time.perf_counter() - t0,
           "blocks": len(chain.blocks) - 1, "chain_valid": chain.validate()}
    if mesh is not None:
        out.update(backend=group_backend(), mesh=mesh_shape(mesh))
    return out


def mesh_specs(cfg, mesh, *, edges: int, clients: int, batch: int,
               seq: int) -> dict:
    """``run``'s step inputs on ``mesh`` as ``train_input_specs``' stand-ins
    (E edges of C clients of ``batch`` rows of ``seq`` tokens); raises
    where the mesh's ``pod`` extent does not divide E, or its ``data``
    extent C (one client an edge: the batch rows)."""
    ext = mesh_shape(mesh)
    pod, data = ext.get("pod", 1), ext.get("data", 1)
    if edges % pod:
        raise ValueError(f"{edges} edges on a pod axis of {pod}")
    split = (clients, "clients") if clients > 1 else (batch, "batch rows")
    if split[0] % data:
        raise ValueError(f"{split[0]} {split[1]} on a data axis of {data}")
    return train_input_specs(cfg, InputShape(
        "train", seq, edges * clients * batch, "train"), mesh, edges=edges)


def mesh_state(cfg, mesh, specs: dict, *, seed: int = 0,
               init_params: Optional[dict] = None, device="cpu"):
    """(params, dev_hist, glob_hist) of ``run``'s cold boot on ``mesh``,
    placed by ``specs`` (``mesh_specs``), built leaf by leaf: each weight
    drawn whole on ``device`` from ``make_params``' generator
    (``draw_params``), or taken whole from ``init_params`` on the host,
    cut to this rank's chunk (``sharding.shard_leaves``) and dropped
    before the next, the slots and histories made from the chunk
    (``steps.place_fl_state``).  A rank's setup peak is its placed state
    and one whole float32 leaf; its chunks equal the one-card state's
    bitwise."""
    pspec = {k: v.spec for k, v in flatten(specs["params"]).items()}
    if init_params is None:
        leaves = draw_params(cfg, seed, device)
    else:
        leaves = ((k, leaf_from_numpy(v))
                  for k, v in flatten(init_params).items())
    return place_fl_state(shd.shard_leaves(
        leaves, pspec, mesh, lead=2, device=device,
        dtype=cfg.torch_param_dtype), specs, mesh)


def _placer(dev: torch.device, mesh=None, specs: Optional[dict] = None):
    """put(name, whole value) -> the step's argument ``name`` (a batch key,
    ``dev_mask`` or ``edge_mask``): the value on ``dev``, or on a mesh
    this rank's chunk of it as a DTensor placed by ``specs``."""
    if mesh is None:
        return lambda name, x: torch.as_tensor(x, device=dev)
    stands = {**specs["batch"], "dev_mask": specs["dev_mask"],
              "edge_mask": specs["edge_mask"]}

    def put(name, x):
        st = stands[name]
        x = torch.as_tensor(x)
        loc = x[shd.local_index(tuple(x.shape), st.spec, mesh)]
        return shd.from_local(loc.to(dev).contiguous(), st, mesh)

    return put


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _global_model(state: dict, mesh=None):
    """Client slot (0, 0): after a global step, the global model.  On a
    mesh each leaf's slot is gathered whole in turn (every rank's slots
    hold the global model) and copied to rank 0's host; other ranks get
    None."""
    if mesh is None:
        return tree_map(lambda x: x[0, 0], state["params"])
    from torch.distributed.tensor import DTensor, Replicate
    out = {}
    for k, v in flatten(state["params"]).items():
        pl = tuple(Replicate() if p.is_shard() and p.dim < 2 else p
                   for p in v.placements)
        shape = torch.Size((1, 1, *v.shape[2:]))
        full = DTensor.from_local(
            v.to_local()[:1, :1], v.device_mesh, pl, run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride()
        ).full_tensor()
        if dist.get_rank() == 0:
            out[k] = full[0, 0].cpu()
        del full
    return unflatten(out) if dist.get_rank() == 0 else None


def _save(ckpt_dir: str, step: int, state: dict, chain, mesh) -> None:
    """The global model's checkpoint at ``step`` (on a mesh, rank 0's)."""
    model = _global_model(state, mesh)
    if model is not None:
        save_checkpoint(ckpt_dir, step, model,
                        metadata={"round": step,
                                  "block": len(chain.blocks) - 1})


def _with_memory(step, memory: torch.Tensor):
    """``step`` with ``memory`` [E, C, b, *memory shape] in every batch."""
    def wrapped(params, dev_hist, glob_hist, batch, dm, em, lr):
        return step(params, dev_hist, glob_hist, {**batch, "memory": memory},
                    dm, em, lr)
    return wrapped


def _batch(chunk: np.ndarray, dev: torch.device) -> dict:
    """tokens and labels [E, C, b, S] of [E, C, b, S + 1] token rows."""
    t = torch.as_tensor(chunk, device=dev).long()
    return {"tokens": t[..., :-1], "labels": t[..., 1:]}


def _step(step, state: dict, put, batch: dict, dm, em, lr,
          dev) -> torch.Tensor:
    state["params"], state["dev_hist"], state["glob_hist"], loss = step(
        state["params"], state["dev_hist"], state["glob_hist"],
        {k: put(k, v) for k, v in batch.items()}, put("dev_mask", dm),
        put("edge_mask", em), torch.as_tensor(lr, device=dev))
    return loss


def _run_loop(step, state, chain, dev_masks, edge_masks, data, rng, *,
              steps, k_edge, e, c, batch, seq, progress, dev, put,
              ckpt_dir, mesh) -> dict:
    """The per-round loop: a batch drawn per edge round, the chain elected
    before and committed after each global round."""
    losses = []
    for t in range(steps):
        chain.elect_leader()
        for k in range(k_edge):
            idx = rng.integers(0, data.shape[0], e * c * batch)
            chunk = data[idx].reshape(e, c, batch, seq + 1)
            loss = _step(step, state, put, _batch(chunk, dev),
                         dev_masks[t * k_edge + k].reshape(e, c),
                         edge_masks[t], paper_lr(t * k_edge + k, 1e-2, 0.3),
                         dev)
        chain.commit_block(f"edges@{t}", f"global@{t}")
        losses.append(float(loss))
        if progress and (t % 5 == 0 or t == steps - 1):
            print(f"  global round {t:3d}  loss {losses[-1]:.4f}")
        if ckpt_dir and (t + 1) % 10 == 0:
            _save(ckpt_dir, t + 1, state, chain, mesh)
    return {"losses": losses}


def _run_fused(step, state, chain, dev_masks, edge_masks, data, rng,
               lp: LatencyParams, *, steps, k_edge, e, c, batch, seq,
               progress, dev, put) -> dict:
    """Every batch drawn up front in the loop's order (the same ``rng``
    draws), the chain replayed up front (its election + commit latency
    a global round feeds the simulated clock: the K-round edge window
    ``k_edge (2 lm_device + lp_device)``, the edge-leader hop and any
    consensus stall past the window), then the T x K steps."""
    r_n = steps * k_edge
    idx = np.stack([rng.integers(0, data.shape[0], e * c * batch)
                    for _ in range(r_n)])
    chunks = data[idx].reshape(r_n, e, c, batch, seq + 1)
    dms = dev_masks[:r_n].reshape(r_n, e, c)
    ems = edge_masks[np.arange(r_n) // k_edge]
    lrs = paper_lr(np.arange(r_n, dtype=np.float32), 1e-2, 0.3)

    cons = np.zeros(steps)
    for t in range(steps):
        _, t_elect = chain.elect_leader()
        _, t_commit = chain.commit_block(f"edges@{t}", f"global@{t}")
        cons[t] = t_elect + t_commit
    window = k_edge * (2.0 * lp.lm_device + lp.lp_device)
    sim_clock = np.cumsum(window + 2.0 * lp.lm_edge
                          + np.maximum(0.0, cons - window))

    batches = _batch(chunks, dev)
    losses_r = [_step(step, state, put,
                      {k: v[r] for k, v in batches.items()}, dms[r], ems[r],
                      lrs[r], dev) for r in range(r_n)]
    # the loop reports each global round's last edge-round loss
    losses = [float(x) for x in
              torch.stack(losses_r).cpu().numpy().reshape(
                  steps, k_edge)[:, -1]]
    if progress:
        for t in range(steps):
            if t % 5 == 0 or t == steps - 1:
                print(f"  global round {t:3d}  loss {losses[t]:.4f}  "
                      f"clock {sim_clock[t]:.1f}s")
    return {"losses": losses, "sim_clock": sim_clock}


def parse_mesh(text: str) -> dict:
    """``--mesh``'s ``data=D,model=M[,pod=P]`` as ``make_debug_mesh``'s
    keyword arguments."""
    out = {}
    for part in text.split(","):
        name, _, n = part.partition("=")
        if name not in ("pod", "data", "model") or name in out \
                or not n.isdigit() or int(n) < 1:
            raise ValueError(f"--mesh {text!r}: expected data=D,model=M"
                             "[,pod=P] with positive extents")
        out[name] = int(n)
    if "data" not in out or "model" not in out:
        raise ValueError(f"--mesh {text!r}: expected data=D,model=M[,pod=P]")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--k-edge", type=int, default=2)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--n-edges", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--kernel-mode", choices=KERNEL_MODES, default="auto")
    ap.add_argument("--mesh", default=None, metavar="data=D,model=M[,pod=P]",
                    help="train on a mesh, one process a rank (launched by "
                    "python -m torch.distributed.run --nproc-per-node N)")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="the mesh's collectives (with --mesh; default "
                    "auto: nccl with a card a rank, else staged)")
    args = ap.parse_args()
    if args.backend is not None and args.mesh is None:
        ap.error("--backend needs --mesh")
    kw = dict(smoke=args.smoke, steps=args.steps, k_edge=args.k_edge,
              n_clients=args.clients, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir, device=args.device,
              kernel_mode=args.kernel_mode, n_layers=args.n_layers,
              n_edges=args.n_edges)
    if args.mesh is None:
        out = run(args.arch, **kw)
    else:
        try:
            axes = parse_mesh(args.mesh)
        except ValueError as err:
            ap.error(str(err))
        group = start_group(backend=args.backend or "auto")
        try:
            n = int(np.prod(list(axes.values())))
            if n != group.world:
                raise SystemExit(f"--mesh {args.mesh} holds {n} ranks, the "
                                 f"group {group.world}")
            if group.rank == 0:
                print(f"backend {group.backend} ({group.reason})",
                      flush=True)
            out = run(args.arch, mesh=make_debug_mesh(**axes), **kw)
        finally:
            dist.destroy_process_group()
        if group.rank != 0:
            return
    print(f"done: loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
          f"{out['blocks']} blocks, chain_valid={out['chain_valid']}, "
          f"{out['wall']:.1f}s")


if __name__ == "__main__":
    main()
