"""Step builders: hierarchical FL training and serving
(``repro.launch.steps`` for the port).

Plain closures over the config and the kernel mode, run eagerly; the JAX
package jits them and places them on a mesh.  Each builder takes the
reference's ``mesh=``.  Without one, or on a mesh whose every axis has
extent 1, the step runs on plain tensors as they come.  On a
``DeviceMesh`` with an axis above 1 (``_sharded``) the step takes and
returns DTensors placed as ``launch.inputs`` places them
(``sharding.place`` makes them from whole tensors) and computes what the
meshless step computes:

* the FL axes by explicit collectives: each rank holds its own
  ``[E/pod, C/data, ...]`` slots and runs local SGD on them only; HieAvg
  at the edge (a sum over C) ends in an all-reduce over ``data``, at the
  leader (a sum over E) in one over ``pod``, as the reference's docstring
  says, and the global model goes into the local slots;
* the ``model`` axis (and, for one client a pod or serving, FSDP of
  ``embed`` over ``data``) as DTensors: each client slot is a DTensor on
  the sub-mesh of those axes, the unchanged model code runs on it, and
  the reference's hints (``_set_moe_hint``, ``act_spec``) are worked out
  once a step (``step_hints``) and applied as explicit redistributions
  (``models.hints``); the flash kernels run on each rank's shard
  (``kernels.ops.flash_attention_sharded``).  The model code reads the
  hints from one slot of the process (autograd's device thread must see
  them), so a process runs one mesh step at a time: a second step
  entered while one runs, from another thread, raises.

Layout A (train): every parameter leaf is ``[E, C, *shape]``: E edges
(pods), C clients an edge.  One ``make_hfl_train_step`` step is

  1. per-client local SGD: each client's gradient of its own slot, then
     the update of that slot (the reference vmaps all gradients, then all
     updates; each update reads only its own gradient, so the two agree);
  2. HieAvg edge aggregation over the C clients of each edge;
  3. HieAvg global aggregation over the E edges on the leader;
  4. the global model broadcast into every client slot (or, without the
     global step, each edge's model into its clients' slots).

The port updates the parameters and both histories in place, and walks
the aggregation one piece at a time (each unit of a stacked leaf apart,
each layer of the encoder's, and a large unstacked leaf in blocks of rows):
the math is elementwise, so the result is the reference's, and the float32
temporaries stay one piece large.  Histories are ``core.hieavg.History``
with flat leaves keyed by the parameter's path (``"unit/0/ffn/gate"``).

Layout B (serve, and ``make_train_step``): plain parameter dicts.
"""
from __future__ import annotations

import math
import sys

import torch

from repro_torch.core import hieavg
from repro_torch.core.hieavg import History
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import hints
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import decode_step, loss_fn, prefill
from repro_torch.optim.sgd import OptState, sgd_leaf, sgd_step

f32 = torch.float32


def flatten(tree: dict, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: dict) -> dict:
    """The nested dict of ``flatten``'s keys."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


#: the stacked leaves' prefixes: the decoder's units, the encoder's layers
STACKED = ("unit/", "encoder/unit/")
#: the most elements of one slot an unstacked leaf's piece spans: a larger
#: leaf goes in blocks of rows (recurrentgemma's tied 256000 x 4096
#: embedding, whose float32 temporaries over two clients would be 8.4 GB
#: each); the tail's layers and every unit stay whole
PIECE_ELEMS = 1 << 26


def _pieces(flat: dict, lead: int) -> list:
    """(key, index) pieces of ``[*lead axes, ...]`` leaves: a stacked leaf
    (``STACKED``, its unit axis after the lead axes) one unit at a time,
    an unstacked leaf of more than ``PIECE_ELEMS`` elements a slot in
    blocks of rows, any other leaf whole."""
    out, every = [], (slice(None),) * lead
    for k, v in flat.items():
        if k.startswith(STACKED):
            out += [(k, every + (u,)) for u in range(v.shape[lead])]
            continue
        size = math.prod(v.shape[lead:])
        if size <= PIECE_ELEMS:
            out.append((k, every))
            continue
        rows = max(1, PIECE_ELEMS * v.shape[lead] // size)
        out += [(k, every + (slice(r, r + rows),))
                for r in range(0, v.shape[lead], rows)]
    return out


def _micro(t: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a ``[b, ...]`` batch: its rows ``[i b/n,
    (i + 1) b/n)``; for a DTensor split on its rows, those of each rank's
    own rows (no row moves between ranks)."""
    if n == 1:
        return t
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is not None and isinstance(t, dt.DTensor):
        loc = t.to_local()
        mb = loc.shape[0] // n
        return dt.DTensor.from_local(loc[i * mb:(i + 1) * mb],
                                     t.device_mesh, t.placements,
                                     run_check=False)
    mb = t.shape[0] // n
    return t[i * mb:(i + 1) * mb]


def _client_grads(slot: dict, tokens, labels, cfg: ArchConfig, *,
                  memory=None, remat: bool, n_micro: int, kernel_mode: str,
                  to_local=None):
    """(loss, flat gradients) of one client's ``[b, S]`` batch (and its raw
    memory ``[b, *memory shape]``, or None) against its parameter slot
    (detached leaves).  ``n_micro`` > 1: the mean over microbatches of
    ``b // n_micro`` rows, accumulated in float32.  ``to_local(key, g)``
    (DTensor leaves): each gradient at its parameter's placements, local,
    taken before it is accumulated, so that the accumulator is as split as
    the weights and never gathers one."""
    leaves = {k: v.detach().requires_grad_() for k, v in
              flatten(slot).items()}
    tree = unflatten(leaves)
    put = to_local or (lambda k, g: g)

    def one(i):
        tok, lab, mem = (None if t is None else _micro(t, i, n_micro)
                         for t in (tokens, labels, memory))
        loss = loss_fn(tree, tok, lab, cfg, memory_embeds=mem, remat=remat,
                       kernel_mode=kernel_mode)
        return loss, [put(k, g) for k, g in zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))]

    if n_micro == 1:
        loss, grads = one(0)
        return loss.detach(), dict(zip(leaves, grads))
    loss_acc = None
    acc = {}
    for i in range(n_micro):
        loss, grads = one(i)
        loss_acc = loss.detach() if loss_acc is None else \
            loss_acc + loss.detach()
        for k, g in zip(leaves, grads):
            if k not in acc:
                acc[k] = torch.zeros(g.shape, dtype=f32, device=g.device)
            acc[k] += g
    inv = 1.0 / n_micro
    return loss_acc * inv, {k: g * inv for k, g in acc.items()}


def _sgd_(w: torch.Tensor, g: torch.Tensor, lr: torch.Tensor) -> None:
    """``w <- (w - lr g)`` in float32, cast back to w's dtype, in place."""
    w.copy_(sgd_leaf(w, g, lr))


def _sub(h: History, idx: tuple, key: str) -> History:
    """One piece of a history: its leaves at ``idx`` (views), the counts
    at ``idx``'s first entry (an edge, or every edge)."""
    return History(prev_w={key: h.prev_w[key][idx]},
                   delta_mean={key: h.delta_mean[key][idx]},
                   n_obs=h.n_obs[idx[0]], miss_count=h.miss_count[idx[0]])


def _store_(h: History, idx: tuple, key: str, new: History) -> None:
    h.prev_w[key][idx].copy_(new.prev_w[key])
    h.delta_mean[key][idx].copy_(new.delta_mean[key])


def _advance_counts_(h: History, mask: torch.Tensor) -> None:
    m = mask.to(f32)
    h.n_obs.add_(m)
    h.miss_count.copy_((h.miss_count + 1.0) * (1.0 - m))


def _wide(mesh) -> bool:
    """Whether ``mesh`` has an axis above 1 (the sharded path)."""
    return mesh is not None and any(n > 1 for n in
                                    mesh_shape(mesh).values())


def _local_tree(tree):
    """A tree's DTensors as their local tensors (views), the rest as it
    is."""
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is not None and isinstance(tree, dt.DTensor):
        return tree.to_local()
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_local_tree(v) for v in tree)
    if isinstance(tree, History):
        return _local_history(tree, _local_tree)
    return tree


def _has_dtensor(tree) -> bool:
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is None:
        return False
    if isinstance(tree, dt.DTensor):
        return True
    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_has_dtensor(v) for v in tree)
    if isinstance(tree, History):
        return _has_dtensor((tree.prev_w, tree.delta_mean, tree.n_obs))
    return False


def _one_rank(step, mesh, state):
    """``step`` as it is, or on a mesh of extent 1 on every axis taking any
    DTensor arguments' local tensors (each the whole tensor: the meshless
    step, whose in-place updates reach the DTensors); ``state(args, out)``
    gives the outputs back with the DTensor trees updated in place."""
    if mesh is None or _wide(mesh):
        return step

    def local(*args, **kw):
        if not _has_dtensor((args, kw)):
            return step(*args, **kw)
        return state(args, step(*_local_tree(args), **_local_tree(kw)))

    return local


def _dtensor():
    import torch.distributed.tensor as dt
    return dt


def step_hints(cfg: ArchConfig, mesh, *, train: bool):
    """(``models.hints.Hints``, the mesh they act on) of a step on
    ``mesh``: the reference's ``_set_moe_hint`` choices and, for training,
    its ``act_spec``, as state of the step.

    * ``experts``: the expert all-to-all where the experts divide ``model``;
    * ``heads``: q, k, v split on heads where the q heads divide ``model``
      and the kv heads do too (or the layer is MLA, whose per-head K
      is made on the rank);
    * ``kv_gather``: K/V gathered once a layer where the q heads do not
      divide ``model`` (not for MLA);
    * ``seq`` (training): the residual stream's sequence over ``model``,
      and its batch over ``data`` for one client a pod.

    A train step's model DTensors live on ``model`` (and ``data`` for one
    client a pod: FSDP of ``embed``), since ``pod`` and ``data`` carry the
    FL dims; a serve step's on the whole mesh.  None where no such axis is
    above 1."""
    shape = mesh_shape(mesh)
    m = shape.get("model", 1)
    flags = hint_flags(cfg, m)
    if train:
        names = tuple(a for a in (("data",) if cfg.clients_per_pod == 1
                                  else ()) + ("model",)
                      if shape.get(a, 1) > 1)
        if not names:
            return None, None
        sub = mesh[names if len(names) > 1 else names[0]]
    else:
        names, sub = tuple(mesh.mesh_dim_names), mesh
    model = names.index("model") if "model" in names and m > 1 else None
    data = names.index("data") if "data" in names and \
        shape["data"] > 1 else None
    seq = None
    if train and model is not None:
        dt = _dtensor()
        seq = tuple(dt.Shard(1) if a == "model" else dt.Shard(0)
                    for a in names)
    return hints.Hints(mesh=sub, model=model, data=data, seq=seq,
                       fsdp=data is not None, **flags), sub


def hint_flags(cfg: ArchConfig, model: int) -> dict:
    """The reference's ``_set_moe_hint`` choices on a ``model`` axis of
    that extent: ``heads`` (``HEAD_SPEC``), ``kv_gather``
    (``KV_GATHER_SPEC``), ``experts`` (``EXPERT_PARALLEL_SPEC``)."""
    kv_ok = cfg.mla is not None or cfg.n_kv_heads % model == 0
    heads = model > 1 and cfg.n_heads % model == 0 and kv_ok
    return {"heads": heads,
            "kv_gather": (model > 1 and not heads and cfg.mla is None
                          and cfg.n_heads % model != 0),
            "experts": (model > 1 and cfg.moe is not None
                        and cfg.moe.n_experts % model == 0)}


class _Shards:
    """A train step's view of its DTensors on ``mesh``: each leaf's local
    ``[E/pod, C/data, ...]`` slots (never indexed as a DTensor along a
    split FL dim, which would gather the whole stack), each client slot as
    a DTensor on the step's sub-mesh, and the FL axes' all-reduces."""

    def __init__(self, mesh, sub):
        self.mesh, self.sub = mesh, sub
        names = list(mesh.mesh_dim_names)
        self.sub_dims = [names.index(a) for a in
                         (sub.mesh_dim_names if sub is not None else ())]
        shape = mesh_shape(mesh)
        self.groups = {a: mesh.get_group(a) for a in ("pod", "data")
                       if shape.get(a, 1) > 1}
        self.inner = {}

    def note(self, key: str, t) -> None:
        """Record leaf ``key``'s inner placements on the sub-mesh: its
        placement on each sub-mesh dim, the two FL dims dropped."""
        if self.sub is None:
            return
        dt = _dtensor()
        pl = []
        for d in self.sub_dims:
            p = t.placements[d]
            if p.is_shard():
                if p.dim < 2:
                    raise ValueError(f"{key}: an FL dim split on a model "
                                     f"axis ({t.placements})")
                p = dt.Shard(p.dim - 2)
            pl.append(p if p.is_shard() else dt.Replicate())
        self.inner[key] = tuple(pl)

    def slot(self, key: str, local):
        """Client slot ``local`` (a local tensor) as a DTensor on the
        sub-mesh (plain where there is none)."""
        if self.sub is None:
            return local
        dt = _dtensor()
        return dt.DTensor.from_local(local, self.sub, self.inner[key],
                                     run_check=False)

    def batch(self, local, split: bool):
        """A client's batch rows: split over ``data`` where one client a pod
        spreads its batch there, else whole on the sub-mesh."""
        if self.sub is None:
            return local
        dt = _dtensor()
        pl = tuple(dt.Shard(0) if split and a == "data" else dt.Replicate()
                   for a in self.sub.mesh_dim_names)
        return dt.DTensor.from_local(local, self.sub, pl, run_check=False)

    def grad(self, key: str, g):
        """A gradient at its parameter's placements, local: a partial sum
        reduced (scattered where the parameter is split)."""
        if self.sub is None:
            return g
        return g.redistribute(self.sub, self.inner[key]).to_local()

    def whole(self, t):
        """A DTensor's value whole on this rank (a pending sum reduced)."""
        return t.full_tensor() if self.sub is not None else t

    def all_reduce(self, t, axis: str):
        """``t`` summed over ``axis`` (in place) where it is split over it
        (None: no axis), by the functional all-reduce (the op the dry-run's
        census counts, on any backend)."""
        if axis in self.groups:
            from torch.distributed import _functional_collectives as funcol
            t.copy_(funcol.all_reduce(t, "sum", self.groups[axis]))
        return t


def _local_history(h: History, local) -> History:
    """``h`` with each leaf's local tensor (views: writes go through)."""
    return History(prev_w={k: local(v) for k, v in h.prev_w.items()},
                   delta_mean={k: local(v) for k, v in h.delta_mean.items()},
                   n_obs=local(h.n_obs), miss_count=local(h.miss_count))


def _weights(mask, miss, n_all: int, gamma0, lam, normalize: bool,
             shards, axis: str) -> torch.Tensor:
    """Part weights ``1/n`` of the local participants of an aggregate over
    ``n_all`` split over ``axis``; with ``normalize`` divided by the sum of
    all coefficients (an all-reduce), so that ``hieavg.aggregate`` without
    normalising gives the normalised eq. (4)/(5)."""
    pw = torch.full(mask.shape, 1.0 / n_all, dtype=f32, device=mask.device)
    if not normalize:
        return pw
    m = mask.to(f32)
    coef = pw * (m + (1.0 - m) * gamma0 * torch.pow(lam, miss + 1.0))
    tot = shards.all_reduce(coef.sum(-1, keepdim=True), axis)
    return pw / torch.clamp(tot, min=1e-12)


def make_hfl_train_step(cfg: ArchConfig, *, gamma0: float = 0.9,
                        lam: float = 0.9, do_global: bool = True,
                        remat: bool = True, normalize: bool = False,
                        mesh=None, n_micro: int = 1,
                        kernel_mode: str = "auto"):
    """Returns step(params, dev_hist, glob_hist, batch, dev_mask,
    edge_mask, lr) -> (params, dev_hist, glob_hist, loss).

    ``params`` leaves [E, C, ...]; ``dev_hist`` leaves [E, C, ...] (per
    edge device histories, counts [E, C]), ``glob_hist`` leaves [E, ...]
    (the edge models' history at the leader, float32, counts [E]), both
    from ``init_fl_histories``.  ``batch``: dict(tokens [E, C, b, S],
    labels [E, C, b, S], and for a model with cross-attention memory
    [E, C, b, *memory shape], the raw embeddings).  ``dev_mask`` [E, C]
    bool; ``edge_mask`` [E] bool; ``lr`` float32 (the paper's decayed
    eta^{t,k}).  ``n_micro`` > 1
    splits each client's batch into microbatches with gradient
    accumulation (a mean): the same SGD math, 1/n_micro the activations.
    The parameters and histories are updated in place and returned;
    ``loss`` is the mean of the clients' losses (float32, 0-dim).

    ``mesh``: None, a mesh of extent 1 on every axis (the same), or a
    ``DeviceMesh`` with an axis above 1: then every argument but ``lr`` is
    a DTensor on it placed by ``launch.inputs.train_input_specs``'s specs,
    and ``loss`` is the mean over every client of every rank."""
    if n_micro < 1:
        raise ValueError(f"n_micro {n_micro} < 1")
    shards = h = None
    if _wide(mesh):
        h, sub = step_hints(cfg, mesh, train=True)
        shards = _Shards(mesh, sub)
    kw = dict(gamma0=gamma0, lam=lam, normalize=normalize)
    # the axis the clients are split over (one client a pod: none; its
    # ``data`` axis splits weights and batch rows instead)
    clients = "data" if cfg.clients_per_pod > 1 else None

    def edge_models(flat, dev_hist, dev_mask, key, idx, c_all):
        """The edge models of one piece: [E_local, ...] float32."""
        w = flat[key][idx]
        out = []
        for e in range(w.shape[0]):
            at = (e, slice(None)) + idx[2:]
            sub_h = _sub(dev_hist, at, key)
            if shards is None:
                agg, new = hieavg.edge_aggregate({key: w[e]}, dev_mask[e],
                                                 sub_h, **kw)
            else:
                pw = _weights(dev_mask[e], sub_h.miss_count, c_all, gamma0,
                              lam, normalize, shards, clients)
                agg, new = hieavg.aggregate({key: w[e]}, dev_mask[e], sub_h,
                                            pw, gamma0, lam)
                shards.all_reduce(agg[key], clients)
            _store_(dev_hist, at, key, new)
            out.append(agg[key])
        return torch.stack(out)

    def step(params, dev_hist, glob_hist, batch, dev_mask, edge_mask, lr):
        local = _local_tree
        flat = flatten(params)
        if shards is not None:
            for k, v in flat.items():
                shards.note(k, v)
        e_all, c_all = dev_mask.shape
        flat = {k: local(v) for k, v in flat.items()}
        hists = (dev_hist, glob_hist)
        dev_hist, glob_hist = (_local_history(x, local) for x in hists)
        tokens, labels = local(batch["tokens"]), local(batch["labels"])
        memory = batch.get("memory")
        memory = None if memory is None else local(memory)
        dev_mask, edge_mask = local(dev_mask), local(edge_mask)
        e_n, c_n = dev_mask.shape
        if tokens.shape[2] % n_micro:
            raise ValueError(f"batch {tokens.shape[2]} not a multiple of "
                             f"n_micro {n_micro}")
        lr = torch.as_tensor(local(lr), dtype=f32, device=dev_mask.device)
        split = cfg.clients_per_pod == 1
        losses = []
        # 1. local SGD, client by client (this rank's slots)
        with hints.use(h):
            for e in range(e_n):
                for c in range(c_n):
                    slot = {k: v[e, c] for k, v in flat.items()}
                    if shards is None:
                        tree, tok, lab = unflatten(slot), tokens[e, c], \
                            labels[e, c]
                        mem = None if memory is None else memory[e, c]
                    else:
                        tree = unflatten({k: shards.slot(k, v)
                                          for k, v in slot.items()})
                        tok, lab = (shards.batch(t[e, c], split)
                                    for t in (tokens, labels))
                        mem = None if memory is None else \
                            shards.batch(memory[e, c], split)
                    loss, grads = _client_grads(
                        tree, tok, lab, cfg, memory=mem, remat=remat,
                        n_micro=n_micro, kernel_mode=kernel_mode,
                        to_local=None if shards is None else shards.grad)
                    losses.append(loss if shards is None
                                  else shards.whole(loss))
                    for k, w in slot.items():
                        _sgd_(w, grads[k], lr)
                    del grads
        # 2.-4. HieAvg at the edges, at the leader, and the broadcast
        for key, idx in _pieces(flat, 2):
            w = flat[key][idx]
            models = edge_models(flat, dev_hist, dev_mask, key, idx, c_all)
            if do_global:
                gidx = (slice(None),) + idx[2:]
                sub_h = _sub(glob_hist, gidx, key)
                if shards is None:
                    j_per_edge = torch.full((e_n,), float(c_n), dtype=f32,
                                            device=dev_mask.device)
                    agg, new = hieavg.global_aggregate(
                        {key: models}, edge_mask, sub_h, j_per_edge, **kw)
                else:
                    pw = _weights(edge_mask, sub_h.miss_count, e_all,
                                  gamma0, lam, normalize, shards, "pod")
                    agg, new = hieavg.aggregate({key: models}, edge_mask,
                                                sub_h, pw, gamma0, lam)
                    shards.all_reduce(agg[key], "pod")
                _store_(glob_hist, gidx, key, new)
                w.copy_(agg[key][None, None].to(w.dtype).expand_as(w))
            else:
                w.copy_(models[:, None].to(w.dtype).expand_as(w))
        _advance_counts_(dev_hist, dev_mask)
        if do_global:
            _advance_counts_(glob_hist, edge_mask)
        loss = torch.stack(losses).mean()
        if shards is not None:
            loss = loss * (e_n * c_n)
            for a in (clients, "pod"):
                shards.all_reduce(loss, a)
            loss = loss / (e_all * c_all)
        return params, hists[0], hists[1], loss

    return _one_rank(step, mesh, lambda a, out: (*a[:3], out[3]))


def init_fl_histories(params: dict) -> tuple[History, History]:
    """(dev_hist, glob_hist) from Layout-A params, the cold boot of Alg. 1:
    the device histories start from a copy of every slot (in the
    parameters' dtype), the leader's from each edge's float32 mean over its
    clients; both with no delta observed."""
    flat = flatten(params)
    dev_hist = hieavg.init_history_batched(
        {k: v.clone() for k, v in flat.items()})
    glob_hist = hieavg.init_history(
        {k: v.to(f32).mean(1) for k, v in flat.items()})
    return dev_hist, glob_hist


def place_fl_state(chunks, specs: dict, mesh):
    """``init_fl_histories``' cold boot of every client slot holding one
    model, as (params, dev_hist, glob_hist) DTensors on ``mesh`` placed by
    ``specs`` (``launch.inputs.train_input_specs``' stand-ins), made from
    ``chunks``: ``(key, this rank's chunk of one slot)`` pairs, taken one
    at a time (``sharding.shard_leaves``).  A rank fills its own
    ``[E/pod, C/data]`` slots with its chunk, and takes the leader's
    float32 mean over all C clients from it too (every slot holds the
    same model), so no leaf is ever whole and no data moves."""
    from repro_torch.launch import sharding as shd
    c_all = specs["dev_mask"].shape[1]
    sp = flatten(specs["params"])
    dev, glob = specs["dev_hist"], specs["glob_hist"]

    def put(local, stand):
        return shd.from_local(local, stand, mesh)

    params, d_prev, d_dmean, g_prev, g_dmean = {}, {}, {}, {}, {}
    for k, x in chunks:
        e_l, c_l = shd.local_shape(tuple(sp[k].shape), sp[k].spec, mesh)[:2]
        w = x[None, None].expand(e_l, c_l, *x.shape).contiguous()
        params[k] = put(w, sp[k])
        d_prev[k] = put(w.clone(), dev.prev_w[k])
        d_dmean[k] = put(torch.zeros_like(w), dev.delta_mean[k])
        g = x.to(f32)[None, None].expand(e_l, c_all, *x.shape).mean(1)
        del x, w
        g_prev[k] = put(g, glob.prev_w[k])
        g_dmean[k] = put(torch.zeros_like(g), glob.delta_mean[k])

    def counts(stand, device):
        return put(torch.zeros(shd.local_shape(tuple(stand.shape),
                                               stand.spec, mesh),
                               dtype=f32, device=device), stand)

    at = next(iter(params.values())).device
    return unflatten(params), History(
        prev_w=d_prev, delta_mean=d_dmean, n_obs=counts(dev.n_obs, at),
        miss_count=counts(dev.miss_count, at)), History(
        prev_w=g_prev, delta_mean=g_dmean, n_obs=counts(glob.n_obs, at),
        miss_count=counts(glob.miss_count, at))


def make_train_step(cfg: ArchConfig, remat: bool = True,
                    kernel_mode: str = "auto"):
    """Plain (non-FL) train step for Layout B params, the W/O-stragglers
    oracle: step(params, tokens [B, S], labels [B, S], lr, memory=None)
    -> (new params, loss); ``memory`` the raw memory [B, *memory shape]."""

    def step(params, tokens, labels, lr, memory=None):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten(params).items()}
        loss = loss_fn(unflatten(leaves), tokens, labels, cfg,
                       memory_embeds=memory, remat=remat,
                       kernel_mode=kernel_mode)
        grads = unflatten(dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))))
        new, _ = sgd_step(params, grads, OptState(mu=None, nu=None,
                                                  count=0), lr)
        return new, loss.detach()

    return step


def make_prefill_step(cfg: ArchConfig, kernel_mode: str = "auto", *,
                      mesh=None):
    """(params, tokens [B, S], caches, memory_embeds=None, *, memory=None)
    -> (logits [B, V], caches): the raw memory (encoded inside, as the
    reference's step takes it) or the encoded one (``encode``'s output),
    for a model with cross-attention.  ``mesh``: None, a mesh of extent 1
    on every axis, or a ``DeviceMesh`` with an axis above 1: then every
    tensor argument is a DTensor on it placed by
    ``launch.inputs.serve_input_specs``'s specs (caches filled in place on
    each rank's shard), and the logits are a DTensor."""
    h = step_hints(cfg, mesh, train=False)[0] if _wide(mesh) else None

    def step(params, tokens, caches, memory_embeds=None, *, memory=None):
        with hints.use(h):
            return prefill(params, tokens, cfg, caches,
                           memory_embeds=memory_embeds, memory=memory,
                           kernel_mode=kernel_mode)

    return _one_rank(step, mesh, lambda a, out: (out[0], a[2]))


def make_serve_step(cfg: ArchConfig, mesh=None):
    """One-token decode: (params, token [B, 1], pos, caches, memory=None)
    -> (logits [B, V], caches).  ``pos`` is the current absolute position,
    a host int (the cache holds positions < pos); ``memory`` the *encoded*
    cross-attention memory.  Decode attends through its mask, not the
    flash kernel, so it takes no kernel mode.  ``mesh`` as in
    ``make_prefill_step``: on a cache split on its sequence, only the rank
    holding position ``pos`` writes it."""
    h = step_hints(cfg, mesh, train=False)[0] if _wide(mesh) else None

    def step(params, token, pos, caches, memory=None):
        with hints.use(h):
            return decode_step(params, token, pos, cfg, caches,
                               memory=memory)

    return _one_rank(step, mesh, lambda a, out: (out[0], a[3]))
