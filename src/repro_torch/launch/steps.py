"""Step builders: hierarchical FL training and serving
(``repro.launch.steps`` for the port).

Plain closures over the config and the kernel mode; the JAX package jits
them and places them on a mesh, the port runs them eagerly on one card.
Each builder takes the reference's ``mesh=``: a mesh whose every axis has
extent 1 computes exactly what no mesh does, and a mesh with an axis
above 1 raises ``NotImplementedError`` (tensor- and FSDP-parallel steps
are not ported; the reference's sharding hints, ``_set_moe_hint``, have
nothing to pin on one card).

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

import torch

from repro_torch.core import hieavg
from repro_torch.core.hieavg import History
from repro_torch.launch.mesh import mesh_shape
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


def _client_grads(slot: dict, tokens, labels, cfg: ArchConfig, *,
                  memory=None, remat: bool, n_micro: int, kernel_mode: str):
    """(loss, flat gradients) of one client's ``[b, S]`` batch (and its raw
    memory ``[b, *memory shape]``, or None) against its parameter slot
    (detached leaves).  ``n_micro`` > 1: the mean over microbatches of
    ``b // n_micro`` rows, accumulated in float32."""
    leaves = {k: v.detach().requires_grad_() for k, v in
              flatten(slot).items()}
    tree = unflatten(leaves)

    def one(rows):
        mem = None if memory is None else memory[rows]
        loss = loss_fn(tree, tokens[rows], labels[rows], cfg,
                       memory_embeds=mem, remat=remat,
                       kernel_mode=kernel_mode)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    if n_micro == 1:
        loss, grads = one(slice(None))
        return loss.detach(), dict(zip(leaves, grads))
    mb = tokens.shape[0] // n_micro
    loss_acc = torch.zeros((), dtype=f32, device=tokens.device)
    acc = {k: torch.zeros(v.shape, dtype=f32, device=v.device)
           for k, v in leaves.items()}
    for i in range(n_micro):
        loss, grads = one(slice(i * mb, (i + 1) * mb))
        loss_acc = loss_acc + loss.detach()
        for k, g in zip(leaves, grads):
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


def _one_card(mesh) -> None:
    """Refuse a mesh the one-card steps cannot honour: any axis above 1."""
    if mesh is None:
        return
    wide = {a: n for a, n in mesh_shape(mesh).items() if n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: the port's LLM steps run on one card; "
            "steps split over a 'model' or 'data' axis are not ported "
            "(ROADMAP.md, Queue 1: tensor- and FSDP-parallel LLM steps)")


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
    ``mesh``: None or a mesh of extent 1 on every axis (``_one_card``)."""
    _one_card(mesh)
    if n_micro < 1:
        raise ValueError(f"n_micro {n_micro} < 1")

    def step(params, dev_hist, glob_hist, batch, dev_mask, edge_mask, lr):
        tokens, labels = batch["tokens"], batch["labels"]
        memory = batch.get("memory")
        e_n, c_n = dev_mask.shape
        if tokens.shape[2] % n_micro:
            raise ValueError(f"batch {tokens.shape[2]} not a multiple of "
                             f"n_micro {n_micro}")
        lr = torch.as_tensor(lr, dtype=f32, device=dev_mask.device)
        flat = flatten(params)
        losses = []
        # 1. local SGD, client by client
        for e in range(e_n):
            for c in range(c_n):
                slot = {k: v[e, c] for k, v in flat.items()}
                loss, grads = _client_grads(
                    unflatten(slot), tokens[e, c], labels[e, c], cfg,
                    memory=None if memory is None else memory[e, c],
                    remat=remat, n_micro=n_micro, kernel_mode=kernel_mode)
                losses.append(loss)
                for k, w in slot.items():
                    _sgd_(w, grads[k], lr)
                del grads
        # 2.-4. HieAvg at the edges, at the leader, and the broadcast
        j_per_edge = torch.full((e_n,), float(c_n), dtype=f32,
                                device=dev_mask.device)
        kw = dict(gamma0=gamma0, lam=lam, normalize=normalize)
        for key, idx in _pieces(flat, 2):
            w = flat[key][idx]
            models = []
            for e in range(e_n):
                at = (e, slice(None)) + idx[2:]
                agg, new = hieavg.edge_aggregate(
                    {key: w[e]}, dev_mask[e], _sub(dev_hist, at, key),
                    **kw)
                _store_(dev_hist, at, key, new)
                models.append(agg[key])
            models = torch.stack(models)
            if do_global:
                gidx = (slice(None),) + idx[2:]
                agg, new = hieavg.global_aggregate(
                    {key: models}, edge_mask,
                    _sub(glob_hist, gidx, key), j_per_edge, **kw)
                _store_(glob_hist, gidx, key, new)
                w.copy_(agg[key][None, None].to(w.dtype).expand_as(w))
            else:
                w.copy_(models[:, None].to(w.dtype).expand_as(w))
        _advance_counts_(dev_hist, dev_mask)
        if do_global:
            _advance_counts_(glob_hist, edge_mask)
        return params, dev_hist, glob_hist, torch.stack(losses).mean()

    return step


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
    for a model with cross-attention.  ``mesh`` as in
    ``make_hfl_train_step``."""
    _one_card(mesh)

    def step(params, tokens, caches, memory_embeds=None, *, memory=None):
        return prefill(params, tokens, cfg, caches,
                       memory_embeds=memory_embeds, memory=memory,
                       kernel_mode=kernel_mode)

    return step


def make_serve_step(cfg: ArchConfig, mesh=None):
    """One-token decode: (params, token [B, 1], pos, caches, memory=None)
    -> (logits [B, V], caches).  ``pos`` is the current absolute position,
    a host int (the cache holds positions < pos); ``memory`` the *encoded*
    cross-attention memory.  Decode attends through its mask, not the
    flash kernel, so it takes no kernel mode.  ``mesh`` as in
    ``make_hfl_train_step``."""
    _one_card(mesh)

    def step(params, token, pos, caches, memory=None):
        return decode_step(params, token, pos, cfg, caches, memory=memory)

    return step
