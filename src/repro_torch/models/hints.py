"""The reference's sharding hints as explicit DTensor redistributions.

The JAX package pins its layout on a mesh with GSPMD constraints that the
launch layer sets as module globals (``repro.launch.steps._set_moe_hint``,
``models.attention.HEAD_SPEC``/``KV_GATHER_SPEC``,
``models.moe.EXPERT_PARALLEL_SPEC``, the train step's ``act_spec``).  The
port's step builders work the same choices out once (``Hints``, state of
the step) and enter them around each call (``use``); the model code calls
the helpers below at the reference's points, and each is the identity
when no hints are entered or its tensor is not a DTensor, so the meshless
path runs exactly as before.

* ``seq``: the residual stream ``[b, s, d]`` with its sequence over
  ``model`` (and its batch over ``data`` for one client a pod), and each
  layer's branch moved there before it is added (``act_spec``, sequence
  parallelism: a row-parallel projection's pending sum becomes a
  reduce-scatter, and its gradient comes back whole); in a serve step the
  stream and each branch with their pending sums reduced (all-reduce).
* ``whole_seq``: the stream gathered whole again, where its positions
  are sliced (the chunked cross-entropy) or mixed (MLA, the MoE blocks,
  the SSD and RG-LRU mixers: their projections, convs and scans run over
  the whole sequence on each rank).
* ``tp_in``: a normed activation gathered on ``model`` before a
  projection whose weight is split over ``model`` (the Megatron SP->TP
  transition; a replicated weight keeps the rows split).
* ``heads``: q, k and v split on their heads over ``model``
  (``HEAD_SPEC``); ``kv_gather``: k and v whole on ``model``, once a layer
  (``KV_GATHER_SPEC``).
* ``blocks``: MoE token blocks each whole on a rank, as the reference
  aligns its blocks with the sequence split.
* ``experts_in``/``experts_out``: the dispatched ``[b, ns, E, cap, d]``
  buffers moved from their token split (blocks, or capacity slots) to the
  expert split and back: the all-to-all (``EXPERT_PARALLEL_SPEC``).
* ``over_pairs``: the MoE combine on each rank's experts or slots, its
  product a part of the sum.
* ``gather_weights``: a layer's weights whole on ``data`` at use (FSDP of
  ``embed`` over ``data``); their gradients go back reduce-scattered.
* ``embed``: a vocab-split table's rows looked up on each rank's slice,
  the sum over ``model`` left pending (``Partial``).
* ``write``/``assign``: cache writes on each rank's own shard: only the
  rank that holds a cache slot writes it (a cache split on its sequence).
* ``split_heads``: a per-head computation with tensors the heads share
  (SSD's chunked scan) on each rank's heads.
* ``per_channel``: a recurrence along the sequence on each rank's rows
  and channels (RG-LRU's scan).
* ``per_head``: a per-head tensor joined with one its heads share (MLA's
  RoPE key) on each rank's heads; ``along_last``: an op along the last
  dim alone on each rank's shard.

Where a flash kernel meets DTensors, ``kernels.ops.flash_attention`` takes
the local shards (``local_map``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


class _Current:
    """The hints entered (``use``), one slot for the process: autograd
    runs a CUDA backward, and a checkpointed unit's recompute, on its own
    device thread, which a context variable would not reach.  So one
    mesh step runs at a time in a process: ``use`` refuses to enter a
    step's hints while another step's are entered (a meshless call made
    inside one sees plain tensors, which every helper passes through)."""

    value = None


@dataclasses.dataclass(frozen=True)
class Hints:
    """One step's layout choices on the mesh its DTensors live on.

    ``model``/``data``: the indices of those mesh dims (None: not in the
    mesh, or of extent 1); ``heads``, ``kv_gather``, ``experts`` the
    reference's three hints; ``seq`` the residual stream's placements
    (None: a serve step's, its pending sums reduced); ``fsdp``: gather
    weights split over ``data`` at use."""

    mesh: object
    model: Optional[int]
    data: Optional[int]
    heads: bool
    kv_gather: bool
    experts: bool
    seq: Optional[tuple]
    fsdp: bool


@contextlib.contextmanager
def use(h: Optional[Hints]):
    """Enter ``h`` (None: no hints) for the model code called inside; plain
    tensors meeting DTensors inside count as replicated."""
    if h is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    if _Current.value is not None and _Current.value != h:
        raise RuntimeError("models.hints.use: another mesh step's hints "
                           "are entered; run one mesh step at a time in a "
                           "process")
    before, _Current.value = _Current.value, h
    try:
        with implicit_replication():
            yield
    finally:
        _Current.value = before


def _dt(x) -> bool:
    if _Current.value is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _with(x, dim: Optional[int], p):
    """``x`` redistributed with mesh dim ``dim``'s placement set to ``p``
    (no-op where it is ``p`` already)."""
    if dim is None or x.placements[dim] == p:
        return x
    pl = list(x.placements)
    pl[dim] = p
    return x.redistribute(x.device_mesh, pl)


def _replicate(x, dim):
    from torch.distributed.tensor import Replicate
    return _with(x, dim, Replicate())


def _split(x, dim, tdim):
    from torch.distributed.tensor import Shard
    return _with(x, dim, Shard(tdim % x.dim()))


def seq(x):
    """The residual stream ``[b, s, d]`` at the step's ``act_spec`` (a dim
    that its mesh dim does not divide stays whole there); without one (a
    serve step), its pending sums reduced, its splits kept."""
    h = _Current.value
    if h is None or not _dt(x):
        return x
    if h.seq is None:
        return reduced(x)
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    pl = tuple(p if not p.is_shard() or x.shape[p.dim] % mesh.shape[i] == 0
               else Replicate() for i, p in enumerate(h.seq))
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def flat_heads(y, n_heads: int):
    """``y`` [..., H, P] flattened to [..., H * P]; along a mesh dim whose
    extent does not divide the ``n_heads`` heads, its gradient is made as
    ``y``'s placements before the view back to [..., H, P] (the output
    projection's gradient arrives split on H * P, which a view cannot
    split into whole heads: mamba2's 24 SSD heads over 16)."""
    out = y.flatten(-2)
    if not _dt(out) or all(n_heads % e == 0 for e in out.device_mesh.shape):
        return out
    return out.redistribute(out.device_mesh, out.placements)


def reduced(x):
    """``x`` with its pending sums reduced, its splits kept: before a view
    that would otherwise scatter a pending sum over a dim its mesh dim does
    not divide (MLA's absorbed decode: minicpm3's 40 heads over 16)."""
    if not _dt(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def whole_seq(x):
    """The residual stream whole on ``model`` again (its sequence split
    gathered), where a caller slices its positions."""
    h = _Current.value
    if h is None or h.seq is None or not _dt(x):
        return x
    return _replicate(x, h.model)


def tp_in(x, *weights):
    """``x`` whole on ``model`` where any of ``weights`` is split there (the
    SP->TP transition before a tensor-parallel projection)."""
    h = _Current.value
    if h is None or not _dt(x) or h.model is None:
        return x
    if any(_dt(w) and w.placements[h.model].is_shard() for w in weights):
        return _replicate(x, h.model)
    return x


def heads(*ts):
    """q, k, v ``[b, s, h, dh]`` split on heads over ``model``
    (``HEAD_SPEC``)."""
    h = _Current.value
    if h is None or not h.heads:
        return ts
    return tuple(_split(t, h.model, 2) if _dt(t) else t for t in ts)


def kv_gather(*ts):
    """k, v whole on ``model`` (``KV_GATHER_SPEC``: one gather a layer)."""
    h = _Current.value
    if h is None or not h.kv_gather:
        return ts
    return tuple(_replicate(t, h.model) if _dt(t) else t for t in ts)


def blocks(x):
    """MoE token blocks ``[b, ns, blk, d]`` each whole on one rank (the
    routing's cumulative count runs along a block): a split of ``blk`` moves
    to the blocks where they divide, else the blocks are gathered."""
    if not _dt(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if not p.is_shard(2) else
          Shard(1) if x.shape[1] % x.device_mesh.shape[i] == 0 else
          Replicate() for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def _token_dim(x) -> Optional[int]:
    """The token dim of a ``[b, ns, E, cap, d]`` buffer that the all-to-all
    starts from: the blocks (1) where the stream is split on them already,
    else the capacity slots (3) where they divide, else None."""
    h = _Current.value
    p = x.placements[h.model]
    if p.is_shard() and p.dim in (1, 3):
        return p.dim
    n = h.mesh.shape[h.model]
    return 3 if x.shape[3] % n == 0 else None


def _all_to_all(x, mdim: int, src: int, dst: int):
    """DTensor ``x`` split on tensor dim ``src`` over mesh dim ``mdim``
    moved to a split on ``dst``: one all-to-all of the local shards (the
    functional collective, on every device type)."""
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    n, group = mesh.shape[mdim], mesh.get_group(mdim)

    def move(t):
        # piece j of this rank's dst dim goes to rank j, which stacks the
        # pieces it gets along src in rank order
        send = torch.stack(t.chunk(n, dim=dst), 0).contiguous()
        sizes = [send[0].numel()] * n
        got = all_to_all_single_autograd(send.flatten(), sizes, sizes, group)
        return torch.cat(got.view(send.shape).unbind(0), dim=src)

    out = list(x.placements)
    out[mdim] = Shard(dst)
    return local_map(move, out_placements=out, in_placements=(
        tuple(x.placements),), device_mesh=mesh)(x)


def experts_in(x):
    """The dispatched buffer moved to its expert split: pinned to its
    token split (a slice where it is whole), then one all-to-all to
    ``Shard(2)`` (``EXPERT_PARALLEL_SPEC``)."""
    h = _Current.value
    if h is None or not h.experts or not _dt(x):
        return x
    t = _token_dim(x)
    if t is None or x.shape[2] % h.mesh.shape[h.model]:
        return _split(x, h.model, 2)
    return _all_to_all(_split(x, h.model, t), h.model, t, 2)


def experts_out(y, like):
    """The experts' output back at ``like``'s token split (the all-to-all
    back)."""
    h = _Current.value
    if h is None or not h.experts or not _dt(y):
        return y
    t = _token_dim(like)
    if t is None or not y.placements[h.model].is_shard(2):
        return y
    return _all_to_all(y, h.model, 2, t)


def over_pairs(fn, comb, eout):
    """``fn(comb, eout)``, the MoE combine ``[b, ns, blk, E, cap] x [b, ns,
    E, cap, d] -> [b, ns, blk, d]``, on each rank's shards where ``eout``
    is a DTensor: ``comb`` split as ``eout`` on its batch, blocks, experts
    or slots, each rank's product over its (expert, slot) pairs a part of
    the sum (``Partial``)."""
    if not _dt(eout):
        return fn(comb, eout)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    epl, cpl, opl = [], [], []
    for p in eout.placements:
        if p.is_shard() and p.dim in (2, 3):      # experts or slots
            epl.append(p)
            cpl.append(Shard(p.dim + 1))
            opl.append(Partial())
        elif p.is_shard() and p.dim in (0, 1):    # batch or blocks
            epl.append(p)
            cpl.append(p)
            opl.append(p)
        else:
            epl.append(Replicate())
            cpl.append(Replicate())
            opl.append(Replicate())
    return local_map(fn, out_placements=opl, in_placements=(
        tuple(cpl), tuple(epl)), device_mesh=eout.device_mesh,
        redistribute_inputs=True)(comb, eout)


def gather_weights(tree):
    """A layer's weights whole on ``data`` (FSDP's all-gather at use)."""
    h = _Current.value
    if h is None or not h.fsdp or h.data is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_weights(v) for k, v in tree.items()}
    return _replicate(tree, h.data) if _dt(tree) else tree


def embed(tab, tokens):
    """``F.embedding(tokens, tab)`` where the table may be split on its
    vocab rows: each rank looks its slice up (rows outside it read 0) and
    the sum over those mesh dims stays pending (``Partial``)."""
    import torch.nn.functional as F
    if not _dt(tab) or not any(p.is_shard(0) for p in tab.placements):
        return F.embedding(tokens, tab)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = tab.device_mesh
    vocab_dims = [i for i, p in enumerate(tab.placements) if p.is_shard(0)]
    tok_pl = tuple(p if isinstance(p, Shard) and i not in vocab_dims
                   else Replicate() for i, p in enumerate(
                       tokens.placements if isinstance(tokens, DTensor)
                       else [Replicate()] * mesh.ndim))
    out_pl = tuple(Partial() if i in vocab_dims else p
                   for i, p in enumerate(tok_pl))
    def lookup(t, ids):
        lo = 0
        for i in vocab_dims:                 # this rank's first row
            n = mesh.shape[i]
            lo = lo * n + mesh.get_local_rank(i)
        lo *= t.shape[0]
        rows = ids - lo
        inside = (rows >= 0) & (rows < t.shape[0])
        out = F.embedding(torch.where(inside, rows, 0), t)
        return out * inside[..., None].to(out.dtype)

    tab_pl = tuple(Shard(0) if i in vocab_dims else Replicate()
                   for i in range(mesh.ndim))
    # the table's gradient is a part of the sum where the tokens are split
    grad_pl = tuple(Shard(0) if i in vocab_dims else
                    Partial() if tok_pl[i].is_shard() else Replicate()
                    for i in range(mesh.ndim))
    return local_map(lookup, out_placements=list(out_pl),
                     in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(tab, tokens)


def per_head(fn, x, shared):
    """``fn(x, shared)`` for ``x`` [b, s, H, d] and ``shared`` [b, s, d']
    broadcast over the heads, on each rank's shards where ``x`` is a
    DTensor: ``x`` with any pending sum reduced, ``shared`` split as ``x``
    on batch and sequence, whole on a heads split (its gradient there a
    part of the sum), the output placed as ``x``."""
    if not _dt(x):
        return fn(x, shared)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    xpl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    pl = tuple(p if p.is_shard() and p.dim < 2 else Replicate()
               for p in xpl)
    grad = tuple(Partial() if p.is_shard() and p.dim >= 2 else q
                 for p, q in zip(xpl, pl))
    return local_map(fn, out_placements=list(xpl),
                     in_placements=(xpl, pl),
                     in_grad_placements=(xpl, grad),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, shared)


def along_last(fn, x):
    """``fn(x)`` for an ``fn`` that acts along the last dim of ``x`` alone
    (MLA's zero-padded values), on each rank's shard of a DTensor ``x``
    whose last dim no placement splits, the output placed as ``x``."""
    if not _dt(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_map(fn, out_placements=list(pl), in_placements=(pl,),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def split_heads(fn, x, heads: tuple, shared: tuple, outs: tuple):
    """``fn(*heads, *shared)`` where each of ``heads`` has a heads dim (the
    dim) and ``shared`` are tensors the heads share (SSD's B and C): on
    each rank's heads where ``x``, one of ``heads``, is a DTensor split on
    its heads dim, the shared tensors whole there (their gradients a part
    of the sum), splits of the batch kept.  ``heads`` is ((tensor, its
    heads dim), ...), ``outs`` each output's heads dim."""
    if not _dt(x):
        return fn(*(t for t, _ in heads), *shared)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    xdim = next(d for t, d in heads if t is x)
    hpl, spl, gpl, opl = [[] for _ in heads], [[] for _ in shared], \
        [[] for _ in shared], [[] for _ in outs]
    for p in x.placements:
        split = p.is_shard() and p.dim == xdim
        batch = p.is_shard(0)
        for lst, (_, d) in zip(hpl, heads):
            lst.append(Shard(d) if split else p if batch else Replicate())
        for lst, g in zip(spl, gpl):
            lst.append(p if batch else Replicate())
            g.append(Partial() if split else p if batch else Replicate())
        for lst, d in zip(opl, outs):
            lst.append(Shard(d) if split else p if batch else Replicate())
    return local_map(fn, out_placements=tuple(opl),
                     in_placements=tuple(map(tuple, hpl + spl)),
                     in_grad_placements=tuple(map(tuple, hpl + gpl)),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(
        *(t for t, _ in heads), *shared)


def per_channel(fn, a, gx, h0):
    """``fn(a, gx, h0) -> (h [b, s, w], h_final [b, w])``, a recurrence
    along the sequence of a, gx [b, s, w] from h0 [b, w] that is
    elementwise across batch rows and channels (RG-LRU's scan; h0 may be
    None), on each rank's rows and channels where ``a`` is a DTensor: a
    split of the sequence is gathered first."""
    if not _dt(a):
        return fn(a, gx, h0)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    seq_pl = tuple(p if p.is_shard() and p.dim != 1 else Replicate()
                   for p in a.placements)
    h_pl = tuple(Shard(1) if p.is_shard(2) else p for p in seq_pl)
    return local_map(fn, out_placements=(list(seq_pl), list(h_pl)),
                     in_placements=(seq_pl, seq_pl,
                                    None if h0 is None else h_pl),
                     device_mesh=a.device_mesh,
                     redistribute_inputs=True)(a, gx, h0)


def _local_values(dst, src):
    """``src`` as a DTensor on ``dst``'s mesh (a plain tensor: whole on
    every rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, dst.device_mesh,
                                 [Replicate()] * dst.device_mesh.ndim,
                                 run_check=False)
    return src


def index_device(cache, device):
    """The device of an index tensor into ``cache``: the host for a DTensor
    cache, whose ``write`` picks each rank's slots there (also where the
    cache lies on the meta device, which holds no values), else
    ``device``."""
    return "cpu" if _dt(cache) else device


def write(cache, dim: int, slots, values) -> None:
    """``cache[..., slots, *rest]`` (``slots`` on dim ``dim`` < 0: a slice
    or a 1-D index tensor on the cache's device) set to ``values``, in
    place.  On a DTensor cache each rank writes its own shard: where the
    cache is split on ``dim``, only the rank holding a slot writes it, from
    the values made whole on that dim (never a DTensor slice assignment)."""
    if not _dt(cache):
        cache[(Ellipsis, slots) + (slice(None),) * (-dim - 1)] = values
        return
    from torch.distributed.tensor import Replicate
    tdim = cache.dim() + dim
    seq_dims = [i for i, p in enumerate(cache.placements)
                if p.is_shard(tdim)]
    pl = [Replicate() if i in seq_dims else p
          for i, p in enumerate(cache.placements)]
    values = _local_values(cache, values).redistribute(cache.device_mesh,
                                                       pl).to_local()
    local = cache.to_local()
    slots = torch.arange(cache.shape[tdim])[slots] \
        if isinstance(slots, slice) else slots.cpu()
    if seq_dims:                  # the slots this rank holds, on the host
        (i,) = seq_dims
        rows = local.shape[tdim]
        lo = cache.device_mesh.get_local_rank(i) * rows
        mine = ((slots >= lo) & (slots < lo + rows)).nonzero()[:, 0]
        values = values.index_select(tdim, mine.to(values.device))
        slots = slots[mine] - lo
    local.index_copy_(tdim, slots.to(local.device), values.to(local.dtype))


def assign(dst, src) -> None:
    """``dst.copy_(src)`` on each rank's shard of a DTensor ``dst`` (``src``
    moved to its placements first)."""
    if not _dt(dst):
        dst.copy_(src)
        return
    src = _local_values(dst, src).redistribute(dst.device_mesh,
                                               dst.placements)
    dst.to_local().copy_(src.to_local())
