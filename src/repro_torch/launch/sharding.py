"""Logical-axis -> mesh-axis rules (``repro.launch.sharding`` for the port).

Models annotate parameters with *logical* axis names
(``repro_torch.models.spec.ParamSpec.axes``).  This module maps them to
mesh axes per runtime layout, with the reference's fallback: a logical
axis is sharded only when the dimension is divisible by the mesh-axis
extent and the mesh axis is not already taken by another dimension of
the same tensor, so GQA archs with 8 (or 1) KV heads on a 16-way model
axis fall back to replicated KV projections.

A spec is a tuple of the form of the reference's ``PartitionSpec``: one
entry per tensor dim, each None (replicated), a mesh axis name, or a
tuple of names (the dim sharded over their product, the first the
outermost), trailing Nones trimmed: ``("pod", "data", None, "model")``
trims to itself, ``(None, "model", None)`` to ``(None, "model")``.
``placements`` turns a spec into one DTensor placement per mesh dim for
a ``DeviceMesh``.

Layouts
-------
* ``train`` (Layout A, hierarchical FL): every parameter leaf carries two
  leading FL dims ``[n_pods, clients_per_pod, ...]``, logical axes
  ``fl_pods`` / ``fl_clients``, sharded over ``pod`` / ``data``.  Inner
  dims use tensor-parallel rules over ``model``.
* ``train_fl1`` (grok-scale): one client per pod; the dead ``fl_clients``
  dim frees the ``data`` axis for FSDP over ``embed``.
* ``serve`` (Layout B): no FL dims; 2D weight sharding (``embed`` over
  data, matmul dims over model); activations and caches shard the batch
  over pod + data.

The port's kernel policy (the reference re-exports
``resolve_kernel_mode`` here) lives in ``kernels/dispatch.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.spec import ParamSpec

Spec = tuple
PyTree = Any

# ------------------------------------------------------------------ rules
_TP = {
    "mlp": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "experts": (("model",),),
    "vocab": (("model",),),
    "layers": (),
    "embed": (),
}

TRAIN_RULES = {
    "fl_pods": (("pod",),),
    "fl_clients": (("data",),),
    "act_batch": (),            # per-client batch stays local
    **_TP,
}

# grok-scale: 1 client per pod -> data axis does FSDP over embed instead
TRAIN_RULES_FL1 = {
    "fl_pods": (("pod",),),
    "fl_clients": (),
    "act_batch": (),
    **{**_TP, "embed": (("data",),)},
}

SERVE_RULES = {
    "fl_pods": (),
    "fl_clients": (),
    "act_batch": (("pod", "data"), ("data",)),
    "kv_seq": (("model",),),    # secondary: only if kv_heads can't use it
    **{**_TP, "embed": (("data",),)},
}

# sweep fabric: the stacked grid-point axis of a batched BHFL sweep
# (repro_torch.fl.sweep).  Prefers the full pod x data product when pods
# exist, otherwise the data axis; the divisibility contract applies per
# bucket, so an indivisible bucket runs whole on every rank.  The
# seed-major data plane (``engine.SHARED_DATA_FIELDS``) is not on the
# point axis and stays whole on every rank (``sweep_data_spec``).
SWEEP_RULES = {
    "sweep_points": (("pod", "data"), ("data",)),
}

# logical axes resolved in a second pass, after the primary dims have had
# first pick of the mesh axes (kv_seq takes "model" only when the arch's
# kv_heads count is not divisible by the model-axis extent)
SECONDARY_AXES = frozenset({"kv_seq"})


def train_rules(clients_per_pod: int) -> dict:
    return TRAIN_RULES_FL1 if clients_per_pod == 1 else TRAIN_RULES


def sweep_spec(n_points: int, mesh) -> Spec:
    """Spec of a sweep's stacked point axis on ``mesh``.

    ``()`` (replicated) means the bucket runs whole on every rank: the
    point count divides no candidate mesh axis, or the mesh has no >1
    sweep-capable axis."""
    return resolve_spec((n_points,), ("sweep_points",), SWEEP_RULES, mesh)


def sweep_data_spec() -> Spec:
    """Spec of the sweep fabric's seed-major data plane: replicated.

    The train/test/init arrays of a sweep are stacked over *distinct
    seeds* (``[n_seeds, ...]``), not grid points, and every point gathers
    its row by ``seed_idx`` inside the engine, so every rank holds the
    whole plane."""
    return ()


# ------------------------------------------------------------- resolution
def _axes_size(shape: dict, cand) -> int:
    return math.prod(shape[a] for a in cand) if cand else 1


def resolve_spec(shape: tuple, axes: tuple, rules: dict, mesh) -> Spec:
    """Pick mesh axes per dim: first divisible, unused candidate wins.

    Two passes: primary logical axes first, then SECONDARY_AXES claim
    whatever mesh axes remain (kv_seq fallback for undersized kv_heads).
    """
    extents = mesh_shape(mesh)
    used: set = set()
    out: list = [None] * len(shape)

    def try_dim(i, dim, name):
        for cand in rules.get(name, ()):
            cand = tuple(a for a in cand if a in extents)
            if not cand or any(a in used for a in cand):
                continue
            size = _axes_size(extents, cand)
            if size > 1 and dim % size == 0:
                out[i] = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                return

    for i, (dim, name) in enumerate(zip(shape, axes)):
        if name is not None and name not in SECONDARY_AXES:
            try_dim(i, dim, name)
    for i, (dim, name) in enumerate(zip(shape, axes)):
        if name in SECONDARY_AXES:
            try_dim(i, dim, name)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name, or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape: tuple, spec: Spec, mesh) -> tuple:
    """One rank's shard of a ``shape`` tensor placed by ``spec``: each dim
    divided by the product of the extents its entry names."""
    extents = mesh_shape(mesh)
    return tuple(d // _axes_size(extents, spec_axes(spec[i]))
                 if i < len(spec) else d for i, d in enumerate(shape))


def placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """One DTensor placement per dim of ``mesh``: ``Shard(i)`` on each mesh
    dim that tensor dim i's entry names (a dim over ``("pod", "data")`` is
    ``Shard(i)`` on both), ``Replicate()`` on the others."""
    # imported here: torch.distributed.tensor takes a second to import,
    # and the serve and train drivers never place a DTensor
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def _map_specs(fn, specs: PyTree) -> PyTree:
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def shard_specs(specs: PyTree, rules: dict, mesh,
                prefix: tuple[tuple[int, str], ...] = ()) -> PyTree:
    """ParamSpec tree -> spec tree.

    ``prefix``: extra leading (size, logical_name) dims prepended to every
    leaf: the FL client dims of Layout A.
    """
    pshape = tuple(s for s, _ in prefix)
    paxes = tuple(a for _, a in prefix)
    return _map_specs(lambda s: resolve_spec(pshape + s.shape,
                                             paxes + s.axes, rules, mesh),
                      specs)


def stand_in(shape: tuple, dtype: torch.dtype, spec: Spec, mesh
             ) -> torch.Tensor:
    """A meta-device tensor of the global ``shape`` carrying ``spec``
    (``.spec``): a DTensor on ``mesh`` when it is a ``DeviceMesh``, else a
    plain meta tensor.  Nothing is allocated."""
    shape = tuple(shape)
    if isinstance(mesh, DeviceMesh):
        from torch.distributed.tensor import DTensor
        local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                            device="meta")
        t = DTensor.from_local(local, mesh, placements(spec, mesh),
                               run_check=False, shape=torch.Size(shape),
                               stride=torch.empty(shape, device="meta")
                               .stride())
    else:
        t = torch.empty(shape, dtype=dtype, device="meta")
    t.spec = spec
    return t


def shard_abstract(specs: PyTree, rules: dict, mesh,
                   prefix: tuple[tuple[int, str], ...] = (),
                   dtype=None) -> tuple[PyTree, PyTree]:
    """(stand-in tree, spec tree): a meta-device stand-in (``stand_in``)
    per leaf, the FL prefix dims in its shape, in ``dtype`` (each spec's
    own where None)."""
    pshape = tuple(s for s, _ in prefix)
    shardings = shard_specs(specs, rules, mesh, prefix)

    def one(s: ParamSpec, sh):
        if isinstance(s, ParamSpec):
            return stand_in(pshape + s.shape, dtype or s.dtype, sh, mesh)
        return {k: one(s[k], sh[k]) for k in s}

    return one(specs, shardings), shardings


def batch_axes(mesh) -> tuple:
    """The composite batch axis: ("pod", "data") when pods exist."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def place(tree: PyTree, specs: PyTree, mesh: DeviceMesh) -> PyTree:
    """A tree of whole tensors (dicts, tuples and dataclasses such as
    ``History``) as DTensors on ``mesh``, each placed by its spec in
    ``specs`` (a tree of the same form, or of stand-ins carrying ``.spec``);
    each rank keeps its own chunk of the tensor it holds, so every rank
    must hold the same whole tensors.  No data moves."""
    if isinstance(tree, torch.Tensor):
        from torch.distributed.tensor import distribute_tensor
        spec = specs.spec if isinstance(specs, torch.Tensor) else specs
        return distribute_tensor(tree, mesh, placements(spec, mesh),
                                 src_data_rank=None)
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(place(v, s, mesh) for v, s in zip(tree, specs))
    return dataclasses.replace(tree, **{
        f.name: place(getattr(tree, f.name), getattr(specs, f.name), mesh)
        for f in dataclasses.fields(tree)})


def local_index(shape: tuple, spec: Spec, mesh: DeviceMesh) -> tuple:
    """The slices of a whole ``shape`` tensor that this rank holds when it
    is placed by ``spec`` (``place``'s chunk): a dim over several mesh axes
    split by the outermost mesh dim first, as a DTensor splits it."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    extents = mesh_shape(mesh)
    out = []
    for i, d in enumerate(shape):
        axes = spec_axes(spec[i]) if i < len(spec) else ()
        idx, n = 0, 1
        for a in mesh.mesh_dim_names:
            if a in axes:
                idx, n = idx * extents[a] + coord[a], n * extents[a]
        out.append(slice(idx * (d // n), (idx + 1) * (d // n)))
    return tuple(out)


def from_local(local: torch.Tensor, stand: torch.Tensor,
               mesh: DeviceMesh):
    """This rank's chunk ``local`` of the tensor a stand-in describes (its
    global shape and ``.spec``) as a DTensor on ``mesh``.  No data moves."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(stand.shape)
    return DTensor.from_local(local, mesh, placements(stand.spec, mesh),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def shard_leaves(leaves, specs: dict, mesh: DeviceMesh, *, lead: int = 0,
                 device=None, dtype=None):
    """Each rank's chunks of a model made one leaf at a time, never whole:
    for each ``(key, whole tensor)`` that ``leaves`` yields, this rank's
    chunk of it, where ``specs[key]`` places a tensor of ``lead`` more
    leading dims (the FL dims: each rank's chunk of a slot), copied to
    ``device`` in ``dtype`` (each the whole tensor's where None).  Yields
    ``(key, chunk)``; the whole tensor is dropped before the next is
    drawn, so a rank holds its chunks and one whole leaf at the most.
    A chunk equals ``place``'s of the whole tree bitwise: the cast is
    elementwise, so cutting before it changes no bit."""
    for key, full in leaves:
        spec = tuple(specs[key])[lead:]
        chunk = full[local_index(tuple(full.shape), spec, mesh)]
        chunk = chunk.to(device=device or full.device,
                         dtype=dtype or full.dtype, copy=True,
                         memory_format=torch.contiguous_format)
        del full
        yield key, chunk


def whole(tree: PyTree) -> PyTree:
    """``place``'s inverse: every DTensor of a tree gathered whole on every
    rank (``full_tensor``); plain tensors as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.full_tensor() if hasattr(tree, "full_tensor") else tree
    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(whole(v) for v in tree)
    return dataclasses.replace(tree, **{
        f.name: whole(getattr(tree, f.name))
        for f in dataclasses.fields(tree)})
