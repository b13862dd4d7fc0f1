"""Stand-ins for every model input, per (architecture x input shape x mesh)
(``repro.launch.inputs`` for the port).

A stand-in is a meta-device tensor of the input's global shape and dtype
carrying its spec (``.spec``, ``launch.sharding``): a DTensor on the
mesh when ``mesh`` is a ``DeviceMesh``, a plain meta tensor when it is
only a ``.shape`` mapping.  Nothing is allocated.  ``census`` sums one
rank's bytes of a tree of them: what the inputs of an arch x shape take
on each device of a mesh.  ``memory_shape`` is the shape of the stubbed
modality frontend's output that cross-attention reads.

The trees are the port's step inputs: ``train_input_specs`` those of
``steps.make_hfl_train_step`` (histories are ``core.hieavg.History``
with flat leaves keyed by the parameter's path, as ``init_fl_histories``
makes them), ``serve_input_specs`` those of ``make_prefill_step`` /
``make_serve_step``.  Dtypes are the reference's: histories in the
parameters' dtype (``HIST_DTYPE`` None), tokens int32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.hieavg import History
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import mesh_axis_size, mesh_shape
from repro_torch.launch.steps import flatten
from repro_torch.models import cache_specs, param_specs
from repro_torch.models.config import ArchConfig, InputShape

PyTree = Any


def memory_shape(cfg: ArchConfig) -> Optional[tuple[int, int]]:
    """(frames, d_model) of the stubbed modality frontend, if any: the
    encoder's input frames (enc-dec), or the VLM's patch embeddings."""
    if cfg.encoder is not None:
        return cfg.encoder.n_frames, cfg.d_model
    if "xattn" in cfg.block_pattern:
        return cfg.n_image_tokens, cfg.d_model
    return None


def fl_dims(cfg: ArchConfig, shape: InputShape, mesh) -> tuple[int, int, int]:
    """(E pods, C clients a pod, per-client batch): E is the mesh's pod
    extent, C the config's ``clients_per_pod``."""
    e = mesh_axis_size(mesh, "pod")
    c = cfg.clients_per_pod
    b = max(shape.global_batch // (e * c), 1)
    return e, c, b


# ------------------------------------------------------------------ train
# History storage dtype override (float8_e4m3fn halves HieAvg's
# 4-extra-model-copies cost); None = parameter dtype.
HIST_DTYPE = None


def train_input_specs(cfg: ArchConfig, shape: InputShape, mesh, *,
                      edges: Optional[int] = None) -> dict:
    """Inputs of ``make_hfl_train_step``'s step function (Layout A).
    ``edges``: E where it is not the mesh's pod extent (``fl_dims``), a
    multiple of it (a mesh without ``pod`` holds every edge on each rank)."""
    if shape.kind != "train":
        raise ValueError(f"not a train shape: {shape}")
    e, c, b = fl_dims(cfg, shape, mesh)
    if edges is not None:
        e, b = edges, max(shape.global_batch // (edges * c), 1)
    rules = shd.train_rules(cfg.clients_per_pod)
    prefix = ((e, "fl_pods"), (c, "fl_clients"))
    dt = cfg.torch_param_dtype
    hdt = HIST_DTYPE or dt
    specs = param_specs(cfg)

    def tree(pre, dtype):
        return shd.shard_abstract(specs, rules, mesh, prefix=pre,
                                  dtype=dtype)[0]

    pod_ax = "pod" if "pod" in mesh_shape(mesh) else None
    cli_ax = "data" if cfg.clients_per_pod > 1 else None
    bat_ax = "data" if cfg.clients_per_pod == 1 else None

    def sds(shp, dtype, spec):
        return shd.stand_in(shp, dtype, _trim(spec), mesh)

    tok = (e, c, b, shape.seq_len)
    batch = {"tokens": sds(tok, torch.int32, (pod_ax, cli_ax, bat_ax)),
             "labels": sds(tok, torch.int32, (pod_ax, cli_ax, bat_ax))}
    mem = memory_shape(cfg)
    if mem is not None:
        batch["memory"] = sds((e, c, b) + mem, dt, (pod_ax, cli_ax, bat_ax))

    def hist_of(pre, n_shape, n_spec):
        return History(prev_w=flatten(tree(pre, hdt)),
                       delta_mean=flatten(tree(pre, hdt)),
                       n_obs=sds(n_shape, torch.float32, n_spec),
                       miss_count=sds(n_shape, torch.float32, n_spec))

    return dict(
        params=tree(prefix, dt),
        dev_hist=hist_of(prefix, (e, c), (pod_ax, cli_ax)),
        glob_hist=hist_of(prefix[:1], (e,), (pod_ax,)),
        batch=batch,
        dev_mask=sds((e, c), torch.bool, (pod_ax, cli_ax)),
        edge_mask=sds((e,), torch.bool, (pod_ax,)),
        lr=sds((), torch.float32, ()),
    )


def _trim(spec: tuple) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


# ------------------------------------------------------------------ serve
def serve_param_specs(cfg: ArchConfig, mesh) -> PyTree:
    return shd.shard_abstract(param_specs(cfg), shd.SERVE_RULES, mesh,
                              dtype=cfg.torch_param_dtype)[0]


def serve_input_specs(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """Inputs of the prefill step (kind "prefill") or the decode step
    (kind "decode")."""
    b = shape.global_batch
    dt = cfg.torch_param_dtype
    caches, _ = shd.shard_abstract(cache_specs(cfg, b, shape.seq_len,
                                               dtype=dt),
                                   shd.SERVE_RULES, mesh)
    bspec = shd.resolve_spec((b,), ("act_batch",), shd.SERVE_RULES, mesh)
    bax = bspec[0] if bspec else None

    def sds(shp, dtype):
        return shd.stand_in(shp, dtype, _trim((bax,)), mesh)

    out = dict(params=serve_param_specs(cfg, mesh), caches=caches)
    if shape.kind == "prefill":
        out["tokens"] = sds((b, shape.seq_len), torch.int32)
    else:
        out["token"] = sds((b, 1), torch.int32)
        out["pos"] = shd.stand_in((), torch.int32, (), mesh)
    mem = memory_shape(cfg)
    if mem is not None:
        # decode consumes *pre-encoded* memory (the encoder runs at prefill)
        out["memory"] = sds((b,) + mem, dt)
    return out


def input_specs(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    if shape.kind == "train":
        return train_input_specs(cfg, shape, mesh)
    return serve_input_specs(cfg, shape, mesh)


# -------------------------------------------------------- output shardings
def leaves(tree: PyTree) -> list:
    """The tensors of a tree of dicts, tuples, lists and ``History``s, in
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in leaves(getattr(tree, f.name))]
    raise TypeError(f"not a tree of tensors: {type(tree)}")


def _spec_like(tree: PyTree) -> PyTree:
    """The spec tree of a tree of stand-ins."""
    if isinstance(tree, torch.Tensor):
        return tree.spec
    if isinstance(tree, dict):
        return {k: _spec_like(v) for k, v in tree.items()}
    return dataclasses.replace(tree, **{
        f.name: _spec_like(getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


def output_shardings(cfg: ArchConfig, shape: InputShape, mesh):
    """The specs of the step's outputs: (params, dev_hist, glob_hist, loss)
    for a train shape, (logits, caches) for a serve shape.  Each state
    output keeps its input's spec, so the global model broadcast back into
    the [E, C] client slots stays sharded as the slots are."""
    specs = input_specs(cfg, shape, mesh)
    if shape.kind == "train":
        return (_spec_like(specs["params"]), _spec_like(specs["dev_hist"]),
                _spec_like(specs["glob_hist"]), ())
    b = shape.global_batch
    logits = shd.resolve_spec((b, cfg.vocab), ("act_batch", "vocab"),
                              shd.SERVE_RULES, mesh)
    return logits, _spec_like(specs["caches"])


# ------------------------------------------------------------------ census
def census(tree: PyTree, mesh) -> int:
    """One rank's bytes of a tree of stand-ins: each leaf's global shape
    divided by the extents its spec names, times its item size."""
    return sum(math.prod(shd.local_shape(tuple(t.shape), t.spec, mesh))
               * t.element_size() for t in leaves(tree))
