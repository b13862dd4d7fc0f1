"""Step-indexed, atomic checkpoints of nested tensor state, in numpy files.

Port of ``repro.checkpoint.ckpt``.  Layout: ``<dir>/step_<n>.npz`` holds
the flattened leaves under their ``|``-joined key paths, with an optional
JSON sidecar ``step_<n>.json`` of metadata.  Both are written to a
``mkstemp`` file and renamed into place, so a writer killed half way never
leaves a torn checkpoint behind.

A tree is nested dicts and dataclasses (``EngineCarry``, ``History``)
whose leaves are tensors or numpy arrays.  Tensors are stored as numpy
arrays: bfloat16 as its ``uint16`` bits and float8_e4m3fn as its
``uint8`` bits (npz has no such dtypes), so every value round-trips
exactly.  ``restore_checkpoint`` rebuilds the structure of a ``like``
tree, checks keys, shapes and dtypes against it, and puts each tensor on
the device of its ``like`` leaf.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

_SEP = "|"

#: tensor dtypes stored as the bits of an unsigned integer of their width
_BITS = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8}


def _items(tree: Any) -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) pairs in the tree's own order."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix, tree)]
    out = []
    for k, v in _items(tree):
        out += _leaves(v, f"{prefix}{_SEP}{k}" if prefix else k)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, np.ndarray):
        return leaf
    t = leaf.detach().cpu()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy()


def _rebuild(like: Any, values: dict, prefix: str = "") -> Any:
    if isinstance(like, (torch.Tensor, np.ndarray)):
        return values[prefix]
    kids = {k: _rebuild(v, values, f"{prefix}{_SEP}{k}" if prefix else k)
            for k, v in _items(like)}
    if isinstance(like, dict):
        return {k: kids[str(k)] for k in like}
    return dataclasses.replace(like, **kids)


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    """Write ``tree`` as ``step_<step>.npz`` (and ``metadata`` as its JSON
    sidecar) in ``directory``; returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    flat = {k: _to_numpy(v) for k, v in _leaves(tree)}
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    if metadata is not None:
        fd, mtmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(metadata, f)
        os.replace(mtmp, path.replace(".npz", ".json"))
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest step with an npz file in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None
                       ) -> tuple[Any, Optional[dict]]:
    """Load step ``step`` (default: the latest) into the structure of
    ``like``: every key, shape and dtype must match, and each tensor goes
    to its ``like`` leaf's device.  Returns (tree, metadata or None)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.npz")
    want = _leaves(like)
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    keys = [k for k, _ in want]
    if set(stored) != set(keys):
        raise ValueError(f"checkpoint mismatch: missing="
                         f"{set(keys) - set(stored)} extra="
                         f"{set(stored) - set(keys)}")
    values = {}
    for key, leaf in want:
        arr = stored[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, np.ndarray):
            if arr.dtype != leaf.dtype:
                raise ValueError(f"{key}: dtype {arr.dtype} != {leaf.dtype}")
            values[key] = arr
            continue
        t = torch.from_numpy(arr)
        if t.dtype != _BITS.get(leaf.dtype, leaf.dtype):
            raise ValueError(f"{key}: stored {arr.dtype} for a {leaf.dtype} "
                             "tensor")
        if leaf.dtype in _BITS:
            t = t.view(leaf.dtype)
        values[key] = t.to(leaf.device)
    mpath = path.replace(".npz", ".json")
    meta = None
    if os.path.exists(mpath):
        with open(mpath) as f:
            meta = json.load(f)
    return _rebuild(like, values), meta
