"""Copy of ``repro.data.partition`` for the port, which imports nothing of ``repro``.

Keep the two in step: the port's host plane must stay bitwise equal to the
reference (``tests/test_torch_host_plane.py``).

Non-IID partitioners (Sec. 6.1.1, 6.2.1).

``by_class(max_classes)`` reproduces the paper's setting: each local device
owns at most ``max_classes`` image classes ("non_IID_1" = 1 class/device).
``dirichlet`` is the standard LDA partitioner for ablations.  Both return a
list-of-index-arrays per (edge, device) so edges can have inconsistent J_i
(Fig. 4b).

Population-scale variants back ``repro.fl.population``: with a
device *population* far larger than the per-round cohort, materializing one
index array per device is O(population) memory for nothing.  Instead,

  * ``population_classes`` assigns classes to all P devices as one
    vectorized round-robin (same rule as ``by_class``: device ``d`` owns
    ``order[(d * max_classes + m) % n_classes]``) — P × max_classes i32,
    the only O(population) array the store keeps;
  * ``class_pools`` indexes the train split once into per-class pools;
  * ``sample_class_batches`` draws SGD batches for a *cohort* of devices
    directly from their classes' pools — O(cohort × steps × batch) work
    regardless of population size.

Unlike ``by_class`` (disjoint per-class slices), population shards are the
class pools themselves: two devices owning the same class sample from the
same pool (overlapping shards) — the standard cross-device regime where
per-round cohorts resample the population anyway.
"""
from __future__ import annotations

import numpy as np


def population_classes(population: int, n_classes: int, max_classes: int = 1,
                       seed=0) -> np.ndarray:
    """Vectorized round-robin class assignment for a device population.

    Returns ``[population, max_classes]`` i32 — the same assignment rule as
    ``by_class`` (a seed-shuffled class order walked round-robin so every
    class is covered), computed without per-device Python loops.  ``seed``
    may be an int or a ``SeedSequence``.
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_classes)
    d = np.arange(population, dtype=np.int64)[:, None]
    m = np.arange(max_classes, dtype=np.int64)[None, :]
    return order[(d * max_classes + m) % n_classes].astype(np.int32)


def class_pools(labels: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Index ``labels`` into per-class sample pools, once.

    Returns ``(pool, offsets, counts)``: ``pool`` is a flat i32 array of
    sample indices sorted by class, class ``c`` owning the slice
    ``pool[offsets[c] : offsets[c] + counts[c]]``.
    """
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    pool = np.argsort(labels, kind="stable").astype(np.int32)
    counts = np.bincount(labels, minlength=n_classes).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return pool, offsets, counts


def sample_class_batches(pool: np.ndarray, offsets: np.ndarray,
                         counts: np.ndarray, device_classes: np.ndarray,
                         steps: int, batch: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Sample ``[D, steps, batch]`` train indices for a device cohort.

    ``device_classes``: ``[D, M]`` class assignment rows (from
    ``population_classes``, gathered for the cohort occupants).  Each draw
    first picks one of the device's M classes uniformly, then a uniform
    sample (with replacement) from that class's pool — one vectorized pass,
    no per-device loop.  Classes must be non-empty (``counts > 0``); the
    population store validates that once at construction.
    """
    D, M = device_classes.shape
    ci = rng.integers(0, M, size=(D, steps, batch))
    cls = device_classes[np.arange(D)[:, None, None], ci]
    draw = rng.integers(0, np.maximum(counts[cls], 1))
    return pool[offsets[cls] + draw].astype(np.int32)


def by_class(labels: np.ndarray, n_edges: int, j_per_edge: list[int],
             max_classes: int = 1, seed: int = 0) -> list[list[np.ndarray]]:
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    by_c = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idx in by_c:
        rng.shuffle(idx)
    cursor = [0] * n_classes
    total_devices = sum(j_per_edge)
    # round-robin class assignment so all classes are covered across devices
    device_classes = []
    order = rng.permutation(n_classes)
    for d in range(total_devices):
        cls = [int(order[(d * max_classes + m) % n_classes])
               for m in range(max_classes)]
        device_classes.append(cls)
    per_class_share = {c: max(1, len(by_c[c]) // max(
        1, sum(c in dc for dc in device_classes))) for c in range(n_classes)}
    out, d = [], 0
    for e in range(n_edges):
        edge_parts = []
        for _ in range(j_per_edge[e]):
            chunks = []
            for c in device_classes[d]:
                share = per_class_share[c]
                lo = cursor[c]
                cursor[c] = min(lo + share, len(by_c[c]))
                chunks.append(by_c[c][lo:cursor[c]])
            edge_parts.append(np.concatenate(chunks) if chunks else
                              np.empty((0,), np.int64))
            d += 1
        out.append(edge_parts)
    return out


def dirichlet(labels: np.ndarray, n_edges: int, j_per_edge: list[int],
              alpha: float = 0.5, seed: int = 0) -> list[list[np.ndarray]]:
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    total = sum(j_per_edge)
    props = rng.dirichlet(np.full(total, alpha), size=n_classes)  # [C, D]
    device_idx: list[list[np.ndarray]] = [[] for _ in range(total)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        cuts = (np.cumsum(props[c])[:-1] * len(idx)).astype(int)
        for d, part in enumerate(np.split(idx, cuts)):
            device_idx[d].append(part)
    flat = [np.concatenate(p) if p else np.empty((0,), np.int64)
            for p in device_idx]
    out, d = [], 0
    for e in range(n_edges):
        out.append(flat[d:d + j_per_edge[e]])
        d += j_per_edge[e]
    return out
