"""Copy of ``repro.core.rng`` for the port, which imports nothing of ``repro``.

Keep the two in step: the port's host plane must stay bitwise equal to the
reference (``tests/test_torch_host_plane.py``).

Collision-free RNG stream derivation for the simulator's host-side draws.

The simulator needs several independent randomness streams per deployment
seed — data synthesis, the non-IID partition, per-round batch sampling,
latency jitter, the straggler schedules (one per edge), the Raft chain,
and (population mode) the device-population profiles and cohort sampling.
These used to be derived ad hoc: ``seed + 17 * e`` for edge ``e``'s device
masks, ``seed + 991`` for the edge masks, ``[seed, 0x1A7E]`` for latency
jitter.  Affine offsets collide across (seed, stream) pairs — e.g.
``sim(seed=0)``'s edge-1 device masks were byte-identical to
``sim(seed=17)``'s edge-0 masks — so adjacent-seed grid points silently
shared straggler schedules instead of drawing independently.

Every stream is now derived through ``np.random.SeedSequence`` spawning,
which is designed for collision-free parallel stream derivation: child
sequences differ in their ``spawn_key``, not in arithmetic on the entropy,
so no (seed, stream) pair aliases another.

The ``STREAMS`` registry is **append-only**: each name owns a fixed spawn
position, so adding a stream never re-keys existing ones.  Switching the
derivation scheme was a documented one-time break of the exact draws
behind previously published figures (CHANGES.md) — trajectories change
within seed-to-seed noise, invariants do not.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

#: Append-only registry of named streams.  Position = spawn index.
STREAMS = (
    "data",        # synthetic image generation (class_images)
    "partition",   # non-IID shard assignment (by_class / population classes)
    "batches",     # per-round SGD batch sampling (legacy loop + engine)
    "latency",     # per-device round-time jitter draws
    "edge_masks",  # edge-layer straggler schedule
    "dev_masks",   # device-layer straggler schedules (sub-spawned per edge)
    "chain",       # Raft election/commit timing
    "population",  # device-population profile synthesis
    "cohort",      # per-round cohort sampling
    "faults",      # fault-injection schedules (edge/validator churn, bursts,
    #                message loss) — see repro.fl.faults
)
_POS = {name: i for i, name in enumerate(STREAMS)}


def stream_seq(seed: int, name: str,
               index: Optional[int] = None) -> np.random.SeedSequence:
    """The ``SeedSequence`` for stream ``name`` of deployment ``seed``.

    ``index`` selects a sub-stream (e.g. one per edge for ``dev_masks``)
    via a second spawn level, so per-index streams are as independent of
    each other as the top-level streams are.
    """
    try:
        pos = _POS[name]
    except KeyError:
        raise KeyError(f"unknown RNG stream {name!r}; registered streams: "
                       f"{STREAMS}") from None
    child = np.random.SeedSequence(seed).spawn(len(STREAMS))[pos]
    if index is not None:
        if index < 0:
            raise ValueError(f"stream index must be >= 0, got {index}")
        child = child.spawn(index + 1)[index]
    return child


def stream_seed(seed: int, name: str, index: Optional[int] = None) -> int:
    """A hashable integer seed for stream ``name`` (for seed-keyed caches
    like ``data.synthetic.class_images`` and plain ``seed=`` APIs)."""
    return int(stream_seq(seed, name, index).generate_state(1, np.uint64)[0])


def stream_rng(seed: int, name: str,
               index: Optional[int] = None) -> np.random.Generator:
    """A fresh ``Generator`` on stream ``name`` of deployment ``seed``."""
    return np.random.default_rng(stream_seq(seed, name, index))
