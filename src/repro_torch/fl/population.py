"""Copy of ``repro.fl.population`` for the port, which imports nothing of
``repro``.

Keep the two in step: the port's host plane must stay bitwise equal to the
reference (``tests/test_torch_population.py``).  The store is host data
(numpy) and never moves to the device: the only O(population) state of a
run; every array the engine puts on the card is cohort-sized.

Population-scale device plane: a store of [population] device profiles
from which each round gathers a sampled cohort ``[N, J_cohort]`` by index.

The paper's experiments cap at N × J of a few hundred devices because the
simulator materializes every device.  The ROADMAP north star is millions of
users — which requires decoupling the device *population* (who exists) from
the per-round *cohort* (who trains).  This module supplies the population
side:

  * ``DevicePopulation`` — a seed-major store of per-device profiles sized
    ``[population]``: the non-IID class assignment (its data shard — see
    ``data.partition.population_classes``), a per-device straggler
    propensity ``miss_prob`` (Beta-distributed around the spec mean, so the
    population is heterogeneous like a real fleet), and a per-device
    round-``time_scale`` multiplier (lognormal, mean 1; > 1 = slower
    device) feeding the latency fabric.
    These P-sized profile rows are the ONLY O(population) state anywhere;
    everything the engine touches is gathered per round.

  * cohort sampling — ``cohort_ids(T, n_edges, seed)`` draws the occupant
    of every device slot for every global round, with replacement, in
    O(T × cohort) work.  This extends the seed-deduped gather trick the
    sweep data plane already plays (gather rows by index instead of
    materializing copies): per-round randomness (straggler draws, batch
    sampling, latency jitter) is keyed by SLOT, and the occupant's profile
    is gathered into the slot — so device memory and per-round work scale
    with cohort size, not population size (``chip_smoke.py``'s
    ``population`` lines print the card's rounds/s and peak memory at
    10³ and 10⁶ devices).

Resampling policies (``PopulationSpec.resample``):
  * ``"round"``  — a fresh cohort every global round (the cross-device FL
    default; within a round the cohort is fixed across the K edge rounds);
  * ``"static"`` — one cohort drawn at round 0 and kept for the whole run;
  * ``"full"``   — the identity cohort (requires ``population == N × J``):
    every device participates every round.  This is the bridge to the
    fixed-membership simulator — and the parity lever:
    ``store.subset(ids)`` materializes the sampled rows as a small
    ``"full"``-mode population whose run is bitwise-identical to the
    gathered cohort's (tests/test_torch_population.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import partition

_RESAMPLE = ("round", "static", "full")


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """Shape and profile distribution of a device population."""

    size: int                  # P — number of devices that exist
    j_cohort: int              # devices gathered per edge per round
    resample: str = "round"    # "round" | "static" | "full"
    miss_frac: float = 0.2     # population-mean straggle probability
    miss_conc: float = 8.0     # Beta concentration (higher = homogeneous)
    speed_sigma: float = 0.25  # lognormal sigma of time_scale (mean 1)

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"population size must be >= 1, got {self.size}")
        if self.j_cohort < 1:
            raise ValueError(f"j_cohort must be >= 1, got {self.j_cohort}")
        if self.resample not in _RESAMPLE:
            raise ValueError(f"resample must be one of {_RESAMPLE}, "
                             f"got {self.resample!r}")
        if not 0.0 <= self.miss_frac <= 1.0:
            raise ValueError("miss_frac must be in [0, 1]")


class DevicePopulation:
    """Seed-major store of ``[population]`` device profiles.

    Profiles are synthesized from three independent sub-streams of the
    given seed (class assignment, miss propensity, speed), so growing the
    population or adding a profile field never re-keys the others.
    """

    def __init__(self, spec: PopulationSpec, *, n_classes: int,
                 max_classes: int = 1, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        kids = np.random.SeedSequence(self.seed).spawn(3)
        P = spec.size
        self.classes = partition.population_classes(
            P, n_classes, max_classes, seed=kids[0])      # [P, M] i32
        if spec.miss_frac <= 0.0:
            self.miss_prob = np.zeros(P)
        elif spec.miss_frac >= 1.0:
            self.miss_prob = np.ones(P)
        else:
            a = spec.miss_conc * spec.miss_frac
            b = spec.miss_conc * (1.0 - spec.miss_frac)
            self.miss_prob = np.random.default_rng(kids[1]).beta(a, b, P)
        sig = spec.speed_sigma
        self.time_scale = np.random.default_rng(kids[2]).lognormal(
            mean=-0.5 * sig * sig, sigma=sig, size=P) if sig > 0 \
            else np.ones(P)                           # E[time_scale] = 1

    @property
    def size(self) -> int:
        return self.spec.size

    def cohort_ids(self, t_rounds: int, n_edges: int, seed: int
                   ) -> np.ndarray:
        """Occupant ids ``[T, N, J_cohort]`` for every global round.

        Sampling is with replacement and O(T × N × J) regardless of the
        population size.  ``seed`` should be the deployment's ``"cohort"``
        stream (``core.rng.stream_seed``).
        """
        N, J = n_edges, self.spec.j_cohort
        if self.spec.resample == "full":
            if self.size != N * J:
                raise ValueError(
                    f"resample='full' requires population == N*J_cohort "
                    f"({N}*{J}={N * J}), got {self.size}")
            ids = np.arange(self.size, dtype=np.int64).reshape(N, J)
            return np.broadcast_to(ids, (t_rounds, N, J)).copy()
        rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
        if self.spec.resample == "static":
            ids = rng.integers(0, self.size, size=(N, J))
            return np.broadcast_to(ids, (t_rounds, N, J)).copy()
        return rng.integers(0, self.size, size=(t_rounds, N, J))

    def subset(self, ids: np.ndarray) -> "DevicePopulation":
        """Materialize the profile rows ``ids`` as a ``"full"``-mode
        population of ``len(ids) == N*J`` devices (parity/testing lever:
        a gathered cohort and its materialized subset run identically)."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        sub = object.__new__(DevicePopulation)
        sub.spec = dataclasses.replace(self.spec, size=len(ids),
                                       resample="full")
        sub.seed = self.seed
        sub.classes = self.classes[ids].copy()
        sub.miss_prob = self.miss_prob[ids].copy()
        sub.time_scale = self.time_scale[ids].copy()
        return sub


def as_population(population, j_cohort, *, n_classes: int, max_classes: int,
                  seed: int) -> DevicePopulation:
    """Coerce the simulator's ``population=`` argument into a store.

    Accepts a ready ``DevicePopulation`` (shared across sweep points — the
    store is profile data, the O(P) part, so build it once), a
    ``PopulationSpec``, or a plain int population size (then ``j_cohort``
    must be given).  ``seed`` should be the deployment's ``"population"``
    stream and is only used when the store is built here.
    """
    if isinstance(population, DevicePopulation):
        if j_cohort is not None and j_cohort != population.spec.j_cohort:
            raise ValueError(
                f"j_cohort={j_cohort} conflicts with the population store's "
                f"j_cohort={population.spec.j_cohort}")
        return population
    if isinstance(population, PopulationSpec):
        spec = population
        if j_cohort is not None and j_cohort != spec.j_cohort:
            raise ValueError(f"j_cohort={j_cohort} conflicts with "
                             f"spec.j_cohort={spec.j_cohort}")
    else:
        if j_cohort is None:
            raise ValueError("population given as an int needs an explicit "
                             "j_cohort (devices per edge per round)")
        spec = PopulationSpec(size=int(population), j_cohort=int(j_cohort))
    return DevicePopulation(spec, n_classes=n_classes,
                            max_classes=max_classes, seed=seed)
