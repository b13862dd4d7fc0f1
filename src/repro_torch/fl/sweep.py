"""Sweep fabric — grids of deployments as a few batched runs, split over
the ranks of a mesh.

Port of ``repro.fl.sweep``: the paper's figures are grids (convergence
against straggler fraction, topology N x J x K, non-IID skew, consensus
latency), and a grid runs here as one batched engine run per *shape
bucket*, its points stacked along a leading axis where the reference
``vmap``s them.

  Planner   ``plan_sweep`` classifies the override fields (batched, padded,
            or refused with the field named), groups the points into at
            most ``max_buckets`` shape buckets by the reference's greedy
            merge (``_bucket_points``, decision for decision: with
            ``bucket_cost="proxy"`` the buckets are the reference's; with
            ``"measured"`` a bucket is priced by the seconds of its
            stacked train steps on the card, and a merge the cap does not
            force must save time), and builds every point's
            ``EngineInputs`` padded to its bucket's maxima
            (``engine.build_inputs``), stacked.  The data plane (train/test/init) is seed-deduped: one ``[n_seeds]``
            stack shared by every bucket, gathered per point by
            ``seed_idx`` inside the engine.

  Placement ``execute_plan`` runs each bucket as one ``engine.run_engine``
            over its stack of P points (the conv and SGD kernels over
            D = P·N·J devices, the edge aggregates over B = P·N rows, the
            global ones over B = P); its points are ordered so that those
            taking the same aggregator branch are neighbours, and the
            rows are put back in point order.  On a mesh
            (``launch.mesh.make_sweep_mesh``: one rank a process, each
            computing on ``cuda:{rank % device_count}``) a bucket whose
            point count divides the ``data`` extent
            (``launch.sharding.sweep_spec``) is split: each rank runs a
            contiguous share of the ordered points, and the ``[P, T]``
            rows are all-gathered over a ``gloo`` group (host rows; two
            ranks may share one card, which NCCL refuses); the shared
            data plane stays whole on every rank (``sweep_data_spec``).
            Any other bucket runs whole on every rank.  Rows from a
            bucket of fewer rounds extend by the engine's tail convention
            (accuracy, clock and energy repeat the final value; loss and
            delta are 0).

  Callers   ``run_sweep`` (= ``plan_sweep`` + ``run_plan``) returns a
            ``SweepResult``; ``SweepPlan.describe()`` renders the buckets.

Invariants (the reference's): every point lands in exactly one bucket and
its rows come back in point order; bucketing never changes numerics
(padding is inert); at most ``max_buckets`` buckets (by default the
reference's 4 under the proxy cost, no cap under the measured one), and
voluntary merges keep the padded compute within ``bucket_waste`` of the
no-padding ideal (proxy cost) or lower the measured seconds (measured
cost); the data plane's rows are the distinct seeds in first-appearance
order, the same arrays in every bucket.
"""
from __future__ import annotations

import dataclasses
import time
import types
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.bhfl_cnn import BHFLSetting
from repro_torch.fl.engine import (AGG_SEL, SHARED_DATA_FIELDS, EngineInputs,
                                   build_inputs, run_engine,
                                   train_epoch_body)
from repro_torch.fl.simulator import BHFLSimulator
from repro_torch.launch.mesh import make_sweep_mesh, mesh_shape
from repro_torch.launch.sharding import spec_axes, sweep_spec
from repro_torch.models import cnn_specs

# ------------------------------------------------------- field classification
#: Fields a grid may vary freely: they change data (schedules, decay
#: scalars, batch indices, latency draws, the replayed chain's planes),
#: never array shapes.
BATCHED_FIELDS = frozenset({
    "straggler_frac", "gamma0", "lam", "t_cold_boot", "classes_per_device",
    "lr0", "lr_decay", "permanent_stop_round", "seed",
    "lm_device", "lp_device", "lm_edge", "link_latency", "consensus_mult",
    "consensus", "n_shards",
    "staleness_discount", "delay_delta",
    "edge_fail_rate", "edge_recover_rate", "val_fail_rate",
    "val_recover_rate", "burst_prob", "burst_frac", "msg_loss_prob",
    "max_stall_rounds", "stall_backoff",
})

#: Pseudo-field of an override dict (not a ``BHFLSetting`` field): the
#: point's aggregator.  A single-valued grid plans as that aggregator, a
#: mixed one as ``"switched"``, selected per point by ``agg_sel``.
AGGREGATION_FIELD = "aggregation"

#: Aggregators the ``"switched"`` engine can mix in one stack
#: (``engine.AGG_SEL``); the others are single-valued only.
SWITCHABLE_AGGREGATORS = tuple(sorted(AGG_SEL))

_ALL_AGGREGATORS = ("hieavg", "t_fedavg", "d_fedavg", "delayed_grad",
                    "fedavg")

#: Fields that change array shapes, absorbed by padding every point to its
#: bucket's maxima.
PADDED_FIELDS = frozenset({
    "n_edges", "j_per_edge", "k_edge_rounds", "t_global_rounds",
})

#: Shape-defining fields padding cannot absorb (the model or data geometry
#: itself): a swept value raises, naming the field.
UNSUPPORTED_FIELDS = frozenset({
    "image_hw", "cnn_c1", "cnn_c2", "n_classes", "batch_size",
})


def _validate_overrides(overrides: list[dict]) -> None:
    setting_fields = {f.name for f in dataclasses.fields(BHFLSetting)}
    for ov in overrides:
        for name in ov:
            if name == AGGREGATION_FIELD:
                if ov[name] not in _ALL_AGGREGATORS:
                    raise ValueError(
                        f"run_sweep: unknown aggregation {ov[name]!r}; "
                        f"known aggregators: {_ALL_AGGREGATORS}")
                continue
            if name not in setting_fields:
                raise ValueError(
                    f"run_sweep: {name!r} is not a BHFLSetting field "
                    f"(known fields: {sorted(setting_fields)})")
            if name in UNSUPPORTED_FIELDS:
                raise ValueError(
                    f"run_sweep cannot sweep {name!r}: it changes the "
                    "model/data geometry, which padding cannot absorb. "
                    "Fix it across the grid (pass it via the base setting) "
                    "or run separate sweeps per value. Sweepable shape "
                    f"fields: {sorted(PADDED_FIELDS)}; data fields: "
                    f"{sorted(BATCHED_FIELDS)}.")


# ------------------------------------------------------------ shape buckets
_SHAPE_KEYS = ("t", "k", "n", "j", "steps")


def _vol(ext: dict) -> int:
    """Padded-compute proxy for one point at extents ``ext``: training
    work scales with rounds x devices x steps = t*k*(n*j)*steps (the unit
    of ``padding_stats()``/``point_volume``)."""
    return ext["t"] * ext["k"] * ext["n"] * ext["j"] * ext["steps"]


#: Measured seconds of one train step, keyed (geometry, kernel_mode,
#: device) -> {stacked device count D -> seconds}: repeated plans pay each
#: (geometry, D) timing once per process.
_STEP_TIME_CACHE: dict[tuple, dict[int, float]] = {}


def _measured_step_time(d: int, geom: tuple) -> float:
    """Measured seconds for ONE train step over ``d`` stacked devices.

    ``geom`` = (image_hw, batch_size, c1, c2, n_classes, kernel_mode,
    device).  The first query per (geom, d) runs the engine's inner step
    (``train_epoch_body``: forward, backward and SGD update on zero data,
    through the plan's kernel path) once to warm up, then times two more,
    each to a synchronized end, and keeps the best; later queries hit the
    cache.  The cost is forced strictly increasing in ``d`` (running max
    over cached smaller counts, times ``1 + 1e-6·d``), so timing noise
    cannot make bucketing non-deterministic.
    """
    times = _STEP_TIME_CACHE.setdefault(geom, {})
    if d not in times:
        hw, bs, c1, c2, n_classes, kernel_mode, device = geom
        dev = torch.device(device)
        specs = cnn_specs(hw, 1, n_classes, c1, c2)
        params = {k: torch.zeros((d,) + sp.shape, device=dev)
                  for k, sp in specs.items()}
        images = torch.zeros((d, 1, bs, hw, hw, 1), device=dev)
        labels = torch.zeros((d, 1, bs), dtype=torch.int32, device=dev)

        def step():
            train_epoch_body(params, images, labels, 0.01, kernel_mode)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        step()                                            # warm-up
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            step()
            best = min(best, time.perf_counter() - t0)
        times[d] = best
    mono = max(t for dd, t in times.items() if dd <= d)
    return mono * (1.0 + 1e-6 * d)


def _measured_bucket_cost_fn(geom: tuple, extents: list[dict],
                             step_time=None):
    """Bucketing cost of a bucket as the engine runs it: the measured
    seconds of its train steps.  At global round t and edge round k the
    engine computes only the points still running (``t < t_p``,
    ``k < k_p``), as one stack of ``Pa·n·j`` devices over the bucket's
    ``steps``: padded rounds cost nothing, padded devices and steps their
    share of a step, and a stack pays a step's host time once for all its
    points.  ``step_time(d, geom)`` gives a step's seconds (None:
    ``_measured_step_time``)."""

    def cost(ids: list, ext: dict) -> float:
        ts = np.array([extents[i]["t"] for i in ids])
        ks = np.array([extents[i]["k"] for i in ids])
        pa = ((np.arange(ext["t"])[:, None, None] < ts)
              & (np.arange(ext["k"])[None, :, None] < ks)).sum(-1)  # [t, k]
        counts, rounds = np.unique(pa[pa > 0], return_counts=True)
        return ext["steps"] * sum(
            int(r) * (step_time or _measured_step_time)(
                int(c) * ext["n"] * ext["j"], geom)
            for c, r in zip(counts, rounds))

    return cost


def _bucket_points(extents: list[dict], max_buckets: int,
                   bucket_waste: float, cost_fn=_vol,
                   bucket_cost_fn=None) -> list[dict]:
    """Group points into shape buckets under a padding-waste heuristic.

    Greedy agglomerative merge: one bucket per distinct extent tuple, then
    repeatedly merge the pair whose elementwise-max envelope adds the least
    padded compute; forced while the bucket count exceeds ``max_buckets``,
    voluntary while the total padded compute stays within ``bucket_waste``
    x the no-padding ideal.  ``cost_fn(ext)`` prices one point padded to
    ``ext`` (only called when there are shapes to merge).  Returns
    ``[{"ids": [point indices], "ext": {...}}]`` ordered by first point
    id, ids ascending within each bucket.

    ``bucket_cost_fn(ids, ext)``, where given, prices a whole bucket in
    place of ``len(ids) * cost_fn(ext)`` (a stack is not the sum of its
    points), and a voluntary merge must then lower the total:
    ``bucket_waste`` is not read.
    """
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    by_key: dict[tuple, list[int]] = {}
    for i, e in enumerate(extents):
        by_key.setdefault(tuple(e[k] for k in _SHAPE_KEYS), []).append(i)
    buckets = [{"ids": ids, "ext": dict(zip(_SHAPE_KEYS, key))}
               for key, ids in by_key.items()]
    if len(buckets) > 1:                   # uniform grids never pay cost_fn
        if bucket_cost_fn is None:
            ideal = sum(cost_fn(e) for e in extents)

            def price(ids, ext):
                return len(ids) * cost_fn(ext)
        else:
            price = bucket_cost_fn

        def cost(b):
            return price(b["ids"], b["ext"])

        total = sum(cost(b) for b in buckets)
        while len(buckets) > 1:
            best = None
            for x in range(len(buckets)):
                for y in range(x + 1, len(buckets)):
                    ext = {k: max(buckets[x]["ext"][k], buckets[y]["ext"][k])
                           for k in _SHAPE_KEYS}
                    delta = (price(buckets[x]["ids"] + buckets[y]["ids"], ext)
                             - cost(buckets[x]) - cost(buckets[y]))
                    if best is None or delta < best[0]:
                        best = (delta, x, y, ext)
            delta, x, y, ext = best
            voluntary = delta < 0 if bucket_cost_fn is not None \
                else total + delta <= bucket_waste * ideal
            if len(buckets) > max_buckets or voluntary:
                merged = {"ids": buckets[x]["ids"] + buckets[y]["ids"],
                          "ext": ext}
                buckets = [b for i, b in enumerate(buckets)
                           if i not in (x, y)] + [merged]
                total += delta
            else:
                break
    for b in buckets:
        b["ids"].sort()
    buckets.sort(key=lambda b: b["ids"][0])
    return buckets


def _stack_points(inputs: list[EngineInputs], data_plane: dict,
                  seed_ids: list[int], seed_shared: bool) -> EngineInputs:
    """Stack one bucket's per-point inputs along a leading point axis.

    Data-plane fields take the plan-wide seed-major stack (the same arrays
    in every bucket); ``seed_idx`` becomes the per-point ``[Pb]`` gather
    index, or stays the scalar 0 on single-seed plans; everything else
    stacks point-major."""
    def one(name):
        if name == "seed_idx":
            return np.int32(0) if seed_shared \
                else np.asarray(seed_ids, np.int32)
        if name in SHARED_DATA_FIELDS:
            return data_plane[name]
        return np.stack([getattr(i, name) for i in inputs])

    return EngineInputs(**{f.name: one(f.name)
                           for f in dataclasses.fields(EngineInputs)})


def _shapes(inp: EngineInputs) -> dict:
    return {f.name: np.shape(getattr(inp, f.name))
            for f in dataclasses.fields(EngineInputs)
            if f.name not in SHARED_DATA_FIELDS}


@dataclasses.dataclass
class SweepBucket:
    """One shape bucket: a stack of compatible points, ready to run."""
    point_ids: list            # indices into the plan's point order
    inputs: Optional[EngineInputs]  # stacked [Pb, ...], padded to bucket
    #   maxima.  None after a donated execute consumed this bucket.
    grid_max: dict             # this bucket's {"t","k","n","j","steps"}


_CONSUMED = ("this SweepPlan's bucket inputs were consumed by a "
             "previous donated execute_plan/run_plan; build a fresh "
             "plan, or run with donate=False to keep a plan re-runnable")


@dataclasses.dataclass
class SweepPlan:
    """A bucketed sweep, ready to run: stacked inputs and metadata.

    Holds only host scalars per point besides the bucket inputs (the
    planning simulators are released).  All buckets share ONE seed-major
    data plane (``n_seeds`` rows)."""
    points: list                    # (overrides dict, seed) per grid point
    buckets: list                   # [SweepBucket], first-point order
    grid_max: dict                  # global {"t","k","n","j","steps"} maxima
    aggregator: str
    normalize: bool
    history_dtype: Any
    kernel_mode: str                # "auto" | "cuda" | "torch"
    device: torch.device            # the card (or the CPU) the plan runs on
    n_seeds: int                    # distinct seeds in the data plane
    sim_latency: np.ndarray         # [P] paper latency model totals
    blocks: np.ndarray              # [P] committed blocks per point
    t_valid: np.ndarray             # [P] real rounds per point
    point_volume: np.ndarray        # [P] no-padding compute proxy per point

    @property
    def inputs(self) -> EngineInputs:
        """The single bucket's stacked inputs (single-bucket plans only)."""
        if len(self.buckets) != 1:
            raise ValueError(
                f"plan has {len(self.buckets)} shape buckets; per-bucket "
                "inputs live at plan.buckets[i].inputs")
        if self.buckets[0].inputs is None:
            raise ValueError(
                "this SweepPlan's bucket inputs were consumed by a donated "
                "execute_plan/run_plan; build a fresh plan, or run with "
                "donate=False to keep a plan re-runnable")
        return self.buckets[0].inputs

    def padding_stats(self) -> dict:
        """Padded-compute accounting for the chosen bucket plan:
        ``padded_flop_frac`` is the share of the plan's compute volume that
        is padding, ``single_bucket_flop_frac`` the same had every point
        been padded to the global maxima."""
        ideal = int(self.point_volume.sum())
        padded = sum(len(b.point_ids) * _vol(b.grid_max)
                     for b in self.buckets)
        single = len(self.points) * _vol(self.grid_max)
        return {
            "ideal_volume": ideal,
            "padded_volume": padded,
            "single_bucket_volume": single,
            "padded_flop_frac": 1.0 - ideal / padded,
            "single_bucket_flop_frac": 1.0 - ideal / single,
            "buckets": [dict(points=len(b.point_ids), **b.grid_max)
                        for b in self.buckets],
        }

    def describe(self) -> str:
        """Human-readable bucket plan."""
        st = self.padding_stats()
        lines = [
            f"sweep plan: {len(self.points)} points -> "
            f"{len(self.buckets)} shape bucket(s), {self.n_seeds} distinct "
            f"seed(s) in the data plane; padded-compute waste "
            f"{st['padded_flop_frac']:.1%} (single-bucket baseline "
            f"{st['single_bucket_flop_frac']:.1%})"]
        for i, b in enumerate(self.buckets):
            g = b.grid_max
            lines.append(
                f"  bucket {i}: {len(b.point_ids)} point(s) padded to "
                f"T={g['t']} K={g['k']} N={g['n']} J={g['j']} "
                f"steps={g['steps']}")
        return "\n".join(lines)


@dataclasses.dataclass
class SweepResult:
    """Trajectories for a grid of runs (leading axis = grid point).

    Rows are padded to the grid's max round count: row ``p`` is valid up to
    ``t_valid[p]`` rounds; past that ``accuracy``, ``sim_clock`` and
    ``sim_energy`` repeat the final valid value and ``loss``/``grad_norm``
    are 0.  Rows are in original point order."""
    points: list              # (overrides dict, seed) per grid point
    accuracy: np.ndarray      # [P, T_max]
    loss: np.ndarray          # [P, T_max]
    grad_norm: np.ndarray     # [P, T_max]
    sim_clock: np.ndarray     # [P, T_max] cumulative simulated seconds
    sim_energy: np.ndarray    # [P, T_max] cumulative consensus energy (J)
    sim_latency: np.ndarray   # [P] paper's Sec. 5.1.4 expectation totals
    blocks: np.ndarray        # [P]
    t_valid: np.ndarray       # [P] real rounds per point

    def trajectory(self, p: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        tv = int(self.t_valid[p])
        return (self.accuracy[p, :tv], self.loss[p, :tv],
                self.grad_norm[p, :tv])

    def latency_trajectory(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        """(simulated clock [tv], accuracy [tv]): one point's
        time-to-accuracy curve."""
        tv = int(self.t_valid[p])
        return self.sim_clock[p, :tv], self.accuracy[p, :tv]

    def energy_trajectory(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        """(simulated clock [tv], cumulative consensus energy [tv] J)."""
        tv = int(self.t_valid[p])
        return self.sim_clock[p, :tv], self.sim_energy[p, :tv]

    def time_to_accuracy(self, p: int, target: float) -> float:
        """Simulated seconds until point ``p`` first reaches ``target``
        test accuracy; +inf when it never does."""
        clock, acc = self.latency_trajectory(p)
        hit = np.flatnonzero(acc >= target)
        return float(clock[hit[0]]) if hit.size else float("inf")

    def k_star_empirical(self, target: float
                         ) -> tuple[Optional[int], np.ndarray]:
        """The measured K* selector: the grid point reaching ``target``
        accuracy in the least simulated time, reported beside the
        ``omega_bound`` K* (``repro_torch.core.optimize_k``).  Returns
        ``(best_point_index, times[P])``; the index is None when no point
        reaches the target."""
        times = np.array([self.time_to_accuracy(p, target)
                          for p in range(len(self.points))])
        if not np.isfinite(times).any():
            return None, times
        return int(np.argmin(times)), times


def plan_sweep(setting: BHFLSetting, seeds=(0,), *,
               overrides: Optional[list] = None,
               aggregator: str = "hieavg",
               device_stragglers: str = "temporary",
               edge_stragglers: str = "temporary",
               normalize: bool = False, history_dtype=None,
               kernel_mode: str = "auto",
               max_buckets: Optional[int] = None, bucket_waste: float = 1.25,
               bucket_cost: str = "measured",
               device=None, init_params: Optional[dict] = None,
               mesh=None, **sim_kw) -> SweepPlan:
    """Precompute a grid (overrides x seeds) into bucketed ``EngineInputs``.

    As ``repro.fl.sweep.plan_sweep``: ``overrides`` entries may change
    topology and round counts (``PADDED_FIELDS``; ``j_per_edge`` also as a
    per-edge list), and points are grouped into at most ``max_buckets``
    shape buckets; geometry fields (``UNSUPPORTED_FIELDS``) raise, naming
    the field.  ``bucket_cost``: ``"measured"`` prices a bucket by the
    seconds of the train steps the engine runs for it (one real step timed
    per stacked device count on ``device`` through ``kernel_mode``'s path,
    cached per process, strictly monotone; padded rounds are skipped, so
    they cost nothing), and merges beyond those ``max_buckets`` forces only
    where the stack is faster than its parts; ``"proxy"`` prices a point by
    the ``t·k·n·j·steps`` volume, ``bucket_waste`` caps the padding that
    voluntary merges add, and the buckets are the reference's.
    ``max_buckets`` None is the reference's 4 under ``"proxy"`` and no cap
    under ``"measured"``: the reference caps its compiled programs, and
    the port compiles nothing per bucket, so a forced merge only costs
    time (``tools/sweep_plans.py`` times Fig. 3 both ways).  An override's
    ``"aggregation"`` names its point's aggregator; a mixed grid plans as
    ``"switched"`` (mixing one outside ``SWITCHABLE_AGGREGATORS`` raises).
    Datasets and initial weights are seed-deduped.

    ``device`` (None = ``"cuda"``, which raises without a GPU; ``"cpu"``
    runs the plain versions) and ``kernel_mode`` (``"auto" | "cuda" |
    "torch"``) are where and how the plan runs.  ``init_params``: the
    initial model in the JAX layouts (one dict for every seed, or a
    ``{seed: dict}`` mapping), instead of the port's seeded draw; ``sim_kw``
    goes to every ``BHFLSimulator``.  ``mesh``: the mesh the plan will run
    on, when it has more than one rank: every rank plans, and under the
    measured cost the first rank times each step and every rank prices
    the buckets by its times, so all ranks make the same buckets.
    """
    overrides = [dict(ov) for ov in (overrides or [{}])]
    _validate_overrides(overrides)
    # an override's explicit "seed" wins over the ``seeds`` cross product
    # and is not crossed with it
    points = []
    for ov in overrides:
        if "seed" in ov:
            points.append((ov, int(ov["seed"])))
        else:
            points.extend((ov, seed) for seed in seeds)

    sims = []
    point_aggs = []
    for ov, seed in points:
        ov = dict(ov)
        ov.pop("seed", None)
        agg = ov.pop(AGGREGATION_FIELD, aggregator)
        point_aggs.append(agg)
        kw = dict(sim_kw)
        jpe = ov.pop("j_per_edge", None)
        if isinstance(jpe, (list, tuple, np.ndarray)):
            kw["j_per_edge"] = [int(j) for j in jpe]
        elif jpe is not None:
            ov["j_per_edge"] = int(jpe)
        sims.append(BHFLSimulator(
            dataclasses.replace(setting, **ov), agg,
            device_stragglers, edge_stragglers, normalize=normalize,
            seed=seed, history_dtype=history_dtype, kernel_mode=kernel_mode,
            device=device, **kw))

    # a mixed-aggregation grid runs as the "switched" engine, each point
    # the aggregator its agg_sel names
    distinct = sorted(set(point_aggs))
    if len(distinct) == 1:
        plan_aggregator = distinct[0]
    else:
        bad = [a for a in distinct if a not in SWITCHABLE_AGGREGATORS]
        if bad:
            raise ValueError(
                f"mixed-aggregation sweep includes {bad}, which cannot be "
                f"traced-switched; switchable: {SWITCHABLE_AGGREGATORS}. "
                "Run those aggregators as separate sweeps.")
        plan_aggregator = "switched"

    extents = [{"t": s.s.t_global_rounds, "k": s.s.k_edge_rounds,
                "n": s.N, "j": max(s.j_per_edge), "steps": s.steps}
               for s in sims]
    grid_max = {k: max(e[k] for e in extents) for k in _SHAPE_KEYS}
    if bucket_cost not in ("measured", "proxy"):
        raise ValueError(f"unknown bucket_cost {bucket_cost!r}; "
                         "expected 'measured' or 'proxy'")
    if max_buckets is None:
        max_buckets = 4 if bucket_cost == "proxy" else len(points)
    dev = sims[0].device
    if bucket_cost == "measured":
        s0 = sims[0].s
        step_time = None
        ranks = _Ranks(mesh) if mesh is not None else None
        if ranks is not None and ranks.n > 1:
            def step_time(d, geom):
                return ranks.from_first(lambda: _measured_step_time(d, geom))
        try:
            groups = _bucket_points(
                extents, max_buckets, bucket_waste,
                bucket_cost_fn=_measured_bucket_cost_fn(
                    (s0.image_hw, s0.batch_size, s0.cnn_c1, s0.cnn_c2,
                     s0.n_classes, kernel_mode, str(dev)), extents,
                    step_time))
        finally:
            if ranks is not None:
                ranks.close()
    else:
        groups = _bucket_points(extents, max_buckets, bucket_waste, _vol)

    per_seed = isinstance(init_params, dict) and init_params and all(
        isinstance(k, (int, np.integer)) for k in init_params)
    # seed dedup: the first point of each distinct seed makes that seed's
    # data-plane row, which every same-seed point shares
    seed_to_idx: dict = {}
    for s in sims:
        seed_to_idx.setdefault(s.seed, len(seed_to_idx))
    first_by_seed: dict = {}
    built: list = []          # (group, [EngineInputs per point])
    for g in groups:
        ext = g["ext"]
        binputs = []
        for i in g["ids"]:
            s = sims[i]
            w0 = init_params[s.seed] if per_seed else init_params
            inp = build_inputs(
                s, t_max=ext["t"], k_max=ext["k"], n_max=ext["n"],
                j_max=ext["j"], steps_max=ext["steps"],
                share_data_from=first_by_seed.get(s.seed), init_params=w0)
            first_by_seed.setdefault(s.seed, inp)
            binputs.append(inp)
        shapes = [_shapes(i) for i in binputs]
        if any(sh != shapes[0] for sh in shapes[1:]):
            raise ValueError(
                "sweep grid points disagree on array shapes even after "
                "padding — the base setting/sim kwargs (image size, batch "
                "size, data sizes) must be identical across the grid")
        built.append((g, binputs))

    reps = [first_by_seed[seed] for seed in seed_to_idx]
    data_plane = {}
    for name in SHARED_DATA_FIELDS:
        vals = [getattr(r, name) for r in reps]
        if len(vals) == 1:
            data_plane[name] = vals[0]
        elif name == "init_w":
            data_plane[name] = {k: np.concatenate([v[k] for v in vals])
                                for k in vals[0]}
        else:
            data_plane[name] = np.concatenate(vals)

    seed_shared = len(seed_to_idx) == 1
    buckets = [SweepBucket(
        point_ids=list(g["ids"]),
        inputs=_stack_points(binputs, data_plane,
                             [seed_to_idx[sims[i].seed] for i in g["ids"]],
                             seed_shared),
        grid_max=dict(g["ext"]))
        for g, binputs in built]
    return SweepPlan(points=points, buckets=buckets, grid_max=grid_max,
                     aggregator=plan_aggregator, normalize=normalize,
                     history_dtype=history_dtype, kernel_mode=kernel_mode,
                     device=dev, n_seeds=len(seed_to_idx),
                     sim_latency=np.asarray([s.paper_latency()
                                             for s in sims]),
                     blocks=np.asarray([len(s.chain.blocks) - 1
                                        for s in sims]),
                     t_valid=np.asarray([s.s.t_global_rounds
                                         for s in sims]),
                     point_volume=np.asarray([_vol(e) for e in extents]))


# ---------------------------------------------------------------- placement
def _branch_order(inp: EngineInputs) -> np.ndarray:
    """The bucket's points ordered by aggregator, then cold-boot length
    (stable): the engine runs the points of one branch as one group, and
    neighbours form a slice of the stack, not a gather."""
    return np.lexsort((inp.t_cold_boot, inp.agg_sel))


def _reorder(inp: EngineInputs, order: np.ndarray) -> EngineInputs:
    """The stacked planes in ``order``; the shared data plane as it is."""
    return dataclasses.replace(inp, **{
        f.name: getattr(inp, f.name)[order]
        for f in dataclasses.fields(EngineInputs)
        if f.name not in SHARED_DATA_FIELDS
        and np.ndim(getattr(inp, f.name)) > 0})


class _Ranks:
    """A sweep mesh's ranks as this process sees them: how many there are,
    this rank's coordinate on each mesh axis, and a ``gloo`` group over
    them for the host-side collectives (the rows' gather, the first rank's
    step times, the plans' agreement).  ``close`` releases the group."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        self.n = int(np.prod(list(self.shape.values())))
        self.group = None
        if self.n == 1:
            self.coord = dict.fromkeys(self.shape, 0)
            return
        if not (dist.is_initialized() and hasattr(mesh, "get_coordinate")):
            raise ValueError(f"a sweep mesh of {self.n} ranks must be a "
                             "DeviceMesh over a running process group")
        world = dist.get_world_size()
        ranks = mesh.mesh.flatten().tolist()
        if sorted(ranks) != list(range(world)):
            raise ValueError(f"the sweep mesh holds ranks {ranks}; it must "
                             f"hold every rank of the process group "
                             f"({world})")
        self.ranks = ranks
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        # each rank's coordinate, in rank order (the order of a gather)
        self.coords = [dict(zip(mesh.mesh_dim_names, np.unravel_index(
            ranks.index(r), tuple(mesh.shape)))) for r in range(world)]
        if dist.get_backend() != "gloo":
            self.group = dist.new_group(ranks, backend="gloo")

    def close(self) -> None:
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None

    def share(self, spec: tuple, coord: dict) -> tuple[int, int]:
        """(index, count) of the share of a point axis placed by ``spec``
        that the rank at ``coord`` runs: row-major over the spec's axes."""
        idx, count = 0, 1
        for a in spec_axes(spec[0]):
            idx = idx * self.shape[a] + int(coord[a])
            count *= self.shape[a]
        return idx, count

    def gather(self, rows: np.ndarray) -> list:
        """Every rank's ``rows`` (equal shapes), in rank order."""
        t = torch.from_numpy(np.ascontiguousarray(rows))
        out = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(out, t, group=self.group)
        return [o.numpy() for o in out]

    def from_first(self, fn) -> float:
        """``fn()`` computed on the mesh's first rank, on every rank."""
        first = self.ranks[0]
        t = torch.tensor([fn() if dist.get_rank() == first else 0.0],
                         dtype=torch.float64)
        dist.broadcast(t, first, group=self.group)
        return float(t)

    def agree(self, key: str, what: str) -> None:
        """Raise unless every rank holds the same ``key``."""
        mine = torch.tensor([zlib.crc32(key.encode())], dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(self.n)]
        dist.all_gather(every, mine, group=self.group)
        if any(int(e) != int(mine) for e in every):
            raise RuntimeError(f"the ranks of the sweep mesh hold different "
                               f"{what}: {[int(e) for e in every]}")


#: a one-rank mesh's shape: where the plan runs with no mesh and no
#: process group, every bucket runs whole, as on the reference's
#: one-device mesh
_ONE_RANK = types.SimpleNamespace(shape={"data": 1})


def execute_plan(plan: SweepPlan, *, mesh=None, placement: str = "auto",
                 donate: bool = True
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
    """Run a plan's buckets (one batched engine run each) and merge the
    rows.

    Returns per-point ``(accuracy, loss, grad_norm, sim_clock,
    sim_energy)``, each ``[P, T_max]``, in original point order; rows of a
    bucket of fewer rounds extend by the engine's tail convention.

    ``placement``: ``"auto"`` splits each bucket's point axis over the
    mesh ``data`` axis when ``sweep_spec`` says it divides, and runs it
    whole on every rank otherwise; ``"vmap"`` runs every bucket whole;
    ``"shard"`` requires the split for every bucket and raises, before any
    bucket runs, if the mesh cannot take one.  ``mesh`` None means
    ``make_sweep_mesh()`` over the running process group (one rank where
    none runs).  A split bucket's ranks each run a contiguous share of
    its points, in the engine's branch order, on
    ``cuda:{rank % device_count}`` (a CUDA plan) and all-gather the rows,
    so every rank returns every row.  Every rank must run the same plan:
    the ranks check that their buckets agree before the first runs.

    ``donate`` (default True): each bucket's stacked planes are released
    after its run, so a big grid does not hold every bucket's planes to
    its end; the shared data plane stays.  A consumed plan raises if
    run again: build a fresh plan, or run with ``donate=False``.
    """
    if placement not in ("auto", "vmap", "shard"):
        raise ValueError(f"unknown placement {placement!r}")
    if mesh is None and dist.is_initialized():
        mesh = make_sweep_mesh()
    ranks = _Ranks(_ONE_RANK if mesh is None else mesh)
    try:
        return _execute(plan, ranks, placement, donate)
    finally:
        ranks.close()


def _execute(plan: SweepPlan, ranks: _Ranks, placement: str, donate: bool):
    # every bucket's spec up front, so that placement='shard' fails before
    # any bucket runs
    specs = [sweep_spec(len(b.point_ids), ranks.mesh)
             if placement != "vmap" else () for b in plan.buckets]
    if placement == "shard":
        for b, spec in zip(plan.buckets, specs):
            if spec == ():
                raise ValueError(
                    f"placement='shard' but a bucket of {len(b.point_ids)} "
                    f"grid points (of {len(plan.points)} total) does not "
                    f"divide a >1 mesh axis (mesh={ranks.shape}); "
                    "force max_buckets=1 or use placement='auto'")
    device = plan.device
    if ranks.n > 1:
        ranks.agree(repr([(b.point_ids, sorted(b.grid_max.items()), spec)
                          for b, spec in zip(plan.buckets, specs)]
                         + [plan.aggregator, len(plan.points)]),
                    "sweep plans")
        if device.type == "cuda":
            device = torch.device(
                "cuda", dist.get_rank() % torch.cuda.device_count())

    P_, Tg = len(plan.points), plan.grid_max["t"]
    acc = np.zeros((P_, Tg), np.float32)
    loss = np.zeros((P_, Tg), np.float32)
    gn = np.zeros((P_, Tg), np.float32)
    clock = np.zeros((P_, Tg), np.float32)
    energy = np.zeros((P_, Tg), np.float32)
    for b, spec in zip(plan.buckets, specs):
        if b.inputs is None:
            raise ValueError(_CONSUMED)
        inp = b.inputs
        order = whole = _branch_order(inp)
        if spec:
            # this rank's contiguous share of the ordered points
            idx, count = ranks.share(spec, ranks.coord)
            size = whole.size // count
            order = whole[idx * size:(idx + 1) * size]
        if order.size < whole.size or (order != np.arange(order.size)).any():
            inp = _reorder(inp, order)
        outs = run_engine(inp, aggregator=plan.aggregator,
                          device=device, normalize=plan.normalize,
                          history_dtype=plan.history_dtype,
                          kernel_mode=plan.kernel_mode)
        if donate:
            # only after a run that succeeded: a failed bucket stays, and
            # the plan can be retried
            b.inputs = None
        del inp
        a, l, g, c, en = outs
        ids = np.asarray(b.point_ids)[order]
        if spec:
            # every rank's share, put back in the bucket's branch order
            # (float64 carries each row's float32 and float64 values)
            shares = ranks.gather(np.stack([a, l, g, c, en]).astype(
                np.float64))
            full = np.empty((5, whole.size) + a.shape[1:])
            for r, rows in enumerate(shares):
                i, _ = ranks.share(spec, ranks.coords[r])
                full[:, i * size:(i + 1) * size] = rows
            a, l, g, c, en = full
            ids = np.asarray(b.point_ids)[whole]
        Tb = a.shape[1]
        acc[ids, :Tb] = a
        acc[ids, Tb:] = a[:, -1:]
        loss[ids, :Tb] = l
        gn[ids, :Tb] = g
        clock[ids, :Tb] = c
        clock[ids, Tb:] = c[:, -1:]
        energy[ids, :Tb] = en
        energy[ids, Tb:] = en[:, -1:]
    return acc, loss, gn, clock, energy


def run_plan(plan: SweepPlan, *, mesh=None, placement: str = "auto",
             donate: bool = True) -> SweepResult:
    """Execute a prepared plan (``plan.describe()`` may be logged first)
    and package a ``SweepResult``; ``mesh``, ``placement`` and ``donate``
    as in ``execute_plan``."""
    accs, losses, deltas, clocks, energies = execute_plan(
        plan, mesh=mesh, placement=placement, donate=donate)
    return SweepResult(
        points=plan.points,
        accuracy=accs, loss=losses, grad_norm=deltas, sim_clock=clocks,
        sim_energy=energies,
        sim_latency=plan.sim_latency, blocks=plan.blocks,
        t_valid=plan.t_valid)


# ------------------------------------------------------------------ wrapper
def run_sweep(setting: BHFLSetting, seeds=(0,), *,
              overrides: Optional[list] = None,
              aggregator: str = "hieavg",
              device_stragglers: str = "temporary",
              edge_stragglers: str = "temporary",
              normalize: bool = False, history_dtype=None,
              kernel_mode: str = "auto", mesh=None,
              placement: str = "auto",
              max_buckets: Optional[int] = None, bucket_waste: float = 1.25,
              bucket_cost: str = "measured",
              device=None, init_params: Optional[dict] = None,
              **sim_kw) -> SweepResult:
    """A grid (overrides x seeds, topology and round grids included) as one
    batched run per shape bucket, each split over the ranks of ``mesh``
    where it divides: ``plan_sweep`` then ``run_plan`` (see both; ``mesh``
    None is ``make_sweep_mesh()`` over a running process group, one rank
    where none runs).  An override may carry the ``"aggregation"``
    pseudo-field; a grid mixing ``SWITCHABLE_AGGREGATORS`` runs each point
    under its own aggregator in one stack."""
    if mesh is None and dist.is_initialized():
        mesh = make_sweep_mesh()
    plan = plan_sweep(setting, seeds, overrides=overrides,
                      aggregator=aggregator,
                      device_stragglers=device_stragglers,
                      edge_stragglers=edge_stragglers, normalize=normalize,
                      history_dtype=history_dtype, kernel_mode=kernel_mode,
                      max_buckets=max_buckets,
                      bucket_waste=bucket_waste, bucket_cost=bucket_cost,
                      device=device, init_params=init_params, mesh=mesh,
                      **sim_kw)
    return run_plan(plan, mesh=mesh, placement=placement)
