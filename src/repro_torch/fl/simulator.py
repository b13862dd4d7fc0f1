"""BHFL simulator — the paper's experiment (Sec. 6) end to end, on the card.

Port of ``repro.fl.simulator.BHFLSimulator``: N edge servers x J_i local
devices train the paper's CNN on a non-IID class-partitioned dataset with
the BHFL workflow (local updates, HieAvg at the edge K times per global
round, Raft consensus overlapped with the edge rounds, HieAvg on the
leader).  The host-side set-up (data, partition, straggler schedules,
chain, fault schedule) is the reference's, draw for draw; ``run`` builds
the host plane and drives ``repro_torch.fl.engine.run_engine``, and
``run_checkpointed`` the same run in resumable chunks.  Population mode
(``population=``, ``repro_torch.fl.population``) samples each round's
cohort of ``[N, j_cohort]`` devices from a store of device profiles that
stays on the host.  ``run_legacy`` is the reference's per-edge loop, the
numerics cross-check of ``run``, in plain PyTorch.  Aggregators:
``hieavg`` (the paper), ``t_fedavg`` (drop stragglers), ``d_fedavg``
(reuse their last weights), ``delayed_grad`` (stale updates arrive one
round late, staleness-discounted), ``fedavg`` (the oracle, meaningful with
no stragglers), ``switched`` (the sweeps' per-point choice among HieAvg,
delayed-gradient and FedAvg); ``run_comparison`` runs the paper's Fig. 2
set, ``repro_torch.fl.sweep`` grids of deployments.

The simulator runs on a CUDA device: ``device=None`` means ``"cuda"`` and
raises when no GPU is present.  ``device="cpu"`` runs the plain PyTorch
versions of the kernels (the CPU tests do).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as _ckpt
from repro_torch.configs.bhfl_cnn import BHFLSetting
from repro_torch.core import baselines
from repro_torch.core import consensus as _consensus
from repro_torch.core import hieavg
from repro_torch.core import latency as lat
from repro_torch.core import rng as rng_streams
from repro_torch.core import straggler as strag
from repro_torch.data import by_class, class_images, class_pools
from repro_torch.kernels.build import KERNEL_MODES
from repro_torch.models import (cnn_accuracy_shifted, cnn_loss_shifted,
                                cnn_specs, stack_params)
from repro_torch.optim import paper_lr

from . import engine as _engine
from . import faults as _faults
from . import population as _population


@dataclasses.dataclass
class RunResult:
    accuracy: np.ndarray          # [T] test accuracy after each global round
    loss: np.ndarray              # [T] mean local training loss
    grad_norm: np.ndarray         # [T] global-model round-to-round delta
    wall_time: float
    sim_latency: float            # paper's latency model total (Sec. 5.1.4)
    blocks: int                   # committed blockchain blocks
    chain_valid: bool
    sim_clock: Optional[np.ndarray] = None   # [T] cumulative simulated s
    sim_energy: Optional[np.ndarray] = None  # [T] cumulative consensus J
    #   (run_legacy leaves both None, as the reference's does)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device and no GPU is present; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


class BHFLSimulator:
    """One BHFL deployment over the synthetic MNIST surrogate."""

    def __init__(self, setting: BHFLSetting = BHFLSetting(),
                 aggregator: str = "hieavg",
                 device_stragglers: str = "temporary",
                 edge_stragglers: str = "temporary",
                 j_per_edge: Optional[list[int]] = None,
                 n_train: int = 4000, n_test: int = 1000,
                 steps_per_epoch: Optional[int] = None,
                 normalize: bool = False,
                 fail_leader_at: Optional[int] = None,
                 seed: Optional[int] = None,
                 history_dtype=None,
                 kernel_mode: str = "auto",
                 population=None,
                 j_cohort: Optional[int] = None,
                 device_rates: Optional[list] = None,
                 faults: Optional[_faults.FaultSpec] = None,
                 device=None,
                 init_params: Optional[dict] = None):
        """Arguments as ``repro.fl.simulator.BHFLSimulator``, plus

        ``device``: where the run happens (``None`` = ``"cuda"``, which
        raises without a GPU); ``kernel_mode``: ``"auto" | "cuda" |
        "torch"`` (see ``repro_torch.kernels.build``); ``init_params``:
        the initial global model as a dict of arrays in the JAX layouts
        (for example the reference's own ``init_from_specs`` draw),
        instead of the port's seeded initialiser.

        ``history_dtype``: the HieAvg history storage dtype, None
        (float32), ``torch.bfloat16`` or ``torch.float8_e4m3fn``; the math
        stays float32.

        ``aggregator="switched"`` runs the aggregator its ``agg_sel``
        names (``engine.AGG_SEL``; HieAvg for a standalone run), as the
        reference's traced tri-select does; the sweeps set it per point.

        ``population`` (with ``j_cohort``): population mode, as the
        reference's: an int population size, a ``PopulationSpec`` or a
        prebuilt ``DevicePopulation`` (share one across sweep points).
        Each global round gathers a cohort ``[N, j_cohort]`` by index; the
        occupant's profile gives its straggling, data shard and speed, and
        every per-round draw is keyed by the slot.  The store stays on the
        host; what the engine puts on the device is cohort-sized.
        ``j_per_edge`` and ``device_rates`` are refused with a population,
        and device stragglers must be ``"temporary"`` or ``"none"``."""
        if aggregator not in _engine.AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggregator!r}; expected "
                             f"one of {_engine.AGGREGATORS}")
        if history_dtype is not None and \
                history_dtype not in hieavg.HISTORY_DTYPES:
            raise ValueError(
                f"history_dtype must be None or one of "
                f"{hieavg.HISTORY_DTYPES}, got {history_dtype!r}")
        if kernel_mode not in KERNEL_MODES:
            raise ValueError(f"unknown kernel_mode {kernel_mode!r}; expected "
                             f"one of {KERNEL_MODES}")
        self.device = resolve_device(device)
        if kernel_mode == "cuda" and self.device.type != "cuda":
            raise ValueError("kernel_mode='cuda' needs device='cuda'")
        self.kernel_mode = kernel_mode
        self.aggregator = aggregator
        self.history_dtype = history_dtype
        self.init_params = init_params
        self.s = setting
        self.normalize = normalize
        self.seed = setting.seed if seed is None else seed
        self.N = setting.n_edges
        # population mode: the store fixes the cohort's shape
        if population is not None:
            if j_per_edge is not None:
                raise ValueError(
                    "population mode fixes the per-edge device count to "
                    "j_cohort; pass j_cohort instead of j_per_edge")
            self.pop = _population.as_population(
                population, j_cohort, n_classes=setting.n_classes,
                max_classes=setting.classes_per_device,
                seed=rng_streams.stream_seed(self.seed, "population"))
            self.j_per_edge = [self.pop.spec.j_cohort] * self.N
        else:
            self.pop = None
            self.j_per_edge = j_per_edge or [setting.j_per_edge] * self.N
        if len(self.j_per_edge) != self.N:
            raise ValueError(
                f"j_per_edge has {len(self.j_per_edge)} entries for "
                f"n_edges={self.N}; a ragged device list must name every "
                "edge exactly once")
        self.D = sum(self.j_per_edge)
        # one local iteration = one epoch over the device's own shard
        self.steps = steps_per_epoch if steps_per_epoch is not None \
            else max(1, n_train // (self.D * setting.batch_size))

        # ---- data: synthetic class-clustered images, non-IID partition,
        # each draw on its named SeedSequence stream (core.rng)
        imgs, labels = class_images(
            n_train + n_test, seed=rng_streams.stream_seed(self.seed, "data"),
            hw=setting.image_hw, n_classes=setting.n_classes)
        self.test_x = imgs[n_train:]
        self.test_y = labels[n_train:]
        self.train_x, self.train_y = imgs[:n_train], labels[:n_train]
        if self.pop is None:
            parts = by_class(labels[:n_train], self.N, self.j_per_edge,
                             max_classes=setting.classes_per_device,
                             seed=rng_streams.stream_seed(self.seed,
                                                          "partition"))
            self.device_idx = [idx for edge in parts for idx in edge]
        else:
            # population shards are the class pools themselves: the
            # occupant's classes select pools, batches sample from them
            self.device_idx = None
            self._pool, self._pool_off, self._pool_cnt = class_pools(
                labels[:n_train])
            used = np.unique(self.pop.classes)
            if (self._pool_cnt[used] == 0).any():
                raise ValueError(
                    "population mode needs every assigned class present in "
                    "the train split; increase n_train or n_classes")

        # ---- straggler schedules (submission masks per round)
        rounds = setting.t_global_rounds * setting.k_edge_rounds + 1
        if self.pop is not None:
            self.cohort_ids, self.dev_masks = self._population_schedules(
                rounds, device_stragglers)
        else:
            self.cohort_ids = None
            n_dev_strag = int(round(setting.straggler_frac
                                    * setting.j_per_edge))
            dev_masks = []
            for e in range(self.N):
                kw = dict(stop_round=setting.permanent_stop_round
                          * setting.k_edge_rounds) \
                    if device_stragglers == "permanent" else {}
                dev_masks.append(strag.from_fraction(
                    rounds, self.j_per_edge[e],
                    n_dev_strag / max(setting.j_per_edge, 1),
                    kind=device_stragglers,
                    seed=rng_streams.stream_seed(self.seed, "dev_masks", e),
                    **kw))
            self.dev_masks = dev_masks                  # list of [rounds, J_e]
        kw = dict(stop_round=setting.permanent_stop_round) \
            if edge_stragglers == "permanent" else {}
        self.edge_masks = strag.from_fraction(
            setting.t_global_rounds + 1, self.N, setting.straggler_frac,
            kind=edge_stragglers,
            seed=rng_streams.stream_seed(self.seed, "edge_masks"),
            **kw)  # [T+1, N]

        self.specs = cnn_specs(setting.image_hw, 1, setting.n_classes,
                               c1=setting.cnn_c1, c2=setting.cnn_c2)
        # ---- latency fabric and the consensus chain
        rate_mult = None
        if device_rates is not None:
            if self.pop is not None:
                raise ValueError(
                    "population mode draws per-device rates from the "
                    "store's time_scale profiles; device_rates only "
                    "applies to fixed fleets")
            rate_mult = np.asarray(device_rates, np.float64).reshape(-1)
            if rate_mult.shape != (self.D,):
                raise ValueError(
                    f"device_rates must name every device once "
                    f"(D={self.D}), got shape {rate_mult.shape}")
            if not (rate_mult > 0).all():
                raise ValueError("device_rates must be positive "
                                 "multipliers")
        self.lat = lat.LatencyParams(
            T=setting.t_global_rounds, N=self.N,
            J=int(round(float(np.mean(self.j_per_edge)))),
            lm_device=setting.lm_device, lp_device=setting.lp_device,
            lm_edge=setting.lm_edge, rate_mult=rate_mult)
        self.chain = _consensus.make_chain(
            setting.consensus, self.N,
            link_latency=setting.link_latency, n_shards=setting.n_shards,
            seed=rng_streams.stream_seed(self.seed, "chain"))
        # ---- fault plane: the setting's fault fields unless passed
        # explicitly; fail_leader_at is its one-event leader-crash schedule
        if faults is None:
            faults = _faults.FaultSpec.from_setting(
                setting, leader_crash_round=fail_leader_at)
        elif faults.leader_crash_round is None and fail_leader_at is not None:
            faults = dataclasses.replace(faults,
                                         leader_crash_round=fail_leader_at)
        self.fault_spec = faults
        self.fail_leader_at = faults.leader_crash_round
        self.fault_schedule = _faults.compile_schedule(
            faults, t_rounds=setting.t_global_rounds,
            k_rounds=setting.k_edge_rounds, n_edges=self.N,
            j_per_edge=list(self.j_per_edge), seed=self.seed)

    # ----------------------------------------------------- population plane
    def _population_schedules(self, rounds: int, device_stragglers: str
                              ) -> tuple[np.ndarray, list[np.ndarray]]:
        """The cohort plan ``[T, N, J]`` and its straggler masks (a list of
        ``[rounds, J]``), as the reference draws them.  Straggling is
        i.i.d. Bernoulli from the occupant's ``miss_prob``, drawn as
        slot-keyed uniforms on the ``"dev_masks"`` stream once for every
        edge (a gathered cohort and ``store.subset`` of its rows see the
        same masks); cold-boot edge rounds are never missed, and the
        trailing schedule row reuses the last cohort."""
        s, N, J = self.s, self.N, self.pop.spec.j_cohort
        T, K = s.t_global_rounds, s.k_edge_rounds
        cohort_ids = self.pop.cohort_ids(
            T, N, rng_streams.stream_seed(self.seed, "cohort"))
        if device_stragglers not in ("temporary", "none"):
            raise ValueError(
                "population mode draws straggling from per-device "
                "propensity profiles; device_stragglers must be "
                f"'temporary' or 'none', got {device_stragglers!r}")
        if device_stragglers == "none":
            masks = np.ones((rounds, N, J), dtype=bool)
        else:
            ids_r = np.repeat(cohort_ids, K, axis=0)
            ids_r = np.concatenate([ids_r, ids_r[-1:]])[:rounds]
            u = rng_streams.stream_rng(self.seed, "dev_masks").random(
                (rounds, N, J))
            masks = u >= self.pop.miss_prob[ids_r]
            masks[:s.t_cold_boot * K] = True
        return cohort_ids, [masks[:, e, :] for e in range(N)]

    def cohort_change(self) -> np.ndarray:
        """``[T, N, J]`` bool: the slot's occupant changed at the start of
        global round t (always False at t = 0 and for a fixed fleet).  The
        engine resets the slot's delayed-gradient pending update and age
        there."""
        T = self.s.t_global_rounds
        J = max(self.j_per_edge)
        chg = np.zeros((T, self.N, J), dtype=bool)
        if self.cohort_ids is not None:
            chg[1:] = self.cohort_ids[1:] != self.cohort_ids[:-1]
        return chg

    def cohort_time_scale(self) -> Optional[np.ndarray]:
        """``[T*K, D]`` round-time multipliers of each round's occupants
        for the latency draws (None for a fixed fleet)."""
        if self.cohort_ids is None:
            return None
        K = self.s.k_edge_rounds
        ids_r = np.repeat(self.cohort_ids, K, axis=0)    # [T*K, N, J]
        return self.pop.time_scale[ids_r].reshape(ids_r.shape[0], self.D)

    def _epoch_batches(self, rng) -> tuple[torch.Tensor, torch.Tensor]:
        """``[D, steps, B]`` batches from each device's own shard, on the
        simulator's device."""
        bs = self.s.batch_size
        xs = np.zeros((self.D, self.steps, bs, self.s.image_hw,
                       self.s.image_hw, 1), np.float32)
        ys = np.zeros((self.D, self.steps, bs), np.int32)
        for d, idx in enumerate(self.device_idx):
            if len(idx) == 0:
                continue
            take = rng.choice(idx, size=(self.steps, bs), replace=True)
            xs[d] = self.train_x[take]
            ys[d] = self.train_y[take]
        return (torch.from_numpy(xs).to(self.device),
                torch.from_numpy(ys).to(self.device))

    def paper_latency(self) -> float:
        """The paper's latency model total (Sec. 5.1.4) for this deployment."""
        return lat.total_latency(self.s.k_edge_rounds, self.lat)

    def run(self, progress: bool = False) -> RunResult:
        """Run the deployment.  Every call draws the same batches (a fresh
        generator on the ``"batches"`` stream); the chain advances per
        call, as in the reference."""
        t0 = time.time()
        inp = _engine.build_inputs(self, init_params=self.init_params)
        accs, losses, deltas, clock, energy = _engine.run_engine(
            inp, aggregator=self.aggregator, device=self.device,
            normalize=self.normalize, history_dtype=self.history_dtype,
            kernel_mode=self.kernel_mode)
        if progress:
            for t in range(1, self.s.t_global_rounds + 1):
                if t % 10 == 0 or t == 1:
                    print(f"  t={t:3d} acc={accs[t - 1]:.4f} "
                          f"loss={losses[t - 1]:.4f} "
                          f"clock={clock[t - 1]:.1f}s")
        return self._result(t0, accs, losses, deltas, clock, energy)

    def _result(self, t0, accs, losses, deltas, clock, energy) -> RunResult:
        return RunResult(
            accuracy=accs, loss=losses, grad_norm=deltas,
            wall_time=time.time() - t0, sim_latency=self.paper_latency(),
            blocks=len(self.chain.blocks) - 1,
            chain_valid=self.chain.validate(), sim_clock=clock,
            sim_energy=energy)

    def run_checkpointed(self, ckpt_dir: str, *, every: int = 10,
                         resume: bool = True,
                         progress: bool = False) -> RunResult:
        """``run()`` in chunks of ``every`` global rounds, writing the
        engine carry and the rows so far to ``ckpt_dir``
        (``repro_torch.checkpoint``) after each chunk.

        A run killed after any chunk and resumed from a **fresh** simulator
        (same arguments: the chain replay, fault schedule and batch and
        latency draws are rebuilt from their named streams, so the host
        plane is byte for byte the same) ends bitwise equal to the
        uninterrupted checkpointed run; against ``run()`` it is allclose.
        ``resume=False`` ignores (and overwrites) existing checkpoints."""
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        t0 = time.time()
        T = self.s.t_global_rounds
        inp = _engine.build_inputs(self, init_params=self.init_params)
        carry = _engine.init_engine_carry(inp, self.history_dtype,
                                          device=self.device)
        keys = ("accuracy", "loss", "delta", "clock", "energy")
        outs = {k: np.zeros((0,), np.float32) for k in keys}
        t_done = 0
        if resume:
            step = _ckpt.latest_step(ckpt_dir)
            if step is not None:
                like = {"carry": carry,
                        "outs": {k: np.zeros((step,), np.float32)
                                 for k in keys}}
                state, _ = _ckpt.restore_checkpoint(ckpt_dir, like, step)
                carry, outs, t_done = state["carry"], state["outs"], step
                if progress:
                    print(f"  resumed from checkpoint @ t={t_done}")
        while t_done < T:
            t1 = min(t_done + every, T)
            rows, carry = _engine.run_engine_chunk(
                inp, carry, t_done, t1, aggregator=self.aggregator,
                device=self.device, normalize=self.normalize,
                kernel_mode=self.kernel_mode)
            for k, v in zip(keys, rows):
                outs[k] = np.concatenate([outs[k], v.astype(np.float32)])
            t_done = t1
            _ckpt.save_checkpoint(ckpt_dir, t_done,
                                  {"carry": carry, "outs": outs},
                                  metadata={"t": t_done})
            if progress:
                print(f"  t={t_done:3d} acc={outs['accuracy'][-1]:.4f} "
                      f"clock={outs['clock'][-1]:.1f}s  [checkpointed]")
        return self._result(t0, outs["accuracy"], outs["loss"],
                            outs["delta"], outs["clock"], outs["energy"])

    def run_legacy(self, progress: bool = False) -> RunResult:
        """The reference's per-edge Python loop (``run_legacy``), the
        numerics cross-check of ``run``: per edge round one local epoch of
        every device, then each edge's aggregate in turn; per global round
        the leader's aggregate, the block commit and the test accuracy.

        An entry point of its own, not a fallback of ``run``: it launches
        no kernel, by design, as the reference's reaches no Pallas kernel.
        The conv is the shifted sum of nine matmuls
        (``models.cnn_loss_shifted``), the update the plain ``w - lr * g``,
        the aggregates ``core.hieavg``/``core.baselines``, all in float32
        PyTorch on the simulator's device.  The shifted sum adds in
        another order than the conv kernels, so it matches ``run`` within
        the engine-parity bounds, not bitwise.  Each call opens a fresh
        ``"batches"`` stream (repeated runs are identical) and derives
        failover availability afresh; the chain advances per call.  Leaves
        ``sim_clock``/``sim_energy`` None.  Population mode and stochastic
        faults raise, as in the reference."""
        if self.pop is not None:
            raise ValueError(
                "population mode runs on the engine path only; use run()")
        if self.fault_spec.any_faults:
            raise ValueError(
                "stochastic fault injection (repro_torch.fl.faults) runs "
                "on the engine path only; use run()")
        s, dev, N = self.s, self.device, self.N
        t0 = time.time()
        batch_rng = rng_streams.stream_rng(self.seed, "batches")
        test_x = torch.from_numpy(np.array(self.test_x)).to(dev)
        test_y = torch.from_numpy(np.array(self.test_y)).to(dev)
        global_w = {k: torch.from_numpy(v).to(dev) for k, v in
                    _engine.initial_model(self, self.init_params).items()}
        device_w = stack_params(global_w, self.D)
        edge_slices = np.cumsum([0] + self.j_per_edge)
        j_arr = torch.tensor(self.j_per_edge, dtype=torch.float32,
                             device=dev)
        # each device slot's edge, for the sync to the edge models
        edge_of = torch.from_numpy(np.repeat(np.arange(N),
                                             self.j_per_edge)).to(dev)
        dev_hist = dev_last = glob_hist = glob_last = None
        accs, losses, deltas = [], [], []
        prev_global = global_w
        round_ctr = 0        # edge-round counter t*K + k for masks and lr
        failed_edge: Optional[int] = None
        # failover availability is derived per run, never written back
        edge_avail = np.ones(N, dtype=bool)
        for t in range(1, s.t_global_rounds + 1):
            # Raft: the election overlaps the K edge rounds
            self.chain.elect_leader()
            if self.fail_leader_at is not None and t == self.fail_leader_at:
                failed_edge = self.chain.leader
                self.chain.fail_node(failed_edge)
            if failed_edge is not None:
                edge_avail[failed_edge] = False
            edge_models = None
            for _ in range(s.k_edge_rounds):
                lr = float(paper_lr(round_ctr, s.lr0, s.lr_decay))
                bx, by = self._epoch_batches(batch_rng)
                device_w, dev_loss = _engine.train_epoch_body(
                    device_w, bx, by, lr, kernel_mode="torch",
                    loss_fn=cnn_loss_shifted)
                new_models, new_hists, new_lasts = [], [], []
                for e in range(N):
                    sl = slice(int(edge_slices[e]), int(edge_slices[e + 1]))
                    mask = torch.from_numpy(np.ascontiguousarray(
                        self.dev_masks[e][round_ctr])).to(dev)
                    agg, hist_e, last_e = self._agg(
                        {k: v[sl] for k, v in device_w.items()}, mask, t,
                        None if dev_hist is None else dev_hist[e],
                        None if dev_last is None else dev_last[e], None)
                    new_models.append(agg)
                    new_hists.append(hist_e)
                    new_lasts.append(last_e)
                dev_hist, dev_last = new_hists, new_lasts
                edge_models = {k: torch.stack([m[k] for m in new_models])
                               for k in new_models[0]}
                # devices sync to their edge model for the next epoch
                device_w = {k: v.index_select(0, edge_of)
                            for k, v in edge_models.items()}
                round_ctr += 1

            # global aggregation on the leader, then the block commit
            emask = torch.from_numpy(self.edge_masks[t - 1]
                                     & edge_avail).to(dev)
            global_w, glob_hist, glob_last = self._agg(
                edge_models, emask, t, glob_hist, glob_last, j_arr)
            device_w = stack_params(global_w, self.D)
            self.chain.commit_block(f"edges@t={t}", f"global@t={t}")

            acc = float(cnn_accuracy_shifted(global_w, test_x, test_y))
            accs.append(acc)
            losses.append(float(dev_loss.mean()))
            deltas.append(float(sum(
                float(torch.square(global_w[k] - prev_global[k]).sum())
                for k in sorted(global_w))) ** 0.5)
            prev_global = global_w
            if progress and (t % 10 == 0 or t == 1):
                print(f"  t={t:3d} acc={acc:.4f} loss={losses[-1]:.4f}")
        return RunResult(
            accuracy=np.asarray(accs), loss=np.asarray(losses),
            grad_norm=np.asarray(deltas), wall_time=time.time() - t0,
            sim_latency=self.paper_latency(),
            blocks=len(self.chain.blocks) - 1,
            chain_valid=self.chain.validate())

    def _agg(self, ws: dict, mask: torch.Tensor, t: int, hist, last,
             part_weights: Optional[torch.Tensor]):
        """One aggregate of ``run_legacy``: an edge's (``part_weights``
        None) or the leader's (the J_i).  Returns (aggregate, new history,
        new store), as the reference's ``_agg``."""
        s = self.s
        if self.aggregator == "hieavg":
            if hist is None:                       # first-ever submission
                hist = hieavg.init_history(ws)
            if t <= s.t_cold_boot:                 # Alg. 1: cold boot
                if part_weights is None:
                    agg = hieavg.edge_aggregate_cold(ws)
                else:
                    agg = hieavg.global_aggregate_cold(ws, part_weights)
                return agg, hieavg.update_history(hist, ws, mask), last
            if part_weights is None:
                agg, hist = hieavg.edge_aggregate(
                    ws, mask, hist, gamma0=s.gamma0, lam=s.lam,
                    normalize=self.normalize)
            else:
                agg, hist = hieavg.global_aggregate(
                    ws, mask, hist, part_weights, gamma0=s.gamma0,
                    lam=s.lam, normalize=self.normalize)
            return agg, hist, last
        if self.aggregator == "t_fedavg":
            return baselines.t_fedavg(ws, mask, part_weights), hist, last
        if self.aggregator == "d_fedavg":
            if last is None:
                # first round: everyone counts present for the store
                last = {k: torch.zeros_like(v) for k, v in ws.items()}
                mask = torch.ones_like(mask)
            agg, last = baselines.d_fedavg(ws, mask, last, part_weights)
            return agg, hist, last
        if self.aggregator == "delayed_grad":
            if last is None:
                # first round: everyone counts present (nothing in flight)
                last = ({k: torch.zeros_like(v) for k, v in ws.items()},
                        torch.zeros(mask.shape, dtype=torch.float32,
                                    device=mask.device))
                mask = torch.ones_like(mask)
            pending, age = last
            agg, pending, age = baselines.delayed_grad(
                ws, mask, pending, age, s.staleness_discount,
                float(s.delay_delta), part_weights)
            return agg, hist, (pending, age)
        if self.aggregator == "fedavg":
            return baselines.fedavg(ws, part_weights), hist, last
        raise ValueError(f"unknown aggregator {self.aggregator!r}")


def run_comparison(setting: BHFLSetting = BHFLSetting(),
                   kinds: tuple[str, ...] = ("hieavg", "t_fedavg",
                                             "d_fedavg"),
                   straggler_kind: str = "temporary",
                   include_oracle: bool = True, **kw) -> dict[str, RunResult]:
    """The paper's Fig. 2 comparison: the same deployment and seed under
    each aggregator of ``kinds`` with ``straggler_kind`` stragglers at both
    layers, plus FedAvg without stragglers (``"wo_stragglers"``).
    ``kw`` goes to every ``BHFLSimulator``."""
    out = {}
    if include_oracle:
        out["wo_stragglers"] = BHFLSimulator(
            setting, "fedavg", "none", "none", **kw).run()
    for kind in kinds:
        out[kind] = BHFLSimulator(
            setting, kind, straggler_kind, straggler_kind, **kw).run()
    return out
