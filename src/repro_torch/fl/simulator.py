"""BHFL simulator — the paper's experiment (Sec. 6) end to end, on the card.

Port of ``repro.fl.simulator.BHFLSimulator``: N edge servers x J_i local
devices train the paper's CNN on a non-IID class-partitioned dataset with
the BHFL workflow (local updates, HieAvg at the edge K times per global
round, Raft consensus overlapped with the edge rounds, HieAvg on the
leader).  The host-side set-up (data, partition, straggler schedules,
chain, fault schedule) is the reference's, draw for draw; ``run`` builds
the host plane and drives ``repro_torch.fl.engine.run_engine``, and
``run_checkpointed`` the same run in resumable chunks.  Aggregators:
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
from repro_torch.core import consensus as _consensus
from repro_torch.core import hieavg
from repro_torch.core import latency as lat
from repro_torch.core import rng as rng_streams
from repro_torch.core import straggler as strag
from repro_torch.data import by_class, class_images
from repro_torch.kernels.build import KERNEL_MODES
from repro_torch.models import cnn_specs

from . import engine as _engine
from . import faults as _faults

_LATER = "comes with a later slice of the port"


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
        Population mode raises ``NotImplementedError``: it comes with a
        later slice of the port."""
        if aggregator not in _engine.AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggregator!r}; expected "
                             f"one of {_engine.AGGREGATORS}")
        if history_dtype is not None and \
                history_dtype not in hieavg.HISTORY_DTYPES:
            raise ValueError(
                f"history_dtype must be None or one of "
                f"{hieavg.HISTORY_DTYPES}, got {history_dtype!r}")
        if population is not None or j_cohort is not None:
            raise NotImplementedError(f"population mode {_LATER}")
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
        parts = by_class(labels[:n_train], self.N, self.j_per_edge,
                         max_classes=setting.classes_per_device,
                         seed=rng_streams.stream_seed(self.seed, "partition"))
        self.device_idx = [idx for edge in parts for idx in edge]

        # ---- straggler schedules (submission masks per round)
        rounds = setting.t_global_rounds * setting.k_edge_rounds + 1
        n_dev_strag = int(round(setting.straggler_frac * setting.j_per_edge))
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
        self.dev_masks = dev_masks                      # list of [rounds, J_e]
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

    def run_legacy(self, *args, **kwargs) -> RunResult:
        raise NotImplementedError(f"run_legacy {_LATER}")


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
