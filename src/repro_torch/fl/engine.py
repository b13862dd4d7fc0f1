"""The BHFL run on the card: the host plane, then T global rounds of K edge
rounds, for one deployment or a sweep's stack of them.

Port of ``repro.fl.engine``.  Where the JAX package compiles a whole run
into one ``lax.scan`` program (and a sweep into ``vmap`` of it), the port
is a Python loop that launches the kernels of each phase:

  * ``build_inputs`` — the host plane, bitwise the reference's: dense
    ``[N, J_max]`` device slots with a ``valid`` mask, straggler and edge
    masks, batch indices in the legacy order, the paper's ``lr`` plane,
    per-device round times, the replayed consensus chain's latency and
    energy per round (``replay_chain``).  The ``*_max`` targets pad every
    plane past the deployment's own extents, inertly (the sweep fabric,
    ``repro_torch.fl.sweep``, stacks points that disagree on shape).
  * ``run_engine_chunk`` — global rounds ``t0+1..t1`` from a carry (the
    cross-round state, ``init_engine_carry``) of P points at once: a
    standalone run is P = 1, a sweep bucket stacks its points along a
    leading axis (``EngineInputs`` with that axis on every per-point
    plane).  Per edge round one local SGD epoch for every device of every
    point, folded into one batch of D = P·N·J devices (conv forward and
    backward, SGD update kernels), then the aggregator at every edge of
    every point (B = P·N rows: HieAvg's cold-boot mean or warm mix on the
    ``coef_agg``/``hieavg_agg`` kernels, FedAvg on ``coef_agg``,
    delayed-gradient on ``coef_agg_pair``, the ``t_fedavg``/``d_fedavg``
    baselines in PyTorch); per global round the aggregator on each point's
    leader (B = P rows), the metric rows, and one test-set evaluation per
    point on its seed's test set (conv kernels + ``eval_head``).
    ``run_engine`` is one chunk over all T rounds.

What differs between points is known on the host, so it is decided there:
a point's cold boot (``t <= t_cold_boot``), its padded edge rounds
(``k >= k_valid``) and global rounds (``t > t_valid``), which carry its
state through untouched and are not computed, its padded SGD steps (a
zero row scale), and under ``aggregator="switched"`` the aggregator its
``agg_sel`` names.  Points that take the same branch run as one group, a
slice of the stack where they are neighbours (the sweep orders them so).
Round tests compare global round numbers (``r == 0``, ``t == 1``), so
chunks run back to back give the whole run's numbers.  No SGD step waits
for the device.  The simulated clock and the consensus energy are
functions of the host plane alone, so ``host_clock`` computes them in
float32 numpy with the reference's operations in the reference's order,
and they match it exactly.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import baselines, hieavg
from repro_torch.core import latency as lat
from repro_torch.core import rng as rng_streams
from repro_torch.core import straggler as strag
from repro_torch.data import partition
from repro_torch.fl import faults as _faults
from repro_torch.kernels import dispatch as kernel_dispatch
from repro_torch.models import cnn_accuracy_many, cnn_loss
from repro_torch.models import spec as _spec
from repro_torch.optim import paper_lr


# --------------------------------------------------------------- local step
def train_epoch_body(params: dict, images: torch.Tensor,
                     labels: torch.Tensor, lr, kernel_mode: str = "auto",
                     step_ok: Optional[torch.Tensor] = None,
                     loss_fn=None) -> tuple[dict, torch.Tensor]:
    """One local epoch for all devices.  params: stacked [D, ...];
    images [D, steps, B, H, W, 1]; labels [D, steps, B].  Returns (new
    stacked params, mean loss per device [D]).

    ``lr``: a host float, the scale of every row in every step; or a
    float32 tensor ``[steps, D]`` of per-step, per-row scales (a sweep's
    rows: lr × step validity, 0 on a padded step, which is then an exact
    identity).  ``step_ok``: None, every step counts in the mean loss; or
    a float32 ``[steps, D]`` of 0/1, and the mean loss is
    ``sum(loss * ok) / max(sum(ok), 1)`` per row, as the reference's
    ``train_epoch_body`` takes it with a step mask.

    Each step takes the gradient of the sum of the per-device mean losses:
    the devices' weights are independent, so every device gets its own
    gradient, as JAX's ``vmap(value_and_grad)`` gives it.

    ``loss_fn``: None, the engine's loss (``models.cnn_loss``, its conv
    blocks through ``kernel_mode``'s route); or a ``(params, images,
    labels) -> [D]`` loss used as it is (``run_legacy``'s shifted-sum
    ``models.cnn_loss_shifted``).
    """
    total = None
    steps = images.shape[1]
    for s in range(steps):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = cnn_loss(leaves, images[:, s], labels[:, s], kernel_mode) \
            if loss_fn is None else loss_fn(leaves, images[:, s],
                                            labels[:, s])
        names = list(leaves)
        grads = torch.autograd.grad(loss.sum(), [leaves[k] for k in names])
        params = kernel_dispatch.sgd_update(
            {k: leaves[k].detach() for k in names}, dict(zip(names, grads)),
            lr[s] if isinstance(lr, torch.Tensor) else lr, mode=kernel_mode)
        loss = loss.detach()
        if step_ok is not None:
            loss = loss * step_ok[s]
        total = loss if total is None else total + loss
    if step_ok is None:
        return params, total / steps
    return params, total / torch.clamp(step_ok.sum(0), min=1.0)


# ------------------------------------------------------------ dense inputs
@dataclasses.dataclass
class EngineInputs:
    """The host plane of one run, as numpy arrays: the fields of the
    reference's ``EngineInputs`` that the port reads (see there for each
    plane).  The data plane is seed-major (a leading ``[S]`` axis of
    distinct seeds, gathered per point by ``seed_idx``).

    A sweep bucket stacks P points: every other plane then has a leading
    ``[P]`` axis (the scalars become ``[P]``), and ``seed_idx`` is ``[P]``
    or, on a single-seed plan, the scalar 0.  The array extents
    T/K/N/J/steps may be padding targets; each point's real extents are in
    ``t_valid``/``k_valid``/``n_valid``/``s_valid``."""

    train_x: np.ndarray       # [S, n_train, H, W, 1] f32
    train_y: np.ndarray       # [S, n_train] i32
    test_x: np.ndarray        # [S, n_test, H, W, 1] f32
    test_y: np.ndarray        # [S, n_test] i32
    init_w: dict              # [S, ...] f32 global model at t=0
    seed_idx: np.ndarray      # scalar i32 — this run's row of the [S] axis
    batch_idx: np.ndarray     # [T, K, N, J, steps, B] i32 into train_x
    has_data: np.ndarray      # [N, J] f32 — 0 for empty-shard/padded slots
    valid: np.ndarray         # [N, J] bool — real device slots
    dev_masks: np.ndarray     # [T, K, N, J] bool submission masks
    edge_masks: np.ndarray    # [T, N] bool (failover already applied)
    lr: np.ndarray            # [T, K] f32 paper schedule (0 when padded)
    j_arr: np.ndarray         # [N] f32 devices per edge (0 = padded edge)
    gamma0: np.ndarray        # scalar f32
    lam: np.ndarray           # scalar f32
    t_cold_boot: np.ndarray   # scalar i32
    t_valid: np.ndarray       # scalar i32 — real global rounds (<= T)
    k_valid: np.ndarray       # scalar i32 — real edge rounds (<= K)
    n_valid: np.ndarray       # scalar i32 — real edges (<= N); metadata,
    #                           padded edges are inert by valid and j_arr
    s_valid: np.ndarray       # scalar i32 — real SGD steps an epoch
    dev_time: np.ndarray      # [T, K, N, J] f32 per-device round time
    cons_time: np.ndarray     # [T] f32 per-round consensus latency
    cons_energy: np.ndarray   # [T] f32 per-round consensus energy (J)
    edge_hop: np.ndarray      # scalar f32 — 2 * E[LM'] edge<->leader hop
    cohort_change: np.ndarray  # [T, N, J] bool — the slot's occupant
    #                           changed at the start of global round t
    #                           (population churn; all False for a fixed
    #                           fleet and on padding)
    agg_sel: np.ndarray       # scalar i32 — the "switched" engine's
    #                           aggregator (AGG_SEL)
    stale_beta: np.ndarray    # scalar f32 — delayed-grad discount beta
    delay_delta: np.ndarray   # scalar f32 — delayed-grad max staleness


#: ``EngineInputs`` fields of the seed-major data plane: shared by every
#: point and bucket of a sweep, never stacked per point
SHARED_DATA_FIELDS = frozenset({"train_x", "train_y", "test_x", "test_y",
                                "init_w"})

#: ``agg_sel`` encoding of the ``"switched"`` engine: the aggregators a
#: sweep may mix in one stack
AGG_SEL = {"hieavg": 0, "delayed_grad": 1, "fedavg": 2}
_SEL_AGG = {v: k for k, v in AGG_SEL.items()}


def replay_chain(sim) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replay the control plane as the legacy loop interleaves it: elect ->
    (maybe crash the leader) -> commit, once per global round, under the
    deployment's fault schedule.  Mutates only ``sim.chain`` (and the
    ``sim._failed_leader`` crash memo).  Returns ``(cons [T], energy [T],
    edge_avail [T, N])``, as ``repro.fl.engine.replay_chain``."""
    sched = sim.fault_schedule
    crash_at = sched.spec.leader_crash_round
    failed_edge: Optional[int] = getattr(sim, "_failed_leader", None)
    T = sim.s.t_global_rounds
    cons = np.zeros(T, np.float64)
    energy = np.zeros(T, np.float64)
    pinned = set() if failed_edge is None else {failed_edge}
    for t in range(1, T + 1):
        crash = crash_at is not None and t == crash_at and failed_edge is None
        elapsed, de, _, crashed = _faults.stalled_round(
            sim.chain, t, sched, pinned_down=pinned, crash_leader=crash)
        if crashed is not None:
            failed_edge = crashed
            sim._failed_leader = crashed
            pinned.add(crashed)
        cons[t - 1] = elapsed
        energy[t - 1] = de
    edge_avail = ~sched.edge_down & ~sched.edge_msg_drop    # [T, N]
    if failed_edge is not None:
        edge_avail[crash_at - 1:, failed_edge] = False
    return cons, energy, edge_avail


def initial_model(sim, init_params: Optional[dict] = None) -> dict:
    """The run's initial global model as float32 numpy arrays in the JAX
    layouts: ``init_params`` when given, else the port's own draw from a
    CPU generator seeded with the deployment's seed (so the model does not
    depend on the device)."""
    if init_params is None:
        g = torch.Generator()
        g.manual_seed(int(sim.seed))
        init_params = _spec.init_params(sim.specs, g)
    return {k: np.array(v, dtype=np.float32) for k, v in init_params.items()}


def build_inputs(sim, *, t_max: Optional[int] = None,
                 k_max: Optional[int] = None, n_max: Optional[int] = None,
                 j_max: Optional[int] = None,
                 steps_max: Optional[int] = None,
                 share_data_from: Optional[EngineInputs] = None,
                 init_params: Optional[dict] = None) -> EngineInputs:
    """Precompute a ``BHFLSimulator``'s whole run into its host plane.

    Bitwise ``repro.fl.engine.build_inputs`` for the same deployment and
    pad targets, except ``init_w``: drawn by the port's initialiser from
    the seed, or ``init_params`` (a dict of arrays in the JAX layouts) when
    given.  The ``*_max`` targets pad the planes inertly: padded rounds get
    zero lr and all-False masks, padded edges ``j_arr`` 0 and all-False
    ``valid`` rows, padded steps index sample 0 (the engine gives them a
    zero scale); the real extents are in ``t_valid``/``k_valid``/
    ``n_valid``/``s_valid``.  ``share_data_from``: another point's inputs
    of the same seed and data geometry, whose data plane (the same
    arrays) this one takes instead of its own.
    """
    s = sim.s
    T, K, N = s.t_global_rounds, s.k_edge_rounds, sim.N
    steps, bs = sim.steps, s.batch_size
    Tm, Km, Nm = t_max or T, k_max or K, n_max or N
    Sm = steps_max or steps
    if (Tm < T or Km < K or Nm < N or Sm < steps
            or (j_max is not None and j_max < max(sim.j_per_edge))):
        raise ValueError("pad targets must be >= the deployment's extents")

    cons_draws, energy_draws, edge_avail = replay_chain(sim)

    dense_dev, valid = strag.stack_ragged(sim.dev_masks, j_max=j_max,
                                          n_max=Nm)
    J = valid.shape[1]
    # fault plane: a down edge trains nothing for the round's K edge
    # rounds, a burst/lost-message device misses its edge round; folded
    # into the submission masks before the latency computation
    sched = sim.fault_schedule
    if sched.edge_down.any() or sched.dev_drop.any():
        dense_dev = dense_dev.copy()
        if sched.edge_down.any():
            ed = np.repeat(sched.edge_down, K, axis=0)       # [T*K, N]
            dense_dev[:T * K, :N] &= ~ed[:, :, None]
        if sched.dev_drop.any():
            dd = sched.dev_drop                              # [T*K, N, Js]
            dense_dev[:T * K, :N, :dd.shape[2]] &= ~dd
    dev_masks = np.zeros((Tm, Km, Nm, J), dtype=bool)
    dev_masks[:T, :K] = dense_dev[:T * K].reshape(T, K, Nm, J)
    edge_masks = np.zeros((Tm, Nm), dtype=bool)
    edge_masks[:T, :N] = np.asarray(sim.edge_masks[:T], dtype=bool) \
        & edge_avail

    # batch indices in legacy order: per edge round, per device, from the
    # deployment's "batches" stream
    rng = rng_streams.stream_rng(sim.seed, "batches")
    R = T * K
    pop = getattr(sim, "pop", None)
    if pop is not None:
        # population mode: one vectorized draw for every (round, slot);
        # the occupant's classes select the pools, O(R x cohort)
        ids_r = np.repeat(sim.cohort_ids, K, axis=0).reshape(R, sim.D)
        cls_rd = pop.classes[ids_r.reshape(-1)]          # [R*D, M]
        flat_idx = partition.sample_class_batches(
            sim._pool, sim._pool_off, sim._pool_cnt, cls_rd, steps, bs,
            rng).reshape(R, sim.D, steps, bs)
        flat_has = np.ones((sim.D,), np.float32)
    else:
        flat_idx = np.zeros((R, sim.D, steps, bs), np.int32)
        flat_has = np.zeros((sim.D,), np.float32)
        for r in range(R):
            for d, idx in enumerate(sim.device_idx):
                if len(idx) == 0:
                    continue
                flat_idx[r, d] = rng.choice(idx, size=(steps, bs),
                                            replace=True)
                flat_has[d] = 1.0
    # per-device round-time draws on their own stream (the batch draws stay
    # untouched by the latency accounting), over the real extents only;
    # population mode scales each slot's draw by its occupant's time_scale
    lp = sim.lat
    lrng = rng_streams.stream_rng(sim.seed, "latency")
    jm = lrng.uniform(1.0 - lp.lm_jitter, 1.0 + lp.lm_jitter, (R, sim.D))
    jp = lrng.uniform(1.0 - lp.lp_jitter, 1.0 + lp.lp_jitter, (R, sim.D))
    draw = 2.0 * lp.lm_device * jm + lp.lp_device * jp
    spd = sim.cohort_time_scale() if pop is not None else None
    if spd is not None:
        draw = draw * spd
    elif lp.rate_mult is not None:
        rm = np.asarray(lp.rate_mult, np.float64).reshape(-1)
        if rm.shape != (sim.D,):
            raise ValueError(
                f"LatencyParams.rate_mult must have one entry per device "
                f"({sim.D}), got shape {rm.shape}")
        draw = draw * rm[None, :]
    draw = draw.reshape(T, K, sim.D)
    deadline = lat.device_deadline(lp)
    sub = dense_dev[:R].reshape(T, K, Nm, J)

    batch_idx = np.zeros((Tm, Km, Nm, J, Sm, bs), np.int32)
    has_data = np.zeros((Nm, J), np.float32)
    dev_time = np.zeros((Tm, Km, Nm, J), np.float32)
    rect = flat_idx.reshape(T, K, sim.D, steps, bs)
    d = 0
    for e in range(N):
        for j in range(sim.j_per_edge[e]):
            batch_idx[:T, :K, e, j, :steps] = rect[:, :, d]
            has_data[e, j] = flat_has[d]
            # a straggler's submission is delayed; the edge closes the
            # round at the deadline without it
            dly = np.where(sub[:, :, e, j], draw[:, :, d],
                           draw[:, :, d] * lp.straggler_slowdown)
            dev_time[:T, :K, e, j] = np.minimum(dly, deadline)
            d += 1
    cons_time = np.zeros((Tm,), np.float32)
    cons_time[:T] = cons_draws * float(s.consensus_mult)
    cons_energy = np.zeros((Tm,), np.float32)
    cons_energy[:T] = energy_draws
    lr = np.zeros((Tm, Km), np.float32)
    lr[:T, :K] = paper_lr(np.arange(R), s.lr0, s.lr_decay).reshape(T, K)
    j_arr = np.zeros((Nm,), np.float32)
    j_arr[:N] = sim.j_per_edge
    # cohort churn: padded rounds and edges stay False
    cohort_change = np.zeros((Tm, Nm, J), dtype=bool)
    chg = sim.cohort_change()
    cohort_change[:T, :N, :chg.shape[2]] = chg

    if share_data_from is not None:
        src = share_data_from
        data = dict(train_x=src.train_x, train_y=src.train_y,
                    test_x=src.test_x, test_y=src.test_y, init_w=src.init_w)
    else:
        w0 = initial_model(sim, init_params)
        data = dict(train_x=np.asarray(sim.train_x)[None],
                    train_y=np.asarray(sim.train_y)[None],
                    test_x=np.asarray(sim.test_x)[None],
                    test_y=np.asarray(sim.test_y)[None],
                    init_w={k: v[None] for k, v in w0.items()})
    return EngineInputs(
        **data, seed_idx=np.int32(0),
        batch_idx=batch_idx, has_data=has_data, valid=valid,
        dev_masks=dev_masks, edge_masks=edge_masks, lr=lr, j_arr=j_arr,
        gamma0=np.float32(s.gamma0), lam=np.float32(s.lam),
        t_cold_boot=np.int32(s.t_cold_boot),
        t_valid=np.int32(T), k_valid=np.int32(K), n_valid=np.int32(N),
        s_valid=np.int32(steps),
        dev_time=dev_time, cons_time=cons_time, cons_energy=cons_energy,
        edge_hop=np.float32(2.0 * lp.lm_edge), cohort_change=cohort_change,
        agg_sel=np.int32(AGG_SEL.get(sim.aggregator, 0)),
        stale_beta=np.float32(s.staleness_discount),
        delay_delta=np.float32(s.delay_delta))


def _stacked(inp: EngineInputs) -> EngineInputs:
    """``inp`` with the leading point axis on every per-point plane and a
    ``[P]`` ``seed_idx``: a standalone run's inputs become a stack of one
    (views, no copies); a sweep bucket's stay as they are."""
    if inp.dev_masks.ndim == 5:
        P = inp.dev_masks.shape[0]
        if np.ndim(inp.seed_idx) == 0:
            inp = dataclasses.replace(
                inp, seed_idx=np.full((P,), int(inp.seed_idx), np.int32))
        return inp
    return dataclasses.replace(inp, **{
        f.name: np.asarray(getattr(inp, f.name))[None]
        for f in dataclasses.fields(EngineInputs)
        if f.name not in SHARED_DATA_FIELDS})


def _point(inp: EngineInputs, p: int) -> EngineInputs:
    """Point ``p`` of a stack, with the data plane it shares."""
    inp = _stacked(inp)
    return dataclasses.replace(inp, **{
        f.name: getattr(inp, f.name)[p]
        for f in dataclasses.fields(EngineInputs)
        if f.name not in SHARED_DATA_FIELDS})


# ---------------------------------------------------------------- the run
def host_clock(inp: EngineInputs) -> tuple[np.ndarray, np.ndarray]:
    """The simulated clock [T] and cumulative consensus energy [T] of one
    run (unstacked inputs), in float32 with the reference's operations in
    its order.

    Per edge round the slowest valid device closes the round; the K valid
    edge rounds sum into each edge's window; the global aggregation waits
    for the slowest submitting edge (all valid edges when none submitted),
    plus the edge<->leader hop, plus any consensus stall
    ``max(0, L_bc - window)`` (constraint C2).  Rounds past ``t_valid``
    repeat the last clock and energy; padded edges and slots count 0.
    """
    f32 = np.float32
    T = inp.dev_masks.shape[0]
    t_valid, k_valid = int(inp.t_valid), int(inp.k_valid)
    zero = f32(0.0)
    valid_edge = inp.j_arr > 0
    clock, energy = zero, zero
    clocks = np.zeros(T, f32)
    energies = np.zeros(T, f32)
    for t in range(T):
        if t < t_valid:
            window = np.zeros(inp.j_arr.shape, f32)
            for k in range(k_valid):
                window = window + np.max(
                    np.where(inp.valid, inp.dev_time[t, k], zero), axis=1)
            sub = inp.edge_masks[t] & valid_edge
            w = np.max(np.where(sub if sub.any() else valid_edge, window,
                                zero))
            round_time = w + inp.edge_hop + np.maximum(zero,
                                                       inp.cons_time[t] - w)
            clock = f32(clock + round_time)
            energy = f32(energy + inp.cons_energy[t])
        clocks[t], energies[t] = clock, energy
    return clocks, energies


#: the delayed-gradient churn resets the engine has applied (``"slots"``:
#: slot resets summed over rounds), counted on the host where it applies
#: them; ``CHURN_RESETS.clear()`` sets it to 0
CHURN_RESETS: collections.Counter = collections.Counter()

#: the aggregators ``run_engine_chunk`` runs; ``"switched"`` runs per point
#: the one its ``agg_sel`` names (``AGG_SEL``)
AGGREGATORS = ("hieavg", "t_fedavg", "d_fedavg", "fedavg", "delayed_grad",
               "switched")


@dataclasses.dataclass
class EngineCarry:
    """The engine's cross-round state after a global round, the carry of
    ``repro.fl.engine.init_engine_carry`` less the clock and the energy
    (``host_clock`` computes those from the host plane), every field with
    the leading point axis P (1 for a standalone run).  A run resumed from
    a saved carry is bitwise the uninterrupted one."""

    device_w: dict              # [P, N, J, ...] every device slot's model
    ehist: hieavg.History       # edge HieAvg history [P, N, J, ...]
    elast: dict                 # [P, N, J, ...] d_fedavg last weights /
    #                             delayed_grad pending updates
    ghist: hieavg.History       # global HieAvg history [P, N, ...]
    glast: dict                 # [P, N, ...] the same stores on the leader
    prev_global: dict           # [P, ...] the global model of the last round
    eage: torch.Tensor          # [P, N, J] delayed_grad consecutive misses
    gage: torch.Tensor          # [P, N] the same on the leader


def _bcast(tree: dict, at: int, *lead: int) -> dict:
    """Leaves ``[*a, ...]`` (``at`` axes in ``a``) to contiguous copies
    ``[*a, *lead, ...]``: a model per point to one per edge or device
    slot, an edge model to one per device slot."""
    out = {}
    for k, v in tree.items():
        shape = v.shape
        for _ in lead:
            v = v.unsqueeze(at)
        out[k] = v.expand(*shape[:at], *lead, *shape[at:]).contiguous()
    return out


def init_engine_carry(inp: EngineInputs, history_dtype=None, *,
                      device="cuda") -> EngineCarry:
    """The round-zero carry on ``device``: every model its seed's initial
    one, the HieAvg histories in ``history_dtype`` storage (None: float32;
    both are set up again from the first submissions), zero stores and
    ages."""
    inp = _stacked(inp)
    dev = torch.device(device)
    P, _, _, N, J = inp.dev_masks.shape
    sel = np.asarray(inp.seed_idx)
    init_w = {k: torch.from_numpy(np.array(v[sel])).to(dev)
              for k, v in inp.init_w.items()}
    edge0 = _bcast(init_w, 1, N)
    dev0 = _bcast(init_w, 1, N, J)
    return EngineCarry(
        device_w=dev0,
        ehist=hieavg.init_history_batched(dev0, history_dtype, lead=3),
        elast={k: torch.zeros_like(v) for k, v in dev0.items()},
        ghist=hieavg.init_history_batched(edge0, history_dtype),
        glast={k: torch.zeros_like(v) for k, v in edge0.items()},
        prev_global=init_w,
        eage=torch.zeros((P, N, J), dtype=torch.float32, device=dev),
        gage=torch.zeros((P, N), dtype=torch.float32, device=dev))


class _Rows:
    """A set of rows of the leading point axis: all of them, a contiguous
    run (views), or any others (gathered)."""

    def __init__(self, ids: np.ndarray, n: int, dev: torch.device):
        self.ids = ids
        self.all = len(ids) == n
        self.sl = slice(int(ids[0]), int(ids[-1]) + 1) \
            if ids[-1] - ids[0] + 1 == len(ids) else None
        self.idx = None if self.all or self.sl else \
            torch.as_tensor(ids, device=dev)

    def take(self, x):
        """Rows of a tensor, dict or ``History``."""
        if self.all or x is None:
            return x
        if isinstance(x, dict):
            return {k: self.take(v) for k, v in x.items()}
        if isinstance(x, hieavg.History):
            return hieavg.History(*(self.take(getattr(x, f.name))
                                    for f in dataclasses.fields(x)))
        return x[self.sl] if self.sl else x.index_select(0, self.idx)

    def put(self, old, new):
        """``old`` with these rows replaced by ``new`` (out of place)."""
        if self.all:
            return new
        if isinstance(new, dict):
            return {k: self.put(old[k], v) for k, v in new.items()}
        if isinstance(new, hieavg.History):
            return hieavg.History(*(self.put(getattr(old, f.name),
                                             getattr(new, f.name))
                                    for f in dataclasses.fields(new)))
        if self.sl:
            return torch.cat([old[:self.sl.start], new, old[self.sl.stop:]])
        return old.index_copy(0, self.idx, new)


def _groups(keys: list) -> list:
    """The rows of each distinct key, in first-appearance order."""
    out: dict = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return [(k, np.asarray(v)) for k, v in out.items()]


def _assemble(parts: list, n: int) -> dict:
    """Leaves ``[n, ...]`` from ``(rows, leaves of those rows)`` parts that
    cover every row once."""
    if len(parts) == 1:
        return parts[0][1]
    first = parts[0][1]
    out = {k: v.new_empty((n,) + v.shape[1:]) for k, v in first.items()}
    for rows, tree in parts:
        for k, v in tree.items():
            if rows.sl:
                out[k][rows.sl] = v
            else:
                out[k].index_copy_(0, rows.idx, v)
    return out


def run_engine_chunk(inp: EngineInputs, carry: EngineCarry, t0: int,
                     t1: int, *, aggregator: str = "hieavg", device="cuda",
                     normalize: bool = False, kernel_mode: str = "auto"
                     ) -> tuple[tuple, EngineCarry]:
    """Global rounds ``t0+1..t1`` on ``device``, from the carry after round
    ``t0``.  Returns ((accuracy, mean local loss, global-model delta norm,
    simulated clock, cumulative consensus energy), the carry after round
    ``t1``): the rows of ``repro.fl.engine.run_engine_chunk``, each
    ``[t1 - t0]`` for a standalone run's inputs and ``[P, t1 - t0]`` for a
    stack of P points (a sweep bucket, the rows of the reference's
    ``vmap``).

    The loss row is each point's last valid edge round's per-device loss
    averaged over its valid slots; the delta row is the L2 norm of its
    global model's change over the round.  Rounds past a point's
    ``t_valid`` repeat its last accuracy, clock and energy, with loss and
    delta 0.  The history storage dtype is the carry's.  ``kernel_mode``:
    see ``repro_torch.kernels.build``.
    """
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; expected one "
                         f"of {AGGREGATORS}")
    one = inp.dev_masks.ndim == 4
    inp = _stacked(inp)
    dev = torch.device(device)
    P, T, K, N, J = inp.dev_masks.shape
    if not 0 <= t0 < t1 <= T:
        raise ValueError(f"rounds {t0}..{t1} outside 0..{T}")
    steps, bs = inp.batch_idx.shape[-2:]
    NJ = N * J
    f32 = torch.float32

    def put(a):
        return torch.from_numpy(np.array(a)).to(dev)   # a writable copy

    def send(a: np.ndarray) -> torch.Tensor:
        """A fresh host array to the device without waiting for the
        device: staged in pinned memory and copied on the stream."""
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) \
            if dev.type == "cuda" else t.to(dev)

    # ---- per-point scalars stay on the host
    t_valid = inp.t_valid.astype(np.int64)
    k_valid = inp.k_valid.astype(np.int64)
    s_valid = inp.s_valid.astype(np.int64)
    t_cold = inp.t_cold_boot.astype(np.int64)
    agg_sel = inp.agg_sel.astype(np.int64)
    seed = np.asarray(inp.seed_idx, np.int64)
    n_train = inp.train_x.shape[1]

    def scalar(vals, ids):
        """A per-point scalar of rows ``ids``: a host float where they
        agree, else a ``[len(ids)]`` tensor on the device (``per_row``)."""
        v = vals[ids]
        if (v == v[0]).all():
            return float(v[0])
        return send(np.ascontiguousarray(v, np.float32))

    plans: dict = {}

    def plan(mask: np.ndarray, t: int, k: Optional[int] = None):
        """The points of ``mask`` at global round t (edge round k, or the
        global aggregation): their rows, the loss rows of those whose last
        valid edge round this is, their step validity, and their
        aggregator groups, each with its rows, points and per-point
        scalars.  Memoized by what decides them, so a round repeats no
        host work a round before it did."""
        cold_all = t <= t_cold
        key = (k, mask.tobytes(), cold_all.tobytes())
        hit = plans.get(key)
        if hit is not None:
            return hit
        ids = np.flatnonzero(mask)
        rows = _Rows(ids, P, dev)
        keys = []
        for p in ids:
            a = _SEL_AGG[int(agg_sel[p])] if aggregator == "switched" \
                else aggregator
            keys.append((a, a == "hieavg" and bool(cold_all[p])))
        groups = [(a, cold, _Rows(pos, ids.size, dev), {
            "gamma0": scalar(inp.gamma0, ids[pos]),
            "lam": scalar(inp.lam, ids[pos]),
            "beta": scalar(inp.stale_beta, ids[pos]),
            "delta": scalar(inp.delay_delta, ids[pos])})
            for (a, cold), pos in _groups(keys)]
        last = ok = step_ok = None
        if k is not None:
            pos = np.flatnonzero(k == k_valid[ids] - 1)
            last = (_Rows(pos, ids.size, dev), ids[pos]) if pos.size \
                else None
            ok = (np.arange(steps)[None, :] < s_valid[ids, None]
                  ).T.astype(np.float32)                 # [steps, P']
            if not ok.all():
                step_ok = send(np.repeat(ok, NJ, axis=1))
        hit = plans[key] = (ids, rows, groups, last, ok, step_ok)
        return hit

    # a round's lr where every point has the same one (any subset agrees)
    lr_same = (inp.lr == inp.lr[:1]).all(axis=0)          # [T, K]

    # ---- the planes of the chunk on the device, rounds leading
    train_x = put(inp.train_x.reshape((-1,) + inp.train_x.shape[2:]))
    train_y = put(inp.train_y.reshape(-1))
    img_shape = tuple(train_x.shape[1:])
    gidx = inp.batch_idx[:, t0:t1].astype(np.int64) \
        + (seed * n_train).reshape(P, 1, 1, 1, 1, 1, 1)
    batch_idx = put(gidx.transpose(1, 2, 0, 3, 4, 5, 6))  # [C, K, P, ...]
    dev_masks = put(inp.dev_masks[:, t0:t1].transpose(1, 2, 0, 3, 4))
    edge_masks = put(inp.edge_masks[:, t0:t1].transpose(1, 0, 2))
    churn = inp.cohort_change[:, t0:t1]                   # host [P, C, N, J]
    cohort_change = put(churn.transpose(1, 0, 2, 3)) if churn.any() \
        else None
    hd = put(inp.has_data)
    valid = put(inp.valid)
    v32 = valid.to(f32)
    j_arr = put(inp.j_arr)
    pw_all = j_arr / j_arr.sum(-1, keepdim=True)
    test_key = None          # the alive mask of the test sets on the device

    c = carry
    device_w, ehist, elast, eage = c.device_w, c.ehist, c.elast, c.eage
    ghist, glast, gage, prev_global = c.ghist, c.glast, c.gage, c.prev_global
    hdtype = next(iter(ehist.prev_w.values())).dtype
    # the metric rows as they come: (row kind, round, points, [n] tensor),
    # brought to the host in one copy at the end
    out_parts = []
    for t in range(t0 + 1, t1 + 1):
        tt = t - 1 - t0
        alive = t <= t_valid
        if not alive.any():
            continue
        edge_w = None
        for k in range(K):
            r = (t - 1) * K + k
            act = alive & (k < k_valid)
            if not act.any():
                continue
            act_ids, A, groups, last, ok, step_ok = plan(act, t, k)
            Pa = act_ids.size
            # ---- one local epoch for every device of the active points
            bidx = A.take(batch_idx[tt, k])               # [Pa, N, J, s, B]
            hd_a = A.take(hd)
            x = train_x[bidx] * hd_a[..., None, None, None, None, None]
            y = torch.where(hd_a[..., None, None] > 0, train_y[bidx], 0)
            lr_a = inp.lr[act_ids, t - 1, k]
            if step_ok is None and (lr_same[t - 1, k]
                                    or (lr_a == lr_a[0]).all()):
                scale = float(lr_a[0])           # one scale: every row's
            else:                                # lr x step validity a row
                scale = send(np.repeat(lr_a[None, :] * ok, NJ, axis=1))
            flat = {n: v.reshape((Pa * NJ,) + v.shape[3:])
                    for n, v in A.take(device_w).items()}
            pflat, loss = train_epoch_body(
                flat, x.reshape((Pa * NJ, steps, bs) + img_shape),
                y.reshape(Pa * NJ, steps, bs), scale, kernel_mode, step_ok)
            ws = {n: v.reshape((Pa, N, J) + v.shape[1:])
                  for n, v in pflat.items()}
            v_a = A.take(v32)
            # the loss row: a point's last valid edge round's per-device
            # loss, averaged over its valid slots
            if last is not None:
                Z, last_ids = last
                v_l = Z.take(v_a)
                out_parts.append((1, tt, last_ids, (
                    Z.take(loss.reshape(Pa, N, J)) * v_l).sum((1, 2))
                    / torch.clamp(v_l.sum((1, 2)), min=1.0)))
            dmask = A.take(dev_masks[tt, k])
            valid_a = A.take(valid)

            # ---- each point's aggregator at each of its edges
            ehist_a, elast_a, eage_a = A.take(ehist), A.take(elast), \
                A.take(eage)
            if r == 0 and aggregator in ("hieavg", "switched"):
                # the edge history starts from the first epoch
                ehist_a = hieavg.init_history_batched(ws, hdtype, lead=3)
            parts = []
            for a, cold, G, sc in groups:
                w_g, m_g, v_g = G.take(ws), G.take(dmask), G.take(v_a)
                # first edge round: everyone counts present for the
                # d_fedavg/delayed_grad stores (nothing is in flight yet)
                m_eff = m_g if r > 0 else torch.ones_like(m_g)
                if a == "hieavg" and cold:
                    em = kernel_dispatch.edge_aggregate_cold_batched(
                        w_g, G.take(valid_a), mode=kernel_mode)
                    ehist_a = G.put(ehist_a, hieavg.update_history_batched(
                        G.take(ehist_a), w_g, m_g))
                elif a == "hieavg":
                    em, h = kernel_dispatch.edge_aggregate_batched(
                        w_g, m_g, G.take(ehist_a), G.take(valid_a),
                        sc["gamma0"], sc["lam"], normalize, mode=kernel_mode)
                    ehist_a = G.put(ehist_a, h)
                elif a == "delayed_grad":
                    pend, age = G.take(elast_a), G.take(eage_a)
                    n_chg = 0 if k or cohort_change is None else int(
                        churn[act_ids[G.ids], tt].sum())
                    if n_chg:
                        # population churn at the round's first edge
                        # round: a slot with a new occupant starts from
                        # its fresh weights, age 0 (the d_fedavg store and
                        # the HieAvg histories stay keyed to the slot)
                        chg = G.take(A.take(cohort_change[tt]))
                        pend = {n: torch.where(
                            chg.reshape(chg.shape + (1,) * (w.dim() - 3)),
                            w, pend[n]) for n, w in w_g.items()}
                        age = age * (1.0 - chg.to(f32))
                        CHURN_RESETS["slots"] += n_chg
                    em, el, ea = kernel_dispatch.delayed_grad(
                        w_g, m_eff, pend, age, sc["beta"], sc["delta"], v_g,
                        mode=kernel_mode)
                    elast_a, eage_a = G.put(elast_a, el), G.put(eage_a, ea)
                elif a == "t_fedavg":
                    em = baselines.t_fedavg(w_g, m_g, v_g)
                elif a == "d_fedavg":
                    em, el = baselines.d_fedavg(w_g, m_eff, G.take(elast_a),
                                                v_g)
                    elast_a = G.put(elast_a, el)
                else:
                    em = kernel_dispatch.fedavg(w_g, v_g, mode=kernel_mode)
                parts.append((G, em))
            edge_models = _assemble(parts, Pa)
            if edge_w is None and not A.all:
                edge_w = {n: v[:, :, 0] for n, v in device_w.items()}
            edge_w = A.put(edge_w, edge_models)
            device_w = A.put(device_w, _bcast(edge_models, 2, J))
            ehist, elast, eage = A.put(ehist, ehist_a), \
                A.put(elast, elast_a), A.put(eage, eage_a)

        # ---- each point's global aggregation on its (replayed) leader
        alive_ids, L, groups, *_ = plan(alive, t)
        Pl = alive_ids.size
        em_l = L.take(edge_w)
        emask = L.take(edge_masks[tt])
        j_l, pw_l = L.take(j_arr), L.take(pw_all)
        ghist_l, glast_l, gage_l = L.take(ghist), L.take(glast), L.take(gage)
        if t == 1 and aggregator in ("hieavg", "switched"):
            ghist_l = hieavg.init_history_batched(em_l, hdtype)
        parts = []
        for a, cold, G, sc in groups:
            w_g, m_g, j_g = G.take(em_l), G.take(emask), G.take(j_l)
            m_eff = m_g if t > 1 else torch.ones_like(m_g)
            if a == "hieavg" and cold:
                gw = kernel_dispatch.global_aggregate_cold(w_g, j_g,
                                                           mode=kernel_mode)
                ghist_l = G.put(ghist_l, hieavg.update_history(
                    G.take(ghist_l), w_g, m_g))
            elif a == "hieavg":
                gw, h = kernel_dispatch.global_aggregate(
                    w_g, m_g, G.take(ghist_l), G.take(pw_l), sc["gamma0"],
                    sc["lam"], normalize, mode=kernel_mode)
                ghist_l = G.put(ghist_l, h)
            elif a == "delayed_grad":
                gw, gl, ga = kernel_dispatch.delayed_grad(
                    w_g, m_eff, G.take(glast_l), G.take(gage_l), sc["beta"],
                    sc["delta"], j_g, mode=kernel_mode)
                glast_l, gage_l = G.put(glast_l, gl), G.put(gage_l, ga)
            elif a == "t_fedavg":
                gw = baselines.t_fedavg(w_g, m_g, j_g)
            elif a == "d_fedavg":
                gw, gl = baselines.d_fedavg(w_g, m_eff, G.take(glast_l), j_g)
                glast_l = G.put(glast_l, gl)
            else:
                gw = kernel_dispatch.fedavg(w_g, j_g, mode=kernel_mode)
            parts.append((G, gw))
        global_w = _assemble(parts, Pl)
        ghist, glast, gage = L.put(ghist, ghist_l), L.put(glast, glast_l), \
            L.put(gage, gage_l)
        device_w = L.put(device_w, _bcast(global_w, 1, N, J))

        # ---- per-round metrics of the points still running
        prev_l = L.take(prev_global)
        delta = torch.sqrt(sum(
            torch.square(global_w[n] - prev_l[n]).reshape(Pl, -1).sum(-1)
            for n in sorted(global_w)))
        prev_global = L.put(prev_global, global_w)
        if test_key != alive.tobytes():
            test_key = alive.tobytes()
            test_x = put(inp.test_x[seed[alive_ids]])
            test_y = put(inp.test_y[seed[alive_ids]])
        out_parts.append((0, tt, alive_ids, cnn_accuracy_many(
            global_w, test_x, test_y, kernel_mode)))
        out_parts.append((2, tt, alive_ids, delta))

    # ---- rows past a point's t_valid repeat its last accuracy
    done = np.flatnonzero(t_valid <= t0)     # ended before this chunk
    if done.size:
        E = _Rows(done, P, dev)
        out_parts.append((0, slice(None), done, cnn_accuracy_many(
            E.take(prev_global), put(inp.test_x[seed[done]]),
            put(inp.test_y[seed[done]]), kernel_mode)))
    rows = np.zeros((3, P, t1 - t0), np.float32)
    if out_parts:
        flat = torch.cat([v for *_, v in out_parts]).cpu().numpy()
        i = 0
        for kind, tt, ids, v in out_parts:
            rows[kind, ids, tt] = flat[i:i + len(ids), None] \
                if isinstance(tt, slice) else flat[i:i + len(ids)]
            i += len(ids)
    for p in np.flatnonzero((t_valid > t0) & (t_valid < t1)):
        rows[0, p, t_valid[p] - t0:] = rows[0, p, t_valid[p] - t0 - 1]
    clocks, energies = (np.stack(x)[:, t0:t1] for x in zip(
        *(host_clock(_point(inp, p)) for p in range(P))))
    new_carry = EngineCarry(device_w=device_w, ehist=ehist, elast=elast,
                            ghist=ghist, glast=glast,
                            prev_global=prev_global, eage=eage, gage=gage)
    out = (rows[0], rows[1], rows[2], clocks, energies)
    if one:
        out = tuple(o[0] for o in out)
    return out, new_carry


def run_engine(inp: EngineInputs, *, aggregator: str = "hieavg",
               device="cuda", normalize: bool = False, history_dtype=None,
               kernel_mode: str = "auto"
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray]:
    """One whole BHFL run (or a stack of P) on ``device``:
    ``run_engine_chunk`` over all T rounds from the round-zero carry.
    Returns per global round (accuracy, mean local loss, global-model delta
    norm, simulated clock, cumulative consensus energy), each ``[T]`` (or
    ``[P, T]``), the rows of ``repro.fl.engine.run_engine``."""
    carry = init_engine_carry(inp, history_dtype, device=device)
    rows, _ = run_engine_chunk(inp, carry, 0, inp.dev_masks.shape[-4],
                               aggregator=aggregator, device=device,
                               normalize=normalize, kernel_mode=kernel_mode)
    return rows
