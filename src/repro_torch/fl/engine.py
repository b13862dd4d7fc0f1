"""The BHFL run on the card: the host plane, then T global rounds of K edge
rounds.

Port of ``repro.fl.engine`` for the five single-run aggregators
(``"hieavg"``, ``"t_fedavg"``, ``"d_fedavg"``, ``"fedavg"``,
``"delayed_grad"``).  Where the JAX package compiles a whole run into one
``lax.scan`` program, the port is a Python loop that launches the kernels
of each phase:

  * ``build_inputs`` — the host plane, bitwise the reference's: dense
    ``[N, J_max]`` device slots with a ``valid`` mask, straggler and edge
    masks, batch indices in the legacy order, the paper's ``lr`` plane,
    per-device round times, the replayed consensus chain's latency and
    energy per round (``replay_chain``).
  * ``run_engine_chunk`` — global rounds ``t0+1..t1`` from a carry (the
    cross-round state, ``init_engine_carry``): per edge round a local SGD
    epoch for all devices (conv forward/backward and SGD update kernels),
    then the aggregator at every edge (HieAvg's cold-boot mean or warm
    mix on the ``coef_agg``/``hieavg_agg`` kernels, FedAvg on
    ``coef_agg``, delayed-gradient on ``coef_agg_pair``, the
    ``t_fedavg``/``d_fedavg`` baselines in PyTorch); per global round the
    aggregator on the leader, the metric rows, and one test-set evaluation
    (conv kernels + ``eval_head``).  ``run_engine`` is one chunk over all
    T rounds.

Round tests compare global round numbers (``r == 0``, ``t == 1``,
``t <= T_c``), so chunks run back to back give the whole run's numbers.
Host-known scalars stay on the host: the learning rate of a step, the
cold-boot test, the history set-up rounds.  No SGD step waits for the
device.  The simulated clock and the consensus energy are functions of
the host plane alone, so ``host_clock`` computes them in float32 numpy
with the reference's operations in the reference's order, and they match
it exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import baselines, hieavg
from repro_torch.core import latency as lat
from repro_torch.core import rng as rng_streams
from repro_torch.core import straggler as strag
from repro_torch.fl import faults as _faults
from repro_torch.kernels import dispatch as kernel_dispatch
from repro_torch.models import cnn_accuracy, cnn_loss, stack_params
from repro_torch.models import spec as _spec
from repro_torch.optim import paper_lr


# --------------------------------------------------------------- local step
def train_epoch_body(params: dict, images: torch.Tensor,
                     labels: torch.Tensor, lr: float,
                     kernel_mode: str = "auto"
                     ) -> tuple[dict, torch.Tensor]:
    """One local epoch for all devices.  params: stacked [D, ...];
    images [D, steps, B, H, W, 1]; labels [D, steps, B]; ``lr`` a host
    float.  Returns (new stacked params, mean loss per device [D]).

    Each step takes the gradient of the sum of the per-device mean losses:
    the devices' weights are independent, so every device gets its own
    gradient, as JAX's ``vmap(value_and_grad)`` gives it.
    """
    total = None
    for s in range(images.shape[1]):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = cnn_loss(leaves, images[:, s], labels[:, s], kernel_mode)
        names = list(leaves)
        grads = torch.autograd.grad(loss.sum(), [leaves[k] for k in names])
        params = kernel_dispatch.sgd_update(
            {k: leaves[k].detach() for k in names}, dict(zip(names, grads)),
            lr, mode=kernel_mode)
        loss = loss.detach()
        total = loss if total is None else total + loss
    return params, total / images.shape[1]


# ------------------------------------------------------------ dense inputs
@dataclasses.dataclass
class EngineInputs:
    """The host plane of one run, as numpy arrays: the fields of the
    reference's ``EngineInputs`` that this slice reads (see there for each
    plane).  The data fields keep the reference's seed-major ``[S = 1]``
    axis."""

    train_x: np.ndarray       # [S, n_train, H, W, 1] f32
    train_y: np.ndarray       # [S, n_train] i32
    test_x: np.ndarray        # [S, n_test, H, W, 1] f32
    test_y: np.ndarray        # [S, n_test] i32
    init_w: dict              # [S, ...] f32 global model at t=0
    seed_idx: np.ndarray      # scalar i32
    batch_idx: np.ndarray     # [T, K, N, J, steps, B] i32 into train_x
    has_data: np.ndarray      # [N, J] f32 — 0 for empty-shard/padded slots
    valid: np.ndarray         # [N, J] bool — real device slots
    dev_masks: np.ndarray     # [T, K, N, J] bool submission masks
    edge_masks: np.ndarray    # [T, N] bool (failover already applied)
    lr: np.ndarray            # [T, K] f32 paper schedule
    j_arr: np.ndarray         # [N] f32 devices per edge
    gamma0: np.ndarray        # scalar f32
    lam: np.ndarray           # scalar f32
    t_cold_boot: np.ndarray   # scalar i32
    dev_time: np.ndarray      # [T, K, N, J] f32 per-device round time
    cons_time: np.ndarray     # [T] f32 per-round consensus latency
    cons_energy: np.ndarray   # [T] f32 per-round consensus energy (J)
    edge_hop: np.ndarray      # scalar f32 — 2 * E[LM'] edge<->leader hop
    stale_beta: np.ndarray    # scalar f32 — delayed-grad discount beta
    delay_delta: np.ndarray   # scalar f32 — delayed-grad max staleness


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


def build_inputs(sim, *, init_params: Optional[dict] = None) -> EngineInputs:
    """Precompute a ``BHFLSimulator``'s whole run into its host plane.

    Bitwise ``repro.fl.engine.build_inputs`` for the same deployment,
    except ``init_w``: drawn by the port's initialiser from the seed, or
    ``init_params`` (a dict of arrays in the JAX layouts) when given.
    """
    s = sim.s
    T, K, N = s.t_global_rounds, s.k_edge_rounds, sim.N
    steps, bs = sim.steps, s.batch_size

    cons_draws, energy_draws, edge_avail = replay_chain(sim)

    dense_dev, valid = strag.stack_ragged(sim.dev_masks)
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
    dev_masks = dense_dev[:T * K].reshape(T, K, N, J).copy()
    edge_masks = np.asarray(sim.edge_masks[:T], dtype=bool) & edge_avail

    # batch indices in legacy order: per edge round, per device, from the
    # deployment's "batches" stream
    rng = rng_streams.stream_rng(sim.seed, "batches")
    R = T * K
    flat_idx = np.zeros((R, sim.D, steps, bs), np.int32)
    flat_has = np.zeros((sim.D,), np.float32)
    for r in range(R):
        for d, idx in enumerate(sim.device_idx):
            if len(idx) == 0:
                continue
            flat_idx[r, d] = rng.choice(idx, size=(steps, bs), replace=True)
            flat_has[d] = 1.0
    # per-device round-time draws on their own stream (the batch draws stay
    # untouched by the latency accounting)
    lp = sim.lat
    lrng = rng_streams.stream_rng(sim.seed, "latency")
    jm = lrng.uniform(1.0 - lp.lm_jitter, 1.0 + lp.lm_jitter, (R, sim.D))
    jp = lrng.uniform(1.0 - lp.lp_jitter, 1.0 + lp.lp_jitter, (R, sim.D))
    draw = 2.0 * lp.lm_device * jm + lp.lp_device * jp
    if lp.rate_mult is not None:
        rm = np.asarray(lp.rate_mult, np.float64).reshape(-1)
        if rm.shape != (sim.D,):
            raise ValueError(
                f"LatencyParams.rate_mult must have one entry per device "
                f"({sim.D}), got shape {rm.shape}")
        draw = draw * rm[None, :]
    draw = draw.reshape(T, K, sim.D)
    deadline = lat.device_deadline(lp)
    sub = dense_dev[:R].reshape(T, K, N, J)

    batch_idx = np.zeros((T, K, N, J, steps, bs), np.int32)
    has_data = np.zeros((N, J), np.float32)
    dev_time = np.zeros((T, K, N, J), np.float32)
    rect = flat_idx.reshape(T, K, sim.D, steps, bs)
    d = 0
    for e in range(N):
        for j in range(sim.j_per_edge[e]):
            batch_idx[:, :, e, j] = rect[:, :, d]
            has_data[e, j] = flat_has[d]
            # a straggler's submission is delayed; the edge closes the
            # round at the deadline without it
            dly = np.where(sub[:, :, e, j], draw[:, :, d],
                           draw[:, :, d] * lp.straggler_slowdown)
            dev_time[:, :, e, j] = np.minimum(dly, deadline)
            d += 1
    cons_time = (cons_draws * float(s.consensus_mult)).astype(np.float32)
    cons_energy = energy_draws.astype(np.float32)
    lr = paper_lr(np.arange(R), s.lr0, s.lr_decay).reshape(T, K)
    j_arr = np.asarray(sim.j_per_edge, np.float32)

    if init_params is None:
        # the port's own draw: a CPU generator seeded with the deployment's
        # seed, so the initial model does not depend on the device
        g = torch.Generator()
        g.manual_seed(int(sim.seed))
        init_params = _spec.init_params(sim.specs, g)
    w0 = {k: np.array(v, dtype=np.float32) for k, v in init_params.items()}
    return EngineInputs(
        train_x=np.asarray(sim.train_x)[None],
        train_y=np.asarray(sim.train_y)[None],
        test_x=np.asarray(sim.test_x)[None],
        test_y=np.asarray(sim.test_y)[None],
        init_w={k: v[None] for k, v in w0.items()},
        seed_idx=np.int32(0),
        batch_idx=batch_idx, has_data=has_data, valid=valid,
        dev_masks=dev_masks, edge_masks=edge_masks, lr=lr, j_arr=j_arr,
        gamma0=np.float32(s.gamma0), lam=np.float32(s.lam),
        t_cold_boot=np.int32(s.t_cold_boot),
        dev_time=dev_time, cons_time=cons_time, cons_energy=cons_energy,
        edge_hop=np.float32(2.0 * lp.lm_edge),
        stale_beta=np.float32(s.staleness_discount),
        delay_delta=np.float32(s.delay_delta))


# ---------------------------------------------------------------- the run
def host_clock(inp: EngineInputs) -> tuple[np.ndarray, np.ndarray]:
    """The simulated clock [T] and cumulative consensus energy [T], in
    float32 with the reference's operations in its order.

    Per edge round the slowest valid device closes the round; the K edge
    rounds sum into each edge's window; the global aggregation waits for
    the slowest submitting edge (all valid edges when none submitted),
    plus the edge<->leader hop, plus any consensus stall
    ``max(0, L_bc - window)`` (constraint C2).
    """
    f32 = np.float32
    T, K = inp.dev_masks.shape[:2]
    zero = f32(0.0)
    valid_edge = inp.j_arr > 0
    clock, energy = zero, zero
    clocks = np.zeros(T, f32)
    energies = np.zeros(T, f32)
    for t in range(T):
        window = np.zeros(inp.j_arr.shape, f32)
        for k in range(K):
            window = window + np.max(np.where(inp.valid, inp.dev_time[t, k],
                                              zero), axis=1)
        sub = inp.edge_masks[t] & valid_edge
        w = np.max(np.where(sub if sub.any() else valid_edge, window, zero))
        round_time = w + inp.edge_hop + np.maximum(zero, inp.cons_time[t] - w)
        clock = f32(clock + round_time)
        energy = f32(energy + inp.cons_energy[t])
        clocks[t], energies[t] = clock, energy
    return clocks, energies


#: the aggregators ``run_engine_chunk`` runs (the reference's traced
#: ``"switched"`` tri-select batches sweep grids and comes with the sweeps)
AGGREGATORS = ("hieavg", "t_fedavg", "d_fedavg", "fedavg", "delayed_grad")


@dataclasses.dataclass
class EngineCarry:
    """The engine's cross-round state after a global round, the carry of
    ``repro.fl.engine.init_engine_carry`` less the clock and the energy
    (``host_clock`` computes those from the host plane).  A run resumed
    from a saved carry is bitwise the uninterrupted one."""

    device_w: dict              # [N, J, ...] every device slot's model
    ehist: hieavg.History       # edge HieAvg history [N, J, ...]
    elast: dict                 # [N, J, ...] d_fedavg last weights /
    #                             delayed_grad pending updates
    ghist: hieavg.History       # global HieAvg history [N, ...]
    glast: dict                 # [N, ...] the same stores on the leader
    prev_global: dict           # [...] the global model of the last round
    eage: torch.Tensor          # [N, J] delayed_grad consecutive misses
    gage: torch.Tensor          # [N] the same on the leader


def init_engine_carry(inp: EngineInputs, history_dtype=None, *,
                      device="cuda") -> EngineCarry:
    """The round-zero carry on ``device``: every model the initial one, the
    HieAvg histories in ``history_dtype`` storage (None: float32; both are
    set up again from the first submissions), zero stores and ages."""
    dev = torch.device(device)
    N, J = inp.dev_masks.shape[2:]
    si = int(inp.seed_idx)
    init_w = {k: torch.from_numpy(np.array(v[si])).to(dev)
              for k, v in inp.init_w.items()}
    edge0 = stack_params(init_w, N)
    dev0 = stack_params(init_w, N, J)
    return EngineCarry(
        device_w=dev0,
        ehist=hieavg.init_history_batched(dev0, history_dtype),
        elast={k: torch.zeros_like(v) for k, v in dev0.items()},
        ghist=hieavg.init_history(edge0, history_dtype),
        glast={k: torch.zeros_like(v) for k, v in edge0.items()},
        prev_global=init_w,
        eage=torch.zeros((N, J), dtype=torch.float32, device=dev),
        gage=torch.zeros((N,), dtype=torch.float32, device=dev))


def run_engine_chunk(inp: EngineInputs, carry: EngineCarry, t0: int,
                     t1: int, *, aggregator: str = "hieavg", device="cuda",
                     normalize: bool = False, kernel_mode: str = "auto"
                     ) -> tuple[tuple, EngineCarry]:
    """Global rounds ``t0+1..t1`` of one BHFL run on ``device``, from the
    carry after round ``t0``.  Returns ((accuracy, mean local loss,
    global-model delta norm, simulated clock, cumulative consensus energy)
    each ``[t1 - t0]``, the carry after round ``t1``): the rows of
    ``repro.fl.engine.run_engine_chunk``.

    The loss row is the last edge round's per-device loss averaged over the
    valid slots; the delta row is the L2 norm of the global model's change
    over the round.  The history storage dtype is the carry's.
    ``kernel_mode``: see ``repro_torch.kernels.build``.
    """
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; expected one "
                         f"of {AGGREGATORS}")
    dev = torch.device(device)
    T, K, N, J = inp.dev_masks.shape
    if not 0 <= t0 < t1 <= T:
        raise ValueError(f"rounds {t0}..{t1} outside 0..{T}")
    steps, bs = inp.batch_idx.shape[-2:]
    D = N * J
    si = int(inp.seed_idx)

    def put(a):
        return torch.from_numpy(np.array(a)).to(dev)   # a writable copy

    train_x, train_y = put(inp.train_x[si]), put(inp.train_y[si])
    test_x, test_y = put(inp.test_x[si]), put(inp.test_y[si])
    batch_idx = put(inp.batch_idx[t0:t1].astype(np.int64))
    hd = put(inp.has_data)
    valid = put(inp.valid)
    v32 = valid.to(torch.float32)
    dev_masks = put(inp.dev_masks[t0:t1])
    edge_masks = put(inp.edge_masks[t0:t1])
    j_arr = put(inp.j_arr)
    pw = j_arr / j_arr.sum()
    gamma0, lam = float(inp.gamma0), float(inp.lam)
    beta, delta = float(inp.stale_beta), float(inp.delay_delta)
    t_cold = int(inp.t_cold_boot)
    img_shape = tuple(train_x.shape[1:])

    device_w, ehist, elast = carry.device_w, carry.ehist, carry.elast
    ghist, glast, prev_global = carry.ghist, carry.glast, carry.prev_global
    eage, gage = carry.eage, carry.gage
    hdtype = next(iter(ehist.prev_w.values())).dtype
    accs, losses, deltas = [], [], []
    for t in range(t0 + 1, t1 + 1):
        for k in range(K):
            r = (t - 1) * K + k
            bidx = batch_idx[t - 1 - t0, k]               # [N, J, steps, B]
            x = train_x[bidx] * hd[:, :, None, None, None, None, None]
            y = torch.where(hd[:, :, None, None] > 0, train_y[bidx], 0)
            flat = {n: v.reshape((D,) + v.shape[2:])
                    for n, v in device_w.items()}
            pflat, loss = train_epoch_body(
                flat, x.reshape((D, steps, bs) + img_shape),
                y.reshape(D, steps, bs), float(inp.lr[t - 1, k]),
                kernel_mode)
            ws = {n: v.reshape((N, J) + v.shape[1:])
                  for n, v in pflat.items()}
            dev_loss = loss.reshape(N, J)
            dmask = dev_masks[t - 1 - t0, k]
            # first edge round: everyone counts present for the
            # d_fedavg/delayed_grad stores (nothing is in flight yet)
            m_eff = dmask if r > 0 else torch.ones_like(dmask)
            if aggregator == "hieavg":
                if r == 0:  # the edge history starts from the first epoch
                    ehist = hieavg.init_history_batched(ws, hdtype)
                if t <= t_cold:
                    edge_models = kernel_dispatch.edge_aggregate_cold_batched(
                        ws, valid, mode=kernel_mode)
                    ehist = hieavg.update_history_batched(ehist, ws, dmask)
                else:
                    edge_models, ehist = kernel_dispatch.edge_aggregate_batched(
                        ws, dmask, ehist, valid, gamma0, lam, normalize,
                        mode=kernel_mode)
            elif aggregator == "delayed_grad":
                edge_models, elast, eage = kernel_dispatch.delayed_grad(
                    ws, m_eff, elast, eage, beta, delta, v32,
                    mode=kernel_mode)
            elif aggregator == "t_fedavg":
                edge_models = baselines.t_fedavg(ws, dmask, v32)
            elif aggregator == "d_fedavg":
                edge_models, elast = baselines.d_fedavg(ws, m_eff, elast, v32)
            else:
                edge_models = kernel_dispatch.fedavg(ws, v32, mode=kernel_mode)
            device_w = {n: v[:, None].expand((N, J) + v.shape[1:])
                        .contiguous() for n, v in edge_models.items()}

        # ---- global aggregation on the (replayed) leader
        emask = edge_masks[t - 1 - t0]
        m_eff = emask if t > 1 else torch.ones_like(emask)
        if aggregator == "hieavg":
            if t == 1:
                ghist = hieavg.init_history(edge_models, hdtype)
            if t <= t_cold:
                global_w = kernel_dispatch.global_aggregate_cold(
                    edge_models, j_arr, mode=kernel_mode)
                ghist = hieavg.update_history(ghist, edge_models, emask)
            else:
                global_w, ghist = kernel_dispatch.global_aggregate(
                    edge_models, emask, ghist, pw, gamma0, lam, normalize,
                    mode=kernel_mode)
        elif aggregator == "delayed_grad":
            global_w, glast, gage = kernel_dispatch.delayed_grad(
                edge_models, m_eff, glast, gage, beta, delta, j_arr,
                mode=kernel_mode)
        elif aggregator == "t_fedavg":
            global_w = baselines.t_fedavg(edge_models, emask, j_arr)
        elif aggregator == "d_fedavg":
            global_w, glast = baselines.d_fedavg(edge_models, m_eff, glast,
                                                 j_arr)
        else:
            global_w = kernel_dispatch.fedavg(edge_models, j_arr,
                                              mode=kernel_mode)
        device_w = stack_params(global_w, N, J)

        # ---- per-round metrics
        losses.append((dev_loss * v32).sum()
                      / torch.clamp(v32.sum(), min=1.0))
        deltas.append(torch.sqrt(sum(
            torch.sum(torch.square(global_w[n] - prev_global[n]))
            for n in sorted(global_w))))
        prev_global = global_w
        accs.append(cnn_accuracy(global_w, test_x, test_y, kernel_mode))

    clock, energy = host_clock(inp)
    rows = torch.stack([torch.stack(accs), torch.stack(losses),
                        torch.stack(deltas)]).cpu().numpy()
    new_carry = EngineCarry(device_w=device_w, ehist=ehist, elast=elast,
                            ghist=ghist, glast=glast,
                            prev_global=prev_global, eage=eage, gage=gage)
    return ((rows[0], rows[1], rows[2], clock[t0:t1], energy[t0:t1]),
            new_carry)


def run_engine(inp: EngineInputs, *, aggregator: str = "hieavg",
               device="cuda", normalize: bool = False, history_dtype=None,
               kernel_mode: str = "auto"
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray]:
    """One whole BHFL run on ``device``: ``run_engine_chunk`` over all T
    rounds from the round-zero carry.  Returns per global round (accuracy,
    mean local loss, global-model delta norm, simulated clock, cumulative
    consensus energy), each ``[T]``, the rows of
    ``repro.fl.engine.run_engine``."""
    carry = init_engine_carry(inp, history_dtype, device=device)
    rows, _ = run_engine_chunk(inp, carry, 0, inp.dev_masks.shape[0],
                               aggregator=aggregator, device=device,
                               normalize=normalize, kernel_mode=kernel_mode)
    return rows
