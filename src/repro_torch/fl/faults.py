"""Copy of ``repro.fl.faults`` for the port, which imports nothing of ``repro``.

Keep the two in step: the port's host plane must stay bitwise equal to the
reference (``tests/test_torch_host_plane.py``).

Chaos plane — declarative fault injection for BHFL deployments.

The paper's premise is tolerance of stragglers *and* single points of
failure, but the repro's only fault used to be one scripted
``fail_leader_at`` leader crash that masked an edge out forever.  This
module turns "decentralized and straggler-tolerant" into a measurable
claim: a declarative :class:`FaultSpec` (crash–recover processes, bursts,
message loss, bounded quorum-stall policy) is compiled once per deployment
into a :class:`FaultSchedule` of host-side per-round event planes, drawn
from the dedicated ``"faults"`` stream of the ``core.rng`` registry so
fault injection never perturbs data/batch/latency draws.

Fault processes (all off by default — an all-zero spec compiles the inert
schedule without consuming any randomness):

  * **Edge crash–recover** (``edge_fail_rate``/``edge_recover_rate``): a
    two-state Markov process per edge per *global round* (rate = 1/MTBF
    resp. 1/MTTR in rounds).  A down edge neither submits to the global
    aggregation (its ``edge_masks`` row is cleared — HieAvg's historical
    estimator spans the outage exactly as it does for stragglers, the
    ``miss_count`` axis keeps counting) nor participates in consensus
    (its chain node is failed for those rounds).  On recovery the edge
    rejoins from the latest committed global model: the engine broadcasts
    the global model to every slot each round, so rejoining is the
    existing sync, not a special path.
  * **Chain-validator churn** (``val_fail_rate``/``val_recover_rate``): an
    independent Markov process over consensus *attempt ticks* — the
    ``[T, max_stall_rounds + 1]`` grid of (round, stall attempt) slots —
    failing/recovering chain validators without touching training.  This
    is what makes alive counts, latency, and energy vary over rounds, and
    what lets a stalled round recover quorum mid-stall.
  * **Correlated device-outage bursts** (``burst_prob``/``burst_frac``):
    per (global round, edge), a burst takes ``ceil(burst_frac * J_e)``
    random devices out for the whole round (all K edge rounds) — the
    rack-switch / cell-outage failure mode iid masks cannot express.
  * **Submission message loss** (``msg_loss_prob``): iid per device
    edge-round submission and per edge global submission.  A lost message
    is indistinguishable from a straggler miss to the aggregator (the
    deadline passes without it), which is exactly the paper's model.
  * **Leader crash** (``leader_crash_round``): the paper's original
    single-point-of-failure drill, re-expressed as a one-event schedule —
    ``BHFLSimulator(fail_leader_at=t)`` routes through here and is
    parity-pinned bitwise against the pre-chaos behaviour.

Below-quorum policy: with ``max_stall_rounds=0`` a below-quorum round
raises immediately (the pre-chaos semantics, zoo-wide).  With
``max_stall_rounds=S > 0`` the round *stalls*: each retry waits
``stall_backoff * 2**attempt`` simulated seconds (accumulated into that
round's ``cons_time`` draw, i.e. counted by the engine's traced clock as
C2 consensus stall), re-applies the next validator-churn attempt tick
(recoveries may restore quorum), and re-runs the protocol round; only
after S failed retries does the ``RuntimeError`` propagate.

Everything here is host-side numpy: schedules are *data* consumed by
``fl.engine.build_inputs``/``replay_chain``, so every fault-rate field is
a data-batched sweep field (``fl.sweep.BATCHED_FIELDS``) and a fault-rate
x consensus grid compiles as ONE padded call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import rng as rng_streams

#: Draw order inside :func:`compile_schedule` — fixed and append-only so a
#: spec that enables a later process never re-keys an earlier one's draws.
_DRAW_ORDER = ("edge_process", "validator_process", "bursts", "msg_loss")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative fault model for one deployment (all processes off by
    default).  Field semantics match the ``BHFLSetting`` fault fields —
    ``from_setting`` lifts them — plus the ``leader_crash_round`` one-event
    drill; rates are per-round/tick Markov transition probabilities."""
    edge_fail_rate: float = 0.0
    edge_recover_rate: float = 0.0
    val_fail_rate: float = 0.0
    val_recover_rate: float = 0.0
    burst_prob: float = 0.0
    burst_frac: float = 0.5
    msg_loss_prob: float = 0.0
    leader_crash_round: Optional[int] = None
    max_stall_rounds: int = 0
    stall_backoff: float = 0.5

    def __post_init__(self):
        for name in ("edge_fail_rate", "edge_recover_rate", "val_fail_rate",
                     "val_recover_rate", "burst_prob", "burst_frac",
                     "msg_loss_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"FaultSpec.{name} is a probability, got {v}")
        if self.max_stall_rounds < 0:
            raise ValueError("max_stall_rounds must be >= 0, got "
                             f"{self.max_stall_rounds}")
        if self.stall_backoff < 0.0:
            raise ValueError("stall_backoff must be >= 0, got "
                             f"{self.stall_backoff}")
        if self.leader_crash_round is not None \
                and self.leader_crash_round < 1:
            raise ValueError("leader_crash_round is a 1-based global round, "
                             f"got {self.leader_crash_round}")

    @property
    def any_faults(self) -> bool:
        """True when any stochastic fault process is enabled (the leader
        crash drill alone keeps the schedule draw-free)."""
        return any(r > 0.0 for r in (
            self.edge_fail_rate, self.val_fail_rate, self.burst_prob,
            self.msg_loss_prob))

    @classmethod
    def from_setting(cls, setting,
                     leader_crash_round: Optional[int] = None) -> "FaultSpec":
        """Lift a ``BHFLSetting``'s fault fields into a spec (how the
        simulator and the sweep fabric construct fault planes — every
        field here is a data-batched sweep field)."""
        return cls(
            edge_fail_rate=setting.edge_fail_rate,
            edge_recover_rate=setting.edge_recover_rate,
            val_fail_rate=setting.val_fail_rate,
            val_recover_rate=setting.val_recover_rate,
            burst_prob=setting.burst_prob,
            burst_frac=setting.burst_frac,
            msg_loss_prob=setting.msg_loss_prob,
            leader_crash_round=leader_crash_round,
            max_stall_rounds=setting.max_stall_rounds,
            stall_backoff=setting.stall_backoff)


@dataclasses.dataclass
class FaultSchedule:
    """Compiled per-round event planes for one deployment (host numpy).

    The schedule is pure data: compiling it twice from the same (spec,
    geometry, seed) is bitwise identical, so repeated ``run()`` calls and
    checkpoint resumes replay the exact same faults.  Array contract:

      * ``edge_down [T, N]`` — edge unavailable during global round t+1
        (1-based round t ↔ row t-1): masked out of the global aggregation
        AND failed as a chain node for that round.
      * ``val_down [T, S+1, N]`` — validator-churn state at (round,
        consensus-attempt) tick; attempt 0 is the round's normal try,
        attempts 1..S its stall retries.  The process ticks through every
        cell in row-major order whether or not the attempt happens — what
        keeps the plane precompilable and replays bitwise-repeatable.
      * ``dev_drop [T*K, N, J]`` — device submission lost this edge round
        (burst ∪ message loss), folded into the engine's submission masks
        before the latency draws so a dropped device is deadline-capped
        exactly like a straggler.
      * ``edge_msg_drop [T, N]`` — the edge's global submission was lost
        (trained fine, message dropped): cleared from ``edge_masks`` only,
        the chain node stays alive.
    """
    spec: FaultSpec
    edge_down: np.ndarray       # [T, N] bool
    val_down: np.ndarray        # [T, S+1, N] bool
    dev_drop: np.ndarray        # [T*K, N, J] bool
    edge_msg_drop: np.ndarray   # [T, N] bool

    @property
    def inert(self) -> bool:
        """True when no plane carries any event (the no-fault fast path —
        ``build_inputs`` skips mask folding entirely)."""
        return not (self.edge_down.any() or self.val_down.any()
                    or self.dev_drop.any() or self.edge_msg_drop.any())

    def availability_summary(self) -> dict:
        """Per-process downtime fractions (diagnostics / bench reporting)."""
        return {
            "edge_down_frac": float(self.edge_down.mean()),
            "val_down_frac": float(self.val_down[:, 0, :].mean()),
            "dev_drop_frac": float(self.dev_drop.mean()),
            "edge_msg_drop_frac": float(self.edge_msg_drop.mean()),
        }


def _markov_down(rng: np.random.Generator, steps: int, n: int,
                 fail_rate: float, recover_rate: float) -> np.ndarray:
    """``[steps, n]`` down-state plane of n independent two-state Markov
    chains started all-up, one transition draw per step (row 0 is the
    state after the first transition)."""
    u = rng.random((steps, n))
    down = np.zeros((steps, n), dtype=bool)
    state = np.zeros(n, dtype=bool)
    for t in range(steps):
        state = np.where(state, u[t] >= recover_rate, u[t] < fail_rate)
        down[t] = state
    return down


def compile_schedule(spec: FaultSpec, *, t_rounds: int, k_rounds: int,
                     n_edges: int, j_per_edge: list, seed: int
                     ) -> FaultSchedule:
    """Compile a spec into per-round event planes for one deployment.

    All randomness comes from the deployment's ``"faults"`` stream
    (``core.rng``), drawn in the fixed ``_DRAW_ORDER``; processes whose
    rates are zero draw nothing, so enabling one process never re-keys
    another and the all-zero spec is draw-free (bitwise parity of the
    ``fail_leader_at`` drill with the pre-chaos path).  ``j_per_edge``
    slots past an edge's real device count are never dropped (they carry
    zero aggregation weight anyway).
    """
    T, K, N = t_rounds, k_rounds, n_edges
    J = max(j_per_edge) if j_per_edge else 0
    S = spec.max_stall_rounds
    rng = rng_streams.stream_rng(seed, "faults")

    edge_down = np.zeros((T, N), dtype=bool)
    if spec.edge_fail_rate > 0.0:
        edge_down = _markov_down(rng, T, N, spec.edge_fail_rate,
                                 spec.edge_recover_rate)

    val_down = np.zeros((T, S + 1, N), dtype=bool)
    if spec.val_fail_rate > 0.0:
        val_down = _markov_down(rng, T * (S + 1), N, spec.val_fail_rate,
                                spec.val_recover_rate
                                ).reshape(T, S + 1, N)

    dev_drop = np.zeros((T * K, N, J), dtype=bool)
    if spec.burst_prob > 0.0:
        hit = rng.random((T, N)) < spec.burst_prob          # [T, N]
        u = rng.random((T, N, J))                           # victim scores
        # per (round, edge) burst: ceil(burst_frac * J_e) distinct random
        # REAL devices go out for the whole round (all K edge rounds) —
        # the lowest-scoring slots among the edge's real device count
        for e, j_e in enumerate(j_per_edge):
            n_out = math.ceil(spec.burst_frac * j_e)
            if n_out == 0:
                continue
            order = np.argsort(u[:, e, :j_e], axis=-1)      # [T, j_e] perms
            out = np.zeros((T, J), dtype=bool)
            np.put_along_axis(out[:, :j_e], order[:, :n_out], True, axis=1)
            out &= hit[:, e:e + 1]
            dev_drop[:, e, :] |= np.repeat(out, K, axis=0)[:T * K]
    if spec.msg_loss_prob > 0.0:
        dev_drop |= rng.random((T * K, N, J)) < spec.msg_loss_prob

    edge_msg_drop = np.zeros((T, N), dtype=bool)
    if spec.msg_loss_prob > 0.0:
        edge_msg_drop = rng.random((T, N)) < spec.msg_loss_prob

    return FaultSchedule(spec=spec, edge_down=edge_down, val_down=val_down,
                         dev_drop=dev_drop, edge_msg_drop=edge_msg_drop)


def apply_chain_availability(chain, want_down: np.ndarray,
                             pinned_down: Optional[set] = None) -> None:
    """Diff-apply a desired down-set onto a ``ConsensusChain``'s alive mask
    via its ``fail_node``/``recover_node`` membership interface.

    ``pinned_down`` nodes (the leader-crash drill's permanent casualty)
    stay failed no matter what the churn planes say.  Recovering through
    ``recover_node`` (not by writing ``.alive``) keeps the chain's
    leader-invalidation bookkeeping honest — the wiring that used to be
    dead code.
    """
    pinned = pinned_down or set()
    for i in range(chain.n):
        down = bool(want_down[i]) or i in pinned
        if down and chain.alive[i]:
            chain.fail_node(i)
        elif not down and not chain.alive[i]:
            chain.recover_node(i)


def stalled_round(chain, t: int, schedule: FaultSchedule,
                  pinned_down: Optional[set] = None,
                  crash_leader: bool = False
                  ) -> tuple[float, float, int, Optional[int]]:
    """Run one consensus round (elect → optional leader crash → commit)
    under the schedule's bounded quorum-stall policy.

    Attempt 0 applies the round's normal validator tick; a below-quorum
    ``RuntimeError`` then triggers up to ``spec.max_stall_rounds`` stall
    retries, each adding ``stall_backoff * 2**attempt`` seconds of backoff
    and re-applying the next attempt tick (validator recoveries can
    restore quorum mid-stall) before re-running the whole protocol round.
    With ``max_stall_rounds=0`` the first failure propagates — exactly the
    pre-chaos immediate-raise semantics, for every protocol in the zoo.

    Returns ``(elapsed_s, energy_j, stall_attempts, crashed_leader)``:
    total round latency including backoff, the chain's energy delta, how
    many retries were consumed, and the leader id crashed by the drill
    (None unless ``crash_leader``).
    """
    spec = schedule.spec
    S = spec.max_stall_rounds
    pinned = set(pinned_down or ())
    e0 = chain.energy
    stall = 0.0
    crashed: Optional[int] = None
    for attempt in range(S + 1):
        want_down = schedule.edge_down[t - 1] | schedule.val_down[t - 1,
                                                                  attempt]
        apply_chain_availability(chain, want_down, pinned)
        try:
            _, t_elect = chain.elect_leader()
            if crash_leader and crashed is None:
                crashed = chain.leader
                chain.fail_node(crashed)
                pinned.add(crashed)
            _, t_commit = chain.commit_block(f"edges@t={t}",
                                             f"global@t={t}")
            return (stall + t_elect + t_commit, chain.energy - e0,
                    attempt, crashed)
        except RuntimeError as err:
            if attempt == S:
                if S == 0:
                    raise    # immediate-raise semantics: the protocol's own
                    #          quorum error propagates unchanged
                raise RuntimeError(
                    f"consensus stalled below quorum at global round {t} "
                    f"for {S} retry attempt(s) (max_stall_rounds={S}); "
                    f"{chain.n_alive()}/{chain.n} validators alive"
                    ) from err
            stall += spec.stall_backoff * (2.0 ** attempt)
    raise AssertionError("unreachable")  # pragma: no cover
