"""Copy of ``repro.core.blockchain`` for the port, which imports nothing of ``repro``.

Keep the two in step: the port's host plane must stay bitwise equal to the
reference (``tests/test_torch_host_plane.py``).

Raft-based consortium blockchain (Sec. 2.3) — discrete-event simulation.

The blockchain is a control-plane protocol among edge servers; it has no TPU
compute analogue (see DESIGN.md §3), so we implement it as a faithful,
latency-accounted simulation:

  * Leader election — randomized election timeouts, term counting, majority
    votes (Raft §5.2).  Runs *before* global aggregation, overlapped with the
    K edge rounds, exactly as the paper requires to hide consensus latency.
  * Model submission — followers send edge models to the leader.
  * Block generation — the leader packages all edge models + the new global
    model into a block (hash-chained), replicates it, and commits on majority
    acknowledgement.

Every operation returns elapsed simulated time; ``consensus_latency()`` feeds
constraint C2 of the latency optimization (Sec. 5).

``ConsensusChain`` is the pluggable consensus-model interface (the MC half
of a *consensus model*; the closed-form half is the expected-latency/energy
pair each protocol registers in ``repro.core.consensus``).  ``RaftChain`` is
the paper's protocol; the PoFEL and sharded-chain alternatives live in
``repro.core.consensus``.  Every chain also accrues cumulative protocol
*energy* (Joules) on ``.energy`` — the second traced cost axis beside the
simulated clock.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Optional

import numpy as np


def _hash_payload(payload: Any) -> str:
    def default(o):
        if isinstance(o, np.ndarray):
            return hashlib.sha256(o.tobytes()).hexdigest()
        if hasattr(o, "tolist"):
            return o.tolist()
        return repr(o)
    blob = json.dumps(payload, sort_keys=True, default=default).encode()
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class Block:
    index: int
    term: int
    prev_hash: str
    payload_hash: str      # hash over {edge models, global model}
    leader: int
    timestamp: float       # simulated seconds since genesis

    @property
    def hash(self) -> str:
        return _hash_payload(dataclasses.asdict(self))


@dataclasses.dataclass
class RaftParams:
    """Timing parameters (seconds).  Defaults follow the paper's measured
    setup: ~0.05 s edge-to-edge link latency (Sec. 6.2.2, citing [8])."""
    link_latency: float = 0.05          # one-way edge<->edge message
    election_timeout: tuple[float, float] = (0.15, 0.30)  # Raft's range
    heartbeat_interval: float = 0.05
    block_serialize: float = 0.01       # leader-side block packaging
    e_msg: float = 0.05                 # J per protocol message (energy axis)


class ConsensusChain:
    """The pluggable consensus-model interface: shared block lifecycle.

    One instance per BHFL deployment; the engine drives it once per global
    round as ``elect_leader()`` → ``commit_block()``.  Subclass contract
    (what ``repro.fl.engine.replay_chain`` and the simulator rely on):

      * ``elect_leader() -> (leader id, elapsed s)`` — the per-round
        agreement phase (Raft's vote, PoFEL's candidate scoring, a sharded
        chain's intra-shard rounds).  MUST raise ``RuntimeError`` matching
        "no majority alive" when fewer than a quorum of nodes is alive —
        never spin.
      * ``commit_block(edges, global) -> (Block, elapsed s)`` — package
        the round's models into a hash-chained block and finalize it.
        Same below-quorum raise.
      * ``.energy`` — cumulative protocol energy in Joules, accrued by
        both phases; ``replay_chain`` differences it per round into the
        engine's ``cons_energy`` plane.
      * ``fail_node``/``recover_node`` and the ``.alive`` mask — leader
        failover drills mutate these mid-run.
      * ``.blocks`` (genesis at index 0) and ``validate()`` — chain
        integrity, reported per run as ``RunResult.blocks``/``chain_valid``.

    The closed-form half of a consensus model (expected per-round latency
    and energy as a function of its params and the alive count) lives next
    to each protocol and is registered in ``repro.core.consensus``; the
    hypothesis-driven Monte-Carlo pins (tests/test_consensus_zoo.py,
    ``-m consensus_mc``) hold the two halves together within 5%.
    """

    def __init__(self, n_nodes: int, seed: int = 0):
        if n_nodes < 1:
            raise ValueError("need at least one edge server")
        self.n = n_nodes
        self.rng = np.random.default_rng(seed)
        self.term = 0
        self.leader: Optional[int] = None
        self.clock = 0.0
        self.energy = 0.0               # cumulative protocol Joules
        genesis = Block(0, 0, "0" * 64, _hash_payload("genesis"), -1, 0.0)
        self.blocks: list[Block] = [genesis]
        self.alive = np.ones(n_nodes, dtype=bool)

    # ------------------------------------------------------------ membership
    def fail_node(self, i: int) -> None:
        self.alive[i] = False
        if self.leader == i:
            self.leader = None

    def recover_node(self, i: int) -> None:
        self.alive[i] = True

    def n_alive(self) -> int:
        return int(self.alive.sum())

    def _require_majority(self) -> int:
        """Quorum gate: returns the alive count, raising below majority."""
        a = self.n_alive()
        if a == 0:
            raise RuntimeError("no live edge servers")
        if a < self.n // 2 + 1:
            raise RuntimeError(
                f"no majority alive ({a}/{self.n} nodes): "
                "consensus can never be reached")
        return a

    # ------------------------------------------------------------- protocol
    def elect_leader(self) -> tuple[int, float]:
        raise NotImplementedError

    def commit_block(self, edge_models_digest: Any, global_model_digest: Any
                     ) -> tuple[Block, float]:
        raise NotImplementedError

    def _append_block(self, payload: Any, elapsed: float) -> Block:
        """Hash-chain the payload onto the tip and advance the clock."""
        block = Block(
            index=len(self.blocks),
            term=self.term,
            prev_hash=self.blocks[-1].hash,
            payload_hash=_hash_payload(payload),
            leader=self.leader,
            timestamp=self.clock,
        )
        self.blocks.append(block)
        self.clock += elapsed
        return block

    # ------------------------------------------------------------ integrity
    def validate(self) -> bool:
        for prev, blk in zip(self.blocks, self.blocks[1:]):
            if blk.prev_hash != prev.hash or blk.index != prev.index + 1:
                return False
        return True


class RaftChain(ConsensusChain):
    """N edge servers running Raft; one instance per BHFL deployment."""

    def __init__(self, n_nodes: int, params: Optional[RaftParams] = None,
                 seed: int = 0):
        super().__init__(n_nodes, seed)
        self.params = params or RaftParams()

    # ------------------------------------------------------------------ raft
    def elect_leader(self) -> tuple[int, float]:
        """Randomized-timeout election; returns (leader id, elapsed time).

        The node whose timeout fires first requests votes; it wins if a
        majority of nodes is alive (consortium setting: no byzantine voters).
        Re-draws on split timeouts within 1ms, like Raft's re-election.
        Raises ``RuntimeError`` when fewer than a majority of the N nodes
        are alive — the win condition can never hold, and silently looping
        forever (the pre-fix behaviour) hid the quorum loss from callers.

        Energy: each attempt costs one RequestVote fan-out + the vote
        replies — ``2·(A-1)`` messages at ``e_msg`` Joules each.
        """
        elapsed = 0.0
        while True:
            self.term += 1
            lo, hi = self.params.election_timeout
            alive_ids = np.flatnonzero(self.alive)
            if alive_ids.size == 0:
                raise RuntimeError("no live edge servers")
            if alive_ids.size < self.n // 2 + 1:
                raise RuntimeError(
                    f"no majority alive ({alive_ids.size}/{self.n} nodes): "
                    "a leader can never win the vote")
            timeouts = self.rng.uniform(lo, hi, size=alive_ids.size)
            order = np.argsort(timeouts)
            first, t_first = alive_ids[order[0]], timeouts[order[0]]
            split = timeouts.size > 1 and (timeouts[order[1]] - t_first) < 1e-3
            # candidate timeout + RequestVote round trip to majority
            elapsed += t_first + 2 * self.params.link_latency
            self.energy += 2.0 * (alive_ids.size - 1) * self.params.e_msg
            if self.alive.sum() >= self.n // 2 + 1 and not split:
                self.leader = int(first)
                self.clock += elapsed
                return self.leader, elapsed
            # split vote: try again (elapsed keeps accumulating)

    # ------------------------------------------------------ block lifecycle
    def commit_block(self, edge_models_digest: Any, global_model_digest: Any
                     ) -> tuple[Block, float]:
        """Leader packages + replicates a block; commits on majority ack.

        Returns (block, elapsed time).  Elapsed = serialize + AppendEntries
        round trip; with a failed leader an election is run first.  Energy:
        the AppendEntries fan-out + acks — ``2·(A-1)`` messages.
        """
        elapsed = 0.0
        if self.leader is None or not self.alive[self.leader]:
            _, t = self.elect_leader()
            elapsed += t
        payload = {"edges": edge_models_digest, "global": global_model_digest,
                   "term": self.term}
        elapsed += self.params.block_serialize + 2 * self.params.link_latency
        if self.alive.sum() < self.n // 2 + 1:
            raise RuntimeError("cannot commit: no majority alive")
        self.energy += 2.0 * (self.n_alive() - 1) * self.params.e_msg
        block = self._append_block(payload, elapsed)
        return block, elapsed

    def consensus_latency(self) -> float:
        """Expected per-round consensus latency L_bc (election amortized out:
        the paper overlaps election with edge rounds, so steady-state L_bc is
        block replication only)."""
        return self.params.block_serialize + 2 * self.params.link_latency


# --------------------------------------------------- statistical model
# Closed-form expectations of the discrete-event simulation above, used by
# the latency fabric (repro.core.latency / repro.fl.sweep) so consensus
# latency can be swept without replaying a RaftChain per grid point.  The
# discrete-event ``RaftChain`` stays the reference implementation;
# tests/test_latency_fabric.py pins these expectations against Monte-Carlo
# replay over a link_latency x N grid.

_SPLIT_EPS = 1e-3   # elect_leader's split-vote window (two timeouts < 1ms)


def expected_election_latency(params: RaftParams, n_nodes: int,
                              n_alive: Optional[int] = None) -> float:
    """E[elapsed] of ``RaftChain.elect_leader`` with ``n_alive`` live nodes.

    One attempt costs ``t_first + 2 * link_latency`` where ``t_first`` is
    the minimum of A iid U(lo, hi) timeouts: ``E[t_first] = lo + w/(A+1)``.
    An attempt fails on a split vote — the gap between the two smallest of
    A uniforms on a width-``w`` window falls under eps with probability
    ``1 - (1 - eps/w)^A`` (each consecutive uniform spacing is
    Beta(1, A)-scaled: for A=2, P(|X1-X2| > d) = (1 - d/w)^2) — so the
    attempt count is geometric and the expectation divides by the
    per-attempt success probability.  The tiny
    negative correlation between ``t_first`` and the first spacing is
    ignored (eps/w ~ 0.7%); the Monte-Carlo pin budgets for it.

    Returns ``inf`` when fewer than a majority of ``n_nodes`` is alive
    (``elect_leader`` raises in that regime — no finite expectation
    exists).
    """
    a = n_nodes if n_alive is None else n_alive
    if a < n_nodes // 2 + 1:
        return float("inf")
    lo, hi = params.election_timeout
    w = hi - lo
    e_first = lo + w / (a + 1.0)
    p_split = 1.0 - (1.0 - _SPLIT_EPS / w) ** a if a > 1 else 0.0
    return (e_first + 2.0 * params.link_latency) / (1.0 - p_split)


def expected_consensus_latency(params: RaftParams, n_nodes: int,
                               n_alive: Optional[int] = None,
                               include_election: bool = True) -> float:
    """Expected per-global-round consensus latency L_bc.

    Replication (serialize + AppendEntries round trip) is always on the
    round's critical path; the election runs once per round in the BHFL
    workflow and is included by default.  ``include_election=False`` gives
    the steady-state replication-only figure, identical to
    ``RaftChain.consensus_latency()`` (the paper amortizes the election
    into the edge window).
    """
    lbc = params.block_serialize + 2.0 * params.link_latency
    if include_election:
        lbc += expected_election_latency(params, n_nodes, n_alive)
    return lbc


def expected_consensus_energy(params: RaftParams, n_nodes: int,
                              n_alive: Optional[int] = None) -> float:
    """E[energy] of one elect+commit Raft round, in Joules.

    Message counting: every election attempt is a RequestVote fan-out plus
    the vote replies (``2·(A-1)`` messages), the commit is an AppendEntries
    fan-out plus acks (another ``2·(A-1)``).  The attempt count is the same
    split-vote geometric as ``expected_election_latency`` —
    ``E[attempts] = 1/(1 - p_split)`` — so

        E[J/round] = e_msg · 2·(A-1) · (E[attempts] + 1).

    Returns ``inf`` below quorum (the chain raises there).
    """
    a = n_nodes if n_alive is None else n_alive
    if a < n_nodes // 2 + 1:
        return float("inf")
    lo, hi = params.election_timeout
    w = hi - lo
    p_split = 1.0 - (1.0 - _SPLIT_EPS / w) ** a if a > 1 else 0.0
    e_attempts = 1.0 / (1.0 - p_split)
    return params.e_msg * 2.0 * (a - 1) * (e_attempts + 1.0)
