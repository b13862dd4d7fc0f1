"""Copy of ``repro.core.consensus`` for the port, which imports nothing of ``repro``.

Keep the two in step: the port's host plane must stay bitwise equal to the
reference (``tests/test_torch_host_plane.py``).

Consensus zoo — pluggable consensus models for the consortium chain.

The paper fixes Raft as the consortium-chain consensus and optimizes the
round latency around its delay; production BHFL would sweep the protocol
like any other axis.  This module makes that possible: a *consensus model*
is a pair of

  * a discrete-event Monte-Carlo replay — a ``ConsensusChain`` subclass
    (``core.blockchain``) driven once per global round as
    ``elect_leader()`` → ``commit_block()``, each returning elapsed
    simulated seconds and accruing Joules on ``.energy``, raising (never
    spinning) below quorum, and
  * closed-form expected per-round latency AND energy models, pinned ≤5%
    against the replay by hypothesis-driven Monte-Carlo tests
    (tests/test_consensus_zoo.py, ``pytest -m consensus_mc``).

Protocols:

  raft     The paper's consortium Raft (``core.blockchain.RaftChain``).
           Energy = message counting (RequestVote/AppendEntries fan-outs
           + replies) × ``e_msg``.

  pofel    PoFEL-style Proof-of-Federated-Learning (arXiv:2308.07840):
           instead of hash mining, every alive node *scores* the round's
           candidate models (``n_candidates × eval_time`` seconds each,
           jittered); the best-scoring candidate's proposer wins, a vote
           round trip and block commit follow.  Energy = scoring watts ×
           total scoring seconds + messages — the protocol's point is
           that useful evaluation replaces wasted hashing.

  sharded  Layered/sharded FL chain (arXiv:2104.13130): nodes partition
           round-robin into ``n_shards`` committees; each shard finalizes
           its sub-block in parallel (a jittered 3-phase intra-shard
           round), the round closes on the *slowest* shard plus one
           cross-shard final commit.  Quorum is PER SHARD — every shard
           must hold an intra-shard majority or the model raises, just
           like Raft below global majority.

The engine consumes any model identically: the chain is replayed host-side
before the jitted run (``fl.engine.replay_chain``) into the per-round
``cons_time``/``cons_energy`` planes, so ``consensus=`` is a *data-batched*
sweep field — mixed-consensus × straggler × K grids compile as ONE padded
call (``fl.sweep.BATCHED_FIELDS``).  ``consensus_mult`` scales any
protocol's latency draws; energy is never scaled by it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from .blockchain import (Block, ConsensusChain, RaftChain, RaftParams,
                         expected_consensus_energy,
                         expected_consensus_latency)


# ------------------------------------------------------------------- PoFEL
@dataclasses.dataclass
class PoFELParams:
    """PoFEL-style consensus timing/energy parameters.

    Per round, each alive node scores ``n_candidates`` candidate models at
    ``eval_time`` seconds each (uniform ±``eval_jitter`` node-to-node);
    the committee waits for the slowest scorer, then a vote round trip and
    the block commit close the round.  ``eval_power`` is the Watts a node
    draws while scoring; ``e_msg`` the Joules per protocol message.
    """
    link_latency: float = 0.05
    block_serialize: float = 0.01
    eval_time: float = 0.08       # seconds to score ONE candidate model
    eval_jitter: float = 0.3      # node time ~ c·eval_time·U(1±jitter)
    n_candidates: int = 3         # candidate models scored per round
    eval_power: float = 2.0       # W drawn while scoring
    e_msg: float = 0.05           # J per protocol message


class PoFELChain(ConsensusChain):
    """Proof-of-Federated-Learning committee (arXiv:2308.07840 style)."""

    def __init__(self, n_nodes: int, params: Optional[PoFELParams] = None,
                 seed: int = 0):
        super().__init__(n_nodes, seed)
        self.params = params or PoFELParams()

    def elect_leader(self) -> tuple[int, float]:
        """Candidate-scoring phase: every alive node evaluates the round's
        candidates; the fastest scorer's pick leads.  Elapsed = slowest
        scorer + vote round trip.  Energy = scoring watt-seconds + the
        ``2·(A-1)`` vote messages."""
        a = self._require_majority()
        alive_ids = np.flatnonzero(self.alive)
        p = self.params
        draws = (p.n_candidates * p.eval_time
                 * self.rng.uniform(1.0 - p.eval_jitter,
                                    1.0 + p.eval_jitter, a))
        elapsed = float(draws.max()) + 2.0 * p.link_latency
        self.energy += (p.eval_power * float(draws.sum())
                        + 2.0 * (a - 1) * p.e_msg)
        self.term += 1
        self.leader = int(alive_ids[int(draws.argmin())])
        self.clock += elapsed
        return self.leader, elapsed

    def commit_block(self, edge_models_digest: Any, global_model_digest: Any
                     ) -> tuple[Block, float]:
        """Winner packages + broadcasts the block; finalized on majority
        ack (serialize + round trip, ``2·(A-1)`` messages)."""
        elapsed = 0.0
        if self.leader is None or not self.alive[self.leader]:
            _, t = self.elect_leader()
            elapsed += t
        a = self._require_majority()
        p = self.params
        payload = {"edges": edge_models_digest, "global": global_model_digest,
                   "term": self.term}
        elapsed += p.block_serialize + 2.0 * p.link_latency
        self.energy += 2.0 * (a - 1) * p.e_msg
        block = self._append_block(payload, elapsed)
        return block, elapsed


def expected_pofel_latency(params: PoFELParams, n_nodes: int,
                           n_alive: Optional[int] = None) -> float:
    """E[elapsed] of one PoFEL elect+commit round.

    The scoring phase is the max of A iid U(lo, hi) node times with
    ``lo = c·et·(1-j)``, ``hi = c·et·(1+j)``: ``E[max] = lo + w·A/(A+1)``.
    Add the vote round trip and the commit (serialize + round trip).
    Returns ``inf`` below quorum (the chain raises there).
    """
    a = n_nodes if n_alive is None else n_alive
    if a < n_nodes // 2 + 1:
        return float("inf")
    ct = params.n_candidates * params.eval_time
    lo = ct * (1.0 - params.eval_jitter)
    w = 2.0 * ct * params.eval_jitter
    e_scoring = lo + w * a / (a + 1.0)
    return (e_scoring + 2.0 * params.link_latency
            + params.block_serialize + 2.0 * params.link_latency)


def expected_pofel_energy(params: PoFELParams, n_nodes: int,
                          n_alive: Optional[int] = None) -> float:
    """E[energy] of one PoFEL elect+commit round, in Joules.

    Scoring: A nodes × c candidates × E[eval_time] at ``eval_power`` Watts
    (the jitter is mean-1, so it drops out of the expectation).  Messages:
    ``2·(A-1)`` votes + ``2·(A-1)`` commit acks.
    """
    a = n_nodes if n_alive is None else n_alive
    if a < n_nodes // 2 + 1:
        return float("inf")
    scoring = params.eval_power * a * params.n_candidates * params.eval_time
    return scoring + 4.0 * (a - 1) * params.e_msg


# ----------------------------------------------------------------- sharded
@dataclasses.dataclass
class ShardedParams:
    """Sharded-chain consensus parameters (arXiv:2104.13130 style).

    Nodes partition round-robin into ``n_shards`` committees (capped at the
    node count); each shard runs a 3-phase intra-shard round of base cost
    ``block_serialize + 3·link_latency``, jittered uniform ±``intra_jitter``
    shard-to-shard.  The round closes on the slowest shard plus one
    cross-shard final commit (serialize + round trip).
    """
    link_latency: float = 0.05
    block_serialize: float = 0.01
    n_shards: int = 2
    intra_jitter: float = 0.3     # shard round time ~ base·U(1±jitter)
    e_msg: float = 0.05


def _shard_sizes(n_nodes: int, n_shards: int) -> np.ndarray:
    """Round-robin shard membership counts (node i → shard i % S)."""
    s = min(n_shards, n_nodes)
    return np.bincount(np.arange(n_nodes) % s, minlength=s)


class ShardedChain(ConsensusChain):
    """Parallel shard committees with a cross-shard final commit."""

    def __init__(self, n_nodes: int, params: Optional[ShardedParams] = None,
                 seed: int = 0):
        super().__init__(n_nodes, seed)
        self.params = params or ShardedParams()
        self.n_shards = min(self.params.n_shards, n_nodes)
        self.shard_of = np.arange(n_nodes) % self.n_shards

    def _shard_alive(self) -> np.ndarray:
        """Alive count per shard, [S]."""
        return np.bincount(self.shard_of[self.alive],
                           minlength=self.n_shards)

    def _require_shard_quorum(self) -> np.ndarray:
        """Every shard needs an intra-shard majority; returns alive-per-
        shard counts.  (Losing a global majority always breaks at least
        one shard's majority, so this is at least as strict as Raft's
        gate.)"""
        sizes = np.bincount(self.shard_of, minlength=self.n_shards)
        alive = self._shard_alive()
        for s in range(self.n_shards):
            if alive[s] < sizes[s] // 2 + 1:
                raise RuntimeError(
                    f"no majority alive in shard {s} "
                    f"({alive[s]}/{sizes[s]} nodes): the shard cannot "
                    "finalize its sub-block")
        return alive

    def elect_leader(self) -> tuple[int, float]:
        """Intra-shard phase: every shard finalizes its sub-block in
        parallel; the round waits for the slowest shard.  Energy = 3-phase
        fan-outs within every shard (``3·(a_s - 1)`` messages each)."""
        alive_s = self._require_shard_quorum()
        p = self.params
        base = p.block_serialize + 3.0 * p.link_latency
        draws = base * self.rng.uniform(1.0 - p.intra_jitter,
                                        1.0 + p.intra_jitter, self.n_shards)
        elapsed = float(draws.max())
        self.energy += p.e_msg * 3.0 * float(
            np.maximum(alive_s - 1, 0).sum())
        self.term += 1
        # cross-shard coordinator: deterministic — the lowest-id alive node
        self.leader = int(np.flatnonzero(self.alive)[0])
        self.clock += elapsed
        return self.leader, elapsed

    def commit_block(self, edge_models_digest: Any, global_model_digest: Any
                     ) -> tuple[Block, float]:
        """Cross-shard final commit: shard digests reach the coordinator,
        which serializes the final block and broadcasts it shard-to-shard
        (``2·(S-1)`` messages, deterministic latency)."""
        elapsed = 0.0
        if self.leader is None or not self.alive[self.leader]:
            _, t = self.elect_leader()
            elapsed += t
        self._require_shard_quorum()
        p = self.params
        payload = {"edges": edge_models_digest, "global": global_model_digest,
                   "term": self.term}
        elapsed += p.block_serialize + 2.0 * p.link_latency
        self.energy += p.e_msg * 2.0 * (self.n_shards - 1)
        block = self._append_block(payload, elapsed)
        return block, elapsed


def _prefix_shard_alive(n_nodes: int, n_alive: int, n_shards: int
                        ) -> np.ndarray:
    """Alive-per-shard counts when the alive set is the id prefix
    ``0..n_alive-1`` under round-robin assignment — the failure pattern
    the closed forms assume (and the MC pins use: fail the highest ids).
    For an arbitrary alive set, read the counts off the chain itself."""
    s = min(n_shards, n_nodes)
    return np.bincount(np.arange(n_alive) % s, minlength=s)


def expected_sharded_latency(params: ShardedParams, n_nodes: int,
                             n_alive: Optional[int] = None) -> float:
    """E[elapsed] of one sharded elect+commit round.

    Max of S iid ``base·U(1-j, 1+j)`` shard rounds:
    ``E[max] = base·(1 + j·(S-1)/(S+1))``; plus the deterministic
    cross-shard commit.  Latency does not depend on the alive count (only
    the per-shard quorum gates it); returns ``inf`` when the prefix
    alive-set assumption leaves any shard below majority.
    """
    a = n_nodes if n_alive is None else n_alive
    s = min(params.n_shards, n_nodes)
    sizes = _shard_sizes(n_nodes, params.n_shards)
    alive_s = _prefix_shard_alive(n_nodes, a, params.n_shards)
    if (alive_s < sizes // 2 + 1).any():
        return float("inf")
    base = params.block_serialize + 3.0 * params.link_latency
    e_max = base * (1.0 + params.intra_jitter * (s - 1.0) / (s + 1.0))
    return e_max + params.block_serialize + 2.0 * params.link_latency


def expected_sharded_energy(params: ShardedParams, n_nodes: int,
                            n_alive: Optional[int] = None) -> float:
    """E[energy] of one sharded elect+commit round (deterministic):
    3-phase fan-outs within every shard + the cross-shard broadcast,
    under the same prefix alive-set assumption as the latency form."""
    a = n_nodes if n_alive is None else n_alive
    s = min(params.n_shards, n_nodes)
    sizes = _shard_sizes(n_nodes, params.n_shards)
    alive_s = _prefix_shard_alive(n_nodes, a, params.n_shards)
    if (alive_s < sizes // 2 + 1).any():
        return float("inf")
    intra = 3.0 * float(np.maximum(alive_s - 1, 0).sum())
    return params.e_msg * (intra + 2.0 * (s - 1))


# ---------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class ConsensusSpec:
    """One zoo entry: the MC replay + its closed-form latency/energy pair.

    ``make_params(link_latency, n_shards)`` builds the protocol's params
    from the deployment knobs a ``BHFLSetting`` carries (core never
    imports configs); ``expected_latency``/``expected_energy`` take
    ``(params, n_nodes, n_alive=None)`` and return ``inf`` below quorum.
    """
    name: str
    chain_cls: type
    params_cls: type
    make_params: Callable[[float, int], Any]
    expected_latency: Callable[..., float]
    expected_energy: Callable[..., float]


CONSENSUS_MODELS: dict[str, ConsensusSpec] = {
    "raft": ConsensusSpec(
        name="raft", chain_cls=RaftChain, params_cls=RaftParams,
        make_params=lambda link, n_shards: RaftParams(link_latency=link),
        expected_latency=expected_consensus_latency,
        expected_energy=expected_consensus_energy),
    "pofel": ConsensusSpec(
        name="pofel", chain_cls=PoFELChain, params_cls=PoFELParams,
        make_params=lambda link, n_shards: PoFELParams(link_latency=link),
        expected_latency=expected_pofel_latency,
        expected_energy=expected_pofel_energy),
    "sharded": ConsensusSpec(
        name="sharded", chain_cls=ShardedChain, params_cls=ShardedParams,
        make_params=lambda link, n_shards: ShardedParams(
            link_latency=link, n_shards=n_shards),
        expected_latency=expected_sharded_latency,
        expected_energy=expected_sharded_energy),
}


def _spec(name: str) -> ConsensusSpec:
    try:
        return CONSENSUS_MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown consensus model {name!r}; known models: "
            f"{sorted(CONSENSUS_MODELS)}") from None


def make_chain(name: str, n_nodes: int, *, link_latency: float = 0.05,
               n_shards: int = 2, seed: int = 0,
               params: Optional[Any] = None) -> ConsensusChain:
    """Build the named protocol's chain from deployment knobs.

    ``params`` overrides the knob-derived protocol params wholesale (must
    be the protocol's own params class); otherwise ``link_latency`` (all
    protocols) and ``n_shards`` (sharded only) parameterize the defaults.
    """
    spec = _spec(name)
    if params is None:
        params = spec.make_params(link_latency, n_shards)
    elif not isinstance(params, spec.params_cls):
        raise TypeError(
            f"consensus {name!r} takes {spec.params_cls.__name__} params, "
            f"got {type(params).__name__}")
    return spec.chain_cls(n_nodes, params, seed=seed)


def expected_round_latency(name: str, params: Any, n_nodes: int,
                           n_alive: Optional[int] = None) -> float:
    """The named protocol's closed-form E[per-round latency] (seconds)."""
    return _spec(name).expected_latency(params, n_nodes, n_alive)


def expected_round_energy(name: str, params: Any, n_nodes: int,
                          n_alive: Optional[int] = None) -> float:
    """The named protocol's closed-form E[per-round energy] (Joules)."""
    return _spec(name).expected_energy(params, n_nodes, n_alive)
