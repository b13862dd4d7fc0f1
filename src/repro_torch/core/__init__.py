"""Core library: the paper's contribution (HieAvg, stragglers, the
consensus chain, latency and the convergence bound), for the port."""
from .hieavg import (History, init_history, update_history,
                     edge_aggregate, global_aggregate, edge_aggregate_cold,
                     global_aggregate_cold)
from .baselines import fedavg, t_fedavg, d_fedavg, delayed_grad
from .rng import STREAMS, stream_rng, stream_seed, stream_seq
from .straggler import no_stragglers, permanent, temporary, from_fraction
from .blockchain import (Block, ConsensusChain, RaftChain, RaftParams,
                         expected_consensus_energy,
                         expected_consensus_latency,
                         expected_election_latency)
from .consensus import (CONSENSUS_MODELS, ConsensusSpec, PoFELChain,
                        PoFELParams, ShardedChain, ShardedParams, make_chain,
                        expected_pofel_energy, expected_pofel_latency,
                        expected_round_energy, expected_round_latency,
                        expected_sharded_energy, expected_sharded_latency)
from .latency import (LatencyParams, shannon_rate, comm_latency,
                      compute_latency, total_latency, edge_window, optimize_k,
                      KOptResult, k_axis, total_latency_k, edge_window_k,
                      optimize_k_masked, round_time, device_deadline)
from .convergence import BoundParams, omega_bound, omega_bound_k

__all__ = [
    "History", "init_history", "update_history", "edge_aggregate",
    "global_aggregate", "edge_aggregate_cold", "global_aggregate_cold",
    "fedavg", "t_fedavg", "d_fedavg", "delayed_grad",
    "STREAMS", "stream_rng", "stream_seed", "stream_seq",
    "no_stragglers", "permanent", "temporary", "from_fraction",
    "Block", "ConsensusChain", "RaftChain", "RaftParams",
    "expected_consensus_energy", "expected_consensus_latency",
    "expected_election_latency",
    "CONSENSUS_MODELS", "ConsensusSpec", "PoFELChain", "PoFELParams",
    "ShardedChain", "ShardedParams", "make_chain",
    "expected_pofel_energy", "expected_pofel_latency",
    "expected_round_energy", "expected_round_latency",
    "expected_sharded_energy", "expected_sharded_latency",
    "LatencyParams", "shannon_rate", "comm_latency", "compute_latency",
    "total_latency", "edge_window", "optimize_k", "KOptResult",
    "k_axis", "total_latency_k", "edge_window_k", "optimize_k_masked",
    "round_time", "device_deadline",
    "BoundParams", "omega_bound", "omega_bound_k",
]
