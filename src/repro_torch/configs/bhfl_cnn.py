"""Copy of ``repro.configs.bhfl_cnn`` for the port, which imports nothing of ``repro``.

Keep the two in step: the port's host plane must stay bitwise equal to the
reference (``tests/test_torch_host_plane.py``).

The paper's own experimental model (Sec. 6.1.5): a small CNN for the
MNIST-surrogate BHFL experiments — 2 conv layers, 1 max-pool, 1 dense.

Not part of the assigned-architecture grid; used by the FL simulator and
the Fig. 2-7 benchmark repros.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class BHFLSetting:
    """Sec. 6.1.1 basic setting."""
    n_edges: int = 5
    j_per_edge: int = 5
    k_edge_rounds: int = 2          # K
    t_global_rounds: int = 50       # T
    t_cold_boot: int = 2            # T_c
    gamma0: float = 0.9
    lam: float = 0.9
    lr0: float = 1e-3
    lr_decay: float = 0.90
    batch_size: int = 32
    straggler_frac: float = 0.2     # 20% per layer
    image_hw: int = 28
    cnn_c1: int = 32                # paper's conv widths (Sec. 6.1.5)
    cnn_c2: int = 64
    n_classes: int = 10
    classes_per_device: int = 1     # non_IID_1
    permanent_stop_round: int = 40
    seed: int = 0
    # --- latency fabric (Sec. 5 / Sec. 6.2.2 measured constants).  These
    # are data-batched sweep fields: the engine precomputes per-round time
    # draws from them, so a consensus-latency x topology grid is one
    # compiled call (see repro.fl.sweep.BATCHED_FIELDS).
    lm_device: float = 0.51         # E[LM]  device<->edge one-way (s)
    lp_device: float = 1.67         # E[LP]  local training per edge round
    lm_edge: float = 0.05           # E[LM'] edge<->leader one-way
    link_latency: float = 0.05      # Raft edge<->edge message (s)
    consensus_mult: float = 1.0     # scales the drawn per-round L_bc
    # --- consensus zoo (repro.core.consensus).  Both are data-batched
    # sweep fields: the protocol only changes the host-side chain replay
    # feeding the cons_time/cons_energy planes, so a mixed-consensus grid
    # compiles as one padded call.
    consensus: str = "raft"         # "raft" | "pofel" | "sharded"
    n_shards: int = 2               # sharded-chain committee count
    # --- delayed-gradient aggregation (aggregator="delayed_grad"; see
    # core.baselines.delayed_grad).  Data-batched sweep fields like the
    # latency constants: a staleness-discount grid is one compiled call.
    staleness_discount: float = 0.9  # beta — stale update weight beta**k'
    delay_delta: int = 1            # max consecutive-miss staleness; k' >
    #   delta drops the slot from the round's aggregate entirely
    # --- fault plane (repro.fl.faults).  All data-batched sweep fields:
    # faults only change host-side planes (submission masks, the replayed
    # chain's alive set and cons_time/cons_energy draws), never array
    # shapes, so a fault-rate x consensus grid compiles as one padded call.
    # Rates are per-round transition probabilities of two-state Markov
    # crash-recover processes (rate = 1/MTBF resp. 1/MTTR in rounds).
    edge_fail_rate: float = 0.0     # P[edge up -> down] per global round
    edge_recover_rate: float = 0.0  # P[edge down -> up]; 0 = never recover
    val_fail_rate: float = 0.0      # P[chain validator up -> down] per tick
    val_recover_rate: float = 0.0   # P[validator down -> up] per tick
    burst_prob: float = 0.0         # P[correlated device-outage burst] per
    #   (global round, edge): a burst masks burst_frac of the edge's
    #   devices out for that whole round
    burst_frac: float = 0.5         # fraction of devices a burst takes out
    msg_loss_prob: float = 0.0      # P[a submission message is lost], iid
    #   per device edge-round submission and per edge global submission
    max_stall_rounds: int = 0       # below-quorum consensus: bounded
    #   stall-and-retry attempts before raising (0 = immediate raise)
    stall_backoff: float = 0.5      # seconds of backoff for the first
    #   stall retry; doubles per attempt (C2-style stall in the clock)


DEFAULT = BHFLSetting()

# CPU-budget setting for the benchmark repros: same topology/rounds as the
# paper, smaller images/CNN so a full Fig. 2 sweep runs in minutes.  The
# paper's qualitative claims (straggler robustness ordering, K/J/N trends)
# are width-independent.
REDUCED = BHFLSetting(image_hw=14, cnn_c1=8, cnn_c2=16, batch_size=16,
                      lr0=0.02, lr_decay=0.3)

