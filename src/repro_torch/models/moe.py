"""Mixture-of-Experts MLP with top-k routing (Grok-1, DeepSeek-V2-Lite).

Port of ``repro.models.moe``: capacity-based dispatch in blocks of
``MOE_BLOCK`` tokens (the whole sequence when it does not divide).  Each
block's tokens go to ``[E, capacity, D]`` buffers through a one-hot
dispatch tensor, run through the batched expert SwiGLU, and come back
weighted by the renormalised router probabilities through a one-hot
combine tensor; a token past its expert's capacity in the block is
dropped (its slot adds nothing).  The shared experts (DeepSeek) are a
dense SwiGLU on every token.  Returns the Switch-style load-balance
auxiliary loss beside the output.

The routing (probabilities -> expert index, buffer position, keep) is
``route``, apart, so that it can be fed given probabilities.  Its top-k
orders ties as ``jax.lax.top_k`` does, the lower expert index first:
random weights can saturate the router's softmax, several experts then
read exactly 0, and the order among them decides who takes a capacity
slot.

The reference's mesh hint ``EXPERT_PARALLEL_SPEC`` is ``models.hints``'
``experts_in``/``experts_out``: on a step's mesh (``launch.steps
.step_hints``) the dispatched buffers move from their token split to the
expert split and back by an all-to-all around the expert products; the
blocks stay whole on a rank (``hints.blocks``) and the combine runs on
each rank's (expert, slot) pairs (``hints.over_pairs``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import hints
from .config import ArchConfig
from .layers import norm_spec, rms_norm
from .spec import ParamSpec

f32 = torch.float32

#: token-block size for dispatch (a module attribute: tests set it)
MOE_BLOCK = 256


def moe_specs(cfg: ArchConfig, stacked: Optional[int]) -> dict:
    """Router [d, E], experts' gate/up [E, d, f] and down [E, f, d], the
    norm, and the shared experts' SwiGLU [d, f n_shared] where there are
    any."""
    m = cfg.moe
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    d = cfg.d_model
    fe = m.d_expert or cfg.d_ff
    out = {
        "router": ParamSpec(pre_s + (d, m.n_experts), pre_a + ("embed", None)),
        "gate": ParamSpec(pre_s + (m.n_experts, d, fe),
                          pre_a + ("experts", "embed", "mlp")),
        "up": ParamSpec(pre_s + (m.n_experts, d, fe),
                        pre_a + ("experts", "embed", "mlp")),
        "down": ParamSpec(pre_s + (m.n_experts, fe, d),
                          pre_a + ("experts", "mlp", "embed")),
        "norm": norm_spec(d, pre_a, pre_s),
    }
    if m.n_shared:
        out["sh_gate"] = ParamSpec(pre_s + (d, fe * m.n_shared),
                                   pre_a + ("embed", "mlp"))
        out["sh_up"] = ParamSpec(pre_s + (d, fe * m.n_shared),
                                 pre_a + ("embed", "mlp"))
        out["sh_down"] = ParamSpec(pre_s + (fe * m.n_shared, d),
                                   pre_a + ("mlp", "embed"))
    return out


def _capacity(n_tokens: int, m) -> int:
    cap = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(cap, m.top_k)


def route(probs: torch.Tensor, top_k: int, cap: int):
    """probs [..., blk, E] -> (gate values [..., blk, k] renormalised,
    expert index [..., blk, k] int64, buffer position [..., blk, k] int64,
    keep [..., blk, k] bool, one-hot [..., blk, k, E] int64).

    Top-k by a stable descending sort, so ties keep the lower expert index
    first (``jax.lax.top_k``'s order).  A (token, k) pair's position in its
    expert's buffer counts the pairs before it in the block's flattened
    (token, k) order that chose the same expert; it is kept below
    ``cap``."""
    n_e = probs.shape[-1]
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    gates = vals / vals.sum(-1, keepdim=True)
    oh = F.one_hot(idx, n_e)                                  # [..., blk, k, E]
    flat = oh.flatten(-3, -2)                                 # [..., blk k, E]
    pos = (torch.cumsum(flat, dim=-2) - flat).reshape(oh.shape)
    pos = (pos * oh).sum(-1)                                  # [..., blk, k]
    return gates, idx, pos, pos < cap, oh


def _combine(comb: torch.Tensor, eout: torch.Tensor) -> torch.Tensor:
    """``einsum("bntec,bnecd->bntd")`` as one product over the (expert,
    slot) pairs, the einsum's own form."""
    return comb.flatten(-2) @ eout.flatten(2, 3)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (x + y, aux loss, float32 0-dim).

    Router logits and softmax in float32; the dispatch and combine
    tensors ``[B, ns, blk, E, C]`` (0/1 and gate-weighted, float32) cast
    to the activations' dtype before their products, as the reference
    casts them."""
    m = cfg.moe
    b, s, d = x.shape
    h = hints.whole_seq(rms_norm(x, p["norm"], cfg.norm_eps))
    blk = MOE_BLOCK if s % MOE_BLOCK == 0 else s
    ns = s // blk
    cap = _capacity(blk, m)
    hb = hints.blocks(h.reshape(b, ns, blk, d))

    logits = hb.to(f32) @ p["router"].to(f32)                 # [b,ns,blk,E]
    probs = torch.softmax(logits, dim=-1)
    gates, _, pos, keep, oh = route(probs, m.top_k, cap)

    pos_oh = F.one_hot(torch.clamp(pos, max=cap - 1), cap).to(f32)
    send = oh.to(f32) * keep.to(f32)[..., None]               # [b,ns,blk,k,E]
    disp = torch.einsum("bntke,bntkc->bntec", send, pos_oh)
    comb = torch.einsum("bntke,bntkc->bntec", send * gates[..., None],
                        pos_oh)

    tokens = torch.einsum("bntec,bntd->bnecd", disp.to(h.dtype), hb)
    xin = hints.experts_in(tokens)
    g = torch.einsum("bnecd,edf->bnecf", xin, p["gate"])
    u = torch.einsum("bnecd,edf->bnecf", xin, p["up"])
    eout = torch.einsum("bnecf,efd->bnecd", F.silu(g) * u, p["down"])
    eout = hints.experts_out(eout, tokens)
    y = hints.over_pairs(_combine, comb.to(h.dtype), eout)
    y = y.reshape(b, s, d)

    if m.n_shared:
        hs = hints.tp_in(h, p["sh_gate"])
        y = y + (F.silu(hs @ p["sh_gate"]) * (hs @ p["sh_up"])) @ p["sh_down"]

    # Switch-style load-balance aux loss: E * sum_e f_e * P_e, f_e from the
    # routing before the capacity drop
    frac_tokens = oh.sum(-2).to(f32).mean((0, 1, 2))
    frac_prob = probs.mean((0, 1, 2))
    aux = m.n_experts * (frac_tokens * frac_prob).sum() * m.router_aux_weight
    return x + hints.seq(y), aux
