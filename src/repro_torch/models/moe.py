"""Mixture-of-Experts FFN: routed experts (capacity-based GShard/Switch
dispatch) plus optional shared experts.

Port of ``repro.models.moe``, step for step.  Dispatch is sort-free and
static-shaped: each (token, slot) assignment gets its rank within its
expert from an exclusive cumulative sum over one-hots, slots past the
expert's capacity are dropped, the kept ones are added into an
(E, C, D) buffer, the experts run as batched products over E, and the
results are gathered back and summed per token.  Capacity is a Python
int computed from the token count, so nothing is read back to the host
and a decode step that runs this captures as a CUDA graph.

Routers: softmax_topk (Qwen-MoE: softmax, then the top-k renormalised)
and sigmoid_top1 (Llama-4).  Top-k picks the lower expert index first
among equal probabilities, as ``jax.lax.top_k`` does (a stable
descending sort; ``torch.topk`` promises no order for ties).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import _dtensor as _dt
from repro_torch.launch import hints
from repro_torch.models.common import dense_init, init_mlp, mlp_forward
from repro_torch.quant.paths import expert_einsum

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    """Random MoE params drawn from ``gen`` on its device: the router
    (D, E), stacked experts ``w_up``/``w_gate`` (E, D, F) and ``w_down``
    (E, F, D), and the ``shared`` MLP when the config has one."""
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    f32 = dict(generator=gen, device=gen.device, dtype=torch.float32)
    p: Params = {
        "router": dense_init(gen, D, E, dtype),
        "w_up": (torch.randn((E, D, F_), **f32) / math.sqrt(D)).to(dtype),
        "w_down": (torch.randn((E, F_, D), **f32) / math.sqrt(F_)).to(dtype),
    }
    if cfg.mlp_gated:
        p["w_gate"] = (torch.randn((E, D, F_), **f32) / math.sqrt(D)).to(dtype)
    if cfg.shared_d_ff:
        p["shared"] = init_mlp(gen, D, cfg.shared_d_ff, cfg.mlp_gated, dtype)
    return p


def top_k_lower_first(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, xt: torch.Tensor, cfg: ArchConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, D) -> (expert_idx (T,k), gates (T,k), router_probs (T,E))."""
    logits = (xt @ p["router"]).float()
    if cfg.router_type == "sigmoid_top1":
        idx = torch.argmax(logits, dim=-1)[:, None]
        gates = torch.sigmoid(torch.gather(logits, 1, idx))
        probs = torch.softmax(logits, dim=-1)   # for the aux loss only
        return idx, gates, probs
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_lower_first(probs, cfg.top_k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    return idx, gates, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    one_hot = F.one_hot(idx.long(), n_experts).float()        # (T,k,E)
    f = torch.mean(torch.sum(one_hot, dim=1), dim=0)          # fraction per expert
    pbar = torch.mean(probs, dim=0)
    return n_experts * torch.sum(f * pbar)


def capacity_for(T: int, k: int, capacity_factor: float, E: int) -> int:
    """Slots per expert: max(int(T k cf / E), 1), rounded up to a
    multiple of 256 above 256 (the reference shards the (E, C, D)
    buffer over its data axes)."""
    capacity = max(int(T * k * capacity_factor / E), 1)
    if capacity > 256:
        capacity = (capacity + 255) // 256 * 256
    return capacity


def _dispatch_rows(n_rows: int, slot: torch.Tensor, contrib: torch.Tensor
                   ) -> torch.Tensor:
    """Zeros (n_rows, D) in contrib's dtype with each row ``contrib[i]``
    added at row ``slot[i]``.  DTensors run on local shards
    (``_dtensor.local_call``): every rank gathers all the slots and
    their rows, and D stays as it is split; DTensor has no in-place
    scatter into a tensor it would have to reshard."""
    if _dt.any_dtensor(slot, contrib):
        return _dt.local_call(lambda s, c: _dispatch_rows(n_rows, s, c),
                              [(slot, "."), (contrib, ".d")], [".d"])
    buf = torch.zeros((n_rows, contrib.shape[1]), dtype=contrib.dtype,
                      device=contrib.device)
    return buf.index_add_(0, slot, contrib)


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                with_aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar).  ``with_aux=False``
    skips the aux loss (None in its place): the decode paths discard it,
    as the reference's compiled step drops it unused."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, max(cfg.top_k, 1)
    xt = _dt.flatten_leading(x)

    idx, gates, probs = _route(p, xt, cfg)                    # (T,k)
    aux = load_balance_loss(probs, idx, E) if with_aux else None
    capacity = capacity_for(T, k, cfg.capacity_factor, E)

    # rank of each (token, slot) within its expert, in token order
    flat_e = idx.reshape(-1)                                  # (T*k,)
    experts = torch.arange(E, device=x.device)
    onehot = (flat_e[:, None] == experts).to(torch.int32)     # (T*k, E)
    ranks = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    rank = torch.gather(ranks, 1, flat_e[:, None])[:, 0]
    keep = rank < capacity

    # add tokens into (E, C, D); a dropped slot adds zeros at rank 0
    safe_rank = torch.where(keep, rank, 0)
    slot = flat_e * capacity + safe_rank                      # (T*k,) into E*C
    xs = xt[:, None].expand(T, k, D).reshape(T * k, D)        # xt[tok_of_slot]
    contrib = torch.where(keep[:, None], xs, 0)
    buf = _dispatch_rows(E * capacity, slot, contrib).view(E, capacity, D)

    # expert compute, batched over E: EP (experts over model) when E
    # divides the TP degree, else TP inside each expert (F over model)
    ep = hints.tp_divides(E)
    buf = hints.constrain(buf, ("tp" if ep else None, "dp", None))
    if cfg.mlp_gated:
        h = F.silu(expert_einsum("ecd,edf->ecf", buf, p["w_gate"])) * \
            expert_einsum("ecd,edf->ecf", buf, p["w_up"])
    else:
        h = F.gelu(expert_einsum("ecd,edf->ecf", buf, p["w_up"]),
                   approximate="tanh")
    h = hints.constrain(h, ("tp", "dp", None) if ep else (None, "dp", "tp"))
    out_buf = expert_einsum("ecf,efd->ecd", h, p["w_down"])
    out_buf = hints.constrain(out_buf, ("tp" if ep else None, "dp", None))

    # combine: gather back per assignment, weight by gate, sum over k
    gathered = _dt.take_rows(out_buf, slot)
    gathered = torch.where(keep[:, None], gathered, 0)
    weighted = gathered * gates.reshape(-1)[:, None].to(gathered.dtype)
    weighted = weighted.to(x.dtype).view(T, k, D)
    # the reference scatter-adds the k slots of each token into zeros in
    # x's dtype; a token's slots are adjacent, so this is that sum in
    # slot order, without atomics (the same bits on every call)
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + weighted[:, j]

    if cfg.shared_d_ff:
        y = y + mlp_forward(p["shared"], xt, cfg.mlp_gated)
    return _dt.unflatten_leading(y, x), aux
