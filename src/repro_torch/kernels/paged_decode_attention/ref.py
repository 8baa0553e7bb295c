"""Plain PyTorch version of the paged decode-attention kernel: the
gather+SDPA route the kernel replaces (materialise each slot's virtual
view through the block table, then masked softmax attention over it).

Port of ``repro.kernels.paged_decode_attention.ref``.  It is the same
function as ``csrc/paged_decode_attention.cu`` and the TPU kernel
``paged_decode_attention_pallas`` compute; a slot with ``lengths[b] ==
0`` gives zeros.
"""
from __future__ import annotations

import torch


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd); k_pool/v_pool (n_pages, page, Hkv, hd);
    block_table (B, max_blocks); lengths (B,) -> (B, Hq, hd) f32."""
    B, Hq, hd = q.shape
    _, page, Hkv, _ = k_pool.shape
    bt = block_table.long()
    k_view = k_pool[bt].reshape(B, -1, Hkv, hd)
    v_view = v_pool[bt].reshape(B, -1, Hkv, hd)
    S = k_view.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_view.float()) * (hd ** -0.5)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask, probs, 0.0)            # len-0 lanes
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_view.float())
    return out.reshape(B, Hq, hd)


def paged_decode_attention_quant_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     k_scale_pool: torch.Tensor,
                                     v_scale_pool: torch.Tensor,
                                     block_table: torch.Tensor,
                                     lengths: torch.Tensor) -> torch.Tensor:
    """Int8-KV version: dequantise the pools to f32 (codes * scale) and
    run the plain version."""
    k = k_pool.float() * k_scale_pool[..., None]
    v = v_pool.float() * v_scale_pool[..., None]
    return paged_decode_attention_ref(q, k, v, block_table, lengths)
