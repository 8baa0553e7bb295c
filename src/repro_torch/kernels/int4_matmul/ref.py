"""Plain PyTorch version of the fused int4 matmul kernel: unpack the
nibbles, scale per group in f32, and multiply in f32."""
from __future__ import annotations

import torch


def unpack_int4_ref(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (K//2, N) -> int8 (K, N), low nibble = even k, high = odd k."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    K2, N = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, group: int) -> torch.Tensor:
    """x (M, K) @ dequant(packed (K//2, N), scales (K//group, N)) -> (M, N)
    in x's dtype, computed in f32."""
    K = 2 * packed.shape[0]
    N = packed.shape[1]
    q = unpack_int4_ref(packed).float()
    w = (q.reshape(K // group, group, N) * scales[:, None, :].float()
         ).reshape(K, N)
    return (x.float() @ w).to(x.dtype)
