"""The plain reference: a dense GQA decoder (Qwen2 / Mistral) written out
in PyTorch, computed in float32 from the benchmark's own weights.

It follows the published models: token embedding; per layer RMSNorm, q /
k / v projections (with biases where the configuration has them), rotary
embedding in the rotate-half form at absolute positions, causal
attention with each KV head serving ``heads / kv_heads`` query heads,
the output projection and the residual; RMSNorm, the SwiGLU MLP
(``down(silu(gate(x)) * up(x))``) and the residual; a final RMSNorm and
the LM head.  No cache and no batching: every sequence runs whole, layer
by layer, with each layer's weights cast to float32 only while it runs,
and attention in blocks of queries, so that it fits beside the weights.
TF32 is off, so a float32 product is a float32 product.

``precision="float8"`` is the control: the same model with every matrix
product's operands (weights per output column, activations per row) and
the cached K and V (per token and head) rounded to float8 e4m3, the next
precision below the bfloat16 the configurations state.

It imports nothing of the port.
"""
from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import torch

PRECISIONS = ("float32", "float8")
_LAYER_LEAVES = ("wq", "wk", "wv", "wo", "gate", "up", "down", "norm1",
                 "norm2", "bq", "bk", "bv")
_MATRICES = ("wq", "wk", "wv", "wo", "gate", "up", "down")
E4M3_MAX = 448.0


def _float8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (T, H, hd); cos, sin (T, 1, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    def __init__(self, cfg: Mapping, precision: str = "float32",
                 q_block: int = 1024):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.cfg = cfg
        self.low = precision == "float8"
        self.q_block = q_block
        self.eps = float(cfg["rms_norm_eps"])

    def _linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.low:
            x = _float8(x, -1)
        return x @ w

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal attention, q (T, H, hd), k / v (T, KV, hd) -> (T, H * hd)."""
        T, H, hd = q.shape
        G = H // k.shape[1]
        out = torch.empty_like(q)
        for j in range(k.shape[1]):
            qg = q[:, j * G:(j + 1) * G].transpose(0, 1)        # (G, T, hd)
            kj, vj = k[:, j], v[:, j]
            for s in range(0, T, self.q_block):
                e = min(T, s + self.q_block)
                scores = qg[:, s:e] @ kj[:e].T / hd ** 0.5      # (G, e-s, e)
                keep = (torch.arange(e, device=q.device)[None, :]
                        <= torch.arange(s, e, device=q.device)[:, None])
                scores = scores.masked_fill(~keep, float("-inf"))
                probs = torch.softmax(scores, dim=-1)
                out[s:e, j * G:(j + 1) * G] = (probs @ vj[:e]).transpose(0, 1)
        return out.reshape(T, H * hd)

    def _layer(self, x, lw, cos, sin) -> torch.Tensor:
        cfg = self.cfg
        T = x.shape[0]
        hd = cfg["head_dim"]
        h = _rmsnorm(x, lw["norm1"], self.eps)
        q, k, v = (self._linear(h, lw[n]) for n in ("wq", "wk", "wv"))
        if "bq" in lw:
            q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
        q = _rope(q.view(T, -1, hd), cos, sin)
        k = _rope(k.view(T, -1, hd), cos, sin)
        v = v.view(T, -1, hd)
        if self.low:
            k, v = _float8(k, -1), _float8(v, -1)
        x = x + self._linear(self._attention(q, k, v), lw["wo"])
        h = _rmsnorm(x, lw["norm2"], self.eps)
        mlp = torch.nn.functional.silu(self._linear(h, lw["gate"])) \
            * self._linear(h, lw["up"])
        return x + self._linear(mlp, lw["down"])

    @torch.no_grad()
    def logits(self, w: Mapping[str, torch.Tensor],
               seqs: Sequence[Tuple[torch.Tensor, int]]) -> List[torch.Tensor]:
        """For each (tokens (T,), first) the float32 logits (T - first, V)
        at positions first .. T-1, each predicting the token after it."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg
        hd = cfg["head_dim"]
        dev = w["embed"].device
        inv_freq = 1.0 / (cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd))
        xs, rot = [], []
        for tokens, _ in seqs:
            xs.append(w["embed"][tokens].float())
            ang = torch.arange(tokens.shape[0], dtype=torch.float32,
                               device=dev)[:, None] * inv_freq
            rot.append((torch.cos(ang)[:, None], torch.sin(ang)[:, None]))
        for i in range(cfg["num_hidden_layers"]):
            lw = {n: w[n][i].float() for n in _LAYER_LEAVES if n in w}
            if self.low:
                lw.update({n: _float8(lw[n], 0) for n in _MATRICES})
            for s in range(len(xs)):
                xs[s] = self._layer(xs[s], lw, *rot[s])
            del lw
        head = w["embed" if cfg["tie_word_embeddings"] else "lm_head"].float().T
        if self.low:
            head = _float8(head, 0)
        out = []
        for (_, first), x in zip(seqs, xs):
            h = _rmsnorm(x[first:], w["final_norm"].float(), self.eps)
            out.append(self._linear(h, head))
        return out


def worst_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens[:, None].long())[:, 0]
    return float((best - got).max())
