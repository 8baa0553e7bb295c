"""Train-step factory: loss -> grads -> AdamW, with remat policies,
microbatch gradient accumulation and int8 gradient compression.

Port of ``repro.training.train_loop``.  Grads come from
``torch.autograd.grad`` over the param leaves (the counterpart of
``jax.value_and_grad``); params must require grad (``trainable``, once,
when the state is made).  The reference compiles the step into one
program; here ``jit_train_step`` captures the whole step (forward,
backward and the AdamW update) as one CUDA graph on the card, and runs
the plain step on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import dispatch
from repro_torch.kernels import _dtensor as _dt
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten

REMAT_POLICIES = ("none", "blocks", "full")
GRAD_COMPRESSION = (None, "int8")


def trainable(params):
    """The params made leaves that require grad (in place); returns them."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def make_loss_fn(model: Model, *, remat: str = "none", aux_weight: float = 0.01):
    """remat is applied at the layer-body level inside the model (see
    ``Model._maybe_remat``)."""
    model.remat = remat if remat in ("blocks", "full") else "none"
    return lambda p, b: model.loss(p, b, aux_weight=aux_weight)


def compress_int8(g: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Symmetric int8 quantisation and back, in g's dtype: s = amax / 127
    + 1e-12 (amax defaults to max|g|), round(g / s) (half to even, as
    jnp.round) to int8, times s."""
    if amax is None:
        amax = torch.max(torch.abs(g))
    s = amax / 127.0 + 1e-12
    return (torch.round(g / s).to(torch.int8).float() * s).to(g.dtype)


def compress_grads_int8(grads):
    """``compress_int8`` with one scale per leaf of the reference's tree:
    its ``blocks`` leaves stack every layer, so a block leaf's scale is
    the max|g| over all layers of that leaf."""
    out = {k: tree_map(compress_int8, v) for k, v in grads.items()
           if k != "blocks"}
    layers = grads["blocks"]
    amax = tree_map(lambda *gs: torch.stack([torch.max(torch.abs(g))
                                             for g in gs]).max(), *layers)
    out["blocks"] = [tree_map(compress_int8, layer, amax) for layer in layers]
    return out


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its param's layout: a ``Partial()`` part of
    a sum over ranks (a replicated weight applied to batch-split rows) is
    all-reduced, or reduce-scattered onto a sharded param, here."""
    if _dt.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(v: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's full value)."""
    return v.full_tensor() if _dt.is_dtensor(v) else v


def make_train_step(model: Model, opt: AdamW, *, remat: str = "blocks",
                    microbatches: int = 1, aux_weight: float = 0.01,
                    grad_compression: Optional[str] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) where state =
    (params, opt_state); params and moments are updated in place.

    microbatches > 1: the batch axis is split into ``microbatches``
    equal parts; their grads are summed in f32 and divided by the count,
    and the metrics are the last microbatch's, as in the reference.
    grad_compression="int8": ``compress_grads_int8`` on the gradients
    before the update."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    if grad_compression not in GRAD_COMPRESSION:
        raise ValueError(f"grad_compression must be one of {GRAD_COMPRESSION}, "
                         f"got {grad_compression!r}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    loss_fn = make_loss_fn(model, remat=remat, aux_weight=aux_weight)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        if not all(p.requires_grad for p in leaves):
            raise ValueError("params must require grad: make the state with "
                             "trainable(params)")
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a param the loss does not reach (the vlm's untied embedding)
        # gets zeros, as jax.grad gives
        grads = [torch.zeros_like(p) if g is None else _like_param(g, p)
                 for p, g in zip(leaves, grads)]
        return (tree_unflatten(params, grads),
                {k: _plain(v.detach()) for k, v in metrics.items()})

    def train_step(state: Tuple[Any, AdamWState], batch: Dict):
        params, opt_state = state
        if microbatches == 1:
            grads, metrics = grads_of(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            # zeros laid out as each param (a DTensor's too)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, metrics = grads_of(params, mb)
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                del g
            grads = tree_map(lambda acc: acc / microbatches, grads)
        if grad_compression == "int8":
            grads = compress_grads_int8(grads)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return (params, opt_state), {**metrics, **opt_metrics}

    return train_step


class _GraphStep:
    """A train step captured as one CUDA graph at its first call on the
    card (a real step, run eagerly on a side stream, then the capture);
    later calls copy the batch into the captured inputs and replay.  The
    graph updates the captured state's tensors: a call with another
    state (one restored from a checkpoint) copies it into them first,
    and every call returns the captured state.  A batch of another shape
    or dtype raises: build another ``jit_train_step`` for it."""

    def __init__(self, step: Callable):
        self.step = step
        self._cap = None

    def _capture(self, state, batch):
        device = tree_leaves(state)[0].device
        static = {k: v.clone() for k, v in batch.items()}
        out = dispatch.warm_up(lambda: self.step(state, static), device)
        self._cap = dispatch.capture(lambda: self.step(state, static)[1], static)
        self._state = state
        return out

    # staticcheck: hotpath
    def __call__(self, state, batch):
        if tree_leaves(state)[0].device.type != "cuda":
            return self.step(state, batch)
        if self._cap is None:
            return self._capture(state, batch)
        static = self._cap.inputs
        if ({k: (v.shape, v.dtype) for k, v in batch.items()}
                != {k: (v.shape, v.dtype) for k, v in static.items()}):
            raise ValueError("this train step was captured for batches of "
                             f"{ {k: tuple(v.shape) for k, v in static.items()} }; "
                             "build another jit_train_step for these")
        if state is not self._state:
            with torch.no_grad():
                for dst, src in zip(tree_leaves(self._state), tree_leaves(state)):
                    if dst is not src:
                        dst.copy_(src)
        for k, v in batch.items():
            static[k].copy_(v)
        self._cap.replay()
        return self._state, {k: v.clone() for k, v in self._cap.output.items()}


def jit_train_step(train_step: Callable) -> Callable:
    """The step as one captured CUDA graph on the card (``_GraphStep``),
    the plain step on the CPU.  The reference's ``donate_state`` has no
    counterpart: the step always updates the state in place."""
    return _GraphStep(train_step)
