"""The port's analytic weight traffic follows the route its matmul takes.

For every weight path, ``quant.paths.matmul`` is run with
``dequantize`` counted (monkeypatched): a route that multiplies by a
dequantised copy (``dequant``, and ``fused`` for int8 or int4 that is not
2-D) must be charged the copy's write and read in bf16 on top of the
codes and scales, and the int4 kernel's route (2-D int4 ``fused``) only
its codes and scales.  The JAX package charges every ``fused`` weight as
codes and scales; the port's int4 route keeps that charge exactly."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import quantize_tree as jax_quantize_tree
from repro.quant import tree_weight_traffic as jax_traffic
from repro_torch.quant import (WEIGHT_PATHS, matmul, parse_path, quantize,
                               quantize_tree, tree_weight_traffic)
from repro_torch.quant import paths as qpaths

K, N = 256, 96


def _w(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def _count_dequantize(monkeypatch):
    calls = []
    real = qpaths.dequantize

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(qpaths, "dequantize", counted)
    return calls


@pytest.mark.parametrize("path", [p for p in WEIGHT_PATHS if p != "bf16"])
@pytest.mark.parametrize("shape", [(K, N), (3, K, N)], ids=["2d", "stacked"])
def test_charge_follows_the_route(monkeypatch, path, shape):
    bits, mode = parse_path(path)
    w = quantize(torch.from_numpy(_w(shape)), bits, 128, mode)
    calls = _count_dequantize(monkeypatch)
    x = torch.from_numpy(_w((2, K), 1))
    y = matmul(x, w)
    assert y.shape[-1] == N and bool(torch.isfinite(y).all())
    copies = len(calls)
    assert copies in (0, 1)
    assert (copies == 0) == w.int4_kernel
    codes = w.data.numel() * w.data.element_size()
    scales = w.scales.numel() * w.scales.element_size()
    bf16_copy = 2 * math.prod(w.shape) * 2       # written, then read back
    assert w.nbytes_streamed == codes + scales + copies * bf16_copy


@pytest.mark.parametrize("path", WEIGHT_PATHS)
def test_tree_traffic_against_the_reference(path):
    """A layer's tree: the port charges what the reference charges, but
    for int8 fused, where it adds the bf16 copy of every weight."""
    tree = {"attn": {"wq": _w((K, N)), "wo": _w((N, K), 1)},
            "mlp": {"up": _w((K, 2 * N), 2)}, "norm1": _w((K,), 3)}
    port = quantize_tree({k: ({n: torch.from_numpy(a) for n, a in v.items()}
                              if isinstance(v, dict) else torch.from_numpy(v))
                          for k, v in tree.items()}, path)
    ref = jax_quantize_tree({k: ({n: jnp.asarray(a) for n, a in v.items()}
                                 if isinstance(v, dict) else jnp.asarray(v))
                             for k, v in tree.items()}, path)
    copies = 2 * (K * N + N * K + K * 2 * N) * 2 if path == "int8_fused" else 0
    assert tree_weight_traffic(port) == pytest.approx(jax_traffic(ref) + copies)
