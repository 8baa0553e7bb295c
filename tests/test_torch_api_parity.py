"""The port's public API against the JAX package's, on the CPU.

Every public top-level function and class of each module of
``src/repro/`` (read with ``ast``: nested functions and methods do not
count) must exist in the port's counterpart module, imported or
defined.  The exceptions are named below with their reasons.  Then the
last helpers the port took over: each kernel's analytic
``traffic_bytes`` gives the reference's dict over the configs' shapes,
``quantize_int4`` / ``quantize_int8`` give its codes and scales bit for
bit at f32, and ``is_quantized_cache`` agrees on bf16 and int8 caches.
"""
import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs
from repro.kernels.decode_attention import ops as jax_da
from repro.kernels.int4_matmul import ops as jax_i4
from repro.kernels.ssd_update import ops as jax_ssd
from repro.models.model import Model as JaxModel
from repro.quant import quantize_int4 as jax_quantize_int4
from repro.quant import quantize_int8 as jax_quantize_int8
from repro.quant.kv import is_quantized_cache as jax_is_quantized_cache
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.int4_matmul import ops as i4
from repro_torch.kernels.ssd_update import ops as ssd
from repro_torch.models.model import Model
from repro_torch.quant import quantize_int4, quantize_int8
from repro_torch.quant.kv import is_quantized_cache

SRC = pathlib.Path(repro.configs.__file__).parents[1]   # src/repro
# the reference's Pallas kernels, which the port replaces with csrc/*.cu
# behind the same ops.py / ref.py modules
PALLAS = {f"kernels.{k}.{k}" for k in ("decode_attention", "int4_matmul",
                                       "paged_decode_attention", "rmsnorm",
                                       "ssd_update")}
# modules the port replaces with one of another name
RENAMED = {"analysis.hlo": "analysis.collectives"}
# names that exist only for JAX: jit_cache_size wraps a private jax.jit
# internal (the port's graph count is SchedulerPrograms'); parse_collectives
# parses XLA's HLO text, where the port counts collectives as they run
# (analysis.collectives.CollectiveCounter)
JAX_ONLY = {("serving.programs", "jit_cache_size"),
            ("analysis.hlo", "parse_collectives")}


def _public_names(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def test_every_public_name_of_the_reference_is_in_the_port():
    missing, seen = [], 0
    for path in sorted(SRC.rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        mod = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        names = _public_names(path)
        if mod in PALLAS or not names:
            continue
        port = importlib.import_module(
            "repro_torch" + ("." + RENAMED.get(mod, mod) if mod else ""))
        for name in names:
            seen += 1
            if (mod, name) not in JAX_ONLY and not hasattr(port, name):
                missing.append(f"repro.{mod}.{name}")
    assert seen > 200, f"only {seen} public names found under {SRC}"
    assert not missing, missing


def _shapes():
    return [get_config(n) for n in list_configs()]


def test_decode_attention_traffic_bytes_match_the_reference():
    for cfg in _shapes():
        if not cfg.n_kv_heads:
            continue
        for B in (1, 4):
            for S in (1, 2048, 32768):
                for kv_bytes in (1, 2):
                    args = (B, S, cfg.n_kv_heads, cfg.head_dim, kv_bytes)
                    assert da.traffic_bytes(*args) == jax_da.traffic_bytes(*args), (
                        cfg.name, args)


def test_int4_matmul_traffic_bytes_match_the_reference():
    for cfg in _shapes():
        widths = [cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff]
        for K in widths:
            for N in widths:
                if not K or not N:
                    continue
                for M in (1, 4, 2048):
                    for group in (32, 128):
                        args = (M, K, N, group)
                        assert i4.traffic_bytes(*args) == \
                            jax_i4.traffic_bytes(*args), (cfg.name, args)
    assert i4.traffic_bytes(1, 3584, 18944) == jax_i4.traffic_bytes(1, 3584, 18944)


def test_ssd_update_traffic_bytes_match_the_reference():
    ssm = [c for c in _shapes() if c.ssm_state]
    assert {c.family for c in ssm} == {"ssm", "hybrid"}
    for cfg in ssm:
        for B in (1, 8):
            args = (B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
            assert ssd.traffic_bytes(*args) == jax_ssd.traffic_bytes(*args), (
                cfg.name, args)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N,group", [(64, 48, 32), (256, 96, 128), (128, 40, 64)])
def test_quantize_int4_int8_bit_equal_to_the_reference(bits, K, N, group):
    w = np.random.default_rng(K * N + bits).standard_normal((2, K, N)).astype(np.float32)
    fn, jax_fn = ((quantize_int4, jax_quantize_int4) if bits == 4
                  else (quantize_int8, jax_quantize_int8))
    for path in ("fused", "dequant"):
        qt = fn(torch.from_numpy(w), group, path)
        qj = jax_fn(jnp.asarray(w), group, path)
        np.testing.assert_array_equal(qt.data.numpy(), np.asarray(qj.data))
        np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(qj.scales))
        assert (qt.bits, qt.path, qt.group, qt.shape) == (qj.bits, qj.path,
                                                          qj.group, qj.shape)


@pytest.mark.parametrize("paged", [False, True])
def test_is_quantized_cache_agrees_with_the_reference(paged):
    shape = dict(vocab_size=64, d_model=64, d_ff=128, n_layers=2, n_heads=4,
                 n_kv_heads=2, head_dim=16)
    jax_model = JaxModel(jax_get_config("qwen2.5-3b").reduced().replace(**shape))
    model = Model(get_config("qwen2.5-3b").reduced().replace(**shape), device="cpu")
    kw = dict(paged=True, page_size=4) if paged else dict(slotted=True)
    for jax_dtype, dtype in ((None, None), (jnp.int8, torch.int8)):
        want = jax_is_quantized_cache(jax_model.init_cache(2, 16, kv_dtype=jax_dtype, **kw))
        assert is_quantized_cache(model.init_cache(2, 16, kv_dtype=dtype, **kw)) == want
        assert want == (dtype is not None)
