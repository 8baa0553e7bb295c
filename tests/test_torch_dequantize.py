"""The dequantisation kernel's wrapper (``kernels/dequantize``) against
the JAX package's jnp ``dequantize``, on the CPU.

The plain version (what a CPU tensor takes, and what chip_smoke holds
the CUDA kernel to bit for bit) equals the reference's on the same
numpy codes and scales, bit for bit: int4 and int8, bf16, f16 and f32
out, 2-D and 3-D, groups 32 and 128.  Also: the wrapper's refusals, its
meta branch, its DTensor branch on a fake 2x2 mesh (in a subprocess: a
fake world is process-global), the launch counter's registration, and
that every route of ``quant.paths`` that multiplies by a dequantised
copy reaches the wrapper once per call.  About 15 s on one worker."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.quant.quantize import QuantizedTensor as RefQuantizedTensor
from repro.quant.quantize import dequantize as ref_dequantize
from repro_torch import kernels
from repro_torch.kernels.dequantize import ops, ref
from repro_torch.quant import QuantizedTensor, dequantize, expert_einsum, matmul, quantize
from repro_torch.quant import paths as qpaths

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
       torch.float32: jnp.float32}
BITS_OF = {torch.bfloat16: np.uint16, torch.float16: np.uint16, torch.float32: np.uint32}


def _case(bits, lead, K, N, group, seed=0):
    """Random codes over their whole range and positive f32 scales over
    twelve decades (f16 outputs meet subnormals and rounding)."""
    rng = np.random.default_rng(seed)
    if bits == 4:
        codes = rng.integers(0, 256, lead + (K // 2, N), dtype=np.uint8)
    else:
        codes = rng.integers(-128, 128, lead + (K, N)).astype(np.int8)
    G = K // group
    scales = (rng.random(lead + (G, N)) + 0.5) * 10.0 ** rng.integers(-9, 3, lead + (G, N))
    return codes, scales.astype(np.float32)


def _bits(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a).view(BITS_OF[dtype])


@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "3d"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("bits", [4, 8])
def test_plain_bit_equal_to_reference(bits, dtype, lead, group):
    codes, scales = _case(bits, lead, 256, 48, group)
    want = np.asarray(ref_dequantize(
        RefQuantizedTensor(jnp.asarray(codes), jnp.asarray(scales), bits, "fused"),
        JNP[dtype]))
    got = ops.dequantize(torch.from_numpy(codes), torch.from_numpy(scales), bits, dtype)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    view = torch.int16 if dtype != torch.float32 else torch.int32
    np.testing.assert_array_equal(got.view(view).numpy().view(BITS_OF[dtype]),
                                  _bits(want, dtype))
    # the port's QuantizedTensor route takes the same wrapper
    qt = QuantizedTensor(torch.from_numpy(codes), torch.from_numpy(scales), bits, "fused")
    assert torch.equal(dequantize(qt, dtype).view(view), got.view(view))


def test_unpack_int4_nibble_order():
    """Row 2i takes the low nibble, row 2i+1 the high; >= 8 takes 16 off."""
    packed = torch.tensor([[0x7F, 0x08, 0x9A]], dtype=torch.uint8)
    assert ref.unpack_int4(packed).tolist() == [[-1, -8, -6], [7, 0, -7]]


def test_quantize_round_trip_through_the_wrapper():
    """quantize then dequantize (the route every quantised weight takes)
    comes back within half a step of each group's scale."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 128, 32))
                         .astype(np.float32))
    for bits in (4, 8):
        qt = quantize(w, bits, 32)
        back = dequantize(qt, torch.float32)
        step = torch.repeat_interleave(qt.scales, 32, dim=-2)
        assert bool(((back - w).abs() <= 0.5 * step + 1e-6).all())


def _refusals():
    u8 = torch.zeros((64, 32), dtype=torch.uint8)
    i8 = torch.zeros((128, 32), dtype=torch.int8)
    s = torch.ones((2, 32))
    return [
        ("bits", (u8, s, 3, torch.bfloat16), ValueError, "bits must be"),
        ("int4 codes int8", (i8, s, 4, torch.bfloat16), TypeError, "uint8"),
        ("int8 codes uint8", (u8, s, 8, torch.bfloat16), TypeError, "int8"),
        ("scales bf16", (u8, s.bfloat16(), 4, torch.bfloat16), TypeError, "f32"),
        ("out int8", (u8, s, 4, torch.int8), TypeError, "bf16, f16 or f32"),
        ("out f64", (u8, s, 4, torch.float64), TypeError, "bf16, f16 or f32"),
        ("1-d", (u8[0], s[0], 4, torch.bfloat16), ValueError, "want codes"),
        ("N differs", (u8, torch.ones((2, 16)), 4, torch.bfloat16), ValueError, "want codes"),
        ("K not groups", (u8, torch.ones((3, 32)), 4, torch.bfloat16), ValueError, "want codes"),
        ("lead differs", (u8[None].expand(2, 64, 32).contiguous(), s[None],
                          4, torch.bfloat16), ValueError, "want codes"),
        ("odd int4 group", (torch.zeros((3, 32), dtype=torch.uint8), torch.ones((2, 32)),
                            4, torch.bfloat16), ValueError, "whole code rows"),
        ("strided", (u8.t(), torch.ones((2, 64)), 4, torch.bfloat16), ValueError,
         "contiguous"),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())),
                         ids=[c[0] for c in _refusals()])
def test_check_refuses(case):
    _, args, exc, msg = _refusals()[case]
    with pytest.raises(exc, match=msg):
        ops._check(*args)


def test_check_accepts_and_gives_the_group():
    codes, scales = _case(4, (2,), 256, 48, 32)
    assert ops._check(torch.from_numpy(codes), torch.from_numpy(scales), 4,
                      torch.bfloat16) == 32
    codes, scales = _case(8, (), 256, 48, 128)
    assert ops._check(torch.from_numpy(codes), torch.from_numpy(scales), 8,
                      torch.float16) == 128


def test_check_refuses_null_pointer():
    """A tensor without storage has data_ptr() 0 (a meta tensor here):
    refused before any launch (a DTensor is refused the same way; see
    the subprocess)."""
    codes = torch.empty((64, 32), dtype=torch.uint8, device="meta")
    scales = torch.empty((2, 32), device="meta")
    assert codes.data_ptr() == 0
    with pytest.raises(ValueError, match="data_ptr"):
        ops._check(codes, scales, 4, torch.bfloat16)


def test_wrapper_rejects_other_devices():
    """Neither CPU nor CUDA nor meta: the wrapper raises (a fake xpu
    tensor stands in)."""
    with FakeTensorMode():
        codes = torch.empty((64, 32), dtype=torch.uint8, device="xpu")
        scales = torch.empty((2, 32), device="xpu")
        with pytest.raises(ValueError, match="no dequantize"):
            ops.dequantize(codes, scales, 4)


@pytest.mark.parametrize("bits", [4, 8])
def test_meta_branch(bits):
    codes, scales = _case(bits, (5,), 128, 32, 32)
    before = ops.launches
    out = ops.dequantize(torch.from_numpy(codes).to("meta"),
                         torch.from_numpy(scales).to("meta"), bits, torch.bfloat16)
    assert out.is_meta and tuple(out.shape) == (5, 128, 32) and out.dtype == torch.bfloat16
    assert ops.launches == before


def test_counter_registered():
    assert "dequantize" in kernels.launch_counts()
    ops.launches = 7
    kernels.zero_launch_counts()
    assert ops.launches == 0 and kernels.launch_counts()["dequantize"] == 0


@pytest.mark.parametrize("route", ["dequant 2d", "int8_fused 2d", "int4_fused 3d",
                                   "int8_fused 3d", "int4_fused 2d"])
def test_routes_reach_the_wrapper(monkeypatch, route):
    """Each route that multiplies by a copy calls the wrapper once per
    product; the 2-D int4 kernel's route never."""
    path, dims = route.split()
    bits, mode = (8, "dequant") if path == "dequant" else (int(path[3]), "fused")
    shape = (3, 64, 32) if dims == "3d" else (64, 32)
    rng = np.random.default_rng(4)
    w = quantize(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                 bits, 32, mode)
    calls = []
    real = ops.dequantize

    def counted(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)
    monkeypatch.setattr(ops, "dequantize", counted)
    x = torch.ones((3, 5, 64)) if dims == "3d" else torch.ones((2, 64))
    y = expert_einsum("ecd,edf->ecf", x, w) if dims == "3d" else matmul(x, w)
    assert y.shape[-1] == 32
    assert calls == ([] if w.int4_kernel else [bits])
    assert qpaths.dequantize is dequantize


FAKE_MESH = r"""
import json, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.kernels.dequantize import ops, ref
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_test_mesh

out = {}
g = torch.Generator().manual_seed(0)
with fake_world(4):
    mesh = make_test_mesh(data=2, model=2, device_type="cpu")
    R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
    # rank 0's shards of an int4 (4, 128, 64) stack, group 32: 4 groups
    E, K, N, G = 4, 128, 64, 4

    def wrap(t, pl, shape):
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())
    cases = {
        # experts over data, columns over model: stays split
        "E data, N model": ((S0, S2), (E // 2, K // 2, N // 2), (E // 2, G, N // 2)),
        # K over data in whole groups (2 of 4 a rank): stays split
        "K data aligned": ((S1, R), (E, K // 4, N), (E, G // 2, N)),
    }
    for name, (pl, cs, ss) in cases.items():
        codes = torch.randint(0, 256, cs, generator=g).to(torch.uint8)
        scales = torch.rand(ss, generator=g) + 0.5
        c = wrap(codes, pl, (E, K // 2, N))
        s = wrap(scales, pl, (E, G, N))
        with CommDebugMode() as cm:
            y = ops.dequantize(c, s, 4, torch.bfloat16)
        out[name] = {"placements": [repr(p) for p in y.placements],
                     "shape": list(y.shape), "local": list(y.to_local().shape),
                     "equal": bool(torch.equal(y.to_local(),
                                               ref.dequantize_ref(codes, scales, 4,
                                                                  torch.bfloat16))),
                     "comms": cm.get_total_counts()}
    # K over data with one group a matrix: not whole groups, gathered first
    c = wrap(torch.zeros((E, K // 4, N), dtype=torch.uint8), (S1, R), (E, K // 2, N))
    s = wrap(torch.ones((E, 1, N)), (R, R), (E, 1, N))
    with CommDebugMode() as cm:
        y = ops.dequantize(c, s, 4, torch.float32)
    out["K data unaligned"] = {"placements": [repr(p) for p in y.placements],
                               "shape": list(y.shape), "local": list(y.to_local().shape),
                               "comms": {str(k): v for k, v in cm.get_comm_counts().items()}}
    # meta DTensors (the dry run's): a meta local result
    c = wrap(torch.empty((E // 2, K // 2, N), dtype=torch.uint8, device="meta"),
             (S0, R), (E, K // 2, N))
    s = wrap(torch.empty((E // 2, G, N), device="meta"), (S0, R), (E, G, N))
    y = ops.dequantize(c, s, 4, torch.bfloat16)
    out["meta"] = {"placements": [repr(p) for p in y.placements], "shape": list(y.shape),
                   "meta": y.to_local().is_meta}
    try:
        ops._check(c, s, 4, torch.bfloat16)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_mesh():
    proc = subprocess.run([sys.executable, "-c", FAKE_MESH], env=ENV, text=True,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_dtensor_branch_keeps_whole_group_splits(fake_mesh):
    """Experts over data and columns over model, or K over data in whole
    groups: each rank dequantises its own shard, bit-equal to the plain
    version on it, with no collective; the output keeps the split."""
    a = fake_mesh["E data, N model"]
    assert a["placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
    assert a["shape"] == [4, 128, 64] and a["local"] == [2, 128, 32]
    b = fake_mesh["K data aligned"]
    assert b["placements"] == ["Shard(dim=1)", "Replicate()"]
    assert b["shape"] == [4, 128, 64] and b["local"] == [4, 64, 64]
    for case in (a, b):
        assert case["equal"] and case["comms"] == 0


def test_dtensor_branch_gathers_a_split_inside_a_group(fake_mesh):
    c = fake_mesh["K data unaligned"]
    assert c["placements"] == ["Replicate()", "Replicate()"]
    assert c["shape"] == [4, 128, 64] and c["local"] == [4, 128, 64]
    assert any("all_gather" in k for k in c["comms"]), c["comms"]


def test_dtensor_branch_on_meta_and_refused_by_check(fake_mesh):
    m = fake_mesh["meta"]
    assert m["meta"] and m["shape"] == [4, 128, 64]
    assert m["placements"] == ["Shard(dim=0)", "Replicate()"]
    assert fake_mesh["refused"] is not None and "DTensor" in fake_mesh["refused"]
