"""The RMSNorm kernel's plain version (what the port runs for a CPU
tensor) against the JAX package's RMSNorm kernel (``repro.kernels.rmsnorm``,
the Pallas kernel in interpret mode on the CPU, as ``tests/test_kernels.py``
runs it) and against the model's ``common.rmsnorm`` for the
non-parametric variant, on the same numpy inputs.

Tolerances: f32 1e-5 (both sides compute in f32 and differ in the order
of the row sum); bf16 one bf16 spacing of the output (2^-7 relative),
as the f32 results round to bf16 on both sides and may straddle a
rounding boundary."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models.common import rmsnorm as jax_common_rmsnorm
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import common

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(jnp.bfloat16).astype(np.float32)
        w = w.astype(jnp.bfloat16).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [
    (1, 256),          # one decode row
    (300, 128),        # 300 rows: the Pallas wrapper pads to 512
    (2, 3, 64),        # leading dims flattened
    (7, 96),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(shape, dtype):
    x, w = _inputs(shape, dtype, seed=sum(shape))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_rmsnorm(jnp.asarray(x).astype(jd),
                                  jnp.asarray(w).astype(jd)).astype(jnp.float32))
    got = ops.rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    assert got.dtype == td and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonparametric_matches_jax(dtype):
    x, _ = _inputs((4, 5, 64), dtype, seed=3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_common_rmsnorm(jnp.asarray(x).astype(jd), None)
                      .astype(jnp.float32))
    got = ops.rmsnorm(torch.from_numpy(x).to(td), None)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("parametric", [True, False])
def test_model_norm_routes_cpu_tensors_to_the_plain_version(parametric):
    x, w = _inputs((3, 2, 64), "float32", seed=11)
    xt = torch.from_numpy(x)[:, -1:]             # a strided slice, as at decode
    wt = torch.from_numpy(w) if parametric else None
    before = ops.launches
    out = common.rmsnorm(xt, wt)
    assert torch.equal(out, rmsnorm_ref(xt, wt)) and ops.launches == before


def test_wrapper_rejects_other_devices():
    """A device other than the CPU, CUDA and meta (the dry run's shapes)
    raises: an xpu tensor stands in, as a fake tensor (no xpu here)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    mode = FakeTensorMode()
    x = FakeTensor(mode, torch.empty((2, 8), device="meta"), torch.device("xpu"))
    with mode, pytest.raises(ValueError, match="no rmsnorm"):
        ops.rmsnorm(x, None)


# chip_smoke phase 5's widths and row counts, ragged row counts, and
# narrow rows of the CPU tests above
NORM_WIDTHS = (2048, 2560, 3584, 4096, 5120)
NORM_ROWS = (1, 4, 512, 2048, 3, 4097)


@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("R,D", [(R, D) for D in NORM_WIDTHS for R in NORM_ROWS]
                         + [(1, 64), (7, 96), (300, 128), (4097, 8192)])
def test_norm_plan_covers_each_row_and_chunk_once(R, D, itemsize, n_sm):
    """The kernel's plan, as the kernel walks it: every row of R by exactly
    one warp group, every 16-byte chunk of a row by exactly one lane of
    the group; blocks within the kernel's thread limit at the plan's
    chunks a lane, and at most 15 groups (named barriers) when a row has
    several warps."""
    plan = ops.norm_plan(R, D, itemsize, n_sm)
    threads = 32 * plan.warps_per_row * plan.rows_per_block
    assert threads <= 1024 and threads <= ops.max_threads(plan.chunks)
    assert 1 <= plan.chunks <= ops.MAX_CHUNKS and plan.grid >= 1
    assert plan.warps_per_row == 1 or plan.rows_per_block <= 15
    rows = [r for b in range(plan.grid) for g in range(plan.rows_per_block)
            for r in ops.rows_of(plan, R, b, g)]
    assert sorted(rows) == list(range(R))
    nvec = D * itemsize // 16
    chunks = [c for lane in range(32 * plan.warps_per_row)
              for c in ops.chunks_of(plan, nvec, lane)]
    assert sorted(chunks) == list(range(nvec))
    if R < n_sm:      # a decode row: one block each, a lane for every chunk
        assert plan.grid == R and plan.rows_per_block == 1
        assert plan.chunks == (1 if nvec <= 1024 else 2)


def test_norm_plan_refuses_rows_it_cannot_hold():
    with pytest.raises(ValueError, match="do not fit"):
        ops.norm_plan(1, 16384, 4, 132)         # 4096 chunks: past 32 warps of 2
    with pytest.raises(ValueError, match="do not fit"):
        ops.norm_plan(2048, 5120, 2, 132, warps_per_row=1)   # 20 chunks a lane


# kernel 5's backward: chip_smoke phase 5b's row counts and ragged ones,
# and every width from 64 to the widest row the kernel holds
BWD_ROWS = (1, 7, 2048, 4096, 4097)
BWD_WIDTHS = [(D, 2) for D in (64, 128, 1536, 2048, 2560, 3584, 4096, 5120, 8192, 16384)] + \
    [(D, 4) for D in (64, 128, 1536, 2048, 2560, 3584, 4096, 5120, 8192)]


@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("D,itemsize", BWD_WIDTHS)
@pytest.mark.parametrize("R", BWD_ROWS)
def test_bwd_plan_covers_each_row_and_chunk_once(R, D, itemsize, n_sm):
    """The backward kernel's plan, as the kernel walks it: every row of R
    by exactly one warp group, every 16-byte chunk of a row by exactly
    one lane of the group; blocks, warps, chunks, clusters and shared
    memory within the kernel's limits; and the dw reduction's order adds
    every (block, group) part into every column exactly once."""
    plan = ops.bwd_plan(R, D, itemsize, n_sm)
    threads = 32 * plan.warps * plan.groups
    assert threads <= ops.BWD_THREADS and 1 <= plan.warps <= ops.BWD_MAX_WARPS
    assert 1 <= plan.chunks <= ops.BWD_MAX_CHUNKS and plan.groups >= 1
    assert plan.warps == 1 or plan.groups <= 15          # named barriers 1..15
    assert 1 <= plan.cluster <= ops.BWD_MAX_CLUSTER and plan.grid % plan.cluster == 0
    per_sm = ops.bwd_blocks_per_sm(plan.chunks)
    assert plan.grid <= max(plan.cluster, n_sm * per_sm)  # one wave: a persistent grid
    nvec = D * itemsize // 16
    # the parts of a slice of dw the cluster's groups push to a block: within
    # what the kernel asks for (bwd_max_smem) and what a block may have
    most = (ops.BWD_THREADS * plan.chunks * (16 // itemsize)
            + 4 * ops.BWD_MAX_CLUSTER * ops.BWD_THREADS // 32) * 4
    assert ops.bwd_smem(plan, D) <= min(most, 227 * 1024)
    rows = [r for b in range(plan.grid) for g in range(plan.groups)
            for r in ops.bwd_rows_of(plan, R, b, g)]
    assert sorted(rows) == list(range(R))
    chunks = [c for lane in range(32 * plan.warps) for c in ops.bwd_chunks_of(plan, nvec, lane)]
    assert sorted(chunks) == list(range(nvec))
    parts = sorted((b, g) for b in range(plan.grid) for g in range(plan.groups))
    columns = []
    for cols, terms in ops.dw_sums(plan, D):
        columns += list(cols)
        assert sorted(terms) == parts
    assert sorted(columns) == list(range(D // 4))


def test_bwd_plan_refuses_rows_it_cannot_hold():
    with pytest.raises(ValueError, match="do not fit"):
        ops.bwd_plan(1, 16384, 4, 132)          # 4096 chunks: past 8 warps of 8
    with pytest.raises(ValueError, match="do not fit"):
        ops.bwd_plan(2048, 32768, 2, 132)
    with pytest.raises(ValueError, match="clusters of 1 to"):
        ops.bwd_plan(2048, 2048, 2, 132, cluster=16)   # past the tickets


def test_bwd_plan_keeps_to_the_clusters_the_card_holds():
    """A card whose GPCs hold fewer clusters than n_sm * blocks / cluster
    gets no more clusters than it holds; a short input no more than its
    rows need."""
    full = ops.bwd_plan(2048, 2048, 2, 132)
    held = ops.bwd_plan(2048, 2048, 2, 132, max_clusters=30)
    assert held.grid == 30 * held.cluster < full.grid
    assert held._replace(grid=full.grid) == full
    assert ops.bwd_plan(3, 2048, 2, 132, max_clusters=30).grid == full.cluster
