"""The SSD decode-step kernel's plain version (what the port runs for a
CPU tensor) against the JAX package's ``ssd_update`` (the Pallas kernel
in interpret mode on the CPU, as ``tests/test_ssd_kernel.py`` runs it),
on the same numpy inputs.

Tolerances are the reference's own (``test_ssd_kernel.py``): 1e-4 on
h' and 1e-3 on y, which sums N products in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_update.ops import ssd_update as jax_ssd_update
from repro_torch.kernels.ssd_update import ops
from repro_torch.kernels.ssd_update.ref import ssd_update_ref

TOL_H = dict(rtol=1e-4, atol=1e-4)
TOL_Y = dict(rtol=1e-3, atol=1e-3)


def _inputs(B, H, P, N, G, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(h=rng.standard_normal((B, H, P, N)).astype(f32),
                x=rng.standard_normal((B, H, P)).astype(f32),
                dt=np.log1p(np.exp(rng.standard_normal((B, H)))).astype(f32),
                A=-np.exp(rng.standard_normal(H)).astype(f32),
                Bm=rng.standard_normal((B, G, N)).astype(f32),
                Cm=rng.standard_normal((B, G, N)).astype(f32))


def _jax(a, xdtype):
    cast = {k: jnp.asarray(v) for k, v in a.items()}
    for k in ("x", "Bm", "Cm"):
        cast[k] = cast[k].astype(xdtype)
    h, y = jax_ssd_update(cast["h"], cast["x"], cast["dt"], cast["A"],
                          cast["Bm"], cast["Cm"])
    return np.asarray(h), np.asarray(y)


def _torch(a, xdtype):
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    for k in ("x", "Bm", "Cm"):
        t[k] = t[k].to(xdtype)
    return t


@pytest.mark.parametrize("B,H,P,N,G", [
    (1, 80, 64, 128, 1),     # mamba2-2.7b decode shape
    (2, 64, 64, 64, 1),      # zamba2-1.2b decode shape
    (3, 8, 16, 32, 2),       # grouped B/C
    (1, 4, 8, 16, 4),
])
@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
def test_plain_matches_jax_kernel(B, H, P, N, G, xdtype):
    a = _inputs(B, H, P, N, G, seed=B * H + P)
    if xdtype == "bfloat16":   # both sides see the same bf16 values
        for k in ("x", "Bm", "Cm"):
            a[k] = a[k].astype(jnp.bfloat16).astype(np.float32)
    h_ref, y_ref = _jax(a, getattr(jnp, xdtype))
    t = _torch(a, getattr(torch, xdtype))
    h_new, y = ops.ssd_update(t["h"], t["x"], t["dt"], t["A"], t["Bm"], t["Cm"])
    assert h_new.dtype == torch.float32 and y.dtype == torch.float32
    np.testing.assert_allclose(h_new.numpy(), h_ref, **TOL_H)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL_Y)


def test_out_writes_the_state_in_place():
    a = _inputs(2, 8, 16, 32, 2, seed=7)
    t = _torch(a, torch.float32)
    want_h, want_y = ssd_update_ref(t["h"].clone(), t["x"], t["dt"], t["A"],
                                    t["Bm"], t["Cm"])
    h = t["h"]
    h_new, y = ops.ssd_update(h, t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], out=h)
    assert h_new is h
    assert torch.equal(h, want_h) and torch.equal(y, want_y)


def test_state_decays_to_input_term():
    """dt*A -> -inf (full decay): h' == xdt (outer) B exactly."""
    B, H, P, N = 1, 2, 4, 8
    h = torch.full((B, H, P, N), 100.0)
    h_new, y = ops.ssd_update(h, torch.ones((B, H, P)), torch.full((B, H), 50.0),
                              torch.full((H,), -10.0), torch.full((B, 1, N), 2.0),
                              torch.ones((B, 1, N)))
    assert torch.equal(h_new, torch.full_like(h, 100.0))
    assert torch.equal(y, torch.full((B, H, P), 100.0 * N))


def test_wrapper_rejects_other_devices():
    """A device other than the CPU, CUDA and meta (the dry run's shapes)
    raises: xpu tensors stand in, as fake tensors (no xpu here)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    mode = FakeTensorMode()

    def xpu(*shape):
        return FakeTensor(mode, torch.empty(shape, device="meta"), torch.device("xpu"))
    with mode, pytest.raises(ValueError, match="no ssd_update"):
        ops.ssd_update(xpu(1, 2, 4, 8), xpu(1, 2, 4), xpu(1, 2), xpu(2),
                       xpu(1, 1, 8), xpu(1, 1, 8))


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("rows_per_thread", [None, 1, 2, 4])
@pytest.mark.parametrize("B,H,P,N,G", [
    (1, 80, 64, 128, 1),     # mamba2-2.7b decode shape
    (1, 64, 64, 64, 1),      # zamba2-1.2b decode shape
    (3, 8, 16, 32, 2),
    (2, 6, 5, 24, 3),        # P below one block's rows, N / 4 not a power of 2
    (1, 8, 37, 16, 1),       # N 16: four lanes a row
    (1, 8, 64, 20, 2),       # N 20: two chunks on one lane of four
    (2, 4, 100, 256, 2),     # N 256: two chunks a lane; ragged P
])
def test_ssd_plan_covers_each_state_chunk_once(B, H, P, N, G, rows_per_thread, warps):
    """The kernel's plan, as the kernel indexes it: within a (b, head)
    tile every row of P and every 16-byte chunk of a row by exactly one
    thread; blocks of at most 256 threads."""
    plan = ops.ssd_plan(B, H, P, N, 132, rows_per_thread=rows_per_thread, warps=warps)
    assert plan.lanes * plan.chunks * 4 >= N and plan.chunks in (1, 2)
    assert plan.rows_per_thread in (1, 2, 4) and 32 * plan.warps <= 256
    cover = [(p, c) for blk in range(plan.grid) for t in range(32 * plan.warps)
             for p in ops.ssd_rows(plan, blk, t) if p < P
             for c in ops.ssd_columns(plan, N, t)]
    assert sorted(cover) == [(p, c) for p in range(P) for c in range(0, N, 4)]


def test_ssd_plan_fills_the_card_at_the_model_shapes():
    """A thread takes the most rows that still leave MIN_BLOCKS_PER_SM
    blocks an SM."""
    for B, H, P, N in ((1, 80, 64, 128), (1, 64, 64, 64)):
        plan = ops.ssd_plan(B, H, P, N, 132)
        assert B * H * plan.grid >= ops.MIN_BLOCKS_PER_SM * 132 or plan.rows_per_thread == 1
        if plan.rows_per_thread < 4:
            wider = ops.ssd_plan(B, H, P, N, 132, rows_per_thread=2 * plan.rows_per_thread)
            assert B * H * wider.grid < ops.MIN_BLOCKS_PER_SM * 132
