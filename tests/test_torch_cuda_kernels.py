"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc; every test skips without one.  This file
imports neither jax nor the JAX package, so it runs on a machine without
them (``--noconftest`` skips the suite's jax-importing conftest):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py

Tolerances, relative to max(1, |plain|): f32 1e-4 (sums in another
order), bf16 2e-2 (the output is rounded to bf16, spacing 2^-8).  The
RMSNorm kernel's bf16 output must be within one bf16 spacing of the
plain version's, element by element."""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.dequantize import ops as dq_ops
from repro_torch.kernels.dequantize.ref import dequantize_ref
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.int4_matmul import ops as i4_ops
from repro_torch.kernels.int4_matmul.ref import int4_matmul_ref
from repro_torch.kernels.paged_decode_attention import ops as pda_ops
from repro_torch.kernels.paged_decode_attention import ref as pda_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_update import ops as ssd_ops
from repro_torch.kernels.ssd_update.ref import ssd_update_ref

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _close(out, ref, dtype):
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,hd,S", [
    (1, 28, 4, 128, 512), (2, 8, 2, 64, 256), (3, 16, 4, 64, 384),
    (2, 4, 4, 128, 128), (1, 2, 1, 32, 96), (1, 28, 4, 128, 2047),
    (1, 16, 16, 128, 2081), (1, 12, 2, 128, 2081)])   # qwen2-moe, qwen2-vl (G=6)
def test_decode_attention(cuda, dtype, B, Hq, Hkv, hd, S):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((B, Hq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=g, device=cuda).to(dtype)
    mask = torch.rand((B, S), generator=g, device=cuda) < 0.7
    mask[0] = False
    before = da_ops.launches
    out = da_ops.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    _close(out, decode_attention_ref(q, k, v, mask), dtype)
    assert torch.all(out[0] == 0)


def _mma_case(dev, B, G, Hkv, hd, S, seed):
    """bf16 q, k, v and a (B, S) mask: sparse random slots, a run of 600
    masked slots (whole tiles and splits with no valid slot), the last
    row fully masked when B > 1, and the first slot valid in row 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, G * Hkv, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, hd), generator=g, device=dev).bfloat16()
    mask = torch.rand((B, S), generator=g, device=dev) < 0.5
    mask[:, S // 4:S // 4 + 600] = False
    mask[0, 0] = True
    if B > 1:
        mask[-1] = False
    return q, k, v, mask


@pytest.mark.parametrize("G", [1, 4, 6, 7, 8, 16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_decode_attention_mma(cuda, hd, G):
    """Kernel 1's mma path (bf16): one launch per call, within bf16's
    tolerance of the plain version, two calls bit-equal, and NaN written
    into every masked slot's K/V row leaves the output bit-equal (a
    masked row is never read); a fully masked row gives zeros."""
    B, Hkv, S = 2, max(1, 8 // G), 2081
    q, k, v, mask = _mma_case(cuda, B, G, Hkv, hd, S, seed=hd * 17 + G)
    assert da_ops.path_for(q, k) == "mma"
    before = da_ops.launches
    out = da_ops.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    _close(out, decode_attention_ref(q, k, v, mask), torch.bfloat16)
    assert torch.all(out[-1] == 0)
    assert torch.equal(da_ops.decode_attention(q, k, v, mask), out)
    dead = ~mask
    k[dead], v[dead] = float("nan"), float("nan")
    poisoned = da_ops.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, out)


def test_decode_attention_mma_one_split_and_long_range(cuda):
    """B * Hkv >= the SM count gives one split per (b, KV head): each block
    writes its output directly (no partials, no ticket) and walks all S =
    9000 slots as three 4096-slot windows of mask bits; NaN in the masked
    rows still leaves the output bit-equal."""
    B, G, Hkv, hd, S = 3, 2, 48, 32, 9000
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert da_ops.mma_split_plan(B, Hkv, S, sms) == 1
    q, k, v, mask = _mma_case(cuda, B, G, Hkv, hd, S, seed=1)
    mask[0, 4000:8500] = False           # the second window of row 0 has no valid slot
    out = da_ops.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    _close(out, decode_attention_ref(q, k, v, mask), torch.bfloat16)
    assert torch.all(out[-1] == 0)
    dead = ~mask
    k[dead], v[dead] = float("nan"), float("nan")
    assert torch.equal(da_ops.decode_attention(q, k, v, mask), out)


@pytest.mark.parametrize("hd,G,Hkv,S", [(128, 7, 4, 2081), (64, 1, 32, 2081),
                                       (128, 1, 16, 2081), (128, 6, 2, 2081)])
def test_decode_attention_mma_is_one_launch(cuda, hd, G, Hkv, S):
    """At the main-path shapes (qwen2.5-7b; zamba2-1.2b's shared block and
    musicgen-large; qwen2-moe-a2.7b; qwen2-vl-2b, G=6) with the prefix
    mask of a decode step, the profiler sees one kernel per call,
    `decode_attention_mma`, and no merge kernel."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, _ = _mma_case(cuda, 1, G, Hkv, hd, S, seed=S)
    mask = torch.arange(S, device=cuda) <= 2048
    da_ops.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            da_ops.decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")}
    assert len(kernels) == 1
    (name, count), = kernels.items()
    assert "decode_attention_mma" in name and count == 3
    _close(da_ops.decode_attention(q, k, v, mask), decode_attention_ref(q, k, v, mask),
           torch.bfloat16)


def test_decode_attention_mma_graph_replay(cuda):
    """Kernel 1's first mma call allocates its tickets, so under CUDA-graph
    capture it raises; after an eager call a captured call replays with
    q and the mask changed in place, each replay bit-equal to an eager
    call, and the tickets are back at 0 after each."""
    B, G, Hkv, hd, S = 1, 7, 4, 128, 2081
    q, k, v, mask = _mma_case(cuda, B, G, Hkv, hd, S, seed=5)
    saved = da_ops._tickets.pop(cuda.index if cuda.index is not None
                                else torch.cuda.current_device(), None)
    try:
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="before CUDA-graph capture"):
            with torch.cuda.graph(graph):
                da_ops.decode_attention(q, k, v, mask)
    finally:
        if saved is not None:
            da_ops._tickets[saved.device.index] = saved
    da_ops.decode_attention(q, k, v, mask)   # allocates the tickets
    tickets = da_ops._tickets[q.device.index]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.decode_attention(q, k, v, mask)
    g = torch.Generator(device=cuda).manual_seed(9)
    for pos in (0, 700, 2080):
        q.copy_(torch.randn(q.shape, generator=g, device=cuda).bfloat16())
        mask.copy_(torch.arange(S, device=cuda)[None] <= pos)
        graph.replay()
        torch.cuda.synchronize()
        assert int(tickets.abs().sum()) == 0
        assert torch.equal(out, da_ops.decode_attention(q, k, v, mask))
        _close(out, decode_attention_ref(q, k, v, mask), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,group", [
    (1, 128, 128, 128), (4, 256, 384, 128), (16, 64, 96, 64),
    (130, 512, 300, 128), (8, 128, 128, 32), (1, 3584, 512, 128)])
def test_int4_matmul(cuda, dtype, M, K, N, group):
    g = torch.Generator(device=cuda).manual_seed(K + N)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    packed = torch.randint(0, 256, (K // 2, N), generator=g, device=cuda,
                           dtype=torch.uint8)
    scales = 0.01 + 0.01 * torch.rand((K // group, N), generator=g, device=cuda)
    if M <= i4_ops.GEMV_MAX_M and (N % i4_ops.GEMV_N or group % i4_ops.GEMV_GROUP):
        with pytest.raises(ValueError):
            i4_ops.int4_matmul(x, packed, scales, group=group)
        return
    out = i4_ops.int4_matmul(x, packed, scales, group=group)
    torch.cuda.synchronize()
    _close(out, int4_matmul_ref(x, packed, scales, group), dtype)



def _wgmma_case(dev, M, K, N, group, seed, pow2_scales=False,
                dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    packed = torch.randint(0, 256, (K // 2, N), generator=g, device=dev,
                           dtype=torch.uint8)
    if pow2_scales:   # differ per (group, column) by up to 2^8
        e = torch.randint(-4, 5, (K // group, N), generator=g, device=dev)
        scales = 0.01 * torch.pow(2.0, e.float())
    else:
        scales = 0.005 + 0.01 * torch.rand((K // group, N), generator=g, device=dev)
    return x, packed, scales


def _wgmma_check(dev, M, K, N, group, seed, pow2_scales=False):
    x, packed, scales = _wgmma_case(dev, M, K, N, group, seed, pow2_scales)
    assert i4_ops.path_for(M, x.dtype) == "wgmma"
    before = i4_ops.launches
    out = i4_ops.int4_matmul(x, packed, scales, group=group)
    torch.cuda.synchronize()
    assert i4_ops.launches == before + 1
    _close(out, int4_matmul_ref(x, packed, scales, group), torch.bfloat16)


@pytest.mark.parametrize("K", [16, 32, 64, 256])
def test_int4_wgmma_single_tile(cuda, K):
    """One 64x128 output tile (one warpgroup's rows, the other's padded),
    group 16: every k16 step starts and ends a scale group.  Checks the
    shared-memory descriptors and the fragment-to-column map first."""
    _wgmma_check(cuda, 64, K, 128, 16, K, pow2_scales=True)


@pytest.mark.parametrize("M", [64, 512, 2048])
@pytest.mark.parametrize("name,K,N", [
    ("wq", 3584, 3584), ("wk", 3584, 512), ("down", 18944, 3584)])
def test_int4_wgmma_qwen_shapes(cuda, M, name, K, N):
    _wgmma_check(cuda, M, K, N, 128, M + N)


@pytest.mark.parametrize("M,K,N,group", [
    (512, 3584, 512, 128), (200, 1024, 300, 32), (130, 192, 96, 48)])
def test_int4_wgmma_per_column_scales(cuda, M, K, N, group):
    """Scales that differ per (group, column) by powers of two: a wrong
    fragment-to-column or group map is off by up to 2^8."""
    _wgmma_check(cuda, M, K, N, group, K + N, pow2_scales=True)

GEMV_LAYER = [("wq", 3584, 3584), ("wk", 3584, 512), ("wv", 3584, 512),
              ("wo", 3584, 3584), ("gate", 3584, 18944), ("up", 3584, 18944),
              ("down", 18944, 3584)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("name,K,N", GEMV_LAYER)
def test_int4_gemv_qwen_shapes(cuda, dtype, M, name, K, N):
    """The GEMV at the qwen2.5-7b layer shapes: one launch per call, two
    calls bit-equal (the K slices are added in a fixed order)."""
    x, packed, scales = _wgmma_case(cuda, M, K, N, 128, M + N, dtype=dtype)
    assert i4_ops.path_for(M, dtype) == "gemv"
    before = i4_ops.launches
    out = i4_ops.int4_matmul(x, packed, scales, group=128)
    again = i4_ops.int4_matmul(x, packed, scales, group=128)
    torch.cuda.synchronize()
    assert i4_ops.launches == before + 2
    assert torch.equal(out, again)
    _close(out, int4_matmul_ref(x, packed, scales, 128), dtype)


@pytest.mark.parametrize("M,K,N,group", [
    (1, 3584, 512, 128), (4, 1024, 304, 32), (2, 512, 96, 16),
    (3, 3584, 18944, 128), (4, 18944, 3584, 128)])
def test_int4_gemv_per_column_scales(cuda, M, K, N, group):
    """Scales that differ per (group, column) by powers of two: a wrong
    fragment-to-column or group map is off by up to 2^8."""
    x, packed, scales = _wgmma_case(cuda, M, K, N, group, K + N, pow2_scales=True)
    out = i4_ops.int4_matmul(x, packed, scales, group=group)
    torch.cuda.synchronize()
    _close(out, int4_matmul_ref(x, packed, scales, group), torch.bfloat16)


@pytest.mark.parametrize("M", [1, 4])
def test_int4_gemv_graph_replay(cuda, M):
    """One GEMV captured as a CUDA graph and replayed with new x three
    times: each replay equals an eager call bit for bit, and the tickets
    are back at 0 after each (K split 28 ways, so every replay uses them)."""
    K, N = 3584, 512
    x, packed, scales = _wgmma_case(cuda, M, K, N, 128, 7)
    assert i4_ops.split_plan(K, N, torch.cuda.get_device_properties(cuda).multi_processor_count,
                             M) > 1
    i4_ops.int4_matmul(x, packed, scales, group=128)    # allocates the tickets
    tickets = i4_ops._tickets[x.device.index]
    static_x = x.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = i4_ops.int4_matmul(static_x, packed, scales, group=128)
    g = torch.Generator(device=cuda).manual_seed(11)
    for _ in range(3):
        new_x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
        static_x.copy_(new_x)
        graph.replay()
        torch.cuda.synchronize()
        assert int(tickets.abs().sum()) == 0
        assert torch.equal(out, i4_ops.int4_matmul(new_x, packed, scales, group=128))


@pytest.mark.parametrize("M", [1, 4, 64, 512])
@pytest.mark.parametrize("K,N", [(3584, 512), (18944, 3584)])
def test_int4_group256(cuda, M, K, N):
    """Group 256: one scale group spans two of the wgmma path's 128-deep
    k-tiles and eight of the GEMV's warp chunks; per-(group, column)
    power-of-two scales against the plain version."""
    x, packed, scales = _wgmma_case(cuda, M, K, N, 256, M + K, pow2_scales=True)
    assert i4_ops.path_for(M, x.dtype) == ("gemv" if M <= 4 else "wgmma")
    out = i4_ops.int4_matmul(x, packed, scales, group=256)
    torch.cuda.synchronize()
    _close(out, int4_matmul_ref(x, packed, scales, 256), torch.bfloat16)


def _paged_case(dev, dtype, quant, B, Hq, Hkv, hd, page, max_blocks, lengths):
    """Pools with a shuffled block table; blocks past each length point
    at page 0, the garbage sentinel."""
    g = torch.Generator(device=dev).manual_seed(page * 131 + hd)
    n_pages = 1 + B * max_blocks
    q = torch.randn((B, Hq, hd), generator=g, device=dev).to(dtype)
    shape = (n_pages, page, Hkv, hd)
    if quant:
        k = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        ks = 0.02 * torch.rand(shape[:3], generator=g, device=dev)
        vs = 0.02 * torch.rand(shape[:3], generator=g, device=dev)
        ks[1] = 0.0                     # an all-zero row of scales
    else:
        k = torch.randn(shape, generator=g, device=dev).to(dtype)
        v = torch.randn(shape, generator=g, device=dev).to(dtype)
        ks = vs = None
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = (torch.arange(max_blocks, device=dev)[None] * page) < lens[:, None]
    bt = torch.where(live, bt, 0).to(torch.int32).contiguous()
    return q, k, v, ks, vs, bt, lens


def _paged_plain(q, k, v, ks, vs, bt, lens):
    if ks is None:
        return pda_ref.paged_decode_attention_ref(q, k, v, bt, lens)
    return pda_ref.paged_decode_attention_quant_ref(q, k, v, ks, vs, bt, lens)


PAGED_LENGTHS = (2100, 2081, 2117, 2064)   # the paged serving shape's slots


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,page,max_blocks,lengths", [
    (28, 4, 128, 16, 9, (140, 1, 0, 77)), (8, 2, 64, 4, 6, (24, 5, 13)),
    (16, 2, 32, 8, 5, (40, 39, 0)), (4, 4, 128, 32, 3, (96, 33)),
    (28, 4, 128, 16, 136, PAGED_LENGTHS),            # the serving shape
    (4, 4, 64, 8, 20, (150, 0, 77)),                 # G = 1
    (32, 2, 128, 16, 12, (190, 17)),                 # G = 16
    (28, 4, 128, 16, 136, (1, 63, 64, 65)),          # tile edges
    # 16 splits a pair: 2048 tokens are 8 units a split, 127-129 are 8-9
    # units over 16 splits (most hold none)
    (28, 4, 128, 16, 136, (127, 128, 129, 2048)),
    (28, 4, 128, 16, 136, (2047, 2049, 2175, 2176))])
def test_paged_decode_attention(cuda, dtype, quant, Hq, Hkv, hd, page,
                                max_blocks, lengths):
    """Kernel 2 against its plain version, on the path ``path_for``
    names (mma for bf16 q, cuda_core for f32); two calls are bit-equal;
    the garbage page 0, poisoned, must leave every output bit-equal (it
    is never read), and a length-0 lane gives zeros."""
    B = len(lengths)
    q, k, v, ks, vs, bt, lens = _paged_case(cuda, dtype, quant, B, Hq, Hkv, hd,
                                            page, max_blocks, lengths)
    assert pda_ops.path_for(q, k) == ("mma" if dtype == torch.bfloat16
                                      else "cuda_core")
    before = pda_ops.launches
    out = pda_ops.paged_decode_attention(q, k, v, bt, lens, ks, vs)
    torch.cuda.synchronize()
    assert pda_ops.launches == before + 1
    _close(out, _paged_plain(q, k, v, ks, vs, bt, lens), dtype)
    assert torch.equal(pda_ops.paged_decode_attention(q, k, v, bt, lens, ks, vs),
                       out)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.all(out[i] == 0)
    k[0] = 100 if quant else 1e9
    v[0] = -100 if quant else -1e9
    if quant:
        ks[0], vs[0] = 1e9, 1e9
    again = pda_ops.paged_decode_attention(q, k, v, bt, lens, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_attention_graph_replay(cuda, quant):
    """One mma-path call at the serving shape captured as a CUDA graph
    and replayed three times, with lengths and the block table changed in
    place between replays: each replay equals an eager call bit for bit
    and agrees with the plain version, and the tickets are back at 0
    after each."""
    B, Hq, Hkv, hd, page, max_blocks = 4, 28, 4, 128, 16, 136
    q, k, v, ks, vs, bt, lens = _paged_case(cuda, torch.bfloat16, quant, B, Hq,
                                            Hkv, hd, page, max_blocks,
                                            PAGED_LENGTHS)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pda_ops.mma_split_plan(B, Hkv, max_blocks * page, sms, quant) > 1
    pda_ops.paged_decode_attention(q, k, v, bt, lens, ks, vs)   # allocates the tickets
    tickets = pda_ops._tickets[q.device.index]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pda_ops.paged_decode_attention(q, k, v, bt, lens, ks, vs)
    g = torch.Generator(device=cuda).manual_seed(3)
    for lengths in ((1, 0, 2176, 65), (2100, 17, 0, 1000), (2176, 2176, 2176, 2176)):
        new_lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        perm = torch.randperm(B * max_blocks, generator=g, device=cuda) + 1
        live = torch.arange(max_blocks, device=cuda)[None] * page < new_lens[:, None]
        lens.copy_(new_lens)
        bt.copy_(torch.where(live, perm.reshape(B, max_blocks), 0))
        graph.replay()
        torch.cuda.synchronize()
        assert int(tickets.abs().sum()) == 0
        assert torch.equal(out, pda_ops.paged_decode_attention(q, k, v, bt, lens,
                                                               ks, vs))
        _close(out, _paged_plain(q, k, v, ks, vs, bt, lens), torch.bfloat16)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 96), device=cuda)
    k = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="hd"):
        da_ops.decode_attention(q, k, k, torch.ones(8, dtype=torch.bool, device=cuda))
    q = torch.zeros((1, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        da_ops.decode_attention(q, k, k, torch.ones(8, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="aligned"):
        rms_ops.rmsnorm(torch.ones((5, 98), device=cuda), None)
    with pytest.raises(ValueError, match="aligned"):
        rms_ops.rmsnorm(torch.ones((2, 3, 65), device=cuda)[:, :, 1:], None)
    h = torch.zeros((1, 2, 4, 8), device=cuda)
    x, d = torch.zeros((1, 2, 4), device=cuda), torch.zeros((1, 2), device=cuda)
    bc = torch.zeros((1, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="N=8"):
        ssd_ops.ssd_update(h, x, d, torch.zeros(2, device=cuda), bc, bc)


@pytest.mark.parametrize("quant", ["bf16", "int4_fused"])
def test_decode_step_replays_as_a_cuda_graph(cuda, quant):
    """The step keeps its state at fixed addresses and reads nothing back
    to the host, so it captures as one CUDA graph, kernels included, and
    each replay equals an eager step."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    cfg = get_config("qwen2.5-3b").reduced().replace(dtype="float32")
    model = Model(cfg, decode_backend="cuda", device=cuda)
    eng = DecodeEngine(model, model.init(torch.Generator(device=cuda).manual_seed(0)),
                       quant_path=quant)
    prompt = {"tokens": torch.arange(12, device=cuda)[None] * 7 % cfg.vocab_size}
    feed = (5, 9, 3, 200)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        _, eager_cache = eng.prefill(prompt, 32)
        want = []
        for t in feed:
            tok.fill_(t)
            want.append(model.decode_step(eng.params, eager_cache, tok)[0].clone())
        _, warm = eng.prefill(prompt, 32)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode_step(eng.params, warm, tok)
        torch.cuda.current_stream().wait_stream(side)
        _, cache = eng.prefill(prompt, 32)
        graph = torch.cuda.CUDAGraph()
        before = (da_ops.launches, i4_ops.launches)
        with torch.cuda.graph(graph):
            logits, _ = model.decode_step(eng.params, cache, tok)
        for t, w in zip(feed, want):
            tok.fill_(t)
            graph.replay()
            torch.cuda.synchronize()
            torch.testing.assert_close(logits, w, rtol=1e-5, atol=1e-5)
    assert int(cache["pos"]) == 12 + len(feed)
    assert da_ops.launches == before[0] + cfg.n_layers


@pytest.mark.parametrize("kv_quant,K", [("none", 1), ("int8", 4)])
def test_paged_scheduler_graph_replays_equal_plain_calls(cuda, kv_quant, K):
    """The paged scheduler's decode step, captured once as a CUDA graph
    and replayed through admission, preemption and backfill, gives the
    same event log as the same scheduler making plain calls; the graph
    is captured once, and the kernel wrapper runs only at warm-up and
    capture (replays do not pass through Python); the replays launch the
    kernel as often as the plain calls do."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import SessionRequest, SlotScheduler, programs
    cfg = get_config("qwen2.5-3b").reduced().replace(dtype="float32")
    model = Model(cfg, decode_backend="cuda", device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    reqs = [SessionRequest(f"s{i}", (torch.arange(6 + 3 * i) * (i + 5)
                                     % cfg.vocab_size).numpy(), 6 + i % 3)
            for i in range(5)]
    runs = []
    for capture in (True, False):
        sched = SlotScheduler(model, params, n_slots=2, max_len=40, paged=True,
                              page_size=8, n_pages=1 + 5, steps_per_tick=K,
                              kv_dtype=torch.int8 if kv_quant == "int8" else None)
        sched._progs.capture = capture
        for r in reqs:
            sched.submit(r)
        before = pda_ops.launches
        replayed = programs.replay_launches.get("paged_decode_attention", 0)
        res = sched.run()
        replayed = programs.replay_launches.get("paged_decode_attention",
                                                0) - replayed
        runs.append((res, pda_ops.launches - before, replayed))
    (graph, graph_launches, replayed), (plain, plain_launches, _) = runs
    assert graph.events == plain.events
    assert graph.preemptions >= 1 and graph.step_cache_size == 1
    assert graph_launches == 2 * K * cfg.n_layers
    assert plain_launches == K * cfg.n_layers * plain.decode_steps
    assert replayed == plain_launches


@pytest.mark.parametrize("adaptive", [False, True])
def test_paged_scheduler_stochastic_graph_replays_equal_plain_calls(cuda, adaptive):
    """int8 KV, K=4, temperature 0.8, top_k 5 on an oversubscribed pool:
    the captured horizon graphs draw from the scheduler's generator
    (registered at capture; the warm-up draws from its own) what the
    same scheduler's plain calls draw, so the event logs are equal
    through admission, preemption and backfill, and the generator ends
    where the plain run's does; with ``adaptive_k`` one graph per K of
    the ladder, all on that one generator.  Another seed, other draws."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import SessionRequest, SlotScheduler
    cfg = get_config("qwen2.5-3b").reduced().replace(dtype="float32")
    model = Model(cfg, decode_backend="cuda", device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    reqs = [SessionRequest(f"s{i}", (torch.arange(6 + 3 * i) * (i + 5)
                                     % cfg.vocab_size).numpy(), 6 + i % 3)
            for i in range(5)]
    runs = []
    for capture, seed in ((True, 11), (False, 11), (True, 12)):
        sched = SlotScheduler(model, params, n_slots=2, max_len=40, paged=True,
                              page_size=8, n_pages=1 + 5, steps_per_tick=4,
                              adaptive_k=adaptive, kv_dtype=torch.int8,
                              temperature=0.8, top_k=5, seed=seed)
        sched._progs.capture = capture
        for r in reqs:
            sched.submit(r)
        runs.append((sched.run(), sched.gen.get_state()))
    (graph, g_state), (plain, p_state), (other, _) = runs
    assert graph.events == plain.events and torch.equal(g_state, p_state)
    assert graph.events != other.events
    assert graph.preemptions >= 1
    assert graph.step_cache_size == (len(graph.horizon_hist) if adaptive else 1)
    if adaptive:
        assert len(graph.horizon_hist) > 1
    assert {sid: len(s.tokens) for sid, s in graph.sessions.items()} == \
        {r.session_id: r.max_new_tokens for r in reqs}


def _moe_requests(cfg):
    """Five sessions through three slots, slot 0's short: it frees while
    slots 1 and 2 decode, so free lanes (token 0) route through the
    experts and take capacity beside live ones."""
    spec = [(40, 2), (70, 9), (55, 11), (33, 3), (47, 2)]
    g = torch.Generator().manual_seed(7)
    return [(f"s{i}", torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy(), new)
            for i, (n, new) in enumerate(spec)]


@pytest.mark.parametrize("paged,K", [(False, 1), (True, 1), (True, 4)])
def test_moe_scheduler_graph_replays_equal_plain_calls(cuda, paged, K):
    """A 2-layer qwen2-moe-a2.7b at full width (60 experts, bf16): the
    scheduler's decode step captured once as a CUDA graph and replayed
    gives the same event log and streams as the same scheduler making
    plain calls, free lanes present; the MoE dispatch reads nothing back
    to the host, so it captures; kernel 1 (contiguous) or 2 (paged)
    runs once per layer and device step in the replays."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import SessionRequest, SlotScheduler, programs
    cfg = get_config("qwen2-moe-a2.7b").replace(n_layers=2)
    model = Model(cfg, decode_backend="cuda", device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    reqs = [SessionRequest(*r) for r in _moe_requests(cfg)]
    kernel = "paged_decode_attention" if paged else "decode_attention"
    runs = []
    for capture in (True, False):
        sched = SlotScheduler(model, params, n_slots=3, max_len=96, paged=paged,
                              page_size=16, steps_per_tick=K)
        sched._progs.capture = capture
        for r in reqs:
            sched.submit(r)
        replayed = programs.replay_launches.get(kernel, 0)
        res = sched.run()
        runs.append((res, programs.replay_launches.get(kernel, 0) - replayed))
    (graph, replayed), (plain, _) = runs
    assert graph.events == plain.events
    for r in reqs:
        assert torch.equal(torch.as_tensor(graph.tokens_for(r.session_id)),
                           torch.as_tensor(plain.tokens_for(r.session_id)))
    assert graph.step_cache_size == 1
    assert replayed == K * cfg.n_layers * plain.decode_steps
    live = {}
    free_below_live = False
    for ev in graph.events:
        if ev[0] == "admit":
            live[ev[2]] = ev[1]
        elif ev[0] == "finish":
            live.pop(ev[2], None)
        elif ev[0] == "token" and ev[2] > 0 and 0 not in live:
            free_below_live = True
    assert free_below_live



def test_paged_moe_step_repeats_bit_equal(cuda):
    """A 2-layer qwen2-moe-a2.7b at full width: one paged decode step,
    called 12 times from copies of one cache, gives the same logits bits
    on every lane, with two inactive lanes scattered to one row of the
    garbage page 0 and a free lane reading that page (its junk routes
    through the experts beside the live lanes).  Before the last-writer
    rule the card's scatter picked a winner by race."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config("qwen2-moe-a2.7b").replace(n_layers=2)
    model = Model(cfg, decode_backend="cuda", device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    cache = model.init_cache(4, 64, paged=True, page_size=16)
    g = torch.Generator(device=cuda).manual_seed(1)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=g, device=cuda))
    cache["block_table"].zero_()
    cache["block_table"][0, :3] = torch.tensor([1, 2, 3])
    cache["block_table"][1, :3] = torch.tensor([5, 6, 7])
    cache["block_table"][3, :3] = torch.tensor([9, 10, 11])
    cache["pos"].copy_(torch.tensor([20, 37, 4, 20]))
    tokens = torch.tensor([[11], [22], [33], [44]], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, False, False], device=cuda)
    runs = []
    for _ in range(12):
        c = {k: v.clone() for k, v in cache.items()}
        logits, c = model.decode_step(params, c, tokens, active=active)
        runs.append((logits.view(torch.int16).clone(), c["k"][:, 0].clone()))
    for logits, page0 in runs[1:]:
        assert torch.equal(logits, runs[0][0])
        assert torch.equal(page0.view(torch.int16), runs[0][1].view(torch.int16))

def test_capture_collects_a_cycle_that_owns_a_graph(cuda):
    """A reference cycle that owns a captured CUDA graph (as a scheduler
    and its programs do), dropped just before another capture:
    ``dispatch.capture`` collects it first.  Destroyed inside a capture
    (the collector can run at any allocation), the old graph's reset is
    a call a capture forbids, and the new capture fails."""
    import gc

    from repro_torch.core import dispatch

    class Owner:
        pass
    owner = Owner()
    owner.me = owner
    y = torch.zeros(8, device=cuda)
    owner.graph = dispatch.capture(lambda: y + 1, {"y": y})
    del owner
    x = torch.arange(8.0, device=cuda)

    def step():
        gc.collect()          # a collection that falls inside the capture
        return x * 2
    cap = dispatch.capture(step, {"x": x})
    x.fill_(3.0)
    cap.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap.output, torch.full((8,), 6.0, device=cuda))


def _tier_requests(cfg):
    from repro_torch.serving import SessionRequest
    return [SessionRequest(f"s{i}", (torch.arange(6 + 3 * i) * (i + 5)
                                     % cfg.vocab_size).numpy(), 6 + i % 3)
            for i in range(5)]


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_kv_blob_roundtrip_on_cuda(cuda, kv_dtype):
    """Pages saved from a paged pool on the card land in the host pool's
    page-locked rows (a put adopts them), come back bit-equal into other
    pages after the pool was clobbered, codes and scales alike; the
    pools keep their tensors; without a pool the blobs are page-locked
    too."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.memory import (HostPagePool, restore_kv_blobs,
                                            save_kv_blobs)
    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg, device=cuda)
    cache = model.init_cache(2, 64, kv_dtype=kv_dtype, paged=True,
                             page_size=16, n_pages=12)
    g = torch.Generator(device=cuda).manual_seed(0)
    keys = model._page_slab_keys(cache)
    for key in keys:
        t = cache[key]
        t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=cuda)
                if t.dtype == torch.int8 else
                torch.randn(t.shape, generator=g, device=cuda))
    orig = {k: cache[k].clone() for k in keys}
    ptrs = {k: cache[k].data_ptr() for k in keys}
    src, dst = [2, 3, 4, 9, 7], [5, 6, 8, 10, 11]
    pool = HostPagePool(8, pin_memory=True)
    blobs = save_kv_blobs(model.save_kv_pages, cache, src, pool)
    assert all(c.is_pinned() and not c.is_cuda for b in blobs for c in b)
    handles = [pool.put(b, pinned=True) for b in blobs]
    assert [pool.get(h)[0].data_ptr() for h in handles] == \
        [b[0].data_ptr() for b in blobs]
    for key in keys:
        cache[key][:, dst].zero_()
    restore_kv_blobs(model.restore_kv_pages, cache, dst,
                     [pool.get(h) for h in handles])
    torch.cuda.synchronize()
    for key in keys:
        assert cache[key].data_ptr() == ptrs[key]
        assert torch.equal(cache[key][:, dst], orig[key][:, src]), key
        assert torch.equal(cache[key][:, src], orig[key][:, src]), key
    fresh = save_kv_blobs(model.save_kv_pages, cache, src)
    assert all(c.is_pinned() for b in fresh for c in b)
    assert all(torch.equal(a, b) for x, y in zip(fresh, blobs)
               for a, b in zip(x, y))


@pytest.mark.parametrize("kv_quant,K", [("none", 1), ("int8", 4)])
def test_tiered_scheduler_graph_replays_equal_plain_calls(cuda, kv_quant, K):
    """The paged scheduler with the host tier ("spill"): a preempted
    session parks its full pages in page-locked host rows and is restored
    into other pages, in place; the decode graph replayed after the
    restore gives the same event log as plain calls, and both pools
    balance."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import SlotScheduler
    cfg = get_config("qwen2.5-3b").reduced().replace(dtype="float32")
    model = Model(cfg, decode_backend="cuda", device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    runs = []
    for capture in (True, False):
        sched = SlotScheduler(model, params, n_slots=2, max_len=40, paged=True,
                              page_size=8, n_pages=1 + 5, steps_per_tick=K,
                              kv_dtype=torch.int8 if kv_quant == "int8" else None,
                              kv_tier="host", tier_policy="spill")
        sched._progs.capture = capture
        for r in _tier_requests(cfg):
            sched.submit(r)
        runs.append((sched, sched.run()))
    (sched, graph), (_, plain) = runs
    assert graph.events == plain.events
    assert graph.step_cache_size == 1
    assert graph.tier_restores >= 1 and graph.pages_restored >= 1
    assert all(c.is_pinned() for c in sched.store.host._slabs)
    sched.store.flush_host()
    assert sched.store.allocator.n_free == sched.store.n_pages - 1
    assert sched.store.host_used == 0


def test_injected_save_fail_past_the_budget_balances_both_pools(cuda):
    """Every save fails past a retry budget of 1: parks degrade to
    re-prefill, the streams equal the fault-free run's, and the device
    pool and the host pool balance."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import (FaultInjector, FaultPlan, FaultPlanConfig,
                                     FaultSpec, SlotScheduler)
    cfg = get_config("qwen2.5-3b").reduced().replace(dtype="float32")
    model = Model(cfg, decode_backend="cuda", device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    plan = FaultPlan(FaultPlanConfig(), (FaultSpec("save_fail", 0.0, "", 50),))
    runs = []
    for inj in (None, FaultInjector(plan)):
        sched = SlotScheduler(model, params, n_slots=2, max_len=40, paged=True,
                              page_size=8, n_pages=1 + 5, kv_tier="host",
                              fault_injector=inj, retry_budget=1,
                              self_audit=inj is not None)
        for r in _tier_requests(cfg):
            sched.submit(r)
        runs.append((sched, sched.run()))
    (_, clean), (sched, chaos) = runs
    assert chaos.save_retries >= 1 and chaos.fault_counts.get("save_fail", 0) >= 2
    assert sched.store.park_fails >= 1 and chaos.tier_restores == 0
    for sid, s in clean.sessions.items():
        assert chaos.sessions[sid].status == "ok"
        assert s.tokens.tolist() == chaos.sessions[sid].tokens.tolist(), sid
    sched.store.flush_host()
    assert sched.store.allocator.n_free == sched.store.n_pages - 1
    assert sched.store.host_used == 0 and chaos.audit_failures == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,parametric,strided", [
    ((1, 2560), True, False), ((512, 3584), True, False),
    ((3, 5120), False, False), ((4, 7, 2048), True, True),
    ((4, 4096), True, False), ((2, 6, 96), False, True),
    ((3, 2560), True, False), ((4097, 2560), True, False),
    ((4097, 5120), False, False), ((3, 7, 3584), True, True)])
def test_rmsnorm(cuda, dtype, shape, parametric, strided):
    """Kernel 5 against its plain version: decode and prefill rows, the
    non-parametric variant and a strided slice (the last position of a
    batch, read in place)."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = 3 * torch.randn(shape, generator=g, device=cuda)
    x = (x[:, -1:] if strided else x).to(dtype)
    w = ((1 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)).to(dtype)
         if parametric else None)
    before = rms_ops.launches
    out = rms_ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    want = rmsnorm_ref(x, w)
    assert out.shape == x.shape and out.dtype == dtype
    if dtype == torch.bfloat16:
        err = (out.float() - want.float()).abs()
        assert bool(torch.all(err <= want.float().abs() * 2 ** -7 + 1e-30))
    else:
        _close(out, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(1, 2560), (4, 5120), (3, 3584), (2048, 3584),
                                 (4097, 2560)])
def test_rmsnorm_repeat_and_graph_replay(cuda, dtype, R, D):
    """Kernel 5: two calls are bit-equal, and a call captured as a CUDA
    graph (one launch, the output its only allocation) replayed with new x
    three times equals an eager call on that x bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(R + D)
    x = (3 * torch.randn((R, D), generator=g, device=cuda)).to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
    assert torch.equal(rms_ops.rmsnorm(x, w), rms_ops.rmsnorm(x, w))
    static_x = x.clone()
    graph = torch.cuda.CUDAGraph()
    before = rms_ops.launches
    with torch.cuda.graph(graph):
        out = rms_ops.rmsnorm(static_x, w)
    assert rms_ops.launches == before + 1
    for _ in range(3):
        new_x = (3 * torch.randn((R, D), generator=g, device=cuda)).to(dtype)
        static_x.copy_(new_x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, rms_ops.rmsnorm(new_x, w))


def _bwd_ok(out, want, dtype, floor):
    """The backward kernel's tolerance: f32 within 1e-5 x max|plain|;
    bf16 within one bf16 spacing of the plain version's element plus
    ``floor`` x max|plain| (dx: 1e-5, where its two terms cancel; dw:
    1e-3, a sum over R rows in another order)."""
    o, w = out.float(), want.float()
    scale = float(w.abs().max())
    if dtype == torch.float32:
        return float((o - w).abs().max()) <= 1e-5 * scale
    return bool(torch.all((o - w).abs() <= w.abs() * 2 ** -7 + floor * scale))


def _groups_rows(spec, D, dtype, dev):
    """R from ``spec``: an int, or (k, delta) for k times the row groups
    the card's plan runs at once (``card_bwd_plan``'s grid x groups),
    plus delta: the persistent grid's edges."""
    if isinstance(spec, int):
        return spec
    k, delta = spec
    size = torch.empty((), dtype=dtype).element_size()
    plan = rms_ops.card_bwd_plan(4096, D, size, dev.index or 0)
    return k * plan.grid * plan.groups + delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parametric", [True, False])
@pytest.mark.parametrize("R,D", [(1, 2048), (7, 1536), (2048, 2048), (4096, 3584),
                                 (2048, 5120), (3, 128), (5, 8192),
                                 ((1, -1), 2048), ((1, 1), 2048), ((2, -1), 1536),
                                 ((2, 1), 2560), ((1, 1), 4096), (2048, 1536),
                                 (2048, 2560), (1000, 4096), (2048, 8192)])
def test_rmsnorm_bwd(cuda, dtype, parametric, R, D):
    """Kernel 5's backward against ``rmsnorm_bwd_ref`` at the training
    shapes (qwen2.5-3b D 2048 at R 2048), a decode row, ragged rows, the
    reduced width and the widest f32 row; R one below and above once and
    twice the row groups the persistent grid holds; D 1536, 2560, 4096 and
    8192 (bf16 and f32); two calls bit-equal."""
    R = _groups_rows(R, D, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(R + D)
    x = (3 * torch.randn((R, D), generator=g, device=cuda)).to(dtype)
    dy = torch.randn((R, D), generator=g, device=cuda).to(dtype)
    w = ((1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
         if parametric else None)
    before = rms_ops.bwd_launches
    dx, dw = rms_ops.rmsnorm_bwd(x, w, dy)
    dx2, dw2 = rms_ops.rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert rms_ops.bwd_launches == before + 2
    want_dx, want_dw = rms_ops.ref.rmsnorm_bwd_ref(x, w, dy)
    assert dx.dtype == dtype and dx.shape == x.shape and torch.equal(dx, dx2)
    assert _bwd_ok(dx, want_dx, dtype, 1e-5)
    if parametric:
        assert dw.dtype == dtype and torch.equal(dw, dw2)
        assert _bwd_ok(dw, want_dw, dtype, 1e-3)
    else:
        assert dw is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_graph_replay_and_function(cuda, dtype):
    """A backward call captured as a CUDA graph, replayed with new x and
    dy, equals an eager call bit for bit; ``ops.rmsnorm`` under grad mode
    runs the forward kernel and, in the backward, this kernel; under
    inference_mode it launches the forward alone, with no grad_fn."""
    R, D = 2048, 2048
    g = torch.Generator(device=cuda).manual_seed(D)
    w = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
    sx = (3 * torch.randn((R, D), generator=g, device=cuda)).to(dtype)
    sdy = torch.randn((R, D), generator=g, device=cuda).to(dtype)
    rms_ops.rmsnorm_bwd(sx, w, sdy)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dx, dw = rms_ops.rmsnorm_bwd(sx, w, sdy)
    for _ in range(2):
        x = (3 * torch.randn((R, D), generator=g, device=cuda)).to(dtype)
        dy = torch.randn((R, D), generator=g, device=cuda).to(dtype)
        sx.copy_(x)
        sdy.copy_(dy)
        graph.replay()
        torch.cuda.synchronize()
        want_dx, want_dw = rms_ops.rmsnorm_bwd(x, w, dy)
        assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    f0, b0 = rms_ops.launches, rms_ops.bwd_launches
    y = rms_ops.rmsnorm(xr, wr)
    gx, gw = torch.autograd.grad(y, (xr, wr), dy)
    assert (rms_ops.launches - f0, rms_ops.bwd_launches - b0) == (1, 1)
    assert torch.equal(gx, want_dx) and torch.equal(gw, want_dw)
    with torch.inference_mode():
        out = rms_ops.rmsnorm(xr, wr)
    assert out.grad_fn is None
    assert (rms_ops.launches - f0, rms_ops.bwd_launches - b0) == (2, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(2048, 2048), (7, 1536), (4097, 3584)])
def test_rmsnorm_bwd_graph_replays_equal_eager_calls(cuda, dtype, R, D):
    """One captured backward (one launch) replayed three times with new
    x and dy: dx and dw bit-equal to eager calls on the same inputs each
    time, and the kernel's tickets back at 0 after each replay, so the
    last block of each slice of dw is found afresh."""
    g = torch.Generator(device=cuda).manual_seed(R + 3 * D)
    w = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
    sx = (3 * torch.randn((R, D), generator=g, device=cuda)).to(dtype)
    sdy = torch.randn((R, D), generator=g, device=cuda).to(dtype)
    rms_ops.rmsnorm_bwd(sx, w, sdy)   # allocates the tickets, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = rms_ops.bwd_launches
    with torch.cuda.graph(graph):
        dx, dw = rms_ops.rmsnorm_bwd(sx, w, sdy)
    assert rms_ops.bwd_launches == before + 1
    tickets = rms_ops._tickets[cuda.index or 0]
    for _ in range(3):
        x = (3 * torch.randn((R, D), generator=g, device=cuda)).to(dtype)
        dy = torch.randn((R, D), generator=g, device=cuda).to(dtype)
        sx.copy_(x)
        sdy.copy_(dy)
        graph.replay()
        torch.cuda.synchronize()
        assert not bool(tickets.any())
        want_dx, want_dw = rms_ops.rmsnorm_bwd(x, w, dy)
        torch.cuda.synchronize()
        assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
        assert not bool(tickets.any())
        assert _bwd_ok(dw, rms_ops.ref.rmsnorm_bwd_ref(x, w, dy)[1], dtype, 1e-3)


def _ssd_case(dev, B, H, P, N, G, dtype, seed, strided=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((B, H, P, N), generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((B, H), generator=g, device=dev))
    A = -torch.exp(torch.randn((H,), generator=g, device=dev))
    if strided:   # views into one (B, H*P + 2*G*N) row, as the decode step makes
        row = torch.randn((B, H * P + 2 * G * N), generator=g, device=dev).to(dtype)
        x = row[:, :H * P].reshape(B, H, P)
        Bm = row[:, H * P:H * P + G * N].reshape(B, G, N)
        Cm = row[:, H * P + G * N:].reshape(B, G, N)
    else:
        x = torch.randn((B, H, P), generator=g, device=dev).to(dtype)
        Bm = torch.randn((B, G, N), generator=g, device=dev).to(dtype)
        Cm = torch.randn((B, G, N), generator=g, device=dev).to(dtype)
    return h, x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,P,N,G,strided", [
    (1, 80, 64, 128, 1, True), (2, 64, 64, 64, 1, False),
    (3, 8, 16, 32, 2, True), (1, 4, 8, 16, 4, False), (2, 6, 5, 24, 3, False),
    (1, 8, 37, 16, 1, False), (1, 8, 64, 20, 2, True), (2, 4, 100, 256, 2, True),
    (1, 80, 61, 128, 1, False)])
def test_ssd_update(cuda, dtype, B, H, P, N, G, strided):
    """Kernel 4 against its plain version, out of place and in place (h'
    written over h); h' is f32 and computed as the plain version does."""
    h, x, dt, A, Bm, Cm = _ssd_case(cuda, B, H, P, N, G, dtype, B * H + N,
                                    strided)
    want_h, want_y = ssd_update_ref(h, x, dt, A, Bm, Cm)
    before = ssd_ops.launches
    h_new, y = ssd_ops.ssd_update(h, x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    _close(h_new, want_h, torch.float32)
    _close(y, want_y, torch.float32)
    h_in, y2 = ssd_ops.ssd_update(h, x, dt, A, Bm, Cm, out=h)
    torch.cuda.synchronize()
    assert h_in is h and torch.equal(h, h_new) and torch.equal(y2, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,P,N,G", [
    (1, 80, 64, 128, 1), (1, 64, 64, 64, 1), (2, 4, 100, 256, 2), (1, 8, 64, 20, 2)])
def test_ssd_update_repeat_and_graph_replay(cuda, dtype, B, H, P, N, G):
    """Kernel 4: two calls are bit-equal; an in-place call (out=h)
    captured as a CUDA graph (one launch, y its only allocation) and
    replayed with new inputs three times gives h' and y bit-equal to an
    eager call on those inputs."""
    args = _ssd_case(cuda, B, H, P, N, G, dtype, 7 * H + N)
    h1, y1 = ssd_ops.ssd_update(*args)
    h2, y2 = ssd_ops.ssd_update(*args)
    assert torch.equal(h1, h2) and torch.equal(y1, y2)
    static = [t.clone() for t in args]
    graph = torch.cuda.CUDAGraph()
    before = ssd_ops.launches
    with torch.cuda.graph(graph):
        _, y = ssd_ops.ssd_update(*static, out=static[0])
    assert ssd_ops.launches == before + 1
    for seed in range(3):
        new = _ssd_case(cuda, B, H, P, N, G, dtype, seed)
        want_h, want_y = ssd_ops.ssd_update(*new)
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static[0], want_h) and torch.equal(y, want_y)


def test_ssd_update_full_decay(cuda):
    """dt*A = -500: exp gives 0 and h' is the input term exactly."""
    B, H, P, N = 1, 2, 4, 16
    h = torch.full((B, H, P, N), 100.0, device=cuda)
    h_new, y = ssd_ops.ssd_update(
        h, torch.ones((B, H, P), device=cuda), torch.full((B, H), 50.0, device=cuda),
        torch.full((H,), -10.0, device=cuda), torch.full((B, 1, N), 2.0, device=cuda),
        torch.ones((B, 1, N), device=cuda), out=h)
    torch.cuda.synchronize()
    assert torch.equal(h, torch.full_like(h, 100.0))
    assert torch.equal(y, torch.full((B, H, P), 100.0 * N, device=cuda))


def test_ssm_decode_step_replays_as_a_cuda_graph(cuda):
    """The mamba2 decode step updates its state and conv window in place
    and reads nothing back to the host, so it captures as one CUDA graph,
    kernels 4 and 5 included, and each replay equals an eager step."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    cfg = get_config("mamba2-2.7b").reduced().replace(dtype="float32")
    model = Model(cfg, device=cuda)
    eng = DecodeEngine(model, model.init(torch.Generator(device=cuda).manual_seed(0)))
    prompt = {"tokens": torch.arange(16, device=cuda)[None] * 7 % cfg.vocab_size}
    feed = (5, 9, 3, 200)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        _, eager_cache = eng.prefill(prompt, 32)
        want = []
        for t in feed:
            tok.fill_(t)
            want.append(model.decode_step(eng.params, eager_cache, tok)[0].clone())
        _, warm = eng.prefill(prompt, 32)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode_step(eng.params, warm, tok)
        torch.cuda.current_stream().wait_stream(side)
        _, cache = eng.prefill(prompt, 32)
        graph = torch.cuda.CUDAGraph()
        before = (ssd_ops.launches, rms_ops.launches)
        with torch.cuda.graph(graph):
            logits, _ = model.decode_step(eng.params, cache, tok)
        for t, w in zip(feed, want):
            tok.fill_(t)
            graph.replay()
            torch.cuda.synchronize()
            torch.testing.assert_close(logits, w, rtol=1e-5, atol=1e-5)
    assert int(cache["pos"]) == 16 + len(feed)
    torch.testing.assert_close(cache["h"], eager_cache["h"], rtol=1e-5, atol=1e-5)
    assert torch.equal(cache["conv"], eager_cache["conv"])
    assert ssd_ops.launches == before[0] + cfg.n_layers
    assert rms_ops.launches == before[1] + 2 * cfg.n_layers + 1


# ---------------------------------------------------------------- dispatch A/B
def _ab_engine(cuda, quant, name="qwen2.5-3b"):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    cfg = get_config(name).reduced()
    model = Model(cfg, decode_backend="cuda", device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    return DecodeEngine(model, params, quant_path=quant)


def _ab_prompt(eng, cuda, n=12):
    return {"tokens": torch.arange(n, device=cuda)[None] * 7 % eng.cfg.vocab_size}


@pytest.mark.parametrize("quant", ["bf16", "int4_fused"])
def test_graph_arms_replay_equal_eager(cuda, quant):
    """The stage_jit and full_jit executors (one graph per stage, one for
    the step) replayed over 8 steps equal the eager executor: logits,
    cache rows and positions bit for bit, since a replay runs the same
    kernels on the same inputs; the replays launch kernel 1 once per
    layer and step (``launches - captured_launches + replay_launches``)."""
    from repro_torch.core import dispatch
    eng = _ab_engine(cuda, quant)
    feed = [(5 * i + 3) % eng.cfg.vocab_size for i in range(8)]
    runs = {}
    with torch.inference_mode():
        for mode in dispatch.MODES:
            _, cache = eng.prefill(_ab_prompt(eng, cuda), 32)
            run = eng.step_program(cache).executor(mode)
            tok = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
            before = (da_ops.launches, dict(dispatch.captured_launches),
                      dict(dispatch.replay_launches))
            logits = []
            for t in feed:
                tok.fill_(t)
                logits.append(run({"tokens": tok, "cache": cache})["logits"].clone())
            torch.cuda.synchronize()
            launched = (da_ops.launches - before[0]
                        - (dispatch.captured_launches.get("decode_attention", 0)
                           - before[1].get("decode_attention", 0))
                        + (dispatch.replay_launches.get("decode_attention", 0)
                           - before[2].get("decode_attention", 0)))
            assert launched == eng.cfg.n_layers * len(feed), mode
            runs[mode] = (logits, cache)
    want_logits, want_cache = runs["eager"]
    assert int(want_cache["pos"]) == 12 + len(feed)
    for mode in ("stage_jit", "full_jit"):
        logits, cache = runs[mode]
        for i, (got, want) in enumerate(zip(logits, want_logits)):
            assert torch.equal(got, want), f"{mode} step {i}"
        for key in want_cache:
            assert torch.equal(cache[key], want_cache[key]), f"{mode} {key}"


def test_graph_executor_refuses_another_cache(cuda):
    eng = _ab_engine(cuda, "bf16")
    tok = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        _, cache = eng.prefill(_ab_prompt(eng, cuda), 32)
        _, other = eng.prefill(_ab_prompt(eng, cuda), 32)
        for mode in ("stage_jit", "full_jit"):
            run = eng.step_program(cache).executor(mode)
            run({"tokens": tok, "cache": cache})
            run({"tokens": tok, "cache": cache})
            with pytest.raises(ValueError, match="another cache"):
                run({"tokens": tok, "cache": other})
            with pytest.raises(ValueError, match="token shape"):
                run({"tokens": tok.expand(2, 1), "cache": cache})


def _plain_greedy(eng, batch, max_len, n_new):
    with torch.inference_mode():
        logits, cache = eng.prefill(batch, max_len)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        out = [tok]
        for _ in range(n_new - 1):
            logits, _ = eng.model.decode_step(eng.params, cache, tok[:, None])
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            out.append(tok)
    return torch.stack(out, dim=1)


def _plain_sampled(eng, batch, max_len, n_new, seed, temperature=0.8, top_k=5):
    """Uncaptured stochastic tokens: prefill, the first draw, then
    ``Model.decode_steps``, all from one generator seeded with ``seed``."""
    from repro_torch.serving.sampling import sample
    with torch.inference_mode():
        logits, cache = eng.prefill(batch, max_len)
        gen = torch.Generator(device=eng.device).manual_seed(seed)
        tok = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
        toks, _ = eng.model.decode_steps(eng.params, cache, tok[:, None], gen,
                                         horizon=n_new - 1, temperature=temperature,
                                         top_k=top_k)
    return torch.cat([tok[:, None], toks], dim=1)


@pytest.mark.parametrize("name,quant", [("qwen2.5-3b", "bf16"),
                                        ("qwen2.5-3b", "int4_fused"),
                                        ("mamba2-2.7b", "bf16")])
def test_engine_graph_tokens_equal_plain_calls(cuda, name, quant):
    """The engine's captured step (streamed: one replay per token; fused:
    one replay of the whole horizon) gives the tokens of plain
    ``decode_step`` calls, for two requests of one shape (the second
    replays the first's graphs over the reused cache); the replays
    launch the kernels per step as the plain calls do."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import launch_counts
    eng = _ab_engine(cuda, quant, name)
    n_new = 10
    batch = _ab_prompt(eng, cuda, 16)
    want = _plain_greedy(eng, batch, 40, n_new)
    for _ in range(2):
        assert torch.equal(eng.generate_streamed(batch, max_len=40, n_new=n_new).tokens,
                           want)
        assert torch.equal(eng.generate_fused(batch, max_len=40, n_new=n_new).tokens,
                           want)
    assert len(eng._executors) == 2 and len(eng._caches) == 1
    before = (launch_counts(), dict(dispatch.replay_launches))
    eng.generate_streamed(batch, max_len=40, n_new=n_new)
    eng.generate_fused(batch, max_len=40, n_new=n_new)
    steps = 2 * (n_new - 1)
    per_step = ({"ssd_update": eng.cfg.n_layers} if eng.cfg.family == "ssm"
                else {"decode_attention": eng.cfg.n_layers})
    per_step["rmsnorm"] = 2 * eng.cfg.n_layers + 1
    for kernel, n in per_step.items():
        assert (dispatch.replay_launches.get(kernel, 0)
                - before[1].get(kernel, 0)) == n * steps, kernel
    # the wrappers ran only for the two prefills (their norms)
    assert launch_counts()["rmsnorm"] - before[0]["rmsnorm"] == 2 * per_step["rmsnorm"]
    # stochastic: the fused graph (captured, then replayed) draws what
    # uncaptured decode_steps draws from the same seed
    want = _plain_sampled(eng, batch, 40, n_new, seed=5)
    for _ in range(2):
        assert torch.equal(eng.generate_fused(batch, max_len=40, n_new=n_new, seed=5,
                                              temperature=0.8, top_k=5).tokens, want)


def test_engine_stochastic_graphs_are_keyed_by_temperature_and_top_k(cuda):
    """Each (temperature, top_k) has its fused graph: a change of either
    captures a new executor, whose replays draw that setting's tokens;
    a second seed replays the graph with other draws; a greedy call
    after them still gives the greedy tokens."""
    eng = _ab_engine(cuda, "bf16")
    batch = _ab_prompt(eng, cuda, 16)
    settings = [(0.8, 5), (0.8, 0), (0.5, 5)]
    for t, k in settings:
        streams = []
        for seed in (1, 2, 1):
            got = eng.generate_fused(batch, max_len=40, n_new=10, seed=seed,
                                     temperature=t, top_k=k).tokens
            assert torch.equal(got, _plain_sampled(eng, batch, 40, 10, seed, t, k))
            streams.append(got)
        assert not torch.equal(streams[0], streams[1]) and torch.equal(streams[0],
                                                                       streams[2])
    assert len(eng._executors) == len(settings) and len(eng._generators) == len(settings)
    assert torch.equal(eng.generate_fused(batch, max_len=40, n_new=10).tokens,
                       _plain_greedy(eng, batch, 40, 10))
    assert len(eng._executors) == len(settings) + 1


def test_engine_loops_keep_their_own_graphs_at_one_horizon(cuda):
    """At n_new=2 the fused loop's horizon is 1, one step like the
    streamed loop's: each loop still captures and replays its own graph
    (logits for the one, tokens for the other) over the shared cache."""
    eng = _ab_engine(cuda, "bf16")
    batch = _ab_prompt(eng, cuda, 16)
    want = _plain_greedy(eng, batch, 40, 2)
    for _ in range(2):
        for loop in (eng.generate_streamed, eng.generate_fused):
            got = loop(batch, max_len=40, n_new=2).tokens
            assert got.shape == (1, 2) and torch.equal(got, want), loop.__name__
    assert len(eng._executors) == 2 and len(eng._caches) == 1


def _train_setup(cuda, dtype):
    """The reduced qwen2.5-3b, params drawn on the CPU with its norms and
    biases moved off 1 / 0, on the CPU and on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.training import DataCursor, synthetic_batch
    from repro_torch.training.tree import leaves_with_path
    cfg = get_config("qwen2.5-3b").reduced().replace(dtype=dtype)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for path, t in leaves_with_path(params):
        if path[-1] in ("norm1", "norm2", "final_norm", "bq", "bk", "bv"):
            t.add_((0.1 * torch.randn(t.shape, generator=g)).to(t.dtype))
    batches = [synthetic_batch(cfg, DataCursor(3, i), batch=2, seq_len=64)
               for i in range(4)]
    return cfg, params, batches


def _to(tree, dev):
    from repro_torch.training.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def test_train_step_grads_card_equal_cpu(cuda):
    """The reduced f32 model's loss and grads on the card (kernel 5 and
    its backward, remat blocks) against the CPU's (their plain versions),
    each leaf within 1e-4 x max|g|; the norm weights' grads are nonzero."""
    from repro_torch.models.model import Model
    from repro_torch.training import trainable
    from repro_torch.training.tree import leaves_with_path
    cfg, params, batches = _train_setup(cuda, "float32")
    out = {}
    for dev, remat in (("cpu", "none"), (cuda, "blocks")):
        p = trainable(_to(params, dev))
        loss, _ = Model(cfg, device=dev, remat=remat).loss(p, _to(batches[0], dev))
        leaves = leaves_with_path(p)
        b0 = rms_ops.bwd_launches
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out[str(dev)] = (float(loss.detach()), [(path, gr.cpu()) for (path, _), gr
                                                in zip(leaves, grads)],
                         rms_ops.bwd_launches - b0)
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, bwd) = out["cpu"], out[str(cuda)]
    assert bwd == 2 * cfg.n_layers + 1
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    for (path, a), (_, b) in zip(g_gpu, g_cpu):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), path
        if path[-1] in ("norm1", "norm2", "final_norm"):
            assert float(a.abs().max()) > 0, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jit_train_step_replays_equal_eager_steps(cuda, dtype):
    """jit_train_step (the first call a real step on a side stream and the
    capture, then graph replays) gives the eager step's losses and params
    bit for bit over 4 batches from the same state; the replays launch
    kernel 5's forward and backward as an eager step does; another batch
    shape raises; another state is copied into the captured one."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import Model
    from repro_torch.training import (AdamW, jit_train_step, make_train_step,
                                      trainable)
    from repro_torch.training.tree import tree_leaves
    cfg, params, batches = _train_setup(cuda, dtype)
    model = Model(cfg, device=cuda)
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt, remat="blocks")
    runs = {}
    for label, fn in (("eager", step), ("graph", jit_train_step(step))):
        p = trainable(_to(params, cuda))
        state = (p, opt.init(p))
        losses, counts = [], []
        for b in batches:
            before = (launch_counts(), dict(dispatch.replay_launches))
            state, m = fn(state, _to(b, cuda))
            losses.append(float(m["loss"]))
            counts.append({k: launch_counts()[k] - before[0][k]
                           + dispatch.replay_launches.get(k, 0) - before[1].get(k, 0)
                           for k in ("rmsnorm", "rmsnorm_bwd")})
        runs[label] = (losses, [t.detach().clone() for t in tree_leaves(state)], counts)
    assert runs["graph"][0] == runs["eager"][0]
    for a, b in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(a, b)
    per_step = {"rmsnorm": 4 * cfg.n_layers + 1, "rmsnorm_bwd": 2 * cfg.n_layers + 1}
    assert runs["eager"][2] == [per_step] * 4
    assert runs["graph"][2][2:] == [per_step] * 2     # replays
    with pytest.raises(ValueError, match="captured for batches"):
        b = _to(batches[0], cuda)
        fn(state, {k: v[:1] for k, v in b.items()})
    fresh = trainable(_to(params, cuda))
    state2, m = fn((fresh, opt.init(fresh)), _to(batches[0], cuda))
    assert state2 is state and float(m["loss"]) == runs["eager"][0][0]


# ------------------------------------------- the attention contraction
# _gqa_scores / _gqa_out on the tensor cores (bf16 operands, f32 result)
# against the f32 einsum over the upcast operands, the route CPU tensors
# take.  Both sum exact products in f32, so an entry differs by at most
# the two sums' rounding: |d| <= 2 n 2^-24 sum|a||b| over its n terms.
GQA_SHAPES = [  # B, Sq, Sk, Hq, Hkv, hd: qwen2.5-7b and qwen2.5-3b heads
    (1, 1, 2048, 28, 4, 128), (1, 512, 512, 28, 4, 128), (2, 64, 1024, 28, 4, 128),
    (1, 1, 2048, 16, 2, 128), (1, 512, 512, 16, 2, 128), (2, 64, 1024, 16, 2, 128)]


def _gqa_inputs(cuda, B, Sq, Sk, Hq, Hkv, hd, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, Sq, Hq, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Sk, Hkv, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, Sk, Hkv, hd), generator=g, device=cuda).bfloat16()
    return q, k, v


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd", GQA_SHAPES)
def test_gqa_contraction_on_tensor_cores(cuda, B, Sq, Sk, Hq, Hkv, hd):
    """Scores and outputs of the bf16 route within the summation-order
    bound of the f32 einsum's, both f32, in the same layout."""
    from repro_torch.models import attention as attn
    q, k, v = _gqa_inputs(cuda, B, Sq, Sk, Hq, Hkv, hd)
    assert attn._on_tensor_cores(q, k)
    s = attn._gqa_scores_local(q, k)
    s_ref = attn._gqa_scores_local(q.cpu(), k.cpu())
    assert s.dtype == torch.float32 and s.shape == s_ref.shape
    # the sums' bound, scaled by hd^-0.5, and each route's rounding of that
    # product
    bound = 2 * hd * 2.0 ** -24 * attn._gqa_scores_local(q.cpu().abs(), k.cpu().abs())
    bound += 2.0 ** -23 * s_ref.abs()
    assert bool(((s.cpu() - s_ref).abs() <= bound + 1e-30).all())
    probs = torch.softmax(s, dim=-1)
    o = attn._gqa_out_local(probs, v)
    o_ref = attn._gqa_out_local(probs.cpu(), v.cpu())
    assert o.dtype == torch.float32 and o.shape == o_ref.shape
    bound = 2 * Sk * 2.0 ** -24 * attn._gqa_out_local(
        probs.cpu().bfloat16().float().abs(), v.cpu().abs())
    assert bool(((o.cpu() - o_ref).abs() <= bound + 1e-30).all())


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd", GQA_SHAPES[1:3] + GQA_SHAPES[4:])
def test_gqa_contraction_grads_on_tensor_cores(cuda, B, Sq, Sk, Hq, Hkv, hd):
    """Gradients of q, k and v through scores, softmax and output: the
    bf16 route (its backward rounds the f32 output gradient to bf16 and
    multiplies on the tensor cores) against the f32 einsum's, both in
    bf16, within the file's bf16 tolerance (2e-2 x max|grad|)."""
    from repro_torch.models import attention as attn
    q, k, v = _gqa_inputs(cuda, B, Sq, Sk, Hq, Hkv, hd, seed=1)
    w = torch.randn((B, Sq, Hq * hd), generator=torch.Generator().manual_seed(2))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        s = attn._gqa_scores_local(leaves[0], leaves[1])
        o = attn._gqa_out_local(torch.softmax(s, dim=-1), leaves[2])
        grads[str(dev)] = torch.autograd.grad((o * w.to(dev)).sum(), leaves)
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        assert got.dtype == torch.bfloat16
        _close(got.cpu(), want, torch.bfloat16)


def test_bf16_train_step_graph_losses_on_tensor_cores(cuda, monkeypatch):
    """The reduced bf16 model's captured train step (jit_train_step) with
    the attention on the tensor cores: its losses equal the eager step's
    bit for bit, and stay within 5e-3 x |loss| of the same captured step
    with the contraction forced onto the f32 einsum, over 4 steps."""
    from repro_torch.models import attention as attn
    from repro_torch.models.model import Model
    from repro_torch.training import (AdamW, jit_train_step, make_train_step,
                                      trainable)
    cfg, params, batches = _train_setup(cuda, "bfloat16")
    opt = AdamW(lr=1e-3)
    runs = {}
    for label, f32 in (("eager", False), ("graph", False), ("graph f32", True)):
        if f32:
            monkeypatch.setattr(attn, "_on_tensor_cores", lambda a, b: False)
        step = make_train_step(Model(cfg, device=cuda), opt, remat="blocks")
        fn = step if label == "eager" else jit_train_step(step)
        p = trainable(_to(params, cuda))
        state, losses = (p, opt.init(p)), []
        for b in batches:
            state, m = fn(state, _to(b, cuda))
            losses.append(float(m["loss"]))
        runs[label] = losses
    assert runs["graph"] == runs["eager"]
    for a, b in zip(runs["graph"], runs["graph f32"]):
        assert abs(a - b) <= 5e-3 * abs(b)


# ------------------------------------------------- the dequantisation kernel
def _dq_case(dev, bits, shape, group, seed):
    """Codes over their whole range and positive f32 scales over six
    decades: shape is the output's (..., K, N)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    *lead, K, N = shape
    rows = K // 2 if bits == 4 else K
    codes = torch.randint(0, 256, (*lead, rows, N), generator=g, device=dev,
                          dtype=torch.int32)
    codes = codes.to(torch.uint8) if bits == 4 else (codes - 128).to(torch.int8)
    exp = torch.randint(-6, 1, (*lead, K // group, N), generator=g, device=dev)
    scales = (torch.rand((*lead, K // group, N), generator=g, device=dev) + 0.5) \
        * torch.pow(10.0, exp.float())
    return codes, scales


@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("shape", [(60, 2048, 1408), (3584, 18944), (3, 256, 50),
                                   (2, 64, 16)],
                         ids=["moe-stack", "7b-w_gate", "ragged-N", "small"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequantize_bit_equal(cuda, bits, dtype, shape, group):
    """The kernel bit-equal to its plain version (vector and, at N = 50,
    scalar variants), one launch a call, two calls bit-equal."""
    if shape[-2] % group:
        pytest.skip("K is not a multiple of the group")
    codes, scales = _dq_case(cuda, bits, shape, group, sum(shape) + bits)
    before = dq_ops.launches
    got = dq_ops.dequantize(codes, scales, bits, dtype)
    again = dq_ops.dequantize(codes, scales, bits, dtype)
    torch.cuda.synchronize()
    assert dq_ops.launches == before + 2
    want = dequantize_ref(codes, scales, bits, dtype)
    view = torch.int32 if dtype == torch.float32 else torch.int16
    assert got.shape == want.shape == torch.Size(shape) and got.dtype == dtype
    assert torch.equal(got.view(view), want.view(view))
    assert torch.equal(again.view(view), got.view(view))


def test_dequantize_refuses(cuda):
    codes, scales = _dq_case(cuda, 4, (256, 64), 32, 0)
    with pytest.raises(TypeError, match="uint8"):
        dq_ops.dequantize(codes.to(torch.int8), scales, 4)
    with pytest.raises(ValueError, match="contiguous"):
        dq_ops.dequantize(torch.cat([codes, codes], 1)[:, :64], scales, 4)
    with pytest.raises(ValueError, match="one device"):
        dq_ops.dequantize(codes, scales.cpu(), 4)


BLAS = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk")
ROUTES = ("expert_einsum int4 stack", "matmul int8_fused", "matmul int8_dequant",
          "matmul int4_dequant")

# Each route is profiled in a process of its own: run after this file's
# earlier tests (graph captures among them), torch.profiler saw no
# kernel, or the GEMM alone, where a fresh process sees both.
ROUTE_KERNELS = r"""
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.dequantize.ref import dequantize_ref
from repro_torch.quant import expert_einsum, matmul, quantize
dev = torch.device("cuda", 0)
out = {}
for route in sys.argv[1:]:
    g = torch.Generator(device=dev).manual_seed(3)
    if route.startswith("expert_einsum"):
        w = quantize(torch.randn((60, 2048, 1408), generator=g, device=dev) * 0.02, 4)
        x = torch.randn((60, 4, 2048), generator=g, device=dev).to(torch.bfloat16)
        fn = lambda: expert_einsum("ecd,edf->ecf", x, w)
        plain = torch.einsum("ecd,edf->ecf", x, dequantize_ref(w.data, w.scales, 4))
    else:
        path = route.split()[1]
        bits, mode = int(path[3]), path.split("_")[1]
        w = quantize(torch.randn((3584, 18944), generator=g, device=dev) * 0.02, bits,
                     path=mode)
        x = torch.randn((1, 3584), generator=g, device=dev).to(torch.bfloat16)
        fn = lambda: matmul(x, w)
        plain = x @ dequantize_ref(w.data, w.scales, bits)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: a memset (of cuBLAS's workspace) is no kernel
    kernels = {e.key: e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
               and not e.key.startswith("Memset")}
    out[route] = {"kernels": kernels, "equal": bool(torch.equal(fn(), plain))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def route_kernels():
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", ROUTE_KERNELS, *ROUTES], cwd=root,
                          env=dict(os.environ, PYTHONPATH=str(root / "src")),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("route", ROUTES)
def test_dequantizing_routes_launch_one_pass_and_one_gemm(route_kernels, route):
    """Each route that multiplies by a dequantised copy: under the
    profiler, one dequantisation kernel and one GEMM, no elementwise
    pass (bf16 x at qwen2-moe-a2.7b's expert and qwen2.5-7b's w_gate
    shapes); the product equals the GEMM on the plain version's copy."""
    kernels = route_kernels[route]["kernels"]
    dq = {k: n for k, n in kernels.items() if "dequantize_kernel" in k}
    rest = {k: n for k, n in kernels.items() if k not in dq}
    assert list(dq.values()) == [1], kernels
    # the rest is the library's product: one GEMM (with its split-K
    # reduction, where cuBLAS picks one), no elementwise pass
    assert all(any(t in k.lower() for t in BLAS) for k in rest), kernels
    assert sum(n for k, n in rest.items() if "reduce" not in k.lower()) == 1, kernels
    assert route_kernels[route]["equal"]


# ---------------------------------------------------------------- DTensors
@pytest.fixture
def mesh11(cuda):
    """A 1x1 (data, model) CUDA mesh over a world-1 NCCL group on an
    in-process store, destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    yield make_test_mesh(data=1, model=1, device_type="cuda")
    dist.destroy_process_group()


def _dt(mesh, t, *placements):
    from torch.distributed.tensor import distribute_tensor
    return None if t is None else distribute_tensor(t, mesh, list(placements))


def _same(got, want, placements):
    from torch.distributed.tensor import DTensor
    assert isinstance(got, DTensor) and tuple(got.placements) == tuple(placements)
    assert torch.equal(got.to_local(), want)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("split", ["slots", "heads"])
def test_paged_decode_attention_dtensor(mesh11, quant, split):
    """Kernel 2 through its wrapper on DTensors: slots over data (pools'
    pages and rows gathered) or KV heads over model; equal to the
    plain-tensor call, one launch."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.quant.kv import quantize_kv_write
    R = Replicate()
    dev = mesh11.device_type
    g = torch.Generator(device=dev).manual_seed(5)
    B, page, Hkv, hd, max_blocks = 3, 16, 4, 128, 8
    n_pages = 1 + B * max_blocks
    q = torch.randn((B, 28, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((n_pages, page, Hkv, hd), generator=g, device=dev)
    v = torch.randn((n_pages, page, Hkv, hd), generator=g, device=dev)
    if quant:
        (k, ks), (v, vs) = quantize_kv_write(k), quantize_kv_write(v)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    bt = (torch.arange(B * max_blocks, device=dev, dtype=torch.int32) + 1).reshape(B, max_blocks)
    lens = torch.tensor([100, 0, 128], dtype=torch.int32, device=dev)
    want = pda_ops.paged_decode_attention(q, k, v, bt, lens, ks, vs)
    qp, pp = (((Shard(0), R), (Shard(0), Shard(1))) if split == "slots"
              else ((R, Shard(1)), (R, Shard(2))))
    before = pda_ops.launches
    got = pda_ops.paged_decode_attention(
        _dt(mesh11, q, *qp), _dt(mesh11, k, *pp), _dt(mesh11, v, *pp),
        _dt(mesh11, bt, qp[0], R), _dt(mesh11, lens, qp[0], R),
        _dt(mesh11, ks, *pp), _dt(mesh11, vs, *pp))
    assert pda_ops.launches == before + 1
    _same(got, want, qp)


@pytest.mark.parametrize("M", [1, 4, 512])
@pytest.mark.parametrize("split", ["columns", "K"])
def test_int4_matmul_dtensor(mesh11, M, split):
    """Kernel 3 (GEMV and wgmma paths) through its wrapper on DTensors:
    rows over data and columns over model, or K split (gathered)."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    dev = mesh11.device_type
    g = torch.Generator(device=dev).manual_seed(M)
    K, N, group = 1024, 512, 128
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    packed = torch.randint(0, 256, (K // 2, N), generator=g, device=dev, dtype=torch.uint8)
    scales = 0.005 + 0.01 * torch.rand((K // group, N), generator=g, device=dev)
    want = i4_ops.int4_matmul(x, packed, scales)
    xp, wp, outp = (((Shard(0), R), (R, Shard(1)), (Shard(0), Shard(1))) if split == "columns"
                    else ((R, Shard(1)), (Shard(0), R), (R, R)))
    got = i4_ops.int4_matmul(_dt(mesh11, x, *xp), _dt(mesh11, packed, *wp),
                             _dt(mesh11, scales, *wp))
    _same(got, want, outp)


@pytest.mark.parametrize("split", ["batch_heads", "replicated"])
def test_ssd_update_dtensor(mesh11, split):
    """Kernel 4 through its wrapper on DTensors, in place (out=h) on a
    state split over batch and heads, as cache_shardings plans it."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    dev = mesh11.device_type
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, P, N, G = 2, 8, 64, 128, 2
    h = torch.randn((B, H, P, N), generator=g, device=dev)
    x = torch.randn((B, H, P), generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((B, H), generator=g, device=dev))
    A = -torch.exp(torch.randn((H,), generator=g, device=dev))
    Bm = torch.randn((B, G, N), generator=g, device=dev)
    Cm = torch.randn((B, G, N), generator=g, device=dev)
    want_h, want_y = ssd_ops.ssd_update(h.clone(), x, dt, A, Bm, Cm)
    hp = (Shard(0), Shard(1)) if split == "batch_heads" else (R, R)
    hd_ = _dt(mesh11, h.clone(), *hp)
    got_h, got_y = ssd_ops.ssd_update(
        hd_, _dt(mesh11, x, *hp), _dt(mesh11, dt, *hp),
        _dt(mesh11, A, R, Shard(0) if split == "batch_heads" else R),
        _dt(mesh11, Bm, hp[0], R), _dt(mesh11, Cm, hp[0], R), out=hd_)
    assert got_h is hd_
    _same(got_h, want_h, hp)
    _same(got_y, want_y, hp)


@pytest.mark.parametrize("split", ["rows", "D"])
def test_rmsnorm_dtensor_grad(mesh11, split):
    """Kernel 5 forward and backward on DTensors under grad: dx in x's
    layout, dw Partial over the mesh dim that splits the rows; both
    equal to the plain-tensor call's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    R = Replicate()
    dev = mesh11.device_type
    g = torch.Generator(device=dev).manual_seed(6)
    x = (3 * torch.randn((2, 512, 2048), generator=g, device=dev)).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=g, device=dev)).to(torch.bfloat16)
    dy = torch.randn_like(x)
    xp, outp, dwp = (((Shard(0), R), (Shard(0), R), (Partial(), R)) if split == "rows"
                     else ((R, Shard(2)), (R, R), (R, R)))
    before = (rms_ops.launches, rms_ops.bwd_launches)
    want = rms_ops.rmsnorm(x, w)
    want_dx, want_dw = rms_ops.rmsnorm_bwd(x, w, dy)
    xd = _dt(mesh11, x, *xp).requires_grad_(True)
    wd = _dt(mesh11, w, R, R).requires_grad_(True)
    y = rms_ops.rmsnorm(xd, wd)
    dx, dw = torch.autograd.grad(y, (xd, wd), _dt(mesh11, dy, *outp))
    assert (rms_ops.launches, rms_ops.bwd_launches) == (before[0] + 2, before[1] + 2)
    _same(y, want, outp)
    _same(dx, want_dx, xp)
    _same(dw, want_dw, dwp)


def test_check_refuses_null_pointers(mesh11):
    """A DTensor reaching a launcher's check is refused on the host."""
    from torch.distributed.tensor import Replicate
    R = Replicate()
    dev = mesh11.device_type
    x = _dt(mesh11, torch.randn((4, 256), device=dev), R, R)
    with pytest.raises(ValueError, match="rmsnorm"):
        rms_ops._check(x, None)
    q = _dt(mesh11, torch.randn((1, 8, 64), device=dev), R, R)
    k = torch.randn((1, 32, 2, 64), device=dev)
    with pytest.raises(ValueError, match="decode_attention"):
        da_ops._check(q, k, k, torch.ones(32, dtype=torch.bool, device=dev))


def test_train_distributed_torchrun(cuda, tmp_path):
    """``--distributed`` under ``torch.distributed.run`` with one process
    (NCCL, a TCP rendezvous on localhost): its loss line equals the
    run without the flag."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    args = ["-m", "repro_torch.launch.train", "--arch", "qwen2.5-3b", "--reduced",
            "--steps", "6"]
    lines = []
    for pre, extra in ((["-m", "torch.distributed.run", "--standalone",
                         "--nproc-per-node", "1"], ["--distributed"]), ([], [])):
        out = subprocess.run([sys.executable, *pre, *args, *extra], env=env, cwd=root,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        lines.append(out.stdout.strip().splitlines())
    assert any("uncaptured" in line for line in lines[0])
    assert lines[0][-1] == lines[1][-1]

