"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc; every test skips without one.  This file
imports neither jax nor the JAX package, so it runs on a machine without
them (``--noconftest`` skips the suite's jax-importing conftest):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py

Tolerances, relative to max(1, |plain|): f32 1e-4 (sums in another
order), bf16 2e-2 (the output is rounded to bf16, spacing 2^-8)."""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.int4_matmul import ops as i4_ops
from repro_torch.kernels.int4_matmul.ref import int4_matmul_ref

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
    (2, 4, 4, 128, 128), (1, 2, 1, 32, 96), (1, 28, 4, 128, 2047)])
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
    if M <= i4_ops.GEMV_MAX_M and N % 8:
        with pytest.raises(ValueError):
            i4_ops.int4_matmul(x, packed, scales, group=group)
        return
    out = i4_ops.int4_matmul(x, packed, scales, group=group)
    torch.cuda.synchronize()
    _close(out, int4_matmul_ref(x, packed, scales, group), dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 96), device=cuda)
    k = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="hd"):
        da_ops.decode_attention(q, k, k, torch.ones(8, dtype=torch.bool, device=cuda))
    q = torch.zeros((1, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        da_ops.decode_attention(q, k, k, torch.ones(8, dtype=torch.bool, device=cuda))


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
