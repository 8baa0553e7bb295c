#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing catches:

 1. setup: the card's name and power limit, versions, and the build of
    every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per source,
    all started together).
 2. decode-attention kernel against its plain version, bf16 and f32, on
    the qwen2.5-7b decode shape and on ragged, per-sequence-mask (one row
    fully masked), MHA, G=4, G=8, B=3 and sparse-mask (whole splits
    masked, G=16, hd 32) shapes, and at the first decode step of the
    main paths that run it (qwen2.5-7b; zamba2-1.2b's shared block and
    musicgen-large, Hq=Hkv=32 hd 64; qwen2-moe-a2.7b, Hq=Hkv=16;
    qwen2-vl-2b, Hq 12 Hkv 2 (G=6); S=2081); each case logs its path (``ops.path_for``: mma for bf16,
    one tensor-core launch; cuda_core for f32), two calls must be
    bit-equal, and NaN written into every masked slot's K/V row must
    leave the output bit-equal (and so within tolerance of the plain
    version on the clean cache); ptxas' registers and spills of
    ``decode_attention_mma``; times of the kernel, the plain version and
    ``F.scaled_dot_product_attention`` (timed only) at the four main-path
    shapes.
 3. int4-matmul kernel against its plain version at the qwen2.5-7b layer
    shapes, M=1 and M=4 (the GEMV: batch-1 decode and the paged step's 4
    slots; bf16 and f32, two calls bit-equal, one launch each) and M=512
    and 2048 (the wgmma path: a paged prefill chunk and a prompt), with
    codes that hit -8 and 7; times of the kernel, the plain version and
    ``torch.matmul`` on the bf16 dequantised weight (timed only), per
    shape and summed over a layer; for the GEMV also ``read_ms`` (one
    ``torch.sum`` over a buffer of the same packed and scale bytes: the
    rate this card reaches on them), ``gemv_layer_ms`` (the seven GEMVs
    back to back between one event pair, L2 flushed once, as a step meets
    them) and the wrapper's host time per call (196 calls, not
    synchronised); the count of HGMMA instructions in the built library
    (``cuobjdump --dump-sass``) must not be 0.  The GEMV also at the 2-D
    int4 shapes of a qwen2-moe-a2.7b layer (wq/wk/wv/wo 2048x2048, the
    shared experts' 2048x5632 and 5632x2048), M=1, bf16 and f32, two
    calls bit-equal, timed beside ``torch.matmul``.
 4. paged-decode-attention kernel against its plain version in bf16, f32
    and int8 KV at the paged serving shape (4 slots of ~2100 live tokens,
    page 16, G=7, hd 128) and on ragged lengths with a length-0 lane at
    pages 4, 8 and 32, each case with its path (``ops.path_for``: mma for
    bf16 q, cuda_core for f32); two calls must be bit-equal and a
    poisoned garbage page 0 must leave the output bit-equal; ptxas'
    registers and spills of the mma kernel; times of the kernel, the
    plain version and gather + ``F.scaled_dot_product_attention`` (timed
    only), bf16 and int8.
 5. RMSNorm kernel against its plain version, bf16 and f32, D in {1536,
    2048, 2560, 3584, 4096, 5120} x R in {1, 4, 512, 2048} (every width and
    row count of the main paths), with and without w, and a strided
    slice read in place; bf16 output within one bf16 spacing of the plain
    version's; ptxas' registers and spills of ``rmsnorm_kernel``; times
    of the kernel (with its plan, ``ops.norm_plan``), the plain version
    and ``F.rms_norm`` (timed only) at the main paths' rows (D=1536 too,
    qwen2-vl-2b's width, R 1 and 2048); at D=2560
    also the profiler's device time per call and the time per call back
    to back with L2 cold (129 decode rows, or 8 prompts of 2048 rows).
5b. RMSNorm's backward kernel (run after phase 6) against its plain
    version (``rmsnorm_bwd_ref``), bf16 and f32, D in {1536, 2048, 2560,
    3584, 4096, 5120} x R in {1, 7, 2048, 4096}, with and without w: dx
    within one bf16 spacing of the plain version's plus 1e-5 x max|dx|
    (f32: 1e-5 x max|dx|), dw within one bf16 spacing plus 1e-3 x
    max|dw| (a sum over R rows in another order; f32 1e-5); two calls
    bit-equal; ptxas' registers of the backward kernel; at R=2048 and
    D 2048 (qwen2.5-3b), 3584 and 1536, with its plan (``card_bwd_plan``):
    kernel, plain and device times (by kernel) beside ``F.rms_norm``'s
    backward under autograd timed the same two ways (timed only).
 6. SSD-update kernel against its plain version with f32 and bf16
    x/B/C at the mamba2-2.7b (1,80,64,128) and zamba2-1.2b (1,64,64,64)
    decode shapes, grouped (3,8,16,32, G=2) and with dt*A near -1e4
    (exp gives 0); the in-place call (out=h) must be bit-equal to the
    out-of-place one; ptxas' registers and spills of
    ``ssd_update_kernel``; times of the kernel (with its plan,
    ``ops.ssd_plan``) and the plain version (no single PyTorch call
    computes it), the profiler's device time per call and the time per
    call back to back over 64 (mamba2) or 96 (zamba2) distinct states.
6c. the dequantisation kernel (``csrc/dequantize.cu``; port-only: the
    reference dequantises with jnp, ``src/repro/quant/quantize.py:126``)
    bit-equal to its plain version over int4 and int8 codes, bf16, f16
    and f32 out, groups 32 and 128, at a qwen2-moe-a2.7b expert stack
    (60, 2048, 1408) and a qwen2.5-7b w_gate (3584, 18944), and at N = 50
    (the scalar variant); two calls bit-equal; ptxas' registers and
    spills; times of the kernel and the plain version (no single
    PyTorch call computes it) against the bound (codes + scales + output
    bytes at 3.35 TB/s) at both shapes, int4 and int8 to bf16.
 7. the decode-attention kernel inside the real path: a qwen2.5-7b-width
    model with 2 layers in f32; greedy tokens of ``decode_backend="cuda"``
    and ``"sdpa"`` must be identical over 16 tokens.
 8. the paged kernel inside the real path: the same f32 model serves 4
    sessions through 2 paged slots (``generate_continuous``, chunked
    prefill); each session's greedy tokens on the "cuda" route must equal
    those on the "sdpa" gather route and its own batch-1
    ``generate_streamed`` tokens.
 9. kernels 4 and 5 (and 1) inside the real path, card against CPU: a
    mamba2-2.7b-width model with 2 layers and a zamba2-1.2b-width model
    with 4, f32, weights drawn once on the CPU and copied to the card;
    16 greedy tokens must be identical and the first-step logits agree
    within 1e-4 x max|logit|.
9b. the host KV tier inside the real path: a qwen2.5-7b-width model
    with 2 layers in f32 serves 6 sessions through 2 paged slots
    (chunked prefill) at full backing and on a pool cut to 13 pages:
    without a tier (re-prefill), and with ``kv_tier="host"`` under
    prefer-device, spill and lookahead, plus int8 KV at K=4 with spill
    against its own full-backing run; every greedy stream equals the
    full-backing run's, spill and lookahead spill and restore pages, and
    both pools balance after ``flush_prefix_cache()`` and ``flush_host()``.
    Then a seeded fault plan over every fault kind (what ``serve
    --fault-plan mixed`` builds) through the spill arm with retry budget
    2 and the self-audit: sessions that end ok keep their streams, the
    others a prefix of it, every token lies in the vocabulary, the pools
    balance; the counters the plan fired are logged.
9c. the moe, vlm and audio families inside the real path, card against
    CPU: qwen2-moe-a2.7b (all 60 experts), qwen2-vl-2b and musicgen-large
    at full width with 2 layers, f32, weights drawn once on the CPU and
    copied to the card; prompts of 64 tokens (vlm: bf16 embeddings with
    t/h/w positions that differ; audio: 4 codebooks); 16 greedy tokens
    must be identical and the first-step logits agree within 1e-4 x
    max|logit|.
10. the batch-1 main path at full width: qwen2.5-7b, 28 layers, bf16,
    random weights drawn on the card; ``DecodeEngine`` serves the step
    as one captured CUDA graph: one warm-up request of each loop at the
    timed shape (captures), then three requests of 2048 prompt tokens
    (two ``generate_streamed``, one ``generate_fused``, 32 new tokens
    each); the kernels launched on the card (the wrappers' counts minus
    what captures recorded plus what replays launched) must be 28
    decode attentions x decode steps and 57 RMSNorms x (decode steps +
    prefills); first-step logits of "cuda" and "sdpa" must agree; p50
    step time of the graph step and, beside it, the eager p50
    (``measure_cell`` of plain ``decode_step`` calls, one session),
    both against the analytic floor; wall of a 2048-token prefill
    (synchronised, median of 3); a plain step under torch.profiler must
    show 28 ``decode_attention_mma`` kernels and no
    ``decode_attention_merge``.
11. the int4 main path: the same model quantised on the card
    (``int4_fused``), one request through the engine's graph step; the
    int4 launch count must be 7 x 28 per decode step plus the prefill's;
    graph and eager p50; wall of a 2048-token prefill (median of 3),
    which must launch the int4 kernel 7 x 28 times; the step's device
    time under torch.profiler (as in phase 10), which must show 7 x 28
    GEMV kernels per step and no split-K reduce kernel.
10c. stochastic sampling inside the captured graphs (temperature 0.8,
    top_k 50) at qwen2.5-7b full width (28 layers, bf16, random weights
    drawn on the card), prompt 2048, 32 new tokens.  (A) the engine's
    fused loop: three calls (seed 11 captured, 11 replayed, 12 replayed)
    each bit-equal to uncaptured ``decode_steps`` from that seed (a
    prefill, the first draw, the N-1 steps, one generator), the two
    seeds' streams different, kernels 1 and 5 launched by the replays
    28 and 57 times a step.  (B) the same on ``int4_fused``, kernel 3
    196 times a step in the replays.  For both: the fused loop's ms a
    token and the streamed loop's p50 step, greedy and stochastic, and
    the stochastic tok/s of each loop; the sampling ops of a step
    (``sample`` on a (1, V) logits row) by kernel name, profiler device
    µs.  (C) phase 12's 8 sessions through 4 paged slots (bf16 KV) at
    K=4 captured and uncaptured from one seed: equal event logs and
    generator states; then K=1; every session ends with its budget, the
    pools balance, kernel 2 runs 28 times a device step in the replays;
    tok/s at K=4 and K=1.  Its numbers go on a ``{"sampling": ...}``
    line.
12. the paged serving path at full width: qwen2.5-7b, 28 layers, bf16,
    8 sessions (prompts 2048+, 32+ new tokens) through 4 paged slots,
    page 16, prefill chunk 512, through ``generate_continuous`` twice:
    bf16 KV at full backing with K=1, and int8 KV on an oversubscribed
    pool (at least one preemption) with K=4.  Every session must end
    with its full budget, the decode step must be captured once per
    (route, K), its replays must launch the paged kernel 28 times and
    the RMSNorm kernel 57 times per device step (the capture's launches
    times the replays; the profiler must see the same in a steady
    window: 28 ``paged_attention_mma`` kernels per device step and no
    ``paged_merge``), and first-step logits of "cuda" and "sdpa" must agree;
    p50 decode time per token, aggregate tok/s and the device-busy share.
13. mamba2-2.7b at full width and depth (64 layers, bf16, random weights
    drawn on the card): the requests of phase 10 through the engine's
    graph step; launches on the card must be 64 SSD updates per decode
    step and 129 RMSNorms per decode step and prefill; streamed and
    fused tokens identical; the first-step logits must agree within
    5e-2 x max|logit| with one decode step of the same weights and
    prefilled state copied to the CPU (plain versions); graph and eager
    p50 against the floor, device time per step.
14. zamba2-1.2b at full width and depth (38 Mamba2 layers, 7 applications
    of the shared attention block): the same, with 38 SSD updates, 7
    decode attentions and 91 RMSNorms per decode step; the profiled step
    must show 7 ``decode_attention_mma`` kernels and no merge.
15. the dispatch A/B (the paper's CUDA-Graphs experiment) at qwen2.5-7b
    full width, bf16, batch 1, ctx 2048: ``Model.step_program``'s
    executors under ``core/protocol.py``'s ``run_ab`` (5 warm-up and 30
    measured steps, p50 per arm, paired speedups with a bootstrap 95%
    CI), eager against full_jit and stage_jit against full_jit over 3
    fresh sessions each (a session: its own cache prefilled from its
    seed, weights shared; ``pos`` put back to 2048 before each arm);
    R_floor per arm; the three arms' greedy tokens over 16 steps must be
    identical and their first-step logits agree within 2e-2 x max|logit|
    (whether they are bit-equal is logged); one profiled step per arm:
    kernels, summed kernel time, span from the first kernel's start to
    the last one's end, and the in-step device us per call of kernels 1
    and 5.
    Its numbers go on a ``{"dispatch_ab": ...}`` line.
16. the host-DRAM KV tier at full width: qwen2.5-7b, 28 layers, bf16,
    the 8 sessions of phase 12 through 4 paged slots on a pool of 340
    pages (about 2.5 sessions), ``kv_tier="host"``: first the control arm
    (prefer-device: nothing parks, preempted sessions re-prefill; bf16
    KV, K=1), then the spill policy with bf16 KV at K=1 and int8 KV at
    K=4: every session ends with
    its budget; at least 3 parks and 3 parked restores; the first
    restored session's pages ``torch.equal`` to a device copy of them
    taken at park; kernels 2 and 5 counted in the captured step as in
    phase 12; p50 per token, tok/s and the device's busy share (a
    profiled rerun); each park's and restore's device ms (CUDA events),
    the checksums' host ms and the virtual charge beside them; both pools
    balance.  Then ``save_kv_blobs`` / ``restore_kv_blobs`` of 128 pages
    (one 2048-token session, 117,440,512 B) through a page-locked host
    pool, CUDA-event medians of 10, in GB/s against the PCIe link's bound
    (``nvidia-smi`` pcie.link.gen.max / width.max, where it reports one)
    and beside one contiguous pinned copy of the same bytes each way and
    phase 10's prefill wall; the fault plan of phase 9b at full width (accounting:
    statuses, tokens in the vocabulary, pools balance); a seeded poisson
    trace replayed through the tiered scheduler with priority preemption
    on and off, with ``slo_report``'s TTFT and per-token p50/p95/p99 and
    goodput under the SLO.  Its numbers go on a ``{"host_tier": ...}``
    line.
17. the moe, vlm and audio families at full width (bf16, random weights
    drawn on the card), through the engine's graph step with phase 10's
    requests: qwen2-moe-a2.7b (24 layers, 60 experts top-4 + shared):
    24 decode attentions and 49 RMSNorms per decode step, streamed =
    fused tokens, first-step logits cuda vs sdpa, graph and eager p50,
    R_floor against ``floor_cell`` (the active set) and the weight bytes
    ``tree_weight_traffic`` charges, device time per step, prefill wall;
    the same model under ``int4_fused`` (one request; kernel 3 7 x 24
    times and the dequantisation kernel 3 x 24 times per step; graph and
    eager p50; two eager steps profiled by kernel kind: 72 dequantisation
    kernels a step and no uint8 / int8 elementwise kernel); its paged serving (phase 12's 8 sessions through 4
    slots, bf16 KV, K=1: full budgets, one graph, 24 paged kernels per
    device step; p50 per token, tok/s); qwen2-vl-2b (28 layers, bf16
    embeddings with t/h/w positions) and musicgen-large (48 layers,
    tokens (1, 2048, 4), output (1, 32, 4)) as qwen2-moe's batch-1 cell.
    Its numbers go on a ``{"families": ...}`` line.
18. training (``repro_torch.training``).  (a) one train step at
    qwen2.5-3b width, 2 layers, f32, weights drawn on the CPU and copied
    over: the card's loss and grads (remat blocks; kernel 5 forward 4 a
    layer + 1, its backward 2 a layer + 1) against the CPU's, every leaf
    within 1e-4 x max|g|, the norm weights' grads nonzero.  (b) the
    reduced config through ``run_training`` with the captured step, a
    ``Preemption`` at step 3: the restarted run's final loss bit-equal to
    a clean run's (checkpoints under ``build/``, removed).  (c) full
    width: qwen2.5-3b, 36 layers, bf16, batch 1, seq 2048, remat blocks,
    AdamW: 3 warm-up and 10 timed eager steps, then the same 13 batches
    from the same initial state through ``jit_train_step`` (one CUDA
    graph a step); step p50 and spread per arm, tokens/s, MFU (6 N T /
    step / 989e12), peak allocated memory, both arms' losses (finite and
    equal step for step), kernel launches a step, the profiler's top
    device ops of one eager step (and kernel 5's backward's launches and
    device us in it) and the graph's busy share.  Its
    numbers go on a ``{"training": ...}`` line.
19. the multi-device runtime (``launch/mesh``, ``sharding``, ``hints``)
    on a world-1 NCCL group started on an in-process ``HashStore`` (no
    environment, no port, no subprocess; destroyed when the phase ends)
    and a 1x1 ``(data, model)`` mesh.  (a) the five kernel wrappers (and
    RMSNorm's backward under grad) on DTensors at main-path shapes, with
    the placements the plan gives their inputs and with a reduced dim
    split: each output ``torch.equal`` to the plain call's and a DTensor
    with the wrapper rule's placements (dw ``Partial`` over the mesh dim
    that splits the rows).  (b) a 2-layer qwen2.5-7b-width bf16 decode
    step on DTensors, the B=1 cache planned by ``cache_shardings`` (the
    sequence over data and model): logits and cache ``torch.equal`` to
    the plain step's, kernel 1 twice a step (wrapper count and
    profiler).  (c) qwen2.5-3b at full width and depth, bf16, batch 1,
    seq 2048, remat blocks, 3 + 5 uncaptured steps, plain and then on
    the plan's DTensors under ``activation_hints`` (each arm's state
    freed before the next): losses equal step for step (tolerance 0),
    each arm's step p50 (min, max), MFU, peak allocated memory and
    launches a step.  (d) ``launch.train.main`` in-process with and
    without ``--distributed`` (qwen2.5-3b reduced, 20 steps): equal loss
    lines.  Its numbers go on a ``{"distributed": ...}`` line.
20. the analysis and the dry run (``repro_torch.analysis``,
    ``launch/dryrun.py``).  (a) ``python -m repro_torch.launch.dryrun``
    in a subprocess of its own (a fake world of 256 / 512 ranks is
    process-global; phase 19's group is gone by then) on four full-width
    cells: qwen2.5-3b ``train_4k`` on ``pod``, qwen2.5-3b ``decode_32k``
    on ``multipod``, llama4-scout-17b-a16e ``decode_32k`` on ``pod`` (the
    int4_fused weights), mamba2-2.7b ``long_500k`` on ``pod`` and
    llama4-scout-17b-a16e ``train_4k`` on ``pod`` (the moe's token
    reshapes on an FSDP data split; about 110 s of trace), into
    ``build/dryrun/``; each must end ``ok`` (a failed cell's traceback is
    printed); each cell's trace seconds, collective counts by kind, wire
    bytes and argument bytes a rank, FLOPs a rank.  (b) the one-card
    roofline: ``analytic.estimate`` (n_chips 1, tp 1, dp 1, no
    collectives) through the copied ``roofline.build_row`` with
    ``analysis.links.h100_chip()`` for qwen2.5-7b decode (batch 1, ctx
    2048) and qwen2.5-3b training (batch 1, seq 2048), each floor beside
    phase 10's graph p50 and 18c's graph step p50 of the same run (their
    ratio), and the estimate's optimizer bytes as a time at 3.35 TB/s
    beside 18c's AdamW ms; the rows alone when phases 10 and 18c did not
    run.  Its numbers go on an ``{"analysis": ...}`` line.
21. the examples (``examples/torch``).  (a) each of ``quickstart.py``,
    ``serve_stream.py``, ``train_dense.py`` and ``quant_ablation.py`` as
    a user runs it (on the card, its defaults), in a subprocess: exit 0
    and ``OK`` last.  (b) ``quant_ablation.ablation`` at qwen2.5-7b full
    width (28 layers, bf16 random weights drawn on the card), prompt
    2048, 32 new tokens, one weight path at a time with the counts at 0
    just before it: the dequantisation kernel 7 x 28 times a step on
    int8_dequant, int8_fused and int4_dequant, kernel 3 on int4_fused,
    neither on bf16; per path the charged GB a step
    (``tree_weight_traffic``), the H100 floor, the graph p50 and the
    realised rate (charged bytes over p50), which must not pass 3.35
    TB/s.  Its numbers go on an ``{"examples": ...}`` line.
22. the kernels line: one JSON object with every ported kernel's
    numbers (all five, kernel 5's backward and the dequantisation
    kernel, both port-only: no TPU kernel is left to port; ``device_us`` and
    ``b2b_us`` for kernels 4 and 5, null for the others); ``launches`` sums
    the main paths that run the kernel and ``launches_by_path`` names
    each path's count (the tiered cells of phase 16 included); the int4
    row adds the M=2048 sums (``prefill_*``) and the prefill's launches
    and walls.  ``rmsnorm_bwd`` (the backward, port-only) counts phase
    18c's and 19c's launches; 19b and 19c's DTensor arm are paths of
    their own in ``launches_by_path``, as are phase 10c's sampled paths.  ``dequantize`` counts phase 17's
    int4 moe cell and phase 21's three dequantising 7b paths (whose
    int4_fused path adds to kernel 3's row).
23. last line: ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --only kernels

runs phases 1-6 (and 5b, 6c) only and prints the kernels line (launches null) without
the ``ok`` line: the quick call for tuning a kernel.  ``--only families``
runs phases 1, 9c and 17 only, ``--only train`` phases 1, 5b and 18,
``--only dist`` phases 1 and 19, ``--only analysis`` phases 1 and 20,
``--only examples`` phases 1 and 21, ``--only sampling`` phases 1 and
10c (no kernels line, no ``ok`` line).
Every phase prints its name on a line of its own before it starts.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Times are CUDA-event medians of 30 runs
after 5 warm-ups, with L2 flushed before each run; bounds use the
H100 SXM peaks (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s f32 off the
tensor cores).
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
WARMUP, ITERS = 5, 30
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # relative to max(1, |plain|)

PROMPT, NEW = 2048, 32


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing
class Timer:
    """CUDA-event median of ITERS runs after WARMUP, L2 flushed first.

    Before each timed run the card is kept busy (flush + spin) while the
    host enqueues the run, so host-side launch work does not show up as
    device time."""

    def __init__(self, device):
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self, fn) -> float:
        for _ in range(WARMUP):
            fn()
        events = []
        for _ in range(ITERS):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def device_us(self, fn, iters=20) -> float:
        """torch.profiler device time per call (us) of the kernels ``fn``
        launches, L2 flushed before each call (the flush left out), over
        the calls the profiler recorded: the kernels alone, without the
        launch and the timer's own cost."""
        return sum(self.device_split_us(fn, iters).values()) or float("nan")

    def device_split_us(self, fn, iters=20, once=None) -> dict:
        """As ``device_us``, by kernel: {kernel name: device us per call}.
        The calls recorded are counted by the kernel launched most often,
        or with ``once`` by the kernel whose name holds it (one launch a
        call, where ``fn`` launches some kernels more than once)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if e.self_device_time_total > 0
                and "fill" not in e.key.lower() and "memset" not in e.key.lower()]
        calls = max((e.count for e in seen if once is None or once in e.key),
                    default=0)                            # the calls it recorded
        return {e.key: e.self_device_time_total / calls for e in seen} if calls else {}

    def back_to_back_us(self, calls, reps=7) -> float:
        """us per call of ``calls`` (on distinct data) enqueued behind one
        spin between one event pair, L2 flushed first: the card runs them
        back to back, each finding its data cold, as a step meets them."""
        for c in calls:
            c()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(20_000_000)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            for c in calls:
                c()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events) / len(calls) * 1e3


def bound_ms(nbytes: float, flops: float, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(out, ref) -> tuple:
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    return err, err / scale


# ---------------------------------------------------------------- phase 1
def setup():
    from repro_torch.kernels import _build
    log("== phase 1: setup (the card, versions, the kernels' build)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s wall: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "wgmma" in line or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                log(f"  ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, dev


# ---------------------------------------------------------------- phase 2
def attention_case(dev, dtype, B, Hq, Hkv, hd, S, mask, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = 2 * torch.randn((B, Hq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=g, device=dev).to(dtype)
    return q, k, v, mask.to(dev)


def check_decode_attention(dev, timer):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops, ref
    log("== phase 2: decode attention, kernel vs plain")
    log_kernel_build("decode_attention", "decode_attention_mma")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("  decode_attention_mma blocks per SM (hd 32, 64, 128) "
        f"{[ops._lib().decode_attention_mma_blocks_per_sm(hd) for hd in (32, 64, 128)]}")
    S_main = PROMPT + NEW + 1
    gm = torch.Generator().manual_seed(0)
    ragged = torch.rand((2, 2048), generator=gm) < 0.6
    ragged[1] = False
    holes = torch.rand((2, S_main), generator=gm) < 0.3
    holes[0, 300:1500] = False
    cases = [
        ("qwen2.5-7b S=2048", 1, 28, 4, 128, 2048, torch.ones(2048, dtype=torch.bool)),
        ("S=2047 ragged", 1, 28, 4, 128, 2047, torch.ones(2047, dtype=torch.bool)),
        ("(B,S) mask, row 1 fully masked", 2, 28, 4, 128, 2048, ragged),
        ("G=1 (MHA)", 1, 32, 32, 64, 1024, torch.arange(1024) < 700),
        ("G=4 (Hq=32, Hkv=8: llama-3.1-8b / mistral-7b)", 1, 32, 8, 128, 2048,
         torch.ones(2048, dtype=torch.bool)),
        ("G=8 (Hq=16, Hkv=2: qwen2.5-3b)", 1, 16, 2, 128, 2048,
         torch.arange(2048) < 1500),
        ("B=3", 3, 28, 4, 128, 1000,
         torch.arange(1000)[None, :] < torch.tensor([[1000], [517], [1]])),
        ("sparse mask, 1200 masked slots in a run (empty splits), G=16 hd 32", 2, 32, 2,
         32, S_main, holes),
        ("zamba2-1.2b shared block and musicgen-large: S=2081, first decode step",
         1, 32, 32, 64, S_main, torch.arange(S_main) <= PROMPT),
        ("qwen2-moe-a2.7b (Hq=Hkv=16): S=2081, first decode step", 1, 16, 16, 128,
         S_main, torch.arange(S_main) <= PROMPT),
        ("qwen2-vl-2b (G=6): S=2081, first decode step", 1, 12, 2, 128, S_main,
         torch.arange(S_main) <= PROMPT),
        ("main path: S=2081, first decode step", 1, 28, 4, 128, S_main,
         torch.arange(S_main) <= PROMPT),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for i, (label, B, Hq, Hkv, hd, S, mask) in enumerate(cases):
            q, k, v, m = attention_case(dev, dtype, B, Hq, Hkv, hd, S, mask, i)
            path = ops.path_for(q, k)
            out = ops.decode_attention(q, k, v, m)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, m)
            err, rel = rel_err(out, want)
            ok = rel <= TOL[dtype] and path == ("mma" if dtype == torch.bfloat16
                                                else "cuda_core")
            if mask.dim() == 2:
                dead = ~mask.any(dim=1)
                ok = ok and bool(out[dead.to(dev)].eq(0).all())
            repeat = torch.equal(ops.decode_attention(q, k, v, m), out)
            # NaN in every masked slot's K/V row: never read, so the output
            # stays bit-equal and within tolerance of the plain version on
            # the clean cache
            masked = ~m.reshape(-1, S).expand(B, S)
            k[masked], v[masked] = float("nan"), float("nan")
            poisoned = ops.decode_attention(q, k, v, m)
            torch.cuda.synchronize()
            nan_ok = torch.equal(poisoned, out) and rel_err(poisoned, want)[1] <= TOL[dtype]
            ok = ok and repeat and nan_ok
            log(f"  {str(dtype)[6:]:8s} {label} ({path} path): B={B} Hq={Hq} Hkv={Hkv} "
                f"hd={hd} S={S}: max_abs_err {err:.3g} (tol {TOL[dtype]:g} x "
                f"max(1,|plain|)), two calls bit-equal {repeat}, NaN in the "
                f"{int(masked.sum())} masked rows: bit-equal and within tol of the "
                f"plain version on the clean cache {nan_ok}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"decode_attention {label} {dtype} disagrees")
            del q, k, v, m

    # times at the main paths' shapes (bf16, first decode step)
    at = {}
    for label, B, Hq, Hkv, hd, S, mask in cases[-4:]:
        q, k, v, m = attention_case(dev, torch.bfloat16, B, Hq, Hkv, hd, S, mask, 99)
        out = ops.decode_attention(q, k, v, m)
        err, _ = rel_err(out, ref.decode_attention_ref(q, k, v, m))
        ms = timer(lambda: ops.decode_attention(q, k, v, m))
        plain_ms = timer(lambda: ref.decode_attention_ref(q, k, v, m))
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        am = m.reshape(1, 1, 1, S)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=am, enable_gqa=True))
        n_valid = int(m.sum()) * B
        nbytes = (q.numel() * 2 + 2 * n_valid * Hkv * hd * 2 + m.numel()
                  + out.numel() * 2)
        flops = 4 * B * Hq * (n_valid // B) * hd
        b_ms, b_by = bound_ms(nbytes, flops, torch.bfloat16)
        n_split = ops.mma_split_plan(B, Hkv, S, sms)
        log(f"  times at {label} (bf16, {n_valid} valid slots, {n_split} splits, "
            f"{ops.path_for(q, k)} path): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.scaled_dot_product_attention {lib_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}: {nbytes / 1e6:.3f} MB)")
        at[Hkv] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, n_split=n_split,
                       shape=f"bf16 B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S}, "
                             f"{n_valid} valid")
        del q, k, v, m
    main = at[4]
    extra = {f"{arch}_{k}": v for arch, hkv in (("zamba2", 32), ("qwen2_moe", 16),
                                                ("qwen2_vl", 2))
             for k, v in at[hkv].items()}
    return dict(name="decode_attention", route="cuda", path="mma",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention/decode_attention.py:64",
                **main, **extra)


# ---------------------------------------------------------------- phase 3
LAYER = [("wq", 3584, 3584), ("wk", 3584, 512), ("wv", 3584, 512),
         ("wo", 3584, 3584), ("gate", 3584, 18944), ("up", 3584, 18944),
         ("down", 18944, 3584)]


def int4_case(dev, dtype, M, K, N, seed, group=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    packed = torch.randint(0, 256, (K // 2, N), generator=g, device=dev,
                           dtype=torch.uint8)   # every nibble, -8..7
    scales = 0.005 + 0.01 * torch.rand((K // group, N), generator=g, device=dev)
    return x, packed, scales


def hgmma_count() -> int:
    """HGMMA (wgmma) instructions in the built int4_matmul library's SASS."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(_build._lib_path("int4_matmul"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def check_int4_matmul(dev, timer):
    from repro_torch.kernels.int4_matmul import ops, ref
    from repro_torch.quant import QuantizedTensor, dequantize
    log("== phase 3: int4 matmul, kernel vs plain (qwen2.5-7b layer shapes)")
    n_hgmma = hgmma_count()
    log(f"  HGMMA instructions in the built int4_matmul library: {n_hgmma}")
    if n_hgmma == 0:
        raise AssertionError("the int4_matmul library has no wgmma (HGMMA) code")
    codes = ref.unpack_int4_ref(int4_case(dev, torch.bfloat16, 1, 256, 64, 0)[1])
    if int(codes.min()) != -8 or int(codes.max()) != 7:
        raise AssertionError("test codes do not reach -8 and 7")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    totals = {M: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      read_ms=0.0, err=0.0)
              for M in (1, 4, 512, 2048)}
    shapes = {}
    for M in totals:
        gemv = M <= ops.GEMV_MAX_M
        for dtype in ((torch.bfloat16, torch.float32) if gemv else (torch.bfloat16,)):
            for i, (name, K, N) in enumerate(LAYER):
                x, packed, scales = int4_case(dev, dtype, M, K, N, 10 * M + i)
                before = ops.launches
                out = ops.int4_matmul(x, packed, scales, group=128)
                torch.cuda.synchronize()
                want = ref.int4_matmul_ref(x, packed, scales, 128)
                err, rel = rel_err(out, want)
                ok = rel <= TOL[dtype] and ops.launches == before + 1
                plan = ""
                if gemv:
                    plan = f", {ops.split_plan(K, N, n_sm, M)} K slices"
                    again = ops.int4_matmul(x, packed, scales, group=128)
                    torch.cuda.synchronize()
                    ok = ok and torch.equal(again, out)
                line = (f"  {str(dtype)[6:]:8s} {name:4s} M={M} K={K} N={N} "
                        f"({ops.path_for(M, dtype)}{plan}): max_abs_err {err:.3g} (tol "
                        f"{TOL[dtype]:g} x max(1,|plain|)"
                        f"{', repeat bit-equal' if gemv else ''}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    log(line)
                    raise AssertionError(f"int4_matmul {name} M={M} {dtype} disagrees")
                if dtype != torch.bfloat16:
                    log(line)
                    continue
                w = dequantize(QuantizedTensor(packed, scales, 4, "fused"),
                               torch.bfloat16)
                ms = timer(lambda: ops.int4_matmul(x, packed, scales, group=128))
                plain_ms = timer(lambda: ref.int4_matmul_ref(x, packed, scales, 128))
                lib_ms = timer(lambda: torch.matmul(x, w))
                nbytes = x.numel() * 2 + packed.numel() + scales.numel() * 4 + M * N * 2
                b_ms, b_by = bound_ms(nbytes, 2 * M * K * N, torch.bfloat16)
                extra = ""
                t = totals[M]
                if gemv:
                    # the same weight and scale bytes in one buffer, read by
                    # one PyTorch call: the rate this card reaches on them
                    # (viewed as f32; an int32 sum into int64 ran 3x slower)
                    buf = torch.empty(packed.numel() + scales.numel() * 4,
                                      dtype=torch.uint8, device=dev).view(torch.float32)
                    read = timer(lambda: torch.sum(buf))
                    t["read_ms"] += read
                    extra = f", read of its bytes (torch.sum) {read:.4f} ms"
                    shapes.setdefault(name, {})[f"m{M}_ms"] = ms
                    shapes[name]["read_ms"] = read
                    shapes[name][f"m{M}_bound_ms"] = b_ms
                    del buf
                log(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"torch.matmul(bf16 dequantised) {lib_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}){extra}")
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("bound_ms", b_ms)):
                    t[key] += val
                t["err"] = max(t["err"], err)
                del w
        t = totals[M]
        log(f"  one layer's 7 int4 matmuls at M={M} (bf16, {ops.path_for(M, torch.bfloat16)}): "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.matmul "
            f"{t['library_ms']:.4f} ms ({t['ms'] / t['library_ms']:.2f}x), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%})"
            + (f", read of the same bytes {t['read_ms']:.4f} ms" if gemv else ""))
    layer, host_us = gemv_layer(dev, timer, ops)
    moe = moe_gemv_layer(dev, timer, ops, ref)
    dec, m4, pre = totals[1], totals[4], totals[2048]
    return dict(name="int4_matmul", route="cuda",
                source="src/repro_torch/csrc/int4_matmul.cu",
                replaces="src/repro/kernels/int4_matmul/int4_matmul.py:53",
                max_abs_err=max(t["err"] for t in totals.values()), ms=dec["ms"],
                plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
                bound_by="bytes", library_ms=dec["library_ms"],
                read_ms=dec["read_ms"], gemv_layer_ms=layer[1],
                gemv_m4_ms=m4["ms"], gemv_m4_plain_ms=m4["plain_ms"],
                gemv_m4_bound_ms=m4["bound_ms"], gemv_m4_library_ms=m4["library_ms"],
                gemv_layer_m4_ms=layer[4], gemv_host_us=host_us,
                gemv_shapes=shapes,
                prefill_ms=pre["ms"], prefill_plain_ms=pre["plain_ms"],
                prefill_bound_ms=pre["bound_ms"], prefill_bound_by="operations",
                prefill_library_ms=pre["library_ms"],
                prefill_m512_ms=totals[512]["ms"], **moe,
                shape="sum of the 7 qwen2.5-7b layer matmuls at M=1, bf16 (the "
                      "GEMV); gemv_m4_*: the same at M=4; gemv_layer_ms: the 7 "
                      "back to back, L2 flushed once; read_ms: torch.sum over "
                      "the same packed and scale bytes; prefill_*: M=2048 "
                      "(wgmma path); qwen2_moe_*: the 7 int4 matmuls of a "
                      "qwen2-moe-a2.7b layer (attention and shared experts) at M=1")


MOE_LAYER = [("wq", 2048, 2048), ("wk", 2048, 2048), ("wv", 2048, 2048),
             ("wo", 2048, 2048), ("shared gate", 2048, 5632),
             ("shared up", 2048, 5632), ("shared down", 5632, 2048)]


def moe_gemv_layer(dev, timer, ops, ref):
    """The GEMV at the 2-D int4 shapes of a qwen2-moe-a2.7b layer (its
    attention and shared experts; the expert stacks are dequantised as
    in the reference), M=1, bf16 and f32 against the plain version, two
    calls bit-equal; bf16 times summed over the layer."""
    from repro_torch.quant import QuantizedTensor, dequantize
    t = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, K, N) in enumerate(MOE_LAYER):
            x, packed, scales = int4_case(dev, dtype, 1, K, N, 700 + i)
            before = ops.launches
            out = ops.int4_matmul(x, packed, scales, group=128)
            again = ops.int4_matmul(x, packed, scales, group=128)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref.int4_matmul_ref(x, packed, scales, 128))
            ok = (rel <= TOL[dtype] and ops.launches == before + 2
                  and torch.equal(again, out) and ops.path_for(1, dtype) == "gemv")
            line = (f"  {str(dtype)[6:]:8s} qwen2-moe {name} M=1 K={K} N={N} "
                    f"(gemv): max_abs_err {err:.3g}, repeat bit-equal "
                    f"{'ok' if ok else 'FAIL'}")
            if not ok:
                log(line)
                raise AssertionError(f"int4_matmul qwen2-moe {name} {dtype} disagrees")
            t["err"] = max(t["err"], err)
            if dtype != torch.bfloat16:
                log(line)
                continue
            w = dequantize(QuantizedTensor(packed, scales, 4, "fused"), torch.bfloat16)
            ms = timer(lambda: ops.int4_matmul(x, packed, scales, group=128))
            plain_ms = timer(lambda: ref.int4_matmul_ref(x, packed, scales, 128))
            lib_ms = timer(lambda: torch.matmul(x, w))
            nbytes = x.numel() * 2 + packed.numel() + scales.numel() * 4 + N * 2
            b_ms, _ = bound_ms(nbytes, 2 * K * N, torch.bfloat16)
            log(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.matmul(bf16 dequantised) {lib_ms:.4f} ms, bound {b_ms:.4f} ms")
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bound_ms", b_ms)):
                t[key] += val
            del w
    log(f"  one qwen2-moe layer's 7 int4 GEMVs at M=1 (bf16): kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, torch.matmul {t['library_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%})")
    return {f"qwen2_moe_{k}": v for k, v in t.items()}


def gemv_layer(dev, timer, ops):
    """The seven GEMVs of a layer back to back between one event pair, L2
    flushed once before (as a decode step meets them), at M=1 and M=4;
    and the wrapper's host time per call: 28 layers' 196 calls between
    host clocks, not synchronised."""
    layer = {}
    for M in (1, 4):
        cases = [int4_case(dev, torch.bfloat16, M, K, N, 10 * M + i)
                 for i, (_, K, N) in enumerate(LAYER)]

        def seven():
            for x, packed, scales in cases:
                ops.int4_matmul(x, packed, scales, group=128)
        layer[M] = timer(seven)
        log(f"  the layer's 7 GEMVs back to back at M={M} (one event pair, L2 "
            f"flushed once): {layer[M]:.4f} ms")
        if M == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(28):
                seven()
            host_us = (time.perf_counter() - t0) / 196 * 1e6
            torch.cuda.synchronize()
            log(f"  wrapper host time per call (196 calls, not synchronised): "
                f"{host_us:.2f} us")
        del cases
    return layer, host_us


def log_kernel_build(source, kernel):
    """ptxas' registers, shared memory and spills of each instance of
    ``kernel`` in ``source``'s build log."""
    from repro_torch.kernels import _build
    entry = None
    for line in _build.build_log.get(source, "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if kernel in line else None
        elif entry and ("registers" in line or "spill" in line):
            log(f"  ptxas {kernel} {entry[:60]}: {line.split(':', 1)[-1].strip()}")


# ---------------------------------------------------------------- phase 4
PAGE = 16
PAGED_LENGTHS = (2100, 2081, 2117, 2064)     # live tokens per slot
PAGED_SPAN = 2176                            # 136 pages of 16: max_len of phase 9


def paged_case(dev, dtype, quant, lengths, page, span, seed, Hq=28, Hkv=4, hd=128):
    """q, pools (int8 codes + f32 scales from quantising normal K/V when
    ``quant``), a shuffled block table whose blocks past each length
    point at the garbage page 0, and the lengths."""
    from repro_torch.quant.kv import quantize_kv_write
    g = torch.Generator(device=dev).manual_seed(seed)
    B, max_blocks = len(lengths), -(-span // page)
    n_pages = 1 + B * max_blocks
    q = 2 * torch.randn((B, Hq, hd), generator=g, device=dev).to(dtype)
    shape = (n_pages, page, Hkv, hd)
    k = torch.randn(shape, generator=g, device=dev)
    v = torch.randn(shape, generator=g, device=dev)
    if quant:
        (k, ks), (v, vs) = quantize_kv_write(k), quantize_kv_write(v)
    else:
        k, v, ks, vs = k.to(dtype), v.to(dtype), None, None
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = torch.arange(max_blocks, device=dev)[None] * page < lens[:, None]
    bt = torch.where(live, perm.reshape(B, max_blocks), 0).to(torch.int32).contiguous()
    return q, k, v, bt, lens, ks, vs


def paged_plain(q, k, v, bt, lens, ks, vs):
    from repro_torch.kernels.paged_decode_attention import ref
    if ks is None:
        out = ref.paged_decode_attention_ref(q, k, v, bt, lens)
    else:
        out = ref.paged_decode_attention_quant_ref(q, k, v, ks, vs, bt, lens)
    return out.to(q.dtype)


def gather_sdpa(q, k, v, bt, lens, ks, vs):
    """The library yardstick: gather each slot's view through the block
    table (dequantised to q's dtype on int8) and one
    ``F.scaled_dot_product_attention`` call over it.  Timed only."""
    import torch.nn.functional as F

    from repro_torch.models.attention import paged_view
    from repro_torch.quant.kv import dequantize_kv
    kv, vv = paged_view(k, bt), paged_view(v, bt)
    if ks is not None:
        kv = dequantize_kv(kv, paged_view(ks, bt), q.dtype)
        vv = dequantize_kv(vv, paged_view(vs, bt), q.dtype)
    S = kv.shape[1]
    mask = (torch.arange(S, device=q.device)[None] < lens[:, None])[:, None, None]
    return F.scaled_dot_product_attention(q[:, :, None], kv.transpose(1, 2),
                                          vv.transpose(1, 2), attn_mask=mask,
                                          enable_gqa=True)


def check_paged_decode_attention(dev, timer):
    from repro_torch.kernels.paged_decode_attention import ops
    log("== phase 4: paged decode attention, kernel vs plain")
    cases = [("serving shape", PAGED_LENGTHS, PAGE, PAGED_SPAN),
             ("ragged, length-0 lane, page 4", (1000, 0, 517, 1), 4, 1024),
             ("ragged, length-0 lane, page 8", (0, 777, 8, 1023), 8, 1024),
             ("ragged, length-0 lane, page 32", (300, 33, 0, 2047), 32, 2048)]
    variants = [("bf16", torch.bfloat16, False), ("f32", torch.float32, False),
                ("int8 KV", torch.bfloat16, True)]
    log_kernel_build("paged_decode_attention", "paged_attention_mma")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("  paged_attention_mma at hd 128: blocks per SM (bf16, int8 KV) "
        f"{[ops._lib().paged_decode_attention_mma_blocks_per_sm(128, q) for q in (0, 1)]}"
        f"; splits per (slot, KV head) at the serving shape (bf16, int8 KV) "
        f"{[ops.mma_split_plan(4, 4, PAGED_SPAN, sms, q) for q in (False, True)]}")
    for name, dtype, quant in variants:
        for i, (label, lengths, page, span) in enumerate(cases):
            args = paged_case(dev, dtype, quant, lengths, page, span, seed=i)
            out = ops.paged_decode_attention(*args)
            torch.cuda.synchronize()
            err, rel = rel_err(out, paged_plain(*args))
            repeat = torch.equal(ops.paged_decode_attention(*args), out)
            zeros = all(bool(out[b].eq(0).all())
                        for b, n in enumerate(lengths) if n == 0)
            k, v, ks, vs = args[1], args[2], args[5], args[6]
            k[0], v[0] = (100, -100) if quant else (1e9, -1e9)
            if quant:
                ks[0], vs[0] = 1e9, 1e9
            poisoned = ops.paged_decode_attention(*args)
            torch.cuda.synchronize()
            same = torch.equal(poisoned, out)
            ok = rel <= TOL[dtype] and zeros and same and repeat
            log(f"  {name:8s} {label} ({ops.path_for(args[0], args[1])} path): "
                f"lengths {lengths}: max_abs_err {err:.3g} "
                f"(tol {TOL[dtype]:g} x max(1,|plain|)), length-0 lanes zero "
                f"{zeros}, two calls bit-equal {repeat}, poisoned page 0 "
                f"bit-equal {same}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged_decode_attention {name} {label} "
                                     "disagrees")

    rows = []
    for name, quant in (("paged_decode_attention", False),
                        ("paged_decode_attention_int8", True)):
        args = paged_case(dev, torch.bfloat16, quant, PAGED_LENGTHS, PAGE,
                          PAGED_SPAN, seed=99)
        q = args[0]
        out = ops.paged_decode_attention(*args)
        err, _ = rel_err(out, paged_plain(*args))
        ms = timer(lambda: ops.paged_decode_attention(*args))
        plain_ms = timer(lambda: paged_plain(*args))
        lib_ms = timer(lambda: gather_sdpa(*args))
        # the kernel reads each live token's K/V (codes and scales) once,
        # the block-table entries of the live pages and the lengths; q in,
        # out out
        live_pages = sum(-(-n // PAGE) for n in PAGED_LENGTHS)
        tok_bytes = ops.kv_token_bytes(4, 128, 2, "int8" if quant else "none")
        nbytes = (sum(PAGED_LENGTHS) * tok_bytes + 4 * live_pages
                  + 4 * len(PAGED_LENGTHS) + q.numel() * 2 + out.numel() * 2)
        flops = 4 * 28 * 128 * sum(PAGED_LENGTHS)
        b_ms, b_by = bound_ms(nbytes, flops, torch.bfloat16)
        kv = "int8 codes + f32 scales" if quant else "bf16"
        log(f"  times, {kv} KV, 4 slots {PAGED_LENGTHS} tokens, page {PAGE}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, gather + "
            f"F.scaled_dot_product_attention {lib_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}: {nbytes} bytes of live tokens, their "
            f"block-table entries, lengths, q and out)")
        rows.append(dict(
            name=name, route="cuda", path=ops.path_for(q, args[1]),
            source="src/repro_torch/csrc/paged_decode_attention.cu",
            replaces="src/repro/kernels/paged_decode_attention/"
                     "paged_decode_attention.py:136",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms,
            shape=f"q bf16 B=4 Hq=28 Hkv=4 hd=128, {kv} pools, page {PAGE}, "
                  f"lengths {list(PAGED_LENGTHS)}"))
        del args
    return rows


# ---------------------------------------------------------------- phase 5
# qwen2-vl d_model, zamba2 / qwen2-moe / musicgen d_model, mamba2 d_model,
# qwen2.5-7b d_model, zamba2 d_inner, mamba2 d_inner
NORM_WIDTHS = (1536, 2048, 2560, 3584, 4096, 5120)
NORM_ROWS = (1, 4, 512, 2048)   # decode row, paged step, prefill chunk, prompt


def norm_case(dev, dtype, R, D, seed, parametric=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3 * torch.randn((R, D), generator=g, device=dev)).to(dtype)
    w = ((1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(dtype)
         if parametric else None)
    return x, w


def check_rmsnorm(dev, timer):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops, ref
    log("== phase 5: RMSNorm, kernel vs plain (bf16 within one bf16 spacing "
        "of the plain version's output, element by element; f32 1e-4)")
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for D in NORM_WIDTHS:
            for R in NORM_ROWS:
                for parametric in (True, False):
                    x, w = norm_case(dev, dtype, R, D, R + D, parametric)
                    out = ops.rmsnorm(x, w)
                    torch.cuda.synchronize()
                    want = ref.rmsnorm_ref(x, w)
                    err, rel = rel_err(out, want)
                    if dtype == torch.bfloat16:
                        ok = bool(((out.float() - want.float()).abs()
                                   <= want.float().abs() * 2 ** -7).all())
                    else:
                        ok = rel <= TOL[dtype]
                    worst = max(worst, err)
                    if not ok:
                        raise AssertionError(f"rmsnorm {dtype} R={R} D={D} "
                                             f"w={parametric} disagrees ({err:.3g})")
        log(f"  {str(dtype)[6:]:8s} D in {NORM_WIDTHS} x R in {NORM_ROWS}, with "
            f"and without w: ok (largest max_abs_err so far {worst:.3g})")
    xs = 3 * torch.randn((3, 7, 3584), device=dev).to(torch.bfloat16)
    strided = xs[:, -1:]
    if not torch.equal(ops.rmsnorm(strided, None),
                       ops.rmsnorm(strided.contiguous(), None)):
        raise AssertionError("rmsnorm of a strided slice differs")
    log("  strided slice x[:, -1:] of (3, 7, 3584) read in place: ok")

    log_kernel_build("rmsnorm", "rmsnorm_kernel")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    row, vl = None, {}
    for R, D in ((1, 2560), (1, 5120), (1, 3584), (1, 1536), (2048, 2560),
                 (2048, 5120), (2048, 3584), (2048, 1536)):
        x, w = norm_case(dev, torch.bfloat16, R, D, 7 * R + D)
        out = ops.rmsnorm(x, w)
        err, _ = rel_err(out, ref.rmsnorm_ref(x, w))
        ms = timer(lambda: ops.rmsnorm(x, w))
        plain_ms = timer(lambda: ref.rmsnorm_ref(x, w))
        lib_ms = timer(lambda: F.rms_norm(x, (D,), w, eps=1e-6))
        nbytes = 2 * R * D * 2 + D * 2
        b_ms, b_by = bound_ms(nbytes, 4 * R * D, torch.float32)
        log(f"  times, bf16 R={R} D={D} ({ops.norm_plan(R, D, 2, n_sm)}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}: {nbytes} bytes)")
        if D == 1536:    # qwen2-vl-2b: decode row and prompt
            vl.update({f"qwen2_vl_r{R}_ms": ms, f"qwen2_vl_r{R}_plain_ms": plain_ms,
                       f"qwen2_vl_r{R}_library_ms": lib_ms,
                       f"qwen2_vl_r{R}_bound_ms": b_ms, f"qwen2_vl_r{R}_err": err})
        if D == 2560:
            dev_us = timer.device_us(lambda: ops.rmsnorm(x, w))
            if R == 1:   # a mamba2 step's 129 decode rows
                many = norm_case(dev, torch.bfloat16, 129, D, 5)[0]
                inputs = [many[i:i + 1] for i in range(129)]
            else:        # 8 prompts, 84 MB: past L2
                inputs = [norm_case(dev, torch.bfloat16, R, D, i)[0] for i in range(8)]
            b2b_us = timer.back_to_back_us([lambda xi=xi: ops.rmsnorm(xi, w)
                                            for xi in inputs])
            log(f"  bf16 R={R} D={D}: device {dev_us:.2f} us a call (profiler), "
                f"{b2b_us:.2f} us a call back to back over {len(inputs)} distinct "
                f"inputs, L2 cold")
            del inputs
        if (R, D) == (2048, 2560):
            row = dict(name="rmsnorm", route="cuda",
                       source="src/repro_torch/csrc/rmsnorm.cu",
                       replaces="src/repro/kernels/rmsnorm/rmsnorm.py:24",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, device_us=dev_us,
                       b2b_us=b2b_us,
                       shape="bf16 R=2048 D=2560 with w (mamba2-2.7b prefill "
                             "norm1); b2b_us over 8 distinct inputs; qwen2_vl_*: "
                             "D=1536 at R=1 and 2048")
    row.update(vl)
    return row


NORM_BWD_ROWS = (1, 7, 2048, 4096)   # a decode row, ragged, a prompt, two prompts
NORM_BWD_TIMED = (2048, 3584, 1536)  # qwen2.5-3b (the training path), qwen2.5-7b, qwen2-vl


def bwd_close(out, want, dtype, what):
    """The backward's tolerance: f32 within 1e-5 x max|plain|; bf16 (one
    rounding of an f32 result) within one bf16 spacing of the plain
    version's element, plus, for dx, 1e-5 x max|dx| where its two terms
    cancel, and, for dw (a sum over R rows in another order), 1e-3 x
    max|dw|.  Returns max_abs_err."""
    o, w_ = out.float(), want.float()
    err = (o - w_).abs()
    scale = float(w_.abs().max())
    if dtype == torch.float32:
        ok = float(err.max()) <= 1e-5 * max(scale, 1e-30)
    else:
        floor = (1e-3 if what == "dw" else 1e-5) * scale
        ok = bool((err <= w_.abs() * 2 ** -7 + floor).all())
    if not ok:
        raise AssertionError(f"rmsnorm_bwd {what} disagrees: max_abs_err "
                             f"{float(err.max()):.3g}, max|plain| {scale:.3g}")
    return float(err.max())


def check_rmsnorm_bwd(dev, timer):
    """Kernel 5's backward against ``rmsnorm_bwd_ref``; the row of the
    kernels line at R=2048 D=2048 bf16 (qwen2.5-3b's norms)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops, ref
    log("== phase 5b: RMSNorm backward, kernel vs plain (dx within one bf16 "
        "spacing + 1e-5 x max|dx|, f32 1e-5 x max|dx|; dw one bf16 spacing + "
        "1e-3 x max|dw|, f32 1e-5); two calls bit-equal")
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for D in NORM_WIDTHS:
            for R in NORM_BWD_ROWS:
                for parametric in (True, False):
                    x, w = norm_case(dev, dtype, R, D, 3 * R + D, parametric)
                    dy = norm_case(dev, dtype, R, D, 5 * R + D)[0] / 3
                    dx, dw = ops.rmsnorm_bwd(x, w, dy)
                    dx2, dw2 = ops.rmsnorm_bwd(x, w, dy)
                    torch.cuda.synchronize()
                    if not torch.equal(dx, dx2) or (w is not None
                                                    and not torch.equal(dw, dw2)):
                        raise AssertionError(f"rmsnorm_bwd R={R} D={D} {dtype}: "
                                             "two calls differ")
                    want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy)
                    worst = max(worst, bwd_close(dx, want_dx, dtype, "dx"))
                    if w is not None:
                        worst = max(worst, bwd_close(dw, want_dw, dtype, "dw"))
                    elif dw is not None:
                        raise AssertionError("rmsnorm_bwd returned dw without w")
        log(f"  {str(dtype)[6:]:8s} D in {NORM_WIDTHS} x R in {NORM_BWD_ROWS}, with "
            f"and without w: ok, repeat calls bit-equal (largest max_abs_err so far "
            f"{worst:.3g})")
    log_kernel_build("rmsnorm", "rmsnorm_bwd_kernel")
    row, extra = None, {}

    def split(us: dict) -> str:
        return ", ".join(f"{k.split('(')[0][-40:]} {v:.2f}" for k, v in us.items())
    for D in NORM_BWD_TIMED:
        R = 2048
        x, w = norm_case(dev, torch.bfloat16, R, D, 11 * D)
        dy = norm_case(dev, torch.bfloat16, R, D, 13 * D)[0] / 3
        dx, dw = ops.rmsnorm_bwd(x, w, dy)
        want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy)
        err = max(bwd_close(dx, want_dx, torch.bfloat16, "dx"),
                  bwd_close(dw, want_dw, torch.bfloat16, "dw"))
        ms = timer(lambda: ops.rmsnorm_bwd(x, w, dy))
        plain_ms = timer(lambda: ref.rmsnorm_bwd_ref(x, w, dy))
        dev_split = timer.device_split_us(lambda: ops.rmsnorm_bwd(x, w, dy))
        dev_us = sum(dev_split.values())
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        y = F.rms_norm(xr, (D,), wr, eps=1e-6)

        def library():
            return torch.autograd.grad(y, (xr, wr), dy, retain_graph=True)
        lib_ms = timer(library)
        lib_split = timer.device_split_us(library)
        lib_us = sum(lib_split.values())
        nbytes = 3 * R * D * 2 + 2 * D * 2      # x, dy read, dx written; w, dw
        b_ms, b_by = bound_ms(nbytes, 10 * R * D, torch.float32)
        log(f"  times, bf16 R={R} D={D} (plan {ops.card_bwd_plan(R, D, 2, dev.index or 0)}): "
            f"kernel {ms:.4f} ms (device {dev_us:.2f} us: {split(dev_split)}), plain "
            f"{plain_ms:.4f} ms, F.rms_norm backward {lib_ms:.4f} ms (device {lib_us:.2f} "
            f"us: {split(lib_split)}), bound {b_ms:.6f} ms ({b_by}: {nbytes} bytes); "
            f"device {100 * b_ms * 1e3 / dev_us:.1f}% of the bound")
        if D == 2048:
            row = dict(name="rmsnorm_bwd", route="cuda",
                       source="src/repro_torch/csrc/rmsnorm.cu",
                       replaces="src/repro/kernels/rmsnorm/rmsnorm.py:24 (its "
                                "gradient; the reference differentiates its jnp "
                                "RMSNorm, src/repro/models/common.py:37)",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, device_us=dev_us,
                       library_device_us=lib_us, b2b_us=None,
                       shape="bf16 R=2048 D=2048 with w (qwen2.5-3b training, every "
                             "norm); library_ms: F.rms_norm's backward under "
                             "autograd, timed as the kernel; library_device_us: its "
                             "profiler device time; d3584_*, d1536_*: D 3584 and 1536 "
                             "at R=2048")
        else:
            extra.update({f"d{D}_ms": ms, f"d{D}_plain_ms": plain_ms,
                          f"d{D}_bound_ms": b_ms, f"d{D}_library_ms": lib_ms,
                          f"d{D}_library_device_us": lib_us, f"d{D}_device_us": dev_us})
        del xr, wr, y
    row.update(extra)
    return row


# ---------------------------------------------------------------- phase 6
def ssd_bytes(B, H, P, N, G, xbytes=4):
    """Each input read once, each output written once: h in and h' out
    (f32), x, dt, A, B and C in, y out."""
    return (2 * B * H * P * N * 4 + B * H * P * xbytes + B * H * 4 + H * 4
            + 2 * B * G * N * xbytes + B * H * P * 4)


def ssd_case(dev, dtype, B, H, P, N, G, seed, dA_scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((B, H, P, N), generator=g, device=dev)
    x = torch.randn((B, H, P), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, H), generator=g, device=dev))
    A = -dA_scale * torch.exp(torch.randn((H,), generator=g, device=dev))
    Bm = torch.randn((B, G, N), generator=g, device=dev).to(dtype)
    Cm = torch.randn((B, G, N), generator=g, device=dev).to(dtype)
    return h, x, dt, A, Bm, Cm


def check_ssd_update(dev, timer):
    from repro_torch.kernels.ssd_update import ops, ref
    log("== phase 6: SSD update, kernel vs plain (h' and y f32, tol 1e-4 x "
        "max(1,|plain|))")
    log_kernel_build("ssd_update", "ssd_update_kernel")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [("mamba2-2.7b decode", 1, 80, 64, 128, 1, 1.0),
             ("zamba2-1.2b decode", 1, 64, 64, 64, 1, 1.0),
             ("grouped, G=2", 3, 8, 16, 32, 2, 1.0),
             ("very negative dA (exp -> 0)", 1, 80, 64, 128, 1, 1e4)]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (label, B, H, P, N, G, scale) in enumerate(cases):
            h, x, dt, A, Bm, Cm = ssd_case(dev, dtype, B, H, P, N, G, i, scale)
            want_h, want_y = ref.ssd_update_ref(h, x, dt, A, Bm, Cm)
            h_new, y = ops.ssd_update(h, x, dt, A, Bm, Cm)
            torch.cuda.synchronize()
            errs = [rel_err(h_new, want_h), rel_err(y, want_y)]
            same = ops.ssd_update(h, x, dt, A, Bm, Cm, out=h)
            torch.cuda.synchronize()
            in_place = (same[0] is h and torch.equal(h, h_new)
                        and torch.equal(same[1], y))
            ok = all(r <= TOL[torch.float32] for _, r in errs) and in_place
            worst = max(worst, errs[0][0], errs[1][0])
            log(f"  {str(dtype)[6:]:8s} x/B/C, {label}: B={B} H={H} P={P} N={N} "
                f"G={G}: max_abs_err h' {errs[0][0]:.3g}, y {errs[1][0]:.3g}; "
                f"in place (out=h) bit-equal {in_place}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"ssd_update {label} {dtype} disagrees")

    row = None
    for label, B, H, P, N, G in (("mamba2-2.7b", 1, 80, 64, 128, 1),
                                 ("zamba2-1.2b", 1, 64, 64, 64, 1)):
        h, x, dt, A, Bm, Cm = ssd_case(dev, torch.float32, B, H, P, N, G, 99)
        want_h, want_y = ref.ssd_update_ref(h, x, dt, A, Bm, Cm)
        h_new, y = ops.ssd_update(h, x, dt, A, Bm, Cm)
        err = max(rel_err(h_new, want_h)[0], rel_err(y, want_y)[0])
        ms = timer(lambda: ops.ssd_update(h, x, dt, A, Bm, Cm, out=h))
        plain_ms = timer(lambda: ref.ssd_update_ref(h, x, dt, A, Bm, Cm))
        dev_us = timer.device_us(lambda: ops.ssd_update(h, x, dt, A, Bm, Cm, out=h))
        # a step's layers each update their own state: 64 (mamba2, 168 MB)
        # or 96 (zamba2, 101 MB) distinct states, past L2
        states = [torch.randn_like(h) for _ in range(64 if N == 128 else 96)]
        b2b_us = timer.back_to_back_us([
            lambda s=s: ops.ssd_update(s, x, dt, A, Bm, Cm, out=s) for s in states])
        del states
        nbytes = ssd_bytes(B, H, P, N, G)
        b_ms, b_by = bound_ms(nbytes, 5 * B * H * P * N, torch.float32)
        log(f"  times at the {label} decode shape (f32 x/B/C as the model passes "
            f"them, in place; {ops.ssd_plan(B, H, P, N, n_sm)}): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library: no single PyTorch call, bound "
            f"{b_ms:.6f} ms ({b_by}: {nbytes} bytes); device {dev_us:.2f} us a call "
            f"(profiler), {b2b_us:.2f} us a call back to back, L2 cold")
        if row is None:
            row = dict(name="ssd_update", route="cuda",
                       source="src/repro_torch/csrc/ssd_update.cu",
                       replaces="src/repro/kernels/ssd_update/ssd_update.py:37",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None, device_us=dev_us,
                       b2b_us=b2b_us,
                       shape="f32 B=1 H=80 P=64 N=128 G=1, in place "
                             "(mamba2-2.7b decode); b2b_us over 64 distinct "
                             "states")
    return row


# ---------------------------------------------------------------- phase 6c
# (label, leading dims, K, N): a qwen2-moe-a2.7b expert stack and a
# qwen2.5-7b w_gate, the shapes the int4 moe step and the 7b dequant
# routes give the kernel
DEQUANT_SHAPES = (("qwen2-moe-a2.7b w_gate stack", (60,), 2048, 1408),
                  ("qwen2.5-7b w_gate", (), 3584, 18944))
DEQUANT_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def dequant_case(dev, bits, lead, K, N, group, seed):
    """Codes over their whole range (int4 nibbles -8..7, int8 -128..127)
    and positive f32 scales over six decades, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = K // 2 if bits == 4 else K
    codes = torch.randint(0, 256, lead + (rows, N), generator=g, device=dev,
                          dtype=torch.int32)
    codes = codes.to(torch.uint8) if bits == 4 else (codes - 128).to(torch.int8)
    exp = torch.randint(-6, 1, lead + (K // group, N), generator=g, device=dev)
    scales = (torch.rand(lead + (K // group, N), generator=g, device=dev) + 0.5) \
        * torch.pow(10.0, exp.float())
    return codes, scales


def dequant_bytes(codes, scales, dtype, bits) -> int:
    out = codes.numel() * (2 if bits == 4 else 1) * torch.finfo(dtype).bits // 8
    return codes.numel() * codes.element_size() + scales.numel() * 4 + out


def check_dequantize(dev, timer):
    """6c: the dequantisation kernel (port-only: the reference dequantises
    with jnp) bit-equal to its plain version; its row of the kernels
    line at the qwen2-moe-a2.7b stack (int4, group 128, bf16)."""
    from repro_torch.kernels.dequantize import ops, ref
    log("== phase 6c: dequantisation, kernel vs plain (bit-equal): int4 and int8, "
        "bf16 / f16 / f32 out, 2-D and 3-D, groups 32 and 128")
    log_kernel_build("dequantize", "dequantize_kernel")
    cases = [(bits, dtype, shape, group) for bits in (4, 8) for dtype in DEQUANT_DTYPES
             for shape in DEQUANT_SHAPES for group in (32, 128)]
    # the scalar variant: N not a multiple of 16
    cases += [(bits, torch.bfloat16, ("ragged N", (3,), 256, 50), 32) for bits in (4, 8)]
    worst = 0.0
    for i, (bits, dtype, (label, lead, K, N), group) in enumerate(cases):
        codes, scales = dequant_case(dev, bits, lead, K, N, group, i)
        got = ops.dequantize(codes, scales, bits, dtype)
        want = ref.dequantize_ref(codes, scales, bits, dtype)
        again = ops.dequantize(codes, scales, bits, dtype)
        torch.cuda.synchronize()
        view = torch.int32 if dtype == torch.float32 else torch.int16
        ok = (got.shape == want.shape and torch.equal(got.view(view), want.view(view))
              and torch.equal(got.view(view), again.view(view)))
        if got.shape == want.shape:
            worst = max(worst, (got.float() - want.float()).abs().max().item())
        log(f"  int{bits} -> {str(dtype)[6:]:8s} {label} {lead + (K, N)} group {group}: "
            f"bit-equal to the plain version and across two calls: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dequantize int{bits} {dtype} {label} group {group} "
                                 "differs from its plain version")
        del codes, scales, got, want, again
    log(f"  largest max_abs_err over the {len(cases)} cases: {worst:.3g}")
    row, times = None, {}
    for label, lead, K, N in DEQUANT_SHAPES:
        for bits in (4, 8):
            codes, scales = dequant_case(dev, bits, lead, K, N, 128, 99)
            ms = timer(lambda: ops.dequantize(codes, scales, bits, torch.bfloat16))
            plain_ms = timer(lambda: ref.dequantize_ref(codes, scales, bits, torch.bfloat16))
            nbytes = dequant_bytes(codes, scales, torch.bfloat16, bits)
            b_ms, b_by = bound_ms(nbytes, 0, torch.bfloat16)
            log(f"  times, int{bits} -> bf16, {label} {lead + (K, N)} group 128: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library: no single PyTorch "
                f"call, bound {b_ms:.6f} ms ({b_by}: {nbytes} bytes, "
                f"{nbytes / ms / 1e6:.1f} GB/s realised)")
            times[f"{label} int{bits}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                               bytes=nbytes)
            if row is None:
                row = dict(name="dequantize", route="cuda",
                           source="src/repro_torch/csrc/dequantize.cu",
                           replaces="src/repro/quant/quantize.py:126 (jnp; no TPU kernel)",
                           max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None,
                           shape=f"int4 (60, 1024, 1408) packed codes, group 128 -> "
                                 f"bf16 (60, 2048, 1408): a qwen2-moe-a2.7b w_gate "
                                 f"stack")
            del codes, scales
    row["times"] = times
    return row


# ---------------------------------------------------------------- phases 7-12
def prompt_batch(vocab, dev, n=None, seed=0):
    rng = np.random.default_rng(seed)
    n = n or PROMPT
    return {"tokens": torch.from_numpy(rng.integers(0, vocab, (1, n))).to(dev)}


def check_f32_tokens(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    log("== phase 7: kernel inside the real path (qwen2.5-7b width, 2 layers, f32)")
    cfg = get_config("qwen2.5-7b").replace(n_layers=2, dtype="float32")
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    batch = prompt_batch(cfg.vocab_size, dev, 512, seed=1)
    toks = {}
    for backend in ("cuda", "sdpa"):
        model.decode_backend = backend
        res = DecodeEngine(model, params).generate_streamed(
            batch, max_len=512 + 17, n_new=16)
        toks[backend] = res.tokens.cpu()
    same = torch.equal(toks["cuda"], toks["sdpa"])
    log(f"  greedy tokens cuda {toks['cuda'][0].tolist()}")
    log(f"  greedy tokens sdpa {toks['sdpa'][0].tolist()}: "
        f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("f32 greedy tokens differ between cuda and sdpa")
    del params, model
    torch.cuda.empty_cache()


def prefill_wall(engine, batch, max_len, reps=3):
    """Median host wall (ms, synchronised) of ``reps`` prefills of batch."""
    walls = []
    with torch.inference_mode():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = engine.prefill(batch, max_len)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del cache
    return statistics.median(walls) * 1e3


def zero_counts():
    """Every kernel wrapper's ``launches`` and the capture / replay
    tallies set to 0, just before a main path is driven."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import zero_launch_counts
    zero_launch_counts()
    dispatch.captured_launches.clear()
    dispatch.replay_launches.clear()


def launched():
    """Kernels launched on the card since ``zero_counts``, by kernel: the
    wrappers' counts minus what captures recorded (counted, not run) plus
    what graph replays launched (run, not counted)."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import launch_counts
    return {name: n - dispatch.captured_launches.get(name, 0)
            + dispatch.replay_launches.get(name, 0)
            for name, n in launch_counts().items()}


def eager_p50(engine, batch, tok):
    """The eager arm's p50 (ms): ``measure_cell`` (5 warm-up + 30
    measured steps, synchronised) of plain ``decode_step`` calls over a
    prefilled cache of its own, one session."""
    from repro_torch.core.protocol import measure_cell
    with torch.inference_mode():
        cache = engine.new_cache(1, PROMPT + 64)
        engine.model.prefill(engine.params, batch, cache)
        cell = measure_cell(lambda: engine.model.decode_step(engine.params, cache, tok)[0],
                            name="eager")
    del cache
    return cell.p50_ms


def serve_graph_step(engine, batch, max_len):
    """The engine's graph step served: a warm-up request of each loop at
    the timed shape (their graphs are captured there), then, counts at
    0, two streamed requests and one fused.  Returns the runs and the
    kernels launched on the card by them."""
    engine.generate_streamed(batch, max_len=max_len, n_new=NEW)
    engine.generate_fused(batch, max_len=max_len, n_new=NEW)
    zero_counts()
    runs = [engine.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True),
            engine.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True),
            engine.generate_fused(batch, max_len=max_len, n_new=NEW)]
    return runs, launched()


def main_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.floor import floor_cell
    from repro_torch.core.hardware import GPU_H100
    from repro_torch.kernels.int4_matmul import ops as i4_ops
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    log("== phase 10: main path, qwen2.5-7b full width (28 layers, bf16), "
        f"prompt {PROMPT}, {NEW} new tokens")
    cfg = get_config("qwen2.5-7b")
    model = Model(cfg, decode_backend="cuda", device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"  random weights drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    engine = DecodeEngine(model, params)
    batch = prompt_batch(cfg.vocab_size, dev)
    max_len = PROMPT + NEW + 1
    runs, counts = serve_graph_step(engine, batch, max_len)
    da_launches, i4_main = counts["decode_attention"], counts["int4_matmul"]
    rms = counts["rmsnorm"]
    steps = 3 * (NEW - 1)
    norms = 2 * cfg.n_layers + 1
    log(f"  engine graph step (captured once per loop at this shape, replayed): "
        f"decode_attention launches {da_launches} ({cfg.n_layers} x {steps} "
        f"decode steps = {cfg.n_layers * steps}); rmsnorm launches {rms} ({norms} "
        f"x ({steps} decode steps + 3 prefills) = {norms * (steps + 3)}); "
        f"int4_matmul launches {i4_main}")
    if da_launches != cfg.n_layers * steps:
        raise AssertionError("the main path did not run decode attention once "
                             "per layer and step")
    if rms != norms * (steps + 3):
        raise AssertionError("the main path did not run the RMSNorm kernel for "
                             "every norm")
    for i, r in enumerate(runs):
        if r.tokens.shape != (1, NEW):
            raise AssertionError(f"request {i}: tokens {tuple(r.tokens.shape)}")
    if not (torch.equal(runs[0].tokens, runs[1].tokens)
            and torch.equal(runs[0].tokens, runs[2].tokens)):
        raise AssertionError("streamed and fused greedy tokens differ")
    pre_bf16 = prefill_wall(engine, batch, max_len)
    log(f"  prefill of {PROMPT} tokens (bf16): {pre_bf16:.4f} ms wall, median of 3")
    step_s = runs[0].step_times_s + runs[1].step_times_s
    p50 = statistics.median(step_s) * 1e3
    p50_eager = eager_p50(engine, batch, runs[0].tokens[:, :1])
    fc = floor_cell(cfg, GPU_H100, PROMPT)
    log(f"  p50 step {p50:.4f} ms (engine graph step, streamed, n={len(step_s)}); "
        f"eager p50 {p50_eager:.4f} ms (plain decode_step calls, measure_cell); "
        f"analytic floor {fc.t_floor_ms:.4f} ms (floor_cell qwen2.5-7b, "
        f"{GPU_H100.name}, ctx {PROMPT}); R_floor {fc.t_floor_ms / p50:.4f} "
        f"(eager {fc.t_floor_ms / p50_eager:.4f})")
    log("  tok/s: " + ", ".join(f"{r.tokens_per_s:.2f}" for r in runs)
        + " (streamed, streamed, fused)")
    MEASURED["qwen2.5-7b decode graph p50 ms"] = p50

    # first decode step: kernel route against the sdpa route
    tok = runs[0].tokens[:, :1]
    first_step_cuda_vs_sdpa(model, engine, batch, max_len, tok)
    _, kernels = device_time(model, engine, batch, max_len, tok, p50, p50_eager)
    check_attention_kernels(kernels, cfg.n_layers, "qwen2.5-7b bf16 step")
    torch.cuda.empty_cache()

    log("== phase 11: int4 main path (int4_fused, quantised on the card)")
    t0 = time.perf_counter()
    engine_q = DecodeEngine(model, params, quant_path="int4_fused")
    torch.cuda.synchronize()
    log(f"  quantised in {time.perf_counter() - t0:.1f} s")
    per_step = 7 * cfg.n_layers
    i4_ops.launches = 0
    pre_int4 = prefill_wall(engine_q, batch, max_len)
    pre_launches = i4_ops.launches / 3
    log(f"  prefill of {PROMPT} tokens (int4_fused): {pre_int4:.4f} ms wall, "
        f"median of 3 (bf16 {pre_bf16:.4f} ms); int4_matmul launches per "
        f"prefill {pre_launches:g} (7 x {cfg.n_layers} = {per_step})")
    if pre_launches != per_step:
        raise AssertionError("the int4 prefill did not run the int4 kernel for "
                             "every quantised matmul")
    engine_q.generate_streamed(batch, max_len=max_len, n_new=NEW)   # capture
    zero_counts()
    res = engine_q.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True)
    counts = launched()
    i4_launches, da_q = counts["int4_matmul"], counts["decode_attention"]
    want = per_step * (NEW - 1) + per_step
    log(f"  engine graph step: int4_matmul launches {i4_launches} (7 x "
        f"{cfg.n_layers} x {NEW - 1} decode steps + {per_step} at prefill = "
        f"{want}); decode_attention launches {da_q}")
    if i4_launches != want:
        raise AssertionError("the int4 path did not run the int4 kernel for "
                             "every quantised matmul")
    if res.tokens.shape != (1, NEW):
        raise AssertionError(f"int4 tokens {tuple(res.tokens.shape)}")
    from repro_torch.quant import tree_weight_traffic
    p50_q = statistics.median(res.step_times_s) * 1e3
    p50_q_eager = eager_p50(engine_q, batch, res.tokens[:, :1])
    fq = floor_cell(cfg, GPU_H100, PROMPT, weight_dtype_bytes=0.5)
    own = (tree_weight_traffic(engine_q.params) + fq.kv_bytes) / GPU_H100.hbm_bw * 1e3
    log(f"  p50 step {p50_q:.4f} ms (engine graph step); eager p50 "
        f"{p50_q_eager:.4f} ms; analytic int4 floor {fq.t_floor_ms:.4f} ms "
        f"(floor_cell weight_dtype_bytes=0.5); this path's own bytes (int4 "
        f"linears, bf16 embedding and head, bf16 KV) give {own:.4f} ms; "
        f"{res.tokens_per_s:.2f} tok/s")
    busy_q, kernels = device_time(model, engine_q, batch, max_len,
                                  res.tokens[:, :1], p50_q, p50_q_eager)
    if kernels:
        gemv = sum(n for k, n in kernels.items() if "int4_gemv" in k)
        reduce = sum(n for k, n in kernels.items() if "splitk" in k)
        log(f"  int4 GEMV kernels per step under the profiler: {gemv:g} (7 x "
            f"{cfg.n_layers} = {per_step}); split-K reduce kernels: {reduce:g}")
        if gemv != per_step or reduce:
            raise AssertionError("the int4 step did not run one GEMV launch per "
                                 "quantised matmul")
    prefill = dict(prefill_launches=pre_launches, prefill_wall_ms=pre_int4,
                   prefill_wall_bf16_ms=pre_bf16, step_device_ms=busy_q,
                   step_p50_ms=p50_q, step_eager_p50_ms=p50_q_eager)
    return da_launches, i4_launches, rms, prefill


def device_time(model, engine, batch, max_len, tok, p50_ms, p50_eager_ms, steps=4):
    """Kernel time per decode step under torch.profiler (plain
    ``decode_step`` calls: the same kernels the graph replays), against
    the unprofiled p50 of the graph step and of the eager arm: the
    device's busy share of a step.  Returns the busy ms per step and
    {kernel name: launches per step}; without device time from the
    profiler, the steps' span between CUDA events instead (idle gaps
    included) and no names."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        _, cache = engine.prefill(batch, max_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.decode_step(engine.params, cache, tok)
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total, e.key, e.count)
                for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy = sum(r[0] for r in rows) / 1e3 / steps
        if busy == 0:
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            for _ in range(steps):
                model.decode_step(engine.params, cache, tok)
            e.record()
            torch.cuda.synchronize()
            span = s.elapsed_time(e) / steps
            log(f"  device time per step: the profiler saw no device time; "
                f"CUDA events around {steps} steps give {span:.4f} ms per step "
                f"(idle gaps included) of the {p50_ms:.4f} ms p50 step")
            return span, {}
    log(f"  device time per step (torch.profiler, {steps} eager steps): {busy:.4f} "
        f"ms busy = {busy / p50_ms:.1%} of the {p50_ms:.4f} ms graph p50 step, "
        f"{busy / p50_eager_ms:.1%} of the {p50_eager_ms:.4f} ms eager p50; "
        f"{sum(r[2] for r in rows) // steps} kernels per step")
    for t, name, n in sorted(rows, reverse=True)[:8]:
        log(f"    {t / 1e3 / steps:8.4f} ms/step  {n // steps:5d}x  {name[:90]}")
    return busy, {name: n / steps for _, name, n in rows}


def check_attention_kernels(kernels, per_step, where):
    """Kernel 1 in a profiled bf16 decode step: ``per_step``
    ``decode_attention_mma`` kernels (one launch per call) and no
    CUDA-core partial or merge kernel."""
    mma = sum(n for k, n in kernels.items() if "decode_attention_mma" in k)
    pair = sum(n for k, n in kernels.items()
               if "decode_attention_partial" in k or "decode_attention_merge" in k)
    log(f"  {where}: decode_attention_mma kernels per step under the profiler "
        f"{mma:g} (want {per_step}); decode_attention_partial/merge kernels {pair:g} "
        "(want 0)")
    if mma != per_step or pair:
        raise AssertionError(f"{where}: kernel 1 was not one decode_attention_mma "
                             "launch per attention call")


# ---------------------------------------------------------------- phase 10c
SAMPLE_T, SAMPLE_K, SEEDS = 0.8, 50, (11, 12)


def plain_sampled(engine, batch, max_len, seed):
    """Uncaptured stochastic tokens (1, NEW): a prefill, the first draw,
    then ``Model.decode_steps``, all from one generator seeded with
    ``seed``: the calls the fused loop makes, as plain calls."""
    from repro_torch.serving.sampling import sample
    with torch.inference_mode():
        logits, cache = engine.prefill(batch, max_len)
        gen = torch.Generator(device=engine.device).manual_seed(seed)
        tok = sample(logits[:, -1], gen, temperature=SAMPLE_T, top_k=SAMPLE_K)
        toks, _ = engine.model.decode_steps(
            engine.params, cache, tok[:, None], gen, horizon=NEW - 1,
            temperature=SAMPLE_T, top_k=SAMPLE_K)
        out = torch.cat([tok[:, None], toks], dim=1)
    del cache
    return out


def fused_ms_per_token(engine, batch, max_len, reps=5, **kw):
    """Median over ``reps`` fused calls of the loop's wall a token (one
    replay of NEW - 1 steps, synchronised; the graph captured before)."""
    return statistics.median(
        1e3 / engine.generate_fused(batch, max_len=max_len, n_new=NEW, **kw).tokens_per_s
        for _ in range(reps))


def streamed_p50(engine, batch, max_len, **kw):
    """A warm-up streamed request, an untimed one (its tok/s: no sync
    between steps) and two timed ones (a sync after each step): (p50 ms
    a step, replay plus sampling; the untimed tok/s; its tokens)."""
    engine.generate_streamed(batch, max_len=max_len, n_new=NEW, **kw)
    run = engine.generate_streamed(batch, max_len=max_len, n_new=NEW, **kw)
    timed = [engine.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True, **kw)
             for _ in range(2)]
    steps = timed[0].step_times_s + timed[1].step_times_s
    return statistics.median(steps) * 1e3, run.tokens_per_s, run.tokens


def sampled_batch1(engine, batch, max_len, label, per_step):
    """A (bf16) and B (int4_fused): the fused loop at temperature 0.8,
    top_k 50, captured at its first call and replayed at its second,
    bit-equal to uncaptured ``decode_steps`` from the same seed; a second
    seed draws another stream.  ``per_step``: {kernel: launches a decode
    step} that the replays must make.  Then greedy against stochastic:
    the fused loop's ms a token and the streamed loop's p50 step."""
    from repro_torch.core import dispatch
    want = {s: plain_sampled(engine, batch, max_len, s) for s in SEEDS}
    if torch.equal(want[SEEDS[0]], want[SEEDS[1]]):
        raise AssertionError(f"{label}: seeds {SEEDS} drew one stream uncaptured")
    kw = dict(temperature=SAMPLE_T, top_k=SAMPLE_K)
    order = (SEEDS[0], SEEDS[0], SEEDS[1])    # capture, replay, replay reseeded
    zero_counts()
    runs = [engine.generate_fused(batch, max_len=max_len, n_new=NEW, seed=s, **kw)
            for s in order]
    counts = launched()
    replayed = dict(dispatch.replay_launches)
    for i, (r, s) in enumerate(zip(runs, order)):
        if not torch.equal(r.tokens, want[s]):
            raise AssertionError(
                f"{label}: fused call {i} (seed {s}) drew {r.tokens.tolist()}, "
                f"uncaptured decode_steps {want[s].tolist()}")
    steps = NEW - 1
    log(f"  {label}: fused loop at temperature {SAMPLE_T}, top_k {SAMPLE_K}: "
        f"3 calls (seed {order[0]} captured, {order[1]} replayed, {order[2]} "
        f"replayed) bit-equal to uncaptured decode_steps from each seed; "
        f"launched {counts}; by the 2 replays {replayed}")
    for kernel, n in per_step.items():
        if replayed.get(kernel, 0) != 2 * steps * n:
            raise AssertionError(f"{label}: the replays launched {kernel} "
                                 f"{replayed.get(kernel, 0)} times, want {n} x "
                                 f"{steps} steps x 2")
    fused = {"stochastic": fused_ms_per_token(engine, batch, max_len, seed=SEEDS[0], **kw)}
    engine.generate_fused(batch, max_len=max_len, n_new=NEW)       # greedy capture
    fused["greedy"] = fused_ms_per_token(engine, batch, max_len)
    s_greedy, tps_greedy, _ = streamed_p50(engine, batch, max_len)
    s_sto, tps_sto, s_tokens = streamed_p50(engine, batch, max_len, seed=SEEDS[0], **kw)
    same = bool(torch.equal(s_tokens, want[SEEDS[0]]))
    out = dict(fused_equal_uncaptured=True, seeds_differ=True,
               fused_ms_per_token=fused,
               streamed_p50_ms={"greedy": s_greedy, "stochastic": s_sto},
               tok_s={"fused_stochastic": 1e3 / fused["stochastic"],
                      "streamed_stochastic": tps_sto, "streamed_greedy": tps_greedy},
               streamed_equal_fused=same,
               replayed_per_step={k: replayed.get(k, 0) / (2 * steps) for k in per_step})
    log(f"    fused ms a token: greedy {fused['greedy']:.4f}, stochastic "
        f"{fused['stochastic']:.4f} (median of 5); streamed p50 step (synchronised "
        f"after each): greedy {s_greedy:.4f}, stochastic {s_sto:.4f} ms (n=62); "
        f"stochastic tok/s (no sync between steps) streamed {tps_sto:.2f}, fused "
        f"{1e3 / fused['stochastic']:.2f}; streamed stochastic tokens equal the "
        f"fused loop's: {same}")
    return counts, out


def sample_ops(engine, batch, max_len, dev):
    """The sampling ops of one fused step on their own: ``sample`` on the
    last prefill row (1, V), stochastic and greedy; profiler device µs by
    kernel name (L2 flushed) and the Timer's ms."""
    from repro_torch.serving.sampling import sample
    timer = Timer(dev)
    with torch.inference_mode():
        logits, cache = engine.prefill(batch, max_len)
        row = logits[:, -1].clone()
        del cache
        gen = torch.Generator(device=dev).manual_seed(0)
        # the sort launches its radix pass kernel once a digit; argmax once
        split = timer.device_split_us(
            lambda: sample(row, gen, temperature=SAMPLE_T, top_k=SAMPLE_K),
            once="ArgMaxOps")
        greedy = timer.device_split_us(lambda: sample(row), once="ArgMaxOps")
        ms = timer(lambda: sample(row, gen, temperature=SAMPLE_T, top_k=SAMPLE_K))
        ms_greedy = timer(lambda: sample(row))
    del timer
    out = dict(row=[list(row.shape), str(row.dtype)], device_us=split,
               device_us_total=sum(split.values()),
               greedy_device_us_total=sum(greedy.values()), ms=ms, greedy_ms=ms_greedy)
    log(f"  sampling ops on a {tuple(row.shape)} {row.dtype} row: stochastic "
        f"{out['device_us_total']:.2f} device µs over {len(split)} kernel names "
        f"({ms:.4f} ms by events), greedy {out['greedy_device_us_total']:.2f} µs "
        f"({ms_greedy:.4f} ms):")
    for name, us in sorted(split.items(), key=lambda kv: -kv[1]):
        log(f"    {us:8.2f} µs  {name[:100]}")
    return out


def sampled_paged(dev, model, params):
    """C: phase 12's 8 sessions through 4 paged slots (bf16 KV, page 16,
    chunk 512) at temperature 0.8, top_k 50, one seed: K=4 captured, K=4
    uncaptured (equal event logs, the generator left where it was), K=1
    captured (sampling outside the step graph).  Every session ends with
    its budget, the pools balance, and the K=4 replays launch kernel 2
    28 times a device step."""
    from repro_torch.launch.serve import mixed_requests
    from repro_torch.serving import SlotScheduler, programs
    cfg = model.cfg
    reqs = mixed_requests(cfg, 8, base_prompt=PROMPT, base_new=NEW, seed=0)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 1
    budgets = {r.session_id: r.max_new_tokens for r in reqs}
    kw = dict(n_slots=4, max_len=max_len, paged=True, page_size=PAGE,
              prefill_chunk=512, temperature=SAMPLE_T, top_k=SAMPLE_K, seed=SEEDS[0])
    counts, out, events = {}, {}, {}
    for label, K, capture in (("K=4", 4, True), ("K=4 uncaptured", 4, False),
                              ("K=1", 1, True)):
        sched = SlotScheduler(model, params, steps_per_tick=K, **kw)
        sched._progs.capture = capture
        for r in reqs:
            sched.submit(r)
        zero_counts()
        with torch.inference_mode():
            res = sched.run()
        if capture:
            counts[label] = launched()
        replayed = programs.replay_launches.get("paged_decode_attention", 0)
        got = {sid: len(s.tokens) for sid, s in res.sessions.items()}
        step_s = [t for s in res.sessions.values() for t in s.step_times_s]
        p50 = statistics.median(step_s) * 1e3
        slowest = max(step_s) * K * 1e3    # the first dispatch's wall: the capture
        log(f"  paged, {label}: {res.run_tokens} tokens in {res.ticks} ticks / "
            f"{res.dispatches} decode dispatches, {res.preemptions} preemptions; "
            f"{res.tokens_per_s:.2f} tok/s over {res.wall_s:.3f} s; p50 decode "
            f"time a token {p50:.4f} ms; slowest dispatch {slowest:.1f} ms; graphs "
            f"{res.step_cache_size}; kernel-2 launches by replays {replayed}")
        if got != budgets:
            raise AssertionError(f"paged {label}: sessions ended short: {got} vs {budgets}")
        check_balanced(sched, f"paged {label}")
        if capture and (res.step_cache_size != 1
                        or replayed != res.dispatches * K * cfg.n_layers):
            raise AssertionError(f"paged {label}: {res.step_cache_size} graphs, "
                                 f"{replayed} kernel-2 launches by the replays, "
                                 f"want 1 and {cfg.n_layers} x {K} x {res.dispatches}")
        events[label] = (res.events, sched.gen.get_state())
        out[label] = dict(tok_s=res.tokens_per_s, p50_ms_token=p50, wall_s=res.wall_s,
                          slowest_dispatch_ms=slowest, ticks=res.ticks,
                          dispatches=res.dispatches, tokens=res.run_tokens,
                          preemptions=res.preemptions)
        del sched
    (ev, st), (ev_plain, st_plain) = events["K=4"], events["K=4 uncaptured"]
    if ev != ev_plain or not torch.equal(st, st_plain):
        raise AssertionError("paged K=4: the captured scheduler's event log (or "
                             "its generator) differs from the uncaptured one's")
    log(f"  paged K=4: captured and uncaptured event logs equal ({len(ev)} events), "
        "generators at one offset; every session ended with its budget, pools "
        "balance")
    out["events_equal"] = True
    out["kernel2_per_device_step"] = cfg.n_layers
    return counts, out


def sampling_phase(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    log(f"== phase 10c: stochastic sampling inside the captured graphs, qwen2.5-7b "
        f"full width (28 layers, bf16), prompt {PROMPT}, {NEW} new tokens, "
        f"temperature {SAMPLE_T}, top_k {SAMPLE_K}")
    cfg = get_config("qwen2.5-7b")
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = prompt_batch(cfg.vocab_size, dev)
    max_len = PROMPT + NEW + 1
    norms = 2 * cfg.n_layers + 1
    engine = DecodeEngine(model, params)
    counts, out = {}, {}
    counts["bf16"], out["bf16"] = sampled_batch1(
        engine, batch, max_len, "A, bf16",
        {"decode_attention": cfg.n_layers, "rmsnorm": norms})
    out["sample_ops"] = sample_ops(engine, batch, max_len, dev)
    del engine
    free_card()
    engine = DecodeEngine(model, params, quant_path="int4_fused")
    counts["int4"], out["int4_fused"] = sampled_batch1(
        engine, batch, max_len, "B, int4_fused",
        {"int4_matmul": 7 * cfg.n_layers, "decode_attention": cfg.n_layers,
         "rmsnorm": norms})
    del engine
    free_card()
    paged_counts, out["paged"] = sampled_paged(dev, model, params)
    counts.update(paged_counts)
    out.update(temperature=SAMPLE_T, top_k=SAMPLE_K, seeds=list(SEEDS))
    del params, model
    free_card()
    return counts, out


def check_f32_paged_tokens(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import mixed_requests
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    log("== phase 8: paged kernel inside the real path (qwen2.5-7b width, "
        "2 layers, f32): 4 sessions through 2 paged slots")
    cfg = get_config("qwen2.5-7b").replace(n_layers=2, dtype="float32")
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    reqs = mixed_requests(cfg, 4, base_prompt=200, base_new=12, seed=2)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 1
    engine = DecodeEngine(model, params)
    streams = {}
    for backend in ("cuda", "sdpa"):
        model.decode_backend = backend
        res = engine.generate_continuous(reqs, n_slots=2, max_len=max_len,
                                         paged=True, page_size=PAGE,
                                         prefill_chunk=64)
        if res.step_cache_size != 1:
            raise AssertionError(f"{backend}: {res.step_cache_size} graphs")
        streams[backend] = {r.session_id: res.tokens_for(r.session_id).tolist()
                            for r in reqs}
    model.decode_backend = "cuda"
    for r in reqs:
        batch = {"tokens": torch.from_numpy(r.prompt)[None].to(dev)}
        one = engine.generate_streamed(batch, max_len=max_len,
                                       n_new=r.max_new_tokens).tokens[0]
        same = (streams["cuda"][r.session_id] == streams["sdpa"][r.session_id]
                == one.cpu().tolist())
        log(f"  {r.session_id} (prompt {len(r.prompt)}, {r.max_new_tokens} new): "
            f"cuda {streams['cuda'][r.session_id]}: "
            f"{'identical to sdpa and batch-1' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"f32 paged greedy tokens differ for "
                                 f"{r.session_id}")
    del params, model, engine
    torch.cuda.empty_cache()


def paged_first_step_logits(model, params, reqs, max_len, kv_dtype):
    """First decode step of 4 slots prefilled with the first 4 prompts,
    on the "cuda" route and the "sdpa" gather route from the same cache
    (positions reset between the two; the step rewrites the same rows)."""
    cache = model.init_cache(4, max_len, kv_dtype=kv_dtype, paged=True,
                             page_size=PAGE)
    toks, nxt = torch.zeros((4, 1), dtype=torch.int32, device=model.device), 1
    for slot, r in enumerate(reqs[:4]):
        n = -(-(len(r.prompt) + 1) // PAGE)
        cache["block_table"][slot, :n] = torch.arange(nxt, nxt + n)
        nxt += n
        logits, _ = model.prefill_chunk_into_slot(
            params, {"tokens": torch.from_numpy(r.prompt)[None].to(model.device)},
            cache, slot, 0)
        toks[slot, 0] = logits[0, -1].argmax()
    prefill_chunk_time(model, params, cache, reqs[0])
    pos0 = cache["pos"].clone()
    out = {}
    for backend in ("cuda", "sdpa"):
        model.decode_backend = backend
        cache["pos"].copy_(pos0)
        out[backend] = model.decode_step(params, cache, toks)[0].float()
    model.decode_backend = "cuda"
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError("non-finite first-step logits")
    diff = float((out["cuda"] - out["sdpa"]).abs().max())
    scale = float(out["sdpa"].abs().max())
    agree = bool(torch.equal(out["cuda"].argmax(-1), out["sdpa"].argmax(-1)))
    log(f"  first-step logits cuda vs sdpa (4 slots): max_abs_diff {diff:.4g}, "
        f"max|logit| {scale:.4g}, argmax {'agrees' if agree else 'differs'} "
        f"(tol 5e-2 x max|logit|)")
    if not agree or diff > 5e-2 * scale:
        raise AssertionError("paged first-step logits of cuda and sdpa disagree")


def prefill_chunk_time(model, params, cache, req, C=512, reps=3):
    """Host-clock time (synchronised) of one 512-token prefill chunk at
    the end of slot 0's prompt, and its largest kernels under
    torch.profiler.  Re-prefilling rewrites the same rows."""
    from torch.profiler import ProfilerActivity, profile
    aligned = len(req.prompt) // PAGE * PAGE
    C = min(C, aligned)
    start = aligned - C
    batch = {"tokens": torch.from_numpy(req.prompt[start:start + C])[None].to(
        model.device)}
    pos = int(cache["pos"][0])

    def run():
        model.prefill_chunk_into_slot(params, batch, cache, 0, start)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    cache["pos"][0] = pos
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    log(f"  one {C}-token prefill chunk at position {start}: {wall:.4f} ms wall, "
        f"{sum(r[0] for r in rows) / 1e3:.4f} ms device (torch.profiler); "
        f"largest:")
    for t, name, n in sorted(rows, reverse=True)[:5]:
        log(f"      {t / 1e3:8.4f} ms  {n:5d}x  {name[:90]}")


def paged_window(model, params, reqs, max_len, kw, ticks=3):
    """Device view of steady paged decode: a scheduler over the first 4
    sessions runs until every slot decodes and its graph is captured;
    then ``ticks`` ticks run under torch.profiler, timed by the host
    clock (synchronised).  Returns (paged-kernel and RMSNorm-kernel
    launches per device step, device ms per tick, wall ms per tick, the
    profiler's rows)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import SlotScheduler
    sched = SlotScheduler(model, params, max_len=max_len, **kw)
    for r in reqs[:4]:
        sched.submit(r)
    K = sched.steps_per_tick
    with torch.inference_mode():
        for _ in range(1000):
            if all(s is not None and s.decoding for s in sched.slots) \
                    and sched.step_cache_size():
                break
            sched.tick()
        else:
            raise AssertionError("the 4 slots never decoded together")
        torch.cuda.synchronize()
        steps0 = sched.decode_steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                sched.tick()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / ticks
        dev_steps = (sched.decode_steps - steps0) * K
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy = sum(r[0] for r in rows) / 1e3 / ticks
    kernel2 = sum(r[2] for r in rows if any(
        n in r[1] for n in ("paged_attention_mma", "paged_partial", "paged_merge")))
    merges = sum(r[2] for r in rows if "paged_merge" in r[1])
    norms = sum(r[2] for r in rows if "rmsnorm_kernel" in r[1])
    return (kernel2 / max(dev_steps, 1), merges, norms / max(dev_steps, 1),
            busy, wall, rows)


def paged_serving(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode_attention import ops as pda_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.launch.serve import mixed_requests
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine, programs
    log(f"== phase 12: paged serving, qwen2.5-7b full width (28 layers, bf16), "
        f"8 sessions through 4 slots, prompts {PROMPT}+, {NEW}+ new tokens, "
        f"page {PAGE}, prefill chunk 512")
    cfg = get_config("qwen2.5-7b")
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    reqs = mixed_requests(cfg, 8, base_prompt=PROMPT, base_new=NEW, seed=0)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 1
    pages_for = [-(-(len(r.prompt) + r.max_new_tokens - 1) // PAGE) for r in reqs]
    # 8 pages short of the first four sessions' full length: they cannot
    # all reach their budgets resident, so one is preempted
    tight = 1 + sum(pages_for[:4]) - 8
    counts, rms_counts = [], []
    for label, kv_dtype, n_pages, K in (
            ("bf16 KV, full backing, K=1", None, None, 1),
            (f"int8 KV, {tight} pages (oversubscribed), K=4", torch.int8, tight, 4)):
        engine = DecodeEngine(model, params, kv_dtype=kv_dtype)
        kw = dict(n_slots=4, paged=True, page_size=PAGE, n_pages=n_pages,
                  prefill_chunk=512, steps_per_tick=K)
        pda_ops.launches = rms_ops.launches = 0
        programs.captured_launches.clear()
        programs.replay_launches.clear()
        res = engine.generate_continuous(reqs, max_len=max_len, **kw)
        wrapper = pda_ops.launches
        captured = programs.captured_launches.get("paged_decode_attention", 0)
        replayed = programs.replay_launches.get("paged_decode_attention", 0)
        launches = wrapper - captured + replayed    # launched on the card
        counts.append(launches)
        norms = 2 * cfg.n_layers + 1
        rms_captured = programs.captured_launches.get("rmsnorm", 0)
        rms_replayed = programs.replay_launches.get("rmsnorm", 0)
        rms = rms_ops.launches - rms_captured + rms_replayed
        rms_counts.append(rms)
        budgets = {r.session_id: r.max_new_tokens for r in reqs}
        got = {sid: len(s.tokens) for sid, s in res.sessions.items()}
        step_s = [t for s in res.sessions.values() for t in s.step_times_s]
        log(f"  {label}: {len(res.sessions)} sessions, {res.run_tokens} tokens in "
            f"{res.ticks} ticks / {res.dispatches} decode dispatches, "
            f"{res.preemptions} preemptions, {res.prefill_tokens} prefill tokens; "
            f"{res.step_cache_size} CUDA graph(s) captured; paged-kernel "
            f"launches {launches} = {wrapper} wrapper calls (warm-up + capture, "
            f"{2 * K} x {cfg.n_layers}) - {captured} recorded at capture + "
            f"{replayed} by {res.dispatches} graph replays ({K} x "
            f"{cfg.n_layers} each); rmsnorm launches {rms} = "
            f"{rms_ops.launches} wrapper calls (prefill chunks, warm-up, "
            f"capture) - {rms_captured} recorded at capture + {rms_replayed} "
            f"by the replays ({K} x {norms} each)")
        log(f"    aggregate {res.tokens_per_s:.2f} tok/s over {res.wall_s:.3f} s "
            f"wall; p50 decode time per token {statistics.median(step_s) * 1e3:.4f}"
            f" ms (n={len(step_s)}); mean tick {res.wall_s / res.ticks * 1e3:.4f} ms; "
            f"host {res.host_dispatch_s:.3f} s dispatching + "
            f"{res.host_sync_s:.3f} s waiting for tokens")
        if got != budgets:
            raise AssertionError(f"{label}: sessions ended short: {got} vs {budgets}")
        if (res.step_cache_size != 1 or wrapper != 2 * K * cfg.n_layers
                or captured != K * cfg.n_layers):
            raise AssertionError(f"{label}: decode step not captured once")
        if replayed != res.dispatches * K * cfg.n_layers:
            raise AssertionError(f"{label}: the replays launched the paged "
                                 f"kernel {replayed} times, want {cfg.n_layers} "
                                 "per device step")
        if rms_captured != K * norms or rms_replayed != res.dispatches * K * norms:
            raise AssertionError(f"{label}: the captured step does not run the "
                                 f"RMSNorm kernel {norms} times per device step")
        if n_pages is not None and res.preemptions < 1:
            raise AssertionError(f"{label}: the tight pool preempted no one")
        p50 = statistics.median(step_s) * 1e3
        per_step, merges, norm_step, busy, wall, rows = paged_window(
            model, engine.params, reqs, max_len, dict(kw, kv_dtype=kv_dtype))
        log(f"    steady window (4 slots decoding, 3 ticks of {K} device "
            f"step(s), torch.profiler): {per_step:g} kernel-2 kernels "
            f"(paged_attention_mma; {merges} paged_merge in the window) and "
            f"{norm_step:g} RMSNorm-kernel launches per "
            f"device step; device {busy / K:.4f} ms busy per device step = "
            f"{busy / K / p50:.1%} of the unprofiled p50 decode time per token "
            f"({busy / wall:.1%} of the profiled window's own {wall / K:.4f} ms "
            f"per step); largest per tick:")
        for t, name, n in sorted(rows, reverse=True)[:6]:
            log(f"      {t / 1e3 / 3:8.4f} ms  {n / 3:6.1f}x  {name[:90]}")
        if per_step != cfg.n_layers or merges or norm_step != norms:
            raise AssertionError(f"{label}: {per_step} kernel-2 kernels "
                                 f"({merges} merges) and "
                                 f"{norm_step} RMSNorm launches per device step, "
                                 f"want {cfg.n_layers} (no merge) and {norms}")
        with torch.inference_mode():
            paged_first_step_logits(model, engine.params, reqs, max_len, kv_dtype)
        del engine
        torch.cuda.empty_cache()
    return counts, rms_counts


# ---------------------------------------------------------------- phases 9, 13, 14
SSM_ARCHS = (("mamba2-2.7b", 2), ("zamba2-1.2b", 4))   # layers in phase 9


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def check_f32_ssm_tokens(dev):
    """The same f32 weights, drawn once on the CPU, served on the card
    (kernels 1, 4 and 5) and on the CPU (their plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    log("== phase 9: kernels 4, 5 (and 1) inside the real path, card against "
        "CPU: mamba2-2.7b and zamba2-1.2b width, f32, prompt 256, 16 tokens")
    prompt = 256
    for name, layers in SSM_ARCHS:
        cfg = get_config(name).replace(n_layers=layers, dtype="float32")
        cpu_model = Model(cfg, device="cpu")
        cpu_params = cpu_model.init(torch.Generator().manual_seed(3))
        batch = prompt_batch(cfg.vocab_size, "cpu", prompt, seed=3)
        out = {}
        for label, model, params in (
                ("cpu", cpu_model, cpu_params),
                ("cuda", Model(cfg, device=dev), to_device(cpu_params, dev))):
            b = {"tokens": batch["tokens"].to(model.device)}
            eng = DecodeEngine(model, params)
            toks = eng.generate_streamed(b, max_len=prompt + 17, n_new=16).tokens
            with torch.inference_mode():
                _, cache = eng.prefill(b, prompt + 17)
                logits, _ = model.decode_step(params, cache, toks[:, :1])
            out[label] = (toks.cpu(), logits.float().cpu())
        same = torch.equal(out["cpu"][0], out["cuda"][0])
        diff = float((out["cuda"][1] - out["cpu"][1]).abs().max())
        scale = float(out["cpu"][1].abs().max())
        log(f"  {name} ({layers} layers): greedy tokens cuda "
            f"{out['cuda'][0][0].tolist()}: {'identical to' if same else 'DIFFER from'}"
            f" cpu; first-step logits max_abs_diff {diff:.4g}, max|logit| "
            f"{scale:.4g} (tol 1e-4 x max|logit|)")
        if not same or diff > 1e-4 * scale:
            raise AssertionError(f"{name}: card and CPU disagree")
        del cpu_params, out
        torch.cuda.empty_cache()


def ssm_main_path(dev, name, phase):
    """Batch-1 decode of an ssm or hybrid arch at full width and depth:
    three requests through DecodeEngine, launch counts of kernels 1, 4
    and 5, p50 step against the floor, device time per step."""
    from repro_torch.configs import get_config
    from repro_torch.core.floor import floor_cell
    from repro_torch.core.hardware import GPU_H100
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    cfg = get_config(name)
    model = Model(cfg, device=dev)
    n_apps = len(model._hybrid_groups()) if cfg.family == "hybrid" else 0
    log(f"== phase {phase}: {name} full width ({cfg.n_layers} Mamba2 layers"
        + (f" + {n_apps} shared-attention applications" if n_apps else "")
        + f", d_model {cfg.d_model}, bf16), prompt {PROMPT}, {NEW} new tokens")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"  random weights drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    engine = DecodeEngine(model, params)
    batch = prompt_batch(cfg.vocab_size, dev)
    max_len = PROMPT + NEW + 1
    t0 = time.perf_counter()
    runs, launches = serve_graph_step(engine, batch, max_len)
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in ("ssd_update", "rmsnorm", "decode_attention")}
    steps = 3 * (NEW - 1)
    norms = 2 * cfg.n_layers + 2 * n_apps + 1
    want = dict(ssd_update=cfg.n_layers * steps, rmsnorm=norms * (steps + 3),
                decode_attention=n_apps * steps)
    log(f"  engine graph step: two warm-up and three timed requests in {wall:.2f} "
        f"s; launches by the timed ones {counts}; want ssd_update "
        f"{cfg.n_layers} x {steps} decode steps, rmsnorm {norms} x ({steps} "
        f"decode steps + 3 prefills), decode_attention {n_apps} x {steps}: {want}")
    if counts != want:
        raise AssertionError(f"{name}: the main path's kernel launches {counts} "
                             f"differ from {want}")
    for i, r in enumerate(runs):
        if r.tokens.shape != (1, NEW):
            raise AssertionError(f"request {i}: tokens {tuple(r.tokens.shape)}")
    if not (torch.equal(runs[0].tokens, runs[1].tokens)
            and torch.equal(runs[0].tokens, runs[2].tokens)):
        raise AssertionError("streamed and fused greedy tokens differ")
    step_s = runs[0].step_times_s + runs[1].step_times_s
    p50 = statistics.median(step_s) * 1e3
    tok = runs[0].tokens[:, :1]
    p50_eager = eager_p50(engine, batch, tok)
    fc = floor_cell(cfg, GPU_H100, PROMPT)
    log(f"  p50 step {p50:.4f} ms (engine graph step, streamed, n={len(step_s)}); "
        f"eager p50 {p50_eager:.4f} ms (plain decode_step calls, measure_cell); "
        f"analytic floor {fc.t_floor_ms:.4f} ms (floor_cell {name}, "
        f"{GPU_H100.name}, ctx {PROMPT}); R_floor {fc.t_floor_ms / p50:.4f} "
        f"(eager {fc.t_floor_ms / p50_eager:.4f})")
    log("  tok/s: " + ", ".join(f"{r.tokens_per_s:.2f}" for r in runs)
        + " (streamed, streamed, fused)")
    with torch.inference_mode():
        t0 = time.perf_counter()
        _, cache = engine.prefill(batch, max_len)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        cpu_cache = to_device(cache, "cpu")     # before the step updates it
        logits, _ = model.decode_step(engine.params, cache, tok)
        logits = logits.float().cpu()
        t0 = time.perf_counter()
        cpu_model = Model(cfg, device="cpu")
        want, _ = cpu_model.decode_step(to_device(engine.params, "cpu"), cpu_cache,
                                        tok.cpu())
        cpu_s = time.perf_counter() - t0
        want = want.float()
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"first-step logits {tuple(logits.shape)} not finite "
                             "or of the wrong shape")
    diff = float((logits - want).abs().max())
    scale = float(want.abs().max())
    agree = int(logits.argmax()) == int(want.argmax())
    log(f"  prefill of {PROMPT} tokens {pre_ms:.1f} ms wall; first-step logits "
        f"(1, 1, {cfg.vocab_size}) finite; against one bf16 decode step on the "
        f"CPU from the same weights and prefilled state (plain versions, "
        f"{cpu_s:.1f} s): max_abs_diff {diff:.4g}, max|logit| {scale:.4g}, "
        f"argmax {'agrees' if agree else 'differs'} (tol 5e-2 x max|logit|)")
    if diff > 5e-2 * scale:
        raise AssertionError(f"{name}: first-step logits of the card and the "
                             "CPU disagree")
    del cache, cpu_cache, cpu_model
    _, kernels = device_time(model, engine, batch, max_len, tok, p50, p50_eager)
    if n_apps:
        check_attention_kernels(kernels, n_apps, f"{name} step")
    del params, engine, model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 15
AB_SESSIONS = 3
TRACES = ROOT / "build" / "traces"


def device_events(fn):
    """One call of ``fn`` under torch.profiler: its device activities as
    (start us, end us, name, category: kernel, gpu_memcpy or
    gpu_memset), in order, read from the profiler's Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    TRACES.mkdir(parents=True, exist_ok=True)
    path = TRACES / "step.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset"))


def step_view(events, names):
    """One profiled step: its kernels, their summed time and their span
    (the first kernel's start to the last one's end, so a graph's launch
    latency before its first kernel is left out), its copies and fills,
    and the device us per call of the kernels whose names hold each of
    ``names``."""
    kernels = [e for e in events if e[3] == "kernel"]
    if not kernels:
        raise AssertionError("the profiler saw no kernel in the step")
    per_call = {}
    for key in names:
        durs = [e - s for s, e, n, _ in kernels if key in n]
        per_call[key] = sum(durs) / len(durs) if durs else None
    return dict(kernels=len(kernels), copies=len(events) - len(kernels),
                kernel_ms=sum(e - s for s, e, _, _ in kernels) / 1e3,
                span_ms=(kernels[-1][1] - kernels[0][0]) / 1e3, us_per_call=per_call)


@torch.inference_mode()
def dispatch_ab(dev):
    """The paper's CUDA-Graphs A/B (§5) at qwen2.5-7b full width: the
    step program's three executors under the protocol of
    ``core/protocol.py``."""
    from repro_torch.configs import get_config
    from repro_torch.core import stats
    from repro_torch.core.dispatch import MODES
    from repro_torch.core.floor import floor_cell
    from repro_torch.core.hardware import GPU_H100
    from repro_torch.core.protocol import MEASURED_STEPS, WARMUP_STEPS, run_ab
    from repro_torch.models.model import Model
    log(f"== phase 15: dispatch A/B, qwen2.5-7b full width (28 layers, bf16), "
        f"batch 1, ctx {PROMPT}: eager / stage_jit / full_jit executors, "
        f"{WARMUP_STEPS} warm-up + {MEASURED_STEPS} measured steps, "
        f"{AB_SESSIONS} fresh sessions per A/B")
    cfg = get_config("qwen2.5-7b")
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    max_len = PROMPT + 64
    held = {}

    def session(s):
        """Session ``s``'s cache, prefilled from its own seed, and its
        first token; the previous session's cache is dropped first."""
        if s not in held:
            held.clear()
            cache = model.init_cache(1, max_len)
            logits, _ = model.prefill(params, prompt_batch(cfg.vocab_size, dev, seed=s),
                                      cache)
            held[s] = (cache, torch.argmax(logits[:, -1], -1, keepdim=True)
                       .to(torch.int32))
        return held[s]

    def arm(mode):
        def make(s):
            cache, tok = session(s)
            cache["pos"].fill_(PROMPT)      # both arms decode over one context
            run = model.step_program(params, cache).executor(mode)
            state = {"tokens": tok, "cache": cache}
            return lambda: run(state)["logits"]
        return make

    t0 = time.perf_counter()
    fc = floor_cell(cfg, GPU_H100, PROMPT)
    out = {"cell": f"qwen2.5-7b bf16 batch 1 ctx {PROMPT}",
           "floor_ms": fc.t_floor_ms, "n_sessions": AB_SESSIONS}
    for base in ("eager", "stage_jit"):
        ab = run_ab(arm(base), arm("full_jit"), n_sessions=AB_SESSIONS,
                    name=f"{base}/full_jit")
        summ = ab.summary()
        out[f"{base}_vs_full_jit"] = summ
        lo, hi = summ["speedup_ci95"]
        log(f"  {base} vs full_jit: {base} p50 mean {summ['baseline_mean_ms']:.4f} ms "
            f"(cv {summ['baseline_cv']:.4f}), full_jit {summ['treated_mean_ms']:.4f} ms "
            f"(cv {summ['treated_cv']:.4f}); paired speedup "
            f"{summ['mean_speedup']:.4f}x, 95% CI [{lo:.4f}, {hi:.4f}] over "
            f"{AB_SESSIONS} sessions; R_floor {fc.t_floor_ms / summ['baseline_mean_ms']:.4f}"
            f" / {fc.t_floor_ms / summ['treated_mean_ms']:.4f} ({base} / full_jit, "
            f"floor {fc.t_floor_ms:.4f} ms)")
        log("    per session (ms): " + ", ".join(
            f"{r['baseline_ms']:.4f} / {r['treated_ms']:.4f}" for r in summ["per_session"]))
    p50s = {"eager": out["eager_vs_full_jit"]["baseline_mean_ms"],
            "stage_jit": out["stage_jit_vs_full_jit"]["baseline_mean_ms"],
            "full_jit": stats.mean([out[k]["treated_mean_ms"] for k in
                                    ("eager_vs_full_jit", "stage_jit_vs_full_jit")])}
    out["p50_ms"] = p50s
    out["r_floor"] = {m: fc.t_floor_ms / p for m, p in p50s.items()}

    # identical greedy tokens over 16 steps, first-step logits; one
    # profiled step per arm.  The first call of a graph arm is its eager
    # warm-up and capture, so the steps compared are the calls after it:
    # replays of the graphs.
    cache, tok0 = session(0)
    toks, first, views = {}, {}, {}
    for mode in MODES:
        cache["pos"].fill_(PROMPT)
        run = model.step_program(params, cache).executor(mode)
        run({"tokens": tok0, "cache": cache})
        cache["pos"].fill_(PROMPT)
        tok, seq = tok0.clone(), []
        for i in range(16):
            logits = run({"tokens": tok, "cache": cache})["logits"]
            if i == 0:
                first[mode] = logits.float().clone()
            tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
            seq.append(int(tok))
        toks[mode] = seq
        cache["pos"].fill_(PROMPT)
        views[mode] = step_view(device_events(
            lambda: run({"tokens": tok0, "cache": cache})),
            ("decode_attention_mma", "int4_gemv", "rmsnorm_kernel"))
    for mode in MODES:
        v = views[mode]
        log(f"  {mode}: greedy tokens {toks[mode]}; one profiled step: "
            f"{v['kernels']} kernels (+{v['copies']} copies), {v['kernel_ms']:.4f} "
            f"ms summed, span {v['span_ms']:.4f} ms; in-step us per call "
            + ", ".join(f"{k} {u:.3f}" for k, u in v["us_per_call"].items()
                        if u is not None))
    same = all(toks[m] == toks["eager"] for m in MODES)
    scale = max(1.0, float(first["eager"].abs().max()))
    diffs = {m: float((first[m] - first["eager"]).abs().max()) for m in MODES}
    bit_equal = {m: bool(torch.equal(first[m], first["eager"])) for m in MODES}
    log(f"  greedy tokens over 16 steps {'identical' if same else 'DIFFER'} across "
        f"the arms; first-step logits (graph arms: a replay) against eager: "
        f"max_abs_diff {diffs}, "
        f"bit-equal {bit_equal} (tol {TOL[torch.bfloat16]} x {scale:.4g})")
    if not same:
        raise AssertionError("the dispatch arms' greedy tokens differ")
    if max(diffs.values()) > TOL[torch.bfloat16] * scale:
        raise AssertionError("the dispatch arms' first-step logits disagree")
    out.update(tokens_identical=same, first_logits_bit_equal=bit_equal,
               profiled_step=views, seconds=time.perf_counter() - t0)
    log(f"  phase 15 took {out['seconds']:.1f} s")
    held.clear()
    del params, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phases 9b, 16
TIER_POLICIES = ("prefer-device", "spill", "lookahead")
STATUSES = ("ok", "aborted", "failed", "expired")


def serve_sched(model, params, reqs, **kw):
    """A ``SlotScheduler`` over ``reqs``, run to the end: (scheduler,
    result)."""
    from repro_torch.serving import SlotScheduler
    sched = SlotScheduler(model, params, **kw)
    for r in reqs:
        sched.submit(r)
    return sched, sched.run()


def streams_of(res):
    return {sid: s.tokens.tolist() for sid, s in res.sessions.items()}


def check_balanced(sched, label):
    """Both pools balance once the prefix cache and the host prefix index
    are flushed: every device page free, no host blob left."""
    sched.flush_prefix_cache()
    sched.store.flush_host()
    free, host = sched.store.allocator.n_free, sched.store.host_used
    if free != sched.store.n_pages - 1 or host or sched._pressure_holds:
        raise AssertionError(f"{label}: pools do not balance ({free} of "
                             f"{sched.store.n_pages - 1} device pages free, "
                             f"{host} host blobs left)")


def check_recovered(res, vocab, label, baseline=None):
    """Accounting after a fault plan: every session has a terminal
    status, every token lies in the vocabulary (no token from a
    non-finite logit was emitted) and, given ``baseline``, every session
    that ended ok kept its stream and every other one a prefix of it."""
    for sid, s in res.sessions.items():
        toks = s.tokens.tolist()
        if s.status not in STATUSES:
            raise AssertionError(f"{label}: {sid} has status {s.status!r}")
        if any(not 0 <= t < vocab for t in toks):
            raise AssertionError(f"{label}: {sid} emitted a token outside "
                                 "the vocabulary")
        if baseline is not None:
            want = baseline[sid] if s.status == "ok" else baseline[sid][:len(toks)]
            if toks != want:
                raise AssertionError(f"{label}: {sid} ({s.status}) left the "
                                     "baseline stream")


def fault_plan_for(reqs):
    """What ``serve --fault-plan mixed`` builds for requests that all
    arrive at 0: 12 faults over every kind in 0.25 virtual seconds."""
    from repro_torch.serving import FaultInjector, FaultPlanConfig, generate_fault_plan
    plan = generate_fault_plan(FaultPlanConfig(seed=7, n_faults=12, horizon_s=0.25),
                               session_ids=[r.session_id for r in reqs])
    return FaultInjector(plan)


def log_recovery(res, where):
    log(f"  {where}: faults fired {res.fault_counts} ({res.faults_injected}); "
        f"save/restore retries {res.save_retries}/{res.restore_retries} "
        f"({res.retry_backoff_s * 1e3:.1f} ms virtual backoff), "
        f"{res.degraded_restores} degraded restores, {res.corrupt_blobs} "
        f"checksum rejects, {res.quarantines} quarantines, sessions "
        f"{res.aborted_sessions} aborted / {res.failed_sessions} failed / "
        f"{res.expired_sessions} expired; statuses "
        f"{ {sid: s.status for sid, s in res.sessions.items()} }")


@torch.inference_mode()
def check_f32_tier_tokens(dev):
    """Phase 9b: the host tier's arms at qwen2.5-7b width in f32, each
    stream held to the full-backing run's, then a seeded fault plan."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import mixed_requests
    from repro_torch.models.model import Model
    cfg = get_config("qwen2.5-7b").replace(n_layers=2, dtype="float32")
    reqs = mixed_requests(cfg, 6, base_prompt=100, base_new=24, seed=3)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 1
    cut = 14      # 13 pages: two sessions cannot both reach their budgets
    log(f"== phase 9b: the host KV tier inside the real path (qwen2.5-7b width, "
        f"2 layers, f32): 6 sessions through 2 paged slots, prefill chunk 64, "
        f"pool cut to {cut - 1} pages")
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(3))
    kw = dict(n_slots=2, max_len=max_len, paged=True, page_size=PAGE,
              prefill_chunk=64)
    tier = dict(n_pages=cut, kv_tier="host")
    int8 = dict(kv_dtype=torch.int8, steps_per_tick=4)
    arms = [("full backing, no tier", {}, None),
            ("cut pool, no tier (re-prefill)", dict(n_pages=cut), "f32")]
    arms += [(f"cut pool, host tier, {pol}", dict(tier, tier_policy=pol), "f32")
             for pol in TIER_POLICIES]
    arms += [("int8 KV, K=4, full backing", int8, None),
             ("int8 KV, K=4, cut pool, host tier, spill", dict(tier, **int8), "int8")]
    base = {}
    for label, arm, against in arms:
        sched, res = serve_sched(model, params, reqs, **kw, **arm)
        got = streams_of(res)
        if against is None:
            base["int8" if "kv_dtype" in arm else "f32"] = got
        same = got == base[against or ("int8" if "kv_dtype" in arm else "f32")]
        log(f"  {label}: {res.preemptions} preemptions, {res.prefill_tokens} "
            f"prefill tokens, pages spilled / restored {res.pages_spilled} / "
            f"{res.pages_restored}, {res.tier_restores} parked restores, "
            f"{res.host_prefix_hits} host prefix hits; {res.step_cache_size} "
            f"graph(s); streams {'equal the full-backing run' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"phase 9b, {label}: greedy streams differ from "
                                 "the full-backing run")
        if "n_pages" in arm and res.preemptions < 1:
            raise AssertionError(f"phase 9b, {label}: the cut pool preempted no one")
        if arm.get("tier_policy", "spill") != "prefer-device" and "kv_tier" in arm \
                and not (res.pages_spilled > 0 and res.tier_restores > 0):
            raise AssertionError(f"phase 9b, {label}: the tier moved no pages")
        if arm.get("tier_policy") == "prefer-device" and res.pages_spilled:
            raise AssertionError("phase 9b: prefer-device spilled pages")
        if "n_pages" in arm:
            check_balanced(sched, f"phase 9b, {label}")
    log(f"  int8 KV streams {'equal' if base['int8'] == base['f32'] else 'differ from'} "
        "the f32 KV streams (int8 arms are held to the int8 full-backing run)")
    sched, res = serve_sched(model, params, reqs, **kw, **tier, tier_policy="spill",
                             fault_injector=fault_plan_for(reqs), retry_budget=2,
                             self_audit=True)
    log_recovery(res, "seeded fault plan (seed 7, 12 faults, every kind) through "
                 "the spill arm, retry budget 2, self-audit")
    check_recovered(res, cfg.vocab_size, "phase 9b fault plan", base["f32"])
    if not res.faults_injected:
        raise AssertionError("phase 9b: the fault plan fired nothing")
    check_balanced(sched, "phase 9b fault plan")
    del params, model, sched
    torch.cuda.empty_cache()


class TierProbe:
    """Watches one tiered scheduler's store: device ms of every save and
    restore call (CUDA events around the store's page movers), host ms of
    every checksum, parks that copied, and for the first session restored
    from its parked copy whether the pages it lands in equal a device copy
    of its pages taken when it parked."""

    def __init__(self, sched):
        from repro_torch.serving.memory import tiers
        self.tiers, self.crc_fn = tiers, tiers.blob_checksum
        store = self.store = sched.store
        keys = sched.model._page_slab_keys(sched.cache)
        self.saves, self.restores, self.crc_ms = [], [], []
        self.parks, self.snap, self.checked = 0, {}, None
        save, restore, park, take = (store._save, store._restore, store.park,
                                     store.take_parked)

        def timed(fn, out):
            def run(cache, pages, *rest):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                got = fn(cache, pages, *rest)
                e.record()
                e.synchronize()
                out.append((len(pages), s.elapsed_time(e)))
                return got
            return run

        def park_(sid, n_full, pages, cache):
            snap = ({k: cache[k][:, list(pages[:n_full])].clone() for k in keys}
                    if self.checked is None and n_full else None)
            got = park(sid, n_full, pages, cache)
            if got is not None:
                self.parks += 1
                if snap is not None:
                    self.snap[sid] = snap
            return got

        def take_(sid, skip, pages, cache):
            got = take(sid, skip, pages, cache)
            if self.checked is None and sid in self.snap:
                equal = all(torch.equal(cache[k][:, list(pages)],
                                        self.snap[sid][k][:, skip:]) for k in keys)
                self.checked = (sid, len(pages), equal)
                self.snap.clear()
            return got

        def crc_(blob):
            t0 = time.perf_counter()
            c = self.crc_fn(blob)
            self.crc_ms.append((time.perf_counter() - t0) * 1e3)
            return c

        store._save, store._restore = timed(save, self.saves), timed(restore, self.restores)
        store.park, store.take_parked = park_, take_
        tiers.blob_checksum = crc_

    def close(self):
        self.tiers.blob_checksum = self.crc_fn
        self.snap.clear()


PCIE_GTS = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}   # GT/s a lane


def pcie_bound_gbs():
    """The host link's one-way rate (GB/s) from ``nvidia-smi``'s maximum
    PCIe generation and width: GT/s a lane x lanes x encoding / 8.
    (None, what it printed) when it reports no link."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    try:
        gen, width = (int(x) for x in smi.splitlines()[0].split(","))
        gts = PCIE_GTS[gen]
    except (IndexError, KeyError, ValueError):
        return None, f"nvidia-smi printed {smi!r}"
    enc = 0.8 if gen < 3 else 128 / 130
    return gts * width * enc / 8, f"PCIe gen {gen} x{width}"


def raw_copy(model, cache, prefill_wall_ms, n=128, reps=10):
    """``save_kv_blobs`` and ``restore_kv_blobs`` of ``n`` pages (one
    2048-token session) through a page-locked host pool, CUDA-event
    medians of ``reps``, against the host link's bound."""
    from repro_torch.serving.memory import (HostPagePool, blob_checksum,
                                            restore_kv_blobs, save_kv_blobs)
    pool = HostPagePool(n, pin_memory=True)
    pages = list(range(1, n + 1))
    blobs = save_kv_blobs(model.save_kv_pages, cache, pages, pool)
    nbytes = sum(c.numel() * c.element_size() for b in blobs for c in b)
    ms = {}
    for name, fn in (("save", lambda: save_kv_blobs(model.save_kv_pages, cache,
                                                    pages, pool)),
                     ("restore", lambda: restore_kv_blobs(model.restore_kv_pages,
                                                          cache, pages, blobs))):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        ms[name] = statistics.median(times)
    t0 = time.perf_counter()
    for b in blobs:
        blob_checksum(b)
    crc_ms = (time.perf_counter() - t0) * 1e3
    # the same bytes as one contiguous copy each way between a pinned
    # buffer and the card: what the link gives a copy with no gather
    flat = torch.empty(nbytes, dtype=torch.uint8, device=cache["k"].device)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    for name, dst, src in (("d2h", host, flat), ("h2d", flat, host)):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            dst.copy_(src, non_blocking=True)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        ms[f"bare_{name}"] = statistics.median(times)
    del flat, host
    bound, link = pcie_bound_gbs()
    out = {"pages": n, "bytes": nbytes, "crc_ms": crc_ms, "link": link,
           "link_bound_gbs": bound, "prefill_2048_wall_ms": prefill_wall_ms}
    for name, what in (("save", "save_kv_blobs (gather, D2H into pool rows)"),
                       ("restore", "restore_kv_blobs (H2D, index_copy_ into the pools)"),
                       ("bare_d2h", "one contiguous pinned D2H copy"),
                       ("bare_h2d", "one contiguous pinned H2D copy")):
        gbs = nbytes / ms[name] / 1e6
        out[f"{name}_ms"], out[f"{name}_gbs"] = ms[name], gbs
        share = (f"{gbs / bound:.1%} of the {bound:.2f} GB/s of {link}" if bound
                 else f"no link bound read: {link}")
        log(f"  raw {what} of {n} pages ({nbytes} B): {ms[name]:.4f} ms, "
            f"{gbs:.2f} GB/s ({share})")
    log(f"  CRC32 of the {n} blobs on the host: {crc_ms:.2f} ms; virtual charge "
        f"of one migration of {n} pages: {4 + n * 0.5:.1f} ms (4 ms launch tax + "
        f"0.5 ms a page); re-prefill of the same 2048 tokens: {prefill_wall_ms:.4f} ms "
        f"(phase 10's prefill wall)")
    return out


def log_probe(probe, label):
    for name, rows in (("park (save)", probe.saves), ("restore", probe.restores)):
        if rows:
            pages = sum(n for n, _ in rows)
            ms = sum(t for _, t in rows)
            log(f"    {name} copies: {len(rows)}, {pages} pages, {ms:.3f} ms device "
                f"({ms / pages * 1e3:.1f} us a page); each (pages, ms): "
                + ", ".join(f"({n}, {t:.3f})" for n, t in rows))
    if probe.crc_ms:
        log(f"    CRC32 on the host: {len(probe.crc_ms)} blobs, "
            f"{sum(probe.crc_ms):.2f} ms ({statistics.median(probe.crc_ms):.4f} ms a "
            "page, median)")
    charge = sum(4 + 0.5 * n for n, _ in probe.saves + probe.restores)
    log(f"    virtual charge of these copies: {charge:.1f} ms (4 ms + 0.5 ms a page "
        "per migration)")


@torch.inference_mode()
def tiered_serving(dev, prefill_wall_ms):
    """Phase 16: the host tier at qwen2.5-7b full width."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.launch.serve import mixed_requests
    from repro_torch.models.model import Model
    from repro_torch.serving import (SlotScheduler, generate_trace, poisson_config,
                                     slo_report)
    t_phase = time.perf_counter()
    cfg = get_config("qwen2.5-7b")

    def log_t(what):
        log(f"  ({what} {time.perf_counter() - t_phase:.1f} s into phase 16)")
    n_pages = 1 + 340      # about 2.5 of the sessions below
    log(f"== phase 16: the host KV tier at full width, qwen2.5-7b (28 layers, "
        f"bf16), 8 sessions through 4 paged slots, prompts {PROMPT}+, {NEW}+ new "
        f"tokens, page {PAGE}, prefill chunk 512, a pool of {n_pages - 1} pages, "
        "kv_tier host, spill")
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    reqs = mixed_requests(cfg, 8, base_prompt=PROMPT, base_new=NEW, seed=0)
    log_t("weights drawn")
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 1
    kw = dict(n_slots=4, max_len=max_len, paged=True, page_size=PAGE,
              n_pages=n_pages, prefill_chunk=512, kv_tier="host",
              tier_policy="spill")
    norms = 2 * cfg.n_layers + 1
    out = {"cells": {}}
    counts = {}
    budgets = {r.session_id: r.max_new_tokens for r in reqs}
    # the control arm on the same pool: the tier places nothing, so a
    # preempted session re-prefills its prompt and generated prefix
    sched, res = serve_sched(model, params, reqs, **dict(kw, tier_policy="prefer-device"))
    step_s = [t for s in res.sessions.values() for t in s.step_times_s]
    out["prefer_device"] = dict(p50_ms=statistics.median(step_s) * 1e3,
                                tok_s=res.tokens_per_s, preemptions=res.preemptions,
                                prefill_tokens=res.prefill_tokens, wall_s=res.wall_s)
    log(f"  bf16 KV, K=1, the same pool, prefer-device (no parking: preempted "
        f"sessions re-prefill): {res.run_tokens} tokens in {res.ticks} ticks, "
        f"{res.preemptions} preemptions, {res.prefill_tokens} prefill tokens, "
        f"{res.pages_spilled} pages spilled; p50 decode time per token "
        f"{out['prefer_device']['p50_ms']:.4f} ms, {res.tokens_per_s:.2f} tok/s over "
        f"{res.wall_s:.3f} s wall")
    if {sid: len(s.tokens) for sid, s in res.sessions.items()} != budgets \
            or res.pages_spilled:
        raise AssertionError("phase 16, prefer-device: sessions ended short or "
                             "pages were spilled")
    check_balanced(sched, "phase 16, prefer-device")
    del sched
    for label, kv_dtype, K in (("bf16 KV, K=1", None, 1), ("int8 KV, K=4", torch.int8, 4)):
        sched = SlotScheduler(model, params, kv_dtype=kv_dtype, steps_per_tick=K, **kw)
        probe = TierProbe(sched)
        for r in reqs:
            sched.submit(r)
        zero_counts()
        try:
            res = sched.run()
        finally:
            probe.close()
        got = launched()
        captured = dispatch.captured_launches.get("paged_decode_attention", 0)
        replayed = dispatch.replay_launches.get("paged_decode_attention", 0)
        rms_captured = dispatch.captured_launches.get("rmsnorm", 0)
        rms_replayed = dispatch.replay_launches.get("rmsnorm", 0)
        counts[label] = (got["paged_decode_attention"], got["rmsnorm"])
        step_s = [t for s in res.sessions.values() for t in s.step_times_s]
        p50 = statistics.median(step_s) * 1e3
        log(f"  {label}: {res.run_tokens} tokens in {res.ticks} ticks / "
            f"{res.dispatches} decode dispatches, {res.preemptions} preemptions, "
            f"{probe.parks} parks, {res.tier_restores} parked restores, pages "
            f"spilled / restored {res.pages_spilled} / {res.pages_restored}, "
            f"{res.prefill_tokens} prefill tokens; {res.step_cache_size} graph(s); "
            f"kernel-2 launches {got['paged_decode_attention']} ({K} x "
            f"{cfg.n_layers} x ({res.dispatches} replays + 1 warm-up)), rmsnorm "
            f"launches {got['rmsnorm']} (replays {rms_replayed} = {res.dispatches} "
            f"x {K} x {norms})")
        log(f"    p50 decode time per token {p50:.4f} ms (n={len(step_s)}), "
            f"{res.tokens_per_s:.2f} tok/s over {res.wall_s:.3f} s wall; host "
            f"{res.host_dispatch_s:.3f} s dispatching + {res.host_sync_s:.3f} s "
            "waiting for tokens")
        log_probe(probe, label)
        if {sid: len(s.tokens) for sid, s in res.sessions.items()} != budgets:
            raise AssertionError(f"phase 16, {label}: sessions ended short")
        if probe.parks < 3 or res.tier_restores < 3:
            raise AssertionError(f"phase 16, {label}: {probe.parks} parks and "
                                 f"{res.tier_restores} restores, want >= 3 each")
        if probe.checked is None or not probe.checked[2]:
            raise AssertionError(f"phase 16, {label}: restored pages differ from "
                                 f"the bytes parked ({probe.checked})")
        log(f"    first parked restore: {probe.checked[0]}, {probe.checked[1]} "
            "pages, torch.equal to the device copy taken at park")
        if (res.step_cache_size != 1 or captured != K * cfg.n_layers
                or replayed != res.dispatches * K * cfg.n_layers
                or rms_captured != K * norms
                or rms_replayed != res.dispatches * K * norms):
            raise AssertionError(f"phase 16, {label}: the captured step did not run "
                                 f"kernel 2 {cfg.n_layers} and kernel 5 {norms} "
                                 "times per device step")
        check_balanced(sched, f"phase 16, {label}")
        # the device's busy share over a second run of the same cell
        sched2 = SlotScheduler(model, params, kv_dtype=kv_dtype, steps_per_tick=K, **kw)
        for r in reqs:
            sched2.submit(r)
        t_rerun = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sched2.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
        log(f"    busy share {busy / wall:.1%} ({busy:.3f} s of device work, kernels "
            f"and copies, in a profiled rerun of {wall:.3f} s wall; the rerun and "
            f"its trace took {time.perf_counter() - t_rerun:.1f} s)")
        out["cells"][label] = dict(
            p50_ms=p50, tok_s=res.tokens_per_s, busy_share=busy / wall,
            parks=probe.parks, restores=res.tier_restores,
            pages_spilled=res.pages_spilled, pages_restored=res.pages_restored,
            save_ms=[t for _, t in probe.saves], save_pages=[n for n, _ in probe.saves],
            restore_ms=[t for _, t in probe.restores],
            restore_pages=[n for n, _ in probe.restores],
            crc_ms_total=sum(probe.crc_ms), preemptions=res.preemptions)
        if K == 1:
            out["raw_copy"] = raw_copy(model, sched.cache, prefill_wall_ms)
        del sched, sched2, probe
        torch.cuda.empty_cache()
        log_t(f"{label} done")

    sched, res = serve_sched(model, params, reqs, **kw,
                             fault_injector=fault_plan_for(reqs), retry_budget=2,
                             self_audit=True)
    log_recovery(res, "the same fault plan at full width (bf16 KV, K=1, spill)")
    check_recovered(res, cfg.vocab_size, "phase 16 fault plan")
    if set(res.sessions) != set(budgets):
        raise AssertionError("phase 16 fault plan: a session has no result")
    check_balanced(sched, "phase 16 fault plan")
    out["fault_counts"] = res.fault_counts
    del sched
    log_t("fault plan done")

    trace = generate_trace(poisson_config(seed=13, n_requests=16,
                                          vocab_size=cfg.vocab_size, rate_rps=50.0))
    tkw = dict(n_slots=4, max_len=trace.max_len() + 1, paged=True, page_size=PAGE,
               n_pages=1 + 7, kv_tier="host", tier_policy="spill")
    toks = {}
    for prio in (True, False):
        sched, res = serve_sched(model, params, trace.requests, **tkw,
                                 priority_preemption=prio)
        rep = slo_report(res, trace.classes)
        toks[prio] = streams_of(res)
        name = "priority" if prio else "youngest-first"
        log(f"  trace replay (poisson seed 13, 16 requests at 50 req/s, 4 slots, "
            f"7 pages, host tier), {name} preemption: {res.preemptions} "
            f"preemptions, {res.tier_restores} parked restores; ttft p50/p95/p99 "
            + "/".join(f"{rep['ttft'][q]:.4f}" for q in ("p50", "p95", "p99"))
            + " s, tpot p50/p95/p99 "
            + "/".join(f"{rep['tpot'][q]:.4f}" for q in ("p50", "p95", "p99"))
            + f" s (virtual); wall ttft p50 {rep['ttft_wall']['p50'] * 1e3:.2f} ms; "
            f"goodput under SLO {rep['goodput_tok_s']:.1f} tok/s "
            f"({rep['slo_sessions']}/{rep['sessions']} sessions in SLO, "
            f"{rep['tokens_per_s_virtual']:.1f} tok/s served)")
        for cname, c in rep["classes"].items():
            log(f"    class {cname}: {c['sessions']} sessions, slo_frac "
                f"{c['slo_frac']:.2f}, goodput {c['goodput_tok_s']:.1f} tok/s")
        check_recovered(res, cfg.vocab_size, f"phase 16 trace, {name}")
        check_balanced(sched, f"phase 16 trace, {name}")
        out[f"slo_{name}"] = rep
        del sched
    log(f"  greedy streams {'identical' if toks[True] == toks[False] else 'differ'} "
        "across the two preemption orders (bf16: a re-prefilled tail may round "
        "otherwise than the decode that wrote it)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 took {out['seconds']:.1f} s")
    del params, model
    torch.cuda.empty_cache()
    return counts, out


# ---------------------------------------------------------------- phases 9c, 17
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "qwen2-vl-2b", "musicgen-large")


def family_prompt(cfg, dev, n, seed):
    """The launcher's batch-1 prompt (``serve.prompt_batch``: tokens, 4
    codebooks for the audio arch, bf16 embeddings for the vlm), the vlm's
    positions made an image's: t, h and w differ (t == h == w would make
    M-RoPE plain RoPE)."""
    from repro_torch.launch.serve import prompt_batch
    batch = prompt_batch(cfg, 1, n, seed, dev)
    if "embeds" in batch:
        t = torch.arange(n, device=dev)
        batch["positions"] = torch.stack([t, t // 32, t % 32], dim=-1)[None]
    return batch


def check_f32_family_tokens(dev):
    """The same f32 weights, drawn once on the CPU, served on the card
    (kernels 1 and 5) and on the CPU (their plain versions), two layers
    at full width of each new family."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    prompt = 64
    log("== phase 9c: the moe, vlm and audio families inside the real path, card "
        f"against CPU: {', '.join(FAMILY_ARCHS)} width, 2 layers, f32, prompt "
        f"{prompt}, 16 tokens")
    t_phase = time.perf_counter()
    for name in FAMILY_ARCHS:
        cfg = get_config(name).replace(n_layers=2, dtype="float32")
        cpu_model = Model(cfg, device="cpu")
        t0 = time.perf_counter()
        cpu_params = cpu_model.init(torch.Generator().manual_seed(4))
        batch = family_prompt(cfg, "cpu", prompt, 4)
        out = {}
        for label, model, params in (
                ("cpu", cpu_model, cpu_params),
                ("cuda", Model(cfg, device=dev), to_device(cpu_params, dev))):
            b = {k: v.to(model.device) for k, v in batch.items()}
            eng = DecodeEngine(model, params)
            toks = eng.generate_streamed(b, max_len=prompt + 17, n_new=16).tokens
            with torch.inference_mode():
                _, cache = eng.prefill(b, prompt + 17)
                logits, _ = model.decode_step(params, cache, toks[:, :1])
            out[label] = (toks.cpu(), logits.float().cpu())
            del eng, cache
        same = torch.equal(out["cpu"][0], out["cuda"][0])
        diff = float((out["cuda"][1] - out["cpu"][1]).abs().max())
        scale = float(out["cpu"][1].abs().max())
        log(f"  {name} (2 layers, {time.perf_counter() - t0:.1f} s): greedy tokens "
            f"{tuple(out['cuda'][0].shape)} cuda "
            f"{out['cuda'][0][0].reshape(-1)[:16].tolist()}: "
            f"{'identical to' if same else 'DIFFER from'} cpu; first-step logits "
            f"{tuple(out['cuda'][1].shape)} max_abs_diff {diff:.4g}, max|logit| "
            f"{scale:.4g} (tol 1e-4 x max|logit|)")
        if not same or diff > 1e-4 * scale:
            raise AssertionError(f"{name}: card and CPU disagree")
        del cpu_params, out
        torch.cuda.empty_cache()
    log(f"  phase 9c took {time.perf_counter() - t_phase:.1f} s")


def first_step_cuda_vs_sdpa(model, engine, batch, max_len, tok):
    """First decode step's logits on the "cuda" route and the "sdpa"
    route from the same prefill: finite, and within 5e-2 x max|logit|
    where the two steps route every token to the same experts.  A moe
    layer's top-k is discontinuous: the two routes' bf16 roundings can
    move one choice, which changes the logits by more than rounding;
    there the steps must still agree on the argmax, and the count of
    layers that routed apart is logged (phase 9c holds the routes to
    each other in f32)."""
    from repro_torch.models import moe
    real = moe._route
    logits, routes = {}, {}
    try:
        with torch.inference_mode():
            for backend in ("cuda", "sdpa"):
                picked = routes[backend] = []

                def spy(p, xt, cfg, picked=picked):
                    out = real(p, xt, cfg)
                    picked.append(out[0].sort(dim=-1).values.clone())
                    return out
                moe._route = spy
                model.decode_backend = backend
                _, cache = engine.prefill(batch, max_len)
                picked.clear()          # the prefill's routes
                logits[backend], _ = model.decode_step(engine.params, cache, tok)
                logits[backend] = logits[backend].float()
                del cache
    finally:
        moe._route = real
        model.decode_backend = "cuda"
    if not all(bool(torch.isfinite(v).all()) for v in logits.values()):
        raise AssertionError("non-finite first-step logits")
    diff = float((logits["cuda"] - logits["sdpa"]).abs().max())
    scale = float(logits["sdpa"].abs().max())
    agree = torch.equal(logits["cuda"].argmax(-1), logits["sdpa"].argmax(-1))
    apart = sum(not torch.equal(a, b) for a, b in zip(routes["cuda"], routes["sdpa"]))
    where = (f"; the two steps routed apart in {apart} of {len(routes['cuda'])} moe "
             "layers" if routes["cuda"] else "")
    log(f"  first-step logits {tuple(logits['cuda'].shape)} cuda vs sdpa: "
        f"max_abs_diff {diff:.4g}, max|logit| {scale:.4g}, argmax "
        f"{'agrees' if agree else 'differs'}{where} (tol 5e-2 x max|logit| "
        "where no layer routed apart, else the argmax)")
    if (diff > 5e-2 * scale) if apart == 0 else not agree:
        raise AssertionError("bf16 first-step logits of cuda and sdpa disagree")


def family_batch1(dev, name):
    """Batch-1 decode of ``name`` at full width and depth (bf16, random
    weights drawn on the card) through the engine's graph step: the
    requests of phase 10, launch counts of kernels 1 and 5, streamed and
    fused tokens identical, p50 against the floor, prefill wall, first
    step cuda vs sdpa, device time per step.  Returns the model, its
    params, the counts and the numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.floor import floor_cell
    from repro_torch.core.hardware import GPU_H100
    from repro_torch.models.model import Model
    from repro_torch.quant import tree_weight_traffic
    from repro_torch.serving import DecodeEngine
    cfg = get_config(name)
    L = cfg.n_layers
    log(f"  -- {name} batch-1 ({cfg.family}, {L} layers, d_model {cfg.d_model}, "
        f"bf16), prompt {PROMPT}"
        + (f" x {cfg.n_codebooks} codebooks" if cfg.n_codebooks else "")
        + (" (bf16 embeddings, t/h/w positions)" if cfg.family == "vlm" else "")
        + f", {NEW} new tokens")
    model = Model(cfg, decode_backend="cuda", device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"  random weights drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    engine = DecodeEngine(model, params)
    batch = family_prompt(cfg, dev, PROMPT, 0)
    max_len = PROMPT + NEW + 1
    runs, launches = serve_graph_step(engine, batch, max_len)
    counts = {k: launches[k] for k in ("decode_attention", "rmsnorm", "int4_matmul")}
    steps = 3 * (NEW - 1)
    norms = 2 * L + 1
    want = dict(decode_attention=L * steps, rmsnorm=norms * (steps + 3), int4_matmul=0)
    log(f"  engine graph step: launches by the timed requests {counts}; want "
        f"decode_attention {L} x {steps} decode steps, rmsnorm {norms} x ({steps} "
        f"decode steps + 3 prefills): {want}")
    if counts != want:
        raise AssertionError(f"{name}: the main path's kernel launches {counts} "
                             f"differ from {want}")
    shape = (1, NEW, cfg.n_codebooks) if cfg.n_codebooks else (1, NEW)
    for i, r in enumerate(runs):
        if tuple(r.tokens.shape) != shape:
            raise AssertionError(f"request {i}: tokens {tuple(r.tokens.shape)}, "
                                 f"want {shape}")
    if not (torch.equal(runs[0].tokens, runs[1].tokens)
            and torch.equal(runs[0].tokens, runs[2].tokens)):
        raise AssertionError("streamed and fused greedy tokens differ")
    pre_ms = prefill_wall(engine, batch, max_len)
    step_s = runs[0].step_times_s + runs[1].step_times_s
    p50 = statistics.median(step_s) * 1e3
    tok = runs[0].tokens[:, :1]
    p50_eager = eager_p50(engine, batch, tok)
    fc = floor_cell(cfg, GPU_H100, PROMPT)
    streamed = tree_weight_traffic(engine.params)
    log(f"  tokens {shape}, streamed = fused; prefill of {PROMPT} tokens "
        f"{pre_ms:.4f} ms wall, median of 3")
    log(f"  p50 step {p50:.4f} ms (engine graph step, streamed, n={len(step_s)}); "
        f"eager p50 {p50_eager:.4f} ms (plain decode_step calls, measure_cell); "
        f"analytic floor {fc.t_floor_ms:.4f} ms (floor_cell {name}, {GPU_H100.name}, "
        f"ctx {PROMPT}); R_floor {fc.t_floor_ms / p50:.4f} (eager "
        f"{fc.t_floor_ms / p50_eager:.4f}); weights by tree_weight_traffic "
        f"{streamed / 1e9:.4f} GB, the floor's {fc.weight_bytes / 1e9:.4f} GB + KV "
        f"{fc.kv_bytes / 1e9:.4f} GB")
    log("  tok/s: " + ", ".join(f"{r.tokens_per_s:.2f}" for r in runs)
        + " (streamed, streamed, fused)")
    first_step_cuda_vs_sdpa(model, engine, batch, max_len, tok)
    busy, kernels = device_time(model, engine, batch, max_len, tok, p50, p50_eager)
    check_attention_kernels(kernels, L, f"{name} bf16 step")
    numbers = dict(graph_p50_ms=p50, eager_p50_ms=p50_eager, floor_ms=fc.t_floor_ms,
                   r_floor=fc.t_floor_ms / p50, r_floor_eager=fc.t_floor_ms / p50_eager,
                   device_ms=busy, busy_share=busy / p50,
                   kernels_per_step=sum(kernels.values()), prefill_ms=pre_ms,
                   tok_s=[r.tokens_per_s for r in runs], weight_bytes=streamed,
                   floor_weight_bytes=fc.weight_bytes)
    del engine
    torch.cuda.empty_cache()
    return model, params, counts, numbers


def moe_int4(dev, model, params):
    """qwen2-moe-a2.7b under int4_fused: one request through the engine's
    graph step; kernel 3 launches 7 x n_layers per step (attention and
    shared experts) and the dequantisation kernel 3 x n_layers (the
    expert stacks are multiplied by a bf16 copy, as in the reference);
    the eager p50; two eager decode steps profiled by kernel kind: 3 x
    n_layers dequantisation kernels a step and no uint8 / int8
    elementwise kernel (the eager chain the kernel replaced)."""
    from repro_torch.core.floor import floor_cell
    from repro_torch.core.hardware import GPU_H100
    from repro_torch.quant import tree_weight_traffic
    from repro_torch.serving import DecodeEngine
    cfg = model.cfg
    log(f"  -- {cfg.name} batch-1 int4_fused (quantised on the card)")
    t0 = time.perf_counter()
    engine = DecodeEngine(model, params, quant_path="int4_fused")
    torch.cuda.synchronize()
    log(f"  quantised in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    batch = family_prompt(cfg, dev, PROMPT, 0)
    max_len = PROMPT + NEW + 1
    engine.generate_streamed(batch, max_len=max_len, n_new=NEW)   # capture
    zero_counts()
    res = engine.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True)
    launches = launched()
    counts = {k: launches[k] for k in ("decode_attention", "rmsnorm", "int4_matmul",
                                       "dequantize")}
    per_step = 7 * cfg.n_layers
    stacks = 3 * cfg.n_layers
    norms = 2 * cfg.n_layers + 1
    want = dict(decode_attention=cfg.n_layers * (NEW - 1),
                rmsnorm=norms * NEW, int4_matmul=per_step * NEW, dequantize=stacks * NEW)
    log(f"  engine graph step: launches {counts}; want int4_matmul 7 x "
        f"{cfg.n_layers} and dequantize 3 x {cfg.n_layers} x ({NEW - 1} decode steps "
        f"+ the prefill): {want}")
    if counts != want:
        raise AssertionError(f"int4 {cfg.name}: launches {counts} differ from {want}")
    if tuple(res.tokens.shape) != (1, NEW):
        raise AssertionError(f"int4 tokens {tuple(res.tokens.shape)}")
    p50 = statistics.median(res.step_times_s) * 1e3
    tok = res.tokens[:, :1]
    p50_eager = eager_p50(engine, batch, tok)
    streamed = tree_weight_traffic(engine.params)
    fq = floor_cell(cfg, GPU_H100, PROMPT, weight_dtype_bytes=0.5)
    log(f"  p50 step {p50:.4f} ms (engine graph step, n={len(res.step_times_s)}; "
        f"169.4282 ms before the dequantisation kernel, PR 27); eager p50 "
        f"{p50_eager:.4f} ms; {res.tokens_per_s:.2f} tok/s; weights by "
        f"tree_weight_traffic {streamed / 1e9:.4f} GB (int4 codes and scales, plus "
        f"the bf16 copy of every expert stack written once and read once), "
        f"{streamed / (p50 * 1e-3) / 1e12:.3f} TB/s realised; int4 floor "
        f"{fq.t_floor_ms:.4f} ms ({fq.weight_bytes / 1e9:.4f} GB active weights), "
        f"R_floor {fq.t_floor_ms / p50:.4f}")
    with torch.inference_mode():
        cache = engine.new_cache(1, max_len)
        engine.model.prefill(engine.params, batch, cache)
        steps = 2

        def two_steps():
            for _ in range(steps):
                engine.model.decode_step(engine.params, cache, tok)
        total, count, top, kinds = top_device_ops(two_steps, n=100000)
    del cache
    per = {name: calls / steps for name, calls, _ in top}
    dq = sum(n for name, n in per.items() if "dequantize_kernel" in name)
    narrow = {name: n for name, n in per.items()
              if kernel_kind(name) == "uint8 / int8 elementwise"}
    log_profile(f"int4 moe eager decode step x {steps}",
                (total, count, top[:15], kinds))
    busy = total / steps
    log(f"  per decode step: {busy:.4f} ms of kernels = {busy / p50:.1%} of the graph "
        f"p50, {count / steps:.0f} kernels, {dq:.0f} dequantisation kernels (want "
        f"{stacks}), uint8 / int8 elementwise kernels {narrow or 'none'}")
    if dq != stacks or narrow:
        raise AssertionError(f"int4 moe step: {dq} dequantisation kernels a step "
                             f"(want {stacks}), uint8 / int8 elementwise {narrow}")
    del engine
    torch.cuda.empty_cache()
    return counts, dict(graph_p50_ms=p50, eager_p50_ms=p50_eager, weight_bytes=streamed,
                        floor_ms=fq.t_floor_ms, r_floor=fq.t_floor_ms / p50,
                        tok_s=res.tokens_per_s, device_ms=busy, busy_share=busy / p50,
                        kernels_per_step=count / steps, dequantize_per_step=dq,
                        ms_by_kind={k: v / steps for k, v in kinds.items()})


def moe_paged(dev, model, params):
    """qwen2-moe-a2.7b paged serving: the 8 sessions of phase 12 through 4
    paged slots, page 16, prefill chunk 512, bf16 KV, K=1; every session
    ends with its budget, the step is captured once and its replays
    launch kernel 2 once per layer and device step."""
    from repro_torch.core import dispatch
    from repro_torch.launch.serve import mixed_requests
    from repro_torch.serving import DecodeEngine
    cfg = model.cfg
    log(f"  -- {cfg.name} paged serving: 8 sessions through 4 slots, prompts "
        f"{PROMPT}+, {NEW}+ new tokens, page {PAGE}, prefill chunk 512, bf16 KV, K=1")
    reqs = mixed_requests(cfg, 8, base_prompt=PROMPT, base_new=NEW, seed=0)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 1
    engine = DecodeEngine(model, params)
    zero_counts()
    res = engine.generate_continuous(reqs, max_len=max_len, n_slots=4, paged=True,
                                     page_size=PAGE, prefill_chunk=512)
    launches = launched()
    replayed = dispatch.replay_launches.get("paged_decode_attention", 0)
    counts = {k: launches[k] for k in ("paged_decode_attention", "rmsnorm")}
    budgets = {r.session_id: r.max_new_tokens for r in reqs}
    got = {sid: len(s.tokens) for sid, s in res.sessions.items()}
    step_s = [t for s in res.sessions.values() for t in s.step_times_s]
    p50 = statistics.median(step_s) * 1e3
    log(f"  {len(res.sessions)} sessions, {res.run_tokens} tokens in {res.ticks} "
        f"ticks / {res.dispatches} decode dispatches, {res.preemptions} "
        f"preemptions, {res.prefill_tokens} prefill tokens; "
        f"{res.step_cache_size} CUDA graph(s); launches on the card {counts}, "
        f"the replays' paged kernels {replayed} ({cfg.n_layers} x "
        f"{res.dispatches})")
    log(f"  aggregate {res.tokens_per_s:.2f} tok/s over {res.wall_s:.3f} s wall; "
        f"p50 decode time per token {p50:.4f} ms (n={len(step_s)})")
    if got != budgets:
        raise AssertionError(f"moe paged: sessions ended short: {got} vs {budgets}")
    if res.step_cache_size != 1:
        raise AssertionError("moe paged: decode step not captured once")
    if replayed != res.dispatches * cfg.n_layers:
        raise AssertionError(f"moe paged: the replays launched the paged kernel "
                             f"{replayed} times, want {cfg.n_layers} per device step")
    del engine
    torch.cuda.empty_cache()
    return counts, dict(p50_ms_per_token=p50, tok_s=res.tokens_per_s,
                        preemptions=res.preemptions, dispatches=res.dispatches)


def free_card():
    """Collect what earlier phases left (an engine and its graph
    executors refer to each other, so their weights wait for the cycle
    collector) and return the cache to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def families_full_width(dev):
    free_card()
    log(f"== phase 17: the moe, vlm and audio families at full width (bf16, random "
        f"weights drawn on the card), prompt {PROMPT}, {NEW} new tokens; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated at the start")
    t_phase = time.perf_counter()
    counts, out = {}, {}
    model, params, counts["moe"], out["qwen2-moe-a2.7b bf16"] = family_batch1(
        dev, "qwen2-moe-a2.7b")
    counts["moe_int4"], out["qwen2-moe-a2.7b int4"] = moe_int4(dev, model, params)
    free_card()
    counts["moe_paged"], out["qwen2-moe-a2.7b paged"] = moe_paged(dev, model, params)
    del model, params
    free_card()
    for key, name in (("vlm", "qwen2-vl-2b"), ("audio", "musicgen-large")):
        model, params, counts[key], out[name] = family_batch1(dev, name)
        del model, params
        free_card()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17 took {out['seconds']:.1f} s")
    return counts, out


# ---------------------------------------------------------------- phase 18
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 2048, 3, 10
NORM_KEYS = ("norm1", "norm2", "final_norm")


def check_train_card_vs_cpu(dev):
    """18a: one train step's loss and grads at qwen2.5-3b width (2 layers,
    f32, remat blocks on the card), weights drawn on the CPU and copied
    over, against the CPU's (the plain versions of kernel 5 and of its
    backward).  The norms and biases are moved off their 1 / 0 init."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models.model import Model
    from repro_torch.training import DataCursor, synthetic_batch, trainable
    from repro_torch.training.tree import leaves_with_path, path_key
    seq = 128
    log(f"== phase 18a: one train step, card against CPU: {TRAIN_ARCH} width, 2 "
        f"layers, f32, batch 1, seq {seq} (grads per leaf within 1e-4 x max|g|)")
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).replace(n_layers=2, dtype="float32")
    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    for path, t in leaves_with_path(cpu_params):
        if path[-1] in NORM_KEYS + ("bq", "bk", "bv"):
            t.add_(0.1 * torch.randn(t.shape, generator=g))
    batch = synthetic_batch(cfg, DataCursor(5, 0), batch=1, seq_len=seq)
    out = {}
    for label, model, params in (
            ("cpu", cpu_model, cpu_params),
            ("cuda", Model(cfg, device=dev, remat="blocks"), to_device(cpu_params, dev))):
        params = trainable(params)
        b = {k: v.to(model.device) for k, v in batch.items()}
        fwd0, bwd0 = rms_ops.launches, rms_ops.bwd_launches
        loss, _ = model.loss(params, b)
        leaves = leaves_with_path(params)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out[label] = (float(loss.detach()), {path_key(p): gr.float().cpu()
                                    for (p, _), gr in zip(leaves, grads)},
                      rms_ops.launches - fwd0, rms_ops.bwd_launches - bwd0)
        del params, grads
    (l_cpu, g_cpu, _, _), (l_cuda, g_cuda, fwd, bwd) = out["cpu"], out["cuda"]
    worst, worst_key, norm_min = 0.0, None, float("inf")
    for key, want in g_cpu.items():
        rel = float((g_cuda[key] - want).abs().max()) / float(want.abs().max())
        if rel > worst:
            worst, worst_key = rel, key
        if key.rsplit("/", 1)[-1] in NORM_KEYS:
            norm_min = min(norm_min, float(g_cuda[key].abs().max()))
    log(f"  loss cpu {l_cpu:.6f}, cuda {l_cuda:.6f}; {len(g_cpu)} grad leaves, worst "
        f"max|diff| / max|g| {worst:.3g} ({worst_key}); smallest max|g| of a norm "
        f"weight {norm_min:.3g}; kernel 5 on the card: {fwd} forward launches "
        f"(remat: 2 a layer twice, and the final norm), {bwd} backward launches "
        f"({time.perf_counter() - t0:.1f} s)")
    if worst > 1e-4 or abs(l_cuda - l_cpu) > 1e-5 * abs(l_cpu):
        raise AssertionError("18a: the card's train step disagrees with the CPU's")
    if not norm_min > 0:
        raise AssertionError("18a: a norm weight got no gradient on the card")
    if bwd != 2 * cfg.n_layers + 1 or fwd != 4 * cfg.n_layers + 1:
        raise AssertionError(f"18a: kernel 5 launched {fwd} forward, {bwd} backward")
    return dict(worst_rel=worst, loss_cpu=l_cpu, loss_cuda=l_cuda)


def check_train_restart(dev):
    """18b: the reduced config through run_training on the card (the
    captured step), preempted at step 3 and restored from the step-2
    checkpoint: the final loss must be bit-equal to a clean run's."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.training import (AdamW, DataLoader, Preemption, jit_train_step,
                                      make_train_step, run_training, trainable)
    log(f"== phase 18b: {TRAIN_ARCH} reduced (bf16) through run_training on the "
        "card, captured step, a Preemption at step 3, 6 steps, checkpoint every 2")
    cfg = get_config(TRAIN_ARCH).reduced()
    model = Model(cfg, device=dev)
    opt = AdamW(lr=1e-3)

    def run(ckpt_dir, hook=None):
        def init():
            params = trainable(model.init(torch.Generator(device=dev).manual_seed(0)))
            return (params, opt.init(params))
        return run_training(
            train_step=jit_train_step(make_train_step(model, opt, remat="blocks")),
            init_state=init, loader=DataLoader(cfg, batch=2, seq_len=64, seed=5,
                                               device=dev),
            ckpt_dir=ckpt_dir, total_steps=6, ckpt_every=2, failure_hook=hook)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    armed = [True]

    def boom(step):
        if step == 3 and armed[0]:
            armed[0] = False
            raise Preemption(step)
    try:
        clean = run(f"{tmp}/clean")
        faulty = run(f"{tmp}/faulty", boom)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = clean.metrics_history[-1]["loss"], faulty.metrics_history[-1]["loss"]
    log(f"  clean losses {[round(m['loss'], 5) for m in clean.metrics_history]}; "
        f"preempted run: {faulty.restarts} restart, {len(faulty.metrics_history)} "
        f"steps run, final loss {b!r} vs clean {a!r}: "
        f"{'bit-equal' if a == b else 'DIFFER'}")
    if faulty.restarts != 1 or a != b:
        raise AssertionError("18b: the restarted run's final loss differs")
    return dict(final_loss=a, restarts=faulty.restarts)


KERNEL_KINDS = (("dequantize", ("dequantize_kernel",)), ("kernel 3", ("int4_",)),
                ("kernel 1", ("decode_attention",)), ("kernel 2", ("paged_attention",)),
                ("kernel 4", ("ssd_update",)), ("kernel 5", ("rmsnorm",)),
                ("f32 GEMMs", ("f32f32", "sgemm")),
                ("bf16 GEMMs", ("gemm", "nvjet", "cutlass")),
                # int8 is ``signed char`` in a kernel's template arguments
                ("uint8 / int8 elementwise", ("unsigned char", "signed char")),
                ("softmax", ("softmax",)), ("reductions", ("reduce",)),
                ("elementwise and casts", ("elementwise", "copy", "fill")))


def kernel_kind(name: str) -> str:
    """The kind of a kernel, by its name: the first of KERNEL_KINDS whose
    keys it holds (f32 GEMMs: the attention's f32 einsums)."""
    low = name.lower()
    return next((kind for kind, keys in KERNEL_KINDS if any(k in low for k in keys)),
                "other")


def top_device_ops(fn, n=15, pick=()):
    """One call of ``fn`` under torch.profiler: (kernel ms summed, kernels
    launched, the n kernels with the most device time as (name, calls,
    ms), ms by ``kernel_kind``), and with ``pick`` a fifth item: (calls,
    ms) of the kernels whose names hold one of ``pick``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    kinds = {}
    for e in events:
        kind = kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    total = sum(e.self_device_time_total for e in events) / 1e3
    out = (total, sum(e.count for e in events),
           [(e.key, e.count, e.self_device_time_total / 1e3) for e in events[:n]],
           kinds)
    if not pick:
        return out
    picked = [e for e in events if any(k in e.key for k in pick)]
    return out + ((sum(e.count for e in picked),
                   sum(e.self_device_time_total for e in picked) / 1e3),)


def log_profile(label, prof):
    total, count, top, kinds = prof
    log(f"  {label}: {total:.2f} ms of kernels, {count} kernels; by kind: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    for name, calls, ms in top:
        log(f"    {ms:9.3f} ms {calls:5d}x {name[:90]}")


def event_ms(fn, reps=3) -> float:
    """CUDA-event median (ms) of ``reps`` synchronised calls of ``fn``."""
    ms = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
        del out
    return statistics.median(ms)


def spread(walls):
    return dict(p50_ms=statistics.median(walls), min_ms=min(walls), max_ms=max(walls))


def train_full_width(dev):
    """18c: qwen2.5-3b at full width and depth in bf16, batch 1, seq 2048,
    remat blocks: TRAIN_WARMUP + TRAIN_STEPS eager steps, then the same
    batches from the same initial state through jit_train_step (the
    first call a real step and the capture, the rest replays)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import GPU_H100
    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import Model
    from repro_torch.training import (AdamW, DataCursor, cosine_schedule,
                                      jit_train_step, make_train_step,
                                      synthetic_batch, trainable)
    from repro_torch.training.tree import tree_leaves, tree_unflatten
    free_card()
    n = TRAIN_WARMUP + TRAIN_STEPS
    log(f"== phase 18c: training {TRAIN_ARCH} at full width (36 layers, bf16, random "
        f"weights drawn on the card), batch 1, seq {TRAIN_SEQ}, remat blocks, AdamW; "
        f"{TRAIN_WARMUP} + {TRAIN_STEPS} steps eager, then the same {n} batches "
        "through jit_train_step (one CUDA graph a step)")
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg, device=dev)
    opt = AdamW(lr=cosine_schedule(3e-4, 2, 4 * n))
    step = make_train_step(model, opt, remat="blocks")

    def init():
        params = trainable(model.init(torch.Generator(device=dev).manual_seed(0)))
        return (params, opt.init(params))
    batches = [synthetic_batch(cfg, DataCursor(7, i), batch=1, seq_len=TRAIN_SEQ,
                               device=dev) for i in range(n)]
    out = {"tokens_per_step": TRAIN_SEQ}

    def arm(fn, label):
        state = init()
        if "n_params" not in out:
            out["n_params"] = sum(t.numel() for t in tree_leaves(state[0]))
        torch.cuda.reset_peak_memory_stats(dev)
        losses, walls, per_step = [], [], None
        for i, b in enumerate(batches):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fn(state, b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            if i == 1:
                per_step = {k: v - before[k] for k, v in launch_counts().items()
                            if v != before[k]}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        res = dict(spread(walls[TRAIN_WARMUP:]), first_ms=walls[0], peak_gb=peak,
                   losses=losses)
        res["tok_s"] = TRAIN_SEQ / (res["p50_ms"] / 1e3)
        res["mfu"] = 6 * out["n_params"] * TRAIN_SEQ / (res["p50_ms"] / 1e3) / \
            GPU_H100.peak_flops_bf16
        log(f"  {label}: step p50 {res['p50_ms']:.2f} ms (min {res['min_ms']:.2f}, max "
            f"{res['max_ms']:.2f}, first {walls[0]:.1f}) over steps {TRAIN_WARMUP + 1}-{n}; "
            f"{res['tok_s']:.1f} tokens/s, MFU {100 * res['mfu']:.2f}% (6 N T / step / "
            f"989e12, N {out['n_params']}); peak allocated {peak:.2f} GB")
        log(f"  {label} losses {[round(x, 5) for x in losses]}")
        return state, res, per_step

    state, out["eager"], per_step = arm(step, "eager")
    out["eager_launches_per_step"] = per_step
    log(f"  eager step's kernel launches: {per_step} (kernel 5 forward: 2 a layer, "
        "recomputed under remat, and the final norm; backward: 2 a layer and the final)")
    b = synthetic_batch(cfg, DataCursor(7, n), batch=1, seq_len=TRAIN_SEQ, device=dev)
    prof = top_device_ops(lambda: step(state, b), pick=("rmsnorm_bwd",))
    log_profile("profiled eager step", prof[:4])
    out["eager_kernel_ms"], out["eager_kernels"], out["eager_top_ops"], \
        out["eager_ms_by_kind"], (calls, ms) = prof
    out["norm_bwd_in_step"] = dict(launches=calls, device_us=ms * 1e3,
                                   device_us_a_launch=ms * 1e3 / max(calls, 1))
    log(f"  kernel 5's backward in the profiled eager step: {calls} launches, "
        f"{ms * 1e3:.2f} us of device time ({ms * 1e3 / max(calls, 1):.2f} us a launch)")
    # the step's two halves alone: forward + backward, and the AdamW update
    params, opt_state = state
    leaves = tree_leaves(params)

    def fwd_bwd():
        loss, _ = model.loss(params, b)
        return torch.autograd.grad(loss, leaves)
    grads = tree_unflatten(params, list(fwd_bwd()))
    out["fwd_bwd_ms"] = event_ms(fwd_bwd)
    out["adamw_ms"] = event_ms(lambda: opt.update(grads, opt_state, params))
    prof = top_device_ops(lambda: opt.update(grads, opt_state, params), n=6)
    log(f"  forward + backward {out['fwd_bwd_ms']:.2f} ms, AdamW update "
        f"{out['adamw_ms']:.2f} ms (CUDA events, median of 3)")
    log_profile("profiled AdamW update", prof)
    out["adamw_kernel_ms"], out["adamw_kernels"], _, out["adamw_ms_by_kind"] = prof
    del state, params, opt_state, leaves, grads
    free_card()
    jstep = jit_train_step(step)
    state, out["graph"], _ = arm(jstep, "graph (jit_train_step)")
    total = top_device_ops(lambda: jstep(state, b))[0]
    out["graph_kernel_ms"] = total
    out["graph_busy"] = total / out["graph"]["p50_ms"]
    log(f"  profiled graph replay: {total:.2f} ms of kernels, busy "
        f"{100 * out['graph_busy']:.1f}% of the graph p50")
    le, lg = out["eager"]["losses"], out["graph"]["losses"]
    if not all(np.isfinite(le)) or le != lg:
        raise AssertionError(f"18c: losses not finite or unequal: {le} vs {lg}")
    log(f"  losses of both arms finite and equal, step for step ({n} steps)")
    del state, jstep
    free_card()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 18c took {out['seconds']:.1f} s")
    MEASURED["qwen2.5-3b train graph step p50 ms"] = out["graph"]["p50_ms"]
    MEASURED["qwen2.5-3b AdamW ms"] = out["adamw_ms"]
    return out


def training(dev):
    """Phase 18; returns (kernel launches of the full-width run, by
    kernel, the phase's numbers)."""
    out = {"card_vs_cpu": check_train_card_vs_cpu(dev),
           "restart": check_train_restart(dev)}
    zero_counts()
    out["full_width"] = train_full_width(dev)
    return launched(), out


# ---------------------------------------------------------------- phase 19
DIST_WARMUP, DIST_STEPS = 3, 5
DIST_DECODE_ARCH, DIST_DECODE_LAYERS, DIST_CTX, DIST_PROMPT = "qwen2.5-7b", 2, 1024, 512
DIST_LOSS_TOL = 0.0     # relative, step for step: a 1x1 mesh runs the same kernels


def dist_start(dev):
    """A world-1 NCCL group on an in-process store (no environment, no
    port, no subprocess) and a 1x1 (data, model) mesh over it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    return make_test_mesh(data=1, model=1, device_type="cuda")


def dtensor_case(name, got, want, placements):
    """``got`` must be a DTensor with ``placements`` whose value is
    ``torch.equal`` to the plain call's ``want``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(got, DTensor) or tuple(got.placements) != tuple(placements):
        raise AssertionError(f"19a {name}: want a DTensor {placements}, got "
                             f"{type(got).__name__} {getattr(got, 'placements', None)}")
    local = got.to_local()
    if not torch.equal(local, want):
        raise AssertionError(f"19a {name}: not equal to the plain call, max |diff| "
                             f"{float((local.float() - want.float()).abs().max())}")
    return {"case": name, "placements": [str(p) for p in placements], "equal": True}


def check_dtensor_wrappers(dev, mesh):
    """19a: the five wrappers (and RMSNorm's backward under grad) on
    DTensors at main-path shapes, with the placements the plan gives
    their inputs (batch rows over data, weights' columns over model, a
    B=1 cache's sequence over data and model, pools' pages over data),
    and with a reduced dim split (gathered first).  Each output
    ``torch.equal`` to the plain-tensor call's, with the placements the
    wrapper's rule gives."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.int4_matmul import ops as i4
    from repro_torch.kernels.paged_decode_attention import ops as pda
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.ssd_update import ops as ssd
    log("== phase 19a: the five kernel wrappers on DTensors (1x1 mesh), each "
        "output torch.equal to the plain call's")
    R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)

    def put(t, *pl):
        return None if t is None else distribute_tensor(t, mesh, list(pl))
    bf = torch.bfloat16
    cases = []
    # kernel 1: qwen2.5-7b decode shape, B=1 cache split over the sequence
    q, k, v, mask = attention_case(dev, bf, 1, 28, 4, 128, 2048,
                                   torch.arange(2048) < 1500, 31)
    want = da.decode_attention(q, k, v, mask)
    for qp, kp, outp in (((S0, R), (S1, S1), (S0, R)), ((R, R), (R, R), (R, R)),
                         ((R, S1), (R, S2), (R, S1))):
        got = da.decode_attention(put(q, *qp), put(k, *kp), put(v, *kp),
                                  put(mask, R, R))
        cases.append(dtensor_case(f"decode_attention q{qp} kv{kp}", got, want, outp))
    # kernel 2: the paged serving shape, bf16 and int8 pools
    for quant in (False, True):
        q, k, v, bt, lens, ks, vs = paged_case(dev, bf, quant, [2100, 7, 0, 1300],
                                               16, 2112, 32)
        want = pda.paged_decode_attention(q, k, v, bt, lens, ks, vs)
        for qp, pp in (((S0, R), (S0, S1)), ((R, S1), (R, S2))):
            got = pda.paged_decode_attention(
                put(q, *qp), put(k, *pp), put(v, *pp), put(bt, qp[0], R),
                put(lens, qp[0], R), put(ks, *pp), put(vs, *pp))
            cases.append(dtensor_case(f"paged_decode_attention int8={quant} "
                                      f"q{qp} pools{pp}", got, want, qp))
    # kernel 3: the GEMV (M=1) and the wgmma path (M=512), wq's shape
    for M in (1, 512):
        x, packed, scales = int4_case(dev, bf, M, 3584, 3584, 33)
        want = i4.int4_matmul(x, packed, scales)
        for xp, wp, outp in (((S0, R), (R, S1), (S0, S1)), ((R, S1), (S0, R), (R, R))):
            got = i4.int4_matmul(put(x, *xp), put(packed, *wp), put(scales, *wp))
            cases.append(dtensor_case(f"int4_matmul M={M} x{xp} w{wp}", got, want, outp))
    # kernel 4: the mamba2-2.7b decode shape, in place on a split state
    h, x, dt, A, Bm, Cm = ssd_case(dev, torch.float32, 1, 80, 64, 128, 1, 34)
    want_h, want_y = ssd.ssd_update(h.clone(), x, dt, A, Bm, Cm)
    for hp in ((S0, S1), (R, R)):
        hd_ = put(h.clone(), *hp)
        got_h, got_y = ssd.ssd_update(hd_, put(x, *hp), put(dt, *hp),
                                      put(A, R, S0 if hp[1] == S1 else R),
                                      put(Bm, hp[0], R), put(Cm, hp[0], R), out=hd_)
        cases.append(dtensor_case(f"ssd_update h{hp} (out=h)", got_h, want_h, hp))
        cases.append(dtensor_case(f"ssd_update y h{hp}", got_y, want_y, hp))
        if got_h is not hd_:
            raise AssertionError("19a ssd_update: out= was not returned")
    # kernel 5, forward and backward under grad: prompt rows at D=2048
    x, w = norm_case(dev, bf, 2048, 2048, 35)
    xs = x.reshape(1, 2048, 2048)
    dy = torch.randn_like(xs)
    want = rn.rmsnorm(xs, w)
    want_dx, want_dw = rn.rmsnorm_bwd(xs, w, dy)
    P = Partial()
    # dw of rows split over a mesh dim is the ranks' sum there: Partial
    for xp, outp, dwp in (((S0, R), (S0, R), (P, R)), ((R, S1), (R, S1), (R, P)),
                          ((R, S2), (R, R), (R, R))):
        cases.append(dtensor_case(f"rmsnorm x{xp}", rn.rmsnorm(put(xs, *xp), put(w, R, R)),
                                  want, outp))
        xd = put(xs, *xp).requires_grad_(True)
        wd = put(w, R, R).requires_grad_(True)
        y = rn.rmsnorm(xd, wd)
        dx, dw = torch.autograd.grad(y, (xd, wd), put(dy, *outp))
        cases.append(dtensor_case(f"rmsnorm grad dx x{xp}", dx, want_dx, xp))
        cases.append(dtensor_case(f"rmsnorm grad dw x{xp}", dw, want_dw, dwp))
    log(f"  {len(cases)} cases equal, outputs DTensors with the rule's placements")
    return cases


def dist_decode(dev, mesh):
    """19b: a 2-layer decode step at qwen2.5-7b width in bf16, params
    planned by ``params_shardings`` and the B=1 cache by
    ``cache_shardings`` (the sequence over data and model), under
    ``activation_hints``; logits equal to the plain step's; kernel 1
    twice a step (wrapper count and profiler)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.hints import activation_hints
    from repro_torch.models.model import Model
    cfg = get_config(DIST_DECODE_ARCH).replace(n_layers=DIST_DECODE_LAYERS)
    log(f"== phase 19b: {DIST_DECODE_ARCH} width, {cfg.n_layers} layers, bf16 decode "
        f"step on DTensors (B=1 cache of {DIST_CTX} split over the sequence) "
        "against the plain step")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, DIST_PROMPT),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    with torch.no_grad():
        cache = model.init_cache(1, DIST_CTX)
        _, cache = model.prefill(params, {"tokens": tokens}, cache)
        plain_cache = {k: v.clone() for k, v in cache.items()}
        tok = tokens[:, -1:]
        want, _ = model.decode_step(params, plain_cache, tok)
    plan = shd.make_plan(cfg, mesh)
    layouts = shd.cache_shardings(plan, cache)
    pd = shd.distribute(params, shd.params_shardings(plan, params))
    cd = shd.distribute(cache, layouts)
    zero_counts()
    with torch.no_grad(), activation_hints(mesh):
        got, _ = model.decode_step(pd, cd, tok)
    counts = launched()
    if counts["decode_attention"] != cfg.n_layers:
        raise AssertionError(f"19b: kernel 1 launched {counts['decode_attention']} "
                             f"times, want {cfg.n_layers}")
    got = got.full_tensor()
    if not torch.equal(got, want):
        raise AssertionError("19b: DTensor logits differ from the plain step's, max "
                             f"|diff| {float((got.float() - want.float()).abs().max())}")
    kd = cd["k"].full_tensor()
    if not torch.equal(kd, plain_cache["k"]):
        raise AssertionError("19b: the DTensor cache's new rows differ")
    with torch.no_grad(), activation_hints(mesh):
        prof = top_device_ops(lambda: model.decode_step(pd, cd, tok), n=60)
    n_k1 = sum(calls for name, calls, _ in prof[2] if "decode_attention_mma" in name)
    if n_k1 != cfg.n_layers:
        raise AssertionError(f"19b: profiler saw {n_k1} kernel-1 launches, want "
                             f"{cfg.n_layers}")
    out = {"arch": DIST_DECODE_ARCH, "layers": cfg.n_layers, "ctx": DIST_CTX,
           "cache_spec": [str(x) for x in layouts["k"].spec],
           "cache_placements": [str(p) for p in layouts["k"].placements],
           "logits_equal": True, "kernel1_per_step": n_k1, "counts": counts}
    log(f"  logits and cache torch.equal to the plain step's; cache spec "
        f"{out['cache_spec']} -> {out['cache_placements']}; kernel 1 {n_k1}x a step "
        f"(profiler), wrapper counts {counts}")
    del model, params, pd, cd, cache, plain_cache
    free_card()
    return counts, out


def dist_train(dev, mesh):
    """19c: qwen2.5-3b full width and depth, bf16, batch 1, seq 2048,
    remat blocks, uncaptured: the plain step, then the same batches from
    the same seed through the plan's DTensors under activation_hints.
    Each arm's state is freed before the next is built."""
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import GPU_H100
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.hints import activation_hints
    from repro_torch.launch.train import state_shardings
    from repro_torch.models.model import Model
    from repro_torch.training import (AdamW, DataCursor, cosine_schedule,
                                      make_train_step, synthetic_batch, trainable)
    from repro_torch.training.tree import tree_leaves
    free_card()
    n = DIST_WARMUP + DIST_STEPS
    log(f"== phase 19c: training {TRAIN_ARCH} at full width (36 layers, bf16), batch 1, "
        f"seq {TRAIN_SEQ}, remat blocks, {DIST_WARMUP} + {DIST_STEPS} uncaptured steps: "
        "plain tensors, then the plan's DTensors on the 1x1 mesh")
    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg, device=dev)
    opt = AdamW(lr=cosine_schedule(3e-4, 2, 4 * n))
    step = make_train_step(model, opt, remat="blocks")
    plan = shd.make_plan(cfg, mesh)
    batches = [synthetic_batch(cfg, DataCursor(7, i), batch=1, seq_len=TRAIN_SEQ,
                               device=dev) for i in range(n)]
    out, counts = {}, {}

    def arm(sharded):
        params = trainable(model.init(torch.Generator(device=dev).manual_seed(0)))
        state = (params, opt.init(params))
        n_params = sum(t.numel() for t in tree_leaves(params))
        if sharded:
            state = shd.distribute(state, state_shardings(plan, state))
        del params
        free_card()
        torch.cuda.reset_peak_memory_stats(dev)
        ctx = activation_hints(mesh) if sharded else contextlib.nullcontext()
        losses, walls, per_step = [], [], None
        zero_counts()
        with ctx:
            for i, b in enumerate(batches):
                if sharded:
                    b = shd.distribute(b, shd.batch_shardings(plan, b))
                before = launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, b)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
                if i == 1:
                    per_step = {k: v - before[k] for k, v in launch_counts().items()
                                if v != before[k]}
        arm_counts = launched()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        res = dict(spread(walls[DIST_WARMUP:]), first_ms=walls[0], peak_gb=peak,
                   losses=losses, launches_per_step=per_step)
        res["mfu"] = 6 * n_params * TRAIN_SEQ / (res["p50_ms"] / 1e3) / \
            GPU_H100.peak_flops_bf16
        label = "DTensor" if sharded else "plain"
        log(f"  {label}: step p50 {res['p50_ms']:.2f} ms (min {res['min_ms']:.2f}, max "
            f"{res['max_ms']:.2f}, first {walls[0]:.1f}) over steps {DIST_WARMUP + 1}-{n}; "
            f"MFU {100 * res['mfu']:.2f}%; peak allocated {peak:.2f} GB; kernel launches "
            f"a step {per_step}")
        log(f"  {label} losses {losses}")
        del state
        free_card()
        return res, arm_counts

    out["plain"], _ = arm(False)
    out["dtensor"], counts = arm(True)
    lp, ld = out["plain"]["losses"], out["dtensor"]["losses"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(lp, ld))
    out["loss_max_rel_diff"] = rel
    out["loss_tol"] = DIST_LOSS_TOL
    if not all(np.isfinite(ld)) or rel > DIST_LOSS_TOL:
        raise AssertionError(f"19c: losses differ beyond {DIST_LOSS_TOL}: {lp} vs {ld}")
    out["dtensor_over_plain"] = out["dtensor"]["p50_ms"] / out["plain"]["p50_ms"]
    log(f"  losses equal step for step within {DIST_LOSS_TOL} relative (max relative "
        f"difference {rel}); DTensor p50 / plain p50 {out['dtensor_over_plain']:.3f}")
    del model
    free_card()
    return counts, out


def dist_launcher():
    """19d: ``repro_torch.launch.train.main`` in-process with and without
    ``--distributed`` on the phase's group; the loss lines must match."""
    from repro_torch.launch import train
    argv = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "20"]
    log(f"== phase 19d: launch.train.main({argv} [+ --distributed]) in-process")
    lines = {}
    for label, extra in (("plain", []), ("distributed", ["--distributed"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(argv + extra)
        text = buf.getvalue().strip().splitlines()
        lines[label] = text
        log(f"  {label}: {text}")
    if lines["plain"][-1] != lines["distributed"][-1]:
        raise AssertionError(f"19d: loss lines differ: {lines}")
    return {"plain": lines["plain"][-1], "distributed": lines["distributed"][-1],
            "equal": True}


def distributed(dev):
    """Phase 19; returns (kernel launches of 19b and 19c's DTensor arm,
    the phase's numbers).  The group is destroyed at the end."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    log("== phase 19: the multi-device runtime on DTensor (world-1 NCCL group on "
        "an in-process store, 1x1 (data, model) mesh)")
    mesh = dist_start(dev)
    try:
        out = {"wrappers": check_dtensor_wrappers(dev, mesh)}
        decode_counts, out["decode"] = dist_decode(dev, mesh)
        train_counts, out["train"] = dist_train(dev, mesh)
        out["launcher"] = dist_launcher()
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19 took {out['seconds']:.1f} s")
    return {"decode": decode_counts, "train": train_counts}, out


# ---------------------------------------------------------------- phase 20
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", "pod"),
                ("qwen2.5-3b", "decode_32k", "multipod"),
                ("llama4-scout-17b-a16e", "decode_32k", "pod"),
                ("mamba2-2.7b", "long_500k", "pod"),
                # the moe token reshapes on an FSDP data split (2 rows a rank)
                ("llama4-scout-17b-a16e", "train_4k", "pod"))
DRYRUN_TIMEOUT_S = 600
MEASURED = {}   # phase 10's and 18c's numbers, read by phase 20b


def dry_run_cells():
    """20a: ``python -m repro_torch.launch.dryrun`` on DRYRUN_CELLS in a
    subprocess of its own (a fake world of 256 / 512 ranks is
    process-global and cannot share a process with phase 19's group);
    every cell must end ``ok``.  Returns each cell's numbers."""
    out_dir = ROOT / "build" / "dryrun"
    cells = [f"{a}:{s}:{m}" for a, s, m in DRYRUN_CELLS]
    log("== phase 20a: the dry run on meta DTensors over a fake world, in a "
        f"subprocess: {', '.join(cells)}")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--force",
           "--out", str(out_dir)] + [x for c in cells for x in ("--cell", c)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.strip():
            log("  " + line)
    out = {"wall_s": wall, "cells": {}}
    for arch, shape, mesh in DRYRUN_CELLS:
        cell = json.loads((out_dir / f"{arch}__{shape}__{mesh}.json").read_text())
        if cell["status"] != "ok":
            log(cell.get("traceback", ""))
            raise AssertionError(f"dry run {arch} x {shape} x {mesh}: "
                                 f"{cell['status']} {cell.get('error', '')}")
        colls = cell["collectives"]
        counts = {k: v["count"] for k, v in colls["by_kind"].items()}
        mem = cell["memory"]
        log(f"  {arch} x {shape} x {mesh} ({cell['n_chips']} ranks): trace "
            f"{cell['trace_s']} s; collectives {counts}; wire "
            f"{colls['total_wire_bytes_per_chip'] / 1e9:.4f} GB a rank; argument "
            f"bytes a rank {mem['per_chip_bytes'] / 1e9:.4f} GB (fits an H100: "
            f"{mem['fits_h100']}); FLOPs a rank "
            f"{cell['flop_counter']['flops_per_rank']:.4e} (analytic, global: "
            f"{cell['analytic']['flops']:.4e})")
        out["cells"][f"{arch} x {shape} x {mesh}"] = dict(
            trace_s=cell["trace_s"], collectives=counts,
            wire_bytes_per_rank=colls["total_wire_bytes_per_chip"],
            argument_bytes_per_rank=mem["per_chip_bytes"],
            flops_per_rank=cell["flop_counter"]["flops_per_rank"])
    if proc.returncode:
        log(proc.stderr[-4000:])
        raise AssertionError(f"the dry run exited {proc.returncode}")
    log(f"  the dry run's subprocess took {wall:.1f} s")
    return out


def one_card_roofline():
    """20b: ``analytic.estimate`` on one card (n_chips 1, tp 1, dp 1, no
    collectives) through the copied ``roofline.build_row`` with the
    H100 and its NVLink term (``analysis/links.h100_chip``), beside this
    run's phase 10 graph p50 and phase 18c graph step p50 where they
    ran; the estimate's optimizer bytes as a time at the card's HBM
    rate beside 18c's AdamW ms."""
    from repro_torch.analysis import analytic, roofline
    from repro_torch.analysis.links import h100_chip
    from repro_torch.configs import ShapeSpec, get_config
    log("== phase 20b: the one-card roofline (analytic.estimate, build_row with "
        "h100_chip()) beside this run's measurements")
    chip = h100_chip()
    cases = (("qwen2.5-7b", ShapeSpec("decode_2k", PROMPT, 1, "decode"),
              "qwen2.5-7b decode graph p50 ms"),
             ("qwen2.5-3b", ShapeSpec("train_2k", TRAIN_SEQ, 1, "train"),
              "qwen2.5-3b train graph step p50 ms"))
    out = {}
    for arch, shape, measured_key in cases:
        est = analytic.estimate(get_config(arch), shape, n_chips=1, tp=1, dp=1)
        cell = {"arch": arch, "shape": shape.name, "mesh": "1 card", "n_chips": 1,
                "analytic": {"flops": est.flops,
                             "hbm_bytes_per_chip": est.hbm_bytes_per_chip,
                             "model_flops": est.model_flops},
                "collectives": {"total_wire_bytes_per_chip": 0.0}}
        row = roofline.build_row(cell, chip)
        res = dict(compute_ms=row.compute_t * 1e3, memory_ms=row.memory_t * 1e3,
                   collective_ms=row.collective_t * 1e3, step_floor_ms=row.step_t * 1e3,
                   dominant=row.dominant, measured_ms=MEASURED.get(measured_key))
        line = (f"  {arch} {shape.kind} batch 1, {shape.seq_len} tokens: compute "
                f"{res['compute_ms']:.4f} ms, memory {res['memory_ms']:.4f} ms, "
                f"collective {res['collective_ms']:.4f} ms -> floor "
                f"{res['step_floor_ms']:.4f} ms ({row.dominant}-bound)")
        if res["measured_ms"] is not None:
            res["floor_over_measured"] = res["step_floor_ms"] / res["measured_ms"]
            line += (f"; measured {res['measured_ms']:.4f} ms ({measured_key}), "
                     f"floor / measured {res['floor_over_measured']:.4f}")
        log(line)
        if shape.kind == "train":
            res["opt_bytes"] = est.detail["opt_bytes"]
            res["opt_ms_at_hbm"] = est.detail["opt_bytes"] / HBM_BPS * 1e3
            adamw = MEASURED.get("qwen2.5-3b AdamW ms")
            log(f"  the estimate's optimizer bytes {res['opt_bytes'] / 1e9:.4f} GB "
                f"(f32 moments read and written) take {res['opt_ms_at_hbm']:.4f} ms "
                f"at {HBM_BPS / 1e12:.2f} TB/s"
                + (f"; 18c's AdamW update took {adamw:.2f} ms" if adamw else ""))
            res["adamw_ms"] = adamw
        out[f"{arch} {shape.kind}"] = res
    return out


def analysis():
    """Phase 20; returns its numbers."""
    t_phase = time.perf_counter()
    out = {"dryrun": dry_run_cells(), "roofline": one_card_roofline()}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 20 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 21
EXAMPLES = ("quickstart.py", "serve_stream.py", "train_dense.py", "quant_ablation.py")
EXAMPLE_TIMEOUT_S = 300
ABLATION_ARCH = "qwen2.5-7b"


def run_examples():
    """21a: each ``examples/torch`` script as a user runs it (on the
    card, its defaults), in a subprocess: exit 0 and ``OK`` last.
    Returns each one's wall seconds."""
    out = {}
    env = dict(os.environ, PYTHONPATH="")
    for name in EXAMPLES:
        log(f"  -- examples/torch/{name}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch" / name)],
                              cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=EXAMPLE_TIMEOUT_S)
        out[name] = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines[-14:]:
            log("    " + line)
        if proc.returncode or not lines or lines[-1] != "OK":
            log(proc.stderr[-4000:])
            raise AssertionError(f"examples/torch/{name} exited {proc.returncode} "
                                 "without OK")
        log(f"    ({out[name]:.1f} s)")
    return out


def quant_ablation_full_width(dev):
    """21b: the example's ``ablation`` at qwen2.5-7b full width (28
    layers, bf16 random weights drawn on the card), prompt 2048, 32 new
    tokens, one path at a time with the counts at 0 just before it: the
    dequantisation kernel 7 x 28 times a step on int8_dequant,
    int8_fused and int4_dequant, kernel 3 on int4_fused, neither on
    bf16; each path's charged bytes over its graph p50 must not pass
    the card's 3.35 TB/s."""
    import importlib.util
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    spec = importlib.util.spec_from_file_location(
        "quant_ablation_example", ROOT / "examples" / "torch" / "quant_ablation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = get_config(ABLATION_ARCH)
    log(f"  -- quant_ablation.ablation at {ABLATION_ARCH} full width ({cfg.n_layers} "
        f"layers, bf16 random weights drawn on the card), prompt {PROMPT}, {NEW} new "
        f"tokens, each path's engine graph step")
    params = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    prompt = prompt_batch(cfg.vocab_size, dev)
    per_step = 7 * cfg.n_layers
    rows, counts = [], {}
    for path in mod.WEIGHT_PATHS:
        free_card()
        zero_counts()
        row, = mod.ablation(cfg, params, dev, prompt, paths=(path,),
                            max_len=PROMPT + NEW + 1, n_new=NEW)
        launches = launched()
        got = {k: launches[k] for k in ("dequantize", "int4_matmul")}
        copies = path in ("int8_dequant", "int8_fused", "int4_dequant")
        want = {"dequantize": per_step * NEW if copies else 0,
                "int4_matmul": per_step * NEW if path == "int4_fused" else 0}
        counts[path] = got
        rate = row["traffic_bytes"] / (row["p50_ms"] * 1e-3)
        log(f"  {path:13s} charged {row['traffic_bytes'] / 1e9:.4f} GB a step, H100 "
            f"floor {row['floor_ms']:.4f} ms (nominal {mod.NOMINAL_BYTES[path]} bytes an "
            f"element), graph p50 {row['p50_ms']:.4f} ms, realised "
            f"{rate / 1e12:.4f} TB/s of {HBM_BPS / 1e12:.2f}; launches {got} (want {want})")
        if got != want or tuple(row["tokens"].shape) != (1, NEW):
            raise AssertionError(f"{path}: launches {got} differ from {want}, or "
                                 f"tokens {tuple(row['tokens'].shape)}")
        if rate > HBM_BPS:
            raise AssertionError(f"{path}: {row['traffic_bytes']} charged bytes in "
                                 f"{row['p50_ms']} ms read over the card's bound")
        rows.append(row)
    del params
    free_card()
    log(f"  {mod.summary(rows)}")
    ratio = mod.vs_bf16(rows)
    return counts, [dict(path=r["path"], charged_bytes=r["traffic_bytes"],
                         vs_bf16=ratio[r["path"]], floor_ms=r["floor_ms"],
                         graph_p50_ms=r["p50_ms"],
                         realised_tbps=r["traffic_bytes"] / (r["p50_ms"] * 1e-3) / 1e12)
                    for r in rows]


def examples_phase(dev):
    """Phase 21; returns the ablation's launches by path and the numbers."""
    free_card()
    log("== phase 21: the examples (examples/torch) on the card, then the quant "
        f"ablation at {ABLATION_ARCH} full width over every weight path")
    t_phase = time.perf_counter()
    out = {"scripts_s": run_examples()}
    counts, out["ablation"] = quant_ablation_full_width(dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 21 took {out['seconds']:.1f} s")
    return counts, out


# ---------------------------------------------------------------- main
PENDING = []    # TPU kernels still to port: none


KEYS = ("name", "route", "source", "replaces", "launches", "launches_by_path",
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "device_us", "b2b_us", "shape")


def kernels_line(rows) -> str:
    return json.dumps({"kernels": [
        {k: r[k] for k in KEYS + tuple(sorted(set(r) - set(KEYS)))} for r in rows]})


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["kernels", "families", "train", "dist",
                                       "analysis", "examples", "sampling"],
                    help="kernels: phases 1-6 and the kernels line (launches "
                         "null), no main path and no ok line; families: "
                         "phases 1, 9c and 17 (the moe, vlm and audio "
                         "families), no kernels line and no ok line; train: "
                         "phases 1, 5b and 18 (training), no kernels line "
                         "and no ok line; dist: phases 1 and 19 (the "
                         "multi-device runtime), no kernels line and no ok "
                         "line; analysis: phases 1 and 20 (the dry run and "
                         "the one-card roofline), no kernels line and no ok "
                         "line; examples: phases 1 and 21 (the examples and "
                         "the full-width quant ablation), no kernels line and "
                         "no ok line; sampling: phases 1 and 10c (stochastic "
                         "sampling in the captured graphs), no kernels line "
                         "and no ok line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    smi, dev = setup()
    if args.only == "sampling":
        log(json.dumps({"sampling": sampling_phase(dev)[1]}))
        log(smi.splitlines()[0])
        return 0
    if args.only == "examples":
        log(json.dumps({"examples": examples_phase(dev)[1]}))
        log(smi.splitlines()[0])
        return 0
    if args.only == "analysis":
        log(json.dumps({"analysis": analysis()}))
        log(smi.splitlines()[0])
        return 0
    if args.only == "dist":
        _, dist_out = distributed(dev)
        log(json.dumps({"distributed": dist_out}))
        log(smi.splitlines()[0])
        return 0
    if args.only == "families":
        check_f32_family_tokens(dev)
        _, fam = families_full_width(dev)
        log(json.dumps({"families": fam}))
        log(smi.splitlines()[0])
        return 0
    timer = Timer(dev)
    if args.only == "train":
        check_rmsnorm_bwd(dev, timer)
        del timer
        _, train = training(dev)
        log(json.dumps({"training": train}))
        log(smi.splitlines()[0])
        return 0
    rows = [check_decode_attention(dev, timer), check_int4_matmul(dev, timer)]
    rows += check_paged_decode_attention(dev, timer)
    rows += [check_rmsnorm(dev, timer), check_ssd_update(dev, timer),
             check_rmsnorm_bwd(dev, timer), check_dequantize(dev, timer)]
    for row in rows:     # device_us and b2b_us: measured for kernels 4 and 5
        row.setdefault("device_us", None)
        row.setdefault("b2b_us", None)
    del timer
    torch.cuda.empty_cache()
    if args.only == "kernels":
        for row in rows:
            row["launches"], row["launches_by_path"] = None, {}
        log(smi.splitlines()[0])
        print(kernels_line(rows))
        return 0
    check_f32_tokens(dev)
    check_f32_paged_tokens(dev)
    check_f32_ssm_tokens(dev)
    check_f32_tier_tokens(dev)
    check_f32_family_tokens(dev)
    da_launches, i4_launches, dense_norms, prefill = main_path(dev)
    rows[1].update(prefill)
    torch.cuda.empty_cache()
    sc, sampling_out = sampling_phase(dev)
    paged_launches, paged_norms = paged_serving(dev)
    ssm = [ssm_main_path(dev, "mamba2-2.7b", 13),
           ssm_main_path(dev, "zamba2-1.2b", 14)]
    ab = dispatch_ab(dev)
    tier_counts, tier = tiered_serving(dev, prefill["prefill_wall_bf16_ms"])
    torch.cuda.empty_cache()
    fc, fam = families_full_width(dev)
    tc, train = training(dev)
    dc, dist_out = distributed(dev)
    analysis_out = analysis()
    ec, examples_out = examples_phase(dev)
    dense, int4 = "qwen2.5-7b batch-1 bf16", "qwen2.5-7b batch-1 int4"
    paged = ("qwen2.5-7b paged bf16 KV", "qwen2.5-7b paged int8 KV")
    tiered = ("qwen2.5-7b tiered paged bf16 KV", "qwen2.5-7b tiered paged int8 KV")
    t_bf16, t_int8 = tier_counts["bf16 KV, K=1"], tier_counts["int8 KV, K=4"]
    mamba, zamba = "mamba2-2.7b batch-1", "zamba2-1.2b batch-1"
    moe, moe_q, moe_p = ("qwen2-moe-a2.7b batch-1 bf16", "qwen2-moe-a2.7b batch-1 int4",
                         "qwen2-moe-a2.7b paged bf16 KV")
    vl, audio = "qwen2-vl-2b batch-1", "musicgen-large batch-1"
    trained = "qwen2.5-3b training bf16 (eager and captured steps)"
    d_decode = "qwen2.5-7b-width decode on DTensors (2 layers, sequence-split cache)"
    d_train = "qwen2.5-3b training bf16 on DTensors (1x1 mesh, uncaptured)"
    ablated = {p: f"qwen2.5-7b batch-1 {p} (quant ablation)" for p in ec}
    s_dense, s_int4 = (f"qwen2.5-7b batch-1 {q} sampled (fused graph)"
                       for q in ("bf16", "int4"))
    s_k4, s_k1 = (f"qwen2.5-7b paged bf16 KV sampled {k}" for k in ("K=4", "K=1"))
    by_path = [
        {dense: da_launches, zamba: ssm[1]["decode_attention"],
         moe: fc["moe"]["decode_attention"], moe_q: fc["moe_int4"]["decode_attention"],
         vl: fc["vlm"]["decode_attention"], audio: fc["audio"]["decode_attention"],
         d_decode: dc["decode"]["decode_attention"],
         s_dense: sc["bf16"]["decode_attention"], s_int4: sc["int4"]["decode_attention"]},
        {int4: i4_launches, moe_q: fc["moe_int4"]["int4_matmul"],
         ablated["int4_fused"]: ec["int4_fused"]["int4_matmul"],
         s_int4: sc["int4"]["int4_matmul"]},
        {paged[0]: paged_launches[0], tiered[0]: t_bf16[0],
         moe_p: fc["moe_paged"]["paged_decode_attention"],
         s_k4: sc["K=4"]["paged_decode_attention"],
         s_k1: sc["K=1"]["paged_decode_attention"]},
        {paged[1]: paged_launches[1], tiered[1]: t_int8[0]},
        {dense: dense_norms, paged[0]: paged_norms[0], paged[1]: paged_norms[1],
         tiered[0]: t_bf16[1], tiered[1]: t_int8[1],
         mamba: ssm[0]["rmsnorm"], zamba: ssm[1]["rmsnorm"],
         moe: fc["moe"]["rmsnorm"], moe_q: fc["moe_int4"]["rmsnorm"],
         moe_p: fc["moe_paged"]["rmsnorm"], vl: fc["vlm"]["rmsnorm"],
         audio: fc["audio"]["rmsnorm"], trained: tc["rmsnorm"],
         d_decode: dc["decode"]["rmsnorm"], d_train: dc["train"]["rmsnorm"],
         s_dense: sc["bf16"]["rmsnorm"], s_int4: sc["int4"]["rmsnorm"],
         s_k4: sc["K=4"]["rmsnorm"], s_k1: sc["K=1"]["rmsnorm"]},
        {mamba: ssm[0]["ssd_update"], zamba: ssm[1]["ssd_update"]},
        {trained: tc["rmsnorm_bwd"], d_train: dc["train"]["rmsnorm_bwd"]},
        {moe_q: fc["moe_int4"]["dequantize"],
         **{ablated[p]: ec[p]["dequantize"]
            for p in ("int8_dequant", "int8_fused", "int4_dequant")}}]
    for row, counts in zip(rows, by_path):
        row["launches"] = sum(counts.values())
        row["launches_by_path"] = counts
        log(f"  {row['name']} launches per main path: {counts}")
    log(json.dumps({"pending_kernels": PENDING}))
    log(json.dumps({"sampling": sampling_out}))
    log(json.dumps({"dispatch_ab": ab}))
    log(json.dumps({"host_tier": tier}))
    log(json.dumps({"families": fam}))
    log(json.dumps({"training": train}))
    log(json.dumps({"distributed": dist_out}))
    log(json.dumps({"analysis": analysis_out}))
    log(json.dumps({"examples": examples_out}))
    log(smi.splitlines()[0])
    print(kernels_line(rows))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
