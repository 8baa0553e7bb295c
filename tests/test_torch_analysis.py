"""The port's analysis (``repro_torch.analysis``) against the JAX
package's: the analytic model and the roofline as copies, equal to the
originals on every config; the H100's link term; and the collective
counter, which takes the place of the reference's HLO parse, held to a
hand count of a small DTensor step and to ``CommDebugMode``.

About 15 s on one worker (the hand count runs in a subprocess of its
own: the fake process group is process-global)."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import analytic as ref_analytic
from repro.analysis import roofline as ref_roofline
from repro.analysis.hlo import CollectiveOp as RefCollectiveOp
from repro.analysis.hlo import collective_summary as ref_collective_summary
from repro.configs import get_config as ref_get_config
from repro.core import hardware as ref_hardware
from repro_torch.analysis import analytic
from repro_torch.analysis.collectives import CollectiveOp, collective_summary
from repro_torch.analysis.links import H100_NVLINK_BW_PER_DIRECTION, h100_chip
from repro_torch.analysis.roofline import build_row, markdown_table
from repro_torch.configs import SHAPES, get_config, list_configs, shape_applicable
from repro_torch.core import hardware

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
TRIPLES = [(256, 16, 16), (512, 16, 32), (1, 1, 1)]   # (n_chips, tp, dp)
# (weight bytes, kv bytes, remat) per estimate: bf16, int4 weights with
# int8 KV (the dry run's kv_bytes_eff at hd 128), no remat
VARIANTS = [(2, 2.0, "blocks"), (0.5, 1.0 + 4.0 / 256, "blocks"), (2, 2.0, "none")]


# ------------------------------------------- the reference's test cases
def test_decode_flops_scale_with_batch():
    cfg = get_config("qwen2.5-3b")
    f1 = analytic.decode_flops(cfg, 1, 2048)
    f2 = analytic.decode_flops(cfg, 2, 2048)
    assert f2 == pytest.approx(2 * f1)


def test_train_flops_vs_model_flops():
    cfg = get_config("olmo-1b")
    est = analytic.estimate(cfg, SHAPES["train_4k"], n_chips=256, tp=16, dp=16)
    # 6ND <= total (remat adds a fwd; attention adds seq^2 term)
    assert est.model_flops < est.flops < 3 * est.model_flops


def test_ssm_decode_ctx_invariant():
    cfg = get_config("mamba2-2.7b")
    assert (analytic.decode_flops(cfg, 1, 2048)
            == analytic.decode_flops(cfg, 1, 524288))


def _cell():
    return {
        "arch": "olmo-1b", "shape": "decode_32k", "mesh": "pod",
        "n_chips": 256,
        "analytic": {"flops": 851e9, "hbm_bytes_per_chip": 2.29e9,
                     "model_flops": 301e9},
        "collectives": {"total_wire_bytes_per_chip": 9.0e6},
    }


def test_build_row():
    r = build_row(_cell())
    assert r.dominant == "memory"
    assert r.memory_t == pytest.approx(2.29e9 / 819e9)
    assert r.compute_t == pytest.approx(851e9 / (256 * 197e12))
    assert r.collective_t == pytest.approx(9.0e6 / 50e9)
    assert 0 < r.useful_ratio < 1


def test_markdown_table():
    md = markdown_table([build_row(_cell())])
    assert "olmo-1b" in md and "memory" in md


def test_collective_cost_model():
    ag = CollectiveOp("all-gather", 1000, 4, "e", 1)
    rs = CollectiveOp("reduce-scatter", 250, 4, "e", 1)
    ar = CollectiveOp("all-reduce", 1000, 4, "e", 1)
    # AR == AG(result) + RS(same logical tensor) wire bytes
    assert ar.wire_bytes_per_chip == pytest.approx(
        ag.wire_bytes_per_chip + rs.wire_bytes_per_chip)


# ------------------------------------------- the copies equal the originals
def _cells(name):
    """(estimate of the port, of the reference, a roofline cell) for every
    applicable shape, triple and variant of config ``name``."""
    out = []
    for shape in SHAPES.values():
        if not shape_applicable(get_config(name), shape):
            continue
        for n, tp, dp in TRIPLES:
            for wb, kvb, remat in VARIANTS:
                kw = dict(n_chips=n, tp=tp, dp=dp, weight_dtype_bytes=wb,
                          kv_dtype_bytes=kvb, remat=remat)
                a = analytic.estimate(get_config(name), shape, **kw)
                b = ref_analytic.estimate(ref_get_config(name), shape, **kw)
                cell = {"arch": name, "shape": shape.name, "mesh": f"{n}",
                        "n_chips": n,
                        "analytic": {"flops": a.flops,
                                     "hbm_bytes_per_chip": a.hbm_bytes_per_chip,
                                     "model_flops": a.model_flops},
                        "collectives": {"total_wire_bytes_per_chip": 1e6 * n}}
                out.append((a, b, cell))
    return out


@pytest.mark.parametrize("name", list_configs())
def test_estimate_and_roofline_equal_reference(name):
    """``analytic.estimate`` field for field, and ``build_row`` on the same
    cell for every TPU chip of the table, equal the reference's; the
    H100 with its NVLink term gives a finite row."""
    cells = _cells(name)
    assert cells
    for a, b, cell in cells:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for chip in ("tpu-v5e", "tpu-v4", "tpu-v6e", "tpu-v5p"):
            mine = build_row(cell, hardware.get_chip(chip))
            theirs = ref_roofline.build_row(cell, ref_hardware.get_chip(chip))
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        row = build_row(cell, h100_chip())
        assert all(math.isfinite(t) for t in (row.compute_t, row.memory_t,
                                              row.collective_t, row.step_t))


def test_h100_needs_the_link_term():
    """The hardware table (a copy) gives the H100 no link bandwidth, so the
    copied ``build_row`` refuses it; ``h100_chip()`` adds NVLink 4's
    450 GB/s each way and changes nothing else."""
    assert hardware.GPU_H100.ici_bw is None
    with pytest.raises(TypeError):
        build_row(_cell(), hardware.GPU_H100)
    chip = h100_chip()
    assert chip.ici_bw == H100_NVLINK_BW_PER_DIRECTION == 450e9
    assert dataclasses.replace(chip, ici_bw=None) == hardware.GPU_H100
    row = build_row(_cell(), chip)
    assert row.collective_t == pytest.approx(9.0e6 / 450e9)
    assert row.memory_t == pytest.approx(2.29e9 / 3350e9)


def test_collective_ops_and_summary_equal_reference():
    """The copied ring formulas and summary on every kind and group size."""
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    ops = [(k, 1000.0 * (i + 1), n, 1) for i, k in enumerate(kinds)
           for n in (1, 2, 16, 512)]
    mine = [CollectiveOp(k, b, n, "e", m) for k, b, n, m in ops]
    theirs = [RefCollectiveOp(k, b, n, "e", m) for k, b, n, m in ops]
    for a, b in zip(mine, theirs):
        assert a.wire_bytes_per_chip == b.wire_bytes_per_chip
    assert collective_summary(mine) == ref_collective_summary(theirs)


# ------------------------------------------- the counter on a DTensor step
HAND_COUNT = r"""
import json, sys, torch
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.analysis.collectives import CollectiveCounter
from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.hints import activation_hints
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import Model, input_specs

out = {}
for data, model in ((2, 2), (1, 2)):
    with fake_world(data * model):
        mesh = make_test_mesh(data=data, model=model, device_type="cpu")
        cfg = get_config("qwen2.5-3b").reduced()
        m = Model(cfg, device="meta")
        plan = shd.make_plan(cfg, mesh)
        p = m.abstract_params()
        params = shd.distribute(p, shd.params_shardings(plan, p))
        c = m.init_cache(2, 16)
        cache = shd.distribute(c, shd.cache_shardings(plan, c))
        b = input_specs(cfg, seq_len=16, batch=2, kind="decode")
        batch = shd.distribute(b, shd.batch_shardings(plan, b))
        with torch.no_grad(), activation_hints(mesh), CommDebugMode() as cm, \
                CollectiveCounter() as cc:
            m.decode_step(params, cache, batch["tokens"])
        out[f"{data}x{model}"] = {
            "ops": [[o.kind, o.result_bytes, o.group_size, o.multiplier]
                    for o in cc.ops],
            "summary": cc.summary(),
            "comm_debug": {str(k): v for k, v in cm.get_comm_counts().items()},
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "kv_row": cfg.n_kv_heads * cfg.head_dim}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def hand_count():
    proc = subprocess.run([sys.executable, "-c", HAND_COUNT], env=ENV, text=True,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_counter_equals_hand_count(hand_count, mesh):
    """One decode step of the reduced qwen2.5-3b (2 layers, d_model 128,
    4 heads of 32, 2 KV heads, bf16) at batch 2 with a 16-slot cache, on
    a (data, model) mesh over a fake world.  The plan puts the vocab and
    the heads on ``model``, the batch on ``data``, and the cache's
    sequence on ``model``, so each rank holds b = 2 / data batch rows:

    - all-reduce, b x d_model x 2 bytes: the vocab-split embedding's
      masked rows (1), and each layer's two row-parallel products, wo
      and down (2 a layer): 5;
    - all-gather, each layer: the new K and V rows (b x 2 heads x 32 x 2
      bytes), gathered over the heads so that each rank writes its own
      slots of the sequence-split cache (2), and kernel 1's wrapper
      gathering the cache's sequence (b x 16 x 2 x 32 x 2 bytes) for K
      and V (2): 8.

    Every group is the model axis (2 ranks).  The counter's ops, their
    ring wire bytes and ``CommDebugMode``'s counts agree with this."""
    got = hand_count[mesh]
    data = int(mesh.split("x")[0])
    b = 2 // data
    L, D, row = got["n_layers"], got["d_model"], got["kv_row"]
    ar = ["all-reduce", b * D * 2.0, 2, 1]
    ag_new = ["all-gather", b * row * 2.0, 2, 1]
    ag_cache = ["all-gather", b * 16 * row * 2.0, 2, 1]
    want = [ar] + [ag_new, ag_new, ag_cache, ag_cache, ar, ar] * L
    assert got["ops"] == want
    assert got["summary"] == {
        "by_kind": {"all-reduce": {"count": 5, "wire_bytes_per_chip": 5 * b * D * 2.0},
                    "all-gather": {"count": 8, "wire_bytes_per_chip":
                                   L * (b * row * 2.0 + b * 16 * row * 2.0)}},
        "total_wire_bytes_per_chip": 5 * b * D * 2.0 + L * (b * row * 2.0
                                                            + b * 16 * row * 2.0)}
    assert got["comm_debug"] == {"c10d_functional.all_reduce": 5,
                                 "c10d_functional.all_gather_into_tensor": 8}
