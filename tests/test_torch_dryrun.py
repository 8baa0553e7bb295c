"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: the cell policy, the abstract params and input specs, the
kernel wrappers' meta branches, and traced cells -- reduced cells of
every family on both production meshes and one full-width cell -- whose
analytic block and sharding decisions equal the reference's.

The cells run in one subprocess (a fake world of 256 or 512 ranks is
process-global), which also checks that the dry run touches no CUDA
state and imports no jax.  About 70 s on one worker, 60 of them the
subprocess."""
import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import analytic as ref_analytic
from repro.configs import get_config as ref_get_config
from repro.launch import sharding as ref_shd
from repro.models.model import Model as RefModel
from repro.models.model import input_specs as ref_input_specs
from repro.quant import quantize_tree as ref_quantize_tree
from repro.training import AdamW as RefAdamW
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.int4_matmul import ops as i4_ops
from repro_torch.kernels.paged_decode_attention import ops as pda_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_update import ops as ssd_ops
from repro_torch.launch import dryrun
from repro_torch.models.model import Model, input_specs
from repro_torch.training.tree import leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

# reduced cells: every family on both meshes; the train and prefill kinds
# on the (16, 16) mesh (on the (2, 16, 16) mesh DTensor's placement
# planner takes minutes on most of them), one skipped cell; the moe
# train_4k cells whose token dim splits unevenly (llama4-scout's 4-row
# microbatches on 16 data ranks, qwen2-moe's over pod x data), about 10
# and 15 s
REDUCED_CELLS = [
    ("qwen2.5-3b", "train_4k", "pod"), ("qwen2-vl-2b", "prefill_32k", "pod"),
    ("musicgen-large", "decode_32k", "pod"), ("zamba2-1.2b", "decode_32k", "pod"),
    ("mamba2-2.7b", "long_500k", "pod"), ("qwen2-moe-a2.7b", "decode_32k", "pod"),
    ("llama4-scout-17b-a16e", "decode_32k", "pod"), ("qwen2.5-3b", "long_500k", "pod"),
    ("qwen2.5-3b", "decode_32k", "multipod"),
    ("qwen2-moe-a2.7b", "decode_32k", "multipod"),
    ("llama4-scout-17b-a16e", "decode_32k", "multipod"),
    ("mamba2-2.7b", "long_500k", "multipod"), ("zamba2-1.2b", "decode_32k", "multipod"),
    ("qwen2-vl-2b", "decode_32k", "multipod"),
    ("musicgen-large", "decode_32k", "multipod"),
    ("llama4-scout-17b-a16e", "train_4k", "pod"),
    ("qwen2-moe-a2.7b", "train_4k", "multipod")]
FULL_CELL = ("qwen2.5-3b", "decode_32k", "pod")

RUN = r"""
import json, sys, torch
from repro_torch.launch import dryrun
out_dir, cells = sys.argv[1], sys.argv[2:]
rc_reduced = dryrun.main(["--reduced", "--force", "--out", out_dir]
                         + [x for c in cells for x in ("--cell", c)])
rc_full = dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh",
                       "pod", "--out", out_dir, "--force"])
refused = None
with dryrun.fake_world(4):
    try:
        with dryrun.fake_world(4):
            pass
    except RuntimeError as e:
        refused = str(e)
print(json.dumps({
    "rc": [rc_reduced, rc_full], "refused": refused,
    "cuda_initialized": torch.cuda.is_initialized(),
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")),
    "repro": sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))}))
"""


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cells = [":".join(c) for c in REDUCED_CELLS]
    proc = subprocess.run([sys.executable, "-c", RUN, str(out)] + cells, env=ENV,
                          text=True, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out, json.loads(proc.stdout.strip().splitlines()[-1])


def _cell(out, arch, shape, mesh, tag=""):
    return json.loads((out / f"{arch}__{shape}__{mesh}{tag}.json").read_text())


# ------------------------------------------------------- the reference side
def ref_cell_policy():
    """The reference's ``cell_policy``, taken from its source (importing
    ``repro.launch.dryrun`` sets XLA_FLAGS for the whole process)."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "cell_policy")
    ns = {"Dict": dict}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["cell_policy"]


class _StandIn:
    """The production meshes' axis names and sizes (the specs read no
    more)."""

    def __init__(self, mesh):
        if mesh == "pod":
            self.axis_names, self.shape = ("data", "model"), {"data": 16, "model": 16}
        else:
            self.axis_names = ("pod", "data", "model")
            self.shape = {"pod": 2, "data": 16, "model": 16}


def ref_decisions(arch, shape_name, mesh, reduced, monkeypatch):
    """The reference's ``plan.decisions`` after the shardings its
    ``build_cell`` asks for (params, optimizer state, batch, cache)."""
    monkeypatch.setattr(ref_shd.ShardingPlan, "named", lambda self, spec: tuple(spec))
    cfg = ref_get_config(arch)
    shape = SHAPES[shape_name]
    if reduced:
        cfg, shape = cfg.reduced(), dryrun.REDUCED_SHAPES[shape_name]
    pol = ref_cell_policy()(arch, shape_name)
    plan = ref_shd.make_plan(cfg, _StandIn(mesh), fsdp=pol["fsdp"],
                             strategy=pol["strategy"])
    model = RefModel(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    if pol["weight_path"] != "bf16":
        params = jax.eval_shape(lambda p: ref_quantize_tree(p, pol["weight_path"]),
                                params)
    ref_shd.params_shardings(plan, params)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        ref_shd.opt_state_shardings(plan, jax.eval_shape(RefAdamW(lr=1e-4).init, params))
    else:
        cache = jax.eval_shape(lambda: model.init_cache(B, S, kv_dtype=jax.numpy.bfloat16))
        ref_shd.cache_shardings(plan, cache)
    ref_shd.batch_shardings(plan, ref_input_specs(cfg, seq_len=S, batch=B,
                                                  kind=shape.kind))
    return plan.decisions


def ref_estimate(arch, shape_name, mesh, reduced):
    """The reference's ``estimate`` with ``build_cell``'s arguments."""
    cfg = ref_get_config(arch)
    shape = SHAPES[shape_name]
    if reduced:
        cfg, shape = cfg.reduced(), dryrun.REDUCED_SHAPES[shape_name]
    pol = ref_cell_policy()(arch, shape_name)
    n, tp, dp = (256, 16, 16) if mesh == "pod" else (512, 16, 32)
    wdtype = {"bf16": 2, "int4_fused": 0.5}[pol["weight_path"]]
    est = ref_analytic.estimate(cfg, shape, n_chips=n, tp=tp, dp=dp,
                                weight_dtype_bytes=wdtype, kv_dtype_bytes=2.0,
                                remat=pol["remat"])
    return {"flops": est.flops, "hbm_bytes_per_chip": est.hbm_bytes_per_chip,
            "model_flops": est.model_flops,
            **{k: float(v) for k, v in est.detail.items()}}


# ------------------------------------------------------------------ tests
def test_cell_policy_equal_reference():
    ref = ref_cell_policy()
    for arch in list_configs(assigned_only=True):
        for shape in SHAPES:
            assert dryrun.cell_policy(arch, shape) == ref(arch, shape), (arch, shape)


@functools.lru_cache(maxsize=None)
def _init_under_fake(name):
    with FakeTensorMode():
        return Model(get_config(name), device="cpu").init(torch.Generator())


@pytest.mark.parametrize("name", list_configs())
def test_abstract_params_equal_init(name):
    """Every leaf of ``abstract_params`` (meta) at the path, shape and
    dtype of ``init``'s, at full width (``init`` under FakeTensorMode)
    and for the reduced config (``init`` on the CPU)."""
    for cfg, made in ((get_config(name), _init_under_fake(name)),
                      (get_config(name).reduced(), None)):
        model = Model(cfg, device="cpu")
        if made is None:
            made = model.init(torch.Generator().manual_seed(0))
        abstract = leaves_with_path(model.abstract_params())
        concrete = leaves_with_path(made)
        assert [p for p, _ in abstract] == [p for p, _ in concrete]
        for (path, a), (_, c) in zip(abstract, concrete):
            assert a.is_meta, path
            assert (tuple(a.shape), a.dtype) == (tuple(c.shape), c.dtype), path


@pytest.mark.parametrize("name", list_configs())
def test_input_specs_equal_reference(name):
    """Key for key and shape for shape; ids are int64 where the
    reference's are int32, embeddings bf16 in both."""
    for kind in ("train", "prefill", "decode"):
        mine = input_specs(get_config(name), seq_len=64, batch=4, kind=kind)
        theirs = ref_input_specs(ref_get_config(name), seq_len=64, batch=4, kind=kind)
        assert list(mine) == list(theirs), kind
        for k, v in mine.items():
            assert v.is_meta and tuple(v.shape) == tuple(theirs[k].shape), (kind, k)
            want = torch.bfloat16 if str(theirs[k].dtype) == "bfloat16" else torch.int64
            assert v.dtype == want, (kind, k)


def _meta(t):
    if not isinstance(t, torch.Tensor):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _wrapper_cases():
    g = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = randn(2, 4, 32, dtype=dt), randn(2, 16, 2, 32, dtype=dt), \
            randn(2, 16, 2, 32, dtype=dt)
        cases.append(("decode_attention", da_ops.decode_attention,
                      (q, k, v, torch.rand((2, 16), generator=g) < 0.7), {}))
        bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        lens = torch.tensor([5, 8], dtype=torch.int32)
        pools = randn(5, 4, 2, 32, dtype=dt), randn(5, 4, 2, 32, dtype=dt)
        cases.append(("paged_decode_attention", pda_ops.paged_decode_attention,
                      (q,) + pools + (bt, lens), {}))
        codes = (torch.randint(-127, 128, (5, 4, 2, 32), generator=g).to(torch.int8),
                 torch.randint(-127, 128, (5, 4, 2, 32), generator=g).to(torch.int8))
        cases.append(("paged_decode_attention int8", pda_ops.paged_decode_attention,
                      (q,) + codes + (bt, lens, randn(5, 4, 2).abs(),
                                      randn(5, 4, 2).abs()), {}))
        cases.append(("int4_matmul", i4_ops.int4_matmul,
                      (randn(3, 64, dtype=dt),
                       torch.randint(0, 256, (32, 16), generator=g).to(torch.uint8),
                       randn(1, 16).abs()), {"group": 64}))
        x = randn(3, 5, 64, dtype=dt)
        for w in (randn(64, dtype=dt), None):
            cases.append(("rmsnorm", rms_ops.rmsnorm, (x, w), {}))
            cases.append(("rmsnorm_bwd", rms_ops.rmsnorm_bwd,
                          (x, w, randn(3, 5, 64, dtype=dt)), {}))
        h = randn(1, 4, 8, 16)
        args = (h, randn(1, 4, 8, dtype=dt), randn(1, 4).abs(), -randn(4).abs(),
                randn(1, 2, 16, dtype=dt), randn(1, 2, 16, dtype=dt))
        cases.append(("ssd_update", ssd_ops.ssd_update, args, {}))
        cases.append(("ssd_update out", ssd_ops.ssd_update, args, {"out": h.clone()}))
    return cases


@pytest.mark.parametrize("case", range(len(_wrapper_cases())),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(_wrapper_cases())])
def test_wrapper_meta_branch_shapes(case):
    """Each kernel wrapper on meta inputs returns meta outputs of its CPU
    outputs' shapes and dtypes, and launches nothing."""
    name, fn, args, kwargs = _wrapper_cases()[case]
    cpu = fn(*args, **kwargs)
    counts = (da_ops.launches, i4_ops.launches, pda_ops.launches, rms_ops.launches,
              rms_ops.bwd_launches, ssd_ops.launches)
    meta = fn(*[_meta(a) for a in args], **{k: _meta(v) for k, v in kwargs.items()})
    assert counts == (da_ops.launches, i4_ops.launches, pda_ops.launches,
                      rms_ops.launches, rms_ops.bwd_launches, ssd_ops.launches)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    meta = meta if isinstance(meta, tuple) else (meta,)
    assert len(cpu) == len(meta)
    for c, m in zip(cpu, meta):
        if c is None:
            assert m is None
            continue
        assert m.is_meta and (m.shape, m.dtype) == (c.shape, c.dtype), name


def test_rmsnorm_grad_on_meta():
    """``RMSNormFunction``'s backward takes the backward wrapper's meta
    branch: the grads of x and w have their shapes and dtypes."""
    x = torch.empty((4, 64), dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty((64,), dtype=torch.bfloat16, device="meta", requires_grad=True)
    gx, gw = torch.autograd.grad(rms_ops.rmsnorm(x, w).sum(), (x, w))
    assert (gx.shape, gx.dtype, gw.shape, gw.dtype) == (x.shape, x.dtype, w.shape, w.dtype)
    assert gx.is_meta and gw.is_meta


def test_dry_run_touches_no_cuda_and_no_jax(dry_run):
    _, flags = dry_run
    assert flags["rc"] == [0, 0]
    assert not flags["cuda_initialized"]
    assert flags["jax"] == [] and flags["repro"] == []
    assert "process group exists already" in flags["refused"]


@pytest.mark.parametrize("cell", REDUCED_CELLS, ids=[":".join(c) for c in REDUCED_CELLS])
def test_reduced_cells_equal_reference(dry_run, cell, monkeypatch):
    """Each reduced cell ends ok (or skipped, as the reference skips
    long_500k on full attention); its analytic block equals the
    reference's ``estimate`` and its sharding decisions the reference's
    plan; its collectives are summed by the copied ring formulas."""
    out, _ = dry_run
    got = _cell(out, *cell, tag="__reduced")
    if cell == ("qwen2.5-3b", "long_500k", "pod"):
        assert got["status"] == "skipped"
        return
    assert got["status"] == "ok", got.get("error")
    assert got["n_chips"] == (256 if cell[2] == "pod" else 512)
    assert got["analytic"] == ref_estimate(*cell, reduced=True)
    assert got["sharding_decisions"] == ref_decisions(*cell, True, monkeypatch)
    colls = got["collectives"]
    assert colls["total_wire_bytes_per_chip"] == pytest.approx(
        sum(v["wire_bytes_per_chip"] for v in colls["by_kind"].values()))
    assert got["collective_count_kinds"] == sorted(colls["by_kind"])
    assert got["flop_counter"]["flops_per_rank"] > 0
    assert got["memory"]["per_chip_bytes"] == sum(
        got["memory"][k] for k in ("params_bytes", "opt_state_bytes", "cache_bytes",
                                   "batch_bytes"))


def test_full_width_decode_cell(dry_run, monkeypatch):
    """qwen2.5-3b decode_32k on the (16, 16) mesh at full width: ok, the
    reference's estimate and decisions, all-reduces and all-gathers on
    the wire, and each rank's bytes: the params' shard (vocab, heads and
    features over the 16-way model axis) plus the cache's (batch over
    data, sequence over model)."""
    out, _ = dry_run
    got = _cell(out, *FULL_CELL)
    assert got["status"] == "ok", got.get("error")
    assert got["analytic"] == ref_estimate(*FULL_CELL, reduced=False)
    assert got["sharding_decisions"] == ref_decisions(*FULL_CELL, False, monkeypatch)
    assert got["collective_count_kinds"] == ["all-gather", "all-reduce"]
    assert got["collectives"]["total_wire_bytes_per_chip"] > 0
    cfg = get_config("qwen2.5-3b")
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    cache = 2 * L * (128 // 16) * (32768 // 16) * Hkv * hd * 2 + 4
    assert got["memory"]["cache_bytes"] == cache
    assert got["memory"]["fits_h100"]
    assert dataclasses.asdict(get_config("qwen2.5-3b")) == \
        dataclasses.asdict(ref_get_config("qwen2.5-3b"))
