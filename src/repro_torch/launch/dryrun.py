"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta
DTensors over a fake world of 256 or 512 ranks.

Port of ``repro.launch.dryrun``.  For each cell this driver:
  1. starts a fake process group of 256 ranks ((16, 16), ``pod``) or 512
     ((2, 16, 16), ``multipod``) in this one process (torch's ``fake``
     backend: collectives return at once and move no data) and lays the
     production mesh over it (``launch/mesh.py``, ``device_type="cpu"``);
  2. builds allocation-free abstract params (``Model.abstract_params``,
     meta tensors; quantised by the cell's policy), optimizer state,
     cache and batch (``input_specs``);
  3. plans them (``launch/sharding.py``) and ``distribute``s them as meta
     DTensors: each rank's local shard has the shape a real rank would
     hold;
  4. traces one step (the train step of ``training/train_loop`` with the
     policy's remat and microbatches, ``Model.prefill`` or
     ``Model.decode_step``) under ``activation_hints``, the collective
     counter (``analysis/collectives.py``) and a per-rank FLOP count with
     ``torch.utils.flop_counter``'s formulas -- proving the plan is
     coherent (a sharding rule DTensor refuses, an uneven split, a
     kernel wrapper with no meta branch fail HERE);
  5. records each rank's argument bytes, the FLOPs, the collectives with
     their ring wire bytes, the analytic FLOP/byte model and the
     sharding decisions in one JSON per cell under ``--out`` (read by
     ``analysis/roofline.py``).

The reference lowers and compiles with XLA; here nothing is compiled
and no kernel runs: meta tensors hold no data, and each kernel wrapper
returns an empty meta tensor of its output's shape.  No CUDA state is
touched (``torch.cuda.is_initialized()`` stays False), so the dry run
runs on a machine without a GPU and beside a CUDA process.  The fake
world is process-global: one cell at a time, and never in a process
that has a process group already.

Weight paths per cell as in the reference: bf16 by default;
llama4-scout's serving cells use int4_fused, its train cell FSDP.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --reduced --mesh both

``--reduced`` (port-only) traces the CPU-sized config of each arch at
cut shapes (``REDUCED_SHAPES``) on the same meshes: the quick check.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.analysis import analytic
from repro_torch.analysis.collectives import CollectiveCounter
from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_configs, shape_applicable
from repro_torch.core.hardware import GPU_H100
from repro_torch.launch import sharding as shd
from repro_torch.launch.hints import activation_hints
from repro_torch.launch.mesh import dp_size, make_production_mesh, tp_size
from repro_torch.models import attention as attn
from repro_torch.models.model import Model, input_specs
from repro_torch.quant import quantize_tree
from repro_torch.quant.quantize import QuantizedTensor
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_loop import make_train_step, trainable
from repro_torch.training.tree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

DEFAULT_OUT = "results/dryrun_torch"

# --reduced: each shape cut for the reduced configs (max_seq_len 128);
# batches divide (pod x data) = 32 and the 8 microbatches of train_4k
REDUCED_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 64, 32, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 32, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}


def cell_policy(arch: str, shape_name: str) -> Dict:
    """Per-cell deployment choices (recorded in the cell JSON): the
    reference's policy, key for key."""
    pol = {"weight_path": "bf16", "fsdp": False, "kv_dtype": "bfloat16",
           "remat": "blocks", "microbatches": 1, "strategy": "tp",
           "grad_compression": None, "attn_chunk_threshold": None}
    if shape_name == "train_4k":
        # the reference's policy: gradient accumulation bounds each
        # rank's activation residuals
        pol["microbatches"] = 8
    if arch == "llama4-scout-17b-a16e":
        if shape_name == "train_4k":
            pol["fsdp"] = True
        else:
            # the reference's policy: 109B params serve from int4 fused
            # weights
            pol["weight_path"] = "int4_fused"
    return pol


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A process group of ``n_ranks`` fake ranks in this process (this
    process is rank 0), destroyed on exit.  Refuses to start when a
    process group exists already."""
    import torch.distributed as dist
    # torch-internal: the fake backend's store lives in torch's testing
    # package (torch.testing._internal.distributed.fake_pg), the one place
    # the port imports it
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake world; a process "
                           "group exists already in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


class RankFlops(TorchDispatchMode):
    """FLOPs this rank computes: ``torch.utils.flop_counter``'s formulas
    (those ``FlopCounterMode`` applies) on each op below DTensor, at its
    local shapes.  ``FlopCounterMode`` itself counts a DTensor op at its
    global shape and an op that ``_dtensor.local_call`` runs on local
    shards at the local one, so its total mixes the two.  The ops DTensor's
    sharding propagation runs on fake tensors are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and not _shape_probe(types):
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            key = func._overloadpacket.__name__
            self.by_op[key] = self.by_op.get(key, 0) + n
        return out


def _shape_probe(types) -> bool:
    """Whether an op runs on fake tensors: DTensor's sharding propagation
    runs each new op once at its global shape to learn the output's
    shape, which no rank computes."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    total = 0
    for leaf in tree_leaves(tree):
        parts = (leaf.data, leaf.scales) if isinstance(leaf, QuantizedTensor) else (leaf,)
        for t in parts:
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def build_cell(arch: str, shape_name: str, mesh_kind: str,
               policy_overrides: Optional[Dict] = None, *,
               reduced: bool = False) -> Dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if reduced:
        cfg, shape = cfg.reduced(), REDUCED_SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention "
                          "(full-attention arch)"}

    pol = cell_policy(arch, shape_name)
    pol.update(policy_overrides or {})
    multi = mesh_kind == "multipod"
    old_chunking = (attn.CHUNKED_ATTN_THRESHOLD, attn.CHUNK_Q)
    with fake_world(512 if multi else 256):
        try:
            if pol["attn_chunk_threshold"] is not None:
                attn.configure(threshold=pol["attn_chunk_threshold"])
            return _trace_cell(arch, shape_name, mesh_kind, cfg, shape, pol,
                               make_production_mesh(multi_pod=multi,
                                                    device_type="cpu"))
        finally:
            attn.configure(*old_chunking)


def _trace_cell(arch, shape_name, mesh_kind, cfg, shape, pol, mesh) -> Dict:
    n_chips = mesh.size()
    model = Model(cfg, device="meta")
    plan = shd.make_plan(cfg, mesh, fsdp=pol["fsdp"], strategy=pol["strategy"])

    t0 = time.time()
    abstract_params = model.abstract_params()
    if pol["weight_path"] != "bf16":
        abstract_params = quantize_tree(abstract_params, pol["weight_path"])
    B, S = shape.global_batch, shape.seq_len
    kv_dtype = torch.bfloat16 if pol["kv_dtype"] == "bfloat16" else torch.int8

    opt_state = cache = None
    if shape.kind == "train":
        opt = AdamW(lr=1e-4)
        abstract_opt = opt.init(abstract_params)
        params = shd.distribute(trainable(abstract_params),
                                shd.params_shardings(plan, abstract_params))
        opt_state = shd.distribute(abstract_opt,
                                   shd.opt_state_shardings(plan, abstract_opt))
        batch_specs = input_specs(cfg, seq_len=S, batch=B, kind="train")
        batch = shd.distribute(batch_specs, shd.batch_shardings(plan, batch_specs))
        step = make_train_step(model, opt, remat=pol["remat"],
                               microbatches=pol["microbatches"],
                               grad_compression=pol["grad_compression"])

        def run():
            return step((params, opt_state), batch)
    else:
        params = shd.distribute(abstract_params,
                                shd.params_shardings(plan, abstract_params))
        abstract_cache = model.init_cache(B, S, kv_dtype=kv_dtype)
        cache = shd.distribute(abstract_cache,
                               shd.cache_shardings(plan, abstract_cache))
        batch_specs = input_specs(cfg, seq_len=S, batch=B, kind=shape.kind)
        batch = shd.distribute(batch_specs, shd.batch_shardings(plan, batch_specs))

        def run():
            with torch.no_grad():
                if shape.kind == "prefill":
                    return model.prefill(params, batch, cache)
                return model.decode_step(params, cache, batch["tokens"])
    t_build = time.time() - t0

    t0 = time.time()
    with activation_hints(mesh, dp_all=(pol["strategy"] == "dp")), \
            CollectiveCounter() as counter, RankFlops() as flops:
        run()
    t_trace = time.time() - t0
    csum = counter.summary()

    wdtype = {"bf16": 2, "int8_fused": 1, "int8_dequant": 1,
              "int4_fused": 0.5, "int4_dequant": 0.5}[pol["weight_path"]]
    tp_eff = 1 if pol["strategy"] == "dp" else tp_size(mesh)
    dp_eff = n_chips if pol["strategy"] == "dp" else dp_size(mesh)
    kv_bytes_eff = 1.0 + 4.0 / (2 * max(cfg.head_dim, 1)) \
        if pol["kv_dtype"] == "int8" else 2.0
    est = analytic.estimate(cfg, shape, n_chips=n_chips, tp=tp_eff,
                            dp=dp_eff, weight_dtype_bytes=wdtype,
                            kv_dtype_bytes=kv_bytes_eff,
                            remat=pol["remat"])

    parts = {"params_bytes": _local_bytes(params),
             "opt_state_bytes": _local_bytes(opt_state),
             "cache_bytes": _local_bytes(cache),
             "batch_bytes": _local_bytes(batch)}
    per_chip_bytes = sum(parts.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "n_chips": n_chips, "status": "ok",
        "policy": pol,
        "build_s": round(t_build, 2), "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": per_chip_bytes, **parts,
            "per_chip_bytes": per_chip_bytes,
            "fits_h100": bool(per_chip_bytes <= GPU_H100.hbm_bytes),
            "note": "each rank's local shards of the step's arguments "
                    "(params, optimizer state, cache, batch), exact; "
                    "activations, gradients and workspace are not "
                    "counted: the meta trace allocates nothing",
        },
        "flop_counter": {
            "flops_per_rank": flops.flops,
            "by_op": flops.by_op,
            "note": "torch.utils.flop_counter's formulas on each op at "
                    "this rank's local shapes (matmuls, attention, "
                    "convolutions; elementwise ops and the hand-written "
                    "kernels' meta branches count 0); no bytes: the meta "
                    "trace moves none, and the analytic model gives them",
        },
        "collectives": csum,
        "collective_count_kinds": sorted(csum["by_kind"].keys()),
        "analytic": {
            "flops": est.flops,
            "hbm_bytes_per_chip": est.hbm_bytes_per_chip,
            "model_flops": est.model_flops,
            **{k: float(v) for k, v in est.detail.items()},
        },
        "sharding_decisions": plan.decisions,
    }


def run_cell(arch, shape_name, mesh_kind, out_dir, force=False,
             policy_overrides=None, tag="", reduced=False) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        cell = build_cell(arch, shape_name, mesh_kind, policy_overrides,
                          reduced=reduced)
    except Exception as e:
        # recorded in the cell's JSON with its traceback, as the
        # reference records a failed compile; main counts it as an error
        cell = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(cell, f, indent=1, default=str)
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--assigned-only", action="store_true", default=True)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized configs at cut shapes (REDUCED_SHAPES)")
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:SHAPE:MESH",
                    help="one cell (repeatable), in place of --arch, --shape "
                         "and --mesh")
    args = ap.parse_args(argv)

    archs = list_configs(assigned_only=True) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    cells = [tuple(c.split(":")) for c in args.cell] or \
        [(a, s, m) for a in archs for s in shapes for m in meshes]
    tag = "__reduced" if args.reduced else ""

    n_ok = n_skip = n_err = 0
    for arch, shape_name, mesh_kind in cells:
        t0 = time.time()
        cell = run_cell(arch, shape_name, mesh_kind, args.out,
                        force=args.force, tag=tag, reduced=args.reduced)
        dt = time.time() - t0
        st = cell["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_err += st == "error"
        extra = ""
        if st == "ok":
            extra = (f" fits={cell['memory']['fits_h100']} "
                     f"perchip={cell['memory']['per_chip_bytes']/1e9:.2f}GB "
                     f"trace={cell['trace_s']}s")
        elif st == "error":
            extra = " " + cell["error"][:120]
        print(f"[{st:7s}] {arch} x {shape_name} x {mesh_kind}"
              f" ({dt:.1f}s){extra}", flush=True)
    print(f"\nok={n_ok} skipped={n_skip} error={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
