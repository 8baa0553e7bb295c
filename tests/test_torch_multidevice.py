"""The port's multi-device runtime on the CPU: gloo, world 8.

Each spawn (``torch.multiprocessing.spawn``, a ``FileStore`` under the
test's temporary directory: no port) runs a group of cases on all 8
ranks; rank 0 writes the numbers, the parent asserts them.  The workers
import only torch and repro_torch and take their inputs as numpy from
the parent.  The single-device side is the port's own plain path, which
the parity tests hold to ``jax.value_and_grad``.

Bounds (f32): the 4x2 train step's loss and every grad within 1e-5
relative (max |diff| / max |single-device|), the AdamW-updated params
within 1e-5; the sharded decode step's logits within 1e-5 of the
single-device logits (relative to max(1, |logits|)); the elastic
restore's loss within 1e-5 relative; the kernel wrappers' DTensor
branch within 1e-6 of the plain call (the same plain versions on the
same rows; the sums over ranks of RMSNorm's dw within 1e-5)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8


def _init(rank, store_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _spawn(fn, tmp_path, *args) -> dict:
    out = tmp_path / f"{fn.__name__}.json"
    mp.spawn(fn, args=(str(tmp_path / "store"), str(out), *args), nprocs=WORLD,
             join=True)
    return json.loads(out.read_text())


# ---------------------------------------------------------------- spawn 1
def _train_worker(rank, store_path, out_path, batch_np, ckpt_dir):
    """The 4x2 train step (internlm2-1.8b reduced) against the
    single-device step, and the elastic checkpoint paths (olmo-1b
    reduced): unsharded -> 2x4, and a 4x2 DTensor state -> 2x4."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.hints import activation_hints
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import state_shardings
    from repro_torch.models.model import Model
    from repro_torch.training import AdamW, make_train_step, restore, save, trainable
    from repro_torch.training.tree import leaves_with_path, tree_leaves, tree_map
    _init(rank, store_path)
    res = {}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    def fresh(model, opt):
        p = trainable(model.init(torch.Generator().manual_seed(0)))
        return p, opt.init(p)

    # -- the train step on a 4x2 mesh
    cfg = get_config("internlm2-1.8b").reduced().replace(dtype="float32")
    model, opt = Model(cfg, device="cpu"), AdamW(lr=1e-3)
    step = make_train_step(model, opt, remat="blocks")
    params, opt_state = fresh(model, opt)
    loss1, _ = model.loss(params, batch)
    g1 = torch.autograd.grad(loss1, tree_leaves(params))
    (p1, _), m1 = step((params, opt_state), batch)
    mesh = make_test_mesh(data=4, model=2, device_type="cpu")
    plan = shd.make_plan(cfg, mesh)
    state = fresh(model, opt)
    state = shd.distribute(state, state_shardings(plan, state))
    db = shd.distribute(batch, shd.batch_shardings(plan, batch))
    with activation_hints(mesh):
        loss2, _ = model.loss(state[0], db)
        g2 = torch.autograd.grad(loss2, tree_leaves(state[0]))
        (p2, _), m2 = step(state, db)
    res["loss"] = [float(loss1), float(_full(loss2))]
    res["step_loss"] = [float(m1["loss"]), float(m2["loss"])]
    res["grad_rel"] = max(_rel(_full(b), a) for a, b in zip(g1, g2))
    diffs = torch.cat([(_full(b) - a).detach().abs().flatten()
                       for a, b in zip(tree_leaves(p1), tree_leaves(p2))])
    res["param_max_abs"] = float(diffs.max())
    res["param_frac_off"] = float((diffs > 1e-6).float().mean())
    res["grad_norm"] = [float(m1["grad_norm"]), float(m2["grad_norm"])]
    sharded = [(path, t) for path, t in leaves_with_path(p2)
               if tuple(t.to_local().shape) != tuple(t.shape)]
    res["n_sharded_leaves"] = len(sharded)
    res["n_leaves"] = len(tree_leaves(p2))
    embed = p2["embed"]
    locals_ = [None] * WORLD
    dist.all_gather_object(locals_, (dist.get_rank(), tuple(embed.to_local().shape)))
    res["embed_shards"] = locals_
    res["embed_global"] = list(embed.shape)
    res["mesh_ranks"] = sorted(int(r) for r in mesh.mesh.flatten())

    # -- elastic: a checkpoint saved unsharded restores onto a 2x4 mesh;
    #    a 4x2 DTensor state saved as full tensors restores onto it too
    cfg = get_config("olmo-1b").reduced().replace(dtype="float32")
    model, opt = Model(cfg, device="cpu"), AdamW(lr=1e-3)
    state = fresh(model, opt)
    loss_ref = float(model.loss(state[0], batch)[0])
    plain_dir, sharded_dir = os.path.join(ckpt_dir, "plain"), os.path.join(ckpt_dir, "dt")
    if rank == 0:
        save(plain_dir, 1, state)
    dist.barrier()
    mesh24 = make_test_mesh(data=2, model=4, device_type="cpu")
    plan24 = shd.make_plan(cfg, mesh24)
    like = fresh(model, opt)
    with activation_hints(mesh24):
        s2, manifest = restore(plain_dir, like, shardings=state_shardings(plan24, like))
        res["restored_dtensors"] = all(hasattr(t, "device_mesh") for t in tree_leaves(s2))
        res["restored_requires_grad"] = all(t.requires_grad for t in tree_leaves(s2[0]))
        loss_24 = float(_full(model.loss(s2[0], shd.distribute(
            batch, shd.batch_shardings(plan24, batch)))[0]))
    plan42 = shd.make_plan(cfg, mesh)
    s42 = shd.distribute(fresh(model, opt), state_shardings(plan42, like))
    save(sharded_dir, 2, s42)
    with activation_hints(mesh24):
        s3, _ = restore(sharded_dir, like, shardings=state_shardings(plan24, like))
        loss_42_24 = float(_full(model.loss(s3[0], shd.distribute(
            batch, shd.batch_shardings(plan24, batch)))[0]))
        pairs = tree_map(lambda lay: (lay.mesh, lay.placements),
                         state_shardings(plan24, like))
        s4, _ = restore(plain_dir, like, shardings=pairs)
        res["pairs_equal"] = all(torch.equal(a.to_local(), b.to_local()) and
                                 a.placements == b.placements
                                 for a, b in zip(tree_leaves(s4), tree_leaves(s2)))
    res["elastic"] = [loss_ref, loss_24, loss_42_24]
    res["manifest_step"] = manifest["step"]
    res["placements_24"] = [repr(p) for p in s3[0]["blocks"][0]["attn"]["wq"].placements]
    if rank == 0:
        Path(out_path).write_text(json.dumps(res))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train8")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (8, 33))
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    return _spawn(_train_worker, tmp, batch, str(tmp / "ckpt"))


def test_train_step_4x2_loss_and_grads(train_results):
    r = train_results
    a, b = r["loss"]
    assert abs(a - b) / abs(a) < 1e-5
    assert r["grad_rel"] < 1e-5


def test_train_step_4x2_update(train_results):
    """One full step (AdamW on DTensors, grads synchronised to each
    param's layout) against the single-device step.  AdamW's first
    update is lr * g / (|g| + eps): a gradient within rounding of 0 may
    take the other sign, so a param may differ by up to 2 lr (2e-3)
    where its gradient is ~1e-6 of the largest; all but a few in 1e4
    agree within 1e-6."""
    r = train_results
    a, b = r["step_loss"]
    assert abs(a - b) / abs(a) < 1e-5
    g1, g2 = r["grad_norm"]
    assert abs(g1 - g2) / g1 < 1e-5
    assert r["param_max_abs"] <= 2e-3 * (1 + 1e-4)
    assert r["param_frac_off"] < 1e-4


def test_train_step_8_ranks_hold_shards(train_results):
    r = train_results
    assert r["mesh_ranks"] == list(range(WORLD))
    assert 0 < r["n_sharded_leaves"] <= r["n_leaves"]
    # vocab 256 over model (2): each rank holds half the table's rows
    assert sorted(rank for rank, _ in r["embed_shards"]) == list(range(WORLD))
    assert all(list(shape) == [r["embed_global"][0] // 2, r["embed_global"][1]]
               for _, shape in r["embed_shards"])


def test_elastic_checkpoint_remesh(train_results):
    """Unsharded -> 2x4, and 4x2 DTensors (saved as full tensors) ->
    2x4: the same loss."""
    ref, l24, l4224 = train_results["elastic"]
    assert abs(ref - l24) / abs(ref) < 1e-5
    assert abs(ref - l4224) / abs(ref) < 1e-5
    assert train_results["restored_dtensors"] and train_results["restored_requires_grad"]
    assert train_results["manifest_step"] == 1
    assert train_results["pairs_equal"]     # (mesh, placements) pairs as shardings
    assert train_results["placements_24"] == ["Replicate()", "Shard(dim=1)"]


# ---------------------------------------------------------------- spawn 2
def _decode_worker(rank, store_path, out_path, inputs):
    """The sharded decode step (qwen2.5-3b reduced, cache planned by
    cache_shardings on a 2x4 mesh, B=2 and B=1), and the five kernel
    wrappers' DTensor branch on a 4x2 mesh."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.int4_matmul import ops as i4
    from repro_torch.kernels.paged_decode_attention import ops as pda
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.ssd_update import ops as ssd
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.hints import activation_hints
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model
    _init(rank, store_path)
    res = {}
    T = {k: torch.from_numpy(v) for k, v in inputs.items()}

    # -- decode with a sequence-split cache
    cfg = get_config("qwen2.5-3b").reduced().replace(dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mesh24 = make_test_mesh(data=2, model=4, device_type="cpu")
    plan = shd.make_plan(cfg, mesh24)
    pd = shd.distribute(params, shd.params_shardings(plan, params))
    for B in (2, 1):
        tokens = T["tokens"][:B]
        with torch.no_grad():
            cache = model.init_cache(B, 64)
            _, cache = model.prefill(params, {"tokens": tokens}, cache)
            layouts = shd.cache_shardings(plan, cache)
            cd = shd.distribute({k: v.clone() for k, v in cache.items()}, layouts)
            want, _ = model.decode_step(params, cache, tokens[:, :1])
            with activation_hints(mesh24):
                got, cd = model.decode_step(pd, cd, tokens[:, :1])
            got = got.full_tensor()
            scale = max(1.0, float(want.abs().max()))
            res[f"decode_B{B}"] = float((got - want).abs().max()) / scale
            res[f"cache_B{B}"] = _rel(cd["k"].full_tensor(), cache["k"])
            res[f"cache_spec_B{B}"] = [str(x) for x in layouts["k"].spec]
            res[f"pos_B{B}"] = int(cd["pos"].full_tensor())

    # -- the wrappers on a 4x2 mesh
    mesh = make_test_mesh(data=4, model=2, device_type="cpu")
    R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)

    def put(t, *pl):
        return None if t is None else distribute_tensor(t, mesh, list(pl))
    errs, shapes = {}, {}

    def check(name, got, want, placements, tol=1e-6):
        assert tuple(got.placements) == tuple(placements), (name, got.placements)
        errs[name] = _rel(got.full_tensor(), want)
        shapes[name] = list(got.to_local().shape)
        assert errs[name] <= tol, (name, errs[name])

    x, w, dy = T["norm_x"], T["norm_w"], T["norm_dy"]
    want = rn.rmsnorm(x, w)
    want_dx, want_dw = rn.rmsnorm_bwd(x, w, dy)
    for xp, outp in (((S0, R), (S0, R)), ((S0, S1), (S0, S1)), ((R, S2), (R, R))):
        check(f"rmsnorm {xp}", rn.rmsnorm(put(x, *xp), put(w, R, R)), want, outp)
        xd = put(x, *xp).requires_grad_(True)
        wd = put(w, R, R).requires_grad_(True)
        dx, dw = torch.autograd.grad(rn.rmsnorm(xd, wd), (xd, wd), put(dy, *outp))
        check(f"rmsnorm dx {xp}", dx, want_dx, xp)
        errs[f"rmsnorm dw {xp}"] = _rel(dw.full_tensor(), want_dw)
        assert errs[f"rmsnorm dw {xp}"] <= 1e-5
        res[f"dw placements {xp}"] = [repr(p) for p in dw.placements]
        dx2, dw2 = rn.rmsnorm_bwd(put(x, *xp), put(w, R, R), put(dy, *outp))
        check(f"rmsnorm_bwd dx {xp}", dx2, want_dx, outp)
        errs[f"rmsnorm_bwd dw {xp}"] = _rel(dw2.full_tensor(), want_dw)
    q, k, v, mask = T["q"], T["k"], T["v"], T["mask"]
    want = da.decode_attention(q, k, v, mask)
    for qp, kp, mp_, outp in (((S0, S1), (S0, S2), (S0, R), (S0, S1)),
                              ((S0, R), (S0, S1), (S0, S1), (S0, R)),
                              ((R, R), (S1, S1), (R, R), (R, R))):
        check(f"decode_attention q{qp} k{kp}",
              da.decode_attention(put(q, *qp), put(k, *kp), put(v, *kp),
                                  put(mask, *mp_)), want, outp)
    for quant in (False, True):
        args = [T[n] for n in ("pq", "pk8" if quant else "pk", "pv8" if quant else "pv",
                               "bt", "lens")]
        scales = [T["pks"], T["pvs"]] if quant else [None, None]
        want = pda.paged_decode_attention(*args, *scales)
        for qp, pp in (((S0, R), (R, R)), ((S0, S1), (S0, S2)), ((R, S1), (S1, S2))):
            pq, pk, pv, bt, lens = args
            got = pda.paged_decode_attention(
                put(pq, *qp), put(pk, *pp), put(pv, *pp), put(bt, qp[0], R),
                put(lens, qp[0], R), *(put(s, *pp) for s in scales))
            check(f"paged int8={quant} q{qp} pools{pp}", got, want, qp)
    x4, packed, sc = T["x4"], T["packed"], T["scales"]
    want = i4.int4_matmul(x4, packed, sc, group=32)
    for xp, wp, outp in (((S0, R), (R, S1), (S0, S1)), ((R, S1), (S0, R), (R, R)),
                         ((S0, S1), (S1, S1), (R, S1))):
        check(f"int4 x{xp} w{wp}", i4.int4_matmul(put(x4, *xp), put(packed, *wp),
                                                   put(sc, *wp), group=32), want, outp)
    h, xs, dt, A, Bm, Cm = (T[n] for n in ("h", "xs", "dt", "A", "Bm", "Cm"))
    want_h, want_y = ssd.ssd_update(h.clone(), xs, dt, A, Bm, Cm)
    # heads (with Bm / Cm's groups) over model, N gathered, P over model
    for hp, ap, bp in (((S0, S1), (R, S0), (S0, S1)), ((S0, S1), (R, S0), (S0, S2)),
                       ((R, S2), (R, R), (R, R))):
        hd_ = put(h.clone(), *hp)
        got_h, got_y = ssd.ssd_update(hd_, put(xs, *hp),
                                      put(dt, *(p if p != S2 else R for p in hp)),
                                      put(A, *ap), put(Bm, *bp), put(Cm, *bp), out=hd_)
        assert got_h is hd_
        check(f"ssd h' h{hp} Bm{bp}", got_h, want_h, hp)
        check(f"ssd y h{hp} Bm{bp}", got_y, want_y, hp)
    # -- a DTensor (data_ptr 0) is refused by every launcher's check
    dtx = put(x.reshape(-1, x.shape[-1]), S0, R)
    res["dtensor_data_ptr"] = dtx.data_ptr()
    refused = {}
    for name, call in (
            ("rmsnorm", lambda: rn._check(dtx, None)),
            ("decode_attention", lambda: da._check(put(q, R, R), k, v, mask)),
            ("paged_decode_attention", lambda: pda._check(
                put(T["pq"], R, R), T["pk"], T["pv"], T["bt"], T["lens"], None, None)),
            ("int4_matmul", lambda: i4._check(put(x4, R, R), packed, sc, 32)),
            ("ssd_update", lambda: ssd._check(put(h, R, R), xs, dt, A, Bm, Cm, None))):
        try:
            call()
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    res["refused"] = refused
    res["errs"], res["local_shapes"] = errs, shapes
    if rank == 0:
        Path(out_path).write_text(json.dumps(res))
    import torch.distributed as dist
    dist.destroy_process_group()


def _decode_inputs():
    from repro_torch.quant.kv import quantize_kv_write
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    n_pages, page = 1 + 8 * 4, 16
    pk, pv = f(n_pages, page, 2, 32), f(n_pages, page, 2, 32)
    (pk8, pks), (pv8, pvs) = (quantize_kv_write(torch.from_numpy(t)) for t in (pk, pv))
    bt = (1 + rng.permutation(n_pages - 1)).reshape(8, 4).astype(np.int32)
    lens = np.array([64, 0, 17, 33, 50, 1, 64, 20], dtype=np.int32)
    mask = rng.random((8, 64)) < 0.8
    mask[2] = False
    return {
        "tokens": rng.integers(0, 256, (2, 16)),
        "norm_x": 3 * f(8, 6, 64), "norm_w": 1 + 0.1 * f(64), "norm_dy": f(8, 6, 64),
        "q": f(8, 8, 32), "k": f(8, 64, 2, 32), "v": f(8, 64, 2, 32), "mask": mask,
        "pq": f(8, 8, 32), "pk": pk, "pv": pv, "pk8": pk8.numpy(), "pv8": pv8.numpy(),
        "pks": pks.numpy(), "pvs": pvs.numpy(), "bt": bt, "lens": lens,
        "x4": f(8, 128), "packed": rng.integers(0, 256, (64, 64)).astype(np.uint8),
        "scales": (0.005 + 0.01 * rng.random((4, 64))).astype(np.float32),
        "h": f(4, 8, 16, 16), "xs": f(4, 8, 16), "dt": np.log1p(np.exp(f(4, 8))),
        "A": -np.exp(f(8)), "Bm": f(4, 2, 16), "Cm": f(4, 2, 16),
    }


@pytest.fixture(scope="module")
def decode_results(tmp_path_factory):
    return _spawn(_decode_worker, tmp_path_factory.mktemp("decode8"), _decode_inputs())


@pytest.mark.parametrize("B", [2, 1])
def test_decode_step_seq_sharded_cache(decode_results, B):
    """Batch over data and the sequence over model (B=2); the sequence
    over data and model (B=1): logits and the written cache rows equal
    the single-device step's."""
    r = decode_results
    assert r[f"decode_B{B}"] < 1e-5
    assert r[f"cache_B{B}"] < 1e-5
    assert r[f"pos_B{B}"] == 17
    want = (["None", "data", "model", "None", "None"] if B == 2
            else ["None", "None", "('data', 'model')", "None", "None"])
    assert r[f"cache_spec_B{B}"] == want


@pytest.mark.parametrize("kernel", ["rmsnorm", "decode_attention", "paged", "int4", "ssd"])
def test_wrapper_dtensor_branch(decode_results, kernel):
    """Each wrapper on DTensor inputs split over the batch and over a
    reduced dim equals the plain call on the full tensors."""
    errs = {k: v for k, v in decode_results["errs"].items() if k.startswith(kernel)}
    assert len(errs) >= 3
    assert all(e <= 1e-5 for e in errs.values()), errs


def test_rmsnorm_dw_partial_over_row_split(decode_results):
    """dw of rows split over data (and model) comes back Partial there."""
    r = decode_results
    assert r["dw placements (Shard(dim=0), Replicate())"] == ["Partial(sum)", "Replicate()"]
    assert r["dw placements (Shard(dim=0), Shard(dim=1))"] == ["Partial(sum)",
                                                                "Partial(sum)"]
    assert r["dw placements (Replicate(), Shard(dim=2))"] == ["Replicate()", "Replicate()"]
    # the work was split: batch rows over 4 ranks
    assert r["local_shapes"]["rmsnorm (Shard(dim=0), Replicate())"] == [2, 6, 64]


def test_check_refuses_null_pointer(decode_results):
    r = decode_results
    assert r["dtensor_data_ptr"] == 0
    for name, msg in r["refused"].items():
        assert msg is not None and name in msg and "DTensor" in msg, (name, msg)


# ---------------------------------------------------------------- import, launcher
def test_mesh_import_touches_no_device_and_no_group():
    code = textwrap.dedent("""
        import json
        import torch
        import repro_torch.launch.mesh as m
        import repro_torch.launch.sharding, repro_torch.launch.hints  # noqa
        assert callable(m.make_production_mesh)
        print(json.dumps({"cuda": torch.cuda.is_initialized(),
                          "dist": torch.distributed.is_initialized()}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"cuda": False, "dist": False}


ARGS = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu", "--steps", "4",
        "--batch", "4", "--seq-len", "32"]


def _loss(line):
    a, b = line.split("loss ")[1].split(" (")[0].split(" -> ")
    return float(a), float(b)


def test_train_distributed_world1_in_process(tmp_path, capsys):
    """On a world-1 gloo group started in the process, ``--distributed``
    joins it (a 1x1 mesh, the plan's DTensors, uncaptured) and prints
    the loss line of the run without the flag."""
    import torch.distributed as dist
    from repro_torch.launch import train
    train.main(ARGS)
    plain = capsys.readouterr().out.strip().splitlines()[-1]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        train.main(ARGS + ["--distributed"])
    finally:
        dist.destroy_process_group()
    lines = capsys.readouterr().out.strip().splitlines()
    assert "uncaptured" in lines[0]
    assert lines[-1] == plain


def test_train_distributed_torchrun_world2():
    """``torch.distributed.run --standalone --nproc-per-node 2`` (gloo):
    both ranks print the loss line; it matches the run without the flag
    to the bf16 rounding of the ranks' gradient sums (the reduced config
    is bf16: two half-batch gradients rounded and summed are not the
    full batch's rounded once)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = [sys.executable, "-m", "repro_torch.launch.train", *ARGS]
    plain = subprocess.run(run, capture_output=True, text=True, env=env, timeout=600)
    assert plain.returncode == 0, plain.stderr[-2000:]
    dist_run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *ARGS,
         "--distributed"], capture_output=True, text=True, env=env, timeout=600)
    assert dist_run.returncode == 0, dist_run.stderr[-3000:]
    want = plain.stdout.strip().splitlines()[-1]
    got = [ln for ln in dist_run.stdout.splitlines() if ln.startswith("steps=")]
    assert len(got) == 2 and got[0] == got[1]
    (a0, b0), (a1, b1) = _loss(want), _loss(got[0])
    assert a0 == a1                      # the first loss: the same forward
    assert abs(b0 - b1) <= 2e-3 * abs(b0)
