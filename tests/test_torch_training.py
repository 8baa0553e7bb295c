"""The port's training substrate on the CPU: AdamW against the JAX
package's on identical numpy gradients, the data pipeline, checkpoints,
the fault-tolerant loop and the training launcher.

Tolerances: AdamW params and moments within 1e-6 relative of the
reference's after 5 updates (f32 on both sides, the same formulas);
the schedule and the global norm within 1e-6 relative."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import AdamW as JaxAdamW
from repro.training import cosine_schedule as jax_cosine_schedule
from repro.training.optimizer import global_norm as jax_global_norm
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.training import (AdamW, DataCursor, DataLoader, Preemption,
                                  cosine_schedule, global_norm, jit_train_step,
                                  latest_step, make_train_step, restore,
                                  run_training, save, synthetic_batch, trainable)
from repro_torch.training.tree import leaves_with_path, path_key

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
CFG = get_config("internlm2-1.8b").reduced()
SHAPES = {"w": (6, 5), "b": (5,), "blocks": [{"a": (4,)}, {"a": (4,)}]}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, rng, scale) for v in shapes]
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype) for v in tree]
    return torch.from_numpy(tree.copy()).to(dtype)


def _close(port, ref, rtol):
    if isinstance(port, dict):
        for k in port:
            _close(port[k], ref[k], rtol)
    elif isinstance(port, list):
        for a, b in zip(port, ref):
            _close(a, b, rtol)
    else:
        np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=rtol, atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_reference(clip, schedule):
    rng = np.random.default_rng(3)
    params = _tree(SHAPES, rng)
    grads = [_tree(SHAPES, rng, scale=3.0) for _ in range(5)]
    lr = (cosine_schedule(1e-2, 2, 5), jax_cosine_schedule(1e-2, 2, 5)) if schedule \
        else (1e-2, 1e-2)
    opt, jopt = AdamW(lr=lr[0], clip_norm=clip), JaxAdamW(lr=lr[1], clip_norm=clip)
    p = _to_torch(params)
    state = opt.init(p)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    for g in grads:
        p2, state2, m = opt.update(_to_torch(g), state, p)
        assert p2 is p and state2.mu is state.mu     # in place
        jp, jstate, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.step) == int(jstate.step) == 5
    assert state.step.dtype == torch.int32
    _close(p, jax.tree_util.tree_map(np.asarray, jp), 1e-6)
    _close(state.mu, jax.tree_util.tree_map(np.asarray, jstate.mu), 1e-6)
    _close(state.nu, jax.tree_util.tree_map(np.asarray, jstate.nu), 1e-6)


def test_adamw_keeps_bf16_params_and_f32_moments():
    opt = AdamW(lr=1e-3)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    new, state, m = opt.update({"w": torch.ones(4, dtype=torch.bfloat16)}, state, params)
    assert new["w"].dtype == torch.bfloat16 and state.mu["w"].dtype == torch.float32
    assert torch.is_tensor(m["lr"]) and torch.is_tensor(m["grad_norm"])


def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0], requires_grad=True)}
    state = opt.init(params)
    for _ in range(200):
        g, = torch.autograd.grad(torch.sum(params["w"] ** 2), [params["w"]])
        params, state, _ = opt.update({"w": g}, state, params)
    assert float(params["w"].detach().abs().max()) < 0.05


@pytest.mark.parametrize("step", [0, 1, 49, 50, 51, 500, 999, 1000, 1200])
def test_cosine_schedule_and_global_norm_match_reference(step):
    got = cosine_schedule(1e-3, warmup=50, total=1000)(torch.tensor(step, dtype=torch.int32))
    want = jax_cosine_schedule(1e-3, warmup=50, total=1000)(jnp.int32(step))
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)
    tree = _tree(SHAPES, np.random.default_rng(step))
    assert float(global_norm(_to_torch(tree))) == pytest.approx(
        float(jax_global_norm(jax.tree_util.tree_map(jnp.asarray, tree))), rel=1e-6)


class TestData:
    def test_deterministic_in_cursor(self):
        b1 = synthetic_batch(CFG, DataCursor(3, 17), batch=4, seq_len=16)
        b2 = synthetic_batch(CFG, DataCursor(3, 17), batch=4, seq_len=16)
        b3 = synthetic_batch(CFG, DataCursor(3, 18), batch=4, seq_len=16)
        assert torch.equal(b1["tokens"], b2["tokens"])
        assert not torch.equal(b1["tokens"], b3["tokens"])

    def test_disjoint_shards(self):
        b0 = synthetic_batch(CFG, DataCursor(0, 0), batch=8, seq_len=16,
                             shard=0, shard_count=2)
        b1 = synthetic_batch(CFG, DataCursor(0, 0), batch=8, seq_len=16,
                             shard=1, shard_count=2)
        assert not torch.equal(b0["tokens"], b1["tokens"])
        assert b0["tokens"].shape == (4, 16)

    def test_labels_are_next_tokens(self):
        b = synthetic_batch(CFG, DataCursor(0, 0), batch=2, seq_len=16)
        assert b["labels"].shape == b["tokens"].shape
        assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])

    def test_arith_recurrence(self):
        b = synthetic_batch(CFG, DataCursor(1, 2), batch=3, seq_len=20, mode="arith")
        assert torch.equal(b["labels"], (5 * b["tokens"] + 17) % CFG.vocab_size)

    def test_vlm_and_audio_keys(self):
        vl = get_config("qwen2-vl-2b").reduced()
        b = synthetic_batch(vl, DataCursor(0, 0), batch=2, seq_len=8)
        assert set(b) == {"embeds", "positions", "labels"}
        assert b["embeds"].shape == (2, 8, vl.d_model) and b["embeds"].dtype == torch.bfloat16
        assert b["positions"].shape == (2, 8, 3)
        au = get_config("musicgen-large").reduced()
        b = synthetic_batch(au, DataCursor(0, 0), batch=2, seq_len=8, mode="arith")
        assert b["tokens"].shape == b["labels"].shape == (2, 8, au.n_codebooks)

    def test_loader_advances_its_cursor(self):
        loader = DataLoader(CFG, batch=2, seq_len=8, seed=4, start_step=5)
        first = next(loader)
        assert loader.cursor.step == 6
        assert torch.equal(first["tokens"], synthetic_batch(
            CFG, DataCursor(4, 5), batch=2, seq_len=8)["tokens"])


def _state():
    opt = AdamW()
    params = {"a": torch.arange(15, dtype=torch.float32).reshape(3, 5).to(torch.bfloat16) * 1.5,
              "blocks": [{"w": torch.randn(4), "n": None}, {"w": torch.randn(4), "n": None}],
              "c": torch.arange(4, dtype=torch.int32)}
    return (params, opt.init({k: v for k, v in params.items() if k != "c"}))


class TestCheckpoint:
    def test_roundtrip_with_optimizer_state(self, tmp_path):
        state = _state()
        state[1].step.fill_(7)
        state[1].mu["a"].fill_(0.25)
        save(str(tmp_path), 7, state, cursor={"step": 7})
        like = _state()
        out, manifest = restore(str(tmp_path), like)
        assert manifest["step"] == 7 and manifest["cursor"] == {"step": 7}
        assert manifest["raw_dtypes"]["0/a"] == {"dtype": "bfloat16", "shape": [3, 5]}
        for (path, a), (_, b) in zip(leaves_with_path(out), leaves_with_path(state)):
            assert a.dtype == b.dtype and torch.equal(a, b), path_key(path)
        assert out[0]["blocks"][1]["n"] is None and int(out[1].step) == 7
        with np.load(tmp_path / "step_00000007" / "arrays.npz") as arrays:
            assert arrays["0/a"].dtype == np.uint16
            assert arrays["1/mu/blocks/1/w"].dtype == np.float32

    def test_restore_keeps_requires_grad(self, tmp_path):
        params = trainable({"w": torch.ones(3)})
        save(str(tmp_path), 1, params)
        out, _ = restore(str(tmp_path), params)
        assert out["w"].requires_grad and out["w"] is not params["w"]

    def test_keep_last_k(self, tmp_path):
        tree = {"a": torch.zeros(2)}
        for s in (1, 2, 3, 4, 5):
            save(str(tmp_path), s, tree, keep=2)
        steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
        assert steps == ["step_00000004", "step_00000005"]

    def test_atomic_latest_pointer(self, tmp_path):
        tree = {"a": torch.zeros(2)}
        save(str(tmp_path), 3, tree)
        assert latest_step(str(tmp_path)) == 3
        assert (tmp_path / "LATEST").read_text() == "step_00000003"
        assert not (tmp_path / "LATEST.tmp").exists()
        json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
        # a half-written step (crash before the rename) is not pointed to
        (tmp_path / "step_00000004.tmp").mkdir()
        assert latest_step(str(tmp_path)) == 3

    def test_no_ml_dtypes_after_port_only_import(self):
        code = ("import sys, repro_torch.training, repro_torch.launch.train, "
                "repro_torch.bridge; "
                "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'; "
                "assert 'jax' not in sys.modules, 'jax imported'")
        subprocess.run([sys.executable, "-c", code], env=ENV, check=True, timeout=120)


class TestFaultTolerance:
    def _run(self, ckpt_dir, failure_hook=None, steps=8):
        model = Model(CFG, device="cpu")
        opt = AdamW(lr=1e-3)
        step = jit_train_step(make_train_step(model, opt))

        def init():
            params = trainable(model.init(torch.Generator().manual_seed(0)))
            return (params, opt.init(params))
        loader = DataLoader(CFG, batch=2, seq_len=16, seed=5)
        return run_training(train_step=step, init_state=init, loader=loader,
                            ckpt_dir=ckpt_dir, total_steps=steps, ckpt_every=3,
                            failure_hook=failure_hook)

    def test_restart_bit_identical(self, tmp_path):
        r_clean = self._run(str(tmp_path / "a"))
        armed = {"on": True}

        def boom(step):
            if step == 5 and armed["on"]:
                armed["on"] = False
                raise Preemption(step)
        r_faulty = self._run(str(tmp_path / "b"), failure_hook=boom)
        assert r_faulty.restarts == 1 and r_clean.restarts == 0
        assert (r_clean.metrics_history[-1]["loss"]
                == r_faulty.metrics_history[-1]["loss"])
        # steps 3 and 4 ran twice: before the preemption and after the restore
        assert len(r_faulty.metrics_history) == len(r_clean.metrics_history) + 2
        assert latest_step(str(tmp_path / "b")) == 8

    def test_gives_up_after_max_restarts(self, tmp_path):
        def always_boom(step):
            raise Preemption(step)
        with pytest.raises(Preemption):
            self._run(str(tmp_path / "c"), failure_hook=always_boom)


def test_train_cli_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2.5-3b",
         "--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
         "--seq-len", "16", "--ckpt-dir", str(tmp_path)],
        env=ENV, check=True, timeout=120, capture_output=True, text=True).stdout
    last = out.strip().splitlines()[-1]
    assert last.startswith("steps=4 loss ") and last.endswith("(restarts=0)")
    assert latest_step(str(tmp_path)) == 4


def test_train_cli_distributed_raises(monkeypatch):
    """Outside ``torch.distributed.run`` (no process group, no RANK in the
    environment) ``--distributed`` cannot start a group and raises; under
    the launcher it trains (tests/test_torch_multidevice.py)."""
    import torch.distributed as dist
    from repro_torch.launch import train
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        train.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                    "--distributed"])
    assert not dist.is_initialized()
