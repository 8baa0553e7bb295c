"""The port's examples (``examples/torch/*.py``) against the JAX
package's (``examples/*.py``), on the CPU, with weights bridged from the
reference's ``Model.init`` and data made with numpy.

- quickstart: the train step's loss and grad norm within 1e-5 relative
  (f32 on both sides; the frameworks sum in different orders), and the
  greedy tokens after it identical, for the default qwen2-moe-a2.7b and
  the dense qwen2.5-3b;
- serve_stream: the 8 batched bf16-path streams identical to the
  reference engine's, and the fused loop's tokens equal to the streamed
  loop's;
- train_dense at 40 steps: one restart, and the loss falls;
- quant_ablation: each path's charge equal to the reference's
  ``tree_weight_traffic`` where the two rules agree, and above it by
  exactly 4 bytes a quantised element (the bf16 copy written and read)
  for int8_fused, where the port charges the copy its route moves; the
  H100 floors equal the reference's;
- and each script run as it is with ``--device cpu``: exit 0, ``OK``;
  the bridge takes the reference's bf16 leaves bit for bit.

About 60 s on one worker (the four scripts 30 s of it)."""
import importlib.util
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import floor as jax_floor
from repro.core.hardware import GPU_H100 as JAX_H100
from repro.models.model import Model as JaxModel
from repro.quant import quantize_tree as jax_quantize_tree
from repro.quant import tree_weight_traffic as jax_traffic
from repro.serving import DecodeEngine as JaxEngine
from repro.training import AdamW as JaxAdamW
from repro.training import jit_train_step as jax_jit_train_step
from repro.training import make_train_step as jax_make_train_step
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
ENV = dict(os.environ, PYTHONPATH="")
CPU = torch.device("cpu")


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(seed)))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2.5-3b"])
def test_quickstart_equals_reference(arch):
    jcfg = jax_get_config(arch).reduced().replace(dtype="float32")
    cfg = get_config(arch).reduced().replace(dtype="float32")
    np_params = _jax_params(jcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    prompt = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)

    model = JaxModel(jcfg)
    opt = JaxAdamW(lr=1e-3)
    step = jax_jit_train_step(jax_make_train_step(model, opt))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    state, metrics = step((params, opt.init(params)),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    want = JaxEngine(model, state[0]).generate_streamed(
        {"tokens": jnp.asarray(prompt)}, max_len=96, n_new=8)

    got = _example("quickstart").quickstart(
        cfg, from_jax_params(np_params, cfg, CPU), CPU,
        {k: torch.from_numpy(v).long() for k, v in batch.items()},
        {"tokens": torch.from_numpy(prompt).long()})
    assert _rel(got["loss"], float(metrics["loss"])) <= 1e-5
    assert _rel(got["grad_norm"], float(metrics["grad_norm"])) <= 1e-5
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want.tokens))


def test_serve_stream_equals_reference():
    mod = _example("serve_stream")
    cfg = mod.config().replace(dtype="float32")
    jcfg = jax_get_config("qwen2.5-3b").reduced().replace(
        d_model=256, d_ff=512, n_layers=8, vocab_size=2048, dtype="float32")
    np_params = _jax_params(jcfg)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (8, 24)).astype(np.int32)
    want = JaxEngine(JaxModel(jcfg), jax.tree_util.tree_map(jnp.asarray, np_params)) \
        .generate_streamed({"tokens": jnp.asarray(tokens)}, max_len=128, n_new=32)
    got = mod.serve_stream(cfg, from_jax_params(np_params, cfg, CPU), CPU,
                           torch.from_numpy(tokens).long())
    np.testing.assert_array_equal(got["streams"].numpy(), np.asarray(want.tokens))
    assert torch.equal(got["fused"], got["streamed"])
    # the first stream alone, streamed, is the batch's first stream
    assert torch.equal(got["streamed"][0], got["streams"][0])
    assert set(got["p50_ms"]) == {"bf16", "int8_fused", "int4_fused"}


def test_train_dense_restarts_and_learns():
    mod = _example("train_dense")
    cfg = mod.config()
    jcfg = jax_get_config("olmo-1b").reduced().replace(
        d_model=192, d_ff=384, n_layers=4, vocab_size=512)
    params = from_jax_params(_jax_params(jcfg), cfg, CPU)
    before = {k: v.clone() for k, v in params.items() if isinstance(v, torch.Tensor)}
    with tempfile.TemporaryDirectory() as ckpt:
        res = mod.train_dense(cfg, params, CPU, 40, ckpt)
    losses = [h["loss"] for h in res.metrics_history]
    assert res.step == 40 and res.restarts == 1
    assert len(losses) == 20 + 40          # preempted at step 20, before any checkpoint
    assert losses[-1] < losses[0]
    assert all(torch.equal(params[k], v) for k, v in before.items())


def test_quant_ablation_charges_against_reference():
    from repro_torch.quant import quantize_tree
    mod = _example("quant_ablation")
    cfg = get_config("qwen2.5-3b").reduced().replace(vocab_size=1024)
    jcfg = jax_get_config("qwen2.5-3b").reduced().replace(vocab_size=1024)
    np_params = _jax_params(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = from_jax_params(np_params, cfg, CPU)
    prompt = {"tokens": torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 16))).long()}
    full = get_config("qwen2.5-3b")
    rows = mod.ablation(cfg, params, CPU, prompt, full=full)
    assert [r["path"] for r in rows] == list(mod.WEIGHT_PATHS)
    for r in rows:
        want = jax_traffic(jax_quantize_tree(jparams, r["path"]))
        if r["path"] == "int8_fused":
            q = quantize_tree(params, "int8_fused")
            copies = sum(4 * w.data.numel() for w in _quantized(q))
            assert copies > 0
            assert r["traffic_bytes"] == pytest.approx(want + copies, rel=1e-12)
        else:
            assert r["traffic_bytes"] == pytest.approx(want, rel=1e-12), r["path"]
        floor = jax_floor.floor_cell(jax_get_config("qwen2.5-3b"), JAX_H100, 2048,
                                     weight_dtype_bytes=mod.NOMINAL_BYTES[r["path"]])
        assert r["floor_ms"] == pytest.approx(floor.t_floor_ms, rel=1e-12)
        assert np.isfinite(r["p50_ms"]) and r["tokens"].shape == (1, 16)
    assert mod.vs_bf16(rows)["bf16"] == 1.0
    assert "int4_fused" in mod.summary(rows)
    one = mod.ablation(cfg, params, CPU, prompt, full=full, paths=("int8_fused",))
    assert [r["path"] for r in one] == ["int8_fused"]
    assert one[0]["traffic_bytes"] == rows[2]["traffic_bytes"]


def _quantized(node):
    from repro_torch.quant import QuantizedTensor
    if isinstance(node, dict):
        for v in node.values():
            yield from _quantized(v)
    elif isinstance(node, list):
        for v in node:
            yield from _quantized(v)
    elif isinstance(node, QuantizedTensor):
        yield node


def test_bridge_takes_bf16_leaves():
    """The reference's bf16 params (ml_dtypes arrays, whose numpy buffer
    the bridge must not touch) come across bit for bit: train_dense and
    quant_ablation run bridged bf16 weights."""
    jcfg = jax_get_config("qwen2.5-3b").reduced()
    np_params = _jax_params(jcfg)
    params = from_jax_params(np_params, get_config("qwen2.5-3b").reduced(), CPU)
    for key in ("embed", "final_norm"):
        assert params[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(params[key].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(np_params[key]).view(np.uint16))
    wq = params["blocks"][1]["attn"]["wq"]
    np.testing.assert_array_equal(wq.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(np_params["blocks"]["attn"]["wq"][1])
                                  .view(np.uint16))


@pytest.mark.parametrize("script", ["quickstart.py", "serve_stream.py",
                                    "train_dense.py --steps 40", "quant_ablation.py"])
def test_script_runs_on_the_cpu(script, tmp_path):
    """Each example as a user runs it, from another directory, with no
    PYTHONPATH: exit 0 and ``OK`` last."""
    name, *args = script.split()
    proc = subprocess.run([sys.executable, str(EXAMPLES / name), *args, "--device", "cpu"],
                          cwd=tmp_path, env=ENV, text=True, capture_output=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"
