"""The port's training path against the JAX package's, on the CPU, in
f32, on the reduced configs, with weights bridged from the JAX
``Model.init`` and batches made from a seed with numpy.

Each family's loss and gradients (``Model.loss`` under
``torch.autograd.grad`` against ``jax.value_and_grad``), the RMSNorm
gradient's plain version (the formula the backward kernel computes,
reached through ``RMSNormFunction`` on every norm of the port's
models), remat, microbatches, int8 gradient compression, the whole
train step over several steps, and the learnable data mode.

Tolerances: loss, ce and aux within 1e-5 relative and each gradient
leaf within 1e-5 x that leaf's max|g| (f32 on both sides; the frameworks
sum matmuls and reductions in different orders).  Several steps of the
whole train step: losses within 1e-4 relative (AdamW's first update is
about lr x sign(g) elementwise, so an element whose gradient is rounding
noise moves by +-lr in either framework; the losses, not every param,
are compared after it)."""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.common import rmsnorm as jax_rmsnorm
from repro.models.model import Model as JaxModel
from repro.training import AdamW as JaxAdamW
from repro.training import jit_train_step as jax_jit_train_step
from repro.training import make_train_step as jax_make_train_step
from repro_torch.bridge import (from_jax_opt_state, from_jax_params,
                                to_reference_layout)
from repro_torch.configs import get_config
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.models.model import Model
from repro_torch.training import (AdamW, DataLoader, jit_train_step,
                                  make_train_step, trainable)
from repro_torch.training.train_loop import compress_int8

FAMILIES = ("qwen2.5-3b", "olmo-1b", "qwen2-moe-a2.7b", "mamba2-2.7b",
            "zamba2-1.2b", "qwen2-vl-2b", "musicgen-large")
B, S = 2, 16


def _cfgs(name):
    return (jax_get_config(name).reduced().replace(dtype="float32"),
            get_config(name).reduced().replace(dtype="float32"))


def _perturb(p, rng):
    """Biases and norm weights off their 0 / 1 init, so that their
    gradients are tested away from a special point."""
    def visit(node, name=None):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if node is not None and name in ("bq", "bk", "bv", "norm1", "norm2",
                                         "final_norm", "gate_norm", "conv_b"):
            return node + 0.1 * rng.standard_normal(node.shape).astype(node.dtype)
        return node
    return visit(p)


def _batch(cfg, rng, b=B, s=S):
    """A numpy training batch in the reference's shapes.  The vlm's
    embeddings are f32 (the port casts ``embeds`` to the model dtype,
    the reference promotes after the first norm: in f32 both see the
    same values) with t, h and w positions that differ."""
    if cfg.n_codebooks:
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1, cfg.n_codebooks))
    else:
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    toks = toks.astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        t = np.arange(s)
        thw = np.stack([t, t // 3, (5 * t) % 7], axis=-1)
        out["positions"] = np.broadcast_to(thw, (b, s, 3)).astype(np.int32).copy()
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        out.pop("tokens")
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _setup(name):
    jcfg, cfg = _cfgs(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0))), rng)
    return jcfg, cfg, np_params, _batch(jcfg, rng)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name):
    jcfg, _, np_params, batch = _setup(name)
    model = JaxModel(jcfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b), has_aux=True))
    (_, metrics), grads = fn(jax.tree_util.tree_map(jnp.asarray, np_params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(name, remat="none"):
    _, cfg, np_params, batch = _setup(name)
    model = Model(cfg, device="cpu", remat=remat)
    params = trainable(from_jax_params(np_params, cfg, "cpu"))
    total, metrics = model.loss(params, _torch_batch(batch))
    leaves = [p for p in jax.tree_util.tree_leaves(params)]
    grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    gtree = jax.tree_util.tree_map(lambda _: next(it), params)
    return {k: float(v.detach()) for k, v in metrics.items()}, gtree, cfg


def _assert_grads_close(port_ref_layout, jax_grads, tol=1e-5):
    flat_p = jax.tree_util.tree_flatten_with_path(port_ref_layout)[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax_grads)[0])
    assert len(flat_p) == len(flat_j)
    for path, g in flat_p:
        want = flat_j[path]
        assert g.shape == want.shape, path
        scale = float(np.abs(want).max())
        err = float(np.abs(g - want).max())
        assert scale > 0, f"{jax.tree_util.keystr(path)}: zero gradient"
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_loss_and_grads_match_jax(name):
    want_metrics, want_grads = _jax_loss_and_grads(name)
    metrics, grads, cfg = _port_loss_and_grads(name)
    for k in ("loss", "ce", "aux"):
        assert metrics[k] == pytest.approx(want_metrics[k], rel=1e-5, abs=1e-7), k
    if cfg.family == "moe":
        assert want_metrics["aux"] > 0
    _assert_grads_close(to_reference_layout(grads, cfg), want_grads)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "zamba2-1.2b"])
def test_remat_blocks_grads_equal_none(name):
    _, g_none, cfg = _port_loss_and_grads(name, "none")
    m_blk, g_blk, _ = _port_loss_and_grads(name, "blocks")
    for a, b in zip(jax.tree_util.tree_leaves(g_none), jax.tree_util.tree_leaves(g_blk)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("parametric", [True, False])
@pytest.mark.parametrize("shape", [(1, 64), (7, 96), (2, 5, 128)])
def test_rmsnorm_bwd_ref_matches_jax_grad(shape, parametric):
    rng = np.random.default_rng(sum(shape))
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jw = jnp.asarray(w) if parametric else None
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm(a, b), jnp.asarray(x), jw)
    jdx, jdw = vjp(jnp.asarray(dy))
    tw = torch.from_numpy(w) if parametric else None
    dx, dw = rmsnorm_bwd_ref(torch.from_numpy(x), tw, torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jdx).max()))
    # and against autograd of the forward's plain version
    tx = torch.from_numpy(x).requires_grad_()
    tw2 = torch.from_numpy(w).requires_grad_() if parametric else None
    auto = torch.autograd.grad(rmsnorm_ref(tx, tw2), [t for t in (tx, tw2) if t is not None],
                               torch.from_numpy(dy))
    torch.testing.assert_close(dx, auto[0], rtol=1e-5, atol=1e-6)
    if parametric:
        np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jdw).max()))
        torch.testing.assert_close(dw, auto[1], rtol=1e-5, atol=1e-5)
    else:
        assert dw is None and jdw is None


def test_rmsnorm_enters_the_function_only_under_grad():
    x = torch.randn(3, 64, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    assert type(rms_ops.rmsnorm(x, w).grad_fn).__name__ == "RMSNormFunctionBackward"
    with torch.inference_mode():
        assert rms_ops.rmsnorm(x, w).grad_fn is None
    with torch.no_grad():
        assert rms_ops.rmsnorm(x, w).grad_fn is None
    assert rms_ops.rmsnorm(x.detach(), None).grad_fn is None


def _one_step_moments(name, **kw):
    """mu after one step with lr 0 and no clip: (1 - b1) x the step's
    gradient, in the reference's layout (port) and the reference's."""
    jcfg, cfg, np_params, _ = _setup(name)
    batch = _batch(jcfg, np.random.default_rng(7), b=4)
    jopt = JaxAdamW(lr=0.0, clip_norm=None)
    jstep = jax.jit(jax_make_train_step(JaxModel(jcfg), jopt, remat="none", **kw))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    (_, jstate), jm = jstep((jp, jopt.init(jp)),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    opt = AdamW(lr=0.0, clip_norm=None)
    step = make_train_step(Model(cfg, device="cpu"), opt, remat="none", **kw)
    params = trainable(from_jax_params(np_params, cfg, "cpu"))
    (_, state), m = step((params, opt.init(params)), _torch_batch(batch))
    return (to_reference_layout(state.mu, cfg),
            jax.tree_util.tree_map(np.asarray, jstate.mu), m, jm, cfg)


def test_microbatches_equal_full_batch():
    mu2, jmu2, m2, jm2, cfg = _one_step_moments("qwen2.5-3b", microbatches=2)
    mu1, _, _, _, _ = _one_step_moments("qwen2.5-3b")
    _assert_grads_close(mu2, jax.tree_util.tree_map(np.asarray, mu1))
    _assert_grads_close(mu2, jmu2)
    # the last microbatch's metrics, as in the reference
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]), rel=1e-5)


def test_int8_compression_matches_jax():
    mu, jmu, _, _, _ = _one_step_moments("qwen2.5-3b", grad_compression="int8")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jmu)[0])
    flips = total = 0
    for path, a in jax.tree_util.tree_flatten_with_path(mu)[0]:
        b = flat_j[path]
        step = float(np.abs(b).max()) / 127    # one code: mu = (1 - b1) q(g)
        diff = np.abs(a - b)
        # the frameworks' gradients differ by ~1e-7 of max|g|: a code
        # may differ by one where g / s sits that close to a .5 boundary
        assert float(diff.max()) <= step * 1.001, jax.tree_util.keystr(path)
        flips += int((diff > 1e-3 * step).sum())
        total += a.size
    assert flips <= 1e-3 * total


def test_int8_rounds_half_to_even_as_jnp_round():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 0.25])   # s = 1
    got = compress_int8(g)
    want = np.asarray(jnp.round(jnp.asarray(g.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [127.0, 0.0, 2.0, 2.0, -0.0, -4.0, 0.0]


def test_jit_train_step_losses_match_jax():
    jcfg, cfg, np_params, _ = _setup("qwen2.5-3b")
    rng = np.random.default_rng(11)
    batches = [_batch(jcfg, rng, b=4) for _ in range(5)]
    jopt, opt = JaxAdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax_jit_train_step(jax_make_train_step(JaxModel(jcfg), jopt,
                                                   remat="blocks"))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = (jp, jopt.init(jp))
    step = jit_train_step(make_train_step(Model(cfg, device="cpu"), opt,
                                          remat="blocks"))
    params = trainable(from_jax_params(np_params, cfg, "cpu"))
    state = (params, opt.init(params))
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _torch_batch(b))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state[1].step) == int(jstate[1].step) == 5


def test_optimizer_state_bridges_both_ways():
    jcfg, cfg, np_params, _ = _setup("olmo-1b")
    jopt = JaxAdamW()
    jstate = jax.tree_util.tree_map(np.asarray, jopt.init(jax.tree_util.tree_map(
        jnp.asarray, np_params)))
    state = from_jax_opt_state(jstate, cfg, "cpu")
    assert int(state.step) == 0
    back = to_reference_layout(state.mu, cfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jstate.mu))
    assert to_reference_layout(from_jax_params(np_params, cfg, "cpu"), cfg)[
        "blocks"]["attn"]["wq"].shape == np_params["blocks"]["attn"]["wq"].shape


def test_arith_mode_loss_falls():
    """The reference's test_learnable_mode_decreases_loss on the port."""
    cfg = get_config("internlm2-1.8b").reduced()
    model = Model(cfg, device="cpu")
    opt = AdamW(lr=3e-3)
    step = jit_train_step(make_train_step(model, opt, remat="none"))
    params = trainable(model.init(torch.Generator().manual_seed(0)))
    state = (params, opt.init(params))
    loader = DataLoader(cfg, batch=8, seq_len=32, seed=0, mode="arith")
    losses = []
    for _ in range(30):
        state, m = step(state, next(loader))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
