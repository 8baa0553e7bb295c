"""The port's sharding plan, placements, mesh helpers and activation
hints, in process (no ranks), against the JAX package's.

Plan parity: every config of the port at full size, on the production
meshes' stand-ins (16, 16) and (2, 16, 16), with ``ShardingPlan.named``
patched to return the spec on both sides: the port's spec of each leaf
equals the reference's (a block leaf without the reference's leading L
entry), and the ``decisions`` are equal.  The port's trees are built
under ``FakeTensorMode`` (shapes only), the reference's with
``jax.eval_shape``.  Also the cases of ``tests/test_hints_strategy.py``
(``TestHints``, ``TestStrategies``) and of
``tests/test_sharding_multidevice.py``'s ``TestPlanRules``."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.launch import sharding as ref_shd
from repro.models import Model as RefModel
from repro.quant import quantize_tree as ref_quantize_tree
from repro.quant.quantize import QuantizedTensor as RefQuantized
from repro.training import AdamW as RefAdamW
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import hints
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as shd
from repro_torch.models.model import ATTENTION_FAMILIES, Model
from repro_torch.quant import quantize_tree
from repro_torch.quant.quantize import QuantizedTensor
from repro_torch.training import AdamW

CONFIGS = list_configs()
FAKE = FakeTensorMode()   # one mode: trees made under it meet again
_NAMED = shd.ShardingPlan.named   # before the fixture patches it


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakeMesh3:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": FakeMesh, "2x16x16": FakeMesh3}
STRATEGIES = [("tp", False), ("tp", True), ("dp", False)]


@pytest.fixture(autouse=True)
def _named_is_spec(monkeypatch):
    monkeypatch.setattr(ref_shd.ShardingPlan, "named", lambda self, spec: tuple(spec))
    monkeypatch.setattr(shd.ShardingPlan, "named", lambda self, spec: tuple(spec))


# ------------------------------------------------------------------ trees
@functools.lru_cache(maxsize=None)
def ref_params(name, quant=None):
    m = RefModel(ref_get_config(name))
    p = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    if quant:
        p = jax.eval_shape(lambda t: ref_quantize_tree(t, quant), p)
    return p


@functools.lru_cache(maxsize=None)
def port_params(name, quant=None):
    with FAKE:
        p = Model(get_config(name), device="cpu").init(torch.Generator())
        if quant:
            p = quantize_tree(p, quant)
    return p


@functools.lru_cache(maxsize=None)
def ref_opt_state(name):
    return jax.eval_shape(RefAdamW().init, ref_params(name))


@functools.lru_cache(maxsize=None)
def port_opt_state(name):
    with FAKE:
        return AdamW().init(port_params(name))


def ref_spec_dict(tree, prefix=()):
    """{path: spec} of the reference's spec tree (QuantizedTensor leaves
    give path + ("data",) and path + ("scales",)); None is no leaf."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(ref_spec_dict(v, prefix + (str(k),)))
        return out
    if isinstance(tree, RefQuantized):
        return {prefix + ("data",): tuple(tree.data),
                prefix + ("scales",): tuple(tree.scales)}
    return {prefix: tuple(tree)}


def at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def port_leaves(tree):
    """(path, leaf) of a params tree, QuantizedTensor leaves whole."""
    out = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        else:
            out.append((prefix, node))
    walk(tree, ())
    return out


def assert_params_match(port_tree, port_specs, ref_specs):
    """Each port leaf's spec equals the reference's at its path, less
    the leading L entry of a block leaf; every reference leaf is met."""
    ref = ref_spec_dict(ref_specs)
    seen = set()
    for path, leaf in port_leaves(port_tree):
        block = path[0] == "blocks"
        rpath = path[:1] + path[2:] if block else path
        spec = at(port_specs, path)
        parts = ([("data", spec.data), ("scales", spec.scales)]
                 if isinstance(leaf, QuantizedTensor) else [(None, spec)])
        for sub, got in parts:
            key = rpath + ((sub,) if sub else ())
            want = ref[key][1:] if block else ref[key]
            assert tuple(got) == want, (path, sub, got, want)
            seen.add(key)
    assert seen == set(ref), set(ref) ^ seen


def plans(cfg_name, mesh, strategy, fsdp):
    return (ref_shd.ShardingPlan(mesh(), ref_get_config(cfg_name), fsdp, {}, strategy),
            shd.ShardingPlan(mesh(), get_config(cfg_name), fsdp, {}, strategy))


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_params_plan_parity(name, mesh):
    """Every param leaf under tp (fsdp off and on) and dp: the same
    spec, the same decisions."""
    for strategy, fsdp in STRATEGIES:
        ref_plan, plan = plans(name, MESHES[mesh], strategy, fsdp)
        ref = ref_shd.params_shardings(ref_plan, ref_params(name))
        got = shd.params_shardings(plan, port_params(name))
        assert_params_match(port_params(name), got, ref)
        assert plan.decisions == ref_plan.decisions, (strategy, fsdp)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_opt_state_plan_parity(name, mesh):
    """The AdamW moments with zero1 off and on, under tp and dp; the
    step counter replicated."""
    for strategy, fsdp in STRATEGIES:
        for zero1 in (False, True):
            ref_plan, plan = plans(name, MESHES[mesh], strategy, fsdp)
            ref = ref_shd.opt_state_shardings(ref_plan, ref_opt_state(name), zero1=zero1)
            got = shd.opt_state_shardings(plan, port_opt_state(name), zero1=zero1)
            assert tuple(got.step) == tuple(ref.step) == ()
            assert_params_match(port_params(name), got.mu, ref.mu)
            assert_params_match(port_params(name), got.nu, ref.nu)
            assert plan.decisions == ref_plan.decisions, (strategy, fsdp, zero1)


@pytest.mark.parametrize("name", CONFIGS)
def test_int4_tree_plan_parity(name):
    """An int4_fused tree: data and scales each guarded on their own
    shapes, as the reference does."""
    for mesh in MESHES.values():
        for strategy, fsdp in STRATEGIES[:2]:
            ref_plan, plan = plans(name, mesh, strategy, fsdp)
            ref = ref_shd.params_shardings(ref_plan, ref_params(name, "int4_fused"))
            got = shd.params_shardings(plan, port_params(name, "int4_fused"))
            assert_params_match(port_params(name, "int4_fused"), got, ref)
            assert plan.decisions == ref_plan.decisions


def _caches(name, B, kv):
    cfg = get_config(name)
    S = 32768
    with FAKE:
        port = Model(cfg, device="cpu").init_cache(
            B, S, kv_dtype=torch.int8 if kv == "int8" else None)
    m = RefModel(ref_get_config(name))
    ref = jax.eval_shape(lambda: m.init_cache(B, S, kv_dtype=jnp.int8 if kv == "int8"
                                              else None))
    return port, ref


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_cache_and_batch_plan_parity(name, mesh):
    """cache_shardings at B=1 and B=128, bf16 and int8 KV (attention
    families), and batch_shardings of a train batch under each
    strategy."""
    cfg = get_config(name)
    kvs = ("bf16", "int8") if cfg.family in ATTENTION_FAMILIES else ("bf16",)
    for B in (1, 128):
        for kv in kvs:
            port, ref = _caches(name, B, kv)
            assert set(port) == set(ref)
            ref_plan, plan = plans(name, MESHES[mesh], "tp", False)
            want = ref_shd.cache_shardings(ref_plan, ref)
            got = shd.cache_shardings(plan, port)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (B, kv)
            assert plan.decisions == ref_plan.decisions
    batch = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
             "labels": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
             "odd": jax.ShapeDtypeStruct((3, 5), jnp.int32)}
    for strategy, fsdp in STRATEGIES:
        ref_plan, plan = plans(name, MESHES[mesh], strategy, fsdp)
        want = ref_shd.batch_shardings(ref_plan, batch)
        got = shd.batch_shardings(plan, batch)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        assert plan.decisions == ref_plan.decisions
        assert plan.batch_axes == ref_plan.batch_axes


# ------------------------------------------------------------------ placements
def _placements(spec, names):
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = names
    return shd.placements(spec, M()), Replicate, Shard


@pytest.mark.parametrize("names,spec,want", [
    (("data",), (None, "data"), ("S1",)),
    (("data",), (), ("R",)),
    (("data", "model"), ("data", None, "model"), ("S0", "S2")),
    (("data", "model"), (None, "model"), ("R", "S1")),
    (("data", "model"), (None, None, ("data", "model"), None, None), ("S2", "S2")),
    (("pod", "data", "model"), (("pod", "data"), "model"), ("S0", "S0", "S1")),
    (("pod", "data", "model"), (None, None, ("pod", "data", "model")), ("S2", "S2", "S2")),
    (("pod", "data", "model"), ("model", None, "pod"), ("S2", "R", "S0")),
])
def test_placements(names, spec, want):
    got, Replicate, Shard = _placements(spec, names)
    expect = tuple(Replicate() if w == "R" else Shard(int(w[1])) for w in want)
    assert got == expect


@pytest.mark.parametrize("names,spec", [
    (("data", "model"), (("model", "data"), None)),
    (("pod", "data", "model"), (None, ("data", "pod"))),
    (("pod", "data", "model"), (("model", "pod"),)),
    (("data", "model"), ("pod",)),
    (("data", "model"), ("data", "data")),
])
def test_placements_refuses(names, spec):
    """Axes out of mesh order raise (never reordered), as do an axis the
    mesh lacks and one named twice."""
    with pytest.raises(ValueError):
        _placements(spec, names)


def test_layout_of_named():
    """Unpatched, ``named`` gives a Layout: the mesh, the placements, the
    spec."""
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("data", "model")
    plan = shd.make_plan(get_config("olmo-1b"), M())
    layout = _NAMED(plan, (None, "model"))
    assert layout.placements == (Replicate(), Shard(1))
    assert layout.spec == (None, "model") and layout.mesh is plan.mesh


# ------------------------------------------------------------------ mesh helpers
@pytest.mark.parametrize("mesh,dp,dps,tp", [
    (FakeMesh, ("data",), 16, 16),
    (FakeMesh3, ("pod", "data"), 32, 16),
])
def test_mesh_helpers(mesh, dp, dps, tp):
    from repro.launch import mesh as ref_mesh
    assert tmesh.dp_axes(mesh()) == ref_mesh.dp_axes(mesh()) == dp
    assert tmesh.dp_size(mesh()) == ref_mesh.dp_size(mesh()) == dps
    assert tmesh.tp_size(mesh()) == ref_mesh.tp_size(mesh()) == tp


# ------------------------------------------------------------------ hints
def test_hints_noop_without_mesh():
    x = torch.ones((4, 8))
    assert hints.constrain(x, ("dp", "tp")) is x
    assert hints.constrain_first_fit(x, [("dp", "tp")]) is x


def test_hints_tp_divides_requires_mesh():
    assert not hints.tp_divides(16)


def test_hints_dp_all_disables_tp():
    hints.enable(FakeMesh(), dp_all=True)
    try:
        assert not hints.tp_divides(16)
        assert hints._resolve("tp", FakeMesh()) is None
        assert hints._resolve("dp", FakeMesh()) == ("data", "model")
    finally:
        hints.disable()


def test_hints_context_manager_restores():
    with hints.activation_hints(None):
        pass
    assert hints._STATE["mesh"] is None


@pytest.mark.parametrize("mesh", [FakeMesh, FakeMesh3])
@pytest.mark.parametrize("dp_all", [False, True])
def test_hints_resolve_and_guard_match_reference(mesh, dp_all):
    """``_resolve``, ``tp_divides`` and the guarded spec ``constrain``
    applies, against the reference's ``with_sharding_constraint`` spec."""
    from repro.launch import hints as ref_hints
    hints.enable(mesh(), dp_all)
    ref_hints.enable(mesh(), dp_all)
    try:
        for ax in ("dp", "tp", None, "model"):
            assert hints._resolve(ax, mesh()) == ref_hints._resolve(ax, mesh())
        for n in (1, 8, 16, 48, 60):
            assert hints.tp_divides(n) == ref_hints.tp_divides(n)
        for shape, axes in [((8, 2048, 16, 128), ("dp", None, "tp")),
                            ((3, 7, 5), ("dp", None, "tp")),
                            ((64, 11008), ("dp", "tp")),
                            ((60, 40, 1408), (None, "dp", "tp"))]:
            want = []
            for i, dim in enumerate(shape):
                ax = axes[i] if i < len(axes) else None
                if ax is not None:
                    ax = ref_hints._resolve(ax, mesh())
                    if ax is not None and dim % ref_hints._size_of(ax, mesh()) != 0:
                        ax = None
                want.append(ax)
            assert hints.resolved_spec(shape, axes, mesh()) == tuple(want)
    finally:
        hints.disable()
        ref_hints.disable()


# ------------------------------------------------------------------ strategies
class _Leaf:
    def __init__(self, shape):
        self.shape = shape


def test_dp_strategy_replicates_params():
    plan = shd.ShardingPlan(FakeMesh(), get_config("olmo-1b"), False, {}, strategy="dp")
    assert shd.param_spec(plan, ("blocks", "0", "mlp", "up"),
                          _Leaf((2048, 8192))) == (None, None)


def test_dp_strategy_batch_over_all_axes():
    plan = shd.ShardingPlan(FakeMesh(), get_config("olmo-1b"), False, {}, strategy="dp")
    assert plan.batch_axes == ("data", "model")


def test_tp_strategy_default():
    plan = shd.make_plan(get_config("olmo-1b"), FakeMesh())
    assert plan.strategy == "tp"
    assert plan.batch_axes == ("data",)


def test_kv_scale_sharding_rule():
    plan = shd.ShardingPlan(FakeMesh(), get_config("qwen2.5-3b"), False, {})
    specs = shd.cache_shardings(plan, {"k_scale": _Leaf((36, 128, 32768, 2))})
    # batch over data, seq over model; heads (2) replicated
    assert specs["k_scale"] == (None, "data", "model", None)


# ------------------------------------------------------------------ plan rules
def test_divisibility_fallback_recorded():
    """mamba2 vocab 50280 % 16 != 0 -> embed shards d_model instead."""
    plan = shd.ShardingPlan(FakeMesh(), get_config("mamba2-2.7b"), False, {})
    assert shd.param_spec(plan, ("embed",), _Leaf((50280, 2560))) == (None, "model")


@pytest.mark.parametrize("arch,shape,want", [
    ("qwen2-moe-a2.7b", (60, 2048, 1408), (None, None, "model")),   # TP in experts
    ("llama4-scout-17b-a16e", (16, 5120, 8192), ("model", None, None)),  # EP
])
def test_moe_ep_vs_tp(arch, shape, want):
    """The reference's stacked (L, E, D, F) leaf without its L entry."""
    plan = shd.ShardingPlan(FakeMesh(), get_config(arch), False, {})
    assert shd.param_spec(plan, ("blocks", "3", "moe", "w_up"), _Leaf(shape)) == want
