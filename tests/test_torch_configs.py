"""The port's copies of the framework-neutral modules (configs, floor
model, hardware table) agree with the JAX package's exactly."""
import dataclasses

import pytest

from repro import configs as jax_configs
from repro.core import floor as jax_floor
from repro.core import hardware as jax_hw
from repro_torch import configs
from repro_torch.core import floor, hardware


def test_registries_equal_field_by_field():
    names = jax_configs.list_configs()
    assert configs.list_configs() == names
    assert configs.list_configs(assigned_only=True) == \
        jax_configs.list_configs(assigned_only=True)
    for name in names:
        a = dataclasses.asdict(configs.get_config(name))
        b = dataclasses.asdict(jax_configs.get_config(name))
        assert a == b, name
        assert dataclasses.asdict(configs.get_config(name).reduced()) == \
            dataclasses.asdict(jax_configs.get_config(name).reduced())


def test_chip_tables_equal():
    assert {k: dataclasses.asdict(v) for k, v in hardware.CHIPS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_hw.CHIPS.items()}


@pytest.mark.parametrize("name", jax_configs.list_configs())
def test_floor_cell_equal(name):
    for ctx, wb in [(2048, 2), (2048, 0.5), (32768, 1)]:
        a = floor.floor_cell(configs.get_config(name), hardware.GPU_H100, ctx,
                             weight_dtype_bytes=wb)
        b = jax_floor.floor_cell(jax_configs.get_config(name), jax_hw.GPU_H100,
                                 ctx, weight_dtype_bytes=wb)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_headline_floors():
    """The slice's two reference floors (arithmetic, not measurements)."""
    cfg = configs.get_config("qwen2.5-7b")
    bf16 = floor.floor_cell(cfg, hardware.GPU_H100, 2048)
    int4 = floor.floor_cell(cfg, hardware.GPU_H100, 2048, weight_dtype_bytes=0.5)
    assert round(bf16.t_floor_ms, 2) == 4.58 and round(int4.t_floor_ms, 2) == 1.17
