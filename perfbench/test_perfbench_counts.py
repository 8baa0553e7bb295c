"""The yardstick's worked counts (CPU only)."""
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

import pb_counts  # noqa: E402


def shape(name):
    return pb_counts.Shape.of(json.loads((HERE / "configs" / f"{name}.json").read_text()))


QWEN, MISTRAL = shape("qwen2.5-7b"), shape("mistral-7b-v0.3")


def test_qwen_decode_step():
    assert QWEN.layers * QWEN.layer_params == 6_525_618_176     # 6.5256e9
    assert QWEN.head_params == 544_997_376
    assert QWEN.weight_bytes / 1e9 == pytest.approx(14.14, abs=0.005)
    assert QWEN.kv_bytes_per_token == 57_344
    flops, nbytes = pb_counts.decode_step(QWEN, [2080])
    assert nbytes / 1e9 == pytest.approx(14.26, abs=0.005)
    assert pb_counts.least_time(flops, nbytes) * 1e3 == pytest.approx(4.26, abs=0.005)
    assert flops / pb_counts.PEAK_FLOPS < nbytes / pb_counts.PEAK_BYTES


def test_mistral_decode_step():
    assert MISTRAL.weight_bytes / 1e9 == pytest.approx(14.23, abs=0.005)
    assert MISTRAL.kv_bytes_per_token == 131_072
    flops, nbytes = pb_counts.decode_step(MISTRAL, [8320])
    assert nbytes / 1e9 == pytest.approx(15.32, abs=0.005)
    assert pb_counts.least_time(flops, nbytes) * 1e3 == pytest.approx(4.57, abs=0.005)


def test_embedding_is_one_row_a_lane():
    """The floor model of the port charges the whole table to every step;
    a step reads one row: 1.09 GB less for qwen2.5-7b, 0.27 GB for mistral."""
    for s, table_gb in ((QWEN, 1.09), (MISTRAL, 0.27)):
        one = pb_counts.decode_step(s, [100])
        two = pb_counts.decode_step(s, [100, 100])
        assert two[1] - one[1] == pytest.approx(s.d * 2 + 101 * s.kv_bytes_per_token)
        assert s.head_params * s.elem_bytes / 1e9 == pytest.approx(table_gb, abs=0.005)


def test_prefill_flops():
    for s, n, want, ms in ((QWEN, 2048, 2.757e13, 27.9), (MISTRAL, 8192, 1.320e14, 133.4)):
        flops, nbytes = pb_counts.prefill(s, 0, n)
        assert flops == pytest.approx(want, rel=5e-4)
        assert flops / pb_counts.PEAK_FLOPS * 1e3 == pytest.approx(ms, abs=0.05)
        assert flops / pb_counts.PEAK_FLOPS > nbytes / pb_counts.PEAK_BYTES


def test_chunks_add_up_to_the_whole_prefill():
    whole = pb_counts.prefill(QWEN, 0, 2048)[0]
    parts = sum(pb_counts.prefill(QWEN, s, 512)[0] for s in range(0, 2048, 512))
    assert parts - 3 * 2 * QWEN.head_params == pytest.approx(whole, rel=1e-12)


def test_kernel_bytes():
    live = 2080
    assert pb_counts.decode_attention_bytes(QWEN, live) == 2 * live * 512 * 2 + 2 * 3584 * 2
    # a lane of 17 tokens on 16-token pages reads two pages
    assert pb_counts.paged_attention_bytes(QWEN, [17], 16) == \
        2 * 32 * 512 * 2 + 2 * 3584 * 2
    assert pb_counts.paged_attention_bytes(QWEN, [], 16) == 0
