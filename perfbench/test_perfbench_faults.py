"""``correct`` comes out false when the timed path is broken underneath
(each fault a served cell can have: a decode step that returns its state
unchanged, half of the batch computed for the other half, a token
altered where it is produced), and when the float8 control stands in
for the port (CPU only: the harness's look for a card is skipped, the
rest of a run is driven as on the card)."""
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import torch  # noqa: E402

import pb_check  # noqa: E402
import pb_manifest  # noqa: E402
import pb_model  # noqa: E402
import pb_tiny  # noqa: E402
from pb_drive import Req  # noqa: E402
from pb_traffic import Traffic  # noqa: E402
from pb_tiny import B1, SERVE  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


def _state_unchanged(step):
    def faulty(self, params, cache, tokens, active=None):
        saved = {k: v.clone() for k, v in cache.items() if torch.is_tensor(v)}
        out = step(self, params, cache, tokens, active)
        for k, v in saved.items():
            cache[k].copy_(v)
        return out
    return faulty


def _half_batch(step):
    def faulty(self, params, cache, tokens, active=None):
        logits, cache = step(self, params, cache, tokens, active)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:2 * half] = logits[:half]
        return logits, cache
    return faulty


def _token_altered(step):
    def faulty(self, params, cache, tokens, active=None):
        logits, cache = step(self, params, cache, tokens, active)
        return -logits, cache          # the least likely token comes first
    return faulty


@pytest.mark.parametrize("name,fault", [
    (B1, _state_unchanged), (B1, _token_altered),
    (SERVE, _state_unchanged), (SERVE, _half_batch), (SERVE, _token_altered)],
    ids=["b1-state-unchanged", "b1-token-altered", "serve-state-unchanged",
         "serve-half-batch", "serve-token-altered"])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(Model, "decode_step", fault(Model.decode_step))
    out, numbers = pb_tiny.run(pb_tiny.cell(name))
    assert out["correct"] is False
    assert numbers["gap"]["value"] > numbers["gap"]["limit"]


def test_the_float8_control_is_not_correct():
    """The control (the reference in float8 e4m3, the next precision below
    the configurations' bfloat16) at a size a CPU test holds: 32 layers of
    width 256, read as on the card at each position of four requests of
    128 + 64 tokens.  Its widest gap passes every cell's limit."""
    size = dict(num_hidden_layers=32, hidden_size=256, intermediate_size=512,
                num_attention_heads=8, num_key_value_heads=2, head_dim=32,
                vocab_size=4096)
    c = pb_tiny.cell(B1, **size)
    spec = dict(c.traffic, prompt_len={"fixed": 128}, new_tokens={"fixed": 64},
                max_len=192)
    seed = 2 ** 31 + 5
    weights = pb_model.make_weights(c.config, seed, torch.device("cpu"))
    served = np.random.default_rng(seed).integers(0, 4096, (4, 64))
    reqs = [Req(i, 128, 64, 0.0, tokens=row.tolist()) for i, row in enumerate(served)]
    limits = [pb_manifest.load_cell(pb_manifest.load(), w["name"]).limits["gap"]["limit"]
              for w in pb_manifest.load()["workloads"]]
    with pb_tiny.one_thread():
        control = max(pb_check.gaps(c.config, weights, Traffic(spec, seed, 4096),
                                    reqs, control=True))
    assert control > max(limits)
