"""Training: AdamW, the train step (remat, microbatches, int8 gradient
compression, one captured CUDA graph on the card), the deterministic
data pipeline, atomic checkpoints and the fault-tolerant loop.  Port of
``repro.training``."""
from repro_torch.training.checkpoint import latest_step, restore, save  # noqa: F401
from repro_torch.training.data import DataCursor, DataLoader, synthetic_batch  # noqa: F401
from repro_torch.training.fault_tolerance import Preemption, run_training  # noqa: F401
from repro_torch.training.optimizer import AdamW, cosine_schedule, global_norm  # noqa: F401
from repro_torch.training.train_loop import (jit_train_step, make_loss_fn,  # noqa: F401
                                             make_train_step, trainable)
