"""repro_torch.train (counterpart of ``repro.train``): AdamW with a
float32 master copy (``optimizer.py``), the train step with microbatches,
bf16 gradient compression and error feedback (``train_step.py``), and the
embedding gradient assembled fsparse-style (``sparse_grads.py``)."""
from .optimizer import OptConfig, adamw_update, init_opt_state
from .sparse_grads import sparse_grad_embed
from .train_step import TrainConfig, init_train_state, make_train_step

__all__ = ["OptConfig", "TrainConfig", "adamw_update", "init_opt_state",
           "init_train_state", "make_train_step", "sparse_grad_embed"]
