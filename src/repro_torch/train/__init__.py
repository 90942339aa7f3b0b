"""repro_torch.train (counterpart of ``repro.train``).

Only the sparse embedding gradient is ported so far; ``OptConfig``,
``adamw_update``, ``init_opt_state``, ``TrainConfig``,
``init_train_state`` and ``make_train_step`` come with the training
slice (ROADMAP queue A, item 15).
"""
from .sparse_grads import sparse_grad_embed

__all__ = ["sparse_grad_embed"]
