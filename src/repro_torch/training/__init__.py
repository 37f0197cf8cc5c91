"""Training substrate: optimizer, steps, loop, checkpointing."""

from .optim import AdamW, AdamWState, cosine_schedule
from .steps import loss_and_grads, make_eval_step, make_train_step

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "loss_and_grads",
           "make_train_step", "make_eval_step"]
