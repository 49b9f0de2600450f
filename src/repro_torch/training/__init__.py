"""The LM training layer of the port: optimizers as pure functions over
parameter trees, and the flat and hierarchical-FL train steps.
Counterpart of ``repro/training``."""
from repro_torch.training.optimizer import SGD, AdamW, AdamWState, SGDState
from repro_torch.training.train_step import (hfl_global_round,
                                             init_hfl_opt_state,
                                             make_eval_step,
                                             make_hfl_train_step,
                                             make_train_step)

__all__ = ["SGD", "AdamW", "AdamWState", "SGDState", "hfl_global_round",
           "init_hfl_opt_state", "make_eval_step", "make_hfl_train_step",
           "make_train_step"]
