"""Optimizers of the LM train step, the JAX package's ``repro.optim``."""

from repro_torch.optim.optimizers import (Optimizer, adafactor, adam, adamw,
                                          apply_updates, sgd, update_placed)

__all__ = ["Optimizer", "adafactor", "adam", "adamw", "apply_updates", "sgd",
           "update_placed"]
