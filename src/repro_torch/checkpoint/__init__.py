"""Checkpoints and crash-resume snapshots (the JAX package's
``repro.checkpoint``, for torch pytrees): a flattened-pytree ``.npz``
tensor file plus a msgpack or JSON ``.meta`` sidecar, both written
atomically."""

from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.run_state import (RunState, load_run_state,
                                              save_run_state)
