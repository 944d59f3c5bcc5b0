"""Full-run crash-resume snapshots over the atomic checkpoint writer.

A :class:`RunState` is everything a driver needs to continue a run from a
round boundary with BIT-IDENTICAL results (tests/test_torch_resume.py): the
array state (global + stacked client params, losses, dropout rates, the
protocol PRNG key, observed-telemetry EWMAs) rides the flattened-npz
tensor file of :mod:`repro_torch.checkpoint.io`, while the round index, the
completed :class:`~repro_torch.core.protocol.RoundRecord` history, and the sim
extras (clock, event trace) ride the msgpack/json ``.meta`` sidecar —
reusing the obs run-log serialization (:mod:`repro_torch.obs.runlog`), whose
round events round-trip records exactly (float64 repr / native doubles).

Nothing else needs persisting: fault draws are keyed
``(seed, tag, epoch, client)`` and network/outage chains are keyed per
epoch, so they replay for free on resume.

Both writes are atomic (temp + fsync + ``os.replace``), so a SIGKILL at
any instant leaves either the previous snapshot or the new one — never a
torn file.  The tensor file is written before the sidecar; loaders
require the sidecar's round marker, so a kill between the two writes
reads as the OLDER complete snapshot pair at worst one round behind.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List

from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint
from repro_torch.obs import runlog

_FORMAT = 1


@dataclasses.dataclass
class RunState:
    """One resumable snapshot at a round boundary.

    round: the last COMPLETED round index (resume continues at round+1).
    arrays: pytree (typically a dict) of array state — global params,
      stacked client params, losses, dropout, PRNG key, telemetry EWMAs.
    history: the RoundRecords of rounds 1..round.
    extra: JSON-able driver extras (sim clock, event trace, seeds...).
    """

    round: int
    arrays: Any
    history: List
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def save_run_state(path: str | Path, state: RunState) -> None:
    """Atomically persist ``state`` (tensors + sidecar)."""
    meta = {
        "_run_state": _FORMAT,
        "round": int(state.round),
        "history": [runlog.round_event(r) for r in state.history],
        "extra": runlog.jsonable(state.extra),
    }
    save_checkpoint(path, state.arrays, metadata=meta)


def load_run_state(path: str | Path, like_arrays: Any) -> RunState:
    """Restore a snapshot written by :func:`save_run_state`.

    ``like_arrays`` is the shape/dtype template for the array state —
    the caller's freshly-initialised state, which resume then overwrites.
    """
    arrays, meta = load_checkpoint(path, like_arrays)
    if meta.get("_run_state") != _FORMAT:
        raise ValueError(
            f"{path} is not a RunState snapshot (missing/unknown "
            f"_run_state marker {meta.get('_run_state')!r}) — plain "
            "parameter checkpoints cannot seed a resume")
    history = [runlog.record_from_event(ev) for ev in meta["history"]]
    return RunState(round=int(meta["round"]), arrays=arrays,
                    history=history, extra=dict(meta.get("extra") or {}))
