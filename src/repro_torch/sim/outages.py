"""Correlated cell-outage processes — the cluster-failure axis.

The fault models (sim/faults.py) draw *independent* per-client failures; real fleets
fail in correlated bursts (a cell tower drops, a building loses power, an
ISP route flaps) and FedDD's rare-client regimes are exactly what such
bursts create.  This module groups clients into **cells** and drives each
cell with a two-state (up/down) Markov outage chain — the same
Gilbert–Elliott machinery as :class:`~repro_torch.sim.network.MarkovFadingNetwork`,
lifted from per-client link quality to per-cell availability:

    P(up   -> down) = p_out
    P(down -> up)   = p_back

While a cell is down every member client behaves as crashed: its upload
never completes, its telemetry EWMA stalls (the server never sees a
measurement), and the runner's survivor-only LP re-solve excludes the
whole cell at once.  An outage therefore composes with ANY inner
:class:`~repro_torch.sim.faults.FaultModel` — independent churn/loss/corruption
draws continue underneath, and the outage overlay forces entire cells
into the crashed channel on top.

Determinism contract (tests/test_torch_faults.py): the chain draw of epoch
``e`` comes from ``np.random.default_rng((seed, _TAG_OUTAGE, e))`` and
each outaged member's crash fraction from
``np.random.default_rng((seed, _TAG_OUTAGE, e, client))`` — pure
functions of (seed, epoch[, client]) like every other fault draw, so
outage scenarios replay identically across call orders, processes and
crash-resume (checkpoint/run_state.py never has to persist the chain).
All cells are up at epoch 0.  ``cells=0`` or ``p_out=0`` is the inert
config: ``round_faults`` returns the inner model's draw bit-identically.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.sim.faults import FaultConfig, FaultModel, RoundFaults

# SeedSequence domain tag: outage draws can never collide with the
# per-client fault (0xFA) or corruption-noise (0xC0) streams.
_TAG_OUTAGE = 0x0D


@dataclasses.dataclass(frozen=True)
class OutageConfig:
    """Cell-outage process knobs.

    cells: number of cells clients are grouped into (round-robin
      ``client % cells`` unless an explicit assignment is given);
      ``0`` disables the overlay entirely (inert config).
    p_out: per-epoch probability an up cell goes down.
    p_back: per-epoch probability a down cell recovers.
    seed: outage-stream seed, independent of the inner fault seed so the
      same outage scenario can be replayed over different fault draws.
    """

    cells: int = 0
    p_out: float = 0.0
    p_back: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.cells < 0:
            raise ValueError(f"cells must be >= 0, got {self.cells}")
        for name in ("p_out", "p_back"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0,1], got {v}")


class CellOutageModel(FaultModel):
    """Correlated-failure overlay: cell-level Markov outages on top of an
    optional inner per-client fault model.

    ``round_faults`` first takes the inner model's draw (or a clean draw
    when ``inner is None``), then marks every member of a down cell as
    crashed with a per-client keyed crash fraction.  Cell up->down /
    down->up transitions are reported as ``outage_begin`` /
    ``outage_end`` incidents on the returned :class:`RoundFaults`
    (``.outages``), which :func:`repro_torch.sim.faults.incident_events`
    forwards to the observability layer.
    """

    def __init__(self, num_clients: int,
                 config: Optional[OutageConfig] = None, *,
                 inner: Optional[FaultModel] = None,
                 assignment: Optional[Sequence[int]] = None, **kw):
        self.outage = config or OutageConfig(**kw)
        self.inner = inner
        self.config = inner.config if inner is not None else FaultConfig()
        self.num_clients = int(num_clients)
        c = self.outage.cells
        if assignment is not None:
            asg = np.asarray(assignment, int)
            if asg.shape != (self.num_clients,):
                raise ValueError("assignment must have one cell index per "
                                 f"client, got shape {asg.shape}")
            if c and (asg.min() < 0 or asg.max() >= c):
                raise ValueError(f"assignment indices must be in [0,{c})")
            self.assignment = asg
        else:
            self.assignment = (np.arange(self.num_clients) % c if c
                               else np.zeros(self.num_clients, int))
        # _states[e] is the (cells,) bool "down" vector of epoch e; all
        # cells up at epoch 0 (epoch 0 equals the inner model alone).
        self._states: List[np.ndarray] = [np.zeros(max(c, 1), bool)]

    @property
    def active(self) -> bool:
        """Whether the overlay can ever produce an outage."""
        return self.outage.cells > 0 and self.outage.p_out > 0.0

    @property
    def may_corrupt(self) -> bool:
        return self.inner.may_corrupt if self.inner is not None else False

    def cell_members(self, cell: int) -> np.ndarray:
        return np.flatnonzero(self.assignment == int(cell))

    def _advance_to(self, epoch: int) -> None:
        cfg = self.outage
        while len(self._states) <= epoch:
            e = len(self._states)
            down = self._states[-1]
            u = np.random.default_rng(
                (cfg.seed, _TAG_OUTAGE, e)).uniform(size=len(down))
            self._states.append(
                np.where(down, u >= cfg.p_back, u < cfg.p_out))

    def down_cells(self, epoch: int) -> np.ndarray:
        """(cells,) bool: which cells are down at ``epoch``."""
        self._advance_to(epoch)
        return self._states[epoch].copy()

    def outage_mask(self, epoch: int) -> Optional[np.ndarray]:
        """(N,) bool mask of clients inside a down cell (None when the
        overlay is inert) — the runner excludes these rows from the
        allocation LP re-solve for the duration of the outage."""
        if not self.active:
            return None
        down = self.down_cells(epoch)
        return down[self.assignment]

    def _transitions(self, epoch: int) -> list:
        """The epoch's ``outage_begin`` / ``outage_end`` incidents,
        computed purely from the memoised chain (repeatable)."""
        if not self.active or epoch <= 0:
            # epoch 0 is all-up by construction: no transitions
            if not self.active:
                return []
            self._advance_to(epoch)
            return []
        self._advance_to(epoch)
        prev, cur = self._states[epoch - 1], self._states[epoch]
        out = []
        for c in np.flatnonzero(cur & ~prev):
            out.append({"kind": "outage_begin", "cell": int(c),
                        "members": [int(i) for i in self.cell_members(c)]})
        for c in np.flatnonzero(prev & ~cur):
            # duration: consecutive down epochs ending at epoch-1
            first = epoch - 1
            while first > 0 and self._states[first - 1][c]:
                first -= 1
            out.append({"kind": "outage_end", "cell": int(c),
                        "members": [int(i) for i in self.cell_members(c)],
                        "duration": int(epoch - first)})
        return out

    def round_faults(self, epoch: int, wire_bytes: np.ndarray,
                     uplink_rate: np.ndarray) -> RoundFaults:
        n = len(wire_bytes)
        if self.inner is not None:
            out = self.inner.round_faults(epoch, wire_bytes, uplink_rate)
        else:
            out = RoundFaults.clean(n)
        if not self.active:
            return out
        mask = self.outage_mask(epoch)
        out.outages = self._transitions(epoch)
        if mask is None or not mask.any():
            return out
        cfg = self.outage
        for i in np.flatnonzero(mask[:n]):
            # overlay wins: a client inside a down cell crashes even if
            # the inner draw had it surviving with retries/corruption
            frac = np.random.default_rng(
                (cfg.seed, _TAG_OUTAGE, epoch, int(i))).uniform()
            out.crashed[i] = True
            out.crash_frac[i] = frac
            out.aborted[i] = False
            out.retries[i] = 0
            out.extra_bytes[i] = 0.0
            out.extra_delay[i] = 0.0
            out.sent_bytes[i] = 0.0
            out.corrupt[i] = 0
        return out
