"""Deterministic fault injection for the FL simulator — the failure axis.

The network models (sim/network.py) make clients *slow*; this module makes
them *fail*, the regime FedDD is motivated by (cross-device fleets with
constant churn — Bonawitz et al., 1812.07210).  A fault model composes
with any :class:`~repro_torch.sim.network.NetworkModel`: the network decides how
fast a round trip would be, the fault model decides whether (and in what
shape) it completes.  Three failure channels:

* **crash / churn** — the client dies part-way through its round trip
  (probability per communication epoch).  Events after the crash instant
  are never scheduled, so the upload never arrives and the server's
  telemetry EWMA keeps its last estimate (it never saw a measurement —
  the gap is *skipped*, not zero-filled).
* **lossy uplink** — the upload is chunked; every chunk is retransmitted
  under exponential backoff until it lands or ``max_retries`` is spent.
  Retries are charged REAL codec bytes (repro_torch.comm) on both the event
  timeline and the Eq. (12) clock; an exhausted chunk abandons the whole
  upload (the bytes already sent are wasted — ``abandoned_bytes``).
* **corrupted payloads** — bit-flip / NaN / Inf injection into the upload
  the server decodes.  The client's own state stays clean (corruption is
  on the wire); the server's validation screen
  (:func:`screen_quarantine`) quarantines non-finite or norm-anomalous
  updates with a 0 weight on the stacked Eq. (4) aggregation — the same
  mechanism baselines use for non-participation, so the fused engines
  need no new code path.

Determinism contract (tests/test_torch_faults.py): every draw comes from
``np.random.default_rng((seed, tag, epoch, client))`` — a SeedSequence
key, so the fault sequence is a pure function of (seed, epoch, client),
independent of call order and identical across processes.  The sim's
``(time, seq)`` event ordering is untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree

CORRUPT_KINDS = ("bitflip", "nan", "inf")

# SeedSequence domain tags: fault draws vs corruption noise can never
# collide even for equal (seed, epoch, client).
_TAG_FAULTS = 0xFA
_TAG_CORRUPT = 0xC0


@dataclasses.dataclass(frozen=True)
class ValidationConfig:
    """Server-side payload screening knobs.

    ``norm_factor`` quarantines an arrived update whose l2 norm exceeds
    ``norm_factor`` x the median norm of this round's finite arrivals
    (<= 0 disables the norm screen); the median needs at least
    ``min_reference`` finite arrivals to be meaningful, with a hard
    floor of 3 (see :func:`screen_quarantine` — survivor sets of 1–2
    are finite-checked only).  Non-finite (NaN/Inf) updates are always
    quarantined when ``screen_nonfinite``.
    """

    screen_nonfinite: bool = True
    norm_factor: float = 10.0
    min_reference: int = 3


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Failure-channel rates and server-degradation knobs.

    crash_rate: per-epoch probability a scheduled client dies mid-round.
    loss_rate: per-chunk uplink packet-loss probability.
    chunk_bytes: uplink chunking granularity (bytes).
    backoff_base: first retransmit backoff (seconds); doubles per retry.
    max_retries: retransmit budget per chunk; exhaustion abandons the
      whole upload.
    corrupt_rate: probability an arriving upload is corrupted on the wire.
    corrupt_kind: ``bitflip`` | ``nan`` | ``inf`` | ``mix`` (uniform draw).
    quorum: minimum VALID contributions per round — a float in (0,1) is a
      fraction of the scheduled participants, an int an absolute count
      (floored at 1: a fault-aware server never aggregates an empty
      round).  Below the floor the round is skipped: global held, client
      params held, allocation LP re-solved on survivor-only telemetry.
    staleness_budget: buffered-async analogue of quorum (0 = unlimited):
      at merge time, buffered updates staler than this many versions are
      dropped and charged as abandoned bytes; the merge proceeds only
      when the surviving buffered mass still meets the quorum floor,
      otherwise the server keeps buffering.
    seed: fault-stream seed (independent of the run seed on purpose, so a
      fault scenario can be replayed over different training seeds).
    validation: :class:`ValidationConfig` for the quarantine screen.
    """

    crash_rate: float = 0.0
    loss_rate: float = 0.0
    chunk_bytes: float = 4096.0
    backoff_base: float = 0.05
    max_retries: int = 5
    corrupt_rate: float = 0.0
    corrupt_kind: str = "mix"
    quorum: float = 1
    staleness_budget: int = 0
    seed: int = 0
    validation: ValidationConfig = dataclasses.field(
        default_factory=ValidationConfig)

    def __post_init__(self):
        for name in ("crash_rate", "loss_rate", "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0,1], got {v}")
        if self.corrupt_kind not in CORRUPT_KINDS + ("mix",):
            raise ValueError(f"corrupt_kind must be one of "
                             f"{CORRUPT_KINDS + ('mix',)}, "
                             f"got {self.corrupt_kind!r}")
        if self.chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.quorum < 0:
            raise ValueError("quorum must be >= 0")
        if self.staleness_budget < 0:
            raise ValueError("staleness_budget must be >= 0 "
                             "(0 = unlimited)")


@dataclasses.dataclass
class RoundFaults:
    """The fault draw of one communication epoch; arrays shaped (N,).

    ``crashed`` clients die at ``dispatch + crash_frac * round_trip``;
    ``aborted`` clients exhausted a chunk's retransmit budget (their
    upload never arrives; ``sent_bytes`` already crossed the wire);
    surviving lossy clients arrive ``extra_delay`` seconds late having
    moved ``extra_bytes`` duplicate bytes in ``retries`` retransmits.
    ``corrupt`` holds 0 (clean) or 1 + index into :data:`CORRUPT_KINDS`.
    ``outages`` carries the epoch's cell-level ``outage_begin`` /
    ``outage_end`` incident dicts (repro_torch.sim.outages), forwarded to the
    observability layer by :func:`incident_events`.
    """

    crashed: np.ndarray        # bool
    crash_frac: np.ndarray     # float in [0,1)
    aborted: np.ndarray        # bool
    retries: np.ndarray        # int
    extra_bytes: np.ndarray    # float, retransmitted duplicate bytes
    extra_delay: np.ndarray    # float, seconds added to the upload leg
    sent_bytes: np.ndarray     # float, bytes wasted by aborted uploads
    corrupt: np.ndarray        # int, 0 = clean
    outages: list = dataclasses.field(default_factory=list)

    @classmethod
    def clean(cls, n: int) -> "RoundFaults":
        return cls(crashed=np.zeros(n, bool), crash_frac=np.zeros(n),
                   aborted=np.zeros(n, bool), retries=np.zeros(n, int),
                   extra_bytes=np.zeros(n), extra_delay=np.zeros(n),
                   sent_bytes=np.zeros(n), corrupt=np.zeros(n, int))


class FaultModel:
    """Base: ``round_faults(epoch, wire_bytes, uplink_rate)`` -> the
    epoch's :class:`RoundFaults` (pure function of the constructor
    seed/script and its arguments)."""

    config: FaultConfig

    def round_faults(self, epoch: int, wire_bytes: np.ndarray,
                     uplink_rate: np.ndarray) -> RoundFaults:
        raise NotImplementedError

    @property
    def may_corrupt(self) -> bool:
        return self.config.corrupt_rate > 0.0

    def quorum_floor(self, scheduled: int) -> int:
        """Resolved minimum valid-contribution count for a round with
        ``scheduled`` dispatched participants."""
        q = self.config.quorum
        k = int(np.ceil(q * scheduled)) if 0.0 < q < 1.0 else int(q)
        return max(1, min(k, scheduled) if scheduled else 1)

    def outage_mask(self, epoch: int) -> Optional[np.ndarray]:
        """(N,) bool mask of clients inside an active correlated outage,
        or None.  Overridden by the cell-outage overlay
        (:class:`repro_torch.sim.outages.CellOutageModel`); the base models
        have no correlated structure."""
        del epoch
        return None


def _chunk_losses(rng: np.random.Generator, wire: float,
                  cfg: FaultConfig) -> Tuple[bool, int, float, float, float]:
    """Draw one client's chunked-uplink loss outcome.

    Returns ``(aborted, retries, extra_bytes, backoff_s, sent_bytes)``.
    Chunk k is retransmitted until one attempt succeeds
    (``u >= loss_rate``) or ``max_retries`` retries are exhausted, each
    retry preceded by a ``backoff_base * 2^j`` wait.  Chunk count is
    capped at 4096 (the chunk size grows instead) so pathological
    ``wire/chunk_bytes`` ratios cannot blow up the draw.
    """
    n_chunks = max(1, int(np.ceil(wire / cfg.chunk_bytes)))
    if n_chunks > 4096:
        n_chunks = 4096
    sizes = np.full(n_chunks, wire / n_chunks)
    tries = cfg.max_retries + 1
    u = rng.uniform(size=(n_chunks, tries))
    ok = u >= cfg.loss_rate
    first = np.argmax(ok, axis=1)               # first success per chunk
    dead = ~ok.any(axis=1)
    attempts = np.where(dead, tries, first + 1)
    fatal = int(np.argmax(dead)) if dead.any() else n_chunks
    live = np.arange(n_chunks) < fatal
    retries = int(np.sum((attempts - 1)[live]))
    extra = float(np.sum(((attempts - 1) * sizes)[live]))
    backoff = float(cfg.backoff_base
                    * np.sum((2.0 ** (attempts - 1) - 1.0)[live]))
    if fatal < n_chunks:
        sent = float(np.sum((attempts * sizes)[:fatal + 1]))
        return True, retries + cfg.max_retries, extra, backoff, sent
    return False, retries, extra, backoff, 0.0


class RandomFaults(FaultModel):
    """I.i.d. fault draws at the configured rates, keyed per
    (seed, epoch, client) so the stream is call-order independent."""

    def __init__(self, config: Optional[FaultConfig] = None, **kw):
        self.config = config or FaultConfig(**kw)

    def round_faults(self, epoch: int, wire_bytes: np.ndarray,
                     uplink_rate: np.ndarray) -> RoundFaults:
        cfg = self.config
        n = len(wire_bytes)
        out = RoundFaults.clean(n)
        for i in range(n):
            rng = np.random.default_rng(
                (cfg.seed, _TAG_FAULTS, epoch, i))
            # fixed draw order; unused channels still consume their draws
            # so enabling one channel never shifts another's stream
            u_crash, frac, u_corr, u_kind = rng.uniform(size=4)
            if cfg.crash_rate > 0.0 and u_crash < cfg.crash_rate:
                out.crashed[i] = True
                out.crash_frac[i] = frac
                continue
            if cfg.corrupt_rate > 0.0 and u_corr < cfg.corrupt_rate:
                kind = (cfg.corrupt_kind if cfg.corrupt_kind != "mix"
                        else CORRUPT_KINDS[int(u_kind
                                               * len(CORRUPT_KINDS))])
                out.corrupt[i] = 1 + CORRUPT_KINDS.index(kind)
            if cfg.loss_rate > 0.0:
                aborted, retries, extra, backoff, sent = _chunk_losses(
                    rng, float(wire_bytes[i]), cfg)
                out.aborted[i] = aborted
                out.retries[i] = retries
                out.extra_bytes[i] = extra
                out.sent_bytes[i] = sent
                r_u = max(float(uplink_rate[i]), 1e-9)
                out.extra_delay[i] = extra / r_u + backoff
        return out


class ScriptedFaults(FaultModel):
    """Explicit per-(round, client) fault script — the hand-computable
    scenarios the acceptance tests pin (e.g. "client 2 crashes in round
    3", "client 0's upload needs exactly 2 retransmits in round 1").

    crashes: ``{(epoch, client): crash_frac}`` (``True`` -> 0.5).
    chunk_retries: ``{(epoch, client): k}`` — exactly k retransmits of
      one ``chunk_bytes`` chunk, so the upload lands
      ``k * chunk_bytes / r_u + backoff_base * (2^k - 1)`` late having
      moved ``k * chunk_bytes`` duplicate bytes.
    aborts: ``{(epoch, client): sent_bytes}`` — the upload is abandoned
      after ``sent_bytes`` crossed the wire.
    corrupt: ``{(epoch, client): kind}`` with kind in
      :data:`CORRUPT_KINDS`.
    """

    def __init__(self, crashes: Optional[Dict] = None,
                 chunk_retries: Optional[Dict] = None,
                 aborts: Optional[Dict] = None,
                 corrupt: Optional[Dict] = None,
                 config: Optional[FaultConfig] = None, **kw):
        self.config = config or FaultConfig(**kw)
        self.crashes = dict(crashes or {})
        self.chunk_retries = dict(chunk_retries or {})
        self.aborts = dict(aborts or {})
        self.corrupt = dict(corrupt or {})
        for kind in self.corrupt.values():
            if kind not in CORRUPT_KINDS:
                raise ValueError(f"scripted corrupt kind {kind!r} not in "
                                 f"{CORRUPT_KINDS}")

    @property
    def may_corrupt(self) -> bool:
        return bool(self.corrupt)

    def round_faults(self, epoch: int, wire_bytes: np.ndarray,
                     uplink_rate: np.ndarray) -> RoundFaults:
        cfg = self.config
        n = len(wire_bytes)
        out = RoundFaults.clean(n)
        for (e, i), frac in self.crashes.items():
            if e == epoch and 0 <= i < n:
                out.crashed[i] = True
                out.crash_frac[i] = 0.5 if frac is True else float(frac)
        for (e, i), k in self.chunk_retries.items():
            if e == epoch and 0 <= i < n and not out.crashed[i]:
                out.retries[i] = int(k)
                out.extra_bytes[i] = float(k) * cfg.chunk_bytes
                r_u = max(float(uplink_rate[i]), 1e-9)
                out.extra_delay[i] = (out.extra_bytes[i] / r_u
                                      + cfg.backoff_base * (2.0 ** k - 1.0))
        for (e, i), sent in self.aborts.items():
            if e == epoch and 0 <= i < n and not out.crashed[i]:
                out.aborted[i] = True
                out.sent_bytes[i] = float(sent)
        for (e, i), kind in self.corrupt.items():
            if e == epoch and 0 <= i < n and not out.crashed[i]:
                out.corrupt[i] = 1 + CORRUPT_KINDS.index(kind)
        return out


def incident_events(fr: RoundFaults, scheduled: np.ndarray) -> list:
    """One observability event dict per fault incident in a round's draw
    (consumed by ``repro_torch.obs`` — the recorder's ``fault()`` hook turns
    each into a JSONL ``fault`` event and a
    ``feddd_fault_incidents_total{kind=}`` increment).

    ``scheduled`` is the (N,) bool mask of clients dispatched this round;
    incidents of unscheduled clients never happened on the timeline and
    are not reported.  Kinds: ``crash``, ``abort``, ``retry`` (survived
    retransmits), ``corrupt``, plus the cell-level ``outage_begin`` /
    ``outage_end`` transitions carried on ``fr.outages`` (cell id, member
    clients, duration in rounds — these are fleet-scoped, not filtered by
    the schedule).  Quarantine and quorum-skip incidents are emitted by
    the runner, which owns those decisions.
    """
    sched = np.asarray(scheduled, bool)
    out = [dict(ev) for ev in fr.outages]
    for i in np.flatnonzero(sched & fr.crashed):
        out.append({"kind": "crash", "client": int(i),
                    "crash_frac": float(fr.crash_frac[i])})
    for i in np.flatnonzero(sched & fr.aborted):
        out.append({"kind": "abort", "client": int(i),
                    "retries": int(fr.retries[i]),
                    "sent_bytes": float(fr.sent_bytes[i])})
    for i in np.flatnonzero(sched & (fr.retries > 0) & ~fr.aborted
                            & ~fr.crashed):
        out.append({"kind": "retry", "client": int(i),
                    "retries": int(fr.retries[i]),
                    "extra_bytes": float(fr.extra_bytes[i]),
                    "extra_delay": float(fr.extra_delay[i])})
    for i in np.flatnonzero(sched & (fr.corrupt > 0) & ~fr.crashed):
        out.append({"kind": "corrupt", "client": int(i),
                    "corrupt_kind": CORRUPT_KINDS[int(fr.corrupt[i]) - 1]})
    return out


# ------------------------------------------------- wire-side corruption

def _host_copy(leaf) -> np.ndarray:
    """A writable host numpy copy of one leaf (tensors other than
    float32 widen to float32: numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype != torch.float32 and t.is_floating_point():
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(leaf)


def corrupt_pytree(params, kind: str, rng: np.random.Generator):
    """The on-wire corruption of one upload, on a host numpy copy.

    ``nan`` / ``inf`` poison ~1/64 of each leaf's values; ``bitflip``
    flips one random mantissa/exponent bit of one float32 value per leaf
    (a leaf of another dtype gets a NaN write instead).  Deterministic
    given ``rng``'s seed: the same positions and bits as the JAX
    package's.  Returns a pytree of numpy arrays (float32 for every
    float leaf); the caller casts each back to its leaf's dtype.
    """
    if kind not in CORRUPT_KINDS:
        raise ValueError(f"unknown corruption kind {kind!r}")
    leaves, treedef = tree.flatten(params)
    out = []
    for leaf in leaves:
        is_f32 = (leaf.dtype == torch.float32 if isinstance(leaf, torch.Tensor)
                  else np.asarray(leaf).dtype == np.float32)
        arr = _host_copy(leaf)
        flat = arr.reshape(-1)
        if flat.size == 0:
            out.append(arr)
            continue
        if kind == "bitflip" and is_f32:
            pos = int(rng.integers(flat.size))
            bit = int(rng.integers(32))
            view = flat.view(np.uint32)
            view[pos] ^= np.uint32(1 << bit)
        else:
            k = max(1, flat.size // 64)
            pos = rng.choice(flat.size, size=k, replace=False)
            flat[pos] = np.nan if kind != "inf" else np.inf
        out.append(arr)
    return tree.unflatten(treedef, out)


def corruption_rng(seed: int, epoch: int, client: int
                   ) -> np.random.Generator:
    """The corruption noise stream for one (epoch, client) upload."""
    return np.random.default_rng((seed, _TAG_CORRUPT, epoch, client))


def host_update_stats(new_params, old_params) -> Tuple[float, bool]:
    """(l2 norm, all-finite) of one host-side update ``new - old``, in
    float64 — the per-client mirror of :func:`update_stats_stacked`."""
    sq = 0.0
    finite = True
    for nl, ol in zip(tree.leaves(new_params), tree.leaves(old_params)):
        d = (_host_copy(nl).astype(np.float64)
             - _host_copy(ol).astype(np.float64))
        finite = finite and bool(np.isfinite(d).all())
        sq += float(np.sum(np.square(np.nan_to_num(
            d, nan=0.0, posinf=0.0, neginf=0.0))))
    return float(np.sqrt(sq)), finite


def update_stats_device(stacked_new, stacked_old
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-client float32 squared update norm and all-finite flag of
    client-stacked updates, as two (N,) device tensors."""
    sq = None
    finite = None
    for nl, ol in zip(tree.leaves(stacked_new), tree.leaves(stacked_old)):
        d = nl.float() - ol.float()
        dims = tuple(range(1, d.ndim))
        if dims:
            fin = torch.isfinite(d).all(dim=dims)
            s = torch.square(torch.nan_to_num(d)).sum(dim=dims)
        else:
            fin = torch.isfinite(d)
            s = torch.square(torch.nan_to_num(d))
        sq = s if sq is None else sq + s
        finite = fin if finite is None else finite & fin
    return sq, finite


def stats_to_host(sq: torch.Tensor, finite: torch.Tensor
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(float64 norms, bool finite) on the host, in one transfer (the
    flags ride the squared norms' buffer); writable copies, since the
    runner overwrites corrupted rows' entries in place."""
    n = sq.shape[0]
    host = torch.cat([sq, finite.float()]).cpu().numpy()
    return np.sqrt(host[:n].astype(np.float64)), host[n:] > 0


def update_stats_stacked(stacked_new, stacked_old
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-client (l2 norm, all-finite) of client-stacked updates.

    One device reduction over the (N, *leaf) stacks and one host transfer
    of the two (N,) vectors.  Used by the validation screen every faulty
    round.
    """
    return stats_to_host(*update_stats_device(stacked_new, stacked_old))


def screen_quarantine(norms: np.ndarray, finite: np.ndarray,
                      candidates: np.ndarray,
                      vcfg: ValidationConfig) -> np.ndarray:
    """The server's payload-validation screen.

    Among ``candidates`` (this round's arrivals): quarantine non-finite
    updates, and updates whose norm exceeds ``norm_factor`` x the median
    finite-arrival norm.  Returns the (N,) quarantine mask.

    Small-survivor policy (pinned in tests/test_faults.py): the
    norm-anomaly screen needs a meaningful median, so it only engages
    when at least ``max(min_reference, 3)`` finite arrivals anchor it.
    With n <= 2 finite survivors the median of 1–2 norms says nothing
    about which one is anomalous (n=1 can never exceed 10x itself; n=2
    would let either arrival veto the other), so tiny survivor sets are
    screened by the finite check ONLY — never by the norm test,
    regardless of how low ``min_reference`` is configured.
    """
    cand = np.asarray(candidates, bool)
    quarantine = np.zeros_like(cand)
    if vcfg.screen_nonfinite:
        quarantine |= cand & ~np.asarray(finite, bool)
    good = cand & np.asarray(finite, bool)
    min_ref = max(int(vcfg.min_reference), 3)
    if vcfg.norm_factor > 0 and int(good.sum()) >= min_ref:
        ref = float(np.median(norms[good]))
        if ref > 0.0:
            quarantine |= good & (norms > vcfg.norm_factor * ref)
    return quarantine
