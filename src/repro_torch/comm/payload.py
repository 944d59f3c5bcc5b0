"""Upload payloads and on-wire byte accounting — the port's copy of
``repro.comm.payload``.

* :class:`CommConfig` — the wire format of a run (``ProtocolConfig.comm``);
  the default (dense codec, 32-bit values) is the analytic accounting.
* :class:`WireSpec` — per-leaf (channels, elements) of one model, what the
  analytic byte model and the overhead-aware allocation need.
* :func:`encode_upload` / :func:`decode_upload` — one client's serialized
  upload on the host: per-leaf mask bytes + quantized kept values; decoded
  masks are exact, values bit-identical for qbits=32, cast-exact for 16,
  within one scale step for 8; ``payload.nbytes`` equals the measured
  accounting.
* the accounting every driver charges through: :func:`uplink_bytes_raw`,
  :func:`account_uplink` (raw + wire bytes from measured overheads),
  :func:`analytic_wire_bytes` (bytes as a function of the dropout rate:
  the Eq. (12) clock and the overhead-aware LP), and the cross-device
  :func:`collective_payload_bytes` / :func:`account_collective`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.comm import codecs, quantize


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Wire format of a protocol run.

    codec: mask encoding — ``dense`` (values only, the analytic
      accounting), ``bitmask``, ``index`` or ``auto`` (per leaf the
      cheaper of the two).
    qbits: value precision — 32 (lossless), 16 (fp16 cast), 8 (int8
      stochastic rounding of the values the server aggregates; clients
      keep their full-precision values for Eq. (5)).
    overhead_aware_allocation: solve the dropout LP on effective wire
      bytes per kept parameter instead of the linear ``U_n`` proxy (a
      host-side fixed point around the numpy LP).
    """

    codec: str = "dense"
    qbits: int = 32
    overhead_aware_allocation: bool = False

    def __post_init__(self):
        if self.codec not in codecs.CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; "
                             f"expected one of {codecs.CODECS}")
        if self.qbits not in quantize.QBITS:
            raise ValueError(f"qbits must be one of {quantize.QBITS}, "
                             f"got {self.qbits}")

    @property
    def is_default(self) -> bool:
        """The analytic accounting (dense codec, lossless values): a run
        is then the same as one without a comm config."""
        return self.codec == "dense" and self.qbits == 32


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Per-leaf (channels, elements) of one model; hashable."""

    leaves: Tuple[Tuple[int, int], ...]

    @classmethod
    def from_params(cls, params, channel_axis: int = -1) -> "WireSpec":
        out = []
        for l in tree.leaves(params):
            shape = tuple(l.shape)
            if not shape:
                out.append((1, 1))
                continue
            out.append((int(shape[channel_axis % len(shape)]),
                        int(np.prod(shape, dtype=np.int64))))
        return cls(tuple(out))

    @classmethod
    def from_stacked(cls, stacked, channel_axis: int = -1) -> "WireSpec":
        """Spec of client-stacked params (the leading client axis
        dropped)."""
        one = tree.tree_map(lambda l: np.empty(tuple(l.shape[1:]), np.uint8),
                            stacked)
        return cls.from_params(one, channel_axis)

    @property
    def total_elements(self) -> int:
        return sum(e for _, e in self.leaves)


# ------------------------------------------------------- real payloads

@dataclasses.dataclass
class LeafUpload:
    mask_bytes: bytes
    value_bytes: bytes
    scale: Optional[float]        # int8 per-leaf scale (ships with framing)
    num_channels: int
    shape: Tuple[int, ...]
    channel_axis: int             # the leaf axis the mask spans (part of the
                                  # schema both ends share)
    known_mask: Optional[np.ndarray] = None   # dense codec: the mask the
                                              # receiver knows (zero bytes)


@dataclasses.dataclass
class UploadPayload:
    """One client's serialized sparse upload (host side)."""

    leaves: List[LeafUpload]
    treedef: object
    comm: CommConfig

    @property
    def nbytes(self) -> int:
        """On-wire bytes: mask framing + quantized values + int8 scales
        (= codecs.mask_overhead_bytes + kept * value_bytes)."""
        total = 0
        for lf in self.leaves:
            total += len(lf.mask_bytes) + len(lf.value_bytes)
            if lf.scale is not None:
                total += 4
        return total


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def encode_upload(params, masks, comm: CommConfig, key=None
                  ) -> UploadPayload:
    """Serialize one client's masked update What ⊙ M.

    ``key`` is the client's quantization key
    (:func:`repro_torch.comm.quantize.client_quant_key`), folded per leaf
    in flatten order: the noise the in-engine QDQ draws, so the decoded
    values are the values the server's aggregation consumed.
    """
    pleaves, treedef = tree.flatten(params)
    mleaves = tree.leaves(masks)
    out: List[LeafUpload] = []
    for i, (p, m) in enumerate(zip(pleaves, mleaves)):
        p_host = _host(p)
        m_host = _host(m)
        m1d = m_host.reshape(-1)
        # the mask's single non-unit axis (masks are (1, ..., C, ..., 1));
        # an all-unit mask degenerates to the last axis
        nonunit = [ax for ax, s in enumerate(m_host.shape) if s > 1]
        ch_ax = nonunit[0] if nonunit else max(m_host.ndim - 1, 0)
        mask_buf = codecs.encode_mask(m1d, comm.codec)
        mfull = np.broadcast_to(m_host, p_host.shape) > 0
        kept_vals = p_host[mfull]
        scale = None
        if comm.qbits == 32:
            buf = kept_vals.astype(np.float32).tobytes()
        elif comm.qbits == 16:
            buf = kept_vals.astype(np.float16).tobytes()
        else:
            leaf_key = prng.fold_in(key, i) if key is not None else None
            codes, s = quantize.quantize_leaf(torch.from_numpy(p_host),
                                              comm.qbits, leaf_key)
            # the scale ships only with values to decode
            scale = float(s) if int(np.sum(mfull)) else None
            buf = codes.numpy()[mfull].tobytes()
        out.append(LeafUpload(mask_buf, buf, scale, int(m1d.shape[0]),
                              tuple(p_host.shape), ch_ax,
                              known_mask=(m1d if comm.codec == "dense"
                                          else None)))
    return UploadPayload(out, treedef, comm)


def decode_upload(payload: UploadPayload):
    """Inverse of :func:`encode_upload` -> (values, masks) pytrees of
    float32 numpy arrays: the decoded kept values at their positions
    (zeros where dropped: Eq. (4)'s numerator contribution) and the
    full-shape 0/1 mask."""
    comm = payload.comm
    vals, msks = [], []
    for lf in payload.leaves:
        m1d = (np.asarray(lf.known_mask, np.float32)
               if lf.known_mask is not None
               else codecs.decode_mask(lf.mask_bytes, lf.num_channels,
                                       comm.codec))
        if len(lf.shape) == 0:
            mfull = np.ones((), np.float32) * m1d[0]
        else:
            shape = [1] * len(lf.shape)
            shape[lf.channel_axis] = lf.num_channels
            mfull = np.broadcast_to(m1d.reshape(shape), lf.shape)
        sel = mfull > 0
        kept = int(np.sum(sel))
        if comm.qbits == 32:
            dec = np.frombuffer(lf.value_bytes, np.float32, count=kept)
        elif comm.qbits == 16:
            dec = np.frombuffer(lf.value_bytes, np.float16,
                                count=kept).astype(np.float32)
        else:
            q = np.frombuffer(lf.value_bytes, np.int8, count=kept)
            dec = (q.astype(np.float32) * np.float32(lf.scale)
                   if lf.scale and lf.scale > 0
                   else np.zeros(kept, np.float32))
        full = np.zeros(lf.shape, np.float32)
        full[sel] = dec
        vals.append(full)
        msks.append(np.asarray(mfull, np.float32))
    return (tree.unflatten(payload.treedef, vals),
            tree.unflatten(payload.treedef, msks))


# ------------------------------------------------------- byte accounting

def uplink_bytes_raw(densities, participants, model_bytes) -> float:
    """sum_n density_n * U_n over the round's uploaders: the one place raw
    upload bytes are computed."""
    d = np.asarray(densities, np.float64)
    p = np.asarray(participants, np.float64)
    return float(np.dot(d * p, np.asarray(model_bytes, np.float64)))


def account_uplink(densities, participants, model_bytes, wire_overhead,
                   comm: CommConfig, obs=None) -> Tuple[float, float]:
    """(uploaded_bytes, wire_bytes) of one round.

    ``uploaded_bytes`` is the raw kept-parameter mass (density x U_n);
    ``wire_bytes`` scales it to the codec's value precision and adds the
    measured per-client mask overhead (``wire_overhead``, from
    ``codecs.mask_overhead_bytes_stacked``; None for the dense codec).
    The default CommConfig gives the same float twice.  ``obs`` (a
    :mod:`repro_torch.obs` recorder) gets both through ``obs.uplink``, so
    its byte counters equal the round records' sums on every executor.
    """
    raw = uplink_bytes_raw(densities, participants, model_bytes)
    if comm.is_default:
        wire = raw
    else:
        wire = raw * (comm.qbits / 32.0)
        if wire_overhead is not None:
            wire += float(np.dot(np.asarray(wire_overhead, np.float64),
                                 np.asarray(participants, np.float64)))
    if obs is not None and obs.active:
        obs.uplink(raw, wire)
    return raw, wire


def collective_payload_bytes(spec: WireSpec, *, mode: str = "dense",
                             k_fraction: float = 1.0) -> float:
    """Per-shard, per-hop bytes of ONE Eq. (4) cross-device reduction:
    ``dense`` moves the float32 numerator of every element plus the (C,)
    denominator per leaf; ``sparse`` the compacted top-K exchange, per
    leaf ``K = max(1, ceil(C * k_fraction))`` rows of ``elements/C``
    float32 values, K int32 indices and K float32 denominator rows."""
    if mode not in ("dense", "sparse"):
        raise ValueError(f"mode must be 'dense' or 'sparse', got {mode!r}")
    total = 0.0
    for c, e in spec.leaves:
        if mode == "dense":
            total += e * 4.0 + c * 4.0
        else:
            k = max(1, min(c, int(np.ceil(c * k_fraction))))
            total += k * (e / c) * 4.0 + k * 4.0 + k * 4.0
    return total


def account_collective(spec: WireSpec, num_shards: int, *,
                       mode: str = "dense", k_fraction: float = 1.0,
                       obs=None) -> Tuple[float, float]:
    """(dense_bytes, actual_bytes) of one round's Eq. (4) reduction summed
    over the shards; equal for ``mode="dense"``.  ``obs`` (a
    :mod:`repro_torch.obs` recorder) gets both through ``obs.collective``,
    as :func:`account_uplink` hands it the uplink leg."""
    dense = collective_payload_bytes(spec, mode="dense") * num_shards
    actual = collective_payload_bytes(
        spec, mode=mode, k_fraction=k_fraction) * num_shards
    if obs is not None and obs.active:
        obs.collective(dense, actual)
    return dense, actual


class _NumpyOps:
    """The array functions of the analytic byte model, on numpy arrays."""

    @staticmethod
    def f32(x):
        return np.asarray(x, np.float32)

    @staticmethod
    def full_like(x, value):
        return np.full_like(x, value)

    ceil, clip, maximum, minimum = np.ceil, np.clip, np.maximum, np.minimum


class _TorchOps:
    """The same functions on tensors, on their device, with no host copy
    (the scanned engine's device clock)."""

    @staticmethod
    def f32(x):
        return x.to(torch.float32)

    @staticmethod
    def full_like(x, value):
        return torch.full_like(x, value)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def maximum(x, lo):
        return torch.clamp(x, min=lo)

    @staticmethod
    def minimum(x, hi):
        return torch.clamp(x, max=hi)

    ceil = torch.ceil


def _ops(x):
    return _TorchOps if isinstance(x, torch.Tensor) else _NumpyOps


def varint_bytes_f(v):
    """Float rendering of ``codecs.varint_bytes`` for the analytic model
    (expected gaps are fractional); a tensor gives a tensor."""
    xp = _ops(v)
    v = xp.f32(v)
    out = xp.full_like(v, 1.0)
    for t in (1 << 7, 1 << 14, 1 << 21, 1 << 28):
        out = out + xp.f32(v >= t)
    return out


def analytic_wire_bytes(spec: WireSpec, dropout, comm: CommConfig):
    """Modelled on-wire upload bytes as a function of the dropout rate
    (float32, scalar or vector ``dropout``; a tensor of rates gives a
    tensor on its device, the reference's ``xp=jnp`` rendering).

    Kept counts as the mask builder makes them (per leaf
    ``clip(ceil(C*(1-D)), 0, C)``, one D for every leaf) and the measured
    framing; exact for ``dense`` and ``bitmask``; ``index``/``auto`` take
    the expected uniform gap ``C/kept - 1`` (the measured overhead
    depends on which channels survive)."""
    xp = _ops(dropout)
    d = xp.f32(dropout)
    vbytes = float(quantize.value_bytes(comm.qbits))
    values = xp.full_like(d, 0.0)
    overhead = xp.full_like(d, 0.0)
    for c, e in spec.leaves:
        kept = xp.clip(xp.ceil(c * (1.0 - d)), 0.0, float(c))
        values = values + kept * (e / c) * vbytes
        if comm.qbits == 8:
            overhead = overhead + 4.0 * xp.f32(kept > 0)
        if comm.codec != "dense":
            bm = float(codecs.HEADER_BYTES + codecs.bitmask_bytes(c))
            if comm.codec in ("index", "auto"):
                # C / kept with C as an array: a tensor divides truly
                gap = xp.maximum(xp.full_like(kept, float(c))
                                 / xp.maximum(kept, 1.0) - 1.0, 0.0)
                ix = codecs.HEADER_BYTES + kept * varint_bytes_f(gap)
                if comm.codec == "index":
                    overhead = overhead + ix
                else:
                    overhead = (overhead + codecs.AUTO_TAG_BYTES
                                + xp.minimum(ix, bm))
            else:
                overhead = overhead + bm
    return values + overhead


def delivered_prefix_counts(spec: WireSpec, dropout: float,
                            comm: CommConfig,
                            delivered_bytes: float) -> np.ndarray:
    """Per-leaf kept-channel counts a truncated upload delivered.

    The serialized upload walks the leaves in flatten order, each leaf's
    framing first and then its kept channels in ascending order, so a cut
    after ``delivered_bytes`` is a per-leaf prefix of kept channels (the
    deadline policy's partial aggregation).  Kept counts and framing as
    :func:`analytic_wire_bytes`: a cut at its total delivers every kept
    channel, a cut at 0 none.  (L,) int32, one entry per leaf.
    """
    remaining = float(delivered_bytes)
    vbytes = float(quantize.value_bytes(comm.qbits))
    counts = np.zeros(len(spec.leaves), np.int32)
    for li, (c, e) in enumerate(spec.leaves):
        kept = int(np.clip(np.ceil(c * (1.0 - float(dropout))), 0.0,
                           float(c)))
        per_kept = (e / c) * vbytes
        frame = 0.0
        if comm.qbits == 8 and kept > 0:
            frame += 4.0
        if comm.codec != "dense":
            bm = float(codecs.HEADER_BYTES + codecs.bitmask_bytes(c))
            if comm.codec in ("index", "auto"):
                gap = max(c / max(kept, 1.0) - 1.0, 0.0)
                gap_b = float(varint_bytes_f(gap))
                ix = codecs.HEADER_BYTES + kept * gap_b
                if comm.codec == "index":
                    per_kept += gap_b
                    frame += codecs.HEADER_BYTES
                elif ix < bm:
                    per_kept += gap_b
                    frame += codecs.AUTO_TAG_BYTES + codecs.HEADER_BYTES
                else:
                    frame += codecs.AUTO_TAG_BYTES + bm
            else:
                frame += bm
        if remaining < frame or kept == 0:
            break
        remaining -= frame
        got = (kept if per_kept <= 0.0
               else min(kept, int(np.floor(remaining / per_kept + 1e-9))))
        counts[li] = got
        remaining -= got * per_kept
        if got < kept:
            break
    return counts


def analytic_uplink_vector(specs, dropout_vec, comm: CommConfig
                           ) -> np.ndarray:
    """Per-client analytic uplink bytes of a (possibly ragged) fleet: one
    WireSpec and one dropout rate per client; what the Eq. (12) clock
    charges on the uplink when the codec is not dense."""
    d = np.asarray(dropout_vec, np.float64)
    out = np.empty_like(d)
    cache = {}
    for i, spec in enumerate(specs):
        key = (spec, float(d[i]))
        if key not in cache:
            cache[key] = float(analytic_wire_bytes(spec, d[i], comm))
        out[i] = cache[key]
    return out
