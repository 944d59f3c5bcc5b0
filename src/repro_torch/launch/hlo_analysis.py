"""Cost accounting for the dry-run: the counterpart of
``repro.launch.hlo_analysis``, reading the torch dispatcher where the JAX
package reads XLA HLO.

The JAX package lowers a step, compiles it for a 256- or 512-chip mesh
and reads ``cost_analysis()`` (flops, bytes accessed), the partitioned
HLO's collectives and ``memory_analysis()``.  The port has no compiler
and no partitioner: :class:`CostCounter` (a ``TorchDispatchMode``) runs
the step itself, on ``meta`` tensors for the dry-run or on the card to
check the count, and counts per aten op

* flops, through ``torch.utils.flop_counter``'s registry (matmuls,
  convolutions, attention; elementwise ops count none);
* bytes accessed: the tensor inputs' and outputs' ``nbytes`` (XLA's
  HloCostAnalysis convention); view and alias ops, and allocations that
  write nothing (``empty``), count 0;
* the peak of live bytes: each storage an op creates on the counted
  device is live from then until it is freed (a finaliser on the
  storage), so views and autograd's saved tensors that share a storage
  count once.

The repo's own kernels launch through ``ctypes``, out of the
dispatcher's sight, so each wrapper reports its cost to an active
counter (``kernels._lib.report_cost``): the counter files it under
``kernel:<name>``.  The port runs no partitioned program, so there are
no collectives to read: the dry-run records them as null, and the pods'
sync (``launch.perf_federated``) counts its own.

``Hardware`` holds one H100 SXM's published numbers; ``Roofline`` and
``model_flops`` are the reference's.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.analytic_cost import H100_BF16_FLOPS, H100_HBM_BW


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet; dense
    rates)."""
    peak_flops: float = H100_BF16_FLOPS   # bf16 FLOP/s, tensor cores
    hbm_bw: float = H100_HBM_BW           # bytes/s, HBM3
    link_bw: float = 450e9                # bytes/s each way, NVLink 4
    hbm_bytes: float = 80e9               # capacity


@dataclasses.dataclass
class Roofline:
    """Per-device roofline terms.  ``collective_per_device`` None means
    the collectives were not counted (the port partitions nothing): the
    collective term is then None and the dominant term is taken over
    compute and memory."""
    flops_per_device: float
    bytes_per_device: float
    collective_per_device: Optional[Dict[str, int]]
    num_devices: int
    hw: Hardware = dataclasses.field(default_factory=Hardware)

    @property
    def compute_term(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def memory_term(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def collective_term(self) -> Optional[float]:
        if self.collective_per_device is None:
            return None
        return sum(self.collective_per_device.values()) / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_term, "memory": self.memory_term}
        if self.collective_term is not None:
            terms["collective"] = self.collective_term
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict:
        coll = self.collective_per_device
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_per_device": None if coll is None else dict(coll),
            "num_devices": self.num_devices,
            "compute_term_s": self.compute_term,
            "memory_term_s": self.memory_term,
            "collective_term_s": self.collective_term,
            "dominant": self.dominant,
        }


def model_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens.

    N counts *active* parameters: for MoE layers top_k/num_experts of the
    expert params; embeddings excluded from the 6ND rule's N (standard
    convention) but the lm_head matmul is included via 2*D*d*V.
    """
    n_active = 0
    layout = cfg.layout()
    d = cfg.d_model
    hd = cfg.head_dim_
    for spec in layout:
        if spec.mixer in ("attn", "attn_local"):
            n_active += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        elif spec.mixer == "mamba":
            di = cfg.mamba.expand * d
            dr = cfg.mamba.dt_rank or max(1, int(np.ceil(d / 16)))
            n_active += (d * 2 * di + di * (dr + 2 * cfg.mamba.d_state)
                         + dr * di + di * d)
        elif spec.mixer in ("mlstm", "slstm"):
            di = int(cfg.xlstm.proj_factor * d)
            n_active += d * 2 * di + di * d
            hd_x = di // cfg.num_heads
            # mlstm q/k/v are per-head block-diagonal
            n_active += (3 * di * hd_x if spec.mixer == "mlstm"
                         else 4 * di * di + 4 * di * hd_x)
        if spec.cross_attention:
            n_active += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        if spec.ff == "dense":
            mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
            n_active += mats * d * cfg.d_ff
        elif spec.ff == "moe":
            mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
            n_active += mats * d * cfg.moe.d_ff_expert * cfg.moe.top_k
    # encoder layers (audio)
    for spec in (cfg.encoder_layout() if cfg.is_encdec else []):
        n_active += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
        n_active += mats * d * cfg.d_ff

    tokens = batch * (1 if kind == "decode" else seq)
    factor = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[kind]
    head = (2.0 * tokens * d * cfg.vocab_size
            * (3.0 if kind == "train" else 1.0))
    return factor * n_active * tokens + head


# --------------------------------------------------------- the counter -----

def _tensors(x):
    """The tensors among an op's arguments or results (one level of
    lists and tuples, as aten schemas nest them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                yield v
            elif isinstance(v, (list, tuple)):
                yield from (t for t in v if isinstance(t, torch.Tensor))
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# allocations that write nothing: no traffic (their storage still counts
# toward the live bytes)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


class CostCounter(TorchDispatchMode):
    """Counts flops, bytes accessed and the peak of live bytes of every
    aten op run inside ``with CostCounter(device):``.

    ``device``: the device type whose new storages count toward the live
    bytes ("meta" for a dry-run trace, "cuda" on the card, "cpu"); host
    temporaries of a card run are not the card's memory, and ops on host
    tensors only are filed as ``<op>@host``.  The counts are per op
    (``by_op``: calls, flops, bytes) and in total (``totals``).
    """

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = torch.device(device).type
        self.ops: Dict[str, list] = collections.defaultdict(
            lambda: [0, 0.0, 0])
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._lock = threading.Lock()

    # -- bookkeeping ----------------------------------------------------
    def _add(self, key: str, flops: float, nbytes: int) -> None:
        with self._lock:
            rec = self.ops[key]
            rec[0] += 1
            rec[1] += flops
            rec[2] += nbytes

    def _alloc(self, storage, nbytes: int) -> None:
        key = storage._cdata
        with self._lock:
            if key in self._storages:
                return
            self._storages[key] = nbytes
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._storages.pop(key, 0)

    def kernel_cost(self, name: str, flops: float, nbytes: int) -> None:
        """A launch of one of the repo's kernels, reported by its wrapper
        (the dispatcher does not see it)."""
        self._add(f"kernel:{name}", float(flops), int(nbytes))

    # -- the dispatch hook ------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite op (matmul, einsum, ...) reaches the mode whole when
        # autograd is off (inference mode): count it as the ops it runs,
        # as a step with grad sees them
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        in_storages = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs
                 if t.untyped_storage()._cdata not in in_storages]
        packet = func._overloadpacket
        fn = flop_registry.get(packet)
        flops = float(fn(*args, **kwargs, out_val=out)) if fn else 0.0
        name = packet.__name__
        if name in _NO_TRAFFIC or (outs and not fresh
                                   and not func._schema.is_mutable):
            nbytes = 0                 # a view or alias, or no write
        else:
            nbytes = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        key = str(func)
        if self.device != "cpu" and all(
                t.device.type == "cpu" for t in ins + outs) and ins + outs:
            key += "@host"       # a host-side op of a device run
        self._add(key, flops, nbytes)
        for t in fresh:
            if t.device.type == self.device:
                st = t.untyped_storage()
                self._alloc(st, st.nbytes())
        return out

    # -- results ----------------------------------------------------------
    def by_op(self) -> Dict[str, Dict]:
        return {k: {"calls": c, "flops": f, "bytes": b}
                for k, (c, f, b) in sorted(self.ops.items())}

    def totals(self) -> Dict:
        return {"flops": sum(r[1] for r in self.ops.values()),
                "bytes": sum(r[2] for r in self.ops.values()),
                "ops": sum(r[0] for r in self.ops.values()),
                "peak_live_bytes": self.peak}


def op_differences(a: Dict[str, Dict], b: Dict[str, Dict]) -> Dict:
    """The ops whose calls, flops or bytes differ between two ``by_op``
    counts: {op: (a's, b's)} (a missing op reads as None)."""
    out = {}
    for k in sorted(set(a) | set(b)):
        if a.get(k) != b.get(k):
            out[k] = (a.get(k), b.get(k))
    return out


def costly_device_differences(diff: Dict) -> Dict:
    """The entries of ``op_differences`` that move device flops or bytes:
    host-side ops and ops that cost nothing are left out (they are named,
    not counted)."""
    return {k: v for k, v in diff.items() if not k.endswith("@host")
            and any(r and (r["flops"] or r["bytes"]) for r in v)}
