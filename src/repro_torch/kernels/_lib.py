"""Build, load and bind the CUDA kernels of ``repro_torch/csrc``.

All ``.cu`` sources compile in ONE ``nvcc`` call for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use and lands in ``build/repro_torch/`` at the root
of the checkout; the library's name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Also here: the per-kernel launch counts (each wrapper adds one where it
launches its kernel, nowhere else), the cost a launch reports to an
active cost counter, and the helpers the wrappers share.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("importance.cu", "sparse_agg.cu", "masked_merge.cu",
           "flash_attention.cu", "flash_attention_sm90.cu", "conv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("importance", "sparse_agg", "masked_merge", "flash_attention",
           "conv")
_launches: Dict[str, int] = collections.Counter()
_routes: Dict[Tuple[str, object], int] = collections.Counter()
_flags: Dict[Tuple[str, str], int] = collections.Counter()

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    # w_old, w_new, coverage, out, n, a, c, b, vec, splits, dtype, stream
    "feddd_importance": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32,
                         _I32, _P),
    # vals, mask, weights, gprev, out, den, n, a, c, b, mask_c, vec, mode,
    # select, dtype, out_dtype, stream
    "feddd_sparse_agg": (_P,) * 6 + (_I64,) * 5 + (_I32,) * 5 + (_P,),
    # table (leaves x 18 int64, kernels/masked_merge/ops.plan), leaves,
    # dtype, stream
    "feddd_masked_merge_group": (ctypes.POINTER(_I64), _I32, _I32, _P),
    # q, k, v, out, b, sq, skv, h, hkv, hd, 9 strides (q, k, v: b, s, h),
    # causal, window, dtype, stream
    "feddd_flash_attention": (_P, _P, _P, _P) + (_I64,) * 15 + (_I32, _I64,
                                                                _I32, _P),
    # the same without the dtype (bf16 only)
    "feddd_flash_attention_sm90": (_P, _P, _P, _P) + (_I64,) * 15 + (
        _I32, _I64, _P),
    # x, w, out, desc (18 int64, kernels/conv/ops._fprop), stream
    "feddd_conv_fprop": (_P, _P, _P, ctypes.POINTER(_I64), _P),
    # x, g, out, desc (20 int64, kernels/conv/ops.wgrad_batched), stream
    "feddd_conv_wgrad": (_P, _P, _P, ctypes.POINTER(_I64), _P),
    # partials, out, clients, splits, elements a client, stream
    "feddd_conv_wgrad_reduce": (_P, _P, _I64, _I32, _I64, _P),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in ("common.cuh",) + SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfeddd_kernels-{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float, str]:
    """Compile the kernels if needed -> (library, seconds, compiler log)."""
    out = _library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out, secs, log


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, symbol: str, *args, device: torch.device,
           route=None) -> None:
    """Call ``symbol`` on PyTorch's current stream of ``device``, the card
    its tensors lie on, with that card current (a guard only when another
    one is); raise on a launch error, count the launch otherwise (and
    under ``route``: the route or mode of a kernel that has several, or
    what a launch covered)."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(kernel, symbol, *args, device=device, route=route)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(load(), symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    _launches[kernel] += 1
    if route is not None:
        _routes[kernel, route] += 1


def launch_counts() -> Dict[str, int]:
    return {k: _launches[k] for k in KERNELS}


def route_launches(kernel: str, routes=None) -> Dict:
    """Launches of ``kernel`` by route since ``reset_launch_counts``: of
    each of ``routes``, or of every route it has taken (sorted)."""
    if routes is None:
        routes = sorted(r for k, r in _routes if k == kernel)
    return {r: _routes[kernel, r] for r in routes}


def count_flag(kernel: str, flag: str) -> None:
    """Count a launch of ``kernel`` just made with the option ``flag``."""
    _flags[kernel, flag] += 1


def report_cost(kernel: str, cost: Callable[[], Tuple[float, int]]
                ) -> None:
    """Report one launch's (flops, bytes), ``cost()``, to every active cost
    counter (``launch.hlo_analysis.CostCounter``, a dispatch mode: the
    dispatcher does not see a ctypes launch).  Without a dispatch mode on
    the stack it returns at once and ``cost`` is never called."""
    if not torch._C._len_torch_dispatch_stack():
        return
    sinks = [mode.kernel_cost for mode in _get_current_dispatch_mode_stack()
             if hasattr(mode, "kernel_cost")]
    if sinks:
        flops, nbytes = cost()
        for sink in sinks:
            sink(kernel, flops, nbytes)


def flag_launches(kernel: str, flag: str) -> int:
    """Launches of ``kernel`` with ``flag`` since ``reset_launch_counts``."""
    return _flags[kernel, flag]


def reset_launch_counts() -> None:
    _launches.clear()
    _routes.clear()
    _flags.clear()


# --------------------------------------------------------- wrapper helpers

def kernel_device(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors that all lie on one such device; the
    wrappers run the plain version for 'cpu' and the kernel for 'cuda'."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}; use cuda or cpu")
    return dev.type


def check_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_dtype(name: str, t: torch.Tensor, allowed) -> None:
    if t.dtype not in allowed:
        raise TypeError(f"{name} has dtype {t.dtype}; expected one of "
                        f"{tuple(allowed)}")


def vector_width(inner: int, *tensors: torch.Tensor, most: int = 8) -> int:
    """Elements per access for a kernel that reads or writes rows of
    ``inner`` contiguous elements of each of ``tensors``: the largest power
    of two up to ``most`` that is at most 16 bytes of the first tensor's
    dtype, divides ``inner``, and keeps every tensor's first element
    aligned to it."""
    return vector_width_of(inner, tensors[0].element_size(),
                           [(t.data_ptr(), t.element_size())
                            for t in tensors], most)


def vector_width_of(inner: int, element_size: int, addrs, most: int = 8
                    ) -> int:
    """:func:`vector_width` from numbers: ``addrs`` holds an (address,
    element size) pair per tensor."""
    v = min(most, 16 // element_size)
    while v > 1 and (inner % v or any(p % (v * es) for p, es in addrs)):
        v //= 2
    return v


def split_at(shape, axis: int) -> Tuple[int, int, int]:
    """(A, C, B) of a leaf shape around its channel axis."""
    a = 1
    for s in shape[:axis]:
        a *= int(s)
    b = 1
    for s in shape[axis + 1:]:
        b *= int(s)
    return a, int(shape[axis]), b


def mask_view(leaf_shape, mask_shape, elementwise: bool = False
              ) -> Tuple[Tuple[int, int, int], int]:
    """((A, C, B), C_m) for a mask against a leaf.

    ``mask_shape`` is the un-stacked mask shape.  A channel-shaped mask is
    all ones except at most one axis, which must equal the leaf's size
    there (the channel axis); an all-ones mask shape (full uploads) gives
    C_m = 1.  With ``elementwise``, a mask shaped like the leaf that is
    not channel-shaped is taken too: the leaf's view is then (A, C, 1)
    around its last axis and C_m = A * C, one mask value per element.
    """
    if len(mask_shape) != len(leaf_shape):
        raise ValueError(f"mask shape {tuple(mask_shape)} does not match "
                         f"leaf shape {tuple(leaf_shape)}")
    axes = [i for i, s in enumerate(mask_shape) if s != 1]
    if not axes:
        size = 1
        for s in leaf_shape:
            size *= int(s)
        return (1, 1, size), 1
    if len(axes) == 1 and mask_shape[axes[0]] == leaf_shape[axes[0]]:
        acb = split_at(leaf_shape, axes[0])
        return acb, acb[1]
    if elementwise and tuple(mask_shape) == tuple(leaf_shape):
        a, c, _ = split_at(leaf_shape, len(leaf_shape) - 1)
        return (a, c, 1), a * c
    raise ValueError(f"mask shape {tuple(mask_shape)} is not "
                     f"channel-shaped for leaf {tuple(leaf_shape)}")
