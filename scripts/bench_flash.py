#!/usr/bin/env python3
"""Time the port's flash-attention wrapper at the serving path's shapes on
one NVIDIA GPU, for the package under ``--src`` (default: this checkout's).

    python3 scripts/bench_flash.py [--src DIR] [--out PATH]

Shapes: gemma3-27b's heads (B=1, 32 query / 16 kv heads, hd 128), bf16,
causal, at S = 8192 and 32768, windows 0 and 1024 (the global and local
layers of the 32k prefill).  Each time is ``chip_smoke.time_ms``: the
median of ``chip_smoke.LONG_TIMED`` CUDA-event pairs around one call,
after three warm-up calls, with L2 flushed before each call.  ``--src``
may be another checkout's ``src``, so two versions of the kernel are
compared on one card in one run (parent, change, change, parent).  That
package builds its kernels into its own checkout's ``build/``, so unpack
the other commit (``git archive``) under this checkout's git-ignored
``build/``, e.g. ``build/parent``, and pass ``--src build/parent/src``.
Prints one JSON line; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(8192, 0), (8192, 1024), (32768, 0), (32768, 1024)]
HEADS, KV_HEADS, HEAD_DIM = 32, 16, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash needs a CUDA device")
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    card = smoke.card_line()
    _, build_s, _ = kernels.build()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    s_max = max(s for s, _ in SHAPES)
    q, k, v = (torch.randn((1, s_max, n, HEAD_DIM), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for n in (HEADS, KV_HEADS, KV_HEADS))

    times = []
    for s, window in SHAPES:
        qs, ks, vs = q[:, :s], k[:, :s], v[:, :s]
        ms = smoke.time_ms(lambda: ops.flash_attention(  # noqa: B023
            qs, ks, vs, causal=True, window=window), flush, smoke.LONG_TIMED)
        times.append(dict(seq=s, window=window, ms=ms))
    res = dict(card=card, src=str(src), build_s=build_s,
               shape=[1, None, HEADS, KV_HEADS, HEAD_DIM], dtype="bfloat16",
               times=times)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
