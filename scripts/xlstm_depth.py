#!/usr/bin/env python3
"""How far xlstm-1.3b's decode drifts from its forward with depth, at full
width (d 2048, 4 heads of 1024) on random weights.

    python3 scripts/xlstm_depth.py [--layers 8 16 48]        # the port, cuda
    JAX_PLATFORMS=cpu python3 scripts/xlstm_depth.py --jax --layers 8 16

Default: the port on the card: for each depth, decode from empty states
over 32 tokens at batch 2 against ``lm.forward``, in bf16 and in fp32
(TF32 off), and the bf16 forward against the fp32 forward of the same
weights, each as max |diff| / max |logit|.  ``--jax``: the JAX package's
own fp32 decode against its forward on the CPU, and the port's forward
and decode on the same weights (about 2 GB of fp32 parameters at 8
layers, 4 GB at 16).  Prints one JSON line per depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
B, T = 2, 32


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_decode(params, cfg, toks):
    import torch
    from repro_torch.models import lm
    with torch.inference_mode():
        full, _ = lm.forward(params, cfg, {"tokens": toks})
        step = lm.make_serve_step(cfg)
        st = lm.init_decode_state(params, cfg, B, T)
        outs = []
        for t in range(T):
            lg, st = step(params, st, toks[:, t:t + 1])
            outs.append(lg)
    return full.float().cpu().numpy(), torch.stack(outs, 1).cpu().numpy()


def port_on_card(layers: int) -> dict:
    import torch
    from repro_torch import tree
    from repro_torch.launch import serve
    cfg, params, gen = serve.build("xlstm_1p3b", reduced=False,
                                   num_layers=layers, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device="cuda")
    full16, dec16 = _port_decode(params, cfg, toks)
    params = tree.tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    full32, dec32 = _port_decode(params, cfg32, toks)
    return dict(layers=layers, device=torch.cuda.get_device_name(0),
                decode_vs_forward_bf16=_rel(dec16, full16),
                decode_vs_forward_fp32=_rel(dec32, full32),
                forward_bf16_vs_fp32=_rel(full16, full32))


def jax_on_cpu(layers: int) -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jax_get_config
    from repro.models import lm as jax_lm
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    kw = dict(num_layers=layers, param_dtype="float32",
              compute_dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("xlstm_1p3b"), **kw)
    tcfg = dataclasses.replace(get_config("xlstm_1p3b"), **kw)
    jp = jax_lm.init_model(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (B, T)).astype(np.int32)
    full = jax.jit(lambda p, t: jax_lm.forward(
        p, jcfg, {"tokens": t}, remat=False)[0])(jp, jnp.asarray(toks))
    serve = jax.jit(jax_lm.make_serve_step(jcfg))
    st = jax_lm.init_decode_state(jp, jcfg, B, T)
    outs = []
    for t in range(T):
        lg, st = serve(jp, st, jnp.asarray(toks[:, t:t + 1]))
        outs.append(lg)
    tp = lm_params_from_jax(jax.device_get(jp), "cpu")
    del jp
    pfull, pdec = _port_decode(tp, tcfg, torch.from_numpy(toks))
    return dict(layers=layers, device="cpu",
                jax_decode_vs_forward_fp32=_rel(jnp.stack(outs, 1), full),
                port_forward_vs_jax_fp32=_rel(pfull, full),
                port_decode_vs_forward_fp32=_rel(pdec, pfull))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 16, 48])
    ap.add_argument("--jax", action="store_true",
                    help="the JAX package's own drift on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if not args.jax:
        import torch
        if not torch.cuda.is_available():
            print("xlstm_depth: no CUDA device (use --jax on the CPU)",
                  file=sys.stderr)
            return 2
    for layers in args.layers:
        rec = jax_on_cpu(layers) if args.jax else port_on_card(layers)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
