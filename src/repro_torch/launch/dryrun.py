"""Dry-run of every (architecture x input shape) pair on the production
meshes: per-device memory, cost and roofline terms, from an abstract
trace of the port's own step.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID ...] \
        [--shape NAME ...] [--mesh single|multi|both] [--force] [--tag T] \
        [--rules JSON] [--microbatches N] [--results-dir DIR]

The counterpart of ``repro.launch.dryrun``.  The JAX package lowers and
compiles each step for a 256- or 512-chip mesh and reads XLA's cost and
memory analyses.  The port has no compiler and no partitioner, so it runs
the step once, at the global shape, on ``meta`` tensors under
``launch.hlo_analysis.CostCounter`` (every op executes, shapes only; the
flash kernel's wrapper reports its cost), and derives both meshes from
that one trace:

* ``memory.argument_bytes``: per device, the local-shard bytes of every
  input (parameters or train state, batch, decode state) under the specs
  of ``models.sharding`` and ``lm.*_pspecs``;
* ``roofline``: the trace's flops and bytes divided by the device count
  on ``Hardware`` (one H100); ``collective_term_s`` is null (no
  partitioned program, so no collectives to count) and the dominant term
  is taken over compute and memory;
* ``trace_peak_live_bytes``: the peak of the bytes the unsharded step
  allocates beyond its inputs, and ``fits_one_card``: inputs plus that
  peak within one card's memory;
* ``temp_bytes`` is null for the same reason as the collectives.

The trace counts every executed op, layers and microbatches included,
so the reference's ``--unroll`` has no twin.  Records are cached under
``results/dryrun_torch/`` (never the JAX package's ``results/dryrun/``),
so an interrupted sweep resumes.  Nothing here touches a device but
``meta``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.analytic_cost import analytic_terms
from repro_torch.launch.hlo_analysis import (CostCounter, Hardware, Roofline,
                                             model_flops)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm, sharding
from repro_torch.optim import adafactor, adamw

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESHES = {"single": False, "multi": True}
NO_PARTITION = ("the port runs no partitioned program: no collectives or "
                "compiler temporaries to read")


def _opt(name: str):
    return adafactor(1e-2) if name == "adafactor" else adamw(3e-4)


def _batch_spec(t: torch.Tensor, mesh) -> sharding.Spec:
    if t.ndim >= 2:
        axes = ("batch", "seq") + (None,) * (t.ndim - 2)
    elif t.ndim == 1:
        axes = ("batch",)
    else:
        axes = ()
    return sharding.spec(*axes, shape=tuple(t.shape), mesh=mesh)


def build_lowerable(cfg, shape_name: str, num_microbatches: int = 0):
    """(step, abstract args, spec_fn): ``step(*args)`` is the pair's step
    on meta inputs, ``spec_fn(mesh)`` the args' specs on ``mesh``.

    train: ``lm.make_train_step`` with the policy's optimizer and
    microbatches (``num_microbatches`` overrides); prefill: ``lm.prefill``
    (the last position's logits; flash at S >= FLASH_MIN_SEQ); decode:
    ``lm.make_serve_step`` on ``lm.abstract_decode_state``, windowed at
    long_500k."""
    _, _, kind = specs_mod.SHAPES[shape_name]
    pol = specs_mod.policy_for(cfg)
    if kind == "train":
        opt = _opt(pol.optimizer)
        step = lm.make_train_step(
            cfg, opt, num_microbatches=num_microbatches
            or pol.num_microbatches)
        ts = lm.abstract_train_state(cfg, opt)
        batch = specs_mod.input_specs(cfg, shape_name)
        return step, (ts, batch), lambda mesh: (
            lm.train_state_pspecs(cfg, ts, mesh),
            {k: _batch_spec(v, mesh) for k, v in batch.items()})
    if kind == "prefill":
        params = lm.abstract_params(cfg)
        batch = specs_mod.input_specs(cfg, shape_name)
        return (lambda p, b: lm.prefill(p, cfg, b)), (params, batch), \
            lambda mesh: (lm.param_pspecs(cfg, params, mesh),
                          {k: _batch_spec(v, mesh) for k, v in batch.items()})
    cfg_eff = specs_mod.effective_decode_config(cfg, shape_name)
    serve = lm.make_serve_step(cfg_eff)
    params = lm.abstract_params(cfg_eff)
    state, tokens = specs_mod.decode_specs(cfg, shape_name)
    return serve, (params, state, tokens), lambda mesh: (
        lm.param_pspecs(cfg_eff, params, mesh),
        lm.decode_state_pspecs(cfg_eff, state, mesh),
        _batch_spec(tokens, mesh))


def argument_bytes(args: Sequence, arg_specs: Optional[Sequence] = None,
                   mesh=None) -> int:
    """Per-device bytes of the inputs: each tensor's block under its spec
    on ``mesh`` (no mesh: whole tensors); host scalars hold none."""
    total = 0
    for i, arg in enumerate(args):
        leaves = list(tree.named_leaves(arg))
        if mesh is None:
            spl = [None] * len(leaves)
        else:
            spl = [s for _, s in tree.named_leaves(arg_specs[i])]
        if len(leaves) != len(spl):
            raise ValueError(f"{len(leaves)} leaves, {len(spl)} specs")
        for (_, t), s in zip(leaves, spl):
            if isinstance(t, torch.Tensor):
                shape = (tuple(t.shape) if mesh is None else
                         sharding.local_shape(tuple(t.shape), s, mesh))
                total += math.prod(shape) * t.element_size()
    return total


def trace(cfg, shape_name: str, num_microbatches: int = 0):
    """Run the pair's step once on meta under a cost counter:
    (counter, abstract args, spec_fn, seconds)."""
    t0 = time.perf_counter()
    fn, args, spec_fn = build_lowerable(cfg, shape_name, num_microbatches)
    with CostCounter("meta") as counter:
        fn(*args)
    return counter, args, spec_fn, time.perf_counter() - t0


def _records_from_trace(cfg, shape_name: str, counter: CostCounter, args,
                        spec_fn, trace_s: float, mesh_names, rules, tag
                        ) -> List[Dict]:
    seq, batch, kind = specs_mod.SHAPES[shape_name]
    tot = counter.totals()
    hw = Hardware()
    unsharded = argument_bytes(args)
    peak_one = unsharded + tot["peak_live_bytes"]
    mf = model_flops(cfg, seq, batch, kind)
    pol = specs_mod.policy_for(cfg)
    kernels = {k.split(":", 1)[1]: v for k, v in counter.by_op().items()
               if k.startswith("kernel:")}
    out = []
    for mesh_name in mesh_names:
        mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
        n_dev = mesh.size
        sharding.reset_rules()
        try:
            if pol.rules:
                sharding.set_rules(**pol.rules)
            if rules:
                sharding.set_rules(**rules)
            arg_bytes = argument_bytes(args, spec_fn(mesh), mesh)
        finally:
            sharding.reset_rules()
        rl = Roofline(flops_per_device=tot["flops"] / n_dev,
                      bytes_per_device=tot["bytes"] / n_dev,
                      collective_per_device=None, num_devices=n_dev, hw=hw)
        out.append({
            "arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
            "tag": tag, "status": "ok", "reason": "",
            "num_devices": n_dev,
            "trace_s": trace_s,
            "traced_ops": tot["ops"],
            "memory": {
                "argument_bytes": arg_bytes,
                "argument_bytes_unsharded": unsharded,
                "temp_bytes": None,
                "temp_bytes_reason": NO_PARTITION,
            },
            "trace_peak_live_bytes": tot["peak_live_bytes"],
            "peak_bytes_one_card": peak_one,
            "fits_one_card": peak_one <= hw.hbm_bytes,
            "roofline": rl.as_dict(),
            "collective_reason": NO_PARTITION,
            "model_flops_total": mf,
            "traced_flops_total": tot["flops"],
            "traced_bytes_total": tot["bytes"],
            "useful_flops_ratio": mf / tot["flops"] if tot["flops"] else None,
            "kernels": kernels,
            "analytic": analytic_terms(cfg, seq, batch, kind, n_dev,
                                       optimizer=pol.optimizer),
        })
    return out


def run_pair(arch: str, shape_name: str,
             mesh_names: Sequence[str] = ("single", "multi"),
             rules: Optional[dict] = None, tag: str = "",
             num_microbatches: int = 0) -> List[Dict]:
    """One trace of the pair, one record per mesh (a skipped or failed
    pair gives a skip or error record per mesh)."""
    cfg = get_config(arch)
    ok, reason = specs_mod.should_run(cfg, shape_name)
    base = [{"arch": cfg.name, "shape": shape_name, "mesh": m, "tag": tag,
             "status": "skip", "reason": reason} for m in mesh_names]
    if not ok:
        return base
    try:
        counter, args, spec_fn, secs = trace(cfg, shape_name,
                                             num_microbatches)
        return _records_from_trace(cfg, shape_name, counter, args, spec_fn,
                                   secs, mesh_names, rules, tag)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        err = {"status": "error", "reason": "",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        return [dict(r, **err) for r in base]


def train_peak(cfg, batch: Dict) -> Dict:
    """The one-card memory of one train step of ``cfg`` on ``batch`` (meta
    tensors, one microbatch), with the policy's optimizer: its inputs'
    bytes, the trace's peak beyond them, their sum, and the trace's
    seconds."""
    t0 = time.perf_counter()
    opt = _opt(specs_mod.policy_for(cfg).optimizer)
    ts = lm.abstract_train_state(cfg, opt)
    step = lm.make_train_step(cfg, opt, num_microbatches=1)
    with CostCounter("meta") as counter:
        step(ts, batch)
    args = argument_bytes((ts, batch))
    peak = counter.totals()["peak_live_bytes"]
    return {"num_layers": cfg.num_layers, "argument_bytes": args,
            "trace_peak_live_bytes": peak, "peak_bytes_one_card": args + peak,
            "trace_s": time.perf_counter() - t0}


def max_depth(cfg, batch: Dict, limit_bytes: float
              ) -> Tuple[Optional[Dict], List[Dict]]:
    """The deepest cut of ``cfg`` (``num_layers`` in 1..its own) whose
    train step on ``batch`` fits ``limit_bytes`` on one card by
    :func:`train_peak`: (that depth's prediction, or None when one layer
    does not fit; every prediction made, in order).

    Depths 1 and 2 first; then, while no depth is known not to fit, the
    depth the last two fitting ones extrapolate to (the peak grows about
    linearly with depth), and bisection once one is: so a stack that fits
    whole costs three traces, and the deepest trace is never much deeper
    than the answer."""
    full = cfg.num_layers
    tried: Dict[int, Dict] = {}

    def fits(layers: int) -> bool:
        if layers not in tried:
            tried[layers] = train_peak(
                dataclasses.replace(cfg, num_layers=layers), batch)
        return tried[layers]["peak_bytes_one_card"] <= limit_bytes

    if not fits(1):
        return None, list(tried.values())
    lo, hi = 1, None            # deepest known fit, shallowest known miss
    while lo < full and (hi is None or hi - lo > 1):
        if hi is None and lo > 1:
            a = max(n for n in tried if n < lo and fits(n))
            pa = tried[a]["peak_bytes_one_card"]
            pb = tried[lo]["peak_bytes_one_card"]
            slope = (pb - pa) / (lo - a)
            guess = full if slope <= 0 else lo + int(
                (limit_bytes - pb) / slope)
        elif hi is None:
            guess = 2
        else:
            guess = (lo + hi) // 2
        guess = min(full, max(guess, lo + 1))
        if hi is not None:
            guess = min(guess, hi - 1)
        if fits(guess):
            lo = guess
        else:
            hi = guess
    return tried[lo], list(tried.values())


def result_path(results_dir: Path, arch: str, shape: str, mesh: str,
                tag: str = "") -> Path:
    sfx = f"_{tag}" if tag else ""
    return Path(results_dir) / f"{arch}_{shape}_{mesh}{sfx}.json"


def summary(rec: Dict) -> str:
    """One line of a record: the trace's totals, the memory and the
    terms."""
    if rec["status"] != "ok":
        return f"{rec['status']}: {rec.get('reason') or rec.get('error')}"
    r = rec["roofline"]
    a = rec["analytic"]
    return (f"flops {rec['traced_flops_total']:.4e} bytes "
            f"{rec['traced_bytes_total']:.4e} ({rec['traced_ops']} ops, "
            f"{rec['trace_s']:.2f} s) peak live "
            f"{rec['trace_peak_live_bytes'] / 2**30:.2f} GiB, one card "
            f"{rec['peak_bytes_one_card'] / 2**30:.2f} GiB; args "
            f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB/dev on "
            f"{rec['num_devices']}; terms (s) c={r['compute_term_s']:.3e} "
            f"m={r['memory_term_s']:.3e} dom={r['dominant']}; analytic "
            f"c={a['analytic_compute_term_s']:.3e} "
            f"m={a['analytic_memory_term_s']:.3e}")


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=ARCH_IDS)
    ap.add_argument("--shape", nargs="*", default=list(specs_mod.SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rules", default="",
                    help="JSON dict of sharding-rule overrides")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="override the arch policy's grad-accum count")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.results_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    rules = json.loads(args.rules) if args.rules else None
    records = []
    for arch in args.arch:
        name = get_config(arch).name
        for shape in args.shape:
            paths = {m: result_path(out_dir, name, shape, m, args.tag)
                     for m in meshes}
            todo = [m for m in meshes if args.force or not paths[m].exists()]
            for m in meshes:
                if m not in todo:
                    rec = json.loads(paths[m].read_text())
                    records.append(rec)
                    print(f"[cached] {name} {shape} {m}: {rec['status']}")
            if not todo:
                continue
            print(f"[run] {name} {shape} {'+'.join(todo)} ...", flush=True)
            for rec in run_pair(arch, shape, todo, rules=rules, tag=args.tag,
                                num_microbatches=args.microbatches):
                paths[rec["mesh"]].write_text(json.dumps(rec, indent=1))
                records.append(rec)
                print(f"  {rec['mesh']}: {summary(rec)}", flush=True)
    return records


if __name__ == "__main__":
    main()
