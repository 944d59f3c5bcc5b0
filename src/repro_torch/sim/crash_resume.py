"""Crash-resume demonstration: a faulty simulator run killed with SIGKILL
after a snapshot, then resumed, gives the uninterrupted run's digest.

    PYTHONPATH=src python -m repro_torch.sim.crash_resume MODE CKPT \
        [--rounds 6] [--clients 8] [--every 2] [--kill-round 5] \
        [--log PATH] [--device D]

MODE is ``full`` (an uninterrupted run), ``crash`` (checkpoints every
``--every`` rounds and sends itself SIGKILL during round ``--kill-round``,
after its snapshots of the earlier rounds) or ``resume`` (continues from
CKPT).  The run is the straggler demo's setup
(:mod:`repro_torch.straggler_sim`: the paper's MLP, synthetic MNIST,
the Markov fading network) under the sync policy with client crashes,
lossy uplinks and correlated cell outages, observability on when
``--log`` is given.  ``full`` and ``resume`` print one line, the SHA-256
of the event trace, the round records, the dropout rates and the global
parameters.  Runs on ``cuda`` unless ``--device cpu`` is given; on the
CPU one thread is used, so two processes sum in the same order.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import signal

import numpy as np
import torch

from repro_torch import tree
from repro_torch.obs import ObsConfig
from repro_torch.sim import (CellOutageModel, OutageConfig, RandomFaults,
                             SimConfig, run_sim)
from repro_torch.sim.runner import SimResult


def digest(res: SimResult) -> str:
    """SHA-256 of a run's event trace, records, rates and parameters."""
    h = hashlib.sha256()
    h.update(np.asarray([e[0] for e in res.event_trace]).tobytes())
    h.update(",".join(f"{e[1]}:{e[2]}" for e in res.event_trace).encode())
    h.update(np.asarray([[r.sim_time, r.mean_loss, r.participants,
                          r.survivors, r.retries, r.abandoned_bytes,
                          float(r.skipped)] for r in res.history]).tobytes())
    h.update(np.concatenate([np.asarray(r.dropout_rates)
                             for r in res.history]).tobytes())
    for leaf in tree.leaves(res.global_params):
        h.update(leaf.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def run(mode: str, ckpt: str, *, rounds: int = 6, clients: int = 8,
        every: int = 2, kill_round: int = 5, log=None,
        device=None) -> SimResult:
    from repro_torch import straggler_sim
    if mode not in ("full", "crash", "resume"):
        raise ValueError(f"mode must be full|crash|resume, got {mode!r}")
    params, tel, ltf, _ = straggler_sim.setup(clients, device)
    evals = []

    def eval_fn(p):      # once a round: the crash hook
        evals.append(1)
        if mode == "crash" and len(evals) == kill_round:
            os.kill(os.getpid(), signal.SIGKILL)
        return {"probe": float(p["fc2"]["b"].double().sum())}

    faults = CellOutageModel(
        clients, OutageConfig(cells=2, p_out=0.3, p_back=0.5, seed=3),
        inner=RandomFaults(crash_rate=0.15, loss_rate=0.1, seed=5))
    kw = dict(sim=SimConfig(policy="sync"), faults=faults,
              network=straggler_sim.network(tel), rounds=rounds,
              a_server=0.6, h=2, seed=0, device=device)
    if log:
        kw["obs"] = ObsConfig(enabled=True, jsonl_path=str(log))
    if mode != "full":
        kw.update(checkpoint_every=every, checkpoint_path=ckpt)
    if mode == "resume":
        kw["resume_from"] = ckpt
    return run_sim("feddd", params, tel, ltf, eval_fn, **kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("full", "crash", "resume"))
    ap.add_argument("ckpt")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--kill-round", type=int, default=5)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    res = run(args.mode, args.ckpt, rounds=args.rounds,
              clients=args.clients, every=args.every,
              kill_round=args.kill_round, log=args.log, device=args.device)
    print(digest(res), flush=True)


if __name__ == "__main__":
    main()
