"""Straggler demo: FedDD on a FADING network under three serving policies.

    PYTHONPATH=src python -m repro_torch.straggler_sim [--rounds 10] \
        [--clients 8] [--device D]

The port's twin of ``examples/straggler_sim.py``: the paper's MLP
784-100-64-10 from ``PRNGKey(0)``, synthetic MNIST 4000/1000 split over
``--clients`` non-IID clients, trained through the event-driven simulator
(:mod:`repro_torch.sim`) on a two-state Markov fading network (clients
drop into 10x slower links with probability 0.25 a round and recover with
0.5), A_server = 0.6, h = 5, under:

  sync      wait for every upload (the paper's protocol)
  deadline  semi-sync: abandon uploads missing an adaptive deadline
  async     buffered merges with staleness-decayed weights; clients
            re-dispatch immediately (no fleet barrier), for
            ``rounds * (clients // buffer)`` merges

The server never sees the true link rates: it re-solves the dropout-rate
LP each round from telemetry observed on the event timeline.  Prints each
policy's rounds and the simulated time to the target accuracy.  Runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict

from repro_torch import prng
from repro_torch.data import (label_coverage_score, make_dataset,
                              partition_noniid_b)
from repro_torch.device import DeviceLike
from repro_torch.fl import (MLP_SPEC, init_cnn_spec, make_eval_fn,
                            make_local_train_fn, model_bytes,
                            sample_system_telemetry)
from repro_torch.sim import (AsyncPolicy, MarkovFadingNetwork, SimConfig,
                             SimResult, run_sim)

POLICIES = ("sync", "deadline", "async")


def setup(clients: int = 8, device: DeviceLike = None):
    """The demo's model, telemetry, trainer and eval -> (params,
    telemetry, local_train_fn, eval_fn)."""
    train, test = make_dataset("mnist", num_train=4000, num_test=1000)
    parts = partition_noniid_b(train, clients, seed=0)
    params = init_cnn_spec(MLP_SPEC, prng.PRNGKey(0), device=device)
    tel = sample_system_telemetry(
        clients, [model_bytes(params)] * clients, [len(p) for p in parts],
        [label_coverage_score(train, p) for p in parts], seed=0)
    ltf = make_local_train_fn(MLP_SPEC, train, parts, flatten=True, lr=0.1,
                              device=device)
    ef = make_eval_fn(MLP_SPEC, test, flatten=True, device=device)
    return params, tel, ltf, ef


def network(tel) -> MarkovFadingNetwork:
    """The demo's fading network (a fresh chain for every run)."""
    return MarkovFadingNetwork(tel, p_fade=0.25, p_recover=0.5,
                               fade_factor=0.1, seed=1)


def policy_rounds(policy: str, rounds: int, clients: int) -> int:
    """Async merges ``buffer`` clients per (shorter) round: its merge count
    is scaled so every policy makes the same number of client updates."""
    buf = AsyncPolicy().resolved_buffer(clients)
    return rounds * (clients // buf) if policy == "async" else rounds


def run(rounds: int = 10, clients: int = 8, *, policies=POLICIES,
        device: DeviceLike = None, eval_every: int = 1,
        **run_kw) -> Dict[str, SimResult]:
    """Each policy's :class:`SimResult` over the same setup; ``run_kw``
    goes to ``run_sim`` (e.g. ``obs=``)."""
    params, tel, ltf, ef = setup(clients, device)
    out = {}
    for policy in policies:
        out[policy] = run_sim(
            "feddd", params, tel, ltf, ef if eval_every else None,
            sim=SimConfig(policy=policy, eval_every=max(eval_every, 1)),
            network=network(tel),
            rounds=policy_rounds(policy, rounds, clients), a_server=0.6,
            h=5, seed=0, device=device, **run_kw)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--target", type=float, default=0.85)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run(args.rounds, args.clients, device=args.device)
    for policy, res in results.items():
        print(f"== FedDD / {policy} / markov-fading ==")
        step = max(1, len(res.history) // args.rounds)
        for r in res.history[::step]:
            print(f"  round {r.round:3d}  acc={r.metrics['accuracy']:.3f}  "
                  f"sim_t={r.sim_time:8.1f}s  parts={r.participants}  "
                  f"uploaded={r.uploaded_fraction:.0%}  "
                  f"host={r.host_wall_time:.3f}s", flush=True)
    print(f"\nSimulated time to {args.target:.0%} accuracy "
          f"(fading network):")
    for policy, res in results.items():
        t = res.time_to_accuracy(args.target)
        print(f"  {policy:9s} "
              f"{'not reached' if t is None else f'{t:8.1f}s'}  "
              f"(final sim_time {res.history[-1].sim_time:.1f}s)")


if __name__ == "__main__":
    main()
