"""Quickstart: FedDD on a synthetic MNIST-like task, then FedAvg.

    PYTHONPATH=src python -m repro_torch.quickstart [--rounds N] \
        [--codec dense|bitmask|index|auto] [--qbits 32|16|8] [--loop] \
        [--mesh N] [--log-jsonl PATH] [--trace] [--device D]

The port's twin of ``examples/quickstart.py``: the paper's MLP from
``PRNGKey(0)`` across 10 non-IID clients (3 classes each), A_server =
0.6, h = 5, lr 0.1, uploads in the wire format ``--codec``/``--qbits``
(8: int8 stochastic rounding of the aggregated values), then FedAvg with
full uploads on the same data and telemetry.  ``--loop`` runs FedDD
through the per-client reference loop instead of the batched engine;
``--mesh N`` shards its client axis over a mesh of up to N of the
visible devices (clamped: one on the CPU or on a one-card machine; the
engine only, so not with ``--loop``); ``--log-jsonl`` writes the FedDD run's JSONL log (inspect it with
``python -m repro_torch.obs.report PATH``) and ``--trace`` wraps its
spans in ``torch.profiler.record_function``.  Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Optional, Tuple

from repro_torch import prng
from repro_torch.comm import CommConfig
from repro_torch.obs import ObsConfig
from repro_torch.core.protocol import RunResult, run_scheme
from repro_torch.core.selection import SelectionConfig
from repro_torch.data import (label_coverage_score, make_dataset,
                              partition_noniid_b)
from repro_torch.device import DeviceLike
from repro_torch.fl import (MLP_SPEC, init_cnn_spec, make_eval_fn,
                            make_local_train_fn, model_bytes,
                            sample_system_telemetry)

FEDDD_H = 5     # full-broadcast period h of the FedDD run (Table 4)


def setup(clients: int = 10, device: DeviceLike = None):
    """The quickstart's model, telemetry, trainer and eval: synthetic
    MNIST 6000/1500 over ``clients`` non-IID clients and the paper's MLP
    from ``PRNGKey(0)`` -> (params, telemetry, local_train_fn, eval_fn)."""
    train, test = make_dataset("mnist", num_train=6000, num_test=1500)
    parts = partition_noniid_b(train, clients, seed=0)
    params = init_cnn_spec(MLP_SPEC, prng.PRNGKey(0), device=device)
    tel = sample_system_telemetry(
        clients, [model_bytes(params)] * clients, [len(p) for p in parts],
        [label_coverage_score(train, p) for p in parts], seed=0)
    ltf = make_local_train_fn(MLP_SPEC, train, parts, flatten=True, lr=0.1,
                              device=device)
    ef = make_eval_fn(MLP_SPEC, test, flatten=True, device=device)
    return params, tel, ltf, ef


def run(rounds: int = 10, *, fedavg_rounds: Optional[int] = None,
        clients: int = 10, a_server: float = 0.6,
        comm: CommConfig = CommConfig(), selection: str = "feddd",
        batched: bool = True, track_epsilon: bool = False,
        obs: ObsConfig = ObsConfig(), device: DeviceLike = None,
        mesh=None, on_round: Optional[Callable] = None
        ) -> Tuple[RunResult, Optional[RunResult], object]:
    """FedDD for ``rounds`` rounds in the wire format ``comm`` with the
    channel selection ``selection`` (the paper's "feddd" importance, or an
    ablation such as "random"), on the batched engine or (``batched=False``
    or ``track_epsilon``) the per-client loop, recorded by ``obs``, over
    the client mesh ``mesh`` (``ProtocolConfig.mesh``) if one is given; then
    FedAvg for ``fedavg_rounds`` (default: as many; 0: none, and None in
    its place) with full uploads.  ``on_round(scheme, record)`` sees every
    round once its run has finished.  Returns (feddd, fedavg, telemetry)."""
    params, tel, ltf, ef = setup(clients, device)
    results = []
    n_avg = rounds if fedavg_rounds is None else fedavg_rounds
    for scheme, n_rounds, kw in (
            ("feddd", rounds, dict(a_server=a_server, h=FEDDD_H, comm=comm,
                                   selection=SelectionConfig(selection),
                                   batched=batched,
                                   track_epsilon=track_epsilon, obs=obs,
                                   mesh=mesh)),
            ("fedavg", n_avg, {})):
        if not n_rounds:
            results.append(None)
            continue
        res = run_scheme(scheme, params, tel, ltf, ef, rounds=n_rounds,
                         device=device, **kw)
        if on_round is not None:
            for rec in res.history:
                on_round(scheme, rec)
        results.append(res)
    return results[0], results[1], tel


def _print_round(scheme: str, r) -> None:
    print(f"  {scheme:6s} round {r.round:2d}  "
          f"acc={r.metrics['accuracy']:.3f}  loss={r.mean_loss:.4f}  "
          f"sim_t={r.sim_time:8.1f}s  uploaded={r.uploaded_fraction:.0%}  "
          f"wire={r.wire_bytes / 1e3:.0f}kB  host={r.host_wall_time:.3f}s",
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--a-server", type=float, default=0.6)
    ap.add_argument("--codec", default="dense",
                    choices=("dense", "bitmask", "index", "auto"),
                    help="upload mask wire codec; dense is the analytic "
                         "idealization")
    ap.add_argument("--qbits", type=int, default=32, choices=(32, 16, 8),
                    help="uploaded-value precision (8 = int8 stochastic "
                         "rounding)")
    ap.add_argument("--loop", action="store_true",
                    help="run FedDD through the per-client reference loop "
                         "instead of the batched round engine")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard FedDD's client axis over a mesh of up to N "
                         "visible devices (the engine only)")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="write the FedDD run's JSONL log here; inspect "
                         "with `python -m repro_torch.obs.report PATH`")
    ap.add_argument("--trace", action="store_true",
                    help="wrap host spans in torch.profiler.record_function "
                         "(implies observability on)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh is not None and args.loop:
        ap.error("--mesh requires the batched engine (drop --loop)")
    obs = ObsConfig()
    if args.log_jsonl or args.trace:
        if args.log_jsonl:
            Path(args.log_jsonl).parent.mkdir(parents=True, exist_ok=True)
        obs = ObsConfig(enabled=True, jsonl_path=args.log_jsonl,
                        trace=args.trace)
    feddd, fedavg, _ = run(args.rounds, clients=args.clients,
                           a_server=args.a_server,
                           comm=CommConfig(codec=args.codec,
                                           qbits=args.qbits),
                           batched=not args.loop, obs=obs,
                           device=args.device, mesh=args.mesh,
                           on_round=_print_round)
    if args.log_jsonl:
        print(f"  run log -> {args.log_jsonl}  (inspect: python -m "
              f"repro_torch.obs.report {args.log_jsonl})")
    tgt = 0.9
    t_dd, t_avg = (x.time_to_accuracy(tgt) for x in (feddd, fedavg))
    if t_dd and t_avg:
        print(f"\nTime to {tgt:.0%} accuracy: FedDD {t_dd:.0f}s vs "
              f"FedAvg {t_avg:.0f}s  ({1 - t_dd / t_avg:.0%} reduction)")


if __name__ == "__main__":
    main()
