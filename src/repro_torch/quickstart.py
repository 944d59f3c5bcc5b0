"""Quickstart: FedDD on a synthetic MNIST-like task, then FedAvg.

    PYTHONPATH=src python -m repro_torch.quickstart [--rounds N] \
        [--clients N] [--a-server A] [--loop] \
        [--codec dense|bitmask|index|auto] [--qbits 32|16|8] \
        [--fault-rate R] [--quorum Q] [--cells K] [--robust-agg SPEC] \
        [--checkpoint-dir DIR] [--resume] [--mesh N] \
        [--population N] [--cohort K] \
        [--availability always|bernoulli|diurnal] \
        [--log-jsonl PATH] [--trace] [--device D]

The port's twin of ``examples/quickstart.py``: the paper's MLP from
``PRNGKey(0)`` across ``--clients`` non-IID clients (3 classes each),
A_server ``--a-server`` (0.6), h = 5, lr 0.1, uploads in the wire format
``--codec``/``--qbits`` (8: int8 stochastic rounding of the aggregated
values), then FedAvg with full uploads on the same data and telemetry.

* ``--loop`` runs FedDD through the per-client reference loop instead of
  the batched engine; ``--mesh N`` shards its client axis over a mesh of
  up to N of the visible devices (clamped: one on the CPU or on a
  one-card machine; the engine only, so not with ``--loop``).
* ``--fault-rate R`` routes FedDD through the event-driven simulator
  (``repro_torch.sim``): clients crash at R/2, lose uplink chunks at R
  (retransmitted and charged) and ship corrupted payloads at R/4, which
  the server's screen quarantines; below ``--quorum`` survivors a round
  is skipped and the global model held.  ``--cells K`` groups the
  clients into K cells, each a two-state Markov outage chain that
  crashes all its members at once (with or without ``--fault-rate``).
* ``--robust-agg trimmed[:beta]`` or ``clip[:factor]`` replaces the
  Eq. (4) weighted mean by a Byzantine-robust variant.
* ``--checkpoint-dir DIR`` snapshots the whole FedDD run state to
  ``DIR/run_state.npz`` every round; ``--resume`` continues from it, and
  the continued run equals an uninterrupted one bit for bit::

      PYTHONPATH=src python -m repro_torch.quickstart --rounds 10 \\
          --fault-rate 0.2 --cells 3 --checkpoint-dir results/ckpt
      # ... killed mid-run ...
      PYTHONPATH=src python -m repro_torch.quickstart --rounds 10 \\
          --fault-rate 0.2 --cells 3 --checkpoint-dir results/ckpt --resume

* ``--population N`` serves an N-client population
  (``repro_torch.population``) instead of the fleet: client ``g`` trains
  on data shard ``g % --clients`` and takes its sample count and label
  coverage; ``--cohort K`` of them (default: all N) are served a round,
  drawn uniformly from those ``--availability`` puts online.  FedAvg
  serves a fresh population of its own::

      PYTHONPATH=src python -m repro_torch.quickstart --rounds 10 \\
          --clients 32 --population 100000 --cohort 256 \\
          --availability bernoulli

* ``--log-jsonl PATH`` writes the FedDD run's JSONL log (inspect it with
  ``python -m repro_torch.obs.report PATH``) and ``--trace`` wraps its
  spans in ``torch.profiler.record_function``.

FedAvg takes the population flags only: no faults, no robust
aggregation, no checkpoint.  Runs on ``cuda`` unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch import prng, sim
from repro_torch.comm import CommConfig
from repro_torch.core.allocation import ClientTelemetry
from repro_torch.obs import ObsConfig
from repro_torch.core.protocol import RunResult, run_scheme
from repro_torch.core.selection import SelectionConfig
from repro_torch.data import (label_coverage_score, make_dataset,
                              partition_noniid_b)
from repro_torch.device import DeviceLike
from repro_torch.fl import (MLP_SPEC, init_cnn_spec, make_eval_fn,
                            make_local_train_fn, model_bytes,
                            sample_system_telemetry)
from repro_torch.population import Population

FEDDD_H = 5     # full-broadcast period h of the FedDD run (Table 4)
CHECKPOINT_FILE = "run_state.npz"


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


def check_flags(*, cohort: Optional[int] = None,
                population: Optional[int] = None, resume: bool = False,
                checkpoint_dir: Optional[str] = None) -> None:
    """The reference's argument errors, as ValueError."""
    if cohort is not None and population is None:
        raise ValueError("--cohort requires --population")
    if resume and not checkpoint_dir:
        raise ValueError("--resume requires --checkpoint-dir")
    if resume:
        ckpt = Path(checkpoint_dir) / CHECKPOINT_FILE
        if not ckpt.exists():
            raise ValueError(f"--resume: no checkpoint at {ckpt}")


@dataclasses.dataclass
class Scheme:
    """What the flags make of the quickstart's fleet: the telemetry and
    trainer both runs take, and FedDD's ``run_scheme`` keyword arguments
    beyond the quickstart's own."""
    telemetry: ClientTelemetry
    local_train_fn: Callable
    feddd: Dict
    make_population: Optional[Callable] = None
    cohort: Optional[int] = None

    def fedavg(self) -> Dict:
        """FedAvg's keyword arguments: the population's only, with a
        fresh store (its sticky state is the run's own)."""
        if self.make_population is None:
            return {}
        return dict(population=self.make_population(),
                    cohort_size=self.cohort)


def scheme_kwargs(telemetry: ClientTelemetry, local_train_fn: Callable, *,
                  fault_rate: float = 0.0, quorum: int = 1, cells: int = 0,
                  robust_agg: str = "mean",
                  checkpoint_dir: Optional[str] = None, resume: bool = False,
                  population: Optional[int] = None,
                  cohort: Optional[int] = None,
                  availability: str = "always") -> Scheme:
    """Map the quickstart's fault, outage, robust-aggregation,
    crash-resume and population flags onto ``run_scheme``'s arguments,
    as ``examples/quickstart.py`` builds them.  ``telemetry`` and
    ``local_train_fn`` are the fleet's (one client a data shard); the
    defaults leave them and the run as they are."""
    check_flags(cohort=cohort, population=population, resume=resume,
                checkpoint_dir=checkpoint_dir)
    shards = telemetry.num_clients
    feddd: Dict = {}
    faults = None
    if fault_rate > 0.0:
        faults = sim.RandomFaults(sim.FaultConfig(
            crash_rate=fault_rate / 2, loss_rate=fault_rate,
            corrupt_rate=fault_rate / 4, quorum=quorum, seed=0))
    if cells > 0:
        faults = sim.CellOutageModel(
            shards, sim.OutageConfig(cells=cells, p_out=0.15, p_back=0.5,
                                     seed=0), inner=faults)
    if faults is not None:
        feddd["faults"] = faults
    if robust_agg != "mean":
        feddd["robust_agg"] = robust_agg
    if checkpoint_dir:
        ckpt = str(Path(checkpoint_dir) / CHECKPOINT_FILE)
        feddd.update(checkpoint_every=1, checkpoint_path=ckpt)
        if resume:
            feddd["resume_from"] = ckpt
    out = Scheme(telemetry, local_train_fn, feddd)
    if population is None:
        return out
    # client g takes data shard g % shards: its sample count and Eq. (13)
    # coverage, read once a shard from the fleet's telemetry
    shard = np.arange(population) % shards
    out.telemetry = tel = sample_system_telemetry(
        population, [float(telemetry.model_bytes[0])] * population,
        np.asarray(telemetry.num_samples)[shard],
        np.asarray(telemetry.label_coverage)[shard], seed=0)

    def shard_train_fn(p, gid, key):
        return local_train_fn(p, int(gid) % shards, key)

    out.local_train_fn = shard_train_fn
    out.make_population = lambda: Population(
        tel, availability=availability, sampler="uniform", seed=0)
    out.cohort = cohort
    feddd.update(out.fedavg())
    return out


def run(rounds: int = 10, *, fedavg_rounds: Optional[int] = None,
        clients: int = 10, a_server: float = 0.6,
        comm: CommConfig = CommConfig(), selection: str = "feddd",
        batched: bool = True, track_epsilon: bool = False,
        obs: ObsConfig = ObsConfig(), device: DeviceLike = None,
        mesh=None, fault_rate: float = 0.0, quorum: int = 1, cells: int = 0,
        robust_agg: str = "mean", checkpoint_dir: Optional[str] = None,
        resume: bool = False, population: Optional[int] = None,
        cohort: Optional[int] = None, availability: str = "always",
        on_start: Optional[Callable] = None,
        on_round: Optional[Callable] = None
        ) -> Tuple[RunResult, Optional[RunResult], object]:
    """FedDD for ``rounds`` rounds in the wire format ``comm`` with the
    channel selection ``selection`` (the paper's "feddd" importance, or an
    ablation such as "random"), on the batched engine or (``batched=False``
    or ``track_epsilon``) the per-client loop, recorded by ``obs``, over
    the client mesh ``mesh`` (``ProtocolConfig.mesh``) if one is given,
    under the faults, aggregation, checkpoints and population of the
    matching flags (:func:`scheme_kwargs`); then FedAvg for
    ``fedavg_rounds`` (default: as many; 0: none, and None in its place)
    with full uploads.  ``on_start(scheme)`` is called before each run
    and ``on_round(scheme, record)`` sees every round once its run has
    finished.  Returns (feddd, fedavg, telemetry)."""
    params, tel, ltf, ef = setup(clients, device)
    sk = scheme_kwargs(tel, ltf, fault_rate=fault_rate, quorum=quorum,
                       cells=cells, robust_agg=robust_agg,
                       checkpoint_dir=checkpoint_dir, resume=resume,
                       population=population, cohort=cohort,
                       availability=availability)
    results = []
    n_avg = rounds if fedavg_rounds is None else fedavg_rounds
    for scheme, n_rounds, kw in (
            ("feddd", rounds, dict(a_server=a_server, h=FEDDD_H, comm=comm,
                                   selection=SelectionConfig(selection),
                                   batched=batched,
                                   track_epsilon=track_epsilon, obs=obs,
                                   mesh=mesh, **sk.feddd)),
            ("fedavg", n_avg, sk.fedavg())):
        if not n_rounds:
            results.append(None)
            continue
        if on_start is not None:
            on_start(scheme)
        res = run_scheme(scheme, params, sk.telemetry, sk.local_train_fn, ef,
                         rounds=n_rounds, device=device, **kw)
        if on_round is not None:
            for rec in res.history:
                on_round(scheme, rec)
        results.append(res)
    return results[0], results[1], sk.telemetry


def _print_round(scheme: str, r, fault_col: str = "") -> None:
    print(f"  {scheme:6s} round {r.round:2d}  "
          f"acc={r.metrics['accuracy']:.3f}  loss={r.mean_loss:.4f}  "
          f"sim_t={r.sim_time:8.1f}s  uploaded={r.uploaded_fraction:.0%}  "
          f"wire={r.wire_bytes / 1e3:.0f}kB  host={r.host_wall_time:.3f}s"
          f"{fault_col}", flush=True)


def main(argv=None) -> Tuple[RunResult, Optional[RunResult]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--a-server", type=float, default=0.6)
    ap.add_argument("--loop", action="store_true",
                    help="run FedDD through the per-client reference loop "
                         "instead of the batched round engine")
    ap.add_argument("--codec", default="dense",
                    choices=("dense", "bitmask", "index", "auto"),
                    help="upload mask wire codec; dense is the analytic "
                         "idealization")
    ap.add_argument("--qbits", type=int, default=32, choices=(32, 16, 8),
                    help="uploaded-value precision (8 = int8 stochastic "
                         "rounding)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="inject faults at this rate (crashes at rate/2, "
                         "lossy uplink chunks at rate, corrupted payloads "
                         "at rate/4); 0 keeps the closed-form driver")
    ap.add_argument("--quorum", type=int, default=1,
                    help="minimum surviving contributors per round; below "
                         "it the server skips the round (fault runs only)")
    ap.add_argument("--cells", type=int, default=0, metavar="K",
                    help="group clients into K correlated-failure cells, "
                         "each driven by a two-state Markov outage chain; "
                         "composes with --fault-rate and routes through "
                         "the simulator like it")
    ap.add_argument("--robust-agg", default="mean", metavar="SPEC",
                    help="Eq. (4) aggregation variant: 'mean' (default), "
                         "'trimmed[:beta]' (coordinate-wise trimmed mean) "
                         "or 'clip[:factor]' (per-client norm clipping)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="snapshot the full run state to DIR/"
                         f"{CHECKPOINT_FILE} every round (atomic writes)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the --checkpoint-dir snapshot; the "
                         "continued run is bit-identical to an "
                         "uninterrupted one")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard FedDD's client axis over a mesh of up to N "
                         "visible devices (the engine only)")
    ap.add_argument("--population", type=int, default=None, metavar="N",
                    help="serve an N-client population instead of a fixed "
                         "fleet; data is sharded by global id (id %% "
                         "--clients)")
    ap.add_argument("--cohort", type=int, default=None, metavar="K",
                    help="clients served per round in population mode "
                         "(default: the whole population)")
    ap.add_argument("--availability", default="always",
                    choices=("always", "bernoulli", "diurnal"),
                    help="who is online each round in population mode")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="write the FedDD run's JSONL log here; inspect "
                         "with `python -m repro_torch.obs.report PATH`")
    ap.add_argument("--trace", action="store_true",
                    help="wrap host spans in torch.profiler.record_function "
                         "(implies observability on)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    flags = dict(cohort=args.cohort, population=args.population,
                 resume=args.resume, checkpoint_dir=args.checkpoint_dir)
    try:
        check_flags(**flags)
    except ValueError as e:
        ap.error(str(e))
    engine = "per-client loop" if args.loop else "batched round engine"
    if args.mesh is not None:
        if args.loop:
            ap.error("--mesh requires the batched engine (drop --loop)")
        engine = f"sharded round engine ({args.mesh}-device mesh)"
    obs = ObsConfig()
    if args.log_jsonl or args.trace:
        if args.log_jsonl:
            Path(args.log_jsonl).parent.mkdir(parents=True, exist_ok=True)
        obs = ObsConfig(enabled=True, jsonl_path=args.log_jsonl,
                        trace=args.trace)
    faulty = args.fault_rate > 0.0 or args.cells > 0
    fleet_n = args.clients
    if args.population is not None:
        fleet_n = args.population if args.cohort is None else args.cohort
    pop_col = (f", population={args.population}/cohort={fleet_n}"
               f"/{args.availability}" if args.population else "")

    def on_start(scheme: str) -> None:
        if scheme == "fedavg":
            print("== FedAvg (full uploads) ==", flush=True)
        elif faulty:
            cells_col = f", cells={args.cells}" if args.cells else ""
            print(f"== FedDD + faults (rate={args.fault_rate}, "
                  f"quorum={args.quorum}{cells_col}, "
                  f"agg={args.robust_agg}{pop_col}) ==", flush=True)
        else:
            print(f"== FedDD (A_server={args.a_server}, {engine}, "
                  f"codec={args.codec}/q{args.qbits}, "
                  f"agg={args.robust_agg}{pop_col}) ==", flush=True)

    def on_round(scheme: str, r) -> None:
        fault_col = ""
        if faulty and scheme == "feddd":
            fault_col = (" SKIPPED" if r.skipped else
                         f"  surv={r.survivors}/{fleet_n}")
        _print_round(scheme, r, fault_col)

    feddd, fedavg, _ = run(args.rounds, clients=args.clients,
                           a_server=args.a_server,
                           comm=CommConfig(codec=args.codec,
                                           qbits=args.qbits),
                           batched=not args.loop, obs=obs,
                           device=args.device, mesh=args.mesh,
                           fault_rate=args.fault_rate, quorum=args.quorum,
                           cells=args.cells, robust_agg=args.robust_agg,
                           availability=args.availability,
                           on_start=on_start, on_round=on_round, **flags)
    if args.log_jsonl:
        print(f"  run log -> {args.log_jsonl}  (inspect: python -m "
              f"repro_torch.obs.report {args.log_jsonl})")
    tgt = 0.9
    t_dd, t_avg = (x.time_to_accuracy(tgt) for x in (feddd, fedavg))
    if t_dd and t_avg:
        print(f"\nTime to {tgt:.0%} accuracy: FedDD {t_dd:.0f}s vs "
              f"FedAvg {t_avg:.0f}s  ({1 - t_dd / t_avg:.0%} reduction)")
    return feddd, fedavg


if __name__ == "__main__":
    main()
