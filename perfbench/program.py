"""The system under test: the port ``repro_torch`` driving FedDD rounds.

This module and the trainers (``perfbench/trainers/<trainer>.py``, found
by the traffic's ``trainer``) are the benchmark's only imports of the
program.  ``build`` makes a ``FedDDServer`` from the inputs
``perfbench.inputs`` made, with the traffic's FedDD settings (and any
further ``ProtocolConfig`` fields under its ``protocol`` key); rounds run
through the program's own entry, ``FedDDServer.run``.

A round ends when its ``RoundRecord`` reaches the program's
observability (``obs.Recorder.round``): its telemetry is on the host and
the LP has run.  The benchmark hears of it through the registry it hands
the program (``ObsConfig.registry``), on every path that writes records,
a scanned chunk's records included.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from perfbench import lookup

# the protocol's per-round counter (``obs.recorder.update_round_metrics``)
ROUNDS_COUNTER = "feddd_rounds_total"


@dataclasses.dataclass
class Program:
    server: object                   # repro_torch.core.protocol.FedDDServer
    run_kwargs: Dict                 # the trainer argument of server.run
    stream: object                   # the registry that hears each round

    def run(self, rounds: int, on_round: Optional[Callable[[], None]] = None):
        """``rounds`` rounds through ``FedDDServer.run``; ``on_round()`` is
        called as each round's record reaches the program's
        observability.  An exception it raises ends the run there."""
        self.stream.on_round = on_round
        try:
            return self.server.run(rounds=rounds, **self.run_kwargs)
        finally:
            self.stream.on_round = None

    def host_span_seconds(self) -> Dict[str, float]:
        """Host seconds so far in each of the program's obs spans.  The
        spans do not synchronise: ``local_train`` and ``engine_step``
        time the enqueue, and the wait for the device lands in
        ``host_transfer``."""
        return {labels["name"]: v for name, labels, v in
                self.stream.samples() if name == "feddd_span_seconds_sum"}

    def executor_kind(self) -> str:
        return self.server.executor_kind

    def state(self):
        """(global params, client params) as the server holds them at the
        end of a round."""
        return (self.server.global_params,
                [cs.params for cs in self.server.clients])


def _round_stream():
    from repro_torch.obs import MetricsRegistry

    class RoundStream(MetricsRegistry):
        """A metrics registry that calls ``on_round`` on each round."""
        on_round: Optional[Callable[[], None]] = None

        def inc(self, name, value=1.0, /, **labels):
            super().inc(name, value, **labels)
            if name == ROUNDS_COUNTER and self.on_round is not None:
                self.on_round()

    return RoundStream()


def build(cfg: Dict, traffic: Dict, inputs, trace_jsonl: Optional[str]
          = None) -> Program:
    """The server and trainer of a cell; ``trace_jsonl``: a traced run,
    whose spans become ``torch.profiler`` ranges and a JSONL log there."""
    from repro_torch.core.allocation import ClientTelemetry
    from repro_torch.core.protocol import FedDDServer, ProtocolConfig
    from repro_torch.obs import ObsConfig

    stream = _round_stream()
    obs = (ObsConfig(registry=stream) if trace_jsonl is None else
           ObsConfig(trace=True, jsonl_path=trace_jsonl, registry=stream))
    tel = ClientTelemetry(**{k: np.array(v) for k, v in
                             inputs.telemetry.items()})
    pcfg = ProtocolConfig(
        scheme="feddd", rounds=traffic["check_rounds"],
        a_server=traffic["a_server"], d_max=traffic["d_max"],
        h=traffic["h"], seed=inputs.protocol_seed,
        allocator=traffic["allocator"], obs=obs,
        **traffic.get("protocol", {}))
    shared = all(p is inputs.global_params for p in inputs.client_params)
    server = FedDDServer(inputs.global_params, pcfg, tel,
                         client_params=None if shared
                         else inputs.client_params,
                         device=inputs.x.device)
    kwargs = lookup.module("trainers", traffic["trainer"]).build(
        cfg, traffic, inputs)
    return Program(server, kwargs, stream)


def read_spans(jsonl_path: str):
    """The span events of the program's JSONL log."""
    from repro_torch.obs import read_events
    return [e for e in read_events(jsonl_path) if e.get("event") == "span"]
