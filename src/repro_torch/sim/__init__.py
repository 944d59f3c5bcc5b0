"""Event-driven federated system simulator — the time-domain subsystem
(the JAX package's ``repro.sim``, on the port's engines and kernels).

Modules
  engine    discrete-event queue + simulated clock (deterministic order)
  network   true per-epoch client conditions: static Table-4, two-state
            Markov fading, trace-driven
  policies  server aggregation disciplines: sync wait-for-all, deadline
            semi-sync (drops late uploads), retry/timeout serving,
            buffered async with staleness-decayed weights
  faults    deterministic fault injection: client churn, lossy uplinks
            with retransmit/backoff, corrupted payloads, server-side
            validation + quorum-gated degradation
  outages   correlated cell-outage overlay: clients grouped into cells,
            each cell driven by a two-state Markov availability chain;
            outages crash whole cells at once
  runner    the driver: composes the above with the batched round engine
            and re-solves the dropout LP from OBSERVED telemetry

Population-scale serving rides the same runner: ``run_sim(...,
population=Population(tel), cohort_size=K)`` (repro_torch.population) samples
a K-client cohort per round from a large, mostly-offline population —
availability models decide who is online, cohort samplers pick the
round's fleet, and per-client sticky state (telemetry EWMAs by GLOBAL
id, losses, dropout rates, params, byte economy) survives cohort churn.
A population the size of the fleet with always-on availability is
bit-identical to a plain fleet run.

Entry points: :func:`run_sim`, or ``run_scheme(..., sim=..., network=...,
faults=..., population=...)`` in repro_torch.core.protocol.  See the routing
table in core/protocol.py for which execution path serves which
scenario.
"""

from repro_torch.sim.engine import (COMPUTE_DONE, DOWNLOAD_DONE, UPLOAD_DONE,
                              Event, EventQueue, Simulator)
from repro_torch.sim.faults import (CORRUPT_KINDS, FaultConfig, FaultModel,
                              RandomFaults, RoundFaults, ScriptedFaults,
                              ValidationConfig)
from repro_torch.sim.network import (MarkovFadingNetwork, NetworkConditions,
                               NetworkModel, StaticNetwork, TraceNetwork,
                               make_network, telemetry_with_conditions)
from repro_torch.sim.outages import CellOutageModel, OutageConfig
from repro_torch.sim.policies import (POLICIES, AsyncPolicy, DeadlinePolicy,
                                RetryPolicy, SyncPolicy, make_policy)
from repro_torch.sim.runner import (ObservedTelemetry, SimConfig, SimResult,
                              SimRunner, run_sim)
