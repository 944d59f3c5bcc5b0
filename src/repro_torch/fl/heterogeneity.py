"""System-heterogeneity sampler — the paper's Table 4 simulation settings.

  r_u  ~ U[1, 5]  x 10^4 bit/s        uplink
  r_d  ~ U[4, 20] x 10^4 bit/s        downlink
  f_n  ~ U[1, 10] GHz                 CPU frequency
  c_n  ~ U[1, 10] Megacycles/sample   per-sample cycles

t_cmp = c_n * b_n / f_n  (Eq. (7)) with b_n = the client's shard size x
local epochs.  Same draws as ``repro.fl.heterogeneity`` for the same seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.allocation import ClientTelemetry


def sample_system_telemetry(
    num_clients: int,
    model_bytes: Sequence[float],
    num_samples: Sequence[int],
    label_coverage: Sequence[float],
    *,
    local_epochs: int = 1,
    seed: int = 0,
    initial_loss: float = 1.0,
) -> ClientTelemetry:
    rng = np.random.default_rng(seed)
    n = num_clients
    bits_u = rng.uniform(1e4, 5e4, n)            # bit/s (Table 4)
    bits_d = rng.uniform(4e4, 2e5, n)
    f_ghz = rng.uniform(1, 10, n)                # GHz
    c_mc = rng.uniform(1, 10, n)                 # Megacycles/sample
    samples = np.asarray(num_samples, float)
    t_cmp = c_mc * 1e6 * samples * local_epochs / (f_ghz * 1e9)
    return ClientTelemetry(
        model_bytes=np.asarray(model_bytes, float),
        uplink_rate=bits_u / 8.0,                # bytes/s
        downlink_rate=bits_d / 8.0,
        compute_latency=t_cmp,
        num_samples=samples,
        label_coverage=np.asarray(label_coverage, float),
        train_loss=np.full(n, initial_loss),
    )
