"""The Eq. (12) round clock and the FedAvg baseline selector (§6.2).

FedCS and Oort selection are not ported yet (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.allocation import ClientTelemetry


def round_times(tel: ClientTelemetry, dropout: Optional[np.ndarray] = None,
                *, uplink_bytes: Optional[np.ndarray] = None) -> np.ndarray:
    """t_n = t_cmp + U(1-D)/r_u + U(1-D)/r_d (Eq. (12) summand).

    ``uplink_bytes`` replaces the uplink leg's idealized ``U(1-D)`` with
    the codec's on-wire bytes (:mod:`repro_torch.comm`); the downlink
    broadcast stays idealized."""
    d = np.zeros(tel.num_clients) if dropout is None else dropout
    u_eff = tel.model_bytes * (1.0 - d)
    up = u_eff if uplink_bytes is None else np.asarray(uplink_bytes)
    return (tel.compute_latency
            + up / tel.uplink_rate
            + u_eff / tel.downlink_rate)


def select_fedavg(tel: ClientTelemetry) -> np.ndarray:
    """FedAvg: every client uploads its full model."""
    return np.ones(tel.num_clients, bool)
