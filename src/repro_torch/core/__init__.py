from repro_torch.core.allocation import (ClientTelemetry,
                                         solve_dropout_rates,
                                         solve_dropout_rates_with)
from repro_torch.core.protocol import (FedDDServer, ProtocolConfig,
                                       RoundRecord, RunResult, run_scheme)
from repro_torch.core.round_engine import BatchedRoundEngine
from repro_torch.core.selection import SelectionConfig, build_masks_batched

__all__ = ["ClientTelemetry", "solve_dropout_rates",
           "solve_dropout_rates_with", "FedDDServer", "ProtocolConfig",
           "RoundRecord", "RunResult", "run_scheme", "BatchedRoundEngine",
           "SelectionConfig", "build_masks_batched"]
