from repro_torch.comm.payload import (CommConfig, account_uplink,
                                      uplink_bytes_raw)

__all__ = ["CommConfig", "account_uplink", "uplink_bytes_raw"]
