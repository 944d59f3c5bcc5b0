"""Wire formats — what a FedDD upload costs on the wire (the port's copy of
``repro.comm``).

  codecs     mask encodings per leaf (packed bitmask, delta+varint index,
             the dense idealization, auto) with exact int32 byte formulas
  quantize   value codecs: fp32, fp16, int8 with threefry-keyed
             stochastic rounding
  payload    CommConfig / WireSpec, per-client encode_upload /
             decode_upload, and the byte accounting every driver charges
             through

Routing: ``ProtocolConfig(comm=CommConfig(codec=..., qbits=...))``.  The
default (dense, 32) is the analytic accounting: ``wire_bytes ==
uploaded_bytes`` and the Eq. (12) clock is unchanged.  Sparse codecs add
the measured mask overhead to ``wire_bytes`` and charge the codec's
analytic bytes on the clock's uplink leg; ``qbits < 32`` quantizes the
values the server aggregates.
"""

from repro_torch.comm.codecs import (AUTO_TAG_BYTES, CODECS, HEADER_BYTES,
                                     bitmask_bytes, decode_mask, encode_mask,
                                     index_bytes, mask_overhead_bytes,
                                     mask_overhead_bytes_stacked,
                                     varint_bytes)
from repro_torch.comm.payload import (CommConfig, UploadPayload, WireSpec,
                                      account_uplink, analytic_uplink_vector,
                                      analytic_wire_bytes, decode_upload,
                                      encode_upload, uplink_bytes_raw)
from repro_torch.comm.quantize import (QBITS, quantize_dequantize,
                                       quantize_dequantize_stacked,
                                       scale_bytes, value_bytes)

__all__ = ["AUTO_TAG_BYTES", "CODECS", "HEADER_BYTES", "bitmask_bytes",
           "decode_mask", "encode_mask", "index_bytes",
           "mask_overhead_bytes", "mask_overhead_bytes_stacked",
           "varint_bytes", "CommConfig", "UploadPayload", "WireSpec",
           "account_uplink", "analytic_uplink_vector", "analytic_wire_bytes",
           "decode_upload", "encode_upload", "uplink_bytes_raw", "QBITS",
           "quantize_dequantize", "quantize_dequantize_stacked",
           "scale_bytes", "value_bytes"]
