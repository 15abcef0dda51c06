"""KV-page migration for disaggregated prefill/decode serving and drain by
migration.

``wire``: versioned, chunked, checksummed serialization of paged-KV state
(the JAX package's format, byte for byte); ``migrate``: the sender/receiver
protocol over the bus (with a direct worker-to-worker HTTP path for large
transfers) plus the migration metrics. The engine-side export/import lives
on ``InferenceEngine`` (export_prefix_pages / import_prefix_pages); the
control flow (handoff, fallback, drain) in worker/service.py.
"""

from gridllm_torch.transfer.migrate import (
    KVImportManager,
    ack_key,
    kvx_channel,
    kvx_settings,
    ready_key,
    recv_key,
    send_kv,
)
from gridllm_torch.transfer.wire import (
    WIRE_VERSION,
    Assembler,
    WireError,
    build_header,
    iter_chunks,
)

__all__ = [
    "KVImportManager",
    "Assembler",
    "WireError",
    "WIRE_VERSION",
    "ack_key",
    "build_header",
    "iter_chunks",
    "kvx_channel",
    "kvx_settings",
    "ready_key",
    "recv_key",
    "send_kv",
]
