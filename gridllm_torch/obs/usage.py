"""Per-request usage attribution, the worker's half (the JAX package's
obs/usage.py without the owning shard's ledger and the gateway's tenant
resolution).

The worker builds a usage payload at a generation's finish
(`build_usage`), ships it in the JobResult, and once both result publishes
succeeded folds it into the process-global ``gridllm_usage_engine_*``
counters (`account_engine_usage`): the engine half of the exactly-once
ledger whose shard half sums the same payloads per tenant.
"""

from __future__ import annotations

from typing import Any, Mapping

from .metrics import default_registry

ANONYMOUS_TENANT = "anonymous"
# Reserved tenant for canary probes: synthetic health traffic
# is excluded from BOTH halves of the conservation ledger (worker skips
# account_engine_usage, the shard's account() early-returns) and from SLO
# attainment — billing and burn rates only ever describe real demand.
CANARY_TENANT = "canary"

# usage-payload token kinds and resource kinds (wire keys -> label values)
TOKEN_KINDS = {
    "promptTokens": "prompt",
    "outputTokens": "output",
    "prefixSavedTokens": "prefix_saved",
    "specWastedTokens": "spec_wasted",
}
RESOURCE_KINDS = {
    "decodeDeviceSeconds": "decode_device",
    "kvPageSeconds": "kv_page",
}


def build_usage(
    *,
    tenant: str,
    model: str,
    prompt_tokens: int,
    output_tokens: int,
    prefix_saved_tokens: int = 0,
    spec_wasted_tokens: int = 0,
    decode_device_s: float = 0.0,
    kv_page_s: float = 0.0,
    migrated_bytes: int = 0,
) -> dict[str, Any]:
    """Assemble the wire-format usage payload a worker folds into its
    ``JobResult`` (camelCase keys, like the rest of the job envelope)."""
    return {
        "tenant": tenant or ANONYMOUS_TENANT,
        "model": model,
        "promptTokens": int(prompt_tokens),
        "outputTokens": int(output_tokens),
        "prefixSavedTokens": int(prefix_saved_tokens),
        "specWastedTokens": int(spec_wasted_tokens),
        "decodeDeviceSeconds": round(float(decode_device_s), 6),
        "kvPageSeconds": round(float(kv_page_s), 6),
        "migratedBytes": int(migrated_bytes),
    }


_glob = default_registry()
_ENGINE_TOKENS = _glob.counter(
    "gridllm_usage_engine_tokens_total",
    "Engine-side usage ledger: tokens attributed at request finish.",
    ("model", "kind"),
)
_ENGINE_SECONDS = _glob.counter(
    "gridllm_usage_engine_seconds_total",
    "Engine-side usage ledger: decode device-seconds and KV "
    "page-occupancy-seconds attributed at request finish.",
    ("model", "resource"),
)
_ENGINE_MIGRATED = _glob.counter(
    "gridllm_usage_engine_migrated_bytes_total",
    "Engine-side usage ledger: KV bytes imported for disagg handoffs.",
    ("model",),
)


def account_engine_usage(usage: Mapping[str, Any]) -> None:
    """Fold one published usage payload into the process-global engine
    ledger.  Call ONLY after the result publishes succeeded — an
    unpublished execution (killed worker) must stay invisible on both
    sides of the conservation invariant."""
    if str(usage.get("tenant") or "") == CANARY_TENANT:
        return  # canary probes stay invisible on BOTH ledger halves
    model = str(usage.get("model") or "unknown")
    for key, kind in TOKEN_KINDS.items():
        n = int(usage.get(key) or 0)
        if n:
            _ENGINE_TOKENS.inc(n, model=model, kind=kind)
    for key, resource in RESOURCE_KINDS.items():
        s = float(usage.get(key) or 0.0)
        if s > 0:
            _ENGINE_SECONDS.inc(s, model=model, resource=resource)
    b = int(usage.get("migratedBytes") or 0)
    if b:
        _ENGINE_MIGRATED.inc(b, model=model)


def engine_usage_totals() -> dict[str, float]:
    """Per-kind token totals of the engine-side ledger (tests diff this
    against the shard-side per-tenant sums)."""
    out: dict[str, float] = {}
    for labels, value in _ENGINE_TOKENS.items():
        kind = dict(labels).get("kind", "")
        out[kind] = out.get(kind, 0.0) + value
    return out
