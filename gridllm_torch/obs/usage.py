"""Per-tenant / per-model usage attribution.

Two halves of one exactly-once ledger:

* **Engine/worker half** — process-global ``gridllm_usage_engine_*``
  counters, incremented by the worker at the moment a ``job:result``
  with a usage payload has been published.  These are the conservation
  anchor: whatever the engine actually spent, keyed by model only.
* **Shard half** — per-scheduler ``gridllm_usage_*`` counters with a
  ``tenant`` label, incremented by the *owning* shard when it folds a
  result's usage payload into its ledger.  Every published usage
  payload is accounted exactly once (normal completion, the orphan-race
  branch, and duplicate executions under an explicit ``duplicate``
  outcome), so per-tenant sums equal the engine counters.

Tenant ids come from the configured header (``GRIDLLM_TENANT_HEADER``)
or a truncated hash of the Authorization bearer; cardinality is bounded
at label time by :class:`TenantLRU` (``GRIDLLM_TENANT_LRU``) with an
``other`` overflow bucket, which is why ``tenant``-labeled series are
registered in this module alone.
"""

from __future__ import annotations

import hashlib
import re
import threading
from collections import OrderedDict
from typing import Any, Mapping

from gridllm_torch.utils.config import env_int, env_str

from .metrics import MetricsRegistry, default_registry

ANONYMOUS_TENANT = "anonymous"
OVERFLOW_TENANT = "other"
# Reserved tenant for canary probes: synthetic health traffic
# is excluded from BOTH halves of the conservation ledger (worker skips
# account_engine_usage, the shard's account() early-returns) and from SLO
# attainment — billing and burn rates only ever describe real demand.
CANARY_TENANT = "canary"

_TENANT_RE = re.compile(r"[^a-zA-Z0-9_.:-]+")

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


def resolve_tenant(headers: Mapping[str, str]) -> str:
    """Resolve a tenant id from request headers: the configured tenant
    header verbatim (sanitized), else a truncated digest of the
    Authorization value, else ``anonymous``."""
    name = env_str("GRIDLLM_TENANT_HEADER")
    raw = headers.get(name) or headers.get(name.lower()) or ""
    raw = raw.strip()
    if raw:
        return _TENANT_RE.sub("_", raw)[:64]
    auth = (headers.get("Authorization") or headers.get("authorization") or "").strip()
    if auth:
        digest = hashlib.sha256(auth.encode("utf-8", "replace")).hexdigest()[:12]
        return f"key-{digest}"
    return ANONYMOUS_TENANT


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


class TenantLRU:
    """Bounded tenant-label vocabulary: the most recently seen ``cap``
    tenants keep their own label; everything else folds into ``other``.
    The registry cannot see cardinality at runtime — this is the one
    place it is enforced."""

    def __init__(self, cap: int | None = None) -> None:
        self.cap = int(cap if cap is not None else env_int("GRIDLLM_TENANT_LRU"))
        self._seen: OrderedDict[str, None] = OrderedDict()
        self._lock = threading.Lock()

    def label(self, tenant: str) -> str:
        t = tenant or ANONYMOUS_TENANT
        with self._lock:
            if t in self._seen:
                self._seen.move_to_end(t)
                return t
            if len(self._seen) < self.cap:
                self._seen[t] = None
                return t
        return OVERFLOW_TENANT


# ---------------------------------------------------------------- engine half

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


# ----------------------------------------------------------------- shard half


class UsageAccountant:
    """Owning-shard usage ledger: per-tenant/per-model counters on the
    scheduler's instance registry, tenant cardinality bounded by
    :class:`TenantLRU`."""

    def __init__(self, metrics: MetricsRegistry, lru_cap: int | None = None) -> None:
        self.lru = TenantLRU(lru_cap)
        self.tokens = metrics.counter(
            "gridllm_usage_tokens_total",
            "Shard usage ledger: tokens accounted exactly once by the "
            "owning shard, attributed to tenant and model.",
            ("tenant", "model", "kind"),
        )
        self.requests = metrics.counter(
            "gridllm_usage_requests_total",
            "Shard usage ledger: terminal request outcomes per tenant "
            "and model.",
            ("tenant", "model", "outcome"),
        )
        self.seconds = metrics.counter(
            "gridllm_usage_seconds_total",
            "Shard usage ledger: decode device-seconds and KV "
            "page-occupancy-seconds per tenant and model.",
            ("tenant", "model", "resource"),
        )
        self.migrated = metrics.counter(
            "gridllm_usage_migrated_bytes_total",
            "Shard usage ledger: disagg KV bytes migrated per tenant "
            "and model.",
            ("tenant", "model"),
        )

    def account(self, usage: Mapping[str, Any] | None, outcome: str) -> None:
        """Fold one result's usage payload into the ledger.  ``outcome``
        is ``completed`` for the job that resolved the request and
        ``duplicate`` for a redundant at-least-once execution — the
        engine really spent those tokens, so conservation demands they
        land somewhere."""
        if not usage:
            return
        if str(usage.get("tenant") or "") == CANARY_TENANT:
            return  # mirrors the engine half's exclusion exactly
        tenant = self.lru.label(str(usage.get("tenant") or ANONYMOUS_TENANT))
        model = str(usage.get("model") or "unknown")
        self.requests.inc(1, tenant=tenant, model=model, outcome=outcome)
        for key, kind in TOKEN_KINDS.items():
            n = int(usage.get(key) or 0)
            if n:
                self.tokens.inc(n, tenant=tenant, model=model, kind=kind)
        for key, resource in RESOURCE_KINDS.items():
            s = float(usage.get(key) or 0.0)
            if s > 0:
                self.seconds.inc(s, tenant=tenant, model=model, resource=resource)
        b = int(usage.get("migratedBytes") or 0)
        if b:
            self.migrated.inc(b, tenant=tenant, model=model)

    def note_outcome(self, tenant: str, model: str, outcome: str) -> None:
        """Record a terminal outcome that carries no usage payload
        (failures, sheds) so demand by tenant stays visible."""
        if (tenant or "") == CANARY_TENANT:
            return
        t = self.lru.label(tenant or ANONYMOUS_TENANT)
        self.requests.inc(1, tenant=t, model=model or "unknown", outcome=outcome)

    def token_totals(self) -> dict[str, float]:
        """Per-kind token totals summed over tenants and models (the
        shard side of the conservation invariant)."""
        out: dict[str, float] = {}
        for labels, value in self.tokens.items():
            kind = dict(labels).get("kind", "")
            out[kind] = out.get(kind, 0.0) + value
        return out

    def snapshot(self) -> dict[str, Any]:
        """JSON view of the ledger, grouped tenant -> model."""
        tenants: dict[str, dict[str, dict[str, Any]]] = {}

        def cell(tenant: str, model: str) -> dict[str, Any]:
            return tenants.setdefault(tenant, {}).setdefault(
                model, {"tokens": {}, "seconds": {}, "outcomes": {}, "migratedBytes": 0}
            )

        for labels, value in self.tokens.items():
            d = dict(labels)
            cell(d["tenant"], d["model"])["tokens"][d["kind"]] = value
        for labels, value in self.seconds.items():
            d = dict(labels)
            cell(d["tenant"], d["model"])["seconds"][d["resource"]] = round(value, 6)
        for labels, value in self.requests.items():
            d = dict(labels)
            cell(d["tenant"], d["model"])["outcomes"][d["outcome"]] = int(value)
        for labels, value in self.migrated.items():
            d = dict(labels)
            cell(d["tenant"], d["model"])["migratedBytes"] = int(value)
        return {"tenants": tenants}
