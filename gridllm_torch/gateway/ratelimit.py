"""Per-IP fixed-window rate limiter (the JAX package's gateway/ratelimit.py).

Reference analogue: client/src/middleware/rateLimiter.ts (130 LoC) — built
but never mounted (SURVEY.md §2.4); here it is actually applied, with the
same semantics: fixed window, X-RateLimit-* headers, health-path bypass,
429 with Retry-After on exceed. Config keys match the reference's env
(RATE_LIMIT_WINDOW_MS / RATE_LIMIT_MAX_REQUESTS).

Multi-replica deployments: with per-process bucket state N gateway
replicas multiply every limit by N. The scope is now
explicit (``GRIDLLM_RATELIMIT_SCOPE``):

- ``replica`` (default): the original per-process buckets. The limit is
  PER REPLICA by documented contract — size it as limit/N, or use it
  deliberately when replicas sit behind per-replica DNS.
- ``fleet``: bucket state lives in the shared bus (one TTL'd KV record
  per client IP, read-modify-write per counted request), so the limit
  holds fleet-wide regardless of which replica serves the request.
  Concurrent replicas may momentarily lose an increment to the
  read-modify-write race — the limiter is a throttle, not a ledger —
  and a bus failure degrades to the local bucket rather than letting
  traffic through uncounted.

Either scope counts throttled requests in
``gridllm_ratelimit_rejections_total{scope}``.
"""

from __future__ import annotations

import json
import time

from aiohttp import web

from gridllm_torch.bus.base import MessageBus
from gridllm_torch.obs import MetricsRegistry
from gridllm_torch.utils.config import GatewayConfig

# /metrics joins the health bypass: a Prometheus scrape cadence (every
# 10-15 s) would otherwise eat the client budget of whatever shares the
# scraper's IP (and throttling a scrape blinds the dashboard exactly when
# traffic spikes)
_BYPASS_PREFIXES = ("/health", "/live", "/ready", "/metrics")


def _ratelimit_key(ip: str) -> str:
    """Bus KV key holding one client's fleet-scope window record."""
    return f"ratelimit:{ip}"


def rate_limit_middleware(config: GatewayConfig,
                          bus: MessageBus | None = None,
                          metrics: MetricsRegistry | None = None):
    window_s = config.rate_limit_window_ms / 1000
    limit = config.rate_limit_max_requests
    scope = config.rate_limit_scope if bus is not None else "replica"
    buckets: dict[str, tuple[float, int]] = {}  # ip → (window start, count)
    rejections = None
    if metrics is not None:
        rejections = metrics.counter(
            "gridllm_ratelimit_rejections_total",
            "Requests throttled with HTTP 429, by bucket scope (replica "
            "= per-process buckets, so N gateway replicas multiply the "
            "configured limit by N; fleet = bus-shared buckets).",
            ("scope",))

    def local_count(ip: str, now: float) -> tuple[int, float]:
        """(count after this request, window start) from the per-process
        buckets — the replica scope, and the fleet scope's degraded path."""
        start, count = buckets.get(ip, (now, 0))
        if now - start >= window_s:
            start, count = now, 0
        count += 1
        buckets[ip] = (start, count)
        if len(buckets) > 10_000:  # bound memory under IP churn
            cutoff = now - window_s
            for k in [k for k, (s, _) in buckets.items() if s < cutoff]:
                del buckets[k]
        return count, start

    async def fleet_count(ip: str, now: float) -> tuple[int, float]:
        """Bus-shared window record: read-modify-write with the window
        TTL, so abandoned client records expire on their own."""
        key = _ratelimit_key(ip)
        raw = await bus.get(key)
        start, count = now, 0
        if raw:
            try:
                rec = json.loads(raw)
                start = float(rec.get("start", now))
                count = int(rec.get("count", 0))
            except (TypeError, ValueError):
                start, count = now, 0
        if now - start >= window_s:
            start, count = now, 0
        count += 1
        await bus.set_with_expiry(
            key, json.dumps({"start": start, "count": count}), window_s)
        return count, start

    @web.middleware
    async def middleware(request: web.Request, handler):
        if not config.rate_limit_enabled or request.path.startswith(_BYPASS_PREFIXES):
            return await handler(request)
        ip = request.remote or "unknown"
        # wall clock, not monotonic: fleet-scope window starts are shared
        # across processes, and monotonic clocks don't agree between them
        now = time.time()
        if scope == "fleet":
            try:
                count, start = await fleet_count(ip, now)
            except Exception:  # noqa: BLE001 — degraded bus: local bucket
                count, start = local_count(ip, now)
        else:
            count, start = local_count(ip, now)
        remaining = max(0, limit - count)
        reset_s = int(start + window_s - now) + 1
        if count > limit:
            if rejections is not None:
                rejections.inc(scope=scope)
            return web.json_response(
                {"error": {"message": "Too many requests", "code": "RATE_LIMITED"}},
                status=429,
                headers={
                    "Retry-After": str(reset_s),
                    "X-RateLimit-Limit": str(limit),
                    "X-RateLimit-Remaining": "0",
                    "X-RateLimit-Reset": str(reset_s),
                })
        response = await handler(request)
        response.headers["X-RateLimit-Limit"] = str(limit)
        response.headers["X-RateLimit-Remaining"] = str(remaining)
        response.headers["X-RateLimit-Reset"] = str(reset_s)
        return response

    return middleware
