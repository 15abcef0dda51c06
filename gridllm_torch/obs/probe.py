"""Canary prober: active end-to-end correctness + latency probes.

Each scheduler shard runs one :class:`CanaryProber`.  At a low, bounded
rate (``GRIDLLM_PROBE_INTERVAL_MS``; 0 disables) it issues synthetic
greedy fixed-seed generations pinned to one (worker, model) pair at a
time — round-robin over every live worker — through the normal submit
path (``metadata.pinWorkerId`` placement).  The repo's byte-determinism
guarantees make the full response text a correctness checksum: the
first canary per (model, engine-config-hash) **seals a golden output
hash**, and every later canary against the same pair must match
byte-identically.  A mismatch means end-to-end drift — corrupted
weights, a silent kernel fallback, dtype rot — which numcheck's sampled
kernel shadowing cannot see end to end; it quarantines the worker
immediately and opens a forensics incident (``probe.golden_drift``).

Canary traffic rides the reserved ``canary`` tenant
(obs/usage.py CANARY_TENANT): invisible in the usage ledger (both
conservation halves) and in SLO attainment, while its e2e latency still
trains the worker's health baselines (obs/health.py).
"""

from __future__ import annotations

import asyncio
import hashlib
import time
import uuid
from typing import Any

from gridllm_torch.utils.config import env_int
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import InferenceRequest, Priority

from .flightrec import default_flight_recorder
from .health import HealthMonitor
from .metrics import LATENCY_BUCKETS, MetricsRegistry
from .usage import CANARY_TENANT

log = get_logger("obs.probe")

# fixed probe shape: greedy (temperature 0) + pinned seed + fixed prompt
# — the determinism surface the golden hash seals. Changing ANY of these
# (or the engine config, via the hash in the golden key) re-seals.
CANARY_PROMPT = "The canary sings a fixed song:"
CANARY_SEED = 0xCA9A


class CanaryProber:
    """Low-rate synthetic prober for one scheduler shard."""

    def __init__(self, scheduler: Any, registry: Any,
                 health: HealthMonitor, metrics: MetricsRegistry) -> None:
        self.scheduler = scheduler
        self.registry = registry
        self.health = health
        self.interval_ms = env_int("GRIDLLM_PROBE_INTERVAL_MS")
        self.concurrency = max(env_int("GRIDLLM_PROBE_CONCURRENCY"), 1)
        self.timeout_ms = env_int("GRIDLLM_PROBE_TIMEOUT_MS")
        self.tokens = max(env_int("GRIDLLM_PROBE_TOKENS"), 1)
        self.enabled = self.interval_ms > 0
        # golden output hash per (model, engine-config-hash): sealed by
        # the first canary, byte-law for every later one
        self.goldens: dict[tuple[str, str], str] = {}
        self._rr = 0
        self._inflight = 0
        self._task: asyncio.Task | None = None
        self.flightrec = default_flight_recorder()
        self._probes = metrics.counter(
            "gridllm_canary_probes_total",
            "Canary probe rounds, by result: pass (golden match or "
            "seal), drift (golden mismatch — correctness regression), "
            "fail (error/timeout), error (prober-side failure before "
            "submit).",
            ("result",))
        self._latency = metrics.histogram(
            "gridllm_canary_latency_seconds",
            "Canary end-to-end latency per probed worker — the health "
            "monitor's regression baseline input.",
            ("worker",), buckets=LATENCY_BUCKETS)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.enabled and self._task is None:
            self._task = asyncio.create_task(self._loop())
            log.info("canary prober started",
                     interval_ms=self.interval_ms, tokens=self.tokens)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_ms / 1000)
            try:
                target = self._next_target()
                if target is None:
                    continue
                if self._inflight >= self.concurrency:
                    continue  # bounded: never accumulate probe backlog
                asyncio.ensure_future(self._probe_guarded(*target))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — probing is best-effort
                log.warning("canary round failed", error=str(e))

    # -- target selection ----------------------------------------------------
    def _targets(self) -> list[tuple[Any, str]]:
        out: list[tuple[Any, str]] = []
        for w in self.registry.get_all_workers():
            # quarantined workers get no canaries — re-registration is
            # their only way back (health.note_registered); voluntarily
            # draining workers are mid-restart and skipped too
            if w.status not in ("online", "busy"):
                continue
            if getattr(w, "healthState", "online") == "quarantined":
                continue
            mc = getattr(w, "modelCapacity", None) or {}
            for model in w.model_names():
                # scale-to-zero: a model mid-unload (or already
                # unloaded, pending re-registration) has no capacity block
                # in the worker's freshest heartbeat — probing it now
                # would time out and trip CanaryDrift on a healthy worker.
                # Embedding-only models never report capacity and are
                # exempt from the check.
                if mc and model not in mc and not self._embedding_model(w, model):
                    continue
                out.append((w, model))
        return out

    @staticmethod
    def _embedding_model(worker: Any, model: str) -> bool:
        for m in worker.capabilities.availableModels:
            if m.name == model:
                return (m.details or {}).get("family") == "bert_embed"
        return False

    def _next_target(self) -> tuple[Any, str] | None:
        targets = self._targets()
        if not targets:
            return None
        self._rr = (self._rr + 1) % len(targets)
        return targets[self._rr]

    # -- probing -------------------------------------------------------------
    def golden_key(self, worker: Any, model: str) -> tuple[str, str]:
        """(model, engine-config-hash) — the worker advertises the hash
        in its ModelInfo.details (worker/capabilities.py); workers that
        don't (older registrations, test fakes) share the empty-hash
        golden for the model."""
        for m in worker.capabilities.availableModels:
            if m.name == model:
                cfg = (m.details or {}).get("engineConfigHash")
                if cfg:
                    return (model, str(cfg))
        return (model, "")

    async def _probe_guarded(self, worker: Any, model: str) -> None:
        self._inflight += 1
        try:
            await self.probe_once(worker, model)
        except Exception as e:  # noqa: BLE001 — never kill the loop
            log.warning("canary probe errored", error=str(e),
                        worker_id=worker.workerId)
            self._probes.inc(result="error")
        finally:
            self._inflight -= 1

    async def probe_once(self, worker: Any, model: str) -> str:
        """Issue one canary at (worker, model); returns the result label
        (pass/drift/fail/error). Public so tests and bench drive rounds
        directly without the timer loop."""
        from gridllm_torch import faults  # lazy: faults imports obs

        worker_id = worker.workerId
        try:
            faults.inject("probe.issue")
        except faults.InjectedFault:
            # prober-side failure before submit: counted, but never a
            # golden verdict and never a strike against the worker
            self._probes.inc(result="error")
            return "error"
        request = InferenceRequest(
            id=f"canary-{uuid.uuid4().hex[:12]}",
            model=model,
            prompt=CANARY_PROMPT,
            options={"temperature": 0.0, "seed": CANARY_SEED,
                     "num_predict": self.tokens},
            priority=Priority.low,
            timeout=self.timeout_ms,
            metadata={"tenant": CANARY_TENANT, "canary": True,
                      "pinWorkerId": worker_id},
        )
        t0 = time.time()
        try:
            result = await self.scheduler.submit_and_wait(
                request, timeout_ms=self.timeout_ms)
        except Exception:  # noqa: BLE001 — timeout/cancel/bus loss
            result = None
        e2e_s = time.time() - t0
        self._latency.observe(e2e_s, worker=worker_id)
        if result is None or not result.success or result.response is None:
            self._probes.inc(result="fail")
            self.health.note_canary(worker_id, ok=False, e2e_s=e2e_s)
            return "fail"
        text = result.response.response or ""
        digest = hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()
        key = self.golden_key(worker, model)
        golden = self.goldens.get(key)
        if golden is None:
            self.goldens[key] = digest
            self.flightrec.record("probe", "golden_sealed",
                                  worker=worker_id, model=model,
                                  hash=digest[:16])
            verdict = "pass"
        elif digest == golden:
            verdict = "pass"
        else:
            self.flightrec.record("probe", "golden_drift",
                                  worker=worker_id, model=model,
                                  expected=golden[:16], got=digest[:16])
            log.error("canary golden drift", worker_id=worker_id,
                      model=model, expected=golden[:16], got=digest[:16])
            verdict = "drift"
        self._probes.inc(result=verdict)
        self.health.note_canary(worker_id, ok=True, e2e_s=e2e_s,
                                drift=(verdict == "drift"))
        return verdict

    def summary(self) -> dict[str, Any]:
        """Canary pass-rate block for bench records and the fleet-health
        admin view."""
        by_result = {str(dict(labels).get("result", "")): int(v)
                     for labels, v in self._probes.items()}
        total = sum(by_result.values())
        judged = by_result.get("pass", 0) + by_result.get("drift", 0) \
            + by_result.get("fail", 0)
        return {
            "enabled": self.enabled,
            "probes": total,
            "byResult": by_result,
            "passRate": (round(by_result.get("pass", 0) / judged, 4)
                         if judged else None),
            "goldens": len(self.goldens),
        }
