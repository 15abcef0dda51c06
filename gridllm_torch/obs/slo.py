"""SLO engine: per-request-class objectives, attainment, burn rates,
goodput.

Raw latency histograms say how fast the system is; this layer says
whether it is fast ENOUGH. Each resolved request is classified
(:func:`classify_request`) and judged against its class's configured
objectives (TTFT / inter-token latency / end-to-end, utils/config.py
``SLOConfig``). The per-class outcome stream feeds:

- cumulative attainment ratios (within-SLO / total) and per-objective
  violation counters;
- multi-window **burn rates** — the pace at which the class is spending
  its error budget: ``(violation rate over window) / (1 - target)``. A
  burn rate of 1.0 sustained for the whole window exactly exhausts the
  budget; alerting pairs a fast window (paging) with a slow one
  (ticketing) — deploy/prometheus-alerts.yml encodes the pairing;
- **goodput**: tokens served by within-SLO requests vs. all tokens, plus
  wasted-token accounting for work the cluster did and then threw away
  (duplicate executions surfaced by the at-least-once counters,
  cancelled decodes).

Everything is exposed twice from the SAME state: gauges on ``/metrics``
(render-time collector) and JSON at ``GET /admin/slo`` — so scrapes and
snapshots cannot disagree. Pure stdlib; thread-safe.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from gridllm_torch.obs.metrics import MetricsRegistry
from gridllm_torch.utils.config import SLOConfig

# objectives a request can violate; "error" marks failed/timed-out requests
OBJECTIVES = ("ttft", "itl", "e2e", "error")


def classify_request(request: Any) -> str:
    """Request class for SLO purposes: embeddings are their own class,
    streaming generation is interactive, the rest is batch."""
    if getattr(request, "request_type", "") == "embedding" or \
            getattr(request, "input", None) is not None:
        return "embedding"
    if getattr(request, "stream", False):
        return "interactive"
    return "batch"


class _ClassState:
    __slots__ = ("requests", "within", "tokens", "goodput_tokens",
                 "violations", "events")

    def __init__(self) -> None:
        self.requests = 0
        self.within = 0
        self.tokens = 0
        self.goodput_tokens = 0
        self.violations: dict[str, int] = {}
        # (ts, ok) outcome stream for windowed burn rates; bounded so a
        # flood cannot grow memory — at the cap the oldest events age out
        # exactly as the window prune would have dropped them anyway
        self.events: deque[tuple[float, bool]] = deque(maxlen=65536)


class SLOEngine:
    def __init__(self, config: SLOConfig | None = None,
                 metrics: MetricsRegistry | None = None):
        self.config = config or SLOConfig()
        self.metrics = metrics or MetricsRegistry()
        self._lock = threading.Lock()
        self._classes: dict[str, _ClassState] = {}
        # per-model breakdown: same outcome stream keyed by
        # model, JSON-only (/admin/slo "models") — no extra gauge series
        self._models: dict[str, _ClassState] = {}
        self._wasted: dict[str, int] = {}  # reason → tokens
        m = self.metrics
        self._requests_total = m.counter(
            "gridllm_slo_requests_total",
            "Requests judged against their class SLO.", ("slo_class",))
        self._violations_total = m.counter(
            "gridllm_slo_violations_total",
            "SLO objective violations, by class and objective "
            "(ttft/itl/e2e/error).", ("slo_class", "objective"))
        self._tokens_total = m.counter(
            "gridllm_slo_tokens_total",
            "Output tokens attributed to SLO-judged requests, by class.",
            ("slo_class",))
        self._goodput_tokens = m.counter(
            "gridllm_goodput_tokens_total",
            "Output tokens served by within-SLO requests, by class.",
            ("slo_class",))
        self._wasted_tokens = m.counter(
            "gridllm_goodput_wasted_tokens_total",
            "Output tokens the cluster generated and then discarded "
            "(duplicate executions, cancellations), by reason.",
            ("reason",))
        self._attainment = m.gauge(
            "gridllm_slo_attainment_ratio",
            "Cumulative fraction of requests meeting every objective of "
            "their class.", ("slo_class",))
        self._burn = m.gauge(
            "gridllm_slo_burn_rate",
            "Error-budget burn rate over a trailing window: violation "
            "rate / (1 - target). 1.0 sustained for the window exhausts "
            "the budget.", ("slo_class", "window"))
        self._goodput_ratio = m.gauge(
            "gridllm_goodput_ratio",
            "Within-SLO tokens / all SLO-judged tokens, cumulative.")
        m.add_collector("slo", self._collect)

    # -- recording ----------------------------------------------------------
    def record(self, slo_class: str, ok: bool = True,
               ttft_s: float | None = None, itl_s: float | None = None,
               e2e_s: float | None = None, tokens: int = 0,
               now: float | None = None, model: str | None = None) -> bool:
        """Judge one resolved request. ``ok=False`` (failure/timeout) is an
        unconditional violation ("error"); otherwise each objective the
        class configures is checked against the measurement provided (a
        missing measurement — e.g. no ITL on a one-token reply — is not a
        violation). Returns whether the request was within SLO."""
        if not self.config.enabled:
            return True
        cls_cfg = self.config.classes.get(slo_class)
        violated: list[str] = []
        if not ok:
            violated.append("error")
        elif cls_cfg is not None:
            checks = (("ttft", cls_cfg.ttft_ms, ttft_s),
                      ("itl", cls_cfg.itl_ms, itl_s),
                      ("e2e", cls_cfg.e2e_ms, e2e_s))
            violated = [name for name, limit_ms, measured_s in checks
                        if limit_ms is not None and measured_s is not None
                        and measured_s * 1000 > limit_ms]
        within = not violated
        ts = time.time() if now is None else now
        with self._lock:
            st = self._classes.setdefault(slo_class, _ClassState())
            st.requests += 1
            st.tokens += tokens
            if within:
                st.within += 1
                st.goodput_tokens += tokens
            for obj in violated:
                st.violations[obj] = st.violations.get(obj, 0) + 1
            st.events.append((ts, within))
            if model:
                ms = self._models.setdefault(model, _ClassState())
                ms.requests += 1
                ms.tokens += tokens
                if within:
                    ms.within += 1
                    ms.goodput_tokens += tokens
                for obj in violated:
                    ms.violations[obj] = ms.violations.get(obj, 0) + 1
                ms.events.append((ts, within))
        self._requests_total.inc(slo_class=slo_class)
        self._tokens_total.inc(tokens, slo_class=slo_class)
        if within:
            self._goodput_tokens.inc(tokens, slo_class=slo_class)
        for obj in violated:
            self._violations_total.inc(slo_class=slo_class, objective=obj)
        return within

    def record_waste(self, tokens: int, reason: str) -> None:
        """Account tokens that were generated and then thrown away."""
        if tokens <= 0:
            return
        with self._lock:
            self._wasted[reason] = self._wasted.get(reason, 0) + tokens
        self._wasted_tokens.inc(tokens, reason=reason)

    # -- derived views ------------------------------------------------------
    def _burn_rates_locked(self, st: _ClassState, target: float,
                           now: float) -> dict[int, float]:
        """All configured windows in ONE newest-first walk of the event
        deque (called with the lock held): windows sorted ascending share
        the pass — when the walk crosses a window's cutoff, that window's
        counts are frozen and the walk continues for the larger ones."""
        windows = sorted(self.config.windows_s)
        budget = max(1.0 - target, 1e-9)
        counts: dict[int, tuple[int, int]] = {}  # window → (total, bad)
        total = bad = 0
        wi = 0
        for ts, within in reversed(st.events):
            while wi < len(windows) and ts < now - windows[wi]:
                counts[windows[wi]] = (total, bad)
                wi += 1
            if wi >= len(windows):
                break
            total += 1
            bad += 0 if within else 1
        for w in windows[wi:]:
            counts[w] = (total, bad)
        return {w: ((b / t) / budget if t else 0.0)
                for w, (t, b) in counts.items()}

    def _target_of(self, name: str) -> float:
        cfg = self.config.classes.get(name)
        return cfg.target if cfg is not None else 0.99

    def _collect(self) -> None:
        """Render-time collector: gauges from the same state snapshot()
        reads, so /metrics and /admin/slo always agree."""
        now = time.time()
        with self._lock:
            classes = dict(self._classes)
            total_tokens = sum(st.tokens for st in classes.values())
            good_tokens = sum(st.goodput_tokens for st in classes.values())
            burns = {name: self._burn_rates_locked(st, self._target_of(name),
                                                   now)
                     for name, st in classes.items()}
        for name, st in classes.items():
            if st.requests:
                self._attainment.set(st.within / st.requests, slo_class=name)
            for w, rate in burns[name].items():
                self._burn.set(rate, slo_class=name, window=f"{w}s")
        if total_tokens:
            self._goodput_ratio.set(good_tokens / total_tokens)

    def snapshot(self) -> dict[str, Any]:
        """The /admin/slo JSON body."""
        now = time.time()
        out_classes: dict[str, Any] = {}
        with self._lock:
            classes = dict(self._classes)
            models = dict(self._models)
            wasted = dict(self._wasted)
            burns = {name: self._burn_rates_locked(st, self._target_of(name),
                                                   now)
                     for name, st in classes.items()}
        total_tokens = good_tokens = 0
        for name, st in classes.items():
            cfg = self.config.classes.get(name)
            burn = {f"{w}s": round(rate, 4)
                    for w, rate in burns[name].items()}
            total_tokens += st.tokens
            good_tokens += st.goodput_tokens
            out_classes[name] = {
                "objectives": (cfg.model_dump() if cfg is not None else None),
                "requests": st.requests,
                "withinSlo": st.within,
                "attainment": (round(st.within / st.requests, 6)
                               if st.requests else None),
                "violations": dict(st.violations),
                "burnRates": burn,
                "tokens": st.tokens,
                "goodputTokens": st.goodput_tokens,
            }
        return {
            "enabled": self.config.enabled,
            "windowsS": list(self.config.windows_s),
            "classes": out_classes,
            "models": {
                name: {
                    "requests": ms.requests,
                    "withinSlo": ms.within,
                    "attainment": (round(ms.within / ms.requests, 6)
                                   if ms.requests else None),
                    "violations": dict(ms.violations),
                    "tokens": ms.tokens,
                    "goodputTokens": ms.goodput_tokens,
                }
                for name, ms in models.items()
            },
            "goodput": {
                "tokensTotal": total_tokens,
                "tokensWithinSlo": good_tokens,
                "ratio": (round(good_tokens / total_tokens, 6)
                          if total_tokens else None),
                "wastedTokens": wasted,
            },
        }
