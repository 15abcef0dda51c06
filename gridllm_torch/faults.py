"""Deterministic fault injection.

Every failure path the fault-tolerance machinery claims to survive —
worker loss, bus loss, transfer failure, allocator pressure, engine step
crashes — is reachable through a SEEDED, site-keyed injection layer, so
chaos scenarios are reproducible test cases instead of bespoke
process-kill scripts.

Spec grammar (``GRIDLLM_FAULT_SPEC``, comma-separated)::

    site=P        inject with probability P (0..1) per call, drawn from a
                  per-site RNG seeded by (GRIDLLM_FAULT_SEED, site) —
                  the decision SEQUENCE is a pure function of the seed
    site=@N       inject exactly the Nth call to the site (1-based)
    site=@N+      inject every call from the Nth on

Sites are fixed (``SITES``) so a typo'd site name fails loudly at spec
parse instead of silently injecting nothing:

    bus.publish       raise from the bus publish path (message never sent)
    bus.deliver       drop a delivered message before its handler runs
    kvx.send          fail a KV-migration send (sender falls back locally)
    kvx.import        fail a KV-migration import (receiver NACKs)
    alloc.alloc       simulate KV page-pool exhaustion (alloc returns None)
    kvtier.spill      skip a host-tier page spill (the evicted page is
                      simply lost from the tier — a later match is a miss)
    kvtier.restore    fail a host-tier page restore (the admission
                      degrades to a cold prefill — counted miss, never a
                      wedged request)
    worker.heartbeat  skip one worker heartbeat (key not refreshed)
    engine.step       raise from the engine runner's pump (step-failure
                      recovery: abort + device-state rebuild)
    broker.accept     gridbus drops an accepted connection before reading
                      a byte (dying / conn-table-exhausted broker)
    broker.reply      gridbus writes half a reply then resets the
                      connection (crash mid-reply; clients must abandon
                      the torn reply stream, never resync into it)
    broker.fsync      gridbus AOF fsync stalls, freezing the broker event
                      loop the way a saturated disk does
    probe.issue       raise from the canary prober before a probe is
                      submitted (the round is counted as an error, never
                      a golden-hash verdict)
    health.baseline   drop one baseline observation before it reaches the
                      EWMA detector (a deaf detector round)
    swap.load         raise from the worker's admin load path before the
                      engine is constructed (the op reports ok=false and
                      no half-built engine survives)
    swap.unload       raise from the worker's admin unload path before
                      the engine is torn down (the op reports ok=false;
                      the model stays resident and servable)
    swap.snapshot_restore  fail a host-RAM weight-snapshot restore (the
                      load degrades to the disk/init path — slower,
                      never a wedged request)

The hot-path cost with no spec configured is one module-global boolean
check. Tests drive the layer through :func:`configure` directly; the env
spec exists for chaos runs against real deployments (CI ``fault-smoke``).
"""

from __future__ import annotations

import random
import threading

from gridllm_torch.obs import default_registry
from gridllm_torch.utils.config import env_int, env_str

SITES = (
    "bus.publish",
    "bus.deliver",
    "kvx.send",
    "kvx.import",
    "alloc.alloc",
    "kvtier.spill",
    "kvtier.restore",
    "worker.heartbeat",
    "engine.step",
    "broker.accept",
    "broker.reply",
    "broker.fsync",
    "probe.issue",
    "health.baseline",
    "swap.load",
    "swap.unload",
    "swap.snapshot_restore",
)

_INJECTED = default_registry().counter(
    "gridllm_faults_injected_total",
    "Deterministic fault injections fired, by site (faults.py). Nonzero "
    "outside a chaos run means GRIDLLM_FAULT_SPEC is live in production.",
    ("site",),
)


class InjectedFault(RuntimeError):
    """Raised by raise-style sites; spelled out in error messages so a
    chaos run's failure paths are distinguishable from organic ones."""


class _Site:
    __slots__ = ("mode", "arg", "rng", "calls")

    def __init__(self, mode: str, arg: float, seed: int, name: str):
        self.mode = mode          # "p" | "at" | "from"
        self.arg = arg
        # per-site stream: decisions depend only on (seed, site, call #)
        self.rng = random.Random(f"{seed}|{name}")
        self.calls = 0

    def fire(self) -> bool:
        self.calls += 1
        if self.mode == "p":
            return self.rng.random() < self.arg
        if self.mode == "at":
            return self.calls == int(self.arg)
        return self.calls >= int(self.arg)  # "from"


def parse_spec(spec: str, seed: int) -> dict[str, _Site]:
    """Parse a fault spec; raises ValueError on unknown sites or malformed
    entries (a chaos knob that silently injects nothing is worse than a
    loud startup failure)."""
    table: dict[str, _Site] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"fault spec entry {entry!r}: expected site=value")
        site, _, val = entry.partition("=")
        site = site.strip()
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} (known: {', '.join(SITES)})")
        val = val.strip()
        if val.startswith("@"):
            body = val[1:]
            mode = "from" if body.endswith("+") else "at"
            body = body.rstrip("+")
            n = int(body)
            if n < 1:
                raise ValueError(f"fault spec {entry!r}: call index is 1-based")
            table[site] = _Site(mode, float(n), seed, site)
        else:
            p = float(val)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"fault spec {entry!r}: probability not in [0, 1]")
            table[site] = _Site("p", p, seed, site)
    return table


# Module state: _armed is the one-boolean hot-path gate; _table holds the
# per-site decision state. _loaded gates the lazy env read so a process
# that never sets GRIDLLM_FAULT_SPEC pays nothing beyond the flag check.
_lock = threading.Lock()
_armed = False
_loaded = False
_table: dict[str, _Site] = {}


def configure(spec: str | None, seed: int = 0) -> None:
    """Install a fault spec programmatically (tests / chaos harnesses).
    ``None`` or "" disarms. Replaces any env-derived state."""
    global _armed, _loaded, _table
    with _lock:
        _table = parse_spec(spec, seed) if spec else {}
        _armed = bool(_table)
        _loaded = True


def reset() -> None:
    """Disarm and forget; the next check re-reads the environment."""
    global _armed, _loaded, _table
    with _lock:
        _table = {}
        _armed = False
        _loaded = False


def _ensure_loaded() -> None:
    global _armed, _loaded, _table
    with _lock:
        if _loaded:
            return
        spec = env_str("GRIDLLM_FAULT_SPEC")
        _table = parse_spec(spec, env_int("GRIDLLM_FAULT_SEED")) if spec else {}
        _armed = bool(_table)
        _loaded = True


def check(site: str) -> bool:
    """True when the site should inject THIS call (skip/degrade-style
    sites: dropped delivery, skipped heartbeat, simulated exhaustion)."""
    if _loaded and not _armed:
        return False
    _ensure_loaded()
    if not _armed:
        return False
    with _lock:
        st = _table.get(site)
        fired = st.fire() if st is not None else False
    if fired:
        _INJECTED.inc(site=site)
    return fired


def inject(site: str) -> None:
    """Raise :class:`InjectedFault` when the site fires (raise-style
    sites: bus publish, transfer send/import, engine step)."""
    if check(site):
        raise InjectedFault(f"injected fault at {site}")
