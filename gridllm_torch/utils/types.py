"""Wire types of the scheduler/bus/worker protocol, without pydantic.

The JAX package's utils/types.py declares these as pydantic models; the
port declares the same fields, in the same order and with the same
defaults, as dataclasses behind a small `_Model` base with the methods the
worker and the scheduler call (`model_validate`, `model_validate_json`,
`model_dump`, `model_dump_json`, `model_copy`). The JSON is pydantic's:
compact, declared fields in order, float fields as floats, enums as
their values, nested models as objects, and unknown keys kept and
written after the declared ones (`extra="allow"`). Validation
converts nested models, enums and numbers, and checks Literal fields.

`TpuTopology` keeps its name: it is the wire contract the scheduler
reads. A torch worker fills it with `platform="gpu"`.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import json
import time
import types
import typing
from enum import Enum
from typing import Any, Literal


def now_ms() -> int:
    return int(time.time() * 1000)


def iso_now() -> str:
    t = time.time()
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + f".{int(t*1000)%1000:03d}Z"


class Priority(str, Enum):
    high = "high"
    medium = "medium"
    low = "low"

    @property
    def rank(self) -> int:
        return {"high": 0, "medium": 1, "low": 2}[self.value]


_HINTS: dict[type, dict[str, Any]] = {}


def _hints(cls: type) -> dict[str, Any]:
    hints = _HINTS.get(cls)
    if hints is None:
        hints = _HINTS[cls] = typing.get_type_hints(cls)
    return hints


class ValidationError(ValueError):
    """A value that fails its field's annotation. `loc` is the path to it
    (field name, list index, union member) and `msg` pydantic's wording,
    so the gateway answers a malformed body as the JAX gateway does."""

    def __init__(self, model: str, loc: tuple[Any, ...], msg: str, value: Any = None):
        self.model, self.loc, self.msg = model, loc, msg
        super().__init__(f"{model}.{'.'.join(map(str, loc))}: {msg} (got {value!r})")


def _tag(tp: Any) -> str:
    """pydantic's name of a union member, as it appears in an error's loc."""
    if tp is Any:
        return "any"
    origin = typing.get_origin(tp)
    if origin in (list, dict):
        return f"{origin.__name__}[{','.join(_tag(a) for a in typing.get_args(tp))}]"
    return getattr(tp, "__name__", str(tp))


def _choices(values: Any) -> str:
    names = [repr(v.value if isinstance(v, enum.Enum) else v) for v in values]
    return names[0] if len(names) == 1 else f"{', '.join(names[:-1])} or {names[-1]}"


def _convert(tp: Any, value: Any, model: str, loc: tuple[Any, ...]) -> Any:
    """`value` validated against the annotation `tp` (pydantic's lax mode
    for the types these models use); a failure raises ValidationError."""

    def fail(msg: str):
        raise ValidationError(model, loc, msg, value)

    if tp is Any:
        return value
    origin = typing.get_origin(tp)
    if origin in (typing.Union, types.UnionType):
        members = [a for a in typing.get_args(tp) if a is not type(None)]
        if value is None and len(members) < len(typing.get_args(tp)):
            return None
        if len(members) == 1:
            return _convert(members[0], value, model, loc)
        errors = []
        for arg in members:
            try:
                return _convert(arg, value, model, loc + (_tag(arg),))
            except ValidationError as e:
                errors.append(e)
        raise errors[0]
    if origin is Literal:
        if value not in typing.get_args(tp):
            fail(f"Input should be {_choices(typing.get_args(tp))}")
        return value
    if origin is list:
        if not isinstance(value, (list, tuple)):
            fail("Input should be a valid list")
        (arg,) = typing.get_args(tp)
        return [_convert(arg, v, model, loc + (i,)) for i, v in enumerate(value)]
    if origin is dict:
        if not isinstance(value, dict):
            fail("Input should be a valid dictionary")
        _, arg = typing.get_args(tp)
        return {str(k): _convert(arg, v, model, loc + (k,)) for k, v in value.items()}
    if isinstance(tp, type) and issubclass(tp, _Model):
        if not isinstance(value, (dict, _Model)):
            fail(f"Input should be a valid dictionary or instance of {tp.__name__}")
        return tp.model_validate(value)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        try:
            return tp(value)
        except ValueError:
            fail(f"Input should be {_choices(list(tp))}")
    if tp is bool:
        if not isinstance(value, bool):
            fail("Input should be a valid boolean")
        return value
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            fail("Input should be a valid integer")
        if isinstance(value, float):
            if not value.is_integer():
                fail("Input should be a valid integer, got a number with a fractional part")
            return int(value)
        return value
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            fail("Input should be a valid number")
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            fail("Input should be a valid string")
        return value
    raise TypeError(f"{model}.{'.'.join(map(str, loc))}: unsupported annotation {tp!r}")


def _jsonable(value: Any) -> Any:
    if isinstance(value, _Model):
        return value.model_dump()
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    return value


def _drop_none(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _drop_none(v) for k, v in value.items() if v is not None}
    if isinstance(value, list):
        return [_drop_none(v) for v in value]
    return value


class _Model:
    """Base of the wire models: a dataclass with pydantic's method names.
    Unknown keys live in `model_extra` and read as attributes."""

    model_extra: dict[str, Any]

    def __post_init__(self) -> None:
        object.__setattr__(self, "model_extra", {})

    def __getattr__(self, name: str) -> Any:
        extra = self.__dict__.get("model_extra")
        if extra is not None and name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__!s} has no attribute {name!r}")

    @classmethod
    def model_validate(cls, obj: Any):
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, _Model):
            obj = obj.model_dump()
        if not isinstance(obj, dict):
            raise ValidationError(cls.__name__, (), "Input should be a valid dictionary", obj)
        hints = _hints(cls)
        kwargs: dict[str, Any] = {}
        extra: dict[str, Any] = {}
        names = {f.name for f in dataclasses.fields(cls) if f.init}
        # declared fields in their order (pydantic reports the first field
        # that fails in declaration order), then the unknown keys
        for f in dataclasses.fields(cls):
            if f.init and f.name in obj:
                kwargs[f.name] = _convert(hints[f.name], obj[f.name], cls.__name__, (f.name,))
        for key, value in obj.items():
            if key not in names:
                extra[key] = value
        missing = [f.name for f in dataclasses.fields(cls)
                   if f.init and f.name not in kwargs
                   and f.default is dataclasses.MISSING
                   and f.default_factory is dataclasses.MISSING]
        if missing:
            raise ValidationError(cls.__name__, (missing[0],), "Field required")
        inst = cls(**kwargs)
        inst.model_extra.update(extra)
        return inst

    @classmethod
    def model_validate_json(cls, data: str | bytes):
        return cls.model_validate(json.loads(data))

    def model_dump(self, *, mode: str = "json", exclude_none: bool = False) -> dict[str, Any]:
        """Declared fields in order, then the unknown keys, as JSON values
        (pydantic's ``mode="json"``, the one mode the callers use);
        ``exclude_none`` drops None values at every depth, as pydantic's."""
        if mode != "json":
            raise ValueError(f"model_dump(mode={mode!r}): only 'json' is supported")
        hints = _hints(type(self))
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if hints[f.name] is float and type(value) is int:
                value = float(value)  # an int default of a float field: 0 → 0.0
            out[f.name] = _jsonable(value)
        for k, v in self.model_extra.items():
            out.setdefault(k, _jsonable(v))
        return _drop_none(out) if exclude_none else out

    def model_copy(self, *, update: dict[str, Any] | None = None):
        """A shallow copy with `update` applied unvalidated, as pydantic's:
        a declared field is set, any other key joins the unknown keys."""
        names = {f.name for f in dataclasses.fields(self)}
        new = copy.copy(self)
        object.__setattr__(new, "model_extra", dict(self.model_extra))
        for k, v in (update or {}).items():
            if k in names:
                object.__setattr__(new, k, v)
            else:
                new.model_extra[k] = v
        return new

    def model_dump_json(self) -> str:
        return json.dumps(self.model_dump(), separators=(",", ":"), ensure_ascii=False)


def _model(cls):
    """Declare a wire model: a keyword-only dataclass on `_Model`."""
    return dataclasses.dataclass(kw_only=True, eq=True)(cls)


def _field(factory):
    return dataclasses.field(default_factory=factory)


# ---------------------------------------------------------------------------
# Worker capability / status records (bus hash `workers`)
# ---------------------------------------------------------------------------

@_model
class SystemResources(_Model):
    cpuCores: int = 0
    totalMemoryMB: float = 0
    availableMemoryMB: float = 0
    cpuUsagePercent: float = 0
    memoryUsagePercent: float = 0
    diskSpaceGB: float = 0
    platform: str = ""
    architecture: str = ""
    # accelerator fields under the JAX package's names (device count and
    # device memory of this worker)
    tpuChips: int = 0
    hbmTotalMB: float = 0
    hbmFreeMB: float = 0


@_model
class TpuTopology(_Model):
    """Accelerator topology of a worker; a torch worker reports "gpu"."""

    platform: str = "cpu"            # "tpu" | "cpu" | "gpu"
    numDevices: int = 1
    numHosts: int = 1
    meshShape: dict[str, int] = _field(dict)
    deviceKind: str = ""
    iciBandwidthGBps: float = 0.0


@_model
class ModelShardLayout(_Model):
    name: str
    strategy: str = "replicated"
    meshAxes: dict[str, int] = _field(dict)
    dtype: str = "bfloat16"
    maxSeqLen: int = 8192
    maxBatchSlots: int = 8


@_model
class ModelInfo(_Model):
    name: str
    model: str | None = None
    size: int = 0
    digest: str = ""
    modified_at: str = ""
    details: dict[str, Any] | None = None


@_model
class NodeCapabilities(_Model):
    workerId: str
    availableModels: list[ModelInfo] = _field(list)
    systemResources: SystemResources | None = None
    performanceTier: Literal["high", "medium", "low"] = "medium"
    maxConcurrentTasks: int = 1
    supportedFormats: list[str] = _field(lambda: ["json"])
    lastUpdated: str = _field(iso_now)
    topology: TpuTopology | None = None
    shardLayouts: list[ModelShardLayout] = _field(list)


@_model
class WorkerInfo(_Model):
    workerId: str
    capabilities: NodeCapabilities
    status: Literal["online", "offline", "busy", "error", "draining"] = "online"
    currentJobs: int = 0
    lastHeartbeat: float = _field(time.time)
    registeredAt: float = _field(time.time)
    totalJobsProcessed: int = 0
    connectionHealth: Literal["healthy", "degraded", "unhealthy"] = "healthy"
    cachedPrefixes: list[str] = _field(list)
    role: Literal["unified", "prefill", "decode"] = "unified"
    decodeSlotsFree: int = 0
    httpAddr: str = ""
    modelCapacity: dict[str, dict[str, int]] = _field(dict)
    healthState: Literal["online", "degraded", "quarantined", "probation"] = "online"

    def model_names(self) -> list[str]:
        return [m.name for m in self.capabilities.availableModels]


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

@_model
class InferenceRequest(_Model):
    """One job as it travels gateway → scheduler → bus → worker."""

    id: str
    model: str
    prompt: str | None = None
    stream: bool | None = None
    messages: list[dict[str, Any]] | None = None
    tools: list[dict[str, Any]] | None = None
    format: str | dict[str, Any] | None = None
    images: list[str] | None = None
    input: str | list[str] | None = None
    truncate: bool | None = None
    options: dict[str, Any] = _field(dict)
    priority: Priority = Priority.medium
    timeout: int = 300_000  # ms
    metadata: dict[str, Any] = _field(dict)

    @property
    def request_type(self) -> str:
        return self.metadata.get("requestType", "inference")


@_model
class JobAssignment(_Model):
    jobId: str
    workerId: str
    request: InferenceRequest
    assignedAt: float = _field(time.time)
    timeout: int = 300_000  # ms


@_model
class InferenceResponse(_Model):
    """Ollama-native response shape (durations in nanoseconds)."""

    id: str
    model: str | None = None
    created_at: str | None = None
    response: str | None = None
    thinking: str | None = None
    message: dict[str, Any] | None = None
    done: bool = True
    done_reason: str | None = None
    context: list[int] | None = None
    embeddings: list[list[float]] | None = None
    embedding: list[float] | None = None
    total_duration: int | None = None
    load_duration: int | None = None
    prompt_eval_count: int | None = None
    prompt_eval_duration: int | None = None
    eval_count: int | None = None
    eval_duration: int | None = None
    system_fingerprint: str | None = None


@_model
class StreamChunk(_Model):
    """One streamed frame on `job:stream:{id}`; `offset` is the absolute
    char index of its first char in the full response text."""

    id: str
    model: str | None = None
    created_at: str | None = None
    response: str = ""
    thinking: str | None = None
    message: dict[str, Any] | None = None
    done: bool = False
    done_reason: str | None = None
    eval_count: int | None = None
    offset: int | None = None


@_model
class JobResult(_Model):
    """Payload on `job:result:{id}` / `job:completed` / `job:failed`."""

    jobId: str
    workerId: str
    success: bool
    response: InferenceResponse | None = None
    error: str | None = None
    retryable: bool = True
    nack: bool = False
    completedAt: float = _field(time.time)
    processingTimeMs: float = 0
    usage: dict[str, Any] | None = None
