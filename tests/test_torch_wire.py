"""The port's bus wire contract against the JAX package's.

Every channel constant and helper, the channel registry's classification,
the broker's sequence framing and the HLC framing are the JAX package's;
every payload model of `gridllm_torch.utils.types` (dataclasses, no
pydantic) writes the JSON the JAX package's pydantic model writes for the
same payload — on defaults and on seeded random payloads with unknown
keys — and each package's `model_validate` reads the other's JSON back to
the same payload.
"""

import dataclasses
import json
import types
import typing

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gridllm_torch.bus import base as tbase
from gridllm_torch.obs import timeline as ttimeline
from gridllm_torch.utils import types as ttypes
from gridllm_tpu.bus import base as jbase
from gridllm_tpu.obs import timeline as jtimeline
from gridllm_tpu.utils import types as jtypes

MODELS = ["SystemResources", "TpuTopology", "ModelShardLayout", "ModelInfo",
          "NodeCapabilities", "WorkerInfo", "InferenceRequest", "JobAssignment",
          "InferenceResponse", "StreamChunk", "JobResult"]
# fields whose default is drawn when the model is built (a clock reading)
CLOCK_FIELDS = {"lastUpdated", "lastHeartbeat", "registeredAt", "assignedAt", "completedAt"}
IDS = ["w1", "job-7f3a", "a:b:c", "ünï", "x" * 40]


def test_channel_constants_and_helpers_equal_jax():
    t_consts = {k: v for k, v in vars(tbase).items() if k.startswith("CH_")}
    j_consts = {k: v for k, v in vars(jbase).items() if k.startswith("CH_")}
    assert t_consts == j_consts and len(t_consts) == 18
    helpers = [k for k, v in vars(jbase).items()
               if k.endswith("_channel") and callable(v)
               and k not in ("durable_channel", "register_channel")]
    assert len(helpers) == 8
    for name in helpers:
        for i in IDS:
            assert getattr(tbase, name)(i) == getattr(jbase, name)(i), name


def test_channel_registry_and_classification_equal_jax():
    assert tbase.CHANNELS.keys() == jbase.CHANNELS.keys()
    wire = ("family", "pattern", "payload", "keys", "durable", "publishers", "subscribers",
            "helper")
    for fam, spec in jbase.CHANNELS.items():
        got = dataclasses.asdict(tbase.CHANNELS[fam])
        assert {k: got[k] for k in wire} == {k: getattr(spec, k) for k in wire}, fam
    names = [c for c in vars(jbase).values() if isinstance(c, str) and ":" in c]
    names += [getattr(jbase, h)(i) for h in ("worker_job_channel", "job_result_channel",
                                              "job_stream_channel", "kvx_channel")
              for i in IDS]
    names += ["trace:job-1", "unregistered:chan", "job:stream:"]
    for ch in names:
        assert tbase.channel_class(ch) == jbase.channel_class(ch), ch
        assert tbase.durable_channel(ch) == jbase.durable_channel(ch), ch


@given(seq=st.integers(0, 2**40), body=st.text(max_size=40))
@settings(max_examples=60, deadline=None)
def test_seq_framing_equal_jax(seq, body):
    framed = tbase.encode_seq(seq, body)
    assert framed == jbase.encode_seq(seq, body)
    assert tbase.split_seq(framed) == jbase.split_seq(framed) == (seq, body)
    assert tbase.split_seq(body) == jbase.split_seq(body)


@given(wall=st.integers(0, 2**45), logical=st.integers(0, 2**20),
       member=st.text(alphabet="abcdef-0123456789", max_size=12), body=st.text(max_size=30))
@settings(max_examples=60, deadline=None)
def test_hlc_framing_equal_jax(wall, logical, member, body):
    framed = ttimeline.encode_hlc(ttimeline.HLCStamp(wall, logical, member), body)
    assert framed == jtimeline.encode_hlc(jtimeline.HLCStamp(wall, logical, member), body)
    (ts, tb), (js, jb) = ttimeline.split_hlc(framed), jtimeline.split_hlc(framed)
    assert tb == jb == body
    assert (ts.wall_ms, ts.logical, ts.member) == (js.wall_ms, js.logical, js.member)


# -- payload models ---------------------------------------------------------

_JSON_LEAF = st.one_of(st.none(), st.booleans(), st.integers(-2**31, 2**31),
                       st.floats(-1e6, 1e6, allow_nan=False), st.text(max_size=8))
_JSON = st.recursive(_JSON_LEAF, lambda inner: st.one_of(
    st.lists(inner, max_size=3), st.dictionaries(st.text(max_size=5), inner, max_size=3)),
    max_leaves=6)


def _strategy(tp):
    """Values of annotation `tp` as JSON (what a payload on the bus holds)."""
    if tp is typing.Any:
        return _JSON
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin in (typing.Union, types.UnionType):
        return st.one_of(*[st.none() if a is type(None) else _strategy(a) for a in args])
    if origin is typing.Literal:
        return st.sampled_from(args)
    if origin is list:
        return st.lists(_strategy(args[0]), max_size=3)
    if origin is dict:
        return st.dictionaries(st.text(max_size=6), _strategy(args[1]), max_size=3)
    if isinstance(tp, type) and issubclass(tp, ttypes._Model):
        return _payload(tp)
    if isinstance(tp, type) and issubclass(tp, ttypes.Enum):
        return st.sampled_from([m.value for m in tp])
    return {bool: st.booleans(), int: st.integers(-2**40, 2**40),
            float: st.floats(-1e9, 1e9, allow_nan=False), str: st.text(max_size=12)}[tp]


def _payload(cls):
    """Required fields and clock readings always, optional ones sometimes,
    unknown keys sometimes."""
    hints = typing.get_type_hints(cls)
    fields = [f for f in dataclasses.fields(cls) if f.init]
    required = {f.name: _strategy(hints[f.name]) for f in fields
                if f.name in CLOCK_FIELDS or (f.default is dataclasses.MISSING
                                              and f.default_factory is dataclasses.MISSING)}
    optional = {f.name: _strategy(hints[f.name]) for f in fields if f.name not in required}
    extra = st.dictionaries(st.sampled_from(["zzExtra", "aExtra", "_meta"]), _JSON, max_size=2)
    return st.tuples(st.fixed_dictionaries(required, optional=optional), extra).map(
        lambda p: {**p[0], **p[1]})


def _pair(name):
    return getattr(ttypes, name), getattr(jtypes, name)


@pytest.mark.parametrize("name", MODELS)
def test_payload_model_fields_and_defaults_equal_jax(name):
    tcls, jcls = _pair(name)
    assert [f.name for f in dataclasses.fields(tcls)] == list(jcls.model_fields)
    for f in dataclasses.fields(tcls):
        jf = jcls.model_fields[f.name]
        if f.default is not dataclasses.MISSING:
            want = jf.default.value if isinstance(jf.default, jtypes.Enum) else jf.default
            got = f.default.value if isinstance(f.default, ttypes.Enum) else f.default
            assert got == want, (name, f.name)
        elif f.default_factory is not dataclasses.MISSING and f.name not in CLOCK_FIELDS:
            assert f.default_factory() == jf.default_factory(), (name, f.name)


def _minimal(name):
    """The smallest valid payload of each model (its required fields)."""
    worker = {"workerId": "w1", "capabilities": {"workerId": "w1"}}
    request = {"id": "r1", "model": "tiny-llama"}
    return {
        "ModelShardLayout": {"name": "m"}, "ModelInfo": {"name": "m"},
        "NodeCapabilities": {"workerId": "w1"}, "WorkerInfo": worker,
        "InferenceRequest": request,
        "JobAssignment": {"jobId": "r1", "workerId": "w1", "request": request},
        "InferenceResponse": {"id": "r1"}, "StreamChunk": {"id": "r1"},
        "JobResult": {"jobId": "r1", "workerId": "w1", "success": True},
    }.get(name, {})


def _drop_clock(obj):
    if isinstance(obj, dict):
        return {k: _drop_clock(v) for k, v in obj.items() if k not in CLOCK_FIELDS}
    if isinstance(obj, list):
        return [_drop_clock(v) for v in obj]
    return obj


@pytest.mark.parametrize("name", MODELS)
def test_default_payload_json_equals_jax(name):
    tcls, jcls = _pair(name)
    t = json.loads(tcls.model_validate(_minimal(name)).model_dump_json())
    j = json.loads(jcls.model_validate(_minimal(name)).model_dump_json())
    assert list(t) == list(j)
    assert _drop_clock(t) == _drop_clock(j)


@pytest.mark.parametrize("name", MODELS)
@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_random_payload_json_equals_jax_both_ways(name, data):
    tcls, jcls = _pair(name)
    payload = data.draw(_payload(tcls))
    t, j = tcls.model_validate(payload), jcls.model_validate(payload)
    t_json, j_json = t.model_dump_json(), j.model_dump_json()
    assert json.loads(t_json) == json.loads(j_json)
    assert list(json.loads(t_json)) == list(json.loads(j_json))   # unknown keys last, in order
    # each package reads the other's JSON back to the same payload
    assert json.loads(tcls.model_validate_json(j_json).model_dump_json()) == json.loads(j_json)
    assert json.loads(jcls.model_validate_json(t_json).model_dump_json()) == json.loads(t_json)


def test_worker_payloads_are_byte_equal_to_jax():
    """What the worker publishes most (results, stream frames, its
    registration) is the same bytes as the JAX package's, not only the
    same JSON value."""
    resp = {"id": "r1", "model": "tiny-llama", "created_at": "2026-10-17T00:00:00.000Z",
            "response": "héllo", "done": True, "done_reason": "stop", "context": [1, 2],
            "total_duration": 1234, "eval_count": 5}
    payloads = {
        "JobResult": {"jobId": "r1", "workerId": "w1", "success": True, "response": resp,
                      "completedAt": 1792252253.5, "processingTimeMs": 12.25,
                      "usage": {"tenant": "anonymous", "outputTokens": 5}},
        "StreamChunk": {"id": "r1", "model": "m", "response": "a\nb\"", "eval_count": 3,
                        "offset": 7, "message": {"role": "assistant", "content": "a"}},
        "WorkerInfo": {"workerId": "w1", "capabilities": {
            "workerId": "w1", "availableModels": [{"name": "m", "details": {"family": "llama"}}],
            "topology": {"platform": "gpu", "numDevices": 1, "deviceKind": "H100"},
            "lastUpdated": "2026-10-17T00:00:00.000Z"},
            "lastHeartbeat": 1.5, "registeredAt": 2.5, "modelCapacity": {"m": {"slotsFree": 3}}},
    }
    for name, payload in payloads.items():
        tcls, jcls = _pair(name)
        assert tcls.model_validate(payload).model_dump_json() == \
            jcls.model_validate(payload).model_dump_json()


def test_validation_rejects_what_pydantic_rejects():
    for bad in ({"workerId": "w1", "capabilities": {"workerId": "w1"}, "status": "gone"},
                {"workerId": "w1"},
                {"workerId": "w1", "capabilities": {"workerId": "w1"}, "currentJobs": "two"}):
        with pytest.raises(Exception):
            jtypes.WorkerInfo.model_validate(bad)
        with pytest.raises((TypeError, ValueError)):
            ttypes.WorkerInfo.model_validate(bad)
    req = ttypes.InferenceRequest.model_validate(
        {"id": "r", "model": "m", "priority": "high", "extraKey": [1]})
    assert req.priority is ttypes.Priority.high and req.priority.rank == 0
    assert req.extraKey == [1] and req.request_type == "inference"
