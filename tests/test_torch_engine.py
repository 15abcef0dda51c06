"""The PyTorch port's InferenceEngine against the JAX engine on CPU.

Both engines serve tiny-llama at float32 with the same weights (the JAX
engine's parameters carried across as numpy), speculative decoding off and
the prefix cache on, and get the same requests in the same order. Greedy
token streams, texts, finish reasons and prefix-cache hits must be
identical: solo requests, continuous batching, a prompt longer than the
prefill chunk (mixed steps), a warm prefix-cache repeat, stop sequences
and num_predict. Both are driven through step(); the port's runner thread
is checked against its own synchronous path. Engines that each worker's
`build_one_engine` builds read the fleet's engine knobs alike.
"""

import threading

import jax
import numpy as np
import pytest

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.ops.spec import NgramDrafter as TNgram
from gridllm_torch.utils.config import load_config as t_load_config
from gridllm_torch.worker.main import build_one_engine as t_build
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.ops.spec import NgramDrafter as JNgram
from gridllm_tpu.utils.config import load_config as j_load_config
from gridllm_tpu.worker.main import build_one_engine as j_build

TINY = dict(model="tiny-llama", max_slots=4, page_size=8, num_pages=64,
            max_pages_per_slot=8, prefill_buckets=(16, 32), prefill_chunk=16,
            dtype="float32")
LONG = "ab ab ab ab ab ab ab ab ab ab"   # 30 tokens > prefill_chunk
GREEDY = {"temperature": 0.0, "num_predict": 10}


@pytest.fixture(scope="module")
def engines():
    je = JEngine(JConfig(spec_decode=False, prefix_cache=True, **TINY))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = TEngine(TConfig(spec_decode=False, prefix_cache=True, **TINY), device="cpu",
                 params=params)
    return je, te


def _batch(engine, request_cls, prompts, opts):
    """Submit all prompts, drive step() until done; results in order."""
    res = {}

    def cb(i):
        def f(_delta, done, r):
            if done:
                res[i] = r
        return f

    for i, p in enumerate(prompts):
        engine.submit(request_cls(id=f"r{i}", prompt=p, options=dict(opts), on_chunk=cb(i)))
    for _ in range(10_000):
        if len(res) == len(prompts):
            break
        engine.step()
    return [res[i] for i in range(len(prompts))]


def _same(je, te, prompts, opts=GREEDY):
    want = _batch(je, JRequest, prompts, opts)
    got = _batch(te, TRequest, prompts, opts)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.text == w.text
        assert g.done_reason == w.done_reason
        assert g.prompt_eval_count == w.prompt_eval_count
        assert g.cached_tokens == w.cached_tokens
    return got


@pytest.mark.parametrize("prompt", ["hello", "xyz", "the quick brown fox"])
def test_solo_greedy_streams_match_jax(engines, prompt):
    (r,) = _same(*engines, [prompt])
    assert r.eval_count == GREEDY["num_predict"] and r.done_reason == "length"


def test_continuous_batching_matches_jax(engines):
    _same(*engines, ["aa", "bbbb", "ccccc", "dd dd"])


def test_long_prompt_then_warm_prefix_repeat_match_jax(engines):
    (cold,) = _same(*engines, [LONG + " cold"])
    (warm,) = _same(*engines, [LONG + " cold"])
    assert warm.cached_tokens > 0 and warm.token_ids == cold.token_ids
    # a long prompt admitted while other streams decode: mixed steps
    _same(*engines, ["hi", LONG + " mixed", "yo"])


def test_stop_sequence_and_num_predict_match_jax(engines):
    je, te = engines
    base = _same(je, te, ["stop here"], {"temperature": 0.0, "num_predict": 24})[0]
    text = base.text.replace("�", "")
    stop = text[len(text) // 2:len(text) // 2 + 2]
    assert stop, base.text
    (r,) = _same(je, te, ["stop here"], {"temperature": 0.0, "num_predict": 24,
                                         "stop": [stop]})
    assert r.done_reason == "stop" and stop not in r.text
    _same(je, te, ["num predict"], {"temperature": 0.0, "num_predict": 3})


def test_runner_matches_sync_step(engines):
    _je, te = engines
    prompts = ["runner one", LONG + " runner", "runner three"]
    sync = _batch(te, TRequest, prompts, GREEDY)
    done = {}
    events = [threading.Event() for _ in prompts]

    def cb(i):
        def f(_delta, fin, r):
            if fin:
                done[i] = r
                events[i].set()
        return f

    te.start()
    try:
        for i, p in enumerate(prompts):
            te.submit(TRequest(id=f"q{i}", prompt=p, options=dict(GREEDY), on_chunk=cb(i)))
        assert all(e.wait(60) for e in events)
    finally:
        te.stop()
    assert not te.running
    assert [done[i].token_ids for i in range(len(prompts))] == [r.token_ids for r in sync]
    assert te.free_slot_count == TINY["max_slots"]
    assert te.batch_state()["slots"] == {}


def test_cancel_pending_and_abort(engines):
    _je, te = engines
    seen = []
    te.submit(TRequest(id="c1", prompt="cancel me", options=dict(GREEDY),
                       on_chunk=lambda d, fin, r: fin and seen.append(r)))
    assert te.cancel("c1") and seen[0].done_reason == "cancel"
    te.submit(TRequest(id="c2", prompt="abort me", options=dict(GREEDY),
                       on_chunk=lambda d, fin, r: fin and seen.append(r)))
    assert te.abort_all("test abort") == 1 and seen[1].done_reason == "error"


def _serve(engine, prompts, tag):
    """Submit all prompts to a live runner and wait; results in order."""
    done, events = {}, [threading.Event() for _ in prompts]

    def cb(i):
        def f(_delta, fin, r):
            if fin:
                done[i] = r
                events[i].set()
        return f

    for i, p in enumerate(prompts):
        engine.submit(TRequest(id=f"{tag}{i}", prompt=p, options=dict(GREEDY), on_chunk=cb(i)))
    assert all(e.wait(60) for e in events)
    return [done[i] for i in range(len(prompts))]


def test_runner_serves_under_engine_profile_and_refuses_other_captures(engines):
    """With the runner thread live, InferenceEngine.profile() captures the
    engine's serving (it starts and stops the torch profiler on the runner
    thread, between steps) and the greedy streams equal the unprofiled
    ones; a torch.profiler capture that the engine did not start is
    refused: requests fail with an error naming profile(), start() raises,
    and serving resumes once the capture ends."""
    from torch.profiler import ProfilerActivity, profile

    _je, te = engines
    prompts = ["profiled one", LONG + " profiled", "profiled three"]
    want = _batch(te, TRequest, prompts, GREEDY)
    te.start()
    try:
        with te.profile(activities=[ProfilerActivity.CPU]) as prof:
            got = _serve(te, prompts, "p")
        assert [r.token_ids for r in got] == [r.token_ids for r in want]
        assert any(e.name.startswith("aten::") for e in prof.events())
        with profile(activities=[ProfilerActivity.CPU]):
            refused = _serve(te, prompts, "f")
        assert all(r.done_reason == "error" and "InferenceEngine.profile()" in r.error
                   for r in refused)
        assert [r.token_ids for r in _serve(te, prompts, "a")] == [r.token_ids for r in want]
    finally:
        te.stop()
    assert not te.running
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match=r"InferenceEngine\.profile\(\)"):
            te.start()
    assert not te.running


def test_profile_is_process_wide(engines):
    """Two engines in one process, both runners live: under one engine's
    profile() capture the other keeps serving, unrefused, with the
    unprofiled streams; a second profile() while the first is open raises,
    and the next one, after the first has closed, opens."""
    from torch.profiler import ProfilerActivity

    je, te = engines
    other = TEngine(TConfig(spec_decode=False, prefix_cache=True, **TINY), device="cpu",
                    params=jax.tree_util.tree_map(np.asarray, je.params))
    prompts = ["other one", LONG + " other", "other three"]
    want = _batch(te, TRequest, prompts, GREEDY)
    te.start()
    other.start()
    try:
        with te.profile(activities=[ProfilerActivity.CPU]):
            got = _serve(other, prompts, "o")
            with pytest.raises(RuntimeError, match="another capture"):
                with other.profile(activities=[ProfilerActivity.CPU]):
                    pass
        assert [r.token_ids for r in got] == [r.token_ids for r in want]
        with other.profile(activities=[ProfilerActivity.CPU]):   # the claim was released
            assert [r.token_ids for r in _serve(te, prompts, "t")] == \
                [r.token_ids for r in want]
    finally:
        te.stop()
        other.stop()
    assert not (te.running or other.running)


def test_profile_gate_holds_steps_while_a_capture_switches():
    """_ProfileGate: a capture's switch waits for every other thread's step
    to end (not for the switching thread's own), and a step that starts
    during the switch waits for it to end."""
    from gridllm_torch.engine.engine import _ProfileGate

    gate = _ProfileGate()
    in_step, leave_step, switched, stepped = (threading.Event() for _ in range(4))

    def runner():
        with gate.step():
            in_step.set()
            leave_step.wait(10)

    def switcher():
        with gate.step(), gate.switch():   # a runner switching inside its own step
            switched.set()
            assert not stepped.wait(0.2)   # a new step waits for the switch

    def late_step():
        with gate.step():
            stepped.set()

    threads = [threading.Thread(target=runner)]
    threads[0].start()
    assert in_step.wait(10)
    threads.append(threading.Thread(target=switcher))
    threads[1].start()
    assert not switched.wait(0.2)   # the runner is still inside its step
    leave_step.set()
    assert switched.wait(10)
    threads.append(threading.Thread(target=late_step))
    threads[2].start()
    for th in threads:
        th.join(10)
    assert stepped.is_set() and not any(th.is_alive() for th in threads)


@pytest.mark.parametrize("name", ["tiny-qwen2", "tiny-qwen3", "tiny-mistral"])
def test_model_branches_stream_like_jax_with_chunked_admission(name):
    """tiny-qwen2 (q/k/v bias), tiny-qwen3 (q/k norm) and tiny-mistral
    (sliding window of 8) with their norm, bias and q/k-norm weights moved
    off their init: ragged attention on (both engines' default), a prompt
    longer than the prefill chunk admitted in chunks beside two decoding
    streams (mixed steps), greedy streams identical to the JAX engine's."""
    import jax.numpy as jnp

    from tests.test_torch_llama import moved_params

    cfg = dict(TINY, model=name)
    _, _, np_params = moved_params(name)
    je = JEngine(JConfig(spec_decode=False, prefix_cache=True, **cfg))
    je.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    te = TEngine(TConfig(spec_decode=False, prefix_cache=True, **cfg), device="cpu",
                 params=np_params)
    assert te.model.ragged_attention
    got = _same(je, te, ["hello", LONG, "xyz"])
    assert got[1].prompt_eval_count > TINY["prefill_chunk"]


# ---------------------------------------------------------------------------
# resume, snapshots and suspend (the calls the worker makes)
# ---------------------------------------------------------------------------

REP = "ab ab ab ab ab ab"
REP_OPTS = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 24}
SAMPLED = {"temperature": 0.9, "seed": 1234, "num_predict": 20}


@pytest.fixture(scope="module")
def spec_engines(engines):
    """Port engines on the shared weights: n-gram speculation (K = 4) and
    draft-model tree speculation, its tiny-llama draft on weights of its own
    (so the verify rejects some of its drafts)."""
    je, _ = engines
    params = jax.tree_util.tree_map(np.asarray, je.params)
    ngram = TEngine(TConfig(spec_k=4, **TINY), device="cpu", params=params)
    tree = TEngine(TConfig(spec_k=4, draft_model="tiny-llama", **TINY), device="cpu",
                   params=params)
    return {"ngram": ngram, "tree": tree}


def _run(engine, rid, prompt, opts, snapshot_every=0, **kw):
    """One request through step(); returns (result, deltas, snapshots): the
    snapshot read at each delta, with the chars delivered by then."""
    deltas, snaps, box = [], [], []

    def cb(delta, done, res):
        if done:
            box.append(res)
        deltas.append(delta)
        snap = engine.decode_snapshot(rid)
        if snap is not None:
            snaps.append((snap["tokens"], len("".join(deltas))))

    engine.submit(TRequest(id=rid, prompt=prompt, options=dict(opts), on_chunk=cb,
                           snapshot_every=snapshot_every, **kw))
    for _ in range(10_000):
        if box:
            break
        engine.step()
    return box[0], "".join(deltas), snaps


@pytest.mark.parametrize("mode,prompt,opts", [
    ("plain", "resume me please", GREEDY),
    ("plain", LONG, GREEDY),                 # the resumed context is admitted in chunks
    ("plain", "seeded sampled resume", SAMPLED),
    ("ngram", REP, REP_OPTS),
    ("tree", REP, REP_OPTS),
])
def test_resume_streams_equal_the_undisturbed_stream(engines, spec_engines, mode, prompt,
                                                     opts):
    """A request resumed from a mid-stream watermark (resume_ids = the
    snapshot's tokens, resume_sent = the chars the client had) emits exactly
    the rest of the undisturbed text, and its result equals the undisturbed
    one: greedy with speculation off, n-gram and tree; and a seeded sampled
    stream with speculation off (the same stream as the JAX package's, since
    both draw threefry noise: tests/test_torch_sampling_rng.py). With
    speculation on, a sampled resume is equal only in distribution, as in
    the JAX package."""
    te = engines[1] if mode == "plain" else spec_engines[mode]
    want, text, snaps = _run(te, f"u-{mode}", prompt, opts, snapshot_every=1)
    assert want.done_reason == "length" and want.text == text
    toks, sent = snaps[len(snaps) // 2]
    assert 0 < len(toks) < want.eval_count
    got, rest, _ = _run(te, f"r-{mode}", prompt, opts, resume_ids=toks, resume_sent=sent)
    assert rest == want.text[sent:]
    assert got.text == want.text and got.token_ids == want.token_ids
    assert got.eval_count == want.eval_count and got.done_reason == want.done_reason
    assert got.prompt_eval_count == want.prompt_eval_count
    if mode == "plain" and opts is GREEDY:
        # the JAX engine resumes the same watermark to the same stream
        je = engines[0]
        box = []
        je.submit(JRequest(id=f"j-{prompt}", prompt=prompt, options=dict(opts),
                           resume_ids=toks, resume_sent=sent,
                           on_chunk=lambda d, fin, r: fin and box.append(r)))
        while not box:
            je.step()
        assert box[0].token_ids == got.token_ids and box[0].text == got.text


@pytest.mark.parametrize("mode", ["ngram", "tree"])
def test_decode_snapshot_never_holds_a_rolled_back_token(spec_engines, mode):
    """With speculation on, every watermark the engine writes is a prefix of
    the final stream: a verify's rejected drafts (proposed > accepted here)
    never reach it, and it only grows."""
    te = spec_engines[mode]
    for i, prompt in enumerate((REP, "hello world, here we go", "abc abd abe abf")):
        res, _, snaps = _run(te, f"s-{mode}{i}", prompt, REP_OPTS, snapshot_every=1)
        assert snaps and res.spec_proposed > res.spec_accepted
        for toks, _ in snaps:
            assert res.token_ids[:len(toks)] == toks
        lens = [len(t) for t, _ in snaps]
        assert lens == sorted(lens)


def test_suspend_running_and_pending_requests(engines):
    """suspend() finishes a running request with done_reason "suspend" and
    what a resume needs; its pages stay in the prefix cache, so the resume
    admits warm and equals the undisturbed stream. A pending request
    suspends with nothing generated."""
    _je, te = engines
    want, _, _ = _run(te, "sus-ref", "suspend this one", GREEDY)
    box = []
    te.submit(TRequest(id="sus", prompt="suspend this one", options=dict(GREEDY),
                       on_chunk=lambda d, fin, r: fin and box.append(r)))
    for _ in range(4):
        te.step()
    assert te.active_requests == 1 and te.queued_requests == 0
    assert te.suspend("sus") and box[0].done_reason == "suspend"
    res = box[0]
    assert 0 < len(res.token_ids) < want.eval_count
    assert res.token_ids == want.token_ids[:len(res.token_ids)]
    assert res.context[-len(res.token_ids):] == res.token_ids
    got, _, _ = _run(te, "sus-resume", "suspend this one", GREEDY,
                     resume_ids=res.token_ids, resume_sent=len(res.text))
    assert got.token_ids == want.token_ids and got.cached_tokens > 0
    te.submit(TRequest(id="sus-p", prompt="pending", options=dict(GREEDY),
                       on_chunk=lambda d, fin, r: fin and box.append(r)))
    assert te.queued_requests == 1 and te.suspend("sus-p")
    assert box[-1].done_reason == "suspend" and box[-1].token_ids == []
    assert not te.suspend("sus-p") and te.queued_requests == 0


def test_worker_calls_seed_usage_and_refusals():
    """resolve_seed draws from the engine-seeded RNG; results carry the
    usage fields; images fail non-retryably, naming the slice that ports
    them; an export_only request finishes at its first token with reason
    "export" and its prompt's pages exportable; with the host tier off,
    park_to_host parks nothing."""
    te = TEngine(TConfig(spec_decode=False, seed=7, **TINY), device="cpu")
    te2 = TEngine(TConfig(spec_decode=False, seed=7, **TINY), device="cpu")
    assert [te.resolve_seed() for _ in range(3)] == [te2.resolve_seed() for _ in range(3)]
    res, _, _ = _run(te, "usage", "hello", GREEDY)
    assert res.decode_device_s > 0 and res.kv_page_s > 0
    assert not te.embedding_only and te.kv_transfer_supported()
    bad, _, _ = _run(te, "bad-A 8", "hello", GREEDY, images=["aGVsbG8="])
    assert bad.done_reason == "error" and not bad.retryable and "A 8" in bad.error
    prompt = "an export only prompt that spans more than one page " * 2
    exp, text, _ = _run(te, "export", prompt, GREEDY, export_only=True)
    assert exp.done_reason == "export" and exp.text == "" and len(exp.token_ids) == 1
    out = te.export_prefix_pages(exp.context[:-1])
    n = len(out["tokens"])
    assert n and n % TINY["page_size"] == 0 and out["tokens"] == exp.context[:n]
    assert out["k"].shape[1] == n // TINY["page_size"] and out["dtype"] == "float32"
    assert te.host_tier is None and te.park_to_host(exp.context[:-1]) == 0


# -- the fleet's engine knobs ----------------------------------------------------
# A torch engine built by gridllm_torch.worker.main.build_one_engine and a JAX
# engine built by gridllm_tpu.worker.main.build_one_engine, each from its
# package's load_config() under the same environment, on tiny-llama, report
# the same speculation depth and tree width, drafter kind and settings, KV
# pool dtype, prefix-cache cap and attention mode. Each case sets its knobs
# with monkeypatch; "defaults" sets none.

KNOB_CASES = {
    "defaults": {},
    "all_off": {"GRIDLLM_SPEC_DECODE": "0", "GRIDLLM_PREFIX_CACHE": "0",
                "GRIDLLM_RAGGED_ATTN": "0"},
    "tuned": {"GRIDLLM_SPEC_K": "2", "GRIDLLM_SPEC_NGRAM_MAX": "3",
              "GRIDLLM_SPEC_NGRAM_MIN": "2", "GRIDLLM_SPEC_LOOKBACK": "16",
              "GRIDLLM_PREFIX_CACHE_PAGES": "32", "GRIDLLM_KV_INT8": "1"},
    "draft_model": {"GRIDLLM_SPEC_DRAFT_MODEL": "tiny-llama", "GRIDLLM_SPEC_TREE_WIDTH": "3",
                    "GRIDLLM_SPEC_DRAFT_INGEST": "32", "GRIDLLM_SPEC_K": "3"},
}


def _knob_report(engine, *, ngram_cls, int8, ragged) -> dict:
    spec = engine.batch_state()["specDecode"]
    d = engine._drafter
    drafter = None
    if isinstance(d, ngram_cls):
        drafter = ("ngram", d.max_n, d.min_n, d.lookback)
    elif d is not None:  # the draft model's tree drafter: its ingest width
        drafter = (d.kind, d._w)
    return {
        "spec": (spec["k"], spec["drafter"], spec["treeWidth"]) if spec else None,
        "drafter": drafter,
        "kv_int8": int8,
        "prefix_cap": engine._prefix_cache_cap,
        "ragged": ragged,
    }


@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_build_one_engine_reads_the_fleet_knobs(case, monkeypatch):
    for name, value in KNOB_CASES[case].items():
        monkeypatch.setenv(name, value)
    je = j_build(j_load_config(), "tiny-llama")
    te = t_build(t_load_config(), "tiny-llama", device="cpu")
    want = _knob_report(je, ngram_cls=JNgram, int8=je._kv_int8,
                   ragged=je._ragged)
    got = _knob_report(te, ngram_cls=TNgram, int8=te._kv_int8,
                  ragged=te.model.ragged_attention)
    assert got == want
    if case == "defaults":
        # the values the port's engine served before it read the knobs
        assert got == {"spec": (4, "ngram", 1), "drafter": ("ngram", 4, 1, 0),
                       "kv_int8": False, "prefix_cap": -1, "ragged": True}
