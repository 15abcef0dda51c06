"""The PyTorch port's InferenceEngine against the JAX engine on CPU.

Both engines serve tiny-llama at float32 with the same weights (the JAX
engine's parameters carried across as numpy), speculative decoding off and
the prefix cache on, and get the same requests in the same order. Greedy
token streams, texts, finish reasons and prefix-cache hits must be
identical: solo requests, continuous batching, a prompt longer than the
prefill chunk (mixed steps), a warm prefix-cache repeat, stop sequences
and num_predict. Both are driven through step(); the port's runner thread
is checked against its own synchronous path.
"""

import threading

import jax
import numpy as np
import pytest

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine

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
