"""models.gemma of the PyTorch port against the JAX package at float32.

The JAX gemma2 parameters (every norm moved off its zero init, so the
(1 + w) norms and the four per-layer norms show in the logits) are carried
across with `params_from_jax`; then `forward` and every paged entry point
(`prefill`, `prefill_chunk`, `decode_step`, `verify_step` with a chain and
with a token tree, `mixed_step`), in both attention modes
(GRIDLLM_RAGGED_ATTN on the JAX side), must give the JAX logits to
rtol/atol 2e-4 (the tests/test_models.py tolerance), and the pools both
packages end with must agree. Configs: tiny-gemma2 (D = 16, qpas 24 != D)
and a narrow 2-layer config at D = 256 (H 2, KVH 1, window 8, softcap 50),
with qpas = D and qpas 192; every prompt is longer than the window, so the
even layers drop keys. Then configs, the HF layout, checkpoints, the engine
(greedy streams equal to the JAX engine's in every setting) and a torch
worker beside a JAX one.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.engine import loader as TLOAD
from gridllm_torch.models import configs as TCFG
from gridllm_torch.models import gemma as TG
from gridllm_torch.ops import spec as TSP
from gridllm_torch.ops.kvcache import PagedKVCache as TCache
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import gemma as JG
from gridllm_tpu.ops.kvcache import PagedKVCache as JCache

TOL = dict(rtol=2e-4, atol=2e-4)
# gemma2 at head dim 256 (gemma2:2b/9b's), narrow everywhere else
D256 = dict(name="gemma2-d256-2l", family="gemma2", vocab_size=512, hidden_size=128,
            intermediate_size=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=256,
            rope_theta=10_000.0, rms_eps=1e-6, tie_embeddings=True, max_seq_len=256,
            sliding_window=8, attn_logit_softcap=50.0, final_logit_softcap=30.0,
            query_pre_attn_scalar=256)
CONFIGS = {"tiny-gemma2": None, "gemma2-d256-2l": D256,
           "gemma2-d256-qpas192": dict(D256, name="gemma2-d256-qpas192",
                                       query_pre_attn_scalar=192)}
MODES = ["ragged", "per_phase"]
NORMS = ("attn_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm")


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(name):
    if CONFIGS[name] is None:
        return JCFG.get_config(name), TCFG.get_config(name)
    return JCFG.ModelConfig(**CONFIGS[name]), TCFG.ModelConfig(**CONFIGS[name])


def moved_params(jcfg, seed: int = 3):
    """JAX gemma2 params at float32 (jnp and numpy) with every norm moved
    off its zero init."""
    np_params = jax.tree_util.tree_map(
        np.array, JG.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for key in NORMS:
        leaf = np_params["layers"][key]
        np_params["layers"][key] = (leaf + rng.normal(scale=0.3, size=leaf.shape)).astype(
            np.float32)
    fn = np_params["final_norm"]
    np_params["final_norm"] = (fn + rng.normal(scale=0.3, size=fn.shape)).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, np_params), np_params


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    jcfg, tcfg = _configs(request.param)
    params, np_params = moved_params(jcfg)
    return jcfg, tcfg, params, np_params


def _model(tcfg, np_params, mode="ragged"):
    return TG.Gemma2(tcfg, dtype=torch.float32, device="cpu",
                     ragged_attention=mode == "ragged").params_from_jax(np_params)


def test_forward_matches_jax(models):
    jcfg, tcfg, params, np_params = models
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    want = np.asarray(JG.forward(params, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(_model(tcfg, np_params)(_t(tokens)).numpy(), want, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_paged_entry_points_match_jax(models, mode, monkeypatch):
    """One scenario through every paged entry point, prompts and contexts
    past the window of 8: slot 0 prefills 11 tokens in the 16 bucket, slot
    2 prefills 13 in two page-aligned chunks, five decode steps for both;
    with ragged attention a mixed step admits slot 1's chunk while 0 and 2
    decode (the per-phase mode has no mixed step: slot 1 prefills its chunk
    alone); then a chain verify step of 3 candidates and a token-tree
    verify step of the (2, 2) tree for slots 0 and 2. Logits at every call,
    lengths, tables and pools against the JAX package's."""
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", "1" if mode == "ragged" else "0")
    jcfg, tcfg, params, np_params = models
    model = _model(tcfg, np_params, mode)
    L, P, ps, S, maxp = jcfg.num_layers, 24, 8, 3, 6
    kvh, d = jcfg.num_kv_heads, jcfg.head_dim_
    jc = JCache.create(L, P, ps, kvh, d, S, maxp, dtype=jnp.float32)
    tc = TCache.create(L, P, ps, kvh, d, S, maxp, dtype=torch.float32, device="cpu")
    rows = np.full((S, maxp), -1, np.int32)
    rows[0, :4], rows[1, :2], rows[2, :4] = [4, 9, 1, 17], [12, 0], [7, 3, 15, 20]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=40).astype(np.int32)

    def close(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    padded = np.concatenate([toks[:11], np.zeros(5, np.int32)])
    jl, jc = JG.prefill(params, jcfg, jnp.asarray(padded), jnp.int32(11), jc, jnp.int32(0),
                        jnp.asarray(rows[0]))
    tl, tc = model.prefill(_t(padded), 11, tc, 0, _t(rows[0]))
    close(jl, tl)
    for start, n in ((0, 8), (8, 5)):
        chunk = np.zeros(8, np.int32)
        chunk[:n] = toks[11 + start:11 + start + n]
        jl, jc = JG.prefill_chunk(params, jcfg, jnp.asarray(chunk), jnp.int32(start),
                                  jnp.int32(n), jc, jnp.int32(2), jnp.asarray(rows[2]))
        tl, tc = model.prefill_chunk(_t(chunk), start, n, tc, 2, _t(rows[2]))
        close(jl, tl)

    active = np.asarray([True, False, True])
    cur = np.zeros(S, np.int32)
    for _ in range(5):
        jl, jc = JG.decode_step(params, jcfg, jnp.asarray(cur), jc, jnp.asarray(active))
        tl, tc = model.decode_step(_t(cur), tc, _t(active))
        close(jl, tl)
        cur = np.array(jnp.argmax(jl, axis=-1), np.int32)

    chunk = np.zeros(8, np.int32)
    chunk[:6] = toks[30:36]
    if mode == "ragged":
        jcl, jdl, jc = JG.mixed_step(params, jcfg, jnp.asarray(chunk), jnp.int32(0),
                                     jnp.int32(6), jnp.int32(1), jnp.asarray(rows[1]),
                                     jnp.asarray(cur), jc, jnp.asarray(active))
        tcl, tdl, tc = model.mixed_step(_t(chunk), 0, 6, 1, _t(rows[1]), _t(cur), tc,
                                        _t(active))
        close(jcl, tcl)
        close(jdl[active], tdl[_t(active)])
    else:
        jl, jc = JG.prefill_chunk(params, jcfg, jnp.asarray(chunk), jnp.int32(0), jnp.int32(6),
                                  jc, jnp.int32(1), jnp.asarray(rows[1]))
        tl, tc = model.prefill_chunk(_t(chunk), 0, 6, tc, 1, _t(rows[1]))
        close(jl, tl)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))

    cand = toks[None, 20:23].repeat(S, axis=0).astype(np.int32)
    jl, jc = JG.verify_step(params, jcfg, jnp.asarray(cand), jc, jnp.asarray(active))
    tl, tc = model.verify_step(_t(cand), tc, _t(active))
    close(jl[active], tl[_t(active)])
    parents = TSP.tree_topology(2, 2)
    depths, anc = TSP.tree_depths(parents), TSP.tree_ancestor_mask(parents)
    cand = toks[None, 24:24 + len(parents)].repeat(S, axis=0).astype(np.int32)
    jl, jc = JG.verify_step(params, jcfg, jnp.asarray(cand), jc, jnp.asarray(active),
                            tree_pos=depths, tree_mask=anc)
    tl, tc = model.verify_step(_t(cand), tc, _t(active), tree_pos=depths, tree_mask=anc)
    close(jl[active], tl[_t(active)])

    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_windows_and_init():
    """Even layers slide, odd ones attend fully; random init zeroes the
    norms (the (1 + w) convention) and draws projections at the JAX
    scales."""
    cfg = dataclasses.replace(TCFG.get_config("tiny-gemma2"), num_layers=4)
    gen = torch.Generator().manual_seed(0)
    m = TG.Gemma2(cfg, dtype=torch.float32, device="cpu").init_params(gen)
    assert [m._window(li) for li in range(4)] == [8, 0, 8, 0]
    assert set(m.layers) == {"attn_norm", "wq", "wk", "wv", "wo", "post_attn_norm",
                             "pre_ffn_norm", "w_gate", "w_up", "w_down", "post_ffn_norm"}
    assert all(torch.all(m.layers[k] == 0) for k in NORMS) and torch.all(m.final_norm == 0)
    assert m.lm_head is None
    assert abs(float(m.embed.std()) - 0.02) < 2e-3
    assert abs(float(m.layers["wq"].std()) - cfg.hidden_size ** -0.5) < 0.02


def test_gemma_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(scale=0.3, size=(64,)).astype(np.float32)
    want = np.asarray(JG._gnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    np.testing.assert_allclose(TG.gemma_norm(_t(x), _t(w), 1e-6).numpy(), want, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# configs, HF layout, checkpoints
# ---------------------------------------------------------------------------

HF_GEMMA2 = {"model_type": "gemma2", "architectures": ["Gemma2ForCausalLM"],
             "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
             "num_hidden_layers": 42, "num_attention_heads": 16, "num_key_value_heads": 8,
             "head_dim": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
             "max_position_embeddings": 8192, "sliding_window": 4096,
             "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
             "query_pre_attn_scalar": 256, "hidden_activation": "gelu_pytorch_tanh"}


@pytest.mark.parametrize("tied", [None, True, False])
def test_config_from_hf_dir_matches_jax(tmp_path, tied):
    """A gemma2 config.json (gemma2:9b's, with tie_word_embeddings absent,
    true or false) read by both packages gives the same config; absent
    means tied, as the JAX package reads it."""
    hf = dict(HF_GEMMA2) if tied is None else dict(HF_GEMMA2, tie_word_embeddings=tied)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    got = TCFG.config_from_hf_dir("local", str(tmp_path))
    want = JCFG.config_from_hf_dir("local", str(tmp_path))
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.tie_embeddings == (tied is not False)
    assert dataclasses.replace(got, name="gemma2:9b", tie_embeddings=True) == \
        TCFG.get_config("gemma2:9b")


@pytest.mark.parametrize("name", ["gemma2:2b", "gemma2:9b", "gemma2:27b", "tiny-gemma2"])
def test_registered_gemma2_round_trips_through_hf_config(tmp_path, name):
    cfg = TCFG.get_config(name)
    (tmp_path / "config.json").write_text(json.dumps(cfg.hf_config()))
    back = TCFG.config_from_hf_dir(name, str(tmp_path))
    assert back == cfg
    assert JCFG.config_from_hf_dir(name, str(tmp_path)) == JCFG.get_config(name)


def test_hf_map_matches_jax():
    cfg = TCFG.get_config("tiny-gemma2")
    assert TG.hf_map(cfg) == JG.hf_map(JCFG.get_config("tiny-gemma2"))
    assert TLOAD.model_class(cfg) is TG.Gemma2
    assert TG.Gemma2(cfg, device="cpu").name_map() == TG.hf_map(cfg)


def test_checkpoint_round_trip(tmp_path):
    """tiny-gemma2 through save_checkpoint and load_checkpoint: the HF
    names of Gemma2ForCausalLM (four norms a layer, no lm_head: the head
    is tied), every parameter back bit for bit, the same logits; the JAX
    loader reads the same directory into the same leaves."""
    from gridllm_torch.engine.loader import _open_safetensors
    from gridllm_tpu.engine import loader as JLOAD

    jcfg, tcfg = _configs("tiny-gemma2")
    _, np_params = moved_params(jcfg)
    model = _model(tcfg, np_params)
    TLOAD.save_checkpoint(model, tcfg, str(tmp_path), dtype=torch.float32)
    idx = _open_safetensors(str(tmp_path))
    try:
        names = set(idx.keys())
    finally:
        idx.close()
    assert "lm_head.weight" not in names
    assert {f"model.layers.1.{n}.weight" for n in (
        "input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
        "post_feedforward_layernorm")} <= names
    back = TLOAD.load_checkpoint(tcfg, str(tmp_path), dtype=torch.float32, device="cpu")
    assert isinstance(back, TG.Gemma2)
    for (n, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), n
    tokens = _t(np.arange(20, dtype=np.int32)[None])
    assert torch.equal(back(tokens), model(tokens))
    jcfg_local = JCFG.config_from_hf_dir("local", str(tmp_path))
    jparams = JLOAD.load_checkpoint(jcfg_local, str(tmp_path), dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(jparams["embed"]), np_params["embed"])
    for key, leaf in np_params["layers"].items():
        np.testing.assert_array_equal(np.asarray(jparams["layers"][key]), leaf, err_msg=key)


# ---------------------------------------------------------------------------
# the engine: greedy streams against the JAX engine's
# ---------------------------------------------------------------------------

TINY = dict(model="tiny-gemma2", max_slots=4, page_size=8, num_pages=64,
            max_pages_per_slot=8, prefill_buckets=(16, 32), prefill_chunk=16,
            dtype="float32")
REP_PROMPT = "ab ab ab ab ab ab"
LONG = "ab cd ab cd ab cd ab cd ab cd xy"   # 33 tokens: two chunks, past the window
PROMPTS = [REP_PROMPT, "hello world hello world", LONG]
OPTS = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 20}
SETTINGS = {
    "spec_ragged": (dict(), "1"),
    "plain_ragged": (dict(spec_decode=False), "1"),
    "spec_per_phase": (dict(ragged_attention=False), "0"),
    "plain_per_phase": (dict(spec_decode=False, ragged_attention=False), "0"),
    "kv_int8": (dict(kv_int8=True), "1"),
    "tree_draft": (dict(draft_model="tiny-gemma2"), "1"),
}


def _batch(engine, request_cls, prompts, opts):
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


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_engine_streams_match_jax(setting, monkeypatch):
    """tiny-gemma2 engines of both packages on the same weights, the three
    prompts at once (one of two chunks, past the window), then the long
    prompt again from the prefix cache: greedy token streams, texts,
    cached tokens and speculation counts identical."""
    kw, env = SETTINGS[setting]
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", env)
    jkw = {k: v for k, v in kw.items() if k != "ragged_attention"}
    je = JEngine(JConfig(**TINY, **jkw))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    draft = {}
    if "draft_model" in kw:
        draft = dict(draft_params=jax.tree_util.tree_map(np.asarray, je._drafter.params))
    te = TEngine(TConfig(**TINY, **kw), device="cpu", params=params, **draft)
    assert isinstance(te.model, TG.Gemma2)
    for prompts in (PROMPTS, [LONG]):
        want = _batch(je, JRequest, prompts, OPTS)
        got = _batch(te, TRequest, prompts, OPTS)
        for w, g in zip(want, got):
            assert g.token_ids == w.token_ids
            assert g.text == w.text
            assert g.done_reason == w.done_reason
            assert g.cached_tokens == w.cached_tokens
            assert (g.spec_proposed, g.spec_accepted) == (w.spec_proposed, w.spec_accepted)
    assert got[0].cached_tokens > 0
    if "draft_model" in kw:
        assert te.batch_state()["specDecode"]["drafter"] == je.batch_state()["specDecode"][
            "drafter"]


# ---------------------------------------------------------------------------
# a torch worker beside a JAX worker
# ---------------------------------------------------------------------------

WORKER_TINY = dict(TINY, num_pages=128, max_pages_per_slot=16, prefill_buckets=(16, 64, 128),
                   seed=42)


async def _generate_through_gateway(kind, engine, prompt, opts):
    """One generate job through the JAX gateway, registry and scheduler to a
    worker of `kind` serving `engine` as tiny-gemma2 (tests/test_e2e.py's
    wiring); (text, eval_count, done_reason)."""
    from aiohttp.test_utils import TestClient, TestServer

    from gridllm_torch.utils.config import WorkerConfig as TWorkerConfig
    from gridllm_torch.worker.service import WorkerService as TWorker
    from gridllm_tpu.bus.memory import InMemoryBus
    from gridllm_tpu.gateway.app import create_app
    from gridllm_tpu.scheduler import JobScheduler, WorkerRegistry
    from gridllm_tpu.utils.config import Config
    from gridllm_tpu.utils.config import WorkerConfig as JWorkerConfig
    from gridllm_tpu.worker.service import WorkerService as JWorker
    from tests.helpers import fast_config

    bus = InMemoryBus()
    await bus.connect()
    sched_cfg = fast_config()
    registry = WorkerRegistry(bus, sched_cfg)
    scheduler = JobScheduler(bus, registry, sched_cfg)
    await registry.initialize()
    await scheduler.initialize()
    config = Config()
    config.scheduler = sched_cfg
    cls, wcfg = (JWorker, JWorkerConfig) if kind == "jax" else (TWorker, TWorkerConfig)
    worker = cls(bus, {"tiny-gemma2": engine},
                 wcfg(worker_id=f"{kind}-w", heartbeat_interval_ms=150,
                      resource_monitor_interval_ms=500), stream_flush_ms=5)
    await worker.start()
    client = TestClient(TestServer(create_app(bus, registry, scheduler, config)))
    await client.start_server()
    try:
        resp = await client.post("/ollama/api/generate", json={
            "model": "tiny-gemma2", "prompt": prompt, "stream": False, "options": opts})
        text = await resp.text()
        assert resp.status == 200, text
        body = json.loads(text)
        return body["response"], body["eval_count"], body["done_reason"]
    finally:
        await client.close()
        await worker.stop()
        await scheduler.shutdown()
        await registry.shutdown()
        await bus.disconnect()


async def test_torch_worker_serves_gemma2_like_a_jax_worker():
    """A torch WorkerService serving tiny-gemma2 (the JAX engine's weights)
    answers one generate job, a prompt past the window, with the JAX
    worker's text."""
    je = JEngine(JConfig(**WORKER_TINY))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = TEngine(TConfig(**WORKER_TINY), device="cpu", params=params)
    opts = {"temperature": 0, "num_predict": 12}
    got = await _generate_through_gateway("torch", te, LONG, opts)
    want = await _generate_through_gateway("jax", je, LONG, opts)
    assert got == want
    assert got[1] == 12
