"""models.mixtral of the PyTorch port against the JAX package, on the CPU,
at float32 (inputs made with numpy from a seed).

- `_route` and both MoE forms (`_moe_mlp_dense`, `_moe_mlp_ragged`) against
  the JAX package's, with GRIDLLM_MOE_RAGGED=1 on both sides, within 1e-5;
  the two forms against each other and against a per-token brute force
  that runs only the selected experts; the form chosen per call (dense
  below 16 tokens, ragged at or above only when enabled) and counted;
- tiny-mixtral's forward against the JAX forward; every paged entry point
  (bucket prefill, chunks, decode, mixed and verify steps, in both
  attention modes and both MoE forms) against the JAX package's and
  against the cache-free forward;
- greedy tiny-mixtral engine streams identical to the JAX engine's in both
  forms, with speculation on and off;
- int8 tiny-mixtral (attention and head int8, router and experts in the
  load dtype) against the JAX int8 forward;
- the HF layout: `hf_map` equal to the JAX HF_MAP, a round trip through
  `save_checkpoint`, `config_from_hf_dir` and `load_checkpoint` (per-expert
  HF names, every leaf back bit for bit, the JAX loader reading the same
  directory), mixtral:8x7b's config.json read alike by both packages;
- the worker's capabilities of a mixtral engine equal to the JAX worker's.
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
from gridllm_torch.engine import loader as TLD
from gridllm_torch.models import configs as TCFG
from gridllm_torch.models import mixtral as TM
from gridllm_torch.ops import quant as TQ
from gridllm_torch.ops.kvcache import PagedKVCache as TCache
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import mixtral as JM
from gridllm_tpu.ops import quant as JQ
from gridllm_tpu.ops.kvcache import PagedKVCache as JCache

NAME = "tiny-mixtral"
TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
FORMS = {"dense": "0", "ragged": "1"}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JCFG.get_config(NAME), TCFG.get_config(NAME)
    params = JM.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, np_params


def _model(tcfg, np_params, mode="ragged"):
    return TM.Mixtral(tcfg, dtype=torch.float32, device="cpu",
                      ragged_attention=mode == "ragged").params_from_jax(np_params)


def _layer(np_params, li=0):
    return {k: np_params["layers"][k][li] for k in TM.EXPERT_LEAVES}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 64)])
def test_route_matches_jax(models, shape):
    jcfg, tcfg, _, np_params = models
    lp = _layer(np_params, 1)
    x = _x(shape, 0)
    jw, ji = JM._route(jcfg, jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x))
    tw, ti = TM._route(tcfg, {k: _t(v) for k, v in lp.items()}, _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", [(5, 64), (1, 33, 64), (4, 5, 64)])
def test_moe_forms_match_jax(models, form, shape, monkeypatch):
    """Each form against the JAX package's same form (ragged: its
    ragged_dot dispatch, GRIDLLM_MOE_RAGGED=1 on both sides)."""
    monkeypatch.setenv("GRIDLLM_MOE_RAGGED", FORMS[form])
    jcfg, tcfg, _, np_params = models
    lp = _layer(np_params, 0)
    x = _x(shape, sum(shape))
    jfn = JM._moe_mlp_dense if form == "dense" else JM._moe_mlp_ragged
    tfn = TM._moe_mlp_dense if form == "dense" else TM._moe_mlp_ragged
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jfn(jcfg, jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x)))
    got = tfn(tcfg, {k: _t(v) for k, v in lp.items()}, _t(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, **MOE_TOL)


@pytest.mark.parametrize("tokens", [1, 16, 40])
def test_moe_matches_per_token_brute_force(models, tokens):
    """Both forms against a loop over tokens running only the top-k
    experts, and against each other to 1e-5 relative."""
    _, tcfg, _, np_params = models
    lp = _layer(np_params, 1)
    x = _x((tokens, tcfg.hidden_size), tokens)
    want = np.zeros_like(x)
    for t in range(tokens):
        logits = x[t].astype(np.float64) @ lp["router"]
        p = np.exp(logits - logits.max())
        p /= p.sum()
        top = np.argsort(-p)[:tcfg.experts_per_token]
        for w, e in zip(p[top] / p[top].sum(), top):
            g, u = x[t] @ lp["we_gate"][e], x[t] @ lp["we_up"][e]
            want[t] += w * ((g / (1 + np.exp(-g))) * u) @ lp["we_down"][e]
    tlp = {k: _t(v) for k, v in lp.items()}
    dense = TM._moe_mlp_dense(tcfg, tlp, _t(x)).numpy()
    ragged = TM._moe_mlp_ragged(tcfg, tlp, _t(x)).numpy()
    np.testing.assert_allclose(dense, want, **TOL)
    np.testing.assert_allclose(ragged, want, **TOL)
    np.testing.assert_allclose(ragged, dense, **MOE_TOL)


@pytest.mark.parametrize("env,tokens,form", [
    ("1", 15, "dense"), ("1", 16, "ragged"), ("on", 40, "ragged"), ("0", 40, "dense"),
    ("auto", 40, "dense"),   # auto is the card only: the CPU keeps the dense form
])
def test_moe_form_choice(models, monkeypatch, env, tokens, form):
    monkeypatch.setenv("GRIDLLM_MOE_RAGGED", env)
    _, tcfg, _, np_params = models
    lp = {k: _t(v) for k, v in _layer(np_params).items()}
    before = dict(TM.MOE_FORMS)
    called = []
    for name in ("_moe_mlp_dense", "_moe_mlp_ragged"):
        fn = getattr(TM, name)
        monkeypatch.setattr(TM, name, lambda *a, fn=fn, name=name: called.append(name)
                            or fn(*a))
    TM.moe_mlp(tcfg, lp, _t(_x((1, tokens, tcfg.hidden_size), 3)))
    assert called == [f"_moe_mlp_{form}"]
    assert TM.MOE_FORMS[form] == before[form] + 1
    assert sum(TM.MOE_FORMS.values()) == sum(before.values()) + 1


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", list(FORMS))
def test_forward_matches_jax(models, form, monkeypatch):
    monkeypatch.setenv("GRIDLLM_MOE_RAGGED", FORMS[form])
    jcfg, tcfg, params, np_params = models
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 21)).astype(
        np.int32)
    want = np.asarray(JM.forward(params, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(_model(tcfg, np_params)(_t(tokens)).numpy(), want, **TOL)


def test_layout_and_init():
    """The stacked expert leaves replace the dense FFN; random init draws
    the router at 0.02 and the experts at fan_in ** -0.5."""
    cfg = TCFG.get_config(NAME)
    m = TM.Mixtral(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    e, f, x, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.num_layers
    shapes = {k: tuple(t.shape) for k, t in m.layers.items()}
    assert not {"w_gate", "w_up", "w_down"} & set(shapes)
    assert (shapes["router"], shapes["we_gate"], shapes["we_up"], shapes["we_down"]) == (
        (n, e, x), (n, x, e, f), (n, x, e, f), (n, x, f, e))
    assert abs(float(m.layers["router"].std()) - 0.02) < 4e-3
    assert abs(float(m.layers["we_gate"].std()) - e ** -0.5) < 0.01
    assert abs(float(m.layers["we_down"].std()) - f ** -0.5) < 0.01
    assert TLD.model_class(cfg) is TM.Mixtral


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("mode", ["ragged", "per_phase"])
def test_paged_entry_points_match_jax_and_forward(models, form, mode, monkeypatch):
    """Slot 0 prefills 11 tokens in the 16 bucket, slot 2 prefills 13 in two
    chunks, three decode steps; with ragged attention a mixed step admits
    slot 1's chunk while 0 and 2 decode (per-phase: slot 1's chunk alone);
    then a verify step of 3 candidates. Every call's logits against the JAX
    package's and slot 0's against the cache-free forward of its
    sequence; lengths and pools against JAX's."""
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", "1" if mode == "ragged" else "0")
    monkeypatch.setenv("GRIDLLM_MOE_RAGGED", FORMS[form])
    jcfg, tcfg, params, np_params = models
    model = _model(tcfg, np_params, mode)
    L, P, ps, S, maxp = jcfg.num_layers, 24, 8, 3, 6
    kvh, d = jcfg.num_kv_heads, jcfg.head_dim_
    jc = JCache.create(L, P, ps, kvh, d, S, maxp, dtype=jnp.float32)
    tc = TCache.create(L, P, ps, kvh, d, S, maxp, dtype=torch.float32, device="cpu")
    rows = np.full((S, maxp), -1, np.int32)
    rows[0, :4], rows[1, :2], rows[2, :4] = [4, 9, 1, 17], [12, 0], [7, 3, 15, 20]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=40).astype(np.int32)
    seq0 = list(toks[:11])

    def close(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def oracle(seq):
        return model(_t(np.asarray(seq, np.int32)[None]))[0]

    padded = np.concatenate([toks[:11], np.zeros(5, np.int32)])
    jl, jc = JM.prefill(params, jcfg, jnp.asarray(padded), jnp.int32(11), jc, jnp.int32(0),
                        jnp.asarray(rows[0]))
    tl, tc = model.prefill(_t(padded), 11, tc, 0, _t(rows[0]))
    close(jl, tl)
    np.testing.assert_allclose(tl.numpy(), oracle(seq0)[-1].numpy(), **TOL)
    for start, n in ((0, 8), (8, 5)):
        chunk = np.zeros(8, np.int32)
        chunk[:n] = toks[11 + start:11 + start + n]
        jl, jc = JM.prefill_chunk(params, jcfg, jnp.asarray(chunk), jnp.int32(start),
                                  jnp.int32(n), jc, jnp.int32(2), jnp.asarray(rows[2]))
        tl, tc = model.prefill_chunk(_t(chunk), start, n, tc, 2, _t(rows[2]))
        close(jl, tl)
    active = np.asarray([True, False, True])
    cur = np.zeros(S, np.int32)
    for _ in range(3):
        cur[0] = toks[len(seq0) + 20]
        seq0.append(cur[0])
        jl, jc = JM.decode_step(params, jcfg, jnp.asarray(cur), jc, jnp.asarray(active))
        tl, tc = model.decode_step(_t(cur), tc, _t(active))
        close(jl, tl)
        np.testing.assert_allclose(tl[0].numpy(), oracle(seq0)[-1].numpy(), **TOL)
        cur = np.array(jnp.argmax(jl, axis=-1), np.int32)
    chunk = np.zeros(8, np.int32)
    chunk[:6] = toks[30:36]
    cur[0] = toks[5]
    seq0.append(cur[0])
    if mode == "ragged":
        jcl, jdl, jc = JM.mixed_step(params, jcfg, jnp.asarray(chunk), jnp.int32(0),
                                     jnp.int32(6), jnp.int32(1), jnp.asarray(rows[1]),
                                     jnp.asarray(cur), jc, jnp.asarray(active))
        tcl, tdl, tc = model.mixed_step(_t(chunk), 0, 6, 1, _t(rows[1]), _t(cur), tc,
                                        _t(active))
        close(jcl, tcl)
        close(jdl[active], tdl[_t(active)])
        np.testing.assert_allclose(tdl[0].numpy(), oracle(seq0)[-1].numpy(), **TOL)
        np.testing.assert_allclose(tcl.numpy(), oracle(chunk[:6])[-1].numpy(), **TOL)
    else:
        seq0.pop()
        jl, jc = JM.prefill_chunk(params, jcfg, jnp.asarray(chunk), jnp.int32(0),
                                  jnp.int32(6), jc, jnp.int32(1), jnp.asarray(rows[1]))
        tl, tc = model.prefill_chunk(_t(chunk), 0, 6, tc, 1, _t(rows[1]))
        close(jl, tl)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    cand = toks[None, 20:23].repeat(S, axis=0).astype(np.int32)
    jl, jc = JM.verify_step(params, jcfg, jnp.asarray(cand), jc, jnp.asarray(active))
    tl, tc = model.verify_step(_t(cand), tc, _t(active))
    close(jl[active], tl[_t(active)])
    want = oracle(seq0 + list(cand[0]))[-3:]
    np.testing.assert_allclose(tl[0].numpy(), want.numpy(), **TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_int8_mixtral_matches_jax(models):
    """int8 weights on mixtral: the attention projections and the head are
    int8 (bit-equal to the JAX package's), the router and the experts keep
    the load dtype, and the logits match the JAX int8 forward."""
    jcfg, tcfg, params, _ = models
    qparams = JQ.quantize_params(params)
    assert not isinstance(qparams["layers"]["we_gate"], JQ.QuantizedTensor)
    m = TM.Mixtral(tcfg, dtype=torch.float32, device="cpu", quantize="int8").params_from_jax(
        jax.tree_util.tree_map(np.asarray, qparams))
    assert m.layers["wq"].dtype == torch.int8 and m.layers["we_up"].dtype == torch.float32
    assert "router" not in m.scales and "we_down" not in m.scales
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(1, 17)).astype(
        np.int32)
    want = np.asarray(JM.forward(qparams, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(m(_t(tokens)).numpy(), want, **TOL)
    assert TQ.params_nbytes(m.params_tree()) == JQ.params_nbytes(qparams)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

TINY = dict(model=NAME, max_slots=4, page_size=8, num_pages=64, max_pages_per_slot=8,
            prefill_buckets=(16, 32), prefill_chunk=16, dtype="float32")
PROMPTS = ["ab ab ab ab ab ab", "hello world hello world", "ab cd ab cd ab cd ab cd ab cd xy"]
OPTS = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 16}


def _batch(engine, request_cls, prompts):
    res = {}

    def cb(i):
        def f(_delta, done, r):
            if done:
                res[i] = r
        return f

    for i, p in enumerate(prompts):
        engine.submit(request_cls(id=f"r{i}", prompt=p, options=dict(OPTS), on_chunk=cb(i)))
    for _ in range(10_000):
        if len(res) == len(prompts):
            break
        engine.step()
    return [res[i] for i in range(len(prompts))]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("spec", [True, False])
def test_engine_streams_match_jax(form, spec, monkeypatch):
    """tiny-mixtral engines of both packages on the JAX engine's weights,
    the three prompts at once (one in two chunks) and the long one again
    from the prefix cache: greedy streams, texts, cached tokens and
    speculation counts identical; in the ragged form the MoE calls of 16
    or more tokens (prefill buckets, chunks, mixed and verify steps) took
    it and decode calls stayed dense."""
    monkeypatch.setenv("GRIDLLM_MOE_RAGGED", FORMS[form])
    je = JEngine(JConfig(**TINY, spec_decode=spec))
    te = TEngine(TConfig(**TINY, spec_decode=spec), device="cpu",
                 params=jax.tree_util.tree_map(np.asarray, je.params))
    assert isinstance(te.model, TM.Mixtral)
    before = dict(TM.MOE_FORMS)
    for prompts in (PROMPTS, PROMPTS[2:]):
        want = _batch(je, JRequest, prompts)
        got = _batch(te, TRequest, prompts)
        for w, g in zip(want, got):
            assert (g.token_ids, g.text, g.done_reason) == (w.token_ids, w.text,
                                                             w.done_reason)
            assert g.cached_tokens == w.cached_tokens
            assert (g.spec_proposed, g.spec_accepted) == (w.spec_proposed, w.spec_accepted)
    assert got[0].cached_tokens > 0
    calls = {k: TM.MOE_FORMS[k] - before[k] for k in before}
    assert (calls["ragged"] > 0) == (form == "ragged")
    # spec off: decode steps of 4 rows stay dense in both forms; spec on,
    # every step is a verify of 4 x 5 = 20 rows, ragged in that form
    assert (calls["dense"] > 0) == (form == "dense" or not spec)


# ---------------------------------------------------------------------------
# configs, the HF layout, checkpoints
# ---------------------------------------------------------------------------

HF_MIXTRAL = {"model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
              "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
              "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
              "rope_theta": 1e6, "rms_norm_eps": 1e-5, "max_position_embeddings": 32768,
              "num_local_experts": 8, "num_experts_per_tok": 2, "sliding_window": None,
              "tie_word_embeddings": False, "hidden_act": "silu"}


def test_config_from_hf_dir_matches_jax(tmp_path):
    """mixtral:8x7b's published config.json: both packages read the same
    config, the registered one."""
    (tmp_path / "config.json").write_text(json.dumps(HF_MIXTRAL))
    got = TCFG.config_from_hf_dir("mixtral:8x7b", str(tmp_path))
    want = JCFG.config_from_hf_dir("mixtral:8x7b", str(tmp_path))
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got == TCFG.get_config("mixtral:8x7b")


@pytest.mark.parametrize("name", ["mixtral:8x7b", NAME])
def test_registered_mixtral_round_trips_through_hf_config(tmp_path, name):
    cfg = TCFG.get_config(name)
    hf = cfg.hf_config()
    assert (hf["model_type"], hf["num_local_experts"], hf["num_experts_per_tok"]) == (
        "mixtral", cfg.num_experts, cfg.experts_per_token)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    back = TCFG.config_from_hf_dir(name, str(tmp_path))
    assert dataclasses.replace(back, head_dim=cfg.head_dim) == cfg
    assert back.head_dim_ == cfg.head_dim_
    jback = JCFG.config_from_hf_dir(name, str(tmp_path))
    assert (jback.family, jback.num_experts, jback.experts_per_token, jback.head_dim_) == (
        "mixtral", cfg.num_experts, cfg.experts_per_token, cfg.head_dim_)


def test_hf_map_matches_jax():
    cfg = TCFG.get_config(NAME)
    assert TM.hf_map(cfg) == JM.HF_MAP
    assert TM.Mixtral(cfg, device="cpu").name_map() == JM.HF_MAP


def test_checkpoint_round_trip(tmp_path, models):
    """tiny-mixtral through save_checkpoint, config_from_hf_dir and
    load_checkpoint: MixtralForCausalLM's per-expert names (experts.{x}.w1,
    w2, w3 and the router's gate), every parameter back bit for bit, the
    same logits; the JAX loader reads the same directory into the same
    leaves; an engine serves the directory by an unregistered name."""
    from gridllm_torch.engine.loader import _open_safetensors
    from gridllm_tpu.engine import loader as JLD

    jcfg, tcfg, _, np_params = models
    model = _model(tcfg, np_params)
    TLD.save_checkpoint(model, tcfg, str(tmp_path), dtype=torch.float32)
    idx = _open_safetensors(str(tmp_path))
    try:
        names = set(idx.keys())
        w2 = idx.get("model.layers.1.block_sparse_moe.experts.3.w2.weight")
    finally:
        idx.close()
    assert {f"model.layers.1.block_sparse_moe.experts.{x}.w{j}.weight"
            for x in range(tcfg.num_experts) for j in (1, 2, 3)} <= names
    assert "model.layers.0.block_sparse_moe.gate.weight" in names
    assert not any("mlp.gate_proj" in n for n in names)
    np.testing.assert_array_equal(w2.numpy(), np_params["layers"]["we_down"][1, 3].T)
    cfg = TCFG.config_from_hf_dir("local-mixtral", str(tmp_path))
    assert dataclasses.replace(cfg, name=NAME) == tcfg
    back = TLD.load_checkpoint(cfg, str(tmp_path), dtype=torch.float32, device="cpu")
    assert isinstance(back, TM.Mixtral)
    for (n, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), n
    tokens = _t(np.arange(20, dtype=np.int32)[None])
    assert torch.equal(back(tokens), model(tokens))
    jparams = JLD.load_checkpoint(JCFG.config_from_hf_dir("local", str(tmp_path)),
                                  str(tmp_path), dtype=jnp.float32)
    for key, leaf in np_params["layers"].items():
        np.testing.assert_array_equal(np.asarray(jparams["layers"][key]), leaf, err_msg=key)
    eng = TEngine(TConfig(**dict(TINY, model="local-mixtral", checkpoint_path=str(tmp_path))),
                  device="cpu")
    assert eng.load_source == "checkpoint" and isinstance(eng.model, TM.Mixtral)
    res = eng.generate(TRequest(id="c", prompt="hello", options=dict(OPTS)))
    assert res.done_reason in ("length", "stop") and res.token_ids


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_capabilities_equal_the_jax_workers(quantize):
    from gridllm_torch.worker import capabilities as TCAP
    from gridllm_tpu.worker import capabilities as JCAP

    cfg = dict(TINY, dtype="bfloat16", quantize=quantize)
    got = TCAP.gather_capabilities("w", {NAME: TEngine(TConfig(**cfg), device="cpu")})
    want = JCAP.gather_capabilities("w", {NAME: JEngine(JConfig(**cfg))})
    gd, wd = got.availableModels[0].details, want.availableModels[0].details
    assert gd["family"] == "mixtral"
    assert gd["quantization_level"] == ("Q8_0" if quantize else "BFLOAT16")
    assert {k: v for k, v in gd.items() if k != "engineConfigHash"} == {
        k: v for k, v in wd.items() if k != "engineConfigHash"}
    gl, wl = got.shardLayouts[0], want.shardLayouts[0]
    assert (gl.dtype, gl.maxSeqLen, gl.maxBatchSlots) == (wl.dtype, wl.maxSeqLen,
                                                          wl.maxBatchSlots)
