"""ops.quant of the PyTorch port (int8 weight-only quantization) against the
JAX package, on the CPU.

- `quantize_array` and `quantize_np_leaf` bit-equal to the JAX package's
  (the same int8 values and the same float32 scale bits) on 2-D and stacked
  [L, in, out] leaves, with channels spanning four decades and an all-zero
  channel (its scale floored at 1e-12); `qdot` within 1e-5 relative of
  JAX's; `quantize_params` quantizing the same leaves;
- int8 tiny-llama, tiny-qwen2 and tiny-gemma2: the module's layout (int8
  leaves and float32 scales under both names, no float copy of a quant
  leaf), forward logits against the JAX int8 forward within 1e-4, every
  paged entry point against JAX's;
- greedy int8 streams through the engine identical to the JAX engine's
  (speculation and ragged attention on and off); a snapshot park and
  restore keeping the int8 pairs as they are and the streams;
- `load_checkpoint(quantize="int8")` equal to quantizing after the load and
  to the JAX loader's int8 leaves; `save_checkpoint` refusing int8;
- the llama3:70b memory math for one H100 80GB, from shapes only (meta
  tensors): int8 weights plus a real pool fit, bf16 weights alone do not;
- the worker's capabilities of an int8 engine equal to the JAX worker's.
"""

import dataclasses

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
from gridllm_torch.models import gemma as TG
from gridllm_torch.models import llama as TL
from gridllm_torch.ops import quant as TQ
from gridllm_torch.ops.kvcache import PagedKVCache as TCache
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.engine import loader as JLD
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import gemma as JG
from gridllm_tpu.models import llama as JL
from gridllm_tpu.ops import quant as JQ
from gridllm_tpu.ops.kvcache import PagedKVCache as JCache

TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = {"tiny-llama": (JL, TL.Llama), "tiny-qwen2": (JL, TL.Llama),
          "tiny-gemma2": (JG, TG.Gemma2)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(shape, seed=0):
    """Channels scaled over four decades, channel 0 all zero."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 1, size=shape[-1])
    w[..., 0] = 0.0
    return w.astype(np.float32)


def _bits_equal(got: TQ.QuantizedTensor, want) -> None:
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  np.asarray(want.scale, np.float32).view(np.uint32))


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48), (2, 3, 16, 40)])
def test_quantize_array_bit_equal_to_jax(shape):
    w = _weights(shape)
    want = JQ.quantize_array(jnp.asarray(w))
    _bits_equal(TQ.quantize_array(torch.from_numpy(w)), want)
    _bits_equal(TQ.quantize_array(w), want)             # numpy in, as the loader's
    assert float(TQ.quantize_array(w).scale[..., 0].max()) == np.float32(1e-12)


@pytest.mark.parametrize("shape", [(64, 48), (4, 64, 48)])
def test_quantize_np_leaf_bit_equal_to_jax(shape):
    w = _weights(shape, seed=1)
    got = TQ.quantize_np_leaf("w_down", w)
    _bits_equal(got, JQ.quantize_np_leaf("w_down", w))
    _bits_equal(got, JQ.quantize_array(jnp.asarray(w)))
    assert TQ.quantize_np_leaf("attn_norm", w) is w     # not a matmul leaf
    if len(shape) > 2:                                  # a layer's pair by indexing
        _bits_equal(got[1], JQ.quantize_array(jnp.asarray(w[1])))


@pytest.mark.parametrize("rows", [1, 8, 33])
def test_qdot_matches_jax(rows):
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, 64)).astype(np.float32)
    w = _weights((3, 64, 96), seed=rows)
    jq = JQ.quantize_array(jnp.asarray(w))
    tq = TQ.quantize_array(torch.from_numpy(w))
    for li in range(3):
        jw = JQ.QuantizedTensor(q=jq.q[li], scale=jq.scale[li])
        want = np.asarray(JQ.qdot(jnp.asarray(x), jw, precision=jax.lax.Precision.HIGHEST))
        got = TQ.qdot(_t(x), tq[li]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    plain = rng.normal(size=(64, 96)).astype(np.float32)
    np.testing.assert_allclose(TQ.qdot(_t(x), _t(plain)).numpy(), x @ plain, rtol=1e-5,
                               atol=1e-5)


def test_quantize_params_quantizes_the_jax_leaves():
    jcfg = JCFG.get_config("tiny-qwen2")
    params = JL.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    want = JQ.quantize_params(params)
    got = TQ.quantize_params(jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                                    params))
    assert TQ.QUANT_LEAVES == JQ.QUANT_LEAVES
    assert TQ.NO_QUANT_SUBTREES == JQ.NO_QUANT_SUBTREES
    for name, leaf in want["layers"].items():
        if isinstance(leaf, JQ.QuantizedTensor):
            _bits_equal(got["layers"][name], leaf)
        else:
            assert not isinstance(got["layers"][name], TQ.QuantizedTensor), name
    _bits_equal(got["lm_head"], want["lm_head"])
    assert TQ.params_nbytes(got) == JQ.params_nbytes(want)


# ---------------------------------------------------------------------------
# int8 models against the JAX package
# ---------------------------------------------------------------------------


def _int8_pair(name, seed=1):
    jmod, cls = MODELS[name]
    jcfg, tcfg = JCFG.get_config(name), TCFG.get_config(name)
    params = JQ.quantize_params(jmod.init_params(jcfg, jax.random.PRNGKey(seed),
                                                 dtype=jnp.float32))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = cls(tcfg, dtype=torch.float32, device="cpu", quantize="int8")
    return jmod, jcfg, params, model.params_from_jax(np_params)


@pytest.mark.parametrize("name", list(MODELS))
def test_int8_module_layout(name):
    """Quant leaves are int8 parameters with float32 scales under the same
    names (named_parameters carries both halves); everything else keeps the
    load dtype; the tied gemma2 head has no int8 copy."""
    cfg = TCFG.get_config(name)
    m = MODELS[name][1](cfg, dtype=torch.bfloat16, device="cpu", quantize="int8")
    names = dict(m.named_parameters())
    for leaf, t in m.layers.items():
        if leaf in TQ.QUANT_LEAVES:
            assert t.dtype == torch.int8, leaf
            assert names[f"scales.{leaf}"].dtype == torch.float32
            assert names[f"scales.{leaf}"].shape == t.shape[:-2] + t.shape[-1:]
        else:
            assert t.dtype == torch.bfloat16 and f"scales.{leaf}" not in names, leaf
    assert m.embed.dtype == torch.bfloat16
    if cfg.tie_embeddings:
        assert m.lm_head is None and "scales.lm_head" not in names
    else:
        assert m.lm_head.dtype == torch.int8 and names["scales.lm_head"].shape == (
            cfg.vocab_size,)
    # random init draws the unquantized model's numbers, rounds them to
    # bf16 and quantizes them: the int8 pairs of the bf16 model's weights
    m.init_params(torch.Generator().manual_seed(0))
    plain = MODELS[name][1](cfg, dtype=torch.bfloat16, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    want = TQ.quantize_params(plain.params_tree())
    tree = m.params_tree()
    for leaf in [k for k in tree["layers"] if k in TQ.QUANT_LEAVES] + (
            [] if cfg.tie_embeddings else ["lm_head"]):
        got_leaf = tree["layers"].get(leaf) if leaf != "lm_head" else tree["lm_head"]
        want_leaf = want["layers"].get(leaf) if leaf != "lm_head" else want["lm_head"]
        _bits_equal(got_leaf, want_leaf)
    assert torch.equal(m.embed, plain.embed)
    wq = tree["layers"]["wq"]
    assert int(wq.q.abs().amax(dim=-2).min()) == 127
    assert abs(float(wq.dequantize().std()) - cfg.hidden_size ** -0.5) < 0.02
    with pytest.raises(ValueError, match="unknown quantize mode"):
        MODELS[name][1](cfg, device="cpu", quantize="int4")


@pytest.mark.parametrize("name", list(MODELS))
def test_int8_forward_matches_jax(name):
    jmod, jcfg, params, model = _int8_pair(name)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 21)).astype(
        np.int32)
    want = np.asarray(jmod.forward(params, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(model(_t(tokens)).numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["ragged", "per_phase"])
def test_int8_paged_entry_points_match_jax(mode, monkeypatch):
    """int8 tiny-llama: a bucket prefill, two chunks, three decode steps, a
    mixed step (ragged) and a verify step, logits and pools against the
    JAX package's int8 model."""
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", "1" if mode == "ragged" else "0")
    _, jcfg, params, _ = _int8_pair("tiny-llama")
    tcfg = TCFG.get_config("tiny-llama")
    model = TL.Llama(tcfg, dtype=torch.float32, device="cpu", quantize="int8",
                     ragged_attention=mode == "ragged").params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    L, P, ps, S, maxp = jcfg.num_layers, 24, 8, 3, 6
    jc = JCache.create(L, P, ps, jcfg.num_kv_heads, jcfg.head_dim_, S, maxp,
                       dtype=jnp.float32)
    tc = TCache.create(L, P, ps, jcfg.num_kv_heads, jcfg.head_dim_, S, maxp,
                       dtype=torch.float32, device="cpu")
    rows = np.full((S, maxp), -1, np.int32)
    rows[0, :4], rows[1, :2], rows[2, :4] = [4, 9, 1, 17], [12, 0], [7, 3, 15, 20]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=40).astype(np.int32)

    def close(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    padded = np.concatenate([toks[:11], np.zeros(5, np.int32)])
    jl, jc = JL.prefill(params, jcfg, jnp.asarray(padded), jnp.int32(11), jc, jnp.int32(0),
                        jnp.asarray(rows[0]))
    tl, tc = model.prefill(_t(padded), 11, tc, 0, _t(rows[0]))
    close(jl, tl)
    for start, n in ((0, 8), (8, 5)):
        chunk = np.zeros(8, np.int32)
        chunk[:n] = toks[11 + start:11 + start + n]
        jl, jc = JL.prefill_chunk(params, jcfg, jnp.asarray(chunk), jnp.int32(start),
                                  jnp.int32(n), jc, jnp.int32(2), jnp.asarray(rows[2]))
        tl, tc = model.prefill_chunk(_t(chunk), start, n, tc, 2, _t(rows[2]))
        close(jl, tl)
    active = np.asarray([True, False, True])
    cur = np.zeros(S, np.int32)
    for _ in range(3):
        jl, jc = JL.decode_step(params, jcfg, jnp.asarray(cur), jc, jnp.asarray(active))
        tl, tc = model.decode_step(_t(cur), tc, _t(active))
        close(jl, tl)
        cur = np.array(jnp.argmax(jl, axis=-1), np.int32)
    if mode == "ragged":
        chunk = np.zeros(8, np.int32)
        chunk[:6] = toks[30:36]
        jcl, jdl, jc = JL.mixed_step(params, jcfg, jnp.asarray(chunk), jnp.int32(0),
                                     jnp.int32(6), jnp.int32(1), jnp.asarray(rows[1]),
                                     jnp.asarray(cur), jc, jnp.asarray(active))
        tcl, tdl, tc = model.mixed_step(_t(chunk), 0, 6, 1, _t(rows[1]), _t(cur), tc,
                                        _t(active))
        close(jcl, tcl)
        close(jdl[active], tdl[_t(active)])
    cand = toks[None, 20:23].repeat(S, axis=0).astype(np.int32)
    jl, jc = JL.verify_step(params, jcfg, jnp.asarray(cand), jc, jnp.asarray(active))
    tl, tc = model.verify_step(_t(cand), tc, _t(active))
    close(jl[active], tl[_t(active)])
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_int8_tracks_the_unquantized_forward():
    """The JAX test's bound (tests/test_quant.py): int8 logits within 0.15
    of the float logits, relative to their largest."""
    jcfg = JCFG.get_config("tiny-llama")
    params = JL.init_params(jcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = TCFG.get_config("tiny-llama")
    dense = TL.Llama(tcfg, dtype=torch.float32, device="cpu").params_from_jax(np_params)
    # a float pytree into an int8 model: quantized on the host as it is copied
    quant = TL.Llama(tcfg, dtype=torch.float32, device="cpu",
                     quantize="int8").params_from_jax(np_params)
    want_q = JQ.quantize_params(params)
    _bits_equal(quant.params_tree()["layers"]["w_up"], want_q["layers"]["w_up"])
    toks = _t(np.asarray([[5, 17, 99, 3, 42, 7]], np.int32))
    a, b = dense(toks).numpy(), quant(toks).numpy()
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-6)
    assert 0 < err < 0.15


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

TINY = dict(model="tiny-llama", max_slots=4, page_size=8, num_pages=64,
            max_pages_per_slot=8, prefill_buckets=(16, 32), prefill_chunk=16,
            dtype="float32", quantize="int8")
REP = "ab ab ab ab ab ab"
LONG = "ab cd ab cd ab cd ab cd ab cd xy"   # 33 tokens: two chunks
PROMPTS = [REP, "hello world hello world", LONG]
OPTS = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 16}
SETTINGS = {"spec_ragged": (dict(), "1"), "plain_ragged": (dict(spec_decode=False), "1"),
            "spec_per_phase": (dict(ragged_attention=False), "0")}


def _batch(engine, request_cls, prompts, opts=OPTS):
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


def _streams(results):
    return [(r.token_ids, r.text, r.done_reason) for r in results]


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_int8_engine_streams_match_jax(setting, monkeypatch):
    """int8 tiny-llama engines of both packages on the JAX engine's int8
    weights: the three prompts at once (one in two chunks), greedy token
    streams, texts, cached tokens and speculation counts identical."""
    kw, env = SETTINGS[setting]
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", env)
    je = JEngine(JConfig(**TINY, **{k: v for k, v in kw.items() if k != "ragged_attention"}))
    assert isinstance(je.params["layers"]["wq"], JQ.QuantizedTensor)
    te = TEngine(TConfig(**TINY, **kw), device="cpu",
                 params=jax.tree_util.tree_map(np.asarray, je.params))
    assert te.model.layers["wq"].dtype == torch.int8 and te.model.quantize == "int8"
    for prompts in (PROMPTS, [LONG]):
        want = _batch(je, JRequest, prompts)
        got = _batch(te, TRequest, prompts)
        for w, g in zip(want, got):
            assert (g.token_ids, g.text, g.done_reason) == (w.token_ids, w.text,
                                                             w.done_reason)
            assert g.cached_tokens == w.cached_tokens
            assert (g.spec_proposed, g.spec_accepted) == (w.spec_proposed, w.spec_accepted)
    assert got[0].cached_tokens > 0


def test_int8_engine_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TEngine(TConfig(**dict(TINY, quantize="int4")), device="cpu")


@pytest.fixture
def tier_env(monkeypatch):
    def set_bytes(n):
        monkeypatch.setenv("GRIDLLM_WEIGHT_SNAPSHOT_BYTES", str(n))
        TLD.reset_weight_snapshot_tier()
    yield set_bytes
    TLD.reset_weight_snapshot_tier()


def test_int8_snapshot_park_and_restore_keep_streams(tier_env):
    """An int8 engine parks its int8 pairs (the tier holds int8 q and
    float32 scales, the model's bytes) and the next engine of the same
    snapshot key restores them as they are: equal parameters and streams,
    and no quantization on the restore path."""
    tier_env(1 << 24)
    first = TEngine(TConfig(**TINY), device="cpu")
    want = _streams(_batch(first, TRequest, PROMPTS))
    params = {n: p.clone() for n, p in first.model.named_parameters()}
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    assert first.snapshot_key().endswith("|int8|")
    assert first.park_weights() and first.model is None
    tier = TLD.weight_snapshot_tier()
    assert tier.stats()["bytes"] == nbytes
    snap = tier.restore(first.snapshot_key())
    assert snap["layers.wq"].dtype == torch.int8 and snap["scales.wq"].dtype == torch.float32

    def no_quantize(*_a, **_k):
        raise AssertionError("a restore quantized")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "quantize_into", no_quantize)
        mp.setattr(TL, "to_int8", no_quantize)
        again = TEngine(TConfig(**TINY), device="cpu")
    assert again.load_source == "snapshot"
    for n, p in again.model.named_parameters():
        assert torch.equal(p, params[n]), n
    assert _streams(_batch(again, TRequest, PROMPTS)) == want
    # an unquantized engine of the same model is another identity: a miss
    other = TEngine(TConfig(**dict(TINY, quantize=None)), device="cpu")
    assert other.load_source == "init" and other.model.layers["wq"].dtype == torch.float32


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,dtype", [("tiny-llama", torch.float32),
                                         ("tiny-llama", torch.bfloat16),
                                         ("tiny-gemma2", torch.float32)])
def test_load_checkpoint_int8_equals_quantizing_after_the_load(tmp_path, model, dtype):
    """An unquantized checkpoint loaded with quantize="int8" holds exactly
    the int8 pairs of quantize_params on the same checkpoint loaded as
    float32 (each layer quantized from the stored values), and the JAX
    loader's int8 leaves on the same directory; the load dtype governs the
    other leaves only. An engine with checkpoint_path and quantize serves
    it."""
    cfg = TCFG.get_config(model)
    src = TLD.model_class(cfg)(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    TLD.save_checkpoint(src, cfg, str(tmp_path), dtype)
    got = TLD.load_checkpoint(cfg, str(tmp_path), torch.float32, "cpu", quantize="int8")
    plain = TLD.load_checkpoint(cfg, str(tmp_path), torch.float32, "cpu")
    want = TQ.quantize_params(plain.params_tree())
    jwant = JLD.load_checkpoint(JCFG.get_config(model), str(tmp_path), jnp.float32,
                                quantize="int8")
    tree = got.params_tree()
    for name, leaf in want["layers"].items():
        if isinstance(leaf, TQ.QuantizedTensor):
            _bits_equal(tree["layers"][name], leaf)
            _bits_equal(tree["layers"][name], jwant["layers"][name])
        else:
            assert torch.equal(tree["layers"][name], leaf), name
    if not cfg.tie_embeddings:
        _bits_equal(tree["lm_head"], want["lm_head"])
        _bits_equal(tree["lm_head"], jwant["lm_head"])
    tokens = _t(np.arange(20, dtype=np.int32)[None])
    assert torch.equal(got(tokens), TLD.model_class(cfg)(
        cfg, dtype=torch.float32, device="cpu", quantize="int8").params_from_jax(
        jax.tree_util.tree_map(np.asarray, jwant))(tokens))
    eng = TEngine(TConfig(**dict(TINY, model=model, checkpoint_path=str(tmp_path))),
                  device="cpu")
    assert eng.load_source == "checkpoint"
    for n, p in eng.model.named_parameters():
        assert torch.equal(p, dict(got.named_parameters())[n]), n
    with pytest.raises(ValueError, match="quantize"):
        TLD.load_checkpoint(cfg, str(tmp_path), torch.float32, "cpu", model=plain,
                            quantize="int8")


def test_save_checkpoint_refuses_int8(tmp_path):
    cfg = TCFG.get_config("tiny-llama")
    m = TL.Llama(cfg, dtype=torch.float32, device="cpu", quantize="int8")
    with pytest.raises(ValueError, match="no int8 format"):
        TLD.save_checkpoint(m, cfg, str(tmp_path))
    assert not (tmp_path / "model.safetensors").exists()


# ---------------------------------------------------------------------------
# llama3:70b on one H100 80GB: memory math from shapes only
# ---------------------------------------------------------------------------

H100_BYTES = 81_559 * 2**20          # an H100 80GB's device memory (79.6 GiB)


def _meta_bytes(name, quantize):
    cfg = TCFG.get_config(name)
    m = TLD.model_class(cfg)(cfg, dtype=torch.bfloat16, device="meta", quantize=quantize)
    return TQ.params_nbytes(m.params_tree()), m


def test_70b_int8_fits_one_h100_bf16_does_not():
    """llama3:70b: the int8 weights and scales (66.7 GiB, equal to the JAX
    package's count of the same pytree) plus a real KV pool (8 slots x
    4,096 tokens in bf16, 10 GiB) fit one H100 80GB with room for the
    activations; the bf16 weights alone do not fit. Shapes only: the model
    is built on the meta device and nothing is allocated."""
    cfg = TCFG.get_config("llama3:70b")
    q_bytes, m = _meta_bytes("llama3:70b", "int8")
    bf16_bytes, _ = _meta_bytes("llama3:70b", None)
    assert m.layers["w_down"].device.type == "meta"
    jcfg = JCFG.get_config("llama3:70b")
    jq = jax.eval_shape(lambda: JQ.quantize_params(
        JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)))
    assert q_bytes == JQ.params_nbytes(jq)
    assert bf16_bytes == JQ.params_nbytes(jax.eval_shape(
        lambda: JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)))
    assert 66.5 * 2**30 < q_bytes < 67.0 * 2**30
    assert bf16_bytes > H100_BYTES                      # bf16 cannot fit at all
    tokens = 8 * 4096
    pool = 2 * cfg.num_layers * tokens * cfg.num_kv_heads * cfg.head_dim_ * 2
    assert pool == 10 * 2**30
    assert q_bytes + pool < 0.98 * H100_BYTES


def test_mixtral_bf16_memory_math():
    """mixtral:8x7b: its experts do not quantize, so int8 leaves it past
    one card (87.0 GiB in bf16, 85.6 GiB in int8); 16 of its 32 layers
    (the card phase's cut) are 43.7 GiB."""
    full, _ = _meta_bytes("mixtral:8x7b", None)
    q, _ = _meta_bytes("mixtral:8x7b", "int8")
    assert full > H100_BYTES and q > H100_BYTES
    TCFG.register(dataclasses.replace(TCFG.get_config("mixtral:8x7b"),
                                      name="mixtral-16l-test", num_layers=16))
    try:
        half, _ = _meta_bytes("mixtral-16l-test", None)
    finally:
        del TCFG.REGISTRY["mixtral-16l-test"]
    assert 43.5 * 2**30 < half < 44.0 * 2**30


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def test_int8_capabilities_equal_the_jax_workers():
    from gridllm_torch.worker import capabilities as TCAP
    from gridllm_tpu.worker import capabilities as JCAP

    cfg = dict(TINY, dtype="bfloat16")
    je = JEngine(JConfig(**cfg))
    te = TEngine(TConfig(**cfg), device="cpu")
    got = TCAP.gather_capabilities("w", {"tiny-llama": te})
    want = JCAP.gather_capabilities("w", {"tiny-llama": je})
    gd, wd = got.availableModels[0].details, want.availableModels[0].details
    assert gd["quantization_level"] == "Q8_0"
    assert {k: v for k, v in gd.items() if k != "engineConfigHash"} == {
        k: v for k, v in wd.items() if k != "engineConfigHash"}
    gl, wl = got.shardLayouts[0], want.shardLayouts[0]
    assert (gl.dtype, gl.maxSeqLen, gl.maxBatchSlots) == (wl.dtype, wl.maxSeqLen,
                                                          wl.maxBatchSlots)
