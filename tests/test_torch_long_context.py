"""Long-context serving in the PyTorch port against the JAX package on CPU.

- `attention_prefill_blocked_ref`, the plain version of the
  `flash_prefill_streamed` kernel (query rows in blocks against the keys
  they can see, bounded memory at long T): equal to
  `attention_prefill_ref` on the valid rows (1e-6), and to the JAX
  package's `flash_prefill_streamed` run in interpret mode on the shapes of
  tests/test_pallas.py (2e-5, float32); the CPU wrapper runs it.
- Routing: `attention_prefill` picks the streamed kernel past the JAX
  package's VMEM cap, by the same formula (lane-padded head dim), and both
  packages pick the same kernel at a boundary for D = 64 and 128.
- The engine with whole-prompt admission routed to the streamed kernel
  (cap patched, prefill_chunk at the top bucket, spec decode on): greedy
  streams identical to the JAX engine's.
- llama3 rope at long positions, the prefix cache's chain keys of a
  32,768-token prompt (512 pages), and the long-context model configs.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.models import configs as TCFG
from gridllm_torch.models import llama as TL
from gridllm_torch.ops import attention as TA
from gridllm_torch.ops import cuda_kernels as TK
from gridllm_torch.ops import kvcache as TC
from gridllm_torch.ops import layers as TLY
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import llama as JL
from gridllm_tpu.ops import attention as JA
from gridllm_tpu.ops import kvcache as JC
from gridllm_tpu.ops import layers as JLY
from gridllm_tpu.ops import pallas_kernels as PK

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_pallas.py's streamed tolerance


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, b, t, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, d)).astype(np.float32),
            rng.normal(size=(b, t, kvh, d)).astype(np.float32),
            rng.normal(size=(b, t, kvh, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# the streamed kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,lens,window,softcap,block", [
    (256, [256], 0, 0.0, 64),
    (512, [300, 512], 0, 0.0, 100),     # a block that does not divide T
    (256, [256, 180], 129, 0.0, 64),    # window straddling a block edge
    (128, [128, 70], 24, 50.0, 32),
    (96, [96], 0, 30.0, 1024),          # one block: the whole bucket
])
def test_blocked_ref_equals_prefill_ref(t, lens, window, softcap, block):
    q, k, v = (_t(x) for x in _qkv(t + window, len(lens), t, 4, 2, 32))
    sl = torch.tensor(lens, dtype=torch.int32)
    want = TA.attention_prefill_ref(q, k, v, sl, logit_softcap=softcap, window=window)
    got = TA.attention_prefill_blocked_ref(q, k, v, sl, logit_softcap=softcap, window=window,
                                           block=block)
    assert got.shape == want.shape and got.dtype == want.dtype
    for i, ln in enumerate(lens):
        np.testing.assert_allclose(got[i, :ln].numpy(), want[i, :ln].numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t,lens,window,softcap", [
    (256, [256], 0, 0.0),               # test_pallas.py:351-368
    (512, [300, 512], 0, 0.0),
    (128, [128, 70], 8, 0.0),           # test_pallas.py:421-426
    (128, [128, 70], 0, 30.0),
    (128, [128, 70], 24, 50.0),
    (128, [128, 70], 1, 50.0),
    (256, [256, 180], 32, 0.0),         # test_pallas.py:504-531
    (256, [256, 180], 129, 0.0),
    (256, [256, 180], 200, 0.0),
])
def test_blocked_ref_matches_jax_streamed_kernel(t, lens, window, softcap):
    q, k, v = _qkv(7 * t + window, len(lens), t, 4, 2, 32)
    sl = np.asarray(lens, np.int32)
    want = np.asarray(PK.flash_prefill_streamed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl), interpret=True,
        softcap=softcap, window=window))
    got = TA.attention_prefill_blocked_ref(_t(q), _t(k), _t(v), _t(sl), logit_softcap=softcap,
                                           window=window, block=64).numpy()
    via_wrapper = TK.flash_prefill_streamed(_t(q), _t(k), _t(v), _t(sl), softcap=softcap,
                                            window=window).numpy()
    for i, ln in enumerate(lens):   # padding rows are unspecified in the kernel
        np.testing.assert_allclose(got[i, :ln], want[i, :ln], **KERNEL_TOL)
        np.testing.assert_allclose(via_wrapper[i, :ln], want[i, :ln], **KERNEL_TOL)
    assert TK.LAUNCHES["flash_prefill_streamed"] == 0   # the CPU path launches nothing


@pytest.mark.parametrize("fault,error,match", [
    ("seq_lens_shape", ValueError, "seq_lens has shape"),
    ("v_dtype", TypeError, "v has dtype"),
    ("k_tokens", ValueError, "k has shape"),
    ("kv_heads", ValueError, "query heads over"),
])
def test_streamed_wrapper_refuses_what_the_kernel_does_not_take(fault, error, match):
    """Shapes, dtypes and the head grouping are refused before the device
    dispatch, so a CPU call refuses what a CUDA launch would."""
    q, k, v = (_t(x) for x in _qkv(0, 1, 16, 4, 2, 16))
    sl = torch.tensor([16], dtype=torch.int32)
    if fault == "seq_lens_shape":
        sl = torch.tensor([16, 16], dtype=torch.int32)
    elif fault == "v_dtype":
        v = v.to(torch.bfloat16)
    elif fault == "k_tokens":
        k = k[:, :15]
    else:   # 4 query heads over 3 kv heads
        k, v = (_t(x) for x in _qkv(1, 1, 16, 3, 3, 16)[1:])
    with pytest.raises(error, match=match):
        TK.flash_prefill_streamed(q, k, v, sl)
    assert TK.LAUNCHES["flash_prefill_streamed"] == 0


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's kernels in interpret mode (its env policy is
    cached: cleared before and after)."""
    monkeypatch.setenv("GRIDLLM_PALLAS", "interpret")
    JA._env_mode.cache_clear()
    yield
    JA._env_mode.cache_clear()


def test_attention_prefill_routes_streamed_past_the_cap(monkeypatch, jax_interpret):
    """test_pallas.py:371-396 on both packages: with the cap at 1024 bytes
    both dispatchers pick the streamed kernel, and agree."""
    monkeypatch.setattr(TA, "_FLASH_KV_VMEM_CAP", 1024)
    monkeypatch.setattr(JA, "_FLASH_KV_VMEM_CAP", 1024)
    q, k, v = _qkv(3, 1, 256, 4, 2, 32)
    lens = np.asarray([200], np.int32)
    with mock.patch.object(PK, "flash_prefill_streamed",
                           wraps=PK.flash_prefill_streamed) as jspy:
        want = np.asarray(JA.attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(lens)))
    with mock.patch.object(TK, "flash_prefill_streamed",
                           wraps=TK.flash_prefill_streamed) as tspy, \
            mock.patch.object(TK, "flash_prefill", wraps=TK.flash_prefill) as resident:
        got = TA.attention_prefill(_t(q), _t(k), _t(v), _t(lens)).numpy()
    assert jspy.called and tspy.call_count == 1 and not resident.called
    np.testing.assert_allclose(got[0, :200], want[0, :200], **KERNEL_TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,kernel", [(64, "flash_prefill"), (128, "flash_prefill_streamed")])
def test_routing_boundary_matches_jax(monkeypatch, jax_interpret, d, t, kernel):
    """The cap at exactly a 64-token bucket's 2 * T * 128 * 4 bytes: D = 64
    and D = 128 (both lane-padded to 128) switch after the same T, in both
    packages."""
    cap = 2 * 64 * 128 * 4
    monkeypatch.setattr(TA, "_FLASH_KV_VMEM_CAP", cap)
    monkeypatch.setattr(JA, "_FLASH_KV_VMEM_CAP", cap)
    assert TA.prefill_kernel(t, d, 4) == kernel
    q, k, v = _qkv(d + t, 1, t, 2, 1, d)
    lens = np.asarray([t - 5], np.int32)
    with mock.patch.object(PK, kernel, wraps=getattr(PK, kernel)) as jspy:
        want = np.asarray(JA.attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(lens)))
    with mock.patch.object(TK, kernel, wraps=getattr(TK, kernel)) as tspy:
        got = TA.attention_prefill(_t(q), _t(k), _t(v), _t(lens)).numpy()
    assert jspy.called and tspy.called
    np.testing.assert_allclose(got[0, :t - 5], want[0, :t - 5], **KERNEL_TOL)


@pytest.mark.parametrize("t,d,itemsize,kernel", [
    (16384, 128, 2, "flash_prefill"),
    (20480, 128, 2, "flash_prefill_streamed"),
    (16384, 64, 2, "flash_prefill"),          # D = 64 pads to 128 lanes
    (16448, 64, 2, "flash_prefill_streamed"),
    (8192, 128, 4, "flash_prefill"),
    (16384, 128, 4, "flash_prefill_streamed"),
    (4096, 256, 4, "flash_prefill"),
    (8192, 256, 4, "flash_prefill_streamed"),
])
def test_routing_at_the_real_cap(t, d, itemsize, kernel):
    assert TA._FLASH_KV_VMEM_CAP == JA._FLASH_KV_VMEM_CAP == 8 * 1024 * 1024
    assert TA.prefill_kernel(t, d, itemsize) == kernel
    jax_streamed = 2 * t * JC.lane_pad_dim(d) * itemsize > JA._FLASH_KV_VMEM_CAP
    assert jax_streamed == (kernel == "flash_prefill_streamed")


# ---------------------------------------------------------------------------
# the engine: whole-prompt admission through the streamed kernel
# ---------------------------------------------------------------------------


TINY_LONG = dict(model="tiny-llama", max_slots=4, page_size=8, num_pages=64,
                 max_pages_per_slot=8, prefill_buckets=(16, 32), prefill_chunk=64,
                 dtype="float32")
REP_PROMPT = "ab ab ab ab ab ab ab ab ab ab ab ab ab ab ab ab ab ab"   # 55 tokens
REP_OPTS = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 8}


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


def test_engine_whole_prompt_streamed_matches_jax(monkeypatch, jax_interpret):
    """tiny-llama with prefill_chunk at the top bucket (max_context 64):
    prompts up to 64 tokens admit whole, and with the cap patched in both
    packages every bucket routes to the streamed kernel (the JAX engine's
    kernels in interpret mode); spec decode on (the default)."""
    monkeypatch.setattr(TA, "_FLASH_KV_VMEM_CAP", 1024)
    monkeypatch.setattr(JA, "_FLASH_KV_VMEM_CAP", 1024)
    je = JEngine(JConfig(**TINY_LONG))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = TEngine(TConfig(**TINY_LONG), device="cpu", params=params)
    assert te._chunk_len == te._buckets[-1] == te.max_context == 64
    prompts = [REP_PROMPT, "hello long context", "xyz"]
    with mock.patch.object(TK, "flash_prefill_streamed",
                           wraps=TK.flash_prefill_streamed) as spy, \
            mock.patch.object(TK, "flash_prefill", wraps=TK.flash_prefill) as resident:
        got = _batch(te, TRequest, prompts, REP_OPTS)
    with mock.patch.object(PK, "flash_prefill_streamed",
                           wraps=PK.flash_prefill_streamed) as jspy:
        want = _batch(je, JRequest, prompts, REP_OPTS)
    assert jspy.called
    # one call per layer per admission, and never the resident kernel
    assert spy.call_count == TCFG.get_config("tiny-llama").num_layers * len(prompts)
    assert not resident.called
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids and g.text == w.text
        assert g.done_reason == w.done_reason
        assert (g.spec_proposed, g.spec_accepted) == (w.spec_proposed, w.spec_accepted)
    assert got[0].spec_accepted > 0


def test_engine_num_ctx_and_warm_repeat_match_jax(monkeypatch):
    """num_ctx truncates a long prompt from the left in both engines; the
    warm repeat of a whole-prompt admission goes chunked from its cached
    prefix with one chunk of the full chunk length, as in the JAX engine."""
    je = JEngine(JConfig(**TINY_LONG))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = TEngine(TConfig(**TINY_LONG), device="cpu", params=params)
    monkeypatch.setattr(TA, "_FLASH_KV_VMEM_CAP", 1024)
    opts = {**REP_OPTS, "num_ctx": 40}
    (cut,) = _batch(te, TRequest, [REP_PROMPT], opts)
    (jcut,) = _batch(je, JRequest, [REP_PROMPT], opts)
    assert cut.prompt_eval_count == jcut.prompt_eval_count == 39
    assert cut.token_ids == jcut.token_ids
    chunks = []
    mixed = te._mixed_chunk

    def spy(chunk, start, length, *rest):
        chunks.append((chunk.shape[0], start, length))
        return mixed(chunk, start, length, *rest)

    prompt = "the cat sat on the mat " * 2
    (cold,) = _batch(te, TRequest, [prompt], REP_OPTS)
    te._mixed_chunk = spy
    (warm,) = _batch(te, TRequest, [prompt], REP_OPTS)
    (jcold,) = _batch(je, JRequest, [prompt], REP_OPTS)
    (jwarm,) = _batch(je, JRequest, [prompt], REP_OPTS)
    assert warm.cached_tokens == jwarm.cached_tokens > 0
    assert chunks == [(64, warm.cached_tokens, warm.prompt_eval_count - warm.cached_tokens)]
    assert warm.token_ids == cold.token_ids == jwarm.token_ids == jcold.token_ids


# ---------------------------------------------------------------------------
# long positions and long prompts
# ---------------------------------------------------------------------------


def test_rope_llama3_scaling_at_long_positions_matches_jax():
    inv = np.array(JLY.precompute_rope(128, 500_000.0, JLY.RopeScaling()))
    np.testing.assert_allclose(
        TLY.precompute_rope(128, 500_000.0, TLY.RopeScaling()).numpy(), inv,
        rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(5).normal(size=(1, 5, 2, 128)).astype(np.float32)
    pos = np.asarray([[0, 8191, 8192, 32767, 131071]], np.int32)
    want = np.asarray(JLY.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv)))
    got = TLY.apply_rope(_t(x), _t(pos), _t(inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_chain_keys_of_a_32k_prompt_match_jax():
    """512 pages of 64 tokens: byte-identical chain keys, and a prompt that
    shares 24,000 tokens with a registered one matches the same pages."""
    ps, pages = 64, 512
    rng = np.random.default_rng(11)
    ids = [int(x) for x in rng.integers(0, 128_256, size=pages * ps)]
    talloc = TC.PageAllocator(1280, ps, pages, cache_pages=-1)
    jalloc = JC.PageAllocator(1280, ps, pages, cache_pages=-1)
    tkeys, jkeys = talloc.chain_keys(ids, pages), jalloc.chain_keys(ids, pages)
    assert len(tkeys) == pages and tkeys == jkeys
    for alloc in (talloc, jalloc):
        assert alloc.alloc(0, len(ids)) is not None
        alloc.free(0, ids)
    other = ids[:24_000] + [int(x) for x in rng.integers(0, 128_256, size=2_000)]
    t_hit, j_hit = talloc.match_prefix(1, other), jalloc.match_prefix(1, other)
    assert t_hit == j_hit == (24_000 // ps) * ps
    assert talloc.table_row(1)[:t_hit // ps] == [talloc._page_by_key[key]
                                                 for key in tkeys[:t_hit // ps]]


@pytest.mark.parametrize("name", ["llama3.1:8b", "mistral:7b", "mistral-nemo:12b"])
def test_long_context_configs_match_jax(name):
    t, j = TCFG.get_config(name), JCFG.get_config(name)
    for field in dataclasses.fields(t):
        value, want = getattr(t, field.name), getattr(j, field.name)
        if field.name == "rope_scaling":
            value = value and dataclasses.astuple(value)
            want = want and dataclasses.astuple(want)
        assert value == want, (name, field.name)
    assert t.head_dim_ == j.head_dim_ == 128
    assert t.max_seq_len >= 32_768


def test_nemo_head_layout_forward_matches_jax():
    """mistral-nemo's head_dim (128) differs from hidden / heads: a 2-layer
    cut at narrow widths keeps that, with its weights carried across with
    params_from_jax."""
    cut = dict(vocab_size=512, hidden_size=320, intermediate_size=256, num_layers=2,
               num_heads=4, num_kv_heads=2, max_seq_len=4096)
    jcfg = dataclasses.replace(JCFG.get_config("mistral-nemo:12b"), **cut)
    tcfg = dataclasses.replace(TCFG.get_config("mistral-nemo:12b"), **cut)
    assert tcfg.head_dim_ == 128 != tcfg.hidden_size // tcfg.num_heads
    params = JL.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    model = TL.Llama(tcfg, dtype=torch.float32, device="cpu").params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    tokens = np.random.default_rng(2).integers(0, 512, size=(1, 24)).astype(np.int32)
    want = np.asarray(JL.forward(params, jcfg, jnp.asarray(tokens)))
    got = model(_t(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
