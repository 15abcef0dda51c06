"""Checkpoints in the PyTorch port against the JAX package, on the CPU.

- the port's safetensors reader against the `safetensors` library on F32,
  F16 and BF16 tensors over two shards, bit for bit (the library's BF16 read
  through `framework="pt"`: numpy has no bfloat16); its refusals of other
  dtypes and of offsets that overlap or run past the file, naming the file
  and the tensor; the writer read back by `safe_open`;
- `config_from_hf_dir` against the JAX package's on llama3 (rope_scaling),
  mistral, qwen2 and qwen3 config.json dicts, every field equal, and the
  refusals that name their ROADMAP items (bert and llava; a quantize mode
  other than int8); `hf_config()` read back;
- `load_checkpoint` against the JAX package's on tiny LlamaForCausalLM,
  Qwen2ForCausalLM and tied-embedding checkpoints saved by `transformers`,
  every leaf exactly equal at float32; the port's `save_checkpoint` read by
  the JAX loader (float32 files: the JAX loader reads through numpy);
- greedy streams of the port's engine on a real HF directory (trained BPE
  tokenizer, `LlamaForCausalLM`) equal to the JAX engine's and to
  `transformers` `generate`, as tests/test_real_checkpoint.py holds the
  JAX engine;
- the weight snapshot tier: `snapshot_key` strings and the tier's
  park/hit/miss/evict counts equal to the JAX package's; an engine parked
  and rebuilt restores from the tier with an equal stream;
- `draft_checkpoint` streams equal to those with the same `draft_params`;
  prewarm leaves the stream unchanged.
"""

import json
import os
import struct

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
from gridllm_torch.models import hf_layout as THF
from gridllm_torch.models import llama as TL
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.engine import loader as JLD
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import llama as JL

# tests/test_real_checkpoint.py's corpus, seed and widths: its prompts meet no
# near-tie of two logits between transformers' float32 forward and the engines'
CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "pack my box with five dozen liquor jugs. "
    "how vexingly quick daft zebras jump! "
    "sphinx of black quartz judge my vow. "
) * 8
SMALL = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_slot=16,
             prefill_buckets=(16, 32), prefill_chunk=16, dtype="float32")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_tree(model):
    return _leaves({k: ({n: t.detach().float().numpy() for n, t in v.items()}
                        if isinstance(v, dict) else v.detach().float().numpy())
                    for k, v in model.params_tree().items()})


# ---------------------------------------------------------------------------
# the safetensors reader and writer
# ---------------------------------------------------------------------------


def _shards(tmp_path):
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    a = {"a.f32": torch.randn((3, 5), generator=gen),
         "a.bf16": torch.randn((4, 7), generator=gen).to(torch.bfloat16),
         "a.f16": torch.randn((6,), generator=gen).to(torch.float16)}
    b = {"b.bf16": torch.randn((2, 3, 4), generator=gen).to(torch.bfloat16),
         "b.f32": torch.randn((1,), generator=gen),
         "b.scalar": torch.tensor(1.5, dtype=torch.float32)}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    return {**a, **b}


def test_reader_equals_safetensors_across_shards(tmp_path):
    from safetensors import safe_open

    tensors = _shards(tmp_path)
    idx = TLD._open_safetensors(str(tmp_path))
    assert sorted(idx.keys()) == sorted(tensors)
    for f in sorted(os.listdir(tmp_path)):
        with safe_open(str(tmp_path / f), framework="pt") as h:
            for name in h.keys():  # noqa: SIM118
                want, got = h.get_tensor(name), idx.get(name)
                assert got.dtype == want.dtype and got.shape == want.shape, name
                assert torch.equal(got.reshape(-1).view(torch.uint8),
                                   want.reshape(-1).view(torch.uint8)), name
    idx.close()


def _write_raw(path, header, data=b""):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["dtype", "overlap", "past_end", "size"])
def test_reader_refuses_bad_headers(tmp_path, case):
    fname = tmp_path / "bad.safetensors"
    header = {"x": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
              "y": {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}}
    if case == "dtype":
        header["y"]["dtype"] = "I64"
    elif case == "overlap":
        header["y"]["data_offsets"] = [4, 12]
        header["y"]["shape"] = [2]
    elif case == "past_end":
        header["y"]["data_offsets"] = [8, 24]
        header["y"]["shape"] = [4]
    else:
        header["y"]["shape"] = [3]
    _write_raw(fname, header, bytes(16))
    with pytest.raises(ValueError) as err:
        TLD._open_safetensors(str(tmp_path))
    assert "bad.safetensors" in str(err.value) and "'y'" in str(err.value)


def test_writer_read_back_by_safe_open(tmp_path):
    from safetensors import safe_open

    gen = torch.Generator().manual_seed(1)
    w = torch.randn((6, 4), generator=gen)
    tensors = {"t.T": w.T, "t.row": w[2], "t.bf16": w.to(torch.bfloat16)}
    TLD._save_safetensors(str(tmp_path / "x.safetensors"), tensors)
    with safe_open(str(tmp_path / "x.safetensors"), framework="pt") as h:
        assert sorted(h.keys()) == sorted(tensors)
        for name, t in tensors.items():
            assert torch.equal(h.get_tensor(name), t.contiguous()), name
    TLD._save_safetensors(str(tmp_path / "y.safetensors"), tensors, torch.bfloat16)
    with safe_open(str(tmp_path / "y.safetensors"), framework="pt") as h:
        for name, t in tensors.items():
            assert torch.equal(h.get_tensor(name), t.to(torch.bfloat16)), name


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

HF_DICTS = {
    "llama3": {"model_type": "llama", "vocab_size": 128256, "hidden_size": 2048,
               "intermediate_size": 8192, "num_hidden_layers": 16,
               "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
               "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
               "max_position_embeddings": 131072,
               "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                                "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192}},
    "mistral": {"model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096,
                "intermediate_size": 14336, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "rope_theta": 10000.0, "sliding_window": 4096,
                "max_position_embeddings": 32768},
    "qwen2": {"model_type": "qwen2", "vocab_size": 151936, "hidden_size": 896,
              "intermediate_size": 4864, "num_hidden_layers": 24,
              "num_attention_heads": 14, "num_key_value_heads": 2,
              "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
              "sliding_window": 32768, "use_sliding_window": False,
              "max_position_embeddings": 32768},
    "qwen3": {"model_type": "qwen3", "vocab_size": 151936, "hidden_size": 1024,
              "intermediate_size": 3072, "num_hidden_layers": 28,
              "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 128,
              "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
              "max_position_embeddings": 40960, "attention_bias": False},
}


@pytest.mark.parametrize("kind", sorted(HF_DICTS))
def test_config_from_hf_dir_equals_jax(tmp_path, kind):
    (tmp_path / "config.json").write_text(json.dumps(HF_DICTS[kind]))
    got = TCFG.config_from_hf_dir("local", str(tmp_path))
    want = JCFG.config_from_hf_dir("local", str(tmp_path))
    for field in ("name", "family", "vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim", "rope_theta",
                  "rms_eps", "tie_embeddings", "max_seq_len", "attn_logit_softcap",
                  "sliding_window", "attn_bias", "qk_norm"):
        assert getattr(got, field) == getattr(want, field), field
    if want.rope_scaling is None:
        assert got.rope_scaling is None
    else:
        assert vars(got.rope_scaling) == vars(want.rope_scaling)
    # hf_config() is the inverse: written and read back, the same config
    (tmp_path / "config.json").write_text(json.dumps(got.hf_config()))
    again = TCFG.config_from_hf_dir("local", str(tmp_path))
    assert again.head_dim_ == got.head_dim_
    assert dataclasses_equal(again, got)


def dataclasses_equal(a, b):
    import dataclasses

    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    da["head_dim"] = a.head_dim_
    db["head_dim"] = b.head_dim_
    return da == db


@pytest.mark.parametrize("model_type,item", [("bert", "ROADMAP A 8"),
                                             ("llava", "ROADMAP A 8")])
def test_config_refuses_unported_families(tmp_path, model_type, item):
    (tmp_path / "config.json").write_text(json.dumps(dict(HF_DICTS["llama3"],
                                                          model_type=model_type)))
    with pytest.raises(ValueError, match=item):
        TCFG.config_from_hf_dir("x", str(tmp_path))


def test_registered_configs_round_trip_through_hf_config(tmp_path):
    for name in ("llama3.2:1b", "llama3:8b", "llama3.1:8b", "qwen2.5:0.5b", "qwen3:0.6b",
                 "mistral:7b", "tiny-mistral", "tiny-qwen2", "tiny-qwen3"):
        cfg = TCFG.get_config(name)
        (tmp_path / "config.json").write_text(json.dumps(cfg.hf_config()))
        back = TCFG.config_from_hf_dir(name, str(tmp_path))
        assert dataclasses_equal(back, cfg), name
        jback = JCFG.config_from_hf_dir(name, str(tmp_path))
        assert (jback.family, jback.head_dim_, jback.sliding_window, jback.attn_bias,
                jback.qk_norm, jback.tie_embeddings) == (
            cfg.family, cfg.head_dim_, cfg.sliding_window, cfg.attn_bias, cfg.qk_norm,
            cfg.tie_embeddings), name


# ---------------------------------------------------------------------------
# loading against the JAX loader
# ---------------------------------------------------------------------------


def _hf_model(kind, path):
    from transformers import LlamaConfig, LlamaForCausalLM, Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(0)
    common = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  rope_theta=10_000.0)
    if kind == "qwen2":
        model = Qwen2ForCausalLM(Qwen2Config(**common))
    else:
        model = LlamaForCausalLM(LlamaConfig(tie_word_embeddings=kind == "tied", **common))
    model.save_pretrained(path, safe_serialization=True)
    return model


@pytest.mark.parametrize("kind", ["llama", "qwen2", "tied"])
def test_load_checkpoint_equals_jax_loader(tmp_path, kind):
    _hf_model(kind, tmp_path)
    tcfg = TCFG.config_from_hf_dir("local", str(tmp_path))
    jcfg = JCFG.config_from_hf_dir("local", str(tmp_path))
    assert tcfg.tie_embeddings == (kind == "tied")
    got = _port_tree(TLD.load_checkpoint(tcfg, str(tmp_path), torch.float32, "cpu"))
    want = _leaves(JLD.load_checkpoint(jcfg, str(tmp_path), jnp.float32))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert TL.hf_map(tcfg) == JL.hf_map(jcfg)
    # the inverse: to_hf_tensors of the loaded model gives back every file tensor
    from safetensors.torch import load_file

    back = THF.to_hf_tensors(TLD.load_checkpoint(tcfg, str(tmp_path), torch.float32,
                                                 "cpu").params_tree(), tcfg, TL.hf_map(tcfg))
    files = load_file(str(tmp_path / "model.safetensors"))
    assert sorted(back) == sorted(k for k in files if not (
        kind == "tied" and k == "lm_head.weight"))
    for name, t in back.items():
        assert torch.equal(t, files[name]), name


def test_quantized_load_is_refused(tmp_path):
    """int8 loads are served (tests/test_torch_quant.py); a mode other
    than int8 is refused before any file is read, as the JAX engine
    refuses it."""
    with pytest.raises(ValueError, match="unknown quantize mode: 'int4'"):
        TLD.load_checkpoint(TCFG.get_config("tiny-llama"), str(tmp_path), quantize="int4",
                            device="cpu")


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-qwen3"])
def test_save_checkpoint_read_by_jax_loader(tmp_path, model):
    je = JEngine(JConfig(model=model, **SMALL))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = TEngine(TConfig(model=model, **SMALL), device="cpu", params=params)
    TLD.save_checkpoint(te.model, te.cfg, str(tmp_path), torch.float32)
    jcfg = JCFG.config_from_hf_dir(model, str(tmp_path))
    back = _leaves(JLD.load_checkpoint(jcfg, str(tmp_path), jnp.float32))
    want = _leaves(params)
    assert sorted(back) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(back[name], want[name], err_msg=name)
    # and the JAX package's writer read by the port
    jdir = tmp_path / "jax"
    JLD.save_checkpoint(params, je.cfg, str(jdir))
    mine = _port_tree(TLD.load_checkpoint(te.cfg, str(jdir), torch.float32, "cpu"))
    for name in want:
        np.testing.assert_array_equal(mine[name], want[name], err_msg=name)


# ---------------------------------------------------------------------------
# serving a real HF directory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny real HF checkpoint: a trained byte-level BPE tokenizer and a
    LlamaForCausalLM saved with safetensors (tests/test_real_checkpoint.py's)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    path = tmp_path_factory.mktemp("hf-tiny")
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator([CORPUS], trainers.BpeTrainer(
        vocab_size=384, special_tokens=["<s>", "</s>"]))
    hf_tok = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>")
    hf_tok.save_pretrained(path)
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=len(hf_tok), hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=10_000.0,
        max_position_embeddings=256, tie_word_embeddings=False))
    model.save_pretrained(path, safe_serialization=True)
    return path, model, hf_tok


def _hf_greedy(model, hf_tok, prompt, n):
    ids = [hf_tok.bos_token_id] + hf_tok.encode(prompt, add_special_tokens=False)
    with torch.no_grad():
        out = model.generate(input_ids=torch.tensor([ids]), max_new_tokens=n, do_sample=False,
                             eos_token_id=None, pad_token_id=hf_tok.eos_token_id)
    return out[0][len(ids):].tolist()


PROMPTS = [("the quick brown fox", 12), ("pack my box", 10)]


@pytest.mark.parametrize("spec", [False, True])
def test_engine_on_hf_dir_equals_jax_and_transformers(hf_dir, spec):
    path, model, hf_tok = hf_dir
    cfg = dict(model="local-tiny-llama", checkpoint_path=str(path), tokenizer=str(path),
               spec_decode=spec, **SMALL)
    te = TEngine(TConfig(**cfg), device="cpu")
    assert te.load_source == "checkpoint" and te.cfg.vocab_size == len(hf_tok)
    je = JEngine(JConfig(**cfg))
    for i, (prompt, n) in enumerate(PROMPTS):
        opts = {"temperature": 0.0, "num_predict": n}
        got = te.generate(TRequest(id=f"t{i}", prompt=prompt, options=dict(opts)))
        want = je.generate(JRequest(id=f"j{i}", prompt=prompt, options=dict(opts)))
        hf = _hf_greedy(model, hf_tok, prompt, n)
        assert got.token_ids == want.token_ids == hf
        assert got.text == want.text == hf_tok.decode(hf, skip_special_tokens=True)


# ---------------------------------------------------------------------------
# the weight snapshot tier, drafts from a checkpoint, prewarm
# ---------------------------------------------------------------------------


@pytest.fixture
def tier_env(monkeypatch):
    def set_bytes(n):
        monkeypatch.setenv("GRIDLLM_WEIGHT_SNAPSHOT_BYTES", str(n))
        TLD.reset_weight_snapshot_tier()
        JLD.reset_weight_snapshot_tier()
    yield set_bytes
    TLD.reset_weight_snapshot_tier()
    JLD.reset_weight_snapshot_tier()


def test_tier_counts_equal_jax(tier_env):
    tier_env(3 * 4096)
    leaf = {"w": np.zeros((1024,), np.float32)}      # 4096 bytes
    big = {"w": np.zeros((4096,), np.float32)}       # past the capacity
    t, j = TLD.weight_snapshot_tier(), JLD.weight_snapshot_tier()
    ops = [("park", "a", leaf), ("park", "b", leaf), ("restore", "a"), ("restore", "c"),
           ("park", "c", leaf), ("park", "d", leaf), ("restore", "b"), ("park", "e", big),
           ("park", "a", leaf), ("restore", "a"), ("restore", "d")]
    for op, key, *arg in ops:
        if op == "park":
            got = t.park(key, {k: torch.from_numpy(v) for k, v in arg[0].items()})
            assert got == j.park(key, arg[0]), (op, key)
        else:
            assert (t.restore(key) is None) == (j.restore(key) is None), (op, key)
        assert t.stats() == j.stats(), (op, key)
    assert t.stats()["evictions"] >= 1 and t.stats()["misses"] >= 1


@pytest.mark.parametrize("model,extra", [
    ("tiny-llama", {}), ("tiny-qwen2", {"checkpoint_path": "/ckpt/q"}),
    ("llama3:8b", {"dtype": "bfloat16", "checkpoint_path": "/x/y"})])
def test_snapshot_key_equals_jax(model, extra):
    cfg = dict(dict(model=model, dtype="float32"), **extra)
    tcfg = TConfig(**cfg)
    got = TEngine.snapshot_key(type("E", (), {"config": tcfg, "cfg": TCFG.get_config(model)})())
    want = JEngine.snapshot_key(type("E", (), {"config": JConfig(**cfg),
                                               "cfg": JCFG.get_config(model)})())
    assert got == want


def _stream(engine, prompt="ab ab ab ab ab ab and the quick brown fox"):
    res = engine.generate(TRequest(id="s", prompt=prompt,
                                   options={"temperature": 0, "num_predict": 16}))
    return res.token_ids, res.text


def test_parked_engine_restores_from_the_tier(tmp_path, tier_env):
    src = TEngine(TConfig(model="tiny-llama", **SMALL), device="cpu")
    TLD.save_checkpoint(src.model, src.cfg, str(tmp_path), torch.float32)
    want = _stream(src)
    cfg = TConfig(model="tiny-llama", checkpoint_path=str(tmp_path), **SMALL)
    tier_env(0)
    assert TEngine(cfg, device="cpu").park_weights() is False   # the tier is off
    tier_env(1 << 24)
    first = TEngine(cfg, device="cpu")
    assert first.load_source == "checkpoint" and _stream(first) == want
    weights = sum(p.numel() * p.element_size() for p in first.model.parameters())
    assert first.park_weights() is True and first.model is None
    tier = TLD.weight_snapshot_tier()
    assert tier.stats()["parks"] == 1 and tier.stats()["bytes"] == weights
    again = TEngine(cfg, device="cpu")
    assert again.load_source == "snapshot"
    assert tier.stats()["hits"] == 1
    assert _stream(again) == want
    for (n, p), (_, q) in zip(src.model.named_parameters(), again.model.named_parameters()):
        assert torch.equal(p, q), n


def test_snapshot_restore_fault_falls_back_to_the_checkpoint(tmp_path, tier_env):
    from gridllm_torch import faults

    src = TEngine(TConfig(model="tiny-llama", **SMALL), device="cpu")
    TLD.save_checkpoint(src.model, src.cfg, str(tmp_path), torch.float32)
    tier_env(1 << 24)
    cfg = TConfig(model="tiny-llama", checkpoint_path=str(tmp_path), **SMALL)
    assert TEngine(cfg, device="cpu").park_weights()
    faults.configure("swap.snapshot_restore=@1", seed=0)
    try:
        eng = TEngine(cfg, device="cpu")
    finally:
        faults.reset()
    assert eng.load_source == "checkpoint" and _stream(eng) == _stream(src)


def test_draft_checkpoint_equals_draft_params(tmp_path):
    je = JEngine(JConfig(model="tiny-llama", **SMALL))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    draft = TL.Llama(TCFG.get_config("tiny-llama"), dtype=torch.float32, device="cpu")
    draft.init_params(torch.Generator().manual_seed(5))
    TLD.save_checkpoint(draft, draft.cfg, str(tmp_path), torch.float32)
    dparams = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
                   else v.detach().numpy()) for k, v in draft.params_tree().items()}
    base = dict(model="tiny-llama", draft_model="tiny-llama", **SMALL)
    by_params = TEngine(TConfig(**base), device="cpu", params=params, draft_params=dparams)
    by_file = TEngine(TConfig(draft_checkpoint=str(tmp_path), **base), device="cpu",
                      params=params)
    for eng in (by_params, by_file):
        assert eng._drafter.kind == "model"
    a, b = _stream(by_params), _stream(by_file)
    assert a == b
    assert by_params.spec_stats == dict(by_file.spec_stats, draft_ns=by_params.spec_stats[
        "draft_ns"])
    assert by_file.spec_stats["proposed"] > 0


def test_prewarm_keeps_the_stream(monkeypatch):
    cold = TEngine(TConfig(model="tiny-llama", **SMALL), device="cpu")
    assert cold.prewarm_duration_ns == 0
    monkeypatch.setenv("GRIDLLM_PREWARM_COMPILES", "1")
    warm = TEngine(TConfig(model="tiny-llama", **SMALL), device="cpu")
    assert warm.prewarm_duration_ns > 0
    assert not warm.active_requests and not warm.queued_requests
    assert _stream(warm) == _stream(cold)
