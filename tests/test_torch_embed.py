"""The embeddings path of the PyTorch port against the JAX package at float32.

`models.bert_embed` (hidden states with the padding keys masked, both
pooling modes), the decoder families' `hidden_states` (tiny-llama,
tiny-gemma2, tiny-mixtral) and the engine's `embed` for each tiny family:
batched equal to one text at a time, and equal to the JAX engine's vectors
on the same weights, all within 1e-4. Then the embedding-only engine (no
pool, generation refused with the JAX wording), `embed` beside a live
runner and under a foreign profiler capture, the new catalog entries and
HF configs, and bert checkpoints in both HF namings (with and without the
"bert." prefix) against the JAX loader.
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.engine import loader as TLOAD
from gridllm_torch.engine.tokenizer import ByteTokenizer as TByte
from gridllm_torch.models import bert_embed as TB
from gridllm_torch.models import configs as TCFG
from gridllm_torch.models.bert_embed import BertEmbed
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.engine import loader as JLOAD
from gridllm_tpu.engine.tokenizer import ByteTokenizer as JByte
from gridllm_tpu.models import bert_embed as JB
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import gemma as JG
from gridllm_tpu.models import llama as JL
from gridllm_tpu.models import mixtral as JM

TOL = 1e-4
FAMILIES = {"tiny-llama": JL, "tiny-gemma2": JG, "tiny-mixtral": JM}
# mixed lengths: rows of 1 token (the empty text's BOS), a padded batch
# bucket (6 texts in a bucket of 16), and two length buckets
TEXTS = ["", "a", "hello world", "the quick brown fox jumps over the lazy dog",
         "embeddings " * 9, "x" * 70, "tiny", "a longer sentence for the second bucket " * 2]
ENGINE = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_slot=16,
              prefill_buckets=(16, 64, 128), dtype="float32", seed=3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed=0, b=4, t=12):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 256, (b, t)).astype(np.int32)
    lens = np.array([t, 5, 1, 9][:b], np.int32)
    return tok, lens


def test_bert_hidden_states_and_pooling_match_jax():
    jcfg, tcfg = JCFG.get_config("tiny-bert"), TCFG.get_config("tiny-bert")
    params = JB.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    model = BertEmbed(tcfg, dtype=torch.float32, device="cpu").params_from_jax(_np(params))
    tok, lens = _tokens()
    want = np.asarray(JB.hidden_states(params, jcfg, jnp.asarray(tok), jnp.asarray(lens)))
    got = model.hidden_states(torch.from_numpy(tok), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the padding keys are masked: a row's valid states do not see its padding
    tok2 = tok.copy()
    tok2[1, 5:] = 7
    again = model.hidden_states(torch.from_numpy(tok2), torch.from_numpy(lens))
    np.testing.assert_allclose(again[1, :5].numpy(), got[1, :5].numpy(), rtol=0, atol=1e-6)
    for mode in ("mean", "cls"):
        jp = np.asarray(JB.pool(jnp.asarray(want), jnp.asarray(lens), mode))
        tp = TB.pool(got, torch.from_numpy(lens), mode).numpy()
        np.testing.assert_allclose(tp, jp, rtol=0, atol=TOL)
        np.testing.assert_allclose(np.linalg.norm(tp, axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_decoder_hidden_states_match_jax(name):
    """Final-norm hidden states at [B, T] with a length per row (and with
    `embeds` in place of the lookup): the valid rows within 1e-4."""
    jcfg, tcfg = JCFG.get_config(name), TCFG.get_config(name)
    mod = FAMILIES[name]
    params = mod.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32)
    model = TLOAD.model_class(tcfg)(tcfg, dtype=torch.float32,
                                    device="cpu").params_from_jax(_np(params))
    tok, lens = _tokens(1)
    want = np.asarray(mod.hidden_states(params, jcfg, jnp.asarray(tok),
                                        seq_lens=jnp.asarray(lens)))
    got = model.hidden_states(torch.from_numpy(tok), torch.from_numpy(lens)).numpy()
    valid = np.arange(tok.shape[1])[None] < lens[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=TOL)
    embeds = model._embed(torch.from_numpy(tok))
    if name == "tiny-gemma2":   # given rows take gemma's sqrt(E) normalizer too
        embeds = embeds / float(np.sqrt(tcfg.hidden_size))
    same = model.hidden_states(torch.from_numpy(tok), torch.from_numpy(lens), embeds=embeds)
    np.testing.assert_allclose(same.numpy()[valid], got[valid], rtol=0, atol=1e-5)


def _engines(name, **kw):
    je = JEngine(JConfig(model=name, **ENGINE, **kw))
    te = TEngine(TConfig(model=name, **ENGINE, **kw), device="cpu", params=_np(je.params))
    return je, te


@pytest.mark.parametrize("name", ["tiny-bert", *sorted(FAMILIES)])
def test_engine_embed_matches_jax(name):
    """engine.embed: batched equal to one at a time, and equal to the JAX
    engine's vectors, within 1e-4; unit norm."""
    je, te = _engines(name, embed_batch=16)
    assert te.embedding_only == je.embedding_only == (name == "tiny-bert")
    got = np.asarray(te.embed(TEXTS))
    want = np.asarray(je.embed(TEXTS))
    assert got.shape == (len(TEXTS), te.cfg.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    one = np.asarray([te.embed([t])[0] for t in TEXTS[:4]])
    np.testing.assert_allclose(one, got[:4], rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_embedding_only_engine_refuses_generation_like_jax():
    je, te = _engines("tiny-bert")
    assert te.free_slot_count == 0 and not te.kv_transfer_supported()
    assert te.memory_arrays()["alloc"] is None and te.batch_state()["embeddingOnly"]
    assert not hasattr(te, "cache") and te.host_tier is None
    te.start()
    assert not te.running
    out = {}
    for kind, eng, cls in (("torch", te, TRequest), ("jax", je, JRequest)):
        eng.submit(cls(id="gen", prompt="hi", options={"num_predict": 2},
                       on_chunk=lambda d, done, r, k=kind: done and out.setdefault(k, r)))
    assert out["torch"].done_reason == out["jax"].done_reason == "error"
    assert out["torch"].error == out["jax"].error
    assert not out["torch"].retryable and not out["jax"].retryable
    with pytest.raises(ValueError, match="quantize is not supported"):
        TEngine(TConfig(model="tiny-bert", quantize="int8", **ENGINE), device="cpu")


def test_embed_beside_a_live_runner_and_under_a_foreign_capture():
    """With the runner live, embed batches run on it between steps while a
    generation decodes: the vectors equal the synchronous ones and the
    generation equals its run alone. Under a profiler capture that no
    engine's profile() started, embed raises."""
    _, te = _engines("tiny-llama", spec_decode=False)
    want = np.asarray(te.embed(TEXTS))
    opts = {"temperature": 0, "num_predict": 40}
    alone = te.generate(TRequest(id="alone", prompt="decode beside embeds", options=opts))
    te.start()
    try:
        box = {}
        gen = threading.Thread(target=lambda: box.setdefault("r", te.generate(
            TRequest(id="beside", prompt="decode beside embeds", options=opts))))
        gen.start()
        got = [np.asarray(te.embed(TEXTS)) for _ in range(3)]
        gen.join(60)
        assert box["r"].token_ids == alone.token_ids
        for g in got:
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)
    finally:
        te.stop()
    bert = TEngine(TConfig(model="tiny-bert", **ENGINE), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="profile"):
            bert.embed(["under a capture"])
    assert len(bert.embed(["after it"])[0]) == bert.cfg.hidden_size


def test_encode_for_embedding_matches_jax():
    for text in ("", "abc", "longer text " * 20):
        for max_len in (None, 8):
            assert TByte(256).encode_for_embedding(text, max_len) == \
                JByte(256).encode_for_embedding(text, max_len)


# ---------------------------------------------------------------------------
# configs and checkpoints
# ---------------------------------------------------------------------------

NEW = ("llava:7b", "llava:13b", "all-minilm", "mxbai-embed-large", "tiny-bert", "tiny-llava")


@pytest.mark.parametrize("name", NEW)
def test_catalog_entries_equal_jax(name):
    got = dataclasses.asdict(TCFG.get_config(name))
    want = dataclasses.asdict(JCFG.get_config(name))
    want.pop("use_pallas")
    assert got == want


@pytest.mark.parametrize("name", ["tiny-bert", "mxbai-embed-large", "tiny-llava", "llava:7b"])
def test_hf_config_round_trips_and_reads_like_jax(tmp_path, name):
    """hf_config() written and read back is the config (bert's pooling is
    not in its config.json, in either package); the JAX reader makes the
    same config of it."""
    cfg = TCFG.get_config(name)
    (tmp_path / "config.json").write_text(json.dumps(cfg.hf_config()))
    back = TCFG.config_from_hf_dir(name, str(tmp_path))
    assert (dataclasses.replace(back, pooling=cfg.pooling, head_dim=back.head_dim_)
            == dataclasses.replace(cfg, head_dim=cfg.head_dim_))
    want = dataclasses.asdict(JCFG.config_from_hf_dir(name, str(tmp_path)))
    want.pop("use_pallas")
    got = dataclasses.asdict(back)
    if cfg.family == "llava":   # the port writes head_dim; the JAX reader reads it
        want["head_dim"] = got["head_dim"]
    assert got == want


def _hf_bert(path, prefixed: bool):
    """A BERT checkpoint of tiny-bert in HF names, written from the JAX
    package's layout contract (`to_hf_tensors`): BertModel's names, or
    with prefixed the "bert."-prefixed names of a BertFor* model plus a
    head tensor this loader ignores."""
    from safetensors.numpy import save_file

    jcfg = JCFG.get_config("tiny-bert")
    params = JB.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    # non-trivial norms and biases, so a leaf read from the wrong name shows
    rng = np.random.default_rng(4)
    tensors = {k: (v + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
               for k, v in JB.to_hf_tensors(params, jcfg).items()}
    if prefixed:
        tensors = {"bert." + k: v for k, v in tensors.items()}
        tensors["cls.predictions.bias"] = np.zeros(jcfg.vocab_size, np.float32)
    path.mkdir()
    save_file(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(TCFG.get_config("tiny-bert").hf_config()))


@pytest.mark.parametrize("prefixed", [False, True], ids=["BertModel", "bert-prefixed"])
def test_bert_checkpoint_loads_like_jax_and_round_trips(tmp_path, prefixed):
    _hf_bert(tmp_path / "hf", prefixed)
    jcfg, tcfg = JCFG.get_config("tiny-bert"), TCFG.get_config("tiny-bert")
    want = _np(JLOAD.load_checkpoint(jcfg, str(tmp_path / "hf"), dtype=jnp.float32))
    model = TLOAD.load_checkpoint(tcfg, str(tmp_path / "hf"), dtype=torch.float32,
                                  device="cpu")
    got = {k: v.numpy() for k, v in model.params_tree().items() if k != "layers"}
    got["layers"] = {k: v.numpy() for k, v in model.params_tree()["layers"].items()}
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b), got, want)
    TLOAD.save_checkpoint(model, tcfg, str(tmp_path / "out"), dtype=torch.float32)
    again = TLOAD.load_checkpoint(TCFG.config_from_hf_dir("local", str(tmp_path / "out")),
                                  str(tmp_path / "out"), dtype=torch.float32, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n
