"""Every family and mode a tensor-parallel group of the torch package
serves beyond the llama family's default path, held against the JAX
package's engine under a tp = 2 mesh on the CPU.

One two-process gloo launch (tests/torch_tp_modes_child.py, tp = 2,
float32, tiny configs, one thread a rank) runs the modes in sequence;
generation runs as a worker group does, rank 0 serving and recording its
plan, rank 1 replaying it. The JAX side (engines under
MeshConfig(dp=-1, tp=2), whose weights the ranks and an unmeshed port
engine take) is computed once for the module:

- cache-free forward within 1e-5 of the JAX model's on both ranks:
  tiny-gemma2 (softcaps, the sliding window, the tied vocab-split head,
  the sums before the post-norms) and tiny-llava over an image's spliced
  embeddings (the tower split by its heads);
- greedy streams equal to the JAX engine's and to the unmeshed port
  engine's: tiny-gemma2; tiny-llava with an image; tiny-llama with int8
  weights; tiny-llama with per-phase attention (GRIDLLM_RAGGED_ATTN=0 on
  the JAX side, speculation off: paged_decode and prefix_chunk); tiny-llama
  with draft_model="tiny-llama" (the draft model on rank 0 only, its
  trees reaching rank 1 as verify_tree records); tiny-llama with the
  prefix cache and a second request sharing the first's prefix (cached > 0
  in the admit record each rank dispatched);
- the follower's replicated device state (tokens, lengths, page table,
  penalty state, sampler steps) equal to the liaison's after every mode;
- tiny-bert embeddings within 1e-5 of the JAX engine's on both ranks;
- each rank's worker advertising every engine as tensor parallel, llava
  with vision, the int8 engine at Q8_0.
"""

import base64
import dataclasses
import io
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine
from gridllm_torch.engine.images import preprocess_images
from gridllm_torch.ops.quant import QuantizedTensor
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.models import gemma as jgemma
from gridllm_tpu.models import llava as jllava
from gridllm_tpu.models.configs import get_config as jget_config
from gridllm_tpu.parallel import MeshConfig as JMesh

CHILD = Path(__file__).with_name("torch_tp_modes_child.py")
REPO = CHILD.parent.parent
CHILD_TIMEOUT_S = 300
TOL = 1e-5
TINY = dict(max_slots=4, page_size=8, num_pages=64, max_pages_per_slot=16,
            prefill_buckets=(16, 32), prefill_chunk=16, dtype="float32")
OPTS = {"temperature": 0, "num_predict": 10}
LONG = "the quick brown fox jumps over the lazy dog"   # > prefill_chunk: chunks
IMG = 250   # tiny-llava's image token


def _png(seed: int, h: int, w: int) -> str:
    """A base64 PNG of random pixels (PIL writes it)."""
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _req(prompt, **kw):
    return dict(prompt=prompt, options=dict(OPTS), **kw)


# mode → (model, engine settings of both packages, the JAX side's
# GRIDLLM_RAGGED_ATTN, requests); the forward modes add a token row
MODES = {
    "gemma2": ("tiny-gemma2", {}, "1", [_req("hello gemma"), _req(LONG)]),
    "llava": ("tiny-llava", {}, "1",
              [_req("describe this", images=[_png(1, 30, 40)]), _req(LONG)]),
    "int8": ("tiny-llama", {"quantize": "int8"}, "1", [_req("abc abc abc abc"), _req(LONG)]),
    "per_phase": ("tiny-llama", {"ragged_attention": False, "spec_decode": False}, "0",
                  [_req("hello world"), _req(LONG)]),
    "draft": ("tiny-llama", {"draft_model": "tiny-llama", "spec_k": 4}, "1",
              [_req("abc abc abc abc abc"), _req(LONG)]),
    "prefix": ("tiny-llama", {"prefix_cache": True}, "1",
               [_req(LONG + " once"), _req(LONG + " twice")]),
}
FORWARD = {"gemma2": [[5, 17, 99, 3, 42, 7, 250, 1, 9, 11, 13]],
           "llava": [[1, 7, 9] + [IMG] * 4 + [11, 12, 13]]}
BERT_TEXTS = ["a short text", "a somewhat longer text to embed", "x"]
FORWARD_PNG = _png(5, 28, 28)


def _np(tree):
    """A JAX pytree as numpy, int8 pairs as the port's QuantizedTensor."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if hasattr(tree, "q"):
        return QuantizedTensor(np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


def _jax_engine(model: str, engine: dict, ragged: str) -> JEngine:
    fields = {f.name for f in dataclasses.fields(JConfig)}
    kw = {k: v for k, v in {**TINY, **engine}.items() if k in fields}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRIDLLM_RAGGED_ATTN", ragged)
        return JEngine(JConfig(model=model, mesh=JMesh(dp=-1, tp=2), **kw))


def _jax_forward(name: str, params, pixels) -> np.ndarray:
    cfg = jget_config(MODES[name][0])
    tokens = jnp.asarray(FORWARD[name], jnp.int32)
    if name == "gemma2":
        return np.asarray(jgemma.forward(params, cfg, tokens))
    flat = jllava.encode_images(params, cfg, jnp.asarray(pixels)).reshape(-1, cfg.hidden_size)
    embeds = jllava.splice_embeds(params, cfg, tokens[0], flat)
    return np.asarray(jllava.forward(params, cfg, tokens, embeds=embeds[None]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_group(work: Path, weights: dict) -> list:
    """Start the two ranks on every mode with the JAX engines' weights."""
    modes = {}
    for name, (model, engine, _, requests) in MODES.items():
        side = weights[name]
        spec = {"model": model, "engine": {**TINY, **engine}, "params": side["params"],
                "requests": requests}
        if "draft_params" in side:
            spec["draft_params"] = side["draft_params"]
        if name in FORWARD:
            spec["forward"] = {"tokens": FORWARD[name], "pixels": side["pixels"]}
        modes[name] = spec
    modes["bert"] = {"model": "tiny-bert", "engine": dict(TINY),
                     "params": weights["bert"]["params"], "texts": BERT_TEXTS}
    (work / "modes.pkl").write_bytes(pickle.dumps(modes))
    port, store_port = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(2):
        log = open(work / f"rank{rank}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, str(CHILD), str(rank), "2", str(port), str(store_port),
             str(work)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engines under a tp = 2 mesh give the weights; the two-rank
    group starts on them at once and runs while the JAX side computes its
    streams, forwards and embeddings. Returns (JAX side, each rank's
    report)."""
    work = tmp_path_factory.mktemp("tp_modes")
    engines = {name: _jax_engine(model, engine, ragged)
               for name, (model, engine, ragged, _) in MODES.items()}
    engines["bert"] = _jax_engine("tiny-bert", {}, "1")
    side = {name: {"params": _np(je.params)} for name, je in engines.items()}
    side["draft"]["draft_params"] = _np(engines["draft"]._drafter.params)
    side["llava"]["pixels"] = preprocess_images(
        [FORWARD_PNG], jget_config("tiny-llava").vision_cfg.image_size)
    side["gemma2"]["pixels"] = None
    procs = _start_group(work, side)
    try:
        for name, (model, _, ragged, requests) in MODES.items():
            je = engines[name]
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("GRIDLLM_RAGGED_ATTN", ragged)
                side[name]["results"] = [je.generate(JRequest(id=f"{name}{i}", **dict(
                    r, options=dict(r["options"])))) for i, r in enumerate(requests)]
            if name in FORWARD:
                side[name]["forward"] = _jax_forward(
                    name, jax.tree_util.tree_map(np.asarray, je.params), side[name]["pixels"])
        side["bert"]["embeddings"] = np.asarray(engines["bert"].embed(BERT_TEXTS))
        for p, _ in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(procs):
        log.seek(0)
        assert p.returncode == 0, f"rank {rank}: {log.read()[-4000:]}"
        log.close()
    return side, [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(2)]


@pytest.fixture(scope="module")
def jax_side(runs):
    """Per mode: the JAX engine's weights (numpy), results and forward
    logits; tiny-bert's weights and embeddings."""
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


def _unmeshed(name: str, side: dict):
    model, engine, _, requests = MODES[name]
    eng = InferenceEngine(EngineConfig(model=model, **TINY, **engine), device="cpu",
                          params=side["params"], draft_params=side.get("draft_params"))
    return [eng.generate(GenerationRequest(id=f"{name}{i}", **dict(r, options=dict(
        r["options"])))) for i, r in enumerate(requests)]


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_tp_forward_matches_jax(jax_side, ranks, name):
    want = jax_side[name]["forward"]
    for out in ranks:
        np.testing.assert_allclose(out[name]["forward"], want, rtol=TOL, atol=TOL)
        assert out[name]["heads"] == [2, 1]   # tp = 2 of 4 q and 2 kv heads


@pytest.mark.parametrize("name", sorted(MODES))
def test_tp_streams_match_jax_and_unmeshed(jax_side, ranks, name):
    """Rank 0's greedy streams (the group's: rank 1 replayed them) equal the
    JAX engine's under tp = 2 and an unmeshed port engine's."""
    want = jax_side[name]["results"]
    plain = _unmeshed(name, jax_side[name])
    got = ranks[0][name]["results"]
    for w, p, g in zip(want, plain, got):
        assert w.done_reason in ("stop", "length") and not p.error
        assert g["tokens"] == list(w.token_ids) == list(p.token_ids)
        assert g["cached"] == w.cached_tokens == p.cached_tokens
    assert all(ranks[r][name]["collectives"]["all_reduce"] > 0 for r in range(2))


@pytest.mark.parametrize("name", sorted(MODES))
def test_tp_follower_replays_to_the_liaisons_state(ranks, name):
    """The follower, replaying the liaison's records, holds the same
    replicated state and dispatched the same admits."""
    lead, follow = ranks[0][name], ranks[1][name]
    assert follow["admits"] == lead["admits"] and len(lead["admits"]) == len(MODES[name][3])
    for key, value in lead["state"].items():
        np.testing.assert_array_equal(follow["state"][key], value, err_msg=key)


def test_tp_mode_specifics(ranks):
    """What each mode must have run: the warm prefix hit replayed with
    cached > 0 on both ranks; the draft model on the liaison only, its
    trees reaching the follower as verify_tree records; per-phase decode
    blocks; an image admit."""
    for out in ranks:
        assert out["prefix"]["admits"][0] == 0 and out["prefix"]["admits"][1] > 0
    assert ranks[0]["draft"]["drafter"] == "model" and ranks[1]["draft"]["drafter"] == "ngram"
    assert "verify_tree" in ranks[1]["draft"]["ops"]
    assert "verify" not in ranks[1]["draft"]["ops"]
    assert "block" in ranks[1]["per_phase"]["ops"]
    assert "verify" in ranks[1]["int8"]["ops"]
    # each rank parks its own slices: the weight snapshot keys differ
    keys = [out["int8"]["snapshot_key"] for out in ranks]
    assert keys[0] != keys[1] and all("|int8|" in k for k in keys)


def test_tp_group_advertises_what_one_card_serves(ranks):
    """Each rank's worker advertises every engine as tensor parallel over
    tp = 2, llava with its vision capability and the int8 engine at Q8_0,
    as one card advertises them."""
    for out in ranks:
        for name, got in out.items():
            adv = got["advertised"]
            assert adv["strategy"] == "tensor" and adv["meshAxes"]["tp"] == 2, name
            assert adv["vision"] == (name == "llava"), name
            assert (adv["quantization"] == "Q8_0") == (name == "int8"), name


def test_tp_bert_embeddings_match_jax(jax_side, ranks):
    want = jax_side["bert"]["embeddings"]
    plain = InferenceEngine(EngineConfig(model="tiny-bert", **TINY), device="cpu",
                            params=jax_side["bert"]["params"]).embed(BERT_TEXTS)
    np.testing.assert_allclose(np.asarray(plain), want, rtol=TOL, atol=TOL)
    for out in ranks:
        np.testing.assert_allclose(out["bert"]["embeddings"], want, rtol=TOL, atol=TOL)
        assert out["bert"]["collectives"]["all_reduce"] > 0
