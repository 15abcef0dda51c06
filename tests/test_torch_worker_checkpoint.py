"""A torch worker serving a checkpoint directory, on the CPU.

GRIDLLM_CHECKPOINT_DIR laid out as `resolve_checkpoint` expects (weights and
tokenizer at {root}/{model name}): the worker's engine serves the model from
its safetensors and its trained tokenizer, behind the JAX scheduler on an
in-memory bus, with the text `transformers` generates from the same files.
Unloading the model parks its weights in the host snapshot tier, and a
reload answers "loaded (snapshot)" and serves the same text.
"""

import asyncio
import uuid

import pytest
import torch

from gridllm_torch.engine import loader as TLD
from gridllm_torch.utils.config import WorkerConfig as TWorkerConfig
from gridllm_torch.utils.config import load_config
from gridllm_torch.worker import main as wmain
from gridllm_torch.worker.service import WorkerService as TWorker
from gridllm_tpu.bus.memory import InMemoryBus
from gridllm_tpu.scheduler import JobScheduler, WorkerRegistry
from gridllm_tpu.utils.types import InferenceRequest
from tests.helpers import fast_config
from tests.test_torch_checkpoint import CORPUS

NAME = "local-tiny"


@pytest.fixture(scope="module")
def checkpoint_root(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    root = tmp_path_factory.mktemp("ckpt-root")
    path = root / NAME
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
    ids = [hf_tok.bos_token_id] + hf_tok.encode("the quick brown fox", add_special_tokens=False)
    with torch.no_grad():
        out = model.generate(input_ids=torch.tensor([ids]), max_new_tokens=12, do_sample=False,
                             eos_token_id=None, pad_token_id=hf_tok.eos_token_id)
    return root, hf_tok.decode(out[0][len(ids):].tolist(), skip_special_tokens=True)


async def test_worker_serves_checkpoint_and_reloads_from_the_snapshot_tier(
        checkpoint_root, monkeypatch):
    root, want_text = checkpoint_root
    monkeypatch.setenv("GRIDLLM_CHECKPOINT_DIR", str(root))
    monkeypatch.setenv("GRIDLLM_MODELS", NAME)
    monkeypatch.setenv("GRIDLLM_KV_PAGE_SIZE", "8")
    monkeypatch.setenv("GRIDLLM_PREFILL_BUCKETS", "16,32")
    monkeypatch.setenv("GRIDLLM_DTYPE", "float32")
    monkeypatch.setenv("GRIDLLM_WEIGHT_SNAPSHOT_BYTES", str(1 << 26))
    monkeypatch.delenv("GRIDLLM_ALLOW_SYNTHETIC_WEIGHTS", raising=False)
    TLD.reset_weight_snapshot_tier()
    cfg = load_config()
    assert wmain.resolve_checkpoint(cfg.engine.checkpoint_dir, NAME) == (
        str(root / NAME), str(root / NAME))
    eng = wmain.build_one_engine(cfg, NAME, device="cpu")
    assert eng.load_source == "checkpoint" and type(eng.tokenizer).__name__ == "HFTokenizer"

    sched_cfg = fast_config()
    bus = InMemoryBus()
    await bus.connect()
    registry = WorkerRegistry(bus, sched_cfg)
    scheduler = JobScheduler(bus, registry, sched_cfg)
    await registry.initialize()
    await scheduler.initialize()
    svc = TWorker(bus, {NAME: eng}, TWorkerConfig(worker_id="ckpt-w", heartbeat_interval_ms=150),
                  stream_flush_ms=5, engine_factory=wmain.pull_engine_factory(cfg, device="cpu"))

    async def serve():
        res = await scheduler.submit_and_wait(InferenceRequest(
            id=f"c-{uuid.uuid4().hex[:6]}", model=NAME, prompt="the quick brown fox",
            stream=False, options={"temperature": 0, "num_predict": 12}), timeout_ms=60_000)
        assert res.success, res.error
        return res.response.response

    try:
        await svc.start()
        for _ in range(500):
            if registry.get_all_workers():
                break
            await asyncio.sleep(0.01)
        assert await serve() == want_text

        assert await svc._admin_unload(NAME) == (True, "unloaded")
        tier = TLD.weight_snapshot_tier()
        assert tier.stats()["parks"] == 1 and eng.model is None
        assert NAME not in svc.engines

        assert await svc._admin_load(NAME) == (True, "loaded (snapshot)")
        assert svc.engines[NAME].load_source == "snapshot"
        assert tier.stats()["hits"] == 1
        for _ in range(500):
            models = {m.name for w in registry.get_all_workers()
                      for m in w.capabilities.availableModels}
            if NAME in models:
                break
            await asyncio.sleep(0.01)
        assert await serve() == want_text
        # a model without a checkpoint is still refused random weights
        with pytest.raises(ValueError, match="random weights"):
            wmain.pull_engine_factory(cfg, device="cpu")("tiny-llama")
    finally:
        await svc.stop(announce=False)
        await scheduler.shutdown()
        await registry.shutdown()
        await bus.disconnect()
        TLD.reset_weight_snapshot_tier()
