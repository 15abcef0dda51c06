"""One rank of a two-process tensor-parallel group of the torch package,
for tests/test_torch_parallel.py: gloo on the CPU, tiny models, float32.

    python tests/torch_tp_child.py RANK WORLD PORT WORKDIR

Reads WORKDIR/params_<model>.npz (a JAX-layout pytree, "/"-joined keys)
and writes WORKDIR/rank<RANK>.npz: each model's cache-free forward logits
under MeshConfig(tp=WORLD), the paged prefill-plus-decode greedy tokens of
the JAX package's sharded pipeline test, and a tp engine's greedy streams
(speculative decoding and ragged attention on). Imports nothing of JAX.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine  # noqa: E402
from gridllm_torch.models.configs import get_config  # noqa: E402
from gridllm_torch.models.llama import Llama  # noqa: E402
from gridllm_torch.ops.kvcache import PageAllocator, PagedKVCache  # noqa: E402
from gridllm_torch.parallel import GroupConfig, MeshConfig, build_mesh  # noqa: E402
from gridllm_torch.parallel import collectives, distributed  # noqa: E402

MODELS = ("tiny-llama", "tiny-qwen2")
TOKENS = [[5, 17, 99, 3, 42, 7, 250, 1]]
PROMPT = [5, 17, 99, 3, 42]
STREAM_PROMPTS = ("the quick brown fox", "abc abc abc abc abc abc abc abc abc abc abc")
ENGINE = dict(max_slots=4, page_size=8, num_pages=64, max_pages_per_slot=16,
              prefill_buckets=(16, 32), prefill_chunk=16, dtype="float32",
              spec_decode=True, spec_k=4, ragged_attention=True)


def load_params(path: Path) -> dict:
    flat = np.load(path)
    tree: dict = {"layers": {}}
    for key in flat.files:
        head, _, leaf = key.partition("/")
        if leaf:
            tree[head][leaf] = flat[key]
        else:
            tree[head] = flat[key]
    return tree


def paged_tokens(model: Llama) -> list[int]:
    """tests/test_parallel.py::test_sharded_prefill_decode_match_single_device's
    procedure: a 5-token prompt prefilled, then 4 greedy decode steps."""
    cfg = model.cfg
    cache = PagedKVCache.create(cfg.num_layers, 16, 8, model.n_kv_heads, cfg.head_dim_, 4, 8,
                                dtype=torch.float32, device="cpu")
    alloc = PageAllocator(16, 8, 8)
    alloc.alloc(0, 16)
    row = torch.tensor(alloc.table_row(0), dtype=torch.int32)
    padded = torch.tensor(PROMPT + [0] * 3, dtype=torch.int32)
    logits, cache = model.prefill(padded, len(PROMPT), cache, 0, row)
    out = [int(torch.argmax(logits))]
    tok = torch.zeros(cache.max_slots, dtype=torch.int32)
    tok[0] = out[0]
    active = torch.zeros(cache.max_slots, dtype=torch.bool)
    active[0] = True
    for _ in range(4):
        logits, cache = model.decode_step(tok, cache, active)
        out.append(int(torch.argmax(logits[0])))
        tok[0] = out[-1]
    return out


def main() -> None:
    rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    group = GroupConfig(coordinator=f"127.0.0.1:{port}", num_processes=world, process_id=rank)
    distributed.initialize_group(group, backend="gloo", timeout_s=120)
    mesh = build_mesh(MeshConfig(tp=world))
    out: dict[str, np.ndarray] = {}
    for name in MODELS:
        cfg = get_config(name)
        params = load_params(work / f"params_{name}.npz")
        model = Llama(cfg, dtype=torch.float32, device="cpu", mesh=mesh).params_from_jax(params)
        out[f"{name}/forward"] = model(torch.tensor(TOKENS)).numpy()
        out[f"{name}/paged"] = np.asarray(paged_tokens(model))
        out[f"{name}/heads"] = np.asarray([model.n_heads, model.n_kv_heads])
        collectives.reset_counts()
        eng = InferenceEngine(EngineConfig(model=name, mesh=MeshConfig(tp=world), **ENGINE),
                              device="cpu", params=params)
        for i, prompt in enumerate(STREAM_PROMPTS):
            res = eng.generate(GenerationRequest(
                id=f"s{i}", prompt=prompt,
                options={"temperature": 0, "num_predict": 12, "seed": 3}))
            out[f"{name}/stream{i}"] = np.asarray(res.token_ids)
        out[f"{name}/spec_steps"] = np.asarray(eng.spec_stats["steps"])
        out[f"{name}/all_reduce"] = np.asarray(collectives.CALLS["all_reduce"])
    np.savez(work / f"rank{rank}.npz", **out)
    distributed.shutdown_group(group)


if __name__ == "__main__":
    main()
