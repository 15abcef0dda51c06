"""One rank of a two-process tensor-parallel group of the torch package,
for tests/test_torch_tp_modes.py: gloo on the CPU, tiny models, float32,
every family and mode a group serves beyond tests/torch_tp_child.py's.

    python tests/torch_tp_modes_child.py RANK WORLD PORT STORE_PORT WORKDIR

Reads WORKDIR/modes.pkl (per mode: the model, the engine settings, the
JAX-layout weights as numpy trees, the requests) and writes
WORKDIR/rank<RANK>.pkl. Per mode:

- a generation mode runs as a worker group does: rank 0, the liaison,
  serves the requests and hands each plan record to the group's TCP store
  (STORE_PORT) before its dispatch; rank 1 replays them in order with
  `apply_plan_op` and never reads a result. Each rank reports the device
  state every rank holds whole (tokens, lengths, page table, penalty
  counts and window, sampler steps), rank 0 its streams and each rank the
  `cached` of the admit records it dispatched;
- a mode with `forward` also runs the cache-free forward on both ranks
  (with an image's spliced embeddings for llava);
- the embeddings mode runs `embed` on both ranks.

Each rank also reports what its worker would advertise of each engine
(`gather_capabilities`).

Imports nothing of JAX.
"""

import datetime
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine  # noqa: E402
from gridllm_torch.engine.loader import model_class  # noqa: E402
from gridllm_torch.models.configs import get_config  # noqa: E402
from gridllm_torch.parallel import GroupConfig, MeshConfig, build_mesh  # noqa: E402
from gridllm_torch.parallel import collectives, distributed  # noqa: E402
from gridllm_torch.worker.capabilities import gather_capabilities  # noqa: E402

END = {"op": "end"}          # the liaison's last record of a mode
STATE = ("tokens", "active", "counts", "window", "wlen")
STORE_TIMEOUT_S = 120


def forward(model, cfg, spec: dict) -> np.ndarray:
    """Cache-free logits of spec["tokens"] [1, T]; with spec["pixels"] (a
    preprocessed image), its patch rows spliced over the image tokens."""
    tokens = torch.tensor(spec["tokens"], dtype=torch.int32)
    embeds = None
    if spec.get("pixels") is not None:
        flat = model.encode_images(torch.from_numpy(spec["pixels"]))
        embeds = model.splice_embeds(tokens[0], flat.reshape(-1, cfg.hidden_size))[None]
    return model(tokens, embeds=embeds).numpy()


def state(engine: InferenceEngine) -> dict[str, np.ndarray]:
    """The device state a follower must hold as the liaison does."""
    out = {k: getattr(engine, k).numpy().copy() for k in STATE}
    out["lengths"] = engine.cache.lengths.numpy().copy()
    out["page_table"] = engine.cache.page_table.numpy().copy()
    out["step"] = engine.sampling.step.numpy().copy()
    return out


def serve(engine: InferenceEngine, store, name: str, spec: dict, liaison: bool) -> dict:
    """The mode's requests on the liaison (its records to the store), or
    their replay on a follower; what the rank saw."""
    admits: list[int] = []
    if liaison:
        seq = iter(range(1, 1 << 30))

        def sink(rec: dict) -> None:
            if rec["op"] == "admit":
                admits.append(int(rec["cached"]))
            store.set(f"{name}/{next(seq)}", json.dumps(rec))

        engine.plan_sink = sink
        results = []
        for i, req in enumerate(spec["requests"]):
            res = engine.generate(GenerationRequest(id=f"{name}{i}", **req))
            results.append({"tokens": list(res.token_ids), "cached": res.cached_tokens,
                            "reason": res.done_reason})
        sink(END)
        return {"results": results, "admits": admits, "state": state(engine)}
    ops = []
    for i in range(1, 1 << 30):
        rec = json.loads(store.get(f"{name}/{i}"))
        if rec == END:
            break
        ops.append(rec["op"])
        if rec["op"] == "admit":
            admits.append(int(rec["cached"]))
        engine.apply_plan_op(rec)
    return {"admits": admits, "ops": ops, "state": state(engine)}


def main() -> None:
    rank, world, port, store_port = (int(a) for a in sys.argv[1:5])
    work = Path(sys.argv[5])
    group = GroupConfig(coordinator=f"127.0.0.1:{port}", num_processes=world, process_id=rank)
    distributed.initialize_group(group, backend="gloo", timeout_s=STORE_TIMEOUT_S)
    store = torch.distributed.TCPStore(
        "127.0.0.1", store_port, world, rank == 0,
        timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S))
    mesh_cfg = MeshConfig(tp=world)
    mesh = build_mesh(mesh_cfg)
    modes = pickle.loads((work / "modes.pkl").read_bytes())
    out: dict = {}
    for name, spec in modes.items():
        cfg = get_config(spec["model"])
        got: dict = {}
        if "forward" in spec:
            model = model_class(cfg)(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
            model.params_from_jax(spec["params"])
            got["forward"] = forward(model, cfg, spec["forward"])
            got["heads"] = [model.n_heads, model.n_kv_heads]
            del model
        collectives.reset_counts()
        engine = InferenceEngine(
            EngineConfig(model=spec["model"], mesh=mesh_cfg, **spec["engine"]),
            device="cpu", params=spec["params"], draft_params=spec.get("draft_params"))
        if "texts" in spec:
            got["embeddings"] = np.asarray(engine.embed(spec["texts"]))
        else:
            got.update(serve(engine, store, name, spec, liaison=rank == 0))
            got["drafter"] = engine._drafter.kind if engine._drafter is not None else None
            got["snapshot_key"] = engine.snapshot_key()
        got["collectives"] = dict(collectives.CALLS)
        # what the group's worker advertises of this engine
        caps = gather_capabilities("group", {spec["model"]: engine})
        layout, details = caps.shardLayouts[0], caps.availableModels[0].details
        got["advertised"] = {"strategy": layout.strategy, "meshAxes": dict(layout.meshAxes),
                             "vision": details["vision"],
                             "quantization": details["quantization_level"]}
        out[name] = got
        del engine
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    distributed.shutdown_group(group)


if __name__ == "__main__":
    main()
