"""One rank of a four-process group of the torch package over dp, ep and tp,
for tests/test_torch_ep.py: gloo on the CPU, tiny models, float32.

    python tests/torch_ep_child.py RANK WORLD PORT STORE_PORT WORKDIR

Reads WORKDIR/ep.pkl (per mesh: the inputs of the MoE forms and the
forward; per mode: the JAX-layout weights, the requests) and writes
WORKDIR/rank<RANK>.pkl. The same world builds the meshes of MESHES in
turn (every rank creates every process group in one order). Per mesh:

- where the mesh splits mixtral's experts, its layer 0 MoE on each input
  (the form it took, from MOE_FORMS) and its cache-free forward;
- per mode on that mesh, generation as a worker group runs it: rank 0, the
  liaison, serves the requests and hands each plan record to the group's
  TCP store (STORE_PORT) before its dispatch; the other ranks replay them
  with `apply_plan_op` (tests/torch_tp_modes_child.py's `serve`). Each rank
  reports its replicated device state, the admits it dispatched, its MoE
  calls by form, its collectives and what its worker advertises.

Imports nothing of JAX.
"""

import datetime
import os
import pickle
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_tp_modes_child import serve  # noqa: E402

from gridllm_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from gridllm_torch.engine.loader import model_class  # noqa: E402
from gridllm_torch.models import mixtral as mx  # noqa: E402
from gridllm_torch.models.configs import get_config  # noqa: E402
from gridllm_torch.parallel import GroupConfig, MeshConfig, build_mesh  # noqa: E402
from gridllm_torch.parallel import collectives, distributed  # noqa: E402
from gridllm_torch.worker.capabilities import gather_capabilities  # noqa: E402

# the port's meshes over four ranks, and the JAX meshes over eight devices
# each is held against (dp only replicates, so the dp sizes differ)
MESHES = {"ep_tp": dict(dp=1, ep=2, tp=2), "dp_ep": dict(dp=2, ep=2, tp=1),
          "dp_tp": dict(dp=2, ep=1, tp=2)}
JAX_MESHES = {"ep_tp": dict(dp=2, ep=2, tp=2), "dp_ep": dict(dp=4, ep=2, tp=1),
              "dp_tp": dict(dp=4, ep=1, tp=2)}
# mode → (mesh, model, engine settings, GRIDLLM_MOE_RAGGED of both packages)
MODES = {
    "ragged": ("ep_tp", "tiny-mixtral", {}, "1"),
    "dense": ("ep_tp", "tiny-mixtral", {}, "0"),
    "int8": ("ep_tp", "tiny-mixtral", {"quantize": "int8"}, "1"),
    "dp_ragged": ("dp_ep", "tiny-mixtral", {}, "1"),
    "llama": ("dp_tp", "tiny-llama", {}, "1"),
}
STORE_TIMEOUT_S = 120


def moe_forms(mesh, spec: dict) -> dict:
    """The mesh's tiny-mixtral (the JAX weights, this rank's slices): layer
    0's MoE on each input with its GRIDLLM_MOE_RAGGED, and the forward."""
    cfg = get_config("tiny-mixtral")
    model = model_class(cfg)(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    model.params_from_jax(spec["params"])
    out: dict = {"moe": {}, "experts": model._expert_range(), "axes": model._expert_axes}
    for label, (x, ragged) in spec["inputs"].items():
        os.environ["GRIDLLM_MOE_RAGGED"] = ragged
        before = dict(mx.MOE_FORMS)
        y = model._mlp(0, torch.from_numpy(x))
        out["moe"][label] = (y.numpy(), [k for k, v in mx.MOE_FORMS.items() if v > before[k]])
    os.environ["GRIDLLM_MOE_RAGGED"] = "1"
    out["forward"] = model(torch.tensor(spec["tokens"])).numpy()
    return out


def group_sizes(mesh) -> dict:
    """The size of this rank's line along each axis and of its (ep, tp)
    plane (1 where no group is built)."""
    import torch.distributed as dist

    def size(axes):
        g = mesh.group(axes)
        return 1 if g is None else dist.get_world_size(g)

    return {"ep": size("ep"), "tp": size("tp"), "dp": size("dp"), "plane": size(("ep", "tp"))}


def main() -> None:
    rank, world, port, store_port = (int(a) for a in sys.argv[1:5])
    work = Path(sys.argv[5])
    group = GroupConfig(coordinator=f"127.0.0.1:{port}", num_processes=world, process_id=rank)
    distributed.initialize_group(group, backend="gloo", timeout_s=STORE_TIMEOUT_S)
    store = torch.distributed.TCPStore(
        "127.0.0.1", store_port, world, rank == 0,
        timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S))
    spec = pickle.loads((work / "ep.pkl").read_bytes())
    out: dict = {}
    for mesh_name, shape in MESHES.items():
        mesh_cfg = MeshConfig(**shape)
        mesh = build_mesh(mesh_cfg)
        got: dict = {"coords": dict(mesh.coords), "groups": group_sizes(mesh)}
        if mesh_name in spec["forms"]:
            got.update(moe_forms(mesh, spec["forms"][mesh_name]))
        out[mesh_name] = got
        for name, (on, model, engine_kw, ragged) in MODES.items():
            if on != mesh_name:
                continue
            os.environ["GRIDLLM_MOE_RAGGED"] = ragged
            mode = spec["modes"][name]
            collectives.reset_counts()
            before = dict(mx.MOE_FORMS)
            engine = InferenceEngine(EngineConfig(model=model, mesh=mesh_cfg, **mode["engine"]),
                                     device="cpu", params=mode["params"])
            res = serve(engine, store, name, mode, liaison=rank == 0)
            res["forms"] = {k: v - before[k] for k, v in mx.MOE_FORMS.items()}
            res["collectives"] = dict(collectives.CALLS)
            layout = gather_capabilities("group", {model: engine}).shardLayouts[0]
            res["advertised"] = {"strategy": layout.strategy, "meshAxes": dict(layout.meshAxes)}
            res["model_meshed"] = engine.model.mesh is not None
            out[name] = res
            del engine
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    # rank 0 holds the store: it leaves after every rank has read the last
    # record (a dp replica runs no collective with it)
    torch.distributed.barrier()
    distributed.shutdown_group(group)


if __name__ == "__main__":
    main()
