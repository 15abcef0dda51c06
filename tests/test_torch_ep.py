"""Expert parallelism and dp replicas of the torch package, held against the
JAX package's engine and MoE under the same meshes on the CPU.

One four-process gloo launch (tests/torch_ep_child.py, float32, tiny
configs, one thread a rank) builds the meshes (ep 2, tp 2), (dp 2, ep 2)
and (dp 2, tp 2) in turn from the same world. Generation runs as a worker
group does, rank 0 serving and recording its plan, the others replaying
it. The JAX side (engines under MeshConfig(dp=2, ep=2, tp=2), (dp=4, ep=2,
tp=1) and (dp=4, tp=2), whose weights the ranks and an unmeshed port
engine take) is computed while the ranks run:

- tiny-mixtral's layer 0 MoE on every rank within 1e-5 of JAX `_moe_mlp`
  under its mesh: `_moe_mlp_ragged_ep` at 24 tokens, the meshed dense form
  at 8 tokens and with GRIDLLM_MOE_RAGGED=0 (set alike on both sides);
  the cache-free forward under both expert meshes within 1e-5;
- greedy streams equal to the JAX engine's and the unmeshed port engine's,
  with the engine's defaults (speculation and the prefix cache on): both
  MoE forms and int8 weights (attention and head int8, experts whole)
  under ep × tp, the ragged form under dp × ep, tiny-llama under dp × tp;
- every follower's replicated device state equal to the liaison's;
- each rank's MoE calls by form and its collectives: one all-reduce per
  meshed MoE call, none over dp; the groups each mesh builds; what each
  rank's worker advertises.
"""

import dataclasses
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
import torch

from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine
from gridllm_torch.ops.quant import QuantizedTensor
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.models import mixtral as jmixtral
from gridllm_tpu.models.configs import get_config as jget_config
from gridllm_tpu.parallel import MeshConfig as JMesh
from gridllm_tpu.parallel import build_mesh as jbuild_mesh

CHILD = Path(__file__).with_name("torch_ep_child.py")
REPO = CHILD.parent.parent
sys.path.insert(0, str(CHILD.parent))
import torch_ep_child as child  # noqa: E402

WORLD = 4
CHILD_TIMEOUT_S = 300
TOL = 1e-5
TINY = dict(max_slots=4, page_size=8, num_pages=64, max_pages_per_slot=16,
            prefill_buckets=(16, 32), prefill_chunk=16, dtype="float32")
OPTS = {"temperature": 0, "num_predict": 10}
LONG = "the quick brown fox jumps over the lazy dog"   # > prefill_chunk: chunks
REQUESTS = [dict(prompt="abc abc abc abc abc", options=OPTS),
            dict(prompt=LONG + " once", options=OPTS),
            dict(prompt=LONG + " twice", options=OPTS)]   # the prefix cache's hit
# the MoE inputs: label → (tokens, GRIDLLM_MOE_RAGGED, the form each rank takes)
MOE_INPUTS = {"ragged_24": (24, "1", "ragged_ep"), "dense_8": (8, "1", "dense_ep"),
              "dense_24": (24, "0", "dense_ep")}
FORWARD_TOKENS = [[5, 17, 99, 3, 42, 7, 250, 1, 9, 11, 13, 2, 8, 60, 61, 62, 63, 64, 70]]


def _np(tree):
    """A JAX pytree as numpy, int8 pairs as the port's QuantizedTensor."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if hasattr(tree, "q"):
        return QuantizedTensor(np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


def _jmesh(name: str):
    return jbuild_mesh(JMesh(**child.JAX_MESHES[name]))


def _jax_engine(mode: str) -> JEngine:
    mesh_name, model, engine, ragged = child.MODES[mode]
    fields = {f.name for f in dataclasses.fields(JConfig)}
    kw = {k: v for k, v in {**TINY, **engine}.items() if k in fields}
    return JEngine(JConfig(model=model, mesh=JMesh(**child.JAX_MESHES[mesh_name]), **kw))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(e: int) -> dict:
    rng = np.random.default_rng(7)
    return {label: (rng.standard_normal((1, n, e)).astype(np.float32), ragged)
            for label, (n, ragged, _) in MOE_INPUTS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engines give the weights; the four ranks start on them at
    once and run while the JAX side computes its streams, MoE forms and
    forwards. Returns (JAX side, each rank's report)."""
    work = tmp_path_factory.mktemp("ep")
    engines = {mode: _jax_engine(mode) for mode in child.MODES}
    side = {mode: {"params": _np(je.params)} for mode, je in engines.items()}
    side["forms"] = {}
    cfg = jget_config("tiny-mixtral")
    inputs = _inputs(cfg.hidden_size)
    forms = {m: {"params": side["ragged"]["params"], "inputs": inputs, "tokens": FORWARD_TOKENS}
             for m in ("ep_tp", "dp_ep")}
    modes = {mode: {"engine": {**TINY, **child.MODES[mode][2]}, "params": side[mode]["params"],
                    "requests": REQUESTS} for mode in child.MODES}
    (work / "ep.pkl").write_bytes(pickle.dumps({"forms": forms, "modes": modes}))
    port, store_port = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(WORLD):
        log = open(work / f"rank{rank}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, str(CHILD), str(rank), str(WORLD), str(port), str(store_port),
             str(work)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for mode, je in engines.items():
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("GRIDLLM_MOE_RAGGED", child.MODES[mode][3])
                side[mode]["results"] = [je.generate(JRequest(id=f"{mode}{i}", **dict(
                    r, options=dict(r["options"])))) for i, r in enumerate(REQUESTS)]
        params = jax.tree_util.tree_map(jnp.asarray, engines["ragged"].params)
        lp = {k: params["layers"][k][0] for k in ("router", "we_gate", "we_up", "we_down")}
        for mesh_name in forms:
            jm = _jmesh(mesh_name)
            got = side["forms"][mesh_name] = {"moe": {}}
            with pytest.MonkeyPatch.context() as mp, jm:
                for label, (x, ragged) in inputs.items():
                    mp.setenv("GRIDLLM_MOE_RAGGED", ragged)
                    got["moe"][label] = np.asarray(
                        jmixtral._moe_mlp(cfg, jm, lp, jnp.asarray(x)))
                mp.setenv("GRIDLLM_MOE_RAGGED", "1")
                got["forward"] = np.asarray(jmixtral.forward(
                    params, cfg, jnp.asarray(FORWARD_TOKENS, jnp.int32), mesh=jm))
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
    return side, [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_side(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


@pytest.mark.parametrize("label", sorted(MOE_INPUTS))
@pytest.mark.parametrize("mesh_name", ["ep_tp", "dp_ep"])
def test_ep_moe_forms_match_jax(jax_side, ranks, mesh_name, label):
    """Every rank's MoE output (its experts' partial sum, summed over the
    axes that split them) equals JAX `_moe_mlp` under the matching mesh,
    in the form JAX takes: `_moe_mlp_ragged_ep` at 16 tokens or more with
    GRIDLLM_MOE_RAGGED on, the meshed dense form otherwise."""
    want = jax_side["forms"][mesh_name]["moe"][label]
    form = MOE_INPUTS[label][2]
    for out in ranks:
        got, taken = out[mesh_name]["moe"][label]
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert taken == [form]


@pytest.mark.parametrize("mesh_name", ["ep_tp", "dp_ep"])
def test_ep_forward_matches_jax(jax_side, ranks, mesh_name):
    """The cache-free forward (ragged EP at 19 tokens) on every rank within
    1e-5 of the JAX forward under the matching mesh; each rank holds its
    expert range and sums over exactly the axes that split the experts."""
    want = jax_side["forms"][mesh_name]["forward"]
    x = jget_config("tiny-mixtral").num_experts
    for out in ranks:
        got = out[mesh_name]
        np.testing.assert_allclose(got["forward"], want, rtol=TOL, atol=TOL)
        ep = got["coords"]["ep"]
        assert got["experts"] == (ep * x // 2, (ep + 1) * x // 2)
        assert got["axes"] == (("ep", "tp") if mesh_name == "ep_tp" else ("ep",))


def _unmeshed(mode: str, side: dict):
    _, model, engine, ragged = child.MODES[mode]
    threads = torch.get_num_threads()
    # one thread, as each rank: tiny products gain nothing from more, and
    # the suite runs beside other test workers
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRIDLLM_MOE_RAGGED", ragged)
            eng = InferenceEngine(EngineConfig(model=model, **TINY, **engine), device="cpu",
                                  params=side["params"])
            return [eng.generate(GenerationRequest(id=f"{mode}{i}", **dict(r, options=dict(
                r["options"])))) for i, r in enumerate(REQUESTS)]
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", sorted(child.MODES))
def test_ep_streams_match_jax_and_unmeshed(jax_side, ranks, mode):
    """The liaison's greedy streams (the group's: the others replayed them)
    equal the JAX engine's under the matching mesh and an unmeshed port
    engine's, the prefix cache's hit included."""
    want = jax_side[mode]["results"]
    plain = _unmeshed(mode, jax_side[mode])
    got = ranks[0][mode]["results"]
    for w, p, g in zip(want, plain, got):
        assert w.done_reason in ("stop", "length") and not p.error
        assert g["tokens"] == list(w.token_ids) == list(p.token_ids)
        assert g["cached"] == w.cached_tokens == p.cached_tokens
    assert got[2]["cached"] > 0


@pytest.mark.parametrize("mode", sorted(child.MODES))
def test_ep_followers_replay_to_the_liaisons_state(ranks, mode):
    """Every follower, replaying the liaison's records, dispatched the same
    admits and holds the same replicated state: the routing is the same
    bits on every rank, so no expert choice diverges."""
    lead = ranks[0][mode]
    assert len(lead["admits"]) == len(REQUESTS)
    for out in ranks[1:]:
        assert out[mode]["admits"] == lead["admits"]
        for key, value in lead["state"].items():
            np.testing.assert_array_equal(out[mode]["state"][key], value, err_msg=key)


@pytest.mark.parametrize("mode", sorted(child.MODES))
def test_ep_moe_calls_and_collectives(ranks, mode):
    """Each rank's MoE calls by form and its collectives: the ragged modes
    take ragged EP (speculation makes every step a verify of 20 rows), the
    dense mode only the meshed dense form; one all-reduce per meshed MoE
    call; no tp sum and no gather where tp is 1 (dp × ep); no MoE and no
    MoE sum for tiny-llama under dp × tp."""
    layers = 2
    for out in ranks:
        got = out[mode]
        forms, calls = got["forms"], got["collectives"]
        meshed = forms["dense_ep"] + forms["ragged_ep"]
        assert forms["dense"] == forms["ragged"] == 0
        assert calls["all_reduce.moe"] == meshed and meshed % layers == 0
        if mode == "dense":
            assert forms["ragged_ep"] == 0 and forms["dense_ep"] > 0
        elif mode == "llama":
            assert meshed == 0 and calls["all_reduce"] > 0 and calls["all_gather"] > 0
        else:
            assert forms["ragged_ep"] > 0
        if mode == "dp_ragged":
            assert calls["all_reduce"] == calls["all_gather"] == 0
        assert got["model_meshed"]


def test_ep_mesh_groups_and_advertised_layouts(ranks):
    """The groups each mesh builds (a line along ep and tp, the (ep, tp)
    plane, none along dp) and the JAX worker's strategy names: "tensor"
    where tp > 1, else "expert" where ep > 1."""
    want = {"ep_tp": {"ep": 2, "tp": 2, "dp": 1, "plane": 4},
            "dp_ep": {"ep": 2, "tp": 1, "dp": 1, "plane": 2},
            "dp_tp": {"ep": 1, "tp": 2, "dp": 1, "plane": 2}}
    strategy = {"ragged": "tensor", "dense": "tensor", "int8": "tensor", "dp_ragged": "expert",
                "llama": "tensor"}
    for rank, out in enumerate(ranks):
        for mesh_name, sizes in want.items():
            assert out[mesh_name]["groups"] == sizes, (rank, mesh_name)
        for mode, name in strategy.items():
            adv = out[mode]["advertised"]
            shape = child.MESHES[child.MODES[mode][0]]
            assert adv["strategy"] == name, mode
            assert {k: adv["meshAxes"][k] for k in shape} == shape, mode
