"""Tensor parallelism of the torch package (parallel/, the meshed models and
engine) held against the JAX package's parallel/ on the CPU.

- `MeshConfig.resolve` against the JAX one, errors included, and the
  refusal of every axis but tp (ROADMAP A 9);
- the shard cut (parallel/sharding.py) against
  `gridllm_tpu.parallel.sharding.param_shardings` on tiny-llama,
  tiny-qwen2, tiny-gemma2, tiny-llava (its vision tower's leaves),
  tiny-bert and tiny-llama's int8 leaves: the same split dims, and where
  the heads do not divide by tp the port's whole-head fallback (attention
  replicated, the MLP and vocab still split); an int8 scale follows a
  column split and stays whole under a row split (JAX keeps every scale
  whole);
- a rank's int8 q and scale of a row-split and of a column-split leaf
  are slices of the unmeshed quantization, bit for bit, however the
  weights arrive (the scale is the amax over the WHOLE contracted axis);
- mixtral under a mesh still refused, naming ROADMAP A 9;
- a two-process gloo group (tests/torch_tp_child.py, tp=2, float32): each
  rank's cache-free forward within 1e-5 of `gridllm_tpu.models.llama.forward`,
  the paged prefill-plus-decode tokens of the JAX package's
  test_sharded_prefill_decode_match_single_device procedure, and a tp
  engine's greedy streams with speculation and ragged attention on equal to
  the JAX engine's under a tp=2 mesh and to an unmeshed port engine's.

Inputs come from seeds; the children log to files, each has its own
timeout.
"""

import dataclasses
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.models import bert_embed as jbert
from gridllm_tpu.models import gemma as jgemma
from gridllm_tpu.models import llama as jllama
from gridllm_tpu.models import llava as jllava
from gridllm_tpu.models.configs import get_config as jget_config
from gridllm_tpu.ops.kvcache import PageAllocator as JAllocator
from gridllm_tpu.ops.kvcache import PagedKVCache as JCache
from gridllm_tpu.parallel import MeshConfig as JMesh
from gridllm_tpu.parallel import build_mesh as jbuild_mesh
from gridllm_tpu.ops.quant import quantize_params as jquantize_params
from gridllm_tpu.parallel import param_shardings as jparam_shardings
from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine
from gridllm_torch.models.configs import get_config
from gridllm_torch.engine.loader import model_class
from gridllm_torch.models.llama import Llama, validate_mesh
from gridllm_torch.models.mixtral import Mixtral
from gridllm_torch.parallel import Mesh, MeshConfig, build_mesh, param_shardings, shard_params
from gridllm_torch.parallel.sharding import ATTENTION_LEAVES, scale_split
from gridllm_torch.parallel.mesh import AXES

CHILD = Path(__file__).with_name("torch_tp_child.py")
REPO = CHILD.parent.parent
sys.path.insert(0, str(CHILD.parent))
import torch_tp_child as child  # noqa: E402

CHILD_TIMEOUT_S = 240
FORWARD_TOL = 1e-5


def _resolve(cls, kw, n):
    try:
        return cls(**kw).resolve(n)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("kw,n", [
    (dict(tp=-1), 8), (dict(dp=2, tp=-1), 8), (dict(dp=2, ep=2, tp=2, sp=1), 8),
    (dict(pp=2, tp=-1), 8), (dict(tp=2), 2), (dict(tp=4), 4), (dict(tp=-1), 1),
    (dict(dp=3, tp=-1), 8), (dict(dp=-1, tp=-1), 8), (dict(dp=2, tp=2), 8),
    (dict(tp=2), 3),
])
def test_mesh_config_resolve_matches_jax(kw, n):
    assert _resolve(MeshConfig, kw, n) == _resolve(JMesh, kw, n)


@pytest.mark.parametrize("kw", [dict(pp=2, tp=1), dict(dp=2, tp=1), dict(ep=2, tp=1),
                                dict(sp=2, tp=1), dict(dp=2, tp=2)])
def test_build_mesh_refuses_unported_axes(kw):
    world = math.prod(kw.values())
    with pytest.raises(ValueError, match="ROADMAP A 9"):
        build_mesh(MeshConfig(**kw), world_size=world, rank=0)


def _fake_mesh(tp: int, rank: int) -> Mesh:
    """A tp mesh as one rank sees it, with no process group (shapes only)."""
    shape = {ax: (tp if ax == "tp" else 1) for ax in AXES}
    coords = {ax: (rank if ax == "tp" else 0) for ax in AXES}
    return Mesh(shape=shape, rank=rank, coords=coords, groups={})


def _jax_dim(spec) -> int | None:
    dims = [i for i, ax in enumerate(spec) if ax == "tp"]
    return dims[0] if dims else None


_JAX_INIT = {"llama": jllama, "qwen2": jllama, "gemma2": jgemma, "llava": jllava,
             "bert_embed": jbert}


def _shapes(tree):
    """Shapes of a params tree's leaves, an int8 pair as (q's, scale's)."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if hasattr(tree, "q"):
        return (tuple(tree.q.shape), tuple(tree.scale.shape))
    return tuple(tree.shape)


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-qwen2", "tiny-gemma2", "tiny-llava",
                                   "tiny-bert", "tiny-llama:int8"])
@pytest.mark.parametrize("tp,jmesh", [(2, dict(dp=4, tp=2)), (4, dict(dp=2, tp=4))])
def test_shard_dims_match_jax(model, tp, jmesh):
    """The same split dims as the JAX package's param_shardings, for every
    leaf of the family's tree (llava's vision tower and projector, the
    encoder's leaves, an int8 leaf's q); where the heads (of the text
    stack, or the tower's) do not divide by tp (tiny-llama's 2 kv heads,
    tiny-llava's 2 tower heads at tp = 4) the port keeps attention whole
    (JAX splits the flattened out dim there and re-shards around the
    kernels) while the MLP, embed and lm_head still split. An int8 scale:
    JAX keeps it whole; the port cuts it with a column split's q."""
    name, _, quant = model.partition(":")
    jcfg, cfg = jget_config(name), get_config(name)
    params = _JAX_INIT[cfg.family].init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params = jquantize_params(params)
    params = jax.tree_util.tree_map(np.asarray, params)
    jsh = jparam_shardings(params, jbuild_mesh(JMesh(**jmesh)))
    mesh = _fake_mesh(tp, 1)
    got = param_shardings(params, cfg, mesh)

    def compare(got, jsh, leaves, heads):
        for key, dim in got.items():
            if isinstance(dim, dict):
                vc = cfg.vision_cfg
                compare(dim, jsh[key], leaves[key], (vc.num_heads, vc.num_heads))
                continue
            leaf, want = leaves[key], jsh[key]
            if hasattr(leaf, "q"):   # an int8 pair: q as the float leaf
                assert _jax_dim(want.scale.spec) is None, key
                # the scale [..., out]: cut on its last dim with a column split
                column = dim is not None and dim == leaf.q.ndim - 1
                assert scale_split(dim, leaf.q.ndim) == (leaf.q.ndim - 2 if column else None)
                want = want.q
            if key in ATTENTION_LEAVES and heads and any(n % tp for n in heads):
                assert dim is None, key
            else:
                assert dim == _jax_dim(want.spec), key

    compare({k: v for k, v in got.items() if k != "layers"},
            {k: v for k, v in jsh.items() if k != "layers"}, params, None)
    compare(got["layers"], jsh["layers"], params["layers"], (cfg.num_kv_heads, cfg.num_heads))
    # the model's parameters are the cut's shapes
    m = model_class(cfg)(cfg, dtype=torch.float32, device="cpu", mesh=mesh,
                         quantize=quant or None)
    assert _shapes(m.params_tree()) == _shapes(shard_params(params, cfg, mesh))
    heads_divide = cfg.num_kv_heads % tp == 0
    if hasattr(m, "n_kv_heads"):
        assert (m.n_kv_heads, m.n_heads) == (
            (cfg.num_kv_heads // tp, cfg.num_heads // tp) if heads_divide
            else (cfg.num_kv_heads, cfg.num_heads))


@pytest.mark.parametrize("rank", [0, 1])
def test_int8_rank_pairs_are_slices_of_the_unmeshed_quantization(rank, tmp_path):
    """A rank's int8 q and scale of the row-split wo and w_down and the
    column-split wq and lm_head equal slices of the unmeshed model's
    quantization bit for bit, whether the rank draws its weights
    (init_params), takes a float or an already quantized JAX-layout tree
    (params_from_jax) or reads a float checkpoint (load_checkpoint): the
    scale of a row-split leaf is the amax over ALL its rows, not the
    rank's."""
    from gridllm_torch.engine import loader

    cfg, mesh = get_config("tiny-llama"), _fake_mesh(2, rank)
    gen = torch.Generator()
    gen.manual_seed(5)
    whole = Llama(cfg, dtype=torch.float32, device="cpu", quantize="int8").init_params(gen)
    want = shard_params(whole.params_tree(), cfg, mesh)

    def same(m: Llama) -> None:
        got = m.params_tree()
        for leaf, dim in (("wo", 1), ("w_down", 1), ("wq", 2), ("w_up", 2)):
            assert m._leaf_split(leaf) == dim
            pair, ref = got["layers"][leaf], want["layers"][leaf]
            assert torch.equal(pair.q, ref.q) and torch.equal(pair.scale, ref.scale), leaf
            if dim == 1:    # row split: the whole scale, not the rank's rows' amax
                assert torch.equal(pair.scale, whole.params_tree()["layers"][leaf].scale)
        assert torch.equal(got["lm_head"].q, want["lm_head"].q)
        assert torch.equal(got["lm_head"].scale, want["lm_head"].scale)

    def meshed() -> Llama:
        return Llama(cfg, dtype=torch.float32, device="cpu", quantize="int8", mesh=mesh)

    gen.manual_seed(5)
    same(meshed().init_params(gen))
    gen.manual_seed(5)
    fp = Llama(cfg, dtype=torch.float32, device="cpu").init_params(gen)
    np_float = {k: v.numpy() if isinstance(v, torch.Tensor) else
                {n: t.numpy() for n, t in v.items()} for k, v in fp.params_tree().items()}
    same(meshed().params_from_jax(np_float))
    np_int8 = jax.tree_util.tree_map(np.asarray, jquantize_params(np_float))
    same(meshed().params_from_jax(np_int8))
    loader.save_checkpoint(fp, cfg, str(tmp_path), dtype=torch.float32)
    m = meshed()
    assert not any(".o_proj." in n or ".down_proj." in n for n in m.hf_slices())
    loader.load_checkpoint(cfg, str(tmp_path), model=m, quantize="int8")
    same(m)


def test_mixtral_under_a_mesh_is_refused():
    """Mixtral's experts wait for the ep axis: refused under a tp mesh,
    naming ROADMAP A 9, at the model and at the family check the engine
    runs."""
    cfg = get_config("tiny-mixtral")
    with pytest.raises(ValueError, match="ROADMAP A 9"):
        validate_mesh(cfg, _fake_mesh(2, 0))
    with pytest.raises(ValueError, match="ROADMAP A 9"):
        Mixtral(cfg, dtype=torch.float32, device="cpu", mesh=_fake_mesh(2, 0))


def _full_model(model: str) -> Llama:
    m = Llama(get_config(model), dtype=torch.float32, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(5)
    return m.init_params(gen)


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-qwen2"])
@pytest.mark.parametrize("rank", [0, 1])
def test_rank_weights_are_slices_of_the_unmeshed_weights(model, rank, tmp_path, monkeypatch):
    """Every way weights arrive gives a rank the same slices of the same
    full tensors: init_params from one seed (the full tensors drawn, the
    share kept), params_from_jax of a full pytree, and a checkpoint read
    on the rank, which reads only its slices of the split tensors
    (SafetensorsIndex.get_slice) and never one of them whole."""
    from gridllm_torch.engine import loader

    cfg, mesh = get_config(model), _fake_mesh(2, rank)
    full = _full_model(model)
    want = shard_params({k: v.numpy() if isinstance(v, torch.Tensor) else
                         {n: t.numpy() for n, t in v.items()}
                         for k, v in full.params_tree().items()}, cfg, mesh)

    def same(m: Llama) -> None:
        got = m.params_tree()
        for name, leaf in want.items():
            if name == "layers":
                for k, v in leaf.items():
                    np.testing.assert_array_equal(got[name][k].numpy(), v, err_msg=k)
            else:
                np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)

    gen = torch.Generator()
    gen.manual_seed(5)
    same(Llama(cfg, dtype=torch.float32, device="cpu", mesh=mesh).init_params(gen))
    np_tree = {k: v.numpy() if isinstance(v, torch.Tensor) else
               {n: t.numpy() for n, t in v.items()} for k, v in full.params_tree().items()}
    same(Llama(cfg, dtype=torch.float32, device="cpu", mesh=mesh).params_from_jax(np_tree))
    loader.save_checkpoint(full, cfg, str(tmp_path), dtype=torch.float32)
    sliced, whole = [], []
    real_slice, real_get = loader.SafetensorsIndex.get_slice, loader.SafetensorsIndex.get

    def spy_slice(self, name, *a, **kw):
        sliced.append(name)
        return real_slice(self, name, *a, **kw)

    def spy_get(self, name, device="cpu", shard=None):
        if shard is None:
            whole.append(name)
        return real_get(self, name, device, shard)

    monkeypatch.setattr(loader.SafetensorsIndex, "get_slice", spy_slice)
    monkeypatch.setattr(loader.SafetensorsIndex, "get", spy_get)
    m = Llama(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    loader.load_checkpoint(cfg, str(tmp_path), model=m)
    same(m)
    split = m.hf_slices()
    assert split and sorted(sliced) == sorted(split)
    assert not set(whole) & set(split)
    assert any(".self_attn.o_proj." in n for n in split)      # columns (row parallel)
    assert any(".mlp.gate_proj." in n for n in split)         # rows (column parallel)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_engine(model: str, mesh) -> JEngine:
    """The JAX engine with the children's settings (ragged attention is its
    GRIDLLM_RAGGED_ATTN default, on)."""
    fields = {f.name for f in dataclasses.fields(JConfig)}
    kw = {k: v for k, v in child.ENGINE.items() if k in fields}
    return JEngine(JConfig(model=model, mesh=mesh, **kw))


def _streams(engine, request_cls) -> list[list[int]]:
    return [engine.generate(request_cls(
        id=f"s{i}", prompt=p, options={"temperature": 0, "num_predict": 12, "seed": 3})).token_ids
        for i, p in enumerate(child.STREAM_PROMPTS)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the two-rank group once; the JAX side's params and results."""
    work = tmp_path_factory.mktemp("tp_group")
    jax_side = {}
    for name in child.MODELS:
        # the JAX engine under a tp=2 mesh (dp absorbs the test process's
        # other virtual devices): its weights go to the ranks
        je = _jax_engine(name, JMesh(dp=-1, tp=2))
        params = jax.tree_util.tree_map(np.asarray, je.params)
        flat = {k: v for k, v in params.items() if k != "layers"}
        flat.update({f"layers/{k}": v for k, v in params["layers"].items()})
        np.savez(work / f"params_{name}.npz", **flat)
        jax_side[name] = {"params": params, "streams": _streams(je, JRequest)}
    port = _free_port()
    # one thread a rank: the suite runs beside other test workers
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    logs, procs = [], []
    for rank in range(2):
        logs.append(open(work / f"rank{rank}.log", "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, str(CHILD), str(rank), "2", str(port), str(work)],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        assert p.returncode == 0, f"rank {rank}: {log.read()[-4000:]}"
        log.close()
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    return jax_side, ranks


@pytest.mark.parametrize("model", child.MODELS)
def test_tp_forward_matches_jax(group, model):
    jax_side, ranks = group
    params = jax_side[model]["params"]
    want = np.asarray(jllama.forward(params, jget_config(model),
                                     jnp.asarray(child.TOKENS, jnp.int32)))
    cfg = get_config(model)
    for out in ranks:
        np.testing.assert_allclose(out[f"{model}/forward"], want, rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)
        # whole heads on each rank: tp=2 divides tiny models' 4 q and 2 kv heads
        assert out[f"{model}/heads"].tolist() == [cfg.num_heads // 2, cfg.num_kv_heads // 2]
    np.testing.assert_array_equal(ranks[0][f"{model}/forward"], ranks[1][f"{model}/forward"])


@pytest.mark.parametrize("model", child.MODELS)
def test_tp_paged_prefill_decode_matches_jax(group, model):
    """The JAX package's sharded pipeline procedure (prefill a 5-token
    prompt, 4 greedy decode steps) gives the same tokens on every rank."""
    jax_side, ranks = group
    jcfg = jget_config(model)
    params = jax.tree_util.tree_map(jnp.asarray, jax_side[model]["params"])
    c = JCache.create(jcfg.num_layers, 16, 8, jcfg.num_kv_heads, jcfg.head_dim_, 4, 8)
    cache = JCache(k=c.k.astype(jnp.float32), v=c.v.astype(jnp.float32),
                   page_table=c.page_table, lengths=c.lengths, page_size=c.page_size)
    alloc = JAllocator(16, 8, 8)
    alloc.alloc(0, 16)
    row = jnp.asarray(alloc.table_row(0), jnp.int32)
    padded = jnp.asarray(child.PROMPT + [0] * 3, jnp.int32)
    logits, cache = jllama.prefill(params, jcfg, padded, jnp.int32(len(child.PROMPT)), cache,
                                   jnp.int32(0), row)
    want = [int(jnp.argmax(logits))]
    tok = jnp.zeros((cache.max_slots,), jnp.int32).at[0].set(want[0])
    active = jnp.zeros((cache.max_slots,), bool).at[0].set(True)
    for _ in range(4):
        logits, cache = jllama.decode_step(params, jcfg, tok, cache, active)
        want.append(int(jnp.argmax(logits[0])))
        tok = tok.at[0].set(want[-1])
    for out in ranks:
        assert out[f"{model}/paged"].tolist() == want


@pytest.mark.parametrize("model", child.MODELS)
def test_tp_engine_stream_matches_jax_and_unmeshed(group, model):
    """Greedy float32 streams, speculation (K=4) and ragged attention on:
    each rank's tp=2 engine, the JAX engine under a tp=2 mesh and an
    unmeshed port engine on the same weights agree token for token; each
    verify and decode step summed over tp after every wo and w_down."""
    jax_side, ranks = group
    plain = InferenceEngine(EngineConfig(model=model, **child.ENGINE), device="cpu",
                            params=jax_side[model]["params"])
    unmeshed = _streams(plain, GenerationRequest)
    assert unmeshed == jax_side[model]["streams"]
    cfg = get_config(model)
    for out in ranks:
        got = [out[f"{model}/stream{i}"].tolist() for i in range(len(child.STREAM_PROMPTS))]
        assert got == unmeshed
        assert int(out[f"{model}/spec_steps"]) > 0
        # two row-parallel sums a layer per model call, beside the embedding's
        assert int(out[f"{model}/all_reduce"]) % (2 * cfg.num_layers + 1) == 0
