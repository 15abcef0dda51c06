"""Draft-model tree speculation in the PyTorch port against the JAX package
on CPU (the in-scope cases of tests/test_spec_tree.py, and more).

- topology helpers: parents, depths, ancestor masks and int32 bitmasks
  equal to the JAX package's, bit 31 included (as the JAX dispatcher packs
  it for its kernel);
- `spec_accept_tree` in greedy mode: emitted tokens, paths, n_emit, the
  repeat-penalty state and the noise counter equal to the JAX function's
  (chain walk, sibling rescue, node validity, budget-masked nodes);
  seeded sampling deterministic, on sub-streams of its own;
- `commit_tree_path`: fp and int8 pools equal to the JAX function's bit
  for bit, across a page boundary, inactive slots untouched, rows at or
  below lengths never written;
- tree attention: the tree branches of `paged_attention_verify_ref` and
  `ragged_paged_attention_ref`, the dispatchers and the kernel wrapper's
  CPU path against the JAX plain versions (1e-5) and the JAX ragged Pallas
  kernel's tree leg in interpret mode (the KERNELS tolerance, 3e-2), on fp
  and int8 pools; a chain topology equals the causal group;
- the kernel wrapper's operand checks: chain groups of any width (the
  draft model's 64-token ingest), trees of at most 32 nodes;
- tiny-llama `verify_step` with a tree, both attention modes, logits and
  pools against JAX's;
- `DraftModelDrafter.draft_batch` against JAX's (multi-round ingest, slot
  isolation, overflow), ties broken toward the lowest index;
- engines with `draft_model="tiny-llama"`: greedy streams and speculation
  counts equal to the JAX engine's with ragged attention on, off, and with
  an int8 pool, a concurrent batch, exact num_predict and a warm
  prefix-cache repeat; an unknown draft model serves with n-grams.
"""

import dataclasses

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
from gridllm_torch.ops import sampling as TS
from gridllm_torch.ops import spec as TSP
from gridllm_torch.ops.kernels import by_name
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import llama as JL
from gridllm_tpu.ops import attention as JA
from gridllm_tpu.ops import kvcache as JC
from gridllm_tpu.ops import pallas_kernels as PK
from gridllm_tpu.ops import sampling as JS
from gridllm_tpu.ops import spec as JSP

_SPEC = by_name("ragged_attention")
KERNEL_TOL = dict(rtol=_SPEC.rtol, atol=_SPEC.atol)
REF_TOL = dict(rtol=1e-5, atol=1e-5)   # plain version against plain version
TINY = dict(model="tiny-llama", max_slots=4, page_size=8, num_pages=64,
            max_pages_per_slot=8, prefill_buckets=(16, 32), prefill_chunk=16,
            dtype="float32")
REP_PROMPT = "ab ab ab ab ab ab"
REP_OPTS = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 24}
LONG = "ab ab ab ab ab ab ab ab ab ab"   # 30 tokens > prefill_chunk


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,width", [(4, 2), (3, 2), (2, 3), (4, 1), (0, 4), (4, 8), (7, 4)])
def test_topology_helpers_match_jax(k, width):
    parents = TSP.tree_topology(k, width)
    np.testing.assert_array_equal(parents, JSP.tree_topology(k, width))
    np.testing.assert_array_equal(TSP.tree_depths(parents), JSP.tree_depths(parents))
    np.testing.assert_array_equal(TSP.tree_ancestor_mask(parents),
                                  JSP.tree_ancestor_mask(parents))
    bits = TSP.tree_ancestor_bits(parents)
    assert bits.dtype == np.int32
    np.testing.assert_array_equal(bits, JSP.tree_ancestor_bits(parents))
    np.testing.assert_array_equal(TA.tree_bits_of(TSP.tree_ancestor_mask(parents)), bits)


def test_topology_bad_shapes_raise():
    with pytest.raises(ValueError):
        TSP.tree_topology(-1, 2)
    with pytest.raises(ValueError):
        TSP.tree_topology(2, 0)
    with pytest.raises(ValueError):
        TSP.tree_depths(np.asarray([-1, 1], np.int32))
    with pytest.raises(ValueError):
        TSP.tree_ancestor_bits(np.asarray([-1] + list(range(32)), np.int32))


def test_32_node_bitmask_sets_the_sign_bit():
    """A 32-node tree's last nodes carry bit 31: the int32 mask is then
    negative, exactly the JAX dispatcher's uint32 packing viewed as int32
    (the JAX package's own tree_ancestor_bits overflows there under numpy
    2, so the dispatcher's packing is the reference)."""
    parents = TSP.tree_topology(16, 16)
    assert len(parents) == 32
    bits = TSP.tree_ancestor_bits(parents)
    anc = JSP.tree_ancestor_mask(parents)
    want = np.zeros(32, np.uint32)
    for j in range(32):
        want |= anc[:, j].astype(np.uint32) << np.uint32(j)
    np.testing.assert_array_equal(bits, want.view(np.int32))
    assert bits[-1] < 0 and bits[15] > 0
    np.testing.assert_array_equal(TK.tree_mask_from_bits(bits, 32).numpy(), anc)


# ---------------------------------------------------------------------------
# accept walk
# ---------------------------------------------------------------------------


def _sampler_state(rng, s, vocab, w=8):
    window = rng.integers(0, vocab, size=(s, w)).astype(np.int32)
    wlen = np.asarray([w, 3, 0, 5, 2, 8][:s], np.int32)
    counts = np.zeros((s, vocab), np.int32)
    for i in range(s):
        for tok in window[i, w - wlen[i]:]:
            counts[i, tok] += 1
    return window, wlen, counts


def _accept_both(logits, nt, parents, valid, active, penalty, state):
    """spec_accept_tree of both packages on the same greedy inputs; every
    output and every piece of state must be equal."""
    s, _, vocab = logits.shape
    window, wlen, counts = state
    common = dict(temperature=np.zeros(s, np.float32), top_k=np.full(s, 40, np.int32),
                  top_p=np.full(s, 0.9, np.float32), min_p=np.zeros(s, np.float32),
                  repeat_penalty=penalty, repeat_last_n=np.full(s, 6, np.int32),
                  seed=np.arange(s, dtype=np.int32), step=np.arange(s, dtype=np.int32) * 3)
    jsp = JS.SamplingParams(**{k: jnp.asarray(v) for k, v in common.items()})
    out, path, n_emit, last, jcounts, jwin, jwlen, jsp = JS.spec_accept_tree(
        jnp.asarray(logits), jnp.asarray(nt), parents, jnp.asarray(valid), jsp,
        jnp.asarray(counts), jnp.asarray(window), jnp.asarray(wlen), jnp.asarray(active),
        vocab)
    tsp = TS.SamplingParams(**{k: _t(v) for k, v in common.items()})
    tcounts, twin, twlen = _t(counts), _t(window), _t(wlen)
    t_out, t_path, t_n, t_last = TS.spec_accept_tree(
        _t(logits), _t(nt), parents, _t(valid), tsp, tcounts, twin, twlen, _t(active), vocab)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(out))
    np.testing.assert_array_equal(t_path.numpy(), np.asarray(path))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(n_emit))
    np.testing.assert_array_equal(t_last.numpy(), np.asarray(last))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(twlen.numpy(), np.asarray(jwlen))
    np.testing.assert_array_equal(tsp.step.numpy(), np.asarray(jsp.step))
    return t_out.numpy(), t_path.numpy(), t_n.numpy()


def test_accept_tree_chain_walk_matches_jax():
    parents = TSP.tree_topology(2, 2)  # [-1, 0, 1, 0]
    n, s, vocab = len(parents), 2, 16
    logits = np.full((s, n, vocab), -10.0, np.float32)
    tgt = [(i * 2 + 3) % vocab for i in range(n)]
    for i in range(n):
        logits[:, i, tgt[i]] = 5.0
    nt = np.zeros((s, n), np.int32)
    nt[:, 1] = tgt[0]
    nt[0, 2] = tgt[1]
    nt[1, 2] = (tgt[1] + 1) % vocab
    nt[:, 3] = (tgt[0] + 5) % vocab
    state = _sampler_state(np.random.default_rng(0), s, vocab)
    out, path, n_emit = _accept_both(logits, nt, parents, np.ones((s, n), bool),
                                     np.ones(s, bool), np.ones(s, np.float32), state)
    assert n_emit.tolist() == [3, 2]
    assert path[0, :3].tolist() == [1, 2, 0] and path[1, :2].tolist() == [1, 0]


def test_accept_tree_sibling_rescue_matches_jax():
    parents = TSP.tree_topology(2, 2)
    n, vocab = len(parents), 16
    logits = np.full((1, n, vocab), -10.0, np.float32)
    logits[0, 0, 7] = 5.0   # the root's argmax is 7
    logits[0, 3, 9] = 5.0   # after the sibling, 9
    nt = np.zeros((1, n), np.int32)
    nt[0, 1], nt[0, 3] = 5, 7   # the chain head misses, the sibling carries 7
    state = _sampler_state(np.random.default_rng(1), 1, vocab)
    out, path, n_emit = _accept_both(logits, nt, parents, np.ones((1, n), bool),
                                     np.ones(1, bool), np.ones(1, np.float32), state)
    assert n_emit.tolist() == [2] and out.T[0, :2].tolist() == [7, 9]
    assert path[0, :2].tolist() == [3, 0]   # base + 1 is backed by node 3's row


def test_accept_tree_respects_node_validity_matches_jax():
    parents = TSP.tree_topology(2, 2)
    n, vocab = len(parents), 16
    logits = np.full((1, n, vocab), -10.0, np.float32)
    logits[0, :, 7] = 5.0
    nt = np.zeros((1, n), np.int32)
    nt[0, 1] = nt[0, 2] = 7
    valid = np.ones((1, n), bool)
    valid[0, 2] = False   # the depth-2 node masked out by the budget
    state = _sampler_state(np.random.default_rng(2), 1, vocab)
    _, path, n_emit = _accept_both(logits, nt, parents, valid, np.ones(1, bool),
                                   np.ones(1, np.float32), state)
    assert n_emit.tolist() == [2] and path[0, :2].tolist() == [1, 0]


@pytest.mark.parametrize("seed", range(3))
def test_accept_tree_random_matches_jax(seed):
    """The engine's default topology (K = 4, width 2) on random logits:
    per slot the chain follows the penalized argmax for a while, siblings
    sometimes carry it, budgets mask nodes, one slot is inactive."""
    rng = np.random.default_rng(seed)
    parents = TSP.tree_topology(4, 2)
    n, s, vocab = len(parents), 6, 48
    logits = (rng.normal(size=(s, n, vocab)) * 3).astype(np.float32)
    nt = rng.integers(0, vocab, size=(s, n)).astype(np.int32)
    greedy = logits.argmax(-1)
    for i in range(s):
        depth_ok = int(rng.integers(0, 5))
        node = 0
        for d in range(depth_ok):
            nt[i, d + 1] = greedy[i, node]
            node = d + 1
        if rng.random() < 0.5:
            nt[i, 5] = greedy[i, 0]
    valid = np.ones((s, n), bool)
    valid[1, 3:5] = False          # a budget of 2
    valid[2, 1:] = False           # a slot the drafter skipped
    active = np.asarray([True] * 5 + [False])
    penalty = np.asarray([1.0, 1.1, 1.3, 1.0, 1.2, 1.0], np.float32)
    _, _, n_emit = _accept_both(logits, nt, parents, valid, active, penalty,
                                _sampler_state(rng, s, vocab))
    assert n_emit[5] == 0 and n_emit[2] == 1


def test_accept_tree_sampled_is_seeded():
    rng = np.random.default_rng(7)
    parents = TSP.tree_topology(4, 2)
    s, n, vocab = 3, len(parents), 64
    logits = _t((rng.normal(size=(s, n, vocab)) * 2).astype(np.float32))
    nt = _t(rng.integers(0, vocab, size=(s, n)).astype(np.int32))
    runs = []
    for _ in range(2):
        sp = TS.SamplingParams.defaults(s, "cpu")
        sp.seed.copy_(torch.tensor([5, 6, 7], dtype=torch.int32))
        window, wlen, counts = (_t(a) for a in _sampler_state(np.random.default_rng(3), s,
                                                                vocab))
        out, path, n_emit, _ = TS.spec_accept_tree(
            logits, nt, parents, torch.ones((s, n), dtype=torch.bool), sp, counts, window,
            wlen, torch.ones(s, dtype=torch.bool), vocab)
        runs.append((out.tolist(), path.tolist(), n_emit.tolist(), sp.step.tolist()))
    assert runs[0] == runs[1]
    assert runs[0][3] == runs[0][2]      # the noise counter advanced by n_emit
    # the tree's accept uniforms are sub-streams of their own (the key folded
    # with 3 + round), apart from the chain's (folded with 1); the residual
    # fallback's Gumbel noise is the chain's (folded with 2), as in the JAX
    # package
    seed, step = torch.tensor([5]), torch.tensor([0])
    u_chain, g_chain = TS._spec_keys(seed, step, 8)
    u_tree, g_tree = TS._spec_tree_keys(seed, step, 8, 5)
    assert torch.equal(g_chain, g_tree) and float(u_chain[0]) not in u_tree.tolist()
    assert len(set(u_tree[0].tolist())) == 5


# ---------------------------------------------------------------------------
# KV commit of the accepted path
# ---------------------------------------------------------------------------


def _tree_caches(lengths, quant=False, L=2, ps=4, P=16, maxp=4, kvh=2, d=8, seed=0):
    """The same stamped pools in both packages: every row distinct."""
    rng = np.random.default_rng(seed)
    table = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, -1, -1]], np.int32)
    s = len(lengths)
    table = table[:s]
    if quant:
        pools = []
        for _ in range(2):
            data = rng.integers(-127, 128, size=(L, P, ps, kvh, d)).astype(np.int8)
            scale = rng.uniform(0.1, 2.0, size=(L, P, ps)).astype(np.float32)
            pools.append((JC.QuantPages(jnp.asarray(data), jnp.asarray(scale)),
                          TC.QuantPages(_t(data), _t(scale))))
        (jk, tk), (jv, tv) = pools
    else:
        k = rng.normal(size=(L, P, ps, kvh, d)).astype(np.float32)
        v = rng.normal(size=(L, P, ps, kvh, d)).astype(np.float32)
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
    jc = JC.PagedKVCache(k=jk, v=jv, page_table=jnp.asarray(table),
                         lengths=jnp.asarray(lengths, jnp.int32), page_size=ps)
    tc = TC.PagedKVCache(k=tk, v=tv, page_table=_t(table),
                         lengths=torch.tensor(lengths, dtype=torch.int32), page_size=ps)
    return jc, tc


def _pool_np(pages):
    if isinstance(pages, (JC.QuantPages, TC.QuantPages)):
        return [np.asarray(pages.data), np.asarray(pages.scale)]
    return [np.asarray(pages)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", ["page_boundary", "prefix_untouched", "inactive", "overlap"])
def test_commit_tree_path_matches_jax(quant, case):
    lengths, active = [5, 5, 2], [True, True, True]
    # slot 0: the chain (no move), slot 1: the sibling (node 3) backs base+1
    # on another page, slot 2: a sibling whose source page is unmapped
    path = [[1, 2, 0, 0], [3, 0, 0, 0], [2, 3, 0, 0]]
    if case == "prefix_untouched":
        lengths, path = [5, 3, 2], [[3, 0, 0, 0], [2, 3, 0, 0], [3, 0, 0, 0]]
    elif case == "inactive":
        active = [False, True, False]
    elif case == "overlap":   # a chain that moves row after row downward
        lengths, path = [4, 6, 1], [[2, 3, 4, 0], [3, 4, 0, 0], [2, 3, 0, 0]]
    jc, tc = _tree_caches(lengths, quant=quant)
    before = [p.copy() for p in _pool_np(tc.k)]
    out = JC.commit_tree_path(jc, jnp.asarray(path, jnp.int32), jnp.asarray(active))
    assert TC.commit_tree_path(tc, _t(np.asarray(path, np.int32)), _t(active)) is tc
    for got, want in zip(_pool_np(tc.k) + _pool_np(tc.v), _pool_np(out.k) + _pool_np(out.v)):
        np.testing.assert_array_equal(got, want)
    assert tc.lengths.tolist() == lengths
    ps, table = tc.page_size, tc.page_table.numpy()
    for slot, base in enumerate(lengths):
        for pos in range(base + 1):   # the committed rows and the root row
            page = table[slot][pos // ps]
            for got, old in zip(_pool_np(tc.k), before):
                np.testing.assert_array_equal(got[:, page, pos % ps], old[:, page, pos % ps])
    if case == "inactive":
        page, off = table[0][6 // ps], 6 % ps   # slot 0's would-be move
        np.testing.assert_array_equal(_pool_np(tc.k)[0][:, page, off], before[0][:, page, off])


def test_commit_tree_path_quant_moves_bits_verbatim():
    jc, tc = _tree_caches([5, 5, 2], quant=True, seed=4)
    path = _t(np.asarray([[3, 0, 0, 0], [4, 0, 0, 0], [0, 0, 0, 0]], np.int32))
    # slot 0 (pages 0-3 of 4 rows): position 6 (page 1, row 2) <- 8 (page 2, row 0)
    src = [tc.k.data[:, 2, 0].clone(), tc.k.scale[:, 2, 0].clone()]
    TC.commit_tree_path(tc, path, torch.ones(3, dtype=torch.bool))
    assert torch.equal(tc.k.data[:, 1, 2], src[0])    # the int8 values
    assert torch.equal(tc.k.scale[:, 1, 2], src[1])   # and the scales, verbatim


# ---------------------------------------------------------------------------
# tree attention
# ---------------------------------------------------------------------------


def _verify_inputs(rng, quant=False, d=16, S=3, t=6, L=2, P=32, ps=8, maxp=8, kvh=2, h=4):
    if quant:
        pools = []
        for _ in range(2):
            x = rng.normal(size=(L, P * ps, kvh, d)).astype(np.float32)
            q, sc = JC.quantize_kv_rows(jnp.asarray(x))
            q = np.asarray(q).reshape(L, P, ps, kvh, d)
            sc = np.asarray(sc).reshape(L, P, ps)
            pools.append((JC.QuantPages(jnp.asarray(q), jnp.asarray(sc)),
                          TC.QuantPages(_t(q), _t(sc))))
        (jk, tk), (jv, tv) = pools
    else:
        k = rng.normal(size=(L, P, ps, kvh, d)).astype(np.float32)
        v = rng.normal(size=(L, P, ps, kvh, d)).astype(np.float32)
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
    table = rng.choice(P, size=S * maxp, replace=False).reshape(S, maxp).astype(np.int32)
    return dict(
        pools=(jk, jv, tk, tv), ps=ps,
        group=dict(q_group=rng.normal(size=(S, t, h, d)).astype(np.float32),
                   page_table=table, group_lengths=np.asarray([13, 0, 37][:S], np.int32),
                   k_group=rng.normal(size=(S, t, kvh, d)).astype(np.float32),
                   v_group=rng.normal(size=(S, t, kvh, d)).astype(np.float32)))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("k,width,softcap,window", [
    (4, 2, 0.0, 0), (4, 2, 30.0, 9), (2, 3, 0.0, 3), (4, 8, 30.0, 0), (4, 1, 0.0, 0)])
def test_tree_attention_matches_jax(quant, k, width, softcap, window):
    """Both plain versions, both dispatchers and the kernel wrapper's CPU
    path against the JAX references and the JAX ragged Pallas kernel's tree
    leg in interpret mode."""
    rng = np.random.default_rng(k * 10 + width + window)
    parents = TSP.tree_topology(k, width)
    depths, anc, bits = (TSP.tree_depths(parents), TSP.tree_ancestor_mask(parents),
                         TSP.tree_ancestor_bits(parents))
    inp = _verify_inputs(rng, quant=quant, t=len(parents))
    jk, jv, tk, tv = inp["pools"]
    g, ps = inp["group"], inp["ps"]
    jg = {name: jnp.asarray(v) for name, v in g.items()}
    tg = {name: _t(v) for name, v in g.items()}
    tree = dict(tree_pos=depths, tree_mask=anc)
    want = JA.paged_attention_verify_ref(
        jg["q_group"], jk, jv, jg["page_table"], jg["group_lengths"], ps, jg["k_group"],
        jg["v_group"], layer=jnp.int32(1), logit_softcap=softcap, window=window, **tree)
    want = np.asarray(want)
    args = (tg["q_group"], TA._layer_pool(tk, 1), TA._layer_pool(tv, 1), tg["page_table"],
            tg["group_lengths"], ps, tg["k_group"], tg["v_group"])
    got = TA.paged_attention_verify_ref(*args, logit_softcap=softcap, window=window, **tree)
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    _, ref_g = TA.ragged_paged_attention_ref(tk, tv, ps, layer=1, logit_softcap=softcap,
                                             window=window, **tg, **tree)
    _, disp_g = TA.ragged_paged_attention(tk, tv, ps, layer=1, logit_softcap=softcap,
                                          window=window, **tg, **tree)
    per_phase = TA.paged_attention_verify(
        tg["q_group"], tk, tv, tg["page_table"], tg["group_lengths"], ps, tg["k_group"],
        tg["v_group"], layer=1, logit_softcap=softcap, window=window, **tree)
    for out in (ref_g, disp_g, per_phase):
        np.testing.assert_array_equal(out.numpy(), got.numpy())
    scales = {}
    kd, vd, jkd, jvd = tk, tv, jk, jv
    if quant:
        scales = dict(k_scale=tk.scale, v_scale=tv.scale)
        kd, vd, jkd, jvd = tk.data, tv.data, jk.data, jv.data
    _, wg = TK.ragged_attention(kd, vd, ps, layer=1, softcap=softcap, window=window,
                                tree_pos=depths, tree_bits=bits, **scales, **tg)
    np.testing.assert_array_equal(wg.numpy(), got.numpy())
    jscales = dict(k_scale=jk.scale, v_scale=jv.scale) if quant else {}
    _, kg = PK.ragged_attention(jkd, jvd, ps, layer=jnp.int32(1), interpret=True,
                                softcap=softcap, window=window, tree_pos=jnp.asarray(depths),
                                tree_bits=jnp.asarray(bits), **jscales, **jg)
    np.testing.assert_allclose(got.numpy(), np.asarray(kg), **KERNEL_TOL)
    if width == 1:   # a chain is the causal group
        _, chain = TA.ragged_paged_attention_ref(tk, tv, ps, layer=1, logit_softcap=softcap,
                                                 window=window, **tg)
        np.testing.assert_allclose(got.numpy(), chain.numpy(), **REF_TOL)


def test_tree_of_more_than_32_nodes_runs_the_plain_version():
    rng = np.random.default_rng(11)
    parents = TSP.tree_topology(20, 14)   # 34 nodes
    inp = _verify_inputs(rng, t=len(parents), S=2)
    _, _, tk, tv = inp["pools"]
    tg = {name: _t(v) for name, v in inp["group"].items()}
    tree = dict(tree_pos=TSP.tree_depths(parents), tree_mask=TSP.tree_ancestor_mask(parents))
    _, got = TA.ragged_paged_attention(tk, tv, inp["ps"], layer=0, **tg, **tree)
    _, want = TA.ragged_paged_attention_ref(tk, tv, inp["ps"], layer=0, **tg, **tree)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrapper_checks_accept_wide_chain_groups():
    """A causal group may be as wide as the draft model's 64-token ingest
    chunk (the kernel walks its rows 32 at a time); only a tree is capped
    at 32 nodes, by its bitmasks."""
    assert TK.tree_rows(64, None, None) == (0, [], [])
    assert TK.tree_rows(33, None, None) == (0, [], [])
    parents = TSP.tree_topology(4, 2)
    n, pos, bits = TK.tree_rows(6, TSP.tree_depths(parents), TSP.tree_ancestor_bits(parents))
    assert (n, pos, bits) == (6, [0, 1, 2, 3, 4, 1], [1, 3, 7, 15, 31, 33])
    big = TSP.tree_topology(16, 16)
    n, _, bits = TK.tree_rows(32, TSP.tree_depths(big), TSP.tree_ancestor_bits(big))
    assert n == 32 and bits[-1] < 0
    with pytest.raises(ValueError):
        TK.tree_rows(33, np.zeros(33, np.int32), np.ones(33, np.int32))
    with pytest.raises(ValueError):
        TK.tree_rows(6, TSP.tree_depths(parents), None)
    with pytest.raises(ValueError):   # a node without its own bit
        TK.tree_rows(2, [0, 1], [1, 1])
    with pytest.raises(ValueError):   # Td and the tree disagree
        TK.tree_rows(5, TSP.tree_depths(parents), TSP.tree_ancestor_bits(parents))


@pytest.mark.parametrize("td", [33, 64])
def test_wide_chain_group_matches_jax(td):
    """The draft model's ingest shape through the wrapper's CPU path
    against the JAX ragged dispatcher's plain version."""
    rng = np.random.default_rng(td)
    inp = _verify_inputs(rng, t=td, S=2, maxp=16, P=40)
    jk, jv, tk, tv = inp["pools"]
    g = inp["group"]
    _, want = JA.ragged_paged_attention(jk, jv, inp["ps"], layer=jnp.int32(0), use_pallas=False,
                                        **{k: jnp.asarray(v) for k, v in g.items()})
    _, got = TK.ragged_attention(tk, tv, inp["ps"], layer=0, **{k: _t(v) for k, v in g.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF_TOL)


# ---------------------------------------------------------------------------
# the model's tree verify step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ragged", "per_phase"])
def test_verify_step_with_tree_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", "1" if mode == "ragged" else "0")
    jcfg, tcfg = JCFG.get_config("tiny-llama"), TCFG.get_config("tiny-llama")
    params = JL.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = TL.Llama(tcfg, dtype=torch.float32, device="cpu",
                     ragged_attention=mode == "ragged").params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    L, P, ps, S, maxp = jcfg.num_layers, 16, 8, 3, 6
    kvh, d = jcfg.num_kv_heads, jcfg.head_dim_
    jc = JC.PagedKVCache.create(L, P, ps, kvh, d, S, maxp, dtype=jnp.float32)
    tc = TC.PagedKVCache.create(L, P, ps, kvh, d, S, maxp, dtype=torch.float32, device="cpu")
    rows = np.full((S, maxp), -1, np.int32)
    rows[0, :3], rows[2, :4] = [4, 9, 1], [7, 3, 15, 0]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=32).astype(np.int32)
    for slot, n in ((0, 11), (2, 14)):
        padded = np.concatenate([toks[:n], np.zeros(16 - n, np.int32)])
        _, jc = JL.prefill(params, jcfg, jnp.asarray(padded), jnp.int32(n), jc,
                           jnp.int32(slot), jnp.asarray(rows[slot]))
        model.prefill(_t(padded), n, tc, slot, _t(rows[slot]))
    parents = TSP.tree_topology(4, 2)
    depths, anc = TSP.tree_depths(parents), TSP.tree_ancestor_mask(parents)
    active = np.asarray([True, False, True])
    for step in range(2):
        cand = rng.integers(0, jcfg.vocab_size, size=(S, len(parents))).astype(np.int32)
        jl, jc = JL.verify_step(params, jcfg, jnp.asarray(cand), jc, jnp.asarray(active),
                                tree_pos=depths, tree_mask=anc)
        tl, tc = model.verify_step(_t(cand), tc, _t(active), tree_pos=depths, tree_mask=anc)
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=2e-4, atol=2e-4)
        path = np.asarray([[5, 0, 0, 0, 0, 0], [0] * 6, [1, 2, 3, 0, 0, 0]], np.int32)
        jc = JC.commit_tree_path(jc, jnp.asarray(path), jnp.asarray(active))
        TC.commit_tree_path(tc, _t(path), _t(active))
        n_emit = np.asarray([2, 0, 4], np.int32)
        jc = JC.rollback_to_length(jc, jc.lengths + jnp.asarray(n_emit))
        TC.rollback_to_length(tc, tc.lengths + _t(n_emit))
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_tree_rows_equal_sequential_decode():
    """The rescue on the model: a chain head the model does not pick and
    a sibling that it does. The accepted sibling's logits and committed
    row equal those of the same token fed by decode_step."""
    cfg = TCFG.get_config("tiny-llama")
    gen = torch.Generator().manual_seed(3)
    model = TL.Llama(cfg, dtype=torch.float32, device="cpu").init_params(gen)
    prompt = torch.randint(0, cfg.vocab_size, (12,), generator=gen, dtype=torch.int32)
    row = torch.arange(4, dtype=torch.int32)

    def fresh():
        cache = TC.PagedKVCache.create(cfg.num_layers, 8, 8, cfg.num_kv_heads, cfg.head_dim_,
                                       1, 4, dtype=torch.float32, device="cpu")
        logits, _ = model.prefill(torch.cat([prompt, prompt[:4] * 0]), 12, cache, 0, row)
        return cache, int(torch.argmax(logits))

    cache, root = fresh()
    seq, seq_tok = fresh()
    one = torch.ones(1, dtype=torch.bool)
    want, _ = model.decode_step(torch.tensor([root], dtype=torch.int32), seq, one)
    pick = int(torch.argmax(want[0]))
    want2, _ = model.decode_step(torch.tensor([pick], dtype=torch.int32), seq, one)
    parents = TSP.tree_topology(4, 2)
    cand = torch.tensor([[root, (pick + 1) % cfg.vocab_size, 1, 2, 3, pick]], dtype=torch.int32)
    logits, _ = model.verify_step(cand, cache, one, tree_pos=TSP.tree_depths(parents),
                                  tree_mask=TSP.tree_ancestor_mask(parents))
    sp = TS.SamplingParams.defaults(1, "cpu")
    sp.temperature.zero_()
    sp.repeat_penalty.fill_(1.0)
    out, path, n_emit, _ = TS.spec_accept_tree(
        logits, cand, parents, torch.ones((1, 6), dtype=torch.bool), sp,
        torch.zeros((1, cfg.vocab_size), dtype=torch.int32), torch.zeros((1, 8), dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), one, cfg.vocab_size)
    assert out[:2, 0].tolist() == [pick, int(torch.argmax(want2[0]))]
    assert path[0, :2].tolist() == [5, 0] and n_emit.tolist() == [2]
    np.testing.assert_allclose(logits[0, 0].numpy(), want[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits[0, 5].numpy(), want2[0].numpy(), rtol=1e-4, atol=1e-4)
    TC.commit_tree_path(cache, path, one)
    TC.rollback_to_length(cache, cache.lengths + n_emit)
    assert cache.lengths.tolist() == [14] == (seq.lengths).tolist()
    np.testing.assert_allclose(cache.k[:, 1, :6].numpy(), seq.k[:, 1, :6].numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the draft-model drafter
# ---------------------------------------------------------------------------


def _drafters(ingest):
    jcfg = JCFG.get_config("tiny-llama")
    params = JL.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jd = JSP.DraftModelDrafter(JL, jcfg, params, max_slots=3, page_size=8,
                               max_pages_per_slot=4, ingest_width=ingest, dtype=jnp.float32)
    model = TL.Llama(TCFG.get_config("tiny-llama"), dtype=torch.float32,
                     device="cpu").params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    td = TSP.DraftModelDrafter(model, max_slots=3, page_size=8, max_pages_per_slot=4,
                               ingest_width=ingest)
    return jd, td


def test_draft_batch_matches_jax():
    """Multi-round catch-up (ingest width 4), a second call after accepted
    and rejected drafts (rollback to the common prefix), slot isolation,
    overflow and reset_slot."""
    jd, td = _drafters(4)
    rng = np.random.default_rng(5)
    ids = {0: [int(x) for x in rng.integers(0, 256, 11)], 2: [9, 9, 9, 9]}
    for _ in range(3):
        want = jd.draft_batch({s: list(v) for s, v in ids.items()}, 3, 2)
        got = td.draft_batch({s: list(v) for s, v in ids.items()}, 3, 2)
        assert got == want and set(got) == {0, 2}
        for chain, alts in got.values():
            assert len(chain) == 3 and len(alts) == 1 and alts[0] != chain[0]
        assert td._ctx == jd._ctx
        # slot 0 accepts its first draft and a correction follows; slot 2
        # rejects everything and gets a new token
        ids[0] = ids[0] + [got[0][0][0], 17]
        ids[2] = ids[2] + [(got[2][0][0] + 1) % 256]
    assert td.draft_batch({1: list(range(td.max_context))}, 3, 2) == {}
    td.reset_slot(0)
    assert td._ctx[0] == [] and td._ctx[2]
    assert td.draft_ns > 0 and td.kind == "model" and td.tree
    assert td.draft([5, 6, 7], 2) == jd.draft([5, 6, 7], 2)


def test_stable_topk_breaks_ties_to_the_lowest_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    got = TSP.stable_topk(logits, 3)
    want = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert torch.argmax(logits, dim=-1).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)).tolist() == [1, 0]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


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


class _Pair:
    """A JAX engine with draft_model="tiny-llama" (GRIDLLM_RAGGED_ATTN set
    for its mode whenever it builds and runs) and the port's with the same
    target and draft weights."""

    def __init__(self, mode: str):
        self.env = "0" if mode == "per_phase" else "1"
        extra = dict(kv_int8=True) if mode == "int8" else {}
        cfg = dict(TINY, spec_k=4, draft_model="tiny-llama", **extra)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRIDLLM_RAGGED_ATTN", self.env)
            self.je = JEngine(JConfig(**cfg))
        assert isinstance(self.je._drafter, JSP.DraftModelDrafter)
        params = jax.tree_util.tree_map(np.asarray, self.je.params)
        dparams = jax.tree_util.tree_map(np.asarray, self.je._drafter.params)
        self.te = TEngine(TConfig(ragged_attention=mode != "per_phase", **cfg), device="cpu",
                          params=params, draft_params=dparams)

    def same(self, prompts, opts):
        before = dict(self.te.spec_stats), dict(self.je.spec_stats)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRIDLLM_RAGGED_ATTN", self.env)
            want = _batch(self.je, JRequest, prompts, opts)
        got = _batch(self.te, TRequest, prompts, opts)
        for w, g in zip(want, got):
            assert g.token_ids == w.token_ids
            assert g.text == w.text
            assert g.done_reason == w.done_reason
            assert g.cached_tokens == w.cached_tokens
            assert (g.spec_proposed, g.spec_accepted) == (w.spec_proposed, w.spec_accepted)
        for key in ("steps", "proposed", "accepted", "emitted"):
            assert (self.te.spec_stats[key] - before[0][key]
                    == self.je.spec_stats[key] - before[1][key]), key
        return got


@pytest.fixture(scope="module", params=["ragged", "per_phase", "int8"])
def pair(request):
    return _Pair(request.param)


def test_tree_greedy_streams_match_jax(pair):
    for prompt in (REP_PROMPT, "hello world, here we go"):
        (r,) = pair.same([prompt], REP_OPTS)
        assert r.spec_proposed > 0 and r.spec_accepted > 0
    pair.same(["aa aa aa aa", "bc bc bc bc", "hello"],
              {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 10})
    (r,) = pair.same([REP_PROMPT], {**REP_OPTS, "num_predict": 7})
    assert r.eval_count == 7 and r.done_reason == "length"
    (r,) = pair.same(["hello there"], {"temperature": 0.0, "num_predict": 12})


def test_tree_long_prompt_and_warm_repeat_match_jax(pair):
    cold, _ = pair.same([LONG + " tree", "yo"], REP_OPTS)
    (warm,) = pair.same([LONG + " tree"], REP_OPTS)
    assert warm.cached_tokens > 0 and warm.token_ids == cold.token_ids


def test_tree_state_and_sampling(pair):
    te = pair.te
    state = te.batch_state()["specDecode"]
    assert state["drafter"] == "model" and state["treeWidth"] == 2
    assert state["steps"] > 0 and state["draft_ns"] > 0
    assert state["emitted"] >= state["accepted"]
    opts = {"temperature": 0.9, "seed": 11, "num_predict": 12}
    r1 = _batch(te, TRequest, [REP_PROMPT], opts)[0]
    r2 = _batch(te, TRequest, [REP_PROMPT], opts)[0]
    assert r1.token_ids == r2.token_ids and r1.eval_count == 12
    assert all(not ctx for ctx in te._drafter._ctx)   # every finished slot reset


def test_unknown_or_incompatible_draft_model_serves_with_ngrams():
    for name in ("no-such-model", "llama3:8b"):   # unknown; another vocabulary
        eng = TEngine(TConfig(spec_k=2, draft_model=name, **TINY), device="cpu")
        jeng = JEngine(JConfig(spec_decode=True, spec_k=2, draft_model=name, **TINY))
        assert eng._spec_k == 2 and eng._drafter.kind == "ngram" == jeng._drafter.kind
        (r,) = _batch(eng, TRequest, [REP_PROMPT], REP_OPTS)
        assert r.eval_count == 24
    # a draft checkpoint is served since checkpoints were ported: a missing
    # directory fails its load (tests/test_torch_checkpoint.py serves one)
    with pytest.raises(FileNotFoundError):
        TEngine(TConfig(draft_model="tiny-llama", draft_checkpoint="x", **TINY), device="cpu")
    eng = TEngine(TConfig(draft_model="tiny-llama", spec_tree_width=1, **TINY), device="cpu")
    assert dataclasses.asdict(eng.config)["draft_ingest"] == 64
    assert eng.batch_state()["specDecode"]["treeWidth"] == 1
