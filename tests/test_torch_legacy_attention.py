"""The per-phase attention dispatchers of the PyTorch port against the JAX
package: `paged_attention_decode`, `attention_prefix_chunk` and
`paged_attention_verify` (the attention of the ragged-off model paths).

The port's dispatchers and plain versions (which the `paged_decode` and
`prefix_chunk` CUDA kernels are held to on the card) against the JAX
package's Pallas kernels run in interpret mode (paged_decode,
prefix_chunk, as tests/test_pallas.py runs them) and its jnp dispatchers
and references, on full [L, P, ps, KVH, D] pools with a layer selected:
page straddles, an empty slot, the capacity edge, sliding window, softcap,
C in {5, 128} with a start that is not page-aligned, a chunk already in the
pool, and a lane-padded pool. float32, rtol/atol 1e-4 (inside the 1e-3
float32 bound of the kernels). On CPU tensors the kernel wrappers are the
plain versions, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.ops import attention as TA
from gridllm_torch.ops import cuda_kernels as TK
from gridllm_tpu.ops import attention as JA
from gridllm_tpu.ops import pallas_kernels as PK

TOL = dict(rtol=1e-4, atol=1e-4)
PS, KVH, H, L = 8, 2, 4, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(rng, d=16, pages=64):
    shape = (L, pages, PS, KVH, d)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _decode_inputs(rng, d=16, dq=None):
    dq = dq or d
    s, maxp = 4, 6
    kp, vp = _pools(rng, d)
    table = rng.choice(60, size=s * maxp, replace=False).reshape(s, maxp).astype(np.int32)
    table[1, 1:] = -1                                  # the empty slot owns one page
    lens = np.asarray([13, 0, 37, maxp * PS], np.int32)  # straddle, empty, capacity edge
    return dict(q=rng.normal(size=(s, H, dq)).astype(np.float32), kp=kp, vp=vp, table=table,
                lens=lens, k_cur=rng.normal(size=(s, KVH, dq)).astype(np.float32),
                v_cur=rng.normal(size=(s, KVH, dq)).astype(np.float32), cap=maxp * PS)


@pytest.mark.parametrize("merge_cur,window,softcap", [
    (True, 0, 0.0),
    (True, 6, 0.0),     # sliding window
    (True, 0, 30.0),    # softcap
    (False, 0, 0.0),    # the current token already in the pool
    (False, 5, 30.0),
])
def test_decode_matches_jax(merge_cur, window, softcap):
    inp = _decode_inputs(np.random.default_rng(window + int(softcap) + merge_cur))
    cur = dict(k_cur=inp["k_cur"], v_cur=inp["v_cur"]) if merge_cur else {}
    jcur = {k: jnp.asarray(v) for k, v in cur.items()}
    tcur = {k: _t(v) for k, v in cur.items()}
    args = (inp["q"], inp["kp"], inp["vp"], inp["table"], inp["lens"])
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    kern = np.asarray(PK.paged_decode(*jargs, page_size=PS, layer=jnp.int32(1),
                                      interpret=True, softcap=softcap, window=window, **jcur))
    ref = np.asarray(JA.paged_attention_decode_ref(
        jargs[0], jargs[1][1], jargs[2][1], jargs[3], jargs[4], PS, logit_softcap=softcap,
        window=window, **jcur))
    disp = np.asarray(JA.paged_attention_decode(
        *jargs, PS, layer=jnp.int32(1), use_pallas=False, logit_softcap=softcap,
        window=window, **jcur))
    got = TA.paged_attention_decode(*targs, PS, layer=1, logit_softcap=softcap,
                                    window=window, **tcur).numpy()
    plain = TA.paged_attention_decode_ref(targs[0], targs[1][1], targs[2][1], targs[3],
                                          targs[4], PS, logit_softcap=softcap, window=window,
                                          **tcur).numpy()
    wrapper = TK.paged_decode(*targs, PS, layer=1, softcap=softcap, window=window,
                              **tcur).numpy()
    np.testing.assert_array_equal(wrapper, plain)
    np.testing.assert_array_equal(got, plain)
    # without the current token a length-0 slot is unspecified; the TPU
    # kernel merges the current token even at the capacity edge, where the
    # reference (and the port) drop it: the slot is finished there
    lens = inp["lens"]
    rows = (lens > 0) if not merge_cur else np.ones_like(lens, bool)
    np.testing.assert_allclose(got[rows], ref[rows], **TOL)
    np.testing.assert_allclose(got[rows], disp[rows], **TOL)
    in_cap = rows & (lens < inp["cap"])
    np.testing.assert_allclose(got[in_cap], kern[in_cap], **TOL)


def test_decode_lane_padded_pool_matches_jax():
    """q of head dim 16 against a pool padded to 32: padded at the boundary,
    sliced back, as the JAX dispatcher does."""
    inp = _decode_inputs(np.random.default_rng(7), d=32, dq=16)
    args = (inp["q"], inp["kp"], inp["vp"], inp["table"], inp["lens"])
    want = np.asarray(JA.paged_attention_decode(
        *[jnp.asarray(a) for a in args], PS, k_cur=jnp.asarray(inp["k_cur"]),
        v_cur=jnp.asarray(inp["v_cur"]), layer=jnp.int32(0), use_pallas=False, window=9))
    got = TA.paged_attention_decode(*[_t(a) for a in args], PS, k_cur=_t(inp["k_cur"]),
                                    v_cur=_t(inp["v_cur"]), layer=0, window=9)
    assert got.shape == (4, H, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# chunked prefill against the paged prefix
# ---------------------------------------------------------------------------


def _chunk_inputs(rng, c, d=16, dq=None):
    dq = dq or d
    maxp = 24                                          # capacity 192 tokens
    kp, vp = _pools(rng, d)
    row = rng.choice(64, size=maxp, replace=False).astype(np.int32)
    return dict(q=rng.normal(size=(1, c, H, dq)).astype(np.float32), kp=kp, vp=vp, row=row,
                k_cur=rng.normal(size=(c, KVH, dq)).astype(np.float32),
                v_cur=rng.normal(size=(c, KVH, dq)).astype(np.float32), cap=maxp * PS)


@pytest.mark.parametrize("c,start,valid,window,softcap,fresh", [
    (5, 13, 5, 0, 0.0, True),        # verify width, start not page-aligned
    (5, 13, 5, 4, 30.0, True),       # window + softcap
    (128, 21, 100, 0, 0.0, True),    # a ragged prefill chunk
    (128, 40, 128, 16, 0.0, True),   # windowed chunk
    (128, 0, 77, 0, 0.0, True),      # the first chunk: no prefix
    (8, 16, 8, 0, 0.0, False),       # the chunk already in the pool
    (5, 189, 5, 0, 0.0, True),       # rows past the capacity edge are cut
])
def test_prefix_chunk_matches_jax(c, start, valid, window, softcap, fresh):
    inp = _chunk_inputs(np.random.default_rng(c + start + window), c)
    total = start + valid
    cur = dict(k_cur=inp["k_cur"], v_cur=inp["v_cur"]) if fresh else {}
    jcur = {k: jnp.asarray(v) for k, v in cur.items()}
    tcur = {k: _t(v) for k, v in cur.items()}
    jq, jkp, jvp, jrow = (jnp.asarray(inp[k]) for k in ("q", "kp", "vp", "row"))
    tq, tkp, tvp, trow = (_t(inp[k]) for k in ("q", "kp", "vp", "row"))
    ref = np.asarray(JA._prefix_chunk_ref(
        jq, jkp, jvp, jrow, jnp.int32(start), jnp.int32(total), PS, layer=jnp.int32(1),
        logit_softcap=softcap, window=window, **jcur))
    disp = np.asarray(JA.attention_prefix_chunk(
        jq, jkp, jvp, jrow, jnp.int32(start), jnp.int32(total), PS, layer=jnp.int32(1),
        use_pallas=False, logit_softcap=softcap, window=window, **jcur))
    got = TA.attention_prefix_chunk(tq, tkp, tvp, trow, start, total, PS, layer=1,
                                    logit_softcap=softcap, window=window, **tcur).numpy()
    plain = TA._prefix_chunk_ref(tq, tkp[1], tvp[1], trow, start, total, PS,
                                 logit_softcap=softcap, window=window, **tcur).numpy()
    # start/total as one-element int32 tensors, as the model and the verify
    # loop pass them to the kernel
    wrapper = TK.prefix_chunk(tq, tkp, tvp, trow, torch.tensor([start], dtype=torch.int32),
                              torch.tensor([total], dtype=torch.int32), PS, layer=1,
                              softcap=softcap, window=window, **tcur).numpy()
    np.testing.assert_array_equal(wrapper, plain)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, disp, **TOL)
    if fresh and start + c <= inp["cap"]:  # the TPU kernel needs the fresh rows
        kern = np.asarray(PK.prefix_chunk(
            jq, jkp, jvp, jrow, jnp.int32(start), jnp.int32(total), PS, layer=jnp.int32(1),
            interpret=True, softcap=softcap, window=window, **jcur))
        np.testing.assert_allclose(got[:, :valid], kern[:, :valid], **TOL)


def test_prefix_chunk_lane_padded_pool_matches_jax():
    inp = _chunk_inputs(np.random.default_rng(3), 5, d=32, dq=16)
    want = np.asarray(JA.attention_prefix_chunk(
        jnp.asarray(inp["q"]), jnp.asarray(inp["kp"]), jnp.asarray(inp["vp"]),
        jnp.asarray(inp["row"]), jnp.int32(29), jnp.int32(34), PS,
        k_cur=jnp.asarray(inp["k_cur"]), v_cur=jnp.asarray(inp["v_cur"]),
        layer=jnp.int32(0), use_pallas=False, window=11))
    got = TA.attention_prefix_chunk(_t(inp["q"]), _t(inp["kp"]), _t(inp["vp"]),
                                    _t(inp["row"]), 29, 34, PS, k_cur=_t(inp["k_cur"]),
                                    v_cur=_t(inp["v_cur"]), layer=0, window=11)
    assert got.shape == (1, 5, H, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# speculative verify
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 7])
def test_verify_matches_jax(window):
    """One prefix chunk per slot (start read from the lengths tensor, total
    = start + T) against the JAX package's batched verify attention."""
    rng = np.random.default_rng(40 + window)
    s, t, maxp = 3, 5, 6
    kp, vp = _pools(rng)
    table = rng.choice(60, size=s * maxp, replace=False).reshape(s, maxp).astype(np.int32)
    table[1, 1:] = -1
    lens = np.asarray([13, 0, 30], np.int32)
    q = rng.normal(size=(s, t, H, 16)).astype(np.float32)
    kc = rng.normal(size=(s, t, KVH, 16)).astype(np.float32)
    vc = rng.normal(size=(s, t, KVH, 16)).astype(np.float32)
    want = np.asarray(JA.paged_attention_verify(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lens)), PS, jnp.asarray(kc),
        jnp.asarray(vc), layer=jnp.int32(1), use_pallas=False, window=window))
    got = TA.paged_attention_verify(*(_t(a) for a in (q, kp, vp, table, lens)), PS, _t(kc),
                                    _t(vc), layer=1, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = TA.paged_attention_verify_ref(_t(q), _t(kp[1]), _t(vp[1]), _t(table), _t(lens),
                                          PS, _t(kc), _t(vc), window=window)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_verify_refuses_tree():
    """The per-phase verify never routes a token tree through the
    prefix_chunk loop (it cannot express an ancestor mask): a tree runs the
    plain version's tree branch, as in the JAX package."""
    rng = np.random.default_rng(9)
    kp = _t(rng.normal(size=(L, 4, PS, KVH, 16)).astype(np.float32))
    vp = _t(rng.normal(size=(L, 4, PS, KVH, 16)).astype(np.float32))
    q = _t(rng.normal(size=(1, 3, H, 16)).astype(np.float32))
    kc = _t(rng.normal(size=(1, 3, KVH, 16)).astype(np.float32))
    vc = _t(rng.normal(size=(1, 3, KVH, 16)).astype(np.float32))
    table, lengths = torch.tensor([[2, 0]], dtype=torch.int32), torch.tensor([5], dtype=torch.int32)
    tree = dict(tree_pos=np.asarray([0, 1, 1]),
                tree_mask=np.asarray([[1, 0, 0], [1, 1, 0], [1, 0, 1]], bool))
    got = TA.paged_attention_verify(q, kp, vp, table, lengths, PS, kc, vc, layer=1, **tree)
    want = TA.paged_attention_verify_ref(q, kp[1], vp[1], table, lengths, PS, kc, vc, **tree)
    assert torch.equal(got, want)
    chain = TA.paged_attention_verify_ref(q, kp[1], vp[1], table, lengths, PS, kc, vc)
    assert torch.equal(got[:, :2], chain[:, :2]) and not torch.equal(got[:, 2], chain[:, 2])