"""ops.attention of the PyTorch port against the JAX package.

The port's plain versions — `attention_prefill_ref` and
`ragged_paged_attention_ref`, which the CUDA kernels are held to on the
card — against the JAX package's Pallas kernels run in interpret mode
(flash_prefill, ragged_attention) and its jnp references, on the shapes
of tests/test_ragged_attention.py: page straddles, an empty slot, a
partial last page, sliding window, softcap, chunk with group, Td in
{1, 5}. float32 with rtol/atol 1e-4, far inside the 3e-2 bf16 bound.
Head dim 256 (gemma2's) for every dispatcher's plain version: prefill,
the ragged regions and the per-phase decode, chunk and verify, with
gemma2's grouping (G = 2), softcap 50 and a window.
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


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("t,h,kvh,d,lens,window,softcap", [
    (16, 4, 2, 16, [16], 0, 0.0),
    (32, 4, 4, 16, [32, 7], 0, 0.0),
    (128, 8, 2, 32, [128, 77], 0, 0.0),
    (64, 4, 2, 16, [64, 40], 8, 0.0),
    (64, 4, 2, 16, [50], 16, 30.0),
    (48, 4, 2, 256, [48, 30], 0, 0.0),     # head dim 256
    (64, 2, 1, 256, [64], 16, 50.0),       # gemma2: G = 2, window, softcap 50
])
def test_prefill_ref_matches_flash_kernel(t, h, kvh, d, lens, window, softcap):
    rng = np.random.default_rng(t + len(lens))
    b = len(lens)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kvh, d)).astype(np.float32)
    sl = np.asarray(lens, np.int32)
    kern = np.asarray(PK.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(sl), interpret=True, softcap=softcap,
                                       window=window))
    ref = np.asarray(JA.attention_prefill_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jnp.asarray(sl), logit_softcap=softcap,
                                              window=window))
    got = TA.attention_prefill_ref(_t(q), _t(k), _t(v), _t(sl), logit_softcap=softcap,
                                   window=window).numpy()
    via_wrapper = TK.flash_prefill(_t(q), _t(k), _t(v), _t(sl), softcap=softcap,
                                   window=window).numpy()
    np.testing.assert_array_equal(via_wrapper, got)
    for i, ln in enumerate(lens):  # padding rows are unspecified in the kernel
        np.testing.assert_allclose(got[i, :ln], kern[i, :ln], **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def _ragged_inputs(rng, td, d=16, h=4, kvh=2):
    ps, S, maxp, C = 8, 3, 6, 16
    kp = rng.normal(size=(2, 32, ps, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(2, 32, ps, kvh, d)).astype(np.float32)
    table = rng.choice(26, size=S * maxp, replace=False).reshape(S, maxp).astype(np.int32)
    table[1, 1:] = -1  # the empty slot owns one page, the rest unmapped
    return dict(
        kp=kp, vp=vp, ps=ps,
        chunk=dict(q_chunk=rng.normal(size=(1, C, h, d)).astype(np.float32),
                   chunk_row=np.asarray([26, 27, 28, 29, 30, 31], np.int32),
                   chunk_start=16, chunk_total=16 + 11,  # 11 of 16 rows valid
                   k_chunk=rng.normal(size=(C, kvh, d)).astype(np.float32),
                   v_chunk=rng.normal(size=(C, kvh, d)).astype(np.float32)),
        group=dict(q_group=rng.normal(size=(S, td, h, d)).astype(np.float32),
                   page_table=table,
                   group_lengths=np.asarray([13, 0, 37], np.int32),  # straddles, empty
                   k_group=rng.normal(size=(S, td, kvh, d)).astype(np.float32),
                   v_group=rng.normal(size=(S, td, kvh, d)).astype(np.float32)),
    )


@pytest.mark.parametrize("regions,td,softcap,window", [
    ("chunk", 1, 0.0, 0),
    ("group", 1, 0.0, 0),      # decode
    ("group", 5, 0.0, 0),      # spec-verify width
    ("both", 1, 0.0, 0),       # a mixed step: chunk + decode in one launch
    ("both", 5, 0.0, 6),       # sliding window
    ("group", 1, 30.0, 4),     # softcap + window
    ("chunk", 1, 30.0, 0),     # softcap
])
def test_ragged_ref_matches_ragged_kernel(regions, td, softcap, window):
    _check_ragged(regions, td, softcap, window)


@pytest.mark.parametrize("regions,td,softcap,window", [
    ("group", 1, 50.0, 8),     # gemma2 decode on an even layer
    ("group", 5, 50.0, 0),     # verify on an odd layer
    ("both", 1, 50.0, 8),      # a mixed step
    ("chunk", 1, 0.0, 0),
])
def test_ragged_ref_matches_ragged_kernel_d256(regions, td, softcap, window):
    """Head dim 256 at gemma2's grouping (H 2, KVH 1)."""
    _check_ragged(regions, td, softcap, window, d=256, h=2, kvh=1)


def _check_ragged(regions, td, softcap, window, **dims):
    rng = np.random.default_rng(td * 10 + window)
    inp = _ragged_inputs(rng, td, **dims)
    kw = {}
    if regions in ("chunk", "both"):
        kw.update(inp["chunk"])
    if regions in ("group", "both"):
        kw.update(inp["group"])
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else jnp.int32(v))
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jc, jg = PK.ragged_attention(jnp.asarray(inp["kp"]), jnp.asarray(inp["vp"]), inp["ps"],
                                 layer=jnp.int32(1), interpret=True, softcap=softcap,
                                 window=window, **jkw)
    rc, rg = JA.ragged_paged_attention_ref(
        jnp.asarray(inp["kp"]), jnp.asarray(inp["vp"]), inp["ps"], layer=jnp.int32(1),
        logit_softcap=softcap, window=window, **jkw)
    tc, tg = TA.ragged_paged_attention_ref(_t(inp["kp"]), _t(inp["vp"]), inp["ps"], layer=1,
                                           logit_softcap=softcap, window=window, **tkw)
    wc, wg = TK.ragged_attention(_t(inp["kp"]), _t(inp["vp"]), inp["ps"], layer=1,
                                 softcap=softcap, window=window, **tkw)
    if "q_chunk" in kw:
        valid = kw["chunk_total"] - kw["chunk_start"]
        np.testing.assert_array_equal(wc.numpy(), tc.numpy())
        np.testing.assert_allclose(tc.numpy()[:, :valid], np.asarray(jc)[:, :valid], **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(rc), **TOL)
    if "q_group" in kw:
        np.testing.assert_array_equal(wg.numpy(), tg.numpy())
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(rg), **TOL)


def test_ragged_wrapper_refuses_unported_legs():
    """Every leg is ported; the int8 leg's scales and the tree leg's
    operands must come in pairs."""
    rng = np.random.default_rng(0)
    inp = _ragged_inputs(rng, 1)
    g = {k: _t(v) for k, v in inp["group"].items()}
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        TK.ragged_attention(_t(inp["kp"]), _t(inp["vp"]), 8, k_scale=torch.ones(1), **g)
    with pytest.raises(ValueError, match="tree_pos and tree_bits"):
        TK.ragged_attention(_t(inp["kp"]), _t(inp["vp"]), 8, tree_bits=torch.ones(1), **g)


# ---------------------------------------------------------------------------
# the per-phase dispatchers' plain versions at head dim 256
# ---------------------------------------------------------------------------

D256_PS, D256_H, D256_KVH, D256 = 8, 2, 1, 256


def _d256_pools(rng, pages=32):
    shape = (2, pages, D256_PS, D256_KVH, D256)
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 50.0)])
def test_decode_ref_matches_paged_decode_kernel_d256(window, softcap):
    rng = np.random.default_rng(60 + window)
    s, maxp = 3, 6
    kp, vp = _d256_pools(rng)
    table = rng.choice(30, size=s * maxp, replace=False).reshape(s, maxp).astype(np.int32)
    lens = np.asarray([13, 1, 37], np.int32)
    q = rng.normal(size=(s, D256_H, D256)).astype(np.float32)
    kc = rng.normal(size=(s, D256_KVH, D256)).astype(np.float32)
    vc = rng.normal(size=(s, D256_KVH, D256)).astype(np.float32)
    kern = np.asarray(PK.paged_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lens)), page_size=D256_PS,
        layer=jnp.int32(1), interpret=True, softcap=softcap, window=window,
        k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc)))
    got = TA.paged_attention_decode(*(_t(a) for a in (q, kp, vp, table, lens)), D256_PS,
                                    k_cur=_t(kc), v_cur=_t(vc), layer=1, logit_softcap=softcap,
                                    window=window).numpy()
    wrapper = TK.paged_decode(*(_t(a) for a in (q, kp, vp, table, lens)), D256_PS,
                              _t(kc), _t(vc), layer=1, softcap=softcap, window=window).numpy()
    np.testing.assert_array_equal(wrapper, got)
    np.testing.assert_allclose(got, kern, **TOL)


@pytest.mark.parametrize("c,start,valid,window,softcap", [
    (16, 24, 16, 0, 0.0),
    (16, 21, 12, 9, 50.0),     # start off a page, window, softcap
])
def test_chunk_ref_matches_prefix_chunk_kernel_d256(c, start, valid, window, softcap):
    rng = np.random.default_rng(70 + window)
    kp, vp = _d256_pools(rng)
    row = rng.choice(32, size=12, replace=False).astype(np.int32)
    q = rng.normal(size=(1, c, D256_H, D256)).astype(np.float32)
    kc = rng.normal(size=(c, D256_KVH, D256)).astype(np.float32)
    vc = rng.normal(size=(c, D256_KVH, D256)).astype(np.float32)
    total = start + valid
    kern = np.asarray(PK.prefix_chunk(
        *(jnp.asarray(a) for a in (q, kp, vp, row)), jnp.int32(start), jnp.int32(total),
        D256_PS, layer=jnp.int32(1), interpret=True, softcap=softcap, window=window,
        k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc)))
    got = TA.attention_prefix_chunk(*(_t(a) for a in (q, kp, vp, row)), start, total,
                                    D256_PS, k_cur=_t(kc), v_cur=_t(vc), layer=1,
                                    logit_softcap=softcap, window=window).numpy()
    np.testing.assert_allclose(got[:, :valid], kern[:, :valid], **TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 50.0)])
def test_verify_ref_matches_prefix_chunk_kernel_d256(window, softcap):
    """The verify over slots: each slot's candidates against the TPU
    prefix_chunk kernel at start = length, total = length + T."""
    rng = np.random.default_rng(80 + window)
    s, t, maxp = 2, 5, 6
    kp, vp = _d256_pools(rng)
    table = rng.choice(30, size=s * maxp, replace=False).reshape(s, maxp).astype(np.int32)
    lens = np.asarray([13, 30], np.int32)
    q = rng.normal(size=(s, t, D256_H, D256)).astype(np.float32)
    kc = rng.normal(size=(s, t, D256_KVH, D256)).astype(np.float32)
    vc = rng.normal(size=(s, t, D256_KVH, D256)).astype(np.float32)
    got = TA.paged_attention_verify(*(_t(a) for a in (q, kp, vp, table, lens)), D256_PS,
                                    _t(kc), _t(vc), layer=1, logit_softcap=softcap,
                                    window=window).numpy()
    for i, ln in enumerate(lens):
        kern = np.asarray(PK.prefix_chunk(
            jnp.asarray(q[i:i + 1]), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table[i]),
            jnp.int32(ln), jnp.int32(ln + t), D256_PS, layer=jnp.int32(1), interpret=True,
            softcap=softcap, window=window, k_cur=jnp.asarray(kc[i]), v_cur=jnp.asarray(vc[i])))
        np.testing.assert_allclose(got[i:i + 1], kern, **TOL)
