"""Attention: causal prefill, unified ragged paged attention, and the
per-phase paged dispatchers the model uses with ragged attention off.

Public entry points (`attention_prefill`, `ragged_paged_attention`,
`paged_attention_decode`, `attention_prefix_chunk`,
`paged_attention_verify`) run the hand-written CUDA kernels on CUDA
tensors (ops/cuda_kernels.py) and the plain PyTorch versions here
(`*_ref`) on CPU tensors. The plain versions
are copies of the JAX package's references (ops/attention.py there) and
are the numerical oracle the kernels are held to;
`attention_prefill_blocked_ref` computes `attention_prefill_ref`'s
function in bounded memory for long buckets. `attention_prefill` routes a
bucket to `flash_prefill` or `flash_prefill_streamed` as the JAX package
does (`prefill_kernel`). Softmax is computed in float32 whatever the
input dtype.

GQA convention: q has H heads, k/v have KVH heads, H % KVH == 0; query head
h reads kv head h // (H // KVH).

Pools may be int8 (`QuantPages`): the plain versions read them through
`gather_kv`, which dequantizes; `ragged_paged_attention` hands values and
scales to the kernel's int8 leg; the per-phase dispatchers have no int8
kernel (nor has the JAX package) and run the plain versions.

Tree verify (a draft model's token tree, `tree_pos`/`tree_mask`):
`ragged_paged_attention` packs the ancestor mask into int32 bitmasks for
the kernel's tree leg (trees of at most 32 nodes; larger ones run the
plain version, as in the JAX package); `paged_attention_verify` always
runs the plain version's tree branch, since no per-phase kernel carries an
ancestor mask, here or in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gridllm_torch.ops.kvcache import QuantPages, gather_kv, record_kernel_path

# masking value of every softmax here and in the kernels: finite in
# float32, so exp(x - m) underflows to exactly 0 for masked columns
_NEG_INF = -1e30

# the JAX package's budget for flash_prefill's resident per-head K+V
# (`_FLASH_KV_VMEM_CAP` there); buckets past it run the streamed kernel
_FLASH_KV_VMEM_CAP = 8 * 1024 * 1024


def _lane_pad_dim(d: int) -> int:
    """Head dim rounded up to the TPU's 128-lane tile (`lane_pad_dim` of
    the JAX package), used only to route prefill as the JAX package does."""
    return -(-d // 128) * 128


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh logit capping, applied BEFORE masking (HF Gemma2 order)."""
    return cap * torch.tanh(logits / cap) if cap else logits


def _masked_softmax_av(logits: torch.Tensor, mask: torch.Tensor,
                       values: torch.Tensor, cap: float, eq: str) -> torch.Tensor:
    logits = _softcap(logits, cap)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum(eq, probs, values)


def attention_prefill_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seq_lens: torch.Tensor,
    logit_softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Causal self-attention over one self-contained prompt bucket.

    q: [B, T, H, D]; k/v: [B, T, KVH, D]; seq_lens: [B] valid tokens
    (padding keys masked out). `window` > 0 attends only keys at distance
    < window. Returns [B, T, H, D] in q's dtype."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, t, kvh, g, d)
    logits = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * scale
    pos = torch.arange(t, device=q.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    mask = q_pos >= k_pos
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    valid = k_pos < seq_lens.to(q.device)[:, None, None, None, None]
    mask = mask[None, None, None] & valid
    out = _masked_softmax_av(logits, mask, v.float(), logit_softcap,
                             "bkgts,bskd->btkgd")
    return out.reshape(b, t, h, d).to(q.dtype)


def attention_prefill_blocked_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seq_lens: torch.Tensor,
    logit_softcap: float = 0.0,
    window: int = 0,
    block: int = 1024,
) -> torch.Tensor:
    """`attention_prefill_ref`'s function, `block` query rows at a time
    against the keys those rows can see (the causal bound, and with a
    window the floor of the block's first row), so memory stays bounded at
    long T: a [B, KVH, G, block, <= T] logits tensor instead of [.., T, T].
    The plain version of the `flash_prefill_streamed` kernel. Valid rows
    equal the reference's; a padding row with no visible key averages
    another key range than the reference (such rows are unspecified)."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    valid_len = seq_lens.to(q.device)[:, None, None, None, None]
    out = torch.empty_like(q)
    for i0 in range(0, t, block):
        i1 = min(i0 + block, t)
        j0 = max(i0 - window + 1, 0) if window > 0 else 0
        qf = q[:, i0:i1].float().reshape(b, i1 - i0, kvh, g, d)
        logits = torch.einsum("btkgd,bskd->bkgts", qf, k[:, j0:i1].float()) * scale
        q_pos = torch.arange(i0, i1, device=q.device)[:, None]
        k_pos = torch.arange(j0, i1, device=q.device)[None, :]
        mask = q_pos >= k_pos
        if window > 0:
            mask = mask & (q_pos - k_pos < window)
        mask = mask[None, None, None] & (k_pos < valid_len)
        blk = _masked_softmax_av(logits, mask, v[:, j0:i1].float(), logit_softcap,
                                 "bkgts,bskd->btkgd")
        out[:, i0:i1] = blk.reshape(b, i1 - i0, h, d).to(q.dtype)
    return out


def paged_attention_decode_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    page_size: int,
    k_cur: torch.Tensor | None = None,
    v_cur: torch.Tensor | None = None,
    logit_softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """One-token-per-slot decode attention against one layer's pool.

    q: [S, H, D]; k_pages/v_pages: [P, ps, KVH, D]; page_table [S, maxp].
    Without k_cur/v_cur, lengths counts the current token (already in the
    pool). With them ([S, KVH, D]), lengths counts the cached prefix only
    and the current token is overlaid at position lengths[s] (dropped at
    the capacity edge). Returns [S, H, D]."""
    s, h, d = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    outs = []
    for i in range(s):
        ks, vs = gather_kv(k_pages, v_pages, page_table[i], page_size)
        ks, vs = ks.float(), vs.float()
        ln = int(lengths[i])
        total = ln
        if k_cur is not None:
            if ln < ks.shape[0]:
                ks[ln] = k_cur[i].float()
                vs[ln] = v_cur[i].float()
            total = ln + 1
        qf = q[i].float().reshape(kvh, g, d)
        logits = torch.einsum("kgd,nkd->kgn", qf, ks) * scale
        k_pos = torch.arange(ks.shape[0], device=q.device)
        valid = k_pos < total
        if window > 0:
            valid = valid & ((total - 1) - k_pos < window)
        out = _masked_softmax_av(logits, valid[None, None, :], vs,
                                 logit_softcap, "kgn,nkd->kgd")
        outs.append(out.reshape(h, d))
    return torch.stack(outs).to(q.dtype)


def _prefix_chunk_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    table_row: torch.Tensor,
    start: int,
    total_len: int,
    page_size: int,
    k_cur: torch.Tensor | None = None,
    v_cur: torch.Tensor | None = None,
    logit_softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Chunked-prefill attention against one layer's paged prefix.

    q: [1, T, H, D] at absolute positions start + arange(T); table_row
    [maxp]; total_len = start + valid rows. With k_cur/v_cur ([T, KVH, D])
    the chunk's fresh K/V are overlaid at positions start + i (rows past
    the capacity edge are cut). Returns [1, T, H, D]."""
    _, t, h, d = q.shape
    kvh = k_pages.shape[-2]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    ks, vs = gather_kv(k_pages, v_pages, table_row, page_size)
    ks, vs = ks.float(), vs.float()
    if k_cur is not None:
        n = ks.shape[0]
        m = max(min(t, n - start), 0)
        ks[start:start + m] = k_cur[:m].float()
        vs[start:start + m] = v_cur[:m].float()
    qf = q.float().reshape(t, kvh, g, d)
    q_pos = start + torch.arange(t, device=q.device)
    k_pos = torch.arange(ks.shape[0], device=q.device)
    dist = q_pos[:, None] - k_pos[None, :]
    mask = (dist >= 0) & (k_pos[None, :] < total_len)
    if window > 0:
        mask = mask & (dist < window)
    logits = torch.einsum("tkgd,nkd->kgtn", qf, ks) * scale
    out = _masked_softmax_av(logits, mask[None, None], vs, logit_softcap,
                             "kgtn,nkd->tkgd")
    return out.reshape(1, t, h, d).to(q.dtype)


def paged_attention_verify_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    page_size: int,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    logit_softcap: float = 0.0,
    window: int = 0,
    tree_pos: torch.Tensor | None = None,
    tree_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched multi-token decode attention (S slots × T candidates each)
    against one layer's pool: candidate i of slot s sits at position
    lengths[s] + i and attends the prefix plus the candidates before it.
    q: [S, T, H, D]; k_cur/v_cur: [S, T, KVH, D]. Returns [S, T, H, D].

    Tree verify: with `tree_pos` ([T] node depths) and `tree_mask` ([T, T]
    bool, row i marks node i's ancestors and itself) the T candidates are a
    token tree shared by all slots. Node i's K/V stay at STORAGE position
    lengths[s] + i, but its LOGICAL position is lengths[s] + tree_pos[i]:
    its query attends the whole prefix plus exactly its tree ancestors and
    itself, with the window measured on logical distance."""
    if tree_pos is None:
        s, t = q.shape[:2]
        outs = [
            _prefix_chunk_ref(
                q[i][None], k_pages, v_pages, page_table[i], int(lengths[i]),
                int(lengths[i]) + t, page_size, k_cur=k_cur[i], v_cur=v_cur[i],
                logit_softcap=logit_softcap, window=window,
            )[0]
            for i in range(s)
        ]
        return torch.stack(outs)
    return torch.stack([
        _tree_verify_ref(q[i], k_pages, v_pages, page_table[i], int(lengths[i]), page_size,
                         k_cur[i], v_cur[i], tree_pos, tree_mask, logit_softcap, window)
        for i in range(q.shape[0])
    ])


def _tree_verify_ref(q, k_pages, v_pages, table_row, start: int, page_size: int, k_cur,
                     v_cur, tree_pos, tree_mask, logit_softcap: float, window: int):
    """One slot of the tree branch of paged_attention_verify_ref (the JAX
    package's `one_slot` tree trace): q [T, H, D] → [T, H, D]."""
    t, h, d = q.shape
    kvh = k_pages.shape[-2]
    g = h // kvh
    ks, vs = gather_kv(k_pages, v_pages, table_row, page_size)
    ks, vs = ks.float(), vs.float()
    n = ks.shape[0]
    m = max(min(t, n - start), 0)   # candidates past the capacity edge are cut
    ks[start:start + m] = k_cur[:m].float()
    vs[start:start + m] = v_cur[:m].float()
    dev = q.device
    tree_pos = torch.as_tensor(tree_pos, dtype=torch.int64, device=dev)
    tree_mask = torch.as_tensor(tree_mask, dtype=torch.bool, device=dev)
    k_pos = torch.arange(n, device=dev)
    total = start + t
    # query node i at logical start + depth[i]; a key in the candidate
    # region [start, start + T) is node k_pos - start at logical start +
    # its depth, a prefix key at its own index
    q_pos = start + tree_pos
    is_cand = (k_pos >= start) & (k_pos < total)
    node = torch.clamp(k_pos - start, 0, t - 1)
    k_log = torch.where(is_cand, start + tree_pos[node], k_pos)
    dist = q_pos[:, None] - k_log[None, :]
    mask = torch.where(is_cand[None, :], tree_mask[:, node], dist >= 0)
    if window > 0:
        mask = mask & (dist < window)
    mask = mask & (k_pos[None, :] < total)
    qf = q.float().reshape(t, kvh, g, d)
    logits = torch.einsum("tkgd,nkd->kgtn", qf, ks) * (1.0 / (d ** 0.5))
    out = _masked_softmax_av(logits, mask[None, None], vs, logit_softcap, "kgtn,nkd->tkgd")
    return out.reshape(t, h, d).to(q.dtype)


def _layer_pool(pages, layer: int | None):
    """One layer's pool: a 4-dim pool as it is, else layer `layer` (0 when
    None) of the full stack; for an int8 pool, its values and scales."""
    if pages.dim() == 4:
        return pages
    li = 0 if layer is None else layer
    return pages.layer(li) if isinstance(pages, QuantPages) else pages[li]


def ragged_paged_attention_ref(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_size: int,
    q_chunk: torch.Tensor | None = None,
    chunk_row: torch.Tensor | None = None,
    chunk_start: int | None = None,
    chunk_total: int | None = None,
    k_chunk: torch.Tensor | None = None,
    v_chunk: torch.Tensor | None = None,
    q_group: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,
    group_lengths: torch.Tensor | None = None,
    k_group: torch.Tensor | None = None,
    v_group: torch.Tensor | None = None,
    layer: int | None = None,
    logit_softcap: float = 0.0,
    window: int = 0,
    tree_pos: torch.Tensor | None = None,
    tree_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Plain version of the unified ragged launch: the per-region legacy
    references composed (see `ragged_paged_attention` for the contract).
    A tree (`tree_pos`/`tree_mask`) routes the group region through the
    tree branch of paged_attention_verify_ref."""
    kp, vp = _layer_pool(k_pages, layer), _layer_pool(v_pages, layer)
    out_chunk = out_group = None
    if q_chunk is not None:
        out_chunk = _prefix_chunk_ref(
            q_chunk, kp, vp, chunk_row, int(chunk_start), int(chunk_total),
            page_size, k_cur=k_chunk, v_cur=v_chunk,
            logit_softcap=logit_softcap, window=window,
        )
    if q_group is not None:
        if tree_pos is not None:
            out_group = paged_attention_verify_ref(
                q_group, kp, vp, page_table, group_lengths, page_size, k_group, v_group,
                logit_softcap=logit_softcap, window=window, tree_pos=tree_pos,
                tree_mask=tree_mask,
            )
        elif q_group.shape[1] == 1:
            out_group = paged_attention_decode_ref(
                q_group[:, 0], kp, vp, page_table, group_lengths, page_size,
                k_cur=k_group[:, 0], v_cur=v_group[:, 0],
                logit_softcap=logit_softcap, window=window,
            )[:, None]
        else:
            out_group = paged_attention_verify_ref(
                q_group, kp, vp, page_table, group_lengths, page_size,
                k_group, v_group, logit_softcap=logit_softcap, window=window,
            )
    return out_chunk, out_group


def prefill_kernel(t: int, d: int, itemsize: int) -> str:
    """The prefill kernel for a bucket of `t` tokens at head dim `d`: the
    JAX package's routing (`_prefill_kernel` there), so both packages pick
    the same kernel for the same shapes. Its resident kernel pins one kv
    head's K and V, 2 * T * dp * itemsize bytes with dp the head dim padded
    to the TPU's 128-lane tile; past the cap the streamed kernel runs (in
    bf16 past T = 16384, in float32 past T = 8192, for D = 64 and 128)."""
    kv_bytes = 2 * t * _lane_pad_dim(d) * itemsize
    return "flash_prefill" if kv_bytes <= _FLASH_KV_VMEM_CAP else "flash_prefill_streamed"


def attention_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seq_lens: torch.Tensor,
    logit_softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Causal GQA prefill attention (contract of attention_prefill_ref).
    CUDA tensors run the `flash_prefill` kernel, or for a bucket past the
    cap (`prefill_kernel`) the `flash_prefill_streamed` kernel."""
    from gridllm_torch.ops import cuda_kernels

    record_kernel_path("attention_prefill", q.is_cuda, q.shape)
    kernel = getattr(cuda_kernels, prefill_kernel(q.shape[1], q.shape[3], q.element_size()))
    return kernel(q, k, v, seq_lens, softcap=logit_softcap, window=window)


def ragged_paged_attention(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_size: int,
    q_chunk: torch.Tensor | None = None,
    chunk_row: torch.Tensor | None = None,
    chunk_start: int | None = None,
    chunk_total: int | None = None,
    k_chunk: torch.Tensor | None = None,
    v_chunk: torch.Tensor | None = None,
    q_group: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,
    group_lengths: torch.Tensor | None = None,
    k_group: torch.Tensor | None = None,
    v_group: torch.Tensor | None = None,
    layer: int | None = None,
    logit_softcap: float = 0.0,
    window: int = 0,
    tree_pos=None,
    tree_mask=None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Unified ragged paged attention: one prefill CHUNK region plus S
    per-slot GROUPS in a single launch.

    - chunk: q_chunk [1, C, H, D] — one slot's prefill chunk at absolute
      positions chunk_start + i, prefix pages via chunk_row [max_pages],
      fresh K/V k_chunk/v_chunk [C, KVH, D] merged causally;
      chunk_total = chunk_start + valid rows.
    - group: q_group [S, Td, H, D] — Td query tokens per slot (1 = decode)
      at positions group_lengths[s] + i against page_table[s]; the pool
      holds the prefix only (group_lengths counts it), the fresh K/V
      k_group/v_group [S, Td, KVH, D] are merged causally.

    - tree verify: `tree_pos` ([Td] node depths) and `tree_mask` ([Td, Td]
      ancestor-or-self), host arrays of a topology shared by all slots,
      make the group's tokens a token tree (contract of
      paged_attention_verify_ref's tree branch). The mask is packed into
      one int32 bitmask per node for the kernel's tree leg; a tree of more
      than 32 nodes runs the plain version, as in the JAX package.

    Pools are one layer [P, ps, KVH, D] or the full stack with `layer`
    selecting, in the compute dtype or int8 (`QuantPages`, whose values
    and per-row scales go to the kernel's int8 leg). Returns (chunk_out,
    group_out), each shaped like its q (None when the region is absent).
    CUDA tensors run the `ragged_attention` kernel.
    """
    from gridllm_torch.ops.cuda_kernels import MAX_TREE_NODES, ragged_attention

    q_any = q_chunk if q_chunk is not None else q_group
    shapes = (None if q_chunk is None else q_chunk.shape,
              None if q_group is None else q_group.shape, tree_pos is not None)
    tree = {}
    if tree_pos is not None and q_group is not None:
        if q_group.shape[1] > MAX_TREE_NODES:
            record_kernel_path("attention_ragged", False, shapes)
            return ragged_paged_attention_ref(
                k_pages, v_pages, page_size, q_chunk=q_chunk, chunk_row=chunk_row,
                chunk_start=chunk_start, chunk_total=chunk_total, k_chunk=k_chunk,
                v_chunk=v_chunk, q_group=q_group, page_table=page_table,
                group_lengths=group_lengths, k_group=k_group, v_group=v_group,
                layer=layer, logit_softcap=logit_softcap, window=window,
                tree_pos=tree_pos, tree_mask=tree_mask)
        tree = dict(tree_pos=np.asarray(tree_pos, np.int32),
                    tree_bits=tree_bits_of(tree_mask))
    record_kernel_path("attention_ragged", q_any.is_cuda, shapes)
    scales = {}
    if isinstance(k_pages, QuantPages):
        scales = dict(k_scale=k_pages.scale, v_scale=v_pages.scale)
        k_pages, v_pages = k_pages.data, v_pages.data
    return ragged_attention(
        k_pages, v_pages, page_size,
        q_chunk=q_chunk, chunk_row=chunk_row, chunk_start=chunk_start,
        chunk_total=chunk_total, k_chunk=k_chunk, v_chunk=v_chunk,
        q_group=q_group, page_table=page_table, group_lengths=group_lengths,
        k_group=k_group, v_group=v_group, layer=layer,
        softcap=logit_softcap, window=window, **scales, **tree,
    )


def tree_bits_of(tree_mask) -> np.ndarray:
    """[N, N] ancestor mask → N int32 bitmasks, bit j of entry i set iff
    node j is on node i's root path (bit 31 is the sign, as the JAX
    package packs it)."""
    tm = np.asarray(tree_mask, bool)
    bits = (tm.astype(np.uint32) << np.arange(tm.shape[1], dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32)
    return bits.view(np.int32)


def _lane_pad_qkv(q: torch.Tensor, k_cur: torch.Tensor | None,
                  v_cur: torch.Tensor | None, dpool: int):
    """Pad q and the fresh K/V to a pool whose head dim `dpool` is wider
    than q's (a lane-padded pool). q is pre-scaled by sqrt(dpool / d) so
    the kernels' 1/sqrt(dpool) equals 1/sqrt(d); callers slice the output
    back to d. Exact: padded K lanes meet zero q lanes, padded V lanes give
    zeros that are sliced away."""
    pad = (0, dpool - q.shape[-1])
    scale = torch.tensor(math.sqrt(dpool / q.shape[-1]), dtype=torch.float32)
    q = torch.nn.functional.pad(q * scale.to(q.dtype), pad)
    if k_cur is not None:
        k_cur = torch.nn.functional.pad(k_cur, pad)
        v_cur = torch.nn.functional.pad(v_cur, pad)
    return q, k_cur, v_cur


def paged_attention_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    page_size: int,
    k_cur: torch.Tensor | None = None,
    v_cur: torch.Tensor | None = None,
    layer: int | None = None,
    logit_softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Paged decode attention (contract of paged_attention_decode_ref):
    q [S, H, D], one query per slot. With k_cur/v_cur [S, KVH, D],
    `lengths` counts the cached prefix only and the current token's K/V
    are merged inside the kernel (the model writes all layers' K/V once
    after the layer loop, so the pool lags one token). Pools are one
    layer [P, ps, KVH, D] or the full stack with `layer` selecting. A pool
    whose head dim is wider than q's is lane-padded at this boundary and
    the output sliced back. CUDA tensors run the `paged_decode` kernel; an
    int8 pool runs the plain version (no kernel reads one)."""
    from gridllm_torch.ops.cuda_kernels import paged_decode

    quant = isinstance(k_pages, QuantPages)
    record_kernel_path("attention_decode", not quant and q.is_cuda, q.shape)
    if quant:
        return paged_attention_decode_ref(
            q, _layer_pool(k_pages, layer), _layer_pool(v_pages, layer), page_table,
            lengths, page_size, k_cur=k_cur, v_cur=v_cur, logit_softcap=logit_softcap,
            window=window)
    d, dpool = q.shape[-1], k_pages.shape[-1]
    if dpool != d:
        q, k_cur, v_cur = _lane_pad_qkv(q, k_cur, v_cur, dpool)
    out = paged_decode(q, k_pages, v_pages, page_table, lengths, page_size,
                       k_cur=k_cur, v_cur=v_cur, layer=layer,
                       softcap=logit_softcap, window=window)
    return out[..., :d] if dpool != d else out


def attention_prefix_chunk(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    table_row: torch.Tensor,
    start,
    total_len,
    page_size: int,
    k_cur: torch.Tensor | None = None,
    v_cur: torch.Tensor | None = None,
    layer: int | None = None,
    logit_softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Chunked-prefill attention (contract of _prefix_chunk_ref): one chunk
    q [1, C, H, D] at positions start + i against the slot's paged prefix
    through table_row [maxp], plus the chunk's fresh K/V k_cur/v_cur
    [C, KVH, D] when the pool writes are deferred; keys at >= total_len
    masked. `start`/`total_len` are host ints or one-element int32 tensors
    on the pool's device (`total_len` None = start + C), so a caller can
    pass device-side lengths without a host sync. Any C; lane-padded pools
    as in paged_attention_decode. CUDA tensors run the `prefix_chunk`
    kernel; an int8 pool runs the plain version (no kernel reads one)."""
    from gridllm_torch.ops.cuda_kernels import prefix_chunk

    quant = isinstance(k_pages, QuantPages)
    record_kernel_path("attention_prefix_chunk", not quant and q.is_cuda, q.shape)
    if quant:
        st = int(start)
        total = st + q.shape[1] if total_len is None else int(total_len)
        return _prefix_chunk_ref(
            q, _layer_pool(k_pages, layer), _layer_pool(v_pages, layer), table_row, st,
            total, page_size, k_cur=k_cur, v_cur=v_cur, logit_softcap=logit_softcap,
            window=window)
    d, dpool = q.shape[-1], k_pages.shape[-1]
    if dpool != d:
        q, k_cur, v_cur = _lane_pad_qkv(q, k_cur, v_cur, dpool)
    out = prefix_chunk(q, k_pages, v_pages, table_row, start, total_len, page_size,
                       k_cur=k_cur, v_cur=v_cur, layer=layer,
                       softcap=logit_softcap, window=window)
    return out[..., :d] if dpool != d else out


def paged_attention_verify(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    page_size: int,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    layer: int | None = None,
    logit_softcap: float = 0.0,
    window: int = 0,
    tree_pos=None,
    tree_mask=None,
) -> torch.Tensor:
    """Speculative-verify attention (contract of paged_attention_verify_ref):
    q [S, T, H, D], candidate i of slot s at position lengths[s] + i,
    attending the slot's prefix plus the candidates before it. CUDA tensors
    run the `prefix_chunk` kernel once for all slots
    (`cuda_kernels.prefix_chunk_slots`, reading each slot's length from the
    lengths tensor on the card: no host sync), where the JAX package loops
    prefix_chunk over slots; lane-padded pools as in paged_attention_decode.
    An int8 pool runs the plain version, all slots at once.

    A token tree (`tree_pos`/`tree_mask`) always runs the plain version's
    tree branch: no per-phase kernel carries an ancestor mask, in this
    package or the JAX package (the unified ragged kernel's tree leg
    does)."""
    from gridllm_torch.ops.cuda_kernels import prefix_chunk_slots

    plain = tree_pos is not None or isinstance(k_pages, QuantPages)
    record_kernel_path("attention_verify", not plain and q.is_cuda, q.shape)
    if plain:
        return paged_attention_verify_ref(
            q, _layer_pool(k_pages, layer), _layer_pool(v_pages, layer), page_table,
            lengths, page_size, k_cur, v_cur, logit_softcap=logit_softcap, window=window,
            tree_pos=tree_pos, tree_mask=tree_mask)
    d, dpool = q.shape[-1], k_pages.shape[-1]
    if dpool != d:
        q, k_cur, v_cur = _lane_pad_qkv(q, k_cur, v_cur, dpool)
    out = prefix_chunk_slots(q, k_pages, v_pages, page_table, lengths, page_size, k_cur, v_cur,
                             layer=layer, softcap=logit_softcap, window=window)
    return out[..., :d] if dpool != d else out
