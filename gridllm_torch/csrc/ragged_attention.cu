// ragged_attention: unified paged attention for one ragged token batch —
// one prefill CHUNK region plus S per-slot GROUPS — in a single launch.
//
// Replaces gridllm_tpu/ops/pallas_kernels.py:1168 `ragged_attention`
// (body `_ragged_attn_kernel`, :821) with both of its legs: the int8
// dequant leg (k_scale/v_scale) and the tree-verify leg
// (tree_pos/tree_bits), which combine freely. The function:
// - chunk region: the C queries of one slot at positions chunk_start + i
//   attend the slot's cached prefix [0, chunk_start) through chunk_row,
//   then the chunk's own fresh K/V causally, keys at positions
//   >= chunk_total masked;
// - group region: slot s's Td queries at positions group_lengths[s] + i
//   attend its pages [0, group_lengths[s]) through page_table[s] (the pool
//   lags one step: group_lengths counts the prefix only), then its Td fresh
//   K/V causally. Td = 1 is decode, Td = K+1 speculative verify, Td = 64 a
//   draft model's catch-up chunk: any Td (the block walks its rows NR at a
//   time).
// Both regions take a sliding window and a tanh softcap.
// int8 leg (k_scale/v_scale given): the pool holds int8 values and one
// float32 scale per (layer, page, row); each pool row is multiplied by its
// scale right after the load (QuantPagedRows), then the math is the fp
// leg's. The fresh chunk/group K/V stay in the compute dtype, unscaled.
// It reads half the pool bytes of a bf16 pool plus 4 bytes per row.
// tree leg (tree_n = Td <= 32 nodes): the group's Td tokens are the nodes
// of a draft token tree in topological order, shared by all slots. Node i
// is STORED at length + i (its fresh K/V column i) but sits at LOGICAL
// position length + tree_pos[i]: its query attends the pool at that
// position, and fresh column j iff bit j of tree_bits[i] (node j is an
// ancestor of node i, or i itself); the window is measured on logical
// distance. The topology travels by value in the launch's arguments (the
// counterpart of the TPU kernel's scalar prefetch: no device buffer, no
// copy per launch) and is staged in shared memory once per block.
//
// What bounds it on the H100: decode groups read every cached K/V byte of
// every slot once per layer for ~2 flops per byte, so they are bound by
// device-memory bytes; the chunk region at C=1024 is compute bound like
// flash_prefill. This version streams tiles synchronously through shared
// memory with float32 CUDA-core math (attention_common.cuh), so decode
// latency is dominated by load latency with one block per (slot, kv head);
// split-K over pages and tensor-core chunk tiles are later work.
//
// Design: grid ((C / BQ chunk tiles + S group tiles), KVH), the TPU
// kernel's static tile grid with the sequential grid axis turned into
// parallel blocks. A block walks its slot's page-table row itself (the
// pool row of one kv head is D values strided by KVH*D), so no page is
// gathered into a dense copy. Safety: page numbers are clamped into the
// pool and the walk stops at min(length, table capacity), so an empty slot
// (length 0) or an unmapped (-1) entry never reads outside the pool.
#include "attention_common.cuh"

namespace gridllm {

constexpr int kMaxTreeNodes = 32;  // one int32 ancestor bitmask per node

struct RaggedArgs {
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // int8 pools: [L, P, ps] per-row scales; else null
  const float* v_scale;
  int num_pages, ps, layer;
  // chunk region
  const void* q_chunk;
  const void* k_chunk;
  const void* v_chunk;
  void* o_chunk;
  const int* chunk_row;
  int n_table_c, C, bq, chunk_start, chunk_total, n_chunk_tiles;
  // group region
  const void* q_group;
  const void* k_group;
  const void* v_group;
  void* o_group;
  const int* page_table;
  const int* group_lengths;
  int n_table_g, S, Td;
  int H, KVH;
  float scale, softcap;
  int window;
  // tree leg: tree_n = Td nodes (0 = a causal chain group)
  int tree_n;
  int tree_pos[kMaxTreeNodes];   // node depths
  int tree_bits[kMaxTreeNodes];  // bit j of entry i: node j is on node i's root path
};

// The pool's row reader: rows of the compute dtype, or int8 rows scaled.
template <typename T>
__device__ __forceinline__ KVRows<T, PagedRows> pool_rows(const T* k, const T* v, const float*,
                                                          const float*, PagedRows pages) {
  return {k, v, pages};
}
__device__ __forceinline__ QuantPagedRows pool_rows(const int8_t* k, const int8_t* v,
                                                    const float* ks, const float* vs,
                                                    PagedRows pages) {
  return {k, v, ks, vs, pages};
}

// T: the compute dtype (q, fresh K/V, output); P: the pool's element type,
// T itself or int8_t.
template <typename T, typename P, int D, int RPW>
__global__ void __launch_bounds__(kThreads) ragged_attention_kernel(RaggedArgs a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, h = blockIdx.y;
  const int G = a.H / a.KVH;
  const int64_t row_stride = static_cast<int64_t>(a.KVH) * D;
  const int64_t tok_stride = static_cast<int64_t>(a.H) * D;
  const int64_t head_q = static_cast<int64_t>(h) * G * D;
  const P* k_pool = static_cast<const P*>(a.k_pool) + static_cast<int64_t>(h) * D;
  const P* v_pool = static_cast<const P*>(a.v_pool) + static_cast<int64_t>(h) * D;
  const int64_t layer_base = static_cast<int64_t>(a.layer) * a.num_pages * a.ps;
  constexpr int NR = AttnBlock<T, D, RPW>::NR;
  AttnBlock<T, D, RPW> blk(smem, a.softcap, a.window);

  if (tile < a.n_chunk_tiles) {
    const int tok0 = tile * a.bq;
    const int ntok = min(a.bq, a.C - tok0);
    const int rows_total = ntok * G;
    const int64_t qoff = static_cast<int64_t>(tok0) * tok_stride + head_q;
    const PagedRows pages{a.chunk_row, a.n_table_c, layer_base, a.ps, a.num_pages, row_stride};
    const int ctx = min(max(a.chunk_start, 0), a.n_table_c * a.ps);
    const int k_hi = min(tok0 + ntok, a.C);  // causal bound inside the chunk
    const T* kc = static_cast<const T*>(a.k_chunk) + static_cast<int64_t>(h) * D;
    const T* vc = static_cast<const T*>(a.v_chunk) + static_cast<int64_t>(h) * D;
    for (int row0 = 0; row0 < rows_total; row0 += NR) {
      const int qfirst = a.chunk_start + tok0 + row0 / G;
      const int p_lo = a.window > 0 ? max(qfirst - a.window + 1, 0) : 0;
      const int c_lo = a.window > 0 ? max(qfirst - a.window + 1 - a.chunk_start, 0) : 0;
      blk.load_q(static_cast<const T*>(a.q_chunk) + qoff, tok_stride, G, row0, rows_total,
                 a.chunk_start + tok0, a.scale);
      blk.segment(pool_rows(k_pool, v_pool, a.k_scale, a.v_scale, pages), min(p_lo, ctx), ctx,
                  0, ctx);
      blk.segment(kc, vc, ContigRows{row_stride}, min(c_lo, k_hi), k_hi, a.chunk_start,
                  a.chunk_total);
      blk.store(static_cast<T*>(a.o_chunk) + qoff, tok_stride, G, row0, rows_total);
    }
    return;
  }

  const int s = tile - a.n_chunk_tiles;
  const int length = max(a.group_lengths[s], 0);
  const int rows_total = a.Td * G;
  const int64_t qoff = static_cast<int64_t>(s) * a.Td * tok_stride + head_q;
  const PagedRows pages{a.page_table + static_cast<int64_t>(s) * a.n_table_g, a.n_table_g,
                        layer_base, a.ps, a.num_pages, row_stride};
  const int ctx = min(length, a.n_table_g * a.ps);
  const int64_t kvoff = static_cast<int64_t>(s) * a.Td * row_stride;
  const T* kg = static_cast<const T*>(a.k_group) + kvoff + static_cast<int64_t>(h) * D;
  const T* vg = static_cast<const T*>(a.v_group) + kvoff + static_cast<int64_t>(h) * D;
  const bool tree = a.tree_n > 0;
  __shared__ int tree_depth[kMaxTreeNodes];
  __shared__ unsigned tree_bits[kMaxTreeNodes];
  if (tree && threadIdx.x == 0) {  // published by load_q's barrier
#pragma unroll
    for (int i = 0; i < kMaxTreeNodes; ++i) {  // constant indices into the arguments
      if (i < a.tree_n) {
        tree_depth[i] = a.tree_pos[i];
        tree_bits[i] = static_cast<unsigned>(a.tree_bits[i]);
      }
    }
  }
  for (int row0 = 0; row0 < rows_total; row0 += NR) {
    // a tree row's logical position is length + depth >= length
    const int qfirst = length + (tree ? 0 : row0 / G);
    const int p_lo = a.window > 0 ? max(qfirst - a.window + 1, 0) : 0;
    blk.load_q(static_cast<const T*>(a.q_group) + qoff, tok_stride, G, row0, rows_total,
               length, a.scale);
    if (tree) blk.tree_qpos(tree_depth, G, row0, rows_total, length);
    blk.segment(pool_rows(k_pool, v_pool, a.k_scale, a.v_scale, pages), min(p_lo, ctx), ctx, 0,
                ctx);
    if (tree) {
      TreeKeys<RPW> keys{tree_depth, length, {}};
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int gi = row0 + blk.warp * RPW + r;
        keys.bits[r] = gi < rows_total ? tree_bits[gi / G] : 0u;
      }
      blk.segment(KVRows<T, ContigRows>{kg, vg, ContigRows{row_stride}}, 0, a.Td, keys);
    } else {
      blk.segment(kg, vg, ContigRows{row_stride}, 0, a.Td, length, length + a.Td);
    }
    blk.store(static_cast<T*>(a.o_group) + qoff, tok_stride, G, row0, rows_total);
  }
}

template <typename T, typename P, int D, int RPW>
cudaError_t launch(const RaggedArgs& a, cudaStream_t stream) {
  auto kernel = ragged_attention_kernel<T, P, D, RPW>;
  const int smem = smem_floats<D, RPW>() * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_chunk_tiles + a.S, a.KVH);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t by_rpw(int rpw, const RaggedArgs& a, cudaStream_t s) {
  switch (rpw) {
    case 1: return launch<T, P, D, 1>(a, s);
    case 2: return launch<T, P, D, 2>(a, s);
    case 4: return launch<T, P, D, 4>(a, s);
    case 8: return launch<T, P, D, 8>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename P>
cudaError_t by_dim(int d, int rpw, const RaggedArgs& a, cudaStream_t s) {
  switch (d) {
    case 64: return by_rpw<T, P, 64>(rpw, a, s);
    case 128: return by_rpw<T, P, 128>(rpw, a, s);
  }
  return cudaErrorInvalidValue;
}

// the fp pool (P = T) or, with scales, the int8 pool
template <typename T>
cudaError_t by_pool(int d, int rpw, const RaggedArgs& a, cudaStream_t s) {
  if (a.k_scale != nullptr) return by_dim<T, int8_t>(d, rpw, a, s);
  return by_dim<T, T>(d, rpw, a, s);
}

}  // namespace gridllm

// dtype: the compute dtype, 0 = float32, 1 = bfloat16. k_scale/v_scale:
// null for a pool of the compute dtype, else the float32 [L, P, ps] scales
// of an int8 pool. A region is absent when its query pointer is null
// (n_chunk_tiles = 0 or S = 0). tree_n: 0 for a causal group, else Td
// (<= 32) tree nodes whose depths and ancestor bitmasks are HOST arrays
// tree_pos/tree_bits of tree_n ints, copied into the launch's arguments.
// Returns cudaGetLastError().
extern "C" int gridllm_ragged_attention(
    const void* k_pool, const void* v_pool, const void* k_scale, const void* v_scale,
    int num_pages, int ps, int layer,
    const void* q_chunk, const void* k_chunk, const void* v_chunk, void* o_chunk,
    const void* chunk_row, int n_table_c, int C, int bq, int chunk_start, int chunk_total,
    int n_chunk_tiles, const void* q_group, const void* k_group, const void* v_group,
    void* o_group, const void* page_table, const void* group_lengths, int n_table_g,
    int S, int Td, int H, int KVH, int D, int rpw, int dtype, float scale, float softcap,
    int window, int tree_n, const int* tree_pos, const int* tree_bits, void* stream) {
  if (tree_n < 0 || tree_n > gridllm::kMaxTreeNodes || (tree_n > 0 && tree_n != Td))
    return static_cast<int>(cudaErrorInvalidValue);
  gridllm::RaggedArgs a{k_pool, v_pool, static_cast<const float*>(k_scale),
                        static_cast<const float*>(v_scale), num_pages, ps, layer,
                        q_chunk, k_chunk, v_chunk, o_chunk,
                        static_cast<const int*>(chunk_row), n_table_c, C, bq,
                        chunk_start, chunk_total, n_chunk_tiles,
                        q_group, k_group, v_group, o_group,
                        static_cast<const int*>(page_table),
                        static_cast<const int*>(group_lengths), n_table_g, S, Td,
                        H, KVH, scale, softcap, window, tree_n, {}, {}};
  for (int i = 0; i < tree_n; ++i) {
    a.tree_pos[i] = tree_pos[i];
    a.tree_bits[i] = tree_bits[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = gridllm::by_pool<float>(D, rpw, a, s);
  else if (dtype == 1) err = gridllm::by_pool<__nv_bfloat16>(D, rpw, a, s);
  return static_cast<int>(err);
}
