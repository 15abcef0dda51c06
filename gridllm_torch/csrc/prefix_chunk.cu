// prefix_chunk: one chunk of C queries against the slot's paged prefix
// plus the chunk's own K/V, causal on absolute positions.
//
// Replaces gridllm_tpu/ops/pallas_kernels.py:739 `prefix_chunk` (body
// `_prefix_chunk_kernel`, :567), the chunked-prefill attention of the
// per-phase dispatchers (ragged attention off) and, one launch per slot,
// their speculative-verify attention. The function, the plain version's
// (ops.attention._prefix_chunk_ref): query i sits at position start + i;
// with k_cur/v_cur it attends pool keys [0, start) through table_row, then
// the chunk's fresh rows at positions start + r (cut at the table's
// capacity); without them the chunk is already in the pool and the walk
// covers [0, total). Keys at positions >= total, later than the query or
// (with a window) at distance >= window are masked; a tanh softcap applies
// before the mask.
//
// `start` and `total` are read from device memory, as the TPU kernel reads
// them from scalar prefetch: the verify loop passes each slot's length
// straight from the cache (total = start + C when no total is given), so a
// launch never needs a host copy of a device scalar.
//
// What bounds it on the H100: at C = 1024 the work is about 4*C*(start +
// C/2)*H*D flops for (C*H*D*2 + (start + C)*KVH*D*2) * itemsize bytes, so
// it is compute bound like flash_prefill; at the verify width C = K+1 = 5
// it reads the slot's whole context for a handful of queries and is bound
// by bytes. This version runs float32 CUDA-core math through shared-memory
// tiles (attention_common.cuh); tensor-core tiles and split-K are later
// work.
//
// Design: grid (ceil(C / BQ), KVH). A block stacks the G query heads of
// one kv head over BQ consecutive tokens (BQ*G <= 32 rows), walks the
// prefix pages above its window floor, then the chunk rows up to its own
// causal bound. Page ids are clamped into the pool and every walk stops at
// the table's capacity, so an unmapped (-1) entry never reads outside it.
#include "attention_common.cuh"

namespace gridllm {

struct ChunkArgs {
  const void* q;       // [C, H, D]
  const void* k_pool;  // [L, P, ps, KVH, D]
  const void* v_pool;
  const void* k_cur;   // [C, KVH, D] or null
  const void* v_cur;
  void* out;           // [C, H, D]
  const int* table_row;  // [n_table]
  const int* start_ptr;  // device scalar
  const int* total_ptr;  // device scalar, or null: total = start + C
  int n_table, num_pages, ps, layer;
  int C, bq, H, KVH;
  float scale, softcap;
  int window;
};

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads) prefix_chunk_kernel(ChunkArgs a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, h = blockIdx.y;
  const int G = a.H / a.KVH;
  const int tok0 = tile * a.bq;
  const int ntok = min(a.bq, a.C - tok0);
  const int rows_total = ntok * G;
  const int start = *a.start_ptr;
  const int total = a.total_ptr != nullptr ? *a.total_ptr : start + a.C;
  const int cap = a.n_table * a.ps;
  const bool has_cur = a.k_cur != nullptr;
  const int64_t row_stride = static_cast<int64_t>(a.KVH) * D;
  const int64_t tok_stride = static_cast<int64_t>(a.H) * D;
  const int64_t qoff = static_cast<int64_t>(tok0) * tok_stride + static_cast<int64_t>(h) * G * D;
  const int64_t layer_base = static_cast<int64_t>(a.layer) * a.num_pages * a.ps;
  const T* k_pool = static_cast<const T*>(a.k_pool) + static_cast<int64_t>(h) * D;
  const T* v_pool = static_cast<const T*>(a.v_pool) + static_cast<int64_t>(h) * D;
  const PagedRows pages{a.table_row, a.n_table, layer_base, a.ps, a.num_pages, row_stride};
  // pool keys: the prefix [0, start) with fresh rows, else [0, total);
  // never past the tile's last query (causal) or the table's capacity
  const int pool_end = min(min(max(has_cur ? start : total, 0), cap), max(start + tok0 + ntok, 0));
  // fresh rows the tile can see: causal bound, cut at the capacity edge
  const int k_hi = max(min(tok0 + ntok, cap - start), 0);
  constexpr int NR = AttnBlock<T, D, RPW>::NR;
  AttnBlock<T, D, RPW> blk(smem, a.softcap, a.window);
  for (int row0 = 0; row0 < rows_total; row0 += NR) {
    const int qfirst = start + tok0 + row0 / G;
    const int p_lo = a.window > 0 ? max(qfirst - a.window + 1, 0) : 0;
    blk.load_q(static_cast<const T*>(a.q) + qoff, tok_stride, G, row0, rows_total,
               start + tok0, a.scale);
    blk.segment(k_pool, v_pool, pages, min(p_lo, pool_end), pool_end, 0, total);
    if (has_cur) {
      const int c_lo = a.window > 0 ? max(qfirst - a.window + 1 - start, 0) : 0;
      const T* kc = static_cast<const T*>(a.k_cur) + static_cast<int64_t>(h) * D;
      const T* vc = static_cast<const T*>(a.v_cur) + static_cast<int64_t>(h) * D;
      blk.segment(kc, vc, ContigRows{row_stride}, min(c_lo, k_hi), k_hi, start, total);
    }
    blk.store(static_cast<T*>(a.out) + qoff, tok_stride, G, row0, rows_total);
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const ChunkArgs& a, cudaStream_t stream) {
  auto kernel = prefix_chunk_kernel<T, D, RPW>;
  const int smem = smem_floats<D, RPW>() * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.C + a.bq - 1) / a.bq, a.KVH), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rpw(int rpw, const ChunkArgs& a, cudaStream_t st) {
  switch (rpw) {
    case 1: return launch<T, D, 1>(a, st);
    case 2: return launch<T, D, 2>(a, st);
    case 4: return launch<T, D, 4>(a, st);
    case 8: return launch<T, D, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int d, int rpw, const ChunkArgs& a, cudaStream_t st) {
  switch (d) {
    case 64: return by_rpw<T, 64>(rpw, a, st);
    case 128: return by_rpw<T, 128>(rpw, a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace gridllm

// dtype: 0 = float32, 1 = bfloat16. k_cur/v_cur null: the chunk is already
// in the pool. total_ptr null: total = start + C. Returns
// cudaGetLastError().
extern "C" int gridllm_prefix_chunk(const void* q, const void* k_pool, const void* v_pool,
                                    const void* k_cur, const void* v_cur, void* out,
                                    const void* table_row, const void* start_ptr,
                                    const void* total_ptr, int n_table, int num_pages, int ps,
                                    int layer, int C, int bq, int H, int KVH, int D, int rpw,
                                    int dtype, float scale, float softcap, int window,
                                    void* stream) {
  gridllm::ChunkArgs a{q, k_pool, v_pool, k_cur, v_cur, out,
                       static_cast<const int*>(table_row), static_cast<const int*>(start_ptr),
                       static_cast<const int*>(total_ptr), n_table, num_pages, ps, layer,
                       C, bq, H, KVH, scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = gridllm::by_dim<float>(D, rpw, a, st);
  else if (dtype == 1) err = gridllm::by_dim<__nv_bfloat16>(D, rpw, a, st);
  return static_cast<int>(err);
}
