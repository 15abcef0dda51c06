// paged_decode: one query token per slot against that slot's page walk,
// with the current token's K/V merged as one extra online-softmax step.
//
// Replaces gridllm_tpu/ops/pallas_kernels.py:479 `paged_decode` (body
// `_paged_decode_kernel`, :330), the decode attention of the per-phase
// dispatchers (ragged attention off). The function, the plain version's
// (ops.attention.paged_attention_decode_ref):
// - with k_cur/v_cur: lengths[s] counts the cached prefix only; the query
//   sits at position lengths[s] and attends pool keys [0, lengths[s]) plus
//   its own K/V at position lengths[s] (dropped at the capacity edge, where
//   the slot is already finished);
// - without them: the current token is already in the pool and the query
//   sits at position lengths[s] - 1;
// - an optional sliding window (keys at distance >= window masked) and a
//   tanh softcap applied before the mask.
//
// What bounds it on the H100: device-memory bytes. Each slot's cached K/V
// is read once per layer for about two flops per byte (G = 4 query heads
// share every K/V row), far below the card's ~295 flops/byte ridge. This
// version streams 64-key tiles through shared memory with float32
// CUDA-core math (attention_common.cuh), one block per (slot, kv head), so
// a step's latency is that of one block walking its whole context; split-K
// over pages is later work.
//
// Design: grid (S, KVH). The G query heads of one kv head are the block's
// rows, so each K/V row read serves all of them. Segments: the page walk
// over [max(0, qpos - window + 1), min(length, capacity)), then the k_cur
// row at position lengths[s]. The block reads lengths[s] and the page ids
// itself from device memory (no host scalar per launch). Page ids are
// clamped into the pool and the walk stops at the table's capacity, so an
// empty slot (length 0) or an unmapped (-1) entry never reads outside it.
#include "attention_common.cuh"

namespace gridllm {

struct DecodeArgs {
  const void* q;       // [S, H, D]
  const void* k_pool;  // [L, P, ps, KVH, D]
  const void* v_pool;
  const void* k_cur;   // [S, KVH, D] or null
  const void* v_cur;
  void* out;           // [S, H, D]
  const int* page_table;  // [S, n_table]
  const int* lengths;     // [S]
  int n_table, num_pages, ps, layer;
  int H, KVH;
  float scale, softcap;
  int window;
};

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, h = blockIdx.y;
  const int G = a.H / a.KVH;
  const int64_t row_stride = static_cast<int64_t>(a.KVH) * D;
  const int64_t head_q = static_cast<int64_t>(s) * a.H * D + static_cast<int64_t>(h) * G * D;
  const int64_t layer_base = static_cast<int64_t>(a.layer) * a.num_pages * a.ps;
  const T* k_pool = static_cast<const T*>(a.k_pool) + static_cast<int64_t>(h) * D;
  const T* v_pool = static_cast<const T*>(a.v_pool) + static_cast<int64_t>(h) * D;
  const bool merge_cur = a.k_cur != nullptr;
  const int cap = a.n_table * a.ps;
  const int length = max(a.lengths[s], 0);
  const int qpos = merge_cur ? length : length - 1;
  const int ctx = min(length, cap);
  const int p_lo = a.window > 0 ? min(max(qpos - a.window + 1, 0), ctx) : 0;
  const PagedRows pages{a.page_table + static_cast<int64_t>(s) * a.n_table, a.n_table,
                        layer_base, a.ps, a.num_pages, row_stride};
  constexpr int NR = AttnBlock<T, D, RPW>::NR;
  AttnBlock<T, D, RPW> blk(smem, a.softcap, a.window);
  for (int row0 = 0; row0 < G; row0 += NR) {
    blk.load_q(static_cast<const T*>(a.q) + head_q, 0, G, row0, G, qpos, a.scale);
    blk.segment(k_pool, v_pool, pages, p_lo, ctx, 0, ctx);
    if (merge_cur && length < cap) {
      const int64_t cur = static_cast<int64_t>(s) * row_stride + static_cast<int64_t>(h) * D;
      blk.segment(static_cast<const T*>(a.k_cur) + cur, static_cast<const T*>(a.v_cur) + cur,
                  ContigRows{row_stride}, 0, 1, length, length + 1);
    }
    blk.store(static_cast<T*>(a.out) + head_q, 0, G, row0, G);
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const DecodeArgs& a, int S, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, D, RPW>;
  const int smem = smem_floats<D, RPW>() * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, a.KVH), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rpw(int rpw, const DecodeArgs& a, int S, cudaStream_t st) {
  switch (rpw) {
    case 1: return launch<T, D, 1>(a, S, st);
    case 2: return launch<T, D, 2>(a, S, st);
    case 4: return launch<T, D, 4>(a, S, st);
    case 8: return launch<T, D, 8>(a, S, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int d, int rpw, const DecodeArgs& a, int S, cudaStream_t st) {
  switch (d) {
    case 64: return by_rpw<T, 64>(rpw, a, S, st);
    case 128: return by_rpw<T, 128>(rpw, a, S, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace gridllm

// dtype: 0 = float32, 1 = bfloat16. k_cur/v_cur null: the current token is
// already in the pool. Returns cudaGetLastError().
extern "C" int gridllm_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                    const void* k_cur, const void* v_cur, void* out,
                                    const void* page_table, const void* lengths, int S,
                                    int n_table, int num_pages, int ps, int layer, int H,
                                    int KVH, int D, int rpw, int dtype, float scale,
                                    float softcap, int window, void* stream) {
  gridllm::DecodeArgs a{q, k_pool, v_pool, k_cur, v_cur, out,
                        static_cast<const int*>(page_table), static_cast<const int*>(lengths),
                        n_table, num_pages, ps, layer, H, KVH, scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = gridllm::by_dim<float>(D, rpw, a, S, st);
  else if (dtype == 1) err = gridllm::by_dim<__nv_bfloat16>(D, rpw, a, S, st);
  return static_cast<int>(err);
}
