// The per-phase attention kernels (the dispatchers' route with ragged
// attention off): paged_decode, and prefix_chunk both as one chunk and as
// the batched speculative verify over all slots.
//
// Replaces gridllm_tpu/ops/pallas_kernels.py:479 `paged_decode` (body
// `_paged_decode_kernel`, :330) and :739 `prefix_chunk` (body
// `_prefix_chunk_kernel`, :567). The functions, the plain versions'
// (ops.attention.paged_attention_decode_ref, _prefix_chunk_ref and
// paged_attention_verify_ref):
// - paged_decode: one query per slot against its page walk. With
//   k_cur/v_cur, lengths[s] counts the cached prefix only: the query sits
//   at lengths[s] and attends [0, lengths[s]) plus its own K/V (dropped at
//   the capacity edge, where the slot is finished). Without them the
//   current token is already in the pool: the query sits at lengths[s] - 1
//   and attends [0, lengths[s]);
// - prefix_chunk: q [1, C, H, D] at positions start + i against the slot's
//   pool through table_row, with the chunk's fresh K/V when given (else the
//   chunk is already in the pool and the walk covers [0, total)), keys at
//   positions >= total masked. start and total are read from device memory
//   (the TPU kernel's scalar prefetch): the model's chunk passes both as
//   device scalars, so a launch never needs a host copy of one;
// - prefix_chunk over slots (the per-phase speculative verify, which the
//   JAX package loops over slots): q [S, T, H, D], candidate i of slot s at
//   lengths[s] + i attending the slot's prefix plus the candidates before
//   it, one launch for all slots.
// All take a sliding window (measured from the query's position) and a
// tanh softcap applied before the mask.
//
// What bounds them on the H100, and the design: decode and verify are bound
// by device-memory bytes (each slot's cached K/V read once per layer for
// ~2 flops per byte); they launch the group body of attention_bodies.cuh
// (`ragged_body`, the same code as ragged_attention's decode groups):
// paged_decode at Td = 1, the verify at Td = T, each slot's pages split
// over spans of whole pages with the partials merged by the last block in
// the launch. paged_decode's two modes are the body's two policies (with
// or without fresh rows). A chunk of C = 1,024 is bound by operations: a
// bf16 chunk on a bf16 pool whose pages hold whole 8-row TMA boxes runs
// the wgmma + TMA chunk body (`chunk::chunk_body`, ragged_attention's chunk
// kernel); any other chunk the CUDA-core chunk region of `ragged_body`.
//
// Entry points, each a __global__ symbol of its own so a profiler trace
// names it: `paged_decode_kernel`, `prefix_chunk_kernel` (the CUDA-core
// chunk and the verify over slots) and `prefix_chunk_wgmma_kernel`.
#include "attention_bodies.cuh"

namespace gridllm {

template <typename T, typename P, int D, int RPW>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(RaggedArgs a) {
  ragged_body<T, P, D, RPW>(a);
}

template <typename T, typename P, int D, int RPW>
__global__ void __launch_bounds__(kThreads) prefix_chunk_kernel(RaggedArgs a) {
  ragged_body<T, P, D, RPW>(a);
}

template <int D, bool kCap, bool kDev, bool kFresh>
__global__ void __launch_bounds__(hopper::kWgThreads, 1)
    prefix_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap kp_map,
                              const __grid_constant__ CUtensorMap vp_map,
                              const __grid_constant__ CUtensorMap kc_map,
                              const __grid_constant__ CUtensorMap vc_map,
                              const chunk::ChunkArgs a) {
  chunk::chunk_body<D, kCap, kDev, kFresh, false>(q_map, kp_map, vp_map, kc_map, vc_map, a);
}

struct DecodeEntry {
  template <typename T, typename P, int D, int RPW>
  static auto kernel() { return paged_decode_kernel<T, P, D, RPW>; }
};

struct PrefixChunkEntry {
  template <typename T, typename P, int D, int RPW>
  static auto kernel() { return prefix_chunk_kernel<T, P, D, RPW>; }
  template <int D, bool kCap, bool kDev, bool kFresh, bool kQuant>
  static auto chunk_kernel() {
    static_assert(!kQuant, "prefix_chunk reads an int8 pool through its plain version");
    return prefix_chunk_wgmma_kernel<D, kCap, kDev, kFresh>;
  }
};

template <class Entry>
cudaError_t by_dtype(int dtype, int d, int rpw, const RaggedArgs& a, cudaStream_t s) {
  if (dtype == 0) return by_dim<Entry, float, float>(d, rpw, a, s);
  if (dtype == 1) return by_dim<Entry, __nv_bfloat16, __nv_bfloat16>(d, rpw, a, s);
  return cudaErrorInvalidValue;
}

// The group launch of both group entry points: q [S, Td, H, D], fresh K/V
// [S, Td, KVH, D] or null, out like q.
template <class Entry>
int groups(const void* q, const void* k_pool, const void* v_pool, const void* k_new,
           const void* v_new, void* out, const void* page_table, const void* lengths, int S,
           int Td, int n_table, int num_pages, int ps, int layer, int n_splits, void* part_ml,
           void* part_acc, void* counters, int H, int KVH, int D, int rpw, int dtype,
           float scale, float softcap, int window, void* stream) {
  if (n_splits < 1 || (n_splits > 1 && (part_ml == nullptr || counters == nullptr)) ||
      (k_new == nullptr) != (v_new == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const RaggedArgs a{k_pool, v_pool, nullptr, nullptr, num_pages, ps, layer,
                     nullptr, nullptr, nullptr, nullptr, nullptr, {nullptr, nullptr, 0, 0},
                     0, 0, 1, 0,
                     q, k_new, v_new, out, static_cast<const int*>(page_table),
                     static_cast<const int*>(lengths), n_table, S, Td,
                     n_splits, static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                     static_cast<int*>(counters), H, KVH, scale, softcap, window, 0, {}, {}};
  return static_cast<int>(by_dtype<Entry>(dtype, D, rpw, a, static_cast<cudaStream_t>(stream)));
}

}  // namespace gridllm

// The group entry points: q [S, Td, H, D], k_cur/v_cur [S, Td, KVH, D],
// page_table [S, n_table], lengths [S] int32 on the device. dtype: 0 =
// float32, 1 = bfloat16. n_splits, part_ml, part_acc, counters: the
// split-K scratch of gridllm_ragged_attention's group region (zero
// counters, left zero). Returns cudaGetLastError().
// paged_decode: Td = 1; k_cur/v_cur null: the current token already in the
// pool (the query at lengths[s] - 1).
extern "C" int gridllm_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                    const void* k_cur, const void* v_cur, void* out,
                                    const void* page_table, const void* lengths, int S, int Td,
                                    int n_table, int num_pages, int ps, int layer, int n_splits,
                                    void* part_ml, void* part_acc, void* counters, int H,
                                    int KVH, int D, int rpw, int dtype, float scale,
                                    float softcap, int window, void* stream) {
  if (Td != 1) return static_cast<int>(cudaErrorInvalidValue);
  return gridllm::groups<gridllm::DecodeEntry>(
      q, k_pool, v_pool, k_cur, v_cur, out, page_table, lengths, S, Td, n_table, num_pages, ps,
      layer, n_splits, part_ml, part_acc, counters, H, KVH, D, rpw, dtype, scale, softcap,
      window, stream);
}

// prefix_chunk over slots (the per-phase verify): Td = T candidates per
// slot, candidate i of slot s at lengths[s] + i; k_cur/v_cur required.
extern "C" int gridllm_prefix_chunk_slots(const void* q, const void* k_pool, const void* v_pool,
                                          const void* k_cur, const void* v_cur, void* out,
                                          const void* page_table, const void* lengths, int S,
                                          int T, int n_table, int num_pages, int ps, int layer,
                                          int n_splits, void* part_ml, void* part_acc,
                                          void* counters, int H, int KVH, int D, int rpw,
                                          int dtype, float scale, float softcap, int window,
                                          void* stream) {
  if (k_cur == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return gridllm::groups<gridllm::PrefixChunkEntry>(
      q, k_pool, v_pool, k_cur, v_cur, out, page_table, lengths, S, T, n_table, num_pages, ps,
      layer, n_splits, part_ml, part_acc, counters, H, KVH, D, rpw, dtype, scale, softcap,
      window, stream);
}

// prefix_chunk on the CUDA cores: q [1, C, H, D], k_cur/v_cur [C, KVH, D]
// or null (the chunk already in the pool), out like q, table_row
// [n_table]; bq query tokens per block. start_ptr: a device int32 scalar;
// total_ptr: one, or null for start + C.
extern "C" int gridllm_prefix_chunk(const void* q, const void* k_pool, const void* v_pool,
                                    const void* k_cur, const void* v_cur, void* out,
                                    const void* table_row, const void* start_ptr,
                                    const void* total_ptr, int n_table, int num_pages, int ps,
                                    int layer, int C, int bq, int H, int KVH, int D, int rpw,
                                    int dtype, float scale, float softcap, int window,
                                    void* stream) {
  if ((k_cur == nullptr) != (v_cur == nullptr) || bq < 1 || start_ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const gridllm::RaggedArgs a{
      k_pool, v_pool, nullptr, nullptr, num_pages, ps, layer,
      q, k_cur, v_cur, out, static_cast<const int*>(table_row),
      {static_cast<const int*>(start_ptr), static_cast<const int*>(total_ptr), 0, -1},
      n_table, C, bq, (C + bq - 1) / bq,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0,
      1, nullptr, nullptr, nullptr, H, KVH, scale, softcap, window, 0, {}, {}};
  return static_cast<int>(gridllm::by_dtype<gridllm::PrefixChunkEntry>(
      dtype, D, rpw, a, static_cast<cudaStream_t>(stream)));
}

// prefix_chunk on the tensor cores: bf16 q [1, C, H, D], k_cur/v_cur
// [C, KVH, D] or null, out like q, the pool maps of gridllm_ragged_pool_map
// (host buffers, copied into the launch), bq = 128 / (H / KVH). start_ptr:
// a device int32 scalar; total_ptr: one, or null for start + C. Returns
// cudaGetLastError() of the launch, -1, -2 or -3 (shared memory past the
// card's limit).
extern "C" int gridllm_prefix_chunk_wgmma(const void* kp_map, const void* vp_map, const void* q,
                                          const void* k_cur, const void* v_cur, void* out,
                                          const void* table_row, const void* start_ptr,
                                          const void* total_ptr, int n_table, int num_pages,
                                          int pool_pages, int ps, int box_rows, int layer, int C,
                                          int bq, int H, int KVH, int D, float scale,
                                          float softcap, int window, void* stream) {
  if (start_ptr == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const gridllm::chunk::ChunkArgs a{
      static_cast<const int*>(table_row), static_cast<__nv_bfloat16*>(out),
      n_table, num_pages, pool_pages, ps, box_rows, layer, C, bq, H, KVH,
      {static_cast<const int*>(start_ptr), static_cast<const int*>(total_ptr), 0, -1}, 0,
      scale, softcap, window, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using gridllm::PrefixChunkEntry;
  return k_cur != nullptr
             ? gridllm::chunk::run<PrefixChunkEntry, true, true, false>(kp_map, vp_map, q, k_cur,
                                                                        v_cur, a, D, s)
             : gridllm::chunk::run<PrefixChunkEntry, true, false, false>(kp_map, vp_map, q, k_cur,
                                                                         v_cur, a, D, s);
}
