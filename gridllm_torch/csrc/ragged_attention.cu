// ragged_attention: unified paged attention for one ragged token batch —
// one prefill CHUNK region plus S per-slot GROUPS.
//
// Replaces gridllm_tpu/ops/pallas_kernels.py:1168 `ragged_attention`
// (body `_ragged_attn_kernel`, :821; chunk tile :1006, group tile :1076)
// with both of its legs: the int8 dequant leg (k_scale/v_scale) and the
// tree-verify leg (tree_pos/tree_bits), which combine freely. The function:
// - chunk region: the C queries of one slot at positions chunk_start + i
//   attend the slot's cached prefix [0, chunk_start) through chunk_row,
//   then the chunk's own fresh K/V causally, keys at positions
//   >= min(chunk_total, table capacity) masked;
// - group region: slot s's Td queries at positions group_lengths[s] + i
//   attend its pages [0, group_lengths[s]) through page_table[s] (the pool
//   lags one step: group_lengths counts the prefix only), then its Td fresh
//   K/V causally, a fresh row at or past the table's capacity cut. Td = 1
//   is decode, Td = K+1 speculative verify, Td = 64 a draft model's
//   catch-up chunk: any Td (the block walks its rows NR at a time).
// Both regions take a sliding window and a tanh softcap.
// int8 leg (k_scale/v_scale given): the pool holds int8 values and one
// float32 scale per (layer, page, row). The groups (and a float32 chunk)
// multiply each pool row by its scale right after the load
// (QuantPagedRows), then the math is the fp leg's; a bf16 chunk converts
// each int8 pool tile exactly to bf16 in shared memory and applies the
// scales in float32 to S's and P's columns (chunk::chunk_body, kQuant).
// The fresh chunk/group K/V stay in the compute dtype, unscaled.
// tree leg (tree_n = Td <= 32 nodes): the group's Td tokens are the nodes
// of a draft token tree in topological order, shared by all slots. Node i
// is STORED at length + i (its fresh K/V column i) but sits at LOGICAL
// position length + tree_pos[i]: its query attends the pool at that
// position, and fresh column j iff bit j of tree_bits[i] (node j is an
// ancestor of node i, or i itself); the window is measured on logical
// distance. The topology travels by value in the launch's arguments (the
// counterpart of the TPU kernel's scalar prefetch) and is staged in shared
// memory once per block.
//
// The bodies of both kernels live in attention_bodies.cuh (shared with
// per_phase_attention.cu's paged_decode and prefix_chunk); this file holds
// their entry points for the ragged launch:
// - `ragged_chunk_kernel`: the chunk region for bf16 q on a bf16 or an
//   int8 pool (wgmma + TMA, `chunk::chunk_body`; the int8 pool's tiles
//   converted in shared memory), a launch of its own;
// - `ragged_attention_kernel`: every group, split over pages, and the
//   chunk region for float32 q (CUDA cores, `ragged_body`; an explicit
//   route by input type, counted apart by the wrapper).
#include "attention_bodies.cuh"

namespace gridllm {

template <typename T, typename P, int D, int RPW>
__global__ void __launch_bounds__(kThreads) ragged_attention_kernel(RaggedArgs a) {
  ragged_body<T, P, D, RPW>(a);
}

template <int D, bool kCap, bool kDev, bool kFresh, bool kQuant>
__global__ void __launch_bounds__(hopper::kWgThreads, 1)
    ragged_chunk_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap kp_map,
                        const __grid_constant__ CUtensorMap vp_map,
                        const __grid_constant__ CUtensorMap kc_map,
                        const __grid_constant__ CUtensorMap vc_map, const chunk::ChunkArgs a) {
  chunk::chunk_body<D, kCap, kDev, kFresh, kQuant>(q_map, kp_map, vp_map, kc_map, vc_map, a);
}

struct RaggedEntry {
  template <typename T, typename P, int D, int RPW>
  static auto kernel() { return ragged_attention_kernel<T, P, D, RPW>; }
  template <int D, bool kCap, bool kDev, bool kFresh, bool kQuant>
  static auto chunk_kernel() { return ragged_chunk_kernel<D, kCap, kDev, kFresh, kQuant>; }
};

// the fp pool (P = T) or, with scales, the int8 pool
template <typename T>
cudaError_t by_pool(int d, int rpw, const RaggedArgs& a, cudaStream_t s) {
  if (a.k_scale != nullptr) return by_dim<RaggedEntry, T, int8_t>(d, rpw, a, s);
  return by_dim<RaggedEntry, T, T>(d, rpw, a, s);
}

}  // namespace gridllm

// dtype: the compute dtype, 0 = float32, 1 = bfloat16. k_scale/v_scale:
// null for a pool of the compute dtype, else the float32 [L, P, ps] scales
// of an int8 pool. A region is absent when its query pointer is null
// (n_chunk_tiles = 0 or S = 0). n_splits: spans per (slot, kv head); with
// n_splits > 1, part_ml [S, KVH, n_splits, Td * G, 2] and part_acc
// [S, KVH, n_splits, Td * G, D] float32 scratch and counters [S * KVH]
// int32, zero on the first launch (each launch leaves them zero). tree_n:
// 0 for a causal group, else Td (<= 32) tree nodes whose depths and
// ancestor bitmasks are HOST arrays tree_pos/tree_bits of tree_n ints,
// copied into the launch's arguments. Returns cudaGetLastError().
extern "C" int gridllm_ragged_attention(
    const void* k_pool, const void* v_pool, const void* k_scale, const void* v_scale,
    int num_pages, int ps, int layer,
    const void* q_chunk, const void* k_chunk, const void* v_chunk, void* o_chunk,
    const void* chunk_row, int n_table_c, int C, int bq, int chunk_start, int chunk_total,
    int n_chunk_tiles, const void* q_group, const void* k_group, const void* v_group,
    void* o_group, const void* page_table, const void* group_lengths, int n_table_g,
    int S, int Td, int n_splits, void* part_ml, void* part_acc, void* counters,
    int H, int KVH, int D, int rpw, int dtype, float scale, float softcap,
    int window, int tree_n, const int* tree_pos, const int* tree_bits, void* stream) {
  if (tree_n < 0 || tree_n > gridllm::kMaxTreeNodes || (tree_n > 0 && tree_n != Td) ||
      n_splits < 1 || (n_splits > 1 && (part_ml == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  gridllm::RaggedArgs a{k_pool, v_pool, static_cast<const float*>(k_scale),
                        static_cast<const float*>(v_scale), num_pages, ps, layer,
                        q_chunk, k_chunk, v_chunk, o_chunk,
                        static_cast<const int*>(chunk_row),
                        {nullptr, nullptr, chunk_start, chunk_total},
                        n_table_c, C, bq, n_chunk_tiles,
                        q_group, k_group, v_group, o_group,
                        static_cast<const int*>(page_table),
                        static_cast<const int*>(group_lengths), n_table_g, S, Td,
                        n_splits, static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                        static_cast<int*>(counters),
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

// The TMA map of one pool [L, P, ps, KVH, D] viewed as {D, KVH, ps, L * P},
// written as the 128 bytes of a CUtensorMap into map_out (host memory; the
// caller keeps it per pool tensor): a bf16 pool (int8 = 0) in boxes
// {64, 1, box_rows, 1}, 128-byte swizzled; an int8 pool (int8 = 1) in
// whole rows, boxes {D, 1, box_rows, 1}, unswizzled. Returns 0, -1 (no
// encoder in the driver) or -2 (the driver refused the map).
extern "C" int gridllm_ragged_pool_map(const void* pool, long long pool_pages, int ps, int KVH,
                                       int D, int box_rows, int int8, void* map_out) {
  const int64_t row = static_cast<int64_t>(D) * (int8 ? 1 : 2);
  CUtensorMap map;
  const int err =
      int8 ? gridllm::hopper::encode_int8_4d(&map, pool, D, KVH, ps, pool_pages, row, row * KVH,
                                             row * KVH * ps, 1, box_rows)
           : gridllm::hopper::encode_bf16_4d(&map, pool, D, KVH, ps, pool_pages, row, row * KVH,
                                             row * KVH * ps, 1, box_rows);
  if (err == 0) memcpy(map_out, &map, sizeof(CUtensorMap));
  return err;
}

// The chunk region alone on the tensor cores: bf16 q_chunk [1, C, H, D],
// k_chunk/v_chunk [C, KVH, D] and out, the pool maps of
// gridllm_ragged_pool_map (host buffers, copied into the launch), bq =
// 128 / (H / KVH); k_scale/v_scale: null for a bf16 pool, else the
// float32 [L, P, ps] scales of an int8 pool (whose maps were encoded with
// int8 = 1). Returns cudaGetLastError() of the launch, -1, -2 or -3 (the
// block's shared memory with the staged table row past the card's limit).
extern "C" int gridllm_ragged_chunk(const void* kp_map, const void* vp_map, const void* q_chunk,
                                    const void* k_chunk, const void* v_chunk, void* out,
                                    const void* chunk_row, const void* k_scale,
                                    const void* v_scale, int n_table, int num_pages,
                                    int pool_pages, int ps, int box_rows, int layer, int C,
                                    int bq, int chunk_start, int chunk_total, int H, int KVH,
                                    int D, float scale, float softcap, int window, void* stream) {
  const gridllm::chunk::ChunkArgs a{static_cast<const int*>(chunk_row),
                                    static_cast<__nv_bfloat16*>(out),
                                    n_table, num_pages, pool_pages, ps, box_rows, layer, C, bq,
                                    H, KVH, {nullptr, nullptr, chunk_start, chunk_total},
                                    std::min(chunk_total, n_table * ps), scale, softcap, window,
                                    static_cast<const float*>(k_scale),
                                    static_cast<const float*>(v_scale)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using gridllm::RaggedEntry;
  return k_scale != nullptr
             ? gridllm::chunk::run<RaggedEntry, false, true, true>(kp_map, vp_map, q_chunk,
                                                                   k_chunk, v_chunk, a, D, s)
             : gridllm::chunk::run<RaggedEntry, false, true, false>(kp_map, vp_map, q_chunk,
                                                                    k_chunk, v_chunk, a, D, s);
}
