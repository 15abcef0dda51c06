// The bodies of the paged attention kernels, one copy each, behind the
// __global__ entry points of ragged_attention.cu (the unified ragged
// launch) and per_phase_attention.cu (paged_decode and prefix_chunk, the
// per-phase dispatchers'): each entry point is a thin kernel of its own
// symbol around one body, so a profiler trace attributes device time to
// the entry point that launched it.
//
// What bounds them on the H100: decode and verify groups read every cached
// K/V byte of every slot once per layer for ~2 flops per byte, so they are
// bound by device-memory bytes; a chunk of C = 1024 queries is bound by
// operations like flash_prefill. Two bodies, each shaped for one of those
// bounds:
//
// `ragged_body` (CUDA cores, float32 math through attention_common.cuh's
// AttnBlock): the GROUP region, and the CHUNK region for float32 q or a
// page size that does not hold whole 8-row boxes.
// - Group region: slot s's Td queries attend its pages [0, ctx), ctx =
//   min(lengths[s], table capacity), then its Td fresh K/V causally. Two
//   policies, by whether fresh K/V are given: with them the queries sit at
//   lengths[s] + i (the pool lags: lengths counts the prefix only) and
//   fresh row i is cut when lengths[s] + i reaches the capacity (the slot
//   is finished there); without them (paged_decode with the current token
//   already in the pool) the query sits at lengths[s] - 1 and attends
//   [0, ctx) alone. A tree group (tree_n = Td) gives node i the logical
//   position lengths[s] + tree_pos[i] and shows it fresh column j iff bit j
//   of tree_bits[i] is set.
//   Groups are split over pages (split-K): one block per (slot, kv head,
//   span), the slot's cached pages cut into n_splits spans of equal
//   whole-page counts, read from the slot's length on the device (n_splits
//   itself comes from host shapes only). Span 0, which exists whatever the
//   length, also attends the fresh K/V. With n_splits > 1 each block
//   writes its rows' partial softmax state (m, l, acc; float32) to
//   scratch, and the last block to arrive for a (slot, kv head), counted by
//   an atomic, merges the spans and writes the output in the same launch,
//   then resets the counter for the next launch. A span past the slot's
//   length writes an empty partial (l = 0). The split plan is
//   `ragged_split_count` / `ragged_split_plan`, and the merge
//   `ragged_split_merge_ref`, in ops/cuda_kernels.py.
// - Chunk region: the C queries of one slot at positions start + i attend
//   its cached prefix [0, min(start, capacity)) through its table row, then
//   the chunk's fresh K/V causally; without fresh K/V (the chunk already in
//   the pool) the pool rows [0, min(total, capacity)) causally. Keys at
//   positions >= min(total, capacity) are masked.
//
// `chunk_body` (the chunk region on the tensor cores: bf16 q on a bf16 or
// an int8 pool, D 64, 128 or 256) is flash_prefill's Hopper kernel
// (hopper_common.cuh) walking two key segments: one producer warpgroup
// whose single thread issues TMA loads, two consumer warpgroups of 64 query
// rows each, S = Q K^T and O += P V on wgmma, float32 online softmax. The
// query tile stacks the G query heads of one kv head over bq = 128 / G
// chunk tokens (spare rows zeroed when G does not divide 128). It walks the
// slot's cached prefix in tiles of kBK keys (128; 64 at D = 256) aligned to
// absolute positions, each tile kBK / box_rows TMA boxes of box_rows =
// gcd(ps, kBK) pool rows from a
// map over the pool viewed as {D, KVH, ps, L * P}, at page coordinate
// layer * P + chunk_row[p] (the block stages its table row in shared memory,
// clamped into the pool as PagedRows clamps it; a box past the prefix is
// loaded from outside the map, which TMA fills with zeros); then the
// chunk's own K/V from a second map, in kBK-key tiles aligned to the
// chunk, at absolute positions start + j. The per-element mask runs only
// on tiles that need it (the prefix edge, the fresh segment's diagonal,
// the total or capacity edge, the window edge); tiles wholly outside the
// window are never loaded; a query tile wholly past total writes zeros
// (padding rows). Its plan is `ragged_chunk_tile_plan` in
// ops/cuda_kernels.py, tested on the CPU. On an int8 pool the same boxes
// land as int8 rows in a staging stage (QuantSmem); the producer
// warpgroup's 128 threads convert them exactly to bf16 in the stage's
// swizzled layout and stage the rows' scales, and the consumers apply the
// scales in float32 (to S after Q K^T, to P before P V): the wgmma path
// itself is unchanged.
//
// ragged_attention's chunk takes start and total by value; the per-phase
// prefix_chunk (the counterpart of the TPU kernel's scalar prefetch) reads
// them from device memory on either body (`ChunkBounds`): the grid comes
// from host shapes (C, KVH), and each block derives its walk from the two
// scalars.
//
// Safety: page numbers are clamped into the pool and walks stop at
// min(length, table capacity), so an empty slot (length 0) or an unmapped
// (-1) entry never reads outside the pool.
#pragma once

#include "attention_common.cuh"
#include "hopper_common.cuh"

#include <algorithm>
#include <cstring>

namespace gridllm {

constexpr int kMaxTreeNodes = 32;  // one int32 ancestor bitmask per node

// A chunk's start and total: device scalars where the pointers are set
// (read by every block), else the values; total < 0 with no total_ptr
// means start + C.
struct ChunkBounds {
  const int* start_ptr;
  const int* total_ptr;
  int start, total;
  __device__ __forceinline__ void read(int C, int& cs, int& ct) const {
    cs = start_ptr != nullptr ? *start_ptr : start;
    ct = total_ptr != nullptr ? *total_ptr : (total >= 0 ? total : cs + C);
  }
  bool on_device() const { return start_ptr != nullptr || total_ptr != nullptr; }
};

struct RaggedArgs {
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // int8 pools: [L, P, ps] per-row scales; else null
  const float* v_scale;
  int num_pages, ps, layer;
  // chunk region (CUDA-core route); k_chunk null: no fresh rows
  const void* q_chunk;
  const void* k_chunk;
  const void* v_chunk;
  void* o_chunk;
  const int* chunk_row;
  ChunkBounds bounds;
  int n_table_c, C, bq, n_chunk_tiles;
  // group region; k_group null: no fresh rows (the query at length - 1)
  const void* q_group;
  const void* k_group;
  const void* v_group;
  void* o_group;
  const int* page_table;
  const int* group_lengths;
  int n_table_g, S, Td;
  // split-K: n_splits spans per (slot, kv head); with n_splits > 1 the
  // partials [S, KVH, n_splits, Td * G] of (m, l) and of acc [.., D], and
  // one arrival counter per (slot, kv head), all zero between launches
  int n_splits;
  float* part_ml;
  float* part_acc;
  int* counters;
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

// The warp's rows of one pass as partials: (m, l) and acc per row.
template <typename Blk, int D, int RPW>
__device__ __forceinline__ void store_partial(const Blk& blk, float* ml, float* acc, int row0,
                                              int rows_total) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int gi = row0 + blk.warp * RPW + r;
    if (gi >= rows_total) continue;
    if (blk.lane == 0) {
      ml[2 * gi] = blk.m[r];
      ml[2 * gi + 1] = blk.l[r];
    }
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[static_cast<int64_t>(gi) * D + blk.lane + 32 * c] = blk.acc[r][c];
  }
}

// The last block of a (slot, kv head) merges its n spans: per row,
// M = max m_i over spans with l_i > 0, out = sum e^(m_i - M) acc_i /
// max(sum e^(m_i - M) l_i, 1e-30). One warp per row; lane u holds the
// weights of spans u, u + 32, ..., so the span reads of a row are issued
// together. Partials of other blocks are read past L1 (__ldcg).
template <typename T, int D>
__device__ void merge_spans(const float* ml, const float* acc, int n, int rows_total,
                            T* obase, int64_t tok_stride, int G) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float2* st = reinterpret_cast<const float2*>(ml);
  for (int gi = warp; gi < rows_total; gi += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < n; i += 32) {
      const float2 p = __ldcg(st + static_cast<int64_t>(i) * rows_total + gi);
      if (p.y > 0.f) mx = fmaxf(mx, p.x);
    }
    mx = warp_max(mx);
    float l = 0.f, o[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) o[c] = 0.f;
    for (int i0 = 0; i0 < n; i0 += 32) {
      float w = 0.f;
      if (i0 + lane < n) {
        const float2 p = __ldcg(st + static_cast<int64_t>(i0 + lane) * rows_total + gi);
        w = p.y > 0.f ? expf(p.x - mx) : 0.f;
        l += w * p.y;
      }
      const int cnt = min(32, n - i0);
#pragma unroll 4
      for (int u = 0; u < cnt; ++u) {
        const float wu = __shfl_sync(kFull, w, u);
        if (wu != 0.f) {  // the same for the whole warp
          const float* a = acc + (static_cast<int64_t>(i0 + u) * rows_total + gi) * D;
#pragma unroll
          for (int c = 0; c < D / 32; ++c) o[c] += wu * __ldcg(a + lane + 32 * c);
        }
      }
    }
    const float inv = 1.f / fmaxf(warp_sum(l), 1e-30f);
    T* out = obase + static_cast<int64_t>(gi / G) * tok_stride + (gi % G) * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) out[lane + 32 * c] = from_f<T>(o[c] * inv);
  }
}

// The CUDA-core body: block (tile, kv head) of grid (n_chunk_tiles +
// S * n_splits, KVH). T: the compute dtype (q, fresh K/V, output); P: the
// pool's element type, T itself or int8_t.
template <typename T, typename P, int D, int RPW>
__device__ __forceinline__ void ragged_body(const RaggedArgs& a) {
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
    int cs, ct;
    a.bounds.read(a.C, cs, ct);
    const int tok0 = tile * a.bq;
    const int ntok = min(a.bq, a.C - tok0);
    const int rows_total = ntok * G;
    const int64_t qoff = static_cast<int64_t>(tok0) * tok_stride + head_q;
    const PagedRows pages{a.chunk_row, a.n_table_c, layer_base, a.ps, a.num_pages, row_stride};
    const int cap = a.n_table_c * a.ps;
    const bool fresh = a.k_chunk != nullptr;
    // pool keys: the prefix, or without fresh rows the chunk too; never
    // past the capacity, nor past the tile's last query
    const int ctx = min(max(fresh ? cs : ct, 0), cap);
    const int p_hi = min(ctx, cs + tok0 + ntok);
    // fresh keys at positions >= f_limit are masked (cut at the capacity)
    const int f_limit = min(ct, cap);
    const int k_hi = min(tok0 + ntok, max(f_limit - cs, 0));  // causal bound inside the chunk
    const T* kc = static_cast<const T*>(a.k_chunk) + static_cast<int64_t>(h) * D;
    const T* vc = static_cast<const T*>(a.v_chunk) + static_cast<int64_t>(h) * D;
    for (int row0 = 0; row0 < rows_total; row0 += NR) {
      const int qfirst = cs + tok0 + row0 / G;
      const int p_lo = a.window > 0 ? max(qfirst - a.window + 1, 0) : 0;
      const int c_lo = a.window > 0 ? max(qfirst - a.window + 1 - cs, 0) : 0;
      blk.load_q(static_cast<const T*>(a.q_chunk) + qoff, tok_stride, G, row0, rows_total,
                 cs + tok0, a.scale);
      blk.segment(pool_rows(k_pool, v_pool, a.k_scale, a.v_scale, pages), min(p_lo, p_hi), p_hi,
                  0, ctx);
      if (fresh) blk.segment(kc, vc, ContigRows{row_stride}, min(c_lo, k_hi), k_hi, cs, f_limit);
      blk.store(static_cast<T*>(a.o_chunk) + qoff, tok_stride, G, row0, rows_total);
    }
    return;
  }

  const int gidx = tile - a.n_chunk_tiles;
  const int s = gidx / a.n_splits, span = gidx % a.n_splits;
  const int length = max(a.group_lengths[s], 0);
  const int rows_total = a.Td * G;
  const int64_t qoff = static_cast<int64_t>(s) * a.Td * tok_stride + head_q;
  const PagedRows pages{a.page_table + static_cast<int64_t>(s) * a.n_table_g, a.n_table_g,
                        layer_base, a.ps, a.num_pages, row_stride};
  const int cap = a.n_table_g * a.ps;
  const int ctx = min(length, cap);
  const bool fresh = a.k_group != nullptr;
  // the first query's position: after the prefix, or without fresh rows
  // the last pool row; fresh rows at or past the capacity are cut
  const int qpos0 = fresh ? length : length - 1;
  const int n_fresh = fresh ? max(min(a.Td, cap - length), 0) : 0;
  // this span's pool rows [p0, p1): the slot's pages in n_splits spans of
  // span_pages whole pages each
  const int span_pages = ((ctx + a.ps - 1) / a.ps + a.n_splits - 1) / a.n_splits;
  const int p0 = min(span * span_pages * a.ps, ctx);
  const int p1 = min(p0 + span_pages * a.ps, ctx);
  const bool split = a.n_splits > 1;
  const int64_t part_row0 =
      (static_cast<int64_t>(s * a.KVH + h) * a.n_splits + span) * rows_total;
  float* part_ml = split ? a.part_ml + 2 * part_row0 : nullptr;
  float* part_acc = split ? a.part_acc + part_row0 * D : nullptr;

  if (span > 0 && p0 >= p1) {  // past the slot's length: an empty partial
    for (int gi = threadIdx.x; gi < rows_total; gi += kThreads) {
      part_ml[2 * gi] = kNegInf;
      part_ml[2 * gi + 1] = 0.f;
    }
  } else {
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
      const int qfirst = qpos0 + (tree ? 0 : row0 / G);
      const int p_lo = a.window > 0 ? max(qfirst - a.window + 1, 0) : 0;
      blk.load_q(static_cast<const T*>(a.q_group) + qoff, tok_stride, G, row0, rows_total,
                 qpos0, a.scale);
      if (tree) blk.tree_qpos(tree_depth, G, row0, rows_total, length);
      blk.segment(pool_rows(k_pool, v_pool, a.k_scale, a.v_scale, pages),
                  max(p0, min(p_lo, p1)), p1, 0, ctx);
      if (span == 0 && n_fresh > 0) {  // the fresh K/V
        if (tree) {
          TreeKeys<RPW> keys{tree_depth, length, {}};
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const int gi = row0 + blk.warp * RPW + r;
            keys.bits[r] = gi < rows_total ? tree_bits[gi / G] : 0u;
          }
          blk.segment(KVRows<T, ContigRows>{kg, vg, ContigRows{row_stride}}, 0, n_fresh, keys);
        } else {
          blk.segment(kg, vg, ContigRows{row_stride}, 0, n_fresh, length, length + n_fresh);
        }
      }
      if (split)
        store_partial<AttnBlock<T, D, RPW>, D, RPW>(blk, part_ml, part_acc, row0, rows_total);
      else
        blk.store(static_cast<T*>(a.o_group) + qoff, tok_stride, G, row0, rows_total);
    }
  }
  if (!split) return;

  // arrive; the last of the n_splits blocks merges (release: every
  // thread's partials fenced before the count; acquire: fence after it)
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = a.counters + s * a.KVH + h;
    is_last = atomicAdd(counter, 1) == a.n_splits - 1;
    if (is_last) *counter = 0;  // every span has arrived: ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int64_t base_row = static_cast<int64_t>(s * a.KVH + h) * a.n_splits * rows_total;
  merge_spans<T, D>(a.part_ml + 2 * base_row, a.part_acc + base_row * D, a.n_splits, rows_total,
                    static_cast<T*>(a.o_group) + qoff, tok_stride, G);
}

// Launch of the CUDA-core body through an entry point: Entry::kernel<T, P,
// D, RPW>() names the __global__ of that entry point.
template <class Entry, typename T, typename P, int D, int RPW>
cudaError_t launch_body(const RaggedArgs& a, cudaStream_t stream) {
  auto kernel = Entry::template kernel<T, P, D, RPW>();
  const int smem = smem_floats<D, RPW>() * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_chunk_tiles + a.S * a.n_splits, a.KVH);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Rows per warp compiled at head dim D: at D = 256 eight rows a warp hold
// 64 accumulator and 64 query floats a lane before the K tile and spill
// (ptxas), so the wrapper takes at most 4 there (cuda_kernels._rows_per_warp)
// and 8 is not compiled.
template <int D>
constexpr int kMaxRpw = D == 256 ? 4 : 8;

template <class Entry, typename T, typename P, int D>
cudaError_t by_rpw(int rpw, const RaggedArgs& a, cudaStream_t s) {
  switch (rpw) {
    case 1: return launch_body<Entry, T, P, D, 1>(a, s);
    case 2: return launch_body<Entry, T, P, D, 2>(a, s);
    case 4: return launch_body<Entry, T, P, D, 4>(a, s);
    case 8:
      if constexpr (kMaxRpw<D> >= 8) return launch_body<Entry, T, P, D, 8>(a, s);
      break;
  }
  return cudaErrorInvalidValue;
}

template <class Entry, typename T, typename P>
cudaError_t by_dim(int d, int rpw, const RaggedArgs& a, cudaStream_t s) {
  switch (d) {
    case 64: return by_rpw<Entry, T, P, 64>(rpw, a, s);
    case 128: return by_rpw<Entry, T, P, 128>(rpw, a, s);
    case 256: return by_rpw<Entry, T, P, 256>(rpw, a, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the chunk region on wgmma + TMA (bf16 q; a bf16 or an int8 pool)
// ---------------------------------------------------------------------------

namespace chunk {

using namespace hopper;

struct ChunkArgs {
  const int* chunk_row;      // [n_table] pages of the slot
  __nv_bfloat16* out;        // [1, C, H, D]
  int n_table, num_pages, pool_pages, ps, box_rows, layer;  // pool_pages = L * P
  int C, bq, H, KVH;
  ChunkBounds bounds;
  int f_limit;               // by-value bounds: min(total, n_table * ps); else unused
  float scale, softcap;
  int window;
  const float* k_scale;      // an int8 pool: the float32 row scales [L, P, ps]; else null
  const float* v_scale;
};

// An int8 pool's room after the barriers (kQuant): kIStages staging
// stages, each a prefix tile's int8 K and V rows as TMA lands them (kBK
// rows of D bytes each), then the float32 scales of each bf16 stage's rows
// (K's kBK, then V's). At D = 128 one staging stage is what fits beside the
// bf16 ring: 198,784 bytes before the table row (a 512-page table takes
// 2,048 more of the card's 232,448); at D = 256 (64-key tiles) 231,552, so
// a table row of up to 224 pages fits (gemma2:9b's default is 128).
template <int D>
struct QuantSmem {
  static constexpr int kBK = Smem<D>::kBK;
  static constexpr int kIStages = D == 64 ? 2 : 1;
  static constexpr int kTile = kBK * D;  // bytes of one int8 K or V tile
  static constexpr int kStageOff = Smem<D>::kBarOff + 128;
  static constexpr int kScaleOff = kStageOff + kIStages * 2 * kTile;
  static constexpr int kEnd = kScaleOff + Smem<D>::kStages * 2 * kBK * 4;
  // the barriers fit their 128 bytes: q, full and empty per stage, one per
  // staging stage
  static_assert(8 * (1 + 2 * Smem<D>::kStages + kIStages) <= 128, "chunk barriers");
};

// Dynamic shared memory: the Smem<D> layout (and an int8 pool's
// QuantSmem<D>), then the table row's pages that hold the pool keys
// (clamped into the pool); all n_table of them when the bounds live on the
// device.
template <int D, bool kQuant>
__host__ __device__ constexpr int table_offset() {
  return kQuant ? QuantSmem<D>::kEnd : Smem<D>::kBarOff + 128;
}
template <int D, bool kFresh, bool kQuant>
int smem_bytes(const ChunkArgs& a) {
  int pages = a.n_table;
  if (!a.bounds.on_device()) {
    const int total = a.bounds.total >= 0 ? a.bounds.total : a.bounds.start + a.C;
    const int ctx = std::min(std::max(kFresh ? a.bounds.start : total, 0), a.n_table * a.ps);
    pages = (ctx + a.ps - 1) / a.ps;
  }
  return (kQuant ? QuantSmem<D>::kEnd + 1024 : Smem<D>::kBytes + 128) + 4 * pages;
}

// Four int8 values (one 32-bit word) as four bf16, exactly, two to an
// instruction: byte b of the word goes into the low byte of a bf16 0x43bb;
// v = 0x4300 | (b & 0x7F) is 128 + (b & 0x7F) and c = 0x4300 | (b & 0x80)
// is 128 or 256, so v - c = (b & 0x7F) - (b & 0x80) = x, an integer in
// [-128, 127] that bf16 holds exactly.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t v, uint32_t c) {
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  const uint32_t lo = __byte_perm(w, 0x43434343u, 0x5140u);  // bytes 0, 1: 0x43b0, 0x43b1
  const uint32_t hi = __byte_perm(w, 0x43434343u, 0x7362u);  // bytes 2, 3
  return make_uint2(bf16x2_sub(lo & 0xFF7FFF7Fu, lo & 0xFF80FF80u),
                    bf16x2_sub(hi & 0xFF7FFF7Fu, hi & 0xFF80FF80u));
}

// One int8 tile (kBK rows of D bytes at src) as bf16 in a stage's
// 128-byte-swizzled 64-column blocks at dst, the layout TMA writes for a
// bf16 pool, by the producer warpgroup's thread t: eight values a row.
// Thread t keeps one 8-value group g8 of rows r0, r0 + 128 / (D / 8), ...;
// where that step is a multiple of 8 rows (D 64 and 128) its swizzled
// chunk (g8 % 8) ^ (row % 8) is the same in every row (at D = 256, a step
// of 4 rows, it alternates). A quarter warp writes the eight 16-byte
// chunks of one row, a half warp reads 128 contiguous bytes. The loads of
// kBatch rows are issued before any of their stores (the compiler may not
// move a load of src above a store to dst, which it cannot tell apart).
template <int D>
__device__ __forceinline__ void convert_tile(const unsigned char* src, unsigned char* dst,
                                             int t) {
  constexpr int kGroups = D / 8;            // 8-value groups per row
  constexpr int kRowStep = 128 / kGroups;   // rows between a thread's rows (16, 8 or 4)
  constexpr int kRows = Smem<D>::kBK / kRowStep, kBatch = 8;
  static_assert(kRows % kBatch == 0 && kBatch * kRowStep % 8 == 0, "convert_tile shape");
  const int g8 = t % kGroups, r0 = t / kGroups;
  const unsigned char* s = src + r0 * D + g8 * 8;
  unsigned char* d = dst + (g8 / 8) * Smem<D>::kKVBlock;
#pragma unroll 1
  for (int k0 = 0; k0 < kRows; k0 += kBatch) {
    uint2 w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      w[j] = *reinterpret_cast<const uint2*>(s + (k0 + j) * kRowStep * D);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const uint2 lo = int8x4_to_bf16x4(w[j].x), hi = int8x4_to_bf16x4(w[j].y);
      // row % 8 = (r0 + j * kRowStep) % 8: k0 * kRowStep is a multiple of 8
      const int row = r0 + (k0 + j) * kRowStep;
      const int sw = (g8 % 8) ^ ((r0 + j * kRowStep) % 8);
      *reinterpret_cast<uint4*>(d + row * 128 + (sw << 4)) = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// S's column of key k times K row k's scale (2 * NS floats in shared
// memory), on the m64nBK accumulator layout of softmax_tile.
template <int NS>
__device__ __forceinline__ void scale_keys(float (&s)[NS], const float* k_scale, int quad) {
  const float2* k2 = reinterpret_cast<const float2*>(k_scale);
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
    const float2 k = k2[4 * n + quad];
    s[4 * n] *= k.x;
    s[4 * n + 1] *= k.y;
    s[4 * n + 2] *= k.x;
    s[4 * n + 3] *= k.y;
  }
}

// kDev: start and total read from device memory (ChunkBounds::read; the
// per-phase prefix_chunk, whose caller holds them as device scalars); else
// by value, total resolved on the host (ragged_attention's chunk): kernel
// parameters, read where used. kFresh: the chunk's fresh K/V follow the
// pool keys; without them the chunk is already in the pool (prefix_chunk
// alone). ragged_attention's instantiations are <kDev = false, kFresh =
// true>. kQuant: an int8 pool (ragged_attention's int8 leg): kp_map/vp_map
// read int8 rows (encode_int8_4d) into a staging stage, the producer
// warpgroup's 128 threads convert each prefix tile exactly into the bf16
// stage and stage its rows' scales beside it, and the consumers multiply
// S's columns by the K scales after Q K^T and P's columns by the V scales
// before P V, in float32, as the TPU kernel dequantizes each row in
// float32 before its dots. Fresh K/V are bf16 and unscaled.
template <int D, bool kCap, bool kDev, bool kFresh, bool kQuant>
__device__ __forceinline__ void chunk_body(const CUtensorMap& q_map, const CUtensorMap& kp_map,
                                           const CUtensorMap& vp_map, const CUtensorMap& kc_map,
                                           const CUtensorMap& vc_map, const ChunkArgs& a) {
  using L = Smem<D>;
  using Q = QuantSmem<D>;
  constexpr int kBK = L::kBK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  int* table = reinterpret_cast<int*>(smem + table_offset<D, kQuant>());
  const uint32_t q_s = base, kv_s = base + L::kQBytes;
  const uint32_t bar_q = base + L::kBarOff;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + L::kStages + s); };
  auto ifull = [&](int s) { return bar_q + 8u * (1 + 2 * L::kStages + s); };  // staging
  // an int8 pool's scales of bf16 stage s's rows: K's, then V's
  auto stage_scales = [&](int s) {
    return reinterpret_cast<float*>(smem + Q::kScaleOff) + s * 2 * kBK;
  };

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int G = a.H / a.KVH;
  const int tok0 = qt * a.bq;
  const int ntok = min(a.bq, a.C - tok0);
  const int rows = ntok * G;
  int cs = a.bounds.start, ct = a.bounds.total;
  if constexpr (kDev) a.bounds.read(a.C, cs, ct);
  const int64_t tok_stride = static_cast<int64_t>(a.H) * D;
  __nv_bfloat16* ob = a.out + static_cast<int64_t>(tok0) * tok_stride +
                      static_cast<int64_t>(h) * G * D;
  const int q_first = cs + tok0, q_last = cs + tok0 + ntok - 1;  // absolute positions
  if (q_first >= ct) {  // padding rows only
    write_zeros<__nv_bfloat16, D>(ob, rows, G, tok_stride, kWgThreads);
    return;
  }
  // the tile plan (ragged_chunk_tile_plan): pool keys [p_lo, p_hi) in
  // kBK-key tiles aligned to absolute positions (the prefix, or without
  // fresh K/V the chunk's own rows too), then fresh keys [c_lo, c_hi) of
  // the chunk in tiles aligned to the chunk; keys at or past the capacity
  // are cut
  const int cap = a.n_table * a.ps;
  const int ctx = min(max(kFresh ? cs : ct, 0), cap);
  // fresh keys end at the capacity; by value the host resolves the cut:
  // computing it here cost ragged_attention's chunk 3% (its schedule
  // moved, not its work)
  const int f_limit = kDev ? min(ct, cap) : a.f_limit;
  // with fresh K/V the pool keys end before the first query
  const int p_hi = kFresh ? ctx : min(ctx, q_last + 1);
  const int p_lo = a.window > 0 ? max(q_first - a.window + 1, 0) : 0;
  const int pt_first = p_lo / kBK * kBK;
  const int n_ptiles = p_lo < p_hi ? (p_hi - pt_first + kBK - 1) / kBK : 0;
  const int c_hi = min(q_last + 1, f_limit) - cs;
  const int c_lo = a.window > 0 ? max(q_first - a.window + 1 - cs, 0) : 0;
  const int ft_first = c_lo / kBK * kBK;
  const int n_ftiles = kFresh && c_hi > ft_first ? (c_hi - ft_first + kBK - 1) / kBK : 0;
  const int n_tiles = n_ptiles + n_ftiles;
  // first key (absolute) of tile i
  auto tile_key = [&](int i) { return i < n_ptiles ? pt_first + i * kBK : cs + ft_first + (i - n_ptiles) * kBK; };

  const int n_pages_ctx = (ctx + a.ps - 1) / a.ps;
  for (int p = threadIdx.x; p < n_pages_ctx; p += kWgThreads)  // clamped as PagedRows
    table[p] = min(max(a.chunk_row[p], 0), a.num_pages - 1);
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);  // one arrival per consumer warp
    }
    if constexpr (kQuant) {
      for (int s = 0; s < Q::kIStages; ++s) mbar_init(ifull(s), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: thread 0 keeps the ring of K/V stages filled (on an int8
    // pool the warpgroup's other threads convert beside it)
    setmaxnreg_dec<kProducerRegs>();
    const int page0 = a.layer * a.num_pages;
    auto load_q = [&] {
      mbar_expect_tx(bar_q, L::kBlocks * 128 * G * a.bq);
      for (int cb = 0; cb < L::kBlocks; ++cb)
        tma_load(q_s + cb * L::kQBlock, &q_map, bar_q, cb * 64, h * G, tok0, 0);
    };
    auto load_fresh = [&](int kt0, uint32_t st, uint32_t bar) {
      for (int cb = 0; cb < L::kBlocks; ++cb) {
        tma_load(st + cb * L::kKVBlock, &kc_map, bar, cb * 64, h, kt0 - cs, 0);
        tma_load(st + (L::kBlocks + cb) * L::kKVBlock, &vc_map, bar, cb * 64, h, kt0 - cs, 0);
      }
    };
    if constexpr (kQuant) {
      // every producer thread converts: thread 0 issues the loads (Q, the
      // int8 prefix tiles into staging, the fresh tiles into the bf16
      // ring); per prefix tile the first kBK threads read their row's
      // scales (thread t row t, zero past the pool keys), wait for the tile's int8
      // rows and a free bf16 stage, convert K and V into it, stage the
      // scales beside it, fence the writes for wgmma and release the stage
      // together (one arrival), and thread 0 loads the next tile into the
      // staging stage they have read
      const int t = threadIdx.x;
      auto load_int8 = [&](int i, int is) {
        const int kt0 = tile_key(i);
        const uint32_t dst = base + Q::kStageOff + is * 2 * Q::kTile;
        mbar_expect_tx(ifull(is), 2 * Q::kTile);
        for (int b = 0; b < kBK / a.box_rows; ++b) {
          // a box past the pool keys reads from outside the map: zeros
          const int pos = kt0 + b * a.box_rows;
          const bool in = pos < ctx;
          const int pg = in ? page0 + table[pos / a.ps] : a.pool_pages;
          const int row = in ? pos % a.ps : 0;
          tma_load(dst + b * a.box_rows * D, &kp_map, ifull(is), 0, h, row, pg);
          tma_load(dst + Q::kTile + b * a.box_rows * D, &vp_map, ifull(is), 0, h, row, pg);
        }
      };
      if (t == 0) {
        load_q();
        for (int i = 0; i < min(Q::kIStages, n_ptiles); ++i) load_int8(i, i);
      }
      int stage = 0, phase = 0, is = 0, iphase = 0;
      for (int i = 0; i < n_ptiles; ++i) {
        const int pos = tile_key(i) + t;
        float ks = 0.f, vs = 0.f;
        if (t < kBK && pos < ctx) {
          const int64_t r =
              static_cast<int64_t>(page0 + table[pos / a.ps]) * a.ps + pos % a.ps;
          ks = a.k_scale[r];
          vs = a.v_scale[r];
        }
        const unsigned char* src = smem + Q::kStageOff + is * 2 * Q::kTile;
        unsigned char* dst = smem + L::kQBytes + stage * L::kStageBytes;
        mbar_wait(ifull(is), iphase);
        mbar_wait(empty(stage), phase ^ 1);
        convert_tile<D>(src, dst, t);
        convert_tile<D>(src + Q::kTile, dst + L::kBlocks * L::kKVBlock, t);
        if (t < kBK) {
          stage_scales(stage)[t] = ks;
          stage_scales(stage)[kBK + t] = vs;
        }
        fence_proxy_async();  // the converted tiles, before wgmma reads them
        // every thread done: the stage is written, the staging stage read
        asm volatile("bar.sync 3, 128;\n" ::: "memory");
        if (t == 0) {
          mbar_arrive(full(stage));
          if (i + Q::kIStages < n_ptiles) load_int8(i + Q::kIStages, is);
        }
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (++is == Q::kIStages) {
          is = 0;
          iphase ^= 1;
        }
      }
      if (t == 0) {
        for (int i = n_ptiles; i < n_tiles; ++i) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), L::kStageBytes);
          load_fresh(tile_key(i), kv_s + stage * L::kStageBytes, full(stage));
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (threadIdx.x == 0) {
      load_q();
      const int boxes = kBK / a.box_rows, box_bytes = a.box_rows * 128;
      int stage = 0, phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int kt0 = tile_key(i);
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), L::kStageBytes);
        const uint32_t st = kv_s + stage * L::kStageBytes;
        if (i < n_ptiles) {
          for (int b = 0; b < boxes; ++b) {
            // a box past the pool keys reads from outside the map: zeros
            const int pos = kt0 + b * a.box_rows;
            const bool in = pos < ctx;
            const int pg = in ? page0 + table[pos / a.ps] : a.pool_pages;
            const int row = in ? pos % a.ps : 0;
            for (int cb = 0; cb < L::kBlocks; ++cb) {
              tma_load(st + cb * L::kKVBlock + b * box_bytes, &kp_map, full(stage), cb * 64, h,
                       row, pg);
              tma_load(st + (L::kBlocks + cb) * L::kKVBlock + b * box_bytes, &vp_map,
                       full(stage), cb * 64, h, row, pg);
            }
          }
        } else {
          load_fresh(kt0, st, full(stage));
        }
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int slab = c * 64;  // this warpgroup's first row
    const int r0 = slab + warp * 16 + lane / 4, r1 = r0 + 8;
    // the spare rows past G * bq (G not dividing 128) hold zeros
    zero_spare_rows<D>(smem, slab, max(G * a.bq, slab), t);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    const int qp0 = r0 < rows ? q_first + r0 / G : -1;
    const int qp1 = r1 < rows ? q_first + r1 / G : -1;
    const bool live = slab < rows;
    const int w_first = q_first + slab / G;  // this warpgroup's positions
    const int w_last = q_first + min(slab + 63, rows - 1) / G;
    float o[L::kBlocks][32];
#pragma unroll
    for (int cb = 0; cb < L::kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
    }
    float m0 = hopper::kNegInf, m1 = hopper::kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(bar_q, 0);
    int stage = 0, phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int kt0 = tile_key(i);
      const int limit = i < n_ptiles ? ctx : f_limit;
      mbar_wait(full(stage), phase);
      const bool skip = !live || kt0 > w_last ||
                        (a.window > 0 && kt0 + kBK - 1 < w_first - a.window + 1);
      if (!skip) {
        const uint32_t st = kv_s + stage * L::kStageBytes;
        float s[kBK / 2];
        qk_tile<D>(s, q_s, st, slab);
        // the per-element mask only where a row of the query tile misses
        // a key of this tile: the diagonal, the pool or total edge, the
        // window edge
        const bool masked = kt0 + kBK - 1 > q_first || kt0 + kBK > limit ||
                            (a.window > 0 && q_last - kt0 >= a.window);
        uint32_t p[kBK / 16][4];
        bool scaled = false;  // an int8 pool's prefix tile: S and P dequantized
        if constexpr (kQuant) {
          scaled = i < n_ptiles;
          if (scaled) {
            const float* sc = stage_scales(stage);
            scale_keys(s, sc, quad);
            if (masked)
              softmax_tile<true, kCap, true>(s, p, o, m0, m1, l0, l1, a.scale, a.softcap, kt0,
                                             quad, qp0, qp1, limit, a.window, sc + kBK);
            else
              softmax_tile<false, kCap, true>(s, p, o, m0, m1, l0, l1, a.scale, a.softcap, kt0,
                                              quad, qp0, qp1, limit, a.window, sc + kBK);
          }
        }
        if (!scaled) {
          if (masked)
            softmax_tile<true, kCap>(s, p, o, m0, m1, l0, l1, a.scale, a.softcap, kt0, quad,
                                     qp0, qp1, limit, a.window);
          else
            softmax_tile<false, kCap>(s, p, o, m0, m1, l0, l1, a.scale, a.softcap, kt0, quad,
                                      qp0, qp1, limit, a.window);
        }
        pv_tile<D>(o, p, st + L::kBlocks * L::kKVBlock);
      }
      if (lane == 0) mbar_arrive(empty(stage));  // this warp is done with the stage
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_rows<D>(ob, o, l0, l1, r0, r1, rows, G, tok_stride, quad);
  }
}

// Launch of the chunk body through an entry point: Entry::chunk_kernel<D,
// kCap, kDev, kFresh, kQuant>() names its __global__. Without fresh K/V
// their maps are not encoded; the q map stands in, never read. A block
// whose shared memory passes the card's opt-in limit (a table row too long
// to stage) is not launched: kErrSmem.
template <class Entry, int D, bool kCap, bool kDev, bool kFresh, bool kQuant>
int launch(const CUtensorMap* kp_map, const CUtensorMap* vp_map, const void* q, const void* kc,
           const void* vc, const ChunkArgs& a, cudaStream_t stream) {
  CUtensorMap qm, kcm, vcm;
  const int64_t row = static_cast<int64_t>(D) * 2;
  const int G = a.H / a.KVH;
  // q [1, C, H, D] in boxes {64, G, bq}; k/v_chunk [C, KVH, D] in {64, 1, kBK}
  constexpr int kBK = Smem<D>::kBK;
  int err = encode_bf16_4d(&qm, q, D, a.H, a.C, 1, row, row * a.H, row * a.H * a.C, G, a.bq);
  if (err == 0 && kFresh)
    err = encode_bf16_4d(&kcm, kc, D, a.KVH, a.C, 1, row, row * a.KVH, row * a.KVH * a.C, 1, kBK);
  if (err == 0 && kFresh)
    err = encode_bf16_4d(&vcm, vc, D, a.KVH, a.C, 1, row, row * a.KVH, row * a.KVH * a.C, 1, kBK);
  if (err != 0) return err;
  if (!kFresh) kcm = vcm = qm;
  auto kernel = Entry::template chunk_kernel<D, kCap, kDev, kFresh, kQuant>();
  const int smem = smem_bytes<D, kFresh, kQuant>(a);
  if (smem > max_smem_optin()) return kErrSmem;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((a.C + a.bq - 1) / a.bq, a.KVH);
  kernel<<<grid, kWgThreads, smem, stream>>>(qm, *kp_map, *vp_map, kcm, vcm, a);
  return cudaGetLastError();
}

// The chunk entry points' host side: check the shapes, copy the caller's
// pool maps (host buffers of gridllm_ragged_pool_map) to aligned maps and
// launch at D 64, 128 or 256, with or without softcap; kDev and kFresh as
// chunk_body's (without kDev the bounds hold start and a total >= 0, and
// f_limit its cut at the capacity; kc/vc are given iff kFresh); kQuant: the
// maps read an int8 pool and a.k_scale/v_scale are its scales. Returns
// cudaGetLastError() of the launch, kErrNoEncoder, kErrTensorMap or
// kErrSmem.
template <class Entry, bool kDev, bool kFresh, bool kQuant>
int run(const void* kp_map, const void* vp_map, const void* q, const void* kc, const void* vc,
        const ChunkArgs& a, int D, cudaStream_t stream) {
  if (a.H % a.KVH || a.bq < 1 || a.bq * (a.H / a.KVH) > kRows || a.box_rows < 8 ||
      a.box_rows % 8 || tile_keys(D) % a.box_rows || a.ps % a.box_rows ||
      (kc != nullptr) != kFresh || (vc != nullptr) != kFresh ||
      kDev != a.bounds.on_device() || (!kDev && a.bounds.total < 0) ||
      (a.k_scale != nullptr) != kQuant || (a.v_scale != nullptr) != kQuant)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kpm, vpm;  // 64-byte aligned copies of the caller's maps
  memcpy(&kpm, kp_map, sizeof(CUtensorMap));
  memcpy(&vpm, vp_map, sizeof(CUtensorMap));
  const bool cap = a.softcap > 0.f;
  switch (D) {
    case 64:
      return cap ? launch<Entry, 64, true, kDev, kFresh, kQuant>(&kpm, &vpm, q, kc, vc, a,
                                                                 stream)
                 : launch<Entry, 64, false, kDev, kFresh, kQuant>(&kpm, &vpm, q, kc, vc, a,
                                                                  stream);
    case 128:
      return cap ? launch<Entry, 128, true, kDev, kFresh, kQuant>(&kpm, &vpm, q, kc, vc, a,
                                                                  stream)
                 : launch<Entry, 128, false, kDev, kFresh, kQuant>(&kpm, &vpm, q, kc, vc, a,
                                                                   stream);
    case 256:
      return cap ? launch<Entry, 256, true, kDev, kFresh, kQuant>(&kpm, &vpm, q, kc, vc, a,
                                                                  stream)
                 : launch<Entry, 256, false, kDev, kFresh, kQuant>(&kpm, &vpm, q, kc, vc, a,
                                                                   stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace chunk
}  // namespace gridllm
