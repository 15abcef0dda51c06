// Shared core of the CUDA-core attention kernels (attention_bodies.cuh's
// `ragged_body`, behind ragged_attention.cu and per_phase_attention.cu):
// one thread block attends a set of query rows (the G query heads of ONE
// kv head, for a run of consecutive query tokens) to one or more SEGMENTS
// of keys, with an online softmax in float32.
//
// Design, for the H100 (sm_90a):
// - The K/V rows of a segment stream through shared memory in tiles of
//   kTileKeys keys, converted to float32 on load with 16-byte vector reads
//   (a key row of one kv head is D contiguous values; rows are strided by
//   KVH*D in both the page pool and the fresh K/V). Each thread issues a
//   batch of up to 8 such reads of K and of V (and their page-table reads)
//   before it converts and stores any of them, so a tile costs about one
//   trip to device memory, not one per read; where a tile is one batch
//   and registers allow, the next tile's batch is issued before this
//   tile's math.
// - Each of the kWarps warps owns RPW query rows, kept in shared memory
//   pre-scaled by 1/sqrt(D). A warp scores 32 keys at a time, one key per
//   lane, reusing every K value it reads for its RPW rows (register
//   blocking: the K reads from shared memory, not the multiply-adds, bound
//   the inner loop). The softmax statistics are warp reductions; each lane
//   owns D/32 output columns of every row's accumulator.
// - Masking uses absolute positions: key at position kp is visible to the
//   query at qp iff the segment's key policy says so and (window <= 0 or
//   qp - kp < window). The causal policy (`CausalKeys`, every segment of
//   every kernel but one) is kp <= qp and kp < klimit; the tree policy
//   (`TreeKeys`, the fresh columns of a tree-verify group) gives key j the
//   logical position pos0 + depth[j] and shows it to row i iff bit j of
//   row i's ancestor mask is set. Masked scores get probability 0 (the
//   finite -1e30 of the JAX package's kernels only enters the running
//   maximum), and the output is acc / max(l, 1e-30).
// - All math runs on the CUDA cores in float32 (the tensor-core kernels
//   build on hopper_common.cuh instead); see PERF.md for what this costs
//   against the card's bound.
// - A segment's rows come through a row READER (`KVRows` for rows of the
//   compute dtype, `QuantPagedRows` for an int8 page pool, which multiplies
//   each row by its float32 scale right after the load), so the int8 pool
//   shares the block's tile walk and math with the fp pools.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gridllm {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 64;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC = 16 / sizeof(T) values of a 16-byte read as floats.
template <typename T>
__device__ __forceinline__ void unpack_vec(const uint4& raw, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC; ++e) dst[e] = to_f<T>(vals[e]);
}

// Read VEC = 16 / sizeof(T) values at a 16-byte aligned address as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  unpack_vec<T>(*reinterpret_cast<const uint4*>(src), dst);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Key rows stored contiguously: row r at offset r * stride (elements).
struct ContigRows {
  int64_t stride;
  __device__ __forceinline__ int64_t operator()(int r) const {
    return static_cast<int64_t>(r) * stride;
  }
};

// Key rows of one slot in the page pool [L, P, ps, KVH, D]: absolute
// position r lives in page table[r / ps], row r % ps. Table entries are
// clamped into [0, P) so an unmapped (-1) or corrupt entry never reads
// outside the pool (such rows are masked by the caller's limits anyway).
struct PagedRows {
  const int* table;
  int n_table;
  int64_t layer_base;  // layer * P * ps (rows)
  int ps;
  int num_pages;
  int64_t row_stride;  // KVH * D (elements)
  // The pool row [L * P * ps] of position r: also the index of its scale
  // in an int8 pool's [L, P, ps] scales.
  __device__ __forceinline__ int64_t row(int r) const {
    int p = r / ps;
    int page = p < n_table ? table[p] : 0;
    page = min(max(page, 0), num_pages - 1);
    return layer_base + static_cast<int64_t>(page) * ps + (r - p * ps);
  }
  __device__ __forceinline__ int64_t operator()(int r) const { return row(r) * row_stride; }
};

// Row reader of K/V of element type E: row r's K/V start at k/v + off(r).
// fetch() reads VEC values from column c of both (16 bytes each) into a
// Raw; unpack() turns a Raw into floats. A tile's fetches are issued
// together, before any unpack.
template <typename E, class RowOff>
struct KVRows {
  static constexpr int VEC = 16 / sizeof(E);
  struct Raw {
    uint4 k, v;
  };
  const E* k;
  const E* v;
  RowOff off;
  __device__ __forceinline__ void fetch(int r, int c, Raw& raw) const {
    const int64_t o = off(r) + c;
    raw.k = *reinterpret_cast<const uint4*>(k + o);
    raw.v = *reinterpret_cast<const uint4*>(v + o);
  }
  __device__ __forceinline__ void unpack(const Raw& raw, float* kv, float* vv) const {
    unpack_vec<E>(raw.k, kv);
    unpack_vec<E>(raw.v, vv);
  }
};

// Row reader of an int8 page pool: one 16-byte load is 16 values of a row,
// multiplied by the row's float32 scale (k_scale/v_scale [L, P, ps],
// indexed by the pool row, not by element or page).
struct QuantPagedRows {
  static constexpr int VEC = 16;
  struct Raw {
    uint4 k, v;
    float ks, vs;
  };
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  PagedRows rows;
  __device__ __forceinline__ void fetch(int r, int c, Raw& raw) const {
    const int64_t row = rows.row(r);
    const int64_t o = row * rows.row_stride + c;
    raw.k = *reinterpret_cast<const uint4*>(k + o);
    raw.v = *reinterpret_cast<const uint4*>(v + o);
    raw.ks = k_scale[row];
    raw.vs = v_scale[row];
  }
  __device__ __forceinline__ void unpack(const Raw& raw, float* kv, float* vv) const {
    unpack_vec<int8_t>(raw.k, kv);
    unpack_vec<int8_t>(raw.v, vv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      kv[e] *= raw.ks;
      vv[e] *= raw.vs;
    }
  }
};

// Key policy of a causal segment: row r of the segment sits at absolute
// position pos0 + r and is visible to the query at qp iff kp <= qp and
// kp < klimit.
struct CausalKeys {
  int pos0, klimit;
  __device__ __forceinline__ int pos(int r) const { return pos0 + r; }
  __device__ __forceinline__ bool visible(int, int, int qp, int kp) const {
    return kp <= qp && kp < klimit;
  }
};

// Key policy of a tree-verify group's fresh columns (at most 32 nodes):
// column r is tree node r at logical position pos0 + depth[r], visible to
// the warp's row `row` iff bit r of that row's ancestor mask bits[row] is
// set. An ancestor is never deeper than its descendant, so there is no
// separate causal term; the window applies to the logical distance.
template <int RPW>
struct TreeKeys {
  const int* depth;    // [32] node depths (shared memory)
  int pos0;
  unsigned bits[RPW];  // ancestor-or-self mask of each of the warp's rows
  __device__ __forceinline__ int pos(int r) const { return pos0 + depth[r & 31]; }
  __device__ __forceinline__ bool visible(int row, int r, int, int) const {
    return (bits[row] >> r) & 1u;
  }
};

// Shared-memory floats the attention block needs.
template <int D, int RPW>
constexpr int smem_floats() {
  return kWarps * RPW * D + kTileKeys * (D + 4) + kTileKeys * D;
}

template <typename T, int D, int RPW>
struct AttnBlock {
  static_assert(D % 32 == 0 && D % (16 / sizeof(T)) == 0, "head_dim");
  static constexpr int NR = kWarps * RPW;  // rows per pass
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int KS = D + 4;         // padded K row: conflict-free float4 reads

  float* qs;  // [NR][D]
  float* ks;  // [kTileKeys][KS]
  float* vs;  // [kTileKeys][D]
  int warp, lane;
  float softcap;
  int window;
  float m[RPW], l[RPW], acc[RPW][D / 32];
  int qpos[RPW];

  __device__ AttnBlock(float* smem, float softcap_, int window_)
      : softcap(softcap_), window(window_) {
    qs = smem;
    ks = qs + NR * D;
    vs = ks + kTileKeys * KS;
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
  }

  // Load rows [row0, row0 + NR) of a row list of `rows_total` rows into
  // shared memory and reset the softmax state. Row i is query token i / G,
  // head g = i % G: at qbase + (i / G) * tok_stride + (i % G) * D, at
  // absolute position qpos0 + i / G.
  __device__ void load_q(const T* qbase, int64_t tok_stride, int G, int row0,
                         int rows_total, int qpos0, float scale) {
    __syncthreads();  // the previous pass's readers of qs are done
    for (int idx = threadIdx.x; idx < NR * (D / VEC); idx += kThreads) {
      int row = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
      int gi = row0 + row;
      float vals[VEC];
      if (gi < rows_total) {
        load_vec<T>(qbase + static_cast<int64_t>(gi / G) * tok_stride + (gi % G) * D + c, vals);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qs[row * D + c + e] = vals[e] * scale;
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      int gi = row0 + warp * RPW + r;
      qpos[r] = gi < rows_total ? qpos0 + gi / G : -1;
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;
    }
  }

  // Tree rows: row token i sits at logical position pos0 + depth[i] (its
  // storage position stays pos0 + i). Call after load_q.
  __device__ void tree_qpos(const int* depth, int G, int row0, int rows_total, int pos0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int gi = row0 + warp * RPW + r;
      qpos[r] = gi < rows_total ? pos0 + depth[gi / G] : -1;
    }
  }

  // Attend to key rows [r_lo, r_hi) of one segment: row r's K/V start at
  // kbase/vbase + off(r), its absolute position is pos0 + r, and keys at
  // positions >= klimit are masked.
  template <class RowOff>
  __device__ void segment(const T* kbase, const T* vbase, RowOff off, int r_lo,
                          int r_hi, int pos0, int klimit) {
    segment(KVRows<T, RowOff>{kbase, vbase, off}, r_lo, r_hi, CausalKeys{pos0, klimit});
  }

  // The same through a row reader (KVRows or QuantPagedRows).
  template <class Rows>
  __device__ void segment(const Rows& src, int r_lo, int r_hi, int pos0, int klimit) {
    segment(src, r_lo, r_hi, CausalKeys{pos0, klimit});
  }

  // The same with a key policy (CausalKeys or TreeKeys) giving each row's
  // position and visibility.
  template <class Rows, class Keys>
  __device__ void segment(const Rows& src, int r_lo, int r_hi, const Keys& keys) {
    constexpr int SV = Rows::VEC;
    constexpr int CPR = D / SV;                     // 16-byte reads per row
    constexpr int PER = kTileKeys * CPR / kThreads;  // reads of K (and V) per thread
    constexpr int BATCH = PER < 8 ? PER : 8;         // issued before any is used
    // With one batch per tile and registers to spare (the held reads and
    // the accumulators within 68 registers: decode rows, D = 64, the int8
    // pool at up to 4 rows per warp), the next tile's reads are issued
    // before this tile's math, so they are in flight while it runs; at 8
    // rows per warp and D = 128 holding them spilled and measured slower.
    constexpr bool kPrefetch =
        PER == BATCH && RPW * (D / 32) + PER * int(sizeof(typename Rows::Raw)) / 4 <= 68;
    static_assert(D % SV == 0, "head_dim must hold whole 16-byte loads");
    static_assert(PER * kThreads == kTileKeys * CPR && PER % BATCH == 0, "tile shape");
    typename Rows::Raw raw[BATCH];
    auto fetch = [&](int t0, int nk, int b0) {  // rows past nk read row nk - 1
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = threadIdx.x + (b0 + i) * kThreads;
        src.fetch(t0 + min(idx / CPR, nk - 1), (idx % CPR) * SV, raw[i]);
      }
    };
    auto store = [&](int nk, int b0) {  // rows past nk as zeros
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = threadIdx.x + (b0 + i) * kThreads;
        const int j = idx / CPR, c = (idx % CPR) * SV;
        float kv[SV], vv[SV];
        src.unpack(raw[i], kv, vv);
        const bool live = j < nk;
#pragma unroll
        for (int e = 0; e < SV; e += 4) {  // 16-byte stores (rows are 16-byte aligned)
          *reinterpret_cast<float4*>(ks + j * KS + c + e) =
              live ? make_float4(kv[e], kv[e + 1], kv[e + 2], kv[e + 3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(vs + j * D + c + e) =
              live ? make_float4(vv[e], vv[e + 1], vv[e + 2], vv[e + 3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    };
    if constexpr (kPrefetch) {
      if (r_lo < r_hi) fetch(r_lo, min(kTileKeys, r_hi - r_lo), 0);
    }
    for (int t0 = r_lo; t0 < r_hi; t0 += kTileKeys) {
      const int nk = min(kTileKeys, r_hi - t0);
      __syncthreads();  // previous tile consumed; q rows visible
      if constexpr (kPrefetch) {
        store(nk, 0);
      } else {
#pragma unroll
        for (int b0 = 0; b0 < PER; b0 += BATCH) {
          fetch(t0, nk, b0);
          store(nk, b0);
        }
      }
      __syncthreads();
      const int t1 = t0 + kTileKeys;
      if constexpr (kPrefetch) {
        if (t1 < r_hi) fetch(t1, min(kTileKeys, r_hi - t1), 0);
      }
      tile(nk, t0, keys);
    }
  }

  // Score, mask and accumulate the nk keys of the shared-memory tile: key
  // j is segment row t0 + j, at position keys.pos(t0 + j).
  template <class Keys>
  __device__ void tile(int nk, int t0, const Keys& keys) {
    for (int sub = 0; sub < nk; sub += 32) {
      const int j = sub + lane;
      const int kp = keys.pos(t0 + j);
      float s[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = 0.f;
      const float* krow = ks + j * KS;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + (warp * RPW + r) * D + d);
          s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float x = s[r];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int qp = qpos[r];
        const bool ok = j < nk && qp >= 0 && keys.visible(r, t0 + j, qp, kp) &&
                        (window <= 0 || qp - kp < window);
        const float m_new = fmaxf(m[r], warp_max(ok ? x : kNegInf));
        const float alpha = expf(m[r] - m_new);
        const float p = ok ? expf(x - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < D / 32; ++c) acc[r][c] *= alpha;
        s[r] = p;
      }
      const int nsub = min(32, nk - sub);
      for (int jj = 0; jj < nsub; ++jj) {
        const float* vrow = vs + (sub + jj) * D;
        float vv[D / 32];
#pragma unroll
        for (int c = 0; c < D / 32; ++c) vv[c] = vrow[lane + 32 * c];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float p = __shfl_sync(kFull, s[r], jj);
#pragma unroll
          for (int c = 0; c < D / 32; ++c) acc[r][c] += p * vv[c];
        }
      }
    }
  }

  // Write the warp's rows: out = acc / max(l, 1e-30), same row addressing
  // as load_q.
  __device__ void store(T* obase, int64_t tok_stride, int G, int row0, int rows_total) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int gi = row0 + warp * RPW + r;
      if (gi >= rows_total) continue;
      T* o = obase + static_cast<int64_t>(gi / G) * tok_stride + (gi % G) * D;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) o[lane + 32 * c] = from_f<T>(acc[r][c] * inv);
    }
  }
};

// Opt a kernel instance into more than 48 KB of dynamic shared memory
// (set before every launch: a host-side attribute write, no device work).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace gridllm
