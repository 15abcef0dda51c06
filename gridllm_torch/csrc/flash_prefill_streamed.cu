// flash_prefill_streamed: causal GQA attention over one long prompt bucket,
// K/V streamed through shared memory one tile at a time, on tensor cores.
//
// Replaces gridllm_tpu/ops/pallas_kernels.py:268 `flash_prefill_streamed`
// (body `_flash_prefill_stream_kernel`, :190). Same function as
// flash_prefill.cu: q [B, T, H, D] against k/v [B, T, KVH, D], keys at
// positions >= seq_lens[b] masked, causal, an optional sliding window and
// tanh softcap (applied before the mask), float32 online softmax, output
// acc / max(l, 1e-30) in q's dtype. Rows at positions >= seq_lens[b] are
// padding, unspecified by the contract (the JAX kernel's tests compare the
// valid rows only): a query tile wholly past the valid length writes zeros
// and does no work.
//
// What bounds it on the H100: operations. A bucket of T tokens costs
// 4*T*T*H*D/2 flops against (2*T*H*D + 2*T*KVH*D) * itemsize bytes; at
// T = 32768 that is 8.8 TFLOP (8.9 ms at 989 TFLOP/s) against 0.6 GB
// (0.2 ms at 3.35 TB/s).
//
// Design, and what it does about that bound:
// - One block of 8 warps per (query tile, kv head, batch). The tile stacks
//   the G query heads of the kv head over BQ = 128 / G consecutive tokens:
//   128 rows, 16 per warp (one m16 tile of mma.sync). flash_prefill.cu's
//   blocks hold 32 rows, so at T = 32768 each K/V tile is fetched by 4x
//   more blocks there; here one tile in shared memory serves 128 rows.
// - K/V tiles of 64 keys stream through a double buffer with cp.async: the
//   next tile is in flight while the current one is scored. Keys past the
//   causal bound min(last query + 1, seq_len) are never loaded (zero-filled
//   at the edge), and with a window the tiles below the first query's
//   window are skipped; each warp also skips the math of tiles wholly
//   outside its own rows' causal and window bounds.
// - Both products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   float32 accumulate): S = Q K^T, then P V with P rounded to bf16. For
//   float32 inputs every operand is split into bf16 hi + lo parts and each
//   product is hi*hi + hi*lo + lo*hi (three mma): about 16 mantissa bits,
//   far inside the 1e-3 float32 tolerance.
// - Query tiles are issued heaviest first (the last tokens see the most
//   keys), and the blocks in flight at once share one kv head, so its K/V
//   stay in L2.
// - Offsets into q, k, v and out are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gridllm {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr float kNegInf = -1e30f;

// Shared-memory row stride in elements: 8 elements of padding make the
// fragment loads below conflict-free (row stride = 4 or 8 banks mod 32).
template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }

template <typename T, int D>
constexpr int smem_bytes() {
  return (kRows + 4 * kBK) * ld<D>() * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// A pair of values as a bf16x2 mma operand register; float32 inputs also
// give the rounding remainder (lo) so that hi + lo carries ~16 bits.
struct Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ Pair split2(float a, float b) {
  const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
  const float ra = a - __bfloat162float(ha), rb = b - __bfloat162float(hb);
  __nv_bfloat162 h;
  h.x = ha;
  h.y = hb;
  return {*reinterpret_cast<uint32_t*>(&h), pack_bf16(ra, rb)};
}

// Two adjacent elements p[0], p[1].
__device__ __forceinline__ Pair load_pair(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint32_t*>(p), 0u};
}
__device__ __forceinline__ Pair load_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return split2(v.x, v.y);
}

// Two elements one row apart: p[0], p[stride].
__device__ __forceinline__ Pair load_col_pair(const __nv_bfloat16* p, int stride) {
  const uint32_t a = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t b = *reinterpret_cast<const unsigned short*>(p + stride);
  return {a | (b << 16), 0u};
}
__device__ __forceinline__ Pair load_col_pair(const float* p, int stride) {
  return split2(p[0], p[stride]);
}

// Two probabilities as an A-operand register pair (hi, lo).
template <bool kSplit>
__device__ __forceinline__ Pair prob_pair(float a, float b) {
  if (kSplit) return split2(a, b);
  return {pack_bf16(a, b), 0u};
}

// c += a * b: m16n8k16, A row-major (4 regs), B column-major (2 regs).
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A * B with A = a[0..3], B = b[0..1], each split when kSplit.
template <bool kSplit>
__device__ __forceinline__ void mma_split(float (&c)[4], const Pair (&a)[4], const Pair (&b)[2]) {
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  if (kSplit) {
    mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
    mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_prefill_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const int* __restrict__ seq_lens,
                                  T* __restrict__ out, int t_len, int H, int KVH, int bq,
                                  float scale, float softcap, int window) {
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int LD = ld<D>();
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CH = D / VEC;          // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][LD]
  T* ks = qs + kRows * LD;                 // [2][kBK][LD]
  T* vs = ks + 2 * kBK * LD;               // [2][kBK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int tok0 = qt * bq;
  const int ntok = min(bq, t_len - tok0);
  const int rows = ntok * G;
  const int seq_len = seq_lens[b];
  const int64_t tok_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(KVH) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * t_len + tok0) * tok_stride +
                       static_cast<int64_t>(h) * G * D;
  const T* kb = k + static_cast<int64_t>(b) * t_len * kv_stride + static_cast<int64_t>(h) * D;
  const T* vb = v + static_cast<int64_t>(b) * t_len * kv_stride + static_cast<int64_t>(h) * D;

  if (tok0 >= seq_len) {  // padding rows only
    for (int idx = threadIdx.x; idx < rows * (D / 2); idx += kThreads) {
      const int r = idx / (D / 2), c = (idx % (D / 2)) * 2;
      store2(out + qoff + static_cast<int64_t>(r / G) * tok_stride + (r % G) * D + c, 0.f, 0.f);
    }
    return;
  }

  // keys this tile can see: [k_lo, k_hi), tiles from k_lo's tile down
  const int k_hi = min(tok0 + ntok, seq_len);
  const int k_lo = window > 0 ? max(tok0 - window + 1, 0) : 0;
  const int kt_first = (k_lo / kBK) * kBK;
  const int n_tiles = (k_hi - kt_first + kBK - 1) / kBK;

  auto load_kv = [&](int stage, int kt0) {
    T* kd = ks + stage * kBK * LD;
    T* vd = vs + stage * kBK * LD;
    for (int idx = threadIdx.x; idx < kBK * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * VEC;
      const int key = kt0 + r;
      const bool ok = key < k_hi;
      const int64_t src = static_cast<int64_t>(ok ? key : 0) * kv_stride + c;
      cp_async16(kd + r * LD + c, kb + src, ok);
      cp_async16(vd + r * LD + c, vb + src, ok);
    }
  };

  // query rows (zeros past the tile) and the first K/V tile: one group
  for (int idx = threadIdx.x; idx < kRows * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx % CH) * VEC;
    const bool ok = r < rows;
    const int64_t src = ok ? static_cast<int64_t>(r / G) * tok_stride + (r % G) * D + c : 0;
    cp_async16(qs + r * LD + c, q + qoff + src, ok);
  }
  load_kv(0, kt_first);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tid = lane % 4;
  const int wr0 = warp * 16;                      // first row of this warp
  const bool warp_live = wr0 < rows;
  const int ra = wr0 + g, rb = wr0 + g + 8;       // the lane's two rows
  const int qpos_a = ra < rows ? tok0 + ra / G : -1;
  const int qpos_b = rb < rows ? tok0 + rb / G : -1;
  const int w_first = tok0 + wr0 / G;             // the warp's token range
  const int w_last = tok0 + (min(wr0 + 15, rows - 1)) / G;

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int kt0 = kt_first + i * kBK;
    if (i + 1 < n_tiles) {
      load_kv((i + 1) & 1, kt0 + kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool skip = !warp_live || kt0 > w_last ||
                      (window > 0 && kt0 + kBK - 1 < w_first - window + 1);
    if (!skip) {
      const T* kt = ks + (i & 1) * kBK * LD;
      const T* vt = vs + (i & 1) * kBK * LD;
      // S = Q K^T for the warp's 16 rows x 64 keys
      float s[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const T* qa = qs + ra * LD + kk * 16 + tid * 2;
        const T* qb = qs + rb * LD + kk * 16 + tid * 2;
        const Pair a[4] = {load_pair(qa), load_pair(qb), load_pair(qa + 8), load_pair(qb + 8)};
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          const T* kr = kt + (n * 8 + g) * LD + kk * 16 + tid * 2;
          const Pair bb[2] = {load_pair(kr), load_pair(kr + 8)};
          mma_split<kSplit>(s[n], a, bb);
        }
      }
      // scale, softcap, mask; online softmax over the tile
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = e < 2 ? qpos_a : qpos_b;
          const int kp = kt0 + n * 8 + tid * 2 + (e & 1);
          float x = s[n][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const bool ok = qp >= 0 && kp <= qp && kp < seq_len && (window <= 0 || qp - kp < window);
          x = ok ? x : kNegInf;
          s[n][e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = __expf(m_a - mn_a), al_b = __expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
      }
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          const float p = x > 0.5f * kNegInf ? __expf(x - (e < 2 ? m_a : m_b)) : 0.f;
          s[n][e] = p;
          if (e < 2) l_a += p; else l_b += p;
        }
      }
      // O += P V, P as the A operand (16 keys per k-step)
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        const Pair a[4] = {prob_pair<kSplit>(s[2 * j][0], s[2 * j][1]),
                           prob_pair<kSplit>(s[2 * j][2], s[2 * j][3]),
                           prob_pair<kSplit>(s[2 * j + 1][0], s[2 * j + 1][1]),
                           prob_pair<kSplit>(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const T* vr = vt + (j * 16 + tid * 2) * LD + n * 8 + g;
          const Pair bb[2] = {load_col_pair(vr, LD), load_col_pair(vr + 8 * LD, LD)};
          mma_split<kSplit>(o[n], a, bb);
        }
      }
    }
    __syncthreads();  // this stage is free for the load two tiles ahead
  }

  // row sums over the quad, normalise, store the valid rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  T* oa = out + qoff + static_cast<int64_t>(ra / G) * tok_stride + (ra % G) * D + tid * 2;
  T* ob = out + qoff + static_cast<int64_t>(rb / G) * tok_stride + (rb % G) * D + tid * 2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qpos_a >= 0) store2(oa + n * 8, o[n][0] * inv_a, o[n][1] * inv_a);
    if (qpos_b >= 0) store2(ob + n * 8, o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* seq_lens, void* out,
                   int B, int t_len, int H, int KVH, int bq, float scale, float softcap,
                   int window, cudaStream_t stream) {
  auto kernel = flash_prefill_streamed_kernel<T, D>;
  constexpr int smem = smem_bytes<T, D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + bq - 1) / bq, KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), t_len, H, KVH, bq, scale,
      softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int d, const void* q, const void* k, const void* v, const void* seq_lens,
                   void* out, int B, int t_len, int H, int KVH, int bq, float scale,
                   float softcap, int window, cudaStream_t s) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap, window, s);
    case 128: return launch<T, 128>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap, window, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gridllm

// dtype: 0 = float32, 1 = bfloat16; bq * (H / KVH) <= 128 query rows per
// block. Returns cudaGetLastError() of the launch.
extern "C" int gridllm_flash_prefill_streamed(const void* q, const void* k, const void* v,
                                              const void* seq_lens, void* out, int dtype, int B,
                                              int t_len, int H, int KVH, int D, int bq,
                                              float scale, float softcap, int window,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bq < 1 || bq * (H / KVH) > gridllm::kRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = gridllm::by_dim<float>(D, q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap,
                                 window, s);
  else if (dtype == 1)
    err = gridllm::by_dim<__nv_bfloat16>(D, q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale,
                                         softcap, window, s);
  return static_cast<int>(err);
}
