// Hopper (sm_90a) building blocks shared by the tensor-core attention
// kernels: flash_prefill.cu's prefill kernel and the chunk body of
// attention_bodies.cuh (ragged_attention.cu's and per_phase_attention.cu's
// chunk kernels). Each PTX form is one small wrapper:
// - mbarriers (init, expect_tx, arrive, a parity wait that traps after
//   ~2^34 cycles instead of hanging the card);
// - TMA 4-D tile loads into shared memory, completion counted in bytes on
//   an mbarrier, and the host encoders of their tensor maps (bf16 tiles
//   128-byte swizzled; int8 rows unswizzled);
// - wgmma: shared-memory descriptors of 128-byte-swizzled tiles,
//   m64n128k16 and m64n64k16 with both operands in shared memory (S = Q K^T
//   over a 128- or a 64-key tile) and m64n64k16 with A from registers
//   (O += P V), the fences around them;
// - setmaxnreg for the producer and consumer warpgroups;
// - the online-softmax step of one K/V tile on the m64nBK accumulator
//   layout, with the per-element mask on absolute positions as a template
//   flag (`softmax_tile`), and optionally per-key V scales on P (the int8
//   pool's chunk).
// Both kernels share the block shape: one producer warpgroup (one thread
// issues TMA loads) and two consumer warpgroups of 64 query rows each,
// over a ring of K/V stages (`Smem<D>`). The keys per tile depend on D
// (`tile_keys`): 128 at D 64 and 128; 64 at D = 256, where Q alone takes
// 64 KB and a 128-key stage of K and V 128 KB, so two such stages would
// pass the 227 KB a block may use, and the consumers' O (m64n256, 128
// float registers a thread) leaves room for S of 64 keys (32 registers),
// not 128 (64).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace gridllm {
namespace hopper {

constexpr int kRows = 128;  // query rows per block

// Keys per K/V tile at head dim D (see the note at the top); the host's
// plans take the same value (ops/cuda_kernels.py `prefill_bk`).
__host__ __device__ constexpr int tile_keys(int D) { return D == 256 ? 64 : 128; }
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kConsumers = 2;                       // m64 row slabs
constexpr int kWgThreads = 128 * (1 + kConsumers);  // producer + consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// A query tile wholly past the valid length: zeros in its rows, no work.
template <typename T, int D>
__device__ __forceinline__ void write_zeros(T* ob, int rows, int G, int64_t tok_stride,
                                            int nthreads) {
  for (int idx = threadIdx.x; idx < rows * (D / 2); idx += nthreads) {
    const int r = idx / (D / 2), c = (idx % (D / 2)) * 2;
    store2(ob + static_cast<int64_t>(r / G) * tok_stride + (r % G) * D + c, 0.f, 0.f);
  }
}

// Shared-memory layout of a block: Q, then kStages K/V stages of kBK keys,
// then the mbarriers. D = 256: 64 KB of Q and two 64 KB stages.
template <int D>
struct Smem {
  static constexpr int kBK = tile_keys(D);           // keys per K/V tile
  static constexpr int kBlocks = D / 64;             // 64-column (128-byte) blocks
  static constexpr int kQBlock = kRows * 128;        // bytes of one Q column block
  static constexpr int kKVBlock = kBK * 128;         // bytes of one K or V column block
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kStageBytes = 2 * kBlocks * kKVBlock;  // K blocks, then V blocks
  static constexpr int kQBytes = kBlocks * kQBlock;
  static constexpr int kBarOff = kQBytes + kStages * kStageBytes;
  // + the barriers (q, then full and empty per stage) + 1024 to align the base
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the phase of the given parity to complete. A phase that never
// completes (a load that never lands) traps after ~2^34 cycles instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) asm volatile("trap;\n");
  }
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (TMA, wgmma) before they read it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// One TMA box of a 4-D map {c0, c1, c2, c3} into shared memory; completion
// counted in bytes on `bar`. Coordinates outside the map fill zeros (the
// bytes still count).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned, or offset along K inside one 128-byte row): start
// address, leading and stride byte offsets in 16-byte units, swizzle mode
// 1 (128B). A K-major operand steps 8 rows of 128 bytes by the stride
// offset; an MN-major operand of 64 columns (one swizzle row) steps 8 K
// rows by one of the two offsets and never uses the other, so both are
// 1024 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma registers across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A * B, m64n128k16: A (64 x 16) and B (16 x 128) from shared memory, both
// K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A * B, m64n64k16: A (64 x 16) and B (16 x 64) from shared memory, both
// K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A * B, m64n64k16: A (64 x 16) from registers, B (16 x 64) from
// shared memory, MN-major (transposed); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Logits of one K/V tile in the log2 domain (scale*log2(e), softcap), the
// per-element mask only when kMask (key kp visible to the query at qp iff
// kp <= qp, kp < seq_len and, with a window, qp - kp < window; positions
// absolute, the tile's first key at kt0), the online-softmax update of the
// row statistics and of O, and P as bf16 wgmma A fragments. Thread layout
// of the m64nBK accumulator (NS = BK / 2 floats a thread): s[i] is row r0
// (i % 4 < 2) or r0 + 8, key 8 * (i / 4) + 2 * quad + (i & 1) of the tile.
// kVScale: P's columns are multiplied by v_scale[key] (BK floats in shared
// memory) before they are packed, and l sums them unscaled (an int8 V tile
// converted exactly).
template <bool kMask, bool kCap, bool kVScale = false, int NB, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], uint32_t (&p)[NS / 8][4],
                                             float (&o)[NB][32], float& m0, float& m1,
                                             float& l0, float& l1, float scale, float softcap,
                                             int kt0, int quad, int qp0, int qp1, int seq_len,
                                             int window, const float* v_scale = nullptr) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = kCap ? softcap * tanhf(s[i] * scale / softcap) * kLog2e : s[i] * (scale * kLog2e);
    if (kMask) {
      const int kp = kt0 + (i / 4) * 8 + quad * 2 + (i & 1);
      const int qp = (i & 2) ? qp1 : qp0;
      const bool ok = kp <= qp && kp < seq_len && (window <= 0 || qp - kp < window);
      x = ok ? x : kNegInf;
    }
    s[i] = x;
    if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= al0;
  l1 *= al1;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] *= (i & 2) ? al1 : al0;
  }
#pragma unroll
  for (int j = 0; j < NS / 8; ++j) {  // keys 16j .. 16j + 15: s[8j .. 8j + 7]
    float e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float x = s[8 * j + u];
      float pe = exp2f(x - ((u & 2) ? m1 : m0));
      if (kMask) pe = x > 0.5f * kNegInf ? pe : 0.f;  // a row with no visible key yet
      e[u] = pe;
      if (u & 2) l1 += pe; else l0 += pe;
    }
    if constexpr (kVScale) {  // P's column of key k times V row k's scale (l sums P unscaled)
      const float2 v0 = reinterpret_cast<const float2*>(v_scale)[8 * j + quad];
      const float2 v1 = reinterpret_cast<const float2*>(v_scale)[8 * j + 4 + quad];
      e[0] *= v0.x; e[1] *= v0.y; e[2] *= v0.x; e[3] *= v0.y;
      e[4] *= v1.x; e[5] *= v1.y; e[6] *= v1.x; e[7] *= v1.y;
    }
    p[j][0] = pack_bf16(e[0], e[1]);  // row r0,     keys 16j + 2 quad (+1)
    p[j][1] = pack_bf16(e[2], e[3]);  // row r0 + 8, the same keys
    p[j][2] = pack_bf16(e[4], e[5]);  // row r0,     keys 16j + 8 + 2 quad (+1)
    p[j][3] = pack_bf16(e[6], e[7]);  // row r0 + 8
  }
}

// S = Q K^T for one consumer warpgroup: its 64-row slab of the Q tile at
// q_s against the K blocks of the stage at k_s, both 128-byte swizzled in
// 64-column blocks of kRows (Q) and kBK (K) rows.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[Smem<D>::kBK / 2], uint32_t q_s, uint32_t k_s,
                                        int slab) {
#pragma unroll
  for (int j = 0; j < Smem<D>::kBK / 2; ++j) s[j] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // column block kk / 4, 32 bytes per step
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = desc_sw128(q_s + (kk / 4) * Smem<D>::kQBlock + slab * 128 + col);
    const uint64_t db = desc_sw128(k_s + (kk / 4) * Smem<D>::kKVBlock + col);
    if constexpr (Smem<D>::kBK == 128)
      wgmma_ss_n128(s, da, db, 1);
    else
      wgmma_ss_n64(s, da, db, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// O += P V for one consumer warpgroup, V the stage's V blocks at v_s.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 64][32],
                                        const uint32_t (&p)[Smem<D>::kBK / 16][4], uint32_t v_s) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) fence_regs(o[cb]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < Smem<D>::kBK / 16; ++j) {  // 16 keys: two 8-row groups of V
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      wgmma_rs_n64(o[cb], p[j], desc_sw128(v_s + cb * Smem<D>::kKVBlock + j * 16 * 128), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) fence_regs(o[cb]);
}

// Zero the Q rows [spare0, slab + 64) of one consumer's slab (G not
// dividing 128), so stale shared memory cannot put NaN in a row.
template <int D>
__device__ __forceinline__ void zero_spare_rows(unsigned char* q_smem, int slab, int spare0,
                                                int t) {
  const int n_spare = slab + 64 - spare0;
  if (n_spare <= 0) return;
  for (int idx = t; idx < Smem<D>::kBlocks * n_spare * 8; idx += 128) {
    const int cb = idx / (n_spare * 8), r = spare0 + (idx / 8) % n_spare, ch = idx % 8;
    *reinterpret_cast<uint4*>(q_smem + cb * Smem<D>::kQBlock + r * 128 + ch * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
}

// Row sums over the quad, normalise, store the rows of one consumer's
// accumulator: row r goes to ob + (r / G) * tok_stride + (r % G) * D.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* ob, const float (&o)[D / 64][32], float l0,
                                           float l1, int r0, int r1, int rows, int G,
                                           int64_t tok_stride, int quad) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= rows) continue;
    const float inv = half ? inv1 : inv0;
    T* orow = ob + static_cast<int64_t>(r / G) * tok_stride + (r % G) * D + quad * 2;
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(orow + cb * 64 + n * 8, o[cb][4 * n + 2 * half] * inv,
               o[cb][4 * n + 2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// Codes the entry points return beside cudaError_t values.
constexpr int kErrNoEncoder = -1;  // cuTensorMapEncodeTiled not found in the driver
constexpr int kErrTensorMap = -2;  // the driver refused a tensor map
constexpr int kErrSmem = -3;       // the block's shared memory exceeds the card's opt-in limit

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's encoder, from the libcuda.so.1 that the CUDA runtime loaded
// (no link-time dependency on the driver library).
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 4-D map {n0, n1, n2, n3} over rows of n0 contiguous elements (strides
// in bytes of dims 1..3), read in boxes of {box0, box1, box2, 1}, zeros
// outside. Returns 0, kErrNoEncoder or kErrTensorMap.
inline int encode_4d(CUtensorMap* map, CUtensorMapDataType type, CUtensorMapSwizzle swizzle,
                     const void* ptr, int n0, int64_t n1, int64_t n2, int64_t n3,
                     int64_t stride1, int64_t stride2, int64_t stride3, int box0, int box1,
                     int box2) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(n0), static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2), static_cast<cuuint64_t>(n3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride1),
                                 static_cast<cuuint64_t>(stride2),
                                 static_cast<cuuint64_t>(stride3)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1),
                             static_cast<cuuint32_t>(box2), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// A bf16 4-D map read in boxes of {64, box1, box2, 1}, 128-byte swizzled
// (the layout wgmma reads).
inline int encode_bf16_4d(CUtensorMap* map, const void* ptr, int D, int64_t n1, int64_t n2,
                          int64_t n3, int64_t stride1, int64_t stride2, int64_t stride3,
                          int box1, int box2) {
  return encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B, ptr, D,
                   n1, n2, n3, stride1, stride2, stride3, 64, box1, box2);
}

// An int8 4-D map read in whole rows, boxes of {D, box1, box2, 1} (D <=
// 256 bytes), unswizzled: rows land D bytes apart for the threads that
// convert them.
inline int encode_int8_4d(CUtensorMap* map, const void* ptr, int D, int64_t n1, int64_t n2,
                          int64_t n3, int64_t stride1, int64_t stride2, int64_t stride3,
                          int box1, int box2) {
  return encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_NONE, ptr, D, n1,
                   n2, n3, stride1, stride2, stride3, D, box1, box2);
}

// Dynamic shared memory a block of the current device may opt into.
inline int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

}  // namespace hopper
}  // namespace gridllm
