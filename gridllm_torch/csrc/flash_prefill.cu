// flash_prefill: causal GQA attention over one prompt bucket, for both
// prefill kernels of the JAX package, on Hopper's tensor cores.
//
// Replaces gridllm_tpu/ops/pallas_kernels.py:129 `flash_prefill` (body
// `_flash_prefill_kernel`, :63; K/V resident in VMEM) and :268
// `flash_prefill_streamed` (body `_flash_prefill_stream_kernel`, :190; K/V
// streamed tile by tile). The two compute one function, and the TPU's split
// between them (what fits in VMEM) means nothing on this card, so both
// wrappers of ops/cuda_kernels.py launch this kernel: q [B, T, H, D]
// against k/v [B, T, KVH, D], keys at positions >= seq_lens[b] masked,
// causal, an optional sliding window and tanh softcap (applied before the
// mask), float32 online softmax, output acc / max(l, 1e-30) in q's dtype.
// Rows at positions >= seq_lens[b] are padding, unspecified by the
// contract: a query tile wholly past the valid length writes zeros and does
// no work.
//
// What bounds it on the H100: operations. A bucket of T tokens costs
// 4*T*T*H*D/2 flops against (2*T*H*D + 2*T*KVH*D) * itemsize bytes; at
// T = 32768 that is 8.8 TFLOP (8.9 ms at 989 TFLOP/s) against 0.6 GB
// (0.2 ms at 3.35 TB/s). Only wgmma reaches the card's tensor rate.
//
// The tile plan (which query tokens and heads a block holds, which K/V
// tiles it loads, which of them need the per-element mask, which tiles
// write zeros, the issue order) is `prefill_tile_plan` in
// ops/cuda_kernels.py, the same index math in Python, tested on the CPU
// (tests/test_torch_prefill_plan.py).
//
// bf16 (the serving dtype), `prefill_wgmma_kernel`:
// - One block per (query tile, kv head, batch), three warpgroups: one
//   producer, whose single thread issues TMA loads (setmaxnreg lowers its
//   registers), and two consumer warpgroups (setmaxnreg raises theirs). The
//   query tile stacks the G query heads of the kv head over bq = 128 / G
//   tokens, row r = token tok0 + r / G, head h * G + r % G: each consumer
//   owns one m64 row slab, and every K/V tile in shared memory serves 128
//   rows. When G does not divide 128 (qwen2.5: G = 7, 126 rows) the spare
//   rows are zeroed once, so stale shared memory cannot put NaN in a row.
// - TMA loads Q once and K/V tiles of kBK keys (128; 64 at D = 256, see
//   hopper_common.cuh) through a ring of stages, each with a full and an
//   empty mbarrier, in the 128-byte swizzle that wgmma descriptors read. A
//   swizzled row is at most 128 bytes, so a D = 128 row is two 64-column
//   blocks, a D = 256 row four. The tensor maps are encoded on the
//   host at each launch and passed as __grid_constant__ parameters; keys
//   and queries past T are zero-filled by TMA.
// - S = Q K^T: wgmma m64n128k16 (m64n64k16 at D = 256) with both operands
//   in shared memory.
//   Softmax in registers with exp2f on logits prescaled by scale*log2(e);
//   P rounded to bf16 in registers is wgmma's register A operand for
//   O += P V (m64n64k16 per 64-column block, V as an MN-major B).
// - Masks only where needed: a K/V tile runs the per-element compare only
//   if it crosses the diagonal, the length edge or the window edge for some
//   row of the query tile; tiles outside the window or past min(last query
//   + 1, seq_len) are never loaded. Softcap is a template flag.
// - Query tiles are issued heaviest first (the last tokens see the most
//   keys), and the blocks in flight at once share one kv head, whose K/V
//   (16 MB at T = 32768) stay in the 50 MB L2.
//
// float32 (the parity checks only), `prefill_split_kernel`: mma.sync
// m16n8k16 on bf16 operands, each float32 operand split into bf16 hi + lo
// and each product hi*hi + hi*lo + lo*hi (about 16 mantissa bits, far
// inside the 1e-3 float32 tolerance; tf32 would give 10), K/V through a
// cp.async double buffer of kSplitBK keys (64; 16 at D = 256, where the
// 128 padded query rows take 135 KB of float32), 8 warps of 16 rows over
// the same 128-row query tile.
//
// Offsets into q, k, v and out are 64-bit.
#include "hopper_common.cuh"

namespace gridllm {
namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (the helpers of hopper_common.cuh)
// ---------------------------------------------------------------------------

template <int D, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1)
    prefill_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out,
                         int t_len, int H, int KVH, int bq, float scale, float softcap,
                         int window) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, kv_s = base + L::kQBytes;
  const uint32_t bar_q = base + L::kBarOff;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + L::kStages + s); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int tok0 = qt * bq;
  const int ntok = min(bq, t_len - tok0);
  const int rows = ntok * G;
  const int seq_len = seq_lens[b];
  const int64_t tok_stride = static_cast<int64_t>(H) * D;
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * t_len + tok0) * tok_stride +
                      static_cast<int64_t>(h) * G * D;
  if (tok0 >= seq_len) {  // padding rows only
    write_zeros<__nv_bfloat16, D>(ob, rows, G, tok_stride, kWgThreads);
    return;
  }
  // keys this tile can see: [k_lo, k_hi), in tiles from k_lo's tile up
  const int tok_last = tok0 + ntok - 1;
  const int k_hi = min(tok_last + 1, seq_len);
  const int k_lo = window > 0 ? max(tok0 - window + 1, 0) : 0;
  const int kt_first = k_lo / kBK * kBK;
  const int n_tiles = (k_hi - kt_first + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring of K/V stages filled
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kBlocks * 128 * G * bq);
      for (int cb = 0; cb < L::kBlocks; ++cb)
        tma_load(q_s + cb * L::kQBlock, &q_map, bar_q, cb * 64, h * G, tok0, b);
      int stage = 0, phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int kt0 = kt_first + i * kBK;
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), L::kStageBytes);
        const uint32_t st = kv_s + stage * L::kStageBytes;
        for (int cb = 0; cb < L::kBlocks; ++cb) {
          tma_load(st + cb * L::kKVBlock, &k_map, full(stage), cb * 64, h, kt0, b);
          tma_load(st + (L::kBlocks + cb) * L::kKVBlock, &v_map, full(stage), cb * 64, h, kt0, b);
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
    zero_spare_rows<D>(smem, slab, max(G * bq, slab), t);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    const int qp0 = r0 < rows ? tok0 + r0 / G : -1;
    const int qp1 = r1 < rows ? tok0 + r1 / G : -1;
    const bool live = slab < rows;
    const int w_first = tok0 + slab / G;  // this warpgroup's tokens
    const int w_last = tok0 + min(slab + 63, rows - 1) / G;
    float o[L::kBlocks][32];
#pragma unroll
    for (int cb = 0; cb < L::kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
    }
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(bar_q, 0);
    int stage = 0, phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int kt0 = kt_first + i * kBK;
      mbar_wait(full(stage), phase);
      const bool skip = !live || kt0 > w_last ||
                        (window > 0 && kt0 + kBK - 1 < w_first - window + 1);
      if (!skip) {
        const uint32_t st = kv_s + stage * L::kStageBytes;
        float s[kBK / 2];
        qk_tile<D>(s, q_s, st, slab);
        // the tile plan: the per-element mask only where a row of the
        // query tile misses a key of this tile (diagonal, length, window)
        const bool masked = kt0 + kBK - 1 > tok0 || kt0 + kBK > seq_len ||
                            (window > 0 && tok_last - kt0 >= window);
        uint32_t p[kBK / 16][4];
        if (masked)
          softmax_tile<true, kCap>(s, p, o, m0, m1, l0, l1, scale, softcap, kt0, quad, qp0, qp1,
                                   seq_len, window);
        else
          softmax_tile<false, kCap>(s, p, o, m0, m1, l0, l1, scale, softcap, kt0, quad, qp0,
                                    qp1, seq_len, window);
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

// ---------------------------------------------------------------------------
// float32: mma.sync on split bf16 operands
// ---------------------------------------------------------------------------

constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = kSplitWarps * 32;
// keys per tile: at D = 256 the query tile and two stages of 64 keys would
// take 405,504 bytes; of 16 keys, 202,752
template <int D>
__host__ __device__ constexpr int split_bk() { return D == 256 ? 16 : 64; }

// Shared-memory row stride in elements: 8 elements of padding make the
// fragment loads below conflict-free.
template <int D>
__host__ __device__ constexpr int split_ld() { return D + 8; }

template <int D>
constexpr int split_smem_bytes() {
  return (kRows + 4 * split_bk<D>()) * split_ld<D>() * static_cast<int>(sizeof(float));
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

// A pair of float32 values as a bf16x2 mma operand register (hi) and the
// rounding remainder (lo), so that hi + lo carries ~16 bits.
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

// Two adjacent elements p[0], p[1]; two elements one row apart p[0], p[stride].
__device__ __forceinline__ Pair load_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return split2(v.x, v.y);
}
__device__ __forceinline__ Pair load_col_pair(const float* p, int stride) {
  return split2(p[0], p[stride]);
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

// c += A * B as hi*hi + hi*lo + lo*hi.
__device__ __forceinline__ void mma_split(float (&c)[4], const Pair (&a)[4], const Pair (&b)[2]) {
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
}

template <int D>
__global__ void __launch_bounds__(kSplitThreads)
    prefill_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seq_lens,
                         float* __restrict__ out, int t_len, int H, int KVH, int bq,
                         float scale, float softcap, int window) {
  constexpr int LD = split_ld<D>();
  constexpr int CH = D / 4;  // 16-byte copies per row
  constexpr int kSplitBK = split_bk<D>();
  extern __shared__ __align__(16) unsigned char smem_split[];
  float* qs = reinterpret_cast<float*>(smem_split);  // [kRows][LD]
  float* ks = qs + kRows * LD;                       // [2][kSplitBK][LD]
  float* vs = ks + 2 * kSplitBK * LD;                // [2][kSplitBK][LD]

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
  const float* kb = k + static_cast<int64_t>(b) * t_len * kv_stride + static_cast<int64_t>(h) * D;
  const float* vb = v + static_cast<int64_t>(b) * t_len * kv_stride + static_cast<int64_t>(h) * D;

  if (tok0 >= seq_len) {  // padding rows only
    write_zeros<float, D>(out + qoff, rows, G, tok_stride, kSplitThreads);
    return;
  }
  const int k_hi = min(tok0 + ntok, seq_len);
  const int k_lo = window > 0 ? max(tok0 - window + 1, 0) : 0;
  const int kt_first = (k_lo / kSplitBK) * kSplitBK;
  const int n_tiles = (k_hi - kt_first + kSplitBK - 1) / kSplitBK;

  auto load_kv = [&](int stage, int kt0) {
    float* kd = ks + stage * kSplitBK * LD;
    float* vd = vs + stage * kSplitBK * LD;
    for (int idx = threadIdx.x; idx < kSplitBK * CH; idx += kSplitThreads) {
      const int r = idx / CH, c = (idx % CH) * 4;
      const int key = kt0 + r;
      const bool ok = key < k_hi;
      const int64_t src = static_cast<int64_t>(ok ? key : 0) * kv_stride + c;
      cp_async16(kd + r * LD + c, kb + src, ok);
      cp_async16(vd + r * LD + c, vb + src, ok);
    }
  };

  // query rows (zeros past the tile) and the first K/V tile: one group
  for (int idx = threadIdx.x; idx < kRows * CH; idx += kSplitThreads) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool ok = r < rows;
    const int64_t src = ok ? static_cast<int64_t>(r / G) * tok_stride + (r % G) * D + c : 0;
    cp_async16(qs + r * LD + c, q + qoff + src, ok);
  }
  load_kv(0, kt_first);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tid = lane % 4;
  const int wr0 = warp * 16;  // first row of this warp
  const bool warp_live = wr0 < rows;
  const int ra = wr0 + g, rb = wr0 + g + 8;  // the lane's two rows
  const int qpos_a = ra < rows ? tok0 + ra / G : -1;
  const int qpos_b = rb < rows ? tok0 + rb / G : -1;
  const int w_first = tok0 + wr0 / G;  // the warp's token range
  const int w_last = tok0 + (min(wr0 + 15, rows - 1)) / G;

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int kt0 = kt_first + i * kSplitBK;
    if (i + 1 < n_tiles) {
      load_kv((i + 1) & 1, kt0 + kSplitBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool skip = !warp_live || kt0 > w_last ||
                      (window > 0 && kt0 + kSplitBK - 1 < w_first - window + 1);
    if (!skip) {
      const float* kt = ks + (i & 1) * kSplitBK * LD;
      const float* vt = vs + (i & 1) * kSplitBK * LD;
      // S = Q K^T for the warp's 16 rows x 64 keys
      float s[kSplitBK / 8][4];
#pragma unroll
      for (int n = 0; n < kSplitBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const float* qa = qs + ra * LD + kk * 16 + tid * 2;
        const float* qb = qs + rb * LD + kk * 16 + tid * 2;
        const Pair a[4] = {load_pair(qa), load_pair(qb), load_pair(qa + 8), load_pair(qb + 8)};
#pragma unroll
        for (int n = 0; n < kSplitBK / 8; ++n) {
          const float* kr = kt + (n * 8 + g) * LD + kk * 16 + tid * 2;
          const Pair bb[2] = {load_pair(kr), load_pair(kr + 8)};
          mma_split(s[n], a, bb);
        }
      }
      // scale, softcap, mask; online softmax over the tile
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int n = 0; n < kSplitBK / 8; ++n) {
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
      for (int n = 0; n < kSplitBK / 8; ++n) {
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
      for (int j = 0; j < kSplitBK / 16; ++j) {
        const Pair a[4] = {split2(s[2 * j][0], s[2 * j][1]), split2(s[2 * j][2], s[2 * j][3]),
                           split2(s[2 * j + 1][0], s[2 * j + 1][1]),
                           split2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float* vr = vt + (j * 16 + tid * 2) * LD + n * 8 + g;
          const Pair bb[2] = {load_col_pair(vr, LD), load_col_pair(vr + 8 * LD, LD)};
          mma_split(o[n], a, bb);
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
  float* oa = out + qoff + static_cast<int64_t>(ra / G) * tok_stride + (ra % G) * D + tid * 2;
  float* obp = out + qoff + static_cast<int64_t>(rb / G) * tok_stride + (rb % G) * D + tid * 2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qpos_a >= 0) store2(oa + n * 8, o[n][0] * inv_a, o[n][1] * inv_a);
    if (qpos_b >= 0) store2(obp + n * 8, o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------

// A contiguous bf16 [B, T, heads, D] as a 4-D map {D, heads, T, B} read in
// boxes of {64, box_heads, box_t, 1}, 128-byte swizzled, zeros outside.
int encode(CUtensorMap* map, const void* ptr, int B, int t_len, int heads, int D, int box_heads,
           int box_t) {
  const int64_t row = static_cast<int64_t>(D) * 2;
  return encode_bf16_4d(map, ptr, D, heads, t_len, B, row, row * heads, row * heads * t_len,
                        box_heads, box_t);
}

template <int D, bool kCap>
int launch_wgmma(const void* q, const void* k, const void* v, const void* seq_lens, void* out,
                 int B, int t_len, int H, int KVH, int bq, float scale, float softcap,
                 int window, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = encode(&qm, q, B, t_len, H, D, H / KVH, bq);
  if (err == 0) err = encode(&km, k, B, t_len, KVH, D, 1, Smem<D>::kBK);
  if (err == 0) err = encode(&vm, v, B, t_len, KVH, D, 1, Smem<D>::kBK);
  if (err != 0) return err;
  auto kernel = prefill_wgmma_kernel<D, kCap>;
  constexpr int smem = Smem<D>::kBytes;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((t_len + bq - 1) / bq, KVH, B);
  kernel<<<grid, kWgThreads, smem, stream>>>(qm, km, vm, static_cast<const int*>(seq_lens),
                                             static_cast<__nv_bfloat16*>(out), t_len, H, KVH,
                                             bq, scale, softcap, window);
  return cudaGetLastError();
}

template <int D>
int launch_split(const void* q, const void* k, const void* v, const void* seq_lens, void* out,
                 int B, int t_len, int H, int KVH, int bq, float scale, float softcap,
                 int window, cudaStream_t stream) {
  auto kernel = prefill_split_kernel<D>;
  constexpr int smem = split_smem_bytes<D>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((t_len + bq - 1) / bq, KVH, B);
  kernel<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seq_lens), static_cast<float*>(out), t_len, H, KVH, bq, scale,
      softcap, window);
  return cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* seq_lens,
           void* out, int B, int t_len, int H, int KVH, int bq, float scale, float softcap,
           int window, cudaStream_t s) {
  if (dtype == 0)
    return launch_split<D>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap,
                           window, s);
  if (softcap > 0.f)
    return launch_wgmma<D, true>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap,
                                 window, s);
  return launch_wgmma<D, false>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap,
                                window, s);
}

}  // namespace
}  // namespace gridllm

// dtype: 0 = float32, 1 = bfloat16; bq * (H / KVH) <= 128 query rows per
// block. Returns cudaGetLastError() of the launch, or -1 when the driver
// has no cuTensorMapEncodeTiled, -2 when it refuses a tensor map.
extern "C" int gridllm_flash_prefill(const void* q, const void* k, const void* v,
                                     const void* seq_lens, void* out, int dtype, int B, int t_len,
                                     int H, int KVH, int D, int bq, float scale, float softcap,
                                     int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bq < 1 || H % KVH || bq * (H / KVH) > gridllm::hopper::kRows || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return gridllm::launch<64>(dtype, q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale,
                                 softcap, window, s);
    case 128:
      return gridllm::launch<128>(dtype, q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale,
                                  softcap, window, s);
    case 256:
      return gridllm::launch<256>(dtype, q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale,
                                  softcap, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
