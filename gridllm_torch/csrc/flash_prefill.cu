// flash_prefill: causal GQA attention over one contiguous prompt bucket.
//
// Replaces gridllm_tpu/ops/pallas_kernels.py:129 `flash_prefill` (body
// `_flash_prefill_kernel`, :63). Same function: q [B, T, H, D] against
// k/v [B, T, KVH, D], keys at positions >= seq_lens[b] masked, causal, an
// optional sliding window and tanh softcap (applied before the mask),
// float32 online softmax, output acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: the work is 4*T*T*H*D/2 flops against
// (T*H*D + 2*T*KVH*D + T*H*D) * itemsize bytes, so at prompt buckets of
// 256 and up it is compute bound (about T/2 flops per byte at D=128, far
// above the card's ~295 flops/byte bf16 ridge). This version runs the dot
// products on the CUDA cores in float32 (see attention_common.cuh), so it
// sits well below the tensor-core bound; wgmma tiles are a later PR.
//
// Design: one block per (q tile, kv head, batch). The q tile stacks the G
// query heads of the kv head over BQ consecutive tokens (G*BQ <= 32 rows,
// the TPU kernel's row stacking), so each K/V tile read from device memory
// serves all G heads. Keys stream through shared memory only over the
// range a tile can see: below the causal bound min(last query + 1,
// seq_len) and, with a window, above the first query's window start.
#include "attention_common.cuh"

namespace gridllm {

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seq_lens,
                         T* __restrict__ out, int t_len, int H, int KVH, int bq,
                         float scale, float softcap, int window) {
  extern __shared__ float smem[];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int tok0 = qt * bq;
  const int ntok = min(bq, t_len - tok0);
  const int rows_total = ntok * G;
  const int seq_len = seq_lens[b];
  const int64_t tok_stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * t_len + tok0) * tok_stride +
                       static_cast<int64_t>(h) * G * D;
  const int64_t kvoff = static_cast<int64_t>(b) * t_len * KVH * D + static_cast<int64_t>(h) * D;
  const int k_hi = min(tok0 + ntok, seq_len);

  AttnBlock<T, D, RPW> blk(smem, softcap, window);
  for (int row0 = 0; row0 < rows_total; row0 += AttnBlock<T, D, RPW>::NR) {
    const int qfirst = tok0 + row0 / G;
    const int k_lo = window > 0 ? max(qfirst - window + 1, 0) : 0;
    blk.load_q(q + qoff, tok_stride, G, row0, rows_total, tok0, scale);
    blk.segment(k + kvoff, v + kvoff, ContigRows{static_cast<int64_t>(KVH) * D}, k_lo,
                k_hi, 0, seq_len);
    blk.store(out + qoff, tok_stride, G, row0, rows_total);
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const void* q, const void* k, const void* v, const void* seq_lens,
                   void* out, int B, int t_len, int H, int KVH, int bq, float scale,
                   float softcap, int window, cudaStream_t stream) {
  auto kernel = flash_prefill_kernel<T, D, RPW>;
  const int smem = smem_floats<D, RPW>() * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + bq - 1) / bq, KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), t_len, H, KVH, bq, scale,
      softcap, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rpw(int rpw, const void* q, const void* k, const void* v,
                   const void* seq_lens, void* out, int B, int t_len, int H, int KVH,
                   int bq, float scale, float softcap, int window, cudaStream_t s) {
  switch (rpw) {
    case 1: return launch<T, D, 1>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap, window, s);
    case 2: return launch<T, D, 2>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap, window, s);
    case 4: return launch<T, D, 4>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap, window, s);
    case 8: return launch<T, D, 8>(q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap, window, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int d, int rpw, const void* q, const void* k, const void* v,
                   const void* seq_lens, void* out, int B, int t_len, int H, int KVH,
                   int bq, float scale, float softcap, int window, cudaStream_t s) {
  switch (d) {
    case 64: return by_rpw<T, 64>(rpw, q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap, window, s);
    case 128: return by_rpw<T, 128>(rpw, q, k, v, seq_lens, out, B, t_len, H, KVH, bq, scale, softcap, window, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace gridllm

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int gridllm_flash_prefill(const void* q, const void* k, const void* v,
                                     const void* seq_lens, void* out, int dtype, int B,
                                     int t_len, int H, int KVH, int D, int bq, int rpw,
                                     float scale, float softcap, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = gridllm::by_dim<float>(D, rpw, q, k, v, seq_lens, out, B, t_len, H, KVH, bq,
                                 scale, softcap, window, s);
  else if (dtype == 1)
    err = gridllm::by_dim<__nv_bfloat16>(D, rpw, q, k, v, seq_lens, out, B, t_len, H,
                                         KVH, bq, scale, softcap, window, s);
  return static_cast<int>(err);
}
