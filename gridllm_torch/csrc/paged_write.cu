// In-place KV page-pool writes: paged_write_decode and paged_write_chunk.
//
// Replace gridllm_tpu/ops/pallas_kernels.py:1404 `paged_write_decode`
// (body `_write_decode_all_kernel`, :1361) and :1497 `paged_write_chunk`
// (body `_write_chunk_all_kernel`, :1466). Both move bytes only, so they
// are dtype-agnostic: a pool row is KVH*D values = row_bytes bytes.
//
// What bounds them on the H100: device-memory bytes — each written row is
// read once from the fresh K/V and written once into the pool, zero flops.
// At llama3:8b widths a decode step writes 32 layers x S slots x 2 KB per
// K and V, a few hundred KB: small enough that launch latency, not
// bandwidth, sets the time. The design keeps it to ONE launch per step for
// all layers and slots (and one per prefill chunk), with 16-byte vector
// copies so a warp moves 512 contiguous bytes per instruction.
//
// - paged_write_decode: grid (L, N) over N = S * T rows, T rows per slot
//   (T = 1 for a decode step, K+1 for a speculative verify step's
//   flattened candidates). Block (l, r) belongs to slot s = r / T, looks up
//   its own page in page_table[s] at positions[r] and copies k_new[l, r]
//   and v_new[l, r] into pool[l, page, positions[r] % ps]. An inactive
//   slot, a position past the table's capacity and an unmapped (-1) page
//   skip the row: the rule of the plain version's `_safe_page_idx`,
//   applied here so a step is one launch with no index math before it.
// - paged_write_chunk: grid (L, T / ps). Block (l, c) copies chunk page c
//   (ps rows, the padded tail included) into pool[l, dst[c]]; dst[c] == P
//   skips a page past the valid length or unmapped. The wrapper computes
//   dst on the device exactly as the TPU wrapper does.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void copy16(char* dst, const char* src, int64_t bytes) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int64_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
}

__global__ void write_decode_kernel(char* __restrict__ k_pool, char* __restrict__ v_pool,
                                    const char* __restrict__ k_new,
                                    const char* __restrict__ v_new,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ positions,
                                    const bool* __restrict__ active, int num_pages,
                                    int page_size, int num_rows, int rows_per_slot,
                                    int max_pages, int64_t row_bytes) {
  const int l = blockIdx.x, r = blockIdx.y;
  const int s = r / rows_per_slot;
  const int pos = positions[r];
  if (!active[s] || pos < 0 || pos >= max_pages * page_size) return;
  const int page = page_table[static_cast<int64_t>(s) * max_pages + pos / page_size];
  if (page < 0 || page >= num_pages) return;
  const int off = pos % page_size;
  const int64_t dst = ((static_cast<int64_t>(l) * num_pages + page) * page_size + off) * row_bytes;
  const int64_t src = (static_cast<int64_t>(l) * num_rows + r) * row_bytes;
  copy16(k_pool + dst, k_new + src, row_bytes);
  copy16(v_pool + dst, v_new + src, row_bytes);
}

__global__ void write_chunk_kernel(char* __restrict__ k_pool, char* __restrict__ v_pool,
                                   const char* __restrict__ k_new,
                                   const char* __restrict__ v_new,
                                   const int* __restrict__ dst_pages, int num_pages,
                                   int page_size, int t_len, int64_t row_bytes) {
  const int l = blockIdx.x, c = blockIdx.y;
  const int page = dst_pages[c];
  if (page < 0 || page >= num_pages) return;
  const int64_t page_bytes = row_bytes * page_size;
  const int64_t dst = (static_cast<int64_t>(l) * num_pages + page) * page_bytes;
  const int64_t src = (static_cast<int64_t>(l) * t_len + static_cast<int64_t>(c) * page_size) * row_bytes;
  copy16(k_pool + dst, k_new + src, page_bytes);
  copy16(v_pool + dst, v_new + src, page_bytes);
}

}  // namespace

// Pools [L, P, ps, KVH, D]; k_new/v_new [L, N, KVH, D] with N = S * T;
// page_table [S, max_pages] int32; positions [N] int32; active [S] bool.
// row_bytes must be a multiple of 16. Returns cudaGetLastError().
extern "C" int gridllm_paged_write_decode(void* k_pool, void* v_pool, const void* k_new,
                                          const void* v_new, const void* page_table,
                                          const void* positions, const void* active, int L,
                                          int num_pages, int page_size, int N,
                                          int rows_per_slot, int max_pages,
                                          long long row_bytes, void* stream) {
  dim3 grid(L, N);
  write_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pool), static_cast<char*>(v_pool),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new),
      static_cast<const int*>(page_table), static_cast<const int*>(positions),
      static_cast<const bool*>(active), num_pages, page_size, N, rows_per_slot, max_pages,
      row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Pools [L, P, ps, KVH, D]; k_new/v_new [L, T, KVH, D] with T % ps == 0;
// dst_pages [T / ps] int32. Returns cudaGetLastError().
extern "C" int gridllm_paged_write_chunk(void* k_pool, void* v_pool, const void* k_new,
                                         const void* v_new, const void* dst_pages, int L,
                                         int num_pages, int page_size, int t_len,
                                         long long row_bytes, void* stream) {
  dim3 grid(L, t_len / page_size);
  write_chunk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pool), static_cast<char*>(v_pool),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new),
      static_cast<const int*>(dst_pages), num_pages, page_size, t_len, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Message of a cudaError_t returned by any entry point above.
extern "C" const char* gridllm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
