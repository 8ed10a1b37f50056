// Event-compacted spike matmul: out = s @ w over the occupied
// (m-tile, k-tile) steps of a CSR-of-tiles work list.
//
// Replaces: src/repro/kernels/spike_matmul.py::_spike_matmul_csr_kernel
//           and ::_spike_matmul_csr_pipe_kernel (spike_matmul_csr_pallas,
//           pipeline=False/True; both compute the same function).
// Bound on the H100: operations, at the main path's densities. An
//           occupied 128x128 tile costs 2*128*128*N flops against
//           128*128*4 bytes of spikes, ~N/2 flops per byte, above the
//           fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20) for every N the
//           model uses (96..1536). The work is fp32 FMA on the CUDA cores:
//           tensor cores would need TF32 (or a 3-pass split) to hold the
//           1e-5 parity contract, which is later work.
// Design:   grid (m-tile row, n-tile); each block owns one 128x128 output
//           tile and walks its row's steps row_ptr[r]..row_ptr[r+1] in
//           order, the loop that replaces the TPU's sequential grid axis.
//           Steps with occ == 0 (dummy steps of empty rows) are skipped,
//           so an empty row writes zeros; padding steps past row_ptr[MT]
//           are never reached. Each occupied step streams its s tile and
//           w tile through shared memory in 16-deep slices; 256 threads
//           each accumulate an 8x8 register block with fmaf. Ragged edges
//           (M, K or N not multiples of 128) are masked on load and store,
//           so the caller never materialises a padded copy.
//           The map and work-list tiling stays 128x128, the occupancy
//           contract; a cp.async/TMA multi-stage ring is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;          // map tile (rows and k) and CTA n-tile
constexpr int kSlice = 16;          // k depth staged per shared-memory pass
constexpr int kThreads = 256;       // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPadA = 4;            // breaks bank conflicts on the A stores

__global__ void __launch_bounds__(kThreads)
csr_matmul_kernel(const float* __restrict__ s, const float* __restrict__ w,
                  float* __restrict__ out, const int* __restrict__ row_ptr,
                  const int* __restrict__ tile_k_idx,
                  const int* __restrict__ occ, int64_t m, int64_t k,
                  int64_t n) {
  __shared__ float a_s[kSlice][kTile + kPadA];   // s slice, k-major
  __shared__ float b_s[kSlice][kTile];           // w slice
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * kTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int beg = row_ptr[blockIdx.x], end = row_ptr[blockIdx.x + 1];
  for (int step = beg; step < end; ++step) {
    if (occ[step] <= 0) continue;                // dummy step: no events
    const int64_t k0 = (int64_t)tile_k_idx[step] * kTile;
    for (int kk = 0; kk < kTile; kk += kSlice) {
#pragma unroll
      for (int l = 0; l < kTile * kSlice / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int r = e / kSlice, c = e % kSlice;
        const int64_t gr = m0 + r, gc = k0 + kk + c;
        a_s[c][r] = (gr < m && gc < k) ? s[gr * k + gc] : 0.0f;
      }
#pragma unroll
      for (int l = 0; l < kTile * kSlice / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int r = e / kTile, c = e % kTile;
        const int64_t gk = k0 + kk + r, gn = n0 + c;
        b_s[r][c] = (gk < k && gn < n) ? w[gk * n + gn] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kSlice; ++c) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = a_s[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = b_s[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t c = n0 + tx + 16 * j;
      if (c < n) out[r * n + c] = acc[i][j];
    }
  }
}

}  // namespace

// s: (M, K) f32, w: (K, N) f32, out: (M, N) f32; row_ptr: (MT+1,),
// tile_k_idx / occ: (cap,) int32 with MT = ceil(M/128).
extern "C" int spike_matmul_csr_forward(const float* s, const float* w,
                                        float* out, const int* row_ptr,
                                        const int* tile_k_idx,
                                        const int* occ, int64_t m, int64_t k,
                                        int64_t n, int64_t mt, void* stream) {
  if (m > 0 && n > 0) {
    // m-tile rows on x (no 65535 limit); neighbouring blocks share the
    // n-tile's weight slices in L2.
    dim3 grid((unsigned)mt, (unsigned)((n + kTile - 1) / kTile));
    csr_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        s, w, out, row_ptr, tile_k_idx, occ, m, k, n);
  }
  return (int)cudaGetLastError();
}
