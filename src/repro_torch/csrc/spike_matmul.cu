// Predicated spike matmul: out = s @ w on the dense (m-tile, n-tile) grid,
// each 128-deep k-tile's product gated by the occupancy map.
//
// Replaces: src/repro/kernels/spike_matmul.py::_spike_matmul_kernel
//           (spike_matmul_pallas): the matmul under the `tconv` op's
//           kernel form (SegNet's decoder), the CSR family's dense
//           fallback and hybrid routing's dense side.
// Bound on the H100: bytes for the decoder's narrow outputs. Each
//           occupied 128x128 s tile (64 KB) feeds 2*128*128*N flops,
//           N/2 flops per byte: at N = 16 and N = 2 that is far below the
//           fp32 ridge (~20), so reading s once is the floor. Wide N
//           (>= 64) turns it operation-bound like the CSR kernel. fp32
//           FMA on the CUDA cores, no TF32, for the 1e-5 parity contract.
// Design:   grid (m-tile row, n-tile); each block owns one 128-row x BN
//           output tile and walks k-tiles 0..KT-1 in order (the TPU's
//           sequential k grid axis), skipping a k-tile whose map count
//           occ[mt, kt] is 0 (the `pl.when` gate; the map stays 128x128,
//           the occupancy contract). An m-tile row with no occupied tile
//           still stores its zeros, as the TPU's _init/_flush do. The
//           n-tile width is a template parameter picked from N: BN = 128
//           (8x8 outputs per thread), 16 (4x2) or 4 (2x2), so N = 16 and
//           N = 2 do not spend 8x and 64x the needed FMAs on a 128-wide
//           tile. The tile loop is tile_fma.cuh's (masked ragged edges,
//           no padded operand copies). Staging is synchronous; float4
//           loads and a cp.async ring are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_fma.cuh"

namespace {

using tile_fma::kTile;

template <int BN, int RM, int RN>
__global__ void __launch_bounds__(tile_fma::Shape<BN, RM, RN>::kThreads)
pred_matmul_kernel(const float* __restrict__ s, const float* __restrict__ w,
                   float* __restrict__ out, const int* __restrict__ occ,
                   int64_t m, int64_t k, int64_t n, int64_t kt) {
  __shared__ tile_fma::Staging<BN> st;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  const int* row = occ + (int64_t)blockIdx.x * kt;
  tile_fma::DenseA a{s, m, k};
  float acc[RM][RN];
  tile_fma::zero(acc);
  for (int j = 0; j < (int)kt; ++j) {    // an int index: faster than int64
    if (row[j] <= 0) continue;                   // empty tile: gated off
    tile_fma::accumulate_tile<BN, RM, RN>(st, a, w, m0, n0,
                                          (int64_t)j * kTile, k, n, acc);
  }
  tile_fma::store_tile<BN, RM, RN>(out, m0, n0, m, n, acc);
}

template <int BN, int RM, int RN>
void launch(const float* s, const float* w, float* out, const int* occ,
            int64_t m, int64_t k, int64_t n, int64_t kt,
            cudaStream_t stream) {
  dim3 grid((unsigned)((m + kTile - 1) / kTile), (unsigned)((n + BN - 1) / BN));
  pred_matmul_kernel<BN, RM, RN>
      <<<grid, tile_fma::Shape<BN, RM, RN>::kThreads, 0, stream>>>(
          s, w, out, occ, m, k, n, kt);
}

}  // namespace

// s: (M, K) f32, w: (K, N) f32, out: (M, N) f32; occ: (MT, KT) int32 with
// MT = ceil(M/128), KT = ceil(K/128).
extern "C" int spike_matmul_pred_forward(const float* s, const float* w,
                                         float* out, const int* occ,
                                         int64_t m, int64_t k, int64_t n,
                                         int64_t kt, void* stream) {
  if (m > 0 && n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (n <= 4)
      launch<4, 2, 2>(s, w, out, occ, m, k, n, kt, st);      // 2 x 64 threads
    else if (n <= 16)
      launch<16, 4, 2>(s, w, out, occ, m, k, n, kt, st);     // 8 x 32
    else
      launch<kTile, 8, 8>(s, w, out, occ, m, k, n, kt, st);  // 16 x 16
  }
  return (int)cudaGetLastError();
}
