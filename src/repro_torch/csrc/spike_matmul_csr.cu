// Event-compacted spike matmul, serial form: out = s @ w over the
// occupied (m-tile, k-tile) steps of a CSR-of-tiles work list, with s as
// f32 spikes or as uint32 words, in fp32 FMA.
//
// Replaces: src/repro/kernels/spike_matmul.py::_spike_matmul_csr_kernel
//           (spike_matmul_csr_pallas, pipeline=False; :156) and, on words,
//           ::_spike_matmul_packed_csr_kernel (+ _unpack_tile;
//           spike_matmul_packed_csr_pallas, pipeline=False; :296). Their
//           pipelined twins (pipeline=True, :181 and :318) are
//           csrc/spike_matmul_csr_pipe.cu, which the registry picks on
//           the card; these kernels stay the `cuda` / `cuda-packed`
//           routes, reached by override and by a degrade.
// Bound on the H100: operations, at the main path's densities. An
//           occupied 128x128 tile costs 2*128*128*N flops against
//           128*128*4 bytes of spikes, ~N/2 flops per byte, above the
//           fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20) for every N the
//           model uses (96..1536). The work is fp32 FMA on the CUDA cores
//           (csrc/tile_mma.cuh says why the pipelined twins stay there
//           too).
// Design:   grid (m-tile row, n-tile); each block owns one 128x128 output
//           tile and walks its row's steps row_ptr[r]..row_ptr[r+1] in
//           order, the loop that replaces the TPU's sequential grid axis.
//           Steps with occ == 0 (dummy steps of empty rows) are skipped,
//           so an empty row writes zeros; padding steps past row_ptr[MT]
//           are never reached. Each occupied step runs the shared tile
//           loop (tile_fma.cuh): 256 threads, an 8x8 register block each,
//           ragged edges masked, slices staged synchronously (the
//           cp.async ring is csrc/tile_mma.cuh's). The map and work-list
//           tiling stays 128x128, the occupancy contract. The packed form
//           is the same kernel with
//           tile_fma.cuh's word loader: each occupied step stages the
//           (128 x 4)-word tile (2 KB, against the f32 tile's 64 KB) and
//           builds each 16-deep slice from 16 bits of one word, so the
//           spike read shrinks 32x while the FMAs, and on the same k
//           order their sums, stay kernel 11's.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_fma.cuh"

namespace {

using tile_fma::kTile;
using Tile = tile_fma::Shape<kTile, 8, 8>;   // 16 x 16 threads

// `a` is a loader of tile_fma.cuh; the packed one's word tile lives in
// this block's shared memory (`a.tile` is set here).
template <class A>
__global__ void __launch_bounds__(Tile::kThreads)
csr_matmul_kernel(A a, const float* __restrict__ w, float* __restrict__ out,
                  const int* __restrict__ row_ptr,
                  const int* __restrict__ tile_k_idx,
                  const int* __restrict__ occ, int64_t m, int64_t k,
                  int64_t n) {
  __shared__ tile_fma::Staging<kTile> st;
  __shared__ uint32_t words[kTile * tile_fma::kTileWords];
  (void)words;
  if constexpr (!std::is_same<A, tile_fma::DenseA>::value) a.tile = words;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * kTile;
  float acc[8][8];
  tile_fma::zero(acc);
  const int beg = row_ptr[blockIdx.x], end = row_ptr[blockIdx.x + 1];
  for (int step = beg; step < end; ++step) {
    if (occ[step] <= 0) continue;                // dummy step: no events
    tile_fma::accumulate_tile<kTile, 8, 8>(
        st, a, w, m0, n0, (int64_t)tile_k_idx[step] * kTile, k, n, acc);
  }
  tile_fma::store_tile<kTile, 8, 8>(out, m0, n0, m, n, acc);
}

template <class A>
int launch(A a, const float* w, float* out, const int* row_ptr,
           const int* tile_k_idx, const int* occ, int64_t m, int64_t k,
           int64_t n, int64_t mt, void* stream) {
  if (m > 0 && n > 0) {
    // m-tile rows on x (no 65535 limit); neighbouring blocks share the
    // n-tile's weight slices in L2.
    dim3 grid((unsigned)mt, (unsigned)((n + kTile - 1) / kTile));
    csr_matmul_kernel<A><<<grid, Tile::kThreads, 0, (cudaStream_t)stream>>>(
        a, w, out, row_ptr, tile_k_idx, occ, m, k, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// s: (M, K) f32, w: (K, N) f32, out: (M, N) f32; row_ptr: (MT+1,),
// tile_k_idx / occ: (cap,) int32 with MT = ceil(M/128).
extern "C" int spike_matmul_csr_forward(const float* s, const float* w,
                                        float* out, const int* row_ptr,
                                        const int* tile_k_idx,
                                        const int* occ, int64_t m, int64_t k,
                                        int64_t n, int64_t mt, void* stream) {
  return launch(tile_fma::DenseA{s, m, k}, w, out, row_ptr, tile_k_idx, occ,
                m, k, n, mt, stream);
}

// p: (M, KW) uint32 words covering K <= 32*KW columns (bits past K zero),
// w: (K, N) f32, out: (M, N) f32; the work list as above, on the 128 x 128
// grid of the unpacked (M, K) matrix.
extern "C" int spike_matmul_packed_csr_forward(
    const uint32_t* p, const float* w, float* out, const int* row_ptr,
    const int* tile_k_idx, const int* occ, int64_t m, int64_t kw, int64_t k,
    int64_t n, int64_t mt, void* stream) {
  return launch(tile_fma::PackedA<kTile>{p, m, kw, nullptr}, w, out,
                row_ptr, tile_k_idx, occ, m, k, n, mt, stream);
}
