// Pipelined event-compacted spike matmul: out = s @ w over the occupied
// (m-tile, k-tile) steps of a CSR-of-tiles work list, with s as f32
// spikes or as uint32 words, fed by a cp.async ring.
//
// Replaces: src/repro/kernels/spike_matmul.py::_spike_matmul_csr_pipe_kernel
//           (spike_matmul_csr_pallas, pipeline=True) and, on words,
//           ::_spike_matmul_packed_csr_pipe_kernel
//           (spike_matmul_packed_csr_pallas, pipeline=True), with their
//           weight prefetch `_weight_prefetch`.
// Bound on the H100: operations at the main path's densities. An occupied
//           128x128 step costs 2*128*128*N flops for 64 KB of f32 spikes
//           (2 KB of words), above the fp32 ridge (67 TFLOP/s over
//           3.35 TB/s, ~20 flops a byte) for every N the models use
//           (96..1536).
// Design:   grid (m-tile row, n-tile), 256 threads, dynamic shared memory
//           (opted in past 48 KB). Each block walks its row's occupied
//           steps through csrc/tile_mma.cuh's ring: kStages stages of one
//           32-deep k-slice each, the spike slice (f32, or one word a row)
//           and the weight slice arriving by cp.async kStages-1 slices
//           ahead of compute, across step boundaries, so no thread stalls
//           on its own loads as kernel 11's synchronous staging does.
//           Steps with occ == 0 (dummy steps of empty rows) issue no copy;
//           an empty row writes zeros; padding steps past row_ptr[MT] are
//           never reached. The n-tile width BN (128, 96, 64 or 32) is
//           picked from N (`tile_mma::pick_bn`), so stage 1's N = 96 runs
//           one 96-wide tile and fc2's grid fills the SMs. Each output is
//           an fmaf chain in k order, kernel 11's arithmetic: the result
//           equals kernel 11's (and cuBLAS fp32's) bit for bit
//           (tile_mma.cuh says why not tensor cores).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using namespace tile_mma;

template <int BN, class A>
__global__ void __launch_bounds__(kThreads, 2)
csr_pipe_kernel(A a, const float* __restrict__ w, float* __restrict__ out,
                const int* __restrict__ row_ptr,
                const int* __restrict__ tile_k_idx,
                const int* __restrict__ occ, int64_t m, int64_t k, int64_t n,
                bool vec_w) {
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr int kStage = A::kStageBytes + WeightSlice<BN>::kStageBytes;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  float acc[kRM][BN / kT];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < BN / kT; ++j) acc[i][j] = 0.0f;

  RowCursor<OneGate> cur(OneGate{occ}, tile_k_idx, row_ptr[blockIdx.x],
                         row_ptr[blockIdx.x + 1], k);
  auto issue = [&](int slot) {
    unsigned char* stage = ring + slot * kStage;
    a.issue(stage, m0, cur.k0());
    WeightSlice<BN>::issue(stage + A::kStageBytes, w, cur.k0(), n0, k, n,
                           vec_w);
    commit();
    cur.next();
  };
  int issued = 0;
  for (; issued < kStages - 1 && cur.valid(); ++issued) issue(issued);
  for (int done = 0; done < issued; ++done) {
    wait_pending(issued - done - 1);     // slice `done` has landed
    __syncthreads();                     // ... for every thread; and every
                                         // thread is past slice done-1
    if (cur.valid()) issue(issued++ % kStages);   // into done-1's slot
    const unsigned char* stage = ring + (done % kStages) * kStage;
    fma_slice<BN>(a, stage, stage + A::kStageBytes, acc);
  }
  store_acc<BN>(out, m0, n0, m, n, acc);
}

template <int BN, class A>
int launch_bn(A a, const float* w, float* out, const int* row_ptr,
              const int* tile_k_idx, const int* occ, int64_t m, int64_t k,
              int64_t n, int64_t mt, cudaStream_t stream) {
  constexpr int kBytes =
      kStages * (A::kStageBytes + WeightSlice<BN>::kStageBytes);
  auto kernel = csr_pipe_kernel<BN, A>;
  cudaError_t err = tile_fma::allow_dynamic_smem(kernel, kBytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec_w = n % 4 == 0 && (uintptr_t)w % 16 == 0;
  dim3 grid((unsigned)mt, (unsigned)((n + BN - 1) / BN));
  kernel<<<grid, kThreads, kBytes, stream>>>(a, w, out, row_ptr, tile_k_idx,
                                             occ, m, k, n, vec_w);
  return (int)cudaGetLastError();
}

template <class A>
int launch(A a, const float* w, float* out, const int* row_ptr,
           const int* tile_k_idx, const int* occ, int64_t m, int64_t k,
           int64_t n, int64_t mt, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_bn(n, mt)) {
    case 128:
      return launch_bn<128>(a, w, out, row_ptr, tile_k_idx, occ, m, k, n, mt,
                            st);
    case 96:
      return launch_bn<96>(a, w, out, row_ptr, tile_k_idx, occ, m, k, n, mt,
                           st);
    case 64:
      return launch_bn<64>(a, w, out, row_ptr, tile_k_idx, occ, m, k, n, mt,
                           st);
    default:
      return launch_bn<32>(a, w, out, row_ptr, tile_k_idx, occ, m, k, n, mt,
                           st);
  }
}

}  // namespace

// s: (M, K) f32, w: (K, N) f32, out: (M, N) f32; row_ptr: (MT+1,),
// tile_k_idx / occ: (cap,) int32 with MT = ceil(M/128).
extern "C" int spike_matmul_csr_pipe_forward(
    const float* s, const float* w, float* out, const int* row_ptr,
    const int* tile_k_idx, const int* occ, int64_t m, int64_t k, int64_t n,
    int64_t mt, void* stream) {
  const bool vec = k % 4 == 0 && (uintptr_t)s % 16 == 0;
  return launch(DenseSpikes<>{s, m, k, vec}, w, out, row_ptr, tile_k_idx,
                occ, m, k, n, mt, stream);
}

// p: (M, KW) uint32 words covering K <= 32*KW columns (bits past K zero),
// w: (K, N) f32, out: (M, N) f32; the work list as above, on the 128 x 128
// grid of the unpacked (M, K) matrix.
extern "C" int spike_matmul_packed_csr_pipe_forward(
    const uint32_t* p, const float* w, float* out, const int* row_ptr,
    const int* tile_k_idx, const int* occ, int64_t m, int64_t kw, int64_t k,
    int64_t n, int64_t mt, void* stream) {
  return launch(PackedSpikes<>{p, m, kw}, w, out, row_ptr, tile_k_idx, occ,
                m, k, n, mt, stream);
}
