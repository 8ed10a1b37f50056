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
//           never reached. Each output is an fmaf chain in k order, kernel
//           11's arithmetic: the result equals kernel 11's (and cuBLAS
//           fp32's) bit for bit (tile_mma.cuh says why not tensor cores).
//           f32 spikes (`csr_pipe_kernel`): kernel 11's thread layout and
//           `fma_slice`, the n-tile width BN (128, 96, 64 or 32) picked
//           from N (`tile_mma::pick_bn`).
//           Words (`csr_pipe_word_kernel`): a compute of their own,
//           `tile_mma::add_word_slice`. A thread holds few rows and many
//           columns in runs of 4 (`WordTile`: 8 x 8 at BN = 128, 4 x 12 at
//           96, 4 x 8 at 64, 2 x 8 at 32), reads weight rows as LDS.128
//           and tests each row's word bit once for all its columns; a set
//           bit adds the weight row with predicated fadds (fadd(acc, w) =
//           fmaf(1, w, acc), and fmaf(0, w, acc) = acc: the same chain).
//           Its BN is picked for whole waves of two blocks an SM
//           (`tile_mma::pick_bn_waves`): fc2's 64 m-tiles x N = 384 run
//           BN = 96 in 256 blocks, one wave on 132 SMs, where `pick_bn`'s
//           64 left 1.45. `spike_matmul_packed_csr_pipe_launch` reports
//           the launch it makes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace {

using namespace tile_mma;

// Blocks an SM of the word kernel: its __launch_bounds__ and the waves
// its n-tile width is picked for.
constexpr int kWordBlocksPerSM = 2;

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

template <int BN>
__global__ void __launch_bounds__(kThreads, kWordBlocksPerSM)
csr_pipe_word_kernel(PackedSpikes<> a, const float* __restrict__ w,
                     float* __restrict__ out,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ tile_k_idx,
                     const int* __restrict__ occ, int64_t m, int64_t k,
                     int64_t n, bool vec_w) {
  extern __shared__ __align__(16) unsigned char ring[];
  using T = WordTile<BN>;
  constexpr int kStage = PackedSpikes<>::kStageBytes +
                         WeightSlice<BN>::kStageBytes;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  float4 acc[T::kRM][T::kRuns];
#pragma unroll
  for (int i = 0; i < T::kRM; ++i)
#pragma unroll
    for (int q = 0; q < T::kRuns; ++q) acc[i][q] = make_float4(0, 0, 0, 0);

  RowCursor<OneGate> cur(OneGate{occ}, tile_k_idx, row_ptr[blockIdx.x],
                         row_ptr[blockIdx.x + 1], k);
  auto issue = [&](int slot) {
    unsigned char* stage = ring + slot * kStage;
    a.issue(stage, m0, cur.k0());
    WeightSlice<BN>::issue(stage + PackedSpikes<>::kStageBytes, w, cur.k0(),
                           n0, k, n, vec_w);
    commit();
    cur.next();
  };
  int issued = 0;
  for (; issued < kStages - 1 && cur.valid(); ++issued) issue(issued);
  for (int done = 0; done < issued; ++done) {
    wait_pending(issued - done - 1);
    __syncthreads();
    if (cur.valid()) issue(issued++ % kStages);
    const unsigned char* stage = ring + (done % kStages) * kStage;
    add_word_slice<BN>(stage, stage + PackedSpikes<>::kStageBytes, acc);
  }
  store_word_acc<BN>(out, m0, n0, m, n, acc);
}

// The kernel of each loader: f32 spikes take `fma_slice`, words their own
// compute.
template <int BN>
auto kernel_for(const DenseSpikes<>&) {
  return csr_pipe_kernel<BN, DenseSpikes<>>;
}
template <int BN>
auto kernel_for(const PackedSpikes<>&) {
  return csr_pipe_word_kernel<BN>;
}

template <int BN, class A>
int launch_bn(A a, const float* w, float* out, const int* row_ptr,
              const int* tile_k_idx, const int* occ, int64_t m, int64_t k,
              int64_t n, int64_t mt, cudaStream_t stream) {
  constexpr int kBytes =
      kStages * (A::kStageBytes + WeightSlice<BN>::kStageBytes);
  auto kernel = kernel_for<BN>(a);
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
           int64_t n, int64_t mt, int bn, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
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

inline int pick_word_bn(int64_t n, int64_t mt) {
  return pick_bn_waves(n, mt, kWordBlocksPerSM);
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
                occ, m, k, n, mt, pick_bn(n, mt), stream);
}

// p: (M, KW) uint32 words covering K <= 32*KW columns (bits past K zero),
// w: (K, N) f32, out: (M, N) f32; the work list as above, on the 128 x 128
// grid of the unpacked (M, K) matrix.
extern "C" int spike_matmul_packed_csr_pipe_forward(
    const uint32_t* p, const float* w, float* out, const int* row_ptr,
    const int* tile_k_idx, const int* occ, int64_t m, int64_t kw, int64_t k,
    int64_t n, int64_t mt, void* stream) {
  return launch(PackedSpikes<>{p, m, kw}, w, out, row_ptr, tile_k_idx, occ,
                m, k, n, mt, pick_word_bn(n, mt), stream);
}

// The launch the word kernel makes for N columns and MT m-tile rows:
// out = {BN, rows and columns a thread holds, SMs, blocks an SM}.
extern "C" int spike_matmul_packed_csr_pipe_launch(int64_t n, int64_t mt,
                                                   int* out) {
  const int bn = pick_word_bn(n, mt);
  auto fill = [&](auto bc) {
    using T = WordTile<decltype(bc)::value>;
    out[0] = bn;
    out[1] = T::kRM;
    out[2] = T::kCN;
  };
  switch (bn) {
    case 128: fill(std::integral_constant<int, 128>{}); break;
    case 96: fill(std::integral_constant<int, 96>{}); break;
    case 64: fill(std::integral_constant<int, 64>{}); break;
    default: fill(std::integral_constant<int, 32>{}); break;
  }
  out[3] = sm_count();
  out[4] = kWordBlocksPerSM;
  return 0;
}
