// Pipelined event-compacted spike matmul: out = s @ w over the occupied
// (m-tile, k-tile) steps of a CSR-of-tiles work list, with s as f32
// spikes or as uint32 words, fed by a cp.async ring.
//
// Replaces: src/repro/kernels/spike_matmul.py::_spike_matmul_csr_pipe_kernel
//           (spike_matmul_csr_pallas, pipeline=True) and, on words,
//           ::_spike_matmul_packed_csr_pipe_kernel
//           (spike_matmul_packed_csr_pallas, pipeline=True), with their
//           weight prefetch `_weight_prefetch`.
// Bound on the H100: at the main path's densities (0.2-0.47), the f32
//           spikes' bytes at stage 1 and fc1 (4 bytes a spike of a live
//           tile, far more than the one fp32 instruction a nonzero spike
//           and column the product needs) and the operations at fc2;
//           the words' operations everywhere (1/8 byte a spike). What the
//           kernels issue is one fp32 instruction an element of a live
//           tile and a column, dense or not: at 50% tiles the dense-tile
//           FMAs take 0.081 / 0.066 / 0.074 ms at stage 1 / fc1 / fc2 on
//           67 TFLOP/s (chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W), so
//           the loop's issue rate, not the bytes, sets their time.
// Design:   grid (m-tile row, n-tile), 256 threads, two blocks an SM,
//           dynamic shared memory (opted in past 48 KB). Each block walks
//           its row's occupied steps through csrc/tile_mma.cuh's ring:
//           kStages stages of one 32-deep k-slice each, the spike slice
//           (f32, or one word a row) and the weight slice arriving by
//           cp.async kStages-1 slices ahead of compute, across step
//           boundaries, so no thread stalls on its own loads. Steps with occ == 0 (dummy
//           steps of empty rows) issue no copy; an empty row writes
//           zeros; padding steps past row_ptr[MT] are never reached. Each
//           output is an fmaf chain in k order, the arithmetic of kernel
//           11's event walk (which skips the zero spikes): the result
//           equals kernel 11's (and cuBLAS fp32's) bit for bit
//           (tile_mma.cuh says why not tensor cores).
//           Both loaders share one thread tile (`tile_mma::ThreadTile`):
//           a thread holds few rows and many columns in runs of 4 (8 x 8
//           at BN = 128, 4 x 12 at 96, 4 x 8 at 64, 2 x 8 at 32) and reads
//           weight rows as LDS.128. On f32 spikes
//           (`tile_mma::fma_tile_slice`) it reads each row's spikes
//           kKV k-columns at once and runs an fmaf per element, any spike
//           value and no test of it (a warp's 16 rows are all zero in
//           0.8^16 = 2.8% of k-columns at density 0.2, too few to skip).
//           On words (`tile_mma::add_word_slice`) it tests each row's word
//           bit once for all its columns; a set bit adds the weight row
//           with predicated fadds (fadd(acc, w) = fmaf(1, w, acc), and
//           fmaf(0, w, acc) = acc: the same chain). The n-tile width is
//           picked for whole waves of two blocks an SM
//           (`tile_mma::pick_bn_waves`): fc2's 64 m-tiles x N = 384 run
//           BN = 96 in 256 blocks, one wave on 132 SMs.
//           `spike_matmul_csr_pipe_launch` and
//           `spike_matmul_packed_csr_pipe_launch` report the launch each
//           entry makes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace {

using namespace tile_mma;

// Blocks an SM of both kernels: their __launch_bounds__ and the waves
// their n-tile width is picked for.
constexpr int kBlocksPerSM = 2;

// acc += one slice's product, by the loader's kind of spikes.
template <int BN>
__device__ __forceinline__ void slice_product(const DenseSpikes<>&,
                                              const unsigned char* a_stage,
                                              const unsigned char* b_stage,
                                              TileAcc<BN>& acc) {
  fma_tile_slice<BN>(a_stage, b_stage, acc);
}
template <int BN>
__device__ __forceinline__ void slice_product(const PackedSpikes<>&,
                                              const unsigned char* a_stage,
                                              const unsigned char* b_stage,
                                              TileAcc<BN>& acc) {
  add_word_slice<BN>(a_stage, b_stage, acc);
}

template <int BN, class A>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
csr_pipe_kernel(A a, const float* __restrict__ w, float* __restrict__ out,
                const int* __restrict__ row_ptr,
                const int* __restrict__ tile_k_idx,
                const int* __restrict__ occ, int64_t m, int64_t k, int64_t n,
                bool vec_w) {
  extern __shared__ __align__(16) unsigned char ring[];
  using T = ThreadTile<BN>;
  constexpr int kStage = A::kStageBytes + WeightSlice<BN>::kStageBytes;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  TileAcc<BN> acc;
#pragma unroll
  for (int i = 0; i < T::kRM; ++i)
#pragma unroll
    for (int q = 0; q < T::kRuns; ++q) acc[i][q] = make_float4(0, 0, 0, 0);

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
    slice_product<BN>(a, stage, stage + A::kStageBytes, acc);
  }
  store_tile<BN>(out, m0, n0, m, n, acc);
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

// The n-tile width both kernels take for N columns and MT m-tile rows.
inline int pick_pipe_bn(int64_t n, int64_t mt) {
  return pick_bn_waves(n, mt, kBlocksPerSM);
}

template <class A>
int launch(A a, const float* w, float* out, const int* row_ptr,
           const int* tile_k_idx, const int* occ, int64_t m, int64_t k,
           int64_t n, int64_t mt, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_pipe_bn(n, mt)) {
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

// out = {BN, rows and columns a thread holds, SMs, blocks an SM}: the
// launch both entries make for N columns and MT m-tile rows.
int report_launch(int64_t n, int64_t mt, int* out) {
  const int bn = pick_pipe_bn(n, mt);
  auto fill = [&](auto bc) {
    using T = ThreadTile<decltype(bc)::value>;
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
  out[4] = kBlocksPerSM;
  return 0;
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

// The launch each kernel makes for N columns and MT m-tile rows: out =
// {BN, rows and columns a thread holds, SMs, blocks an SM}.
extern "C" int spike_matmul_csr_pipe_launch(int64_t n, int64_t mt,
                                            int* out) {
  return report_launch(n, mt, out);
}

extern "C" int spike_matmul_packed_csr_pipe_launch(int64_t n, int64_t mt,
                                                   int* out) {
  return report_launch(n, mt, out);
}
