// Pipelined fused APEC matmul over a union CSR-of-tiles work list:
// out = res @ w + repeat(ov @ w, g) along the rows, with res and ov as f32
// spikes or as uint32 words, fed by csrc/tile_mma.cuh's cp.async ring.
//
// Replaces: src/repro/kernels/spike_matmul.py::_apec_matmul_csr_pipe_kernel
//           (apec_matmul_csr_pallas, pipeline=True) and, on words,
//           ::_apec_matmul_packed_csr_pipe_kernel
//           (apec_matmul_packed_csr_pallas, pipeline=True), with their
//           union-gated weight prefetch `_weight_prefetch`.
// Bound on the H100: operations at the main path's densities. An occupied
//           residual step costs 2*128*128*N flops and an occupied overlap
//           step 2*(128/g)*128*N, against 64 KB and 64/g KB of f32 spikes
//           (2 KB and 2/g KB of words): above the fp32 ridge (67 TFLOP/s
//           over 3.35 TB/s, ~20 flops a byte) for every N the models use
//           (96..1536).
// Design:   grid (m-tile row, n-tile), 256 threads, dynamic shared memory
//           (opted in past 48 KB). Each block walks its row's steps
//           row_ptr[r]..row_ptr[r+1] through the ring, kStages-1 32-deep
//           k-slices ahead of compute, across step boundaries. A step is
//           live when either operand's count is positive (`UnionGate`);
//           a dead step issues nothing. A ring stage holds the residual
//           slice (128 rows), the overlap slice (128/g rows) and the
//           weight slice (32 x BN); each spike slice is copied only when
//           its own count is positive, the weight slice on every live
//           step, all of one slice's copies in one committed group. Each
//           slot's two live flags travel beside it in a register bit mask
//           (two bits a slot, block-uniform), and a dead operand's dot is
//           skipped, never run on stale ring contents. The residual sums
//           into an 8 x BN/16 register block per thread (rows ty + 16 i),
//           the overlap into a (8/g) x BN/16 block with kernel 17's
//           mapping; for g >= 16 (fewer overlap rows than the 16 thread
//           rows) thread row ty < 128/g holds overlap row ty and the
//           others skip the overlap dot. Every output is an fmaf chain in
//           k order and one add acc + ovsum[row / g]: kernel 17's
//           arithmetic (csrc/apec_matmul_csr.cu), so the results equal its
//           bit for bit, f32 or words. Once the last slice is consumed (no
//           copy group pending) a barrier frees the ring, the overlap sums
//           are parked in it, and each row writes acc + ovsum[lr / g]: the
//           repeat happens in the epilogue. BN (128, 96, 64, 32) comes from
//           `tile_mma::pick_bn`; ragged M, K and N are zero-filled on copy
//           and masked on store, no operand is padded; g is any divisor
//           of 128 (a template parameter).
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "tile_mma.cuh"

namespace {

using namespace tile_mma;

constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// One ring stage: [residual slice | overlap slice | weight slice], each
// section 16-byte aligned for cp.async's 16-byte copies; the epilogue's
// overlap sums (128/g x BN f32) alias the ring.
template <int G, int BN, class RA, class OA>
struct Layout {
  static constexpr int kRo = kTile / G;    // overlap rows of a tile
  static constexpr int kOffO = align16(RA::kStageBytes);
  static constexpr int kOffW = kOffO + align16(OA::kStageBytes);
  static constexpr int kStage = kOffW + WeightSlice<BN>::kStageBytes;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kOvsum = kRo * BN * 4;
  static constexpr int kBytes = kRing > kOvsum ? kRing : kOvsum;
  // Two blocks an SM where the accumulators leave room (<= 64 a thread:
  // kernel 12's budget); one where they do not (g = 1: 64 + 64).
  static constexpr int kAcc = (kRM + OA::kRowsPerThread) * (BN / kT);
  static constexpr int kMinBlocks = kAcc <= 64 ? 2 : 1;
};

template <int G, int BN, class RA, class OA>
__global__ void
__launch_bounds__(kThreads, (Layout<G, BN, RA, OA>::kMinBlocks))
apec_pipe_kernel(RA ra, OA oa, const float* __restrict__ w,
                 float* __restrict__ out, const int* __restrict__ row_ptr,
                 const int* __restrict__ tile_k_idx,
                 const int* __restrict__ occ_res,
                 const int* __restrict__ occ_ov, int64_t m, int64_t k,
                 int64_t n, bool vec_w) {
  using L = Layout<G, BN, RA, OA>;
  constexpr int kRMo = OA::kRowsPerThread;
  constexpr int kRN = BN / kT;
  extern __shared__ __align__(16) unsigned char ring[];
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;
  const bool ov_rows = L::kRo >= kT || ty < L::kRo;   // holds overlap rows
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t mo0 = (int64_t)blockIdx.x * L::kRo;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  float acc[kRM][kRN], acco[kRMo][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRMo; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acco[i][j] = 0.0f;

  RowCursor<UnionGate> cur(UnionGate{occ_res, occ_ov}, tile_k_idx,
                           row_ptr[blockIdx.x], row_ptr[blockIdx.x + 1], k);
  unsigned slot_live = 0;    // bits 2s, 2s+1: slot s's residual, overlap
  auto issue = [&](int slot) {
    unsigned char* stage = ring + slot * L::kStage;
    const int64_t k0 = cur.k0();
    if (cur.live & 1u) ra.issue(stage, m0, k0);
    if (cur.live & 2u) oa.issue(stage + L::kOffO, mo0, k0);
    WeightSlice<BN>::issue(stage + L::kOffW, w, k0, n0, k, n, vec_w);
    commit();
    slot_live = (slot_live & ~(3u << (2 * slot))) | (cur.live << (2 * slot));
    cur.next();
  };
  int issued = 0;
  for (; issued < kStages - 1 && cur.valid(); ++issued) issue(issued);
  for (int done = 0; done < issued; ++done) {
    wait_pending(issued - done - 1);     // slice `done` has landed
    __syncthreads();                     // ... for every thread; and every
                                         // thread is past slice done-1
    if (cur.valid()) issue(issued++ % kStages);   // into done-1's slot
    const int slot = done % kStages;
    const unsigned live = (slot_live >> (2 * slot)) & 3u;
    const unsigned char* stage = ring + slot * L::kStage;
    if (live & 1u) fma_slice<BN>(ra, stage, stage + L::kOffW, acc);
    if ((live & 2u) && ov_rows)
      fma_slice<BN>(oa, stage + L::kOffO, stage + L::kOffW, acco);
  }

  // Epilogue: overlap row o of the tile serves residual rows o*G..o*G+G-1
  // (128 % G == 0, so groups never straddle two tiles).
  __syncthreads();              // every thread past its last slice
  float* ovsum = reinterpret_cast<float*>(ring);
  if (ov_rows) {
#pragma unroll
    for (int i = 0; i < kRMo; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j)
        ovsum[(ty + kT * i) * BN + tx + kT * j] = acco[i][j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int lr = ty + kT * i;
    const int64_t r = m0 + lr;
    if (r >= m) continue;
    const float* os = ovsum + (lr / G) * BN + tx;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int64_t c = n0 + tx + kT * j;
      if (c < n) out[r * n + c] = acc[i][j] + os[kT * j];
    }
  }
}

template <int G, int BN, class RA, class OA>
cudaError_t launch_bn(RA ra, OA oa, const float* w, float* out,
                      const int* row_ptr, const int* tile_k_idx,
                      const int* occ_res, const int* occ_ov, int64_t m,
                      int64_t k, int64_t n, int64_t mt, cudaStream_t stream) {
  constexpr int kBytes = Layout<G, BN, RA, OA>::kBytes;
  auto kernel = apec_pipe_kernel<G, BN, RA, OA>;
  const cudaError_t err = tile_fma::allow_dynamic_smem(kernel, kBytes);
  if (err != cudaSuccess) return err;
  const bool vec_w = n % 4 == 0 && (uintptr_t)w % 16 == 0;
  dim3 grid((unsigned)mt, (unsigned)((n + BN - 1) / BN));
  kernel<<<grid, kThreads, kBytes, stream>>>(ra, oa, w, out, row_ptr,
                                             tile_k_idx, occ_res, occ_ov, m,
                                             k, n, vec_w);
  return cudaGetLastError();
}

// `make(gc)`: the (residual, overlap) loaders for group size
// decltype(gc)::value.
template <class Make>
int launch(Make&& make, const float* w, float* out, const int* row_ptr,
           const int* tile_k_idx, const int* occ_res, const int* occ_ov,
           int64_t m, int64_t k, int64_t n, int64_t mt, int64_t g,
           void* stream) {
  if (g < 1 || m % g != 0) return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int bn = pick_bn(n, mt);
  cudaError_t err = cudaSuccess;
  const bool ok = tile_fma::dispatch_group(g, [&](auto gc) {
    const auto ops = make(gc);
    auto run = [&](auto bc) {
      err = launch_bn<decltype(gc)::value, decltype(bc)::value>(
          ops.first, ops.second, w, out, row_ptr, tile_k_idx, occ_res,
          occ_ov, m, k, n, mt, st);
    };
    switch (bn) {
      case 128: run(std::integral_constant<int, 128>{}); break;
      case 96: run(std::integral_constant<int, 96>{}); break;
      case 64: run(std::integral_constant<int, 64>{}); break;
      default: run(std::integral_constant<int, 32>{}); break;
    }
  });
  return ok ? (int)err : (int)cudaErrorInvalidValue;
}

}  // namespace

// res: (M, K) f32, ov: (M/g, K) f32, w: (K, N) f32, out: (M, N) f32;
// row_ptr: (MT+1,), tile_k_idx / occ_res / occ_ov: (cap,) int32 with
// MT = ceil(M/128); g in {1, 2, 4, ..., 128}.
extern "C" int apec_matmul_csr_pipe_forward(
    const float* res, const float* ov, const float* w, float* out,
    const int* row_ptr, const int* tile_k_idx, const int* occ_res,
    const int* occ_ov, int64_t m, int64_t k, int64_t n, int64_t mt,
    int64_t g, void* stream) {
  const bool vec = k % 4 == 0 && (uintptr_t)res % 16 == 0 &&
                   (uintptr_t)ov % 16 == 0;
  return launch(
      [&](auto gc) {
        constexpr int G = decltype(gc)::value;
        return std::pair<DenseSpikes<>, DenseSpikes<kTile / G>>{
            {res, m, k, vec}, {ov, m / G, k, vec}};
      },
      w, out, row_ptr, tile_k_idx, occ_res, occ_ov, m, k, n, mt, g, stream);
}

// The same on words: res (M, KW) and ov (M/g, KW) uint32 covering
// K <= 32*KW columns (bits past K zero); the rest as above.
extern "C" int apec_matmul_packed_csr_pipe_forward(
    const uint32_t* res, const uint32_t* ov, const float* w, float* out,
    const int* row_ptr, const int* tile_k_idx, const int* occ_res,
    const int* occ_ov, int64_t m, int64_t kw, int64_t k, int64_t n,
    int64_t mt, int64_t g, void* stream) {
  return launch(
      [&](auto gc) {
        constexpr int G = decltype(gc)::value;
        return std::pair<PackedSpikes<>, PackedSpikes<kTile / G>>{
            {res, m, kw}, {ov, m / G, kw}};
      },
      w, out, row_ptr, tile_k_idx, occ_res, occ_ov, m, k, n, mt, g, stream);
}
