// Pipelined fused APEC matmul over a union CSR-of-tiles work list:
// out = res @ w + repeat(ov @ w, g) along the rows, with res and ov as f32
// spikes or as uint32 words, fed by csrc/tile_mma.cuh's cp.async ring into
// the tensor cores (csrc/tile_tc.cuh).
//
// Replaces: src/repro/kernels/spike_matmul.py::_apec_matmul_csr_pipe_kernel
//           (apec_matmul_csr_pallas, pipeline=True) and, on words,
//           ::_apec_matmul_packed_csr_pipe_kernel
//           (apec_matmul_packed_csr_pallas, pipeline=True), with their
//           union-gated weight prefetch `_weight_prefetch`.
// Bound on the H100: tensor-core operations, or the f32 spike bytes. An
//           occupied residual step is 2*128*128*N fp32 flops and an
//           occupied overlap step 2*(128/g)*128*N; each fp32 product is
//           three bf16 products (the exact split below), so the
//           operations bound is 3 * flops / 989 TFLOP/s (bf16 dense), 0.2x
//           the fp32-FMA bound (67 TFLOP/s). At the stage-1 patch matmul
//           (N = 96) the f32 spikes' bytes (64 KB an occupied step, over
//           3.35 TB/s) bound it instead; words (2 KB a step) never do.
// Numbers:  w = hi + mid + lo exactly in bf16 (each part the next 8 of
//           w's 24 significant bits); the spikes must be exact in bf16
//           (0 / 1, or small integers in the f32 operand), so every
//           product is exact and only the fp32 accumulation rounds. Per
//           output fragment and 32-deep slice, six m16n8k16 MMAs sum from
//           zero, smallest part first (lo, mid, hi; k16 step 0 then 1),
//           and one fp32 add puts that slice sum into the accumulator:
//           the tensor core's truncating adds never see more than one
//           slice. Not kernel 17's fmaf chain, so not its bits; the f32
//           and word kernels build the same A bits and run the same MMAs,
//           so they equal each other bit for bit.
// Design:   grid (m-tile row, n-tile), 256 threads as 8 warps, 2 (rows) x
//           4 (columns), dynamic shared memory (opted in past 48 KB). Each
//           block stages its row's steps row_ptr[r]..row_ptr[r+1] in
//           shared memory (`tile_tc::ListCursor`, RowCursor's walk) and
//           walks them through a kApecStages-deep ring, kApecStages-1
//           32-deep k-slices ahead of compute, across step boundaries. A
//           step is live when either operand's count is positive
//           (`UnionGate`); a dead step issues nothing. A ring stage holds
//           the residual slice (128 rows), the overlap slice (128/g rows)
//           and the weight slice (32 x BN f32); each spike slice is copied
//           only when its own count is positive, the weight slice on every
//           live step, all of one slice's copies in one committed group.
//           Each slot's two live flags travel beside it in a register bit
//           mask (two bits a slot, block-uniform), and a dead operand's
//           dot is skipped, never run on stale ring contents. Warp (wm,
//           wn) owns residual rows 64 wm .. 64 wm + 63 (four m16 tiles),
//           overlap m16 tiles wm * kMO .. (below 16 overlap rows, g >= 16,
//           one zero-filled tile on warp row 0) and BN/4 columns (BN/32 n8
//           tiles). Per slice a warp loads and splits its columns' B
//           fragments once and feeds both operands' MMAs from them; the A
//           fragments come from the ring, f32 spikes converted to bf16,
//           words expanded bit by bit in registers (no spike tile is
//           staged in any other form). Once the last slice is consumed (no copy group pending)
//           a barrier frees the ring, the overlap sums are parked in it,
//           and each row writes acc + ovsum[lr / g]: the repeat happens in
//           the epilogue. BN (128, 96, 64, 32; at most 96 at g = 1) comes
//           from `tile_mma::pick_bn_waves` (whole waves of one block
//           an SM); ragged M, K and N are zero-filled
//           on copy and masked on store, no operand is padded; g is any
//           divisor of 128 (a template parameter). One block of 8 warps
//           an SM; `mma.sync` peaks near half the bf16 rate, and `wgmma`
//           fed by TMA is the step past it.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <utility>

#include "tile_mma.cuh"
#include "tile_tc.cuh"

namespace {

using tile_mma::commit;
using tile_mma::kThreads;
using tile_mma::kTile;
using tile_mma::UnionGate;
using tile_mma::wait_pending;
using tile_tc::kListCap;

// Ring depth (kernels/spike_matmul.py: APEC_PIPE_STAGES mirrors it): one
// deeper than the CSR kernels' ring, since a slice of tensor-core work
// hides less copy time than one of fp32 FMAs.
constexpr int kApecStages = 4;
static_assert(kApecStages >= 2 && kApecStages <= 4,
              "wait_pending covers 0..2 groups in flight");

constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Warp tiling of the block's 128 residual rows, 128/g overlap rows and BN
// columns.
template <int G, int BN>
struct Warps {
  static constexpr int kRo = kTile / G;                    // overlap rows
  static constexpr int kMR = 4;                  // residual m16 tiles a warp
  static constexpr int kMOAll = kRo >= 16 ? kRo / 16 : 1;  // overlap m16s
  static constexpr int kMO = (kMOAll + 1) / 2;   // overlap m16 tiles a warp
  static constexpr int kNJ = BN / 32;            // n8 tiles a warp
  static_assert(BN % 32 == 0, "BN splits into 4 warps of n8 tiles");
};

// One ring stage: [residual slice | overlap slice | weight slice], each
// section 16-byte aligned for cp.async's 16-byte copies; the epilogue's
// overlap sums (128/g x (BN + 8) f32) alias the ring.
template <int G, int BN, class RA, class OA>
struct Layout {
  static constexpr int kOffO = align16(RA::kStageBytes);
  static constexpr int kOffW = kOffO + align16(OA::kStageBytes);
  static constexpr int kStage = kOffW + tile_tc::Weights<BN>::kStageBytes;
  static constexpr int kRing = kApecStages * kStage;
  static constexpr int kOvRow = BN + 8;    // conflict-free fragment stores
  static constexpr int kOvsum = Warps<G, BN>::kRo * kOvRow * 4;
  static constexpr int kBytes = kRing > kOvsum ? kRing : kOvsum;
  static_assert(kBytes + 4 * kListCap <= 232448,
                "past the H100's 227 KB a block");
};

// One block an SM: the accumulators and split weights need up to 255
// registers a thread at BN >= 96, and the f32 spike ring fills an SM's
// shared memory alone.
template <int G, int BN, class RA, class OA>
__global__ void __launch_bounds__(kThreads, 1)
apec_pipe_kernel(RA ra, OA oa, const float* __restrict__ w,
                 float* __restrict__ out, const int* __restrict__ row_ptr,
                 const int* __restrict__ tile_k_idx,
                 const int* __restrict__ occ_res,
                 const int* __restrict__ occ_ov, int64_t m, int64_t k,
                 int64_t n, bool vec_w) {
  using L = Layout<G, BN, RA, OA>;
  using W = Warps<G, BN>;
  using WS = tile_tc::Weights<BN>;
  extern __shared__ __align__(16) unsigned char ring[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int c0 = wn * (BN / 4);            // the warp's first column
  const int o0 = wm * W::kMO;              // the warp's first overlap m16
  // The warp holds overlap rows: both warp rows, but only row 0 where the
  // tile has one overlap m16 (kMO = 1 and g >= 8).
  const bool ov_warp = o0 < W::kMOAll;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t mo0 = (int64_t)blockIdx.x * W::kRo;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  float acc[W::kMR][W::kNJ][4], acco[W::kMO][W::kNJ][4];
#pragma unroll
  for (int i = 0; i < W::kMR; ++i)
#pragma unroll
    for (int j = 0; j < W::kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < W::kMO; ++i)
#pragma unroll
    for (int j = 0; j < W::kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acco[i][j][e] = 0.0f;

  __shared__ int list[kListCap];
  const UnionGate gate{occ_res, occ_ov};
  const int beg = row_ptr[blockIdx.x], end = row_ptr[blockIdx.x + 1];
  for (int t = threadIdx.x; t < end - beg && t < kListCap; t += kThreads)
    list[t] = tile_tc::list_entry(gate, tile_k_idx, beg + t);
  __syncthreads();
  tile_tc::ListCursor cur(list, gate, tile_k_idx, beg, end, k);
  unsigned slot_live = 0;    // bits 2s, 2s+1: slot s's residual, overlap
  auto issue = [&](int slot) {
    unsigned char* stage = ring + slot * L::kStage;
    const int64_t k0 = cur.k0();
    if (cur.live & 1u) ra.issue(stage, m0, k0);
    if (cur.live & 2u) oa.issue(stage + L::kOffO, mo0, k0);
    WS::issue(stage + L::kOffW, w, k0, n0, k, n, vec_w);
    commit();
    slot_live = (slot_live & ~(3u << (2 * slot))) | (cur.live << (2 * slot));
    cur.next();
  };
  int issued = 0;
  for (; issued < kApecStages - 1 && cur.valid(); ++issued) issue(issued);
  for (int done = 0; done < issued; ++done) {
    wait_pending(issued - done - 1);     // slice `done` has landed
    __syncthreads();                     // ... for every thread; and every
                                         // thread is past slice done-1
    if (cur.valid()) issue(issued++ % kApecStages);   // into done-1's slot
    const int slot = done % kApecStages;
    const unsigned live = (slot_live >> (2 * slot)) & 3u;
    const unsigned char* stage = ring + slot * L::kStage;
    const bool res_live = live & 1u, ov_live = (live & 2u) && ov_warp;
    tile_tc::BFrag b[W::kNJ];
    if (res_live || ov_live) {
#pragma unroll
      for (int j = 0; j < W::kNJ; ++j)
        tile_tc::load_b<WS::kRow>(
            reinterpret_cast<const float*>(stage + L::kOffW),
            c0 + 8 * j + gid, tig, b[j]);
    }
    if (res_live) {
#pragma unroll
      for (int i = 0; i < W::kMR; ++i) {
        uint32_t a[tile_tc::kKSteps][4];
        tile_tc::load_a(ra, stage, 64 * wm + 16 * i, gid, tig, a);
        tile_tc::mma_tile(acc[i], a, b);
      }
    }
    if (ov_live) {
#pragma unroll
      for (int i = 0; i < W::kMO; ++i) {
        uint32_t a[tile_tc::kKSteps][4];
        tile_tc::load_a(oa, stage + L::kOffO, 16 * (o0 + i), gid, tig, a);
        tile_tc::mma_tile(acco[i], a, b);
      }
    }
  }

  // Epilogue: overlap row o of the tile serves residual rows o*G..o*G+G-1
  // (128 % G == 0, so groups never straddle two tiles).
  __syncthreads();              // every thread past its last slice
  float* ovsum = reinterpret_cast<float*>(ring);
  if (ov_warp) {
#pragma unroll
    for (int i = 0; i < W::kMO; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (o0 + i) + gid + 8 * h;
        if (W::kRo < 16 && r >= W::kRo) continue;
#pragma unroll
        for (int j = 0; j < W::kNJ; ++j) {
          float* dst = ovsum + r * L::kOvRow + c0 + 8 * j + 2 * tig;
          dst[0] = acco[i][j][2 * h];
          dst[1] = acco[i][j][2 * h + 1];
        }
      }
    }
  }
  __syncthreads();
  const bool pair = n % 2 == 0;          // 8-byte stores line up
#pragma unroll
  for (int i = 0; i < W::kMR; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = 64 * wm + 16 * i + gid + 8 * h;
      const int64_t r = m0 + lr;
      if (r >= m) continue;
      const float* os = ovsum + (lr / G) * L::kOvRow;
#pragma unroll
      for (int j = 0; j < W::kNJ; ++j) {
        const int lc = c0 + 8 * j + 2 * tig;
        const int64_t c = n0 + lc;
        const float v0 = acc[i][j][2 * h] + os[lc];
        const float v1 = acc[i][j][2 * h + 1] + os[lc + 1];
        float* dst = out + r * n + c;
        if (pair && c + 1 < n) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (c < n) dst[0] = v0;
          if (c + 1 < n) dst[1] = v1;
        }
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
  cudaError_t err = cudaSuccess;
  const bool ok = tile_fma::dispatch_group(g, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    // At g = 1 the 128 overlap rows double the accumulators: BN <= 96
    // keeps them in registers.
    constexpr int kMaxBN = G == 1 ? 96 : 128;
    const auto ops = make(gc);
    auto run = [&](auto bc) {
      err = launch_bn<G, decltype(bc)::value>(
          ops.first, ops.second, w, out, row_ptr, tile_k_idx, occ_res,
          occ_ov, m, k, n, mt, st);
    };
    switch (tile_mma::pick_bn_waves(n, mt, 1, kMaxBN)) {
      case 128:
        if constexpr (kMaxBN >= 128) run(std::integral_constant<int, 128>{});
        break;
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
        return std::pair<tile_tc::Dense<kTile>, tile_tc::Dense<kTile / G>>{
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
        return std::pair<tile_tc::Packed<kTile>, tile_tc::Packed<kTile / G>>{
            {res, m, kw}, {ov, m / G, kw}};
      },
      w, out, row_ptr, tile_k_idx, occ_res, occ_ov, m, k, n, mt, g, stream);
}
