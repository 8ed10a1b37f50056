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
// Design, N <= 16 (SegNet's tconv1 N = 16 and tconv2 N = 2): a stream.
//           A block owns one 128-row m-tile and all of the n-tile's BN
//           columns (BN = 2, 4, 8 or 16, the least that covers N). It walks
//           the map row's k-tiles in order through csrc/tile_mma.cuh's
//           RowCursor (k-tile index = step, `TileIndex`) and streams each
//           live k-tile's 32-deep slices of s, with the matching weight
//           rows, through a ring of kStages shared-memory stages by 16-byte
//           cp.async (4-byte copies where K % 4 != 0 or s is unaligned;
//           zero-fill past M and K), kStages - 1 slices ahead of its FMAs
//           and across k-tile boundaries: the ring of the CSR kernels, on
//           the map row. A dead k-tile (occ <= 0) issues no copy, and the
//           block waits only on groups it committed (`wait_pending`).
//           Each row's slice is one 128-byte line: 16-deep slices (64-byte
//           pieces) held the same stream near 1.9 TB/s on the H100, 32-deep
//           ones 2.6-2.8 TB/s. A stage is 16-18 KB (swizzled, unpadded
//           rows), four blocks an SM, 128 KB of loads in flight; tconv1's
//           1024 m-tiles take 1.94 waves. Lane l of a warp holds rows
//           l + 32 i (i < 4) x 4 columns (2 at N = 2), reads its spikes
//           along k as float4 (conflict-free) and each weight row as a
//           broadcast; BN / 4 warps split the columns (one at N <= 4, four
//           at N = 16), because one warp's FMAs could not keep up with its
//           copies (H100: 0.085 ms at tconv1 with one warp, 0.069 with
//           two, 0.067 with four). An
//           m-tile row with no live k-tile stores its zeros, as the TPU's
//           _init/_flush do.
//           Each output is one fmaf chain in k order over the live k-tiles
//           (zero-filled columns past K add fmaf(0, 0, acc) = acc), the
//           chain of the CSR kernels 11 and 12 (csrc/tile_mma.cuh): on the
//           same spikes and `build_csr` of the same map the results equal
//           theirs bit for bit, binary or multi-bit s.
// Design, N > 16 (hybrid routing's dense side): grid (m-tile row, 128-wide
//           n-tile), csrc/tile_fma.cuh's synchronous tile loop, the same
//           chain.
// Route gate: `spike_matmul_pred_routed_forward` takes a device int
//           `route`; every block returns at entry when it reads 0, so the
//           launch writes nothing. Hybrid dispatch launches this kernel
//           and the event walk (csrc/spike_matmul_csr.cu) behind one flag
//           computed on the card from the carried map, so the route is
//           chosen with no host read (and a CUDA graph of the call picks it
//           from the map present at replay). A null `route` always runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using tile_fma::kTile;

// ---------------------------------------------------------- N <= 16
using tile_mma::kSlice;           // k depth of a ring stage
using tile_mma::kStages;          // ring depth
constexpr int kPredRows = kTile / 32;   // rows a lane holds
constexpr int kChunks = kSlice / 4;     // 16-byte chunks a staged row

// A block is kWarps warps over one m-tile; warp w owns columns
// [w kCols, (w + 1) kCols): four columns a warp (two at BN = 2), so the
// FMAs of N = 8 and 16 spread over two and four warps and keep up with
// the copies, which one warp's could not.
template <int BN>
struct Pred {
  static constexpr int kCols = BN < 4 ? BN : 4;
  static constexpr int kWarps = BN / kCols;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSpikeBytes = kTile * kSlice * 4;
  static constexpr int kStageBytes = kSpikeBytes + kSlice * BN * 4;
  static constexpr int kBytes = kStages * kStageBytes;
};

// Staged spike rows are kSlice floats, unpadded; chunk c of row r sits at
// chunk c ^ (r & 7). Eight lanes copying one row's eight chunks, or
// reading one chunk of eight consecutive rows, then touch eight distinct
// 16-byte bank groups.
__device__ __forceinline__ int swizzle(int r, int c) {
  return r * kSlice + 4 * (c ^ (r & 7));
}

// s[m0:m0+128, k0:k0+kSlice] into the stage's rows, zeros past M and K:
// 128-byte row pieces, so DRAM sees whole lines (16-deep slices, 64-byte
// pieces, held the stream near 1.9 TB/s on the H100). Chunk e = tid +
// THREADS j is row e / kChunks.
template <int THREADS>
__device__ __forceinline__ void issue_spikes(float* a, const float* s,
                                             int64_t m0, int64_t k0,
                                             int64_t m, int64_t k,
                                             bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kStep = THREADS / kChunks;            // rows a pass
    const int r0 = tid / kChunks, c = tid % kChunks;
    const bool kin = k0 + 4 * c < k;
    const float* src = s + (m0 + r0) * k + k0 + 4 * c;
#pragma unroll
    for (int j = 0; j < kTile / kStep; ++j) {
      const bool in = kin && m0 + r0 + kStep * j < m;
      tile_mma::cp16(a + swizzle(r0 + kStep * j, c),
                     in ? src + (int64_t)kStep * j * k : s, in);
    }
  } else {
    for (int e = tid; e < kTile * kSlice; e += THREADS) {
      const int r = e / kSlice, c = e % kSlice;
      const int64_t gr = m0 + r, gc = k0 + c;
      const bool in = gr < m && gc < k;
      tile_mma::cp4(a + swizzle(r, c / 4) + c % 4,
                    in ? s + gr * k + gc : s, in);
    }
  }
}

// w[k0:k0+kSlice, 0:BN] into `b` (rows of BN floats), zeros past K and N.
// `vec`: N == BN, BN % 4 == 0 and w 16-byte aligned.
template <int BN, int THREADS>
__device__ __forceinline__ void issue_weights(float* b, const float* w,
                                              int64_t k0, int64_t k,
                                              int64_t n, bool vec) {
  const int tid = threadIdx.x;
  if constexpr (BN % 4 == 0) {
    if (vec) {     // the slice is kSlice * BN contiguous floats
      for (int e = tid; e < kSlice * BN / 4; e += THREADS) {
        const bool in = k0 + e / (BN / 4) < k;
        tile_mma::cp16(b + 4 * e, in ? w + k0 * n + 4 * e : w, in);
      }
      return;
    }
  }
  for (int e = tid; e < kSlice * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int64_t gk = k0 + r;
    const bool in = gk < k && c < n;
    tile_mma::cp4(b + e, in ? w + gk * n + c : w, in);
  }
}

// acc[i][j] (row lane + 32 i, column c0 + j) += the stage's slice
// product, one fmaf at a time in k order.
template <int BN>
__device__ __forceinline__ void fma_stage(const unsigned char* stage,
                                          int lane, int c0,
                                          float (&acc)[kPredRows]
                                                      [Pred<BN>::kCols]) {
  constexpr int kCols = Pred<BN>::kCols;
  const float* a = reinterpret_cast<const float*>(stage);
  const float* b =
      reinterpret_cast<const float*>(stage + Pred<BN>::kSpikeBytes) + c0;
#pragma unroll
  for (int q = 0; q < kSlice; q += 4) {
    const float* aq = a + swizzle(lane, q / 4);   // rows lane + 32 i alike
    float4 av[kPredRows];
#pragma unroll
    for (int i = 0; i < kPredRows; ++i)
      av[i] = *reinterpret_cast<const float4*>(aq + 32 * i * kSlice);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float bv[kCols];
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int j = 0; j < kCols; j += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(b + (q + u) * BN + j);
          bv[j] = v.x, bv[j + 1] = v.y, bv[j + 2] = v.z, bv[j + 3] = v.w;
        }
      } else {
        const float2 v = *reinterpret_cast<const float2*>(b + (q + u) * BN);
        bv[0] = v.x, bv[1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < kPredRows; ++i) {
        const float sv = u == 0 ? av[i].x : u == 1 ? av[i].y
                         : u == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(sv, bv[j], acc[i][j]);
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(Pred<BN>::kThreads, 4)
pred_stream_kernel(const float* __restrict__ s, const float* __restrict__ w,
                   float* __restrict__ out, const int* __restrict__ occ,
                   int64_t m, int64_t k, int64_t n, int kt, bool vec_s,
                   bool vec_w, const int* __restrict__ route) {
  using P = Pred<BN>;
  if (route != nullptr && *route == 0) return;      // the other route runs
  static_assert(P::kCols == 2 || P::kCols % 4 == 0, "float2 or float4 rows");
  extern __shared__ __align__(16) unsigned char ring[];
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, c0 = threadIdx.x / 32 * P::kCols;
  float acc[kPredRows][P::kCols];
#pragma unroll
  for (int i = 0; i < kPredRows; ++i)
#pragma unroll
    for (int j = 0; j < P::kCols; ++j) acc[i][j] = 0.0f;

  tile_mma::RowCursor<tile_mma::OneGate, tile_mma::TileIndex> cur(
      tile_mma::OneGate{occ + (int64_t)blockIdx.x * kt},
      tile_mma::TileIndex{}, 0, kt, k);
  auto issue = [&](int slot) {
    unsigned char* stage = ring + slot * P::kStageBytes;
    issue_spikes<P::kThreads>(reinterpret_cast<float*>(stage), s, m0,
                              cur.k0(), m, k, vec_s);
    issue_weights<BN, P::kThreads>(
        reinterpret_cast<float*>(stage + P::kSpikeBytes), w, cur.k0(), k, n,
        vec_w);
    tile_mma::commit();
    cur.next();
  };
  int issued = 0;
  for (; issued < kStages - 1 && cur.valid(); ++issued) issue(issued);
  for (int done = 0; done < issued; ++done) {
    tile_mma::wait_pending(issued - done - 1);   // slice `done` has landed
    __syncthreads();         // ... for every thread; every thread is past
                             // slice done-1, whose slot the issue reuses
    if (cur.valid()) issue(issued++ % kStages);
    fma_stage<BN>(ring + (done % kStages) * P::kStageBytes, lane, c0, acc);
  }
#pragma unroll
  for (int i = 0; i < kPredRows; ++i) {
    const int64_t r = m0 + lane + 32 * i;
    if (r >= m) continue;
    float* o = out + r * n + c0;
    if (P::kCols % 4 == 0 && n == BN) {
#pragma unroll
      for (int j = 0; j < P::kCols; j += 4)
        *reinterpret_cast<float4*>(o + j) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                        acc[i][j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < P::kCols; ++j)
        if (c0 + j < n) o[j] = acc[i][j];
    }
  }
}

template <int BN>
int launch_stream(const float* s, const float* w, float* out, const int* occ,
                  int64_t m, int64_t k, int64_t n, int64_t kt,
                  const int* route, cudaStream_t stream) {
  using P = Pred<BN>;
  auto kernel = pred_stream_kernel<BN>;
  const cudaError_t err = tile_fma::allow_dynamic_smem(kernel, P::kBytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec_s = k % 4 == 0 && (uintptr_t)s % 16 == 0;
  const bool vec_w = n == BN && (uintptr_t)w % 16 == 0;
  kernel<<<(unsigned)((m + kTile - 1) / kTile), P::kThreads, P::kBytes,
           stream>>>(s, w, out, occ, m, k, n, (int)kt, vec_s, vec_w, route);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- N > 16
constexpr int kWideRM = 8, kWideRN = 8;

__global__ void __launch_bounds__(
    tile_fma::Shape<kTile, kWideRM, kWideRN>::kThreads)
pred_matmul_kernel(const float* __restrict__ s, const float* __restrict__ w,
                   float* __restrict__ out, const int* __restrict__ occ,
                   int64_t m, int64_t k, int64_t n, int64_t kt,
                   const int* __restrict__ route) {
  __shared__ tile_fma::Staging<kTile> st;
  if (route != nullptr && *route == 0) return;      // the other route runs
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * kTile;
  const int* row = occ + (int64_t)blockIdx.x * kt;
  tile_fma::DenseA a{s, m, k};
  float acc[kWideRM][kWideRN];
  tile_fma::zero(acc);
  for (int j = 0; j < (int)kt; ++j) {    // an int index: faster than int64
    if (row[j] <= 0) continue;                   // empty tile: gated off
    tile_fma::accumulate_tile<kTile, kWideRM, kWideRN>(
        st, a, w, m0, n0, (int64_t)j * kTile, k, n, acc);
  }
  tile_fma::store_tile<kTile, kWideRM, kWideRN>(out, m0, n0, m, n, acc);
}

int forward(const float* s, const float* w, float* out, const int* occ,
            int64_t m, int64_t k, int64_t n, int64_t kt, const int* route,
            cudaStream_t st) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (n <= 2) return launch_stream<2>(s, w, out, occ, m, k, n, kt, route, st);
  if (n <= 4) return launch_stream<4>(s, w, out, occ, m, k, n, kt, route, st);
  if (n <= 8) return launch_stream<8>(s, w, out, occ, m, k, n, kt, route, st);
  if (n <= 16)
    return launch_stream<16>(s, w, out, occ, m, k, n, kt, route, st);
  dim3 grid((unsigned)((m + kTile - 1) / kTile),
            (unsigned)((n + kTile - 1) / kTile));
  pred_matmul_kernel<<<grid, tile_fma::Shape<kTile, kWideRM, kWideRN>::kThreads,
                       0, st>>>(s, w, out, occ, m, k, n, kt, route);
  return (int)cudaGetLastError();
}

}  // namespace

// s: (M, K) f32, w: (K, N) f32, out: (M, N) f32; occ: (MT, KT) int32 with
// MT = ceil(M/128), KT = ceil(K/128).
extern "C" int spike_matmul_pred_forward(const float* s, const float* w,
                                         float* out, const int* occ,
                                         int64_t m, int64_t k, int64_t n,
                                         int64_t kt, void* stream) {
  return forward(s, w, out, occ, m, k, n, kt, nullptr, (cudaStream_t)stream);
}

// The same, gated: runs only where the device int `route` is nonzero, and
// otherwise writes nothing.
extern "C" int spike_matmul_pred_routed_forward(const float* s,
                                                const float* w, float* out,
                                                const int* occ, int64_t m,
                                                int64_t k, int64_t n,
                                                int64_t kt, const int* route,
                                                void* stream) {
  return forward(s, w, out, occ, m, k, n, kt, route, (cudaStream_t)stream);
}
