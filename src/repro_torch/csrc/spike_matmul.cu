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
//           (>= 64) turns it operation-bound like the CSR kernel: the
//           FMAs of every element of a live tile, issued one an element
//           and column (0.144 ms at fc1 on 67 TFLOP/s). fp32 FMA on the
//           CUDA cores, no TF32, for the bit-for-bit chain below.
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
// Design, N > 16 (hybrid routing's dense side, APEC hybrid's two products,
//           the guard's repair): the same chain on csrc/tile_mma.cuh's
//           fp32 thread tile (`ThreadTile`: 8 x 8 outputs a thread at
//           BN = 128, 4 x 12 at 96, 4 x 8 at 64, 2 x 8 at 32, spikes and
//           weight runs read as LDS.128), the n-tile width picked for whole
//           waves (`tile_mma::pick_bn_waves`), in one of two forms:
//           - TMA (where s and w are 16-byte aligned and K, N multiples of
//             4, as at every model's wide call): a persistent grid, one
//             block an SM walking output tiles blockIdx.x, + gridDim.x.
//             A producer warp's one thread walks each tile's map row
//             (`RowCursor<OneGate, TileIndex>`) and, for every 32-deep slice
//             of a live k-tile, issues two TMA box copies
//             (cp.async.bulk.tensor) into a kWideStages ring: s's 128 x 32
//             box with 128-byte swizzled rows and w's 32 x BN box, both
//             completing on the stage's `full` mbarrier; it refills a stage
//             once its `empty` mbarrier has one arrival from each consumer
//             warp. A dead k-tile issues no copy. The 8 consumer warps wait
//             on `full` (never on a stage no copy was issued to: they walk
//             the same cursor), run the slice's FMAs unrolled whole, the
//             next 4 k-columns' spike pieces loading while the current
//             ones issue, then arrive on `empty`; the ring runs on across
//             tiles, so one tile's store overlaps the next tile's copies,
//             and no barrier stops the block between slices. TMA
//             zero-fills the boxes past M, K and N (no load masks); the
//             tensor maps are encoded per launch through the driver entry
//             point `cuTensorMapEncodeTiled` (no link to libcuda). The
//             barriers, box copies and encoder are csrc/tma_ring.cuh's,
//             shared with the LIF backward's slab ring (csrc/lif.cu).
//             H100, fc1 / fc2 / stage 1 of SpikingFormer-4-384 on the
//             model's maps: 0.223 / 0.234 / 0.277 ms, the ring 0.244 /
//             0.251 / 0.301, cuBLAS fp32 0.214 / 0.231 / 0.340 (stream
//             probe, in turns); thread 0 producing between its slices at
//             two blocks an SM ran 0.255 / 0.278 / 0.331.
//           - ring (K = 27 at the CNNs' coded conv, an unaligned operand):
//             grid (m-tile row, n-tile), kernel 12's cp.async ring of
//             kStages 32-deep slices, 16-byte copies where rows allow and
//             4-byte ones elsewhere, on the map row, two blocks an SM.
//           An m-tile row with no live k-tile stores zeros in both forms.
// Route gate: `spike_matmul_pred_routed_forward` takes a device int
//           `route`; every block returns at entry when it reads 0, so the
//           launch writes nothing. Hybrid dispatch launches this kernel
//           and the event walk (csrc/spike_matmul_csr.cu) behind one flag
//           computed on the card from the carried map, so the route is
//           chosen with no host read (and a CUDA graph of the call picks it
//           from the map present at replay). A null `route` always runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"
#include "tma_ring.cuh"

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
using tile_mma::ThreadTile;
using tile_mma::TileAcc;

template <int BN>
__device__ __forceinline__ void zero_acc(TileAcc<BN>& acc) {
#pragma unroll
  for (int i = 0; i < ThreadTile<BN>::kRM; ++i)
#pragma unroll
    for (int q = 0; q < ThreadTile<BN>::kRuns; ++q)
      acc[i][q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The map row of m-tile `mt` as the ring's work list: step j is k-tile j.
using MapCursor = tile_mma::RowCursor<tile_mma::OneGate, tile_mma::TileIndex>;

__device__ __forceinline__ MapCursor map_row(const int* occ, int64_t mt,
                                             int kt, int64_t k) {
  return MapCursor(tile_mma::OneGate{occ + mt * kt}, tile_mma::TileIndex{},
                   0, kt, k);
}

// ------------------------------------------------- the ring form
// Blocks an SM: the kernel's __launch_bounds__ and its waves.
constexpr int kRingBlocksPerSM = 2;

template <int BN>
__global__ void __launch_bounds__(tile_mma::kThreads, kRingBlocksPerSM)
pred_ring_kernel(tile_mma::DenseSpikes<> a, const float* __restrict__ w,
                 float* __restrict__ out, const int* __restrict__ occ,
                 int64_t m, int64_t k, int64_t n, int kt, bool vec_w,
                 const int* __restrict__ route) {
  using tile_mma::WeightSlice;
  if (route != nullptr && *route == 0) return;      // the other route runs
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr int kStage =
      tile_mma::DenseSpikes<>::kStageBytes + WeightSlice<BN>::kStageBytes;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  TileAcc<BN> acc;
  zero_acc<BN>(acc);
  MapCursor cur = map_row(occ, blockIdx.x, kt, k);
  auto issue = [&](int slot) {
    unsigned char* stage = ring + slot * kStage;
    a.issue(stage, m0, cur.k0());
    WeightSlice<BN>::issue(stage + tile_mma::DenseSpikes<>::kStageBytes, w,
                           cur.k0(), n0, k, n, vec_w);
    tile_mma::commit();
    cur.next();
  };
  int issued = 0;
  for (; issued < kStages - 1 && cur.valid(); ++issued) issue(issued);
  for (int done = 0; done < issued; ++done) {
    tile_mma::wait_pending(issued - done - 1);   // slice `done` has landed
    __syncthreads();                     // ... for every thread; and every
                                         // thread is past slice done-1
    if (cur.valid()) issue(issued++ % kStages);   // into done-1's slot
    const unsigned char* stage = ring + (done % kStages) * kStage;
    tile_mma::fma_tile_slice<BN>(
        stage, stage + tile_mma::DenseSpikes<>::kStageBytes, acc);
  }
  tile_mma::store_tile<BN>(out, m0, n0, m, n, acc);
}

template <int BN>
int launch_ring(const float* s, const float* w, float* out, const int* occ,
                int64_t m, int64_t k, int64_t n, int64_t kt,
                const int* route, cudaStream_t stream) {
  constexpr int kBytes =
      kStages * (tile_mma::DenseSpikes<>::kStageBytes +
                 tile_mma::WeightSlice<BN>::kStageBytes);
  auto kernel = pred_ring_kernel<BN>;
  const cudaError_t err = tile_fma::allow_dynamic_smem(kernel, kBytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec_s = k % 4 == 0 && (uintptr_t)s % 16 == 0;
  const bool vec_w = n % 4 == 0 && (uintptr_t)w % 16 == 0;
  dim3 grid((unsigned)((m + kTile - 1) / kTile), (unsigned)((n + BN - 1) / BN));
  kernel<<<grid, tile_mma::kThreads, kBytes, stream>>>(
      tile_mma::DenseSpikes<>{s, m, k, vec_s}, w, out, occ, m, k, n, (int)kt,
      vec_w, route);
  return (int)cudaGetLastError();
}

// -------------------------------------------------- the TMA form
constexpr int kWideStages = 4;                   // TMA ring depth
constexpr int kConsumers = tile_mma::kThreads;   // the thread tile's 256
constexpr int kWideThreads = kConsumers + 32;    // and the producer's warp
constexpr int kWideBlocksPerSM = 1;

template <int BN>
struct Wide {
  static constexpr int kSpikeBytes = kTile * kSlice * 4;   // 128 x 128 B
  static constexpr int kStageBytes = kSpikeBytes + kSlice * BN * 4;
  // + slack to align the ring to 1024 bytes, the 128-byte swizzle's period
  static constexpr int kBytes = kWideStages * kStageBytes + 1024;
  static_assert(kStageBytes % 1024 == 0, "every spike box 1024-aligned");
  static_assert(ThreadTile<BN>::kRG % 8 == 0,
                "a thread's rows share one swizzle phase");
};

using tma_ring::bar_arrive;
using tma_ring::bar_expect;
using tma_ring::bar_init;
using tma_ring::bar_wait;
using tma_ring::tma_box;

// acc += the stage's slice product for this consumer thread: the chain of
// `tile_mma::fma_tile_slice` (each output one fmaf a k-column, k order) on
// the TMA layout. Spike row r's 16-byte piece c sits at piece c ^ (r & 7)
// of its 128-byte row (the 128-byte swizzle), so a warp's consecutive rows
// read one piece from distinct bank groups; weight rows are BN floats.
// The next piece's spikes load while the current piece's FMAs issue.
template <int BN>
__device__ __forceinline__ void fma_swizzled_slice(const unsigned char* stage,
                                                   TileAcc<BN>& acc) {
  using T = ThreadTile<BN>;
  constexpr int kPieces = kSlice / 4;
  const int cg = threadIdx.x % T::kG, rg = threadIdx.x / T::kG;
  const float* a = reinterpret_cast<const float*>(stage) + rg * kSlice;
  const float* b =
      reinterpret_cast<const float*>(stage + Wide<BN>::kSpikeBytes) + 4 * cg;
  const int phase = rg & 7;
  auto load = [&](int p, float4 (&av)[T::kRM]) {
    const float* ap = a + 4 * (p ^ phase);
#pragma unroll
    for (int i = 0; i < T::kRM; ++i)
      av[i] = *reinterpret_cast<const float4*>(ap + T::kRG * i * kSlice);
  };
  auto product = [&](int p, const float4 (&av)[T::kRM]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 wv[T::kRuns];
#pragma unroll
      for (int q = 0; q < T::kRuns; ++q)
        wv[q] = *reinterpret_cast<const float4*>(b + (4 * p + u) * BN +
                                                 4 * T::kG * q);
#pragma unroll
      for (int i = 0; i < T::kRM; ++i) {
        const float sv = tile_mma::piece_at(av[i], u);
#pragma unroll
        for (int q = 0; q < T::kRuns; ++q) tile_mma::fma4(sv, wv[q], acc[i][q]);
      }
    }
  };
  // Unrolled whole (the H100 ran a loop over pairs of pieces 7-19%
  // slower): the next piece's spikes and column's weights load while the
  // current FMAs issue.
  float4 even[T::kRM], odd[T::kRM];
  load(0, even);
#pragma unroll
  for (int p = 0; p < kPieces; p += 2) {
    load(p + 1, odd);
    product(p, even);
    if (p + 2 < kPieces) load(p + 2, even);
    product(p + 1, odd);
  }
}

template <int BN>
__global__ void __launch_bounds__(kWideThreads, kWideBlocksPerSM)
pred_tma_kernel(const __grid_constant__ CUtensorMap map_s,
                const __grid_constant__ CUtensorMap map_w,
                float* __restrict__ out, const int* __restrict__ occ,
                int64_t m, int64_t k, int64_t n, int kt, int nt, int tiles,
                const int* __restrict__ route) {
  using W = Wide<BN>;
  if (route != nullptr && *route == 0) return;      // the other route runs
  extern __shared__ __align__(16) unsigned char wide_smem[];
  __shared__ __align__(8) uint64_t full[kWideStages], empty[kWideStages];
  unsigned char* ring =
      wide_smem + (1024 - tile_mma::smem_addr(wide_smem) % 1024) % 1024;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWideStages; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kConsumers / 32);     // one arrival a warp
    }
    tma_ring::bar_init_fence();
  }
  __syncthreads();
  // Both sides walk tiles blockIdx.x, + gridDim.x and each tile's live
  // slices in one order; `slice` counts them across tiles, so the slice
  // sits in stage slice % kWideStages, on that stage's (slice /
  // kWideStages)-th fill.
  if (threadIdx.x >= kConsumers) {                  // the producer warp
    if (threadIdx.x != kConsumers) return;
    int slice = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int mt = t / nt, n0 = t % nt * BN;
      for (MapCursor cur = map_row(occ, mt, kt, k); cur.valid();
           cur.next(), ++slice) {
        const int slot = slice % kWideStages, fill = slice / kWideStages;
        if (fill > 0) bar_wait(&empty[slot], (fill - 1) & 1);
        unsigned char* stage = ring + slot * W::kStageBytes;
        bar_expect(&full[slot], W::kStageBytes);
        tma_box(stage, &map_s, (int)cur.k0(), mt * kTile, &full[slot]);
        tma_box(stage + W::kSpikeBytes, &map_w, n0, (int)cur.k0(),
                &full[slot]);
      }
    }
    return;
  }
  int slice = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = t / nt, n0 = t % nt * BN;
    TileAcc<BN> acc;
    zero_acc<BN>(acc);
    for (MapCursor cur = map_row(occ, mt, kt, k); cur.valid();
         cur.next(), ++slice) {
      const int slot = slice % kWideStages;
      bar_wait(&full[slot], (slice / kWideStages) & 1);
      fma_swizzled_slice<BN>(ring + slot * W::kStageBytes, acc);
      __syncwarp();                    // the warp's reads of the stage done
      if (threadIdx.x % 32 == 0) bar_arrive(&empty[slot]);
    }
    tile_mma::store_tile<BN>(out, (int64_t)mt * kTile, n0, m, n, acc);
  }
}

using tma_ring::encode;

// The wide form for an (M, K) x (K, N) product: TMA when it can describe
// both operands: 16-byte aligned bases (`aligned`), rows a multiple of 16
// bytes, coordinates within int; else the ring.
bool wide_tma(bool aligned, int64_t m, int64_t k, int64_t n) {
  return aligned && k % 4 == 0 && n % 4 == 0 &&
         m + kTile < INT32_MAX && k + kTile < INT32_MAX &&
         n + kTile < INT32_MAX;
}

// Output tiles of the TMA form for N columns and MT m-tile rows, and the
// persistent grid over them.
int64_t tma_tiles(int bn, int64_t n, int64_t mt) {
  return mt * ((n + bn - 1) / bn);
}
int64_t tma_grid(int64_t tiles) {
  const int64_t slots = (int64_t)kWideBlocksPerSM * tile_mma::sm_count();
  return tiles < slots ? tiles : slots;
}

template <int BN>
int launch_tma(const float* s, const float* w, float* out, const int* occ,
               int64_t m, int64_t k, int64_t n, int64_t kt, const int* route,
               cudaStream_t stream) {
  CUtensorMap map_s, map_w;
  if (!encode(&map_s, s, m, k, kTile, kSlice, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&map_w, w, k, n, kSlice, BN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorNotSupported;
  auto kernel = pred_tma_kernel<BN>;
  const cudaError_t err =
      tile_fma::allow_dynamic_smem(kernel, Wide<BN>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t mt = (m + kTile - 1) / kTile, nt = (n + BN - 1) / BN;
  const int64_t tiles = tma_tiles(BN, n, mt);
  if (tiles >= INT32_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tma_grid(tiles), kWideThreads, Wide<BN>::kBytes,
           stream>>>(map_s, map_w, out, occ, m, k, n, (int)kt, (int)nt,
                     (int)tiles, route);
  return (int)cudaGetLastError();
}

// Calls fn(std::integral_constant<int, BN>) for an n-tile width the picker
// gives.
template <class Fn>
int dispatch_bn(int bn, Fn&& fn) {
  switch (bn) {
    case 128: return fn(std::integral_constant<int, 128>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    default: return fn(std::integral_constant<int, 32>{});
  }
}

int pick_wide_bn(bool tma, int64_t n, int64_t mt) {
  return tile_mma::pick_bn_waves(n, mt,
                                 tma ? kWideBlocksPerSM : kRingBlocksPerSM);
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
  const bool tma = wide_tma(
      (uintptr_t)s % 16 == 0 && (uintptr_t)w % 16 == 0, m, k, n);
  return dispatch_bn(pick_wide_bn(tma, n, (m + kTile - 1) / kTile),
                     [&](auto bc) {
    constexpr int BN = decltype(bc)::value;
    return tma ? launch_tma<BN>(s, w, out, occ, m, k, n, kt, route, st)
               : launch_ring<BN>(s, w, out, occ, m, k, n, kt, route, st);
  });
}

// out = {form (0 stream, 1 ring, 2 TMA), BN, rows and columns a thread
// holds (the stream: rows a lane, columns a warp), grid blocks, blocks an
// SM, ring stages}: the launch `forward` makes for an (M, K) x (K, N)
// product whose operands are 16-byte aligned or not (`aligned`).
int report_launch(int64_t m, int64_t k, int64_t n, int aligned, int* out) {
  const int64_t mt = (m + kTile - 1) / kTile;
  if (n <= 16) {
    const int bn = n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
    out[0] = 0;
    out[1] = bn;
    out[2] = kPredRows;
    out[3] = bn < 4 ? bn : 4;
    out[4] = (int)mt;
    out[5] = 4;
    out[6] = kStages;
    return 0;
  }
  const bool tma = wide_tma(aligned != 0, m, k, n);
  const int bn = pick_wide_bn(tma, n, mt);
  return dispatch_bn(bn, [&](auto bc) {
    using T = ThreadTile<decltype(bc)::value>;
    const int64_t tiles = tma_tiles(bn, n, mt);
    out[0] = tma ? 2 : 1;
    out[1] = bn;
    out[2] = T::kRM;
    out[3] = T::kCN;
    out[4] = (int)(tma ? tma_grid(tiles) : tiles);
    out[5] = tma ? kWideBlocksPerSM : kRingBlocksPerSM;
    out[6] = tma ? kWideStages : kStages;
    return 0;
  });
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

// The launch kernel 10 makes for an (M, K) x (K, N) product (`aligned`:
// s and w 16-byte aligned), as `report_launch` gives it.
extern "C" int spike_matmul_pred_launch(int64_t m, int64_t k, int64_t n,
                                        int aligned, int* out) {
  return report_launch(m, k, n, aligned, out);
}
