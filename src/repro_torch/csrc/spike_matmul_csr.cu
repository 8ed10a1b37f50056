// Event-compacted spike matmul, serial form: out = s @ w over the
// occupied (m-tile, k-tile) steps of a CSR-of-tiles work list, with s as
// f32 spikes or as uint32 words, summed as an event walk: one weight-row
// add per nonzero spike of a live step.
//
// Replaces: src/repro/kernels/spike_matmul.py::_spike_matmul_csr_kernel
//           (spike_matmul_csr_pallas, pipeline=False; :156) and, on words,
//           ::_spike_matmul_packed_csr_kernel (+ _unpack_tile;
//           spike_matmul_packed_csr_pallas, pipeline=False; :296). Their
//           pipelined twins (pipeline=True, :181 and :318) are
//           csrc/spike_matmul_csr_pipe.cu, which the registry picks on
//           the card; these kernels stay the `cuda` / `cuda-packed`
//           routes, reached by override and by a degrade.
// Bound on the H100: the work the function needs is one add of a BN-wide
//           weight row per event, a nonzero spike of a live tile: 2 *
//           events * N flops over 67 TFLOP/s (fp32), or the bytes
//           (spikes, the weight rows of the used k-tiles, the output),
//           whichever is larger. A dense tile of FMAs would run every
//           element of every live tile. Each event reads its weight row
//           from shared memory (an LDS.128 a lane, four passes of 128
//           bytes) for up to 128 adds, a quarter of the add rate, so the
//           walk beats a dense tile below a density of about a quarter
//           and its time follows the spikes.
// Numbers:  each output is the k-order fmaf chain of kernels 12 and 14
//           (csrc/tile_mma.cuh) and of the dense loop: acc = fmaf(v, w[k],
//           acc) in k order, v the f32 spike (any value: econv's coded
//           first conv feeds its multi-bit drive) or 1.0 on words. The work
//           list ascends in k within each m-tile row, and a zero spike is
//           skipped (fmaf(0, w, acc) = acc for finite w; acc starts at +0
//           and is never -0). So for finite weights kernels 11 and 13 equal
//           each other, kernels 12 and 14, and the chain plain version
//           (`spike_matmul_csr_chain_plain`) bit for bit.
// Design:   csrc/event_walk.cuh's walk, the APEC kernels' (17, 15)
//           without an overlap operand. Grid (m-tile row, n-tile), 512
//           threads as 16 warps; each block walks its row's steps
//           row_ptr[r]..row_ptr[r+1] in order (the TPU's sequential grid
//           axis). A step is live when occ[step] > 0; a dummy step (occ 0)
//           is skipped, so an all-empty row writes zeros, and padding
//           steps past row_ptr[MT] are never reached. A live step's weight
//           rows are staged in shared memory once (16-byte cp.async, zeros
//           past K and N), double-buffered across live steps: one barrier
//           a step. Warp w walks rows w + 16 i, i = 0..7 (clustered rows
//           spread over the warps), its lanes four columns each. On words
//           a lane loads one (row, word) of the next live step while the
//           current one is walked, and the warp builds all 8 rows' event
//           lists at once (`walk_step`): each lane writes its own word's
//           set bits at ranks from a scan over the row's 4 lanes, where
//           the per-row build took 32 shuffles and 32 rank writes a step
//           (1-12% faster). On f32 the warp loads each row's 128 values
//           coalesced, rows ahead of its walk, and walks row by row
//           (`walk_f32_row`; a row holding any value but 0 or 1 walks with
//           the values): ballotting the rows into the words' layout first
//           ran 8-33% slower, the loads then waiting before the walk. BN
//           comes from `tile_mma::pick_bn_waves` at one block an SM; where
//           that is at most 96 (fc2, the stage-1 patches) two blocks share
//           an SM (64 registers, BN <= 96, f32 rows one ahead and events
//           two at a time, no spill), so one block's staging, barriers and
//           tail overlap the other's walk (10-15% faster there; at BN 128
//           the weights of two blocks do not fit, and BN 96 at fc1 walks a
//           third more n-tiles). Lanes past BN read column
//           0's weights and store nothing. The epilogue writes out = acc
//           (float4 stores where N % 4 == 0). Ragged M, K and N are masked;
//           no operand is padded.
// Route gate: `spike_matmul_csr_routed_forward` takes a device int
//           `route`; every block returns at entry when it reads 0, writing
//           nothing. Hybrid dispatch launches this kernel and the
//           predicated kernel 10 (csrc/spike_matmul.cu) behind one flag
//           computed on the card from the carried map (no host read). A
//           null `route` always runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "event_walk.cuh"

namespace {

using event_walk::kBatch;
using event_walk::kFull;
using event_walk::kRowsW;
using event_walk::kThreads;
using event_walk::kTile;
using event_walk::kWarps;
using event_walk::kWords;
using event_walk::load_words;
using event_walk::stage_weights;
using event_walk::store4;
using event_walk::walk_f32_row;
using event_walk::walk_list;

// What a block holds at kBlocks blocks an SM (two: 64 registers a
// thread, and BN at most 96 so that both blocks' weights fit): f32 rows
// loaded ahead of the walk, and weight rows loaded at once.
template <bool kPacked, int kBlocks>
struct Budget {
  static_assert(kBlocks == 1 || kBlocks == 2, "one or two blocks an SM");
  static constexpr int kAhead = kBlocks == 1 ? 3 : 1;
  static constexpr int kB = kPacked || kBlocks == 1 ? kBatch : 2;
};
constexpr int kMaxBn2 = 96;                // BN at two blocks an SM

// The block's view of one launch.
struct Problem {
  const void* s;          // (m, kcols) f32 spikes or uint32 words
  const float* w;         // (k, n)
  float* out;             // (m, n)
  const int* row_ptr;
  const int* tile_k_idx;
  tile_mma::OneGate gate;
  int64_t m, kcols, k, n;
  int bn;
  bool vec_w, vec_out;
  const int* route = nullptr;   // run only where *route != 0 (null: always)
};

// f32 spikes: this lane's values of row t of a warp's walk through the
// step at k0 (columns k0 + 32 q + lane), zeros where the step is dead, the
// row lies past M or the column past K.
__device__ __forceinline__ void load_row(float (&x)[kWords], const Problem& p,
                                         int t, int64_t k0, bool live) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * kTile + warp + kWarps * t;
  live = live && row < p.m;
  const float* src =
      static_cast<const float*>(p.s) + (live ? row * p.k + k0 + lane : 0);
#pragma unroll
  for (int q = 0; q < kWords; ++q)
    x[q] = live && k0 + 32 * q + lane < p.k ? __ldg(src + 32 * q) : 0.0f;
}

// One step of the warp's 8 rows from this lane's (row, word) `word`
// (`load_words`' layout: lane 4i+q holds row i's word q): every lane
// writes its word's set bits to its row's event list in `lists` at ranks
// from a scan over the row's 4 lanes, then each row walks its list
// (`walk_list`), in ascending column order.
template <int B>
__device__ __forceinline__ void walk_step(uint32_t word,
                                          uint8_t (*lists)[kTile],
                                          const float* wt, int bn,
                                          float4 (&acc)[kRowsW]) {
  const int lane = threadIdx.x % 32, q = lane % kWords;
  const int count = __popc(word);
  int below = count;                 // the row's events up to this word
#pragma unroll
  for (int d = 1; d < kWords; d *= 2) {
    const int t = __shfl_up_sync(kFull, below, d, kWords);
    if (q >= d) below += t;
  }
  uint8_t* list = lists[lane / kWords];
  int e = below - count;
  __syncwarp();                      // the warp's last walks read the lists
  for (uint32_t bits = word; bits; bits &= bits - 1)
    list[e++] = (uint8_t)(32 * q + __ffs(bits) - 1);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kRowsW; ++i)
    walk_list<B>(lists[i], __shfl_sync(kFull, below, kWords * i + kWords - 1),
                 wt, bn, acc[i]);
}

template <bool kPacked, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
csr_walk_kernel(Problem p) {
  if (p.route != nullptr && *p.route == 0) return;  // the other route runs
  constexpr int kAhead = Budget<kPacked, kBlocks>::kAhead;
  constexpr int kB = Budget<kPacked, kBlocks>::kB;
  extern __shared__ __align__(16) float smem[];   // 2 x 128 x bn weights
  // Each warp's event lists: one a row on words, one on f32.
  __shared__ __align__(4) uint8_t lists[kWarps][kPacked ? kRowsW : 1][kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bn = p.bn;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t n0 = (int64_t)blockIdx.y * bn;
  const int c = 4 * lane;                          // this lane's columns
  float4 acc[kRowsW];
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int end = p.row_ptr[blockIdx.x + 1];
  auto settle = [&](int step) {                    // the next live step
    while (step < end && !p.gate.live(step)) ++step;
    return step;
  };
  auto k0_of = [&](int step) {
    return step < end ? (int64_t)p.tile_k_idx[step] * kTile : (int64_t)0;
  };
  int step = settle(p.row_ptr[blockIdx.x]);
  int64_t k0 = k0_of(step);
  if (step < end) stage_weights(smem, p.w, k0, n0, p.k, p.n, bn, p.vec_w);
  // The walk's spikes for the current step, loaded ahead: on words one
  // word a lane; on f32 the first kAhead rows.
  const auto* words = static_cast<const uint32_t*>(p.s);
  uint32_t wr = 0;
  float xs[kAhead][kWords];
  if constexpr (kPacked) {
    wr = load_words(words, p.m, p.kcols, m0, kTile, k0, step < end);
  } else {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) load_row(xs[a], p, a, k0, step < end);
  }
  int buf = 0;
  while (step < end) {
    const int nxt = settle(step + 1);
    const int64_t nk0 = k0_of(nxt);
    tile_mma::wait_pending(0);
    __syncthreads();         // this step's weights landed; the other buffer
                             // is free (every warp left the last step)
    if (nxt < end)
      stage_weights(smem + (buf ^ 1) * kTile * bn, p.w, nk0, n0, p.k, p.n,
                    bn, p.vec_w);
    // Lanes past BN read column 0's weights (their sums go nowhere), so
    // the walk has no per-lane branch.
    const float* wt = smem + buf * kTile * bn + (c < bn ? c : 0);
    if constexpr (kPacked) {
      const uint32_t nwr = load_words(words, p.m, p.kcols, m0, kTile, nk0,
                                      nxt < end);
      // Words past the step's live columns read as zero.
      const bool in = 32 * (lane % kWords) < p.k - k0;
      walk_step<kB>(in ? wr : 0u, lists[warp], wt, bn, acc);
      wr = nwr;
    } else {
      // Rows t = 0 .. kRowsW-1 in turn, each loaded kAhead rows before
      // its walk; the last ones load the next live step's first.
#pragma unroll
      for (int t = 0; t < kRowsW; ++t) {
        float x[kWords];
#pragma unroll
        for (int q = 0; q < kWords; ++q) x[q] = xs[0][q];
#pragma unroll
        for (int a = 0; a + 1 < kAhead; ++a)
#pragma unroll
          for (int q = 0; q < kWords; ++q) xs[a][q] = xs[a + 1][q];
        if (t + kAhead < kRowsW)
          load_row(xs[kAhead - 1], p, t + kAhead, k0, true);
        else
          load_row(xs[kAhead - 1], p, t + kAhead - kRowsW, nk0, nxt < end);
        walk_f32_row<kB>(x, lists[warp][0], wt, bn, acc[t]);
      }
    }
    step = nxt;
    k0 = nk0;
    buf ^= 1;
  }

  if (c >= bn || n0 + c >= p.n) return;
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    const int64_t gr = m0 + warp + kWarps * i;
    if (gr >= p.m) break;                          // rows ascend in i
    store4(p.out + gr * p.n + n0 + c, acc[i], n0 + c, p.n, p.vec_out);
  }
}

template <bool kPacked, int kBlocks>
cudaError_t launch(Problem p, int64_t mt, void* stream) {
  auto kernel = csr_walk_kernel<kPacked, kBlocks>;
  const int bytes = 2 * kTile * p.bn * (int)sizeof(float);
  const cudaError_t err = tile_fma::allow_dynamic_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  // m-tile rows on x (no 65535 limit); neighbouring blocks share the
  // n-tile's weight rows in L2.
  dim3 grid((unsigned)mt, (unsigned)((p.n + p.bn - 1) / p.bn));
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(p);
  return cudaSuccess;
}

template <bool kPacked>
int forward(Problem p, int64_t mt, void* stream) {
  if (p.m > 0 && p.n > 0) {
    p.vec_w = p.n % 4 == 0 && event_walk::aligned16(p.w);
    p.vec_out = p.n % 4 == 0 && event_walk::aligned16(p.out);
    p.bn = tile_mma::pick_bn_waves(p.n, mt, 1);
    cudaError_t err;
    if (p.bn <= kMaxBn2) {
      p.bn = tile_mma::pick_bn_waves(p.n, mt, 2, kMaxBn2);
      err = launch<kPacked, 2>(p, mt, stream);
    } else {
      err = launch<kPacked, 1>(p, mt, stream);
    }
    if (err != cudaSuccess) return (int)err;
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
  return forward<false>(Problem{s, w, out, row_ptr, tile_k_idx, {occ}, m, k,
                                k, n, 0, false, false},
                        mt, stream);
}

// The same, gated: runs only where the device int `route` is nonzero, and
// otherwise writes nothing.
extern "C" int spike_matmul_csr_routed_forward(
    const float* s, const float* w, float* out, const int* row_ptr,
    const int* tile_k_idx, const int* occ, int64_t m, int64_t k, int64_t n,
    int64_t mt, const int* route, void* stream) {
  return forward<false>(Problem{s, w, out, row_ptr, tile_k_idx, {occ}, m, k,
                                k, n, 0, false, false, route},
                        mt, stream);
}

// p: (M, KW) uint32 words covering K <= 32*KW columns (bits past K zero),
// w: (K, N) f32, out: (M, N) f32; the work list as above, on the 128 x 128
// grid of the unpacked (M, K) matrix.
extern "C" int spike_matmul_packed_csr_forward(
    const uint32_t* p, const float* w, float* out, const int* row_ptr,
    const int* tile_k_idx, const int* occ, int64_t m, int64_t kw, int64_t k,
    int64_t n, int64_t mt, void* stream) {
  return forward<true>(Problem{p, w, out, row_ptr, tile_k_idx, {occ}, m, kw,
                               k, n, 0, false, false},
                       mt, stream);
}
