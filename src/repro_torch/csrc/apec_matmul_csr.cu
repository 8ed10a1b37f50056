// Fused APEC matmul over a union CSR-of-tiles work list:
// out = res @ w + repeat(ov @ w, g) along the rows, with res and ov as f32
// spikes or as uint32 words, summed as an event walk: one weight-row
// accumulate per residual or overlap spike. The walk's pieces (event
// lists, weight staging, word loads) are csrc/event_walk.cuh's, shared with
// the serial CSR kernels 11 and 13 (csrc/spike_matmul_csr.cu).
//
// Replaces: src/repro/kernels/spike_matmul.py::_apec_matmul_csr_kernel
//           (apec_matmul_csr_pallas, pipeline=False) and, on words,
//           ::_apec_matmul_packed_csr_kernel (apec_matmul_packed_csr_pallas,
//           pipeline=False). Their prefetching twins (pipeline=True) are
//           csrc/apec_matmul_csr_pipe.cu, the routes picked on the card;
//           this serial kernel stays reachable by override.
// Bound on the H100: after decomposition both operands are binary (or small
//           counts), so the work the function needs is one accumulate of a
//           BN-wide weight row per event, a nonzero of res or ov in a live
//           tile: 2 * events * N flops over 67 TFLOP/s (fp32), or the
//           bytes (spikes, weight rows of the used k-tiles, the output).
//           APEC exists to shrink that event count, so this kernel's time
//           follows it. Each event reads its 512-byte weight row from shared
//           memory (an LDS.128 a lane, four passes of 128 bytes) for 128
//           adds: about 4 clocks of an SM an event, a quarter of the add
//           rate. A dense tile of FMAs would run every element of every
//           live tile, 1.5x the dense product at g = 2.
// Numbers:  each output is the dense loop's fmaf chain: acc = fmaf(v,
//           w[k][c], acc) in k order (the steps ascend in k, the events
//           within a step), v the f32 spike (any value: the counts the
//           tests feed) or 1.0 on words. A zero spike is skipped: the dense
//           chain's fmaf(0, w, acc) leaves acc as it is (w finite; acc is
//           never -0, it starts at +0), so the sums equal the dense loop's,
//           and the f32 and word kernels equal each other, bit for bit. The
//           residual and overlap sums stay apart and the output is
//           acc_res[i] + acc_ov[i / g].
// Design:   grid (m-tile row, n-tile), 512 threads as 16 warps, one block an
//           SM. Each block walks its row's steps row_ptr[r]..row_ptr[r+1] in
//           order (the TPU's sequential grid axis); a step is live when
//           either operand's count is positive (`tile_mma::UnionGate`), a
//           dead one is skipped. A live step's weight rows w[k0:k0+128,
//           n0:n0+BN] are staged in shared memory once (16-byte cp.async,
//           zeros past K and N), double-buffered across live steps, and both
//           operands' events read them: one barrier a step. A warp takes one
//           row at a time (residual rows warp + 16 i, then overlap rows
//           warp + 16 i, so clustered rows spread over the warps) and its lanes
//           split the BN columns, four a lane. The row's four 32-bit words of
//           the step are the same in every lane: on words a lane loads one
//           (row, word) of the next live step while the current one is
//           walked, and each row's words come by shuffle; on f32 spikes the
//           warp loads a row's 128 values coalesced, three rows ahead of its
//           walk (two at g = 1), and takes `__ballot_sync(x != 0)`. A binary
//           row (`walk_binary`) writes its events in order to the warp's list
//           in shared memory, each lane its own columns' bits at their ranks,
//           and reads the list four indices at a time: four LDS.128 in
//           flight, then their adds in order. A row holding other values
//           (counts) walks its bits one at a time with the value by
//           `__shfl_sync` (`walk_valued`). The walk loops are kept rolled:
//           unrolled (11,456 instructions in the g = 2 word instance) they
//           ran no faster and held more registers. Each overlap row is walked
//           once a group, never g times; a step whose operand count is 0
//           walks nothing of it, and a carried map's empty operand reads as
//           zero words. The epilogue parks the overlap sums in the weight
//           buffers and writes acc_res + ovsum[r / g] (float4 stores where
//           N % 4 == 0): the repeat happens there. BN (128, 96, 64, 32) comes
//           from `tile_mma::pick_bn_waves` at one block an SM; lanes past BN
//           read column 0's weights and store nothing. Ragged M, K and N are
//           masked, no operand is padded; g is any divisor of 128 (a template
//           parameter).
// Measured: the walk runs near 5 clocks of an SM an event, near its
//           shared-memory passes; about 40% of the time is around it (the
//           steps' staging, the lists, block starts). Bulk (TMA) weight
//           copies, persistent blocks, 32 warps and 8-index batches each
//           ran no faster on an NVIDIA H100 80GB HBM3 (PERF.md, Findings).
// Route gate: `apec_matmul_csr_routed_forward` takes a device int `route`;
//           every block returns at entry when it reads 0, writing nothing.
//           Hybrid dispatch launches this kernel and the predicated route's
//           kernel-10 launches behind one flag computed on the card from
//           the carried map (no host read). A null `route` always runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "event_walk.cuh"

namespace {

using event_walk::kBatch;
using event_walk::kRowsW;
using event_walk::kThreads;
using event_walk::kTile;
using event_walk::kWarps;
using event_walk::kWords;
using event_walk::load_words;
using event_walk::row_words;
using event_walk::stage_weights;
using event_walk::store4;
using event_walk::walk_binary;
using event_walk::walk_f32_row;

constexpr int kAhead = 3;                  // f32 rows loaded ahead of walk
// The f32 g = 1 instance holds the most accumulators (128 rows of each
// operand a block): it loads 2 rows ahead and 2 weight rows at once, or
// it spills.

// A warp's rows of one m-tile: kRowsW residual rows, then kOvW overlap
// rows (below 16 overlap rows, g >= 16, the warps past them hold none).
template <int G>
struct Rows {
  static_assert(G >= 1 && kTile % G == 0, "g must divide 128");
  static constexpr int kRo = kTile / G;                       // overlap rows
  static constexpr int kOvW = (kRo + kWarps - 1) / kWarps;
  static constexpr int kSeq = kRowsW + kOvW;
};

// The block's view of one launch.
struct Problem {
  const void* res;        // (m, kcols) f32 spikes or uint32 words
  const void* ov;         // (m / g, kcols)
  const float* w;         // (k, n)
  float* out;             // (m, n)
  const int* row_ptr;
  const int* tile_k_idx;
  tile_mma::UnionGate gate;
  int64_t m, kcols, k, n;
  int bn;
  bool vec_w, vec_out;
  const int* route = nullptr;   // run only where *route != 0 (null: always)
};

// f32 spikes: this lane's values of entry t of a warp's walk through the
// step at k0 (columns k0 + 32 q + lane), zeros where the entry's operand is
// dead at the step (`lv`), the row lies past its operand or the column
// past K.
template <int G>
__device__ __forceinline__ void load_entry(float (&x)[kWords],
                                           const Problem& p, int t,
                                           int64_t k0, unsigned lv) {
  using R = Rows<G>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* s;
  int64_t row, rows;
  bool live;
  if (t < kRowsW) {
    s = static_cast<const float*>(p.res);
    row = (int64_t)blockIdx.x * kTile + warp + kWarps * t;
    rows = p.m;
    live = lv & 1u;
  } else {
    const int o = warp + kWarps * (t - kRowsW);
    s = static_cast<const float*>(p.ov);
    row = (int64_t)blockIdx.x * R::kRo + o;
    rows = p.m / G;
    live = (lv & 2u) && o < R::kRo;
  }
  live = live && row < rows;
  const float* src = s + (live ? row * p.k + k0 + lane : 0);
#pragma unroll
  for (int q = 0; q < kWords; ++q)
    x[q] = live && k0 + 32 * q + lane < p.k ? __ldg(src + 32 * q) : 0.0f;
}

template <int G, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
apec_walk_kernel(Problem p) {
  if (p.route != nullptr && *p.route == 0) return;  // the other route runs
  using R = Rows<G>;
  constexpr int kB = kPacked || G > 1 ? kBatch : 2;
  constexpr int kAh = G > 1 ? kAhead : 2;
  extern __shared__ __align__(16) float smem[];   // 2 x 128 x bn weights
  __shared__ __align__(4) uint8_t lists[kWarps][kTile];   // event lists
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bn = p.bn;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t mo0 = (int64_t)blockIdx.x * R::kRo;
  const int64_t n0 = (int64_t)blockIdx.y * bn;
  const int c = 4 * lane;                          // this lane's columns
  const bool on = c < bn && n0 + c < p.n;
  uint8_t* list = lists[warp];
  float4 acc_r[kRowsW], acc_o[R::kOvW];
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) acc_r[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < R::kOvW; ++i) acc_o[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int end = p.row_ptr[blockIdx.x + 1];
  auto settle = [&](int step, unsigned& lv) {      // the next live step
    for (; step < end; ++step)
      if ((lv = p.gate.live(step)) != 0u) break;
    return step;
  };
  auto k0_of = [&](int step) {
    return step < end ? (int64_t)p.tile_k_idx[step] * kTile : (int64_t)0;
  };
  unsigned lv = 0;
  int step = settle(p.row_ptr[blockIdx.x], lv);
  int64_t k0 = k0_of(step);
  if (step < end) stage_weights(smem, p.w, k0, n0, p.k, p.n, bn, p.vec_w);
  // The walk's operands for the current step, loaded ahead: on words one
  // residual and one overlap word a lane; on f32 the first kAh entries.
  uint32_t wr = 0, wo = 0;
  float xs[kAh][kWords];
  if constexpr (kPacked) {
    const auto* res = static_cast<const uint32_t*>(p.res);
    const auto* ov = static_cast<const uint32_t*>(p.ov);
    wr = load_words(res, p.m, p.kcols, m0, kTile, k0, lv & 1u);
    wo = load_words(ov, p.m / G, p.kcols, mo0, R::kRo, k0, lv & 2u);
  } else {
#pragma unroll
    for (int a = 0; a < kAh; ++a) load_entry<G>(xs[a], p, a, k0, lv);
  }
  int buf = 0;
  while (step < end) {
    unsigned nlv = 0;
    const int nxt = settle(step + 1, nlv);
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
    const int64_t left = p.k - k0;                 // live columns a step
    if constexpr (kPacked) {
      const auto* res = static_cast<const uint32_t*>(p.res);
      const auto* ov = static_cast<const uint32_t*>(p.ov);
      const uint32_t nwr = load_words(res, p.m, p.kcols, m0, kTile, nk0,
                                      nlv & 1u);
      const uint32_t nwo = load_words(ov, p.m / G, p.kcols, mo0, R::kRo,
                                      nk0, nlv & 2u);
      if (lv & 1u) {
#pragma unroll
        for (int i = 0; i < kRowsW; ++i) {
          uint32_t bits[kWords];
          row_words(bits, wr, i, left);
          walk_binary<kB>(bits, list, wt, bn, acc_r[i]);
        }
      }
      if (lv & 2u) {
#pragma unroll
        for (int i = 0; i < R::kOvW; ++i)
          if (warp + kWarps * i < R::kRo) {
            uint32_t bits[kWords];
            row_words(bits, wo, i, left);
            walk_binary<kB>(bits, list, wt, bn, acc_o[i]);
          }
      }
      wr = nwr;
      wo = nwo;
    } else {
      // Entries t = 0 .. kSeq-1 in turn, each loaded kAh entries
      // before its walk; the last ones load the next live step's first.
#pragma unroll
      for (int t = 0; t < R::kSeq; ++t) {
        float x[kWords];
#pragma unroll
        for (int q = 0; q < kWords; ++q) x[q] = xs[0][q];
#pragma unroll
        for (int a = 0; a + 1 < kAh; ++a)
#pragma unroll
          for (int q = 0; q < kWords; ++q) xs[a][q] = xs[a + 1][q];
        if (t + kAh < R::kSeq)
          load_entry<G>(xs[kAh - 1], p, t + kAh, k0, lv);
        else
          load_entry<G>(xs[kAh - 1], p, t + kAh - R::kSeq, nk0, nlv);
        float4& acc = t < kRowsW ? acc_r[t < kRowsW ? t : 0]
                                 : acc_o[t < kRowsW ? 0 : t - kRowsW];
        // Binary rows (the spikes APEC takes) walk their event list; a
        // row holding any other value (counts) walks with the values.
        walk_f32_row<kB>(x, list, wt, bn, acc);
      }
    }
    step = nxt;
    lv = nlv;
    k0 = nk0;
    buf ^= 1;
  }

  // Epilogue: overlap row o of the tile serves residual rows o*G..o*G+G-1
  // (128 % G == 0, so groups never straddle two tiles). No copy is in
  // flight: the last live step staged nothing.
  __syncthreads();
  float* ovsum = smem;                             // kRo x bn
  if (c < bn) {
#pragma unroll
    for (int i = 0; i < R::kOvW; ++i) {
      const int o = warp + kWarps * i;
      if (o < R::kRo) *reinterpret_cast<float4*>(ovsum + o * bn + c) = acc_o[i];
    }
  }
  __syncthreads();
  if (!on) return;
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    const int r = warp + kWarps * i;
    const int64_t gr = m0 + r;
    if (gr >= p.m) break;                          // rows ascend in i
    const float4 o = *reinterpret_cast<const float4*>(ovsum + r / G * bn + c);
    const float4 v = make_float4(acc_r[i].x + o.x, acc_r[i].y + o.y,
                                 acc_r[i].z + o.z, acc_r[i].w + o.w);
    store4(p.out + gr * p.n + n0 + c, v, n0 + c, p.n, p.vec_out);
  }
}

template <int G, bool kPacked>
cudaError_t launch(Problem p, int64_t mt, cudaStream_t stream) {
  auto kernel = apec_walk_kernel<G, kPacked>;
  const int bytes = 2 * kTile * p.bn * (int)sizeof(float);
  const cudaError_t err = tile_fma::allow_dynamic_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  // m-tile rows on x (no 65535 limit); neighbouring blocks share the
  // n-tile's weight rows in L2.
  dim3 grid((unsigned)mt, (unsigned)((p.n + p.bn - 1) / p.bn));
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaSuccess;
}

template <bool kPacked>
int forward(Problem p, int64_t mt, int64_t g, void* stream) {
  if (g < 1 || p.m % g != 0) return (int)cudaErrorInvalidValue;
  if (p.m > 0 && p.n > 0) {
    p.bn = tile_mma::pick_bn_waves(p.n, mt, 1);
    p.vec_w = p.n % 4 == 0 && event_walk::aligned16(p.w);
    p.vec_out = p.n % 4 == 0 && event_walk::aligned16(p.out);
    cudaError_t err = cudaSuccess;
    if (!tile_fma::dispatch_group(g, [&](auto gc) {
          err = launch<decltype(gc)::value, kPacked>(
              p, mt, (cudaStream_t)stream);
        }))
      return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// res: (M, K) f32, ov: (M/g, K) f32, w: (K, N) f32, out: (M, N) f32;
// row_ptr: (MT+1,), tile_k_idx / occ_res / occ_ov: (cap,) int32 with
// MT = ceil(M/128); g in {1, 2, 4, ..., 128}.
extern "C" int apec_matmul_csr_forward(const float* res, const float* ov,
                                       const float* w, float* out,
                                       const int* row_ptr,
                                       const int* tile_k_idx,
                                       const int* occ_res, const int* occ_ov,
                                       int64_t m, int64_t k, int64_t n,
                                       int64_t mt, int64_t g, void* stream) {
  return forward<false>(Problem{res, ov, w, out, row_ptr, tile_k_idx,
                                {occ_res, occ_ov}, m, k, k, n, 0, false,
                                false},
                        mt, g, stream);
}

// The same, gated: runs only where the device int `route` is nonzero, and
// otherwise writes nothing (hybrid dispatch's event route, launched beside
// the predicated route's two kernel-10 launches behind one flag).
extern "C" int apec_matmul_csr_routed_forward(
    const float* res, const float* ov, const float* w, float* out,
    const int* row_ptr, const int* tile_k_idx, const int* occ_res,
    const int* occ_ov, int64_t m, int64_t k, int64_t n, int64_t mt,
    int64_t g, const int* route, void* stream) {
  return forward<false>(Problem{res, ov, w, out, row_ptr, tile_k_idx,
                                {occ_res, occ_ov}, m, k, k, n, 0, false,
                                false, route},
                        mt, g, stream);
}

// The same on words: res (M, KW) and ov (M/g, KW) uint32 covering
// K <= 32*KW columns (bits past K zero); the rest as above.
extern "C" int apec_matmul_packed_csr_forward(
    const uint32_t* res, const uint32_t* ov, const float* w, float* out,
    const int* row_ptr, const int* tile_k_idx, const int* occ_res,
    const int* occ_ov, int64_t m, int64_t kw, int64_t k, int64_t n,
    int64_t mt, int64_t g, void* stream) {
  return forward<true>(Problem{res, ov, w, out, row_ptr, tile_k_idx,
                               {occ_res, occ_ov}, m, kw, k, n, 0, false,
                               false},
                       mt, g, stream);
}
