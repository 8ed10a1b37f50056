// The Hopper tile loops of the pipelined CSR spike matmuls
// (csrc/spike_matmul_csr_pipe.cu): a cp.async ring of k-slices, gated by
// the work list's per-step counts, feeding an fp32 FMA loop on f32 spikes
// (`fma_tile_slice`) or predicated fadds on words (`add_word_slice`);
// the ring the predicated kernel's narrow and wide ring paths
// (csrc/spike_matmul.cu) walk over a map row (`TileIndex`); and the ring,
// loaders and weight slices that the pipelined APEC matmuls
// (csrc/apec_matmul_csr_pipe.cu) feed into csrc/tile_tc.cuh's tensor-core
// loop instead.
//
// A block owns one 128-row m-tile x BN output columns and walks its row's
// work-list steps row_ptr[r]..row_ptr[r+1] as kSlice-deep k-slices. Each
// ring stage holds one slice: the spike slice (f32 spikes, or one uint32
// word per row) and the weight slice (kSlice x BN f32); APEC's stages
// hold a residual slice, an overlap slice of 128/g rows and the weight
// slice, in a ring one stage deeper. The issue side (`RowCursor`) runs
// stages-1 slices ahead of compute, across step boundaries within the
// row. The gate contract of the TPU kernels' `_weight_prefetch`
// (src/repro/kernels/spike_matmul.py:116) holds: a step whose gate is
// dead (occ == 0; for APEC both counts 0) issues no copy, an operand
// whose count is 0 is not copied, every committed group holds one
// slice's copies, and the consumer waits on exactly the groups that were
// committed (`wait_pending`, never on an unissued group).
// tests/test_torch_pipe.py, tests/test_torch_apec_pipe.py and
// tests/test_torch_stream.py hold the CPU twin of this schedule
// (`kernels/spike_matmul.py::ring_schedule`) to that contract.
//
// The CSR kernels' compute is fp32 on the CUDA cores, each output summed
// in k order one rounding at a time, as the serial kernels' event walk
// (csrc/event_walk.cuh: kernels 11 and 13 skip the zero spikes, which add
// nothing) and cuBLAS's fp32 GEMM sum it: the results equal theirs bit
// for bit, binary or multi-bit spikes, f32 or words. A split-TF32 tensor-core loop
// (w = hi + lo, two mma.sync.m16n8k8 per fragment, each k8 step's or
// slice's MMAs summed from zero and added in fp32) ran 1.8-2.5x faster
// than kernel 11 and sat closer to the fp64 product than it, but rounds in
// another order than `ref`'s cuDNN convolution; the CNN forwards' spike
// drift against `ref` (a threshold tie flips, and the flip cascades) then
// broke its 1e-2 gate at ResNet18's deep layers (H100, chip_smoke).
// Bitwise equality keeps every drift gate where kernel 11 held it. No
// model calls APEC, so no drift gate sees the APEC kernels: their
// tensor-core loop is held to its plain version and to the fp64 product
// instead.
//
// 256 threads, each holding few rows and many columns of the block
// (`ThreadTile`): RM x CN = 8 x 8 at BN = 128, 4 x 12 at 96, 4 x 8 at 64,
// 2 x 8 at 32, the columns in runs of 4, so its weight reads are LDS.128
// without bank conflicts, broadcast over the warp's row groups. On f32
// spikes (`fma_tile_slice`) a thread reads each of its rows' spikes 4
// k-columns at a time (LDS.128; a warp's rows are consecutive, 36 floats
// apart, so their pieces fall on disjoint banks) and runs RM x CN fmafs a
// k-column: 16 FMAs a shared-memory load at BN = 128, 12 at 96, 10.7 at
// 64 (kernel 10's wide path, csrc/spike_matmul.cu, runs the same tile,
// on this ring or on a TMA ring with 128-byte swizzled spike rows). On
// words (`add_word_slice`) one bit test of a row's word predicates CN
// fadds (a set bit adds the weight row, fadd(acc, w) = fmaf(1, w, acc); a
// clear one adds nothing, as fmaf(0, w, acc) = acc: kernel 11's chain,
// with no float made of the bit). A slice's
// 16-byte copies are unrolled, each thread stepping one pointer a pass.
// Shared-memory rows are padded (A: 32+4 floats, B: BN+8 floats; the
// APEC kernels pass tile_tc.cuh's pads). Ragged M, K and N are
// zero-filled on copy (cp.async src-size 0) and masked on store: no
// operand is padded. A row of f32 spikes or weights whose
// length is not a multiple of 4 (K = 27 at the coded conv, N = 2) is
// copied in 4-byte pieces instead of 16-byte ones.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "tile_fma.cuh"

namespace tile_mma {

constexpr int kTile = tile_fma::kTile;   // work-list tile (rows and k)
constexpr int kSlice = 32;       // k depth of one ring stage: one word a row
constexpr int kStages = 3;       // ring depth (kernels/spike_matmul.py:
                                 // PIPE_STAGES mirrors it)
constexpr int kThreads = 256;
constexpr int kPadA = 4;
constexpr int kPadB = 8;
static_assert(kStages >= 2 && kStages <= 4, "wait_pending covers 0..2");

// ------------------------------------------------------------ cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros when `in` is false (the source is then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Blocks until at most `pending` committed groups are still in flight.
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::); break;
  }
}

// ------------------------------------------------------------ work list
// A step's gate: the operands whose tile holds events at the step, as a
// bit mask (bit 0 the spike operand, or APEC's residual; bit 1 APEC's
// overlap). A step whose mask is 0 issues no copy.
struct OneGate {
  const int* __restrict__ occ;
  __device__ __forceinline__ unsigned live(int step) const {
    return occ[step] > 0 ? 1u : 0u;
  }
};

// APEC's union gate, `repro`'s `gate(u)` = occ_res[u] > 0 | occ_ov[u] > 0
// (src/repro/kernels/spike_matmul.py:633).
struct UnionGate {
  const int* __restrict__ occ_res;
  const int* __restrict__ occ_ov;
  __device__ __forceinline__ unsigned live(int step) const {
    return (occ_res[step] > 0 ? 1u : 0u) | (occ_ov[step] > 0 ? 2u : 0u);
  }
};

// A dense map row as a work list: step j is k-tile j (the predicated
// kernel, csrc/spike_matmul.cu, gates on the map row itself).
struct TileIndex {
  __device__ __forceinline__ int operator[](int step) const { return step; }
};

// Walks one m-tile row's live steps slice by slice: the ring's issue
// side (and, as a count, its consume side). `live` is the current step's
// gate mask, which tells the issuer what to copy; `kidx[step]` is the
// step's k-tile. Every thread holds its own copy and moves it
// identically, so the walk is block-uniform.
template <class Gate, class Index = const int*>
struct RowCursor {
  Gate gate;
  Index kidx;
  int step, end, kk;
  unsigned live;
  int64_t k;

  __device__ RowCursor(Gate gate_, Index kidx_, int beg, int end_,
                       int64_t k_)
      : gate(gate_), kidx(kidx_), step(beg), end(end_), kk(0), live(0),
        k(k_) {
    settle();
  }
  // Skips dead steps (mask 0, e.g. dummy steps of empty rows): they issue
  // no copy.
  __device__ void settle() {
    for (; step < end; ++step)
      if ((live = gate.live(step)) != 0u) break;
    kk = 0;
  }
  __device__ bool valid() const { return step < end; }
  __device__ int64_t k0() const { return (int64_t)kidx[step] * kTile + kk; }
  // The next slice: within the step while it lies before K, else the
  // next live step's first.
  __device__ void next() {
    kk += kSlice;
    if (kk >= kTile || k0() >= k) {
      ++step;
      settle();
    }
  }
};

// ------------------------------------------------------- spike loaders
// Each loader stages ROWS rows of a slice: 128 for a spike operand or
// APEC's residual, 128/g for APEC's overlap.

// f32 spikes (M, K) row-major. `vec`: rows may be copied 16 bytes at a
// time (K % 4 == 0 and s 16-byte aligned). Staged rows are kSlice + PAD
// floats (PAD a multiple of 4, so every row starts 16-byte aligned).
template <int ROWS = kTile, int PAD = kPadA>
struct DenseSpikes {
  static_assert(ROWS >= 1 && kTile % ROWS == 0, "ROWS must divide 128");
  static_assert(PAD % 4 == 0, "rows 16-byte aligned");
  const float* __restrict__ s;
  int64_t m, k;
  bool vec;
  static constexpr int kRow = kSlice + PAD;
  static constexpr int kStageBytes = ROWS * kRow * 4;

  // 16-byte copies: thread t takes chunks t + 256 i, unrolled, so a
  // slice's copies issue back to back (rolled, they cost kernel 12 3-5%
  // of its time and kernel 18 a sixth on an NVIDIA H100 80GB HBM3 at
  // 700 W), stepping one pointer a pass: per-pass offsets, which the
  // compiler keeps live across the compute, spilled kernel 12's 8 x 8
  // tile (ptxas, sm_90a). The 4-byte path is a plain loop.
  __device__ void issue(unsigned char* stage, int64_t m0, int64_t k0) const {
    float* a = reinterpret_cast<float*>(stage);
    constexpr int kChunks = ROWS * (kSlice / 4);
    if (vec) {
      constexpr int kStep = kThreads / (kSlice / 4);   // rows a pass
      const int r0 = threadIdx.x / (kSlice / 4);
      const int c = threadIdx.x % (kSlice / 4) * 4;
      const bool kin = k0 + c < k;
      const float* src = s + (m0 + r0) * k + k0 + c;
      float* dst = a + r0 * kRow + c;
      int64_t row = m0 + r0;
#pragma unroll
      for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
        if (kChunks % kThreads != 0 && r0 + kStep * i >= ROWS) break;
        const bool in = kin && row < m;
        cp16(dst, in ? src : s, in);
        src += kStep * k;
        dst += kStep * kRow;
        row += kStep;
      }
      return;
    }
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int r = e / (kSlice / 4), c = (e % (kSlice / 4)) * 4;
      const int64_t gr = m0 + r, gc = k0 + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = gr < m && gc + q < k;
        cp4(a + r * kRow + c + q, in ? s + gr * k + gc + q : s, in);
      }
    }
  }
};

// uint32 words of binary spikes (M, KW) row-major, bit i of word w =
// column 32w+i (core/spikes.py::pack_spikes). A kSlice-deep slice is one
// word per row, staged as is: no f32 spike tile is ever built. The CSR
// word kernel tests its rows' bits straight from the words
// (`add_word_slice`); the APEC kernels build bf16 fragments from them
// (csrc/tile_tc.cuh). Bits past K meet zero-filled weight rows.
template <int ROWS = kTile>
struct PackedSpikes {
  const uint32_t* __restrict__ p;
  int64_t m, kw;
  static constexpr int kStageBytes = ROWS * 4;

  __device__ void issue(unsigned char* stage, int64_t m0, int64_t k0) const {
    uint32_t* words = reinterpret_cast<uint32_t*>(stage);
    const int64_t gw = k0 / 32;
    for (int r = threadIdx.x; r < ROWS; r += kThreads) {
      const int64_t gr = m0 + r;
      const bool in = gr < m && gw < kw;
      cp4(words + r, in ? p + gr * kw + gw : p, in);
    }
  }
};

// ------------------------------------------------------- weight slices
// Staged rows are BN + PAD floats (PAD a multiple of 4).
template <int BN, int PAD = kPadB>
struct WeightSlice {
  static constexpr int kRow = BN + PAD;
  static constexpr int kStageBytes = kSlice * kRow * 4;

  // w[k0:k0+kSlice, n0:n0+BN] into `stage`, zeros past K and N. `vec`:
  // N % 4 == 0 and w 16-byte aligned; its 16-byte copies unrolled as the
  // spike loader's, one pointer stepped a pass where a pass covers whole
  // rows (BN = 32, 64, 128).
  __device__ static void issue(unsigned char* stage, const float* w,
                               int64_t k0, int64_t n0, int64_t k, int64_t n,
                               bool vec) {
    float* b = reinterpret_cast<float*>(stage);
    constexpr int kChunks = kSlice * (BN / 4);
    if (vec) {
      static_assert(kChunks % kThreads == 0, "whole passes of the block");
      if constexpr (kThreads % (BN / 4) == 0) {   // a pass: whole rows
        constexpr int kStep = kThreads / (BN / 4);
        const int r0 = threadIdx.x / (BN / 4);
        const int c = threadIdx.x % (BN / 4) * 4;
        const bool nin = n0 + c < n;
        const float* src = w + (k0 + r0) * n + n0 + c;
        float* dst = b + r0 * kRow + c;
        int64_t row = k0 + r0;
#pragma unroll
        for (int i = 0; i < kChunks / kThreads; ++i) {
          const bool in = nin && row < k;
          cp16(dst, in ? src : w, in);
          src += kStep * n;
          dst += kStep * kRow;
          row += kStep;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kChunks / kThreads; ++i) {
          const int e = threadIdx.x + kThreads * i;
          const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
          const int64_t gk = k0 + r, gn = n0 + c;
          const bool in = gk < k && gn < n;
          cp16(b + r * kRow + c, in ? w + gk * n + gn : w, in);
        }
      }
      return;
    }
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const int64_t gk = k0 + r, gn = n0 + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = gk < k && gn + q < n;
        cp4(b + r * kRow + c + q, in ? w + gk * n + gn + q : w, in);
      }
    }
  }
};

// ------------------------------------------------------------- compute
// The CSR kernels' thread tile: RM rows x CN columns, the columns in CN/4
// runs of 4. Thread t is column group cg = t % G and row group
// rg = t / G (G = BN / CN column groups, RG = 128 / RM row groups,
// G * RG = 256); it holds rows rg + RG i and columns 4 cg + 4 G q + 0..3.
// A warp's weight reads for one run are then G consecutive 16-byte chunks
// (LDS.128 without bank conflicts, broadcast over its row groups), and
// its spike reads (f32) or bit tests (words) of one row serve CN >= 8
// columns.
template <int BN>
struct ThreadTile {
  static constexpr int kRM = BN == 128 ? 8 : BN == 32 ? 2 : 4;
  static constexpr int kCN = BN == 96 ? 12 : 8;
  static constexpr int kG = BN / kCN;
  static constexpr int kRG = kTile / kRM;
  static constexpr int kRuns = kCN / 4;
  static_assert(kG * kRG == kThreads && kG * kCN == BN, "256 threads");
};

template <int BN>
using TileAcc = float4[ThreadTile<BN>::kRM][ThreadTile<BN>::kRuns];

// acc += a * w lane by lane, one fmaf a lane.
__device__ __forceinline__ void fma4(float a, const float4& w, float4& acc) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// The spike at column u of a four-column piece.
__device__ __forceinline__ float piece_at(const float4& p, int u) {
  return u == 0 ? p.x : u == 1 ? p.y : u == 2 ? p.z : p.w;
}

// acc += f32 spike slice @ weight slice for this thread: each output an
// fmaf chain in k order, one rounding a product, as kernel 11 and cuBLAS
// fp32 sum it; any spike value (the coded conv's multi-bit drive), no
// test of it. Per 4 k-columns: one LDS.128 of each row's piece, then per
// column the CN/4 weight runs and RM x CN fmafs.
template <int BN>
__device__ __forceinline__ void fma_tile_slice(const unsigned char* a_stage,
                                               const unsigned char* b_stage,
                                               TileAcc<BN>& acc) {
  using T = ThreadTile<BN>;
  constexpr int kRowA = DenseSpikes<>::kRow;
  constexpr int kRow = WeightSlice<BN>::kRow;
  const int cg = threadIdx.x % T::kG, rg = threadIdx.x / T::kG;
  const float* a = reinterpret_cast<const float*>(a_stage) + rg * kRowA;
  const float* b = reinterpret_cast<const float*>(b_stage) + 4 * cg;
  auto piece = [&](int c0) {      // k columns c0 .. c0 + 3
    float4 av[T::kRM];
#pragma unroll
    for (int i = 0; i < T::kRM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + T::kRG * i * kRowA + c0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 wv[T::kRuns];
#pragma unroll
      for (int q = 0; q < T::kRuns; ++q)
        wv[q] = *reinterpret_cast<const float4*>(b + (c0 + u) * kRow +
                                                 4 * T::kG * q);
#pragma unroll
      for (int i = 0; i < T::kRM; ++i) {
        const float s = piece_at(av[i], u);
#pragma unroll
        for (int q = 0; q < T::kRuns; ++q) fma4(s, wv[q], acc[i][q]);
      }
    }
  };
  if constexpr (T::kRM == 8) {   // 64 sums and 32 spikes: unrolled 2
#pragma unroll 1                 // deep, the 8 x 8 tile spilled (ptxas)
    for (int c0 = 0; c0 < kSlice; c0 += 4) piece(c0);
  } else {
#pragma unroll 2
    for (int c0 = 0; c0 < kSlice; c0 += 4) piece(c0);
  }
}

// acc += w, each lane of the four rounded on its own, where `bit` is not
// 0; nothing where it is: predicated adds, no branch and no float made of
// the bit.
__device__ __forceinline__ void add_if(uint32_t bit, float4& acc,
                                       const float4& w) {
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %8, 0;\n\t"
      "@p add.rn.f32 %0, %0, %4;\n\t@p add.rn.f32 %1, %1, %5;\n\t"
      "@p add.rn.f32 %2, %2, %6;\n\t@p add.rn.f32 %3, %3, %7;\n\t}"
      : "+f"(acc.x), "+f"(acc.y), "+f"(acc.z), "+f"(acc.w)
      : "f"(w.x), "f"(w.y), "f"(w.z), "f"(w.w), "r"(bit));
}

// acc += word slice @ weight slice for this thread: a set bit c of row
// i's word adds weight row c to acc[i], a clear one adds nothing. Since
// fadd(acc, w) = fmaf(1, w, acc) and fmaf(0, w, acc) = acc, each output is
// the f32 kernel's fmaf chain in k order, bit for bit. Rounds of 8 k
// columns, the words shifted 8 bits a round, so every test is a constant
// mask; the slice's four rounds unrolled but at BN = 128.
template <int BN>
__device__ __forceinline__ void add_word_slice(const unsigned char* a_stage,
                                               const unsigned char* b_stage,
                                               TileAcc<BN>& acc) {
  using T = ThreadTile<BN>;
  constexpr int kRow = WeightSlice<BN>::kRow;
  const int cg = threadIdx.x % T::kG, rg = threadIdx.x / T::kG;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(a_stage) + rg;
  const float* b = reinterpret_cast<const float*>(b_stage) + 4 * cg;
  uint32_t bits[T::kRM];
#pragma unroll
  for (int i = 0; i < T::kRM; ++i) bits[i] = words[T::kRG * i];
  auto round = [&](int c0) {      // k columns c0 .. c0 + 7
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float4 wv[T::kRuns];
#pragma unroll
      for (int q = 0; q < T::kRuns; ++q)
        wv[q] = *reinterpret_cast<const float4*>(b + (c0 + u) * kRow +
                                                 4 * T::kG * q);
#pragma unroll
      for (int i = 0; i < T::kRM; ++i) {
        const uint32_t bit = bits[i] & (1u << u);
#pragma unroll
        for (int q = 0; q < T::kRuns; ++q) add_if(bit, acc[i][q], wv[q]);
      }
    }
#pragma unroll
    for (int i = 0; i < T::kRM; ++i) bits[i] >>= 8;
  };
  if constexpr (BN == 128) {     // fully unrolled, the 8 x 8 tile ran
#pragma unroll 1                 // slower on the H100
    for (int c0 = 0; c0 < kSlice; c0 += 8) round(c0);
  } else {
#pragma unroll
    for (int c0 = 0; c0 < kSlice; c0 += 8) round(c0);
  }
}

// out[m0.., n0..] = acc for this thread, masked to (m, n); float4 stores
// where N % 4 == 0 and out is 16-byte aligned (a run then lies wholly
// inside N or past it).
template <int BN>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           int64_t m0, int64_t n0, int64_t m,
                                           int64_t n, const TileAcc<BN>& acc) {
  using T = ThreadTile<BN>;
  const int cg = threadIdx.x % T::kG, rg = threadIdx.x / T::kG;
  const bool vec = n % 4 == 0 && (uintptr_t)out % 16 == 0;
#pragma unroll
  for (int i = 0; i < T::kRM; ++i) {
    const int64_t r = m0 + rg + T::kRG * i;
    if (r >= m) continue;
#pragma unroll
    for (int q = 0; q < T::kRuns; ++q) {
      const int64_t c = n0 + 4 * cg + 4 * T::kG * q;
      float* o = out + r * n + c;
      const float4 v = acc[i][q];
      if (vec) {
        if (c < n) *reinterpret_cast<float4*>(o) = v;
      } else {
        if (c < n) o[0] = v.x;
        if (c + 1 < n) o[1] = v.y;
        if (c + 2 < n) o[2] = v.z;
        if (c + 3 < n) o[3] = v.w;
      }
    }
  }
}

// The card's SM count, read once per process (the pickers below run on
// every launch; the port's cards are all alike).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return sms;
}

// The n-tile width for whole waves: the one of 128, 96, 64, 32 (up to
// `max_bn`) with the least estimated time, ceil(blocks / (per_sm * SMs))
// waves times (BN + 32) (a block's adds or MMAs and its weight copies grow
// with its columns; its spike copies, bit tests and barriers do not), the
// wider on a tie. `per_sm`: the blocks an SM holds (the kernel's
// __launch_bounds__). The APEC kernels 18 / 16 take it at one block an SM,
// the CSR kernels 12 and 14 at two. fc2's 64 m-tiles x N = 384 take
// BN = 96, 256 blocks, in all: whole waves on 132 SMs, where 128 (one
// block an SM) and 64 (two) leave 1.45 waves.
inline int pick_bn_waves(int64_t n, int64_t mt, int per_sm,
                         int max_bn = 128) {
  const int64_t slots = (int64_t)per_sm * sm_count();
  int best = 0;
  int64_t best_cost = 0;
  for (int bn : {128, 96, 64, 32}) {
    if (bn > max_bn) continue;
    const int64_t blocks = mt * ((n + bn - 1) / bn);
    const int64_t cost = (blocks + slots - 1) / slots * (bn + 32);
    if (best == 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace tile_mma
