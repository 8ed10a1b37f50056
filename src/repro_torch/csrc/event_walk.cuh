// The event walk of the serial spike matmuls: the CSR kernels 11 and 13
// (csrc/spike_matmul_csr.cu) and the APEC kernels 17 and 15
// (csrc/apec_matmul_csr.cu). Each adds one weight row to an output row
// for every nonzero spike of a live work-list step, in k order.
//
// A block owns one 128-row m-tile x BN output columns and runs 16 warps;
// a warp walks one spike row of the step at a time and its lanes split
// the BN columns, four a lane (an LDS.128 of the staged weight row per
// event). The step's weights w[k0:k0+128, n0:n0+BN] are staged in shared
// memory with 16-byte cp.async (`stage_weights`), double-buffered across
// live steps by the kernels. A row's spikes of a step are four 32-bit
// words: on uint32 words a lane loads one (row, word) (`load_words`); on
// f32 spikes the warp loads a row's 128 values coalesced and takes
// `__ballot_sync(x != 0)`. A binary row's events go in order to an event
// list in shared memory (`walk_binary`: the row's words in every lane,
// by shuffle or ballot, each lane placing its own columns' bits at their
// ranks; the CSR kernel on words builds all of a warp's rows' lists at
// once instead), and the list is read four indices at a time, four
// LDS.128 in flight, then their adds in order (`walk_list`); a row
// holding other values (counts, a coded drive) walks its bits one at a
// time with the value by `__shfl_sync` (`walk_valued`). The loops stay
// rolled: unrolled, they ran no faster and held more registers.
//
// Numbers: each output is the dense loop's fmaf chain, acc = fmaf(v,
// w[k][c], acc) in k order (the work list's steps ascend in k, the events
// within a step), v the f32 spike or 1.0 on words (fadd(acc, w) =
// fmaf(1, w, acc)). A zero spike is skipped: fmaf(0, w, acc) leaves acc
// as it is for finite w, and acc is never -0 (it starts at +0). So the
// walk equals the dense chain bit for bit, and the f32 and word kernels
// equal each other, for finite weights.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace event_walk {

constexpr int kTile = 128;                 // map tile (rows and k)
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsW = kTile / kWarps;     // rows of the m-tile a warp
constexpr int kWords = kTile / 32;         // spike words a row a step
constexpr int kBatch = 4;                  // weight rows loaded at once
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRowsW * kWords == 32, "a row's word a lane a step");

__device__ __forceinline__ void add4(float4& acc, const float4& b) {
  acc.x += b.x;
  acc.y += b.y;
  acc.z += b.z;
  acc.w += b.w;
}

// acc += v_j * w[j] for each set bit j of `bits`, in ascending j, v_j
// being lane j's `x` (f32 spikes of any value), one event at a time; `wq`
// points at this lane's four columns of the slice's first weight row.
__device__ __forceinline__ void walk_valued(uint32_t bits, float x,
                                            const float* wq, int bn,
                                            float4& acc) {
#pragma unroll 1
  while (bits) {
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    const float v = __shfl_sync(kFull, x, j);
    const float4 b = *reinterpret_cast<const float4*>(wq + j * bn);
    acc.x = fmaf(v, b.x, acc.x);
    acc.y = fmaf(v, b.y, acc.y);
    acc.z = fmaf(v, b.z, acc.z);
    acc.w = fmaf(v, b.w, acc.w);
  }
}

// acc += w[list[e]] for e = 0 .. count-1 in order (binary spikes;
// fadd(acc, w) = fmaf(1, w, acc)), `list` a warp's event list in shared
// memory (columns within the step, ascending), `wt` this lane's four
// columns of the step's first weight row: every lane reads the list B
// indices at a time and adds their weight rows in order, B loads in
// flight, then the rest one at a time (a warp waits out each load).
template <int B>
__device__ __forceinline__ void walk_list(const uint8_t* list, int count,
                                          const float* wt, int bn,
                                          float4& acc) {
  static_assert(B == 2 || B == 4, "a batch is one 16- or 32-bit list read");
  int e = 0;
#pragma unroll 1
  for (; e + B <= count; e += B) {
    const uint32_t js = B == 4 ? *reinterpret_cast<const uint32_t*>(list + e)
                               : *reinterpret_cast<const uint16_t*>(list + e);
    float4 b[B];
#pragma unroll
    for (int u = 0; u < B; ++u)
      b[u] = *reinterpret_cast<const float4*>(wt + (js >> 8 * u & 0xffu) * bn);
#pragma unroll
    for (int u = 0; u < B; ++u) add4(acc, b[u]);
  }
#pragma unroll 1
  for (; e < count; ++e)
    add4(acc, *reinterpret_cast<const float4*>(wt + list[e] * bn));
}

// acc += w[j] for each set bit j of a row's step words `bits`, in
// ascending j: the warp first writes the row's events to its `list` in
// shared memory, each lane placing its own columns' set bits at their
// ranks, then walks the list (`walk_list`).
template <int B>
__device__ __forceinline__ void walk_binary(const uint32_t (&bits)[kWords],
                                            uint8_t* list, const float* wt,
                                            int bn, float4& acc) {
  const int lane = threadIdx.x % 32;
  const uint32_t below = (1u << lane) - 1u;
  int count = 0;
  __syncwarp();                  // the warp's last walk has read the list
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    if (bits[q] >> lane & 1u)
      list[count + __popc(bits[q] & below)] = (uint8_t)(32 * q + lane);
    count += __popc(bits[q]);
  }
  __syncwarp();
  walk_list<B>(list, count, wt, bn, acc);
}

// Stages w[k0:k0+128, n0:n0+bn] into `dst` (rows of bn floats), zeros
// past K and N; one cp.async group's copies. `vec`: N % 4 == 0 and w
// 16-byte aligned, else 4-byte copies.
__device__ __forceinline__ void stage_weights(float* dst,
                                              const float* __restrict__ w,
                                              int64_t k0, int64_t n0,
                                              int64_t k, int64_t n, int bn,
                                              bool vec) {
  const int per_row = bn / 4;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    const int r = e / per_row, c = e % per_row * 4;
    const int64_t gk = k0 + r, gn = n0 + c;
    float* d = dst + r * bn + c;
    if (vec) {
      const bool in = gk < k && gn < n;
      tile_mma::cp16(d, in ? w + gk * n + gn : w, in);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = gk < k && gn + u < n;
        tile_mma::cp4(d + u, in ? w + gk * n + gn + u : w, in);
      }
    }
  }
  tile_mma::commit();
}

// Words: this lane's (row, word) of the step at k0 for the operand at
// `s` (rows from `row0`, `nrows` of them in the tile): lane l holds row
// warp + 16 (l / 4)'s word l % 4; zero where the operand is dead (`live`
// false) or the row or word lies past it.
__device__ __forceinline__ uint32_t load_words(const uint32_t* __restrict__ s,
                                               int64_t rows, int64_t kw,
                                               int64_t row0, int nrows,
                                               int64_t k0, bool live) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp + kWarps * (lane / kWords);
  const int64_t row = row0 + r, gw = k0 / 32 + lane % kWords;
  return live && r < nrows && row < rows && gw < kw ? __ldg(s + row * kw + gw)
                                                    : 0u;
}

// A row's step words from `word` (this lane's (row, word), `load_words`'
// layout): row i of the warp is lanes 4i .. 4i+3; words past the step's
// `left` live columns read as zero.
__device__ __forceinline__ void row_words(uint32_t (&bits)[kWords],
                                          uint32_t word, int i,
                                          int64_t left) {
#pragma unroll
  for (int q = 0; q < kWords; ++q)
    bits[q] = 32 * q < left ? __shfl_sync(kFull, word, kWords * i + q) : 0u;
}

// Walks one row's step of f32 spikes `x` (lane l holds columns 32 q + l):
// a binary row walks its event list, a row holding any other value walks
// with the values.
template <int B>
__device__ __forceinline__ void walk_f32_row(const float (&x)[kWords],
                                             uint8_t* list, const float* wt,
                                             int bn, float4& acc) {
  uint32_t bits[kWords];
  bool valued = false;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    bits[q] = __ballot_sync(kFull, x[q] != 0.0f);
    valued |= x[q] != 0.0f && x[q] != 1.0f;
  }
  if (__any_sync(kFull, valued)) {
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      walk_valued(bits[q], x[q], wt + 32 * q * bn, bn, acc);
  } else {
    walk_binary<B>(bits, list, wt, bn, acc);
  }
}

// Writes a lane's four columns of an output row: a float4 store where
// `vec` (N % 4 == 0 and out 16-byte aligned), else the columns before N.
__device__ __forceinline__ void store4(float* dst, const float4& v,
                                       int64_t col, int64_t n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (col + u < n) dst[u] = vs[u];
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace event_walk
