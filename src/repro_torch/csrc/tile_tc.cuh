// The tensor-core tile code of the pipelined APEC matmuls
// (csrc/apec_matmul_csr_pipe.cu): binary spikes as bf16 A fragments times
// an exact three-way bf16 split of the fp32 weights, on
// mma.sync.aligned.m16n8k16 (bf16 x bf16 -> fp32), fed from
// csrc/tile_mma.cuh's cp.async ring. Nothing here is instantiated by the
// CSR kernels (csrc/spike_matmul_csr_pipe.cu), which keep their fmaf
// chain.
//
// The split: an fp32 weight w is hi + mid + lo exactly, hi = RN_bf16(w),
// mid = RN_bf16(w - hi), lo = RN_bf16(w - hi - mid). Each part holds the
// next 8 significant bits of w's 24, so both subtractions are exact in
// fp32 and lo is exactly w - hi - mid (for |w| >= 2^-100 every part is a
// normal number). The spike operand must be exact in bf16: 0 and 1, or
// small integers (|s| <= 256) in the f32 operand. A product of a spike
// and a part is then exact in the tensor core, and the only rounding left
// is the fp32 accumulation.
//
// Summation order, per output fragment and ring slice (32 deep = two k16
// steps): six MMAs from zero, smallest part first (lo k0, lo k1, mid k0,
// mid k1, hi k0, hi k1), then one fp32 add (CUDA cores, round to
// nearest) of that slice sum into the running accumulator. The tensor
// core's own fp32 additions truncate, so starting each slice from zero
// keeps them from piling up over K. Both spike loaders build the same A
// bits (0x3F80 for a 1), so the f32 and word kernels sum identically.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 gid + tig;
// A a0..a3 = (row gid, k 2tig..+1), (row gid+8, k 2tig..+1),
// (row gid, k 2tig+8..+9), (row gid+8, k 2tig+8..+9), low half the lower
// k; B b0, b1 = (k 2tig..+1, n gid), (k 2tig+8..+9, n gid); C c0..c3 =
// (row gid, n 2tig..+1), (row gid+8, n 2tig..+1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace tile_tc {

using tile_mma::kSlice;
using tile_mma::kTile;

// Row pads of the staged slices, chosen for conflict-free fragment
// reads: f32 spike rows of 40 floats (a quarter warp's 8-byte A reads
// land on 8 distinct bank pairs), weight rows of BN + 4 floats (the 4
// k rows a warp reads per column land 8 banks apart).
constexpr int kPadA = 8;
constexpr int kPadB = 4;

// ------------------------------------------------------------- copies
// The loaders of csrc/tile_mma.cuh (their 16-byte copies unrolled, one
// pointer stepped a pass) with the padded rows above.
template <int ROWS>
using Dense = tile_mma::DenseSpikes<ROWS, kPadA>;

template <int ROWS>
using Packed = tile_mma::PackedSpikes<ROWS>;

template <int BN>
using Weights = tile_mma::WeightSlice<BN, kPadB>;

// ---------------------------------------------------------- work list
// One m-tile row's union work list, staged in shared memory once per
// block (its first kListCap steps, each (kidx << 2) | live mask; later
// steps are read from global memory), and walked as RowCursor walks it:
// dead steps issue nothing, a live step's 32-deep slices run up to K.
constexpr int kListCap = 64;

__device__ __forceinline__ int list_entry(const tile_mma::UnionGate& gate,
                                          const int* __restrict__ kidx,
                                          int step) {
  return (kidx[step] << 2) | (int)gate.live(step);
}

struct ListCursor {
  const int* list;                     // shared: the row's first steps
  tile_mma::UnionGate gate;
  const int* __restrict__ kidx;
  int beg, step, end, kk, kt;
  unsigned live;
  int64_t k;

  __device__ ListCursor(const int* list_, tile_mma::UnionGate gate_,
                        const int* kidx_, int beg_, int end_, int64_t k_)
      : list(list_), gate(gate_), kidx(kidx_), beg(beg_), step(beg_),
        end(end_), kk(0), kt(0), live(0), k(k_) {
    settle();
  }
  __device__ void settle() {
    for (; step < end; ++step) {
      const int v = step - beg < kListCap ? list[step - beg]
                                          : list_entry(gate, kidx, step);
      if ((live = (unsigned)v & 3u) != 0u) {
        kt = v >> 2;
        break;
      }
    }
    kk = 0;
  }
  __device__ bool valid() const { return step < end; }
  __device__ int64_t k0() const { return (int64_t)kt * kTile + kk; }
  __device__ void next() {
    kk += kSlice;
    if (kk >= kTile || k0() >= k) {
      ++step;
      settle();
    }
  }
};

constexpr int kKSteps = kSlice / 16;   // k16 steps a slice
constexpr int kParts = 3;              // lo, mid, hi

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> three bf16x2 words, part p = 0 lo, 1 mid, 2 hi; x0 in the
// low half of each.
__device__ __forceinline__ void split3(float x0, float x1,
                                       uint32_t (&part)[kParts]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(hi), r1 = x1 - __high2float(hi);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(r0 - __low2float(mid),
                                                  r1 - __high2float(mid));
  part[0] = bits(lo);
  part[1] = bits(mid);
  part[2] = bits(hi);
}

// One n8 column tile's B fragments over a slice, split: b[part][ks][reg].
struct BFrag {
  uint32_t b[kParts][kKSteps][2];
};

// Column `col` of the staged weight slice (rows of kRow floats).
template <int kRow>
__device__ __forceinline__ void load_b(const float* ws, int col, int tig,
                                       BFrag& f) {
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = ws + (16 * ks + 8 * h + 2 * tig) * kRow + col;
      uint32_t part[kParts];
      split3(p[0], p[kRow], part);
#pragma unroll
      for (int q = 0; q < kParts; ++q) f.b[q][ks][h] = part[q];
    }
}

// A fragments of the m16 tile at stage rows r0..r0+15 over a slice:
// a[ks][reg]. Rows at or past ROWS (fewer than 16 overlap rows, g >= 16)
// are zeros and are not read.
template <int ROWS>
__device__ __forceinline__ void load_a(const Dense<ROWS>&,
                                       const unsigned char* stage, int r0,
                                       int gid, int tig,
                                       uint32_t (&a)[kKSteps][4]) {
  constexpr int kRow = Dense<ROWS>::kRow;
  const float* s = reinterpret_cast<const float*>(stage);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gid + 8 * h;
    const bool in = ROWS >= 16 || row < ROWS;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t v = 0u;
        if (in) {
          const float2 x = *reinterpret_cast<const float2*>(
              s + row * kRow + 16 * ks + 8 * c + 2 * tig);
          v = bits(__floats2bfloat162_rn(x.x, x.y));
        }
        a[ks][h + 2 * c] = v;
      }
  }
}

// The same from one uint32 word a row: bit c of the word is column c of
// the slice, and a bit pair becomes a bf16x2 of 0 / 1 (0x3F80) values.
template <int ROWS>
__device__ __forceinline__ void load_a(const Packed<ROWS>&,
                                       const unsigned char* stage, int r0,
                                       int gid, int tig,
                                       uint32_t (&a)[kKSteps][4]) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gid + 8 * h;
    const uint32_t word =
        (ROWS >= 16 || row < ROWS) ? words[row] >> (2 * tig) : 0u;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t t = word >> (16 * ks + 8 * c);
        a[ks][h + 2 * c] = ((t & 1u) | ((t << 15) & 0x10000u)) * 0x3F80u;
      }
  }
}

// d = a * b + c on the tensor cores (m16n8k16, bf16 in, fp32 sum).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b from zero.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// acc += the slice's product for one m16 tile x NJ n8 tiles: each
// fragment's six MMAs from zero, smallest part first, then one fp32 add
// per element. The chain step is the outer loop, so the NJ independent
// chains interleave in issue order.
template <int NJ>
__device__ __forceinline__ void mma_tile(float (&acc)[NJ][4],
                                         const uint32_t (&a)[kKSteps][4],
                                         const BFrag (&f)[NJ]) {
  float p[NJ][4];
#pragma unroll
  for (int q = 0; q < kParts; ++q)
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (q == 0 && ks == 0)
          mma0(p[j], a[0], f[j].b[0][0][0], f[j].b[0][0][1]);
        else
          mma(p[j], a[ks], f[j].b[q][ks][0], f[j].b[q][ks][1]);
      }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
}

}  // namespace tile_tc
