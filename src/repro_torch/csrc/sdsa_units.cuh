// What the two SDSA kernels (csrc/sdsa.cu, csrc/sdsa_causal.cu) share:
// the operand layout the wrappers describe (kernels/sdsa_kernel.py
// `_describe`), and the unit a thread owns of a token row.
//
// A unit is 16 bytes of spikes (4 f32 or 8 bf16 channels, one vector
// load), one spike (the scalar path, where a row or a stride is not a
// multiple of 16 bytes), or one uint32 word of 32 packed channels (the
// TPU rows' word entries). `mask` turns a unit into a channel mask (bit e
// for element e; a word is its own mask) and `expand` a mask back into a
// unit of ones and zeros, so the kernels scan and AND masks in registers
// and touch device memory only to read the spikes and write the result.
// "Spike" means nonzero, as `pack_spikes` reads it: the sign bit is
// masked off, so -0 is no spike and NaN is one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sdsa {

constexpr int kThreads = 256;      // threads a block
constexpr int kMaxUnitBlock = 64;  // units a block spans across a row

enum Kind : int { kF32 = 0, kBF16 = 1, kWords = 2 };

// Element strides of the four operands (0 q, 1 k, 2 v, 3 out): the
// micro-step axis t (the causal form folds it), up to three leading
// axes, the token axis n, and c channels at unit stride.
struct Layout {
  int64_t t, r1, r2, r3, n, c;
  int64_t st[4], s1[4], s2[4], s3[4], sn[4];
};

// The wrappers' descriptor: kind, vec, unit block, a plan value (the OR
// form's token groups, the causal form's chunk of tokens), then t, r1,
// r2, r3, n, c and each operand's (st, s1, s2, s3, sn).
constexpr int kDescHead = 4;
constexpr int kDescLen = kDescHead + 6 + 4 * 5;

inline Layout read_layout(const int64_t* d) {
  Layout g;
  const int64_t* s = d + kDescHead;
  g.t = s[0]; g.r1 = s[1]; g.r2 = s[2]; g.r3 = s[3]; g.n = s[4]; g.c = s[5];
  for (int o = 0; o < 4; ++o) {
    const int64_t* p = s + 6 + 5 * o;
    g.st[o] = p[0]; g.s1[o] = p[1]; g.s2[o] = p[2]; g.s3[o] = p[3];
    g.sn[o] = p[4];
  }
  return g;
}

inline bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

// A vector unit needs 16-byte aligned bases and every stride and the
// row width in whole vectors; the wrapper chose the path, this checks it.
inline bool vectors_fit(const Layout& g, const void* const* ptrs,
                        int64_t elems, int64_t elem_bytes) {
  if (g.c % elems) return false;
  for (int o = 0; o < 4; ++o) {
    if (ptrs[o] && reinterpret_cast<uintptr_t>(ptrs[o]) % 16) return false;
    if ((g.st[o] | g.s1[o] | g.s2[o] | g.s3[o] | g.sn[o]) % elems)
      return false;
  }
  return elems * elem_bytes == 16;
}

// Offsets of one leading row in each operand (the row index split into
// its three axes once a block).
__device__ __forceinline__ void row_offsets(const Layout& g, int64_t row,
                                            int64_t off[4]) {
  const int64_t r3 = row % g.r3, rest = row / g.r3;
  const int64_t r2 = rest % g.r2, r1 = rest / g.r2;
#pragma unroll
  for (int o = 0; o < 4; ++o)
    off[o] = r1 * g.s1[o] + r2 * g.s2[o] + r3 * g.s3[o];
}

template <int kKind> struct Format;
template <> struct Format<kF32> {
  using Elem = uint32_t;
  static constexpr uint32_t kMag = 0x7fffffffu, kOne = 0x3f800000u;
};
template <> struct Format<kBF16> {
  using Elem = uint16_t;
  static constexpr uint32_t kMag = 0x7fffu, kOne = 0x3f80u;
};
template <> struct Format<kWords> {
  using Elem = uint32_t;
  static constexpr uint32_t kMag = 0xffffffffu, kOne = 0u;
};

template <int kKind, bool kVec>
struct Unit {
  using Elem = typename Format<kKind>::Elem;
  static constexpr bool kWord = kKind == kWords;
  static_assert(!(kWord && kVec), "word units are one word");
  static constexpr int kPerLane = 4 / sizeof(Elem);  // elements a 32-bit lane
  static constexpr int kElems = kVec ? 4 * kPerLane : 1;
  using Raw = typename std::conditional<kVec, uint4, Elem>::type;

  __device__ static __forceinline__ Raw zero() { return Raw{}; }

  __device__ static __forceinline__ Raw load(const void* base, int64_t off) {
    return __ldg(reinterpret_cast<const Raw*>(
        static_cast<const Elem*>(base) + off));
  }

  __device__ static __forceinline__ void store(void* base, int64_t off,
                                               Raw x) {
    *reinterpret_cast<Raw*>(static_cast<Elem*>(base) + off) = x;
  }

  __device__ static __forceinline__ uint32_t mask(Raw x) {
    if constexpr (kWord) {
      return x;
    } else if constexpr (!kVec) {
      return (x & Format<kKind>::kMag) != 0u;
    } else {
      const uint32_t lane[4] = {x.x, x.y, x.z, x.w};
      uint32_t m = 0u;
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          m |= (uint32_t)(((lane[l] >> (16 * e)) & Format<kKind>::kMag) !=
                          0u) << (l * kPerLane + e);
      return m;
    }
  }

  __device__ static __forceinline__ Raw expand(uint32_t m) {
    if constexpr (kWord) {
      return m;
    } else if constexpr (!kVec) {
      return (m & 1u) ? (Elem)Format<kKind>::kOne : (Elem)0;
    } else {
      uint32_t lane[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        lane[l] = 0u;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          if ((m >> (l * kPerLane + e)) & 1u)
            lane[l] |= Format<kKind>::kOne << (16 * e);
      }
      return make_uint4(lane[0], lane[1], lane[2], lane[3]);
    }
  }
};

}  // namespace sdsa
