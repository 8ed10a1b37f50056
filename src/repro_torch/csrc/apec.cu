// APEC overlap/residual decomposition: for each group of g adjacent rows,
// overlap = AND of the rows, residual_i = s_i AND NOT overlap (the paper's
// Eq. 1 and Fig. 5).
//
// Replaces: src/repro/kernels/apec_kernel.py::_apec_kernel
//           (apec_decompose_packed), on uint32 words of 32 channels (the
//           word entry, the TPU row's own function) and, in the same
//           template, on the f32 / bf16 spikes themselves (the spike
//           entry, which the port's dense APEC route calls).
// Bound on the H100: bytes. It reads the P rows once and writes P
//           residual rows and P/g overlap rows once; the work is g-1 ANDs
//           and g AND-NOTs per group and channel (or word).
// Design:   the TPU kernel took words, so the dense route used to pad C
//           to 32, pack through int64 bit tensors, launch, and unpack
//           both outputs twice over (0.4-2.5 ms a call around a 0.02 ms
//           kernel). The spike entry reads the (P, C) spikes where they
//           lie (unit channel stride, any row stride: the callers'
//           `reshape(-1, C)` views) and writes the overlap and residual as
//           ones and zeros in the input's type, which is what the APEC
//           matmul kernels read. One template serves both entries: a
//           thread owns one unit of a group (16 bytes of channels: 4 f32,
//           8 bf16 or 4 words; narrower where C, a row stride or a
//           pointer does not allow it), issues the g loads of its group's
//           rows before the first AND, and turns spikes into a channel
//           mask (`bits`) and the result back into spikes (`unit`); a word
//           is its own mask. One unit a thread, so the grid fills all 132
//           SMs in waves of blocks, and neighbouring threads own
//           neighbouring units of a row, so loads and stores coalesce. g
//           is a template parameter for 2, 4 and 8, where the g loads sit
//           in registers; any other g (1, 3, 16, 128, ...) is a run-time
//           bound: the AND pass loads kBatch rows at a time, and the
//           residual pass reads the group's rows again (from L1) as it
//           writes them. "Spike" means nonzero as `pack_spikes` reads it:
//           the sign bit is masked off, so -0 is no spike and NaN is one.
//           The TPU cut the words into (g*8, 128) blocks and needed its
//           wrapper's padding; here only P % g == 0 is required.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace apec {
namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535LL * 32;
constexpr int kBatch = 4;   // rows whose loads a run-time g issues together

enum Kind : int { kF32 = 0, kBF16 = 1, kWords = 2 };

template <int kBytes> struct RawOf;
template <> struct RawOf<16> { using T = uint4; };
template <> struct RawOf<8> { using T = uint2; };
template <> struct RawOf<4> { using T = uint32_t; };
template <> struct RawOf<2> { using T = uint16_t; };

template <int kKind> struct Format;
template <> struct Format<kF32> {
  static constexpr int kBytes = 4;
  static constexpr uint32_t kMag = 0x7fffffffu, kOne = 0x3f800000u;
};
template <> struct Format<kBF16> {
  static constexpr int kBytes = 2;
  static constexpr uint32_t kMag = 0x7fffu, kOne = 0x3f80u;
};
template <> struct Format<kWords> {
  static constexpr int kBytes = 4;
  static constexpr uint32_t kMag = 0xffffffffu, kOne = 0u;
};

__device__ __forceinline__ uint32_t and_(uint32_t a, uint32_t b) {
  return a & b;
}
__device__ __forceinline__ uint32_t andnot(uint32_t a, uint32_t b) {
  return a & ~b;
}
__device__ __forceinline__ uint2 and_(uint2 a, uint2 b) {
  return make_uint2(a.x & b.x, a.y & b.y);
}
__device__ __forceinline__ uint2 andnot(uint2 a, uint2 b) {
  return make_uint2(a.x & ~b.x, a.y & ~b.y);
}
__device__ __forceinline__ uint4 and_(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 andnot(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

// kBytes of one row a thread owns: a vector or one element of spikes, or
// 1, 2 or 4 words. `bits` is its channel mask (bit e for element e; words
// are their own bits), `unit` the inverse for ones and zeros.
template <int kKind, int kBytes>
struct Unit {
  using Raw = typename RawOf<kBytes>::T;
  static constexpr bool kWord = kKind == kWords;
  static constexpr int kElemBytes = Format<kKind>::kBytes;
  static constexpr int kElems = kBytes / kElemBytes;
  static constexpr int kPerLane = 4 / kElemBytes;   // elements a 32-bit lane
  static_assert(kWord || kBytes == 16 || kBytes == kElemBytes,
                "a spike unit is 16 bytes or one element");
  using Bits = typename std::conditional<kWord, Raw, uint32_t>::type;

  __device__ static __forceinline__ Raw load(const void* base, int64_t off) {
    return __ldg(reinterpret_cast<const Raw*>(
        static_cast<const char*>(base) + off * kElemBytes));
  }

  __device__ static __forceinline__ void store(void* base, int64_t off,
                                               Raw x) {
    *reinterpret_cast<Raw*>(static_cast<char*>(base) + off * kElemBytes) = x;
  }

  __device__ static __forceinline__ Bits bits(Raw x) {
    if constexpr (kWord) {
      return x;
    } else if constexpr (kBytes == kElemBytes) {
      return ((uint32_t)x & Format<kKind>::kMag) != 0u;
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

  __device__ static __forceinline__ Raw unit(Bits m) {
    if constexpr (kWord) {
      return m;
    } else if constexpr (kBytes == kElemBytes) {
      return (Raw)((m & 1u) ? Format<kKind>::kOne : 0u);
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

// s: groups*g rows of `units` units, `stride` elements apart; ov (groups,
// c) and res (groups*g, c) contiguous, c = units * kElems. G > 0 fixes g
// at compile time; G == 0 reads it from g_rt.
template <int kKind, int kBytes, int G>
__global__ void __launch_bounds__(kThreads)
apec_kernel(const void* __restrict__ s, void* __restrict__ ov,
            void* __restrict__ res, int64_t groups, int64_t units,
            int64_t stride, int g_rt) {
  using U = Unit<kKind, kBytes>;
  using Raw = typename U::Raw;
  using Bits = typename U::Bits;
  const int g = G > 0 ? G : g_rt;
  const int64_t total = groups * units;
  const int64_t c = units * U::kElems;
  const bool narrow = total <= 0xffffffffLL;   // 32-bit division suffices
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * kThreads) {
    int64_t grp;
    if (narrow)
      grp = (uint32_t)i / (uint32_t)units;
    else
      grp = i / units;
    const int64_t col = (i - grp * units) * U::kElems;
    const int64_t in0 = grp * g * stride + col;
    const int64_t out0 = grp * g * c + col;
    if constexpr (G > 0) {
      Raw r[G];
#pragma unroll
      for (int m = 0; m < G; ++m) r[m] = U::load(s, in0 + m * stride);
      Bits o = U::bits(r[0]);
#pragma unroll
      for (int m = 1; m < G; ++m) o = and_(o, U::bits(r[m]));
      U::store(ov, grp * c + col, U::unit(o));
#pragma unroll
      for (int m = 0; m < G; ++m)
        U::store(res, out0 + m * c, U::unit(andnot(U::bits(r[m]), o)));
    } else {
      // Rows past g reload row 0, which leaves the AND as it is.
      Bits o = U::bits(U::load(s, in0));
      for (int m0 = 1; m0 < g; m0 += kBatch) {
        Raw r[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          r[b] = U::load(s, in0 + (m0 + b < g ? (int64_t)(m0 + b) * stride
                                              : 0));
#pragma unroll
        for (int b = 0; b < kBatch; ++b) o = and_(o, U::bits(r[b]));
      }
      U::store(ov, grp * c + col, U::unit(o));
      for (int m0 = 0; m0 < g; m0 += kBatch) {
        Raw r[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          r[b] = m0 + b < g ? U::load(s, in0 + (int64_t)(m0 + b) * stride)
                            : Raw{};
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (m0 + b < g)
            U::store(res, out0 + (int64_t)(m0 + b) * c,
                     U::unit(andnot(U::bits(r[b]), o)));
      }
    }
  }
}

template <int kKind, int kBytes>
int launch(const void* s, void* ov, void* res, int64_t groups, int64_t c,
           int64_t stride, int g, cudaStream_t st) {
  using U = Unit<kKind, kBytes>;
  const int64_t units = c / U::kElems;
  const int64_t want = (groups * units + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  switch (g) {
    case 2:
      apec_kernel<kKind, kBytes, 2><<<blocks, kThreads, 0, st>>>(
          s, ov, res, groups, units, stride, g);
      break;
    case 4:
      apec_kernel<kKind, kBytes, 4><<<blocks, kThreads, 0, st>>>(
          s, ov, res, groups, units, stride, g);
      break;
    case 8:
      apec_kernel<kKind, kBytes, 8><<<blocks, kThreads, 0, st>>>(
          s, ov, res, groups, units, stride, g);
      break;
    default:
      apec_kernel<kKind, kBytes, 0><<<blocks, kThreads, 0, st>>>(
          s, ov, res, groups, units, stride, g);
  }
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

bool all_aligned(const void* a, const void* b, const void* c, int bytes) {
  return aligned(a, bytes) && aligned(b, bytes) && aligned(c, bytes);
}

}  // namespace
}  // namespace apec

// s: (P, dw) uint32 words, P = groups * g; ov: (groups, dw); res: (P, dw),
// all contiguous.
extern "C" int apec_decompose_forward(const uint32_t* s, uint32_t* ov,
                                      uint32_t* res, int64_t p, int64_t dw,
                                      int64_t g, void* stream) {
  using namespace apec;
  if (g < 1 || p % g != 0 || dw < 0) return (int)cudaErrorInvalidValue;
  const int64_t groups = p / g;
  if (groups == 0 || dw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dw % 4 == 0 && all_aligned(s, ov, res, 16))
    return launch<kWords, 16>(s, ov, res, groups, dw, dw, (int)g, st);
  if (dw % 2 == 0 && all_aligned(s, ov, res, 8))
    return launch<kWords, 8>(s, ov, res, groups, dw, dw, (int)g, st);
  return launch<kWords, 4>(s, ov, res, groups, dw, dw, (int)g, st);
}

// s: (P, C) f32 (kind 0) or bf16 (kind 1) spikes, rows `stride` elements
// apart, channels at unit stride; ov: (P/g, C), res: (P, C) contiguous, in
// s's type. 16-byte units where C, the stride and the pointers allow.
extern "C" int apec_decompose_spikes_forward(const void* s, void* ov,
                                             void* res, int64_t p, int64_t c,
                                             int64_t stride, int64_t g,
                                             int kind, void* stream) {
  using namespace apec;
  if (g < 1 || p % g != 0 || c < 0 || stride < 0 ||
      (kind != kF32 && kind != kBF16))
    return (int)cudaErrorInvalidValue;
  const int64_t groups = p / g;
  if (groups == 0 || c == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t elems = kind == kF32 ? 4 : 8;
  const bool vec = c % elems == 0 && stride % elems == 0 &&
                   all_aligned(s, ov, res, 16);
  if (kind == kF32)
    return vec ? launch<kF32, 16>(s, ov, res, groups, c, stride, (int)g, st)
               : launch<kF32, 4>(s, ov, res, groups, c, stride, (int)g, st);
  return vec ? launch<kBF16, 16>(s, ov, res, groups, c, stride, (int)g, st)
             : launch<kBF16, 2>(s, ov, res, groups, c, stride, (int)g, st);
}
