// Causal (LM) spike-driven self-attention: status[i] = OR over the micro-
// steps t and the tokens j <= i of (K[t, j] != 0 AND V[t, j] != 0) per
// channel, out[t, i] = (Q[t, i] != 0 AND status[i]) as ones and zeros in
// Q's type. The word entry computes the TPU row's own function, the
// prefix-OR over tokens of uint32 kv words, and writes the status words.
//
// Replaces: src/repro/kernels/sdsa_kernel.py::_causal_status_kernel
//           (sdsa_causal_status_pallas), and the word plumbing around it
//           (pack, T-fold, AND, unpack).
// Bound on the H100: bytes. It reads K, V and Q once and writes the
//           output once; the work is a compare, an AND and an OR a
//           channel and micro-step.
// Design:   the TPU kernel took uint32 kv words and ran the token axis as
//           a sequential grid dimension with a carry row in VMEM, so the
//           port packed three tensors, folded T in word ops and unpacked
//           after (57 of a 139.5 ms prefill on an H100), and its first
//           kernel walked all N tokens of a (row, word) in one block. Here
//           one launch reads the f32 or bf16 spikes where they lie (any
//           layout with a unit-stride channel axis; the heads fold into
//           the channel axis where they sit side by side) and runs the
//           scan in parallel over rows, units and tokens:
//           - a thread owns one unit of a row (16 bytes of channels, one
//             channel, or one word) and kTok consecutive tokens; it ORs
//             K AND V over T as it reads (loads of its kTok tokens go out
//             together) and scans its tokens serially in registers, as
//             channel masks. Rows narrower than a warp's units (ub < 32:
//             the word entry's dw = 2) load and store in token order, a
//             warp over 32 / ub whole token rows, and pass the masks to
//             their scanning threads through shared memory (at the 32k
//             row 0.0156 against 0.0217 ms with each thread loading its
//             own tokens, on an H100);
//           - a block owns (row, slice of `ub` units, chunk of
//             kThreads / ub * kTok tokens); its token lanes pass their
//             ORs on with warp shuffles (lanes ub apart, where ub < 32)
//             and one barrier over the warps' or lanes' totals;
//           - chunks of one (row, slice) pass their ORs on by decoupled
//             look-back, in this launch: a chunk publishes its aggregate,
//             reads its predecessors' flags kWindow at a time back to the
//             nearest inclusive one, and publishes its inclusive OR. A
//             flag is one 64-bit word (state in the high half, the unit's
//             mask in the low), so one relaxed store publishes both. A
//             chunk waits only on chunks of lower block index, which the
//             card has scheduled before it. The wrapper keeps the flags
//             and per-column counters zero at rest: the last chunk of a
//             column to finish its look-back zeroes them again;
//           - pass 2 reads Q once and writes Q AND (carry OR the lanes
//             before OR the thread's own prefix).
//           Any N: tokens past N are no-ops and are not stored. At the 32k
//           row (32 rows, 32768 tokens, 2 words) the grid is 1024 blocks
//           of 1024-token chunks, not 64 serial walks.
#include "sdsa_units.cuh"

namespace sdsa {
namespace {

constexpr int kTok = 8;       // consecutive tokens a thread scans
constexpr int kWindow = 8;    // predecessor flags the look-back reads at once
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// OR of every chunk before `chunk` in one column of flags (chunk j's flag
// at column[j * ub]): aggregates back to the nearest inclusive flag.
__device__ uint32_t look_back(const unsigned long long* column,
                              int64_t chunk, int ub) {
  uint32_t carry = 0u;
  for (int64_t j = chunk - 1;; j -= kWindow) {
    unsigned long long w[kWindow];
#pragma unroll
    for (int x = 0; x < kWindow; ++x)
      w[x] = j - x >= 0 ? load_flag(column + (j - x) * ub) : kInclusive;
#pragma unroll
    for (int x = 0; x < kWindow; ++x) {
      while ((w[x] >> 32) == 0) {
        __nanosleep(32);
        w[x] = load_flag(column + (j - x) * ub);
      }
      carry |= (uint32_t)w[x];
      if (w[x] >= kInclusive) return carry;
    }
  }
}

// grid: rows x slices x chunks, chunk fastest; a block = kThreads / ub
// token lanes x ub units, unit fastest. flags: (rows x slices, chunks,
// ub) 64-bit flags, then (rows x slices, ub) 32-bit counters.
template <int kKind, bool kVec>
__global__ void __launch_bounds__(kThreads)
sdsa_causal_kernel(const void* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, void* __restrict__ out,
                   Layout g, int ub, int64_t units, int64_t slices,
                   int64_t chunks, unsigned long long* __restrict__ flags,
                   unsigned* __restrict__ done) {
  using U = Unit<kKind, kVec>;
  using Raw = typename U::Raw;
  constexpr bool kStatus = U::kWord;   // words: kv in, status out
  __shared__ uint32_t part[kThreads];
  __shared__ uint32_t carried[kMaxUnitBlock];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = tid & (ub - 1);
  const int l = tid / ub;
  const int lanes = kThreads / ub;
  const int64_t chunk = blockIdx.x % chunks;
  const int64_t col = blockIdx.x / chunks;
  const int64_t unit = (col % slices) * ub + u;
  const bool live = unit < units;
  const int64_t n0 = (chunk * lanes + l) * kTok;
  int64_t off[4];
  row_offsets(g, col / slices, off);
  const int64_t c = unit * U::kElems;
  const int64_t steps = kStatus ? 1 : g.t;

  // Narrow rows (ub < 32) load and store in token order through shared
  // memory (a word of padding every 32 against bank conflicts); each
  // thread still scans its own consecutive tokens.
  __shared__ uint32_t stage[kThreads * kTok + kThreads * kTok / 32];
  const bool staged = ub < 32;
  const int64_t chunk0 = chunk * lanes * kTok;

  // Pass 1: each token's mask, ORed over T, then the thread's prefix-OR.
  uint32_t m[kTok];
#pragma unroll
  for (int i = 0; i < kTok; ++i) m[i] = 0u;
  if (live) {
    for (int64_t t = 0; t < steps; ++t) {
      Raw kr[kTok], vr[kTok];
#pragma unroll
      for (int i = 0; i < kTok; ++i) {
        const int64_t n = staged ? chunk0 + i * lanes + l : n0 + i;
        kr[i] = U::zero();
        vr[i] = U::zero();
        if (n < g.n) {
          kr[i] = U::load(k, off[1] + t * g.st[1] + n * g.sn[1] + c);
          if constexpr (!kStatus)
            vr[i] = U::load(v, off[2] + t * g.st[2] + n * g.sn[2] + c);
        }
      }
#pragma unroll
      for (int i = 0; i < kTok; ++i) {
        if constexpr (kStatus)
          m[i] |= U::mask(kr[i]);
        else
          m[i] |= U::mask(kr[i]) & U::mask(vr[i]);
      }
    }
  }
  if (staged) {
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      const int x = (i * lanes + l) * ub + u;
      stage[x + (x >> 5)] = m[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      const int x = (l * kTok + i) * ub + u;
      m[i] = stage[x + (x >> 5)];
    }
  }
#pragma unroll
  for (int i = 1; i < kTok; ++i) m[i] |= m[i - 1];

  // The block's token lanes: `before` = OR of the lanes before this one
  // (same unit), `total` = the chunk's OR.
  uint32_t before = 0u, total = m[kTok - 1];
  if (lanes > 1) {
    if (ub < 32) {
      uint32_t incl = total;
      for (int d = ub; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl |= y;
      }
      const uint32_t y = __shfl_up_sync(0xffffffffu, incl, ub);
      if (lane >= ub) before = y;
      if (lane >= 32 - ub) part[warp * ub + u] = incl;   // the warp's total
      __syncthreads();
      total = 0u;
      for (int w = 0; w < kThreads / 32; ++w) {
        const uint32_t x = part[w * ub + u];
        if (w < warp) before |= x;
        total |= x;
      }
    } else {
      part[tid] = total;
      __syncthreads();
      total = 0u;
      for (int j = 0; j < lanes; ++j) {
        const uint32_t x = part[j * ub + u];
        if (j < l) before |= x;
        total |= x;
      }
    }
  }

  // The chunks before this one: decoupled look-back, one thread a unit.
  uint32_t carry = 0u;
  if (chunks > 1) {
    if (tid < ub) {
      unsigned long long* column = flags + col * chunks * ub + u;
      if (chunk == 0) {
        store_flag(column, kInclusive | total);
      } else {
        store_flag(column + chunk * ub, kAggregate | total);
        carry = look_back(column, chunk, ub);
        store_flag(column + chunk * ub, kInclusive | carry | total);
      }
      carried[u] = carry;
      // Every chunk counts itself once its look-back is read; the last
      // one leaves the column's flags and counter zero for the next call.
      __threadfence();
      unsigned* count = done + col * ub + u;
      if (atomicAdd(count, 1u) == (unsigned)(chunks - 1)) {
        __threadfence();
        for (int64_t j = 0; j < chunks; ++j) store_flag(column + j * ub, 0ull);
        atomicExch(count, 0u);
      }
    }
    __syncthreads();
    carry = carried[u];
  }

  // Pass 2: the status of each token, written (words) or ANDed with Q.
  // Staged rows take their statuses back in the loads' token order. The
  // two loops stay apart: one loop with a select a slot held the wide
  // rows' launch 15% longer (0.115 against 0.100 ms at the LM's prefill
  // layer, on an H100).
  const uint32_t pre = carry | before;
  if (staged) {
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      const int x = (l * kTok + i) * ub + u;
      stage[x + (x >> 5)] = pre | m[i];
    }
    __syncthreads();
    if (!live) return;
    for (int64_t t = 0; t < steps; ++t) {
      Raw qr[kTok];
      if constexpr (!kStatus) {
#pragma unroll
        for (int i = 0; i < kTok; ++i) {
          const int64_t n = chunk0 + i * lanes + l;
          qr[i] = n < g.n ? U::load(q, off[0] + t * g.st[0] + n * g.sn[0] + c)
                          : U::zero();
        }
      }
#pragma unroll
      for (int i = 0; i < kTok; ++i) {
        const int64_t n = chunk0 + i * lanes + l;
        if (n >= g.n) continue;
        const int x = (i * lanes + l) * ub + u;
        const uint32_t st = stage[x + (x >> 5)];
        const int64_t o = off[3] + t * g.st[3] + n * g.sn[3] + c;
        if constexpr (kStatus)
          U::store(out, o, U::expand(st));
        else
          U::store(out, o, U::expand(U::mask(qr[i]) & st));
      }
    }
    return;
  }
  if (!live) return;
  for (int64_t t = 0; t < steps; ++t) {
    Raw qr[kTok];
    if constexpr (!kStatus) {
#pragma unroll
      for (int i = 0; i < kTok; ++i) {
        const int64_t n = n0 + i;
        qr[i] = n < g.n ? U::load(q, off[0] + t * g.st[0] + n * g.sn[0] + c)
                        : U::zero();
      }
    }
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      const int64_t n = n0 + i;
      if (n >= g.n) continue;
      const int64_t o = off[3] + t * g.st[3] + n * g.sn[3] + c;
      if constexpr (kStatus)
        U::store(out, o, U::expand(pre | m[i]));
      else
        U::store(out, o, U::expand(U::mask(qr[i]) & (pre | m[i])));
    }
  }
}

template <int kKind, bool kVec>
int launch(const void* q, const void* k, const void* v, void* out,
           const Layout& g, int ub, int64_t chunk_tokens, void* flags,
           cudaStream_t stream) {
  using U = Unit<kKind, kVec>;
  const int64_t units = g.c / U::kElems;
  const int64_t rows = g.r1 * g.r2 * g.r3;
  const int64_t slices = (units + ub - 1) / ub;
  const int64_t chunks = (g.n + chunk_tokens - 1) / chunk_tokens;
  const int64_t blocks = rows * slices * chunks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (chunks > 1 && flags == nullptr) return (int)cudaErrorInvalidValue;
  auto* f = static_cast<unsigned long long*>(flags);
  auto* done = reinterpret_cast<unsigned*>(f + rows * slices * chunks * ub);
  sdsa_causal_kernel<kKind, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      q, k, v, out, g, ub, units, slices, chunks, f, done);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sdsa

// q, k, v, out: f32 / bf16 spikes (T, rows, N, channels), or (kind words)
// uint32 kv words in k and the status words out, laid out as `desc` says
// (sdsa_units.cuh); desc's plan value is the chunk (kThreads / ub * kTok
// tokens). flags: zeroed look-back flags and counters the wrapper keeps
// (kernels/sdsa_kernel.py `look_back_words`), unused with one chunk.
extern "C" int sdsa_causal_strided_forward(const void* q, const void* k,
                                           const void* v, void* out,
                                           const int64_t* desc, void* flags,
                                           void* stream) {
  using namespace sdsa;
  const int kind = (int)desc[0], vec = (int)desc[1];
  const int64_t ub = desc[2], chunk_tokens = desc[3];
  const Layout g = read_layout(desc);
  if (kind < kF32 || kind > kWords || (vec && kind == kWords) ||
      !pow2(ub) || ub > kMaxUnitBlock ||
      chunk_tokens != kThreads / ub * kTok || g.r1 < 1 || g.r2 < 1 ||
      g.r3 < 1 || (kind == kWords && g.t != 1))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  const int64_t elem_bytes = kind == kBF16 ? 2 : 4;
  if (vec && !vectors_fit(g, ptrs, 16 / elem_bytes, elem_bytes))
    return (int)cudaErrorMisalignedAddress;
  if (g.t == 0 || g.n == 0 || g.c == 0 || g.r1 * g.r2 * g.r3 == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int b = (int)ub;
  if (kind == kF32)
    return vec ? launch<kF32, true>(q, k, v, out, g, b, chunk_tokens, flags, s)
               : launch<kF32, false>(q, k, v, out, g, b, chunk_tokens, flags,
                                     s);
  if (kind == kBF16)
    return vec ? launch<kBF16, true>(q, k, v, out, g, b, chunk_tokens, flags,
                                     s)
               : launch<kBF16, false>(q, k, v, out, g, b, chunk_tokens,
                                      flags, s);
  return launch<kWords, false>(q, k, v, out, g, b, chunk_tokens, flags, s);
}

// The capture sequence of `stream` (cudaStreamGetCaptureInfo's id), 0 when
// it is not capturing: the wrapper keeps one zeroed flag buffer for each
// CUDA graph capture, zeroed by the graph once a replay.
extern "C" int sdsa_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long seq = 0;
  const cudaError_t err =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &seq);
  *id = status == cudaStreamCaptureStatusActive ? seq : 0ull;
  return (int)err;
}
