// Spike-driven self-attention, OR form: status = OR over the N tokens of
// (K != 0 AND V != 0) per channel, out = (Q != 0 AND status) as ones and
// zeros in Q's type; on uint32 words, out = Q AND (OR over N of K AND V).
//
// Replaces: src/repro/kernels/sdsa_kernel.py::_status_kernel
//           (sdsa_status_pallas) and ::_apply_kernel (sdsa_apply_pallas),
//           fused into one kernel.
// Bound on the H100: bytes. It reads K, V and Q once and writes the
//           output once; the work is a compare, an AND and an OR a
//           channel.
// Design:   the TPU kernels took uint32 words, so the port packed the
//           spikes before the call and unpacked after it (int64 tensor
//           code around a 0.02 ms kernel). Here one launch reads the f32
//           or bf16 spikes where they lie, in any layout whose channel
//           axis is unit-stride (the models' head-transposed views: the
//           wrapper folds the heads into the channel axis where they sit
//           side by side), and writes the output spikes into a tensor
//           laid out like Q. A thread owns one unit of a row (16 bytes of
//           channels, or one channel or word on the scalar path), so a
//           warp reads a token row in 16-byte pieces; blocks split the
//           leading rows and the row's units (SpikingFormer's 128 (t, b)
//           rows x 96 vectors: 384 blocks of 32 units x 8 token groups),
//           and a block's token groups stride over N. The status stays
//           in a register as a channel mask: pass 1 ORs the groups' K AND
//           V masks, one barrier ORs the groups together in shared
//           memory (no atomics, no division in the loops), and pass 2
//           reads Q once and writes Q AND status. Loads go out four tokens
//           at a time. The word entry (the TPU row's own function) runs
//           the same template on one-word units.
// Status:   `sdsa_status_strided_forward` is the TPU row's status-only
//           entry (`sdsa_status_pallas`, `kernels/ops.py::sdsa_status`):
//           the same template with kStatus set runs pass 1 and the
//           shared-memory OR, then the first token group writes the
//           channel mask (ones and zeros in K's type, or the word) once
//           a row and pass 2 is skipped. It reads K and V once and writes
//           (..., d): bound by the bytes of K and V.
#include "sdsa_units.cuh"

namespace sdsa {
namespace {

constexpr int kBatch = 4;   // tokens whose loads a thread issues together

// grid: slices x ceil(rows / rows a block); a block = rows a block x
// `groups` token groups x `ub` units, unit fastest. With kStatus, `out`
// is described with a token stride of 0 and receives the status alone.
template <int kKind, bool kVec, bool kStatus>
__global__ void __launch_bounds__(kThreads)
sdsa_or_kernel(const void* __restrict__ q, const void* __restrict__ k,
               const void* __restrict__ v, void* __restrict__ out, Layout g,
               int ub, int groups, int64_t units, int64_t slices,
               int64_t rows) {
  using U = Unit<kKind, kVec>;
  using Raw = typename U::Raw;
  __shared__ uint32_t part[kThreads];
  const int tid = threadIdx.x;
  const int per_row = ub * groups;
  const int u = tid & (ub - 1);
  const int grp = (tid / ub) & (groups - 1);
  const int rb = tid / per_row;
  const int64_t slice = blockIdx.x % slices;
  const int64_t row =
      (int64_t)(blockIdx.x / slices) * (kThreads / per_row) + rb;
  const int64_t unit = slice * ub + u;
  const bool live = row < rows && unit < units;
  int64_t off[4] = {0, 0, 0, 0};
  if (live) row_offsets(g, row, off);
  const int64_t c = unit * U::kElems;
  const int64_t step = (int64_t)groups * kBatch;

  uint32_t status = 0u;
  if (live) {
    for (int64_t n0 = grp; n0 < g.n; n0 += step) {
      Raw kr[kBatch], vr[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int64_t n = n0 + (int64_t)b * groups;
        kr[b] = U::zero();
        vr[b] = U::zero();
        if (n < g.n) {
          kr[b] = U::load(k, off[1] + n * g.sn[1] + c);
          vr[b] = U::load(v, off[2] + n * g.sn[2] + c);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        status |= U::mask(kr[b]) & U::mask(vr[b]);
    }
  }
  part[tid] = status;
  __syncthreads();
  const int first = rb * per_row + u;
  for (int j = 0; j < groups; ++j) status |= part[first + j * ub];
  if (!live) return;
  if constexpr (kStatus) {
    if (grp == 0) U::store(out, off[3] + c, U::expand(status));
    return;
  }
  for (int64_t n0 = grp; n0 < g.n; n0 += step) {
    Raw qr[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t n = n0 + (int64_t)b * groups;
      qr[b] = n < g.n ? U::load(q, off[0] + n * g.sn[0] + c) : U::zero();
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t n = n0 + (int64_t)b * groups;
      if (n < g.n)
        U::store(out, off[3] + n * g.sn[3] + c,
                 U::expand(U::mask(qr[b]) & status));
    }
  }
}

template <int kKind, bool kVec, bool kStatus>
int launch(const void* q, const void* k, const void* v, void* out,
           const Layout& g, int ub, int groups, cudaStream_t stream) {
  using U = Unit<kKind, kVec>;
  const int64_t units = g.c / U::kElems;
  const int64_t rows = g.r1 * g.r2 * g.r3;
  const int64_t slices = (units + ub - 1) / ub;
  const int64_t rows_per_block = kThreads / (ub * groups);
  const int64_t blocks =
      slices * ((rows + rows_per_block - 1) / rows_per_block);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  sdsa_or_kernel<kKind, kVec, kStatus>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
      q, k, v, out, g, ub, groups, units, slices, rows);
  return (int)cudaGetLastError();
}

// Checks the descriptor and launches the instance it names.
template <bool kStatus>
int run(const void* q, const void* k, const void* v, void* out,
        const int64_t* desc, void* stream) {
  const int kind = (int)desc[0], vec = (int)desc[1];
  const int64_t ub = desc[2], groups = desc[3];
  const Layout g = read_layout(desc);
  if (kind < kF32 || kind > kWords || (vec && kind == kWords) ||
      !pow2(ub) || ub > kMaxUnitBlock || !pow2(groups) ||
      ub * groups > kThreads || g.r1 < 1 || g.r2 < 1 || g.r3 < 1 ||
      (kStatus && g.sn[3] != 0))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  const int64_t elem_bytes = kind == kBF16 ? 2 : 4;
  if (vec && !vectors_fit(g, ptrs, 16 / elem_bytes, elem_bytes))
    return (int)cudaErrorMisalignedAddress;
  if (g.n == 0 || g.c == 0 || g.r1 * g.r2 * g.r3 == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int b = (int)ub, gr = (int)groups;
  if (kind == kF32)
    return vec ? launch<kF32, true, kStatus>(q, k, v, out, g, b, gr, s)
               : launch<kF32, false, kStatus>(q, k, v, out, g, b, gr, s);
  if (kind == kBF16)
    return vec ? launch<kBF16, true, kStatus>(q, k, v, out, g, b, gr, s)
               : launch<kBF16, false, kStatus>(q, k, v, out, g, b, gr, s);
  return launch<kWords, false, kStatus>(q, k, v, out, g, b, gr, s);
}

}  // namespace
}  // namespace sdsa

// q, k, v, out: f32 / bf16 spikes or uint32 words laid out as `desc` says
// (sdsa_units.cuh); desc's plan value is the number of token groups.
extern "C" int sdsa_or_strided_forward(const void* q, const void* k,
                                       const void* v, void* out,
                                       const int64_t* desc, void* stream) {
  return sdsa::run<false>(q, k, v, out, desc, stream);
}

// The status alone: out[row, c] = OR over N of (K AND V). `desc` describes
// (q, k, v, out) as the OR form does, q as k, and out with token stride 0
// (its (..., d) status seen as (..., N, d)); q is not read.
extern "C" int sdsa_status_strided_forward(const void* k, const void* v,
                                           void* out, const int64_t* desc,
                                           void* stream) {
  return sdsa::run<true>(k, k, v, out, desc, stream);
}
