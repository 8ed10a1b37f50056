// APEC overlap/residual decomposition on packed spike words.
//
// Replaces: src/repro/kernels/apec_kernel.py::_apec_kernel
//           (apec_decompose_packed): for each group of g adjacent rows,
//           overlap = AND of the rows' words, residual_i = s_i AND NOT
//           overlap (the paper's Eq. 1 and Fig. 5, 32 channels a word).
// Bound on the H100: bytes. It reads the P x dw words once and writes
//           P x dw residual and P/g x dw overlap words once; the work is
//           g-1 ANDs and g AND-NOTs per group and word.
// Design:   one thread per (group, vector of words), a grid-stride loop
//           over groups x vectors. The vector is 16 bytes (4 words) when
//           dw and the pointers allow it, else 8 bytes or one word, so a
//           ragged dw (14 words for a 432-channel patch row) is covered
//           without a padded copy and loads stay coalesced. The TPU cut
//           the array into (g*8, 128) blocks and needed P % (g*8) == 0
//           and dw % 128 == 0 (padded by its wrapper); here only P % g ==
//           0 is required (the wrapper checks it). g is a template
//           parameter for 2, 4 and 8, a run-time loop bound otherwise.
//           Words are uint32_t here, so nothing sign-extends.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// s, res: (groups*g, dwv) vectors; ov: (groups, dwv). G > 0 fixes g at
// compile time; G == 0 reads it from g_rt.
template <int G, typename V>
__global__ void apec_kernel(const V* __restrict__ s, V* __restrict__ ov,
                            V* __restrict__ res, int64_t groups,
                            int64_t dwv, int g_rt) {
  const int g = G > 0 ? G : g_rt;
  const int64_t total = groups * dwv;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t grp = i / dwv, c = i - grp * dwv;
    const V* row = s + grp * g * dwv + c;
    V o = row[0];
#pragma unroll
    for (int m = 1; m < g; ++m) o = and_(o, row[m * dwv]);
    ov[i] = o;
    V* out = res + grp * g * dwv + c;
#pragma unroll
    for (int m = 0; m < g; ++m) out[m * dwv] = andnot(row[m * dwv], o);
  }
}

template <typename V>
void launch(const void* s, void* ov, void* res, int64_t groups, int64_t dwv,
            int g, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = groups * dwv;
  const int64_t blocks64 = (total + threads - 1) / threads;
  const unsigned blocks = (unsigned)(blocks64 < 132 * 32 ? blocks64
                                                          : 132 * 32);
  const V* sv = (const V*)s;
  V* ovv = (V*)ov;
  V* rv = (V*)res;
  switch (g) {
    case 2:
      apec_kernel<2, V><<<blocks, threads, 0, stream>>>(sv, ovv, rv, groups,
                                                        dwv, g);
      break;
    case 4:
      apec_kernel<4, V><<<blocks, threads, 0, stream>>>(sv, ovv, rv, groups,
                                                        dwv, g);
      break;
    case 8:
      apec_kernel<8, V><<<blocks, threads, 0, stream>>>(sv, ovv, rv, groups,
                                                        dwv, g);
      break;
    default:
      apec_kernel<0, V><<<blocks, threads, 0, stream>>>(sv, ovv, rv, groups,
                                                        dwv, g);
  }
}

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

}  // namespace

// s: (P, dw) uint32 words, P = groups * g; ov: (groups, dw); res: (P, dw).
extern "C" int apec_decompose_forward(const uint32_t* s, uint32_t* ov,
                                      uint32_t* res, int64_t p, int64_t dw,
                                      int64_t g, void* stream) {
  if (g < 1 || p % g != 0) return (int)cudaErrorInvalidValue;
  const int64_t groups = p / g;
  if (groups > 0 && dw > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const bool al16 = aligned(s, 16) && aligned(ov, 16) && aligned(res, 16);
    const bool al8 = aligned(s, 8) && aligned(ov, 8) && aligned(res, 8);
    if (dw % 4 == 0 && al16)
      launch<uint4>(s, ov, res, groups, dw / 4, (int)g, st);
    else if (dw % 2 == 0 && al8)
      launch<uint2>(s, ov, res, groups, dw / 2, (int)g, st);
    else
      launch<uint32_t>(s, ov, res, groups, dw, (int)g, st);
  }
  return (int)cudaGetLastError();
}
