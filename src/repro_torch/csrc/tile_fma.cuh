// The register-blocked fp32 tile loop of the predicated kernel 10's wide
// path, N > 16 (csrc/spike_matmul.cu), with its f32 spike loader; and the
// dynamic shared-memory opt-in and the group-size dispatch that the
// pipelined, fused and walking kernels launch with. Kernel 10's narrow
// path (N <= 16, SegNet's tconvs) and the pipelined kernels (TPU rows 12,
// 14, 16 and 18) feed the same fmaf arithmetic, or its equal, from
// csrc/tile_mma.cuh's cp.async ring instead of this loop's synchronous
// staging (rows 16 and 18 sum on the tensor cores, csrc/tile_tc.cuh); the
// serial CSR and APEC kernels (rows 11, 13, 15 and 17) walk the spikes'
// events instead (csrc/event_walk.cuh), with the same sums.
//
// A block owns one 128-row x BN-column output tile. Each occupied
// 128-deep k-tile streams its s tile and w tile through shared memory in
// 16-deep slices; thread (tx, ty) of the TX x TY grid accumulates the
// RM x RN outputs at rows ty + TY*i and columns tx + TX*j with fmaf, in
// k order. Ragged edges (M, K or N not multiples of the tile) are masked
// on load and store, and a slice that lies wholly past K is not staged at
// all (it would add fmaf(0, 0, acc) = acc), so callers never materialise
// padded copies. The spike operand comes through a loader, `DenseA`, which
// reads f32 spikes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile_fma {

// Lets `kernel` launch with `bytes` of dynamic shared memory, past the
// 48 KB a launch gets without asking (up to 227 KB on the H100). Callers
// launch with the same byte count and return the error it gives.
template <class Kernel>
inline cudaError_t allow_dynamic_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Calls fn(std::integral_constant<int, G>) for APEC's group size g, one
// of the divisors of 128 (a group never straddles two 128-row tiles);
// false for any other g.
template <class Fn>
bool dispatch_group(int64_t g, Fn&& fn) {
  switch (g) {
    case 1: fn(std::integral_constant<int, 1>{}); return true;
    case 2: fn(std::integral_constant<int, 2>{}); return true;
    case 4: fn(std::integral_constant<int, 4>{}); return true;
    case 8: fn(std::integral_constant<int, 8>{}); return true;
    case 16: fn(std::integral_constant<int, 16>{}); return true;
    case 32: fn(std::integral_constant<int, 32>{}); return true;
    case 64: fn(std::integral_constant<int, 64>{}); return true;
    case 128: fn(std::integral_constant<int, 128>{}); return true;
    default: return false;
  }
}

constexpr int kTile = 128;          // map tile (rows and k)
constexpr int kSlice = 16;          // k depth staged per shared-memory pass
constexpr int kPadA = 4;            // breaks bank conflicts on the A stores

template <int BN, int RM, int RN>
struct Shape {
  static_assert(kTile % RM == 0 && BN % RN == 0, "tile must split evenly");
  static constexpr int kTY = kTile / RM;
  static constexpr int kTX = BN / RN;
  static constexpr int kThreads = kTX * kTY;
};

template <int BN>
struct Staging {
  float a[kSlice][kTile + kPadA];   // s slice, k-major
  float b[kSlice][BN];              // w slice
};

// f32 spikes, (M, K) row-major.
struct DenseA {
  const float* __restrict__ s;
  int64_t m, k;
  // The spike at row m0 + r, column k0 + c; 0 past the edges.
  __device__ __forceinline__ float at(int64_t m0, int64_t k0, int r,
                                      int c) const {
    const int64_t gr = m0 + r, gc = k0 + c;
    return (gr < m && gc < k) ? s[gr * k + gc] : 0.0f;
  }
};

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
}

// acc += s[m0:m0+128, k0:k0+128] @ w[k0:k0+128, n0:n0+BN], masked to
// (m, k, n), with s read through loader `a`. Every thread of the block
// must call it (it synchronises).
template <int BN, int RM, int RN, class A>
__device__ __forceinline__ void accumulate_tile(
    Staging<BN>& st, const A& a, const float* __restrict__ w, int64_t m0,
    int64_t n0, int64_t k0, int64_t k, int64_t n, float (&acc)[RM][RN]) {
  using S = Shape<BN, RM, RN>;
  const int tid = threadIdx.x;
  const int tx = tid % S::kTX, ty = tid / S::kTX;
  for (int kk = 0; kk < kTile; kk += kSlice) {
    if (k0 + kk >= k) break;
#pragma unroll
    for (int l = 0; l < (kTile * kSlice + S::kThreads - 1) / S::kThreads;
         ++l) {
      const int e = tid + l * S::kThreads;
      // The guard vanishes at compile time when the threads split the
      // slice evenly (a run-time guard there doubled the kernel's time).
      if ((kTile * kSlice) % S::kThreads == 0 || e < kTile * kSlice) {
        const int r = e / kSlice, c = e % kSlice;
        st.a[c][r] = a.at(m0, k0, r, kk + c);
      }
    }
#pragma unroll
    for (int l = 0; l < (BN * kSlice + S::kThreads - 1) / S::kThreads; ++l) {
      const int e = tid + l * S::kThreads;
      if ((BN * kSlice) % S::kThreads == 0 || e < BN * kSlice) {
        const int r = e / BN, c = e % BN;
        const int64_t gk = k0 + kk + r, gn = n0 + c;
        st.b[r][c] = (gk < k && gn < n) ? w[gk * n + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kSlice; ++c) {
      float av[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = st.a[c][ty + S::kTY * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = st.b[c][tx + S::kTX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out[m0:m0+128, n0:n0+BN] = acc, masked to (m, n).
template <int BN, int RM, int RN>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           int64_t m0, int64_t n0, int64_t m,
                                           int64_t n,
                                           const float (&acc)[RM][RN]) {
  using S = Shape<BN, RM, RN>;
  const int tx = threadIdx.x % S::kTX, ty = threadIdx.x / S::kTX;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = m0 + ty + S::kTY * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int64_t c = n0 + tx + S::kTX * j;
      if (c < n) out[r * n + c] = acc[i][j];
    }
  }
}

}  // namespace tile_fma
