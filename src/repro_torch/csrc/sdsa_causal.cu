// Causal (LM) spike-driven self-attention status: the prefix-OR over the
// token axis of bit-packed kv words, out[b, i, w] = OR over j <= i of
// kv[b, j, w].
//
// Replaces: src/repro/kernels/sdsa_kernel.py::_causal_status_kernel
//           (sdsa_causal_status_pallas).
// Bound on the H100: bytes. It reads the BH*N*dw kv words once and writes
//           as many status words; the work is one OR per word per scan
//           level, far below any compute limit.
// Design:   the TPU ran the token axis as a sequential grid dimension: a
//           Hillis-Steele doubling scan inside each (block_n, dw) block
//           and a (1, dw) VMEM carry row from one block to the next.
//           Blocks on the card run in no order, so no carry may cross
//           them: here one block owns one (batch*head, word column) pair
//           and walks all N tokens itself, in chunks of one token per
//           thread. In a chunk each warp OR-scans its 32 tokens with
//           __shfl_up_sync (5 levels), lane 31 parks the warp's total in
//           shared memory, and after one barrier every thread ORs in the
//           totals of the warps before it and the running carry of the
//           earlier chunks, which lives in a register (the same value in
//           every thread). A second barrier guards the totals before the
//           next chunk overwrites them. Tokens past N are zero words, a
//           no-op for OR, and are not stored, so any N is taken without
//           padding. A thread's loads stride dw words (8 bytes at the LM's
//           dw = 2); the two column blocks of a row share those cache
//           lines in L2. The T-fold of K AND V before and the Q AND after
//           stay elementwise word ops in the wrapper (kernels/ops.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // 16 warps: one token each per chunk

// kv, out: (BH, N, dw) uint32. grid = (BH, dw); blockDim.x a multiple of
// 32, at most kMaxThreads.
__global__ void __launch_bounds__(kMaxThreads)
sdsa_causal_kernel(const uint32_t* __restrict__ kv,
                   uint32_t* __restrict__ out, int64_t n, int64_t dw) {
  __shared__ uint32_t warp_or[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * n * dw + blockIdx.y;
  const uint32_t* __restrict__ src = kv + base;
  uint32_t* __restrict__ dst = out + base;
  uint32_t carry = 0u;                 // OR of every earlier chunk
  for (int64_t c0 = 0; c0 < n; c0 += blockDim.x) {
    const int64_t i = c0 + threadIdx.x;
    uint32_t x = i < n ? src[i * dw] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x |= y;
    }
    if (lane == 31) warp_or[warp] = x;
    __syncthreads();
    uint32_t before = carry, all = carry;
    for (int q = 0; q < warps; ++q) {
      const uint32_t t = warp_or[q];
      if (q < warp) before |= t;
      all |= t;
    }
    if (i < n) dst[i * dw] = x | before;
    carry = all;
    __syncthreads();                   // totals read before the next chunk
  }
}

}  // namespace

// kv, out: (BH, N, dw) uint32 words.
extern "C" int sdsa_causal_forward(const uint32_t* kv, uint32_t* out,
                                   int64_t bh, int64_t n, int64_t dw,
                                   void* stream) {
  if (dw > 65535) return (int)cudaErrorInvalidValue;
  if (bh > 0 && n > 0 && dw > 0) {
    const int64_t want = (n + 31) / 32 * 32;
    const int threads = (int)(want < kMaxThreads ? want : kMaxThreads);
    dim3 grid((unsigned)bh, (unsigned)dw);
    sdsa_causal_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        kv, out, n, dw);
  }
  return (int)cudaGetLastError();
}
