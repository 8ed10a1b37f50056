// Spike-driven self-attention, OR form, on bit-packed spike words.
//
// Replaces: src/repro/kernels/sdsa_kernel.py::_status_kernel
//           (sdsa_status_pallas) and ::_apply_kernel (sdsa_apply_pallas),
//           fused into one kernel.
// Bound on the H100: bytes. It reads Q, K and V words once and writes the
//           output words once; the work is one AND, one OR and one AND
//           per word.
// Design:   one block per (batch, head) row. The TPU ran two kernels, the
//           status one accumulating over a sequential N grid axis into a
//           (1, dw) output block. Here the block's threads stride over the
//           (N, dw) words, fold K AND V into a dw-word status row in
//           shared memory (shared-memory atomicOr, so no order is needed),
//           wait at one barrier, and write Q AND status. The status row
//           never reaches device memory and the second launch is gone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// q, k, v, out: (BH, N, dw) uint32 words. grid = BH, dynamic shared
// memory = dw words.
__global__ void sdsa_or_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ k,
                               const uint32_t* __restrict__ v,
                               uint32_t* __restrict__ out, int64_t n,
                               int64_t dw) {
  extern __shared__ uint32_t status[];
  const int64_t words = n * dw;
  const int64_t base = (int64_t)blockIdx.x * words;
  for (int64_t w = threadIdx.x; w < dw; w += blockDim.x) status[w] = 0u;
  __syncthreads();
  for (int64_t i = threadIdx.x; i < words; i += blockDim.x) {
    const uint32_t kv = k[base + i] & v[base + i];
    if (kv) atomicOr(&status[i % dw], kv);
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < words; i += blockDim.x) {
    out[base + i] = q[base + i] & status[i % dw];
  }
}

}  // namespace

extern "C" int sdsa_or_forward(const uint32_t* q, const uint32_t* k,
                               const uint32_t* v, uint32_t* out, int64_t bh,
                               int64_t n, int64_t dw, void* stream) {
  if (bh > 0 && n > 0 && dw > 0) {
    const int64_t words = n * dw;
    const int threads = words >= 256 ? 256 : (int)((words + 31) / 32 * 32);
    sdsa_or_kernel<<<(unsigned)bh, threads, dw * sizeof(uint32_t),
                     (cudaStream_t)stream>>>(q, k, v, out, n, dw);
  }
  return (int)cudaGetLastError();
}
