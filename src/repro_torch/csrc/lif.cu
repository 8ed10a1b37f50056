// Fused LIF scan over the leading time axis, with or without per-tile
// event counts.
//
// Replaces: src/repro/kernels/lif_scan.py::_lif_kernel (lif_scan_pallas)
//           and ::_lif_occ_kernel (_lif_occ_pallas).
// Bound on the H100: bytes. Each call reads T*P f32 drive values and
//           writes T*P f32 spikes (P neurons per step); it does a few
//           flops per element, far below the card's ~20 flop/byte ridge.
// Design:   one thread per neuron keeps its membrane potential in a
//           register across the T loop, so the membrane never touches
//           device memory (the TPU kernel kept it in VMEM scratch).
//           Neighbouring threads own neighbouring neurons, so every load
//           and store is coalesced. The counts mode lays a (8 rows x 128
//           lanes) block over each (row chunk, lane tile) of the TPU
//           kernel's count map and reduces its spikes exactly: a warp
//           ballot + popcount per warp, then a 32-entry shared-memory sum.
//           The count map therefore has the same layout as
//           _lif_occ_pallas, (T, R/8, ceil(K/128)); lanes past K (the
//           TPU wrapper's zero pad to 128) exist only as idle threads and
//           never fire, so no padded copy of the drive is made.
//           v*decay + x is rounded twice (__fmul_rn, __fadd_rn) like the
//           plain PyTorch version: a contracted FMA could flip a spike
//           that sits exactly at the threshold when decay is not 0.5.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float lif_step(float& v, float x, float decay,
                                          float v_th, bool soft_reset) {
  const float vv = __fadd_rn(__fmul_rn(v, decay), x);
  const float s = vv >= v_th ? 1.0f : 0.0f;
  v = soft_reset ? __fsub_rn(vv, __fmul_rn(s, v_th))
                 : __fmul_rn(vv, __fsub_rn(1.0f, s));
  return s;
}

// x, s: (T, P) contiguous. One thread per neuron, grid-stride over P.
__global__ void lif_kernel(const float* __restrict__ x, float* __restrict__ s,
                           int64_t t_steps, int64_t p, float decay,
                           float v_th, bool soft_reset) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride) {
    float v = 0.0f;
    for (int64_t t = 0; t < t_steps; ++t) {
      s[t * p + i] = lif_step(v, x[t * p + i], decay, v_th, soft_reset);
    }
  }
}

constexpr int kLanes = 128;  // lane tile (the map's K tiling)
constexpr int kChunk = 8;    // row chunk (the TPU kernel's block_m)

// x, s: (T, R, K) contiguous; counts: (T, R/8, ceil(K/128)) int32.
// Block (128, 8): threadIdx.x = lane in the tile, threadIdx.y = row in
// the chunk. grid = (R/8, ceil(K/128)): chunks on x, which has no 65535
// limit.
__global__ void __launch_bounds__(kLanes * kChunk)
lif_counts_kernel(const float* __restrict__ x, float* __restrict__ s,
                  int* __restrict__ counts, int64_t t_steps, int64_t rows,
                  int64_t k, float decay, float v_th, bool soft_reset) {
  __shared__ int partial[2][kLanes * kChunk / 32];
  const int64_t chunk = blockIdx.x;
  const int64_t lane = (int64_t)blockIdx.y * kLanes + threadIdx.x;
  const int64_t row = chunk * kChunk + threadIdx.y;
  const bool live = lane < k;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int warp = tid / 32;
  const int64_t chunks = gridDim.x;
  const int64_t kt = gridDim.y;
  float v = 0.0f;
  for (int64_t t = 0; t < t_steps; ++t) {
    float sp = 0.0f;
    if (live) {
      const int64_t off = (t * rows + row) * k + lane;
      sp = lif_step(v, x[off], decay, v_th, soft_reset);
      s[off] = sp;
    }
    const unsigned fired = __ballot_sync(0xffffffffu, sp != 0.0f);
    int* slot = partial[t & 1];
    if ((tid & 31) == 0) slot[warp] = __popc(fired);
    __syncthreads();
    // Safe with one barrier per step: the next step writes the other
    // slot, and the step after that waits at its barrier for this read.
    if (warp == 0) {
      int c = slot[tid];
      for (int d = 16; d > 0; d >>= 1)
        c += __shfl_down_sync(0xffffffffu, c, d);
      if (tid == 0)
        counts[(t * chunks + chunk) * kt + blockIdx.y] = c;
    }
  }
}

}  // namespace

extern "C" int lif_forward(const float* x, float* s, int64_t t_steps,
                           int64_t p, float decay, float v_th,
                           int soft_reset, void* stream) {
  if (p > 0) {
    const int threads = 256;
    const int64_t want = (p + threads - 1) / threads;
    const int blocks = (int)(want < 65535 * 32 ? want : 65535 * 32);
    lif_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, s, t_steps, p, decay, v_th, soft_reset != 0);
  }
  return (int)cudaGetLastError();
}

extern "C" int lif_counts_forward(const float* x, float* s, int* counts,
                                  int64_t t_steps, int64_t rows, int64_t k,
                                  float decay, float v_th, int soft_reset,
                                  void* stream) {
  if (rows > 0 && k > 0) {
    dim3 block(kLanes, kChunk);
    dim3 grid((unsigned)(rows / kChunk), (unsigned)((k + kLanes - 1) / kLanes));
    lif_counts_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        x, s, counts, t_steps, rows, k, decay, v_th, soft_reset != 0);
  }
  return (int)cudaGetLastError();
}
