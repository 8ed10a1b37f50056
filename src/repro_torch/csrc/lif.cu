// Fused LIF scan over the leading time axis: the forward with or without
// per-tile event counts, each with or without the membrane residual that
// training saves, the packed fire that writes uint32 words instead of
// spikes, and the reversed-time ATan surrogate backward. The plain
// forward also takes bf16 drives (the LM's element type) and writes bf16
// spikes, with the membrane kept in f32 as the TPU kernel keeps it.
//
// Replaces: src/repro/kernels/lif_scan.py::_lif_kernel (lif_scan_pallas),
//           ::_lif_occ_kernel (_lif_occ_pallas), ::_lif_fwd_kernel
//           (_lif_fwd_pallas), ::_lif_occ_fwd_kernel (_lif_occ_pallas with
//           emit_vres), ::_lif_occ_packed_kernel
//           (lif_scan_occ_packed_pallas) and ::_lif_bwd_kernel
//           (_lif_bwd_pallas).
// Bound on the H100: bytes. The forward reads T*P f32 drive values and
//           writes T*P f32 spikes (P neurons per step), plus T*P f32
//           residuals in the residual mode; the packed fire writes T*P/8
//           bytes of words instead of the spikes, so it moves 4.125
//           bytes per element against the counts mode's 8; the bf16
//           forward moves 2 + 2 bytes per element; the backward
//           reads the residuals and the spike cotangent (2*T*P f32) and
//           writes the drive cotangent (T*P f32). Each does a few to ~12
//           flops per element, far below the card's ~20 flop/byte ridge.
//           At the LM's prefill fire, (2, 8*1024*5632) bf16, the bytes
//           take 0.110 ms on 3.35 TB/s; a thread a neuron with 2-byte
//           loads, one dependent load-fire-store a step, took 0.255
//           (chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W): one small load
//           in flight a thread is too little to cover the memory latency.
//           Streamed as below it takes 0.126, as long as a device copy of
//           the same bytes (tools/stream_probe.py, the same card).
// Design:   each thread keeps its membrane potential (backward: the
//           membrane cotangent u) in registers across the T loop, so the
//           state never touches device memory (the TPU kernels kept it
//           in VMEM scratch). The plain forward (`lif_kernel`, f32, bf16
//           and residual) streams: a thread owns one 16-byte vector of
//           neurons (4 f32 or 8 bf16), issues the 16-byte loads of all
//           its steps (up to 4 at once; the LM fires T = 2, SpikingFormer
//           T = 4) before the first step's arithmetic, and writes each
//           step's spikes and residuals as 16-byte stores; one vector a
//           thread, so the grid fills all 132 SMs in waves of blocks. A
//           drive whose rows are not all 16-byte aligned, or the ragged
//           tail of P, takes a scalar path in the same kernel, the same
//           steps one element at a time. The backward is one thread a
//           neuron; neighbouring threads own neighbouring neurons (or
//           vectors), so every load and store is coalesced. The residual
//           mode is a template flag: the same step, plus one store of the
//           pre-reset membrane, so spikes and counts equal the primal
//           kernel's and the primal pays nothing for it. The counts mode
//           lays a (8 rows x 128 lanes) block over each (row chunk, lane
//           tile) of the TPU kernel's count map and reduces its spikes
//           exactly: a warp ballot + popcount per warp, then a 32-entry
//           shared-memory sum. The count map counts the 8-row chunks of
//           the flattened (T*R, K) spikes, (ceil(T*R/8), ceil(K/128)):
//           with R % 8 == 0 that is _lif_occ_pallas's (T, R/8, ...)
//           layout flattened. A ragged R (VGG11's 2x2 fires at odd batch)
//           masks the rows past R in the last block of each step, and a
//           chunk then spans two steps or two blocks, so each warp adds its
//           popcount to the chunk with an integer atomicAdd into a zeroed
//           map (exact, so order does not matter). Lanes past K (the
//           TPU wrapper's zero pad to 128) exist only as idle threads and
//           never fire, so no padded copy of the drive is made. In that
//           block each warp covers 32 consecutive lanes of one row,
//           starting at a multiple of 32, so the ballot the counts take
//           IS the packed word (bit i = lane 32w+i): the packed mode
//           stores it from lane 0 of the warp, for words below
//           ceil(K/32), and writes no f32 spike. Idle lanes past K give
//           zero tail bits, as `pack_spikes_padded` pads.
//           Every operation is rounded on its own (__f*_rn, no FMA
//           contraction) in the order of the plain PyTorch versions in
//           kernels/lif_scan.py, so spikes, residuals and cotangents equal
//           them bit for bit: a contracted v*decay + x could flip a spike
//           that sits exactly at the threshold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One forward step; `vv` receives the pre-reset membrane.
__device__ __forceinline__ float lif_step(float& v, float x, float decay,
                                          float v_th, bool soft_reset,
                                          float& vv) {
  vv = __fadd_rn(__fmul_rn(v, decay), x);
  const float s = vv >= v_th ? 1.0f : 0.0f;
  v = soft_reset ? __fsub_rn(vv, __fmul_rn(s, v_th))
                 : __fmul_rn(vv, __fsub_rn(1.0f, s));
  return s;
}

// Element type of the drive and the spikes: f32, or bf16 widened to f32
// on load (exact) and narrowed on store (0 and 1 are exact in bf16).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E>
__device__ __forceinline__ E narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of E as four 32-bit words: 4 f32 or 8 bf16 lanes. Lane i of
// a bf16 vector is half-word i (little-endian), widened exactly by a
// shift, as __bfloat162float widens.
template <typename E>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int kN = 4;
  __device__ static float get(const uint32_t (&w)[4], int i) {
    return __uint_as_float(w[i]);
  }
  __device__ static void put(uint32_t (&w)[4], int i, float x) {
    w[i] = __float_as_uint(x);
  }
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static float get(const uint32_t (&w)[4], int i) {
    return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  }
  __device__ static void put(uint32_t (&w)[4], int i, float x) {
    const uint32_t h = __bfloat16_as_ushort(narrow<__nv_bfloat16>(x));
    w[i / 2] = i % 2 ? (w[i / 2] & 0xffffu) | (h << 16) : h;
  }
};

__device__ __forceinline__ void load16(uint32_t (&w)[4], const void* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void store16(void* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr int kFireThreads = 128;
constexpr int kGroup = 4;   // steps whose loads a thread issues together

// x, s (and vres): (T, P) contiguous, x and s of element type E, the
// membrane (and vres) f32. Thread j owns neurons [V j, V j + V), one
// 16-byte vector (V = 16 / sizeof(E)); one vector a thread (grid-stride
// past flat_blocks' cap). It issues the loads of up to kGroup steps
// before the first of their steps' arithmetic, then fires them in order
// and stores each step's spikes (and residuals) as 16-byte stores. `vec`: every row of x, s and vres starts 16-byte
// aligned (pointers aligned, and P % V == 0 or T == 1); where it is not,
// or at a ragged tail (n0 + V > P), the thread loads and stores its
// neurons one element at a time, in the same order.
template <typename E, bool kResidual>
__global__ void __launch_bounds__(kFireThreads)
lif_kernel(const E* __restrict__ x, E* __restrict__ s,
           float* __restrict__ vres, int64_t t_steps, int64_t p,
           float decay, float v_th, bool soft_reset, bool vec) {
  using L = Lanes<E>;
  constexpr int V = L::kN;
  const int64_t nvec = (p + V - 1) / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < nvec;
       j += stride) {
    const int64_t n0 = j * V;
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.0f;
    if (vec && n0 + V <= p) {
      for (int64_t t0 = 0; t0 < t_steps; t0 += kGroup) {
        uint32_t in[kGroup][4];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (t0 + g < t_steps) load16(in[g], x + (t0 + g) * p + n0);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (t0 + g >= t_steps) break;
          const int64_t off = (t0 + g) * p + n0;
          uint32_t sp[4] = {0u, 0u, 0u, 0u};
          float vv[V];
#pragma unroll
          for (int i = 0; i < V; ++i)
            L::put(sp, i, lif_step(v[i], L::get(in[g], i), decay, v_th,
                                   soft_reset, vv[i]));
          store16(s + off, sp);
          if (kResidual) {
#pragma unroll
            for (int q = 0; q < V / 4; ++q) {
              const uint32_t r[4] = {
                  __float_as_uint(vv[4 * q]), __float_as_uint(vv[4 * q + 1]),
                  __float_as_uint(vv[4 * q + 2]),
                  __float_as_uint(vv[4 * q + 3])};
              store16(vres + off + 4 * q, r);
            }
          }
        }
      }
    } else {
      for (int64_t t = 0; t < t_steps; ++t) {
        float xs[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          xs[i] = n0 + i < p ? widen(x[t * p + n0 + i]) : 0.0f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (n0 + i >= p) break;
          float vv;
          s[t * p + n0 + i] = narrow<E>(
              lif_step(v[i], xs[i], decay, v_th, soft_reset, vv));
          if (kResidual) vres[t * p + n0 + i] = vv;
        }
      }
    }
  }
}

constexpr int kLanes = 128;  // lane tile (the map's K tiling)
constexpr int kChunk = 8;    // row chunk (the TPU kernel's block_m)

// x, s (and vres): (T, R, K) contiguous; counts: (ceil(T*R/8),
// ceil(K/128)) int32, zeroed by the caller when R % 8 != 0; words (packed
// mode, instead of s): (T, R, ceil(K/32)) uint32. Block (128, 8):
// threadIdx.x = lane in the tile, threadIdx.y = row in the block.
// grid = (ceil(R/8), ceil(K/128)): row blocks on x, which has no 65535
// limit.
template <bool kResidual, bool kPacked>
__global__ void __launch_bounds__(kLanes * kChunk)
lif_counts_kernel(const float* __restrict__ x, float* __restrict__ s,
                  int* __restrict__ counts, float* __restrict__ vres,
                  uint32_t* __restrict__ words, int64_t t_steps,
                  int64_t rows, int64_t k, float decay, float v_th,
                  bool soft_reset) {
  __shared__ int partial[2][kLanes * kChunk / 32];
  const int64_t chunk = blockIdx.x;
  const int64_t lane = (int64_t)blockIdx.y * kLanes + threadIdx.x;
  const int64_t row = chunk * kChunk + threadIdx.y;
  const bool live = lane < k && row < rows;
  const bool ragged = rows % kChunk != 0;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int warp = tid / 32;
  const int64_t chunks = gridDim.x;
  const int64_t kt = gridDim.y;
  float v = 0.0f;
  for (int64_t t = 0; t < t_steps; ++t) {
    float sp = 0.0f;
    if (live) {
      const int64_t off = (t * rows + row) * k + lane;
      float vv;
      sp = lif_step(v, x[off], decay, v_th, soft_reset, vv);
      if (!kPacked) s[off] = sp;
      if (kResidual) vres[off] = vv;
    }
    const unsigned fired = __ballot_sync(0xffffffffu, sp != 0.0f);
    int* slot = partial[t & 1];
    if ((tid & 31) == 0) {
      if (kPacked && row < rows) {
        const int64_t kw = (k + 31) / 32;
        const int64_t word = lane / 32;   // lane % 32 == 0 here
        if (word < kw) words[(t * rows + row) * kw + word] = fired;
      }
      // A warp covers 32 lanes of one row, so its whole popcount belongs
      // to that row's chunk of the flattened rows.
      if (!ragged)
        slot[warp] = __popc(fired);
      else if (fired != 0u)
        atomicAdd(&counts[((t * rows + row) / kChunk) * kt + blockIdx.y],
                  __popc(fired));
    }
    if (ragged) continue;   // uniform over the grid: no barrier is skipped
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

// vres, g, dx: (T, P) contiguous. Reversed scan, per step t (the TPU
// kernel's order, repro/kernels/lif_scan.py:107-138):
//   sg     = (alpha/2) / (1 + (pi/2*alpha * (V[t] - v_th))^2)
//   dreset = 1 - v_th*sg (soft)  |  (1 - S[t]) - V[t]*sg (hard)
//   dv     = g[t]*sg + u*dreset;  dx[t] = dv;  u = decay*dv
__global__ void lif_bwd_kernel(const float* __restrict__ vres,
                               const float* __restrict__ g,
                               float* __restrict__ dx, int64_t t_steps,
                               int64_t p, float decay, float v_th,
                               bool soft_reset, float half_alpha,
                               float half_pi_alpha) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride) {
    float u = 0.0f;
    for (int64_t t = t_steps - 1; t >= 0; --t) {
      const int64_t off = t * p + i;
      const float v = vres[off];
      const float d = __fmul_rn(half_pi_alpha, __fsub_rn(v, v_th));
      const float sg = __fdiv_rn(half_alpha, __fadd_rn(1.0f, __fmul_rn(d, d)));
      float dreset;
      if (soft_reset) {
        dreset = __fsub_rn(1.0f, __fmul_rn(v_th, sg));
      } else {
        const float s = v >= v_th ? 1.0f : 0.0f;
        dreset = __fsub_rn(__fsub_rn(1.0f, s), __fmul_rn(v, sg));
      }
      const float dv = __fadd_rn(__fmul_rn(g[off], sg), __fmul_rn(u, dreset));
      dx[off] = dv;
      u = __fmul_rn(decay, dv);
    }
  }
}

int flat_blocks(int64_t p, int threads) {
  const int64_t want = (p + threads - 1) / threads;
  return (int)(want < 65535 * 32 ? want : 65535 * 32);
}

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

template <typename E, bool kResidual>
int launch_lif(const E* x, E* s, float* vres, int64_t t_steps, int64_t p,
               float decay, float v_th, int soft_reset, void* stream) {
  if (p > 0 && t_steps > 0) {
    constexpr int V = Lanes<E>::kN;
    const bool vec = (p % V == 0 || t_steps == 1) && aligned16(x) &&
                     aligned16(s) && (!kResidual || aligned16(vres));
    lif_kernel<E, kResidual><<<flat_blocks((p + V - 1) / V, kFireThreads),
                               kFireThreads, 0, (cudaStream_t)stream>>>(
        x, s, vres, t_steps, p, decay, v_th, soft_reset != 0, vec);
  }
  return (int)cudaGetLastError();
}

template <bool kResidual, bool kPacked>
int launch_lif_counts(const float* x, float* s, int* counts, float* vres,
                      uint32_t* words, int64_t t_steps, int64_t rows,
                      int64_t k, float decay, float v_th, int soft_reset,
                      void* stream) {
  if (rows > 0 && k > 0) {
    dim3 block(kLanes, kChunk);
    dim3 grid((unsigned)((rows + kChunk - 1) / kChunk),
              (unsigned)((k + kLanes - 1) / kLanes));
    lif_counts_kernel<kResidual, kPacked>
        <<<grid, block, 0, (cudaStream_t)stream>>>(
            x, s, counts, vres, words, t_steps, rows, k, decay, v_th,
            soft_reset != 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lif_forward(const float* x, float* s, int64_t t_steps,
                           int64_t p, float decay, float v_th,
                           int soft_reset, void* stream) {
  return launch_lif<float, false>(x, s, nullptr, t_steps, p, decay, v_th,
                                  soft_reset, stream);
}

// x, s: (T, P) bf16; the membrane stays f32 in a register.
extern "C" int lif_bf16_forward(const __nv_bfloat16* x, __nv_bfloat16* s,
                                int64_t t_steps, int64_t p, float decay,
                                float v_th, int soft_reset, void* stream) {
  return launch_lif<__nv_bfloat16, false>(x, s, nullptr, t_steps, p, decay,
                                          v_th, soft_reset, stream);
}

extern "C" int lif_fwd_forward(const float* x, float* s, float* vres,
                               int64_t t_steps, int64_t p, float decay,
                               float v_th, int soft_reset, void* stream) {
  return launch_lif<float, true>(x, s, vres, t_steps, p, decay, v_th,
                                 soft_reset, stream);
}

extern "C" int lif_counts_forward(const float* x, float* s, int* counts,
                                  int64_t t_steps, int64_t rows, int64_t k,
                                  float decay, float v_th, int soft_reset,
                                  void* stream) {
  return launch_lif_counts<false, false>(x, s, counts, nullptr, nullptr,
                                         t_steps, rows, k, decay, v_th,
                                         soft_reset, stream);
}

// words: (T, R, ceil(K/32)) uint32, written instead of the spikes.
extern "C" int lif_counts_packed_forward(const float* x, uint32_t* words,
                                         int* counts, int64_t t_steps,
                                         int64_t rows, int64_t k,
                                         float decay, float v_th,
                                         int soft_reset, void* stream) {
  return launch_lif_counts<false, true>(x, nullptr, counts, nullptr, words,
                                        t_steps, rows, k, decay, v_th,
                                        soft_reset, stream);
}

extern "C" int lif_counts_fwd_forward(const float* x, float* s, int* counts,
                                      float* vres, int64_t t_steps,
                                      int64_t rows, int64_t k, float decay,
                                      float v_th, int soft_reset,
                                      void* stream) {
  return launch_lif_counts<true, false>(x, s, counts, vres, nullptr,
                                        t_steps, rows, k, decay, v_th,
                                        soft_reset, stream);
}

extern "C" int lif_backward(const float* vres, const float* g, float* dx,
                            int64_t t_steps, int64_t p, float decay,
                            float v_th, int soft_reset, float half_alpha,
                            float half_pi_alpha, void* stream) {
  if (p > 0) {
    const int threads = 256;
    lif_bwd_kernel<<<flat_blocks(p, threads), threads, 0,
                     (cudaStream_t)stream>>>(
        vres, g, dx, t_steps, p, decay, v_th, soft_reset != 0, half_alpha,
        half_pi_alpha);
  }
  return (int)cudaGetLastError();
}
