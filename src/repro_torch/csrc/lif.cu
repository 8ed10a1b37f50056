// Fused LIF scan over the leading time axis: the forward with or without
// per-tile event counts, each with or without the membrane residual that
// training saves, the packed fire that writes uint32 words instead of
// spikes, and the reversed-time ATan surrogate backward. The plain
// forward, with or without the residual, also takes bf16 drives (the
// LM's element type) and writes bf16 spikes, with the membrane and the
// residual kept in f32 as the TPU kernel keeps them; the backward takes a
// bf16 spike cotangent too, carries the membrane cotangent in f32 and
// rounds each bf16 dx once, at its store.
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
//           forward moves 2 + 2 bytes per element (2 + 2 + 4 with the
//           residual); the backward reads the residuals and the spike
//           cotangent (2*T*P f32) and writes the drive cotangent (T*P
//           f32), 4 + 2 + 2 bytes per element in bf16. At the LM
//           training step's hidden fire, (2, 8*128*5632), the bf16
//           residual forward and backward each take 0.0275 ms of bytes
//           on 3.35 TB/s. Each does a few to ~12
//           flops per element, far below the card's ~20 flop/byte ridge.
//           At the LM's prefill fire, (2, 8*1024*5632) bf16, the bytes
//           take 0.110 ms on 3.35 TB/s; a thread a neuron with 2-byte
//           loads, one dependent load-fire-store a step, took 0.255
//           (chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W): one small load
//           in flight a thread is too little to cover the memory latency.
//           Streamed as below it takes 0.126, as long as a device copy of
//           the same bytes (tools/stream_probe.py, the same card).
//           The counts fire at SpikingFormer's stage-1 drive (4, 32768,
//           96) took 0.077 ms (0.072 packed) as a thread a lane with
//           4-byte loads, 1024-thread blocks of 128 lanes (62-94% of them
//           idle below K = 128) and a barrier a step; streamed as below
//           it takes 0.041, a device copy of its bytes 0.037, and the
//           packed fire 0.027, as long as a sum of the drive (0.025:
//           the read alone; tools/stream_probe.py, the same card).
//           The backward at qwen2-moe's shared-expert drive (2048, 5632)
//           bf16 has 0.0275 ms of bytes: the stream took 0.99 (704
//           threads on 6 SMs), the slab ring below 0.059; at the stage-1
//           cotangent (4, 32768*96) f32 the stream takes 0.0525 against
//           0.0451, a thread a neuron with 4-byte loads took 0.0668
//           (tools/stream_probe.py in turns, the same card).
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
//           steps one element at a time. The backward is one template
//           over g's element type (f32 or bf16; vres and u f32) with two
//           layouts, picked before the launch from T, P and the SM count:
//           - the stream (`lif_bwd_stream_kernel`), the forward's stream
//             run backwards: a thread owns one 16-byte vector of g (4 f32
//             or 8 bf16 neurons) and the vres vectors beside it, and
//             issues the loads of its latest steps first. It takes short
//             T on many neurons (SpikingFormer's and the CNNs' T = 4, the
//             LM's T = 2).
//           - the slab ring, for long T on few neurons (qwen2-moe's shared
//             experts fire over the step's 2048 tokens as their time axis,
//             P = 5632): the stream gave 704 threads on 6 SMs, each
//             walking 2048 dependent steps with 4 steps' loads in flight.
//             A block owns 32 neurons, a lane each, so P / 32 blocks
//             cover the SMs; a producer warp copies chunks of 32 steps of
//             vres and g, the latest first, into a ring of 64 KB of
//             shared-memory stages by TMA boxes on mbarriers
//             (`lif_bwd_ring_kernel<E, true>`, csrc/tma_ring.cuh); eight
//             warps compute each stage's u-free terms (the surrogate's
//             division among them) in place, and one walker warp carries
//             u through the stage in reversed time. Where TMA cannot
//             describe an operand, the producer's lanes fill the same
//             ring by cp.async (`lif_bwd_ring_kernel<E, false>`).
//           The recurrence is not re-associated: every neuron's steps
//           are `lif_bwd_step`'s operations, each rounded on its own, in
//           time order, in both layouts.
//           Neighbouring threads own neighbouring neurons (or
//           vectors), so every load and store is coalesced. The residual
//           mode is a template flag: the same step, plus one store of the
//           pre-reset membrane, so spikes and counts equal the primal
//           kernel's and the primal pays nothing for it.
//           The counts kernel (`lif_counts_kernel`: counts, packed, and
//           counts + residual) streams the same way: a thread owns one
//           16-byte vector (4 lanes) of one row, issues its steps' loads
//           first and stores spikes and residuals as 16-byte vectors.
//           The count map counts the 8-row chunks of the flattened
//           (T*R, K) spikes per 128-lane tile, (ceil(T*R/8),
//           ceil(K/128)): with R % 8 == 0 that is _lif_occ_pallas's
//           (T, R/8, ...) layout flattened. Threads lie over live lanes
//           only: a row takes its tile's vectors in whole word groups (8
//           vectors = 32 lanes) from 32 lanes on, a power of two of
//           vectors below, and narrow rows share a warp (K = 8: 16 rows
//           a warp), so at most a quarter of the threads idle at the
//           models' widths (K = 48, 96, 192); the earlier block of 128
//           lanes x 8 rows idled 94% of them at K = 8. A block holds
//           whole 8-row chunks of one tile and walks items in a
//           grid-stride loop over one wave of blocks. Counts take no
//           barrier a step: each thread pops its 4 spikes, a warp sums
//           the lanes of one chunk (`__reduce_add_sync`, or a shuffle
//           tree where 16 or 8 lanes make a chunk), and one barrier
//           after each group of steps sums a chunk's warps from shared
//           memory and stores the count. A ragged R (VGG11's 2x2 fires
//           at odd batch) puts a chunk across two steps or two blocks:
//           the lanes of a warp that share a count cell
//           (`__match_any_sync`) sum their popcounts and one adds the
//           sum with an integer atomicAdd into a map the caller zeroed
//           (exact, so order does not matter). The packed mode builds
//           each word in registers (bit i = lane 32w+i): a thread
//           shifts its 4-bit nibble to bits 4j of its group, three
//           `__shfl_xor_sync` rounds OR the group's 8 nibbles (fewer for
//           a row under 32 lanes), the group's first thread stores the
//           word, and no f32 spike is written; lanes past K give zero
//           bits, as `pack_spikes_padded` pads. K % 4 != 0 or an
//           unaligned operand takes a scalar instance of the kernel,
//           the same steps one element at a time. Lanes past K (the
//           TPU wrapper's zero pad to 128) are never loaded, so no
//           padded copy of the drive is made.
//           Every operation is rounded on its own (__f*_rn, no FMA
//           contraction) in the order of the plain PyTorch versions in
//           kernels/lif_scan.py, so spikes, residuals and cotangents equal
//           them bit for bit: a contracted v*decay + x could flip a spike
//           that sits exactly at the threshold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"
#include "tma_ring.cuh"

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

constexpr int kLanes = 128;            // lane tile (the map's K tiling)
constexpr int kChunk = 8;              // row chunk (the TPU kernel's block_m)
constexpr int kTileVecs = kLanes / 4;  // 16-byte vectors a lane tile
constexpr int kWordVecs = 8;           // vectors a uint32 word (32 lanes)
constexpr int kCountThreads = 256;     // the most threads a counts block holds

// The counts kernel's layout for K lanes. A thread owns one vector (4
// lanes) of one row; a row takes `slots` threads in each lane tile: the
// tile's vectors, rounded up to whole word groups of 8 vectors from 32
// lanes on, or to a power of two below (SegNet's K = 8: 2 slots, so a
// warp holds 16 rows). A block holds `chunks` 8-row chunks of one lane
// tile, kChunk * chunks * slots threads (256, or 192 at 24 slots); its
// thread i takes row i / slots of the block and vector i % slots of the
// tile. Lanes past K are idle only where K is not a whole word group past
// 32 lanes or a power of two below.
struct CountsLayout {
  int slots, chunks, threads;
  int64_t kt;   // lane tiles, ceil(K/128)
};

inline CountsLayout counts_layout(int64_t k) {
  const int64_t v = (k + 3) / 4;
  int slots = 1;
  if (v >= kTileVecs)
    slots = kTileVecs;
  else if (v >= kWordVecs)
    slots = (int)((v + kWordVecs - 1) / kWordVecs * kWordVecs);
  else
    while (slots < v) slots *= 2;
  const int fit = kCountThreads / (kChunk * slots);
  const int chunks = fit > 1 ? fit : 1;
  return {slots, chunks, kChunk * chunks * slots, (k + kLanes - 1) / kLanes};
}

// x, s (and vres): (T, R, K) contiguous; counts: (ceil(T*R/8),
// ceil(K/128)) int32, zeroed by the caller when R % 8 != 0; words (packed
// mode, instead of s): (T, R, ceil(K/32)) uint32. Items are (8 * chunks
// rows, one lane tile), taken by the blocks in a grid-stride loop. Each
// thread loads the 16-byte vectors of up to kGroup steps before the
// first step's arithmetic and stores its spikes (and residuals) as
// 16-byte vectors; kVec false (K % 4 != 0 or an operand not 16-byte
// aligned) takes the same steps one element at a time.
// Counts: with R % 8 == 0 (kWhole) a block holds whole chunks: a
// chunk's lanes of a warp (all 32, or 8 * slots at 1-2 slots) sum their
// popcounts, one lane puts the sum in shared memory, and after each step
// group one barrier lets a thread a (step, chunk) add its segments and
// store the count. A ragged R puts chunks across steps and blocks: the lanes of a
// warp that share a count cell (`__match_any_sync`) sum their popcounts
// and one of them adds the sum to the zeroed map (an exact integer
// atomicAdd). Words: the 4-bit nibbles of a word group's threads, OR-ed
// over log2(8) shuffle rounds (fewer below 32 lanes); the group's first
// thread stores the word.
template <bool kResidual, bool kPacked, bool kVec, bool kWhole>
__global__ void __launch_bounds__(kCountThreads)
lif_counts_kernel(const float* __restrict__ x, float* __restrict__ s,
                  int* __restrict__ counts, float* __restrict__ vres,
                  uint32_t* __restrict__ words, int64_t t_steps,
                  int64_t rows, int64_t k, float decay, float v_th,
                  bool soft_reset, CountsLayout lay) {
  // Warp-segment sums of a step group, double-buffered so one barrier a
  // group keeps the next group's writes off the sums still being read.
  __shared__ int part[2][kGroup][kCountThreads / kChunk];
  const int tid = threadIdx.x;
  const int slot = tid % lay.slots;
  const int row_in = tid / lay.slots;
  const int wg = lay.slots < kWordVecs ? lay.slots : kWordVecs;
  const int seg = kChunk * lay.slots < 32 ? kChunk * lay.slots : 32;
  const int segs = kChunk * lay.slots / seg;   // warp segments a chunk
  const int sum_g = tid / lay.chunks, sum_ch = tid % lay.chunks;
  const int64_t kw = (k + 31) / 32;
  const int64_t plane = rows * k;     // elements a step
  const int64_t wplane = rows * kw;   // words a step
  const int64_t block_rows = (int64_t)kChunk * lay.chunks;
  const int64_t row_blocks = (rows + block_rows - 1) / block_rows;
  // Items (row block, tile), row-major, stepped by the grid with no
  // division an item.
  const int64_t kt = lay.kt;
  const int64_t step_rb = gridDim.x / kt, step_tile = gridDim.x % kt;
  int64_t rb = blockIdx.x / kt, tile = blockIdx.x % kt;
  int parity = 0;
  while (rb < row_blocks) {
    const int64_t row0 = rb * block_rows;
    const int64_t row = row0 + row_in;
    const int vidx = (int)tile * kTileVecs + slot;
    const int64_t n0 = 4 * (int64_t)vidx;
    const int lanes =
        row < rows && n0 < k ? (k - n0 < 4 ? (int)(k - n0) : 4) : 0;
    const int64_t at = row * k + n0;   // the thread's lane 0 at step 0
    const int word = vidx / kWordVecs;
    const bool stores_word = slot % wg == 0 && row < rows && word < kw;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int64_t t0 = 0; t0 < t_steps; t0 += kGroup, parity ^= 1) {
      // The vector path issues its steps' loads first; the scalar path
      // loads each lane at its step.
      uint32_t in[kGroup][4];
      if (kVec) {
        const float* xq = x + t0 * plane + at;
#pragma unroll
        for (int g = 0; g < kGroup; ++g, xq += plane)
          if (lanes != 0 && t0 + g < t_steps) load16(in[g], xq);
      }
      int64_t off = t0 * plane + at;
      uint32_t* wq = words + t0 * wplane + row * kw + word;
      int64_t trow = t0 * rows + row;   // the flattened row (ragged R)
#pragma unroll
      for (int g = 0; g < kGroup;
           ++g, off += plane, wq += wplane, trow += rows) {
        if (t0 + g >= t_steps) break;   // uniform over the grid
        uint32_t nib = 0u;
        if (lanes != 0 && kVec) {
          uint32_t sp[4], vv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float r;
            const float f = lif_step(v[i], __uint_as_float(in[g][i]), decay,
                                     v_th, soft_reset, r);
            sp[i] = __float_as_uint(f);
            vv[i] = __float_as_uint(r);
            if (f != 0.0f) nib |= 1u << i;
          }
          if (!kPacked) store16(s + off, sp);
          if (kResidual) store16(vres + off, vv);
        } else if (lanes != 0) {   // the scalar path: a lane at a time
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i < lanes) {
              float r;
              const float f =
                  lif_step(v[i], x[off + i], decay, v_th, soft_reset, r);
              if (f != 0.0f) nib |= 1u << i;
              if (!kPacked) s[off + i] = f;
              if (kResidual) vres[off + i] = r;
            }
          }
        }
        if (kPacked) {
          // Bit i of word w is lane 32w + i: thread j of the group holds
          // bits 4j .. 4j + 3. Groups start at multiples of wg in a warp.
          uint32_t w = nib << (4 * (slot % wg));
          for (int o = 1; o < wg; o <<= 1)
            w |= __shfl_xor_sync(0xffffffffu, w, o);
          if (stores_word) *wq = w;
        }
        int c = __popc(nib);
        if (kWhole) {
          if (seg == 32) {
            c = __reduce_add_sync(0xffffffffu, c);
          } else {
            for (int o = seg / 2; o > 0; o >>= 1)
              c += __shfl_xor_sync(0xffffffffu, c, o);
          }
          if ((tid & (seg - 1)) == 0) part[parity][g][tid / seg] = c;
        } else {
          const long long cell =
              row < rows ? (long long)(trow / kChunk * kt + tile) : -1ll;
          const unsigned peers = __match_any_sync(0xffffffffu, cell);
          c = __reduce_add_sync(peers, c);
          if (cell >= 0 && c != 0 && (tid & 31) == __ffs(peers) - 1)
            atomicAdd(counts + cell, c);
        }
      }
      if (kWhole) {
        __syncthreads();
        const int64_t first = row0 + (int64_t)sum_ch * kChunk;
        if (tid < kGroup * lay.chunks && t0 + sum_g < t_steps &&
            first < rows) {
          int c = 0;
          for (int q = 0; q < segs; ++q)
            c += part[parity][sum_g][sum_ch * segs + q];
          counts[((t0 + sum_g) * rows + first) / kChunk * kt + tile] = c;
        }
      }
    }
    rb += step_rb;
    tile += step_tile;
    if (tile >= kt) {
      tile -= kt;
      ++rb;
    }
  }
}

// One reversed step of the backward at the pre-reset membrane v and the
// spike cotangent g (the TPU kernel's order, repro/kernels/lif_scan.py:
// 107-138):
//   sg     = (alpha/2) / (1 + (pi/2*alpha * (v - v_th))^2)
//   dreset = 1 - v_th*sg (soft)  |  (1 - S) - v*sg (hard)
//   dv     = g*sg + u*dreset;  dx = dv;  u = decay*dv
// in two parts: the terms g*sg and dreset, which do not depend on u, and
// the carry through u. The slab ring computes them on other warps than
// the one that walks u; rounded the same, each part alone.
__device__ __forceinline__ void lif_bwd_terms(float v, float g, float v_th,
                                              bool soft_reset,
                                              float half_alpha,
                                              float half_pi_alpha,
                                              float& gsg, float& dreset) {
  const float d = __fmul_rn(half_pi_alpha, __fsub_rn(v, v_th));
  const float sg = __fdiv_rn(half_alpha, __fadd_rn(1.0f, __fmul_rn(d, d)));
  if (soft_reset) {
    dreset = __fsub_rn(1.0f, __fmul_rn(v_th, sg));
  } else {
    const float s = v >= v_th ? 1.0f : 0.0f;
    dreset = __fsub_rn(__fsub_rn(1.0f, s), __fmul_rn(v, sg));
  }
  gsg = __fmul_rn(g, sg);
}

__device__ __forceinline__ float lif_bwd_carry(float& u, float gsg,
                                               float dreset, float decay) {
  const float dv = __fadd_rn(gsg, __fmul_rn(u, dreset));
  u = __fmul_rn(decay, dv);
  return dv;
}

__device__ __forceinline__ float lif_bwd_step(float& u, float v, float g,
                                              float decay, float v_th,
                                              bool soft_reset,
                                              float half_alpha,
                                              float half_pi_alpha) {
  float gsg, dreset;
  lif_bwd_terms(v, g, v_th, soft_reset, half_alpha, half_pi_alpha, gsg,
                dreset);
  return lif_bwd_carry(u, gsg, dreset, decay);
}

// The backward's scalars: the decay, the threshold, the reset rule and
// the surrogate's alpha / 2 and pi/2 * alpha.
struct BwdArgs {
  float decay, v_th, half_alpha, half_pi_alpha;
  bool soft_reset;
};

__device__ __forceinline__ float bwd_step(float& u, float v, float g,
                                          const BwdArgs& a) {
  return lif_bwd_step(u, v, g, a.decay, a.v_th, a.soft_reset, a.half_alpha,
                      a.half_pi_alpha);
}

// The stream. vres f32, g and dx of element type E: (T, P) contiguous. A
// thread owns one 16-byte vector of g (V = 4 f32 or 8 bf16 neurons) and
// the V / 4 16-byte vectors of vres beside it, issues the loads of up to
// kGroup steps (the latest first) before their arithmetic, carries the
// membrane cotangent u in f32 registers and stores each step's dx as one
// 16-byte store (bf16 rounded once, there). `vec` and the scalar path as
// in `lif_kernel`.
template <typename E>
__global__ void __launch_bounds__(kFireThreads)
lif_bwd_stream_kernel(const float* __restrict__ vres, const E* __restrict__ g,
                      E* __restrict__ dx, int64_t t_steps, int64_t p,
                      BwdArgs a, bool vec) {
  using L = Lanes<E>;
  constexpr int V = L::kN;
  const int64_t nvec = (p + V - 1) / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < nvec;
       j += stride) {
    const int64_t n0 = j * V;
    float u[V];
#pragma unroll
    for (int i = 0; i < V; ++i) u[i] = 0.0f;
    if (vec && n0 + V <= p) {
      for (int64_t t1 = t_steps; t1 > 0; t1 -= kGroup) {
        uint32_t gin[kGroup][4];
        uint32_t vin[kGroup][V / 4][4];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (t1 - 1 - k < 0) break;
          const int64_t off = (t1 - 1 - k) * p + n0;
          load16(gin[k], g + off);
#pragma unroll
          for (int q = 0; q < V / 4; ++q) load16(vin[k][q], vres + off + 4 * q);
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (t1 - 1 - k < 0) break;
          uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < V; ++i)
            L::put(out, i, bwd_step(u[i],
                                    __uint_as_float(vin[k][i / 4][i % 4]),
                                    L::get(gin[k], i), a));
          store16(dx + (t1 - 1 - k) * p + n0, out);
        }
      }
    } else {
      for (int64_t t = t_steps - 1; t >= 0; --t) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (n0 + i >= p) break;
          const int64_t off = t * p + n0 + i;
          dx[off] = narrow<E>(bwd_step(u[i], vres[off], widen(g[off]), a));
        }
      }
    }
  }
}

// The slab ring. A block owns a slab of kSlab neurons and walks their T
// steps in chunks of kSlabSteps, the latest chunk first, through a ring
// of shared-memory stages; a stage holds one chunk's (kSlabSteps, kSlab)
// box of vres (f32) and of g (E), row r step t0 + r, column c neuron
// n0 + c. Three roles, a warp or more each:
//   - the producer warp fills a free stage: one thread issues two TMA
//     boxes on the stage's `full` mbarrier (`kTma`), or, where TMA cannot
//     describe an operand, each lane copies its column by 4-byte
//     cp.async (bf16 g, which can sit at any 2-byte offset, below
//     cp.async's least copy, by loads and shared stores) and arrives;
//   - kTermWarps term warps compute each element's u-free terms (g*sg and
//     dreset, the surrogate's division included) in place and arrive on
//     `ready`: the division's slow-path branch stops the compiler from
//     overlapping one step's chain with the next, so one warp doing it all
//     spent ~170 cycles a step, and the 32 x 32 elements of a stage are
//     independent;
//   - the walker warp, a lane a neuron with u in its register, runs each
//     stage's carries in reversed time (two shared loads and three
//     dependent operations a step, unrolled), stores dx straight to device
//     memory (a warp's 32 neurons one 64- or 128-byte run a step) and
//     arrives on `empty`.
// Lane l reads and writes column l of a row: consecutive words, or halves
// of one word, so no bank conflict. Rows past T and columns past P arrive
// as zeros; they get terms but are neither walked nor stored.
constexpr int kSlab = 32;          // neurons a block
constexpr int kSlabSteps = 32;     // steps a stage (Tc)
constexpr int kTermWarps = 8;      // warps computing a stage's terms
constexpr int kRingThreads = 32 * (kTermWarps + 2);   // + walker, producer
constexpr int kRingBytes = 64 * 1024;
template <typename E>
struct Slab {
  static constexpr int kVresBytes = kSlabSteps * kSlab * 4;   // then dreset
  static constexpr int kGBytes = kSlabSteps * kSlab * (int)sizeof(E);
  // g*sg in place of an f32 g; after a bf16 g, which is half its width
  static constexpr int kGsgOffset =
      sizeof(E) == 4 ? kVresBytes : kVresBytes + kGBytes;
  static constexpr int kStageBytes = kGsgOffset + kSlabSteps * kSlab * 4;
  static constexpr int kStages = kRingBytes / kStageBytes;   // 8 f32, 6 bf16
  static constexpr int kBytes = kStages * kStageBytes;
  static_assert(kVresBytes % 128 == 0 && kStageBytes % 128 == 0,
                "every TMA box 128-byte aligned");
  static_assert(kSlabSteps % kTermWarps == 0, "whole rows a term warp");
};

__host__ __device__ __forceinline__ int slab_chunks(int64_t t_steps) {
  return (int)((t_steps + kSlabSteps - 1) / kSlabSteps);
}

// The cp.async fill of one stage by the producer warp: lane l copies
// column l of chunk rows [t0, t0 + kSlabSteps), zeros past T and P, then
// arrives on `full` as its copies land (and, for a bf16 g, once more after
// its shared stores).
template <typename E>
__device__ __forceinline__ void fill_async(unsigned char* stage,
                                           const float* __restrict__ vres,
                                           const E* __restrict__ g,
                                           int64_t t0, int64_t t_steps,
                                           int64_t p, int64_t col, bool live,
                                           int lane, uint64_t* full) {
  float* vs = reinterpret_cast<float*>(stage) + lane;
  E* gs = reinterpret_cast<E*>(stage + Slab<E>::kVresBytes) + lane;
#pragma unroll 8
  for (int r = 0; r < kSlabSteps; ++r) {
    const bool in = live && t0 + r < t_steps;
    const int64_t off = in ? (t0 + r) * p + col : 0;
    tile_mma::cp4(vs + r * kSlab, vres + off, in);
    if constexpr (sizeof(E) == 4) tile_mma::cp4(gs + r * kSlab, g + off, in);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   tma_ring::smem_addr(full))
               : "memory");
  if constexpr (sizeof(E) != 4) {
    E gq[kSlabSteps];
#pragma unroll
    for (int r = 0; r < kSlabSteps; ++r)
      gq[r] = live && t0 + r < t_steps ? g[(t0 + r) * p + col]
                                       : narrow<E>(0.0f);
#pragma unroll
    for (int r = 0; r < kSlabSteps; ++r) gs[r * kSlab] = gq[r];
    tma_ring::bar_arrive(full);
  }
}

// Chunk i (walk order) is chunk chunks - 1 - i in time, in stage
// i % kStages on that stage's (i / kStages)-th fill. The tensor maps are
// read only where kTma.
template <typename E, bool kTma>
__global__ void __launch_bounds__(kRingThreads, 2)
lif_bwd_ring_kernel(const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_g,
                    const float* __restrict__ vres, const E* __restrict__ g,
                    E* __restrict__ dx, int64_t t_steps, int64_t p,
                    BwdArgs a) {
  using S = Slab<E>;
  constexpr int kFillArrivals = kTma ? 1 : sizeof(E) == 4 ? 32 : 64;
  extern __shared__ __align__(128) unsigned char slab_smem[];
  __shared__ __align__(8) uint64_t full[S::kStages], ready[S::kStages],
      empty[S::kStages];
  unsigned char* ring =
      slab_smem + (128 - tma_ring::smem_addr(slab_smem) % 128) % 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = slab_chunks(t_steps);
  const int64_t n0 = (int64_t)blockIdx.x * kSlab, col = n0 + lane;
  const bool live = col < p;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      tma_ring::bar_init(&full[i], kFillArrivals);
      tma_ring::bar_init(&ready[i], kTermWarps);   // a term warp's lane 0
      tma_ring::bar_init(&empty[i], 1);            // the walker's lane 0
    }
    tma_ring::bar_init_fence();
  }
  __syncthreads();
  auto stage_of = [&](int i) {
    return ring + i % S::kStages * S::kStageBytes;
  };
  auto first = [&](int i) { return (int64_t)(chunks - 1 - i) * kSlabSteps; };
  if (warp == kTermWarps + 1) {                     // the producer
    for (int i = 0; i < chunks; ++i) {
      const int slot = i % S::kStages, fill = i / S::kStages;
      if constexpr (kTma) {
        if (lane != 0) return;
        if (fill > 0) tma_ring::bar_wait(&empty[slot], (fill - 1) & 1);
        tma_ring::bar_expect(&full[slot], S::kVresBytes + S::kGBytes);
        tma_ring::tma_box(stage_of(i), &map_v, (int)n0, (int)first(i),
                          &full[slot]);
        tma_ring::tma_box(stage_of(i) + S::kVresBytes, &map_g, (int)n0,
                          (int)first(i), &full[slot]);
      } else {
        if (fill > 0) tma_ring::bar_wait(&empty[slot], (fill - 1) & 1);
        fill_async<E>(stage_of(i), vres, g, first(i), t_steps, p, col, live,
                      lane, &full[slot]);
      }
    }
    return;
  }
  if (warp > 0) {                                   // a term warp
    constexpr int kRows = kSlabSteps / kTermWarps;
    for (int i = 0; i < chunks; ++i) {
      const int slot = i % S::kStages;
      tma_ring::bar_wait(&full[slot], (i / S::kStages) & 1);
      unsigned char* stage = stage_of(i);
      float* vs = reinterpret_cast<float*>(stage) + lane;
      const E* gs = reinterpret_cast<const E*>(stage + S::kVresBytes) + lane;
      float* gsg = reinterpret_cast<float*>(stage + S::kGsgOffset) + lane;
      float v[kRows], gv[kRows], q[kRows], dres[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = warp - 1 + k * kTermWarps;
        v[k] = vs[r * kSlab];
        gv[k] = widen(gs[r * kSlab]);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        lif_bwd_terms(v[k], gv[k], a.v_th, a.soft_reset, a.half_alpha,
                      a.half_pi_alpha, q[k], dres[k]);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = warp - 1 + k * kTermWarps;
        vs[r * kSlab] = dres[k];
        gsg[r * kSlab] = q[k];
      }
      // The stage is refilled by TMA (the async proxy) after the walk.
      if constexpr (kTma)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) tma_ring::bar_arrive(&ready[slot]);
    }
    return;
  }
  float u = 0.0f;                                   // the walker
  for (int i = 0; i < chunks; ++i) {
    const int slot = i % S::kStages;
    tma_ring::bar_wait(&ready[slot], (i / S::kStages) & 1);
    const unsigned char* stage = stage_of(i);
    const float* dres = reinterpret_cast<const float*>(stage) + lane;
    const float* gsg =
        reinterpret_cast<const float*>(stage + S::kGsgOffset) + lane;
    const int64_t t0 = first(i);
    const int rows =
        t_steps - t0 < kSlabSteps ? (int)(t_steps - t0) : kSlabSteps;
    E* out = dx + (t0 + rows - 1) * p + col;
    auto carry = [&](int r) {
      const float d = lif_bwd_carry(u, gsg[r * kSlab], dres[r * kSlab],
                                    a.decay);
      if (live) *out = narrow<E>(d);
      out -= p;
    };
    if (rows == kSlabSteps) {
#pragma unroll
      for (int r = kSlabSteps - 1; r >= 0; --r) carry(r);
    } else {
      for (int r = rows - 1; r >= 0; --r) carry(r);
    }
    __syncwarp();                      // the warp's reads of the stage done
    if (lane == 0) tma_ring::bar_arrive(&empty[slot]);
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

template <bool kResidual, bool kPacked, bool kVec, bool kWhole>
int counts_blocks_per_sm(int threads) {
  static int cached[2] = {0, 0};   // 192 and 256 threads
  int& n = cached[threads == kCountThreads];
  if (n == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, lif_counts_kernel<kResidual, kPacked, kVec, kWhole>,
                    threads, 0) != cudaSuccess)
    n = 1;
  return n > 0 ? n : 1;
}

// The grid: every block an SM can hold, on every SM (one whole wave),
// or one block an item where there are fewer items.
template <bool kResidual, bool kPacked, bool kVec, bool kWhole>
int64_t counts_grid(const CountsLayout& lay, int64_t rows) {
  const int64_t block_rows = (int64_t)kChunk * lay.chunks;
  const int64_t items = (rows + block_rows - 1) / block_rows * lay.kt;
  const int64_t wave =
      (int64_t)counts_blocks_per_sm<kResidual, kPacked, kVec, kWhole>(
          lay.threads) * tile_mma::sm_count();
  return items < wave ? items : wave;
}

template <bool kResidual, bool kPacked, bool kVec, bool kWhole>
void launch_counts(const float* x, float* s, int* counts, float* vres,
                   uint32_t* words, int64_t t_steps, int64_t rows,
                   int64_t k, float decay, float v_th, int soft_reset,
                   const CountsLayout& lay, cudaStream_t stream) {
  lif_counts_kernel<kResidual, kPacked, kVec, kWhole>
      <<<(unsigned)counts_grid<kResidual, kPacked, kVec, kWhole>(lay, rows),
         lay.threads, 0, stream>>>(x, s, counts, vres, words, t_steps, rows,
                                   k, decay, v_th, soft_reset != 0, lay);
}

template <bool kResidual, bool kPacked>
int launch_lif_counts(const float* x, float* s, int* counts, float* vres,
                      uint32_t* words, int64_t t_steps, int64_t rows,
                      int64_t k, float decay, float v_th, int soft_reset,
                      void* stream) {
  if (rows > 0 && k > 0 && t_steps > 0) {
    const CountsLayout lay = counts_layout(k);
    const bool vec = k % 4 == 0 && aligned16(x) &&
                     (kPacked || aligned16(s)) &&
                     (!kResidual || aligned16(vres));
    const bool whole = rows % kChunk == 0;
    (vec ? whole ? launch_counts<kResidual, kPacked, true, true>
                 : launch_counts<kResidual, kPacked, true, false>
         : whole ? launch_counts<kResidual, kPacked, false, true>
                 : launch_counts<kResidual, kPacked, false, false>)(
        x, s, counts, vres, words, t_steps, rows, k, decay, v_th, soft_reset,
        lay, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// out = {slots, chunks, threads, lane tiles, grid, SMs, blocks an SM}:
// the launch (16-byte vectors, R % 8 == 0) of mode 0 (counts), 1
// (packed) or 2 (counts + residual).
template <bool kResidual, bool kPacked>
int report_counts_launch(int64_t rows, int64_t k, int* out) {
  const CountsLayout lay = counts_layout(k);
  out[0] = lay.slots;
  out[1] = lay.chunks;
  out[2] = lay.threads;
  out[3] = (int)lay.kt;
  out[4] = (int)counts_grid<kResidual, kPacked, true, true>(lay, rows);
  out[5] = tile_mma::sm_count();
  out[6] = counts_blocks_per_sm<kResidual, kPacked, true, true>(lay.threads);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ backward
// Layouts of the backward (the report's codes).
constexpr int kStream = 0, kTmaRing = 1, kAsyncRing = 2;

// The switch, from the sweep of the layouts on the H100
// (tools/lif_bwd_sweep.py; PERF.md, PR 38): the slab ring from
// kRingMinSteps steps on, where the stream would have fewer 16-byte
// vectors an SM than kRingVecsPerStep a step, up to kRingMaxVecsPerSM;
// the stream elsewhere. Below 16 steps a ring block's set-up outweighs
// its walk; with many vectors an SM the stream's threads hide their own
// latency and both layouts move bytes at about the same rate.
constexpr int64_t kRingMinSteps = 16;
constexpr int64_t kRingVecsPerStep = 2;
constexpr int64_t kRingMaxVecsPerSM = 256;

template <typename E>
bool ring_pays(int64_t t_steps, int64_t p) {
  constexpr int V = Lanes<E>::kN;
  const int64_t per_sm = t_steps * kRingVecsPerStep < kRingMaxVecsPerSM
                             ? t_steps * kRingVecsPerStep
                             : kRingMaxVecsPerSM;
  return t_steps >= kRingMinSteps &&
         (p + V - 1) / V < per_sm * tile_mma::sm_count();
}

// TMA describes both operands: bases 16-byte aligned (`aligned`), row
// pitches multiples of 16 bytes, box coordinates within int.
template <typename E>
bool tma_describes(bool aligned, int64_t t_steps, int64_t p) {
  return aligned && p % (int64_t)(16 / sizeof(E)) == 0 && p % 4 == 0 &&
         p <= INT32_MAX && t_steps <= INT32_MAX - kSlabSteps;
}

template <typename E>
int auto_layout(int64_t t_steps, int64_t p, bool aligned) {
  if (!ring_pays<E>(t_steps, p)) return kStream;
  return tma_describes<E>(aligned, t_steps, p) ? kTmaRing : kAsyncRing;
}

template <typename E>
struct TmaType;
template <>
struct TmaType<float> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

int64_t slabs(int64_t p) { return (p + kSlab - 1) / kSlab; }
constexpr int kRingSlack = 128;    // to align the ring to 128 bytes

template <typename E>
int launch_bwd(const float* vres, const E* g, E* dx, int64_t t_steps,
               int64_t p, const BwdArgs& a, int layout, cudaStream_t st) {
  using S = Slab<E>;
  if (layout == kStream) {
    constexpr int V = Lanes<E>::kN;
    const bool vec = (p % V == 0 || t_steps == 1) && aligned16(vres) &&
                     aligned16(g) && aligned16(dx);
    lif_bwd_stream_kernel<E>
        <<<flat_blocks((p + V - 1) / V, kFireThreads), kFireThreads, 0, st>>>(
            vres, g, dx, t_steps, p, a, vec);
  } else if (layout == kTmaRing || layout == kAsyncRing) {
    // A failed encode is an error, never a quiet change of layout.
    CUtensorMap map_v{}, map_g{};
    const bool tma = layout == kTmaRing;
    if (tma &&
        (!tma_describes<E>(aligned16(vres) && aligned16(g), t_steps, p) ||
         !tma_ring::encode(&map_v, vres, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                           t_steps, p, kSlabSteps, kSlab,
                           CU_TENSOR_MAP_SWIZZLE_NONE) ||
         !tma_ring::encode(&map_g, g, TmaType<E>::kType, (int)sizeof(E),
                           t_steps, p, kSlabSteps, kSlab,
                           CU_TENSOR_MAP_SWIZZLE_NONE)))
      return (int)cudaErrorNotSupported;
    auto kernel = tma ? lif_bwd_ring_kernel<E, true>
                      : lif_bwd_ring_kernel<E, false>;
    const int bytes = S::kBytes + kRingSlack;
    const cudaError_t err = tile_fma::allow_dynamic_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)slabs(p), kRingThreads, bytes, st>>>(
        map_v, map_g, vres, g, dx, t_steps, p, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// layout < 0: the switch's choice for these shapes and pointers.
template <typename E>
int backward(const float* vres, const E* g, E* dx, int64_t t_steps,
             int64_t p, float decay, float v_th, int soft_reset,
             float half_alpha, float half_pi_alpha, int layout,
             void* stream) {
  if (p <= 0 || t_steps <= 0) return (int)cudaGetLastError();
  if (layout < 0)
    layout = auto_layout<E>(t_steps, p, aligned16(vres) && aligned16(g));
  const BwdArgs a{decay, v_th, half_alpha, half_pi_alpha, soft_reset != 0};
  return launch_bwd<E>(vres, g, dx, t_steps, p, a, layout,
                       (cudaStream_t)stream);
}

// out = {layout, neurons a thread's vector (stream) or a block (ring),
// threads a block, grid, steps a load group (stream) or a stage (ring),
// stages (0 for the stream), SMs}.
template <typename E>
int report_bwd_launch(int64_t t_steps, int64_t p, int* out) {
  constexpr int V = Lanes<E>::kN;
  const int layout = auto_layout<E>(t_steps, p, true);
  const bool ring = layout != kStream;
  out[0] = layout;
  out[1] = ring ? kSlab : V;
  out[2] = ring ? kRingThreads : kFireThreads;
  out[3] = ring ? (int)slabs(p) : flat_blocks((p + V - 1) / V, kFireThreads);
  out[4] = ring ? kSlabSteps : kGroup;
  out[5] = ring ? Slab<E>::kStages : 0;
  out[6] = tile_mma::sm_count();
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

// x, s: (T, P) bf16; vres (T, P) f32, the membrane as the kernel holds it.
extern "C" int lif_fwd_bf16_forward(const __nv_bfloat16* x, __nv_bfloat16* s,
                                    float* vres, int64_t t_steps, int64_t p,
                                    float decay, float v_th, int soft_reset,
                                    void* stream) {
  return launch_lif<__nv_bfloat16, true>(x, s, vres, t_steps, p, decay, v_th,
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

// The launch of `lif_counts_kernel` for R rows of K lanes: out = {slots,
// chunks, threads, lane tiles, grid, SMs, blocks an SM} (7 ints); mode 0
// is the counts mode, 1 the packed, 2 counts + residual.
extern "C" int lif_counts_launch(int64_t rows, int64_t k, int mode,
                                 int* out) {
  switch (mode) {
    case 1: return report_counts_launch<false, true>(rows, k, out);
    case 2: return report_counts_launch<true, false>(rows, k, out);
    default: return report_counts_launch<false, false>(rows, k, out);
  }
}

// vres, g, dx: (T, P) f32.
extern "C" int lif_backward(const float* vres, const float* g, float* dx,
                            int64_t t_steps, int64_t p, float decay,
                            float v_th, int soft_reset, float half_alpha,
                            float half_pi_alpha, void* stream) {
  return backward<float>(vres, g, dx, t_steps, p, decay, v_th, soft_reset,
                         half_alpha, half_pi_alpha, -1, stream);
}

// vres: (T, P) f32; g, dx: (T, P) bf16.
extern "C" int lif_bf16_backward(const float* vres, const __nv_bfloat16* g,
                                 __nv_bfloat16* dx, int64_t t_steps,
                                 int64_t p, float decay, float v_th,
                                 int soft_reset, float half_alpha,
                                 float half_pi_alpha, void* stream) {
  return backward<__nv_bfloat16>(vres, g, dx, t_steps, p, decay, v_th,
                                 soft_reset, half_alpha, half_pi_alpha, -1,
                                 stream);
}

// The backward in the named layout (0 the stream, 1 the TMA ring, 2 the
// cp.async ring) whatever the switch would pick; g and dx bf16 where
// `bf16`, else f32. The TMA ring on operands it cannot describe fails
// with cudaErrorNotSupported.
extern "C" int lif_bwd_forced(const float* vres, const void* g, void* dx,
                              int64_t t_steps, int64_t p, float decay,
                              float v_th, int soft_reset, float half_alpha,
                              float half_pi_alpha, int bf16, int layout,
                              void* stream) {
  if (layout < 0) return (int)cudaErrorInvalidValue;
  return bf16 ? backward<__nv_bfloat16>(
                    vres, static_cast<const __nv_bfloat16*>(g),
                    static_cast<__nv_bfloat16*>(dx), t_steps, p, decay, v_th,
                    soft_reset, half_alpha, half_pi_alpha, layout, stream)
              : backward<float>(vres, static_cast<const float*>(g),
                                static_cast<float*>(dx), t_steps, p, decay,
                                v_th, soft_reset, half_alpha, half_pi_alpha,
                                layout, stream);
}

// The launch the backward makes for T steps of P neurons (bf16 or f32 g)
// on 16-byte aligned operands: out = {layout, width, threads, grid, steps,
// stages, SMs} (7 ints) as `report_bwd_launch` gives them.
extern "C" int lif_bwd_launch(int64_t t_steps, int64_t p, int bf16,
                              int* out) {
  return bf16 ? report_bwd_launch<__nv_bfloat16>(t_steps, p, out)
              : report_bwd_launch<float>(t_steps, p, out);
}
