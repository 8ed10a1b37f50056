// Probe of the pipelined APEC kernels' slice loop (csrc/apec_matmul_csr_pipe.cu
// on csrc/tile_tc.cuh) on one H100: clocks a 32-deep slice of one block of
// 8 warps an SM, at g = 2 and BN = 128 (fc1's instance), with the kernel's
// fragment loads, split and MMAs on a ring of four stages:
//   mma       the 144 m16n8k16 MMAs a warp and slice alone (the weights'
//             bits taken as all three parts): the mma.sync issue rate;
//   loop      the slice loop as the kernel runs it, no copies;
//   cp.async  the loop with the kernel's copies (192 spike rows x 128 B and
//             32 weight rows x 512 B a slice, 16 bytes a cp.async);
//   bulk      the loop with the same bytes as one cp.async.bulk a row,
//             completed on an mbarrier a stage.
// Build and run: python3 tools/apec_tc_probe.py (needs nvcc and a card).
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "../src/repro_torch/csrc/tile_tc.cuh"

namespace {

using namespace tile_tc;
constexpr int kBN = 128, kNJ = kBN / 32, kStages = 4, kSlices = 2000;
constexpr int kRowA = kSlice + kPadA, kRowW = kBN + kPadB;
constexpr int kRowsA = 128 + 64;                    // residual + overlap
constexpr int kStage = (kRowsA * kRowA + kSlice * kRowW) * 4;
constexpr int kK = 1024;               // global spike rows and row length

enum Mode { kMma, kLoop, kCpAsync, kBulk };

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk(void* dst, const void* src, int bytes,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(sa(dst)),
      "l"(src), "r"(bytes), "r"(sa(bar))
      : "memory");
}

// Bounded: a fault traps instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (long long n = 0; !done; ++n) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(sa(bar)), "r"(parity)
        : "memory");
    if (n > (1ll << 26)) __trap();
  }
}

template <Mode M>
__global__ void __launch_bounds__(256, 1)
probe(const float* gs, const float* gw, float* out, long long* clk) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4, wm = warp / 4, wn = warp % 4;
  for (int e = threadIdx.x; e < kStages * kStage / 4; e += 256)
    reinterpret_cast<float*>(ring)[e] = (e % 3 == 0) ? 1.0f : 0.0f;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared.b64 [%0], 1;" ::"r"(sa(&bars[s])));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  float acc[4][kNJ][4] = {}, acco[2][kNJ][4] = {};
  const Dense<128> loader(nullptr, 0, 0, true);
  auto issue = [&](int slice) {
    unsigned char* st = ring + (slice % kStages) * kStage;
    float* sw = reinterpret_cast<float*>(st + kRowsA * kRowA * 4);
    const int k0 = slice * kSlice % kK, m0 = blockIdx.x * kRowsA % (kK - kRowsA);
    if (M == kCpAsync) {
      for (int e = threadIdx.x; e < kRowsA * kSlice / 4; e += 256)
        tile_mma::cp16(reinterpret_cast<float*>(st) + e / 8 * kRowA + e % 8 * 4,
                       gs + (size_t)(m0 + e / 8) * kK + k0 + e % 8 * 4, true);
      for (int e = threadIdx.x; e < kSlice * kBN / 4; e += 256)
        tile_mma::cp16(sw + e / 32 * kRowW + e % 32 * 4,
                       gw + (size_t)(k0 + e / 32) * kBN + e % 32 * 4, true);
      tile_mma::commit();
    } else if (M == kBulk) {
      uint64_t* bar = &bars[slice % kStages];
      if (threadIdx.x == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;" ::"r"(
                         sa(bar)),
                     "r"(kRowsA * kSlice * 4 + kSlice * kBN * 4));
      if (threadIdx.x < kRowsA)
        bulk(reinterpret_cast<float*>(st) + threadIdx.x * kRowA,
             gs + (size_t)(m0 + threadIdx.x) * kK + k0, kSlice * 4, bar);
      else if (threadIdx.x < kRowsA + kSlice)
        bulk(sw + (threadIdx.x - kRowsA) * kRowW,
             gw + (size_t)(k0 + threadIdx.x - kRowsA) * kBN, kBN * 4, bar);
    }
  };
  int issued = 0;
  for (; issued < kStages - 1; ++issued) issue(issued);
  const long long t0 = clock64();
  for (int d = 0; d < kSlices; ++d) {
    if (M == kCpAsync) tile_mma::wait_pending(kStages - 2);
    if (M == kBulk) bar_wait(&bars[d % kStages], d / kStages & 1);
    __syncthreads();
    issue(issued++);
    const unsigned char* st = ring + (d % kStages) * kStage;
    const float* sw = reinterpret_cast<const float*>(st + kRowsA * kRowA * 4);
    BFrag b[kNJ];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      if (M == kMma) {
#pragma unroll
        for (int q = 0; q < kParts; ++q)
#pragma unroll
          for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              b[j].b[q][ks][h] = __float_as_uint(
                  sw[(16 * ks + 8 * h + 2 * tig) * kRowW + wn * 32 + 8 * j + gid]);
      } else {
        load_b<kRowW>(sw, wn * 32 + 8 * j + gid, tig, b[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a[kKSteps][4];
      load_a(loader, st, 64 * wm + 16 * i, gid, tig, a);
      mma_tile(acc[i], a, b);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t a[kKSteps][4];
      load_a(loader, st + 128 * kRowA * 4, 32 * wm + 16 * i, gid, tig, a);
      mma_tile(acco[i], a, b);
    }
  }
  if (M == kCpAsync) tile_mma::wait_pending(0);
  if (M == kBulk)
    for (int d = kSlices; d < issued; ++d)
      bar_wait(&bars[d % kStages], d / kStages & 1);
  const long long t1 = clock64();
  float v = 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < kNJ; ++j)
      for (int e = 0; e < 4; ++e) v += acc[i][j][e] + (i < 2 ? acco[i][j][e] : 0.0f);
  out[blockIdx.x * 256 + threadIdx.x] = v;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

template <Mode M>
int run(const char* name, const float* gs, const float* gw, float* out,
        long long* clk, int sms) {
  const int smem = kStages * kStage;
  cudaFuncSetAttribute(probe<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  probe<M><<<sms, 256, smem>>>(gs, gw, out, clk);    // warm
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  probe<M><<<sms, 256, smem>>>(gs, gw, out, clk);
  cudaEventRecord(b);
  const cudaError_t err = cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  long long cycles = 0;
  cudaMemcpy(&cycles, clk, sizeof cycles, cudaMemcpyDeviceToHost);
  // 144 MMAs a warp and slice, two warps a sub-partition.
  printf("{\"mode\": \"%s\", \"ms\": %.4f, \"clocks_per_slice\": %.1f, "
         "\"clocks_per_mma_per_subpartition\": %.3f, \"error\": \"%s\"}\n",
         name, ms, (double)cycles / kSlices, (double)cycles / kSlices / 288.0,
         cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}

}  // namespace

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float *gs, *gw, *out;
  long long* clk;
  cudaMalloc(&gs, (size_t)kK * kK * 4);
  cudaMalloc(&gw, (size_t)kK * kBN * 4);
  cudaMalloc(&out, (size_t)sms * 256 * 4);
  cudaMalloc(&clk, (size_t)sms * 8);
  cudaMemset(gs, 0, (size_t)kK * kK * 4);
  cudaMemset(gw, 0, (size_t)kK * kBN * 4);
  int bad = 0;
  bad |= run<kMma>("mma", gs, gw, out, clk, sms);
  bad |= run<kLoop>("loop", gs, gw, out, clk, sms);
  bad |= run<kCpAsync>("cp.async", gs, gw, out, clk, sms);
  bad |= run<kBulk>("bulk", gs, gw, out, clk, sms);
  bad |= run<kLoop>("loop", gs, gw, out, clk, sms);
  return bad;
}
