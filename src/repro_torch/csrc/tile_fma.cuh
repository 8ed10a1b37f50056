// The map tile, the dynamic shared-memory opt-in and the group-size
// dispatch that the pipelined, fused, walking and predicated kernels
// launch with. The tile loops themselves live in csrc/tile_mma.cuh (the
// cp.async ring of kernels 12, 14, 16 and 18 and of kernel 10's ring
// path, the fp32 thread tile), csrc/tile_tc.cuh (the APEC kernels'
// tensor-core loop) and csrc/event_walk.cuh (the serial kernels 11, 13,
// 15 and 17); kernel 10's TMA path is in csrc/spike_matmul.cu.
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

}  // namespace tile_fma
