// The TMA machinery of the producer-warp rings: mbarriers, 2D box copies
// (cp.async.bulk.tensor) and the tensor-map encoder, shared by kernel 10's
// wide path (csrc/spike_matmul.cu `pred_tma_kernel`) and the LIF
// backward's slab ring (csrc/lif.cu `lif_bwd_tma_kernel`).
//
// A ring stage is filled by one producer thread: `bar_expect` arms the
// stage's `full` barrier with the bytes its boxes carry, `tma_box` copies
// each box and completes those bytes on it; consumers `bar_wait` on `full`
// and arrive on the stage's `empty` barrier once they have read it. The
// tensor maps are encoded on the host per launch through the driver entry
// point `cuTensorMapEncodeTiled`, looked up through the runtime, so no
// library links libcuda. A box past the matrix's edges is zero-filled and
// still completes its whole byte count.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma_ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// Makes the barriers' initialisation visible to the other threads and to
// the async proxy (the TMA unit); one thread calls it after its inits,
// before the block's barrier.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Blocks until the phase of parity `parity` has completed. Bounded: a
// broken schedule traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (spins > (1ll << 26)) __trap();
  }
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// The box of `map` at (inner, outer) into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int inner, int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer),
      "r"(smem_addr(bar))
      : "memory");
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// The driver's tensor-map encoder, looked up once through the runtime, so
// the library needs no link to libcuda; null where the driver has none.
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (rows, cols) row-major matrix at `base`, `elem_bytes` an element of
// type `type`, as a tensor map of (box_rows, box_cols) boxes, zeros past
// its edges. False where the driver has no encoder or refuses the map
// (a base not 16-byte aligned, a row pitch not a multiple of 16 bytes).
inline bool encode(CUtensorMap* map, const void* base,
                   CUtensorMapDataType type, int elem_bytes, int64_t rows,
                   int64_t cols, int box_rows, int box_cols,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t step[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same for an f32 matrix.
inline bool encode(CUtensorMap* map, const float* base, int64_t rows,
                   int64_t cols, int box_rows, int box_cols,
                   CUtensorMapSwizzle swizzle) {
  return encode(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rows, cols,
                box_rows, box_cols, swizzle);
}

}  // namespace tma_ring
