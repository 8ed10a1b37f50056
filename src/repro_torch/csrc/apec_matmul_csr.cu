// Fused APEC matmul over a union CSR-of-tiles work list:
// out = res @ w + repeat(ov @ w, g) along the rows, with res and ov as f32
// spikes or as uint32 words.
//
// Replaces: src/repro/kernels/spike_matmul.py::_apec_matmul_csr_kernel
//           (apec_matmul_csr_pallas, pipeline=False) and, on words,
//           ::_apec_matmul_packed_csr_kernel (apec_matmul_packed_csr_pallas,
//           pipeline=False). Their prefetching twins (pipeline=True) are
//           csrc/apec_matmul_csr_pipe.cu, the routes picked on the card;
//           this serial kernel stays reachable by override.
// Bound on the H100: operations at the main path's densities. An occupied
//           residual step costs 2*128*128*N flops and an occupied overlap
//           step 2*(128/g)*128*N, against 64 KB and 64/g KB of spikes:
//           about N/2 flops per byte, above the fp32 ridge (67 TFLOP/s
//           over 3.35 TB/s, ~20) for every N the model uses (96..1536).
//           fp32 FMA on the CUDA cores, for the 1e-5 parity contract
//           (tensor cores would need TF32 or a 3-pass split).
// Design:   grid (m-tile row, n-tile), 256 threads; each block owns one
//           128 x 128 output tile and walks its row's steps
//           row_ptr[r]..row_ptr[r+1] in order (the TPU's sequential grid
//           axis). The union work list visits a k-tile when either
//           operand's tile holds events; per-step counts gate each dot.
//           At a step the block stages the 16-deep weight slice ONCE and
//           feeds it to both dots: the residual's 128-row tile into an
//           8 x 8 register block per thread (rows ty + 16 i, columns
//           tx + 16 j, as csrc/tile_fma.cuh lays them out), and the
//           overlap's 128/g-row tile into a second, (8/g) x 8 block with
//           its own mapping (rows ty + 16 i), so each overlap product is
//           computed once per group, never g times. For g >= 16 the
//           overlap tile has 128/g <= 8 rows, fewer than the 16 thread
//           rows: thread row ty < 128/g owns overlap row ty (a 1 x 8
//           block) and the other thread rows skip the overlap dot, so
//           every group size that divides 128 keeps the same k order.
//           Dummy steps (counts 0) zero empty rows; padding steps past
//           row_ptr[MT] are never reached. The epilogue parks the overlap sums
//           in shared memory (aliasing the staging buffers) and writes
//           acc_res[i] + acc_ov[i / g] for every row i: the repeat happens
//           here, with no pass over the full output. Ragged M, K and N are
//           masked on load and store; no operand is padded. g is any divisor of
//           128 (a template parameter: 1, 2, ..., 128). The staging union lives
//           in dynamic shared memory, opted in past 48 KB
//           (tile_fma::allow_dynamic_smem): at g = 1 its 128 x 128 f32 epilogue
//           tile is 64 KB. The loop is this file's own, so kernels 10 and 11
//           keep their code. Both operands are read through tile_fma.cuh's
//           loaders: the packed form stages each live operand's word tile (128
//           x 4 and 128/g x 4 words) once per step and unpacks bits into the
//           same slices, so its sums equal the f32 form's on the same spikes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_fma.cuh"

namespace {

constexpr int kTile = 128;   // map tile (rows and k), output tile width
constexpr int kSlice = 16;   // k depth staged per shared-memory pass
constexpr int kPad = 4;      // breaks bank conflicts on the A stores
constexpr int kT = 16;       // threads per side (16 x 16 = 256)
constexpr int kThreads = kT * kT;
constexpr int kR = kTile / kT;   // 8 rows / columns per thread

template <int G>
union Smem {
  struct {
    float a[kSlice][kTile + kPad];        // residual slice, k-major
    float ao[kSlice][kTile / G + kPad];   // overlap slice, k-major
    float b[kSlice][kTile];               // weight slice
  } st;
  float ovsum[kTile / G][kTile];          // epilogue: overlap sums
};

// `ra` / `oa`: tile_fma.cuh loaders of the residual (M rows) and the
// overlap (M/g rows); the packed ones' word tiles live in this block's
// shared memory (their `tile` is set here).
template <int G, class RA, class OA>
__global__ void __launch_bounds__(kThreads)
apec_csr_kernel(RA ra, OA oa, const float* __restrict__ w,
                float* __restrict__ out, const int* __restrict__ row_ptr,
                const int* __restrict__ tile_k_idx,
                const int* __restrict__ occ_res,
                const int* __restrict__ occ_ov, int64_t m, int64_t k,
                int64_t n) {
  constexpr int kRo = kTile / G;      // overlap rows per tile
  // Overlap rows per thread: 8/g for g <= 8; for g >= 16 one, held only
  // by the thread rows ty < kRo.
  constexpr int kRMo = kRo >= kT ? kRo / kT : 1;
  static_assert(kTile % G == 0 && (kRo % kT == 0 || kRo < kT),
                "g must divide 128");
  constexpr bool kPacked = !std::is_same<RA, tile_fma::DenseA>::value;
  extern __shared__ __align__(16) unsigned char apec_smem[];
  Smem<G>& sm = *reinterpret_cast<Smem<G>*>(apec_smem);
  __shared__ uint32_t words_r[kPacked ? kTile * tile_fma::kTileWords : 1];
  __shared__ uint32_t words_o[kPacked ? kRo * tile_fma::kTileWords : 1];
  if constexpr (kPacked) {
    ra.tile = words_r;
    oa.tile = words_o;
  }
  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const bool ov_rows = kRo >= kT || ty < kRo;   // holds overlap rows
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int64_t mo0 = (int64_t)blockIdx.x * kRo;
  const int64_t n0 = (int64_t)blockIdx.y * kTile;
  float acc[kR][kR], acco[kRMo][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRMo; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acco[i][j] = 0.0f;

  const int beg = row_ptr[blockIdx.x], end = row_ptr[blockIdx.x + 1];
  for (int step = beg; step < end; ++step) {
    const bool live_r = occ_res[step] > 0, live_o = occ_ov[step] > 0;
    if (!live_r && !live_o) continue;          // dummy step: no events
    const int64_t k0 = (int64_t)tile_k_idx[step] * kTile;
    if (live_r) ra.begin(m0, k0);          // step-uniform: all threads
    if (live_o) oa.begin(mo0, k0);
    for (int kk = 0; kk < kTile; kk += kSlice) {
      if (k0 + kk >= k) break;                 // slice wholly past K
#pragma unroll
      for (int l = 0; l < kTile * kSlice / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int r = e / kTile, c = e % kTile;
        const int64_t gk = k0 + kk + r, gn = n0 + c;
        sm.st.b[r][c] = (gk < k && gn < n) ? w[gk * n + gn] : 0.0f;
      }
      if (live_r) {
#pragma unroll
        for (int l = 0; l < kTile * kSlice / kThreads; ++l) {
          const int e = tid + l * kThreads;
          const int r = e / kSlice, c = e % kSlice;
          sm.st.a[c][r] = ra.at(m0, k0, r, kk + c);
        }
      }
      if (live_o) {
#pragma unroll
        for (int l = 0; l < (kRo * kSlice + kThreads - 1) / kThreads; ++l) {
          const int e = tid + l * kThreads;
          // Compile-time true when the threads split the slice evenly.
          if ((kRo * kSlice) % kThreads == 0 || e < kRo * kSlice) {
            const int r = e / kSlice, c = e % kSlice;
            sm.st.ao[c][r] = oa.at(mo0, k0, r, kk + c);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kSlice; ++c) {
        float b[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) b[j] = sm.st.b[c][tx + kT * j];
        if (live_r) {
          float a[kR];
#pragma unroll
          for (int i = 0; i < kR; ++i) a[i] = sm.st.a[c][ty + kT * i];
#pragma unroll
          for (int i = 0; i < kR; ++i)
#pragma unroll
            for (int j = 0; j < kR; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (live_o && ov_rows) {
          float a[kRMo];
#pragma unroll
          for (int i = 0; i < kRMo; ++i) a[i] = sm.st.ao[c][ty + kT * i];
#pragma unroll
          for (int i = 0; i < kRMo; ++i)
#pragma unroll
            for (int j = 0; j < kR; ++j)
              acco[i][j] = fmaf(a[i], b[j], acco[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // Epilogue: overlap row o of the tile serves residual rows o*G..o*G+G-1
  // (128 % G == 0, so groups never straddle two tiles).
  __syncthreads();
  if (ov_rows) {
#pragma unroll
    for (int i = 0; i < kRMo; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j)
        sm.ovsum[ty + kT * i][tx + kT * j] = acco[i][j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int lr = ty + kT * i;
    const int64_t r = m0 + lr;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int64_t c = n0 + tx + kT * j;
      if (c < n) out[r * n + c] = acc[i][j] + sm.ovsum[lr / G][tx + kT * j];
    }
  }
}

template <int G, class RA, class OA>
cudaError_t launch(RA ra, OA oa, const float* w, float* out,
                   const int* row_ptr, const int* tile_k_idx,
                   const int* occ_res, const int* occ_ov, int64_t m,
                   int64_t k, int64_t n, int64_t mt, cudaStream_t stream) {
  auto kernel = apec_csr_kernel<G, RA, OA>;
  constexpr int kBytes = sizeof(Smem<G>);
  const cudaError_t err = tile_fma::allow_dynamic_smem(kernel, kBytes);
  if (err != cudaSuccess) return err;
  // m-tile rows on x (no 65535 limit); neighbouring blocks share the
  // n-tile's weight slices in L2.
  dim3 grid((unsigned)mt, (unsigned)((n + kTile - 1) / kTile));
  kernel<<<grid, kThreads, kBytes, stream>>>(
      ra, oa, w, out, row_ptr, tile_k_idx, occ_res, occ_ov, m, k, n);
  return cudaSuccess;
}

}  // namespace

// res: (M, K) f32, ov: (M/g, K) f32, w: (K, N) f32, out: (M, N) f32;
// row_ptr: (MT+1,), tile_k_idx / occ_res / occ_ov: (cap,) int32 with
// MT = ceil(M/128); g in {1, 2, 4, ..., 128}.
extern "C" int apec_matmul_csr_forward(const float* res, const float* ov,
                                       const float* w, float* out,
                                       const int* row_ptr,
                                       const int* tile_k_idx,
                                       const int* occ_res, const int* occ_ov,
                                       int64_t m, int64_t k, int64_t n,
                                       int64_t mt, int64_t g, void* stream) {
  if (g < 1 || m % g != 0) return (int)cudaErrorInvalidValue;
  if (m > 0 && n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const tile_fma::DenseA ra{res, m, k}, oa{ov, m / g, k};
    cudaError_t err = cudaSuccess;
    if (!tile_fma::dispatch_group(g, [&](auto gc) {
          err = launch<decltype(gc)::value>(ra, oa, w, out, row_ptr,
                                            tile_k_idx, occ_res, occ_ov, m,
                                            k, n, mt, st);
        }))
      return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The same on words: res (M, KW) and ov (M/g, KW) uint32 covering
// K <= 32*KW columns (bits past K zero); the rest as above.
extern "C" int apec_matmul_packed_csr_forward(
    const uint32_t* res, const uint32_t* ov, const float* w, float* out,
    const int* row_ptr, const int* tile_k_idx, const int* occ_res,
    const int* occ_ov, int64_t m, int64_t kw, int64_t k, int64_t n,
    int64_t mt, int64_t g, void* stream) {
  if (g < 1 || m % g != 0) return (int)cudaErrorInvalidValue;
  if (m > 0 && n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const tile_fma::PackedA<kTile> ra{res, m, kw, nullptr};
    cudaError_t err = cudaSuccess;
    if (!tile_fma::dispatch_group(g, [&](auto gc) {
          constexpr int G = decltype(gc)::value;
          err = launch<G>(ra,
                          tile_fma::PackedA<kTile / G>{ov, m / G, kw, nullptr},
                          w, out, row_ptr, tile_k_idx, occ_res, occ_ov, m, k,
                          n, mt, st);
        }))
      return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
