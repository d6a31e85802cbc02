// Pairwise l1 distance between client weight vectors for Hopper (sm_90a):
// out[i][j] = sum_d |x[i][d] - x[j][d]| (paper Eq. 3, Phase-1 grouping).
//
// Replaces the Pallas TPU kernel src/repro/kernels/l1_distance/kernel.py
// pairwise_l1 (_l1_kernel, tri_decode).
//
// What bounds it on an H100: f32 operations on the CUDA cores. |a - b| has no
// tensor-core form, and each element of x is reused by up to M pairs, so at
// M = 260 the kernel does ~100x more arithmetic than the 162 MB it must read
// would cost in bandwidth. The design therefore maximises arithmetic per
// shared-memory load and keeps all 132 SMs busy:
//   * A block owns one (kTM x kTM) tile of pairs on or above the diagonal
//     (a 2-D grid; blocks below the diagonal exit at once, which replaces the
//     TPU's tri_decode sqrt-and-correct index map). Row and column tiles of
//     x are staged over chunks of kKD along D in shared memory, k-major, and
//     each thread keeps a 4 x 4 register tile of sums: two 16-byte shared
//     loads feed 32 f32 adds.
//   * Only kTM^2/2-ish tiles exist at small M (15 at M = 260), too few for
//     132 SMs, so D is split into S chunks (grid.z): each chunk writes its own
//     partial (S, M, M) slab, and a second small kernel sums the slabs in a
//     fixed order. No atomics: the result is deterministic.
//   * The reduction kernel writes both (i, j) and (j, i) from the same upper
//     partial, so the mirrored matrix is exactly symmetric and the JAX
//     wrapper's triu + triu(., 1).T pass disappears.
// Ragged M and D are masked at the loads (zeros add |0 - 0| = 0); the input
// is never padded. Accumulation is f32 for f32 and bf16 inputs alike.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kTM = 64;        // pair tile edge
constexpr int kKD = 32;        // D chunk staged in shared memory per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 pairs each
constexpr int kPad = 4;        // keeps rows 16-byte aligned for float4 reads

template <typename T>
__global__ void __launch_bounds__(kThreads)
l1_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int M,
                  int64_t D, int64_t chunk) {
  const int tj = blockIdx.x, ti = blockIdx.y, s = blockIdx.z;
  if (ti > tj) return;                      // lower triangle: mirrored later
  const int64_t k_begin = static_cast<int64_t>(s) * chunk;
  const int64_t k_end = k_begin + chunk < D ? k_begin + chunk : D;
  __shared__ __align__(16) float As[kKD][kTM + kPad];
  __shared__ __align__(16) float Bs[kKD][kTM + kPad];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = ti * kTM, j0 = tj * kTM;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kKD) {
    // 32 consecutive threads read 32 consecutive d of one row: coalesced
    for (int e = threadIdx.x; e < kTM * kKD; e += kThreads) {
      const int r = e / kKD, kk = e % kKD;
      const int64_t k = k0 + kk;
      const bool in_k = k < k_end;
      const int gi = i0 + r, gj = j0 + r;
      As[kk][r] = (in_k && gi < M) ? to_f32(x[static_cast<int64_t>(gi) * D + k]) : 0.f;
      Bs[kk][r] = (in_k && gj < M) ? to_f32(x[static_cast<int64_t>(gj) * D + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKD; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += fabsf(av[p] - bv[q]);
    }
    __syncthreads();
  }
  float* slab = partial + static_cast<int64_t>(s) * M * M;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gi = i0 + ty * 4 + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gj = j0 + tx * 4 + q;
      if (gi < M && gj < M) slab[static_cast<int64_t>(gi) * M + gj] = acc[p][q];
    }
  }
}

__global__ void l1_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int M, int S) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t MM = static_cast<int64_t>(M) * M;
  if (idx >= MM) return;
  const int i = static_cast<int>(idx / M), j = static_cast<int>(idx % M);
  // a <= b implies tile(a) <= tile(b): the partial there was computed
  const int64_t at = static_cast<int64_t>(min(i, j)) * M + max(i, j);
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += partial[s * MM + at];
  out[idx] = sum;
}

}  // namespace

extern "C" int p4_l1_tile_m() { return kTM; }
extern "C" int p4_l1_tile_d() { return kKD; }

// partial: (S, M, M) f32 scratch; out: (M, M) f32. chunk % kKD == 0 and
// S * chunk >= D. dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int p4_pairwise_l1(const void* x, float* partial, float* out, int64_t M,
                              int64_t D, int64_t S, int64_t chunk, int dtype,
                              cudaStream_t stream) {
  if (M <= 0) return 0;
  if (M > 0x7fffffffLL || S <= 0 || S > 65535 || chunk <= 0 || chunk % kKD != 0 ||
      S * chunk < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned T = static_cast<unsigned>((M + kTM - 1) / kTM);
  if (T > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(T, T, static_cast<unsigned>(S));
  if (dtype == 0) {
    l1_partial_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), partial, static_cast<int>(M), D, chunk);
  } else if (dtype == 1) {
    l1_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), partial, static_cast<int>(M), D, chunk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t MM = M * M;
  const int threads = 256;
  l1_reduce_kernel<<<static_cast<unsigned>((MM + threads - 1) / threads), threads, 0,
                     stream>>>(partial, out, static_cast<int>(M), static_cast<int>(S));
  return static_cast<int>(cudaGetLastError());
}
