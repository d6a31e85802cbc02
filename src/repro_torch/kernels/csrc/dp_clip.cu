// DP-SGD per-example clipping for Hopper (sm_90a): the two passes over the
// per-example flat-gradient matrix of paper Eqs. 10-11.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/dp_clip/kernel.py:
//   sq_norms          (_sq_norm_kernel)    -> sq_norms_kernel below
//   scale_accumulate  (_scale_acc_kernel)  -> scale_accumulate_kernel below
//
// What bounds them on an H100: bytes. Each pass reads the (M*B, D) matrix
// once (15.5 GB in f32 at the paper's CIFAR-10 width) and does 2 flops per
// element, about 0.5 flop/byte against the card's ~20 f32 flop/byte balance.
// So the design aims at streaming reads only:
//   * sq_norms: one block per row, the reduction axis D is a loop inside the
//     block (the TPU walked D as a sequential grid axis and carried the sum
//     in its output block; Hopper's blocks run in no order, so the carry
//     becomes a register loop plus one warp-shuffle reduction). Rows of odd
//     length are not 16-byte aligned, so each row peels a scalar head up to
//     the next 16-byte boundary, then issues 16-byte loads, then a scalar
//     tail: no padding of the input is needed (the JAX wrapper padded to tile
//     multiples, which would double a 15.5 GB buffer here).
//   * scale_accumulate: the client axis M is explicit (grid.y), each thread
//     owns kCols columns of D and loops over the B examples, so a warp reads
//     contiguous 128-byte segments of each row and the sum over b needs no
//     atomics and is deterministic. The clip scales
//     min(1, C / max(sqrt(sq_b), 1e-12)) / denom are computed in the block's
//     prologue from the squared norms of the first pass, a tile of kSB at a
//     time in shared memory.
// Accumulation is f32 for f32 and bf16 inputs alike.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kNormThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
sq_norms_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t D) {
  constexpr int V = 16 / sizeof(T);                 // elements per 16-byte load
  const T* row = x + static_cast<int64_t>(blockIdx.x) * D;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > D) head = D;
  const int64_t nvec = (D - head) / V;
  float acc = 0.f;
  for (int64_t i = threadIdx.x; i < head; i += kNormThreads) {
    const float v = to_f32(row[i]);
    acc = fmaf(v, v, acc);
  }
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < nvec; i += kNormThreads) {
    const uint4 u = __ldg(vec + i);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = to_f32(e[k]);
      acc = fmaf(v, v, acc);
    }
  }
  for (int64_t i = head + nvec * V + threadIdx.x; i < D; i += kNormThreads) {
    const float v = to_f32(row[i]);
    acc = fmaf(v, v, acc);
  }
  // block reduction: warp shuffles, then one warp over the warp sums
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ float warp_sums[kNormThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kNormThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[blockIdx.x] = acc;
  }
}

constexpr int kAccThreads = 256;
constexpr int kCols = 4;      // columns of D per thread, kAccThreads apart
constexpr int kSB = 128;      // clip scales staged in shared memory per tile

template <typename T>
__global__ void __launch_bounds__(kAccThreads)
scale_accumulate_kernel(const T* __restrict__ x, const float* __restrict__ sq,
                        float* __restrict__ out, int B, int64_t D,
                        float clip, float denom) {
  __shared__ float scale[kSB];
  const int m = blockIdx.y;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * (kAccThreads * kCols) + threadIdx.x;
  const T* xm = x + static_cast<int64_t>(m) * B * D;
  const float* sqm = sq + static_cast<int64_t>(m) * B;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int b0 = 0; b0 < B; b0 += kSB) {
    const int nb = min(kSB, B - b0);
    __syncthreads();                         // previous tile fully consumed
    if (threadIdx.x < nb) {
      const float norm = sqrtf(sqm[b0 + threadIdx.x]);
      scale[threadIdx.x] = fminf(1.f, clip / fmaxf(norm, 1e-12f)) / denom;
    }
    __syncthreads();
    for (int b = 0; b < nb; ++b) {
      const float s = scale[b];
      const T* xr = xm + static_cast<int64_t>(b0 + b) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int64_t d = d0 + c * kAccThreads;
        if (d < D) acc[c] = fmaf(s, to_f32(__ldg(xr + d)), acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t d = d0 + c * kAccThreads;
    if (d < D) out[static_cast<int64_t>(m) * D + d] = acc[c];
  }
}

}  // namespace

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16.
extern "C" int p4_sq_norms(const void* x, float* out, int64_t rows, int64_t D,
                           int dtype, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows));
  if (dtype == 0) {
    sq_norms_kernel<float><<<grid, kNormThreads, 0, stream>>>(
        static_cast<const float*>(x), out, D);
  } else if (dtype == 1) {
    sq_norms_kernel<__nv_bfloat16><<<grid, kNormThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), out, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p4_scale_accumulate(const void* x, const float* sq, float* out,
                                   int64_t M, int64_t B, int64_t D, float clip,
                                   float denom, int dtype, cudaStream_t stream) {
  if (M <= 0 || D <= 0) return 0;
  if (M > 65535 || B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = static_cast<int64_t>(kAccThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((D + per_block - 1) / per_block),
                  static_cast<unsigned>(M));
  if (dtype == 0) {
    scale_accumulate_kernel<float><<<grid, kAccThreads, 0, stream>>>(
        static_cast<const float*>(x), sq, out, static_cast<int>(B), D, clip, denom);
  } else if (dtype == 1) {
    scale_accumulate_kernel<__nv_bfloat16><<<grid, kAccThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), sq, out, static_cast<int>(B), D, clip,
        denom);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
