// The deployed models' float head: integer codes times a float32 weight
// matrix, rescaled and shifted.
//
//   y[m, n] = (sum_k float(x[m, k]) * w[k, n]) * in_scale + b[n]
//
// A repair, not a port of a TPU kernel: the head is the reference's plain
// ``x_int.astype(float32) @ w * in_scale + b`` (FloatHeadStage.apply_ref,
// src/repro/deploy/lower.py:441), which the port first left to cuBLAS.
// cuBLAS picks its reduction by shape, so a row's logits depended on how
// many rows came with it: a 64-row serving wave differed from one call on
// all the served rows by up to 0.0029 of 13,135 on AD. Here every output
// sums its K products one after the other, k = 0 .. K-1, with a fused
// multiply-add per step, so y[m, n] depends on row m alone and on K, never
// on M. The rescale and the bias follow in the reference's order, each
// rounded on its own (__fmul_rn, __fadd_rn: no contraction into an FMA).
//
// Bound on the H100: the heads are small (K <= 512, N <= 128, up to a few
// thousand rows), so reading the codes and writing the logits bound it;
// at AD's head (1024 x 72 codes, 72 x 128 weights) that is under 1 us at
// 3.35 TB/s, below a launch. Design: a block of 32 x 8 threads covers 32
// outputs of 8 rows; a warp reads one code of its row (one address for
// all lanes) and 32 adjacent weights per step, so every load is coalesced
// and nothing is staged in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;  // outputs per block (one warp wide)
constexpr int BM = 8;   // rows per block (one warp each)

__global__ void __launch_bounds__(BN * BM)
float_head_kernel(const int32_t* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y,
                  int M, int N, int K, float in_scale) {
  const int n = blockIdx.x * BN + threadIdx.x;
  const int m = blockIdx.y * BM + threadIdx.y;
  if (m >= M || n >= N) return;
  const int32_t* xr = x + (size_t)m * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k)
    acc = __fmaf_rn(__int2float_rn(xr[k]), w[(size_t)k * N + n], acc);
  y[(size_t)m * N + n] = __fadd_rn(__fmul_rn(acc, in_scale), b[n]);
}

}  // namespace

extern "C" int float_head_launch(const void* x, const void* w, const void* b,
                                 void* y, int M, int N, int K, float in_scale,
                                 void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  float_head_kernel<<<grid, dim3(BN, BM), 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const float*)w, (const float*)b, (float*)y, M, N, K,
      in_scale);
  return (int)cudaGetLastError();
}
