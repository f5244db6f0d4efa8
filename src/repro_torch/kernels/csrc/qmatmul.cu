// Fused int8 dataflow stage for Hopper: int8 x int8 into an int32
// accumulator, then the per-channel epilogue, in one pass.
//
//   y[m, n] = (float)(sum_k x[m, k] * w[k, n]) * scale[n] + bias[n]
//   y       = max(y, 0)                                  (relu)
//   out     = y (f32), or clip(rint(y * inv_out_scale), -128, 127) (int8)
//
// Replaces the Pallas kernel repro.kernels.qmatmul.qmatmul (body
// _qmatmul_kernel, wrapper repro.kernels.ops.qmatmul).
//
// Bound on the H100: at the bench's 512^3 the call reads 0.5 MB of codes
// and writes 0.25 MB (int8) or 1 MB (f32): 0.24 or 0.47 us at 3.35 TB/s,
// above the 0.14 us its 2.7e8 operations take at the int8 tensor-core
// rate, so bytes bound it. This is the simple, correct first version on the CUDA cores: a
// 64 x 64 output tile per block of 256 threads, each thread 4 x 4 outputs;
// per depth-32 step the x and w tiles are staged in shared memory packed
// four k-values to a 32-bit word, and each thread issues __dp4a (four
// int8 products and the sum in one instruction) on them. Ragged M, N and K
// are masked in the kernel (out-of-range loads pack 0, out-of-range outputs
// are not written): the host pads nothing. No MMA, TMA or cp.async yet.
//
// Exactness: the epilogue keeps the Pallas kernel's order and roundings,
// so the result equals the plain PyTorch version bit for bit: the int32
// accumulator rounds once to float (__int2float_rn), the scale product and
// the bias sum round separately (__fmul_rn, __fadd_rn: nvcc would contract
// a*b+c into one FMA), bias 0 when absent, as the Pallas wrapper pads it;
// the requant multiplies by the float32 reciprocal the host passes (the
// Pallas kernel's y * (1 / out_scale), not y / out_scale), rounds half to
// even (rintf, as jnp.round and torch.round) and clips before the cast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;            // k per shared-memory step
constexpr int BKQ = BK / 4;       // packed words per row per step
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
         ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24);
}

__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ bias, void* __restrict__ out,
               int M, int N, int K, int relu, int requant, float inv_scale) {
  // xs[q][r]: k = 4q..4q+3 of tile row r; ws[q][c]: the same k of column c
  __shared__ int32_t xs[BKQ][BM + 1];
  __shared__ int32_t ws[BKQ][BN];

  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM rows x BKQ words; neighbouring threads, neighbouring words
    for (int e = tid; e < BM * BKQ; e += THREADS) {
      const int r = e / BKQ, q = e % BKQ;
      const long long gm = m0 + r;
      int8_t v[4] = {0, 0, 0, 0};
      if (gm < M) {
        const int8_t* xr = x + gm * K;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int gk = k0 + 4 * q + b;
          if (gk < K) v[b] = __ldg(xr + gk);
        }
      }
      xs[q][r] = (int32_t)pack4(v[0], v[1], v[2], v[3]);
    }
    // w tile: BKQ words x BN columns; neighbouring threads, neighbouring n
    for (int e = tid; e < BKQ * BN; e += THREADS) {
      const int q = e / BN, c = e % BN;
      const int gn = n0 + c;
      int8_t v[4] = {0, 0, 0, 0};
      if (gn < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int gk = k0 + 4 * q + b;
          if (gk < K) v[b] = __ldg(w + (long long)gk * N + gn);
        }
      }
      ws[q][c] = (int32_t)pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < BKQ; ++q) {
      int32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[q][tm * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[q][tn * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tn * TN + j;
    if (gn >= N) continue;
    const float s = __ldg(scale + gn);
    const float bn = bias != nullptr ? __ldg(bias + gn) : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long gm = m0 + tm * TM + i;
      if (gm >= M) continue;
      float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), s), bn);
      if (relu) y = fmaxf(y, 0.0f);
      if (requant) {
        float q = rintf(__fmul_rn(y, inv_scale));
        q = fminf(fmaxf(q, -128.0f), 127.0f);
        ((int8_t*)out)[gm * N + gn] = (int8_t)q;
      } else {
        ((float*)out)[gm * N + gn] = y;
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (M, K) int8, w (K, N) int8,
// scale (N,) float32, bias (N,) float32 or null, out (M, N) float32, or
// int8 when requant is set; all contiguous on the device. inv_scale is the
// float32 reciprocal of out_scale. The launch goes on `stream`; returns
// cudaGetLastError().
extern "C" int qmatmul_launch(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int M, int N,
                              int K, int relu, int requant, float inv_scale,
                              void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  qmatmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)scale,
      (const float*)bias, out, M, N, K, relu, requant, inv_scale);
  return (int)cudaGetLastError();
}
