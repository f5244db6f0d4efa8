// Fused integer dense stage for Hopper: int32 codes x int8 weights into an
// int32 accumulator, then the per-channel multi-threshold count.
//
//   out[m, n] = #{ s : sum_k x[m, k] * w[k, n] >= thr[n, s] }
//
// Replaces the Pallas kernel repro.kernels.multi_threshold.threshold_matmul
// (body _tmm_kernel, wrapper repro.kernels.ops.threshold_matmul).
//
// Bound on the H100: at the tiny models' shapes (K <= 490, N <= 256,
// M = 1024 rows) every call moves a few MB at most and does well under a
// GFLOP, so the card's bound is some microseconds and a launch costs more.
// This is the simple, correct first version: a BM x BN output tile per
// block of BM * BN / 16 threads, each thread 4 x 4 outputs; x and w tiles
// of depth 32 staged in shared memory as int32 (at most 33 KB at 128 x
// 128); exact int32 multiply-accumulate on the CUDA cores. Ragged M/N/K
// edges are masked in the kernel (out-of-range loads read 0, out-of-range
// outputs are not written), so the host pads nothing and needs no
// INT32_MAX channel padding. No wgmma, TMA or
// cp.async yet: those are later work.
//
// The tile is a template parameter, instantiated for BM and BN in
// {32, 64, 128} (kernels/ops.py's TMM_TILE_SIZES, which must match); the
// launch picks one at run time. 64 x 64 is the default. Every tile
// computes the same integers: only the grid and the block change.
//
// Why x is int32: the first layer's codes are signed (-127..127) and later
// codes are unsigned up to 255 (8-bit activations), so neither s8 nor u8
// holds both. An MMA redesign has to take u8 x s8 for the inner stages and
// s8 x s8 for the first, or shift codes by -128 and add 128 * colsum(w).
//
// The epilogue counts the bank linearly over all S steps, as the TPU kernel
// does, which is exact for unsorted banks too (a binary search would need
// sorted banks). The bank row of a channel is read from global memory
// through the read-only cache: at S = 255 a 64-channel slice is 64 KB, too
// big for static shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;

template <int BM, int BN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
threshold_matmul_kernel(const int32_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const int32_t* __restrict__ thr,
                        int32_t* __restrict__ out,
                        int M, int N, int K, int S) {
  // xs is stored k-major so a thread's TM rows sit side by side
  __shared__ int32_t xs[BK][BM + 1];
  __shared__ int32_t ws[BK][BN];
  constexpr int THREADS = (BM / TM) * (BN / TN);

  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN);   // column group: outputs tn*TN .. +TN
  const int tm = tid / (BN / TN);   // row group:    outputs tm*TM .. +TM
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile (BM x BK): neighbouring threads read neighbouring k
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? __ldg(x + gm * K + gk) : 0;
    }
    // w tile (BK x BN): neighbouring threads read neighbouring n
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N)
                     ? (int32_t)__ldg(w + (long long)gk * N + gn) : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      int32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tm * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tn * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tn * TN + j;
    if (gn >= N) continue;
    const int32_t* t = thr + (long long)gn * S;
    int32_t cnt[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) cnt[i] = 0;
    for (int s = 0; s < S; ++s) {
      const int32_t ts = __ldg(t + s);
#pragma unroll
      for (int i = 0; i < TM; ++i) cnt[i] += acc[i][j] >= ts;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long gm = m0 + tm * TM + i;
      if (gm < M) out[gm * N + gn] = cnt[i];
    }
  }
}

template <int BM, int BN>
int launch(const void* x, const void* w, const void* thr, void* out, int M,
           int N, int K, int S, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  threshold_matmul_kernel<BM, BN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          (const int32_t*)x, (const int8_t*)w, (const int32_t*)thr,
          (int32_t*)out, M, N, K, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (M, K) int32, w (K, N) int8,
// thr (N, S) int32, out (M, N) int32, all contiguous on the device; the
// output tile is block_m x block_n, each in {32, 64, 128}. The launch goes
// on `stream` and the function returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile that is not instantiated.
extern "C" int threshold_matmul_launch(const void* x, const void* w,
                                       const void* thr, void* out, int M,
                                       int N, int K, int S, int block_m,
                                       int block_n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define TILE(bm, bn)                                        \
  if (block_m == bm && block_n == bn)                       \
    return launch<bm, bn>(x, w, thr, out, M, N, K, S, st);
  TILE(32, 32) TILE(32, 64) TILE(32, 128)
  TILE(64, 32) TILE(64, 64) TILE(64, 128)
  TILE(128, 32) TILE(128, 64) TILE(128, 128)
#undef TILE
  return (int)cudaErrorInvalidValue;
}
