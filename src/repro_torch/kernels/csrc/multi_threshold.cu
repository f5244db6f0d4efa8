// Standalone FINN multi-threshold activation for Hopper: an int32
// accumulator against a per-channel bank gives the count of reached steps.
//
//   out[m, c] = #{ s : acc[m, c] >= thr[c, s] }      in [0, S]
//
// Replaces the Pallas kernel repro.kernels.multi_threshold.multi_threshold
// (bodies _mt_kernel for banks of S < 256 steps, _mt_slab_kernel for deeper
// banks streamed in 64-step slabs padded with INT32_MAX; wrapper
// repro.kernels.ops.multi_threshold). One kernel covers both: every bank
// goes through shared memory in chunks of SB steps, and the last chunk
// counts only the steps that exist, so no padding is needed.
//
// Bound on the H100: at AD's bank (1024 rows x 72 channels, S = 255) the
// call reads 0.37 MB and writes 0.29 MB, 0.2 us at 3.35 TB/s, and its
// 1.9e7 compares take 1.1 us at the CUDA cores' int32 rate (64 lanes per
// SM, 132 SMs, 1.98 GHz), so the compares bound it; a launch costs about
// as much. This is the simple, correct first version: a block of 32 x 8
// threads covers 32 channels (one per lane) and 32 rows (4 per thread),
// the accumulators in registers. The bank chunk is read coalesced along
// the steps of each channel and written transposed, step-major (SB, 32),
// into shared memory (one padding word per row keeps both the writes and
// the reads free of bank conflicts), so at each step a warp's 32 channels
// read 32 adjacent words. K1 read its banks channel-major from global
// memory (thr[f*S + s], a warp's channels S*4 bytes apart), which PERF.md
// names as K1's slow count; this kernel does not.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BC = 32;            // channels per block (one per lane)
constexpr int TY = 8;             // warps per block
constexpr int RPT = 4;            // rows per thread
constexpr int BR = TY * RPT;      // rows per block
constexpr int SB = 64;            // bank steps per shared-memory chunk

__global__ void __launch_bounds__(BC * TY)
multi_threshold_kernel(const int32_t* __restrict__ acc,
                       const int32_t* __restrict__ thr,
                       int32_t* __restrict__ out, int M, int C, int S) {
  __shared__ int32_t ts[SB][BC + 1];

  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * BC + lane;
  const int c0 = blockIdx.y * BC;
  const int c = c0 + lane;
  const long long m0 = (long long)blockIdx.x * BR;

  int32_t a[RPT], cnt[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long m = m0 + ty + i * TY;
    a[i] = (m < M && c < C) ? __ldg(acc + m * C + c) : 0;
    cnt[i] = 0;
  }

  for (int s0 = 0; s0 < S; s0 += SB) {
    const int steps = min(SB, S - s0);
    // chunk (BC channels x steps): neighbouring threads read neighbouring
    // steps of one channel, and write them step-major
    for (int e = tid; e < BC * SB; e += BC * TY) {
      const int cc = e / SB, ss = e % SB;
      if (ss < steps && c0 + cc < C)
        ts[ss][cc] = __ldg(thr + (long long)(c0 + cc) * S + s0 + ss);
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const int32_t t = ts[s][lane];
#pragma unroll
      for (int i = 0; i < RPT; ++i) cnt[i] += a[i] >= t;
    }
    __syncthreads();
  }

  if (c >= C) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long m = m0 + ty + i * TY;
    if (m < M) out[m * C + c] = cnt[i];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). acc (M, C) int32, thr (C, S)
// int32, out (M, C) int32, all contiguous on the device. Grid:
// (ceil(M / 32), ceil(C / 32)). The launch goes on `stream`; returns
// cudaGetLastError().
extern "C" int multi_threshold_launch(const void* acc, const void* thr,
                                      void* out, int M, int C, int S,
                                      void* stream) {
  const dim3 grid((M + BR - 1) / BR, (C + BC - 1) / BC);
  const dim3 block(BC, TY);
  multi_threshold_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)acc, (const int32_t*)thr, (int32_t*)out, M, C, S);
  return (int)cudaGetLastError();
}
