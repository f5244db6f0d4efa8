// Fused direct conv + multi-threshold stage for Hopper: NHWC int32 codes,
// a K x K tap loop over shifted input windows into an int32 accumulator,
// then the per-channel threshold count. No patch matrix is materialised.
//
//   acc[n, oh, ow, f] = sum_{kh, kw, c} x[n, oh*s + kh, ow*s + kw, c]
//                                       * w[(kh*K + kw)*C + c, f]
//   out[n, oh, ow, f] = #{ t : acc[n, oh, ow, f] >= thr[f, t] }
//
// Replaces the Pallas kernel repro.kernels.conv_threshold.conv_threshold
// (body _conv_thr_kernel, wrapper repro.kernels.ops.conv_threshold).
//
// Bound on the H100: the goldens' convs read at most a few hundred KB per
// sample and do a few MMAC per sample, so at a 1024-sample batch a stage
// is bound by bytes at some microseconds; the launch and the CUDA-core
// integer MACs dominate this version. This is the simple, correct first
// version: one thread block per (sample, output-row block), threads striding
// over the block's (row, ow, f) outputs with f fastest, so neighbouring
// threads read neighbouring weight columns and the same input pixel. Each
// thread accumulates its K*K*C taps in int32 from global memory through the
// read-only cache and then counts its channel's bank linearly (exact for
// unsorted banks too). Thin inputs (C = 1 or 3, the IC input) are plain
// CUDA-core work: no MMA K-step applies. Shared-memory line buffers, MMA and
// TMA are later work.
//
// The host has zero-padded the input with the SAME split, so every tap of
// an output row below out_h is in bounds. The last row block masks its rows
// at or past out_h, so the host adds no bottom rows for the row-block grid
// (the Pallas wrapper does, because its grid has no mask).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
conv_threshold_kernel(const int32_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const int32_t* __restrict__ thr,
                      int32_t* __restrict__ out,
                      int HP, int WP, int C, int F, int K, int stride,
                      int out_h, int out_w, int block_h, int S) {
  const long long n = blockIdx.x;
  const int oh0 = blockIdx.y * block_h;
  const int rows = min(block_h, out_h - oh0);
  const int per_block = rows * out_w * F;
  const int32_t* xn = x + n * HP * WP * C;
  for (int e = threadIdx.x; e < per_block; e += THREADS) {
    const int f = e % F;
    const int p = e / F;
    const int ow = p % out_w;
    const int oh = oh0 + p / out_w;
    const int32_t* xo = xn + ((long long)oh * stride * WP + ow * stride) * C;
    const int8_t* wf = w + f;
    int32_t acc = 0;
    for (int kh = 0; kh < K; ++kh) {
      for (int kw = 0; kw < K; ++kw) {
        const int32_t* xp = xo + ((long long)kh * WP + kw) * C;
        const int8_t* wp = wf + (long long)(kh * K + kw) * C * F;
        for (int c = 0; c < C; ++c)
          acc += __ldg(xp + c) * (int32_t)__ldg(wp + (long long)c * F);
      }
    }
    const int32_t* t = thr + (long long)f * S;
    int32_t cnt = 0;
    for (int s = 0; s < S; ++s) cnt += acc >= __ldg(t + s);
    out[((n * out_h + oh) * out_w + ow) * F + f] = cnt;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (N, HP, WP, C) int32 already
// padded, w (K*K*C, F) int8, thr (F, S) int32, out (N, out_h, out_w, F)
// int32, all contiguous on the device. Grid: (N, ceil(out_h / block_h)).
// The launch goes on `stream`; returns cudaGetLastError().
extern "C" int conv_threshold_launch(const void* x, const void* w,
                                     const void* thr, void* out, int N,
                                     int HP, int WP, int C, int F, int K,
                                     int stride, int out_h, int out_w,
                                     int block_h, int S, void* stream) {
  const dim3 grid(N, (out_h + block_h - 1) / block_h);
  conv_threshold_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int8_t*)w, (const int32_t*)thr,
      (int32_t*)out, HP, WP, C, F, K, stride, out_h, out_w, block_h, S);
  return (int)cudaGetLastError();
}
