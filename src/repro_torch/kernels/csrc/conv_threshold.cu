// Fused direct conv + multi-threshold stage for Hopper: NHWC int32 codes,
// a K x K conv as an implicit GEMM into an int32 accumulator, then the
// per-channel threshold count. No patch matrix is materialised.
//
//   acc[n, oh, ow, f] = sum_{kh, kw, c} x[n, oh*s + kh, ow*s + kw, c]
//                                       * w[(kh*K + kw)*C + c, f]
//   out[n, oh, ow, f] = #{ t : acc[n, oh, ow, f] >= thr[f, t] }
//
// Replaces the Pallas kernel repro.kernels.conv_threshold.conv_threshold
// (body _conv_thr_kernel, wrapper repro.kernels.ops.conv_threshold).
//
// Bound on the H100: the paper's convs read at most a few hundred KB per
// sample and do some MMAC per sample, so at a 1024-sample batch a stage is
// bound by bytes (its int32 codes in and out) at tens of microseconds.
// This kernel runs 5-30x that, bound by the SM's instruction issue: each
// block stages its banks, band and weights, and each output takes
// ceil(log2(S + 1)) dependent probes of the search (PERF.md).
//
// Design: an implicit GEMM on the int8 tensor cores. A block of 8 warps
// covers one sample, block_h output rows (the tuned parameter; by default
// about 8192 / (k-steps) pixels, ops.py's conv_block_rows) and BN output
// channels (8, 16, 32 or 64: the least at or above F, 64 above it):
// M = its output pixels, N = its channels, K = kernel * kernel * Cp in the
// (kh, kw, c) order of w2d. Where block_h covers a whole image of fewer
// pixels than that, it covers G consecutive samples (at most 8; the host
// picks G), so that its staged weights and banks serve G images. It stages
//   - the banks of its channels step-major, checked for order on the way
//     in (threshold_epilogue.cuh);
//   - its padded input band, band_rows(block_h) whole padded rows of each
//     of its samples, one byte per code (the block's code-range vote picks
//     the mma flavour), each pixel's channels zero-padded to Cp = ceil(C /
//     4) * 4 and to a stride `ps` the host picks so that fragment loads of
//     neighbouring pixels avoid bank conflicts;
//   - the weights of its channels transposed to (BN, k), all of K when
//     they fit (the host's chunk `kc`), else kc at a time;
//   - a table of each word of 4 k's band offset, k -> (tap, c) ->
//     (kh * WP + kw) * ps + c, and per pass each pixel's band offset and
//     output row.
// Warps take 32-pixel x 8-to-32-channel tiles of mma.sync.m16n8k32, 128
// pixels a pass (256 when BN is 8 or 16: all 8 warps along the pixels). A
// fragment word is one load at the pixel's offset plus the k word's. Every
// word of 4 k is 4 channels of one tap: a thin first layer (C = 3) runs as
// C = 4, its weights for the fourth channel 0; depths below 32 (IC's
// 1x1x4, CNV's 3x3x4) are zero-padded to 32-deep steps, words past the
// depth 0 without a load. Each pass's accumulators go to a shared-memory
// tile and count by the search (or linearly), one channel per lane, and
// are stored.
//
// The host has zero-padded the input with the SAME split, so every tap of
// an output row below out_h is in bounds. The last row block masks its rows
// at or past out_h, so the host adds no bottom rows for the row-block grid
// (the Pallas wrapper does, because its grid has no mask).
//
// Banks too large for shared memory (flags & FLAG_SEARCH clear) stream
// through it in chunks of 64 steps with the linear count; flags &
// FLAG_CORES selects dp4a products on the CUDA cores instead of mma.sync,
// for timing the two apart.

#include <cstdint>
#include <cuda_runtime.h>

#include "threshold_epilogue.cuh"

namespace {

using namespace thr_epi;

constexpr int NT = 256;           // 8 warps

// the warp layout of a block of BN channels: 2 warps along the channels
// from 32 channels, else 1; the rest along the pixels, 32 each
template <int BN>
struct Cfg {
  static constexpr int WARPS_N = BN >= 32 ? 2 : 1;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WTN = BN / WARPS_N;      // channels per warp
  static constexpr int NI = WTN / 8;
  static constexpr int MI = 2;                  // 32 pixels per warp
  static constexpr int PASS = WARPS_M * 32;     // output pixels per pass
  static constexpr int BC = BN >= 32 ? BN : 32; // bank slots (epilogue)
};

// the padded depth: K * K * Cp, Cp = C rounded up to 4
__host__ __device__ inline int padded_depth(int K, int C) {
  return K * K * ((C + 3) / 4 * 4);
}

// the k-offset table's words: one per word of 4 k over the padded depth
// rounded up to whole 32-deep steps
__host__ __device__ inline int koff_words(int ktot) {
  return (ktot + 31) / 32 * 8;
}

// byte offset in the band, beside a pixel's base, of padded k's tap and
// channel: k -> (tap, c) -> (kh * WP + kw) * ps + c
__device__ __forceinline__ int k_offset(int k, int Cp, int K, int WP,
                                        int ps) {
  const int tap = k / Cp, c = k - tap * Cp;
  const int kh = tap / K, kw = tap - kh * K;
  return (kh * WP + kw) * ps + c;
}

// a pass's output rows and band offsets, the banks, the weights, the
// accumulator tile of a pass, the k-offset table and the band
template <int BN>
size_t smem_bytes(int bank_steps, int kc, int band_rows, int WP, int ps,
                  int G, int ktot) {
  using L = Cfg<BN>;
  const size_t band = ((size_t)G * band_rows * WP * ps + 15) / 16 * 16;
  const size_t koff = ((size_t)koff_words(ktot) * 4 + 15) / 16 * 16;
  return (size_t)L::PASS * 12 + (size_t)bank_steps * L::BC * 4
         + (size_t)BN * (kc / 4 + 4) * 4 + (size_t)L::PASS * (BN + 1) * 4
         + koff + band;
}

// two blocks an SM (at most 128 registers a thread) for the mma kernels,
// whose blocks are chains of latencies that other blocks hide
template <int BN, bool CORES>
__global__ void __launch_bounds__(NT, CORES ? 1 : 2)
conv_threshold_kernel(const int32_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const int32_t* __restrict__ thr,
                      int32_t* __restrict__ out,
                      int N, int HP, int WP, int C, int F, int K, int stride,
                      int out_h, int out_w, int block_h, int S, int ps,
                      int kc, int G, int flags) {
  using L = Cfg<BN>;
  constexpr int MI = L::MI, NI = L::NI, WTN = L::WTN, PASS = L::PASS;
  constexpr int BC = L::BC;
  extern __shared__ __align__(16) uint32_t smem[];
  const bool search = flags & FLAG_SEARCH;
  const int bank_steps = search ? search_steps(S) : LINEAR_CHUNK;
  const int Cp = (C + 3) / 4 * 4;
  const int ktot = padded_depth(K, C);
  const int ldw = kc / 4 + 4;                   // weight row stride, words
  long long* orows = (long long*)smem;          // [PASS] output rows
  int* pbases = (int*)(orows + PASS);           // [PASS] band offsets
  int32_t* ts = pbases + PASS;                  // [steps][BC] banks
  uint32_t* Ws = (uint32_t*)(ts + bank_steps * BC);  // [BN][ldw] weights
  int32_t* at = (int32_t*)(Ws + BN * ldw);      // [PASS][BN + 1] accumulators
  int* koff = at + PASS * (BN + 1);             // word of k -> band offset
  const int n_koff = koff_words(ktot);
  uint8_t* band = (uint8_t*)(koff + (n_koff + 3) / 4 * 4);  // [G][rows][WP][ps]
  __shared__ unsigned falls[(BC + 31) / 32];
  __shared__ unsigned vote;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
  const long long n0 = (long long)blockIdx.x * G;
  const int ng = (int)min((long long)G, N - n0);   // samples of the block
  const int oh0 = blockIdx.y * block_h;
  const int rows = min(block_h, out_h - oh0);
  const int f0 = blockIdx.z * BN;
  const int nf = min(BN, F - f0);
  const int npix1 = rows * out_w;                   // pixels per sample
  const int npix = ng * npix1;
  const int brows = (rows - 1) * stride + K;
  // sample gi's band starts at xb + gi * xs in x
  const int32_t* xb = x + (n0 * HP + (long long)oh0 * stride) * WP * C;
  const long long xs = (long long)HP * WP * C;

  if (tid < (BC + 31) / 32) falls[tid] = 0;
  if (tid == 0) vote = 0;
  for (int e = tid; e < n_koff; e += NT)
    koff[e] = 4 * e < ktot ? k_offset(4 * e, Cp, K, WP, ps) : 0;
  __syncthreads();
  // its channels' banks, step-major, checked for order on the way in
  if (search) {
    stage_banks<NT, BC>(thr, S, f0, nf, 0, S, ts, falls);
    pad_banks<NT, BC>(S, ts);
  }

  // one byte plane of the band's codes, Cp channels a pixel (codes past C
  // are 0); on the first staging the block's code-range vote too
  auto stage_band = [&](int plane, bool do_vote) {
    constexpr int UB = 4;                       // words in flight
    unsigned bits = 0;
    const int c4 = Cp / 4;
    const int per = brows * WP * c4;            // words per sample
    const int words = ng * per;
    const bool vec = C % 4 == 0 && ((uintptr_t)x & 15) == 0;
    for (int e0 = tid; e0 < words; e0 += NT * UB) {
      int32_t v[UB][4];
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int e = e0 + u * NT;
        const int gi = e / per, r = e - gi * per;
        const int pix = r / c4, cw = r - pix * c4;
        const int32_t* src = xb + gi * xs + (long long)pix * C + 4 * cw;
        if (e < words && vec) {
          const int4 q = __ldg(reinterpret_cast<const int4*>(src));
          v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[u][j] = (e < words && 4 * cw + j < C) ? __ldg(src + j) : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int e = e0 + u * NT;
        if (e >= words) continue;
        const int pix = e / c4, cw = e - pix * c4;   // over all samples
#pragma unroll
        for (int j = 0; j < 4; ++j) bits |= code_bits(v[u][j]);
        reinterpret_cast<uint32_t*>(band)[pix * (ps / 4) + cw] =
            pack_plane(v[u][0], v[u][1], v[u][2], v[u][3], plane);
      }
    }
    if (do_vote) {
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane == 0 && bits) atomicOr(&vote, bits);
    }
  };
  // weights of padded k in [kci * kc, + kc) of the block's channels,
  // transposed (k of a padding channel: 0); UW words in flight per thread
  auto stage_weights = [&](int kci) {
    constexpr int UW = 4;
    const int k0 = kci * kc;
    const int words = BN * (kc / 4);
    for (int e0 = tid; e0 < words; e0 += NT * UW) {
      int8_t v[UW][4];
#pragma unroll
      for (int u = 0; u < UW; ++u) {
        const int e = e0 + u * NT;
        const int f = f0 + e % BN;
        const int k = k0 + 4 * (e / BN);        // a word: one tap
        const int tap = k / Cp, c = k - tap * Cp;
        const int8_t* src = w + ((long long)tap * C + c) * F + f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[u][j] = (e < words && f < F && k < ktot && c + j < C)
                        ? __ldg(src + (long long)j * F) : (int8_t)0;
      }
#pragma unroll
      for (int u = 0; u < UW; ++u) {
        const int e = e0 + u * NT;
        if (e < words)
          Ws[(e % BN) * ldw + e / BN] =
              pack_s8(v[u][0], v[u][1], v[u][2], v[u][3]);
      }
    }
  };

  const int n_chunks = (ktot + kc - 1) / kc;
  stage_band(0, true);
  int band_plane = 0, w_chunk = -1;
  if (n_chunks == 1) {
    stage_weights(0);
    w_chunk = 0;
  }
  __syncthreads();
  const int fl = flavour_of(vote);
  const int planes = fl == WIDE ? 4 : 1;

  for (int p0 = 0; p0 < npix; p0 += PASS) {
    // the pass's pixels: band offset and output row, once per pixel (the
    // last pass's barrier ends its reads)
    for (int r = tid; r < PASS; r += NT) {
      const int p = p0 + r;
      const int gi = p / npix1, pl = p - gi * npix1;
      const int rr = pl / out_w, col = pl - rr * out_w;
      const bool in = p < npix;
      pbases[r] = in ? ((gi * brows + rr * stride) * WP + col * stride) * ps
                     : 0;
      orows[r] = in ? ((n0 + gi) * out_h + oh0) * out_w + pl : -1;
    }
    __syncthreads();
    int pbase[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pbase[mi][h] = pbases[wm * 32 + mi * 16 + g + 8 * h];
    int32_t acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

    for (int plane = 0; plane < planes; ++plane) {
      // byte split: bytes 0-2 as u8, byte 3 as s8, each shifted
      const bool sgn = fl == S8 || plane == 3;
      const int shift = 8 * plane;
      for (int kci = 0; kci < n_chunks; ++kci) {
        const bool need_band = band_plane != plane;
        const bool need_w = w_chunk != kci;
        if (need_band || need_w) {
          __syncthreads();                     // the old contents are used
          if (need_band) stage_band(plane, false);
          if (need_w) stage_weights(kci);
          band_plane = plane;
          w_chunk = kci;
          __syncthreads();
        }
        const int k_steps = (min(kc, ktot - kci * kc) + 31) / 32;
        for (int ks = 0; ks < k_steps; ++ks) {
          const int kg = kci * kc + ks * 32;     // words kg / 4 ..
          if constexpr (!CORES) {
            // words past the depth (a thin layer's padding) are 0 without
            // a load
            const int w0 = kg / 4 + t, w1 = kg / 4 + 4 + t;
            const bool live0 = 4 * w0 < ktot, live1 = 4 * w1 < ktot;
            const int o0 = koff[w0], o1 = koff[w1];
            uint32_t a[MI][4], b[NI][2];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint8_t* pb = band + pbase[mi][h];
                a[mi][h] = live0 ? *reinterpret_cast<const uint32_t*>(pb + o0)
                                 : 0u;
                a[mi][2 + h] =
                    live1 ? *reinterpret_cast<const uint32_t*>(pb + o1) : 0u;
              }
            }
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              const uint32_t* br =
                  Ws + (wn * WTN + ni * 8 + g) * ldw + ks * 8 + t;
              b[ni][0] = br[0];
              b[ni][1] = br[4];
            }
            if (sgn) mma_tiles<MI, NI, true>(acc, a, b, shift);
            else mma_tiles<MI, NI, false>(acc, a, b, shift);
          } else {
            // each lane forms its own outputs (pixels g, g + 8; channels
            // 2t, 2t + 1 of each tile) from the eight words of the step
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
              for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const uint8_t* pb = band + pbase[mi][i >> 1];
                  const uint32_t* br = Ws + (wn * WTN + ni * 8 + 2 * t
                                             + (i & 1)) * ldw + ks * 8;
                  int32_t d = 0;
#pragma unroll
                  for (int q = 0; q < 8; ++q) {
                    const int wq = kg / 4 + q;
                    const uint32_t av =
                        4 * wq < ktot
                            ? *reinterpret_cast<const uint32_t*>(pb + koff[wq])
                            : 0u;
                    d = sgn ? dp4<true>(av, br[q], d)
                            : dp4<false>(av, br[q], d);
                  }
                  acc[mi][ni][i] = add_shifted(acc[mi][ni][i], d, shift);
                }
          }
        }
      }
    }
    fragments_to_tile<BN + 1, MI, NI>(acc, at, wm * 32, wn * WTN);
    __syncthreads();
    count_tile<NT, BC, BN + 1, PASS>(at, min(PASS, npix - p0), search, thr,
                                     S, f0, nf, ts, falls, out, F,
                                     [&](int r) { return orows[r]; });
    __syncthreads();                           // the tile is counted
  }
}

template <int BN, bool CORES>
int launch(const void* x, const void* w, const void* thr, void* out, int N,
           int HP, int WP, int C, int F, int K, int stride, int out_h,
           int out_w, int block_h, int S, int ps, int kc, int G, int flags,
           cudaStream_t stream) {
  static bool configured = false;
  auto kernel = conv_threshold_kernel<BN, CORES>;
  const int bank_steps =
      (flags & FLAG_SEARCH) ? search_steps(S) : LINEAR_CHUNK;
  const size_t bytes = smem_bytes<BN>(bank_steps, kc,
                                      (block_h - 1) * stride + K, WP, ps, G,
                                      padded_depth(K, C));
  if (bytes > (size_t)SMEM_DYN) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kernel, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + G - 1) / G, (out_h + block_h - 1) / block_h,
                  (F + BN - 1) / BN);
  kernel<<<grid, NT, bytes, stream>>>(
      (const int32_t*)x, (const int8_t*)w, (const int32_t*)thr,
      (int32_t*)out, N, HP, WP, C, F, K, stride, out_h, out_w, block_h, S,
      ps, kc, G, flags);
  return (int)cudaGetLastError();
}

template <bool CORES>
int launch_bn(int block_n, const void* x, const void* w, const void* thr,
              void* out, int N, int HP, int WP, int C, int F, int K,
              int stride, int out_h, int out_w, int block_h, int S, int ps,
              int kc, int G, int flags, cudaStream_t st) {
#define BN_CASE(bn)                                                        \
  if (block_n == bn)                                                       \
    return launch<bn, CORES>(x, w, thr, out, N, HP, WP, C, F, K, stride,   \
                             out_h, out_w, block_h, S, ps, kc, G, flags, st);
  BN_CASE(8) BN_CASE(16) BN_CASE(32) BN_CASE(64)
#undef BN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (N, HP, WP, C) int32 already
// padded, w (K*K*C, F) int8, thr (F, S) int32, out (N, out_h, out_w, F)
// int32, all contiguous on the device. Grid: (ceil(N / G),
// ceil(out_h / block_h), ceil(F / block_n)). The host's plan (kernels/ops.py,
// conv_threshold_plan) gives block_n (8, 16, 32 or 64), the band's pixel
// stride ps in bytes (a multiple of 4, at least C rounded up to 4), the
// weight chunk kc (a multiple of 32, over the padded depth), the samples
// per block G (above 1 only when block_h covers out_h) and flags
// (FLAG_SEARCH, FLAG_CORES). The launch goes on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take or a block that does not fit shared memory.
extern "C" int conv_threshold_launch(const void* x, const void* w,
                                     const void* thr, void* out, int N,
                                     int HP, int WP, int C, int F, int K,
                                     int stride, int out_h, int out_w,
                                     int block_h, int S, int block_n, int ps,
                                     int kc, int G, int flags, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (kc <= 0 || kc % 32 || ps % 4 || ps < (C + 3) / 4 * 4 || block_h < 1
      || G < 1 || (G > 1 && block_h < out_h))
    return (int)cudaErrorInvalidValue;
#define ARGS block_n, x, w, thr, out, N, HP, WP, C, F, K, stride, out_h, \
             out_w, block_h, S, ps, kc, G, flags, st
  return (flags & FLAG_CORES) ? launch_bn<true>(ARGS) : launch_bn<false>(ARGS);
#undef ARGS
}
