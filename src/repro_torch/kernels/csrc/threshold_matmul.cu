// Fused integer dense stage for Hopper: int32 codes x int8 weights into an
// int32 accumulator, then the per-channel multi-threshold count.
//
//   out[m, n] = #{ s : sum_k x[m, k] * w[k, n] >= thr[n, s] }
//
// Replaces the Pallas kernel repro.kernels.multi_threshold.threshold_matmul
// (body _tmm_kernel, wrapper repro.kernels.ops.threshold_matmul).
//
// Bound on the H100: at the tiny models' shapes (K <= 490, N <= 512, M =
// 1024 rows) a call moves a few MB at most and does well under a GOP, so
// bytes bound it at some microseconds. This kernel runs 10-80x that,
// bound by latency: each block stages its channels' banks and walks K one
// global round trip per 64-deep tile (PERF.md).
//
// Design. A block of 4-16 warps computes a BM x BN output tile (BM, BN in
// {32, 64, 128}: kernels/ops.py's TMM_TILE_SIZES, which must match; every
// tile gives the same integers; 32 x 32 by default). Warps take 16 x 16 to
// 32 x 32 sub-tiles of mma.sync.m16n8k32 with int32 accumulators
// (threshold_epilogue.cuh). The block first stages its channels' banks
// step-major in shared memory, checking their order on the way in; then it
// walks K in tiles of 64: the next tile's int32 codes and int8 weights are
// loaded into registers while the current one is multiplied; the codes'
// bytes go to shared memory as a (BM, 64) tile, the weights transposed to
// (BN, 64), both with an 80-byte row stride, which makes the fragment loads
// free of bank conflicts. The block votes over each staged code tile which
// mma flavour is exact (.s8.s8, .u8.s8, or the byte split). Last the
// accumulators go to a shared-memory tile and count by the search (or the
// linear count for a falling bank), one channel per lane, and are stored.
// Ragged M, N and K are masked (out-of-range codes and weights read as 0,
// outputs past M or N are not written), so the host pads nothing.
//
// Why x is int32: the first layer's codes are signed (-127..127) and later
// codes are unsigned up to 255 (8-bit activations), so neither s8 nor u8
// holds both; the per-tile vote picks, and codes wider than 8 bits (which
// no deployed stage makes) still give the exact int32 sums by the split.
//
// Banks too large for shared memory beside the tiles (the host's
// threshold_matmul_plan decides; flags & FLAG_SEARCH clear) stream through
// it in chunks of 64 steps with the linear count, exact for any bank.
// flags & FLAG_CORES selects dp4a products on the CUDA cores instead of
// mma.sync, for timing the two apart (built for the 32 x 32 tile only).

#include <cstdint>
#include <cuda_runtime.h>

#include "threshold_epilogue.cuh"

namespace {

using namespace thr_epi;

constexpr int BK = 64;            // k bytes per shared-memory tile
constexpr int KW = BK / 4;        // k words per tile row
constexpr int LDT = KW + 4;       // tile row stride in words (80 bytes)

template <int BM, int BN>
struct Cfg {
  static constexpr int WARPS_M = BM / 32 > 2 ? BM / 32 : 2;
  static constexpr int WARPS_N = BN / 32 > 2 ? BN / 32 : 2;
  static constexpr int WTM = BM / WARPS_M;     // 16 or 32 rows per warp
  static constexpr int WTN = BN / WARPS_N;     // 16 or 32 channels per warp
  static constexpr int MI = WTM / 16;
  static constexpr int NI = WTN / 8;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int A_PER = BM * KW / NT;   // code words per thread
  static constexpr int B_PER = BN * KW / NT;   // weight words per thread
  // resident blocks asked of the compiler: 512 threads an SM (at most 128
  // registers a thread)
  static constexpr int MIN_BLOCKS = 512 / NT;
  static_assert(A_PER * NT == BM * KW && B_PER * NT == BN * KW, "tiling");
};

// the code and weight tiles, the accumulator tile and the banks
template <int BM, int BN>
size_t smem_bytes(int bank_steps) {
  return (size_t)(BM + BN) * LDT * 4 + (size_t)BM * (BN + 1) * 4
         + (size_t)bank_steps * BN * 4;
}

template <int BM, int BN, bool CORES>
__global__ void __launch_bounds__(Cfg<BM, BN>::NT, Cfg<BM, BN>::MIN_BLOCKS)
threshold_matmul_kernel(const int32_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const int32_t* __restrict__ thr,
                        int32_t* __restrict__ out,
                        int M, int N, int K, int S, int flags) {
  using G = Cfg<BM, BN>;
  constexpr int MI = G::MI, NI = G::NI, NT = G::NT;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* As = smem;                          // [BM][LDT] code bytes
  uint32_t* Bs = As + BM * LDT;                 // [BN][LDT] weights, n-major
  int32_t* at = (int32_t*)(Bs + BN * LDT);      // [BM][BN + 1] accumulators
  int32_t* ts = at + BM * (BN + 1);             // [steps][BN] banks
  __shared__ unsigned falls[(BN + 31) / 32];
  __shared__ unsigned vote[2];                  // range bits, by tile parity

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nch = min(BN, N - n0);
  const bool search = flags & FLAG_SEARCH;

  if (tid < (BN + 31) / 32) falls[tid] = 0;
  if (tid < 2) vote[tid] = 0;
  __syncthreads();

  // registers of the next tile: 4 codes per word, 4 weights per word
  int32_t xa[G::A_PER][4];
  uint32_t wb[G::B_PER];
  const bool xvec = (K & 3) == 0 && ((uintptr_t)x & 15) == 0;
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < G::A_PER; ++i) {
      const int e = tid + i * NT;
      const int r = e / KW, k = k0 + 4 * (e % KW);
      const long long m = m0 + r;
      const int32_t* src = x + m * K + k;
      if (m < M && xvec && k < K) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(src));
        xa[i][0] = v.x; xa[i][1] = v.y; xa[i][2] = v.z; xa[i][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xa[i][j] = (m < M && k + j < K) ? __ldg(src + j) : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < G::B_PER; ++i) {
      const int e = tid + i * NT;
      const int n = n0 + e % BN, k = k0 + 4 * (e / BN);
      int8_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (n < N && k + j < K) ? __ldg(w + (long long)(k + j) * N + n)
                                    : (int8_t)0;
      wb[i] = pack_s8(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_codes = [&](int plane) {
#pragma unroll
    for (int i = 0; i < G::A_PER; ++i) {
      const int e = tid + i * NT;
      As[(e / KW) * LDT + e % KW] =
          pack_plane(xa[i][0], xa[i][1], xa[i][2], xa[i][3], plane);
    }
  };

  int32_t acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  // the products of the staged tile (one plane of its codes)
  auto products = [&](bool sgn, int shift) {
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      if constexpr (!CORES) {
        uint32_t a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const uint32_t* ar = As + (wm * G::WTM + mi * 16 + g) * LDT
                               + ks * 8 + t;
          a[mi][0] = ar[0];
          a[mi][1] = ar[8 * LDT];
          a[mi][2] = ar[4];
          a[mi][3] = ar[8 * LDT + 4];
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint32_t* br = Bs + (wn * G::WTN + ni * 8 + g) * LDT
                               + ks * 8 + t;
          b[ni][0] = br[0];
          b[ni][1] = br[4];
        }
        if (sgn) mma_tiles<MI, NI, true>(acc, a, b, shift);
        else mma_tiles<MI, NI, false>(acc, a, b, shift);
      } else {
        // each lane forms its own outputs: rows g, g + 8 and channels 2t,
        // 2t + 1 of each tile, eight words of k each
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t* ar = As + (wm * G::WTM + mi * 16 + g
                                         + 8 * (i >> 1)) * LDT + ks * 8;
              const uint32_t* br = Bs + (wn * G::WTN + ni * 8 + 2 * t
                                         + (i & 1)) * LDT + ks * 8;
              int32_t d = 0;
#pragma unroll
              for (int q = 0; q < 8; ++q)
                d = sgn ? dp4<true>(ar[q], br[q], d)
                        : dp4<false>(ar[q], br[q], d);
              acc[mi][ni][i] = add_shifted(acc[mi][ni][i], d, shift);
            }
      }
    }
  };

  const int n_tiles = (K + BK - 1) / BK;
  load_tile(0);
  // its channels' banks, step-major, checked for order on the way in (the
  // first tile's loads are in flight meanwhile)
  if (search) {
    stage_banks<NT, BN>(thr, S, n0, nch, 0, S, ts, falls);
    pad_banks<NT, BN>(S, ts);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt > 0) __syncthreads();             // the previous tile is used
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < G::A_PER; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) bits |= code_bits(xa[i][j]);
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(&vote[kt & 1], bits);
    store_codes(0);
#pragma unroll
    for (int i = 0; i < G::B_PER; ++i) {
      const int e = tid + i * NT;
      Bs[(e % BN) * LDT + e / BN] = wb[i];
    }
    __syncthreads();
    const int fl = flavour_of(vote[kt & 1]);
    if (tid == 0) vote[(kt + 1) & 1] = 0;
    if (fl != WIDE) {
      if (kt + 1 < n_tiles) load_tile((kt + 1) * BK);
      products(fl == S8, 0);
    } else {
      // the byte split: bytes 0-2 as u8, byte 3 as s8, each shifted
      products(false, 0);
      for (int plane = 1; plane < 4; ++plane) {
        __syncthreads();
        store_codes(plane);
        __syncthreads();
        products(plane == 3, 8 * plane);
      }
      if (kt + 1 < n_tiles) load_tile((kt + 1) * BK);
    }
  }

  fragments_to_tile<BN + 1, MI, NI>(acc, at, wm * G::WTM, wn * G::WTN);
  __syncthreads();
  count_tile<NT, BN, BN + 1, BM>(at, BM, search, thr, S, n0, nch, ts, falls,
                                 out, N, [&](int r) -> long long {
                                   return m0 + r < M ? m0 + r : -1;
                                 });
}

template <int BM, int BN, bool CORES>
int launch(const void* x, const void* w, const void* thr, void* out, int M,
           int N, int K, int S, int flags, cudaStream_t stream) {
  static bool configured = false;
  auto kernel = threshold_matmul_kernel<BM, BN, CORES>;
  const size_t bytes = smem_bytes<BM, BN>(
      (flags & FLAG_SEARCH) ? search_steps(S) : LINEAR_CHUNK);
  if (bytes > (size_t)SMEM_DYN) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kernel, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, Cfg<BM, BN>::NT, bytes, stream>>>(
      (const int32_t*)x, (const int8_t*)w, (const int32_t*)thr,
      (int32_t*)out, M, N, K, S, flags);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (M, K) int32, w (K, N) int8,
// thr (N, S) int32, out (M, N) int32, all contiguous on the device; the
// output tile is block_m x block_n, each in {32, 64, 128}. flags:
// FLAG_SEARCH (whole banks in shared memory, sorted ones searched; the
// host's plan sets it when they fit) and FLAG_CORES (dp4a products, 32 x 32
// only). The launch goes on `stream` and the function returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tile that is not
// built or banks that do not fit.
extern "C" int threshold_matmul_launch(const void* x, const void* w,
                                       const void* thr, void* out, int M,
                                       int N, int K, int S, int block_m,
                                       int block_n, int flags, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (flags & FLAG_CORES) {
    if (block_m == 32 && block_n == 32)
      return launch<32, 32, true>(x, w, thr, out, M, N, K, S, flags, st);
    return (int)cudaErrorInvalidValue;
  }
#define TILE(bm, bn)                                                 \
  if (block_m == bm && block_n == bn)                                \
    return launch<bm, bn, false>(x, w, thr, out, M, N, K, S, flags, st);
  TILE(32, 32) TILE(32, 64) TILE(32, 128)
  TILE(64, 32) TILE(64, 64) TILE(64, 128)
  TILE(128, 32) TILE(128, 64) TILE(128, 128)
#undef TILE
  return (int)cudaErrorInvalidValue;
}
