// Fused int8 dataflow stage for Hopper: int8 x int8 into an int32
// accumulator on the int8 tensor cores, then the per-channel epilogue, in
// one pass.
//
//   y[m, n] = (float)(sum_k x[m, k] * w[k, n]) * scale[n] + bias[n]
//   y       = max(y, 0)                                  (relu)
//   out     = y (f32), or clip(rint(y * inv_out_scale), -128, 127) (int8)
//
// or, in the accumulator mode (the template flag ACC), the int32 sum
// itself, with no scale, bias, ReLU or requant: the row-parallel linear
// of a mesh adds these partial sums over its ranks before the one rescale,
// so the result is one device's (models/layers.py, row_parallel_linear).
//
// Replaces the Pallas kernel repro.kernels.qmatmul.qmatmul (body
// _qmatmul_kernel, wrapper repro.kernels.ops.qmatmul).
//
// Bound on the H100: at the bench's 512^3 the call reads 0.5 MB of codes
// and writes 0.25 MB (int8) or 1 MB (f32): 0.24 or 0.47 us at 3.35 TB/s,
// above the 0.14 us its 2.7e8 operations take at the int8 tensor-core
// rate, so bytes bound it; at 4096^3 the 1.4e11 operations bound it
// (69 us).
//
// Design. A block computes a BM x BN output tile with mma.sync.m16n8k32
// .s8.s8 (threshold_epilogue.cuh's fragments; both operands are int8, so
// no vote): 32 x 64 with 4 warps of 16 x 32 (512^3 gives 128 blocks for
// the 132 SMs), or 128 x 128 with 8 warps of 64 x 32 where the grid of
// those still fills the card (kernels/ops.py qmatmul_plan picks). K walks
// in tiles of 128 (64 for the large tile, whose two-deep tiles must fit 48
// KB of static shared memory), two deep: the x tile of the next step is
// copied to shared memory with cp.async (16 bytes a copy, zero-filled past
// M and K; byte loads through registers when K is not a multiple of 16 or
// x is not 16-byte aligned) and the next w tile is loaded into registers
// while the current one is multiplied. w is (K, N) row-major; a thread
// loads 16 k rows x 4 channels and transposes them (__byte_perm) into
// k-contiguous words, the B operand's layout, as K1 builds its B words.
// Both tiles have a row stride of 4 mod 8 words, which makes the fragment
// loads and the stores free of bank conflicts. Ragged M, N and K are
// masked in the kernel (out-of-range loads are 0, out-of-range outputs are
// not written): the host pads nothing.
//
// Exactness: the epilogue keeps the Pallas kernel's order and roundings,
// so the result equals the plain PyTorch version bit for bit: the int32
// accumulator rounds once to float (__int2float_rn), the scale product and
// the bias sum round separately (__fmul_rn, __fadd_rn: nvcc would contract
// a*b+c into one FMA), bias 0 when absent, as the Pallas wrapper pads it;
// the requant multiplies by the float32 reciprocal the host passes (the
// Pallas kernel's y * (1 / out_scale), not y / out_scale), rounds half to
// even (rintf, as jnp.round and torch.round) and clips before the cast.
// Integer sums do not depend on their order, so the tensor cores change
// nothing there.

#include <cstdint>
#include <cuda_runtime.h>

#include "threshold_epilogue.cuh"

namespace {

using namespace thr_epi;

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
struct Cfg {
  // tile row stride in words: BK / 4 + 4, 4 mod 8, so that the fragment
  // loads (8 rows x 4 words) and the 128-bit stores are conflict-free
  static constexpr int LDT = BK / 4 + 4;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M;
  static constexpr int WTN = BN / WARPS_N;
  static constexpr int MI = WTM / 16;
  static constexpr int NI = WTN / 8;
  static constexpr int KB = BK / 16;                    // 16-byte k blocks
  static constexpr int A_CHUNKS = BM * KB / NT;          // 16-byte copies
  static constexpr int B_ITEMS = (BN / 4) * KB;          // 4 ch x 16 k
  static constexpr int B_PER = (B_ITEMS + NT - 1) / NT;
  static_assert(A_CHUNKS * NT == BM * KB, "tiling");
};

__device__ __forceinline__ uint32_t gather_byte(uint32_t r0, uint32_t r1,
                                                uint32_t r2, uint32_t r3,
                                                int j) {
  const uint32_t sel = (uint32_t)j | (uint32_t)(j + 4) << 4;
  const uint32_t lo = __byte_perm(r0, r1, sel);
  const uint32_t hi = __byte_perm(r2, r3, sel);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, bool ACC>
__global__ void __launch_bounds__(Cfg<BM, BN, BK, WARPS_M, WARPS_N>::NT)
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ bias, void* __restrict__ out,
               int M, int N, int K, int relu, int requant, float inv_scale,
               int async_x) {
  using G = Cfg<BM, BN, BK, WARPS_M, WARPS_N>;
  constexpr int NT = G::NT, MI = G::MI, NI = G::NI, LDT = G::LDT;
  __shared__ __align__(16) uint32_t As[2][BM * LDT];   // [row][k word]
  __shared__ __align__(16) uint32_t Bs[2][BN * LDT];   // [channel][k word]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bool wvec = (N & 3) == 0 && ((uintptr_t)w & 3) == 0;

  // x: a 16-byte chunk (row e / KB, k 16 * (e % KB)) per copy
  uint32_t xa[G::A_CHUNKS][4];
  auto issue_x = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < G::A_CHUNKS; ++i) {
      const int e = tid + i * NT;
      const int r = e / G::KB, kc = 16 * (e % G::KB);
      const long long m = m0 + r;
      const int k = k0 + kc;
      if (async_x) {
        const bool in = m < M && k < K;
        cp_async16(&As[buf][r * LDT + kc / 4], in ? x + m * K + k : x,
                   in ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int8_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = (m < M && k + 4 * q + j < K)
                       ? __ldg(x + m * K + k + 4 * q + j) : (int8_t)0;
          xa[i][q] = pack_s8(v[0], v[1], v[2], v[3]);
        }
      }
    }
  };
  auto store_x = [&](int buf) {
    if (async_x) return;
#pragma unroll
    for (int i = 0; i < G::A_CHUNKS; ++i) {
      const int e = tid + i * NT;
      const int r = e / G::KB, kc = 16 * (e % G::KB);
      *reinterpret_cast<uint4*>(&As[buf][r * LDT + kc / 4]) =
          make_uint4(xa[i][0], xa[i][1], xa[i][2], xa[i][3]);
    }
  };
  // w: 16 k rows x 4 channels per item, neighbouring threads on
  // neighbouring k blocks then channels (conflict-free 128-bit stores)
  uint32_t wr[G::B_PER][16];
  auto load_w = [&](int k0) {
#pragma unroll
    for (int i = 0; i < G::B_PER; ++i) {
      const int e = tid + i * NT;
      const int kb = e % G::KB, n = 4 * (e / G::KB);
      const int gn = n0 + n;
      const int k = k0 + 16 * kb;
      if (e >= G::B_ITEMS) continue;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (wvec) {
          wr[i][r] = (k + r < K && gn < N)
                         ? __ldg(reinterpret_cast<const uint32_t*>(
                               w + (long long)(k + r) * N + gn))
                         : 0u;
        } else {
          int8_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = (k + r < K && gn + j < N)
                       ? __ldg(w + (long long)(k + r) * N + gn + j)
                       : (int8_t)0;
          wr[i][r] = pack_s8(v[0], v[1], v[2], v[3]);
        }
      }
    }
  };
  auto store_w = [&](int buf) {
#pragma unroll
    for (int i = 0; i < G::B_PER; ++i) {
      const int e = tid + i * NT;
      if (e >= G::B_ITEMS) continue;
      const int kb = e % G::KB, n = 4 * (e / G::KB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint4 v;
        v.x = gather_byte(wr[i][0], wr[i][1], wr[i][2], wr[i][3], j);
        v.y = gather_byte(wr[i][4], wr[i][5], wr[i][6], wr[i][7], j);
        v.z = gather_byte(wr[i][8], wr[i][9], wr[i][10], wr[i][11], j);
        v.w = gather_byte(wr[i][12], wr[i][13], wr[i][14], wr[i][15], j);
        *reinterpret_cast<uint4*>(&Bs[buf][(n + j) * LDT + 4 * kb]) = v;
      }
    }
  };

  int32_t acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  const int n_tiles = (K + BK - 1) / BK;
  issue_x(0, 0);
  load_w(0);
  store_x(0);
  store_w(0);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < n_tiles;
    if (more) {
      issue_x((kt + 1) * BK, nxt);
      asm volatile("cp.async.commit_group;\n" ::);
      load_w((kt + 1) * BK);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint32_t* ar = &As[cur][(wm * G::WTM + mi * 16 + g) * LDT
                                      + ks * 8 + t];
        a[mi][0] = ar[0];
        a[mi][1] = ar[8 * LDT];
        a[mi][2] = ar[4];
        a[mi][3] = ar[8 * LDT + 4];
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint32_t* br = &Bs[cur][(wn * G::WTN + ni * 8 + g) * LDT
                                      + ks * 8 + t];
        b[ni][0] = br[0];
        b[ni][1] = br[4];
      }
      mma_tiles<MI, NI, true>(acc, a, b, 0);
    }
    if (more) {
      store_x(nxt);
      store_w(nxt);
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + wn * G::WTN + ni * 8 + 2 * t + (i & 1);
      if (gn >= N) continue;
      if constexpr (ACC) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const long long gm = m0 + wm * G::WTM + mi * 16 + g + 8 * (i >> 1);
          if (gm < M) ((int32_t*)out)[gm * N + gn] = acc[mi][ni][i];
        }
        continue;
      }
      const float s = __ldg(scale + gn);
      const float bn = bias != nullptr ? __ldg(bias + gn) : 0.0f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const long long gm = m0 + wm * G::WTM + mi * 16 + g + 8 * (i >> 1);
        if (gm >= M) continue;
        float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][i]), s),
                            bn);
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
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int M, int N, int K, int relu, int requant,
           int acc_out, float inv_scale, cudaStream_t stream) {
  const int async_x = (K & 15) == 0 && ((uintptr_t)x & 15) == 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  constexpr int NT = Cfg<BM, BN, BK, WARPS_M, WARPS_N>::NT;
  if (acc_out)
    qmatmul_kernel<BM, BN, BK, WARPS_M, WARPS_N, true>
        <<<grid, NT, 0, stream>>>(
            (const int8_t*)x, (const int8_t*)w, nullptr, nullptr, out, M, N,
            K, 0, 0, 0.0f, async_x);
  else
    qmatmul_kernel<BM, BN, BK, WARPS_M, WARPS_N, false>
        <<<grid, NT, 0, stream>>>(
            (const int8_t*)x, (const int8_t*)w, (const float*)scale,
            (const float*)bias, out, M, N, K, relu, requant, inv_scale,
            async_x);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (M, K) int8, w (K, N) int8,
// scale (N,) float32, bias (N,) float32 or null, out (M, N) float32, or
// int8 when requant is set; all contiguous on the device. inv_scale is the
// float32 reciprocal of out_scale. acc_out set: out (M, N) int32, the
// accumulator, and scale, bias, relu, requant and inv_scale unread (scale
// may be null). tile 0: 32 x 64 blocks of 4 warps, 1: 128 x 128 blocks of
// 8 warps (the host's qmatmul_plan), k tiles of 128 and 64. The launch goes
// on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// tile that is not built.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int M, int N,
                              int K, int relu, int requant, int acc_out,
                              float inv_scale, int tile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tile == 0)
    return launch<32, 64, 128, 2, 2>(x, w, scale, bias, out, M, N, K, relu,
                                requant, acc_out, inv_scale, st);
  if (tile == 1)
    return launch<128, 128, 64, 2, 4>(x, w, scale, bias, out, M, N, K, relu,
                                  requant, acc_out, inv_scale, st);
  return (int)cudaErrorInvalidValue;
}
