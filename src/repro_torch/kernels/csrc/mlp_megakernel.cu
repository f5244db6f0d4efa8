// Megakernel for Hopper: a whole run of fused integer dense stages in ONE
// launch, the inter-stage codes kept in shared memory.
//
//   h_0 = x
//   h_{d+1}[m, n] = #{ s : sum_k h_d[m, k] * w_d[k, n] >= thr_d[s, n] }
//   out = h_D                              (D = number of stages, <= 8)
//
// Replaces the Pallas kernel repro.kernels.megakernel.mlp_megakernel
// (body _mega_kernel, wrapper repro.kernels.ops.mlp_megakernel).
//
// The TPU kernel keeps every weight matrix and bank resident in VMEM. A
// Hopper block has at most 227 KB of shared memory, less than the
// full-width KWS weights alone, so this kernel keeps only the row tiles on
// chip and reads weights and banks from global memory: every block reads
// the same few hundred KB, which come from device memory once per wave and
// from the 50 MB L2 after that. The planner (repro_torch.deploy.lower
// .plan_megakernel) admits a run only when the tiles fit shared memory and
// the weights and banks fit its L2 budget (repro_torch.core.bops).
//
// Layout. One block of 128 threads per BM = 8 rows of the wave. Shared
// memory holds the block's input rows and two revolving FIFO tiles, each
// k-major (element (row r, feature k) at tile[k * BM + r]) so that four
// rows of one feature are one 16-byte load. Stage d reads one tile and
// writes its codes into the other; only the last stage writes to global
// memory. Rows past M are staged as 0 and never written, so the host pads
// nothing.
//
// Work per stage: each thread takes items of RM rows x 4 columns (RM = 4
// when the stage has at least one such item per thread, else RM = 1 so
// that narrow stages still spread over the block), accumulates exactly in
// int32 on the CUDA cores, then counts the bank linearly over all S steps,
// as the TPU kernel does (exact for unsorted banks too). Weight rows and
// bank steps are loaded U = 8 at a time ahead of their use. Banks come step-major,
// (S, N), so the four columns of one step are one 16-byte load and a warp
// reads contiguous lines (the (N, S) layout K1 reads is strided by S).
// Stages whose width is a multiple of 4 load weights as char4 and banks as
// int4; other widths load bytes and words with masks.
//
// Why int32 codes and CUDA cores: the first layer's codes are signed and
// later ones reach 255, so neither s8 nor u8 holds both (see
// threshold_matmul.cu). MMA, cp.async/TMA staging of weight slabs and
// bank-conflict-free tile layouts are later work.
//
// Bound on the H100: at the tiny models' shapes (1024 rows, K <= 512,
// N <= 512) a launch moves well under 10 MB and does under a GMAC, so the
// bound is microseconds. Up to about a thousand rows a launch takes as
// long as one block's serial chain — every k step and bank step of every
// stage, one after the other, each waiting on memory — so the row block
// is small (8 rows: a 1024-row wave fills 128 of the 132 SMs); the
// sweep behind the choice is scripts/k3_row_block_sweep.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 8;          // = repro_torch.core.bops.MEGAKERNEL_BLOCK_M
constexpr int THREADS = 128;
constexpr int MAX_STAGES = 8;   // = repro_torch.core.bops.MEGAKERNEL_MAX_STAGES
constexpr int U = 8;            // weight rows / bank steps loaded together
// = repro_torch.core.bops.MEGAKERNEL_SMEM_BYTES, the sm_90 block maximum
constexpr int SMEM_MAX = 232448;

struct Chain {
  const int8_t* w[MAX_STAGES];     // (K_d, N_d) row-major int8
  const int32_t* thr[MAX_STAGES];  // (S_d, N_d) step-major int32
  int k[MAX_STAGES];
  int n[MAX_STAGES];
  int s[MAX_STAGES];
  int vec[MAX_STAGES];  // N_d % 4 == 0 and the pointers allow vector loads
  int n_stages;
  int inter;            // FIFO tile width: the widest intermediate N_d
};

template <bool VEC>
__device__ __forceinline__ void load4_w(const int8_t* __restrict__ p,
                                        int rem, int32_t b[4]) {
  if constexpr (VEC) {
    const char4 v = __ldg(reinterpret_cast<const char4*>(p));
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = j < rem ? (int32_t)__ldg(p + j) : 0;
  }
}

template <bool VEC>
__device__ __forceinline__ void load4_t(const int32_t* __restrict__ p,
                                        int rem, int32_t t[4]) {
  if constexpr (VEC) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = j < rem ? __ldg(p + j) : 0;
  }
}

template <int RM>
__device__ __forceinline__ void mac(const int32_t* hp, const int32_t b[4],
                                    int32_t acc[RM][4]) {
  int32_t a[RM];
  if constexpr (RM == 4) {
    const int4 v = *reinterpret_cast<const int4*>(hp);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else {
    a[0] = hp[0];
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
}

template <int RM>
__device__ __forceinline__ void count(const int32_t acc[RM][4],
                                      const int32_t t[4],
                                      int32_t cnt[RM][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cnt[i][j] += acc[i][j] >= t[j];
}

// One stage for the block's BM rows: h (K x BM, k-major, shared) times w
// (K x N), thresholded by thr (S x N). Writes the codes k-major into dst
// (shared) or, for the last stage (dst == nullptr), row-major into out.
// Weights and bank steps are loaded U at a time before they are used, so
// a thread waits for one memory latency per U steps, not per step.
template <int RM, bool VEC>
__device__ __forceinline__ void run_stage(
    const int32_t* h, const int8_t* __restrict__ w,
    const int32_t* __restrict__ thr, int K, int N, int S, int32_t* dst,
    int32_t* __restrict__ out, long long m0, int rows) {
  const int cg = (N + 3) / 4;
  const int items = (BM / RM) * cg;
  for (int e = threadIdx.x; e < items; e += THREADS) {
    const int c0 = (e % cg) * 4;
    const int r0 = (e / cg) * RM;
    const int rem = N - c0;
    int32_t acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    int k = 0;
    for (; k + U <= K; k += U) {
      int32_t b[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load4_w<VEC>(w + (long long)(k + u) * N + c0, rem, b[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) mac<RM>(h + (k + u) * BM + r0, b[u], acc);
    }
    for (; k < K; ++k) {
      int32_t b[4];
      load4_w<VEC>(w + (long long)k * N + c0, rem, b);
      mac<RM>(h + k * BM + r0, b, acc);
    }
    int32_t cnt[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cnt[i][j] = 0;
    int s = 0;
    for (; s + U <= S; s += U) {
      int32_t t[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load4_t<VEC>(thr + (long long)(s + u) * N + c0, rem, t[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) count<RM>(acc, t[u], cnt);
    }
    for (; s < S; ++s) {
      int32_t t[4];
      load4_t<VEC>(thr + (long long)s * N + c0, rem, t);
      count<RM>(acc, t, cnt);
    }
    if (dst != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= rem) break;
        if constexpr (RM == 4) {
          *reinterpret_cast<int4*>(dst + (c0 + j) * BM + r0) =
              make_int4(cnt[0][j], cnt[1][j], cnt[2][j], cnt[3][j]);
        } else {
          dst[(c0 + j) * BM + r0] = cnt[0][j];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (r0 + i >= rows) break;
        int32_t* o = out + (m0 + r0 + i) * N + c0;
        if constexpr (VEC) {
          *reinterpret_cast<int4*>(o) =
              make_int4(cnt[i][0], cnt[i][1], cnt[i][2], cnt[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < rem) o[j] = cnt[i][j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mlp_megakernel_kernel(const int32_t* __restrict__ x,
                      int32_t* __restrict__ out, const Chain c, int M) {
  extern __shared__ __align__(16) int32_t smem[];
  const int k0 = c.k[0];
  const long long m0 = (long long)blockIdx.x * BM;
  const int rows = (int)min((long long)BM, (long long)M - m0);

  // the block's input rows, k-major; rows past M are 0
  for (int e = threadIdx.x; e < BM * k0; e += THREADS) {
    const int r = e / k0, k = e % k0;
    smem[k * BM + r] = r < rows ? __ldg(x + (m0 + r) * k0 + k) : 0;
  }
  __syncthreads();

  const int32_t* h = smem;
  for (int d = 0; d < c.n_stages; ++d) {
    int32_t* dst = d == c.n_stages - 1
                       ? nullptr
                       : smem + k0 * BM + (d & 1) * c.inter * BM;
    const int K = c.k[d], N = c.n[d], S = c.s[d];
    const bool wide = (BM / 4) * ((N + 3) / 4) >= THREADS;
    if (c.vec[d]) {
      if (wide)
        run_stage<4, true>(h, c.w[d], c.thr[d], K, N, S, dst, out, m0, rows);
      else
        run_stage<1, true>(h, c.w[d], c.thr[d], K, N, S, dst, out, m0, rows);
    } else {
      if (wide)
        run_stage<4, false>(h, c.w[d], c.thr[d], K, N, S, dst, out, m0, rows);
      else
        run_stage<1, false>(h, c.w[d], c.thr[d], K, N, S, dst, out, m0,
                            rows);
    }
    // the codes just written are the next stage's input; the tile just
    // read is the one the stage after next overwrites
    __syncthreads();
    h = dst;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (M, dims[0]) int32 and out
// (M, dims[n_stages]) int32 are contiguous on the device; w[d] points to
// stage d's (dims[d], dims[d+1]) int8 weights and thr[d] to its
// (steps[d], dims[d+1]) int32 step-major bank. `w`, `thr`, `dims` and
// `steps` are host arrays. The launch goes on `stream`; returns the
// cudaError_t of the launch (or of setting its shared-memory size).
extern "C" int mlp_megakernel_launch(const void* x, void* out,
                                     const void* const* w,
                                     const void* const* thr, const int* dims,
                                     const int* steps, int n_stages, int M,
                                     void* stream) {
  if (n_stages < 1 || n_stages > MAX_STAGES || M <= 0)
    return (int)cudaErrorInvalidValue;
  Chain c = {};
  c.n_stages = n_stages;
  c.inter = 0;
  for (int d = 0; d < n_stages; ++d) {
    c.w[d] = (const int8_t*)w[d];
    c.thr[d] = (const int32_t*)thr[d];
    c.k[d] = dims[d];
    c.n[d] = dims[d + 1];
    c.s[d] = steps[d];
    c.vec[d] = dims[d + 1] % 4 == 0 && (uintptr_t)w[d] % 4 == 0 &&
               (uintptr_t)thr[d] % 16 == 0 && (uintptr_t)out % 16 == 0;
    if (d < n_stages - 1 && dims[d + 1] > c.inter) c.inter = dims[d + 1];
  }
  const int n_fifo = n_stages - 1 < 2 ? n_stages - 1 : 2;
  const size_t smem =
      sizeof(int32_t) * BM * ((size_t)dims[0] + (size_t)n_fifo * c.inter);
  // lift the 48 KB default ceiling on dynamic shared memory to the
  // block maximum, once (a thread-safe static initialisation)
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      mlp_megakernel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const dim3 grid((M + BM - 1) / BM);
  mlp_megakernel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, c, M);
  return (int)cudaGetLastError();
}
