// Flash attention for Hopper: GQA, causal and sliding-window masks, a
// query offset and a key length, online softmax with float32 statistics.
//
//   out[b, h, i] = sum_j p_ij v[b, hk, j] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij) over the live keys j of row i,
//   s_ij = (q[b, h, i] . k[b, hk, j]) * D^-1/2,   hk = h / (H / Hkv),
//   j live iff j < kv_len, j <= i + q_offset (causal) and
//   j > i + q_offset - window (window > 0).
//
// Replaces the Pallas kernel repro.kernels.flash_attention.flash_attention
// (body _flash_kernel, wrapper repro.kernels.ops.flash_attention).
//
// Bound on the H100: 4 * D operations per live (i, j) pair and head against
// q, k, v and out read or written once. At the LM's prefill shape (32 query
// heads, 8 KV heads, D = 128, S = 4096, causal) that is about 1.4e11
// operations against 84 MB, so the tensor cores' bf16 rate bounds it
// (~0.14 ms). This is the simple, correct first version and runs on the
// CUDA cores in float32 (bf16 inputs are widened when they are staged), so
// it is bound by the cores' FMA and shared-memory rates, far above that
// bound: mma.sync or wgmma tiles with TMA loads are later work.
//
// Design: one block of 256 threads per (64-row query tile, head, batch).
// The query tile and one 64-key tile of K and V at a time sit in shared
// memory as float32; Q and K are stored d-major, so each thread reads its 4
// query rows and its 4 keys with one 16-byte load per d. Thread (r, c), r
// = tid / 16, c = tid % 16, computes the scores of rows 4r..4r+3 against
// keys 4c..4c+3; the 16 threads of a row group are one half-warp, so row
// max and row sum are shuffles. P goes to shared memory (over the K tile,
// which the scores no longer need) and the thread accumulates rows
// 4r..4r+3 at the columns c, c + 16, ... of the output in registers.
// Tiles that hold no live key are never loaded (the TPU kernel's pl.when
// skip, as a loop range). Masked entries get the score -1e30 and p = 0,
// and the output divides by max(l, 1e-30): for every row with a live key
// this is the TPU kernel's arithmetic, and a row with no live key at all
// gives 0 (the TPU kernel gives 0 only when none of the row's blocks is
// live, and a block-size dependent mean otherwise). Ragged Sq and Sk are
// masked in the kernel; tensors are addressed through their strides, so
// the model's (B, S, H, D) layout is read without a copy.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int LD = BQ + 4;              // row stride of the d-major tiles
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

static_assert(BQ == 64 && BK == 64 && THREADS == 256,
              "16 x 16 threads, each 4 rows x 4 keys, cover a 64 x 64 tile");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, Hkv, Sq, Sk, kv_len, causal, window, q_offset;
  float scale;
  // element strides of (batch, head, position) for q, k, v and out
  long long qs[3], ks[3], vs[3], os[3];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  // q tile [D][LD]; K tile [D][LD], then P^T [BK][LD]; V tile [BK][D]
  return D * LD + (D > BK ? D : BK) * LD + BK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;            // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                               // [D][LD]
  float* kt = qs + D * LD;                        // [D][LD], then P^T
  float* vt = kt + (D > BK ? D : BK) * LD;        // [BK][D]

  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  T* out = static_cast<T*>(p.out) + b * p.os[0] + h * p.os[1];

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int row = e / D, d = e % D;
    const int gq = q0 + row;
    qs[d * LD + row] = gq < p.Sq ? to_float(q[gq * p.qs[2] + d]) : 0.f;
  }

  // live key range of this query tile: [k_begin, k_end)
  const int q_lo = q0 + p.q_offset;
  const int q_hi = min(q0 + BQ, p.Sq) - 1 + p.q_offset;
  int k_end = p.kv_len;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_lo - p.window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                  // the last tile's P and V are read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int key = e / D, d = e % D;
      const int gk = k0 + key;
      const bool in = gk < p.Sk;
      kt[d * LD + key] = in ? to_float(k[gk * p.ks[2] + d]) : 0.f;
      vt[key * D + d] = in ? to_float(v[gk * p.vs[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * LD + 4 * r);
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * LD + 4 * c);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float pr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i + p.q_offset;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * c + j;
        ok[j] = kpos < p.kv_len && (!p.causal || kpos <= qpos) &&
                (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = ok[j] ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pr[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pr[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }

    __syncthreads();                  // every thread is done with the K tile
    float* pt = kt;                   // P^T [BK][LD]
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * c + j) * LD + 4 * r) =
          make_float4(pr[0][j], pr[1][j], pr[2][j], pr[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + key * LD + 4 * r);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = vt[key * D + c + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      out[row * p.os[2] + c + 16 * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_attention_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, stream);
    case 80: return launch<T, 80>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), out (B, H, Sq, D), each
// addressed through the element strides in ``strides``: 12 int64 values,
// (batch, head, position) for q, k, v and out; the last dimension is
// contiguous. ``bf16`` selects bfloat16 tensors, else float32. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a D other than 16, 80
// and 128).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      int kv_len, int causal, int window,
                                      int q_offset, int bf16,
                                      const long long* strides,
                                      void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.kv_len = kv_len;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = (float)(1.0 / sqrt((double)D));   // float32(D ** -0.5)
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_d<__nv_bfloat16>(p, B, D, s)
                               : launch_d<float>(p, B, D, s);
  return (int)err;
}
