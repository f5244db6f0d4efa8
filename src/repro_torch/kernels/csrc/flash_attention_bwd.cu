// The backward of flash attention (flash_attention.cu) for Hopper: GQA,
// causal and sliding-window masks, a query offset and a key length.
//
// With s_ij = (q_i . k_j) D^-1/2 over the live keys (j < kv_len,
// j <= i + q_offset when causal, j > i + q_offset - window when window
// > 0) and lse_i the forward's log-sum-exp of row i:
//
//   P_ij = exp(s_ij - lse_i),   delta_i = sum_d dO_id O_id,
//   dS_ij = P_ij (dP_ij - delta_i),   dP_ij = dO_i . v_j,
//   dQ_i = D^-1/2 sum_j dS_ij k_j,
//   dK_j = D^-1/2 sum_{h in group} sum_i dS_ij q_i,
//   dV_j = sum_{h in group} sum_i P_ij dO_i.
//
// The backward the TPU reference gets by differentiating its jnp flash
// twin (repro.models.attention.chunked_attention), for the kernel that
// replaces repro.kernels.flash_attention.flash_attention.
//
// Deterministic, with no atomics: two kernels, one after the other on the
// caller's stream, each output element written by one thread after a sum
// in a fixed order.
//   1. dq_kernel, one block per (64-row query tile, query head, batch):
//      delta of its rows (written to a workspace for kernel 2), then a
//      loop over the live 64-key tiles in ascending order, recomputing S
//      and dP and accumulating dQ in registers.
//   2. dkv_kernel, one block per (64-key tile, KV head, batch): the
//      group's query heads in ascending order, and for each its live
//      64-row query tiles in ascending order, recomputing S^T and dP^T and
//      accumulating dK and dV in registers.
// Both run on the CUDA cores in float32 (bf16 inputs are widened as they
// are staged in shared memory, outputs rounded once at the end), after
// the float32 forward's layout: 256 threads, thread (r, c) = (tid / 16,
// tid % 16) computes a 4 x 4 block of the 64 x 64 score tile from d-major
// tiles with one 16-byte load per operand and d, and the 16 threads of a
// row group are one half-warp. Tiles with no live entry are never loaded;
// rows past Sq and keys past Sk are zero-filled and masked. A row with no
// live key (lse = +inf) has P = 0 and so zero gradients.
//
// Bound on the H100: 5 products of 2 D operations per live (i, j) pair and
// head (S, dP, dQ, dK, dV) against q, k, v, O, dO, lse read and dQ, dK,
// dV written once; at the LM's training shape (B 2, 16 heads, 8 KV heads,
// D = 128, S = 4096, causal) about 3.4e11 operations against 168 MB, so
// the bf16 tensor-core rate bounds it (0.35 ms). This first version
// recomputes S and dP in both kernels (7 products) on the CUDA cores.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                  // query rows per tile
constexpr int BK = 64;                  // keys per tile
constexpr int LD = BQ + 4;              // row stride of the d-major tiles
constexpr int THREADS = 256;

static_assert(BQ == 64 && BK == 64 && THREADS == 256,
              "16 x 16 threads, each 4 x 4 entries, cover a 64 x 64 tile");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                     // (B, H, Sq)
  float* delta;                         // (B, H, Sq) workspace
  void* dq;
  void* dk;
  void* dv;
  int H, Hkv, Sq, Sk, kv_len, causal, window, q_offset;
  float scale;
  // element strides of (batch, head, position)
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  return kpos < p.kv_len && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// a 64-row tile of a (position, D) slice, d-major into dst[d * LD + row];
// rows at or past n are zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long row_stride, int row0, int n) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int row = e / D, d = e % D;
    const int g = row0 + row;
    dst[d * LD + row] = g < n ? ld(src + g * row_stride + d) : 0.f;
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // Q^T, dO^T, K^T, V^T [D][LD]; dS^T [BK][LD]; lse, delta [BQ]
  return 4 * D * LD + BK * LD + 2 * BQ;
}

template <int D>
constexpr int dkv_smem_floats() {
  // K^T, V^T, Q^T, dO^T [D][LD]; P, dS [BQ][LD] (query-major); lse,
  // delta [BQ]
  return 4 * D * LD + 2 * BQ * LD + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;            // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qd = smem;                     // [D][LD]
  float* dod = qd + D * LD;             // [D][LD]
  float* kd = dod + D * LD;             // [D][LD]
  float* vd = kd + D * LD;              // [D][LD]
  float* dst = vd + D * LD;             // [BK][LD]: dS^T, key-major
  float* rl = dst + BK * LD;            // [BQ] lse
  float* rd = rl + BQ;                  // [BQ] delta

  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & 15;
  const int qt = p.causal ? (int)gridDim.x - 1 - (int)blockIdx.x
                          : (int)blockIdx.x;   // causal: longest first
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  const T* o = static_cast<const T*>(p.o) + b * p.os[0] + h * p.os[1];
  const T* dout = static_cast<const T*>(p.dout) + b * p.dos[0]
                  + h * p.dos[1];
  T* dq = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1];
  const long long row_base = ((long long)b * p.H + h) * p.Sq;

  stage<T, D>(qd, q, p.qs[2], q0, p.Sq);
  stage<T, D>(dod, dout, p.dos[2], q0, p.Sq);
  __syncthreads();
  {
    // delta of row tid / 4: four lanes, each every fourth d, then two
    // shuffles (a fixed order)
    const int row = tid >> 2, part = tid & 3;
    const int gq = q0 + row;
    float acc = 0.f;
    if (gq < p.Sq)
      for (int d = part; d < D; d += 4)
        acc = fmaf(dod[d * LD + row], ld(o + gq * p.os[2] + d), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      rd[row] = acc;
      rl[row] = gq < p.Sq ? p.lse[row_base + gq] : INFINITY;
      if (gq < p.Sq) p.delta[row_base + gq] = acc;
    }
  }

  // live key range of this query tile: [k_begin, k_end)
  const int q_lo = q0 + p.q_offset;
  const int q_hi = min(q0 + BQ, p.Sq) - 1 + p.q_offset;
  int k_end = p.kv_len;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  const int k_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                  // the last tile's dS^T and K are read
    stage<T, D>(kd, k, p.ks[2], k0, p.Sk);
    stage<T, D>(vd, v, p.vs[2], k0, p.Sk);
    __syncthreads();

    // S (rows 4r + i, keys 4c + j) and dP on the same entries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qd + d * LD + 4 * r);
      const float4 kv = *reinterpret_cast<const float4*>(kd + d * LD + 4 * c);
      const float4 ov = *reinterpret_cast<const float4*>(dod + d * LD + 4 * r);
      const float4 vv = *reinterpret_cast<const float4*>(vd + d * LD + 4 * c);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }
    // dS = P (dP - delta), stored key-major
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + 4 * c + j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * r + i;
        const bool ok = q0 + row < p.Sq && live(p, q0 + row + p.q_offset,
                                               kpos);
        const float pij = ok ? expf(s[i][j] * p.scale - rl[row]) : 0.f;
        ds[i] = pij * (dp[i][j] - rd[row]);
      }
      *reinterpret_cast<float4*>(dst + (4 * c + j) * LD + 4 * r) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ (rows 4r + i, columns c + 16 j) += dS K
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float4 sv = *reinterpret_cast<const float4*>(dst + key * LD
                                                         + 4 * r);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kk = kd[(c + 16 * j) * LD + key];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sa[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[row * p.dqs[2] + c + 16 * j] = from_float<T>(acc[i][j] * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) dkv_kernel(Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* kd = smem;                     // [D][LD]
  float* vd = kd + D * LD;              // [D][LD]
  float* qd = vd + D * LD;              // [D][LD]
  float* dod = qd + D * LD;             // [D][LD]
  float* pq = dod + D * LD;             // [BQ][LD]: P, query-major
  float* dsq = pq + BQ * LD;            // [BQ][LD]: dS, query-major
  float* rl = dsq + BQ * LD;            // [BQ] lse
  float* rd = rl + BQ;                  // [BQ] delta

  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & 15;
  const int k0 = blockIdx.x * BK;       // causal: key tile 0 is the longest
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  T* dk = static_cast<T*>(p.dk) + b * p.dks[0] + hk * p.dks[1];
  T* dv = static_cast<T*>(p.dv) + b * p.dvs[0] + hk * p.dvs[1];

  // live query rows of this key tile: [i_begin, i_end)
  const int k_hi = min(k0 + BK, p.kv_len) - 1;
  int i_begin = p.causal ? max(0, k0 - p.q_offset) : 0;
  int i_end = p.Sq;
  if (p.window > 0) i_end = min(i_end, k_hi + p.window - p.q_offset);
  if (k_hi < k0) i_end = 0;             // no live key in the tile
  const int qt_begin = i_begin / BQ;
  const int qt_end = i_end > i_begin ? (i_end + BQ - 1) / BQ : qt_begin;

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) adk[i][j] = adv[i][j] = 0.f;

  if (qt_begin < qt_end) {
    stage<T, D>(kd, k, p.ks[2], k0, p.Sk);
    stage<T, D>(vd, v, p.vs[2], k0, p.Sk);
  }
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
    const T* dout = static_cast<const T*>(p.dout) + b * p.dos[0]
                    + h * p.dos[1];
    const long long row_base = ((long long)b * p.H + h) * p.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                // the last tile's P, dS, Q, dO read
      stage<T, D>(qd, q, p.qs[2], q0, p.Sq);
      stage<T, D>(dod, dout, p.dos[2], q0, p.Sq);
      if (tid < BQ) {
        const int gq = q0 + tid;
        rl[tid] = gq < p.Sq ? p.lse[row_base + gq] : INFINITY;
        rd[tid] = gq < p.Sq ? p.delta[row_base + gq] : 0.f;
      }
      __syncthreads();

      // S^T (keys 4r + i, rows 4c + j) and dP^T on the same entries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kv = *reinterpret_cast<const float4*>(kd + d * LD
                                                           + 4 * r);
        const float4 qv = *reinterpret_cast<const float4*>(qd + d * LD
                                                           + 4 * c);
        const float4 vv = *reinterpret_cast<const float4*>(vd + d * LD
                                                           + 4 * r);
        const float4 ov = *reinterpret_cast<const float4*>(dod + d * LD
                                                           + 4 * c);
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
        const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
            dp[i][j] = fmaf(va[i], oa[j], dp[i][j]);
          }
      }
      // P and dS, stored query-major
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = 4 * c + j;
        const int qpos = q0 + row + p.q_offset;
        float pv[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = q0 + row < p.Sq && live(p, qpos, k0 + 4 * r + i);
          pv[i] = ok ? expf(s[i][j] * p.scale - rl[row]) : 0.f;
          ds[i] = pv[i] * (dp[i][j] - rd[row]);
        }
        *reinterpret_cast<float4*>(pq + row * LD + 4 * r) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
        *reinterpret_cast<float4*>(dsq + row * LD + 4 * r) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      // dV (keys 4r + i, columns c + 16 j) += P^T dO, dK += dS^T Q
#pragma unroll 2
      for (int row = 0; row < BQ; ++row) {
        const float4 pv = *reinterpret_cast<const float4*>(pq + row * LD
                                                           + 4 * r);
        const float4 sv = *reinterpret_cast<const float4*>(dsq + row * LD
                                                           + 4 * r);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float oo = dod[(c + 16 * j) * LD + row];
          const float qq = qd[(c + 16 * j) * LD + row];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] = fmaf(pa[i], oo, adv[i][j]);
            adk[i][j] = fmaf(sa[i], qq, adk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * r + i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = c + 16 * j;
      dk[key * p.dks[2] + col] = from_float<T>(adk[i][j] * p.scale);
      dv[key * p.dvs[2] + col] = from_float<T>(adv[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int dq_bytes = dq_smem_floats<D>() * (int)sizeof(float);
  constexpr int dkv_bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dq_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dkv_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid_q((p.Sq + BQ - 1) / BQ, p.H, B);
  dq_kernel<T, D><<<grid_q, THREADS, dq_bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((p.Sk + BK - 1) / BK, p.Hkv, B);
  dkv_kernel<T, D><<<grid_k, THREADS, dkv_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, stream);
    case 80: return launch<T, 80>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out and d_out (B, H, Sq, D), k and v (B, Hkv, Sk, D) in bf16
// (``bf16`` != 0) or float32, lse (B, H, Sq) float32 from the forward;
// writes dq, dk, dv (the shapes and dtype of q, k, v) and uses delta, a
// (B, H, Sq) float32 workspace. Tensors are addressed through the element
// strides in ``strides``: 24 int64 values, (batch, head, position) for q,
// k, v, out, d_out, dq, dk and dv; the last dimension is contiguous.
// Returns the launches' cudaError_t (cudaErrorInvalidValue for a D other
// than 16, 80 and 128, or a grid past its limits).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const float* lse, const void* d_out, void* dq, void* dk, void* dv,
    float* delta, int B, int H, int Hkv, int Sq, int Sk, int D, int kv_len,
    int causal, int window, int q_offset, int bf16, const long long* strides,
    void* stream) {
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.dout = d_out;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.kv_len = kv_len;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = (float)(1.0 / sqrt((double)D));   // float32(D ** -0.5)
  long long* dst[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_dim<__nv_bfloat16>(p, B, D, s)
                    : launch_dim<float>(p, B, D, s));
}
