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
// Deterministic in both routes, with no atomics: a dK/dV kernel and a dQ
// kernel, one after the other on the caller's stream, each output element
// written once after sums in a fixed order, so a second call equals the
// first bit for bit. A row with no live key (lse = +inf) has P = 0 and so
// zero gradients.
//
// Bound on the H100: 5 products of 2 D operations per live (i, j) pair and
// head (S, dP, dQ, dK, dV) against q, k, v, O, dO, lse read and dQ, dK,
// dV written once; at the LM's training shape (B 2, 16 heads, 8 KV heads,
// D = 128, S = 4096, causal) about 3.4e11 operations against 168 MB, so
// the bf16 tensor-core rate bounds it (0.35 ms). Both routes recompute S
// and dP in the dQ kernel (7 products for 5): keeping dS in device memory
// instead would move about 2 GB a launch at that shape (0.64 ms), more
// than the two products cost (0.14 ms at the bf16 peak).
//
// bf16: on the tensor cores, after FlashAttention-3's backward and the
// forward's design (the building blocks are in hopper.cuh). A pre-pass
// writes delta and lse log2(e) of every row into a workspace (rows padded
// to a multiple of 128: +inf and 0), so the two kernels read both with
// no bounds check and rebuild P with one FFMA and one ex2 an entry. Both
// kernels run three warpgroups: warpgroup 0 gives its registers away
// (setmaxnreg) and one of its threads issues every TMA load into a
// 2-stage ring with full and empty mbarriers; warpgroups 1 and 2 each own
// 64 rows of the block's resident tile. Tiles are 64-column boxes of
// 128 B rows with the 128 B swizzle, from tensor maps built per call from
// the strides (the model's (B, S, H, D) views need no copy); D = 16 and
// D = 80 are padded in shared memory by TMA's zero fill and padded
// columns are not stored. Every product is a wgmma with bf16 operands and
// fp32 accumulators:
//   1. dkv_tc_kernel, one block per (KV head, 128-key tile, batch): K and
//      V of the tile stay in shared memory; the group's query heads in
//      ascending order, and for each its live 64-row query tiles in
//      ascending order, stream through the ring (Q and dO by TMA boxes,
//      the rows' lse and delta by bulk copies beside them). Per tile and
//      warpgroup: S^T = K.Q^T and dP^T = V.dO^T (both operands in shared
//      memory, K-major, m64n64k16), P^T and dS^T on the fp32 fragments,
//      then dV += P^T.dO and dK += dS^T.Q with A the fragment rounded to
//      bf16 in registers (the accumulator fragment of 16 queries is the A
//      fragment of one k16 step) and B the Q or dO tile as an MN-major
//      operand (m64n64k16 a 64-column box). dK and dV stay fp32 in
//      registers over the whole walk.
//   2. dq_tc_kernel, one block per (query head, 128-row query tile,
//      batch): Q and dO stay in shared memory; the live 64-key tiles in
//      ascending order stream through the ring (K and V with their own
//      full barriers, so S starts before V lands). Per tile and
//      warpgroup: S = Q.K^T and dP = dO.V^T (K-major), dS on the
//      fragment, dQ += dS.K with dS in registers and the K tile as an
//      MN-major operand.
// P and dS never pass through shared memory. Tiles with no live pair are
// never loaded; masks apply only on the tiles that cross an edge. Causal
// blocks are issued longest first (key tile 0 first in kernel 1, the last
// query tile first in kernel 2), and heads that share a KV head have
// neighbouring block indices in kernel 2.
//
// float32: the first version, on the CUDA cores (a tensor-core route
// cannot hold its 1e-5 contract: TF32 keeps 10 mantissa bits). dq_kernel,
// one block per (64-row query tile, query head, batch), writes delta of
// its rows to the workspace and loops over the live 64-key tiles in
// ascending order, recomputing S and dP and accumulating dQ in registers;
// dkv_kernel, one block per (64-key tile, KV head, batch), walks the
// group's query heads and their live 64-row query tiles in ascending
// order, recomputing S^T and dP^T and accumulating dK and dV in
// registers. 256 threads, thread (r, c) = (tid / 16, tid % 16) computes a
// 4 x 4 block of the 64 x 64 score tile from d-major float32 tiles with
// one 16-byte load per operand and d, and the 16 threads of a row group
// are one half-warp. Rows past Sq and keys past Sk are zero-filled and
// masked.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
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

cudaError_t launch_f32(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<float, 16>(p, B, stream);
    case 80: return launch<float, 80>(p, B, stream);
    case 128: return launch<float, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (wgmma, TMA, mbarriers, warp specialisation)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 384;         // producer warpgroup + 2 consumers
constexpr int TC_ROWS = 128;            // resident rows of a block
constexpr int TC_STEP = 64;             // streamed rows of a ring stage
constexpr int TC_PAD = 128;             // workspace rows per (batch, head):
                                        // Sq rounded up to a multiple of it
constexpr int BOX_BIG = TC_ROWS * BOX_COLS * 2;     // bytes of a 128-row box
constexpr int BOX_SMALL = TC_STEP * BOX_COLS * 2;   // bytes of a 64-row box
constexpr float LOG2E = 1.4426950408889634f;
// added to a CUresult of cuTensorMapEncodeTiled that the entry point returns
constexpr int TENSOR_MAP_ERROR = 10000;

struct TcParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;                     // (B, H, Sq)
  float* ws;                            // lse log2(e), then delta: (B, H, Sqp)
  void* dq;
  void* dk;
  void* dv;
  int H, Hkv, Sq, Sqp, Sk, kv_len, causal, window, q_offset, n_qtiles;
  long long ws_half;                    // B * H * Sqp: delta's offset in ws
  float scale, scale_log2;              // D^-1/2 and D^-1/2 log2(e)
  // element strides of (batch, head, position)
  long long os[3], dos[3], dqs[3], dks[3], dvs[3];
};

template <int D>
__host__ __device__ constexpr int tc_boxes() {
  return D <= BOX_COLS ? 1 : 2;
}

// delta_i = sum_d dO_id O_id (a warp a row, lanes on d pairs, then a
// shuffle tree: a fixed order) and lse_i log2(e); padding rows get +inf
// and 0
template <int D>
__global__ void __launch_bounds__(256) bwd_prep_kernel(const TcParams p) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.ws_half) return;
  const int bh = (int)(row / p.Sqp);
  const int i = (int)(row - (long long)bh * p.Sqp);
  const int b = bh / p.H, h = bh - b * p.H;
  float acc = 0.f;
  if (i < p.Sq) {
    const __nv_bfloat16* orow = p.o + b * p.os[0] + h * p.os[1] + i * p.os[2];
    const __nv_bfloat16* drow = p.dout + b * p.dos[0] + h * p.dos[1]
                                + i * p.dos[2];
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(orow + d));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(drow + d));
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.ws[row] = i < p.Sq ? p.lse[(long long)bh * p.Sq + i] * LOG2E
                         : INFINITY;
    p.ws[p.ws_half + row] = acc;
  }
}

// whether key kpos is live for the query at position qpos
__device__ __forceinline__ bool tc_live(const TcParams& p, int qpos,
                                        int kpos) {
  return kpos < p.kv_len && (!p.causal || kpos <= qpos)
         && (p.window <= 0 || kpos > qpos - p.window);
}

// Shared memory of a block: two resident tiles (NB 128-row boxes each),
// the ring's 2 stages of two streamed tiles (NB 64-row boxes each), the
// stages' lse and delta rows (2 x 2 x 64 floats), then 7 barriers; 1024 B
// aligned for the swizzle.
template <int D>
constexpr int tc_smem_bytes() {
  return 1024 + 2 * tc_boxes<D>() * BOX_BIG + 4 * tc_boxes<D>() * BOX_SMALL
         + 4 * TC_STEP * 4 + 8 * 8;
}

// the bf16 pair (lo, hi) at dst (4-byte aligned)
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* dst, float lo,
                                             float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,    // 64-row boxes
              const __grid_constant__ CUtensorMap tdo,   // 64-row boxes
              const __grid_constant__ CUtensorMap tk,    // 128-row boxes
              const __grid_constant__ CUtensorMap tv,    // 128-row boxes
              const TcParams p) {
  constexpr int NB = tc_boxes<D>();
  constexpr int DP = NB * BOX_COLS;
  constexpr int KV_TILE = NB * BOX_BIG;         // the block's K (or V)
  constexpr int Q_TILE = NB * BOX_SMALL;        // a stage's Q (or dO)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = base;
  uint8_t* sv = sk + KV_TILE;
  uint8_t* sq = sv + KV_TILE;                   // stage s at sq + s * Q_TILE
  uint8_t* sdo = sq + 2 * Q_TILE;
  float* srow = reinterpret_cast<float*>(sdo + 2 * Q_TILE);
  // stage s: lse at srow + 128 s, delta at srow + 128 s + 64
  uint64_t* bars = reinterpret_cast<uint64_t*>(srow + 4 * TC_STEP);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;                    // [2]
  uint64_t* empty = bars + 3;                   // [2]

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * TC_ROWS;          // causal: tile 0 is longest
  const int G = p.H / p.Hkv;

  // live query rows of this key tile: [i_begin, i_end)
  const int k_hi = min(k0 + TC_ROWS, p.kv_len) - 1;
  const int i_begin = p.causal ? max(0, k0 - p.q_offset) : 0;
  int i_end = p.Sq;
  if (p.window > 0) i_end = min(i_end, k_hi + p.window - p.q_offset);
  const int qt_begin = i_begin / TC_STEP;
  const int nq = (k_hi >= k0 && i_end > i_begin)
                     ? (i_end + TC_STEP - 1) / TC_STEP - qt_begin : 0;
  const int n_tiles = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);                  // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(kv_full, 2 * KV_TILE);
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        tma_load_box(sk + x * BOX_BIG, &tk, kv_full, x * BOX_COLS, k0, hk, b);
        tma_load_box(sv + x * BOX_BIG, &tv, kv_full, x * BOX_COLS, k0, hk, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int h = hk * G + i / nq;
        const int q0 = (qt_begin + i % nq) * TC_STEP;
        const int st = i & 1;
        mbar_wait(empty + st, ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * Q_TILE + 2 * TC_STEP * 4);
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          tma_load_box(sq + st * Q_TILE + x * BOX_SMALL, &tq, full + st,
                       x * BOX_COLS, q0, h, b);
          tma_load_box(sdo + st * Q_TILE + x * BOX_SMALL, &tdo, full + st,
                       x * BOX_COLS, q0, h, b);
        }
        const long long r = ((long long)b * p.H + h) * p.Sqp + q0;
        tma_load_bytes(srow + 2 * TC_STEP * st, p.ws + r, TC_STEP * 4,
                       full + st);
        tma_load_bytes(srow + 2 * TC_STEP * st + TC_STEP,
                       p.ws + p.ws_half + r, TC_STEP * 4, full + st);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns keys k0 + 64 cw .. k0 + 64 cw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    // this thread's keys (r0, r0 + 8) within the block and first query
    // in each 8-column group of the fragments
    const int r0 = 64 * cw + 16 * warp + (lane >> 2);
    const int c2 = 2 * (lane & 3);
    const int kc = k0 + 64 * cw;                // the warpgroup's first key

    float dk[NB][32], dv[NB][32];
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[x][e] = dv[x][e] = 0.f;

    if (n_tiles > 0) {
      const uint32_t k_addr = smem_u32(sk) + cw * 64 * 128;
      const uint32_t v_addr = smem_u32(sv) + cw * 64 * 128;
      mbar_wait(kv_full, 0);
      for (int i = 0; i < n_tiles; ++i) {
        const int q0 = (qt_begin + i % nq) * TC_STEP;
        const int st = i & 1;
        const uint32_t q_addr = smem_u32(sq + st * Q_TILE);
        const uint32_t do_addr = smem_u32(sdo + st * Q_TILE);
        mbar_wait(full + st, (i >> 1) & 1);

        // S^T = K Q^T and dP^T = V dO^T: DP / 16 steps of depth 16, four
        // per 128 B-wide box
        float s[32], dp[32];
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t a_off = (kk >> 2) * BOX_BIG + (kk & 3) * 32;
          const uint32_t b_off = (kk >> 2) * BOX_SMALL + (kk & 3) * 32;
          wgmma_m64n64k16_ss(s, sw128_desc(k_addr + a_off, 16),
                             sw128_desc(q_addr + b_off, 16), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t a_off = (kk >> 2) * BOX_BIG + (kk & 3) * 32;
          const uint32_t b_off = (kk >> 2) * BOX_SMALL + (kk & 3) * 32;
          wgmma_m64n64k16_ss(dp, sw128_desc(v_addr + a_off, 16),
                             sw128_desc(do_addr + b_off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // P^T and dS^T on the fragments: s[4j + 2hf + e] is key
        // k0 + r0 + 8 hf, query q0 + 8j + c2 + e; then both to bf16 A
        // fragments, 16 queries a step
        const bool whole = kc + 63 < p.kv_len
                           && (!p.causal || kc + 63 <= q0 + p.q_offset)
                           && (p.window <= 0
                               || kc > q0 + TC_STEP - 1 + p.q_offset
                                       - p.window);
        const float* lse_s = srow + 2 * TC_STEP * st;
        const float* del_s = lse_s + TC_STEP;
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
            const float2 lq = *reinterpret_cast<const float2*>(lse_s + 8 * j
                                                               + c2);
            const float2 dl = *reinterpret_cast<const float2*>(del_s + 8 * j
                                                               + c2);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = 4 * j + 2 * hf + e;
                float pv = fast_exp2(fmaf(s[n], p.scale_log2,
                                          -(e ? lq.y : lq.x)));
                if (!whole)
                  pv = tc_live(p, q0 + 8 * j + c2 + e + p.q_offset,
                               k0 + r0 + 8 * hf) ? pv : 0.f;
                s[n] = pv;
                dp[n] = pv * (dp[n] - (e ? dl.y : dl.x));
              }
            }
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            pa[kk][g] = pack_bf16x2(s[8 * kk + 2 * g], s[8 * kk + 2 * g + 1]);
            da[kk][g] = pack_bf16x2(dp[8 * kk + 2 * g],
                                    dp[8 * kk + 2 * g + 1]);
          }
        }

        // dV += P^T dO and dK += dS^T Q: 4 steps of 16 queries per
        // 64-column box, B the stage's tile as an MN-major operand
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          fence_regs(dk[x]);
          fence_regs(dv[x]);
        }
        wgmma_fence();
#pragma unroll
        for (int x = 0; x < NB; ++x)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_rs_tb(
                dv[x], pa[kk],
                sw128_desc(do_addr + x * BOX_SMALL + kk * 16 * 128,
                           BOX_SMALL));
#pragma unroll
        for (int x = 0; x < NB; ++x)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_rs_tb(
                dk[x], da[kk],
                sw128_desc(q_addr + x * BOX_SMALL + kk * 16 * 128,
                           BOX_SMALL));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          fence_regs(dk[x]);
          fence_regs(dv[x]);
        }
        if (tid == 0) mbar_arrive(empty + st);  // this stage is read
      }
    }

    // every key of the tile below Sk is written, zeros where no query
    // was live
    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dks[0]
                         + hk * p.dks[1];
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.dvs[0]
                         + hk * p.dvs[1];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = k0 + r0 + 8 * hf;
      if (key >= p.Sk) continue;
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = x * BOX_COLS + 8 * j + c2;
          const int n = 4 * j + 2 * hf;
          if (col < D) {
            store_bf16x2(dkp + key * p.dks[2] + col, dk[x][n] * p.scale,
                         dk[x][n + 1] * p.scale);
            store_bf16x2(dvp + key * p.dvs[2] + col, dv[x][n], dv[x][n + 1]);
          }
        }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,     // 128-row boxes
             const __grid_constant__ CUtensorMap tdo,    // 128-row boxes
             const __grid_constant__ CUtensorMap tk,     // 64-row boxes
             const __grid_constant__ CUtensorMap tv,     // 64-row boxes
             const TcParams p) {
  constexpr int NB = tc_boxes<D>();
  constexpr int DP = NB * BOX_COLS;
  constexpr int Q_TILE = NB * BOX_BIG;          // the block's Q (or dO)
  constexpr int K_TILE = NB * BOX_SMALL;        // a stage's K (or V)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = base;
  uint8_t* sdo = sq + Q_TILE;
  uint8_t* sk = sdo + Q_TILE;                   // stage s at sk + s * K_TILE
  uint8_t* sv = sk + 2 * K_TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + 2 * K_TILE);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                  // [2]
  uint64_t* v_full = bars + 3;                  // [2]
  uint64_t* empty = bars + 5;                   // [2]

  // heads that share a KV head are neighbours along x; causal query tiles
  // go longest first
  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = p.causal ? p.n_qtiles - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
  const int q0 = qt * TC_ROWS;
  const int hk = h / (p.H / p.Hkv);

  // live key range of this query tile: [k_begin, k_end)
  const int q_lo = q0 + p.q_offset;
  const int q_hi = min(q0 + TC_ROWS, p.Sq) - 1 + p.q_offset;
  int k_end = p.kv_len;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  const int k_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int t_begin = k_begin / TC_STEP;
  const int t_end = k_end > 0 ? (k_end + TC_STEP - 1) / TC_STEP : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2);                  // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load -------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && t_begin < t_end) {
      mbar_expect_tx(q_full, 2 * Q_TILE);
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        tma_load_box(sq + x * BOX_BIG, &tq, q_full, x * BOX_COLS, q0, h, b);
        tma_load_box(sdo + x * BOX_BIG, &tdo, q_full, x * BOX_COLS, q0, h,
                     b);
      }
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i & 1;
        mbar_wait(empty + st, ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(k_full + st, K_TILE);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          tma_load_box(sk + st * K_TILE + x * BOX_SMALL, &tk, k_full + st,
                       x * BOX_COLS, t * TC_STEP, hk, b);
        mbar_expect_tx(v_full + st, K_TILE);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          tma_load_box(sv + st * K_TILE + x * BOX_SMALL, &tv, v_full + st,
                       x * BOX_COLS, t * TC_STEP, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63 ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = 64 * cw + 16 * warp + (lane >> 2);
    const int c2 = 2 * (lane & 3);

    // the two rows' lse log2(e) and delta (padding rows: +inf and 0)
    const long long wrow = ((long long)b * p.H + h) * p.Sqp + q0 + r0;
    const float lse2[2] = {p.ws[wrow], p.ws[wrow + 8]};
    const float delta[2] = {p.ws[p.ws_half + wrow],
                            p.ws[p.ws_half + wrow + 8]};

    float acc[NB][32];
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[x][e] = 0.f;

    if (t_begin < t_end) {
      const uint32_t q_addr = smem_u32(sq) + cw * 64 * 128;
      const uint32_t do_addr = smem_u32(sdo) + cw * 64 * 128;
      mbar_wait(q_full, 0);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i & 1;
        const int par = (i >> 1) & 1;
        const int k0 = t * TC_STEP;
        const uint32_t k_addr = smem_u32(sk + st * K_TILE);
        const uint32_t v_addr = smem_u32(sv + st * K_TILE);

        // S = Q K^T, then dP = dO V^T once V has landed
        float s[32], dp[32];
        mbar_wait(k_full + st, par);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t a_off = (kk >> 2) * BOX_BIG + (kk & 3) * 32;
          const uint32_t b_off = (kk >> 2) * BOX_SMALL + (kk & 3) * 32;
          wgmma_m64n64k16_ss(s, sw128_desc(q_addr + a_off, 16),
                             sw128_desc(k_addr + b_off, 16), kk > 0);
        }
        mbar_wait(v_full + st, par);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t a_off = (kk >> 2) * BOX_BIG + (kk & 3) * 32;
          const uint32_t b_off = (kk >> 2) * BOX_SMALL + (kk & 3) * 32;
          wgmma_m64n64k16_ss(dp, sw128_desc(do_addr + a_off, 16),
                             sw128_desc(v_addr + b_off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // dS on the fragment: s[4j + 2hf + e] is row q0 + r0 + 8 hf, key
        // k0 + 8j + c2 + e; then to bf16 A fragments, 16 keys a step
        const bool whole = k0 + TC_STEP <= p.kv_len
                           && (!p.causal || k0 + TC_STEP - 1 <= q_lo)
                           && (p.window <= 0
                               || k0 > q0 + TC_ROWS - 1 + p.q_offset
                                       - p.window);
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = 4 * j + 2 * hf + e;
                float pv = fast_exp2(fmaf(s[n], p.scale_log2, -lse2[hf]));
                if (!whole)
                  pv = tc_live(p, q0 + r0 + 8 * hf + p.q_offset,
                               k0 + 8 * j + c2 + e) ? pv : 0.f;
                dp[n] = pv * (dp[n] - delta[hf]);
              }
            }
          }
#pragma unroll
          for (int g = 0; g < 4; ++g)
            da[kk][g] = pack_bf16x2(dp[8 * kk + 2 * g],
                                    dp[8 * kk + 2 * g + 1]);
        }

        // dQ += dS K: 4 steps of 16 keys per 64-column box, the stage's
        // K tile as an MN-major operand
#pragma unroll
        for (int x = 0; x < NB; ++x) fence_regs(acc[x]);
        wgmma_fence();
#pragma unroll
        for (int x = 0; x < NB; ++x)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_rs_tb(
                acc[x], da[kk],
                sw128_desc(k_addr + x * BOX_SMALL + kk * 16 * 128,
                           BOX_SMALL));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int x = 0; x < NB; ++x) fence_regs(acc[x]);
        if (tid == 0) mbar_arrive(empty + st);  // this stage is read
      }
    }

    __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dqs[0]
                         + h * p.dqs[1];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r0 + 8 * hf;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = x * BOX_COLS + 8 * j + c2;
          const int n = 4 * j + 2 * hf;
          if (col < D)
            store_bf16x2(dqp + row * p.dqs[2] + col, acc[x][n] * p.scale,
                         acc[x][n + 1] * p.scale);
        }
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, TcParams& p,
              int B, const long long* strides, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<D>();
  // on every call, before the tensor maps: a runtime call makes the
  // device's primary context current on a thread that has made none yet
  // (autograd's worker thread runs this backward), which
  // cuTensorMapEncodeTiled needs; it is allowed inside a graph capture
  cudaError_t err = cudaFuncSetAttribute(
      dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (p.Sk + TC_ROWS - 1) / TC_ROWS;
  if (p.n_qtiles > 65535 || n_ktiles > 65535)
    return (int)cudaErrorInvalidValue;
  // kernel 1 streams 64-row Q / dO boxes past 128-row K / V boxes, kernel
  // 2 the other way round
  const void* out_grad = p.dout;
  CUtensorMap q1, do1, k1, v1, q2, do2, k2, v2;
  CUresult r = make_map(&q1, q, D, p.Sq, p.H, B, strides, TC_STEP);
  if (r == CUDA_SUCCESS)
    r = make_map(&do1, out_grad, D, p.Sq, p.H, B, strides + 12, TC_STEP);
  if (r == CUDA_SUCCESS)
    r = make_map(&k1, k, D, p.Sk, p.Hkv, B, strides + 3, TC_ROWS);
  if (r == CUDA_SUCCESS)
    r = make_map(&v1, v, D, p.Sk, p.Hkv, B, strides + 6, TC_ROWS);
  if (r == CUDA_SUCCESS)
    r = make_map(&q2, q, D, p.Sq, p.H, B, strides, TC_ROWS);
  if (r == CUDA_SUCCESS)
    r = make_map(&do2, out_grad, D, p.Sq, p.H, B, strides + 12, TC_ROWS);
  if (r == CUDA_SUCCESS)
    r = make_map(&k2, k, D, p.Sk, p.Hkv, B, strides + 3, TC_STEP);
  if (r == CUDA_SUCCESS)
    r = make_map(&v2, v, D, p.Sk, p.Hkv, B, strides + 6, TC_STEP);
  if (r != CUDA_SUCCESS) return TENSOR_MAP_ERROR + (int)r;

  bwd_prep_kernel<D><<<(unsigned)((p.ws_half + 7) / 8), 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_tc_kernel<D><<<dim3(p.Hkv, n_ktiles, B), TC_THREADS, bytes, stream>>>(
      q1, do1, k1, v1, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_tc_kernel<D><<<dim3(p.H, p.n_qtiles, B), TC_THREADS, bytes, stream>>>(
      q2, do2, k2, v2, p);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const float* lse, const void* d_out, void* dq, void* dk,
                void* dv, float* ws, int B, int H, int Hkv, int Sq, int Sk,
                int D, int kv_len, int causal, int window, int q_offset,
                const long long* strides, cudaStream_t stream) {
  TcParams p;
  p.o = static_cast<const __nv_bfloat16*>(out);
  p.dout = static_cast<const __nv_bfloat16*>(d_out);
  p.lse = lse;
  p.ws = ws;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sqp = (Sq + TC_PAD - 1) / TC_PAD * TC_PAD;
  p.Sk = Sk;
  p.kv_len = kv_len;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.n_qtiles = (Sq + TC_ROWS - 1) / TC_ROWS;
  p.ws_half = (long long)B * H * p.Sqp;
  p.scale = (float)(1.0 / sqrt((double)D));   // float32(D ** -0.5)
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  long long* dst[5] = {p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[9 + 3 * t + i];
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, p, B, strides, stream);
    case 80: return launch_tc<80>(q, k, v, p, B, strides, stream);
    case 128: return launch_tc<128>(q, k, v, p, B, strides, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


}  // namespace

// q, out and d_out (B, H, Sq, D), k and v (B, Hkv, Sk, D) in bf16
// (``bf16`` != 0) or float32, lse (B, H, Sq) float32 from the forward;
// writes dq, dk, dv (the shapes and dtype of q, k, v) and uses ``ws``, a
// float32 workspace: (B, H, Sq) for float32, 2 x (B, H, Sqp) for bf16 with
// Sqp = Sq rounded up to a multiple of 128. Tensors are addressed through
// the element strides in ``strides``: 24 int64 values, (batch, head,
// position) for q, k, v, out, d_out, dq, dk and dv; the last dimension is
// contiguous. bf16 reads q, k, v and d_out through TMA tensor maps: their
// bases and strides must be multiples of 16 bytes. Returns the launches'
// cudaError_t (cudaErrorInvalidValue for a D other than 16, 80 and 128, or
// a grid past its limits), or TENSOR_MAP_ERROR plus the CUresult when a
// tensor map cannot be built.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const float* lse, const void* d_out, void* dq, void* dk, void* dv,
    float* ws, int B, int H, int Hkv, int Sq, int Sk, int D, int kv_len,
    int causal, int window, int q_offset, int bf16, const long long* strides,
    void* stream) {
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bf16(q, k, v, out, lse, d_out, dq, dk, dv, ws, B, H, Hkv,
                       Sq, Sk, D, kv_len, causal, window, q_offset, strides,
                       s);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.dout = d_out;
  p.lse = lse;
  p.delta = ws;
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
  return (int)launch_f32(p, B, D, s);
}
