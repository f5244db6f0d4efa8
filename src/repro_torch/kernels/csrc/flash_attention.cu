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
// (0.139 ms).
//
// bf16: one kernel on the tensor cores, after FlashAttention-3's design.
// One block of three warpgroups per (128-row query tile, query head,
// batch). Warpgroup 0 is the producer: after setmaxnreg gives its
// registers to the consumers, one thread issues TMA loads, the Q tile once
// and 128-key K and V tiles into a ring of 2 stages, each stage with full
// barriers (K and V apart, so Q.K^T starts before V lands) and an empty
// barrier that both consumers arrive on. Warpgroups 1 and 2 each own 64
// query rows: S = Q.K^T by wgmma m64n128k16 (Q and K from shared memory,
// K-major), the online softmax on the fp32 accumulator fragment (a row's
// keys sit in one quad of lanes, so row max and sum are two shuffles;
// exp2f with D^-1/2 log2(e) folded into one scale), then P rounded to bf16
// in registers (the accumulator fragment of 16 keys is the A fragment of
// one step) and O += P.V by wgmma m64n64k16 with V from shared memory as
// an MN-major operand; P never goes through shared memory, O and the
// statistics stay fp32. Tiles are 64-column boxes of 128 B rows with the
// 128 B swizzle; a head dim below 64 or between 64 and 128 is padded in
// shared memory by TMA's zero fill (zero columns leave Q.K^T as it is, and
// the extra P.V columns are not stored). Tensor maps are built per call
// from the strides, so the model's (B, S, H, D) views need no copy; TMA's
// zero fill also covers ragged Sq and Sk. Tiles without a live key are
// never loaded; masks apply only to tiles that cross an edge, and a row
// without a live key gives 0. Heads that share a KV head have neighbouring
// block indices (their K/V tiles come from L2), and causal query tiles are
// issued longest first.
//
// float32: the first version, on the CUDA cores (a tensor-core route
// cannot hold its 1e-5 contract: TF32 keeps 10 mantissa bits). One block
// of 256 threads per (64-row query tile, head, batch) loops over 64-key
// tiles with the online-softmax state in registers. The query tile and
// one 64-key tile of K and V at a time sit in shared memory as float32; Q
// and K are stored d-major, so each thread reads its 4 query rows and its
// 4 keys with one 16-byte load per d. Thread (r, c), r = tid / 16, c =
// tid % 16, computes the scores of rows 4r..4r+3 against keys 4c..4c+3;
// the 16 threads of a row group are one half-warp, so row max and row sum
// are shuffles. P goes to shared memory (over the K tile, which the scores
// no longer need) and the thread accumulates rows 4r..4r+3 at the columns
// c, c + 16, ... of the output in registers. Tiles that hold no live key
// are never loaded (the TPU kernel's pl.when skip, as a loop range).
// Masked entries get the score -1e30 and p = 0, and the output divides by
// max(l, 1e-30): for every row with a live key this is the TPU kernel's
// arithmetic, and a row with no live key at all gives 0 (the TPU kernel
// gives 0 only when none of the row's blocks is live, and a block-size
// dependent mean otherwise). Ragged Sq and Sk are masked in the kernel;
// tensors are addressed through their strides.
//
// Both kernels optionally write each row's log-sum-exp of its scaled live
// scores, lse[b, h, i] = log sum_j exp(s_ij) (float32, (B, H, Sq)
// contiguous; +inf on a row with no live key), which the backward kernel
// (flash_attention_bwd.cu) rebuilds P from.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int LD = BQ + 4;              // row stride of the d-major tiles
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
// added to a CUresult of cuTensorMapEncodeTiled that the entry point returns
constexpr int TENSOR_MAP_ERROR = 10000;

static_assert(BQ == 64 && BK == 64 && THREADS == 256,
              "16 x 16 threads, each 4 rows x 4 keys, cover a 64 x 64 tile");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                           // (B, H, Sq) or null
  int H, Hkv, Sq, Sk, kv_len, causal, window, q_offset;
  float scale;
  // element strides of (batch, head, position) for q, k, v and out
  long long qs[3], ks[3], vs[3], os[3];
};

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
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
    if (p.lse != nullptr && c == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
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

cudaError_t launch_f32(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<float, 16>(p, B, stream);
    case 80: return launch<float, 80>(p, B, stream);
    case 128: return launch<float, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma, TMA, mbarriers, warp specialisation;
// the building blocks are in hopper.cuh, shared with the backward)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;              // query rows per block
constexpr int TC_BK = 128;              // keys per tile
constexpr int TC_THREADS = 384;         // producer warpgroup + 2 consumers
constexpr int TC_BOX_COLS = BOX_COLS;   // a TMA box: 64 bf16 = one 128 B row
constexpr int TC_BOX_BYTES = 128 * TC_BOX_COLS * 2;   // 128 rows per box

struct TcParams {
  void* out;
  float* lse;                           // (B, H, Sq) or null
  int H, Hkv, Sq, kv_len, causal, window, q_offset, n_qtiles;
  float scale_log2;                     // D^-1/2 * log2(e)
  long long os[3];                      // out's (batch, head, position)
};

// Shared memory of one block: Q (NB boxes), then 2 stages of K and of V
// (NB boxes each), then the barriers; 1024 B aligned for the swizzle.
template <int DP>
constexpr int tc_smem_bytes() {
  return 1024 + 5 * (DP / TC_BOX_COLS) * TC_BOX_BYTES + 8 * 8;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const TcParams p) {
  constexpr int DP = D <= TC_BOX_COLS ? TC_BOX_COLS : 2 * TC_BOX_COLS;
  constexpr int NB = DP / TC_BOX_COLS;          // boxes per tile
  constexpr int TILE = NB * TC_BOX_BYTES;       // bytes of one Q/K/V tile
  static_assert(D <= DP && D % 8 == 0, "head dim fits the padded tile");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = base;
  uint8_t* sk = sq + TILE;                      // stage s at sk + s * TILE
  uint8_t* sv = sk + 2 * TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + 2 * TILE);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                  // [2]
  uint64_t* v_full = bars + 3;                  // [2]
  uint64_t* empty = bars + 5;                   // [2]

  // heads that share a KV head are neighbours along x; causal query tiles
  // go longest first
  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = p.causal ? p.n_qtiles - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
  const int q0 = qt * TC_BQ;
  const int hk = h / (p.H / p.Hkv);

  // live key range of this query tile: [k_begin, k_end)
  const int q_lo = q0 + p.q_offset;
  const int q_hi = min(q0 + TC_BQ, p.Sq) - 1 + p.q_offset;
  int k_end = p.kv_len;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  const int k_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int t_begin = k_begin / TC_BK;
  const int t_end = k_end > 0 ? (k_end + TC_BK - 1) / TC_BK : 0;

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
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, TILE);
#pragma unroll
      for (int x = 0; x < NB; ++x)
        tma_load_box(sq + x * TC_BOX_BYTES, &tq, q_full, x * TC_BOX_COLS,
                     q0, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i & 1;
        mbar_wait(empty + st, ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(k_full + st, TILE);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          tma_load_box(sk + st * TILE + x * TC_BOX_BYTES, &tk, k_full + st,
                       x * TC_BOX_COLS, t * TC_BK, hk, b);
        mbar_expect_tx(v_full + st, TILE);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          tma_load_box(sv + st * TILE + x * TC_BOX_BYTES, &tv, v_full + st,
                       x * TC_BOX_COLS, t * TC_BK, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63 ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    // this thread's rows (r0, r0 + 8) and first column in each 8-column
    // group of the accumulator fragments
    const int r0 = 64 * cw + 16 * warp + (lane >> 2);
    const int c2 = 2 * (lane & 3);

    float o[NB][32];
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    const uint32_t q_addr = smem_u32(sq) + cw * 64 * 128;
    // S = Q K^T of the tile in stage st: DP / 16 steps of depth 16, four
    // per 128 B-wide box (issued, not waited for)
    float s[64];
    auto issue_qk = [&](int st) {
      const uint32_t k_addr = smem_u32(sk + st * TILE);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * TC_BOX_BYTES + (kk & 3) * 32;
        wgmma_m64n128k16_ss(s, sw128_desc(q_addr + off, 16),
                            sw128_desc(k_addr + off, 16), kk > 0);
      }
    };
    mbar_wait(q_full, 0);
    if (t_begin < t_end) {
      mbar_wait(k_full, 0);
      fence_regs(s);
      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
    }

    // tile t: softmax of S(t) (ready), then O += P(t) V(t) issued together
    // with S(t + 1) = Q K(t + 1)^T, so the tensor cores run the two back
    // to back; both are waited for before stage t is released
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int st = i & 1;
      const int par = (i >> 1) & 1;
      const int k0 = t * TC_BK;
      const uint32_t v_addr = smem_u32(sv + st * TILE);

      // masks only on tiles that cross an edge of the live region
      const bool full = k0 + TC_BK <= p.kv_len
                        && (!p.causal || k0 + TC_BK - 1 <= q_lo)
                        && (p.window <= 0
                            || k0 > q0 + TC_BQ - 1 + p.q_offset - p.window);
      // online softmax on the fragment: s[4j + 2hf + e] is row r0 + 8 hf,
      // key k0 + 8j + c2 + e; a row's 128 keys live in one quad of lanes.
      // m is kept in units of log2: p = 2^(s * scale_log2 - m), one FFMA
      // and one ex2 per score
      float corr[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int qpos = q0 + r0 + 8 * hf + p.q_offset;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = s[4 * j + 2 * hf + e];
            if (!full) {
              const int kpos = k0 + 8 * j + c2 + e;
              const bool ok = kpos < p.kv_len
                              && (!p.causal || kpos <= qpos)
                              && (p.window <= 0 || kpos > qpos - p.window);
              v = ok ? v : -INFINITY;
              s[4 * j + 2 * hf + e] = v;
            }
            mx = fmaxf(mx, v);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx * p.scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        corr[hf] = fast_exp2(m[hf] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = fast_exp2(
                fmaf(s[4 * j + 2 * hf + e], p.scale_log2, -m_use));
            s[4 * j + 2 * hf + e] = pv;
            sum += pv;
          }
        }
        l[hf] = l[hf] * corr[hf] + sum;
        m[hf] = m_new;
      }

      // P to bf16 in registers: the accumulator fragment of keys
      // 16kk .. 16kk + 15 is the A fragment of step kk
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) o[x][i2] *= corr[(i2 >> 1) & 1];

      // O += P V: 8 steps of 16 keys per 64-column box of V
      mbar_wait(v_full + st, par);
      fence_regs(s);
#pragma unroll
      for (int x = 0; x < NB; ++x) fence_regs(o[x]);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_m64n64k16_rs_tb(
              o[x], pa[kk],
              sw128_desc(v_addr + x * TC_BOX_BYTES + kk * 16 * 128,
                         TC_BOX_BYTES));
      wgmma_commit();
      if (t + 1 < t_end) {
        const int st1 = (i + 1) & 1;
        mbar_wait(k_full + st1, ((i + 1) >> 1) & 1);
        issue_qk(st1);
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(s);
#pragma unroll
      for (int x = 0; x < NB; ++x) fence_regs(o[x]);
      if (tid == 0) mbar_arrive(empty + st);   // this stage is read
    }

    // normalise and store bf16 pairs through out's strides
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.os[0]
                         + h * p.os[1];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r0 + 8 * hf;
      if (row >= p.Sq) continue;
      const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
      // m is in units of log2 of the scaled score: lse = ln 2 (m + log2 l)
      if (p.lse != nullptr && (lane & 3) == 0)
        p.lse[((long long)b * p.H + h) * p.Sq + row] =
            l[hf] > 0.f ? 0.6931471805599453f * (m[hf] + log2f(l[hf]))
                        : INFINITY;
      __nv_bfloat16* orow = out + row * p.os[2];
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = x * TC_BOX_COLS + 8 * j + c2;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[x][4 * j + 2 * hf] * inv,
                                      o[x][4 * j + 2 * hf + 1] * inv);
        }
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int H, int Hkv, int Sq, int Sk, int kv_len, int causal,
              int window, int q_offset, const long long* strides,
              cudaStream_t stream) {
  constexpr int DP = D <= TC_BOX_COLS ? TC_BOX_COLS : 2 * TC_BOX_COLS;
  constexpr int bytes = tc_smem_bytes<DP>();
  // on every call, before the tensor maps: a runtime call makes the
  // device's primary context current on a thread that has made none yet
  // (autograd's worker thread recomputes this forward under remat), which
  // cuTensorMapEncodeTiled needs; it is allowed inside a graph capture
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, q, D, Sq, H, B, strides, TC_BQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, k, D, Sk, Hkv, B, strides + 3, TC_BK);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, v, D, Sk, Hkv, B, strides + 6, TC_BK);
  if (r != CUDA_SUCCESS) return TENSOR_MAP_ERROR + (int)r;
  TcParams p;
  p.out = out;
  p.lse = lse;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.kv_len = kv_len;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.n_qtiles = (Sq + TC_BQ - 1) / TC_BQ;
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  if (p.n_qtiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, p.n_qtiles, B);
  flash_attention_tc_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), out (B, H, Sq, D), each
// addressed through the element strides in ``strides``; lse, when not
// null, receives each row's log-sum-exp, (B, H, Sq) float32 contiguous.
// The strides are 12 int64 values,
// (batch, head, position) for q, k, v and out; the last dimension is
// contiguous. ``bf16`` selects bfloat16 tensors (the tensor-core kernel:
// bases and strides of q, k and v multiples of 16 bytes), else float32.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a D other
// than 16, 80 and 128), or TENSOR_MAP_ERROR plus the CUresult when a
// tensor map cannot be built.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      int kv_len, int causal, int window,
                                      int q_offset, int bf16,
                                      const long long* strides,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (D) {
      case 16: return launch_tc<16>(q, k, v, out, lse, B, H, Hkv, Sq, Sk,
                                    kv_len, causal, window, q_offset,
                                    strides, s);
      case 80: return launch_tc<80>(q, k, v, out, lse, B, H, Hkv, Sq, Sk,
                                    kv_len, causal, window, q_offset,
                                    strides, s);
      case 128: return launch_tc<128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk,
                                      kv_len, causal, window, q_offset,
                                      strides, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
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
  return (int)launch_f32(p, B, D, s);
}
