// The deployed models' float head: integer codes times a float32 weight
// matrix, rescaled and shifted.
//
//   y[m, n] = (sum_k float(x[m, k]) * w[k, n]) * in_scale + b[n]
//
// A repair, not a port of a TPU kernel: the head is the reference's plain
// ``x_int.astype(float32) @ w * in_scale + b`` (FloatHeadStage.apply_ref,
// src/repro/deploy/lower.py:441), which the port first left to cuBLAS.
// cuBLAS picks its reduction by shape, so a row's logits depended on how
// many rows came with it: a 64-row serving wave differed from one call on
// all the served rows by up to 0.0029 of 13,135 on AD. Here every output
// sums its K products in an order fixed by K alone: K is cut into splits
// of KS = 16 (K <= 256) or 32 consecutive k (rounds of 16 splits when K >
// 512: split s then takes k in [512 r + 32 s, 512 r + 32 s + 32) of every
// round r), each split sums its products one after the other with a fused
// multiply-add per step, and the splits' sums are added in split order.
// So y[m, n] depends on row m alone and on K, never on M, N or the tile
// it falls in. The rescale and the bias follow in the reference's order,
// each rounded on its own (__fmul_rn, __fadd_rn: no contraction into an
// FMA).
//
// Bound on the H100: the heads are small (K <= 512, N <= 128, up to a few
// thousand rows), so reading the codes and writing the logits bound it;
// at AD's head (1024 x 72 codes, 72 x 128 weights) that is under 1 us at
// 3.35 TB/s, below a launch. What a launch takes is a chain of dependent
// FMAs and the round trips that feed it.
//
// Design: a block of 128 threads owns RB rows and a group of up to 16
// outputs; thread (s, r) = (tid / RB, tid % RB), RB = 128 / S, runs split
// s of row r for all the group's outputs, so every lane is busy whatever
// N is (a head of N = 10 or 12 is one group) and each thread keeps up to
// 16 independent FMA chains of at most 32 steps. The group's weights are
// staged in shared memory split by split, k-major, the group's outputs
// padded to a multiple of 4 (with a 4-float skew between splits, so the
// splits a warp spans read distinct banks), loaded in 4-output slots with
// a row's slots on neighbouring lanes: a step reads them as float4s that
// the split's lanes share. A thread's codes come from device memory
// as 16-byte loads, issued before the block waits for the weights; all
// of a thread's staging loads are issued together, so a block pays one
// round trip to L2 for its weights and one for its codes. The splits'
// sums meet in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int GROUP = 16;               // outputs of a column group
constexpr int SPLITS = 16;              // most splits a row

// CP: the group's outputs padded to a multiple of 4; KS: k a split
template <int CP, int KS>
__global__ void __launch_bounds__(THREADS)
float_head_kernel(const int32_t* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y,
                  int M, int N, int K, float in_scale, int S, int RB) {
  constexpr int ROUND = SPLITS * KS;             // k of a staged round
  constexpr int WS = KS * CP + 4;                // floats of a split's W
  constexpr int CQ = CP / 4;                     // 4-output slots a row
  __shared__ __align__(16) float ws[SPLITS * WS];
  __shared__ __align__(16) float part[THREADS * CP];

  const int tid = threadIdx.x;
  const int s = tid / RB, r = tid - s * RB;
  const int m = blockIdx.x * RB + r;
  const int n0 = blockIdx.y * GROUP;
  const int nc = min(GROUP, N - n0);             // the group's outputs
  const bool active = s < S && m < M;
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool wvec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int32_t* xr = x + (long long)m * K;

  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.f;

  for (int k_round = 0; k_round < K; k_round += ROUND) {
    const int k_hi = min(K - k_round, ROUND);
    if (k_round > 0) __syncthreads();            // the last round is read

    // the group's weights of this round in slots of 4 outputs, a row's
    // slots on neighbouring lanes (16-byte loads where the row is
    // aligned); up to 16 slots a thread, every load issued before any
    // store
    for (int f0 = tid; f0 < k_hi * CQ; f0 += 16 * THREADS) {
      float4 v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int f = f0 + u * THREADS;
        const int k = f / CQ, c = 4 * (f - k * CQ);
        const float* src = w + (long long)(k_round + k) * N + n0 + c;
        if (f >= k_hi * CQ) {
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (wvec && c + 4 <= nc) {
          v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          v[u].x = c < nc ? __ldg(src) : 0.f;
          v[u].y = c + 1 < nc ? __ldg(src + 1) : 0.f;
          v[u].z = c + 2 < nc ? __ldg(src + 2) : 0.f;
          v[u].w = c + 3 < nc ? __ldg(src + 3) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int f = f0 + u * THREADS;
        const int k = f / CQ, c = 4 * (f - k * CQ);
        if (f < k_hi * CQ)
          *reinterpret_cast<float4*>(ws + (k / KS) * WS + (k % KS) * CP
                                     + c) = v[u];
      }
    }

    // this thread's codes of the round, loaded before the barrier
    const int k0 = k_round + s * KS;
    const int k_len = active ? min(KS, K - k0) : 0;
    float xv[KS];
    if (k_len == KS) {
#pragma unroll
      for (int i = 0; i < KS; i += 4) {
        if (vec) {
          const int4 q = __ldg(reinterpret_cast<const int4*>(xr + k0 + i));
          xv[i] = __int2float_rn(q.x);
          xv[i + 1] = __int2float_rn(q.y);
          xv[i + 2] = __int2float_rn(q.z);
          xv[i + 3] = __int2float_rn(q.w);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xv[i + e] = __int2float_rn(__ldg(xr + k0 + i + e));
        }
      }
    }
    __syncthreads();

    const float* wsp = ws + s * WS;
    if (k_len == KS) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int c = 0; c < CP; c += 4) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(wsp + kk * CP + c);
          acc[c] = __fmaf_rn(xv[kk], w4.x, acc[c]);
          acc[c + 1] = __fmaf_rn(xv[kk], w4.y, acc[c + 1]);
          acc[c + 2] = __fmaf_rn(xv[kk], w4.z, acc[c + 2]);
          acc[c + 3] = __fmaf_rn(xv[kk], w4.w, acc[c + 3]);
        }
      }
    } else {
      // the ragged last split (k_len < KS; nothing when k_len <= 0)
      for (int kk = 0; kk < k_len; ++kk) {
        const float xk = __int2float_rn(__ldg(xr + k0 + kk));
#pragma unroll
        for (int c = 0; c < CP; c += 4) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(wsp + kk * CP + c);
          acc[c] = __fmaf_rn(xk, w4.x, acc[c]);
          acc[c + 1] = __fmaf_rn(xk, w4.y, acc[c + 1]);
          acc[c + 2] = __fmaf_rn(xk, w4.z, acc[c + 2]);
          acc[c + 3] = __fmaf_rn(xk, w4.w, acc[c + 3]);
        }
      }
    }
  }

  // the splits' sums meet in shared memory and are added in split order
  if (s < S) {
#pragma unroll
    for (int c = 0; c < CP; c += 4)
      *reinterpret_cast<float4*>(part + tid * CP + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  }
  __syncthreads();
  for (int o = tid; o < RB * nc; o += THREADS) {
    const int rr = o / nc, c = o - rr * nc;
    const int mo = blockIdx.x * RB + rr;
    if (mo >= M) continue;
    float sum = part[rr * CP + c];
    for (int j = 1; j < S; ++j) sum = __fadd_rn(sum, part[(j * RB + rr) * CP + c]);
    y[(long long)mo * N + n0 + c] =
        __fadd_rn(__fmul_rn(sum, in_scale), b[n0 + c]);
  }
}

template <int CP>
cudaError_t launch_cp(const int32_t* x, const float* w, const float* b,
                      float* y, int M, int N, int K, float in_scale,
                      cudaStream_t stream) {
  // splits of 16 k up to K = 256, else of 32; at most 16 a row; the
  // block's rows share its 128 threads
  const int ks = K <= SPLITS * 16 ? 16 : 32;
  const int splits = K > 0 ? min(SPLITS, (K + ks - 1) / ks) : 1;
  const int rb = THREADS / splits;
  const dim3 grid((M + rb - 1) / rb, (N + GROUP - 1) / GROUP);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (ks == 16)
    float_head_kernel<CP, 16><<<grid, THREADS, 0, stream>>>(
        x, w, b, y, M, N, K, in_scale, splits, rb);
  else
    float_head_kernel<CP, 32><<<grid, THREADS, 0, stream>>>(
        x, w, b, y, M, N, K, in_scale, splits, rb);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) int32, w (K, N) float32, b (N,) float32, y (M, N) float32, all
// contiguous. Returns the launch's cudaError_t.
extern "C" int float_head_launch(const void* x, const void* w, const void* b,
                                 void* y, int M, int N, int K, float in_scale,
                                 void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const auto* xi = static_cast<const int32_t*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* yf = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((min(N, GROUP) + 3) / 4) {
    case 1: return (int)launch_cp<4>(xi, wf, bf, yf, M, N, K, in_scale, s);
    case 2: return (int)launch_cp<8>(xi, wf, bf, yf, M, N, K, in_scale, s);
    case 3: return (int)launch_cp<12>(xi, wf, bf, yf, M, N, K, in_scale, s);
    default: return (int)launch_cp<16>(xi, wf, bf, yf, M, N, K, in_scale, s);
  }
}
