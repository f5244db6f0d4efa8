// Standalone FINN multi-threshold activation for Hopper: an int32
// accumulator against a per-channel bank gives the count of reached steps.
//
//   out[m, c] = #{ s : acc[m, c] >= thr[c, s] }      in [0, S]
//
// Replaces the Pallas kernel repro.kernels.multi_threshold.multi_threshold
// (bodies _mt_kernel for banks of S < 256 steps, _mt_slab_kernel for deeper
// banks streamed in 64-step slabs padded with INT32_MAX; wrapper
// repro.kernels.ops.multi_threshold).
//
// Bound on the H100: a non-decreasing bank (every bank the deploy path
// makes: streamline_dense emits monotone banks) needs ceil(log2(S + 1))
// compares per element, so at AD's bank (1024 rows x 72 channels, S = 255)
// the call's 0.59e6 compares take 0.04 us at the CUDA cores' int32 rate
// (64 lanes per SM, 132 SMs, 1.98 GHz) and its 0.66 MB of reads and writes
// 0.2 us at 3.35 TB/s: bytes bound it, and a launch costs ten times as
// much. (Counting all S steps, as the first version of this kernel did,
// needs 1.9e7 compares, 1.1 us.)
//
// Design. A block of 32 x 8 threads covers BC channels and one row per
// thread: a lane covers channel lane % BC of row lane / BC, so a warp
// reads 32 adjacent accumulators whatever BC is. A thread loads its
// accumulator first; the block then stages its channels' whole banks in
// shared memory once, a load per channel and 256-step chunk (two chunks
// at a time for banks above 256 steps) in flight per thread, read
// coalesced along the steps and stored step-major (S, BC + 1) (an odd row
// stride keeps the transposing writes free of bank conflicts). On the way
// each step is compared with the next one of its channel, which the next
// lane holds, and a warp-wide OR gives the channels whose bank falls
// somewhere. Sorted channels count by a branch-free upper-bound search,
// binary lifting over powers of two: #(T[c, s] <= a), which for a
// non-decreasing bank equals #(a >= T[c, s]), ties included, in
// ceil(log2(S + 1)) compares. Unsorted channels count all S steps, so
// every bank, sorted or not, gives the count the plain version gives.
// The kernel is latency-bound at the bench's shapes (a global round trip,
// a barrier and a chain of dependent shared-memory reads), so blocks are
// small and spread over the SMs: the host (multi_threshold_plan in
// kernels/ops.py) takes 4 channels for banks below 1024 steps and 1 above
// (a block's staging grows with BC * S); at AD's bank that is 4 channels
// x 64 rows, 288 blocks. Banks too deep for even one channel per block
// (S > 28,928) go to the chunked linear count (BC = 0): 32 channels and
// 32 rows per block, the bank streamed through shared memory 64 steps at
// a time, counting only the steps that exist, so nothing is padded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TY = 8;             // warps per block
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

// ---------------------------------------------------------------------------
// whole banks in shared memory: binary search for sorted channels
// ---------------------------------------------------------------------------

// CHUNKS: bank chunks of 256 steps whose loads a thread issues at once
template <int BC, int CHUNKS>
__global__ void __launch_bounds__(32 * TY)
multi_threshold_search_kernel(const int32_t* __restrict__ acc,
                              const int32_t* __restrict__ thr,
                              int32_t* __restrict__ out, int M, int C,
                              int S) {
  constexpr int LD = BC + 1;              // step-major row stride
  constexpr int RPW = 32 / BC;            // rows a warp covers
  constexpr int NT = 32 * TY;
  extern __shared__ int32_t smem[];
  int32_t* ts = smem;                     // [S][LD]
  // per warp, bit cc set when channel cc of the block has a falling step
  __shared__ unsigned falling[TY];

  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int c0 = blockIdx.y * BC;
  const int nch = min(BC, C - c0);
  const int ch = threadIdx.x % BC;
  const int c = c0 + ch;
  const long long m = (long long)blockIdx.x * TY * RPW
                      + threadIdx.y * RPW + threadIdx.x / BC;

  // this thread's accumulator first, so its load overlaps the staging
  const int32_t a = (m < M && ch < nch) ? __ldg(acc + m * C + c) : 0;

  // stage the banks step-major, one load per channel and chunk of 256
  // steps in flight per thread (the odd row stride LD keeps the
  // transposing writes free of bank conflicts); each step is compared with
  // the next one of its channel on the way, which the next lane holds (the
  // warp's last lane loads it)
  const int lane = threadIdx.x;
  unsigned fall = 0;
  for (int s0 = 0; s0 < S; s0 += CHUNKS * NT) {
    int32_t v[CHUNKS][BC], nx[CHUNKS][BC];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int ss = s0 + k * NT + tid;
#pragma unroll
      for (int cc = 0; cc < BC; ++cc) {
        const int32_t* src = thr + (long long)(c0 + cc) * S + ss;
        const bool in = cc < nch && ss < S;
        v[k][cc] = in ? __ldg(src) : INT32_MAX;
        nx[k][cc] = (in && lane == 31 && ss + 1 < S) ? __ldg(src + 1)
                                                     : INT32_MAX;
      }
    }
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int ss = s0 + k * NT + tid;
#pragma unroll
      for (int cc = 0; cc < BC; ++cc) {
        const int32_t up = __shfl_down_sync(0xffffffffu, v[k][cc], 1);
        if (lane < 31) nx[k][cc] = up;
        if (cc < nch && ss < S) {
          ts[ss * LD + cc] = v[k][cc];
          fall |= (unsigned)(v[k][cc] > nx[k][cc]) << cc;
        }
      }
    }
  }
  fall = __reduce_or_sync(0xffffffffu, fall);
  if (threadIdx.x == 0) falling[threadIdx.y] = fall;
  __syncthreads();
  if (ch >= nch) return;
#pragma unroll
  for (int w = 0; w < TY; ++w) fall |= falling[w];

  const int32_t* col = ts + ch;
  int cnt = 0;
  if (!((fall >> ch) & 1u)) {
    // binary lifting: cnt is the number of steps known to be <= a, grown
    // by the powers of two from the highest <= S down
    const int top = S > 0 ? 1 << (31 - __clz(S)) : 0;
    for (int step = top; step > 0; step >>= 1) {
      const int nxt = cnt + step;
      const int32_t t = col[(min(nxt, S) - 1) * LD];
      cnt = (nxt <= S && t <= a) ? nxt : cnt;
    }
  } else {
    for (int s = 0; s < S; ++s) cnt += a >= col[s * LD];
  }
  if (m < M) out[m * C + c] = cnt;
}

// ---------------------------------------------------------------------------
// banks deeper than shared memory: chunked linear count
// ---------------------------------------------------------------------------

constexpr int LBC = 32;           // channels per block (one per lane)
constexpr int LRPT = 4;           // rows per thread
constexpr int LBR = TY * LRPT;    // rows per block
constexpr int SB = 64;            // bank steps per shared-memory chunk

__global__ void __launch_bounds__(LBC * TY)
multi_threshold_linear_kernel(const int32_t* __restrict__ acc,
                              const int32_t* __restrict__ thr,
                              int32_t* __restrict__ out, int M, int C,
                              int S) {
  __shared__ int32_t ts[SB][LBC + 1];

  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * LBC + lane;
  const int c0 = blockIdx.y * LBC;
  const int c = c0 + lane;
  const long long m0 = (long long)blockIdx.x * LBR;

  int32_t a[LRPT], cnt[LRPT];
#pragma unroll
  for (int i = 0; i < LRPT; ++i) {
    const long long m = m0 + ty + i * TY;
    a[i] = (m < M && c < C) ? __ldg(acc + m * C + c) : 0;
    cnt[i] = 0;
  }

  for (int s0 = 0; s0 < S; s0 += SB) {
    const int steps = min(SB, S - s0);
    for (int e = tid; e < LBC * SB; e += LBC * TY) {
      const int cc = e / SB, ss = e % SB;
      if (ss < steps && c0 + cc < C)
        ts[ss][cc] = __ldg(thr + (long long)(c0 + cc) * S + s0 + ss);
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const int32_t t = ts[s][lane];
#pragma unroll
      for (int i = 0; i < LRPT; ++i) cnt[i] += a[i] >= t;
    }
    __syncthreads();
  }

  if (c >= C) return;
#pragma unroll
  for (int i = 0; i < LRPT; ++i) {
    const long long m = m0 + ty + i * TY;
    if (m < M) out[m * C + c] = cnt[i];
  }
}

template <int BC, int CHUNKS>
cudaError_t launch_chunks(const int32_t* acc, const int32_t* thr,
                          int32_t* out, int M, int C, int S,
                          cudaStream_t stream) {
  const long long bytes = (long long)S * (BC + 1) * 4;
  if (bytes > SMEM_MAX - 1024) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        multi_threshold_search_kernel<BC, CHUNKS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX - 1024);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  constexpr int BR = TY * (32 / BC);    // rows per block, one per thread
  const dim3 grid((M + BR - 1) / BR, (C + BC - 1) / BC);
  multi_threshold_search_kernel<BC, CHUNKS>
      <<<grid, dim3(32, TY), (size_t)bytes, stream>>>(acc, thr, out, M, C,
                                                      S);
  return cudaGetLastError();
}

// one chunk of loads in flight for banks up to 256 steps, two above
template <int BC>
cudaError_t launch_search(const int32_t* acc, const int32_t* thr,
                          int32_t* out, int M, int C, int S,
                          cudaStream_t stream) {
  return S <= 32 * TY
             ? launch_chunks<BC, 1>(acc, thr, out, M, C, S, stream)
             : launch_chunks<BC, 2>(acc, thr, out, M, C, S, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). acc (M, C) int32, thr (C, S)
// int32, out (M, C) int32, all contiguous on the device. ``bc`` is the
// search kernel's channels per block (1, 2 or 4; the banks of bc channels
// must fit shared memory), or 0 for the chunked linear count. The launch
// goes on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// another bc or banks that do not fit).
extern "C" int multi_threshold_launch(const void* acc, const void* thr,
                                      void* out, int M, int C, int S,
                                      int bc, void* stream) {
  const int32_t* a = (const int32_t*)acc;
  const int32_t* t = (const int32_t*)thr;
  int32_t* o = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bc) {
    case 4: return (int)launch_search<4>(a, t, o, M, C, S, s);
    case 2: return (int)launch_search<2>(a, t, o, M, C, S, s);
    case 1: return (int)launch_search<1>(a, t, o, M, C, S, s);
    case 0: {
      const dim3 grid((M + LBR - 1) / LBR, (C + LBC - 1) / LBC);
      multi_threshold_linear_kernel<<<grid, dim3(LBC, TY), 0, s>>>(
          a, t, o, M, C, S);
      return (int)cudaGetLastError();
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
