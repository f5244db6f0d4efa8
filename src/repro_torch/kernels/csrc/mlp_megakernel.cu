// Megakernel for Hopper: a whole run of fused integer dense stages in ONE
// launch, on thread-block clusters, the inter-stage codes kept in
// distributed shared memory.
//
//   h_0 = x
//   h_{d+1}[m, n] = #{ s : sum_k h_d[m, k] * w_d[k, n] >= thr_d[s, n] }
//   out = h_D                              (D = number of stages, <= 8)
//
// Replaces the Pallas kernel repro.kernels.megakernel.mlp_megakernel
// (body _mega_kernel, wrapper repro.kernels.ops.mlp_megakernel).
//
// The TPU kernel keeps every weight matrix and bank resident in VMEM. One
// Hopper block has 227 KB of shared memory, less than the full-width KWS
// weights alone; a cluster of C <= 8 blocks (CTAs) on neighbouring SMs has
// C times that, and each CTA can write its peers' shared memory. So a
// launch is a grid of clusters, one cluster per row tile of BM rows, and
// CTA j of a cluster owns a contiguous share of every stage's output
// channels, in n8 tiles (tiles [j * T / C, (j + 1) * T / C) of the stage's
// T = ceil(N / 8)). It holds only its slices:
//
//   * prologue: every copy is issued at once, by cp.async, one group per
//     stage (the row tile's int32 input codes in stage 0's): the weights of
//     its channels of every stage, which the host packs once into words of
//     4 k bytes of one channel (ops.megakernel_pack_weights), so that
//     16-byte copies of 4 channels land them in the B operand's layout (k
//     word rows of weight_stride words, 8 mod 32: a B fragment's loads hit
//     32 banks); its slice of every bank, step-major (S, channels), padded
//     to search_steps(S) steps with INT32_MAX. Stage d waits only for its
//     own group. Slices that do not fit a CTA: the weights stream through a
//     shared-memory chunk of CHUNK_K k at a time, the banks are searched in
//     global memory (the host's plan, kernels/ops.py megakernel_plan,
//     decides). Each channel whose bank falls somewhere gets a bit in
//     `falls`, a run of 8 steps a thread; a later stage's check runs inside
//     the cluster barrier before it.
//   * products on the int8 tensor cores: mma.sync.m16n8k32 with the
//     fragments of threshold_epilogue.cuh. The flavour (.s8.s8, .u8.s8 or
//     the byte split, exact for any int32 code) is voted once over the
//     run's input tile; a later stage's codes are counts in [0, S] of the
//     stage before, so its flavour follows from S. A warp unit is up to 4
//     n8 tiles of every m16 tile over a slice of the stage's k steps; when
//     there are fewer units than warps the stage's K is split across warps
//     and the int32 partial sums are added in shared memory
//     (red.shared.add: integer sums do not depend on order). One
//     instantiation per (m16 tiles, flavour) keeps the code a launch runs
//     small.
//   * threshold epilogue: a thread per row and 4 channels; sorted banks are
//     searched by branch-free binary lifting, the 4 searches interleaved,
//     falling ones counted step by step.
//   * the inter-stage FIFO in distributed shared memory: every CTA writes
//     its channels' codes of the row tile into the next stage's code tile
//     of EVERY CTA of the cluster (mapa + st.shared::cluster, 16 bytes a
//     store), then the cluster synchronises; each CTA then holds the whole
//     code row of the stage as the next A operand. The two code tiles
//     alternate. The last stage writes its codes to global memory,
//     coalesced. Only the run's input and its last codes cross device
//     memory, as in the TPU kernel.
//
// Rows past M are never loaded (fragment rows past the tile's valid rows
// read as 0) and never stored; channels past N give code 0, which is what
// the next stage's padded k reads; the host pads nothing. A CTA with no
// channel in a stage still takes part in the cluster barrier.
//
// Bound on the H100: at the tiny models' shapes (1024 rows, K <= 512,
// N <= 512) a launch moves well under 10 MB and does under a GMAC, so the
// bound is microseconds and the kernel is latency-bound: the staging in the
// prologue, one cluster barrier per stage and each warp's chain of mma
// steps (a clock64 breakdown per phase is in PERF.md). A row tile spreads
// each stage over C SMs, so a batch-1 query uses C SMs, not one; at 1024
// rows the plan takes small clusters (2-3 CTAs), whose grid fills the card
// in one wave (MEGAKERNEL_ACTIVE_CLUSTERS in kernels/ops.py).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

#include "threshold_epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace thr_epi;

constexpr int NT = 256;          // = repro_torch.kernels.ops.MEGAKERNEL_THREADS
constexpr int NW = NT / 32;
constexpr int MAX_STAGES = 8;    // = repro_torch.core.bops.MEGAKERNEL_MAX_STAGES
constexpr int MAX_CLUSTER = 8;   // = ops.MEGAKERNEL_MAX_CLUSTER (portable)
constexpr int MAX_BLOCK_M = 64;  // = max(ops.MEGAKERNEL_ROW_TILES)
constexpr int CHUNK_K = 128;     // = ops.MEGAKERNEL_CHUNK_K
constexpr int NI = 4;            // n8 tiles of a warp unit

// launch flags (= ops._MK_WEIGHTS_RESIDENT, _MK_BANKS_RESIDENT)
constexpr int WEIGHTS_RESIDENT = 1;
constexpr int BANKS_RESIDENT = 2;

struct Stage {
  const uint32_t* wq;   // (ceil(K / 4), N) words: 4 k bytes of a channel
  const int32_t* thr;   // (S, N) step-major int32
  int k, n, s;
  int nc;               // channel slots of a CTA: 8 * ceil(ceil(N / 8) / C)
  int ns;               // words per k-word row of the staged weights
  int w_off;            // word offset of the resident weights, or -1
  int t_off;            // word offset of the resident bank, or -1
  int f_off;            // word offset of the falls bits
  int wvec;             // weight rows copyable 16 bytes at a time
  int tvec;             // bank rows copyable 16 bytes at a time
};

struct Chain {
  Stage st[MAX_STAGES];
  int n_stages, cluster, block_m;
  int lda[2], a_off[2];  // the two code tiles: row stride, word offset
  int ldc, acc_off;      // the accumulator tile
  int ring_off;          // the streamed weight chunk, or -1
  int vote_off;          // the input's code-range vote
  int xvec;              // bytes per copy of x: 16, 8 or 4
  int ovec;              // out storable 16 bytes at a time
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// words per row of a code tile of `width` codes: at least round_up(width,
// 8), and 16 mod 32, so that the int4 loads of an A fragment (rows g, g + 8
// at k 4t, 16 + 4t) are free of bank conflicts
__host__ __device__ inline int code_stride(int width) {
  const int r8 = round_up(width, 8);
  return r8 <= 16 ? 16 : 16 + round_up(r8 - 16, 32);
}

// words per k-word row of a staged weight slice of `nc` channels: 8 mod
// 32, so that a B fragment's loads (k words t and 4 + t, 8 channels) hit 32
// distinct banks
__host__ __device__ inline int weight_stride(int nc) {
  return round_up(nc, 32) + 8;
}

// cp.async of BYTES (4, 8 or 16) from src to shared dst; !live fills dst
// with zeros and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(live ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(live ? BYTES : 0));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most n committed groups are pending (n < MAX_STAGES)
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Copies k words [q_lo, q_hi) of the packed weights of this CTA's channels
// [c_lo, c_lo + nch) into dst, word (q, n) at (q - q_lo) * ns + n, by
// asynchronous copies of 4 channels (16 bytes) or 1; zeros past K and N.
__device__ void stage_weights(const Stage& s, int c_lo, int nch, int q_lo,
                              int q_hi, uint32_t* dst) {
  const int kq = (s.k + 3) / 4;
  if (s.wvec) {
    const int q4 = nch / 4;
    for (int e = threadIdx.x; e < (q_hi - q_lo) * q4; e += NT) {
      const int r = e / q4, n = 4 * (e - r * q4);
      const bool live = q_lo + r < kq && c_lo + n < s.n;
      cp_async<16>(dst + r * s.ns + n,
                   live ? s.wq + (long long)(q_lo + r) * s.n + c_lo + n
                        : s.wq, live);
    }
  } else {
    for (int e = threadIdx.x; e < (q_hi - q_lo) * nch; e += NT) {
      const int r = e / nch, n = e - r * nch;
      const bool live = q_lo + r < kq && c_lo + n < s.n;
      cp_async<4>(dst + r * s.ns + n,
                  live ? s.wq + (long long)(q_lo + r) * s.n + c_lo + n
                       : s.wq, live);
    }
  }
}

// This CTA's bank slice, step-major (search_steps(S), nc), by asynchronous
// copies of 4 channels (16 bytes) or 1; steps past S are INT32_MAX, slots
// past N are not staged (their channels give code 0).
__device__ void stage_bank(const Stage& s, int c_lo, int nch, int32_t* ts) {
  const int live = min(nch, s.n - c_lo);
  if (s.tvec) {
    const int q = nch / 4;
    for (int e = threadIdx.x; e < s.s * q; e += NT) {
      const int st = e / q, n = 4 * (e - st * q);
      if (n < live)
        cp_async<16>(ts + st * s.nc + n,
                     s.thr + (long long)st * s.n + c_lo + n, true);
    }
  } else {
    for (int e = threadIdx.x; e < s.s * nch; e += NT) {
      const int st = e / nch, n = e - st * nch;
      if (n < live)
        cp_async<4>(ts + st * s.nc + n,
                    s.thr + (long long)st * s.n + c_lo + n, true);
    }
  }
  const int pad = (search_steps(s.s) - s.s) * s.nc;
  for (int e = threadIdx.x; e < pad; e += NT) ts[s.s * s.nc + e] = INT32_MAX;
}

// bit c of falls: channel c_lo + c has a step above the next one. A thread
// takes a run of 8 steps of one channel and the first step of the next run;
// neighbouring threads take neighbouring channels.
__device__ void find_falls(const Stage& s, int c_lo, int nch,
                           const int32_t* ts, unsigned* falls) {
  constexpr int RUN = 8;
  const int live = min(nch, s.n - c_lo);
  const int runs = (s.s - 1 + RUN - 1) / RUN;    // runs of pairs (j, j + 1)
  for (int e = threadIdx.x; e < runs * live; e += NT) {
    const int r = e / live, n = e - r * live;
    const int s0 = r * RUN;
    const int cnt = min(RUN, s.s - 1 - s0);       // pairs in this run
    int32_t v[RUN + 1];
#pragma unroll
    for (int j = 0; j <= RUN; ++j)
      v[j] = j <= cnt
                 ? (ts != nullptr
                        ? ts[(s0 + j) * s.nc + n]
                        : __ldg(s.thr + (long long)(s0 + j) * s.n + c_lo + n))
                 : INT32_MAX;
    bool fall = false;
#pragma unroll
    for (int j = 0; j < RUN; ++j) fall |= j < cnt && v[j] > v[j + 1];
    if (fall) atomicOr(falls + (n >> 5), 1u << (n & 31));
  }
}

// the same over channel n of the bank in global memory: #(a >= T), sorted
// by binary lifting with bounds, falling step by step
__device__ __forceinline__ int count_global(const int32_t* __restrict__ thr,
                                            int N, int n, int S, bool fall,
                                            int32_t a) {
  int cnt = 0;
  if (!fall) {
    for (int step = (search_steps(S) + 1) / 2; step >= 1; step >>= 1) {
      const int i = cnt + step - 1;
      if (i < S && __ldg(thr + (long long)i * N + n) <= a) cnt += step;
    }
    return cnt;
  }
  for (int s = 0; s < S; ++s) cnt += a >= __ldg(thr + (long long)s * N + n);
  return cnt;
}

// The products of k steps [ks_lo, ks_hi) of one stage for this CTA's nt
// tiles: A (rows x lda int32 codes, k < k8 live, rows past `rows` read 0)
// times the staged weights W (word row q = k word q_base + q, ns words a
// row), added into the accumulator tile (ldc). FL is the mma flavour exact
// for every code of the stage's input (threshold_epilogue.cuh); MT m16
// tiles cover the rows. A warp unit is up to NI n8 tiles of every m16 tile
// over a slice of the k steps; each B fragment is loaded once for all m16
// tiles. One instantiation per (MT, FL) keeps the code a launch runs small.
template <int MT, int FL>
__device__ void products(const int32_t* A, int lda, int rows, int k8,
                         const uint32_t* W, int ns, int q_base, int ks_lo,
                         int ks_hi, int nt, int32_t* acc_s, int ldc) {
  constexpr int PLANES = FL == WIDE ? 4 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ng = (nt + NI - 1) / NI;
  const int n_ks = ks_hi - ks_lo;
  if (ng == 0 || n_ks <= 0) return;
  const int ksl = max(1, min(n_ks, NW / ng));
  for (int u = warp; u < ng * ksl; u += NW) {
    const int slice = u % ksl, gi = u / ksl;
    const int tiles = min(NI, nt - gi * NI);
    const int s0 = ks_lo + slice * n_ks / ksl;
    const int s1 = ks_lo + (slice + 1) * n_ks / ksl;
    int32_t acc[MT][NI][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;
    for (int ks = s0; ks < s1; ++ks) {
      const int kb = ks * 32;
      uint32_t b[NI][2];
      const uint32_t* br = W + (kb / 4 - q_base + t) * ns + gi * NI * 8 + g;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        b[ni][0] = ni < tiles ? br[ni * 8] : 0u;
        b[ni][1] = ni < tiles ? br[4 * ns + ni * 8] : 0u;
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r0 = mi * 16 + g, r1 = r0 + 8;
        int4 v[4];  // (r0, 4t), (r1, 4t), (r0, 16 + 4t), (r1, 16 + 4t)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = (q & 1) ? r1 : r0;
          const int k = kb + 16 * (q >> 1) + 4 * t;
          v[q] = (r < rows && k < k8)
                     ? *reinterpret_cast<const int4*>(A + r * lda + k)
                     : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          uint32_t a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = pack_plane(v[q].x, v[q].y, v[q].z, v[q].w, p);
          constexpr bool SGN0 = FL == S8;
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            if (ni >= tiles) continue;
            if (PLANES == 1) {
              mma_k32<SGN0>(acc[mi][ni], a, b[ni]);
            } else {
              int32_t d[4] = {0, 0, 0, 0};
              if (p == 3) mma_k32<true>(d, a, b[ni]);
              else mma_k32<false>(d, a, b[ni]);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[mi][ni][i] = add_shifted(acc[mi][ni][i], d[i], 8 * p);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        if (ni >= tiles) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = mi * 16 + g + 8 * (i >> 1);
          if (r < rows)
            atomicAdd(acc_s + r * ldc + (gi * NI + ni) * 8 + 2 * t + (i & 1),
                      acc[mi][ni][i]);
        }
      }
    }
  }
}

template <int MT>
__device__ __forceinline__ void products_fl(int fl, const int32_t* A,
                                            int lda, int rows, int k8,
                                            const uint32_t* W, int ns,
                                            int q_base, int ks_lo, int ks_hi,
                                            int nt, int32_t* acc_s, int ldc) {
  if (fl == U8)
    products<MT, U8>(A, lda, rows, k8, W, ns, q_base, ks_lo, ks_hi, nt,
                     acc_s, ldc);
  else if (fl == S8)
    products<MT, S8>(A, lda, rows, k8, W, ns, q_base, ks_lo, ks_hi, nt,
                     acc_s, ldc);
  else
    products<MT, WIDE>(A, lda, rows, k8, W, ns, q_base, ks_lo, ks_hi, nt,
                       acc_s, ldc);
}

// products<MT, FL> for the rows' m16 tiles and the stage's flavour
__device__ void run_products(int fl, const int32_t* A, int lda, int rows,
                             int k8, const uint32_t* W, int ns, int q_base,
                             int ks_lo, int ks_hi, int nt, int32_t* acc_s,
                             int ldc) {
  const int mt = (rows + 15) / 16;
  if (mt <= 1)
    products_fl<1>(fl, A, lda, rows, k8, W, ns, q_base, ks_lo, ks_hi, nt,
                   acc_s, ldc);
  else if (mt == 2)
    products_fl<2>(fl, A, lda, rows, k8, W, ns, q_base, ks_lo, ks_hi, nt,
                   acc_s, ldc);
  else
    products_fl<4>(fl, A, lda, rows, k8, W, ns, q_base, ks_lo, ks_hi, nt,
                   acc_s, ldc);
}

__global__ void __launch_bounds__(NT, 1)
mlp_megakernel_kernel(const int32_t* __restrict__ x,
                      int32_t* __restrict__ out, const __grid_constant__ Chain c,
                      int M) {
  extern __shared__ __align__(16) int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = c.cluster, D = c.n_stages;
  const int rank = (int)cluster.block_rank();
  const long long m0 = (long long)(blockIdx.x / C) * c.block_m;
  const int rows = (int)min((long long)c.block_m, (long long)M - m0);
  int32_t* acc_s = smem + c.acc_off;
  unsigned* vote = reinterpret_cast<unsigned*>(smem + c.vote_off);

  // ---- prologue: every copy of the row tile's input and of every stage's
  // resident slices in flight at once, one cp.async group per stage (the
  // input in stage 0's), while the accumulators and flags are zeroed
  {
    const int k0 = c.st[0].k, k8 = round_up(k0, 8);
    int32_t* a0 = smem + c.a_off[0];
    const int per = c.xvec / 4;                  // codes per copy
    const int q = k8 / per;
    for (int e = threadIdx.x; e < rows * q; e += NT) {
      const int r = e / q, k = per * (e - r * q);
      const int32_t* src = k < k0 ? x + (m0 + r) * k0 + k : x;
      int32_t* dst = a0 + r * c.lda[0] + k;
      if (per == 4) cp_async<16>(dst, src, k < k0);
      else if (per == 2) cp_async<8>(dst, src, k < k0);
      else cp_async<4>(dst, src, k < k0);
    }
  }
  for (int d = 0; d < D; ++d) {
    const Stage s = c.st[d];
    const int T = (s.n + 7) / 8;
    const int t_lo = rank * T / C, nt = (rank + 1) * T / C - t_lo;
    if (s.w_off >= 0)
      stage_weights(s, 8 * t_lo, 8 * nt, 0, round_up(s.k, 32) / 4,
                    reinterpret_cast<uint32_t*>(smem + s.w_off));
    if (s.t_off >= 0) stage_bank(s, 8 * t_lo, 8 * nt, smem + s.t_off);
    cp_commit();
  }
  for (int e = threadIdx.x; e < c.block_m * c.ldc; e += NT) acc_s[e] = 0;
  for (int d = 0; d < D; ++d) {
    const int words = (c.st[d].nc + 31) / 32;
    for (int e = threadIdx.x; e < words; e += NT)
      smem[c.st[d].f_off + e] = 0;
  }
  if (threadIdx.x == 0) *vote = 0;
  // every CTA of the cluster is running before any writes a peer's shared
  // memory
  cluster.sync();

  // ---- the stages
  for (int d = 0; d < D; ++d) {
    const Stage s = c.st[d];
    const int T = (s.n + 7) / 8;
    const int t_lo = rank * T / C, nt = (rank + 1) * T / C - t_lo;
    const int c_lo = 8 * t_lo, nch = 8 * nt;
    const int32_t* A = smem + c.a_off[d & 1];
    const int lda = c.lda[d & 1];
    const int k8 = round_up(s.k, 8), n_ks = (s.k + 31) / 32;
    unsigned* falls = reinterpret_cast<unsigned*>(smem + s.f_off);
    const int32_t* ts = s.t_off >= 0 ? smem + s.t_off : nullptr;
    // stage 0's copies have landed and its bank's order is checked (a
    // later stage's inside the cluster barrier before it)
    if (d == 0) {
      cp_wait(D - 1);
      __syncthreads();
      find_falls(s, c_lo, nch, ts, falls);
    }
    // the mma flavour: voted over the run's input tile; a later stage's
    // codes are counts in [0, S] of the stage before
    int fl;
    if (d == 0) {
      unsigned bits = 0;
      const int q = k8 / 4;
      for (int e = threadIdx.x; e < rows * q; e += NT) {
        const int r = e / q;
        const int4 v =
            *reinterpret_cast<const int4*>(A + r * lda + 4 * (e - r * q));
        bits |= code_bits(v.x) | code_bits(v.y) | code_bits(v.z)
                | code_bits(v.w);
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if ((threadIdx.x & 31) == 0 && bits) atomicOr(vote, bits);
      __syncthreads();
      fl = flavour_of(*vote);
    } else {
      fl = flavour_of(code_bits(c.st[d - 1].s));
    }

    if (s.w_off >= 0) {
      run_products(fl, A, lda, rows, k8,
                   reinterpret_cast<const uint32_t*>(smem + s.w_off), s.ns,
                   0, 0, n_ks, nt, acc_s, c.ldc);
    } else {
      uint32_t* ring = reinterpret_cast<uint32_t*>(smem + c.ring_off);
      for (int ks = 0; ks < n_ks; ks += CHUNK_K / 32) {
        const int ks_hi = min(n_ks, ks + CHUNK_K / 32);
        __syncthreads();                   // the previous chunk is used
        stage_weights(s, c_lo, nch, 8 * ks, 8 * ks_hi, ring);
        cp_commit();
        cp_wait(0);
        __syncthreads();
        run_products(fl, A, lda, rows, k8, ring, s.ns, 8 * ks, ks, ks_hi,
                     nt, acc_s, c.ldc);
      }
    }
    __syncthreads();

    // threshold epilogue: a thread per row and 4 channels, channels
    // fastest, their searches interleaved; the 4 codes go to each peer's
    // next code tile in one 16-byte store
    const bool last = d == D - 1;
    const int ld_next = c.lda[(d + 1) & 1];
    unsigned peer[MAX_CLUSTER];
    if (!last) {
      const unsigned next =
          (unsigned)__cvta_generic_to_shared(smem + c.a_off[(d + 1) & 1]);
#pragma unroll
      for (int p = 0; p < MAX_CLUSTER; ++p) {
        peer[p] = 0;
        if (p < C)
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                       : "=r"(peer[p]) : "r"(next), "r"(p));
      }
    }
    const int q4 = nch / 4;
    const int top = (search_steps(s.s) + 1) / 2;
    for (int e = threadIdx.x; e < rows * q4; e += NT) {
      const int r = e / q4, cc = 4 * (e - r * q4);
      const int n = c_lo + cc;
      int32_t a[4];
      int code[4];
      bool fall[4], srch[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = acc_s[r * c.ldc + cc + j];
        acc_s[r * c.ldc + cc + j] = 0;
        fall[j] = (falls[(cc + j) >> 5] >> ((cc + j) & 31)) & 1u;
        srch[j] = n + j < s.n && !fall[j];
        code[j] = 0;
      }
      if (ts != nullptr) {
        for (int step = top; step >= 1; step >>= 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int32_t th = srch[j]
                ? ts[(code[j] + step - 1) * s.nc + cc + j] : INT32_MAX;
            code[j] = th <= a[j] ? code[j] + step : code[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          code[j] = srch[j] ? min(code[j], s.s) : 0;
          if (n + j < s.n && fall[j])
            for (int st = 0; st < s.s; ++st)
              code[j] += a[j] >= ts[st * s.nc + cc + j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < s.n)
            code[j] = count_global(s.thr, s.n, n + j, s.s, fall[j], a[j]);
      }
      if (last) {
        int32_t* o = out + (m0 + r) * s.n + n;
        if (c.ovec && n < s.n) {
          *reinterpret_cast<int4*>(o) =
              make_int4(code[0], code[1], code[2], code[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < s.n) o[j] = code[j];
        }
      } else {
        const unsigned off = 4u * (unsigned)(r * ld_next + n);
#pragma unroll
        for (int p = 0; p < MAX_CLUSTER; ++p)
          if (p < C)
            asm volatile(
                "st.shared::cluster.v4.s32 [%0], {%1, %2, %3, %4};\n"
                :: "r"(peer[p] + off), "r"(code[0]), "r"(code[1]),
                   "r"(code[2]), "r"(code[3]) : "memory");
      }
    }
    // the stage's codes are in every CTA's next code tile once the
    // cluster barrier completes; meanwhile the next stage's copies are
    // waited for and its bank's order checked
    if (!last) {
      cluster_arrive();
      const Stage& sn = c.st[d + 1];
      const int Tn = (sn.n + 7) / 8;
      const int tn_lo = rank * Tn / C, ntn = (rank + 1) * Tn / C - tn_lo;
      cp_wait(D - 2 - d);
      __syncthreads();
      find_falls(sn, 8 * tn_lo, 8 * ntn,
                 sn.t_off >= 0 ? smem + sn.t_off : nullptr,
                 reinterpret_cast<unsigned*>(smem + sn.f_off));
      cluster_wait();
    }
  }
}

// The shared-memory layout of a launch (words), filled into c; the same
// arithmetic as ops.megakernel_layout. Returns its size in bytes.
size_t layout(Chain& c, const int* dims, const int* steps, int flags) {
  const int D = c.n_stages, C = c.cluster, bm = c.block_m;
  int w0 = 0, w1 = 0, max_nt = 0;
  for (int d = 0; d < D; ++d) {
    if (d % 2 == 0) w0 = dims[d] > w0 ? dims[d] : w0;
    else w1 = dims[d] > w1 ? dims[d] : w1;
    const int nt = ((dims[d + 1] + 7) / 8 + C - 1) / C;
    max_nt = nt > max_nt ? nt : max_nt;
  }
  c.lda[0] = code_stride(w0);
  c.lda[1] = D > 1 ? code_stride(w1) : 0;
  c.ldc = round_up(8 * max_nt, 32) + 8;
  long long off = 0;
  auto take = [&](long long words) {
    const long long at = off;
    off += (words + 3) / 4 * 4;
    return (int)at;
  };
  c.a_off[0] = take((long long)bm * c.lda[0]);
  c.a_off[1] = take((long long)bm * c.lda[1]);
  c.acc_off = take((long long)bm * c.ldc);
  c.ring_off = -1;
  for (int d = 0; d < D; ++d) {
    Stage& s = c.st[d];
    s.nc = 8 * (((dims[d + 1] + 7) / 8 + C - 1) / C);
    s.ns = weight_stride(s.nc);
    s.w_off = (flags & WEIGHTS_RESIDENT)
                  ? take((long long)round_up(dims[d], 32) / 4 * s.ns) : -1;
  }
  if (!(flags & WEIGHTS_RESIDENT))
    c.ring_off = take((long long)CHUNK_K / 4 * weight_stride(8 * max_nt));
  for (int d = 0; d < D; ++d) {
    Stage& s = c.st[d];
    s.t_off = (flags & BANKS_RESIDENT)
                  ? take((long long)search_steps(steps[d]) * s.nc) : -1;
  }
  for (int d = 0; d < D; ++d) c.st[d].f_off = take((c.st[d].nc + 31) / 32);
  c.vote_off = take(1);
  return (size_t)off * 4;
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (M, dims[0]) int32 and out
// (M, dims[n_stages]) int32 are contiguous on the device; w[d] points to
// stage d's (dims[d], dims[d+1]) int8 weights and thr[d] to its
// (steps[d], dims[d+1]) int32 step-major bank. `w`, `thr`, `dims` and
// `steps` are host arrays. The host's plan (ops.megakernel_plan) gives the
// cluster size, the row tile, the residency flags and the shared memory it
// priced, which must equal this launcher's layout. The first launch of
// each (cluster, shared memory) asks cudaOccupancyMaxActiveClusters
// whether such a cluster can be scheduled at all and fails with
// cudaErrorInvalidConfiguration if not. The launch goes on `stream`;
// returns the cudaError_t of the launch (cudaErrorInvalidValue for a plan
// this launcher does not take).
extern "C" int mlp_megakernel_launch(const void* x, void* out,
                                     const void* const* w,
                                     const void* const* thr, const int* dims,
                                     const int* steps, int n_stages, int M,
                                     int cluster, int block_m, int flags,
                                     int smem_bytes, void* stream) {
  if (n_stages < 1 || n_stages > MAX_STAGES || M <= 0 || cluster < 1
      || cluster > MAX_CLUSTER || block_m < 1 || block_m > MAX_BLOCK_M)
    return (int)cudaErrorInvalidValue;
  Chain c = {};
  c.n_stages = n_stages;
  c.cluster = cluster;
  c.block_m = block_m;
  c.xvec = dims[0] % 4 == 0 && (uintptr_t)x % 16 == 0   ? 16
           : dims[0] % 2 == 0 && (uintptr_t)x % 8 == 0 ? 8 : 4;
  c.ovec = dims[n_stages] % 4 == 0 && (uintptr_t)out % 16 == 0;
  for (int d = 0; d < n_stages; ++d) {
    Stage& s = c.st[d];
    s.wq = (const uint32_t*)w[d];
    s.thr = (const int32_t*)thr[d];
    s.k = dims[d];
    s.n = dims[d + 1];
    s.s = steps[d];
    if (s.k < 0 || s.n < 0 || s.s < 0) return (int)cudaErrorInvalidValue;
    s.wvec = s.n % 4 == 0 && (uintptr_t)w[d] % 16 == 0;
    s.tvec = s.n % 4 == 0 && (uintptr_t)thr[d] % 16 == 0;
  }
  const size_t bytes = layout(c, dims, steps, flags);
  if (bytes != (size_t)smem_bytes || bytes > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  // lift the 48 KB default ceiling on dynamic shared memory to the block
  // maximum, once (a thread-safe static initialisation)
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      mlp_megakernel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr_err != cudaSuccess) return (int)attr_err;

  const long long clusters = ((long long)M + block_m - 1) / block_m;
  if (clusters * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // can a cluster of this size and shared memory be scheduled? asked once
  // per (cluster, bytes) in the process
  {
    static std::mutex mu;
    static int seen[64][2];
    static int n_seen = 0;
    std::lock_guard<std::mutex> lock(mu);
    bool known = false;
    for (int i = 0; i < n_seen; ++i)
      known |= seen[i][0] == cluster && seen[i][1] == (int)bytes;
    if (!known) {
      int active = 0;
      const cudaError_t err = cudaOccupancyMaxActiveClusters(
          &active, (void*)mlp_megakernel_kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (active < 1) return (int)cudaErrorInvalidConfiguration;
      if (n_seen < 64) {
        seen[n_seen][0] = cluster;
        seen[n_seen][1] = (int)bytes;
        ++n_seen;
      }
    }
  }
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, mlp_megakernel_kernel, (const int32_t*)x, (int32_t*)out, c, M);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `cluster` CTAs with `smem_bytes` of shared memory each that
// the card runs at once (cudaOccupancyMaxActiveClusters), into *active;
// returns the cudaError_t of the query.
extern "C" int mlp_megakernel_max_clusters(int cluster, int smem_bytes,
                                           int* active) {
  const cudaError_t attr = cudaFuncSetAttribute(
      mlp_megakernel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster * 64);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cudaLaunchAttribute attr_c[1];
  attr_c[0].id = cudaLaunchAttributeClusterDimension;
  attr_c[0].val.clusterDim.x = (unsigned)cluster;
  attr_c[0].val.clusterDim.y = 1;
  attr_c[0].val.clusterDim.z = 1;
  cfg.attrs = attr_c;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      active, (void*)mlp_megakernel_kernel, &cfg);
}
