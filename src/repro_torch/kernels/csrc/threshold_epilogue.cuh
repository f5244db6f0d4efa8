// Pieces shared by the fused integer stages threshold_matmul.cu (K1) and
// conv_threshold.cu (K2): int8 tensor-core products on mma.sync fragments,
// the code-range vote that picks their flavour, and the threshold epilogue
// (banks staged step-major in shared memory, searched when sorted).
//
// Fragments. Both kernels tile their output over warps; a warp owns MI x NI
// tiles of mma.sync.m16n8k32 (16 rows x 8 channels, 32 k per step). Lane
// (g = lane / 4, t = lane % 4) holds, per tile, the accumulators of rows g
// and g + 8 at channels 2t and 2t + 1 (acc[i]: row g + 8 * (i / 2),
// channel 2t + i % 2), A words (4 consecutive k bytes) of rows g / g + 8
// at k words t and 4 + t, and B words of channel g at k words t and 4 + t.
//
// Flavours. Codes arrive as int32; the kernels store one byte of each code
// in shared memory and vote over the block's staged codes which byte
// product is exact: .s8.s8 when every code is in [-128, 127] (the first
// layer's signed codes), .u8.s8 when every code is in [0, 255] (inner
// codes, binary codes), otherwise a byte split: the four bytes of each code
// are staged one at a time (a "plane"), bytes 0-2 multiplied as u8, byte 3
// as s8, each plane's products added shifted left by 8 * plane, which is
// the int32 product modulo 2^32, as the CUDA-core loop it replaces gave.
//
// Epilogue. A block stages the banks of its channels step-major, (S, BC)
// int32, comparing each step with the next one of its channel on the way
// in: a channel whose bank falls somewhere gets its bit in `falls` (the
// step-major layout and the check of multi_threshold.cu, K4; here a thread
// loads a run of steps of one channel, so the next step is in its own
// registers). The accumulators go from the mma fragments to a
// shared-memory tile; then each lane counts one channel down the rows:
// sorted channels by branch-free binary lifting, #(T <= a), which for a
// non-decreasing bank equals #(a >= T) with ties, in ceil(log2(S + 1))
// shared-memory reads, all in the lane's own bank; channels that fall
// count all S steps; the counts are stored coalesced along the channels.
// Banks too large for shared memory stream through it LINEAR_CHUNK steps at
// a time and count linearly (the host's plan, kernels/ops.py, picks).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace thr_epi {

constexpr int SMEM_MAX = 232448;       // bytes of shared memory a block may use
constexpr int SMEM_DYN = SMEM_MAX - 1024;  // of which dynamic (static arrays aside)
constexpr int LINEAR_CHUNK = 64;       // bank steps per chunk of the linear path

// flags of a launch
constexpr int FLAG_SEARCH = 1;         // whole banks staged, sorted ones searched
constexpr int FLAG_CORES = 2;          // products by dp4a on the CUDA cores
                                       // (a timing variant; mma.sync otherwise)

enum Flavour { U8 = 0, S8 = 1, WIDE = 2 };

// range bits of a code: 1 negative, 2 above 127, 4 outside [-128, 255]
__device__ __forceinline__ unsigned code_bits(int32_t v) {
  return (v < 0 ? 1u : 0u) | (v > 127 ? 2u : 0u)
         | ((v < -128 || v > 255) ? 4u : 0u);
}

// the flavour exact for every code whose bits were ORed into `bits`
__device__ __forceinline__ int flavour_of(unsigned bits) {
  if ((bits & 4u) || (bits & 3u) == 3u) return WIDE;
  return (bits & 1u) ? S8 : U8;
}

// byte `plane` of four codes, packed little-endian into one word
__device__ __forceinline__ uint32_t pack_plane(int32_t a, int32_t b, int32_t c,
                                               int32_t d, int plane) {
  const int sh = 8 * plane;
  return ((uint32_t)a >> sh & 0xffu) | ((uint32_t)b >> sh & 0xffu) << 8
         | ((uint32_t)c >> sh & 0xffu) << 16 | ((uint32_t)d >> sh) << 24;
}

// four int8 weights packed little-endian into one word
__device__ __forceinline__ uint32_t pack_s8(int8_t a, int8_t b, int8_t c,
                                            int8_t d) {
  return (uint32_t)(uint8_t)a | (uint32_t)(uint8_t)b << 8
         | (uint32_t)(uint8_t)c << 16 | (uint32_t)(uint8_t)d << 24;
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------

// d += A (16 x 32, row) . B (32 x 8, col): A bytes s8 (SGN) or u8, B s8
template <bool SGN>
__device__ __forceinline__ void mma_k32(int32_t (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  if constexpr (SGN) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// c + the dot product of four bytes of a (s8 or u8) with four s8 bytes of b
template <bool SGN>
__device__ __forceinline__ int32_t dp4(uint32_t a, uint32_t b, int32_t c) {
  int32_t d;
  if constexpr (SGN) {
    asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else {
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  }
  return d;
}

// acc += (d << shift), modulo 2^32
__device__ __forceinline__ int32_t add_shifted(int32_t acc, int32_t d,
                                               int shift) {
  return (int32_t)((uint32_t)acc + ((uint32_t)d << shift));
}

// one k-step of 32 on a warp's MI x NI tiles; a plane's products (shift >
// 0) are formed apart and added shifted
template <int MI, int NI, bool SGN>
__device__ __forceinline__ void mma_tiles(int32_t (&acc)[MI][NI][4],
                                          const uint32_t (&a)[MI][4],
                                          const uint32_t (&b)[NI][2],
                                          int shift) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (shift == 0) {
        mma_k32<SGN>(acc[mi][ni], a[mi], b[ni]);
      } else {
        int32_t d[4] = {0, 0, 0, 0};
        mma_k32<SGN>(d, a[mi], b[ni]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mi][ni][i] = add_shifted(acc[mi][ni][i], d[i], shift);
      }
    }
}

// ---------------------------------------------------------------------------
// the threshold epilogue
// ---------------------------------------------------------------------------

// Steps of a whole bank in shared memory: S padded with INT32_MAX to
// 2^(floor(log2 S) + 1) - 1, so that every probe of the binary lifting is
// in range and needs no bounds check (the count is clamped to S after).
__host__ __device__ inline int search_steps(int S) {
  if (S <= 0) return 0;
  int top = 1;
  while (2 * top <= S) top *= 2;
  return 2 * top - 1;
}

// Channels a warp's lanes cover at once in the epilogue: the power of two
// at or above nch, up to 32 (a lane per channel, 32 / lanes_per_row(nch)
// rows per instruction), or BC above 32 (a lane per 32 channels).
__device__ __forceinline__ int lanes_per_row(int nch, int bc) {
  int cp = 1;
  while (cp < nch) cp <<= 1;
  return cp > 32 ? bc : cp;
}

// Stages steps [s0, s0 + steps) of the banks of channels [c0, c0 + nch) of
// thr (C x S, channel-major) into ts[(s - s0) * BC + slot]. With cp =
// lanes_per_row(nch, BC) >= 32 slot j holds channel j; below, the 32 slots
// hold channel j % cp, each bank 32 / cp times over. Either way lane l of
// the epilogue reads slot l (and l + 32, ...), in shared-memory bank l at
// every step, so the search's reads are free of bank conflicts. (BC is a
// multiple of 32.) Neighbouring threads take neighbouring slots, each a
// run of RUN consecutive steps (RUN loads in one 32-byte sector, read once
// from L2), U runs in flight per thread, so the stores are conflict-free
// too. With `falls` (whole banks: s0 = 0, steps = S), each step is compared
// with the next one on the way in (a run loads the first step of the next
// run too), and bit c of falls[c / 32] is set when channel c has a step
// above the next one; falls must be 0 before. A barrier must follow before
// ts or falls are read. 1-D blocks of NT threads.
template <int NT, int BC>
__device__ void stage_banks(const int32_t* __restrict__ thr, int S, int c0,
                            int nch, int s0, int steps, int32_t* ts,
                            unsigned* falls) {
  constexpr int RUN = 8;
  constexpr int U = 2;
  const int cp = lanes_per_row(nch, BC);
  const int slots = cp >= 32 ? nch : 32;
  const int runs = (steps + RUN - 1) / RUN;
  const int total = slots * runs;
  for (int e0 = threadIdx.x; e0 < total; e0 += NT * U) {
    int32_t v[U][RUN + 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      const int run = e / slots, slot = e - run * slots;
      const int cc = cp >= 32 ? slot : slot % cp;
      const int sr = run * RUN;
      const bool in = e < total && cc < nch;
      const int n = in ? min(RUN, steps - sr) : 0;
      const int32_t* src = thr + (long long)(c0 + cc) * S + s0 + sr;
#pragma unroll
      for (int j = 0; j <= RUN; ++j)
        v[u][j] = (j < n || (falls != nullptr && in && j == n
                             && sr + j < steps))
                      ? __ldg(src + j) : INT32_MAX;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      const int run = e / slots, slot = e - run * slots;
      const int cc = cp >= 32 ? slot : slot % cp;
      const int sr = run * RUN;
      if (e >= total || cc >= nch) continue;
      const int n = min(RUN, steps - sr);
      bool fall = false;
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        if (j < n) ts[(sr + j) * BC + slot] = v[u][j];
        fall |= j < n && sr + j + 1 < steps && v[u][j] > v[u][j + 1];
      }
      if (falls != nullptr && fall && slot == cc)
        atomicOr(falls + (cc >> 5), 1u << (cc & 31));
    }
  }
}

// Fills steps [S, search_steps(S)) of the whole banks in ts with INT32_MAX
// (every slot). A barrier must follow before ts is read.
template <int NT, int BC>
__device__ __forceinline__ void pad_banks(int S, int32_t* ts) {
  const int total = (search_steps(S) - S) * BC;
  for (int e = threadIdx.x; e < total; e += NT) ts[S * BC + e] = INT32_MAX;
}

// A warp's accumulator fragments into the block's tile at `at`, row stride
// LDA (odd: a column's rows spread over the banks); row0 and col0 are the
// warp's first row and channel in the tile.
template <int LDA, int MI, int NI>
__device__ __forceinline__ void fragments_to_tile(
    const int32_t (&acc)[MI][NI][4], int32_t* at, int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        at[(row0 + mi * 16 + g + 8 * (i >> 1)) * LDA + col0 + ni * 8
           + 2 * t + (i & 1)] = acc[mi][ni][i];
}

// Counts the tile's accumulators (rows x nch at `at`, row stride LDA)
// against the banks of the block's channels [c0, c0 + nch) and stores the
// counts to out[orow(r) * ldo + c0 + c] (orow(r) < 0: a row past the
// output). Lane l takes channel l % cp of row l / cp of each group of
// 32 / cp rows (cp = lanes_per_row(nch, BC); above 32 channels, channels
// l, l + 32, ... of one row), so no lane idles on a narrow stage, the
// stores are coalesced along the channels, and the bank reads (slot l of
// stage_banks, bank l) are free of bank conflicts; the warps share the row
// groups, R rows in flight per lane.
//   search: the banks are in ts whole (padded to search_steps(S) steps),
//     with `falls`; a sorted channel counts by branch-free binary lifting,
//     #(T <= a), in ceil(log2(S + 1)) reads, clamped to S (an INT32_MAX
//     accumulator reaches the padding too), a falling one step by step.
//   otherwise every bank streams through ts LINEAR_CHUNK steps at a time
//     and counts step by step; every thread of the block must call this
//     (it holds barriers), and ts holds LINEAR_CHUNK * BC words.
// A barrier must come between fragments_to_tile and this, and after it
// before `at` is written again.
template <int NT, int BC, int LDA, int ROWS, typename RowFn>
__device__ void count_tile(const int32_t* at, int rows, bool search,
                           const int32_t* __restrict__ thr, int S, int c0,
                           int nch, int32_t* ts, const unsigned* falls,
                           int32_t* __restrict__ out, int ldo, RowFn orow) {
  constexpr int NW = NT / 32;
  constexpr int CQ = BC / 32;                  // channels per lane, at most
  constexpr int RP = (ROWS + NW - 1) / NW;     // rows per lane, at most
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cp = lanes_per_row(nch, BC);
  const int rpi = cp >= 32 ? 1 : 32 / cp;      // rows per warp instruction
  const int nq = cp >= 32 ? cp / 32 : 1;
  const int rsub = cp >= 32 ? 0 : lane / cp;
  const int rstride = NW * rpi;                // rows between a lane's rows
  if (search) {
    constexpr int R = RP < 8 ? RP : 8;         // searches in flight
    // probe offsets in bytes: step k of the lifting reads
    // tb[(cnt + 2^k) * BC] = T[cnt + 2^k - 1]
    constexpr int ROW = BC * 4;
    const int top_b = (search_steps(S) + 1) / 2 * ROW;
    for (int q = 0; q < nq; ++q) {
      const int slot = q * 32 + lane;
      const int col = cp >= 32 ? slot : lane % cp;
      const bool live = col < nch;
      const bool fall = live && ((falls[col >> 5] >> (col & 31)) & 1u);
      const int32_t* tc = ts + slot;
      const char* tb = reinterpret_cast<const char*>(tc - BC);
      for (int r0 = warp * rpi + rsub; r0 < rows; r0 += rstride * R) {
        int32_t a[R];
        int cnt[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int r = r0 + u * rstride;
          a[u] = r < rows ? at[r * LDA + col] : 0;
          cnt[u] = 0;
        }
        if (!fall) {
          // cnt in bytes (cnt * ROW) until the end: one add, one load,
          // one compare and one select a probe
          for (int step = top_b; step >= ROW; step >>= 1) {
#pragma unroll
            for (int u = 0; u < R; ++u) {
              const int32_t th =
                  *reinterpret_cast<const int32_t*>(tb + cnt[u] + step);
              cnt[u] = th <= a[u] ? cnt[u] + step : cnt[u];
            }
          }
#pragma unroll
          for (int u = 0; u < R; ++u) cnt[u] = min(cnt[u] / ROW, S);
        } else {
          for (int s = 0; s < S; ++s) {
            const int32_t th = tc[s * BC];
#pragma unroll
            for (int u = 0; u < R; ++u) cnt[u] += a[u] >= th;
          }
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int r = r0 + u * rstride;
          if (r < rows && live) {
            const long long o = orow(r);
            if (o >= 0) out[o * ldo + c0 + col] = cnt[u];
          }
        }
      }
    }
  } else {
    int32_t a[CQ][RP];
    int cnt[CQ][RP];
#pragma unroll
    for (int q = 0; q < CQ; ++q)
#pragma unroll
      for (int u = 0; u < RP; ++u) {
        const int r = warp * rpi + rsub + u * rstride;
        const int col = cp >= 32 ? q * 32 + lane : lane % cp;
        a[q][u] = (q < nq && r < rows) ? at[r * LDA + col] : 0;
        cnt[q][u] = 0;
      }
    for (int s0 = 0; s0 < S; s0 += LINEAR_CHUNK) {
      const int steps = min(LINEAR_CHUNK, S - s0);
      __syncthreads();                    // the previous chunk is counted
      stage_banks<NT, BC>(thr, S, c0, nch, s0, steps, ts, nullptr);
      __syncthreads();
      for (int s = 0; s < steps; ++s) {
#pragma unroll
        for (int q = 0; q < CQ; ++q) {
          const int32_t th = ts[s * BC + q * 32 + lane];
#pragma unroll
          for (int u = 0; u < RP; ++u) cnt[q][u] += a[q][u] >= th;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CQ; ++q)
#pragma unroll
      for (int u = 0; u < RP; ++u) {
        const int r = warp * rpi + rsub + u * rstride;
        const int col = cp >= 32 ? q * 32 + lane : lane % cp;
        if (q < nq && r < rows && col < nch) {
          const long long o = orow(r);
          if (o >= 0) out[o * ldo + c0 + col] = cnt[q][u];
        }
      }
  }
}

// Sets `kernel`'s dynamic shared-memory limit to SMEM_DYN and its carveout
// to the most shared memory once, so that launches above 48 KB are accepted
// and blocks are not held back by the L1 share.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
  // the largest shared-memory carveout, so that as many blocks as their
  // shared memory allows are resident on an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace thr_epi
