// The LU engine's eta ring applied in one launch per pass, for Hopper
// (sm_90a): FTRAN through the live product-form etas, and BTRAN of one
// vector or of two at once.
//
// Replaces no Pallas kernel.  The JAX package applies the ring with two
// lax.fori_loops, relp_tpu/simplex/lu.py:77 (_apply_etas_ftran) and :98
// (_apply_etas_btran), which XLA compiles into one device loop inside the
// jitted lu_run_chunk.  The port's plain versions (relp_tpu_torch/ops/
// eta_ring.py) launch several torch ops per slot; these kernels are one
// launch per pass, and read the live count on the device, so a captured
// chunk does not depend on the ring's fill at entry.
//
// The ring holds K slots: slot k is the eta (w_k, r_k), w_k a row of the
// row-major (K, M) eta_vals, r_k = eta_rows[k]; n = min(max(eta_count, 0), K)
// slots are live.
//
//   FTRAN, k = 0 .. n-1:      f = x[r] / w[r];  x <- x - f w;  x[r] <- f
//   BTRAN, k = n-1 .. 0:      y[r] <- y[r] - (y.w - y[r]) / w[r]
//
// What bounds it: the live ring is n M sizeof(T) bytes (0.46 MB at K = 60,
// M = 1920, f32), about 0.14 us at 3.35 TB/s, and 2 n M operations.  What
// really bounds it is the chain of n dependent slots.  A pass that makes
// the whole vector wait on each slot pays a round trip to L2 and a block's
// barrier per slot (csrc/slot_chain.cu times that chain alone).  These
// kernels take the chain off the vector: it runs on n scalars in one warp
// (under 0.1 us a slot), and the vector is one parallel pass over the ring.
// On an H100 at 59 live slots, M = 1,920, f32: FTRAN about 9 us, the BTRAN
// pair about 12 us, against 17 and 2 x 29 us for the slot chain alone
// (relp_tpu_torch/tools/eta_ring_timing.py).
//
// FTRAN (eta_ftran_kernel).  The factor f_k = x[r_k] / w_k[r_k] depends only
// on the values x takes at the live rows, so:
//   * Gather: the rows r_k, and the block G[k][j] = w_k[r_j] (k <= j, the
//     diagonal holds the pivots) and x0[r_j] into shared memory.  These
//     reads are scattered, one sector each: a cluster of kCluster blocks
//     shares them, each block reading a kCluster-th of G's rows and storing
//     them into every block of the cluster (distributed shared memory), then
//     one cluster barrier.  A block stores into another's shared memory only
//     once every block of the cluster has started, as the programming model
//     requires: each block arrives at the cluster's barrier (relaxed) after
//     its first loads and waits on it just before its first remote store,
//     so the barrier's round trip overlaps those loads.
//   * Chain: one warp, lane l holding the running values u_j of x[r_j]
//     for j = l and l + 32; step k: f_k = u_k / G[k][k] (on u_k's lane, then
//     a shuffle), and every later u_j <- u_j - f_k G[k][j], or f_k where
//     r_j = r_k: the plain loop's own rule, at the live rows.  Only u_k's
//     lane divides u_k: a lane whose operand is 0 or stale would take the
//     IEEE division's slow path, and the warp would wait for it every step.
//   * Pass: every element i runs x_i <- x_i - f_k w_k[i], or f_k where
//     i = r_k, for k in slot order.  The elements are independent: blocks
//     of kFtranThreads elements, one thread an element, the slots' rows of
//     the block's elements copied into shared memory (cp.async) while the
//     chain runs.
//   * One launch, no grid-wide barrier: every block computes the chain
//     itself.  Each gets the same bits from the same inputs, and the chain
//     is a few microseconds of one warp; one block computing the factors
//     for its cluster would add a second cluster barrier, after the chain,
//     to every block's path.
//   * Every operation is rounded on its own (__fmul_rn, __fsub_rn,
//     __fdiv_rn; no FMA contraction), as the plain version's separate torch
//     kernels do, so every element sees the plain loop's operations in its
//     order: the kernel gives eta_ftran_plain's bits, with repeated rows and
//     with a zero pivot's inf and NaN.
//
// BTRAN (eta_btran_kernel; one vector, or two that read the same ring, as
// the LU pivot's rho and Goldfarb BTRANs do).  Only the entries y[r_k]
// change.  With R the live rows, each dot splits into
//     y.w_k = S_k + sum over the rows rho in R of y_cur[rho] w_k[rho],
// S_k the products over the rows outside R, which never change:
//   * S: one parallel pass over the ring by one cluster of kCluster blocks.
//     The elements form tiles of kTile = 256; in a tile, lane l of a warp
//     adds the rounded products of elements l, l + 32, ... (8 of them) in
//     order from +0, the 32 lanes are added by a halving tree (lane l and
//     lane l + 16, then 8, 4, 2, 1), and S_k adds the tiles' sums in tile
//     order, from tile 0.  An element in R enters with y = 0 (its product
//     0 w_k[i], a signed zero that changes no sum).  No atomics: the
//     tiles' sums go to a scratch array in device memory (part), the
//     cluster's barrier publishes them, and block 0 reads them from L2.
//   * The chain, slot k = n-1 .. 0, one warp per vector: the accumulator
//     A_k starts at S_k + y0[r_j] G[k][j] over j = 0 .. k in order, taking
//     each row's last live slot only (its value is still y0 at step k); at
//     step j, y_new = y_cur - (A_j - y_cur) / G[j][j], and every A_k, k < j,
//     adds y_new G[k][j] where slot j holds row r_j's value at step k (no
//     slot between k and j on that row).  So dot_k is S_k, then the rows
//     still at y0 in slot order, then the rows that changed, newest slot
//     first, one term per row.  The plain version's ordered twin
//     (eta_btran_plain(..., order="kernel")) sums in this order, and the
//     kernel gives its bits.
//   * Every block writes its tiles' entries outside R; block 0 of the
//     cluster runs the chain and writes the entries in R.  G goes into block
//     0 through distributed shared memory, after the same start barrier as
//     in FTRAN.
//
// Large rings.  The chain holds kGroup = 64 slots in a warp's registers
// (two a lane) and G for those 64 slots in shared memory.  A ring of more
// slots (refactor_period is a user setting, 60 by default) runs its chain
// in groups of 64: a group starts from the values the earlier groups left,
// computed with the ring's entries read from L2, and G is gathered again
// for each group.  Shared memory then grows with K by about 12 bytes a slot
// (FTRAN, f64) and 68 (a BTRAN pair, f64): the card's 227 KB hold K up to
// about 10,000 and 2,800; a larger K fails to launch, and the wrapper
// raises.
//
// A live slot's row outside [0, M) traps (a CUDA error at the next
// synchronisation), as an out-of-range index does in torch.
//
// C interface, loaded with ctypes; every entry returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 64;             // slots of one chain group: eta_ring.CHAIN_SLOTS
constexpr int kStride = kGroup + 1;    // G's row stride: rows and columns read without bank conflicts
constexpr int kFtranThreads = 128;     // FTRAN: a block's elements
constexpr int kBtranThreads = 512;     // BTRAN: 16 warps
constexpr int kBtranWarps = kBtranThreads / 32;
constexpr int kCluster = 8;            // blocks of a cluster (BTRAN: its one cluster)
constexpr int kTileRows = 8;           // eta_ring.TILE_ROWS
constexpr int kTile = 32 * kTileRows;  // eta_ring.TILE
constexpr int kSlotsPerWarp = 4;       // S pass: slots a warp loads at once
constexpr int kFtranWarps = kFtranThreads / 32;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ int live_slots(const int* count, int K) {
  const int n = *count;
  return n < 0 ? 0 : (n > K ? K : n);
}

__device__ __forceinline__ int checked_row(int r, int M) {
  if (r < 0 || r >= M) __trap();
  return r;
}

// The cluster's barrier split in two, ordering no memory: every block
// arrives once it has started (after its first loads) and waits just before
// its first store into another block's shared memory, which is allowed only
// once every block of the cluster is running.  Each arrival is matched by a
// wait before the cluster's next barrier.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The live rows into shared memory.  Every slot's row is read, so the
// loads do not wait for the count; a live one outside [0, M) traps.
__device__ __forceinline__ void load_rows(const int* __restrict__ rows, int K, int n, int M,
                                          int* rows_s, int nthreads) {
  for (int k = threadIdx.x; k < K; k += nthreads) {
    const int r = rows[k];
    rows_s[k] = k < n ? checked_row(r, M) : r;
  }
}

// Group [g0, g0 + gn)'s block G[kk][jj] = w_{g0+kk}[r_{g0+jj}] by one
// block: rows kk = warp, warp + warps, ..., two columns jj = lane, lane + 32
// a thread, every load in flight before the first store.
template <typename T, int kWarps>
__device__ __forceinline__ void gather_block(const T* __restrict__ vals, int M,
                                             const int* rows_s, T* G_s, int g0, int gn) {
  constexpr int kRows = kGroup / kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T v[kRows][2];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int kk = warp + kWarps * q;
      const int jj = lane + 32 * m;
      v[q][m] = kk < gn && jj < gn ? vals[static_cast<size_t>(g0 + kk) * M + rows_s[g0 + jj]]
                                   : T(0);
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int kk = warp + kWarps * q;
      const int jj = lane + 32 * m;
      if (kk < gn && jj < gn) G_s[kk * kStride + jj] = v[q][m];
    }
  }
}

// The newest group's G gathered by a whole cluster: its block of rank c
// loads rows kk = c, c + kCluster, ... (those where keep(kk, jj)), each
// thread's entries in flight at once, and stores them into G_s of every
// block (to_all) or of block 0, through distributed shared memory; with
// wait_start, the start barrier's wait (cluster_wait) comes between the
// loads and the stores.  The cluster's next barrier publishes them; each
// block's share of the scattered reads is a kCluster-th of the block's.
template <typename T, int kThreads, typename Keep>
__device__ __forceinline__ void gather_block_cluster(cg::cluster_group& cluster,
                                                     const T* __restrict__ vals, int M,
                                                     const int* rows_s, T* G_s, int g0,
                                                     int gn, bool to_all, bool wait_start,
                                                     Keep keep) {
  constexpr int kPer = kGroup * kGroup / kCluster / kThreads;
  static_assert(kPer * kCluster * kThreads == kGroup * kGroup, "an entry for every thread");
  const int rank = static_cast<int>(cluster.block_rank());
  T v[kPer];
  int dst[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = threadIdx.x + kThreads * p;
    const int kk = rank + kCluster * (e / kGroup);
    const int jj = e % kGroup;
    const bool used = kk < gn && jj < gn && keep(kk, jj);
    v[p] = used ? vals[static_cast<size_t>(g0 + kk) * M + rows_s[g0 + jj]] : T(0);
    dst[p] = used ? kk * kStride + jj : -1;
  }
  if (wait_start) cluster_wait();
  for (int d = 0; d < (to_all ? kCluster : 1); ++d) {
    T* target = cluster.map_shared_rank(G_s, d);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (dst[p] >= 0) target[dst[p]] = v[p];
    }
  }
}

// ---------------------------------------------------------------- FTRAN --

// Shared memory of a FTRAN block: the factors f (K of T), G with the x0
// row under it ((kGroup + 1) rows of kStride), the slab of the block's
// elements (ts slots of kFtranThreads), then the rows (K ints).
template <typename T>
size_t ftran_smem(int K, int ts) {
  return static_cast<size_t>(K) * sizeof(T) +
         static_cast<size_t>(kGroup + 1) * kStride * sizeof(T) +
         static_cast<size_t>(ts) * kFtranThreads * sizeof(T) +
         static_cast<size_t>(K) * sizeof(int);
}

// Slots [k0, k0 + kn) of element i into this thread's column of the slab.
template <typename T>
__device__ __forceinline__ void stage_slab(const T* vals, int M, int i, int k0, int kn,
                                           T* slab) {
  for (int kk = 0; kk < kn; ++kk) {
    __pipeline_memcpy_async(slab + kk * kFtranThreads + threadIdx.x,
                            vals + static_cast<size_t>(k0 + kk) * M + i, sizeof(T));
  }
  __pipeline_commit();
}

// The chain of group [g0, g0 + gn) in one warp: f_s[k] for its slots.  A
// step's operands from shared memory (the pivot, r_k, row k of G at the
// lane's two slots) are loaded a step ahead, nothing is stored until the
// loop ends and nothing branches but the division's own slow path, so a
// step waits only on its arithmetic: the division on u_k's lane, the
// shuffle, and each later u_j's multiply and subtract.  Slot k's lane
// keeps f_k where u_k was.
template <typename T>
__device__ void ftran_chain(const T* __restrict__ vals, int M, const int* rows_s, T* f_s,
                            const T* G_s, int g0, int gn, int lane) {
  T u[2];
  int r_own[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int jj = lane + 32 * m;
    u[m] = T(0);
    r_own[m] = -1;
    if (jj < gn) {
      const int r = rows_s[g0 + jj];
      T v = G_s[kGroup * kStride + jj];  // x0[r], gathered with G
      // The earlier groups' slots, as the pass applies them to element r.
      for (int k = 0; k < g0; ++k) {
        v = rows_s[k] == r ? f_s[k]
                           : sub_rn(v, mul_rn(f_s[k], vals[static_cast<size_t>(k) * M + r]));
      }
      u[m] = v;
      r_own[m] = r;
    }
  }
  T piv = G_s[0];
  int rk = rows_s[g0];
  T g[2] = {G_s[lane], G_s[lane + 32]};
  for (int kk = 0; kk < gn; ++kk) {
    const int next = kk + 1 < gn ? kk + 1 : kk;
    const T piv_next = G_s[next * kStride + next];
    const int rk_next = rows_s[g0 + next];
    const T g_next[2] = {G_s[next * kStride + lane], G_s[next * kStride + lane + 32]};
    // Only u_k's lane divides u_k; the others divide the pivot by itself,
    // so that no lane takes the division's slow path on a stale value.
    const bool owner = lane == (kk & 31);
    T f = div_rn(owner ? (kk < 32 ? u[0] : u[1]) : piv, piv);
    f = __shfl_sync(0xffffffffu, f, kk & 31);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int jj = lane + 32 * m;
      const T later = r_own[m] == rk ? f : sub_rn(u[m], mul_rn(f, g[m]));
      u[m] = jj == kk ? f : (jj > kk && jj < gn ? later : u[m]);
    }
    piv = piv_next;
    rk = rk_next;
    g[0] = g_next[0];
    g[1] = g_next[1];
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (lane + 32 * m < gn) f_s[g0 + lane + 32 * m] = u[m];
  }
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kFtranThreads)
    eta_ftran_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
                     const int* __restrict__ count, const T* __restrict__ x,
                     T* __restrict__ out, int K, int M, int ts) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* f_s = reinterpret_cast<T*>(smem);
  T* G_s = f_s + K;
  T* slab = G_s + (kGroup + 1) * kStride;
  int* rows_s = reinterpret_cast<int*>(slab + static_cast<size_t>(ts) * kFtranThreads);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int n = live_slots(count, K);
  const int first = blockIdx.x * kFtranThreads + tid;  // this thread's first element
  load_rows(rows, K, n, M, rows_s, kFtranThreads);  // in flight with the count
  if (first < M && n > 0) stage_slab(vals, M, first, 0, n < ts ? n : ts, slab);
  cluster_arrive_relaxed();  // started; the first group's gather waits
  __syncthreads();

  for (int g0 = 0; g0 < n; g0 += kGroup) {
    const int gn = n - g0 < kGroup ? n - g0 : kGroup;
    // G's upper triangle (kk <= jj; the diagonal holds the pivots), and
    // x0[r_{g0+jj}] in row kGroup.
    const T x0 = tid < gn ? x[rows_s[g0 + tid]] : T(0);
    gather_block_cluster<T, kFtranThreads>(cluster, vals, M, rows_s, G_s, g0, gn, true,
                                           g0 == 0, [](int kk, int jj) { return kk <= jj; });
    if (tid < gn) G_s[kGroup * kStride + tid] = x0;
    cluster.sync();  // every block's G complete; no block reads another's after this
    if (tid < 32) ftran_chain(vals, M, rows_s, f_s, G_s, g0, gn, tid);
    // The next group's G goes into every block: every chain must be done.
    if (g0 + kGroup < n) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  }
  if (n == 0) cluster_wait();  // no gather waited

  // The pass, element by element, the slots in order.
  for (int tile = blockIdx.x; tile * kFtranThreads < M; tile += gridDim.x) {
    const int i = tile * kFtranThreads + tid;
    if (i >= M) break;
    T v = x[i];
    for (int k0 = 0; k0 < n; k0 += ts) {
      const int kn = n - k0 < ts ? n - k0 : ts;
      if (tile != static_cast<int>(blockIdx.x) || k0 != 0) stage_slab(vals, M, i, k0, kn, slab);
      __pipeline_wait_prior(0);
      for (int kk = 0; kk < kn; ++kk) {
        const int k = k0 + kk;
        const T f = f_s[k];
        v = i == rows_s[k] ? f : sub_rn(v, mul_rn(f, slab[kk * kFtranThreads + tid]));
      }
    }
    out[i] = v;
  }
}

// ---------------------------------------------------------------- BTRAN --

// One vector of a BTRAN launch.
template <typename T>
struct BtranVector {
  const int* count;
  const T* y;
  T* out;
};

// Shared memory of a BTRAN block for kVecs vectors: S, y0 at the live rows
// and the new values (kVecs K of T each), the group's starting accumulators
// (kVecs kGroup of T), G (kGroup rows of kStride), the tile of y with the
// live rows at 0 (kVecs kTile of T), then the rows and the previous and the
// next slot on each row (K ints each).
template <typename T>
size_t btran_smem(int K, int vecs) {
  return static_cast<size_t>(3 * vecs) * K * sizeof(T) +
         static_cast<size_t>(vecs) * kGroup * sizeof(T) +
         static_cast<size_t>(kGroup) * kStride * sizeof(T) +
         static_cast<size_t>(vecs) * kTile * sizeof(T) + static_cast<size_t>(3) * K * sizeof(int);
}

// The chain of vector v over its live slots in group [g0, g0 + gn), newest
// first, in one warp; A_s holds each slot's accumulator with every term
// from outside the group.  As in ftran_chain, a step's operands (the
// pivot, the slot before r_j, column j of G at the lane's two slots) are
// loaded a step ahead, only the division branches, and the new values are
// stored after the loop; slot j's lane keeps y_new_j where y_cur was.
template <typename T>
__device__ void btran_chain(const int* rows_s, const int* prv_s, const int* nxt_s,
                            const T* G_s, const T* A_s, const T* y0r_s, T* ynew_s,
                            T* __restrict__ out, int nv, int g0, int gn, int lane) {
  T A[2], yc[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int kk = lane + 32 * m;
    A[m] = T(0);
    yc[m] = T(0);
    if (kk < gn) {
      const int k = g0 + kk;
      A[m] = A_s[kk];
      // Row r_k's value at step k: y0 unless a later live slot holds it.
      const int nx = nxt_s[k];
      yc[m] = nx >= nv ? y0r_s[k] : (nx >= g0 + gn ? ynew_s[nx] : T(0));
    }
  }
  int jj = gn - 1;
  T piv = G_s[jj * kStride + jj];
  int pj = prv_s[g0 + jj];
  T g[2] = {G_s[lane * kStride + jj], G_s[(lane + 32) * kStride + jj]};
  for (; jj >= 0; --jj) {
    const int next = jj > 0 ? jj - 1 : 0;
    const T piv_next = G_s[next * kStride + next];
    const int pj_next = prv_s[g0 + next];
    const T g_next[2] = {G_s[lane * kStride + next], G_s[(lane + 32) * kStride + next]};
    const bool owner = lane == (jj & 31);  // only y_j's lane divides, as in ftran_chain
    const T a = jj < 32 ? A[0] : A[1];
    const T c = jj < 32 ? yc[0] : yc[1];
    T yn = sub_rn(c, div_rn(owner ? sub_rn(a, c) : piv, piv));
    yn = __shfl_sync(0xffffffffu, yn, jj & 31);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int kk = lane + 32 * m;
      const int k = g0 + kk;
      const bool earlier = kk < jj;
      A[m] = earlier && pj <= k ? add_rn(A[m], mul_rn(yn, g[m])) : A[m];
      yc[m] = kk == jj || (earlier && pj == k) ? yn : yc[m];
    }
    piv = piv_next;
    pj = pj_next;
    g[0] = g_next[0];
    g[1] = g_next[1];
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int k = g0 + lane + 32 * m;
    if (lane + 32 * m < gn) {
      ynew_s[k] = yc[m];
      if (prv_s[k] < 0) out[rows_s[k]] = yc[m];  // the row's first live slot: its final value
    }
  }
}

// S's operands for this warp: slots k0, k0 + 16, ... (kSlotsPerWarp of
// them, below limit) at the lane's elements of the tile at base.
template <typename T>
__device__ __forceinline__ void load_slots(const T* __restrict__ vals, int M, int base,
                                           int k0, int limit,
                                           T (&w)[kSlotsPerWarp][kTileRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kSlotsPerWarp; ++q) {
    const int k = k0 + q * kBtranWarps;
#pragma unroll
    for (int m = 0; m < kTileRows; ++m) {
      const int i = base + lane + 32 * m;
      w[q][m] = k < limit && i < M ? vals[static_cast<size_t>(k) * M + i] : T(0);
    }
  }
}

// The tile at base's y of each vector at this thread's element.
template <typename T, int kVecs>
__device__ __forceinline__ void load_tile(const BtranVector<T> (&vec)[2], int M, int base,
                                          T (&yt)[kVecs]) {
  const int i = base + static_cast<int>(threadIdx.x);
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    yt[v] = threadIdx.x < kTile && i < M ? vec[v].y[i] : T(0);
  }
}

template <typename T, int kVecs>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kBtranThreads)
    eta_btran_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
                     BtranVector<T> va, BtranVector<T> vb, T* __restrict__ part, int K,
                     int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* S_s = reinterpret_cast<T*>(smem);
  T* y0r_s = S_s + kVecs * K;
  T* ynew_s = y0r_s + kVecs * K;
  T* A_s = ynew_s + kVecs * K;
  T* G_s = A_s + kVecs * kGroup;
  T* ys_s = G_s + kGroup * kStride;
  int* rows_s = reinterpret_cast<int*>(ys_s + kVecs * kTile);
  int* prv_s = rows_s + K;
  int* nxt_s = prv_s + K;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool chain_block = rank == 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const BtranVector<T> vec[2] = {va, vb};  // indexed by unrolled loops only
  const int nv[2] = {live_slots(va.count, K), kVecs > 1 ? live_slots(vb.count, K) : 0};
  const int n = nv[0] > nv[1] ? nv[0] : nv[1];
  const int tiles = (M + kTile - 1) / kTile;

  // S's operands, the block's first tile loaded with the rows, before
  // anything waits on the count.
  static_assert(kTile <= kBtranThreads, "a thread an element of the tile");
  T w[kSlotsPerWarp][kTileRows];
  T yt[kVecs];
  if (rank < tiles) {
    load_slots(vals, M, rank * kTile, warp, K, w);
    load_tile<T, kVecs>(vec, M, rank * kTile, yt);
  }
  load_rows(rows, K, n, M, rows_s, kBtranThreads);
  cluster_arrive_relaxed();  // started; the gather waits
  __syncthreads();

  // Block 0's slot tables: each slot's neighbours on its row and y0 at its
  // row; and the newest group's G into block 0, by the whole cluster.  All
  // in flight while the S pass runs.
  const int groups = (n + kGroup - 1) / kGroup;
  T y0[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    y0[v] = chain_block && tid < n ? vec[v].y[rows_s[tid]] : T(0);
  }
  if (groups > 0) {
    const int g0 = (groups - 1) * kGroup;
    gather_block_cluster<T, kBtranThreads>(cluster, vals, M, rows_s, G_s, g0, n - g0, false,
                                           true, [](int, int) { return true; });
  } else {
    cluster_wait();
  }
  if (chain_block) {
    for (int j = tid; j < n; j += kBtranThreads) {
      const int r = rows_s[j];
      int p = -1;
      int nx = K;
#pragma unroll 8
      for (int q = n - 1; q >= 0; --q) {  // no early exit: the loads stream
        const bool same = rows_s[q] == r;
        p = same && q < j && p < 0 ? q : p;
        nx = same && q > j ? q : nx;
      }
      prv_s[j] = p;
      nxt_s[j] = nx;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) y0r_s[v * K + j] = j == tid ? y0[v] : vec[v].y[r];
    }
  }

  // S: the tiles of this block, its warps taking kSlotsPerWarp slots at a
  // time.
  for (int t = rank; t < tiles; t += kCluster) {
    const int base = t * kTile;
    if (t != rank) {
      load_slots(vals, M, base, warp, K, w);
      load_tile<T, kVecs>(vec, M, base, yt);
    }
    if (tid < kTile) {
      const int i = base + tid;
      int f = INT_MAX;
#pragma unroll 8
      for (int j = n - 1; j >= 0; --j) f = rows_s[j] == i ? j : f;  // no early exit
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const bool unchanged = f >= nv[v];  // not a live row of vector v
        ys_s[v * kTile + tid] = unchanged ? yt[v] : T(0);
        if (i < M && unchanged) vec[v].out[i] = yt[v];
      }
    }
    __syncthreads();
    for (int k0 = warp; k0 < n; k0 += kSlotsPerWarp * kBtranWarps) {
      if (k0 != warp) load_slots(vals, M, base, k0, n, w);
      // Every tree first, the stores after: no divergent store between
      // two trees' shuffles, so the trees interleave.
      T s[kSlotsPerWarp][kVecs];
#pragma unroll
      for (int q = 0; q < kSlotsPerWarp; ++q) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          s[q][v] = T(0);
#pragma unroll
          for (int m = 0; m < kTileRows; ++m) {
            const int e = lane + 32 * m;
            if (base + e < M) {
              s[q][v] = add_rn(s[q][v], mul_rn(ys_s[v * kTile + e], w[q][m]));
            }
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < kSlotsPerWarp; ++q) {
#pragma unroll
          for (int v = 0; v < kVecs; ++v) {
            s[q][v] = add_rn(s[q][v], __shfl_down_sync(0xffffffffu, s[q][v], off));
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kSlotsPerWarp; ++q) {
          const int k = k0 + q * kBtranWarps;
#pragma unroll
          for (int v = 0; v < kVecs; ++v) {
            if (k < nv[v]) part[(static_cast<size_t>(t) * kVecs + v) * K + k] = s[q][v];
          }
        }
      }
    }
    __syncthreads();  // the tile's y is read; the next tile may overwrite it
  }

  // The tiles' sums published to block 0 (release / acquire at cluster
  // scope).
  cluster.sync();
  if (!chain_block) return;

  for (int idx = tid; idx < kVecs * n; idx += kBtranThreads) {
    const int v = idx / n;
    const int k = idx - v * n;
    if (k < (v == 0 ? nv[0] : nv[1])) {
      const auto sum = [&](int t) {
        return __ldcg(part + (static_cast<size_t>(t) * kVecs + v) * K + k);
      };
      T s = sum(0);
      for (int t = 1; t < tiles; ++t) s = add_rn(s, sum(t));
      S_s[v * K + k] = s;
    }
  }

  for (int g = groups - 1; g >= 0; --g) {
    const int g0 = g * kGroup;
    const int gn = n - g0 < kGroup ? n - g0 : kGroup;
    if (g != groups - 1) {  // the newest group's G came before the S pass
      __syncthreads();      // the previous group's chain has read G
      gather_block<T, kBtranWarps>(vals, M, rows_s, G_s, g0, gn);
    }
    __syncthreads();  // S, the slot tables and G are in place
    // Each live slot's accumulator from every term outside the group:
    // S_k, the rows still at y0 in slot order (j <= k), then the newer
    // groups' new values, newest first.
    for (int idx = tid; idx < kVecs * kGroup; idx += kBtranThreads) {
      const int v = idx / kGroup;
      const int kk = idx - v * kGroup;
      const int k = g0 + kk;
      const int live = v == 0 ? nv[0] : nv[1];
      if (k >= live || kk >= gn) continue;
      const T* y0r = y0r_s + v * K;
      T a = S_s[v * K + k];
      for (int j = 0; j < g0; ++j) {  // the older groups' slots, from L2
        a = add_rn(a, nxt_s[j] >= live
                          ? mul_rn(y0r[j], vals[static_cast<size_t>(k) * M + rows_s[j]])
                          : T(0));
      }
#pragma unroll 8
      for (int j = g0; j <= k; ++j) {
        a = add_rn(a, nxt_s[j] >= live ? mul_rn(y0r[j], G_s[kk * kStride + (j - g0)]) : T(0));
      }
      for (int j = live - 1; j >= g0 + kGroup; --j) {
        if (prv_s[j] <= k) {
          a = add_rn(a, mul_rn(ynew_s[v * K + j], vals[static_cast<size_t>(k) * M + rows_s[j]]));
        }
      }
      A_s[v * kGroup + kk] = a;
    }
    __syncthreads();
    if (warp < kVecs) {
      const int live = warp == 0 ? nv[0] : nv[1];
      const int gv = live - g0 < gn ? live - g0 : gn;
      if (gv > 0) {
        btran_chain(rows_s, prv_s, nxt_s, G_s, A_s + warp * kGroup, y0r_s + warp * K,
                    ynew_s + warp * K, warp == 0 ? va.out : vb.out, live, g0, gv, lane);
      }
    }
  }
}

// ------------------------------------------------------------- launches --

// The largest dynamic shared memory of a block of ``kernel`` on this card
// set as the kernel's limit, once per kernel and card (the attribute
// belongs to the current card's context: configured holds a bit per card
// ordinal, and a card past the 64th sets it on every launch), so that any
// launch up to it is taken.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, std::atomic<unsigned long long>* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (configured->load() & bit) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes attrs = {};
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attrs, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attrs.sharedSizeBytes));
  if (err == cudaSuccess) configured->fetch_or(bit);
  return err;
}

template <typename T>
int launch_ftran(const void* vals, const void* rows, const void* count, const void* x,
                 void* out, int K, int M, void* stream) {
  if (K < 0 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_shared(eta_ftran_kernel<T>, &configured);
  int device = 0;
  int sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ts = K < kGroup ? K : kGroup;
  const int tiles = (M + kFtranThreads - 1) / kFtranThreads;
  const int blocks = tiles < 2 * sms ? tiles : 2 * sms;
  const int grid = (blocks + kCluster - 1) / kCluster * kCluster;  // whole clusters
  eta_ftran_kernel<T><<<grid, kFtranThreads, ftran_smem<T>(K, ts),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(rows),
      static_cast<const int*>(count), static_cast<const T*>(x), static_cast<T*>(out), K, M,
      ts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVecs>
int launch_btran_vecs(const void* vals, const void* rows, BtranVector<T> a,
                      BtranVector<T> b, void* part, int K, int M, void* stream) {
  static std::atomic<unsigned long long> configured{0};
  const cudaError_t err = allow_shared(eta_btran_kernel<T, kVecs>, &configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  eta_btran_kernel<T, kVecs><<<kCluster, kBtranThreads, btran_smem<T>(K, kVecs),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(rows), a, b,
      static_cast<T*>(part), K, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_btran(const void* vals, const void* rows, int vecs, const void* count_a,
                 const void* y_a, void* out_a, const void* count_b, const void* y_b,
                 void* out_b, void* part, int K, int M, void* stream) {
  if (K < 0 || M < 1 || vecs < 1 || vecs > 2) return static_cast<int>(cudaErrorInvalidValue);
  const BtranVector<T> a{static_cast<const int*>(count_a), static_cast<const T*>(y_a),
                         static_cast<T*>(out_a)};
  const BtranVector<T> b{static_cast<const int*>(count_b), static_cast<const T*>(y_b),
                         static_cast<T*>(out_b)};
  return vecs == 1 ? launch_btran_vecs<T, 1>(vals, rows, a, b, part, K, M, stream)
                   : launch_btran_vecs<T, 2>(vals, rows, a, b, part, K, M, stream);
}

}  // namespace

#define RELP_ETA_FTRAN(NAME, T)                                                           \
  extern "C" int NAME(const void* vals, const void* rows, const void* count, const void* x, \
                      void* out, int K, int M, void* stream) {                            \
    return launch_ftran<T>(vals, rows, count, x, out, K, M, stream);                      \
  }

#define RELP_ETA_BTRAN(NAME, T)                                                            \
  extern "C" int NAME(const void* vals, const void* rows, int vecs, const void* count_a,   \
                      const void* y_a, void* out_a, const void* count_b, const void* y_b, \
                      void* out_b, void* part, int K, int M, void* stream) {              \
    return launch_btran<T>(vals, rows, vecs, count_a, y_a, out_a, count_b, y_b, out_b,    \
                           part, K, M, stream);                                            \
  }

RELP_ETA_FTRAN(relp_eta_ftran_f32, float)
RELP_ETA_FTRAN(relp_eta_ftran_f64, double)
RELP_ETA_BTRAN(relp_eta_btran_f32, float)
RELP_ETA_BTRAN(relp_eta_btran_f64, double)
