// Fused steepest-edge pricing scan for Hopper (sm_90a).
//
// Replaces relp_tpu/ops/pallas_scan.py::fused_price_scan (Pallas body
// _scan_kernel).  One pass over the row-major (M, N) tableau A computes, per
// column j, with P = [pi_new; v; rho] of shape (3, M):
//
//     S     = P @ A   (accumulated in f32 for f32 and bf16, f64 for f64,
//                      then rounded to A's dtype, as pallas_scan.py:36 does)
//     d_j   = c_j - S[0, j]
//     g_j   = max(gamma_j - 2 S[2,j] S[1,j] + S[2,j]^2 gamma_q, 1 + S[2,j]^2)
//
// What bounds it: 6 M N flops over M N sizeof(T) bytes of tableau (1.5
// flop/byte in f32, 3 in bf16, 0.75 in f64), far below the card's ridge, so
// it is bound by memory bandwidth, and at small shapes by the latency of one
// launch and one round trip to memory.
//
// Design: one launch, no scratch in device memory, no atomics.
//   * The columns are cut into tiles of 128, 256 or 512 bytes of a row (32,
//     64 or 128 f32 columns; twice as many bf16, half as many f64), so that
//     every dtype asks for as many bytes per request.  The rows of a tile are
//     split over the `cluster` CTAs of a thread block cluster (1, 2, 4 or
//     8): grid (tiles * cluster), rank r of a tile's cluster takes rows
//     [r rows_per_rank, (r + 1) rows_per_rank).  The host's tiling aims at
//     a few small CTAs (128 threads) on every SM.
//   * A thread owns 16 bytes of a row of the tile (a float4, eight bf16, a
//     double2), so a warp reads 512 bytes of one to four rows, and every
//     (tile bytes / 16) threads form a row group that takes a contiguous
//     1/groups of the CTA's rows.  It keeps the three sums of its columns in
//     registers and accumulates them with FMAs in f32 (f32, bf16) or f64.
//   * Each thread streams its rows through its own ring in shared memory:
//     kRing slots of kRows rows, filled by 16-byte cp.async, kRing - 1 slots
//     (192 bytes a thread, 24 KB a CTA) in flight while it computes on the
//     oldest, waited for with cp.async.wait_group.  A thread reads only the
//     bytes it copied itself, so the loop has no barrier.  (A ring shared by
//     the CTA, filled by TMA and handed over with mbarriers, spent more on
//     each slot's hand-over than it hid at this intensity: PERF.md.)
//   * P's rows of the CTA are staged in shared memory once, in the
//     accumulation type, a row's three values side by side (one 16-byte
//     load in f32); a rank of more rows than 64 KB holds reads P through L1.
//   * The row groups' sums are added in shared memory in group order.  In a
//     cluster each CTA then pushes its sums of each column into the slot of
//     the rank that owns the column (distributed shared memory), one cluster
//     barrier follows, and the owner adds its slots in rank order 0, 1, ...
//     Every sum is taken in a fixed order: the same bits on every launch.
//     A rank left without rows adds zeros in its place.
//   * The epilogue does the plain version's operations in its order, each
//     rounded to T (no FMA contraction), on S rounded to T; c, gamma and
//     gamma_q of the columns a thread finishes are loaded at the start, so
//     it waits for no second round trip.
//   * A tableau whose rows are not 16-byte aligned (N sizeof(T) % 16 != 0,
//     or an unaligned base) takes the masked tail path: plain loads of each
//     element in the tile, no ring.  A ragged last column tile zero-fills
//     the 16 bytes past N, which are never written out.
//   * CUDA cores only: no tensor cores and no TF32.
//
// C interface, loaded with ctypes; every entry returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kRing = 4;          // slots of a thread's ring
constexpr int kRows = 4;          // rows of a slot
constexpr int kRingBytes = kRing * kRows * kThreads * 16;  // 32 KB
constexpr int kMaxTileCols = 256;  // 512 bytes of bf16
constexpr int kMaxStagedBytes = 64 * 1024;  // P's rows of a rank in shared memory
constexpr int kSlotBytes = 3 * kMaxTileCols * 4;  // the cluster's sums of a rank's columns

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_acc(typename Acc<T>::type x);
template <> __device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <> __device__ __forceinline__ double from_acc<double>(double x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return __fma_rn(a, b, c); }

// The epilogue's operations one at a time (no contraction into FMAs), each
// result rounded to T: the plain version's arithmetic (per-op rounding in
// bf16, as the TPU kernel's bf16 epilogue rounds).
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
template <typename T> __device__ __forceinline__ typename Acc<T>::type rnd(typename Acc<T>::type x) {
  return to_acc(from_acc<T>(x));
}

// 16 bytes of a row as accumulator values.
__device__ __forceinline__ void unpack(uint4 v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, double (&x)[2]) {
  x[0] = __hiloint2double(int(v.y), int(v.x));
  x[1] = __hiloint2double(int(v.w), int(v.z));
}
__device__ __forceinline__ void unpack(uint4 v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Shared memory: the threads' rings (the row groups' sums, [groups][3]
// [tile columns] of the accumulation type, take their place once they are
// drained: 12 KB at most), the slots where the cluster's ranks put their
// sums of this rank's columns ([rank][3][tile columns / cluster]), then,
// where they fit in kMaxStagedBytes, P's rows of the rank, [row][4] (the
// fourth 0), so that one row's three values come in one or two 16-byte
// loads.
template <typename T> __host__ __device__ constexpr int staged_bytes(int rows_per_rank) {
  return 4 * rows_per_rank * int(sizeof(typename Acc<T>::type));
}
template <typename T> __host__ __device__ constexpr bool p_staged(int rows_per_rank) {
  return staged_bytes<T>(rows_per_rank) <= kMaxStagedBytes;
}
template <typename T> __host__ __device__ constexpr int smem_bytes(int rows_per_rank) {
  return kRingBytes + kSlotBytes +
         (p_staged<T>(rows_per_rank) ? staged_bytes<T>(rows_per_rank) : 0);
}

// Row lr's three P values from the staged [row][4] rows.
__device__ __forceinline__ void load_p(const float* sP, int lr, float& p0, float& p1,
                                       float& p2) {
  const float4 p = *reinterpret_cast<const float4*>(sP + 4 * lr);
  p0 = p.x; p1 = p.y; p2 = p.z;
}
__device__ __forceinline__ void load_p(const double* sP, int lr, double& p0, double& p1,
                                       double& p2) {
  const double2 a = *reinterpret_cast<const double2*>(sP + 4 * lr);
  p0 = a.x; p1 = a.y; p2 = sP[4 * lr + 2];
}

// The cluster barrier, split: arrive (release; relaxed: orders nothing) and
// wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src (global, 16-byte aligned) to dst (shared), or 16 zero
// bytes (src not read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One CTA: rank blockIdx.x % cluster of column tile blockIdx.x / cluster.
// kAsync: rows 16-byte aligned, streamed through the rings; else the masked
// tail path.  kStaged: P's rows of the rank in shared memory; else read
// through L1 (a rank of more rows than kMaxStagedBytes holds).
template <typename T, bool kAsync, bool kStaged>
__global__ void __launch_bounds__(kThreads)
price_scan_kernel(const T* __restrict__ P, const T* __restrict__ A, const T* __restrict__ c,
                  const T* __restrict__ gamma, const T* __restrict__ gamma_q,
                  T* __restrict__ d_out, T* __restrict__ g_out, int M, int N, int tile_cols,
                  int cluster, int rows_per_rank) {
  using AccT = typename Acc<T>::type;
  constexpr int kVec = 16 / sizeof(T);  // elements a thread reads of a row
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  constexpr int kMaxOwned = kMaxTileCols / kThreads;  // epilogue columns a thread finishes
  AccT* slots = reinterpret_cast<AccT*>(smem + kRingBytes);
  AccT* sP = reinterpret_cast<AccT*>(smem + kRingBytes + kSlotBytes);

  // Half of the cluster barrier that the first push waits for: every CTA of
  // the cluster has started (its slots exist) by then.
  if (cluster > 1) cluster_arrive_relaxed();
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % cluster;
  const int col0 = (blockIdx.x / cluster) * tile_cols;
  const int cols = min(tile_cols, N - col0);
  const int vpr = tile_cols / kVec;     // 16-byte vectors in a row of the tile
  const int groups = kThreads / vpr;    // row groups
  const int v = tid % vpr, grp = tid / vpr;
  const int row0 = min(M, rank * rows_per_rank);
  const int rows = min(M, row0 + rows_per_rank) - row0;
  // This thread's rows: row0 + first + j for j < nj, a contiguous block.
  const int per_group = (rows + groups - 1) / groups;
  const int first = min(rows, grp * per_group);
  const int nj = min(rows, first + per_group) - first;
  const bool live = v * kVec < cols;  // its 16 bytes lie in the tableau
  const T* src = A + size_t(row0 + first) * N + col0 + v * kVec;
  const size_t step = size_t(N);

  // Fill the ring first, so the copies fly while P is staged.
  const int nslots = (nj + kRows - 1) / kRows;
  const T* next = src;  // the next row to copy
  const auto issue = [&](int s) {  // slot s of the thread's sequence
    if (s < nslots) {
      uint4* dst = ring + (s % kRing) * kRows * kThreads + tid;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool valid = live && s * kRows + r < nj;
        cp_async16(dst + r * kThreads, valid ? next : A, valid);
        next += step;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  if (kAsync) {
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) issue(s);
  }

  // P's rows of the CTA, and c, gamma and gamma_q of the columns this
  // thread finishes (rank r finishes columns [r own, (r + 1) own) of the
  // tile).
  for (int i = tid; kStaged && i < rows; i += kThreads) {
#pragma unroll
    for (int p = 0; p < 3; ++p) sP[4 * i + p] = to_acc(P[size_t(p) * M + row0 + i]);
    sP[4 * i + 3] = AccT(0);
  }
  const int own = tile_cols / cluster;
  AccT c_own[kMaxOwned], g_own[kMaxOwned];
#pragma unroll
  for (int u = 0; u < kMaxOwned; ++u) {
    const int j = rank * own + tid + u * kThreads;
    const bool ok = tid + u * kThreads < own && j < cols;
    c_own[u] = ok ? to_acc(c[col0 + j]) : AccT(0);
    g_own[u] = ok ? to_acc(gamma[col0 + j]) : AccT(0);
  }
  const AccT gq = to_acc(*gamma_q);
  __syncthreads();

  AccT acc[3][kVec];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[k][e] = AccT(0);
  // Row j's three P values.
  const auto p_of = [&](int j, AccT& p0, AccT& p1, AccT& p2) {
    const int lr = first + j;
    if (kStaged) {
      load_p(sP, lr, p0, p1, p2);
    } else {
      const T* p = P + row0 + lr;
      p0 = to_acc(p[0]); p1 = to_acc(p[size_t(M)]); p2 = to_acc(p[2 * size_t(M)]);
    }
  };
  const auto add = [&](const AccT (&x)[kVec], AccT p0, AccT p1, AccT p2) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      acc[0][e] = fma_acc(p0, x[e], acc[0][e]);
      acc[1][e] = fma_acc(p1, x[e], acc[1][e]);
      acc[2][e] = fma_acc(p2, x[e], acc[2][e]);
    }
  };

  if (kAsync) {
    for (int s = 0; s < nslots; ++s) {
      // Refill the slot this thread read last (its own bytes: no barrier),
      // then wait for slot s, kRing - 1 groups back.
      issue(s + kRing - 1);
      cp_async_wait<kRing - 1>();
      const uint4* mine = ring + (s % kRing) * kRows * kThreads + tid;
      uint4 raw[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) raw[r] = mine[r * kThreads];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = s * kRows + r;
        if (j >= nj) break;
        AccT x[kVec], p0, p1, p2;
        unpack(raw[r], x);
        p_of(j, p0, p1, p2);
        add(x, p0, p1, p2);
      }
    }
    cp_async_wait<0>();
  } else {
    for (int j = 0; j < nj; ++j) {
      AccT x[kVec], p0, p1, p2;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        x[e] = v * kVec + e < cols ? to_acc(src[j * step + e]) : AccT(0);
      }
      p_of(j, p0, p1, p2);
      add(x, p0, p1, p2);
    }
  }
  __syncthreads();  // every ring is drained

  // The row groups' sums, added in group order into group 0's place: red
  // is [groups][3][tile_cols] over the drained rings.
  AccT* red = reinterpret_cast<AccT*>(smem);
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) red[(grp * 3 + k) * tile_cols + v * kVec + e] = acc[k][e];
  __syncthreads();
  const auto group_sum = [&](int e) {
    AccT s = red[e];
    for (int g = 1; g < groups; ++g) s += red[g * 3 * tile_cols + e];
    return s;
  };
  if (cluster > 1) {
    // Push this CTA's sums of each column into the slot of the rank that
    // owns the column, then one barrier: after it every rank reads only its
    // own shared memory, so no CTA waits for another to leave.
    cg::cluster_group cl = cg::this_cluster();
    cluster_wait();
    for (int e = tid; e < 3 * tile_cols; e += kThreads) {
      const int k = e / tile_cols, j = e % tile_cols, q = j / own;
      cl.map_shared_rank(slots, q)[(rank * 3 + k) * own + j - q * own] = group_sum(e);
    }
    cluster_arrive();
    cluster_wait();
  }

  // The cluster's sums in rank order (a CTA alone: its groups' sums), then
  // the epilogue.
#pragma unroll
  for (int u = 0; u < kMaxOwned; ++u) {
    const int jj = tid + u * kThreads, j = rank * own + jj;
    if (jj >= own || j >= cols) continue;
    AccT s0 = 0, s1 = 0, s2 = 0;
    if (cluster == 1) {
      s0 = group_sum(j);
      s1 = group_sum(tile_cols + j);
      s2 = group_sum(2 * tile_cols + j);
    }
    for (int r = 0; r < cluster && cluster > 1; ++r) {
      s0 += slots[(r * 3 + 0) * own + jj];
      s1 += slots[(r * 3 + 1) * own + jj];
      s2 += slots[(r * 3 + 2) * own + jj];
    }
    // S in the scan dtype, as the TPU kernel casts its dot (pallas_scan.py:36),
    // then gamma - 2 abar inner + (abar abar) gq and 1 + abar abar in the
    // plain version's order, every step rounded to T.
    const AccT S0 = rnd<T>(s0), inner = rnd<T>(s1), abar = rnd<T>(s2);
    d_out[col0 + j] = from_acc<T>(sub_rn(c_own[u], S0));
    const AccT sq = rnd<T>(mul_rn(abar, abar));
    const AccT g = rnd<T>(add_rn(
        rnd<T>(sub_rn(g_own[u], rnd<T>(mul_rn(rnd<T>(mul_rn(AccT(2), abar)), inner)))),
        rnd<T>(mul_rn(sq, gq))));
    const AccT lo = rnd<T>(add_rn(AccT(1), sq));
    // max(g, lo) that propagates a NaN from either side, as torch.maximum does.
    g_out[col0 + j] = from_acc<T>((g >= lo || g != g) ? g : lo);
  }
}

template <typename T, bool kAsync, bool kStaged>
cudaError_t launch_kernel(const void* P, const void* A, const void* c, const void* gamma,
                          const void* gamma_q, void* d_out, void* g_out, int M, int N,
                          int tile_cols, int cluster, int rows_per_rank, cudaStream_t s) {
  static bool configured = false;  // once per process (one card per process)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        price_scan_kernel<T, kAsync, kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingBytes + kSlotBytes + kMaxStagedBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long tiles = (static_cast<long long>(N) + tile_cols - 1) / tile_cols;
  if (tiles * cluster > INT_MAX) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<T>(rows_per_rank);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, price_scan_kernel<T, kAsync, kStaged>,
                            static_cast<const T*>(P),
                            static_cast<const T*>(A), static_cast<const T*>(c),
                            static_cast<const T*>(gamma), static_cast<const T*>(gamma_q),
                            static_cast<T*>(d_out), static_cast<T*>(g_out), M, N, tile_cols,
                            cluster, rows_per_rank);
}

template <typename T>
int launch(const void* P, const void* A, const void* c, const void* gamma, const void* gamma_q,
           void* d_out, void* g_out, int M, int N, int tile_cols, int cluster,
           int rows_per_rank, void* stream) {
  const int tile_bytes = tile_cols * int(sizeof(T));
  const bool tiling_ok =
      M >= 1 && N >= 1 && (tile_bytes == 128 || tile_bytes == 256 || tile_bytes == 512) &&
      (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) && rows_per_rank >= 1 &&
      static_cast<long long>(rows_per_rank) * cluster >= M;
  if (!tiling_ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                       (static_cast<long long>(N) * sizeof(T)) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel_launch) {
    return kernel_launch(P, A, c, gamma, gamma_q, d_out, g_out, M, N, tile_cols, cluster,
                         rows_per_rank, s);
  };
  const bool staged = p_staged<T>(rows_per_rank);
  const cudaError_t err =
      aligned ? (staged ? go(launch_kernel<T, true, true>) : go(launch_kernel<T, true, false>))
              : (staged ? go(launch_kernel<T, false, true>) : go(launch_kernel<T, false, false>));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RELP_PRICE_SCAN_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* P, const void* A, const void* c, const void* gamma,      \
                      const void* gamma_q, void* d_out, void* g_out, int M, int N,         \
                      int tile_cols, int cluster, int rows_per_rank, void* stream) {       \
    return launch<T>(P, A, c, gamma, gamma_q, d_out, g_out, M, N, tile_cols, cluster,      \
                     rows_per_rank, stream);                                               \
  }

RELP_PRICE_SCAN_ENTRY(relp_price_scan_f32, float)
RELP_PRICE_SCAN_ENTRY(relp_price_scan_f64, double)
RELP_PRICE_SCAN_ENTRY(relp_price_scan_bf16, __nv_bfloat16)

// Dynamic shared memory of a CTA of rows_per_rank rows, by element size
// (ptxas does not see it); -1 for another size.
extern "C" int relp_price_scan_smem_bytes(int itemsize, int rows_per_rank) {
  switch (itemsize) {
    case 2: return smem_bytes<__nv_bfloat16>(rows_per_rank);
    case 4: return smem_bytes<float>(rows_per_rank);
    case 8: return smem_bytes<double>(rows_per_rank);
    default: return -1;
  }
}
