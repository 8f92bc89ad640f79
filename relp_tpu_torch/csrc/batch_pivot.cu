// Batched-pivot chunk kernels for Hopper (sm_90a): a whole chunk of
// steepest-edge primal simplex pivots for every LP of a scenario batch, one
// thread block per LP, with no host round trip between pivots.
//
// Replaces relp_tpu/ops/pallas_batch.py:
//   * batch_pivot_kernel<true>  ("resident") <- batched_pivot_chunk
//     (pl.pallas_call at :865, body _make_kernel :51-325);
//   * batch_pivot_kernel<false> ("blocked")  <- batched_pivot_chunk_blocked
//     (pl.pallas_call at :724, body _make_blocked_kernel :328-646).
// Both compute the unguarded semantics of the TPU kernels (noise_eps = 0,
// no hi_scan): on this card f32 products are true f32.  Per pivot, for LP b:
//   1. pricing: argmax over eligible columns of d^2 / gamma, ties to the
//      lowest index;
//   2. a_q = A[:, q], a strided column read;
//   3. w = Binv a_q and d_q = c_q - pi . a_q;
//   4. Harris two-pass ratio test with relative delta 1e-7 (1 + xB): theta
//      = min over w > pivot_tol of (xB+ + delta) / w, then the largest w
//      among rows with xB+ / w <= theta, ties to the lowest row;
//   5. status: OPTIMAL (nothing eligible) or UNBOUNDED (no w > pivot_tol)
//      freezes the LP for the rest of the chunk;
//   6. rho = Binv[r] / w_r and v = w^T Binv, both from the OLD inverse,
//      then the rank-1 update of Binv (row r becomes rho), xB, pi, basis,
//      in_basis and cB;
//   7. the stacked scan S = [pi; v; rho] A: d = c - S0 and the Goldfarb
//      update gamma' = max(gamma - 2 S2 S1 + S2^2 gamma_q, 1 + S2^2), with
//      gamma[leaving] = max(gamma_q / w_r^2, 1) and gamma[q] = 1;
//   8. iteration + 1, degeneracy counter (t <= degen_tol).
// The LP also freezes when stop_at_zero is set and sum(cB xB) <= 1e-9.
//
// What bounds it.  Per pivot one LP reads its (M, N) tableau once (the
// scan) and its (M, M) inverse three times: FTRAN reads it, and one fused
// pass reads every element once more, feeding v = w^T Binv from the old
// value, and writes it back updated.  Each LP has a block of its own on
// one SM (two resident blocks share an SM).  The design:
//   * one tableau for a shared-structure batch: A comes with a batch
//     stride of 0 (one (M, N) tableau, an expanded view) or M N (one per
//     LP).  With stride 0 every block reads the same lines, which stay in
//     the 50 MB L2, so the scan is bound by L2, not device memory;
//   * the scan gives every thread four adjacent columns, read as float4,
//     and splits the rows into groups over the block's threads, eight (256
//     threads) or four (1024) row loads in flight per thread; the groups'
//     partial sums are added in a fixed order through shared memory;
//   * "resident" keeps the whole inverse in shared memory for the chunk
//     (the TPU kernel's VMEM-resident carry), in a block of 256 threads
//     whose 128 registers a thread keep everything out of local memory;
//     two such blocks share an SM (80.7 KB of shared memory each at
//     128 x 384), so one block's barriers and loads overlap the other's
//     work and a batch of 256 runs in one wave;
//   * "blocked" keeps the first R rows of the inverse in shared memory for
//     the chunk, R as large as fits beside the vector state (45 of 512 at
//     512 x 1408), and streams the other rows through a ring of kStages
//     tiles (16 KB each, one float4 per thread of its 1024) filled with
//     cp.async, kStages - 1 tiles (64 KB) in flight.
//     The ring's first tiles are issued ahead (FTRAN's during the previous
//     pivot's scan, the update pass's before the ratio test), so the
//     streamed rows cross device memory three times per pivot: FTRAN's
//     read, the fused pass's read and its write;
//   * the fused pass: every thread owns one float4 column quad of a tile
//     row, accumulates its part of v over the rows it updates, and the
//     parts are summed over the row groups in a fixed order by all threads.
//   No tensor cores: B^-1 and the scan carry state, which TF32 would cut
//   to about three digits, and every product here is bound by memory or
//   latency anyway.
// Times per 25-pivot chunk of the whole batch from the phase-2 start
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): the first version (one
// copy of the tableau per LP, a column per thread, inverse crossing device
// memory four times) took 0.748 ms at 256 x 128x384 (resident) and 7.94 ms
// at 128 x 512x1408 (blocked); this one 0.43-0.47 and 5.61-5.63 ms, against
// 0.71-0.74 and 8.19-8.21 for the first version in the same run.  What
// bounds it now: resident, the latency of each pivot's chain of barriers,
// reductions and L2 round trips (8% of its operations bound); blocked, its
// inverse's device-memory traffic and the L2 scan (5%).  PERF.md has more.
//
// Numerics: IEEE division and no flush to zero (no --use_fast_math), since
// the Harris test compares quotients; the elementwise updates use _rn
// intrinsics so that no multiply-add is contracted and each matches the
// plain PyTorch version's two roundings.  Every reduction runs in a fixed
// order (warp shuffle trees, fixed group orders in shared memory), no
// atomics: two launches give the same bits, and so do a stride-0 tableau
// and B copies of it.
//
// C interface, loaded with ctypes; every entry returns cudaGetLastError()
// (a launch refused for too much shared memory never runs).

#include <climits>
#include <math.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRedWords = 136;  // reduction scratch: 4 x 32 partials, results
constexpr int kStages = 5;      // ring tiles of the streamed inverse rows
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRunning = 0;
constexpr int kOptimal = 1;
constexpr int kUnbounded = 2;

// Threads of a block, and blocks per SM for the register budget (at most
// 65,536 / (kThreads kMinBlocks) registers a thread).  The resident kernel
// runs two 256-thread blocks per SM, so that one block's barriers and loads
// overlap the other's work and a 256-LP batch runs in one wave on the 132
// SMs; the blocked kernel, which needs the whole of an SM's shared memory,
// one block of 1024.
template <bool kResident>
struct Launch {
  static constexpr int kThreads = kResident ? 256 : 1024;
  static constexpr int kMinBlocks = kResident ? 2 : 1;
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "warps of one block");
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr size_t zmax(size_t a, size_t b) { return a > b ? a : b; }

// The work split of one LP, from (M, N), R, the inverse rows kept in shared
// memory, and the block's threads; relp_tpu_torch/ops/batch_pivot.py::_bytes
// computes the same numbers.
struct Shape {
  int M, N, R;
  int Qm;  // float4 column quads of an inverse row
  int Qn;  // float4 column quads of a tableau row
  int T;   // inverse rows per tile (T Qm <= threads: one float4 each)
  int Sg;  // 32-quad segments of an inverse row (FTRAN: one warp each)
  int Gs;  // row groups of the scan
  int H;   // first-level chunks of the fixed-order sum of v
  size_t scratch;  // words: scan partials, v partials, FTRAN partials
  size_t ring;     // words of the ring (blocked only)
};

__host__ __device__ inline Shape make_shape(int M, int N, int R, int threads) {
  Shape s;
  s.M = M;
  s.N = N;
  s.R = R;
  s.Qm = M / 4;
  s.Qn = N / 4;
  s.T = imin(M, imax(1, 4 * threads / M));
  s.Sg = (s.Qm + 31) / 32;
  s.Gs = s.Qn >= threads ? 1 : imin(M, threads / s.Qn);
  s.H = imax(1, imin(s.T, threads / M));
  s.scratch = zmax(zmax(size_t(s.Gs - 1) * 3 * N, size_t(s.T + s.H) * M),
                   size_t(M) * s.Sg);
  s.ring = R < M ? size_t(kStages) * s.T * M : 0;
  return s;
}

// Shared memory of one block: the resident inverse rows, the ring, eight
// M-vectors, three N-vectors, the reduction scratch, the work scratch and
// two N-byte masks, rounded up to 16.
size_t smem_bytes(const Shape& s) {
  const size_t words = size_t(s.R) * s.M + s.ring + 8 * size_t(s.M) +
                       3 * size_t(s.N) + kRedWords + s.scratch;
  const size_t bytes = 4 * words + 2 * size_t(s.N);
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_down_sync(kFull, v, o));
  return v;
}

// (s, i) <- the better of (s, i) and (os, oi): larger score, then lower index.
__device__ __forceinline__ void keep_better(float& s, int& i, float os, int oi) {
  if (os > s || (os == s && oi < i)) {
    s = os;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_down_sync(kFull, s, o);
    const int oi = __shfl_down_sync(kFull, i, o);
    keep_better(s, i, os, oi);
  }
}

// Block reductions: every thread calls them and gets the result.
template <int kThreads>
__device__ float block_sum(float v, float* red) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_sum(lane < kWarps ? red[lane] : 0.f);
    if (lane == 0) red[64] = s;
  }
  __syncthreads();
  const float out = red[64];
  __syncthreads();
  return out;
}

// The ratio test's four reductions in one: min of tmin, the sums s1 and
// s2 (each in block_sum's order) and the or of pos.
struct RatioSums {
  float tmin, s1, s2;
  int any;
};

template <int kThreads>
__device__ RatioSums block_ratio_sums(float tmin, float s1, float s2, int pos,
                                      float* red) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  tmin = warp_min(tmin);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  pos = __any_sync(kFull, pos);
  if (lane == 0) {
    red[warp] = tmin;
    red[32 + warp] = s1;
    red[64 + warp] = s2;
    red[96 + warp] = pos ? 1.f : 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < kWarps;
    const float a = warp_min(in ? red[lane] : INFINITY);
    const float b = warp_sum(in ? red[32 + lane] : 0.f);
    const float c = warp_sum(in ? red[64 + lane] : 0.f);
    const int d = __any_sync(kFull, in && red[96 + lane] != 0.f);
    if (lane == 0) {
      red[128] = a;
      red[129] = b;
      red[130] = c;
      red[131] = d ? 1.f : 0.f;
    }
  }
  __syncthreads();
  const RatioSums out = {red[128], red[129], red[130], red[131] != 0.f};
  __syncthreads();
  return out;
}

// Index of the best (score, index) pair; INT_MAX when no thread had one.
template <int kThreads>
__device__ int block_argmax(float s, int i, float* red) {
  constexpr int kWarps = kThreads / 32;
  int* redi = reinterpret_cast<int*>(red + 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(s, i);
  if (lane == 0) {
    red[warp] = s;
    redi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? red[lane] : -INFINITY;
    i = lane < kWarps ? redi[lane] : INT_MAX;
    warp_argmax(s, i);
    if (lane == 0) redi[33] = i;
  }
  __syncthreads();
  const int out = redi[33];
  __syncthreads();
  return out;
}

// --- the ring of streamed inverse rows [R, M) ---

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int ring_tiles(const Shape& s) {
  return (s.M - s.R + s.T - 1) / s.T;
}

// Copies tile t of the streamed rows (contiguous in device memory) into its
// ring slot: one 16-byte cp.async per thread.
template <int kThreads>
__device__ __forceinline__ void issue_tile(float* ring, const float* Bg,
                                           const Shape& s, int t) {
  const int row0 = s.R + t * s.T;
  const int units = imin(s.T, s.M - row0) * s.Qm;
  const float* src = Bg + size_t(row0) * s.M;
  float* dst = ring + size_t(t % kStages) * s.T * s.M;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    cp_async16(dst + 4 * u, src + 4 * u);
  }
}

// Issues the first kStages - 1 tiles of one pass over the streamed rows
// (one commit group each, empty past the last tile).
template <int kThreads>
__device__ void ring_prologue(float* ring, const float* Bg, const Shape& s) {
  const int n = ring_tiles(s);
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n) issue_tile<kThreads>(ring, Bg, s, t);
    cp_async_commit();
  }
}

// One pass over the streamed rows, after ring_prologue: consume(tile, row0,
// nrows) sees each tile in shared memory while the next kStages - 1 load.
template <int kThreads, class Consume>
__device__ void ring_pass(float* ring, const float* Bg, const Shape& s,
                          Consume consume) {
  const int n = ring_tiles(s);
  for (int t = 0; t < n; ++t) {
    if (t + kStages - 1 < n) issue_tile<kThreads>(ring, Bg, s, t + kStages - 1);
    cp_async_commit();
    cp_async_wait_ring();  // this thread's copies of tile t have landed
    __syncthreads();       // and everyone's
    const int row0 = s.R + t * s.T;
    consume(ring + size_t(t % kStages) * s.T * s.M, row0, imin(s.T, s.M - row0));
    __syncthreads();  // the slot is free for tile t + kStages
  }
}

// --- the tableau scan ---

template <int K>
__device__ __forceinline__ void fma_row(float4 (&s)[K], const float* const (&xs)[3],
                                        int i, const float4& a) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float x = xs[k][i];
    s[k].x = fmaf(x, a.x, s[k].x);
    s[k].y = fmaf(x, a.y, s[k].y);
    s[k].z = fmaf(x, a.z, s[k].z);
    s[k].w = fmaf(x, a.w, s[k].w);
  }
}

// Partial sums over rows i = g, g + step, ... < M of x_k[i] A[i, 4c..4c+3]
// for K = 1 (pi) or 3 (pi, v, rho) row vectors, in increasing i, D row
// loads in flight.
template <int K, int D>
__device__ __forceinline__ void scan_quad(const float4* __restrict__ A4, int Qn,
                                          int M, int g, int step,
                                          const float* x0, const float* x1,
                                          const float* x2, float4 (&s)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* const xs[3] = {x0, x1, x2};
  int i = g;
  for (; i + (D - 1) * step < M; i += D * step) {
    float4 a[D];
#pragma unroll
    for (int u = 0; u < D; ++u) a[u] = __ldg(A4 + size_t(i + u * step) * Qn);
#pragma unroll
    for (int u = 0; u < D; ++u) fma_row<K>(s, xs, i + u * step, a[u]);
  }
  for (; i < M; i += step) fma_row<K>(s, xs, i, __ldg(A4 + size_t(i) * Qn));
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

// S = [x0; x1; x2][:K] A over the whole tableau, then epilogue(j, S0..) for
// every column j of the quads this thread finishes.  Row groups g > 0 leave
// their partials in scratch; group 0 adds them in the order g = 1, 2, ...
template <int kThreads, int K, class Epilogue>
__device__ void scan(const float* __restrict__ Ab, const Shape& s,
                     const float* x0, const float* x1, const float* x2,
                     float* scratch, Epilogue epilogue) {
  // Row loads in flight per thread: a 256-thread block walks many rows a
  // thread and has the registers for eight; a 1024-thread block has 64.
  constexpr int D = kThreads <= 256 ? 8 : 4;
  const float4* A4 = reinterpret_cast<const float4*>(Ab);
  const int tid = threadIdx.x;
  if (s.Gs == 1) {
    for (int c = tid; c < s.Qn; c += kThreads) {
      float4 acc[K];
      scan_quad<K, D>(A4 + c, s.Qn, s.M, 0, 1, x0, x1, x2, acc);
      epilogue(c, acc);
    }
    __syncthreads();
    return;
  }
  const int c = tid % s.Qn, g = tid / s.Qn;
  float4* part = reinterpret_cast<float4*>(scratch);
  float4 acc[K];
  if (g < s.Gs) {
    scan_quad<K, D>(A4 + c, s.Qn, s.M, g, s.Gs, x0, x1, x2, acc);
    if (g > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) part[(size_t(g - 1) * K + k) * s.Qn + c] = acc[k];
    }
  }
  __syncthreads();
  if (g == 0) {
    for (int h = 1; h < s.Gs; ++h) {
#pragma unroll
      for (int k = 0; k < K; ++k) add4(acc[k], part[(size_t(h - 1) * K + k) * s.Qn + c]);
    }
    epilogue(c, acc);
  }
  __syncthreads();
}

template <bool kResident>
__global__ void __launch_bounds__(Launch<kResident>::kThreads,
                                  Launch<kResident>::kMinBlocks)
batch_pivot_kernel(const float* __restrict__ A, long long a_stride,
                   const float* __restrict__ c,
                   const unsigned char* __restrict__ cand, float* Binv_all,
                   float* xB_all, float* pi_all, int* basis_all,
                   unsigned char* inb_all, float* gamma_all, int* status_all,
                   int* iter_all, int* degen_all, int M, int N, int R,
                   int chunk, float opt_tol, float pivot_tol, float degen_tol,
                   int stop_at_zero) {
  constexpr int kThreads = Launch<kResident>::kThreads;
  constexpr int kWarps = kThreads / 32;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // A frozen LP: the outputs already hold its state.
  if (status_all[b] != kRunning) return;

  const Shape sh = make_shape(M, N, kResident ? M : R, kThreads);
  extern __shared__ __align__(16) unsigned char smem[];
  float* p = reinterpret_cast<float*>(smem);
  float* sBinv = p; p += size_t(sh.R) * M;  // rows [0, R) of the inverse
  float* ring = p; p += sh.ring;
  float* sxB = p; p += M;
  float* spi = p; p += M;
  float* scB = p; p += M;
  float* sw = p; p += M;
  float* srho = p; p += M;
  float* sv = p; p += M;
  float* saq = p; p += M;
  int* sbasis = reinterpret_cast<int*>(p); p += M;
  float* sd = p; p += N;
  float* sg = p; p += N;
  float* sc = p; p += N;
  float* red = p; p += kRedWords;
  float* scratch = p; p += sh.scratch;
  unsigned char* scand = reinterpret_cast<unsigned char*>(p);
  unsigned char* sinb = scand + N;

  // a_stride is 0 (one tableau shared by the batch) or M N.
  const float* Ab = A + size_t(b) * size_t(a_stride);
  float* Bg = Binv_all + size_t(b) * M * M;
  const bool stream = !kResident && sh.R < M;

  for (size_t e = tid; e < size_t(sh.R) * sh.Qm; e += kThreads) {
    reinterpret_cast<float4*>(sBinv)[e] = reinterpret_cast<const float4*>(Bg)[e];
  }
  for (int i = tid; i < M; i += kThreads) {
    sxB[i] = xB_all[size_t(b) * M + i];
    spi[i] = pi_all[size_t(b) * M + i];
    sbasis[i] = basis_all[size_t(b) * M + i];
  }
  for (int j = tid; j < N; j += kThreads) {
    sc[j] = c[size_t(b) * N + j];
    sg[j] = gamma_all[size_t(b) * N + j];
    scand[j] = cand[size_t(b) * N + j];
    sinb[j] = inb_all[size_t(b) * N + j];
  }
  if (stream) ring_prologue<kThreads>(ring, Bg, sh);  // FTRAN's first tiles
  __syncthreads();
  for (int i = tid; i < M; i += kThreads) scB[i] = sc[sbasis[i]];
  // Chunk-entry reduced costs d = c - pi A.
  scan<kThreads, 1>(Ab, sh, spi, nullptr, nullptr, scratch,
          [&](int q4, const float4 (&S)[1]) {
            const float s0[4] = {S[0].x, S[0].y, S[0].z, S[0].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) sd[4 * q4 + e] = __fsub_rn(sc[4 * q4 + e], s0[e]);
          });

  // The fused update pass: thread tid owns float4 quad uc4 of row urow of
  // every tile (T Qm <= kThreads).
  const int urow = tid / sh.Qm, uc4 = tid % sh.Qm;
  // FTRAN: warp items it = warp, warp + 32, ... of a tile are (row, segment)
  // pairs it = row Sg + seg, stepped without a division.
  const int frow0 = warp / sh.Sg, fseg0 = warp % sh.Sg;
  const int drow = kWarps / sh.Sg, dseg = kWarps % sh.Sg;

  int status = kRunning;
  int iter = iter_all[b];
  int degen = degen_all[b];
  for (int k = 0; k < chunk; ++k) {
    if (stop_at_zero) {
      float part = 0.f;
      for (int i = tid; i < M; i += kThreads) part += __fmul_rn(scB[i], sxB[i]);
      if (!(block_sum<kThreads>(part, red) > 1e-9f)) break;
    }

    // 1. pricing (columns ascend per thread, so a strict > keeps the lowest
    // index among equal scores).
    float best = -INFINITY;
    int q = INT_MAX;
    for (int j = tid; j < N; j += kThreads) {
      const float dj = sd[j];
      if (scand[j] && !sinb[j] && dj < -opt_tol) {
        const float score = __fdiv_rn(__fmul_rn(dj, dj), sg[j]);
        if (score > best) {
          best = score;
          q = j;
        }
      }
    }
    q = block_argmax<kThreads>(best, q, red);
    if (q == INT_MAX) {
      status = kOptimal;
      break;
    }

    // 2. the entering column.
    for (int i = tid; i < M; i += kThreads) saq[i] = __ldg(Ab + size_t(i) * N + q);
    __syncthreads();

    // 3. FTRAN w = Binv a_q: one warp per (row, 32-quad segment), the
    // segments' sums added in order; d_q = c_q - pi . a_q.
    const float4* aq4 = reinterpret_cast<const float4*>(saq);
    auto ftran_tile = [&](const float* rows, int row0, int nrows) {
      int row = frow0, seg = fseg0;
      for (int it = warp; it < nrows * sh.Sg; it += kWarps) {
        const int c4 = seg * 32 + lane;
        float s = 0.f;
        if (c4 < sh.Qm) {
          const float4 x = reinterpret_cast<const float4*>(rows + row * M)[c4];
          const float4 a = aq4[c4];
          s = fmaf(x.x, a.x, s);
          s = fmaf(x.y, a.y, s);
          s = fmaf(x.z, a.z, s);
          s = fmaf(x.w, a.w, s);
        }
        s = warp_sum(s);
        if (lane == 0) scratch[(row0 + row) * sh.Sg + seg] = s;
        row += drow;
        seg += dseg;
        if (seg >= sh.Sg) {
          seg -= sh.Sg;
          ++row;
        }
      }
    };
    for (int row0 = 0; row0 < sh.R; row0 += sh.T) {
      ftran_tile(sBinv + row0 * M, row0, imin(sh.T, sh.R - row0));
    }
    if (stream) {
      ring_pass<kThreads>(ring, Bg, sh, ftran_tile);
      ring_prologue<kThreads>(ring, Bg, sh);  // the update pass's first tiles
    }
    __syncthreads();
    for (int i = tid; i < M; i += kThreads) {
      float s = 0.f;
      for (int seg = 0; seg < sh.Sg; ++seg) s += scratch[i * sh.Sg + seg];
      sw[i] = s;
    }
    __syncthreads();

    // 4. Harris two-pass ratio test; the same reduction gives d_q = c_q -
    // pi . a_q and gamma_q = 1 + w . w.
    float tmin = INFINITY, dot_pi = 0.f, dot_w = 0.f;
    int positive = 0;
    for (int i = tid; i < M; i += kThreads) {
      const float wi = sw[i];
      dot_pi = fmaf(spi[i], saq[i], dot_pi);
      dot_w = fmaf(wi, wi, dot_w);
      if (wi > pivot_tol) {
        positive = 1;
        const float xe = fmaxf(sxB[i], 0.f);
        const float delta = __fmul_rn(1e-7f, __fadd_rn(1.f, xe));
        tmin = fminf(tmin, __fdiv_rn(__fadd_rn(xe, delta), wi));
      }
    }
    const RatioSums sums =
        block_ratio_sums<kThreads>(tmin, dot_pi, dot_w, positive, red);
    const int any_positive = sums.any;
    const float theta = sums.tmin;
    const float c_q = sc[q];
    const float d_q = __fsub_rn(c_q, sums.s1);
    const float gq = __fadd_rn(1.f, sums.s2);
    float wbest = -INFINITY;
    int r = INT_MAX;
    for (int i = tid; i < M; i += kThreads) {
      const float wi = sw[i];
      if (wi > pivot_tol && __fdiv_rn(fmaxf(sxB[i], 0.f), wi) <= theta &&
          wi > wbest) {
        wbest = wi;
        r = i;
      }
    }
    r = block_argmax<kThreads>(wbest, r, red);

    // 5. status.
    if (!any_positive || r == INT_MAX) {
      status = kUnbounded;
      break;
    }

    // 6. rho from the OLD row r (then a barrier), then one pass over the
    // inverse: each element is read once, feeds v = w^T Binv with its old
    // value and is written back updated.
    const float w_r = sw[r];
    const float t = __fdiv_rn(fmaxf(sxB[r], 0.f), w_r);
    const int leaving = sbasis[r];
    const float* row_r = r < sh.R ? sBinv + size_t(r) * M : Bg + size_t(r) * M;
    for (int kk = tid; kk < M; kk += kThreads) {
      srho[kk] = __fdiv_rn(r < sh.R ? row_r[kk] : __ldcg(row_r + kk), w_r);
    }
    __syncthreads();

    const float4 rho4 = urow < sh.T ? reinterpret_cast<const float4*>(srho)[uc4]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vacc = make_float4(0.f, 0.f, 0.f, 0.f);
    auto update_tile = [&](const float* src, float* dst, int row0, int nrows) {
      if (urow >= nrows) return;
      const int i = row0 + urow;
      const float4 old = reinterpret_cast<const float4*>(src + urow * M)[uc4];
      const float wi = sw[i];
      vacc.x = fmaf(wi, old.x, vacc.x);
      vacc.y = fmaf(wi, old.y, vacc.y);
      vacc.z = fmaf(wi, old.z, vacc.z);
      vacc.w = fmaf(wi, old.w, vacc.w);
      float4 nw = rho4;
      if (i != r) {
        nw.x = __fsub_rn(old.x, __fmul_rn(wi, rho4.x));
        nw.y = __fsub_rn(old.y, __fmul_rn(wi, rho4.y));
        nw.z = __fsub_rn(old.z, __fmul_rn(wi, rho4.z));
        nw.w = __fsub_rn(old.w, __fmul_rn(wi, rho4.w));
      }
      reinterpret_cast<float4*>(dst + size_t(i) * M)[uc4] = nw;
    };
    for (int row0 = 0; row0 < sh.R; row0 += sh.T) {
      update_tile(sBinv + row0 * M, sBinv, row0, imin(sh.T, sh.R - row0));
    }
    if (stream) {
      ring_pass<kThreads>(ring, Bg, sh, [&](const float* tile, int row0, int nrows) {
        update_tile(tile, Bg, row0, nrows);
      });
      ring_prologue<kThreads>(ring, Bg, sh);  // the next FTRAN's first tiles
    }
    // v: the parts of row groups g = 0..T-1, summed in that order in two
    // levels (H chunks of groups, then the chunks), by all threads.
    if (urow < sh.T) reinterpret_cast<float4*>(scratch + size_t(urow) * M)[uc4] = vacc;
    __syncthreads();
    float* lvl1 = scratch + size_t(sh.T) * M;
    for (int u = tid; u < sh.H * M; u += kThreads) {
      const int kk = u % M, h = u / M;
      float s = 0.f;
      for (int g = h * sh.T / sh.H; g < (h + 1) * sh.T / sh.H; ++g) {
        s += scratch[size_t(g) * M + kk];
      }
      lvl1[u] = s;
    }
    __syncthreads();
    for (int kk = tid; kk < M; kk += kThreads) {
      float s = 0.f;
      for (int h = 0; h < sh.H; ++h) s += lvl1[size_t(h) * M + kk];
      sv[kk] = s;
    }
    for (int i = tid; i < M; i += kThreads) {
      sxB[i] = (i == r) ? t : __fsub_rn(sxB[i], __fmul_rn(t, sw[i]));
      spi[i] = __fadd_rn(spi[i], __fmul_rn(d_q, srho[i]));
      if (i == r) {
        sbasis[i] = q;
        scB[i] = c_q;
      }
    }
    __syncthreads();

    // 7. the stacked scan [pi; v; rho] A, d and the Goldfarb weights.
    const float g_leaving = fmaxf(__fdiv_rn(gq, __fmul_rn(w_r, w_r)), 1.f);
    scan<kThreads, 3>(Ab, sh, spi, sv, srho, scratch,
            [&](int q4, const float4 (&S)[3]) {
              const float s0[4] = {S[0].x, S[0].y, S[0].z, S[0].w};
              const float s1[4] = {S[1].x, S[1].y, S[1].z, S[1].w};
              const float s2[4] = {S[2].x, S[2].y, S[2].z, S[2].w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = 4 * q4 + e;
                sd[j] = __fsub_rn(sc[j], s0[e]);
                float g;
                if (j == q) {
                  g = 1.f;
                } else if (j == leaving) {
                  g = g_leaving;
                } else {
                  const float a2 = __fmul_rn(s2[e], s2[e]);
                  g = __fadd_rn(__fsub_rn(sg[j], __fmul_rn(__fmul_rn(2.f, s2[e]), s1[e])),
                                __fmul_rn(a2, gq));
                  const float lo = __fadd_rn(1.f, a2);
                  g = (g >= lo || g != g) ? g : lo;  // torch.maximum: NaN propagates
                }
                sg[j] = g;
              }
            });
    if (tid == 0) {
      sinb[leaving] = 0;
      sinb[q] = 1;
    }
    __syncthreads();

    // 8. counters.
    iter += 1;
    degen = (t <= degen_tol) ? degen + 1 : 0;
  }

  if (stream) cp_async_wait_all();  // tiles issued ahead and not consumed
  __syncthreads();
  for (size_t e = tid; e < size_t(sh.R) * sh.Qm; e += kThreads) {
    reinterpret_cast<float4*>(Bg)[e] = reinterpret_cast<const float4*>(sBinv)[e];
  }
  for (int i = tid; i < M; i += kThreads) {
    xB_all[size_t(b) * M + i] = sxB[i];
    pi_all[size_t(b) * M + i] = spi[i];
    basis_all[size_t(b) * M + i] = sbasis[i];
  }
  for (int j = tid; j < N; j += kThreads) {
    gamma_all[size_t(b) * N + j] = sg[j];
    inb_all[size_t(b) * N + j] = sinb[j];
  }
  if (tid == 0) {
    status_all[b] = status;
    iter_all[b] = iter;
    degen_all[b] = degen;
  }
}

template <bool kResident>
int launch(const void* A, long long a_stride, const void* c, const void* cand,
           void* Binv, void* xB, void* pi, void* basis, void* inb, void* gamma,
           void* status, void* iteration, void* degen, int B, int M, int N,
           int R, int chunk, float opt_tol, float pivot_tol,
           float degen_tol, int stop_at_zero, int smem, void* stream) {
  constexpr int kThreads = Launch<kResident>::kThreads;
  const bool shape_ok = B >= 1 && M >= 4 && N >= 4 && M % 4 == 0 &&
                        N % 4 == 0 && M <= 4 * kThreads && R >= 0 && R <= M &&
                        (!kResident || R == M) &&
                        (a_stride == 0 || a_stride == (long long)M * N);
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = smem_bytes(make_shape(M, N, R, kThreads));
  if (size_t(smem) != need) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      batch_pivot_kernel<kResident>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  batch_pivot_kernel<kResident>
      <<<B, kThreads, need, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(A), a_stride, static_cast<const float*>(c),
          static_cast<const unsigned char*>(cand), static_cast<float*>(Binv),
          static_cast<float*>(xB), static_cast<float*>(pi),
          static_cast<int*>(basis), static_cast<unsigned char*>(inb),
          static_cast<float*>(gamma), static_cast<int*>(status),
          static_cast<int*>(iteration), static_cast<int*>(degen), M, N, R,
          chunk, opt_tol, pivot_tol, degen_tol, stop_at_zero);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RELP_BATCH_PIVOT_ENTRY(NAME, RESIDENT)                                  \
  extern "C" int NAME(const void* A, long long a_stride, const void* c,        \
                      const void* cand, void* Binv, void* xB, void* pi,        \
                      void* basis, void* inb, void* gamma, void* status,       \
                      void* iteration, void* degen, int B, int M, int N,       \
                      int R, int chunk, float opt_tol, float pivot_tol,        \
                      float degen_tol, int stop_at_zero, int smem,             \
                      void* stream) {                                          \
    return launch<RESIDENT>(A, a_stride, c, cand, Binv, xB, pi, basis, inb,    \
                            gamma, status, iteration, degen, B, M, N, R,       \
                            chunk, opt_tol, pivot_tol, degen_tol,              \
                            stop_at_zero, smem, stream);                       \
  }

RELP_BATCH_PIVOT_ENTRY(relp_batch_pivot_resident, true)
RELP_BATCH_PIVOT_ENTRY(relp_batch_pivot_blocked, false)

// The shared memory a kernel (resident or blocked) asks for at (M, N) with
// R inverse rows in it.
extern "C" long long relp_batch_pivot_smem_bytes(int M, int N, int R,
                                                 int resident) {
  const int threads = resident ? Launch<true>::kThreads : Launch<false>::kThreads;
  return static_cast<long long>(smem_bytes(make_shape(M, N, R, threads)));
}
