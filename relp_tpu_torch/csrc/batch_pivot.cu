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
//   3. w = Binv a_q (one warp per row) and d_q = c_q - pi . a_q;
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
// What bounds it: per pivot one LP reads its (M, N) tableau once for the
// scan (M N 4 bytes) and its inverse two to three times (w, v, the update),
// and one block per LP runs on one SM, so a batch uses at most B of the
// card's 132 SMs and each SM is bound by the bandwidth one block can draw.
// What the design does about it:
//   * "resident" keeps the LP's (M, M) inverse and all vector state in
//     shared memory for the whole chunk (the TPU kernel's VMEM-resident
//     carry): the inverse never touches device memory between pivots.  That
//     needs about (M^2 + 8M + 5N) 4 bytes, so M <= 128 at the families'
//     widths under the 232,448-byte opt-in limit of a block;
//   * "blocked" keeps only the vector state in shared memory; the LP's
//     inverse stays in device memory and is updated in place.  In this
//     first version both variants read the tableau straight from device
//     memory (coalesced: a thread owns columns and walks the rows); the
//     TPU kernel's double-buffered tile stream (a cp.async ring here) is
//     later work.  A family's tableaus stay largely in the 50 MB L2 when
//     they fit.
//
// Numerics: IEEE division and no flush to zero (no --use_fast_math), since
// the Harris test compares quotients; the elementwise updates use _rn
// intrinsics so that no multiply-add is contracted and each matches the
// plain PyTorch version's two roundings.  Every reduction runs in a fixed
// order (warp shuffle trees, then one warp over the warp partials), no
// atomics: two launches give the same bits.
//
// C interface, loaded with ctypes; every entry returns cudaGetLastError()
// (a launch refused for too much shared memory never runs).

#include <climits>
#include <math.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRedWords = 128;  // reduction scratch: 32 partials, 32 indices, slots
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRunning = 0;
constexpr int kOptimal = 1;
constexpr int kUnbounded = 2;

static_assert(kWarps == 32, "the second reduction stage is one warp");

// Shared memory of one block; relp_tpu_torch/ops/batch_pivot.py::smem_bytes
// computes the same number.
size_t smem_bytes(int M, int N, bool resident) {
  const size_t words = (resident ? size_t(M) * M : 0) + 8 * size_t(M) +
                       3 * size_t(N) + kRedWords;
  const size_t bytes = 4 * words + 2 * size_t(N);
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
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_sum(red[lane]);
    if (lane == 0) red[64] = s;
  }
  __syncthreads();
  const float out = red[64];
  __syncthreads();
  return out;
}

__device__ float block_min(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_min(red[lane]);
    if (lane == 0) red[64] = s;
  }
  __syncthreads();
  const float out = red[64];
  __syncthreads();
  return out;
}

// Index of the best (score, index) pair; INT_MAX when no thread had one.
__device__ int block_argmax(float s, int i, float* red) {
  int* redi = reinterpret_cast<int*>(red + 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(s, i);
  if (lane == 0) {
    red[warp] = s;
    redi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    s = red[lane];
    i = redi[lane];
    warp_argmax(s, i);
    if (lane == 0) redi[33] = i;
  }
  __syncthreads();
  const int out = redi[33];
  __syncthreads();
  return out;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
batch_pivot_kernel(const float* __restrict__ A, const float* __restrict__ c,
                   const unsigned char* __restrict__ cand, float* Binv_all,
                   float* xB_all, float* pi_all, int* basis_all,
                   unsigned char* inb_all, float* gamma_all, int* status_all,
                   int* iter_all, int* degen_all, int M, int N, int chunk,
                   float opt_tol, float pivot_tol, float degen_tol,
                   int stop_at_zero) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // A frozen LP: the outputs already hold its state.
  if (status_all[b] != kRunning) return;

  extern __shared__ __align__(16) unsigned char smem[];
  float* p = reinterpret_cast<float*>(smem);
  float* sBinv = p;
  if (kResident) p += size_t(M) * M;
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
  unsigned char* scand = reinterpret_cast<unsigned char*>(p);
  unsigned char* sinb = scand + N;

  const float* Ab = A + size_t(b) * M * N;
  float* Bg = Binv_all + size_t(b) * M * M;
  // The working inverse: shared memory (resident) or device memory (blocked,
  // updated in place; never read through the read-only path).
  float* Binv = kResident ? sBinv : Bg;

  if (kResident) {
    for (size_t e = tid; e < size_t(M) * M; e += kThreads) sBinv[e] = Bg[e];
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
  __syncthreads();
  for (int i = tid; i < M; i += kThreads) scB[i] = sc[sbasis[i]];
  // Chunk-entry reduced costs d = c - pi A.
  for (int j = tid; j < N; j += kThreads) {
    const float* a = Ab + j;
    float s = 0.f;
    for (int i = 0; i < M; ++i) s = fmaf(spi[i], a[size_t(i) * N], s);
    sd[j] = __fsub_rn(sc[j], s);
  }
  __syncthreads();

  int status = kRunning;
  int iter = iter_all[b];
  int degen = degen_all[b];
  for (int k = 0; k < chunk; ++k) {
    if (stop_at_zero) {
      float part = 0.f;
      for (int i = tid; i < M; i += kThreads) part += __fmul_rn(scB[i], sxB[i]);
      if (!(block_sum(part, red) > 1e-9f)) break;
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
    q = block_argmax(best, q, red);
    if (q == INT_MAX) {
      status = kOptimal;
      break;
    }

    // 2. the entering column.
    for (int i = tid; i < M; i += kThreads) saq[i] = Ab[size_t(i) * N + q];
    __syncthreads();

    // 3. FTRAN w = Binv a_q, one warp per row; d_q = c_q - pi . a_q.
    for (int i = warp; i < M; i += kWarps) {
      const float* row = Binv + size_t(i) * M;
      float s = 0.f;
      for (int kk = lane; kk < M; kk += 32) s = fmaf(row[kk], saq[kk], s);
      s = warp_sum(s);
      if (lane == 0) sw[i] = s;
    }
    float part = 0.f;
    for (int i = tid; i < M; i += kThreads) part = fmaf(spi[i], saq[i], part);
    const float c_q = sc[q];
    const float d_q = __fsub_rn(c_q, block_sum(part, red));  // syncs: sw done

    // 4. Harris two-pass ratio test.
    float tmin = INFINITY;
    int positive = 0;
    for (int i = tid; i < M; i += kThreads) {
      const float wi = sw[i];
      if (wi > pivot_tol) {
        positive = 1;
        const float xe = fmaxf(sxB[i], 0.f);
        const float delta = __fmul_rn(1e-7f, __fadd_rn(1.f, xe));
        tmin = fminf(tmin, __fdiv_rn(__fadd_rn(xe, delta), wi));
      }
    }
    const int any_positive = __syncthreads_or(positive);
    const float theta = block_min(tmin, red);
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
    r = block_argmax(wbest, r, red);

    // 5. status.
    if (!any_positive || r == INT_MAX) {
      status = kUnbounded;
      break;
    }

    // 6. rho and v from the OLD inverse, then the product-form update.
    const float w_r = sw[r];
    const float t = __fdiv_rn(fmaxf(sxB[r], 0.f), w_r);
    const int leaving = sbasis[r];
    for (int kk = tid; kk < M; kk += kThreads) {
      srho[kk] = __fdiv_rn(Binv[size_t(r) * M + kk], w_r);
      float s = 0.f;
      for (int i = 0; i < M; ++i) s = fmaf(sw[i], Binv[size_t(i) * M + kk], s);
      sv[kk] = s;
    }
    part = 0.f;
    for (int i = tid; i < M; i += kThreads) part = fmaf(sw[i], sw[i], part);
    const float gq = __fadd_rn(1.f, block_sum(part, red));  // syncs: rho, v done
    for (int i = warp; i < M; i += kWarps) {
      float* row = Binv + size_t(i) * M;
      const float wi = sw[i];
      for (int kk = lane; kk < M; kk += 32) {
        row[kk] = (i == r) ? srho[kk] : __fsub_rn(row[kk], __fmul_rn(wi, srho[kk]));
      }
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
    for (int j = tid; j < N; j += kThreads) {
      const float* a = Ab + j;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < M; ++i) {
        const float x = a[size_t(i) * N];
        s0 = fmaf(spi[i], x, s0);
        s1 = fmaf(sv[i], x, s1);
        s2 = fmaf(srho[i], x, s2);
      }
      sd[j] = __fsub_rn(sc[j], s0);
      float g;
      if (j == q) {
        g = 1.f;
      } else if (j == leaving) {
        g = fmaxf(__fdiv_rn(gq, __fmul_rn(w_r, w_r)), 1.f);
      } else {
        const float a2 = __fmul_rn(s2, s2);
        g = __fadd_rn(__fsub_rn(sg[j], __fmul_rn(__fmul_rn(2.f, s2), s1)),
                      __fmul_rn(a2, gq));
        const float lo = __fadd_rn(1.f, a2);
        g = (g >= lo || g != g) ? g : lo;  // torch.maximum: NaN propagates
      }
      sg[j] = g;
    }
    if (tid == 0) {
      sinb[leaving] = 0;
      sinb[q] = 1;
    }
    __syncthreads();

    // 8. counters.
    iter += 1;
    degen = (t <= degen_tol) ? degen + 1 : 0;
  }

  if (kResident) {
    for (size_t e = tid; e < size_t(M) * M; e += kThreads) Bg[e] = sBinv[e];
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
int launch(const void* A, const void* c, const void* cand, void* Binv, void* xB,
           void* pi, void* basis, void* inb, void* gamma, void* status,
           void* iteration, void* degen, int B, int M, int N, int chunk,
           float opt_tol, float pivot_tol, float degen_tol, int stop_at_zero,
           int smem, void* stream) {
  const size_t need = smem_bytes(M, N, kResident);
  if (B < 1 || M < 1 || N < 1 || size_t(smem) != need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      batch_pivot_kernel<kResident>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  batch_pivot_kernel<kResident>
      <<<B, kThreads, need, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(A), static_cast<const float*>(c),
          static_cast<const unsigned char*>(cand), static_cast<float*>(Binv),
          static_cast<float*>(xB), static_cast<float*>(pi),
          static_cast<int*>(basis), static_cast<unsigned char*>(inb),
          static_cast<float*>(gamma), static_cast<int*>(status),
          static_cast<int*>(iteration), static_cast<int*>(degen), M, N, chunk,
          opt_tol, pivot_tol, degen_tol, stop_at_zero);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RELP_BATCH_PIVOT_ENTRY(NAME, RESIDENT)                                  \
  extern "C" int NAME(const void* A, const void* c, const void* cand,          \
                      void* Binv, void* xB, void* pi, void* basis, void* inb,  \
                      void* gamma, void* status, void* iteration, void* degen, \
                      int B, int M, int N, int chunk, float opt_tol,           \
                      float pivot_tol, float degen_tol, int stop_at_zero,      \
                      int smem, void* stream) {                                \
    return launch<RESIDENT>(A, c, cand, Binv, xB, pi, basis, inb, gamma,       \
                            status, iteration, degen, B, M, N, chunk, opt_tol, \
                            pivot_tol, degen_tol, stop_at_zero, smem, stream); \
  }

RELP_BATCH_PIVOT_ENTRY(relp_batch_pivot_resident, true)
RELP_BATCH_PIVOT_ENTRY(relp_batch_pivot_blocked, false)
