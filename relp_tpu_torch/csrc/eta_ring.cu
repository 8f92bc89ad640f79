// The LU engine's eta ring applied in one launch per pass, for Hopper
// (sm_90a): FTRAN and BTRAN through the live product-form etas.
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
// really bounds it is the chain of n dependent slots: each slot reads the
// result of the one before, so it costs one round trip to L2 for w_k and
// one block-wide barrier (two and a block reduction in BTRAN), whatever M.
// csrc/slot_chain.cu times that chain alone: on an H100 at 59 live slots,
// f32, about 17 us for FTRAN's and 29 us for BTRAN's.
//
// Design: one thread block of kThreads threads does the whole pass.
//   * The vector, the live rows and the pivots w_k[r_k] are staged in
//     shared memory (the "shared" launch): at K = 60 up to M = 14,400 in
//     f64 on the H100.  FTRAN keeps two copies of x and writes each slot's
//     result into the other one, so a slot needs one barrier; BTRAN updates
//     y[r] in place.  A vector too large for shared memory (the "global" launch)
//     lives in the output (and, for FTRAN, a scratch vector) in device
//     memory, rows and pivots read from the ring.  The shared launch is
//     the faster one: on an H100 at M = 1,920 and 59 live slots, FTRAN
//     takes about 40 us against 51 us, BTRAN 49 us against 53 us
//     (relp_tpu_torch/tools/eta_ring_timing.py).
//   * Each slot streams w_k from device memory (or L2): thread t takes
//     elements t, t + kThreads, ...
//   * Every operation is rounded on its own (__fmul_rn, __fsub_rn, ...; no
//     FMA contraction), as the plain version's separate torch kernels do,
//     so FTRAN gives the plain loop's bits.
//   * BTRAN's dot is summed in a fixed order: thread t adds its products
//     y[i] w[i] in order of i, from 0; each warp adds its lanes' sums by a
//     shuffle tree (lane l + lane l + 16, then + 8, 4, 2, 1); warp 0 adds
//     the 32 warps' sums by the same tree.  The plain version's ordered
//     twin (eta_btran_plain(..., order="kernel")) sums in this order, and
//     the kernel gives its bits.
//   * A live slot's row outside [0, M) traps (a CUDA error at the next
//     synchronisation), as an out-of-range index does in torch.
//
// C interface, loaded with ctypes; every entry returns a cudaError_t.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int kThreads = 1024;  // eta_ring.THREADS
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the block's tree adds 32 warps' sums in one warp");

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

// Shared memory of a "shared" launch: the pivots w_k[r_k] (K of T), the
// vector (FTRAN: two copies), then the rows (K ints).
template <typename T>
size_t smem_bytes(int K, int M, bool ftran) {
  return static_cast<size_t>(K) * sizeof(T) +
         static_cast<size_t>(ftran ? 2 : 1) * M * sizeof(T) +
         static_cast<size_t>(K) * sizeof(int);
}

// The live rows and pivots into shared memory (a "shared" launch).
template <typename T>
__device__ void stage_ring(const T* vals, const int* rows, int n, int M, T* piv_s,
                           int* rows_s) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int r = checked_row(rows[k], M);
    rows_s[k] = r;
    piv_s[k] = vals[static_cast<size_t>(k) * M + r];
  }
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
    eta_ftran_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
                     const int* __restrict__ count, const T* __restrict__ x, T* out,
                     T* scratch, int K, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n = live_slots(count, K);
  T* a;
  T* b;
  const T* piv_s = nullptr;
  const int* rows_s = nullptr;
  if constexpr (kShared) {
    T* piv = reinterpret_cast<T*>(smem);
    a = piv + K;
    b = a + M;
    int* r_s = reinterpret_cast<int*>(b + M);
    stage_ring(vals, rows, n, M, piv, r_s);
    piv_s = piv;
    rows_s = r_s;
  } else {
    a = out;
    b = scratch;
  }
  for (int i = tid; i < M; i += kThreads) a[i] = x[i];
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const T* w = vals + static_cast<size_t>(k) * M;
    int r;
    T wr;
    if constexpr (kShared) {
      r = rows_s[k];
      wr = piv_s[k];
    } else {
      r = checked_row(rows[k], M);
      wr = w[r];
    }
    const T f = div_rn(a[r], wr);
    for (int i = tid; i < M; i += kThreads) {
      b[i] = i == r ? f : sub_rn(a[i], mul_rn(f, w[i]));
    }
    __syncthreads();
    T* t = a;
    a = b;
    b = t;
  }
  // Each thread copies the elements it wrote itself.
  if (kShared || a != out) {
    for (int i = tid; i < M; i += kThreads) out[i] = a[i];
  }
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
    eta_btran_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
                     const int* __restrict__ count, const T* __restrict__ y, T* out,
                     int K, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = live_slots(count, K);
  T* a;
  const T* piv_s = nullptr;
  const int* rows_s = nullptr;
  if constexpr (kShared) {
    T* piv = reinterpret_cast<T*>(smem);
    a = piv + K;
    int* r_s = reinterpret_cast<int*>(a + M);
    stage_ring(vals, rows, n, M, piv, r_s);
    piv_s = piv;
    rows_s = r_s;
  } else {
    a = out;
  }
  for (int i = tid; i < M; i += kThreads) a[i] = y[i];
  __syncthreads();
  for (int k = n - 1; k >= 0; --k) {
    const T* w = vals + static_cast<size_t>(k) * M;
    T s = T(0);
    for (int i = tid; i < M; i += kThreads) s = add_rn(s, mul_rn(a[i], w[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s = add_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    }
    if (lane == 0) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
      T v = warp_sums[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = add_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      }
      if (lane == 0) {
        int r;
        T wr;
        if constexpr (kShared) {
          r = rows_s[k];
          wr = piv_s[k];
        } else {
          r = checked_row(rows[k], M);
          wr = w[r];
        }
        const T yr = a[r];
        a[r] = sub_rn(yr, div_rn(sub_rn(v, yr), wr));
      }
    }
    __syncthreads();
  }
  if constexpr (kShared) {
    for (int i = tid; i < M; i += kThreads) out[i] = a[i];
  }
}

// The largest dynamic shared memory of a block of ``kernel`` on this card,
// beside the kernel's static shared memory.
template <typename Kernel>
cudaError_t max_dynamic_smem(Kernel kernel, int* bytes) {
  int device = 0;
  int optin = 0;
  cudaFuncAttributes attrs = {};
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attrs, kernel);
  if (err != cudaSuccess) return err;
  *bytes = optin - static_cast<int>(attrs.sharedSizeBytes);
  return cudaSuccess;
}

// That largest size set as the kernel's limit, once per kernel and card
// (the attribute belongs to the current card's context: configured holds
// a bit per card ordinal, and a card past the 64th sets it on every
// launch), so that any launch up to it is taken.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, std::atomic<unsigned long long>* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (configured->load() & bit) return cudaSuccess;
  int bytes = 0;
  err = max_dynamic_smem(kernel, &bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured->fetch_or(bit);
  return err;
}

template <typename T>
int launch(bool ftran, const void* vals, const void* rows, const void* count,
           const void* x, void* out, void* scratch, int K, int M, int shared,
           void* stream) {
  if (K < 0 || M < 1 || (ftran && !shared && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto v = static_cast<const T*>(vals);
  const auto r = static_cast<const int*>(rows);
  const auto c = static_cast<const int*>(count);
  const auto in = static_cast<const T*>(x);
  const auto o = static_cast<T*>(out);
  cudaError_t err = cudaSuccess;
  if (ftran && shared) {
    static std::atomic<unsigned long long> configured{0};
    err = allow_shared(eta_ftran_kernel<T, true>, &configured);
    if (err == cudaSuccess) {
      eta_ftran_kernel<T, true><<<1, kThreads, smem_bytes<T>(K, M, true), s>>>(
          v, r, c, in, o, nullptr, K, M);
    }
  } else if (ftran) {
    eta_ftran_kernel<T, false><<<1, kThreads, 0, s>>>(v, r, c, in, o,
                                                      static_cast<T*>(scratch), K, M);
  } else if (shared) {
    static std::atomic<unsigned long long> configured{0};
    err = allow_shared(eta_btran_kernel<T, true>, &configured);
    if (err == cudaSuccess) {
      eta_btran_kernel<T, true><<<1, kThreads, smem_bytes<T>(K, M, false), s>>>(
          v, r, c, in, o, K, M);
    }
  } else {
    eta_btran_kernel<T, false><<<1, kThreads, 0, s>>>(v, r, c, in, o, K, M);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RELP_ETA_ENTRY(NAME, T, FTRAN)                                                    \
  extern "C" int NAME(const void* vals, const void* rows, const void* count,             \
                      const void* x, void* out, void* scratch, int K, int M, int shared, \
                      void* stream) {                                                     \
    return launch<T>(FTRAN, vals, rows, count, x, out, scratch, K, M, shared, stream);   \
  }

RELP_ETA_ENTRY(relp_eta_ftran_f32, float, true)
RELP_ETA_ENTRY(relp_eta_ftran_f64, double, true)
RELP_ETA_ENTRY(relp_eta_btran_f32, float, false)
RELP_ETA_ENTRY(relp_eta_btran_f64, double, false)

// Dynamic shared memory of a "shared" launch, by element size; -1 for
// another size.
extern "C" long long relp_eta_ring_smem_bytes(int itemsize, int K, int M, int ftran) {
  switch (itemsize) {
    case 4: return static_cast<long long>(smem_bytes<float>(K, M, ftran != 0));
    case 8: return static_cast<long long>(smem_bytes<double>(K, M, ftran != 0));
    default: return -1;
  }
}

// The largest dynamic shared memory of a "shared" launch on this card, by
// element size; a negative cudaError_t on failure, -1 for another size.
extern "C" long long relp_eta_ring_max_smem(int itemsize, int ftran) {
  int bytes = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (itemsize == 4) {
    err = ftran ? max_dynamic_smem(eta_ftran_kernel<float, true>, &bytes)
                : max_dynamic_smem(eta_btran_kernel<float, true>, &bytes);
  } else if (itemsize == 8) {
    err = ftran ? max_dynamic_smem(eta_ftran_kernel<double, true>, &bytes)
                : max_dynamic_smem(eta_btran_kernel<double, true>, &bytes);
  } else {
    return -1;
  }
  return err == cudaSuccess ? bytes : -static_cast<long long>(err);
}
