// Latency probe of a slot chain that makes the whole vector wait on each
// slot, on Hopper (sm_90a): what one slot costs when it does nothing but
// wait for the card.  relp_tpu_torch/tools/eta_ring_timing.py and
// chip_smoke.py's lu/kernel time it beside csrc/eta_ring.cu on the same
// ring.  Replaces no kernel and runs on no solver path.
//
// A pass that walks the live slots one after another in one block of 1,024
// threads, the whole vector updated at each slot, pays per slot at least
// one round trip to L2 for w_k and the block's barriers, whatever M.  The
// probe keeps exactly that and drops the arithmetic:
//
//   FTRAN chain, each live slot k:  every thread reads one element of w_k
//     (from L2: the row is new to the block's L1), at an index that depends
//     on the slot before; writes it to shared memory; one barrier.
//   BTRAN chain, each live slot k:  the same read; the warp's halving tree
//     of shuffles, one barrier, warp 0's tree, one barrier (a block-wide
//     dot's reduction, with no products).
//
// Its time at n live slots is the floor of that design under an n-slot
// pass, not the card's: csrc/eta_ring.cu runs the chain on n scalars in one
// warp instead, and its pass over the vector has no chain.
//
// C interface, loaded with ctypes; returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // eta_ring_timing.CHAIN_THREADS
constexpr int kWarps = kThreads / 32;

template <typename T, bool kBtran>
__global__ void __launch_bounds__(kThreads)
    slot_chain_kernel(const T* __restrict__ vals, const int* __restrict__ count, int K,
                      int M, T* out) {
  __shared__ T seen[kThreads];
  __shared__ T warp_sums[kWarps];
  __shared__ int link[2];  // slot k reads link[k & 1], writes the other
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = *count;
  const int n = c < 0 ? 0 : (c > K ? K : c);
  seen[tid] = T(0);
  if (tid < 2) link[tid] = 0;
  __syncthreads();
  T v = T(0);
  for (int k = 0; k < n; ++k) {
    // link is 0 unless a value read equals 7: the address hangs on the slot
    // before, and no compiler can prove it constant.
    int i = tid + link[k & 1];
    i = i < M ? i : i % M;
    v = vals[static_cast<size_t>(k) * M + i];
    if constexpr (kBtran) {
      T s = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) warp_sums[warp] = s;
      seen[tid] = v;
      __syncthreads();
      if (warp == 0) {
        T t = warp_sums[lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
        if (lane == 0) link[(k + 1) & 1] = t == T(7) ? 1 : 0;
      }
    } else {
      seen[tid] = v;
      if (tid == 0) link[(k + 1) & 1] = v == T(7) ? 1 : 0;
    }
    __syncthreads();
  }
  out[tid] = seen[(tid + 1) % kThreads];
}

template <typename T>
int launch(int btran, const void* vals, const void* count, int K, int M, void* out,
           void* stream) {
  if (K < 0 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto v = static_cast<const T*>(vals);
  const auto c = static_cast<const int*>(count);
  const auto o = static_cast<T*>(out);
  if (btran) {
    slot_chain_kernel<T, true><<<1, kThreads, 0, s>>>(v, c, K, M, o);
  } else {
    slot_chain_kernel<T, false><<<1, kThreads, 0, s>>>(v, c, K, M, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over the ring (K, M) row-major of element size ``itemsize``
// (4 or 8) and its live count; out holds 1,024 elements of that size.
extern "C" int relp_slot_chain(int itemsize, int btran, const void* vals,
                               const void* count, int K, int M, void* out,
                               void* stream) {
  switch (itemsize) {
    case 4: return launch<float>(btran, vals, count, K, M, out, stream);
    case 8: return launch<double>(btran, vals, count, K, M, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
