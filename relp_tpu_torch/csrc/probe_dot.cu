// Precision probe of f32 products on Hopper (sm_90a): three kernels that
// compute one (M, M) f32 product C = A B, or one outer product, in the ways
// a kernel of this port could.  relp_tpu_torch/tools/probe_dot_precision.py
// runs them and reports each one's error against an f64 product.
//
// Replaces the three Pallas kernels of scripts/probe_dot_precision.py, which
// asked whether a Pallas f32 dot on the TPU is single-pass bf16:
//   * probe_mma_kernel<false> (tf32) <- kernel (pl.pallas_call at :54), the default-
//     precision dot: here single-pass TF32 on the tensor cores (mma.sync
//     m16n8k8, inputs rounded to TF32's 10-bit mantissa), Hopper's
//     counterpart of a single-pass bf16 dot;
//   * probe_mma_kernel<true> (tf32x3) <- kernel_hi (:64), Precision.HIGHEST:
//     three TF32 products of the split inputs a = a_hi + a_lo (a_lo b_hi +
//     a_hi b_lo + a_hi b_hi) per 8-deep step, the steps added in f32 outside
//     the tensor core, whose accumulator truncates: about f32 accuracy;
//   * probe_outer_kernel (outer) <- kernel_outer (:74), the broadcast outer product
//     A[:, 0] B[0, :]: plain f32 multiplies, no tensor core.
// What bounds them: at M = 256 the product moves 768 KB for 34 MFLOP (three
// times that for 3xTF32), so device memory bounds it; the probe is about
// numbers, not speed: one warp per 16 x 8 tile of C, fragments read straight
// from device memory.
//
// C interface, loaded with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned out;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(out) : "f"(x));
  return out;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C = A B for row-major (M, M) A, B, C, M % 16 == 0; one warp per 16 x 8
// tile of C.  kSplit: the 3xTF32 product of the split inputs, each 8-deep
// step's three products summed by the tensor core and the steps by __fadd_rn.
template <bool kSplit>
__global__ void probe_mma_kernel(const float* __restrict__ A,
                                 const float* __restrict__ B, float* C, int M) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int tiles_n = M / 8;
  if (tile >= (M / 16) * tiles_n) return;
  const int row0 = (tile / tiles_n) * 16, col0 = (tile % tiles_n) * 8;
  const int g = lane >> 2, t = lane & 3;  // group and thread in group
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < M; k0 += 8) {
    // Fragment layouts of mma.m16n8k8 .tf32: A row-major, B column-major.
    const float af[4] = {A[size_t(row0 + g) * M + k0 + t],
                         A[size_t(row0 + g + 8) * M + k0 + t],
                         A[size_t(row0 + g) * M + k0 + t + 4],
                         A[size_t(row0 + g + 8) * M + k0 + t + 4]};
    const float bf[2] = {B[size_t(k0 + t) * M + col0 + g],
                         B[size_t(k0 + t + 4) * M + col0 + g]};
    unsigned a_hi[4], b_hi[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a_hi[i] = to_tf32(af[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) b_hi[i] = to_tf32(bf[i]);
    if (kSplit) {
      unsigned a_lo[4], b_lo[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a_lo[i] = to_tf32(af[i] - __uint_as_float(a_hi[i]));
#pragma unroll
      for (int i = 0; i < 2; ++i) b_lo[i] = to_tf32(bf[i] - __uint_as_float(b_hi[i]));
      float step[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(step, a_lo, b_hi);  // the small terms first
      mma_tf32(step, a_hi, b_lo);
      mma_tf32(step, a_hi, b_hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], step[i]);
    } else {
      mma_tf32(c, a_hi, b_hi);
    }
  }
  C[size_t(row0 + g) * M + col0 + 2 * t] = c[0];
  C[size_t(row0 + g) * M + col0 + 2 * t + 1] = c[1];
  C[size_t(row0 + g + 8) * M + col0 + 2 * t] = c[2];
  C[size_t(row0 + g + 8) * M + col0 + 2 * t + 1] = c[3];
}

// C[i, j] = A[i, 0] B[0, j].
__global__ void probe_outer_kernel(const float* __restrict__ A,
                                   const float* __restrict__ B, float* C, int M) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= size_t(M) * M) return;
  const int i = int(e / M), j = int(e % M);
  C[e] = __fmul_rn(A[size_t(i) * M], B[j]);
}

}  // namespace

extern "C" int relp_probe_dot(int kind, const void* A, const void* B, void* C,
                              int M, void* stream) {
  if (M < 16 || M % 16 != 0 || kind < 0 || kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  float* c = static_cast<float*>(C);
  const int tiles = (M / 16) * (M / 8);
  const int blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (kind == 0) {
    probe_mma_kernel<false><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(a, b, c, M);
  } else if (kind == 1) {
    probe_mma_kernel<true><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(a, b, c, M);
  } else {
    const int threads = 256;
    const int grid = int((size_t(M) * M + threads - 1) / threads);
    probe_outer_kernel<<<grid, threads, 0, s>>>(a, b, c, M);
  }
  return static_cast<int>(cudaGetLastError());
}
