// Precision probe of f32 products on Hopper (sm_90a): three kernels that
// compute one (M, M) f32 product C = A B, or one outer product, in the ways
// a kernel of this port could.  relp_tpu_torch/tools/probe_dot_precision.py
// runs them and holds each against its plain version (probe_dot_reference).
//
// Replaces the three Pallas kernels of scripts/probe_dot_precision.py, which
// asked whether a Pallas f32 dot on the TPU is single-pass bf16:
//   * probe_mma_kernel<false> (tf32) <- kernel (pl.pallas_call at :54), the
//     default-precision dot: here single-pass TF32 on the tensor cores
//     (wgmma, inputs rounded to TF32's 10-bit mantissa with cvt.rna),
//     Hopper's counterpart of a single-pass bf16 dot;
//   * probe_mma_kernel<true> (tf32x3) <- kernel_hi (:64), Precision.HIGHEST:
//     the split inputs a = a_hi + a_lo, with a_lo b_hi + a_hi b_lo summed in
//     one accumulator and a_hi b_hi in another, added once in f32 at the
//     end: about f32 accuracy (a_lo b_lo dropped);
//   * probe_outer_kernel (outer) <- kernel_outer (:74), the broadcast outer
//     product A[:, 0] B[0, :]: plain f32 multiplies, no tensor core, with
//     subnormals flushed as XLA's CPU multiply flushes them.
//
// What bounds the outer product: its M^2 f32 stores (M = 4,096: 67.1 MB,
// more than L2, 20.0 us at 3.35 TB/s), and below M of about 1,000 the
// launch and one round trip for A[i, 0] and B[0, j].  Its design: each
// thread keeps its float4 of B's row in registers, loads A[i, 0] of four
// of its rows at once, a batch ahead, and writes C with 16-byte streaming
// stores; the grid walks C's rows together, in several waves of blocks at
// large M, one row a thread at small M; no division.
//
// What bounds the two matrix products: at M = 256 one moves 768 KB for 34 MFLOP (101
// for 3xTF32), 0.23 us at 3.35 TB/s, below the cost of a launch: latency,
// not work.  The design takes one round trip to L2 per CTA and chunk, not
// one per 8-deep step:
//   * a 64 x 64 tile of C per CTA of one warpgroup, K split over a cluster
//     of up to 4 CTAs (64 CTAs at M = 256), each CTA's K-slice walked in
//     64-wide chunks (one at M <= 256);
//   * the chunk's 64 x 64 boxes of A and B come in by two TMA copies
//     (tensor maps made on the host through the runtime's driver entry
//     point, no libcuda link), completing on one mbarrier;
//   * one pass in shared memory rounds every element once (cvt.rna; for
//     3xTF32 also the split) into wgmma's K-major no-swizzle layout, B
//     transposed on the way (wgmma takes TF32 operands K-major only), so
//     wgmma never sees raw f32 bits (it would truncate them);
//   * wgmma.mma_async m64n64k8 from shared memory, accumulators in
//     registers;
//   * the K-slices' partial sums reduce-scattered through distributed
//     shared memory: rank q owns a quarter of the tile's rows, every rank
//     writes its partial sums of them into rank q's slots, one cluster
//     barrier, then rank q sums its slots in rank order 0, 1, 2, 3 and
//     stores with 16-byte coalesced stores: no atomics, the same bits on
//     every launch.
// Kept from the tilings timed on the H100 (PERF.md): the split K over 4
// CTAs; 2 or 1 (fewer CTAs, more chunks each in turn) are slower.
//
// C interface, loaded with ctypes; every entry returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;      // rows and columns of a CTA's tile of C
constexpr int kChunk = 64;     // K per pass through shared memory
constexpr int kThreads = 128;  // one warpgroup
constexpr int kMaxSplit = 4;   // K-slices of a tile: CTAs of a cluster
constexpr int kOperandFloats = kTile * kChunk;
constexpr int kOperandBytes = kOperandFloats * 4;  // 16 KB
// wgmma's K-major layout without swizzle: core matrices of 8 rows x 16
// bytes (4 tf32) stored as 128 contiguous bytes; the core matrices next in
// K are kLbo bytes on, the next 8 rows kSbo bytes on.
constexpr int kLbo = 128;
constexpr int kSbo = (kChunk / 4) * kLbo;
// Row stride (floats) of the partial sums that the cluster reduces.
constexpr int kPartialStride = kTile + 8;
// Shared memory: the raw chunk of A and B, then the rounded operands
// (hi A, hi B and for 3xTF32 lo A, lo B), then the partial sums of the
// CTA's rows of the tile (split slots of 64 / split rows), then the
// mbarrier.
__host__ __device__ constexpr int operand_bytes(bool split) {
  return (split ? 6 : 4) * kOperandBytes;
}
__host__ __device__ constexpr int smem_bytes(bool split) {
  return operand_bytes(split) + kTile * kPartialStride * 4 + 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t out;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(out) : "f"(x));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The box of map at (column x, row y) into shared memory, completing on bar.
__device__ __forceinline__ void tma_copy(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
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

// Descriptor of a K-major operand without swizzle at p (16-byte aligned).
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(kLbo >> 4) << 16) |
         (uint64_t(kSbo >> 4) << 32);  // base offset 0, layout 0: no swizzle
}

// d += A B for one 64 x 8 (A) by 8 x 64 (B) step, both K-major in shared
// memory.  d[4j + i]: row 16 warp + lane / 4 + 8 (i / 2), column 8 j + 2
// (lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Rounds four f32 values that are consecutive in K into 16-byte unit u of
// hi (and of lo: the rounded remainder).
template <bool kSplit>
__device__ __forceinline__ void put(uint4* hi, uint4* lo, int u, float4 v) {
  const uint4 h = {to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w)};
  hi[u] = h;
  if (kSplit) {
    lo[u] = {to_tf32(__fsub_rn(v.x, __uint_as_float(h.x))),
             to_tf32(__fsub_rn(v.y, __uint_as_float(h.y))),
             to_tf32(__fsub_rn(v.z, __uint_as_float(h.z))),
             to_tf32(__fsub_rn(v.w, __uint_as_float(h.w)))};
  }
}

// 16-byte unit of (row r, K-quad q) in the K-major no-swizzle layout.
__device__ __forceinline__ int unit(int r, int q) {
  return (r >> 3) * (kSbo / 16) + q * (kLbo / 16) + (r & 7);
}

// C = A B for row-major (M, M) A, B, C; M % (64 split) == 0.  Grid (split,
// M / 64, M / 64) in clusters of (split, 1, 1): the cluster's CTAs share
// one 64 x 64 tile of C, each one K-slice of M / split.  tma_a and tma_b
// map A and B as (M, M) f32 in 64 x 64 boxes.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    probe_mma_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b, float* __restrict__ C, int M,
                     int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);  // A's chunk, then B's: 64 x 64 each
  uint4* hi_a = reinterpret_cast<uint4*>(smem + 2 * kOperandBytes);
  uint4* hi_b = hi_a + kOperandBytes / 16;
  uint4* lo_a = hi_b + kOperandBytes / 16;  // kSplit only
  uint4* lo_b = lo_a + kOperandBytes / 16;
  // The partial sums of this CTA's rows of the tile, one slot per rank.
  float* slots = reinterpret_cast<float*>(smem + operand_bytes(kSplit));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + smem_bytes(kSplit) - 16);

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x;
  const int row0 = blockIdx.z * kTile, col0 = blockIdx.y * kTile;
  const int slice = M / split;

  if (tid == 0) mbar_init(bar, 1);
  // Every CTA of the cluster has started before any writes into another's
  // shared memory: this arrival is waited for after the product.
  cluster_arrive_relaxed();
  __syncthreads();

  float hh[32], cross[32];  // hi hi, and (3xTF32) lo hi + hi lo
#pragma unroll
  for (int i = 0; i < 32; ++i) hh[i] = cross[i] = 0.f;

  for (int chunk = 0; chunk < slice / kChunk; ++chunk) {
    const int k0 = rank * slice + chunk * kChunk;
    if (tid == 0) {  // the chunk's 64 x 64 boxes of A and B
      mbar_expect_tx(bar, 2 * kOperandBytes);
      tma_copy(raw, &tma_a, k0, row0, bar);
      tma_copy(raw + kOperandFloats, &tma_b, col0, k0, bar);
    }
    mbar_wait(bar, chunk & 1);

    // A: float4 (row m, K-quad q), 8 lanes on 8 rows and 8 quads at once
    // (a diagonal), so neither the reads nor the writes meet in a bank.
    const float4* raw_a = reinterpret_cast<const float4*>(raw);
#pragma unroll
    for (int pass = 0; pass < 8; ++pass) {
      const int i = tid & 7, rest = tid >> 3;
      const int m = (rest >> 1) * 8 + i, q = ((i + pass) & 7) + 8 * (rest & 1);
      put<kSplit>(hi_a, lo_a, unit(m, q), raw_a[m * (kChunk / 4) + q]);
    }
    // B, transposed: column n of the chunk becomes row n, K-major.
    const float* raw_b = raw + kOperandFloats;
#pragma unroll
    for (int pass = 0; pass < 8; ++pass) {
      const int n = tid & 63, q = 2 * pass + (tid >> 6);
      const float4 v = {raw_b[(4 * q) * kTile + n], raw_b[(4 * q + 1) * kTile + n],
                        raw_b[(4 * q + 2) * kTile + n], raw_b[(4 * q + 3) * kTile + n]};
      put<kSplit>(hi_b, lo_b, unit(n, q), v);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int step = 0; step < kChunk / 8; ++step) {
      const int u = step * 2 * (kLbo / 16);  // two core matrices of K per step
      if (kSplit) {
        wgmma_tf32(cross, make_desc(lo_a + u), make_desc(hi_b + u));
        wgmma_tf32(cross, make_desc(hi_a + u), make_desc(lo_b + u));
      }
      wgmma_tf32(hh, make_desc(hi_a + u), make_desc(hi_b + u));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();  // the buffers are free for the next chunk
  }

  // Reduce-scatter over the cluster: rank q owns rows [q rows, (q + 1)
  // rows) of the tile, and every rank writes its partial sums of those rows
  // into slot (its rank) of rank q's shared memory.  Warp w holds rows
  // [16 w, 16 w + 16), all of one owner's.
  cluster_wait();  // every CTA has started
  const int rows = kTile / split;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int owner = 16 * warp / rows;
  float* slot = cg::this_cluster().map_shared_rank(slots, owner) +
                (rank * rows + 16 * warp - owner * rows) * kPartialStride;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = kSplit ? __fadd_rn(cross[4 * j + i], hh[4 * j + i]) : hh[4 * j + i];
    }
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(slot + g * kPartialStride + c) = make_float2(p[0], p[1]);
    *reinterpret_cast<float2*>(slot + (g + 8) * kPartialStride + c) = make_float2(p[2], p[3]);
  }
  cluster_arrive();  // release this CTA's partial sums
  cluster_wait();    // every slot of this CTA is written; none is written again

  // Sum the owned rows over the slots, ranks in order, and store them with
  // 16-byte coalesced stores.
  for (int e = tid; e < rows * (kTile / 4); e += kThreads) {
    const int r = e / (kTile / 4), c = 4 * (e % (kTile / 4));
    float4 s = *reinterpret_cast<const float4*>(slots + r * kPartialStride + c);
    for (int q = 1; q < split; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(slots + (q * rows + r) * kPartialStride + c);
      s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                      __fadd_rn(s.w, v.w));
    }
    *reinterpret_cast<float4*>(C + size_t(row0 + rank * rows + r) * M + col0 + c) = s;
  }
}

// The outer product's arithmetic is XLA's f32 multiply on the CPU, where
// the JAX probe's kernel_outer runs: a subnormal input reads as zero
// (daz), and a product below 2^-126 after rounding with an unbounded
// exponent becomes zero (ftz_mul), signs kept.
__device__ __forceinline__ float daz(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.f, x) : x;
}

// fl(a b), flushed; a_scaled = a 2^64 (exact, or inf where a b is far from
// tiny).  fl(a_scaled b) is the product rounded with an unbounded exponent,
// scaled by 2^64, wherever a b could be tiny.
__device__ __forceinline__ float ftz_mul(float a, float a_scaled, float b) {
  const float p = __fmul_rn(a, b);
  return fabsf(__fmul_rn(a_scaled, b)) < 0x1p-62f ? copysignf(0.f, p) : p;
}

__device__ __forceinline__ float4 outer4(float a, float a_scaled, float4 b) {
  return make_float4(ftz_mul(a, a_scaled, b.x), ftz_mul(a, a_scaled, b.y),
                     ftz_mul(a, a_scaled, b.z), ftz_mul(a, a_scaled, b.w));
}

constexpr int kOuterThreads = 256;  // most threads of a block; one float4 of B's row each
constexpr int kOuterRows = 4;       // rows whose A[i, 0] a thread loads at once
constexpr int kOuterBlocksPerSm = 32;

// C[i, j] = A[i, 0] B[0, j] (flushed as above) for row-major (M, M) A, B,
// C, V = M / 4.  A row of C is V float4s, cut into chunks of W = min(V,
// 256); a block of (W, R) threads runs R rows at once (R = 256 / W),
// thread (x, y) on float4 x of the chunk in row y.  The grid is (chunks,
// strips), and the rows are grid-strided: the grid's stores move through C
// together, as a fill's do.  Each thread loads its float4 of B's row once
// and keeps it in registers, loads A[i, 0] of kOuterRows of its rows at
// once, a batch ahead of the rows it stores (the first batch in flight
// with B's load; a warp's threads on one row share each load), and stores
// each row's float4 with a streaming store: no shared memory, no barrier,
// no division.  Where the grid covers C at one row a thread (small M) a
// thread loads and stores its one row alone, 0.08 us sooner on an H100 at
// M = 256 than the batched loop (PERF.md), which fills C at larger M.
__global__ void __launch_bounds__(kOuterThreads)
    probe_outer_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ C, int M, int V) {
  const int R = blockDim.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;  // this thread's float4 of a row
  const bool active = c < V;
  float4 b = active ? reinterpret_cast<const float4*>(B)[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  const int step = int(gridDim.y) * R;  // rows from one of a thread's rows to its next
  int r0 = blockIdx.y * R + threadIdx.y;
  if (step >= M) {  // at most one row a thread
    const float a0 = active && r0 < M ? A[size_t(r0) * M] : 0.f;
    b = make_float4(daz(b.x), daz(b.y), daz(b.z), daz(b.w));
    if (active && r0 < M) {
      const float a = daz(a0);
      __stcs(reinterpret_cast<float4*>(C) + size_t(r0) * V + c,
             outer4(a, __fmul_rn(a, 0x1p64f), b));
    }
    return;
  }
  const auto load = [&](float (&a)[kOuterRows], int first) {
#pragma unroll
    for (int j = 0; j < kOuterRows; ++j) {
      const int r = first + j * step;
      a[j] = active && r < M ? A[size_t(r) * M] : 0.f;
    }
  };
  float a[kOuterRows], next[kOuterRows] = {};
  load(a, r0);
  b = make_float4(daz(b.x), daz(b.y), daz(b.z), daz(b.w));
  for (; r0 < M; r0 += kOuterRows * step) {
    if (r0 + kOuterRows * step < M) load(next, r0 + kOuterRows * step);
#pragma unroll
    for (int j = 0; j < kOuterRows; ++j) {
      const int r = r0 + j * step;
      const float aj = daz(a[j]);
      if (active && r < M) {
        __stcs(reinterpret_cast<float4*>(C) + size_t(r) * V + c,
               outer4(aj, __fmul_rn(aj, 0x1p64f), b));
      }
      a[j] = next[j];
    }
  }
}

// Does nothing: its time is the floor under every kernel's.
__global__ void probe_empty_kernel() {}

// map: row-major (M, M) f32 at p in 64 x 64 boxes, without swizzle.  The
// driver's encoder comes through the runtime, so nothing links libcuda.
cudaError_t encode_map(CUtensorMap* map, const float* p, int M) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {cuuint64_t(M), cuuint64_t(M)};
  const cuuint64_t strides[1] = {cuuint64_t(M) * 4};
  const cuuint32_t box[2] = {kChunk, kTile};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kSplit>
cudaError_t launch_mma(const float* a, const float* b, float* c, int M, int split,
                       cudaStream_t s) {
  static bool configured = false;  // once per process (the probe runs on one card)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_mma_kernel<kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kSplit));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap map_a, map_b;
  cudaError_t err = encode_map(&map_a, a, M);
  if (err == cudaSuccess) err = encode_map(&map_b, b, M);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, M / kTile, M / kTile);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(kSplit);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, probe_mma_kernel<kSplit>, map_a, map_b, c, M, split);
}

// The outer product's launch: kOuterRows rows a thread where that still
// leaves a block for every SM, else fewer; at most kOuterBlocksPerSm blocks
// an SM (4 waves of 8 at M = 4,096, which keeps the card's stores busy to
// the end where one wave leaves it waiting on its slowest blocks).  The SM
// count is the current card's, read at each launch.
cudaError_t launch_outer(const float* a, const float* b, float* c, int M, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int V = M / 4, W = std::min(V, kOuterThreads), R = kOuterThreads / W;
  const int chunks = (V + W - 1) / W, units = (M + R - 1) / R;
  const int strips = std::min({std::max(1, sms * kOuterBlocksPerSm / chunks), units,
                               std::max(sms / chunks, (units + kOuterRows - 1) / kOuterRows)});
  probe_outer_kernel<<<dim3(chunks, strips), dim3(W, R), 0, s>>>(a, b, c, M, V);
  return cudaSuccess;
}

}  // namespace

// kind 0 tf32, 1 tf32x3, 2 outer; (M, M) row-major f32, M a positive
// multiple of 64, every pointer 16-byte aligned.  split: the K-slices of a
// tile (1, 2 or 4, M % (64 split) == 0), or 0 for the largest of them.
extern "C" int relp_probe_dot_split(int kind, const void* A, const void* B, void* C, int M,
                                    int split, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (split == 0) {
    split = kMaxSplit;
    while (M % (kTile * split) != 0 && split > 1) split /= 2;
  }
  if (M < kTile || M % (kTile * split) != 0 || kind < 0 || kind > 2 ||
      (split != 1 && split != 2 && split != kMaxSplit) || !aligned(A) || !aligned(B) ||
      !aligned(C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  float* c = static_cast<float*>(C);
  cudaError_t err = cudaSuccess;
  if (kind == 0) {
    err = launch_mma<false>(a, b, c, M, split, s);
  } else if (kind == 1) {
    err = launch_mma<true>(a, b, c, M, split, s);
  } else {
    err = launch_outer(a, b, c, M, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int relp_probe_dot(int kind, const void* A, const void* B, void* C, int M,
                              void* stream) {
  return relp_probe_dot_split(kind, A, B, C, M, 0, stream);
}

// Dynamic shared memory of a launch of kind 0 or 1 (ptxas does not see it).
extern "C" int relp_probe_smem_bytes(int kind) { return smem_bytes(kind == 1); }

extern "C" int relp_probe_empty(void* stream) {
  probe_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
