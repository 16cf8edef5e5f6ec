// K4: the lane-packing matmul study, chained bf16 products with an fp32
// accumulator, on Hopper's warpgroup MMA (wgmma).
//
// Replaces the Pallas TPU kernel scripts/bench_lane_packing.py::_mm_kernel.
// For a (m, k) fp32 and w (k, n) bf16 it computes, per row, from acc = 0,
// `reps` times acc = (bf16(a) @ w) * 1e-4 + acc * 0.5 in fp32, then
// o = a * 0.999 + 1e-7 * rowsum(acc). The product is the same every time;
// the study is how fast the tensor cores take it at each GEMM shape, so
// every one of the `reps` products is issued (the wgmma is volatile asm).
// The Pallas kernel reads its accumulator scratch before writing it; this
// kernel starts from zero, which is what the TPU's result equals at the
// script's grid (a finite start weighs 2^-(8 grid) at the end).
//
// Bound: the 2 m k n reps operations at 989 TFLOP/s dense bf16 (about
// 0.11-0.45 ms for the bench's 512 products at m = 9216); the bytes (a and o
// in fp32, w, acc) take a few microseconds. Compute-bound, and wgmma is the
// only path to the tensor cores' full rate.
//
// Design. Rows are independent, so a CTA owns 64 rows (one wgmma M) and NC
// columns, NC the case's n rounded up to 8 unless the plan splits the
// columns over CTAs (ops/cuda/lane_packing.py::tile_plan, which this file's
// constants mirror). One consumer warpgroup issues, per k-step of 16,
// wgmma.mma_async m64nNCk16 with A and B by shared-memory descriptor: one
// instruction covers every column of the CTA. A's 64 x kp tile is converted
// to bf16 once a CTA into shared memory and stays there. When the whole W
// slice fits beside it, W is copied in once too ("resident") and each
// product is one commit group of wgmma with no barrier; when it does not,
// W's k-chunks stream from L2 every product ("streamed") through a ring
// filled by cp.async.bulk from a producer warp, with an mbarrier pair a
// stage, a chunk's stage released two chunks later. The k-steps go round C
// accumulator chains (C by width, FSE_K4_WIDTHS), so that a wgmma need not
// wait for the one before it. The consumers' control flow is uniform to the
// compiler (the role from a __shfl_sync, arrivals predicated inside the asm,
// no wgmma under a condition): where ptxas cannot prove a path uniform it
// serializes every wgmma (its C7520 warning), which the first build of this
// design did. One accumulator for acc: the rep's products accumulate
// straight into D = 5000 acc (chain 0, scale-d = 1; the other chains are
// added in at the end of the product), then D *= 0.5 gives the next rep's
// 5000 acc, and after the last rep D * 1e-4 is acc: (5000 acc + p) * 1e-4 =
// 0.5 acc + 1e-4 p, with other rounding (held to 1e-3 of max|acc|). A
// second small kernel takes the row sums (one warp a row, a fixed order)
// and writes o.
//
// Shared-memory layouts (both operands K-major, 32-byte swizzle): a k-step
// of an operand is a block of rows x 32 bytes (16 bf16 of K a row), row r's
// two 16-byte halves h at r * 32 + ((h ^ ((r >> 2) & 1)) << 4), blocks at
// 256-byte aligned addresses. The descriptor: start address, leading byte
// offset 16 (unused with a swizzle), stride byte offset 256 (the next 8
// rows), layout type 3 (32-byte swizzle). W's image in device memory is
// these bytes already (prepare_weight), [column slice][k-step][NC rows][16],
// so a chunk is one contiguous bulk copy.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The launches
// go on the caller's stream, never synchronise and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_ops.cuh"

namespace {

constexpr int BM = 64;                  // rows a CTA: one wgmma M
constexpr int CONSUMERS = 128;          // one warpgroup
constexpr int THREADS = CONSUMERS + 32; // and one producer warp
constexpr int SLACK = 256;              // to align the dynamic shared memory
constexpr int KSTEP_ROW_BYTES = 32;     // 16 bf16 of K
constexpr int A_KSTEP_BYTES = BM * KSTEP_ROW_BYTES;
constexpr int SBO_BYTES = 8 * KSTEP_ROW_BYTES;  // the next 8 rows
constexpr int LBO_BYTES = 16;  // unused with a swizzle
constexpr uint64_t LAYOUT_TYPE = 3;  // 32-byte swizzle
// byte offset of row r's 16-byte half h in a k-step block
__host__ __device__ inline int row_offset(int r, int h) {
  return r * KSTEP_ROW_BYTES + ((h ^ ((r >> 2) & 1)) << 4);
}

// k-steps of W the ring holds: all ks when resident (one chunk of ks)
__host__ __device__ inline int ring_ksteps(int ks, int kc, int stages) {
  return stages * kc < ks ? stages * kc : ks;
}

// dynamic shared memory of a CTA (ops/cuda/lane_packing.py's _smem)
__host__ __device__ inline int smem_bytes(int ks, int nc, int kc, int stages) {
  return SLACK + ks * A_KSTEP_BYTES + ring_ksteps(ks, kc, stages) * nc * KSTEP_ROW_BYTES +
         16 * stages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// matrix descriptor of a K-major operand block at addr
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO_BYTES >> 4) << 16) |
         ((uint64_t)(SBO_BYTES >> 4) << 32) | (LAYOUT_TYPE << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// arrive from the threads whose `leader` is 0 (a predicate in the asm, not a
// branch around it: the consumers' code has no divergent path for ptxas)
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, int leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(leader)
      : "memory");
}

// the producer's wait until the barrier's phase of this parity has
// completed; a phase that has not completed after about 2^34 cycles
// (seconds) ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// the consumers' wait: the loop inside the asm (a stalled consumer leaves
// the producer stalled too, which traps)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving the accumulators across the async window
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NC, int C>
__global__ void __launch_bounds__(THREADS, 1)
lane_packing_kernel(const float* __restrict__ a, const unsigned char* __restrict__ wimg,
                    float* __restrict__ acc_out, int m, int k, int n, int ks, int kc,
                    int stages, int resident, int reps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + SLACK - 1) & ~(uint32_t)(SLACK - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t a_s = base;
  const uint32_t w_s = a_s + ks * A_KSTEP_BYTES;
  const int stage_bytes = kc * NC * KSTEP_ROW_BYTES;
  const uint32_t full = w_s + ring_ksteps(ks, kc, stages) * NC * KSTEP_ROW_BYTES;
  const uint32_t empty = full + 8 * stages;
  const int row0 = blockIdx.x * BM;
  const int nchunks = (ks + kc - 1) / kc;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A tile, rounded to bf16 (nearest even), 16 bytes (8 k) a unit; zeros
  // past m and k
  for (int u = threadIdx.x; u < BM * ks * 2; u += THREADS) {
    const int r = u / (ks * 2);
    const int q = u - r * ks * 2;  // 2 * k-step + half
    const int c0 = q * 8;
    const int row = row0 + r;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = (row < m && c0 + e < k) ? a[(size_t)row * k + c0 + e] : 0.f;
    const uint4 pk = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    *reinterpret_cast<uint4*>(smem + (q >> 1) * A_KSTEP_BYTES + row_offset(r, q & 1)) = pk;
  }
  const unsigned char* wsrc = wimg + (size_t)blockIdx.y * ks * NC * KSTEP_ROW_BYTES;
  if (resident) {  // all of W's slice, once, by every thread
    const uint4* src = reinterpret_cast<const uint4*>(wsrc);
    uint4* dst = reinterpret_cast<uint4*>(smem + ks * A_KSTEP_BYTES);
    for (int i = threadIdx.x; i < ks * NC * KSTEP_ROW_BYTES / 16; i += THREADS) dst[i] = src[i];
  }
  // the generic proxy's stores, before the async proxy (wgmma) reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the role, warp-uniform to the compiler: a branch it cannot prove uniform
  // makes it serialize the wgmma
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / CONSUMERS, 0);
  const int lane = threadIdx.x & 31;
  if (role == 1) {  // the producer warp: the ring, when W streams
    if (!resident && lane == 0) {
      for (int g = 0; g < reps * nchunks; ++g) {
        const int c = g % nchunks, st = g % stages;
        if (g >= stages) mbar_wait_or_trap(empty + 8 * st, (g / stages - 1) & 1);
        const int s0 = c * kc;
        const int bytes = min(kc, ks - s0) * NC * KSTEP_ROW_BYTES;
        mbar_expect_tx(full + 8 * st, bytes);
        bulk_copy(w_s + st * stage_bytes, wsrc + (size_t)s0 * NC * KSTEP_ROW_BYTES, bytes,
                  full + 8 * st);
      }
    }
    return;
  }

  // C independent accumulator chains: a wgmma that adds into the registers
  // the previous one wrote waits for it, so one chain can leave the tensor
  // core idle at small N; a chunk's k-steps go round the chains in groups
  // of C (the plan's chunks hold at least C), the rest into chain 0; chain 0
  // carries D, the others start each product from zero (scale-d = 0)
  float acc[C][NC / 2];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[c][i] = 0.f;
  const uint64_t da0 = descriptor(a_s);
  const uint64_t db0 = descriptor(w_s);
  // resident: one chunk, all of W; streamed: a chunk's stage is released
  // `lag` chunks later, so that lag chunks of products stay in flight (the
  // ring needs lag + 2 stages)
  const int lag = min(stages - 2, 2);
  int g = 0, rel = 0;
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int c = 0; c < C; ++c) fence_acc(acc[c]);
    for (int ch = 0; ch < nchunks; ++ch, ++g) {
      const int st = g % stages;
      if (!resident) mbar_wait(full + 8 * st, (g / stages) & 1);
      const int s0 = ch * kc;
      const int nks = min(kc, ks - s0);
      // descriptors advance in 16-byte units of the start address
      const uint64_t da = da0 + (uint64_t)((s0 * A_KSTEP_BYTES) >> 4);
      const uint64_t db = db0 + (uint64_t)((st * stage_bytes) >> 4);
      // each commit group is its own pipeline stage: fence, products, commit
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      int j = 0;
#pragma unroll 1
      for (; j + C <= nks; j += C) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          wgmma_bf16(acc[c], da + (uint64_t)(((j + c) * A_KSTEP_BYTES) >> 4),
                     db + (uint64_t)(((j + c) * NC * KSTEP_ROW_BYTES) >> 4), c == 0 || s0 + j > 0);
      }
#pragma unroll 1
      for (; j < nks; ++j)
        wgmma_bf16(acc[0], da + (uint64_t)((j * A_KSTEP_BYTES) >> 4),
                   db + (uint64_t)((j * NC * KSTEP_ROW_BYTES) >> 4), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (!resident && g - rel >= lag) {
        // chunk rel's products are done with its stage
        if (lag == 2)
          wgmma_wait<2>();
        else if (lag == 1)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
        mbar_arrive_if(empty + 8 * (rel % stages), lane);
        ++rel;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C; ++c) fence_acc(acc[c]);
    for (; !resident && rel < g; ++rel) mbar_arrive_if(empty + 8 * (rel % stages), lane);
    const float f = rep + 1 < reps ? 0.5f : 1e-4f;
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) {
      float d = acc[0][i];
#pragma unroll
      for (int c = 1; c < C; ++c) d = __fadd_rn(d, acc[c][i]);
      acc[0][i] = __fmul_rn(d, f);
    }
  }

  const int warp = threadIdx.x >> 5;
  // the m64nNCk16 accumulator layout: warp w holds rows 16 w .. 16 w + 15;
  // acc[4 j + q] is row lane / 4 (+8 for q >= 2), column 8 j + 2 (lane % 4)
  // + q % 2
  const int wr = row0 + warp * 16 + (lane >> 2);
  const int wc = blockIdx.y * NC + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int row = wr + ((i >> 1) & 1) * 8;
    const int col = wc + (i >> 2) * 8 + (i & 1);
    if (row < m && col < n) acc_out[(size_t)row * n + col] = acc[0][i];
  }
}

// o = a * 0.999 + 1e-7 * rowsum(acc): one warp a row, the sum in a fixed order
__global__ void lane_packing_out(const float* __restrict__ a, const float* __restrict__ acc,
                                 float* __restrict__ o, int m, int k, int n) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) s += acc[(size_t)row * n + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float add = __fmul_rn(1e-7f, s);
  for (int c = lane; c < k; c += 32)
    o[(size_t)row * k + c] = __fadd_rn(__fmul_rn(a[(size_t)row * k + c], 0.999f), add);
}

struct Args {
  const float* a;
  const unsigned char* w;
  float* acc;
  int m, k, n, ks, ncol, kc, stages, resident, reps;
};

template <int NC, int C>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const int bytes = smem_bytes(p.ks, NC, p.kc, p.stages);
  cudaError_t err = cudaFuncSetAttribute(lane_packing_kernel<NC, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.m + BM - 1) / BM, p.ncol);
  lane_packing_kernel<NC, C><<<grid, THREADS, bytes, stream>>>(
      p.a, p.w, p.acc, p.m, p.k, p.n, p.ks, p.kc, p.stages, p.resident, p.reps);
  return cudaGetLastError();
}

template <int NC, int C>
cudaError_t info(int* out, int ks, int kc, int stages) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, lane_packing_kernel<NC, C>);
  if (err != cudaSuccess) return err;
  const int v[6] = {at.numRegs, (int)at.localSizeBytes, (int)at.sharedSizeBytes,
                    smem_bytes(ks, NC, kc, stages), THREADS, C};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

// the widths a CTA may take and their accumulator chains (ops/cuda/
// lane_packing.py's WIDTHS): chains x N / 2 registers a thread, enough
// chains to cover a wgmma's latency at small N
#define FSE_K4_WIDTHS(X) \
  X(8, 8) X(16, 8) X(24, 6) X(40, 4) X(48, 4) X(56, 4) X(72, 3) X(112, 2) X(144, 2) X(216, 1)

}  // namespace

extern "C" {

// a: (m, k) fp32; w: prepare_weight's image, ncol slices of ks k-steps of
// nc rows x 32 bytes; acc: (m, n) fp32; o: (m, k) fp32. Streamed: a ring of
// stages >= 2 chunks of kc k-steps; resident: kc = ks, stages = 1. Returns
// cudaGetLastError().
int fse_lane_packing(const void* a, const void* w, void* acc, void* o, int m, int k, int n,
                     int ks, int nc, int ncol, int kc, int stages, int resident, int reps,
                     int device, void* stream) {
  if (m < 1 || k < 1 || n < 1 || ks * 16 < k || kc < 1 || stages < 1 || reps < 1 ||
      ncol * nc < n || (resident && (kc != ks || stages != 1)) || (!resident && stages < 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args p = {(const float*)a, (const unsigned char*)w, (float*)acc, m, k, n, ks, ncol,
                  kc, stages, resident, reps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {
#define FSE_CASE(W, C)        \
  case W:                     \
    err = launch<W, C>(p, s); \
    break;
    FSE_K4_WIDTHS(FSE_CASE)
#undef FSE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  constexpr int ROWS_PER_BLOCK = 8;  // 8 warps
  lane_packing_out<<<(m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32, 0, s>>>(
      (const float*)a, (const float*)acc, (float*)o, m, k, n);
  return (int)cudaGetLastError();
}

// The instantiation of width nc: registers a thread, local memory a thread
// (spills), static and dynamic shared memory for this ring, threads a CTA,
// accumulator chains. out holds 6 ints.
int fse_lane_packing_info(int* out, int nc, int ks, int kc, int stages, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (nc) {
#define FSE_CASE(W, C)                     \
  case W:                                  \
    err = info<W, C>(out, ks, kc, stages); \
    break;
    FSE_K4_WIDTHS(FSE_CASE)
#undef FSE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
