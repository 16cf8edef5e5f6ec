// The whole lightweight pix_shuffle conv stack in one kernel (K1).
//
// Replaces the Pallas TPU kernel
// fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack.py::_stack_kernel
// (driven there by _run_stack, entry point fused_stack_apply). It computes the
// function of the model between pixel-unshuffle and pixel-shuffle: seven 3x3
// SAME convs at half resolution, 12->36->36->72->72->36->[36|36]->36->12, with
// the activation chain sinlu/relu6, telu/+l1/sinlu/biased_prelu, -, mish/
// biased_prelu/+l3/tanh/relu, -, mish/relu6, biased_prelu, and l6's concat of
// (l1, l5) done as one matmul over both sources.
//
// Bound at the main path's shape (one 576x752 frame, crop 0: a 288x376x12
// bf16 half-resolution input): 136,080 multiply-adds per half-res pixel, so
// 29.5 GFLOP per frame (28.8 at crop 16), which is 29.8 us at the H100's
// 989 TFLOP/s dense bf16. The bytes are about 5.5 MB (input and output 2.6 MB
// each, weights 0.3 MB): 1.6 us at 3.35 TB/s. The kernel is compute-bound.
//
// What this first design does about that bound:
// - every conv is an implicit GEMM on the tensor cores (mma.sync m16n8k16,
//   bf16 in, fp32 accumulate): M = output pixels, N = cout, K = 9 * cin.
//   Each of 16 warps takes jobs of 16 output pixels by all output channels;
//   the B fragments come straight from L2/L1, and 16 warps (rather than 8
//   with 32-pixel jobs) hide more of that latency;
// - no intermediate activation leaves shared memory: one CTA owns a 16x16
//   output tile, loads its 30x30 input region (7-pixel halo, SAME-pad zeros)
//   and runs all 7 layers in shared memory, each over a region 2 rows and
//   2 columns smaller than the one before. The price is halo recompute: at a
//   16x16 tile the CTA does about 1.9x the tile's own multiply-adds;
// - out-of-image pixels are re-masked to zero after every layer, which is
//   what per-layer SAME zero padding means at the frame's edges;
// - l1 stays alive until l6 reads it; the other layers ping-pong between two
//   buffers (215,360 bytes of shared memory in all, one CTA per SM).
// It reaches about 4% of the bound. Not yet done (later work): wgmma/TMA,
// weights staged in shared memory, a persistent schedule against the 3.3-wave
// tail, larger tiles or cross-tile reuse to cut the recompute.
//
// Layouts. Input and output: (H2, W2, 12) bf16, channels last, contiguous.
// Shared memory: each region is [pixel][channel] bf16 with a per-layer channel
// stride chosen so that the 8 pixels of an mma fragment hit distinct banks
// (24, 40 or 72 elements). Weights: per layer, the (K, cout_pad) bf16 matrix
// pre-arranged by the wrapper into mma.sync B-fragment order, [kstep][ntile]
// [lane][4], so that each lane reads 8 contiguous bytes per fragment. K runs
// over chunks of 8 input channels, tap-major: k = ((dy*3+dx) * cin_pad + c);
// for layer 6 the l1 chunks come first, then the l5 chunks. The chunk count
// is padded to even with zero weights.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The launch goes
// on the caller's stream, never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 16;      // output tile is TILE x TILE half-res pixels
constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MT = 1;         // 16-pixel mma tiles per warp job

// region width of layer L (0 = input, 7 = output): halo 7 - L on each side
__host__ __device__ constexpr int region(int layer) { return TILE + 2 * (7 - layer); }

// channel strides in shared memory (elements)
constexpr int CS_IN = 24;  // 12 channels, 16 read (4 zero), stride 24 for banks
constexpr int CS36 = 40;   // 36 channels + 4 zero
constexpr int CS72 = 72;

constexpr int bytes_of(int layer, int cs) { return region(layer) * region(layer) * cs * 2; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int SZ_A = bytes_of(1, CS36);                                   // l1
constexpr int SZ_B = cmax(cmax(bytes_of(0, CS_IN), bytes_of(2, CS36)),
                          cmax(bytes_of(4, CS72), bytes_of(6, CS36)));    // in, l2, l4, l6
constexpr int SZ_C = cmax(bytes_of(3, CS72), bytes_of(5, CS36));          // l3, l5

// packed fp32 parameter vector (same offsets in ops/cuda/fused_stack.py)
constexpr int P_B1 = 0, P_B2 = 40, P_B3 = 80, P_B4 = 152, P_B5 = 224, P_B6 = 264,
              P_B7 = 304, P_P2B = 320, P_P2S = 360, P_P4B = 400, P_P4S = 472,
              P_SC = 544, P_TOTAL = 552;
constexpr int SZ_P = P_TOTAL * 4;

constexpr int SMEM_BYTES = SZ_A + SZ_B + SZ_C + SZ_P;
static_assert(SMEM_BYTES <= 232448, "shared memory over the 227 KB a block may take");
static_assert(SZ_A % 16 == 0 && SZ_B % 16 == 0 && SZ_C % 16 == 0, "16-byte aligned regions");

// The activations use the hardware's approximate transcendentals (ex2, sin,
// lg2 and tanh .approx, fast division). They run on every output element of
// every layer, and the exact libm versions cost 0.3 ms of a 1.03 ms frame
// (H100, measured against this kernel with exact math). Their error (tanh.approx
// about 2^-11 relative) is below the bf16 rounding of each stored layer.
__device__ __forceinline__ float tanh_f(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sigmoid_f(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float sinlu_f(float x, float a, float b) {
  return sigmoid_f(x) * (x + a * __sinf(b * x));
}
__device__ __forceinline__ float relu6_f(float x) { return fminf(fmaxf(x, 0.f), 6.f); }
__device__ __forceinline__ float telu_f(float x) { return x * tanh_f(__expf(x)); }
__device__ __forceinline__ float mish_f(float x) {
  const float sp = x > 20.f ? x : __logf(1.f + __expf(x));  // softplus, torch's threshold
  return x * tanh_f(sp);
}
__device__ __forceinline__ float bprelu_f(float x, float bias, float slope) {
  const float s = x - bias;
  return s >= 0.f ? s : slope * s;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One conv layer over the output region of layer OUT, as warp jobs of
// MT*16 pixels by all NT*8 output channels. Source s (1 or 2 of them) is the
// region of layer SRC_s with channel stride CS_s and CPT_s chunks of 8
// channels per tap. epi(y, x, n, v0, v1) receives the fp32 sums of channels
// n and n+1 at pixel (y, x) of the output region (bias not yet added).
template <int OUT, int SRC0, int CS0, int CPT0, int SRC1, int CS1, int CPT1, int NT,
          typename Epi>
__device__ __forceinline__ void conv_layer(const bf16* __restrict__ src0,
                                           const bf16* __restrict__ src1,
                                           const uint2* __restrict__ wf, Epi epi) {
  constexpr int WO = region(OUT);
  constexpr int NPIX = WO * WO;
  constexpr int NJOBS = (NPIX + MT * 16 - 1) / (MT * 16);
  constexpr int W0 = region(SRC0);
  constexpr int O0 = (7 - SRC0) - (7 - OUT) - 1;  // source offset of the window's top-left
  constexpr int W1 = region(SRC1);
  constexpr int O1 = (7 - SRC1) - (7 - OUT) - 1;
  constexpr int NCH0 = 9 * CPT0;
  constexpr int NCH = NCH0 + 9 * CPT1;
  constexpr int KS = (NCH + 1) / 2;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int job = warp; job < NJOBS; job += NWARPS) {
    // element offsets of this thread's 2*MT pixel rows in each source
    int base0[MT][2], base1[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p = job * MT * 16 + m * 16 + g + 8 * h;
        p = p < NPIX ? p : NPIX - 1;  // rows past the region read a valid pixel
        const int y = p / WO;
        const int x = p - y * WO;
        base0[m][h] = ((y + O0) * W0 + (x + O0)) * CS0 + 2 * t;
        base1[m][h] = CPT1 ? ((y + O1) * W1 + (x + O1)) * CS1 + 2 * t : 0;
      }
    }
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

#pragma unroll 2
    for (int s = 0; s < KS; ++s) {
      uint2 bfrag[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) bfrag[j] = __ldg(wf + (s * NT + j) * 32 + lane);
      uint32_t a[MT][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int q = 2 * s + half;  // chunk of 8 channels of one tap of one source
        const bf16* src = src0;
        bool second = false;
        int off = 0;  // the zero-weight pad chunk reads valid data at offset 0
        if (q < NCH0) {
          const int tap = q / CPT0, cb = q - tap * CPT0;
          off = ((tap / 3) * W0 + (tap % 3)) * CS0 + cb * 8;
        } else if (q < NCH) {
          q -= NCH0;
          const int tap = q / (CPT1 ? CPT1 : 1), cb = q - tap * CPT1;
          off = ((tap / 3) * W1 + (tap % 3)) * CS1 + cb * 8;
          src = src1;
          second = true;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          a[m][2 * half + 0] = lds32(src + (second ? base1[m][0] : base0[m][0]) + off);
          a[m][2 * half + 1] = lds32(src + (second ? base1[m][1] : base0[m][1]) + off);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a[m], bfrag[j]);
    }

#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = job * MT * 16 + m * 16 + g + 8 * h;
        if (p < NPIX) {
          const int y = p / WO;
          const int x = p - y * WO;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            epi(y, x, j * 8 + 2 * t, acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
fused_stack_kernel(const bf16* __restrict__ xin, bf16* __restrict__ yout,
                   const uint2* __restrict__ w1, const uint2* __restrict__ w2,
                   const uint2* __restrict__ w3, const uint2* __restrict__ w4,
                   const uint2* __restrict__ w5, const uint2* __restrict__ w6,
                   const uint2* __restrict__ w7, const float* __restrict__ prm,
                   int H2, int W2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufA = reinterpret_cast<bf16*>(smem);
  bf16* bufB = reinterpret_cast<bf16*>(smem + SZ_A);
  bf16* bufC = reinterpret_cast<bf16*>(smem + SZ_A + SZ_B);
  float* sp = reinterpret_cast<float*>(smem + SZ_A + SZ_B + SZ_C);

  const int ty0 = blockIdx.y * TILE;
  const int tx0 = blockIdx.x * TILE;

  // true iff pixel (y, x) of the region of layer L lies inside the image
  auto inside = [&](int layer, int y, int x) {
    const int iy = ty0 - (7 - layer) + y;
    const int ix = tx0 - (7 - layer) + x;
    return iy >= 0 && iy < H2 && ix >= 0 && ix < W2;
  };

  for (int i = threadIdx.x; i < P_TOTAL; i += NTHREADS) sp[i] = prm[i];

  // input region with SAME-pad zeros: 4 x 8 bytes per pixel (channels 12-15 zero)
  {
    constexpr int R = region(0);
    for (int i = threadIdx.x; i < R * R * 4; i += NTHREADS) {
      const int p = i >> 2, c4 = i & 3;
      const int y = p / R, x = p - (p / R) * R;
      uint2 v = make_uint2(0u, 0u);
      if (c4 < 3 && inside(0, y, x)) {
        const int iy = ty0 - 7 + y, ix = tx0 - 7 + x;
        v = *reinterpret_cast<const uint2*>(xin + ((size_t)iy * W2 + ix) * 12 + c4 * 4);
      }
      *reinterpret_cast<uint2*>(bufB + p * CS_IN + c4 * 4) = v;
    }
  }
  __syncthreads();

  const float a1a = sp[P_SC + 0], a1b = sp[P_SC + 1];
  const float a2a = sp[P_SC + 2], a2b = sp[P_SC + 3];
  const float p7b = sp[P_SC + 4], p7s = sp[P_SC + 5];

  // layer 1: conv 12->36, sinlu, relu6            in (B) -> l1 (A)
  conv_layer<1, 0, CS_IN, 2, 0, 0, 0, 5>(bufB, bufB, w1,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (n < 36 && inside(1, y, x)) {
          r0 = relu6_f(sinlu_f(v0 + sp[P_B1 + n], a1a, a1b));
          r1 = relu6_f(sinlu_f(v1 + sp[P_B1 + n + 1], a1a, a1b));
        }
        st2(bufA + (y * region(1) + x) * CS36 + n, r0, r1);
      });
  __syncthreads();

  // layer 2: conv 36->36, telu, + l1, sinlu, biased_prelu(36)   l1 (A) -> l2 (B)
  conv_layer<2, 1, CS36, 5, 0, 0, 0, 5>(bufA, bufA, w2,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (n < 36 && inside(2, y, x)) {
          const float2 s = ld2(bufA + ((y + 1) * region(1) + x + 1) * CS36 + n);
          r0 = telu_f(v0 + sp[P_B2 + n]) + s.x;
          r1 = telu_f(v1 + sp[P_B2 + n + 1]) + s.y;
          r0 = bprelu_f(sinlu_f(r0, a2a, a2b), sp[P_P2B + n], sp[P_P2S + n]);
          r1 = bprelu_f(sinlu_f(r1, a2a, a2b), sp[P_P2B + n + 1], sp[P_P2S + n + 1]);
        }
        st2(bufB + (y * region(2) + x) * CS36 + n, r0, r1);
      });
  __syncthreads();

  // layer 3: conv 36->72                          l2 (B) -> l3 (C)
  conv_layer<3, 2, CS36, 5, 0, 0, 0, 9>(bufB, bufB, w3,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (inside(3, y, x)) {
          r0 = v0 + sp[P_B3 + n];
          r1 = v1 + sp[P_B3 + n + 1];
        }
        st2(bufC + (y * region(3) + x) * CS72 + n, r0, r1);
      });
  __syncthreads();

  // layer 4: conv 72->72, mish, biased_prelu(72), + l3, tanh, relu   l3 (C) -> l4 (B)
  conv_layer<4, 3, CS72, 9, 0, 0, 0, 9>(bufC, bufC, w4,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (inside(4, y, x)) {
          const float2 s = ld2(bufC + ((y + 1) * region(3) + x + 1) * CS72 + n);
          r0 = bprelu_f(mish_f(v0 + sp[P_B4 + n]), sp[P_P4B + n], sp[P_P4S + n]) + s.x;
          r1 = bprelu_f(mish_f(v1 + sp[P_B4 + n + 1]), sp[P_P4B + n + 1], sp[P_P4S + n + 1]) + s.y;
          r0 = fmaxf(tanh_f(r0), 0.f);
          r1 = fmaxf(tanh_f(r1), 0.f);
        }
        st2(bufB + (y * region(4) + x) * CS72 + n, r0, r1);
      });
  __syncthreads();

  // layer 5: conv 72->36                          l4 (B) -> l5 (C)
  conv_layer<5, 4, CS72, 9, 0, 0, 0, 5>(bufB, bufB, w5,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (n < 36 && inside(5, y, x)) {
          r0 = v0 + sp[P_B5 + n];
          r1 = v1 + sp[P_B5 + n + 1];
        }
        st2(bufC + (y * region(5) + x) * CS36 + n, r0, r1);
      });
  __syncthreads();

  // layer 6: conv over concat(l1, l5) 72->36, mish, relu6   l1 (A), l5 (C) -> l6 (B)
  conv_layer<6, 1, CS36, 5, 5, CS36, 5, 5>(bufA, bufC, w6,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (n < 36 && inside(6, y, x)) {
          r0 = relu6_f(mish_f(v0 + sp[P_B6 + n]));
          r1 = relu6_f(mish_f(v1 + sp[P_B6 + n + 1]));
        }
        st2(bufB + (y * region(6) + x) * CS36 + n, r0, r1);
      });
  __syncthreads();

  // layer 7: conv 36->12, biased_prelu(1)         l6 (B) -> output
  conv_layer<7, 6, CS36, 5, 0, 0, 0, 2>(bufB, bufB, w7,
      [&](int y, int x, int n, float v0, float v1) {
        if (n < 12 && inside(7, y, x)) {
          const float r0 = bprelu_f(v0 + sp[P_B7 + n], p7b, p7s);
          const float r1 = bprelu_f(v1 + sp[P_B7 + n + 1], p7b, p7s);
          st2(yout + ((size_t)(ty0 + y) * W2 + (tx0 + x)) * 12 + n, r0, r1);
        }
      });
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel takes per block (for the wrapper's notes).
int fse_fused_stack_smem_bytes(void) { return SMEM_BYTES; }

// x: (rows, cols, 12) bf16, y: (rows, cols, 12) bf16, w1..w7: B-fragment weights,
// prm: the packed fp32 parameter vector. Returns cudaGetLastError().
int fse_fused_stack(const void* x, void* y, const void* w1, const void* w2,
                    const void* w3, const void* w4, const void* w5, const void* w6,
                    const void* w7, const void* prm, int rows, int cols, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((cols + TILE - 1) / TILE, (rows + TILE - 1) / TILE);
  fused_stack_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)y, (const uint2*)w1, (const uint2*)w2, (const uint2*)w3,
      (const uint2*)w4, (const uint2*)w5, (const uint2*)w6, (const uint2*)w7,
      (const float*)prm, rows, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
