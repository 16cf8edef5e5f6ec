// The lightweight pix_shuffle conv stack as one kernel, in two GEMM forms:
// K1 (fused_stack.cu, one output pixel per matmul row) and K2
// (fused_stack_packed.cu, two output pixels per matmul row against
// pair-packed weights). Both compute the function of the model between
// pixel-unshuffle and pixel-shuffle: seven 3x3 SAME convs at half
// resolution, 12->36->36->72->72->36->[36|36]->36->12, with the activation
// chain sinlu/relu6, telu/+l1/sinlu/biased_prelu, -, mish/biased_prelu/+l3/
// tanh/relu, -, mish/relu6, biased_prelu, and l6's concat of (l1, l5) done as
// one matmul over both sources.
//
// The two forms share everything but the GEMM's shape (template parameter
// PK, pixels per matmul row):
// - one CTA owns a 16x16 output tile of one frame (blockIdx.z), loads its
//   30x30 input region (7-pixel halo, SAME-pad zeros) and runs all 7 layers
//   in shared memory, each over a region 2 rows and 2 columns smaller than
//   the one before; out-of-image pixels are re-masked to zero after every
//   layer, which is what per-layer SAME zero padding means at the frame's
//   edges;
// - l1 stays alive until l6 reads it; the other layers ping-pong between two
//   buffers; one CTA of 16 warps per SM;
// - every conv is an implicit GEMM on the tensor cores (mma.sync m16n8k16,
//   bf16 in, fp32 accumulate). PK = 1: M = output pixels, N = cout padded to
//   8, K = 9 taps x cin. PK = 2: M = output pairs (columns 2t, 2t+1), N =
//   2 cout, K = 3 rows x 4 columns x cin: the pair's windows union to columns
//   2t-1..2t+2, and a quarter of the K x N weights are structural zeros.
//   In shared memory the left neighbour of a pair is just the previous
//   pixel's address, so no [A|O] buffer is materialised: only the window's
//   width (3 -> 4 columns) and the weights change;
// - a warp job is 16 matmul rows by at most NT_JOB mma tiles of N; layers
//   with a wider N (K2's 144 columns) split N over two jobs.
//
// Layouts. Input and output: (N, H2, W2, 12) bf16, channels last,
// contiguous. Shared memory: each region is [pixel][channel] bf16 with a
// per-layer channel stride chosen so that the 8 matmul rows of an mma
// fragment hit distinct banks (rows 1 pixel apart for PK = 1, 2 apart for
// PK = 2). Weights: per layer, the (K, N) bf16 matrix pre-arranged by the
// wrapper into mma.sync B-fragment order, [kstep][ntile][lane][4]. K runs
// over chunks of 8 input channels, tap-major: k = (tap * cin_pad + c), with
// tap = dy * (PK + 2) + dx; for layer 6 the l1 chunks come first, then the
// l5 chunks. The chunk count is padded to even with zero weights.
//
// Numerics: bf16 intermediates, as the Pallas kernels' scratch, and the
// hardware's approximate transcendentals (ex2, sin, lg2 and tanh .approx,
// fast division). The exact libm versions cost 0.3 ms of a 1.03 ms frame
// (H100, K1); their error (tanh.approx about 2^-11 relative) is below the
// bf16 rounding of each stored layer.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fse_stack {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 16;      // output tile is TILE x TILE half-res pixels
constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NT_JOB = 9;     // most 8-column mma tiles one warp job accumulates

// region width of layer L (0 = input, 7 = output): halo 7 - L on each side
__host__ __device__ constexpr int region(int layer) { return TILE + 2 * (7 - layer); }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// channel strides in shared memory (elements), per GEMM form: 12 input
// channels (16 read, 12-15 zero), 36 (40 read) and 72. Consecutive matmul
// rows are PK pixels apart, so PK * stride / 2 words must be an odd multiple
// of 4 modulo 32 for the fragment's 8 rows to land on distinct banks.
template <int PK> struct Geo;
template <> struct Geo<1> { static constexpr int CS_IN = 24, CS36 = 40, CS72 = 72; };
template <> struct Geo<2> { static constexpr int CS_IN = 20, CS36 = 44, CS72 = 76; };

// packed fp32 parameter vector (same offsets in ops/cuda/fused_stack.py)
constexpr int P_B1 = 0, P_B2 = 40, P_B3 = 80, P_B4 = 152, P_B5 = 224, P_B6 = 264,
              P_B7 = 304, P_P2B = 320, P_P2S = 360, P_P4B = 400, P_P4S = 472,
              P_SC = 544, P_TOTAL = 552;

template <int PK> struct Smem {
  static constexpr int bytes_of(int layer, int cs) { return region(layer) * region(layer) * cs * 2; }
  static constexpr int A = bytes_of(1, Geo<PK>::CS36);  // l1
  static constexpr int B = cmax(cmax(bytes_of(0, Geo<PK>::CS_IN), bytes_of(2, Geo<PK>::CS36)),
                                cmax(bytes_of(4, Geo<PK>::CS72), bytes_of(6, Geo<PK>::CS36)));  // in, l2, l4, l6
  static constexpr int C = cmax(bytes_of(3, Geo<PK>::CS72), bytes_of(5, Geo<PK>::CS36));  // l3, l5
  static constexpr int P = P_TOTAL * 4;
  static constexpr int TOTAL = A + B + C + P;
  static_assert(TOTAL <= 232448, "shared memory over the 227 KB a block may take");
  static_assert(A % 16 == 0 && B % 16 == 0 && C % 16 == 0, "16-byte aligned regions");
};

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

// One conv layer over the output region of layer OUT, as warp jobs of 16
// matmul rows (PK pixels each) by NT / ceil(NT / NT_JOB) mma tiles of N.
// Source s (1 or 2 of them) is the region of layer SRC_s with channel stride
// CS_s and CPT_s chunks of 8 channels per tap. epi(y, x, c, v0, v1) receives
// the fp32 sums of channels c and c+1 at pixel (y, x) of the output region
// (bias not yet added). For PK = 2, N is 2 * COUT (pixel 2t's channels, then
// pixel 2t+1's), and epi is also called with zeros for the pad channels
// COUT..COUT_PAD-1 that the next layer reads; for PK = 1, N is the padded
// channel count and epi sees every channel.
template <int PK, int OUT, int SRC0, int CS0, int CPT0, int SRC1, int CS1, int CPT1, int NT,
          int COUT, int COUT_PAD, typename Epi>
__device__ __forceinline__ void conv_layer(const bf16* __restrict__ src0,
                                           const bf16* __restrict__ src1,
                                           const uint2* __restrict__ wf, Epi epi) {
  constexpr int WO = region(OUT);
  static_assert(WO % PK == 0, "region width is a multiple of the pixels per row");
  constexpr int WQ = WO / PK;          // matmul rows per region row
  constexpr int NROWS = WO * WQ;
  constexpr int MTILES = (NROWS + 15) / 16;
  constexpr int NSPLIT = (NT + NT_JOB - 1) / NT_JOB;
  constexpr int NTC = NT / NSPLIT;     // mma tiles of N per job
  static_assert(NTC * NSPLIT == NT, "N splits evenly over the jobs");
  constexpr int NJOBS = MTILES * NSPLIT;
  constexpr int TX = PK + 2;           // window columns
  constexpr int W0 = region(SRC0);
  constexpr int O0 = (7 - SRC0) - (7 - OUT) - 1;  // source offset of the window's top-left
  constexpr int W1 = region(SRC1);
  constexpr int O1 = (7 - SRC1) - (7 - OUT) - 1;
  constexpr int NCH0 = 3 * TX * CPT0;
  constexpr int NCH = NCH0 + 3 * TX * CPT1;
  constexpr int KS = (NCH + 1) / 2;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int job = warp; job < NJOBS; job += NWARPS) {
    const int mt = job / NSPLIT;
    const int nt0 = (job - mt * NSPLIT) * NTC;
    // element offsets of this thread's 2 matmul rows in each source
    int base0[2], base1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = mt * 16 + g + 8 * h;
      r = r < NROWS ? r : NROWS - 1;  // rows past the region read a valid pixel
      const int y = r / WQ;
      const int x = (r - y * WQ) * PK;
      base0[h] = ((y + O0) * W0 + (x + O0)) * CS0 + 2 * t;
      base1[h] = CPT1 ? ((y + O1) * W1 + (x + O1)) * CS1 + 2 * t : 0;
    }
    float acc[NTC][4];
#pragma unroll
    for (int j = 0; j < NTC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

#pragma unroll 2
    for (int s = 0; s < KS; ++s) {
      uint2 bfrag[NTC];
#pragma unroll
      for (int j = 0; j < NTC; ++j) bfrag[j] = __ldg(wf + (s * NT + nt0 + j) * 32 + lane);
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int q = 2 * s + half;  // chunk of 8 channels of one tap of one source
        const bf16* src = src0;
        bool second = false;
        int off = 0;  // the zero-weight pad chunk reads valid data at offset 0
        if (q < NCH0) {
          const int tap = q / CPT0, cb = q - tap * CPT0;
          off = ((tap / TX) * W0 + (tap % TX)) * CS0 + cb * 8;
        } else if (q < NCH) {
          q -= NCH0;
          const int tap = q / (CPT1 ? CPT1 : 1), cb = q - tap * CPT1;
          off = ((tap / TX) * W1 + (tap % TX)) * CS1 + cb * 8;
          src = src1;
          second = true;
        }
        a[2 * half + 0] = lds32(src + (second ? base1[0] : base0[0]) + off);
        a[2 * half + 1] = lds32(src + (second ? base1[1] : base0[1]) + off);
      }
#pragma unroll
      for (int j = 0; j < NTC; ++j) mma_bf16(acc[j], a, bfrag[j]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r < NROWS) {
        const int y = r / WQ;
        const int x = (r - y * WQ) * PK;
#pragma unroll
        for (int j = 0; j < NTC; ++j) {
          const int n = (nt0 + j) * 8 + 2 * t;
          if (PK == 1) {
            epi(y, x, n, acc[j][2 * h], acc[j][2 * h + 1]);
          } else {
            const int px = n >= COUT ? 1 : 0;
            const int c = n - px * COUT;
            epi(y, x + px, c, acc[j][2 * h], acc[j][2 * h + 1]);
            if (c + 2 == COUT) {
#pragma unroll
              for (int cp = COUT; cp < COUT_PAD; cp += 2) epi(y, x + px, cp, 0.f, 0.f);
            }
          }
        }
      }
    }
  }
}

template <int PK>
__global__ void __launch_bounds__(NTHREADS, 1)
stack_kernel(const bf16* __restrict__ xin, bf16* __restrict__ yout,
             const uint2* __restrict__ w1, const uint2* __restrict__ w2,
             const uint2* __restrict__ w3, const uint2* __restrict__ w4,
             const uint2* __restrict__ w5, const uint2* __restrict__ w6,
             const uint2* __restrict__ w7, const float* __restrict__ prm,
             int H2, int W2) {
  using G = Geo<PK>;
  using S = Smem<PK>;
  constexpr int CS_IN = G::CS_IN, CS36 = G::CS36, CS72 = G::CS72;
  // N of each layer's GEMM in 8-column mma tiles: padded channels for PK = 1,
  // 2 * cout for PK = 2
  constexpr int N36 = PK == 1 ? 5 : 9, N72 = PK == 1 ? 9 : 18, N12 = PK == 1 ? 2 : 3;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufA = reinterpret_cast<bf16*>(smem);
  bf16* bufB = reinterpret_cast<bf16*>(smem + S::A);
  bf16* bufC = reinterpret_cast<bf16*>(smem + S::A + S::B);
  float* sp = reinterpret_cast<float*>(smem + S::A + S::B + S::C);

  const size_t frame = (size_t)blockIdx.z * H2 * W2 * 12;
  xin += frame;
  yout += frame;
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
  conv_layer<PK, 1, 0, CS_IN, 2, 0, 0, 0, N36, 36, 40>(bufB, bufB, w1,
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
  conv_layer<PK, 2, 1, CS36, 5, 0, 0, 0, N36, 36, 40>(bufA, bufA, w2,
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
  conv_layer<PK, 3, 2, CS36, 5, 0, 0, 0, N72, 72, 72>(bufB, bufB, w3,
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
  conv_layer<PK, 4, 3, CS72, 9, 0, 0, 0, N72, 72, 72>(bufC, bufC, w4,
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
  conv_layer<PK, 5, 4, CS72, 9, 0, 0, 0, N36, 36, 40>(bufB, bufB, w5,
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
  conv_layer<PK, 6, 1, CS36, 5, 5, CS36, 5, N36, 36, 40>(bufA, bufC, w6,
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
  conv_layer<PK, 7, 6, CS36, 5, 0, 0, 0, N12, 12, 12>(bufB, bufB, w7,
      [&](int y, int x, int n, float v0, float v1) {
        if (n < 12 && inside(7, y, x)) {
          const float r0 = bprelu_f(v0 + sp[P_B7 + n], p7b, p7s);
          const float r1 = bprelu_f(v1 + sp[P_B7 + n + 1], p7b, p7s);
          st2(yout + ((size_t)(ty0 + y) * W2 + (tx0 + x)) * 12 + n, r0, r1);
        }
      });
}

// Launch the stack over `frames` frames on `stream`; returns cudaGetLastError().
template <int PK>
int launch_stack(const void* x, void* y, const void* const* w, const void* prm, int frames,
                 int rows, int cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(stack_kernel<PK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<PK>::TOTAL);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((cols + TILE - 1) / TILE, (rows + TILE - 1) / TILE, frames);
  stack_kernel<PK><<<grid, NTHREADS, Smem<PK>::TOTAL, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)y, (const uint2*)w[0], (const uint2*)w[1], (const uint2*)w[2],
      (const uint2*)w[3], (const uint2*)w[4], (const uint2*)w[5], (const uint2*)w[6],
      (const float*)prm, rows, cols);
  return (int)cudaGetLastError();
}

}  // namespace fse_stack
