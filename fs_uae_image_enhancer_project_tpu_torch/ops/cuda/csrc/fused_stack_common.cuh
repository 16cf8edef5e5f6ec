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
// - one CTA of 12 warps owns a TH x TW output tile of one frame
//   (blockIdx.z), loads its input region (7-pixel halo, SAME-pad zeros) and
//   runs all 7 layers in shared memory, each over a region 2 rows and 2
//   columns smaller than the one before; out-of-image pixels are re-masked
//   to zero after every layer, which is what per-layer SAME zero padding
//   means at the frame's edges;
// - every conv is an implicit GEMM on the tensor cores (mma.sync m16n8k16,
//   bf16 in, fp32 accumulate). PK = 1: M = output pixels, N = cout padded to
//   8, K = 9 taps x cin. PK = 2: M = output pairs (columns 2t, 2t+1), N =
//   2 cout, K = 3 rows x 4 columns x cin: the pair's windows union to columns
//   2t-1..2t+2, and a quarter of the K x N weights are structural zeros.
//   In shared memory the left neighbour of a pair is just the previous
//   pixel's address, so no [A|O] buffer is materialised.
//
// What bounds it, and what this design does about it. The first design gave
// each warp jobs of one m-tile (16 matmul rows) and read the B fragments of
// every job from global memory (__ldg): 9.4 MB (K1) and 12.0 MB (K2) of
// weight loads a CTA for 0.31 and 0.77 MB of weights, and 5-9 mma per
// k-step against 4 A loads, 5-9 B loads and the tap arithmetic. Now:
// - each layer's weights come from global memory once per CTA: cp.async
//   stages them into a ring in shared memory, whole where they fit, else in
//   chunks of k-steps through two buffers (the next chunk loads while the
//   CTA computes this one); the first chunk of the next layer loads during
//   this layer's epilogue. All warps read B from shared memory (one uint2 a
//   lane, 256 contiguous bytes a warp: no bank conflicts);
// - the whole CTA walks K in step with the ring, so a warp holds all its
//   work of the layer in registers: the units (m-tile, group of at most 9
//   n-tiles) go round robin over the 12 warps (at most 108 fp32 accumulators
//   a thread: 3 units of 9 n-tiles, or 4 of 5), and each B fragment read
//   from shared memory serves all
//   of the warp's m-tiles; the A offsets of 32 k-steps are worked out at
//   once, a k-step a lane, and each k-step takes its pair by shuffle (the
//   tap arithmetic in the loop cost more issue slots than its mma); the
//   k-step loop is compiled for a warp's exact unit count, with no branch
//   inside; K1 loads A with ldmatrix;
// - shared memory: l1 (the skip into layer 6) is compacted after layer 2 to
//   the window layer 6 reads, which frees the ring of layers 3-7 (layers
//   1-2 stage into l3/l5's buffer, free until layer 3);
// - the tile, 16 x 14, gives 486 CTAs at 288 x 376 (3.7 waves over 132
//   SMs) against the first design's 16 x 16 (432, 3.3 waves): the same four
//   waves of less work each. Three waves would need 288-pixel tiles, whose
//   layer 3 holds 117 accumulators a thread, more than the registers allow.
// What bounds it now (scripts/profile_fused_stack.py, H100): the K loops
// take about 62% of a tile, at about 8-18 cycles per mma.sync a
// sub-partition, and the epilogues (the activation chains, MUFU-heavy)
// about 35%, with all warps in the same phase, so neither overlaps the
// other. Next: wgmma, and epilogues that overlap the next unit's mma.
// Layouts. Input and output: (N, H2, W2, 12) bf16, channels last,
// contiguous; or, for K1's enhance entry (stack_kernel_u8,
// fused_enhance.cu), the uint8 RGBA frames themselves, (N, H, W, 4) in and
// out. Shared memory: each region is [pixel][channel] bf16 with a
// per-layer channel stride chosen so that the 8 matmul rows of an mma
// fragment hit distinct banks (rows 1 pixel apart for PK = 1, 2 apart for
// PK = 2). Weights: per layer, the (K, N) bf16 matrix pre-arranged by the
// wrapper into mma.sync B-fragment order, [kstep][ntile][lane][4], so any
// range of k-steps is one contiguous block. K runs over chunks of 8 input
// channels, tap-major: k = (tap * cin_pad + c), with tap = dy * (PK + 2) +
// dx; for layer 6 the l1 chunks come first, then the l5 chunks. The chunk
// count is padded to even with zero weights. ops/cuda/fused_stack_plan.py
// mirrors the plan (tile, warps' units, buffers, ring chunks) for the tests.
//
// Numerics: bf16 intermediates, as the Pallas kernels' scratch, and the
// hardware's approximate transcendentals (ex2, sin, lg2 and tanh .approx,
// fast division). The exact libm versions cost 0.3 ms of a 1.03 ms frame
// (H100, the first design); their error (tanh.approx about 2^-11 relative)
// is below the bf16 rounding of each stored layer.
//
// K1's enhance entry (stack_kernel_u8: PK = 1, the same layers 1-7) folds
// export/enhance.py's eager prologue and epilogue and the model's unshuffle,
// shuffle, residual add and relu into its load and store, so that one
// enhance call is one launch:
// - load: each half-res pixel of the input region reads its 2x2 full-res
//   RGBA pixels from column `crop` on (two 8-byte loads) and maps each R, G
//   and B byte through a 256-entry bf16 table, the prologue's value of that
//   byte (/255, pow, bf16), into pixel_unshuffle's channel c*4 + ry*2 + rx;
// - store: layer 7 rounds its 12 outputs to bf16 as the bf16 entry does and
//   stages them in shared memory (l5's buffer, free by then); then the CTA
//   writes its full-res pixels: bf16(float(x) + float(y)) of the identity's
//   table value x and the staged y, mapped by its 16 bits through a 65,536-
//   entry uint8 table (relu and the epilogue: clamp, pow, x255, clamp,
//   uint8), alpha 255, and the CTAs of the first tile column write the crop
//   strip [0, crop) as (0, 0, 0, 255).
// The wrapper (ops/cuda/fused_enhance.py) makes both tables on the card by
// running the eager prologue and epilogue over every input value, so the
// frames equal the eager composition's byte for byte. Its cost is the
// tables' lookups and the identity's second read (from L2); the bf16
// entries (K1's stack_kernel<1>, K2's stack_kernel<2>) are unchanged.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fse_stack {

typedef __nv_bfloat16 bf16;

// Built with -DFSE_PROFILE (scripts/profile_fused_stack.py), thread 0 of each
// CTA of frame 0 records clock64() at the phase boundaries: 0 start, 2L and
// 2L+1 the start and end of layer L's K loop (its epilogue follows), 17
// before l1's compaction, 16 the end. Off by default: no cost.
constexpr int PROFILE_CTAS = 1024, PROFILE_STAMPS = 18;
#ifdef FSE_PROFILE
static __device__ unsigned long long g_stamps[PROFILE_CTAS][PROFILE_STAMPS];
#define FSE_STAMP(k)                                                               \
  do {                                                                             \
    const unsigned cta = blockIdx.y * gridDim.x + blockIdx.x;                      \
    if (threadIdx.x == 0 && blockIdx.z == 0 && cta < PROFILE_CTAS)                 \
      g_stamps[cta][k] = clock64();                                                \
  } while (0)
// copy the stamps to the host buffer `out` (PROFILE_CTAS x PROFILE_STAMPS)
static int copy_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
#else
#define FSE_STAMP(k) \
  do {               \
  } while (0)
#endif

// The output tile, rows x columns (half-res pixels); a sweep may set it at
// build time (-DFSE_TILE_H=.. -DFSE_TILE_W=..).
#ifndef FSE_TILE_H
#define FSE_TILE_H 16
#endif
#ifndef FSE_TILE_W
#define FSE_TILE_W 14
#endif
constexpr int TH = FSE_TILE_H;
constexpr int TW = FSE_TILE_W;
static_assert(TW % 2 == 0, "K2 pairs the columns of every region");
constexpr int NWARPS = 12;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NT_GROUP = 9;   // most 8-column mma tiles of N one unit holds
constexpr int SMEM_LIMIT = 232448;

// region of layer L (0 = input, 7 = output): halo 7 - L on each side
__host__ __device__ constexpr int rows_of(int layer) { return TH + 2 * (7 - layer); }
__host__ __device__ constexpr int cols_of(int layer) { return TW + 2 * (7 - layer); }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int align16(int b) { return (b + 15) / 16 * 16; }

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

// Shared memory, in this order: B (in, l2, l4, l6) | C (l3, l5; the ring of
// layers 1-2 before that) | A (l1; from layer 3 on its compacted window A1C,
// then the ring of layers 3-7) | P (parameters). The ring takes what is left.
template <int PK> struct Smem {
  static constexpr int bytes_of(int layer, int cs) {
    return align16(rows_of(layer) * cols_of(layer) * cs * 2);
  }
  static constexpr int A = bytes_of(1, Geo<PK>::CS36);    // l1
  static constexpr int A1C = bytes_of(5, Geo<PK>::CS36);  // l1's window that layer 6 reads
  static constexpr int B = cmax(cmax(bytes_of(0, Geo<PK>::CS_IN), bytes_of(2, Geo<PK>::CS36)),
                                cmax(bytes_of(4, Geo<PK>::CS72), bytes_of(6, Geo<PK>::CS36)));
  static constexpr int C = cmax(bytes_of(3, Geo<PK>::CS72), bytes_of(5, Geo<PK>::CS36));
  static constexpr int P = align16(P_TOTAL * 4);
  static constexpr int OFF_B = 0, OFF_C = B, OFF_A = B + C;
  static constexpr int RING12 = C;  // the ring of layers 1-2 is C
  static constexpr int OFF_RING3 = OFF_A + A1C;
  static constexpr int RING3 = (SMEM_LIMIT - P - OFF_RING3) / 256 * 256;
  static constexpr int OFF_P = OFF_RING3 + RING3;
  static constexpr int TOTAL = OFF_P + P;
  static_assert(TOTAL <= SMEM_LIMIT, "shared memory over the 227 KB a block may take");
  static_assert(A1C + RING3 >= A, "l1 fits where its window and the later ring go");
};

template <int N> struct Int { static constexpr int value = N; };

// The frames of K1's enhance entry: (N, H, W, 4) uint8 RGBA in and out, the
// prologue's table (256 bf16, by input byte) and the epilogue's (65,536
// uint8, by the bits of the bf16 sum before relu), and the left crop. H, W
// and crop are even, the pointers 8-byte aligned (the wrapper checks).
struct U8Frames {
  const uint8_t* in;
  uint8_t* out;
  const unsigned short* lut_in;
  const uint8_t* lut_out;
  int H, W, crop;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// The weights of one layer through a ring of `BYTES` bytes: whole if they
// fit, else chunks of KC k-steps alternating between the ring's two halves.
template <int NT, int KS, int BYTES> struct Ring {
  static constexpr int SLICE = NT * 32;  // uint2 per k-step
  static constexpr bool WHOLE = KS * SLICE * 8 <= BYTES;
  static constexpr int KC = WHOLE ? KS : (BYTES / 2) / (SLICE * 8);
  static constexpr int NC = (KS + KC - 1) / KC;
  static_assert(KC >= 1, "a k-step's slice fits half the ring");

  // Start the copy of chunk c into its half (all threads; one cp.async group).
  static __device__ __forceinline__ void load(int c, uint2* ring, const uint2* __restrict__ wf) {
    const int k0 = c * KC;
    const int n16 = ((KS - k0 < KC ? KS - k0 : KC) * SLICE) / 2;  // 16-byte pieces
    const uint4* src = reinterpret_cast<const uint4*>(wf + k0 * SLICE);
    uint4* dst = reinterpret_cast<uint4*>(ring + (c & 1) * KC * SLICE);
    for (int i = threadIdx.x; i < n16; i += NTHREADS) cp_async16(dst + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::);
  }
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

// The m16n8k16 A fragment from four 8x8 matrices whose row addresses
// (shared memory, 16-byte aligned) the lanes give.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void st2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One conv layer over the output region of layer OUT. Its NSRC sources (l1's
// window and l5 for layer 6) have the geometry of layer GEO's region, channel
// stride CS and CPT chunks of 8 channels per tap. The weights `wf` come
// through ring R at `ring`, whose chunk 0 the caller has started; after the
// K loop, `next()` starts the next layer's chunk 0 (the ring is free then).
// Units (m-tile of 16 matmul rows of PK pixels, group of NT / NG n-tiles)
// go round robin over the warps. epi(y, x, c, v0, v1) receives the fp32 sums
// of channels c and c+1 at pixel (y, x) of the output region (bias not yet
// added). For PK = 2, N is 2 * COUT (pixel 2t's channels, then pixel 2t+1's),
// and epi is also called with zeros for the pad channels COUT..COUT_PAD-1
// that the next layer reads; for PK = 1, N is the padded channel count and
// epi sees every channel.
template <int PK, int OUT, int GEO, int CS, int CPT, int NSRC, int NT, int COUT, int COUT_PAD,
          typename R, typename Epi, typename Next>
__device__ __forceinline__ void conv_layer(const bf16* __restrict__ src0,
                                           const bf16* __restrict__ src1,
                                           const uint2* __restrict__ wf, uint2* ring, Epi epi,
                                           Next next) {
  constexpr int WO = cols_of(OUT);
  static_assert(WO % PK == 0, "region width is a multiple of the pixels per row");
  constexpr int WQ = WO / PK;          // matmul rows per region row
  constexpr int NROWS = rows_of(OUT) * WQ;
  constexpr int MTILES = (NROWS + 15) / 16;
  constexpr int NG = (NT + NT_GROUP - 1) / NT_GROUP;
  constexpr int NTC = NT / NG;         // mma tiles of N per unit
  static_assert(NTC * NG == NT && NWARPS % NG == 0, "N splits evenly, a warp keeps its group");
  constexpr int UNITS = MTILES * NG;
  constexpr int MT = (UNITS + NWARPS - 1) / NWARPS;  // most units a warp holds
  constexpr int TX = PK + 2;           // window columns
  constexpr int WS = cols_of(GEO);
  constexpr int OS = (7 - GEO) - (7 - OUT) - 1;  // source offset of the window's top-left
  constexpr int NCH0 = 3 * TX * CPT;
  constexpr int NCH = NSRC * NCH0;
  constexpr int KS = (NCH + 1) / 2;
  static_assert(R::SLICE == NT * 32 && R::NC * R::KC >= KS && (R::NC - 1) * R::KC < KS,
                "the ring's chunks cover the layer's k-steps");
  static_assert(PK != 1 || CS % 8 == 0, "ldmatrix's rows are 16-byte aligned");

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ng = warp % NG;
  const int nunits = warp < UNITS ? (UNITS - 1 - warp) / NWARPS + 1 : 0;

  // Element offsets in a source of the matmul rows this thread reads for
  // each unit. PK = 1 loads A with ldmatrix: lane L gives the address of row
  // (L & 7) + 8 * ((L >> 3) & 1), in the k-step's first chunk for L < 16 and
  // its second for L >= 16 (base[i][0]). PK = 2's rows are 2 pixels apart,
  // at strides that keep them on distinct banks but not 16-byte aligned, so
  // it reads rows g and g + 8 at channel 2t with 32-bit loads.
  int base[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = (warp + i * NWARPS) / NG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = mt * 16 + (PK == 1 ? (lane & 7) + 8 * ((lane >> 3) & 1) : g + 8 * h);
      r = r < NROWS ? r : NROWS - 1;  // rows past the region read a valid pixel
      const int y = r / WQ;
      const int x = (r - y * WQ) * PK;
      base[i][h] = ((y + OS) * WS + (x + OS)) * CS + (PK == 1 ? 0 : 2 * t);
    }
  }
  float acc[MT][NTC][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // The k-steps [s0, s1) of a chunk for the warp's first NU units, with the
  // chunk's weights at wr. NU is a constant in each of the two versions (a
  // warp holds MT or MT - 1 units), so the loop has no branch to keep the
  // compiler from interleaving one step's loads with another's mma.
  // element offset from src0 of chunk q (8 channels of one tap of one source)
  const int d1 = NSRC == 2 ? (int)(src1 - src0) : 0;
  auto chunk_off = [&](int q) {
    int extra = 0;
    if (NSRC == 2 && q >= NCH0 && q < NCH) {
      q -= NCH0;
      extra = d1;
    }
    if (q >= NCH0) return 0;  // the zero-weight pad chunk reads valid data at offset 0
    const int tap = q / CPT, cb = q - tap * CPT;
    return extra + ((tap / TX) * WS + (tap % TX)) * CS + cb * 8;
  };
  const uint32_t src0_s = (uint32_t)__cvta_generic_to_shared(src0);
  auto steps = [&](auto nu, int s0, int s1, const uint2* wr) {
    constexpr int NU = decltype(nu)::value;
    if constexpr (NU > 0) {
      for (int sb = s0; sb < s1; sb += 32) {
        // lane l works out the offsets of the two chunks of k-step sb + l;
        // each k-step takes its pair by shuffle, once for all m-tiles
        const int own0 = chunk_off(2 * (sb + lane)), own1 = chunk_off(2 * (sb + lane) + 1);
        const int se = sb + 32 < s1 ? sb + 32 : s1;
#pragma unroll 2
        for (int s = sb; s < se; ++s) {
          const int o0 = __shfl_sync(0xffffffffu, own0, s - sb);
          const int o1 = __shfl_sync(0xffffffffu, own1, s - sb);
          uint32_t a[NU][4];
          if constexpr (PK == 1) {
            const uint32_t pa = src0_s + 2 * (lane < 16 ? o0 : o1);
#pragma unroll
            for (int i = 0; i < NU; ++i) ldsm_x4(a[i], pa + 2 * base[i][0]);
          } else {
#pragma unroll
            for (int i = 0; i < NU; ++i) {
              a[i][0] = lds32(src0 + o0 + base[i][0]);
              a[i][1] = lds32(src0 + o0 + base[i][1]);
              a[i][2] = lds32(src0 + o1 + base[i][0]);
              a[i][3] = lds32(src0 + o1 + base[i][1]);
            }
          }
          const uint2* ws = wr + (s - s0) * R::SLICE;
#pragma unroll
          for (int j = 0; j < NTC; ++j) {
            const uint2 b = ws[j * 32];
#pragma unroll
            for (int i = 0; i < NU; ++i) mma_bf16(acc[i][j], a[i], b);
          }
        }
      }
    }
  };

  FSE_STAMP(2 * OUT);
  for (int c = 0; c < R::NC; ++c) {
    if (c + 1 < R::NC) {
      R::load(c + 1, ring, wf);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // chunk c is in shared memory for every warp
    const uint2* wr = ring + (c & 1) * R::KC * R::SLICE + ng * NTC * 32 + lane;
    const int s0 = c * R::KC;
    const int s1 = s0 + R::KC < KS ? s0 + R::KC : KS;
    if (nunits == MT)
      steps(Int<MT>(), s0, s1, wr);
    else
      steps(Int<MT - 1>(), s0, s1, wr);
    if (c + 2 < R::NC) __syncthreads();  // every warp is done with this half
  }
  __syncthreads();  // the ring is free
  FSE_STAMP(2 * OUT + 1);
  next();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= nunits) continue;
    const int mt = (warp + i * NWARPS) / NG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r < NROWS) {
        const int y = r / WQ;
        const int x = (r - y * WQ) * PK;
#pragma unroll
        for (int j = 0; j < NTC; ++j) {
          const int n = (ng * NTC + j) * 8 + 2 * t;
          if (PK == 1) {
            epi(y, x, n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          } else {
            const int px = n >= COUT ? 1 : 0;
            const int cc = n - px * COUT;
            epi(y, x + px, cc, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            if (cc + 2 == COUT) {
#pragma unroll
              for (int cp = COUT; cp < COUT_PAD; cp += 2) epi(y, x + px, cp, 0.f, 0.f);
            }
          }
        }
      }
    }
  }
}

// Copy l1's window that layer 6 reads (layer 5's region, 4 pixels in from
// l1's edges) to the front of its buffer, in place: every thread reads its
// part into registers before any writes. `between()` runs after the reads.
template <int PK, typename Between>
__device__ __forceinline__ void compact_l1(bf16* buf, Between between) {
  constexpr int CS = Geo<PK>::CS36;
  static_assert(CS % 4 == 0, "whole uint2 per pixel");
  constexpr int U = CS / 4;  // uint2 per pixel
  constexpr int D = (7 - 1) - (7 - 5);
  constexpr int WC = cols_of(5), W1 = cols_of(1);
  constexpr int N = rows_of(5) * WC * U;
  constexpr int PER = (N + NTHREADS - 1) / NTHREADS;
  uint2* p = reinterpret_cast<uint2*>(buf);
  uint2 v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    if (i < N) {
      const int px = i / U, w = i - px * U;
      const int y = px / WC, x = px - y * WC;
      v[k] = p[((y + D) * W1 + x + D) * U + w];
    }
  }
  __syncthreads();
  between();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    if (i < N) p[i] = v[k];
  }
}

// K1's enhance entry, the load: the input region (7-pixel halo, SAME-pad
// zeros) from the uint8 RGBA frames. Half-res pixel (iy, ix) reads the 2x2
// full-res pixels at rows 2iy, 2iy+1 and columns crop + 2ix, crop + 2ix + 1
// (8 bytes a row); its channel c*4 + ry*2 + rx (pixel_unshuffle's order) is
// the prologue's table at colour byte c of pixel (ry, rx); channels 12-15
// are zero. A thread starts all its pixels' loads before it converts any.
template <int CS_IN>
__device__ __forceinline__ void load_frames(const U8Frames f, bf16* buf, int ty0, int tx0,
                                            int H2, int W2) {
  constexpr int RW = cols_of(0), NPIX = rows_of(0) * RW;
  constexpr int PER = (NPIX + NTHREADS - 1) / NTHREADS;
  static_assert(CS_IN % 8 == 0, "a pixel's 16 channels are two 16-byte stores");
  const uint8_t* in = f.in + (size_t)blockIdx.z * f.H * f.W * 4;
  uint2 px[PER][2];
  bool ok[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int p = threadIdx.x + k * NTHREADS;
    const int iy = ty0 - 7 + p / RW, ix = tx0 - 7 + p % RW;
    ok[k] = p < NPIX && iy >= 0 && iy < H2 && ix >= 0 && ix < W2;
    px[k][0] = px[k][1] = make_uint2(0u, 0u);
    if (ok[k]) {
      const uint2* a = reinterpret_cast<const uint2*>(
          in + ((size_t)2 * iy * f.W + f.crop + 2 * ix) * 4);
      px[k][0] = __ldg(a);
      px[k][1] = __ldg(a + f.W / 2);  // the next full-res row
    }
  }
  // colour c of the row's two pixels a and b as two bf16 channels
  auto pair = [&](uint32_t a, uint32_t b, int c) {
    return (uint32_t)__ldg(f.lut_in + ((a >> (8 * c)) & 255u)) |
           ((uint32_t)__ldg(f.lut_in + ((b >> (8 * c)) & 255u)) << 16);
  };
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int p = threadIdx.x + k * NTHREADS;
    if (p < NPIX) {
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (ok[k]) {  // 32-bit word c * 2 + ry holds channels c*4 + ry*2 + {0, 1}
        const uint2 r0 = px[k][0], r1 = px[k][1];
        lo = make_uint4(pair(r0.x, r0.y, 0), pair(r1.x, r1.y, 0), pair(r0.x, r0.y, 1),
                        pair(r1.x, r1.y, 1));
        hi = make_uint4(pair(r0.x, r0.y, 2), pair(r1.x, r1.y, 2), 0u, 0u);
      }
      uint4* dst = reinterpret_cast<uint4*>(buf + p * CS_IN);
      dst[0] = lo;
      dst[1] = hi;
    }
  }
}

// K1's enhance entry, the store: the tile's full-res pixels from its output
// staged in shared memory (TH x TW pixels of 12 bf16 channels). Colour c of
// pixel (2y + ry, crop + 2x + rx) is the epilogue's table at the bits of
// bf16(float(x) + float(y)), x the prologue's table at that pixel's input
// byte (read again, from L2) and y staged channel c*4 + ry*2 + rx of pixel
// (y, x); alpha is 255. An item is one full-res row of a half-res pixel:
// two pixels, 8 bytes in and 8 out, neighbouring items on neighbouring
// addresses. The first tile column also writes the crop strip, (0, 0, 0, 255).
__device__ __forceinline__ void store_frames(const U8Frames f, const bf16* stage, int ty0,
                                             int tx0, int H2, int W2) {
  const int rows = min(TH, H2 - ty0), cols = min(TW, W2 - tx0);
  const size_t base = (size_t)blockIdx.z * f.H * f.W;  // the frame's first pixel
  const uint2* in = reinterpret_cast<const uint2*>(f.in);
  uint2* out = reinterpret_cast<uint2*>(f.out);
  for (int i = threadIdx.x; i < 2 * TH * TW; i += NTHREADS) {
    const int t = i / TW, x = i - t * TW;
    const int y = t >> 1, ry = t & 1;
    if (y >= rows || x >= cols) continue;
    const size_t px = base + (size_t)(2 * (ty0 + y) + ry) * f.W + f.crop + 2 * (tx0 + x);
    const uint2 src = __ldg(in + px / 2);
    const bf16* s = stage + (y * TW + x) * 12 + ry * 2;
    uint32_t o[2];
#pragma unroll
    for (int rx = 0; rx < 2; ++rx) {
      const uint32_t w = rx ? src.y : src.x;
      uint32_t v = 0xff000000u;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xv = __uint_as_float((uint32_t)__ldg(f.lut_in + ((w >> (8 * c)) & 255u))
                                         << 16);
        const float sum = xv + __bfloat162float(s[c * 4 + rx]);
        v |= (uint32_t)__ldg(f.lut_out + __bfloat16_as_ushort(__float2bfloat16_rn(sum)))
             << (8 * c);
      }
      o[rx] = v;
    }
    out[px / 2] = make_uint2(o[0], o[1]);
  }
  if (blockIdx.x == 0) {
    uint32_t* px = reinterpret_cast<uint32_t*>(f.out) + base + (size_t)2 * ty0 * f.W;
    for (int i = threadIdx.x; i < 2 * rows * f.crop; i += NTHREADS) {
      const int r = i / f.crop;
      px[(size_t)r * f.W + (i - r * f.crop)] = 0xff000000u;
    }
  }
}

// One CTA's tile: the kernels below are this function for the bf16 entries
// (U8 false: xin and yout) and K1's enhance entry (U8 true: the frames f).
template <int PK, bool U8>
__device__ __forceinline__ void stack_tile(const bf16* __restrict__ xin, bf16* __restrict__ yout,
                                           const uint2* __restrict__ w1,
                                           const uint2* __restrict__ w2,
                                           const uint2* __restrict__ w3,
                                           const uint2* __restrict__ w4,
                                           const uint2* __restrict__ w5,
                                           const uint2* __restrict__ w6,
                                           const uint2* __restrict__ w7,
                                           const float* __restrict__ prm, int H2, int W2,
                                           const U8Frames f) {
  static_assert(!U8 || PK == 1, "the enhance entry is K1's");
  using G = Geo<PK>;
  using S = Smem<PK>;
  constexpr int CS_IN = G::CS_IN, CS36 = G::CS36, CS72 = G::CS72;
  // N of each layer's GEMM in 8-column mma tiles: padded channels for PK = 1,
  // 2 * cout for PK = 2
  constexpr int N36 = PK == 1 ? 5 : 9, N72 = PK == 1 ? 9 : 18, N12 = PK == 1 ? 2 : 3;
  // k-steps of each layer: 3 rows x (PK + 2) columns x chunks, halved, rounded up
  constexpr int TX3 = 3 * (PK + 2);
  constexpr int KS12 = (TX3 * 2 + 1) / 2, KS36 = (TX3 * 5 + 1) / 2, KS72 = (TX3 * 9 + 1) / 2,
                KS6 = (TX3 * 10 + 1) / 2;
  using R1 = Ring<N36, KS12, S::RING12>;
  using R2 = Ring<N36, KS36, S::RING12>;
  using R3 = Ring<N72, KS36, S::RING3>;
  using R4 = Ring<N72, KS72, S::RING3>;
  using R5 = Ring<N36, KS72, S::RING3>;
  using R6 = Ring<N36, KS6, S::RING3>;
  using R7 = Ring<N12, KS36, S::RING3>;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufA = reinterpret_cast<bf16*>(smem + S::OFF_A);
  bf16* bufB = reinterpret_cast<bf16*>(smem + S::OFF_B);
  bf16* bufC = reinterpret_cast<bf16*>(smem + S::OFF_C);
  uint2* ring12 = reinterpret_cast<uint2*>(smem + S::OFF_C);
  uint2* ring3 = reinterpret_cast<uint2*>(smem + S::OFF_RING3);
  float* sp = reinterpret_cast<float*>(smem + S::OFF_P);

  FSE_STAMP(0);
  if constexpr (!U8) {
    const size_t frame = (size_t)blockIdx.z * H2 * W2 * 12;
    xin += frame;
    yout += frame;
  }
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;

  // true iff pixel (y, x) of the region of layer L lies inside the image
  auto inside = [&](int layer, int y, int x) {
    const int iy = ty0 - (7 - layer) + y;
    const int ix = tx0 - (7 - layer) + x;
    return iy >= 0 && iy < H2 && ix >= 0 && ix < W2;
  };

  // the parameters, the input region and layer 1's weights all load at once
  // with cp.async (a thread's loads in flight together, not one by one)
  static_assert(S::P % 16 == 0 && (P_TOTAL * 4) % 16 == 0, "16-byte copies of the parameters");
  for (int i = threadIdx.x; i < P_TOTAL / 4; i += NTHREADS)
    cp_async16(sp + 4 * i, prm + 4 * i);
  // input region with SAME-pad zeros: 4 x 8 bytes per pixel (channels 12-15 zero)
  if constexpr (!U8) {
    constexpr int RW = cols_of(0);
    for (int i = threadIdx.x; i < rows_of(0) * RW * 4; i += NTHREADS) {
      const int p = i >> 2, c4 = i & 3;
      const int y = p / RW, x = p - (p / RW) * RW;
      bf16* dst = bufB + p * CS_IN + c4 * 4;
      if (c4 < 3 && inside(0, y, x)) {
        const int iy = ty0 - 7 + y, ix = tx0 - 7 + x;
        cp_async8(dst, xin + ((size_t)iy * W2 + ix) * 12 + c4 * 4);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      }
    }
  }
  R1::load(0, ring12, w1);
  if constexpr (U8) load_frames<CS_IN>(f, bufB, ty0, tx0, H2, W2);
  cp_async_wait_all();
  __syncthreads();

  const float a1a = sp[P_SC + 0], a1b = sp[P_SC + 1];
  const float a2a = sp[P_SC + 2], a2b = sp[P_SC + 3];
  const float p7b = sp[P_SC + 4], p7s = sp[P_SC + 5];
  auto nothing = [] {};

  // layer 1: conv 12->36, sinlu, relu6            in (B) -> l1 (A)
  conv_layer<PK, 1, 0, CS_IN, 2, 1, N36, 36, 40, R1>(bufB, bufB, w1, ring12,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (n < 36 && inside(1, y, x)) {
          r0 = relu6_f(sinlu_f(v0 + sp[P_B1 + n], a1a, a1b));
          r1 = relu6_f(sinlu_f(v1 + sp[P_B1 + n + 1], a1a, a1b));
        }
        st2(bufA + (y * cols_of(1) + x) * CS36 + n, r0, r1);
      },
      [&] { R2::load(0, ring12, w2); });
  __syncthreads();

  // layer 2: conv 36->36, telu, + l1, sinlu, biased_prelu(36)   l1 (A) -> l2 (B)
  conv_layer<PK, 2, 1, CS36, 5, 1, N36, 36, 40, R2>(bufA, bufA, w2, ring12,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (n < 36 && inside(2, y, x)) {
          const float2 s = ld2(bufA + ((y + 1) * cols_of(1) + x + 1) * CS36 + n);
          r0 = telu_f(v0 + sp[P_B2 + n]) + s.x;
          r1 = telu_f(v1 + sp[P_B2 + n + 1]) + s.y;
          r0 = bprelu_f(sinlu_f(r0, a2a, a2b), sp[P_P2B + n], sp[P_P2S + n]);
          r1 = bprelu_f(sinlu_f(r1, a2a, a2b), sp[P_P2B + n + 1], sp[P_P2S + n + 1]);
        }
        st2(bufB + (y * cols_of(2) + x) * CS36 + n, r0, r1);
      },
      nothing);
  __syncthreads();

  FSE_STAMP(17);
  // l1 keeps only the window layer 6 reads; the ring of layers 3-7 follows it
  compact_l1<PK>(bufA, [&] { R3::load(0, ring3, w3); });

  // layer 3: conv 36->72                          l2 (B) -> l3 (C)
  conv_layer<PK, 3, 2, CS36, 5, 1, N72, 72, 72, R3>(bufB, bufB, w3, ring3,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (inside(3, y, x)) {
          r0 = v0 + sp[P_B3 + n];
          r1 = v1 + sp[P_B3 + n + 1];
        }
        st2(bufC + (y * cols_of(3) + x) * CS72 + n, r0, r1);
      },
      [&] { R4::load(0, ring3, w4); });
  __syncthreads();

  // layer 4: conv 72->72, mish, biased_prelu(72), + l3, tanh, relu   l3 (C) -> l4 (B)
  conv_layer<PK, 4, 3, CS72, 9, 1, N72, 72, 72, R4>(bufC, bufC, w4, ring3,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (inside(4, y, x)) {
          const float2 s = ld2(bufC + ((y + 1) * cols_of(3) + x + 1) * CS72 + n);
          r0 = bprelu_f(mish_f(v0 + sp[P_B4 + n]), sp[P_P4B + n], sp[P_P4S + n]) + s.x;
          r1 = bprelu_f(mish_f(v1 + sp[P_B4 + n + 1]), sp[P_P4B + n + 1], sp[P_P4S + n + 1]) + s.y;
          r0 = fmaxf(tanh_f(r0), 0.f);
          r1 = fmaxf(tanh_f(r1), 0.f);
        }
        st2(bufB + (y * cols_of(4) + x) * CS72 + n, r0, r1);
      },
      [&] { R5::load(0, ring3, w5); });
  __syncthreads();

  // layer 5: conv 72->36                          l4 (B) -> l5 (C)
  conv_layer<PK, 5, 4, CS72, 9, 1, N36, 36, 40, R5>(bufB, bufB, w5, ring3,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (n < 36 && inside(5, y, x)) {
          r0 = v0 + sp[P_B5 + n];
          r1 = v1 + sp[P_B5 + n + 1];
        }
        st2(bufC + (y * cols_of(5) + x) * CS36 + n, r0, r1);
      },
      [&] { R6::load(0, ring3, w6); });
  __syncthreads();

  // layer 6: conv over concat(l1, l5) 72->36, mish, relu6   l1's window (A), l5 (C) -> l6 (B)
  conv_layer<PK, 6, 5, CS36, 5, 2, N36, 36, 40, R6>(bufA, bufC, w6, ring3,
      [&](int y, int x, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (n < 36 && inside(6, y, x)) {
          r0 = relu6_f(mish_f(v0 + sp[P_B6 + n]));
          r1 = relu6_f(mish_f(v1 + sp[P_B6 + n + 1]));
        }
        st2(bufB + (y * cols_of(6) + x) * CS36 + n, r0, r1);
      },
      [&] { R7::load(0, ring3, w7); });
  __syncthreads();

  // layer 7: conv 36->12, biased_prelu(1)         l6 (B) -> output (U8: staged in C)
  conv_layer<PK, 7, 6, CS36, 5, 1, N12, 12, 12, R7>(bufB, bufB, w7, ring3,
      [&](int y, int x, int n, float v0, float v1) {
        if (n < 12 && inside(7, y, x)) {
          const float r0 = bprelu_f(v0 + sp[P_B7 + n], p7b, p7s);
          const float r1 = bprelu_f(v1 + sp[P_B7 + n + 1], p7b, p7s);
          if constexpr (U8)
            st2(bufC + (y * TW + x) * 12 + n, r0, r1);
          else
            st2(yout + ((size_t)(ty0 + y) * W2 + (tx0 + x)) * 12 + n, r0, r1);
        }
      },
      nothing);
  if constexpr (U8) {
    __syncthreads();  // the tile's output is staged
    store_frames(f, bufC, ty0, tx0, H2, W2);
  }
#ifdef FSE_PROFILE
  __syncthreads();
  FSE_STAMP(16);
#endif
}

// The bf16 entries: (N, H2, W2, 12) bf16 in and out.
template <int PK>
__global__ void __launch_bounds__(NTHREADS, 1)
stack_kernel(const bf16* __restrict__ xin, bf16* __restrict__ yout,
             const uint2* __restrict__ w1, const uint2* __restrict__ w2,
             const uint2* __restrict__ w3, const uint2* __restrict__ w4,
             const uint2* __restrict__ w5, const uint2* __restrict__ w6,
             const uint2* __restrict__ w7, const float* __restrict__ prm,
             int H2, int W2) {
  stack_tile<PK, false>(xin, yout, w1, w2, w3, w4, w5, w6, w7, prm, H2, W2, U8Frames{});
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
template <int PK>
cudaError_t set_smem() {
  return set_smem(stack_kernel<PK>, Smem<PK>::TOTAL);
}

// Launch the stack over `frames` frames on `stream`; returns cudaGetLastError().
template <int PK>
int launch_stack(const void* x, void* y, const void* const* w, const void* prm, int frames,
                 int rows, int cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = set_smem<PK>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((cols + TW - 1) / TW, (rows + TH - 1) / TH, frames);
  stack_kernel<PK><<<grid, NTHREADS, Smem<PK>::TOTAL, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)y, (const uint2*)w[0], (const uint2*)w[1], (const uint2*)w[2],
      (const uint2*)w[3], (const uint2*)w[4], (const uint2*)w[5], (const uint2*)w[6],
      (const float*)prm, rows, cols);
  return (int)cudaGetLastError();
}

// The compiled kernel's attributes and its plan, for the wrapper's checks:
// out[0..7] = registers a thread, local memory a thread (bytes; spills),
// static shared memory, dynamic shared memory, threads a CTA, tile rows,
// tile columns, ring bytes of layers 3-7. Returns a CUDA error code.
template <int PK, typename K>
int kernel_info(K kernel, int* out, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = set_smem(kernel, Smem<PK>::TOTAL);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  const int v[8] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    Smem<PK>::TOTAL, NTHREADS, TH, TW, Smem<PK>::RING3};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
template <int PK>
int kernel_info(int* out, int device) {
  return kernel_info<PK>(stack_kernel<PK>, out, device);
}

}  // namespace fse_stack
