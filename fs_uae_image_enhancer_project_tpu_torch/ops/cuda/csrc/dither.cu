// Palette dithering of a batch of crops, each onto its own palette (K3).
//
// Replaces the Pallas TPU kernel
// fs_uae_image_enhancer_project_tpu/ops/pallas/dither.py::_dither_kernel
// (driven there by _run/_run_batch, entry points pallas_palette_dither and
// pallas_palette_dither_batch_per_palette). Per pixel: the nearest and the
// second-nearest of the crop's N palette colours by squared RGB distance (ties
// go to the lowest index), then one of three rules, then the chosen colour:
//   MAP      the nearest colour;
//   CHECKER  the nearest where (x + y) is even, else the second nearest;
//   ORDERED  order the pair dark to light by palette luminance, interpolate the
//            pixel's luminance between them (frac), and take the lighter colour
//            where frac > bayer[y % m][x % m] / (m * m), all in fp32.
// CHECKER and ORDERED keep the nearest where its distance is 0.
//
// Bound. The work is N distance evaluations per pixel: 3 subtractions, one
// multiply and two fused multiply-adds (8 flops), and one compare for MAP or
// two for the two-nearest search, so 9 or 10 fp32 operations per pixel-colour
// pair on the CUDA cores (the exact distance has no tensor-core form here).
// At the generator's batch (16 lores crops of 188x144, N = 256) that is
// 110.9 M pairs, 1.1 GFLOP: 16.6 us at the H100's 67 TFLOP/s fp32. The bytes
// (2.6 MB in and out) take under 1 us, so the kernel is bound by operations.
//
// Design. The search is on integers (a float search of one pixel a thread
// took about 14 instructions a pair): for pixel x and colour j
// the key 1024 (|p_j|^2 - 2 x.p_j) + j is exact in int32 (within about
// +-2e8), orders the colours by distance and then by index, and carries the
// index in its low 10 bits. So the nearest colour is the smallest key, the
// second nearest the second smallest (the Pallas kernel's strict-'<' rule),
// with no selects: MAP keeps k1 = min(k1, key), the two-nearest search
// k2 = min(k2, max(k1, key)); k1 = min(k1, key). The shared palette holds
// (r | g << 8 | b << 16, 1024 |p_j|^2 + j) a colour, so a key is one __dp4a
// on the packed bytes and one multiply-add: 3 integer instructions a pair for
// MAP, 5 for the others (ptxas fuses pairs of mins into a 3-way VIMNMX3;
// the compiled loop, with its share of the load and the loop's own
// instructions, is 3.5 and 5.5 a pair: scripts/sass_k3.py). Each thread
// takes PIX pixels (strided by the block), so one broadcast load of a
// palette entry serves all of them; 3 at 128 threads a CTA was the fastest
// of 1-4 pixels and 64-256 threads on an H100 (PERF.md, section 6). Then
// i = k1 & 1023 and d1 = |x|^2 + (k1 >> 10), exact, for the d1 == 0 rule.
// One CTA row per crop (blockIdx.y); the ragged last CTA of a crop masks its
// own tail.
//
// Byte equality with the Pallas kernel (for integer-valued pixels, as uint8
// input is) rests on these:
// - the distances are exact integers, and so are the keys that order them;
// - the palette luminance is an input, computed as the JAX wrapper computes it
//   (numpy's float32 product of the palette with the weights);
// - the pixel luminance is fma(b, L2, fma(r, L0, g * L1)), the contraction
//   XLA's CPU compiler gives the Pallas kernel's r*L0 + g*L1 + b*L2; written
//   with __fmaf_rn/__fmul_rn so that nvcc can neither contract nor reorder;
// - frac's subtractions and IEEE division use __fsub_rn/__fdiv_rn, with the
//   same |denom| < 1e-6 guard, clip to [0, 1] and strict frac > threshold;
// - the Bayer threshold is bayer / (m * m) by IEEE division, as numpy's.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The launch goes
// on the caller's stream, never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;  // threads a CTA
constexpr int PIX = 3;      // pixels a thread
constexpr int MAX_COLORS = 1024;
constexpr int MODE_MAP = 0, MODE_CHECKER = 1, MODE_ORDERED = 2;

// luminance weights, as fp32 (datagen/quantize.py's _LUMA)
constexpr float L0 = 0.2126f, L1 = 0.7152f, L2 = 0.0722f;

struct Bayer {
  int m;          // 2, 4 or 8; 0 when the mode is not ORDERED
  int v[64];      // row-major m x m
};

template <int MODE>
__global__ void __launch_bounds__(BLOCK) palette_dither_kernel(
    const uint8_t* __restrict__ img, const uint8_t* __restrict__ pal,
    const float* __restrict__ pal_lum, uint8_t* __restrict__ out, int n_px, int width,
    int n, Bayer bayer) {
  __shared__ int2 skey[MAX_COLORS];   // packed rgb, 1024 |p|^2 + j
  __shared__ float slum[MAX_COLORS];  // palette luminance
  const int b = blockIdx.y;
  const uint8_t* pb = pal + (size_t)b * n * 3;
  const float* lb = pal_lum + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += BLOCK) {
    const int r = pb[3 * j], g = pb[3 * j + 1], bl = pb[3 * j + 2];
    skey[j] = make_int2(r | (g << 8) | (bl << 16), 1024 * (r * r + g * g + bl * bl) + j);
    if (MODE == MODE_ORDERED) slum[j] = lb[j];
  }
  __syncthreads();

  const int p0 = blockIdx.x * BLOCK * PIX + threadIdx.x;
  const uint8_t* ib = img + (size_t)b * n_px * 3;
  unsigned x[PIX];
  int k1[PIX], k2[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int p = p0 + i * BLOCK;
    x[i] = p < n_px ? ib[3 * p] | (ib[3 * p + 1] << 8) | (ib[3 * p + 2] << 16) : 0u;
    k1[i] = k2[i] = INT_MAX;
  }
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const int2 c = skey[j];
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const int key = c.y - ((int)__dp4a(x[i], (unsigned)c.x, 0u) << 11);
      if (MODE != MODE_MAP) k2[i] = min(k2[i], max(k1[i], key));
      k1[i] = min(k1[i], key);
    }
  }

#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int p = p0 + i * BLOCK;
    if (p >= n_px) break;
    const int r = x[i] & 255, g = (x[i] >> 8) & 255, bl = x[i] >> 16;
    const int i1 = k1[i] & (MAX_COLORS - 1);
    int chosen = i1;
    if (MODE != MODE_MAP && r * r + g * g + bl * bl + (k1[i] >> 10) != 0) {
      const int i2 = k2[i] & (MAX_COLORS - 1);
      const int px = p % width, py = p / width;
      if (MODE == MODE_CHECKER) {
        chosen = ((px + py) & 1) ? i2 : i1;
      } else {
        const float lum =
            __fmaf_rn((float)bl, L2, __fmaf_rn((float)r, L0, __fmul_rn((float)g, L1)));
        const float l1 = slum[i1], l2 = slum[i2];
        const bool swap = l1 > l2;
        const int lo_i = swap ? i2 : i1, hi_i = swap ? i1 : i2;
        const float lo = fminf(l1, l2), hi = fmaxf(l1, l2);
        const float den = __fsub_rn(hi, lo);
        float frac = fabsf(den) < 1e-6f
                         ? 0.0f
                         : __fdiv_rn(__fsub_rn(lum, lo), den == 0.0f ? 1.0f : den);
        frac = fminf(fmaxf(frac, 0.0f), 1.0f);
        const int m = bayer.m;
        const float thresh =
            __fdiv_rn((float)bayer.v[(py % m) * m + (px % m)], (float)(m * m));
        chosen = frac > thresh ? hi_i : lo_i;
      }
    }
    const unsigned c = (unsigned)skey[chosen].x;
    uint8_t* o = out + ((size_t)b * n_px + p) * 3;
    o[0] = (uint8_t)(c & 255);
    o[1] = (uint8_t)((c >> 8) & 255);
    o[2] = (uint8_t)(c >> 16);
  }
}

}  // namespace

extern "C" {

// img, out: (batch, height, width, 3) uint8; pal: (batch, n, 3) uint8;
// pal_lum: (batch, n) fp32; bayer: host pointer to bayer_m * bayer_m ints
// (read only for mode 2). 2 <= n <= 1024. Returns cudaGetLastError().
int fse_palette_dither(const void* img, const void* pal, const void* pal_lum, void* out,
                       int batch, int height, int width, int n, int mode, int bayer_m,
                       const int* bayer, int device, void* stream) {
  if (n < 2 || n > MAX_COLORS || mode < 0 || mode > 2 || batch < 1 || height < 1 ||
      width < 1)
    return (int)cudaErrorInvalidValue;
  Bayer bay = {};
  if (mode == MODE_ORDERED) {
    if (bayer_m != 2 && bayer_m != 4 && bayer_m != 8) return (int)cudaErrorInvalidValue;
    bay.m = bayer_m;
    for (int i = 0; i < bayer_m * bayer_m; ++i) bay.v[i] = bayer[i];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_px = height * width;
  const dim3 grid((n_px + BLOCK * PIX - 1) / (BLOCK * PIX), batch);
  const auto* x = (const uint8_t*)img;
  const auto* p = (const uint8_t*)pal;
  const auto* l = (const float*)pal_lum;
  auto* y = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_MAP)
    palette_dither_kernel<MODE_MAP><<<grid, BLOCK, 0, s>>>(x, p, l, y, n_px, width, n, bay);
  else if (mode == MODE_CHECKER)
    palette_dither_kernel<MODE_CHECKER><<<grid, BLOCK, 0, s>>>(x, p, l, y, n_px, width, n, bay);
  else
    palette_dither_kernel<MODE_ORDERED><<<grid, BLOCK, 0, s>>>(x, p, l, y, n_px, width, n, bay);
  return (int)cudaGetLastError();
}

// The compiled kernels: registers a thread of the MAP, CHECKER and ORDERED
// instantiations, the most local memory a thread (spills) and static shared
// memory of the three, threads a CTA and pixels a thread. out holds 7 ints.
int fse_palette_dither_info(int* out, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at[3];
  const void* fns[3] = {(const void*)palette_dither_kernel<MODE_MAP>,
                        (const void*)palette_dither_kernel<MODE_CHECKER>,
                        (const void*)palette_dither_kernel<MODE_ORDERED>};
  int local = 0, smem = 0;
  for (int i = 0; i < 3; ++i) {
    err = cudaFuncGetAttributes(&at[i], fns[i]);
    if (err != cudaSuccess) return (int)err;
    out[i] = at[i].numRegs;
    local = at[i].localSizeBytes > (size_t)local ? (int)at[i].localSizeBytes : local;
    smem = at[i].sharedSizeBytes > (size_t)smem ? (int)at[i].sharedSizeBytes : smem;
  }
  out[3] = local;
  out[4] = smem;
  out[5] = BLOCK;
  out[6] = PIX;
  return 0;
}

}  // extern "C"
