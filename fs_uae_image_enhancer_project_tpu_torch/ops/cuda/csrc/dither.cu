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
// This first design: one thread per pixel, 256 pixels per CTA, one CTA row
// per crop (blockIdx.y). The crop's palette, as float4 (r, g, b, luminance),
// is staged in shared memory (16 KB at N = 1024) and read as a broadcast. One
// pass over the N colours keeps the best two with strict '<', which is the
// Pallas kernel's tie rule. No 512-pixel padding and no sentinel palette rows:
// the ragged last CTA of a crop masks its own tail.
//
// Byte equality with the Pallas kernel (for integer-valued pixels, as uint8
// input is) rests on these:
// - the squared distances are integers below 2^24, exact in any order;
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
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
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
  __shared__ float4 spal[MAX_COLORS];
  const int b = blockIdx.y;
  const uint8_t* pb = pal + (size_t)b * n * 3;
  const float* lb = pal_lum + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += BLOCK)
    spal[j] = make_float4(pb[3 * j], pb[3 * j + 1], pb[3 * j + 2], lb[j]);
  __syncthreads();

  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= n_px) return;
  const size_t o = ((size_t)b * n_px + p) * 3;
  const float r = img[o], g = img[o + 1], bl = img[o + 2];

  float d1 = INFINITY, d2 = INFINITY;
  int i1 = 0, i2 = 0;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 c = spal[j];
    const float dr = r - c.x, dg = g - c.y, db = bl - c.z;
    const float d = dr * dr + dg * dg + db * db;  // exact: integers below 2^24
    if (MODE == MODE_MAP) {
      if (d < d1) { d1 = d; i1 = j; }
    } else {
      const bool lt1 = d < d1, lt2 = d < d2;
      d2 = lt1 ? d1 : (lt2 ? d : d2);
      i2 = lt1 ? i1 : (lt2 ? j : i2);
      d1 = lt1 ? d : d1;
      i1 = lt1 ? j : i1;
    }
  }

  int chosen = i1;
  if (MODE != MODE_MAP && d1 != 0.0f) {
    const int x = p % width, y = p / width;
    if (MODE == MODE_CHECKER) {
      chosen = ((x + y) & 1) ? i2 : i1;
    } else {
      const float lum = __fmaf_rn(bl, L2, __fmaf_rn(r, L0, __fmul_rn(g, L1)));
      const float l1 = spal[i1].w, l2 = spal[i2].w;
      const bool swap = l1 > l2;
      const int lo_i = swap ? i2 : i1, hi_i = swap ? i1 : i2;
      const float lo = fminf(l1, l2), hi = fmaxf(l1, l2);
      const float den = __fsub_rn(hi, lo);
      float frac = fabsf(den) < 1e-6f ? 0.0f
                                      : __fdiv_rn(__fsub_rn(lum, lo), den == 0.0f ? 1.0f : den);
      frac = fminf(fmaxf(frac, 0.0f), 1.0f);
      const int m = bayer.m;
      const float thresh = __fdiv_rn((float)bayer.v[(y % m) * m + (x % m)], (float)(m * m));
      chosen = frac > thresh ? hi_i : lo_i;
    }
  }
  const float4 c = spal[chosen];
  out[o] = (uint8_t)c.x;
  out[o + 1] = (uint8_t)c.y;
  out[o + 2] = (uint8_t)c.z;
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
  const dim3 grid((n_px + BLOCK - 1) / BLOCK, batch);
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

}  // extern "C"
