// The pass after a convolution: its bias, an activation, a residual add and
// an activation, in place on the convolution's fresh output, in one launch.
//
// No TPU kernel of its own: the JAX package adds the bias, applies the
// activations and adds the residual as XLA ops, which XLA fuses. On the card
// the port's convolutions are cuDNN's with no bias; after them ATen ran the
// bias broadcast onto NHWC as a non-vectorized elementwise pass (2-byte
// accesses through an offset calculator), then each ReLU and each residual add
// as passes of their own, every one reading and writing the whole tensor.
// This kernel computes, for each element of y (the convolution's output, in
// place; channel c = (flat offset / inner) % C, inner 1 where cuDNN wrote NHWC
// and H * W where it wrote NCHW, as it does for an input whose strides are no
// NHWC tensor's, such as a host frame given a batch axis by numpy's [None]):
//
//   t = rnd(y + rnd(b[c]))          where there is a bias
//   t = pre(t)                       identity or ReLU
//   r' = rnd(r + rnd(bp[c]))         where the residual has a bias
//   t = rnd(r' + t)                  where there is a residual r
//   y = post(t)                      identity or ReLU
//
// in fp32, rnd rounding to y's type (bf16 or fp32) to nearest even: the
// roundings of the eager chain (ATen's bf16 add_ and relu, and the JAX
// package's adds), so the two agree bit for bit. ReLU keeps NaN, as
// torch.relu does. The biases are fp32 and rounded here, so the caller casts
// nothing.
//
// Bound: bytes. y read and written, r read, the biases negligible: 4 bytes an
// element in bf16 (6 with a residual), at 3.35 TB/s on an H100; a few
// operations an element against the card's ~300 a byte. Design for the
// bytes: each thread moves 16 bytes a load and a store (8 bf16 or 4 fp32),
// neighbouring threads on neighbouring 16 bytes, UNROLL loads in flight
// before the first store. The grid (a few waves' worth of CTAs, capped at
// what is resident on the card) strides over the vectors, and its stride in
// elements is a multiple of C (the grid is a multiple of C / gcd(C, 8 or 4)
// threads), so every vector a thread touches starts at the same channel: the
// thread reads and rounds its 8 (or 4) biases once, from the flat index, which
// takes any C (108, 36 and 3 are not multiples of 8). The last n % 8 (or 4)
// elements, past the last whole vector, are the first threads' scalar tail.
// The mode is a template argument: 46 instantiations, and no branch on it
// in the loop (as launch arguments the kernel ran 57-64% of the bound against
// 67-71% on an H100, timed in turns). An NCHW output takes strided_kernel, one
// element a thread and the mode read at run time: rare, so kept plain.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The launch goes
// on the caller's stream, never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fse_epilogue {

constexpr int BLOCK = 256;
constexpr int UNROLL = 4;
constexpr int MAX_DEVICES = 64;
// the mode's bits, as ops/cuda/conv_epilogue.py's
enum : int { PRE = 1, POST = 2, BIAS = 4, RES = 8, RES_BIAS = 16, MODES = 32 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: where the eager chain stores a result in T
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// torch.relu: 0 below zero, NaN kept
__device__ __forceinline__ float relu(float v) { return (v > 0.f || isnan(v)) ? v : 0.f; }

// One element: y's and r's values and the element's two rounded biases;
// M is the mode, a constant where the kernel is instantiated for it.
template <typename T>
__device__ __forceinline__ float element(float y, float r, float b, float bp, int M) {
  float t = y;
  if (M & BIAS) t = rnd<T>(__fadd_rn(t, b));
  if (M & PRE) t = relu(t);
  if (M & RES) {
    if (M & RES_BIAS) r = rnd<T>(__fadd_rn(r, bp));
    t = rnd<T>(__fadd_rn(r, t));
  }
  if (M & POST) t = relu(t);
  return t;
}

template <typename T, int M>
__global__ void __launch_bounds__(BLOCK)
epilogue_kernel(T* __restrict__ y, const T* __restrict__ r, const float* __restrict__ b,
                const float* __restrict__ bp, long long n, int C) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = n / V;
  const long long g = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long stride = (long long)gridDim.x * BLOCK;
  // stride * V is a multiple of C, so each of this thread's vectors starts at
  // channel (g * V) % C: its biases, rounded once
  float bb[V], bq[V];
  int c = (int)((g * V) % C);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    bb[j] = (M & BIAS) ? rnd<T>(__ldg(b + c)) : 0.f;
    bq[j] = (M & RES_BIAS) ? rnd<T>(__ldg(bp + c)) : 0.f;
    c = c + 1 == C ? 0 : c + 1;
  }
  uint4* yv = reinterpret_cast<uint4*>(y);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  for (long long v0 = g; v0 < nvec; v0 += stride * UNROLL) {
    uint4 a[UNROLL], q[UNROLL] = {};
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * stride;
      if (v < nvec) {
        a[u] = yv[v];
        if (M & RES) q[u] = __ldg(rv + v);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * stride;
      if (v < nvec) {
        T* e = reinterpret_cast<T*>(&a[u]);
        const T* f = reinterpret_cast<const T*>(&q[u]);
#pragma unroll
        for (int j = 0; j < V; ++j)
          e[j] = from_f<T>(element<T>(to_f(e[j]), (M & RES) ? to_f(f[j]) : 0.f, bb[j], bq[j], M));
        yv[v] = a[u];
      }
    }
  }
  // the elements past the last whole vector, one a thread
  const long long i = nvec * V + g;
  if (i < n) {
    const int ci = (int)(i % C);
    y[i] = from_f<T>(element<T>(to_f(y[i]), (M & RES) ? to_f(r[i]) : 0.f,
                                (M & BIAS) ? rnd<T>(__ldg(b + ci)) : 0.f,
                                (M & RES_BIAS) ? rnd<T>(__ldg(bp + ci)) : 0.f, M));
  }
}

// Any dense layout, one element a thread over a grid-stride loop: the channel
// from the offset, the mode M read at run time.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
strided_kernel(T* __restrict__ y, const T* __restrict__ r, const float* __restrict__ b,
               const float* __restrict__ bp, long long n, int C, long long inner, int M) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < n; i += stride) {
    const int c = (int)((i / inner) % C);
    y[i] = from_f<T>(element<T>(to_f(y[i]), (M & RES) ? to_f(r[i]) : 0.f,
                                (M & BIAS) ? rnd<T>(__ldg(b + c)) : 0.f,
                                (M & RES_BIAS) ? rnd<T>(__ldg(bp + c)) : 0.f, M));
  }
}

static long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

static int sm_count(int device) {
  static int sms[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return 0;
  if (!sms[device] &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms[device] = 0;
  return sms[device];
}

template <typename T, int M>
static cudaError_t launch(void* y, const void* r, const void* b, const void* bp, long long n, int C,
                          int device, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  static int per_sm = 0;  // CTAs resident on an SM
  if (!per_sm) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epilogue_kernel<T, M>, BLOCK, 0);
    if (err != cudaSuccess) return err;
  }
  const int sms = sm_count(device);
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidDevice;
  // the grid in CTAs: a multiple of m, so that its stride in elements is a
  // multiple of C; as many as the vectors need, up to what is resident
  const long long period = C / gcd(C, V);  // threads whose vectors span lcm(C, V) elements
  const long long m = period / gcd(period, BLOCK);
  const long long need = (n / V + BLOCK - 1) / BLOCK;
  const long long cap = (long long)sms * per_sm;
  const long long want = need < cap ? need : cap;
  const long long blocks = want >= m ? want / m * m : m;
  if (blocks > 0x7fffffffLL || (blocks * BLOCK * V) % C) return cudaErrorInvalidConfiguration;
  epilogue_kernel<T, M><<<(unsigned)blocks, BLOCK, 0, stream>>>(
      (T*)y, (const T*)r, (const float*)b, (const float*)bp, n, C);
  return cudaGetLastError();
}

// The instantiation for `mode`: every mode but the empty one and a residual
// bias without a residual.
template <typename T, int M = 1>
static cudaError_t dispatch(int mode, void* y, const void* r, const void* b, const void* bp,
                            long long n, int C, int device, cudaStream_t stream) {
  if constexpr (M == MODES) {
    return cudaErrorInvalidValue;
  } else {
    if constexpr (!((M & RES_BIAS) && !(M & RES))) {
      if (mode == M) return launch<T, M>(y, r, b, bp, n, C, device, stream);
    }
    return dispatch<T, M + 1>(mode, y, r, b, bp, n, C, device, stream);
  }
}

template <typename T>
static cudaError_t launch_strided(int mode, void* y, const void* r, const void* b, const void* bp,
                                  long long n, int C, long long inner, int device,
                                  cudaStream_t stream) {
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long need = (n + BLOCK - 1) / BLOCK;
  const long long blocks = need < 16LL * sms ? need : 16LL * sms;
  strided_kernel<T><<<(unsigned)blocks, BLOCK, 0, stream>>>(
      (T*)y, (const T*)r, (const float*)b, (const float*)bp, n, C, inner, mode);
  return cudaGetLastError();
}

}  // namespace fse_epilogue

extern "C" {

// y: n elements, dense, 16-byte aligned, read and written, the element at
// offset i in channel (i / inner) % C of C (inner 1: (..., C) contiguous); r:
// the residual, laid out as y, or null; b, bp: C fp32 each, or null. dtype 0
// is bf16, 1 fp32; mode the bits PRE 1, POST 2, BIAS 4, RES 8, RES_BIAS 16,
// each operand present iff its bit is set. Runs on `device`, made current only
// if it is not. Returns a CUDA error code: cudaGetLastError() after the launch.
int fse_epilogue_launch(void* y, const void* r, const void* b, const void* bp, long long n,
                        int C, long long inner, int dtype, int mode, int device, void* stream) {
  using namespace fse_epilogue;
  if (n < 1 || C < 1 || inner < 1 || n % (C * inner) || mode < 1 || mode >= MODES || !y ||
      !(mode & BIAS) != !b || !(mode & RES) != !r || !(mode & RES_BIAS) != !bp ||
      ((uintptr_t)y | (uintptr_t)r) % 16)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(inner == 1 ? dispatch<__nv_bfloat16>(mode, y, r, b, bp, n, C, device, s)
                            : launch_strided<__nv_bfloat16>(mode, y, r, b, bp, n, C, inner,
                                                            device, s));
  if (dtype == 1)
    return (int)(inner == 1 ? dispatch<float>(mode, y, r, b, bp, n, C, device, s)
                            : launch_strided<float>(mode, y, r, b, bp, n, C, inner, device, s));
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
