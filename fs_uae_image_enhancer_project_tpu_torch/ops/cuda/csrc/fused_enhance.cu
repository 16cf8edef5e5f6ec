// K1's enhance entry: a whole enhance call of the lightweight pix_shuffle
// graph in one launch, uint8 RGBA frames in and uint8 RGBA frames out.
//
// No TPU kernel of its own: the JAX package runs export/enhance.py's prologue
// and epilogue around the Pallas stack as XLA ops. Here they, and the
// model's unshuffle, shuffle, residual add and relu, are folded into K1's
// load and store through two tables (stack_kernel_u8, the template
// stack_tile<1, true> of fused_stack_common.cuh, which describes it; the
// tables come from ops/cuda/fused_enhance.py). What it saves is launches
// and bytes, not operations: the eager composition around the bf16 entry
// (fused_stack.cu) took about 20 launches a call and 0.06-0.07 ms of device
// time a frame on the H100; this entry's bytes are the frame's 1.73 MB in
// (read twice, the second time from L2) and 1.73 MB out, against the bf16
// entry's 2.6 + 2.6 MB. Its operations are K1's, 29.5 GFLOP a frame (29.8
// us at 989 TFLOP/s), and bound it as they bound K1. A file of its own, so
// that nvcc compiles it beside fused_stack.cu and not after it.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The launch goes
// on the caller's stream, never synchronises and allocates nothing.

#include "fused_stack_common.cuh"

namespace fse_stack {

// K1's enhance entry: the uint8 RGBA frames in and out (H2 = H / 2, W2 =
// (W - crop) / 2).
__global__ void __launch_bounds__(NTHREADS, 1)
stack_kernel_u8(const U8Frames f, const uint2* __restrict__ w1, const uint2* __restrict__ w2,
                const uint2* __restrict__ w3, const uint2* __restrict__ w4,
                const uint2* __restrict__ w5, const uint2* __restrict__ w6,
                const uint2* __restrict__ w7, const float* __restrict__ prm, int H2, int W2) {
  stack_tile<1, true>(nullptr, nullptr, w1, w2, w3, w4, w5, w6, w7, prm, H2, W2, f);
}

}  // namespace fse_stack

extern "C" {

// The enhance entry's shared-memory limit on `device`: once a device, before
// its first launch there (the launch sets no attribute). Returns a CUDA
// error code.
int fse_fused_stack_u8_init(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = fse_stack::set_smem(fse_stack::stack_kernel_u8, fse_stack::Smem<1>::TOTAL);
  return (int)err;
}

// The enhance entry's registers, spills, shared memory and plan, as
// fse_fused_stack_info's.
int fse_fused_stack_u8_info(int* out, int device) {
  return fse_stack::kernel_info<1>(fse_stack::stack_kernel_u8, out, device);
}

// in, out: (frames, H, W, 4) uint8 RGBA, H, W and crop even, 8-byte aligned;
// lut_in: 256 bf16, the prologue's value of each byte; lut_out: 65,536
// uint8, relu and the epilogue of each bf16 bit pattern; w1..w7 and prm as
// fse_fused_stack's. Runs on `device`, made current only if it is not.
// Returns cudaGetLastError().
int fse_fused_stack_u8(const void* in, void* out, const void* lut_in, const void* lut_out,
                       const void* w1, const void* w2, const void* w3, const void* w4,
                       const void* w5, const void* w6, const void* w7, const void* prm,
                       int frames, int H, int W, int crop, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  using namespace fse_stack;
  const U8Frames f{(const uint8_t*)in, (uint8_t*)out, (const unsigned short*)lut_in,
                   (const uint8_t*)lut_out, H, W, crop};
  const int rows = H / 2, cols = (W - crop) / 2;
  const dim3 grid((cols + TW - 1) / TW, (rows + TH - 1) / TH, frames);
  stack_kernel_u8<<<grid, NTHREADS, Smem<1>::TOTAL, (cudaStream_t)stream>>>(
      f, (const uint2*)w1, (const uint2*)w2, (const uint2*)w3, (const uint2*)w4,
      (const uint2*)w5, (const uint2*)w6, (const uint2*)w7, (const float*)prm, rows, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
