// K2: the lightweight pix_shuffle conv stack in one kernel, two output
// pixels per matmul row against pair-packed weights.
//
// Replaces the Pallas TPU kernel
// fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack_packed.py::_stack_kernel
// (driven there by _run_stack, entry point fused_stack_packed_apply). It
// computes K1's function; the kernel is stack_kernel<2> in
// fused_stack_common.cuh, which describes the design.
//
// What differs from K1 is the GEMM: each matmul row is an output pair
// (columns 2t, 2t+1), K is 3 rows x 4 columns x cin (the pair's windows
// union to columns 2t-1..2t+2), N is 2 cout, and the wrapper packs the
// weights as the Pallas wrapper's _pack_conv_weight does: (12 cin, 2 cout),
// a quarter of it structural zeros. So N needs no padding (conv7: 24 columns
// where K1 pads 12 to 16; cout 36: 72 where K1 pads to 40), and each A
// fragment serves two pixels; the price is 4/3 of the multiply-adds. On the
// TPU the [A|O] lane concat is built once per layer because lanes cannot be
// offset for free; in shared memory A[t] = O[t-1] is the previous pixel's
// address, so K2 keeps K1's per-pixel buffers, tile and halo scheme, with
// channel strides (20, 44, 76) that keep rows two pixels apart on distinct
// banks, one CTA per SM. Its weights are 2.5x K1's (0.77 MB), so the ring
// that stages them in shared memory runs layers 3-6 in chunks (5-11
// k-steps); the first design read 12.0 MB of weights a CTA from L2 (every
// warp job again), this one 0.77 MB. With each B fragment now serving up to
// 3 m-tiles in both forms, K2's fewer A loads a mma no longer make up for
// its 4/3 of K1's multiply-adds, and it is the slower of the two.
//
// Bound at the bench's shape (one 576x752 frame: 288x376x12 bf16): the
// useful work is K1's, 29.5 GFLOP, 29.8 us at 989 TFLOP/s dense bf16; the
// bytes (5.5 MB) take 1.6 us at 3.35 TB/s. Compute-bound, like K1.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The launch goes
// on the caller's stream, never synchronises and allocates nothing.

#include "fused_stack_common.cuh"

extern "C" {

int fse_fused_stack_packed_smem_bytes(void) { return fse_stack::Smem<2>::TOTAL; }

int fse_fused_stack_packed_info(int* out, int device) {
  return fse_stack::kernel_info<2>(out, device);
}

// The same interface as fse_fused_stack, with pair-packed B-fragment weights.
int fse_fused_stack_packed(const void* x, void* y, const void* w1, const void* w2,
                           const void* w3, const void* w4, const void* w5, const void* w6,
                           const void* w7, const void* prm, int frames, int rows, int cols,
                           int device, void* stream) {
  const void* w[7] = {w1, w2, w3, w4, w5, w6, w7};
  return fse_stack::launch_stack<2>(x, y, w, prm, frames, rows, cols, device, stream);
}

#ifdef FSE_PROFILE
// The phase stamps of the last launch (a build with -DFSE_PROFILE only).
int fse_fused_stack_packed_profile(void* out) { return fse_stack::copy_stamps(out); }
#endif

}  // extern "C"
