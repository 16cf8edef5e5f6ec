// K1: the whole lightweight pix_shuffle conv stack in one kernel, one output
// pixel per matmul row.
//
// Replaces the Pallas TPU kernel
// fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack.py::_stack_kernel
// (driven there by _run_stack, entry point fused_stack_apply). The kernel
// itself is stack_kernel<1> in fused_stack_common.cuh, which describes the
// design; K2 (fused_stack_packed.cu) is the same kernel with two pixels per
// matmul row.
//
// Bound at the main path's shape (one 576x752 frame, crop 0: a 288x376x12
// bf16 half-resolution input): 136,080 multiply-adds per half-res pixel, so
// 29.5 GFLOP per frame (28.8 at crop 16), which is 29.8 us at the H100's
// 989 TFLOP/s dense bf16. The bytes are about 5.5 MB (input and output 2.6 MB
// each, weights 0.3 MB): 1.6 us at 3.35 TB/s. By the card's peaks the kernel
// is compute-bound. Its GEMMs: M = output pixels, N = cout padded to a
// multiple of 8 (12 -> 16, 36 -> 40), K = 9 taps x cin padded to 8 (12 -> 16,
// 36 -> 40). One CTA per 16x14 tile recomputes its 7-pixel halo.
// The first design (16x16 tiles, one m-tile a warp job, B fragments read
// from global memory by every job) reached about 4-5% of the bound; it read
// 9.4 MB of weights a CTA from L2 for 0.31 MB of weights. This design
// (fused_stack_common.cuh) stages each layer's weights in shared memory once
// a CTA and gives each warp up to 4 m-tiles that share every B fragment;
// scripts/sweep_fused_stack.py times it against the first design, and
// PERF.md keeps the numbers.
//
// This file is K1's bf16 entry, the stack alone (training validation, the
// exported programs' custom op, the plain comparisons); fused_enhance.cu is
// its enhance entry, a whole pix_shuffle enhance call in one launch (uint8
// RGBA in and out). Not yet done (later work): wgmma, epilogues that overlap
// the mma, cross-tile reuse to cut the halo recompute.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The launch goes
// on the caller's stream, never synchronises and allocates nothing.

#include "fused_stack_common.cuh"

extern "C" {

// Dynamic shared memory the kernel takes per block (for the wrapper's notes).
int fse_fused_stack_smem_bytes(void) { return fse_stack::Smem<1>::TOTAL; }

// The kernel's registers, spills and shared memory, and its plan (see
// fse_stack::kernel_info); out holds 8 ints.
int fse_fused_stack_info(int* out, int device) { return fse_stack::kernel_info<1>(out, device); }

// x: (frames, rows, cols, 12) bf16, y: the same shape, w1..w7: B-fragment
// weights, prm: the packed fp32 parameter vector. Returns cudaGetLastError().
int fse_fused_stack(const void* x, void* y, const void* w1, const void* w2,
                    const void* w3, const void* w4, const void* w5, const void* w6,
                    const void* w7, const void* prm, int frames, int rows, int cols,
                    int device, void* stream) {
  const void* w[7] = {w1, w2, w3, w4, w5, w6, w7};
  return fse_stack::launch_stack<1>(x, y, w, prm, frames, rows, cols, device, stream);
}

#ifdef FSE_PROFILE
// The phase stamps of the last launch (a build with -DFSE_PROFILE only).
int fse_fused_stack_profile(void* out) { return fse_stack::copy_stamps(out); }
#endif

}  // extern "C"
