// Farneback updateMatrices on Hopper (sm_90a).
//
// Replaces three TPU kernels of opticalflow_ri_tpu/ops/pallas/tent_sample.py:
// update_matrices_pallas (_update_matrices_kernel), its shift-skipping twin
// update_matrices_sparse_pallas, and the channel-blocked sampler
// tent_sample_channel_call (dense, sparse and sparse2d bodies) that
// update_matrices_channel_pallas feeds into the XLA assemble_m.  Those
// kernels contract a tent over all (2R+1)^2 = 121 integer shifts because
// per-pixel gathers are slow on a TPU; the sparse and channel variants exist
// to skip zero terms and to fit VMEM.  Here one thread per pixel reads the
// 2x2 enclosing samples of each of the five R1 planes directly and assembles
// M in the same pass, so the sampled field never reaches device memory
// (ofri_fb::update_matrices_pixel, fb_common.cuh).  The exact gather of
// sample_max_shift=None is the same kernel with R < 0.  The stripe mode
// (row0, img_h and an R1 with a_top / a_bot neighbour rows) replaces the
// channel sampler's use on a caller-padded R1 in the rows-sharded solve
// (parallel/sharded_pallas.py:387-408 there, parallel/sharded_kernel.py
// here).
//
// What bounds it on an H100: bytes.  Per pixel it reads 2 flow values, the 5
// R0 values and 20 R1 samples, and writes 5 M values: ~96 B from device
// memory when the R1 gathers hit in cache (they do for the smooth flows of
// PIV: neighbouring threads sample neighbouring pixels), 25 MB at 512^2,
// ~8 us at 3.35 TB/s.
#include <cuda_runtime.h>

#include "fb_common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
update_matrices_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                       const float* __restrict__ flowx, const float* __restrict__ flowy,
                       float* __restrict__ m, ofri_fb::UmParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const size_t i = (size_t)y * p.w + x;
  const size_t plane = (size_t)p.h * p.w;
  float mm[5];
  ofri_fb::update_matrices_pixel(r0, r1, flowx[i], flowy[i], x, y, p, mm);
  for (int c = 0; c < 5; ++c) m[c * plane + i] = mm[c];
}

}  // namespace

// M (5, h, w) from R0 (5, h, w), R1 (5, a_top + h + a_bot, w) and the flow
// (h, w), all row-major float32 on `device`.  R >= 0: the tent sampler
// clipped to [-R, hi], hi the float32 rounding of R - 1e-3; R < 0: the exact
// gather (whole image only).  The field covers global rows [row0, row0 + h)
// of an img_h-row image (the stripe mode, ofri_fb::UmParams).  One launch on
// `stream`; returns cudaErrorInvalidValue for a bad extent, else
// cudaGetLastError().
extern "C" int ofri_fb_update_matrices(const float* r0, const float* r1, const float* flowx,
                                       const float* flowy, float* m, int h, int w, int R,
                                       float hi, int row0, int img_h, int a_top, int a_bot,
                                       int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool whole = row0 == 0 && img_h == h && a_top == 0 && a_bot == 0;
  if (h < 2 || w < 2 || row0 < 0 || img_h < row0 + h || a_top < 0 || a_bot < 0 ||
      (R < 0 && !whole))
    return cudaErrorInvalidValue;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  update_matrices_kernel<<<grid, block, 0, stream>>>(
      r0, r1, flowx, flowy, m, ofri_fb::UmParams{h, w, R, hi, row0, img_h, a_top, a_bot});
  return cudaGetLastError();
}
