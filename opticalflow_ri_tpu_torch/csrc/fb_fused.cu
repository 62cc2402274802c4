// The Farneback iteration loop in one cooperative launch on Hopper (sm_90a).
//
// Replaces opticalflow_ri_tpu/ops/pallas/fb_fused2.py: fb_fused2_pallas
// (_fb_fused2_kernel): n_iters rounds of updateMatrices, then the window
// blur and the 2x2 solve, in one launch.  On the TPU the loop body had to
// live in VMEM, which it outgrew (343 MB of scoped VMEM at 512^2), and its
// blur was reassociated into fold-matrix products.  Here M and the y-pass
// intermediate stay in device memory (2 x 5 planes, 10.5 MB at 512^2, which
// the 50 MB L2 holds), the phases are grid-stride loops over pixels, and
// cooperative_groups' grid barrier separates them:
//
//   M = um(f0)
//   repeat n_iters times:
//     sync; mid = y-pass(M)
//     sync; f = solve(scale * x-pass(mid)); M = um(f)   (the last round
//                                                        skips the um)
//
// updateMatrices at a pixel needs the flow of that pixel only, so it runs
// right after the solve that produced it, in the same thread: two barriers
// per round.  Every phase keeps the op order of fb_update_matrices.cu and
// fb_blur5_flow.cu, so the result equals n_iters rounds of
// update_matrices_plain -> blur5_flow_plain bit for bit; the TPU kernel's
// fold-matrix blur is within 1e-4 of that.
//
// What bounds it on an H100: the grid barriers and L2 traffic.  The grid is
// sized from the occupancy calculator so every block is resident (the
// condition of a cooperative launch), a few blocks per SM.  Per round the
// y-pass reads 33 M values per output and the x-pass 33 mid values, from
// L1/L2 (~350 MB of load requests at 512^2), with no shared-memory tiling.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fb_common.cuh"

namespace cg = cooperative_groups;

namespace {

using ofri_fb::BlurSpec;
using ofri_fb::UmParams;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fb_fused_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                const float* __restrict__ fx0, const float* __restrict__ fy0,
                float* __restrict__ fx, float* __restrict__ fy, float* __restrict__ m,
                float* __restrict__ mid, UmParams p, int n_iters, BlurSpec spec) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float taps[ofri_fb::kMaxTaps];
  const int n = spec.n;
  const int half = n / 2;
  const int h = p.h;
  const int w = p.w;
  const size_t npix = (size_t)h * w;
  const size_t start = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (int j = threadIdx.x; j < n; j += blockDim.x) taps[j] = spec.taps[j];
  __syncthreads();

  if (n_iters <= 0) {
    for (size_t i = start; i < npix; i += stride) {
      fx[i] = fx0[i];
      fy[i] = fy0[i];
    }
    return;
  }
  for (size_t i = start; i < npix; i += stride) {
    const int y = (int)(i / w);
    const int x = (int)(i - (size_t)y * w);
    float mm[5];
    ofri_fb::update_matrices_pixel(r0, r1, fx0[i], fy0[i], x, y, p, mm);
    for (int c = 0; c < 5; ++c) m[c * npix + i] = mm[c];
  }
  for (int it = 0; it < n_iters; ++it) {
    grid.sync();
    // y-pass of the five planes
    for (size_t k = start; k < 5 * npix; k += stride) {
      const size_t c = k / npix;
      const size_t i = k - c * npix;
      const int y = (int)(i / w);
      const int x = (int)(i - (size_t)y * w);
      const float* mc = m + c * npix + x;
      float acc = mc[(size_t)ofri_fb::border_index(y - half, h, spec.mode) * w] * taps[0];
      for (int j = 1; j < n; ++j)
        acc = acc + mc[(size_t)ofri_fb::border_index(y + j - half, h, spec.mode) * w] * taps[j];
      mid[k] = acc;
    }
    grid.sync();
    // x-pass, post-scale and solve; then M of the new flow at this pixel
    const bool last = it + 1 == n_iters;
    for (size_t i = start; i < npix; i += stride) {
      const int y = (int)(i / w);
      const int x = (int)(i - (size_t)y * w);
      float g[5];
      for (int c = 0; c < 5; ++c) {
        const float* row = mid + c * npix + (size_t)y * w;
        float acc = row[ofri_fb::border_index(x - half, w, spec.mode)] * taps[0];
        for (int j = 1; j < n; ++j)
          acc = acc + row[ofri_fb::border_index(x + j - half, w, spec.mode)] * taps[j];
        if (spec.scale != 1.0f) acc = acc * spec.scale;
        g[c] = acc;
      }
      float u, v;
      ofri_fb::solve_flow(g, &u, &v);
      fx[i] = u;
      fy[i] = v;
      if (!last) {
        float mm[5];
        ofri_fb::update_matrices_pixel(r0, r1, u, v, x, y, p, mm);
        for (int c = 0; c < 5; ++c) m[c * npix + i] = mm[c];
      }
    }
  }
}

}  // namespace

// n_iters rounds of updateMatrices -> blur + solve from the flow (fx0, fy0):
// r0, r1 (5, h, w), fx0, fy0 (h, w), outputs fx, fy (h, w), scratch m and
// mid (5, h, w) each, all row-major float32 on `device`; R and hi as for
// ofri_fb_update_matrices, the tap table as for ofri_fb_blur5_flow.  One
// cooperative launch on `stream`.  Returns cudaErrorNotSupported when the
// device cannot launch cooperatively, cudaErrorInvalidValue for bad
// arguments, else the launch's error.
extern "C" int ofri_fb_fused(const float* r0, const float* r1, const float* fx0, const float* fy0,
                             float* fx, float* fy, float* m, float* mid, int h, int w,
                             int n_iters, int R, float hi, const float* taps, int n, int mode,
                             float scale, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BlurSpec spec;
  if (h < 2 || w < 2 || n_iters < 0 ||
      !ofri_fb::blur_spec_from_host(taps, n, mode, scale, &spec))
    return cudaErrorInvalidValue;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fb_fused_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const size_t work = (size_t)5 * h * w;
  const size_t needed = (work + kThreads - 1) / kThreads;
  const size_t resident = (size_t)per_sm * sms;
  const int blocks = (int)(needed < resident ? needed : resident);
  UmParams p{h, w, R, hi};
  void* args[] = {(void*)&r0, (void*)&r1, (void*)&fx0, (void*)&fy0, (void*)&fx, (void*)&fy,
                  (void*)&m,  (void*)&mid, (void*)&p, (void*)&n_iters, (void*)&spec};
  err = cudaLaunchCooperativeKernel((const void*)fb_fused_kernel, dim3(blocks), dim3(kThreads),
                                    args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
