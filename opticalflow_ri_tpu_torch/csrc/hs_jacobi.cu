// Horn-Schunck Jacobi relaxation on Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package with one implementation:
//   opticalflow_ri_tpu/ops/pallas/hs_iter.py:hs_iterate_pallas        (whole state in VMEM)
//   opticalflow_ri_tpu/ops/pallas/hs_tiled.py:hs_iterate_pallas_tiled (T=20 temporal blocking)
// Whole-state VMEM residency has no per-SM counterpart; the 512^2 state
// (fx, fy, ft, 1/denom, u, v: 6 MB) sits in the 50 MB L2 anyway, so the same
// kernel serves every shape, with no 8x128 alignment gate.
//
// What bounds it on an H100: one launch per iteration, each reading 24 B and
// writing 8 B per pixel.  At 512^2 that is 8 MB per iteration out of L2, about
// as long as the launch itself, so a PIV-sized solve (100-600 iterations) is
// launch-bound.  At 2048^2 (96 MB of state) each iteration streams HBM.
// What this design does about it: the simplest right form -- one thread per
// pixel, two ping-pong buffer pairs, the launch loop in C so the host pays one
// call per solve.  Temporal blocking in shared memory (the mirror-pad-by-T
// trick of hs_tiled.py) or a CUDA graph is the next step.
//
// Numerics: the association order is that of ops/stencil.py:hs_avg3x3 and
// models/horn_schunck.py:hs_solve; built with -fmad=false, the kernel equals
// the plain PyTorch version (ops/cuda/hs_iter.py:hs_iterate_plain) bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr float kTwelfth = static_cast<float>(1.0 / 12.0);

__global__ void hs_recip_denom_kernel(const float* __restrict__ fx,
                                      const float* __restrict__ fy, float alpha,
                                      float* __restrict__ rd, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = fx[i];
  float b = fy[i];
  rd[i] = 1.0f / ((alpha * alpha + a * a) + b * b);
}

// (l + 2c) + r along one row, mirror-indexed columns
__device__ __forceinline__ float row121(const float* __restrict__ r, int xm, int x, int xp) {
  return (r[xm] + 2.0f * r[x]) + r[xp];
}

__device__ __forceinline__ float avg3x3(const float* __restrict__ f, int ym, int y, int yp,
                                        int xm, int x, int xp, int w) {
  float q = (row121(f + (size_t)ym * w, xm, x, xp) + 2.0f * row121(f + (size_t)y * w, xm, x, xp)) +
            row121(f + (size_t)yp * w, xm, x, xp);
  return (q - 4.0f * f[(size_t)y * w + x]) * kTwelfth;
}

__global__ void hs_step_kernel(const float* __restrict__ fx, const float* __restrict__ fy,
                               const float* __restrict__ ft, const float* __restrict__ rd,
                               const float* __restrict__ u, const float* __restrict__ v,
                               float* __restrict__ un, float* __restrict__ vn, int h, int w) {
  int x = blockIdx.x * kBlockX + threadIdx.x;
  int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  // mirror border (edge not repeated): -1 -> 1, n -> n-2; needs n >= 2
  int xm = x > 0 ? x - 1 : 1;
  int xp = x < w - 1 ? x + 1 : w - 2;
  int ym = y > 0 ? y - 1 : 1;
  int yp = y < h - 1 ? y + 1 : h - 2;
  size_t i = (size_t)y * w + x;
  float ua = avg3x3(u, ym, y, yp, xm, x, xp, w);
  float va = avg3x3(v, ym, y, yp, xm, x, xp, w);
  float gx = fx[i];
  float gy = fy[i];
  float der = ((gx * ua + gy * va) + ft[i]) * rd[i];
  un[i] = ua - gx * der;
  vn[i] = va - gy * der;
}

}  // namespace

// niter Jacobi iterations from (u0, v0); the result lands in (u_out, v_out).
// rd, u_tmp and v_tmp are H*W scratch buffers.  Returns cudaGetLastError().
extern "C" int ofri_hs_iterate(const float* fx, const float* fy, const float* ft,
                               const float* u0, const float* v0, float alpha, int niter,
                               int h, int w, float* rd, float* u_out, float* v_out,
                               float* u_tmp, float* v_tmp, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  size_t bytes = (size_t)h * w * sizeof(float);
  if (niter <= 0) {
    cudaMemcpyAsync(u_out, u0, bytes, cudaMemcpyDeviceToDevice, stream);
    cudaMemcpyAsync(v_out, v0, bytes, cudaMemcpyDeviceToDevice, stream);
    return cudaGetLastError();
  }
  int n = h * w;
  hs_recip_denom_kernel<<<(n + 255) / 256, 256, 0, stream>>>(fx, fy, alpha, rd, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  const float* su = u0;
  const float* sv = v0;
  // the first write goes to the buffer that makes the last one land in *_out
  float* du = (niter % 2) ? u_out : u_tmp;
  float* dv = (niter % 2) ? v_out : v_tmp;
  for (int k = 0; k < niter; ++k) {
    hs_step_kernel<<<grid, block, 0, stream>>>(fx, fy, ft, rd, su, sv, du, dv, h, w);
    su = du;
    sv = dv;
    du = (du == u_out) ? u_tmp : u_out;
    dv = (dv == v_out) ? v_tmp : v_out;
  }
  return cudaGetLastError();
}
