// Farneback window blur + flow solve on Hopper (sm_90a).
//
// Replaces opticalflow_ri_tpu/ops/pallas/blur5_flow.py: blur5_flow_pallas
// (_blur5_flow_kernel, M resident in VMEM) and blur5_flow_banded_pallas
// (_blur5_flow_banded_kernel, M streamed in row slabs for large fields): the
// separable window blur of the five M planes, y-pass then x-pass over all
// taps in order, the optional post-scale, then the regularised 2x2 solve;
// only the two flow planes are written.  The VMEM split has no counterpart:
// one kernel takes any H, W >= 2.
//
// A 256-thread block owns a 32x32 output tile.  For each plane it stages the
// tile and its (n/2)-pixel halo in shared memory, the border rule applied as
// an index rule (reflect-101 for "mirror", replicate for "nearest"; equal to
// the padded plain version for any pad width), runs the y-pass into a second
// buffer and the x-pass into the tile's blurred planes, then solves.  Taps
// come from the host as a table (ofri_fb::BlurSpec), any odd count up to
// kMaxTaps.
//
// What bounds it on an H100: shared-memory traffic and adds.  At 33 taps a
// pixel costs 5 x (2 x 33 + 33) shared-memory reads and as many adds (the
// y-pass also covers the x-halo columns), ~130 M of each at 512^2; device
// memory sees M read ~4x over (the halo re-reads, mostly from L2) and the
// flow written once.  The fused multiply-add is off
// (-fmad=false): each tap is a product then a sum, in the plain version's
// order, so the result is the same bits.
#include <cuda_runtime.h>

#include "fb_common.cuh"

namespace {

using ofri_fb::BlurSpec;

constexpr int kTile = 32;  // output tile side
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

size_t blur_smem_bytes(int n) {
  const size_t side = kTile + 2 * (n / 2);
  return sizeof(float) * (side * side + kTile * side + 5 * kTile * kTile);
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
blur5_flow_kernel(const float* __restrict__ m, float* __restrict__ fx_out,
                  float* __restrict__ fy_out, int h, int w, BlurSpec spec) {
  extern __shared__ float smem[];
  __shared__ float taps[ofri_fb::kMaxTaps];
  const int n = spec.n;
  const int half = n / 2;
  const int side = kTile + 2 * half;
  float* in = smem;                  // side x side: one plane's tile and halo
  float* mid = in + side * side;     // kTile x side: after the y-pass
  float* blur = mid + kTile * side;  // 5 x kTile x kTile: the blurred planes
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const size_t plane = (size_t)h * w;

  for (int j = tid; j < n; j += nthreads) taps[j] = spec.taps[j];
  for (int c = 0; c < 5; ++c) {
    const float* mc = m + c * plane;
    for (int idx = tid; idx < side * side; idx += nthreads) {
      const int r = idx / side;
      const int col = idx - r * side;
      const int gy = ofri_fb::border_index(y0 - half + r, h, spec.mode);
      const int gx = ofri_fb::border_index(x0 - half + col, w, spec.mode);
      in[idx] = mc[(size_t)gy * w + gx];
    }
    __syncthreads();
    // y-pass: mid[r][col] = sum_j in[r + j][col] * taps[j]
    for (int idx = tid; idx < kTile * side; idx += nthreads) {
      const float* src = in + idx;
      float acc = src[0] * taps[0];
      for (int j = 1; j < n; ++j) acc = acc + src[j * side] * taps[j];
      mid[idx] = acc;
    }
    __syncthreads();
    // x-pass: blur[c][r][col] = sum_j mid[r][col + j] * taps[j], then the post-scale
    for (int idx = tid; idx < kTile * kTile; idx += nthreads) {
      const int r = idx / kTile;
      const int col = idx - r * kTile;
      const float* src = mid + r * side + col;
      float acc = src[0] * taps[0];
      for (int j = 1; j < n; ++j) acc = acc + src[j] * taps[j];
      if (spec.scale != 1.0f) acc = acc * spec.scale;
      blur[c * kTile * kTile + idx] = acc;
    }
    // the next plane's loads overwrite `in` only: the y-pass that read it is
    // behind the barrier above, and `mid` is rewritten after the next one
  }
  __syncthreads();
  for (int idx = tid; idx < kTile * kTile; idx += nthreads) {
    const int r = idx / kTile;
    const int col = idx - r * kTile;
    const int y = y0 + r;
    const int x = x0 + col;
    if (y >= h || x >= w) continue;
    float g[5];
    for (int c = 0; c < 5; ++c) g[c] = blur[c * kTile * kTile + idx];
    const size_t i = (size_t)y * w + x;
    ofri_fb::solve_flow(g, fx_out + i, fy_out + i);
  }
}

}  // namespace

// Blur M (5, h, w) with the host tap table (n odd taps, mode 0 "mirror" or
// 1 "nearest", post-scale `scale`) and solve; writes the flow (h, w).  One
// launch on `stream`; returns cudaErrorInvalidValue for a malformed table or
// a tile that does not fit the device's shared memory, else
// cudaGetLastError().
extern "C" int ofri_fb_blur5_flow(const float* m, float* fx_out, float* fy_out, int h, int w,
                                  const float* taps, int n, int mode, float scale, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BlurSpec spec;
  if (h < 2 || w < 2 || !ofri_fb::blur_spec_from_host(taps, n, mode, scale, &spec))
    return cudaErrorInvalidValue;
  const size_t bytes = blur_smem_bytes(n);
  if (bytes > 48 * 1024) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    if (bytes + sizeof(float) * ofri_fb::kMaxTaps > (size_t)optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(blur5_flow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  blur5_flow_kernel<<<grid, block, bytes, stream>>>(m, fx_out, fy_out, h, w, spec);
  return cudaGetLastError();
}
