// Farneback window blur + flow solve on Hopper (sm_90a).
//
// Replaces opticalflow_ri_tpu/ops/pallas/blur5_flow.py: blur5_flow_pallas
// (_blur5_flow_kernel, M resident in VMEM) and blur5_flow_banded_pallas
// (_blur5_flow_banded_kernel, M streamed in row slabs for large fields): the
// separable window blur of the five M planes, y-pass then x-pass over all
// taps in order, the optional post-scale, then the regularised 2x2 solve;
// only the two flow planes are written.  The VMEM split has no counterpart:
// one kernel takes any H, W >= 2 and any odd tap count up to kMaxTaps (taps
// from the host as a table, ofri_fb::BlurSpec).
//
// What bounds it on an H100: the arithmetic.  At n taps a pixel costs 5 x 2
// x n products and as many sums (n = 33: 0.17 G of each at 512^2); device
// memory sees M read once and the flow written once (28 B a pixel).  The
// fused multiply-add is off (-fmad=false): each tap is a product then a sum,
// in the plain version's order, so the result is the same bits -- and the
// card issues two instructions per tap where the bound's 67 TFLOP/s counts
// one fused one.
//
// Design (what it does about that bound): a 640-thread block owns a 32 x 64
// output tile, and five groups of 128 threads blur the five planes side by
// side (the planes are independent until the solve), so a tile has 20 warps
// in flight and M is read once per tile.
//   * Register blocking along each pass: a thread owns R = 8 consecutive
//     outputs and slides a ring of R inputs along the taps, so each input is
//     read once per thread and each tap costs one load, R products and R
//     sums for R outputs.  Per output the taps still add in ascending order,
//     from -0 (-0 + p = p exactly), so the bits do not change.
//   * y-pass: straight from device memory (the tile's slab of a plane stays
//     in L1), lanes along the columns, R rows a thread, into the group's
//     slab in shared memory (32 rows x (64 + n - 1) columns, an odd stride);
//     x-pass: lanes along the rows, R columns a thread, conflict-free by the
//     odd stride.  The border rule is a table of source rows and columns per
//     tile (reflect-101 for "mirror", replicate for "nearest"; equal to the
//     padded plain version for any pad width).
//   * One group barrier between the passes, one block barrier before the
//     solve, which reads the five blurred planes from shared memory.
// Shared memory: 104 KB at 33 taps, 165 KB at 129.
#include <cuda_runtime.h>

#include "fb_common.cuh"

namespace {

using ofri_fb::BlurSpec;
using ofri_fb::kMaxTaps;

constexpr int kTH = 32;                  // output tile rows: one warp's lanes in the x-pass
constexpr int kTW = 64;                  // output tile columns
constexpr int kR = 8;                    // outputs a thread sums in each pass
constexpr int kGroup = 128;              // threads blurring one plane
constexpr int kThreads = 5 * kGroup;     // 640
constexpr int kBlurStride = kTW + 1;     // odd: the x-pass's stores are conflict-free
constexpr int kMaxDevices = 64;
static_assert(kTH == 32, "the x-pass puts one tile row on each lane of a warp");
static_assert(kTH % kR == 0 && kTW % kR == 0, "passes cover the tile in runs of R");
static_assert(kGroup % 32 == 0, "a plane's group is whole warps");

// the y-pass's row stride in shared memory: the span of the x-pass's
// inputs, made odd
__host__ __device__ int mid_stride(int n) { return (kTW + n - 1) | 1; }

size_t smem_bytes(int n) {
  return sizeof(float) * 5 * kTH * ((size_t)mid_stride(n) + kBlurStride);
}

// R consecutive outputs of an n-tap correlation: acc[o] = sum_j in(o + j) *
// taps[j], the taps added in ascending order.  load(i) returns input i; each
// is read once, into a ring of R registers (input i in slot i % R).
template <int R, class Load>
__device__ __forceinline__ void slide(int n, const float* taps, Load load, float (&acc)[R]) {
  float ring[R];
#pragma unroll
  for (int q = 0; q < R - 1; ++q) ring[q] = load(q);
#pragma unroll
  for (int o = 0; o < R; ++o) acc[o] = -0.0f;
  int j0 = 0;
  for (; j0 + R <= n; j0 += R) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      ring[(q + R - 1) % R] = load(j0 + q + R - 1);
      const float t = taps[j0 + q];
#pragma unroll
      for (int o = 0; o < R; ++o) acc[o] = acc[o] + ring[(o + q) % R] * t;
    }
  }
  // fewer than R taps left: the same ring slots, j0 is a multiple of R
#pragma unroll
  for (int q = 0; q < R - 1; ++q) {
    if (j0 + q < n) {
      ring[(q + R - 1) % R] = load(j0 + q + R - 1);
      const float t = taps[j0 + q];
#pragma unroll
      for (int o = 0; o < R; ++o) acc[o] = acc[o] + ring[(o + q) % R] * t;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
blur5_flow_kernel(const float* __restrict__ m, float* __restrict__ fx_out,
                  float* __restrict__ fy_out, int h, int w, BlurSpec spec) {
  extern __shared__ float smem[];
  __shared__ float taps[kMaxTaps];
  __shared__ int src_row[kTH + kMaxTaps - 1];
  __shared__ int src_col[kTW + kMaxTaps - 1];
  const int n = spec.n;
  const int half = n / 2;
  const int span = kTW + n - 1;  // columns of the y-pass
  const int stride = mid_stride(n);
  float* mid = smem;                        // 5 x kTH x stride: after the y-pass
  float* blur = mid + 5 * kTH * stride;     // 5 x kTH x kBlurStride: the blurred planes
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const size_t plane = (size_t)h * w;

  for (int j = tid; j < n; j += kThreads) taps[j] = spec.taps[j];
  for (int i = tid; i < kTH + n - 1; i += kThreads)
    src_row[i] = ofri_fb::border_index(y0 - half + i, h, spec.mode);
  for (int i = tid; i < span; i += kThreads)
    src_col[i] = ofri_fb::border_index(x0 - half + i, w, spec.mode);
  __syncthreads();

  const int c = tid / kGroup;  // this group's plane
  const int g = tid % kGroup;
  const float* mc = m + c * plane;
  float* midc = mid + c * kTH * stride;
  // y-pass: mid[r][col] = sum_j M[row(r + j)][col(col)] * taps[j], R rows a thread
  for (int item = g; item < (kTH / kR) * span; item += kGroup) {
    const int rb = item / span;
    const int col = item - rb * span;
    const float* src = mc + src_col[col];
    const int* rows = src_row + rb * kR;
    float acc[kR];
    slide<kR>(n, taps, [&](int i) { return __ldg(src + (size_t)rows[i] * w); }, acc);
#pragma unroll
    for (int q = 0; q < kR; ++q) midc[(rb * kR + q) * stride + col] = acc[q];
  }
  // the group's own barrier: the x-pass reads only its plane's slab
  asm volatile("bar.sync %0, %1;" ::"r"(1 + c), "r"(kGroup) : "memory");
  // x-pass: blur[c][r][col] = sum_j mid[r][col + j] * taps[j], R columns a
  // thread, then the post-scale
  for (int item = g; item < kTH * (kTW / kR); item += kGroup) {
    const int r = item % kTH;
    const int cb = item / kTH;
    const float* src = midc + r * stride + cb * kR;
    float acc[kR];
    slide<kR>(n, taps, [&](int i) { return src[i]; }, acc);
    float* dst = blur + (c * kTH + r) * kBlurStride + cb * kR;
#pragma unroll
    for (int q = 0; q < kR; ++q) dst[q] = spec.scale != 1.0f ? acc[q] * spec.scale : acc[q];
  }
  __syncthreads();
  for (int p = tid; p < kTH * kTW; p += kThreads) {
    const int r = p / kTW;
    const int col = p - r * kTW;
    const int y = y0 + r;
    const int x = x0 + col;
    if (y >= h || x >= w) continue;
    float gv[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) gv[q] = blur[(q * kTH + r) * kBlurStride + col];
    const size_t i = (size_t)y * w + x;
    ofri_fb::solve_flow(gv, fx_out + i, fy_out + i);
  }
}

}  // namespace

// Blur M (5, h, w) with the host tap table (n odd taps, mode 0 "mirror" or
// 1 "nearest", post-scale `scale`) and solve; writes the flow (h, w).  One
// launch on `stream`; returns cudaErrorInvalidValue for a malformed table,
// else cudaGetLastError().
extern "C" int ofri_fb_blur5_flow(const float* m, float* fx_out, float* fy_out, int h, int w,
                                  const float* taps, int n, int mode, float scale, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BlurSpec spec;
  if (h < 2 || w < 2 || !ofri_fb::blur_spec_from_host(taps, n, mode, scale, &spec))
    return cudaErrorInvalidValue;
  // the shared-memory opt-in for the largest window, once per device: the
  // call costs host time
  static bool opted_in[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(blur5_flow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxTaps));
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH);
  blur5_flow_kernel<<<grid, kThreads, smem_bytes(n), stream>>>(m, fx_out, fy_out, h, w, spec);
  return cudaGetLastError();
}
