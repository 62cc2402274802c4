// Dense-LK shift-plane build on Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflow_ri_tpu/ops/pallas/lk_build.py:
// lk_build_planes_pallas (_lk_build_kernel).  For every integer shift
// s = (sy, sx) in [-R, R]^2 and both gradients g in {gx, gy} it writes
//     T_g[s](p) = wsum(J(p + s + off) * g(p + off))
// into two (nshift^2, h, w) stacks, sy-major, sx-minor -- the layout of the
// JAX package's build, which the GN kernel (csrc/lk_iter.cu) reads.
//
// Design: one block computes one 32x32 output tile for one shift, both
// gradients in turn.  It forms the 63x63 products J*g of the tile's windows
// in shared memory, runs the x-pass and then the y-pass of the masked window
// sum there, and writes the tile once.  Each pass is the factor ladder of
// ops/window_sums.py:_ladder_run, stage by stage (S_{m*f}(c) =
// sum_{j<f} S_m(c + j*m), added left to right), then the run's remainder taps,
// runs added in run order.  The runs and their factors come in as a table
// (lk_window.cuh), so every window the asymmetric configs select is served.
// Every value depends only on its inputs and their order, so built with
// -fmad=false the planes equal the plain PyTorch build
// (ops/cuda/lk_build.py:lk_build_planes_plain) bit for bit.
//
// What bounds it on an H100: the write of the stack, 2 * 121 * h * w * 4 B
// (254 MB at 512^2, ~76 us at 3.35 TB/s; 4.06 GB at 2048^2), against ~12
// adds per output that the ladder needs.  The 31-row and 31-column window
// halo of a 32x32 tile doubles the x-pass work and re-reads the slab from
// L2; a larger tile, or one block walking several shifts, is later work.
//
// The TPU kernel's split launch (lk_build_split_engages) and the stripe
// staging for large images (lk_striped_height) exist only because VMEM is
// small; the whole stack fits the H100's 80 GB up to 2048^2 and beyond, so
// they have no counterpart here.
#include <cuda_runtime.h>

#include "lk_window.cuh"

namespace {

using ofri_lk::kExt;
using ofri_lk::Run;
using ofri_lk::Runs;

constexpr int kTile = 32;             // output tile: kTile x kTile pixels
constexpr int kReg = kTile + kExt;    // 63 input rows / columns per tile
constexpr int kLd = 64;               // row stride of the kReg-wide buffers
constexpr int kThreads = 256;
constexpr size_t kSmemBytes = sizeof(float) * (3 * kReg * kLd + kReg * kTile);

// One ladder stage along x of a kReg-row buffer:
// dst[r][i] = sum_{j<f} src[r][i + j*m] for i < n_out, added left to right.
__device__ void ladder_stage_x(const float* src, float* dst, int f, int m, int n_out) {
  for (int idx = threadIdx.x; idx < kReg * n_out; idx += blockDim.x) {
    const int r = idx / n_out;
    const int i = idx - r * n_out;
    const float* s = src + r * kLd + i;
    float acc = s[0];
    for (int j = 1; j < f; ++j) acc = acc + s[j * m];
    dst[r * kLd + i] = acc;
  }
}

// One ladder stage along y of a buffer of kTile columns:
// dst[i][c] = sum_{j<f} src[i + j*m][c] for i < n_out.
__device__ void ladder_stage_y(const float* src, float* dst, int f, int m, int n_out) {
  for (int idx = threadIdx.x; idx < n_out * kTile; idx += blockDim.x) {
    const int i = idx / kTile;
    const int c = idx - i * kTile;
    const float* s = src + i * kTile + c;
    float acc = s[0];
    for (int j = 1; j < f; ++j) acc = acc + s[j * m * kTile];
    dst[i * kTile + c] = acc;
  }
}

// x-pass: X[r][x] = sum over runs of the run's ladder sum of P[r][x + ...].
__device__ void x_pass(const float* P, float* A, float* B, float* X, const Runs& runs) {
  for (int q = 0; q < runs.n; ++q) {
    const Run& run = runs.run[q];
    const float* cur = P;
    float* dst = A;
    int m = 1, width = kReg;
    for (int k = 0; k < run.nfac; ++k) {
      const int f = run.fac[k];
      const int nw = width - (f - 1) * m;
      ladder_stage_x(cur, dst, f, m, nw);
      __syncthreads();
      cur = dst;
      dst = (dst == A) ? B : A;
      m *= f;
      width = nw;
    }
    for (int idx = threadIdx.x; idx < kReg * kTile; idx += blockDim.x) {
      const int r = idx / kTile;
      const int x = idx - r * kTile;
      float t = cur[r * kLd + run.lo + x];
      for (int k = run.lo + m; k < run.lo + run.len; ++k) t = t + P[r * kLd + k + x];
      X[idx] = (q == 0) ? t : X[idx] + t;
    }
    __syncthreads();
  }
}

// y-pass: O[y][x] = sum over runs of the run's ladder sum of X[y + ...][x].
__device__ void y_pass(const float* X, float* A, float* B, float* O, const Runs& runs) {
  for (int q = 0; q < runs.n; ++q) {
    const Run& run = runs.run[q];
    const float* cur = X;
    float* dst = A;
    int m = 1, height = kReg;
    for (int k = 0; k < run.nfac; ++k) {
      const int f = run.fac[k];
      const int nh = height - (f - 1) * m;
      ladder_stage_y(cur, dst, f, m, nh);
      __syncthreads();
      cur = dst;
      dst = (dst == A) ? B : A;
      m *= f;
      height = nh;
    }
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
      const int y = idx / kTile;
      const int x = idx - y * kTile;
      float t = cur[(run.lo + y) * kTile + x];
      for (int k = run.lo + m; k < run.lo + run.len; ++k) t = t + X[(k + y) * kTile + x];
      O[idx] = (q == 0) ? t : O[idx] + t;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
lk_build_kernel(const float* __restrict__ slab, const float* __restrict__ g,
                float* __restrict__ t1, float* __restrict__ t2, int h, int w, int nshift,
                Runs runs_y, Runs runs_x) {
  extern __shared__ float smem[];
  float* P = smem;             // products, then the finished tile
  float* A = P + kReg * kLd;   // ladder stages
  float* B = A + kReg * kLd;
  float* X = B + kReg * kLd;   // x-pass result, kReg x kTile

  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int s = blockIdx.z;
  const int sy = s / nshift;
  const int sx = s - sy * nshift;
  const int core_h = h + kExt;
  const int core_w = w + kExt;
  const int slab_w = core_w + nshift - 1;
  const size_t plane = (size_t)h * w;

  for (int k = 0; k < 2; ++k) {
    const float* gk = g + (size_t)k * core_h * core_w;
    for (int idx = threadIdx.x; idx < kReg * kReg; idx += blockDim.x) {
      const int r = idx / kReg;
      const int c = idx - r * kReg;
      const int gy = y0 + r;
      const int gx = x0 + c;
      float p = 0.0f;  // outside the core: read by no output that is written
      if (gy < core_h && gx < core_w)
        p = slab[(size_t)(gy + sy) * slab_w + gx + sx] * gk[(size_t)gy * core_w + gx];
      P[r * kLd + c] = p;
    }
    __syncthreads();
    x_pass(P, A, B, X, runs_x);
    y_pass(X, A, B, P, runs_y);
    float* out = (k == 0 ? t1 : t2) + (size_t)s * plane;
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
      const int y = y0 + idx / kTile;
      const int x = x0 + idx % kTile;
      if (y < h && x < w) out[(size_t)y * w + x] = P[idx];
    }
    __syncthreads();
  }
}

}  // namespace

// Shift planes t1, t2 ((2R+1)^2, h, w) from the J slab (h+31+2R, w+31+2R) and
// the gradient pair g (2, h+31, w+31), all row-major float32 on `device`.
// runs_y, runs_x are host tables (lk_window.cuh).  Enqueues one launch on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a bad table).
extern "C" int ofri_lk_build(const float* slab, const float* g, float* t1, float* t2, int h,
                             int w, int R, const int* runs_y_table, const int* runs_x_table,
                             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Runs runs_y, runs_x;
  if (!ofri_lk::runs_from_table(runs_y_table, &runs_y) ||
      !ofri_lk::runs_from_table(runs_x_table, &runs_x) || R < 0 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(lk_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const int nshift = 2 * R + 1;
  dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, nshift * nshift);
  lk_build_kernel<<<grid, kThreads, kSmemBytes, stream>>>(slab, g, t1, t2, h, w, nshift, runs_y,
                                                          runs_x);
  return cudaGetLastError();
}
