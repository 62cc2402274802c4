// Dense-LK Gauss-Newton loop on Hopper (sm_90a): two kernels.
//
// lk_gn_kernel replaces opticalflow_ri_tpu/ops/pallas/lk_iter.py:
// lk_gn_iterate_pallas (_lk_gn_kernel).  One thread per pixel runs all n_iter
// steps.  Each step needs T1 and T2 at the pixel's displacement, a bilinear
// blend of the 2x2 enclosing integer shifts.  The TPU kernel contracts a tent
// over all (2R+1)^2 planes because per-pixel gathers are slow there; here the
// thread reads just the 4 planes of each stack whose tent weight can be
// non-zero.  Their weights are the tent's, max(0, 1 - |uc - s|) for
// s = floor(uc) and floor(uc) + 1, and they are added as the TPU kernel adds
// them: ty = sum over sy, then s = sum over sx, both ascending, from 0.  The
// other weights are exactly 0 (|uc - s| >= 1 rounds to >= 1), so the 4-tap form
// is the same sum.  (Weights formed as fx = uc - floor(uc) and 1 - fx would
// not be: at uc = 1e-10 the tent gives the upper corner 0, fx gives 1e-10.)
// The rest is models/lucas_kanade.py:401-435: the f32 window origin (px, py),
// the out-of-bounds bail tested before the update, the clamp to
// [-R, R - 1e-3], the x32 step, the |delta| < 0.01 exit, active and status as
// 0/1 floats.
//
// lk_fused_kernel replaces ops/pallas/lk_iter.py:lk_fused_pallas
// (_lk_fused_kernel): the build and the GN loop in one launch, the planes
// kept out of device memory.  A block owns an 8x16 pixel tile.  For every
// shift and gradient it forms the 39x47 products J*g, runs the two-level
// window sum of ops/window_sums.py (hierarchical=True: a base box of width a,
// L // a strided base terms, remainder taps; x-pass, then y-pass), and keeps
// the tile's 242 plane values in shared memory (968 B per pixel, 124 KB for
// the tile at R = 5).  Then each thread runs the same GN loop from there.
//
// What bounds them on an H100:
//   * lk_gn: per pixel 10 field reads and 3 writes, plus 8 gathered plane
//     reads per step (5 steps: 204 B per pixel, 53 MB at 512^2, ~16 us at
//     3.35 TB/s).  The gathers land on neighbouring pixels of one plane for
//     the smooth flows of PIV, so they coalesce well.
//   * lk_fused: arithmetic and shared memory.  An 8-row tile re-does the
//     31-row window halo of the x-pass for every tile (39/8 ~ 5x the rows),
//     the cost that made the TPU version slower than build + GN; and 144 KB of
//     shared memory allow one 128-thread block per SM.  It is expected to be
//     slower than lk_build + lk_gn; both times are recorded in PERF.md.
//
// Built with -fmad=false, both equal their plain PyTorch versions
// (ops/cuda/lk_iter.py: lk_gn_iterate_plain, lk_fused_plain) bit for bit.
// The TPU kernel's stripe arguments (row0, img_h) serve the VMEM-sized
// stripe staging of large images, which has no counterpart on the card.
#include <cuda_runtime.h>

#include "lk_window.cuh"

namespace {

using ofri_lk::kExt;
using ofri_lk::Run;
using ofri_lk::Runs;

struct GnParams {
  int h, w, n_iter, R;
  float hw;  // the half window, as the float the bail and u, v use
  float hi;  // float32(R - 1e-3), the upper clamp
};

// The GN loop of one pixel; T(k, s) reads plane s of stack k (0: T1, 1: T2)
// at this pixel.
template <class Planes>
__device__ __forceinline__ void gn_pixel(const Planes& T, const GnParams& p, float ia11,
                                         float ia12, float ia22, float c1, float c2,
                                         float active, float px, float py, float jj, float ii,
                                         float* px_out, float* py_out, float* status_out) {
  const int nshift = 2 * p.R + 1;
  const float lo = (float)(-p.R);
  const float fw = (float)p.w;
  const float fh = (float)p.h;
  float status = 1.0f;
  for (int it = 0; it < p.n_iter; ++it) {
    const float oob = (px < -p.hw || px >= fw || py < -p.hw || py >= fh) ? 1.0f : 0.0f;
    status = status * (1.0f - active * oob);
    active = active * (1.0f - oob);

    const float u = (px + p.hw) - jj;
    const float v = (py + p.hw) - ii;
    const float uc = fminf(fmaxf(u, lo), p.hi);
    const float vc = fminf(fmaxf(v, lo), p.hi);
    const float sx = floorf(uc);
    const float sy = floorf(vc);
    const float wx0 = fmaxf(0.0f, 1.0f - fabsf(uc - sx));
    const float wx1 = fmaxf(0.0f, 1.0f - fabsf(uc - (sx + 1.0f)));
    const float wy0 = fmaxf(0.0f, 1.0f - fabsf(vc - sy));
    const float wy1 = fmaxf(0.0f, 1.0f - fabsf(vc - (sy + 1.0f)));
    const int s00 = ((int)sy + p.R) * nshift + ((int)sx + p.R);

    const float a0 = wy0 * T(0, s00) + wy1 * T(0, s00 + nshift);
    const float a1 = wy0 * T(0, s00 + 1) + wy1 * T(0, s00 + nshift + 1);
    const float s1 = wx0 * a0 + wx1 * a1;
    const float e0 = wy0 * T(1, s00) + wy1 * T(1, s00 + nshift);
    const float e1 = wy0 * T(1, s00 + 1) + wy1 * T(1, s00 + nshift + 1);
    const float s2 = wx0 * e0 + wx1 * e1;
    const float b1 = s1 - c1;
    const float b2 = s2 - c2;

    const float dx = (ia12 * b2 - ia22 * b1) * 32.0f;
    const float dy = (ia12 * b1 - ia11 * b2) * 32.0f;
    px = px + dx * active;
    py = py + dy * active;
    const float small = (fabsf(dx) < 0.01f && fabsf(dy) < 0.01f) ? 1.0f : 0.0f;
    active = active * (1.0f - small);
  }
  *px_out = px;
  *py_out = py;
  *status_out = status;
}

// ------------------------------------------------------------------ lk_gn

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct GlobalPlanes {
  const float* t1;
  const float* t2;
  size_t plane;
  size_t pix;
  __device__ float operator()(int k, int s) const {
    return (k == 0 ? t1 : t2)[(size_t)s * plane + pix];
  }
};

__global__ void lk_gn_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
                             const float* __restrict__ ia11, const float* __restrict__ ia12,
                             const float* __restrict__ ia22, const float* __restrict__ c1,
                             const float* __restrict__ c2, const float* __restrict__ act0,
                             const float* __restrict__ px0, const float* __restrict__ py0,
                             float* __restrict__ px_out, float* __restrict__ py_out,
                             float* __restrict__ status_out, GnParams p) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const size_t i = (size_t)y * p.w + x;
  const GlobalPlanes T{t1, t2, (size_t)p.h * p.w, i};
  gn_pixel(T, p, ia11[i], ia12[i], ia22[i], c1[i], c2[i], act0[i], px0[i], py0[i], (float)x,
           (float)y, px_out + i, py_out + i, status_out + i);
}

// --------------------------------------------------------------- lk_fused

constexpr int kFH = 8;                 // tile rows
constexpr int kFW = 16;                // tile columns
constexpr int kFThreads = kFH * kFW;   // one thread per pixel of the tile
constexpr int kFRH = kFH + kExt;       // 39 input rows per tile
constexpr int kFRW = kFW + kExt;       // 47 input columns per tile
constexpr int kFLd = 48;               // row stride of the kFRW-wide buffers

size_t fused_smem_bytes(int nshift) {
  return sizeof(float) * ((size_t)2 * nshift * nshift * kFThreads + 2 * kFRH * kFLd +
                          2 * kFRH * kFW);
}

struct SmemPlanes {
  const float* planes;
  int nplanes;
  int tid;
  __device__ float operator()(int k, int s) const {
    return planes[(k * nplanes + s) * kFThreads + tid];
  }
};

// Two-level x-pass of one run into X (kFRH x kFW): X[r][x] (+)= sum_{j<b}
// base[r][lo + a*j + x] + remainder taps, base[r][i] = sum_{i'<a} P[r][i + i'].
__device__ void fused_x_run(const float* P, float* base, float* X, const Run& run, bool first) {
  const int a = run.a;
  const float* bp = P;
  if (a > 1) {
    const int nw = kFRW - a + 1;
    for (int idx = threadIdx.x; idx < kFRH * nw; idx += blockDim.x) {
      const int r = idx / nw;
      const int i = idx - r * nw;
      const float* s = P + r * kFLd + i;
      float acc = s[0];
      for (int j = 1; j < a; ++j) acc = acc + s[j];
      base[r * kFLd + i] = acc;
    }
    __syncthreads();
    bp = base;
  }
  const int b = run.len / a;
  for (int idx = threadIdx.x; idx < kFRH * kFW; idx += blockDim.x) {
    const int r = idx / kFW;
    const int x = idx - r * kFW;
    const float* row = bp + r * kFLd + run.lo + x;
    float t = row[0];
    for (int j = 1; j < b; ++j) t = t + row[a * j];
    for (int k = run.lo + a * b; k < run.lo + run.len; ++k) t = t + P[r * kFLd + k + x];
    X[idx] = first ? t : X[idx] + t;
  }
  __syncthreads();
}

// Two-level y-pass of one run for this thread's pixel (ty, tx); returns the
// run's term.  base has kFW columns.
__device__ float fused_y_run(const float* X, float* base, const Run& run) {
  const int a = run.a;
  const float* bp = X;
  if (a > 1) {
    const int nh = kFRH - a + 1;
    for (int idx = threadIdx.x; idx < nh * kFW; idx += blockDim.x) {
      const float* s = X + idx;
      float acc = s[0];
      for (int j = 1; j < a; ++j) acc = acc + s[j * kFW];
      base[idx] = acc;
    }
    __syncthreads();
    bp = base;
  }
  const int ty = threadIdx.x / kFW;
  const int tx = threadIdx.x - ty * kFW;
  const int b = run.len / a;
  const float* col = bp + (run.lo + ty) * kFW + tx;
  float t = col[0];
  for (int j = 1; j < b; ++j) t = t + col[a * j * kFW];
  for (int k = run.lo + a * b; k < run.lo + run.len; ++k) t = t + X[(k + ty) * kFW + tx];
  __syncthreads();  // base is rewritten by the next run
  return t;
}

__global__ void __launch_bounds__(kFThreads)
lk_fused_kernel(const float* __restrict__ slab, const float* __restrict__ g,
                const float* __restrict__ ia11, const float* __restrict__ ia12,
                const float* __restrict__ ia22, const float* __restrict__ c1,
                const float* __restrict__ c2, const float* __restrict__ act0,
                const float* __restrict__ px0, const float* __restrict__ py0,
                float* __restrict__ px_out, float* __restrict__ py_out,
                float* __restrict__ status_out, GnParams p, Runs runs_y, Runs runs_x) {
  extern __shared__ float smem[];
  const int nshift = 2 * p.R + 1;
  const int nplanes = nshift * nshift;
  float* planes = smem;                              // [2][nplanes][kFThreads]
  float* P = planes + 2 * nplanes * kFThreads;       // kFRH x kFLd products
  float* bx = P + kFRH * kFLd;                       // kFRH x kFLd x-pass base
  float* X = bx + kFRH * kFLd;                       // kFRH x kFW x-pass result
  float* by = X + kFRH * kFW;                        // kFRH x kFW y-pass base

  const int x0 = blockIdx.x * kFW;
  const int y0 = blockIdx.y * kFH;
  const int core_h = p.h + kExt;
  const int core_w = p.w + kExt;
  const int slab_w = core_w + nshift - 1;

  for (int s = 0; s < nplanes; ++s) {
    const int sy = s / nshift;
    const int sx = s - sy * nshift;
    for (int k = 0; k < 2; ++k) {
      const float* gk = g + (size_t)k * core_h * core_w;
      for (int idx = threadIdx.x; idx < kFRH * kFRW; idx += blockDim.x) {
        const int r = idx / kFRW;
        const int c = idx - r * kFRW;
        const int gy = y0 + r;
        const int gx = x0 + c;
        float v = 0.0f;  // outside the core: read by no pixel that is written
        if (gy < core_h && gx < core_w)
          v = slab[(size_t)(gy + sy) * slab_w + gx + sx] * gk[(size_t)gy * core_w + gx];
        P[r * kFLd + c] = v;
      }
      __syncthreads();
      for (int q = 0; q < runs_x.n; ++q) fused_x_run(P, bx, X, runs_x.run[q], q == 0);
      float acc = 0.0f;
      for (int q = 0; q < runs_y.n; ++q) {
        const float t = fused_y_run(X, by, runs_y.run[q]);
        acc = (q == 0) ? t : acc + t;
      }
      planes[(k * nplanes + s) * kFThreads + threadIdx.x] = acc;
    }
  }

  const int ty = threadIdx.x / kFW;
  const int tx = threadIdx.x - ty * kFW;
  const int y = y0 + ty;
  const int x = x0 + tx;
  if (x >= p.w || y >= p.h) return;
  const size_t i = (size_t)y * p.w + x;
  const SmemPlanes T{planes, nplanes, (int)threadIdx.x};
  gn_pixel(T, p, ia11[i], ia12[i], ia22[i], c1[i], c2[i], act0[i], px0[i], py0[i], (float)x,
           (float)y, px_out + i, py_out + i, status_out + i);
}

GnParams make_params(int h, int w, int n_iter, int R, int hw, float hi) {
  return GnParams{h, w, n_iter, R, (float)hw, hi};
}

}  // namespace

// The GN loop: t1, t2 ((2R+1)^2, h, w) shift planes, ia11..c2 the solve
// fields, act0 the non-singular mask as 0/1, px0/py0 the window origins, all
// row-major float32 on `device`; writes px, py, status (h, w).  `hi` is the
// float32 rounding of R - 1e-3.  One launch on `stream`; returns
// cudaGetLastError().
extern "C" int ofri_lk_gn(const float* t1, const float* t2, const float* ia11, const float* ia12,
                          const float* ia22, const float* c1, const float* c2, const float* act0,
                          const float* px0, const float* py0, float* px_out, float* py_out,
                          float* status_out, int h, int w, int n_iter, int R, int hw, float hi,
                          int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (h < 1 || w < 1 || n_iter < 0 || R < 0) return cudaErrorInvalidValue;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  lk_gn_kernel<<<grid, block, 0, stream>>>(t1, t2, ia11, ia12, ia22, c1, c2, act0, px0, py0,
                                           px_out, py_out, status_out,
                                           make_params(h, w, n_iter, R, hw, hi));
  return cudaGetLastError();
}

// Shared memory the fused kernel needs at shift radius R, in bytes.
extern "C" size_t ofri_lk_fused_smem_bytes(int R) { return fused_smem_bytes(2 * R + 1); }

// Build + GN in one launch: slab (h+31+2R, w+31+2R), g (2, h+31, w+31), the
// (h, w) fields as for ofri_lk_gn, and the host run tables (lk_window.cuh).
// Returns cudaErrorInvalidValue when the tile's planes do not fit the
// device's shared memory, else cudaGetLastError().
extern "C" int ofri_lk_fused(const float* slab, const float* g, const float* ia11,
                             const float* ia12, const float* ia22, const float* c1,
                             const float* c2, const float* act0, const float* px0,
                             const float* py0, float* px_out, float* py_out, float* status_out,
                             int h, int w, int n_iter, int R, int hw, float hi,
                             const int* runs_y_table, const int* runs_x_table, int device,
                             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Runs runs_y, runs_x;
  if (!ofri_lk::runs_from_table(runs_y_table, &runs_y) ||
      !ofri_lk::runs_from_table(runs_x_table, &runs_x) || h < 1 || w < 1 || n_iter < 0 || R < 0)
    return cudaErrorInvalidValue;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t bytes = fused_smem_bytes(2 * R + 1);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(lk_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((w + kFW - 1) / kFW, (h + kFH - 1) / kFH);
  lk_fused_kernel<<<grid, kFThreads, bytes, stream>>>(slab, g, ia11, ia12, ia22, c1, c2, act0,
                                                      px0, py0, px_out, py_out, status_out,
                                                      make_params(h, w, n_iter, R, hw, hi),
                                                      runs_y, runs_x);
  return cudaGetLastError();
}
