// Device code shared by the three Farneback kernels (fb_update_matrices.cu,
// fb_blur5_flow.cu, fb_fused.cu): updateMatrices at one pixel, the border
// index rules of the window blur, the blur's tap table and the regularised
// 2x2 flow solve.  Every sum and product keeps the operation order of the
// plain PyTorch versions (ops/cuda/tent_sample.py, ops/cuda/blur5_flow.py);
// built with -fmad=false, the kernels equal them bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace ofri_fb {

// ------------------------------------------------------------ updateMatrices

// R >= 0: the dense tent contraction over shifts [-R, R]^2 with the
// displacement clipped to [-R, hi], hi = float32(R - 1e-3); R < 0: the exact
// 4-tap gather (sample_max_shift=None).
//
// The stripe mode (K9-K11's sharded mode, R >= 0 only): the (h, w) field
// covers global rows [row0, row0 + h) of an img_h-row image, and R1 holds
// a_top rows above it and a_bot below (a neighbour's rows on a side inside
// the image, none on the image's border).  The sample's row index is clamped
// into the rows present, [-a_top, h - 1 + a_bot], which on a border side is
// the edge padding of the whole-image call; the inside test and the border
// ramp take global rows.  row0 = 0, img_h = h, a_top = a_bot = 0 is the
// whole image, bit for bit (the fused loop, fb_fused.cu, always runs it).
struct UmParams {
  int h, w, R;
  float hi;
  int row0, img_h, a_top, a_bot;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// BORDER_RAMP (models/farneback.py:42) at distance d >= 0 from an edge:
// 0.14 for d < 2, 0.4472 for d < 5, else 1.
__device__ __forceinline__ float ramp_at(int d) {
  return d < 2 ? 0.14f : (d < 5 ? 0.4472f : 1.0f);
}

// The five planes of M at pixel (x, y): the sample s of R1 at the displaced
// position, the blend with R0, the border ramp and the normal-equation
// products (ops/cuda/tent_sample.py: update_matrices_plain, assemble_m).
// r0 holds five (h, w) planes, r1 five (a_top + h + a_bot, w) planes.
__device__ __forceinline__ void update_matrices_pixel(const float* __restrict__ r0,
                                                      const float* __restrict__ r1,
                                                      float flowx, float flowy, int x, int y,
                                                      const UmParams& p, float m[5]) {
  const size_t plane = (size_t)p.h * p.w;
  const size_t plane1 = (size_t)(p.a_top + p.h + p.a_bot) * p.w;
  const size_t i = (size_t)y * p.w + x;
  const int yg = y + p.row0;  // the global row
  const float fx = (float)x + flowx;
  const float fy = (float)yg + flowy;
  const float x1 = floorf(fx);
  const float y1 = floorf(fy);
  // from the unclipped flow
  const bool inside =
      x1 >= 0.0f && y1 >= 0.0f && x1 < (float)(p.w - 1) && y1 < (float)(p.img_h - 1);

  float s[5];
  if (p.R >= 0) {
    // Of the (2R+1)^2 tent weights max(0, 1 - |dyc - sy|) * max(0, 1 - |dxc - sx|)
    // only those of sy in {floor(dyc), +1} and sx in {floor(dxc), +1} can be
    // non-zero (|dc - s| >= 1 rounds to >= 1), and the contraction adds the
    // others as exact zeros.  So the sum is these four terms in the dense
    // loop's order (sy outer, sx inner), from 0.  Edge padding of R1 is an
    // index clamp into the rows present.
    const float lo = (float)(-p.R);
    const float dxc = fminf(fmaxf(flowx, lo), p.hi);
    const float dyc = fminf(fmaxf(flowy, lo), p.hi);
    const float sx = floorf(dxc);
    const float sy = floorf(dyc);
    const float wx0 = fmaxf(0.0f, 1.0f - fabsf(dxc - sx));
    const float wx1 = fmaxf(0.0f, 1.0f - fabsf(dxc - (sx + 1.0f)));
    const float wy0 = fmaxf(0.0f, 1.0f - fabsf(dyc - sy));
    const float wy1 = fmaxf(0.0f, 1.0f - fabsf(dyc - (sy + 1.0f)));
    const float w00 = wy0 * wx0;
    const float w01 = wy0 * wx1;
    const float w10 = wy1 * wx0;
    const float w11 = wy1 * wx1;
    const int ylo = -p.a_top, yhi = p.h - 1 + p.a_bot;
    const size_t ya = (size_t)(clampi(y + (int)sy, ylo, yhi) + p.a_top) * p.w;
    const size_t yb = (size_t)(clampi(y + (int)sy + 1, ylo, yhi) + p.a_top) * p.w;
    const int xa = clampi(x + (int)sx, 0, p.w - 1);
    const int xb = clampi(x + (int)sx + 1, 0, p.w - 1);
    for (int c = 0; c < 5; ++c) {
      const float* rc = r1 + c * plane1;
      float acc = 0.0f;
      acc = acc + w00 * rc[ya + xa];
      acc = acc + w01 * rc[ya + xb];
      acc = acc + w10 * rc[yb + xa];
      acc = acc + w11 * rc[yb + xb];
      s[c] = acc;
    }
  } else {
    const float fxf = fx - x1;
    const float fyf = fy - y1;
    const int xc = (int)fminf(fmaxf(x1, 0.0f), (float)(p.w - 2));
    const int yc = (int)fminf(fmaxf(y1, 0.0f), (float)(p.h - 2));
    const float a00 = (1.0f - fxf) * (1.0f - fyf);
    const float a01 = fxf * (1.0f - fyf);
    const float a10 = (1.0f - fxf) * fyf;
    const float a11 = fxf * fyf;
    const size_t q = (size_t)yc * p.w + xc;
    for (int c = 0; c < 5; ++c) {
      const float* rc = r1 + c * plane + q;
      s[c] = ((a00 * rc[0] + a01 * rc[1]) + a10 * rc[p.w]) + a11 * rc[p.w + 1];
    }
  }

  const float q0 = r0[i], q1 = r0[plane + i], q2 = r0[2 * plane + i];
  const float q3 = r0[3 * plane + i], q4 = r0[4 * plane + i];
  float r2 = inside ? s[0] : 0.0f;
  float r3 = inside ? s[1] : 0.0f;
  float r4 = inside ? (q2 + s[2]) * 0.5f : q2;
  float r5 = inside ? (q3 + s[3]) * 0.5f : q3;
  float r6 = inside ? (q4 + s[4]) * 0.25f : q4 * 0.5f;
  r2 = (q0 - r2) * 0.5f;
  r3 = (q1 - r3) * 0.5f;
  r2 = (r2 + r4 * flowy) + r6 * flowx;
  r3 = (r3 + r6 * flowy) + r5 * flowx;

  const float scale = ((ramp_at(min(x, 5)) * ramp_at(min(yg, 5))) * ramp_at(min(p.w - x - 1, 5))) *
                      ramp_at(min(p.img_h - yg - 1, 5));
  r2 = r2 * scale;
  r3 = r3 * scale;
  r4 = r4 * scale;
  r5 = r5 * scale;
  r6 = r6 * scale;

  m[0] = r4 * r4 + r6 * r6;
  m[1] = (r4 + r5) * r6;
  m[2] = r5 * r5 + r6 * r6;
  m[3] = r4 * r2 + r6 * r3;
  m[4] = r6 * r2 + r5 * r3;
}

// ------------------------------------------------------------ window blur

constexpr int kMaxTaps = 129;  // taps of the window blur: any odd count up to this
enum BorderMode : int { kMirror = 0, kNearest = 1 };

// The separable window blur of M: n odd taps, the border rule, and the
// post-scale (1: none).  Passed to a kernel by value.
struct BlurSpec {
  int n;
  int mode;
  float scale;
  float taps[kMaxTaps];
};

// The wrapper's tap table (host memory) as a BlurSpec; false when malformed.
inline bool blur_spec_from_host(const float* taps, int n, int mode, float scale, BlurSpec* out) {
  if (n < 1 || n > kMaxTaps || n % 2 == 0 || (mode != kMirror && mode != kNearest)) return false;
  out->n = n;
  out->mode = mode;
  out->scale = scale;
  std::memset(out->taps, 0, sizeof(out->taps));
  std::memcpy(out->taps, taps, sizeof(float) * n);
  return true;
}

// Source index of position i (any integer) on an axis of length n: "mirror"
// reflects about the edge pixels without repeating them (reflect-101),
// "nearest" replicates the edge.  Reflection repeats when i lies more than
// n - 1 outside, so this equals the port's pad2d (ops/padding.py:_pad_index)
// for any pad width.
__device__ __forceinline__ int border_index(int i, int n, int mode) {
  if (mode == kNearest || n == 1) return clampi(i, 0, n - 1);
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m > n - 1 ? period - m : m;
}

// The regularised 2x2 solve of one pixel (models/farneback.py:462-466).
// g: the blurred g11, g12, g22, h1, h2.
__device__ __forceinline__ void solve_flow(const float g[5], float* fx, float* fy) {
  const float det_inv = 1.0f / (g[0] * g[2] - g[1] * g[1] + 1e-3f);
  *fx = (g[0] * g[4] - g[1] * g[3]) * det_inv;
  *fy = (g[2] * g[3] - g[1] * g[4]) * det_inv;
}

}  // namespace ofri_fb
