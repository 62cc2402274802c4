// The Farneback window blur of one output tile, in shared memory, and the
// 2x2 solve at the tile's pixels: the routine of the blur + solve kernel
// (fb_blur5_flow.cu, once per launch) and of the fused loop (fb_fused.cu,
// once per tile and round).  Both kernels equal their plain versions bit for
// bit through it.
//
// A 640-thread block owns a kTH x TW output tile, and five groups of 128
// threads blur the five M planes side by side (the planes are independent
// until the solve), so a tile has 20 warps in flight and M is read once per
// tile.
//   * Register blocking along each pass: a thread owns R = 8 consecutive
//     outputs and slides a ring of R inputs along the taps, so each input is
//     read once per thread and each tap costs one load, R products and R
//     sums for R outputs.  Per output the taps still add in ascending order,
//     from -0 (-0 + p = p exactly), so the bits do not change.
//   * y-pass: from device memory through the caller's load (the tile's slab
//     of a plane stays in L1), lanes along the columns, R rows a thread, into
//     the group's slab in shared memory (kTH rows x (TW + n - 1) columns, an
//     odd stride); x-pass: lanes along the rows, R columns a thread,
//     conflict-free by the odd stride.  The border rule is a table of source
//     rows and columns per tile (reflect-101 for "mirror", replicate for
//     "nearest"; equal to the padded plain version for any pad width).
//   * The y apron (K12's sharded mode): M may hold a_top rows above the
//     tile's field and a_bot below, a neighbour's rows on a side inside the
//     image (a_top = a_bot = 0: the whole image).  The y rule then runs over
//     the rows present, so a side with an apron reads it and a side without
//     keeps the border rule.
//   * One group barrier between the passes, one block barrier after the
//     x-pass; the solve reads the five blurred planes from shared memory.
// Shared memory at TW = 64: 104 KB at 33 taps, 165 KB at 129.
#pragma once

#include <cuda_runtime.h>

#include "fb_common.cuh"

namespace ofri_fb {

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

template <int TW>
struct BlurTile {
  static constexpr int kTH = 32;               // tile rows: one warp's lanes in the x-pass
  static constexpr int kTW = TW;               // tile columns
  static constexpr int kR = 8;                 // outputs a thread sums in each pass
  static constexpr int kGroup = 128;           // threads blurring one plane
  static constexpr int kThreads = 5 * kGroup;  // 640
  static constexpr int kBlurStride = kTW + 1;  // odd: the x-pass's stores are conflict-free
  static_assert(kTH % kR == 0 && kTW % kR == 0, "passes cover the tile in runs of R");
  static_assert(kGroup % 32 == 0, "a plane's group is whole warps");

  // The block's tap table and the tile's border tables, in static shared
  // memory.
  struct Tables {
    float taps[kMaxTaps];
    int src_row[kTH + kMaxTaps - 1];
    int src_col[kTW + kMaxTaps - 1];
  };

  // the y-pass's row stride in shared memory: the span of the x-pass's
  // inputs, made odd
  __host__ __device__ static int mid_stride(int n) { return (kTW + n - 1) | 1; }

  // the dynamic shared memory of a block: the y-pass slab, then the blurred
  // planes
  static size_t smem_bytes(int n) {
    return sizeof(float) * 5 * kTH * ((size_t)mid_stride(n) + kBlurStride);
  }

  // The tap table into shared memory; the next blur's first barrier
  // publishes it.
  __device__ __forceinline__ static void load_taps(const BlurSpec& spec, Tables& t) {
    for (int j = threadIdx.x; j < spec.n; j += kThreads) t.taps[j] = spec.taps[j];
  }

  // Blur the five (h, w) planes of m over the tile at (y0, x0): y-pass,
  // x-pass and post-scale, into the blurred planes in `smem` (smem_bytes(n)
  // of dynamic shared memory).  m's planes hold a_top + h + a_bot rows, the
  // field's h after a_top rows of apron.  All kThreads threads call it;
  // load(p) reads the M value at p.  It starts with the tile's border tables
  // and a block barrier, so every earlier use of the shared memory by the
  // block is done, and ends with a block barrier, after which solve() may
  // read the tile.
  template <class Load>
  __device__ __forceinline__ static void blur(const float* m, int h, int w, int a_top, int a_bot,
                                              int y0, int x0, const BlurSpec& spec, Tables& t,
                                              float* smem, Load load) {
    const int n = spec.n;
    const int half = n / 2;
    const int span = kTW + n - 1;  // columns of the y-pass
    const int stride = mid_stride(n);
    float* mid = smem;                    // 5 x kTH x stride: after the y-pass
    float* out = mid + 5 * kTH * stride;  // 5 x kTH x kBlurStride: the blurred planes
    const int tid = threadIdx.x;
    const int present = a_top + h + a_bot;  // the rows of m
    const size_t plane = (size_t)present * w;

    for (int i = tid; i < kTH + n - 1; i += kThreads)
      t.src_row[i] = border_index(y0 - half + i + a_top, present, spec.mode);
    for (int i = tid; i < span; i += kThreads)
      t.src_col[i] = border_index(x0 - half + i, w, spec.mode);
    __syncthreads();

    const int c = tid / kGroup;  // this group's plane
    const int g = tid % kGroup;
    const float* mc = m + c * plane;
    float* midc = mid + c * kTH * stride;
    // y-pass: mid[r][col] = sum_j M[row(r + j)][col(col)] * taps[j], R rows a thread
    for (int item = g; item < (kTH / kR) * span; item += kGroup) {
      const int rb = item / span;
      const int col = item - rb * span;
      const float* src = mc + t.src_col[col];
      const int* rows = t.src_row + rb * kR;
      float acc[kR];
      slide<kR>(n, t.taps, [&](int i) { return load(src + (size_t)rows[i] * w); }, acc);
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
      slide<kR>(n, t.taps, [&](int i) { return src[i]; }, acc);
      float* dst = out + (c * kTH + r) * kBlurStride + cb * kR;
#pragma unroll
      for (int q = 0; q < kR; ++q) dst[q] = spec.scale != 1.0f ? acc[q] * spec.scale : acc[q];
    }
    __syncthreads();
  }

  // The 2x2 solve at each image pixel of the tile blur() left in `smem`, the
  // block's threads sharing the pixels; f(x, y, i, u, v) takes the flow of
  // pixel (x, y), flat index i.
  template <class F>
  __device__ __forceinline__ static void solve(const float* smem, int n, int h, int w, int y0,
                                               int x0, F f) {
    const float* planes = smem + 5 * kTH * mid_stride(n);
    for (int p = threadIdx.x; p < kTH * kTW; p += kThreads) {
      const int r = p / kTW;
      const int col = p - r * kTW;
      const int y = y0 + r;
      const int x = x0 + col;
      if (y >= h || x >= w) continue;
      float gv[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) gv[q] = planes[(q * kTH + r) * kBlurStride + col];
      float u, v;
      solve_flow(gv, &u, &v);
      f(x, y, (size_t)y * w + x, u, v);
    }
  }
};

}  // namespace ofri_fb
