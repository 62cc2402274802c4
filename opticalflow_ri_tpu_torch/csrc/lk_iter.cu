// Dense-LK Gauss-Newton loop on Hopper (sm_90a): two kernels.
//
// The GN step (both kernels) is models/lucas_kanade.py:401-435: the f32
// window origin (px, py), the out-of-bounds bail tested before the update,
// the clamp to [-R, R - 1e-3], the x32 step, the |delta| < 0.01 exit, active
// and status as 0/1 floats.  T1 and T2 at the pixel's displacement are a
// bilinear blend of the 2x2 enclosing integer shifts.  The TPU kernels
// contract a tent over all (2R+1)^2 planes because per-pixel gathers are slow
// there; here a pixel reads just the 4 planes of each stack whose tent weight
// can be non-zero.  Their weights are the tent's, max(0, 1 - |uc - s|) for
// s = floor(uc) and floor(uc) + 1, added as the TPU kernel adds them: ty =
// sum over sy, then s = sum over sx, both ascending, from 0.  The other
// weights are exactly 0 (|uc - s| >= 1 rounds to >= 1), so the 4-tap form is
// the same sum.  (Weights formed as fx = uc - floor(uc) and 1 - fx would not
// be: at uc = 1e-10 the tent gives the upper corner 0, fx gives 1e-10.)
//
// The per-pixel exit.  Both kernels end a pixel's loop at the first step at
// whose start (after the out-of-bounds bail) it is inactive, and issue no
// more loads for it.  The plain loop runs every step, but for an inactive
// pixel a step changes nothing, bit for bit:
//   * status * (1 - 0 * oob) = status and 0 * (1 - oob) = 0;
//   * px + dx * 0 = px as long as dx is finite and px is not -0.  dx is
//     finite: ia11, ia12, ia22 are a / det_safe with det_safe >= 1.19e-7 or 1
//     (models/lucas_kanade.py:lk_solve_fields) and the planes and c1, c2 are
//     window sums of finite products.  px is never -0: px0 = (jj + u0) - hw
//     and every update is a sum, and a sum of two values of opposite sign
//     that cancel rounds to +0 (chip_smoke.py:gn_exit models the exit;
//     tests/test_torch_kernel_plans.py holds it against the plain loop,
//     px0 = +0 included).
// The kernels rely on these two premises for inputs the LK solve makes; for
// a non-finite field or a -0 origin they may differ from the plain loop.
//
// lk_gn_kernel replaces opticalflow_ri_tpu/ops/pallas/lk_iter.py:
// lk_gn_iterate_pallas (_lk_gn_kernel).  A thread runs the loop for one
// pixel, its 8 gathers a step issued together; fields are read once through
// the read-only path.
//   What bounds it on an H100: bytes.  Per pixel 8 field reads and 3 writes
//   (44 B) and 8 gathered plane reads per step it runs (32 B a step): at
//   512^2 and 5 steps 53 MB, ~16 us at 3.35 TB/s.  The bound depends on the
//   data: the per-pixel exit runs fewer steps (chip_smoke.gn_exit counts
//   them), and a gather costs a whole 32-byte sector when the lanes of a
//   warp read different planes (a rough flow: ~8x the bytes).  The smooth
//   flows of PIV keep a warp's lanes on one or two planes a load.
//
// lk_fused_kernel replaces ops/pallas/lk_iter.py:lk_fused_pallas
// (_lk_fused_kernel): the build of ops/cuda/lk_build.py:lk_build_planes_plain
// in the two-level order (hierarchical=True) and the GN loop in one launch,
// the planes kept out of device memory.
//   What bounds it on an H100: operations.  The build forms 2 (2R+1)^2
//   window sums a pixel, ~21 operations each (a product, ~10 adds a pass),
//   5 GFLOP at 512^2 (~75 us at 67 TFLOP/s); its inputs are 3.6 MB.
//   Design: a cluster of C thread blocks (8, or 16 where the planes of 8 do
//   not fit shared memory: R = 6) owns a 32 x 32 pixel tile, and its shared
//   memory holds all the tile's planes: shift s lives in block s % C (slot
//   s / C), 2 x 1024 floats.  Each block stages the tile's J rows
//   ((63 + 2R)^2) and both gradients (2 x 63^2) once, all copies in flight
//   together (cp.async, 0 filled in outside the arrays), then builds its shifts
//   two at a time: 4 planes (2 shifts x 2 gradients) a round, 2 barriers a
//   round (8 rounds at R = 5).  The x-pass gives a thread one of the 63
//   product rows and all 32 outputs of one plane; the y-pass one column
//   and 16 outputs.  Each runs the two-level sum in registers (the base box
//   in place, then the b strided base terms and the remainder taps), as
//   csrc/lk_build.cu runs its ladder, one template per run length.  The
//   halo costs 63^2 / 32^2 ~ 3.9x the products of the tile's own area.
//   After a cluster barrier, each block runs the GN loop for 1024 / C of the
//   tile's pixels, reading each step's 8 plane values from the owning
//   block's shared memory (distributed shared memory), with the per-pixel
//   exit; a last cluster barrier keeps every block's planes alive until all
//   reads are done.  212 KB of shared memory a block at R = 5 (C = 8), 174 KB
//   at R = 6 (C = 16): one block of 8 warps a multiprocessor.
//
// Built with -fmad=false, both equal their plain PyTorch versions
// (ops/cuda/lk_iter.py: lk_gn_iterate_plain, lk_fused_plain) bit for bit.
//
// Global rows (lk_gn_kernel only).  As the TPU kernel's row0, img_h and
// img_w (ops/pallas/lk_iter.py:48-80), the (h, w) stack may cover global
// rows [row0, row0 + h) of an img_h x img_w image: a rank's stripe of a
// rows-sharded solve (parallel/sharded_kernel.py:lk_solve_sharded_kernel).
// The pixel's row ii is then the global row y + row0 (exact in float32),
// the out-of-bounds bail tests px >= img_w and py >= img_h, and the
// displacement v = py + hw - ii uses the global ii, so px, py stay in
// global window-origin coordinates.  With row0 = 0, img_h = h and img_w = w
// it is the whole-image kernel, bit for bit.  The loop's code is the same
// for both: its bail tests GnParams' h and w, which a stripe's launch
// (lk_gn_kernel<true>) sets to the image's, the stripe's own extent and
// row0 entering only before the loop.  With the stripe's bounds in the loop
// itself nvcc scheduled it otherwise, and the random-flow input took 2.8x
// as long at 2048^2 (PERF.md §6, K7).  The fused kernel always runs the
// whole image.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lk_window.cuh"

namespace cg = cooperative_groups;

namespace {

using ofri_lk::kExt;
using ofri_lk::Runs;

constexpr int kMaxDevices = 64;

struct GnParams {
  int h, w, n_iter, R;
  float hw;  // the half window, as the float the bail and u, v use
  float hi;  // float32(R - 1e-3), the upper clamp
};

// A stripe (lk_gn_kernel<true>): the image row of its first row and its own
// rows and columns.  GnParams' h and w then hold the image's, which the
// bail tests.
struct GnStripe {
  int row0, rows, cols;
};

// The loop state of one pixel.
struct GnPixel {
  float ia11, ia12, ia22, c1, c2, active, px, py, jj, ii, status;
  int at;  // the pixel's offset in a plane
};

__device__ __forceinline__ GnPixel gn_pixel(const float* __restrict__ ia11,
                                            const float* __restrict__ ia12,
                                            const float* __restrict__ ia22,
                                            const float* __restrict__ c1,
                                            const float* __restrict__ c2,
                                            const float* __restrict__ act0,
                                            const float* __restrict__ px0,
                                            const float* __restrict__ py0, size_t i, int at,
                                            int x, int y) {
  return GnPixel{__ldg(ia11 + i), __ldg(ia12 + i), __ldg(ia22 + i), __ldg(c1 + i),
                 __ldg(c2 + i),   __ldg(act0 + i), __ldg(px0 + i),  __ldg(py0 + i),
                 (float)x,        (float)y,        1.0f,            at};
}

// A pixel outside the image: inactive and inside the window bounds, so it
// runs no step and loads nothing.
__device__ __forceinline__ GnPixel gn_idle() {
  return GnPixel{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0};
}

// The out-of-bounds bail at the start of a step; true while the pixel is
// active (then the step runs).
__device__ __forceinline__ bool gn_check(GnPixel& q, const GnParams& p) {
  const float oob =
      (q.px < -p.hw || q.px >= (float)p.w || q.py < -p.hw || q.py >= (float)p.h) ? 1.0f : 0.0f;
  q.status = q.status * (1.0f - q.active * oob);
  q.active = q.active * (1.0f - oob);
  return q.active != 0.0f;
}

// The tent weights of the 2x2 enclosing shifts and the lower corner's plane.
struct GnTaps {
  float wx0, wx1, wy0, wy1;
  int s00;
};

__device__ __forceinline__ GnTaps gn_taps(const GnPixel& q, const GnParams& p) {
  const float lo = (float)(-p.R);
  const float u = (q.px + p.hw) - q.jj;
  const float v = (q.py + p.hw) - q.ii;
  const float uc = fminf(fmaxf(u, lo), p.hi);
  const float vc = fminf(fmaxf(v, lo), p.hi);
  const float sx = floorf(uc);
  const float sy = floorf(vc);
  GnTaps t;
  t.wx0 = fmaxf(0.0f, 1.0f - fabsf(uc - sx));
  t.wx1 = fmaxf(0.0f, 1.0f - fabsf(uc - (sx + 1.0f)));
  t.wy0 = fmaxf(0.0f, 1.0f - fabsf(vc - sy));
  t.wy1 = fmaxf(0.0f, 1.0f - fabsf(vc - (sy + 1.0f)));
  t.s00 = ((int)sy + p.R) * (2 * p.R + 1) + ((int)sx + p.R);
  return t;
}

// The rest of the step from the 8 plane values: v[0..3] from T1 at s00,
// s00 + nshift, s00 + 1, s00 + nshift + 1, v[4..7] from T2 at the same.
__device__ __forceinline__ void gn_update(GnPixel& q, const GnTaps& t, const float (&v)[8]) {
  const float a0 = t.wy0 * v[0] + t.wy1 * v[1];
  const float a1 = t.wy0 * v[2] + t.wy1 * v[3];
  const float s1 = t.wx0 * a0 + t.wx1 * a1;
  const float e0 = t.wy0 * v[4] + t.wy1 * v[5];
  const float e1 = t.wy0 * v[6] + t.wy1 * v[7];
  const float s2 = t.wx0 * e0 + t.wx1 * e1;
  const float b1 = s1 - q.c1;
  const float b2 = s2 - q.c2;
  const float dx = (q.ia12 * b2 - q.ia22 * b1) * 32.0f;
  const float dy = (q.ia12 * b1 - q.ia11 * b2) * 32.0f;
  q.px = q.px + dx * q.active;
  q.py = q.py + dy * q.active;
  const float small = (fabsf(dx) < 0.01f && fabsf(dy) < 0.01f) ? 1.0f : 0.0f;
  q.active = q.active * (1.0f - small);
}

// The loop for one pixel; T(k, s, at) reads plane s of stack k (0: T1,
// 1: T2) at offset `at`.  Ends at the pixel's first inactive step.
template <class Planes>
__device__ __forceinline__ void gn_loop(const Planes& T, const GnParams& p, GnPixel& q) {
  const int nshift = 2 * p.R + 1;
  for (int it = 0; it < p.n_iter; ++it) {
    if (!gn_check(q, p)) break;
    const GnTaps t = gn_taps(q, p);
    float v[8];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      v[4 * st + 0] = T(st, t.s00, q.at);
      v[4 * st + 1] = T(st, t.s00 + nshift, q.at);
      v[4 * st + 2] = T(st, t.s00 + 1, q.at);
      v[4 * st + 3] = T(st, t.s00 + nshift + 1, q.at);
    }
    gn_update(q, t, v);
  }
}

// ------------------------------------------------------------------ lk_gn

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct GlobalPlanes {
  const float* __restrict__ t1;
  const float* __restrict__ t2;
  size_t plane;
  __device__ __forceinline__ float operator()(int k, int s, int at) const {
    return __ldg((k == 0 ? t1 : t2) + (size_t)s * plane + at);
  }
};

// kStripe: the stack is the stripe s of the p.h x p.w image; else the whole
// image (the file's comment, "Global rows").  The loop is the same code.
template <bool kStripe>
__global__ void __launch_bounds__(kBlockX* kBlockY)
lk_gn_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
             const float* __restrict__ ia11, const float* __restrict__ ia12,
             const float* __restrict__ ia22, const float* __restrict__ c1,
             const float* __restrict__ c2, const float* __restrict__ act0,
             const float* __restrict__ px0, const float* __restrict__ py0,
             float* __restrict__ px_out, float* __restrict__ py_out,
             float* __restrict__ status_out, GnParams p, GnStripe s) {
  const int rows = kStripe ? s.rows : p.h;  // the stack's
  const int cols = kStripe ? s.cols : p.w;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const bool in = x < cols && y < rows;
  const size_t i = (size_t)y * cols + x;
  // A thread outside the image runs an idle pixel instead of returning: of
  // the equivalent forms measured, this one runs fastest (PERF.md §6, K7).
  GnPixel q = in ? gn_pixel(ia11, ia12, ia22, c1, c2, act0, px0, py0, i, (int)i, x,
                           kStripe ? y + s.row0 : y)
                 : gn_idle();
  gn_loop(GlobalPlanes{t1, t2, (size_t)rows * cols}, p, q);
  if (in) {
    px_out[i] = q.px;
    py_out[i] = q.py;
    status_out[i] = q.status;
  }
}

// --------------------------------------------------------------- lk_fused

constexpr int kTile = 32;               // tile rows and columns
constexpr int kPix = kTile * kTile;     // pixels a tile
constexpr int kRows = kTile + kExt;     // 63 product rows and columns a tile (odd)
constexpr int kSegY = 16;               // y-pass outputs a thread: half a tile column
constexpr int kLdX = kTile + 1;         // x-pass result row stride (odd)
constexpr int kSlots = 4;               // planes a round: 2 shifts x 2 gradients
constexpr int kFThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;
static_assert(kFThreads == kSlots * 64, "x-pass: 64 row slots (63 used) per plane");
static_assert(kFThreads == kSlots * kTile * (kTile / kSegY), "y-pass: 32 columns x 2 segments");

// The two-level form's base width for a run of length L,
// ops/window_sums.py:base_width = round(sqrt(L)): the least a with
// a (a + 1) >= L (sqrt(L) is never a half-integer).
__host__ __device__ constexpr int base_width(int L) {
  int a = 1;
  while (a * (a + 1) < L) ++a;
  return a;
}

// One run of length L for K consecutive outputs in the two-level order of
// ops/window_sums.py:windowed_sum_axis (hierarchical=True): base(i) =
// sum_{i'<a} x(i + i'), the run's term base(lo) + base(lo + a) + ... (b =
// L // a of them) + the remainder taps x(lo + a b .. lo + L - 1), all added
// left to right.  src(i) is the input at offset lo + i from the segment's
// first output.  The base box is formed in place, ascending (each entry reads
// only entries at or above it); remainder taps are re-read from src.
// acc = term (first run) or acc + term.
template <int L, int K, class Src>
__device__ __forceinline__ void twolevel_run(const Src& src, float (&acc)[K], bool first) {
  constexpr int a = base_width(L);
  constexpr int b = L / a;
  constexpr int nb = K + a * (b - 1);  // base entries the K outputs read
  float v[nb + a - 1];
#pragma unroll
  for (int i = 0; i < nb + a - 1; ++i) v[i] = src(i);
#pragma unroll
  for (int i = 0; i < nb; ++i) {
    float s = v[i];
#pragma unroll
    for (int j = 1; j < a; ++j) s = s + v[i + j];
    v[i] = s;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = v[k];
#pragma unroll
    for (int j = 1; j < b; ++j) t = t + v[k + a * j];
#pragma unroll
    for (int j = a * b; j < L; ++j) t = t + src(k + j);
    acc[k] = first ? t : acc[k] + t;
  }
}

template <int K, class Src>
__device__ __forceinline__ void twolevel_any(int L, const Src& src, float (&acc)[K], bool first) {
  switch (L) {
#define OFRI_TWOLEVEL_CASE(n)            \
  case n:                                \
    twolevel_run<n, K>(src, acc, first); \
    break;
    OFRI_TWOLEVEL_CASE(1) OFRI_TWOLEVEL_CASE(2) OFRI_TWOLEVEL_CASE(3) OFRI_TWOLEVEL_CASE(4)
    OFRI_TWOLEVEL_CASE(5) OFRI_TWOLEVEL_CASE(6) OFRI_TWOLEVEL_CASE(7) OFRI_TWOLEVEL_CASE(8)
    OFRI_TWOLEVEL_CASE(9) OFRI_TWOLEVEL_CASE(10) OFRI_TWOLEVEL_CASE(11) OFRI_TWOLEVEL_CASE(12)
    OFRI_TWOLEVEL_CASE(13) OFRI_TWOLEVEL_CASE(14) OFRI_TWOLEVEL_CASE(15) OFRI_TWOLEVEL_CASE(16)
    OFRI_TWOLEVEL_CASE(17) OFRI_TWOLEVEL_CASE(18) OFRI_TWOLEVEL_CASE(19) OFRI_TWOLEVEL_CASE(20)
    OFRI_TWOLEVEL_CASE(21) OFRI_TWOLEVEL_CASE(22) OFRI_TWOLEVEL_CASE(23) OFRI_TWOLEVEL_CASE(24)
    OFRI_TWOLEVEL_CASE(25) OFRI_TWOLEVEL_CASE(26) OFRI_TWOLEVEL_CASE(27) OFRI_TWOLEVEL_CASE(28)
    OFRI_TWOLEVEL_CASE(29) OFRI_TWOLEVEL_CASE(30) OFRI_TWOLEVEL_CASE(31) OFRI_TWOLEVEL_CASE(32)
#undef OFRI_TWOLEVEL_CASE
    default:
      break;
  }
}

// Shifts a block of a cluster of `csize` holds, and its shared memory.
__host__ __device__ constexpr int fused_per_rank(int R, int csize) {
  return ((2 * R + 1) * (2 * R + 1) + csize - 1) / csize;
}

size_t fused_smem_bytes(int R, int csize) {
  const size_t jn = kRows + 2 * R;  // odd: the staged J's row stride
  return sizeof(float) * ((size_t)fused_per_rank(R, csize) * 2 * kPix + jn * jn +
                          2 * kRows * kRows + kSlots * kRows * kLdX);
}

// A 4-byte copy from device to shared memory that does not wait for the
// load (cp.async; cp.async.wait_all completes it); `in` false writes 0.
__device__ __forceinline__ void stage4(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// The GN reads a plane from the shared memory of the block that built it.
struct ClusterPlanes {
  float* planes;  // this block's planes
  int cshift;     // log2 of the cluster size
  __device__ __forceinline__ float operator()(int k, int s, int at) const {
    const int owner = s & ((1 << cshift) - 1);
    const int slot = s >> cshift;
    const float* src = cg::this_cluster().map_shared_rank(planes, owner);
    return src[(slot * 2 + k) * kPix + at];
  }
};

__global__ void __launch_bounds__(kFThreads, 1)
lk_fused_kernel(const float* __restrict__ slab, const float* __restrict__ g,
                const float* __restrict__ ia11, const float* __restrict__ ia12,
                const float* __restrict__ ia22, const float* __restrict__ c1,
                const float* __restrict__ c2, const float* __restrict__ act0,
                const float* __restrict__ px0, const float* __restrict__ py0,
                float* __restrict__ px_out, float* __restrict__ py_out,
                float* __restrict__ status_out, GnParams p, Runs runs_y, Runs runs_x,
                int cshift) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = 1 << cshift;
  const int rank = (int)cluster.block_rank();
  const int nshift = 2 * p.R + 1;
  const int per_rank = fused_per_rank(p.R, csize);
  const int jn = kRows + 2 * p.R;
  float* planes = smem;                    // per_rank x 2 x kPix: slot, gradient, pixel
  float* J = planes + per_rank * 2 * kPix; // jn x jn: the tile's J rows
  float* G = J + jn * jn;                  // 2 x kRows x kRows: both gradients
  float* X = G + 2 * kRows * kRows;        // kSlots x kRows x kLdX: x-pass results

  const int x0 = (blockIdx.x >> cshift) * kTile;
  const int y0 = blockIdx.y * kTile;
  const int core_h = p.h + kExt;
  const int core_w = p.w + kExt;
  const int slab_h = core_h + nshift - 1;
  const int slab_w = core_w + nshift - 1;
  const int tid = threadIdx.x;

  // Stage once, every copy in flight together (cp.async).  Outside the slab
  // and the core: 0, read by no output that is written.
  for (int idx = tid; idx < jn * jn; idx += kFThreads) {
    const int r = idx / jn;
    const int c = idx - r * jn;
    const int jy = y0 + r;
    const int jx = x0 + c;
    const bool in = jy < slab_h && jx < slab_w;
    stage4(J + idx, in ? slab + (size_t)jy * slab_w + jx : slab, in);
  }
  for (int idx = tid; idx < kRows * kRows; idx += kFThreads) {
    const int r = idx / kRows;
    const int c = idx - r * kRows;
    const int gy = y0 + r;
    const int gx = x0 + c;
    const bool in = gy < core_h && gx < core_w;
    const size_t i = in ? (size_t)gy * core_w + gx : 0;
    stage4(G + idx, g + i, in);
    stage4(G + kRows * kRows + idx, g + (size_t)core_h * core_w + i, in);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int q = tid >> 6;                 // plane slot of this round
  const int k = q & 1;                    // its gradient
  const int xr = tid & 63;                // x-pass: product row
  const int yc = tid & 31;                // y-pass: column
  const int yr = ((tid >> 5) & 1) * kSegY;  // y-pass: first output row
  const int mine = (nshift * nshift - rank + csize - 1) / csize;  // shifts rank + csize j

#pragma unroll 1
  for (int j0 = 0; j0 < mine; j0 += 2) {
    const int j = j0 + (q >> 1);
    const bool has = j < mine;
    const int s = rank + csize * j;
    const int sy = s / nshift;
    const int sx = s - sy * nshift;
    if (has && xr < kRows) {
      const float* jrow = J + (xr + sy) * jn + sx;
      const float* grow = G + (k * kRows + xr) * kRows;
      float acc[kTile] = {};
#pragma unroll 1
      for (int r = 0; r < runs_x.n; ++r) {
        const int lo = runs_x.run[r].lo;
        auto src = [&](int i) { return jrow[lo + i] * grow[lo + i]; };
        twolevel_any(runs_x.run[r].len, src, acc, r == 0);
      }
      float* xrow = X + (q * kRows + xr) * kLdX;
#pragma unroll
      for (int i = 0; i < kTile; ++i) xrow[i] = acc[i];
    }
    __syncthreads();
    if (has) {
      const float* xcol = X + (q * kRows + yr) * kLdX + yc;
      float acc[kSegY] = {};
#pragma unroll 1
      for (int r = 0; r < runs_y.n; ++r) {
        const int lo = runs_y.run[r].lo;
        auto src = [&](int i) { return xcol[(lo + i) * kLdX]; };
        twolevel_any(runs_y.run[r].len, src, acc, r == 0);
      }
      float* out = planes + (j * 2 + k) * kPix + yr * kTile + yc;
#pragma unroll
      for (int i = 0; i < kSegY; ++i) out[i * kTile] = acc[i];
    }
    __syncthreads();
  }

  cluster.sync();  // every block's planes are built
  const int share = kPix >> cshift;  // pixels this block's GN runs
  if (tid < share) {
    const int at = rank * share + tid;
    const int y = y0 + at / kTile;
    const int x = x0 + at % kTile;
    if (x < p.w && y < p.h) {
      const size_t i = (size_t)y * p.w + x;
      GnPixel q = gn_pixel(ia11, ia12, ia22, c1, c2, act0, px0, py0, i, at, x, y);
      gn_loop(ClusterPlanes{planes, cshift}, p, q);
      px_out[i] = q.px;
      py_out[i] = q.py;
      status_out[i] = q.status;
    }
  }
  cluster.sync();  // no block leaves while another may read its planes
}

GnParams make_params(int h, int w, int n_iter, int R, int hw, float hi) {
  return GnParams{h, w, n_iter, R, (float)hw, hi};
}

// The kernel serves a run only with the base width it was compiled for.
bool bases_match(const Runs& runs) {
  for (int q = 0; q < runs.n; ++q)
    if (runs.run[q].a != base_width(runs.run[q].len)) return false;
  return true;
}

}  // namespace

// The GN loop: t1, t2 ((2R+1)^2, h, w) shift planes, ia11..c2 the solve
// fields, act0 the non-singular mask as 0/1, px0/py0 the window origins, all
// row-major float32 on `device`; writes px, py, status (h, w).  `hi` is the
// float32 rounding of R - 1e-3.  The stack covers global rows [row0, row0 +
// h) of an img_h x img_w image (row0 = 0, img_h = h, img_w = w: the whole
// image).  One launch on `stream`; returns cudaGetLastError().
extern "C" int ofri_lk_gn(const float* t1, const float* t2, const float* ia11, const float* ia12,
                          const float* ia22, const float* c1, const float* c2, const float* act0,
                          const float* px0, const float* py0, float* px_out, float* py_out,
                          float* status_out, int h, int w, int n_iter, int R, int hw, float hi,
                          int row0, int img_h, int img_w, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (h < 1 || w < 1 || n_iter < 0 || R < 0 || row0 < 0 || img_h < row0 + h || img_w < 1)
    return cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  const GnStripe s{row0, h, w};
  if (row0 == 0 && img_h == h && img_w == w)
    lk_gn_kernel<false><<<grid, block, 0, stream>>>(t1, t2, ia11, ia12, ia22, c1, c2, act0, px0,
                                                    py0, px_out, py_out, status_out,
                                                    make_params(h, w, n_iter, R, hw, hi), s);
  else
    lk_gn_kernel<true><<<grid, block, 0, stream>>>(t1, t2, ia11, ia12, ia22, c1, c2, act0, px0,
                                                   py0, px_out, py_out, status_out,
                                                   make_params(img_h, img_w, n_iter, R, hw, hi),
                                                   s);
  return cudaGetLastError();
}

// Shared memory a block of the fused kernel needs at shift radius R in a
// cluster of `csize` blocks, in bytes.
extern "C" size_t ofri_lk_fused_smem_bytes(int R, int csize) {
  return fused_smem_bytes(R, csize);
}

// Build + GN in one launch: slab (h+31+2R, w+31+2R), g (2, h+31, w+31), the
// (h, w) fields as for ofri_lk_gn, the host run tables (lk_window.cuh) and
// the cluster size (8 or 16).  Returns cudaErrorInvalidValue for a bad table
// or planes that do not fit the device's shared memory,
// cudaErrorInvalidConfiguration when no cluster of that size can be
// scheduled, else cudaGetLastError().
extern "C" int ofri_lk_fused(const float* slab, const float* g, const float* ia11,
                             const float* ia12, const float* ia22, const float* c1,
                             const float* c2, const float* act0, const float* px0,
                             const float* py0, float* px_out, float* py_out, float* status_out,
                             int h, int w, int n_iter, int R, int hw, float hi,
                             const int* runs_y_table, const int* runs_x_table, int csize,
                             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Runs runs_y, runs_x;
  if (!ofri_lk::runs_from_table(runs_y_table, &runs_y) ||
      !ofri_lk::runs_from_table(runs_x_table, &runs_x) || !bases_match(runs_y) ||
      !bases_match(runs_x) || h < 1 || w < 1 || n_iter < 0 || R < 0 ||
      (csize != 8 && csize != 16))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  const size_t bytes = fused_smem_bytes(R, csize);
  if (bytes > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const int cshift = csize == 8 ? 3 : 4;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((w + kTile - 1) / kTile) * csize, (h + kTile - 1) / kTile);
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // the opt-ins and the schedulability check, once per device, cluster size
  // and shared-memory size: the calls cost host time
  static size_t opted_in[kMaxDevices] = {};
  static bool nonportable[kMaxDevices] = {};
  static size_t checked[kMaxDevices][2] = {};
  if (bytes > opted_in[device]) {
    err = cudaFuncSetAttribute(lk_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in[device] = bytes;
  }
  if (csize > 8 && !nonportable[device]) {
    err = cudaFuncSetAttribute(lk_fused_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable[device] = true;
  }
  if (checked[device][cshift - 3] != bytes) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, lk_fused_kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[device][cshift - 3] = bytes;
  }
  return cudaLaunchKernelEx(&cfg, lk_fused_kernel, slab, g, ia11, ia12, ia22, c1, c2, act0, px0,
                            py0, px_out, py_out, status_out, make_params(h, w, n_iter, R, hw, hi),
                            runs_y, runs_x, cshift);
}
