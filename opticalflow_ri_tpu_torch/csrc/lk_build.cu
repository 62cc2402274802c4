// Dense-LK shift-plane build on Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflow_ri_tpu/ops/pallas/lk_build.py:
// lk_build_planes_pallas (_lk_build_kernel).  For every integer shift
// s = (sy, sx) in [-R, R]^2 and both gradients g in {gx, gy} it writes
//     T_g[s](p) = wsum(J(p + s + off) * g(p + off))
// into two (nshift^2, h, w) stacks, sy-major, sx-minor -- the layout of the
// JAX package's build, which the GN kernel (csrc/lk_iter.cu) reads.
//
// What bounds it on an H100: the write of the stack, 2 * nshift^2 * h * w * 4 B.
// At R = 5 (121 shifts): 254 MB at 512^2, 76 us at 3.35 TB/s; 4.06 GB at
// 2048^2, 1.21 ms.  The inputs (slab and gradient pair) add 3.6 MB / 51 MB.
// The operations, ~13 per output (1 product, ~6 ladder adds per pass at the
// L = 27 window), are 0.8 GFLOP at 512^2 and 13 GFLOP at 2048^2: 12 us and
// 0.20 ms at 67 TFLOP/s, below the write.
//
// Design (what it does about that bound): a 256-thread block owns a 32 x 64
// output tile and one sy, and walks the nshift sx shifts of that row.
//   * It stages the J rows of its sy (63 x (94 + nshift)) and both gradients
//     (2 x 63 x 95) in shared memory once; each shift's products J * g are
//     formed from there, so the slab is read from L2 once per sy, not once
//     per shift.
//   * x-pass: a thread owns one of the 63 product rows, 32 consecutive
//     output columns and one gradient, and runs the window's ladder sum for
//     them in its registers.  y-pass: a thread owns one column, 16
//     consecutive output rows and one gradient, and does the same down the
//     column of the x-pass result.  Neither pass needs a barrier inside it:
//     two per shift in all.  (A thread's ladder costs ~6 adds per output plus
//     ~80 for the segment's window overhang, so longer segments do less work
//     and read shared memory less; 32 outputs are what the registers hold.)
//   * Indices are 2-D (row, segment) from the thread index, with no
//     division; odd row strides keep the shared-memory walks conflict-free.
//   * Each warp's stores fill whole 128-byte lines (32 neighbouring columns
//     of one row; 16-byte stores would need a thread to hold 4 columns'
//     ladders) and bypass L2 residency (__stcs): the stack is far larger
//     than the 50 MB L2 and the GN kernel reads it later.
// 107 KB of shared memory per block at R = 5: two blocks per SM.  A 64 x 64
// tile (512 threads, 161 KB, one block per SM) halves the x-pass halo but
// measured slower (scripts/torch_kernel_times.py).
//
// Numerics.  Each pass is the factor ladder of ops/window_sums.py:_ladder_run
// for each run of the window: stage k forms S_{m*f}(c) = sum_{j<f} S_m(c + j*m),
// added left to right; the run's term is S(lo + c) plus the remainder taps
// x(lo + c + j), j = M..L-1, in order; the runs' terms are added in run
// order.  A thread runs the stages in place on its register copy (ascending
// c: each stage reads only entries at or above the one it writes), which
// forms every value exactly as the whole-row ladder does.  The ladder's
// factor list depends only on the run's length L, so the kernel holds one
// register ladder per L = 1..32 (ladder_fac below, the table of
// _smooth_factorization) and the host rejects a run table whose factors
// differ.  Built with -fmad=false, the planes equal the plain PyTorch build
// (ops/cuda/lk_build.py:lk_build_planes_plain) bit for bit.
//
// The TPU kernel's split launch (lk_build_split_engages) and the stripe
// staging for large images (lk_striped_height) exist only because VMEM is
// small; the whole stack fits the H100's 80 GB up to 2048^2 and beyond, so
// they have no counterpart here.
#include <cuda_runtime.h>

#include "lk_window.cuh"

namespace {

using ofri_lk::kExt;
using ofri_lk::kGrid;
using ofri_lk::kMaxFactors;
using ofri_lk::Runs;

constexpr int kTileW = 64;             // output tile columns
constexpr int kTileH = 32;             // output tile rows
constexpr int kSegX = 32;              // x-pass outputs per thread: half a tile row
constexpr int kSegY = 16;              // y-pass outputs per thread: half a tile column
constexpr int kRows = kTileH + kExt;   // 63 product rows per tile
constexpr int kGw = kTileW + kExt;     // 95 gradient columns per tile (odd)
constexpr int kLdx = kTileW + 1;       // x-pass result row stride (odd)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kMaxDevices = 64;
static_assert(kThreads == 64 * (kTileW / kSegX) * 2, "x-pass: 64 row slots x 2 segments x 2 g");
static_assert(kThreads == kTileW * (kTileH / kSegY) * 2, "y-pass: 64 columns x 2 segments x 2 g");
static_assert(kRows < 64, "x-pass row slots");

// The factor list _smooth_factorization(L) gives a run of length L
// (ops/window_sums.py), ascending, 0-padded; factor k of run length L.
__host__ __device__ constexpr int ladder_fac(int L, int k) {
  const int table[kGrid + 1][kMaxFactors] = {
      {0, 0, 0, 0, 0},  // L = 0
      {0, 0, 0, 0, 0},  // L = 1
      {0, 0, 0, 0, 0},  // L = 2
      {0, 0, 0, 0, 0},  // L = 3
      {2, 2, 0, 0, 0},  // L = 4
      {2, 2, 0, 0, 0},  // L = 5
      {2, 3, 0, 0, 0},  // L = 6
      {2, 3, 0, 0, 0},  // L = 7
      {2, 2, 2, 0, 0},  // L = 8
      {3, 3, 0, 0, 0},  // L = 9
      {2, 5, 0, 0, 0},  // L = 10
      {2, 5, 0, 0, 0},  // L = 11
      {2, 2, 3, 0, 0},  // L = 12
      {2, 2, 3, 0, 0},  // L = 13
      {2, 2, 3, 0, 0},  // L = 14
      {3, 5, 0, 0, 0},  // L = 15
      {2, 2, 2, 2, 0},  // L = 16
      {2, 2, 2, 2, 0},  // L = 17
      {2, 3, 3, 0, 0},  // L = 18
      {2, 3, 3, 0, 0},  // L = 19
      {2, 2, 5, 0, 0},  // L = 20
      {2, 2, 5, 0, 0},  // L = 21
      {2, 2, 5, 0, 0},  // L = 22
      {2, 2, 5, 0, 0},  // L = 23
      {2, 2, 2, 3, 0},  // L = 24
      {2, 2, 2, 3, 0},  // L = 25
      {2, 2, 2, 3, 0},  // L = 26
      {3, 3, 3, 0, 0},  // L = 27
      {3, 3, 3, 0, 0},  // L = 28
      {3, 3, 3, 0, 0},  // L = 29
      {2, 3, 5, 0, 0},  // L = 30
      {2, 3, 5, 0, 0},  // L = 31
      {2, 2, 2, 2, 2},  // L = 32
  };
  return (L < 0 || L > kGrid || k < 0 || k >= kMaxFactors) ? 0 : table[L][k];
}

__host__ __device__ constexpr int ladder_nfac(int L) {
  int n = 0;
  while (n < kMaxFactors && ladder_fac(L, n) != 0) ++n;
  return n;
}

// product of the first s factors: the stride m before stage s
__host__ __device__ constexpr int ladder_prod(int L, int s) {
  int m = 1;
  for (int k = 0; k < s; ++k) m *= ladder_fac(L, k);
  return m;
}

// One ladder stage in place: v[i] = sum_{j<F} v[i + j*M] for i < N, left to right.
template <int F, int M, int N, int NV>
__device__ __forceinline__ void ladder_stage(float (&v)[NV]) {
  static_assert(N + (F - 1) * M <= NV, "ladder stage reads past the segment");
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = v[i];
#pragma unroll
    for (int j = 1; j < F; ++j) acc = acc + v[i + j * M];
    v[i] = acc;
  }
}

// Stages S.. of run length L for K outputs.  After all stages the first K
// entries must hold the final sums, so stage s forms K + M - m_{s+1} of them
// (M the product of all factors, m_{s+1} that of the first s+1).
template <int L, int K, int S, int NV>
__device__ __forceinline__ void ladder_stages(float (&v)[NV]) {
  if constexpr (S < ladder_nfac(L)) {
    constexpr int f = ladder_fac(L, S);
    constexpr int m = ladder_prod(L, S);
    ladder_stage<f, m, K + ladder_prod(L, ladder_nfac(L)) - m * f>(v);
    ladder_stages<L, K, S + 1>(v);
  }
}

// One run of length L for K consecutive outputs: src(i) is the input at
// offset lo + i from the segment's first output.  acc = term (first run) or
// acc + term.
template <int L, int K, class Src>
__device__ __forceinline__ void ladder_run(const Src& src, float (&acc)[K], bool first) {
  constexpr int M = ladder_prod(L, ladder_nfac(L));
  float v[K + M - 1];
#pragma unroll
  for (int i = 0; i < K + M - 1; ++i) v[i] = src(i);
  ladder_stages<L, K, 0>(v);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = v[k];
#pragma unroll
    for (int j = M; j < L; ++j) t = t + src(k + j);
    acc[k] = first ? t : acc[k] + t;
  }
}

template <int K, class Src>
__device__ __forceinline__ void ladder_any(int L, const Src& src, float (&acc)[K], bool first) {
  switch (L) {
#define OFRI_LADDER_CASE(n)            \
  case n:                              \
    ladder_run<n, K>(src, acc, first); \
    break;
    OFRI_LADDER_CASE(1) OFRI_LADDER_CASE(2) OFRI_LADDER_CASE(3) OFRI_LADDER_CASE(4)
    OFRI_LADDER_CASE(5) OFRI_LADDER_CASE(6) OFRI_LADDER_CASE(7) OFRI_LADDER_CASE(8)
    OFRI_LADDER_CASE(9) OFRI_LADDER_CASE(10) OFRI_LADDER_CASE(11) OFRI_LADDER_CASE(12)
    OFRI_LADDER_CASE(13) OFRI_LADDER_CASE(14) OFRI_LADDER_CASE(15) OFRI_LADDER_CASE(16)
    OFRI_LADDER_CASE(17) OFRI_LADDER_CASE(18) OFRI_LADDER_CASE(19) OFRI_LADDER_CASE(20)
    OFRI_LADDER_CASE(21) OFRI_LADDER_CASE(22) OFRI_LADDER_CASE(23) OFRI_LADDER_CASE(24)
    OFRI_LADDER_CASE(25) OFRI_LADDER_CASE(26) OFRI_LADDER_CASE(27) OFRI_LADDER_CASE(28)
    OFRI_LADDER_CASE(29) OFRI_LADDER_CASE(30) OFRI_LADDER_CASE(31) OFRI_LADDER_CASE(32)
#undef OFRI_LADDER_CASE
    default:
      break;
  }
}

size_t smem_floats(int ldj) { return (size_t)kRows * ldj + 2 * kRows * kGw + 2 * kRows * kLdx; }

__global__ void __launch_bounds__(kThreads, 2)
lk_build_kernel(const float* __restrict__ slab, const float* __restrict__ g,
                float* __restrict__ t1, float* __restrict__ t2, int h, int w, int nshift,
                int ldj, Runs runs_y, Runs runs_x) {
  extern __shared__ float smem[];
  float* J = smem;                   // kRows x ldj: the J rows of this sy
  float* G = J + kRows * ldj;        // 2 x kRows x kGw: both gradients
  float* X = G + 2 * kRows * kGw;    // 2 x kRows x kLdx: x-pass results

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int sy = blockIdx.z;
  const int core_h = h + kExt;
  const int core_w = w + kExt;
  const int slab_h = core_h + nshift - 1;
  const int slab_w = core_w + nshift - 1;
  const int jw = kGw + nshift - 1;
  const size_t plane = (size_t)h * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Stage once.  Outside the slab and the core: 0, read by no output that
  // is written.
  for (int r = warp; r < kRows; r += kWarps) {
    const int jy = y0 + sy + r;
    for (int c = lane; c < jw; c += 32) {
      const int jx = x0 + c;
      J[r * ldj + c] = (jy < slab_h && jx < slab_w) ? slab[(size_t)jy * slab_w + jx] : 0.0f;
    }
    const int gy = y0 + r;
    for (int c = lane; c < kGw; c += 32) {
      const int gx = x0 + c;
      const bool in = gy < core_h && gx < core_w;
      const size_t i = (size_t)gy * core_w + gx;
      G[r * kGw + c] = in ? g[i] : 0.0f;
      G[(kRows + r) * kGw + c] = in ? g[(size_t)core_h * core_w + i] : 0.0f;
    }
  }
  __syncthreads();

  const int xr = threadIdx.x & 63;                  // x-pass: product row
  const int xc = ((threadIdx.x >> 6) & 1) * kSegX;  // x-pass: first output column
  const int yc = threadIdx.x & 63;                  // y-pass: column
  const int yr = ((threadIdx.x >> 6) & 1) * kSegY;  // y-pass: first output row
  const int k = threadIdx.x >> 7;                   // both passes: the gradient

#pragma unroll 1
  for (int sx = 0; sx < nshift; ++sx) {
    if (xr < kRows) {
      const float* jrow = J + xr * ldj + xc + sx;
      const float* grow = G + (k * kRows + xr) * kGw + xc;
      float acc[kSegX] = {};
#pragma unroll 1
      for (int q = 0; q < runs_x.n; ++q) {
        const int lo = runs_x.run[q].lo;
        auto src = [&](int i) { return jrow[lo + i] * grow[lo + i]; };
        ladder_any(runs_x.run[q].len, src, acc, q == 0);
      }
      float* xrow = X + (k * kRows + xr) * kLdx + xc;
#pragma unroll
      for (int i = 0; i < kSegX; ++i) xrow[i] = acc[i];
    }
    __syncthreads();
    {
      const float* xcol = X + (k * kRows + yr) * kLdx + yc;
      float acc[kSegY] = {};
#pragma unroll 1
      for (int q = 0; q < runs_y.n; ++q) {
        const int lo = runs_y.run[q].lo;
        auto src = [&](int i) { return xcol[(lo + i) * kLdx]; };
        ladder_any(runs_y.run[q].len, src, acc, q == 0);
      }
      const int x = x0 + yc;
      if (x < w) {
        float* out = (k == 0 ? t1 : t2) + (size_t)(sy * nshift + sx) * plane + x;
#pragma unroll
        for (int i = 0; i < kSegY; ++i) {
          const int y = y0 + yr + i;
          if (y < h) __stcs(out + (size_t)y * w, acc[i]);
        }
      }
    }
    __syncthreads();
  }
}

// The kernel serves a run only with the ladder it was compiled for.
bool ladders_match(const Runs& runs) {
  for (int q = 0; q < runs.n; ++q) {
    const ofri_lk::Run& r = runs.run[q];
    if (r.nfac != ladder_nfac(r.len)) return false;
    for (int k = 0; k < r.nfac; ++k)
      if (r.fac[k] != ladder_fac(r.len, k)) return false;
  }
  return true;
}

}  // namespace

// Shift planes t1, t2 ((2R+1)^2, h, w) from the J slab (h+31+2R, w+31+2R) and
// the gradient pair g (2, h+31, w+31), all row-major float32 on `device`.
// runs_y, runs_x are host tables (lk_window.cuh).  Enqueues one launch on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a bad table
// or an R whose J rows do not fit shared memory).
extern "C" int ofri_lk_build(const float* slab, const float* g, float* t1, float* t2, int h,
                             int w, int R, const int* runs_y_table, const int* runs_x_table,
                             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Runs runs_y, runs_x;
  if (!ofri_lk::runs_from_table(runs_y_table, &runs_y) ||
      !ofri_lk::runs_from_table(runs_x_table, &runs_x) || !ladders_match(runs_y) ||
      !ladders_match(runs_x) || R < 0 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const int nshift = 2 * R + 1;
  const int ldj = (kGw + nshift - 1) | 1;  // odd: conflict-free row walks
  const size_t smem = sizeof(float) * smem_floats(ldj);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  // the shared-memory opt-in, raised only when a larger R needs it: the call
  // costs host time
  static size_t opted_in[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > opted_in[device]) {
    err = cudaFuncSetAttribute(lk_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted_in[device] = smem;
  }
  dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, nshift);
  lk_build_kernel<<<grid, kThreads, smem, stream>>>(slab, g, t1, t2, h, w, nshift, ldj, runs_y,
                                                    runs_x);
  return cudaGetLastError();
}
