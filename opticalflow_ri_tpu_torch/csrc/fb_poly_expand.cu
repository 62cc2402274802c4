// Farneback polynomial expansion of one frame on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the expansion as XLA ops
// (models/farneback.py: poly_expansion, impl="vpu"), and the port's plain
// version (ops/cuda/poly_expand.py: poly_expand_plain) is that chain in
// PyTorch: three vertical 1-D correlations of the source with g, xg and xxg,
// six horizontal ones of their results (replicate border), then five
// combinations with the Gram-inverse constants.  Run as PyTorch ops it is
// ~250 elementwise launches over whole planes for one frame.  Here one
// launch computes the (5, H, W) field, every intermediate in shared memory.
//
// What bounds it on an H100: bytes.  Each source value is read once and the
// five output planes written once, 24 B a pixel (~0.030 ms at 2048^2 at
// 3.35 TB/s); the arithmetic is ~130 products and as many sums a pixel at
// polyN 7 (~0.017 ms at 67 TFLOP/s).
//
// Design: one 256-thread block per 32 x 64 output tile.
//   1. It stages the tile's source with its n-row and n-column aprons in
//      shared memory: rows come from srcp (which holds n rows above and
//      below the image: the replicate rule's, or a rows-sharded stripe's
//      halo), columns are clamped into the image (the replicate rule).
//   2. The three vertical correlations, over every staged column: a thread
//      sums 4 rows of one column from a sliding window of source values in
//      registers, into three shared planes.
//   3. The six horizontal correlations and the five combinations: a warp
//      takes 32 neighbouring columns of a row, a thread 4 rows at once, and
//      the five planes are stored coalesced.
// Shared memory: (32 + 2n + 3 x 32) x (64 + 2n) floats, 44 KB at n = 7.
//
// Bit for bit with the plain version: every tap is a product then a sum,
// each rounded on its own (__fmul_rn, __fadd_rn, and -fmad=false), taps in
// index order, a zero-weight tap skipped, and the first term added to -0
// (-0 + t == t for every t, so it is the plain chain's first term itself).
// Every basis has a non-zero tap: were all of xg's zero, the Gram matrix
// would be singular and prepare_poly_gaussian would raise.  The
// combinations keep their order: b1 ig03 + b5 ig33 and so on.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 7;  // polyN 5 and 7 (the adapter's), and any n from 1 to this
constexpr int kMaxTaps = 2 * kMaxN + 1;
constexpr int kTH = 32;                  // output tile rows
constexpr int kTW = 64;                  // output tile columns
constexpr int kThreads = 256;
constexpr int kRV = 4;                   // rows a thread sums in the vertical pass
constexpr int kRH = 4;                   // rows a thread sums at once in the horizontal pass
constexpr int kRowStep = kThreads / kTW;  // rows of threads in the horizontal pass
static_assert(kTW == 64 && kTH % kRV == 0 && kTH % (kRowStep * kRH) == 0, "tile");
static_assert((kTH + 2 * kMaxN + 3 * kTH) * (kTW + 2 * kMaxN) * 4 <= 48 * 1024,
              "shared memory within the default 48 KB");

// The three 1-D bases (zero past 2n) and the Gram-inverse constants
// (ops/cuda/poly_expand.py: prepare_poly_gaussian).  Passed by value.
struct PolySpec {
  int n;
  float g[kMaxTaps], xg[kMaxTaps], xxg[kMaxTaps];
  float ig11, ig03, ig33, ig55;
};

__device__ __forceinline__ float mac(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}

__global__ void __launch_bounds__(kThreads)
poly_expand_kernel(const float* __restrict__ srcp, float* __restrict__ out, int h, int w,
                   PolySpec p) {
  extern __shared__ float smem[];
  const int n = p.n;
  const int nt = 2 * n + 1;
  const int sw = kTW + 2 * n;  // columns staged, and of the vertical sums
  const int sh = kTH + 2 * n;  // rows staged
  float* src = smem;           // sh x sw
  float* ve = src + sh * sw;   // kTH x sw each: the g, xg and xxg vertical sums
  float* vo = ve + kTH * sw;
  float* vq = vo + kTH * sw;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;

  // 1. the source tile; rows past srcp's last feed only outputs below the
  // image, which are not stored
  const int last_row = h + 2 * n - 1;
  for (int i = threadIdx.x; i < sh * sw; i += kThreads) {
    const int r = i / sw;
    const int c = i - r * sw;
    const int gy = min(y0 + r, last_row);
    const int gx = min(max(x0 - n + c, 0), w - 1);
    src[i] = __ldg(srcp + (size_t)gy * w + gx);
  }
  __syncthreads();

  // 2. vertical: rows r0 .. r0 + kRV - 1 of column c
  for (int i = threadIdx.x; i < (kTH / kRV) * sw; i += kThreads) {
    const int strip = i / sw;
    const int c = i - strip * sw;
    const int r0 = strip * kRV;
    const float* col = src + r0 * sw + c;
    float xs[kRV + kMaxTaps - 1];
    float e[kRV], o[kRV], q[kRV];
#pragma unroll
    for (int k = 0; k < kRV; ++k) {
      e[k] = o[k] = q[k] = -0.0f;
    }
#pragma unroll
    for (int k = 0; k < kRV - 1; ++k) xs[k] = col[k * sw];
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {
      if (j < nt) {
        xs[j + kRV - 1] = col[(j + kRV - 1) * sw];
        const float wg = p.g[j], wx = p.xg[j], wq = p.xxg[j];
        if (wg != 0.0f) {
#pragma unroll
          for (int k = 0; k < kRV; ++k) e[k] = mac(e[k], xs[j + k], wg);
        }
        if (wx != 0.0f) {
#pragma unroll
          for (int k = 0; k < kRV; ++k) o[k] = mac(o[k], xs[j + k], wx);
        }
        if (wq != 0.0f) {
#pragma unroll
          for (int k = 0; k < kRV; ++k) q[k] = mac(q[k], xs[j + k], wq);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRV; ++k) {
      const int s = (r0 + k) * sw + c;
      ve[s] = e[k];
      vo[s] = o[k];
      vq[s] = q[k];
    }
  }
  __syncthreads();

  // 3. horizontal and the combinations: column c, rows rb + kRowStep k
  const int c = (threadIdx.x & 31) + 32 * ((threadIdx.x >> 5) & 1);
  const int x = x0 + c;
  const size_t plane = (size_t)h * w;
  for (int rb = threadIdx.x >> 6; rb < kTH; rb += kRowStep * kRH) {
    float b1[kRH], b2[kRH], b3[kRH], b4[kRH], b5[kRH], b6[kRH];
#pragma unroll
    for (int k = 0; k < kRH; ++k) {
      b1[k] = b2[k] = b3[k] = b4[k] = b5[k] = b6[k] = -0.0f;
    }
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {
      if (j < nt) {
        const float wg = p.g[j], wx = p.xg[j], wq = p.xxg[j];
        float e[kRH], o[kRH], q[kRH];
#pragma unroll
        for (int k = 0; k < kRH; ++k) {
          const int s = (rb + kRowStep * k) * sw + c + j;
          e[k] = ve[s];
          o[k] = vo[s];
          q[k] = vq[s];
        }
        if (wg != 0.0f) {
#pragma unroll
          for (int k = 0; k < kRH; ++k) {
            b1[k] = mac(b1[k], e[k], wg);
            b3[k] = mac(b3[k], o[k], wg);
            b5[k] = mac(b5[k], q[k], wg);
          }
        }
        if (wx != 0.0f) {
#pragma unroll
          for (int k = 0; k < kRH; ++k) {
            b2[k] = mac(b2[k], e[k], wx);
            b6[k] = mac(b6[k], o[k], wx);
          }
        }
        if (wq != 0.0f) {
#pragma unroll
          for (int k = 0; k < kRH; ++k) b4[k] = mac(b4[k], e[k], wq);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRH; ++k) {
      const int y = y0 + rb + kRowStep * k;
      if (y < h && x < w) {
        const size_t i = (size_t)y * w + x;
        const float b1g = __fmul_rn(b1[k], p.ig03);
        out[i] = __fmul_rn(b3[k], p.ig11);
        out[plane + i] = __fmul_rn(b2[k], p.ig11);
        out[2 * plane + i] = __fadd_rn(b1g, __fmul_rn(b5[k], p.ig33));
        out[3 * plane + i] = __fadd_rn(b1g, __fmul_rn(b4[k], p.ig33));
        out[4 * plane + i] = __fmul_rn(b6[k], p.ig55);
      }
    }
  }
}

}  // namespace

// The expansion (5, h, w) of the image that srcp (h + 2n, w) holds with n
// rows above and below it; g, xg, xxg: the 2n + 1 taps of each basis, ig:
// ig11, ig03, ig33, ig55.  One launch on `stream`; returns
// cudaErrorInvalidValue for n outside [1, kMaxN] or an empty image, else
// cudaGetLastError().
extern "C" int ofri_fb_poly_expand(const float* srcp, float* out, int h, int w, int n,
                                   const float* g, const float* xg, const float* xxg,
                                   const float* ig, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (h < 1 || w < 1 || n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  const int nt = 2 * n + 1;
  PolySpec p = {};
  p.n = n;
  for (int j = 0; j < nt; ++j) {
    p.g[j] = g[j];
    p.xg[j] = xg[j];
    p.xxg[j] = xxg[j];
  }
  p.ig11 = ig[0];
  p.ig03 = ig[1];
  p.ig33 = ig[2];
  p.ig55 = ig[3];
  const size_t smem = sizeof(float) * (size_t)(kTH + 2 * n + 3 * kTH) * (kTW + 2 * n);
  dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH);
  poly_expand_kernel<<<grid, kThreads, smem, stream>>>(srcp, out, h, w, p);
  return cudaGetLastError();
}
