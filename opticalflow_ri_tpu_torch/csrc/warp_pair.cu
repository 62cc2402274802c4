// Symmetric bilinear warp of an image pair on Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflow_ri_tpu/ops/pallas/warp_tent.py:
// warp_pair_tent_pallas (_warp_tent_kernel, _warp_tent_sparse_kernel).  The
// TPU kernel contracts a bilinear tent over all 17x17 integer shifts because
// TPU gathers are slow; its sparse variant skips shifts whose weight is zero.
// On Hopper a direct 4-tap gather computes the same sum: the tent weight
// max(0, 1-|d-s|) is non-zero only at s = floor(d) and floor(d)+1, so the
// sparse/dense split has no counterpart here.
//
// What bounds it on an H100: one pass over both images, 4 gathered reads of
// neighbouring pixels (cache hits for the smooth flows of PIV) plus 2 flow
// reads and 1 write per pixel -- memory-bound, ~8 MB at 512^2 per pair, a
// few microseconds, so launch overhead matters as much as bandwidth: both
// images go through a single launch.
//
// Numerics, held to the XLA contraction ops/warp.py:displacement_warp_tent:
//   * d is clipped to [-R, hi] with hi the float32 rounding of R - 1e-3;
//   * tap weights max(0, 1 - |dc - s|), products (wy * wx) * p, summed from
//     0 in sy-major order -- the order in which the contraction adds its
//     only non-zero terms, so the result equals it bit for bit;
//   * the integer shift is added to the integer pixel index and clamped to
//     the image (edge border); floor(y + d) in float would lose bits at 2048^2.
// Built with -fmad=false, it equals the plain PyTorch version bit for bit.
//
// A caller-padded mode (ofri_warp_pair_padded) warps a tile of a sharded
// image from its neighbours' cells; the TPU kernel has none (GSPMD runs the
// JAX package's sharded warp as XLA).  See Tile below.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ int clampi(int i, int hi) { return i < 0 ? 0 : (i > hi ? hi : i); }

// The caller-padded mode (a tile of a sharded image): each image arrives
// with an apron of `apron` cells on every side, its row stride w + 2*apron,
// and the flows and outputs are the tile's own (h, w).  The tap's global
// index, row0 + y + floor(d) (and + 1), is clamped into the image exactly as
// in the whole-image call and then read from the padded tile, so an
// interior side's apron must hold the neighbour's cells out to the clipped
// reach: floor(d) in [-R, R-1] plus the second tap, R cells.  Given those
// cells every output equals the whole-image call's, bit for bit.
struct Tile {
  int row0, col0;      // the tile's origin in the image
  int img_h, img_w;    // the image's extent
  int apron, stride;   // the apron on every side; stride = w + 2 * apron
};

// kPadded = false is the whole-image kernel, its code as before the padded
// mode existed (the tile is not read); kPadded = true reads the padded tile.
template <bool kPadded>
__global__ void warp_pair_kernel(const float* __restrict__ im1, const float* __restrict__ im2,
                                 const float* __restrict__ dy1, const float* __restrict__ dx1,
                                 const float* __restrict__ dy2, const float* __restrict__ dx2,
                                 float* __restrict__ out1, float* __restrict__ out2, int h, int w,
                                 float lo, float hi, Tile tile) {
  int x = blockIdx.x * kBlockX + threadIdx.x;
  int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  bool second = blockIdx.z == 1;
  const float* img = second ? im2 : im1;
  const float* dyf = second ? dy2 : dy1;
  const float* dxf = second ? dx2 : dx1;
  float* out = second ? out2 : out1;

  size_t i = (size_t)y * w + x;
  float dyc = fminf(fmaxf(dyf[i], lo), hi);
  float dxc = fminf(fmaxf(dxf[i], lo), hi);
  float sy = floorf(dyc);
  float sx = floorf(dxc);
  float wy0 = fmaxf(0.0f, 1.0f - fabsf(dyc - sy));
  float wy1 = fmaxf(0.0f, 1.0f - fabsf(dyc - (sy + 1.0f)));
  float wx0 = fmaxf(0.0f, 1.0f - fabsf(dxc - sx));
  float wx1 = fmaxf(0.0f, 1.0f - fabsf(dxc - (sx + 1.0f)));
  int y0 = y + (int)sy;
  int x0 = x + (int)sx;
  const float* r0;
  const float* r1;
  int c0, c1;
  if constexpr (kPadded) {
    int gy0 = tile.row0 + y0;
    int gx0 = tile.col0 + x0;
    int ry = tile.apron - tile.row0;
    int rx = tile.apron - tile.col0;
    r0 = img + (size_t)(clampi(gy0, tile.img_h - 1) + ry) * tile.stride;
    r1 = img + (size_t)(clampi(gy0 + 1, tile.img_h - 1) + ry) * tile.stride;
    c0 = clampi(gx0, tile.img_w - 1) + rx;
    c1 = clampi(gx0 + 1, tile.img_w - 1) + rx;
  } else {
    r0 = img + (size_t)clampi(y0, h - 1) * w;
    r1 = img + (size_t)clampi(y0 + 1, h - 1) * w;
    c0 = clampi(x0, w - 1);
    c1 = clampi(x0 + 1, w - 1);
  }

  float acc = 0.0f;
  acc = acc + (wy0 * wx0) * r0[c0];
  acc = acc + (wy0 * wx1) * r0[c1];
  acc = acc + (wy1 * wx0) * r1[c0];
  acc = acc + (wy1 * wx1) * r1[c1];
  out[i] = acc;
}

}  // namespace

// Warp im1 by (dy1, dx1) into out1 and im2 by (dy2, dx2) into out2, all (h, w)
// row-major float32, in one launch.  Returns cudaGetLastError().
extern "C" int ofri_warp_pair(const float* im1, const float* im2, const float* dy1,
                              const float* dx1, const float* dy2, const float* dx2, float* out1,
                              float* out2, int h, int w, float lo, float hi, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, 2);
  warp_pair_kernel<false><<<grid, block, 0, stream>>>(im1, im2, dy1, dx1, dy2, dx2, out1, out2,
                                                      h, w, lo, hi, Tile{});
  return cudaGetLastError();
}

// The caller-padded mode: im1 and im2 are (h + 2*apron, w + 2*apron) tiles of
// an (img_h, img_w) image whose owned cells start at (row0, col0); the flows
// and outputs are (h, w).  Returns cudaGetLastError().
extern "C" int ofri_warp_pair_padded(const float* im1, const float* im2, const float* dy1,
                                     const float* dx1, const float* dy2, const float* dx2,
                                     float* out1, float* out2, int h, int w, float lo, float hi,
                                     int row0, int col0, int img_h, int img_w, int apron,
                                     int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, 2);
  Tile tile{row0, col0, img_h, img_w, apron, w + 2 * apron};
  warp_pair_kernel<true><<<grid, block, 0, stream>>>(im1, im2, dy1, dx1, dy2, dx2, out1, out2,
                                                     h, w, lo, hi, tile);
  return cudaGetLastError();
}
