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
// Design (what it does about that bound): one 640-thread block per 32 x 64
// output tile runs the tile routine of fb_tile.cuh (shared with the fused
// loop, fb_fused.cu): five groups of 128 threads blur the five planes side
// by side, register-blocked along each pass (8 outputs a thread, a ring of
// 8 inputs), the y-pass from device memory into a shared-memory slab, the
// x-pass from it, the border rule as per-tile tables of source rows and
// columns; then the solve reads the five blurred planes from shared memory.
// Shared memory: 104 KB at 33 taps, 165 KB at 129.
//
// The per-side y mask (K12/K13's sharded mode, the JAX package's
// blur5_flow_call on a caller-padded M in parallel/sharded_pallas.py:410-416):
// a side inside the image comes with half = n / 2 rows of the neighbour's M,
// which the y-pass reads; a side on the image's border keeps the border
// table's rule.  x is always the whole width.  With both sides on the border
// the launch is the whole-image one, bit for bit.
#include <cuda_runtime.h>

#include "fb_common.cuh"
#include "fb_tile.cuh"

namespace {

using ofri_fb::BlurSpec;
using ofri_fb::kMaxTaps;
using Tile = ofri_fb::BlurTile<64>;

constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(Tile::kThreads, 1)
blur5_flow_kernel(const float* __restrict__ m, float* __restrict__ fx_out,
                  float* __restrict__ fy_out, int h, int w, int a_top, int a_bot, BlurSpec spec) {
  extern __shared__ float smem[];
  __shared__ Tile::Tables tables;
  const int x0 = blockIdx.x * Tile::kTW;
  const int y0 = blockIdx.y * Tile::kTH;
  Tile::load_taps(spec, tables);
  // M is read-only for the launch: through the read-only data cache
  Tile::blur(m, h, w, a_top, a_bot, y0, x0, spec, tables, smem,
             [](const float* p) { return __ldg(p); });
  Tile::solve(smem, spec.n, h, w, y0, x0, [&](int, int, size_t i, float u, float v) {
    fx_out[i] = u;
    fy_out[i] = v;
  });
}

}  // namespace

// Blur M (5, a_top + h + a_bot, w) with the host tap table (n odd taps,
// mode 0 "mirror" or 1 "nearest", post-scale `scale`) and solve; writes the
// flow (h, w) of the rows after the a_top apron rows.  a_top and a_bot are 0
// (the image's border) or n / 2 (a neighbour's rows).  One launch on
// `stream`; returns cudaErrorInvalidValue for a malformed table or apron,
// else cudaGetLastError().
extern "C" int ofri_fb_blur5_flow(const float* m, float* fx_out, float* fy_out, int h, int w,
                                  int a_top, int a_bot, const float* taps, int n, int mode,
                                  float scale, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BlurSpec spec;
  if (h < 2 || w < 2 || !ofri_fb::blur_spec_from_host(taps, n, mode, scale, &spec) ||
      (a_top != 0 && a_top != n / 2) || (a_bot != 0 && a_bot != n / 2))
    return cudaErrorInvalidValue;
  // the shared-memory opt-in for the largest window, once per device: the
  // call costs host time
  static bool opted_in[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(blur5_flow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tile::smem_bytes(kMaxTaps));
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  dim3 grid((w + Tile::kTW - 1) / Tile::kTW, (h + Tile::kTH - 1) / Tile::kTH);
  blur5_flow_kernel<<<grid, Tile::kThreads, Tile::smem_bytes(n), stream>>>(
      m, fx_out, fy_out, h, w, a_top, a_bot, spec);
  return cudaGetLastError();
}
