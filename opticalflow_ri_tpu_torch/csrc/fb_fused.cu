// The Farneback iteration loop in one persistent cooperative launch on
// Hopper (sm_90a).
//
// Replaces opticalflow_ri_tpu/ops/pallas/fb_fused2.py: fb_fused2_pallas
// (_fb_fused2_kernel): n_iters rounds of updateMatrices, then the window
// blur and the 2x2 solve, in one launch.  On the TPU the loop body had to
// live in VMEM, which it outgrew (343 MB of scoped VMEM at 512^2), and its
// blur was reassociated into fold-matrix products.  Here the result equals
// n_iters rounds of update_matrices_plain -> blur5_flow_plain bit for bit
// (every phase keeps the op order of fb_update_matrices.cu and
// fb_blur5_flow.cu; the TPU kernel's fold-matrix blur is within 1e-4 of it).
//
// What bounds it on an H100: the blur's arithmetic, as in fb_blur5_flow.cu
// (5 planes x 2 passes x n taps, a product and a sum each: -fmad=false keeps
// the plain version's rounding, so the card issues two instructions where
// the bound counts one fused one), plus updateMatrices (R0, the R1 gathers
// and M's write), plus one grid barrier a round.  M is 5 planes of 4 B a
// pixel: at 512^2 its two copies (10.5 MB), R0 and R1 stay in the 50 MB L2;
// at 2048^2 they stream from device memory, and updateMatrices' ~0.3 GB a
// round runs beside, not under, the blur (one block an SM).
//
// Design (what it does about that bound): the blocks are persistent, as many
// as the card holds at once (at most one per tile), and walk the 32 x 64
// output tiles (tile = blockIdx.x, += gridDim.x).  A tile is blurred in
// shared memory by the routine of fb_blur5_flow.cu (fb_tile.cuh); the thread
// that solves a pixel runs updateMatrices of its new flow right away
// (ofri_fb::update_matrices_pixel) and writes M there:
//
//   M_a = um(f0)                                  (every pixel)
//   repeat n_iters times:
//     grid barrier
//     for each tile of this block:
//       blur M_a's 5 planes -> shared memory; solve -> (u, v)
//       last round: write the flow    else: M_b[pixel] = um(u, v)
//     swap M_a, M_b
//
//   * Why a grid barrier each round: the 33-tap window reaches 16 pixels
//     past a tile, so a round's tile needs M of its neighbours' pixels from
//     the round before.  Blocking rounds in time inside a block would grow
//     that halo by 16 pixels a round (80 at 5 rounds: a 32 x 64 tile would
//     blur a 192 x 224 region).
//   * Why two M buffers: in a round a block writes M of its tile's pixels
//     while other blocks still read them as their halo, so the writes go to
//     the other buffer.  The one barrier a round is then the only ordering
//     needed.  M is read with plain loads (not __ldg: the read-only data
//     cache is not coherent with the writes of this launch); the barrier's
//     fence orders every block's writes before them.
//   * The flow is written once, in the last round; n_iters = 0 copies f0.
// Shared memory: 104 KB a block at 33 taps, 165 KB at 129 (one block an SM).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fb_common.cuh"
#include "fb_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using ofri_fb::BlurSpec;
using ofri_fb::kMaxTaps;
using ofri_fb::UmParams;

using Tile = ofri_fb::BlurTile<64>;
constexpr int kMaxDevices = 64;

// f(x, y, i, u, v) at each of this thread's pixels of the tile at (y0, x0),
// with (u, v) the start flow there.  All of the thread's start-flow values
// are loaded before the first f, so that their loads are in flight together
// (updateMatrices gathers R1 where the flow points: a load that waits on a
// load).
template <class F>
__device__ __forceinline__ void with_start_flow(const float* __restrict__ fx0,
                                                const float* __restrict__ fy0, int h, int w,
                                                int y0, int x0, F f) {
  constexpr int kPixels = Tile::kTH * Tile::kTW;
  constexpr int kPer = (kPixels + Tile::kThreads - 1) / Tile::kThreads;
  float u[kPer], v[kPer];
  size_t at[kPer];
  bool in[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = threadIdx.x + k * Tile::kThreads;
    const int y = y0 + q / Tile::kTW;
    const int x = x0 + q % Tile::kTW;
    in[k] = q < kPixels && y < h && x < w;
    at[k] = in[k] ? (size_t)y * w + x : 0;  // pixel 0 stands in: loaded, not used
    u[k] = fx0[at[k]];
    v[k] = fy0[at[k]];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = threadIdx.x + k * Tile::kThreads;
    if (in[k]) f(x0 + q % Tile::kTW, y0 + q / Tile::kTW, at[k], u[k], v[k]);
  }
}

// M of the flow (u, v) at pixel (x, y), flat index i, into the 5 planes of m
__device__ __forceinline__ void store_m(const float* __restrict__ r0, const float* __restrict__ r1,
                                        float u, float v, int x, int y, size_t i,
                                        const UmParams& p, float* m) {
  const size_t plane = (size_t)p.h * p.w;
  float mm[5];
  ofri_fb::update_matrices_pixel(r0, r1, u, v, x, y, p, mm);
#pragma unroll
  for (int c = 0; c < 5; ++c) m[c * plane + i] = mm[c];
}

__global__ void __launch_bounds__(Tile::kThreads, 1)
fb_fused_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                const float* __restrict__ fx0, const float* __restrict__ fy0,
                float* __restrict__ fx, float* __restrict__ fy, float* m_a, float* m_b,
                UmParams p, int n_iters, BlurSpec spec) {
  extern __shared__ float smem[];
  __shared__ Tile::Tables tables;
  cg::grid_group grid = cg::this_grid();
  const int h = p.h;
  const int w = p.w;
  const int tiles_x = (w + Tile::kTW - 1) / Tile::kTW;
  const int tiles = tiles_x * ((h + Tile::kTH - 1) / Tile::kTH);

  if (n_iters <= 0) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      with_start_flow(fx0, fy0, h, w, (t / tiles_x) * Tile::kTH, (t % tiles_x) * Tile::kTW,
                      [&](int, int, size_t i, float u, float v) {
                        fx[i] = u;
                        fy[i] = v;
                      });
    return;
  }
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    with_start_flow(fx0, fy0, h, w, (t / tiles_x) * Tile::kTH, (t % tiles_x) * Tile::kTW,
                    [&](int x, int y, size_t i, float u, float v) {
                      store_m(r0, r1, u, v, x, y, i, p, m_a);
                    });
  Tile::load_taps(spec, tables);
  for (int it = 0; it < n_iters; ++it) {
    grid.sync();  // M_a is whole: every block's writes of the round before
    const bool last = it + 1 == n_iters;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int y0 = (t / tiles_x) * Tile::kTH;
      const int x0 = (t % tiles_x) * Tile::kTW;
      Tile::blur(m_a, h, w, 0, 0, y0, x0, spec, tables, smem, [](const float* q) { return *q; });
      Tile::solve(smem, spec.n, h, w, y0, x0, [&](int x, int y, size_t i, float u, float v) {
        if (last) {
          fx[i] = u;
          fy[i] = v;
        } else {
          store_m(r0, r1, u, v, x, y, i, p, m_b);
        }
      });
    }
    float* done = m_a;
    m_a = m_b;
    m_b = done;
  }
}

}  // namespace

// n_iters rounds of updateMatrices -> blur + solve from the flow (fx0, fy0):
// r0, r1 (5, h, w), fx0, fy0 (h, w), outputs fx, fy (h, w), M buffers m_a and
// m_b (5, h, w) each, all row-major float32 on `device`; R and hi as for
// ofri_fb_update_matrices, the tap table as for ofri_fb_blur5_flow.  One
// cooperative launch on `stream`.  Returns cudaErrorNotSupported when the
// device cannot launch cooperatively, cudaErrorInvalidValue for bad
// arguments, else the launch's error.
extern "C" int ofri_fb_fused(const float* r0, const float* r1, const float* fx0, const float* fy0,
                             float* fx, float* fy, float* m_a, float* m_b, int h, int w,
                             int n_iters, int R, float hi, const float* taps, int n, int mode,
                             float scale, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BlurSpec spec;
  if (h < 2 || w < 2 || n_iters < 0 ||
      !ofri_fb::blur_spec_from_host(taps, n, mode, scale, &spec))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  // Queried once, since each query costs host time: per device the SM count
  // (0: not yet; a device without cooperative launch is never cached), with
  // the shared-memory opt-in for the largest window; per device and tap
  // count the blocks an SM holds at that window's shared memory.
  static int sms[kMaxDevices];
  static int per_sm[kMaxDevices][kMaxTaps + 1];
  if (!sms[device]) {
    int coop = 0, count = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fb_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tile::smem_bytes(kMaxTaps));
    if (err != cudaSuccess) return err;
    sms[device] = count;
  }
  const size_t smem = Tile::smem_bytes(n);
  if (!per_sm[device][n]) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fb_fused_kernel, Tile::kThreads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    per_sm[device][n] = blocks;
  }
  // every block resident (the condition of a cooperative launch), at most
  // one a tile
  const int tiles = ((w + Tile::kTW - 1) / Tile::kTW) * ((h + Tile::kTH - 1) / Tile::kTH);
  const int resident = per_sm[device][n] * sms[device];
  const int blocks = tiles < resident ? tiles : resident;
  UmParams p{h, w, R, hi, 0, h, 0, 0};  // the whole image
  void* args[] = {(void*)&r0, (void*)&r1,  (void*)&fx0, (void*)&fy0,     (void*)&fx,  (void*)&fy,
                  (void*)&m_a, (void*)&m_b, (void*)&p,   (void*)&n_iters, (void*)&spec};
  err = cudaLaunchCooperativeKernel((const void*)fb_fused_kernel, dim3(blocks),
                                    dim3(Tile::kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
