// Horn-Schunck Jacobi relaxation on Hopper (sm_90a), temporally blocked.
//
// Replaces two TPU kernels of the JAX package with one implementation:
//   opticalflow_ri_tpu/ops/pallas/hs_iter.py:hs_iterate_pallas        (whole state in VMEM)
//   opticalflow_ri_tpu/ops/pallas/hs_tiled.py:hs_iterate_pallas_tiled (T=20 temporal blocking)
// Whole-state VMEM residency has no per-SM counterpart; one temporally
// blocked kernel serves every shape with H, W >= 2, with no 8x128 gate.
//
// What bounds it on an H100, for n iterations on h x w pixels: bytes, 28 B
// per pixel (fx, fy, ft, u0, v0 read once, u, v written once): 7.3 MB at
// 512^2 (2.2 us at 3.35 TB/s), 117 MB at 2048^2 (35 us); operations, 27 per
// pixel-iteration (per field: the row sum (l + 2c) + r, the column sum of
// three row sums, minus 4 * centre, times 1/12: 9; the update: 9), 0.71
// GFLOP for 100 iterations at 512^2 (11 us at 67 TFLOP/s) and 11.3 GFLOP at
// 2048^2 (0.17 ms).  So the bound is the operations.  One launch per
// iteration, as this kernel was first written, re-streams the 7 MB state 100
// times (at 512^2 each launch is ~3 us, as long as its own traffic).
//
// Design (what it does about that bound): T iterations per launch on a
// 64 x 64 extended tile; the output tile is its centre (64 - 2T)^2, so a
// solve takes ceil(n / T) launches and device memory sees the state once per
// T iterations.
//   * A 1024-thread block gives each thread 4 neighbouring cells of one
//     tile row and keeps their u, v, fx, fy, ft and 1/(alpha^2 + fx^2 +
//     fy^2) in registers for the whole launch.
//   * An iteration forms each cell's row sum (l + 2c) + r in registers, the
//     two neighbours beyond the 4 cells by warp shuffles (a tile row is 16
//     lanes of one warp), and publishes the row sums to shared memory, one
//     16-byte store per field; after one barrier each thread reads the row
//     sums of the rows above and below (16-byte loads, conflict-free) and
//     updates its cells.  Row sums are double-buffered: one barrier per
//     iteration.
//   * Tiles that lie inside the image run a copy of the loop without the
//     border tests.
// The halo re-does (64 / (64 - 2T))^2 of the work.  T is set by the wrapper
// (ops/cuda/hs_iter.py), which also plans the launches and the buffer each
// writes, so that the last lands in the output.  A launch costs ~6 us
// beyond its iterations at 512^2 (scripts/torch_kernel_times.py
// --hs-niters); one cooperative launch with a grid barrier per T iterations
// saved none of it, so the launches stay apart.
//
// The border.  The mirror rule (edge not repeated: -1 -> 1, n -> n-2) is an
// index rule inside the tile, as in global memory: the row above row 0 is
// row 1, the left neighbour of column 0 is column 1, so every sum keeps the
// order (l + 2c) + r of the plain version; padding the tile by a mirrored
// copy and iterating it would add (r + 2c) + l on the mirrored side, which is
// not the same float.  Cells outside the image are never updated.  At the
// tile's interior edges a missing neighbour reads the cell itself: that
// value is wrong, but after t iterations only cells within t of such an edge
// hold wrong values, and the output cells are T deep.
//
// Numerics: the association order is that of ops/stencil.py:hs_avg3x3 and
// models/horn_schunck.py:hs_solve; built with -fmad=false, the kernel equals
// the plain PyTorch version (ops/cuda/hs_iter.py:hs_iterate_plain) bit for bit.
// The only fused multiply-adds are the exact ones, a + 2b and a - 4b (add2x,
// sub4x): they round once, where the plain version rounds once too.
#include <cuda_runtime.h>

namespace {

constexpr int kExt = 64;                   // extended tile side
constexpr int kCells = 4;                  // cells per thread: 4 neighbouring columns of one row
constexpr int kStrips = kExt / kCells;     // threads per tile row: 16 lanes of one warp
constexpr int kThreads = kExt * kStrips;   // 1024
constexpr int kMaxT = kExt / 2 - 1;        // the output tile keeps >= 2 cells
constexpr int kBuf = kExt * kExt;
constexpr size_t kSmemBytes = sizeof(float) * 4 * kBuf;  // row sums: 2 fields x 2 buffers
constexpr float kTwelfth = static_cast<float>(1.0 / 12.0);
constexpr int kMaxDevices = 64;
static_assert(32 % kStrips == 0, "a tile row lies in one warp");

// a + 2b and a - 4b as one fused multiply-add each: 2b and 4b are exact in
// float, so the single rounding of the fused form is the rounding of the
// sum, as in the plain version (which forms 2b, then adds), for every value
// below 2^125
__device__ __forceinline__ float add2x(float a, float b) { return __fmaf_rn(2.0f, b, a); }
__device__ __forceinline__ float sub4x(float a, float b) { return __fmaf_rn(-4.0f, b, a); }

// T iterations of one tile.  kBorder: the extended tile reaches past the
// image, so cells may lie outside it or on its edge (mirror); false for the
// tiles inside, which skip those tests.
template <bool kBorder>
__device__ __forceinline__ void hs_tile(const float* __restrict__ fx,
                                        const float* __restrict__ fy,
                                        const float* __restrict__ ft, float alpha,
                                        const float* __restrict__ u_in,
                                        const float* __restrict__ v_in,
                                        float* __restrict__ u_out, float* __restrict__ v_out,
                                        int h, int w, int T, int nit, int oy, int ox,
                                        float* smem) {
  const int tile = kExt - 2 * T;
  const int r = threadIdx.x / kStrips;   // tile row
  const int s = threadIdx.x % kStrips;   // columns 4s .. 4s+3
  const int lane = threadIdx.x & 31;
  const int gy = oy + r;
  const int gx0 = ox + kCells * s;
  // the rows above and below: mirror at the image border, the row itself at
  // the tile's interior edge
  const int rm = kBorder && gy == 0 ? r + 1 : max(r - 1, 0);
  const int rp = kBorder && gy == h - 1 ? r - 1 : min(r + 1, kExt - 1);
  // the neighbours of the 4 columns: lane s-1's last, lane s+1's first (the
  // cell itself at the tile's interior edge)
  const int from_left = s > 0 ? lane - 1 : lane;
  const int from_right = s < kStrips - 1 ? lane + 1 : lane;

  bool in[kCells], ml[kCells], mr[kCells];
  float u[kCells], v[kCells], cfx[kCells], cfy[kCells], cft[kCells], crd[kCells];
  const float a2 = alpha * alpha;
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int gx = gx0 + j;
    in[j] = !kBorder || (gy >= 0 && gy < h && gx >= 0 && gx < w);
    ml[j] = kBorder && gx == 0;
    mr[j] = kBorder && gx == w - 1;
    u[j] = v[j] = cfx[j] = cfy[j] = cft[j] = crd[j] = 0.0f;
    if (in[j]) {
      const size_t i = (size_t)gy * w + gx;
      cfx[j] = fx[i];
      cfy[j] = fy[i];
      cft[j] = ft[i];
      crd[j] = 1.0f / ((a2 + cfx[j] * cfx[j]) + cfy[j] * cfy[j]);
      u[j] = u_in[i];
      v[j] = v_in[i];
    }
  }

  for (int it = 0; it < nit; ++it) {
    float* su = smem + (it & 1) * kBuf;
    float* sv = su + 2 * kBuf;
    const float ul = __shfl_sync(0xffffffffu, u[kCells - 1], from_left);
    const float ur = __shfl_sync(0xffffffffu, u[0], from_right);
    const float vl = __shfl_sync(0xffffffffu, v[kCells - 1], from_left);
    const float vr = __shfl_sync(0xffffffffu, v[0], from_right);
    float ru[kCells], rv[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      float lu = j == 0 ? (s > 0 ? ul : u[0]) : u[j - 1];
      float xu = j == kCells - 1 ? (s < kStrips - 1 ? ur : u[j]) : u[j + 1];
      float lv = j == 0 ? (s > 0 ? vl : v[0]) : v[j - 1];
      float xv = j == kCells - 1 ? (s < kStrips - 1 ? vr : v[j]) : v[j + 1];
      if (ml[j]) lu = xu, lv = xv;  // mirror: column -1 is column 1
      if (mr[j]) xu = lu, xv = lv;  // column w is column w - 2
      ru[j] = add2x(lu, u[j]) + xu;
      rv[j] = add2x(lv, v[j]) + xv;
    }
    reinterpret_cast<float4*>(su + r * kExt)[s] = make_float4(ru[0], ru[1], ru[2], ru[3]);
    reinterpret_cast<float4*>(sv + r * kExt)[s] = make_float4(rv[0], rv[1], rv[2], rv[3]);
    __syncthreads();
    const float4 a = reinterpret_cast<const float4*>(su + rm * kExt)[s];
    const float4 b = reinterpret_cast<const float4*>(su + rp * kExt)[s];
    const float4 c = reinterpret_cast<const float4*>(sv + rm * kExt)[s];
    const float4 d = reinterpret_cast<const float4*>(sv + rp * kExt)[s];
    const float um[kCells] = {a.x, a.y, a.z, a.w}, up[kCells] = {b.x, b.y, b.z, b.w};
    const float vm[kCells] = {c.x, c.y, c.z, c.w}, vp[kCells] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const float ua = sub4x(add2x(um[j], ru[j]) + up[j], u[j]) * kTwelfth;
      const float va = sub4x(add2x(vm[j], rv[j]) + vp[j], v[j]) * kTwelfth;
      const float der = ((cfx[j] * ua + cfy[j] * va) + cft[j]) * crd[j];
      if (in[j]) {  // cells outside the image are never updated
        u[j] = ua - cfx[j] * der;
        v[j] = va - cfy[j] * der;
      }
    }
  }

  // the output tile: rows and columns T .. T + tile - 1, inside the image
  if (r < T || r >= T + tile) return;
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int c = kCells * s + j;
    if (!in[j] || c < T || c >= T + tile) continue;
    const size_t i = (size_t)gy * w + gx0 + j;
    u_out[i] = u[j];
    v_out[i] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
hs_block_kernel(const float* __restrict__ fx, const float* __restrict__ fy,
                const float* __restrict__ ft, float alpha, const float* __restrict__ u_in,
                const float* __restrict__ v_in, float* __restrict__ u_out,
                float* __restrict__ v_out, int h, int w, int T, int nit) {
  // row sums of u in buffers 0 and 1, of v in 2 and 3
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = kExt - 2 * T;
  const int oy = blockIdx.y * tile - T;  // image row of tile row 0
  const int ox = blockIdx.x * tile - T;
  // a tile whose rows and columns 0 .. kExt-1 all lie strictly inside the
  // image: no cell outside it, none on its edge
  if (oy > 0 && ox > 0 && oy + kExt < h && ox + kExt < w)
    hs_tile<false>(fx, fy, ft, alpha, u_in, v_in, u_out, v_out, h, w, T, nit, oy, ox, smem);
  else
    hs_tile<true>(fx, fy, ft, alpha, u_in, v_in, u_out, v_out, h, w, T, nit, oy, ox, smem);
}

}  // namespace

// niter Jacobi iterations from (u0, v0) in the launches of `plan`: nlaunch
// pairs (iterations, destination), destination 0 = (u_out, v_out) and 1 =
// (u_tmp, v_tmp).  Each launch reads the previous one's destination (the
// first reads u0, v0); destinations alternate and the last is 0; each count
// is 1..T.  nlaunch = 0 copies (u0, v0) to the output.  T is the temporal
// block depth, 1..31.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a plan that breaks these rules.
extern "C" int ofri_hs_iterate(const float* fx, const float* fy, const float* ft,
                               const float* u0, const float* v0, float alpha, int h, int w,
                               int T, const int* plan, int nlaunch, float* u_out, float* v_out,
                               float* u_tmp, float* v_tmp, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (h < 2 || w < 2 || T < 1 || T > kMaxT || nlaunch < 0) return cudaErrorInvalidValue;
  for (int k = 0; k < nlaunch; ++k) {
    const int n = plan[2 * k];
    const int dst = plan[2 * k + 1];
    if (n < 1 || n > T || (dst != 0 && dst != 1) ||
        (k > 0 && dst == plan[2 * k - 1]) || (k == nlaunch - 1 && dst != 0))
      return cudaErrorInvalidValue;
  }
  if (nlaunch == 0) {
    size_t bytes = (size_t)h * w * sizeof(float);
    cudaMemcpyAsync(u_out, u0, bytes, cudaMemcpyDeviceToDevice, stream);
    cudaMemcpyAsync(v_out, v0, bytes, cudaMemcpyDeviceToDevice, stream);
    return cudaGetLastError();
  }
  // the shared-memory opt-in, once per device: the call costs host time
  static bool opted_in[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(hs_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  const int tile = kExt - 2 * T;
  dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
  const float* su = u0;
  const float* sv = v0;
  for (int k = 0; k < nlaunch; ++k) {
    float* du = plan[2 * k + 1] == 0 ? u_out : u_tmp;
    float* dv = plan[2 * k + 1] == 0 ? v_out : v_tmp;
    hs_block_kernel<<<grid, kThreads, kSmemBytes, stream>>>(fx, fy, ft, alpha, su, sv, du, dv, h,
                                                            w, T, plan[2 * k]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    su = du;
    sv = dv;
  }
  return cudaSuccess;
}
