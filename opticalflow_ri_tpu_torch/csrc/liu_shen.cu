// Liu-Shen fixed-point solve on Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package with one implementation:
//   opticalflow_ri_tpu/ops/pallas/liu_shen_iter.py:liu_shen_iterate_pallas    (whole state in VMEM)
//   opticalflow_ri_tpu/ops/pallas/ls_tiled.py:liu_shen_iterate_pallas_tiled   (T=16 stripes)
// Whole-state VMEM residency has no per-SM counterpart; the 512^2 state
// (8 fields, u, v and the ping-pong pair: 14.7 MB) sits in the 50 MB L2, so the
// same kernel serves every shape with H, W >= 2 and no 8x128 alignment gate.
//
// Stopping rule: that of the XLA while loop and of the whole-state kernel,
// exactly -- iterate while err > tol and k < max_iter, with err checked after
// every iteration.  The tiled kernel's overrun of up to T-1 iterations has no
// counterpart here.  The check costs no host synchronisation: the host
// enqueues every launch of the solve in one C call, and the device keeps the
// loop state (active flag, k, err) in a small workspace.
//   * ls_init_kernel: active = (max_iter > 0 && 1e8 > tol), k = 0.
//   * ls_step_kernel, max_iter launches: each block returns at once when the
//     solve has stopped; otherwise one thread per pixel forms (u_new, v_new)
//     and the block writes its partial sums of (u_new-u)^2 and (v_new-v)^2.
//     The last block to finish (ticket counter) adds the partials in block
//     order -- a fixed order, so err is deterministic -- and updates err, k
//     and the flag.
//   * ls_finish_kernel: copies the buffer that holds iteration k (u0 for
//     k = 0) into the output and writes err (0 when no iteration ran) and k.
//
// What bounds it on an H100: one launch per iteration, each reading 10 fields
// (40 B) and writing 8 B per pixel.  At 512^2 that is 12.6 MB per iteration
// out of L2, a few microseconds -- about as long as the launch itself, so the
// 60-iteration solve is launch-bound.  At 2048^2 (235 MB of state) each
// iteration streams HBM.  A persistent cooperative kernel with a grid barrier
// per iteration, or temporal blocking in shared memory, is the next step.
//
// Numerics: the association order is that of models/liu_shen.py
// (ls_field_stencils, ls_ring_sum, liu_shen_iteration); built with
// -fmad=false, u and v equal the plain PyTorch version
// (ops/cuda/liu_shen_iter.py:liu_shen_iterate_plain) bit for bit whenever both
// run the same number of iterations.  err is reduced in double, in another
// order than torch.linalg.norm, so it agrees to round-off only.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;

struct LsState {
  int active;
  int k;
  float err;
  unsigned int ticket;
};

// The workspace: the loop state, then two doubles of partial sums per block.
constexpr size_t kStateBytes = 16;
static_assert(sizeof(LsState) <= kStateBytes, "LsState outgrew its slot");

int num_blocks(int h, int w) {
  return ((w + kBlockX - 1) / kBlockX) * ((h + kBlockY - 1) / kBlockY);
}

__global__ void ls_init_kernel(LsState* st, int active) {
  st->active = active;
  st->k = 0;
  st->err = 1e8f;
  st->ticket = 0u;
}

// Fixed-order tree sums of one double per thread in each of a and b; the
// results land in a[0] and b[0].
__device__ __forceinline__ void block_sum2(double* a, double* b, int t) {
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      a[t] += a[t + stride];
      b[t] += b[t + stride];
    }
    __syncthreads();
  }
}

__global__ void ls_step_kernel(const float* __restrict__ iix, const float* __restrict__ iiy,
                               const float* __restrict__ ii, const float* __restrict__ ixt,
                               const float* __restrict__ iyt, const float* __restrict__ b11,
                               const float* __restrict__ b12, const float* __restrict__ b22,
                               float hreg, const float* __restrict__ u,
                               const float* __restrict__ v, float* __restrict__ un,
                               float* __restrict__ vn, int h, int w, int max_iter, float tol,
                               LsState* st, double* partials) {
  // the flag was written by an earlier launch, or by this launch's last
  // block only after every block had passed this read
  if (!*(volatile int*)&st->active) return;

  __shared__ double su[kThreads];
  __shared__ double sv[kThreads];
  __shared__ bool last;
  const int t = threadIdx.y * kBlockX + threadIdx.x;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  double eu = 0.0, ev = 0.0;
  if (x < w && y < h) {
    // "nearest" border: an index clamp
    const int xm = x > 0 ? x - 1 : 0;
    const int xp = x < w - 1 ? x + 1 : w - 1;
    const size_t rn = (size_t)(y > 0 ? y - 1 : 0) * w;
    const size_t rc = (size_t)y * w;
    const size_t rs = (size_t)(y < h - 1 ? y + 1 : h - 1) * w;
    // zero border of the ring term
    const bool hn = y > 0, hs = y < h - 1, hw = x > 0, he = x < w - 1;

    const float unw = u[rn + xm], un_ = u[rn + x], une = u[rn + xp];
    const float uw = u[rc + xm], uc = u[rc + x], ue = u[rc + xp];
    const float usw = u[rs + xm], us = u[rs + x], use = u[rs + xp];
    const float vnw = v[rn + xm], vn_ = v[rn + x], vne = v[rn + xp];
    const float vw = v[rc + xm], vc = v[rc + x], ve = v[rc + xp];
    const float vsw = v[rs + xm], vs = v[rs + x], vse = v[rs + xp];

    // ls_field_stencils
    const float du1 = (us - un_) * 0.5f;
    const float du2 = (ue - uw) * 0.5f;
    const float fu1 = un_ + us;
    const float mu = ((use - usw) - (une - unw)) * 0.25f;
    const float dv1 = (vs - vn_) * 0.5f;
    const float dv2 = (ve - vw) * 0.5f;
    const float fv2 = vw + ve;
    const float mv = ((vse - vsw) - (vne - vnw)) * 0.25f;

    // ls_ring_sum: ((n + c) + s) per column, then ((w + c) + e) - centre,
    // reading 0 outside the image
    const float zu_nw = (hn && hw) ? unw : 0.0f, zu_n = hn ? un_ : 0.0f, zu_ne = (hn && he) ? une : 0.0f;
    const float zu_w = hw ? uw : 0.0f, zu_e = he ? ue : 0.0f;
    const float zu_sw = (hs && hw) ? usw : 0.0f, zu_s = hs ? us : 0.0f, zu_se = (hs && he) ? use : 0.0f;
    const float ring_u = (((zu_nw + zu_w) + zu_sw) + ((zu_n + uc) + zu_s) + ((zu_ne + zu_e) + zu_se)) - uc;
    const float zv_nw = (hn && hw) ? vnw : 0.0f, zv_n = hn ? vn_ : 0.0f, zv_ne = (hn && he) ? vne : 0.0f;
    const float zv_w = hw ? vw : 0.0f, zv_e = he ? ve : 0.0f;
    const float zv_sw = (hs && hw) ? vsw : 0.0f, zv_s = hs ? vs : 0.0f, zv_se = (hs && he) ? vse : 0.0f;
    const float ring_v = (((zv_nw + zv_w) + zv_sw) + ((zv_n + vc) + zv_s) + ((zv_ne + zv_e) + zv_se)) - vc;

    // liu_shen_iteration, summed left to right as written there
    const size_t i = rc + x;
    const float a_iix = iix[i], a_iiy = iiy[i], a_ii = ii[i];
    const float bu = a_iix * (2.0f * du1 + dv2) + a_iiy * dv1 + a_ii * (fu1 + mv) + hreg * ring_u + ixt[i];
    const float bv = a_iiy * (du1 + 2.0f * dv2) + a_iix * du2 + a_ii * (mu + fv2) + hreg * ring_v + iyt[i];
    const float c11 = b11[i], c12 = b12[i], c22 = b22[i];
    const float u_new = -(c11 * bu + c12 * bv);
    const float v_new = -(c12 * bu + c22 * bv);
    un[i] = u_new;
    vn[i] = v_new;
    const double du = (double)(u_new - uc);
    const double dv = (double)(v_new - vc);
    eu = du * du;
    ev = dv * dv;
  }

  su[t] = eu;
  sv[t] = ev;
  __syncthreads();
  block_sum2(su, sv, t);
  const int nblocks = gridDim.x * gridDim.y;
  if (t == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * b] = su[0];
    partials[2 * b + 1] = sv[0];
    __threadfence();
    last = atomicAdd(&st->ticket, 1u) == (unsigned int)(nblocks - 1);
  }
  __syncthreads();
  if (!last) return;

  // the last block: add every block's partials in block order
  const volatile double* p = partials;
  double au = 0.0, av = 0.0;
  for (int b = t; b < nblocks; b += kThreads) {
    au += p[2 * b];
    av += p[2 * b + 1];
  }
  su[t] = au;
  sv[t] = av;
  __syncthreads();
  block_sum2(su, sv, t);
  if (t == 0) {
    const float err = (float)((sqrt(su[0]) + sqrt(sv[0])) / ((double)h * (double)w));
    const int k = st->k + 1;
    st->err = err;
    st->k = k;
    st->active = (err > tol) && (k < max_iter);
    st->ticket = 0u;
  }
}

// out <- the buffer holding iteration k: u0 for k = 0, buf_odd for odd k,
// buf_even for even k > 0; skips the copy where they are one buffer.
__global__ void ls_finish_kernel(const float* __restrict__ u0, const float* __restrict__ v0,
                                 const float* u_odd, const float* v_odd, const float* u_even,
                                 const float* v_even, float* u_out, float* v_out, int n,
                                 const LsState* st, float* err_out, int* k_out) {
  const int k = st->k;
  const float* su = k == 0 ? u0 : (k & 1) ? u_odd : u_even;
  const float* sv = k == 0 ? v0 : (k & 1) ? v_odd : v_even;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    *err_out = k > 0 ? st->err : 0.0f;
    *k_out = k;
  }
  if (i >= n || su == u_out) return;
  u_out[i] = su[i];
  v_out[i] = sv[i];
}

}  // namespace

// Bytes of device workspace ofri_liu_shen_iterate needs for an h x w field.
extern "C" size_t ofri_liu_shen_workspace_bytes(int h, int w) {
  return kStateBytes + 2 * sizeof(double) * (size_t)num_blocks(h, w);
}

// The Liu-Shen fixed-point solve from (u0, v0) on the 8 precomputed fields;
// the result lands in (u_out, v_out), err in *err_out and the iteration count
// in *k_out (both device pointers).  u_tmp, v_tmp are h*w scratch buffers,
// workspace holds ofri_liu_shen_workspace_bytes(h, w) bytes.  Enqueues
// everything on `stream` without waiting; returns cudaGetLastError().
extern "C" int ofri_liu_shen_iterate(const float* iix, const float* iiy, const float* ii,
                                     const float* ixt, const float* iyt, const float* b11,
                                     const float* b12, const float* b22, float hreg,
                                     const float* u0, const float* v0, int max_iter, float tol,
                                     int h, int w, float* u_out, float* v_out, float* u_tmp,
                                     float* v_tmp, float* err_out, int* k_out, void* workspace,
                                     int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  LsState* st = static_cast<LsState*>(workspace);
  double* partials = reinterpret_cast<double*>(static_cast<char*>(workspace) + kStateBytes);
  // the first check of the XLA loop: err = 1e8 > tol and 0 < max_iter
  const int active = (max_iter > 0) && (1e8f > tol);
  ls_init_kernel<<<1, 1, 0, stream>>>(st, active);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (active) {
    dim3 block(kBlockX, kBlockY);
    dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
    // iteration j (0-based) writes (u_out, v_out) for even j, the scratch
    // pair for odd j: iteration k's result is in u_out when k is odd
    const float* su = u0;
    const float* sv = v0;
    float* du = u_out;
    float* dv = v_out;
    for (int j = 0; j < max_iter; ++j) {
      ls_step_kernel<<<grid, block, 0, stream>>>(iix, iiy, ii, ixt, iyt, b11, b12, b22, hreg, su,
                                                 sv, du, dv, h, w, max_iter, tol, st, partials);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      su = du;
      sv = dv;
      du = (du == u_out) ? u_tmp : u_out;
      dv = (dv == v_out) ? v_tmp : v_out;
    }
  }
  const int n = h * w;
  ls_finish_kernel<<<(n + 255) / 256, 256, 0, stream>>>(u0, v0, u_out, v_out, u_tmp, v_tmp,
                                                        u_out, v_out, n, st, err_out, k_out);
  return cudaGetLastError();
}
