// Liu-Shen fixed-point solve on Hopper (sm_90a), temporally blocked.
//
// Replaces two TPU kernels of the JAX package with one implementation:
//   opticalflow_ri_tpu/ops/pallas/liu_shen_iter.py:liu_shen_iterate_pallas    (whole state in VMEM)
//   opticalflow_ri_tpu/ops/pallas/ls_tiled.py:liu_shen_iterate_pallas_tiled   (T=16 stripes)
// Whole-state VMEM residency has no per-SM counterpart; one temporally
// blocked kernel serves every shape with H, W >= 2, with no 8x128 gate.
//
// Stopping rule: that of the XLA while loop and of the whole-state kernel,
// exactly -- iterate while err > tol and k < max_iter, with err checked after
// every iteration.  The tiled kernel's overrun of up to T-1 iterations has no
// counterpart here, and the check costs no host synchronisation: the host
// enqueues every launch of the solve in one C call, and the device keeps the
// loop state (active flag, k, err, the buffer holding iteration k) in a small
// workspace.
//
// What bounds it on an H100, for 60 steps: operations, ~68 per pixel-step
// (0.016 ms at 512^2 at 67 TFLOP/s, 0.255 ms at 2048^2); the bytes (10 fields
// read once, u, v written once: 48 B per pixel) take less.  One launch per
// step, as this kernel was first written, re-read the 10 fields every step
// (12.6 MB at 512^2) and reduced err across the grid every step: 11 us a step.
//
// Design (what it does about that bound), the blocking of csrc/hs_jacobi.cu:
//   * Up to T steps per launch on a 32 x 64 extended tile; the output tile
//     is its centre (32 - 2T) x (64 - 2T).  A 512-thread block gives each
//     thread 4 neighbouring cells of one tile row and keeps their u, v and 8
//     coefficients in registers for the whole launch; the fields are read
//     from device memory once per launch.
//   * A step publishes u, v of the thread's cells to shared memory (one
//     16-byte store each), and after one barrier reads the rows above and
//     below (16-byte loads); the neighbours beyond the 4 columns come by warp
//     shuffles (a tile row is 16 lanes of one warp).  Double-buffered: one
//     barrier per step.
//   * err, step by step: each thread adds (du)^2 and (dv)^2 of the cells it
//     owns (the output tile, inside the image) in double and stores the pair
//     to its own shared-memory slot for that step.  At the end of the launch
//     one warp per step adds the block's slots in a fixed order and writes one
//     pair per block and step; the last block (atomic ticket) adds the blocks
//     in a fixed order, step by step, and finds the first step i at which
//     err <= tol or k = max_iter.  err is deterministic and equals
//     torch.linalg.norm's to round-off.
//   * The stop inside a launch.  Launches ping-pong between the output pair
//     and the scratch pair, so the launch that stopped leaves its input
//     untouched; it records i, its source and its destination, and a replay
//     launch, always enqueued after the last step launch and returning at
//     once unless i < its count, re-runs the i steps from that source into
//     that destination.  The finish launch copies the buffer holding
//     iteration k into the output.  Launches after the stop return at once.
//   * Tiles that lie inside the image run a copy of the loop without the
//     border tests.
// T and the launches' counts and buffers are planned by the wrapper
// (ops/cuda/liu_shen_iter.py:launch_plan); T = 6 measured fastest at 512^2
// and 2048^2 (at 512^2 each launch is 2 waves of blocks; T = 8 makes it 3).
// 128 registers a thread, no spills: one block per SM.  Two cells a thread
// in 1024-thread blocks measured no faster, so the step is bound by issue,
// not by latency.
//
// The border.  The derivative stencils read the "nearest" border: the row
// above row 0 is row 0, the left neighbour of column 0 is column 0 -- an
// index rule, as in global memory.  The ring term reads 0 outside the image
// (a flag per side).  Cells outside the image are never updated and never
// read by a cell inside.  At the tile's interior edges a missing neighbour
// reads the cell itself: wrong, but after t steps only cells within t of such
// an edge hold wrong values, and the output cells are T deep.
//
// Per-side edges and the no-stop mode, for a rank's tile of a sharded image
// (parallel/sharded_kernel.py).  `edges` holds one bit per side (kTop,
// kBottom, kLeft, kRight): set, the side is the image's border and takes the
// nearest rule; clear, it is an apron edge, padded by the caller with rows of
// its neighbour's data, and a cell on it reads 0 beyond it (the cells outside
// the array), so wrong values creep in from it one cell a step.  The ring
// term reads 0 outside the array on every side already.  With stop = 0 the
// solve runs exactly max_iter steps and computes no err: the apron cells
// hold stale values, and an err over them could come out NaN (err > tol is
// false for NaN) and stop the solve; the caller computes err on the cells
// it owns.  All four bits set and stop = 1 is the whole-image solve, bit for
// bit.
//
// Numerics: the association order is that of models/liu_shen.py
// (ls_field_stencils, ls_ring_sum, liu_shen_iteration); built with
// -fmad=false, u and v equal the plain PyTorch version
// (ops/cuda/liu_shen_iter.py:liu_shen_iterate_plain) bit for bit, and k is
// equal whenever the two errs fall on the same side of tol.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                  // extended tile rows
constexpr int kCols = 64;                  // extended tile columns
constexpr int kCells = 4;                  // cells per thread: 4 neighbouring columns of one row
constexpr int kStrips = kCols / kCells;    // threads per tile row: 16 lanes of one warp
constexpr int kThreads = kRows * kStrips;  // 512
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = kRows / 2 - 1;       // the output tile keeps >= 2 rows
constexpr int kBuf = kRows * kCols;
constexpr size_t kStateSmem = sizeof(float) * 4 * kBuf;  // u, v: 2 fields x 2 buffers
constexpr int kMaxDevices = 64;
constexpr int kTop = 1, kBottom = 2, kLeft = 4, kRight = 8;  // the bits of `edges`
static_assert(kCells == 4, "a thread's cells are one float4 in shared memory");
static_assert(32 % kStrips == 0, "a tile row lies in one warp");
static_assert(kMaxT <= kWarps, "one warp adds each step's slots");

// the solve's buffers: the output pair, the scratch pair, the input (u0, v0)
enum Buffer : int { kOut = 0, kTmp = 1, kIn = 2 };

struct LsState {
  int active;      // the solve goes on
  int k;           // iterations done
  float err;       // err of iteration k
  unsigned int ticket;
  int replay_n;    // steps the replay launch re-runs; 0: none
  int replay_src;  // the Buffer it reads
  int replay_dst;  // the Buffer it writes
  int final_buf;   // the Buffer holding iteration k (k > 0)
};

// The workspace: the loop state, then two doubles per block and step.
constexpr size_t kStateBytes = 32;
static_assert(sizeof(LsState) <= kStateBytes, "LsState outgrew its slot");

struct LsFields {
  const float *iix, *iiy, *ii, *ixt, *iyt, *b11, *b12, *b22;
};

struct LsBuffers {
  const float* u[3];  // indexed by Buffer
  const float* v[3];
};

dim3 grid_for(int h, int w, int T) {
  const int tile_r = kRows - 2 * T, tile_c = kCols - 2 * T;
  return dim3((w + tile_c - 1) / tile_c, (h + tile_r - 1) / tile_r);
}

int num_blocks(int h, int w, int T) {
  const dim3 g = grid_for(h, w, T);
  return (int)(g.x * g.y);
}

size_t smem_bytes(int T) { return kStateSmem + sizeof(double2) * (size_t)T * kThreads; }

// stop = 0: the solve runs max_iter steps without err, into kOut
__global__ void ls_init_kernel(LsState* st, int active, int stop, int max_iter) {
  st->active = active;
  st->k = stop ? 0 : max(max_iter, 0);
  st->err = stop ? 1e8f : __int_as_float(0x7fc00000);  // no err: NaN
  st->ticket = 0u;
  st->replay_n = 0;
  st->replay_src = kIn;
  st->replay_dst = kOut;
  st->final_buf = stop ? kIn : kOut;
}

// The left and right neighbours of cell j in a row of 4 cells x, with lx, rx
// the row's values one column beyond (from the lanes beside): the cell
// itself at the tile's interior edge and at the image's edge ("nearest").
__device__ __forceinline__ float left_of(const float* x, float lx, int j, int s, bool cl) {
  if (cl) return x[j];
  return j == 0 ? (s > 0 ? lx : x[0]) : x[j - 1];
}
__device__ __forceinline__ float right_of(const float* x, float rx, int j, int s, bool cr) {
  if (cr) return x[j];
  return j == kCells - 1 ? (s < kStrips - 1 ? rx : x[j]) : x[j + 1];
}

// nit steps of one tile from (u_in, v_in), the owned cells written to
// (u_out, v_out).  slots: this step's (du^2, dv^2) per thread, or null (the
// replay).  kBorder: the extended tile reaches past the image, so cells may
// lie outside it or on its edge; false for the tiles inside.
template <bool kBorder>
__device__ __forceinline__ void ls_tile(const LsFields& f, float hreg,
                                        const float* __restrict__ u_in,
                                        const float* __restrict__ v_in, float* __restrict__ u_out,
                                        float* __restrict__ v_out, int h, int w, int T, int nit,
                                        int oy, int ox, int edges, float* smem, double2* slots) {
  const int tile_r = kRows - 2 * T;
  const int tile_c = kCols - 2 * T;
  const int r = threadIdx.x / kStrips;   // tile row
  const int s = threadIdx.x % kStrips;   // columns 4s .. 4s+3
  const int lane = threadIdx.x & 31;
  const int gy = oy + r;
  const int gx0 = ox + kCells * s;
  // the rows above and below: the row itself at the image border
  // ("nearest") and at the tile's interior edge (and, at an apron edge, the
  // row of zeros beyond)
  const int rm = kBorder && (edges & kTop) && gy == 0 ? r : max(r - 1, 0);
  const int rp = kBorder && (edges & kBottom) && gy == h - 1 ? r : min(r + 1, kRows - 1);
  // the ring term's zero border, by side
  const bool hn = !kBorder || gy > 0;
  const bool hs = !kBorder || gy < h - 1;
  const int from_left = s > 0 ? lane - 1 : lane;
  const int from_right = s < kStrips - 1 ? lane + 1 : lane;
  const bool own_row = r >= T && r < T + tile_r && (!kBorder || (gy >= 0 && gy < h));

  bool in[kCells], cl[kCells], cr[kCells], own[kCells];
  float u[kCells], v[kCells];
  float c_iix[kCells], c_iiy[kCells], c_ii[kCells], c_ixt[kCells], c_iyt[kCells];
  float c_b11[kCells], c_b12[kCells], c_b22[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int gx = gx0 + j;
    const int c = kCells * s + j;
    in[j] = !kBorder || (gy >= 0 && gy < h && gx >= 0 && gx < w);
    cl[j] = kBorder && (edges & kLeft) && gx == 0;
    cr[j] = kBorder && (edges & kRight) && gx == w - 1;
    own[j] = in[j] && own_row && c >= T && c < T + tile_c;
    u[j] = v[j] = c_iix[j] = c_iiy[j] = c_ii[j] = c_ixt[j] = c_iyt[j] = 0.0f;
    c_b11[j] = c_b12[j] = c_b22[j] = 0.0f;
    if (in[j]) {
      const size_t i = (size_t)gy * w + gx;
      c_iix[j] = f.iix[i];
      c_iiy[j] = f.iiy[i];
      c_ii[j] = f.ii[i];
      c_ixt[j] = f.ixt[i];
      c_iyt[j] = f.iyt[i];
      c_b11[j] = f.b11[i];
      c_b12[j] = f.b12[i];
      c_b22[j] = f.b22[i];
      u[j] = u_in[i];
      v[j] = v_in[i];
    }
  }

  for (int it = 0; it < nit; ++it) {
    float* su = smem + (it & 1) * kBuf;
    float* sv = su + 2 * kBuf;
    reinterpret_cast<float4*>(su + r * kCols)[s] = make_float4(u[0], u[1], u[2], u[3]);
    reinterpret_cast<float4*>(sv + r * kCols)[s] = make_float4(v[0], v[1], v[2], v[3]);
    __syncthreads();
    const float4 a = reinterpret_cast<const float4*>(su + rm * kCols)[s];
    const float4 b = reinterpret_cast<const float4*>(su + rp * kCols)[s];
    const float4 c = reinterpret_cast<const float4*>(sv + rm * kCols)[s];
    const float4 d = reinterpret_cast<const float4*>(sv + rp * kCols)[s];
    const float un[kCells] = {a.x, a.y, a.z, a.w}, us[kCells] = {b.x, b.y, b.z, b.w};
    const float vn[kCells] = {c.x, c.y, c.z, c.w}, vs[kCells] = {d.x, d.y, d.z, d.w};
    // each row's values one column beyond the thread's 4, from the lanes beside
    const float unl = __shfl_sync(0xffffffffu, un[kCells - 1], from_left);
    const float unr = __shfl_sync(0xffffffffu, un[0], from_right);
    const float ucl = __shfl_sync(0xffffffffu, u[kCells - 1], from_left);
    const float ucr = __shfl_sync(0xffffffffu, u[0], from_right);
    const float usl = __shfl_sync(0xffffffffu, us[kCells - 1], from_left);
    const float usr = __shfl_sync(0xffffffffu, us[0], from_right);
    const float vnl = __shfl_sync(0xffffffffu, vn[kCells - 1], from_left);
    const float vnr = __shfl_sync(0xffffffffu, vn[0], from_right);
    const float vcl = __shfl_sync(0xffffffffu, v[kCells - 1], from_left);
    const float vcr = __shfl_sync(0xffffffffu, v[0], from_right);
    const float vsl = __shfl_sync(0xffffffffu, vs[kCells - 1], from_left);
    const float vsr = __shfl_sync(0xffffffffu, vs[0], from_right);

    double eu = 0.0, ev = 0.0;
    float u_new[kCells], v_new[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const bool hw = !kBorder || !cl[j];
      const bool he = !kBorder || !cr[j];
      const float unw = left_of(un, unl, j, s, cl[j]), un_ = un[j];
      const float une = right_of(un, unr, j, s, cr[j]);
      const float uw = left_of(u, ucl, j, s, cl[j]), uc = u[j], ue = right_of(u, ucr, j, s, cr[j]);
      const float usw = left_of(us, usl, j, s, cl[j]), us_ = us[j];
      const float use = right_of(us, usr, j, s, cr[j]);
      const float vnw = left_of(vn, vnl, j, s, cl[j]), vn_ = vn[j];
      const float vne = right_of(vn, vnr, j, s, cr[j]);
      const float vw = left_of(v, vcl, j, s, cl[j]), vc = v[j], ve = right_of(v, vcr, j, s, cr[j]);
      const float vsw = left_of(vs, vsl, j, s, cl[j]), vs_ = vs[j];
      const float vse = right_of(vs, vsr, j, s, cr[j]);

      // ls_field_stencils
      const float du1 = (us_ - un_) * 0.5f;
      const float du2 = (ue - uw) * 0.5f;
      const float fu1 = un_ + us_;
      const float mu = ((use - usw) - (une - unw)) * 0.25f;
      const float dv1 = (vs_ - vn_) * 0.5f;
      const float dv2 = (ve - vw) * 0.5f;
      const float fv2 = vw + ve;
      const float mv = ((vse - vsw) - (vne - vnw)) * 0.25f;

      // ls_ring_sum: ((n + c) + s) per column, then ((w + c) + e) - centre,
      // reading 0 outside the image
      const float zu_nw = (hn && hw) ? unw : 0.0f, zu_n = hn ? un_ : 0.0f;
      const float zu_ne = (hn && he) ? une : 0.0f;
      const float zu_w = hw ? uw : 0.0f, zu_e = he ? ue : 0.0f;
      const float zu_sw = (hs && hw) ? usw : 0.0f, zu_s = hs ? us_ : 0.0f;
      const float zu_se = (hs && he) ? use : 0.0f;
      const float ring_u =
          (((zu_nw + zu_w) + zu_sw) + ((zu_n + uc) + zu_s) + ((zu_ne + zu_e) + zu_se)) - uc;
      const float zv_nw = (hn && hw) ? vnw : 0.0f, zv_n = hn ? vn_ : 0.0f;
      const float zv_ne = (hn && he) ? vne : 0.0f;
      const float zv_w = hw ? vw : 0.0f, zv_e = he ? ve : 0.0f;
      const float zv_sw = (hs && hw) ? vsw : 0.0f, zv_s = hs ? vs_ : 0.0f;
      const float zv_se = (hs && he) ? vse : 0.0f;
      const float ring_v =
          (((zv_nw + zv_w) + zv_sw) + ((zv_n + vc) + zv_s) + ((zv_ne + zv_e) + zv_se)) - vc;

      // liu_shen_iteration, summed left to right as written there
      const float bu = c_iix[j] * (2.0f * du1 + dv2) + c_iiy[j] * dv1 + c_ii[j] * (fu1 + mv) +
                       hreg * ring_u + c_ixt[j];
      const float bv = c_iiy[j] * (du1 + 2.0f * dv2) + c_iix[j] * du2 + c_ii[j] * (mu + fv2) +
                       hreg * ring_v + c_iyt[j];
      u_new[j] = -(c_b11[j] * bu + c_b12[j] * bv);
      v_new[j] = -(c_b12[j] * bu + c_b22[j] * bv);
      if (own[j]) {
        const double du = (double)(u_new[j] - uc);
        const double dv = (double)(v_new[j] - vc);
        eu += du * du;
        ev += dv * dv;
      }
    }
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (in[j]) {  // cells outside the image are never updated
        u[j] = u_new[j];
        v[j] = v_new[j];
      }
    }
    if (slots != nullptr) slots[it * kThreads + threadIdx.x] = make_double2(eu, ev);
  }

  // the output tile: rows T .. T + tile_r - 1 and columns T .. T + tile_c - 1, inside the image
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    if (!own[j]) continue;
    const size_t i = (size_t)gy * w + gx0 + j;
    u_out[i] = u[j];
    v_out[i] = v[j];
  }
}

// One launch of up to T steps.  A step launch (replay = 0) runs nit steps
// from buffer src into dst and settles the stop (unless stop = 0); the
// replay launch (replay = 1) re-runs st->replay_n steps of the launch that
// stopped, or returns at once.
__global__ void __launch_bounds__(kThreads, 1)
ls_block_kernel(LsFields f, float hreg, LsBuffers bufs, int src, int dst, int h, int w, int T,
                int nit, int max_iter, float tol, LsState* st, double2* partials, int replay,
                int edges, int stop) {
  if (replay) {
    nit = st->replay_n;
    if (nit == 0) return;
    src = st->replay_src;
    dst = st->replay_dst;
  } else if (!*(volatile int*)&st->active) {
    // the flag was written by an earlier launch, or by this launch's last
    // block only after every block had passed this read
    return;
  }
  extern __shared__ double2 smem2[];
  float* smem = reinterpret_cast<float*>(smem2);
  double2* slots = replay || !stop ? nullptr : reinterpret_cast<double2*>(smem + 4 * kBuf);
  __shared__ double2 sums[kMaxT];
  __shared__ bool last;
  const int tile_r = kRows - 2 * T;
  const int tile_c = kCols - 2 * T;
  const int oy = blockIdx.y * tile_r - T;  // image row of tile row 0
  const int ox = blockIdx.x * tile_c - T;
  float* u_out = const_cast<float*>(bufs.u[dst]);
  float* v_out = const_cast<float*>(bufs.v[dst]);
  // a tile whose rows and columns all lie strictly inside the image: no cell
  // outside it, none on its edge
  if (oy > 0 && ox > 0 && oy + kRows < h && ox + kCols < w)
    ls_tile<false>(f, hreg, bufs.u[src], bufs.v[src], u_out, v_out, h, w, T, nit, oy, ox, edges,
                   smem, slots);
  else
    ls_tile<true>(f, hreg, bufs.u[src], bufs.v[src], u_out, v_out, h, w, T, nit, oy, ox, edges,
                  smem, slots);
  if (replay || !stop) return;

  // each step's block sum of the slots, one warp a step, in thread order
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int nblocks = gridDim.x * gridDim.y;
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  if (warp < nit) {
    double au = 0.0, av = 0.0;
    for (int t = lane; t < kThreads; t += 32) {
      const double2 e = slots[warp * kThreads + t];
      au += e.x;
      av += e.y;
    }
    for (int o = 16; o > 0; o >>= 1) {
      au += __shfl_down_sync(0xffffffffu, au, o);
      av += __shfl_down_sync(0xffffffffu, av, o);
    }
    if (lane == 0) partials[(size_t)warp * nblocks + b] = make_double2(au, av);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&st->ticket, 1u) == (unsigned int)(nblocks - 1);
  __syncthreads();
  if (!last) return;

  // the last block: each step's sum over the blocks in block order, then
  // the first step that stops the solve
  __threadfence();
  if (warp < nit) {
    const volatile double* p = reinterpret_cast<const volatile double*>(partials);
    double au = 0.0, av = 0.0;
    for (int q = lane; q < nblocks; q += 32) {
      const size_t i = 2 * ((size_t)warp * nblocks + q);
      au += p[i];
      av += p[i + 1];
    }
    for (int o = 16; o > 0; o >>= 1) {
      au += __shfl_down_sync(0xffffffffu, au, o);
      av += __shfl_down_sync(0xffffffffu, av, o);
    }
    if (lane == 0) sums[warp] = make_double2(au, av);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int k0 = st->k;
    const double npix = (double)h * (double)w;
    int k = k0;
    float err = st->err;
    int halt = 0;
    for (int i = 0; i < nit; ++i) {
      err = (float)((sqrt(sums[i].x) + sqrt(sums[i].y)) / npix);
      k = k0 + i + 1;
      if (!(err > tol && k < max_iter)) {
        halt = i + 1;
        break;
      }
    }
    st->k = k;
    st->err = err;
    st->final_buf = dst;
    st->ticket = 0u;
    if (halt > 0) {
      st->active = 0;
      if (halt < nit) {  // iteration k lies inside this launch: replay it
        st->replay_n = halt;
        st->replay_src = src;
        st->replay_dst = dst;
      }
    }
  }
}

// out <- the buffer holding iteration k: u0 for k = 0; skips the copy where
// it is the output itself.
__global__ void ls_finish_kernel(LsBuffers bufs, float* u_out, float* v_out, int n,
                                 const LsState* st, float* err_out, int* k_out) {
  const int k = st->k;
  const int which = k == 0 ? kIn : st->final_buf;
  const float* su = bufs.u[which];
  const float* sv = bufs.v[which];
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

// Bytes of device workspace ofri_liu_shen_iterate needs for an h x w field
// at T steps per launch.
extern "C" size_t ofri_liu_shen_workspace_bytes(int h, int w, int T) {
  return kStateBytes + sizeof(double2) * (size_t)kMaxT * (size_t)num_blocks(h, w, T);
}

// The Liu-Shen fixed-point solve from (u0, v0) on the 8 precomputed fields,
// at most max_iter steps in the nlaunch launches of `plan`: pairs (steps,
// destination), destination 0 = (u_out, v_out) and 1 = (u_tmp, v_tmp); each
// launch reads the previous one's destination (the first reads u0, v0);
// destinations alternate and the last is 0; each count is 1..T and the
// counts add up to max_iter (nlaunch = 0 for max_iter <= 0).  T is 1..15.
// The result lands in (u_out, v_out), err in *err_out and the iteration count
// in *k_out (both device pointers).  workspace holds
// ofri_liu_shen_workspace_bytes(h, w, T) bytes.  edges: the sides that are
// the image's border, a mask of kTop | kBottom | kLeft | kRight (15: the
// whole image).  stop = 0 runs all max_iter steps and writes err = NaN.
// Enqueues everything on `stream` without waiting; returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments that break
// these rules.
extern "C" int ofri_liu_shen_iterate(const float* iix, const float* iiy, const float* ii,
                                     const float* ixt, const float* iyt, const float* b11,
                                     const float* b12, const float* b22, float hreg,
                                     const float* u0, const float* v0, int max_iter, float tol,
                                     int h, int w, int T, const int* plan, int nlaunch,
                                     float* u_out, float* v_out, float* u_tmp, float* v_tmp,
                                     float* err_out, int* k_out, void* workspace, int edges,
                                     int stop, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (h < 2 || w < 2 || T < 1 || T > kMaxT || nlaunch < 0 || edges < 0 || edges > 15 ||
      (stop != 0 && stop != 1))
    return cudaErrorInvalidValue;
  int total = 0;
  for (int k = 0; k < nlaunch; ++k) {
    const int n = plan[2 * k];
    const int dst = plan[2 * k + 1];
    if (n < 1 || n > T || (dst != kOut && dst != kTmp) ||
        (k > 0 && dst == plan[2 * k - 1]) || (k == nlaunch - 1 && dst != kOut))
      return cudaErrorInvalidValue;
    total += n;
  }
  if (total != (max_iter > 0 ? max_iter : 0)) return cudaErrorInvalidValue;

  LsState* st = static_cast<LsState*>(workspace);
  double2* partials = reinterpret_cast<double2*>(static_cast<char*>(workspace) + kStateBytes);
  const LsFields f{iix, iiy, ii, ixt, iyt, b11, b12, b22};
  const LsBuffers bufs{{u_out, u_tmp, u0}, {v_out, v_tmp, v0}};
  // the first check of the XLA loop: err = 1e8 > tol and 0 < max_iter
  const int active = (max_iter > 0) && (!stop || 1e8f > tol);
  ls_init_kernel<<<1, 1, 0, stream>>>(st, active, stop, max_iter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (active) {
    // the shared-memory opt-in, once per device and depth: the call costs
    // host time
    static size_t opted_in[kMaxDevices] = {};
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    const size_t bytes = smem_bytes(T);
    if (opted_in[device] < bytes) {
      err = cudaFuncSetAttribute(ls_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return err;
      opted_in[device] = bytes;
    }
    const dim3 grid = grid_for(h, w, T);
    int src = kIn;
    for (int k = 0; k < nlaunch; ++k) {
      const int dst = plan[2 * k + 1];
      ls_block_kernel<<<grid, kThreads, bytes, stream>>>(f, hreg, bufs, src, dst, h, w, T,
                                                         plan[2 * k], max_iter, tol, st,
                                                         partials, 0, edges, stop);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      src = dst;
    }
    // the replay: returns at once unless the stop fell inside a launch
    if (stop) {
      ls_block_kernel<<<grid, kThreads, kStateSmem, stream>>>(
          f, hreg, bufs, kIn, kOut, h, w, T, 0, max_iter, tol, st, partials, 1, edges, stop);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const int n = h * w;
  ls_finish_kernel<<<(n + 255) / 256, 256, 0, stream>>>(bufs, u_out, v_out, n, st, err_out,
                                                        k_out);
  return cudaGetLastError();
}
