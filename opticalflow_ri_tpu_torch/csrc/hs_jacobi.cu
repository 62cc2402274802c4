// Horn-Schunck Jacobi relaxation on Hopper (sm_90a): one resident launch a
// solve where the tiles fit one wave, temporally blocked launches elsewhere.
//
// Replaces two TPU kernels of the JAX package with one implementation:
//   opticalflow_ri_tpu/ops/pallas/hs_iter.py:hs_iterate_pallas        (whole state in VMEM)
//   opticalflow_ri_tpu/ops/pallas/hs_tiled.py:hs_iterate_pallas_tiled (T=20 temporal blocking)
// One kernel name, hs_block_kernel, serves every shape with H, W >= 2, with
// no 8x128 gate: the blocked launch, and a template on the tile's width for
// the resident launch.
//
// What bounds it on an H100, for n iterations on h x w pixels: bytes, 28 B
// per pixel (fx, fy, ft, u0, v0 read once, u, v written once): 7.3 MB at
// 512^2 (2.2 us at 3.35 TB/s), 117 MB at 2048^2 (35 us); operations, 27 per
// pixel-iteration (per field: the row sum (l + 2c) + r, the column sum of
// three row sums, minus 4 * centre, times 1/12: 9; the update: 9), 4.2
// GFLOP for 600 iterations at 512^2 (63 us at 67 TFLOP/s) and 11.3 GFLOP for
// 100 at 2048^2 (0.17 ms).  So the bound is the operations.
//
// The tile and its iteration (both paths).  A block of up to 1024 threads
// holds an extended tile of rows x 4*kStrips cells (kStrips threads a row: 16
// on the blocked path, 8 or 16 on the resident one); each thread keeps 4
// neighbouring cells of one tile row, with their u, v, fx, fy, ft and
// 1/(alpha^2 + fx^2 + fy^2), in registers.  An
// iteration forms each cell's row sum (l + 2c) + r, the two neighbours beyond
// the 4 cells by warp shuffles (a tile row is kStrips lanes of one warp), and
// publishes the row sums to shared memory, one 16-byte store per field; after
// one barrier each thread reads the row sums of the rows above and below
// (16-byte loads, conflict-free) and updates its cells.  Row sums are
// double-buffered: one barrier per iteration.  The tile's output ("core") is
// its centre, core_h x core_w, inside a ring T cells deep; tiles that lie
// inside the image run a copy of the loop without the border tests.
//
// Path 1, temporally blocked: shapes whose tiles do not fit one
// wave, such as 2048^2.  64 x 64 tiles, T iterations a launch, a solve in
// ceil(n / T) launches; device memory sees the state once per T iterations.
// Each launch reloads its extended tile and forms the reciprocals again, and
// costs ~6-8 us beyond its iterations (PERF.md, section 6): at 512^2, 600
// iterations take 75 launches.  At 256^2 its 36 tiles leave 96 of the 132
// SMs idle.  The halo re-does (64 / (64 - 2T))^2 of the work.  T is set by
// the wrapper (ops/cuda/hs_iter.py: STEPS_PER_LAUNCH), which also plans the
// launches and the buffer each writes, so that the last lands in the output.
//
// Path 2, resident: shapes whose tiles fit one wave (on an
// H100, squares up to ~680^2; both levels of the 512^2 configurations).  One
// cooperative launch a solve, one tile an SM (the launch asks for more than
// half an SM's shared memory), every tile resident until the last iteration.  Each tile
// loads its fx, fy, ft, u0 and v0 and forms the reciprocals once, and keeps
// them in registers for the whole solve.  Every T iterations (a round) it
// publishes the T-deep band of its core (u and v only, st.global.cg) to an
// exchange buffer in device memory (two image-sized (u, v) pairs, one a
// round's parity: it stays in L2), passes a grid barrier, and reads its ring
// from its neighbours' bands (ld.global.cg: an SM's L1 may hold round k - 2's
// lines at the same addresses).  The interior and the coefficients are never
// reread.  Two buffers suffice: a tile writes round k's parity again in
// round k + 2, after the barrier of round k + 1, which every tile passed
// after reading round k.  The wrapper sizes the tiles from (h, w, n) and the
// SM count (hs_iter.resident_tiles: 32- or 64-wide tiles, the ring's depth,
// whole warps), so that at 256^2 as at 512^2 the grid covers the card; one
// tile alone needs no round and a ring of 1 (the zeros beyond the image).
// An earlier cooperative draft (one launch, a grid barrier every T
// iterations) saved nothing because each of its rounds still reloaded the
// extended tile from device memory and drained it back; here nothing is
// reloaded, and a round costs the barrier and the band, ~2.5-4 us on an
// H100.  Tried on the card and dropped (PERF.md, section 6): a flag a tile
// (release/acquire between neighbours) in place of the grid barrier, as fast
// within the runs' noise; 2 or 4 rows a thread (fewer shared-memory bytes a
// cell, fewer warps), 1.3-3x slower an iteration; warps waiting on their
// neighbour warps in place of the block barrier, 1.7x slower.
//
// The rule between the two (hs_iter.resident_tiles) reads (h, w, n) and the
// SM count alone: the resident path wherever a tiling of at most one tile an
// SM exists (tiles 32 or 64 cells wide, at most 1024 threads), the blocked
// path elsewhere.  The two paths keep two copies of the tile's iteration,
// the same arithmetic in the same order: the blocked one is the earlier
// kernel as it was (hs_tile; its arguments __restrict__ parameters), the
// resident one a Tile whose kernel takes its arguments as one struct.  Built
// from one source, one path or the other lost, measured on the H100 in one
// process (PERF.md, section 6): the struct of arguments cost the blocked path
// 2% at 2048^2, the __restrict__ parameters the resident path 4-5% at 256^2
// and 512^2.
//
// The border.  The mirror rule (edge not repeated: -1 -> 1, n -> n-2) is an
// index rule inside the tile, as in global memory: the row above row 0 is
// row 1, the left neighbour of column 0 is column 1, so every sum keeps the
// order (l + 2c) + r of the plain version; padding the tile by a mirrored
// copy and iterating it would add (r + 2c) + l on the mirrored side, which is
// not the same float.  Cells outside the image are never updated.  At the
// tile's interior edges a missing neighbour reads the cell itself: that
// value is wrong, but after t iterations only cells within t of such an edge
// hold wrong values, and the core cells are T deep.
//
// Per-side edges.  `edges` holds one bit per side of the array (kTop,
// kBottom, kLeft, kRight): set, the side is the image's border and takes the
// mirror rule; clear, it is an apron edge -- the array is one rank's tile of
// a sharded image, padded on that side by rows or columns of its neighbour's
// data (parallel/sharded_kernel.py).  The mirror rule does not fire there:
// a cell on an apron edge reads 0 beyond it (the cells outside the array,
// which are never updated), so wrong values creep in from that edge as from
// a tile's interior edge, one cell an iteration, and the caller crops them.
// All four bits set is the whole-image kernel, bit for bit.  Both paths.
//
// Numerics: the association order is that of ops/stencil.py:hs_avg3x3 and
// models/horn_schunck.py:hs_solve; built with -fmad=false, the kernel equals
// the plain PyTorch version (ops/cuda/hs_iter.py:hs_iterate_plain) bit for bit
// on both paths.  The only fused multiply-adds are the exact ones, a + 2b and
// a - 4b (add2x, sub4x): they round once, where the plain version rounds once
// too.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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
constexpr int kTop = 1, kBottom = 2, kLeft = 4, kRight = 8;  // the bits of `edges`
static_assert(32 % kStrips == 0, "a tile row lies in one warp");

// a + 2b and a - 4b as one fused multiply-add each: 2b and 4b are exact in
// float, so the single rounding of the fused form is the rounding of the
// sum, as in the plain version (which forms 2b, then adds), for every value
// below 2^125
__device__ __forceinline__ float add2x(float a, float b) { return __fmaf_rn(2.0f, b, a); }
__device__ __forceinline__ float sub4x(float a, float b) { return __fmaf_rn(-4.0f, b, a); }

// T iterations of one tile.  kBorder: the extended tile reaches past the
// image, so cells may lie outside it or on its edge (mirror where `edges`
// says so); false for the tiles inside, which skip those tests.
template <bool kBorder>
__device__ __forceinline__ void hs_tile(const float* __restrict__ fx,
                                        const float* __restrict__ fy,
                                        const float* __restrict__ ft, float alpha,
                                        const float* __restrict__ u_in,
                                        const float* __restrict__ v_in,
                                        float* __restrict__ u_out, float* __restrict__ v_out,
                                        int h, int w, int T, int nit, int oy, int ox,
                                        int edges, float* smem) {
  const int tile = kExt - 2 * T;
  const int r = threadIdx.x / kStrips;   // tile row
  const int s = threadIdx.x % kStrips;   // columns 4s .. 4s+3
  const int lane = threadIdx.x & 31;
  const int gy = oy + r;
  const int gx0 = ox + kCells * s;
  // the rows above and below: mirror at the image border, the row itself at
  // the tile's interior edge (and, at an apron edge, the row of zeros beyond)
  const int rm = kBorder && (edges & kTop) && gy == 0 ? r + 1 : max(r - 1, 0);
  const int rp = kBorder && (edges & kBottom) && gy == h - 1 ? r - 1 : min(r + 1, kExt - 1);
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
    ml[j] = kBorder && (edges & kLeft) && gx == 0;
    mr[j] = kBorder && (edges & kRight) && gx == w - 1;
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
                float* __restrict__ v_out, int h, int w, int T, int nit, int edges) {
  // row sums of u in buffers 0 and 1, of v in 2 and 3
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = kExt - 2 * T;
  const int oy = blockIdx.y * tile - T;  // image row of tile row 0
  const int ox = blockIdx.x * tile - T;
  // a tile whose rows and columns 0 .. kExt-1 all lie strictly inside the
  // image: no cell outside it, none on its edge
  if (oy > 0 && ox > 0 && oy + kExt < h && ox + kExt < w)
    hs_tile<false>(fx, fy, ft, alpha, u_in, v_in, u_out, v_out, h, w, T, nit, oy, ox, edges,
                   smem);
  else
    hs_tile<true>(fx, fy, ft, alpha, u_in, v_in, u_out, v_out, h, w, T, nit, oy, ox, edges, smem);
}


// ---------------------------------------------------------------- the resident path

// row sums take at most 64 KB (4 x 4096 cells); the resident launch asks for
// more than half an SM's shared memory, so that no SM holds two of its blocks
constexpr size_t kResidentSmem = 120 * 1024;

struct HsArgs {
  const float* fx;
  const float* fy;
  const float* ft;
  const float* u_in;
  const float* v_in;
  float* u_out;
  float* v_out;
  float* xchg;  // 2 parities x (u, v) x h x w: the published bands
  float alpha;
  int h, w;
  int T;       // the ring's depth
  int nit;     // iterations of the solve
  int round;   // iterations between two exchanges (<= T with more than one tile)
  int core_h, core_w;
  int edges;
};

// One thread's 4 cells of a resident tile of `rows` x kW cells whose row 0
// and column 0 are the image's (oy, ox): tile row r, columns 4s .. 4s + 3;
// the iteration is hs_tile's.  kBorder as for hs_tile.
template <int kRowThreads, bool kBorder>
struct Tile {
  static constexpr int kW = kCells * kRowThreads;
  static_assert(32 % kRowThreads == 0, "a tile row lies in one warp");
  int r, s, gy, gx0, rm, rp, from_left, from_right;
  unsigned bits;  // bit j: cell j inside the image; 4 + j: on its left edge; 8 + j: right
  float u[kCells], v[kCells], cfx[kCells], cfy[kCells], cft[kCells], crd[kCells];

  __device__ __forceinline__ Tile(const HsArgs& a, int rows, int oy, int ox) {
    r = threadIdx.x / kRowThreads;
    s = threadIdx.x % kRowThreads;
    const int lane = threadIdx.x & 31;
    gy = oy + r;
    gx0 = ox + kCells * s;
    rm = kBorder && (a.edges & kTop) && gy == 0 ? r + 1 : max(r - 1, 0);
    rp = kBorder && (a.edges & kBottom) && gy == a.h - 1 ? r - 1 : min(r + 1, rows - 1);
    from_left = s > 0 ? lane - 1 : lane;
    from_right = s < kRowThreads - 1 ? lane + 1 : lane;
    const float a2 = a.alpha * a.alpha;
    bits = 0;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const int gx = gx0 + j;
      if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) bits |= 1u << j;
      if ((a.edges & kLeft) && gx == 0) bits |= 16u << j;
      if ((a.edges & kRight) && gx == a.w - 1) bits |= 256u << j;
      u[j] = v[j] = cfx[j] = cfy[j] = cft[j] = crd[j] = 0.0f;
      if (in(j)) {  // the inputs are read-only for the launch
        const size_t i = at(j, a.w);
        cfx[j] = __ldg(a.fx + i);
        cfy[j] = __ldg(a.fy + i);
        cft[j] = __ldg(a.ft + i);
        crd[j] = 1.0f / ((a2 + cfx[j] * cfx[j]) + cfy[j] * cfy[j]);
        u[j] = __ldg(a.u_in + i);
        v[j] = __ldg(a.v_in + i);
      }
    }
  }

  __device__ __forceinline__ bool in(int j) const { return !kBorder || (bits >> j & 1u); }
  __device__ __forceinline__ size_t at(int j, int w) const { return (size_t)gy * w + gx0 + j; }
  __device__ __forceinline__ bool in_core(int j, const HsArgs& a) const {
    const int c = kCells * s + j;
    return r >= a.T && r < a.T + a.core_h && c >= a.T && c < a.T + a.core_w;
  }

  // one iteration, as hs_tile's; `buf` floats a row-sum buffer (rows x kW)
  __device__ __forceinline__ void step(int it, float* smem, int buf) {
    float* su = smem + (it & 1) * buf;
    float* sv = su + 2 * buf;
    const float ul = __shfl_sync(0xffffffffu, u[kCells - 1], from_left);
    const float ur = __shfl_sync(0xffffffffu, u[0], from_right);
    const float vl = __shfl_sync(0xffffffffu, v[kCells - 1], from_left);
    const float vr = __shfl_sync(0xffffffffu, v[0], from_right);
    float ru[kCells], rv[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      float lu = j == 0 ? (s > 0 ? ul : u[0]) : u[j - 1];
      float xu = j == kCells - 1 ? (s < kRowThreads - 1 ? ur : u[j]) : u[j + 1];
      float lv = j == 0 ? (s > 0 ? vl : v[0]) : v[j - 1];
      float xv = j == kCells - 1 ? (s < kRowThreads - 1 ? vr : v[j]) : v[j + 1];
      if (kBorder && (bits & (16u << j))) lu = xu, lv = xv;   // mirror: column -1 is column 1
      if (kBorder && (bits & (256u << j))) xu = lu, xv = lv;  // column w is column w - 2
      ru[j] = add2x(lu, u[j]) + xu;
      rv[j] = add2x(lv, v[j]) + xv;
    }
    reinterpret_cast<float4*>(su + r * kW)[s] = make_float4(ru[0], ru[1], ru[2], ru[3]);
    reinterpret_cast<float4*>(sv + r * kW)[s] = make_float4(rv[0], rv[1], rv[2], rv[3]);
    __syncthreads();
    const float4 a = reinterpret_cast<const float4*>(su + rm * kW)[s];
    const float4 b = reinterpret_cast<const float4*>(su + rp * kW)[s];
    const float4 c = reinterpret_cast<const float4*>(sv + rm * kW)[s];
    const float4 d = reinterpret_cast<const float4*>(sv + rp * kW)[s];
    const float um[kCells] = {a.x, a.y, a.z, a.w}, up[kCells] = {b.x, b.y, b.z, b.w};
    const float vm[kCells] = {c.x, c.y, c.z, c.w}, vp[kCells] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const float ua = sub4x(add2x(um[j], ru[j]) + up[j], u[j]) * kTwelfth;
      const float va = sub4x(add2x(vm[j], rv[j]) + vp[j], v[j]) * kTwelfth;
      const float der = ((cfx[j] * ua + cfy[j] * va) + cft[j]) * crd[j];
      if (in(j)) {  // cells outside the image are never updated
        u[j] = ua - cfx[j] * der;
        v[j] = va - cfy[j] * der;
      }
    }
  }

  // round k's exchange: publish the core's T-deep band, wait for every tile
  // to publish, read the ring from the neighbours' bands
  __device__ __forceinline__ void exchange(const HsArgs& a, int k) {
    const size_t plane = (size_t)a.h * a.w;
    float* xu = a.xchg + 2 * (k & 1) * plane;
    float* xv = xu + plane;
    const bool row_band = r < 2 * a.T || r >= a.core_h;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const int c = kCells * s + j;
      if (in(j) && in_core(j, a) && (row_band || c < 2 * a.T || c >= a.core_w)) {
        __stcg(xu + at(j, a.w), u[j]);
        __stcg(xv + at(j, a.w), v[j]);
      }
    }
    cg::this_grid().sync();
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (in(j) && !in_core(j, a)) {
        u[j] = __ldcg(xu + at(j, a.w));
        v[j] = __ldcg(xv + at(j, a.w));
      }
    }
  }

  // the core cells that lie inside the image, to the output
  __device__ __forceinline__ void write_core(const HsArgs& a) const {
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (in(j) && in_core(j, a)) {
        a.u_out[at(j, a.w)] = u[j];
        a.v_out[at(j, a.w)] = v[j];
      }
    }
  }
};

template <int kRowThreads, bool kBorder>
__device__ __forceinline__ void solve(const HsArgs& a, int rows, int oy, int ox, float* smem) {
  Tile<kRowThreads, kBorder> t(a, rows, oy, ox);
  const int buf = rows * Tile<kRowThreads, kBorder>::kW;
  int it = 0;
  for (int k = 0;; ++k) {
    const int end = min(it + a.round, a.nit);
    for (; it < end; ++it) t.step(it, smem, buf);
    if (it >= a.nit) break;
    t.exchange(a, k);
  }
  t.write_core(a);
}

// The resident launch: kRowThreads threads a tile row (8 or 16: 32- or
// 64-wide tiles), a row of 4 cells a thread, blockDim / kRowThreads rows.
template <int kRowThreads>
__global__ void __launch_bounds__(kThreads, 1) hs_block_kernel(const HsArgs a) {
  // row sums of u in buffers 0 and 1, of v in 2 and 3
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kW = kCells * kRowThreads;
  const int rows = blockDim.x / kRowThreads;
  const int oy = blockIdx.y * a.core_h - a.T;  // image row of tile row 0
  const int ox = blockIdx.x * a.core_w - a.T;
  if (oy > 0 && ox > 0 && oy + rows < a.h && ox + kW < a.w)
    solve<kRowThreads, false>(a, rows, oy, ox, smem);
  else
    solve<kRowThreads, true>(a, rows, oy, ox, smem);
}

// the SM count of each device (0: not yet read; a device without cooperative
// launch is never cached), read once: the query costs host time
cudaError_t sm_count(int device, int* count) {
  static int sms[kMaxDevices];
  if (!sms[device]) {
    int coop = 0;
    cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *count = sms[device];
  return cudaSuccess;
}

template <int kRowThreads>
cudaError_t launch_resident(const HsArgs& a, dim3 grid, int rows, int device,
                            cudaStream_t stream) {
  const void* kernel = (const void*)hs_block_kernel<kRowThreads>;
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kResidentSmem);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  void* args[] = {(void*)&a};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, grid, dim3(rows * kRowThreads), args,
                                                kResidentSmem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the blocked kernel, by its type: the resident one shares its name
void (*const kBlockedKernel)(const float*, const float*, const float*, float, const float*,
                             const float*, float*, float*, int, int, int, int, int) =
    hs_block_kernel;

}  // namespace

// niter Jacobi iterations from (u0, v0) in the launches of `plan`: nlaunch
// pairs (iterations, destination), destination 0 = (u_out, v_out) and 1 =
// (u_tmp, v_tmp).  Each launch reads the previous one's destination (the
// first reads u0, v0); destinations alternate and the last is 0; each count
// is 1..T.  nlaunch = 0 copies (u0, v0) to the output.  T is the temporal
// block depth, 1..31.  edges: the sides that are the image's border, a mask
// of kTop | kBottom | kLeft | kRight (15: the whole image).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that breaks these
// rules.
extern "C" int ofri_hs_iterate(const float* fx, const float* fy, const float* ft,
                               const float* u0, const float* v0, float alpha, int h, int w,
                               int T, const int* plan, int nlaunch, float* u_out, float* v_out,
                               float* u_tmp, float* v_tmp, int edges, int device,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (h < 2 || w < 2 || T < 1 || T > kMaxT || nlaunch < 0 || edges < 0 || edges > 15)
    return cudaErrorInvalidValue;
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
    err = cudaFuncSetAttribute(kBlockedKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
                                                            w, T, plan[2 * k], edges);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    su = du;
    sv = dv;
  }
  return cudaSuccess;
}

// The resident path: niter Jacobi iterations from (u0, v0) into (u_out,
// v_out) in one cooperative launch of grid_y x grid_x tiles, each of
// core_h x (4 * strips - 2T) output cells inside a T-deep ring (strips 8 or
// 16, core_h + 2T rows, at most 1024 threads), the grid covering the image
// with no empty row or column of tiles and at most one tile an SM.  With more
// than one tile, the tiles exchange their bands every `round` iterations
// (1..T), T is at most the core's height where grid_y > 1 and its width where
// grid_x > 1, and xchg holds 4 * h * w floats.  round >= 1.  edges as above.
// Returns cudaErrorInvalidValue for arguments that break these rules,
// cudaErrorNotSupported on a device without cooperative launch, else the
// launch's error.
extern "C" int ofri_hs_iterate_resident(const float* fx, const float* fy, const float* ft,
                                        const float* u0, const float* v0, float alpha, int h,
                                        int w, int strips, int T, int core_h, int grid_y,
                                        int grid_x, int niter, int round, float* u_out,
                                        float* v_out, float* xchg, int edges, int device,
                                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int core_w = kCells * strips - 2 * T;
  const int rows = core_h + 2 * T;
  const int tiles = grid_y * grid_x;
  if (h < 2 || w < 2 || (strips != 8 && strips != 16) || T < 1 || core_w < 1 || core_h < 1 ||
      rows * strips > kThreads || rows * strips % 32 || niter < 0 || round < 1 || edges < 0 ||
      edges > 15 || grid_y < 1 || grid_x < 1 || (grid_y - 1) * core_h >= h || grid_y * core_h < h ||
      (grid_x - 1) * core_w >= w || grid_x * core_w < w)
    return cudaErrorInvalidValue;
  if (tiles > 1 && (round > T || (grid_y > 1 && T > core_h) || (grid_x > 1 && T > core_w)))
    return cudaErrorInvalidValue;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  if (tiles > sms) return cudaErrorInvalidValue;
  const HsArgs a{fx, fy, ft, u0, v0, u_out, v_out, xchg, alpha, h, w, T, niter, round, core_h,
                 core_w, edges};
  const dim3 grid(grid_x, grid_y);
  return strips == 8 ? launch_resident<8>(a, grid, rows, device, stream)
                     : launch_resident<16>(a, grid, rows, device, stream);
}
