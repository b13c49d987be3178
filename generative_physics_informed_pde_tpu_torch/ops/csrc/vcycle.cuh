// The multigrid V-cycle's steps, each fused into one kernel, hand-written
// for Hopper (sm_90a).  Included by stencil.cu, so they are built into K1's
// library by the same nvcc process.
//
// Replaces no TPU kernel: the JAX package writes its V-cycle
// (generative_physics_informed_pde_tpu/fem/multigrid.py, MultigridPreconditioner.apply)
// in XLA operations and leaves their fusion to XLA.  Written out in PyTorch,
// one damped-Jacobi sweep was one K1 launch and four elementwise launches,
// each reading or writing whole fields, and the residual, restriction and
// prolongation were written out likewise.  Here one level of the V-cycle
// above the coarsest is four launches and the coarsest level one, in the
// order of fem/multigrid.py's vcycle:
//
//   presmooth  z = S(S(0)), the first sweep z1 = w D^-1 r formed on the fly
//   restrict   rc = cmask * R(mask * (r - K z)); the fine residual stays on chip
//   correct    z = S(z + mask * P(ec)), the corrected z formed on the fly
//   smooth     z = S(z)
//   coarse     z = S^nu(0) on the coarsest grid, every sweep in one launch
//
// with S(z) = z + w D^-1 (r - K z), K z = mask * sum_k coefs[k] z[+o_k]
// (K1's apply, zero outside the grid), D^-1 = mask / (coefs[0] <= 0 ? 1 :
// coefs[0]) formed from the coefficients in the kernel (the levels store
// none), P the linear interpolation along the triangulation's diagonal
// (fem/multigrid.py _prolong) and R its transpose (_restrict).
//
// Bound on the H100: memory.  A sweep reads the 7 coefficient grids, r and
// z and writes z (about 1 flop a byte), so the only gain is to move fewer
// bytes: the written-out finest level moved ~100 fields a cycle, these
// kernels ~40 (7 coefficient grids, r, z and the output each, about once).
//
// Design (ops/vcycle.py vcycle_plan gives the geometry per shape; K1's
// Plan, checked by check_plan): a block owns a tile of output nodes for one
// chunk of the batch (128 bytes of the summed type); a thread owns one
// batch entry of a node at a time.  Phase 1 stages the sweep's input on the
// tile and its one-node halo in shared memory -- z1, z or the corrected z,
// each computed once per node -- and phase 2 sums the stencil from there,
// streaming the coefficients once (evict first).  restrict stages z on the
// fine nodes its coarse tile gathers from (two-node halo), forms the masked
// residual there in shared memory, and restricts it.  coarse keeps its
// batch slice's whole grid on chip for all sweeps: z in shared memory (two
// buffers), each thread's first kNodeRegs nodes' coefficients, r and w D^-1
// in registers; a grid too large for 48 KB at one batch entry a block puts
// its two z buffers in a scratch array the wrapper allocates.  Loads are
// scalar (as K1's).  Nothing is timed or tuned at run time, and the kernels
// allocate nothing.
//
// Arithmetic: every value in the order of the plain versions
// (ops/vcycle.py), round-to-nearest, never contracted into fused
// multiply-adds, so in float32 and float64 the kernels equal their plain
// versions bit for bit.  bfloat16: loads are widened to f32 (exact), all
// arithmetic runs in f32, and each stored value is rounded once, to nearest
// even; the values that stay on chip (z1, the residual, the corrected z,
// the coarse sweeps' z) are never rounded.  The plain versions upcast,
// compute and round the same way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "stencil_tile.cuh"

namespace gpipde {
namespace vcycle {

enum Step { kPresmooth = 0, kRestrict = 1, kCorrect = 2, kSmooth = 3, kCoarse = 4 };

constexpr int kNodeRegs = 4;              // coarse: nodes a thread keeps in registers
constexpr size_t kSharedBytes = 48 * 1024;  // no opt-in beyond the default

struct Bf16 {};

// An element as stored (S) and as summed (A), as K1's Elem in stencil.cu.
template <typename T>
struct Val {
  using S = T;
  using A = T;
  static __device__ __forceinline__ A ld(const S* p) { return __ldg(p); }
  static __device__ __forceinline__ A stream(const S* p) { return __ldcs(p); }
  static __device__ __forceinline__ void store(S* p, A x) { __stcs(p, x); }
};

template <>
struct Val<Bf16> {
  using S = unsigned short;
  using A = float;
  static __device__ __forceinline__ A widen(unsigned short u) {
    return __uint_as_float(static_cast<unsigned>(u) << 16);
  }
  static __device__ __forceinline__ A ld(const S* p) { return widen(__ldg(p)); }
  static __device__ __forceinline__ A stream(const S* p) { return widen(__ldcs(p)); }
  static __device__ __forceinline__ void store(S* p, A x) {
    __stcs(p, __bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
};

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// w D^-1 at a node: omega * (m / (d <= 0 ? 1 : d)).
template <typename A>
__device__ __forceinline__ A weight(A omega, A m, A d) {
  return mul_rn(omega, div_rn(m, d <= A(0) ? A(1) : d));
}

extern __shared__ __align__(16) unsigned char vcycle_smem[];

// A block's output tile and a thread's batch entry (live: inside B).
struct Tile {
  int y0, h, x0, w, b, lane, slot, slots, chunk;
  bool live;
};

__device__ __forceinline__ Tile tile_of(int Ny, int Nx, int B, const Plan& p) {
  const Item it = item_of(Ny, Nx, p);
  const Lanes ln = lanes_of<1>(p.chunk);
  const int b = it.b0 + ln.lane;
  return {it.y0, it.h, it.x0, it.w, b, ln.lane, ln.slot, ln.slots, p.chunk, b < B};
}

// Fill the region [y0, y0 + h) x [x0, x0 + w) of grid nodes of the staged
// buffer s (w nodes a row, chunk entries a node) with f(y, x), and with 0
// outside the Ny x Nx grid (the plain version's zero padding).
template <typename A, typename F>
__device__ __forceinline__ void stage(A* s, const Tile& t, int y0, int h, int x0, int w, int Ny,
                                      int Nx, F f) {
  for (NodeWalk nw(t.slot, t.slots, w); nw.ly < h; nw.next()) {
    const int y = y0 + nw.ly, x = x0 + nw.lx;
    A v = A(0);
    if (t.live && y >= 0 && y < Ny && x >= 0 && x < Nx) v = f(y, x);
    s[(nw.ly * w + nw.lx) * t.chunk + t.lane] = v;
  }
}

// sum_k coefs[k] u[+o_k] from +0, in fem/assembly.py _OFFSETS order:
// (0,0) (1,0) (-1,0) (0,1) (0,-1) (1,1) (-1,-1); u[q] its seven values.
template <typename A>
__device__ __forceinline__ A stencil_sum(const A (&c)[7], const A (&u)[7]) {
  A acc = A(0);
#pragma unroll
  for (int q = 0; q < 7; ++q) acc = add_rn(acc, mul_rn(c[q], u[q]));
  return acc;
}

// The seven values around a node of a staged buffer: s at the node, rows
// `row` entries apart, columns `col` entries apart.
template <typename A>
__device__ __forceinline__ void around(const A* s, int row, int col, A (&u)[7]) {
  u[0] = s[0];
  u[1] = s[row];
  u[2] = s[-row];
  u[3] = s[col];
  u[4] = s[-col];
  u[5] = s[row + col];
  u[6] = s[-row - col];
}

template <typename T>
__device__ __forceinline__ void load_coefs(const typename Val<T>::S* coefs, ptrdiff_t plane,
                                           ptrdiff_t i, typename Val<T>::A (&c)[7]) {
#pragma unroll
  for (int q = 0; q < 7; ++q) c[q] = Val<T>::stream(coefs + q * plane + i);
}

// S(z) at one node: z + w D^-1 (r - m sum), z = u[0].
template <typename A>
__device__ __forceinline__ A sweep(const A (&c)[7], const A (&u)[7], A r, A m, A omega) {
  return add_rn(u[0], mul_rn(weight(omega, m, c[0]), sub_rn(r, mul_rn(m, stencil_sum(c, u)))));
}

// Phase 2 of presmooth, correct and smooth: S of the input staged on the
// tile and its halo (region width tile width + 2), or the input itself
// where `sweeps` is 0.
template <typename T>
__device__ __forceinline__ void sweep_tile(const typename Val<T>::S* __restrict__ coefs,
                                           const typename Val<T>::S* __restrict__ mask,
                                           const typename Val<T>::S* __restrict__ r,
                                           typename Val<T>::S* __restrict__ out,
                                           const typename Val<T>::A* s, const Tile& t, int Ny,
                                           int Nx, int B, typename Val<T>::A omega, int sweeps) {
  using E = Val<T>;
  using A = typename E::A;
  const ptrdiff_t plane = static_cast<ptrdiff_t>(Ny) * Nx * B;
  const int rw = t.w + 2;
  for (NodeWalk nw(t.slot, t.slots, t.w); nw.ly < t.h; nw.next()) {
    const int node = (t.y0 + nw.ly) * Nx + t.x0 + nw.lx;
    const ptrdiff_t i = static_cast<ptrdiff_t>(node) * B + t.b;
    const A* sn = s + ((nw.ly + 1) * rw + nw.lx + 1) * t.chunk + t.lane;
    A z = sn[0];
    if (sweeps > 0) {
      A c[7], u[7];
      load_coefs<T>(coefs, plane, i, c);
      around(sn, rw * t.chunk, t.chunk, u);
      z = sweep(c, u, E::ld(r + i), E::ld(mask + node), omega);
    }
    E::store(out + i, z);
  }
}

// presmooth: sweeps (0, 1 or 2) sweeps from zero; the first, w D^-1 r, is
// staged on the tile and its halo.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mg_presmooth_kernel(const typename Val<T>::S* __restrict__ coefs,
                    const typename Val<T>::S* __restrict__ mask,
                    const typename Val<T>::S* __restrict__ r, typename Val<T>::S* __restrict__ out,
                    int Ny, int Nx, int B, typename Val<T>::A omega, int sweeps, Plan p) {
  using E = Val<T>;
  using A = typename E::A;
  const Tile t = tile_of(Ny, Nx, B, p);
  A* s = reinterpret_cast<A*>(vcycle_smem);
  stage(s, t, t.y0 - 1, t.h + 2, t.x0 - 1, t.w + 2, Ny, Nx, [&](int y, int x) {
    const int node = y * Nx + x;
    const ptrdiff_t i = static_cast<ptrdiff_t>(node) * B + t.b;
    return sweeps == 0 ? A(0)
                       : mul_rn(weight(omega, E::ld(mask + node), E::ld(coefs + i)), E::ld(r + i));
  });
  __syncthreads();
  if (!t.live) return;
  sweep_tile<T>(coefs, mask, r, out, s, t, Ny, Nx, B, omega, sweeps - 1);
}

// restrict: the tile is of coarse nodes ((Ny+1)/2 x (Nx+1)/2); z is staged
// on the fine nodes two around the ones they gather from, the masked
// residual on those fine nodes, then each coarse node sums its seven.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mg_restrict_kernel(const typename Val<T>::S* __restrict__ coefs,
                   const typename Val<T>::S* __restrict__ mask,
                   const typename Val<T>::S* __restrict__ r, const typename Val<T>::S* __restrict__ z,
                   const typename Val<T>::S* __restrict__ cmask,
                   typename Val<T>::S* __restrict__ out, int Ny, int Nx, int B, Plan p) {
  using E = Val<T>;
  using A = typename E::A;
  const int Nxc = (Nx + 1) / 2, Nyc = (Ny + 1) / 2;
  const Tile t = tile_of(Nyc, Nxc, B, p);
  const int zy0 = 2 * t.y0 - 2, zx0 = 2 * t.x0 - 2, zh = 2 * t.h + 3, zw = 2 * t.w + 3;
  const int qh = 2 * t.h + 1, qw = 2 * t.w + 1;  // residual region, from (zy0 + 1, zx0 + 1)
  A* sz = reinterpret_cast<A*>(vcycle_smem);
  A* sq = sz + zh * zw * t.chunk;
  const ptrdiff_t plane = static_cast<ptrdiff_t>(Ny) * Nx * B;
  stage(sz, t, zy0, zh, zx0, zw, Ny, Nx, [&](int y, int x) {
    return E::ld(z + static_cast<ptrdiff_t>(y * Nx + x) * B + t.b);
  });
  __syncthreads();
  stage(sq, t, zy0 + 1, qh, zx0 + 1, qw, Ny, Nx, [&](int y, int x) {
    const int node = y * Nx + x;
    const ptrdiff_t i = static_cast<ptrdiff_t>(node) * B + t.b;
    A c[7], u[7];
    load_coefs<T>(coefs, plane, i, c);
    around(sz + ((y - zy0) * zw + x - zx0) * t.chunk + t.lane, zw * t.chunk, t.chunk, u);
    const A m = E::ld(mask + node);
    return mul_rn(m, sub_rn(E::ld(r + i), mul_rn(m, stencil_sum(c, u))));
  });
  __syncthreads();
  if (!t.live) return;
  const int row = qw * t.chunk, col = t.chunk;
  for (NodeWalk nw(t.slot, t.slots, t.w); nw.ly < t.h; nw.next()) {
    const int node = (t.y0 + nw.ly) * Nxc + t.x0 + nw.lx;
    const A* q = sq + ((2 * nw.ly + 1) * qw + 2 * nw.lx + 1) * t.chunk + t.lane;
    // W, E, S, N, SW, NE, as _restrict sums them
    const A sum = add_rn(add_rn(add_rn(add_rn(add_rn(q[-col], q[col]), q[-row]), q[row]),
                                q[-row - col]),
                         q[row + col]);
    const A v = add_rn(q[0], mul_rn(A(0.5), sum));
    E::store(out + static_cast<ptrdiff_t>(node) * B + t.b, mul_rn(E::ld(cmask + node), v));
  }
}

// correct: z + mask * P(ec) staged on the tile and its halo, then sweeps
// (0 or 1) sweeps.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mg_correct_kernel(const typename Val<T>::S* __restrict__ coefs,
                  const typename Val<T>::S* __restrict__ mask,
                  const typename Val<T>::S* __restrict__ r, const typename Val<T>::S* __restrict__ z,
                  const typename Val<T>::S* __restrict__ ec, typename Val<T>::S* __restrict__ out,
                  int Ny, int Nx, int B, typename Val<T>::A omega, int sweeps, Plan p) {
  using E = Val<T>;
  using A = typename E::A;
  const Tile t = tile_of(Ny, Nx, B, p);
  const int Nxc = (Nx + 1) / 2;
  A* s = reinterpret_cast<A*>(vcycle_smem);
  stage(s, t, t.y0 - 1, t.h + 2, t.x0 - 1, t.w + 2, Ny, Nx, [&](int y, int x) {
    const int node = y * Nx + x;
    const ptrdiff_t row = static_cast<ptrdiff_t>(Nxc) * B;
    const typename E::S* e = ec + static_cast<ptrdiff_t>((y >> 1) * Nxc + (x >> 1)) * B + t.b;
    A pe = E::ld(e);
    if (y & 1) {
      pe = mul_rn(A(0.5), add_rn(pe, E::ld(e + ((x & 1) ? row + B : row))));
    } else if (x & 1) {
      pe = mul_rn(A(0.5), add_rn(pe, E::ld(e + B)));
    }
    return add_rn(E::ld(z + static_cast<ptrdiff_t>(node) * B + t.b), mul_rn(E::ld(mask + node), pe));
  });
  __syncthreads();
  if (!t.live) return;
  sweep_tile<T>(coefs, mask, r, out, s, t, Ny, Nx, B, omega, sweeps);
}

// smooth: one sweep of z staged on the tile and its halo.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mg_smooth_kernel(const typename Val<T>::S* __restrict__ coefs,
                 const typename Val<T>::S* __restrict__ mask,
                 const typename Val<T>::S* __restrict__ r, const typename Val<T>::S* __restrict__ z,
                 typename Val<T>::S* __restrict__ out, int Ny, int Nx, int B,
                 typename Val<T>::A omega, Plan p) {
  using E = Val<T>;
  using A = typename E::A;
  const Tile t = tile_of(Ny, Nx, B, p);
  A* s = reinterpret_cast<A*>(vcycle_smem);
  stage(s, t, t.y0 - 1, t.h + 2, t.x0 - 1, t.w + 2, Ny, Nx, [&](int y, int x) {
    return E::ld(z + static_cast<ptrdiff_t>(y * Nx + x) * B + t.b);
  });
  __syncthreads();
  if (!t.live) return;
  sweep_tile<T>(coefs, mask, r, out, s, t, Ny, Nx, B, omega, 1);
}

// The seven values of z around node (y, x) from a buffer of the whole grid
// (entry n * ns of node n), 0 outside the grid.
template <typename A>
__device__ __forceinline__ void around_grid(const A* zc, int y, int x, int Ny, int Nx,
                                            ptrdiff_t ns, A (&u)[7]) {
  const ptrdiff_t row = Nx * ns;
  const A* s = zc + (static_cast<ptrdiff_t>(y) * Nx + x) * ns;
  const bool n_ = y + 1 < Ny, s_ = y > 0, e_ = x + 1 < Nx, w_ = x > 0;
  u[0] = s[0];
  u[1] = n_ ? s[row] : A(0);
  u[2] = s_ ? s[-row] : A(0);
  u[3] = e_ ? s[ns] : A(0);
  u[4] = w_ ? s[-ns] : A(0);
  u[5] = n_ && e_ ? s[row + ns] : A(0);
  u[6] = s_ && w_ ? s[-row - ns] : A(0);
}

// coarse: `sweeps` sweeps from zero on the whole grid of a chunk of the
// batch, z ping-ponged between two buffers (shared memory, or `scratch`
// (2, Ny, Nx, B) in the summed type where the wrapper passes one).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mg_coarse_kernel(const typename Val<T>::S* __restrict__ coefs,
                 const typename Val<T>::S* __restrict__ mask,
                 const typename Val<T>::S* __restrict__ r, typename Val<T>::S* __restrict__ out,
                 typename Val<T>::A* scratch, int Ny, int Nx, int B, typename Val<T>::A omega,
                 int sweeps, Plan p) {
  using E = Val<T>;
  using A = typename E::A;
  const Tile t = tile_of(Ny, Nx, B, p);
  const int nodes = Ny * Nx;
  const ptrdiff_t plane = static_cast<ptrdiff_t>(nodes) * B;
  // entry of node n, buffer k: zb[k * buf + n * ns]
  A* zb;
  ptrdiff_t ns, buf;
  if (scratch != nullptr) {
    zb = scratch + t.b;
    ns = B;
    buf = plane;
  } else {
    zb = reinterpret_cast<A*>(vcycle_smem) + t.lane;
    ns = t.chunk;
    buf = static_cast<ptrdiff_t>(nodes) * t.chunk;
  }
  A c[kNodeRegs][7], rr[kNodeRegs], mm[kNodeRegs];
#pragma unroll
  for (int j = 0; j < kNodeRegs; ++j) {
    const int n = t.slot + j * t.slots;
    if (t.live && n < nodes) {
      const ptrdiff_t i = static_cast<ptrdiff_t>(n) * B + t.b;
      load_coefs<T>(coefs, plane, i, c[j]);
      rr[j] = E::ld(r + i);
      mm[j] = E::ld(mask + n);
    }
  }
  if (t.live)
    for (int n = t.slot; n < nodes; n += t.slots) zb[n * ns] = A(0);
  __syncthreads();
  int cur = 0;
  for (int k = 0; k < sweeps; ++k) {
    const A* zc = zb + cur * buf;
    A* zn = zb + (1 - cur) * buf;
    if (t.live) {
#pragma unroll
      for (int j = 0; j < kNodeRegs; ++j) {
        const int n = t.slot + j * t.slots;
        if (n < nodes) {
          A u[7];
          around_grid(zc, n / Nx, n % Nx, Ny, Nx, ns, u);
          zn[n * ns] = sweep(c[j], u, rr[j], mm[j], omega);
        }
      }
      for (int n = t.slot + kNodeRegs * t.slots; n < nodes; n += t.slots) {
        const ptrdiff_t i = static_cast<ptrdiff_t>(n) * B + t.b;
        A cn[7], u[7];
#pragma unroll
        for (int q = 0; q < 7; ++q) cn[q] = E::ld(coefs + q * plane + i);
        around_grid(zc, n / Nx, n % Nx, Ny, Nx, ns, u);
        zn[n * ns] = sweep(cn, u, E::ld(r + i), E::ld(mask + n), omega);
      }
    }
    __syncthreads();
    cur = 1 - cur;
  }
  if (!t.live) return;
  for (int n = t.slot; n < nodes; n += t.slots)
    E::store(out + static_cast<ptrdiff_t>(n) * B + t.b, zb[cur * buf + n * ns]);
}

// Shared memory of a launch, in bytes.
inline size_t shared_bytes(int step, const Plan& p, int Ny, int Nx, size_t acc, bool scratch) {
  const size_t per_node = static_cast<size_t>(p.chunk) * acc;
  const size_t h = p.tile_rows, w = p.tile_cols;
  switch (step) {
    case kRestrict:
      return ((2 * h + 3) * (2 * w + 3) + (2 * h + 1) * (2 * w + 1)) * per_node;
    case kCoarse:
      return scratch ? 0 : 2 * static_cast<size_t>(Ny) * Nx * per_node;
    default:
      return (h + 2) * (w + 2) * per_node;
  }
}

template <typename T>
int launch(int step, const void* coefs, const void* mask, const void* r, const void* z,
           const void* aux, void* out, void* scratch, int Ny, int Nx, int B, double omega,
           int sweeps, const int* plan, int device, void* stream) {
  using E = Val<T>;
  using S = typename E::S;
  using A = typename E::A;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (step < kPresmooth || step > kCoarse || sweeps < 0 || Ny <= 0 || Nx <= 0) return bad;
  const bool transfer = step == kRestrict || step == kCorrect;
  if (transfer && (Ny % 2 == 0 || Nx % 2 == 0 || Ny < 3 || Nx < 3)) return bad;
  if ((step == kPresmooth && sweeps > 2) || (step == kCorrect && sweeps > 1)) return bad;
  if (scratch != nullptr && step != kCoarse) return bad;
  const int gy = step == kRestrict ? (Ny + 1) / 2 : Ny;
  const int gx = step == kRestrict ? (Nx + 1) / 2 : Nx;
  Plan p;
  int err = check_plan(plan, gy, gx, B, sizeof(S), false, &p);
  if (err != 0) return err;
  if (step == kCoarse && (p.tiles_y != 1 || p.tiles_x != 1)) return bad;
  const size_t shm = shared_bytes(step, p, Ny, Nx, sizeof(A), scratch != nullptr);
  if (shm > kSharedBytes) return bad;
  err = use_device(device);
  if (err != 0) return err;
  const dim3 g = grid_of(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const A w = static_cast<A>(omega);
  const S* c = static_cast<const S*>(coefs);
  const S* m = static_cast<const S*>(mask);
  const S* rv = static_cast<const S*>(r);
  const S* zv = static_cast<const S*>(z);
  const S* xv = static_cast<const S*>(aux);
  S* o = static_cast<S*>(out);
  switch (step) {
    case kPresmooth:
      mg_presmooth_kernel<T><<<g, p.threads, shm, st>>>(c, m, rv, o, Ny, Nx, B, w, sweeps, p);
      break;
    case kRestrict:
      mg_restrict_kernel<T><<<g, p.threads, shm, st>>>(c, m, rv, zv, xv, o, Ny, Nx, B, p);
      break;
    case kCorrect:
      mg_correct_kernel<T><<<g, p.threads, shm, st>>>(c, m, rv, zv, xv, o, Ny, Nx, B, w, sweeps, p);
      break;
    case kSmooth:
      mg_smooth_kernel<T><<<g, p.threads, shm, st>>>(c, m, rv, zv, o, Ny, Nx, B, w, p);
      break;
    default:
      mg_coarse_kernel<T><<<g, p.threads, shm, st>>>(c, m, rv, o, static_cast<A*>(scratch), Ny, Nx,
                                                     B, w, sweeps, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vcycle
}  // namespace gpipde

// Plain C interface for ctypes (ops/vcycle.py): the step (Step above), the
// level's coefficients (7, Ny, Nx, B), mask (Ny, Nx, 1), r and z (Ny, Nx,
// B; z unused by presmooth and coarse), aux (restrict: the coarse mask
// ((Ny+1)/2, (Nx+1)/2, 1); correct: the coarse correction ((Ny+1)/2,
// (Nx+1)/2, B)), the output, the coarse step's scratch or null, the fine
// sizes, omega, the sweeps, the launch plan (LaunchPlan.as_ints(), over the
// coarse grid for restrict), the device index and the caller's stream.
// Returns the cudaError_t of the launch (0 = launched).
#define GPIPDE_VCYCLE_ENTRY(SUFFIX, TYPE)                                                         \
  extern "C" int gpipde_vcycle_##SUFFIX(int step, const void* coefs, const void* mask,           \
                                        const void* r, const void* z, const void* aux, void* out, \
                                        void* scratch, int Ny, int Nx, int B, double omega,       \
                                        int sweeps, const int* plan, int device, void* stream) {  \
    return gpipde::vcycle::launch<TYPE>(step, coefs, mask, r, z, aux, out, scratch, Ny, Nx, B,    \
                                        omega, sweeps, plan, device, stream);                    \
  }

GPIPDE_VCYCLE_ENTRY(f32, float)
GPIPDE_VCYCLE_ENTRY(f64, double)
GPIPDE_VCYCLE_ENTRY(bf16, gpipde::vcycle::Bf16)

#undef GPIPDE_VCYCLE_ENTRY
