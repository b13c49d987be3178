// Masked 7-point stiffness stencil apply, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of generative_physics_informed_pde_tpu/ops/stencil.py
// (_make_kernel, launched through pl.pallas_call by apply_stencil):
//
//   out[y,x,b] = mask[y,x] * sum_{k<7} coefs[k,y,x,b] * v[y+oy_k, x+ox_k, b]
//
// on batch-last arrays, with v read as zero outside the (Ny, Nx) node grid.
// The offsets (oy, ox) are fem/assembly.py's _OFFSETS, in that order:
// (0,0) (1,0) (-1,0) (0,1) (0,-1) (1,1) (-1,-1).
//
// Bound on the H100: memory.  Each output costs 7 multiplies, 7 adds and the
// mask multiply against 7 coefficient reads, one v read and one write (36
// bytes in f32): about 0.4 flop/byte, far below the card's f32 balance of
// ~20 flop/byte.  One apply must read 8 grids (7 coefficient grids and v)
// plus the mask and write one grid; at the highres32 label shape
// (33 x 33 x 1024, f32, 4.46 MB a grid) that is 40 MB, or 12 us at 3.35 TB/s.
// At the V-cycle's coarse levels (5^2-17^2 nodes) an apply moves 0.1-12 MB
// and its time is launch and memory latency, not bandwidth.
//
// Design (ops/stencil.py launch_plan gives the geometry per shape): a block
// owns a tile of nodes (2 x 2, one on the coarsest grids) for one chunk of
// the batch (512 bytes); the chunks of a tile go to adjacent blocks, so the
// card streams each grid in address order.  A thread owns one batch entry
// of one node at a time and issues all fourteen loads of its output at
// once: the seven coefficients, read once, as evict-first streaming loads;
// v at the node and its six neighbours through L1, where the other threads
// of the tile read the same lines.  Measured on the card (PERF.md), staging
// v with a halo into shared memory lost to these direct loads at every
// main-path shape, and 16-byte loads lost to scalar ones (fewer threads for
// the same fourteen loads), so K1 stages nothing and loads scalars only:
// its plans have vec = 1 and check_plan refuses any other.
// The sum runs in _OFFSETS order from +0 with round-to-nearest multiplies
// and adds that are never contracted into fused multiply-adds, and a
// neighbour outside the grid contributes c * 0 as the plain version's zero
// padding does; so the result equals apply_stencil_reference bit for bit,
// signed zeros and inf * 0 = NaN included.
//
// bfloat16 (the V-cycle's levels under precond_dtype="bfloat16"): the
// coefficients, v and the mask are loaded as bf16 and widened to f32, which
// is exact; the seven products, the sums and the mask product run in f32 in
// the order above, without fused multiply-adds, and the result is rounded
// once, to nearest even, at the store.  apply_stencil_reference upcasts,
// sums and rounds the same way, so the two agree bit for bit (a NaN's
// payload aside).  The Pallas kernel instead accumulates in the output
// dtype, rounding at every step; one rounding is at least as accurate and
// costs nothing on an apply bound by memory, whose bytes halve against f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "stencil_tile.cuh"
#include "vcycle.cuh"

namespace {

using namespace gpipde;

// An element as stored (S) and as summed (A).  f32 and f64 are summed in
// their own type; bf16 is stored as its 16 bits and summed in f32.
template <typename T>
struct Elem {
  using S = T;
  using A = T;
  static __device__ __forceinline__ A stream(const S* p) { return __ldcs(p); }
  static __device__ __forceinline__ A cached(const S* p, bool in_grid) {
    return ld_cached<T, 1>(p, in_grid).e[0];
  }
  static __device__ __forceinline__ void store(S* p, A x) { __stcs(p, x); }
};

struct Bf16 {};

template <>
struct Elem<Bf16> {
  using S = unsigned short;
  using A = float;
  static __device__ __forceinline__ A widen(unsigned short u) {
    return __uint_as_float(static_cast<unsigned>(u) << 16);
  }
  static __device__ __forceinline__ A stream(const S* p) { return widen(__ldcs(p)); }
  static __device__ __forceinline__ A cached(const S* p, bool in_grid) {
    return in_grid ? widen(__ldg(p)) : 0.0f;
  }
  static __device__ __forceinline__ void store(S* p, A x) {
    __stcs(p, __bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
apply_stencil_kernel(const typename Elem<T>::S* __restrict__ coefs,
                     const typename Elem<T>::S* __restrict__ v,
                     const typename Elem<T>::S* __restrict__ mask,
                     typename Elem<T>::S* __restrict__ out, int Ny, int Nx, int B, Plan p) {
  using E = Elem<T>;
  using A = typename E::A;
  const Item it = item_of(Ny, Nx, p);
  const Lanes ln = lanes_of<1>(p.chunk);
  const int b = it.b0 + ln.lane;
  if (b >= B) return;
  const ptrdiff_t plane = static_cast<ptrdiff_t>(Ny) * Nx * B;
  const ptrdiff_t row = static_cast<ptrdiff_t>(Nx) * B;
  for (NodeWalk nw(ln.slot, ln.slots, it.w); nw.ly < it.h; nw.next()) {
    const int y = it.y0 + nw.ly, x = it.x0 + nw.lx;
    const int node = y * Nx + x;
    const ptrdiff_t i = static_cast<ptrdiff_t>(node) * B + b;
    const bool n_ = y + 1 < Ny, s_ = y > 0, e_ = x + 1 < Nx, w_ = x > 0;
    A c[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) c[q] = E::stream(coefs + q * plane + i);
    const A u[7] = {E::cached(v + i, true),                 // ( 0, 0)
                    E::cached(v + i + row, n_),             // ( 1, 0)
                    E::cached(v + i - row, s_),             // (-1, 0)
                    E::cached(v + i + B, e_),               // ( 0, 1)
                    E::cached(v + i - B, w_),               // ( 0,-1)
                    E::cached(v + i + row + B, n_ && e_),   // ( 1, 1)
                    E::cached(v + i - row - B, s_ && w_)};  // (-1,-1)
    const A m = E::cached(mask + node, true);
    A acc = A(0);
#pragma unroll
    for (int q = 0; q < 7; ++q) acc = add_rn(acc, mul_rn(c[q], u[q]));
    E::store(out + i, mul_rn(m, acc));
  }
}

template <typename T>
int launch(const void* coefs, const void* v, const void* mask, void* out,
           int Ny, int Nx, int B, const int* plan, int device, void* stream) {
  using S = typename Elem<T>::S;
  Plan p;
  int err = check_plan(plan, Ny, Nx, B, sizeof(S), false, &p);
  if (err == 0) err = use_device(device);
  if (err != 0) return err;
  apply_stencil_kernel<T><<<grid_of(p), p.threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(coefs), static_cast<const S*>(v), static_cast<const S*>(mask),
      static_cast<S*>(out), Ny, Nx, B, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: device pointers, sizes, the launch plan
// (ops/stencil.py LaunchPlan.as_ints()), the device index and the caller's
// stream.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int gpipde_apply_stencil_f32(const void* coefs, const void* v,
                                        const void* mask, void* out, int Ny,
                                        int Nx, int B, const int* plan,
                                        int device, void* stream) {
  return launch<float>(coefs, v, mask, out, Ny, Nx, B, plan, device, stream);
}

extern "C" int gpipde_apply_stencil_f64(const void* coefs, const void* v,
                                        const void* mask, void* out, int Ny,
                                        int Nx, int B, const int* plan,
                                        int device, void* stream) {
  return launch<double>(coefs, v, mask, out, Ny, Nx, B, plan, device, stream);
}

extern "C" int gpipde_apply_stencil_bf16(const void* coefs, const void* v,
                                         const void* mask, void* out, int Ny,
                                         int Nx, int B, const int* plan,
                                         int device, void* stream) {
  return launch<Bf16>(coefs, v, mask, out, Ny, Nx, B, plan, device, stream);
}
