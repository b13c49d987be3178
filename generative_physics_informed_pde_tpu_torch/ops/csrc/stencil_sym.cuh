// The symmetric-form (4-grid) stencil kernel body that K2 (stencil_sym.cu)
// and K3 (stencil_sym_blocked.cu) both instantiate, and their launch.  The
// two differ only where their contracts do, by the compile-time flag
// `Padded`:
//
//   K2 (Padded = false): an (Ny, Nx) node grid; v and the coefficient grids
//     are read as zero outside it (guarded loads), v is used as it is.
//   K3 (Padded = true): an (R, C) grid halo-padded by one node on each side;
//     every neighbour of an interior node is a valid address, so no load is
//     guarded; each v value read is first multiplied by its node's mask
//     (the kernel masks its own input); halo nodes store zeros.
//
// For every node computed, with u = v (K2) or u = v * mask (K3, per node):
//
//   out[y,x,b] = mask[y,x] * ( c0[y,x,b] * u[y,x,b]
//       + sum_{dir in _SYM_DIRS} ( c_dir[y,x,b]       * u[y+oy, x+ox, b]
//                                + c_dir[y-oy,x-ox,b] * u[y-oy, x-ox, b] ) )
//
// _SYM_DIRS = (1,0) (0,1) (1,1).  A block owns a tile of nodes for one chunk
// of the batch (ops/stencil.py launch_plan); each direction grid is read at
// two nodes per output and v (and K3's mask) at seven, so those reads hit
// lines the tile's threads share in L1, and a thread issues its loads at
// once (16 bytes a load where the batch row allows).  c0, read once,
// streams with evict-first loads.  The sum runs in the plain versions'
// order (c0*u, then per dir the +dir term and the -dir term) with
// round-to-nearest multiplies and adds that are never contracted into fused
// multiply-adds.  K2's out-of-grid terms are added as c * 0 and 0 * 0 from
// zero loads, as the plain version's zero padding does; K3 multiplies every
// term, its halo's too, as its plain version does.  So each equals its
// plain version bit for bit, signed zeros and inf * 0 = NaN included.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

#include "stencil_tile.cuh"

namespace gpipde {

template <typename T, int V, bool Padded>
__global__ void __launch_bounds__(kMaxThreads)
apply_stencil_sym_kernel(const T* __restrict__ coefs4, const T* __restrict__ v,
                         const T* __restrict__ mask, T* __restrict__ out,
                         int Ny, int Nx, int B, Plan p) {
  const Item it = item_of(Ny, Nx, p);
  const Lanes ln = lanes_of<V>(p.chunk);
  const int b = it.b0 + ln.lane * V;
  if (b >= B) return;
  const ptrdiff_t plane = static_cast<ptrdiff_t>(Ny) * Nx * B;
  const ptrdiff_t row = static_cast<ptrdiff_t>(Nx) * B;
  const T* cN = coefs4 + plane;
  const T* cE = coefs4 + 2 * plane;
  const T* cD = coefs4 + 3 * plane;
  for (NodeWalk nw(ln.slot, ln.slots, it.w); nw.ly < it.h; nw.next()) {
    const int y = it.y0 + nw.ly, x = it.x0 + nw.lx;
    const int node = y * Nx + x;
    const ptrdiff_t i = static_cast<ptrdiff_t>(node) * B + b;
    if constexpr (Padded) {
      if (y == 0 || y == Ny - 1 || x == 0 || x == Nx - 1) {
        Pack<T, V> z;
#pragma unroll
        for (int e = 0; e < V; ++e) z.e[e] = T(0);
        st_stream<T, V>(out + i, z);  // the output's halo is zero
        continue;
      }
    }
    const bool n_ = Padded || y + 1 < Ny, s_ = Padded || y > 0;
    const bool e_ = Padded || x + 1 < Nx, w_ = Padded || x > 0;
    const Pack<T, V> c0 = ld_stream<T, V>(coefs4 + i);
    Pack<T, V> v0 = ld_cached<T, V>(v + i, true);
    // (coefficient, v) of each term after c0 * v, in the plain order
    Pack<T, V> t[6][2] = {
        {ld_cached<T, V>(cN + i, true), ld_cached<T, V>(v + i + row, n_)},
        {ld_cached<T, V>(cN + i - row, s_), ld_cached<T, V>(v + i - row, s_)},
        {ld_cached<T, V>(cE + i, true), ld_cached<T, V>(v + i + B, e_)},
        {ld_cached<T, V>(cE + i - B, w_), ld_cached<T, V>(v + i - B, w_)},
        {ld_cached<T, V>(cD + i, true), ld_cached<T, V>(v + i + row + B, n_ && e_)},
        {ld_cached<T, V>(cD + i - row - B, s_ && w_),
         ld_cached<T, V>(v + i - row - B, s_ && w_)}};
    if constexpr (Padded) {  // K3 masks its input: v * mask at each node
      const int dn[6] = {Nx, -Nx, 1, -1, Nx + 1, -Nx - 1};
      const T m0 = __ldg(mask + node);
#pragma unroll
      for (int e = 0; e < V; ++e) v0.e[e] = mul_rn(v0.e[e], m0);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const T mq = __ldg(mask + node + dn[q]);
#pragma unroll
        for (int e = 0; e < V; ++e) t[q][1].e[e] = mul_rn(t[q][1].e[e], mq);
      }
    }
    const T m = __ldg(mask + node);
    Pack<T, V> r;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      T acc = mul_rn(c0.e[e], v0.e[e]);
#pragma unroll
      for (int q = 0; q < 6; ++q) acc = add_rn(acc, mul_rn(t[q][0].e[e], t[q][1].e[e]));
      r.e[e] = mul_rn(m, acc);
    }
    st_stream<T, V>(out + i, r);
  }
}

// Check the plan against the shape (K3: at least 3 x 3 padded nodes), make
// `device` current and launch on `stream`.  Returns the cudaError_t (0 =
// launched).
template <typename T, bool Padded>
int launch_sym(const void* coefs4, const void* v, const void* mask, void* out,
               int Ny, int Nx, int B, const int* plan, int device, void* stream) {
  if (Padded && (Ny < 3 || Nx < 3)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = check_plan(plan, Ny, Nx, B, sizeof(T), true, &p);
  if (err == 0) err = use_device(device);
  if (err == 0 && p.vec > 1 && !aligned16(coefs4, v, out))
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* c = static_cast<const T*>(coefs4);
  const T* vv = static_cast<const T*>(v);
  const T* m = static_cast<const T*>(mask);
  T* o = static_cast<T*>(out);
  if (p.vec == 1)
    apply_stencil_sym_kernel<T, 1, Padded><<<grid_of(p), p.threads, 0, s>>>(c, vv, m, o, Ny, Nx,
                                                                            B, p);
  else
    apply_stencil_sym_kernel<T, 16 / sizeof(T), Padded><<<grid_of(p), p.threads, 0, s>>>(
        c, vv, m, o, Ny, Nx, B, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gpipde
