// Masked symmetric-form (4-grid) stiffness stencil apply, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of generative_physics_informed_pde_tpu/ops/stencil.py
// (_make_sym_kernel, launched through pl.pallas_call by apply_stencil_sym):
//
//   out[y,x,b] = mask[y,x] * ( c0[y,x,b] * v[y,x,b]
//       + sum_{dir in _SYM_DIRS} ( c_dir[y,x,b]       * v[y+oy, x+ox, b]
//                                + c_dir[y-oy,x-ox,b] * v[y-oy, x-ox, b] ) )
//
// on batch-last arrays, with coefs4 = [c0, c_N, c_E, c_D] (fem/assembly.py
// coefficients_sym) and both v and the coefficient grids read as zero
// outside the (Ny, Nx) node grid.  _SYM_DIRS = (1,0) (0,1) (1,1).
//
// Bound on the H100: memory.  Each output costs 7 multiplies, 6 adds and the
// mask multiply against 4 coefficient reads, one v read and one write.  One
// apply must read the 4 coefficient grids, v and the mask and write one grid:
// 6 grids, at the highres32 label shape (33 x 33 x 1024, f32, 4.46 MB a grid)
// 26.8 MB, or 8.0 us at 3.35 TB/s -- two thirds of the 7-grid kernel's bytes.
//
// Design: that of stencil.cu (K1), with the geometry of ops/stencil.py
// launch_plan.  Each direction grid c_dir is read at two nodes per output,
// its own and its -dir neighbour's, and v at seven; a block owns a tile of
// nodes for one chunk of the batch, so both reads of c_dir and the seven of
// v hit lines the tile's threads share in L1, and a thread issues its 14
// loads at once (16-byte loads where the batch row allows).  c0, read once,
// streams with evict-first loads.  The sum runs in the order of
// _apply_stencil_sym_blast (c0*v, then per dir the +dir term and the -dir
// term) with round-to-nearest multiplies and adds that are never contracted
// into fused multiply-adds; a node outside the grid contributes zeros, as
// the plain version's zero padding does (c * 0 and 0 * 0), so the result
// equals apply_stencil_sym_reference bit for bit.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "stencil_tile.cuh"

namespace {

using namespace gpipde;

template <typename T, int V>
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
    const bool n_ = y + 1 < Ny, s_ = y > 0, e_ = x + 1 < Nx, w_ = x > 0;
    const Pack<T, V> c0 = ld_stream<T, V>(coefs4 + i);
    const Pack<T, V> v0 = ld_cached<T, V>(v + i, true);
    // (coefficient, v) of each term after c0 * v, in the plain order
    const Pack<T, V> t[6][2] = {
        {ld_cached<T, V>(cN + i, true), ld_cached<T, V>(v + i + row, n_)},
        {ld_cached<T, V>(cN + i - row, s_), ld_cached<T, V>(v + i - row, s_)},
        {ld_cached<T, V>(cE + i, true), ld_cached<T, V>(v + i + B, e_)},
        {ld_cached<T, V>(cE + i - B, w_), ld_cached<T, V>(v + i - B, w_)},
        {ld_cached<T, V>(cD + i, true), ld_cached<T, V>(v + i + row + B, n_ && e_)},
        {ld_cached<T, V>(cD + i - row - B, s_ && w_),
         ld_cached<T, V>(v + i - row - B, s_ && w_)}};
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

template <typename T>
int launch(const void* coefs4, const void* v, const void* mask, void* out,
           int Ny, int Nx, int B, const int* plan, int device, void* stream) {
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
    apply_stencil_sym_kernel<T, 1><<<grid_of(p), p.threads, 0, s>>>(c, vv, m, o, Ny, Nx, B, p);
  else
    apply_stencil_sym_kernel<T, 16 / sizeof(T)><<<grid_of(p), p.threads, 0, s>>>(c, vv, m, o,
                                                                              Ny, Nx, B, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: device pointers, sizes, the launch plan
// (ops/stencil.py LaunchPlan.as_ints()), the device index and the caller's
// stream.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int gpipde_apply_stencil_sym_f32(const void* coefs4, const void* v,
                                            const void* mask, void* out, int Ny,
                                            int Nx, int B, const int* plan,
                                            int device, void* stream) {
  return launch<float>(coefs4, v, mask, out, Ny, Nx, B, plan, device, stream);
}

extern "C" int gpipde_apply_stencil_sym_f64(const void* coefs4, const void* v,
                                            const void* mask, void* out, int Ny,
                                            int Nx, int B, const int* plan,
                                            int device, void* stream) {
  return launch<double>(coefs4, v, mask, out, Ny, Nx, B, plan, device, stream);
}
