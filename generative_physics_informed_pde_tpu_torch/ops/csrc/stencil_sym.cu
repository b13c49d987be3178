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
// Design: a block owns a tile of nodes for one chunk of the batch, with the
// geometry of ops/stencil.py launch_plan (8 x 8 tiles of one 128-byte line,
// 16-byte loads where the batch row allows), so the two reads of each c_dir
// and the seven of v hit lines the tile's threads share in L1.  The kernel
// body is stencil_sym.cuh's, shared with the halo-padded form K3
// (stencil_sym_blocked.cu); here it runs with guarded loads (Padded =
// false) and equals apply_stencil_sym_reference bit for bit.

#include "stencil_sym.cuh"
#include "stencil_tile.cuh"

// Plain C interface for ctypes: device pointers, sizes, the launch plan
// (ops/stencil.py LaunchPlan.as_ints()), the device index and the caller's
// stream.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int gpipde_apply_stencil_sym_f32(const void* coefs4, const void* v,
                                            const void* mask, void* out, int Ny,
                                            int Nx, int B, const int* plan,
                                            int device, void* stream) {
  return gpipde::launch_sym<float, false>(coefs4, v, mask, out, Ny, Nx, B, plan, device, stream);
}

extern "C" int gpipde_apply_stencil_sym_f64(const void* coefs4, const void* v,
                                            const void* mask, void* out, int Ny,
                                            int Nx, int B, const int* plan,
                                            int device, void* stream) {
  return gpipde::launch_sym<double, false>(coefs4, v, mask, out, Ny, Nx, B, plan, device, stream);
}
