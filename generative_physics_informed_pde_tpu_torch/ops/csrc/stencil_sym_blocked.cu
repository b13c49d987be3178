// Masked symmetric-form (4-grid) stiffness stencil apply on the halo-padded
// layout, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of generative_physics_informed_pde_tpu/ops/stencil.py
// (_make_sym_blocked_kernel, launched through pl.pallas_call by
// apply_stencil_sym_blocked) and keeps its contract: v, out and the mask are
// halo-padded, interior at [1:1+Ny, 1:1+Nx], and the kernel masks its own
// input, so for an interior node (y, x)
//
//   vm[j]      = v[j] * mask[j]
//   out[y,x,b] = mask[y,x] * ( c0[y,x,b] * vm[y,x,b]
//       + sum_{dir in _SYM_DIRS} ( c_dir[y,x,b]       * vm[y+oy, x+ox, b]
//                                + c_dir[y-oy,x-ox,b] * vm[y-oy, x-ox, b] ) )
//
// and out is 0 on the halo rows and columns.  _SYM_DIRS = (1,0) (0,1) (1,1).
// Layout (chosen for Hopper; the TPU's (Bb, R, CP, 128) tiling is dropped):
// batch-last v/out (R, C, B) and coefficients (4, R, C, B) with R = Ny + 2,
// C = Nx + 2, mask (R, C, 1).  Every neighbour of an interior node is a
// valid address, so the kernel needs none of K2's edge guards.
//
// Bound on the H100: memory.  Each interior output costs 7 multiplies, 6
// adds, the mask multiply and 7 input-mask multiplies against 4 coefficient
// reads, one v read and one write.  One apply must read c0 at the interior,
// each direction grid at the interior and its shift, v and the mask at all
// but two halo corners, and write the whole output: at (33, 33, 1024) f32
// padded to (35, 35, 1024), 28.4 MB, or 8.5 us at 3.35 TB/s.
//
// Design: K2's (stencil_sym.cu), on the padded grid.  The kernel body is
// stencil_sym.cuh's, instantiated with Padded = true: a block owns a tile of
// padded nodes for one chunk of the batch (ops/stencil.py launch_plan, K2's
// form of the plan on the padded sizes), so the tile's threads share v's, the mask's and
// the direction grids' lines in L1; loads are 16 bytes where the batch row
// allows; no load is guarded; tiles over the halo store zeros with the same
// stores; the chunk follows B, so no thread idles at a small batch.  The
// TPU kernel's double-buffered DMAs of row tiles into VMEM become these
// direct loads: staging in shared memory lost to them for K1 and K2 at
// every shape measured (PERF.md).  Every term of the plain version is
// multiplied and added in its order (apply_stencil_sym_blocked_reference)
// with round-to-nearest operations that are never contracted into fused
// multiply-adds, so the result equals it bit for bit.

#include "stencil_sym.cuh"
#include "stencil_tile.cuh"

// Plain C interface for ctypes: device pointers, the padded sizes R = Ny + 2
// and C = Nx + 2, the batch, the launch plan (ops/stencil.py
// LaunchPlan.as_ints()), the device index and the caller's stream.  Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int gpipde_apply_stencil_sym_blocked_f32(const void* c, const void* v,
                                                    const void* mask, void* out,
                                                    int R, int C, int B,
                                                    const int* plan, int device,
                                                    void* stream) {
  return gpipde::launch_sym<float, true>(c, v, mask, out, R, C, B, plan, device, stream);
}

extern "C" int gpipde_apply_stencil_sym_blocked_f64(const void* c, const void* v,
                                                    const void* mask, void* out,
                                                    int R, int C, int B,
                                                    const int* plan, int device,
                                                    void* stream) {
  return gpipde::launch_sym<double, true>(c, v, mask, out, R, C, B, plan, device, stream);
}
