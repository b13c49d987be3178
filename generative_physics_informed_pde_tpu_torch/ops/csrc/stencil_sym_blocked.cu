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
// C = Nx + 2, mask (R, C, 1).  The coefficients are zero on the halo
// (pad_coefs_blocked), so every neighbour of an interior node is a valid
// address and the kernel needs none of stencil_sym.cu's edge guards.
//
// Bound on the H100: memory.  Each interior output costs 7 multiplies, 6
// adds, the mask multiply and 7 input-mask multiplies against 4 coefficient
// reads, one v read and one write.  One apply must read c0 at the interior,
// each direction grid at the interior and its shift, v and the mask at all
// but two halo corners, and write the whole output: at (33, 33, 1024) f32
// padded to (35, 35, 1024), 28.4 MB, or 8.5 us at 3.35 TB/s (six whole
// padded grids would be 30.1 MB, 9.0 us).
//
// Design: one thread per element (y, x, b) of the padded output, b fastest,
// kThreads consecutive batch entries of one node per block, exactly as
// stencil_sym.cu; halo threads write 0.  The TPU kernel's double-buffered
// DMAs of (TY+2)-row tiles into VMEM become plain loads: the shifted reads
// c_dir[y-oy, x-ox] and v of the neighbours hit lines that the blocks of the
// neighbouring nodes read as their own, so L1 and L2 serve them and each grid
// crosses HBM about once.  The sum runs in the order of the plain version
// (apply_stencil_sym_blocked_reference, itself the order of
// _apply_stencil_sym_blast) with round-to-nearest multiplies and adds that
// are never contracted into fused multiply-adds, so the result equals the
// plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_stencil_sym_blocked_kernel(const T* __restrict__ c, const T* __restrict__ v,
                                 const T* __restrict__ mask, T* __restrict__ out,
                                 int R, int C, int B, int blocks_per_node) {
  const int node = blockIdx.x / blocks_per_node;  // y * C + x, padded grid
  const int b = (blockIdx.x - node * blocks_per_node) * kThreads + threadIdx.x;
  if (b >= B) return;
  const int y = node / C;
  const int x = node - y * C;
  const ptrdiff_t i = static_cast<ptrdiff_t>(node) * B + b;
  if (y == 0 || y == R - 1 || x == 0 || x == C - 1) {
    out[i] = T(0);  // the halo of the output is written as zero
    return;
  }
  const ptrdiff_t plane = static_cast<ptrdiff_t>(R) * C * B;
  const ptrdiff_t row = static_cast<ptrdiff_t>(C) * B;  // offset of dy=+1
  const T* cN = c + plane;
  const T* cE = c + 2 * plane;
  const T* cD = c + 3 * plane;
  // masked input of the node at element offset dv and node offset dn
  auto vm = [&](ptrdiff_t dv, int dn) { return mul_rn(v[i + dv], mask[node + dn]); };

  T acc = mul_rn(c[i], vm(0, 0));                                     // c0 * v
  acc = add_rn(acc, mul_rn(cN[i], vm(row, C)));                       // +( 1, 0)
  acc = add_rn(acc, mul_rn(cN[i - row], vm(-row, -C)));               // -( 1, 0)
  acc = add_rn(acc, mul_rn(cE[i], vm(B, 1)));                         // +( 0, 1)
  acc = add_rn(acc, mul_rn(cE[i - B], vm(-B, -1)));                   // -( 0, 1)
  acc = add_rn(acc, mul_rn(cD[i], vm(row + B, C + 1)));               // +( 1, 1)
  acc = add_rn(acc, mul_rn(cD[i - row - B], vm(-row - B, -C - 1)));   // -( 1, 1)
  out[i] = mul_rn(mask[node], acc);
}

template <typename T>
int launch(const void* c, const void* v, const void* mask, void* out, int R,
           int C, int B, int device, void* stream) {
  if (R < 3 || C < 3 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_node = (B + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(R) * C * blocks_per_node;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  apply_stencil_sym_blocked_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c), static_cast<const T*>(v),
      static_cast<const T*>(mask), static_cast<T*>(out), R, C, B,
      blocks_per_node);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: device pointers, the padded sizes R = Ny + 2
// and C = Nx + 2, the batch, the device index and the caller's stream.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int gpipde_apply_stencil_sym_blocked_f32(const void* c, const void* v,
                                                    const void* mask, void* out,
                                                    int R, int C, int B,
                                                    int device, void* stream) {
  return launch<float>(c, v, mask, out, R, C, B, device, stream);
}

extern "C" int gpipde_apply_stencil_sym_blocked_f64(const void* c, const void* v,
                                                    const void* mask, void* out,
                                                    int R, int C, int B,
                                                    int device, void* stream) {
  return launch<double>(c, v, mask, out, R, C, B, device, stream);
}
