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
// Design: one thread per output (y, x, b), b fastest, kThreads consecutive
// batch entries of one node per block, exactly as stencil.cu.  The TPU
// kernel's double-buffered halo DMAs of v and the coefficients into VMEM
// become edge guards.  The shifted reads c_dir[y-oy, x-ox] hit lines that
// the blocks of the neighbouring nodes read as their own c_dir[y, x], so L1
// and L2 serve them and each coefficient grid crosses HBM about once.  The
// sum runs in the order of _apply_stencil_sym_blast (c0*v, then per dir the
// +dir term and the -dir term) with round-to-nearest multiplies and adds that
// are never contracted into fused multiply-adds, so the result equals the
// plain PyTorch version (apply_stencil_sym_reference) bit for bit.

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
apply_stencil_sym_kernel(const T* __restrict__ coefs4, const T* __restrict__ v,
                         const T* __restrict__ mask, T* __restrict__ out,
                         int Ny, int Nx, int B, int blocks_per_node) {
  const int node = blockIdx.x / blocks_per_node;  // y * Nx + x
  const int b = (blockIdx.x - node * blocks_per_node) * kThreads + threadIdx.x;
  if (b >= B) return;
  const int y = node / Nx;
  const int x = node - y * Nx;
  const ptrdiff_t plane = static_cast<ptrdiff_t>(Ny) * Nx * B;
  const ptrdiff_t i = static_cast<ptrdiff_t>(node) * B + b;
  const ptrdiff_t row = static_cast<ptrdiff_t>(Nx) * B;  // offset of dy=+1
  const bool n = y + 1 < Ny, s = y > 0, e = x + 1 < Nx, w = x > 0;
  const T* cN = coefs4 + plane;
  const T* cE = coefs4 + 2 * plane;
  const T* cD = coefs4 + 3 * plane;

  T acc = mul_rn(coefs4[i], v[i]);                                 // c0 * v
  if (n) acc = add_rn(acc, mul_rn(cN[i], v[i + row]));             // +( 1, 0)
  if (s) acc = add_rn(acc, mul_rn(cN[i - row], v[i - row]));       // -( 1, 0)
  if (e) acc = add_rn(acc, mul_rn(cE[i], v[i + B]));               // +( 0, 1)
  if (w) acc = add_rn(acc, mul_rn(cE[i - B], v[i - B]));           // -( 0, 1)
  if (n && e) acc = add_rn(acc, mul_rn(cD[i], v[i + row + B]));    // +( 1, 1)
  if (s && w) acc = add_rn(acc, mul_rn(cD[i - row - B], v[i - row - B]));  // -( 1, 1)
  out[i] = mul_rn(mask[node], acc);
}

template <typename T>
int launch(const void* coefs4, const void* v, const void* mask, void* out,
           int Ny, int Nx, int B, int device, void* stream) {
  if (Ny <= 0 || Nx <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_node = (B + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(Ny) * Nx * blocks_per_node;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  apply_stencil_sym_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coefs4), static_cast<const T*>(v),
      static_cast<const T*>(mask), static_cast<T*>(out), Ny, Nx, B,
      blocks_per_node);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: device pointers, sizes, the device index and
// the caller's stream.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int gpipde_apply_stencil_sym_f32(const void* coefs4, const void* v,
                                            const void* mask, void* out, int Ny,
                                            int Nx, int B, int device,
                                            void* stream) {
  return launch<float>(coefs4, v, mask, out, Ny, Nx, B, device, stream);
}

extern "C" int gpipde_apply_stencil_sym_f64(const void* coefs4, const void* v,
                                            const void* mask, void* out, int Ny,
                                            int Nx, int B, int device,
                                            void* stream) {
  return launch<double>(coefs4, v, mask, out, Ny, Nx, B, device, stream);
}
