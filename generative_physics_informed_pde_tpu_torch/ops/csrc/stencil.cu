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
// mask multiply (15 flops) against 7 coefficient reads, one v read and one
// write (36 bytes in f32): about 0.4 flop/byte, far below the card's f32
// balance of ~20 flop/byte.  One apply must read 8 grids (7 coefficient
// grids and v) plus the mask and write one grid; at the highres32 label
// shape (33 x 33 x 1024, f32, 4.46 MB a grid) that is 40 MB, or 12 us at
// 3.35 TB/s.
//
// Design: one thread per output (y, x, b).  A block covers kThreads
// consecutive batch entries of one node, so every warp reads 128 contiguous
// bytes of each coefficient grid and of v and writes 128 contiguous bytes of
// out.  The TPU kernel's halo DMA into VMEM becomes edge guards; the seven
// reads of v hit neighbouring nodes' lines, which L1/L2 serve after their
// first use.  Each coefficient value is read exactly once, so nothing is
// staged in shared memory.  The sum runs in _OFFSETS order with
// round-to-nearest multiplies and adds that are never contracted into fused
// multiply-adds, so the result equals the plain PyTorch version
// (apply_stencil_reference) bit for bit.

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
apply_stencil_kernel(const T* __restrict__ coefs, const T* __restrict__ v,
                     const T* __restrict__ mask, T* __restrict__ out,
                     int Ny, int Nx, int B, int blocks_per_node) {
  const int node = blockIdx.x / blocks_per_node;  // y * Nx + x
  const int b = (blockIdx.x - node * blocks_per_node) * kThreads + threadIdx.x;
  if (b >= B) return;
  const int y = node / Nx;
  const int x = node - y * Nx;
  const ptrdiff_t plane = static_cast<ptrdiff_t>(Ny) * Nx * B;
  const ptrdiff_t i = static_cast<ptrdiff_t>(node) * B + b;
  const ptrdiff_t row = static_cast<ptrdiff_t>(Nx) * B;  // v offset of dy=+1
  const bool n = y + 1 < Ny, s = y > 0, e = x + 1 < Nx, w = x > 0;

  T acc = mul_rn(coefs[i], v[i]);                                              // ( 0, 0)
  if (n) acc = add_rn(acc, mul_rn(coefs[plane + i], v[i + row]));              // ( 1, 0)
  if (s) acc = add_rn(acc, mul_rn(coefs[2 * plane + i], v[i - row]));          // (-1, 0)
  if (e) acc = add_rn(acc, mul_rn(coefs[3 * plane + i], v[i + B]));            // ( 0, 1)
  if (w) acc = add_rn(acc, mul_rn(coefs[4 * plane + i], v[i - B]));            // ( 0,-1)
  if (n && e) acc = add_rn(acc, mul_rn(coefs[5 * plane + i], v[i + row + B])); // ( 1, 1)
  if (s && w) acc = add_rn(acc, mul_rn(coefs[6 * plane + i], v[i - row - B])); // (-1,-1)
  out[i] = mul_rn(mask[node], acc);
}

template <typename T>
int launch(const void* coefs, const void* v, const void* mask, void* out,
           int Ny, int Nx, int B, int device, void* stream) {
  if (Ny <= 0 || Nx <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_node = (B + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(Ny) * Nx * blocks_per_node;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  apply_stencil_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coefs), static_cast<const T*>(v),
      static_cast<const T*>(mask), static_cast<T*>(out), Ny, Nx, B,
      blocks_per_node);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: device pointers, sizes, the device index and
// the caller's stream.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int gpipde_apply_stencil_f32(const void* coefs, const void* v,
                                        const void* mask, void* out, int Ny,
                                        int Nx, int B, int device, void* stream) {
  return launch<float>(coefs, v, mask, out, Ny, Nx, B, device, stream);
}

extern "C" int gpipde_apply_stencil_f64(const void* coefs, const void* v,
                                        const void* mask, void* out, int Ny,
                                        int Nx, int B, int device, void* stream) {
  return launch<double>(coefs, v, mask, out, Ny, Nx, B, device, stream);
}
