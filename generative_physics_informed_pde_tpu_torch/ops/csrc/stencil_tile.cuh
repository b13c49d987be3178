// Shared pieces of the tiled stencil kernels K1 (stencil.cu), K2
// (stencil_sym.cu) and K3 (stencil_sym_blocked.cu): the launch plan as the
// kernels read it, work-item decoding, 16-byte (or scalar) loads and
// stores, exact round-to-nearest arithmetic, and the launch checks.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace gpipde {

constexpr int kMaxThreads = 256;  // __launch_bounds__ of the kernels
constexpr int kMaxDevices = 64;
constexpr int kMaxTiles = 65535;  // gridDim.y and gridDim.z

// ops/stencil.py LaunchPlan.as_ints(), in this order.
struct Plan {
  int tiles_y, tiles_x, tile_rows, tile_cols, chunk, vec, threads, blocks;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// V consecutive batch entries: one 16-byte access (float4, double2) or,
// with V == 1, one scalar.
template <typename T, int V>
struct Pack {
  T e[V];
};

// Read once (the coefficients a node owns): evict first.
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ld_stream(const T* p) {
  Pack<T, V> r;
  if constexpr (V == 1) {
    r.e[0] = __ldcs(p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    r.e[0] = q.x; r.e[1] = q.y; r.e[2] = q.z; r.e[3] = q.w;
  } else {
    const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
    r.e[0] = q.x; r.e[1] = q.y;
  }
  return r;
}

// Read again by neighbouring outputs of the block: through L1; zeros where
// the node leaves the grid (the plain version's zero padding).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ld_cached(const T* p, bool in_grid) {
  Pack<T, V> r;
  if (!in_grid) {
#pragma unroll
    for (int e = 0; e < V; ++e) r.e[e] = T(0);
  } else if constexpr (V == 1) {
    r.e[0] = __ldg(p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.e[0] = q.x; r.e[1] = q.y; r.e[2] = q.z; r.e[3] = q.w;
  } else {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    r.e[0] = q.x; r.e[1] = q.y;
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void st_stream(T* p, const Pack<T, V>& r) {
  if constexpr (V == 1) {
    __stcs(p, r.e[0]);
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(r.e[0], r.e[1], r.e[2], r.e[3]));
  } else {
    __stcs(reinterpret_cast<double2*>(p), make_double2(r.e[0], r.e[1]));
  }
}

// The work item of a block of the grid (chunks, tiles_x, tiles_y): node
// rows [y0, y0 + h), columns [x0, x0 + w), batch entries from b0.  Chunks
// are the fastest grid dimension, so a tile's chunks go to adjacent blocks,
// which read adjacent bytes.
struct Item {
  int y0, h, x0, w, b0;
};

__device__ __forceinline__ Item item_of(int Ny, int Nx, const Plan& p) {
  Item it;
  it.y0 = static_cast<int>(blockIdx.z) * p.tile_rows;
  it.x0 = static_cast<int>(blockIdx.y) * p.tile_cols;
  it.h = min(p.tile_rows, Ny - it.y0);
  it.w = min(p.tile_cols, Nx - it.x0);
  it.b0 = static_cast<int>(blockIdx.x) * p.chunk;
  return it;
}

// A thread's lane (V batch entries of the chunk) and its nodes of the tile:
// the slot-th, then every slots-th, row-major.  lanes = chunk / V is a
// power of two that divides the block.
struct Lanes {
  int lane, slot, slots;
};

template <int V>
__device__ __forceinline__ Lanes lanes_of(int chunk) {
  const int lanes = chunk / V;
  const int shift = __ffs(lanes) - 1;
  const int t = static_cast<int>(threadIdx.x);
  return {t & (lanes - 1), t >> shift, static_cast<int>(blockDim.x) >> shift};
}

// Walk a thread's nodes (ly, lx) of a tile of width w: two divisions a
// thread, none per node.
struct NodeWalk {
  int ly, lx, dy, dx, w;
  __device__ __forceinline__ NodeWalk(int slot, int slots, int w_) : w(w_) {
    ly = slot / w;
    lx = slot - ly * w;
    dy = slots / w;
    dx = slots - dy * w;
  }
  __device__ __forceinline__ void next() {
    ly += dy;
    lx += dx;
    if (lx >= w) {
      lx -= w;
      ++ly;
    }
  }
};

// Host side ------------------------------------------------------------------

// Read and check a plan against the shape: 16-byte loads (vec > 1) only
// where `wide` (K2, K3; K1 loads scalars).  0 or cudaErrorInvalidValue.
inline int check_plan(const int* q, int Ny, int Nx, int B, int item, bool wide, Plan* p) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (q == nullptr || Ny <= 0 || Nx <= 0 || B <= 0) return bad;
  *p = Plan{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
  // tiles of tile_rows x tile_cols cover the grid, the last row and column
  // of tiles cut short, none empty
  if (p->tiles_y <= 0 || p->tiles_x <= 0 || p->tiles_y > kMaxTiles || p->tiles_x > kMaxTiles ||
      p->tile_rows <= 0 || p->tile_cols <= 0 ||
      static_cast<long long>(p->tile_rows) * p->tiles_y < Ny ||
      static_cast<long long>(p->tile_rows) * (p->tiles_y - 1) >= Ny ||
      static_cast<long long>(p->tile_cols) * p->tiles_x < Nx ||
      static_cast<long long>(p->tile_cols) * (p->tiles_x - 1) >= Nx)
    return bad;
  if (!(p->vec == 1 || (wide && p->vec * item == 16)) || p->chunk <= 0 || p->chunk % p->vec != 0 ||
      B % p->vec != 0)
    return bad;
  const int lanes = p->chunk / p->vec;
  if ((lanes & (lanes - 1)) != 0) return bad;
  if (p->threads <= 0 || p->threads > kMaxThreads || p->threads % lanes != 0) return bad;
  const long long blocks =
      static_cast<long long>(p->tiles_y) * p->tiles_x * ((B + p->chunk - 1) / p->chunk);
  if (p->blocks != blocks) return bad;  // one work item per block
  return 0;
}

// The grid of a plan: (chunks, tiles_x, tiles_y).
inline dim3 grid_of(const Plan& p) {
  return dim3(static_cast<unsigned>(p.blocks / (p.tiles_y * p.tiles_x)),
              static_cast<unsigned>(p.tiles_x), static_cast<unsigned>(p.tiles_y));
}

// Make `device` current only if it is not already.
inline int use_device(int device) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  return static_cast<int>(e);
}

inline bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15u) == 0;
}

}  // namespace gpipde
