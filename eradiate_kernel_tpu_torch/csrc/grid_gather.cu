// Per-lane row gather from a resident table, the packed-corner trilinear
// lookup built on it, and the lookup's gradient with respect to the grid.
// Three entries:
//
//   grid_gather_launch        out[j, :] = table[clamp(idx[j], 0, V - 1), :]
//   grid_trilinear_launch     out[j, :] = the trilinear interpolation of a
//                             gridvolume at local point pl[j] of grid slot
//                             slot[j], from the packed 8-corner table
//   grid_trilinear_bwd_launch d_grid += the transpose of the lookup applied
//                             to the cotangent ct (L, C)
//
// Replaces the Pallas TPU gather probe of tools/probe_pallas_gather.py
// (kernels `k_fancy` :54, `k_take` :58, `k_tala` :62 and `k_onehot` :72,
// launched through `call` :87; all four compute out[j] = tab[idx[j]]),
// generalised to rows. R = 1 is the probe (V = 4,096, L = 1,024); R = 8 is
// the packed-corner row of textures/volumes.py::_trilinear_gather (one row
// per voxel holding its 8 trilinear corners, e.g. 262,144 rows of 32 bytes
// for a 64^3 grid). Contract (see ops/gather.py):
//   table (V, R) f32, contiguous; idx (L,) i32 or i64; out (L, R) f32.
// Out-of-range indices are clamped, as the jnp gathers of the reference
// clamp them.
//
// grid_gather_launch design: one thread per lane, which reads its row in
// 16-byte chunks when R is a multiple of 4 (float4 loads and stores: a
// 32-byte packed-corner row is two, from one sector; a warp's stores
// cover one contiguous run of the output), else float by float. No
// integer division, no shared memory: each row is read once per lane that
// asks for it, and repeated rows hit L2.
//
// Bound on an H100: bytes. The function moves L * (idx bytes + 2 * R * 4)
// bytes (each index read once, each gathered row read and written once)
// and does no arithmetic, so the least time is those bytes over 3.35 TB/s.
// Random rows cost whole 32-byte sectors: a 32-byte packed-corner row is
// exactly one sector, a 4-byte probe row wastes 28 of its sector's bytes.
//
// grid_trilinear_launch is the gather designed for the one caller the
// probe was written for: textures/volumes.py::_trilinear_gather (the JAX
// package's _trilinear_gather, textures/volumes.py:117). Contract:
//   packed (V, 8C) f32 (volumes.packed_corners: c000..c111 of every voxel),
//   pl (L, 3) f32 local coordinates (already wrapped), slot (L,) i32;
//   grid shape (S, D, H, W, C); out (L, C) f32.
// One thread per lane does the whole eager chain around the gather in
// registers: the clamp, scale, truncate and clamp of corner c000 only, the
// row index slot*D*H*W + (z0*H + y0)*W + x0 in int32 (wrapping as torch's
// int32 ops do), clamped as the gather clamps it, one 8C-float row read
// with float4 loads (C = 1: one 32-byte sector) and _lerp8 in the same
// expression order. Built with -fmad=false it is bit-equal to the plain
// chain (volumes.trilinear_gather_plain). Bound on an H100: bytes, L x (12
// + 4 + 8C*4 + C*4) (the point, the slot, the row, the result) over 3.35
// TB/s; it does ~25 FP32 operations a lane.
//
// grid_trilinear_bwd_launch is the exact transpose of grid ->
// packed_corners -> clamped row gather -> _lerp8 (the plain version is
// textures/volumes.py::trilinear_backward_plain). Contract:
//   ct (L, C) f32, pl (L, 3) f32, slot (L,) i32 as the lookup took them;
//   d_grid (S*D*H*W*C) f32, zeroed by the caller.
// One thread per lane recomputes corner c000's row and the fractions with
// the lookup's own code (corner_row), splits the row into its voxel
// (s, z, y, x) and adds ct[j, c] times the weight _lerp8 gives corner k,
// ((ct (1 - fz|fz)) (1 - fy|fy)) (1 - fx|fx), into the 8 voxels
// (s, min(z + dz, D - 1), min(y + dy, H - 1), min(x + dx, W - 1)), the
// edge-clamped neighbours packed_corners stores, with atomicAdd on f32.
// Each product rounds as the plain version's does; the sums land in an
// order that changes from run to run. Bound on an H100: bytes, L x (12 +
// 4 + 4C) read plus L x 8C x 4 bytes of atomics over 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// a row's 16-byte chunk: 4 floats or 2 doubles
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T, typename Idx, bool kVec>
__global__ void __launch_bounds__(kThreads) grid_gather_kernel(
    const T *__restrict__ table, const Idx *__restrict__ idx,
    T *__restrict__ out, int64_t n_rows, int chunks, int64_t n_lanes) {
  const int64_t lane = blockIdx.x * static_cast<int64_t>(kThreads) +
                       threadIdx.x;
  if (lane >= n_lanes) return;
  int64_t r = static_cast<int64_t>(idx[lane]);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  if constexpr (kVec) {
    using V = typename Vec<T>::type;
    const V *src = reinterpret_cast<const V *>(table) + r * chunks;
    V *dst = reinterpret_cast<V *>(out) + lane * chunks;
    for (int c = 0; c < chunks; ++c) dst[c] = __ldg(src + c);
  } else {
    for (int c = 0; c < chunks; ++c)
      out[lane * chunks + c] = __ldg(table + r * chunks + c);
  }
}

template <typename T, typename Idx>
void launch(const T *table, const Idx *idx, T *out, int64_t n_rows,
            int n_cols, int64_t n_lanes, bool vec, cudaStream_t stream) {
  const int64_t blocks = (n_lanes + kThreads - 1) / kThreads;
  if (vec) {
    grid_gather_kernel<T, Idx, true><<<blocks, kThreads, 0, stream>>>(
        table, idx, out, n_rows, n_cols / Vec<T>::n, n_lanes);
  } else {
    grid_gather_kernel<T, Idx, false><<<blocks, kThreads, 0, stream>>>(
        table, idx, out, n_rows, n_cols, n_lanes);
  }
}

__device__ __forceinline__ float tmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double tmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmax(double a, double b) {
  return fmax(a, b);
}

// torch.clamp(x, 0, 1): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return x != x ? x : tmin(tmax(x, T(0)), T(1));
}

// _corner0 along one axis: (c000's index, fractional weight)
template <typename T>
__device__ __forceinline__ int32_t corner0(T p, int n, T &f) {
  const T g = clamp01(p) * static_cast<T>(n - 1);
  int32_t i = static_cast<int32_t>(g);
  const int32_t hi = n - 2 > 0 ? n - 2 : 0;
  i = i < 0 ? 0 : (i > hi ? hi : i);
  f = g - static_cast<T>(i);
  return i;
}

// _lerp8 of the 8 corners of one channel, c[k] = row[k * C]
template <typename T>
__device__ __forceinline__ T lerp8(const T *c, int C, T fx, T fy, T fz) {
  const T c00 = c[0] * (T(1) - fx) + c[C] * fx;
  const T c01 = c[2 * C] * (T(1) - fx) + c[3 * C] * fx;
  const T c10 = c[4 * C] * (T(1) - fx) + c[5 * C] * fx;
  const T c11 = c[6 * C] * (T(1) - fx) + c[7 * C] * fx;
  const T c0 = c00 * (T(1) - fy) + c01 * fy;
  const T c1 = c10 * (T(1) - fy) + c11 * fy;
  return c0 * (T(1) - fz) + c1 * fz;
}

// corner c000's packed row of lane j, clamped as the gather clamps it,
// and the three fractions: the lookup and its backward share it
template <typename T>
__device__ __forceinline__ int64_t corner_row(const T *pl,
                                              const int32_t *slot, int64_t j,
                                              int64_t n_rows, int D, int H,
                                              int W, T &fx, T &fy, T &fz) {
  const int32_t x0 = corner0(pl[3 * j], W, fx);
  const int32_t y0 = corner0(pl[3 * j + 1], H, fy);
  const int32_t z0 = corner0(pl[3 * j + 2], D, fz);
  // int32 index arithmetic of the plain chain, wrapping like torch's
  const uint32_t u = static_cast<uint32_t>(slot[j]) *
                         static_cast<uint32_t>(D * H * W) +
                     (static_cast<uint32_t>(z0) * H + y0) * W + x0;
  const int64_t r = static_cast<int32_t>(u);
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

// the 8 corners of a C = 1 row: two float4 or four double2 loads
__device__ __forceinline__ void load8(const float *packed, int64_t r,
                                      float (&c)[8]) {
  const float4 *row = reinterpret_cast<const float4 *>(packed) + 2 * r;
  const float4 a = __ldg(row), b = __ldg(row + 1);
  c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
  c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
}
__device__ __forceinline__ void load8(const double *packed, int64_t r,
                                      double (&c)[8]) {
  const double2 *row = reinterpret_cast<const double2 *>(packed) + 4 * r;
  for (int k = 0; k < 4; ++k) {
    const double2 a = __ldg(row + k);
    c[2 * k] = a.x;
    c[2 * k + 1] = a.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) grid_trilinear_kernel(
    const T *__restrict__ packed, const T *__restrict__ pl,
    const int32_t *__restrict__ slot, int64_t n_rows, int D, int H, int W,
    int C, int64_t n_lanes, T *__restrict__ out) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (j >= n_lanes) return;
  T fx, fy, fz;
  const int64_t r = corner_row(pl, slot, j, n_rows, D, H, W, fx, fy, fz);
  if (C == 1) {
    T c[8];
    load8(packed, r, c);
    out[j] = lerp8(c, 1, fx, fy, fz);
  } else {
    const T *row = packed + r * 8 * C;
    for (int ch = 0; ch < C; ++ch)
      out[j * C + ch] = lerp8(row + ch, C, fx, fy, fz);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) grid_trilinear_bwd_kernel(
    const T *__restrict__ ct, const T *__restrict__ pl,
    const int32_t *__restrict__ slot, int64_t n_rows, int D, int H, int W,
    int C, int64_t n_lanes, T *__restrict__ d_grid) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (j >= n_lanes) return;
  T fx, fy, fz;
  const int64_t r = corner_row(pl, slot, j, n_rows, D, H, W, fx, fy, fz);
  // the row's voxel and its +1 neighbours, edge-clamped as packed_corners
  // builds them; base = s * D * H * W
  const int64_t x = r % W, y = (r / W) % H, z = (r / (W * H)) % D;
  const int64_t base = r - (z * H + y) * W - x;
  const int64_t xs[2] = {x, x + 1 < W ? x + 1 : W - 1};
  const int64_t ys[2] = {y, y + 1 < H ? y + 1 : H - 1};
  const int64_t zs[2] = {z, z + 1 < D ? z + 1 : D - 1};
  const T wx[2] = {T(1) - fx, fx}, wy[2] = {T(1) - fy, fy},
          wz[2] = {T(1) - fz, fz};
  for (int c = 0; c < C; ++c) {
    const T g = ct[j * C + c];
    for (int dz = 0; dz < 2; ++dz) {
      const T gz = g * wz[dz];
      for (int dy = 0; dy < 2; ++dy) {
        const T gzy = gz * wy[dy];
        for (int dx = 0; dx < 2; ++dx) {
          const int64_t v = base + (zs[dz] * H + ys[dy]) * W + xs[dx];
          atomicAdd(d_grid + v * C + c, gzy * wx[dx]);
        }
      }
    }
  }
}

template <typename T>
int gather(const void *table, const void *idx, void *out, long long n_rows,
           int n_cols, long long n_lanes, int idx_is_64, int vec,
           void *stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto *tab = static_cast<const T *>(table);
  auto *o = static_cast<T *>(out);
  if (idx_is_64) {
    launch(tab, static_cast<const int64_t *>(idx), o, n_rows, n_cols,
           n_lanes, vec != 0, s);
  } else {
    launch(tab, static_cast<const int32_t *>(idx), o, n_rows, n_cols,
           n_lanes, vec != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int trilinear(const void *packed, const void *pl, const void *slot,
              void *out, long long n_rows, int D, int H, int W, int C,
              long long n_lanes, void *stream) {
  if (n_lanes > 0) {
    const long long blocks = (n_lanes + kThreads - 1) / kThreads;
    grid_trilinear_kernel<T><<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T *>(packed), static_cast<const T *>(pl),
        static_cast<const int32_t *>(slot), n_rows, D, H, W, C, n_lanes,
        static_cast<T *>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int trilinear_bwd(const void *ct, const void *pl, const void *slot,
                  void *d_grid, long long n_rows, int D, int H, int W, int C,
                  long long n_lanes, void *stream) {
  if (n_lanes > 0) {
    const long long blocks = (n_lanes + kThreads - 1) / kThreads;
    grid_trilinear_bwd_kernel<T><<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T *>(ct), static_cast<const T *>(pl),
        static_cast<const int32_t *>(slot), n_rows, D, H, W, C, n_lanes,
        static_cast<T *>(d_grid));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (no sync). vec needs n_cols a multiple of 4 floats
// (2 doubles) and 16-byte aligned table and out. Returns
// cudaGetLastError() after the launch.
extern "C" int grid_gather_launch(const void *table, const void *idx,
                                  void *out, long long n_rows, int n_cols,
                                  long long n_lanes, int idx_is_64, int vec4,
                                  void *stream) {
  return gather<float>(table, idx, out, n_rows, n_cols, n_lanes, idx_is_64,
                       vec4, stream);
}

extern "C" int grid_gather_launch_f64(const void *table, const void *idx,
                                      void *out, long long n_rows,
                                      int n_cols, long long n_lanes,
                                      int idx_is_64, int vec, void *stream) {
  return gather<double>(table, idx, out, n_rows, n_cols, n_lanes, idx_is_64,
                        vec, stream);
}

// Launch the trilinear lookup on `stream` (no sync): packed (n_rows, 8C),
// pl (n_lanes, 3), slot (n_lanes,) i32, out (n_lanes, C). Returns
// cudaGetLastError() after the launch.
extern "C" int grid_trilinear_launch(const void *packed, const void *pl,
                                     const void *slot, void *out,
                                     long long n_rows, int D, int H, int W,
                                     int C, long long n_lanes, void *stream) {
  return trilinear<float>(packed, pl, slot, out, n_rows, D, H, W, C,
                          n_lanes, stream);
}

extern "C" int grid_trilinear_launch_f64(const void *packed, const void *pl,
                                         const void *slot, void *out,
                                         long long n_rows, int D, int H,
                                         int W, int C, long long n_lanes,
                                         void *stream) {
  return trilinear<double>(packed, pl, slot, out, n_rows, D, H, W, C,
                           n_lanes, stream);
}

// Launch the lookup's backward on `stream` (no sync): ct (n_lanes, C), pl
// (n_lanes, 3), slot (n_lanes,) i32 as the lookup took them; d_grid
// (n_rows * C), n_rows = S * D * H * W, zeroed by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int grid_trilinear_bwd_launch(const void *ct, const void *pl,
                                         const void *slot, void *d_grid,
                                         long long n_rows, int D, int H,
                                         int W, int C, long long n_lanes,
                                         void *stream) {
  return trilinear_bwd<float>(ct, pl, slot, d_grid, n_rows, D, H, W, C,
                              n_lanes, stream);
}

extern "C" int grid_trilinear_bwd_launch_f64(const void *ct, const void *pl,
                                             const void *slot, void *d_grid,
                                             long long n_rows, int D, int H,
                                             int W, int C, long long n_lanes,
                                             void *stream) {
  return trilinear_bwd<double>(ct, pl, slot, d_grid, n_rows, D, H, W, C,
                               n_lanes, stream);
}
