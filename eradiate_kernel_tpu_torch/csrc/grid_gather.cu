// Per-lane row gather from a resident table, and the packed-corner
// trilinear lookup built on it. Two entries:
//
//   grid_gather_launch     out[j, :] = table[clamp(idx[j], 0, V - 1), :]
//   grid_trilinear_launch  out[j, :] = the trilinear interpolation of a
//                          gridvolume at local point pl[j] of grid slot
//                          slot[j], from the packed 8-corner table
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Idx, int kVec>
__global__ void __launch_bounds__(kThreads) grid_gather_kernel(
    const float *__restrict__ table, const Idx *__restrict__ idx,
    float *__restrict__ out, int64_t n_rows, int chunks, int64_t n_lanes) {
  const int64_t lane = blockIdx.x * static_cast<int64_t>(kThreads) +
                       threadIdx.x;
  if (lane >= n_lanes) return;
  int64_t r = static_cast<int64_t>(idx[lane]);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  if constexpr (kVec == 4) {
    const float4 *src = reinterpret_cast<const float4 *>(table) + r * chunks;
    float4 *dst = reinterpret_cast<float4 *>(out) + lane * chunks;
    for (int c = 0; c < chunks; ++c) dst[c] = __ldg(src + c);
  } else {
    for (int c = 0; c < chunks; ++c)
      out[lane * chunks + c] = __ldg(table + r * chunks + c);
  }
}

template <typename Idx>
void launch(const float *table, const Idx *idx, float *out, int64_t n_rows,
            int n_cols, int64_t n_lanes, bool vec4, cudaStream_t stream) {
  const int64_t blocks = (n_lanes + kThreads - 1) / kThreads;
  if (vec4) {
    grid_gather_kernel<Idx, 4><<<blocks, kThreads, 0, stream>>>(
        table, idx, out, n_rows, n_cols / 4, n_lanes);
  } else {
    grid_gather_kernel<Idx, 1><<<blocks, kThreads, 0, stream>>>(
        table, idx, out, n_rows, n_cols, n_lanes);
  }
}

// torch.clamp(x, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

// _corner0 along one axis: (c000's index, fractional weight)
__device__ __forceinline__ int32_t corner0(float p, int n, float &f) {
  const float g = clamp01(p) * static_cast<float>(n - 1);
  int32_t i = static_cast<int32_t>(g);
  const int32_t hi = n - 2 > 0 ? n - 2 : 0;
  i = i < 0 ? 0 : (i > hi ? hi : i);
  f = g - static_cast<float>(i);
  return i;
}

// _lerp8 of the 8 corners of one channel, c[k] = row[k * C]
__device__ __forceinline__ float lerp8(const float *c, int C, float fx,
                                       float fy, float fz) {
  const float c00 = c[0] * (1.0f - fx) + c[C] * fx;
  const float c01 = c[2 * C] * (1.0f - fx) + c[3 * C] * fx;
  const float c10 = c[4 * C] * (1.0f - fx) + c[5 * C] * fx;
  const float c11 = c[6 * C] * (1.0f - fx) + c[7 * C] * fx;
  const float c0 = c00 * (1.0f - fy) + c01 * fy;
  const float c1 = c10 * (1.0f - fy) + c11 * fy;
  return c0 * (1.0f - fz) + c1 * fz;
}

__global__ void __launch_bounds__(kThreads) grid_trilinear_kernel(
    const float *__restrict__ packed, const float *__restrict__ pl,
    const int32_t *__restrict__ slot, int64_t n_rows, int D, int H, int W,
    int C, int64_t n_lanes, float *__restrict__ out) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (j >= n_lanes) return;
  float fx, fy, fz;
  const int32_t x0 = corner0(pl[3 * j], W, fx);
  const int32_t y0 = corner0(pl[3 * j + 1], H, fy);
  const int32_t z0 = corner0(pl[3 * j + 2], D, fz);
  // int32 index arithmetic of the plain chain, wrapping like torch's
  const uint32_t u = static_cast<uint32_t>(slot[j]) *
                         static_cast<uint32_t>(D * H * W) +
                     (static_cast<uint32_t>(z0) * H + y0) * W + x0;
  int64_t r = static_cast<int32_t>(u);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  if (C == 1) {
    const float4 *row = reinterpret_cast<const float4 *>(packed) + 2 * r;
    const float4 a = __ldg(row), b = __ldg(row + 1);
    const float c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    out[j] = lerp8(c, 1, fx, fy, fz);
  } else {
    const float *row = packed + r * 8 * C;
    for (int ch = 0; ch < C; ++ch)
      out[j * C + ch] = lerp8(row + ch, C, fx, fy, fz);
  }
}

}  // namespace

// Launch on `stream` (no sync). vec4 needs n_cols % 4 == 0 and 16-byte
// aligned table and out. Returns cudaGetLastError() after the launch.
extern "C" int grid_gather_launch(const void *table, const void *idx,
                                  void *out, long long n_rows, int n_cols,
                                  long long n_lanes, int idx_is_64, int vec4,
                                  void *stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto *tab = static_cast<const float *>(table);
  auto *o = static_cast<float *>(out);
  if (idx_is_64) {
    launch(tab, static_cast<const int64_t *>(idx), o, n_rows, n_cols,
           n_lanes, vec4 != 0, s);
  } else {
    launch(tab, static_cast<const int32_t *>(idx), o, n_rows, n_cols,
           n_lanes, vec4 != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the trilinear lookup on `stream` (no sync): packed (n_rows, 8C),
// pl (n_lanes, 3), slot (n_lanes,) i32, out (n_lanes, C). Returns
// cudaGetLastError() after the launch.
extern "C" int grid_trilinear_launch(const void *packed, const void *pl,
                                     const void *slot, void *out,
                                     long long n_rows, int D, int H, int W,
                                     int C, long long n_lanes, void *stream) {
  if (n_lanes > 0) {
    const long long blocks = (n_lanes + kThreads - 1) / kThreads;
    grid_trilinear_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float *>(packed), static_cast<const float *>(pl),
        static_cast<const int32_t *>(slot), n_rows, D, H, W, C, n_lanes,
        static_cast<float *>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
