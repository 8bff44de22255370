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
// textures/volumes.py::trilinear_backward_plain). It replaces no TPU
// kernel: the JAX package transposes its gather in XLA. Contract:
//   ct (L, C) f32, pl (L, 3) f32, slot (L,) i32 as the lookup took them;
//   d_grid (S*D*H*W*C) f32, zeroed by the caller, 16-byte aligned.
// Each lane adds ct[j, c] times the weight _lerp8 gives corner k,
// ((ct (1 - fz|fz)) (1 - fy|fy)) (1 - fx|fx), into the 8 voxels
// (s, min(z + dz, D - 1), min(y + dy, H - 1), min(x + dx, W - 1)) of its
// row's voxel (s, z, y, x), the edge-clamped neighbours packed_corners
// stores. Each product rounds as the plain version's does; the sums land
// in an order that changes from run to run. Bound on an H100: bytes, L x
// (12 + 4 + 4C) read plus 4C bytes for each distinct voxel the lanes'
// corners touch, written once, over 3.35 TB/s.
//
// Design for Hopper: the atomics, not the arithmetic, bound it. d_grid is
// channel-last, so a voxel's C channels are adjacent, and a thread takes
// one chunk of kVec channels of one lane (a block is (chunks, lanes), the
// chunk fastest): float4 reductions (red.global.add.v4.f32, sm_90) when C
// is a multiple of 4, float2 when it is even, else one channel a thread,
// so a warp's scalar reductions fall on consecutive floats. At C = 1 the
// x-neighbours v and v + 1 go as one float2 reduction where v is even.
// The voxel comes from corner c000's x0, y0, z0 (no division) unless the
// row was wrapped or clamped, where it is split in 32 bits (the row is a
// clamped int32). The adjoint's lanes crowd few rows (the largest call of
// the 64^3 atmosphere's value+grad puts 32,768 lanes on 89 rows), so the
// lanes of a warp on one row are grouped by __match_any_sync once
// neighbouring lanes share a row; the group's lowest lane sums the
// group's products by shuffles (pointer doubling) and issues its
// reductions. float64 takes the same mapping one channel a thread, with
// scalar atomicAdd (Hopper has no vector float64 reduction).

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

// the packed row slot*D*H*W + (z0*H + y0)*W + x0 in the plain chain's
// int32 arithmetic (wrapping like torch's), clamped as the gather clamps it
__device__ __forceinline__ int64_t packed_row(int32_t slot, int32_t x0,
                                              int32_t y0, int32_t z0,
                                              int64_t n_rows, int D, int H,
                                              int W) {
  const uint32_t u = static_cast<uint32_t>(slot) *
                         static_cast<uint32_t>(D * H * W) +
                     (static_cast<uint32_t>(z0) * H + y0) * W + x0;
  const int64_t r = static_cast<int32_t>(u);
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

// corner c000's packed row of lane j and the three fractions
template <typename T>
__device__ __forceinline__ int64_t corner_row(const T *pl,
                                              const int32_t *slot, int64_t j,
                                              int64_t n_rows, int D, int H,
                                              int W, T &fx, T &fy, T &fz) {
  const int32_t x0 = corner0(pl[3 * j], W, fx);
  const int32_t y0 = corner0(pl[3 * j + 1], H, fy);
  const int32_t z0 = corner0(pl[3 * j + 2], D, fz);
  return packed_row(slot[j], x0, y0, z0, n_rows, D, H, W);
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

// one reduction of kVec channels at p (a global address): scalar
// atomicAdd (SASS RED), or Hopper's vector reductions of 2 or 4 floats
__device__ __forceinline__ void red(float *p, const float (&v)[1]) {
  atomicAdd(p, v[0]);
}
__device__ __forceinline__ void red(double *p, const double (&v)[1]) {
  atomicAdd(p, v[0]);
}
__device__ __forceinline__ void red(float *p, const float (&v)[2]) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};"
               :: "l"(__cvta_generic_to_global(p)), "f"(v[0]), "f"(v[1])
               : "memory");
}
__device__ __forceinline__ void red(float *p, const float (&v)[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(__cvta_generic_to_global(p)), "f"(v[0]), "f"(v[1]),
                  "f"(v[2]), "f"(v[3])
               : "memory");
}

// Warp aggregation: the lanes of a warp with the same key (corner c000's
// row and the chunk) form a group, and its lowest lane gets the group's
// sum of v and alone returns true. Only a warp in which some thread
// shares its row with the thread bx lanes below it (the same chunk of
// the previous lane: neighbouring camera samples) groups its lanes, so
// random lanes pay one shuffle and one vote. The sum is taken by pointer
// doubling in ceil(log2(group size)) shuffle rounds: each lane adds the
// partial sum of the member `span` places above it in its group, a fixed
// order for a given assignment of lanes. Every lane of the warp calls it.
template <typename T, int kN>
__device__ __forceinline__ bool aggregate(T (&v)[kN], unsigned long long key,
                                          uint32_t row, unsigned lane,
                                          unsigned bx) {
  const uint32_t below = __shfl_up_sync(~0u, row, bx);
  if (!__any_sync(~0u, lane >= bx && below == row)) return true;
  const unsigned peers = __match_any_sync(~0u, key);
  const unsigned most = __reduce_max_sync(~0u, __popc(peers));
  // the next member of the group above this lane, 32 for none
  const unsigned above = peers & ~((2u << lane) - 1);
  int next = above != 0 ? __ffs(above) - 1 : 32;
  for (unsigned span = 1; span < most; span <<= 1) {
    const int src = next < 32 ? next : static_cast<int>(lane);
    for (int i = 0; i < kN; ++i) {
      const T o = __shfl_sync(~0u, v[i], src);
      if (next < 32) v[i] += o;
    }
    const int after = __shfl_sync(~0u, next, src);
    next = next < 32 ? after : 32;
  }
  return (peers & ((1u << lane) - 1)) == 0;
}

// A block is (bx, by): threadIdx.x the chunk (kVec channels), threadIdx.y
// the lane; bx * by is a multiple of 32, so warps are whole. When C / kVec
// exceeds bx a thread takes chunks threadIdx.x, + bx, ...
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) grid_trilinear_bwd_kernel(
    const T *__restrict__ ct, const T *__restrict__ pl,
    const int32_t *__restrict__ slot, int64_t n_rows, int D, int H, int W,
    int C, int64_t n_lanes, T *__restrict__ d_grid) {
  const int64_t j0 = blockIdx.x * static_cast<int64_t>(blockDim.y) +
                     threadIdx.y;
  const bool lane_ok = j0 < n_lanes;
  if (!__any_sync(~0u, lane_ok)) return;  // the whole warp is past the end
  // a thread past the end works on the last lane and adds nothing
  const int64_t j = lane_ok ? j0 : n_lanes - 1;
  T fx, fy, fz;
  int32_t xyz[3] = {corner0(pl[3 * j], W, fx), corner0(pl[3 * j + 1], H, fy),
                    corner0(pl[3 * j + 2], D, fz)};
  const int64_t r =
      packed_row(slot[j], xyz[0], xyz[1], xyz[2], n_rows, D, H, W);
  // the row's voxel: (x0, y0, z0) when the row is exact (neither wrapped
  // nor clamped), else the split of the clamped row (0 <= r < 2^31: 32
  // bits suffice)
  if (r != static_cast<int64_t>(slot[j]) * (static_cast<int64_t>(D) * H * W) +
               (static_cast<int64_t>(xyz[2]) * H + xyz[1]) * W + xyz[0]) {
    const uint32_t u = static_cast<uint32_t>(r);
    const uint32_t t = u / static_cast<uint32_t>(W);
    xyz[0] = static_cast<int32_t>(u - t * static_cast<uint32_t>(W));
    xyz[1] = static_cast<int32_t>(t % static_cast<uint32_t>(H));
    xyz[2] = static_cast<int32_t>((t / static_cast<uint32_t>(H)) %
                                  static_cast<uint32_t>(D));
  }
  // the +1 neighbours' strides, 0 on the last face (edge-clamped)
  const int64_t sx = xyz[0] + 1 < W ? 1 : 0;
  const int64_t sy = xyz[1] + 1 < H ? W : 0;
  const int64_t sz = xyz[2] + 1 < D ? static_cast<int64_t>(H) * W : 0;
  const T wx[2] = {T(1) - fx, fx}, wy[2] = {T(1) - fy, fy},
          wz[2] = {T(1) - fz, fz};
  const unsigned lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
  const int chunks = C / kVec;
  for (int q0 = 0; q0 < chunks; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    const bool ok = lane_ok && q < chunks;
    T g[kVec];
    for (int i = 0; i < kVec; ++i)
      g[i] = ok ? ct[j * C + q * kVec + i] : T(0);
    // val[k * kVec + i]: corner k's product for channel i of the chunk
    T val[8 * kVec];
    for (int dz = 0; dz < 2; ++dz)
      for (int dy = 0; dy < 2; ++dy)
        for (int i = 0; i < kVec; ++i) {
          const T gzy = g[i] * wz[dz] * wy[dy];
          val[(4 * dz + 2 * dy) * kVec + i] = gzy * wx[0];
          val[(4 * dz + 2 * dy + 1) * kVec + i] = gzy * wx[1];
        }
    // the sentinel ~0 (no row is 2^32 - 1) keeps idle threads apart
    const unsigned long long key =
        ok ? (static_cast<unsigned long long>(r) << 32) | q : ~0ull;
    if (!aggregate(val, key, static_cast<uint32_t>(r), lane, blockDim.x) ||
        !ok)
      continue;
    T *dst = d_grid + r * C + q * kVec;
    for (int k = 0; k < 8; k += 2) {
      const int64_t off = ((k >> 2) ? sz : 0) + ((k >> 1) & 1 ? sy : 0);
      T *p = dst + off * C;
      T lo[kVec], hi[kVec];
      for (int i = 0; i < kVec; ++i) {
        lo[i] = val[k * kVec + i];
        hi[i] = val[(k + 1) * kVec + i];
      }
      if constexpr (kVec == 1 && sizeof(T) == 4) {
        // C = 1: v and v + 1 as one float2 where v is even
        if (C == 1 && sx == 1 && ((r + off) & 1) == 0) {
          const float pair[2] = {lo[0], hi[0]};
          red(p, pair);
          continue;
        }
      }
      red(p, lo);
      red(p + sx * C, hi);
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

template <typename T, int kVec>
void launch_bwd(const void *ct, const void *pl, const void *slot,
                void *d_grid, long long n_rows, int D, int H, int W, int C,
                long long n_lanes, cudaStream_t stream) {
  // (chunks, lanes) blocks of 256, 192 or 160 threads: whole warps
  const int chunks = C / kVec;
  const int bx = chunks < 8 ? chunks : 8;
  const int by = 32 * (8 / bx);
  const long long blocks = (n_lanes + by - 1) / by;
  grid_trilinear_bwd_kernel<T, kVec>
      <<<blocks, dim3(bx, by), 0, stream>>>(
          static_cast<const T *>(ct), static_cast<const T *>(pl),
          static_cast<const int32_t *>(slot), n_rows, D, H, W, C, n_lanes,
          static_cast<T *>(d_grid));
}

template <typename T>
int trilinear_bwd(const void *ct, const void *pl, const void *slot,
                  void *d_grid, long long n_rows, int D, int H, int W, int C,
                  long long n_lanes, void *stream) {
  if (n_lanes > 0 && C > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if constexpr (sizeof(T) == 4) {
      if (C % 4 == 0) {
        launch_bwd<T, 4>(ct, pl, slot, d_grid, n_rows, D, H, W, C, n_lanes,
                         s);
        return static_cast<int>(cudaGetLastError());
      }
      if (C % 2 == 0) {
        launch_bwd<T, 2>(ct, pl, slot, d_grid, n_rows, D, H, W, C, n_lanes,
                         s);
        return static_cast<int>(cudaGetLastError());
      }
    }
    launch_bwd<T, 1>(ct, pl, slot, d_grid, n_rows, D, H, W, C, n_lanes, s);
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
// (n_rows * C), n_rows = S * D * H * W, zeroed by the caller and 16-byte
// aligned (the vector reductions). Returns
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
