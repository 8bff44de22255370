// Shared pieces of the triangle-tile kernels (tile_sweep.cu, tile_bvh.cu,
// tile_bvh8.cu): the packed triangle rows and the leaf test of one
// 128-triangle tile.
//
// The leaf replaces `_intersect_tile` of
// eradiate_kernel_tpu/ops/pallas_intersect.py:40. Every thread tests its
// ray against the tile's 128 triangles in index order with a strict
// `t < best_t`, which is the reference's first-index argmin within a tile
// and its strict rule across tiles. Built with -fmad=false, the
// Moller-Trumbore arithmetic rounds every product and sum in the
// reference's expression order, as the plain PyTorch versions do, so
// kernels and plain versions agree bit for bit. The determinant guard keeps
// padding triangles (v0 = 1e30, e1 = e2 = 0, det = 0) from dividing by zero.
//
// Packed rows (ops/intersect.py::tile_rows): a tile is (128, 12) of the
// scene's float type T, [v0x v0y v0z e1x | e1y e1z e2x e2y | e2z prim
// shape 0]. In float32 prim and shape are int32 bits, so one triangle is
// three 128-bit loads (LDS.128 from the sweep's staged copy, LDG.128
// straight from global memory in the BVH walks) instead of eleven scalar
// ones from three arrays; in float64 (the double variants) they are exact
// doubles and a triangle is six 128-bit loads. 1/det is __frcp_rn /
// __drcp_rn, the correctly rounded reciprocal, which gives the bits of IEEE
// 1 / det.
//
// Every piece is a template on T (float or double): the sweep and both
// walks instantiate it twice, one entry per type. Constants are written
// T(c), which for float is the float literal c (each one checked to round
// the same way through double).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

constexpr int kRayBlock = 256;                   // the sweep's rays a block
constexpr int kTileK = 128;
constexpr int kWarps = kRayBlock / 32;
constexpr int kRowWords = 12;                    // scalars per triangle
constexpr int kTileWords = kTileK * kRowWords;   // 1,536: 6 KB f32, 12 f64

// fminf / fmaxf / fabsf and their double counterparts
__device__ __forceinline__ float tmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double tmin(double a, double b) {
    return fmin(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmax(double a, double b) {
    return fmax(a, b);
}
__device__ __forceinline__ float tabs(float a) { return fabsf(a); }
__device__ __forceinline__ double tabs(double a) { return fabs(a); }
// the correctly rounded reciprocal
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }

// one packed triangle: its 12 scalars from 16-byte loads
__device__ __forceinline__ void load_row(const float *__restrict__ s, int q,
                                         float (&w)[kRowWords]) {
    const float4 *row = reinterpret_cast<const float4 *>(s) + 3 * q;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float4 a = row[k];
        w[4 * k] = a.x;
        w[4 * k + 1] = a.y;
        w[4 * k + 2] = a.z;
        w[4 * k + 3] = a.w;
    }
}
__device__ __forceinline__ void load_row(const double *__restrict__ s, int q,
                                         double (&w)[kRowWords]) {
    const double2 *row = reinterpret_cast<const double2 *>(s) + 6 * q;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        const double2 a = row[k];
        w[2 * k] = a.x;
        w[2 * k + 1] = a.y;
    }
}

// a row's id slot: int32 bits in float32 rows, an exact double in float64
__device__ __forceinline__ int32_t row_id(float v) {
    return __float_as_int(v);
}
__device__ __forceinline__ int32_t row_id(double v) {
    return static_cast<int32_t>(v);
}

// the closest hit so far of one ray
template <typename T>
struct Hit {
    T t, u, v;
    int32_t prim, shape;
};

// test one tile's packed rows s (shared or global) against one ray
// (origin o, direction d, in the tile's space); a hit stores the row's
// shape id plus shape_off
template <typename T>
__device__ __forceinline__ void test_rows(const T *__restrict__ s, T ox,
                                          T oy, T oz, T dx, T dy, T dz,
                                          T mint, int32_t shape_off,
                                          Hit<T> &h) {
#pragma unroll 2
    for (int q = 0; q < kTileK; ++q) {
        T w[kRowWords];
        load_row(s, q, w);
        const T v0x = w[0], v0y = w[1], v0z = w[2], e1x = w[3];
        const T e1y = w[4], e1z = w[5], e2x = w[6], e2y = w[7];
        const T e2z = w[8];
        const int32_t prim = row_id(w[9]);
        const T px = dy * e2z - dz * e2y;
        const T py = dz * e2x - dx * e2z;
        const T pz = dx * e2y - dy * e2x;
        const T det = e1x * px + e1y * py + e1z * pz;
        const T inv_det = rcp_rn(tabs(det) < T(1e-12) ? T(1e-12) : det);
        const T tx = ox - v0x;
        const T ty = oy - v0y;
        const T tz = oz - v0z;
        const T u = (tx * px + ty * py + tz * pz) * inv_det;
        const T qx = ty * e1z - tz * e1y;
        const T qy = tz * e1x - tx * e1z;
        const T qz = tx * e1y - ty * e1x;
        const T v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const T t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = tabs(det) >= T(1e-12) && u >= T(0) && v >= T(0) &&
                        u + v <= T(1) && prim >= 0 && t >= mint && t < h.t;
        if (ok) {
            h.t = t;
            h.u = u;
            h.v = v;
            h.prim = prim;
            h.shape = row_id(w[10]) + shape_off;
        }
    }
}

// per-ray reciprocal direction, finite for zero components
// (pallas_intersect.py:256-259)
template <typename T>
__device__ __forceinline__ T rcp(T d) {
    return (d < T(0) ? T(-1) : T(1)) / tmax(tabs(d), T(1e-30));
}

// slab test of one ray against box [lo.xyz, hi.xyz] (pallas_intersect.py
// :267-280) with the far end capped at far_cap
template <typename T>
__device__ __forceinline__ bool slab(const T *__restrict__ box, T ox, T oy,
                                     T oz, T ix, T iy, T iz, T mint,
                                     T far_cap, T &near) {
    const T t0x = (box[0] - ox) * ix;
    const T t1x = (box[3] - ox) * ix;
    const T t0y = (box[1] - oy) * iy;
    const T t1y = (box[4] - oy) * iy;
    const T t0z = (box[2] - oz) * iz;
    const T t1z = (box[5] - oz) * iz;
    near = tmax(tmax(tmin(t0x, t1x), tmin(t0y, t1y)),
                tmax(tmin(t0z, t1z), mint));
    const T far = tmin(tmin(tmax(t0x, t1x), tmax(t0y, t1y)),
                       tmin(tmax(t0z, t1z), far_cap));
    return near <= far;
}

// the kernels' common output: t = inf and shape = -1 where nothing was hit
// below maxt
template <typename T>
__device__ __forceinline__ void write_hit(
    const Hit<T> &h, T maxt, int64_t r, T *__restrict__ t_out,
    T *__restrict__ uv_out, int32_t *__restrict__ prim_out,
    int32_t *__restrict__ shape_out) {
    const bool no_hit = h.t >= maxt;
    t_out[r] = no_hit ? T(INFINITY) : h.t;
    uv_out[2 * r] = h.u;
    uv_out[2 * r + 1] = h.v;
    prim_out[r] = h.prim;
    shape_out[r] = no_hit ? -1 : h.shape;
}

}  // namespace tile
