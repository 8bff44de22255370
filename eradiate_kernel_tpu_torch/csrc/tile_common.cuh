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
// Packed rows (ops/intersect.py::tile_rows): a tile is (128, 12) f32,
// [v0x v0y v0z e1x | e1y e1z e2x e2y | e2z prim shape 0] with prim and
// shape as int32 bits, so one triangle is three 128-bit loads (LDS.128 from
// the sweep's staged copy, LDG.128 straight from global memory in the BVH
// walks) instead of eleven
// scalar ones from three arrays; 1/det is __frcp_rn, the correctly rounded
// reciprocal, which gives the bits of IEEE 1.0f / det.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

constexpr int kRayBlock = 256;                   // the sweep's rays a block
constexpr int kTileK = 128;
constexpr int kWarps = kRayBlock / 32;
constexpr int kRowWords = 12;                    // floats per packed triangle
constexpr int kTileWords = kTileK * kRowWords;   // 1,536 floats, 6 KB

// the closest hit so far of one ray
struct Hit {
    float t, u, v;
    int32_t prim, shape;
};

// test one tile's packed rows s (shared or global) against one ray
// (origin o, direction d, in the tile's space); a hit stores the row's
// shape id plus shape_off
__device__ __forceinline__ void test_rows(const float *__restrict__ s,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float mint, int32_t shape_off,
                                          Hit &h) {
    const float4 *row = reinterpret_cast<const float4 *>(s);
#pragma unroll 2
    for (int q = 0; q < kTileK; ++q) {
        const float4 a = row[3 * q], b = row[3 * q + 1], c = row[3 * q + 2];
        const float v0x = a.x, v0y = a.y, v0z = a.z, e1x = a.w;
        const float e1y = b.x, e1z = b.y, e2x = b.z, e2y = b.w;
        const float e2z = c.x;
        const int32_t prim = __float_as_int(c.y);
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv_det = __frcp_rn(fabsf(det) < 1e-12f ? 1e-12f : det);
        const float tx = ox - v0x;
        const float ty = oy - v0y;
        const float tz = oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = fabsf(det) >= 1e-12f && u >= 0.0f && v >= 0.0f &&
                        u + v <= 1.0f && prim >= 0 && t >= mint && t < h.t;
        if (ok) {
            h.t = t;
            h.u = u;
            h.v = v;
            h.prim = prim;
            h.shape = __float_as_int(c.z) + shape_off;
        }
    }
}

// per-ray reciprocal direction, finite for zero components
// (pallas_intersect.py:256-259)
__device__ __forceinline__ float rcp(float d) {
    return (d < 0.0f ? -1.0f : 1.0f) / fmaxf(fabsf(d), 1e-30f);
}

// slab test of one ray against box [lo.xyz, hi.xyz] (pallas_intersect.py
// :267-280) with the far end capped at far_cap
__device__ __forceinline__ bool slab(const float *__restrict__ box, float ox,
                                     float oy, float oz, float ix, float iy,
                                     float iz, float mint, float far_cap,
                                     float &near) {
    const float t0x = (box[0] - ox) * ix;
    const float t1x = (box[3] - ox) * ix;
    const float t0y = (box[1] - oy) * iy;
    const float t1y = (box[4] - oy) * iy;
    const float t0z = (box[2] - oz) * iz;
    const float t1z = (box[5] - oz) * iz;
    near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                 fmaxf(fminf(t0z, t1z), mint));
    const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fminf(fmaxf(t0z, t1z), far_cap));
    return near <= far;
}

// the kernels' common output: t = inf and shape = -1 where nothing was hit
// below maxt
__device__ __forceinline__ void write_hit(
    const Hit &h, float maxt, int64_t r, float *__restrict__ t_out,
    float *__restrict__ uv_out, int32_t *__restrict__ prim_out,
    int32_t *__restrict__ shape_out) {
    const bool no_hit = h.t >= maxt;
    t_out[r] = no_hit ? INFINITY : h.t;
    uv_out[2 * r] = h.u;
    uv_out[2 * r + 1] = h.v;
    prim_out[r] = h.prim;
    shape_out[r] = no_hit ? -1 : h.shape;
}

}  // namespace tile
