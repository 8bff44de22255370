// Shared pieces of the triangle-tile kernels (tile_sweep.cu, tile_bvh.cu,
// tile_bvh8.cu): one thread block per block of 256 rays, one thread per
// ray, and the leaf test of one 128-triangle tile.
//
// The leaf replaces `_intersect_tile` of
// eradiate_kernel_tpu/ops/pallas_intersect.py:40. The tile is staged in
// shared memory; every thread tests its 128 triangles in index order with
// a strict `t < best_t`, which is the reference's first-index argmin within
// a tile and its strict rule across tiles. Built with -fmad=false, the
// Moller-Trumbore arithmetic rounds every product and sum in the
// reference's expression order, as the plain PyTorch versions do, so
// kernels and plain versions agree bit for bit. The determinant guard keeps
// padding triangles (v0 = 1e30, e1 = e2 = 0, det = 0) from dividing by zero.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

constexpr int kRayBlock = 256;
constexpr int kTileK = 128;
constexpr int kWarps = kRayBlock / 32;

// max over the thread block; every thread gets the result. Its two
// barriers also order shared-memory reads before the caller's next writes.
__device__ __forceinline__ float block_max(float v, float *s_warp,
                                           float *s_out) {
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        float m = s_warp[0];
        for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_warp[w]);
        *s_out = m;
    }
    __syncthreads();
    return *s_out;
}

// one tile's triangles and ids in shared memory (5.5 KB)
struct TileSmem {
    float v0[kTileK * 3], e1[kTileK * 3], e2[kTileK * 3];
    int32_t prim[kTileK], shape[kTileK];
};

// the closest hit so far of one ray
struct Hit {
    float t, u, v;
    int32_t prim, shape;
};

// copy tile j into shared memory and make it visible to the block
__device__ __forceinline__ void stage_tile(
    TileSmem &s, int64_t j, const float *__restrict__ v0,
    const float *__restrict__ e1, const float *__restrict__ e2,
    const int32_t *__restrict__ prim, const int32_t *__restrict__ shape) {
    const int tid = threadIdx.x;
    for (int i = tid; i < kTileK * 3; i += kRayBlock) {
        s.v0[i] = v0[j * kTileK * 3 + i];
        s.e1[i] = e1[j * kTileK * 3 + i];
        s.e2[i] = e2[j * kTileK * 3 + i];
    }
    if (tid < kTileK) {
        s.prim[tid] = prim[j * kTileK + tid];
        s.shape[tid] = shape[j * kTileK + tid];
    }
    __syncthreads();
}

// test the staged tile against one ray (origin o, direction d, in the
// tile's space); a hit stores the tile's shape id plus shape_off
__device__ __forceinline__ void test_tile(
    const TileSmem &s, float ox, float oy, float oz, float dx, float dy,
    float dz, float mint, int32_t shape_off, Hit &h) {
    for (int q = 0; q < kTileK; ++q) {
        const float v0x = s.v0[3 * q], v0y = s.v0[3 * q + 1],
                    v0z = s.v0[3 * q + 2];
        const float e1x = s.e1[3 * q], e1y = s.e1[3 * q + 1],
                    e1z = s.e1[3 * q + 2];
        const float e2x = s.e2[3 * q], e2y = s.e2[3 * q + 1],
                    e2z = s.e2[3 * q + 2];
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
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
                        u + v <= 1.0f && s.prim[q] >= 0 && t >= mint &&
                        t < h.t;
        if (ok) {
            h.t = t;
            h.u = u;
            h.v = v;
            h.prim = s.prim[q];
            h.shape = s.shape[q] + shape_off;
        }
    }
}

// per-ray reciprocal direction, finite for zero components
// (pallas_intersect.py:256-259)
__device__ __forceinline__ float rcp(float d) {
    return (d < 0.0f ? -1.0f : 1.0f) / fmaxf(fabsf(d), 1e-30f);
}

// slab test of one ray against box [lo.xyz, hi.xyz] (pallas_intersect.py
// :267-280); far_cap = min(maxt, block bound on best t)
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

// a leaf: the ray moved into instance space by xf row k, then the tile
__device__ __forceinline__ void leaf(
    TileSmem &s_tile, int64_t tile_id, int k,
    const float *__restrict__ xf, const int32_t *__restrict__ sbase,
    const float *__restrict__ v0, const float *__restrict__ e1,
    const float *__restrict__ e2, const int32_t *__restrict__ prim,
    const int32_t *__restrict__ shape, float ox, float oy, float oz,
    float dx, float dy, float dz, float mint, Hit &h) {
    const float *m = xf + 12 * k;
    const float lox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
    const float loy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
    const float loz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
    const float ldx = m[0] * dx + m[1] * dy + m[2] * dz;
    const float ldy = m[4] * dx + m[5] * dy + m[6] * dz;
    const float ldz = m[8] * dx + m[9] * dy + m[10] * dz;
    stage_tile(s_tile, tile_id, v0, e1, e2, prim, shape);
    test_tile(s_tile, lox, loy, loz, ldx, ldy, ldz, mint, sbase[k], h);
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
