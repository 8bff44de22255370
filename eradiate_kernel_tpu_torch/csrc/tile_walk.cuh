// The warp walk shared by the tile-BVH kernels (tile_bvh.cu, tile_bvh8.cu):
// the 32 rays of a warp walk the tree together with one stack, as the TPU
// kernels walk it with a block of 256 rays. kGroup is a compile-time
// constant (ops/intersect.py's BVH_GROUP). On an H100 the TPU's 256-ray
// group, built with one block barrier a step, took 1.3-4x the warp's time
// on every load (PERF.md), so only the warp is built.
//
// No block barrier: every fold is a warp shuffle or ballot, and lane 0
// pushes onto the warp's stack in shared memory behind __syncwarp. The
// culling bound is the warp's largest best t.
//
// Leaves read packed rows (tile_common.cuh) straight from global memory:
// all 32 lanes load the same triangle at once, a broadcast LDG.128 through
// L1, so the block holds no shared rows (staging per warp was measured no
// faster: PERF.md). The walk is a template on the scene's float type, as
// the leaf is.

#pragma once

#include "tile_common.cuh"

namespace walk {

constexpr int kGroup = 32;       // rays a group (BVH_GROUP), one warp
constexpr int kRayBlock = 256;   // rays the wrappers pad to (RAY_BLOCK)
// threads a block: a small block frees its slots as soon as its warps
// finish (in a block of 256 one slow warp holds seven more)
constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kStack = 64;       // pallas_intersect.py:203
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
    for (int off = 16; off > 0; off >>= 1)
        v = tile::tmin(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
    for (int off = 16; off > 0; off >>= 1)
        v = tile::tmax(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

// a leaf: tile `tile_id` under instance row k (inst + 1) tested from its
// global rows; returns the warp's new culling bound (largest best t)
template <typename T>
__device__ __forceinline__ T leaf(const T *__restrict__ rows,
                                  int64_t tile_id, int k,
                                  const T *__restrict__ xf,
                                  const int32_t *__restrict__ sbase, T ox,
                                  T oy, T oz, T dx, T dy, T dz, T mint,
                                  tile::Hit<T> &h) {
    // the ray in the instance's space (an affine map keeps t)
    const T *m = xf + 12 * k;
    const T lox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
    const T loy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
    const T loz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
    const T ldx = m[0] * dx + m[1] * dy + m[2] * dz;
    const T ldy = m[4] * dx + m[5] * dy + m[6] * dz;
    const T ldz = m[8] * dx + m[9] * dy + m[10] * dz;
    tile::test_rows(rows + tile_id * tile::kTileWords, lox, loy, loz, ldx,
                    ldy, ldz, mint, sbase[k], h);
    return warp_max(h.t);
}

// the walk's per-warp stats [inner nodes visited, leaves visited, deepest
// stack], written by lane 0 of ray r's warp
__device__ __forceinline__ void write_stats(int64_t r, int n_inner,
                                            int n_leaf, int deepest,
                                            int32_t *__restrict__ stats_out) {
    if ((r & (kGroup - 1)) == 0) {
        const int64_t grp = r / kGroup;
        stats_out[3 * grp] = n_inner;
        stats_out[3 * grp + 1] = n_leaf;
        stats_out[3 * grp + 2] = deepest;
    }
}

}  // namespace walk
