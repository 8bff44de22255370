// Flat tile sweep: closest ray/triangle hits for blocks of 256 rays over
// their admitted 128-triangle tiles.
//
// Replaces the Pallas TPU kernel `_kernel` in
// eradiate_kernel_tpu/ops/pallas_intersect.py:94 (leaf `_intersect_tile`,
// :40), launched through `_run` (:155). Contract (see ops/intersect.py):
//   rays  (nb*256, 8) f32  [ox oy oz dx dy dz mint maxt], maxt already capped
//   ids   (nb, T) i32      admitted tiles of each block, near to far
//   tnear (nb, T) f32      entry lower bound of each admitted tile
//   count (nb,) i32        number of admitted tiles
//   v0/e1/e2 (T, 128, 3) f32, prim/shape (T, 128) i32
// out t (n,) (inf on a miss), uv (n, 2), prim (n,), shape (n,) (-1 on a
// miss), visited (nb,) tiles swept per block.
//
// Design: one thread block per ray block, one thread per ray. The block
// walks its admitted list; for each tile it stages the 128 triangles
// (v0/e1/e2 + prim + shape, 5.5 KB) in shared memory, then every thread
// tests them in index order with a strict `t < best_t`, which reproduces
// the reference's first-index argmin within a tile and its strict
// cross-tile rule. Before each tile a block max-reduction of best_t is held
// against the tile's tnear: once no ray of the block can improve, the walk
// stops (the reference's early exit, pallas_intersect.py:118-122).
//
// Bound on an H100: operations. Each visit is 256 x 128 tests of 46 FP32
// operations against 5.6 KB of tile data, far above the card's
// FLOP-per-byte balance, so the bound is tests x 46 / 67 TFLOP/s (FP32,
// non-tensor). Shared-memory staging keeps the per-visit device-memory
// traffic to one tile read; the triangle reads in the inner loop are
// broadcasts (every thread reads the same address).
//
// Build with -fmad=false: the arithmetic below is the reference's
// expression order with every product and sum rounded, as eager PyTorch
// rounds it, so the kernel and its plain version agree bit for bit. The
// determinant guard keeps padding triangles (v0 = 1e30, e1 = e2 = 0,
// det = 0) from dividing by zero.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRayBlock = 256;
constexpr int kTileK = 128;
constexpr int kWarps = kRayBlock / 32;

// max over the thread block; every thread gets the result
__device__ float block_max(float v, float *s_warp, float *s_out) {
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

__global__ void __launch_bounds__(kRayBlock) tile_sweep_kernel(
    const float *__restrict__ rays, const int32_t *__restrict__ ids,
    const int32_t *__restrict__ count, const float *__restrict__ tnear,
    const float *__restrict__ v0, const float *__restrict__ e1,
    const float *__restrict__ e2, const int32_t *__restrict__ prim,
    const int32_t *__restrict__ shape, int n_tiles,
    float *__restrict__ t_out, float *__restrict__ uv_out,
    int32_t *__restrict__ prim_out, int32_t *__restrict__ shape_out,
    int32_t *__restrict__ visited_out) {
    __shared__ float s_v0[kTileK * 3], s_e1[kTileK * 3], s_e2[kTileK * 3];
    __shared__ int32_t s_prim[kTileK], s_shape[kTileK];
    __shared__ float s_warp[kWarps], s_bt_ub;

    const int64_t b = blockIdx.x;
    const int tid = threadIdx.x;
    const float *ray = rays + (b * kRayBlock + tid) * 8;
    const float ox = ray[0], oy = ray[1], oz = ray[2];
    const float dx = ray[3], dy = ray[4], dz = ray[5];
    const float mint = ray[6], maxt = ray[7];

    float best_t = maxt, best_u = 0.0f, best_v = 0.0f;
    int32_t best_prim = 0, best_shape = -1;

    const int cnt = count[b];
    const int32_t *b_ids = ids + b * n_tiles;
    const float *b_tnear = tnear + b * n_tiles;
    float bt_ub = block_max(maxt, s_warp, &s_bt_ub);
    int k = 0;
    // bt_ub and tnear are block-uniform, so every thread leaves together
    for (; k < cnt && bt_ub > b_tnear[k]; ++k) {
        const int64_t j = b_ids[k];
        for (int i = tid; i < kTileK * 3; i += kRayBlock) {
            s_v0[i] = v0[j * kTileK * 3 + i];
            s_e1[i] = e1[j * kTileK * 3 + i];
            s_e2[i] = e2[j * kTileK * 3 + i];
        }
        if (tid < kTileK) {
            s_prim[tid] = prim[j * kTileK + tid];
            s_shape[tid] = shape[j * kTileK + tid];
        }
        __syncthreads();
        // strict t < best_t in index order = the reference's tile-wide
        // argmin (first index on ties) of the hits below the entry best_t
        for (int q = 0; q < kTileK; ++q) {
            const float v0x = s_v0[3 * q], v0y = s_v0[3 * q + 1],
                        v0z = s_v0[3 * q + 2];
            const float e1x = s_e1[3 * q], e1y = s_e1[3 * q + 1],
                        e1z = s_e1[3 * q + 2];
            const float e2x = s_e2[3 * q], e2y = s_e2[3 * q + 1],
                        e2z = s_e2[3 * q + 2];
            const float px = dy * e2z - dz * e2y;
            const float py = dz * e2x - dx * e2z;
            const float pz = dx * e2y - dy * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const float inv_det =
                1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
            const float tx = ox - v0x;
            const float ty = oy - v0y;
            const float tz = oz - v0z;
            const float u = (tx * px + ty * py + tz * pz) * inv_det;
            const float qx = ty * e1z - tz * e1y;
            const float qy = tz * e1x - tx * e1z;
            const float qz = tx * e1y - ty * e1x;
            const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
            const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
            const bool ok = fabsf(det) >= 1e-12f && u >= 0.0f &&
                            v >= 0.0f && u + v <= 1.0f && s_prim[q] >= 0 &&
                            t >= mint && t < best_t;
            if (ok) {
                best_t = t;
                best_u = u;
                best_v = v;
                best_prim = s_prim[q];
                best_shape = s_shape[q];
            }
        }
        // also orders this tile's shared reads before the next overwrite
        bt_ub = block_max(best_t, s_warp, &s_bt_ub);
    }

    const int64_t r = b * kRayBlock + tid;
    const bool no_hit = best_t >= maxt;
    t_out[r] = no_hit ? INFINITY : best_t;
    uv_out[2 * r] = best_u;
    uv_out[2 * r + 1] = best_v;
    prim_out[r] = best_prim;
    shape_out[r] = no_hit ? -1 : best_shape;
    if (tid == 0) visited_out[b] = k;
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError().
extern "C" int tile_sweep_launch(
    const void *rays, const void *ids, const void *count, const void *tnear,
    const void *v0, const void *e1, const void *e2, const void *prim,
    const void *shape, int n_blocks, int n_tiles, void *t_out, void *uv_out,
    void *prim_out, void *shape_out, void *visited_out, void *stream) {
    if (n_blocks > 0) {
        tile_sweep_kernel<<<n_blocks, kRayBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float *>(rays),
            static_cast<const int32_t *>(ids),
            static_cast<const int32_t *>(count),
            static_cast<const float *>(tnear),
            static_cast<const float *>(v0), static_cast<const float *>(e1),
            static_cast<const float *>(e2),
            static_cast<const int32_t *>(prim),
            static_cast<const int32_t *>(shape), n_tiles,
            static_cast<float *>(t_out), static_cast<float *>(uv_out),
            static_cast<int32_t *>(prim_out),
            static_cast<int32_t *>(shape_out),
            static_cast<int32_t *>(visited_out));
    }
    return static_cast<int>(cudaGetLastError());
}
