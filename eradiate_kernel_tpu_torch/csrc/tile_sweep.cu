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
// walks its admitted list; for each tile it stages the 128 triangles in
// shared memory and every thread runs the leaf test of tile_common.cuh.
// Before each tile a block max-reduction of best_t is held against the
// tile's tnear: once no ray of the block can improve, the walk stops (the
// reference's early exit, pallas_intersect.py:118-122).
//
// Bound on an H100: operations. Each visit is 256 x 128 tests of 46 FP32
// operations against 5.6 KB of tile data, far above the card's
// FLOP-per-byte balance, so the bound is tests x 46 / 67 TFLOP/s (FP32,
// non-tensor). Shared-memory staging keeps the per-visit device-memory
// traffic to one tile read; the triangle reads in the inner loop are
// broadcasts (every thread reads the same address).

#include "tile_common.cuh"

namespace {

using tile::kRayBlock;

__global__ void __launch_bounds__(kRayBlock) tile_sweep_kernel(
    const float *__restrict__ rays, const int32_t *__restrict__ ids,
    const int32_t *__restrict__ count, const float *__restrict__ tnear,
    const float *__restrict__ v0, const float *__restrict__ e1,
    const float *__restrict__ e2, const int32_t *__restrict__ prim,
    const int32_t *__restrict__ shape, int n_tiles,
    float *__restrict__ t_out, float *__restrict__ uv_out,
    int32_t *__restrict__ prim_out, int32_t *__restrict__ shape_out,
    int32_t *__restrict__ visited_out) {
    __shared__ tile::TileSmem s_tile;
    __shared__ float s_warp[tile::kWarps], s_bt_ub;

    const int64_t b = blockIdx.x;
    const int tid = threadIdx.x;
    const int64_t r = b * kRayBlock + tid;
    const float *ray = rays + r * 8;
    const float ox = ray[0], oy = ray[1], oz = ray[2];
    const float dx = ray[3], dy = ray[4], dz = ray[5];
    const float mint = ray[6], maxt = ray[7];

    tile::Hit h{maxt, 0.0f, 0.0f, 0, -1};
    const int cnt = count[b];
    const int32_t *b_ids = ids + b * n_tiles;
    const float *b_tnear = tnear + b * n_tiles;
    float bt_ub = tile::block_max(maxt, s_warp, &s_bt_ub);
    int k = 0;
    // bt_ub and tnear are block-uniform, so every thread leaves together
    for (; k < cnt && bt_ub > b_tnear[k]; ++k) {
        tile::stage_tile(s_tile, b_ids[k], v0, e1, e2, prim, shape);
        tile::test_tile(s_tile, ox, oy, oz, dx, dy, dz, mint, 0, h);
        // also orders this tile's shared reads before the next overwrite
        bt_ub = tile::block_max(h.t, s_warp, &s_bt_ub);
    }
    tile::write_hit(h, maxt, r, t_out, uv_out, prim_out, shape_out);
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
