// Binary tile-BVH traversal: closest ray/triangle hits for blocks of 256
// rays, walking the binary BVH over 128-triangle tiles as a block.
//
// Replaces the Pallas TPU kernel `_bvh_kernel` in
// eradiate_kernel_tpu/ops/pallas_intersect.py:206, launched through
// `_run_bvh` (:377). Contract (see ops/intersect.py):
//   rays  (nb*256, 8) f32 [ox oy oz dx dy dz mint maxt], maxt capped at the
//                         root box
//   nbox  (N, 1, 8) f32   node AABBs [lo.xyz, hi.xyz, 0, 0]
//   nmeta (N, 4) i32      [left, right, tile, inst]; tile >= 0 is a leaf
//   xf    (I+1, 12) f32   world-to-local affine rows, row 0 the identity
//   sbase (I+1,) i32      shape base of each instance, 0 in row 0
//   v0/e1/e2 (T, 128, 3) f32, prim/shape (T, 128) i32
// out t (n,) (inf on a miss), uv (n, 2), prim (n,), shape (n,) (-1 on a
// miss), stats (nb, 3) i32 [inner nodes visited, leaves visited, deepest
// stack]; a deepest stack of kStack + 1 reports an overflow, which ends
// the block's walk (the wrapper raises).
//
// Design: one thread block per ray block, one thread per ray, and the
// whole block walks the tree together as the TPU kernel does: one stack in
// shared memory, written by thread 0 behind a barrier. At an inner node
// each thread slab-tests both children; "some ray enters" is
// __syncthreads_or and a child's entry distance is the block minimum of
// `near` over the rays that enter. The nearer child is pushed last (popped
// first), the left one on a tie. At a leaf every thread moves its ray into
// the instance's space by the leaf's affine row (the ray parameter t is
// unchanged by an affine map) and runs the leaf test of tile_common.cuh;
// a block max of best_t after every leaf tightens the slab tests' far
// bound. The expressions, their order and the culling bound are the
// reference's (pallas_intersect.py:256-358), so the plain PyTorch version
// visits the same nodes and the two agree bit for bit.
//
// Bound on an H100: operations. Each leaf visit is 256 x 128 tests of 46
// FP32 operations on 5.6 KB of tile data; an inner visit is 2 x 256 slab
// tests of 26 operations on 80 bytes of node data.

#include "tile_common.cuh"

namespace {

using tile::kRayBlock;
using tile::kWarps;

constexpr int kStack = 64;   // pallas_intersect.py:203

// minima of a and b over the thread block; every thread gets both
__device__ __forceinline__ void block_min2(float &a, float &b, float *s_warp,
                                           float *s_out) {
    for (int off = 16; off > 0; off >>= 1) {
        a = fminf(a, __shfl_xor_sync(0xffffffffu, a, off));
        b = fminf(b, __shfl_xor_sync(0xffffffffu, b, off));
    }
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_warp[w] = a;
        s_warp[kWarps + w] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float ma = s_warp[0], mb = s_warp[kWarps];
        for (int i = 1; i < kWarps; ++i) {
            ma = fminf(ma, s_warp[i]);
            mb = fminf(mb, s_warp[kWarps + i]);
        }
        s_out[0] = ma;
        s_out[1] = mb;
    }
    __syncthreads();
    a = s_out[0];
    b = s_out[1];
}

__global__ void __launch_bounds__(kRayBlock) tile_bvh_kernel(
    const float *__restrict__ rays, const float *__restrict__ nbox,
    const int32_t *__restrict__ nmeta, const float *__restrict__ xf,
    const int32_t *__restrict__ sbase, const float *__restrict__ v0,
    const float *__restrict__ e1, const float *__restrict__ e2,
    const int32_t *__restrict__ prim, const int32_t *__restrict__ shape,
    float *__restrict__ t_out, float *__restrict__ uv_out,
    int32_t *__restrict__ prim_out, int32_t *__restrict__ shape_out,
    int32_t *__restrict__ stats_out) {
    __shared__ tile::TileSmem s_tile;
    __shared__ float s_warp[2 * kWarps], s_red[2];
    __shared__ int32_t s_stack[kStack];

    const int64_t b = blockIdx.x;
    const int tid = threadIdx.x;
    const int64_t r = b * kRayBlock + tid;
    const float *ray = rays + r * 8;
    const float ox = ray[0], oy = ray[1], oz = ray[2];
    const float dx = ray[3], dy = ray[4], dz = ray[5];
    const float mint = ray[6], maxt = ray[7];
    const float ix = tile::rcp(dx), iy = tile::rcp(dy), iz = tile::rcp(dz);

    tile::Hit h{maxt, 0.0f, 0.0f, 0, -1};
    float bt_ub = tile::block_max(maxt, s_warp, s_red);
    if (tid == 0) s_stack[0] = 0;   // the root
    __syncthreads();
    // sp, the stack and every decision below are block-uniform
    int sp = 1, n_inner = 0, n_leaf = 0, deepest = 1;
    while (sp > 0) {
        --sp;
        const int node = s_stack[sp];
        const int32_t *meta = nmeta + 4 * node;
        const int left = meta[0], right = meta[1], tile_id = meta[2];
        if (tile_id >= 0) {
            tile::leaf(s_tile, tile_id, meta[3] + 1, xf, sbase, v0, e1, e2,
                       prim, shape, ox, oy, oz, dx, dy, dz, mint, h);
            bt_ub = tile::block_max(h.t, s_warp, s_red);
            ++n_leaf;
            continue;
        }
        ++n_inner;
        const float far_cap = fminf(maxt, bt_ub);
        float near_l, near_r;
        const bool ok_l = tile::slab(nbox + 8 * left, ox, oy, oz, ix, iy,
                                     iz, mint, far_cap, near_l);
        const bool ok_r = tile::slab(nbox + 8 * right, ox, oy, oz, ix, iy,
                                     iz, mint, far_cap, near_r);
        const bool hit_l = __syncthreads_or(ok_l);
        const bool hit_r = __syncthreads_or(ok_r);
        near_l = ok_l ? near_l : INFINITY;
        near_r = ok_r ? near_r : INFINITY;
        block_min2(near_l, near_r, s_warp, s_red);
        // the near child on top (popped first); both missed: left first
        const bool l_first = near_l <= near_r;
        const int first = l_first ? left : right;
        const int second = l_first ? right : left;
        const bool push_first = l_first ? hit_l : hit_r;
        const bool push_second = l_first ? hit_r : hit_l;
        const int top = sp + push_first + push_second;
        if (top > kStack) {   // overflow: report it and end the walk
            deepest = kStack + 1;
            break;
        }
        if (tid == 0) {
            if (push_second) s_stack[sp] = second;
            if (push_first) s_stack[sp + push_second] = first;
        }
        sp = top;
        deepest = max(deepest, sp);
        __syncthreads();
    }

    tile::write_hit(h, maxt, r, t_out, uv_out, prim_out, shape_out);
    if (tid == 0) {
        stats_out[3 * b] = n_inner;
        stats_out[3 * b + 1] = n_leaf;
        stats_out[3 * b + 2] = deepest;
    }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError().
extern "C" int tile_bvh_launch(
    const void *rays, const void *nbox, const void *nmeta, const void *xf,
    const void *sbase, const void *v0, const void *e1, const void *e2,
    const void *prim, const void *shape, int n_blocks, void *t_out,
    void *uv_out, void *prim_out, void *shape_out, void *stats_out,
    void *stream) {
    if (n_blocks > 0) {
        tile_bvh_kernel<<<n_blocks, kRayBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float *>(rays),
            static_cast<const float *>(nbox),
            static_cast<const int32_t *>(nmeta),
            static_cast<const float *>(xf),
            static_cast<const int32_t *>(sbase),
            static_cast<const float *>(v0), static_cast<const float *>(e1),
            static_cast<const float *>(e2),
            static_cast<const int32_t *>(prim),
            static_cast<const int32_t *>(shape),
            static_cast<float *>(t_out), static_cast<float *>(uv_out),
            static_cast<int32_t *>(prim_out),
            static_cast<int32_t *>(shape_out),
            static_cast<int32_t *>(stats_out));
    }
    return static_cast<int>(cudaGetLastError());
}
