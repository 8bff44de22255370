// 8-wide tile-BVH traversal: closest ray/triangle hits for warps of 32 rays
// walking the 8-wide BVH over 128-triangle tiles together.
//
// Replaces the Pallas TPU kernel `_bvh8_kernel` in
// eradiate_kernel_tpu/ops/pallas_intersect.py:718, launched through
// `_run_bvh8` (:863). Contract (see ops/intersect.py):
//   rays  (nb*256, 8) f32 [ox oy oz dx dy dz mint maxt] (maxt not capped)
//   cbox  (N8, 8, 8) f32  per child slot [lo.xyz, hi.xyz, 0, 0]; empty
//                         slots hold inverted boxes (lo 1e30, hi -1e30)
//   cmeta (N8, 8, 4) i32  per child slot [child, tile, inst, 0]
//   xf, sbase, rows: as tile_bvh.cu
// out t, uv, prim, shape as tile_bvh.cu; stats (n / 32, 3) i32 [inner
// nodes visited, leaves visited, deepest stack], kStack + 1 on an overflow.
//
// Design: the warp walk of tile_bvh.cu (tile_walk.cuh) with 8 children per
// node. Leaves and inner nodes share one stack: an inner node is its id
// (>= 0), a leaf is -((tile << 12) | (inst + 1)) - 1
// (pallas_intersect.py:715, :813-815). At an inner node each lane
// slab-tests the 8 child boxes; the warp ballots "some ray enters" and
// takes the minimum entry distance per child, and lane c reads child c's
// cmeta row, applies the warp's culling bound to child c's minimum (as
// tile_bvh.cu does) and ranks the child by counting: the entered children
// are pushed far to near, a child going below every entered child with a
// larger entry distance, or an equal one in a higher slot. That is the
// reference's order (repeatedly the largest entry distance among those
// left, ties to the highest slot, pallas_intersect.py:817-840; the plain
// version's stable sort), so the nearest child pops first; lanes 0-7 push
// their own children behind __syncwarp. The empty slots' +-1e30 bounds
// times the finite reciprocals give +-inf at worst, never NaN, so
// fminf/fmaxf and the plain version's minimum/maximum agree.
//
// Bound on an H100: operations. Each leaf visit is 32 x 128 tests of 46
// FP32 operations; an inner visit is 8 x 32 slab tests of 26 operations on
// 384 bytes of node data; the ceiling under -fmad=false is 2x the bound.
// Its first form walked the TPU's 256-ray block and held 255 threads at a
// barrier while thread 0 read the node's 32-word cmeta from global memory,
// folded 8 warps x 8 children and ran a selection sort; here the 8 lanes
// that own the children do it in parallel, with no barrier.

#include "tile_walk.cuh"

namespace {

using walk::kFull;
using walk::kStack;

constexpr int kInstBits = 12;   // pallas_intersect.py:715

__global__ void __launch_bounds__(walk::kThreads) tile_bvh8_kernel(
    const float *__restrict__ rays, const float *__restrict__ cbox,
    const int32_t *__restrict__ cmeta, const float *__restrict__ xf,
    const int32_t *__restrict__ sbase, const float *__restrict__ rows,
    float *__restrict__ t_out, float *__restrict__ uv_out,
    int32_t *__restrict__ prim_out, int32_t *__restrict__ shape_out,
    int32_t *__restrict__ stats_out) {
    __shared__ int32_t s_stack[walk::kWarps][kStack];
    const int lane = threadIdx.x & 31;
    int32_t *stack = s_stack[threadIdx.x >> 5];   // the warp's stack

    const int64_t r =
        static_cast<int64_t>(blockIdx.x) * walk::kThreads + threadIdx.x;
    const float *ray = rays + r * 8;
    const float ox = ray[0], oy = ray[1], oz = ray[2];
    const float dx = ray[3], dy = ray[4], dz = ray[5];
    const float mint = ray[6], maxt = ray[7];
    const float ix = tile::rcp(dx), iy = tile::rcp(dy), iz = tile::rcp(dz);

    tile::Hit h{maxt, 0.0f, 0.0f, 0, -1};
    float bt_ub = walk::warp_max(maxt);   // the warp's largest best t
    if (lane == 0) stack[0] = 0;          // the root (an inner node)
    __syncwarp();
    // sp, the stack and every decision below are warp-uniform
    int sp = 1, n_inner = 0, n_leaf = 0, deepest = 1;
    while (sp > 0) {
        --sp;
        const int32_t enc = stack[sp];
        if (enc < 0) {
            const int32_t code = -enc - 1;
            bt_ub = walk::leaf(rows, code >> kInstBits,
                               code & ((1 << kInstBits) - 1), xf, sbase, ox,
                               oy, oz, dx, dy, dz, mint, h);
            ++n_leaf;
            continue;
        }
        ++n_inner;
        const float *box8 = cbox + 64 * static_cast<int64_t>(enc);
        unsigned enter = 0;        // bit c: some ray of the warp enters c
        float mine = INFINITY;     // lane c < 8: child c's minimum entry
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            float near;
            const bool ok = tile::slab(box8 + 8 * c, ox, oy, oz, ix, iy, iz,
                                       mint, maxt, near);
            const float m = walk::warp_min(ok ? near : INFINITY);
            if (__ballot_sync(kFull, ok)) enter |= 1u << c;
            if (lane == c) mine = m;
        }
        // lane c: child c, under the warp's bound on best t
        bool hit = false;
        int32_t enc_c = 0;
        if (lane < 8) {
            const int4 m = *reinterpret_cast<const int4 *>(
                cmeta + 32 * static_cast<int64_t>(enc) + 4 * lane);
            hit = ((enter >> lane) & 1u) && mine <= bt_ub &&
                  !(m.x < 0 && m.y < 0);   // an empty slot
            enc_c = m.x >= 0 ? m.x : -((m.y << kInstBits) | (m.z + 1)) - 1;
        }
        const unsigned hits = __ballot_sync(kFull, hit);
        // far to near: below every entered child with a larger entry
        // distance, or an equal one in a higher slot
        int pos = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float nj = __shfl_sync(kFull, mine, j);
            pos += ((hits >> j) & 1u) &&
                   (nj > mine || (nj == mine && j > lane));
        }
        const int top = sp + __popc(hits);
        if (top > kStack) {   // overflow: report it and end the walk
            deepest = kStack + 1;
            break;
        }
        if (hit) stack[sp + pos] = enc_c;
        __syncwarp();
        sp = top;
        deepest = max(deepest, sp);
    }

    tile::write_hit(h, maxt, r, t_out, uv_out, prim_out, shape_out);
    walk::write_stats(r, n_inner, n_leaf, deepest, stats_out);
}

}  // namespace

// Launch on `stream` (a cudaStream_t); arguments as tile_bvh_launch.
extern "C" int tile_bvh8_launch(
    const void *rays, const void *cbox, const void *cmeta, const void *xf,
    const void *sbase, const void *rows, int n_blocks, void *t_out,
    void *uv_out, void *prim_out, void *shape_out, void *stats_out,
    void *stream) {
    if (n_blocks > 0)
        tile_bvh8_kernel<<<n_blocks * (walk::kRayBlock / walk::kThreads),
                           walk::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float *>(rays),
            static_cast<const float *>(cbox),
            static_cast<const int32_t *>(cmeta),
            static_cast<const float *>(xf),
            static_cast<const int32_t *>(sbase),
            static_cast<const float *>(rows), static_cast<float *>(t_out),
            static_cast<float *>(uv_out), static_cast<int32_t *>(prim_out),
            static_cast<int32_t *>(shape_out),
            static_cast<int32_t *>(stats_out));
    return static_cast<int>(cudaGetLastError());
}
