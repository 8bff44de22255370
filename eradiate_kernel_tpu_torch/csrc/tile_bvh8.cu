// 8-wide tile-BVH traversal: closest ray/triangle hits for blocks of 256
// rays, walking the 8-wide BVH over 128-triangle tiles as a block.
//
// Replaces the Pallas TPU kernel `_bvh8_kernel` in
// eradiate_kernel_tpu/ops/pallas_intersect.py:718, launched through
// `_run_bvh8` (:863). Contract (see ops/intersect.py):
//   rays  (nb*256, 8) f32 [ox oy oz dx dy dz mint maxt] (maxt not capped)
//   cbox  (N8, 8, 8) f32  per child slot [lo.xyz, hi.xyz, 0, 0]; empty
//                         slots hold inverted boxes (lo 1e30, hi -1e30)
//   cmeta (N8, 8, 4) i32  per child slot [child, tile, inst, 0]
//   xf (I+1, 12) f32, sbase (I+1,) i32, v0/e1/e2, prim/shape: as tile_bvh.cu
// out t, uv, prim, shape as tile_bvh.cu; stats (nb, 3) i32 [inner nodes
// visited, leaves visited, deepest stack], kStack + 1 on an overflow.
//
// Design: the traversal of tile_bvh.cu with 8 children per node. Leaves
// and inner nodes share one stack in shared memory: an inner node is its
// id (>= 0), a leaf is -((tile << 12) | (inst + 1)) - 1
// (pallas_intersect.py:715, :813-815), so each step runs one branch. At an
// inner node each thread slab-tests the 8 child boxes; every warp reduces
// "some ray enters" (a ballot) and the minimum entry distance per child,
// and thread 0 folds the warps and pushes the entered children far to near
// with the reference's rule: repeatedly the largest entry distance among
// those left, ties to the highest slot (pallas_intersect.py:817-840), so
// the nearest child pops first. The empty slots' +-1e30 bounds times the
// finite reciprocals give +-inf at worst, never NaN, so fminf/fmaxf and
// the plain version's minimum/maximum agree.
//
// Bound on an H100: operations. Each leaf visit is 256 x 128 tests of 46
// FP32 operations; an inner visit is 8 x 256 slab tests of 26 operations
// on 384 bytes of node data.

#include "tile_common.cuh"

namespace {

using tile::kRayBlock;
using tile::kWarps;

constexpr int kStack = 64;      // pallas_intersect.py:203
constexpr int kInstBits = 12;   // pallas_intersect.py:715

__global__ void __launch_bounds__(kRayBlock) tile_bvh8_kernel(
    const float *__restrict__ rays, const float *__restrict__ cbox,
    const int32_t *__restrict__ cmeta, const float *__restrict__ xf,
    const int32_t *__restrict__ sbase, const float *__restrict__ v0,
    const float *__restrict__ e1, const float *__restrict__ e2,
    const int32_t *__restrict__ prim, const int32_t *__restrict__ shape,
    float *__restrict__ t_out, float *__restrict__ uv_out,
    int32_t *__restrict__ prim_out, int32_t *__restrict__ shape_out,
    int32_t *__restrict__ stats_out) {
    __shared__ tile::TileSmem s_tile;
    __shared__ float s_warp[kWarps], s_red;
    __shared__ float s_near[kWarps][8];
    __shared__ unsigned s_enter[kWarps];
    __shared__ int32_t s_stack[kStack];
    __shared__ int s_sp;

    const int64_t b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int64_t r = b * kRayBlock + tid;
    const float *ray = rays + r * 8;
    const float ox = ray[0], oy = ray[1], oz = ray[2];
    const float dx = ray[3], dy = ray[4], dz = ray[5];
    const float mint = ray[6], maxt = ray[7];
    const float ix = tile::rcp(dx), iy = tile::rcp(dy), iz = tile::rcp(dz);

    tile::Hit h{maxt, 0.0f, 0.0f, 0, -1};
    float bt_ub = tile::block_max(maxt, s_warp, &s_red);
    if (tid == 0) s_stack[0] = 0;   // the root (an inner node)
    __syncthreads();
    // sp, the stack and every decision below are block-uniform
    int sp = 1, n_inner = 0, n_leaf = 0, deepest = 1;
    while (sp > 0) {
        --sp;
        const int32_t enc = s_stack[sp];
        if (enc < 0) {
            const int32_t code = -enc - 1;
            tile::leaf(s_tile, code >> kInstBits,
                       code & ((1 << kInstBits) - 1), xf, sbase, v0, e1, e2,
                       prim, shape, ox, oy, oz, dx, dy, dz, mint, h);
            bt_ub = tile::block_max(h.t, s_warp, &s_red);
            ++n_leaf;
            continue;
        }
        ++n_inner;
        const float *box8 = cbox + 64 * static_cast<int64_t>(enc);
        const float far_cap = fminf(maxt, bt_ub);
        unsigned enter = 0;   // bit c: this warp has a ray entering child c
        for (int c = 0; c < 8; ++c) {
            float near;
            const bool ok = tile::slab(box8 + 8 * c, ox, oy, oz, ix, iy, iz,
                                       mint, far_cap, near);
            float m = ok ? near : INFINITY;
            for (int off = 16; off > 0; off >>= 1)
                m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
            if (__ballot_sync(0xffffffffu, ok)) enter |= 1u << c;
            if (lane == 0) s_near[warp][c] = m;
        }
        if (lane == 0) s_enter[warp] = enter;
        __syncthreads();
        if (tid == 0) {
            const int32_t *meta8 = cmeta + 32 * static_cast<int64_t>(enc);
            float near8[8];
            int32_t enc8[8];
            unsigned hit = 0;
            for (int w = 0; w < kWarps; ++w) hit |= s_enter[w];
            for (int c = 0; c < 8; ++c) {
                float m = s_near[0][c];
                for (int w = 1; w < kWarps; ++w) m = fminf(m, s_near[w][c]);
                near8[c] = m;
                const int32_t cid = meta8[4 * c], tl = meta8[4 * c + 1],
                              inst = meta8[4 * c + 2];
                if (cid < 0 && tl < 0) hit &= ~(1u << c);   // empty slot
                enc8[c] = cid >= 0 ? cid
                                   : -((tl << kInstBits) | (inst + 1)) - 1;
            }
            int top = sp + __popc(hit);
            if (top > kStack) {
                top = -1;   // overflow
            } else {
                // far to near: the largest entry distance left, ties to
                // the highest slot
                int s = sp;
                while (hit) {
                    int js = -1;
                    float mx = -INFINITY;
                    for (int c = 0; c < 8; ++c)
                        if (((hit >> c) & 1u) && (js < 0 || near8[c] >= mx)) {
                            mx = near8[c];
                            js = c;
                        }
                    s_stack[s++] = enc8[js];
                    hit &= ~(1u << js);
                }
            }
            s_sp = top;
        }
        __syncthreads();
        const int top = s_sp;
        if (top < 0) {   // overflow: report it and end the walk
            deepest = kStack + 1;
            break;
        }
        sp = top;
        deepest = max(deepest, sp);
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
extern "C" int tile_bvh8_launch(
    const void *rays, const void *cbox, const void *cmeta, const void *xf,
    const void *sbase, const void *v0, const void *e1, const void *e2,
    const void *prim, const void *shape, int n_blocks, void *t_out,
    void *uv_out, void *prim_out, void *shape_out, void *stats_out,
    void *stream) {
    if (n_blocks > 0) {
        tile_bvh8_kernel<<<n_blocks, kRayBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float *>(rays),
            static_cast<const float *>(cbox),
            static_cast<const int32_t *>(cmeta),
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
