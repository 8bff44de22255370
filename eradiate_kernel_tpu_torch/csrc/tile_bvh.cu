// Binary tile-BVH traversal: closest ray/triangle hits for warps of 32 rays
// walking the binary BVH over 128-triangle tiles together.
//
// Replaces the Pallas TPU kernel `_bvh_kernel` in
// eradiate_kernel_tpu/ops/pallas_intersect.py:206, launched through
// `_run_bvh` (:377). Contract (see ops/intersect.py; every f32
// below is f64 in the float64 entry `_launch_f64` of the double variants):
//   rays  (nb*256, 8) f32 [ox oy oz dx dy dz mint maxt], maxt capped at the
//                         root box
//   nbox  (N, 1, 8) f32   node AABBs [lo.xyz, hi.xyz, 0, 0]
//   nmeta (N, 4) i32      [left, right, tile, inst]; tile >= 0 is a leaf
//   xf    (I+1, 12) f32   world-to-local affine rows, row 0 the identity
//   sbase (I+1,) i32      shape base of each instance, 0 in row 0
//   rows  (T, 128, 12) f32 packed triangles (tile_common.cuh)
// out t (n,) (inf on a miss), uv (n, 2), prim (n,), shape (n,) (-1 on a
// miss), stats (n / 32, 3) i32 [inner nodes visited, leaves visited,
// deepest stack]; a deepest stack of kStack + 1 reports an overflow, which
// ends the warp's walk (the wrapper raises).
//
// Design: one thread per ray; a warp walks the tree as the TPU kernel walks
// it with its block (tile_walk.cuh). At an inner node each lane slab-tests
// both children; the warp ballots "some ray enters" and takes its minimum
// entry distance per child, then applies its culling bound (its largest
// best t) to that minimum: with fminf (which never returns NaN for a
// non-NaN operand), near <= min(far, maxt, bound) holds exactly when
// near <= min(far, maxt) and near <= bound, so "some ray enters under the
// bound" is "some ray enters, and the smallest entry distance is <= the
// bound", and the decisions, and so the visits and stats, are those of the
// plain walk's single-pass test, NaN maxt included. The nearer child is
// pushed last (popped first), the left one on a tie. A leaf moves each ray
// into the instance's space by the leaf's affine row and tests the tile.
// The expressions and their order are the reference's
// (pallas_intersect.py:256-358), so the plain PyTorch version visits the
// same nodes and the two agree bit for bit.
//
// Bound on an H100: operations. Each leaf visit is 32 x 128 tests of 46
// FP32 operations on 6 KB of tile data; an inner visit is 2 x 32 slab
// tests of 26 operations on 80 bytes of node data. Under -fmad=false no
// multiply-add contracts, so the reachable ceiling is 2x the stated bound.
// The first form of this kernel walked the TPU's 256-ray block with five
// block barriers an inner node and three a leaf; the warp walk takes none
// and tests 1.3-3.6x fewer triangles on the loads of chip_smoke.py, since
// a warp visits only the leaves its own rays need (PERF.md).

#include "tile_walk.cuh"

namespace {

using walk::kFull;
using walk::kStack;

template <typename T>
__global__ void __launch_bounds__(walk::kThreads) tile_bvh_kernel(
    const T *__restrict__ rays, const T *__restrict__ nbox,
    const int32_t *__restrict__ nmeta, const T *__restrict__ xf,
    const int32_t *__restrict__ sbase, const T *__restrict__ rows,
    T *__restrict__ t_out, T *__restrict__ uv_out,
    int32_t *__restrict__ prim_out, int32_t *__restrict__ shape_out,
    int32_t *__restrict__ stats_out) {
    __shared__ int32_t s_stack[walk::kWarps][kStack];
    const int lane = threadIdx.x & 31;
    int32_t *stack = s_stack[threadIdx.x >> 5];   // the warp's stack

    const int64_t r =
        static_cast<int64_t>(blockIdx.x) * walk::kThreads + threadIdx.x;
    const T *ray = rays + r * 8;
    const T ox = ray[0], oy = ray[1], oz = ray[2];
    const T dx = ray[3], dy = ray[4], dz = ray[5];
    const T mint = ray[6], maxt = ray[7];
    const T ix = tile::rcp(dx), iy = tile::rcp(dy), iz = tile::rcp(dz);

    tile::Hit<T> h{maxt, T(0), T(0), 0, -1};
    T bt_ub = walk::warp_max(maxt);   // the warp's largest best t
    if (lane == 0) stack[0] = 0;          // the root
    __syncwarp();
    // sp, the stack and every decision below are warp-uniform
    int sp = 1, n_inner = 0, n_leaf = 0, deepest = 1;
    while (sp > 0) {
        --sp;
        const int node = stack[sp];
        const int4 meta = *reinterpret_cast<const int4 *>(nmeta + 4 * node);
        if (meta.z >= 0) {
            bt_ub = walk::leaf(rows, meta.z, meta.w + 1, xf, sbase, ox, oy,
                               oz, dx, dy, dz, mint, h);
            ++n_leaf;
            continue;
        }
        ++n_inner;
        const int left = meta.x, right = meta.y;
        T near_l, near_r;
        const bool ok_l = tile::slab(nbox + 8 * left, ox, oy, oz, ix, iy,
                                     iz, mint, maxt, near_l);
        const bool ok_r = tile::slab(nbox + 8 * right, ox, oy, oz, ix, iy,
                                     iz, mint, maxt, near_r);
        const T m_l = walk::warp_min(ok_l ? near_l : T(INFINITY));
        const T m_r = walk::warp_min(ok_r ? near_r : T(INFINITY));
        // the warp's bound on best t, applied to the minima
        const bool hit_l = __ballot_sync(kFull, ok_l) && m_l <= bt_ub;
        const bool hit_r = __ballot_sync(kFull, ok_r) && m_r <= bt_ub;
        near_l = hit_l ? m_l : T(INFINITY);
        near_r = hit_r ? m_r : T(INFINITY);
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
        if (lane == 0) {
            if (push_second) stack[sp] = second;
            if (push_first) stack[sp + push_second] = first;
        }
        __syncwarp();
        sp = top;
        deepest = max(deepest, sp);
    }

    tile::write_hit(h, maxt, r, t_out, uv_out, prim_out, shape_out);
    walk::write_stats(r, n_inner, n_leaf, deepest, stats_out);
}

}  // namespace

namespace {

template <typename T>
int launch(const void *rays, const void *nbox, const void *nmeta,
           const void *xf, const void *sbase, const void *rows, int n_blocks,
           void *t_out, void *uv_out, void *prim_out, void *shape_out,
           void *stats_out, void *stream) {
    if (n_blocks > 0)
        tile_bvh_kernel<T><<<n_blocks * (walk::kRayBlock / walk::kThreads),
                          walk::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T *>(rays), static_cast<const T *>(nbox),
            static_cast<const int32_t *>(nmeta),
            static_cast<const T *>(xf), static_cast<const int32_t *>(sbase),
            static_cast<const T *>(rows), static_cast<T *>(t_out),
            static_cast<T *>(uv_out), static_cast<int32_t *>(prim_out),
            static_cast<int32_t *>(shape_out),
            static_cast<int32_t *>(stats_out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t) for n_blocks blocks of 256 rays;
// returns cudaGetLastError(). The _f64 entry takes float64 rays, boxes,
// xf and rows (the double variants) and float64 t and uv.
extern "C" int tile_bvh_launch(
    const void *rays, const void *nbox, const void *nmeta, const void *xf,
    const void *sbase, const void *rows, int n_blocks, void *t_out,
    void *uv_out, void *prim_out, void *shape_out, void *stats_out,
    void *stream) {
    return launch<float>(rays, nbox, nmeta, xf, sbase, rows, n_blocks,
                         t_out, uv_out, prim_out, shape_out, stats_out,
                         stream);
}

extern "C" int tile_bvh_launch_f64(
    const void *rays, const void *nbox, const void *nmeta, const void *xf,
    const void *sbase, const void *rows, int n_blocks, void *t_out,
    void *uv_out, void *prim_out, void *shape_out, void *stats_out,
    void *stream) {
    return launch<double>(rays, nbox, nmeta, xf, sbase, rows, n_blocks,
                          t_out, uv_out, prim_out, shape_out, stats_out,
                          stream);
}
