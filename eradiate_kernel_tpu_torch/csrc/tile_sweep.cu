// Flat tile sweep: closest ray/triangle hits for blocks of 256 rays over
// their admitted 128-triangle tiles. Two entries:
//
//   tile_sweep_launch        the sweep alone, after the eager pre-passes of
//                            ops/intersect.py::prepare_sweep (root cap,
//                            coherence sort, padding, block x tile mask,
//                            near-to-far order): any number of tiles;
//   tile_sweep_small_launch  the whole query in one launch for tile sets of
//                            at most kFusedMaxTiles tiles (the atmosphere's
//                            cube is one): the root cap, the filler rays of
//                            a ragged last block, the block's interval
//                            bounds, the block x tile slab and reach test
//                            and the near-to-far order, then the sweep. No
//                            coherence sort.
//
// Replaces the Pallas TPU kernel `_kernel` in
// eradiate_kernel_tpu/ops/pallas_intersect.py:94 (leaf `_intersect_tile`,
// :40), launched through `_run` (:155), and the XLA pre-passes of
// `intersect_tiles` (:647) for the fused entry. Contracts (see
// ops/intersect.py):
//   tile_sweep_launch: rays (nb*256, 8) f32 [ox oy oz dx dy dz mint maxt]
//     (maxt capped), ids (nb, T) i32 admitted tiles near to far, tnear
//     (nb, T) f32 their entry lower bounds, count (nb,) i32;
//   tile_sweep_small_launch: o, d (n, 3) f32, mint, maxt (n,) f32 as the
//     caller's Ray holds them, root (2, 3) f32 [lo; hi] of all tiles, lo/hi
//     (T, 3) f32 tile boxes, T <= kFusedMaxTiles;
//   both: rows (T, 128, 12) f32 packed triangles (ops/intersect.py
//     ::tile_rows): [v0x v0y v0z e1x | e1y e1z e2x e2y | e2z prim shape 0],
//     prim and shape as int32 bits.
// out t (n,) (inf on a miss), uv (n, 2), prim (n,), shape (n,) (-1 on a
// miss), visited (nb,) tiles swept per block.
//
// Design: one thread block per ray block, one thread per ray; the block
// walks its near-to-far list of admitted tiles and stops once no ray of
// the block can improve (the reference's early exit,
// pallas_intersect.py:118-122). For each visit:
//   - staging is asynchronous and double-buffered: while tile k is tested
//     from one shared buffer, tile k+1 (its id is known from the list) is
//     copied into the other with 16-byte cp.async.cg copies, 384 of them
//     for the tile's 6 KB. A tile fetched and then not visited costs bytes,
//     not results;
//   - one barrier a visit: `bt_ub > tnear[k]`, bt_ub the block's largest
//     best t, holds exactly when some thread's t > tnear[k] (no t is NaN:
//     a block whose capped maxt holds a NaN visits nothing, as the plain
//     version's NaN max compares false), so __syncthreads_or(t > tnear[k])
//     decides the early exit and also publishes the staged buffer and
//     orders the last reads of the buffer that is refilled next;
//   - each triangle is three broadcast 128-bit shared loads (LDS.128)
//     instead of eleven scalar ones from three arrays;
//   - 1/det is __frcp_rn, the correctly rounded reciprocal, which gives
//     the bits of IEEE 1.0f / det.
// Built with -fmad=false, every product and sum rounds as in the plain
// PyTorch versions, and the fused entry's pre-pass arithmetic repeats the
// eager pre-passes' expressions (NaN-propagating min and max as in
// torch.minimum/amax/clamp), so both entries agree with their plain
// versions bit for bit, visit counts included.
//
// Both entries are templates on the scene's float type T and have a
// float64 twin, `_launch_f64`, for the double variants: every f32 of the
// contracts above is then f64, and a tile's rows take 12 KB, so the double
// buffer holds 24 KB of the block's 48 KB of static shared memory.
//
// Bound on an H100: operations. Each visit is 256 x 128 tests of 46 FP32
// operations against 6 KB of tile data, so the bound is tests x 46 over 67
// TFLOP/s (FP32, non-tensor). That rate counts a fused multiply-add as two
// operations; under -fmad=false every operation issues alone, so the
// reachable ceiling is half of it, 2x the stated bound.

#include "tile_common.cuh"

namespace {

using tile::Hit;
using tile::kRayBlock;
using tile::kTileWords;
using tile::kWarps;
using tile::tabs;
using tile::tmax;

// 16-byte copies per tile: 384 in float32, 768 in float64
template <typename T>
constexpr int kTileChunks = kTileWords * static_cast<int>(sizeof(T)) / 16;

// the fused entry's capacity: one warp ranks the tile list, a lane a tile
// (tile_sweep_small_launch refuses more; ops/intersect.py's
// SWEEP_FUSED_MAX_TILES routes no more to it, which a card test checks)
constexpr int kFusedMaxTiles = 32;

// torch.minimum / torch.maximum / torch.clamp: a NaN operand gives NaN
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
    return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
    return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T clamp_min0(T a) {
    return a != a ? a : tmax(a, T(0));
}

// start copying tile j's packed rows into dst (a shared buffer of
// kTileWords scalars, 16-byte aligned); wait_staged() ends the copy
template <typename T>
__device__ __forceinline__ void stage_async(T *dst,
                                            const T *__restrict__ rows,
                                            int64_t j) {
    const char *src = reinterpret_cast<const char *>(rows + j * kTileWords);
    char *d = reinterpret_cast<char *>(dst);
    for (int c = threadIdx.x; c < kTileChunks<T>; c += kRayBlock) {
        const unsigned s =
            static_cast<unsigned>(__cvta_generic_to_shared(d + 16 * c));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(src + 16 * c) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_staged() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Sweep a block's list: tile id(k) with entry bound key(k) for k < cnt,
// near to far, until no thread's best t exceeds the next key. Returns the
// number of tiles visited. Every thread of the block calls it.
template <typename T, typename Id, typename Key>
__device__ __forceinline__ int sweep_list(T (*s_rows)[kTileWords], Id id,
                                          Key key, int cnt, bool nan_block,
                                          const T *__restrict__ rows, T ox,
                                          T oy, T oz, T dx, T dy, T dz,
                                          T mint, Hit<T> &h) {
    if (cnt > 0 && !nan_block) stage_async(s_rows[0], rows, id(0));
    int k = 0;
    for (;; ++k) {
        const bool more = k < cnt && !nan_block;   // block-uniform
        const bool pred = more && h.t > key(k);
        wait_staged();
        if (!__syncthreads_or(pred)) break;
        if (k + 1 < cnt) stage_async(s_rows[(k + 1) & 1], rows, id(k + 1));
        tile::test_rows(s_rows[k & 1], ox, oy, oz, dx, dy, dz, mint, 0, h);
    }
    return k;
}

template <typename T>
__global__ void __launch_bounds__(kRayBlock) tile_sweep_kernel(
    const T *__restrict__ rays, const int32_t *__restrict__ ids,
    const int32_t *__restrict__ count, const T *__restrict__ tnear,
    const T *__restrict__ rows, int n_tiles, T *__restrict__ t_out,
    T *__restrict__ uv_out, int32_t *__restrict__ prim_out,
    int32_t *__restrict__ shape_out, int32_t *__restrict__ visited_out) {
    __shared__ __align__(16) T s_rows[2][kTileWords];

    const int64_t b = blockIdx.x;
    const int64_t r = b * kRayBlock + threadIdx.x;
    const T *ray = rays + r * 8;
    const T ox = ray[0], oy = ray[1], oz = ray[2];
    const T dx = ray[3], dy = ray[4], dz = ray[5];
    const T mint = ray[6], maxt = ray[7];

    Hit<T> h{maxt, T(0), T(0), 0, -1};
    const bool nan_block = __syncthreads_or(maxt != maxt);
    const int32_t *b_ids = ids + b * n_tiles;
    const T *b_tnear = tnear + b * n_tiles;
    const int k = sweep_list(
        s_rows, [&](int i) { return b_ids[i]; },
        [&](int i) { return b_tnear[i]; }, count[b], nan_block, rows, ox,
        oy, oz, dx, dy, dz, mint, h);
    tile::write_hit(h, maxt, r, t_out, uv_out, prim_out, shape_out);
    if (threadIdx.x == 0) visited_out[b] = k;
}

// the block bounds of the fused entry, in s_part order
enum { kOLo = 0, kOHi = 3, kDLo = 6, kDHi = 9, kMaxt = 12, kBounds = 13 };

template <typename T>
__global__ void __launch_bounds__(kRayBlock) tile_sweep_small_kernel(
    const T *__restrict__ o, const T *__restrict__ d,
    const T *__restrict__ mint_in, const T *__restrict__ maxt_in,
    int64_t n_rays, const T *__restrict__ root, const T *__restrict__ lo,
    const T *__restrict__ hi, int n_tiles, const T *__restrict__ rows,
    T *__restrict__ t_out, T *__restrict__ uv_out,
    int32_t *__restrict__ prim_out, int32_t *__restrict__ shape_out,
    int32_t *__restrict__ visited_out) {
    __shared__ __align__(16) T s_rows[2][kTileWords];
    __shared__ T s_part[kBounds][kWarps];
    __shared__ T s_key[kFusedMaxTiles];
    __shared__ int32_t s_ids[kFusedMaxTiles];
    __shared__ int s_cnt, s_nan;

    const int64_t b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t r = b * kRayBlock + tid;
    const bool real = r < n_rays;

    // the ray, or the filler ray of _pad_blocks (o = 0, d = +z, mint =
    // maxt = 0, not capped)
    T ov[3] = {T(0), T(0), T(0)}, dv[3] = {T(0), T(0), T(1)};
    T mint = T(0), maxt = T(0);
    if (real) {
        for (int a = 0; a < 3; ++a) {
            ov[a] = o[3 * r + a];
            dv[a] = d[3 * r + a];
        }
        mint = mint_in[r];
        // _cap_maxt_to_root: maxt clamped to the exit from the root box
        T near = T(0), far = T(0);
        for (int a = 0; a < 3; ++a) {
            const T inv = (dv[a] < T(0) ? T(-1) : T(1)) /
                          nan_max(tabs(dv[a]), T(1e-30));
            const T t0 = (root[a] - ov[a]) * inv;
            const T t1 = (root[3 + a] - ov[a]) * inv;
            const T mn = nan_min(t0, t1), mx = nan_max(t0, t1);
            near = a == 0 ? mn : nan_max(near, mn);
            far = a == 0 ? mx : nan_min(far, mx);
        }
        const bool hit = near <= far && far >= mint;
        const T cap = hit ? far * T(1.0001) + T(1e-4) : mint;
        maxt = nan_min(maxt_in[r], nan_max(cap, mint));
    }

    // _block_tile_mask's block bounds: min and max of o and d, max of maxt
    T v[kBounds];
    for (int a = 0; a < 3; ++a) {
        v[kOLo + a] = v[kOHi + a] = ov[a];
        v[kDLo + a] = v[kDHi + a] = dv[a];
    }
    v[kMaxt] = maxt;
    for (int off = 16; off > 0; off >>= 1) {
        for (int i = 0; i < kBounds; ++i) {
            const T w = __shfl_xor_sync(0xffffffffu, v[i], off);
            v[i] = (i < kOHi || (i >= kDLo && i < kDHi)) ? nan_min(v[i], w)
                                                         : nan_max(v[i], w);
        }
    }
    if (lane == 0)
        for (int i = 0; i < kBounds; ++i) s_part[i][warp] = v[i];
    __syncthreads();

    if (warp == 0) {
        T bnd[kBounds];
        for (int i = 0; i < kBounds; ++i) {
            const bool is_min = i < kOHi || (i >= kDLo && i < kDHi);
            T m = s_part[i][0];
            for (int w = 1; w < kWarps; ++w)
                m = is_min ? nan_min(m, s_part[i][w])
                           : nan_max(m, s_part[i][w]);
            bnd[i] = m;
        }
        const T maxt_ub = bnd[kMaxt];
        // lane i tests tile i: interval slab test of the block's bounds
        // plus the reach bound on sign-mixed axes, the tile's entry lower
        // bound as its key (inf if not admitted)
        const int i = lane;
        bool ok = false;
        T key = T(INFINITY);
        if (i < n_tiles) {
            const T big = T(3.4e38);
            T tnear = T(0), tfar = T(0);
            bool reach = true;
            const T maxt_c = nan_min(maxt_ub, T(1e30));
            for (int a = 0; a < 3; ++a) {
                const T olo = bnd[kOLo + a], ohi = bnd[kOHi + a];
                const T dlo = bnd[kDLo + a], dhi = bnd[kDHi + a];
                const bool mixed = dlo <= T(0) && dhi >= T(0);
                const T i1 = T(1) / (mixed ? T(1) : dlo);
                const T i2 = T(1) / (mixed ? T(1) : dhi);
                const T il = mixed ? -big : nan_min(i1, i2);
                const T ih = mixed ? big : nan_max(i1, i2);
                const T tlo = lo[3 * i + a], thi = hi[3 * i + a];
                const T a_lo = tlo - ohi, a_hi = tlo - olo;
                const T b_lo = thi - ohi, b_hi = thi - olo;
                const T c0 = a_lo * il, c1 = a_lo * ih, c2 = a_hi * il,
                        c3 = a_hi * ih;
                const T c4 = b_lo * il, c5 = b_lo * ih, c6 = b_hi * il,
                        c7 = b_hi * ih;
                const T t0_lo = nan_min(nan_min(c0, c1), nan_min(c2, c3));
                const T t0_hi = nan_max(nan_max(c0, c1), nan_max(c2, c3));
                const T t1_lo = nan_min(nan_min(c4, c5), nan_min(c6, c7));
                const T t1_hi = nan_max(nan_max(c4, c5), nan_max(c6, c7));
                const T n_a = nan_min(t0_lo, t1_lo);
                const T f_a = nan_max(t0_hi, t1_hi);
                tnear = a == 0 ? n_a : nan_max(tnear, n_a);
                tfar = a == 0 ? f_a : nan_min(tfar, f_a);
                if (mixed) {
                    const T dist = clamp_min0(nan_max(tlo - ohi, olo - thi));
                    const T speed = nan_max(tabs(dlo), tabs(dhi));
                    reach = reach && dist <= maxt_c * speed + T(1e-6);
                }
            }
            tnear = clamp_min0(tnear);
            tfar = nan_min(tfar, maxt_ub);
            ok = tnear <= tfar && reach;
            key = ok ? tnear : T(INFINITY);
        }
        // stable near-to-far order: rank by (key, tile index); keys are
        // never NaN (a NaN bound fails the test and keys to inf)
        int rank = 0;
        for (int j = 0; j < n_tiles; ++j) {
            const T kj = __shfl_sync(0xffffffffu, key, j);
            rank += (kj < key || (kj == key && j < i)) ? 1 : 0;
        }
        if (i < n_tiles) {
            s_ids[rank] = i;
            s_key[rank] = key;
        }
        const unsigned admitted = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) {
            s_cnt = __popc(admitted);
            s_nan = maxt_ub != maxt_ub;
        }
    }
    __syncthreads();

    Hit<T> h{maxt, T(0), T(0), 0, -1};
    const int k = sweep_list(
        s_rows, [&](int i) { return s_ids[i]; },
        [&](int i) { return s_key[i]; }, s_cnt, s_nan != 0, rows, ov[0],
        ov[1], ov[2], dv[0], dv[1], dv[2], mint, h);
    if (real) tile::write_hit(h, maxt, r, t_out, uv_out, prim_out, shape_out);
    if (tid == 0) visited_out[b] = k;
}

}  // namespace

namespace {

template <typename T>
int sweep_launch(const void *rays, const void *ids, const void *count,
                 const void *tnear, const void *rows, int n_blocks,
                 int n_tiles, void *t_out, void *uv_out, void *prim_out,
                 void *shape_out, void *visited_out, void *stream) {
    if (n_blocks > 0) {
        tile_sweep_kernel<T><<<n_blocks, kRayBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T *>(rays), static_cast<const int32_t *>(ids),
            static_cast<const int32_t *>(count),
            static_cast<const T *>(tnear), static_cast<const T *>(rows),
            n_tiles, static_cast<T *>(t_out), static_cast<T *>(uv_out),
            static_cast<int32_t *>(prim_out),
            static_cast<int32_t *>(shape_out),
            static_cast<int32_t *>(visited_out));
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sweep_small_launch(const void *o, const void *d, const void *mint,
                       const void *maxt, long long n_rays, const void *root,
                       const void *lo, const void *hi, int n_tiles,
                       const void *rows, void *t_out, void *uv_out,
                       void *prim_out, void *shape_out, void *visited_out,
                       void *stream) {
    if (n_tiles < 1 || n_tiles > kFusedMaxTiles || n_rays < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long n_blocks = (n_rays + kRayBlock - 1) / kRayBlock;
    tile_sweep_small_kernel<T><<<n_blocks, kRayBlock, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T *>(o), static_cast<const T *>(d),
        static_cast<const T *>(mint), static_cast<const T *>(maxt), n_rays,
        static_cast<const T *>(root), static_cast<const T *>(lo),
        static_cast<const T *>(hi), n_tiles, static_cast<const T *>(rows),
        static_cast<T *>(t_out), static_cast<T *>(uv_out),
        static_cast<int32_t *>(prim_out), static_cast<int32_t *>(shape_out),
        static_cast<int32_t *>(visited_out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError(). The
// _f64 entries take and give float64 where these take float32.
extern "C" int tile_sweep_launch(
    const void *rays, const void *ids, const void *count, const void *tnear,
    const void *rows, int n_blocks, int n_tiles, void *t_out, void *uv_out,
    void *prim_out, void *shape_out, void *visited_out, void *stream) {
    return sweep_launch<float>(rays, ids, count, tnear, rows, n_blocks,
                               n_tiles, t_out, uv_out, prim_out, shape_out,
                               visited_out, stream);
}

extern "C" int tile_sweep_launch_f64(
    const void *rays, const void *ids, const void *count, const void *tnear,
    const void *rows, int n_blocks, int n_tiles, void *t_out, void *uv_out,
    void *prim_out, void *shape_out, void *visited_out, void *stream) {
    return sweep_launch<double>(rays, ids, count, tnear, rows, n_blocks,
                                n_tiles, t_out, uv_out, prim_out, shape_out,
                                visited_out, stream);
}

// The fused query for 1 <= n_tiles <= 32 tiles; n_rays > 0. Launch on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a tile
// count out of range).
extern "C" int tile_sweep_small_launch(
    const void *o, const void *d, const void *mint, const void *maxt,
    long long n_rays, const void *root, const void *lo, const void *hi,
    int n_tiles, const void *rows, void *t_out, void *uv_out, void *prim_out,
    void *shape_out, void *visited_out, void *stream) {
    return sweep_small_launch<float>(o, d, mint, maxt, n_rays, root, lo, hi,
                                     n_tiles, rows, t_out, uv_out, prim_out,
                                     shape_out, visited_out, stream);
}

extern "C" int tile_sweep_small_launch_f64(
    const void *o, const void *d, const void *mint, const void *maxt,
    long long n_rays, const void *root, const void *lo, const void *hi,
    int n_tiles, const void *rows, void *t_out, void *uv_out, void *prim_out,
    void *shape_out, void *visited_out, void *stream) {
    return sweep_small_launch<double>(o, d, mint, maxt, n_rays, root, lo,
                                      hi, n_tiles, rows, t_out, uv_out,
                                      prim_out, shape_out, visited_out,
                                      stream);
}
