// Native binned-SAH BVH-over-tiles builder — the C++ twin of
// eradiate_kernel_tpu/ops/bvh.py::build_tile_bvh (the TPU analog of the
// reference's native SAH kd-tree construction, kdtree.h:676,1027-1039).
//
// The algorithm is replicated operation-for-operation so the flattened
// node arrays are BIT-IDENTICAL to the NumPy builder (tested by
// tests/test_accel.py): stable centroid sort on the largest
// centroid-extent axis, exact prefix/suffix-area SAH sweep sampled at
// <= 16 candidate splits, median fallback for tiny/degenerate nodes and
// near the depth cap, LIFO work stack with (left, right) push order.
//
// Exposed as a C ABI for ctypes; built on demand with g++ -O3 (same
// scheme as tile_builder.cpp).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int MAX_DEPTH = 48;  // == ops/bvh.py MAX_DEPTH
constexpr int N_BINS = 16;     // == ops/bvh.py N_BINS

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

// half-surface-area metric, f32 like the NumPy builder's `area`
static inline float area(const Vec3 &l, const Vec3 &h) {
    const float dx = std::max(h.x - l.x, 0.0f);
    const float dy = std::max(h.y - l.y, 0.0f);
    const float dz = std::max(h.z - l.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
}

struct Work {
    int32_t node;
    int64_t begin, end;  // subrange of the shared id array
    int32_t depth;
};

}  // namespace

extern "C" {

// tile_lo/tile_hi: (T, 3) f32 leaf AABBs; leaf_tile/leaf_inst: (T,) i32
// per-leaf payloads. Outputs (caller-allocated, N = 2*T - 1):
//   nbox  (N, 8) f32: [lo.xyz, hi.xyz, 0, 0]
//   nmeta (N, 4) i32: [left, right, tile, inst]; tile >= 0 marks a leaf
// Returns max depth + 1 (node count on the deepest path), or -1 on error.
int build_tile_bvh(const float *tile_lo, const float *tile_hi,
                   const int32_t *leaf_tile, const int32_t *leaf_inst,
                   int64_t T, float *nbox, int32_t *nmeta) {
    if (T < 1) return -1;

    std::vector<Vec3> cent((size_t)T);
    for (int64_t i = 0; i < T; ++i) {
        cent[i] = {0.5f * (tile_lo[3 * i + 0] + tile_hi[3 * i + 0]),
                   0.5f * (tile_lo[3 * i + 1] + tile_hi[3 * i + 1]),
                   0.5f * (tile_lo[3 * i + 2] + tile_hi[3 * i + 2])};
    }

    // shared id array: a node owns ids[begin:end); splitting reorders the
    // subrange in place into (left | right) — equivalent to the NumPy
    // builder materializing ids[order], whose children inherit the sorted
    // order as their base order
    std::vector<int32_t> ids((size_t)T);
    for (int64_t i = 0; i < T; ++i) ids[(size_t)i] = (int32_t)i;

    std::vector<std::pair<float, int32_t>> keyed;   // per-node sort scratch
    std::vector<Vec3> pre_lo, pre_hi, suf_lo, suf_hi;

    int32_t next_node = 0;
    int max_depth_seen = 0;

    std::vector<Work> work;
    work.push_back({next_node++, 0, T, 0});
    while (!work.empty()) {
        const Work w = work.back();
        work.pop_back();
        max_depth_seen = std::max(max_depth_seen, (int)w.depth);
        const int64_t n = w.end - w.begin;

        Vec3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = w.begin; i < w.end; ++i) {
            const int32_t t = ids[(size_t)i];
            lo = vmin(lo, {tile_lo[3 * t + 0], tile_lo[3 * t + 1],
                           tile_lo[3 * t + 2]});
            hi = vmax(hi, {tile_hi[3 * t + 0], tile_hi[3 * t + 1],
                           tile_hi[3 * t + 2]});
        }
        float *nb = nbox + 8 * (int64_t)w.node;
        nb[0] = lo.x; nb[1] = lo.y; nb[2] = lo.z;
        nb[3] = hi.x; nb[4] = hi.y; nb[5] = hi.z;
        nb[6] = 0.0f; nb[7] = 0.0f;
        int32_t *nm = nmeta + 4 * (int64_t)w.node;

        if (n == 1) {
            const int32_t t = ids[(size_t)w.begin];
            nm[0] = 0; nm[1] = 0;
            nm[2] = leaf_tile[t]; nm[3] = leaf_inst[t];
            continue;
        }

        // largest centroid-extent axis (first max on ties, like np.argmax)
        Vec3 c_lo = {1e30f, 1e30f, 1e30f}, c_hi = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = w.begin; i < w.end; ++i) {
            c_lo = vmin(c_lo, cent[(size_t)ids[(size_t)i]]);
            c_hi = vmax(c_hi, cent[(size_t)ids[(size_t)i]]);
        }
        const float ext[3] = {c_hi.x - c_lo.x, c_hi.y - c_lo.y,
                              c_hi.z - c_lo.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        // stable sort of the subrange by centroid on that axis
        keyed.resize((size_t)n);
        for (int64_t i = 0; i < n; ++i) {
            const int32_t t = ids[(size_t)(w.begin + i)];
            const float k = axis == 0 ? cent[(size_t)t].x
                          : axis == 1 ? cent[(size_t)t].y
                                      : cent[(size_t)t].z;
            keyed[(size_t)i] = {k, t};
        }
        std::stable_sort(keyed.begin(), keyed.end(),
                         [](const std::pair<float, int32_t> &a,
                            const std::pair<float, int32_t> &b) {
                             return a.first < b.first;
                         });
        for (int64_t i = 0; i < n; ++i)
            ids[(size_t)(w.begin + i)] = keyed[(size_t)i].second;

        int64_t split;
        const bool force_median = w.depth >= MAX_DEPTH - 2;
        if (force_median || ext[axis] <= 0.0f || n <= 4) {
            split = n / 2;
        } else {
            // exact sweep SAH on the sorted order, sampled at <= N_BINS
            // candidate split positions (np.linspace(1, n-1, 16) truncated
            // to int64, deduplicated)
            pre_lo.resize((size_t)n); pre_hi.resize((size_t)n);
            suf_lo.resize((size_t)n); suf_hi.resize((size_t)n);
            for (int64_t i = 0; i < n; ++i) {
                const int32_t t = ids[(size_t)(w.begin + i)];
                const Vec3 bl = {tile_lo[3 * t + 0], tile_lo[3 * t + 1],
                                 tile_lo[3 * t + 2]};
                const Vec3 bh = {tile_hi[3 * t + 0], tile_hi[3 * t + 1],
                                 tile_hi[3 * t + 2]};
                pre_lo[(size_t)i] = i ? vmin(pre_lo[(size_t)i - 1], bl) : bl;
                pre_hi[(size_t)i] = i ? vmax(pre_hi[(size_t)i - 1], bh) : bh;
            }
            for (int64_t i = n - 1; i >= 0; --i) {
                const int32_t t = ids[(size_t)(w.begin + i)];
                const Vec3 bl = {tile_lo[3 * t + 0], tile_lo[3 * t + 1],
                                 tile_lo[3 * t + 2]};
                const Vec3 bh = {tile_hi[3 * t + 0], tile_hi[3 * t + 1],
                                 tile_hi[3 * t + 2]};
                suf_lo[(size_t)i] =
                    i + 1 < n ? vmin(suf_lo[(size_t)i + 1], bl) : bl;
                suf_hi[(size_t)i] =
                    i + 1 < n ? vmax(suf_hi[(size_t)i + 1], bh) : bh;
            }
            int64_t ks[N_BINS];
            int n_ks = 0;
            if (n > N_BINS) {
                const double step = (double)(n - 2) / (N_BINS - 1);
                for (int i = 0; i < N_BINS; ++i) {
                    const int64_t k = (int64_t)(i * step + 1.0);
                    if (n_ks == 0 || ks[n_ks - 1] != k) ks[n_ks++] = k;
                }
            } else {
                for (int64_t k = 1; k < n; ++k) ks[n_ks++] = k;
            }
            double best = 0.0;
            int best_i = -1;
            for (int i = 0; i < n_ks; ++i) {
                const int64_t k = ks[i];
                const double cost =
                    (double)k *
                        (double)area(pre_lo[(size_t)k - 1],
                                     pre_hi[(size_t)k - 1]) +
                    (double)(n - k) *
                        (double)area(suf_lo[(size_t)k], suf_hi[(size_t)k]);
                if (best_i < 0 || cost < best) {  // first min, like argmin
                    best = cost;
                    best_i = i;
                }
            }
            split = ks[best_i];
        }

        const int32_t li = next_node;
        const int32_t ri = next_node + 1;
        next_node += 2;
        nm[0] = li; nm[1] = ri; nm[2] = -1; nm[3] = -1;
        // LIFO: push left then right -> right is processed first, matching
        // the NumPy builder's node numbering exactly
        work.push_back({li, w.begin, w.begin + split, w.depth + 1});
        work.push_back({ri, w.begin + split, w.end, w.depth + 1});
    }

    if ((int64_t)next_node != 2 * T - 1) return -1;
    return max_depth_seen + 1;
}

}  // extern "C"
