// Per-lane row gather from a resident table:
//   out[j, :] = table[clamp(idx[j], 0, V - 1), :]
//
// Replaces the Pallas TPU gather probe of tools/probe_pallas_gather.py
// (kernels `k_fancy` :54, `k_take` :58, `k_tala` :62 and `k_onehot` :72,
// launched through `call` :87; all four compute out[j] = tab[idx[j]]),
// generalised to rows. R = 1 is the probe (V = 4,096, L = 1,024); R = 8 is
// the packed-corner row of textures/volumes.py::_trilinear_gather (one row
// per voxel holding its 8 trilinear corners, e.g. 262,144 rows of 32 bytes
// for a 64^3 grid). Contract (see ops/gather.py):
//   table (V, R) f32, contiguous; idx (L,) i32 or i64; out (L, R) f32.
// Out-of-range indices are clamped, as the jnp gathers of the reference
// clamp them.
//
// Design: one thread per (lane, 16-byte chunk) when R is a multiple of 4
// (float4 loads and stores; neighbouring threads read neighbouring chunks
// of a row and write neighbouring chunks of the output), else one thread
// per (lane, element). No shared memory: each row is read once per lane
// that asks for it, and repeated rows hit L2.
//
// Bound on an H100: bytes. The function moves L * (idx bytes + 2 * R * 4)
// bytes (each index read once, each gathered row read and written once)
// and does no arithmetic, so the least time is those bytes over 3.35 TB/s.
// Random rows cost whole 32-byte sectors: a 32-byte packed-corner row is
// exactly one sector, a 4-byte probe row wastes 28 of its sector's bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Idx, int kVec>
__global__ void __launch_bounds__(kThreads) grid_gather_kernel(
    const float *__restrict__ table, const Idx *__restrict__ idx,
    float *__restrict__ out, int64_t n_rows, int64_t chunks, int64_t total) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= total) return;
  const int64_t lane = i / chunks;
  const int64_t c = i - lane * chunks;
  int64_t r = static_cast<int64_t>(idx[lane]);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  if constexpr (kVec == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4 *>(table) +
                           r * chunks + c);
    reinterpret_cast<float4 *>(out)[lane * chunks + c] = v;
  } else {
    out[lane * chunks + c] = __ldg(table + r * chunks + c);
  }
}

template <typename Idx>
void launch(const float *table, const Idx *idx, float *out, int64_t n_rows,
            int n_cols, int64_t n_lanes, bool vec4, cudaStream_t stream) {
  const int64_t chunks = vec4 ? n_cols / 4 : n_cols;
  const int64_t total = n_lanes * chunks;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (vec4) {
    grid_gather_kernel<Idx, 4><<<blocks, kThreads, 0, stream>>>(
        table, idx, out, n_rows, chunks, total);
  } else {
    grid_gather_kernel<Idx, 1><<<blocks, kThreads, 0, stream>>>(
        table, idx, out, n_rows, chunks, total);
  }
}

}  // namespace

// Launch on `stream` (no sync). vec4 needs n_cols % 4 == 0 and 16-byte
// aligned table and out. Returns cudaGetLastError() after the launch.
extern "C" int grid_gather_launch(const void *table, const void *idx,
                                  void *out, long long n_rows, int n_cols,
                                  long long n_lanes, int idx_is_64, int vec4,
                                  void *stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto *tab = static_cast<const float *>(table);
  auto *o = static_cast<float *>(out);
  if (idx_is_64) {
    launch(tab, static_cast<const int64_t *>(idx), o, n_rows, n_cols,
           n_lanes, vec4 != 0, s);
  } else {
    launch(tab, static_cast<const int32_t *>(idx), o, n_rows, n_cols,
           n_lanes, vec4 != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
