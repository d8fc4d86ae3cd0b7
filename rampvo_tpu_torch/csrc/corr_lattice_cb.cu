// Target-binned lattice correlation in the reference layout (Hopper).
//
// Replaces the TPU kernel rampvo_tpu/ops/corr_pallas.py::corr_lattice_fused4
// (body _kernel_lat_fused4, tables _cell_tables_a). Its function is K1's
// (csrc/corr_lattice.cu): the reference layout [E, 882], dead cells and
// cells no group walks zero. What it takes from the TPU kernel is the
// grouping of the work by target frame: the edges it computes are those
// its walk tables reach (ops/corr_kernels.py::cell_tables_a: per (target
// a, t-band) group the live t-range [lo, hi]), and it computes them target
// by target. Not copied: the TPU kernel's padded rings, strips, lane rolls
// and SPREAD clamp, its target-major output and the row gather that
// restores lattice order (corr_pallas.py:1625-1640); each edge's row is
// written in place.
//
// Design (corr_bins.cuh): `cb_keys`, one warp per (group, t, patch) of the
// walk, bins each walked live edge by (target slot, level-1 tile) or sends
// it to the residual list, and writes the zero rows of dead walked cells;
// its trailing warps, one per lattice edge, write the zero rows of the
// cells no group walks. Then the scan, the scatter and the persistent
// blocks that stage each bin's target taps in shared memory and run K1's
// per-edge arithmetic with RefStore's blends on them (bf16), or K1's
// global-memory routine on the binned order (float32); residual edges run
// K1's routine in the same launch. So K6 equals K1 bit for bit. The bin building, the zero
// fills and the residual edges are all part of this launch and its time.
//
// Bound on the H100: bytes, as K1's: E * 882 output values (106 MB in bf16
// at E = 60000) plus the touched ring slots.

#include "corr_bins.cuh"

namespace {

using namespace corrbins;

// groups [NB, 6] int32 (a, t-band, target slot, out row, lo, hi; an empty
// group has lo > hi); cells_a [NB * TB, 2] int32 at g * TB + tc (lattice
// cell c, or -1 - c when the cell is dead; host gmap slot); walked [NC].
template <typename T>
__global__ void __launch_bounds__(KEY_WARPS * 32)
cb_keys(const float* __restrict__ u, const float* __restrict__ v,
        const int* __restrict__ groups, const int* __restrict__ cells_a,
        const int* __restrict__ walked, T* __restrict__ out, Scratch s,
        Grid g, int NB, int TB, int NC, int M, int H1, int W1, int H2,
        int W2) {
  const int lane = threadIdx.x & 31;
  const long w = (long)blockIdx.x * KEY_WARPS + (threadIdx.x >> 5);
  const long nwalk = (long)NB * TB * M;
  if (w >= nwalk) {  // zero rows of the cells no group walks
    const long e = w - nwalk;
    if (e >= (long)NC * M || walked[e / M]) return;
    RefStoreRows::dead<T>(out + e * RefStoreRows::NCOL, lane);
    no_bin(s, (int)e, lane);
    return;
  }
  const int grp = (int)(w / ((long)TB * M));
  const int r = (int)(w - (long)grp * TB * M);
  const int tc = r / M, m = r - tc * M;
  if (tc < groups[6 * grp + 4] || tc > groups[6 * grp + 5]) return;
  const int* ce = cells_a + 2 * ((size_t)grp * TB + tc);
  const int cenc = ce[0];
  const int c = cenc >= 0 ? cenc : -1 - cenc;
  const int e = c * M + m;
  if (cenc < 0) {
    RefStoreRows::dead<T>(out + (size_t)e * RefStoreRows::NCOL, lane);
    no_bin(s, e, lane);
    return;
  }
  bin_edge(s, g, e, groups[6 * grp + 2], ce[1], u + (size_t)e * PP,
           v + (size_t)e * PP, H1, W1, H2, W2, lane);
}

template <typename T>
int launch(const void* gmap, const void* fmap1, const void* fmap2,
           const void* u, const void* v, const void* groups,
           const void* cells_a, const void* walked, void* out, void* scratch,
           long scratch_n, const int* gi, int NB, int NC, int TB, int M,
           int H1, int W1, int H2, int W2, cudaStream_t st) {
  const Grid g = grid_from(gi);
  const int E = NC * M;
  if ((size_t)scratch_n < scratch_words(E, g))
    return (int)cudaErrorInvalidValue;
  const Scratch s = carve(static_cast<int*>(scratch), E, g);
  int err = start(s, g, st);
  if (err) return err;
  const long warps = (long)NB * TB * M + E;
  cb_keys<T><<<(warps + KEY_WARPS - 1) / KEY_WARPS, KEY_WARPS * 32, 0, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const int*>(groups), static_cast<const int*>(cells_a),
      static_cast<const int*>(walked), static_cast<T*>(out), s, g, NB, TB,
      NC, M, H1, W1, H2, W2);
  err = (int)cudaGetLastError();
  if (err) return err;
  Args<T> a{static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
            static_cast<const T*>(fmap2), static_cast<const float*>(u),
            static_cast<const float*>(v), static_cast<T*>(out), E, M, H1, W1,
            H2, W2, 0};
  return finish<T, RefStoreRows>(a, s, g, st);
}

}  // namespace

// gmap, fmap1, fmap2, u, v as corr_lattice_launch (csrc/corr_lattice.cu);
// groups [NB, 6], cells_a [NB * TB, 2] and walked [NC] int32 from
// ops/corr_kernels.py::cell_tables_a; out [NC * M, 882]; scratch
// `scratch_n` int32 words (ops/corr_bins.py::scratch_words); gi the bin
// grid (ops/corr_bins.py::BinGrid, in field order, host memory). Returns the
// cudaError_t of the launches.
extern "C" int corr_lattice_cb_launch(
    const void* gmap, const void* fmap1, const void* fmap2, const void* u,
    const void* v, const void* groups, const void* cells_a,
    const void* walked, void* out, void* scratch, long scratch_n,
    const int* gi, int NB, int NC, int TB, int M, int H1, int W1, int H2,
    int W2, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(gmap, fmap1, fmap2, u, v, groups, cells_a,
                                 walked, out, scratch, scratch_n, gi, NB, NC,
                                 TB, M, H1, W1, H2, W2, st);
  return launch<float>(gmap, fmap1, fmap2, u, v, groups, cells_a, walked, out,
                       scratch, scratch_n, gi, NB, NC, TB, M, H1, W1, H2, W2,
                       st);
}

// Edges of this library's launches that took K1's slow path (all of them
// residual edges) since the last reset, as corr_lattice_slow_edges.
extern "C" int corr_lattice_cb_slow_edges(unsigned int* count, int reset) {
  return corrbins::read_slow_edges(count, reset);
}
