// Cell-batched, target-major lattice correlation (Hopper).
//
// Replaces the TPU kernel rampvo_tpu/ops/corr_pallas.py::corr_lattice_fused4
// (body _kernel_lat_fused4, tables _cell_tables_a). Its function is K1's
// (csrc/corr_lattice.cu): the reference layout [E, 882], dead cells zero.
// What it keeps from the TPU kernel is the decomposition: work is grouped
// per (target frame a, t-band of TB offsets), and each group walks its live
// t-range [lo, hi] with a loop whose bounds it reads from the group table
// (ops/corr_kernels.py::cell_tables_a), so one group's cells all read the
// same target slot (the feature ring of one frame stays hot in L2 while the
// group runs). Its work item is a (cell, patch) edge handled by one warp
// with K1's per-edge routine (corr_window.cuh::edge: window unions,
// mma.sync dots, the exact slow path), so K6 equals K1 bit for bit.
//
// Differences from the TPU kernel. A block writes its own output rows in
// lattice order, so the target-major output and the row gather that
// restores lattice order (corr_pallas.py:1625-1640) are not copied. TB = 13
// gives NTGT * ceil(T / TB) = 36 * 2 = 72 groups at the main path's
// lattice, too few blocks for 132 SMs, and of very unequal work (0 to 13
// cells); so each group is also split over ranges of EB patches (EB = 4:
// 72 * 24 = 1728 blocks of 4 warps, one patch per warp and cell;
// `chip_smoke.py --k6-splits` times EB = 1..32 against K1). Cells
// that no group walks (host below 0, or target outside the last NTGT
// frames) are zeroed by the grid's trailing NC blocks, one per lattice
// cell, which write zeros where cell_tables_a's `walked` is 0; cells a
// group walks but that are dead (cell_valid false) get zeros from the
// group. The zero fill is part of this launch and of its time.
//
// Bound on the H100: bytes, as K1's: E * 882 output values (106 MB in
// bf16 at E = 60000) plus the touched ring slots.

#include "corr_window.cuh"

namespace {

using namespace corrwin;

// groups [NB, 6] int32 (a, t-band, target slot, out row, lo, hi; an empty
// group has lo > hi); cells_a [NB * TB, 2] int32 at g * TB + tc (lattice
// cell c, or -1 - c when the cell is dead; host gmap slot); walked [NC]
// int32.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
corr_lattice_cb_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                       const T* __restrict__ fmap2,
                       const float* __restrict__ u,
                       const float* __restrict__ v,
                       const int* __restrict__ groups,
                       const int* __restrict__ cells_a,
                       const int* __restrict__ walked, T* __restrict__ out,
                       int NB, int splits, int EB, int TB, int M,
                       int H1, int W1, int H2, int W2) {
  constexpr int NCOL = RefStore::NCOL;
  __shared__ __align__(16) float raw[WARPS][RAW + RefStore::STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = blockIdx.x;
  if (blk >= NB * splits) {  // zero fill of one unwalked lattice cell
    const int c = blk - NB * splits;
    if (walked[c]) return;
    T* base = out + (size_t)c * M * NCOL;
    const size_t n = (size_t)M * NCOL;
    if ((n * sizeof(T)) % 16 == 0) {
      uint4* p = reinterpret_cast<uint4*>(base);
      const size_t n16 = n * sizeof(T) / 16;
      for (size_t i = threadIdx.x; i < n16; i += blockDim.x)
        p[i] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (size_t i = 2 * threadIdx.x; i < n; i += 2 * blockDim.x)
        Vec<T>::store2(base + i, 0.f, 0.f);  // NCOL is even
    }
    return;
  }
  // The group's live t-range x the block's patches, one (cell, patch) edge
  // per warp and turn. The tables are read again each turn (L1) rather
  // than held in registers across the edge routine.
  const int g = blk / splits, m0 = (blk % splits) * EB;
  const int npatch = min(EB, M - m0);
  const int lo = groups[6 * g + 4];
  const int total = (groups[6 * g + 5] - lo + 1) * npatch;  // <= 0: empty
  for (int it = warp; it < total; it += WARPS) {
    const int tc = lo + it / npatch, m = m0 + it % npatch;
    const int* ce = cells_a + 2 * ((size_t)g * TB + tc);
    const int cenc = ce[0], gslot = ce[1], slot_j = groups[6 * g + 2];
    const int c = cenc >= 0 ? cenc : -1 - cenc;
    const size_t e = (size_t)c * M + m;
    T* orow = out + e * NCOL;
    if (cenc < 0) {
      RefStore::dead<T>(orow, lane);
      continue;
    }
    edge<T, RefStore>(gmap + ((size_t)gslot * M + m) * PP * C,
                      fmap1 + (size_t)slot_j * H1 * W1 * C,
                      fmap2 + (size_t)slot_j * H2 * W2 * C, H1, W1, H2, W2,
                      u + e * PP, v + e * PP, raw[warp], lane, orow);
  }
}

template <typename T>
int launch(const void* gmap, const void* fmap1, const void* fmap2,
           const void* u, const void* v, const void* groups,
           const void* cells_a, const void* walked, void* out, int NB,
           int NC, int EB, int TB, int M, int H1, int W1, int H2, int W2,
           cudaStream_t s) {
  const int splits = (M + EB - 1) / EB;
  corr_lattice_cb_kernel<T><<<NB * splits + NC, WARPS * 32, 0, s>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
      static_cast<const T*>(fmap2), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<const int*>(groups),
      static_cast<const int*>(cells_a), static_cast<const int*>(walked),
      static_cast<T*>(out), NB, splits, EB, TB, M, H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

}  // namespace

// gmap, fmap1, fmap2, u, v as corr_lattice_launch (csrc/corr_lattice.cu);
// groups [NB, 6], cells_a [NB * TB, 2] and walked [NC] int32 from
// ops/corr_kernels.py::cell_tables_a; out [NC * M, 882]. Returns the
// cudaError_t of the launch.
extern "C" int corr_lattice_cb_launch(
    const void* gmap, const void* fmap1, const void* fmap2, const void* u,
    const void* v, const void* groups, const void* cells_a,
    const void* walked, void* out, int NB, int NC, int EB, int TB, int M,
    int H1, int W1, int H2, int W2, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(gmap, fmap1, fmap2, u, v, groups, cells_a,
                                 walked, out, NB, NC, EB, TB, M, H1, W1, H2,
                                 W2, s);
  return launch<float>(gmap, fmap1, fmap2, u, v, groups, cells_a, walked,
                       out, NB, NC, EB, TB, M, H1, W1, H2, W2, s);
}
