// Unblended lattice correlation windows (Hopper).
//
// Replaces the TPU kernel rampvo_tpu/ops/corr_pallas.py::_lattice_bands
// (body _kernel_lat, behind corr_lattice2 and corr_lattice2_stacked): the
// raw 8x8 integer-aligned correlation windows of every (edge, patch pixel,
// level) of the lattice, out [E, 9, 2, 8, 8] in the rings' dtype,
// out[e, q, l, dy, dx] = <gmap[gslot, m, q, :], fmap_l[slot, y0-3+dy,
// x0-3+dx, :]> (exact windows, taps outside the map 0; dead cells zero).
// The bilinear blend and the layout run after it in plain PyTorch
// (ops/corr_band_kernels.py), as the JAX package runs them in XLA. Not
// copied: the padded rings, the TX = 24 tile (its 16 extra columns are
// Mosaic alignment slack), the per-window dynamic lane roll and the SPREAD
// clamp; and the band follows the rings' dtype (the TPU band is bf16
// whatever its input).
//
// Bound on the H100: bytes. At E = 60000 the output is E * 1152 values
// (138 MB in bf16), the rest as K1 (csrc/corr_lattice.cu); the finish then
// reads the bands again and writes E * 882 values.
// Design: K1's warp per edge (corr_window.cuh: window unions, mma.sync
// dots, raw windows in shared memory). Per level, lane (dy = lane / 4,
// dx = 2 (lane % 4)) copies two raw taps of every pixel's window out of
// the box: a warp's store covers the level's 64 contiguous values.

#include "corr_window.cuh"

namespace {

using namespace corrwin;

struct BandStore {
  static constexpr int NCOL = PP * 2 * D * D;
  static constexpr int STAGE = 0;
  template <typename T>
  __device__ static void level(int l, T* orow, const float* raw,
                               const Geom& gm, int lane, float*) {
    const int dy = lane >> 2, dx = (lane & 3) * 2;
    for (int q = 0; q < PP; ++q) {
      const int ox = __shfl_sync(FULL, gm.ox, q);
      const int oy = __shfl_sync(FULL, gm.oy, q);
      const float* p = raw + q * RS + (oy + dy) * gm.bw + ox + dx;
      Vec<T>::store2(orow + (q * 2 + l) * D * D + dy * D + dx, p[0], p[1]);
    }
  }
  template <typename T>
  __device__ static void dead(T* orow, int lane) {
    zero_row<T>(orow, NCOL, lane);
  }
};

}  // namespace

// As corr_lattice_launch (csrc/corr_lattice.cu), with out [E, 9, 2, 8, 8].
extern "C" int corr_bands_launch(const void* gmap, const void* fmap1,
                                 const void* fmap2, const void* u,
                                 const void* v, const void* cells, void* out,
                                 int E, int M, int H1, int W1, int H2, int W2,
                                 int is_bf16, void* stream) {
  return corrwin::launch_lattice_dtype<BandStore>(
      gmap, fmap1, fmap2, u, v, cells, out, E, M, H1, W1, H2, W2, is_bf16,
      stream);
}
