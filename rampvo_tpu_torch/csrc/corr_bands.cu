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
// Design: K1's warp per (edge, pixel) (corr_window.cuh). After the xor
// shuffles every lane of column dx holds the whole column, so lane (dx, cg)
// writes rows dy = cg, cg + 4 of both levels: four stores cover the
// pixel's 128 contiguous values.

#include "corr_window.cuh"

namespace {

using namespace corrwin;

struct BandStore {
  static constexpr int NCOL = PP * 2 * D * D;
  static constexpr int PIX = 2 * D * D;
  template <typename T>
  __device__ static void live(T* orow, const float (&raw1)[D],
                              const float (&raw2)[D], const float (&)[D],
                              const float (&)[D], float, float, int dx,
                              int cg) {
#pragma unroll
    for (int dy = 0; dy < D; ++dy) {
      if ((dy & 3) != cg) continue;
      Vec<T>::store1(orow + dy * D + dx, raw1[dy]);
      Vec<T>::store1(orow + D * D + dy * D + dx, raw2[dy]);
    }
  }
  template <typename T>
  __device__ static void dead(T* orow, int dx, int cg) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int dy = cg + 4 * s;
      Vec<T>::store1(orow + dy * D + dx, 0.f);
      Vec<T>::store1(orow + D * D + dy * D + dx, 0.f);
    }
  }
};

}  // namespace

// As corr_lattice_launch (csrc/corr_lattice.cu), with out [E, 9, 2, 8, 8].
extern "C" int corr_bands_launch(const void* gmap, const void* fmap1,
                                 const void* fmap2, const void* u,
                                 const void* v, const void* cells, void* out,
                                 int E, int M, int H1, int W1, int H2, int W2,
                                 int is_bf16, void* stream) {
  using namespace corrwin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_lattice<__nv_bfloat16, BandStore>(
        gmap, fmap1, fmap2, u, v, cells, out, E, M, H1, W1, H2, W2, s);
  return launch_lattice<float, BandStore>(gmap, fmap1, fmap2, u, v, cells,
                                          out, E, M, H1, W1, H2, W2, s);
}
