// Lattice correlation in the paired 128-column layout (Hopper).
//
// Replaces the TPU kernel rampvo_tpu/ops/corr_pallas.py::corr_lattice_fused2
// (body _kernel_lat_fused2). Same function as K1 (csrc/corr_lattice.cu:
// exact 8x8 windows of both levels, 2x2 bilinear blend, dead cells zero),
// handed to its consumer in the layout the TPU kernel emits: per edge
// [9 * 128] columns, column q*128 + l*64 + b*8 + a holding level l's
// blended window of pixel q at y shift b and x shift a (a, b < 7), the
// other 30 columns of each 128 zero. The update operator reads it through
// fold_corr_fc1(net, "paired") (models/vonet.py), whose weight has zero
// rows there. Not copied from the TPU kernel: the padded rings, binary
// lane rolls, the S4 extraction matmul, the SPREAD clamp and the 10-bit
// fixed-point blend weights; the blend is K1's, in float32.
//
// Bound on the H100: bytes. At E = 60000 the output is E * 1152 values
// (138 MB in bf16, against K1's 106 MB), the rest as K1.
// Design: K1's warp per (edge, pixel) (corr_window.cuh). Lane (dx, cg)
// writes columns (l, b, a = dx) for b = cg, cg + 4 at both levels, zeros
// where a or b is 7: the warp's four stores cover all 128 columns of its
// pixel (256 contiguous bytes in bf16), and the zero columns are written,
// never left as uninitialised memory (0 * NaN is NaN in the folded
// weight's product).

#include "corr_window.cuh"

namespace {

using namespace corrwin;

struct PairedStore {
  static constexpr int NCOL = PP * 128;
  static constexpr int PIX = 128;
  template <typename T>
  __device__ static void live(T* orow, const float (&raw1)[D],
                              const float (&raw2)[D], const float (&n1)[D],
                              const float (&n2)[D], float x1, float y1,
                              int dx, int cg) {
    const float x2 = __fmul_rn(x1, 0.25f), y2 = __fmul_rn(y1, 0.25f);
    const float fx1 = frac(x1), fy1 = frac(y1);
    const float fx2 = frac(x2), fy2 = frac(y2);
#pragma unroll
    for (int b = 0; b < D; ++b) {
      if ((b & 3) != cg) continue;
      float o1 = 0.f, o2 = 0.f;
      if (b < d && dx < d) {
        o1 = blend(raw1, n1, b, fx1, fy1);
        o2 = blend(raw2, n2, b, fx2, fy2);
      }
      Vec<T>::store1(orow + b * 8 + dx, o1);
      Vec<T>::store1(orow + 64 + b * 8 + dx, o2);
    }
  }
  template <typename T>
  __device__ static void dead(T* orow, int dx, int cg) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int b = cg + 4 * s;
      Vec<T>::store1(orow + b * 8 + dx, 0.f);
      Vec<T>::store1(orow + 64 + b * 8 + dx, 0.f);
    }
  }
};

}  // namespace

// As corr_lattice_launch (csrc/corr_lattice.cu), with out [E, 1152].
extern "C" int corr_paired_launch(const void* gmap, const void* fmap1,
                                  const void* fmap2, const void* u,
                                  const void* v, const void* cells,
                                  void* out, int E, int M, int H1, int W1,
                                  int H2, int W2, int is_bf16,
                                  void* stream) {
  using namespace corrwin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_lattice<__nv_bfloat16, PairedStore>(
        gmap, fmap1, fmap2, u, v, cells, out, E, M, H1, W1, H2, W2, s);
  return launch_lattice<float, PairedStore>(gmap, fmap1, fmap2, u, v, cells,
                                            out, E, M, H1, W1, H2, W2, s);
}
