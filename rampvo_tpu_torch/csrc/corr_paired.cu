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
// Design: K1's warp per edge (corr_window.cuh: window unions, mma.sync
// dots, raw windows in shared memory). Per level, lane (b = lane / 4,
// a = 2 (lane % 4)) writes columns (l, b, a) and (l, b, a + 1) of every
// pixel in one store, zeros where a or b is 7: a warp's store covers the
// level's 64 columns of a pixel (128 contiguous bytes in bf16), and the
// zero columns are written, never left as uninitialised memory (0 * NaN is
// NaN in the folded weight's product).

#include "corr_window.cuh"

namespace {

using namespace corrwin;

struct PairedStore {
  static constexpr int NCOL = PP * 128;
  static constexpr int STAGE = 0;
  template <typename T>
  __device__ static void level(int l, T* orow, const float* raw,
                               const Geom& gm, int lane, float*) {
    const int b = lane >> 2, a = (lane & 3) * 2;
    for (int q = 0; q < PP; ++q) {
      const int ox = __shfl_sync(FULL, gm.ox, q);
      const int oy = __shfl_sync(FULL, gm.oy, q);
      const float fx = __shfl_sync(FULL, gm.fx, q);
      const float fy = __shfl_sync(FULL, gm.fy, q);
      const float* p = raw + q * RS + (oy + b) * gm.bw + ox + a;
      float o0 = 0.f, o1 = 0.f;
      if (b < d) {
        o0 = blend(p, gm.bw, fx, fy);
        if (a + 1 < d) o1 = blend(p + 1, gm.bw, fx, fy);
      }
      Vec<T>::store2(orow + q * 128 + l * 64 + b * 8 + a, o0, o1);
    }
  }
  template <typename T>
  __device__ static void dead(T* orow, int lane) {
    zero_row<T>(orow, NCOL, lane);
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
  return corrwin::launch_lattice_dtype<PairedStore>(
      gmap, fmap1, fmap2, u, v, cells, out, E, M, H1, W1, H2, W2, is_bf16,
      stream);
}
