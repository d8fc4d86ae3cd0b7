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
//
// Design (corr_bins.cuh): `paired_keys`, one warp per lattice edge, bins
// each live edge by (target slot, level-1 tile) or sends it to the
// residual list, and writes the zero rows of dead cells; then the scan,
// the scatter and the persistent blocks that stage each bin's target taps
// in shared memory and run K1's per-edge arithmetic on them (bf16; float32
// keeps K1's global-memory routine on the binned order), residual edges
// with K1's routine in the same launch. The store, PairedStore: per level,
// lane (b = lane / 4, a = 2 (lane % 4)) writes columns (l, b, a) and
// (l, b, a + 1) of every pixel in one store, zeros where a or b is 7: a
// warp's store covers the level's 64 columns of a pixel (128 contiguous
// bytes in bf16), and the zero columns are written, never left as
// uninitialised memory (0 * NaN is NaN in the folded weight's product).
// K5 equals K1 through ops/corr_perms.py::paired_corr_perm bit for bit.

#include "corr_bins.cuh"

namespace {

using namespace corrbins;

struct PairedStore {
  static constexpr int NCOL = PP * 128;
  static constexpr int STAGE = 0;
  template <typename T, int RSX = RS>  // RSX: floats per raw pixel row
  __device__ static void level(int l, T* orow, const float* raw,
                               const Geom& gm, int lane, float*) {
    const int b = lane >> 2, a = (lane & 3) * 2;
    for (int q = 0; q < PP; ++q) {
      const int ox = __shfl_sync(FULL, gm.ox, q);
      const int oy = __shfl_sync(FULL, gm.oy, q);
      const float fx = __shfl_sync(FULL, gm.fx, q);
      const float fy = __shfl_sync(FULL, gm.fy, q);
      const float* p = raw + q * RSX + (oy + b) * gm.bw + ox + a;
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

// cells [E / M, 2] int32 (target slot or -1, host gmap slot).
template <typename T>
__global__ void __launch_bounds__(KEY_WARPS * 32)
paired_keys(const float* __restrict__ u, const float* __restrict__ v,
            const int* __restrict__ cells, T* __restrict__ out, Scratch s,
            Grid g, int E, int M, int H1, int W1, int H2, int W2) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * KEY_WARPS + (threadIdx.x >> 5);
  if (e >= E) return;
  const int c = e / M, slot = cells[2 * c];
  if (slot < 0) {
    PairedStore::dead<T>(out + (size_t)e * PairedStore::NCOL, lane);
    no_bin(s, e, lane);
    return;
  }
  bin_edge(s, g, e, slot, cells[2 * c + 1], u + (size_t)e * PP,
           v + (size_t)e * PP, H1, W1, H2, W2, lane);
}

template <typename T>
int launch(const void* gmap, const void* fmap1, const void* fmap2,
           const void* u, const void* v, const void* cells, void* out,
           void* scratch, long scratch_n, const int* gi, int E, int M, int H1,
           int W1, int H2, int W2, cudaStream_t st) {
  if (E == 0) return 0;
  const Grid g = grid_from(gi);
  if ((size_t)scratch_n < scratch_words(E, g))
    return (int)cudaErrorInvalidValue;
  const Scratch s = carve(static_cast<int*>(scratch), E, g);
  int err = start(s, g, st);
  if (err) return err;
  paired_keys<T><<<(E + KEY_WARPS - 1) / KEY_WARPS, KEY_WARPS * 32, 0, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const int*>(cells), static_cast<T*>(out), s, g, E, M, H1,
      W1, H2, W2);
  err = (int)cudaGetLastError();
  if (err) return err;
  Args<T> a{static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
            static_cast<const T*>(fmap2), static_cast<const float*>(u),
            static_cast<const float*>(v), static_cast<T*>(out), E, M, H1, W1,
            H2, W2, 0};
  return finish<T, PairedStore>(a, s, g, st);
}

}  // namespace

// As corr_lattice_launch (csrc/corr_lattice.cu), with out [E, 1152], the
// scratch of `scratch_n` int32 words (ops/corr_bins.py::scratch_words) and
// the bin grid gi (ops/corr_bins.py::BinGrid, in field order, host memory).
extern "C" int corr_paired_launch(const void* gmap, const void* fmap1,
                                  const void* fmap2, const void* u,
                                  const void* v, const void* cells,
                                  void* out, void* scratch, long scratch_n,
                                  const int* gi, int E, int M, int H1,
                                  int W1, int H2, int W2, int is_bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(gmap, fmap1, fmap2, u, v, cells, out,
                                 scratch, scratch_n, gi, E, M, H1, W1, H2, W2,
                                 st);
  return launch<float>(gmap, fmap1, fmap2, u, v, cells, out, scratch,
                       scratch_n, gi, E, M, H1, W1, H2, W2, st);
}

// Edges of this library's launches that took K1's slow path (all of them
// residual edges) since the last reset, as corr_lattice_slow_edges.
extern "C" int corr_paired_slow_edges(unsigned int* count, int reset) {
  return corrbins::read_slow_edges(count, reset);
}
