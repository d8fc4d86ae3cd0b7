// Lattice correlation windows for the folded layout (Hopper): the raw
// bands, and the blended folded layout in one pass.
//
// Replaces the TPU kernel rampvo_tpu/ops/corr_pallas.py::_lattice_bands
// (body _kernel_lat, behind corr_lattice2 and corr_lattice2_stacked).
//
// corr_bands_launch: the raw 8x8 integer-aligned correlation windows of
// every (edge, patch pixel, level) of the lattice, out [E, 9, 2, 8, 8] in
// the rings' dtype, out[e, q, l, dy, dx] = <gmap[gslot, m, q, :],
// fmap_l[slot, y0-3+dy, x0-3+dx, :]> (exact windows, taps outside the map
// 0; dead cells zero), the port of _lattice_bands itself; corr_lattice2
// and corr_lattice2_stacked(folded=False) blend it in plain PyTorch
// (ops/corr_band_kernels.py), as the JAX package blends it in XLA.
//
// corr_folded_launch: what CORR_LAYOUT "folded" reads,
// corr_lattice2_stacked(folded=True), with the blend inside the kernel:
// out [E, 882], column l*441 + q*49 + b*7 + a holding level l's blended
// window of patch pixel q at x shift a and y shift b
// (ops/corr_perms.py::folded_corr_perm maps it to the reference layout).
// The blend is K1's (corr_window.cuh::blend, float32), rounded once to the
// rings' dtype, so the output equals K1's permuted, bit for bit.
//
// Not copied: the padded rings, the TX = 24 tile (its 16 extra columns are
// Mosaic alignment slack), the per-window dynamic lane roll and the SPREAD
// clamp; and the band follows the rings' dtype (the TPU band is bf16
// whatever its input).
//
// Bound on the H100: bytes. At E = 60000 the band is E * 1152 values (138
// MB in bf16), the folded output E * 882 (106 MB, K1's), the rest as K1
// (csrc/corr_lattice.cu). Blending after the band kernel in PyTorch read
// the band back and wrote the blends and their concatenation: 2.37 ms an
// update against the kernel's 0.53.
// Design: K1's warp per edge (corr_window.cuh: window unions, mma.sync
// dots, raw windows in shared memory) with two Store policies. BandStore:
// per level, lane (dy = lane / 4, dx = 2 (lane % 4)) copies two raw taps of
// every pixel's window out of the box: a warp's store covers the level's
// 64 contiguous values. FoldedStore: each level holds 441 columns, an odd
// count, so in bf16 the pair (440, 441) straddles the levels and level 2
// starts at an odd column. Each level writes 220 pairs that start on an
// even column and the odd one out alone (columns 440, 441). Keeping level
// 1's blends in the warp's stage, as K1's RefStore does, and writing the
// row as 441 pairs once level 2 is blended measured slower (PERF.md).

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct FoldedStore {
  static constexpr int NP = PP * d * d;  // columns a level
  static constexpr int NCOL = 2 * NP;
  static constexpr int STAGE = 0;

  // The blended value of column p (< NP) of a level: pixel q = p / 49,
  // y shift b, x shift a. Every lane of the warp calls it (shuffles).
  __device__ static float value(int p, const float* raw, const Geom& gm) {
    const int q = p / (d * d), r = p - q * (d * d);
    const int b = r / d, a = r - b * d;
    const int ox = __shfl_sync(FULL, gm.ox, q);
    const int oy = __shfl_sync(FULL, gm.oy, q);
    const float fx = __shfl_sync(FULL, gm.fx, q);
    const float fy = __shfl_sync(FULL, gm.fy, q);
    return blend(raw + q * RS + (oy + b) * gm.bw + ox + a, gm.bw, fx, fy);
  }

  template <typename T>
  __device__ static void level(int l, T* orow, const float* raw,
                               const Geom& gm, int lane, float*) {
    // pairs (p, p + 1) at even columns l * NP + p (p = 2k + l), and the
    // column left over (level 1: p = 440; level 2: p = 0) alone
    constexpr int NPAIR = NP / 2;
    for (int k = lane; k < (NPAIR + 32) / 32 * 32; k += 32) {
      const bool pair = k < NPAIR;
      const int p0 = pair ? 2 * k + l : (l ? 0 : NP - 1);
      const float v0 = value(p0, raw, gm);
      const float v1 = value(pair ? p0 + 1 : p0, raw, gm);
      if (pair)
        Vec<T>::store2(orow + l * NP + p0, v0, v1);
      else if (k == NPAIR)
        store1(orow + l * NP + p0, v0);
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

// As corr_lattice_launch (csrc/corr_lattice.cu), with out [E, 882] in the
// folded layout.
extern "C" int corr_folded_launch(const void* gmap, const void* fmap1,
                                  const void* fmap2, const void* u,
                                  const void* v, const void* cells, void* out,
                                  int E, int M, int H1, int W1, int H2,
                                  int W2, int is_bf16, void* stream) {
  return corrwin::launch_lattice_dtype<FoldedStore>(
      gmap, fmap1, fmap2, u, v, cells, out, E, M, H1, W1, H2, W2, is_bf16,
      stream);
}
