// Two-level lattice correlation with bilinear blend (Hopper).
//
// Replaces the TPU kernel rampvo_tpu/ops/corr_pallas.py::corr_lattice_fused3
// (kernel body _kernel_lat_fused3). It computes the kernel's function, not
// its TPU layout: for every edge e = (cell c, patch m) of the [NI, T, M]
// lattice and every patch pixel q of the 3x3 patch, at level 1 (the 1/4-res
// feature ring) and level 2 (the 1/16-res ring, coords / 4):
//   raw[dy][dx] = <gmap[gslot_c, m, q, :], fmap[slot_c, y0-3+dy, x0-3+dx, :]>
// over 128 channels for an exact 8x8 window at (x0, y0) = floor(coords),
// taps outside the map reading 0 (altcorr correlation_kernel.cu:83-136);
// then the 2x2 bilinear blend to 7x7 (:221-232), written in the reference
// layout out[e, ((q*7 + a)*7 + b)*2 + l] (a = x shift, b = y shift,
// l = level), which is what corr_fc1's weights read. Edges of dead cells
// (cells[c].slot_j < 0) get zeros. No SPREAD clamp, no strips, no lane
// rolls: every window is exact.
//
// Bound on the H100: bytes. At the full lattice (E = 60000) the output is
// E * 882 values (106 MB in bf16) against ~17.7 GFLOP of dot products, and
// the touched feature-ring slots add ~190 MB of reads.
// Design (corr_window.cuh): one warp per (edge, q), edge-major: the 9
// pixels of one edge run in neighbouring warps of one block, so their
// overlapping windows are served from L1. Accumulation is f32 for f32 and
// bf16 inputs. csrc/corr_lattice_cb.cu (K6) computes the same outputs with
// a target-major decomposition and the same arithmetic.

#include "corr_window.cuh"

// gmap [MEM, M, 9, 128], fmap1 [MEM, H1, W1, 128], fmap2 [MEM, H2, W2, 128]
// and out [E, 882] of one dtype (is_bf16); u, v [E * 9] float32 level-1
// coords; cells [E / M, 2] int32 (target slot or -1, host gmap slot).
// Returns the cudaError_t of the launch.
extern "C" int corr_lattice_launch(const void* gmap, const void* fmap1,
                                   const void* fmap2, const void* u,
                                   const void* v, const void* cells,
                                   void* out, int E, int M, int H1, int W1,
                                   int H2, int W2, int is_bf16,
                                   void* stream) {
  using namespace corrwin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_lattice<__nv_bfloat16, RefStore>(
        gmap, fmap1, fmap2, u, v, cells, out, E, M, H1, W1, H2, W2, s);
  return launch_lattice<float, RefStore>(gmap, fmap1, fmap2, u, v, cells,
                                         out, E, M, H1, W1, H2, W2, s);
}
