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
// the touched feature-ring slots add ~190 MB of reads. What limits the
// kernel is not device memory, though: the first design (one warp per
// (edge, pixel)) ran at 14x this bound on ~17.7 GB of L1/L2 window re-reads
// and f32 FMAs on the CUDA cores. This design (corr_window.cuh): one warp
// per edge; per level the union box of the 9 pixels' windows is read once
// (~2.8-4.5 GB of cache reads per launch) and dotted with all 9 pixels by
// mma.sync.m16n8k16 bf16 with f32 accumulation, B fragments straight from
// global memory; the raw dots go through shared memory, and the blended
// row leaves in coalesced stores. A level whose 9 floors span more than
// CAP = 8 taps on an axis takes an exact per-pixel slow path in the same
// kernel. float32 inputs keep f32 FMAs in the same box decomposition
// (lane = 4 channels, partial dots folded over the warp).
// csrc/corr_lattice_cb.cu (K6) computes the same outputs with a
// target-major decomposition and the same per-edge routine.

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
  return corrwin::launch_lattice_dtype<corrwin::RefStore>(
      gmap, fmap1, fmap2, u, v, cells, out, E, M, H1, W1, H2, W2, is_bf16,
      stream);
}

// Reads into *count (host memory) how many edges of this library's
// launches took the slow path since the last reset, after waiting for
// the device; `reset` then sets the counter to 0. Returns the cudaError_t.
extern "C" int corr_lattice_slow_edges(unsigned int* count, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(count, corrwin::slow_edges,
                                         sizeof(unsigned int));
  if (err == cudaSuccess && reset) {
    const unsigned int zero = 0;
    err = cudaMemcpyToSymbol(corrwin::slow_edges, &zero, sizeof(zero));
  }
  return (int)err;
}
