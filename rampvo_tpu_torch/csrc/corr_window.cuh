// Shared device code of the correlation kernels (K1 corr_lattice, K4
// corr_bands, K5 corr_paired, K6 corr_lattice_cb, and the training
// forward K7 in corr_train.cu): the per-edge routine.
//
// The function, per edge (patch features gp [9, 128], target maps f1, f2,
// level-1 coords of the 9 patch pixels): the exact 8x8 raw windows
//   raw[q][dy][dx] = <gp[q, :], fmap[y0_q - 3 + dy, x0_q - 3 + dx, :]>
// of both levels (level 1 at (x, y), level 2 at (x, y) / 4, (x0, y0) =
// floor), taps outside the map reading 0 (altcorr correlation_kernel.cu:
// 83-136), handed to a Store policy that blends and writes them.
//
// What bounded the first design on the H100 (one warp per (edge, pixel),
// lane = window column x channel quarter): each pixel re-read its whole
// 8x8 window of 256-byte tap rows from L1/L2 -- 9 pixels x 2 levels x 64
// taps per edge, ~17.7 GB of cache reads per 60000-edge launch, though the
// 9 pixels of a patch look at nearly the same taps -- and the dots ran as
// f32 FMAs on the CUDA cores with two shuffles per tap row. Device memory
// was never the limit.
//
// This design: one warp per edge.
//  * Window union. Per level the 9 floors span a box of (8 + span_x) x
//    (8 + span_y) taps (~10x10 for a real 3x3 patch). Each box tap row is
//    read once per edge and dotted with all 9 pixels at once.
//  * bf16 dots on the tensor cores: A = the 9 pixel features padded to 16
//    rows (registers, loaded once for both levels), B = 8 box taps per
//    n-tile, mma.sync.m16n8k16 with f32 accumulation, 8 k-steps per tile.
//    B comes straight from global memory: a dot product does not care
//    about channel order, so k is permuted identically in A and B and
//    each lane's 16-byte load (8 channels of its tap) is the B fragment of
//    two k-steps. No shared-memory staging of features, no ldmatrix. The
//    other warps of the SM hide the loads' latency: issuing the next
//    tile's loads before this tile's mmas (-DCORR_PREFETCH) measured 6%
//    slower, at 16 more registers.
//  * The raw dots [9][box] go to the warp's shared memory (RS floats per
//    pixel row); each output picks its 2x2 raw taps out of the box by its
//    pixel's offset from the box origin, blends, and consecutive lanes
//    store consecutive outputs (full-width coalesced rows).
//  * Cap and slow path. Nothing bounds the spread of the 9 pixels (depth
//    discontinuities, bad poses, the +-1e6 clamp of far and non-finite
//    coords). A level whose span exceeds CAP = 8 on either axis takes the
//    per-pixel form inside the same kernel: 9 passes, pass q dotting
//    pixel q's own 8x8 window (a box of 64 taps at offset 0) and keeping
//    row q. Same mma sequence per tap, so both forms agree bit for bit.
//    `slow_edges` counts the edges that took it.
//  * float32 inputs keep f32 FMA arithmetic (no TF32: their tolerance is
//    1e-5 of scale) in the same decomposition: same boxes, cap, slow path,
//    raw windows and stores. Lane = 4 channels: the 9 pixel features sit
//    in 36 registers, a warp reads a box tap as one coalesced 512-byte
//    row, every lane forms its 9 partial dots, and the partials of 4 taps
//    (36 values) are summed over the warp by a folding butterfly (37
//    shuffles) that leaves each sum in one lane. The main path is bf16.
//
// Store policy S: S::NCOL output columns per edge; S::STAGE floats of the
// warp's shared memory carried from level 1 to level 2; S::level<T>(l,
// orow, raw, geom, lane, stage) writes level l's share of the edge's row;
// S::dead<T>(orow, lane) the zeros of a dead cell. All arithmetic that
// reaches an output is written with explicit intrinsics (no contraction
// choices left to the compiler) and every kernel calls the same
// `edge<T, S>`, so kernels that share a policy's arithmetic agree bit for
// bit.
//
// What bounds it now: the box taps' reads from L2 (~2-3 GB a launch at
// ~5 TB/s, measured by chip_smoke.py), not device memory and not the
// tensor cores; grouping the edges by target slot (K6) changes nothing.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace corrwin {

constexpr int C = 128;  // feature channels
constexpr int PP = 9;   // 3x3 patch pixels
constexpr int D = 8;    // raw window (2R + 2, R = 3)
constexpr int d = 7;    // blended window
#ifndef CORR_WARPS
#define CORR_WARPS 4
#endif
constexpr int WARPS = CORR_WARPS;  // edges per block
#ifndef CORR_MIN_BLOCKS
#define CORR_MIN_BLOCKS 4
#endif
constexpr int MIN_BLOCKS = CORR_MIN_BLOCKS;  // blocks per SM ptxas aims at
constexpr int CAP = 8;             // largest span of the 9 floors per axis
constexpr int BOX = D + CAP;       // largest box side
constexpr int RS = BOX * BOX + 8;  // floats per pixel row of raw dots
                                   // (RS % 32 == 8: conflict-free stores)
constexpr int RAW = PP * RS;       // floats of shared memory per warp
constexpr unsigned FULL = 0xffffffffu;

// Edges whose spread exceeded CAP at either level.
__device__ unsigned int slow_edges;

template <typename T> struct Vec;
template <> struct Vec<float> {
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct Vec<__nv_bfloat16> {
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// floor(v) as an int, clamped before the conversion: far and non-finite
// coords land outside every map and read zeros.
__device__ __forceinline__ int floor_int(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

// Fractional part of a coordinate (the blend weight).
__device__ __forceinline__ float frac(float x) {
  return __fsub_rn(x, floorf(x));
}

// One level's geometry of one edge. Lane q < 9 holds pixel q's values
// (lanes 9.. repeat pixel 8); the box fields are the same in every lane.
struct Geom {
  float fx, fy;  // blend weights of this lane's pixel
  int x0, y0;    // floor of this lane's pixel
  int ox, oy;    // its window's offset inside the box (0 in per-pixel form)
  int bx, by;    // map coords of the box's first tap (box form)
  int bw, bh;    // box size in taps (8 x 8 in per-pixel form)
  bool fits;     // box form (both spans <= CAP)
};

__device__ __forceinline__ Geom geometry(float xf, float yf) {
  Geom g;
  g.fx = frac(xf); g.fy = frac(yf);
  g.x0 = floor_int(xf); g.y0 = floor_int(yf);
  const int xlo = __reduce_min_sync(FULL, g.x0);
  const int xhi = __reduce_max_sync(FULL, g.x0);
  const int ylo = __reduce_min_sync(FULL, g.y0);
  const int yhi = __reduce_max_sync(FULL, g.y0);
  g.fits = xhi - xlo <= CAP && yhi - ylo <= CAP;
  g.bx = xlo - 3; g.by = ylo - 3;
  g.bw = g.fits ? xhi - xlo + D : D;
  g.bh = g.fits ? yhi - ylo + D : D;
  g.ox = g.fits ? g.x0 - xlo : 0;
  g.oy = g.fits ? g.y0 - ylo : 0;
  return g;
}

// Bilinear blend of the 2x2 raw taps at p (x shift a, y shift b of a
// window whose rows are bw floats apart).
__device__ __forceinline__ float blend(const float* p, int bw, float fx,
                                       float fy) {
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  float acc = __fmul_rn(__fmul_rn(gy, gx), p[0]);
  acc = __fmaf_rn(__fmul_rn(gy, fx), p[1], acc);
  acc = __fmaf_rn(__fmul_rn(fy, gx), p[bw], acc);
  return __fmaf_rn(__fmul_rn(fy, fx), p[bw + 1], acc);
}

// ---------------------------------------------------------------------------
// bf16: dots on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of the 8 k-steps: rows = the edge's 9 pixels (rows 9..15
// zero), lane (g = lane / 4, t = lane % 4). Lane's 16-byte chunk j * 4 + t
// (channels 8 (j * 4 + t) ..+7) of row g feeds k-steps 2j (words 0, 1) and
// 2j + 1 (words 2, 3); the B fragments use the same chunk of their tap, so
// every product pairs equal channels.
__device__ __forceinline__ void load_a(const __nv_bfloat16* __restrict__ gp,
                                       int lane, uint32_t (&a)[8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = (j * 4 + t) * 8;
    const uint4 lo = *reinterpret_cast<const uint4*>(gp + g * C + ch);
    uint4 hi = make_uint4(0u, 0u, 0u, 0u);
    if (g == 0) hi = *reinterpret_cast<const uint4*>(gp + 8 * C + ch);
    a[2 * j][0] = lo.x; a[2 * j][1] = hi.x;
    a[2 * j][2] = lo.y; a[2 * j][3] = hi.y;
    a[2 * j + 1][0] = lo.z; a[2 * j + 1][1] = hi.z;
    a[2 * j + 1][2] = lo.w; a[2 * j + 1][3] = hi.w;
  }
}

// This lane's four chunks of box tap (tx, ty), zeros outside the map or
// beyond the box.
__device__ __forceinline__ bool load_b(const __nv_bfloat16* __restrict__ fslot,
                                       int Hf, int Wf, int bx, int by, int tx,
                                       int ty, int bh, int t,
                                       uint4 (&b)[4]) {
  const int x = bx + tx, y = by + ty;
  const bool in = ty < bh && x >= 0 && x < Wf && y >= 0 && y < Hf;
  if (in) {
    const __nv_bfloat16* p = fslot + ((size_t)y * Wf + x) * C + t * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const uint4*>(p + j * 32);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = make_uint4(0u, 0u, 0u, 0u);
  }
  return in;
}

// Dots of the 9 pixels against a box of bw x bh taps at (bx, by), into
// raw[q * RS + tap] (tap = ty * bw + tx). row < 0 writes all 9 rows, else
// only that pixel's. n-tile = 8 consecutive taps; lane (g, t) loads tap g.
__device__ __forceinline__ void dots_mma(const uint32_t (&a)[8][4],
                                         const __nv_bfloat16* __restrict__ fslot,
                                         int Hf, int Wf, int bx, int by,
                                         int bw, int bh, int row,
                                         float* __restrict__ raw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ntile = (bw * bh + 7) >> 3;
  int ty = 0, tx = g;  // bw >= 8 > g
#ifdef CORR_PREFETCH  // build variant: start the next tile's loads early
  uint4 bn[4];
  bool in_n = load_b(fslot, Hf, Wf, bx, by, tx, ty, bh, t, bn);
#endif
  for (int tile = 0; tile < ntile; ++tile) {
    uint4 b[4];
#ifdef CORR_PREFETCH
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bn[j];
    const bool in = in_n;
#else
    const bool in = load_b(fslot, Hf, Wf, bx, by, tx, ty, bh, t, b);
#endif
    const bool any = __any_sync(FULL, in);
    tx += 8;
    if (tx >= bw) { tx -= bw; ++ty; }
#ifdef CORR_PREFETCH
    if (tile + 1 < ntile)
      in_n = load_b(fslot, Hf, Wf, bx, by, tx, ty, bh, t, bn);
#endif
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if (any) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma16816(c, a[2 * j], b[j].x, b[j].y);
        mma16816(c, a[2 * j + 1], b[j].z, b[j].w);
      }
    }
    float* col = raw + tile * 8 + 2 * t;
    if (row < 0) {
      *reinterpret_cast<float2*>(col + g * RS) = make_float2(c[0], c[1]);
      if (g == 0)
        *reinterpret_cast<float2*>(col + 8 * RS) = make_float2(c[2], c[3]);
    } else if (row == g) {
      *reinterpret_cast<float2*>(col + g * RS) = make_float2(c[0], c[1]);
    } else if (row == 8 && g == 0) {
      *reinterpret_cast<float2*>(col + 8 * RS) = make_float2(c[2], c[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: dots as f32 FMAs, lane = 4 channels
// ---------------------------------------------------------------------------

// One step of the folding butterfly: N values per lane become (N + 1) / 2,
// each the sum of a value of this lane and of lane ^ bit; the lanes with
// `bit` set keep the upper half of the values.
template <int N>
__device__ __forceinline__ void fold(float (&v)[36], int lane, int bit) {
  constexpr int Hh = (N + 1) / 2;
  const bool up = lane & bit;
#pragma unroll
  for (int i = 0; i < Hh; ++i) {
    const float lo = v[i], hi = i + Hh < N ? v[i + Hh] : 0.f;
    v[i] = __fadd_rn(up ? hi : lo,
                     __shfl_xor_sync(FULL, up ? lo : hi, bit));
  }
}

// As dots_mma, with g[q] = this lane's 4 channels of pixel q. Four taps a
// turn: 36 partial dots per lane (index k * 9 + q), folded over the warp.
__device__ __forceinline__ void dots_fma(const float4 (&g)[PP],
                                         const float* __restrict__ fslot,
                                         int Hf, int Wf, int bx, int by,
                                         int bw, int bh, int row,
                                         float* __restrict__ raw, int lane) {
  const int ntap = bw * bh;
  // which of the 36 sums the folds leave in this lane's v[0], v[1]
  int own[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int i4 = i + 2 * (lane & 1), i3 = i4 + 3 * ((lane >> 1) & 1);
    const int i2 = i3 + 5 * ((lane >> 2) & 1);
    own[i] = (i4 < 3 && i3 < 5 && i2 < 9)
                 ? i2 + 9 * ((lane >> 3) & 1) + 18 * ((lane >> 4) & 1) : -1;
  }
  int tx = 0, ty = 0;
  for (int t0 = 0; t0 < ntap; t0 += 4) {
    float v[36];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int xk = tx + k, yk = ty;
      if (xk >= bw) { xk -= bw; ++yk; }  // bw >= 8 > k
      const int x = bx + xk, y = by + yk;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (yk < bh && x >= 0 && x < Wf && y >= 0 && y < Hf)
        f = *reinterpret_cast<const float4*>(
            fslot + ((size_t)y * Wf + x) * C + 4 * lane);
#pragma unroll
      for (int q = 0; q < PP; ++q)
        v[k * PP + q] = __fmaf_rn(
            g[q].w, f.w,
            __fmaf_rn(g[q].z, f.z,
                      __fmaf_rn(g[q].y, f.y, __fmul_rn(g[q].x, f.x))));
    }
    tx += 4;
    if (tx >= bw) { tx -= bw; ++ty; }
    fold<36>(v, lane, 16);
    fold<18>(v, lane, 8);
    fold<9>(v, lane, 4);
    fold<5>(v, lane, 2);
    fold<3>(v, lane, 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = own[i] / PP, q = own[i] - k * PP;
      if (own[i] >= 0 && (row < 0 || row == q)) raw[q * RS + t0 + k] = v[i];
    }
  }
}

// The operand the dots keep in registers for both levels: the edge's 9
// pixel features as mma A fragments (bf16) or 4 channels a lane (f32).
template <typename T> struct Feat;
template <> struct Feat<__nv_bfloat16> {
  uint32_t a[8][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* gp, int lane) {
    load_a(gp, lane, a);
  }
  __device__ __forceinline__ void box(const __nv_bfloat16* fslot, int Hf,
                                      int Wf, int bx, int by, int bw, int bh,
                                      int row, float* raw, int lane) const {
    dots_mma(a, fslot, Hf, Wf, bx, by, bw, bh, row, raw, lane);
  }
};
template <> struct Feat<float> {
  float4 g[PP];
  __device__ __forceinline__ void load(const float* gp, int lane) {
#pragma unroll
    for (int q = 0; q < PP; ++q)
      g[q] = *reinterpret_cast<const float4*>(gp + q * C + 4 * lane);
  }
  __device__ __forceinline__ void box(const float* fslot, int Hf, int Wf,
                                      int bx, int by, int bw, int bh, int row,
                                      float* raw, int lane) const {
    dots_fma(g, fslot, Hf, Wf, bx, by, bw, bh, row, raw, lane);
  }
};

// One level's raw dots of one edge: the box, or pixel by pixel.
template <typename T>
__device__ __forceinline__ void dots(const Feat<T>& ft,
                                     const T* __restrict__ fslot, int Hf,
                                     int Wf, const Geom& gm,
                                     float* __restrict__ raw, int lane) {
  if (gm.fits) {
    ft.box(fslot, Hf, Wf, gm.bx, gm.by, gm.bw, gm.bh, -1, raw, lane);
    return;
  }
  for (int q = 0; q < PP; ++q)  // the exact slow path of a wide edge
    ft.box(fslot, Hf, Wf, __shfl_sync(FULL, gm.x0, q) - 3,
           __shfl_sync(FULL, gm.y0, q) - 3, D, D, q, raw, lane);
}

// ---------------------------------------------------------------------------
// the edge
// ---------------------------------------------------------------------------

// One warp, one edge: patch features gp [9, C] against the target slot's
// maps f1 [H1, W1, C] and f2 [H2, W2, C] at the level-1 coords of pixel q
// up[q * cs], vp[q * cs] (cs = 1: planar u, v rows of the lattice; cs = 2:
// interleaved (x, y) pairs of the training edge list); raw = the warp's
// RAW + S::STAGE floats of shared memory; the Store policy writes the
// edge's row orow.
template <typename T, class S>
__device__ __forceinline__ void edge(const T* __restrict__ gp,
                                     const T* __restrict__ f1,
                                     const T* __restrict__ f2, int H1, int W1,
                                     int H2, int W2,
                                     const float* __restrict__ up,
                                     const float* __restrict__ vp,
                                     float* __restrict__ raw, int lane,
                                     T* __restrict__ orow, int cs = 1) {
  const int qi = lane < PP ? lane : PP - 1;
  const float x1 = up[qi * cs], y1 = vp[qi * cs];
  Feat<T> ft;
  ft.load(gp, lane);
  float* stage = raw + RAW;
  bool fits = true;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const Geom gm = l == 0 ? geometry(x1, y1)
                           : geometry(__fmul_rn(x1, 0.25f),
                                      __fmul_rn(y1, 0.25f));
    fits = fits && gm.fits;
    dots<T>(ft, l == 0 ? f1 : f2, l == 0 ? H1 : H2, l == 0 ? W1 : W2, gm, raw,
            lane);
    __syncwarp();
    S::template level<T>(l, orow, raw, gm, lane, stage);
    __syncwarp();
  }
  if (lane == 0 && !fits) atomicAdd(&slow_edges, 1u);
}

// Zeros over an edge's n output columns (n even), coalesced.
template <typename T>
__device__ __forceinline__ void zero_row(T* orow, int n, int lane) {
  for (int i = 2 * lane; i < n; i += 64) Vec<T>::store2(orow + i, 0.f, 0.f);
}

// Reference layout [E, 882]: out[e, ((q*7 + a)*7 + b)*2 + l] (a = x shift,
// b = y shift, l = level), what corr_fc1's weights read unpermuted. Lane
// handles the (level 1, level 2) pairs p = lane + 32 i of (q, a, b): level
// 1's blends wait in the warp's stage for level 2's, then each pair is one
// store and a warp's stores cover consecutive addresses.
struct RefStore {
  static constexpr int NCOL = PP * d * d * 2;
  static constexpr int NP = PP * d * d;
  static constexpr int STAGE = (NP + 7) / 8 * 8;
  template <typename T>
  __device__ static void level(int l, T* orow, const float* raw,
                               const Geom& gm, int lane, float* stage) {
    for (int p = lane; p < (NP + 31) / 32 * 32; p += 32) {
      const int pc = p < NP ? p : 0;
      const int q = pc / (d * d), r = pc - q * (d * d);
      const int a = r / d, b = r - a * d;
      const int ox = __shfl_sync(FULL, gm.ox, q);
      const int oy = __shfl_sync(FULL, gm.oy, q);
      const float fx = __shfl_sync(FULL, gm.fx, q);
      const float fy = __shfl_sync(FULL, gm.fy, q);
      const float v = blend(raw + q * RS + (oy + b) * gm.bw + ox + a, gm.bw,
                            fx, fy);
      if (p >= NP) continue;
      if (l == 0)
        stage[p] = v;
      else
        Vec<T>::store2(orow + 2 * p, stage[p], v);
    }
  }
  template <typename T>
  __device__ static void dead(T* orow, int lane) {
    zero_row<T>(orow, NCOL, lane);
  }
};

// One warp per edge of the lattice, edges in lattice order: edge e =
// (cell c = e / M, patch m = e % M); cells [NC, 2] = (target slot or -1
// for a dead cell, host gmap slot).
template <typename T, class S>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
lattice_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
               const T* __restrict__ fmap2, const float* __restrict__ u,
               const float* __restrict__ v, const int* __restrict__ cells,
               T* __restrict__ out, int E, int M, int H1, int W1, int H2,
               int W2) {
  __shared__ __align__(16) float raw[WARPS][RAW + S::STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * WARPS + warp;
  if (e >= E) return;
  const int c = e / M, m = e % M;
  T* orow = out + (size_t)e * S::NCOL;
  const int slot_j = cells[2 * c], gslot = cells[2 * c + 1];
  if (slot_j < 0) {
    S::template dead<T>(orow, lane);
    return;
  }
  edge<T, S>(gmap + ((size_t)gslot * M + m) * PP * C,
             fmap1 + (size_t)slot_j * H1 * W1 * C,
             fmap2 + (size_t)slot_j * H2 * W2 * C, H1, W1, H2, W2,
             u + (size_t)e * PP, v + (size_t)e * PP, raw[warp], lane, orow);
}

// Launch lattice_kernel<T, S> over E edges; returns the cudaError_t.
template <typename T, class S>
int launch_lattice(const void* gmap, const void* fmap1, const void* fmap2,
                   const void* u, const void* v, const void* cells, void* out,
                   int E, int M, int H1, int W1, int H2, int W2,
                   cudaStream_t s) {
  if (E == 0) return 0;
  lattice_kernel<T, S><<<(E + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
      static_cast<const T*>(fmap2), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<const int*>(cells),
      static_cast<T*>(out), E, M, H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

// The K1-K6 libraries' launch entry: dispatch on the rings' dtype.
template <class S>
int launch_lattice_dtype(const void* gmap, const void* fmap1,
                         const void* fmap2, const void* u, const void* v,
                         const void* cells, void* out, int E, int M, int H1,
                         int W1, int H2, int W2, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_lattice<__nv_bfloat16, S>(gmap, fmap1, fmap2, u, v, cells,
                                            out, E, M, H1, W1, H2, W2, s);
  return launch_lattice<float, S>(gmap, fmap1, fmap2, u, v, cells, out, E, M,
                                  H1, W1, H2, W2, s);
}

}  // namespace corrwin
