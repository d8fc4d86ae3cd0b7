// Shared device code of the lattice correlation kernels (K1 corr_lattice,
// K4 corr_bands, K5 corr_paired, K6 corr_lattice_cb).
//
// One warp computes one (edge, patch pixel q): the exact 8x8 raw windows
//   raw[dy][dx] = <gmap[gslot, m, q, :], fmap[slot, y0-3+dy, x0-3+dx, :]>
// of both levels (level 1 at (x, y), level 2 at (x, y) / 4), taps outside
// the map reading 0 (altcorr correlation_kernel.cu:83-136). Lane = dx * 4 +
// cg: the 8 lanes dx cover one window row, the 4 lanes cg split the 128
// channels (16-byte vector loads, so a warp reads one 8-pixel window row as
// a contiguous run); the patch feature stays in registers for both levels;
// two xor shuffles finish each dot, so all four cg lanes of a column hold
// its sums. What each kernel writes is a Store policy:
//   S::NCOL  output columns per edge, S::PIX columns per patch pixel;
//   S::live(orow, raw1, raw2, n1, n2, x1, y1, dx, cg)  n = column dx + 1;
//   S::dead(orow, dx, cg)  the zeros of a dead cell.
// All arithmetic that reaches an output is written with explicit
// intrinsics (no contraction choices left to the compiler), so kernels that
// share a policy's arithmetic agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace corrwin {

constexpr int C = 128;  // feature channels
constexpr int PP = 9;   // 3x3 patch pixels
constexpr int D = 8;    // raw window (2R + 2, R = 3)
constexpr int d = 7;    // blended window
constexpr int WARPS = 8;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;  // channels per 16-byte load
  __device__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static void store1(float* p, float a) { *p = a; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static void store1(__nv_bfloat16* p, float a) {
    *p = __float2bfloat16_rn(a);
  }
};

// The 8x8 raw window of one level for this lane's column dx: raw[dy].
template <typename T>
__device__ __forceinline__ void window(const float (&g)[C / 4],
                                       const T* __restrict__ fslot, int Hf,
                                       int Wf, float xf, float yf, int dx,
                                       int cg, float (&raw)[D]) {
  constexpr int N = Vec<T>::N;
  constexpr int NCH = (C / 4) / N;  // 16-byte chunks per lane
  // clamp before the int conversion: far/non-finite coords read zeros
  const int x0 = (int)fminf(fmaxf(floorf(xf), -1e6f), 1e6f);
  const int y0 = (int)fminf(fmaxf(floorf(yf), -1e6f), 1e6f);
  const int xx = x0 - 3 + dx;
  const bool xin = xx >= 0 && xx < Wf;
#pragma unroll
  for (int dy = 0; dy < D; ++dy) {
    const int yy = y0 - 3 + dy;
    float acc = 0.f;
    if (xin && yy >= 0 && yy < Hf) {
      const T* px = fslot + ((size_t)yy * Wf + xx) * C;
#pragma unroll
      for (int kc = 0; kc < NCH; ++kc) {
        float f[N];
        Vec<T>::load(px + (kc * 4 + cg) * N, f);
#pragma unroll
        for (int i = 0; i < N; ++i) acc = __fmaf_rn(g[kc * N + i], f[i], acc);
      }
    }
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
    raw[dy] = acc;
  }
}

// Fractional part of a coordinate (the blend weight).
__device__ __forceinline__ float frac(float x) {
  return __fsub_rn(x, floorf(x));
}

// Bilinear blend of one level for output shift (a = dx, b); rawn = the
// x+1 column.
__device__ __forceinline__ float blend(const float (&raw)[D],
                                       const float (&rawn)[D], int b,
                                       float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  float acc = __fmul_rn(__fmul_rn(gy, gx), raw[b]);
  acc = __fmaf_rn(__fmul_rn(gy, fx), rawn[b], acc);
  acc = __fmaf_rn(__fmul_rn(fy, gx), raw[b + 1], acc);
  return __fmaf_rn(__fmul_rn(fy, fx), rawn[b + 1], acc);
}

// The whole warp: patch pixel feature gp [C] against the target slot's maps
// f1 [H1, W1, C] and f2 [H2, W2, C] at level-1 coords (x1, y1); hands the
// windows to the Store policy, which writes the pixel's columns at orow.
template <typename T, class S>
__device__ __forceinline__ void pixel(const T* __restrict__ gp,
                                      const T* __restrict__ f1,
                                      const T* __restrict__ f2, int H1,
                                      int W1, int H2, int W2, float x1,
                                      float y1, int lane, T* orow) {
  constexpr int N = Vec<T>::N;
  constexpr int NCH = (C / 4) / N;
  const int dx = lane >> 2, cg = lane & 3;
  float g[C / 4];
#pragma unroll
  for (int kc = 0; kc < NCH; ++kc) {
    float t[N];
    Vec<T>::load(gp + (kc * 4 + cg) * N, t);
#pragma unroll
    for (int i = 0; i < N; ++i) g[kc * N + i] = t[i];
  }
  float raw1[D], raw2[D], n1[D], n2[D];
  window<T>(g, f1, H1, W1, x1, y1, dx, cg, raw1);
  window<T>(g, f2, H2, W2, __fmul_rn(x1, 0.25f), __fmul_rn(y1, 0.25f), dx,
            cg, raw2);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    n1[i] = __shfl_down_sync(0xffffffffu, raw1[i], 4);
    n2[i] = __shfl_down_sync(0xffffffffu, raw2[i], 4);
  }
  S::template live<T>(orow, raw1, raw2, n1, n2, x1, y1, dx, cg);
}

// Reference layout [E, 882]: out[e, ((q*7 + a)*7 + b)*2 + l] (a = x shift,
// b = y shift, l = level), what corr_fc1's weights read unpermuted. Lane
// (dx, cg) stores (level 1, level 2) pairs for shifts b = cg, cg + 4.
struct RefStore {
  static constexpr int NCOL = PP * d * d * 2;
  static constexpr int PIX = d * d * 2;
  template <typename T>
  __device__ static void live(T* orow, const float (&raw1)[D],
                              const float (&raw2)[D], const float (&n1)[D],
                              const float (&n2)[D], float x1, float y1,
                              int dx, int cg) {
    if (dx >= d) return;
    const float x2 = __fmul_rn(x1, 0.25f), y2 = __fmul_rn(y1, 0.25f);
    const float fx1 = frac(x1), fy1 = frac(y1);
    const float fx2 = frac(x2), fy2 = frac(y2);
#pragma unroll
    for (int b = 0; b < d; ++b) {
      if ((b & 3) != cg) continue;
      Vec<T>::store2(orow + (dx * d + b) * 2, blend(raw1, n1, b, fx1, fy1),
                     blend(raw2, n2, b, fx2, fy2));
    }
  }
  template <typename T>
  __device__ static void dead(T* orow, int dx, int cg) {
    if (dx >= d) return;
    Vec<T>::store2(orow + (dx * d + cg) * 2, 0.f, 0.f);
    if (cg + 4 < d) Vec<T>::store2(orow + (dx * d + cg + 4) * 2, 0.f, 0.f);
  }
};

// One warp per (edge, q) of the lattice, edges in lattice order: edge e =
// (cell c = e / M, patch m = e % M); cells [NC, 2] = (target slot or -1
// for a dead cell, host gmap slot).
template <typename T, class S>
__global__ void __launch_bounds__(WARPS * 32)
lattice_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
               const T* __restrict__ fmap2, const float* __restrict__ u,
               const float* __restrict__ v, const int* __restrict__ cells,
               T* __restrict__ out, int E, int M, int H1, int W1, int H2,
               int W2) {
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long)E * PP) return;
  const int e = (int)(item / PP), q = (int)(item % PP);
  const int c = e / M, m = e % M;
  T* orow = out + (size_t)e * S::NCOL + q * S::PIX;
  const int slot_j = cells[2 * c], gslot = cells[2 * c + 1];
  if (slot_j < 0) {
    S::template dead<T>(orow, lane >> 2, lane & 3);
    return;
  }
  pixel<T, S>(gmap + (((size_t)gslot * M + m) * PP + q) * C,
              fmap1 + (size_t)slot_j * H1 * W1 * C,
              fmap2 + (size_t)slot_j * H2 * W2 * C, H1, W1, H2, W2,
              u[(size_t)e * PP + q], v[(size_t)e * PP + q], lane, orow);
}

// Launch lattice_kernel<T, S> over E edges; returns the cudaError_t.
template <typename T, class S>
int launch_lattice(const void* gmap, const void* fmap1, const void* fmap2,
                   const void* u, const void* v, const void* cells, void* out,
                   int E, int M, int H1, int W1, int H2, int W2,
                   cudaStream_t s) {
  const long items = (long)E * PP;
  const int grid = (int)((items + WARPS - 1) / WARPS);
  lattice_kernel<T, S><<<grid, WARPS * 32, 0, s>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
      static_cast<const T*>(fmap2), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<const int*>(cells),
      static_cast<T*>(out), E, M, H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

}  // namespace corrwin
