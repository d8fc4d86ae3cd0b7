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
// Design: one warp per (edge, q). Lane = dx * 4 + cg: the 8 lanes dx cover
// one window row, the 4 lanes cg split the 128 channels (16-byte vector
// loads, so a warp reads one 8-pixel window row as a contiguous 2 KB run);
// the patch feature stays in registers for both levels and all 8 rows, a
// two-step xor shuffle finishes each dot, a shuffle by 4 lanes brings the
// x+1 tap for the blend, and each lane stores (level 1, level 2) pairs for
// its shifts b = cg, cg + 4. The 9 pixels of one edge run in neighbouring
// warps of one block, so their overlapping windows are served from L1.
// Accumulation is f32 for f32 and bf16 inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int C = 128;  // feature channels
constexpr int PP = 9;   // 3x3 patch pixels
constexpr int D = 8;    // raw window (2R + 2, R = 3)
constexpr int d = 7;    // blended window
constexpr int NCOL = PP * d * d * 2;
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
        for (int i = 0; i < N; ++i) acc = fmaf(g[kc * N + i], f[i], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    raw[dy] = acc;
  }
}

// Bilinear blend of one level for output shift (a = dx, b); rawn = the
// x+1 column (from lane + 4).
__device__ __forceinline__ float blend(const float (&raw)[D],
                                       const float (&rawn)[D], int b,
                                       float fx, float fy) {
  return (1.f - fy) * (1.f - fx) * raw[b] + (1.f - fy) * fx * rawn[b] +
         fy * (1.f - fx) * raw[b + 1] + fy * fx * rawn[b + 1];
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_lattice_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                    const T* __restrict__ fmap2, const float* __restrict__ u,
                    const float* __restrict__ v, const int* __restrict__ cells,
                    T* __restrict__ out, int E, int M, int H1, int W1,
                    int H2, int W2) {
  constexpr int N = Vec<T>::N;
  constexpr int NCH = (C / 4) / N;
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long)E * PP) return;
  const int e = (int)(item / PP), q = (int)(item % PP);
  const int c = e / M, m = e % M;
  const int dx = lane >> 2, cg = lane & 3;
  T* orow = out + (size_t)e * NCOL + q * (d * d * 2);

  const int slot_j = cells[2 * c], gslot = cells[2 * c + 1];
  if (slot_j < 0) {  // dead cell: zeros
    if (dx < d) {
      Vec<T>::store2(orow + (dx * d + cg) * 2, 0.f, 0.f);
      if (cg + 4 < d) Vec<T>::store2(orow + (dx * d + cg + 4) * 2, 0.f, 0.f);
    }
    return;
  }

  float g[C / 4];
  const T* gp = gmap + (((size_t)gslot * M + m) * PP + q) * C;
#pragma unroll
  for (int kc = 0; kc < NCH; ++kc) {
    float t[N];
    Vec<T>::load(gp + (kc * 4 + cg) * N, t);
#pragma unroll
    for (int i = 0; i < N; ++i) g[kc * N + i] = t[i];
  }

  const float x1 = u[(size_t)e * PP + q], y1 = v[(size_t)e * PP + q];
  const float x2 = x1 * 0.25f, y2 = y1 * 0.25f;
  float raw1[D], raw2[D], n1[D], n2[D];
  window<T>(g, fmap1 + (size_t)slot_j * H1 * W1 * C, H1, W1, x1, y1, dx, cg,
            raw1);
  window<T>(g, fmap2 + (size_t)slot_j * H2 * W2 * C, H2, W2, x2, y2, dx, cg,
            raw2);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    n1[i] = __shfl_down_sync(0xffffffffu, raw1[i], 4);
    n2[i] = __shfl_down_sync(0xffffffffu, raw2[i], 4);
  }
  if (dx >= d) return;
  const float fx1 = x1 - floorf(x1), fy1 = y1 - floorf(y1);
  const float fx2 = x2 - floorf(x2), fy2 = y2 - floorf(y2);
#pragma unroll
  for (int b = 0; b < d; ++b) {
    if ((b & 3) != cg) continue;
    Vec<T>::store2(orow + (dx * d + b) * 2, blend(raw1, n1, b, fx1, fy1),
                   blend(raw2, n2, b, fx2, fy2));
  }
}

template <typename T>
int launch(const void* gmap, const void* fmap1, const void* fmap2,
           const float* u, const float* v, const int* cells, void* out,
           int E, int M, int H1, int W1, int H2, int W2, cudaStream_t s) {
  const long items = (long)E * PP;
  const int grid = (int)((items + WARPS - 1) / WARPS);
  corr_lattice_kernel<T><<<grid, WARPS * 32, 0, s>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
      static_cast<const T*>(fmap2), u, v, cells, static_cast<T*>(out), E, M,
      H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

}  // namespace

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* u_ = static_cast<const float*>(u);
  const float* v_ = static_cast<const float*>(v);
  const int* c_ = static_cast<const int*>(cells);
  if (is_bf16)
    return launch<__nv_bfloat16>(gmap, fmap1, fmap2, u_, v_, c_, out, E, M,
                                 H1, W1, H2, W2, s);
  return launch<float>(gmap, fmap1, fmap2, u_, v_, c_, out, E, M, H1, W1, H2,
                       W2, s);
}
