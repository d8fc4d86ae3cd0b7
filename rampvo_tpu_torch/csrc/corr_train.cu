// Training correlation on Hopper: forward (K7) and backward (K8).
//
// Replaces the TPU kernels rampvo_tpu/ops/corr_pallas.py::corr_sched_fused
// (K7, body _kernel_sched_fused2) and ::corr_sched_bwd (K8, body
// _kernel_sched_bwd), the forward and custom-VJP backward of
// corr_train_fused. It computes their function the way the exact XLA path
// (ops/corr.py::corr_train at both pyramid levels, stacked by corr_stack)
// does, not their TPU layout: no SPREAD window clip, no sorting of edges
// by target, no paired 128-lane output. For every edge e of a static flat
// edge list, every pixel q of its 3x3 patch and both levels l (level 1: the
// 1/4-res frame features, level 2: their 4x pool, coords / 4):
//   raw[dy][dx] = <gmap[kk[e], q, :], fmap_l[jj[e], y0-3+dy, x0-3+dx, :]>
// over 128 channels for the exact 8x8 window at (x0, y0) = floor(coords),
// taps outside the map reading 0; then the 2x2 bilinear blend to 7x7,
// written as out[e, ((q*7 + a)*7 + b)*2 + l] (a = x shift, b = y shift),
// the reference layout corr_fc1 reads.
//
// K7 is K1's design (csrc/corr_lattice.cu, whose window code is copied
// here) on a flat edge list: one warp per (edge, q); lane = dx * 4 + cg,
// the 8 lanes dx covering one window row and the 4 lanes cg splitting the
// channels; the patch feature stays in registers for both levels.
// Bound: operations in f32 (18000 edges: 5.3 GFLOP against ~0.2 GB of
// bytes), bytes in bf16.
//
// K8, per (edge, q) in the same lane layout: unblend the output gradient
// onto the 8x8 raw taps of each level (gv), then
//   grad_gmap[kk[e], q, :] += sum over taps of gv * fmap_l(tap)
//   grad_fmap_l[jj[e], tap, :] += gv * gmap[kk[e], q, :]
// with float32 atomics (four channels per atomic where sm_90 has the
// vector form). Taps that fall outside the map get nothing, and taps whose
// gv is exactly zero are skipped: the training forward keeps each edge's
// gradient with p = 0.2 per level, so most (edge, level) pairs have no
// gradient and cost one vote. Bound: about twice K7's operations on the
// kept pairs; the atomics' order changes from run to run.
// Accumulation is float32 for float32 and bf16 inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int C = 128;  // feature channels
constexpr int PP = 9;   // 3x3 patch pixels
constexpr int D = 8;    // raw window (2R + 2, R = 3)
constexpr int d = 7;    // blended window
constexpr int NCOL = PP * d * d * 2;
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

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

// float32 add of four consecutive values (16-byte aligned).
__device__ __forceinline__ void atomic_add4(float* p, float a, float b,
                                            float c, float e) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900) && \
    !defined(K8_SCALAR_ATOMICS)
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, e));
#else
  atomicAdd(p, a); atomicAdd(p + 1, b); atomicAdd(p + 2, c);
  atomicAdd(p + 3, e);
#endif
}

// floor(v) as an int, clamped so that far or non-finite coords read zeros.
__device__ __forceinline__ int floor_int(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

// The patch feature's channels of lane group cg, as float32.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ gp, int cg,
                                         float (&g)[C / 4]) {
  constexpr int N = Vec<T>::N;
  constexpr int NCH = (C / 4) / N;
#pragma unroll
  for (int kc = 0; kc < NCH; ++kc) {
    float t[N];
    Vec<T>::load(gp + (kc * 4 + cg) * N, t);
#pragma unroll
    for (int i = 0; i < N; ++i) g[kc * N + i] = t[i];
  }
}

// The 8x8 raw window of one level for this lane's column dx: raw[dy]
// (csrc/corr_lattice.cu).
template <typename T>
__device__ __forceinline__ void window(const float (&g)[C / 4],
                                       const T* __restrict__ fslot, int Hf,
                                       int Wf, float xf, float yf, int dx,
                                       int cg, float (&raw)[D]) {
  constexpr int N = Vec<T>::N;
  constexpr int NCH = (C / 4) / N;
  const int xx = floor_int(xf) - 3 + dx;
  const int y0 = floor_int(yf);
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
    acc += __shfl_xor_sync(FULL, acc, 1);
    acc += __shfl_xor_sync(FULL, acc, 2);
    raw[dy] = acc;
  }
}

__device__ __forceinline__ float blend(const float (&raw)[D],
                                       const float (&rawn)[D], int b,
                                       float fx, float fy) {
  return (1.f - fy) * (1.f - fx) * raw[b] + (1.f - fy) * fx * rawn[b] +
         fy * (1.f - fx) * raw[b + 1] + fy * fx * rawn[b + 1];
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_train_fwd_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                      const T* __restrict__ fmap2,
                      const float* __restrict__ coords,
                      const int* __restrict__ kk, const int* __restrict__ jj,
                      T* __restrict__ out, int E, int NG, int NF, int H1,
                      int W1, int H2, int W2) {
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long)E * PP) return;
  const int e = (int)(item / PP), q = (int)(item % PP);
  const int dx = lane >> 2, cg = lane & 3;
  T* orow = out + (size_t)e * NCOL + q * (d * d * 2);
  const int k = kk[e], j = jj[e];
  if (k < 0 || k >= NG || j < 0 || j >= NF) {  // no such row: zeros
    if (dx < d) {
      Vec<T>::store2(orow + (dx * d + cg) * 2, 0.f, 0.f);
      if (cg + 4 < d) Vec<T>::store2(orow + (dx * d + cg + 4) * 2, 0.f, 0.f);
    }
    return;
  }
  float g[C / 4];
  load_row<T>(gmap + ((size_t)k * PP + q) * C, cg, g);
  const float x1 = coords[((size_t)e * PP + q) * 2];
  const float y1 = coords[((size_t)e * PP + q) * 2 + 1];
  const float x2 = x1 * 0.25f, y2 = y1 * 0.25f;
  float raw1[D], raw2[D], n1[D], n2[D];
  window<T>(g, fmap1 + (size_t)j * H1 * W1 * C, H1, W1, x1, y1, dx, cg, raw1);
  window<T>(g, fmap2 + (size_t)j * H2 * W2 * C, H2, W2, x2, y2, dx, cg, raw2);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    n1[i] = __shfl_down_sync(FULL, raw1[i], 4);
    n2[i] = __shfl_down_sync(FULL, raw2[i], 4);
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

// One level of K8 for this lane's column dx: unblend, then the tap loop.
template <typename T>
__device__ __forceinline__ bool bwd_level(
    const float* __restrict__ crow, int l, const float (&g)[C / 4],
    const T* __restrict__ fslot, float* __restrict__ gfslot, int Hf, int Wf,
    float xf, float yf, int dx, int cg, float (&acc)[C / 4]) {
  constexpr int N = Vec<T>::N;
  constexpr int NCH = (C / 4) / N;
  const float fx = xf - floorf(xf), fy = yf - floorf(yf);
  // G(a, b): output gradient at x shift a, y shift b (0 outside 7x7)
  auto G = [&](int a, int b) -> float {
    return (a >= 0 && a < d && b >= 0 && b < d) ? crow[(a * d + b) * 2 + l]
                                                : 0.f;
  };
  float gv[D];
  bool nz = false;
#pragma unroll
  for (int dy = 0; dy < D; ++dy) {
    gv[dy] = (1.f - fy) * (1.f - fx) * G(dx, dy) +
             (1.f - fy) * fx * G(dx - 1, dy) +
             fy * (1.f - fx) * G(dx, dy - 1) + fy * fx * G(dx - 1, dy - 1);
    nz |= gv[dy] != 0.f;
  }
  if (!__any_sync(FULL, nz)) return false;
  const int xx = floor_int(xf) - 3 + dx;
  const int y0 = floor_int(yf);
  if (xx < 0 || xx >= Wf) return true;
#pragma unroll
  for (int dy = 0; dy < D; ++dy) {
    const int yy = y0 - 3 + dy;
    if (gv[dy] == 0.f || yy < 0 || yy >= Hf) continue;
    const size_t px = ((size_t)yy * Wf + xx) * C;
#pragma unroll
    for (int kc = 0; kc < NCH; ++kc) {
      const int c0 = (kc * 4 + cg) * N;
      float f[N];
      Vec<T>::load(fslot + px + c0, f);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[kc * N + i] = fmaf(gv[dy], f[i],
                                                         acc[kc * N + i]);
#pragma unroll
      for (int i = 0; i < N; i += 4)
        atomic_add4(gfslot + px + c0 + i, gv[dy] * g[kc * N + i],
                    gv[dy] * g[kc * N + i + 1], gv[dy] * g[kc * N + i + 2],
                    gv[dy] * g[kc * N + i + 3]);
    }
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_train_bwd_kernel(const float* __restrict__ ct,
                      const T* __restrict__ gmap, const T* __restrict__ fmap1,
                      const T* __restrict__ fmap2,
                      const float* __restrict__ coords,
                      const int* __restrict__ kk, const int* __restrict__ jj,
                      float* __restrict__ ggmap, float* __restrict__ gf1,
                      float* __restrict__ gf2, int E, int NG, int NF, int H1,
                      int W1, int H2, int W2) {
  constexpr int N = Vec<T>::N;
  constexpr int NCH = (C / 4) / N;
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long)E * PP) return;
  const int e = (int)(item / PP), q = (int)(item % PP);
  const int dx = lane >> 2, cg = lane & 3;
  const int k = kk[e], j = jj[e];
  if (k < 0 || k >= NG || j < 0 || j >= NF) return;
  const float* crow = ct + (size_t)e * NCOL + q * (d * d * 2);
  float g[C / 4], acc[C / 4];
  load_row<T>(gmap + ((size_t)k * PP + q) * C, cg, g);
#pragma unroll
  for (int i = 0; i < C / 4; ++i) acc[i] = 0.f;
  const float x1 = coords[((size_t)e * PP + q) * 2];
  const float y1 = coords[((size_t)e * PP + q) * 2 + 1];
  bool any = bwd_level<T>(crow, 0, g, fmap1 + (size_t)j * H1 * W1 * C,
                          gf1 + (size_t)j * H1 * W1 * C, H1, W1, x1, y1, dx,
                          cg, acc);
  any |= bwd_level<T>(crow, 1, g, fmap2 + (size_t)j * H2 * W2 * C,
                      gf2 + (size_t)j * H2 * W2 * C, H2, W2, x1 * 0.25f,
                      y1 * 0.25f, dx, cg, acc);
  if (!any) return;  // warp-uniform: both votes were unanimous
  // sum the 8 dx lanes of each channel group (lane = dx * 4 + cg)
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    acc[i] += __shfl_xor_sync(FULL, acc[i], 4);
    acc[i] += __shfl_xor_sync(FULL, acc[i], 8);
    acc[i] += __shfl_xor_sync(FULL, acc[i], 16);
  }
  if (dx != 0) return;
  float* grow = ggmap + ((size_t)k * PP + q) * C;
#pragma unroll
  for (int kc = 0; kc < NCH; ++kc)
#pragma unroll
    for (int i = 0; i < N; i += 4)
      atomic_add4(grow + (kc * 4 + cg) * N + i, acc[kc * N + i],
                  acc[kc * N + i + 1], acc[kc * N + i + 2],
                  acc[kc * N + i + 3]);
}

int grid_of(int E) { return (int)(((long)E * PP + WARPS - 1) / WARPS); }

}  // namespace

// gmap [NG, 9, 128], fmap1 [NF, H1, W1, 128], fmap2 [NF, H2, W2, 128] and
// out [E, 882] of one dtype (is_bf16); coords [E, 9, 2] float32 level-1
// (x, y); kk, jj [E] int32. Returns the cudaError_t of the launch.
extern "C" int corr_train_fwd_launch(const void* gmap, const void* fmap1,
                                     const void* fmap2, const void* coords,
                                     const void* kk, const void* jj,
                                     void* out, int E, int NG, int NF,
                                     int H1, int W1, int H2, int W2,
                                     int is_bf16, void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* co = static_cast<const float*>(coords);
  const int* k = static_cast<const int*>(kk);
  const int* j = static_cast<const int*>(jj);
  if (is_bf16) {
    using T = __nv_bfloat16;
    corr_train_fwd_kernel<T><<<grid_of(E), WARPS * 32, 0, s>>>(
        static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
        static_cast<const T*>(fmap2), co, k, j, static_cast<T*>(out), E, NG,
        NF, H1, W1, H2, W2);
  } else {
    corr_train_fwd_kernel<float><<<grid_of(E), WARPS * 32, 0, s>>>(
        static_cast<const float*>(gmap), static_cast<const float*>(fmap1),
        static_cast<const float*>(fmap2), co, k, j, static_cast<float*>(out),
        E, NG, NF, H1, W1, H2, W2);
  }
  return (int)cudaGetLastError();
}

// ct [E, 882] float32 (the output's gradient); gmap, fmap1, fmap2, coords,
// kk, jj as for the forward; ggmap [NG, 9, 128], gf1 [NF, H1, W1, 128] and
// gf2 [NF, H2, W2, 128] float32, zeroed by the caller, receive the sums.
extern "C" int corr_train_bwd_launch(const void* ct, const void* gmap,
                                     const void* fmap1, const void* fmap2,
                                     const void* coords, const void* kk,
                                     const void* jj, void* ggmap, void* gf1,
                                     void* gf2, int E, int NG, int NF,
                                     int H1, int W1, int H2, int W2,
                                     int is_bf16, void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(ct);
  const float* co = static_cast<const float*>(coords);
  const int* k = static_cast<const int*>(kk);
  const int* j = static_cast<const int*>(jj);
  float* gg = static_cast<float*>(ggmap);
  float* g1 = static_cast<float*>(gf1);
  float* g2 = static_cast<float*>(gf2);
  if (is_bf16) {
    using T = __nv_bfloat16;
    corr_train_bwd_kernel<T><<<grid_of(E), WARPS * 32, 0, s>>>(
        c, static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
        static_cast<const T*>(fmap2), co, k, j, gg, g1, g2, E, NG, NF, H1, W1,
        H2, W2);
  } else {
    corr_train_bwd_kernel<float><<<grid_of(E), WARPS * 32, 0, s>>>(
        c, static_cast<const float*>(gmap), static_cast<const float*>(fmap1),
        static_cast<const float*>(fmap2), co, k, j, gg, g1, g2, E, NG, NF, H1,
        W1, H2, W2);
  }
  return (int)cudaGetLastError();
}
