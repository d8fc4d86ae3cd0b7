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
// the reference layout corr_fc1 reads. An edge whose kk or jj is out of
// range gets a row of zeros.
//
// K7 is K1's function on a flat edge list, so it runs K1's per-edge
// routine (corr_window.cuh::edge with the RefStore policy): one warp per
// edge; per level the union box of the 9 pixels' windows is read once and
// dotted with all 9 pixels (bf16: mma.sync.m16n8k16, f32 accumulation;
// f32: FMAs with the folding butterfly, no TF32); a level whose 9 floors
// span more than CAP = 8 taps takes the exact per-pixel slow path, counted
// in corrwin::slow_edges (read by corr_train_slow_edges). The coords are
// [E, 9, 2] interleaved, read with a coordinate stride of 2. What bounded
// the first design (one warp per (edge, pixel), each pixel re-reading its
// own 8x8 window of tap rows, f32 FMAs with two shuffles per tap): cache
// reads of 9 x 2 x 64 taps an edge. What bounds this one: the box taps'
// reads from L2, as for K1. The bound the kernels line states is
// operations in f32 (18000 edges: 5.3 GFLOP against ~0.2 GB of bytes) and
// bytes in bf16.
//
// K8, gather form with one atomic pass per (edge, level). What bounded
// the first design on the H100 (one warp per (edge, pixel), 32 float4
// atomics into grad fmap per kept (pixel, tap)): L2 atomics -- ~132 M
// vector atomics (~2.1 GB) per 18000-edge launch against ~2 GFLOP of
// arithmetic, though the 9 pixels of an edge hit nearly the same taps.
// This design: one block of 4 warps per edge. One pass over the edge's ct
// row finds which levels have any gradient (the training forward keeps
// each level with p = 0.2; a level with none costs nothing more, an edge
// with none returns). Per kept level the output gradient is unblended
// onto the raw taps of the union box of the 9 pixels' windows in shared
// memory, gv[9][box] (zero where a pixel's window does not cover a tap).
// Work item = (box tap, 4-channel chunk): lane = chunk (a warp reads one
// tap row, coalesced), warps stride over the taps. Per tap the feature
// row is read once, gf = sum_q gv[q][tap] * g[q] leaves in ONE float4
// atomic into grad fmap, and acc[q] += gv[q][tap] * f accumulates grad
// gmap in registers; a tap outside the map or with nine zero gv is
// skipped. The block then sums acc over its warps in shared memory and
// adds it to grad gmap with 9 x 32 float4 atomics (kk repeats across
// edges). ~box x 32 atomics per kept pair instead of 9 x 64 x 32. A level
// whose 9 floors span more than CAP = 8 taps on an axis (nothing bounds
// the spread) takes an exact slow path in the same kernel: 9 passes, pass
// q with pixel q's own 8x8 window as the box; such edges are counted in
// the caller's `slow` word. All arithmetic is f32 FMA for f32 and bf16
// inputs (no TF32); the atomics' order changes from run to run. Bound:
// bytes (the ct rows, the maps and their gradients). K8 keeps its own
// constants below; K7's come from corr_window.cuh (namespace corrwin).

#include "corr_window.cuh"

namespace {

constexpr int C = 128;  // feature channels
constexpr int PP = 9;   // 3x3 patch pixels
constexpr int D = 8;    // raw window (2R + 2, R = 3)
constexpr int d = 7;    // blended window
constexpr int NCOL = PP * d * d * 2;

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

// ---- K7 -------------------------------------------------------------------

// One warp per edge e; coords [E, 9, 2] (x, y), kk into gmap [NG, 9, C],
// jj into the maps [NF, H, W, C].
template <typename T>
__global__ void __launch_bounds__(corrwin::WARPS * 32, corrwin::MIN_BLOCKS)
corr_train_fwd_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                      const T* __restrict__ fmap2,
                      const float* __restrict__ coords,
                      const int* __restrict__ kk, const int* __restrict__ jj,
                      T* __restrict__ out, int E, int NG, int NF, int H1,
                      int W1, int H2, int W2) {
  using Store = corrwin::RefStore;
  __shared__ __align__(16) float raw[corrwin::WARPS][corrwin::RAW +
                                                     Store::STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * corrwin::WARPS + warp;
  if (e >= E) return;
  T* orow = out + (size_t)e * Store::NCOL;
  const int k = kk[e], j = jj[e];
  if (k < 0 || k >= NG || j < 0 || j >= NF) {  // no such row: zeros
    Store::template dead<T>(orow, lane);
    return;
  }
  const float* co = coords + (size_t)e * PP * 2;
  corrwin::edge<T, Store>(gmap + (size_t)k * PP * C,
                          fmap1 + (size_t)j * H1 * W1 * C,
                          fmap2 + (size_t)j * H2 * W2 * C, H1, W1, H2, W2, co,
                          co + 1, raw[warp], lane, orow, 2);
}

// ---- K8 -------------------------------------------------------------------

constexpr int CAP = 8;           // largest span of the 9 floors per axis
constexpr int BOX = D + CAP;     // largest box side
constexpr int BOXT = BOX * BOX;  // taps of the largest box
#ifndef K8_WARPS
#define K8_WARPS 4
#endif
constexpr int BW_WARPS = K8_WARPS;  // warps per edge block

// Four consecutive channels as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

struct BwdShared {
  union {
    struct {
      float ct[NCOL + 2];     // the edge's output gradient
      float gv[PP * BOXT];    // raw-tap gradient over the box, per pixel
    } w;
    float red[BW_WARPS - 1][PP][C];  // grad gmap partial sums
  };
  float fx[PP], fy[PP];  // blend weights of the level's pixels
  int ox[PP], oy[PP];    // window offsets inside the box
  int x0[PP], y0[PP];    // floors
};

// One pass of one level: unblend pixels [q0, q1) onto the box of bw x bh
// taps at (bx, by) (their windows at offsets ox, oy), then the tap loop.
template <typename T>
__device__ __forceinline__ void bwd_pass(
    BwdShared& sh, int l, int q0, int q1, bool boxed, int bx, int by, int bw,
    int bh, const float4 (&g)[PP], const T* __restrict__ fslot,
    float* __restrict__ gfslot, int Hf, int Wf, float4 (&acc)[PP]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntap = bw * bh;
  __syncthreads();  // the previous pass is done with gv
  for (int i = tid; i < PP * ntap; i += BW_WARPS * 32) {
    const int q = i / ntap;
    sh.w.gv[q * BOXT + (i - q * ntap)] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < (q1 - q0) * D * D; i += BW_WARPS * 32) {
    const int q = q0 + i / (D * D), dy = (i / D) % D, dx = i % D;
    const float fx = sh.fx[q], fy = sh.fy[q];
    const float* crow = sh.w.ct + q * (d * d * 2) + l;
    // G(a, b): output gradient at x shift a, y shift b (0 outside 7x7)
    auto G = [&](int a, int b) -> float {
      return (a >= 0 && a < d && b >= 0 && b < d) ? crow[(a * d + b) * 2]
                                                  : 0.f;
    };
    const float v = (1.f - fy) * (1.f - fx) * G(dx, dy) +
                    (1.f - fy) * fx * G(dx - 1, dy) +
                    fy * (1.f - fx) * G(dx, dy - 1) +
                    fy * fx * G(dx - 1, dy - 1);
    const int ox = boxed ? sh.ox[q] : 0, oy = boxed ? sh.oy[q] : 0;
    sh.w.gv[q * BOXT + (oy + dy) * bw + ox + dx] = v;
  }
  __syncthreads();
  for (int t = warp; t < ntap; t += BW_WARPS) {
    const int ty = t / bw, tx = t - ty * bw;
    const int x = bx + tx, y = by + ty;
    if (x < 0 || x >= Wf || y < 0 || y >= Hf) continue;
    float gv[PP];
    bool nz = false;
#pragma unroll
    for (int q = 0; q < PP; ++q) {
      gv[q] = sh.w.gv[q * BOXT + t];
      nz |= gv[q] != 0.f;
    }
    if (!nz) continue;  // the same for every lane
    const size_t off = ((size_t)y * Wf + x) * C + 4 * lane;
    const float4 f = load4(fslot + off);
    float4 gf = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < PP; ++q) {
      gf.x = fmaf(gv[q], g[q].x, gf.x);
      gf.y = fmaf(gv[q], g[q].y, gf.y);
      gf.z = fmaf(gv[q], g[q].z, gf.z);
      gf.w = fmaf(gv[q], g[q].w, gf.w);
      acc[q].x = fmaf(gv[q], f.x, acc[q].x);
      acc[q].y = fmaf(gv[q], f.y, acc[q].y);
      acc[q].z = fmaf(gv[q], f.z, acc[q].z);
      acc[q].w = fmaf(gv[q], f.w, acc[q].w);
    }
    atomic_add4(gfslot + off, gf.x, gf.y, gf.z, gf.w);
  }
}

// One level of one edge: the geometry of its 9 pixels, then one boxed
// pass, or 9 per-pixel passes when the spread exceeds CAP.
template <typename T>
__device__ __forceinline__ bool bwd_level(
    BwdShared& sh, int l, const float* __restrict__ co, float scale,
    const float4 (&g)[PP], const T* __restrict__ fslot,
    float* __restrict__ gfslot, int Hf, int Wf, float4 (&acc)[PP]) {
  const int tid = threadIdx.x;
  __syncthreads();  // the previous level is done with the geometry
  if (tid < PP) {
    const float xf = co[2 * tid] * scale, yf = co[2 * tid + 1] * scale;
    sh.fx[tid] = xf - floorf(xf);
    sh.fy[tid] = yf - floorf(yf);
    sh.x0[tid] = floor_int(xf);
    sh.y0[tid] = floor_int(yf);
  }
  __syncthreads();
  int xlo = sh.x0[0], xhi = xlo, ylo = sh.y0[0], yhi = ylo;
#pragma unroll
  for (int q = 1; q < PP; ++q) {
    xlo = min(xlo, sh.x0[q]); xhi = max(xhi, sh.x0[q]);
    ylo = min(ylo, sh.y0[q]); yhi = max(yhi, sh.y0[q]);
  }
  const bool fits = xhi - xlo <= CAP && yhi - ylo <= CAP;
  if (fits) {
    if (tid < PP) {
      sh.ox[tid] = sh.x0[tid] - xlo;
      sh.oy[tid] = sh.y0[tid] - ylo;
    }
    bwd_pass<T>(sh, l, 0, PP, true, xlo - 3, ylo - 3, xhi - xlo + D,
                yhi - ylo + D, g, fslot, gfslot, Hf, Wf, acc);
  } else {
    for (int q = 0; q < PP; ++q)
      bwd_pass<T>(sh, l, q, q + 1, false, sh.x0[q] - 3, sh.y0[q] - 3, D, D,
                  g, fslot, gfslot, Hf, Wf, acc);
  }
  return fits;
}

template <typename T>
__global__ void __launch_bounds__(BW_WARPS * 32)
corr_train_bwd_kernel(const float* __restrict__ ct,
                      const T* __restrict__ gmap, const T* __restrict__ fmap1,
                      const T* __restrict__ fmap2,
                      const float* __restrict__ coords,
                      const int* __restrict__ kk, const int* __restrict__ jj,
                      float* __restrict__ ggmap, float* __restrict__ gf1,
                      float* __restrict__ gf2,
                      unsigned int* __restrict__ slow, int E, int NG, int NF,
                      int H1, int W1, int H2, int W2) {
  __shared__ __align__(16) BwdShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x;
  const int k = kk[e], j = jj[e];
  if (k < 0 || k >= NG || j < 0 || j >= NF) return;
  // the edge's ct row, and which levels have any gradient
  const float* crow = ct + (size_t)e * NCOL;
  int nz0 = 0, nz1 = 0;
  for (int i = tid; i < NCOL; i += BW_WARPS * 32) {
    const float v = crow[i];
    sh.w.ct[i] = v;
    if (v != 0.f) { if (i & 1) nz1 = 1; else nz0 = 1; }
  }
  const bool any0 = __syncthreads_or(nz0), any1 = __syncthreads_or(nz1);
  if (!any0 && !any1) return;
  float4 g[PP], acc[PP];
#pragma unroll
  for (int q = 0; q < PP; ++q) {
    g[q] = load4(gmap + ((size_t)k * PP + q) * C + 4 * lane);
    acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* co = coords + (size_t)e * PP * 2;
  bool fits = true;
  if (any0)
    fits &= bwd_level<T>(sh, 0, co, 1.f, g, fmap1 + (size_t)j * H1 * W1 * C,
                         gf1 + (size_t)j * H1 * W1 * C, H1, W1, acc);
  if (any1)
    fits &= bwd_level<T>(sh, 1, co, 0.25f, g, fmap2 + (size_t)j * H2 * W2 * C,
                         gf2 + (size_t)j * H2 * W2 * C, H2, W2, acc);
  if (!fits && tid == 0 && slow != nullptr) atomicAdd(slow, 1u);
  // sum acc over the warps, then one atomic pass into grad gmap
  __syncthreads();  // the tap loops are done with gv (red overlays it)
  if (warp > 0) {
#pragma unroll
    for (int q = 0; q < PP; ++q)
      *reinterpret_cast<float4*>(&sh.red[warp - 1][q][4 * lane]) = acc[q];
  }
  __syncthreads();
  if (warp > 0) return;
  float* grow = ggmap + (size_t)k * PP * C + 4 * lane;
#pragma unroll
  for (int q = 0; q < PP; ++q) {
    float4 a = acc[q];
#pragma unroll
    for (int w = 0; w < BW_WARPS - 1; ++w) {
      const float4 r = *reinterpret_cast<const float4*>(&sh.red[w][q][4 * lane]);
      a.x += r.x; a.y += r.y; a.z += r.z; a.w += r.w;
    }
    atomic_add4(grow + q * C, a.x, a.y, a.z, a.w);
  }
}

int grid_of(int E) { return (E + corrwin::WARPS - 1) / corrwin::WARPS; }

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
    corr_train_fwd_kernel<T><<<grid_of(E), corrwin::WARPS * 32, 0, s>>>(
        static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
        static_cast<const T*>(fmap2), co, k, j, static_cast<T*>(out), E, NG,
        NF, H1, W1, H2, W2);
  } else {
    corr_train_fwd_kernel<float><<<grid_of(E), corrwin::WARPS * 32, 0,
                                    s>>>(
        static_cast<const float*>(gmap), static_cast<const float*>(fmap1),
        static_cast<const float*>(fmap2), co, k, j, static_cast<float*>(out),
        E, NG, NF, H1, W1, H2, W2);
  }
  return (int)cudaGetLastError();
}

// ct [E, 882] float32 (the output's gradient); gmap, fmap1, fmap2, coords,
// kk, jj as for the forward; ggmap [NG, 9, 128], gf1 [NF, H1, W1, 128] and
// gf2 [NF, H2, W2, 128] float32, zeroed by the caller, receive the sums;
// slow, when not null, points at a device uint32 that counts the edges
// that took the slow path.
extern "C" int corr_train_bwd_launch(const void* ct, const void* gmap,
                                     const void* fmap1, const void* fmap2,
                                     const void* coords, const void* kk,
                                     const void* jj, void* ggmap, void* gf1,
                                     void* gf2, void* slow, int E, int NG,
                                     int NF, int H1, int W1, int H2, int W2,
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
  unsigned int* sl = static_cast<unsigned int*>(slow);
  if (is_bf16) {
    using T = __nv_bfloat16;
    corr_train_bwd_kernel<T><<<E, BW_WARPS * 32, 0, s>>>(
        c, static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
        static_cast<const T*>(fmap2), co, k, j, gg, g1, g2, sl, E, NG, NF, H1,
        W1, H2, W2);
  } else {
    corr_train_bwd_kernel<float><<<E, BW_WARPS * 32, 0, s>>>(
        c, static_cast<const float*>(gmap), static_cast<const float*>(fmap1),
        static_cast<const float*>(fmap2), co, k, j, gg, g1, g2, sl, E, NG, NF,
        H1, W1, H2, W2);
  }
  return (int)cudaGetLastError();
}

// Reads into *count (host memory) how many edges of this library's K7
// launches took the slow path since the last reset, after waiting for the
// device; `reset` then sets the counter to 0. Returns the cudaError_t.
// (K8 counts into the word its caller passes.)
extern "C" int corr_train_slow_edges(unsigned int* count, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(count, corrwin::slow_edges,
                                         sizeof(unsigned int));
  if (err == cudaSuccess && reset) {
    const unsigned int zero = 0;
    err = cudaMemcpyToSymbol(corrwin::slow_edges, &zero, sizeof(zero));
  }
  return (int)err;
}
