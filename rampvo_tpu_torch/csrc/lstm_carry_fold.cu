// Carried pixel-LSTM step + presence-gated shared super-state folds,
// channel-major (Hopper). The SingleScale encoder's recurrent chain.
//
// Replaces the TPU kernel rampvo_tpu/ops/encoder_pallas.py::
// lstm_carry_fold_cm (kernel body _lstm_carry_fold_kernel). Per pixel p:
//   gates = wg^T x[:, p] + wh^T [h_ev | h_im] + bg      (gate g in columns
//            [g*2hp, (g+1)*2hp), event half first; i, f, g, o order)
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
//   ss1 = pres_ev ? wf^T [ss | h'_ev] + bf : ss
//   ss2 = pres_im ? wf^T [ss1 | h'_im] + bf : ss1
// x [8, HW], hc [4hp, HW] rows [h_ev | h_im | c_ev | c_im] and ss [hp, HW]
// in; ss2 [hp, HW] and hc' = [h' | c'] [4hp, HW] out, f32 or bf16 storage,
// f32 arithmetic; weights f32; pres int32[2] on the device (no host sync).
//
// Bound on the H100: bytes. Per pixel it reads 8 + 5hp values and writes
// 5hp: at hp = 16, HW = 307200 about 103 MB in bf16 (~31 us at 3.35 TB/s),
// 206 MB in f32, against ~3.8 GFLOP of f32 arithmetic.
// Design: one thread per pixel (grid-stride), every load and store
// coalesced along HW. The weights (~23 KB) sit in shared memory,
// re-packed per hidden unit as float4 (i, f, g, o) over the 8 + 2hp
// inputs, so one broadcast load feeds four FMAs. The inputs [x | h] are
// held in registers; the 2hp units are computed one at a time and each
// unit's h' is folded into the hp accumulators at once, so h', c' and the
// gates never reach device memory except as the carried output. The event
// half finishes fold 1 before the image half starts fold 2 from ss1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// Build variants, compared by `python3 chip_smoke.py --k3-variants`:
// K3_MIN_BLOCKS is the blocks per SM asked of __launch_bounds__ (the
// wrapper sizes its grid to match), K3_FOLD_UNROLL the unroll count of
// fold_start's k loop (1: rolled).
#ifndef K3_MIN_BLOCKS
#define K3_MIN_BLOCKS 2
#endif
#ifndef K3_FOLD_UNROLL
#define K3_FOLD_UNROLL 1
#endif
#define K3_PRAGMA(x) _Pragma(#x)
#define K3_UNROLL(n) K3_PRAGMA(unroll n)

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

// One half (event: k0 = 0, image: k0 = HP) of the 2HP units of pixel p:
// computes each unit's c', h', stores them to ohc and folds h' into acc.
template <int HP, typename T>
__device__ __forceinline__ void half_units(
    int k0, const float (&in)[8 + 2 * HP], const T* __restrict__ hc,
    const float4* wk, const float4* bk, const float* wf, float (&acc)[HP],
    T* __restrict__ ohc, int HW, int p) {
  constexpr int H2 = 2 * HP, NIN = 8 + H2;
#pragma unroll 1
  for (int k = k0; k < k0 + HP; ++k) {
    float4 g = bk[k];
    const float4* w = wk + k * NIN;
#pragma unroll
    for (int r = 0; r < NIN; ++r) {
      const float4 v = w[r];
      g.x = fmaf(in[r], v.x, g.x);
      g.y = fmaf(in[r], v.y, g.y);
      g.z = fmaf(in[r], v.z, g.z);
      g.w = fmaf(in[r], v.w, g.w);
    }
    const float c_old = to_f(hc[(size_t)(H2 + k) * HW + p]);
    const float c = sigm(g.y) * c_old + sigm(g.x) * tanhf(g.z);
    const float h = sigm(g.w) * tanhf(c);
    from_f(ohc + (size_t)k * HW + p, h);
    from_f(ohc + (size_t)(H2 + k) * HW + p, c);
    const float* wr = wf + (HP + (k - k0)) * HP;      // fold rows [HP, 2HP)
#pragma unroll
    for (int j = 0; j < HP; ++j) acc[j] = fmaf(h, wr[j], acc[j]);
  }
}

// acc = bf + wf[0:HP]^T s   (the fold's super-state half). The k loop
// stays rolled: unrolled, its HP * HP weight loads are scheduled ahead of
// the FMAs and take ~250 registers, which spill (PERF.md has the times of
// both, from chip_smoke.py --k3-variants).
template <int HP>
__device__ __forceinline__ void fold_start(const float (&s)[HP],
                                           const float* wf, const float* bf,
                                           float (&acc)[HP]) {
#pragma unroll
  for (int j = 0; j < HP; ++j) acc[j] = bf[j];
  K3_UNROLL(K3_FOLD_UNROLL)
  for (int k = 0; k < HP; ++k) {
#pragma unroll
    for (int j = 0; j < HP; ++j) acc[j] = fmaf(s[k], wf[k * HP + j], acc[j]);
  }
}

// Two blocks per SM by default (at most 128 registers a thread; the
// inputs, the super-state and the accumulators are 72 floats), the
// fastest of one, two and three (PERF.md, chip_smoke.py --k3-variants).
template <int HP, typename T>
__global__ void __launch_bounds__(256, K3_MIN_BLOCKS)
lstm_carry_fold_kernel(const T* __restrict__ x, const T* __restrict__ hc,
                       const T* __restrict__ ss,
                       const float* __restrict__ wg,
                       const float* __restrict__ wh,
                       const float* __restrict__ bg,
                       const float* __restrict__ wf,
                       const float* __restrict__ bf,
                       const int* __restrict__ pres, T* __restrict__ oss,
                       T* __restrict__ ohc, int HW) {
  constexpr int H2 = 2 * HP, NIN = 8 + H2, G = 8 * HP;
  __shared__ float4 wk[H2 * NIN];   // [unit][input] -> (i, f, g, o)
  __shared__ float4 bk[H2];         // [unit] -> (i, f, g, o)
  __shared__ float wfs[H2 * HP];    // [ss | data rows][HP]
  __shared__ float bfs[HP];
  for (int e = threadIdx.x; e < H2 * NIN; e += blockDim.x) {
    const int k = e / NIN, r = e % NIN;
    const float* src = r < 8 ? wg + r * G : wh + (r - 8) * G;
    wk[e] = make_float4(src[k], src[H2 + k], src[2 * H2 + k],
                        src[3 * H2 + k]);
  }
  for (int k = threadIdx.x; k < H2; k += blockDim.x)
    bk[k] = make_float4(bg[k], bg[H2 + k], bg[2 * H2 + k], bg[3 * H2 + k]);
  for (int e = threadIdx.x; e < H2 * HP; e += blockDim.x) wfs[e] = wf[e];
  for (int e = threadIdx.x; e < HP; e += blockDim.x) bfs[e] = bf[e];
  const bool p_ev = pres[0] > 0, p_im = pres[1] > 0;
  __syncthreads();

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < HW;
       p += gridDim.x * blockDim.x) {
    float in[NIN];
#pragma unroll
    for (int c = 0; c < 8; ++c) in[c] = to_f(x[(size_t)c * HW + p]);
#pragma unroll
    for (int j = 0; j < H2; ++j) in[8 + j] = to_f(hc[(size_t)j * HW + p]);
    float s[HP], acc[HP];
#pragma unroll
    for (int j = 0; j < HP; ++j) s[j] = to_f(ss[(size_t)j * HW + p]);

    fold_start<HP>(s, wfs, bfs, acc);
    half_units<HP, T>(0, in, hc, wk, bk, wfs, acc, ohc, HW, p);
#pragma unroll
    for (int j = 0; j < HP; ++j) s[j] = p_ev ? acc[j] : s[j];
    fold_start<HP>(s, wfs, bfs, acc);
    half_units<HP, T>(HP, in, hc, wk, bk, wfs, acc, ohc, HW, p);
#pragma unroll
    for (int j = 0; j < HP; ++j)
      from_f(oss + (size_t)j * HW + p, p_im ? acc[j] : s[j]);
  }
}

template <int HP, typename T>
int launch(const void* x, const void* hc, const void* ss, const float* wg,
           const float* wh, const float* bg, const float* wf, const float* bf,
           const int* pres, void* oss, void* ohc, int HW, int grid,
           cudaStream_t stream) {
  lstm_carry_fold_kernel<HP, T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(hc),
      static_cast<const T*>(ss), wg, wh, bg, wf, bf, pres,
      static_cast<T*>(oss), static_cast<T*>(ohc), HW);
  return (int)cudaGetLastError();
}

}  // namespace

// The blocks per SM the kernel was built for: the grid is this many
// blocks per SM (one wave, grid-stride over the pixels).
extern "C" int lstm_carry_fold_blocks_per_sm() { return K3_MIN_BLOCKS; }

// x [8, HW], hc [4hp, HW], ss [hp, HW], oss [hp, HW], ohc [4hp, HW] of one
// dtype (is_bf16); wg [8, 8hp], wh [2hp, 8hp], bg [8hp], wf [2hp, hp],
// bf [hp] float32; pres int32[2]; all contiguous, outputs not aliasing the
// inputs. hp must be 16. Returns the cudaError_t of the launch.
extern "C" int lstm_carry_fold_launch(const void* x, const void* hc,
                                      const void* ss, const void* wg,
                                      const void* wh, const void* bg,
                                      const void* wf, const void* bf,
                                      const void* pres, void* oss, void* ohc,
                                      int HW, int hp, int is_bf16, int grid,
                                      void* stream) {
  if (hp != 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wg_ = static_cast<const float*>(wg);
  const float* wh_ = static_cast<const float*>(wh);
  const float* bg_ = static_cast<const float*>(bg);
  const float* wf_ = static_cast<const float*>(wf);
  const float* bf_ = static_cast<const float*>(bf);
  const int* pr = static_cast<const int*>(pres);
  if (is_bf16)
    return launch<16, __nv_bfloat16>(x, hc, ss, wg_, wh_, bg_, wf_, bf_, pr,
                                     oss, ohc, HW, grid, s);
  return launch<16, float>(x, hc, ss, wg_, wh_, bg_, wf_, bf_, pr, oss, ohc,
                           HW, grid, s);
}
