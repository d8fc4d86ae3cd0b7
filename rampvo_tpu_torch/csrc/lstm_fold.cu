// Fused zero-carry pixel-LSTM + super-state fold, channel-major (Hopper).
//
// Replaces the TPU kernel rampvo_tpu/ops/encoder_pallas.py::lstm_fold_cm
// (kernel body _lstm_fold_kernel). Per pixel p of one encoder scale:
//   gates = wg^T x[:, p] + bg            (events and image in one [8, 8h]
//                                          gate-interleaved matrix)
//   c = sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)   (zero carry: the
//                                          forget gate and h@W_hh vanish)
//   ss'[:, p] = wf^T [ss[:, p] | h_ev | h_im] + bf    (composed fold)
// x [8, HW] and ss [h, HW] in, ss' [h, HW] out, f32 or bf16; weights f32.
//
// Bound on the H100: bytes. Per pixel it reads 8 + h values and writes h,
// about 41 MB per frame over the three scales in bf16 (~12 us at
// 3.35 TB/s), against ~2.3 GFLOP of f32 arithmetic (the gate columns for
// i, g, o and the 3h x h fold).
// Design: one thread per pixel (grid-stride), so every load and store is
// coalesced along HW; the weights (<= 63 KB at h = 64) sit in shared memory
// and are read as warp-wide broadcasts; the 8h gates and the 3h-long fold
// are computed in registers in f32 (the fold accumulators, h floats, are
// the only per-thread array), streaming k over [ss | h_ev | h_im] so no
// intermediate ever reaches device memory. The unused forget-gate columns
// are never loaded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

template <int H>
constexpr int smem_floats() { return 8 * 6 * H + 6 * H + 3 * H * H + H; }

template <int H, typename T>
__global__ void __launch_bounds__(256)
lstm_fold_kernel(const T* __restrict__ x, const T* __restrict__ ss,
                 const float* __restrict__ wg, const float* __restrict__ bg,
                 const float* __restrict__ wf, const float* __restrict__ bf,
                 T* __restrict__ out, int HW) {
  extern __shared__ float smem[];
  float* wgs = smem;             // [8][6H]: i | g | o columns, 2H each
  float* bgs = wgs + 8 * 6 * H;  // [6H]
  float* wfs = bgs + 6 * H;      // [3H][H]
  float* bfs = wfs + 3 * H * H;  // [H]
  for (int k = threadIdx.x; k < 8 * 6 * H; k += blockDim.x) {
    const int c = k / (6 * H), j = k % (6 * H);
    const int part = j / (2 * H);
    const int col = (part == 0 ? 0 : (part == 1 ? 4 * H : 6 * H)) + j % (2 * H);
    wgs[k] = wg[c * 8 * H + col];
  }
  for (int j = threadIdx.x; j < 6 * H; j += blockDim.x) {
    const int part = j / (2 * H);
    bgs[j] = bg[(part == 0 ? 0 : (part == 1 ? 4 * H : 6 * H)) + j % (2 * H)];
  }
  for (int k = threadIdx.x; k < 3 * H * H; k += blockDim.x) wfs[k] = wf[k];
  for (int j = threadIdx.x; j < H; j += blockDim.x) bfs[j] = bf[j];
  __syncthreads();

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < HW;
       p += gridDim.x * blockDim.x) {
    float xv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) xv[c] = to_f(x[(size_t)c * HW + p]);
    float acc[H];
#pragma unroll
    for (int j = 0; j < H; ++j) acc[j] = bfs[j];
    // fold rows [0, H): the carried super-state
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      const float s = to_f(ss[(size_t)k * HW + p]);
      const float* w = wfs + k * H;
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] = fmaf(s, w[j], acc[j]);
    }
    // fold rows [H, 3H): LSTM outputs [h_ev | h_im], computed on the fly
#pragma unroll 2
    for (int k = 0; k < 2 * H; ++k) {
      float gi = bgs[k], gg = bgs[2 * H + k], go = bgs[4 * H + k];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float* w = wgs + c * 6 * H;
        gi = fmaf(xv[c], w[k], gi);
        gg = fmaf(xv[c], w[2 * H + k], gg);
        go = fmaf(xv[c], w[4 * H + k], go);
      }
      const float cc = sigm(gi) * tanhf(gg);
      const float hh = sigm(go) * tanhf(cc);
      const float* w = wfs + (H + k) * H;
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] = fmaf(hh, w[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < H; ++j) from_f(out + (size_t)j * HW + p, acc[j]);
  }
}

template <int H, typename T>
int launch(const void* x, const void* ss, const float* wg, const float* bg,
           const float* wf, const float* bf, void* out, int HW, int grid,
           cudaStream_t stream) {
  const int smem = smem_floats<H>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      lstm_fold_kernel<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  lstm_fold_kernel<H, T><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ss), wg, bg, wf, bf,
      static_cast<T*>(out), HW);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int h, const void* x, const void* ss, const float* wg,
             const float* bg, const float* wf, const float* bf, void* out,
             int HW, int grid, cudaStream_t s) {
  switch (h) {
    case 16: return launch<16, T>(x, ss, wg, bg, wf, bf, out, HW, grid, s);
    case 32: return launch<32, T>(x, ss, wg, bg, wf, bf, out, HW, grid, s);
    case 64: return launch<64, T>(x, ss, wg, bg, wf, bf, out, HW, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [8, HW], ss [h, HW], out [h, HW] of one dtype (is_bf16); wg [8, 8h],
// bg [8h], wf [3h, h], bf [h] float32; all contiguous. Returns the
// cudaError_t of the launch.
extern "C" int lstm_fold_launch(const void* x, const void* ss,
                                const void* wg, const void* bg,
                                const void* wf, const void* bf, void* out,
                                int HW, int h, int is_bf16, int grid,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wg_ = static_cast<const float*>(wg);
  const float* bg_ = static_cast<const float*>(bg);
  const float* wf_ = static_cast<const float*>(wf);
  const float* bf_ = static_cast<const float*>(bf);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(h, x, ss, wg_, bg_, wf_, bf_, out, HW,
                                   grid, s);
  return dispatch<float>(h, x, ss, wg_, bg_, wf_, bf_, out, HW, grid, s);
}
