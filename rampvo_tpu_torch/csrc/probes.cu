// Two measurement probes (Hopper). They compute nothing of the system.
//
// P1 dynlane_kernel replaces the TPU lowering probe
// scripts/probe_dynlane.py (its kernel at :29, pallas_call at :50): one
// block reads (tlo, thi) from a device table and runs a loop with those
// dynamic bounds, writing rows [tc*SP, (tc+1)*SP) of out [T*SP, W] as
// x [SP, W] + vcol[tc*SP + row, 0] (int32 to float32). On the TPU it showed
// which dynamic-bound loops and dynamic offsets Mosaic lowers; here it is
// the same function, a check that a table-driven loop and dynamic row
// offsets behave (K6's t-loop is such a loop). Bound: bytes, tiny.
//
// P2 grid_noop / grid_rows replace scripts/probe_grid_overhead.py (:70
// two outputs, :107 one output): a grid of NB blocks that (A) do nothing,
// (B) read their row of a table tabs [NB, 5] and write one 192-wide bf16
// row of zeros into each of two outputs [NI+1, T, M, PP, 1, 192] at
// (tabs[b][4], tabs[b][1], 0, 0, 0), or (C) the same into one output
// [NI+1, T, M, 2*PP, 1, 192]. Timed per launch, they give the card's cost
// per launch and per block, the number a CUDA-graph frame step is weighed
// against. Bound: bytes (B, C: the table and 384 bytes a block), none (A).
// Blocks are one warp; 24 lanes write a row with 16-byte stores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__global__ void dynlane_kernel(const int* __restrict__ tabs,
                               const int* __restrict__ vcol,
                               const float* __restrict__ x,
                               float* __restrict__ out, int SP, int W) {
  const int tlo = tabs[0], thi = tabs[1];
  for (int tc = tlo; tc <= thi; ++tc) {
    for (int i = threadIdx.x; i < SP * W; i += blockDim.x) {
      const int row = i / W;
      out[(size_t)tc * SP * W + i] =
          x[i] + (float)vcol[2 * ((size_t)tc * SP + row)];
    }
  }
}

__global__ void grid_noop() {}

constexpr int ROW = 192;  // bf16 values a block writes per output

__global__ void grid_rows(const int* __restrict__ tabs,
                          __nv_bfloat16* __restrict__ out1,
                          __nv_bfloat16* __restrict__ out2, int T,
                          long long cell) {
  const int* tb = tabs + 5 * blockIdx.x;
  const int t = tb[1], orow = tb[4];
  const size_t off = ((size_t)orow * T + t) * cell;
  if (threadIdx.x < ROW / 8) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(out1 + off)[threadIdx.x] = z;
    if (out2 != nullptr) reinterpret_cast<uint4*>(out2 + off)[threadIdx.x] = z;
  }
}

}  // namespace

// P1: tabs [2] int32, vcol [T*SP, 2] int32, x [SP, W] f32, out [T*SP, W]
// f32. Returns the cudaError_t of the launch.
extern "C" int dynlane_launch(const void* tabs, const void* vcol,
                              const void* x, void* out, int SP, int W,
                              void* stream) {
  dynlane_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tabs), static_cast<const int*>(vcol),
      static_cast<const float*>(x), static_cast<float*>(out), SP, W);
  return (int)cudaGetLastError();
}

// P2: variant 0 (A) launches NB no-op blocks; 1 (B) writes into out1 and
// out2; 2 (C) into out1 only. `cell` = values of one (row, t) block of an
// output (M * PP * 192 or M * 2 * PP * 192).
extern "C" int grid_probe_launch(int variant, int NB, const void* tabs,
                                 void* out1, void* out2, int T,
                                 long long cell, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    grid_noop<<<NB, 32, 0, s>>>();
  else
    grid_rows<<<NB, 32, 0, s>>>(
        static_cast<const int*>(tabs), static_cast<__nv_bfloat16*>(out1),
        variant == 1 ? static_cast<__nv_bfloat16*>(out2) : nullptr, T, cell);
  return (int)cudaGetLastError();
}
