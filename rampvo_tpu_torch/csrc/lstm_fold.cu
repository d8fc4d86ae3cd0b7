// Fused zero-carry pixel-LSTM + super-state fold, channel-major (Hopper).
//
// Replaces the TPU kernel rampvo_tpu/ops/encoder_pallas.py::lstm_fold_cm
// (kernel body _lstm_fold_kernel). Per pixel p of one encoder scale:
//   gates = wg^T x[:, p] + bg            (events and image in one [Cx, 8h]
//                                          gate-interleaved matrix)
//   c = sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)   (zero carry: the
//                                          forget gate and h@W_hh vanish)
//   ss'[:, p] = wf^T [ss[:, p] | h_ev | h_im] + bf    (composed fold)
// x [Cx, HW] and ss [h, HW] in, ss' [h, HW] out, f32 or bf16. Cx = the
// event bins + 3 image channels (8 at the default 5 bins), any Cx >= 1:
// the x rows are padded to Cp = 8 ceil(Cx / 8) with zeros in shared
// memory or registers, never in device memory.
//
// Bound on the H100, bf16 (the VO main path): per pixel it reads Cx + h
// values and writes h, ~41 MB per frame over the three scales at Cx = 8
// (~12 us at 3.35 TB/s; each further x row adds ~0.8 MB, ~0.25 us); the
// ~2.3 GFLOP of products take ~2 us on the tensor cores; the 4
// transcendental functions of each of the 17.2 M LSTM units a frame take
// >= 69 M SFU operations, ~16.5 us at 16 per clock per SM, whatever Cx.
// So the SFU, then the bytes.
//
// What bounded the first design (one thread per pixel, the whole gate
// product and fold as f32 FMAs whose every weight came from shared memory,
// full-precision expf/tanhf, 64 accumulators a thread at h = 64, and too
// few blocks at scale 4): 0.21-0.25 ms a frame, the CUDA cores' issue.
//
// bf16 design: pixels are the M dimension of mma.sync. A warp takes a tile
// of 16 * MT pixels (MT = 2 m16 tiles, 1 at h = 64 to keep its
// accumulators in registers): it stages x [Cx, P] and ss [h, P] from the
// channel-major rows into its own shared memory with 16-byte cp.async
// copies, the next tile's while it computes this one (two buffers), and
// reads the A fragments with ldmatrix.trans. The fold's accumulators
// [P, h] start at bf; the carried super-state's k-steps (m16n8k16) come
// first. Then, per pair of 8-unit chunks of [h_ev | h_im]: the gates i, g,
// o of each chunk are three products over the x fragments, one m16n8k8
// step per 8 rows of Cp (f32 accumulators started at the gate biases, all
// of x's k-steps summed before the LSTM), the LSTM runs on the
// accumulators in registers (sigmoid(v) = 0.5 + 0.5 tanh(v / 2), tanh by
// tanh.approx.f32: 4 SFU operations a unit), and the two chunks' h, rounded
// to bf16, are the A fragment of the next fold k-step directly (the
// accumulator layout of two m16n8 tiles is the A layout of one m16n8k16):
// h never touches memory. The result goes through the warp's shared tile
// back to channel-major rows and leaves in 16-byte stores. The weights are
// bf16 B fragments in fragment order (packed once per network by
// ops/encoder_kernels.py::pack_fold_weights), copied to shared memory once
// per persistent block (cp.async, with the warps' first tiles). Rounding: x, ss and the weights in bf16 (the TPU
// kernel's default-precision dots are one bf16 pass), h before the fold,
// the output; sums and biases in f32.
//
// f32 storage keeps f32 arithmetic (tolerance 1e-4; no TF32, accurate
// expf/tanhf): the first design's thread-per-pixel loop.
//
// The x k-step count NX = Cp / 8 is a template parameter for NX = 1, 2, 3
// (up to 21 event bins; NX = 1 at the default 5), whose x fragments and
// gate weights are sized at compile time: the launcher picks the
// instance. Every larger Cp runs the NX = 0 instance, which reads nx at
// run time: in bf16 it loads x's A fragments per use instead of holding
// them in registers, in f32 it reads x and the gate weights from device
// memory per use. Its shared memory grows with Cp (the bf16 gate
// fragments and x tiles, ~1.1 KB a row of Cp at h = 64): past the card's
// 227 KB a block (Cp ~ 150 at h = 64) the launch returns the CUDA error
// and the wrapper raises.
//
// Build variants (-D): K2_WARPS (warps a block, 4), K2_MIN_BLOCKS (blocks
// per SM ptxas aims at, 4), K2_EXACT_TANH (expf/tanhf instead of the SFU
// approximations in the bf16 path), K2_ONE_BUFFER (one tile buffer a
// warp: each tile is copied in after the last one has left).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32 storage: one thread per pixel
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

// Shared floats of the f32 kernel: the gate weights [Cp][6H] (NX > 0;
// the NX = 0 instance reads them from device memory), the gate biases,
// the fold's [3H][H] and its bias.
template <int H, int NX>
constexpr int smem_floats() { return 8 * NX * 6 * H + 6 * H + 3 * H * H + H; }

// Gate column of entry j of the [i | g | o] rows (2H each) in wg's [8H].
template <int H>
__device__ __forceinline__ int gate_col(int j) {
  const int part = j / (2 * H);
  return (part == 0 ? 0 : (part == 1 ? 4 * H : 6 * H)) + j % (2 * H);
}

template <int H, int NX>
__global__ void __launch_bounds__(256)
lstm_fold_f32_kernel(const float* __restrict__ x, const float* __restrict__ ss,
                     const float* __restrict__ wg, const float* __restrict__ bg,
                     const float* __restrict__ wf, const float* __restrict__ bf,
                     float* __restrict__ out, int HW, int cx) {
  constexpr int XR = 8 * NX;     // x rows held per pixel (0: read per use)
  extern __shared__ float f32_smem[];
  float* wgs = f32_smem;         // [XR][6H]: i | g | o columns, 2H each
  float* bgs = wgs + XR * 6 * H; // [6H]
  float* wfs = bgs + 6 * H;      // [3H][H]
  float* bfs = wfs + 3 * H * H;  // [H]
  for (int k = threadIdx.x; k < XR * 6 * H; k += blockDim.x) {
    const int c = k / (6 * H);
    wgs[k] = c < cx ? wg[c * 8 * H + gate_col<H>(k % (6 * H))] : 0.f;
  }
  for (int j = threadIdx.x; j < 6 * H; j += blockDim.x)
    bgs[j] = bg[gate_col<H>(j)];
  for (int k = threadIdx.x; k < 3 * H * H; k += blockDim.x) wfs[k] = wf[k];
  for (int j = threadIdx.x; j < H; j += blockDim.x) bfs[j] = bf[j];
  __syncthreads();

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < HW;
       p += gridDim.x * blockDim.x) {
    float xv[XR > 0 ? XR : 1];
#pragma unroll
    for (int c = 0; c < XR; ++c) xv[c] = c < cx ? x[(size_t)c * HW + p] : 0.f;
    float acc[H];
#pragma unroll
    for (int j = 0; j < H; ++j) acc[j] = bfs[j];
    // fold rows [0, H): the carried super-state
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      const float s = ss[(size_t)k * HW + p];
      const float* w = wfs + k * H;
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] = fmaf(s, w[j], acc[j]);
    }
    // fold rows [H, 3H): LSTM outputs [h_ev | h_im], computed on the fly
#pragma unroll 2
    for (int k = 0; k < 2 * H; ++k) {
      float gi = bgs[k], gg = bgs[2 * H + k], go = bgs[4 * H + k];
      if constexpr (XR > 0) {
#pragma unroll
        for (int c = 0; c < XR; ++c) {
          const float* w = wgs + c * 6 * H;
          gi = fmaf(xv[c], w[k], gi);
          gg = fmaf(xv[c], w[2 * H + k], gg);
          go = fmaf(xv[c], w[4 * H + k], go);
        }
      } else {
        for (int c = 0; c < cx; ++c) {
          const float v = x[(size_t)c * HW + p];
          const float* w = wg + c * 8 * H + k;
          gi = fmaf(v, __ldg(w), gi);
          gg = fmaf(v, __ldg(w + 4 * H), gg);
          go = fmaf(v, __ldg(w + 6 * H), go);
        }
      }
      const float cc = sigm(gi) * tanhf(gg);
      const float hh = sigm(go) * tanhf(cc);
      const float* w = wfs + (H + k) * H;
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] = fmaf(hh, w[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < H; ++j) out[(size_t)j * HW + p] = acc[j];
  }
}

template <int H, int NX>
int launch_f32(const void* x, const void* ss, const float* wg,
               const float* bg, const float* wf, const float* bf, void* out,
               int HW, int cx, int sms, cudaStream_t stream) {
  const int smem = smem_floats<H, NX>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      lstm_fold_f32_kernel<H, NX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int need = (HW + 255) / 256;
  const int grid = need < 2 * sms ? need : 2 * sms;
  lstm_fold_f32_kernel<H, NX><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ss), wg, bg, wf,
      bf, static_cast<float*>(out), HW, cx);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 storage: mma.sync
// ---------------------------------------------------------------------------

#ifndef K2_WARPS
#define K2_WARPS 4
#endif
#ifndef K2_MIN_BLOCKS
#define K2_MIN_BLOCKS 4
#endif
constexpr int WARPS = K2_WARPS;
#ifdef K2_ONE_BUFFER  // build variant: load each tile after the last one
constexpr int NBUF = 1;
#else
constexpr int NBUF = 2;  // the next tile's copy overlaps this one's work
#endif

// Tile geometry and packed-weight sizes at hidden size H (the x rows'
// share depends on nx, the k8 steps of Cp).
template <int H> struct Tile {
  static constexpr int MT = H == 64 ? 1 : 2;  // m16 tiles a warp
  static constexpr int PX = 16 * MT;          // pixels a warp tile
  static constexpr int LD = PX + 8;           // shared row stride in bf16:
                                              // ldmatrix conflict-free
  static constexpr int NCH = 2 * H / 8;       // 8-unit chunks of [h_ev|h_im]
  static constexpr int KS0 = H / 16;          // fold k-steps of ss
  static constexpr int NT = H / 8;            // fold n-tiles
  static constexpr int FW = (KS0 + NCH / 2) * NT * 32 * 2;  // fold words
  static constexpr int GB = NCH * 3 * 8;      // gate bias floats
  // gate fragment words: [NCH][3 gates][nx k-steps][32 lanes]
  __host__ __device__ static constexpr int gw(int nx) { return NCH * 3 * nx * 32; }
  // a warp's tile buffer: x rows (8 nx), then ss rows (H)
  __host__ __device__ static constexpr int warp_elems(int nx) { return (8 * nx + H) * LD; }
  __host__ __device__ static constexpr int smem(int nx) {
    return (gw(nx) + FW + GB + H) * 4 + WARPS * NBUF * warp_elems(nx) * 2;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[2],
                                        uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ float tanh_fast(float v) {
#ifdef K2_EXACT_TANH
  return tanhf(v);
#else
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
#endif
}

__device__ __forceinline__ float sigm_fast(float v) {
#ifdef K2_EXACT_TANH
  return 1.f / (1.f + expf(-v));
#else
  return fmaf(0.5f, tanh_fast(0.5f * v), 0.5f);
#endif
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Asynchronous 16-byte copy global -> shared (cp.async), its group
// commit and the wait for every committed group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying `rows` channel-major rows of pixels [p0, p0 + PX) of src
// [rows, HW] into dst [rows][LD]: cp.async of 16 bytes a lane when the
// tile is whole and the rows are 16-byte aligned (HW % 8 == 0); else
// element by element at once, zeros past HW.
template <int PX, int LD>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src,
                                           int rows, int HW, int p0, bool vec,
                                           bf16* __restrict__ dst, int lane) {
  constexpr int LPR = PX / 8;                    // lanes a row
  constexpr int RPI = 32 / LPR;                  // rows an instruction
  if (vec && p0 + PX <= HW) {
    const int r0 = lane / LPR, c = (lane % LPR) * 8;
#pragma unroll
    for (int r = r0; r < rows; r += RPI)
      cp_async16(dst + r * LD + c, src + (size_t)r * HW + p0 + c);
  } else {
    for (int i = lane; i < rows * PX; i += 32) {
      const int r = i / PX, c = i - r * PX;
      dst[r * LD + c] = p0 + c < HW ? src[(size_t)r * HW + p0 + c]
                                    : __float2bfloat16(0.f);
    }
  }
}

// A tile src [ROWS][LD] back to pixels [p0, p0 + PX) of the rows of dst
// [ROWS, HW] (pixels past HW not written), 16-byte stores when it can.
template <int ROWS, int PX, int LD>
__device__ __forceinline__ void store_rows(const bf16* __restrict__ src,
                                           int HW, int p0, bool vec,
                                           bf16* __restrict__ dst, int lane) {
  constexpr int LPR = PX / 8;
  constexpr int RPI = 32 / LPR;
  if (vec && p0 + PX <= HW) {
    const int r0 = lane / LPR, c = (lane % LPR) * 8;
#pragma unroll
    for (int r = r0; r < ROWS; r += RPI)
      *reinterpret_cast<uint4*>(dst + (size_t)r * HW + p0 + c) =
          *reinterpret_cast<const uint4*>(src + r * LD + c);
  } else {
    for (int i = lane; i < ROWS * PX; i += 32) {
      const int r = i / PX, c = i - r * PX;
      if (p0 + c < HW) dst[(size_t)r * HW + p0 + c] = src[r * LD + c];
    }
  }
}

// Zero the x rows [cx, 8 nx) of a warp's tile buffer (columns [0, PX)):
// the k-steps read them, the staging never writes them.
template <int PX, int LD>
__device__ __forceinline__ void zero_rows(bf16* __restrict__ xs, int cx,
                                          int nx, int lane) {
  for (int i = lane; i < (8 * nx - cx) * PX; i += 32)
    xs[(cx + i / PX) * LD + i % PX] = __float2bfloat16(0.f);
}

// wfrag: the gate B fragments [NCH][3 gates i, g, o][nx k8 steps][32
// lanes] (one word: B[2t][g], B[2t+1][g] of the m16n8k8 step, lane = 4 g
// + t), then the fold's [KS0 + NCH / 2][NT][32 lanes][2 words] (m16n8k16:
// rows 2t, 2t+1 and 2t+8, 2t+9 of the k-step, column g of the n-tile),
// all bf16 pairs; bias: the gate biases [NCH][3][8], then bf [H], f32.
// NX > 0: nx = NX, x's A fragments held in registers; NX = 0: nx_arg,
// loaded per use.
template <int H, int NX>
__global__ void __launch_bounds__(WARPS * 32, K2_MIN_BLOCKS)
lstm_fold_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ss,
                     const uint32_t* __restrict__ wfrag,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int HW, int cx, int nx_arg) {
  using TL = Tile<H>;
  constexpr int MT = TL::MT, PX = TL::PX, LD = TL::LD, NT = TL::NT;
  const int nx = NX > 0 ? NX : nx_arg;
  const int GW = TL::gw(nx), WE = TL::warp_elems(nx), XR = 8 * nx;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* gfr = smem;
  const uint2* ffr = reinterpret_cast<const uint2*>(smem + GW);
  float* gbs = reinterpret_cast<float*>(smem + GW + TL::FW);
  const float* fbs = gbs + TL::GB;
  bf16* tiles = reinterpret_cast<bf16*>(gbs + TL::GB + H);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = (HW & 7) == 0;
  const int ntiles = (HW + PX - 1) / PX, stride = gridDim.x * WARPS;
  // the weights, and this warp's first tile, copied in together
  for (int i = threadIdx.x; i < (GW + TL::FW) / 4; i += blockDim.x)
    cp_async16(smem + 4 * i, wfrag + 4 * i);
  for (int i = threadIdx.x; i < (TL::GB + H) / 4; i += blockDim.x)
    cp_async16(gbs + 4 * i, bias + 4 * i);
  for (int b = 0; b < NBUF; ++b)
    zero_rows<PX, LD>(tiles + (NBUF * warp + b) * WE, cx, nx, lane);
  int tile = blockIdx.x * WARPS + warp, buf = 0;
  if (tile < ntiles) {
    bf16* xs = tiles + NBUF * warp * WE;
    stage_rows<PX, LD>(x, cx, HW, tile * PX, vec, xs, lane);
    stage_rows<PX, LD>(ss, H, HW, tile * PX, vec, xs + XR * LD, lane);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix row addresses of this lane: matrix q = lane / 8, row lane % 8
  const int q = lane >> 3, r = lane & 7;
  for (; tile < ntiles; tile += stride, buf ^= NBUF - 1) {
    const int p0 = tile * PX;
    bf16* xs = tiles + (NBUF * warp + buf) * WE;  // [8 nx][LD]
    bf16* st = xs + XR * LD;                   // [H][LD]: ss in, ss' out
    bf16* xn = tiles + (NBUF * warp + (buf ^ (NBUF - 1))) * WE;
    const bool next = tile + stride < ntiles;
    if (NBUF == 2 && next) {                   // the next tile, meanwhile
      stage_rows<PX, LD>(x, cx, HW, p0 + stride * PX, vec, xn, lane);
      stage_rows<PX, LD>(ss, H, HW, p0 + stride * PX, vec, xn + XR * LD,
                         lane);
    }
    cp_async_commit();

    float acc[MT][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(fbs + nt * 8 + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][nt][0] = b.x; acc[mt][nt][1] = b.y;
        acc[mt][nt][2] = b.x; acc[mt][nt][3] = b.y;
      }
    }
    // fold k-steps over the carried super-state
#pragma unroll
    for (int ks = 0; ks < TL::KS0; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_trans(a[mt], st + (ks * 16 + (q >> 1) * 8 + r) * LD +
                                 mt * 16 + (q & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = ffr[(ks * NT + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][nt], a[mt], b.x, b.y);
      }
    }
    // x as the A fragments of the gate products (m16n8k8), one a k-step
    uint32_t ax[MT][NX > 0 ? NX : 1][2];
    if constexpr (NX > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < NX; ++ks)
          ldsm_x2_trans(ax[mt][ks],
                        xs + (ks * 8 + r) * LD + mt * 16 + (q & 1) * 8);
    }
    // two 8-unit chunks of [h_ev | h_im] per fold k-step
#pragma unroll 1
    for (int cp = 0; cp < TL::NCH / 2; ++cp) {
      uint32_t ah[MT][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 2 * cp + half;
        const uint32_t* bw = gfr + c * 3 * nx * 32 + lane;
        const float* bb = gbs + c * 3 * 8 + 2 * t;
        const float2 bi = *reinterpret_cast<const float2*>(bb);
        const float2 bg = *reinterpret_cast<const float2*>(bb + 8);
        const float2 bo = *reinterpret_cast<const float2*>(bb + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float gi[4] = {bi.x, bi.y, bi.x, bi.y};
          float gg[4] = {bg.x, bg.y, bg.x, bg.y};
          float go[4] = {bo.x, bo.y, bo.x, bo.y};
          if constexpr (NX > 0) {
#pragma unroll
            for (int ks = 0; ks < NX; ++ks) {
              mma1688(gi, ax[mt][ks], bw[ks * 32]);
              mma1688(gg, ax[mt][ks], bw[(NX + ks) * 32]);
              mma1688(go, ax[mt][ks], bw[(2 * NX + ks) * 32]);
            }
          } else {
            for (int ks = 0; ks < nx; ++ks) {
              uint32_t a[2];
              ldsm_x2_trans(a, xs + (ks * 8 + r) * LD + mt * 16 + (q & 1) * 8);
              mma1688(gi, a, bw[ks * 32]);
              mma1688(gg, a, bw[(nx + ks) * 32]);
              mma1688(go, a, bw[(2 * nx + ks) * 32]);
            }
          }
          float hv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float cc = sigm_fast(gi[e]) * tanh_fast(gg[e]);
            hv[e] = sigm_fast(go[e]) * tanh_fast(cc);
          }
          // accumulator (rows g, g + 8; columns 2t, 2t + 1) of chunk
          // `half` = A registers 2 half, 2 half + 1 of the k-step
          ah[mt][2 * half] = pack_bf16(hv[0], hv[1]);
          ah[mt][2 * half + 1] = pack_bf16(hv[2], hv[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = ffr[((TL::KS0 + cp) * NT + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma16816(acc[mt][nt], ah[mt], b.x, b.y);
      }
    }
    __syncwarp();  // every lane is done reading ss from st
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bf16* o = st + (nt * 8 + 2 * t) * LD + mt * 16 + g;
        o[0] = __float2bfloat16(acc[mt][nt][0]);
        o[LD] = __float2bfloat16(acc[mt][nt][1]);
        o[8] = __float2bfloat16(acc[mt][nt][2]);
        o[LD + 8] = __float2bfloat16(acc[mt][nt][3]);
      }
    }
    __syncwarp();
    store_rows<H, PX, LD>(st, HW, p0, vec, out, lane);
    if (NBUF == 1 && next) {
      __syncwarp();
      stage_rows<PX, LD>(x, cx, HW, p0 + stride * PX, vec, xn, lane);
      stage_rows<PX, LD>(ss, H, HW, p0 + stride * PX, vec, xn + XR * LD,
                         lane);
      cp_async_commit();
    }
    cp_async_wait_all();  // the next tile has landed
    __syncwarp();         // ... and the stores have read st
  }
}

template <int H, int NX>
int launch_mma(const void* x, const void* ss, const void* wfrag,
               const void* bias, void* out, int HW, int cx, int nx, int sms,
               cudaStream_t stream) {
  using TL = Tile<H>;
  const int smem = TL::smem(nx);
  // resident blocks per SM, found once per shared-memory size
  static int per_sm = 0, per_sm_smem = -1;
  if (smem != per_sm_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_fold_mma_kernel<H, NX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lstm_fold_mma_kernel<H, NX>, WARPS * 32, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm_smem = smem;
  }
  const int need = ((HW + TL::PX - 1) / TL::PX + WARPS - 1) / WARPS;
  const int grid = need < per_sm * sms ? need : per_sm * sms;
  lstm_fold_mma_kernel<H, NX><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ss),
      static_cast<const uint32_t*>(wfrag), static_cast<const float*>(bias),
      static_cast<bf16*>(out), HW, cx, nx);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, NX>) for the instance of nx = Cp / 8
// k-steps: NX = nx up to 3, else 0 (the run-time one).
template <class F>
int by_nx(int nx, F f) {
  switch (nx) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

template <int H>
int launch(const void* x, const void* ss, const void* wg, const void* bg,
           const void* wf, const void* bf, const void* wfrag,
           const void* bias, void* out, int HW, int cx, bool is_bf16,
           int sms, cudaStream_t s) {
  const int nx = (cx + 7) / 8;
  return by_nx(nx, [&](auto n) {
    constexpr int NX = decltype(n)::value;
    if (is_bf16)
      return launch_mma<H, NX>(x, ss, wfrag, bias, out, HW, cx, nx, sms, s);
    return launch_f32<H, NX>(
        x, ss, static_cast<const float*>(wg), static_cast<const float*>(bg),
        static_cast<const float*>(wf), static_cast<const float*>(bf), out,
        HW, cx, sms, s);
  });
}

}  // namespace

// x [cx, HW], ss [h, HW], out [h, HW] of one dtype (is_bf16),
// contiguous, cx >= 1. float32: wg [cx, 8h], bg [8h], wf [3h, h], bf [h]
// float32 (wfrag, bias unused). bf16: wfrag and bias as packed by
// pack_fold_weights for Cp = 8 ceil(cx / 8) (wg .. bf unused). sms: the
// card's SM count. Returns the cudaError_t of the launch.
extern "C" int lstm_fold_launch(const void* x, const void* ss, const void* wg,
                                const void* bg, const void* wf, const void* bf,
                                const void* wfrag, const void* bias,
                                void* out, int HW, int cx, int h, int is_bf16,
                                int sms, void* stream) {
  if (HW == 0) return 0;
  if (cx < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b = is_bf16 != 0;
  switch (h) {
    case 16:
      return launch<16>(x, ss, wg, bg, wf, bf, wfrag, bias, out, HW, cx, b,
                        sms, s);
    case 32:
      return launch<32>(x, ss, wg, bg, wf, bf, wfrag, bias, out, HW, cx, b,
                        sms, s);
    case 64:
      return launch<64>(x, ss, wg, bg, wf, bf, wfrag, bias, out, HW, cx, b,
                        sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
