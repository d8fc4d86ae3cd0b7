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
// x [Cx, HW], hc [4hp, HW] rows [h_ev | h_im | c_ev | c_im] and ss [hp,
// HW] in; ss2 [hp, HW] and hc' = [h' | c'] [4hp, HW] out, f32 or bf16
// storage; pres int32[2] on the device (no host sync). hp = 16. Cx = the
// event bins + 3 image channels (8 at the default 5 bins), any Cx >= 1:
// the x rows are padded to Cp = 8 ceil(Cx / 8) with zeros in shared
// memory or registers, never in device memory.
//
// Bound on the H100, bf16 (the SingleScale main path): bytes. Per pixel it
// reads Cx + 5hp values and writes 5hp: at HW = 307200 and Cx = 8 about
// 103 MB (~31 us at 3.35 TB/s; each further x row adds ~0.6 MB, ~0.18
// us). The 5 transcendental functions of each of the 9.8 M LSTM units
// take 49 M SFU operations (~12 us at 16 per clock per SM) whatever Cx,
// the ~3.8 GFLOP of products (at Cx = 8) < 4 us on the tensor cores.
//
// What bounded the first design (one thread per pixel, each of the 32
// units an f32 FMA chain over all 40 inputs -- half of them the zero
// blocks of the block-diagonal gate weights -- with every weight from
// shared memory and accurate expf/tanhf): 0.218 ms, 7x the byte bound, at
// the same time in f32 and bf16, i.e. the CUDA cores' issue.
//
// bf16 design (csrc/lstm_fold.cu's, with a carry): pixels are the M
// dimension of mma.sync. A warp takes a tile of 16 * MT pixels: it stages
// x [Cx, P], hc [4hp, P] and ss [hp, P] from the channel-major rows into its
// own shared memory with 16-byte cp.async copies, the next tile's while it
// computes this one (two buffers), and reads the A fragments of x, h and ss
// with ldmatrix.trans (rows padded: conflict-free). For each 8-unit chunk
// of [h_ev | h_im], the gates i, f, g, o are four n8 tiles of [x | h] @
// the gate weights (K = Cp + 2hp, 40 at 5 bins: one m16n8k8 step per 8
// rows of Cp for x, two m16n8k16 steps for h), the f32 accumulators
// started at the gate biases.
// The gate weights are dense, as the contract's: their zero blocks cost
// the tensor cores nothing. The LSTM runs on the accumulators in registers
// (c read from the staged tile in the accumulator layout; sigmoid(v) =
// 0.5 + 0.5 tanh(v / 2), tanh by tanh.approx.f32: 5 SFU operations a
// unit); h' and c' go back into the staged tile in place. Fold 1's
// accumulators [P, hp] start at bf, take the ss k-step and then the two
// event chunks' h' as one m16n8k16 A fragment (the accumulator layout of
// two m16n8 tiles is the A layout of one m16n8k16): h' never touches
// memory on its way. ss1 = pres_ev ? fold 1 : ss, and its accumulators
// become fold 2's ss A fragment the same way; fold 2 takes the image
// chunks. The result leaves through the warp's shared tile in 16-byte
// stores. The weights are bf16 B fragments in fragment order, packed once
// per network (ops/singlescale_kernels.py::pack_carry_fold_weights), and
// copied to shared memory once per persistent block (cp.async, with the
// warps' first tiles). Rounding, as the TPU kernel's default-precision
// dots (one bf16 pass): x, h, ss, the weights, h' before each fold and ss1
// before fold 2 in bf16; sums, biases and the LSTM in f32.
//
// f32 storage keeps f32 arithmetic (tolerance 1e-4; no TF32, accurate
// expf/tanhf): the first design's thread-per-pixel loop.
//
// The x k-step count NX = Cp / 8 is a template parameter for NX = 1, 2, 3
// (up to 21 event bins; NX = 1 at the default 5), whose x fragments and
// gate weights are sized at compile time: the launcher picks the
// instance. Every larger Cp runs the NX = 0 instance, which reads nx at
// run time: in bf16 it loads x's A fragments per use instead of holding
// them in registers, in f32 it reads x and its gate weights from device
// memory per use. Its shared memory grows with Cp (~0.9 KB a row of Cp in
// bf16): past the card's 227 KB a block (Cp ~ 200) the launch returns the
// CUDA error and the wrapper raises.
//
// Build variants (-D), compared by `python3 chip_smoke.py --k3-variants`:
// K3_WARPS (warps a block, 4), K3_MT (m16 tiles a warp tile, 2),
// K3_MIN_BLOCKS (blocks per SM ptxas aims at, 3), K3_EXACT_TANH
// (expf/tanhf instead of the SFU approximations in the bf16 path),
// K3_ONE_BUFFER (one tile buffer a warp).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int HP = 16;  // padded hidden size a modality

// ---------------------------------------------------------------------------
// float32 storage: one thread per pixel
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

// One half (event: k0 = 0, image: k0 = HP) of the 2HP units of pixel p:
// computes each unit's c', h', stores them to ohc and folds h' into acc.
// in = [x rows (XR = 8 NX; none at NX = 0, whose x and gate weights
// are read from device memory per use) | h rows (2HP)], wk its weights.
template <int NX>
__device__ __forceinline__ void half_units(
    int k0, const float (&in)[8 * NX + 2 * HP], const float* __restrict__ x,
    int cx, const float* __restrict__ wg, const float* __restrict__ hc,
    const float4* wk, const float4* bk, const float* wf, float (&acc)[HP],
    float* __restrict__ ohc, int HW, int p) {
  constexpr int H2 = 2 * HP, NIN = 8 * NX + H2, G = 8 * HP;
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
    if constexpr (NX == 0) {
      for (int c = 0; c < cx; ++c) {
        const float v = x[(size_t)c * HW + p];
        const float* wc = wg + c * G + k;
        g.x = fmaf(v, __ldg(wc), g.x);
        g.y = fmaf(v, __ldg(wc + H2), g.y);
        g.z = fmaf(v, __ldg(wc + 2 * H2), g.z);
        g.w = fmaf(v, __ldg(wc + 3 * H2), g.w);
      }
    }
    const float c_old = hc[(size_t)(H2 + k) * HW + p];
    const float c = sigm(g.y) * c_old + sigm(g.x) * tanhf(g.z);
    const float h = sigm(g.w) * tanhf(c);
    ohc[(size_t)k * HW + p] = h;
    ohc[(size_t)(H2 + k) * HW + p] = c;
    const float* wr = wf + (HP + (k - k0)) * HP;      // fold rows [HP, 2HP)
#pragma unroll
    for (int j = 0; j < HP; ++j) acc[j] = fmaf(h, wr[j], acc[j]);
  }
}

// acc = bf + wf[0:HP]^T s (the fold's super-state half). The k loop stays
// rolled: unrolled, its HP * HP weight loads are scheduled ahead of the
// FMAs and take ~250 registers, which spill (PERF.md has the times).
__device__ __forceinline__ void fold_start(const float (&s)[HP],
                                           const float* wf, const float* bf,
                                           float (&acc)[HP]) {
#pragma unroll
  for (int j = 0; j < HP; ++j) acc[j] = bf[j];
#pragma unroll 1
  for (int k = 0; k < HP; ++k) {
#pragma unroll
    for (int j = 0; j < HP; ++j) acc[j] = fmaf(s[k], wf[k * HP + j], acc[j]);
  }
}

// Two blocks of 256 threads per SM (at most 128 registers a thread), the
// fastest of one, two and three (PERF.md has the times).
template <int NX>
__global__ void __launch_bounds__(256, 2)
lstm_carry_fold_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ hc,
                           const float* __restrict__ ss,
                           const float* __restrict__ wg,
                           const float* __restrict__ wh,
                           const float* __restrict__ bg,
                           const float* __restrict__ wf,
                           const float* __restrict__ bf,
                           const int* __restrict__ pres,
                           float* __restrict__ oss, float* __restrict__ ohc,
                           int HW, int cx) {
  constexpr int H2 = 2 * HP, XR = 8 * NX, NIN = XR + H2, G = 8 * HP;
  __shared__ float4 wk[H2 * NIN];   // [unit][input] -> (i, f, g, o)
  __shared__ float4 bk[H2];         // [unit] -> (i, f, g, o)
  __shared__ float wfs[H2 * HP];    // [ss | data rows][HP]
  __shared__ float bfs[HP];
  for (int e = threadIdx.x; e < H2 * NIN; e += blockDim.x) {
    const int k = e / NIN, r = e % NIN;
    if (r < XR && r >= cx) {
      wk[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* src = r < XR ? wg + r * G : wh + (r - XR) * G;
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
    for (int c = 0; c < XR; ++c) in[c] = c < cx ? x[(size_t)c * HW + p] : 0.f;
#pragma unroll
    for (int j = 0; j < H2; ++j) in[XR + j] = hc[(size_t)j * HW + p];
    float s[HP], acc[HP];
#pragma unroll
    for (int j = 0; j < HP; ++j) s[j] = ss[(size_t)j * HW + p];

    fold_start(s, wfs, bfs, acc);
    half_units<NX>(0, in, x, cx, wg, hc, wk, bk, wfs, acc, ohc, HW, p);
#pragma unroll
    for (int j = 0; j < HP; ++j) s[j] = p_ev ? acc[j] : s[j];
    fold_start(s, wfs, bfs, acc);
    half_units<NX>(HP, in, x, cx, wg, hc, wk, bk, wfs, acc, ohc, HW, p);
#pragma unroll
    for (int j = 0; j < HP; ++j) oss[(size_t)j * HW + p] = p_im ? acc[j] : s[j];
  }
}

// ---------------------------------------------------------------------------
// bf16 storage: mma.sync
// ---------------------------------------------------------------------------

#ifndef K3_WARPS
#define K3_WARPS 4
#endif
#ifndef K3_MT
#define K3_MT 2
#endif
#ifndef K3_MIN_BLOCKS
#define K3_MIN_BLOCKS 3
#endif
constexpr int WARPS = K3_WARPS;
#ifdef K3_ONE_BUFFER  // build variant: load each tile after the last one
constexpr int NBUF = 1;
#else
constexpr int NBUF = 2;  // the next tile's copy overlaps this one's work
#endif

constexpr int MT = K3_MT;          // m16 tiles a warp tile
constexpr int PX = 16 * MT;        // pixels a warp tile
constexpr int LD = PX + 8;         // shared row stride in bf16: ldmatrix
                                   // conflict-free
constexpr int NCH = 2 * HP / 8;    // 8-unit chunks of [h_ev | h_im]
constexpr int FW = 2 * 2 * 64;     // fold fragment words
constexpr int NB = 8 * HP + HP;    // bias floats: bg, then bf
// At nx k8 steps of x (Cp = 8 nx): the staged rows of a warp tile are x
// (8 nx), h (2hp), c (2hp), ss (hp); the gate words of a (chunk, gate)
// are x's nx steps, then h's.
struct Rows {
  int hr, cr, sr, elems;
  __host__ __device__ constexpr explicit Rows(int nx)
      : hr(8 * nx), cr(8 * nx + 2 * HP), sr(8 * nx + 4 * HP),
        elems((8 * nx + 5 * HP) * LD) {}
};
__host__ __device__ constexpr int gwc(int nx) { return nx * 32 + 2 * 64; }
__host__ __device__ constexpr int gw(int nx) { return NCH * 4 * gwc(nx); }
__host__ __device__ constexpr int smem_bytes(int nx) {
  return (gw(nx) + FW + NB) * 4 + WARPS * NBUF * Rows(nx).elems * 2;
}

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
#ifdef K3_EXACT_TANH
  return tanhf(v);
#else
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
#endif
}

__device__ __forceinline__ float sigm_fast(float v) {
#ifdef K3_EXACT_TANH
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

// Start copying R channel-major rows of pixels [p0, p0 + PX) of src
// [R, HW] into dst [R][LD]: cp.async of 16 bytes a lane when the tile is
// whole and the rows are 16-byte aligned (HW % 8 == 0); else element by
// element at once, zeros past HW.
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src,
                                           int R, int HW, int p0, bool vec,
                                           bf16* __restrict__ dst, int lane) {
  constexpr int LPR = PX / 8;                    // lanes a row
  constexpr int RPI = 32 / LPR;                  // rows an instruction
  if (vec && p0 + PX <= HW) {
    const int r0 = lane / LPR, c = (lane % LPR) * 8;
#pragma unroll
    for (int r = r0; r < R; r += RPI)
      cp_async16(dst + r * LD + c, src + (size_t)r * HW + p0 + c);
  } else {
    for (int i = lane; i < R * PX; i += 32) {
      const int r = i / PX, c = i - r * PX;
      dst[r * LD + c] = p0 + c < HW ? src[(size_t)r * HW + p0 + c]
                                    : __float2bfloat16(0.f);
    }
  }
}

// A tile src [R][LD] back to pixels [p0, p0 + PX) of the rows of dst
// [R, HW] (pixels past HW not written), 16-byte stores when it can.
template <int R>
__device__ __forceinline__ void store_rows(const bf16* __restrict__ src,
                                           int HW, int p0, bool vec,
                                           bf16* __restrict__ dst, int lane) {
  constexpr int LPR = PX / 8;
  constexpr int RPI = 32 / LPR;
  if (vec && p0 + PX <= HW) {
    const int r0 = lane / LPR, c = (lane % LPR) * 8;
#pragma unroll
    for (int r = r0; r < R; r += RPI)
      *reinterpret_cast<uint4*>(dst + (size_t)r * HW + p0 + c) =
          *reinterpret_cast<const uint4*>(src + r * LD + c);
  } else {
    for (int i = lane; i < R * PX; i += 32) {
      const int r = i / PX, c = i - r * PX;
      if (p0 + c < HW) dst[(size_t)r * HW + p0 + c] = src[r * LD + c];
    }
  }
}

// One warp tile's x, hc and ss rows into its buffer (cp.async, not
// committed): x's cx rows at row 0, hc at rw.hr, ss at rw.sr.
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ x,
                                           const bf16* __restrict__ hc,
                                           const bf16* __restrict__ ss,
                                           int cx, const Rows& rw, int HW,
                                           int p0, bool vec,
                                           bf16* __restrict__ t, int lane) {
  stage_rows(x, cx, HW, p0, vec, t, lane);
  stage_rows(hc, 4 * HP, HW, p0, vec, t + rw.hr * LD, lane);
  stage_rows(ss, HP, HW, p0, vec, t + rw.sr * LD, lane);
}

// The fold accumulators acc[MT][2][4] (rows g, g + 8 of m-tile mt; units
// 8 nt + 2t, + 1) as bf16 into the ss rows (from sr) of tile t.
__device__ __forceinline__ void put_ss(bf16* t, int sr,
                                       const float (&acc)[MT][2][4], int g,
                                       int tq) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      bf16* o = t + (sr + nt * 8 + 2 * tq) * LD + mt * 16 + g;
      o[0] = __float2bfloat16(acc[mt][nt][0]);
      o[LD] = __float2bfloat16(acc[mt][nt][1]);
      o[8] = __float2bfloat16(acc[mt][nt][2]);
      o[LD + 8] = __float2bfloat16(acc[mt][nt][3]);
    }
  }
}

// Zero the x rows [cx, 8 nx) of a warp's tile buffer (columns [0, PX)):
// the k-steps read them, the staging never writes them.
__device__ __forceinline__ void zero_rows(bf16* __restrict__ t, int cx,
                                          int nx, int lane) {
  for (int i = lane; i < (8 * nx - cx) * PX; i += 32)
    t[(cx + i / PX) * LD + i % PX] = __float2bfloat16(0.f);
}

// wfrag, bf16 pairs: the gate B fragments [NCH chunks][4 gates i, f, g, o]
// [gwc(nx) words] -- the x steps' [nx k8 steps][32 lanes] (B[2t][g],
// B[2t+1][g] of the m16n8k8 step, lane = 4 g + t), then the h steps' [2
// k-steps][32 lanes][2 words] (m16n8k16: rows 2t, 2t+1 and 2t+8, 2t+9,
// column g) -- then the fold's [2 k-steps: ss, data][2 n-tiles][32 lanes]
// [2 words]. bias, f32: bg [8hp] (the contract's order), then bf [hp].
// NX > 0: nx = NX, x's A fragments held in registers; NX = 0: nx_arg,
// loaded per use.
template <int NX>
__global__ void __launch_bounds__(WARPS * 32, K3_MIN_BLOCKS)
lstm_carry_fold_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ hc,
                           const bf16* __restrict__ ss,
                           const uint32_t* __restrict__ wfrag,
                           const float* __restrict__ bias,
                           const int* __restrict__ pres,
                           bf16* __restrict__ oss, bf16* __restrict__ ohc,
                           int HW, int cx, int nx_arg) {
  const int nx = NX > 0 ? NX : nx_arg;
  const Rows rw(nx);
  const int GW = gw(nx), GWC = gwc(nx);
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t* gfr = smem;
  const uint2* ffr = reinterpret_cast<const uint2*>(smem + GW);
  const float* bgs = reinterpret_cast<const float*>(smem + GW + FW);
  const float* bfs = bgs + 8 * HP;
  bf16* tiles = reinterpret_cast<bf16*>(smem + GW + FW + NB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bool vec = (HW & 7) == 0;
  const bool p_ev = pres[0] > 0, p_im = pres[1] > 0;
  const int ntiles = (HW + PX - 1) / PX, stride = gridDim.x * WARPS;
  // the weights, and this warp's first tile, copied in together
  for (int i = threadIdx.x; i < (GW + FW) / 4; i += blockDim.x)
    cp_async16(smem + 4 * i, wfrag + 4 * i);
  for (int i = threadIdx.x; i < NB / 4; i += blockDim.x)
    cp_async16(smem + GW + FW + 4 * i, bias + 4 * i);
  for (int b = 0; b < NBUF; ++b)
    zero_rows(tiles + (NBUF * warp + b) * rw.elems, cx, nx, lane);
  int tile = blockIdx.x * WARPS + warp, buf = 0;
  if (tile < ntiles)
    stage_tile(x, hc, ss, cx, rw, HW, tile * PX, vec,
               tiles + NBUF * warp * rw.elems, lane);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix row addresses of this lane: matrix q = lane / 8, row lane % 8
  const int q = lane >> 3, r = lane & 7;
  for (; tile < ntiles; tile += stride, buf ^= NBUF - 1) {
    const int p0 = tile * PX;
    bf16* t = tiles + (NBUF * warp + buf) * rw.elems;
    bf16* tn = tiles + (NBUF * warp + (buf ^ (NBUF - 1))) * rw.elems;
    const bool next = tile + stride < ntiles;
    if (NBUF == 2 && next)                     // the next tile, meanwhile
      stage_tile(x, hc, ss, cx, rw, HW, p0 + stride * PX, vec, tn, lane);
    cp_async_commit();

    // A fragments: x (m16n8k8 a k-step; NX = 0: loaded per use), h (two
    // m16n8k16 k-steps), ss (m16n8k16)
    uint32_t ax[MT][NX > 0 ? NX : 1][2], ah[2][MT][4], as[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (NX > 0) {
#pragma unroll
        for (int ks = 0; ks < NX; ++ks)
          ldsm_x2_trans(ax[mt][ks],
                        t + (ks * 8 + r) * LD + mt * 16 + (q & 1) * 8);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldsm_x4_trans(ah[ks][mt], t + (rw.hr + ks * 16 + (q >> 1) * 8 + r) *
                                      LD + mt * 16 + (q & 1) * 8);
      ldsm_x4_trans(as[mt], t + (rw.sr + (q >> 1) * 8 + r) * LD + mt * 16 +
                                (q & 1) * 8);
    }
    __syncwarp();  // h and ss are in registers: their rows may be rewritten
    // modality m = 0 (event: fold 1 over ss), 1 (image: fold 2 over ss1)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float acc[MT][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 b =
            *reinterpret_cast<const float2*>(bfs + nt * 8 + 2 * tq);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][0] = b.x; acc[mt][nt][1] = b.y;
          acc[mt][nt][2] = b.x; acc[mt][nt][3] = b.y;
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {               // the super-state step
        const uint2 b = ffr[nt * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma16816(acc[mt][nt], as[mt], b.x, b.y);
      }
      uint32_t ahn[MT][4];                           // this modality's h'
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 2 * m + half;
        const uint32_t* bw = gfr + c * 4 * GWC;
        float2 bb[4];
#pragma unroll
        for (int G = 0; G < 4; ++G)
          bb[G] = *reinterpret_cast<const float2*>(bgs + G * 2 * HP + 8 * c +
                                                   2 * tq);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float gt[4][4];
#pragma unroll
          for (int G = 0; G < 4; ++G) {
            const uint32_t* w = bw + G * GWC;
            gt[G][0] = bb[G].x; gt[G][1] = bb[G].y;
            gt[G][2] = bb[G].x; gt[G][3] = bb[G].y;
            if constexpr (NX > 0) {
#pragma unroll
              for (int ks = 0; ks < NX; ++ks)
                mma1688(gt[G], ax[mt][ks], w[ks * 32 + lane]);
            } else {
              for (int ks = 0; ks < nx; ++ks) {
                uint32_t a[2];
                ldsm_x2_trans(a, t + (ks * 8 + r) * LD + mt * 16 +
                                     (q & 1) * 8);
                mma1688(gt[G], a, w[ks * 32 + lane]);
              }
            }
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              const uint2 b = reinterpret_cast<const uint2*>(
                  w + nx * 32)[ks * 32 + lane];
              mma16816(gt[G], ah[ks][mt], b.x, b.y);
            }
          }
          // accumulator e: pixel mt*16 + g (+8 for e >= 2), unit 8c + 2t
          // (+1 for odd e); c there in the staged tile, h' and c' after
          bf16* cq = t + (rw.cr + 8 * c + 2 * tq) * LD + mt * 16 + g;
          bf16* hq = t + (rw.hr + 8 * c + 2 * tq) * LD + mt * 16 + g;
          float hv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = (e & 1) * LD + (e >> 1) * 8;
            const float c_old = __bfloat162float(cq[off]);
            const float cn = sigm_fast(gt[1][e]) * c_old +
                             sigm_fast(gt[0][e]) * tanh_fast(gt[2][e]);
            hv[e] = sigm_fast(gt[3][e]) * tanh_fast(cn);
            cq[off] = __float2bfloat16(cn);
            hq[off] = __float2bfloat16(hv[e]);
          }
          // chunk `half`'s accumulator = A registers 2 half, 2 half + 1
          ahn[mt][2 * half] = pack_bf16(hv[0], hv[1]);
          ahn[mt][2 * half + 1] = pack_bf16(hv[2], hv[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {               // the data step
        const uint2 b = ffr[(2 + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma16816(acc[mt][nt], ahn[mt], b.x, b.y);
      }
      if (m == 0 && p_ev) {
        // ss1: fold 1, as fold 2's A fragment (n-tile nt = A registers
        // 2 nt, 2 nt + 1), and the output unless the image fold follows
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            as[mt][2 * nt] = pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
            as[mt][2 * nt + 1] = pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
          }
        }
        if (!p_im) put_ss(t, rw.sr, acc, g, tq);
      }
      if (m == 1 && p_im) put_ss(t, rw.sr, acc, g, tq);
    }
    __syncwarp();
    store_rows<4 * HP>(t + rw.hr * LD, HW, p0, vec, ohc, lane);
    store_rows<HP>(t + rw.sr * LD, HW, p0, vec, oss, lane);
    if (NBUF == 1 && next) {
      __syncwarp();
      stage_tile(x, hc, ss, cx, rw, HW, p0 + stride * PX, vec, tn, lane);
      cp_async_commit();
    }
    cp_async_wait_all();  // the next tile has landed
    __syncwarp();         // ... and the stores have read t
  }
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

template <int NX>
int launch_mma(const void* x, const void* hc, const void* ss,
               const void* wfrag, const void* bias, const int* pres,
               void* oss, void* ohc, int HW, int cx, int nx, int sms,
               cudaStream_t stream) {
  const int smem = smem_bytes(nx);
  // resident blocks per SM, found once per shared-memory size
  static int per_sm = 0, per_sm_smem = -1;
  if (smem != per_sm_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_carry_fold_mma_kernel<NX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lstm_carry_fold_mma_kernel<NX>, WARPS * 32, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm_smem = smem;
  }
  const int need = ((HW + PX - 1) / PX + WARPS - 1) / WARPS;
  const int grid = need < per_sm * sms ? need : per_sm * sms;
  lstm_carry_fold_mma_kernel<NX><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(hc),
      static_cast<const bf16*>(ss), static_cast<const uint32_t*>(wfrag),
      static_cast<const float*>(bias), pres, static_cast<bf16*>(oss),
      static_cast<bf16*>(ohc), HW, cx, nx);
  return (int)cudaGetLastError();
}

template <int NX>
int launch_f32(const void* x, const void* hc, const void* ss, const void* wg,
               const void* wh, const void* bg, const void* wf, const void* bf,
               const int* pres, void* oss, void* ohc, int HW, int cx,
               int sms, cudaStream_t s) {
  const int need = (HW + 255) / 256;
  const int grid = need < 2 * sms ? need : 2 * sms;  // one wave
  lstm_carry_fold_f32_kernel<NX><<<grid, 256, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(hc),
      static_cast<const float*>(ss), static_cast<const float*>(wg),
      static_cast<const float*>(wh), static_cast<const float*>(bg),
      static_cast<const float*>(wf), static_cast<const float*>(bf), pres,
      static_cast<float*>(oss), static_cast<float*>(ohc), HW, cx);
  return (int)cudaGetLastError();
}

}  // namespace

// x [cx, HW], hc [4hp, HW], ss [hp, HW], oss [hp, HW], ohc [4hp, HW] of
// one dtype (is_bf16), contiguous, outputs not aliasing the inputs, cx
// >= 1; pres int32[2]. float32: wg [cx, 8hp], wh [2hp, 8hp], bg [8hp], wf
// [2hp, hp], bf [hp] float32 (wfrag, bias unused). bf16: wfrag and bias
// as packed by pack_carry_fold_weights for Cp = 8 ceil(cx / 8) (wg .. bf
// unused). hp must be 16; sms: the card's SM count. Returns the
// cudaError_t of the launch.
extern "C" int lstm_carry_fold_launch(const void* x, const void* hc,
                                      const void* ss, const void* wg,
                                      const void* wh, const void* bg,
                                      const void* wf, const void* bf,
                                      const void* wfrag, const void* bias,
                                      const void* pres, void* oss, void* ohc,
                                      int HW, int cx, int hp, int is_bf16,
                                      int sms, void* stream) {
  if (hp != HP || cx < 1) return (int)cudaErrorInvalidValue;
  if (HW == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pr = static_cast<const int*>(pres);
  const int nx = (cx + 7) / 8;
  return by_nx(nx, [&](auto n) {
    constexpr int NX = decltype(n)::value;
    if (is_bf16)
      return launch_mma<NX>(x, hc, ss, wfrag, bias, pr, oss, ohc, HW, cx, nx,
                            sms, s);
    return launch_f32<NX>(x, hc, ss, wg, wh, bg, wf, bf, pr, oss, ohc, HW,
                          cx, sms, s);
  });
}
