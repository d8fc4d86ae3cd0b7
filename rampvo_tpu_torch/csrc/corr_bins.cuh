// Binned lattice correlation: the shared device code of K5 (corr_paired.cu)
// and K6 (corr_lattice_cb.cu).
//
// Why. K1's routine (corr_window.cuh::edge, one warp per edge) reads each
// edge's two window boxes straight from L2: no two warps share a tap read,
// so its launches move ~3 GB from L2 at ~5 TB/s, while the edges of one
// target read each tap of its rings ~15 times. This design lets the edges
// that look at the same place share one read.
//
// 1. Bins, built on the device at every launch (nothing read on the host,
//    so a CUDA graph captures it). A key kernel (the caller's: K6 walks
//    cell_tables_a, K5 the live cells) runs `bin_edge` with one warp per
//    edge: the edge's bin is (target slot, tile of its level-1 box origin,
//    ops/corr_bins.py::bin_grid); an edge whose boxes do not fit the
//    bin's fixed staged regions (a span beyond the box sides b1 / b2 or
//    CAP, far or non-finite coords, boxes off the map) goes to the
//    residual list. Lane 0 counts the edge into its bin by an atomic
//    (the rank inside the bin) and widens the bin's bounding boxes (the
//    union of its edges' boxes clipped to the map, per level). Dead and
//    unwalked edges get their zero rows there. `bins_scan` (one block)
//    takes the exclusive scan of the counts and cuts each bin into work
//    items of at most IE edges -- a large bin spreads over several blocks
//    that each stage it -- and `bins_scatter` writes the permutation.
// 2. `binned_kernel`: persistent blocks take work items from an atomic
//    counter. The block copies its bin's bounding boxes of taps at both
//    levels (<= s1x x s1y and s2x x s2y taps of 256 bytes in bf16) from the
//    target rings into shared memory with cp.async, each 16-byte chunk c
//    of the tap at map column x stored at chunk c ^ 4 (x & 1): the mma
//    B-fragment reads of neighbouring taps then fall in disjoint banks.
//    Its warps then run K1's per-edge routine on CB_K edges each, one
//    after the other (the next edge's features loading under the current
//    one), with the B fragments read from shared memory (dots_mma_staged:
//    the same mma.sync.m16n8k16 sequence per 8-tap n-tile, four n-tiles
//    interleaved), K1's raw buffer and the caller's Store policy, so the
//    outputs equal K1's bit for bit. Residual items run K1's routine
//    (`edge`, global loads, `slow_edges` counting) in the same launch.
//    Not TMA: a tap is 256 bytes, and TMA's 128-byte swizzle leaves the
//    B-fragment reads of every even tap with a two-way bank conflict;
//    cp.async writes this kernel's own swizzle.
// 3. float32 rings (and the -DCB_STAGE=0 build, the binned order with
//    loads from global memory through L1) run the same bins and items
//    with K1's global-memory dots (dots_fma in f32). The main path is
//    bf16.
//
// Launch: init (counts, bboxes, control), the caller's key kernel,
// bins_scan, bins_scatter, binned_kernel -- five kernels on one stream,
// all of them the wrapper's one call and its time.
//
// Shipped build (chosen by `chip_smoke.py --corr-bins`): 8 warps, items
// of 64 edges, 4 n-tiles interleaved, bin tile 12 x 12, binned boxes <= 12
// (level 1) and <= 9 (level 2) taps a side, ~229 KB of shared memory, one
// block an SM. Measured there on an NVIDIA H100 80GB HBM3, 700.00 W (bf16,
// patch-shaped coords): K6 0.716 ms and K5 0.658 ms against K1's 0.409 at
// the main path's lattice (60,000 edges), 5.42 and 4.96 ms against 4.47 at
// precise.yaml's (877,500). What bounds it: not the staged bytes but the
// per-edge instruction latency at 8 warps an SM (two a scheduler): the
// shared memory that holds a bin's regions leaves room for no more warps'
// raw buffers, and K1 hides the same per-edge chain with 16-20 warps. The
// main lattice's bins hold ~7 edges, too few to keep 8 warps busy. The
// binned order alone (-DCB_STAGE=0, 16 warps an SM) measured 0.483 / 0.442
// ms there and 4.50 / 3.94 ms at precise.yaml's lattice.

#pragma once

#include <climits>
#include <type_traits>

#include "corr_window.cuh"

namespace corrbins {

using namespace corrwin;

#ifndef CB_WARPS
#define CB_WARPS 8
#endif
#ifndef CB_K
#define CB_K 8
#endif
#ifndef CB_STAGE
#define CB_STAGE 1
#endif
#ifndef CB_BMAX
#define CB_BMAX 12
#endif
#ifndef CB_ILP
#define CB_ILP 4
#endif
constexpr int BW = CB_WARPS;     // warps per block of binned_kernel
constexpr int IE = BW * CB_K;    // edges per work item (CB_K a warp)
constexpr int ILP = CB_ILP;      // n-tiles interleaved in dots_mma_staged
// Largest level-1 box side of a binned edge (the grid's b1 may not exceed
// it) and the raw row stride of binned edges: >= CB_BMAX^2 floats, 8 mod
// 32 (conflict-free stores, as RS), so a warp's raw buffer shrinks with
// the boxes it holds.
constexpr int BMAX = CB_BMAX;
constexpr int RSB = (BMAX * BMAX + 23) / 32 * 32 + 8;
constexpr int KEY_WARPS = 8;  // warps per block of the key kernels

// ops/corr_bins.py::BinGrid, in field order
struct Grid {
  int tsx, tsy, b1, b2, off, ntx, nty, s1x, s1y, s2x, s2y, mem;
  __host__ __device__ int nbin() const { return mem * nty * ntx; }
  __host__ __device__ int tiles() const { return nty * ntx; }
};

// The launch's scratch, carved from one int32 buffer of
// ops/corr_bins.py::scratch_words(E, grid) words.
struct Scratch {
  int4* items; // [E] (bin, first perm index, edges, 0)
  int* key;    // [E] bin, nbin = residual, -1 = none
  int* rank;   // [E] place inside the bin
  int* perm;   // [E] edges in bin order
  int* meta;   // [2E] (target slot, host gmap slot)
  int* counts; // [nbin + 1]
  int* boff;   // [nbin + 1]
  int* bbox;   // [nbin][2 levels][x0, y0, x1, y1]
  int* ctrl;   // [4] items, residual edges, work counter, residual base
};

inline size_t scratch_words(int E, const Grid& g) {
  return 9 * (size_t)E + 10 * (size_t)g.nbin() + 6;
}

inline Scratch carve(int* s, int E, const Grid& g) {
  Scratch c;
  const size_t nb = g.nbin();
  c.items = reinterpret_cast<int4*>(s);  // 16-byte aligned with the buffer
  c.key = s + 4 * (size_t)E;
  c.rank = s + 5 * (size_t)E;
  c.perm = s + 6 * (size_t)E;
  c.meta = s + 7 * (size_t)E;
  c.counts = s + 9 * (size_t)E;
  c.boff = c.counts + nb + 1;
  c.bbox = c.boff + nb + 1;
  c.ctrl = c.bbox + 8 * nb;
  return c;
}

// Level l's geometry of an edge from its level-1 coords (level 2 at / 4),
// as corr_window.cuh::edge computes it.
__device__ __forceinline__ Geom level_geometry(float x1, float y1, int l) {
  return l == 0 ? geometry(x1, y1)
                : geometry(__fmul_rn(x1, 0.25f), __fmul_rn(y1, 0.25f));
}

// Host: how many edges of this library's launches took K1's slow path
// since the last reset, into *count (host memory), after waiting for the
// device; `reset` then sets the counter to 0. Returns the cudaError_t.
inline int read_slow_edges(unsigned int* count, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(count, slow_edges,
                                         sizeof(unsigned int));
  if (err == cudaSuccess && reset) {
    const unsigned int zero = 0;
    err = cudaMemcpyToSymbol(slow_edges, &zero, sizeof(zero));
  }
  return (int)err;
}

// corr_window.cuh's RefStore with the raw pixel rows RSX floats apart (K6's
// policy): the same blends and stores; level<T> (RSX = RS) is RefStore's.
// Copied rather than changed in place, so that the code K1 and K7 compile
// stays as it is.
struct RefStoreRows : RefStore {
  template <typename T, int RSX = RS>
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
      const float v = blend(raw + q * RSX + (oy + b) * gm.bw + ox + a, gm.bw,
                            fx, fy);
      if (p >= NP) continue;
      if (l == 0)
        stage[p] = v;
      else
        Vec<T>::store2(orow + 2 * p, stage[p], v);
    }
  }
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__global__ void bins_init(Scratch s, int nbin) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 2 * nbin;
       i += gridDim.x * blockDim.x) {
    int* b = s.bbox + 4 * i;
    b[0] = INT_MAX; b[1] = INT_MAX; b[2] = INT_MIN; b[3] = INT_MIN;
    if (i <= nbin) s.counts[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x < 4) s.ctrl[threadIdx.x] = 0;
}

// One warp, one live edge e looking at target slot `slot` from host gmap
// slot `gslot`: its bin or the residual list, counted; lanes as `edge`.
__device__ __forceinline__ void bin_edge(const Scratch& s, const Grid& g,
                                         int e, int slot, int gslot,
                                         const float* __restrict__ up,
                                         const float* __restrict__ vp,
                                         int H1, int W1, int H2, int W2,
                                         int lane) {
  const int qi = lane < PP ? lane : PP - 1;
  const float x1 = up[qi], y1 = vp[qi];
  const Geom a = level_geometry(x1, y1, 0);
  const Geom b = level_geometry(x1, y1, 1);
  int key = g.nbin();
  if (a.fits && b.fits && a.bw <= g.b1 && a.bh <= g.b1 && b.bw <= g.b2 &&
      b.bh <= g.b2) {
    const int tx = floor_div(a.bx + 3 + g.off, g.tsx);
    const int ty = floor_div(a.by + 3 + g.off, g.tsy);
    const int X1 = tx * g.tsx - g.off - 3, Y1 = ty * g.tsy - g.off - 3;
    const int X2 = floor_div(tx * g.tsx - g.off, 4) - 3;
    const int Y2 = floor_div(ty * g.tsy - g.off, 4) - 3;
    if (tx >= 0 && tx < g.ntx && ty >= 0 && ty < g.nty && a.bx >= X1 &&
        a.bx + a.bw <= X1 + g.s1x && a.by >= Y1 &&
        a.by + a.bh <= Y1 + g.s1y && b.bx >= X2 &&
        b.bx + b.bw <= X2 + g.s2x && b.by >= Y2 && b.by + b.bh <= Y2 + g.s2y)
      key = (slot * g.nty + ty) * g.ntx + tx;
  }
  if (lane != 0) return;
  s.rank[e] = atomicAdd(s.counts + key, 1);
  s.key[e] = key;
  s.meta[2 * e] = slot;
  s.meta[2 * e + 1] = gslot;
  if (key == g.nbin()) return;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const Geom& m = l == 0 ? a : b;
    const int W = l == 0 ? W1 : W2, H = l == 0 ? H1 : H2;
    const int x0 = max(m.bx, 0), y0 = max(m.by, 0);
    const int xe = min(m.bx + m.bw - 1, W - 1);
    const int ye = min(m.by + m.bh - 1, H - 1);
    if (x0 > xe || y0 > ye) continue;
    int* bb = s.bbox + 8 * key + 4 * l;
    atomicMin(bb, x0); atomicMin(bb + 1, y0);
    atomicMax(bb + 2, xe); atomicMax(bb + 3, ye);
  }
}

// An edge without a bin (dead or unwalked): key -1.
__device__ __forceinline__ void no_bin(const Scratch& s, int e, int lane) {
  if (lane == 0) s.key[e] = -1;
}

// Exclusive scan of the counts (bins, then the residual list) into
// offsets, and the work items: each bin cut into runs of at most IE.
__global__ void __launch_bounds__(1024) bins_scan(Scratch s, int nbin) {
  __shared__ int sa[1024], sb[1024];
  const int n1 = nbin + 1, t = threadIdx.x;
  const int per = (n1 + 1023) / 1024;
  const int lo = min(t * per, n1), hi = min(lo + per, n1);
  int a = 0, b = 0;
  for (int i = lo; i < hi; ++i) {
    a += s.counts[i];
    if (i < nbin) b += (s.counts[i] + IE - 1) / IE;
  }
  sa[t] = a; sb[t] = b;
  __syncthreads();
  for (int d = 1; d < 1024; d <<= 1) {  // inclusive Hillis-Steele scan
    const int va = t >= d ? sa[t - d] : 0, vb = t >= d ? sb[t - d] : 0;
    __syncthreads();
    sa[t] += va; sb[t] += vb;
    __syncthreads();
  }
  int oa = sa[t] - a, ob = sb[t] - b;
  for (int i = lo; i < hi; ++i) {
    const int n = s.counts[i];
    s.boff[i] = oa;
    if (i == nbin) s.ctrl[3] = oa;  // residual base
    if (i < nbin)
      for (int k = 0; k < n; k += IE)
        s.items[ob++] = make_int4(i, oa + k, min(IE, n - k), 0);
    oa += n;
  }
  if (t == 1023) {
    s.ctrl[0] = sb[1023];           // bin items
    s.ctrl[1] = s.counts[nbin];     // residual edges
    s.ctrl[2] = 0;                  // work counter
  }
}

__global__ void bins_scatter(Scratch s, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int k = s.key[e];
  if (k >= 0) s.perm[s.boff[k] + s.rank[e]] = e;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Issue the copies of the taps [x0, x0 + rw) x [y0, y0 + rh) of one
// target map (all in the map) into a shared buffer, row-major, chunk c of
// the tap at map column x at chunk c ^ 4 (x & 1). The caller commits and
// waits.
__device__ __forceinline__ void stage(__nv_bfloat16* reg,
                                      const __nv_bfloat16* __restrict__ fslot,
                                      int Wf, int x0, int y0, int rw,
                                      int rh) {
  const int n = rw * rh * 16;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int tap = i >> 4, ch = i & 15;
    const int ty = tap / rw, tx = tap - ty * rw;
    const int x = x0 + tx;
    cp_async16(reg + tap * C + ((ch ^ ((x & 1) << 2)) << 3),
               fslot + ((size_t)(y0 + ty) * Wf + x) * C + ch * 8);
  }
}

// A bin's staged region at one level: map taps [x, x + w) x [y, y + h).
struct Rect {
  int x, y, w, h;
};

__device__ __forceinline__ Rect bin_rect(const int* __restrict__ bb) {
  Rect r;
  r.x = bb[0]; r.y = bb[1];
  r.w = bb[2] >= r.x ? bb[2] - r.x + 1 : 0;
  r.h = bb[3] >= r.y ? bb[3] - r.y + 1 : 0;
  return r;
}

// dots_mma (corr_window.cuh) with the B fragments read from the staged
// region (map taps [rx, rx + rw) x [ry, ...) in `reg`): box form, all 9
// rows. Same loads per lane, same `any` skip and the same mma sequence per
// n-tile, so the raw dots equal dots_mma's bit for bit; ILP n-tiles at a
// time, their mma chains interleaved.
template <int RSX>
__device__ __forceinline__ void dots_mma_staged(
    const uint32_t (&a)[8][4], const __nv_bfloat16* __restrict__ reg, int rx,
    int ry, int rw, int Hf, int Wf, int bx, int by, int bw, int bh,
    float* __restrict__ raw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ntile = (bw * bh + 7) >> 3;
  int ty = 0, tx = g;  // bw >= 8 > g
  for (int t0 = 0; t0 < ntile; t0 += ILP) {
    uint4 b[ILP][4];
    bool any[ILP];
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      const int x = bx + tx, y = by + ty;
      const bool in = t0 + i < ntile && ty < bh && x >= 0 && x < Wf &&
                      y >= 0 && y < Hf;
      if (in) {
        const __nv_bfloat16* p = reg + ((y - ry) * rw + (x - rx)) * C;
        const int sw = (x & 1) << 2;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[i][j] = *reinterpret_cast<const uint4*>(
              p + (((j * 4 + t) ^ sw) << 3));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) b[i][j] = make_uint4(0u, 0u, 0u, 0u);
      }
      any[i] = __any_sync(FULL, in);
      tx += 8;
      if (tx >= bw) { tx -= bw; ++ty; }
    }
    float c[ILP][4];
#pragma unroll
    for (int i = 0; i < ILP; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < ILP; ++i)
        if (any[i]) mma16816(c[i], a[2 * j], b[i][j].x, b[i][j].y);
#pragma unroll
      for (int i = 0; i < ILP; ++i)
        if (any[i]) mma16816(c[i], a[2 * j + 1], b[i][j].z, b[i][j].w);
    }
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      if (t0 + i >= ntile) break;
      float* col = raw + (t0 + i) * 8 + 2 * t;
      *reinterpret_cast<float2*>(col + g * RSX) =
          make_float2(c[i][0], c[i][1]);
      if (g == 0)
        *reinterpret_cast<float2*>(col + 8 * RSX) =
            make_float2(c[i][2], c[i][3]);
    }
  }
}

template <typename T>
struct Args {
  const T* gmap;
  const T* fmap1;
  const T* fmap2;
  const float* u;
  const float* v;
  T* out;
  int E, M, H1, W1, H2, W2;
  int r1_taps, r2_taps;  // taps of the staged regions (0: global loads)
  int region_bytes;      // shared bytes before the warps' raw buffers
};

// `edge` (corr_window.cuh) with both levels' B fragments read from the
// staged regions reg1 / reg2 of the edge's bin: the same geometry, loads
// per lane, mma sequence and Store, so the same outputs bit for bit. The
// edge fits both regions (bin_edge), so it never takes the slow path.
template <class S>
__device__ __forceinline__ void edge_staged(
    const Feat<__nv_bfloat16>& ft, const __nv_bfloat16* reg1, Rect r1,
    const __nv_bfloat16* reg2, Rect r2, int H1, int W1, int H2, int W2,
    float x1, float y1, float* __restrict__ raw, int lane,
    __nv_bfloat16* __restrict__ orow) {
  float* stage_f = raw + PP * RSB;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const Geom gm = level_geometry(x1, y1, l);
    dots_mma_staged<RSB>(ft.a, l == 0 ? reg1 : reg2, l == 0 ? r1.x : r2.x,
                    l == 0 ? r1.y : r2.y, l == 0 ? r1.w : r2.w,
                    l == 0 ? H1 : H2, l == 0 ? W1 : W2, gm.bx, gm.by, gm.bw,
                    gm.bh, raw, lane);
    __syncwarp();
    S::template level<__nv_bfloat16, RSB>(l, orow, raw, gm, lane, stage_f);
    __syncwarp();
  }
}

// Whether binned_kernel<T, S> stages the bins' taps (bf16 builds).
template <typename T, class S>
__host__ __device__ constexpr bool staged_build() {
  return CB_STAGE && std::is_same<T, __nv_bfloat16>::value;
}

// Floats of a warp's raw buffer (and Store stage) in binned_kernel: RSB rows
// for staged bin edges, K1's RAW for K1's routine.
template <typename T, class S>
__host__ __device__ constexpr int warp_area() {
  return (staged_build<T, S>() ? PP * RSB : RAW) + S::STAGE;
}

// The persistent blocks: work items from the counter, bin items first,
// then the residual list. A bin item: both levels' regions staged at once
// (bf16), then each warp runs its edges one after the other, the next
// edge's patch features and coords loaded while the current one runs.
// Residual items, float32 and the -DCB_STAGE=0 build run K1's `edge`.
template <typename T, class S>
__global__ void __launch_bounds__(BW * 32, 1)
binned_kernel(Args<T> p, Scratch s, Grid g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_item;
  constexpr bool staged = staged_build<T, S>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qi = lane < PP ? lane : PP - 1;
  // bin edges' raw buffers after the regions; K1's larger ones (residual
  // items) inside the regions, which those items do not use
  float* raw = reinterpret_cast<float*>(smem + p.region_bytes) +
               warp * warp_area<T, S>();
  float* raw_k1 = staged ? reinterpret_cast<float*>(smem) +
                               warp * (RAW + S::STAGE)
                         : raw;
  const int n_items = s.ctrl[0], n_res = s.ctrl[1], res0 = s.ctrl[3];
  const int n_all = n_items + (n_res + IE - 1) / IE;
  const size_t slot1 = (size_t)p.H1 * p.W1 * C, slot2 = (size_t)p.H2 * p.W2 * C;
  for (;;) {
    if (threadIdx.x == 0) s_item = atomicAdd(s.ctrl + 2, 1);
    __syncthreads();
    const int w = s_item;
    __syncthreads();
    if (w >= n_all) return;
    int4 it;
    int slot = 0;
    if (w < n_items) {
      it = s.items[w];
      slot = it.x / g.tiles();
    } else {  // residual edges
      it = make_int4(g.nbin(), res0 + (w - n_items) * IE,
                     min(IE, n_res - (w - n_items) * IE), 0);
    }
    if constexpr (staged) {
      if (w < n_items) {
        const Rect r1 = bin_rect(s.bbox + 8 * it.x);
        const Rect r2 = bin_rect(s.bbox + 8 * it.x + 4);
        __nv_bfloat16* reg1 = reinterpret_cast<__nv_bfloat16*>(smem);
        __nv_bfloat16* reg2 = reg1 + (size_t)p.r1_taps * C;
        stage(reg1, p.fmap1 + slot * slot1, p.W1, r1.x, r1.y, r1.w, r1.h);
        stage(reg2, p.fmap2 + slot * slot2, p.W2, r2.x, r2.y, r2.w, r2.h);
        asm volatile("cp.async.commit_group;\n" ::);
        // the first edge's features and coords load under the copies
        int e = warp < it.z ? s.perm[it.y + warp] : -1;
        Feat<T> ft;
        float x1 = 0.f, y1 = 0.f;
        if (e >= 0) {
          ft.load(p.gmap + ((size_t)s.meta[2 * e + 1] * p.M + e % p.M) * PP *
                               C, lane);
          x1 = p.u[(size_t)e * PP + qi];
          y1 = p.v[(size_t)e * PP + qi];
        }
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
        for (int idx = warp; idx < it.z; idx += BW) {
          const int en = idx + BW < it.z ? s.perm[it.y + idx + BW] : -1;
          Feat<T> fn;
          float xn = 0.f, yn = 0.f;
          if (en >= 0) {
            fn.load(p.gmap + ((size_t)s.meta[2 * en + 1] * p.M + en % p.M) *
                                 PP * C, lane);
            xn = p.u[(size_t)en * PP + qi];
            yn = p.v[(size_t)en * PP + qi];
          }
          edge_staged<S>(ft, reg1, r1, reg2, r2, p.H1, p.W1, p.H2, p.W2, x1,
                         y1, raw, lane, p.out + (size_t)e * S::NCOL);
          e = en; ft = fn; x1 = xn; y1 = yn;
        }
        __syncthreads();  // the next item's copies overwrite the regions
        continue;
      }
    }
    for (int idx = warp; idx < it.z; idx += BW) {  // K1's routine
      const int e = s.perm[it.y + idx];
      const int sl = s.meta[2 * e], gslot = s.meta[2 * e + 1];
      edge<T, S>(p.gmap + ((size_t)gslot * p.M + e % p.M) * PP * C,
                 p.fmap1 + sl * slot1, p.fmap2 + sl * slot2, p.H1, p.W1,
                 p.H2, p.W2, p.u + (size_t)e * PP, p.v + (size_t)e * PP,
                 raw_k1, lane, p.out + (size_t)e * S::NCOL);
    }
  }
}

// Shared bytes of binned_kernel: both levels' regions (bf16 staged
// builds; at least K1's raw buffers for the residual items) and the warps'
// raw buffers.
template <typename T, class S>
int smem_bytes(const Grid& g, Args<T>* a) {
  const bool staged = staged_build<T, S>();
  a->r1_taps = staged ? g.s1x * g.s1y : 0;
  a->r2_taps = staged ? g.s2x * g.s2y : 0;
  const int k1 = BW * (RAW + S::STAGE) * (int)sizeof(float);
  const int reg = (a->r1_taps + a->r2_taps) * C * (int)sizeof(T);
  a->region_bytes = staged ? (reg > k1 ? reg : k1) : 0;
  return a->region_bytes + BW * warp_area<T, S>() * (int)sizeof(float);
}

// The launch after the caller's key kernel: scan, scatter, binned_kernel.
// Returns the cudaError_t, or -1 when binned_kernel's shared memory does
// not fit a block (or the grid's box sides exceed CB_BMAX), -2 when no
// block fits an SM. (The device facts are function statics with internal
// linkage: a function with external linkage would share them with every
// build variant's library that a process loads.)
template <typename T, class S>
static int finish(const Args<T>& a0, const Scratch& s, const Grid& g,
                  cudaStream_t st) {
  Args<T> a = a0;
  const int bytes = smem_bytes<T, S>(g, &a);
  // device facts, read once (before any graph capture: the wrappers'
  // first call is eager)
  static int sms = 0, max_dyn = 0, blocks = 0, last_bytes = -1;
  if (sms == 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fa, binned_kernel<T, S>);
    if (err == cudaSuccess) {
      max_dyn = optin - (int)fa.sharedSizeBytes;
      err = cudaFuncSetAttribute(binned_kernel<T, S>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 max_dyn);
    }
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (bytes > max_dyn || g.b1 > BMAX || g.b2 > BMAX) return -1;
  if (bytes != last_bytes) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, binned_kernel<T, S>, BW * 32, bytes);
    if (err != cudaSuccess) return (int)err;
    if (blocks < 1) return -2;
    last_bytes = bytes;
  }
  const int nbin = g.nbin();
  bins_scan<<<1, 1024, 0, st>>>(s, nbin);
  bins_scatter<<<(a.E + 255) / 256, 256, 0, st>>>(s, a.E);
  binned_kernel<T, S><<<sms * blocks, BW * 32, bytes, st>>>(a, s, g);
  return (int)cudaGetLastError();
}

inline int start(const Scratch& s, const Grid& g, cudaStream_t st) {
  bins_init<<<(2 * g.nbin() + 255) / 256, 256, 0, st>>>(s, g.nbin());
  return (int)cudaGetLastError();
}

inline Grid grid_from(const int* gi) {
  Grid g;
  g.tsx = gi[0]; g.tsy = gi[1]; g.b1 = gi[2]; g.b2 = gi[3]; g.off = gi[4];
  g.ntx = gi[5]; g.nty = gi[6]; g.s1x = gi[7]; g.s1y = gi[8]; g.s2x = gi[9];
  g.s2y = gi[10]; g.mem = gi[11];
  return g;
}

}  // namespace corrbins
