// Multi-level ROIAlign by direct bilinear sampling, forward and backward
// (CUDA C++, sm_90a). The backward is described above roi_pool_bwd_kernel.
//
// Replaces: afigan_tpu/ops/pallas/roi_pool.py::fused_window_pool
// (_pool_kernel), driven by afigan_tpu/ops/roi_align.py::_pallas_pool_forward.
// On the TPU each ROI DMAs a (window x window x C) slab of a
// row-concatenated pyramid into VMEM and contracts it with two
// interpolation matrices on the MXU; ROIs whose samples fall outside the
// window need a second full-level pass (capped at 64 ROIs).
//
// Here nothing is copied: the kernel reads the FPN level maps in place.
// Level routing and the ROI's scale are computed outside (plain torch, as
// they are XLA code outside the Pallas kernel); the kernel takes per-level
// base pointers / heights / widths / scales and per-ROI level indices.
// Every sample is exact (no window, hence no overflow ROIs), with d2's
// border handling: a sample outside [-1, size] contributes zero, others
// clamp to the border.
//
// What bounds it on the H100: the gathers' latency and the float32 output
// (at C = 256 and P = 7 a ROI writes 50 KB and reads about as much, mostly
// from L2, since the taps of neighbouring bins overlap). The design:
// - One block per ROI and group of output rows (all P rows when the ROI's
//   work fills a block, fewer at P = 14), so that every SM holds several
//   blocks and many loads are in flight.
// - The pool is separable: the block first computes the S taps of each of
//   its rows (y) and of all P columns (x) into shared memory: low and high
//   index, the two weights, out of range. Coordinates use round-to-nearest
//   multiply / add / divide (no FMA contraction) in the order of the plain
//   version, so the float32 plain version stays comparable.
// - Threads run over (bin, vector of channels): 16-byte loads (8 bf16 or 4
//   float32 channels) and 16-byte float32 stores where C and the pointers
//   allow, one channel a thread otherwise (any C). The samples of a bin are
//   summed in the plain version's order (sy, then sx).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_LEVELS = 8;

struct PoolArgs {
  const void* lvl[MAX_LEVELS];  // (B, H_l, W_l, C) each
  int lh[MAX_LEVELS];
  int lw[MAX_LEVELS];
  float ls[MAX_LEVELS];         // spatial scale 1/stride
  const float* boxes;           // (N, 4) xyxy image coords, N = B*R
  const int* levels;            // (N,) level index
  float* out;                   // (N, P, P, C)
  int N, R, C, P, S, aligned;
  int rows;                     // output rows a block
};

// one tap along an axis: lo < 0 marks a sample outside [-1, size]
struct Tap {
  int lo, hi;
  float l, h;
};

__device__ __forceinline__ Tap make_tap(float v, int size) {
  Tap t;
  if (!(v >= -1.f && v <= (float)size)) {
    t.lo = -1;
    t.hi = 0;
    t.l = t.h = 0.f;
    return t;
  }
  v = fmaxf(v, 0.f);
  t.lo = min((int)floorf(v), size - 1);
  t.hi = min(t.lo + 1, size - 1);
  v = fminf(v, (float)(size - 1));
  t.l = __fsub_rn(v, (float)t.lo);
  t.h = 1.f - t.l;
  return t;
}

// A ROI along one axis of its level: its start and the bin's extent.
struct Axis {
  float c1, bin;
};

__device__ __forceinline__ Axis axis_frame(const float* bx, float sc, bool is_y, int P,
                                           int aligned) {
  const float off = aligned ? 0.5f : 0.f;
  Axis f;
  f.c1 = __fsub_rn(__fmul_rn(bx[is_y ? 1 : 0], sc), off);
  const float c2 = __fsub_rn(__fmul_rn(bx[is_y ? 3 : 2], sc), off);
  float ext = __fsub_rn(c2, f.c1);
  if (!aligned) ext = fmaxf(ext, 1.f);
  f.bin = __fdiv_rn(ext, (float)P);
  return f;
}

// sample s of bin q along an axis, in the plain version's order with
// round-to-nearest multiply / add / divide. Nondecreasing in q * S + s where
// the bin is not negative, nonincreasing otherwise: each step rounds a
// monotone function of the last.
__device__ __forceinline__ float sample_coord(Axis f, int q, int s, int S) {
  const float g = __fadd_rn((float)q, __fdiv_rn((float)s + 0.5f, (float)S));
  return __fadd_rn(f.c1, __fmul_rn(g, f.bin));
}

// The forward's S taps of each of a block's nrows output rows (y; row
// offsets in pixels) and of all P columns (x) into shared memory; the caller
// synchronises. The backward builds its taps from the same three functions.
__device__ __forceinline__ void fill_taps(Tap* ytap, Tap* xtap, const float* bx, float sc,
                                          int H, int W, int py0, int nrows, int P, int S,
                                          int aligned) {
  for (int j = threadIdx.x; j < (nrows + P) * S; j += blockDim.x) {
    const bool is_y = j < nrows * S;
    const int k = is_y ? j : j - nrows * S;
    const int q = k / S, s = k % S;
    const float v =
        sample_coord(axis_frame(bx, sc, is_y, P, aligned), is_y ? py0 + q : q, s, S);
    if (is_y) {
      Tap t = make_tap(v, H);
      if (t.lo >= 0) {  // row offsets in pixels
        t.lo *= W;
        t.hi *= W;
      }
      ytap[k] = t;
    } else {
      xtap[k] = make_tap(v, W);
    }
  }
}

template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* v) { v[0] = *p; }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
};

// grid N * ceil(P / rows); dynamic shared memory (rows + P) * S taps. S_ > 0
// fixes the sampling ratio at compile time (2, every config), so that the
// loads of a bin's S * S samples are unrolled and in flight together
template <typename T, int VEC, int S_>
__global__ void roi_pool_kernel(PoolArgs a) {
  extern __shared__ Tap taps[];
  const int groups = (a.P + a.rows - 1) / a.rows;
  const int n = blockIdx.x / groups;
  const int py0 = (blockIdx.x % groups) * a.rows;
  const int nrows = min(a.rows, a.P - py0);
  const int b = n / a.R;
  const int l = a.levels[n];
  const int H = a.lh[l], W = a.lw[l];
  const int C = a.C, P = a.P, S = S_ > 0 ? S_ : a.S;
  const float sc = a.ls[l];
  const T* f = static_cast<const T*>(a.lvl[l]) + (size_t)b * H * W * C;

  Tap* ytap = taps;              // (nrows, S)
  Tap* xtap = taps + a.rows * S;  // (P, S)
  fill_taps(ytap, xtap, a.boxes + 4 * (size_t)n, sc, H, W, py0, nrows, P, S, a.aligned);
  __syncthreads();

  const float inv = 1.f / (float)(S * S);
  const int nv = C / VEC;
  const int items = nrows * P * nv;
  float* out = a.out + ((size_t)n * P + py0) * P * C;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cv = it % nv;
    const int bin = it / nv;  // (row - py0) * P + column
    const int r = bin / P, q = bin % P;
    const T* fc = f + cv * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int sy = 0; sy < S; ++sy) {
      const Tap ty = ytap[r * S + sy];
#pragma unroll
      for (int sx = 0; sx < S; ++sx) {
        const Tap tx = xtap[q * S + sx];
        if (ty.lo < 0 || tx.lo < 0) continue;  // contributes zero
        float v1[VEC], v2[VEC], v3[VEC], v4[VEC];
        Vec<T, VEC>::load(fc + (size_t)(ty.lo + tx.lo) * C, v1);
        Vec<T, VEC>::load(fc + (size_t)(ty.lo + tx.hi) * C, v2);
        Vec<T, VEC>::load(fc + (size_t)(ty.hi + tx.lo) * C, v3);
        Vec<T, VEC>::load(fc + (size_t)(ty.hi + tx.hi) * C, v4);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] += ty.h * tx.h * v1[i] + ty.h * tx.l * v2[i] + ty.l * tx.h * v3[i] +
                    ty.l * tx.l * v4[i];
      }
    }
    float* o = out + (size_t)bin * C + cv * VEC;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(o + i) =
            make_float4(acc[i] * inv, acc[i + 1] * inv, acc[i + 2] * inv, acc[i + 3] * inv);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = acc[i] * inv;
    }
  }
}

template <typename T, int VEC>
int launch(const PoolArgs& a, int threads, cudaStream_t s) {
  const int groups = (a.P + a.rows - 1) / a.rows;
  const size_t smem = (size_t)(a.rows + a.P) * a.S * sizeof(Tap);
  if (a.S == 2)
    roi_pool_kernel<T, VEC, 2><<<a.N * groups, threads, smem, s>>>(a);
  else
    roi_pool_kernel<T, VEC, 0><<<a.N * groups, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: the adjoint of the pool with respect to the level maps.
//
// Replaces: afigan_tpu/ops/roi_align.py::_pallas_pool_bwd_dense (XLA code,
// the custom VJP of multilevel_roi_align_pallas): on the TPU a dense adjoint,
// Ay^T @ g @ Ax per ROI chunk accumulated over a (B, sumH, Wmax, C) float32
// canvas by two MXU products, with no scatter.
//
// Here every output element is gathered, never scattered. The pool is
// separable: ROI n adds to pixel (y, x) of its level
//   sum_{py, px} Ay[n][y][py] * Ax[n][x][px] * g[n, py, px, :],
// where Ay[n][y][py] sums, over the S samples of bin row py, the bilinear
// weight that the sample's tap puts on row y (h on lo, l on hi, both where lo
// == hi at the border; 0 for a sample outside [-1, size]) and carries 1/S^2;
// Ax likewise on columns. The taps are the forward's own (axis_frame,
// sample_coord, make_tap: the same __f*_rn order and border rules). Boxes get
// no gradient.
//
// What bounds it on the H100: the bytes. g is read (float32, 51 MB a call at
// the train step's box pool and as much at its mask pool) and every level's
// gradient is written once (95 MB in bf16 at p2-p5 of 2 x 832 x 1344 x 256,
// most of it zeros); the multiply-adds are about 8 C a non-empty sample. A
// scatter design made one float32 atomicAdd a tap and channel into a zeroed float32
// buffer of every level (190 MB, 205 M atomics a call) and cast it by a second
// launch: 33x its bound. The design:
// - A block owns a tile of th x tw pixels and cc channels of one image's
//   level and writes it once, in the level's dtype, zeros where no ROI
//   reaches: no atomics, no zero fill, no float32 buffer, no second launch.
// - It first scans the image's ROIs, one a thread: a ROI of its level whose
//   footprint (from the taps of its first and last sample along each axis:
//   the coordinates are monotone) meets the tile is a hit. Hits are compacted
//   into shared memory in index order (ballot, then a prefix over warps).
// - Per batch of up to BWD_BATCH hits a thread per hit, axis and bin builds
//   the bin's weight on each tile row and column it reaches (Ay, Ax) and the
//   range of bins that reach each row and column, in shared memory. Only the
//   bins that touch the tile are read: a ROI larger than the tile costs the
//   tile its share of bins.
// - A thread holds PXT pixels of one tile row and VEC channels in registers
//   (lanes over channels: g's rows are read as 16-byte vectors, coalesced).
//   One cursor walks the batch's hits in index order and each hit's bins by
//   py, then px; a bin's g is loaded once for the thread's pixels, BWD_LOADS
//   loads in flight across hits. Taps that meet on a pixel are summed in
//   registers, in an order that no split and no run changes: the same bits
//   for a finite g (a thread adds 0 * g for a bin that misses one of its
//   pixels; a NaN or Inf in g then reaches pixels the plain scatter leaves
//   at 0, where a non-finite gradient has already failed the step).
// - Coarse levels' blocks launch first: their tiles are reached by the most
//   ROIs and would otherwise form the launch's tail.
// The split (tile, channels) comes from tools/kernel_sweep.py roi_pool_bwd at
// the train step's two shapes; BWD_LOADS, the level order and the register
// cap from an A/B of those choices at the same shapes (PERF.md, row 1b).
// ---------------------------------------------------------------------------

constexpr int BWD_BATCH = 16;  // hits whose tables a block holds at once
constexpr int BWD_LOADS = 2;   // bins of g a thread loads at once

struct PoolBwdArgs {
  void* out[MAX_LEVELS];      // (B, H_l, W_l, C) gradient of each level, its dtype
  int lh[MAX_LEVELS];
  int lw[MAX_LEVELS];
  float ls[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];    // tiles along x of each level
  int first[MAX_LEVELS + 1];  // first block of each level in launch order; [n_levels] = grid
  int n_levels;
  const float* boxes;  // (N, 4)
  const int* levels;   // (N,)
  const float* g;      // (N, P, P, C) float32 gradient of the pool's output
  int R, C, P, S, aligned;
  int th, tw, cc, chunks;  // tile rows and columns, channels a block, ceil(C / cc)
};

template <int VEC>
__device__ __forceinline__ void load_g(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

template <typename TO, int VEC>
__device__ __forceinline__ void store_out(TO* o, const float* v) {
  if constexpr (VEC == 4 && sizeof(TO) == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 4) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(h);
  } else if constexpr (sizeof(TO) == 4) {
    o[0] = v[0];
  } else {
    o[0] = __float2bfloat16_rn(v[0]);
  }
}

// The rows (or columns) [lo, hi] of a level that a ROI's taps reach along one
// axis; false where none does. Taken from the taps of the first and the last
// sample, the extremes of the monotone coordinates: where the extreme sample
// lies outside [-1, size] the span reaches the border (a superset: a tile
// that gets no weight then sums zeros).
__device__ __forceinline__ bool axis_span(const float* bx, float sc, bool is_y, int size, int P,
                                          int S, int aligned, int& lo, int& hi) {
  const Axis f = axis_frame(bx, sc, is_y, P, aligned);
  const float va = sample_coord(f, 0, 0, S), vb = sample_coord(f, P - 1, S - 1, S);
  const float vmin = fminf(va, vb), vmax = fmaxf(va, vb);
  if (!(vmax >= -1.f) || !(vmin <= (float)size)) return false;  // also NaN
  const Tap t0 = make_tap(vmin, size), t1 = make_tap(vmax, size);
  lo = t0.lo >= 0 ? t0.lo : 0;
  hi = t1.lo >= 0 ? t1.hi : size - 1;
  return true;
}

// grid: per level, coarse levels first, B x tiles x chunks blocks (a coarse
// tile is reached by more ROIs: its blocks are the launch's longest, and
// start first); blockDim th * (tw / PXT) * (cc / VEC), at most BWD_THREADS,
// three blocks an SM (at most 85 registers a thread: 72-80 by ptxas, the
// 8-pixel vector instances spilling about 100 bytes)
constexpr int BWD_THREADS = 256;

template <typename TO, int VEC, int PXT>
__global__ void __launch_bounds__(BWD_THREADS, 3) roi_pool_bwd_kernel(PoolBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int order = 0;  // the level's place in the launch, coarse levels first
  while (order + 1 < a.n_levels && (int)blockIdx.x >= a.first[order + 1]) ++order;
  const int l = a.n_levels - 1 - order;
  const int H = a.lh[l], W = a.lw[l];
  const int C = a.C, P = a.P, S = a.S, th = a.th, tw = a.tw;
  const float sc = a.ls[l];
  int local = blockIdx.x - a.first[order];
  const int chunk = local % a.chunks;
  local /= a.chunks;
  const int tiles = ((H + th - 1) / th) * a.tiles_x[l];
  const int b = local / tiles, tile = local % tiles;
  const int y0 = tile / a.tiles_x[l] * th, x0 = tile % a.tiles_x[l] * tw;

  const int nt = th + tw;
  int2* span = reinterpret_cast<int2*>(smem);                  // (BATCH, th + tw)
  float* wt = reinterpret_cast<float*>(span + BWD_BATCH * nt);  // (BATCH, th + tw, P)
  int* hits = reinterpret_cast<int*>(wt + BWD_BATCH * nt * P);  // (blockDim)
  int* wcount = hits + blockDim.x;                              // (warps)

  // this thread's channels and pixels
  const int nv = a.cc / VEC, segs = tw / PXT;
  const int cv = threadIdx.x % nv;
  const int row = threadIdx.x / nv / segs, xs0 = threadIdx.x / nv % segs * PXT;
  const int c = chunk * a.cc + cv * VEC;
  const bool live = c < C;
  float acc[PXT][VEC];
#pragma unroll
  for (int p = 0; p < PXT; ++p)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[p][i] = 0.f;

  const float inv = 1.f / (float)(S * S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int base = 0; base < a.R; base += blockDim.x) {
    // 1. the hits of this round of ROIs, in index order
    const int r = base + threadIdx.x;
    bool hit = false;
    if (r < a.R) {
      const int n = b * a.R + r;
      const float* bx = a.boxes + 4 * (size_t)n;
      int lo, hi;
      hit = a.levels[n] == l && axis_span(bx, sc, true, H, P, S, a.aligned, lo, hi) &&
            lo < y0 + th && hi >= y0 && axis_span(bx, sc, false, W, P, S, a.aligned, lo, hi) &&
            lo < x0 + tw && hi >= x0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < warps; ++w) {
      const int k = wcount[w];
      off += w < warp ? k : 0;
      total += k;
    }
    if (hit) hits[off + __popc(m & ((1u << lane) - 1u))] = b * a.R + r;
    __syncthreads();

    for (int h0 = 0; h0 < total; h0 += BWD_BATCH) {
      const int nh = min(BWD_BATCH, total - h0);
      // 2. empty weight tables and bin ranges
      for (int j = threadIdx.x; j < nh * nt * P; j += blockDim.x) wt[j] = 0.f;
      for (int j = threadIdx.x; j < nh * nt; j += blockDim.x) span[j] = make_int2(P, -1);
      __syncthreads();
      // 3. a thread per hit, axis and bin: its S taps, and their weight on
      // each tile row (column) they reach, summed sample by sample (h on lo,
      // then l on hi); each row's (column's) range of bins with a weight
      for (int j = threadIdx.x; j < nh * 2 * P; j += blockDim.x) {
        const int hh = j / (2 * P), q = j % P;
        const bool is_y = (j / P) % 2 == 0;
        const int size = is_y ? H : W, pos0 = is_y ? y0 : x0, len = is_y ? th : tw;
        const Axis f = axis_frame(a.boxes + 4 * (size_t)hits[h0 + hh], sc, is_y, P, a.aligned);
        Tap tp[4];
        int lo = size, hi = -1;
        for (int k = 0; k < S; ++k) {
          const Tap t = make_tap(sample_coord(f, q, k, S), size);
          if (k < 4) tp[k] = t;
          if (t.lo >= 0) {
            lo = min(lo, t.lo);
            hi = max(hi, t.hi);
          }
        }
        lo = max(lo, pos0);
        hi = min(hi, pos0 + len - 1);
        const int base = hh * nt + (is_y ? 0 : th) - pos0;
        for (int pos = lo; pos <= hi; ++pos) {
          float w = 0.f;
          for (int k = 0; k < S; ++k) {
            const Tap t = k < 4 ? tp[k] : make_tap(sample_coord(f, q, k, S), size);
            if (t.lo < 0) continue;  // an empty sample adds nothing
            if (t.lo == pos) w += t.h;
            if (t.hi == pos) w += t.l;
          }
          if (is_y) w *= inv;
          if (w != 0.f) {
            wt[(size_t)(base + pos) * P + q] = w;
            atomicMin(&span[base + pos].x, q);  // shared memory; min and max
            atomicMax(&span[base + pos].y, q);  // do not depend on the order
          }
        }
      }
      __syncthreads();
      // 4. each thread's pixels, hit by hit, bin by bin (py, then px): a
      // bin's g is read once for all the thread's pixels (its weight is 0 on
      // those it misses: 0 * g, which leaves a sum's bits alone where g is
      // finite). One cursor walks the batch's (hit, bin) pairs so that
      // BWD_LOADS loads are in flight across hits; slots past the end add
      // 0 * 0
      if (live) {
        int hh = -1, py = 0, px = 0, yhi = -1, xlo = 0, xhi = -1;
        // the next hit from hh + 1 on that has a bin on this thread's pixels
        auto seek = [&]() {
          for (++hh; hh < nh; ++hh) {
            const int2 ry = span[hh * nt + row];
            int lo = P, hi = -1;
#pragma unroll
            for (int p = 0; p < PXT; ++p) {
              const int2 rx = span[hh * nt + th + xs0 + p];
              lo = min(lo, rx.x);
              hi = max(hi, rx.y);
            }
            if (ry.x <= ry.y && lo <= hi) {
              py = ry.x;
              yhi = ry.y;
              px = xlo = lo;
              xhi = hi;
              return;
            }
          }
        };
        seek();
        while (hh < nh) {
          float gv[BWD_LOADS][VEC], ay[BWD_LOADS];
          const float* wx[BWD_LOADS];
#pragma unroll
          for (int u = 0; u < BWD_LOADS; ++u) {
            if (hh < nh) {
              ay[u] = wt[(size_t)(hh * nt + row) * P + py];
              wx[u] = wt + (size_t)(hh * nt + th + xs0) * P + px;  // (PXT, P) from px
              load_g<VEC>(a.g + (((size_t)hits[h0 + hh] * P + py) * P + px) * C + c, gv[u]);
              if (++px > xhi) {
                px = xlo;
                if (++py > yhi) seek();
              }
            } else {
              ay[u] = 0.f;
              wx[u] = wt;
#pragma unroll
              for (int i = 0; i < VEC; ++i) gv[u][i] = 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < BWD_LOADS; ++u)
#pragma unroll
            for (int p = 0; p < PXT; ++p) {
              const float w = __fmul_rn(ay[u], wx[u][p * P]);
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[p][i] = __fmaf_rn(w, gv[u][i], acc[p][i]);
            }
        }
      }
      __syncthreads();  // the tables are rebuilt for the next batch
    }
    __syncthreads();  // hits and wcount are rewritten by the next round
  }

  // 5. the tile, once, in the level's dtype
  const int y = y0 + row;
  if (!live || y >= H) return;
  TO* o = static_cast<TO*>(a.out[l]) + (((size_t)b * H + y) * W + x0 + xs0) * C + c;
#pragma unroll
  for (int p = 0; p < PXT; ++p)
    if (x0 + xs0 + p < W) store_out<TO, VEC>(o + (size_t)p * C, acc[p]);
}

template <typename TO, int VEC, int PXT>
int launch_bwd(const PoolBwdArgs& a, int threads, size_t smem, cudaStream_t s) {
  auto kernel = roi_pool_bwd_kernel<TO, VEC, PXT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<a.first[a.n_levels], threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_bwd_dtype(const PoolBwdArgs& a, bool vector, int threads, size_t smem,
                     cudaStream_t s) {
  if (vector)
    return a.tw % 8 == 0 ? launch_bwd<TO, 4, 8>(a, threads, smem, s)
                         : launch_bwd<TO, 4, 4>(a, threads, smem, s);
  return a.tw % 8 == 0 ? launch_bwd<TO, 1, 8>(a, threads, smem, s)
                       : launch_bwd<TO, 1, 4>(a, threads, smem, s);
}

}  // namespace

// The pool's backward (B * R > 0: the wrapper launches nothing for no ROIs):
// one launch that writes every level's gradient whole. out: one buffer of the
// levels' dtype (dtype 0 float32, 1 bfloat16) holding each level's (B, H_l,
// W_l, C) at element offset level_off[l]; g: (B * R, P, P, C) float32. th, tw,
// cc (tile rows, tile columns that are a multiple of 4, channels a block) 0
// pick the split; a block has th * (tw / PXT) * (cc / VEC) threads, a multiple
// of 32 and at most 256 (PXT 8 where tw % 8 == 0, else 4; VEC 4 where C % 4
// == 0 and g and out are 16-byte aligned, else 1). Returns the launch's
// cudaError_t.
extern "C" int roi_pool_backward(void* out, const long long* level_off, const int* level_h,
                                 const int* level_w, const float* level_scale, int n_levels,
                                 const float* boxes, const int* levels, const float* g, int B,
                                 int R, int C, int P, int S, int aligned, int dtype, int th,
                                 int tw, int cc, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || B <= 0 || R <= 0 || P <= 0 || S <= 0 ||
      C <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool vector = C % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int VEC = vector ? 4 : 1;
  // 4 x 8 pixels and up to 64 channel vectors a block (256 channels, 256
  // threads, at C = 256 on the vector path), fewer where C has fewer (a
  // multiple of 8, so that a block is whole warps). Swept on the pool's
  // backward calls of one stage-3 train step (its own ROIs and gradients,
  // box and mask pools, bf16 and float32): the fastest of 34 splits, or
  // within the spread of its own two timings, at three of the four; 2.3-2.7 %
  // behind 2 x 4 x 256 at the float32 mask pool
  // (tools/kernel_sweep.py roi_pool_bwd; PERF.md, row 1b)
  if (th <= 0) th = 4;
  if (tw <= 0) tw = 8;
  if (cc <= 0) cc = VEC * std::min(64, ((C + VEC - 1) / VEC + 7) / 8 * 8);
  const int pxt = tw % 8 == 0 ? 8 : 4;
  if (tw % 4 || cc % VEC) return (int)cudaErrorInvalidValue;
  const int threads = th * (tw / pxt) * (cc / VEC);
  if (threads > BWD_THREADS || threads % 32) return (int)cudaErrorInvalidValue;
  PoolBwdArgs a = {};
  const size_t elt = dtype == 1 ? 2 : 4;
  a.first[0] = 0;
  a.chunks = (C + cc - 1) / cc;
  long long grid = 0;
  for (int i = 0; i < n_levels; ++i) {
    a.out[i] = static_cast<char*>(out) + level_off[i] * elt;
    a.lh[i] = level_h[i];
    a.lw[i] = level_w[i];
    a.ls[i] = level_scale[i];
    a.tiles_x[i] = (level_w[i] + tw - 1) / tw;
  }
  for (int order = 0; order < n_levels; ++order) {  // coarse levels first
    const int i = n_levels - 1 - order;
    grid += (long long)B * ((level_h[i] + th - 1) / th) * a.tiles_x[i] * a.chunks;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    a.first[order + 1] = (int)grid;
  }
  a.n_levels = n_levels;
  a.boxes = boxes;
  a.levels = levels;
  a.g = g;
  a.R = R;
  a.C = C;
  a.P = P;
  a.S = S;
  a.aligned = aligned;
  a.th = th;
  a.tw = tw;
  a.cc = cc;
  const size_t smem = (size_t)BWD_BATCH * (th + tw) * (sizeof(int2) + P * sizeof(float)) +
                      (size_t)(threads + 32) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_bwd_dtype<__nv_bfloat16>(a, vector, threads, smem, s)
                    : launch_bwd_dtype<float>(a, vector, threads, smem, s);
}

// dtype: 0 = float32, 1 = bfloat16 features. rows (output rows a block) and
// threads (a block) 0 pick them from the shapes. Returns the launch's
// cudaError_t.
extern "C" int roi_pool_forward(const void* const* level_ptrs, const int* level_h,
                                const int* level_w, const float* level_scale,
                                int n_levels, const float* boxes, const int* levels,
                                float* out, int N, int R, int C, int P, int S,
                                int aligned, int dtype, int rows, int threads,
                                void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || N <= 0 || P <= 0 || S <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  PoolArgs a = {};
  const int vec = dtype == 1 ? 8 : 4;
  bool vector = C % vec == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = 0; i < n_levels; ++i) {
    a.lvl[i] = level_ptrs[i];
    a.lh[i] = level_h[i];
    a.lw[i] = level_w[i];
    a.ls[i] = level_scale[i];
    vector = vector && reinterpret_cast<uintptr_t>(level_ptrs[i]) % 16 == 0;
  }
  a.boxes = boxes;
  a.levels = levels;
  a.out = out;
  a.N = N;
  a.R = R;
  a.C = C;
  a.P = P;
  a.S = S;
  a.aligned = aligned;
  // about 768 (bin, channel-vector) items a block: 4 of 7 rows of a ROI at
  // C = 256 in bf16, 2 of 14. The split moves a launch by under 10 % at the
  // main paths' shapes (tools/kernel_sweep.py roi_pool); more, larger blocks
  // (whole 14-row ROIs) lose up to 2x at P = 14
  const int per_row = P * (vector ? C / vec : C);
  if (threads <= 0) threads = 256;
  if (rows <= 0) rows = max(1, min(P, (768 + per_row - 1) / per_row));
  rows = min(rows, P);
  a.rows = rows;
  if (threads > 1024 || threads % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vector ? launch<float, 4>(a, threads, s) : launch<float, 1>(a, threads, s);
  } else if (dtype == 1) {
    return vector ? launch<__nv_bfloat16, 8>(a, threads, s)
                  : launch<__nv_bfloat16, 1>(a, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}
