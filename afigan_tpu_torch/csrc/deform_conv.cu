// (Modulated) deformable convolution's sampling and its adjoint (CUDA C++,
// sm_90a).
//
// Replaces no TPU kernel: afigan_tpu/ops/deform_conv.py::deform_conv2d is
// XLA code in the JAX package (four corner gathers and one einsum), and its
// gradient is XLA's autodiff of it. It was added because on the H100 the
// port's plain torch gather (ops/kernels/deform_conv.py::deform_im2col_plain)
// took most of the device time of a batch of the deformable ResNeSt-101
// cascade (PERF.md, row 9). The matrix product with the kernel stays outside
// the kernels (torch.matmul in float32, as the JAX einsum is left to XLA).
//
//   deform_im2col (forward), grid (pixel tiles, taps): for every output pixel
//   p = (b, oy, ox) and tap k = (ky, kx) the sample point
//     sy = (oy*stride - pad + ky*dil) + dy[p, k],  sx likewise with dx,
//   its floor (y0, x0) and fractions (ly, lx), the four corners read from
//   NHWC x as float32 (zero outside the map), the bilinear weights
//   (1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly*lx, times the modulation mask m[p, k]
//   if there is one; written to the float32 columns cols[p, k*C + c], whose
//   (tap, channel) order is weight.permute(2, 3, 1, 0).reshape(K*C, Cout)'s.
//   The arithmetic is the plain version's, in its order, with __f*_rn so
//   that no FMA contraction changes a rounding: the columns equal the plain
//   version's bit for bit.
//
//   deform_col2im (backward): from the columns' gradient g = grad_cols[p,
//   k*C + c] and gm = g * m (g without a mask), the same as jax.vjp of the
//   JAX function:
//     grad_x[corner] += gm * (corner's bilinear weight)
//     grad_off[p, 2k]   = sum_c gm * ((1-lx)(v10-v00) + lx(v11-v01))
//     grad_off[p, 2k+1] = sum_c gm * ((1-ly)(v01-v00) + ly(v11-v10))
//     grad_mask[p, k]   = sum_c g * (the unmasked sample)
//   with corners outside the map at zero value and no gradient. At an
//   integer coordinate floor gives ly = 0, so the derivative is the forward
//   difference, as JAX's floor (zero gradient) gives it; no border
//   convention of mmcv's.
//   One block per tile of 4x8 output pixels (TILE_H x TILE_W) of one image,
//   at all K taps, and a share of the channels (at least MIN_CHANNELS, 128;
//   the blocks of a tile, up to 8, form a thread block cluster). A block
//   first computes each (pixel, tap) pair's sample point and bins the
//   corners that fall inside its window (the cells that the tile's samples
//   reach at offsets within a HALO of 2 cells) and have a weight by cell,
//   with integer atomics on shared memory;
//   the corners inside the map but outside the window go on a list. Then,
//   16 channels at a time, it copies the pairs' column gradient and x's
//   window (zero outside the map) into shared memory with cp.async, and
//   (A) a thread a pair takes the dot products E of the pair's gradient
//   with its four corners' x; (B) the lanes of a window cell sum the shares
//   of the corners binned on it in registers and add them to x's gradient
//   with one 16-byte atomic per 4 channels (neighbouring tiles' windows
//   overlap only in their halos); (C) the listed corners read x in device
//   memory (loaded while the copies were in flight), add their E share and
//   their share of x's gradient directly. From E (the cluster's blocks
//   summed in rank order through distributed shared memory):
//     grad_off = m ((1-lx)(E10 - E00) + lx (E11 - E01)),
//                m ((1-ly)(E01 - E00) + ly (E11 - E10)),
//     grad_mask = sum of the bilinear weights times E,
//   each entry written once. x's gradient differs from the plain version's
//   scatter by float32 summation order, which also changes from run to run
//   (the bins fill in the atomics' order); a corner of weight 0 adds nothing.
//
// Offsets and mask are read through their element strides (the model passes
// pred[..., :18], a non-contiguous bf16 view of the offset predictor's
// output), as float32 or bfloat16; x contiguous NHWC, float32 or bfloat16.
//
// What bounds it on the H100: bytes. The forward writes the columns,
// B*Ho*Wo*K*C float32 (0.64 GB for the largest conv of a batch of the
// ResNeSt-101 at 832x1344) against 8 float32 operations an entry; x is read
// about K times, mostly from the 50 MB L2. A block of the forward covers a
// tile of pixels at one tap with 16-byte loads and stores over channels. The
// backward reads the columns' gradient once (the same size). Its atomics to
// device memory are one per window cell that received a share and 4
// channels (at most the window-to-tile ratio: 5.2 cells an output pixel at
// 4x8 with a halo of 2) instead of one per corner of every pair, 36 a cell.
// Shared-memory float atomics are compare-and-swap loops on this card, so
// the sum into the window is a gather over the binned corners instead; what
// is left bounds it by latency (a block's copies, then its sums, then a
// barrier, a chunk at a time, three blocks an SM). Fusing the product into
// the kernels or the tensor cores are later work.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct Geo {
  int B, H, W, C, Ho, Wo, kh, kw, stride, pad, dil;
};

// element strides (batch, row, column, channel) and type (0 float32, 1 bf16)
struct Strided {
  const void* p;
  long long sb, sy, sx, sc;
  int code;
};

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float ld(const Strided& t, int b, int y, int x, int c) {
  const long long i = b * t.sb + y * t.sy + x * t.sx + c * t.sc;
  return t.code ? __bfloat162float(static_cast<const __nv_bfloat16*>(t.p)[i])
                : static_cast<const float*>(t.p)[i];
}

// V elements of T from p, as float32; V > 1 is one 16- or 8-byte load
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (V == 1) {
    v[0] = tof(p[0]);
  } else if constexpr (V * sizeof(T) == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = tof(e[i]);
  } else {
    static_assert(V * sizeof(T) == 8, "8- or 16-byte vectors");
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = tof(e[i]);
  }
}

// the corner at element offset i of p, or zeros where it lies outside the map
template <typename T, int V>
__device__ __forceinline__ void corner(const T* __restrict__ p, bool inside, long long i,
                                       float* v) {
  if (inside) {
    load_vec<T, V>(p + i, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
  }
}

// The sample point of pixel (b, oy, ox) at tap k: corner (y0, x0), fractions
// and the four bilinear weights, as the plain version computes them.
struct Tap {
  int y0, x0;
  float ly, lx, hy, hx, w00, w01, w10, w11;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ Tap tap_at(const Geo& g, const Strided& off, int b, int oy, int ox,
                                      int k) {
  Tap t;
  const int ky = k / g.kw, kx = k % g.kw;
  const float by = (float)(oy * g.stride - g.pad + ky * g.dil);
  const float bx = (float)(ox * g.stride - g.pad + kx * g.dil);
  const float sy = __fadd_rn(by, ld(off, b, oy, ox, 2 * k));
  const float sx = __fadd_rn(bx, ld(off, b, oy, ox, 2 * k + 1));
  const float fy = floorf(sy), fx = floorf(sx);
  t.ly = __fsub_rn(sy, fy);
  t.lx = __fsub_rn(sx, fx);
  t.hy = __fsub_rn(1.f, t.ly);
  t.hx = __fsub_rn(1.f, t.lx);
  t.w00 = __fmul_rn(t.hy, t.hx);
  t.w01 = __fmul_rn(t.hy, t.lx);
  t.w10 = __fmul_rn(t.ly, t.hx);
  t.w11 = __fmul_rn(t.ly, t.lx);
  // clamped before the conversion (far-off or non-finite samples stay
  // outside the map): no corner's validity changes
  t.y0 = (int)fminf(fmaxf(fy, -2.f), (float)g.H);
  t.x0 = (int)fminf(fmaxf(fx, -2.f), (float)g.W);
  const bool iy0 = t.y0 >= 0 && t.y0 < g.H, iy1 = t.y0 + 1 >= 0 && t.y0 + 1 < g.H;
  const bool ix0 = t.x0 >= 0 && t.x0 < g.W, ix1 = t.x0 + 1 >= 0 && t.x0 + 1 < g.W;
  t.v00 = iy0 && ix0;
  t.v01 = iy0 && ix1;
  t.v10 = iy1 && ix0;
  t.v11 = iy1 && ix1;
  return t;
}

// grid (ceil(P / pix), K); each thread one V-vector of channels of one pixel
template <typename T, int V>
__global__ void deform_im2col_kernel(const T* __restrict__ x, Strided off, Strided mask,
                                     bool has_mask, float* __restrict__ cols, Geo g, int pix) {
  const int k = blockIdx.y;
  const int K = g.kh * g.kw;
  const int cg = g.C / V;
  const long long P = (long long)g.B * g.Ho * g.Wo;
  const long long p0 = (long long)blockIdx.x * pix;
  for (int i = threadIdx.x; i < pix * cg; i += blockDim.x) {
    const long long p = p0 + i / cg;
    if (p >= P) break;
    const int c = (i % cg) * V;
    const int ox = (int)(p % g.Wo);
    const long long r = p / g.Wo;
    const int oy = (int)(r % g.Ho), b = (int)(r / g.Ho);
    const Tap t = tap_at(g, off, b, oy, ox, k);
    const float m = has_mask ? ld(mask, b, oy, ox, k) : 1.f;
    float v00[V], v01[V], v10[V], v11[V];
    const T* img = x + (long long)b * g.H * g.W * g.C + c;
    corner<T, V>(img, t.v00, ((long long)t.y0 * g.W + t.x0) * g.C, v00);
    corner<T, V>(img, t.v01, ((long long)t.y0 * g.W + t.x0 + 1) * g.C, v01);
    corner<T, V>(img, t.v10, ((long long)(t.y0 + 1) * g.W + t.x0) * g.C, v10);
    corner<T, V>(img, t.v11, ((long long)(t.y0 + 1) * g.W + t.x0 + 1) * g.C, v11);
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float s = __fadd_rn(__fmul_rn(v00[j], t.w00), __fmul_rn(v01[j], t.w01));
      s = __fadd_rn(s, __fmul_rn(v10[j], t.w10));
      s = __fadd_rn(s, __fmul_rn(v11[j], t.w11));
      o[j] = has_mask ? __fmul_rn(s, m) : s;
    }
    float* dst = cols + p * ((long long)K * g.C) + (long long)k * g.C + c;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(dst + j) = make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = o[j];
    }
  }
}

// ---------------------------------------------------------------------------
// deform_col2im: one block per tile of TILE_H x TILE_W output pixels of one image and
// a share of the channels, at all K taps; a thread a (pixel, tap) pair, the
// channels 16 at a time.
// ---------------------------------------------------------------------------

constexpr int ADJ_THREADS = 288;  // at most: nine warps, a (pixel, tap) pair a thread
constexpr int TILE_H = 4, TILE_W = 8;  // output pixels a block: 4 rows of 8
// cells by which a tile's window reaches past its samples at zero offsets
constexpr int HALO = 2;
constexpr int MIN_CHANNELS = 128;  // channels a block at least
constexpr int CHUNK = 16;
constexpr int MAX_SPLIT = 8;  // blocks a tile at most, a cluster of them, by channels
constexpr int GS = CHUNK + 4;  // floats a pair's row of the staged gradient
constexpr int XS = CHUNK + 4;  // elements a cell of x's window
constexpr int NO_PIXEL = -0x40000000;  // tap slot of a pixel outside the map
constexpr int OUT_WIN = -1, OUT_MAP = -2;  // a corner's code: else its window cell

// the window of x's cells that a tile's samples reach with offsets within
// the halo: its origin (wy0, wx0) and size (wh, ww)
struct Window {
  int wy0, wx0, wh, ww;
};

__host__ __device__ __forceinline__ Window window_of(const Geo& g, int oy0, int ox0) {
  Window w;
  w.wy0 = oy0 * g.stride - g.pad - HALO;
  w.wx0 = ox0 * g.stride - g.pad - HALO;
  w.wh = (TILE_H - 1) * g.stride + (g.kh - 1) * g.dil + 2 + 2 * HALO;
  w.ww = (TILE_W - 1) * g.stride + (g.kw - 1) * g.dil + 2 + 2 * HALO;
  return w;
}

// 4 channels c.. of x at element offset i, as float32: one 8- or 16-byte load
// with VEC, else element by element up to C
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, long long i, int c, int C,
                                      float* v) {
  if constexpr (VEC) {
    load_vec<T, 4>(p + i, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < C ? tof(p[i + j]) : 0.f;
  }
}

// dst[j] += v[j] * w for the 4 channels: one 16-byte atomic (Hopper's float4
// atomicAdd on global memory) with VEC, else one a channel up to C
template <bool VEC>
__device__ __forceinline__ void add4_global(float* dst, const float* v, float w, int c, int C) {
  if constexpr (VEC) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0] * w, v[1] * w, v[2] * w, v[3] * w));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < C) atomicAdd(dst + j, v[j] * w);
  }
}

// an asynchronous copy of N (8 or 16) bytes into shared memory, or N zero
// bytes where `fill` is false (src is then not read)
template <int N>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* src, bool fill) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  const int n = fill ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

// dynamic shared memory of a block, in this order: per pair (ly, lx, m,
// the bits of its corners inside the map with a weight), float4; per pair its corners'
// codes (window cell, OUT_WIN or OUT_MAP), int4; a chunk's column
// gradient, [pair][GS] floats; x's window at a chunk, [cell][XS] of T;
// per pair its corner (y0, x0), int2; the corners inside the map and the
// window by cell, (pair, m * weight) as int2, 4 a pair at most; per pair the
// dot products of its column gradient with its four corners, 4 floats; the
// corners outside the window, (pair * 4 + corner), int, 4 a pair at most; the
// cells' first corner (cells + 1) and a fill cursor (cells), int
template <typename T>
__host__ __device__ __forceinline__ long long adj_smem(long long pairs, long long cells) {
  return pairs * (16 + 16 + GS * 4) + cells * XS * (long long)sizeof(T) + pairs * 8 +
         pairs * 4 * 8 + pairs * 16 + pairs * 4 * 4 + (2 * cells + 1) * 4;
}

// the threads of a block: the pairs split into as few rounds of at most
// ADJ_THREADS as will do, whole warps
__host__ __device__ __forceinline__ int adj_threads(int pairs) {
  const int rounds = (pairs + ADJ_THREADS - 1) / ADJ_THREADS;
  return ((pairs + rounds - 1) / rounds + 31) / 32 * 32;
}

// grid: B * tiles_y * tiles_x * split blocks of adj_threads(TILE_H * TILE_W * K), in
// clusters of the split blocks of a tile, each `cpb` channels (a multiple of
// CHUNK); spill (nullable): two counters, the corners inside the map that
// fell outside their block's window and all corners inside the map
template <typename T, bool VEC>
__global__ void __launch_bounds__(ADJ_THREADS, 3)
    deform_col2im_kernel(const T* __restrict__ x, Strided off, Strided mask, bool has_mask,
                         const float* __restrict__ gcols, float* __restrict__ gx,
                         float* __restrict__ goff, float* __restrict__ gmask, Geo g, int cpb,
                         unsigned long long* __restrict__ spill) {
  constexpr int th = TILE_H, tw = TILE_W;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_spilled, s_corners;
  __shared__ int s_nout;  // corners outside the window
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int K = g.kh * g.kw, C = g.C;
  const int ntx = (g.Wo + tw - 1) / tw, nty = (g.Ho + th - 1) / th;
  const int tile = blockIdx.x / split;
  const int tx = tile % ntx;
  const int rest = tile / ntx;
  const int ty = rest % nty, b = rest / nty;
  const int oy0 = ty * th, ox0 = tx * tw, tp = th * tw, pairs = tp * K;
  const Window win = window_of(g, oy0, ox0);
  const int cells = win.wh * win.ww;
  float4* lw = reinterpret_cast<float4*>(smem);
  int4* code = reinterpret_cast<int4*>(lw + pairs);
  float* gst = reinterpret_cast<float*>(code + pairs);
  T* xw = reinterpret_cast<T*>(gst + (long long)pairs * GS);
  int2* yx = reinterpret_cast<int2*>(xw + (long long)cells * XS);
  int2* ent = yx + pairs;
  float* acc = reinterpret_cast<float*>(ent + 4 * pairs);  // [4][pairs]
  int* outs = reinterpret_cast<int*>(acc + 4 * pairs);    // [4 * pairs]
  int* cstart = outs + 4 * pairs;                         // [cells + 1]
  int* cursor = cstart + cells + 1;                        // [cells]
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const long long img = (long long)b * g.H * g.W * C;

  // each pair's sample point and its corners' codes, once for all chunks
  if (tid == 0) {
    s_spilled = s_corners = 0u;
    s_nout = 0;
  }
  for (int i = tid; i < cells; i += nthreads) cursor[i] = 0;
  __syncthreads();
  unsigned spilled = 0u, corners = 0u;
  for (int q = tid; q < pairs; q += nthreads) {
    const int k = q / tp, pl = q % tp;
    const int oy = oy0 + pl / tw, ox = ox0 + pl % tw;
    acc[q] = acc[pairs + q] = acc[2 * pairs + q] = acc[3 * pairs + q] = 0.f;
    if (oy >= g.Ho || ox >= g.Wo) {
      yx[q] = make_int2(NO_PIXEL, NO_PIXEL);
      continue;
    }
    const Tap t = tap_at(g, off, b, oy, ox, k);
    yx[q] = make_int2(t.y0, t.x0);
    int cd[4], bits = 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int y = t.y0 + (n >> 1), xx = t.x0 + (n & 1);
      const int wy = y - win.wy0, wx = xx - win.wx0;
      const bool inmap = y >= 0 && y < g.H && xx >= 0 && xx < g.W;
      const bool inwin = wy >= 0 && wy < win.wh && wx >= 0 && wx < win.ww;
      const float w = __fmul_rn(n >> 1 ? t.ly : t.hy, n & 1 ? t.lx : t.hx);
      cd[n] = inwin ? wy * win.ww + wx : (inmap ? OUT_WIN : OUT_MAP);
      if (cd[n] == OUT_WIN) outs[atomicAdd(&s_nout, 1)] = q * 4 + n;
      bits |= (inmap && w != 0.f) << n;  // a corner of weight 0 adds nothing to x's gradient
      corners += rank == 0 && inmap;     // the same corners in every block of the split
      spilled += rank == 0 && inmap && !inwin;
      if (inmap && inwin && w != 0.f) atomicAdd(&cursor[cd[n]], 1);
    }
    code[q] = make_int4(cd[0], cd[1], cd[2], cd[3]);
    lw[q] = make_float4(t.ly, t.lx, has_mask ? ld(mask, b, oy, ox, k) : 1.f,
                        __int_as_float(bits));
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the bins' counts, a segment a lane
    const int seg = (cells + 31) / 32, lo = min(cells, lane * seg), hi = min(cells, lo + seg);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += cursor[i];
    int pre = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, pre, o);
      if (lane >= o) pre += v;
    }
    int at = pre - sum;
    for (int i = lo; i < hi; ++i) {
      const int n = cursor[i];
      cstart[i] = at;
      cursor[i] = at;
      at += n;
    }
    if (lane == 31) cstart[cells] = pre;
  }
  __syncthreads();
  for (int q = tid; q < pairs; q += nthreads) {  // the bins, in the atomics' order
    if (yx[q].x == NO_PIXEL) continue;
    const float4 l4 = lw[q];
    const int4 c4 = code[q];
    const int cd[4] = {c4.x, c4.y, c4.z, c4.w}, bits = __float_as_int(l4.w);
    const float hy = __fsub_rn(1.f, l4.x), hx = __fsub_rn(1.f, l4.y);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (cd[n] < 0 || !((bits >> n) & 1)) continue;  // binned: in the window and weighted
      const float w = __fmul_rn(n >> 1 ? l4.x : hy, n & 1 ? l4.y : hx);
      ent[atomicAdd(&cursor[cd[n]], 1)] = make_int2(q, __float_as_int(w * l4.z));
    }
  }

  // the block's channels [c_lo, c_hi), a chunk at a time: every pair's
  // column gradient and x's window (zero outside the map and past C) into
  // shared memory, asynchronously with VEC; meanwhile x at the corners
  // outside the window into registers, 4 lanes a corner
  const int c_lo = rank * cpb, c_hi = min(C, c_lo + cpb);
  const int nout = s_nout;
  for (int c0 = c_lo; c0 < c_hi; c0 += CHUNK) {
    float* gs = gst;
    T* xs = xw;
    if constexpr (VEC) {
      for (int i = tid; i < pairs * (CHUNK / 4); i += nthreads) {
        const int q = i / (CHUNK / 4), s4 = (i % (CHUNK / 4)) * 4, c = c0 + s4;
        const int k = q / tp, pl = q % tp;
        const int oy = oy0 + pl / tw, ox = ox0 + pl % tw;
        const bool in = c < C && oy < g.Ho && ox < g.Wo;
        const long long p = ((long long)b * g.Ho + oy) * g.Wo + ox;
        cp_async<16>(gs + q * GS + s4, in ? gcols + (p * K + k) * C + c : gcols, in);
      }
      for (int i = tid; i < cells * (CHUNK / 4); i += nthreads) {
        const int cell = i / (CHUNK / 4), s4 = (i % (CHUNK / 4)) * 4, c = c0 + s4;
        const int y = win.wy0 + cell / win.ww, xx = win.wx0 + cell % win.ww;
        const bool in = y >= 0 && y < g.H && xx >= 0 && xx < g.W && c < C;
        const T* src = in ? x + img + ((long long)y * g.W + xx) * C + c : x;
        cp_async<4 * sizeof(T)>(xs + cell * XS + s4, src, in);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    } else {
      for (int i = tid; i < pairs * CHUNK; i += nthreads) {
        const int q = i / CHUNK, c = c0 + i % CHUNK;
        const int k = q / tp, pl = q % tp;
        const int oy = oy0 + pl / tw, ox = ox0 + pl % tw;
        float v = 0.f;
        if (c < C && oy < g.Ho && ox < g.Wo) {
          const long long p = ((long long)b * g.Ho + oy) * g.Wo + ox;
          v = gcols[(p * K + k) * C + c];
        }
        gs[q * GS + i % CHUNK] = v;
      }
      for (int i = tid; i < cells * CHUNK; i += nthreads) {
        const int cell = i / CHUNK, c = c0 + i % CHUNK;
        const int y = win.wy0 + cell / win.ww, xx = win.wx0 + cell % win.ww;
        float v = 0.f;
        if (y >= 0 && y < g.H && xx >= 0 && xx < g.W && c < C)
          v = tof(x[img + ((long long)y * g.W + xx) * C + c]);
        if constexpr (sizeof(T) == 2)
          xs[cell * XS + i % CHUNK] = __float2bfloat16(v);  // the bf16 value itself: exact
        else
          xs[cell * XS + i % CHUNK] = v;
      }
    }
    // the first round of the outside corners: x into registers now
    float vo[4] = {0.f, 0.f, 0.f, 0.f};
    if (tid < nout * (CHUNK / 4)) {
      const int e = outs[tid / (CHUNK / 4)], q = e >> 2, n = e & 3;
      const int2 cy = yx[q];
      const int c = c0 + (tid % (CHUNK / 4)) * 4;
      const long long at = img + ((long long)(cy.x + (n >> 1)) * g.W + cy.y + (n & 1)) * C;
      if (c < C) load4<T, VEC>(x, at + c, c, C, vo);
    }
    if constexpr (VEC) asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();

    // A: a thread a pair, over the chunk's channels 4 at a time: the dot
    // products of the pair's column gradient with its four corners' x, from
    // which the offsets' and the mask's gradients follow (the corners outside
    // the window in the loop below)
    for (int q = tid; q < pairs; q += nthreads) {
      const int2 cy = yx[q];
      if (cy.x == NO_PIXEL) continue;
      const int4 c4 = code[q];
      const int cd[4] = {c4.x, c4.y, c4.z, c4.w};
      float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s4 = 0; s4 < CHUNK; s4 += 4) {
        if (c0 + s4 >= C) break;
        const float4 g4 = *reinterpret_cast<const float4*>(gs + q * GS + s4);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (cd[n] < 0) continue;  // outside the window: below; outside the map: zero
          float v[4];
          load_vec<T, 4>(xs + cd[n] * XS + s4, v);  // zero outside the map
          e[n] += g4.x * v[0] + g4.y * v[1] + g4.z * v[2] + g4.w * v[3];
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)  // this thread alone holds these sums
        if (cd[n] != OUT_WIN) acc[n * pairs + q] += e[n];
    }
    // B: a window cell's lanes, 4 channels each: the sum over the corners
    // binned on the cell, into x's gradient with one 16-byte atomic
    for (int i = tid; i < cells * (CHUNK / 4); i += nthreads) {
      const int cell = i / (CHUNK / 4), s4 = (i % (CHUNK / 4)) * 4, cc = c0 + s4;
      const int e0 = cstart[cell], e1 = cstart[cell + 1];
      if (e0 == e1 || cc >= C) continue;  // a bin holds corners inside the map only
      const int y = win.wy0 + cell / win.ww, xx = win.wx0 + cell % win.ww;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int e = e0; e < e1; ++e) {
        const int2 en = ent[e];
        const float w = __int_as_float(en.y);
        const float4 g4 = *reinterpret_cast<const float4*>(gs + en.x * GS + s4);
        a[0] += g4.x * w;
        a[1] += g4.y * w;
        a[2] += g4.z * w;
        a[3] += g4.w * w;
      }
      if (a[0] != 0.f || a[1] != 0.f || a[2] != 0.f || a[3] != 0.f)
        add4_global<VEC>(gx + img + ((long long)y * g.W + xx) * C + cc, a, 1.f, cc, C);
    }
    // the corners outside the window, CHUNK / 4 lanes a corner: their share of the
    // dot product and of x's gradient (a 16-byte atomic in device memory)
    for (int base = 0; base < nout * (CHUNK / 4); base += nthreads) {
      const int i = base + tid;
      const bool on = i < nout * (CHUNK / 4);
      float part = 0.f;
      int e = 0;
      if (on) {
        e = outs[i / (CHUNK / 4)];
        const int q = e >> 2, n = e & 3, s4 = (i % (CHUNK / 4)) * 4, c = c0 + s4;
        const int2 cy = yx[q];
        const long long at =
            img + ((long long)(cy.x + (n >> 1)) * g.W + cy.y + (n & 1)) * C;
        float v[4] = {vo[0], vo[1], vo[2], vo[3]};
        if (base > 0) {
          v[0] = v[1] = v[2] = v[3] = 0.f;
          if (c < C) load4<T, VEC>(x, at + c, c, C, v);
        }
        if (c < C) {
          const float4 g4 = *reinterpret_cast<const float4*>(gs + q * GS + s4);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
          part = gv[0] * v[0] + gv[1] * v[1] + gv[2] * v[2] + gv[3] * v[3];
          const float4 l4 = lw[q];
          const float hy = __fsub_rn(1.f, l4.x), hx = __fsub_rn(1.f, l4.y);
          const float w = __fmul_rn(n >> 1 ? l4.x : hy, n & 1 ? l4.y : hx);
          add4_global<VEC>(gx + at + c, gv, w * l4.z, c, C);
        }
      }
#pragma unroll
      for (int o = 1; o < CHUNK / 4; o <<= 1)  // the corner's lanes
        part += __shfl_xor_sync(FULL, part, o);
      if (on && i % (CHUNK / 4) == 0) acc[(e & 3) * pairs + (e >> 2)] += part;
    }
    __syncthreads();  // before the next chunk's copies overwrite the stage
  }

  // the offsets' and the mask's gradients from the dot products E (the split
  // blocks' sums added in rank order, through the cluster's shared memory),
  // each entry written once:
  //   d/dly = m ((1-lx)(E10 - E00) + lx (E11 - E01)),
  //   d/dlx = m ((1-ly)(E01 - E00) + ly (E11 - E10)),  d/dm = sum w E
  cluster.sync();
  for (int q = rank + split * tid; q < pairs; q += split * nthreads) {
    if (yx[q].x == NO_PIXEL) continue;
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < split; ++r) {
      const float* ra = cluster.map_shared_rank(acc, r);
#pragma unroll
      for (int n = 0; n < 4; ++n) e[n] += ra[n * pairs + q];
    }
    const float4 l4 = lw[q];
    const float ly = l4.x, lx = l4.y, m = l4.z;
    const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
    const int k = q / tp, pl = q % tp;
    const long long p = ((long long)b * g.Ho + oy0 + pl / tw) * g.Wo + ox0 + pl % tw;
    goff[p * 2 * K + 2 * k] = m * (hx * (e[2] - e[0]) + lx * (e[3] - e[1]));
    goff[p * 2 * K + 2 * k + 1] = m * (hy * (e[1] - e[0]) + ly * (e[3] - e[2]));
    if (has_mask)
      gmask[p * K + k] = __fmul_rn(hy, hx) * e[0] + __fmul_rn(hy, lx) * e[1] +
                         __fmul_rn(ly, hx) * e[2] + __fmul_rn(ly, lx) * e[3];
  }
  cluster.sync();  // no block leaves while another may still read its sums
  if (spill != nullptr) {
    if (corners) {
      atomicAdd(&s_spilled, spilled);
      atomicAdd(&s_corners, corners);
    }
    __syncthreads();
    if (tid == 0 && s_corners) {
      atomicAdd(spill, (unsigned long long)s_spilled);
      atomicAdd(spill + 1, (unsigned long long)s_corners);
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

Geo geo(int B, int H, int W, int C, int Ho, int Wo, int kh, int kw, int stride, int pad,
        int dil) {
  return Geo{B, H, W, C, Ho, Wo, kh, kw, stride, pad, dil};
}

template <typename T, int V>
int launch_im2col(const void* x, const Strided& off, const Strided& mask, bool has_mask,
                  float* cols, const Geo& g, cudaStream_t s) {
  const int cg = g.C / V;
  const int threads = 256;
  const int pix = cg >= threads ? 1 : threads / cg;
  const long long P = (long long)g.B * g.Ho * g.Wo;
  const long long blocks = (P + pix - 1) / pix;
  if (blocks > 2147483647LL || g.kh * g.kw > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)(g.kh * g.kw));
  deform_im2col_kernel<T, V><<<grid, threads, 0, s>>>(static_cast<const T*>(x), off, mask,
                                                      has_mask, cols, g, pix);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_col2im(const void* x, const Strided& off, const Strided& mask, bool has_mask,
                  const float* gcols, float* gx, float* goff, float* gmask, const Geo& g,
                  unsigned long long* spill, cudaStream_t s) {
  const long long pairs = (long long)TILE_H * TILE_W * g.kh * g.kw;
  const long long wh =
      (long long)(TILE_H - 1) * g.stride + (long long)(g.kh - 1) * g.dil + 2 + 2 * HALO;
  const long long ww =
      (long long)(TILE_W - 1) * g.stride + (long long)(g.kw - 1) * g.dil + 2 + 2 * HALO;
  const long long smem = adj_smem<T>(pairs, wh * ww);
  if (pairs > (1 << 20) || wh * ww > (1 << 20) || smem > 232448 - 64)
    return (int)cudaErrorInvalidValue;
  // the channels split over a cluster of blocks a tile: MIN_CHANNELS a
  // block, or an equal share of MAX_SPLIT blocks where that is more, in
  // whole chunks
  const int cpb =
      (max(MIN_CHANNELS, (g.C + MAX_SPLIT - 1) / MAX_SPLIT) + CHUNK - 1) / CHUNK * CHUNK;
  const int split = (g.C + cpb - 1) / cpb;
  const long long blocks =
      (long long)g.B * ((g.Ho + TILE_H - 1) / TILE_H) * ((g.Wo + TILE_W - 1) / TILE_W) * split;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(deform_col2im_kernel<T, VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(adj_threads((int)pairs), 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, deform_col2im_kernel<T, VEC>, static_cast<const T*>(x), off,
                         mask, has_mask, gcols, gx, goff, gmask, g, cpb, spill);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) contiguous, dtype code xc (0 float32, 1 bfloat16);
// offsets (B, Ho, Wo, 2K) through element strides os*, code oc; mask
// (B, Ho, Wo, K) through ms*, code mc, or null; cols (B*Ho*Wo, K*C) float32
// contiguous. Returns the launch's cudaError_t.
extern "C" int deform_im2col(const void* x, int xc, const void* off, long long osb,
                             long long osy, long long osx, long long osc, int oc,
                             const void* mask, long long msb, long long msy, long long msx,
                             long long msc, int mc, void* cols, int B, int H, int W, int C,
                             int Ho, int Wo, int kh, int kw, int stride, int pad, int dil,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0 || (xc != 0 && xc != 1) || (oc != 0 && oc != 1) ||
      (mc != 0 && mc != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g = geo(B, H, W, C, Ho, Wo, kh, kw, stride, pad, dil);
  const Strided o{off, osb, osy, osx, osc, oc};
  const Strided m{mask, msb, msy, msx, msc, mc};
  const bool hm = mask != nullptr;
  float* c = static_cast<float*>(cols);
  const bool vec = aligned16(x) && aligned16(cols);
  if (xc == 0) {
    if (vec && C % 4 == 0) return launch_im2col<float, 4>(x, o, m, hm, c, g, s);
    return launch_im2col<float, 1>(x, o, m, hm, c, g, s);
  }
  if (vec && C % 8 == 0) return launch_im2col<__nv_bfloat16, 8>(x, o, m, hm, c, g, s);
  return launch_im2col<__nv_bfloat16, 1>(x, o, m, hm, c, g, s);
}

// grad_cols (B*Ho*Wo, K*C) float32 contiguous; gx (B, H, W, C) float32
// contiguous, zero-filled by the caller (accumulated with atomics); goff
// (B, Ho, Wo, 2K) and gmask (B, Ho, Wo, K) float32 contiguous, every entry
// written (gmask only with a mask). spill (nullable): two uint64 counters
// that the launch adds to, the corners inside the map but outside their
// block's window, and all corners inside the map. The other arguments as
// deform_im2col's.
extern "C" int deform_col2im(const void* x, int xc, const void* off, long long osb,
                             long long osy, long long osx, long long osc, int oc,
                             const void* mask, long long msb, long long msy, long long msx,
                             long long msc, int mc, const void* grad_cols, void* gx,
                             void* goff, void* gmask, int B, int H, int W, int C, int Ho,
                             int Wo, int kh, int kw, int stride, int pad, int dil, void* spill,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0 || (xc != 0 && xc != 1) || (oc != 0 && oc != 1) ||
      (mc != 0 && mc != 1) || (mask != nullptr && gmask == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g = geo(B, H, W, C, Ho, Wo, kh, kw, stride, pad, dil);
  const Strided o{off, osb, osy, osx, osc, oc};
  const Strided m{mask, msb, msy, msx, msc, mc};
  const bool hm = mask != nullptr;
  const float* gc = static_cast<const float*>(grad_cols);
  float *x_ = static_cast<float*>(gx), *o_ = static_cast<float*>(goff),
        *m_ = static_cast<float*>(gmask);
  unsigned long long* sp = static_cast<unsigned long long*>(spill);
  // 4 channels a lane as one vector: C % 4 and 16-byte rows
  const bool vec = C % 4 == 0 && aligned16(grad_cols) && aligned16(x) && aligned16(gx);
  if (xc == 0) {
    if (vec) return launch_col2im<float, true>(x, o, m, hm, gc, x_, o_, m_, g, sp, s);
    return launch_col2im<float, false>(x, o, m, hm, gc, x_, o_, m_, g, sp, s);
  }
  if (vec) return launch_col2im<__nv_bfloat16, true>(x, o, m, hm, gc, x_, o_, m_, g, sp, s);
  return launch_col2im<__nv_bfloat16, false>(x, o, m, hm, gc, x_, o_, m_, g, sp, s);
}
