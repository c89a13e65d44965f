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
//   deform_col2im (backward), one warp per (pixel, tap), lanes over the
//   channels: from the columns' gradient g = grad_cols[p, k*C + c] and
//   gm = g * m (g without a mask), the same as jax.vjp of the JAX function:
//     grad_x[corner] += gm * (corner's bilinear weight)   (float32 atomics
//                                                          into a scratch)
//     grad_off[p, 2k]   = sum_c gm * ((1-lx)(v10-v00) + lx(v11-v01))
//     grad_off[p, 2k+1] = sum_c gm * ((1-ly)(v01-v00) + ly(v11-v10))
//     grad_mask[p, k]   = sum_c g * (the unmasked sample)
//   with corners outside the map at zero value and no gradient. At an
//   integer coordinate floor gives ly = 0, so the derivative is the forward
//   difference, as JAX's floor (zero gradient) gives it; no border
//   convention of mmcv's. The atomics' order changes from run to run: grad_x
//   differs from the plain version's scatter by float32 summation order.
//
// Offsets and mask are read through their element strides (the model passes
// pred[..., :18], a non-contiguous bf16 view of the offset predictor's
// output), as float32 or bfloat16; x contiguous NHWC, float32 or bfloat16.
//
// What bounds it on the H100: bytes. The forward writes the columns,
// B*Ho*Wo*K*C float32 (0.64 GB for the largest conv of a batch of the
// ResNeSt-101 at 832x1344) against 8 float32 operations an entry; x is read
// about K times, mostly from the 50 MB L2. The backward reads the columns'
// gradient (the same size) and scatters into the float32 grad_x scratch with
// 4 atomics an entry, which are served by L2; where C allows, 16-byte ones
// (4 channels an atomic). A block of the forward covers
// a tile of pixels at one tap with 16-byte loads and stores over channels;
// fusing the product into the kernel or the tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// dst[j] += g[j] * w for the V channels: one 16-byte atomic (Hopper's float4
// atomicAdd on global memory) where V is 4, else one atomic a channel
template <int V>
__device__ __forceinline__ void scatter(float* dst, const float* g, float w) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(g[0] * w, g[1] * w, g[2] * w, g[3] * w));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) atomicAdd(dst + j, g[j] * w);
  }
}

// one warp per (pixel, tap); V channels a lane per step (float4 of the
// gradient, 8 or 16 bytes of x)
template <typename T, int V>
__global__ void deform_col2im_kernel(const T* __restrict__ x, Strided off, Strided mask,
                                     bool has_mask, const float* __restrict__ gcols,
                                     float* __restrict__ gx, float* __restrict__ goff,
                                     float* __restrict__ gmask, Geo g) {
  const int K = g.kh * g.kw;
  const long long P = (long long)g.B * g.Ho * g.Wo;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= P * K) return;  // whole warps
  const int k = (int)(w % K);
  const long long p = w / K;
  const int ox = (int)(p % g.Wo);
  const long long r = p / g.Wo;
  const int oy = (int)(r % g.Ho), b = (int)(r / g.Ho);
  const Tap t = tap_at(g, off, b, oy, ox, k);
  const float m = has_mask ? ld(mask, b, oy, ox, k) : 1.f;
  const long long img = (long long)b * g.H * g.W * g.C;
  const long long i00 = img + ((long long)t.y0 * g.W + t.x0) * g.C;
  const long long i01 = i00 + g.C;
  const long long i10 = i00 + (long long)g.W * g.C;
  const long long i11 = i10 + g.C;
  const float* gc = gcols + p * ((long long)K * g.C) + (long long)k * g.C;
  float ay = 0.f, ax = 0.f, am = 0.f;
  for (int c = lane * V; c < g.C; c += 32 * V) {
    float gv[V], v00[V], v01[V], v10[V], v11[V];
    load_vec<float, V>(gc + c, gv);
    corner<T, V>(x + c, t.v00, i00, v00);
    corner<T, V>(x + c, t.v01, i01, v01);
    corner<T, V>(x + c, t.v10, i10, v10);
    corner<T, V>(x + c, t.v11, i11, v11);
    float gm[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      gm[j] = gv[j] * m;
      ay += gm[j] * (t.hx * (v10[j] - v00[j]) + t.lx * (v11[j] - v01[j]));
      ax += gm[j] * (t.hy * (v01[j] - v00[j]) + t.ly * (v11[j] - v10[j]));
      if (has_mask)
        am += gv[j] * (v00[j] * t.w00 + v01[j] * t.w01 + v10[j] * t.w10 + v11[j] * t.w11);
    }
    if (t.v00) scatter<V>(gx + i00 + c, gm, t.w00);
    if (t.v01) scatter<V>(gx + i01 + c, gm, t.w01);
    if (t.v10) scatter<V>(gx + i10 + c, gm, t.w10);
    if (t.v11) scatter<V>(gx + i11 + c, gm, t.w11);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    ay += __shfl_down_sync(FULL, ay, s);
    ax += __shfl_down_sync(FULL, ax, s);
    am += __shfl_down_sync(FULL, am, s);
  }
  if (lane == 0) {
    goff[p * 2 * K + 2 * k] = ay;
    goff[p * 2 * K + 2 * k + 1] = ax;
    if (has_mask) gmask[p * K + k] = am;
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

template <typename T, int V>
int launch_col2im(const void* x, const Strided& off, const Strided& mask, bool has_mask,
                  const float* gcols, float* gx, float* goff, float* gmask, const Geo& g,
                  cudaStream_t s) {
  const int threads = 256;
  const long long warps = (long long)g.B * g.Ho * g.Wo * g.kh * g.kw;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  deform_col2im_kernel<T, V><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(x), off, mask, has_mask, gcols, gx, goff, gmask, g);
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
// written (gmask only with a mask). The other arguments as deform_im2col's.
extern "C" int deform_col2im(const void* x, int xc, const void* off, long long osb,
                             long long osy, long long osx, long long osc, int oc,
                             const void* mask, long long msb, long long msy, long long msx,
                             long long msc, int mc, const void* grad_cols, void* gx,
                             void* goff, void* gmask, int B, int H, int W, int C, int Ho,
                             int Wo, int kh, int kw, int stride, int pad, int dil,
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
  // float4 of the gradient needs C % 4 and 16-byte rows; x then 4 elements
  const bool vec = C % 4 == 0 && aligned16(grad_cols) && aligned16(x);
  if (xc == 0) {
    if (vec) return launch_col2im<float, 4>(x, o, m, hm, gc, x_, o_, m_, g, s);
    return launch_col2im<float, 1>(x, o, m, hm, gc, x_, o_, m_, g, s);
  }
  if (vec) return launch_col2im<__nv_bfloat16, 4>(x, o, m, hm, gc, x_, o_, m_, g, s);
  return launch_col2im<__nv_bfloat16, 1>(x, o, m, hm, gc, x_, o_, m_, g, s);
}
