// Multi-level ROIAlign forward by direct bilinear sampling (CUDA C++, sm_90a).
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
  const float off = a.aligned ? 0.5f : 0.f;
  const float* bx = a.boxes + 4 * (size_t)n;
  for (int j = threadIdx.x; j < (nrows + P) * S; j += blockDim.x) {
    const bool is_y = j < nrows * S;
    const int k = is_y ? j : j - nrows * S;
    const int q = k / S, s = k % S;
    // the box's start and extent along this axis, and the bin's
    const float c1 = __fsub_rn(__fmul_rn(bx[is_y ? 1 : 0], sc), off);
    const float c2 = __fsub_rn(__fmul_rn(bx[is_y ? 3 : 2], sc), off);
    float ext = __fsub_rn(c2, c1);
    if (!a.aligned) ext = fmaxf(ext, 1.f);
    const float bin = __fdiv_rn(ext, (float)P);
    const float g = __fadd_rn((float)(is_y ? py0 + q : q), __fdiv_rn((float)s + 0.5f, (float)S));
    const float v = __fadd_rn(c1, __fmul_rn(g, bin));
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

}  // namespace

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
