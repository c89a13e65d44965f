// LayerNorm over the last axis: one warp per row, f32 statistics.
//
// Replaces afigan_tpu/ops/pallas/layer_norm.py::fused_layer_norm (Swin's
// LayerNorms). Same formula: mean and E[x^2] in f32,
// var = max(0, E[x^2] - mean^2), y = (x - mean) * (rsqrt(var + eps) * scale)
// + bias, written in the output type the caller names.
//
// Bound: bytes. Each row is read once from device memory and written once;
// the normalising pass re-reads the row its own warp just read (at most
// 12 KB), which L1 serves. Loads and stores are 16 bytes a lane where the
// row length allows it (every Swin width: 192..3072); any other length
// takes the scalar loops. Rows need no padding: the warp index is masked
// against the row count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // rows per block

template <typename T> struct Vec;  // elements per 16-byte load
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void load_vec(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        // a bf16 is the high half of the f32 with the same value
        f[2 * t] = __uint_as_float(w[t] << 16);
        f[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
#pragma unroll
    for (int t = 0; t < N; t += 4)
        *reinterpret_cast<float4*>(p + t) = make_float4(f[t], f[t + 1], f[t + 2], f[t + 3]);
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
    uint32_t w[N / 2];
#pragma unroll
    for (int t = 0; t < N / 2; ++t) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * t], f[2 * t + 1]);
        w[t] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (N == 8) {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const Tin* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, Tout* __restrict__ out,
                  int rows, int c, float eps, int vectorised) {
    constexpr int V = Vec<Tin>::N;
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const Tin* xr = x + (size_t)row * c;
    Tout* yr = out + (size_t)row * c;

    float sum = 0.f, sq = 0.f;
    if (vectorised) {
        for (int e = lane * V; e < c; e += 32 * V) {
            float f[V];
            load_vec(xr + e, f);
#pragma unroll
            for (int t = 0; t < V; ++t) {
                sum += f[t];
                sq += f[t] * f[t];
            }
        }
    } else {
        for (int e = lane; e < c; e += 32) {
            const float f = to_f(xr[e]);
            sum += f;
            sq += f * f;
        }
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float inv_c = 1.f / (float)c;
    const float mean = sum * inv_c;
    const float var = fmaxf(sq * inv_c - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);

    if (vectorised) {
        for (int e = lane * V; e < c; e += 32 * V) {
            float f[V], s[V], b[V];
            load_vec(xr + e, f);
#pragma unroll
            for (int t = 0; t < V; t += 4) {
                load_vec(scale + e + t, s + t);
                load_vec(bias + e + t, b + t);
            }
#pragma unroll
            for (int t = 0; t < V; ++t) f[t] = (f[t] - mean) * (rstd * s[t]) + b[t];
            store_vec<V>(yr + e, f);
        }
    } else {
        for (int e = lane; e < c; e += 32)
            store1(yr + e, (to_f(xr[e]) - mean) * (rstd * scale[e]) + bias[e]);
    }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* out,
                   int rows, int c, float eps, cudaStream_t stream) {
    const uintptr_t addr = (uintptr_t)x | (uintptr_t)out | (uintptr_t)scale | (uintptr_t)bias;
    const int vectorised = (c % Vec<Tin>::N == 0) && (addr % 16 == 0);
    const int blocks = (rows + WARPS - 1) / WARPS;
    layer_norm_kernel<Tin, Tout><<<blocks, WARPS * 32, 0, stream>>>(
        static_cast<const Tin*>(x), scale, bias, static_cast<Tout*>(out), rows, c, eps,
        vectorised);
    return cudaGetLastError();
}

}  // namespace

// x (rows, c) of in_dtype, scale and bias (c,) float32, out (rows, c) of
// out_dtype; dtype codes 0 = float32, 1 = bfloat16. Returns the cudaError
// of the launch.
extern "C" int layer_norm_forward(const void* x, const float* scale, const float* bias,
                                  void* out, int rows, int c, float eps, int in_dtype,
                                  int out_dtype, void* stream) {
    if (rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    using bf16 = __nv_bfloat16;
    cudaError_t err;
    if (in_dtype == 0 && out_dtype == 0)
        err = launch<float, float>(x, scale, bias, out, rows, c, eps, st);
    else if (in_dtype == 0 && out_dtype == 1)
        err = launch<float, bf16>(x, scale, bias, out, rows, c, eps, st);
    else if (in_dtype == 1 && out_dtype == 0)
        err = launch<bf16, float>(x, scale, bias, out, rows, c, eps, st);
    else if (in_dtype == 1 && out_dtype == 1)
        err = launch<bf16, bf16>(x, scale, bias, out, rows, c, eps, st);
    else
        return (int)cudaErrorInvalidValue;
    return (int)err;
}
