// Swin window attention: softmax(q k^T * scale + bias[h] (+ mask[w % NW])) v
// with the (N, N) scores kept in f32 and never written to device memory.
//
// Replaces afigan_tpu/ops/pallas/window_attention.py::fused_window_attention.
// Same arithmetic: scores accumulate in f32, the scale multiplies the f32
// scores (not q), the shifted-window mask row is the window index modulo NW
// with masked entries at -100, the probabilities are rounded to the model
// type before the product with v, and that product accumulates in f32.
//
// One block per (window, head). K and V of the pair, (N, 32) each, sit in
// shared memory as f32 (K rows padded to 33 floats, so that lanes that hold
// different keys read different banks). A warp takes ROWS = 4 query rows at
// a time: lane l holds the scores of keys l, l+32, ... in registers (KPL of
// them, 5 at N = 144), the row maximum and sum go through warp shuffles, the
// rounded probabilities go to a per-warp strip of shared memory, and for
// the product with V lane l owns output column l (the head dimension is
// 32, a warp's width). Shared memory is 54 KB at N = 144, above the 48 KB
// default, so it is dynamic and opted in per launch.
//
// Bound: at the Swin shapes the work is 4*N*N*32 operations per pair on
// 4*N*32 elements, about 144 operations per element: below the bf16
// tensor-core roofline's ridge (bytes bound there), above the f32 FMA
// ridge (operations bound in float32). This kernel uses f32 FMAs for both
// types, four query rows per pass to reuse each shared-memory read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 32;      // head dimension (every Swin stage)
constexpr int ROWS = 4;    // query rows a warp takes per pass
constexpr int WARPS = 6;   // 36 passes at N = 144: 6 per warp
constexpr int KS = D + 1;  // padded K row
constexpr int MAX_KPL = 5; // N <= 160

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__host__ __device__ inline size_t smem_floats(int n) {
    return (size_t)WARPS * ROWS * D + (size_t)WARPS * n * ROWS + (size_t)n * D + (size_t)n * KS;
}

template <typename T, int KPL>
__global__ void __launch_bounds__(WARPS * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out,
                        int nh, int n, int nw, float scale) {
    extern __shared__ __align__(16) float smem[];
    float* qs = smem;                         // [WARPS][D][ROWS]
    float* ps = qs + WARPS * ROWS * D;        // [WARPS][n][ROWS]
    float* vs = ps + (size_t)WARPS * n * ROWS;  // [n][D]
    float* ks = vs + (size_t)n * D;           // [n][KS]

    const int pair = blockIdx.x;  // window * nh + head
    const int win = pair / nh, head = pair % nh;
    const size_t base = (size_t)pair * n * D;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int e = tid; e < n * D; e += WARPS * 32) {
        const int j = e / D, d = e % D;
        ks[j * KS + d] = to_f(k[base + e]);
        vs[e] = to_f(v[base + e]);
    }
    __syncthreads();

    const float* bias_h = bias + (size_t)head * n * n;
    const float* mask_w = mask ? mask + (size_t)(win % nw) * n * n : nullptr;
    float* qw = qs + warp * ROWS * D;
    float* pw = ps + (size_t)warp * n * ROWS;

    // the keys of this lane (clamped: a lane past the end reads key n-1 and
    // its score is dropped below)
    const float* kp[KPL];
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) kp[kk] = ks + min(lane + 32 * kk, n - 1) * KS;

    for (int i0 = warp * ROWS; i0 < n; i0 += WARPS * ROWS) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int i = min(i0 + r, n - 1);
            qw[lane * ROWS + r] = to_f(q[base + (size_t)i * D + lane]);
        }
        __syncwarp();

        float s[ROWS][KPL];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int kk = 0; kk < KPL; ++kk) s[r][kk] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            const float4 q4 = *reinterpret_cast<const float4*>(qw + d * ROWS);
#pragma unroll
            for (int kk = 0; kk < KPL; ++kk) {
                const float kv = kp[kk][d];
                s[0][kk] = fmaf(q4.x, kv, s[0][kk]);
                s[1][kk] = fmaf(q4.y, kv, s[1][kk]);
                s[2][kk] = fmaf(q4.z, kv, s[2][kk]);
                s[3][kk] = fmaf(q4.w, kv, s[3][kk]);
            }
        }

#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int i = min(i0 + r, n - 1);
            const float* brow = bias_h + (size_t)i * n;
            const float* mrow = mask_w ? mask_w + (size_t)i * n : nullptr;
            float mx = -INFINITY;
#pragma unroll
            for (int kk = 0; kk < KPL; ++kk) {
                const int j = lane + 32 * kk;
                if (j < n) {
                    float t = s[r][kk] * scale + brow[j];
                    if (mrow) t += mrow[j];
                    s[r][kk] = t;
                    mx = fmaxf(mx, t);
                }
            }
            mx = warp_max(mx);
            float sum = 0.f;
#pragma unroll
            for (int kk = 0; kk < KPL; ++kk) {
                const int j = lane + 32 * kk;
                const float e = j < n ? expf(s[r][kk] - mx) : 0.f;
                s[r][kk] = e;
                sum += e;
            }
            sum = warp_sum(sum);
#pragma unroll
            for (int kk = 0; kk < KPL; ++kk) {
                const int j = lane + 32 * kk;
                if (j < n) pw[j * ROWS + r] = to_f(from_f<T>(s[r][kk] / sum));
            }
        }
        __syncwarp();

        float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
            const float4 p4 = *reinterpret_cast<const float4*>(pw + j * ROWS);
            const float vv = vs[j * D + lane];
            o0 = fmaf(p4.x, vv, o0);
            o1 = fmaf(p4.y, vv, o1);
            o2 = fmaf(p4.z, vv, o2);
            o3 = fmaf(p4.w, vv, o3);
        }
        const float o[ROWS] = {o0, o1, o2, o3};
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
            if (i0 + r < n) out[base + (size_t)(i0 + r) * D + lane] = from_f<T>(o[r]);
        __syncwarp();  // qw and pw are rewritten by the next pass
    }
}

template <typename T, int KPL>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* mask, void* out, int pairs, int nh, int n, int nw,
                   float scale, cudaStream_t stream) {
    const size_t bytes = smem_floats(n) * sizeof(float);
    auto kernel = window_attention_kernel<T, KPL>;
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
    }
    kernel<<<pairs, WARPS * 32, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        mask, static_cast<T*>(out), nh, n, nw, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int kpl, const void* q, const void* k, const void* v, const float* bias,
                     const float* mask, void* out, int pairs, int nh, int n, int nw,
                     float scale, cudaStream_t st) {
    switch (kpl) {
        case 1: return launch<T, 1>(q, k, v, bias, mask, out, pairs, nh, n, nw, scale, st);
        case 2: return launch<T, 2>(q, k, v, bias, mask, out, pairs, nh, n, nw, scale, st);
        case 3: return launch<T, 3>(q, k, v, bias, mask, out, pairs, nh, n, nw, scale, st);
        case 4: return launch<T, 4>(q, k, v, bias, mask, out, pairs, nh, n, nw, scale, st);
        case 5: return launch<T, 5>(q, k, v, bias, mask, out, pairs, nh, n, nw, scale, st);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: (bnw, nh, n, 32) contiguous, float32 (dtype 0) or bfloat16
// (1); bias (nh, n, n) float32; mask (nw, n, n) float32 or null, nw dividing
// bnw. Returns the cudaError of the launch.
extern "C" int window_attention_forward(const void* q, const void* k, const void* v,
                                        const float* bias, const float* mask, void* out,
                                        int bnw, int nh, int n, int d, int nw, float scale,
                                        int dtype, void* stream) {
    if (d != D || n < 1 || n > 32 * MAX_KPL || bnw < 1 || nh < 1) return (int)cudaErrorInvalidValue;
    if (mask && (nw < 1 || bnw % nw)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int kpl = (n + 31) / 32;
    const int pairs = bnw * nh;
    cudaError_t err;
    if (dtype == 0)
        err = dispatch<float>(kpl, q, k, v, bias, mask, out, pairs, nh, n, nw, scale, st);
    else if (dtype == 1)
        err = dispatch<__nv_bfloat16>(kpl, q, k, v, bias, mask, out, pairs, nh, n, nw, scale, st);
    else
        return (int)cudaErrorInvalidValue;
    return (int)err;
}
