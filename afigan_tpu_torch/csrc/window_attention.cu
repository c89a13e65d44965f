// Swin window attention: softmax(q k^T * scale + bias[h] (+ mask[w % NW])) v
// with the (N, N) scores kept in f32 and never written to device memory.
//
// Replaces afigan_tpu/ops/pallas/window_attention.py::fused_window_attention.
// Same arithmetic: scores accumulate in f32, the scale multiplies the f32
// scores (not q), the shifted-window mask row is the window index modulo NW
// with masked entries at -100, the probabilities are rounded to the model
// type before the product with v, and that product accumulates in f32.
//
// q, k, v and out are addressed through three element strides each (window,
// head, token; the head dimension is contiguous), so the caller passes views
// of the packed (BNW, N, 3, NH, D) output of the qkv linear and gets the
// result in the (BNW, N, NH, D) layout the projection reads: no copy on
// either side of the launch.
//
// Bound: at the Swin shapes the work is 4*N*N*32 operations per pair on
// 4*N*32 elements, about 144 operations per element: below the bf16
// tensor-core roofline's ridge (bytes bound there), above the f32 FMA
// ridge (operations bound in float32). Two kernels:
//
//   bfloat16  tensor cores (mma.sync m16n8k16, f32 accumulation), one block
//             per (window, head) (several windows of a head per block, to
//             keep the head's bias in L1, measured no faster on the H100).
//             K and V of the pair sit in shared memory as bf16 (rows padded
//             to 40 values: ldmatrix reads 8 rows in distinct banks), filled
//             by 16-byte cp.async, keys padded with zeros to a multiple of
//             16. A warp owns strips of 16 query rows: its whole score strip
//             (16 x N f32, 72 registers a thread at N = 144) stays in
//             registers, scale, bias and mask are added there, the row
//             maximum and sum go through the four lanes of a quad, the
//             probabilities are rounded to bf16 in registers and reused as
//             the A operand of the product with V (the accumulator layout of
//             one mma is the A layout of the next). V is the B operand
//             through ldmatrix.trans.
//   float32   CUDA-core FMAs, one block per (window, head); K and V in
//             shared memory as f32 (K rows padded to 33 floats). A warp takes
//             ROWS = 4 query rows at a time: lane l holds the scores of keys
//             l, l+32, ..., the probabilities go through a per-warp strip of
//             shared memory, and for the product with V lane l owns output
//             column l. Shared memory is 54 KB at N = 144: dynamic, opted in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 32;      // head dimension (every Swin stage)
constexpr int MAX_N = 160;

// element strides of a (window, head, token, D) view; D is contiguous
struct Strides {
    long long w, h, t;
};

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* out;
    Strides sq, sk, sv, so;
    const float* bias;  // (nh, n, n)
    const float* mask;  // (nw, n, n) or null
    int bnw, nh, n, nw;
    float scale;
};

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int ROWS = 4;    // query rows a warp takes per pass
constexpr int WARPS = 6;   // 36 passes at N = 144: 6 per warp
constexpr int KS = D + 1;  // padded K row
constexpr int MAX_KPL = MAX_N / 32;

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

template <int KPL>
__global__ void __launch_bounds__(WARPS * 32) window_attention_f32_kernel(Args a) {
    extern __shared__ __align__(16) float smem[];
    const int n = a.n;
    float* qs = smem;                         // [WARPS][D][ROWS]
    float* ps = qs + WARPS * ROWS * D;        // [WARPS][n][ROWS]
    float* vs = ps + (size_t)WARPS * n * ROWS;  // [n][D]
    float* ks = vs + (size_t)n * D;           // [n][KS]

    const int pair = blockIdx.x;  // window * nh + head
    const int win = pair / a.nh, head = pair % a.nh;
    const float* q = static_cast<const float*>(a.q) + win * a.sq.w + head * a.sq.h;
    const float* k = static_cast<const float*>(a.k) + win * a.sk.w + head * a.sk.h;
    const float* v = static_cast<const float*>(a.v) + win * a.sv.w + head * a.sv.h;
    float* out = static_cast<float*>(a.out) + win * a.so.w + head * a.so.h;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int e = tid; e < n * D; e += WARPS * 32) {
        const int j = e / D, d = e % D;
        ks[j * KS + d] = k[j * a.sk.t + d];
        vs[e] = v[j * a.sv.t + d];
    }
    __syncthreads();

    const float* bias_h = a.bias + (size_t)head * n * n;
    const float* mask_w = a.mask ? a.mask + (size_t)(win % a.nw) * n * n : nullptr;
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
            qw[lane * ROWS + r] = q[i * a.sq.t + lane];
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
                    float t = s[r][kk] * a.scale + brow[j];
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
                if (j < n) pw[j * ROWS + r] = s[r][kk] / sum;
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
            if (i0 + r < n) out[(i0 + r) * a.so.t + lane] = o[r];
        __syncwarp();  // qw and pw are rewritten by the next pass
    }
}

template <int KPL>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
    const size_t bytes = smem_floats(a.n) * sizeof(float);
    auto kernel = window_attention_f32_kernel<KPL>;
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
    }
    kernel<<<a.bnw * a.nh, WARPS * 32, bytes, stream>>>(a);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int SROW = D + 8;  // padded shared row of K and V, in bf16 values

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
    return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// KT: key tiles of 16 (the keys padded to 16 * KT >= n).
template <int KT>
__global__ void __launch_bounds__(128) window_attention_bf16_kernel(Args a) {
    constexpr int KP = 16 * KT;
    constexpr int NT = 2 * KT;  // score tiles of 8 keys
    __shared__ __align__(16) uint16_t ks[KP][SROW];
    __shared__ __align__(16) uint16_t vs[KP][SROW];

    const int n = a.n;
    const int head = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int g = lane >> 2, q2 = (lane & 3) * 2;  // fragment row, first column
    const int nstrips = (n + 15) / 16;
    const bool even = (n & 1) == 0;  // then a (row, even column) pair is 8-byte aligned
    const float* bias_h = a.bias + (size_t)head * n * n;
    const uint4 zero = make_uint4(0, 0, 0, 0);

    const int win = blockIdx.x;
    const uint16_t* kg = static_cast<const uint16_t*>(a.k) + win * a.sk.w + head * a.sk.h;
    const uint16_t* vg = static_cast<const uint16_t*>(a.v) + win * a.sv.w + head * a.sv.h;
    for (int c = tid; c < KP * (D / 8); c += blockDim.x) {
        const int j = c >> 2, part = (c & 3) * 8;
        if (j < n) {
            cp_async16(&ks[j][part], kg + j * a.sk.t + part);
            cp_async16(&vs[j][part], vg + j * a.sv.t + part);
        } else {  // padded keys: zeros, so that 0 * v stays 0
            *reinterpret_cast<uint4*>(&ks[j][part]) = zero;
            *reinterpret_cast<uint4*>(&vs[j][part]) = zero;
        }
    }
    cp_async_wait_all();
    __syncthreads();

    const uint16_t* qg = static_cast<const uint16_t*>(a.q) + win * a.sq.w + head * a.sq.h;
    uint16_t* og = static_cast<uint16_t*>(a.out) + win * a.so.w + head * a.so.h;
    const float* mask_w = a.mask ? a.mask + (size_t)(win % a.nw) * n * n : nullptr;

    for (int strip = warp; strip < nstrips; strip += nwarps) {
        const int r0 = strip * 16 + g, r1 = r0 + 8;
        // a query row past the end repeats row n-1 and is never stored
        const int rc0 = min(r0, n - 1), rc1 = min(r1, n - 1);
        uint32_t qf[2][4];
        {
            const uint16_t* q0 = qg + rc0 * a.sq.t + q2;
            const uint16_t* q1 = qg + rc1 * a.sq.t + q2;
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                qf[s][0] = __ldg(reinterpret_cast<const uint32_t*>(q0 + 16 * s));
                qf[s][1] = __ldg(reinterpret_cast<const uint32_t*>(q1 + 16 * s));
                qf[s][2] = __ldg(reinterpret_cast<const uint32_t*>(q0 + 16 * s + 8));
                qf[s][3] = __ldg(reinterpret_cast<const uint32_t*>(q1 + 16 * s + 8));
            }
        }

        // scores: 16 rows x KP keys, f32, in registers
        float s[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
            uint32_t b[4];  // keys 8t.., d 0-7 | 8-15 | 16-23 | 24-31
            ldmatrix_x4(b, &ks[8 * t + (lane & 7)][(lane >> 3) * 8]);
            mma_bf16(s[t], qf[0], b[0], b[1]);
            mma_bf16(s[t], qf[1], b[2], b[3]);
        }

        const float* b0 = bias_h + (size_t)rc0 * n;
        const float* b1 = bias_h + (size_t)rc1 * n;
        const float* m0 = mask_w ? mask_w + (size_t)rc0 * n : nullptr;
        const float* m1 = mask_w ? mask_w + (size_t)rc1 * n : nullptr;
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int col = 8 * t + q2;
            float ab[4] = {0.f, 0.f, 0.f, 0.f};  // bias
            float am[4] = {0.f, 0.f, 0.f, 0.f};  // mask
            if (even) {
                if (col < n) {
                    const float2 x0 = __ldg(reinterpret_cast<const float2*>(b0 + col));
                    const float2 x1 = __ldg(reinterpret_cast<const float2*>(b1 + col));
                    ab[0] = x0.x; ab[1] = x0.y; ab[2] = x1.x; ab[3] = x1.y;
                    if (mask_w) {
                        const float2 y0 = __ldg(reinterpret_cast<const float2*>(m0 + col));
                        const float2 y1 = __ldg(reinterpret_cast<const float2*>(m1 + col));
                        am[0] = y0.x; am[1] = y0.y; am[2] = y1.x; am[3] = y1.y;
                    }
                }
            } else {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if (col + e < n) {
                        ab[e] = __ldg(b0 + col + e);
                        ab[2 + e] = __ldg(b1 + col + e);
                        if (mask_w) {
                            am[e] = __ldg(m0 + col + e);
                            am[2 + e] = __ldg(m1 + col + e);
                        }
                    }
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)  // a padded key drops out of the maximum and the sum
                s[t][e] = col + (e & 1) < n ? (s[t][e] * a.scale + ab[e]) + am[e] : -INFINITY;
            mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
            mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            s[t][0] = __expf(s[t][0] - mx0);
            s[t][1] = __expf(s[t][1] - mx0);
            s[t][2] = __expf(s[t][2] - mx1);
            s[t][3] = __expf(s[t][3] - mx1);
            sum0 += s[t][0] + s[t][1];
            sum1 += s[t][2] + s[t][3];
        }
        const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);

        // probabilities rounded to bf16: the A operand of P v
        uint32_t p[NT][2];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            p[t][0] = pack_bf16(s[t][0] * inv0, s[t][1] * inv0);
            p[t][1] = pack_bf16(s[t][2] * inv1, s[t][3] * inv1);
        }

        float o[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
            const uint32_t af[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                                    p[2 * kk + 1][1]};
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                // keys 16kk.. (+8), d 16np.. | keys .., d 16np+8..
                uint32_t b[4];
                ldmatrix_x4_trans(b, &vs[16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                        [16 * np + (lane >> 4) * 8]);
                mma_bf16(o[2 * np], af, b[0], b[1]);
                mma_bf16(o[2 * np + 1], af, b[2], b[3]);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int d = 8 * j + q2;
            if (r0 < n)
                *reinterpret_cast<uint32_t*>(og + r0 * a.so.t + d) = pack_bf16(o[j][0], o[j][1]);
            if (r1 < n)
                *reinterpret_cast<uint32_t*>(og + r1 * a.so.t + d) = pack_bf16(o[j][2], o[j][3]);
        }
    }
}

template <int KT>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
    // warps: 4, 3 or 2, whichever leaves the fewest idle strip slots
    const int strips = (a.n + 15) / 16;
    int warps = 4, waste = 1 << 30;
    for (int w = 4; w >= 2; --w) {
        const int x = (strips + w - 1) / w * w - strips;
        if (x < waste) { waste = x; warps = w; }
    }
    const dim3 grid(a.bnw, a.nh);
    window_attention_bf16_kernel<KT><<<grid, warps * 32, 0, stream>>>(a);
    return cudaGetLastError();
}

cudaError_t dispatch_f32(const Args& a, cudaStream_t st) {
    switch ((a.n + 31) / 32) {
        case 1: return launch_f32<1>(a, st);
        case 2: return launch_f32<2>(a, st);
        case 3: return launch_f32<3>(a, st);
        case 4: return launch_f32<4>(a, st);
        case 5: return launch_f32<5>(a, st);
    }
    return cudaErrorInvalidValue;
}

cudaError_t dispatch_bf16(const Args& a, cudaStream_t st) {
    switch ((a.n + 15) / 16) {
        case 1: return launch_bf16<1>(a, st);
        case 2: return launch_bf16<2>(a, st);
        case 3: return launch_bf16<3>(a, st);
        case 4: return launch_bf16<4>(a, st);
        case 5: return launch_bf16<5>(a, st);
        case 6: return launch_bf16<6>(a, st);
        case 7: return launch_bf16<7>(a, st);
        case 8: return launch_bf16<8>(a, st);
        case 9: return launch_bf16<9>(a, st);
        case 10: return launch_bf16<10>(a, st);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: logical shape (bnw, nh, n, 32), float32 (dtype 0) or
// bfloat16 (1), each addressed as base + window * s[0] + head * s[1] +
// token * s[2] + d with element strides `strides` = [q(3), k(3), v(3),
// out(3)]; every base and every stride a multiple of 16 bytes. bias (nh, n,
// n) float32; mask (nw, n, n) float32 or null, nw dividing bnw. Returns the
// cudaError of the launch.
extern "C" int window_attention_forward(const void* q, const void* k, const void* v,
                                        const float* bias, const float* mask, void* out,
                                        const long long* strides, int bnw, int nh, int n,
                                        int d, int nw, float scale, int dtype, void* stream) {
    if (d != D || n < 1 || n > MAX_N || bnw < 1 || nh < 1)
        return (int)cudaErrorInvalidValue;
    if (mask && (nw < 1 || bnw % nw)) return (int)cudaErrorInvalidValue;
    Args a;
    a.q = q; a.k = k; a.v = v; a.out = out;
    a.sq = {strides[0], strides[1], strides[2]};
    a.sk = {strides[3], strides[4], strides[5]};
    a.sv = {strides[6], strides[7], strides[8]};
    a.so = {strides[9], strides[10], strides[11]};
    a.bias = bias; a.mask = mask;
    a.bnw = bnw; a.nh = nh; a.n = n; a.nw = nw; a.scale = scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)dispatch_f32(a, st);
    if (dtype == 1) return (int)dispatch_bf16(a, st);
    return (int)cudaErrorInvalidValue;
}
