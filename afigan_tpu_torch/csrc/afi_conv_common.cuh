// Direct 3x3 / stride-1 / zero-padded convolution over NHWC, shared by the
// AF-interpolator kernels (afi_conv3x3.cu, afi_upsample.cu).
//
// A block computes a tile of output pixels, 16 wide, for a group of output
// channels of one image (and, for the subpixel transposed conv, one output
// parity phase). The input channels are walked in chunks: each chunk's halo
// tile and its 9-tap weight slice are staged in shared memory, and the block
// accumulates in float32 registers. Two kernels:
//   float32   CUDA-core FMAs; an 8x16 tile x 32 channels, each thread a
//             4-pixel x 4-channel micro-tile (chunks of 16 channels, weights
//             (9, cin, cout)), one stage.
//   bfloat16  tensor cores through mma.sync m16n8k16 with float32
//             accumulation; weights are (9, cout, cin), k contiguous, the B
//             operand layout. Chunks go through a ring of shared-memory
//             stages filled by 16-byte cp.async (zero fill at the border and
//             past the last channel), so the loads of the next chunks are in
//             flight while the tensor cores work on this one; fragments are
//             read with ldmatrix from rows padded by 8 values (8 rows fall in
//             distinct banks). A warp owns 2 output rows (two m16 fragments)
//             x 32 channels (four n8 fragments) of one 16-channel k-step of
//             the chunk; a block is RG row pairs x NG channel groups x KG
//             k-steps of warps, picked on the host from the shapes alone
//             (t8 = 8x16 pixel tiles x images x phases):
//               0  4 x 2 x 1  8x16 px, 64 ch   cout > 32 on large maps
//               1  4 x 1 x 2  8x16 px, 32 ch   growth conv, t8 >= a wave (132);
//                                              cout > 32 on middle maps (t8 < 84)
//               2  4 x 1 x 4  8x16 px, 32 ch   growth conv, 24 < t8 < 132
//               3  2 x 1 x 4  4x16 px, 32 ch   cout > 32, t8 * ceil(cout/64) < 88
//               4  1 x 1 x 8  2x16 px, 32 ch   the smallest maps (t8 <= 4, or a
//                                              growth conv with t8 <= 24)
//               5  the warpgroup-MMA kernel below, 16x16 px, 128 ch: cout a
//                  multiple of 128 on large maps (t8 >= 84)
//             On a small map a block takes 32 output channels even of a wide
//             conv: there the weights are most of what a block loads, and
//             splitting them over more blocks fills more of the card.
//             With KG > 1 the warps of a tile split the input channels
//             and their partial sums are added through shared memory in a
//             fixed order (deterministic), so a growth conv (32 output
//             channels, up to 352 inputs) or a small map keeps 8 warps busy on
//             a serial chain a half or a quarter as long. Sources whose
//             channel counts or addresses are off 16 bytes (C = 100, odd
//             views) take an element-by-element loader into the same ring.
//             The epilogue handles channel pairs (bf16x2 loads and stores).
//
// The input is a VIRTUAL channel concatenation of up to 5 NHWC tensors
// (the residual dense block's [x, c1, c2, c3, c4]); the tile loader maps a
// channel index to its source, so the concatenation never exists in HBM.
// The ragged spatial / channel edges are masked here, in the kernel.
//
// Epilogue (float32): + bias, LeakyReLU(0.2), out = res1 + s1*v,
// out = res2 + s2*out, + bilinear x2 of a half-resolution skip tensor
// (half-pixel taps 0.25/0.75, edge clamp), then one store in T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace afi {

constexpr int TH = 8;     // output tile rows
constexpr int TW = 16;    // output tile cols
constexpr int TCO = 32;   // output channels per block
constexpr int MAX_SRC = 5;
constexpr int HALO = (TH + 2) * (TW + 2);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct ConvArgs {
  const void* src[MAX_SRC];  // NHWC (B, H, W, src_c[i]) each
  int src_c[MAX_SRC];
  int n_src;
  int cin;                   // sum of src_c
  const void* w;             // float32: (phases, 9, cin, cout); bf16: (phases, 9, cout, cin)
  const void* bias;          // (cout,) T or null
  const void* res1;          // like out, or null
  float s1;
  const void* res2;          // like out, or null
  float s2;
  const void* skip;          // (B, H/2, W/2, cout) or null
  void* out;
  int B, H, W, cout;         // H, W: the conv's (input == output) plane
  int leaky;
  int phases;                // 1: conv, out (B,H,W,cout); 4: subpixel
                             // transposed conv, out (B,2H,2W,cout)
  int vec;                   // bf16, set by launch_conv3x3: 16-byte copies
  int pair;                  // bf16, set by launch_conv3x3: cout is even
};

// The fused epilogue for output (b, oy, ox, o) of a block's phase.
template <typename T>
__device__ __forceinline__ void store_out(const ConvArgs& a, int b, int phase, int oy,
                                          int ox, int o, float v) {
  size_t pix;
  if (a.phases == 1) {
    pix = ((size_t)b * a.H + oy) * a.W + ox;
  } else {
    const int dy = phase / 2, dx = phase % 2;
    pix = ((size_t)b * 2 * a.H + 2 * oy + dy) * (2 * a.W) + 2 * ox + dx;
  }
  const T* bias = static_cast<const T*>(a.bias);
  const T* res1 = static_cast<const T*>(a.res1);
  const T* res2 = static_cast<const T*>(a.res2);
  const T* skip = static_cast<const T*>(a.skip);
  if (bias) v += to_f(bias[o]);
  if (a.leaky) v = v > 0.f ? v : 0.2f * v;
  const size_t idx = pix * a.cout + o;
  if (res1) v = to_f(res1[idx]) + a.s1 * v;
  if (res2) v = to_f(res2[idx]) + a.s2 * v;
  if (skip) {
    // bilinear x2, half-pixel centers: row 2i -> 0.25*g[i-1] + 0.75*g[i],
    // row 2i+1 -> 0.75*g[i] + 0.25*g[i+1]; indices clamp to the edge
    const int hs = a.H / 2, ws = a.W / 2;
    const int iy = oy >> 1, ix = ox >> 1;
    const int ya = (oy & 1) ? iy : max(iy - 1, 0);
    const int yb = (oy & 1) ? min(iy + 1, hs - 1) : iy;
    const int xa = (ox & 1) ? ix : max(ix - 1, 0);
    const int xb = (ox & 1) ? min(ix + 1, ws - 1) : ix;
    const float wya = (oy & 1) ? 0.75f : 0.25f, wyb = 1.f - wya;
    const float wxa = (ox & 1) ? 0.75f : 0.25f, wxb = 1.f - wxa;
    const T* sb = skip + (size_t)b * hs * ws * a.cout + o;
    v += wya * (wxa * to_f(sb[((size_t)ya * ws + xa) * a.cout]) +
                wxb * to_f(sb[((size_t)ya * ws + xb) * a.cout])) +
         wyb * (wxa * to_f(sb[((size_t)yb * ws + xa) * a.cout]) +
                wxb * to_f(sb[((size_t)yb * ws + xb) * a.cout]));
  }
  static_cast<T*>(a.out)[idx] = from_f<T>(v);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int CK = 16;    // input channels per shared-memory chunk
constexpr int NT = 256;   // threads per block

__global__ void __launch_bounds__(NT) conv3x3_f32_kernel(ConvArgs a) {
  __shared__ float in_s[CK][TH + 2][TW + 2];
  __shared__ __align__(16) float w_s[9][CK][TCO];

  const int tiles_w = (a.W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z / a.phases;
  const int phase = blockIdx.z % a.phases;

  const int t = threadIdx.x;
  const int cg = t % 8;            // 4 output channels: co0 + 4*cg ..
  const int pg = t / 8;            // 32 pixel groups of 4 along a row
  const int py = pg / 4;
  const int px0 = (pg % 4) * 4;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  const float* wt = static_cast<const float*>(a.w) + (size_t)phase * 9 * a.cin * a.cout;

  for (int c0 = 0; c0 < a.cin; c0 += CK) {
    for (int i = t; i < CK * HALO; i += NT) {
      const int ci = i % CK;
      const int pix = i / CK;
      const int ly = pix / (TW + 2), lx = pix % (TW + 2);
      const int gy = ty0 + ly - 1, gx = tx0 + lx - 1;
      const int c = c0 + ci;
      float v = 0.f;
      if (c < a.cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
        int s = 0, cl = c;
        while (cl >= a.src_c[s]) { cl -= a.src_c[s]; ++s; }
        const float* sp = static_cast<const float*>(a.src[s]);
        v = sp[(((size_t)b * a.H + gy) * a.W + gx) * a.src_c[s] + cl];
      }
      in_s[ci][ly][lx] = v;
    }
    for (int i = t; i < 9 * CK * TCO; i += NT) {
      const int co = i % TCO;
      const int ci = (i / TCO) % CK;
      const int tap = i / (TCO * CK);
      const int c = c0 + ci, o = co0 + co;
      float v = 0.f;
      if (c < a.cin && o < a.cout) v = wt[((size_t)tap * a.cin + c) * a.cout + o];
      w_s[tap][ci][co] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xin[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) xin[j] = in_s[ci][py + ky][px0 + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(&w_s[ky * 3 + kx][ci][cg * 4]);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float xv = xin[p + kx];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = ty0 + py;
  if (oy >= a.H) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ox = tx0 + px0 + p;
    if (ox >= a.W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = co0 + cg * 4 + j;
      if (o < a.cout) store_out<float>(a, b, phase, oy, ox, o, acc[p][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulation)
// ---------------------------------------------------------------------------

constexpr int HALO_W = TW + 2;

union Vec8 {
  uint4 u;
  uint16_t h[8];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Channels [c, c+8) of the virtual concatenation at flat pixel `pix`, as raw
// bf16 bits; zero past cin. One 16-byte load when the 8 channels lie in one
// source and are aligned, element by element otherwise.
__device__ __forceinline__ uint4 load8_src(const ConvArgs& a, size_t pix, int c) {
  int s = 0, cl = c;
  while (cl >= a.src_c[s]) { cl -= a.src_c[s]; ++s; }
  const uint16_t* sp = static_cast<const uint16_t*>(a.src[s]) + pix * a.src_c[s] + cl;
  if (cl + 8 <= a.src_c[s] && aligned16(sp)) return *reinterpret_cast<const uint4*>(sp);
  Vec8 r;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    r.h[e] = 0;
    if (c + e < a.cin) {
      while (cl >= a.src_c[s]) { cl -= a.src_c[s]; ++s; }
      r.h[e] = static_cast<const uint16_t*>(a.src[s])[pix * a.src_c[s] + cl];
      ++cl;
    }
  }
  return r.u;
}

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

// 16 bytes global -> shared; `bytes` (16 or 0) are copied, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The fused epilogue for the channel pair (o, o+1), o even, of a conv with an
// even cout: the arithmetic of store_out on both, bf16x2 loads and one store.
__device__ __forceinline__ void store_out2(const ConvArgs& a, int b, int phase, int oy,
                                           int ox, int o, float v0, float v1) {
  typedef __nv_bfloat162 B2;
  size_t pix;
  if (a.phases == 1) {
    pix = ((size_t)b * a.H + oy) * a.W + ox;
  } else {
    const int dy = phase / 2, dx = phase % 2;
    pix = ((size_t)b * 2 * a.H + 2 * oy + dy) * (2 * a.W) + 2 * ox + dx;
  }
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(a.bias);
  const __nv_bfloat16* res1 = static_cast<const __nv_bfloat16*>(a.res1);
  const __nv_bfloat16* res2 = static_cast<const __nv_bfloat16*>(a.res2);
  const __nv_bfloat16* skip = static_cast<const __nv_bfloat16*>(a.skip);
  if (bias) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const B2*>(bias + o));
    v0 += t.x;
    v1 += t.y;
  }
  if (a.leaky) {
    v0 = v0 > 0.f ? v0 : 0.2f * v0;
    v1 = v1 > 0.f ? v1 : 0.2f * v1;
  }
  const size_t idx = pix * a.cout + o;
  if (res1) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const B2*>(res1 + idx));
    v0 = t.x + a.s1 * v0;
    v1 = t.y + a.s1 * v1;
  }
  if (res2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const B2*>(res2 + idx));
    v0 = t.x + a.s2 * v0;
    v1 = t.y + a.s2 * v1;
  }
  if (skip) {
    const int hs = a.H / 2, ws = a.W / 2;
    const int iy = oy >> 1, ix = ox >> 1;
    const int ya = (oy & 1) ? iy : max(iy - 1, 0);
    const int yb = (oy & 1) ? min(iy + 1, hs - 1) : iy;
    const int xa = (ox & 1) ? ix : max(ix - 1, 0);
    const int xb = (ox & 1) ? min(ix + 1, ws - 1) : ix;
    const float wya = (oy & 1) ? 0.75f : 0.25f, wyb = 1.f - wya;
    const float wxa = (ox & 1) ? 0.75f : 0.25f, wxb = 1.f - wxa;
    const __nv_bfloat16* sb = skip + (size_t)b * hs * ws * a.cout + o;
    const float2 aa = __bfloat1622float2(
        *reinterpret_cast<const B2*>(sb + ((size_t)ya * ws + xa) * a.cout));
    const float2 ab = __bfloat1622float2(
        *reinterpret_cast<const B2*>(sb + ((size_t)ya * ws + xb) * a.cout));
    const float2 ba = __bfloat1622float2(
        *reinterpret_cast<const B2*>(sb + ((size_t)yb * ws + xa) * a.cout));
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const B2*>(sb + ((size_t)yb * ws + xb) * a.cout));
    v0 += wya * (wxa * aa.x + wxb * ab.x) + wyb * (wxa * ba.x + wxb * bb.x);
    v1 += wya * (wxa * aa.y + wxb * ab.y) + wyb * (wxa * ba.y + wxb * bb.y);
  }
  *reinterpret_cast<B2*>(static_cast<__nv_bfloat16*>(a.out) + idx) =
      __floats2bfloat162_rn(v0, v1);
}

// RG row pairs x NG groups of 32 output channels x KG k-steps of 16 input
// channels: the warps of a block. STAGES: depth of the shared-memory ring.
template <int RG, int NG, int KG, int STAGES>
struct MmaCfg {
  static constexpr int TH_ = 2 * RG;            // output rows of the tile
  static constexpr int NCO = 32 * NG;           // output channels of the block
  static constexpr int MK = 16 * KG;            // input channels per chunk
  static constexpr int KP = MK + 8;             // padded shared row
  static constexpr int THREADS = 32 * RG * NG * KG;
  static constexpr int HALO_PX = (TH_ + 2) * HALO_W;
  static constexpr int IN_ELEMS = HALO_PX * KP;
  static constexpr int STAGE_ELEMS = IN_ELEMS + 9 * NCO * KP;
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
  static_assert((KG - 1) * RG * NG * 32 * 32 * 4 <= SMEM_BYTES, "reduction scratch");
};

template <int RG, int NG, int KG, int STAGES>
__global__ void __launch_bounds__(32 * RG * NG * KG, RG * NG * KG <= 8 ? 2 : 1)
conv3x3_bf16_mma_kernel(ConvArgs a) {
  typedef MmaCfg<RG, NG, KG, STAGES> C;
  constexpr int KP = C::KP, NCO = C::NCO, MK = C::MK, NTHR = C::THREADS, KV = MK / 8;
  extern __shared__ __align__(16) uint16_t smem[];

  const int tiles_w = (a.W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * C::TH_;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * NCO;
  const int b = blockIdx.z / a.phases;
  const int phase = blockIdx.z % a.phases;

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int rg = warp % RG, ng = (warp / RG) % NG, kg = warp / (RG * NG);
  const int g = lane >> 2, q = lane & 3;  // fragment row group / column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  // a warp whose 32 channels lie past cout only helps with the loads
  const bool active = co0 + ng * 32 < a.cout;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const uint16_t* wt = static_cast<const uint16_t*>(a.w) + (size_t)phase * 9 * a.cout * a.cin;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load_chunk = [&](int c0, int stage) {
    uint16_t* in_s = smem + stage * C::STAGE_ELEMS;
    uint16_t* w_s = in_s + C::IN_ELEMS;
    for (int i = t; i < C::HALO_PX * KV; i += NTHR) {
      const int kv = i % KV, p = i / KV;
      const int gy = ty0 + p / HALO_W - 1, gx = tx0 + p % HALO_W - 1;
      const int c = c0 + kv * 8;
      const bool ok = c < a.cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const size_t pix = ((size_t)b * a.H + gy) * a.W + gx;
      uint16_t* dst = in_s + p * KP + kv * 8;
      if (a.vec) {
        const void* src = a.src[0];
        if (ok) {
          int s = 0, cl = c;
          while (cl >= a.src_c[s]) { cl -= a.src_c[s]; ++s; }
          src = static_cast<const uint16_t*>(a.src[s]) + pix * a.src_c[s] + cl;
        }
        cp_async16(dst, src, ok ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(dst) = ok ? load8_src(a, pix, c) : zero;
      }
    }
    if (a.vec && NTHR % (KV * NCO) == 0) {
      // a thread's weight row and 8-channel group are the same for every tap
      // and chunk: only the tap advances, by a constant stride
      constexpr int TAPS = NTHR / (KV * NCO);  // taps the block covers per pass
      const int kv = t % KV, n = (t / KV) % NCO;
      const int o = co0 + n, c = c0 + kv * 8;
      const bool ok = o < a.cout && c < a.cin;
      const size_t tap_stride = (size_t)a.cout * a.cin;
      const uint16_t* wp = wt + (size_t)o * a.cin + c;
      uint16_t* dst = w_s + n * KP + kv * 8;
      for (int tap = t / (KV * NCO); tap < 9; tap += TAPS)
        cp_async16(dst + tap * NCO * KP, ok ? wp + tap * tap_stride : wt, ok ? 16 : 0);
      return;
    }
    for (int i = t; i < 9 * NCO * KV; i += NTHR) {
      const int kv = i % KV, n = (i / KV) % NCO, tap = i / (KV * NCO);
      const int o = co0 + n, c = c0 + kv * 8;
      const bool ok = o < a.cout && c < a.cin;
      const uint16_t* wp = wt + ((size_t)tap * a.cout + o) * a.cin + c;
      uint16_t* dst = w_s + (tap * NCO + n) * KP + kv * 8;
      if (a.vec) {
        cp_async16(dst, ok ? wp : wt, ok ? 16 : 0);
      } else {
        Vec8 r;
        r.u = zero;
        if (ok) {
#pragma unroll
          for (int e = 0; e < 8; ++e) r.h[e] = c + e < a.cin ? wp[e] : 0;
        }
        *reinterpret_cast<uint4*>(dst) = r.u;
      }
    }
  };

  const int nchunks = (a.cin + MK - 1) / MK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s * MK, s);
    cp_async_commit();
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    // chunk ch has landed; every warp is done with the stage chunk ch-1 used
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = ch + STAGES - 1;
    if (nxt < nchunks) load_chunk(nxt * MK, nxt % STAGES);
    cp_async_commit();

    if (!active) continue;
    const uint16_t* in_s = smem + (ch % STAGES) * C::STAGE_ELEMS;
    const uint16_t* w_s = in_s + C::IN_ELEMS;
    const int k0 = kg * 16;
    // B: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
    const uint16_t* wl = w_s + (ng * 32 + (lm >> 1) * 8 + lr) * KP + k0 + (lm & 1) * 8;
    // A: matrices (px 0-7, k 0-7), (px 8-15, k 0-7), (px 0-7, k 8-15), (px 8-15, k 8-15)
    const uint16_t* al = in_s + (rg * 2 * HALO_W + (lm & 1) * 8 + lr) * KP + k0 + (lm >> 1) * 8;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, wl + (tap * NCO + np * 16) * KP);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // fragment row r <-> output pixel (rg*2 + i, r) of the tile, which
        // reads halo pixel (rg*2 + i + ky, r + kx)
        uint32_t af[4];
        ldmatrix_x4(af, al + ((i + ky) * HALO_W + kx) * KP);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }

  if (KG > 1) {
    // add the k-groups' partial sums in a fixed order, through the ring's memory
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    if (kg > 0) {
      float* mine = red + (size_t)(((kg - 1) * NG + ng) * RG + rg) * 32 * 32 + lane;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[((i * 4 + j) * 4 + e) * 32] = acc[i][j][e];
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int k = 1; k < KG; ++k) {
      const float* theirs = red + (size_t)(((k - 1) * NG + ng) * RG + rg) * 32 * 32 + lane;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += theirs[((i * 4 + j) * 4 + e) * 32];
    }
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oy = ty0 + rg * 2 + i;
    if (oy >= a.H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // accumulators 2h, 2h+1: row g + 8h, columns 2q, 2q+1
        const int ox = tx0 + g + 8 * h;
        const int o = co0 + ng * 32 + j * 8 + 2 * q;
        if (ox >= a.W || o >= a.cout) continue;
        if (a.pair) {
          store_out2(a, b, phase, oy, ox, o, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          store_out<__nv_bfloat16>(a, b, phase, oy, ox, o, acc[i][j][2 * h]);
          if (o + 1 < a.cout)
            store_out<__nv_bfloat16>(a, b, phase, oy, ox, o + 1, acc[i][j][2 * h + 1]);
        }
      }
  }
}

// (internal linkage: each library that includes this header opts its own
// copy of the kernel in, with its own flag)
template <int RG, int NG, int KG, int STAGES>
static int launch_mma(const ConvArgs& a, cudaStream_t stream) {
  typedef MmaCfg<RG, NG, KG, STAGES> C;
  auto kernel = conv3x3_bf16_mma_kernel<RG, NG, KG, STAGES>;
  static bool opted_in = false;  // once per instantiation: above the 48 KB default
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int tiles = ((a.H + C::TH_ - 1) / C::TH_) * ((a.W + TW - 1) / TW);
  const dim3 grid(tiles, (a.cout + C::NCO - 1) / C::NCO, a.B * a.phases);
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16, wide convs on large maps: warpgroup MMA (wgmma, sm_90a)
// ---------------------------------------------------------------------------
//
// The same direct conv and the same cp.async ring, with the product started
// by a warpgroup: a block is 4 warpgroups, each 4 output rows x 16 pixels
// (M = 64, one row a warp) x 128 output channels, so a block covers 16x16
// pixels x 128 channels and a weight slice fetched from L2 serves
// four times the outputs of tiling 0 (whose 4576 blocks of a 104x168
// transposed conv pull some 2.6 GB through L2). A comes from registers (the
// ldmatrix fragments of the halo tile, as above: a 64-row A tile taken from
// an 8x16 halo has no uniform row stride in shared memory); B, the chunk's
// (NB, 16) weight slice of one tap, is read by the tensor cores straight from
// shared memory through a matrix descriptor, so no B fragment passes through
// registers and each A fragment feeds NB/8 n8-columns. B is K-major without
// swizzle: 8x8 core matrices of 128 contiguous bytes, the two K halves of a
// row group 128 bytes apart (leading offset), row groups 256 apart (stride).

__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// writes made through the generic proxy (cp.async, st.shared) become visible
// to the async proxy that wgmma reads shared memory through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major, no swizzle: start address, leading (K) and stride (N) byte offsets
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo, int sbo) {
  uint64_t d = (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;
}

// 4 warpgroups (16 output rows, one a warp) x 128 output channels, a ring of
// 4 stages (210 KB): one block an SM.
struct WgCfg {
  static constexpr int NB = 128, NWG = 4, STAGES = 4;
  static constexpr int MK = 16, KP = MK + 8;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int TH_ = 4 * NWG;                 // output rows: one a warp
  static constexpr int HALO_PX = (TH_ + 2) * HALO_W;
  static constexpr int IN_ELEMS = HALO_PX * KP;
  static constexpr int W_TAP = NB * MK;               // one tap's (NB, 16) slice
  static constexpr int STAGE_ELEMS = IN_ELEMS + 9 * W_TAP;
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
  static_assert(IN_ELEMS % 8 == 0 && W_TAP % 8 == 0, "16-byte aligned weight slices");
};

__global__ void __launch_bounds__(WgCfg::THREADS, 1) conv3x3_bf16_wgmma_kernel(ConvArgs a) {
  typedef WgCfg C;
  constexpr int NB = C::NB, STAGES = C::STAGES;
  constexpr int KP = C::KP, MK = C::MK, NTHR = C::THREADS, KV = MK / 8;
  extern __shared__ __align__(16) uint16_t smem[];

  const int tiles_w = (a.W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * C::TH_;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * NB;
  const int b = blockIdx.z / a.phases;
  const int phase = blockIdx.z % a.phases;

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;  // warp = output row of the tile
  const int g = lane >> 2, q = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;

  const uint16_t* wt = static_cast<const uint16_t*>(a.w) + (size_t)phase * 9 * a.cout * a.cin;

  // 16-byte copies only: the launcher sends ragged sources to the mma.sync kernel
  auto load_chunk = [&](int c0, int stage) {
    uint16_t* in_s = smem + stage * C::STAGE_ELEMS;
    uint16_t* w_s = in_s + C::IN_ELEMS;
    for (int i = t; i < C::HALO_PX * KV; i += NTHR) {
      const int kv = i % KV, p = i / KV;
      const int gy = ty0 + p / HALO_W - 1, gx = tx0 + p % HALO_W - 1;
      const int c = c0 + kv * 8;
      const bool ok = c < a.cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const void* src = a.src[0];
      if (ok) {
        int s = 0, cl = c;
        while (cl >= a.src_c[s]) { cl -= a.src_c[s]; ++s; }
        src = static_cast<const uint16_t*>(a.src[s]) +
              (((size_t)b * a.H + gy) * a.W + gx) * a.src_c[s] + cl;
      }
      cp_async16(in_s + p * KP + kv * 8, src, ok ? 16 : 0);
    }
    // a thread's weight row and 8-channel group are the same for every tap
    // and chunk: only the tap advances, by a constant stride
    static_assert(NTHR % (KV * NB) == 0, "whole taps per pass");
    constexpr int TAPS = NTHR / (KV * NB);
    const int kv = t % KV, n = (t / KV) % NB;
    const int o = co0 + n, c = c0 + kv * 8;
    const bool ok = o < a.cout && c < a.cin;
    const size_t tap_stride = (size_t)a.cout * a.cin;
    const uint16_t* wp = wt + (size_t)o * a.cin + c;
    // core matrix (n / 8, kv): 128 bytes, row n % 8 at 16 bytes each
    uint16_t* dst = w_s + ((n >> 3) * 2 + kv) * 64 + (n & 7) * 8;
    for (int tap = t / (KV * NB); tap < 9; tap += TAPS)
      cp_async16(dst + tap * C::W_TAP, ok ? wp + tap * tap_stride : wt, ok ? 16 : 0);
  };

  const int nchunks = (a.cin + MK - 1) / MK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s * MK, s);
    cp_async_commit();
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // chunk ch has landed; the stage of chunk ch-1 is free (its wgmmas were waited for)
    const int nxt = ch + STAGES - 1;
    if (nxt < nchunks) load_chunk(nxt * MK, nxt % STAGES);
    cp_async_commit();

    const uint16_t* in_s = smem + (ch % STAGES) * C::STAGE_ELEMS;
    const uint16_t* w_s = in_s + C::IN_ELEMS;
    // A: matrices (px 0-7, k 0-7), (px 8-15, k 0-7), (px 0-7, k 8-15), (px 8-15, k 8-15)
    const uint16_t* al = in_s + (warp * HALO_W + (lm & 1) * 8 + lr) * KP + (lm >> 1) * 8;
    uint32_t af[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      ldmatrix_x4(af[tap], al + ((tap / 3) * HALO_W + tap % 3) * KP);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      wgmma_m64n128k16(acc, af[tap], wgmma_desc(w_s + tap * C::W_TAP, 128, 256));
    wgmma_commit();
    wgmma_wait<0>();
  }

  const int oy = ty0 + warp;
  if (oy >= a.H) return;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = tx0 + g + 8 * h;
      const int o = co0 + j * 8 + 2 * q;
      if (ox >= a.W || o >= a.cout) continue;
      store_out2(a, b, phase, oy, ox, o, acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
    }
}

static int launch_wgmma(const ConvArgs& a, cudaStream_t stream) {
  typedef WgCfg C;
  auto kernel = conv3x3_bf16_wgmma_kernel;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int tiles = ((a.H + C::TH_ - 1) / C::TH_) * ((a.W + TW - 1) / TW);
  const dim3 grid(tiles, (a.cout + C::NB - 1) / C::NB, a.B * a.phases);
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}


constexpr int WAVE = 132;  // the card's SMs

// dtype: 0 = float32, 1 = bfloat16. tiling: -1 picks the bf16 kernel's tiling
// from the shapes, 0.. forces one (tests and sweeps). Returns the
// cudaError_t of the launch.
static int launch_conv3x3(ConvArgs a, int dtype, int tiling, cudaStream_t stream) {
  if (dtype == 0) {
    const int tiles = ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
    const dim3 grid(tiles, (a.cout + TCO - 1) / TCO, a.B * a.phases);
    conv3x3_f32_kernel<<<grid, NT, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // 16-byte copies need every source's channel count a multiple of 8 and
  // every base aligned (then cin is a multiple of 8 and so is each weight row)
  a.vec = (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
  for (int i = 0; i < a.n_src; ++i)
    a.vec = a.vec && a.src_c[i] % 8 == 0 && (reinterpret_cast<uintptr_t>(a.src[i]) & 15) == 0;
  a.pair = a.cout % 2 == 0;
  if (tiling < 0) {
    // the tile by the problem, from the shapes alone (thresholds from a sweep
    // on the H100, tools/kernel_sweep.py): t8 counts the 8x16 pixel tiles
    const long t8 = (long)((a.H + 7) / 8) * ((a.W + TW - 1) / TW) * a.B * a.phases;
    if (a.cout <= 32)
      tiling = t8 >= WAVE ? 1 : (t8 > 24 ? 2 : 4);
    else if (t8 * ((a.cout + 63) / 64) < 88)
      tiling = t8 <= 4 ? 4 : 3;
    else if (t8 < 84)
      tiling = 1;
    else
      tiling = a.cout % 128 == 0 && a.vec && a.pair ? 5 : 0;
  }
  switch (tiling) {
    case 0: return launch_mma<4, 2, 1, 3>(a, stream);
    case 1: return launch_mma<4, 1, 2, 3>(a, stream);
    case 2: return launch_mma<4, 1, 4, 2>(a, stream);
    case 3: return launch_mma<2, 1, 4, 2>(a, stream);
    case 4: return launch_mma<1, 1, 8, 2>(a, stream);
    case 5:  // wgmma takes 16-byte copies and channel pairs only
      return a.vec && a.pair ? launch_wgmma(a, stream) : (int)cudaErrorInvalidValue;
  }
  return (int)cudaErrorInvalidValue;
}

// One conv over `n_src` sources with the fused epilogue: fills ConvArgs and
// launches. Shapes are the caller's to check.
struct Plane {
  int B, H, W;
  int dtype, tiling;
  cudaStream_t stream;
};

static int conv(const Plane& p, const void* const* srcs, const int* src_c, int n_src,
                const void* w, const void* bias, int cout, int leaky, const void* res1,
                float s1, const void* res2, float s2, const void* skip, void* out) {
  if (n_src < 1 || n_src > MAX_SRC) return (int)cudaErrorInvalidValue;
  ConvArgs a = {};
  for (int i = 0; i < n_src; ++i) {
    a.src[i] = srcs[i];
    a.src_c[i] = src_c[i];
    a.cin += src_c[i];
  }
  a.n_src = n_src;
  a.w = w;
  a.bias = bias;
  a.res1 = res1;
  a.s1 = s1;
  a.res2 = res2;
  a.s2 = s2;
  a.skip = skip;
  a.out = out;
  a.B = p.B;
  a.H = p.H;
  a.W = p.W;
  a.cout = cout;
  a.leaky = leaky;
  a.phases = 1;
  return launch_conv3x3(a, p.dtype, p.tiling, p.stream);
}

// The transposed conv as 4 phases: x (B, H, W, cin) -> out (B, 2H, 2W, cout).
static int deconv(const Plane& p, const void* x, int cin, const void* w_phases,
                  const void* bias, int cout, int leaky, void* out) {
  ConvArgs a = {};
  a.src[0] = x;
  a.src_c[0] = cin;
  a.n_src = 1;
  a.cin = cin;
  a.w = w_phases;
  a.bias = bias;
  a.out = out;
  a.B = p.B;
  a.H = p.H;
  a.W = p.W;
  a.cout = cout;
  a.leaky = leaky;
  a.phases = 4;
  return launch_conv3x3(a, p.dtype, p.tiling, p.stream);
}

}  // namespace afi
