// Greedy non-maximum suppression on the device, with no host synchronisation
// (CUDA C++, sm_90a).
//
// Replaces: afigan_tpu_torch/ops/nms.py's blocked plain loop on CUDA tensors,
// the counterpart of afigan_tpu/ops/nms.py::nms_keep_mask. That is XLA code
// in the JAX package, not a Pallas kernel: on the TPU a while loop over
// 128-box blocks with a self-suppression fixpoint inside each. In PyTorch
// the same loop makes the host wait on the card once per block and once per
// fixpoint sweep (tens of milliseconds a batch).
//
// The fixpoint has one solution, greedy NMS in score order, and this file
// computes it directly, in two launches on the caller's stream:
//   1. nms_mask_kernel: for every valid box i of the sorted order, 64-bit
//      words over the later boxes j, bit set where IoU(i, j) > threshold. One
//      block of 64 threads per (row tile, column tile) of the upper triangle;
//      a row whose box is invalid is never written, since it is never read.
//   2. nms_reduce_kernel: one block per image walks the sorted boxes 64 at a
//      time. Warp 0 resolves a tile in registers from its diagonal words
//      (only the kept boxes are visited, __ffsll over the candidates), then
//      the whole block ORs the kept rows' words of the later tiles into the
//      removal words in shared memory. It stops at the last valid box and
//      once `stop_after` boxes are kept; keep entries it does not reach are 0.
// The IoU is computed in float32 in the order and rounding of
// ops/boxes.py::pairwise_iou (max/min, clamp at 0, w*h, (a1 + a2) - inter,
// inter / max(union, 1e-12), 0 where union <= 0), with __f*_rn so that no
// FMA contraction moves a box that sits at the threshold; max, min and the
// clamps propagate NaN as torch.maximum / torch.clamp do.
//
// What bounds it on the H100: the reduce is a chain of dependent steps, one
// per 64-box tile (a global load of the diagonal words, a walk over the kept
// boxes in registers, a block barrier): latency, on one SM per image. The
// mask is N^2/2 IoUs (12.5 M at N = 5000), a few microseconds of the card's
// arithmetic, and N^2/128 bytes written and read back (about 3 MB an image).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float tmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float iou(float ax1, float ay1, float ax2, float ay2,
                                     float bx1, float by1, float bx2, float by2) {
  const float w = clamp0(__fsub_rn(tmin(ax2, bx2), tmax(ax1, bx1)));
  const float h = clamp0(__fsub_rn(tmin(ay2, by2), tmax(ay1, by1)));
  const float inter = __fmul_rn(w, h);
  const float a1 = __fmul_rn(__fsub_rn(ax2, ax1), __fsub_rn(ay2, ay1));
  const float a2 = __fmul_rn(__fsub_rn(bx2, bx1), __fsub_rn(by2, by1));
  const float uni = __fsub_rn(__fadd_rn(a1, a2), inter);
  return uni > 0.f ? __fdiv_rn(inter, tmax(uni, 1e-12f)) : 0.f;
}

// grid (W, W, B), 64 threads: row tile blockIdx.y against column tile blockIdx.x
__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                const int64_t* __restrict__ order, float thr, int N, int W,
                                u64* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  __shared__ float col[64][4];
  const int64_t* ord = order + (size_t)b * N;
  const float* bx = boxes + (size_t)b * N * 4;
  const int t = threadIdx.x;
  const int j = cb * 64 + t;
  if (j < N) {
    const float* p = bx + 4 * ord[j];
    col[t][0] = p[0];
    col[t][1] = p[1];
    col[t][2] = p[2];
    col[t][3] = p[3];
  }
  __syncthreads();
  const int i = rb * 64 + t;
  if (i >= N) return;
  const int64_t oi = ord[i];
  if (!valid[(size_t)b * N + oi]) return;
  const float* p = bx + 4 * oi;
  const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
  const int end = min(64, N - cb * 64);
  u64 bits = 0;
  for (int k = (cb == rb) ? t + 1 : 0; k < end; ++k) {
    if (iou(x1, y1, x2, y2, col[k][0], col[k][1], col[k][2], col[k][3]) > thr)
      bits |= 1ull << k;
  }
  mask[((size_t)b * N + i) * W + cb] = bits;
}

// grid B, blockDim a multiple of 32 (>= 64); dynamic shared memory W words
__global__ void nms_reduce_kernel(const uint8_t* __restrict__ valid,
                                  const int64_t* __restrict__ order,
                                  const u64* __restrict__ mask, uint8_t* __restrict__ keep,
                                  int N, int W, int stop_after) {
  extern __shared__ u64 removed[];
  __shared__ int s_last, s_nk, s_stop;
  __shared__ int s_list[64];
  const int b = blockIdx.x;
  const int64_t* ord = order + (size_t)b * N;
  const uint8_t* val = valid + (size_t)b * N;
  const u64* m = mask + (size_t)b * N * W;
  uint8_t* kp = keep + (size_t)b * N;
  if (threadIdx.x == 0) {
    s_last = 0;
    s_stop = 0;
  }
  for (int w = threadIdx.x; w < W; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  // 1 + the last valid position of the sorted order: nothing after it is kept
  int last = 0;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    kp[j] = 0;
    if (val[ord[j]]) last = j + 1;
  }
  if (last) atomicMax(&s_last, last);
  __syncthreads();
  const int n_last = s_last;
  const int tiles = (n_last + 63) / 64;
  const int lane = threadIdx.x & 31;
  int kept = 0;  // warp 0's count
  for (int c = 0; c < tiles; ++c) {
    if (threadIdx.x < 32) {
      const int i0 = c * 64 + lane, i1 = i0 + 32;
      const bool v0 = i0 < n_last && val[ord[i0]];
      const bool v1 = i1 < n_last && val[ord[i1]];
      const u64 d0 = v0 ? m[(size_t)i0 * W + c] : 0ull;
      const u64 d1 = v1 ? m[(size_t)i1 * W + c] : 0ull;
      const u64 vbits = ((u64)__ballot_sync(FULL, v1) << 32) | (u64)__ballot_sync(FULL, v0);
      u64 cand = vbits & ~removed[c];
      u64 kbits = 0;
      int nk = 0, stop = 0;
      while (cand) {
        const int t = __ffsll((long long)cand) - 1;
        const u64 dt = __shfl_sync(FULL, t < 32 ? d0 : d1, t & 31);
        kbits |= 1ull << t;
        if (lane == 0) s_list[nk] = t;
        ++nk;
        cand &= cand - 1;  // t
        cand &= ~dt;       // the later boxes of this tile that t suppresses
        if (stop_after > 0 && kept + nk >= stop_after) {
          stop = 1;
          break;
        }
      }
      kept += nk;
      if ((kbits >> lane) & 1ull) kp[i0] = 1;
      if ((kbits >> (lane + 32)) & 1ull) kp[i1] = 1;
      if (lane == 0) {
        s_nk = nk;
        s_stop = stop;
      }
    }
    __syncthreads();
    if (s_stop) break;
    // the kept rows' words of the later tiles into the removal words
    const int nk = s_nk, span = tiles - c - 1;
    for (int it = threadIdx.x; it < nk * span; it += blockDim.x) {
      const int k = it / span, w = c + 1 + it % span;
      atomicOr(&removed[w], m[(size_t)(c * 64 + s_list[k]) * W + w]);
    }
    __syncthreads();
  }
}

}  // namespace

// boxes (B, N, 4) float32 in the caller's order; valid (B, N) bool; order
// (B, N) int64, the stable score-descending permutation of each image; mask
// scratch (B, N, ceil(N/64)) 64-bit words; keep (B, N) bool in sorted order.
// Returns the launches' cudaError_t.
extern "C" int nms_forward(const float* boxes, const uint8_t* valid, const int64_t* order,
                           float iou_threshold, int B, int N, int stop_after, void* mask,
                           uint8_t* keep, void* stream) {
  if (B <= 0 || N <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int W = (N + 63) / 64;
  if (W > 65535 || (size_t)W * 8 > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* m = static_cast<u64*>(mask);
  nms_mask_kernel<<<dim3(W, W, B), 64, 0, s>>>(boxes, valid, order, iou_threshold, N, W, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_reduce_kernel<<<B, 256, (size_t)W * 8, s>>>(valid, order, m, keep, N, W, stop_after);
  return (int)cudaGetLastError();
}
