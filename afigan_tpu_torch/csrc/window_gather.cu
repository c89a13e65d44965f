// Per-ROI window extraction: a strided copy (CUDA C++, sm_90a).
//
// Replaces: afigan_tpu/ops/pallas/window_gather.py::gather_windows
// (_gather_kernel), the window extractor of
// afigan_tpu/ops/roi_align.py::multilevel_roi_align_windowed. On the TPU one
// grid step starts one DMA of a (window, window, C) region of the
// row-concatenated pyramid; Mosaic's tiling wants window % 8 == 0 and column
// starts that are multiples of 8, which the pooler pays for with 8 columns of
// slack. None of that carries over: any row and column start, any window,
// any C, float32 or bfloat16.
//
//   out[r, i, j, :] = concat[rows[r] + i, cols[r] + j, :]   0 <= i, j < window
//
// Row i of a window is ONE contiguous span of window * C elements of concat,
// so the work is R * window contiguous segments. One block per segment;
// its threads walk the segment with 16-byte loads and stores when C * elt
// is a multiple of 16 and both base pointers are 16-byte aligned, and
// element by element otherwise (C = 100, a view at an odd offset). The
// starts are read by the block itself (what scalar prefetch did on the TPU).
//
// What bounds it on the H100: bytes only. Every output byte is written once,
// R * window^2 * C * elt; of concat only the bytes under some window must
// come from device memory, once each: windows of neighbouring ROIs overlap
// and the repeats are served by the 50 MB L2. Starts outside the tensor are
// the caller's error (check_starts of the wrapper's module reads them on the
// host).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// V: the unit of one load/store (uint4 = 16 bytes, or one element).
// px: units per pixel (C * elt / sizeof(V)); row_units: units per row of concat.
template <typename V>
__global__ void window_gather_kernel(const V* __restrict__ src,
                                     const int* __restrict__ rows,
                                     const int* __restrict__ cols,
                                     V* __restrict__ dst, int window,
                                     long long row_units, long long px) {
  const long long seg_id = blockIdx.x;
  const int r = (int)(seg_id / window);
  const int i = (int)(seg_id % window);
  const long long seg = (long long)window * px;
  const V* s = src + ((long long)rows[r] + i) * row_units + (long long)cols[r] * px;
  V* d = dst + seg_id * seg;
  for (long long k = threadIdx.x; k < seg; k += blockDim.x) d[k] = s[k];
}

template <typename V>
int launch(const void* concat, const int* rows, const int* cols, void* out, int R,
           int window, long long row_bytes, long long px_bytes, cudaStream_t s) {
  const long long px = px_bytes / (long long)sizeof(V);
  const long long seg = (long long)window * px;
  int threads = 256;
  while (threads > 32 && threads / 2 >= seg) threads /= 2;
  const long long blocks = (long long)R * window;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  window_gather_kernel<V><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const V*>(concat), rows, cols, static_cast<V*>(out), window,
      row_bytes / (long long)sizeof(V), px);
  return (int)cudaGetLastError();
}

}  // namespace

// concat (sumH, wmax, C) contiguous, rows / cols (R,) int32 on the device,
// out (R, window, window, C) contiguous; elt = bytes per element (2 or 4).
// Returns the launch's cudaError_t.
extern "C" int window_gather_forward(const void* concat, const int* rows,
                                     const int* cols, void* out, int R, int window,
                                     int wmax, int C, int elt, void* stream) {
  if (R <= 0 || window <= 0 || wmax < window || C <= 0 || (elt != 2 && elt != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long px_bytes = (long long)C * elt;
  const long long row_bytes = (long long)wmax * px_bytes;
  const bool vec = px_bytes % 16 == 0 && (uintptr_t)concat % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (vec) return launch<uint4>(concat, rows, cols, out, R, window, row_bytes, px_bytes, s);
  if (elt == 4)
    return launch<uint32_t>(concat, rows, cols, out, R, window, row_bytes, px_bytes, s);
  return launch<uint16_t>(concat, rows, cols, out, R, window, row_bytes, px_bytes, s);
}
