// AF-interpolator ConvTranspose(k6, s2, p2) as 4 subpixel phases
// (CUDA C++, sm_90a).
//
// Replaces: afigan_tpu/ops/pallas/afi_upsample.py::fused_upsample
// (_upsample_kernel), together with afi_conv3x3.cu: fused_upsample is
// mid conv (afi_conv3x3, bias + LReLU) -> this kernel -> tail conv
// (afi_conv3x3 at 2x, bias + bilinear x2 skip of the generator input).
//
// For stride 2, k=6, p=2 every output parity (dy, dx) is a dense 3x3-tap
// convolution over the UNDILATED input with the parity-selected, flipped
// kernel (taps m = 1,3,5 for even outputs and 0,2,4 for odd ones; see
// afigan_tpu/models/layers.py::ConvTranspose._phase_decomposed). The
// wrapper stacks the four (3,3,C,C) phase kernels; blockIdx.z carries the
// phase, and the epilogue writes each phase straight into its interleaved
// position of the (B, 2H, 2W, C) output -- no zero-stuffed input and no
// separate interleave pass.
//
// What bounds it on the H100: arithmetic, as for afi_conv3x3 (4 convs of
// 2*9*C*C FLOP per input pixel; tensor cores in bfloat16, CUDA-core FMAs in
// float32). The design spends no FLOPs on the 3/4 zeros a zero-stuffed
// transposed convolution would multiply.
#include "afi_conv_common.cuh"

extern "C" int afi_subpixel_deconv(const void* x, const void* w_phases,
                                   const void* bias, void* out,
                                   int B, int H, int W, int cin, int cout,
                                   int leaky, int dtype, int tiling, void* stream) {
  const afi::Plane p = {B, H, W, dtype, tiling, static_cast<cudaStream_t>(stream)};
  return afi::deconv(p, x, cin, w_phases, bias, cout, leaky, out);
}

// fused_upsample's three launches in one call: mid conv + LReLU -> y
// (B, H, W, C), the transposed conv + LReLU -> z (B, 2H, 2W, C), tail conv +
// bilinear x2 skip of x -> out (B, 2H, 2W, C). Returns the first launch's
// error that is not 0, or 0.
extern "C" int afi_upsample_forward(const void* r, const void* x, const void* wmid,
                                    const void* bmid, const void* wup, const void* bup,
                                    const void* wtail, const void* btail, void* y, void* z,
                                    void* out, int B, int H, int W, int C, int dtype,
                                    int tiling, void* stream) {
  const afi::Plane p = {B, H, W, dtype, tiling, static_cast<cudaStream_t>(stream)};
  int rc = afi::conv(p, &r, &C, 1, wmid, bmid, C, 1, nullptr, 1.f, nullptr, 1.f, nullptr, y);
  if (rc) return rc;
  rc = afi::deconv(p, y, C, wup, bup, C, 1, z);
  if (rc) return rc;
  const afi::Plane p2 = {B, 2 * H, 2 * W, dtype, tiling, p.stream};
  const void* zc = z;
  return afi::conv(p2, &zc, &C, 1, wtail, btail, C, 0, nullptr, 1.f, nullptr, 1.f, x, out);
}
