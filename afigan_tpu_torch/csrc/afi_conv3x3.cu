// AF-interpolator 3x3 convolution with a multi-source input and a fused
// epilogue (CUDA C++, sm_90a).
//
// Replaces: afigan_tpu/ops/pallas/afi_chain.py::fused_generator_chain
// (_chain_kernel) -- the generator's head conv + 3 residual dense blocks +
// RiR residual, 16 chained 3x3 convs. The port drives this one kernel 16
// times: head (bias + LReLU), then per block conv1..4 (LReLU) reading the
// virtual concatenation [x, c1, .., c_{i-1}], and conv5 whose epilogue adds
// the block residual x + 0.2*c5 (and, in the last block, the RiR residual
// head + 0.2*(...)). The mid and tail convs of
// afigan_tpu/ops/pallas/afi_upsample.py::fused_upsample run on it too; the
// tail's epilogue adds the bilinear x2 skip of the generator input.
//
// What bounds it on the H100: arithmetic by the roofline (at C=256 a conv does
// 2*9*256*256 = 1.18 MFLOP per pixel against ~1 KB of bf16 activations in and
// out, far above the ~295 FLOP/byte ridge); in practice, on the pyramid's
// small maps, the serial chain of one block and the launch itself. What the
// design does about it: bfloat16 runs on the tensor cores (mma.sync, and wgmma
// for wide convs on large maps) behind a cp.async ring, with the tiling picked
// per launch from the shapes (afi_conv_common.cuh); float32 runs FMAs on the
// CUDA cores (67 TFLOP/s peak). Both read the dense-block concatenation in
// place from its sources instead of writing it to HBM (the point of
// _chain_kernel).
//
// tiling: -1 lets the launcher pick the bf16 tiling, 0.. forces an entry of
// its table (tests, sweeps).
#include "afi_conv_common.cuh"

extern "C" int afi_conv3x3(const void* const* srcs, const int* src_c, int n_src,
                           const void* w, const void* bias,
                           const void* res1, float s1, const void* res2, float s2,
                           const void* skip, void* out,
                           int B, int H, int W, int cout, int leaky, int dtype, int tiling,
                           void* stream) {
  const afi::Plane p = {B, H, W, dtype, tiling, static_cast<cudaStream_t>(stream)};
  return afi::conv(p, srcs, src_c, n_src, w, bias, cout, leaky, res1, s1, res2, s2, skip, out);
}

// A run of residual dense blocks in one call, 5 launches a block (and one
// more for the head conv): what fused_generator_chain and fused_rdb launch.
// The host walks the chain here and not in Python, where a launch costs some
// 50 us of interpreter time against 15-60 us on the card.
//   x        (B, H, W, C) input
//   head_w   the head conv's weight and head_b its bias, or null: then the
//            first block reads x
//   w        5 * n_rdb kernel-layout weights, block-major: w1..w4 (G out),
//            w5 (C out)
//   bufs     with a head, its (B, H, W, C) output first; then per block the
//            four (B, H, W, G) growth maps and the block's (B, H, W, C) output
//   rs       the blocks' residual scale: y' = y + rs * conv5
//   outer, outer_scale   folded into the last block: out = outer +
//            outer_scale * y'. With a head the outer residual is the head's
//            output (the RiR residual) and `outer` is not read
// Returns the first launch's error that is not 0, or 0.
extern "C" int afi_rdb_chain(const void* x, const void* head_w, const void* head_b,
                             const void* const* w, void* const* bufs, int n_rdb,
                             float rs, const void* outer, float outer_scale,
                             int B, int H, int W, int C, int G, int dtype, int tiling,
                             void* stream) {
  if (n_rdb < 1) return (int)cudaErrorInvalidValue;
  const afi::Plane p = {B, H, W, dtype, tiling, static_cast<cudaStream_t>(stream)};
  const int chans[5] = {C, G, G, G, G};
  const void* y = x;
  int nb = 0;
  if (head_w) {
    const int rc = afi::conv(p, &x, chans, 1, head_w, head_b, C, 1, nullptr, 1.f, nullptr, 1.f,
                             nullptr, bufs[nb]);
    if (rc) return rc;
    y = outer = bufs[nb++];
    outer_scale = rs;
  }
  for (int i = 0; i < n_rdb; ++i) {
    const void* feats[5] = {y, nullptr, nullptr, nullptr, nullptr};
    for (int j = 0; j < 4; ++j) {
      const int rc = afi::conv(p, feats, chans, j + 1, w[5 * i + j], nullptr, G, 1, nullptr, 1.f,
                               nullptr, 1.f, nullptr, bufs[nb]);
      if (rc) return rc;
      feats[j + 1] = bufs[nb++];
    }
    const bool last = i == n_rdb - 1;
    const int rc = afi::conv(p, feats, chans, 5, w[5 * i + 4], nullptr, C, 0, y, rs,
                             last ? outer : nullptr, outer_scale, nullptr, bufs[nb]);
    if (rc) return rc;
    y = bufs[nb++];
  }
  return 0;
}
