// Int8 residual trunk with output shifts (variants "int8" and "int8_bf16"),
// for Hopper (sm_90a): one launch of the int8 conv body (int8_conv_sm90.cuh)
// per conv, after a pre-pass; int32 sums, or with `stage_bf16` each tap's
// product rounded to bf16 and the taps summed in f32.
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:149),
// reached through `fused_trunk_int8(kernel="out_shift")` and, with
// `stage_bf16`, `kernel="out_shift_bf16"`. It computes the same function,
// not the same blocking: one activation scale per block of `bg` games (16
// by default), true division, round half to even; each tap's int32 product
// shifted to the output and summed (int32, or each rounded to bf16 through
// f32, as XLA converts int32 to bf16, and summed in f32 from zero in
// _OFFSETS order); f32 dequantisation without FMA, residual and ReLU in
// f32, a bf16 output. The Pallas kernel shifts each tap's product at the
// output; here the input is shifted through the wgmma A descriptor, which
// moves only rows, so each output element sums the same products in the
// same tap order. Its (C, 9C) weights are relaid out once per weight set as
// (9, C_out, C_in), K-major, as an 8-bit wgmma needs.
//
// Two bounds on an H100 SXM at B = 1024, 20 convs:
// - operations: 20 x B*64 rows x 128*128*9 MACs x 2 = 3.9e11 int8
//   operations, 0.195 ms at 1,979 TOP/s (with the bf16 input and output);
// - bytes of this structure: the per-block activation scale spans games no
//   CTA holds whole, so every conv is its own launch and reads and writes
//   f32 activations: 1.71 GB a forward with the pre-pass and the weights,
//   0.512 ms at 3.35 TB/s, less where the 50 MB L2 holds part of it.
// The design's overlaps (int8_conv_sm90.cuh) aim at the second. Measured
// on an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.731 ms a forward at
// B = 1024, 1.4x the bytes floor, about 2.35 TB/s of activation traffic
// (with `stage_bf16` 1.174 ms: each tap's wait and rounded adds). kernels/conv_stages.py: without the output
// stores 0.53 ms, without the input loads 0.64 ms, without the products
// 0.71 ms: the f32 activation traffic limits it, the stores most.
//
// Shapes: board side S in {4, 6, 8} and C a multiple of 16 up to 256, one
// library a shape (built with -DTRUNK_S, -DTRUNK_C); above 128 channels a
// layer's weights are streamed through shared memory (int8_conv_sm90.cuh's
// note); the wrapper runs any other width up to 256 at the next multiple
// of 16 with zero channels and refuses the rest before a launch. The
// figures above are at S = 8, C = 128; at C = 256, B = 1024, 20 convs the
// operations bound is 0.781 ms and the f32 bytes floor 1.024 ms (PERF.md
// holds the times).
//
// Plain C interface for ctypes; each function returns 0 or an error code.

#include "int8_conv_sm90.cuh"

#if !defined(TRUNK_S) || !defined(TRUNK_C)
#error "build with -DTRUNK_S=<board side> -DTRUNK_C=<channels> (kernels/build.py)"
#endif

extern "C" int trunk_int8_prepass(const void* x, void* xf, void* amax, int B, int bg,
                                  int num_layers, void* stream) {
  return int8conv::prepass<TRUNK_S, TRUNK_C>(x, xf, amax, B, bg, num_layers, stream);
}

extern "C" int trunk_int8_conv(const void* in, const void* resid, void* out, void* out_bf16,
                               const void* w, const void* wscale, const void* bias, void* amax,
                               int layer, int num_layers, int B, int bg, int is_conv1,
                               int is_last, int stage_bf16, void* stream) {
  return (stage_bf16 ? int8conv::launch<TRUNK_S, TRUNK_C, true>
                     : int8conv::launch<TRUNK_S, TRUNK_C, false>)(
      in, resid, out, out_bf16, w, wscale, bias, amax, layer, num_layers, B, bg, is_conv1,
      is_last, stream);
}
