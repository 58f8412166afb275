// Int8 residual trunk of the dual-head ResNet (variant "int8_dx3"), for
// Hopper (sm_90a): one launch of the int8 conv body (int8_conv_sm90.cuh,
// int32 sums) per conv, after a pre-pass.
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8_dx3`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:318),
// reached through `fused_trunk_int8(kernel="dx3")`. It computes the same
// function, not the same blocking: one activation scale per block of `bg`
// games (64 by default), true division, round half to even, the int32 3x3
// conv, f32 dequantisation without FMA, residual and ReLU in f32, a bf16
// output. The Pallas kernel's dx/dy shifts become offsets of the wgmma A
// descriptor into a zero-padded tile; its (3, C, 3C) weights are relaid
// out once per weight set as (9, C_out, C_in), K-major, as an 8-bit wgmma
// needs.
//
// Two bounds on an H100 SXM at B = 1024, 20 convs:
// - operations: 20 x B*64 rows x 128*128*9 MACs x 2 = 3.9e11 int8
//   operations, 0.195 ms at 1,979 TOP/s (with the bf16 input and output);
// - bytes of this structure: the per-block activation scale spans games no
//   CTA holds whole, so every conv is its own launch and reads and writes
//   f32 activations (a conv 0 reads x and writes y, a conv 1 reads y and x
//   and writes x): 5 x 33.5 MB a block, 1.71 GB a forward with the
//   pre-pass and the weights, 0.512 ms at 3.35 TB/s, less where the 50 MB
//   L2 holds part of it.
// The design's overlaps (int8_conv_sm90.cuh) aim at the second. Measured
// on an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.728 ms a forward at
// B = 1024, 1.4x the bytes floor, about 2.35 TB/s of activation traffic.
// kernels/conv_stages.py: without the output
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

extern "C" int trunk_dx3_prepass(const void* x, void* xf, void* amax, int B, int bg,
                                 int num_layers, void* stream) {
  return int8conv::prepass<TRUNK_S, TRUNK_C>(x, xf, amax, B, bg, num_layers, stream);
}

extern "C" int trunk_dx3_conv(const void* in, const void* resid, void* out, void* out_bf16,
                              const void* w, const void* wscale, const void* bias, void* amax,
                              int layer, int num_layers, int B, int bg, int is_conv1,
                              int is_last, void* stream) {
  return int8conv::launch<TRUNK_S, TRUNK_C, false>(in, resid, out, out_bf16, w, wscale, bias,
                                                   amax, layer, num_layers, B, bg, is_conv1,
                                                   is_last, stream);
}
