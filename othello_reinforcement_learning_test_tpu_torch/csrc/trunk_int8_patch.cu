// Int8 residual trunk as an im2col product over a zero-padded tile (variant
// "int8_patch"), for Hopper (sm_90a): one launch of the int8 conv body
// (int8_conv_sm90.cuh, int32 sums) per conv, after a pre-pass, at the
// variant's block of 32 games.
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8_patch`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:230),
// reached through `fused_trunk_int8(kernel="patch")`. It computes the
// int8_dx3 function (per-block activation scale, true division, round half
// to even, the int32 3x3 conv, s_act * w_scale first, no FMA; bias, residual
// and ReLU in f32; a bf16 output). The Pallas kernel quantizes a game into a
// zero-padded tile and takes one K = 9C = 1152 product over the patch its
// nine shifted reads make. The body does the same product without building
// the patch: 36 wgmma k-steps from nine A-descriptor offsets into the padded
// tile. Its (9C, C) tap-major weights are relaid out once per weight set as
// (9, C_out, C_in), K-major, as an 8-bit wgmma needs.
//
// Bounds on an H100 SXM at B = 1024, 20 convs: 3.9e11 int8 operations,
// 0.195 ms at 1,979 TOP/s; the bytes of this structure (f32 activations
// between convs, one launch a conv: trunk_int8_dx3.cu) 1.71 GB, 0.512 ms at
// 3.35 TB/s. The body's design aims at the second.
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

extern "C" int trunk_patch_prepass(const void* x, void* xf, void* amax, int B, int bg,
                                   int num_layers, void* stream) {
  return int8conv::prepass<TRUNK_S, TRUNK_C>(x, xf, amax, B, bg, num_layers, stream);
}

extern "C" int trunk_patch_conv(const void* in, const void* resid, void* out, void* out_bf16,
                                const void* w, const void* wscale, const void* bias, void* amax,
                                int layer, int num_layers, int B, int bg, int is_conv1,
                                int is_last, void* stream) {
  return int8conv::launch<TRUNK_S, TRUNK_C, false>(in, resid, out, out_bf16, w, wscale, bias,
                                                   amax, layer, num_layers, B, bg, is_conv1,
                                                   is_last, stream);
}
