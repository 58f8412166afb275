// Int8 residual trunk of the dual-head ResNet (variant "int8_dxcat"), for
// Hopper (sm_90a): the whole trunk in one cooperative launch
// (int8_trunk_sm90.cuh), designed for the gated training iteration's
// batches (self-play B = 64, the gate match B = 40).
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8_dxcat`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:377),
// reached through `fused_trunk_int8(kernel="dxcat")`. It computes the same
// function (that of the int8_dx3 trunk: per-block activation scale, true
// division, round half to even, s_act * w_scale taken first, no FMA; bias,
// residual and ReLU in f32; a bf16 output), not the same blocking. The
// Pallas kernel's three dx-shifted copies concatenated along K, one K = 3C
// product per dy and the dy shift on the int32 output become nine offsets
// of the wgmma A descriptor into a zero-padded tile; its (3, 3C, C) weights
// are relaid out once per weight set as (9, C_out, C_in), K-major, as an
// 8-bit wgmma needs.
//
// Bounds on an H100 SXM, 20 convs:
// - operations: 20 x B*64 rows x 128*128*9 MACs x 2, 0.012 ms at B = 64
//   and 0.195 ms at B = 1024 at 1,979 TOP/s; the bf16 input and output and
//   the 2.9 MB of weights take 0.002 ms at B = 64 at 3.35 TB/s;
// - at B = 64 neither binds: one conv is about 0.6 us of products a CTA,
//   and what a conv cannot avoid is its grid barrier, the L2 latency of
//   its input loads and the epilogue's stores. At B = 1024 the f32
//   activation traffic between convs binds (1.71 GB a forward, 0.512 ms
//   at 3.35 TB/s, less where the L2 holds it), as for trunk_int8_dx3.cu.
//
// Shapes: board side S in {4, 6, 8} and C a multiple of 16 up to 256, one
// library a shape (built with -DTRUNK_S, -DTRUNK_C); above 128 channels a
// layer's weights are streamed through shared memory (int8_trunk_sm90.cuh's
// note); the wrapper runs any other width up to 256 at the next multiple
// of 16 with zero channels and refuses the rest before a launch. The
// figures above are at S = 8, C = 128; at C = 256, B = 1024, 20 convs the
// operations bound is 0.781 ms and the f32 bytes floor 1.024 ms (PERF.md
// holds the times).
//
// Plain C interface for ctypes; returns 0 or an error code.

#include "int8_trunk_sm90.cuh"

#if !defined(TRUNK_S) || !defined(TRUNK_C)
#error "build with -DTRUNK_S=<board side> -DTRUNK_C=<channels> (kernels/build.py)"
#endif

// One forward: x bf16 (B, S * S, C); xf, yf f32 (B, S * S, C) scratch; out
// bf16 (B, S * S, C); w int8 (L, 9, C_out, C_in); wscale, bias f32 (L, C);
// scratch 4 * (L * B / bg + L) bytes, zeroed here. One memset, one launch.
extern "C" int trunk_dxcat(const void* x, void* xf, void* yf, void* out, const void* w,
                           const void* wscale, const void* bias, void* scratch, int L, int B,
                           int bg, void* stream) {
  return int8trunk::forward<TRUNK_S, TRUNK_C>(x, xf, yf, out, w, wscale, bias, scratch, L, B,
                                              bg, L, stream);
}
