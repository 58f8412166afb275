// bf16 residual trunk of the dual-head ResNet (variant "matmul9"), for
// Hopper (sm_90a): one launch per conv of the shared wgmma conv body in
// bf16_conv_sm90.cuh, with each tap's f32 product added unrounded.
//
// Replaces the Pallas TPU kernel `_trunk_kernel`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:61),
// reached through `fused_trunk` (variant "matmul9"). It computes the same
// function, not the same blocking. For each of the L = 2 * num_blocks convs,
// with BatchNorm folded into bf16 weights w (3, 3, C, C) (HWIO) and f32
// biases:
//   acc[p, :] = bias + sum over the nine taps (dy, dx) of
//               h[p + (dy, dx), :] @ w[1 + dy, 1 + dx]    (f32, zero outside
//                                                          the board)
//   conv 0 of a block: y = bf16(relu(acc))
//   conv 1 of a block: x = bf16(relu(f32(x) + acc))
// Every bf16 x bf16 product is exact in f32; only the order of the f32 sums
// differs from the plain version's: the 1,152 products of an output and its
// bias are summed by the tensor cores in one chain of 72 k16 steps started
// from the bias, inside the bound `sum_error_bound` puts on any order of the
// 9C + 10 terms.
//
// Shapes: board side S in {4, 6, 8} and C a multiple of 16 up to 256, one
// library a shape (built with -DTRUNK_S, -DTRUNK_C); above 128 channels the
// CTA's taps are streamed through shared memory (bf16_conv_sm90.cuh's
// note); the wrapper runs any other width up to 256 at the next multiple
// of 16 with zero channels and refuses the rest before a launch. The plain
// version takes any board side and channel count. At C = 256, B = 1024,
// 20 convs the operations bound is 1.563 ms (PERF.md holds the times).
//
// Bound on an H100 SXM: 2 * 9 * C^2 * (B * 64) * L = 3.87e11 bf16 operations
// per forward at B = 1024, L = 20, C = 128, 0.391 ms at the dense bf16
// tensor-core rate of 989 TFLOP/s; the bytes (bf16 activations in and out,
// 5.9 MB of weights) are about 39 MB, 0.012 ms at 3.35 TB/s. So the trunk is
// bound by operations.
//
// Design (bf16_conv_sm90.cuh): wgmma m64n64k16 with both operands in shared
// memory, one warpgroup per game; the 3x3 shift as a start offset of the A
// descriptor into a zero-padded 10x10 tile; each CTA's 64 output channels of
// all nine taps resident, loaded once per launch by TMA; the next game's
// activations loaded into registers during the current game's products;
// the epilogue staged through shared memory; persistent CTAs, two per
// stripe of games. What limits it, as measured: the products. With the
// activation loads taken out the conv is no faster, and at N = 64 each k16
// step reads 4 KB of operands from shared memory, as much as the SM's
// shared memory delivers in the step's 32 cycles at the full tensor rate
// (PERF.md, kernel table, row 1).
//
// Plain C interface for ctypes; the function returns 0 or an error code.

#include "bf16_conv_sm90.cuh"

#if !defined(TRUNK_S) || !defined(TRUNK_C)
#error "build with -DTRUNK_S=<board side> -DTRUNK_C=<channels> (kernels/build.py)"
#endif

extern "C" int trunk_m9_conv(const void* in, const void* resid, void* out, const void* w,
                             const void* bias, int B, int is_conv1, void* stream) {
  return bf16conv::launch<TRUNK_S, TRUNK_C, false, false>(in, resid, out, w, bias, B, is_conv1,
                                                          stream);
}
