// bf16 residual trunk with each tap's product rounded (variant "wide"), for
// Hopper (sm_90a): one launch per conv of the shared wgmma conv body in
// bf16_conv_sm90.cuh, with each tap's f32 product rounded to bf16 before it
// is added.
//
// Replaces the Pallas TPU kernel `_trunk_kernel_wide`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:127, with
// `_shifted_accum` :112), reached through `fused_trunk_wide` (variant
// "wide"). It computes the same function, not the same blocking. For each
// of the L = 2 * num_blocks convs, with BatchNorm folded into bf16 weights
// w (C_in, 9 * C_out) (tap k in columns [k*C, (k+1)*C), k row-major over
// (dy, dx)) and f32 biases:
//   z     = bf16(h @ w)                        (f32 accumulation, then one
//                                               rounding per tap product)
//   acc   = bias + z[p + o_0, tap 0] + ... + z[p + o_8, tap 8]
//           (f32, one rounded add per tap in _OFFSETS order, zero outside
//            the board)
//   conv 0 of a block: y = bf16(relu(acc))
//   conv 1 of a block: x = bf16(relu(f32(x) + acc))
// The Pallas kernel shifts the rounded product; this kernel shifts the
// input, as matmul9 does: the rounding is elementwise and the shift only
// moves rows, so z[p + o_k, tap k] = bf16(h[p + o_k] @ w_k), the same
// function. The bf16 rounding of each tap's product is what sets it apart
// from matmul9. The f32 dots behind the products are summed by the tensor
// cores in their own order, so a product can lie one bf16 ulp from the
// plain version's; the nine adds are the plain version's, in its order.
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
// 5.9 MB of weights) take about 0.012 ms at 3.35 TB/s. So the trunk is
// bound by operations.
//
// Design (bf16_conv_sm90.cuh): matmul9's, with the wide weight layout read
// by its own tensor map ((C rows, 9C cols), a box per tap and 64 output
// channels) into the same shared layout; each tap's eight k16 steps are one
// wgmma group from zero, rounded to bf16 and added in OFFSETS order while
// the next tap's group runs. What limits it, as measured: the products and
// the per-tap rounding and adds, which keep a second set of 32 accumulators
// live (252 registers a thread); it runs 14% behind matmul9, which sums all
// taps in one chain (PERF.md, kernel table, row 2).
//
// Plain C interface for ctypes; the function returns 0 or an error code.

#include "bf16_conv_sm90.cuh"

#if !defined(TRUNK_S) || !defined(TRUNK_C)
#error "build with -DTRUNK_S=<board side> -DTRUNK_C=<channels> (kernels/build.py)"
#endif

extern "C" int trunk_wide_conv(const void* in, const void* resid, void* out, const void* w,
                               const void* bias, int B, int is_conv1, void* stream) {
  return bf16conv::launch<TRUNK_S, TRUNK_C, true, true>(in, resid, out, w, bias, B, is_conv1,
                                                        stream);
}
