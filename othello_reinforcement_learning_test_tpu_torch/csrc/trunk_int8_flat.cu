// Int8 residual trunk as an im2col patch of masked flat row shifts (variant
// "int8_flat"), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8_flat`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:264),
// reached through `fused_trunk_int8(kernel="flat")`. It computes the
// int8_dx3 function, not the same blocking. For each of the L = 2 *
// num_blocks convs and each block of `bg` games:
//   s_act = max(amax|h| over the block, 1e-8) / 127
//   q     = clip(rint(h / s_act), -127, 127)        ((M, C) int8, flat rows)
//   patch[r, k*C:(k+1)*C] = valid_k(r) ? q[r + S*dy_k + dx_k] : 0
//   acc   = patch @ w                                     (int32, K = 1152)
//   z     = float(acc) * (s_act * w_scale[c]) + bias[c]   (f32, no FMA)
// with y = relu(conv0(x)), x = relu(x + conv1(y)) in f32 and a bf16 output.
//
// Shapes: 8x8 boards and C = 128 channels only (the wrapper raises on any
// other); the plain version takes any board side and channel count.
//
// Bound on an H100 SXM: 20 convs x B*64 rows x 128*128*9 MACs x 2 is
// 3.9e11 int8 operations per forward at B = 1024, 0.2 ms at the dense int8
// tensor-core rate of 1,979 TOP/s; the bytes (bf16 in and out, 2.9 MB of
// weights) take about 0.01 ms, so the trunk is bound by operations.
//
// Data movement (the row's own): a game is quantized once into an unpadded
// flat (64, C) int8 tile, and the patch's column block k is that tile's rows
// shifted by S*dy + dx, zeroed where the board position of the shifted row
// is off the board (the mask that also keeps a flat shift inside its game);
// no spatial padding. Then one deep product per patch. Choice for shared
// memory (see int8_patch_gemm.cuh): the layer's weights stay resident and
// the CTA walks one game at a time, its patch in two halves of 32 rows.
// Products are warp-level mma.sync m16n8k32 (s8 * s8 -> s32); wgmma and TMA
// are later work. The epilogue fuses dequantisation, bias, residual and
// ReLU, and reduces the next layer's per-block amax with atomicMax on the
// float's bit pattern (every value is >= 0 after ReLU). A small pre-pass
// converts the bf16 input to f32 and reduces the first layer's amax.
//
// Plain C interface for ctypes; each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "int8_trunk_common.cuh"
#include "int8_patch_gemm.cuh"

// one game's rows as they are, position p in row p
struct FlatTile {
  static constexpr int BYTES = P * TSTRIDE;
  __device__ static int pos(int p) { return p; }
  __device__ static int src(int p, int dy, int dx) {
    const int y = (p >> 3) + dy, x = (p & 7) + dx;
    return (y >= 0 && y < S && x >= 0 && x < S) ? p + S * dy + dx : -1;
  }
};

}  // namespace

extern "C" int trunk_flat_prepass(const void* x, void* xf, void* amax, int B,
                                  int bg, int num_layers, void* stream) {
  return launch_prepass(x, xf, amax, B, bg, num_layers, stream);
}

extern "C" int trunk_flat_conv(const void* in, const void* resid, void* out,
                               void* out_bf16, const void* w, const void* wscale,
                               const void* bias, void* amax, int layer,
                               int num_layers, int B, int bg, int is_conv1,
                               int is_last, void* stream) {
  return launch_patch_conv<FlatTile>(in, resid, out, out_bf16, w, wscale, bias, amax,
                                     layer, num_layers, B, bg, is_conv1, is_last, stream);
}
