// Int8 residual trunk of the dual-head ResNet (variant "int8_dxcat"), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8_dxcat`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:377),
// reached through `fused_trunk_int8(kernel="dxcat")`. It computes the
// function of the int8_dx3 trunk (trunk_int8_dx3.cu states it: per-block
// activation scale, true division, round half to even, s_act * w_scale taken
// first, no FMA; bias, residual and ReLU in f32; a bf16 output), with the
// data movement of the Pallas kernel:
//   qcat[p] = (q[p-1], q[p], q[p+1])   lane-concatenated dx copies, (M, 3C)
//             int8, each zero where column c+dx is off the board
//   z_dy    = qcat @ w[dy]             one K = 3C = 384 int8 product per dy
//   acc[p] += z_dy[p + 8 * dy]         the dy shift on the int32 output,
//             where board row r+dy is on the board
//
// Shapes: 8x8 boards and C = 128 channels only (the wrapper raises on any
// other); the plain version takes any board side and channel count.
//
// Bound on an H100 SXM: 3.9e11 int8 operations per forward at B = 1024,
// 0.195 ms at the dense int8 tensor-core rate of 1,979 TOP/s; the bytes take
// about 0.01 ms, so the trunk is bound by operations.
//
// Design. One launch per conv; one CTA of 256 threads owns two whole games
// (128 rows x all 128 output channels), so it needs no halo. For each conv
// it builds the lane-concatenated (128, 384) int8 tile in shared memory: each
// quantized input word is written to its own row's centre block and to the
// dx = -1 block of the next row and the dx = +1 block of the previous one,
// or a zero where that neighbour is off the board. The layer's (3 dy, 3C, C)
// int8 weights are staged transposed per dy, [dy][C_out][3C]. Rows of both
// tiles are 384 + 16 bytes, so the eight rows of an mma.sync fragment load
// start four banks apart and every 32-bit fragment load is conflict-free:
// 153,600 + 51,200 = 204,800 bytes of the 227 KB a block may opt into.
// Warp w owns game w / 4 (64 rows: four m16 tiles) and output channels
// (w % 4) * 32 .. +32 (four n8 tiles). Per dy it runs 12 k-steps of
// m16n8k32 s8 into a fresh int32 z, then adds z shifted by one board row
// into the accumulator. An m16n8 tile covers board rows 2t and 2t+1 of the
// warp's game, and a thread holds column `gid` of both, so a thread holds
// column `gid` of all eight board rows: the shift is a register move (from
// the other half of the same tile or of the neighbouring one), with no
// shuffle and no int32 staging, and the halves that would cross the game's
// first or last board row are dropped. The epilogue (dequantisation, bias,
// residual, ReLU, the next layer's per-block amax by atomicMax) and the
// pre-pass are those of the other int8 trunks (int8_trunk_common.cuh).
//
// Plain C interface for ctypes; each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "int8_trunk_common.cuh"

constexpr int GAMES = 2;                 // games per CTA
constexpr int K3 = 3 * C;                // the concatenated contraction, 384
constexpr int RSTRIDE = K3 + 16;         // smem bytes per row: 100 words
constexpr int W_SMEM = 3 * C * RSTRIDE;  // [dy][C_out][3C]
constexpr int A_SMEM = GAMES * P * RSTRIDE;
constexpr int SMEM_BYTES = W_SMEM + A_SMEM;
constexpr int W_ITEMS = 3 * (K3 / 4) * (C / 4);  // 4x4 byte blocks of a layer

static_assert(SMEM_BYTES <= 232448, "fits the opt-in shared memory of a block");
static_assert(W_SMEM % 16 == 0 && RSTRIDE % 16 == 0, "16-byte aligned tiles");
static_assert(W_ITEMS % THREADS == 0, "whole staging iterations");

// One 3x3 conv of the trunk over GAMES games per CTA.
//   in:    f32 (B, 64, C) layer input, quantized here with amax[layer]
//   resid: f32 (B, 64, C) block input for conv1 (may alias out), else null
//   out:   f32 (B, 64, C) output, unused on the last layer
//   out_bf16: bf16 (B, 64, C) output of the last layer, else null
//   w:     int8 (3 dy, 3C (dx block, C_in), C_out) this layer's weights
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const float* __restrict__ in, const float* resid, float* out,
            __nv_bfloat16* __restrict__ out_bf16, const int8_t* __restrict__ w,
            const float* __restrict__ wscale, const float* __restrict__ bias,
            float* amax, int layer, int num_layers, int B, int bg, int G,
            int is_conv1, int is_last) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Ws = smem;           // [dy][C_out][3C] int8
  unsigned char* As = smem + W_SMEM;  // [game * 64 + p][3C] int8
  const int tid = threadIdx.x;
  const int game0 = blockIdx.x * GAMES;

  // Stage the weights: each item reads a 4 (K) x 4 (C_out) byte block as
  // four words along C_out, transposes it in registers, and writes four
  // words along K. Lanes cover 8 C_out x 4 K blocks.
  const uint32_t* wg = reinterpret_cast<const uint32_t*>(w);
  constexpr int ROW_WORDS = C / 4;  // one K row of a dy group
  for (int it = 0; it < W_ITEMS / THREADS; ++it) {
    const int item = it * THREADS + tid;
    const int rest = item >> 5;
    const int cout4 = (rest & 3) * 8 + (item & 7);
    const int kq = rest >> 2;  // dy * 24 + k4 / 4
    const int dy = kq / (K3 / 16);
    const int k4 = (kq % (K3 / 16)) * 4 + ((item >> 3) & 3);
    const uint32_t* src = wg + (dy * K3 + k4 * 4) * ROW_WORDS + cout4;
    const uint32_t r0 = src[0], r1 = src[ROW_WORDS], r2 = src[2 * ROW_WORDS],
                   r3 = src[3 * ROW_WORDS];
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
    unsigned char* dst = Ws + (dy * C + cout4 * 4) * RSTRIDE + k4 * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + RSTRIDE) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * RSTRIDE) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * RSTRIDE) = __byte_perm(t2, t3, 0x7632);
  }

  // Build the lane-concatenated tile: q[p] goes to row p's centre block
  // (dx = 0), to row p+1's dx = -1 block and to row p-1's dx = +1 block
  // while those rows are on p's board row; the blocks that look off the
  // board (dx = -1 in column 0, dx = +1 in column 7) are zero. Every byte of
  // a present game's rows is written exactly once.
  for (int i = tid; i < GAMES * P * C / 4; i += THREADS) {
    const int c4 = i & (C / 4 - 1);
    const int p = (i >> 5) & (P - 1);
    const int gl = i >> 11;
    const int game = game0 + gl;
    if (game >= B) continue;
    const float s = act_scale(amax[layer * G + game / bg]);
    const float4 v = reinterpret_cast<const float4*>(in)[(static_cast<size_t>(game) * P + p) * (C / 4) + c4];
    const uint32_t q = quant4(v, s);
    unsigned char* row = As + (gl * P + p) * RSTRIDE + c4 * 4;
    const int col = p & (S - 1);
    *reinterpret_cast<uint32_t*>(row + C) = q;
    if (col < S - 1) *reinterpret_cast<uint32_t*>(row + RSTRIDE) = q;  // next row, dx = -1
    else *reinterpret_cast<uint32_t*>(row + 2 * C) = 0u;
    if (col > 0) *reinterpret_cast<uint32_t*>(row - RSTRIDE + 2 * C) = q;  // previous row, dx = +1
    else *reinterpret_cast<uint32_t*>(row) = 0u;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int gl = warp >> 2;          // this warp's game in the CTA
  const int wn = warp & 3;           // output channels wn*32 .. +32
  const int game = game0 + gl;
  if (game >= B) return;  // uniform per warp; no barrier follows

  // acc[t][nt][2h + j]: board row 2t + h, column gid, channel
  // wn*32 + nt*8 + tig*2 + j
  int acc[4][4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][nt][j] = 0;

  const unsigned char* arow = As + (gl * P + gid) * RSTRIDE + tig * 4;
#pragma unroll
  for (int gy = 0; gy < 3; ++gy) {  // dy = gy - 1
    int z[4][4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[t][nt][j] = 0;
    const unsigned char* wrow = Ws + (gy * C + wn * 32 + gid) * RSTRIDE + tig * 4;
#pragma unroll 2
    for (int kk = 0; kk < K3; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned char* r0 = arow + (t * 16) * RSTRIDE + kk;
        const unsigned char* r1 = r0 + 8 * RSTRIDE;
        a[t][0] = ld32(r0);
        a[t][1] = ld32(r1);
        a[t][2] = ld32(r0 + 16);
        a[t][3] = ld32(r1 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* bp = wrow + nt * 8 * RSTRIDE + kk;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 16);
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_s8(z[t][nt], a[t], b0, b1);
      }
    }
    // acc at board row R takes z at board row R + dy, where that is on the
    // board: a register move within the thread
#pragma unroll
    for (int R = 0; R < S; ++R) {
      const int src = R + gy - 1;
      if (src < 0 || src >= S) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[R >> 1][nt][(R & 1) * 2 + j] += z[src >> 1][nt][(src & 1) * 2 + j];
    }
  }

  const int grp = game / bg;
  const float s_act = act_scale(amax[layer * G + grp]);
  float m = 0.0f;
#pragma unroll
  for (int R = 0; R < S; ++R) {
    const int p = R * S + gid;
    const size_t rowoff = (static_cast<size_t>(game) * P + p) * C;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = wn * 32 + nt * 8 + tig * 2;
      float2 r = make_float2(0.0f, 0.0f);
      if (is_conv1) r = *reinterpret_cast<const float2*>(resid + rowoff + n);
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sc = __fmul_rn(s_act, wscale[n + j]);
        float zf = __fadd_rn(__fmul_rn(__int2float_rn(acc[R >> 1][nt][(R & 1) * 2 + j]), sc),
                             bias[n + j]);
        if (is_conv1) zf = __fadd_rn(j ? r.y : r.x, zf);
        zf = zf > 0.0f ? zf : 0.0f;
        v[j] = zf;
        m = fmaxf(m, zf);
      }
      if (is_last) {
        *reinterpret_cast<__nv_bfloat162*>(out_bf16 + rowoff + n) =
            __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
      } else {
        *reinterpret_cast<float2*>(out + rowoff + n) = make_float2(v[0], v[1]);
      }
    }
  }
  m = warp_max(m);
  if (lane == 0 && layer + 1 < num_layers)
    atomicMax(reinterpret_cast<int*>(amax) + (layer + 1) * G + grp, __float_as_int(m));
}

}  // namespace

extern "C" int trunk_dxcat_prepass(const void* x, void* xf, void* amax, int B,
                                   int bg, int num_layers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float) * num_layers * (B / bg), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  prepass_kernel<<<B, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<float*>(xf),
                                        static_cast<float*>(amax), bg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trunk_dxcat_conv(const void* in, const void* resid, void* out,
                                void* out_bf16, const void* w, const void* wscale,
                                const void* bias, void* amax, int layer,
                                int num_layers, int B, int bg, int is_conv1,
                                int is_last, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (B + GAMES - 1) / GAMES;
  conv_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(resid),
      static_cast<float*>(out), static_cast<__nv_bfloat16*>(out_bf16),
      static_cast<const int8_t*>(w), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<float*>(amax), layer,
      num_layers, B, bg, B / bg, is_conv1, is_last);
  return static_cast<int>(cudaGetLastError());
}
