// Int8 residual trunk with input shifts on a padded tile (variant
// "int8_m9"), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8_m9`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:192),
// reached through `fused_trunk_int8(kernel="m9")`. It computes the int8_dx3
// function, not the same blocking. For each of the L = 2 * num_blocks convs
// and each block of `bg` games:
//   s_act = max(amax|h| over the block, 1e-8) / 127
//   q     = clip(rint(h / s_act), -127, 127)             (int8, true division)
//   acc   = sum over the nine taps k of shift_k(pad(q)) @ w[k]
//                                                         (int32, exact)
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
// Data movement (the row's own): the int8 activations are quantized once
// into a zero-padded 10x10 tile, and each of the nine taps is one
// (M, C) @ (C, C) int8 product read at that tap's offset in the tile, all
// nine accumulated in the int32 mma accumulators (int32 sums are exact, so
// their order is free). Products are warp-level mma.sync m16n8k32 (s8 * s8
// -> s32); wgmma and TMA are later work. One CTA per SM stages the layer's
// 147 KB of int8 weights once (transposed to [tap][C_out][C_in], rows
// padded to 144 bytes so fragment loads are bank-conflict free) and walks
// over tiles of two whole games (grid-stride), so it needs no halo and
// reads the weights from L2 once per CTA. The padded tile of two games is
// 28 KB; its border is zeroed once and never written. A missing second game
// (odd B) leaves its half of the tile stale: its products stay in its own
// rows, which the epilogue skips. The epilogue fuses dequantisation, bias,
// residual and ReLU, and reduces the next layer's per-block amax with
// atomicMax on the float's bit pattern (every value is >= 0 after ReLU). A
// small pre-pass converts the bf16 input to f32 and reduces the first
// layer's amax.
//
// Plain C interface for ctypes; each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "int8_trunk_common.cuh"

constexpr int GAMES = 2;                // games per tile
constexpr int PADW = S + 2;             // zero-padded board side
constexpr int PADP = PADW * PADW;       // padded positions per game
constexpr int RSTRIDE = C + 16;         // smem bytes per row: 36 words, so 8
                                        // rows x 4 words hit 32 distinct banks
constexpr int TAPS = 9;
constexpr int W_SMEM = TAPS * C * RSTRIDE;
constexpr int A_SMEM = GAMES * PADP * RSTRIDE;
constexpr int SMEM_BYTES = W_SMEM + A_SMEM;
constexpr int W_ITEMS = TAPS * (C / 4) * (C / 4);  // 4x4 byte blocks of a layer

static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");
static_assert(W_SMEM % 16 == 0 && A_SMEM % 16 == 0, "16-byte aligned tiles");
static_assert(W_ITEMS % THREADS == 0, "whole staging iterations");

// One 3x3 conv of the trunk; each CTA walks over tiles of GAMES games.
//   in:    f32 (B, 64, C) layer input, quantized here with amax[layer]
//   resid: f32 (B, 64, C) block input for conv1 (may alias out), else null
//   out:   f32 (B, 64, C) output, unused on the last layer
//   out_bf16: bf16 (B, 64, C) output of the last layer, else null
//   w:     int8 (9 taps, C_in, C_out) this layer's per-tap weights
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const float* __restrict__ in, const float* resid, float* out,
            __nv_bfloat16* __restrict__ out_bf16, const int8_t* __restrict__ w,
            const float* __restrict__ wscale, const float* __restrict__ bias,
            float* amax, int layer, int num_layers, int B, int bg, int G,
            int is_conv1, int is_last) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Ws = smem;           // [tap][C_out][C_in] int8
  unsigned char* As = smem + W_SMEM;  // [game][10 x 10 padded][C_in] int8
  const int tid = threadIdx.x;

  for (int i = tid; i < A_SMEM / 16; i += THREADS)
    reinterpret_cast<uint4*>(As)[i] = make_uint4(0, 0, 0, 0);

  // Stage the weights: each item reads a 4 (C_in) x 4 (C_out) byte block as
  // four words along C_out, transposes it in registers, and writes four
  // words along C_in. Lanes cover 8 C_out x 4 C_in blocks.
  const uint32_t* wg = reinterpret_cast<const uint32_t*>(w);
  constexpr int ROW_WORDS = C / 4;  // one C_in row of a tap's (C, C)
  for (int it = 0; it < W_ITEMS / THREADS; ++it) {
    const int item = it * THREADS + tid;
    const int rest = item >> 5;
    const int cout4 = (rest & 3) * 8 + (item & 7);
    const int cin4 = ((rest >> 2) & 7) * 4 + ((item >> 3) & 3);
    const int tap = rest >> 5;
    const uint32_t* src = wg + (tap * C + cin4 * 4) * ROW_WORDS + cout4;
    const uint32_t r0 = src[0], r1 = src[ROW_WORDS], r2 = src[2 * ROW_WORDS],
                   r3 = src[3 * ROW_WORDS];
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
    unsigned char* dst = Ws + (tap * C + cout4 * 4) * RSTRIDE + cin4 * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + RSTRIDE) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * RSTRIDE) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * RSTRIDE) = __byte_perm(t2, t3, 0x7632);
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3;   // rows wm*32 .. +32 (one game: wm >> 1)
  const int wn = warp >> 2;  // output channels wn*64 .. +64

  int base[2][2];  // padded position of rows gid and gid + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 32 + mt * 16 + h * 8 + gid;
      const int p = row & (P - 1);
      base[mt][h] = (row >> 6) * PADP + ((p >> 3) + 1) * PADW + (p & 7) + 1;
    }

  const int num_tiles = (B + GAMES - 1) / GAMES;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int game0 = tile * GAMES;
    __syncthreads();  // weights staged, border zeroed; the previous tile's reads done
    // Quantize this tile's games into the padded tile (border stays zero).
    for (int i = tid; i < GAMES * P * C / 4; i += THREADS) {
      const int c4 = i & (C / 4 - 1);
      const int p = (i >> 5) & (P - 1);
      const int gl = i >> 11;
      const int game = game0 + gl;
      if (game >= B) continue;
      const float s = act_scale(amax[layer * G + game / bg]);
      const float4 v = reinterpret_cast<const float4*>(in)[(static_cast<size_t>(game) * P + p) * (C / 4) + c4];
      const int pos = gl * PADP + ((p >> 3) + 1) * PADW + (p & 7) + 1;
      *reinterpret_cast<uint32_t*>(As + pos * RSTRIDE + c4 * 4) = quant4(v, s);
    }
    __syncthreads();

    int acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

    for (int tap = 0; tap < TAPS; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;  // _OFFSETS: dy-major
      const int off = dy * PADW + dx;
      const unsigned char* wt = Ws + (tap * C + wn * 64 + gid) * RSTRIDE + tig * 4;
#pragma unroll
      for (int kk = 0; kk < C; kk += 32) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const unsigned char* r0 = As + (base[mt][0] + off) * RSTRIDE + kk + tig * 4;
          const unsigned char* r1 = As + (base[mt][1] + off) * RSTRIDE + kk + tig * 4;
          a[mt][0] = ld32(r0);
          a[mt][1] = ld32(r1);
          a[mt][2] = ld32(r0 + 16);
          a[mt][3] = ld32(r1 + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const unsigned char* bp = wt + nt * 8 * RSTRIDE + kk;
          const uint32_t b0 = ld32(bp), b1 = ld32(bp + 16);
          mma_s8(acc[0][nt], a[0], b0, b1);
          mma_s8(acc[1][nt], a[1], b0, b1);
        }
      }
    }

    const int game = game0 + (wm >> 1);
    if (game >= B) continue;  // uniform per warp
    const int grp = game / bg;
    const float s_act = act_scale(amax[layer * G + grp]);
    float m = 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm * 32 + mt * 16 + h * 8 + gid) & (P - 1);
        const size_t rowoff = (static_cast<size_t>(game) * P + p) * C;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = wn * 64 + nt * 8 + tig * 2;
          float2 r = make_float2(0.0f, 0.0f);
          if (is_conv1) r = *reinterpret_cast<const float2*>(resid + rowoff + n);
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float sc = __fmul_rn(s_act, wscale[n + j]);
            float z = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][h * 2 + j]), sc), bias[n + j]);
            if (is_conv1) z = __fadd_rn(j ? r.y : r.x, z);
            z = z > 0.0f ? z : 0.0f;
            v[j] = z;
            m = fmaxf(m, z);
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
}

}  // namespace

extern "C" int trunk_int8m9_prepass(const void* x, void* xf, void* amax, int B,
                                    int bg, int num_layers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float) * num_layers * (B / bg), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  prepass_kernel<<<B, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<float*>(xf),
                                        static_cast<float*>(amax), bg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trunk_int8m9_conv(const void* in, const void* resid, void* out,
                                 void* out_bf16, const void* w, const void* wscale,
                                 const void* bias, void* amax, int layer,
                                 int num_layers, int B, int bg, int is_conv1,
                                 int is_last, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (B + GAMES - 1) / GAMES;
  const int grid = tiles < sms ? tiles : sms;
  conv_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(resid),
      static_cast<float*>(out), static_cast<__nv_bfloat16*>(out_bf16),
      static_cast<const int8_t*>(w), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<float*>(amax), layer,
      num_layers, B, bg, B / bg, is_conv1, is_last);
  return static_cast<int>(cudaGetLastError());
}
