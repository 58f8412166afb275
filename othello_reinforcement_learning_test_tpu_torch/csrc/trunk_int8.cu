// Int8 residual trunk with output shifts (variants "int8" and "int8_bf16"),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:149),
// reached through `fused_trunk_int8(kernel="out_shift")` and, with
// `stage_bf16`, `kernel="out_shift_bf16"`. It computes the same function,
// not the same blocking. For each of the L = 2 * num_blocks convs and each
// block of `bg` games:
//   s_act = max(amax|h| over the block, 1e-8) / 127
//   q     = clip(rint(h / s_act), -127, 127)              (int8, true division)
//   z_k   = q @ w[:, k*C:(k+1)*C]   for the nine taps k   (int32)
//   acc   = sum over k in _OFFSETS order (dy-major) of z_k shifted to the
//           output: acc[p] += z_k[p + (dy, dx)], zero outside the board
//           int32, or with STAGE_BF16 each z_k rounded to bf16 (through f32,
//           as XLA converts int32 to bf16) and summed in f32 from zero
//   z     = f32(acc) * (s_act * w_scale[c]) + bias[c]      (f32, no FMA)
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
// Data movement (the kernel's own, unlike int8_dx3's input shifts): each
// tap's product is taken on the unshifted tile, and the shift is applied to
// the int32 output as it is added into an accumulator in shared memory at
// the shifted row, edges masked; a barrier after each tap keeps the f32 sums
// of STAGE_BF16 in _OFFSETS order. Products are warp-level mma.sync m16n8k32
// (s8 * s8 -> s32); wgmma and TMA are later work. A CTA stages one layer's
// 147 KB of int8 weights once (transposed to [tap][C_out][C_in]) and walks
// over tiles of two whole games (grid-stride, one CTA per SM), so it needs no
// halo and reads the weights from L2 once per launch. Shared memory: weights
// 144 KiB, the tile's int8 activations 16 KiB, the accumulator 64 KiB, every
// row XOR-swizzled so fragment loads and the shifted adds are free of bank
// conflicts. The epilogue fuses dequantisation, bias, residual and ReLU, and
// reduces the next layer's per-block amax with atomicMax on the float's bit
// pattern (every value is >= 0 after ReLU). A small pre-pass converts the
// bf16 input to f32 and reduces the first layer's amax.
//
// Plain C interface for ctypes; each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "int8_trunk_common.cuh"

constexpr int GAMES = 2;                // games per tile
constexpr int ROWS = GAMES * P;         // rows per tile
constexpr int TAPS = 9;
constexpr int W_SMEM = TAPS * C * C;    // int8 [tap][C_out][C_in]
constexpr int A_SMEM = ROWS * C;        // int8 [row][C_in]
constexpr int ACC_SMEM = ROWS * C * 4;  // int32 or f32 [row][C_out]
constexpr int SMEM_BYTES = W_SMEM + A_SMEM + ACC_SMEM;
constexpr int W_ITEMS = TAPS * (C / 4) * (C / 4);  // 4x4 byte blocks of a layer

static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");
static_assert(W_ITEMS % THREADS == 0, "whole staging iterations");

// Byte offset of 32-bit word `word` of 128-byte row `row` (weights and
// activations): words XOR (row % 8) * 4, so the 8 rows x 4 words of an mma
// fragment load hit 32 distinct banks.
__device__ __forceinline__ int swz8(int row, int word) {
  return row * C + ((word ^ ((row & 7) << 2)) << 2);
}

// Word offset of column `n` of accumulator row `row`: n XOR (row % 4) * 8,
// so a half-warp's 8-byte adds at 4 consecutive rows hit distinct banks.
__device__ __forceinline__ int swz_acc(int row, int n) {
  return row * C + (n ^ ((row & 3) << 3));
}

// int32 -> bf16 -> f32 through f32, rounding twice as XLA does
__device__ __forceinline__ float bf16_staged(int v) {
  return __bfloat162float(__float2bfloat16_rn(__int2float_rn(v)));
}

// One 3x3 conv of the trunk; each CTA walks over tiles of GAMES games.
//   in:    f32 (B, 64, C) layer input, quantized here with amax[layer]
//   resid: f32 (B, 64, C) block input for conv1 (may alias out), else null
//   out:   f32 (B, 64, C) output, unused on the last layer
//   out_bf16: bf16 (B, 64, C) output of the last layer, else null
//   w:     int8 (C_in, 9 * C_out) this layer's tap-major weights
template <bool STAGE_BF16>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const float* __restrict__ in, const float* resid, float* out,
            __nv_bfloat16* __restrict__ out_bf16, const int8_t* __restrict__ w,
            const float* __restrict__ wscale, const float* __restrict__ bias,
            float* amax, int layer, int num_layers, int B, int bg, int G,
            int is_conv1, int is_last) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Ws = smem;                    // [tap * C + C_out][C_in] int8
  unsigned char* As = smem + W_SMEM;           // [row][C_in] int8
  int* Acc = reinterpret_cast<int*>(smem + W_SMEM + A_SMEM);  // [row][C_out]
  float* AccF = reinterpret_cast<float*>(Acc);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3;   // product rows wm*32 .. +32
  const int wn = warp >> 2;  // output channels wn*64 .. +64

  // Stage the weights: each item reads a 4 (C_in) x 4 (C_out) byte block as
  // four words along C_out, transposes it in registers, and writes four
  // words along C_in. Lanes cover 8 C_out x 4 C_in blocks.
  const uint32_t* wg = reinterpret_cast<const uint32_t*>(w);
  constexpr int ROW_WORDS = TAPS * C / 4;  // one C_in row of (C, 9C)
  for (int it = 0; it < W_ITEMS / THREADS; ++it) {
    const int item = it * THREADS + tid;
    const int rest = item >> 5;
    const int cout4 = (rest & 3) * 8 + (item & 7);
    const int cin4 = ((rest >> 2) & 7) * 4 + ((item >> 3) & 3);
    const int tap = rest >> 5;
    const uint32_t* src = wg + (cin4 * 4) * ROW_WORDS + tap * (C / 4) + cout4;
    const uint32_t r0 = src[0], r1 = src[ROW_WORDS], r2 = src[2 * ROW_WORDS],
                   r3 = src[3 * ROW_WORDS];
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
    const uint32_t v[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                           __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(Ws + swz8(tap * C + cout4 * 4 + i, cin4)) = v[i];
  }

  // this lane's output channels in the epilogue
  float sc_w[4], b_c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc_w[j] = wscale[lane * 4 + j];
    b_c[j] = bias[lane * 4 + j];
  }

  const int num_tiles = (B + GAMES - 1) / GAMES;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int game0 = tile * GAMES;
    for (int i = tid; i < ACC_SMEM / 16; i += THREADS)
      reinterpret_cast<uint4*>(Acc)[i] = make_uint4(0, 0, 0, 0);
    // Quantize the tile's games (a missing last game is left as it is: its
    // products stay in its own rows, which the epilogue skips).
    for (int i = tid; i < ROWS * C / 4; i += THREADS) {
      const int c4 = i & (C / 4 - 1);
      const int row = i >> 5;
      const int game = game0 + row / P;
      if (game >= B) continue;
      const float s = act_scale(amax[layer * G + game / bg]);
      const float4 v = reinterpret_cast<const float4*>(in)[(static_cast<size_t>(game) * P + row % P) * (C / 4) + c4];
      *reinterpret_cast<uint32_t*>(As + swz8(row, c4)) = quant4(v, s);
    }
    __syncthreads();

    for (int tap = 0; tap < TAPS; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;  // _OFFSETS: dy-major
      int acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;
#pragma unroll
      for (int kk = 0; kk < C / 4; kk += 8) {  // 32 bytes of C_in per step
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r0 = wm * 32 + mt * 16 + gid;
          a[mt][0] = ld32(As + swz8(r0, kk + tig));
          a[mt][1] = ld32(As + swz8(r0 + 8, kk + tig));
          a[mt][2] = ld32(As + swz8(r0, kk + 4 + tig));
          a[mt][3] = ld32(As + swz8(r0 + 8, kk + 4 + tig));
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int wrow = tap * C + wn * 64 + nt * 8 + gid;
          const uint32_t b0 = ld32(Ws + swz8(wrow, kk + tig));
          const uint32_t b1 = ld32(Ws + swz8(wrow, kk + 4 + tig));
          mma_s8(acc[0][nt], a[0], b0, b1);
          mma_s8(acc[1][nt], a[1], b0, b1);
        }
      }
      // Add the product at input position p into output position
      // p - (dy, dx) of the same game, where that lies on the board.
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mt * 16 + h * 8 + gid;
          const int p = row % P;
          const int qy = p / S - dy, qx = p % S - dx;
          if (qy < 0 || qy >= S || qx < 0 || qx >= S) continue;
          const int orow = row - p + qy * S + qx;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int at = swz_acc(orow, wn * 64 + nt * 8 + tig * 2);
            const int v0 = acc[mt][nt][h * 2], v1 = acc[mt][nt][h * 2 + 1];
            if (STAGE_BF16) {
              float2* d = reinterpret_cast<float2*>(AccF + at);
              const float2 o = *d;
              *d = make_float2(__fadd_rn(o.x, bf16_staged(v0)), __fadd_rn(o.y, bf16_staged(v1)));
            } else {
              int2* d = reinterpret_cast<int2*>(Acc + at);
              const int2 o = *d;
              *d = make_int2(o.x + v0, o.y + v1);
            }
          }
        }
      __syncthreads();
    }

    // Epilogue: warp w owns rows w*16 .. +16 (one game), lane 4 channels.
    const int game = game0 + warp * 16 / P;
    if (game < B) {  // uniform per warp
      const int grp = game / bg;
      const float s_act = act_scale(amax[layer * G + grp]);
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] = __fmul_rn(s_act, sc_w[j]);
      float m = 0.0f;
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r;
        const int at = swz_acc(row, lane * 4);
        float a[4];
        if (STAGE_BF16) {
          const float4 t = *reinterpret_cast<const float4*>(AccF + at);
          a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
        } else {
          const int4 t = *reinterpret_cast<const int4*>(Acc + at);
          a[0] = __int2float_rn(t.x); a[1] = __int2float_rn(t.y);
          a[2] = __int2float_rn(t.z); a[3] = __int2float_rn(t.w);
        }
        const size_t off = (static_cast<size_t>(game) * P + row % P) * C + lane * 4;
        float r4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (is_conv1) {
          const float4 t = *reinterpret_cast<const float4*>(resid + off);
          r4[0] = t.x; r4[1] = t.y; r4[2] = t.z; r4[3] = t.w;
        }
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float z = __fadd_rn(__fmul_rn(a[j], sc[j]), b_c[j]);
          if (is_conv1) z = __fadd_rn(r4[j], z);
          z = z > 0.0f ? z : 0.0f;
          v[j] = z;
          m = fmaxf(m, z);
        }
        if (is_last) {
          __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(out_bf16 + off);
          d[0] = __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
          d[1] = __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
        } else {
          *reinterpret_cast<float4*>(out + off) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      m = warp_max(m);
      if (lane == 0 && layer + 1 < num_layers)
        atomicMax(reinterpret_cast<int*>(amax) + (layer + 1) * G + grp, __float_as_int(m));
    }
    __syncthreads();  // the next tile overwrites As and Acc
  }
}

}  // namespace

extern "C" int trunk_int8_prepass(const void* x, void* xf, void* amax, int B,
                                  int bg, int num_layers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float) * num_layers * (B / bg), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  prepass_kernel<<<B, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<float*>(xf),
                                        static_cast<float*>(amax), bg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trunk_int8_conv(const void* in, const void* resid, void* out,
                               void* out_bf16, const void* w, const void* wscale,
                               const void* bias, void* amax, int layer,
                               int num_layers, int B, int bg, int is_conv1,
                               int is_last, int stage_bf16, void* stream) {
  auto kernel = stage_bf16 ? conv_kernel<true> : conv_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (B + GAMES - 1) / GAMES;
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(resid),
      static_cast<float*>(out), static_cast<__nv_bfloat16*>(out_bf16),
      static_cast<const int8_t*>(w), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<float*>(amax), layer,
      num_layers, B, bg, B / bg, is_conv1, is_last);
  return static_cast<int>(cudaGetLastError());
}
