// Int8 residual trunk of the dual-head ResNet (variant "int8_dx3"), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_trunk_kernel_int8_dx3`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:318),
// reached through `fused_trunk_int8(kernel="dx3")`. It computes the same
// function, not the same blocking. For each of the L = 2 * num_blocks convs
// and each block of `bg` games:
//   s_act = max(amax|h| over the block, 1e-8) / 127
//   q     = clip(rint(h / s_act), -127, 127)             (int8, true division)
//   acc   = 3x3 conv of q with int8 weights               (int32, no halo
//           across board edges or games)
//   z     = float(acc) * (s_act * w_scale[c]) + bias[c]   (f32, no FMA)
// with y = relu(conv0(x)), x = relu(x + conv1(y)) in f32 and a bf16 output.
//
// Bound on an H100 SXM: 20 convs x B*64 rows x 128*128*9 MACs x 2 is
// 3.9e11 int8 operations per forward at B = 1024, 0.2 ms at the dense int8
// tensor-core rate of 1,979 TOP/s; the bytes (bf16 in and out, 2.9 MB of
// weights) take about 0.01 ms, so the trunk is bound by operations.
//
// What this first design does about that bound is little yet: it uses the
// int8 tensor cores through warp-level mma.sync (m16n8k32, s8*s8 -> s32),
// which reach only part of the rate that wgmma does, and it keeps f32
// activations in device memory between convs. One launch per conv; one CTA
// owns two whole games (128 rows x all 128 output channels), so it needs no
// halo: its games are quantized into a zero-padded 10x10 int8 tile in
// shared memory, and the layer's 147 KB of int8 weights are staged there
// too, transposed so every fragment load is one 32-bit, bank-conflict-free
// access. The epilogue fuses dequantisation, bias, residual and ReLU, and
// reduces the next layer's per-block amax with atomicMax on the float's bit
// pattern (valid because every value is >= 0 after ReLU). A small pre-pass
// converts the bf16 input to f32 and reduces the first layer's amax.
//
// Plain C interface for ctypes; each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;                  // channels
constexpr int S = 8;                    // board side
constexpr int P = S * S;                // positions per game
constexpr int GAMES = 2;                // games per CTA
constexpr int PADW = S + 2;             // zero-padded board side
constexpr int PADP = PADW * PADW;       // padded positions per game
constexpr int RSTRIDE = C + 16;         // smem bytes per row: 36 words, so 8
                                        // rows x 4 words hit 32 distinct banks
constexpr int TAPS = 9;
constexpr int THREADS = 256;            // 8 warps: 4 along rows x 2 along channels
constexpr int W_SMEM = TAPS * C * RSTRIDE;
constexpr int A_SMEM = GAMES * PADP * RSTRIDE;
constexpr int SMEM_BYTES = W_SMEM + A_SMEM;
constexpr int W_ITEMS = 3 * (C / 4) * 3 * (C / 4);  // 4x4 byte blocks of a layer

static_assert(W_SMEM % 16 == 0 && A_SMEM % 16 == 0, "16-byte aligned tiles");
static_assert(W_ITEMS % THREADS == 0, "whole staging iterations");

__device__ __forceinline__ float act_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

__device__ __forceinline__ uint32_t quant4(float4 v, float s) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float r = rintf(__fdiv_rn(f[i], s));
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    out |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xFFu) << (8 * i);
  }
  return out;
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// bf16 (B, 64, C) -> f32 copy, and amax[0][game / bg] = max |x| per block.
__global__ void __launch_bounds__(THREADS)
prepass_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ xf,
               float* __restrict__ amax0, int bg) {
  const int game = blockIdx.x;
  const int tid = threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(game) * P * C);
  float4* dst = reinterpret_cast<float4*>(xf + static_cast<size_t>(game) * P * C);
  float m = 0.0f;
  for (int i = tid; i < P * C / 8; i += THREADS) {
    const uint4 u = src[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float f[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
    dst[2 * i] = make_float4(f[0], f[1], f[2], f[3]);
    dst[2 * i + 1] = make_float4(f[4], f[5], f[6], f[7]);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
  }
  __shared__ float red[THREADS / 32];
  m = warp_max(m);
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float r = red[0];
    for (int i = 1; i < THREADS / 32; ++i) r = fmaxf(r, red[i]);
    atomicMax(reinterpret_cast<int*>(amax0) + game / bg, __float_as_int(r));
  }
}

// One 3x3 conv of the trunk over GAMES games per CTA.
//   in:    f32 (B, 64, C) layer input, quantized here with amax[layer]
//   resid: f32 (B, 64, C) block input for conv1 (may alias out), else null
//   out:   f32 (B, 64, C) output, unused on the last layer
//   out_bf16: bf16 (B, 64, C) output of the last layer, else null
//   w:     int8 (3 dx, C_in, 3 dy * C_out) this layer's dx3 weights
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const float* __restrict__ in, const float* resid, float* out,
            __nv_bfloat16* __restrict__ out_bf16, const int8_t* __restrict__ w,
            const float* __restrict__ wscale, const float* __restrict__ bias,
            float* amax, int layer, int num_layers, int B, int bg, int G,
            int is_conv1, int is_last) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Ws = smem;           // [tap = dx*3 + dy][C_out][C_in] int8
  unsigned char* As = smem + W_SMEM;  // [game][10 x 10 padded][C_in] int8
  const int tid = threadIdx.x;
  const int game0 = blockIdx.x * GAMES;

  for (int i = tid; i < A_SMEM / 16; i += THREADS)
    reinterpret_cast<uint4*>(As)[i] = make_uint4(0, 0, 0, 0);

  // Stage the weights: each item reads a 4 (C_in) x 4 (C_out) byte block as
  // four words along C_out, transposes it in registers, and writes four
  // words along C_in. Lanes cover 8 C_out x 4 C_in blocks.
  const uint32_t* wg = reinterpret_cast<const uint32_t*>(w);
  constexpr int ROW_WORDS = 3 * C / 4;  // one C_in row of the dx3 layout
  for (int it = 0; it < W_ITEMS / THREADS; ++it) {
    const int item = it * THREADS + tid;
    const int rest = item >> 5;
    const int cout4 = (rest & 3) * 8 + (item & 7);
    const int cin4 = ((rest >> 2) & 7) * 4 + ((item >> 3) & 3);
    const int tap = rest >> 5;
    const int gi = tap / 3, gj = tap % 3;
    const uint32_t* src = wg + (gi * C + cin4 * 4) * ROW_WORDS + (gj * C + cout4 * 4) / 4;
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
  __syncthreads();

  // Quantize this CTA's games into the padded tile (border stays zero).
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

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

  for (int tap = 0; tap < TAPS; ++tap) {
    const int dx = tap / 3 - 1, dy = tap % 3 - 1;
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
  if (game >= B) return;  // uniform per warp
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

}  // namespace

extern "C" int trunk_dx3_prepass(const void* x, void* xf, void* amax, int B,
                                 int bg, int num_layers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float) * num_layers * (B / bg), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  prepass_kernel<<<B, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<float*>(xf),
                                        static_cast<float*>(amax), bg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trunk_dx3_conv(const void* in, const void* resid, void* out,
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
