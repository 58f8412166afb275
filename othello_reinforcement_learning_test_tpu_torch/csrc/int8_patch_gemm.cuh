// The im2col conv of trunk_int8_flat.cu:
// weights resident in shared memory as (C_out, 9C), one game's activations
// quantized into a tile, a patch of half a game's rows (32, 9C) built from
// that tile, and ONE deep (32, 9C) @ (9C, C) int8 product per half game.
// The kernel's tile and how it gathers the patch from it come in as `Tile`
// (see trunk_int8_flat.cu):
//   Tile::BYTES                      shared bytes of one game's tile
//   Tile::pos(p)                     tile row of board position p
//   Tile::src(p, dy, dx)             tile row of p's neighbour (dy, dx), or
//                                    -1 where the patch holds zeros
// Included inside the kernel's anonymous namespace, after
// int8_trunk_common.cuh.
//
// Shared memory: one game's (64, 1152) int8 patch is 72 KiB, and the
// layer's weights are 144 KiB, so a patch of two games, or of one, does not
// fit beside resident weights and a tile. This design keeps the weights
// resident (read from L2 once per CTA per launch) and walks one game at a
// time, its patch in two halves of 32 rows (37 KB). Rows of 1168 bytes (292
// words, 4 mod 32) make the mma fragment loads of patch and weights free
// of bank conflicts.

#pragma once

constexpr int TAPS = 9;
constexpr int K9 = TAPS * C;             // contraction depth 1152
constexpr int KSTRIDE = K9 + 16;         // bytes per patch / weight row
constexpr int HALF = P / 2;              // patch rows per product
constexpr int TSTRIDE = C + 16;          // bytes per tile row
constexpr int W_SMEM = C * KSTRIDE;      // int8 [C_out][9C]
constexpr int PATCH_SMEM = HALF * KSTRIDE;
constexpr int W_ITEMS = (K9 / 4) * (C / 4);  // 4x4 byte blocks of a layer

static_assert(W_ITEMS % THREADS == 0, "whole staging iterations");
static_assert(KSTRIDE % 16 == 0 && TSTRIDE % 16 == 0, "16-byte rows");

// One 3x3 conv of the trunk; each CTA walks over whole games.
//   in:    f32 (B, 64, C) layer input, quantized here with amax[layer]
//   resid: f32 (B, 64, C) block input for conv1 (may alias out), else null
//   out:   f32 (B, 64, C) output, unused on the last layer
//   out_bf16: bf16 (B, 64, C) output of the last layer, else null
//   w:     int8 (9C, C_out) this layer's weights, tap-major rows
template <class Tile>
__global__ void __launch_bounds__(THREADS, 1)
patch_conv_kernel(const float* __restrict__ in, const float* resid, float* out,
                  __nv_bfloat16* __restrict__ out_bf16, const int8_t* __restrict__ w,
                  const float* __restrict__ wscale, const float* __restrict__ bias,
                  float* amax, int layer, int num_layers, int B, int bg, int G,
                  int is_conv1, int is_last) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Ws = smem;                          // [C_out][9C] int8
  unsigned char* Ps = smem + W_SMEM;                 // [32 rows][9C] int8 patch
  unsigned char* Ts = smem + W_SMEM + PATCH_SMEM;    // the game's tile
  const int tid = threadIdx.x;

  for (int i = tid; i < Tile::BYTES / 16; i += THREADS)  // zero borders stay zero
    reinterpret_cast<uint4*>(Ts)[i] = make_uint4(0, 0, 0, 0);

  // Stage the weights transposed: each item reads a 4 (k) x 4 (C_out)
  // byte block as four words along C_out, transposes it in registers, and
  // writes four words along k. Lanes cover 8 C_out x 4 k blocks.
  const uint32_t* wg = reinterpret_cast<const uint32_t*>(w);
  constexpr int ROW_WORDS = C / 4;  // one k row of (9C, C)
  for (int it = 0; it < W_ITEMS / THREADS; ++it) {
    const int item = it * THREADS + tid;
    const int rest = item >> 5;
    const int cout4 = (rest & 3) * 8 + (item & 7);
    const int k4 = (rest >> 2) * 4 + ((item >> 3) & 3);
    const uint32_t* src = wg + (k4 * 4) * ROW_WORDS + cout4;
    const uint32_t r0 = src[0], r1 = src[ROW_WORDS], r2 = src[2 * ROW_WORDS],
                   r3 = src[3 * ROW_WORDS];
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
    unsigned char* dst = Ws + (cout4 * 4) * KSTRIDE + k4 * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + KSTRIDE) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * KSTRIDE) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * KSTRIDE) = __byte_perm(t2, t3, 0x7632);
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 1;   // patch rows wm*16 .. +16
  const int wn = warp >> 1;  // output channels wn*32 .. +32
  const unsigned char* a_lane = Ps + (wm * 16 + gid) * KSTRIDE + tig * 4;
  const unsigned char* b_lane = Ws + (wn * 32 + gid) * KSTRIDE + tig * 4;

  for (int game = blockIdx.x; game < B; game += gridDim.x) {
    const int grp = game / bg;
    const float s_act = act_scale(amax[layer * G + grp]);
    __syncthreads();  // weights staged; the previous game's patch built
    for (int i = tid; i < P * C / 4; i += THREADS) {
      const int c4 = i & (C / 4 - 1), p = i >> 5;
      const float4 v = reinterpret_cast<const float4*>(in)[(static_cast<size_t>(game) * P + p) * (C / 4) + c4];
      *reinterpret_cast<uint32_t*>(Ts + Tile::pos(p) * TSTRIDE + c4 * 4) = quant4(v, s_act);
    }
    float m = 0.0f;
    for (int half = 0; half < 2; ++half) {
      __syncthreads();  // the tile is written; the previous half's product read
      // patch[r, k*C + c] = q[position of row r shifted by OFFSETS[k], c]
      for (int i = tid; i < HALF * TAPS * (C / 16); i += THREADS) {
        const int chunk = i & (C / 16 - 1), rk = i >> 3;
        const int r = rk / TAPS, k = rk % TAPS;
        const int src = Tile::src(half * HALF + r, k / 3 - 1, k % 3 - 1);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (src >= 0) v = *reinterpret_cast<const uint4*>(Ts + src * TSTRIDE + chunk * 16);
        *reinterpret_cast<uint4*>(Ps + r * KSTRIDE + k * C + chunk * 16) = v;
      }
      __syncthreads();

      int acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0;
#pragma unroll 4
      for (int kk = 0; kk < K9; kk += 32) {
        uint32_t a[4];
        a[0] = ld32(a_lane + kk);
        a[1] = ld32(a_lane + 8 * KSTRIDE + kk);
        a[2] = ld32(a_lane + kk + 16);
        a[3] = ld32(a_lane + 8 * KSTRIDE + kk + 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned char* bp = b_lane + nt * 8 * KSTRIDE + kk;
          mma_s8(acc[nt], a, ld32(bp), ld32(bp + 16));
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = half * HALF + wm * 16 + h * 8 + gid;
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
            float z = __fadd_rn(__fmul_rn(__int2float_rn(acc[nt][h * 2 + j]), sc), bias[n + j]);
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
    }
    m = warp_max(m);
    if (lane == 0 && layer + 1 < num_layers)
      atomicMax(reinterpret_cast<int*>(amax) + (layer + 1) * G + grp, __float_as_int(m));
  }
}

template <class Tile>
int launch_patch_conv(const void* in, const void* resid, void* out, void* out_bf16,
                      const void* w, const void* wscale, const void* bias, void* amax,
                      int layer, int num_layers, int B, int bg, int is_conv1, int is_last,
                      void* stream) {
  constexpr int smem_bytes = W_SMEM + PATCH_SMEM + Tile::BYTES;
  static_assert(smem_bytes <= 232448, "fits one block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(patch_conv_kernel<Tile>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = B < sms ? B : sms;
  patch_conv_kernel<Tile><<<grid, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(resid),
      static_cast<float*>(out), static_cast<__nv_bfloat16*>(out_bf16),
      static_cast<const int8_t*>(w), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<float*>(amax), layer,
      num_layers, B, bg, B / bg, is_conv1, is_last);
  return static_cast<int>(cudaGetLastError());
}

int launch_prepass(const void* x, void* xf, void* amax, int B, int bg, int num_layers,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float) * num_layers * (B / bg), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  prepass_kernel<<<B, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<float*>(xf),
                                        static_cast<float*>(amax), bg);
  return static_cast<int>(cudaGetLastError());
}
