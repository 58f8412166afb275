// Pieces shared by the int8 trunk kernels (through int8_conv_sm90.cuh:
// trunk_int8_dx3.cu, trunk_int8.cu, trunk_int8_m9.cu, trunk_int8_patch.cu,
// trunk_int8_flat.cu, trunk_int8_dxcat.cu): the geometry of an instance
// (board side S, C channels; above 128 channels the streamed path's
// StreamShape adds its own), the activation scale, the warp max, and the
// pre-pass that converts the bf16 trunk input to f32 and reduces the first
// layer's per-block amax. Included inside the conv body's anonymous
// namespace, after <cuda_bf16.h>, <cuda_runtime.h> and sm90_common.cuh.

#pragma once

constexpr int THREADS = 256;  // the pre-pass: 8 warps
constexpr int TAPS = 9;
constexpr int STAGES = 3;     // the ring of padded tiles

// The geometry of one instance: S x S boards (4, 6 or 8), C channels in and
// out (a multiple of 16 up to 256). Values at S = 8, C = 128 in the notes.
template <int S_, int C_>
struct Shape {
  static constexpr int S = S_, C = C_;
  static constexpr int P = S * S;                 // positions per game
  // the padded tile's pitch: S + 2, at least a core matrix's 8 rows (the
  // rows and columns past S are computed and dropped)
  static constexpr int PADW = S + 2 > 8 ? S + 2 : 8;
  static constexpr int KP = (C + 31) / 32 * 32;   // K in whole k32 steps; the rest zeros
  static constexpr int KCH = KP / 16;             // 16-byte channel chunks of a tile: 8
  // every padded position a tap reads, (0, 0) to (9, 9) in the pitch: 100
  // at S = 8; then one more, so that the chunks a warp writes at one
  // position fall in distinct banks
  static constexpr int CHUNK_BYTES = (9 * PADW + 10 + 1) * 16;
  static constexpr int TILE_BYTES = KCH * CHUNK_BYTES;  // one game's padded tile: 12,928
  // the weights in shared memory: per tap, K-major rows of C_in bytes in
  // panels of SW bytes (the swizzle's width; one panel at C = 128, 64)
  static constexpr int SW = KP % 128 == 0 ? 128 : KP % 64 == 0 ? 64 : 32;
  static constexpr int PANELS = KP / SW;
  static constexpr int W_TAP_BYTES = C * KP;      // one tap: [C_out][C_in], 16,384
  static constexpr int W_BYTES = TAPS * W_TAP_BYTES;  // 147,456
  static constexpr int HALF_BYTES = P / 2 * C * 4;    // half a game in f32: 16,384
  static constexpr int HALF_F4 = HALF_BYTES / 16;     // its float4s
  static constexpr int LOADS = (HALF_F4 + 127) / 128;  // a producer thread's: 8

  static_assert(S == 4 || S == 6 || S == 8, "board side 4, 6 or 8");
  static_assert(C % 16 == 0 && C >= 16 && C <= 256,
                "channels a multiple of 16 up to 256 (above 128 the weights are streamed)");

  // the padded tile's position of position p of the board
  static __device__ __forceinline__ int tile_pos(int p) {
    return (p / S + 1) * PADW + p % S + 1;
  }
};

__device__ __forceinline__ float act_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// bf16 (B, S * S, C) -> f32 copy, and amax[0][game / bg] = max |x| per block.
template <int S, int C>
__global__ void __launch_bounds__(THREADS)
prepass_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ xf,
               float* __restrict__ amax0, int bg) {
  constexpr int P = S * S;
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
