// Pieces shared by the int8 trunk kernels (through int8_conv_sm90.cuh:
// trunk_int8_dx3.cu, trunk_int8.cu, trunk_int8_m9.cu, trunk_int8_patch.cu,
// trunk_int8_flat.cu, trunk_int8_dxcat.cu): the activation scale, the warp
// max, and the pre-pass that converts the bf16 trunk input to f32 and
// reduces the first layer's per-block amax. Included inside the conv body's
// anonymous namespace, after <cuda_bf16.h> and <cuda_runtime.h>; the board
// and channel sizes are those of the 10x128 network.

#pragma once

constexpr int C = 128;        // channels
constexpr int S = 8;          // board side
constexpr int P = S * S;      // positions per game
constexpr int THREADS = 256;  // 8 warps

__device__ __forceinline__ float act_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
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
