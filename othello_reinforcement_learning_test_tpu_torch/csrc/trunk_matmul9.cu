// bf16 residual trunk of the dual-head ResNet (variant "matmul9"), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_trunk_kernel`
// (othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:61),
// reached through `fused_trunk` (variant "matmul9"). It computes the same
// function, not the same blocking. For each of the L = 2 * num_blocks convs,
// with BatchNorm folded into bf16 weights w (3, 3, C, C) and f32 biases:
//   acc[p, :] = bias + sum over the nine taps (dy, dx) of
//               h[p + (dy, dx), :] @ w[1 + dy, 1 + dx]    (f32, zero outside
//                                                          the board)
//   conv 0 of a block: y = bf16(relu(acc))
//   conv 1 of a block: x = bf16(relu(f32(x) + acc))
// Every bf16 x bf16 product is exact in f32; only the order of the f32 sums
// differs from the plain version's.
//
// Shapes: 8x8 boards and C = 128 channels only (the wrapper raises on any
// other); the plain version takes any board side and channel count.
//
// Bound on an H100 SXM: 2 * 9 * C^2 * (B * 64) * L = 3.87e11 bf16 operations
// per forward at B = 1024, L = 20, C = 128, 0.39 ms at the dense bf16
// tensor-core rate of 989 TFLOP/s; the bytes (bf16 activations in and out,
// 5.9 MB of weights) are about 39 MB, 0.012 ms at 3.35 TB/s. So the trunk is
// bound by operations.
//
// What this first design does about that bound: bf16 tensor cores through
// warp-level mma.sync m16n8k16 (f32 accumulate), fed by ldmatrix from shared
// memory; wgmma and TMA would reach more of the rate and come later. Each
// tap's product is accumulated from zero and then added to the running f32
// sum, as the Pallas kernel adds its nine f32 dots. One
// layer's bf16 weights are 288 KiB, more than a block's 227 KB of shared
// memory, so the output channels are split across two CTAs: each CTA keeps
// the nine taps of 64 output channels (162 KiB, padded rows so ldmatrix is
// bank-conflict free) resident for the whole launch and walks over pairs of
// games (grid-stride), staging each pair's activations into a zero-padded
// 10x10 tile (53 KiB), so the weights are read from L2 once per CTA and
// not once per tile. A CTA owns whole games, so it needs no halo. One
// launch per conv; the epilogue fuses bias, ReLU, the residual add and the
// bf16 rounding, and writes straight from the accumulators.
//
// Plain C interface for ctypes; the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;                  // channels
constexpr int S = 8;                    // board side
constexpr int P = S * S;                // positions per game
constexpr int GAMES = 2;                // games per tile
constexpr int NH = 64;                  // output channels per CTA
constexpr int PADW = S + 2;             // zero-padded board side
constexpr int PADP = PADW * PADW;       // padded positions per game
constexpr int A_STRIDE = C + 8;         // bf16 per activation row: 272 B
constexpr int W_STRIDE = NH + 8;        // bf16 per weight row: 144 B
constexpr int TAPS = 9;
constexpr int THREADS = 256;            // 8 warps: 4 along rows x 2 along channels
constexpr int W_ELEMS = TAPS * C * W_STRIDE;
constexpr int A_ELEMS = GAMES * PADP * A_STRIDE;
constexpr int SMEM_BYTES = (W_ELEMS + A_ELEMS) * 2;

static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");
static_assert((W_ELEMS * 2) % 16 == 0 && (A_ELEMS * 2) % 16 == 0, "16-byte tiles");
static_assert((A_STRIDE * 2) % 16 == 0 && (W_STRIDE * 2) % 16 == 0, "16-byte rows");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3x3 conv of the trunk. blockIdx.x picks the 64 output channels,
// blockIdx.y strides over pairs of games.
//   in:    bf16 (B, 64, C) conv input
//   resid: bf16 (B, 64, C) block input for conv 1 (may alias out), else null
//   out:   bf16 (B, 64, C) output
//   w:     bf16 (3, 3, C_in, C_out) this layer's folded weights
//   bias:  f32 (C_out,) this layer's folded bias
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __nv_bfloat16* __restrict__ in, const __nv_bfloat16* resid,
            __nv_bfloat16* out, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, int B, int is_conv1) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [tap][C_in][NH]
  __nv_bfloat16* As = Ws + W_ELEMS;  // [game][10 x 10 padded][C_in]
  const int tid = threadIdx.x;
  const int n_base = blockIdx.x * NH;
  const uint32_t ws = smem_addr(Ws), as = smem_addr(As);

  // Stage this CTA's 64 output channels of all nine taps: row (tap, k) of
  // the global layout holds C_out contiguous, this CTA takes 8 chunks of it.
  for (int i = tid; i < TAPS * C * (NH / 8); i += THREADS) {
    const int row = i >> 3, c = i & 7;
    cp_async16(ws + (row * W_STRIDE + c * 8) * 2, w + static_cast<size_t>(row) * C + n_base + c * 8);
  }
  for (int i = tid; i < A_ELEMS * 2 / 16; i += THREADS)
    reinterpret_cast<uint4*>(As)[i] = make_uint4(0, 0, 0, 0);

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3;   // rows wm*32 .. +32: game wm >> 1 of the pair
  const int wn = warp >> 2;  // channels n_base + wn*32 .. +32
  const int game_l = wm >> 1;

  // ldmatrix row addresses of this lane: A rows (positions) of each m-tile,
  // B rows (input channels) and columns (output channels).
  uint32_t a_row[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = (wm & 1) * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int pos = game_l * PADP + ((p >> 3) + 1) * PADW + (p & 7) + 1;
    a_row[mt] = as + (pos * A_STRIDE + (lane >> 4) * 8) * 2;
  }
  const uint32_t b_lane = ws + (((lane & 7) + ((lane >> 3) & 1) * 8) * W_STRIDE
                                + wn * 32 + (lane >> 4) * 8) * 2;

  float bias_v[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n_base + wn * 32 + nt * 8 + tig * 2;
    bias_v[nt][0] = bias[n];
    bias_v[nt][1] = bias[n + 1];
  }

  const int npairs = (B + GAMES - 1) / GAMES;
  for (int pair = blockIdx.y; pair < npairs; pair += gridDim.y) {
    __syncthreads();  // the previous tile's reads (and the zeroing) are done
    for (int i = tid; i < GAMES * P * (C / 8); i += THREADS) {
      const int c = i & (C / 8 - 1), r = i >> 4;
      const int gl = r >> 6, p = r & (P - 1);
      const int game = pair * GAMES + gl;
      const int pos = gl * PADP + ((p >> 3) + 1) * PADW + (p & 7) + 1;
      if (game < B)
        cp_async16(as + (pos * A_STRIDE + c * 8) * 2, in + (static_cast<size_t>(game) * P + p) * C + c * 8);
      else
        *reinterpret_cast<uint4*>(As + pos * A_STRIDE + c * 8) = make_uint4(0, 0, 0, 0);
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[mt][nt][0] = acc[mt][nt][2] = bias_v[nt][0];
        acc[mt][nt][1] = acc[mt][nt][3] = bias_v[nt][1];
      }

    for (int tap = 0; tap < TAPS; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int a_off = (dy * PADW + dx) * A_STRIDE * 2;
      const uint32_t b_tap = b_lane + tap * C * W_STRIDE * 2;
      // this tap's product from zero, then one rounded add, as the Pallas
      // kernel (and the plain version) adds each tap's f32 product: the
      // tensor cores' own accumulation then spans 128 terms, not 1152
      float part[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < C; kk += 16) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], a_row[mt] + a_off + kk * 2);
#pragma unroll
        for (int j = 0; j < 2; ++j) ldmatrix_x4_trans(b[j], b_tap + (kk * W_STRIDE + j * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(part[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][nt][j] = __fadd_rn(acc[mt][nt][j], part[mt][nt][j]);
    }

    const int game = pair * GAMES + game_l;
    if (game >= B) continue;  // uniform per warp
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm & 1) * 32 + mt * 16 + h * 8 + gid;
        const size_t rowoff = (static_cast<size_t>(game) * P + p) * C;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n_base + wn * 32 + nt * 8 + tig * 2;
          float v0 = acc[mt][nt][h * 2], v1 = acc[mt][nt][h * 2 + 1];
          if (is_conv1) {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(resid + rowoff + n);
            v0 = __fadd_rn(__bfloat162float(r.x), v0);
            v1 = __fadd_rn(__bfloat162float(r.y), v1);
          }
          v0 = v0 > 0.0f ? v0 : 0.0f;
          v1 = v1 > 0.0f ? v1 : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(out + rowoff + n) =
              __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
        }
      }
  }
}

}  // namespace

extern "C" int trunk_m9_conv(const void* in, const void* resid, void* out, const void* w,
                             const void* bias, int B, int is_conv1, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one CTA per SM (the shared memory), two CTAs (the halves of the output
  // channels) per pair of games
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  const int npairs = (B + GAMES - 1) / GAMES;
  const int resident = sms / (C / NH) > 0 ? sms / (C / NH) : 1;
  const int grid_y = npairs < resident ? npairs : resident;
  conv_kernel<<<dim3(C / NH, grid_y), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(in), static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), B, is_conv1);
  return static_cast<int>(cudaGetLastError());
}
