// bf16 residual trunk with output shifts (variant "wide"), for Hopper
// (sm_90a).
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
// The bf16 rounding of each tap's product is what sets it apart from
// matmul9. The f32 dots behind the products are summed by the tensor cores
// in their own order, so a product can lie one bf16 ulp from the plain
// version's; the nine adds are the plain version's, in its order.
//
// Shapes: 8x8 boards and C = 128 channels only (the wrapper raises on any
// other); the plain version takes any board side and channel count.
//
// Bound on an H100 SXM: 2 * 9 * C^2 * (B * 64) * L = 3.87e11 bf16 operations
// per forward at B = 1024, L = 20, C = 128, 0.39 ms at the dense bf16
// tensor-core rate of 989 TFLOP/s; the bytes (bf16 activations in and out,
// 5.9 MB of weights) take about 0.012 ms at 3.35 TB/s. So the trunk is
// bound by operations.
//
// Data movement (the row's own): the product is taken on the unshifted
// input, and the shift is applied to the product as it is added at the
// output. What this first design does about the bound: bf16 tensor cores
// through warp-level mma.sync m16n8k16 (f32 accumulate), fed by ldmatrix;
// wgmma and TMA come later. One layer's bf16 weights are 288 KiB, more than
// a block's 227 KB, so two CTAs split the output channels: each keeps the
// nine taps' columns of its 64 output channels resident (162 KiB, padded
// rows for conflict-free ldmatrix.trans) and walks over tiles of two whole
// games (grid-stride), staging each tile's unpadded activations (34 KiB).
// Tap by tap, the CTA's warps take the tile's product with that tap's
// columns, round it to bf16 into a shared staging tile (18 KiB), and after a
// barrier each thread adds, for the 32 outputs it owns, the staged product
// at the shifted position to its f32 accumulator in registers (a gather per
// output; a second barrier per tap keeps the staging tile single). A CTA
// owns whole games, so it needs no halo. The epilogue fuses the residual
// add, ReLU and the bf16 rounding. One launch per conv.
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
constexpr int ROWS = GAMES * P;         // rows per tile
constexpr int NH = 64;                  // output channels per CTA
constexpr int A_STRIDE = C + 8;         // bf16 per activation row: 272 B
constexpr int W_STRIDE = NH + 8;        // bf16 per weight / staging row: 144 B
constexpr int TAPS = 9;
constexpr int THREADS = 256;            // 8 warps: 4 along rows x 2 along channels
constexpr int W_ELEMS = TAPS * C * W_STRIDE;
constexpr int A_ELEMS = ROWS * A_STRIDE;
constexpr int Z_ELEMS = ROWS * W_STRIDE;
constexpr int SMEM_BYTES = (W_ELEMS + A_ELEMS + Z_ELEMS) * 2;
constexpr int OUT_ROWS = ROWS * NH / 2 / THREADS;  // rows per thread in the gather: 16

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
//   w:     bf16 (C_in, 9 * C_out) this layer's folded wide weights
//   bias:  f32 (C_out,) this layer's folded bias
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __nv_bfloat16* __restrict__ in, const __nv_bfloat16* resid,
            __nv_bfloat16* out, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, int B, int is_conv1) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [tap][C_in][NH]
  __nv_bfloat16* As = Ws + W_ELEMS;  // [row][C_in], unpadded tile
  __nv_bfloat16* Zs = As + A_ELEMS;  // [row][NH] this tap's bf16 product
  const int tid = threadIdx.x;
  const int n_base = blockIdx.x * NH;
  const uint32_t ws = smem_addr(Ws), as = smem_addr(As);

  // Stage this CTA's 64 output channels of all nine taps: global row c_in
  // holds tap k's C_out at columns k*C .. k*C + C; this CTA takes 8 chunks.
  for (int i = tid; i < TAPS * C * (NH / 8); i += THREADS) {
    const int row = i >> 3, c = i & 7;  // row = tap * C + c_in
    const int tap = row / C, cin = row % C;
    cp_async16(ws + (row * W_STRIDE + c * 8) * 2,
               w + static_cast<size_t>(cin) * TAPS * C + tap * C + n_base + c * 8);
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3;   // product rows wm*32 .. +32
  const int wn = warp >> 2;  // channels wn*32 .. +32 of the CTA's 64

  // ldmatrix row addresses of this lane: A rows of each m-tile, B rows
  // (input channels) and columns (output channels)
  uint32_t a_row[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = wm * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_row[mt] = as + (r * A_STRIDE + (lane >> 4) * 8) * 2;
  }
  const uint32_t b_lane = ws + (((lane & 7) + ((lane >> 3) & 1) * 8) * W_STRIDE
                                + wn * 32 + (lane >> 4) * 8) * 2;

  // the gather: this thread owns columns 2*cp, 2*cp + 1 of rows rb + 8*i
  const int cp = tid & 31, rb = tid >> 5;
  const float bias0 = bias[n_base + 2 * cp], bias1 = bias[n_base + 2 * cp + 1];

  const int npairs = (B + GAMES - 1) / GAMES;
  for (int pair = blockIdx.y; pair < npairs; pair += gridDim.y) {
    __syncthreads();  // the previous tile's reads of As and Zs are done
    for (int i = tid; i < ROWS * (C / 8); i += THREADS) {
      const int c = i & (C / 8 - 1), r = i >> 4;
      const int game = pair * GAMES + r / P;
      if (game < B)
        cp_async16(as + (r * A_STRIDE + c * 8) * 2,
                   in + (static_cast<size_t>(game) * P + r % P) * C + c * 8);
      else  // a missing last game: zeros, its rows are never written out
        *reinterpret_cast<uint4*>(As + r * A_STRIDE + c * 8) = make_uint4(0, 0, 0, 0);
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[OUT_ROWS][2];
#pragma unroll
    for (int i = 0; i < OUT_ROWS; ++i) {
      acc[i][0] = bias0;
      acc[i][1] = bias1;
    }

    for (int tap = 0; tap < TAPS; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;  // _OFFSETS: dy-major
      const uint32_t b_tap = b_lane + tap * C * W_STRIDE * 2;
      float part[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < C; kk += 16) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], a_row[mt] + kk * 2);
#pragma unroll
        for (int j = 0; j < 2; ++j) ldmatrix_x4_trans(b[j], b_tap + (kk * W_STRIDE + j * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(part[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
      }
      __syncthreads();  // the previous tap's gather is done with Zs
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + h * 8 + gid;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<__nv_bfloat162*>(Zs + r * W_STRIDE + wn * 32 + nt * 8 + tig * 2) =
                __halves2bfloat162(__float2bfloat16_rn(part[mt][nt][h * 2]),
                                   __float2bfloat16_rn(part[mt][nt][h * 2 + 1]));
        }
      __syncthreads();
      // output row r takes the product at input row r + (dy, dx) of its
      // game; off the board it adds zero, as the padded Pallas sum does
#pragma unroll
      for (int i = 0; i < OUT_ROWS; ++i) {
        const int r = rb + 8 * i;
        const int p = r % P;
        const int y = p / S + dy, x = p % S + dx;
        float2 v = make_float2(0.0f, 0.0f);
        if (y >= 0 && y < S && x >= 0 && x < S)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              Zs + (r - p + y * S + x) * W_STRIDE + 2 * cp));
        acc[i][0] = __fadd_rn(acc[i][0], v.x);
        acc[i][1] = __fadd_rn(acc[i][1], v.y);
      }
    }

#pragma unroll
    for (int i = 0; i < OUT_ROWS; ++i) {
      const int r = rb + 8 * i;
      const int game = pair * GAMES + r / P;
      if (game >= B) continue;
      const size_t off = (static_cast<size_t>(game) * P + r % P) * C + n_base + 2 * cp;
      float v0 = acc[i][0], v1 = acc[i][1];
      if (is_conv1) {
        const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + off));
        v0 = __fadd_rn(rf.x, v0);
        v1 = __fadd_rn(rf.y, v1);
      }
      v0 = v0 > 0.0f ? v0 : 0.0f;
      v1 = v1 > 0.0f ? v1 : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    }
  }
}

}  // namespace

extern "C" int trunk_wide_conv(const void* in, const void* resid, void* out, const void* w,
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
