// The conv body the two bf16 trunk kernels share (trunk_matmul9.cu,
// trunk_wide.cu), for Hopper (sm_90a): one 3x3 conv of 8x8 boards, C = 128
// bf16 channels in and out, f32 sums, with the bias, the residual add (conv
// 1 of a block), ReLU and the bf16 rounding fused.
//
//   acc[p, :] = bias + sum over the nine taps k of T(shift_k(h)[p, :] @ w_k)
//
// where shift_k(h)[p] = h[p + (dy, dx)] (zero off the board), each tap's
// product is an f32 dot over the 128 input channels, and T is the identity
// (ROUND_TAPS = false: "matmul9") or the rounding to bf16 (ROUND_TAPS =
// true: "wide", whose Pallas kernel rounds each tap's product before the f32
// sum; rounding and shift commute, so shifting the input is the same
// function as shifting the rounded product).
//
// Design:
// - Products: wgmma.mma_async m64n64k16, bf16 in, f32 out, both operands
//   from shared memory. One warpgroup computes one game: M = the game's 64
//   positions (8 board rows), N = the CTA's 64 output channels, K = 128
//   input channels in 8 steps per tap.
// - The shift on the input through the A descriptor. A game's activations
//   sit in shared memory zero-padded to 10x10 in the no-swizzle canonical
//   layout [8-channel chunk][padded position][8 bf16]: an 8-row core matrix
//   is one board row of 8 consecutive padded positions, the next board row
//   is 10 positions (160 B) on, so tap (dy, dx) is only a start-address
//   offset of (dy * 10 + dx) * 16 bytes.
// - Resident weights: a CTA keeps the nine taps of its 64 output channels
//   (147,456 B) for the whole launch, loaded once by TMA as nine boxes of
//   [128 C_in][64 C_out] (rows of 128 B, 128-byte swizzle), which wgmma
//   reads as an N-major B: C_out contiguous, no transpose. A layer's
//   294,912 B do not fit one block, so two CTAs split C_out.
// - The order of the sums. wide: each tap's eight steps are one wgmma
//   group from zero, rounded and added to the sum (from the bias) in
//   OFFSETS order; the next tap's group is issued before this one's sums
//   are added, so the roundings and adds overlap the products. matmul9: all
//   72 steps in one chain on the bias, in the tensor cores' order, which
//   sum_error_bound allows (any order of the 9C + 10 terms).
// - The activations come through registers, overlapped with the products:
//   each warpgroup issues the coalesced 16-byte loads of its next game (8
//   a thread) before it starts the current game's products, and writes them
//   into its own padded tile when those products are done. Not by TMA: the
//   padded layout cuts a game's tile into 1,600 box rows of 16 B, and TMA
//   moving them took most of a conv's time (PERF.md).
// - The epilogue through the tile: the f32 sums are staged in the game's
//   tile, then read in whole rows of the CTA's 64 channels, so the residual
//   (brought into shared memory by cp.async during the products) is read
//   and the output written in coalesced 16-byte pieces. The staging
//   overwrites the tile's halo, which is zeroed again before the next game.
// - Persistent CTAs: 2 channel halves x (SMs / 2) stripes of games, two
//   warpgroups per CTA on alternate games, so one's epilogue and loads
//   overlap the other's products.
// - No split-K and no atomics: every output's summation order is fixed,
//   whatever B is and whichever CTA computes it.
//
// The host side (sm90_common.cuh) sets the shared-memory attribute and
// reads the SM count once per device, and encodes each layer's weight map
// once per pointer (the map holds only an address and shapes).

#pragma once

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace bf16conv {
// internal linkage: a function-local static of a template with external
// linkage is one object across every loaded library that instantiates it
namespace {

using namespace sm90;

constexpr int C = 128;                           // channels in and out
constexpr int S = 8;                             // board side
constexpr int P = S * S;                         // positions per game
constexpr int PADW = S + 2;                      // zero-padded board side
constexpr int NH = 64;                           // output channels per CTA
constexpr int TAPS = 9;
constexpr int KCH = C / 8;                       // 16-byte channel chunks
// one chunk's 100 padded positions of 16 B, and one more, so that the 8
// chunks a quarter warp writes at one position fall in distinct banks
constexpr int CHUNK_BYTES = (PADW * PADW + 1) * 16;
constexpr int STAGE_BYTES = KCH * CHUNK_BYTES;   // one game's padded tile: 25,856
constexpr int W_TAP_BYTES = C * NH * 2;          // one tap: [C_in][64 C_out], 16,384
constexpr int W_BYTES = TAPS * W_TAP_BYTES;      // 147,456
constexpr int CONSUMERS = 2;                     // warpgroups, one game each
constexpr int THREADS = CONSUMERS * 128;
constexpr int LOADS = P * KCH / 128;             // 16-byte loads a thread per game: 8
constexpr int EP_STRIDE = NH + 8;                // f32 per row of the epilogue's staging
constexpr int RES_BYTES = P * NH * 2;            // a game's residual for the CTA's channels
constexpr int EP_PIECES = RES_BYTES / 16 / 128;  // 16-byte output pieces a thread per game: 4
// + 1024: the weights' alignment (the 128-byte swizzle repeats every 1024 B)
constexpr int SMEM_BYTES = 1024 + W_BYTES + CONSUMERS * (STAGE_BYTES + RES_BYTES) + 8;

static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");
static_assert(P * EP_STRIDE * 4 <= STAGE_BYTES, "the epilogue's staging fits the tile");

// A: the game's 64 positions shifted by the tap, K-major without swizzle:
// core matrices one board row (8 positions x 16 B) apart in M by a padded
// row (160 B), in K by a channel chunk. B: the tap's [C_in][64 C_out] rows
// of 128 B, N-major with the 128-byte swizzle, 8-row groups 1024 B apart
// in K (the leading offset is unused at N = 64).
__device__ __forceinline__ uint64_t a_desc(uint32_t a_tap, int ks) {
  return desc(a_tap + 2 * ks * CHUNK_BYTES, CHUNK_BYTES, PADW * 16, 0);
}
__device__ __forceinline__ uint64_t b_desc(uint32_t b_tap, int ks) {
  return desc(b_tap + ks * 16 * NH * 2, 16, 1024, 1);
}

// Zeroes the halo of a padded tile: the 36 border positions of each chunk,
// thread t of the warpgroup taking border pieces t, t + 128, ...
__device__ __forceinline__ void zero_halo(uint32_t tile, int t) {
#pragma unroll
  for (int h = t; h < KCH * 36; h += 128) {
    const int b = h % 36;  // top row, bottom row, left column, right column
    const int pos = b < 10 ? b : b < 20 ? 80 + b : b < 28 ? (b - 19) * PADW : (b - 27) * PADW + 9;
    st_zero16(tile + (h / 36) * CHUNK_BYTES + pos * 16);
  }
}

// d (64 x 64 f32) = [d if accumulate] + A (64 x 16, K-major) @ B (16 x 64,
// N-major, hence trans-b = 1)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Issues one tap's eight k16 steps into d (from zero) as one wgmma group.
__device__ __forceinline__ void issue_tap(float (&d)[32], uint32_t a_tap, uint32_t b_tap) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) wgmma_m64n64k16(d, a_desc(a_tap, ks), b_desc(b_tap, ks), ks);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc += bf16(d) elementwise, one rounded add each
__device__ __forceinline__ void add_tap(float (&acc)[32], float (&d)[32]) {
  fence_operands(d);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float2 v = __bfloat1622float2(__floats2bfloat162_rn(d[i], d[i + 1]));
    acc[i] = __fadd_rn(acc[i], v.x);
    acc[i + 1] = __fadd_rn(acc[i + 1], v.y);
  }
}

// One 3x3 conv. blockIdx.x picks the 64 output channels, blockIdx.y the
// stripe of games (blockIdx.y, + gridDim.y, ...), warpgroup wg its
// alternate games (stripe game wg, wg + 2, ...).
//   wmap:  this layer's weights, bf16: HWIO (9C rows, C cols), or wide
//          (C rows, 9C cols) when WIDE
//   in:    bf16 (B, 64, C) conv input
//   resid: bf16 (B, 64, C) block input for conv 1 (may alias out), else null
//   out:   bf16 (B, 64, C) output
//   bias:  f32 (C,) this layer's folded bias
template <bool ROUND_TAPS, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
bf16_conv_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ in,
                 const __nv_bfloat16* resid, __nv_bfloat16* out, const float* __restrict__ bias,
                 int B, int is_conv1) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;  // weights
  const uint32_t wbar = ws + W_BYTES + CONSUMERS * (STAGE_BYTES + RES_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, t = tid & 127;
  const uint32_t stage = ws + W_BYTES + wg * STAGE_BYTES;  // this warpgroup's padded tile
  const uint32_t res = ws + W_BYTES + CONSUMERS * STAGE_BYTES + wg * RES_BYTES;  // its residual
  const int n_base = blockIdx.x * NH;

  if (tid == 0) {
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(wbar, W_BYTES);
    for (int tap = 0; tap < TAPS; ++tap)  // 128 input channels x 64 output channels
      tma_load_2d(ws + tap * W_TAP_BYTES, &wmap, WIDE ? tap * C + n_base : n_base,
                  WIDE ? 0 : tap * C, wbar);
  }
  zero_halo(stage, t);
  // thread t loads and stores 16-byte pieces t + 128 * i of a game: position
  // piece / 16, channel chunk piece % 16
  uint32_t dst[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int piece = t + 128 * i, p = piece >> 4;
    dst[i] = stage + (piece & 15) * CHUNK_BYTES + (((p >> 3) + 1) * PADW + (p & 7) + 1) * 16;
  }
  // thread (warp wl, lane) holds rows wl*16 + lane/4 (+ 8) and columns
  // 8*jn + 2*(lane % 4) (+ 1) of the warpgroup's 64 x 64 accumulator
  float bias_v[16];
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    bias_v[2 * jn] = bias[n_base + jn * 8 + 2 * (lane & 3)];
    bias_v[2 * jn + 1] = bias[n_base + jn * 8 + 2 * (lane & 3) + 1];
  }
  float part[2][32];  // wide: two taps' products, one in flight while the other is added
#pragma unroll
  for (int i = 0; i < 32; ++i) part[0][i] = part[1][i] = 0.0f;
  __syncthreads();  // the barrier's init

  int g = blockIdx.y + wg * gridDim.y;
  const int step = CONSUMERS * gridDim.y;
  uint4 next[LOADS];
  if (g < B) {
    const uint4* src = reinterpret_cast<const uint4*>(in + static_cast<size_t>(g) * P * C);
#pragma unroll
    for (int i = 0; i < LOADS; ++i) next[i] = __ldg(src + t + 128 * i);
#pragma unroll
    for (int i = 0; i < LOADS; ++i)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst[i]), "r"(next[i].x),
                   "r"(next[i].y), "r"(next[i].z), "r"(next[i].w)
                   : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  wg_sync(wg);
  mbar_wait(wbar, 0);

  for (; g < B; g += step) {
    const int g_next = g + step;
    if (is_conv1) {  // this game's residual, the pieces this thread's epilogue takes
#pragma unroll
      for (int i = 0; i < EP_PIECES; ++i) {
        const int piece = t + 128 * i;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(res + piece * 16),
                     "l"(resid + (static_cast<size_t>(g) * P + (piece >> 3)) * C + n_base +
                         (piece & 7) * 8)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (g_next < B) {  // in flight during this game's products
      const uint4* src = reinterpret_cast<const uint4*>(in + static_cast<size_t>(g_next) * P * C);
#pragma unroll
      for (int i = 0; i < LOADS; ++i) next[i] = __ldg(src + t + 128 * i);
    }

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = bias_v[(i >> 2) * 2 + (i & 1)];
    if constexpr (ROUND_TAPS) {
      // tap k's products are issued before tap k - 1's are rounded and
      // added, in OFFSETS order (dy-major): tap (dy, dx) reads the tile
      // from (1 + dy, 1 + dx)
#pragma unroll
      for (int tap = 0; tap <= TAPS; ++tap) {
        if (tap < TAPS)
          issue_tap(part[tap & 1], stage + ((tap / 3) * PADW + tap % 3) * 16,
                    ws + tap * W_TAP_BYTES);
        if (tap == 0) continue;
        if (tap < TAPS)
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        else
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        add_tap(acc, part[(tap - 1) & 1]);
      }
    } else {
      // all 72 steps in one chain on the bias: the tensor cores' order of
      // the 9C products and the bias, inside sum_error_bound
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks)
          wgmma_m64n64k16(acc, a_desc(stage + ((tap / 3) * PADW + tap % 3) * 16, ks),
                          b_desc(ws + tap * W_TAP_BYTES, ks), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
    }

    // The epilogue through the tile, so that it reads resid and writes out
    // in whole rows of the CTA's 64 channels: the sums as f32 [position][72]
    // (rows padded for conflict-free 8-byte writes), then 16-byte pieces:
    // position piece / 8, channels 8 * (piece % 8) ...
    wg_sync(wg);  // every warp's products are done with the tile
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         stage + ((wl * 16 + h * 8 + (lane >> 2)) * EP_STRIDE + jn * 8 +
                                  2 * (lane & 3)) * 4),
                     "f"(acc[4 * jn + 2 * h]), "f"(acc[4 * jn + 2 * h + 1])
                     : "memory");
    wg_sync(wg);
    if (is_conv1) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < EP_PIECES; ++i) {
      const int piece = t + 128 * i, p = piece >> 3, c = (piece & 7) * 8;
      float v[8];
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "r"(stage + (p * EP_STRIDE + c) * 4)
                   : "memory");
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7])
                   : "r"(stage + (p * EP_STRIDE + c + 4) * 4)
                   : "memory");
      const size_t off = (static_cast<size_t>(g) * P + p) * C + n_base + c;
      if (is_conv1) {
        uint32_t rw[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(rw[0]), "=r"(rw[1]), "=r"(rw[2]), "=r"(rw[3])
                     : "r"(res + piece * 16)
                     : "memory");
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rw[k]));
          v[2 * k] = __fadd_rn(rf.x, v[2 * k]);
          v[2 * k + 1] = __fadd_rn(rf.y, v[2 * k + 1]);
        }
      }
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * k] > 0.0f ? v[2 * k] : 0.0f,
                                                        v[2 * k + 1] > 0.0f ? v[2 * k + 1] : 0.0f);
        o[k] = *reinterpret_cast<const uint32_t*>(&b2);
      }
      *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    wg_sync(wg);  // the epilogue is done with the tile

    if (g_next < B) {  // the staging overwrote the halo
      zero_halo(stage, t);
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst[i]), "r"(next[i].x),
                     "r"(next[i].y), "r"(next[i].z), "r"(next[i].w)
                     : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);  // the next game's tile is written
  }
}

// One conv launch. Returns 0, a cudaError_t, or minus a CUresult of the
// tensor-map encoder.
template <bool ROUND_TAPS, bool WIDE>
int launch(const void* in, const void* resid, void* out, const void* w, const void* bias, int B,
           int is_conv1, void* stream) {
  static HostState host;
  if (B <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(w)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte loads, TMA
  auto kernel = bf16_conv_kernel<ROUND_TAPS, WIDE>;
  // a box is one tap's 128 input channels x the CTA's 64 output channels:
  // rows of 128 B, swizzled as wgmma reads them
  const WeightMap layout = {CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            {WIDE ? 9u * C : C, WIDE ? C : 9u * C},
                            (WIDE ? 9u * C : C) * 2u,
                            {NH, C}};
  CUtensorMap wmap;
  int sms = 0;
  const int rc = prepare_launch(host, reinterpret_cast<const void*>(kernel), SMEM_BYTES, w,
                                layout, &wmap, &sms);
  if (rc != 0) return rc;
  // one CTA per SM (the shared memory): the two channel halves of sms / 2
  // stripes of games
  const int stripes = B < sms / 2 ? B : (sms / 2 > 0 ? sms / 2 : 1);
  kernel<<<dim3(C / NH, stripes), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      wmap, static_cast<const __nv_bfloat16*>(in), static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), static_cast<const float*>(bias), B, is_conv1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bf16conv
