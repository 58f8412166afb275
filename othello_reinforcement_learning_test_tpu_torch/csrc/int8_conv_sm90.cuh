// The conv body the int8 trunk kernels share (trunk_int8_dx3.cu,
// trunk_int8.cu, trunk_int8_m9.cu, trunk_int8_patch.cu, trunk_int8_flat.cu;
// int8_trunk_sm90.cuh, the one-launch trunk, takes its pieces), for Hopper
// (sm_90a): one 3x3 conv of 8x8 boards, C = 128 channels in and out, of
// the quantized trunk, with the dequantisation, the bias, the residual add
// (conv 1 of a block), ReLU and the next layer's per-block amax fused.
// For each block of `bg` games:
//
//   s_act = max(amax|h| over the block, 1e-8) / 127
//   q     = clip(rint(h / s_act), -127, 127)          (int8, true division)
//   acc   = sum over the nine taps k of T(shift_k(q) @ w_k)
//   z     = f32(acc) * (s_act * w_scale[c]) + bias[c]  (f32, no FMA)
//
// where shift_k(q)[p] = q[p + (dy, dx)] (zero off the board). T is the
// identity and acc an int32 sum (STAGE_BF16 = false: "int8_dx3", "int8"),
// or T rounds each tap's int32 product to bf16 through f32, as XLA converts
// int32 to bf16, and acc is their f32 sum from zero in OFFSETS order
// (STAGE_BF16 = true: "int8_bf16"). Conv 1 adds the block input in f32;
// ReLU; f32 out, or bf16 on the last layer.
//
// Design:
// - Products: wgmma.mma_async m64n128k32, s8 x s8 -> s32, both operands
//   from shared memory. One warpgroup computes one game: M = its 64
//   positions (8 board rows), N = all 128 output channels, K = 128 input
//   channels in 4 steps a tap. An 8-bit wgmma takes only K-major operands.
// - The shift on the input through the A descriptor: a game's int8 codes
//   sit in shared memory zero-padded to 10x10 in the no-swizzle K-major
//   layout [16-channel chunk][padded position][16 B], an 8-row core matrix
//   being one board row, so tap (dy, dx) is a start offset of
//   ((1 + dy) * 10 + 1 + dx) * 16 bytes. Only interiors are written, so
//   the halos, zeroed once a launch, stay zero.
// - Resident weights: a layer's 147,456 B fit one CTA. They arrive by TMA
//   once a launch, as nine [128 C_out][128 C_in] boxes (rows of 128 B,
//   128-byte swizzle) from the K-major (9, C_out, C_in) layout that
//   FusedInference makes once per weight set.
// - Warp specialisation, so that loads, quantisation, products and
//   epilogue overlap: one CTA an SM, persistent over its stripe of games.
//   A producer warpgroup brings each game in f32 by bulk copies (TMA, one
//   contiguous 16 KB half-game each) into two staging halves in shared
//   memory, one half ahead, quantizes it into a ring of three padded tiles
//   and marks the slot full (mbarrier); two consumer warpgroups take
//   alternate games, wait for their slot, issue the products, release the
//   slot when they are done and run the epilogue. Register-staged loads
//   left the producer waiting on them.
//   Any B and any bg: every game is whole in one tile.
// - Quantisation with the block's s_act from amax, which the previous
//   launch finished. Not by a division each: the IEEE division takes a
//   slow path for a zero dividend, and half of a post-ReLU layer is zeros
//   (it cost 0.8 ms of a 1.7 ms forward). Each value is multiplied by the
//   block's reciprocal, within 2 ulps of the rounded quotient, which rounds
//   to the same integer unless it lies within 2^-14 of a half-integer;
//   only those few are divided.
// - The order of the sums. int32: the 36 k-steps of a conv in one chain,
//   exact in any order (|acc| <= 1,152 x 127 x 127 < 2^31). STAGE_BF16:
//   each tap's product is its own group from zero, and the next tap's
//   group is in flight while this one is rounded and added, in OFFSETS
//   order. The producer gives the consumers its registers (setmaxnreg), so
//   two taps' sums and the f32 accumulator fit.
// - The epilogue from the accumulator registers: s_act * w_scale first,
//   then __fmul_rn and __fadd_rn of the bias, the residual (loaded during
//   the products), ReLU; each thread writes 8-byte pieces that fill whole
//   32-byte sectors. The next layer's per-block amax is an atomicMax on the
//   float's bits (every value is >= 0 after ReLU), one a warp and game.
//
// - Programmatic dependent launch: a conv's set-up (barriers, the weights'
//   TMA) overlaps the previous conv's last games.
//
// The activation scale is a max over a block of bg games that no CTA
// holds whole, so each conv is one launch and the activations cross device
// memory in f32 between convs: rint(h / s_act) needs h exactly.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace int8conv {
// internal linkage: a function-local static of a template with external
// linkage is one object across every loaded library that instantiates it,
// so each library that includes this body keeps its own launch state
// and weight maps. A map is keyed on the weights' pointer and row count, the
// only fields of its layout that vary, so a new weight tensor at a reused
// address is served a map equal to the one it would encode
namespace {

using namespace sm90;

// C, S, P, THREADS, act_scale, warp_max and the pre-pass
#include "int8_trunk_common.cuh"

constexpr int PADW = S + 2;                       // zero-padded board side
constexpr int TAPS = 9;
constexpr int KCH = C / 16;                       // 16-byte channel chunks: 8
// one chunk's 100 padded positions of 16 B, and one more, so that the 8
// chunks a warp writes at one position fall in distinct banks
constexpr int CHUNK_BYTES = (PADW * PADW + 1) * 16;
constexpr int TILE_BYTES = KCH * CHUNK_BYTES;     // one game's padded tile: 12,928
constexpr int W_TAP_BYTES = C * C;                // one tap: [C_out][C_in], 16,384
constexpr int W_BYTES = TAPS * W_TAP_BYTES;       // 147,456
constexpr int CONV_THREADS = 3 * 128;             // a producer and two consumer warpgroups
// registers a thread: the producer gives up what it does not need to the
// consumers' accumulators (128 x 72 + 256 x 216 <= 65,536)
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;
constexpr int STAGES = 3;                         // the ring of padded tiles
constexpr int HALF_BYTES = P / 2 * C * 4;         // half a game in f32: 16,384
constexpr int LOADS = HALF_BYTES / 16 / 128;      // its float4s a producer thread: 8
// + 1024: the weights' alignment (the 128-byte swizzle repeats every 1024 B);
// two half-games of f32 staging; the barriers: full and empty a tile, one a
// staging half, and the weights'
constexpr int SMEM_BYTES =
    1024 + W_BYTES + STAGES * TILE_BYTES + 2 * HALF_BYTES + (2 * STAGES + 3) * 8;

static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");

// A: the game's 64 positions shifted by the tap, K-major without swizzle:
// core matrices one board row (8 positions x 16 B) apart in M by a padded
// row (160 B), in K by a channel chunk. B: the tap's [C_out][C_in] rows of
// 128 B, K-major with the 128-byte swizzle, 8-row groups 1024 B apart in N;
// a k-step is 32 B into the rows (the leading offset is unused).
__device__ __forceinline__ uint64_t a_desc(uint32_t a_tap, int ks) {
  return desc(a_tap + 2 * ks * CHUNK_BYTES, CHUNK_BYTES, PADW * 16, 0);
}
__device__ __forceinline__ uint64_t b_desc(uint32_t b_rows, int ks) {
  return desc(b_rows + ks * 32, 16, 1024, 1);
}

// the tile's start for tap k of OFFSETS (dy-major): (1 + dy, 1 + dx)
__device__ __forceinline__ uint32_t a_tap(uint32_t tile, int tap) {
  return tile + ((tap / 3) * PADW + tap % 3) * 16;
}

// d (64 x 128 s32) = [d if accumulate] + A (64 x 32 s8) @ B (32 x 128 s8)
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Issues tap k's four k-steps from zero as one wgmma group into d.
__device__ __forceinline__ void issue_tap(int (&d)[64], uint32_t tile, uint32_t ws, int tap) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < C / 32; ++ks)
    wgmma_m64n128k32(d, a_desc(a_tap(tile, tap), ks), b_desc(ws + tap * W_TAP_BYTES, ks), ks);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc += f32(bf16(f32(d))), one rounded add each
__device__ __forceinline__ void add_tap(float (&acc)[64], int (&d)[64]) {
  fence_operands(d);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    acc[i] = __fadd_rn(acc[i], __bfloat162float(__float2bfloat16_rn(__int2float_rn(d[i]))));
}

__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// 1.5 * 2^23: adding it to a float of magnitude <= 2^22 rounds it to an
// integer, half to even, and leaves that integer's low byte in the bits
constexpr float ROUND_MAGIC = 12582912.0f;
// h * (1 / s) is within 2 ulps (2^-16 below 128) of fdiv_rn(h, s); past
// this distance from the nearest integer both round alike
constexpr float NEAR_HALF = 0.5f - 1.0f / 16384;

// clip(rint(h * y), -127, 127) as an int8 in the low byte, y the correctly
// rounded 1 / s; sets `near` where that may round otherwise than
// fdiv_rn(h, s) would. No branch, so that a thread's values interleave.
__device__ __forceinline__ uint32_t quantize1(float h, float y, bool& near) {
  const float q = fminf(fmaxf(__fmul_rn(h, y), -127.0f), 127.0f);
  const float r = __fadd_rn(q, ROUND_MAGIC);
  near |= fabsf(__fsub_rn(q, __fsub_rn(r, ROUND_MAGIC))) > NEAR_HALF;
  return __float_as_uint(r);
}

// clip(rint(fdiv_rn(h, s)), -127, 127) as an int8 in the low byte; a zero
// is not divided (the division's slow path)
__device__ __forceinline__ uint32_t quantize1_exact(float h, float s) {
  const float d = __fdiv_rn(h == 0.0f ? s : h, s);
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(h == 0.0f ? 0.0f : d, -127.0f), 127.0f), ROUND_MAGIC));
}

// four int8 codes, v.x in the low byte
__device__ __forceinline__ uint32_t pack4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return __byte_perm(__byte_perm(x, y, 0x0040), __byte_perm(z, w, 0x0040), 0x5410);
}

// Writes a thread's 8 float4s of a half-game, divided by s and rounded
// (y = 1 / s), into the padded tile: float4 i is board row i / 2 of the
// half, columns 4 * (i % 2) + warp of the warpgroup, from q_base (the
// half's first row, column 1 + warp, the thread's chunk and word).
__device__ __forceinline__ void quantize_into(uint32_t q_base, const float4 (&v)[LOADS], float s,
                                              float y) {
  uint32_t w[LOADS];
  bool near = false;
#pragma unroll
  for (int i = 0; i < LOADS; ++i)
    w[i] = pack4(quantize1(v[i].x, y, near), quantize1(v[i].y, y, near),
                 quantize1(v[i].z, y, near), quantize1(v[i].w, y, near));
  if (near) {  // rare: this thread's values again, divided
#pragma unroll
    for (int i = 0; i < LOADS; ++i)
      w[i] = pack4(quantize1_exact(v[i].x, s), quantize1_exact(v[i].y, s),
                   quantize1_exact(v[i].z, s), quantize1_exact(v[i].w, s));
  }
#pragma unroll
  for (int i = 0; i < LOADS; ++i)
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(q_base + ((i >> 1) * PADW + 4 * (i & 1)) * 16),
                 "r"(w[i])
                 : "memory");
}

// The epilogue of a game from the accumulator registers: dequantisation,
// bias, the residual (zero on conv 0: adding it changes no value that ReLU
// lets through), ReLU, f32 out or on the last layer bf16; returns the max.
// Thread (warp wl, lane) holds rows row0 = wl*16 + lane/4 (+ 8) and columns
// 8*jn + col0 (+ 1), col0 = 2*(lane % 4), of the 64 x 2*NA accumulator (NA
// = 64: all 128 channels; 32: the 64 from wscale, bias and game_off on):
// acc[4*jn + 2*h + e] is row row0 + 8*h, column 8*jn + col0 + e, and
// res[2*jn + h] its residual pair. No branch inside, so that the NA / 2
// pairs interleave.
template <bool LAST, typename Acc, int NA>
__device__ __forceinline__ float epilogue(const Acc (&acc)[NA], const float2 (&res)[NA / 2],
                                          float s_act, const float* __restrict__ wscale,
                                          const float* __restrict__ bias, float* out,
                                          __nv_bfloat16* out_bf16, size_t game_off, int row0,
                                          int col0) {
  float m = 0.0f;
#pragma unroll
  for (int jn = 0; jn < NA / 4; ++jn) {
    const int n = 8 * jn + col0;
    const float2 wsc = __ldg(reinterpret_cast<const float2*>(wscale + n));
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + n));
    const float sc0 = __fmul_rn(s_act, wsc.x), sc1 = __fmul_rn(s_act, wsc.y);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float z0 = __fadd_rn(__fmul_rn(to_f32(acc[4 * jn + 2 * h]), sc0), b2.x);
      float z1 = __fadd_rn(__fmul_rn(to_f32(acc[4 * jn + 2 * h + 1]), sc1), b2.y);
      z0 = __fadd_rn(res[2 * jn + h].x, z0);
      z1 = __fadd_rn(res[2 * jn + h].y, z1);
      z0 = z0 > 0.0f ? z0 : 0.0f;
      z1 = z1 > 0.0f ? z1 : 0.0f;
      m = fmaxf(m, fmaxf(z0, z1));
      const size_t off = game_off + (row0 + 8 * h) * C + n;
      if constexpr (LAST) {
        *reinterpret_cast<__nv_bfloat162*>(out_bf16 + off) = __floats2bfloat162_rn(z0, z1);
      } else {
        *reinterpret_cast<float2*>(out + off) = make_float2(z0, z1);
      }
    }
  }
  return m;
}

// The residual at a thread's accumulator positions (see epilogue), or zero
template <int NR>
__device__ __forceinline__ void load_residual(float2 (&res)[NR], const float* resid,
                                              size_t game_off, int row0, int col0, int is_conv1) {
  if (is_conv1) {
#pragma unroll
    for (int i = 0; i < NR; ++i)
      res[i] = *reinterpret_cast<const float2*>(
          resid + game_off + (row0 + 8 * (i & 1)) * C + 8 * (i >> 1) + col0);
  } else {
#pragma unroll
    for (int i = 0; i < NR; ++i) res[i] = make_float2(0.0f, 0.0f);
  }
}

// mbarrier arrive (release) by this thread
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One bulk copy (TMA, no tensor map) of `bytes` contiguous bytes into
// shared memory, completing on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Thread 0 of the producer: half `hh` of game g into staging half hh
__device__ __forceinline__ void stage_half(uint32_t staging, uint32_t sbars, const float* in,
                                           int g, int hh) {
  mbar_expect_tx(sbars + hh * 8, HALF_BYTES);
  bulk_load(staging + hh * HALF_BYTES, in + (static_cast<size_t>(g) * P + hh * P / 2) * C,
            HALF_BYTES, sbars + hh * 8);
}

// One 3x3 conv of the trunk, warp-specialised. blockIdx.x picks the stripe
// of games (blockIdx.x, + gridDim.x, ...): the CTA's j-th game. Warpgroup 0
// (the producer) brings each game in f32 by bulk copies, half a game at a
// time into two staging halves, one half ahead, and quantizes it into
// slot j % STAGES of a ring of padded tiles; warpgroups 1 and 2 (the
// consumers) take the even and the odd j: products, then the epilogue.
//   wmap:  this layer's int8 weights (9 taps x C_out rows, C_in columns)
//   in:    f32 (B, 64, C) layer input, quantized here with amax[layer]
//   resid: f32 (B, 64, C) block input for conv 1 (may alias out), else null
//   out:   f32 (B, 64, C) output, unused on the last layer
//   out_bf16: bf16 (B, 64, C) output of the last layer, else null
//   wscale, bias: f32 (C,) this layer's weight scales and folded bias
//   amax:  f32 (num_layers, B / bg) per-block max of each layer's input
template <bool STAGE_BF16>
__global__ void __launch_bounds__(CONV_THREADS, 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ in,
                 const float* resid, float* out, __nv_bfloat16* __restrict__ out_bf16,
                 const float* __restrict__ wscale, const float* __restrict__ bias, float* amax,
                 int layer, int num_layers, int B, int bg, int is_conv1, int is_last) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;  // weights
  const uint32_t tiles = ws + W_BYTES;                        // the ring of padded tiles
  const uint32_t staging = tiles + STAGES * TILE_BYTES;       // two f32 half-games
  // barriers: full[STAGES], empty[STAGES], the staging halves', the weights'
  const uint32_t bars = staging + 2 * HALF_BYTES;
  const uint32_t sbars = bars + 2 * STAGES * 8;
  const uint32_t wbar = sbars + 2 * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, t = tid & 127;
  const float* amax_in = amax + layer * (B / bg);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + s * 8, 128);                 // full: the producer's threads
      mbar_init(bars + (STAGES + s) * 8, 128);      // empty: a consumer's threads
    }
    mbar_init(sbars, 1);
    mbar_init(sbars + 8, 1);
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(wbar, W_BYTES);
    for (int tap = 0; tap < TAPS; ++tap)  // 128 output channels x 128 input channels
      tma_load_2d(ws + tap * W_TAP_BYTES, &wmap, 0, tap * C, wbar);
  }
  __syncthreads();  // the barriers' init
  // Launched as a programmatic dependent of the previous conv: what comes
  // before reads only the weights, which no launch of the trunk writes;
  // wait here for the previous launch's activations and amax, and let the
  // next launch start its own set-up on SMs this one frees.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int step = gridDim.x;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // The producer. Thread t reads float4s t + 128 * i of a staged half and
    // writes their int8 codes at chunk (t & 31) / 4, word t % 4, column 1 +
    // 4 * (i & 1) + (t >> 5) of the half's rows (see quantize_into). The
    // halos stay zero.
    for (int i = t; i < STAGES * TILE_BYTES / 16; i += 128) st_zero16(tiles + i * 16);
    wg_sync(0);
    const uint32_t q_off =
        ((t & 31) >> 2) * CHUNK_BYTES + (t & 3) * 4 + (PADW + 1 + (t >> 5)) * 16;
    int g = blockIdx.x;
    if (t == 0 && g < B) {
      stage_half(staging, sbars, in, g, 0);
      stage_half(staging, sbars, in, g, 1);
    }
    for (int j = 0; g < B; ++j, g += step) {
      const int s = j % STAGES;
      mbar_wait(bars + (STAGES + s) * 8, ((j / STAGES) & 1) ^ 1);  // empty[s]
      const float s_act = act_scale(amax_in[g / bg]);
      const float y = __frcp_rn(s_act);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mbar_wait(sbars + hh * 8, j & 1);
        float4 v[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i)
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(v[i].x), "=f"(v[i].y), "=f"(v[i].z), "=f"(v[i].w)
                       : "r"(staging + hh * HALF_BYTES + (t + 128 * i) * 16)
                       : "memory");
        quantize_into(tiles + s * TILE_BYTES + q_off + hh * (S / 2) * PADW * 16, v, s_act, y);
        wg_sync(0);  // every producer thread has read the half
        if (t == 0 && g + step < B) stage_half(staging, sbars, in, g + step, hh);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
      mbar_arrive(bars + s * 8);                                      // full[s]
    }
    return;
  }

  // The consumers: warpgroup 1 + c takes the CTA's games j = c, c + 2, ...
  const int c = wg - 1;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  mbar_wait(wbar, 0);
  // this thread's rows and columns of the accumulator (see epilogue)
  const int row0 = wl * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  for (int j = c, g = blockIdx.x + c * step; g < B; j += 2, g += 2 * step) {
    const int s = j % STAGES;
    const uint32_t tile = tiles + s * TILE_BYTES;
    const float s_act = act_scale(amax_in[g / bg]);
    const size_t game_off = static_cast<size_t>(g) * P * C;
    float2 res[32];
    mbar_wait(bars + s * 8, (j / STAGES) & 1);  // full[s]

    using Acc = typename std::conditional<STAGE_BF16, float, int>::type;
    Acc acc[64];
    if constexpr (STAGE_BF16) {
      // tap k's products are issued before tap k - 1's are rounded and
      // added, in OFFSETS order
      int part[2][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int k = 0; k <= TAPS; ++k) {
        if (k < TAPS) issue_tap(part[k & 1], tile, ws, k);
        if (k == 0) continue;
        if (k < TAPS)
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        else
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        add_tap(acc, part[(k - 1) & 1]);
      }
      mbar_arrive(bars + (STAGES + s) * 8);  // empty[s]: the products are done
      load_residual(res, resid, game_off, row0, col0, is_conv1);
    } else {
      // all 36 k-steps in one chain: integer sums are exact in any order
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
        for (int ks = 0; ks < C / 32; ++ks)
          wgmma_m64n128k32(acc, a_desc(a_tap(tile, tap), ks), b_desc(ws + tap * W_TAP_BYTES, ks),
                           1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      load_residual(res, resid, game_off, row0, col0, is_conv1);  // in flight with the products
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
      mbar_arrive(bars + (STAGES + s) * 8);  // empty[s]: the products are done
    }

    float m = is_last ? epilogue<true>(acc, res, s_act, wscale, bias, out, out_bf16, game_off,
                                       row0, col0)
                      : epilogue<false>(acc, res, s_act, wscale, bias, out, out_bf16, game_off,
                                        row0, col0);
    m = warp_max(m);
    if (lane == 0 && layer + 1 < num_layers)
      atomicMax(reinterpret_cast<int*>(amax + (layer + 1) * (B / bg) + g / bg), __float_as_int(m));
  }
}

// The pre-pass: bf16 trunk input to f32, and the first layer's per-block
// amax (the others' are zeroed for the convs' atomicMax).
int prepass(const void* x, void* xf, void* amax, int B, int bg, int num_layers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float) * num_layers * (B / bg), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  prepass_kernel<<<B, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<float*>(xf), static_cast<float*>(amax), bg);
  return static_cast<int>(cudaGetLastError());
}

// One conv launch. w: this layer's (9, C_out, C_in) int8 weights. Returns 0,
// a cudaError_t, or minus a CUresult of the tensor-map encoder.
template <bool STAGE_BF16>
int launch(const void* in, const void* resid, void* out, void* out_bf16, const void* w,
           const void* wscale, const void* bias, void* amax, int layer, int num_layers, int B,
           int bg, int is_conv1, int is_last, void* stream) {
  static HostState host;
  if (B <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(w)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte loads, TMA
  auto kernel = int8_conv_kernel<STAGE_BF16>;
  // a box is one tap's 128 output channels x 128 input channels: rows of
  // 128 B, swizzled as wgmma reads them
  const WeightMap layout = {CU_TENSOR_MAP_DATA_TYPE_UINT8, {C, TAPS * C}, C, {C, C}};
  CUtensorMap wmap;
  int sms = 0;
  const int rc = prepare_launch(host, reinterpret_cast<const void*>(kernel), SMEM_BYTES, w,
                                layout, &wmap, &sms);
  if (rc != 0) return rc;
  // one CTA per SM (the shared memory), two consumers each; a programmatic
  // dependent of the previous launch on the stream (see the kernel)
  const int ctas = (B + 1) / 2 < sms ? (B + 1) / 2 : sms;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(CONV_THREADS);
  config.dynamicSmemBytes = SMEM_BYTES;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernel, wmap, static_cast<const float*>(in), static_cast<const float*>(resid),
      static_cast<float*>(out), static_cast<__nv_bfloat16*>(out_bf16),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<float*>(amax), layer, num_layers, B, bg, is_conv1, is_last);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace
}  // namespace int8conv
