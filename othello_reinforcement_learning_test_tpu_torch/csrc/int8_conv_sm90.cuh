// The conv body the int8 trunk kernels share (trunk_int8_dx3.cu,
// trunk_int8.cu, trunk_int8_m9.cu, trunk_int8_patch.cu, trunk_int8_flat.cu;
// int8_trunk_sm90.cuh, the one-launch trunk, takes its pieces), for Hopper
// (sm_90a): one 3x3 conv of S x S boards, C channels in and out, of the
// quantized trunk, with the dequantisation, the bias, the residual add
// (conv 1 of a block), ReLU and the next layer's per-block amax fused. A
// template on the board side S (4, 6 or 8) and the channel count C (a
// multiple of 16 up to 256), instantiated once in a library built for that
// shape (kernels/build.py passes TRUNK_S and TRUNK_C); the notes give S = 8,
// C = 128, and the streamed path's below them C = 256. For each block of
// `bg` games:
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
//   At other widths N = C (m64nCk32, legal for every multiple of 16 up to
//   128) and K = C rounded up to the k32 step: at C = 16, 48, 80, 112 the
//   tile's last chunk stays zero, so the padded K adds exact zeros.
// - The shift on the input through the A descriptor: a game's int8 codes
//   sit in shared memory zero-padded to 10x10 in the no-swizzle K-major
//   layout [16-channel chunk][padded position][16 B], an 8-row core matrix
//   being one board row, so tap (dy, dx) is a start offset of
//   ((1 + dy) * 10 + 1 + dx) * 16 bytes. Only interiors are written, so
//   the halos, zeroed once a launch, stay zero.
// - Boards smaller than 8x8 (S = 6, 4) keep M = 64: the padded tile gets a
//   pitch of 8 positions (S + 2 <= 8), so a core matrix is still 8
//   consecutive positions of one padded row; the rows and columns past S
//   are computed and dropped by the epilogue, which neither stores them nor
//   counts them in the amax (36 of 64 rows are kept at S = 6, 16 at S = 4).
// - Resident weights: a layer's 147,456 B fit one CTA. They arrive by TMA
//   once a launch, as nine [128 C_out][128 C_in] boxes (rows of 128 B,
//   128-byte swizzle) from the K-major (9, C_out, C_in) layout that
//   FusedInference makes once per weight set. Below 128-byte rows (C < 128)
//   the rows are cut in panels of 64 or 32 bytes, each its own box with
//   the swizzle of that width; a box past C_in is filled with zeros.
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
//
// Above 128 channels (int8_conv_stream_kernel; C <= 128 compiles to the
// kernel above, unchanged) a layer's int8 weights, 9 C^2 bytes (589,824 at
// C = 256), do not fit one CTA, so they are streamed:
// - A ring of SLOTS weight tiles in shared memory, each one panel (SW bytes
//   of C_in, 128 at C = 256) of one tap for all C output channels
//   (32,768 B), loaded by TMA; at C = 256 four slots beside two padded game
//   tiles (51,712 B) and two f32 staging parts (32,768 B): 216,656 B.
// - Both consumer warpgroups compute the same game and split its output
//   channels: consumer 0 the first 128 (m64n128k32, as at C = 128),
//   consumer 1 the other C - 128 (16 to 128, each a legal s8 wgmma width),
//   each from its rows of the same tile. A game takes the layer's 9 x
//   KP / SW tiles in (tap, panel) order: one weight pass a game, so a conv
//   reads B x 9 C^2 bytes of weights from L2 (604 MB at B = 1024, C = 256,
//   beside 64 MB of f32 input and output).
// - A tile is released once both consumers' products that read it are
//   done (wgmma.wait_group 1 after the next tile's products are issued,
//   then a 256-thread named barrier); consumer 0's first thread then loads
//   the tile SLOTS ahead into that slot, so SLOTS - 1 loads are in flight
//   behind the products.
// - The int32 sums stay exact: |acc| <= 9 x 256 x 127^2 < 2^31. STAGE_BF16:
//   a tap's panels accumulate into one of two partial sums from zero, and
//   the tap is rounded to bf16 and added once its last panel is done, in
//   OFFSETS order, while the next tap's products run.
// - The producer stages a game in parts of two board rows (16 KB at S = 8,
//   C = 256), so that a thread keeps at most 8 float4s, and quantizes into
//   two padded tiles (the game in products and the next).

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

// Shape<S, C>, THREADS, TAPS, STAGES, act_scale, warp_max and the pre-pass
#include "int8_trunk_common.cuh"

constexpr int CONV_THREADS = 3 * 128;             // a producer and two consumer warpgroups
// registers a thread: the producer gives up what it does not need to the
// consumers' accumulators (128 x 72 + 256 x 216 <= 65,536)
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;

// + 1024: the weights' alignment (the swizzle repeats every 1024 B or less);
// two half-games of f32 staging; the barriers: full and empty a tile, one a
// staging half, and the weights'
template <class G>
constexpr int conv_smem_bytes() {
  return 1024 + G::W_BYTES + STAGES * G::TILE_BYTES + 2 * G::HALF_BYTES + (2 * STAGES + 3) * 8;
}

// A: the game's 64 rows (8 a padded row) shifted by the tap, K-major without swizzle:
// core matrices one board row (8 positions x 16 B) apart in M by a padded
// row (160 B), in K by a channel chunk. B: the tap's [C_out][C_in] rows,
// K-major in panels of SW bytes with the swizzle of that width (128 B: one
// panel at C = 128), 8-row groups 8 * SW bytes apart in N; a k-step is 32 B
// into a panel's rows (the leading offset is unused). panel_bytes: one
// panel's rows.
template <class G>
__device__ __forceinline__ uint64_t a_desc(uint32_t a_tap, int ks) {
  return desc(a_tap + 2 * ks * G::CHUNK_BYTES, G::CHUNK_BYTES, G::PADW * 16, 0);
}
template <class G>
__device__ __forceinline__ uint64_t b_desc(uint32_t b_rows, int ks, int panel_bytes) {
  return desc(b_rows + (ks * 32 / G::SW) * panel_bytes + ks * 32 % G::SW, 16, 8 * G::SW,
              swizzle_layout(G::SW));
}

// the tile's start for tap k of OFFSETS (dy-major): (1 + dy, 1 + dx)
template <class G>
__device__ __forceinline__ uint32_t a_tap(uint32_t tile, int tap) {
  return tile + ((tap / 3) * G::PADW + tap % 3) * 16;
}

// Thread 0: a layer's weights for `rows` output channels from row `row` of
// the map (every panel of every tap) into dst, [tap][panel][rows][SW],
// completing on bar
template <class G>
__device__ __forceinline__ void load_taps(uint32_t dst, uint32_t bar, const CUtensorMap* map,
                                          int row, int rows) {
  for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
    for (int panel = 0; panel < G::PANELS; ++panel)
      tma_load_2d(dst + (tap * G::PANELS + panel) * rows * G::SW, map, panel * G::SW,
                  row + tap * G::C, bar);
}

// Issues tap k's KP / 32 k-steps from zero as one wgmma group into d.
template <class G>
__device__ __forceinline__ void issue_tap(int (&d)[G::C / 2], uint32_t tile, uint32_t ws,
                                          int tap) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < G::KP / 32; ++ks)
    wgmma_s8(d, a_desc<G>(a_tap<G>(tile, tap), ks),
             b_desc<G>(ws + tap * G::W_TAP_BYTES, ks, G::C * G::SW), ks);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc += f32(bf16(f32(d))), one rounded add each
template <int NA>
__device__ __forceinline__ void add_tap(float (&acc)[NA], int (&d)[NA]) {
  fence_operands(d);
#pragma unroll
  for (int i = 0; i < NA; ++i)
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

// Whether float4 i of producer thread t is one of a half-game's
template <class G>
__device__ __forceinline__ bool in_half(int t, int i) {
  return G::HALF_F4 % 128 == 0 || t + 128 * i < G::HALF_F4;
}

// Reads producer thread t's float4s of a staged half: float4s t + 128 * i
template <class G>
__device__ __forceinline__ void read_half(float4 (&v)[G::LOADS], uint32_t half, int t) {
#pragma unroll
  for (int i = 0; i < G::LOADS; ++i) {
    if (in_half<G>(t, i)) {
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[i].x), "=f"(v[i].y), "=f"(v[i].z), "=f"(v[i].w)
                   : "r"(half + (t + 128 * i) * 16)
                   : "memory");
    } else {
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Writes producer thread t's float4s of a half-game, divided by s and
// rounded (y = 1 / s), into the padded tile from q_half (the half's first
// board row): float4 f = t + 128 * i is position f / (C / 4) of the half,
// channels 4 * (f % (C / 4)) on, the chunk of 16 channels and its 4-byte
// word. At C = 128 thread t keeps chunk (t & 31) / 4, word t % 4, and float4
// i is board row i / 2 of the half, column 4 * (i % 2) + t / 32.
template <class G>
__device__ __forceinline__ void quantize_into(uint32_t q_half, const float4 (&v)[G::LOADS],
                                              float s, float y, int t) {
  constexpr int TPP = G::C / 4;  // float4s a position
  uint32_t w[G::LOADS];
  bool near = false;
#pragma unroll
  for (int i = 0; i < G::LOADS; ++i)
    w[i] = pack4(quantize1(v[i].x, y, near), quantize1(v[i].y, y, near),
                 quantize1(v[i].z, y, near), quantize1(v[i].w, y, near));
  if (near) {  // rare: this thread's values again, divided
#pragma unroll
    for (int i = 0; i < G::LOADS; ++i)
      w[i] = pack4(quantize1_exact(v[i].x, s), quantize1_exact(v[i].y, s),
                   quantize1_exact(v[i].z, s), quantize1_exact(v[i].w, s));
  }
#pragma unroll
  for (int i = 0; i < G::LOADS; ++i) {
    if (!in_half<G>(t, i)) continue;
    int p, cg;  // position of the half, float4 of the position
    if constexpr (128 % TPP == 0) {
      p = t / TPP + i * (128 / TPP);
      cg = t % TPP;
    } else {
      p = (t + 128 * i) / TPP;
      cg = (t + 128 * i) % TPP;
    }
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(q_half + (cg >> 2) * G::CHUNK_BYTES +
                                                     (cg & 3) * 4 + G::tile_pos(p) * 16),
                 "r"(w[i])
                 : "memory");
  }
}

// Accumulator row r of a thread (see epilogue): whether it is a board
// position (r / 8 and r % 8 below S) and which
template <class G>
__device__ __forceinline__ bool board_row(int r, int& pos) {
  if constexpr (G::S == 8) {
    pos = r;
    return true;
  }
  pos = (r >> 3) * G::S + (r & 7);
  return (r >> 3) < G::S && (r & 7) < G::S;
}

// The epilogue of a game from the accumulator registers: dequantisation,
// bias, the residual (zero on conv 0: adding it changes no value that ReLU
// lets through), ReLU, f32 out or on the last layer bf16; returns the max.
// Thread (warp wl, lane) holds rows row0 = wl*16 + lane/4 (+ 8) and columns
// 8*jn + col0 (+ 1), col0 = 2*(lane % 4), of the 64 x 2*NA accumulator (a
// wgmma's n; row r is board row r / 8, column r % 8): acc[4*jn + 2*h + e]
// is row row0 + 8*h, column 8*jn + col0 + e, and res[2*jn + h] its
// residual pair. The first 4 * NR columns are written (from wscale, bias
// and game_off on), and only rows of board positions. No branch inside at
// S = 8, so that the pairs interleave.
template <bool LAST, class G, typename Acc, int NA, int NR>
__device__ __forceinline__ float epilogue(const Acc (&acc)[NA], const float2 (&res)[NR],
                                          float s_act, const float* __restrict__ wscale,
                                          const float* __restrict__ bias, float* out,
                                          __nv_bfloat16* out_bf16, size_t game_off, int row0,
                                          int col0) {
  static_assert(4 * NR <= 2 * NA, "the columns written are the wgmma's");
  float m = 0.0f;
#pragma unroll
  for (int jn = 0; jn < NR / 2; ++jn) {
    const int n = 8 * jn + col0;
    const float2 wsc = __ldg(reinterpret_cast<const float2*>(wscale + n));
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + n));
    const float sc0 = __fmul_rn(s_act, wsc.x), sc1 = __fmul_rn(s_act, wsc.y);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int pos;
      if (!board_row<G>(row0 + 8 * h, pos)) continue;
      float z0 = __fadd_rn(__fmul_rn(to_f32(acc[4 * jn + 2 * h]), sc0), b2.x);
      float z1 = __fadd_rn(__fmul_rn(to_f32(acc[4 * jn + 2 * h + 1]), sc1), b2.y);
      z0 = __fadd_rn(res[2 * jn + h].x, z0);
      z1 = __fadd_rn(res[2 * jn + h].y, z1);
      z0 = z0 > 0.0f ? z0 : 0.0f;
      z1 = z1 > 0.0f ? z1 : 0.0f;
      m = fmaxf(m, fmaxf(z0, z1));
      const size_t off = game_off + pos * G::C + n;
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
template <class G, int NR>
__device__ __forceinline__ void load_residual(float2 (&res)[NR], const float* resid,
                                              size_t game_off, int row0, int col0, int is_conv1) {
  if (is_conv1) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      int pos;
      res[i] = board_row<G>(row0 + 8 * (i & 1), pos)
                   ? *reinterpret_cast<const float2*>(resid + game_off + pos * G::C +
                                                      8 * (i >> 1) + col0)
                   : make_float2(0.0f, 0.0f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NR; ++i) res[i] = make_float2(0.0f, 0.0f);
  }
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
template <class G>
__device__ __forceinline__ void stage_half(uint32_t staging, uint32_t sbars, const float* in,
                                           int g, int hh) {
  mbar_expect_tx(sbars + hh * 8, G::HALF_BYTES);
  bulk_load(staging + hh * G::HALF_BYTES,
            in + (static_cast<size_t>(g) * G::P + hh * G::P / 2) * G::C, G::HALF_BYTES,
            sbars + hh * 8);
}

// One 3x3 conv of the trunk, warp-specialised. blockIdx.x picks the stripe
// of games (blockIdx.x, + gridDim.x, ...): the CTA's j-th game. Warpgroup 0
// (the producer) brings each game in f32 by bulk copies, half a game at a
// time into two staging halves, one half ahead, and quantizes it into
// slot j % STAGES of a ring of padded tiles; warpgroups 1 and 2 (the
// consumers) take the even and the odd j: products, then the epilogue.
//   wmap:  this layer's int8 weights (9 taps x C_out rows, C_in columns)
//   in:    f32 (B, S * S, C) layer input, quantized here with amax[layer]
//   resid: f32 (B, S * S, C) block input for conv 1 (may alias out), else null
//   out:   f32 (B, S * S, C) output, unused on the last layer
//   out_bf16: bf16 (B, S * S, C) output of the last layer, else null
//   wscale, bias: f32 (C,) this layer's weight scales and folded bias
//   amax:  f32 (num_layers, B / bg) per-block max of each layer's input
template <int S, int C, bool STAGE_BF16>
__global__ void __launch_bounds__(CONV_THREADS, 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ in,
                 const float* resid, float* out, __nv_bfloat16* __restrict__ out_bf16,
                 const float* __restrict__ wscale, const float* __restrict__ bias, float* amax,
                 int layer, int num_layers, int B, int bg, int is_conv1, int is_last) {
  using G = Shape<S, C>;
  constexpr int NA = C / 2;  // accumulators a thread: all C channels of 64 rows
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;  // weights
  const uint32_t tiles = ws + G::W_BYTES;                     // the ring of padded tiles
  const uint32_t staging = tiles + STAGES * G::TILE_BYTES;    // two f32 half-games
  // barriers: full[STAGES], empty[STAGES], the staging halves', the weights'
  const uint32_t bars = staging + 2 * G::HALF_BYTES;
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
    mbar_expect_tx(wbar, G::W_BYTES);
    load_taps<G>(ws, wbar, &wmap, 0, C);  // C output channels x C input channels a tap
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
    // writes their int8 codes into the half's board rows (see
    // quantize_into). The halos and the padded channels stay zero.
    for (int i = t; i < STAGES * G::TILE_BYTES / 16; i += 128) st_zero16(tiles + i * 16);
    wg_sync(0);
    int g = blockIdx.x;
    if (t == 0 && g < B) {
      stage_half<G>(staging, sbars, in, g, 0);
      stage_half<G>(staging, sbars, in, g, 1);
    }
    for (int j = 0; g < B; ++j, g += step) {
      const int s = j % STAGES;
      mbar_wait(bars + (STAGES + s) * 8, ((j / STAGES) & 1) ^ 1);  // empty[s]
      const float s_act = act_scale(amax_in[g / bg]);
      const float y = __frcp_rn(s_act);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mbar_wait(sbars + hh * 8, j & 1);
        float4 v[G::LOADS];
        read_half<G>(v, staging + hh * G::HALF_BYTES, t);
        quantize_into<G>(tiles + s * G::TILE_BYTES + hh * (S / 2) * G::PADW * 16, v, s_act, y,
                         t);
        wg_sync(0);  // every producer thread has read the half
        if (t == 0 && g + step < B) stage_half<G>(staging, sbars, in, g + step, hh);
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
    const uint32_t tile = tiles + s * G::TILE_BYTES;
    const float s_act = act_scale(amax_in[g / bg]);
    const size_t game_off = static_cast<size_t>(g) * G::P * C;
    float2 res[NA / 2];
    mbar_wait(bars + s * 8, (j / STAGES) & 1);  // full[s]

    using Acc = typename std::conditional<STAGE_BF16, float, int>::type;
    Acc acc[NA];
    if constexpr (STAGE_BF16) {
      // tap k's products are issued before tap k - 1's are rounded and
      // added, in OFFSETS order
      int part[2][NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int k = 0; k <= TAPS; ++k) {
        if (k < TAPS) issue_tap<G>(part[k & 1], tile, ws, k);
        if (k == 0) continue;
        if (k < TAPS)
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        else
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        add_tap(acc, part[(k - 1) & 1]);
      }
      mbar_arrive(bars + (STAGES + s) * 8);  // empty[s]: the products are done
      load_residual<G>(res, resid, game_off, row0, col0, is_conv1);
    } else {
      // all 9 KP / 32 k-steps in one chain: integer sums are exact in any order
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0;
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
        for (int ks = 0; ks < G::KP / 32; ++ks)
          wgmma_s8(acc, a_desc<G>(a_tap<G>(tile, tap), ks),
                   b_desc<G>(ws + tap * G::W_TAP_BYTES, ks, C * G::SW), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      load_residual<G>(res, resid, game_off, row0, col0, is_conv1);  // in flight with the products
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
      mbar_arrive(bars + (STAGES + s) * 8);  // empty[s]: the products are done
    }

    float m = is_last ? epilogue<true, G>(acc, res, s_act, wscale, bias, out, out_bf16,
                                          game_off, row0, col0)
                      : epilogue<false, G>(acc, res, s_act, wscale, bias, out, out_bf16,
                                           game_off, row0, col0);
    m = warp_max(m);
    if (lane == 0 && layer + 1 < num_layers)
      atomicMax(reinterpret_cast<int*>(amax + (layer + 1) * (B / bg) + g / bg), __float_as_int(m));
  }
}

// ---- The streamed path (C > 128) ----

// Its geometry: the body's, staged in parts of two board rows (the body's
// "half" names a part here, so that read_half and quantize_into serve
// both), the consumers' channel split and the weight ring of tiles of
// ROWS_ output channels (all C, or a CTA's share in int8_trunk_sm90.cuh's
// split).
template <int S_, int C_, int ROWS_ = C_>
struct StreamShape : Shape<S_, C_> {
  using G = Shape<S_, C_>;
  static constexpr int NPART = S_ / 2;                      // staging parts a game: 4 at S = 8
  static constexpr int PART_POS = G::P / NPART;             // positions a part: two board rows
  static constexpr int HALF_BYTES = PART_POS * C_ * 4;      // a part in f32: 16,384
  static constexpr int HALF_F4 = HALF_BYTES / 16;           // its float4s
  static constexpr int LOADS = (HALF_F4 + 127) / 128;       // a producer thread's: 8
  static constexpr int N0 = 128, N1 = C_ - 128;             // consumer 0's and 1's channels
  static constexpr int TILES = 2;                           // padded game tiles
  static constexpr int ROWS = ROWS_;                        // output channels a tile
  static constexpr int SLOT_BYTES = ROWS_ * G::SW;          // a weight tile: 32,768
  static constexpr int STEPS = TAPS * G::PANELS;            // weight tiles a game: 18
  static constexpr int MAX_SLOTS = 8;
  // + 1024: the ring's alignment; the game tiles, two staging parts; the
  // barriers: full and empty a game tile, one a staging part, one a slot
  static constexpr int FIXED = 1024 + TILES * G::TILE_BYTES + 2 * HALF_BYTES +
                               (2 * TILES + 2 + MAX_SLOTS) * 8;
  static constexpr int FIT = (232448 - FIXED) / SLOT_BYTES;
  static constexpr int SLOTS = FIT < MAX_SLOTS ? FIT : MAX_SLOTS;  // 4
  static constexpr int SMEM_BYTES = FIXED + SLOTS * SLOT_BYTES;

  static_assert(C_ > 128 && C_ <= 256, "the streamed path: 144 to 256 channels");
  static_assert(S_ % 2 == 0 && LOADS <= 8, "parts of two board rows, 8 float4s a thread");
  static_assert(SLOTS >= 3, "a tile in products, one released, one loading");
  static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");
};

constexpr int PAIR_BAR = 4;  // the two consumers' named barrier (1 + wg are the warpgroups')

// The stream that a CTA's consumer pair shares: tiles [0, total), per_layer
// a layer from layer0, each ROWS output channels from row0 of a tap; and
// whether this thread loads them
struct Stream {
  uint32_t ws, wfull;
  const CUtensorMap* map;
  int total, per_layer, layer0, row0;
  bool loader;
};

// The loader: weight tile n of the stream into slot n % SLOTS. Tile n is
// step n % STEPS (tap, panel) of layer `layer0 + n / per_layer`.
template <class T>
__device__ __forceinline__ void load_tile(const Stream& st, int n) {
  const int slot = n % T::SLOTS, step = n % T::STEPS;
  const int layer = st.layer0 + n / st.per_layer;
  mbar_expect_tx(st.wfull + slot * 8, T::SLOT_BYTES);
  tma_load_2d(st.ws + slot * T::SLOT_BYTES, st.map, (step % T::PANELS) * T::SW,
              (layer * TAPS + step / T::PANELS) * T::C + st.row0, st.wfull + slot * 8);
}

// The first SLOTS tiles (thread 0, after the barriers' init)
template <class T>
__device__ __forceinline__ void load_first_tiles(const Stream& st) {
  for (int n = 0; n < T::SLOTS && n < st.total; ++n) load_tile<T>(st, n);
}

// Tile n is done in both consumers: the pair's barrier, then the loader
// fetches tile n + SLOTS into its slot
template <class T>
__device__ __forceinline__ void release_tile(const Stream& st, int n) {
  asm volatile("bar.sync %0, 256;\n" ::"n"(PAIR_BAR) : "memory");
  if (st.loader && n + T::SLOTS < st.total) load_tile<T>(st, n + T::SLOTS);
}

// A consumer's products of one game from the stream's tiles tile0 .. tile0 +
// STEPS - 1: N output channels from row `row` of each tile, into acc
// (int32 sums; STAGE_BF16: the f32 sum of the taps' bf16-rounded sums).
// N = 0: no products, only the pair's barrier for each tile.
template <bool STAGE_BF16, class T, int N, typename Acc>
__device__ __forceinline__ void stream_products(Acc (&acc)[N > 0 ? N / 2 : 1], const Stream& st,
                                                uint32_t tile, int tile0, int row) {
  if constexpr (N == 0) {
#pragma unroll 1
    for (int i = 0; i < T::STEPS; ++i) release_tile<T>(st, tile0 + i);
  } else {
    constexpr int NA = N / 2, KS = T::SW / 32;  // k-steps a tile
    int part[2][NA];  // STAGE_BF16: two taps' sums, one in flight while the other is added
    if constexpr (STAGE_BF16) {
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < T::STEPS; ++i) {
      const int n = tile0 + i, slot = n % T::SLOTS;
      const int tap = i / T::PANELS, panel = i % T::PANELS;
      const uint32_t b = st.ws + slot * T::SLOT_BYTES + row * T::SW;
      mbar_wait_or_trap(st.wfull + slot * 8, (n / T::SLOTS) & 1);
      if constexpr (STAGE_BF16) {
        fence_operands(part[tap & 1]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_s8(part[tap & 1], a_desc<T>(a_tap<T>(tile, tap), panel * KS + kk),
                   b_desc<T>(b, kk, 0), panel + kk > 0);
      } else {
        fence_operands(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_s8(acc, a_desc<T>(a_tap<T>(tile, tap), panel * KS + kk), b_desc<T>(b, kk, 0),
                   i + kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (i > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if constexpr (STAGE_BF16) {
          if (panel == 0) add_tap(acc, part[(tap - 1) & 1]);  // tap - 1 is whole
        } else {
          fence_operands(acc);
        }
        release_tile<T>(st, n - 1);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if constexpr (STAGE_BF16)
      add_tap(acc, part[(TAPS - 1) & 1]);
    else
      fence_operands(acc);
    release_tile<T>(st, tile0 + T::STEPS - 1);
  }
}

// A consumer's share of one game: the products of its N channels, rows
// tile_row on of each tile and channels n_first on of the output, the game
// tile's release (empty), the epilogue (see epilogue) and the next layer's
// amax. N = 0 (a CTA share that the other consumer covers): the barriers
// and the release only.
template <bool STAGE_BF16, class T, int N>
__device__ __forceinline__ void stream_game(const Stream& st, uint32_t tile, uint32_t empty,
                                            int tile0, int tile_row, int n_first, float s_act,
                                            const float* wscale, const float* bias,
                                            const float* resid, float* out,
                                            __nv_bfloat16* out_bf16, size_t game_off, int row0,
                                            int col0, int is_conv1, int is_last,
                                            float* amax_next) {
  using Acc = typename std::conditional<STAGE_BF16, float, int>::type;
  if constexpr (N == 0) {
    Acc none[1];
    stream_products<STAGE_BF16, T, 0>(none, st, tile, tile0, tile_row);
    mbar_arrive(empty);
  } else {
    Acc acc[N / 2];
    float2 res[N / 4];
    stream_products<STAGE_BF16, T, N>(acc, st, tile, tile0, tile_row);
    mbar_arrive(empty);  // this consumer's products of the game are done
    load_residual<T>(res, resid, game_off + n_first, row0, col0, is_conv1);
    float m = is_last ? epilogue<true, T>(acc, res, s_act, wscale + n_first, bias + n_first,
                                          out, out_bf16, game_off + n_first, row0, col0)
                      : epilogue<false, T>(acc, res, s_act, wscale + n_first, bias + n_first,
                                           out, out_bf16, game_off + n_first, row0, col0);
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0 && amax_next)
      atomicMax(reinterpret_cast<int*>(amax_next), __float_as_int(m));
  }
}

// Thread 0 of the producer: part `part` of game g into staging buffer b
template <class T>
__device__ __forceinline__ void stage_part(uint32_t staging, uint32_t sbars, const float* in,
                                           int g, int part, int b) {
  mbar_expect_tx(sbars + b * 8, T::HALF_BYTES);
  bulk_load(staging + b * T::HALF_BYTES,
            in + (static_cast<size_t>(g) * T::P + part * T::PART_POS) * T::C, T::HALF_BYTES,
            sbars + b * 8);
}

// The producer's work on one game: its NPART parts, each read from staging
// buffer u & 1 (u = the CTA's part count, j * NPART + part), quantized into
// the padded tile and replaced by part u + 2 where `next_game(u + 2)` gives
// its game (negative: none). Then the tile is full.
template <class T, typename NextGame>
__device__ __forceinline__ void produce_game(uint32_t tile, uint32_t full, uint32_t staging,
                                             uint32_t sbars, const float* in, int j, float s_act,
                                             int t, NextGame next_game) {
  const float y = __frcp_rn(s_act);
#pragma unroll 1
  for (int pp = 0; pp < T::NPART; ++pp) {
    const int u = j * T::NPART + pp, b = u & 1;
    mbar_wait_or_trap(sbars + b * 8, (u >> 1) & 1);
    float4 v[T::LOADS];
    read_half<T>(v, staging + b * T::HALF_BYTES, t);
    quantize_into<T>(tile + pp * (T::PART_POS / T::S) * T::PADW * 16, v, s_act, y, t);
    wg_sync(0);  // every producer thread has read the part
    if (t == 0) {
      const int g2 = next_game((u + 2) / T::NPART);
      if (g2 >= 0) stage_part<T>(staging, sbars, in, g2, (u + 2) % T::NPART, b);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  mbar_arrive(full);
}

// One 3x3 conv of the trunk above 128 channels: the body's function and
// arguments (see int8_conv_kernel), the weights streamed (see the note).
// CTA blockIdx.x takes games blockIdx.x, + gridDim.x, ...; warpgroup 0
// stages and quantizes them into two padded tiles, warpgroups 1 and 2 both
// compute each, output channels [0, 128) and [128, C).
template <int S, int C, bool STAGE_BF16>
__global__ void __launch_bounds__(CONV_THREADS, 1)
int8_conv_stream_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ in,
                        const float* resid, float* out, __nv_bfloat16* __restrict__ out_bf16,
                        const float* __restrict__ wscale, const float* __restrict__ bias,
                        float* amax, int layer, int num_layers, int B, int bg, int is_conv1,
                        int is_last) {
  using T = StreamShape<S, C>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;   // the weight ring
  const uint32_t tiles = ws + T::SLOTS * T::SLOT_BYTES;         // the padded game tiles
  const uint32_t staging = tiles + T::TILES * T::TILE_BYTES;    // two f32 parts
  const uint32_t bars = staging + 2 * T::HALF_BYTES;            // full[TILES], empty[TILES]
  const uint32_t sbars = bars + 2 * T::TILES * 8;               // the staging parts'
  const uint32_t wfull = sbars + 2 * 8;                         // the slots'
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, t = tid & 127;
  const int step = gridDim.x;
  const int n_games = blockIdx.x < B ? (B - 1 - blockIdx.x) / step + 1 : 0;
  const Stream st = {ws, wfull, &wmap, n_games * T::STEPS, n_games * T::STEPS, 0, 0, tid == 128};
  const float* amax_in = amax + layer * (B / bg);

  if (tid == 0) {
    for (int s = 0; s < T::TILES; ++s) {
      mbar_init(bars + s * 8, 128);                 // full: the producer's threads
      mbar_init(bars + (T::TILES + s) * 8, 256);    // empty: both consumers' threads
    }
    mbar_init(sbars, 1);
    mbar_init(sbars + 8, 1);
    for (int s = 0; s < T::SLOTS; ++s) mbar_init(wfull + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_first_tiles<T>(st);
  }
  __syncthreads();  // the barriers' init
  // a programmatic dependent of the previous conv, as int8_conv_kernel
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    for (int i = t; i < T::TILES * T::TILE_BYTES / 16; i += 128) st_zero16(tiles + i * 16);
    wg_sync(0);
    if (t == 0 && n_games > 0) {
      stage_part<T>(staging, sbars, in, blockIdx.x, 0, 0);
      stage_part<T>(staging, sbars, in, blockIdx.x, 1, 1);
    }
    for (int j = 0; j < n_games; ++j) {
      const int s = j % T::TILES, g = blockIdx.x + j * step;
      mbar_wait_or_trap(bars + (T::TILES + s) * 8, ((j / T::TILES) & 1) ^ 1);  // empty[s]
      produce_game<T>(tiles + s * T::TILE_BYTES, bars + s * 8, staging, sbars, in, j,
                      act_scale(amax_in[g / bg]), t, [&](int j2) {
                        return j2 < n_games ? static_cast<int>(blockIdx.x) + j2 * step : -1;
                      });
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;
  const int row0 = wl * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  for (int j = 0; j < n_games; ++j) {
    const int s = j % T::TILES, g = blockIdx.x + j * step;
    const uint32_t tile = tiles + s * T::TILE_BYTES, empty = bars + (T::TILES + s) * 8;
    const float s_act = act_scale(amax_in[g / bg]);
    const size_t game_off = static_cast<size_t>(g) * T::P * C;
    float* amax_next = layer + 1 < num_layers ? amax + (layer + 1) * (B / bg) + g / bg : nullptr;
    mbar_wait_or_trap(bars + s * 8, (j / T::TILES) & 1);  // full[s]
    if (c == 0)
      stream_game<STAGE_BF16, T, T::N0>(st, tile, empty, j * T::STEPS, 0, 0, s_act, wscale,
                                        bias, resid, out, out_bf16, game_off, row0, col0,
                                        is_conv1, is_last, amax_next);
    else
      stream_game<STAGE_BF16, T, T::N1>(st, tile, empty, j * T::STEPS, T::N0, T::N0, s_act,
                                        wscale, bias, resid, out, out_bf16, game_off, row0,
                                        col0, is_conv1, is_last, amax_next);
  }
}

// The pre-pass: bf16 trunk input to f32, and the first layer's per-block
// amax (the others' are zeroed for the convs' atomicMax).
template <int S, int C>
int prepass(const void* x, void* xf, void* amax, int B, int bg, int num_layers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float) * num_layers * (B / bg), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  prepass_kernel<S, C><<<B, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                              static_cast<float*>(xf),
                                              static_cast<float*>(amax), bg);
  return static_cast<int>(cudaGetLastError());
}

// A conv launch's kernel and shared memory: the streamed kernel's above 128
// channels
template <int S, int C, bool STAGE_BF16>
auto conv_kernel() {
  if constexpr (C > 128)
    return int8_conv_stream_kernel<S, C, STAGE_BF16>;
  else
    return int8_conv_kernel<S, C, STAGE_BF16>;
}
template <int S, int C>
constexpr int conv_launch_smem() {
  if constexpr (C > 128)
    return StreamShape<S, C>::SMEM_BYTES;
  else
    return conv_smem_bytes<Shape<S, C>>();
}

// One conv launch. w: this layer's (9, C_out, C_in) int8 weights. Returns 0,
// a cudaError_t, or minus a CUresult of the tensor-map encoder.
template <int S, int C, bool STAGE_BF16>
int launch(const void* in, const void* resid, void* out, void* out_bf16, const void* w,
           const void* wscale, const void* bias, void* amax, int layer, int num_layers, int B,
           int bg, int is_conv1, int is_last, void* stream) {
  using G = Shape<S, C>;
  // above 128 channels the streamed kernel; C <= 128 compiles as before
  constexpr bool STREAM = C > 128;
  constexpr int SMEM_BYTES = conv_launch_smem<S, C>();
  static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");
  static HostState host;
  if (B <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(w)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte loads, TMA
  auto kernel = conv_kernel<S, C, STAGE_BF16>();
  // a box is one panel of one tap: C output channels x SW input channels,
  // swizzled as wgmma reads them (128 x 128 at C = 128)
  const WeightMap layout = {CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            {C, TAPS * C},
                            C,
                            {G::SW, C},
                            swizzle_mode(G::SW)};
  CUtensorMap wmap;
  int sms = 0;
  const int rc = prepare_launch(host, reinterpret_cast<const void*>(kernel), SMEM_BYTES, w,
                                layout, &wmap, &sms);
  if (rc != 0) return rc;
  // one CTA per SM (the shared memory), two consumers each, on alternate
  // games (streamed: both on every game); a programmatic dependent of the
  // previous launch on the stream (see the kernel)
  const int per_cta = STREAM ? B : (B + 1) / 2;
  const int ctas = per_cta < sms ? per_cta : sms;
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
