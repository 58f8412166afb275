// The conv body the two bf16 trunk kernels share (trunk_matmul9.cu,
// trunk_wide.cu), for Hopper (sm_90a): one 3x3 conv of S x S boards, C
// bf16 channels in and out, f32 sums, with the bias, the residual add (conv
// 1 of a block), ReLU and the bf16 rounding fused. A template on the board
// side S (4, 6 or 8) and the channel count C (a multiple of 16 up to 256),
// instantiated once in a library built for that shape (kernels/build.py
// passes TRUNK_S and TRUNK_C); 8x8 boards and C = 128 below unless stated.
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
//   input channels in 8 steps per tap. At other widths a CTA takes NH = 64,
//   32 or 16 output channels, the largest that divides C (m64nNHk16, C / NH
//   CTAs across the channels), and K = C in C / 16 steps.
// - The shift on the input through the A descriptor. A game's activations
//   sit in shared memory zero-padded to 10x10 in the no-swizzle canonical
//   layout [8-channel chunk][padded position][8 bf16]: an 8-row core matrix
//   is one board row of 8 consecutive padded positions, the next board row
//   is 10 positions (160 B) on, so tap (dy, dx) is only a start-address
//   offset of (dy * 10 + dx) * 16 bytes.
// - Boards smaller than 8x8 (S = 6, 4) keep M = 64: the padded tile gets a
//   pitch of 8 positions (S + 2 <= 8), so a core matrix is still 8
//   consecutive positions of one padded row, and the rows and columns past
//   S are computed from whatever the tile holds there and dropped by the
//   epilogue (36 of 64 rows are kept at S = 6, 16 at S = 4). The halo ring
//   the kept rows read is zeroed as at S = 8.
// - Resident weights: a CTA keeps the nine taps of its 64 output channels
//   (147,456 B) for the whole launch, loaded once by TMA as nine boxes of
//   [128 C_in][64 C_out] (rows of 128 B, 128-byte swizzle), which wgmma
//   reads as an N-major B: C_out contiguous, no transpose. At NH = 32 or 16
//   the rows are 64 or 32 B, with the swizzle of that width. A layer's
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
// Above 128 channels (bf16_conv_stream_kernel; C <= 128 compiles to the
// kernel below as before) the CTA's nine taps, 9 x C x NH x 2 bytes
// (294,912 at C = 256, NH = 64), do not fit beside two game tiles of
// 51,712 B, so they are streamed:
// - A ring of SLOTS one-tap tiles ([C_in][NH C_out], 32,768 B at C = 256;
//   three beside the game tiles and residuals, 219,264 B), each loaded by
//   TMA as the resident taps are, by a loader warp (the CTA's ninth) that
//   waits for a slot's release and refills it.
// - The two warpgroups keep their alternate games and both read every
//   tile: one weight pass serves two games, so a conv reads B / 2 x 9 x C x
//   C x 2 bytes of weights from L2 (302 MB at B = 1024, C = 256). A slot is
//   released when both warpgroups' products that read it are done (an
//   mbarrier of 256 arrivals, after wgmma.wait_group 1); a warpgroup
//   without a game in the last pass still takes and releases the tiles.
// - A game's activations are loaded into its tile when its products start,
//   not during the previous game's (16 loads a thread at C = 256 would not
//   fit beside the accumulators); the other warpgroup's products overlap
//   the load as far as the ring lets it run ahead.
// - The sums keep their order: wide adds each tap's rounded product in
//   OFFSETS order; matmul9 chains all 9C / 16 k-steps on the bias.
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

constexpr int TAPS = 9;
constexpr int CONSUMERS = 2;                     // warpgroups, one game each
constexpr int THREADS = CONSUMERS * 128;

// The geometry of one instance: S x S boards, C channels in and out.
template <int S_, int C_>
struct Shape {
  static constexpr int S = S_, C = C_;
  static constexpr int P = S * S;                       // positions per game
  // the padded tile's pitch: S + 2, at least a core matrix's 8 rows
  static constexpr int PADW = S + 2 > 8 ? S + 2 : 8;
  // output channels per CTA, the largest of 64, 32, 16 that divides C
  static constexpr int NH = C % 64 == 0 ? 64 : C % 32 == 0 ? 32 : 16;
  static constexpr int GROUPS = C / NH;                 // CTAs across the channels
  static constexpr int NA = NH / 2;                     // accumulators a thread
  static constexpr int KCH = C / 8;                     // 16-byte channel chunks
  // every padded position a tap reads, (0, 0) to (9, 9) in the pitch: 100
  // at S = 8; then one more, so that the chunks a quarter warp writes at
  // one position fall in distinct banks
  static constexpr int CHUNK_BYTES = (9 * PADW + 10 + 1) * 16;
  static constexpr int STAGE_BYTES = KCH * CHUNK_BYTES;  // one game's padded tile: 25,856
  static constexpr int EP_STRIDE = NH + 8;              // f32 per row of the epilogue's staging
  // the tile, or the epilogue's staging of 64 rows where that is larger
  static constexpr int TILE_BYTES =
      STAGE_BYTES > 64 * EP_STRIDE * 4 ? STAGE_BYTES : 64 * EP_STRIDE * 4;
  static constexpr int W_TAP_BYTES = C * NH * 2;         // one tap: [C_in][NH C_out], 16,384
  static constexpr int W_BYTES = TAPS * W_TAP_BYTES;     // 147,456
  static constexpr int SW = NH * 2;                      // bytes a weight row, its swizzle
  static constexpr int PIECES = P * KCH;                 // 16-byte pieces of a game's input
  static constexpr int LOADS = (PIECES + 127) / 128;     // a thread's per game: 8
  static constexpr int RES_PIECES = P * NH / 8;          // of a game's CTA channels
  static constexpr int RES_BYTES = RES_PIECES * 16;      // a game's residual: 8,192
  static constexpr int EP_PIECES = (RES_PIECES + 127) / 128;  // a thread's per game: 4
  static constexpr int RING = 4 * S + 4;                 // the halo's positions a chunk: 36
  // + 1024: the weights' alignment (the swizzle repeats every 1024 B or less)
  static constexpr int SMEM_BYTES = 1024 + W_BYTES + CONSUMERS * (TILE_BYTES + RES_BYTES) + 8;

  static_assert(S == 4 || S == 6 || S == 8, "board side 4, 6 or 8");
  static_assert(C % 16 == 0 && C >= 16 && C <= 256, "channels a multiple of 16 up to 256");

  // the padded tile's position of board position p
  static __device__ __forceinline__ int tile_pos(int p) {
    return (p / S + 1) * PADW + p % S + 1;
  }
  // the row of the 64-row accumulator (8 a padded row) of board position p
  static __device__ __forceinline__ int acc_row(int p) {
    if constexpr (S == 8) return p;
    return (p / S) * 8 + p % S;
  }
};

// A: the game's 64 rows (8 a padded row) shifted by the tap, K-major without swizzle:
// core matrices one board row (8 positions x 16 B) apart in M by a padded
// row (160 B), in K by a channel chunk. B: the tap's [C_in][NH C_out] rows
// of 2 * NH bytes, N-major with the swizzle of that width, 8-row groups
// 8 rows apart in K (the leading offset is unused: N is one swizzle row).
template <class G>
__device__ __forceinline__ uint64_t a_desc(uint32_t a_tap, int ks) {
  return desc(a_tap + 2 * ks * G::CHUNK_BYTES, G::CHUNK_BYTES, G::PADW * 16, 0);
}
template <class G>
__device__ __forceinline__ uint64_t b_desc(uint32_t b_tap, int ks) {
  return desc(b_tap + ks * 16 * G::SW, 16, 8 * G::SW, swizzle_layout(G::SW));
}

// Zeroes the halo of a padded tile: the 4S + 4 border positions of each
// chunk around the board, thread t of the warpgroup taking border pieces t,
// t + 128, ...
template <class G>
__device__ __forceinline__ void zero_halo(uint32_t tile, int t) {
  constexpr int S = G::S, W = G::PADW;
#pragma unroll
  for (int h = t; h < G::KCH * G::RING; h += 128) {
    const int b = h % G::RING;  // top row, bottom row, left column, right column
    const int pos = b < S + 2           ? b
                    : b < 2 * S + 4     ? (S + 1) * W - (S + 2) + b
                    : b < 3 * S + 4     ? (b - (2 * S + 3)) * W
                                        : (b - (3 * S + 3)) * W + S + 1;
    st_zero16(tile + (h / G::RING) * G::CHUNK_BYTES + pos * 16);
  }
}

// Issues one tap's C / 16 k16 steps into d (from zero) as one wgmma group.
template <class G>
__device__ __forceinline__ void issue_tap(float (&d)[G::NA], uint32_t a_tap, uint32_t b_tap) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < G::C / 16; ++ks)
    wgmma_bf16(d, a_desc<G>(a_tap, ks), b_desc<G>(b_tap, ks), ks);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc += bf16(d) elementwise, one rounded add each
template <int NA>
__device__ __forceinline__ void add_tap(float (&acc)[NA], float (&d)[NA]) {
  fence_operands(d);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const float2 v = __bfloat1622float2(__floats2bfloat162_rn(d[i], d[i + 1]));
    acc[i] = __fadd_rn(acc[i], v.x);
    acc[i + 1] = __fadd_rn(acc[i + 1], v.y);
  }
}

// The epilogue of game g through its tile, so that it reads the residual
// and writes out in whole rows of the CTA's NH channels: the sums as f32
// [row][NH + 8] (rows padded for conflict-free 8-byte writes), then 16-byte
// pieces: position piece / (NH / 8), channels 8 * (piece % (NH / 8)) ...,
// from the position's accumulator row; the residual (conv 1) from res,
// where cp.async brought it. Leaves the tile to the warpgroup. The streamed
// kernel's; bf16_conv_kernel takes the same steps inline.
template <class G>
__device__ __forceinline__ void store_game(const float (&acc)[G::NA], uint32_t stage, uint32_t res,
                                           int is_conv1, __nv_bfloat16* out, int g, int n_base,
                                           int wg, int wl, int lane, int t) {
  constexpr int P = G::P, C = G::C, NH = G::NH, NPC = NH / 8;
  wg_sync(wg);  // every warp's products are done with the tile
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int jn = 0; jn < NH / 8; ++jn)
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                       stage + ((wl * 16 + h * 8 + (lane >> 2)) * G::EP_STRIDE + jn * 8 +
                                2 * (lane & 3)) * 4),
                   "f"(acc[4 * jn + 2 * h]), "f"(acc[4 * jn + 2 * h + 1])
                   : "memory");
  wg_sync(wg);
  if (is_conv1) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < G::EP_PIECES; ++i) {
    const int piece = t + 128 * i, p = piece / NPC, c = (piece % NPC) * 8;
    if (G::RES_PIECES % 128 != 0 && piece >= G::RES_PIECES) continue;
    const int row = G::acc_row(p);
    float v[8];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(stage + (row * G::EP_STRIDE + c) * 4)
                 : "memory");
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7])
                 : "r"(stage + (row * G::EP_STRIDE + c + 4) * 4)
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
}

// One 3x3 conv. blockIdx.x picks the NH output channels, blockIdx.y the
// stripe of games (blockIdx.y, + gridDim.y, ...), warpgroup wg its
// alternate games (stripe game wg, wg + 2, ...).
//   wmap:  this layer's weights, bf16: HWIO (9C rows, C cols), or wide
//          (C rows, 9C cols) when WIDE
//   in:    bf16 (B, S * S, C) conv input
//   resid: bf16 (B, S * S, C) block input for conv 1 (may alias out), else null
//   out:   bf16 (B, S * S, C) output
//   bias:  f32 (C,) this layer's folded bias
template <int S, int C, bool ROUND_TAPS, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
bf16_conv_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ in,
                 const __nv_bfloat16* resid, __nv_bfloat16* out, const float* __restrict__ bias,
                 int B, int is_conv1) {
  using G = Shape<S, C>;
  constexpr int P = G::P, NH = G::NH, NA = G::NA, KCH = G::KCH, LOADS = G::LOADS;
  constexpr int NPC = NH / 8;  // 16-byte pieces of a position's CTA channels
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;  // weights
  const uint32_t wbar = ws + G::W_BYTES + CONSUMERS * (G::TILE_BYTES + G::RES_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, t = tid & 127;
  const uint32_t stage = ws + G::W_BYTES + wg * G::TILE_BYTES;  // this warpgroup's padded tile
  const uint32_t res =
      ws + G::W_BYTES + CONSUMERS * G::TILE_BYTES + wg * G::RES_BYTES;  // its residual
  const int n_base = blockIdx.x * NH;

  if (tid == 0) {
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(wbar, G::W_BYTES);
    for (int tap = 0; tap < TAPS; ++tap)  // C input channels x NH output channels
      tma_load_2d(ws + tap * G::W_TAP_BYTES, &wmap, WIDE ? tap * C + n_base : n_base,
                  WIDE ? 0 : tap * C, wbar);
  }
  zero_halo<G>(stage, t);
  // thread t loads and stores 16-byte pieces t + 128 * i of a game: position
  // piece / KCH, channel chunk piece % KCH (past the game's pieces: none)
  uint32_t dst[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int piece = t + 128 * i;
    dst[i] = stage + (piece % KCH) * G::CHUNK_BYTES + G::tile_pos(piece / KCH) * 16;
  }
  // thread (warp wl, lane) holds rows wl*16 + lane/4 (+ 8) and columns
  // 8*jn + 2*(lane % 4) (+ 1) of the warpgroup's 64 x NH accumulator
  float bias_v[NA / 2];
#pragma unroll
  for (int jn = 0; jn < NH / 8; ++jn) {
    bias_v[2 * jn] = bias[n_base + jn * 8 + 2 * (lane & 3)];
    bias_v[2 * jn + 1] = bias[n_base + jn * 8 + 2 * (lane & 3) + 1];
  }
  float part[2][NA];  // wide: two taps' products, one in flight while the other is added
#pragma unroll
  for (int i = 0; i < NA; ++i) part[0][i] = part[1][i] = 0.0f;
  __syncthreads();  // the barrier's init

  int g = blockIdx.y + wg * gridDim.y;
  const int step = CONSUMERS * gridDim.y;
  uint4 next[LOADS];
  if (g < B) {
    const uint4* src = reinterpret_cast<const uint4*>(in + static_cast<size_t>(g) * P * C);
#pragma unroll
    for (int i = 0; i < LOADS; ++i)
      if (G::PIECES % 128 == 0 || t + 128 * i < G::PIECES) next[i] = __ldg(src + t + 128 * i);
#pragma unroll
    for (int i = 0; i < LOADS; ++i)
      if (G::PIECES % 128 == 0 || t + 128 * i < G::PIECES)
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
      for (int i = 0; i < G::EP_PIECES; ++i) {
        const int piece = t + 128 * i;
        if (G::RES_PIECES % 128 == 0 || piece < G::RES_PIECES)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(res + piece * 16),
                       "l"(resid + (static_cast<size_t>(g) * P + piece / NPC) * C + n_base +
                           (piece % NPC) * 8)
                       : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (g_next < B) {  // in flight during this game's products
      const uint4* src = reinterpret_cast<const uint4*>(in + static_cast<size_t>(g_next) * P * C);
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        if (G::PIECES % 128 == 0 || t + 128 * i < G::PIECES) next[i] = __ldg(src + t + 128 * i);
    }

    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = bias_v[(i >> 2) * 2 + (i & 1)];
    if constexpr (ROUND_TAPS) {
      // tap k's products are issued before tap k - 1's are rounded and
      // added, in OFFSETS order (dy-major): tap (dy, dx) reads the tile
      // from (1 + dy, 1 + dx)
#pragma unroll
      for (int tap = 0; tap <= TAPS; ++tap) {
        if (tap < TAPS)
          issue_tap<G>(part[tap & 1], stage + ((tap / 3) * G::PADW + tap % 3) * 16,
                       ws + tap * G::W_TAP_BYTES);
        if (tap == 0) continue;
        if (tap < TAPS)
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        else
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        add_tap(acc, part[(tap - 1) & 1]);
      }
    } else {
      // all 9C / 16 steps in one chain on the bias: the tensor cores' order
      // of the 9C products and the bias, inside sum_error_bound
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks)
          wgmma_bf16(acc, a_desc<G>(stage + ((tap / 3) * G::PADW + tap % 3) * 16, ks),
                     b_desc<G>(ws + tap * G::W_TAP_BYTES, ks), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
    }

    // The epilogue through the tile, so that it reads resid and writes out
    // in whole rows of the CTA's NH channels: the sums as f32 [row][NH + 8]
    // (rows padded for conflict-free 8-byte writes), then 16-byte pieces:
    // position piece / (NH / 8), channels 8 * (piece % (NH / 8)) ..., from
    // the position's accumulator row
    wg_sync(wg);  // every warp's products are done with the tile
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jn = 0; jn < NH / 8; ++jn)
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         stage + ((wl * 16 + h * 8 + (lane >> 2)) * G::EP_STRIDE + jn * 8 +
                                  2 * (lane & 3)) * 4),
                     "f"(acc[4 * jn + 2 * h]), "f"(acc[4 * jn + 2 * h + 1])
                     : "memory");
    wg_sync(wg);
    if (is_conv1) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < G::EP_PIECES; ++i) {
      const int piece = t + 128 * i, p = piece / NPC, c = (piece % NPC) * 8;
      if (G::RES_PIECES % 128 != 0 && piece >= G::RES_PIECES) continue;
      const int row = G::acc_row(p);
      float v[8];
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "r"(stage + (row * G::EP_STRIDE + c) * 4)
                   : "memory");
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7])
                   : "r"(stage + (row * G::EP_STRIDE + c + 4) * 4)
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
      zero_halo<G>(stage, t);
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        if (G::PIECES % 128 == 0 || t + 128 * i < G::PIECES)
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst[i]),
                       "r"(next[i].x), "r"(next[i].y), "r"(next[i].z), "r"(next[i].w)
                       : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);  // the next game's tile is written
  }
}

// ---- The streamed path (C > 128) ----

// Its geometry: the body's, the ring of one-tap weight tiles and the loader
// warp (see the note)
template <int S_, int C_>
struct StreamShape : Shape<S_, C_> {
  using G = Shape<S_, C_>;
  static constexpr int THREADS = CONSUMERS * 128 + 32;  // the consumers and the loader warp
  static constexpr int MAX_SLOTS = 8;
  // + 1024: the ring's alignment; the two game tiles and residuals; the
  // barriers: full and empty a slot
  static constexpr int FIXED =
      1024 + CONSUMERS * (G::TILE_BYTES + G::RES_BYTES) + 2 * MAX_SLOTS * 8;
  static constexpr int FIT = (232448 - FIXED) / G::W_TAP_BYTES;
  static constexpr int SLOTS = FIT < MAX_SLOTS ? FIT : MAX_SLOTS;  // 3 at C = 256
  static constexpr int SMEM_BYTES = FIXED + SLOTS * G::W_TAP_BYTES;
  static_assert(C_ > 128, "the streamed path: 144 to 256 channels");
  static_assert(SLOTS >= 2, "a tile in products, one loading");
  static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");
};

// One 3x3 conv above 128 channels: the function and arguments of
// bf16_conv_kernel, the CTA's taps streamed (see the note). Warps 0-7 are
// the two warpgroups, warp 8 the loader.
template <int S, int C, bool ROUND_TAPS, bool WIDE>
__global__ void __launch_bounds__(StreamShape<S, C>::THREADS, 1)
bf16_conv_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __nv_bfloat16* __restrict__ in, const __nv_bfloat16* resid,
                        __nv_bfloat16* out, const float* __restrict__ bias, int B, int is_conv1) {
  using G = StreamShape<S, C>;
  constexpr int P = G::P, NH = G::NH, NA = G::NA, KCH = G::KCH, LOADS = G::LOADS;
  constexpr int NPC = NH / 8, SLOTS = G::SLOTS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;         // the weight ring
  const uint32_t tiles = ws + SLOTS * G::W_TAP_BYTES;                 // the game tiles
  const uint32_t wfull = tiles + CONSUMERS * (G::TILE_BYTES + G::RES_BYTES);
  const uint32_t wempty = wfull + SLOTS * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, t = tid & 127;
  const int n_base = blockIdx.x * NH;
  // the stripe's games blockIdx.y, + gridDim.y, ...: pass p takes its games
  // 2p (warpgroup 0) and 2p + 1 (warpgroup 1), from one weight pass
  const int n_games = blockIdx.y < B ? (B - 1 - blockIdx.y) / gridDim.y + 1 : 0;
  const int passes = (n_games + 1) / 2;

  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(wfull + s * 8, 1);
      mbar_init(wempty + s * 8, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers' init

  if (wg == CONSUMERS) {
    // the loader: tap n % 9 of pass n / 9 into slot n % SLOTS, once both
    // warpgroups released the tile before it there
    if (lane == 0) {
      for (int n = 0; n < passes * TAPS; ++n) {
        const int s = n % SLOTS, tap = n % TAPS;
        if (n >= SLOTS) mbar_wait_or_trap(wempty + s * 8, (n / SLOTS - 1) & 1);
        mbar_expect_tx(wfull + s * 8, G::W_TAP_BYTES);
        tma_load_2d(ws + s * G::W_TAP_BYTES, &wmap, WIDE ? tap * C + n_base : n_base,
                    WIDE ? 0 : tap * C, wfull + s * 8);
      }
    }
    return;
  }

  const uint32_t stage = tiles + wg * G::TILE_BYTES;                           // its game tile
  const uint32_t res = tiles + CONSUMERS * G::TILE_BYTES + wg * G::RES_BYTES;  // its residual
  zero_halo<G>(stage, t);
  // thread t stores 16-byte pieces t + 128 * i of a game (see bf16_conv_kernel)
  uint32_t dst[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int piece = t + 128 * i;
    dst[i] = stage + (piece % KCH) * G::CHUNK_BYTES + G::tile_pos(piece / KCH) * 16;
  }
  float bias_v[NA / 2];
#pragma unroll
  for (int jn = 0; jn < NH / 8; ++jn) {
    bias_v[2 * jn] = bias[n_base + jn * 8 + 2 * (lane & 3)];
    bias_v[2 * jn + 1] = bias[n_base + jn * 8 + 2 * (lane & 3) + 1];
  }

  for (int p = 0; p < passes; ++p) {
    const bool has = 2 * p + wg < n_games;
    const int g = blockIdx.y + (2 * p + wg) * gridDim.y;
    if (has) {
      if (is_conv1) {  // this game's residual, the pieces this thread's epilogue takes
#pragma unroll
        for (int i = 0; i < G::EP_PIECES; ++i) {
          const int piece = t + 128 * i;
          if (G::RES_PIECES % 128 == 0 || piece < G::RES_PIECES)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(res + piece * 16),
                         "l"(resid + (static_cast<size_t>(g) * P + piece / NPC) * C + n_base +
                             (piece % NPC) * 8)
                         : "memory");
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      const uint4* src = reinterpret_cast<const uint4*>(in + static_cast<size_t>(g) * P * C);
      uint4 v[LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        if (G::PIECES % 128 == 0 || t + 128 * i < G::PIECES) v[i] = __ldg(src + t + 128 * i);
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        if (G::PIECES % 128 == 0 || t + 128 * i < G::PIECES)
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst[i]), "r"(v[i].x),
                       "r"(v[i].y), "r"(v[i].z), "r"(v[i].w)
                       : "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
      wg_sync(wg);
    }

    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = bias_v[(i >> 2) * 2 + (i & 1)];
    float part[2][NA];  // wide: two taps' products, one in flight while the other is added
#pragma unroll
    for (int tap = 0; tap <= TAPS; ++tap) {
      if (tap < TAPS) {
        const int n = p * TAPS + tap, s = n % SLOTS;
        mbar_wait_or_trap(wfull + s * 8, (n / SLOTS) & 1);
        const uint32_t a = stage + ((tap / 3) * G::PADW + tap % 3) * 16;
        const uint32_t b = ws + s * G::W_TAP_BYTES;
        if (has) {
          if constexpr (ROUND_TAPS) {
            issue_tap<G>(part[tap & 1], a, b);
          } else {
            // the chain of all 9C / 16 steps on the bias, a group a tap
            fence_operands(acc);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int ks = 0; ks < C / 16; ++ks)
              wgmma_bf16(acc, a_desc<G>(a, ks), b_desc<G>(b, ks), 1);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          }
        }
      }
      if (tap == 0) continue;
      if (has) {
        if (tap < TAPS)
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        else
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if constexpr (ROUND_TAPS)
          add_tap(acc, part[(tap - 1) & 1]);  // in OFFSETS order
        else
          fence_operands(acc);
      }
      mbar_arrive(wempty + ((p * TAPS + tap - 1) % SLOTS) * 8);  // tap - 1's slot
    }
    if (!has) continue;
    store_game<G>(acc, stage, res, is_conv1, out, g, n_base, wg, wl, lane, t);
    zero_halo<G>(stage, t);  // the staging overwrote the halo
  }
}

// One conv launch above 128 channels: launch's arguments
template <int S, int C, bool ROUND_TAPS, bool WIDE>
int launch_stream(const void* in, const void* resid, void* out, const void* w, const void* bias,
                  int B, int is_conv1, void* stream) {
  using G = StreamShape<S, C>;
  static HostState host;
  if (B <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(w)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte loads, TMA
  auto kernel = bf16_conv_stream_kernel<S, C, ROUND_TAPS, WIDE>;
  // a box is one tap's C input channels x the CTA's NH output channels, as
  // the resident kernel's
  const WeightMap layout = {CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            {WIDE ? 9u * C : C, WIDE ? C : 9u * C},
                            (WIDE ? 9u * C : C) * 2u,
                            {G::NH, C},
                            swizzle_mode(G::SW)};
  CUtensorMap wmap;
  int sms = 0;
  const int rc = prepare_launch(host, reinterpret_cast<const void*>(kernel), G::SMEM_BYTES, w,
                                layout, &wmap, &sms);
  if (rc != 0) return rc;
  constexpr int GR = G::GROUPS;
  const int stripes = B < sms / GR ? B : (sms / GR > 0 ? sms / GR : 1);
  kernel<<<dim3(GR, stripes), G::THREADS, G::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      wmap, static_cast<const __nv_bfloat16*>(in), static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), static_cast<const float*>(bias), B, is_conv1);
  return static_cast<int>(cudaGetLastError());
}

// One conv launch. Returns 0, a cudaError_t, or minus a CUresult of the
// tensor-map encoder.
template <int S, int C, bool ROUND_TAPS, bool WIDE>
int launch(const void* in, const void* resid, void* out, const void* w, const void* bias, int B,
           int is_conv1, void* stream) {
  if constexpr (C > 128) {
    return launch_stream<S, C, ROUND_TAPS, WIDE>(in, resid, out, w, bias, B, is_conv1, stream);
  } else {
  using G = Shape<S, C>;
  static_assert(G::SMEM_BYTES <= 232448, "fits one block's shared memory");
  static HostState host;
  if (B <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(w)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte loads, TMA
  auto kernel = bf16_conv_kernel<S, C, ROUND_TAPS, WIDE>;
  // a box is one tap's C input channels x the CTA's NH output channels:
  // rows of 2 * NH bytes, swizzled as wgmma reads them
  const WeightMap layout = {CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            {WIDE ? 9u * C : C, WIDE ? C : 9u * C},
                            (WIDE ? 9u * C : C) * 2u,
                            {G::NH, C},
                            swizzle_mode(G::SW)};
  CUtensorMap wmap;
  int sms = 0;
  const int rc = prepare_launch(host, reinterpret_cast<const void*>(kernel), G::SMEM_BYTES, w,
                                layout, &wmap, &sms);
  if (rc != 0) return rc;
  // one CTA per SM (the shared memory): the C / NH channel groups of
  // sms / (C / NH) stripes of games
  constexpr int GR = G::GROUPS;
  const int stripes = B < sms / GR ? B : (sms / GR > 0 ? sms / GR : 1);
  kernel<<<dim3(GR, stripes), THREADS, G::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      wmap, static_cast<const __nv_bfloat16*>(in), static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), static_cast<const float*>(bias), B, is_conv1);
  return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace
}  // namespace bf16conv
