// One uniform-random Othello ply for every game of a batch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_step_kernel`
// (othello_reinforcement_learning_test_tpu/ops/pallas_step.py:162), reached
// through `random_step` (:205) and looped by `play_random_games` (:272).
// Per game, as the Pallas kernel computes it:
//   - both sides' legal squares (reverse flood, 6 iterations per direction,
//     the rule set's post-shift masks, empties confined to the board's
//     validity mask for sizes 4 and 6);
//   - live = either side can place;
//   - n = max(popcount(legal), 1), k = (hi * 2^32 + lo) mod n from the two
//     uniform u32 words given for this game (the Pallas `_mod64`; here one
//     exact uint64 remainder);
//   - the k-th set bit of legal, its flips, then place-or-pass and the side
//     swap; a terminal board passes through unchanged; live as int32.
//
// The eight direction masks and the validity mask are kernel arguments, so
// one build serves every (board size, rule set) pair; the eight shift
// amounts are fixed by the 8-wide bit layout. The floods live in
// othello_engine.cuh, shared with leaf_step.cu.
//
// Bound on an H100 SXM: a game moves 44 bytes per ply (two 64-bit board
// words read and written, two u32 random words, one int32 live), 4.2 M games
// 185 MB, 0.055 ms at 3.35 TB/s; its three floods (both sides' legal
// squares, the move's flips: 8 directions x 7 shift-and-merge steps x 4
// 32-bit instructions, 672 a game, chip_smoke.py's RANDOM_STEP_OPS) at the
// INT32 rate of 132 SMs x 64 lanes x 1.98 GHz take 0.17 ms, so the ply is
// bound by operations. What this first design does about it: one thread per game in
// registers, with 64-bit words (the TPU needed u32 pairs), coalesced
// u32-plane loads and stores, no shared memory and no (R, 128) lane tiling.
//
// Layout: boards (4, N) u32 planes [me_lo, me_hi, opp_lo, opp_hi], words
// (2, N) u32 planes [lo, hi], N games. Plain C interface for ctypes; the
// launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "othello_engine.cuh"

namespace {

constexpr int THREADS = 256;

// Bit index of the k-th (0-based) set bit of x, for k < popcount(x): a
// binary ladder over halves, quarters, ... of the word.
__device__ __forceinline__ int kth_set_bit(uint64_t x, uint32_t k) {
  uint32_t w = static_cast<uint32_t>(x);
  int pos = 0;
  uint32_t c = __popc(w);
  if (k >= c) { k -= c; w = static_cast<uint32_t>(x >> 32); pos = 32; }
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    c = __popc(w & ((1u << width) - 1u));
    if (k >= c) { k -= c; w >>= width; pos += width; }
  }
  return pos;
}

__global__ void __launch_bounds__(THREADS)
random_step_kernel(const uint32_t* __restrict__ boards, const uint32_t* __restrict__ words,
                   uint32_t* __restrict__ out, int32_t* __restrict__ live_out, int n,
                   Tables t) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint64_t me = boards[i] | (static_cast<uint64_t>(boards[n + i]) << 32);
  const uint64_t op = boards[2 * n + i] | (static_cast<uint64_t>(boards[3 * n + i]) << 32);
  const uint64_t lg = legal(me, op, t);
  const bool has_move = lg != 0;
  const bool live = has_move || legal(op, me, t) != 0;

  const uint32_t count = max(__popcll(lg), 1);
  const uint64_t draw = words[i] | (static_cast<uint64_t>(words[n + i]) << 32);
  const uint32_t k = static_cast<uint32_t>(draw % count);
  const uint64_t mv = has_move ? 1ull << kth_set_bit(lg, k) : 0ull;
  const uint64_t f = flips(me, op, mv, t);

  // place (a legal move) or pass (none, but the opponent can): both swap
  uint64_t new_me = me, new_op = op;
  if (live) {
    new_me = has_move ? op & ~f : op;
    new_op = has_move ? me | mv | f : me;
  }
  out[i] = static_cast<uint32_t>(new_me);
  out[n + i] = static_cast<uint32_t>(new_me >> 32);
  out[2 * n + i] = static_cast<uint32_t>(new_op);
  out[3 * n + i] = static_cast<uint32_t>(new_op >> 32);
  live_out[i] = live ? 1 : 0;
}

}  // namespace

extern "C" int random_step_launch(const void* boards, const void* words, void* out,
                                  void* live, int n, const uint64_t* masks,
                                  uint64_t valid, void* stream) {
  Tables t;
  for (int i = 0; i < 8; ++i) t.mask[i] = masks[i];
  t.valid = valid;
  const int grid = (n + THREADS - 1) / THREADS;
  random_step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(boards), static_cast<const uint32_t*>(words),
      static_cast<uint32_t*>(out), static_cast<int32_t*>(live), n, t);
  return static_cast<int>(cudaGetLastError());
}
