// The Othello engine's bit floods for one game in registers, shared by the
// kernels that step games (random_step.cu, leaf_step.cu).
//
// The same floods as the port's plain engine (ops/bitboard.py): boards are
// 64-bit words in the 8-wide bit layout (bit r * 8 + c), the eight direction
// masks are the rule set's post-shift masks and `valid` the squares of the
// SxS board, so one build serves every (board size, rule set) pair; the
// eight shift amounts are fixed by the layout. Each flood is 8 directions x
// 7 shift-and-merge steps.
//
// Kept in an anonymous namespace, as every header of this directory.

#pragma once

#include <stdint.h>

namespace {

constexpr int FLOOD_ITERS = 6;

// Shift of direction i: up, down, left, right, up-left, up-right, down-left,
// down-right (the engines' order). Called with unrolled constant i.
__device__ __forceinline__ int delta(int i) {
  switch (i) {
    case 0: return -8;
    case 1: return 8;
    case 2: return -1;
    case 3: return 1;
    case 4: return -9;
    case 5: return -7;
    case 6: return 7;
    default: return 9;
  }
}

struct Tables {
  uint64_t mask[8];  // per-direction post-shift masks of the rule set
  uint64_t valid;    // squares of the SxS board in the 8-wide layout
};

__device__ __forceinline__ uint64_t shift(uint64_t x, int d) {
  return d > 0 ? x << d : x >> -d;
}

__device__ __forceinline__ uint64_t legal(uint64_t me, uint64_t op, const Tables& t) {
  const uint64_t empty = t.valid & ~(me | op);
  uint64_t lg = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = -delta(i);  // walk backwards from own stones
    const uint64_t m = t.mask[i];
    const uint64_t p = op & m;
    uint64_t y = shift(me & m, d) & p;
#pragma unroll
    for (int j = 0; j < FLOOD_ITERS; ++j) y |= shift(y, d) & p;
    lg |= shift(y, d) & empty;
  }
  return lg;
}

__device__ __forceinline__ uint64_t flips(uint64_t me, uint64_t op, uint64_t mv,
                                          const Tables& t) {
  uint64_t out = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = delta(i);
    const uint64_t mo = t.mask[i] & op;
    uint64_t f = shift(mv, d) & mo;
#pragma unroll
    for (int j = 0; j < FLOOD_ITERS; ++j) f |= shift(f, d) & mo;
    const uint64_t term = shift(f, d) & t.mask[i] & ~f;
    if (term & me) out |= f;
  }
  return out;
}

}  // namespace
