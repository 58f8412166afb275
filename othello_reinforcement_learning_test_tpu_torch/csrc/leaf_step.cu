// The search's leaf step for every game of a batch in one launch, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The JAX package's search runs this step as XLA
// operations fused under jit; the port's eager search ran it as about 227
// small PyTorch operations a simulation (search/mcts.py::_step_leaf: the
// parent gathers, OthelloEngine.step, OthelloEngine.observe), each 10-20 us
// of host time to launch, with the device drained by the select walk's
// last sync and nothing queued to hide them. Per game, one thread:
//   - reads the selection's parent slot and action, then the parent's board
//     words and its cached pass legality from the tree;
//   - applies OthelloEngine.step exactly: action a < S*S is the square
//     (a / S) * 8 + a % S, valid when it flips a stone and is empty; the
//     pass (a == S*S) is valid when the parent's pass is legal; any other
//     action, or an invalid one, leaves the board unswapped and unchanged;
//     move count = the parent's (zeros) + valid, passed = valid and a pass
//     (else the parent's);
//   - runs both sides' legal floods on the child once and writes what
//     observe(child, with_features=True) returns: the legal mask (the pass
//     legal when the side to move has no square), terminal (neither side
//     can place), the winner sign(popcount(me) - popcount(opp)), and the
//     features: own stones, opponent's stones, legal squares, NHWC.
// The floods are othello_engine.cuh's, shared with random_step.cu; the
// eight direction masks and the validity mask are kernel arguments and the
// board side a template argument, so one build serves sizes 4, 6 and 8
// under both rule sets.
//
// Bound on an H100 SXM. A game reads 16 B of parent index and action, 16 B
// of parent words, 1 B of pass legality and 4 B of move count, and writes
// 16 B of child words, 5 B of move count and passed, 65 B of legal mask,
// 5 B of terminal and winner and 768 B of features (8x8): about 0.9 KB, so
// 1,024 games move 0.92 MB, 0.27 us at 3.35 TB/s. Its three floods (the
// move's flips, both sides' legal squares: 8 directions x 7 shift-and-merge
// steps x 4 32-bit instructions, 672 a game) take 0.04 us at the INT32 rate
// of 132 SMs x 64 lanes x 1.98 GHz. At the search's B=1024 the kernel is
// bound by launch latency (a few us), so the aim is one launch in place of
// the step's operations, not its roofline. What the design does: one
// thread per game in registers, one warp's 32 games a block; the per-game
// words and scalars stored straight from the thread (coalesced across the
// warp); the legal mask and the features, whose rows of one block are
// contiguous in the output, staged as three words a game in shared memory
// and stored by all 256 threads of the block, neighbouring threads on
// neighbouring addresses, 33 elements a thread at 8x8: 5.3 us at B=1024
// on the card, where 64 games a block with each thread storing its own
// game's 257 elements took 9.7 us.
//
// Layout: board_me, board_opp (B, N) int64 and tree_legal (B, N, S*S+1)
// bool, the tree's node pools of N slots; parent, action (B) int64; zeros
// (B) int32. Outputs: me, opp (B) int64, move_count (B) int32, passed (B)
// bool, legal (B, S*S+1) bool, terminal (B) bool, winner (B) int32,
// features (B, S, S, 3) float32. Plain C interface for ctypes; the launch
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "othello_engine.cuh"

namespace {

constexpr int GAMES = 32;     // games a block, one a thread of its first warp
constexpr int THREADS = 256;  // threads a block, all storing its rows

struct Args {
  const int64_t* board_me;
  const int64_t* board_opp;
  const uint8_t* tree_legal;
  const int64_t* parent;
  const int64_t* action;
  const int32_t* zeros;
  int64_t* me;
  int64_t* opp;
  int32_t* move_count;
  uint8_t* passed;
  uint8_t* legal;
  uint8_t* terminal;
  int32_t* winner;
  float* features;
  int batch;
  int slots;
};

// bit of square q (row-major on the S x S board) in the 8-wide layout
template <int S>
__device__ __forceinline__ int square_bit(int q) {
  return (q / S) * 8 + q % S;
}

template <int S>
__global__ void __launch_bounds__(THREADS) leaf_step_kernel(Args a, Tables t) {
  constexpr int SQUARES = S * S;
  constexpr int ACTIONS = SQUARES + 1;  // the pass last
  constexpr int FEATURES = 3 * SQUARES;
  __shared__ uint64_t words[GAMES][3];  // the child's me, opp and me's legal squares

  const int first = blockIdx.x * GAMES;
  const int games = min(GAMES, a.batch - first);
  const int b = first + threadIdx.x;
  if (threadIdx.x < games) {
    const int64_t node = static_cast<int64_t>(b) * a.slots + a.parent[b];
    const uint64_t me = static_cast<uint64_t>(a.board_me[node]);
    const uint64_t op = static_cast<uint64_t>(a.board_opp[node]);
    const bool pass_legal = a.tree_legal[node * ACTIONS + SQUARES] != 0;
    const int64_t act = a.action[b];
    const bool is_pass = act == SQUARES;
    const uint64_t mv = act >= 0 && act < SQUARES
        ? 1ull << square_bit<S>(static_cast<int>(act)) : 0ull;
    const uint64_t f = flips(me, op, mv, t);
    const bool valid = is_pass ? pass_legal : f != 0 && ((me | op) & mv) == 0;
    const uint64_t cme = valid ? op & ~f : me;
    const uint64_t cop = valid ? me | mv | f : op;
    const int32_t zero = a.zeros[b];
    a.me[b] = static_cast<int64_t>(cme);
    a.opp[b] = static_cast<int64_t>(cop);
    a.move_count[b] = zero + (valid ? 1 : 0);
    a.passed[b] = valid ? is_pass : zero != 0;

    const uint64_t lme = legal(cme, cop, t);
    const uint64_t lop = legal(cop, cme, t);
    const int diff = __popcll(cme) - __popcll(cop);
    a.terminal[b] = lme == 0 && lop == 0;
    a.winner[b] = (diff > 0) - (diff < 0);
    words[threadIdx.x][0] = cme;
    words[threadIdx.x][1] = cop;
    words[threadIdx.x][2] = lme;
  }
  __syncthreads();

  // the block's rows of the legal mask and of the features are contiguous
  uint8_t* legal_rows = a.legal + static_cast<int64_t>(first) * ACTIONS;
  for (int e = threadIdx.x; e < games * ACTIONS; e += THREADS) {
    const int g = e / ACTIONS, k = e - g * ACTIONS;
    const uint64_t lg = words[g][2];
    legal_rows[e] = k == SQUARES ? lg == 0 : (lg >> square_bit<S>(k)) & 1;
  }
  float* feature_rows = a.features + static_cast<int64_t>(first) * FEATURES;
  for (int e = threadIdx.x; e < games * FEATURES; e += THREADS) {
    const int g = e / FEATURES, r = e - g * FEATURES;
    const int q = r / 3, plane = r - 3 * q;
    feature_rows[e] = static_cast<float>((words[g][plane] >> square_bit<S>(q)) & 1);
  }
}

}  // namespace

extern "C" int leaf_step_launch(const void* board_me, const void* board_opp,
                                const void* tree_legal, const void* parent, const void* action,
                                const void* zeros, void* me, void* opp, void* move_count,
                                void* passed, void* legal, void* terminal, void* winner,
                                void* features, int batch, int slots, int size,
                                const uint64_t* masks, uint64_t valid, void* stream) {
  Args a{static_cast<const int64_t*>(board_me), static_cast<const int64_t*>(board_opp),
         static_cast<const uint8_t*>(tree_legal), static_cast<const int64_t*>(parent),
         static_cast<const int64_t*>(action), static_cast<const int32_t*>(zeros),
         static_cast<int64_t*>(me), static_cast<int64_t*>(opp),
         static_cast<int32_t*>(move_count), static_cast<uint8_t*>(passed),
         static_cast<uint8_t*>(legal), static_cast<uint8_t*>(terminal),
         static_cast<int32_t*>(winner), static_cast<float*>(features), batch, slots};
  Tables t;
  for (int i = 0; i < 8; ++i) t.mask[i] = masks[i];
  t.valid = valid;
  const int grid = (batch + GAMES - 1) / GAMES;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 4: leaf_step_kernel<4><<<grid, THREADS, 0, s>>>(a, t); break;
    case 6: leaf_step_kernel<6><<<grid, THREADS, 0, s>>>(a, t); break;
    case 8: leaf_step_kernel<8><<<grid, THREADS, 0, s>>>(a, t); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
