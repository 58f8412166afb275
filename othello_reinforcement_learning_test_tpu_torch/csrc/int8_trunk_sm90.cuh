// The int8 trunk in one launch (trunk_int8_dxcat.cu), for Hopper (sm_90a):
// the pre-pass and every conv of the residual tower of int8_conv_sm90.cuh's
// function (per-block activation scale, true division, round half to even,
// the int32 3x3 conv, s_act * w_scale first, no FMA, bias, residual and ReLU
// in f32, a bf16 output) in one persistent cooperative kernel, for the
// gated iteration's small batches (B = 40-64), where one launch a conv left
// most SMs idle and paid a launch, a host call and a weight load a conv. A
// template on the board side S and the channel count C, as the body; the
// notes give S = 8, C = 128.
//
// Design:
// - The body's pieces: the A-descriptor shift into a zero-padded 10x10 tile,
//   the reciprocal quantisation with its exact fallback, the TMA-fed
//   producer warpgroup and its ring of tiles, the epilogue and the atomicMax
//   of the next layer's per-block amax (int8_conv_sm90.cuh).
// - A consumer warpgroup's wgmma covers a game's 64 positions and a part of
//   its 128 output channels: half (m64n64k32, 32 accumulator registers a
//   thread) or a quarter (m64n32k32, 16). Every int32 sum is whole in one
//   warpgroup and the epilogue is per element, so how the channels are
//   spread changes no bit; the amax atomics take any number of writers.
// - The split rule, from B and the SM count (sms):
//   * B < sms (split): the grid is 2 * min(B, sms / 2) CTAs. CTA i computes
//     channel half i % 2 of the games i / 2, i / 2 + grid / 2, ...; its two
//     consumer warpgroups a quarter each of every game, so that a CTA with
//     one game keeps both busy. It holds only its half of a layer's
//     weights, 9 x 64 x 128 = 73,728 B, so two layers fit: the next layer's
//     half comes by TMA while this one computes. At B = 64, 128 SMs work
//     (one launch a conv of the body used 32).
//   * C not a multiple of 32 (16, 48, 80, 112): always whole, since a
//     quarter would not be whole 8-row groups of the weights; below sms
//     games the grid is B CTAs.
//   * B >= sms (whole): every SM has a game a conv already, and a split
//     would load and quantize each game twice. The grid is sms CTAs, CTA i
//     takes games i, i + sms, ...; consumer warpgroup c computes half c of
//     every game from the same tile, and the two buffers hold the two halves
//     of one layer. The next layer's weights come once both consumers are
//     done with this one's, during the epilogue's last stores and the
//     barrier. Where half of C is no wgmma width (40 at C = 80, 56 at 112)
//     the product takes the next one (48, 64): the extra columns read
//     weights of the next tap or past the buffer, and are dropped.
// - The whole trunk in one launch: the grid is at most one CTA an SM (the
//   shared memory), launched cooperatively so that all are co-resident, or
//   the launch fails. A grid-wide barrier follows the pre-pass and every
//   conv but the last: the per-block amax of conv l + 1's input is whole
//   only when every CTA has finished conv l. The f32 activations stay in
//   device memory between convs (2 MB a tensor at B = 64: the L2 holds
//   them).
// - Memory order across the barrier: every thread fences its generic
//   stores for the async proxy; after the CTA's barrier, thread 0 fences
//   at gpu scope (cumulative over what the CTA's barrier ordered before it)
//   and arrives with a release add, spins with acquire loads, then fences
//   for the async proxy before its first TMA of the next conv. The amax is
//   read at L2 (ld.global.cg).
// - The pre-pass (bf16 input to f32, the first layer's per-block amax) is
//   the kernel's first phase; the host call zeroes the amax and the barrier
//   counters first (one memset) and launches once.
//
// Above 128 channels (int8_trunk_stream_kernel; C <= 128 compiles to the
// kernels above, unchanged) a layer's weights do not fit one CTA, and they
// are streamed as in the body's streamed path (int8_conv_sm90.cuh): a ring
// of (tap, panel) tiles, loaded ahead across the grid barrier into the next
// layer's first tiles (the weights are never written). The split rule is
// the one above, on channel shares that a stream can serve:
// - B < sms (split): CTA pairs, a game's channels [0, 128) in one CTA and
//   [128, C) in the other, its consumers 64 each (or, in the second CTA,
//   min(64, C - 128) and the rest, none below 80 channels). A CTA streams
//   only its share of a layer, 128 rows of 9 x KP bytes a tap's panel
//   (16,384 B tiles at C = 256: eight in the ring). At the gated batches
//   (B = 40-64) each CTA holds one game a layer.
// - B >= sms (whole): one CTA a game, its consumers [0, 128) and [128, C),
//   each tile all C rows, as the body's streamed kernel.
//
// Launches of a layer range [lb, le) (kernels/conv_stages.py launches one a
// conv to measure what the barrier buys) use barrier counter lb.

#pragma once

#include "int8_conv_sm90.cuh"

namespace int8trunk {
// internal linkage, as int8conv
namespace {

using namespace sm90;
using namespace int8conv;

// The body's geometry and the channel split's
template <int S_, int C_>
struct TrunkShape : Shape<S_, C_> {
  using G = Shape<S_, C_>;
  static constexpr bool SPLIT_OK = C_ % 32 == 0;  // quarters of whole 8-row groups
  static constexpr int NH = C_ / 2;     // split: a CTA's channels; whole: a consumer's
  static constexpr int NQ = C_ / 4;     // split: a consumer's
  // the wgmma width of a whole-mode consumer: NH, or the next legal s8 n
  static constexpr int NW = NH <= 24 ? (NH + 7) / 8 * 8 : (NH + 15) / 16 * 16;
  static constexpr int W_HTAP_BYTES = NH * G::KP;              // one tap's half: 8,192
  static constexpr int W_HALF_BYTES = TAPS * W_HTAP_BYTES;     // one layer's half: 73,728
  // + 1024: the weights' alignment; two weight buffers, the ring of padded
  // tiles, two f32 half-games of staging; the barriers: full and empty a
  // tile, one a staging half, one a weight buffer, and the weights' release
  static constexpr int SMEM_BYTES = 1024 + 2 * W_HALF_BYTES + STAGES * G::TILE_BYTES +
                                    2 * G::HALF_BYTES + (2 * STAGES + 5) * 8;
  static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");
};

// One game's products and epilogue for a consumer warpgroup: a wgmma of
// 2 * NA output channels from the weight rows wb on, of which the first
// 4 * NR are written (from game_off, wscale and bias on), once the tile is
// full; releases the tile (empty) when the products are done. Returns the
// thread's max.
template <class T, int NA, int NR>
__device__ __forceinline__ float conv_game(uint32_t tile, uint32_t wb, uint32_t empty,
                                           float s_act, const float* wsc, const float* bi,
                                           const float* resid, float* dst, __nv_bfloat16* out,
                                           size_t game_off, int row0, int col0, int conv1,
                                           int last) {
  float2 res[NR];
  int acc[NA];
#pragma unroll
  for (int k = 0; k < NA; ++k) acc[k] = 0;
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
    for (int ks = 0; ks < T::KP / 32; ++ks)
      wgmma_s8(acc, a_desc<T>(a_tap<T>(tile, tap), ks),
               b_desc<T>(wb + tap * T::W_HTAP_BYTES, ks, T::NH * T::SW), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  load_residual<T>(res, resid, game_off, row0, col0, conv1);  // in flight with the products
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
  mbar_arrive(empty);  // the products are done
  return last ? epilogue<true, T>(acc, res, s_act, wsc, bi, dst, out, game_off, row0, col0)
              : epilogue<false, T>(acc, res, s_act, wsc, bi, dst, out, game_off, row0, col0);
}

// Thread 0: half `half` of layer l's weights (the NH output channels from
// half * NH, every input channel, nine taps) into the buffer at dst,
// completing on bar
template <class T>
__device__ __forceinline__ void load_weights(uint32_t dst, uint32_t bar, const CUtensorMap* map,
                                             int l, int half) {
  mbar_expect_tx(bar, T::W_HALF_BYTES);
  load_taps<T>(dst, bar, map, l * TAPS * T::C + half * T::NH, T::NH);
}

// about 10 s at the SM clock: a grid barrier that waits longer is a fault
constexpr long long SPIN_CYCLES = 20000000000LL;

// All threads of every CTA: the k-th barrier of the launch on `count`
// (target k * gridDim.x). See the note for the fences.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // cumulative: the CTA's writes, which the barrier ordered before it
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count), "r"(1u) : "memory");
    const long long t0 = clock64();
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
      if (clock64() - t0 > SPIN_CYCLES) __trap();  // a CTA is missing: fail, not hang
    } while (v < target);
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  __syncthreads();
}

// The trunk's layers [lb, le), with the pre-pass first when lb = 0.
//   wmap:  every layer's int8 weights, (L * 9 * C_out) rows of C_in
//   x:     bf16 (B, S * S, C) trunk input
//   xf, yf: f32 (B, S * S, C) block input and conv 0 output
//   out:   bf16 (B, S * S, C) trunk output (the last layer's)
//   wscale, bias: f32 (L, C)
//   amax:  f32 (L, B / bg) per-block max of each layer's input, zeroed
//   count: this launch's barrier counter, zeroed
// SPLIT: the channel split (see the note); one instantiation each, so that
// each holds the registers of one consumer path
template <int S, int C, bool SPLIT>
__global__ void __launch_bounds__(CONV_THREADS, 1)
int8_trunk_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                  float* xf, float* yf, __nv_bfloat16* out, const float* __restrict__ wscale,
                  const float* __restrict__ bias, float* amax, unsigned* count, int L, int B,
                  int bg, int lb, int le) {
  using T = TrunkShape<S, C>;
  constexpr int P = T::P, NH = T::NH, NQ = T::NQ;
  static_assert(!SPLIT || T::SPLIT_OK, "a split only of whole 8-row groups");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;  // two weight buffers
  const uint32_t tiles = ws + 2 * T::W_HALF_BYTES;            // the ring of padded tiles
  const uint32_t staging = tiles + STAGES * T::TILE_BYTES;    // two f32 half-games
  const uint32_t bars = staging + 2 * T::HALF_BYTES;          // full[STAGES], empty[STAGES]
  const uint32_t sbars = bars + 2 * STAGES * 8;               // the staging halves'
  const uint32_t wbars = sbars + 2 * 8;                       // the weight buffers'
  const uint32_t wfree = wbars + 2 * 8;                       // consumers done with a layer
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, t = tid & 127;
  const int nblk = B / bg;
  // this CTA's games: slot, slot + step, ... (n of them, at least one)
  const int slot = SPLIT ? blockIdx.x >> 1 : blockIdx.x;
  const int step = SPLIT ? gridDim.x >> 1 : gridDim.x;
  const int n = (B - slot + step - 1) / step;
  const int my_half = blockIdx.x & 1;  // split: the CTA's channel half

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + s * 8, 128);                             // full: the producer
      mbar_init(bars + (STAGES + s) * 8, 256);                  // empty: both consumers
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(sbars + i * 8, 1);
      mbar_init(wbars + i * 8, 1);
    }
    mbar_init(wfree, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (SPLIT) {  // the first two layers of this CTA's half
      load_weights<T>(ws, wbars, &wmap, lb, my_half);
      if (lb + 1 < le) load_weights<T>(ws + T::W_HALF_BYTES, wbars + 8, &wmap, lb + 1, my_half);
    } else {      // both halves of the first layer
      load_weights<T>(ws, wbars, &wmap, lb, 0);
      load_weights<T>(ws + T::W_HALF_BYTES, wbars + 8, &wmap, lb, 1);
    }
  }
  for (int i = tid; i < STAGES * T::TILE_BYTES / 16; i += CONV_THREADS) st_zero16(tiles + i * 16);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the halos, for wgmma
  __syncthreads();

  unsigned barriers = 0;
  if (lb == 0) {
    // the pre-pass: a split CTA converts its half of each game's rows
    const int r0 = SPLIT ? my_half * (P / 2) : 0, rows = SPLIT ? P / 2 : P;
    for (int i = 0; i < n; ++i) {
      const int g = slot + i * step;
      const size_t off = (static_cast<size_t>(g) * P + r0) * C;
      const uint4* src = reinterpret_cast<const uint4*>(x + off);
      float4* dst = reinterpret_cast<float4*>(xf + off);
      float m = 0.0f;
      for (int k = tid; k < rows * C / 8; k += CONV_THREADS) {
        const uint4 u = src[k];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        float f[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[2 * e] = __uint_as_float(w[e] << 16);
          f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
        }
        dst[2 * k] = make_float4(f[0], f[1], f[2], f[3]);
        dst[2 * k + 1] = make_float4(f[4], f[5], f[6], f[7]);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(f[e]));
      }
      m = warp_max(m);
      if (lane == 0) atomicMax(reinterpret_cast<int*>(amax) + g / bg, __float_as_int(m));
    }
    grid_barrier(count, ++barriers * gridDim.x);
  }

  // the consumers' accumulator positions (see int8_conv_sm90.cuh's epilogue)
  const int row0 = wl * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  int jj = 0;  // the CTA's games before this layer in the launch: ring slots and phases
  for (int l = lb; l < le; ++l, jj += n) {
    const int li = l - lb, conv1 = l & 1, last = l == L - 1;
    const float* in = conv1 ? yf : xf;
    float* dst = conv1 ? xf : yf;
    const float* amax_in = amax + l * nblk;
    if (wg == 0) {
      // the producer: each game by two bulk copies, quantized into the ring
      // (see int8_conv_sm90.cuh's producer)
      if (t == 0) {
        stage_half<T>(staging, sbars, in, slot, 0);
        stage_half<T>(staging, sbars, in, slot, 1);
      }
      for (int i = 0; i < n; ++i) {
        const int j = jj + i, g = slot + i * step, s = j % STAGES;
        mbar_wait(bars + (STAGES + s) * 8, ((j / STAGES) & 1) ^ 1);  // empty[s]
        const float s_act = act_scale(__ldcg(amax_in + g / bg));
        const float y = __frcp_rn(s_act);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mbar_wait(sbars + hh * 8, j & 1);
          float4 v[T::LOADS];
          read_half<T>(v, staging + hh * T::HALF_BYTES, t);
          quantize_into<T>(tiles + s * T::TILE_BYTES + hh * (S / 2) * T::PADW * 16, v, s_act, y,
                           t);
          wg_sync(0);  // every producer thread has read the half
          if (t == 0 && i + 1 < n) stage_half<T>(staging, sbars, in, g + step, hh);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        mbar_arrive(bars + s * 8);                                      // full[s]
      }
      // the next weights, into the buffers this layer's consumers are done with
      const int next = SPLIT ? l + 2 : l + 1;
      if (t == 0 && next < le) {
        mbar_wait(wfree, li & 1);
        if (SPLIT) {
          load_weights<T>(ws + (li & 1) * T::W_HALF_BYTES, wbars + (li & 1) * 8, &wmap, next,
                          my_half);
        } else {
          load_weights<T>(ws, wbars, &wmap, next, 0);
          load_weights<T>(ws + T::W_HALF_BYTES, wbars + 8, &wmap, next, 1);
        }
      }
    } else {
      // the consumers, on every game of the CTA: split, warpgroup 1 + c
      // computes quarter c of the CTA's half (NQ channels); whole, half c
      const int c = wg - 1;
      const int b = SPLIT ? li & 1 : c;
      const int n0 = SPLIT ? my_half * NH + c * NQ : c * NH;  // the first channel
      mbar_wait(wbars + b * 8, SPLIT ? (li >> 1) & 1 : li & 1);
      const uint32_t wb = ws + b * T::W_HALF_BYTES + (SPLIT ? c * NQ * T::SW : 0);
      const float* wsc = wscale + l * C + n0;
      const float* bi = bias + l * C + n0;
      for (int i = 0; i < n; ++i) {
        const int j = jj + i, g = slot + i * step, s = j % STAGES;
        const float s_act = act_scale(__ldcg(amax_in + g / bg));
        const size_t game_off = static_cast<size_t>(g) * P * C + n0;
        const uint32_t tile = tiles + s * T::TILE_BYTES, empty = bars + (STAGES + s) * 8;
        mbar_wait(bars + s * 8, (j / STAGES) & 1);  // full[s]
        float m = conv_game<T, SPLIT ? NQ / 2 : T::NW / 2, SPLIT ? NQ / 4 : NH / 4>(
            tile, wb, empty, s_act, wsc, bi, xf, dst, out, game_off, row0, col0, conv1, last);
        m = warp_max(m);
        if (lane == 0 && l + 1 < L)
          atomicMax(reinterpret_cast<int*>(amax + (l + 1) * nblk + g / bg), __float_as_int(m));
      }
      mbar_arrive(wfree);  // this layer's weights are free
    }
    if (l + 1 < le) grid_barrier(count, ++barriers * gridDim.x);
  }
}

// The trunk's layers [lb, le) above 128 channels: the arguments of
// int8_trunk_kernel, the weights streamed (see the note). SPLIT: the
// channel split across a CTA pair.
template <int S, int C, bool SPLIT>
__global__ void __launch_bounds__(CONV_THREADS, 1)
int8_trunk_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __nv_bfloat16* __restrict__ x, float* xf, float* yf,
                         __nv_bfloat16* out, const float* __restrict__ wscale,
                         const float* __restrict__ bias, float* amax, unsigned* count, int L,
                         int B, int bg, int lb, int le) {
  using T = StreamShape<S, C, SPLIT ? 128 : C>;
  constexpr int P = T::P;
  // split: CTA 2i + h holds channels [128 h, 128 h + W_h) of its games,
  // W_0 = 128, W_1 = C - 128; its consumers Q0 and Q1 of them (Q1 may be 0)
  constexpr int W1 = C - 128, Q0 = W1 < 64 ? W1 : 64, Q1 = W1 - Q0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;   // the weight ring
  const uint32_t tiles = ws + T::SLOTS * T::SLOT_BYTES;         // the padded game tiles
  const uint32_t staging = tiles + T::TILES * T::TILE_BYTES;    // two f32 parts
  const uint32_t bars = staging + 2 * T::HALF_BYTES;            // full[TILES], empty[TILES]
  const uint32_t sbars = bars + 2 * T::TILES * 8;               // the staging parts'
  const uint32_t wfull = sbars + 2 * 8;                         // the slots'
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, t = tid & 127;
  const int nblk = B / bg;
  // this CTA's games: slot, slot + step, ... (n of them, at least one)
  const int slot = SPLIT ? blockIdx.x >> 1 : blockIdx.x;
  const int step = SPLIT ? gridDim.x >> 1 : gridDim.x;
  const int n = (B - slot + step - 1) / step;
  const int my_half = SPLIT ? blockIdx.x & 1 : 0;
  const Stream st = {ws, wfull, &wmap, (le - lb) * n * T::STEPS, n * T::STEPS, lb,
                     128 * my_half, tid == 128};

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
  for (int i = tid; i < T::TILES * T::TILE_BYTES / 16; i += CONV_THREADS)
    st_zero16(tiles + i * 16);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the halos, for wgmma
  __syncthreads();

  unsigned barriers = 0;
  if (lb == 0) {
    // the pre-pass (int8_trunk_kernel's): a split CTA converts its half of
    // each game's rows
    const int r0 = my_half * (P / 2), rows = SPLIT ? P / 2 : P;
    for (int i = 0; i < n; ++i) {
      const int g = slot + i * step;
      const size_t off = (static_cast<size_t>(g) * P + r0) * C;
      const uint4* src = reinterpret_cast<const uint4*>(x + off);
      float4* dst = reinterpret_cast<float4*>(xf + off);
      float m = 0.0f;
      for (int k = tid; k < rows * C / 8; k += CONV_THREADS) {
        const uint4 u = src[k];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        float f[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[2 * e] = __uint_as_float(w[e] << 16);
          f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
        }
        dst[2 * k] = make_float4(f[0], f[1], f[2], f[3]);
        dst[2 * k + 1] = make_float4(f[4], f[5], f[6], f[7]);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(f[e]));
      }
      m = warp_max(m);
      if (lane == 0) atomicMax(reinterpret_cast<int*>(amax) + g / bg, __float_as_int(m));
    }
    grid_barrier(count, ++barriers * gridDim.x);
  }

  // the roles for the whole launch, so that the producer gives the
  // consumers its registers (setmaxnreg), as in the body; every thread
  // still takes each grid barrier
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // jj: the CTA's games before this layer in the launch (tiles, parts, phases)
    for (int l = lb, jj = 0; l < le; ++l, jj += n) {
      const float* in = l & 1 ? yf : xf;
      const float* amax_in = amax + l * nblk;
      // the layer's games by parts, quantized into the tiles; a part's
      // replacement only from this layer's games (the next layer's input
      // is whole only after the grid barrier)
      if (t == 0) {
        stage_part<T>(staging, sbars, in, slot, 0, (jj * T::NPART) & 1);
        stage_part<T>(staging, sbars, in, slot, 1, (jj * T::NPART + 1) & 1);
      }
      for (int i = 0; i < n; ++i) {
        const int j = jj + i, g = slot + i * step, s = j % T::TILES;
        mbar_wait_or_trap(bars + (T::TILES + s) * 8, ((j / T::TILES) & 1) ^ 1);  // empty[s]
        produce_game<T>(tiles + s * T::TILE_BYTES, bars + s * 8, staging, sbars, in, j,
                        act_scale(__ldcg(amax_in + g / bg)), t, [&](int j2) {
                          return j2 - jj < n ? slot + (j2 - jj) * step : -1;
                        });
      }
      if (l + 1 < le) grid_barrier(count, ++barriers * gridDim.x);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;
  const int row0 = wl * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  for (int l = lb, jj = 0; l < le; ++l, jj += n) {
    const int conv1 = l & 1, last = l == L - 1;
    float* dst = conv1 ? xf : yf;
    const float* amax_in = amax + l * nblk;
    const float* wsc = wscale + l * C;
    const float* bi = bias + l * C;
    for (int i = 0; i < n; ++i) {
      const int j = jj + i, g = slot + i * step, s = j % T::TILES;
      const uint32_t tile = tiles + s * T::TILE_BYTES, empty = bars + (T::TILES + s) * 8;
      const float s_act = act_scale(__ldcg(amax_in + g / bg));
      const size_t game_off = static_cast<size_t>(g) * P * C;
      const int tile0 = ((l - lb) * n + i) * T::STEPS;
      float* amax_next = l + 1 < L ? amax + (l + 1) * nblk + g / bg : nullptr;
      mbar_wait_or_trap(bars + s * 8, (j / T::TILES) & 1);  // full[s]
      // (tile row, first output channel) of this consumer's share
      if constexpr (SPLIT) {
        if (my_half == 0) {
          if (c == 0)
            stream_game<false, T, 64>(st, tile, empty, tile0, 0, 0, s_act, wsc, bi, xf, dst,
                                      out, game_off, row0, col0, conv1, last, amax_next);
          else
            stream_game<false, T, 64>(st, tile, empty, tile0, 64, 64, s_act, wsc, bi, xf, dst,
                                      out, game_off, row0, col0, conv1, last, amax_next);
        } else if (c == 0) {
          stream_game<false, T, Q0>(st, tile, empty, tile0, 0, 128, s_act, wsc, bi, xf, dst,
                                    out, game_off, row0, col0, conv1, last, amax_next);
        } else {
          stream_game<false, T, Q1>(st, tile, empty, tile0, Q0, 128 + Q0, s_act, wsc, bi, xf,
                                    dst, out, game_off, row0, col0, conv1, last, amax_next);
        }
      } else if (c == 0) {
        stream_game<false, T, T::N0>(st, tile, empty, tile0, 0, 0, s_act, wsc, bi, xf, dst, out,
                                     game_off, row0, col0, conv1, last, amax_next);
      } else {
        stream_game<false, T, T::N1>(st, tile, empty, tile0, T::N0, T::N0, s_act, wsc, bi, xf,
                                     dst, out, game_off, row0, col0, conv1, last, amax_next);
      }
    }
    if (l + 1 < le) grid_barrier(count, ++barriers * gridDim.x);
  }
}

// The kernel for a launch: split where the shape allows it and it is asked
template <int S, int C>
auto trunk_kernel(bool split) {
  if constexpr (TrunkShape<S, C>::SPLIT_OK)
    return split ? int8_trunk_kernel<S, C, true> : int8_trunk_kernel<S, C, false>;
  else
    return int8_trunk_kernel<S, C, false>;
}

// Layers [lb, le) above 128 channels in one cooperative launch of the
// streamed kernel, split below sms games (see the note); the arguments of
// launch_layers
template <int S, int C>
int launch_stream_layers(const void* x, void* xf, void* yf, void* out, const void* w,
                         const void* wscale, const void* bias, void* amax, void* count, int L,
                         int B, int bg, int lb, int le, void* stream) {
  using Whole = StreamShape<S, C>;
  using Split = StreamShape<S, C, 128>;
  static HostState hosts[2];  // the split kernel's, the whole one's
  // a box is one panel of one tap: a CTA's output channels (128 split, C
  // whole; the second CTA of a pair reads past its C - 128, unused) x SW
  // input channels
  const WeightMap split_layout = {CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                  {C, static_cast<cuuint64_t>(L) * TAPS * C},
                                  C,
                                  {Split::SW, 128},
                                  swizzle_mode(Split::SW)};
  const WeightMap whole_layout = {CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                  {C, static_cast<cuuint64_t>(L) * TAPS * C},
                                  C,
                                  {Whole::SW, C},
                                  swizzle_mode(Whole::SW)};
  CUtensorMap wmap;
  int sms = 0;
  int rc = prepare_launch(hosts[0],
                          reinterpret_cast<const void*>(int8_trunk_stream_kernel<S, C, true>),
                          Split::SMEM_BYTES, w, split_layout, &wmap, &sms);
  if (rc != 0) return rc;
  const bool split = B < sms;
  auto kernel =
      split ? int8_trunk_stream_kernel<S, C, true> : int8_trunk_stream_kernel<S, C, false>;
  if (!split &&
      (rc = prepare_launch(hosts[1], reinterpret_cast<const void*>(kernel), Whole::SMEM_BYTES, w,
                           whole_layout, &wmap, &sms)) != 0)
    return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(split ? 2 * (B < sms / 2 ? B : sms / 2) : (B < sms ? B : sms));
  config.blockDim = dim3(CONV_THREADS);
  config.dynamicSmemBytes = split ? Split::SMEM_BYTES : Whole::SMEM_BYTES;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernel, wmap, static_cast<const __nv_bfloat16*>(x), static_cast<float*>(xf),
      static_cast<float*>(yf), static_cast<__nv_bfloat16*>(out),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<float*>(amax), static_cast<unsigned*>(count), L, B, bg, lb, le);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Layers [lb, le) of the trunk in one cooperative launch on barrier counter
// `count`. w: (L, 9, C_out, C_in) int8. Returns 0, a cudaError_t, or minus
// a CUresult of the tensor-map encoder.
template <int S, int C>
int launch_layers(const void* x, void* xf, void* yf, void* out, const void* w, const void* wscale,
                  const void* bias, void* amax, void* count, int L, int B, int bg, int lb, int le,
                  void* stream) {
  if constexpr (C > 128) {
    return launch_stream_layers<S, C>(x, xf, yf, out, w, wscale, bias, amax, count, L, B, bg, lb,
                                      le, stream);
  } else {
  using T = TrunkShape<S, C>;
  static HostState hosts[2];  // the split kernel's, the whole one's
  // a box is one panel of one tap's half: NH output channels x SW input
  // channels (64 x 128 at C = 128), swizzled as wgmma reads them
  const WeightMap layout = {CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            {C, static_cast<cuuint64_t>(L) * TAPS * C},
                            C,
                            {T::SW, T::NH},
                            swizzle_mode(T::SW)};
  CUtensorMap wmap;
  int sms = 0;
  int rc = 0;
  bool split = false;
  if constexpr (T::SPLIT_OK) {
    rc = prepare_launch(hosts[0], reinterpret_cast<const void*>(trunk_kernel<S, C>(true)),
                        T::SMEM_BYTES, w, layout, &wmap, &sms);
    if (rc != 0) return rc;
    split = B < sms;
  }
  auto kernel = trunk_kernel<S, C>(split);
  if (!split &&
      (rc = prepare_launch(hosts[1], reinterpret_cast<const void*>(kernel), T::SMEM_BYTES, w,
                           layout, &wmap, &sms)) != 0)
    return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  // every CTA has a game: a CTA pair a game below sms / 2 games (split), one
  // CTA a game below sms (whole, at widths that do not split)
  config.gridDim = dim3(split ? 2 * (B < sms / 2 ? B : sms / 2) : (B < sms ? B : sms));
  config.blockDim = dim3(CONV_THREADS);
  config.dynamicSmemBytes = T::SMEM_BYTES;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernel, wmap, static_cast<const __nv_bfloat16*>(x), static_cast<float*>(xf),
      static_cast<float*>(yf), static_cast<__nv_bfloat16*>(out),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<float*>(amax), static_cast<unsigned*>(count), L, B, bg, lb, le);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
}

// One trunk forward: zeroes the scratch (the amax, L x B / bg floats, then
// L barrier counters), then launches the layers, `per_launch` at a time (L:
// the whole trunk in one launch).
template <int S, int C>
int forward(const void* x, void* xf, void* yf, void* out, const void* w, const void* wscale,
            const void* bias, void* scratch, int L, int B, int bg, int per_launch, void* stream) {
  if (B <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xf) |
       reinterpret_cast<uintptr_t>(yf) | reinterpret_cast<uintptr_t>(w)) & 15 ||
      L <= 0 || bg <= 0 || B % bg || per_launch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte loads, TMA, whole blocks
  float* amax = static_cast<float*>(scratch);
  unsigned* counts = reinterpret_cast<unsigned*>(amax + static_cast<size_t>(L) * (B / bg));
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, sizeof(float) * (static_cast<size_t>(L) * (B / bg) + L),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int lb = 0; lb < L; lb += per_launch) {
    const int le = lb + per_launch < L ? lb + per_launch : L;
    const int rc = launch_layers<S, C>(x, xf, yf, out, w, wscale, bias, amax, counts + lb, L, B,
                                       bg, lb, le, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace
}  // namespace int8trunk
