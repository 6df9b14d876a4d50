// The in-block rank decode of the packed BWT, shared by every kernel that
// ranks positions (rank_decode.cu, node_step.cu), so that they cannot drift.
//
// Block b = i >> 7 is one 64-byte row of 16 uint32 words (ops/packing.py):
// words 0-3 bitplane 0, 4-7 bitplane 1, 8-11 the TERM plane, 12-15 the
// absolute A,C,G,T counters before the block. With o = i & 127 and, over the
// first o characters, S = #non-TERM, x = #bit0, y = #bit1, z = #(bit0 &
// bit1): A = S-x-y+z, C = x-z, G = y-z, T = z, each added to its counter.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct BlockRow {
  uint4 p0, p1, p2, cnt;
};

__device__ __forceinline__ uint32_t prefix_mask(int o, int w) {
  int take = o - 32 * w;
  take = take < 0 ? 0 : (take > 32 ? 32 : take);
  // (1u << 32) is undefined: a word taken whole is special-cased
  return take >= 32 ? 0xFFFFFFFFu : ((1u << take) - 1u);
}

// Row b of the blocks, clamped like the JAX gather: every valid position is
// in [0, n], so only a position out of range is clamped.
__device__ __forceinline__ BlockRow load_block_row(
    const uint4* __restrict__ blocks, long long n_blocks, long long b) {
  b = b < 0 ? 0 : (b >= n_blocks ? n_blocks - 1 : b);
  const uint4* row = blocks + 4 * b;
  return {__ldg(row + 0), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3)};
}

// Counts of A,C,G,T in BWT[0, i) from the row of block i >> 7, o = i & 127.
__device__ __forceinline__ void decode_block_row(const BlockRow& r, int o,
                                                 long long out[4]) {
  const uint32_t w0[4] = {r.p0.x, r.p0.y, r.p0.z, r.p0.w};
  const uint32_t w1[4] = {r.p1.x, r.p1.y, r.p1.z, r.p1.w};
  const uint32_t w2[4] = {r.p2.x, r.p2.y, r.p2.z, r.p2.w};
  int S = 0, x = 0, y = 0, z = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t np2m = ~w2[w] & prefix_mask(o, w);
    uint32_t t0 = w0[w] & np2m;
    uint32_t t1 = w1[w] & np2m;
    S += __popc(np2m);
    x += __popc(t0);
    y += __popc(t1);
    z += __popc(t0 & t1);
  }
  out[0] = (long long)r.cnt.x + (S - x - y + z);
  out[1] = (long long)r.cnt.y + (x - z);
  out[2] = (long long)r.cnt.z + (y - z);
  out[3] = (long long)r.cnt.w + z;
}

}  // namespace
