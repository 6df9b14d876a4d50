// Fused block-row gather + in-block rank decode for NVIDIA Hopper (sm_90a).
//
// Replaces: ebwt2indel_tpu/ops/rank_pallas.py::_rank_decode_kernel (the one
// Pallas kernel of the JAX package; its production twin is the jnp
// parallel_rank of ebwt2indel_tpu/ops/rank.py:63-110).
//
// What it computes: for each int64 position i, the counts of A,C,G,T in
// BWT[0, i). Block b = i >> 7 is one 64-byte row of 16 uint32 words
// (ops/packing.py): words 0-3 bitplane 0, 4-7 bitplane 1, 8-11 the TERM
// plane, 12-15 the absolute A,C,G,T counters before the block. With
// o = i & 127 and, over the first o characters, S = #non-TERM, x = #bit0,
// y = #bit1, z = #(bit0 & bit1): A = S-x-y+z, C = x-z, G = y-z, T = z.
//
// What bounds it: random 64-byte row reads from device memory. Per query it
// moves about 104 bytes (8 B position, 64 B row, 32 B of int64 counts) and
// does about 50 integer operations, far below the card's operations-per-byte
// balance, so it is bound by bytes and by the latency of a dependent
// load (position, then row).
//
// What the design does about it: one thread per query, the row gather fused
// with the decode (the TPU needed XLA's separate gather, rank_pallas.py:3-9;
// here the row goes straight from four 16-byte loads into registers and is
// never written back). Queries keep the callers' node-major order, so the
// six boundaries of a suffix-tree node sit in neighbouring threads and
// mostly hit the same row, which the L1/L2 then serve once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t prefix_mask(int o, int w) {
  int take = o - 32 * w;
  take = take < 0 ? 0 : (take > 32 ? 32 : take);
  // (1u << 32) is undefined: a word taken whole is special-cased
  return take >= 32 ? 0xFFFFFFFFu : ((1u << take) - 1u);
}

__global__ void __launch_bounds__(256)
rank_decode_kernel(const uint4* __restrict__ blocks, long long n_blocks,
                   const long long* __restrict__ pos,
                   longlong2* __restrict__ out, long long n_queries) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  long long i = __ldg(pos + q);
  long long b = i >> 7;
  // clamp like the JAX gather: every valid position is in [0, n]
  b = b < 0 ? 0 : (b >= n_blocks ? n_blocks - 1 : b);
  int o = (int)(i & 127);

  const uint4* row = blocks + 4 * b;
  uint4 p0 = __ldg(row + 0);
  uint4 p1 = __ldg(row + 1);
  uint4 p2 = __ldg(row + 2);
  uint4 cnt = __ldg(row + 3);

  const uint32_t w0[4] = {p0.x, p0.y, p0.z, p0.w};
  const uint32_t w1[4] = {p1.x, p1.y, p1.z, p1.w};
  const uint32_t w2[4] = {p2.x, p2.y, p2.z, p2.w};
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
  longlong2 ac, gt;
  ac.x = (long long)cnt.x + (S - x - y + z);
  ac.y = (long long)cnt.y + (x - z);
  gt.x = (long long)cnt.z + (y - z);
  gt.y = (long long)cnt.w + z;
  out[2 * q] = ac;
  out[2 * q + 1] = gt;
}

}  // namespace

// blocks: (n_blocks, 16) 32-bit words, 16-byte aligned; pos: (n_queries,)
// int64; out: (n_queries, 4) int64. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int rank_decode(const void* blocks, long long n_blocks,
                           const void* pos, void* out, long long n_queries,
                           void* stream) {
  if (n_queries > 0) {
    const int threads = 256;
    long long grid = (n_queries + threads - 1) / threads;
    rank_decode_kernel<<<(unsigned int)grid, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint4*)blocks, n_blocks, (const long long*)pos,
        (longlong2*)out, n_queries);
  }
  return (int)cudaGetLastError();
}
