// Fused block-row gather + in-block rank decode for NVIDIA Hopper (sm_90a).
//
// Replaces: ebwt2indel_tpu/ops/rank_pallas.py::_rank_decode_kernel (the one
// Pallas kernel of the JAX package; its production twin is the jnp
// parallel_rank of ebwt2indel_tpu/ops/rank.py:63-110).
//
// What it computes: for each int64 position i, the counts of A,C,G,T in
// BWT[0, i), by the decode of block_rank.cuh.
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

#include "block_rank.cuh"

namespace {

__global__ void __launch_bounds__(256)
rank_decode_kernel(const uint4* __restrict__ blocks, long long n_blocks,
                   const long long* __restrict__ pos,
                   longlong2* __restrict__ out, long long n_queries) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  long long i = __ldg(pos + q);
  long long c[4];
  decode_block_row(load_block_row(blocks, n_blocks, i >> 7), (int)(i & 127),
                   c);
  out[2 * q] = make_longlong2(c[0], c[1]);
  out[2 * q + 1] = make_longlong2(c[2], c[3]);
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
