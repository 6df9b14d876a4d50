// One step of the suffix-tree node phase (modes 1 and 3) for NVIDIA Hopper
// (sm_90a): border flags, Weiner extension and child compaction of a chunk
// of nodes.
//
// Replaces no TPU kernel. The JAX package's node step,
// ebwt2indel_tpu/models/traverse.py::_node_body with
// fm_index.extend_node_narrow and its char-major compaction, is jnp that XLA
// lowered; only its rank decode was Pallas. The port ran it as about 30
// PyTorch ops a step (models/traverse.py::_node_body_plain) and two
// boolean-mask indexes, each a wait of the host on the card.
//
// What it computes, for chunk rows (first_TERM, first_A, first_C, first_G,
// first_T, last, depth), exactly as _node_body_plain:
//   1. the border values of borders j = 1..4 (_border_values): 1 = thr_K and
//      2 = thr_R where border > prev, border != last and depth >= K (or
//      k_right); 4 = a minimum at j >= 2 where border - prev >= 2 and
//      border < last - 1. Each nonzero value is stored at flags[border].
//      Every flagged position is written by exactly one (node, border) over
//      the whole traversal (models/traverse.py), so a store equals the
//      plain version's add; indices are 64-bit, so past 2^31 needs no
//      windows.
//   2. the nodes, LCP values and minima added to stats[0:3];
//   3. the 4 Weiner extensions F[c] + rank(b_j)[c] of the 6 boundaries, with
//      depth + 1, kept where they have >= 2 non-empty children;
//   4. the kept children in _char_major's order: every A-extension in chunk
//      order, then C, G and T, so the FIFO's order is the plain version's.
//
// What bounds it: per node a 56-byte row, 1-6 distinct 64-byte block rows
// (mostly one or two: deep nodes are narrow), at most four 56-byte children
// and four flag bytes, and some 400 integer operations: bytes, and the
// latency of dependent loads (row, then block rows). On the first node
// chunk of a 116M-position index (262,144 nodes) the bytes take 0.036 ms
// at 3.35 TB/s and the three launches 0.20-0.21 ms on an H100; what bounds
// a step in practice is the host, which makes three launches and reads
// one count.
//
// What the design does about it: one thread a node holds its 6 boundaries
// and its 24 ranks in registers and loads a block row only where a boundary
// leaves the previous one's block, so a node's rows are read once. Count,
// scan and write in three launches, the char-major order from a scan across
// blocks in the style of next_set.cu:
//   1. node_step_count_kernel: the flags, the stats (a block reduction, one
//      atomic a block and count) and, per block and character, the number
//      of children kept;
//   2. node_step_offsets_kernel: one block scans those counts in char-major
//      order [c][block] into each (character, block)'s first output row,
//      and writes their total last, the one number the host reads;
//   3. node_step_write_kernel, once the host has allocated the children at
//      their exact count: ranks each node again (its block rows were just
//      read, so L2 serves them) and writes each kept child at its
//      (character, block) row plus its rank among the block's kept threads
//      (a ballot a warp).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_rank.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kWidth = 7;  // the 6 boundaries and the depth
constexpr unsigned kFull = 0xffffffffu;

struct Node {
  long long b[6];
  long long depth;
};

__device__ __forceinline__ Node load_node(const long long* __restrict__ chunk,
                                          long long q) {
  const long long* row = chunk + kWidth * q;
  Node nd;
#pragma unroll
  for (int j = 0; j < 6; ++j) nd.b[j] = __ldg(row + j);
  nd.depth = __ldg(row + 6);
  return nd;
}

// r[j][c]: the count of character c before boundary j. The boundaries
// ascend, so each block row of the node is loaded once.
__device__ __forceinline__ void node_ranks(const uint4* __restrict__ blocks,
                                           long long n_blocks, const Node& nd,
                                           long long r[6][4]) {
  long long at = nd.b[0] >> 7;
  BlockRow row = load_block_row(blocks, n_blocks, at);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const long long blk = nd.b[j] >> 7;
    if (blk != at) {
      row = load_block_row(blocks, n_blocks, blk);
      at = blk;
    }
    decode_block_row(row, (int)(nd.b[j] & 127), r[j]);
  }
}

// bit c: the extension by character c has >= 2 non-empty children
// (node_num_children; F[c] cancels out of each comparison)
__device__ __forceinline__ unsigned keep_mask(long long r[6][4]) {
  unsigned m = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int k = 0;
#pragma unroll
    for (int j = 1; j < 6; ++j) k += r[j][c] > r[j - 1][c];
    m |= (k >= 2 ? 1u : 0u) << c;
  }
  return m;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

__device__ __forceinline__ long long warp_inclusive_sum(long long x,
                                                        int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += o;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
node_step_count_kernel(const uint4* __restrict__ blocks, long long n_blocks,
                       const long long* __restrict__ chunk, long long C,
                       unsigned char* __restrict__ flags, long long n,
                       unsigned long long* __restrict__ stats, long long K,
                       long long k_right, long long* __restrict__ counts) {
  // per warp: LCP values, minima, children kept by A, C, G, T
  __shared__ int s_warp[kWarps][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  int lcp = 0, mins = 0;
  unsigned keep = 0;
  if (q < C) {
    const Node nd = load_node(chunk, q);
    const long long last = nd.b[5];
#pragma unroll
    for (int j = 1; j <= 4; ++j) {
      const long long prev = nd.b[j - 1], border = nd.b[j];
      const bool cond = border > prev && border != last;
      const bool cm = j >= 2 && border - prev >= 2 && border < last - 1;
      const unsigned v = (cond && nd.depth >= K ? 1u : 0u) |
                         (cond && nd.depth >= k_right ? 2u : 0u) |
                         (cm ? 4u : 0u);
      // a flagged border lies in [0, last) and so in [0, n)
      if (v != 0 && border >= 0 && border < n)
        flags[border] = (unsigned char)v;
      lcp += cond;
      mins += cm;
    }
    long long r[6][4];
    node_ranks(blocks, n_blocks, nd, r);
    keep = keep_mask(r);
  }
  int part[6] = {warp_sum(lcp), warp_sum(mins), 0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    part[2 + c] = __popc(__ballot_sync(kFull, (keep >> c) & 1u));
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_warp[warp][k] = part[k];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    long long t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_warp[w][threadIdx.x];
    if (threadIdx.x < 2)
      atomicAdd(stats + 1 + threadIdx.x, (unsigned long long)t);
    else
      counts[(long long)(threadIdx.x - 2) * gridDim.x + blockIdx.x] = t;
  } else if (threadIdx.x == 6) {
    const long long first = (long long)blockIdx.x * kThreads;
    const long long nodes = C - first < kThreads ? C - first : kThreads;
    atomicAdd(stats, (unsigned long long)nodes);
  }
}

// counts[0, len) in place into their exclusive prefix sums; counts[len] =
// their total
__global__ void __launch_bounds__(kScanThreads)
node_step_offsets_kernel(long long* __restrict__ counts, long long len) {
  __shared__ long long s_warp[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long base = 0; base < len; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const long long v = i < len ? counts[i] : 0;
    const long long incl = warp_inclusive_sum(v, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    long long before = carry, total = carry;
#pragma unroll 4
    for (int w = 0; w < kScanThreads / 32; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
    if (i < len) counts[i] = before + incl - v;
    carry = total;
    __syncthreads();  // s_warp is rewritten by the next pass
  }
  if (threadIdx.x == 0) counts[len] = carry;
}

__global__ void __launch_bounds__(kThreads)
node_step_write_kernel(const uint4* __restrict__ blocks, long long n_blocks,
                       const long long* __restrict__ F,
                       const long long* __restrict__ chunk, long long C,
                       const long long* __restrict__ offsets,
                       long long* __restrict__ out) {
  __shared__ int s_warp[4][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  Node nd;
  long long r[6][4];
  unsigned keep = 0;
  if (q < C) {
    nd = load_node(chunk, q);
    node_ranks(blocks, n_blocks, nd, r);
    keep = keep_mask(r);
  }
  const unsigned below = (1u << lane) - 1u;
  int pre[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned bal = __ballot_sync(kFull, (keep >> c) & 1u);
    pre[c] = __popc(bal & below);
    if (lane == 0) s_warp[c][warp] = __popc(bal);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!((keep >> c) & 1u)) continue;
    long long at = offsets[(long long)c * gridDim.x + blockIdx.x] + pre[c];
    for (int w = 0; w < warp; ++w) at += s_warp[c][w];
    const long long f = __ldg(F + c);
    long long* o = out + kWidth * at;
#pragma unroll
    for (int j = 0; j < 6; ++j) o[j] = f + r[j][c];
    o[6] = nd.depth + 1;
  }
}

long long grid_of(long long C) { return (C + kThreads - 1) / kThreads; }

}  // namespace

// Slots of int64 scratch that a step of C nodes needs: a count per block
// and character, then the total.
extern "C" long long node_step_scratch_len(long long C) {
  return 4 * grid_of(C) + 1;
}

// blocks: (n_blocks, 16) 32-bit words, 16-byte aligned; chunk: (C, 7) int64;
// flags: (n,) bytes; stats: int64, [0:3] added to; scratch:
// node_step_scratch_len(C) int64. Launches the count and the scan on
// ``stream``; scratch's last slot then holds the number of children kept.
// Returns the first cudaGetLastError() that is not 0 (0 on success); it
// does not synchronise.
extern "C" int node_step_count(const void* blocks, long long n_blocks,
                               const void* chunk, long long C, void* flags,
                               long long n, void* stats, long long K,
                               long long k_right, void* scratch,
                               void* stream) {
  if (C <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long grid = grid_of(C);
  node_step_count_kernel<<<(unsigned int)grid, kThreads, 0, st>>>(
      (const uint4*)blocks, n_blocks, (const long long*)chunk, C,
      (unsigned char*)flags, n, (unsigned long long*)stats, K, k_right,
      (long long*)scratch);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  node_step_offsets_kernel<<<1, kScanThreads, 0, st>>>((long long*)scratch,
                                                        4 * grid);
  return (int)cudaGetLastError();
}

// F: (4,) int64; scratch: as node_step_count left it; out: (kept, 7) int64,
// kept = scratch's last slot. Launches the writer on ``stream`` and returns
// cudaGetLastError(); it does not synchronise.
extern "C" int node_step_write(const void* blocks, long long n_blocks,
                               const void* F, const void* chunk, long long C,
                               const void* scratch, void* out, void* stream) {
  if (C <= 0) return 0;
  node_step_write_kernel<<<(unsigned int)grid_of(C), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint4*)blocks, n_blocks, (const long long*)F,
      (const long long*)chunk, C, (const long long*)scratch, (long long*)out);
  return (int)cudaGetLastError();
}
