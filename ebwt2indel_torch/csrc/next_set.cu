// The next-set table of a flag vector, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package builds this table with
// jax.lax.cummin(reverse=True) (ebwt2indel_tpu/ops/coords.py:81,
// ebwt2indel_tpu/models/call.py:166 and :210), which XLA lowered; no Pallas
// kernel does it. The port ran it as torch.cummin over a flipped int64
// vector: PyTorch's innermost-dimension scan gives a 1-D tensor's one row
// to one warp (0.34 s at 116.15 M positions), and the flips and outputs
// held four int64 vectors, 32 B a position.
//
// What it computes: for i in [0, len),
//   out[i] = base + (the smallest j >= i with flags[j] != 0 and
//                    base + j < n), or n where there is none.
// The dense route's anchor table is base = 0, n = len; a shard of the
// position mesh passes its first global position as base; the packed route
// runs it over its per-block "has a set bit" flags. Indices and offsets are
// 64-bit throughout: a vector may pass 2^31 positions.
//
// What bounds it: bytes. It reads 1 B of flags and writes 8 B of table a
// position, with a few integer operations: 9 B a position, 1.045 GB or
// 0.31 ms at 116.15 M positions at 3.35 TB/s.
//
// What the design does about it: reduce, then scan, in three launches.
//   1. next_set_tiles: one block per tile of 4,096 positions, one 16-byte
//      load of flags a thread; the block's first set position goes to an
//      8-byte slot of scratch (n where the tile has none).
//   2. next_set_carry: one block turns those slots, in place, into the
//      first set position of the tiles to each one's right (a reverse
//      exclusive minimum, 8,192 tiles a pass).
//   3. next_set_fill: one block per tile again. Each warp owns 512
//      positions and walks them right to left in eight steps of 64, a
//      warp-wide suffix minimum a step seeded with what lies to its right;
//      each lane stores its two positions with one 16-byte store, so a
//      step writes 512 contiguous bytes.
// Flags are read twice and the table written once, 10 B a position; the
// only temporary is the 8 B a tile of scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;  // flags in one 16-byte load
constexpr int kTile = kThreads * kPerThread;  // 4,096 positions
constexpr int kWarps = kThreads / 32;
constexpr int kSegment = kTile / kWarps;  // 512 positions a warp
constexpr int kStep = 64;  // two positions a lane
constexpr int kCarryThreads = 1024;
constexpr int kCarryPerThread = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long llmin(long long a, long long b) {
  return a < b ? a : b;
}

// flags[g, g + 16) as 16 bytes, zero at and past ``lim``
__device__ __forceinline__ uint4 load16(const unsigned char* __restrict__ flags,
                                        long long g, long long lim,
                                        bool aligned) {
  if (aligned && g + kPerThread <= lim)
    return __ldg(reinterpret_cast<const uint4*>(flags + g));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (g + k < lim && flags[g + k] != 0) w[k >> 2] |= 1u << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// index of the first nonzero byte of 16 (little-endian words), 16 if none
__device__ __forceinline__ int first16(uint4 v) {
  if (v.x) return (__ffs((int)v.x) - 1) >> 3;
  if (v.y) return 4 + ((__ffs((int)v.y) - 1) >> 3);
  if (v.z) return 8 + ((__ffs((int)v.z) - 1) >> 3);
  if (v.w) return 12 + ((__ffs((int)v.w) - 1) >> 3);
  return kPerThread;
}

__device__ __forceinline__ long long warp_min(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = llmin(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

// the minimum of x over this lane and the lanes above it
__device__ __forceinline__ long long warp_suffix_min(long long x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long o = __shfl_down_sync(kFull, x, d);
    if (lane + d < 32) x = llmin(x, o);
  }
  return x;
}

// the first set position of this thread's 16 flags, n if none, and the
// flags themselves
__device__ __forceinline__ long long thread_first(
    const unsigned char* __restrict__ flags, long long g, long long lim,
    long long base, long long n, bool aligned, uint4* v) {
  *v = load16(flags, g, lim, aligned);
  int k = first16(*v);
  return k < kPerThread ? base + g + k : n;
}

__global__ void __launch_bounds__(kThreads)
next_set_tiles(const unsigned char* __restrict__ flags, long long lim,
               long long base, long long n, bool aligned,
               long long* __restrict__ firsts) {
  __shared__ long long s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * kTile +
                      (long long)threadIdx.x * kPerThread;
  uint4 v;
  long long f = warp_min(thread_first(flags, g, lim, base, n, aligned, &v));
  if (lane == 0) s_warp[warp] = f;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long m = n;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = llmin(m, s_warp[w]);
    firsts[blockIdx.x] = m;
  }
}

__global__ void __launch_bounds__(kCarryThreads)
next_set_carry(long long* __restrict__ firsts, long long tiles, long long n) {
  __shared__ long long s_warp[kCarryThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr long long kChunk = (long long)kCarryThreads * kCarryPerThread;
  long long right = n;  // the minimum of the chunks already done
  for (long long c = (tiles + kChunk - 1) / kChunk - 1; c >= 0; --c) {
    const long long e0 = c * kChunk + (long long)threadIdx.x * kCarryPerThread;
    long long v[kCarryPerThread];
    long long m = n;
#pragma unroll
    for (int k = 0; k < kCarryPerThread; ++k) {
      v[k] = e0 + k < tiles ? firsts[e0 + k] : n;
      m = llmin(m, v[k]);
    }
    const long long incl = warp_suffix_min(m, lane);
    long long cur = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) cur = n;
    if (lane == 0) s_warp[warp] = incl;
    __syncthreads();
    cur = llmin(cur, right);
    long long total = right;
    for (int w = 0; w < kCarryThreads / 32; ++w) {
      if (w > warp) cur = llmin(cur, s_warp[w]);
      total = llmin(total, s_warp[w]);
    }
    // each thread rewrites only the slots it read
#pragma unroll
    for (int k = kCarryPerThread - 1; k >= 0; --k) {
      if (e0 + k < tiles) firsts[e0 + k] = cur;
      cur = llmin(cur, v[k]);
    }
    right = total;
    __syncthreads();  // s_warp is rewritten by the next pass
  }
}

__global__ void __launch_bounds__(kThreads)
next_set_fill(const unsigned char* __restrict__ flags, long long len,
              long long lim, long long base, long long n, bool aligned,
              const long long* __restrict__ carry,
              long long* __restrict__ out) {
  __shared__ __align__(16) unsigned char s_flags[kTile];
  __shared__ long long s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)blockIdx.x * kTile;
  // thread t loads flags [16t, 16t + 16) of the tile, so warp w's lanes
  // load its own segment [512w, 512w + 512)
  uint4 v;
  long long f = warp_min(thread_first(
      flags, t0 + (long long)threadIdx.x * kPerThread, lim, base, n, aligned,
      &v));
  reinterpret_cast<uint4*>(s_flags)[threadIdx.x] = v;
  if (lane == 0) s_warp[warp] = f;
  __syncthreads();
  long long right = carry[blockIdx.x];
  for (int w = warp + 1; w < kWarps; ++w) right = llmin(right, s_warp[w]);

  const unsigned char* seg = s_flags + warp * kSegment;
  const long long g0 = t0 + warp * kSegment;
#pragma unroll
  for (int s = kSegment / kStep - 1; s >= 0; --s) {
    const int p = s * kStep + 2 * lane;
    const long long g = g0 + p;  // even, so out + g is 16-byte aligned
    const bool b0 = seg[p] != 0, b1 = seg[p + 1] != 0;
    const long long at1 = b1 ? base + g + 1 : n;
    const long long incl = warp_suffix_min(b0 ? base + g : at1, lane);
    long long after = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) after = n;
    after = llmin(after, right);
    const long long o1 = b1 ? at1 : after;
    const long long o0 = b0 ? base + g : o1;
    if (g + 1 < len)
      *reinterpret_cast<longlong2*>(out + g) = make_longlong2(o0, o1);
    else if (g < len)
      out[g] = o0;
    right = llmin(right, __shfl_sync(kFull, incl, 0));
  }
}

}  // namespace

// Slots of int64 scratch that next_set needs for ``len`` flags: one a tile.
extern "C" long long next_set_scratch_len(long long len) {
  return (len + kTile - 1) / kTile;
}

// flags: (len,) bytes, nonzero = set; scratch: next_set_scratch_len(len)
// int64; out: (len,) int64, 16-byte aligned. Launches on ``stream`` and
// returns the first cudaGetLastError() that is not 0 (0 on success); it
// does not synchronise.
extern "C" int next_set(const void* flags, long long len, long long base,
                        long long n, void* scratch, void* out, void* stream) {
  if (len <= 0) return 0;
  long long lim = n - base;
  lim = lim < 0 ? 0 : (lim > len ? len : lim);
  const bool aligned = ((uintptr_t)flags & 15) == 0;
  const long long tiles = next_set_scratch_len(len);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* f = (const unsigned char*)flags;
  long long* firsts = (long long*)scratch;
  next_set_tiles<<<(unsigned int)tiles, kThreads, 0, st>>>(
      f, lim, base, n, aligned, firsts);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  next_set_carry<<<1, kCarryThreads, 0, st>>>(firsts, tiles, n);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  next_set_fill<<<(unsigned int)tiles, kThreads, 0, st>>>(
      f, len, lim, base, n, aligned, firsts, (long long*)out);
  return (int)cudaGetLastError();
}
