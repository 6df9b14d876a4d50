// Mode 1's emission on the card for NVIDIA Hopper (sm_90a): the filters,
// the alignments and the .snp text of genotyping mode.
//
// Replaces no TPU kernel. The JAX package emits on the host in numpy
// (ebwt2indel_tpu/models/emit_vec.py::emit_single), and so did the port
// (ebwt2indel_torch/models/emit_vec.py::emit_single_plain, kept as the plain
// version). It was added to move the host's emission off the critical path:
// in the benchmark's mode1-ecoli25x-hivar cell on an H100 (80GB HBM3, 700 W)
// the numpy half and the per-record Python loop took 0.91 s, 44% of a
// sample, while the card idled.
//
// What it computes, for the B clusters that passed the base-count filter
// (the reference's to_file single, ebwt2InDel.cpp:1254-1330, as
// emit.SnpWriter.write_single_cluster has it, every quirk kept):
//   * the variants: the characters c in ACGT order with found, freq[c] and
//     full[c] set; a cluster of two or more is counted (it advances
//     cluster_nr, written or not);
//   * max_dist over consecutive variants' left contexts only; the good
//     variants (support >= mcov_out), in the same order;
//   * a counted cluster is written when max_dist <= max_snvs, it has two good
//     variants or more, and its right context does not start with a run of
//     `complexity` equal bases (has_run: a k longer than the context is
//     never a run); then every good variant i is a record whose event type
//     aligns good[max(i - 1, 0)] against good[1];
//   * distance(): right-aligned Hamming distances with the indel at the
//     right end; the first minimum gap wins, the no-indel alignment only
//     when strictly smaller than both indel minima, and an a/b tie goes to b
//     (ebwt2InDel.cpp:192-240). Gaps stop at L: a gap past L scores more
//     than the gap of L, whose score is L, so it is never the minimum;
//   * the seven counts of emit_vec.SINGLE_COUNTS.
// The text is the records, each
//   >cluster:N_id:I_right:R_cov:C_type:_SNP_event:X/Y\n<left><right>\n
// (or _INDEL_event:SEQ/ or _INDEL_event:/SEQ), byte for byte the plain
// version's.
//
// What bounds it on this card: its launches and its two copies to the host,
// not bytes. A cluster reads about 4 L + R + 60 bytes and a record writes
// about 115: some 7 MB for the 62,000 records of a hivar sample, 2 us at
// 3.35 TB/s, against a few microseconds a launch and a host synchronise.
//
// What the design does about it: one thread a cluster, in three launches and
// one copy of counts between them.
//   1. emit_plan: the cluster's variants, its distances (a context of up to
//      32 bases is one 64-bit word at 2 bits a base, so each shifted
//      distance is a shift, an XOR, a fold, a mask and a popcount; longer
//      contexts, since -L is a flag, compare byte by byte), its filters, its
//      records' bytes without their cluster number's digits, and the counts
//      (a warp sum, then one atomic a warp and count).
//   2. emit_scan: one block scans the counted flags into cluster numbers and,
//      in the same pass, the records' bytes (now with the numbers' digits)
//      into each cluster's byte offset, and writes the total.
//   The host copies the seven counts and the text's length, allocates the
//   text at its exact size, and launches
//   3. emit_write: each written cluster writes its records at its offset.
// Per-cluster scratch is three int32 and one int64 offset; the text is the
// only other allocation. Contexts and right contexts hold the walks' codes
// 0-3 (TERM, 4, ends a right context and never enters a variant's context);
// the text maps codes through the decode table of ebwt2indel_torch/utils/
// dna.py (code 4 to the terminator).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kCounts = 7;  // emit_vec.SINGLE_COUNTS, in its order
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kLowBits = 0x5555555555555555ull;

struct Inputs {
  const unsigned char* found;  // (B,)
  const unsigned char* freq;   // (B, 4)
  const unsigned char* full;   // (B, 4)
  const long long* support;    // (B, 4)
  const signed char* ctx;      // (B, 4, L) codes
  const signed char* seq;      // (B, R) codes
  const long long* seqlen;     // (B,)
  long long B;
  int L, R;
  long long mcov, max_snvs, complexity;
  int max_gap;
  unsigned char term;
};

struct Dist {
  int d;  // mismatches before the indel
  int g;  // signed indel length: > 0 inserted in a, < 0 in b
};

// one cluster's four left contexts
struct Contexts {
  const signed char* row;  // (4, L)
  int L;
  bool packed;             // L <= 32: w[c] holds base t at bits 2t, 2t + 1
  unsigned long long w[4];
};

__device__ __forceinline__ void load_contexts(const Inputs& in, long long j,
                                              Contexts* c) {
  c->row = in.ctx + j * 4 * in.L;
  c->L = in.L;
  c->packed = in.L <= 32;
  if (!c->packed) return;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    unsigned long long w = 0;
    for (int t = 0; t < in.L; ++t)
      w |= (unsigned long long)(c->row[v * in.L + t] & 3) << (2 * t);
    c->w[v] = w;
  }
}

// mismatches between a[x, x + n) and b[y, y + n) of contexts a and b
__device__ __forceinline__ int mismatches(const Contexts& c, int a, int b,
                                          int x, int y, int n) {
  if (n <= 0) return 0;
  if (c.packed) {
    unsigned long long d = (c.w[a] >> (2 * x)) ^ (c.w[b] >> (2 * y));
    d = (d | (d >> 1)) & kLowBits;
    if (n < 32) d &= (1ull << (2 * n)) - 1;
    return __popcll(d);
  }
  const signed char* pa = c.row + a * c.L + x;
  const signed char* pb = c.row + b * c.L + y;
  int m = 0;
  for (int t = 0; t < n; ++t) m += pa[t] != pb[t];
  return m;
}

// emit.distance(a, b, max_gap) of contexts a and b
__device__ Dist distance(const Contexts& c, int a, int b, int max_gap) {
  const int L = c.L;
  const int none = mismatches(c, a, b, 0, 0, L);
  if (max_gap == 0) return {none, 0};
  const int gmax = max_gap < L ? max_gap : L;
  int best_ab = 0x7fffffff, g_ab = 0, best_ba = 0x7fffffff, g_ba = 0;
  for (int g = 1; g <= gmax; ++g) {
    const int ab = mismatches(c, a, b, 0, g, L - g) + g;  // a[:L-g], b[g:]
    if (ab < best_ab) best_ab = ab, g_ab = g;
    const int ba = mismatches(c, a, b, g, 0, L - g) + g;  // a[g:], b[:L-g]
    if (ba < best_ba) best_ba = ba, g_ba = g;
  }
  if (none < best_ab && none < best_ba) return {none, 0};
  if (best_ab < best_ba) return {best_ab - g_ab, g_ab};
  return {best_ba - g_ba, -g_ba};
}

// emit.has_run over the cluster's right context
__device__ __forceinline__ bool has_run(const signed char* s, long long len,
                                        long long k) {
  if (k > len) return false;
  for (long long i = 1; i < k; ++i)
    if (s[i] != s[i - 1]) return false;
  return true;
}

// the variants of cluster j in ACGT order; returns how many
__device__ __forceinline__ int variants(const Inputs& in, long long j,
                                        int* var) {
  int n = 0;
  if (!in.found[j]) return 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (in.freq[4 * j + c] && in.full[4 * j + c]) var[n++] = c;
  return n;
}

// the good variants among ``var``, in order; returns how many
__device__ __forceinline__ int good_variants(const Inputs& in, long long j,
                                             const int* var, int nvar,
                                             int* good) {
  int n = 0;
  for (int i = 0; i < nvar; ++i)
    if (in.support[4 * j + var[i]] >= in.mcov) good[n++] = var[i];
  return n;
}

__device__ __forceinline__ int digits(long long v) {
  unsigned long long u = v < 0 ? 0ull - (unsigned long long)v
                               : (unsigned long long)v;
  int n = 1;
  while (u >= 10) u /= 10, ++n;
  return n + (v < 0);
}

__device__ __forceinline__ char* put_int(char* o, long long v) {
  const int n = digits(v);
  unsigned long long u = v < 0 ? 0ull - (unsigned long long)v
                               : (unsigned long long)v;
  if (v < 0) o[0] = '-';
  for (int k = n - 1; k >= (v < 0); --k) o[k] = (char)('0' + u % 10), u /= 10;
  return o + n;
}

template <int N>
__device__ __forceinline__ char* put_lit(char* o, const char (&s)[N]) {
#pragma unroll
  for (int k = 0; k < N - 1; ++k) o[k] = s[k];
  return o + N - 1;
}

__device__ __forceinline__ char decode(signed char code, unsigned char term) {
  switch (code) {
    case 0: return 'A';
    case 1: return 'C';
    case 2: return 'G';
    case 3: return 'T';
    case 4: return (char)term;
    default: return 0;
  }
}

__device__ __forceinline__ char* put_codes(char* o, const signed char* s,
                                           long long n, unsigned char term) {
  for (long long k = 0; k < n; ++k) o[k] = decode(s[k], term);
  return o + n;
}

// the bytes of one record without its cluster number's digits: the 28 bytes
// of ">cluster:", "_id:", "_right:", "_cov:", "_", two newlines, the type's
// 19 + |G| ("type:_SNP_event:X/Y", "type:_INDEL_event:" SEQ "/"), and the
// numbers and contexts
__device__ __forceinline__ long long record_bytes(int id, long long right,
                                                  long long cov, Dist d,
                                                  int L) {
  return 28 + digits(id) + digits(right) + digits(cov) + 19 +
         (d.g < 0 ? -d.g : d.g) + L + right;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) x += __shfl_down_sync(kFull, x, k);
  return x;
}

__global__ void __launch_bounds__(kThreads)
emit_plan(Inputs in, int* __restrict__ nrec_counted,
          int* __restrict__ base_bytes,
          unsigned long long* __restrict__ totals) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  int cnt[kCounts] = {0, 0, 0, 0, 0, 0, 0};
  if (j < in.B) {
    int var[4], good[4];
    const int nvar = variants(in, j, var);
    int nrec = 0;
    long long bytes = 0;
    if (nvar >= 2) {
      Contexts c;
      load_contexts(in, j, &c);
      int max_dist = 0;
      for (int i = 0; i + 1 < nvar; ++i) {
        const int d = distance(c, var[i], var[i + 1], in.max_gap).d;
        max_dist = d > max_dist ? d : max_dist;
      }
      const int n_good = good_variants(in, j, var, nvar, good);
      const long long right = in.seqlen[j];
      const bool run_fail = has_run(in.seq + j * in.R, right, in.complexity);
      const bool kept_v = max_dist <= in.max_snvs;
      const bool emitting = kept_v && n_good >= 2;
      cnt[0] = 1;
      cnt[1] = !kept_v;
      cnt[2] = kept_v && n_good < 2;
      cnt[3] = emitting && run_fail;
      cnt[6] = kept_v && max_dist >= 2;
      if (emitting && !run_fail) {
        nrec = n_good;
        for (int i = 0; i < n_good; ++i) {
          const Dist d = distance(c, good[i > 0 ? i - 1 : 0], good[1],
                                  in.max_gap);
          cnt[5] += d.d > 0 && d.g != 0;
          bytes += record_bytes(i + 1, right, in.support[4 * j + good[i]], d,
                                in.L);
        }
      }
    }
    cnt[4] = nrec;
    nrec_counted[j] = (nrec << 1) | (nvar >= 2);
    base_bytes[j] = (int)bytes;
  }
#pragma unroll
  for (int k = 0; k < kCounts; ++k) {
    const int s = warp_sum(cnt[k]);
    if ((threadIdx.x & 31) == 0 && s != 0)
      atomicAdd(totals + k, (unsigned long long)s);
  }
}

// the exclusive prefix sum of x over the block, and the block's total;
// ``s_warp`` holds kScanThreads / 32 values and is free on entry and exit
__device__ __forceinline__ long long block_exclusive(long long x,
                                                     long long* s_warp,
                                                     long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  long long before = 0, all = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
    if (w < warp) before += s_warp[w];
    all += s_warp[w];
  }
  __syncthreads();
  *total = all;
  return before + incl - x;
}

__global__ void __launch_bounds__(kScanThreads)
emit_scan(const int* __restrict__ nrec_counted,
          const int* __restrict__ base_bytes, long long B,
          int* __restrict__ cluster_nr, long long* __restrict__ offset,
          unsigned long long* __restrict__ totals) {
  __shared__ long long s_warp[kScanThreads / 32];
  constexpr long long kChunk = (long long)kScanThreads * kScanItems;
  long long nr = 1, off = 0;  // the next cluster number and byte offset
  for (long long c0 = 0; c0 < B; c0 += kChunk) {
    const long long e0 = c0 + (long long)threadIdx.x * kScanItems;
    int rc[kScanItems];
    int counted = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      rc[k] = e0 + k < B ? nrec_counted[e0 + k] : 0;
      counted += rc[k] & 1;
    }
    long long total;
    long long my_nr = nr + block_exclusive(counted, s_warp, &total);
    nr += total;
    long long bytes[kScanItems];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      bytes[k] = 0;
      if (e0 + k < B) {
        bytes[k] = base_bytes[e0 + k] +
                   (long long)(rc[k] >> 1) * digits(my_nr);
        cluster_nr[e0 + k] = (int)my_nr;
      }
      my_nr += rc[k] & 1;
      sum += bytes[k];
    }
    long long my_off = off + block_exclusive(sum, s_warp, &total);
    off += total;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (e0 + k < B) offset[e0 + k] = my_off;
      my_off += bytes[k];
    }
  }
  if (threadIdx.x == 0) totals[kCounts] = (unsigned long long)off;
}

__global__ void __launch_bounds__(kThreads)
emit_write(Inputs in, const int* __restrict__ nrec_counted,
           const int* __restrict__ cluster_nr,
           const long long* __restrict__ offset, char* __restrict__ out) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= in.B || (nrec_counted[j] >> 1) == 0) return;
  int var[4], good[4];
  const int nvar = variants(in, j, var);
  const int n_good = good_variants(in, j, var, nvar, good);
  Contexts c;
  load_contexts(in, j, &c);
  const int L = in.L;
  const long long right = in.seqlen[j];
  const signed char* seq = in.seq + j * in.R;
  const int nr = cluster_nr[j];
  char* o = out + offset[j];
  for (int i = 0; i < n_good; ++i) {
    const int a = good[i > 0 ? i - 1 : 0], b = good[1];
    const Dist d = distance(c, a, b, in.max_gap);
    o = put_lit(o, ">cluster:");
    o = put_int(o, nr);
    o = put_lit(o, "_id:");
    o = put_int(o, i + 1);
    o = put_lit(o, "_right:");
    o = put_int(o, right);
    o = put_lit(o, "_cov:");
    o = put_int(o, in.support[4 * j + good[i]]);
    if (d.g == 0) {
      o = put_lit(o, "_type:_SNP_event:");
      *o++ = decode(c.row[a * L + L - 1], in.term);
      *o++ = '/';
      *o++ = decode(c.row[b * L + L - 1], in.term);
    } else if (d.g > 0) {
      o = put_lit(o, "_type:_INDEL_event:");
      o = put_codes(o, c.row + a * L + L - d.g, d.g, in.term);
      *o++ = '/';
    } else {
      o = put_lit(o, "_type:_INDEL_event:/");
      o = put_codes(o, c.row + b * L + L + d.g, -d.g, in.term);
    }
    *o++ = '\n';
    o = put_codes(o, c.row + good[i] * L, L, in.term);
    o = put_codes(o, seq, right, in.term);
    *o++ = '\n';
  }
}

}  // namespace

// The arguments of both calls, filled by ops/emit_cuda.py (ctypes mirrors
// this layout: 8-byte fields only, so no padding).
struct EmitArgs {
  const void* found;
  const void* freq;
  const void* full;
  const void* support;
  const void* ctx;
  const void* seq;
  const void* seqlen;
  long long B, L, R, mcov, max_snvs, max_gap, complexity, term;
  void* nrec_counted;  // (B,) int32
  void* base_bytes;    // (B,) int32
  void* cluster_nr;    // (B,) int32
  void* offset;        // (B,) int64
  void* totals;        // (8,) int64, zero on entry: the seven counts, bytes
};

static Inputs inputs_of(const EmitArgs* a) {
  Inputs in;
  in.found = (const unsigned char*)a->found;
  in.freq = (const unsigned char*)a->freq;
  in.full = (const unsigned char*)a->full;
  in.support = (const long long*)a->support;
  in.ctx = (const signed char*)a->ctx;
  in.seq = (const signed char*)a->seq;
  in.seqlen = (const long long*)a->seqlen;
  in.B = a->B;
  in.L = (int)a->L;
  in.R = (int)a->R;
  in.mcov = a->mcov;
  in.max_snvs = a->max_snvs;
  in.complexity = a->complexity;
  in.max_gap = (int)a->max_gap;
  in.term = (unsigned char)a->term;
  return in;
}

static unsigned int blocks_of(long long B) {
  return (unsigned int)((B + kThreads - 1) / kThreads);
}

// Launches emit_plan and emit_scan on ``stream``: the counts and the text's
// total bytes land in totals. Returns the first cudaGetLastError() that is
// not 0 (0 on success); it does not synchronise.
extern "C" int emit_single_plan(const EmitArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  emit_plan<<<blocks_of(a->B), kThreads, 0, st>>>(
      inputs_of(a), (int*)a->nrec_counted, (int*)a->base_bytes,
      (unsigned long long*)a->totals);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  emit_scan<<<1, kScanThreads, 0, st>>>(
      (const int*)a->nrec_counted, (const int*)a->base_bytes, a->B,
      (int*)a->cluster_nr, (long long*)a->offset,
      (unsigned long long*)a->totals);
  return (int)cudaGetLastError();
}

// Launches emit_write on ``stream`` after emit_single_plan: ``out`` holds
// totals[7] bytes. Same return as emit_single_plan.
extern "C" int emit_single_write(const EmitArgs* a, void* out, void* stream) {
  if (a->B <= 0) return 0;
  emit_write<<<blocks_of(a->B), kThreads, 0, (cudaStream_t)stream>>>(
      inputs_of(a), (const int*)a->nrec_counted, (const int*)a->cluster_nr,
      (const long long*)a->offset, (char*)out);
  return (int)cudaGetLastError();
}
