// Exact kNN selection shared by the neighbour kernels (neighbors.cu) and
// the PointConv kNN-with-density kernel (groups.cu): the tiled route.
// Clouds of at most 4 channels whose database fits shared memory take the
// xyz route instead (knn_xyz.cuh), which returns the same indices.
//
// Selection semantics are those of a stable ascending sort of the distances:
// ascending squared distance (|q|^2 - 2 q.d) + |d|^2 in f32, ties to the
// lowest database index.  Masked coalitions collapse whole regions onto the
// cloud centre, so exact ties are the common case.  Every kernel that selects
// neighbours calls select_knn or xyz_select, so their indices agree bit for
// bit.
//
// The selection class (sel: exact, packed, bf16; the JAX package's
// IQTPU_KNN_SELECT, config.knn_select_class) changes only what is compared:
// select_key turns each distance into its class's key where the distance's
// last rounding step ends, before any comparison, and everything after it
// orders keys exactly as it ordered distances.  Identical database rows
// still get bit-identical keys, so both rules below, and the distinct-row
// pass, hold at every class.
//
// The tie rule rests on two things:
//   1. a (query, database row) distance is one fixed instruction sequence
//      (an fmaf chain over the channels in ascending order, from 0), so
//      identical database rows get bit-identical distances to a query
//      wherever they sit in a tile, and a point's distance to itself is
//      exactly 0.  Both routes rest on it: they compute a distance by the
//      same instructions, so their distances, and then their indices, are
//      bit-equal;
//   2. on the tiled route (select_knn), the order of arrival: candidates
//      reach a query's sorted list in ascending index and are inserted
//      behind every entry that is <= them, after a strict '<' against the
//      k-th entry (or an earlier, larger value of it: the list is sorted
//      over all its lanes, so a candidate let through in error lands behind
//      entry k - 1), so an equal distance never overtakes an earlier index.
//      The xyz route does not rest on the order of arrival (its lanes hold
//      candidates interleaved): it orders candidates by the key (distance,
//      index), compared lexicographically, which gives the same order.  Nor
//      does kernel 3's compacted scan (select_knn with kCompact), where a
//      distinct row arrives with all its copies: it compares the key too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// The selection classes (the sel argument of iq_knn, iq_knn_gather_extrema
// and iq_knn_density; SELECT_CODES in ops/cuda/neighbors.py).
constexpr int kSelExact = 0;         // the distance itself
constexpr int kSelPacked = 1;        // the distance's bits, low b cleared
constexpr int kSelBf16 = 2;          // the distance rounded to bf16

// A launch's selection class and, for the packed class, the mask of the
// low b = bit_length(N - 1) bits of a distance's pattern (N database rows):
// the JAX package's packed key (bits & ~mask) | column orders as the key
// (bits & ~mask), then the column, which is the (key, index) order here.
struct SelectKey {
  int cls;
  int mask;
};

inline bool select_key_valid(int sel) { return sel >= kSelExact && sel <= kSelBf16; }

inline SelectKey select_key_for(int sel, int N) {
  int b = 0;
  while (b < 31 && (1 << b) < N) ++b;            // bit_length(N - 1)
  return SelectKey{sel, (1 << b) - 1};
}

// The key of a distance at the launch's class, in integer and conversion
// operations only: packed clamps negatives to +0 (as jnp.maximum(d, 0))
// and clears the mask's bits; bf16 rounds to nearest even and widens back.
// Both routes have instances without the key (kKeyed false) for the exact
// class, so that its distances pay no test of the class.
template <bool kKeyed>
__device__ __forceinline__ float select_key(float d, SelectKey key) {
  if (!kKeyed) return d;
  if (key.cls == kSelPacked) {
    const int bits = __float_as_int(d);
    return __int_as_float((bits < 0 ? 0 : bits) & ~key.mask);
  }
  if (key.cls == kSelBf16) return __bfloat162float(__float2bfloat16_rn(d));
  return d;
}

constexpr int kSelThreads = 256;     // threads per block of the selection kernels
constexpr int kQueries = 128;        // queries per block
constexpr int kCands = 64;           // database rows per distance tile
constexpr int kChunk = 16;           // channels staged per step
constexpr int kChunkStride = kChunk + 4;   // row stride of a staged chunk (floats)
constexpr int kDistStride = kCands + 16;   // row stride of the distance tile
constexpr int kChunkRows = kQueries + kCands;
constexpr int kMaxSmem = 232448;     // opt-in shared memory of one block

__host__ __device__ __forceinline__ int round_up4(int c) { return (c + 3) & ~3; }

// Shared memory of select_knn, in floats, for lists of KL * 32 entries:
//   chunk [2][kChunkRows][kChunkStride]  staged channels of the block's queries
//                                        (rows 0..127) and of the tile's database
//                                        rows (128..191), double buffered
//   dist  [kQueries][kDistStride]        distances of the tile
//   q2    [kQueries], d2 [kCands]        squared norms
//   ld    [kQueries][KL * 32]            each query's sorted distances
//   li    [kQueries][KL * 32]            and their indices
// followed by whatever the calling kernel keeps after it.
__host__ __device__ __forceinline__ size_t select_smem_floats(int kl) {
  return (size_t)2 * kChunkRows * kChunkStride + (size_t)kQueries * kDistStride +
         kQueries + kCands + (size_t)2 * kQueries * kl * 32;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;       // 0 source bytes: the 16 bytes are zero filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
// cp.async of one 4-byte word (index rows are contiguous, but start on a
// 16-byte boundary only where their length is a multiple of 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage channels [c0, c0 + kChunk) of `rows` rows into dst[r][kChunkStride].
// Row r is number r0 + r of the nsrc rows listed in idx (src row idx[r0 + r];
// with idx == nullptr, src row r0 + r), zero beyond nsrc rows and beyond C
// channels.  vec: C % 4 == 0 and src on a 16-byte boundary, so 16-byte async
// copies.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           const int* __restrict__ idx, int r0, int nsrc,
                                           int rows, int C, int c0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kChunk / 4); e += blockDim.x) {
      const int r = e >> 2, c = c0 + 4 * (e & 3);
      const bool live = r0 + r < nsrc && c < C;
      const int sr = !live ? 0 : idx ? idx[r0 + r] : r0 + r;
      cp_async16(dst + r * kChunkStride + 4 * (e & 3),
                 live ? src + (size_t)sr * C + c : src, live);
    }
  } else {
    const int cw = min(kChunk, round_up4(C) - c0);     // channels the caller reads
    for (int e = threadIdx.x; e < rows * cw; e += blockDim.x) {
      const int r = e / cw, c = c0 + (e - r * cw);
      const bool live = r0 + r < nsrc && c < C;
      const int sr = !live ? 0 : idx ? idx[r0 + r] : r0 + r;
      dst[r * kChunkStride + (e - r * cw)] = live ? src[(size_t)sr * C + c] : 0.f;
    }
  }
}

// ------------------------------------------------------ distinct query rows
// Masked coalitions put whole regions on one point, and a network keeps such
// points' features equal layer after layer, so nearly half of a batch's
// query rows are bit-for-bit copies of an earlier row of their cloud.  A copy
// selects what the original selects (the same distances by the same
// instructions), so the selection kernels run the distinct rows only and
// copy_duplicate_rows_kernel hands the results to the copies.  Kernel 3's
// launch also lists each distinct row's copies (copy_lists_kernel, below),
// so that its database, the same cloud, is scanned by distinct rows too.
//
// One block per cloud: first[b, n] = the lowest row of x[b] (S rows of C
// floats) with the bits of row n, found through an open-addressing hash
// table in shared memory (a slot per class of equal rows, holding its
// lowest row; equality checked on the whole row); rows[b, 0..nrows[b])
// lists the rows that are their own first copy, ascending.  Shared memory:
// S hashes and a table of distinct_table(S) ints; O(S) a cloud.
constexpr int kDistinctThreads = 256;
constexpr int kMaxDistinctRows = 12288;       // S whose hashes and table fit shared memory

__host__ __device__ __forceinline__ int distinct_table(int S) {
  int t = 64;
  while (t < 2 * S) t <<= 1;                  // a power of two, at most half full
  return t;
}

__device__ __forceinline__ bool same_row(const unsigned* xb, int m, int n, int C) {
  int c = 0;
  while (c < C && xb[(size_t)m * C + c] == xb[(size_t)n * C + c]) ++c;
  return c == C;
}

__global__ void __launch_bounds__(kDistinctThreads)
distinct_rows_kernel(const float* __restrict__ x, int* __restrict__ first,
                     int* __restrict__ rows, int* __restrict__ nrows, int S, int C) {
  extern __shared__ unsigned hashes[];
  int* table = reinterpret_cast<int*>(hashes + S);
  const int T = distinct_table(S);
  __shared__ int offset[kDistinctThreads + 1];
  const unsigned* xb = reinterpret_cast<const unsigned*>(x) + (size_t)blockIdx.x * S * C;
  int* fb = first + (size_t)blockIdx.x * S;
  for (int n = threadIdx.x; n < S; n += blockDim.x) {
    unsigned h = 2166136261u;
    for (int c = 0; c < C; ++c) h = (h ^ xb[(size_t)n * C + c]) * 16777619u;
    hashes[n] = h;
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) table[t] = -1;
  __syncthreads();
  // each row finds its class's slot (linear probing from its hash), claims
  // an empty one, or lowers the slot's row to its own; fb[n] holds the slot
  for (int n = threadIdx.x; n < S; n += blockDim.x) {
    const unsigned h = hashes[n];
    for (int slot = h & (T - 1);; slot = (slot + 1) & (T - 1)) {
      int m = table[slot];
      if (m < 0 && (m = atomicCAS(&table[slot], -1, n)) < 0) {
        fb[n] = slot;
        break;
      }
      if (hashes[m] == h && same_row(xb, m, n, C)) {
        atomicMin(&table[slot], n);
        fb[n] = slot;
        break;
      }
    }
  }
  __syncthreads();
  for (int n = threadIdx.x; n < S; n += blockDim.x) fb[n] = table[fb[n]];
  __syncthreads();
  // compaction: each thread a stretch of rows, the stretches' counts scanned
  const int per = (S + blockDim.x - 1) / blockDim.x;
  const int lo = min(S, (int)threadIdx.x * per), hi = min(S, lo + per);
  int mine = 0;
  for (int n = lo; n < hi; ++n) mine += fb[n] == n;
  offset[threadIdx.x + 1] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    offset[0] = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) offset[t + 1] += offset[t];
    nrows[blockIdx.x] = offset[blockDim.x];
  }
  __syncthreads();
  int at = offset[threadIdx.x];
  int* rb = rows + (size_t)blockIdx.x * S;
  for (int n = lo; n < hi; ++n)
    if (fb[n] == n) rb[at++] = n;
}

// out[b, n, :] = out[b, first[b, n], :] for every row that is a copy; F
// 4-byte values per row (floats or indices).  A warp a row (32 lanes over
// F), grid-stride over the rows, so a launch has at most kCopyBlocks blocks
// however many rows it copies.
constexpr int kCopyRows = 8;                  // rows (warps) per block
constexpr int kCopyBlocks = 4096;             // most blocks of a launch

__global__ void __launch_bounds__(32 * kCopyRows)
copy_duplicate_rows_kernel(const int* __restrict__ first, float* __restrict__ out0,
                           float* __restrict__ out1, int S, long long nrows_total, int F) {
  for (long long row = (long long)blockIdx.x * kCopyRows + threadIdx.y; row < nrows_total;
       row += (long long)gridDim.x * kCopyRows) {
    const int n = (int)(row % S);
    const int src = first[row];
    if (src == n) continue;
    const size_t to = (size_t)row * F, from = (size_t)(row - n + src) * F;
    for (int f = threadIdx.x; f < F; f += 32) {
      out0[to + f] = out0[from + f];
      if (out1 != nullptr) out1[to + f] = out1[from + f];
    }
  }
}

// ------------------------------------------------------ kernel 3's copy lists
// For iq_knn_gather_extrema only, after distinct_rows_kernel: each distinct
// row's copies, as a per-cloud CSR (compressed sparse row) list, so that
// select_knn can scan the distinct database rows and still hand the list
// every copy.  Distinct row p = rows[b, p] has the copies
// copies[b, starts[b, p] .. starts[b, p + 1]), ascending, itself first
// (a class's lowest row is its first copy); starts[b, nrows[b]] = S.
//
// One block per cloud.  Each row's class (the place of its first copy in
// rows) is counted with shared atomics, one a class and warp: a count is
// the same in any order.  The counts are scanned into starts.  Then one warp
// walks the rows in ascending order, 32 a step, and puts each at its class's
// next slot, the lanes of one class ranked by lane (__match_any_sync), so
// the lists come out the same whatever the schedule.  Shared memory: 3 S
// ints.
__global__ void __launch_bounds__(kDistinctThreads)
copy_lists_kernel(const int* __restrict__ first, const int* __restrict__ rows,
                  const int* __restrict__ nrows, int* __restrict__ starts,
                  int* __restrict__ copies, int S) {
  extern __shared__ int place[];               // [S] a distinct row's place in rows
  int* cls = place + S;                        // [S] each row's class
  int* next = cls + S;                         // [S] a class's count, then its next slot
  __shared__ int offset[kDistinctThreads + 1];
  const int tid = threadIdx.x, lane = tid & 31;
  const int nr = nrows[blockIdx.x];
  const int* fb = first + (size_t)blockIdx.x * S;
  const int* rb = rows + (size_t)blockIdx.x * S;
  int* sb = starts + (size_t)blockIdx.x * (S + 1);
  int* cb = copies + (size_t)blockIdx.x * S;
  for (int p = tid; p < nr; p += blockDim.x) {
    place[rb[p]] = p;
    next[p] = 0;
  }
  __syncthreads();
  for (int n0 = tid & ~31; n0 < S; n0 += blockDim.x) {     // whole warps a step
    const int n = n0 + lane;
    const int c = n < S ? place[fb[n]] : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    if (n < S) {
      cls[n] = c;
      if ((peers & ((1u << lane) - 1)) == 0) atomicAdd(&next[c], __popc(peers));
    }
  }
  __syncthreads();
  // exclusive scan of the counts: each thread a stretch of classes
  const int per = (nr + blockDim.x - 1) / blockDim.x;
  const int lo = min(nr, tid * per), hi = min(nr, lo + per);
  int mine = 0;
  for (int p = lo; p < hi; ++p) mine += next[p];
  offset[tid + 1] = mine;
  __syncthreads();
  if (tid == 0) {
    offset[0] = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) offset[t + 1] += offset[t];
    sb[nr] = S;
  }
  __syncthreads();
  int at = offset[tid];
  for (int p = lo; p < hi; ++p) {
    const int count = next[p];
    sb[p] = at;
    next[p] = at;
    at += count;
  }
  __syncthreads();
  if (tid < 32) {
    for (int n0 = 0; n0 < S; n0 += 32) {
      const int n = n0 + lane;
      const int c = n < S ? cls[n] : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, c);
      const int before = __popc(peers & ((1u << lane) - 1));
      if (n < S) cb[next[c] + before] = n;
      __syncwarp();
      if (n < S && before == 0) next[c] += __popc(peers);
      __syncwarp();
    }
  }
}

// Launch both passes around a selection kernel: distinct_rows() before it,
// copy_duplicate_rows() after it.  scratch holds B * (2 * S + 1) ints:
// first, rows, nrows; for kernel 3 B * (2 * S + 1) more: starts and copies,
// the copy lists of copy_lists().
struct DistinctRows {
  int* first;
  int* rows;
  int* nrows;
  int* starts;
  int* copies;
  DistinctRows(int* scratch, int B, int S)
      : first(scratch),
        rows(scratch + (size_t)B * S),
        nrows(scratch + (size_t)2 * B * S),
        starts(scratch + (size_t)B * (2 * S + 1)),
        copies(starts + (size_t)B * (S + 1)) {}
};

inline cudaError_t distinct_rows(const float* x, const DistinctRows& d, int B, int S, int C,
                                 cudaStream_t s) {
  if (S > kMaxDistinctRows) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)S + distinct_table(S)) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        distinct_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  distinct_rows_kernel<<<(unsigned)B, kDistinctThreads, smem, s>>>(x, d.first, d.rows,
                                                                   d.nrows, S, C);
  return cudaGetLastError();
}

inline cudaError_t copy_lists(const DistinctRows& d, int B, int S, cudaStream_t s) {
  const size_t smem = (size_t)3 * S * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        copy_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  copy_lists_kernel<<<(unsigned)B, kDistinctThreads, smem, s>>>(d.first, d.rows, d.nrows,
                                                                d.starts, d.copies, S);
  return cudaGetLastError();
}

inline cudaError_t copy_duplicate_rows(const DistinctRows& d, float* out0, float* out1, int B,
                                       int S, int F, cudaStream_t s) {
  const long long total = (long long)B * S;
  const long long blocks = (total + kCopyRows - 1) / kCopyRows;
  copy_duplicate_rows_kernel<<<(unsigned)(blocks < kCopyBlocks ? blocks : kCopyBlocks),
                               dim3(32, kCopyRows), 0, s>>>(d.first, out0, out1, S, total, F);
  return cudaGetLastError();
}

// Entry e of a sorted list spread over a warp: lane l holds entries
// 32 s + l in v[s].
template <int KL, typename T>
__device__ __forceinline__ T list_entry(const T (&v)[KL], int e) {
  T x = __shfl_sync(0xffffffffu, v[0], e & 31);
#pragma unroll
  for (int s = 1; s < KL; ++s) {
    const T y = __shfl_sync(0xffffffffu, v[s], e & 31);
    if ((e >> 5) == s) x = y;
  }
  return x;
}

// Place (d, ci) behind every entry <= d of the warp's sorted list; entries
// behind it move up by one and the last falls off.  All 32 lanes call it
// with the same d and ci.
template <int KL>
__device__ __forceinline__ void list_insert(float (&vd)[KL], int (&vi)[KL], float d, int ci,
                                            int lane) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < KL; ++s) pos += __popc(__ballot_sync(0xffffffffu, vd[s] <= d));
#pragma unroll
  for (int s = KL - 1; s >= 0; --s) {
    float pd = __shfl_up_sync(0xffffffffu, vd[s], 1);
    int pi = __shfl_up_sync(0xffffffffu, vi[s], 1);
    if (s > 0) {
      const float wd = __shfl_sync(0xffffffffu, vd[s > 0 ? s - 1 : 0], 31);
      const int wi = __shfl_sync(0xffffffffu, vi[s > 0 ? s - 1 : 0], 31);
      if (lane == 0) {
        pd = wd;
        pi = wi;
      }
    }
    const int e = 32 * s + lane;
    if (e == pos) {
      vd[s] = d;
      vi[s] = ci;
    } else if (e > pos) {
      vd[s] = pd;
      vi[s] = pi;
    }
  }
}

// ------------------------------------------------ the compacted database
// select_knn<.., kCompact> scans a cloud's distinct database rows only, each
// standing for its copies (copy_lists_kernel).  The list it keeps is still
// the first k of a stable sort by (distance, index) over all N rows, entry
// for entry: copies have bit-identical distances (rule 1), and a distinct
// row at distance d with copies j_1 < ... < j_c is the c keys (d, j_1) ..
// (d, j_c).  A copy may come after a higher-indexed row of another class,
// so the list compares (distance, index) and never relies on the order of
// arrival: it holds the 32 smallest keys inserted, in whatever order.
//   * the filter lets through d < worst, or d == worst with j_1 below
//     worst's index ("worst" the (distance, index) of entry k - 1, refreshed
//     as before: a stale one still only lets through what lands behind it);
//   * the first tile goes into the empty list by rank (rank_first_tile);
//   * after it, of the 32 candidates a ballot filters, the rows of one copy
//     go in first, each behind every key below (d, j_1), the warp's two
//     queries' chains in step;
//   * then each row of c > 1 copies: where no entry has distance d, as one
//     block: the entries behind it move up c lanes and lanes pos .. pos + c - 1
//     read (d, j_1 .. j_c) from the copy list in one coalesced load.  The
//     collapsed centre enters once, where the full scan took up to k
//     insertions;
//   * else (the tie path: another row's entry at distance d) its copies go
//     in one at a time, each behind every key below it, until one falls off
//     the list.  Counted, while tracing, in k3_tie_rows.
struct CopyLists {
  const int* rows;                // the cloud's distinct rows, ascending
  const int* starts;              // their copy lists' offsets (nrows + 1)
  const int* copies;              // the copy lists
  int n;                          // distinct rows
  unsigned long long* tie_rows;   // the tie path's count (nullptr: not counted)
};

// Shared memory select_knn<.., kCompact> takes after li, in 4-byte words:
// each candidate's row and (copies << 16 | start) for a tile, and the count
// of the block's tie-path candidates.
constexpr int kCompactWords = 2 * kCands + 4;
constexpr int kNoRow = 0x7fffffff;   // the row of no candidate: above every index

// Place (d, j) behind every key (distance, index) below it in the warp's
// one-register list; the last entry falls off.  pos >= 32: no change.
__device__ __forceinline__ void shift_in(float& vd, int& vi, float d, int j, int pos,
                                         int lane) {
  const float pd = __shfl_up_sync(0xffffffffu, vd, 1);
  const int pi = __shfl_up_sync(0xffffffffu, vi, 1);
  if (lane == pos) {
    vd = d;
    vi = j;
  } else if (lane > pos) {
    vd = pd;
    vi = pi;
  }
}

__device__ __forceinline__ int keys_below(float vd, int vi, float d, int j) {
  return __popc(__ballot_sync(0xffffffffu, vd < d || (vd == d && vi < j)));
}

// Insert a distinct row of c > 1 copies at distance d, meta = c << 16 |
// start of its copy list (see above).  Warp-uniform arguments; returns 1
// where it took the tie path.
__device__ __forceinline__ int copies_insert(float& vd, int& vi, float d, int meta,
                                             const int* __restrict__ copies, int lane) {
  const int c = meta >> 16;
  const int* cp = copies + (meta & 0xffff);
  if (!__any_sync(0xffffffffu, vd == d)) {
    const int pos = __popc(__ballot_sync(0xffffffffu, vd < d));
    const int r = lane - pos;
    const float pd = __shfl_up_sync(0xffffffffu, vd, c < 32 ? c : 31);
    const int pi = __shfl_up_sync(0xffffffffu, vi, c < 32 ? c : 31);
    if (r >= c) {
      vd = pd;
      vi = pi;
    } else if (r >= 0) {
      vd = d;
      vi = __ldg(cp + r);
    }
    return 0;
  }
  const int cj = lane < c ? __ldg(cp + lane) : 0;
  for (int i = 0; i < c && i < 32; ++i) {
    const int ji = __shfl_sync(0xffffffffu, cj, i);
    const int pos = keys_below(vd, vi, d, ji);
    if (pos >= 32) break;
    shift_in(vd, vi, d, ji, pos, lane);
  }
  return 1;
}

// The first tile of the compacted scan, into a query's empty list (lds,
// lis: its row of ld and li): the tile's rows of one copy with a finite
// distance go to their places by rank, each of the 64 ranked against the
// others in one pass of broadcasts ((distance, place in the tile) orders as
// (distance, row), rows being ascending), where one insertion each took a
// dependent chain of shuffles.  d0, d1: candidates lane and 32 + lane;
// m0, m1 their meta, j0, j1 their rows.  The warp reads the list back after
// a __syncwarp.
__device__ __forceinline__ void rank_first_tile(float* lds, int* lis, float d0, float d1,
                                                int m0, int m1, int j0, int j1, int lane) {
  const float k0 = (m0 >> 16) == 1 && d0 < CUDART_INF_F ? d0 : CUDART_INF_F;
  const float k1 = (m1 >> 16) == 1 && d1 < CUDART_INF_F ? d1 : CUDART_INF_F;
  int r0 = 0, r1 = 0;
#pragma unroll 8
  for (int s = 0; s < 32; ++s) {
    const float e0 = __shfl_sync(0xffffffffu, k0, s), e1 = __shfl_sync(0xffffffffu, k1, s);
    r0 += (e0 < k0 || (e0 == k0 && s < lane)) + (e1 < k0);
    r1 += (e0 <= k1) + (e1 < k1 || (e1 == k1 && s < lane));
  }
  if (k0 < CUDART_INF_F && r0 < 32) {
    lds[r0] = d0;
    lis[r0] = j0;
  }
  if (k1 < CUDART_INF_F && r1 < 32) {
    lds[r1] = d1;
    lis[r1] = j1;
  }
}

// Exact kNN, on the keys of the class `key` (kKeyed: the packed or bf16
// class; else the distances themselves), of queries [q0, q0 + kQueries) of
// the S listed in qrows (rows of `query`; nullptr: its first S rows)
// against one cloud's database rows: all N, or with kCompact (KL = 1) the
// cl.n distinct ones, each with its copies (above).  kCompact takes
// kCompactWords more shared memory after li.
// On return (after a __syncthreads) the sorted indices of query q0 + r are
// li[r * KL * 32 + 0..k-1]; the function returns li.  k <= KL * 32, k <= N.
//
// What bounds it on H100: instructions, not the arithmetic's peak.  The
// distances cost 2*N*C FLOP per query (2.2e11 FLOP for 1650 clouds of 1024
// points at C=64, 3.3 ms at 67 TFLOP/s of f32 outside the tensor cores),
// but a block spends most of its cycles in the selection: an insertion is
// a chain of shuffles and a ballot, about 100 a query over a full scan of a
// masked cloud, half of them while the list fills.  Kernel 3's compacted
// scan (kCompact) takes away both what scales with the rows streamed (d^2
// distances a cloud of d distinct rows, not d N; the filter's ballots) and
// the filling: its first tile goes in by rank.  Measured by clock64 on an
// H100 at DGCNN's layer 2 (C = 64, F = 64) on masked clouds, a kernel 3
// block spends 52% of its cycles in the selection, 30% in the tile loop and
// 18% in the gather.
// The design: the distances are a blocked
// product on the f32 FMA units, so that the fmaf chain of a distance (rule 1
// above) is kept by construction.  A block of 256 threads takes 128 queries
// and streams the database through 64-row tiles; the channels of both come
// 16 at a time through a double-buffered cp.async stage, and each thread
// keeps an 8 x 4 register tile of dot products (queries ty + 16 i,
// candidates tx + 16 j: quarter-warps then read distinct banks and a query
// row is a broadcast).  The finished tile of distances goes to shared
// memory, where the selection is cooperative: a warp takes a query, its 32
// lanes hold the sorted list (KL entries each), a ballot filters the tile's
// candidates against the k-th distance, and each survivor, lowest index
// first, is placed with one ballot/popcount and one shuffle per list
// register (list_insert); a warp runs two queries' chains side by side.
// No lane waits on another query's insertion.  The (N, N) distances never
// reach device memory.
template <int KL, bool kKeyed, bool kCompact = false>
__device__ __forceinline__ int* select_knn(const float* __restrict__ query,
                                           const int* __restrict__ qrows,
                                           const float* __restrict__ db, int S, int N,
                                           int C, int k, int q0, SelectKey key,
                                           float* smem, CopyLists cl = CopyLists{}) {
  static_assert(!kCompact || KL == 1, "the compacted scan keeps one-register lists");
  float* chunk = smem;
  float* dist = chunk + 2 * kChunkRows * kChunkStride;
  float* q2s = dist + kQueries * kDistStride;
  float* d2s = q2s + kQueries;
  float* ld = d2s + kCands;
  int* li = reinterpret_cast<int*>(ld + kQueries * KL * 32);
  constexpr int kList = KL * 32;
  // kCompact: the tile's candidates' rows and (copies << 16 | start), and
  // the block's count of tie-path candidates
  int* cand_row = li + kQueries * kList;
  int* cand_meta = cand_row + kCands;
  int* ties_s = cand_meta + kCands;
  const int ND = kCompact ? cl.n : N;         // database rows scanned
  const int* drows = kCompact ? cl.rows : nullptr;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int c4 = round_up4(C);
  const int nchunks = (c4 + kChunk - 1) / kChunk;
  const int ntiles = (ND + kCands - 1) / kCands;
  const int total = ntiles * nchunks;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(query) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(db) % 16 == 0;

  for (int e = tid; e < kQueries * kList; e += blockDim.x) {
    ld[e] = CUDART_INF_F;
    li[e] = 0;
  }
  if constexpr (kCompact) {
    if (tid == 0) *ties_s = 0;
  }
  int ties = 0;                 // kCompact: this lane's tie-path candidates

  auto stage = [&](int it) {
    float* buf = chunk + (it & 1) * kChunkRows * kChunkStride;
    const int t = it / nchunks, c0 = (it - t * nchunks) * kChunk;
    stage_rows(buf, query, qrows, q0, S, kQueries, C, c0, vec);
    stage_rows(buf + kQueries * kChunkStride, db, drows, t * kCands, ND, kCands, C, c0, vec);
    cp_async_commit();
  };

  float acc[8][4];
  float norm = 0.f;     // |q|^2 of query tid (tid < 128), |d|^2 of candidate tid - 128
  stage(0);
  for (int it = 0; it < total; ++it) {
    const int t = it / nchunks, cc = it - t * nchunks;
    if (it + 1 < total) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = chunk + (it & 1) * kChunkRows * kChunkStride;
    const float* cs = qs + kQueries * kChunkStride;
    if (cc == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (tid >= kQueries || t == 0) norm = 0.f;
      if constexpr (kCompact) {
        if (tid >= kQueries && tid < kChunkRows) {
          const int p = t * kCands + tid - kQueries;
          int row = kNoRow, meta = 1 << 16;       // past the last row: never let through
          if (p < ND) {
            row = drows[p];
            meta = (cl.starts[p + 1] - cl.starts[p]) << 16 | cl.starts[p];
          }
          cand_row[tid - kQueries] = row;
          cand_meta[tid - kQueries] = meta;
        }
      }
    }
    const int cw = min(kChunk, c4 - cc * kChunk);
    // squared norms, the same chain as the dot products
    if ((tid < kQueries && t == 0) || (tid >= kQueries && tid < kChunkRows)) {
      const float* row = qs + tid * kChunkStride;
      for (int c = 0; c < cw; ++c) norm = fmaf(row[c], row[c], norm);
    }
    for (int c = 0; c < cw; c += 4) {
      float4 qv[8], cv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kChunkStride + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cv[j] = *reinterpret_cast<const float4*>(cs + (tx + 16 * j) * kChunkStride + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[i][j];
          a = fmaf(qv[i].x, cv[j].x, a);
          a = fmaf(qv[i].y, cv[j].y, a);
          a = fmaf(qv[i].z, cv[j].z, a);
          a = fmaf(qv[i].w, cv[j].w, a);
          acc[i][j] = a;
        }
    }
    if (cc == nchunks - 1) {
      if (tid < kQueries) {
        if (t == 0) q2s[tid] = norm;
      } else if (tid < kChunkRows) {
        d2s[tid - kQueries] = norm;
      }
      __syncthreads();
      // (|q|^2 - 2 q.d) + |d|^2, rounded step by step (no contraction),
      // then its class's key
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float q2 = q2s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = tx + 16 * j;
          const float d = select_key<kKeyed>(
              __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, acc[i][j])), d2s[cj]), key);
          dist[(ty + 16 * i) * kDistStride + cj] = t * kCands + cj < ND ? d : CUDART_INF_F;
        }
      }
      __syncthreads();
      // cooperative selection: this warp's 16 queries, two at a time (two
      // independent chains of ballots and shuffles in flight)
      constexpr int kPerWarp = kQueries / (kSelThreads / 32);
      for (int qi = 0; qi < kPerWarp; qi += 2) {
        const int ra = warp * kPerWarp + qi, rb = ra + 1;
        if (q0 + ra >= S) break;                    // uniform over the warp
        const bool has_b = q0 + rb < S;
        float ad[KL], bd[KL];
        int ai[KL], bi[KL];
#pragma unroll
        for (int s = 0; s < KL; ++s) {
          ad[s] = ld[ra * kList + 32 * s + lane];
          ai[s] = li[ra * kList + 32 * s + lane];
          bd[s] = ld[rb * kList + 32 * s + lane];
          bi[s] = li[rb * kList + 32 * s + lane];
        }
        bool changed_a = false, changed_b = false;
        if constexpr (kCompact) {
          if (t == 0) {
            // the lists are empty: rows of one copy by rank, then the rows
            // of several copies (the list holds the smallest keys inserted)
            const int j0 = cand_row[lane], j1 = cand_row[32 + lane];
            const int m0 = cand_meta[lane], m1 = cand_meta[32 + lane];
            const float* da_row = dist + ra * kDistStride;
            const float* db_row = dist + rb * kDistStride;
            __syncwarp();                           // every lane has read its lists
            rank_first_tile(ld + ra * kList, li + ra * kList, da_row[lane], da_row[32 + lane],
                            m0, m1, j0, j1, lane);
            if (has_b)
              rank_first_tile(ld + rb * kList, li + rb * kList, db_row[lane],
                              db_row[32 + lane], m0, m1, j0, j1, lane);
            __syncwarp();
            ad[0] = ld[ra * kList + lane];
            ai[0] = li[ra * kList + lane];
            bd[0] = ld[rb * kList + lane];
            bi[0] = li[rb * kList + lane];
            const unsigned multi0 = __ballot_sync(0xffffffffu, (m0 >> 16) != 1);
            const unsigned multi1 = __ballot_sync(0xffffffffu, (m1 >> 16) != 1);
            for (int h = 0; h < 2; ++h) {
              for (unsigned m = h ? multi1 : multi0; m; m &= m - 1) {
                const int s = __ffs(m) - 1, meta = __shfl_sync(0xffffffffu, h ? m1 : m0, s);
                const float ca = da_row[32 * h + s];
                if (ca < CUDART_INF_F) ties += copies_insert(ad[0], ai[0], ca, meta, cl.copies, lane);
                if (has_b) {
                  const float cb = db_row[32 * h + s];
                  if (cb < CUDART_INF_F)
                    ties += copies_insert(bd[0], bi[0], cb, meta, cl.copies, lane);
                }
              }
            }
            __syncwarp();
            changed_a = changed_b = true;
          }
        }
#pragma unroll
        for (int h = 0; h < kCands / 32; ++h) {
          if (kCompact && t == 0) break;
          // the k-th distance, refreshed once per 32 candidates: a stale one
          // only lets a candidate through that then lands behind entry k - 1
          const float worst_a = list_entry<KL>(ad, k - 1);
          const float worst_b = list_entry<KL>(bd, k - 1);
          const float ca = dist[ra * kDistStride + 32 * h + lane];
          const float cb = has_b ? dist[rb * kDistStride + 32 * h + lane] : CUDART_INF_F;
          if constexpr (kCompact) {
            // ties with entry k - 1 go to the lower index: a candidate's
            // lowest copy may precede entries of other rows
            const int wia = list_entry<KL>(ai, k - 1), wib = list_entry<KL>(bi, k - 1);
            const int row = cand_row[32 * h + lane], meta = cand_meta[32 * h + lane];
            const unsigned pa = __ballot_sync(0xffffffffu,
                                              ca < worst_a || (ca == worst_a && row < wia));
            const unsigned pb = __ballot_sync(0xffffffffu,
                                              cb < worst_b || (cb == worst_b && row < wib));
            changed_a |= pa != 0;
            changed_b |= pb != 0;
            // The list holds the 32 smallest keys inserted, whatever their
            // order.  Rows of one copy first, both chains in step (no branch
            // between them); rows of several copies (the collapsed centre)
            // after, a chain at a time.
            const unsigned multi = __ballot_sync(0xffffffffu, (meta >> 16) != 1);
            unsigned sa_left = pa & ~multi, sb_left = pb & ~multi;
            while (sa_left | sb_left) {
              const int sa = sa_left ? __ffs(sa_left) - 1 : 0;
              const int sb = sb_left ? __ffs(sb_left) - 1 : 0;
              float da = __shfl_sync(0xffffffffu, ca, sa);
              float db_ = __shfl_sync(0xffffffffu, cb, sb);
              int ja = __shfl_sync(0xffffffffu, row, sa);
              int jb = __shfl_sync(0xffffffffu, row, sb);
              if (!sa_left) {                       // (+inf, kNoRow) lands behind every entry
                da = CUDART_INF_F;
                ja = kNoRow;
              }
              if (!sb_left) {
                db_ = CUDART_INF_F;
                jb = kNoRow;
              }
              sa_left &= sa_left - 1;
              sb_left &= sb_left - 1;
              shift_in(ad[0], ai[0], da, ja, keys_below(ad[0], ai[0], da, ja), lane);
              shift_in(bd[0], bi[0], db_, jb, keys_below(bd[0], bi[0], db_, jb), lane);
            }
            for (unsigned m = pa & multi; m; m &= m - 1) {
              const int s = __ffs(m) - 1;
              ties += copies_insert(ad[0], ai[0], __shfl_sync(0xffffffffu, ca, s),
                                    __shfl_sync(0xffffffffu, meta, s), cl.copies, lane);
            }
            for (unsigned m = pb & multi; m; m &= m - 1) {
              const int s = __ffs(m) - 1;
              ties += copies_insert(bd[0], bi[0], __shfl_sync(0xffffffffu, cb, s),
                                    __shfl_sync(0xffffffffu, meta, s), cl.copies, lane);
            }
          } else {
            unsigned pa = __ballot_sync(0xffffffffu, ca < worst_a);
            unsigned pb = __ballot_sync(0xffffffffu, cb < worst_b);
            changed_a |= pa != 0;
            changed_b |= pb != 0;
            const int base = t * kCands + 32 * h;
            while (pa | pb) {                       // survivors, lowest index first
              const int sa = pa ? __ffs(pa) - 1 : 0, sb = pb ? __ffs(pb) - 1 : 0;
              float da = __shfl_sync(0xffffffffu, ca, sa);
              float db_ = __shfl_sync(0xffffffffu, cb, sb);
              if (!pa) da = CUDART_INF_F;           // +inf lands behind every entry
              if (!pb) db_ = CUDART_INF_F;
              pa &= pa - 1;
              pb &= pb - 1;
              list_insert<KL>(ad, ai, da, base + sa, lane);
              list_insert<KL>(bd, bi, db_, base + sb, lane);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < KL; ++s) {
          if (changed_a) {
            ld[ra * kList + 32 * s + lane] = ad[s];
            li[ra * kList + 32 * s + lane] = ai[s];
          }
          if (changed_b) {
            ld[rb * kList + 32 * s + lane] = bd[s];
            li[rb * kList + 32 * s + lane] = bi[s];
          }
        }
      }
    }
    __syncthreads();
  }
  if constexpr (kCompact) {
    if (cl.tie_rows != nullptr) {               // one atomicAdd a block
      if (lane == 0 && ties) atomicAdd(ties_s, ties);
      __syncthreads();
      if (tid == 0 && *ties_s) atomicAdd(cl.tie_rows, (unsigned long long)*ties_s);
    }
  }
  return li;
}

// Opt a kernel in to `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
