// The xyz route of the exact kNN selection: kernels 1 (iq_knn, neighbors.cu)
// and 6 (iq_knn_density, groups.cu) on clouds of C <= 4 channels whose
// database fits a block's shared memory.  The tiled select_knn
// (knn_select.cuh) serves every other shape.
//
// Replaces, with neighbors.cu and groups.cu, ops/pallas/neighbors.py:482
// (_knn_kernel) and ops/pallas/groups.py:337 (_knn_den_kernel) on xyz
// clouds.  What bounds it on H100: operations, 2 C + 3 a distance (0.12 ms
// for kernel 1 a forward of 1650 masked clouds at 67 TFLOP/s).  The tiled
// route is far from that at C = 3 because it is built for C = 64-256, where
// the blocked product is the work: per 64-candidate tile it stages the
// block's queries and the tile, crosses four block barriers, sends the
// distances through shared memory and inserts survivors one at a time.
// This route keeps the distances and cuts what surrounds them.
//
// The design.
//   * The database is staged once per block: N float4s (x, y, z, |d|^2),
//     |d|^2 by the same chain as the distances (C = 4: (x, y, z, w) and the
//     norms apart).  One block barrier follows, and none inside the
//     candidate loop.
//   * A warp per query; its coordinates and |q|^2 stay in registers.  Lane l
//     takes candidates l, l + 32, ..., reading conflict-free float4s.
//   * The selection orders candidates by the key (distance, index), compared
//     lexicographically as floats and ints (-0 == +0, negatives in order).
//     Its result is then that of a stable ascending sort of the distances
//     whatever order the candidates arrive in, so lanes may hold them
//     interleaved.
//   * Pass 1, an exact prefilter: each lane keeps its M smallest keys (M = 2
//     above k = 24, else 1).  These 32 M keys, sorted by bitonic networks of
//     shuffles, give the first list: a warp-wide sorted list of 32 KL
//     entries (KL = ceil(k / 32) <= M; the 32 KL smallest of the 32 M
//     keys), KL registers a lane (entry 32 s + l in lane l's register s).
//     Its entry k - 1 is >= the true k-th key, since k distinct candidates
//     lie at or below it.
//   * Pass 2, in segments of 32 NPL candidates whose distances sit in
//     registers (pass 1's own when the cloud is one segment): a lane marks
//     the candidates whose key is below the list's entry k - 1, apart from
//     its own entries of the list, one compare each and no ballot.  A warp
//     scan of the marks places the survivors in the warp's buffer in shared
//     memory; while 32 or more wait, 32 are sorted by a bitonic network and
//     merged into the list (the list's last 32 against the sorted 32
//     reversed, then a bitonic merge), and entry k - 1 is read again.  The
//     rest is merged at the end.  A stale entry k - 1 only lets through a
//     candidate that the merge then drops.
//   * Collapsed regions (hundreds of candidates at one distance) are the
//     common case: the key rejects the higher-index copies once the list
//     holds lower-index ones, and pass 1 already puts a lane's lowest-index
//     copy in the list.
//
// A distance is the instruction sequence of knn_select.cuh's rule 1: the
// dot product and both norms one explicit fmaf chain over the channels from
// 0.f, then (|q|^2 - 2 q.d) + |d|^2 rounded step by step, then, in the
// instances for the packed and bf16 classes (kKeyed), its class's key
// (select_key) on the whole distance, never on a part of it.  The exact
// class has instances of its own, as on the tiled route: the class's test
// in the candidate loop cost kernel 1 13% on an H100 (PERF.md).  Channels beyond C would add
// fmaf(0, 0, x) = x (x is never -0 here), so the distances, and with equal
// distances the indices, are bit-equal to the tiled route's.
#pragma once

#include <climits>

#include "knn_select.cuh"

namespace {

constexpr int kXyzRoute = 1;         // route numbers of iq_knn / iq_knn_density
constexpr int kTiledRoute = 2;
constexpr int kXyzMaxC = 4;          // widest rows the xyz route takes
constexpr int kXyzWarps = 8;         // warps (queries in flight) per block
constexpr int kXyzThreads = 32 * kXyzWarps;
constexpr int kXyzQueries = 64;      // queries per block
constexpr int kXyzBuffer = 64;       // survivors a warp's buffer holds
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of an xyz block: the staged cloud (N float4s; at C = 4 also
// N norms) and each warp's survivor buffer (distances and indices).
__host__ __device__ __forceinline__ size_t xyz_smem_bytes(int N, int C) {
  return (size_t)N * (C == 4 ? 20 : 16) + (size_t)kXyzWarps * kXyzBuffer * 8;
}

inline bool xyz_fits(int N, int C) {
  return C <= kXyzMaxC && xyz_smem_bytes(N, C) <= (size_t)kMaxSmem;
}

// The route a shape takes: the xyz route wherever it fits, else the tiled one.
inline int knn_route(int N, int C) { return xyz_fits(N, C) ? kXyzRoute : kTiledRoute; }

// Candidates a lane keeps in registers (xyz_select's NPL): a cloud of up to
// 512 rows in one segment of 16 a lane, else segments of 32 a lane.
constexpr int kXyzSmallN = 512;
inline bool xyz_small(int N) { return N <= kXyzSmallN; }

// Keys each lane hands the first list (xyz_select's M): 2 above k = 24, so
// that entry k - 1 is the k-th of 64 keys, not of 32 (at k = 32 the largest
// of the lanes' minima, which lets hundreds of candidates through); else 1,
// which is faster at k = 20 (PERF.md).
constexpr int kXyzDeepK = 24;
inline bool xyz_deep(int k) { return k > kXyzDeepK; }

// info[1..5] of a route query (iq_knn_route, iq_knn_density_route):
// threads a block, blocks a SM holds, dynamic shared memory a block
// (bytes), registers a thread, local memory a thread (bytes).
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, size_t smem, int* info) {
  cudaError_t err;
  if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  info[1] = threads;
  info[3] = (int)smem;
  info[4] = attr.numRegs;
  info[5] = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, threads, smem);
}

__device__ __forceinline__ bool key_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// One compare-exchange of a bitonic network between lane and lane ^ stride:
// the lane keeps the smaller key if keep_min, else the larger.
__device__ __forceinline__ void exchange(float& d, int& i, int stride, bool keep_min) {
  const float pd = __shfl_xor_sync(kFull, d, stride);
  const int pi = __shfl_xor_sync(kFull, i, stride);
  if (keep_min ? key_less(pd, pi, d, i) : key_less(d, i, pd, pi)) {
    d = pd;
    i = pi;
  }
}

// Sort one key a lane ascending over the warp (15 compare-exchanges).
__device__ __forceinline__ void sort32(float& d, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(d, i, stride, ((lane & stride) == 0) == ((lane & size) == 0));
}

// Merge 32 keys sorted ascending over the warp (w) into the sorted list of
// 32 KL entries (v), keeping its 32 KL smallest.
template <int KL>
__device__ __forceinline__ void merge32(float (&vd)[KL], int (&vi)[KL], float wd, int wi,
                                        int lane) {
  const float rd = __shfl_sync(kFull, wd, 31 - lane);
  const int ri = __shfl_sync(kFull, wi, 31 - lane);
  if (key_less(rd, ri, vd[KL - 1], vi[KL - 1])) {   // the list's last 32 vs w reversed:
    vd[KL - 1] = rd;                                // the 32 KL smallest, bitonic
    vi[KL - 1] = ri;
  }
  if (KL == 2 && key_less(vd[KL - 1], vi[KL - 1], vd[0], vi[0])) {   // stride 32
    const float td = vd[0];
    const int ti = vi[0];
    vd[0] = vd[KL - 1];
    vi[0] = vi[KL - 1];
    vd[KL - 1] = td;
    vi[KL - 1] = ti;
  }
#pragma unroll
  for (int s = 0; s < KL; ++s)
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
      exchange(vd[s], vi[s], stride, (lane & stride) == 0);
}

// The staged cloud of a block.
struct XyzCloud {
  const float4* rows;    // (x, y, z, |d|^2), or (x, y, z, w) at C = 4
  const float* norms;    // |d|^2 at C = 4
  int N, C;
  SelectKey key;         // the selection class of the launch
};

// Stage db (N rows of C floats) into shared memory; every thread of the
// block calls it, and it ends with the block's one barrier.  Returns the
// staged cloud and, through buffer, where the survivor buffers start.
__device__ __forceinline__ XyzCloud xyz_stage(const float* __restrict__ db, int N, int C,
                                              SelectKey key, float* smem, float** buffer) {
  float4* rows = reinterpret_cast<float4*>(smem);
  float* norms = smem + (size_t)4 * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float* p = db + (size_t)n * C;
    const float x = __ldg(p);
    const float y = C > 1 ? __ldg(p + 1) : 0.f;
    const float z = C > 2 ? __ldg(p + 2) : 0.f;
    float n2 = fmaf(x, x, 0.f);
    n2 = fmaf(y, y, n2);
    n2 = fmaf(z, z, n2);
    if (C == 4) {
      const float w = __ldg(p + 3);
      norms[n] = fmaf(w, w, n2);
      rows[n] = make_float4(x, y, z, w);
    } else {
      rows[n] = make_float4(x, y, z, n2);
    }
  }
  *buffer = smem + (size_t)N * (C == 4 ? 5 : 4);
  __syncthreads();
  return XyzCloud{rows, norms, N, C, key};
}

// The key of candidate c for the query (q, q2): knn_select.cuh's rule 1,
// then, if kKeyed, select_key.
template <bool kKeyed>
__device__ __forceinline__ float xyz_distance(const XyzCloud& cl, float4 q, float q2, int c) {
  const float4 r = cl.rows[c];
  float dot = fmaf(q.x, r.x, 0.f);
  dot = fmaf(q.y, r.y, dot);
  dot = fmaf(q.z, r.z, dot);
  float d2 = r.w;
  if (cl.C == 4) {
    dot = fmaf(q.w, r.w, dot);
    d2 = cl.norms[c];
  }
  const float d = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)), d2);
  return select_key<kKeyed>(d, cl.key);
}

// Entry e of the warp's sorted list (e uniform over the warp).
template <int KL>
__device__ __forceinline__ void list_key(const float (&vd)[KL], const int (&vi)[KL], int e,
                                         float& d, int& i) {
  const int s = KL == 1 ? 0 : e >> 5;
  d = __shfl_sync(kFull, s == 0 ? vd[0] : vd[KL - 1], e & 31);
  i = __shfl_sync(kFull, s == 0 ? vi[0] : vi[KL - 1], e & 31);
}

// Distances of one lane's candidates c0, c0 + 32, ..., c0 + 32 (NPL - 1) of
// a segment (+inf beyond N).
template <int NPL, bool kKeyed>
__device__ __forceinline__ void xyz_segment(const XyzCloud& cl, float4 q, float q2, int c0,
                                            float (&dr)[NPL]) {
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = c0 + 32 * j;
    dr[j] = c < cl.N ? xyz_distance<kKeyed>(cl, q, q2, c) : CUDART_INF_F;
  }
}

// Merge the first 32 entries of the warp's buffer into the list while 32
// or more are waiting; the rest move down.  Refreshes (td, ti), entry k - 1.
template <int KL>
__device__ __forceinline__ void drain(float* bd, int* bi, int& count, int k, int lane,
                                      float (&vd)[KL], int (&vi)[KL], float& td, int& ti) {
  while (count >= 32) {
    __syncwarp();
    float wd = bd[lane];
    int wi = bi[lane];
    const bool rest = lane + 32 < count;
    const float rd = rest ? bd[lane + 32] : 0.f;
    const int ri = rest ? bi[lane + 32] : 0;
    __syncwarp();
    if (rest) {
      bd[lane] = rd;
      bi[lane] = ri;
    }
    __syncwarp();
    count -= 32;
    sort32(wd, wi, lane);
    merge32<KL>(vd, vi, wd, wi, lane);
    list_key<KL>(vd, vi, k - 1, td, ti);
  }
}

// The k nearest rows of the staged cloud to the query row qp (C floats),
// for one warp: on return lane l holds list entries 32 s + l in (vd[s],
// vi[s]), ascending by (distance, index); entries 0..k-1 are the answer.
// buf: this warp's kXyzBuffer distances, then kXyzBuffer indices.
// k <= 32 KL, k <= N; distances finite (as the tiled route assumes).
//
// The candidates come in segments of 32 NPL, NPL a lane, whose distances
// sit in registers: with N <= 32 NPL (one segment) pass 2 reuses pass 1's,
// else it computes each segment's again.  Pass 2 marks a lane's survivors
// in a bit mask (one compare each, no ballot), and a warp scan of their
// counts places them in the buffer, lane by lane in ascending index, as
// many as it holds; a survivor's distance is computed again as it is
// written, and tested against entry k - 1 as it stands then (one that fails
// goes in as an empty key, +inf, which every merge drops).
template <int KL, int M, int NPL, bool kKeyed>
__device__ __forceinline__ void xyz_select(const XyzCloud& cl, const float* __restrict__ qp,
                                           int k, float* buf, int lane, float (&vd)[KL],
                                           int (&vi)[KL]) {
  float* bd = buf;
  int* bi = reinterpret_cast<int*>(buf + kXyzBuffer);
  const int C = cl.C, N = cl.N;
  float4 q;
  q.x = __ldg(qp);
  q.y = C > 1 ? __ldg(qp + 1) : 0.f;
  q.z = C > 2 ? __ldg(qp + 2) : 0.f;
  q.w = C > 3 ? __ldg(qp + 3) : 0.f;
  float q2 = fmaf(q.x, q.x, 0.f);
  q2 = fmaf(q.y, q.y, q2);
  q2 = fmaf(q.z, q.z, q2);
  if (C == 4) q2 = fmaf(q.w, q.w, q2);
  constexpr int kSeg = 32 * NPL;
  const int nseg = (N + kSeg - 1) / kSeg;
  float dr[NPL];

  // pass 1: this lane's M smallest keys.  Its candidates come in ascending
  // index, so a strict '<' on the distance keeps the earlier of two equals.
  static_assert(KL <= M && M <= 2, "a lane hands the list 1 or 2 keys");
  float pd[M];
  int pi[M];
#pragma unroll
  for (int s = 0; s < M; ++s) {
    pd[s] = CUDART_INF_F;
    pi[s] = INT_MAX;
  }
  for (int g = 0; g < nseg; ++g) {
    xyz_segment<NPL, kKeyed>(cl, q, q2, g * kSeg + lane, dr);
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int c = g * kSeg + 32 * j + lane;
      if (dr[j] < pd[M - 1]) {
        if (M == 2 && dr[j] < pd[0]) {
          pd[M - 1] = pd[0];
          pi[M - 1] = pi[0];
          pd[0] = dr[j];
          pi[0] = c;
        } else {
          pd[M - 1] = dr[j];
          pi[M - 1] = c;
        }
      }
    }
  }
  const int own0 = pi[0], own1 = pi[M - 1];    // this lane's keys in the list
  vd[0] = pd[0];
  vi[0] = pi[0];
  sort32(vd[0], vi[0], lane);
  if (KL == 2) {
    vd[KL - 1] = CUDART_INF_F;
    vi[KL - 1] = INT_MAX;
  }
  if (M == 2) {
    float wd = pd[M - 1];
    int wi = pi[M - 1];
    sort32(wd, wi, lane);
    merge32<KL>(vd, vi, wd, wi, lane);
  }
  float td;
  int ti;
  list_key<KL>(vd, vi, k - 1, td, ti);

  // pass 2: survivors below entry k - 1, segment by segment
  int count = 0;
  for (int g = 0; g < nseg; ++g) {
    const int base = g * kSeg + lane;
    if (nseg > 1) xyz_segment<NPL, kKeyed>(cl, q, q2, base, dr);
    unsigned mine = 0;
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      if (key_less(dr[j], base + 32 * j, td, ti)) mine |= 1u << j;
    if (own0 - base >= 0 && own0 - base < kSeg) mine &= ~(1u << ((own0 - base) >> 5));
    if (own1 - base >= 0 && own1 - base < kSeg) mine &= ~(1u << ((own1 - base) >> 5));
    while (true) {
      const int n = __popc(mine);
      int end = n;                                    // inclusive scan of n
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int t = __shfl_up_sync(kFull, end, s);
        if (lane >= s) end += t;
      }
      const int total = __shfl_sync(kFull, end, 31);
      if (total == 0) break;
      for (int at = count + end - n; mine && at < kXyzBuffer; ++at) {
        const int j = __ffs(mine) - 1;
        mine &= mine - 1;
        const int c = base + 32 * j;
        const float d = xyz_distance<kKeyed>(cl, q, q2, c);
        const bool keep = key_less(d, c, td, ti);
        bd[at] = keep ? d : CUDART_INF_F;
        bi[at] = keep ? c : INT_MAX;
      }
      count = min(count + total, kXyzBuffer);
      drain<KL>(bd, bi, count, k, lane, vd, vi, td, ti);
    }
  }
  if (count > 0) {
    __syncwarp();
    float wd = lane < count ? bd[lane] : CUDART_INF_F;
    int wi = lane < count ? bi[lane] : INT_MAX;
    sort32(wd, wi, lane);
    merge32<KL>(vd, vi, wd, wi, lane);
  }
  __syncwarp();                 // the buffer's reads are done before the next query
}

}  // namespace
