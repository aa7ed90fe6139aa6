// Exact kNN selection shared by the neighbour kernels (neighbors.cu) and
// the PointConv kNN-with-density kernel (groups.cu).
//
// Selection semantics are those of a stable ascending sort of the distances:
// ascending squared distance |q|^2 - 2 q.d + |d|^2 in f32, ties to the lowest
// database index.  Masked coalitions collapse whole regions onto the cloud
// centre, so exact ties are the common case.  Candidates are scanned in
// ascending index and inserted into a sorted k-list with a strict '<', so an
// equal distance never overtakes an earlier index.  Every kernel that
// selects neighbours calls select_knn, so their indices agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 128;        // queries per block = threads per block
constexpr int kTile = 32;            // database rows staged per shared tile
constexpr int kMaxSmem = 232448;     // opt-in shared memory of one block

__host__ __device__ __forceinline__ int round_up4(int c) { return (c + 3) & ~3; }

// Shared memory of the selection kernels, in floats:
//   ds    [kTile][c4]        database tile, zero padded to a multiple of 4
//   dists [kTile][kQueries]  each thread's distances to the tile rows
//   qs    [kQueries][c4 + 1] this block's queries (odd stride: no bank conflicts)
//   d2s   [kTile]            |d|^2 of the tile rows
// followed by whatever the calling kernel keeps after SelectSmem::end().
__host__ __device__ __forceinline__ size_t select_smem_floats(int c4) {
  return (size_t)kTile * c4 + (size_t)kTile * kQueries +
         (size_t)kQueries * (c4 + 1) + kTile;
}

struct SelectSmem {
  float* ds;
  float* dists;
  float* qs;
  float* d2s;
  __device__ __forceinline__ SelectSmem(float* smem, int c4)
      : ds(smem), dists(smem + kTile * c4), qs(dists + kTile * kQueries),
        d2s(qs + kQueries * (c4 + 1)) {}
  __device__ __forceinline__ int* end() const { return reinterpret_cast<int*>(d2s + kTile); }
};

// |row|^2 as one fmaf chain in channel order: the same chain the dot product
// below runs, so a point's distance to itself is exactly 0.
__device__ __forceinline__ float sqnorm(const float* row, int c4) {
  float acc = 0.f;
  for (int c = 0; c < c4; ++c) acc = fmaf(row[c], row[c], acc);
  return acc;
}

// Exact kNN of this block's queries against one cloud's database; on return
// thread t holds the k nearest (ascending) of query q0 + t in bd/bi.
//
// What bounds it on H100: operations.  Distances cost 2*N*C FLOP per query
// (2.2e11 FLOP for 1650 clouds of 1024 points at C=64) against 67 TFLOP/s of
// f32 outside the tensor cores; the top-k insertion adds a compare per
// candidate.  The design keeps the (N, N) distance matrix out of device
// memory: one thread per query holds its running top-k list in registers,
// the database streams through shared memory in tiles of kTile rows read as
// broadcast float4s, and each thread keeps kTile partial dot products in
// registers while it walks the channels four at a time.  The distances then
// go through a per-thread column of shared memory into a rolled loop, so
// the insertion code exists once: unrolled over the tile, the insertion
// outgrows the instruction cache.
template <int KMAX>
__device__ __forceinline__ void select_knn(
    const float* __restrict__ query, const float* __restrict__ db,
    int S, int N, int C, int k, int q0, const SelectSmem& sm,
    float (&bd)[KMAX], int (&bi)[KMAX]) {
  float* ds = sm.ds;
  float* qs = sm.qs;
  float* d2s = sm.d2s;
  float* dists = sm.dists + threadIdx.x;
  const int c4 = round_up4(C);
  const int qstride = c4 + 1;
  const int tid = threadIdx.x;
  const bool active = q0 + tid < S;

  for (int e = tid; e < kQueries * c4; e += blockDim.x) {
    const int r = e / c4, c = e - r * c4;
    float v = 0.f;
    if (q0 + r < S && c < C) v = query[(size_t)(q0 + r) * C + c];
    qs[r * qstride + c] = v;
  }
  for (int e = tid; e < kTile * c4; e += blockDim.x) ds[e] = 0.f;
  __syncthreads();

  const float* qrow = qs + tid * qstride;
  const float q2 = sqnorm(qrow, c4);
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    bd[i] = CUDART_INF_F;
    bi[i] = 0;
  }
  float worst = CUDART_INF_F;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn = min(kTile, N - t0);
    const float* src = db + (size_t)t0 * C;
    for (int e = tid; e < tn * C; e += blockDim.x) {
      const int r = e / C, c = e - r * C;
      ds[r * c4 + c] = src[e];
    }
    __syncthreads();
    if (tid < tn) d2s[tid] = sqnorm(ds + tid * c4, c4);
    __syncthreads();

    float dot[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) dot[j] = 0.f;
    for (int c = 0; c < c4; c += 4) {
      const float x0 = qrow[c], x1 = qrow[c + 1], x2 = qrow[c + 2], x3 = qrow[c + 3];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float4 d = *reinterpret_cast<const float4*>(ds + j * c4 + c);
        float acc = dot[j];
        acc = fmaf(x0, d.x, acc);
        acc = fmaf(x1, d.y, acc);
        acc = fmaf(x2, d.z, acc);
        acc = fmaf(x3, d.w, acc);
        dot[j] = acc;
      }
    }

    if (active) {
      // (|q|^2 - 2 q.d) + |d|^2, rounded step by step (no contraction)
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        dists[j * kQueries] = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot[j])), d2s[j]);
#pragma unroll 1
      for (int j = 0; j < tn; ++j) {
        float cd = dists[j * kQueries];
        if (cd < worst) {
          int ci = t0 + j;
          bool placed = false;
#pragma unroll
          for (int i = 0; i < KMAX; ++i) {
            const bool take = i < k && (placed || cd < bd[i]);
            const float td = bd[i];
            const int ti = bi[i];
            bd[i] = take ? cd : td;
            bi[i] = take ? ci : ti;
            cd = take ? td : cd;
            ci = take ? ti : ci;
            placed = placed || take;
            if (i == k - 1) worst = bd[i];
          }
        }
      }
    }
    __syncthreads();
  }
}

// Opt a kernel in to `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
