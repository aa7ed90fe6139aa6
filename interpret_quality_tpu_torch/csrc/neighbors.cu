// Neighbour kernels of the edge-conv family (DGCNN / GCNN) for Hopper (sm_90a).
//
// Three kernels, one plain C launcher each (bound with ctypes from
// interpret_quality_tpu_torch/ops/cuda/neighbors.py):
//
//   iq_knn                 exact k-nearest-neighbour indices
//                          replaces interpret_quality_tpu/ops/pallas/neighbors.py
//                          knn_pallas -> _knn_kernel
//   iq_gather_extrema      per-point max/min of value rows over given indices
//                          replaces neighbors.py gather_extrema -> _idx_extrema_kernel
//   iq_knn_gather_extrema  kNN over features fused with the gather-extrema
//                          replaces neighbors.py knn_gather_extrema -> _extrema_kernel
//                          (and its nq-layout twin _extrema_kernel_nq)
//
// Selection (select_knn, knn_select.cuh) is shared with groups.cu.  iq_knn
// and iq_knn_gather_extrema call the same function, so their indices agree
// bit for bit; the gathers of iq_gather_extrema and iq_knn_gather_extrema
// share one function too (gather_extrema_rows).
//
// None of the TPU workarounds are carried over: rows of `a` are gathered
// directly in f32 (no one-hot matmuls, no bf16 hi/lo planes) and the
// selection keeps exact f32 distances (no packed-mantissa indices).
//
// Launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for arguments the
// kernels do not take (k > 32, a feature width whose tiles exceed shared
// memory).  Indices handed to iq_gather_extrema must lie in [0, N).

#include "knn_select.cuh"

namespace {

constexpr int kMaxK = 32;            // largest neighbourhood the kernels take
constexpr int kGatherThreads = 256;  // threads per block of iq_gather_extrema
constexpr int kGatherQueries = 32;   // queries per block of iq_gather_extrema

// Elementwise max and min of rows a[idx[r, j]] over j < k, for the nq query
// rows whose indices sit in shared memory (row stride idx_stride).
//
// What bounds it: bytes.  Threads run over (query, feature) with features
// innermost, so each of the k row reads is coalesced along F and the index
// is a shared-memory broadcast.  Max and min are exact, so both kernels that
// call this give bit-equal results for equal indices.
__device__ __forceinline__ void gather_extrema_rows(
    const int* idx_s, int idx_stride, int k, const float* __restrict__ a, int F,
    int q0, int nq, float* __restrict__ omax, float* __restrict__ omin) {
  for (int e = threadIdx.x; e < nq * F; e += blockDim.x) {
    const int r = e / F, f = e - r * F;
    const int* row = idx_s + r * idx_stride;
    float mx = -CUDART_INF_F, mn = CUDART_INF_F;
    for (int j = 0; j < k; ++j) {
      const float v = __ldg(a + (size_t)row[j] * F + f);
      mx = fmaxf(mx, v);
      mn = fminf(mn, v);
    }
    const size_t o = (size_t)(q0 + r) * F + f;
    omax[o] = mx;
    omin[o] = mn;
  }
}

// Replaces knn_pallas -> _knn_kernel (ops/pallas/neighbors.py:445-496).
// Bound: operations (distance arithmetic); see select_knn.
template <int KMAX>
__global__ void __launch_bounds__(kQueries)
knn_kernel(const float* __restrict__ query, const float* __restrict__ db,
           int32_t* __restrict__ out, int S, int N, int C, int k, int nqb) {
  extern __shared__ __align__(16) float smem[];
  const SelectSmem sm(smem, round_up4(C));
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kQueries;
  float bd[KMAX];
  int bi[KMAX];
  select_knn<KMAX>(query + (size_t)b * S * C, db + (size_t)b * N * C, S, N, C,
                   k, q0, sm, bd, bi);
  const int q = q0 + threadIdx.x;
  if (q < S) {
    int32_t* o = out + ((size_t)b * S + q) * k;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < k) o[i] = bi[i];
  }
}

// Replaces knn_gather_extrema -> _extrema_kernel and its nq twin
// (ops/pallas/neighbors.py:187-368).  Bound: operations; the selected
// indices go through shared memory to the gather, never to device memory.
template <int KMAX>
__global__ void __launch_bounds__(kQueries)
knn_gather_extrema_kernel(const float* __restrict__ xs, const float* __restrict__ a,
                          float* __restrict__ omax, float* __restrict__ omin,
                          int N, int C, int F, int k, int nqb) {
  extern __shared__ __align__(16) float smem[];
  const SelectSmem sm(smem, round_up4(C));
  int* idx_s = sm.end();
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kQueries;
  const float* xb = xs + (size_t)b * N * C;
  float bd[KMAX];
  int bi[KMAX];
  select_knn<KMAX>(xb, xb, N, N, C, k, q0, sm, bd, bi);
#pragma unroll
  for (int i = 0; i < KMAX; ++i) idx_s[threadIdx.x * KMAX + i] = bi[i];
  __syncthreads();
  const size_t off = (size_t)b * N * F;
  gather_extrema_rows(idx_s, KMAX, k, a + off, F, q0, min(kQueries, N - q0),
                      omax + off, omin + off);
}

// Replaces gather_extrema -> _idx_extrema_kernel (ops/pallas/neighbors.py:
// 371-442).  Bound: bytes; see gather_extrema_rows.
__global__ void __launch_bounds__(kGatherThreads)
gather_extrema_kernel(const int32_t* __restrict__ idx, const float* __restrict__ a,
                      float* __restrict__ omax, float* __restrict__ omin,
                      int S, int N, int F, int k, int nqb) {
  __shared__ int idx_s[kGatherQueries * kMaxK];
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kGatherQueries;
  const int nq = min(kGatherQueries, S - q0);
  const int32_t* src = idx + ((size_t)b * S + q0) * k;
  for (int e = threadIdx.x; e < nq * k; e += blockDim.x) idx_s[e] = src[e];
  __syncthreads();
  gather_extrema_rows(idx_s, k, k, a + (size_t)b * N * F, F, q0, nq,
                      omax + (size_t)b * S * F, omin + (size_t)b * S * F);
}

}  // namespace

extern "C" {

int iq_knn(const float* query, const float* db, int32_t* out, int B, int S, int N,
           int C, int k, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxK || k > N || C < 1) return cudaErrorInvalidValue;
  const size_t smem = select_smem_floats(round_up4(C)) * sizeof(float);
  const int nqb = (S + kQueries - 1) / kQueries;
  const dim3 grid((unsigned)B * nqb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 20) {
    if ((err = prepare(knn_kernel<20>, smem)) != cudaSuccess) return err;
    knn_kernel<20><<<grid, kQueries, smem, s>>>(query, db, out, S, N, C, k, nqb);
  } else {
    if ((err = prepare(knn_kernel<kMaxK>, smem)) != cudaSuccess) return err;
    knn_kernel<kMaxK><<<grid, kQueries, smem, s>>>(query, db, out, S, N, C, k, nqb);
  }
  return cudaGetLastError();
}

int iq_knn_gather_extrema(const float* xs, const float* a, float* omax, float* omin,
                          int B, int N, int C, int F, int k, void* stream) {
  if (B <= 0 || N <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxK || k > N || C < 1 || F < 1) return cudaErrorInvalidValue;
  const int kmax = k <= 20 ? 20 : kMaxK;
  const size_t smem = select_smem_floats(round_up4(C)) * sizeof(float) +
                      (size_t)kQueries * kmax * sizeof(int);
  const int nqb = (N + kQueries - 1) / kQueries;
  const dim3 grid((unsigned)B * nqb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kmax == 20) {
    if ((err = prepare(knn_gather_extrema_kernel<20>, smem)) != cudaSuccess) return err;
    knn_gather_extrema_kernel<20><<<grid, kQueries, smem, s>>>(xs, a, omax, omin, N, C, F,
                                                               k, nqb);
  } else {
    if ((err = prepare(knn_gather_extrema_kernel<kMaxK>, smem)) != cudaSuccess) return err;
    knn_gather_extrema_kernel<kMaxK><<<grid, kQueries, smem, s>>>(xs, a, omax, omin, N, C,
                                                                  F, k, nqb);
  }
  return cudaGetLastError();
}

int iq_gather_extrema(const int32_t* idx, const float* a, float* omax, float* omin,
                      int B, int S, int N, int F, int k, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxK || N < 1 || F < 1) return cudaErrorInvalidValue;
  const int nqb = (S + kGatherQueries - 1) / kGatherQueries;
  gather_extrema_kernel<<<(unsigned)B * nqb, kGatherThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(idx, a, omax, omin, S, N,
                                                                F, k, nqb);
  return cudaGetLastError();
}

}  // extern "C"
