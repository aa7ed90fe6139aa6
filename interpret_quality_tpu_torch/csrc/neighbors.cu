// Neighbour kernels of the edge-conv family (DGCNN / GCNN) for Hopper (sm_90a).
//
// Three kernels, one plain C launcher each (bound with ctypes from
// interpret_quality_tpu_torch/ops/cuda/neighbors.py):
//
//   iq_knn                 exact k-nearest-neighbour indices
//                          replaces interpret_quality_tpu/ops/pallas/neighbors.py:482
//                          knn_pallas -> _knn_kernel
//   iq_gather_extrema      per-point max/min of value rows over given indices,
//                          the rows f32 or bf16 (--gather_precision bf16)
//                          replaces neighbors.py gather_extrema -> _idx_extrema_kernel
//   iq_knn_gather_extrema  kNN over features fused with the gather-extrema
//                          replaces neighbors.py knn_gather_extrema -> _extrema_kernel
//                          (and its nq-layout twin _extrema_kernel_nq)
//
// Selection is shared with groups.cu, and takes the selection class of the
// JAX package's IQTPU_KNN_SELECT (sel: exact, packed or bf16; knn_select.cuh
// select_key) as a runtime argument, uniform over a launch: each selection
// kernel has one instance for the exact class, which forms no key, and one
// for the other two (kKeyed), which test the class at each distance.
// iq_knn has two routes, chosen by shape alone (knn_route): the xyz route (knn_xyz.cuh: the cloud staged once
// a block, a warp per query, a selection on (distance, index)) for clouds of
// C <= 4 channels whose database fits shared memory, else the tiled
// select_knn (knn_select.cuh), which iq_knn_gather_extrema calls too, on the
// distinct database rows only (each with its copies).  All three compute a
// distance by the same instructions and return a stable sort's order, so
// they agree bit for bit on the indices.  The two gathers are
// separate functions: iq_knn_gather_extrema gathers with
// gather_extrema_rows; iq_gather_extrema stages a column slice
// of the cloud in shared memory (gather_extrema_slice_kernel) and takes
// gather_extrema_rows only for clouds whose slice does not fit.  Max and min
// are exact, so every route gives bit-equal results on equal indices.
// iq_gather_extrema takes the rows of `a` in f32 or, at the bf16 gather
// precision, as bf16 values (each f32 rounded to nearest even by the caller,
// the TPU's one bf16 value plane): both routes then read half the bytes,
// widen each value exactly to f32 and take max and min in f32, so the result
// is the f32 route's on the rounded values, bit for bit.
//
// None of the TPU workarounds are carried over: rows of `a` are gathered
// directly (no one-hot matmuls, no bf16 hi/lo planes) and the selection
// keeps a (key, index) pair, never an index packed into the key's mantissa:
// a blocked product on the f32 units and a warp-cooperative sorted list per
// query.  The packed class's key is the distance with the mantissa bits
// that the TPU's packed key gives the index cleared, so it orders as the
// TPU's.
//
// Launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for arguments the
// kernels do not take (k > 32, or a route whose slice does not fit shared
// memory, or an xyz route forced on a shape it does not take).  Indices
// handed to iq_gather_extrema must lie in [0, N).

#include "knn_select.cuh"
#include "knn_xyz.cuh"

namespace {

constexpr int kMaxK = 32;            // largest neighbourhood the kernels take

// iq_gather_extrema's routes, chosen by shape (gather_route): the slice
// route wherever a cloud's column slice and two passes of index rows fit one
// block's shared memory (N up to 3376 at k = 32), else the row route.
constexpr int kSliceRoute = 1;
constexpr int kRowRoute = 2;
constexpr int kSliceCols = 16;       // columns of `a` one slice block stages (Ft)
constexpr int kSliceThreads = 256;   // threads per slice block
constexpr int kPassQueries = 64;     // queries whose index rows one pass stages
constexpr int kGatherThreads = 256;  // threads per block of the row route
constexpr int kGatherQueries = 32;   // queries per block of the row route

// A value of `a` as f32: an f32, or a bf16's bits (a bf16 is the high half
// of an f32, so widening is exact).
using bf16_bits = unsigned short;
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) { return __uint_as_float((unsigned)v << 16); }

// four consecutive values of a row in shared memory, as f32 (16 bytes of
// f32 or 8 of bf16, on their own boundary)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16_bits* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Elementwise max and min of rows a[idx[r, j]] over j < k, for the nq query
// rows whose indices sit in shared memory (row stride idx_stride); query r
// writes output row out_rows[q0 + r] (nullptr: row q0 + r).  T: float or
// bf16_bits.
//
// Threads run over (query, feature) with features innermost, so each of the
// k row reads is coalesced along F and the index is a shared-memory
// broadcast.  Every read goes through L2 (k times the bytes of `a`: 69 GB
// per GCNN forward on the main path), which bounds iq_gather_extrema on
// this route; in kernel 3 the selection dominates.
template <typename T>
__device__ __forceinline__ void gather_extrema_rows(
    const int* idx_s, int idx_stride, int k, const T* __restrict__ a, int F,
    const int* __restrict__ out_rows, int q0, int nq, float* __restrict__ omax,
    float* __restrict__ omin) {
  for (int e = threadIdx.x; e < nq * F; e += blockDim.x) {
    const int r = e / F, f = e - r * F;
    const int* row = idx_s + r * idx_stride;
    float mx = -CUDART_INF_F, mn = CUDART_INF_F;
    for (int j = 0; j < k; ++j) {
      const float v = widen(__ldg(a + (size_t)row[j] * F + f));
      mx = fmaxf(mx, v);
      mn = fminf(mn, v);
    }
    const size_t o = (size_t)(out_rows ? out_rows[q0 + r] : q0 + r) * F + f;
    omax[o] = mx;
    omin[o] = mn;
  }
}

// Replaces knn_pallas -> _knn_kernel (ops/pallas/neighbors.py:445-496),
// the tiled route: select_knn over kQueries distinct query rows a block.
// Bound: operations (distance arithmetic); see select_knn.  kKeyed: the
// packed or bf16 class.
template <bool kKeyed>
__global__ void __launch_bounds__(kSelThreads, 2)
knn_kernel(const float* __restrict__ query, const float* __restrict__ db,
           const int* __restrict__ rows, const int* __restrict__ nrows,
           int32_t* __restrict__ out, int S, int N, int C, int k, int nqb,
           SelectKey key) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kQueries;
  const int ns = nrows[b];                    // distinct query rows of this cloud
  if (q0 >= ns) return;
  const int* qrows = rows + (size_t)b * S;
  const int* li = select_knn<1, kKeyed>(query + (size_t)b * S * C, qrows,
                                        db + (size_t)b * N * C, ns, N, C, k, q0, key, smem);
  const int nq = min(kQueries, ns - q0);
  int32_t* o = out + (size_t)b * S * k;
  for (int e = threadIdx.x; e < nq * k; e += blockDim.x) {
    const int r = e / k;
    o[(size_t)qrows[q0 + r] * k + (e - r * k)] = li[r * 32 + (e - r * k)];
  }
}

// Replaces knn_pallas -> _knn_kernel (ops/pallas/neighbors.py:445-496),
// the xyz route.  What bounds it: operations, 2 C + 3 a distance over the
// distinct query rows (0.116 ms a GCNN forward at 67 TFLOP/s); the design
// (knn_xyz.cuh) leaves the distances and the two passes over the staged
// cloud, with one block barrier.  A block stages one cloud and runs
// kXyzQueries of its distinct query rows, a warp each.
template <int M, int NPL, bool kKeyed>
__global__ void __launch_bounds__(kXyzThreads, 4)
knn_xyz_kernel(const float* __restrict__ query, const float* __restrict__ db,
               const int* __restrict__ rows, const int* __restrict__ nrows,
               int32_t* __restrict__ out, int S, int N, int C, int k, int nqb,
               SelectKey key) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kXyzQueries;
  const int ns = nrows[b];                    // distinct query rows of this cloud
  if (q0 >= ns) return;
  float* buffers;
  const XyzCloud cl = xyz_stage(db + (size_t)b * N * C, N, C, key, smem, &buffers);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* qrows = rows + (size_t)b * S;
  const int qend = min(q0 + kXyzQueries, ns);
  for (int r = q0 + warp; r < qend; r += kXyzWarps) {
    const size_t row = (size_t)b * S + qrows[r];
    float vd[1];
    int vi[1];
    xyz_select<1, M, NPL, kKeyed>(cl, query + row * C, k, buffers + warp * 2 * kXyzBuffer,
                                  lane, vd, vi);
    if (lane < k) out[row * k + lane] = vi[0];
  }
}

// The instance of knn_xyz_kernel for (N, k, class): the keys a lane hands
// the first list, the candidates it keeps in registers, and whether the
// distances become keys (the packed and bf16 classes).
using KnnXyz = void (*)(const float*, const float*, const int*, const int*, int32_t*, int, int,
                        int, int, int, SelectKey);
template <bool kKeyed>
inline KnnXyz knn_xyz_instance(int N, int k) {
  if (xyz_deep(k))
    return xyz_small(N) ? knn_xyz_kernel<2, 16, kKeyed> : knn_xyz_kernel<2, 32, kKeyed>;
  return xyz_small(N) ? knn_xyz_kernel<1, 16, kKeyed> : knn_xyz_kernel<1, 32, kKeyed>;
}
inline KnnXyz knn_xyz_launcher(int N, int k, int sel) {
  return sel == kSelExact ? knn_xyz_instance<false>(N, k) : knn_xyz_instance<true>(N, k);
}

// Replaces knn_gather_extrema -> _extrema_kernel and its nq twin
// (ops/pallas/neighbors.py:187-368).  Bound: operations, in the tile loop
// of select_knn; the selected indices stay in its shared lists, where the
// gather reads them.  Queries and database are the same cloud, so both are
// its distinct rows: a block of distinct query rows streams the cloud's d
// distinct rows (the compacted scan, kCompact), d^2 distances a cloud where
// the full scan took d N, and each distinct row enters a list with its
// copies (copy_lists_kernel), so the lists, and the outputs, are those of the
// full scan bit for bit.  tie_rows: the tie path's count, or nullptr.
// kKeyed: the packed or bf16 class.
template <bool kKeyed>
__global__ void __launch_bounds__(kSelThreads, 2)
knn_gather_extrema_kernel(const float* __restrict__ xs, const float* __restrict__ a,
                          const int* __restrict__ rows, const int* __restrict__ nrows,
                          const int* __restrict__ starts, const int* __restrict__ copies,
                          unsigned long long* __restrict__ tie_rows,
                          float* __restrict__ omax, float* __restrict__ omin,
                          int N, int C, int F, int k, int nqb, SelectKey key) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kQueries;
  const int ns = nrows[b];                    // distinct rows of this cloud
  if (q0 >= ns) return;
  const int* qrows = rows + (size_t)b * N;
  const float* xb = xs + (size_t)b * N * C;
  const CopyLists cl{qrows, starts + (size_t)b * (N + 1), copies + (size_t)b * N, ns, tie_rows};
  const int* li = select_knn<1, kKeyed, true>(xb, qrows, xb, ns, N, C, k, q0, key, smem, cl);
  const size_t off = (size_t)b * N * F;
  gather_extrema_rows(li, 32, k, a + off, F, qrows, q0, min(kQueries, ns - q0), omax + off,
                      omin + off);
}

// Replaces gather_extrema -> _idx_extrema_kernel (ops/pallas/neighbors.py:
// 371-442), the row route: gather_extrema_rows over kGatherQueries queries a
// block, every row read through L2.  Taken for clouds whose column slice
// does not fit shared memory.
template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
gather_extrema_kernel(const int32_t* __restrict__ idx, const T* __restrict__ a,
                      float* __restrict__ omax, float* __restrict__ omin,
                      int S, int N, int F, int k, int nqb) {
  __shared__ int idx_s[kGatherQueries * kMaxK];
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kGatherQueries;
  const int nq = min(kGatherQueries, S - q0);
  const int32_t* src = idx + ((size_t)b * S + q0) * k;
  for (int e = threadIdx.x; e < nq * k; e += blockDim.x) idx_s[e] = src[e];
  __syncthreads();
  gather_extrema_rows(idx_s, k, k, a + (size_t)b * N * F, F, nullptr, q0, nq,
                      omax + (size_t)b * S * F, omin + (size_t)b * S * F);
}

// ------------------------------------------------ iq_gather_extrema, slice route
// Columns of a slice: kSliceCols, or F rounded up to 4 where F is narrower.
__host__ __device__ __forceinline__ int slice_cols(int F) {
  return round_up4(F) < kSliceCols ? round_up4(F) : kSliceCols;
}

// Shared memory of a slice block: the slice (N rows of slice_cols(F) values
// of `esize` bytes, 4 for f32 and 2 for bf16) and two passes of index rows
// (kPassQueries rows of k ints each).
__host__ __device__ __forceinline__ size_t slice_smem_bytes(int N, int F, int k, int esize) {
  return (size_t)N * slice_cols(F) * esize + (size_t)2 * kPassQueries * k * sizeof(int);
}

inline int gather_route(int N, int F, int k, int esize) {
  return slice_smem_bytes(N, F, k, esize) <= (size_t)kMaxSmem ? kSliceRoute : kRowRoute;
}

__device__ __forceinline__ void stage_index_rows(int* dst, const int32_t* __restrict__ src,
                                                 int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) cp_async4(dst + e, src + e);
}

// Replaces gather_extrema -> _idx_extrema_kernel (ops/pallas/neighbors.py:
// 371-442), the slice route.
//
// What bounds it: bytes.  The row route reads every row of `a` k times
// through L2 (k = 20: 69 GB per GCNN forward, about what L2 delivers in the
// 12 ms it took); here each row is read from device memory once and its k
// reuses come from shared memory.  The least device-memory traffic is `a`
// once, both outputs once and the indices (10.9 GB a forward, 3.26 ms at
// 3.35 TB/s); the shared-memory reads (the 69 GB) take about 2.3 ms at 128
// bytes a clock on 132 SMs, and run beside it.
//
// One block per (cloud, column slice of Ft = slice_cols(F) columns): the
// block copies a[b, :, f0:f0+Ft] into shared memory once (16-byte cp.async
// where rows are 16-byte aligned), then walks the cloud's queries in passes
// of kPassQueries, the next pass's index rows (contiguous in idx) copied by
// cp.async while the current one computes.  A thread takes one query and 4
// columns: k reads of four values from shared memory (16 bytes, or 8 at
// bf16, widened to f32), max and min, two float4 stores.  A cloud's slices
// are neighbouring blocks, so its index rows, read once per slice, come
// from L2.  At Ft = 16, k = 20, N = 1024 a block holds 74 KB in f32 (42 KB
// at bf16): three blocks a SM.
template <typename T>
__global__ void __launch_bounds__(kSliceThreads, 3)
gather_extrema_slice_kernel(const int32_t* __restrict__ idx, const T* __restrict__ a,
                            float* __restrict__ omax, float* __restrict__ omin, int S,
                            int N, int F, int k, int nslices, bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int per16 = 16 / sizeof(T);                        // values in 16 bytes
  const int ft = slice_cols(F);
  T* vals = reinterpret_cast<T*>(smem);                        // [N][ft]
  int* rows_s = reinterpret_cast<int*>(vals + (size_t)N * ft);  // [2][kPassQueries * k]
  const int b = blockIdx.x / nslices;
  const int f0 = (blockIdx.x - b * nslices) * ft;
  const int fw = min(ft, F - f0);                              // live columns
  const T* ab = a + (size_t)b * N * F + f0;
  const int32_t* ib = idx + (size_t)b * S * k;

  if (vec) {    // F and ft multiples of per16, `a` 16-byte aligned: whole 16 bytes
    const int per_row = ft / per16;
    for (int e = threadIdx.x; e < N * per_row; e += blockDim.x) {
      const int n = e / per_row, c = (e - n * per_row) * per16;
      const bool live = c < fw;
      cp_async16(reinterpret_cast<float*>(vals + (size_t)n * ft + c),
                 reinterpret_cast<const float*>(live ? ab + (size_t)n * F + c : ab), live);
    }
  } else {
    for (int e = threadIdx.x; e < N * ft; e += blockDim.x) {
      const int n = e / ft, c = e - n * ft;
      vals[e] = c < fw ? __ldg(ab + (size_t)n * F + c) : T(0);
    }
  }
  stage_index_rows(rows_s, ib, min(kPassQueries, S) * k);
  cp_async_commit();                                           // group 0: slice, pass 0

  const int tpq = ft >> 2;                   // threads a query
  const int qpr = blockDim.x / tpq;          // queries the block's threads cover at once
  const int tq = threadIdx.x / tpq, c = (threadIdx.x - tq * tpq) * 4;
  const bool active = tq < qpr && c < fw;
  const int npass = (S + kPassQueries - 1) / kPassQueries;
  for (int p = 0; p < npass; ++p) {
    const int q0 = p * kPassQueries;
    if (p + 1 < npass)
      stage_index_rows(rows_s + ((p + 1) & 1) * kPassQueries * k,
                       ib + (size_t)(q0 + kPassQueries) * k,
                       min(kPassQueries, S - q0 - kPassQueries) * k);
    cp_async_commit();                       // possibly empty: keeps the count
    cp_async_wait<1>();                      // everything but the newest group
    __syncthreads();
    if (active) {
      const int* rows = rows_s + (p & 1) * kPassQueries * k;
      const int nq = min(kPassQueries, S - q0);
      for (int r = tq; r < nq; r += qpr) {
        const int* row = rows + r * k;
        float4 mx = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
        float4 mn = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
#pragma unroll 4
        for (int j = 0; j < k; ++j) {
          const float4 v = load4(vals + (size_t)row[j] * ft + c);
          mx.x = fmaxf(mx.x, v.x);
          mx.y = fmaxf(mx.y, v.y);
          mx.z = fmaxf(mx.z, v.z);
          mx.w = fmaxf(mx.w, v.w);
          mn.x = fminf(mn.x, v.x);
          mn.y = fminf(mn.y, v.y);
          mn.z = fminf(mn.z, v.z);
          mn.w = fminf(mn.w, v.w);
        }
        const size_t o = ((size_t)b * S + q0 + r) * F + f0 + c;
        if (vec) {
          *reinterpret_cast<float4*>(omax + o) = mx;
          *reinterpret_cast<float4*>(omin + o) = mn;
        } else {
          const float xs[4] = {mx.x, mx.y, mx.z, mx.w}, ns[4] = {mn.x, mn.y, mn.z, mn.w};
          for (int i = 0; i < 4 && c + i < fw; ++i) {
            omax[o + i] = xs[i];
            omin[o + i] = ns[i];
          }
        }
      }
    }
    __syncthreads();                         // the next copy reuses this buffer
  }
}

template <typename T>
cudaError_t gather_extrema_launch(const int32_t* idx, const T* a, float* omax, float* omin,
                                  int B, int S, int N, int F, int k, int route,
                                  cudaStream_t s) {
  if (route == 0) route = gather_route(N, F, k, sizeof(T));
  if (route == kSliceRoute) {
    const size_t smem = slice_smem_bytes(N, F, k, sizeof(T));
    cudaError_t err;
    if ((err = prepare(gather_extrema_slice_kernel<T>, smem)) != cudaSuccess) return err;
    const int nslices = (F + slice_cols(F) - 1) / slice_cols(F);
    constexpr int per16 = 16 / sizeof(T);
    const bool vec = F % per16 == 0 && slice_cols(F) % per16 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0;
    gather_extrema_slice_kernel<T><<<(unsigned)B * nslices, kSliceThreads, smem, s>>>(
        idx, a, omax, omin, S, N, F, k, nslices, vec);
    return cudaGetLastError();
  }
  const int nqb = (S + kGatherQueries - 1) / kGatherQueries;
  gather_extrema_kernel<T><<<(unsigned)B * nqb, kGatherThreads, 0, s>>>(idx, a, omax, omin, S,
                                                                        N, F, k, nqb);
  return cudaGetLastError();
}

template <typename T>
int gather_extrema_route_info(int N, int F, int k, int* info) {
  info[0] = gather_route(N, F, k, sizeof(T));
  if (info[0] == kSliceRoute) {
    const size_t smem = slice_smem_bytes(N, F, k, sizeof(T));
    cudaError_t err;
    if ((err = prepare(gather_extrema_slice_kernel<T>, smem)) != cudaSuccess) return err;
    info[1] = slice_cols(F);
    info[2] = kSliceThreads;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[3], gather_extrema_slice_kernel<T>, kSliceThreads, smem);
  }
  info[1] = 0;
  info[2] = kGatherThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], gather_extrema_kernel<T>,
                                                       kGatherThreads, 0);
}

}  // namespace

extern "C" {

// scratch (iq_knn): B * (2 * S + 1) ints of device memory, S the number of
// query rows of a cloud; (iq_knn_gather_extrema) B * (4 * N + 2), the copy
// lists included (see DistinctRows).  tie_rows (iq_knn_gather_extrema): a
// counter to which the kernel adds the candidates that took the tie path
// of the compacted scan (knn_select.cuh), or nullptr.
// route (iq_knn): 0 chooses by shape (knn_route), kXyzRoute or kTiledRoute
// forces one (a forced xyz route on a shape it does not take is refused).
// sel (iq_knn, iq_knn_gather_extrema): the selection class, kSelExact,
// kSelPacked or kSelBf16.
int iq_knn(const float* query, const float* db, int32_t* out, int* scratch, int B, int S,
           int N, int C, int k, int route, int sel, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxK || k > N || C < 1 || route < 0 || route > kTiledRoute ||
      !select_key_valid(sel))
    return cudaErrorInvalidValue;
  const SelectKey key = select_key_for(sel, N);
  if (route == 0) route = knn_route(N, C);
  if (route == kXyzRoute && !xyz_fits(N, C)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DistinctRows d(scratch, B, S);
  cudaError_t err;
  if ((err = distinct_rows(query, d, B, S, C, s)) != cudaSuccess) return err;
  if (route == kXyzRoute) {
    const size_t smem = xyz_smem_bytes(N, C);
    const int nqb = (S + kXyzQueries - 1) / kXyzQueries;
    const KnnXyz kernel = knn_xyz_launcher(N, k, sel);
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<(unsigned)B * nqb, kXyzThreads, smem, s>>>(query, db, d.rows, d.nrows, out, S, N,
                                                        C, k, nqb, key);
  } else {
    const size_t smem = select_smem_floats(1) * sizeof(float);
    const int nqb = (S + kQueries - 1) / kQueries;
    const auto kernel = sel == kSelExact ? knn_kernel<false> : knn_kernel<true>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<(unsigned)B * nqb, kSelThreads, smem, s>>>(query, db, d.rows, d.nrows, out, S, N,
                                                        C, k, nqb, key);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return copy_duplicate_rows(d, reinterpret_cast<float*>(out), nullptr, B, S, k, s);
}

// The route iq_knn takes for (N, C, k), for the record (it launches
// nothing): info = {route, threads a block, blocks a SM holds, dynamic
// shared memory a block (bytes), registers a thread, local memory a thread
// (bytes)}.
int iq_knn_route(int N, int C, int k, int* info) {
  if (k < 1 || k > kMaxK || k > N || C < 1) return cudaErrorInvalidValue;
  info[0] = knn_route(N, C);
  if (info[0] == kXyzRoute)
    return kernel_info(knn_xyz_launcher(N, k, kSelExact), kXyzThreads, xyz_smem_bytes(N, C),
                       info);
  return kernel_info(knn_kernel<false>, kSelThreads, select_smem_floats(1) * sizeof(float),
                     info);
}

int iq_knn_gather_extrema(const float* xs, const float* a, float* omax, float* omin,
                          int* scratch, unsigned long long* tie_rows, int B, int N, int C,
                          int F, int k, int sel, void* stream) {
  if (B <= 0 || N <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxK || k > N || C < 1 || F < 1 || !select_key_valid(sel))
    return cudaErrorInvalidValue;
  const size_t smem = (select_smem_floats(1) + kCompactWords) * sizeof(float);
  const int nqb = (N + kQueries - 1) / kQueries;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DistinctRows d(scratch, B, N);
  cudaError_t err;
  if ((err = distinct_rows(xs, d, B, N, C, s)) != cudaSuccess) return err;
  if ((err = copy_lists(d, B, N, s)) != cudaSuccess) return err;
  const auto kernel =
      sel == kSelExact ? knn_gather_extrema_kernel<false> : knn_gather_extrema_kernel<true>;
  if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
  kernel<<<(unsigned)B * nqb, kSelThreads, smem, s>>>(
      xs, a, d.rows, d.nrows, d.starts, d.copies, tie_rows, omax, omin, N, C, F, k, nqb,
      select_key_for(sel, N));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return copy_duplicate_rows(d, omax, omin, B, N, F, s);
}

// route: 0 chooses by shape (gather_route), kSliceRoute or kRowRoute forces
// one (a forced slice route whose slice does not fit is refused).  bf16 != 0:
// `a` holds bf16 values (B * N * F of 2 bytes), else f32.
int iq_gather_extrema(const int32_t* idx, const void* a, float* omax, float* omin,
                      int B, int S, int N, int F, int k, int route, int bf16, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxK || N < 1 || F < 1 || route < 0 || route > kRowRoute)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return gather_extrema_launch(idx, static_cast<const bf16_bits*>(a), omax, omin, B, S, N, F,
                                 k, route, s);
  return gather_extrema_launch(idx, static_cast<const float*>(a), omax, omin, B, S, N, F, k,
                               route, s);
}

// The route iq_gather_extrema takes for (N, F, k) and its value type, for
// the record (it launches nothing): info = {route, slice columns (0 on the
// row route), threads a block, blocks a SM holds}.
int iq_gather_extrema_route(int N, int F, int k, int bf16, int* info) {
  if (k < 1 || k > kMaxK || N < 1 || F < 1) return cudaErrorInvalidValue;
  return bf16 ? gather_extrema_route_info<bf16_bits>(N, F, k, info)
              : gather_extrema_route_info<float>(N, F, k, info);
}

}  // extern "C"
