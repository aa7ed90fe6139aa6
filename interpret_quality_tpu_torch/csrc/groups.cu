// Set-abstraction kernels of PointNet++ and PointConv for Hopper (sm_90a).
//
// Four kernels, one plain C launcher each (bound with ctypes from
// interpret_quality_tpu_torch/ops/cuda/groups.py):
//
//   iq_ball_mlp3      one PointNet++ MSG branch: ball query, layer 1 on exact
//                     xyz offsets plus hoisted feature rows, layers 2-3, max
//                     over the ball's slots
//                     replaces interpret_quality_tpu/ops/pallas/groups.py
//                     fused_ball_mlp3 -> _ball_mlp3_kernel
//   iq_knn_density    kNN over xyz, each neighbour's inverse density and the
//                     per-query max
//                     replaces groups.py knn_with_density -> _knn_den_kernel
//   iq_pointconv_sa   the PointConv SA grouped compute: gathered layer-1 rows,
//                     layers 2-3, density scale, WeightNet on exact offsets,
//                     and the contraction over the neighbours
//                     replaces groups.py fused_pointconv_sa -> _pconv_kernel
//   iq_gather_rows    grouped row gather, out[b, r, :] = values[b, idx[b, r], :]
//                     replaces groups.py gather_rows -> _gather_rows_kernel
//
// All arithmetic is f32 on the CUDA cores.  None of the TPU workarounds are
// carried over: rows are gathered directly in f32 (no one-hot matmuls, no
// bf16 hi/lo planes) and the kNN keeps exact f32 distances with ties to the
// lowest index (select_knn, shared with neighbors.cu).
//
// Layers 2 and 3 of both MLP kernels run through one tiled product,
// dense_tile: a tile of kRows slot rows sits transposed in shared memory,
// each thread computes a kTM x kTN block of outputs with the weight rows
// read as float4 through the read-only cache, and an epilogue consumes the
// block (store for the next layer, max into the ball's row, or scale for
// the contraction).  The (B, S, K, C) grouped tensors never exist in device
// memory.
//
// Launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for arguments the
// kernels do not take.  Indices handed to iq_pointconv_sa and
// iq_gather_rows must lie in [0, N); neither checks.

#include "knn_select.cuh"

namespace {

constexpr int kThreads = 256;               // threads per block of the MLP kernels
constexpr int kRows = 64;                   // slot rows per tile
constexpr int kStride = kRows + 4;          // row stride of a transposed activation tile
constexpr int kTM = 8;                      // rows of a thread's output block
constexpr int kTN = 4;                      // columns of a thread's output block
constexpr int kBallCentres = kThreads / 32; // centres per block of iq_ball_mlp3
constexpr int kMaxDensityK = 64;            // largest k of iq_knn_density
constexpr int kWH = 8;                      // WeightNet 3 -> kWH -> kWH -> kWO
constexpr int kWO = 16;
constexpr int kWnetFloats = 3 * kWH + kWH + kWH * kWH + kWH + kWH * kWO + kWO;

// y = x @ w + bias for the kRows rows of one tile.  x is held transposed in
// shared memory (xt[i * kStride + r], cin rows); w is (cin, cout) row-major
// in device memory, bias (cout,); cout is a multiple of kTN.  Each thread
// takes kTM x kTN blocks of y in turn and hands each to epi(r0, c0, v).
template <typename Epi>
__device__ __forceinline__ void dense_tile(const float* xt, int cin,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias, int cout,
                                           Epi&& epi) {
  const int ncg = cout / kTN;
  const int ntiles = (kRows / kTM) * ncg;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    const int c0 = (t % ncg) * kTN, r0 = (t / ncg) * kTM;
    float acc[kTM][kTN];
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;
    const float* xp = xt + r0;
    const float* wp = w + c0;
#pragma unroll 4
    for (int i = 0; i < cin; ++i) {
      const float4 xa = *reinterpret_cast<const float4*>(xp + i * kStride);
      const float4 xb = *reinterpret_cast<const float4*>(xp + i * kStride + 4);
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wp + (size_t)i * cout));
      const float xr[kTM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float wc[kTN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(xr[r], wc[c], acc[r][c]);
    }
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c0));
    const float bc[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[r][c] = __fadd_rn(acc[r][c], bc[c]);
    epi(r0, c0, acc);
  }
}

// relu(v) stored transposed for the next dense_tile: yt[c * kStride + r]
__device__ __forceinline__ void store_relu_t(float* yt, int r0, int c0,
                                             const float (&v)[kTM][kTN]) {
#pragma unroll
  for (int c = 0; c < kTN; ++c) {
    float* dst = yt + (c0 + c) * kStride + r0;
    *reinterpret_cast<float4*>(dst) =
        make_float4(fmaxf(v[0][c], 0.f), fmaxf(v[1][c], 0.f), fmaxf(v[2][c], 0.f),
                    fmaxf(v[3][c], 0.f));
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(fmaxf(v[4][c], 0.f), fmaxf(v[5][c], 0.f), fmaxf(v[6][c], 0.f),
                    fmaxf(v[7][c], 0.f));
  }
}

// ------------------------------------------------------------ iq_ball_mlp3
// Replaces fused_ball_mlp3 -> _ball_mlp3_kernel (ops/pallas/groups.py:40-113,
// 188-284).
//
// What bounds it on H100: operations.  Layers 2 and 3 cost 2*(C1*C2 + C2*C3)
// FLOP per filled slot, about 9 TFLOP for one PointNet++ forward of 1650
// masked clouds when the balls are full, against 67 TFLOP/s of f32 outside
// the tensor cores.  The design: one block takes kBallCentres centres of one
// cloud, one warp per centre.  The ball query scans the cloud in index
// order 32 points at a time; a ballot and a popcount rank the in-ball points,
// so the first K land in their slots in order and the scan stops at K.  Slots
// beyond the in-ball count repeat slot 0 and cannot change the max, so only
// the filled slots become rows: the rows of the block's centres are packed
// into tiles of kRows, layer 1 is elementwise (exact f32 offsets against the
// three xyz rows of A1, plus the hoisted feature row), layers 2 and 3 run
// through dense_tile, and layer 3's epilogue folds ReLU and the max over each
// centre's rows into a shared row with atomicMax on the f32 bits (all values
// are >= 0, where the order of the bits is the order of the floats).
//
// Membership uses the distance form of ops/geometry.square_distance,
// (|c|^2 - 2 c.p) + |p|^2, against r2 = f32(radius^2) with <=; the norms and
// the dot product are the fmaf chains of select_knn.  An empty ball takes
// index 0, as query_ball_point does.
template <bool HAS_UF>
__global__ void __launch_bounds__(kThreads)
ball_mlp3_kernel(const float* __restrict__ new_xyz, const float* __restrict__ xyz,
                 const float* __restrict__ uf, const float* __restrict__ b1,
                 const float* __restrict__ a1x, const float* __restrict__ a2,
                 const float* __restrict__ b2, const float* __restrict__ a3,
                 const float* __restrict__ b3, float* __restrict__ out, int S, int N,
                 int K, int C1, int C2, int C3, float r2, int nqb) {
  extern __shared__ __align__(16) float smem[];
  float* h1 = smem;                                       // [C1][kStride]
  float* h2 = h1 + C1 * kStride;                          // [C2][kStride]
  int* best = reinterpret_cast<int*>(h2 + C2 * kStride);  // [kBallCentres][C3] max, f32 bits
  int* slots = best + kBallCentres * C3;                  // [kBallCentres][K] ball members
  float* offs = reinterpret_cast<float*>(slots + kBallCentres * K);  // [kRows][3]
  int* row_q = reinterpret_cast<int*>(offs + kRows * 3);  // [kRows] centre of a row, -1: none
  int* row_p = row_q + kRows;                             // [kRows] its point
  __shared__ int nball[kBallCentres];
  __shared__ int first_row[kBallCentres + 1];
  __shared__ float cen[kBallCentres][3];

  const int b = blockIdx.x / nqb;
  const int s0 = (blockIdx.x - b * nqb) * kBallCentres;
  const int nc = min(kBallCentres, S - s0);
  const float* xb = xyz + (size_t)b * N * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < nc) {
    const float* c = new_xyz + ((size_t)b * S + s0 + warp) * 3;
    const float cx = c[0], cy = c[1], cz = c[2];
    if (lane == 0) {
      cen[warp][0] = cx;
      cen[warp][1] = cy;
      cen[warp][2] = cz;
    }
    const float q2 = fmaf(cz, cz, fmaf(cy, cy, fmaf(cx, cx, 0.f)));
    int* mine = slots + warp * K;
    int count = 0;
    for (int base = 0; base < N && count < K; base += 32) {
      const int j = base + lane;
      bool in = false;
      if (j < N) {
        const float px = xb[3 * j], py = xb[3 * j + 1], pz = xb[3 * j + 2];
        const float p2 = fmaf(pz, pz, fmaf(py, py, fmaf(px, px, 0.f)));
        const float dot = fmaf(cz, pz, fmaf(cy, py, fmaf(cx, px, 0.f)));
        in = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)), p2) <= r2;
      }
      const unsigned m = __ballot_sync(0xffffffffu, in);
      const int rank = count + __popc(m & ((1u << lane) - 1u));
      if (in && rank < K) mine[rank] = j;
      count += __popc(m);
    }
    if (lane == 0) {
      if (count == 0) mine[0] = 0;
      nball[warp] = count == 0 ? 1 : min(count, K);
    }
  }
  for (int e = threadIdx.x; e < kBallCentres * C3; e += blockDim.x) best[e] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    first_row[0] = 0;
    for (int q = 0; q < kBallCentres; ++q)
      first_row[q + 1] = first_row[q] + (q < nc ? nball[q] : 0);
  }
  __syncthreads();
  const int total = first_row[kBallCentres];

  for (int t0 = 0; t0 < total; t0 += kRows) {
    if (threadIdx.x < kRows) {
      const int r = t0 + threadIdx.x;
      int q = -1, p = 0;
      float ox = 0.f, oy = 0.f, oz = 0.f;
      if (r < total) {
        q = 0;
        while (r >= first_row[q + 1]) ++q;
        p = slots[q * K + r - first_row[q]];
        ox = __fsub_rn(xb[3 * p], cen[q][0]);
        oy = __fsub_rn(xb[3 * p + 1], cen[q][1]);
        oz = __fsub_rn(xb[3 * p + 2], cen[q][2]);
      }
      row_q[threadIdx.x] = q;
      row_p[threadIdx.x] = p;
      offs[3 * threadIdx.x] = ox;
      offs[3 * threadIdx.x + 1] = oy;
      offs[3 * threadIdx.x + 2] = oz;
    }
    __syncthreads();
    // layer 1: relu(((offset @ A1x) + b1) + uf[p]), transposed into h1
    for (int e = threadIdx.x; e < kRows * C1; e += blockDim.x) {
      const int r = e / C1, c = e - r * C1;
      float v = 0.f;
      if (row_q[r] >= 0) {
        const float* o = offs + 3 * r;
        float pre = fmaf(o[2], a1x[2 * C1 + c],
                         fmaf(o[1], a1x[C1 + c], __fmul_rn(o[0], a1x[c])));
        pre = __fadd_rn(pre, b1[c]);
        if (HAS_UF) pre = __fadd_rn(pre, uf[((size_t)b * N + row_p[r]) * C1 + c]);
        v = fmaxf(pre, 0.f);
      }
      h1[c * kStride + r] = v;
    }
    __syncthreads();
    dense_tile(h1, C1, a2, b2, C2, [&](int r0, int c0, const float (&v)[kTM][kTN]) {
      store_relu_t(h2, r0, c0, v);
    });
    __syncthreads();
    dense_tile(h2, C2, a3, b3, C3, [&](int r0, int c0, const float (&v)[kTM][kTN]) {
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        int cq = row_q[r0];
        float m = 0.f;                 // the max of relu(v) over the run of rows
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const int q = row_q[r0 + r];
          if (q != cq) {
            if (cq >= 0) atomicMax(best + cq * C3 + c0 + c, __float_as_int(m));
            cq = q;
            m = 0.f;
          }
          if (v[r][c] > m) m = v[r][c];
        }
        if (cq >= 0) atomicMax(best + cq * C3 + c0 + c, __float_as_int(m));
      }
    });
    __syncthreads();
  }
  float* ob = out + ((size_t)b * S + s0) * C3;
  for (int e = threadIdx.x; e < nc * C3; e += blockDim.x) ob[e] = __int_as_float(best[e]);
}

// ---------------------------------------------------------- iq_knn_density
// Replaces knn_with_density -> _knn_den_kernel (ops/pallas/groups.py:290-364).
//
// What bounds it on H100: the selection, as in iq_knn (operations: the
// distances are 2*N*C FLOP per query, the insertion a compare per candidate
// and a k-step shift per accepted one).  The selection is select_knn itself,
// templated on the list length (k = 32 at PointConv SA1, 64 at SA2), so the
// indices are those of iq_knn bit for bit; each thread then reads its
// neighbours' inverse densities and their max from device memory.
template <int KMAX>
__global__ void __launch_bounds__(kQueries)
knn_density_kernel(const float* __restrict__ query, const float* __restrict__ db,
                   const float* __restrict__ invden, int32_t* __restrict__ oidx,
                   float* __restrict__ oden, float* __restrict__ odmax, int S, int N,
                   int C, int k, int nqb) {
  extern __shared__ __align__(16) float smem[];
  const SelectSmem sm(smem, round_up4(C));
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kQueries;
  float bd[KMAX];
  int bi[KMAX];
  select_knn<KMAX>(query + (size_t)b * S * C, db + (size_t)b * N * C, S, N, C, k, q0,
                   sm, bd, bi);
  const int q = q0 + threadIdx.x;
  if (q < S) {
    const float* iv = invden + (size_t)b * N;
    const size_t o = ((size_t)b * S + q) * k;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k) {
        const float v = __ldg(iv + bi[i]);
        oidx[o + i] = bi[i];
        oden[o + i] = v;
        mx = fmaxf(mx, v);
      }
    }
    odmax[(size_t)b * S + q] = mx;
  }
}

// --------------------------------------------------------- iq_pointconv_sa
// WeightNet 3 -> 8 -> 8 -> 16 (BN folded, ReLU after every layer) on one
// neighbour's exact f32 offset; wn packs (w1, f1, w2, f2, w3, f3) with each
// w as (in, out) row-major.
__device__ __forceinline__ void weightnet(const float (&off)[3], const float* wn,
                                          float (&o)[kWO]) {
  const float* w1 = wn;
  const float* f1 = w1 + 3 * kWH;
  const float* w2 = f1 + kWH;
  const float* f2 = w2 + kWH * kWH;
  const float* w3 = f2 + kWH;
  const float* f3 = w3 + kWH * kWO;
  float h[kWH], g[kWH];
#pragma unroll
  for (int n = 0; n < kWH; ++n) {
    const float acc = fmaf(off[2], w1[2 * kWH + n],
                           fmaf(off[1], w1[kWH + n], __fmul_rn(off[0], w1[n])));
    h[n] = fmaxf(__fadd_rn(acc, f1[n]), 0.f);
  }
#pragma unroll
  for (int n = 0; n < kWH; ++n) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kWH; ++i) acc = fmaf(h[i], w2[i * kWH + n], acc);
    g[n] = fmaxf(__fadd_rn(acc, f2[n]), 0.f);
  }
#pragma unroll
  for (int n = 0; n < kWO; ++n) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kWH; ++i) acc = fmaf(g[i], w3[i * kWO + n], acc);
    o[n] = fmaxf(__fadd_rn(acc, f3[n]), 0.f);
  }
}

// Replaces fused_pointconv_sa -> _pconv_kernel (ops/pallas/groups.py:367-501).
//
// What bounds it on H100: operations.  Per neighbour, layers 2 and 3 cost
// 2*(C1*C2 + C2*C3) FLOP and the contraction 2*16*C3, about 2.2 TFLOP for one
// PointConv forward of 1650 clouds, against 67 TFLOP/s of f32; the output,
// (B, S, C3*16), is 6.9 GB at SA1, two milliseconds of writes.  The design:
// one block takes G = kRows / K whole centres, so a tile holds all their
// neighbours (K <= kRows).  A thread per row gathers the index and density
// scale, computes the exact offset and runs the small WeightNet in
// registers; layer 1 is the elementwise relu(u[p] - csw[q]); layers 2 and 3
// run through dense_tile, layer 3's epilogue scales each row by its density
// scale into the shared buffer that layer 1 no longer needs.  Then one
// thread per (centre, channel) sums h[j, c] * wt[j, 0..15] over the
// neighbours in slot order, in registers, and writes its 16 outputs as four
// float4s at out[q, c*16 .. c*16+15], the reference's C-major flattening.
__global__ void __launch_bounds__(kThreads)
pointconv_sa_kernel(const int32_t* __restrict__ idx, const float* __restrict__ ds,
                    const float* __restrict__ new_xyz, const float* __restrict__ u,
                    const float* __restrict__ xyz, const float* __restrict__ csw,
                    const float* __restrict__ a2, const float* __restrict__ b2,
                    const float* __restrict__ a3, const float* __restrict__ b3,
                    const float* __restrict__ wnet, float* __restrict__ out, int S, int N,
                    int K, int C1, int C2, int C3, int G, int nqb) {
  extern __shared__ __align__(16) float smem[];
  float* ha = smem;                                   // h1^T [C1][kStride], then h3 [kRows][C3]
  float* h2 = ha + max(C1 * kStride, kRows * C3);     // [C2][kStride]
  float* wt = h2 + C2 * kStride;                      // [kRows][kWO] WeightNet outputs
  float* wn = wt + kRows * kWO;                       // [kWnetFloats]
  float* dsr = wn + kWnetFloats;                      // [kRows] density scale of each row
  int* row_p = reinterpret_cast<int*>(dsr + kRows);   // [kRows] point of each row

  const int b = blockIdx.x / nqb;
  const int s0 = (blockIdx.x - b * nqb) * G;
  const int nc = min(G, S - s0);
  const int rows = nc * K;
  for (int e = threadIdx.x; e < kWnetFloats; e += blockDim.x) wn[e] = wnet[e];
  __syncthreads();

  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float o[kWO];
    int p = 0;
    float d = 0.f;
    if (r < rows) {
      const int q = r / K;
      const size_t at = ((size_t)b * S + s0 + q) * K + (r - q * K);
      p = idx[at];
      d = ds[at];
      const float* c = new_xyz + ((size_t)b * S + s0 + q) * 3;
      const float* pt = xyz + ((size_t)b * N + p) * 3;
      const float off[3] = {__fsub_rn(pt[0], c[0]), __fsub_rn(pt[1], c[1]),
                            __fsub_rn(pt[2], c[2])};
      weightnet(off, wn, o);
    } else {
#pragma unroll
      for (int w = 0; w < kWO; ++w) o[w] = 0.f;
    }
    row_p[r] = p;
    dsr[r] = d;
#pragma unroll
    for (int w = 0; w < kWO; w += 4)
      *reinterpret_cast<float4*>(wt + r * kWO + w) =
          make_float4(o[w], o[w + 1], o[w + 2], o[w + 3]);
  }
  __syncthreads();
  // layer 1: relu(u[p] - csw[q]), transposed into ha
  for (int e = threadIdx.x; e < kRows * C1; e += blockDim.x) {
    const int r = e / C1, c = e - r * C1;
    float v = 0.f;
    if (r < rows) {
      const int q = r / K;
      v = fmaxf(__fsub_rn(u[((size_t)b * N + row_p[r]) * C1 + c],
                          csw[((size_t)b * S + s0 + q) * C1 + c]),
                0.f);
    }
    ha[c * kStride + r] = v;
  }
  __syncthreads();
  dense_tile(ha, C1, a2, b2, C2, [&](int r0, int c0, const float (&v)[kTM][kTN]) {
    store_relu_t(h2, r0, c0, v);
  });
  __syncthreads();
  dense_tile(h2, C2, a3, b3, C3, [&](int r0, int c0, const float (&v)[kTM][kTN]) {
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
      const float s = dsr[r0 + r];
      *reinterpret_cast<float4*>(ha + (r0 + r) * C3 + c0) = make_float4(
          __fmul_rn(fmaxf(v[r][0], 0.f), s), __fmul_rn(fmaxf(v[r][1], 0.f), s),
          __fmul_rn(fmaxf(v[r][2], 0.f), s), __fmul_rn(fmaxf(v[r][3], 0.f), s));
    }
  });
  __syncthreads();
  for (int e = threadIdx.x; e < nc * C3; e += blockDim.x) {
    const int q = e / C3, c = e - q * C3;
    float acc[kWO];
#pragma unroll
    for (int w = 0; w < kWO; ++w) acc[w] = 0.f;
    for (int j = 0; j < K; ++j) {
      const int r = q * K + j;
      const float h = ha[r * C3 + c];
      const float4* wr = reinterpret_cast<const float4*>(wt + r * kWO);
#pragma unroll
      for (int w4 = 0; w4 < kWO / 4; ++w4) {
        const float4 t = wr[w4];
        acc[4 * w4] = fmaf(h, t.x, acc[4 * w4]);
        acc[4 * w4 + 1] = fmaf(h, t.y, acc[4 * w4 + 1]);
        acc[4 * w4 + 2] = fmaf(h, t.z, acc[4 * w4 + 2]);
        acc[4 * w4 + 3] = fmaf(h, t.w, acc[4 * w4 + 3]);
      }
    }
    float4* dst = reinterpret_cast<float4*>(out + (((size_t)b * S + s0 + q) * C3 + c) * kWO);
#pragma unroll
    for (int w4 = 0; w4 < kWO / 4; ++w4)
      dst[w4] = make_float4(acc[4 * w4], acc[4 * w4 + 1], acc[4 * w4 + 2], acc[4 * w4 + 3]);
  }
}

// out[b, r, :] = values[b, idx[b, r], :] over the R = S * K rows of each
// cloud; T is float4 where F % 4 == 0 (FT = F / 4), else float (FT = F).
// A pure copy, so bound by bytes: the output, K times the values, dominates.
// The TPU kernel gathered by one-hot matmuls against bf16 hi/lo planes with F
// padded to 128; here each row is copied exactly in f32.  The tx threads of
// a row (a power of two up to 32, inside one warp) walk it along F, so a
// warp's stores are contiguous; the row's first thread reads its index once
// and shuffles it to the others.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ values, const int32_t* __restrict__ idx,
                   T* __restrict__ out, int N, long long R, long long rows, int FT) {
  const int tx = blockDim.x;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  int src = 0;
  if (live && threadIdx.x == 0) src = __ldg(idx + row);
  src = __shfl_sync(0xffffffffu, src, 0, tx);   // every lane of the warp takes part
  if (!live) return;
  const T* in = values + ((size_t)(row / R) * N + src) * FT;
  T* o = out + (size_t)row * FT;
  for (int c = threadIdx.x; c < FT; c += tx) o[c] = __ldg(in + c);
}

}  // namespace

extern "C" {

int iq_ball_mlp3(const float* new_xyz, const float* xyz, const float* uf, const float* b1,
                 const float* a1x, const float* a2, const float* b2, const float* a3,
                 const float* b3, float* out, int B, int S, int N, int K, int C1, int C2,
                 int C3, float r2, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (N < 1 || K < 1 || C1 < 1 || C2 < kTN || C3 < kTN || C2 % kTN || C3 % kTN)
    return cudaErrorInvalidValue;
  const size_t smem = ((size_t)(C1 + C2) * kStride + (size_t)kBallCentres * (C3 + K) +
                       (size_t)kRows * 5) * sizeof(float);
  const int nqb = (S + kBallCentres - 1) / kBallCentres;
  const dim3 grid((unsigned)B * nqb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (uf != nullptr) {
    if ((err = prepare(ball_mlp3_kernel<true>, smem)) != cudaSuccess) return err;
    ball_mlp3_kernel<true><<<grid, kThreads, smem, s>>>(new_xyz, xyz, uf, b1, a1x, a2, b2,
                                                         a3, b3, out, S, N, K, C1, C2, C3,
                                                         r2, nqb);
  } else {
    if ((err = prepare(ball_mlp3_kernel<false>, smem)) != cudaSuccess) return err;
    ball_mlp3_kernel<false><<<grid, kThreads, smem, s>>>(new_xyz, xyz, uf, b1, a1x, a2, b2,
                                                          a3, b3, out, S, N, K, C1, C2, C3,
                                                          r2, nqb);
  }
  return cudaGetLastError();
}

int iq_knn_density(const float* query, const float* db, const float* invden, int32_t* idx,
                   float* den, float* dmax, int B, int S, int N, int C, int k,
                   void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxDensityK || k > N || C < 1) return cudaErrorInvalidValue;
  const size_t smem = select_smem_floats(round_up4(C)) * sizeof(float);
  const int nqb = (S + kQueries - 1) / kQueries;
  const dim3 grid((unsigned)B * nqb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 32) {
    if ((err = prepare(knn_density_kernel<32>, smem)) != cudaSuccess) return err;
    knn_density_kernel<32><<<grid, kQueries, smem, s>>>(query, db, invden, idx, den, dmax,
                                                        S, N, C, k, nqb);
  } else {
    if ((err = prepare(knn_density_kernel<kMaxDensityK>, smem)) != cudaSuccess) return err;
    knn_density_kernel<kMaxDensityK><<<grid, kQueries, smem, s>>>(
        query, db, invden, idx, den, dmax, S, N, C, k, nqb);
  }
  return cudaGetLastError();
}

int iq_pointconv_sa(const int32_t* idx, const float* ds, const float* new_xyz,
                    const float* u, const float* xyz, const float* csw, const float* a2,
                    const float* b2, const float* a3, const float* b3, const float* wnet,
                    float* out, int B, int S, int N, int K, int C1, int C2, int C3,
                    void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (N < 1 || K < 1 || K > kRows || C1 < 1 || C2 < kTN || C3 < kTN || C2 % kTN ||
      C3 % kTN)
    return cudaErrorInvalidValue;
  const int G = kRows / K;
  const size_t ha = (size_t)C1 * kStride > (size_t)kRows * C3 ? (size_t)C1 * kStride
                                                               : (size_t)kRows * C3;
  const size_t smem = (ha + (size_t)C2 * kStride + (size_t)kRows * kWO + kWnetFloats +
                       2 * kRows) * sizeof(float);
  const int nqb = (S + G - 1) / G;
  cudaError_t err;
  if ((err = prepare(pointconv_sa_kernel, smem)) != cudaSuccess) return err;
  pointconv_sa_kernel<<<(unsigned)B * nqb, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      idx, ds, new_xyz, u, xyz, csw, a2, b2, a3, b3, wnet, out, S, N, K, C1, C2, C3, G,
      nqb);
  return cudaGetLastError();
}

int iq_gather_rows(const float* values, const int32_t* idx, float* out, int B, int N, int R,
                   int F, void* stream) {
  if (B <= 0 || R <= 0) return cudaSuccess;
  if (N < 1 || F < 1) return cudaErrorInvalidValue;
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int FT = vec ? F / 4 : F;
  int tx = 1;
  while (tx < FT && tx < 32) tx <<= 1;
  const dim3 block(tx, kThreads / tx);
  const long long rows = (long long)B * R;
  const long long nblocks = (rows + block.y - 1) / block.y;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    gather_rows_kernel<float4><<<(unsigned)nblocks, block, 0, s>>>(
        reinterpret_cast<const float4*>(values), idx, reinterpret_cast<float4*>(out), N, R,
        rows, FT);
  } else {
    gather_rows_kernel<float><<<(unsigned)nblocks, block, 0, s>>>(values, idx, out, N, R,
                                                                   rows, FT);
  }
  return cudaGetLastError();
}

}  // extern "C"
