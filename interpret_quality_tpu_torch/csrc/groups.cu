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
//                     replaces groups.py:337 knn_with_density -> _knn_den_kernel
//   iq_pointconv_sa   the PointConv SA grouped compute: gathered layer-1 rows,
//                     layers 2-3, density scale, WeightNet on exact offsets,
//                     and the contraction over the neighbours
//                     replaces groups.py fused_pointconv_sa -> _pconv_kernel
//   iq_gather_rows    grouped row gather, out[b, r, :] = values[b, idx[b, r], :],
//                     the values f32 or bf16 (--gather_precision bf16)
//                     replaces groups.py gather_rows -> _gather_rows_kernel
//
// None of the TPU workarounds are carried over: rows are gathered directly
// (no one-hot matmuls, no bf16 hi/lo planes; at the bf16 gather precision
// the callers hand over values rounded to bf16, which is what the TPU's one
// bf16 plane gives) and the kNN keeps f32 distances with ties to the
// lowest index (the xyz route of knn_xyz.cuh or the tiled select_knn, both
// shared with neighbors.cu), compared as the keys of the launch's selection
// class (exact, packed or bf16: knn_select.cuh select_key).  iq_ball_mlp3
// and iq_pointconv_sa run their layers 2 and 3 on the tensor cores through
// one piece of code (order_weights_kernel, WeightRing, mma_layer,
// mlp_layers23; see iq_ball_mlp3; the product's helpers, shared with
// dense.cu, in mma_tf32.cuh), at the matmul precision `prec` a template
// parameter: at kPrecHighest a three-product TF32 split that keeps f32
// accuracy, at kPrecHigh one product of operands rounded to TF32, at
// kPrecDefault one product of operands rounded to bf16 (exact in TF32: one
// bf16 pass).  Each
// brings its own front (a ball query, a gather of given neighbours) and its
// own epilogue (a max over the ball, a contraction over the neighbours).
// All other arithmetic is f32 on the CUDA cores, iq_pointconv_sa's
// WeightNet on operands rounded for `prec`.  The (B, S, K, C) grouped
// tensors never exist in device memory.
//
// Launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for arguments the
// kernels do not take.  Indices handed to iq_pointconv_sa and
// iq_gather_rows must lie in [0, N); neither checks.

#include "knn_select.cuh"
#include "knn_xyz.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;               // threads per block of the MLP kernels
constexpr int kMaxDensityK = 64;            // largest k of iq_knn_density
constexpr int kMaxPconvK = 64;              // largest K of iq_pointconv_sa
constexpr int kWH = 8;                      // WeightNet 3 -> kWH -> kWH -> kWO
constexpr int kWO = 16;
constexpr int kWnetFloats = 3 * kWH + kWH + kWH * kWH + kWH + kWH * kWO + kWO;

// ------------------------------------------------------------ iq_ball_mlp3
// Replaces fused_ball_mlp3 -> _ball_mlp3_kernel (ops/pallas/groups.py:40-113,
// 188-284).
//
// What bounds it on H100: operations.  Layers 2 and 3 cost 2*(C1*C2 + C2*C3)
// FLOP per filled slot, about 9 TFLOP for one PointNet++ forward of 1650
// masked clouds.  They run on the tensor cores in TF32 with f32 accuracy
// kept by a three-product split: every f32 operand is x = hi + lo (hi: the
// low 13 mantissa bits cleared, lo: x - hi rounded to TF32) and a product is
// lo*w_hi + hi*w_lo + hi*w_hi, accumulated in f32; only lo*w_lo (2^-22
// relative) is dropped.  A single TF32 or bf16 pass keeps three decimal
// digits and is not used anywhere here.  The instruction is
// mma.sync.m16n8k8 (row.col, tf32 in, f32 out).
//
// The design.  order_weights_kernel writes both layers' weights once per
// launch, still whole f32 values, in the order the mma's B fragments are
// read: for every (k-step of 8, column tile of 8) 32 lanes x float2 (b0, b1),
// so a warp fetches a B fragment with one conflict-free 8-byte load per lane
// and splits it in registers (8 operations beside 12 mma).  Storing hi and
// lo apart would double the bytes, and the stream from L2 costs more than the
// split (PERF.md).  The stream is cut into slabs of at most
// 16 KB and copied to a ring in shared memory with cp.async: a branch whose
// slabs all fit keeps them resident for the life of the block (four of
// PointNet++'s six); otherwise four buffers hold a stream that runs three
// slabs ahead of the products, across layer and tile boundaries, one
// block-wide barrier per slab.
//
// Blocks are persistent (one per SM).  A block draws batches of centres of
// one cloud from a global counter; one warp per centre scans the cloud in
// index order (128 points a step, twelve loads in flight) and a ballot and a
// popcount per 32 rank the in-ball points, so the first K land in their slots
// in order and the scan stops at K.  Slots beyond the in-ball count repeat slot 0 and cannot change
// the max, so only the filled slots become rows; without feature rows (SA1)
// neither can a slot whose point has the very coordinates of an earlier one
// (first_copy_kernel: about a third to a half of the slots of a masked
// batch), so it becomes no row either.  The rows of all centres go
// to a circular queue, whatever their cloud, and leave it as full tiles of
// 128 rows: layer 1 is elementwise (exact f32 offsets against the three xyz
// rows of A1, plus the hoisted feature row), then each of the 8 warps owns 64
// rows x a quarter of the layer's columns of both products (A fragments
// split in registers; two column tiles at a time, pass by pass, so that 8
// independent accumulators lie between two products into the same one).
// Layer 3's outputs go back to shared memory with bias and ReLU, where a
// thread per four columns and stretch of rows folds each centre's run and
// sends one atomicMax on the f32 bits per run and column to `out` (zeroed by the launcher; all
// kept values are > 0, where the order of the bits is the order of the
// floats).  An atomicMax per thread and row run straight from the
// accumulators would cost more than the products themselves.
//
// Membership uses the distance form of ops/geometry.square_distance,
// (|c|^2 - 2 c.p) + |p|^2, against r2 = f32(radius^2) with <=; the norms and
// the dot product are fmaf chains.  An empty ball takes index 0, as
// query_ball_point does.
constexpr int kBallRows = 128;              // rows of a tile
constexpr int kSlabFloats = 4096;           // floats of one ring buffer (16 KB)
constexpr int kAhead = 3;                   // slabs in flight when streaming
constexpr int kQueueCap = 2048;             // circular row queue (a power of two)
constexpr int kMaxBatchRows = 1024;         // centres of a batch x K
constexpr int kMaxBatch = 32;               // centres of a batch
// floats of shared memory beside the activations and the weight ring:
// queue (centre, point), slots, row centre/point, offsets, nball, first, unit
constexpr int kBallFixedFloats =
    2 * kQueueCap + kMaxBatchRows + 2 * kBallRows + 3 * kBallRows + kMaxBatch +
    (kMaxBatch + 1) + 3;

// w (cin, cout) row-major -> the order the B fragments are read in: float2
// number (ks * (cout / 8) + nt) * 32 + lane holds w[ks*8 + lane%4][nt*8 +
// lane/4] and the value four rows below it; rounded for a one-pass product
// at precision prec, whole f32 at kPrecHighest (mma_layer splits them).
__global__ void order_weights_kernel(const float* __restrict__ w, int cin, int cout,
                                     float2* __restrict__ frag, int prec) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (cin / 8) * (cout / 8) * 32) return;
  const int lane = e & 31, tile = e >> 5;
  const int nt = tile % (cout / 8), ks = tile / (cout / 8);
  const int col = nt * 8 + (lane >> 2), row = ks * 8 + (lane & 3);
  const float x0 = w[(size_t)row * cout + col], x1 = w[(size_t)(row + 4) * cout + col];
  frag[e] = make_float2(round_operand(prec, x0), round_operand(prec, x1));
}

// k-steps of one slab: the largest power of two that fits a ring buffer and
// divides the layer's k-steps
__host__ __device__ __forceinline__ int slab_ksteps(int cin, int cout) {
  int kps = 1;
  while (2 * kps * cout * 8 <= kSlabFloats && (cin / 8) % (2 * kps) == 0) kps *= 2;
  return kps;
}

// The weight stream of one launch: layer 2's slabs, then layer 3's, over and
// over.  All fields are uniform over the block.
struct WeightRing {
  const float* frag;     // device memory: layer 2's fragments, then layer 3's
  float* ring;           // shared memory: nbuf buffers of kSlabFloats
  int n2, s2, n3, s3;    // slabs and floats per slab of each layer
  int nbuf;              // ring buffers; resident when n2 + n3 <= nbuf
  int next;              // slabs consumed so far

  __device__ __forceinline__ bool resident() const { return n2 + n3 <= nbuf; }

  // start the copy of stream slab number g (one commit group)
  __device__ __forceinline__ void copy_slab(int g) {
    const int j = g % (n2 + n3);
    const float* src = j < n2 ? frag + (size_t)j * s2
                              : frag + (size_t)n2 * s2 + (size_t)(j - n2) * s3;
    const int n = j < n2 ? s2 : s3;
    float* dst = ring + (g % nbuf) * kSlabFloats;
    for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x)
      cp_async16(dst + e, src + e, true);
    cp_async_commit();
  }

  __device__ __forceinline__ void start() {
    next = 0;
    if (resident()) {
      for (int g = 0; g < n2 + n3; ++g) copy_slab(g);
      cp_async_wait<0>();
      __syncthreads();
    } else {
      for (int g = 0; g < kAhead; ++g) copy_slab(g);
    }
  }

  // the next slab of the stream, landed and visible to the whole block
  __device__ __forceinline__ const float2* acquire() {
    const int g = next++;
    if (!resident()) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();             // slab g landed; everyone is done with slab g - 1
      copy_slab(g + kAhead);       // into the buffer of slab g - 1 (nbuf == kAhead + 1)
    }
    return reinterpret_cast<const float2*>(ring + (g % nbuf) * kSlabFloats);
  }
};

// acc = x @ w for this warp's 64 rows x NT column tiles, w from the ring.
// x is [kBallRows][xs] in shared memory (xs = cin + 4: conflict-free
// fragment loads); rows rg*64.., column tiles cq*NT...  At kPrecHighest
// three products of the TF32 halves; else one product of x rounded here
// and w as order_weights_kernel rounded it.
template <int NT, int PREC>
__device__ __forceinline__ void mma_layer(const float* x, int xs, int cin, int cout,
                                          int nslabs, WeightRing& wr,
                                          float (&acc)[4][NT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 2, cq = warp & 3;
  const int ntc = cout / 8;
  const int kps = (cin / 8) / nslabs;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const float* xrow = x + (rg * 64 + g) * xs + t;
  for (int slab = 0; slab < nslabs; ++slab) {
    const float2* wb = wr.acquire() + (cq * NT) * 32 + lane;
    for (int kk = 0; kk < kps; ++kk) {
      const float* xa = xrow + (slab * kps + kk) * 8;
      float ahi[4][4], alo[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* p = xa + mt * 16 * xs;
        const float v[4] = {p[0], p[8 * xs], p[4], p[8 * xs + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (one_pass(PREC)) {
            ahi[mt][i] = round_operand(PREC, v[i]);
          } else {
            ahi[mt][i] = tf32_hi(v[i]);
            alo[mt][i] = tf32_lo(v[i], ahi[mt][i]);
          }
        }
      }
      // two column tiles at a time, pass by pass: 8 independent
      // accumulators between two products into the same one
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        float bh[2][2], bl[2][2];       // the weights' halves, split here
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (nt + j < NT) {
            const float2 b = wb[(kk * ntc + nt + j) * 32];
            if (one_pass(PREC)) {       // rounded already
              bh[j][0] = b.x;
              bh[j][1] = b.y;
            } else {
              bh[j][0] = tf32_hi(b.x);
              bh[j][1] = tf32_hi(b.y);
              bl[j][0] = tf32_lo(b.x, bh[j][0]);
              bl[j][1] = tf32_lo(b.y, bh[j][1]);
            }
          }
        if (!one_pass(PREC)) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
              if (nt + j < NT) mma_tf32(acc[mt][nt + j], alo[mt], bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
              if (nt + j < NT) mma_tf32(acc[mt][nt + j], ahi[mt], bl[j][0], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            if (nt + j < NT) mma_tf32(acc[mt][nt + j], ahi[mt], bh[j][0], bh[j][1]);
      }
    }
  }
}

// Layers 2 and 3 of one tile of kBallRows rows, for the whole block; NT2/NT3:
// column tiles of 8 per warp (a quarter of each layer's columns).  h1 is
// [kBallRows][C1 + 4], h2 [kBallRows][C2 + 4]; the result,
// relu(relu(h1 @ a2 + b2) @ a3 + b3), with SCALE times row_scale[row], is
// left in shared memory over h1 and h2 (both dead by then) at row stride xs3
// (kBallRows * xs3 floats must fit in h1 and h2 together), visible to every
// thread on return.  Each caller brings its own epilogue from there.
template <int NT2, int NT3, bool SCALE, int PREC>
__device__ __forceinline__ float* mlp_layers23(const float* h1, float* h2, int C1, int C2,
                                               int C3, int xs3, WeightRing& wr,
                                               const float* __restrict__ b2,
                                               const float* __restrict__ b3,
                                               const float* row_scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 2, cq = warp & 3;
  {
    float acc[4][NT2][4];
    mma_layer<NT2, PREC>(h1, C1 + 4, C1, C2, wr.n2, wr, acc);
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt) {
      const int c = (cq * NT2 + nt) * 8 + 2 * t;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + c));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float* dst = h2 + (rg * 64 + mt * 16 + g) * (C2 + 4) + c;
        *reinterpret_cast<float2*>(dst) =
            make_float2(fmaxf(__fadd_rn(acc[mt][nt][0], bias.x), 0.f),
                        fmaxf(__fadd_rn(acc[mt][nt][1], bias.y), 0.f));
        *reinterpret_cast<float2*>(dst + 8 * (C2 + 4)) =
            make_float2(fmaxf(__fadd_rn(acc[mt][nt][2], bias.x), 0.f),
                        fmaxf(__fadd_rn(acc[mt][nt][3], bias.y), 0.f));
      }
    }
  }
  __syncthreads();
  float acc[4][NT3][4];
  mma_layer<NT3, PREC>(h2, C2 + 4, C2, C3, wr.n3, wr, acc);
  __syncthreads();                    // every warp is done reading h2
  float* o3 = const_cast<float*>(h1);
  float s0[4], s1[4];                 // the scales of this thread's rows
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    s0[mt] = SCALE ? row_scale[rg * 64 + mt * 16 + g] : 1.f;
    s1[mt] = SCALE ? row_scale[rg * 64 + mt * 16 + g + 8] : 1.f;
  }
#pragma unroll
  for (int nt = 0; nt < NT3; ++nt) {
    const int c = (cq * NT3 + nt) * 8 + 2 * t;
    const float2 bias = __ldg(reinterpret_cast<const float2*>(b3 + c));
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float* dst = o3 + (rg * 64 + mt * 16 + g) * xs3 + c;
      float2 lo = make_float2(fmaxf(__fadd_rn(acc[mt][nt][0], bias.x), 0.f),
                              fmaxf(__fadd_rn(acc[mt][nt][1], bias.y), 0.f));
      float2 hi = make_float2(fmaxf(__fadd_rn(acc[mt][nt][2], bias.x), 0.f),
                              fmaxf(__fadd_rn(acc[mt][nt][3], bias.y), 0.f));
      if (SCALE) {
        lo = make_float2(__fmul_rn(lo.x, s0[mt]), __fmul_rn(lo.y, s0[mt]));
        hi = make_float2(__fmul_rn(hi.x, s1[mt]), __fmul_rn(hi.y, s1[mt]));
      }
      *reinterpret_cast<float2*>(dst) = lo;
      *reinterpret_cast<float2*>(dst + 8 * xs3) = hi;
    }
  }
  __syncthreads();
  return o3;
}

// iq_ball_mlp3's layers 2 and 3 of one tile and its epilogue: a thread per
// four columns folds each centre's run of rows into `out`.
template <int NT2, int NT3, int PREC>
__device__ __forceinline__ void ball_layers23(const float* h1, float* h2, int C1, int C2,
                                              int C3, WeightRing& wr,
                                              const float* __restrict__ b2,
                                              const float* __restrict__ b3,
                                              const int* row_c, float* __restrict__ out) {
  const float* o3 =
      mlp_layers23<NT2, NT3, false, PREC>(h1, h2, C1, C2, C3, C3 + 4, wr, b2, b3, nullptr);
  // a thread takes four columns of a stretch of 128 / parts rows
  const int cg = C3 / 4, rows_per = kBallRows / (kThreads / cg);
  const int c = (threadIdx.x % cg) * 4, r0 = (threadIdx.x / cg) * rows_per;
  int* o = reinterpret_cast<int*>(out) + c;
  auto flush = [&](int centre, const float4& m) {
    if (centre < 0) return;
    int* at = o + (size_t)centre * C3;
    if (m.x > 0.f) atomicMax(at, __float_as_int(m.x));
    if (m.y > 0.f) atomicMax(at + 1, __float_as_int(m.y));
    if (m.z > 0.f) atomicMax(at + 2, __float_as_int(m.z));
    if (m.w > 0.f) atomicMax(at + 3, __float_as_int(m.w));
  };
  int cur = -1;
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int r = r0; r < r0 + rows_per; ++r) {
    const int rc = row_c[r];
    const float4 v = *reinterpret_cast<const float4*>(o3 + r * (C3 + 4) + c);
    if (rc != cur) {
      flush(cur, m);
      cur = rc;
      m = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    m = make_float4(fmaxf(m.x, v.x), fmaxf(m.y, v.y), fmaxf(m.z, v.z), fmaxf(m.w, v.w));
  }
  flush(cur, m);
}

// first_copy[b, n] = the lowest index whose coordinates are bit for bit those
// of point n of cloud b (n itself for a point without an earlier copy).
// Masked coalitions put whole regions on one point, and without feature rows
// a slot's row depends on its coordinates alone: a later copy repeats an
// earlier slot's row and cannot change the max.
__global__ void __launch_bounds__(kThreads)
first_copy_kernel(const float* __restrict__ xyz, int* __restrict__ first_copy, int N) {
  const unsigned* xb = reinterpret_cast<const unsigned*>(xyz) + (size_t)blockIdx.x * N * 3;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const unsigned x = xb[3 * n], y = xb[3 * n + 1], z = xb[3 * n + 2];
    int m = 0;
    while (m < n && !(xb[3 * m] == x && xb[3 * m + 1] == y && xb[3 * m + 2] == z)) ++m;
    first_copy[(size_t)blockIdx.x * N + n] = m;
  }
}

template <bool HAS_UF, int PREC>
__global__ void __launch_bounds__(kThreads, 1)
ball_mlp3_kernel(const float* __restrict__ new_xyz, const float* __restrict__ xyz,
                 const float* __restrict__ uf, const float* __restrict__ b1,
                 const float* __restrict__ a1x, const float* __restrict__ wfrag,
                 const float* __restrict__ b2, const float* __restrict__ b3,
                 float* __restrict__ out, int* __restrict__ counter,
                 unsigned long long* __restrict__ rows_count,
                 const int* __restrict__ first_copy, int B, int S, int N, int K, int C1,
                 int C2, int C3, float r2, int CB, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  float* h1 = smem;                                       // [kBallRows][C1 + 4]
  float* h2 = h1 + kBallRows * (C1 + 4);                  // [kBallRows][C2 + 4]
  float* ring = h2 + kBallRows * (C2 + 4);                // [nbuf][kSlabFloats]
  int* qc = reinterpret_cast<int*>(ring + nbuf * kSlabFloats);  // queue: centre b*S + s
  int* qp = qc + kQueueCap;                               // queue: point b*N + p
  int* slots = qp + kQueueCap;                            // [CB][K] ball members
  int* row_c = slots + kMaxBatchRows;                     // [kBallRows] centre, -1: none
  int* row_p = row_c + kBallRows;                         // [kBallRows] point
  float* offs = reinterpret_cast<float*>(row_p + kBallRows);  // [kBallRows][3]
  int* nball = reinterpret_cast<int*>(offs + 3 * kBallRows);  // [kMaxBatch]
  int* first = nball + kMaxBatch;                         // [kMaxBatch + 1]
  int* unit = first + kMaxBatch + 1;                      // [1] the batch drawn

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nqb = (S + CB - 1) / CB;
  const int total = B * nqb;

  WeightRing wr;
  wr.frag = wfrag;
  wr.ring = ring;
  wr.n2 = (C1 / 8) / slab_ksteps(C1, C2);
  wr.s2 = slab_ksteps(C1, C2) * C2 * 8;
  wr.n3 = (C2 / 8) / slab_ksteps(C2, C3);
  wr.s3 = slab_ksteps(C2, C3) * C3 * 8;
  wr.nbuf = nbuf;
  wr.start();

  // layer 1's four columns of this thread (C1 / 4 divides kThreads), their weights
  const int c1 = (threadIdx.x % (C1 / 4)) * 4;
  const float4 w1x = *reinterpret_cast<const float4*>(a1x + c1);
  const float4 w1y = *reinterpret_cast<const float4*>(a1x + C1 + c1);
  const float4 w1z = *reinterpret_cast<const float4*>(a1x + 2 * C1 + c1);
  const float4 w1b = *reinterpret_cast<const float4*>(b1 + c1);
  int head = 0, qlen = 0;
  bool done = false;
  while (true) {
    while (!done && qlen < kBallRows) {
      if (threadIdx.x == 0) unit[0] = atomicAdd(counter, 1);
      __syncthreads();
      const int batch = unit[0];
      if (batch >= total) {
        done = true;
        break;
      }
      const int b = batch / nqb;
      const int s0 = (batch - b * nqb) * CB;
      const int nc = min(CB, S - s0);
      const float* xb = xyz + (size_t)b * N * 3;
      for (int q = warp; q < nc; q += kThreads / 32) {
        const float* c = new_xyz + ((size_t)b * S + s0 + q) * 3;
        const float cx = c[0], cy = c[1], cz = c[2];
        const float q2 = fmaf(cz, cz, fmaf(cy, cy, fmaf(cx, cx, 0.f)));
        int* mine = slots + q * K;
        int count = 0, rows = 0;        // in-ball points, and those that become rows
        // 128 points a step, so that twelve loads are in flight at once
        for (int base = 0; base < N && count < K; base += 128) {
          bool in[4], fresh[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = base + 32 * u + lane;
            in[u] = false;
            fresh[u] = true;
            if (j < N) {
              if (!HAS_UF) fresh[u] = first_copy[(size_t)b * N + j] == j;
              const float px = xb[3 * j], py = xb[3 * j + 1], pz = xb[3 * j + 2];
              const float p2 = fmaf(pz, pz, fmaf(py, py, fmaf(px, px, 0.f)));
              const float dot = fmaf(cz, pz, fmaf(cy, py, fmaf(cx, px, 0.f)));
              in[u] = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)), p2) <= r2;
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const unsigned m = __ballot_sync(0xffffffffu, in[u]);
            const unsigned below = (1u << lane) - 1u;
            // a slot is one of the first K in-ball points; it becomes a row
            // unless an earlier point of the cloud has its very coordinates
            const bool row = in[u] && count + __popc(m & below) < K && fresh[u];
            const unsigned mr = __ballot_sync(0xffffffffu, row);
            if (row) mine[rows + __popc(mr & below)] = base + 32 * u + lane;
            count += __popc(m);
            rows += __popc(mr);
          }
        }
        if (lane == 0) {
          if (count == 0) mine[0] = 0;
          nball[q] = count == 0 ? 1 : rows;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        first[0] = 0;
        for (int q = 0; q < nc; ++q) first[q + 1] = first[q] + nball[q];
        if (rows_count != nullptr) atomicAdd(rows_count, (unsigned long long)first[nc]);
      }
      __syncthreads();
      for (int q = warp; q < nc; q += kThreads / 32)
        for (int i = lane; i < nball[q]; i += 32) {
          const int at = (head + qlen + first[q] + i) & (kQueueCap - 1);
          qc[at] = b * S + s0 + q;
          qp[at] = b * N + slots[q * K + i];
        }
      qlen += first[nc];
      __syncthreads();
    }
    if (qlen == 0) break;

    const int rows = min(kBallRows, qlen);
    if (threadIdx.x < kBallRows) {
      const int r = threadIdx.x;
      int cq = -1, p = 0;
      float ox = 0.f, oy = 0.f, oz = 0.f;
      if (r < rows) {
        const int at = (head + r) & (kQueueCap - 1);
        cq = qc[at];
        p = qp[at];
        const float* pt = xyz + (size_t)p * 3;
        const float* c = new_xyz + (size_t)cq * 3;
        ox = __fsub_rn(pt[0], c[0]);
        oy = __fsub_rn(pt[1], c[1]);
        oz = __fsub_rn(pt[2], c[2]);
      }
      row_c[r] = cq;
      row_p[r] = p;
      offs[3 * r] = ox;
      offs[3 * r + 1] = oy;
      offs[3 * r + 2] = oz;
    }
    head = (head + rows) & (kQueueCap - 1);
    qlen -= rows;
    __syncthreads();
    // layer 1: relu(((offset @ A1x) + b1) + uf[p]); a thread keeps its four columns
#pragma unroll 2
    for (int r = threadIdx.x / (C1 / 4); r < kBallRows; r += kThreads / (C1 / 4)) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row_c[r] >= 0) {
        const float ox = offs[3 * r], oy = offs[3 * r + 1], oz = offs[3 * r + 2];
        v.x = __fadd_rn(fmaf(oz, w1z.x, fmaf(oy, w1y.x, __fmul_rn(ox, w1x.x))), w1b.x);
        v.y = __fadd_rn(fmaf(oz, w1z.y, fmaf(oy, w1y.y, __fmul_rn(ox, w1x.y))), w1b.y);
        v.z = __fadd_rn(fmaf(oz, w1z.z, fmaf(oy, w1y.z, __fmul_rn(ox, w1x.z))), w1b.z);
        v.w = __fadd_rn(fmaf(oz, w1z.w, fmaf(oy, w1y.w, __fmul_rn(ox, w1x.w))), w1b.w);
        if (HAS_UF) {
          const float4 u = __ldg(
              reinterpret_cast<const float4*>(uf + (size_t)row_p[r] * C1 + c1));
          v.x = __fadd_rn(v.x, u.x);
          v.y = __fadd_rn(v.y, u.y);
          v.z = __fadd_rn(v.z, u.z);
          v.w = __fadd_rn(v.w, u.w);
        }
        v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      }
      *reinterpret_cast<float4*>(h1 + r * (C1 + 4) + c1) = v;
    }
    __syncthreads();
    switch ((C2 / 32) * 16 + C3 / 32) {
      case 1 * 16 + 2:
        ball_layers23<1, 2, PREC>(h1, h2, C1, C2, C3, wr, b2, b3, row_c, out);
        break;
      case 2 * 16 + 4:
        ball_layers23<2, 4, PREC>(h1, h2, C1, C2, C3, wr, b2, b3, row_c, out);
        break;
      case 3 * 16 + 4:
        ball_layers23<3, 4, PREC>(h1, h2, C1, C2, C3, wr, b2, b3, row_c, out);
        break;
      default:
        ball_layers23<4, 8, PREC>(h1, h2, C1, C2, C3, wr, b2, b3, row_c, out);
        break;
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------- iq_knn_density
// Replaces knn_with_density -> _knn_den_kernel (ops/pallas/groups.py:290-364).
//
// What bounds it on H100: at SA1 the selection's operations, 2 C + 3 a
// distance, at SA2 the bytes of its outputs: 0.114 ms a PointConv forward
// over the distinct centres (67 TFLOP/s, 3.35 TB/s).  Two routes,
// chosen by shape alone as iq_knn's (knn_route): the xyz route
// (knn_density_xyz_kernel, the selection of knn_xyz.cuh) and the tiled one
// (knn_density_kernel, select_knn itself), each templated on the list
// length (k = 32 at PointConv SA1, 64 at SA2), so the indices are those of
// iq_knn bit for bit.  A warp per query then reads its neighbours' inverse
// densities from device memory and reduces their max.  kKeyed: the packed
// or bf16 class.
template <int KL, bool kKeyed>
__global__ void __launch_bounds__(kSelThreads, KL == 1 ? 2 : 1)
knn_density_kernel(const float* __restrict__ query, const float* __restrict__ db,
                   const float* __restrict__ invden, int32_t* __restrict__ oidx,
                   float* __restrict__ oden, float* __restrict__ odmax, int S, int N,
                   int C, int k, int nqb, SelectKey key) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kQueries;
  const int* li = select_knn<KL, kKeyed>(query + (size_t)b * S * C, nullptr,
                                         db + (size_t)b * N * C, S, N, C, k, q0, key, smem);
  const float* iv = invden + (size_t)b * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = min(kQueries, S - q0);
  for (int r = warp; r < nq; r += kSelThreads / 32) {
    const size_t o = ((size_t)b * S + q0 + r) * k;
    float mx = -CUDART_INF_F;
    for (int i = lane; i < k; i += 32) {
      const int j = li[r * KL * 32 + i];
      const float v = __ldg(iv + j);
      oidx[o + i] = j;
      oden[o + i] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    if (lane == 0) odmax[(size_t)b * S + q0 + r] = mx;
  }
}

// The xyz route: a block stages one cloud's database and runs kXyzQueries
// of its distinct query rows, a warp each (knn_xyz.cuh); FPS repeats a
// centre once a masked cloud has fewer distinct points than centres, and a
// copy takes its original's result (copy_duplicate_rows).  rows == nullptr:
// every query row, in order.
template <int KL, int M, int NPL, bool kKeyed>
__global__ void __launch_bounds__(kXyzThreads, 4)
knn_density_xyz_kernel(const float* __restrict__ query, const float* __restrict__ db,
                       const float* __restrict__ invden, const int* __restrict__ rows,
                       const int* __restrict__ nrows, int32_t* __restrict__ oidx,
                       float* __restrict__ oden, float* __restrict__ odmax, int S, int N,
                       int C, int k, int nqb, SelectKey key) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - b * nqb) * kXyzQueries;
  const int ns = rows ? nrows[b] : S;         // distinct query rows of this cloud
  if (q0 >= ns) return;
  float* buffers;
  const XyzCloud cl = xyz_stage(db + (size_t)b * N * C, N, C, key, smem, &buffers);
  const float* iv = invden + (size_t)b * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qend = min(q0 + kXyzQueries, ns);
  for (int r = q0 + warp; r < qend; r += kXyzWarps) {
    const size_t row = (size_t)b * S + (rows ? rows[(size_t)b * S + r] : r);
    float vd[KL];
    int vi[KL];
    xyz_select<KL, M, NPL, kKeyed>(cl, query + row * C, k, buffers + warp * 2 * kXyzBuffer,
                                   lane, vd, vi);
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < KL; ++s) {
      const int e = 32 * s + lane;
      if (e < k) {
        const float v = __ldg(iv + vi[s]);
        oidx[row * k + e] = vi[s];
        oden[row * k + e] = v;
        mx = fmaxf(mx, v);
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    if (lane == 0) odmax[row] = mx;
  }
}

// The instance of knn_density_xyz_kernel for (N, k, class): the list's
// registers a lane (k <= 32: 1, else 2), the keys a lane hands the first
// list, the candidates it keeps in registers, and whether the distances
// become keys (the packed and bf16 classes).
using KnnDensityXyz = void (*)(const float*, const float*, const float*, const int*,
                               const int*, int32_t*, float*, float*, int, int, int, int, int,
                               SelectKey);
template <bool kKeyed>
inline KnnDensityXyz knn_density_xyz_instance(int N, int k) {
  const bool small = xyz_small(N);
  if (k > 32)
    return small ? knn_density_xyz_kernel<2, 2, 16, kKeyed>
                 : knn_density_xyz_kernel<2, 2, 32, kKeyed>;
  if (xyz_deep(k))
    return small ? knn_density_xyz_kernel<1, 2, 16, kKeyed>
                 : knn_density_xyz_kernel<1, 2, 32, kKeyed>;
  return small ? knn_density_xyz_kernel<1, 1, 16, kKeyed>
               : knn_density_xyz_kernel<1, 1, 32, kKeyed>;
}
inline KnnDensityXyz knn_density_xyz_launcher(int N, int k, int sel) {
  return sel == kSelExact ? knn_density_xyz_instance<false>(N, k)
                          : knn_density_xyz_instance<true>(N, k);
}

// --------------------------------------------------------- iq_pointconv_sa
// Replaces fused_pointconv_sa -> _pconv_kernel (ops/pallas/groups.py:367-501).
//
// What bounds it on H100: operations.  Per neighbour, layers 2 and 3 cost
// 2*(C1*C2 + C2*C3) FLOP and the contraction 2*16*C3: 2.0 and 0.2 TFLOP for
// one PointConv forward of 1650 clouds.  Both run on the tensor cores in the
// three-product TF32 split of iq_ball_mlp3 (f32 accuracy; see there), the
// layers through the same code: order_weights_kernel, WeightRing, mma_layer,
// mlp_layers23.  The output, (B, S, C3*16), is 10.4 GB a forward, three
// milliseconds of writes.
//
// The design.  Blocks are persistent (one per SM; the weights are resident in
// shared memory where both layers fit, as SA1's 48 KB, and stream through
// the ring otherwise, as SA2's 192 KB) and walk over tiles of kBallRows = 128
// rows: G = 128 / K whole centres of one cloud (4 at K = 32, 2 at K = 64).
// Every slot is a real neighbour and K is fixed, so a tile's rows belong to
// its own centres: no row queue, no search for copies (the contraction is a
// sum over the neighbours, so a copy counts) and no atomics.  A tile goes
// through four phases, each on all 256 threads:
//   front     two threads a row: index, density scale, the exact f32 offset,
//             and half of WeightNet's 16 outputs each (wt, row stride 24);
//   layer 1   relu(u[p] - csw[q]) as float4 loads, eight rows in flight a
//             thread, each thread keeping its four columns, stored row-major
//             at stride C1 + 4 as mma_layer reads it;
//   layers    mlp_layers23, whose epilogue applies bias, ReLU and the row's
//             density scale and leaves h3 over h1/h2 at stride C3 + 8;
//   contract  out[q, c, 0..15] = sum_j h3[j, c] * wt[j, 0..15] per centre, as
//             a (C3 x K) (K x 16) product on the tensor cores in the same
//             split: a warp takes a centre and 64 channels (four 16 x 8 x 2
//             accumulator tiles), reads h3 transposed straight from the tile
//             (stride C3 + 8 and wt's 24 keep those loads free of bank
//             conflicts), and writes each channel's 16 outputs as float4s,
//             512 contiguous bytes a warp and store, in the reference's
//             C-major flattening.  (An f32 register loop, a thread per
//             centre and channel, was the slower of the two on an H100;
//             PERF.md has both times.)
// The next tile's indices and density scales are fetched with cp.async while
// the products run.
constexpr int kWtStride = 24;               // row stride of the WeightNet outputs
constexpr int kL1Batch = 8;                 // rows a thread gathers at once in layer 1
// floats of shared memory beside the activations and the weight ring: wt,
// WeightNet's weights (padded to 16 bytes), row scale, row point, and the
// next tile's (index, scale)
constexpr int kWnetPadded = (kWnetFloats + 3) & ~3;
constexpr int kPconvFixedFloats = kBallRows * kWtStride + kWnetPadded + 4 * kBallRows;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Is packed WeightNet float e a weight (not a bias)?  wn packs (w1, f1, w2,
// f2, w3, f3): the weights are rounded for a one-pass precision when staged.
__device__ __forceinline__ bool wnet_weight(int e) {
  constexpr int f1 = 3 * kWH, w2 = f1 + kWH, f2 = w2 + kWH * kWH, w3 = f2 + kWH,
                f3 = w3 + kWH * kWO;
  return e < f1 || (e >= w2 && e < f2) || (e >= w3 && e < f3);
}

// Half of WeightNet 3 -> 8 -> 8 -> 16 (BN folded, ReLU after every layer) on
// one neighbour's exact f32 offset: outputs o0 .. o0 + 7 (o0 = 0 or 8).  wn
// packs (w1, f1, w2, f2, w3, f3) with each w as (in, out) row-major, on a
// 16-byte boundary in shared memory; every row there is 8 or 16 floats.
// At a one-pass precision PREC the weights in wn are rounded for it and
// each layer's input is rounded here: every product is exact in f32 and the
// sums are f32, the TPU's one-pass product on the f32 units.
template <int PREC>
__device__ __forceinline__ void weightnet_half(const float (&off)[3], const float* wn,
                                               int o0, float (&o)[kWO / 2]) {
  static_assert(kWH == 8 && kWO == 16, "rows are read as two float4s");
  const float* w1 = wn;
  const float* f1 = w1 + 3 * kWH;
  const float* w2 = f1 + kWH;
  const float* f2 = w2 + kWH * kWH;
  const float* w3 = f2 + kWH;
  const float* f3 = w3 + kWH * kWO;
  float h[kWH], g[kWH], w[8], x[8], y[8];
  load8(w1, w);
  load8(w1 + kWH, x);
  load8(w1 + 2 * kWH, y);
  const float r0 = round_operand(PREC, off[0]), r1 = round_operand(PREC, off[1]),
              r2 = round_operand(PREC, off[2]);
#pragma unroll
  for (int n = 0; n < kWH; ++n) h[n] = fmaf(r2, y[n], fmaf(r1, x[n], __fmul_rn(r0, w[n])));
  load8(f1, w);
#pragma unroll
  for (int n = 0; n < kWH; ++n) h[n] = round_operand(PREC, fmaxf(__fadd_rn(h[n], w[n]), 0.f));
#pragma unroll
  for (int n = 0; n < kWH; ++n) g[n] = 0.f;
#pragma unroll
  for (int i = 0; i < kWH; ++i) {
    load8(w2 + i * kWH, w);
#pragma unroll
    for (int n = 0; n < kWH; ++n) g[n] = fmaf(h[i], w[n], g[n]);
  }
  load8(f2, w);
#pragma unroll
  for (int n = 0; n < kWH; ++n) g[n] = round_operand(PREC, fmaxf(__fadd_rn(g[n], w[n]), 0.f));
#pragma unroll
  for (int n = 0; n < kWO / 2; ++n) o[n] = 0.f;
#pragma unroll
  for (int i = 0; i < kWH; ++i) {
    load8(w3 + i * kWO + o0, w);
#pragma unroll
    for (int n = 0; n < kWO / 2; ++n) o[n] = fmaf(g[i], w[n], o[n]);
  }
  load8(f3 + o0, w);
#pragma unroll
  for (int n = 0; n < kWO / 2; ++n) o[n] = fmaxf(__fadd_rn(o[n], w[n]), 0.f);
}

// The contraction of one tile on the tensor cores.  A unit is (centre q, 64
// channels): out[q, c, w] = sum_j h3[q*K + j, c] * wt[q*K + j, w] as an
// m16n8k8 product with A = h3^T (row c, k = j), B = wt (k = j, n = w); a
// k-step beyond K is filled with zeros.  out_tile points at out[b, s0, 0].
__device__ __forceinline__ void contract_mma(const float* h3, int xs3, const float* wt,
                                             float* __restrict__ out_tile, int nc, int K,
                                             int C3) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = C3 / 64;
  for (int unit = warp; unit < nc * groups; unit += kThreads / 32) {
    const int q = unit / groups, c0 = (unit - q * groups) * 64;
    float acc[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    const float* hq = h3 + q * K * xs3 + c0 + g;
    const float* wq = wt + q * K * kWtStride + g;
    for (int j0 = 0; j0 < K; j0 += 8) {
      const bool in0 = j0 + t < K, in1 = j0 + t + 4 < K;
      const float* w0 = wq + (j0 + t) * kWtStride;
      const float* hr = hq + (j0 + t) * xs3;
      float bh[2][2], bl[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float x0 = in0 ? w0[nt * 8] : 0.f;
        const float x1 = in1 ? w0[4 * kWtStride + nt * 8] : 0.f;
        bh[nt][0] = tf32_hi(x0);
        bh[nt][1] = tf32_hi(x1);
        bl[nt][0] = tf32_lo(x0, bh[nt][0]);
        bl[nt][1] = tf32_lo(x1, bh[nt][1]);
      }
      float ahi[4][4], alo[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float v[4] = {in0 ? hr[mt * 16] : 0.f, in0 ? hr[mt * 16 + 8] : 0.f,
                            in1 ? hr[4 * xs3 + mt * 16] : 0.f,
                            in1 ? hr[4 * xs3 + mt * 16 + 8] : 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ahi[mt][i] = tf32_hi(v[i]);
          alo[mt][i] = tf32_lo(v[i], ahi[mt][i]);
        }
      }
      // pass by pass: 8 independent accumulators between two products into
      // the same one
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_tf32(acc[mt][nt], alo[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_tf32(acc[mt][nt], ahi[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_tf32(acc[mt][nt], ahi[mt], bh[nt][0], bh[nt][1]);
    }
    // A thread holds w = 2t, 2t+1 of both column tiles.  Neighbouring lanes
    // swap a pair, so that an even lane stores w = 2t .. 2t+3 and an odd one
    // w = 8 + 2(t-1) .. 8 + 2(t-1) + 3: one float4 each, a channel's 64 bytes
    // per four lanes.
    const bool odd = t & 1;
    float* oq = out_tile + ((size_t)q * C3 + c0 + g) * kWO + (odd ? 8 + 2 * (t - 1) : 2 * t);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float a0 = acc[mt][0][2 * hf], a1 = acc[mt][0][2 * hf + 1];
        const float b0 = acc[mt][1][2 * hf], b1 = acc[mt][1][2 * hf + 1];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        *reinterpret_cast<float4*>(oq + (mt * 16 + 8 * hf) * kWO) =
            odd ? make_float4(r0, r1, b0, b1) : make_float4(a0, a1, r0, r1);
      }
  }
}

// Layers 2 and 3 of one tile and iq_pointconv_sa's epilogue.
template <int NT2, int NT3, int PREC>
__device__ __forceinline__ void pconv_layers_contract(const float* h1, float* h2, int C1,
                                                      int C2, int C3, WeightRing& wr,
                                                      const float* __restrict__ b2,
                                                      const float* __restrict__ b3,
                                                      const float* dsr, const float* wt,
                                                      float* __restrict__ out_tile, int nc,
                                                      int K) {
  const float* h3 =
      mlp_layers23<NT2, NT3, true, PREC>(h1, h2, C1, C2, C3, C3 + 8, wr, b2, b3, dsr);
  contract_mma(h3, C3 + 8, wt, out_tile, nc, K, C3);
}

template <int PREC>
__global__ void __launch_bounds__(kThreads, 1)
pointconv_sa_kernel(const int32_t* __restrict__ idx, const float* __restrict__ ds,
                    const float* __restrict__ new_xyz, const float* __restrict__ u,
                    const float* __restrict__ xyz, const float* __restrict__ csw,
                    const float* __restrict__ wfrag, const float* __restrict__ b2,
                    const float* __restrict__ b3, const float* __restrict__ wnet,
                    float* __restrict__ out, int B, int S, int N, int K, int C1, int C2,
                    int C3, int G, int nqb, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  float* h1 = smem;                                       // [kBallRows][C1 + 4]
  float* h2 = h1 + kBallRows * (C1 + 4);                  // [kBallRows][C2 + 4]
  float* ring = h2 + kBallRows * (C2 + 4);                // [nbuf][kSlabFloats]
  float* wt = ring + nbuf * kSlabFloats;                  // [kBallRows][kWtStride]
  float* wn = wt + kBallRows * kWtStride;                 // [kWnetPadded]
  float* dsr = wn + kWnetPadded;                          // [kBallRows] row scale
  int* row_p = reinterpret_cast<int*>(dsr + kBallRows);   // [kBallRows] row point
  int* next_p = row_p + kBallRows;                        // [kBallRows] next tile's
  float* next_d = reinterpret_cast<float*>(next_p + kBallRows);

  const int total = B * nqb;
  // rows of a tile (whole centres), its cloud and first centre
  auto tile_rows = [&](int tile, int& b, int& s0) {
    b = tile / nqb;
    s0 = (tile - b * nqb) * G;
    return min(G, S - s0) * K;
  };
  // start fetching a tile's indices and scales: one commit group, made also
  // when there is no such tile, so that every thread counts the same groups
  auto fetch = [&](int tile) {
    if (tile < total) {
      int b, s0;
      const int rows = tile_rows(tile, b, s0);
      const size_t at = ((size_t)b * S + s0) * K;
      const int r = (int)threadIdx.x - kBallRows;     // the second half fetches scales
      if (r < 0 && r + kBallRows < rows) cp_async4(next_p + r + kBallRows, idx + at + r + kBallRows);
      if (r >= 0 && r < rows) cp_async4(next_d + r, ds + at + r);
    }
    cp_async_commit();
  };
  fetch(blockIdx.x);                    // before the ring's first slabs

  WeightRing wr;
  wr.frag = wfrag;
  wr.ring = ring;
  wr.n2 = (C1 / 8) / slab_ksteps(C1, C2);
  wr.s2 = slab_ksteps(C1, C2) * C2 * 8;
  wr.n3 = (C2 / 8) / slab_ksteps(C2, C3);
  wr.s3 = slab_ksteps(C2, C3) * C3 * 8;
  wr.nbuf = nbuf;
  wr.start();
  for (int e = threadIdx.x; e < kWnetFloats; e += kThreads)
    wn[e] = wnet_weight(e) ? round_operand(PREC, wnet[e]) : wnet[e];

  // layer 1's four columns of this thread (C1 / 4 divides kThreads) and its rows
  const int c1 = (threadIdx.x % (C1 / 4)) * 4;
  const int j1 = threadIdx.x / (C1 / 4), jstep = kThreads / (C1 / 4);
  const int kinv = 65536 / K + 1;       // r / K == (r * kinv) >> 16 for r < 128

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int b, s0;
    const int rows = tile_rows(tile, b, s0);
    const int nc = rows / K;
    // The tile's fetch is older than the kAhead slabs a streaming ring keeps
    // in flight (a tile's layers commit more slabs than that after it), so
    // this does not wait for the stream; a resident ring has nothing in flight.
    if (wr.resident())
      cp_async_wait<0>();
    else
      cp_async_wait<kAhead>();
    __syncthreads();    // the fetch is visible; everyone is done with wt and h3

    // front: two threads a row
    {
      const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
      float o[kWO / 2];
      int p = 0;
      float d = 0.f;
      if (r < rows) {
        p = next_p[r];
        d = next_d[r];
        const int q = (r * kinv) >> 16;
        const float* c = new_xyz + ((size_t)b * S + s0 + q) * 3;
        const float* pt = xyz + ((size_t)b * N + p) * 3;
        const float off[3] = {__fsub_rn(pt[0], c[0]), __fsub_rn(pt[1], c[1]),
                              __fsub_rn(pt[2], c[2])};
        weightnet_half<PREC>(off, wn, half * (kWO / 2), o);
      } else {
#pragma unroll
        for (int w = 0; w < kWO / 2; ++w) o[w] = 0.f;
      }
      if (half == 0) {
        row_p[r] = p;
        dsr[r] = d;
      }
      float4* dst = reinterpret_cast<float4*>(wt + r * kWtStride + half * (kWO / 2));
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();
    fetch(tile + gridDim.x);            // lands while the products run
    // layer 1: relu(u[p] - csw[q]), kL1Batch rows in flight; rows beyond the
    // tile's are zero
    for (int r0 = j1; r0 < kBallRows; r0 += kL1Batch * jstep) {
      float4 uu[kL1Batch], cs[kL1Batch];
#pragma unroll
      for (int i = 0; i < kL1Batch; ++i) {
        const int r = r0 + i * jstep;
        uu[i] = cs[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows) {
          const int q = (r * kinv) >> 16;
          uu[i] = __ldg(
              reinterpret_cast<const float4*>(u + ((size_t)b * N + row_p[r]) * C1 + c1));
          cs[i] = __ldg(
              reinterpret_cast<const float4*>(csw + ((size_t)b * S + s0 + q) * C1 + c1));
        }
      }
#pragma unroll
      for (int i = 0; i < kL1Batch; ++i) {
        const int r = r0 + i * jstep;
        if (r < kBallRows)
          *reinterpret_cast<float4*>(h1 + r * (C1 + 4) + c1) = make_float4(
              fmaxf(__fsub_rn(uu[i].x, cs[i].x), 0.f), fmaxf(__fsub_rn(uu[i].y, cs[i].y), 0.f),
              fmaxf(__fsub_rn(uu[i].z, cs[i].z), 0.f), fmaxf(__fsub_rn(uu[i].w, cs[i].w), 0.f));
      }
    }
    __syncthreads();
    float* out_tile = out + ((size_t)b * S + s0) * C3 * kWO;
    switch ((C2 / 32) * 16 + C3 / 32) {
      case 1 * 16 + 2:
        pconv_layers_contract<1, 2, PREC>(h1, h2, C1, C2, C3, wr, b2, b3, dsr, wt, out_tile, nc,
                                         K);
        break;
      case 2 * 16 + 4:
        pconv_layers_contract<2, 4, PREC>(h1, h2, C1, C2, C3, wr, b2, b3, dsr, wt, out_tile, nc,
                                         K);
        break;
      case 3 * 16 + 4:
        pconv_layers_contract<3, 4, PREC>(h1, h2, C1, C2, C3, wr, b2, b3, dsr, wt, out_tile, nc,
                                         K);
        break;
      default:
        pconv_layers_contract<4, 8, PREC>(h1, h2, C1, C2, C3, wr, b2, b3, dsr, wt, out_tile, nc,
                                         K);
        break;
    }
  }
  cp_async_wait<0>();
}

// A loaded unit of values as f32 output: f32 as it is, bf16 bits widened
// exactly (a bf16 is the high half of an f32); uint2 holds four bf16.
using bf16_bits = unsigned short;
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) { return __uint_as_float((unsigned)v << 16); }
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// out[b, r, :] = values[b, idx[b, r], :] over the R = S * K rows of each
// cloud; T is a unit of four values where F % 4 == 0 (float4 of f32, uint2
// of bf16; FT = F / 4), else one value (FT = F), and O the matching f32
// unit.  A pure copy, so bound by bytes: the output, K times the values,
// dominates.  The TPU kernel gathered by one-hot matmuls against bf16
// planes with F padded to 128; here each row is copied directly, exact f32
// or, at the bf16 gather precision, the bf16 values the caller rounded,
// widened to f32 (the TPU's one-plane result).  The tx threads of a row (a
// power of two up to 32, inside one warp) walk it along F, so a warp's
// stores are contiguous; the row's first thread reads its index once and
// shuffles it to the others.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ values, const int32_t* __restrict__ idx,
                   O* __restrict__ out, int N, long long R, long long rows, int FT) {
  const int tx = blockDim.x;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  int src = 0;
  if (live && threadIdx.x == 0) src = __ldg(idx + row);
  src = __shfl_sync(0xffffffffu, src, 0, tx);   // every lane of the warp takes part
  if (!live) return;
  const T* in = values + ((size_t)(row / R) * N + src) * FT;
  O* o = out + (size_t)row * FT;
  for (int c = threadIdx.x; c < FT; c += tx) o[c] = widen(__ldg(in + c));
}

}  // namespace

extern "C" {

// scratch: 4 + C1*C2 + C2*C3 floats of device memory on a 16-byte boundary
// (the batch counter, then both layers' weights in fragment order), and
// without uf B*N more (each point's first copy).  rows_count: nullptr, or a
// 64-bit counter to which each batch of centres adds the rows it queues
// for layers 2-3 (one atomicAdd a batch).  prec: the matmul precision of
// layers 2-3 (kPrecHighest, kPrecHigh or kPrecDefault).
int iq_ball_mlp3(const float* new_xyz, const float* xyz, const float* uf, const float* b1,
                 const float* a1x, const float* a2, const float* b2, const float* a3,
                 const float* b3, float* out, float* scratch, unsigned long long* rows_count,
                 int B, int S, int N, int K, int C1, int C2, int C3, float r2, int prec,
                 void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  const int widths = (C2 / 32) * 16 + C3 / 32;
  if (prec < kPrecHighest || prec > kPrecDefault) return cudaErrorInvalidValue;
  if (N < 1 || K < 1 || K > kMaxBatchRows || C1 < 8 || kThreads % C1 || C2 % 32 ||
      C3 % 32 || C1 + C2 + 4 < C3 ||
      (widths != 1 * 16 + 2 && widths != 2 * 16 + 4 && widths != 3 * 16 + 4 &&
       widths != 4 * 16 + 8) ||
      (long long)B * S > 0x7fffffffLL || (long long)B * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int CB = min(kMaxBatch, kMaxBatchRows / K);
  const int nslabs = (C1 / 8) / slab_ksteps(C1, C2) + (C2 / 8) / slab_ksteps(C2, C3);
  const int fixed = kBallFixedFloats + kBallRows * (C1 + 4) + kBallRows * (C2 + 4);
  const int room = (kMaxSmem / 4 - fixed) / kSlabFloats;
  const int nbuf = nslabs <= room ? nslabs : kAhead + 1;
  if (nbuf > room) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)fixed + (size_t)nbuf * kSlabFloats) * sizeof(float);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(out, 0, (size_t)B * S * C3 * sizeof(float), s)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(scratch, 0, 4 * sizeof(float), s)) != cudaSuccess) return err;
  int* counter = reinterpret_cast<int*>(scratch);
  float* frag2 = scratch + 4;
  float* frag3 = frag2 + C1 * C2;
  int* first_copy = reinterpret_cast<int*>(frag3 + C2 * C3);
  if (uf == nullptr)
    first_copy_kernel<<<(unsigned)B, kThreads, 0, s>>>(xyz, first_copy, N);
  order_weights_kernel<<<(C1 * C2 / 2 + 255) / 256, 256, 0, s>>>(
      a2, C1, C2, reinterpret_cast<float2*>(frag2), prec);
  order_weights_kernel<<<(C2 * C3 / 2 + 255) / 256, 256, 0, s>>>(
      a3, C2, C3, reinterpret_cast<float2*>(frag3), prec);
  const long long units = (long long)B * ((S + CB - 1) / CB);
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  using Kernel = decltype(&ball_mlp3_kernel<true, kPrecHighest>);
  static const Kernel kernels[2][3] = {
      {ball_mlp3_kernel<false, kPrecHighest>, ball_mlp3_kernel<false, kPrecHigh>,
       ball_mlp3_kernel<false, kPrecDefault>},
      {ball_mlp3_kernel<true, kPrecHighest>, ball_mlp3_kernel<true, kPrecHigh>,
       ball_mlp3_kernel<true, kPrecDefault>}};
  const Kernel kernel = kernels[uf != nullptr][prec];
  if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(new_xyz, xyz, uf, b1, a1x, frag2, b2, b3, out, counter,
                                      rows_count, uf != nullptr ? nullptr : first_copy, B, S,
                                      N, K, C1, C2, C3, r2, CB, nbuf);
  return cudaGetLastError();
}

// route: 0 chooses by shape (knn_route), kXyzRoute or kTiledRoute forces
// one (a forced xyz route on a shape it does not take is refused).
// scratch: B * (2 * S + 1) ints of device memory (see DistinctRows), with
// which the xyz route selects for the distinct query rows only; nullptr
// (or S > kMaxDistinctRows): for every row.  sel: the selection class,
// kSelExact, kSelPacked or kSelBf16 (knn_select.cuh).
int iq_knn_density(const float* query, const float* db, const float* invden, int32_t* idx,
                   float* den, float* dmax, int* scratch, int B, int S, int N, int C, int k,
                   int route, int sel, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxDensityK || k > N || C < 1 || route < 0 || route > kTiledRoute ||
      !select_key_valid(sel))
    return cudaErrorInvalidValue;
  const SelectKey key = select_key_for(sel, N);
  if (route == 0) route = knn_route(N, C);
  if (route == kXyzRoute && !xyz_fits(N, C)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == kXyzRoute) {
    const size_t smem = xyz_smem_bytes(N, C);
    const int nqb = (S + kXyzQueries - 1) / kXyzQueries;
    const bool distinct = scratch != nullptr && S <= kMaxDistinctRows;
    const DistinctRows d(scratch, B, S);
    if (distinct && (err = distinct_rows(query, d, B, S, C, s)) != cudaSuccess) return err;
    const KnnDensityXyz kernel = knn_density_xyz_launcher(N, k, sel);
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<(unsigned)B * nqb, kXyzThreads, smem, s>>>(
        query, db, invden, distinct ? d.rows : nullptr, distinct ? d.nrows : nullptr, idx, den,
        dmax, S, N, C, k, nqb, key);
    if ((err = cudaGetLastError()) != cudaSuccess || !distinct) return err;
    if ((err = copy_duplicate_rows(d, reinterpret_cast<float*>(idx), den, B, S, k, s)) !=
        cudaSuccess)
      return err;
    return copy_duplicate_rows(d, dmax, nullptr, B, S, 1, s);
  }
  const int nqb = (S + kQueries - 1) / kQueries;
  const dim3 grid((unsigned)B * nqb);
  const bool keyed = sel != kSelExact;
  const auto kernel =
      k <= 32 ? (keyed ? knn_density_kernel<1, true> : knn_density_kernel<1, false>)
              : (keyed ? knn_density_kernel<2, true> : knn_density_kernel<2, false>);
  const size_t smem = select_smem_floats(k <= 32 ? 1 : 2) * sizeof(float);
  if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
  kernel<<<grid, kSelThreads, smem, s>>>(query, db, invden, idx, den, dmax, S, N, C, k, nqb,
                                         key);
  return cudaGetLastError();
}

// The route iq_knn_density takes for (N, C, k), for the record (it
// launches nothing): info as iq_knn_route's.
int iq_knn_density_route(int N, int C, int k, int* info) {
  if (k < 1 || k > kMaxDensityK || k > N || C < 1) return cudaErrorInvalidValue;
  info[0] = knn_route(N, C);
  if (info[0] == kXyzRoute)
    return kernel_info(knn_density_xyz_launcher(N, k, kSelExact), kXyzThreads,
                       xyz_smem_bytes(N, C), info);
  return k <= 32 ? kernel_info(knn_density_kernel<1, false>, kSelThreads,
                               select_smem_floats(1) * sizeof(float), info)
                 : kernel_info(knn_density_kernel<2, false>, kSelThreads,
                               select_smem_floats(2) * sizeof(float), info);
}

// scratch: C1*C2 + C2*C3 floats of device memory on a 16-byte boundary (both
// layers' weights in fragment order).  u and csw rows are read as float4s.
// prec: the matmul precision of layers 2-3 and WeightNet (kPrecHighest,
// kPrecHigh or kPrecDefault); the contraction keeps three products.
int iq_pointconv_sa(const int32_t* idx, const float* ds, const float* new_xyz,
                    const float* u, const float* xyz, const float* csw, const float* a2,
                    const float* b2, const float* a3, const float* b3, const float* wnet,
                    float* out, float* scratch, int B, int S, int N, int K, int C1, int C2,
                    int C3, int prec, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (prec < kPrecHighest || prec > kPrecDefault) return cudaErrorInvalidValue;
  const int widths = (C2 / 32) * 16 + C3 / 32;
  if (N < 1 || K < 1 || K > kMaxPconvK || C1 < 8 || kThreads % C1 || C2 % 32 || C3 % 32 ||
      C1 + C2 < C3 ||
      (widths != 1 * 16 + 2 && widths != 2 * 16 + 4 && widths != 3 * 16 + 4 &&
       widths != 4 * 16 + 8) ||
      (long long)B * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int G = kBallRows / K;
  const int nqb = (S + G - 1) / G;
  const int nslabs = (C1 / 8) / slab_ksteps(C1, C2) + (C2 / 8) / slab_ksteps(C2, C3);
  const int fixed = kPconvFixedFloats + kBallRows * (C1 + 4) + kBallRows * (C2 + 4);
  const int room = (kMaxSmem / 4 - fixed) / kSlabFloats;
  const int nbuf = nslabs <= room ? nslabs : kAhead + 1;
  if (nbuf > room) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)fixed + (size_t)nbuf * kSlabFloats) * sizeof(float);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  float* frag2 = scratch;
  float* frag3 = frag2 + C1 * C2;
  order_weights_kernel<<<(C1 * C2 / 2 + 255) / 256, 256, 0, s>>>(
      a2, C1, C2, reinterpret_cast<float2*>(frag2), prec);
  order_weights_kernel<<<(C2 * C3 / 2 + 255) / 256, 256, 0, s>>>(
      a3, C2, C3, reinterpret_cast<float2*>(frag3), prec);
  const long long tiles = (long long)B * nqb;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  using Kernel = decltype(&pointconv_sa_kernel<kPrecHighest>);
  static const Kernel kernels[3] = {pointconv_sa_kernel<kPrecHighest>,
                                    pointconv_sa_kernel<kPrecHigh>,
                                    pointconv_sa_kernel<kPrecDefault>};
  const Kernel kernel = kernels[prec];
  if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(idx, ds, new_xyz, u, xyz, csw, frag2, b2, b3, wnet, out,
                                      B, S, N, K, C1, C2, C3, G, nqb, nbuf);
  return cudaGetLastError();
}

// bf16 != 0: values holds bf16 values (B * N * F of 2 bytes), else f32.
int iq_gather_rows(const void* values, const int32_t* idx, float* out, int B, int N, int R,
                   int F, int bf16, void* stream) {
  if (B <= 0 || R <= 0) return cudaSuccess;
  if (N < 1 || F < 1) return cudaErrorInvalidValue;
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(values) % (bf16 ? 8 : 16) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int FT = vec ? F / 4 : F;
  int tx = 1;
  while (tx < FT && tx < 32) tx <<= 1;
  const dim3 block(tx, kThreads / tx);
  const long long rows = (long long)B * R;
  const long long nblocks = (rows + block.y - 1) / block.y;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* out4 = reinterpret_cast<float4*>(out);
  if (bf16 && vec) {
    gather_rows_kernel<<<(unsigned)nblocks, block, 0, s>>>(static_cast<const uint2*>(values),
                                                           idx, out4, N, R, rows, FT);
  } else if (bf16) {
    gather_rows_kernel<<<(unsigned)nblocks, block, 0, s>>>(
        static_cast<const bf16_bits*>(values), idx, out, N, R, rows, FT);
  } else if (vec) {
    gather_rows_kernel<<<(unsigned)nblocks, block, 0, s>>>(static_cast<const float4*>(values),
                                                           idx, out4, N, R, rows, FT);
  } else {
    gather_rows_kernel<<<(unsigned)nblocks, block, 0, s>>>(static_cast<const float*>(values),
                                                           idx, out, N, R, rows, FT);
  }
  return cudaGetLastError();
}

}  // extern "C"
