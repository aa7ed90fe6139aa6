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
// and iq_pointconv_sa run their layers 2 and 3 on the tensor cores, in the
// weights' fragment order of order_weights_kernel (the product's helpers,
// shared with dense.cu, in mma_tf32.cuh), at the matmul precision `prec` a
// template parameter: at kPrecHighest a three-product TF32 split that keeps
// f32 accuracy, at kPrecHigh one product of operands rounded to TF32, at
// kPrecDefault one product of operands rounded to bf16 (exact in TF32: one
// bf16 pass).  iq_pointconv_sa runs its phases in turn on all its warps
// (WeightRing, mma_layer, mlp_layers23); iq_ball_mlp3 is a warp-specialised
// pipeline with its own weight stream (K5Stream, k5_layer): a producer
// warpgroup runs its ball query and layer 1 beside the consumer
// warpgroups' products (see there).  Each brings its own front (a ball
// query, a gather of given neighbours) and its own epilogue (a max over
// the ball, a contraction over the neighbours).
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
// The weights.  order_weights_kernel writes both layers' weights once per
// launch, still whole f32 values, in the order the mma's B fragments are
// read: for every (k-step of 8, column tile of 8) 32 lanes x float2 (b0, b1),
// so a warp fetches a B fragment with one conflict-free 8-byte load per lane
// and splits it in registers (8 operations beside 12 mma).  Storing hi and
// lo apart would double the bytes, and the stream from L2 costs more than the
// split (PERF.md).  The stream is cut into slabs of at most 16 KB
// (slab_ksteps), layer 2's then layer 3's.
//
// The ball query.  One warp per centre scans the cloud in index order (128
// points a step, twelve loads in flight) and a ballot and a popcount per 32
// rank the in-ball points, so the first K land in their slots in order and
// the scan stops at K.  Slots beyond the in-ball count repeat slot 0 and
// cannot change the max, so only the filled slots become rows; without
// feature rows (SA1) neither can a slot whose point has the very coordinates
// of an earlier one (first_copy_kernel: about a third to a half of the slots
// of a masked batch), so it becomes no row either.  Membership uses the
// distance form of ops/geometry.square_distance, (|c|^2 - 2 c.p) + |p|^2,
// against r2 = f32(radius^2) with <=; the norms and the dot product are fmaf
// chains.  An empty ball takes index 0, as query_ball_point does.
//
// The design: a warp-specialised pipeline (ball_mlp3_kernel).  The ball
// query and layer 1 run on the CUDA cores and the load pipe, layers 2-3 on
// the tensor cores.  A block that ran them in turn, every warp on each
// phase with block-wide barriers between, left one side idle while the
// other worked (PERF.md).  So a persistent block (one per SM, 384 threads)
// runs them side by side in two roles:
//   producers one warpgroup, or two where a row's products are few
//             (C1 C2 + C2 C3 <= kK5TwoFrontsMacs: SA1 b0), setmaxnreg down
//             to k5_front_regs: they draw batches of centres of one cloud
//             from a global counter, run their ball queries (a warp per
//             centre), and write the batch's rows in order into a ring of h1
//             tiles of kK5Rows = 64 rows: layer 1, exact f32 offsets against
//             A1's three xyz rows plus the hoisted feature row, bias and
//             ReLU, and each row's centre;
//   consumers the other warpgroups (setmaxnreg up to kK5ConsumerRegs),
//             taking the tiles in turn: each of a group's four warps owns the
//             tile's 64 rows x a quarter of the layer's columns of both
//             products (A fragments split in registers; two column tiles at
//             a time, pass by pass, so that 8 independent accumulators lie
//             between two products into the same one), mma_layer's
//             instructions in its order.  Layer 2 reads the h1 tile, layer 3
//             the group's own h2.
// What bounds it now: the consumers' products and fold where layers 2-3
// are wide (SA1 b2, SA2 b1-b2: the producers finish a tile before it is
// wanted at all but 1-3% of tiles); the producers' ball query and layer 1
// elsewhere (k5_front_waits counts the tiles a consumer had to wait for).
// Hand-offs are mbarriers, never a block-wide barrier: a tile's full barrier
// (every producer thread arrives after its rows) and empty barrier (each
// warp of the consuming group arrives once its layer-2 products have read
// the tile, so the producers refill it while layer 3 runs); the producers'
// phases sync on a named barrier of their own, a consumer group's on one of
// its own (h2 written, h2 read).  Weights: a branch whose slabs fit beside
// two h1 tiles keeps them resident, copied once at the start by bulk copies
// (four of PointNet++'s six); otherwise kK5StreamBufs buffers hold a stream
// that every group reads once a round of tiles (the producers pad the tile
// count to whole rounds), and the last consumer warp done with a slab
// starts the bulk copy of the slab kK5StreamBufs ahead into its buffer,
// each buffer with a full barrier.  The max over the slots: a warp stages
// its layer-3 outputs (bias, ReLU) half its columns at a time in its
// quarter of the group's dead h2, a lane folds a float4 of columns down a
// stretch of rows, and the lanes of a column join the runs that cross
// their stretches by doubling, so each centre's run and column sends one
// atomicMax on the f32 bits to `out` (zeroed by the launcher; all kept
// values are > 0, where the order of the bits is the order of the floats).
//
// Shared memory (the launcher's k5_smem_bytes): h1 tiles of 64 x (C1 + 4)
// floats, an h2 of 64 x (C2 + 4) a consumer group, weight buffers of 16 KB,
// 11 KB of batch, row and barrier arrays.  The launcher gives the ring
// kK5MaxStages tiles where they fit, so at PointNet++'s widths, in bytes:
// SA1 b0 (32-32-64, two producers) 4 x 9,216 + 9,216 + 2 x 16 K resident =
// 90,712; SA1 b1 and SA2 b0 (64-64-128) 4 x 17,408 + 2 x 17,408 + 3 x 16 K
// resident = 165,464; SA1 b2 (64-96-128) 4 x 17,408 + 2 x 25,600 + 5 x 16 K
// resident = 214,616; SA2 b1 and b2 (128-128-256) 2 x 33,792 + 2 x 33,792 +
// 4 x 16 K streamed (12 slabs a round) = 212,056.
constexpr int kBallRows = 128;              // rows of a tile (iq_pointconv_sa)
constexpr int kSlabFloats = 4096;           // floats of one ring buffer (16 KB)
constexpr int kAhead = 3;                   // slabs in flight when streaming
constexpr int kMaxBatchRows = 1024;         // centres of a batch x K
constexpr int kMaxBatch = 32;               // centres of a batch

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

// ---------------------------------------- iq_ball_mlp3's pipeline pieces
constexpr int kK5Rows = 64;                 // rows of an h1 tile: one consumer group's
constexpr int kK5Threads = 384;             // three warpgroups: consumers, then producers
constexpr int kK5MaxConsumers = 2;          // consumer warpgroups (the rest produce)
// setmaxnreg by the producer warpgroups F: 128 (3 - F) x 216 + 128 F x
// k5_front_regs(F) = 384 x 168, the registers of the launch
constexpr int kK5ConsumerRegs = 216;
__host__ __device__ __forceinline__ constexpr int k5_front_regs(int fronts) {
  return fronts == 1 ? 72 : 144;
}
constexpr int kK5MaxStages = 4;             // h1 tiles in the ring
constexpr int kK5MaxBufs = 14;              // weight buffers of a resident branch
constexpr int kK5StreamBufs = kAhead + 1;   // weight buffers of a streamed branch
constexpr int kK5TwoFrontsMacs = 4096;      // C1 C2 + C2 C3 up to which two warpgroups produce
constexpr int kK5FrontBar = 1, kK5GroupBar = 2, kK5ConsumersBar = 2 + kK5MaxConsumers;
constexpr int kK5BarBytes = 256;            // full[4], empty[4], weights' full[14]
// ints of shared memory beside the barriers, weights, h1 and h2: the consumer
// warps' row centres, slots, batch rows, nball, first, unit, counts, done,
// tile_end (the tiles' row centres come with the tiles)
constexpr int kK5Ints = 4 * kK5MaxConsumers * kK5Rows + 2 * kMaxBatchRows + kMaxBatch +
                        (kMaxBatch + 1) + 1 + 2 + kK5MaxBufs + kK5MaxStages;

// Bytes of shared memory of a launch with `consumers` consumer groups,
// `stages` h1 tiles and `nbuf` weight buffers, in the order
// ball_mlp3_kernel lays them out.
__host__ __device__ __forceinline__ size_t k5_smem_bytes(int C1, int C2, int consumers,
                                                         int stages, int nbuf) {
  return kK5BarBytes + (size_t)nbuf * kSlabFloats * 4 +
         (size_t)stages * kK5Rows * (C1 + 4) * 4 + (size_t)consumers * kK5Rows * (C2 + 4) * 4 +
         ((size_t)stages * kK5Rows + kK5Ints) * 4;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// has the phase of this parity completed (without waiting)
__device__ __forceinline__ bool mbar_done(unsigned long long* bar, int parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// bytes of device memory into shared memory, completing on `bar` (one thread)
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Kernel 5's weight stream: layer 2's slabs, then layer 3's, read once a
// round of tiles (one a consumer group) by every consumer group, in nbuf
// buffers of kSlabFloats, each with a full barrier.  Resident (nbuf ==
// nsl): every slab copied once at the start.  Streamed: the last of the
// consumer warps done with slab g copies slab g + nbuf into its buffer.
// All fields are uniform.
struct K5Stream {
  const float* frag;           // device memory: layer 2's fragments, then layer 3's
  float* ring;                 // shared memory: the buffers
  unsigned long long* full;    // [nbuf] the buffer's slab has landed
  int* done;                   // [nbuf] consumer warps done with the buffer, all told
  int n2, s2, s3, nsl, nbuf;   // layer 2's slabs, floats a slab of each layer, slabs, buffers
  int warps;                   // consumer warps, each reading every slab

  __device__ __forceinline__ bool resident() const { return nsl == nbuf; }

  // start the copy of stream slab g into its buffer (one thread)
  __device__ __forceinline__ void copy(int g) const {
    const int j = g % nsl;
    const float* src = j < n2 ? frag + (size_t)j * s2
                              : frag + (size_t)n2 * s2 + (size_t)(j - n2) * s3;
    bulk_copy(ring + (g % nbuf) * kSlabFloats, src, 4 * (j < n2 ? s2 : s3), full + g % nbuf);
  }

  // stream slab g, landed
  __device__ __forceinline__ const float2* acquire(int g) const {
    mbar_wait(full + g % nbuf, resident() ? 0 : (g / nbuf) & 1);
    return reinterpret_cast<const float2*>(ring + (g % nbuf) * kSlabFloats);
  }

  // this warp has read slab g
  __device__ __forceinline__ void release(int g) const {
    if (resident()) return;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      __threadfence_block();
      if (atomicAdd(done + g % nbuf, 1) % warps == warps - 1) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        copy(g + nbuf);
      }
    }
  }

  // wait for the copies still in flight once `passes` rounds are done
  __device__ __forceinline__ void drain(int passes) const {
    const int g0 = resident() ? 0 : passes * nsl;
    for (int g = g0; g < g0 + nbuf; ++g) acquire(g);
  }
};

// Kernel 5's shared memory (ball_mlp3_kernel lays it out).
struct K5Smem {
  unsigned long long* full;    // [stages] an h1 tile is written
  unsigned long long* empty;   // [stages] its consumer group has read it
  float* h1;                   // [stages][kK5Rows][C1 + 4] layer 1
  int* tile_c;                 // [stages][kK5Rows] each row's centre b*S + s, -1: none
  int* tile_end;               // [stages] 1: no more tiles for the group
  float* h2;                   // [consumers][kK5Rows][C2 + 4]; then the fold's staging
  int* warp_c;                 // [4 consumers][kK5Rows] a consumer warp's copy of tile_c
  int* slots;                  // [kMaxBatchRows] the batch's ball members, [centre][K]
  int* row_q;                  // [kMaxBatchRows] the centre of each of the batch's rows
  int* nball;                  // [kMaxBatch] rows of each centre of the batch
  int* first;                  // [kMaxBatch + 1] their prefix sums
  int* unit;                   // [1] the batch drawn
  int* counts;                 // [2] tiles multiplied, tiles waited for
  int consumers, stages;       // consumer groups (the rest of the block produces), h1 tiles
  int c1s, c2s;                // row strides C1 + 4 and C2 + 4
};

// acc = x @ w for this warp's 64 rows x NT column tiles (cq*NT..), w from
// the stream's slabs g0..: mma_layer's instructions in its order.  x is
// [kK5Rows][xs] in shared memory.
template <int NT, int PREC>
__device__ __forceinline__ void k5_layer(const float* x, int xs, int cin, int cout,
                                         int nslabs, int g0, const K5Stream& ws,
                                         float (&acc)[4][NT][4]) {
  const int lane = threadIdx.x & 31, cq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ntc = cout / 8;
  const int kps = (cin / 8) / nslabs;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const float* xrow = x + g * xs + t;
  for (int slab = 0; slab < nslabs; ++slab) {
    const float2* wb = ws.acquire(g0 + slab) + (cq * NT) * 32 + lane;
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
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        float bh[2][2], bl[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (nt + j < NT) {
            const float2 b = wb[(kk * ntc + nt + j) * 32];
            if (one_pass(PREC)) {
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
    ws.release(g0 + slab);
  }
}

// A consumer group's life: its tiles (consumers * pass + group) through layers 2-3
// and the max fold into `out`, until the producer sends the end.  Counts
// its tiles and those whose full barrier it found incomplete into
// sm.counts.  NT2/NT3: column tiles of 8 per warp (a quarter of a layer's).
template <int NT2, int NT3, int PREC>
__device__ __forceinline__ void k5_consume(const K5Smem& sm, const K5Stream& ws, int C1,
                                           int C2, int C3, const float* __restrict__ b2,
                                           const float* __restrict__ b3,
                                           float* __restrict__ out) {
  const int group = threadIdx.x >> 7, warp = threadIdx.x >> 5, cq = warp & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  float* h2 = sm.h2 + group * kK5Rows * sm.c2s;
  int* rc = sm.warp_c + warp * kK5Rows;
  // The fold, in two chunks of half this warp's columns, NQ float4s wide:
  // the chunk goes through the warp's staging, a quarter of the group's
  // dead h2 (16 (C2 + 4) floats: C3 <= 2 C2 leaves room), and lane
  // (fs, fq) scans float4 column fq down the R rows of stretch fs.
  constexpr int NQ = NT3, R = 2 * NT3, SN = kK5Rows / R;
  float* stg = h2 + cq * 16 * sm.c2s;
  const int fs = lane / NQ, fq = lane % NQ;
  const int4* frc = reinterpret_cast<const int4*>(rc + fs * R);
  // a row between stretches where it fits keeps 8-row stretches of 4
  // float4s off each other's banks
  const int gap = NT3 == 4 && (kK5Rows + SN) * 4 * NQ <= 16 * sm.c2s ? 1 : 0;
  // float offset of (row r, float4 column q): rows of 4 NQ floats, and the
  // float4s of a row permuted so the accumulators' stores miss each other
  auto at = [&](int r, int q) {
    const int swz = NT3 == 8 ? 2 * (r & 3) : NT3 == 4 ? 2 * ((r >> 1) & 1) : 0;
    return ((r + gap * (r / R)) * NQ + (q ^ swz)) * 4;
  };
  int* o = reinterpret_cast<int*>(out);
  int tiles = 0, waits = 0, pass = 0;
  for (;; ++pass) {
    const int tile = sm.consumers * pass + group, st = tile % sm.stages;
    const int par = (tile / sm.stages) & 1;
    const bool ready = !leader || mbar_done(sm.full + st, par);
    mbar_wait(sm.full + st, par);
    if (sm.tile_end[st]) {         // handed back too: one h1 tile may serve two groups' ends
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + st);
      break;
    }
    tiles += leader;
    waits += !ready;
    const int g0 = pass * ws.nsl;
    {
      float acc[4][NT2][4];
      k5_layer<NT2, PREC>(sm.h1 + st * kK5Rows * sm.c1s, sm.c1s, C1, C2, ws.n2, g0, ws, acc);
      rc[lane] = sm.tile_c[st * kK5Rows + lane];
      rc[lane + 32] = sm.tile_c[st * kK5Rows + lane + 32];
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + st);   // the producer may refill the tile
      named_sync(kK5GroupBar + group, 128);        // the group's last fold is done with h2
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        const int c = (cq * NT2 + nt) * 8 + 2 * t;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + c));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          float* dst = h2 + (mt * 16 + g) * sm.c2s + c;
          *reinterpret_cast<float2*>(dst) =
              make_float2(fmaxf(__fadd_rn(acc[mt][nt][0], bias.x), 0.f),
                          fmaxf(__fadd_rn(acc[mt][nt][1], bias.y), 0.f));
          *reinterpret_cast<float2*>(dst + 8 * sm.c2s) =
              make_float2(fmaxf(__fadd_rn(acc[mt][nt][2], bias.x), 0.f),
                          fmaxf(__fadd_rn(acc[mt][nt][3], bias.y), 0.f));
        }
      }
    }
    named_sync(kK5GroupBar + group, 128);          // h2 is written
    float acc[4][NT3][4];
    k5_layer<NT3, PREC>(h2, sm.c2s, C2, C3, ws.nsl - ws.n2, g0 + ws.n2, ws, acc);
    named_sync(kK5GroupBar + group, 128);          // every warp has read h2
    auto flush = [&](int centre, const float4& m, int col) {
      if (centre < 0) return;
      int* to = o + (size_t)centre * C3 + col;
      if (m.x > 0.f) atomicMax(to, __float_as_int(m.x));
      if (m.y > 0.f) atomicMax(to + 1, __float_as_int(m.y));
      if (m.z > 0.f) atomicMax(to + 2, __float_as_int(m.z));
      if (m.w > 0.f) atomicMax(to + 3, __float_as_int(m.w));
    };
    auto max4 = [](const float4& a, const float4& b) {
      return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
    };
    auto down4 = [](const float4& v, int d) {
      return make_float4(__shfl_down_sync(0xffffffffu, v.x, d),
                         __shfl_down_sync(0xffffffffu, v.y, d),
                         __shfl_down_sync(0xffffffffu, v.z, d),
                         __shfl_down_sync(0xffffffffu, v.w, d));
    };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // layer 3's outputs of the chunk, with bias and ReLU
#pragma unroll
      for (int j = 0; j < NT3 / 2; ++j) {
        const int nt = half * (NT3 / 2) + j;
        const float2 bias =
            __ldg(reinterpret_cast<const float2*>(b3 + (cq * NT3 + nt) * 8 + 2 * t));
        const int q = 2 * j + (t >> 1), off = 2 * (t & 1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          *reinterpret_cast<float2*>(stg + at(mt * 16 + g, q) + off) =
              make_float2(fmaxf(__fadd_rn(acc[mt][nt][0], bias.x), 0.f),
                          fmaxf(__fadd_rn(acc[mt][nt][1], bias.y), 0.f));
          *reinterpret_cast<float2*>(stg + at(mt * 16 + g + 8, q) + off) =
              make_float2(fmaxf(__fadd_rn(acc[mt][nt][2], bias.x), 0.f),
                          fmaxf(__fadd_rn(acc[mt][nt][3], bias.y), 0.f));
        }
      }
      __syncwarp();
      const int col = (cq * NT3 + half * (NT3 / 2)) * 8 + 4 * fq;
      // this lane's stretch: its first run (head, hm), its last (cur, m);
      // runs in between are whole and sent here
      const int r0 = fs * R;
      int cur = reinterpret_cast<const int*>(frc)[0];
      float4 m = *reinterpret_cast<const float4*>(stg + at(r0, fq));
      const int head = cur;
      float4 hm = m;
      bool split = false;
#pragma unroll
      for (int i4 = 0; i4 < R / 4; ++i4) {
        const int4 c4 = frc[i4];
        const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * i4 + k;
          if (i == 0) continue;
          const float4 v = *reinterpret_cast<const float4*>(stg + at(r0 + i, fq));
          if (cs[k] != cur) {
            if (split) flush(cur, m, col);
            else hm = m;
            split = true;
            cur = cs[k];
            m = v;
          } else {
            m = max4(m, v);
          }
        }
      }
      if (!split) hm = m;
      // Rows are in centre order.  x: the max of this stretch's first run
      // over it and the later stretches that run on with it, by doubling
      // (open: the run fills every stretch summed so far).
      float4 x = hm;
      bool open = !split;
#pragma unroll
      for (int d = 1; d < SN; d *= 2) {
        const float4 ox = down4(x, d * NQ);
        const int oh = __shfl_down_sync(0xffffffffu, head, d * NQ);
        const bool oo = __shfl_down_sync(0xffffffffu, (int)open, d * NQ) != 0;
        if (open && fs + d < SN && oh == head) {
          x = max4(x, ox);
          open = oo;
        } else {
          open = false;
        }
      }
      // the last run takes the first runs of the later stretches with its
      // centre; the first run is sent here unless the stretch before runs on
      const float4 nx = down4(x, NQ);
      const int nh = __shfl_down_sync(0xffffffffu, head, NQ);
      const int before = __shfl_up_sync(0xffffffffu, cur, NQ);
      if (fs + 1 < SN && nh == cur) m = max4(m, nx);
      const bool runs_on = fs > 0 && before == head;
      if (split && !runs_on) flush(head, hm, col);
      if (split || !runs_on) flush(cur, m, col);
      __syncwarp();
    }
  }
  ws.drain(pass);
  if (leader) {
    atomicAdd(sm.counts, tiles);
    atomicAdd(sm.counts + 1, waits);
  }
}

// The producer's life: batches of centres from `counter`, their balls, and
// their rows through layer 1 into the h1 tiles, in order; then a padded last
// tile, pad tiles to a whole round, and an end tile for each group.
template <bool HAS_UF>
__device__ __forceinline__ void k5_front(const K5Smem& sm, const float* __restrict__ new_xyz,
                                         const float* __restrict__ xyz,
                                         const float* __restrict__ uf,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ a1x,
                                         int* __restrict__ counter,
                                         unsigned long long* __restrict__ rows_count,
                                         const int* __restrict__ first_copy, int B, int S,
                                         int N, int K, int C1, float r2, int CB) {
  const int fthreads = kK5Threads - 128 * sm.consumers, fwarps = fthreads / 32;
  const int ft = threadIdx.x - 128 * sm.consumers;
  const int fw = ft >> 5, lane = ft & 31;
  const int nqb = (S + CB - 1) / CB;
  const int total = B * nqb;
  // layer 1's four columns of this thread (C1 / 4 divides 128), their weights,
  // and its rows of a tile
  const int cg = C1 / 4;
  const int c1 = (ft % cg) * 4, j1 = ft / cg, jstep = fthreads / cg;
  const float4 w1x = *reinterpret_cast<const float4*>(a1x + c1);
  const float4 w1y = *reinterpret_cast<const float4*>(a1x + C1 + c1);
  const float4 w1z = *reinterpret_cast<const float4*>(a1x + 2 * C1 + c1);
  const float4 w1b = *reinterpret_cast<const float4*>(b1 + c1);
  int tile = 0, fill = 0;                  // the tile being written, its rows so far
  // wait until the tile's h1 is free; end: it tells its group to stop
  auto open = [&](int end) {
    const int st = tile % sm.stages;
    if (tile >= sm.stages) mbar_wait(sm.empty + st, (tile / sm.stages - 1) & 1);
    if (ft == 0) sm.tile_end[st] = end;
  };
  // rows from `fill` on are zero and of no centre; hand the tile over
  auto close = [&]() {
    const int st = tile % sm.stages;
    for (int r = fill + j1; r < kK5Rows; r += jstep) {
      *reinterpret_cast<float4*>(sm.h1 + (st * kK5Rows + r) * sm.c1s + c1) =
          make_float4(0.f, 0.f, 0.f, 0.f);
      if (c1 == 0) sm.tile_c[st * kK5Rows + r] = -1;
    }
    mbar_arrive(sm.full + st);
    ++tile;
    fill = 0;
  };
  while (true) {
    if (ft == 0) sm.unit[0] = atomicAdd(counter, 1);
    named_sync(kK5FrontBar, fthreads);
    const int batch = sm.unit[0];
    if (batch >= total) break;
    const int b = batch / nqb;
    const int s0 = (batch - b * nqb) * CB;
    const int nc = min(CB, S - s0);
    const float* xb = xyz + (size_t)b * N * 3;
    for (int q = fw; q < nc; q += fwarps) {
      const float* c = new_xyz + ((size_t)b * S + s0 + q) * 3;
      const float cx = c[0], cy = c[1], cz = c[2];
      const float q2 = fmaf(cz, cz, fmaf(cy, cy, fmaf(cx, cx, 0.f)));
      int* mine = sm.slots + q * K;
      int count = 0, rows = 0;          // in-ball points, and those that become rows
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
        sm.nball[q] = count == 0 ? 1 : rows;
      }
    }
    named_sync(kK5FrontBar, fthreads);
    if (ft == 0) {
      sm.first[0] = 0;
      for (int q = 0; q < nc; ++q) sm.first[q + 1] = sm.first[q] + sm.nball[q];
      if (rows_count != nullptr) atomicAdd(rows_count, (unsigned long long)sm.first[nc]);
    }
    named_sync(kK5FrontBar, fthreads);
    for (int q = fw; q < nc; q += fwarps)
      for (int i = lane; i < sm.nball[q]; i += 32) sm.row_q[sm.first[q] + i] = q;
    named_sync(kK5FrontBar, fthreads);
    // the batch's rows, in order, through layer 1 into the tiles:
    // relu(((offset @ A1x) + b1) + uf[p]), a thread per four columns
    const int nrows = sm.first[nc];
    for (int e0 = 0; e0 < nrows;) {
      if (fill == 0) open(0);
      const int st = tile % sm.stages, n = min(kK5Rows - fill, nrows - e0);
      float* h1 = sm.h1 + (st * kK5Rows + fill) * sm.c1s + c1;
      int* tc = sm.tile_c + st * kK5Rows + fill;
#pragma unroll 2
      for (int r = j1; r < n; r += jstep) {
        const int e = e0 + r, q = sm.row_q[e];
        const int centre = b * S + s0 + q;
        const int p = b * N + sm.slots[q * K + e - sm.first[q]];
        const float* pt = xyz + (size_t)p * 3;
        const float* c = new_xyz + (size_t)centre * 3;
        const float ox = __fsub_rn(pt[0], c[0]);
        const float oy = __fsub_rn(pt[1], c[1]);
        const float oz = __fsub_rn(pt[2], c[2]);
        float4 v;
        v.x = __fadd_rn(fmaf(oz, w1z.x, fmaf(oy, w1y.x, __fmul_rn(ox, w1x.x))), w1b.x);
        v.y = __fadd_rn(fmaf(oz, w1z.y, fmaf(oy, w1y.y, __fmul_rn(ox, w1x.y))), w1b.y);
        v.z = __fadd_rn(fmaf(oz, w1z.z, fmaf(oy, w1y.z, __fmul_rn(ox, w1x.z))), w1b.z);
        v.w = __fadd_rn(fmaf(oz, w1z.w, fmaf(oy, w1y.w, __fmul_rn(ox, w1x.w))), w1b.w);
        if (HAS_UF) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(uf + (size_t)p * C1 + c1));
          v.x = __fadd_rn(v.x, u.x);
          v.y = __fadd_rn(v.y, u.y);
          v.z = __fadd_rn(v.z, u.z);
          v.w = __fadd_rn(v.w, u.w);
        }
        *reinterpret_cast<float4*>(h1 + r * sm.c1s) =
            make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
        if (c1 == 0) tc[r] = centre;
      }
      fill += n;
      e0 += n;
      if (fill == kK5Rows) close();
    }
    named_sync(kK5FrontBar, fthreads);    // the batch's arrays are read
  }
  if (fill > 0) close();
  while (tile % sm.consumers != 0) {  // whole rounds: a round reads the weights once
    open(0);
    close();
  }
  for (int group = 0; group < sm.consumers; ++group) {
    open(1);
    close();
  }
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

// tiles_count, waits_count: nullptr, or 64-bit counters to which each block
// adds the tiles its consumer groups multiplied and those at which a group
// found the tile not yet written (one atomicAdd each a block, at its end).
// FRONTS: producer warpgroups, 1 or 2 (the launcher's choice by shape).
template <bool HAS_UF, int PREC, int FRONTS>
__global__ void __launch_bounds__(kK5Threads, 1)
ball_mlp3_kernel(const float* __restrict__ new_xyz, const float* __restrict__ xyz,
                 const float* __restrict__ uf, const float* __restrict__ b1,
                 const float* __restrict__ a1x, const float* __restrict__ wfrag,
                 const float* __restrict__ b2, const float* __restrict__ b3,
                 float* __restrict__ out, int* __restrict__ counter,
                 unsigned long long* __restrict__ rows_count,
                 unsigned long long* __restrict__ tiles_count,
                 unsigned long long* __restrict__ waits_count,
                 const int* __restrict__ first_copy, int B, int S, int N, int K, int C1,
                 int C2, int C3, float r2, int CB, int stages, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  K5Stream ws;
  ws.frag = wfrag;
  ws.full = bars + 2 * kK5MaxStages;
  ws.ring = smem + kK5BarBytes / 4;                       // [nbuf][kSlabFloats]
  ws.n2 = (C1 / 8) / slab_ksteps(C1, C2);
  ws.s2 = slab_ksteps(C1, C2) * C2 * 8;
  ws.s3 = slab_ksteps(C2, C3) * C3 * 8;
  ws.nsl = ws.n2 + (C2 / 8) / slab_ksteps(C2, C3);
  ws.nbuf = nbuf;
  constexpr int kConsumers = 3 - FRONTS;
  ws.warps = 4 * kConsumers;
  K5Smem sm;
  sm.consumers = kConsumers;
  sm.stages = stages;
  sm.c1s = C1 + 4;
  sm.c2s = C2 + 4;
  sm.full = bars;
  sm.empty = bars + kK5MaxStages;
  sm.h1 = ws.ring + nbuf * kSlabFloats;
  sm.h2 = sm.h1 + stages * kK5Rows * sm.c1s;
  sm.tile_c = reinterpret_cast<int*>(sm.h2 + kConsumers * kK5Rows * sm.c2s);
  sm.warp_c = sm.tile_c + stages * kK5Rows;
  sm.slots = sm.warp_c + 4 * kK5MaxConsumers * kK5Rows;
  sm.row_q = sm.slots + kMaxBatchRows;
  sm.nball = sm.row_q + kMaxBatchRows;
  sm.first = sm.nball + kMaxBatch;
  sm.unit = sm.first + kMaxBatch + 1;
  sm.counts = sm.unit + 1;
  ws.done = sm.counts + 2;
  sm.tile_end = ws.done + kK5MaxBufs;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(sm.full + st, 128 * FRONTS);
      mbar_init(sm.empty + st, 4);
    }
    for (int i = 0; i < nbuf; ++i) {
      mbar_init(ws.full + i, 1);
      ws.done[i] = 0;
    }
    sm.counts[0] = sm.counts[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int g = 0; g < nbuf; ++g) ws.copy(g);
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(k5_front_regs(FRONTS)));
    k5_front<HAS_UF>(sm, new_xyz, xyz, uf, b1, a1x, counter, rows_count, first_copy, B, S, N,
                     K, C1, r2, CB);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kK5ConsumerRegs));
    switch ((C2 / 32) * 16 + C3 / 32) {
      case 1 * 16 + 2:
        k5_consume<1, 2, PREC>(sm, ws, C1, C2, C3, b2, b3, out);
        break;
      case 2 * 16 + 4:
        k5_consume<2, 4, PREC>(sm, ws, C1, C2, C3, b2, b3, out);
        break;
      case 3 * 16 + 4:
        k5_consume<3, 4, PREC>(sm, ws, C1, C2, C3, b2, b3, out);
        break;
      default:  // two producers only where layer 3 has at most 128 columns
        if constexpr (FRONTS == 1) k5_consume<4, 8, PREC>(sm, ws, C1, C2, C3, b2, b3, out);
        break;
    }
    if (tiles_count != nullptr || waits_count != nullptr) {
      named_sync(kK5ConsumersBar, 128 * kConsumers);
      if (threadIdx.x == 0) {
        if (tiles_count != nullptr) atomicAdd(tiles_count, (unsigned long long)sm.counts[0]);
        if (waits_count != nullptr) atomicAdd(waits_count, (unsigned long long)sm.counts[1]);
      }
    }
  }
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
// for layers 2-3 (one atomicAdd a batch).  tiles_count, waits_count:
// nullptr, or 64-bit counters of the h1 tiles the consumer groups
// multiplied and of those they found not yet written (one atomicAdd each a
// block).  prec: the matmul precision of layers 2-3 (kPrecHighest,
// kPrecHigh or kPrecDefault).
int iq_ball_mlp3(const float* new_xyz, const float* xyz, const float* uf, const float* b1,
                 const float* a1x, const float* a2, const float* b2, const float* a3,
                 const float* b3, float* out, float* scratch, unsigned long long* rows_count,
                 unsigned long long* tiles_count, unsigned long long* waits_count, int B,
                 int S, int N, int K, int C1, int C2, int C3, float r2, int prec,
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
  // the weights resident where they fit beside two h1 tiles, else streamed;
  // then as many h1 tiles as fit, up to kK5MaxStages
  const int nslabs = (C1 / 8) / slab_ksteps(C1, C2) + (C2 / 8) / slab_ksteps(C2, C3);
  // two producer warpgroups beside one consumer group where a row costs
  // the products little against its share of the ball query and layer 1
  const int fronts = C1 * C2 + C2 * C3 <= kK5TwoFrontsMacs && C3 <= 128 ? 2 : 1;
  const int consumers = 3 - fronts;
  const int nbuf =
      nslabs <= kK5MaxBufs && k5_smem_bytes(C1, C2, consumers, 2, nslabs) <= kMaxSmem
          ? nslabs
          : kK5StreamBufs;
  int stages = kK5MaxStages;
  while (stages > 1 && k5_smem_bytes(C1, C2, consumers, stages, nbuf) > kMaxSmem) --stages;
  const size_t smem = k5_smem_bytes(C1, C2, consumers, stages, nbuf);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;

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
  using Kernel = decltype(&ball_mlp3_kernel<true, kPrecHighest, 1>);
  static const Kernel kernels[2][2][3] = {
      {{ball_mlp3_kernel<false, kPrecHighest, 1>, ball_mlp3_kernel<false, kPrecHigh, 1>,
        ball_mlp3_kernel<false, kPrecDefault, 1>},
       {ball_mlp3_kernel<true, kPrecHighest, 1>, ball_mlp3_kernel<true, kPrecHigh, 1>,
        ball_mlp3_kernel<true, kPrecDefault, 1>}},
      {{ball_mlp3_kernel<false, kPrecHighest, 2>, ball_mlp3_kernel<false, kPrecHigh, 2>,
        ball_mlp3_kernel<false, kPrecDefault, 2>},
       {ball_mlp3_kernel<true, kPrecHighest, 2>, ball_mlp3_kernel<true, kPrecHigh, 2>,
        ball_mlp3_kernel<true, kPrecDefault, 2>}}};
  const Kernel kernel = kernels[fronts - 1][uf != nullptr][prec];
  if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
  kernel<<<grid, kK5Threads, smem, s>>>(
      new_xyz, xyz, uf, b1, a1x, frag2, b2, b3, out, counter, rows_count, tiles_count,
      waits_count, uf != nullptr ? nullptr : first_copy, B, S, N, K, C1, C2, C3, r2, CB,
      stages, nbuf);
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
