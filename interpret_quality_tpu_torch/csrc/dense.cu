// DGCNN's head for Hopper (sm_90a): conv5, its eval BatchNorm and
// LeakyReLU(0.2), and the max and the mean over each cloud's points, in one
// kernel (bound with ctypes from interpret_quality_tpu_torch/ops/cuda/dense.py):
//
//   iq_dense_pool   out[b, c]     = max_n y[b, n, c]
//                   out[b, C + c] = (sum_n y[b, n, c]) / N
//                   y = leaky_relu_0.2((x @ W^T - mean) * mul + bias),
//                   x the concatenation of up to four feature segments
//
// Replaces no TPU kernel: the JAX package leaves the head to XLA, which
// fuses the product's epilogue and the pooling on the TPU.  On the card the
// same head in PyTorch is a cuBLAS f32 product on the FMA units that writes
// a (B, N, C) activation (6.9 GB a forward of 1650 clouds of 1024 points),
// then six passes over it (BatchNorm's three, LeakyReLU, max, mean), about
// 45% of a DGCNN forward.
//
// What bounds it on H100: operations.  The product costs 2 N K C a cloud
// (1.77 TFLOP a forward at K = 512, C = 1024); its bytes (the input rows and
// W once, the (B, 2C) output) are 3.5 GB.  The product runs on the tensor
// cores at the matmul precision `prec` (mma_tf32.cuh): three TF32 products
// at kPrecHighest (f32 accuracy), one at kPrecHigh and kPrecDefault.  With
// mma.sync it reaches about 40% of the TF32 rate at kPrecHighest (PERF.md);
// wgmma, with W's halves split ahead in shared memory, is the way further.
//
// The design.  One block per (cloud, slice of kCols output channels), the
// slice the fastest index, so a cloud's blocks run together and its input
// rows come from L2 after the first block reads them.  The block walks the
// cloud's rows in tiles of kRows (the last tile's rows beyond N read row
// N - 1 and are masked in the epilogue, so any N works), and streams K in
// chunks of kKChunk through a ring of kStages buffers filled with cp.async:
// a chunk of the rows (read where they lie, from the segment that holds
// those columns: the concatenation never exists) and the matching chunk of
// W, which order_dense_weights_kernel wrote once per launch in the order
// the mma's B fragments are read (one conflict-free 8-byte load a lane),
// rounded for a one-pass product and whole f32 at kPrecHighest, where the
// split is made in registers.  The stream runs across tile boundaries, so
// the next tile's loads fly during a tile's epilogue.  Each of the 8 warps
// owns 64 rows x 64 columns of the tile.  The epilogue is in registers:
// BatchNorm in bn_eval's order (subtract, multiply, add, each rounded),
// LeakyReLU, then a running max and a running sum of each column over the
// thread's rows of every tile.  At the end one butterfly across the lanes
// that share a column, one exchange in shared memory between the two warps
// that share it, and one store.  The order is fixed and nothing is atomic,
// so the result is deterministic.
//
// The listed route (kListed).  A masked coalition collapses its absent
// regions onto one point, so about half of a batch's rows are bit-for-bit
// copies of an earlier row of their cloud, and so are their products.  Where
// the caller passes each cloud's distinct rows and the spans of their copies
// (kernel 3's copy lists, csrc/knn_select.cuh copy_lists_kernel), block b
// walks rows[b][0 .. nrows[b]) in place of all N: tile row r of tile t is
// row rows[b][min(t kRows + r, nrows[b] - 1)], read through the same ring.
// The epilogue masks places from nrows[b] on, folds each place into the max
// once and adds its value times its number of copies to the sum, which is
// still divided by N.  The max is over the same values as the every-row walk
// (a row's products do not depend on its place in the tile); the mean sums
// the same values in another grouping.  Without lists (kListed false) the
// block walks all N rows as above.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for arguments the
// kernel does not take.

#include "knn_select.cuh"
#include "mma_tf32.cuh"

namespace {

// The block's tile: kRowGroups x kColGroups warps, each 64 rows x kNT
// column tiles of 8: 128 rows x 256 columns, one block a SM (250 registers
// a thread).  Measured on the H100 at 1650 clouds of 1024 points against
// 128 x 128 tiles of 64 x 32 a warp at two blocks a SM: 25.4-25.7 ms
// against 27.8-28.6; 256 x 128 tiles, 8 or 16 warps: 26.1 and 29.3 ms; a
// fourth ring buffer: no change.  Larger warp tiles split fewer operands
// for each product and read less from L2.
constexpr int kRowGroups = 2;
constexpr int kColGroups = 4;
constexpr int kNT = 8;
constexpr int kMinBlocks = 1;               // blocks a SM (__launch_bounds__)
constexpr int kDenseThreads = 32 * kRowGroups * kColGroups;
constexpr int kRows = 64 * kRowGroups;      // rows of a tile
constexpr int kCols = 8 * kNT * kColGroups; // output channels of a block
constexpr int kKChunk = 32;                 // input channels of a stream step
constexpr int kStages = 3;                  // ring buffers
constexpr int kMaxSegments = 4;
constexpr int kAStride = kKChunk + 4;       // row stride of a staged chunk: conflict-free
constexpr int kAFloats = kRows * kAStride;
constexpr int kWFloats = kKChunk * kCols;   // (kKChunk / 8) x (kCols / 8) x 32 float2
constexpr size_t kDenseSmem = (size_t)kStages * (kAFloats + kWFloats) * sizeof(float);
constexpr float kLeakySlope = 0.2f;
static_assert(2 * (kRowGroups - 1) * kCols <= kStages * kAFloats,
              "the row groups' partial results fit the ring");

// A cloud's distinct rows and their copies (the listed route): rows[b * N +
// p] is cloud b's distinct row p, ascending, nrows[b] their count, and
// starts[b * (N + 1) + p .. p + 1] the span of row p's copies, itself
// included.
struct RowLists {
  const int* rows;
  const int* nrows;
  const int* starts;
};

// The input rows: segment s holds columns [start[s], start[s] + width[s]) of
// the concatenation, as a (B, N, width[s]) tensor.
struct Segments {
  const float* x[kMaxSegments];
  int width[kMaxSegments];
  int start[kMaxSegments];
  int n;
};

// w (C, K) row-major, conv5's (out, in) -> the order the block of slice
// cs reads its B fragments in: float2 number
// ((((cs * (K / kKChunk) + ch) * (kKChunk / 8) + kk) * (kCols / 8) + nt) * 32
// + lane) holds w[cs*kCols + nt*8 + lane/4][ch*kKChunk + kk*8 + lane%4] and
// the value four input channels further; rounded for a one-pass product at
// precision prec, whole f32 at kPrecHighest (the kernel splits them).
__global__ void order_dense_weights_kernel(const float* __restrict__ w, int K, int C,
                                           float2* __restrict__ frag, int prec) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= K * C / 2) return;
  const int lane = e & 31, tile = e >> 5;
  const int nt = tile % (kCols / 8), kk = (tile / (kCols / 8)) % (kKChunk / 8);
  const int rest = tile / (kCols / 8) / (kKChunk / 8);
  const int chunks = K / kKChunk;
  const int ch = rest % chunks, cs = rest / chunks;
  const int col = cs * kCols + nt * 8 + (lane >> 2);
  const int k = ch * kKChunk + kk * 8 + (lane & 3);
  const float* row = w + (size_t)col * K + k;
  frag[e] = make_float2(round_operand(prec, row[0]), round_operand(prec, row[4]));
}

template <int PREC, bool kListed>
__global__ void __launch_bounds__(kDenseThreads, kMinBlocks)
    dense_pool_kernel(Segments seg, RowLists lists, const float2* __restrict__ frag,
                      const float* __restrict__ mean, const float* __restrict__ mul,
                      const float* __restrict__ bias, float* __restrict__ out, int N, int K,
                      int C) {
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);   // [kStages][kRows][kAStride]
  float* sw = sa + kStages * kAFloats;           // [kStages][kWFloats]
  const int slices = C / kCols;
  const int b = blockIdx.x / slices, cs = blockIdx.x - b * slices;
  const int chunks = K / kKChunk;
  // the rows the block walks: all N, or the cloud's distinct rows
  const int nr = kListed ? __ldg(lists.nrows + b) : N;
  const int* listed = kListed ? lists.rows + (size_t)b * N : nullptr;
  const int steps = ((nr + kRows - 1) / kRows) * chunks;
  const float* wslice = reinterpret_cast<const float*>(frag) + (size_t)cs * chunks * kWFloats;

  // start the copies of stream step `step` (one commit group, empty past the end)
  auto load = [&](int step) {
    if (step < steps) {
      const int tile = step / chunks, ch = step - tile * chunks;
      const int k0 = ch * kKChunk;
      const float* x = seg.x[0];                 // the segment that holds column k0
      int width = seg.width[0], start = 0;
#pragma unroll
      for (int s = 1; s < kMaxSegments; ++s)
        if (s < seg.n && k0 >= seg.start[s]) {
          x = seg.x[s];
          width = seg.width[s];
          start = seg.start[s];
        }
      const float* src = x + (size_t)b * N * width + (k0 - start);
      float* da = sa + (step % kStages) * kAFloats;
      for (int e = threadIdx.x; e < kRows * kKChunk / 4; e += kDenseThreads) {
        const int r = e / (kKChunk / 4), q = e % (kKChunk / 4);
        const int p = min(tile * kRows + r, nr - 1);
        const int n = kListed ? __ldg(listed + p) : p;
        cp_async16(da + r * kAStride + 4 * q, src + (size_t)n * width + 4 * q, true);
      }
      const float* ws = wslice + (size_t)ch * kWFloats;
      float* dw = sw + (step % kStages) * kWFloats;
      for (int e = 4 * threadIdx.x; e < kWFloats; e += 4 * kDenseThreads)
        cp_async16(dw + e, ws + e, true);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / kColGroups, cq = warp % kColGroups;   // rows rg*64.., columns
  float acc[4][kNT][4];                          // [row tile of 16][column tile of 8][frag]
  float vmax[kNT][2], vsum[kNT][2];              // [column tile][column 2t + j]
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      vmax[nt][j] = -CUDART_INF_F;
      vsum[nt][j] = 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) load(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();          // step landed; everyone is done with step - 1's buffer
    load(step + kStages - 1);
    const float* a = sa + (step % kStages) * kAFloats + (rg * 64 + g) * kAStride + t;
    const float2* wb = reinterpret_cast<const float2*>(sw + (step % kStages) * kWFloats) +
                       cq * kNT * 32 + lane;
#pragma unroll
    for (int kk = 0; kk < kKChunk / 8; ++kk) {
      float bh[kNT][2], bl[kNT][2];              // the weights' halves, split here
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float2 w = wb[(kk * (kCols / 8) + nt) * 32];
        if (one_pass(PREC)) {                    // rounded already
          bh[nt][0] = w.x;
          bh[nt][1] = w.y;
        } else {
          bh[nt][0] = tf32_hi(w.x);
          bh[nt][1] = tf32_hi(w.y);
          bl[nt][0] = tf32_lo(w.x, bh[nt][0]);
          bl[nt][1] = tf32_lo(w.y, bh[nt][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* p = a + mt * 16 * kAStride + kk * 8;
        const float v[4] = {p[0], p[8 * kAStride], p[4], p[8 * kAStride + 4]};
        float ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (one_pass(PREC)) {
            ahi[i] = round_operand(PREC, v[i]);
          } else {
            ahi[i] = tf32_hi(v[i]);
            alo[i] = tf32_lo(v[i], ahi[i]);
          }
        }
        // pass by pass over the column tiles: kNT independent accumulators
        // between two products into the same one
        if (!one_pass(PREC)) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], alo, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ahi, bl[nt][0], bl[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ahi, bh[nt][0], bh[nt][1]);
      }
    }
    if ((step + 1) % chunks == 0) {              // the tile's products are done
      const int row0 = (step / chunks) * kRows + rg * 64 + g;
      float copies[4][2];                        // listed: each place's copies
      if constexpr (kListed) {
        const int* sb = lists.starts + (size_t)b * (N + 1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = min(row0 + mt * 16 + 8 * h, nr - 1);
            copies[mt][h] = (float)(__ldg(sb + p + 1) - __ldg(sb + p));
          }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = cs * kCols + (cq * kNT + nt) * 8 + 2 * t + j;
          const float m = __ldg(mean + col), u = __ldg(mul + col), c = __ldg(bias + col);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float y = __fadd_rn(__fmul_rn(__fsub_rn(acc[mt][nt][2 * h + j], m), u), c);
              y = y > 0.f ? y : __fmul_rn(y, kLeakySlope);
              if (row0 + mt * 16 + 8 * h < nr) {
                vmax[nt][j] = fmaxf(vmax[nt][j], y);
                if constexpr (kListed) y = __fmul_rn(copies[mt][h], y);   // exact counts
                vsum[nt][j] = __fadd_rn(vsum[nt][j], y);
              }
            }
        }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }

  // across the 8 lanes of a column (g), then across the row groups, in order
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        vmax[nt][j] = fmaxf(vmax[nt][j], __shfl_xor_sync(0xffffffffu, vmax[nt][j], off));
        vsum[nt][j] = __fadd_rn(vsum[nt][j], __shfl_xor_sync(0xffffffffu, vsum[nt][j], off));
      }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free
  float* red = sa;                               // [kRowGroups - 1][2][kCols]: max, sum
  if (rg > 0 && g == 0) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = (cq * kNT + nt) * 8 + 2 * t + j;
        red[(rg - 1) * 2 * kCols + c] = vmax[nt][j];
        red[(rg - 1) * 2 * kCols + kCols + c] = vsum[nt][j];
      }
  }
  __syncthreads();
  if (rg == 0 && g == 0) {
    float* o = out + (size_t)b * 2 * C + cs * kCols;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = (cq * kNT + nt) * 8 + 2 * t + j;
        float m = vmax[nt][j], s = vsum[nt][j];
        for (int r = 1; r < kRowGroups; ++r) {
          m = fmaxf(m, red[(r - 1) * 2 * kCols + c]);
          s = __fadd_rn(s, red[(r - 1) * 2 * kCols + kCols + c]);
        }
        o[c] = m;
        o[C + c] = __fdiv_rn(s, (float)N);
      }
  }
}

}  // namespace

extern "C" {

// x0..x3: the segments' rows, (B, N, w_s) each, on a 16-byte boundary;
// w_s a multiple of 32, unused segments width 0 (after the used ones).
// weight: (C, K) with K the sum of the widths, C a multiple of kCols (256).
// mean, mul, bias: (C,) each, the BatchNorm as bn_eval applies it.  out:
// (B, 2C).
// scratch: K * C floats of device memory on a 16-byte boundary (the weights
// in fragment order).  prec: kPrecHighest, kPrecHigh or kPrecDefault.
// rows, nrows, starts: each cloud's distinct rows, their count and their
// copies' spans, as kernel 3's launch leaves them ((B, N), (B,), (B, N + 1)
// int32), for the listed route; all three nullptr: every row.
int iq_dense_pool(const float* x0, const float* x1, const float* x2, const float* x3, int w0,
                  int w1, int w2, int w3, const float* weight, const float* mean,
                  const float* mul, const float* bias, float* out, float* scratch,
                  const int* rows, const int* nrows, const int* starts, int B, int N, int C,
                  int prec, void* stream) {
  if (B <= 0) return cudaSuccess;
  const float* xs[kMaxSegments] = {x0, x1, x2, x3};
  const int ws[kMaxSegments] = {w0, w1, w2, w3};
  Segments seg{};
  int K = 0;
  for (int s = 0; s < kMaxSegments; ++s) {
    if (ws[s] == 0) continue;
    if (ws[s] < 0 || ws[s] % kKChunk || xs[s] == nullptr) return cudaErrorInvalidValue;
    seg.x[seg.n] = xs[s];
    seg.width[seg.n] = ws[s];
    seg.start[seg.n] = K;
    ++seg.n;
    K += ws[s];
  }
  const bool listed = rows != nullptr;
  if (listed != (nrows != nullptr) || listed != (starts != nullptr)) return cudaErrorInvalidValue;
  if (prec < kPrecHighest || prec > kPrecDefault || seg.n == 0 || N < 1 || C < kCols ||
      C % kCols || (long long)B * (C / kCols) > 0x7fffffffLL ||
      (long long)K * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  float2* frag = reinterpret_cast<float2*>(scratch);
  order_dense_weights_kernel<<<(K * C / 2 + 255) / 256, 256, 0, s>>>(weight, K, C, frag, prec);
  using Kernel = decltype(&dense_pool_kernel<kPrecHighest, false>);
  static const Kernel kernels[2][3] = {
      {dense_pool_kernel<kPrecHighest, false>, dense_pool_kernel<kPrecHigh, false>,
       dense_pool_kernel<kPrecDefault, false>},
      {dense_pool_kernel<kPrecHighest, true>, dense_pool_kernel<kPrecHigh, true>,
       dense_pool_kernel<kPrecDefault, true>}};
  const Kernel kernel = kernels[listed][prec];
  if ((err = prepare(kernel, kDenseSmem)) != cudaSuccess) return err;
  const RowLists lists{rows, nrows, starts};
  kernel<<<(unsigned)(B * (C / kCols)), kDenseThreads, kDenseSmem, s>>>(seg, lists, frag, mean,
                                                                        mul, bias, out, N, K, C);
  return cudaGetLastError();
}

}  // extern "C"
