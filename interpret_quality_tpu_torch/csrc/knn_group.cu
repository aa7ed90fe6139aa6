// PCT's sample-and-group layer for Hopper (sm_90a), kernel 10: the gather of
// each centre's kNN group, layer 1's ReLU, layer 2 with its folded BatchNorm
// and ReLU, and the max over the group, in one launch (bound with ctypes
// from interpret_quality_tpu_torch/ops/cuda/knn_group.py):
//
//   iq_knn_group_max   out[b, s, o] = relu(max_k sum_c h[b, s, k, c] a2[c, o] + b2[o])
//                      h[b, s, k, c] = relu(u[b, idx[b, s, k], c] + cs[b, s, c])
//
// (the max commutes with the bias and the ReLU, both monotone, so the bias
// is added once a centre).  u is layer 1 hoisted above the gather, on the N
// points; cs is each centre's share, on the S centres.
//
// Replaces no TPU kernel: the JAX package has no PCT.  In plain PyTorch the
// layer writes the gathered (B, S, K, C1) rows and their layer-2 product to
// device memory: at a forward of 1650 clouds 13.8 GB each, at both levels.
//
// What bounds it on H100: operations.  Layer 2 costs C1 C2 multiply-adds a
// slot: 0.89 TFLOP at PCT's first level (512 centres x 32 slots, 128 -> 128)
// and 1.77 at its second (256 x 32, 256 -> 256) a forward of 1650 clouds,
// on the tensor cores at the matmul precision `prec` (mma_tf32.cuh): three
// TF32 products at kPrecHighest (f32 accuracy), one at kPrecHigh and
// kPrecDefault.  Its bytes (the indices, u, cs, the weights and the output,
// each once) are about 1.8 GB a level.
//
// The design is kernel 9's (dense.cu) with a gathered A operand and a
// max over each centre's rows.  A tile is kGCentres centres x kGSlots slots
// = 128 rows by all C2 columns; a block walks kGTiles tiles of one cloud and
// streams C1 in chunks of kGKChunk through a ring of kGStages buffers filled
// with cp.async: the chunk of each row's u, read where it lies at the row
// idx names (the block reads a tile's 128 indices once, into registers, at
// the tile's first chunk), the chunk of the tile's 4 centres' cs, and the
// chunk of layer 2's weights, which order_group_weights_kernel wrote once a
// launch in the order the mma's B fragments are read (rounded for a one-pass
// product, whole f32 at kPrecHighest, where the split is made in registers).
// The A fragments are made on their way in: relu(u + cs) in f32, then split
// or rounded.  The stream runs across tile boundaries.  Each warp owns 64
// rows (two centres) x 64 columns; at a tile's last chunk the max over each
// centre's 32 rows is taken in registers and across the 8 lanes that share
// a column, the bias added, the ReLU applied and the result stored.  The
// order is fixed and nothing is atomic: the result is deterministic.  Rows
// of a ragged last tile read centre S - 1 and are not stored.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for arguments the
// kernel does not take.

#include "knn_select.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kGSlots = 32;                    // neighbours of a centre (K)
constexpr int kGCentres = 4;                   // centres of a tile
constexpr int kGRows = kGCentres * kGSlots;    // rows of a tile
constexpr int kGKChunk = 32;                   // input channels of a stream step
constexpr int kGStages = 3;                    // ring buffers
constexpr int kGTiles = 16;                    // tiles of a block (64 centres)
constexpr int kGNT = 8;                        // column tiles of 8 a warp: 64 columns
constexpr int kGAStride = kGKChunk + 4;        // row stride of a staged chunk: conflict-free
constexpr int kGAFloats = kGRows * kGAStride;
constexpr int kGCFloats = kGCentres * kGKChunk;

// The block of C2 = kCols columns: 2 row groups x kCols / 64 column groups
// of warps, one block a SM at 256 columns (8 warps), two at 128 (4 warps).
template <int kCols>
struct GroupShape {
  static constexpr int kColGroups = kCols / (8 * kGNT);
  static constexpr int kThreads = 32 * 2 * kColGroups;
  static constexpr int kMinBlocks = 256 / kCols;
  static constexpr int kWFloats = kGKChunk * kCols;
  static constexpr int kStageFloats = kGAFloats + kWFloats + kGCFloats;
  static constexpr size_t kSmem = (size_t)kGStages * kStageFloats * sizeof(float);
  static constexpr int kRowStep = kThreads / (kGKChunk / 4);   // rows apart of a thread's copies
  static constexpr int kMyRows = kGRows / kRowStep;            // rows a thread copies a step
  static_assert(kGRows % kRowStep == 0, "a tile's rows split evenly over the threads");
  static_assert(kThreads >= kGCFloats / 4, "one float4 of the centres' chunk a thread");
};

// a2 (C1, C2) row-major, layer 2's (in, out) -> the order the block reads
// its B fragments in: float2 number
// (((ch * (kGKChunk / 8) + kk) * (C2 / 8) + nt) * 32 + lane) holds
// a2[ch*kGKChunk + kk*8 + lane%4][nt*8 + lane/4] and the value four input
// channels further; rounded for a one-pass product at precision prec, whole
// f32 at kPrecHighest (the kernel splits them).
__global__ void order_group_weights_kernel(const float* __restrict__ a2, int C1, int C2,
                                           float2* __restrict__ frag, int prec) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C1 * C2 / 2) return;
  const int lane = e & 31, tile = e >> 5;
  const int nt = tile % (C2 / 8), rest = tile / (C2 / 8);   // rest = ch * 4 + kk
  const int k = rest * 8 + (lane & 3);
  const int col = nt * 8 + (lane >> 2);
  frag[e] = make_float2(round_operand(prec, a2[(size_t)k * C2 + col]),
                        round_operand(prec, a2[(size_t)(k + 4) * C2 + col]));
}

template <int PREC, int kCols>
__global__ void __launch_bounds__(GroupShape<kCols>::kThreads, GroupShape<kCols>::kMinBlocks)
    knn_group_max_kernel(const int* __restrict__ idx, const float* __restrict__ u,
                         const float* __restrict__ cs, const float2* __restrict__ frag,
                         const float* __restrict__ b2, float* __restrict__ out, int S, int N,
                         int C1) {
  using Sh = GroupShape<kCols>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // [kGStages][A | W | cs]
  const int tiles = (S + kGCentres - 1) / kGCentres;
  const int spans = (tiles + kGTiles - 1) / kGTiles;
  const int b = blockIdx.x / spans;
  const int tile0 = (blockIdx.x - b * spans) * kGTiles;
  const int chunks = C1 / kGKChunk;
  const int steps = min(kGTiles, tiles - tile0) * chunks;
  const int* idxb = idx + (size_t)b * S * kGSlots;
  const float* ub = u + (size_t)b * N * C1;
  const float* csb = cs + (size_t)b * S * C1;

  // the thread's copies of a step: rows r0 + i * kRowStep, float4 q of each
  const int q = threadIdx.x & (kGKChunk / 4 - 1), r0 = threadIdx.x / (kGKChunk / 4);
  int rows[Sh::kMyRows];                         // their database rows, this tile's

  // start the copies of stream step `step` (one commit group, empty past the end)
  auto load = [&](int step) {
    if (step < steps) {
      const int tile = tile0 + step / chunks, ch = step % chunks;
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < Sh::kMyRows; ++i) {
          const int r = r0 + i * Sh::kRowStep;
          const int s = min(tile * kGCentres + r / kGSlots, S - 1);
          rows[i] = __ldg(idxb + (size_t)s * kGSlots + r % kGSlots);
        }
      }
      const int k0 = ch * kGKChunk + 4 * q;
      float* st = smem + (step % kGStages) * Sh::kStageFloats;
#pragma unroll
      for (int i = 0; i < Sh::kMyRows; ++i)
        cp_async16(st + (r0 + i * Sh::kRowStep) * kGAStride + 4 * q,
                   ub + (size_t)rows[i] * C1 + k0, true);
      const float* ws = reinterpret_cast<const float*>(frag) + (size_t)ch * Sh::kWFloats;
      float* sw = st + kGAFloats;
      for (int e = 4 * threadIdx.x; e < Sh::kWFloats; e += 4 * Sh::kThreads)
        cp_async16(sw + e, ws + e, true);
      if (threadIdx.x < kGCFloats / 4) {         // the tile's centres' chunk of cs
        const int s = min(tile * kGCentres + r0, S - 1);
        cp_async16(sw + Sh::kWFloats + r0 * kGKChunk + 4 * q, csb + (size_t)s * C1 + k0,
                   true);
      }
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / Sh::kColGroups, cq = warp % Sh::kColGroups;   // rows rg*64.., columns
  float acc[4][kGNT][4];                         // [row tile of 16][column tile of 8][frag]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kGNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int s = 0; s < kGStages - 1; ++s) load(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();          // step landed; everyone is done with step - 1's buffer
    load(step + kGStages - 1);
    const float* st = smem + (step % kGStages) * Sh::kStageFloats;
    const float* a = st + (rg * 64 + g) * kGAStride + t;
    const float2* wb = reinterpret_cast<const float2*>(st + kGAFloats) + cq * kGNT * 32 + lane;
    const float* cc = st + kGAFloats + Sh::kWFloats + rg * 2 * kGKChunk + t;
#pragma unroll
    for (int kk = 0; kk < kGKChunk / 8; ++kk) {
      float bh[kGNT][2], bl[kGNT][2];            // the weights' halves, split here
#pragma unroll
      for (int nt = 0; nt < kGNT; ++nt) {
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
        const float* p = a + mt * 16 * kGAStride + kk * 8;
        const float* c = cc + (mt >> 1) * kGKChunk + kk * 8;   // the rows' centre
        const float v[4] = {fmaxf(__fadd_rn(p[0], c[0]), 0.f),
                            fmaxf(__fadd_rn(p[8 * kGAStride], c[0]), 0.f),
                            fmaxf(__fadd_rn(p[4], c[4]), 0.f),
                            fmaxf(__fadd_rn(p[8 * kGAStride + 4], c[4]), 0.f)};
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
        // pass by pass over the column tiles: kGNT independent accumulators
        // between two products into the same one
        if (!one_pass(PREC)) {
#pragma unroll
          for (int nt = 0; nt < kGNT; ++nt) mma_tf32(acc[mt][nt], alo, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < kGNT; ++nt) mma_tf32(acc[mt][nt], ahi, bl[nt][0], bl[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < kGNT; ++nt) mma_tf32(acc[mt][nt], ahi, bh[nt][0], bh[nt][1]);
      }
    }
    if ((step + 1) % chunks == 0) {              // the tile's products are done
      const int s0 = (tile0 + step / chunks) * kGCentres + rg * 2;   // the warp's centres
#pragma unroll
      for (int nt = 0; nt < kGNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // rows g, g + 8 of row tiles 0-1 (centre s0) and 2-3 (s0 + 1)
          float m0 = fmaxf(fmaxf(acc[0][nt][j], acc[0][nt][2 + j]),
                           fmaxf(acc[1][nt][j], acc[1][nt][2 + j]));
          float m1 = fmaxf(fmaxf(acc[2][nt][j], acc[2][nt][2 + j]),
                           fmaxf(acc[3][nt][j], acc[3][nt][2 + j]));
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {   // across the 8 lanes of a column
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          if (g == 0) {
            const int col = (cq * kGNT + nt) * 8 + 2 * t + j;
            const float bias = __ldg(b2 + col);
            float* o = out + ((size_t)b * S + s0) * kCols + col;
            if (s0 < S) o[0] = fmaxf(__fadd_rn(m0, bias), 0.f);
            if (s0 + 1 < S) o[kCols] = fmaxf(__fadd_rn(m1, bias), 0.f);
          }
        }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < kGNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
  cp_async_wait<0>();
}

template <int kCols>
cudaError_t launch_group(const int* idx, const float* u, const float* cs, const float2* frag,
                         const float* b2, float* out, int blocks, int S, int N, int C1,
                         int prec, cudaStream_t s) {
  using Kernel = decltype(&knn_group_max_kernel<kPrecHighest, kCols>);
  static const Kernel kernels[3] = {knn_group_max_kernel<kPrecHighest, kCols>,
                                    knn_group_max_kernel<kPrecHigh, kCols>,
                                    knn_group_max_kernel<kPrecDefault, kCols>};
  const Kernel kernel = kernels[prec];
  cudaError_t err;
  if ((err = prepare(kernel, GroupShape<kCols>::kSmem)) != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, GroupShape<kCols>::kThreads, GroupShape<kCols>::kSmem, s>>>(
      idx, u, cs, frag, b2, out, S, N, C1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// idx: (B, S, K) int32, every index in [0, N); u: (B, N, C1); cs: (B, S, C1),
// both on a 16-byte boundary; a2: (C1, C2) layer 2 (in, out) with its
// BatchNorm's scale folded in; b2: (C2,) its shift; out: (B, S, C2).
// scratch: C1 * C2 floats of device memory on a 16-byte boundary (the
// weights in fragment order).  K must be kGSlots (32), C1 a multiple of
// kGKChunk (32), C2 128 or 256.  prec: kPrecHighest, kPrecHigh or
// kPrecDefault.
int iq_knn_group_max(const int* idx, const float* u, const float* cs, const float* a2,
                     const float* b2, float* out, float* scratch, int B, int S, int N, int K,
                     int C1, int C2, int prec, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (prec < kPrecHighest || prec > kPrecDefault || K != kGSlots || N < 1 || C1 < kGKChunk ||
      C1 % kGKChunk || (C2 != 128 && C2 != 256) || (long long)C1 * C2 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long tiles = (S + kGCentres - 1) / kGCentres;
  const long long blocks = (long long)B * ((tiles + kGTiles - 1) / kGTiles);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* frag = reinterpret_cast<float2*>(scratch);
  order_group_weights_kernel<<<(C1 * C2 / 2 + 255) / 256, 256, 0, s>>>(a2, C1, C2, frag, prec);
  if (C2 == 128)
    return launch_group<128>(idx, u, cs, frag, b2, out, (int)blocks, S, N, C1, prec, s);
  return launch_group<256>(idx, u, cs, frag, b2, out, (int)blocks, S, N, C1, prec, s);
}

}  // extern "C"
