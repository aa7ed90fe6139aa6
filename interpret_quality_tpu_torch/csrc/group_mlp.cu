// PointMLP's grouped residual chain for Hopper (sm_90a), kernel 11: the
// gather of each centre's kNN group, the stage's transfer (hoisted above the
// gather), two residual blocks of two layers each and the max over the group,
// in one launch (bound with ctypes from
// interpret_quality_tpu_torch/ops/cuda/group_mlp.py):
//
//   iq_group_res_mlp   out[b, s, o] = max_j R2(R1(h0[b, s, j]))[o]
//                      h0[b, s, j, c] = relu(sig[b] (u[b, idx[b, s, j], c] - u[b, fps[b, s], c])
//                                            + cs[b, s, c])
//                      R(x) = relu(relu(x a1 + b1) a2 + b2 + x)
//
// with sig[b] = 1 / (std_b + 1e-5), each cloud's normalisation, u the
// transfer layer's share of the neighbours on the N points, fps[b, s] the
// centre's own row and cs its share, BatchNorm folded into every (a, b).
// The centre's row is taken off before the scale: where sigma_b is near 0
// (a cloud collapsed to one point: sig = 1e5) a term -sig u[fps] folded into
// cs would leave cs nothing of its own share but rounding.
//
// Replaces no TPU kernel: the JAX package has no PointMLP.  In plain PyTorch
// a stage writes several (B, S, 24, C) tensors to device memory, 10.4 GB
// each at a forward of 1650 clouds, at every stage.
//
// What bounds it on H100: operations.  The four C x C products cost
// 4 C^2 multiply-adds a slot: 12.1 G a cloud over the four stages, on the
// tensor cores at the matmul precision `prec` (mma_tf32.cuh): three TF32
// products at kPrecHighest (f32 accuracy), one at kPrecHigh and
// kPrecDefault.  Its bytes (the indices, u, cs, sig, the weights and the
// output, each once) are under 1.5 GB a stage.  The gathered rows, u[idx]
// and u[fps], read 10.4 GB a stage, mostly from L2.
//
// The design.  A tile is two centres x 24 slots = 48 rows (three m16 row
// tiles of mma.sync); a block owns all of a tile's columns.  The tile's
// activations live in one shared-memory buffer P (48 x C, row stride C + 4:
// 197 KB at C = 1024), which is the A operand of every product; layer
// weights stream through a ring of kStages chunks of 8 input rows x Wc
// columns (Wc = min(C, 256)), filled with cp.async from the order
// order_res_weights_kernel wrote once a launch.  A layer runs in C / Wc
// column passes; each warp owns 48 rows x 32 columns of a pass (48
// accumulators a thread).  A layer's output cannot go to P while P is still
// being read, and a second 48 x C buffer does not fit beside P at C = 1024,
// so each layer's epilogue (bias, residual, ReLU) writes to a per-block
// scratch in device memory, two 48 x C buffers G0, G1 (393 KB a block at
// C = 1024, 52 MB for the 132 blocks of a full card, written and read back
// within a tile, so mostly in L2), and the block copies the result back into
// P between layers:
//
//   tile start   h0 -> P and G1 (the gathers and the transfer's ReLU, in f32)
//   layer 0      relu(P a1 + b1) -> G0;                 G0 -> P
//   layer 1      relu(P a2 + b2 + G1) -> G0  (= y1);     G0 -> P
//   layer 2      relu(P a3 + b3) -> G1;                 G1 -> P
//   layer 3      relu(P a4 + b4 + G0), max over each centre's 24 rows -> out
//
// Nothing of size (B, S, 24, C) reaches device memory beyond the scratch.
// The blocks are persistent (as many as fit on the card, each walking tiles
// blockIdx.x, + gridDim.x, ...), and the weight stream runs across layer and
// tile boundaries.  Shared memory: 48 (C + 4) + kStages 8 Wc floats: 41.7,
// 82.7, 131.8 and 230.1 KB at C = 128, 256, 512 and 1024 (4, 8, 8 and 8
// warps); one block a SM from C = 512 up.  ptxas: 118 registers at C = 512
// and 1024, 128 at 256 and 138 at 128 (kPrecHighest; 80-190 at the one-pass
// settings), no spill.  Each weight byte streams once a
// tile, so at C = 1024 the tile's 16 MB of weights per 48 rows make L2, not
// the tensor cores, the likely limit there (a larger tile over a cluster's
// shared memory is the next step).  The order of every sum is fixed and
// nothing is atomic: the result is deterministic.  Rows of a ragged last
// tile read the last centre and are not stored.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for arguments the
// kernel does not take.

#include "knn_select.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kRSlots = 24;                     // neighbours of a centre (K)
constexpr int kRCentres = 2;                    // centres of a tile
constexpr int kRRows = kRCentres * kRSlots;     // rows of a tile: three m16 tiles
constexpr int kRMTiles = kRRows / 16;
constexpr int kRKChunk = 8;                     // input rows of a stream step
constexpr int kRMaxStages = 4;                  // ring buffers, as many as fit up to this
constexpr int kRNT = 4;                         // column tiles of 8 a warp: 32 columns
constexpr int kRMaxPass = 256;                  // columns of a pass at most
constexpr int kRLayers = 4;                     // two residual blocks of two layers

template <int kCols>
struct ResShape {
  static constexpr int kPass = kCols < kRMaxPass ? kCols : kRMaxPass;   // columns of a pass
  static constexpr int kPasses = kCols / kPass;
  static constexpr int kWarps = kPass / (8 * kRNT);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStride = kCols + 4;                   // P's row stride: conflict-free
  static constexpr int kPFloats = kRRows * kStride;
  static constexpr int kWFloats = kRKChunk * kPass;           // a ring buffer
  static constexpr int kFit = (kMaxSmem / 4 - kPFloats) / kWFloats;
  static constexpr int kStages = kFit < kRMaxStages ? kFit : kRMaxStages;
  static constexpr int kChunks = kCols / kRKChunk;
  static constexpr int kTileSteps = kRLayers * kPasses * kChunks;
  static constexpr size_t kSmem = (size_t)(kPFloats + kStages * kWFloats) * sizeof(float);
  static constexpr size_t kScratch = (size_t)2 * kRRows * kCols;   // G0, G1 a block
  static_assert(kStages >= 2, "two ring buffers fit beside P");
  static_assert(kWFloats % (4 * kThreads) == 0,
                "a ring buffer's float4s split evenly over the threads");
};

// a (4, C, C): the four layers' (in, out) products, row-major -> the order
// the block streams them in: float2 number
// ((((l * passes + p) * (C / 8) + ch) * (Wc / 8) + nt) * 32 + lane) holds
// a[l][ch*8 + lane%4][p*Wc + nt*8 + lane/4] and the value four input rows
// further; rounded for a one-pass product at precision prec, whole f32 at
// kPrecHighest (the kernel splits them).
__global__ void order_res_weights_kernel(const float* __restrict__ a, int C, int Wc,
                                         float2* __restrict__ frag, int prec) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kRLayers * C * C / 2) return;
  const int lane = e & 31, tile = e >> 5;
  const int nts = Wc / 8, chunks = C / 8, passes = C / Wc;
  const int nt = tile % nts, ch = (tile / nts) % chunks;
  const int p = (tile / (nts * chunks)) % passes, l = tile / (nts * chunks * passes);
  const int k = ch * 8 + (lane & 3);
  const int col = p * Wc + nt * 8 + (lane >> 2);
  const float* al = a + (size_t)l * C * C;
  frag[e] = make_float2(round_operand(prec, al[(size_t)k * C + col]),
                        round_operand(prec, al[(size_t)(k + 4) * C + col]));
}

template <int PREC, int kCols>
__global__ void __launch_bounds__(ResShape<kCols>::kThreads)
    group_res_mlp_kernel(const int* __restrict__ idx, const int* __restrict__ fps,
                         const float* __restrict__ u,
                         const float* __restrict__ cs, const float* __restrict__ sig,
                         const float2* __restrict__ frag, const float* __restrict__ bias,
                         float* __restrict__ out, float* scratch, int S, int N, int centres) {
  using Sh = ResShape<kCols>;
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);          // [kRRows][kStride]
  float* ring = P + Sh::kPFloats;                      // [kStages][kWFloats]
  float* G0 = scratch + (size_t)blockIdx.x * Sh::kScratch;
  float* G1 = G0 + (size_t)kRRows * kCols;
  const int tiles = (centres + kRCentres - 1) / kRCentres;
  if ((int)blockIdx.x >= tiles) return;
  const int my_tiles = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int steps = my_tiles * Sh::kTileSteps;

  // h0 of tile `tile` into P and G1: relu(sig (u[idx] - u[fps]) + cs), in f32
  auto build_h0 = [&](int tile) {
    for (int e = threadIdx.x; e < kRRows * kCols / 4; e += Sh::kThreads) {
      const int r = e / (kCols / 4), q = e % (kCols / 4);
      const int fc = min(tile * kRCentres + r / kRSlots, centres - 1);
      const int b = fc / S;
      const int i = __ldg(idx + (size_t)fc * kRSlots + r % kRSlots);
      const int i0 = __ldg(fps + fc);
      const float4* ub = reinterpret_cast<const float4*>(u + (size_t)b * N * kCols);
      const float4 uv = __ldg(ub + (size_t)i * (kCols / 4) + q);
      const float4 u0 = __ldg(ub + (size_t)i0 * (kCols / 4) + q);
      const float4 cv = __ldg(reinterpret_cast<const float4*>(cs + (size_t)fc * kCols) + q);
      const float sb = __ldg(sig + b);
      const float4 h =
          make_float4(fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(uv.x, u0.x), sb), cv.x), 0.f),
                      fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(uv.y, u0.y), sb), cv.y), 0.f),
                      fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(uv.z, u0.z), sb), cv.z), 0.f),
                      fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(uv.w, u0.w), sb), cv.w), 0.f));
      *reinterpret_cast<float4*>(P + r * Sh::kStride + 4 * q) = h;
      reinterpret_cast<float4*>(G1)[e] = h;
    }
  };
  // a layer's output, written to G by every thread, into P (read through L2:
  // this block wrote it, after a __syncthreads)
  auto load_p = [&](const float* G) {
    for (int e = threadIdx.x; e < kRRows * kCols / 4; e += Sh::kThreads) {
      const int r = e / (kCols / 4), q = e % (kCols / 4);
      *reinterpret_cast<float4*>(P + r * Sh::kStride + 4 * q) =
          __ldcg(reinterpret_cast<const float4*>(G) + e);
    }
  };
  // start the copies of stream step `step` (one commit group, empty past the end)
  auto load = [&](int step) {
    if (step < steps) {
      const float* ws = reinterpret_cast<const float*>(frag) +
                        (size_t)(step % Sh::kTileSteps) * Sh::kWFloats;
      float* st = ring + (step % Sh::kStages) * Sh::kWFloats;
      for (int e = 4 * threadIdx.x; e < Sh::kWFloats; e += 4 * Sh::kThreads)
        cp_async16(st + e, ws + e, true);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[kRMTiles][kRNT][4];
#pragma unroll
  for (int mt = 0; mt < kRMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kRNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int s = 0; s < Sh::kStages - 1; ++s) load(s);
  build_h0(blockIdx.x);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<Sh::kStages - 2>();
    __syncthreads();          // step landed; everyone is done with step - 1's buffer
    load(step + Sh::kStages - 1);
    const int in_tile = step % Sh::kTileSteps;
    const int ch = in_tile % Sh::kChunks;
    const int pass = (in_tile / Sh::kChunks) % Sh::kPasses;
    const int layer = in_tile / (Sh::kChunks * Sh::kPasses);
    const float2* wbuf =
        reinterpret_cast<const float2*>(ring + (step % Sh::kStages) * Sh::kWFloats) +
        warp * kRNT * 32 + lane;
#pragma unroll
    for (int kk = 0; kk < kRKChunk / 8; ++kk) {
      const float* a = P + g * Sh::kStride + ch * kRKChunk + kk * 8 + t;
      const float2* wb = wbuf + kk * (Sh::kPass / 8) * 32;
      float bh[kRNT][2], bl[kRNT][2];              // the weights' halves, split here
#pragma unroll
      for (int nt = 0; nt < kRNT; ++nt) {
        const float2 w = wb[nt * 32];
        if (one_pass(PREC)) {                      // rounded already
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
      for (int mt = 0; mt < kRMTiles; ++mt) {
        const float* p = a + mt * 16 * Sh::kStride;
        const float v[4] = {p[0], p[8 * Sh::kStride], p[4], p[8 * Sh::kStride + 4]};
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
        if (!one_pass(PREC)) {
#pragma unroll
          for (int nt = 0; nt < kRNT; ++nt) mma_tf32(acc[mt][nt], alo, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < kRNT; ++nt) mma_tf32(acc[mt][nt], ahi, bl[nt][0], bl[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < kRNT; ++nt) mma_tf32(acc[mt][nt], ahi, bh[nt][0], bh[nt][1]);
      }
    }
    if (ch != Sh::kChunks - 1) continue;

    // the pass's products are done: bias, residual, ReLU
    const int tile = blockIdx.x + (step / Sh::kTileSteps) * gridDim.x;
    const float* bl_ = bias + layer * kCols;
    if (layer < kRLayers - 1) {
      float* dst = layer == 2 ? G1 : G0;
      const float* res = layer == 1 ? G1 : nullptr;
#pragma unroll
      for (int nt = 0; nt < kRNT; ++nt) {
        const int col = pass * Sh::kPass + (warp * kRNT + nt) * 8 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bl_ + col);
#pragma unroll
        for (int mt = 0; mt < kRMTiles; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t at = (size_t)(mt * 16 + g + 8 * h) * kCols + col;
            float y0 = __fadd_rn(acc[mt][nt][2 * h], bb.x);
            float y1 = __fadd_rn(acc[mt][nt][2 * h + 1], bb.y);
            if (res != nullptr) {
              const float2 x = __ldcg(reinterpret_cast<const float2*>(res + at));
              y0 = __fadd_rn(y0, x.x);
              y1 = __fadd_rn(y1, x.y);
            }
            *reinterpret_cast<float2*>(dst + at) = make_float2(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
          }
      }
    } else {              // residual y1 (G0), ReLU, the max over each centre's rows
#pragma unroll
      for (int nt = 0; nt < kRNT; ++nt) {
        const int col = pass * Sh::kPass + (warp * kRNT + nt) * 8 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bl_ + col);
        float z[kRMTiles][4];
#pragma unroll
        for (int mt = 0; mt < kRMTiles; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 x = __ldcg(reinterpret_cast<const float2*>(
                G0 + (size_t)(mt * 16 + g + 8 * h) * kCols + col));
            z[mt][2 * h] = fmaxf(__fadd_rn(__fadd_rn(acc[mt][nt][2 * h], bb.x), x.x), 0.f);
            z[mt][2 * h + 1] =
                fmaxf(__fadd_rn(__fadd_rn(acc[mt][nt][2 * h + 1], bb.y), x.y), 0.f);
          }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // centre 0: rows g, g + 8, g + 16; centre 1: rows g + 24, g + 32, g + 40
          float m0 = fmaxf(fmaxf(z[0][j], z[0][2 + j]), z[1][j]);
          float m1 = fmaxf(fmaxf(z[1][2 + j], z[2][j]), z[2][2 + j]);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {   // across the 8 lanes of a column
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          if (g == 0) {
            const int fc = tile * kRCentres;
            if (fc < centres) out[(size_t)fc * kCols + col + j] = m0;
            if (fc + 1 < centres) out[(size_t)(fc + 1) * kCols + col + j] = m1;
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kRMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kRNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    if (pass != Sh::kPasses - 1) continue;

    // the layer is done: its output into P, or the next tile's h0
    __syncthreads();
    if (layer < kRLayers - 1) {
      load_p(layer == 2 ? G1 : G0);
    } else if (step + 1 < steps) {
      build_h0(tile + gridDim.x);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int PREC, int kCols>
cudaError_t occupancy(int* blocks) {
  using Sh = ResShape<kCols>;
  cudaError_t err;
  const auto kernel = group_res_mlp_kernel<PREC, kCols>;
  if ((err = prepare(kernel, Sh::kSmem)) != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Sh::kThreads,
                                                           Sh::kSmem)) != cudaSuccess)
    return err;
  *blocks = sms * per_sm;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int kCols>
cudaError_t capacity(int prec, int* blocks) {
  if (prec == kPrecHigh) return occupancy<kPrecHigh, kCols>(blocks);
  if (prec == kPrecDefault) return occupancy<kPrecDefault, kCols>(blocks);
  return occupancy<kPrecHighest, kCols>(blocks);
}

template <int kCols>
cudaError_t launch_res(const int* idx, const int* fps, const float* u, const float* cs,
                       const float* sig, const float2* frag, const float* bias, float* out,
                       float* scratch, int grid, int S, int N, int centres, int prec,
                       cudaStream_t s) {
  using Sh = ResShape<kCols>;
  using Kernel = decltype(&group_res_mlp_kernel<kPrecHighest, kCols>);
  static const Kernel kernels[3] = {group_res_mlp_kernel<kPrecHighest, kCols>,
                                    group_res_mlp_kernel<kPrecHigh, kCols>,
                                    group_res_mlp_kernel<kPrecDefault, kCols>};
  const Kernel kernel = kernels[prec];
  cudaError_t err;
  if ((err = prepare(kernel, Sh::kSmem)) != cudaSuccess) return err;
  kernel<<<(unsigned)grid, Sh::kThreads, Sh::kSmem, s>>>(idx, fps, u, cs, sig, frag, bias,
                                                        out, scratch, S, N, centres);
  return cudaGetLastError();
}

bool width_ok(int C) { return C == 128 || C == 256 || C == 512 || C == 1024; }

}  // namespace

extern "C" {

// The blocks that fit on the current card at once for width C and precision
// prec (the launcher's grid at most; the activation scratch holds
// 2 * 48 * C floats for each), written to *blocks.
int iq_group_res_mlp_capacity(int C, int prec, int* blocks) {
  if (!width_ok(C) || prec < kPrecHighest || prec > kPrecDefault) return cudaErrorInvalidValue;
  switch (C) {
    case 128: return capacity<128>(prec, blocks);
    case 256: return capacity<256>(prec, blocks);
    case 512: return capacity<512>(prec, blocks);
    default: return capacity<1024>(prec, blocks);
  }
}

// idx: (B, S, K) int32 and fps: (B, S) int32, every index in [0, N): each
// centre's neighbours and its own row; u: (B, N, C); cs: (B, S, C),
// both on a 16-byte boundary; sig: (B,) each cloud's 1 / (std + eps);
// a: (4, C, C) the four layers' (in, out) products with their BatchNorms'
// scales folded in; bias: (4, C) their shifts; out: (B, S, C).  scratch:
// 4 C^2 floats (the weights in stream order) and then 2 * 48 * C floats for
// each of `grid` blocks, on a 16-byte boundary; grid at most what
// iq_group_res_mlp_capacity gave.  K must be kRSlots (24), C 128, 256, 512
// or 1024.  prec: kPrecHighest, kPrecHigh or kPrecDefault.
int iq_group_res_mlp(const int* idx, const int* fps, const float* u, const float* cs,
                     const float* sig, const float* a, const float* bias, float* out,
                     float* scratch, int grid, int B, int S, int N, int K, int C, int prec,
                     void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (prec < kPrecHighest || prec > kPrecDefault || K != kRSlots || N < 1 || !width_ok(C) ||
      grid < 1 || (long long)B * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int centres = B * S;
  const int tiles = (centres + kRCentres - 1) / kRCentres;
  grid = grid < tiles ? grid : tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* frag = reinterpret_cast<float2*>(scratch);
  float* act = scratch + (size_t)kRLayers * C * C;
  const int Wc = C < kRMaxPass ? C : kRMaxPass;
  order_res_weights_kernel<<<(kRLayers * C * C / 2 + 255) / 256, 256, 0, s>>>(a, C, Wc, frag,
                                                                              prec);
  switch (C) {
    case 128:
      return launch_res<128>(idx, fps, u, cs, sig, frag, bias, out, act, grid, S, N, centres,
                             prec, s);
    case 256:
      return launch_res<256>(idx, fps, u, cs, sig, frag, bias, out, act, grid, S, N, centres,
                             prec, s);
    case 512:
      return launch_res<512>(idx, fps, u, cs, sig, frag, bias, out, act, grid, S, N, centres,
                             prec, s);
    default:
      return launch_res<1024>(idx, fps, u, cs, sig, frag, bias, out, act, grid, S, N, centres,
                              prec, s);
  }
}

}  // extern "C"
