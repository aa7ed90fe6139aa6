// Farthest-point sampling for Hopper (sm_90a), plain C launchers bound with
// ctypes from interpret_quality_tpu_torch/ops/cuda/fps.py:
//
//   iq_fps            (B, N, 3) f32 -> (B, npoint) int32
//                     replaces interpret_quality_tpu/ops/pallas/fps.py
//                     fps_pallas -> _fps_kernel
//   iq_fps_occupancy  which route an N takes and how many of its blocks fit
//                     one SM (for the record; it launches nothing)
//
// Semantics are those of the plain version (ops/geometry.farthest_point_sample):
// the first index is 0; each step records the current index, folds its
// squared distance d = (dx*dx + dy*dy) + dz*dz into the running minimum
// (started at 1e10), and takes the argmax of that minimum with ties to the
// lowest index.  FPS is chaotic (one different argmax changes every index
// after it) and masked coalitions put whole regions on one point, so exact
// ties are everywhere: the kernel must agree with the plain version bit for
// bit.  Every operation is a separately rounded f32 intrinsic
// (__fsub_rn / __fmul_rn / __fadd_rn), so nvcc cannot contract a*b+c into
// an FMA, and the distances equal PyTorch's elementwise ones exactly.
// npoint > N simply keeps going, as the plain version does.
//
// What bounds it on H100: neither bytes nor operations (about 10*N*npoint
// FLOP per cloud, 0.15 ms of f32 arithmetic for 1650 clouds at 1024 -> 512
// -> 128) but the chain of npoint block-wide argmaxes.  That bound cannot be
// reached by a sequential chain; the chain's own floor is
//   steps x (one distance update + one reduce-and-barrier),
// a few hundred cycles a step for a block alone on its SM (640 steps a
// forward), and with every cloud of the batch resident at once the SMs'
// instruction issue: twelve instructions per point and step, none of them
// fusable without changing the rounding.
//
// The design, one block of 128 threads per cloud:
//   * a thread owns PPT = 1, 2, 4 or 8 points (index tid + i*128) and keeps
//     their coordinates and running minimum in registers for the whole loop;
//     a step reads nothing from shared memory but the chosen point's three
//     coordinates (a broadcast) and writes nothing back.  The coordinates
//     stay in shared memory only for that look-up (12 KB at N = 1024);
//   * distances are >= 0, so their f32 bits order as unsigned integers: a
//     warp's argmax is __reduce_max_sync on the bits and __reduce_min_sync on
//     the indices of the lanes that hold the maximum, two warp operations
//     where a shuffle tree needs ten shuffles and ten compares.  The
//     thread-local scan keeps a strict > in ascending index, so the lowest
//     index wins whatever the layout;
//   * one barrier a step: each warp writes its candidate to a slot of a
//     double-buffered array (slot[it & 1][warp]), one __syncthreads, and
//     every thread folds the four slots itself;
//   * slots beyond N hold distance 0 at an index >= N: they can tie only at
//     0, where the real index 0 is lower.
// N <= 1024 takes this route (PPT the smallest that holds N); a larger N
// takes the generic kernel below, which keeps the cloud and its running
// minimum in shared memory (256 threads, two barriers a step, N up to
// 14528).  Neither is a fallback to the plain version.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for a cloud that
// does not fit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // generic route: threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;        // opt-in shared memory of one block
constexpr int kRegThreads = 128;        // register route: threads per block
constexpr int kRegWarps = kRegThreads / 32;
constexpr int kMaxPpt = 8;              // register route: N <= kRegThreads * kMaxPpt
// blocks of the register route that the compiler is asked to fit on one SM:
// 1650 clouds on 132 SMs are 12.5 a SM, but 12 blocks leave a thread 40
// registers, which spills at 8 points a thread, and 16 leave 32; 10 (48
// registers, no spill, two waves) measured fastest of the three (PERF.md)
constexpr int kRegBlocksPerSm = 10;

// ---------------------------------------------------------- register route
template <int PPT>
__global__ void __launch_bounds__(kRegThreads, kRegBlocksPerSm)
fps_reg_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int N, int npoint) {
  extern __shared__ float smem[];
  float* xs = smem;          // [N] coordinates, one plane each
  float* ys = xs + N;
  float* zs = ys + N;
  __shared__ uint2 slot[2][kRegWarps];   // (distance bits, index) of each warp

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src = xyz + (size_t)blockIdx.x * N * 3;
  for (int e = threadIdx.x; e < N; e += kRegThreads) {
    xs[e] = src[3 * e];
    ys[e] = src[3 * e + 1];
    zs[e] = src[3 * e + 2];
  }
  __syncthreads();
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int e = threadIdx.x + i * kRegThreads;
    const bool real = e < N;
    px[i] = real ? xs[e] : 0.f;
    py[i] = real ? ys[e] : 0.f;
    pz[i] = real ? zs[e] : 0.f;
    dist[i] = real ? 1e10f : 0.f;
  }
  int32_t* o = out + (size_t)blockIdx.x * npoint;
  int farthest = 0;

  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) o[it] = farthest;
    const float cx = xs[farthest], cy = ys[farthest], cz = zs[farthest];
    float bd = -1.f;           // distances are >= 0: the first point always wins
    int bi = 0;                // which of the thread's points: index tid + bi * 128
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float dx = __fsub_rn(px[i], cx);
      const float dy = __fsub_rn(py[i], cy);
      const float dz = __fsub_rn(pz[i], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float nd = fminf(dist[i], d);
      dist[i] = nd;
      if (nd > bd) {           // the index ascends with i: a tie keeps the lower
        bd = nd;
        bi = i;
      }
    }
    bi = threadIdx.x + bi * kRegThreads;
    const unsigned bits = __float_as_uint(bd);
    const unsigned wmax = __reduce_max_sync(0xffffffffu, bits);
    const unsigned wmin =
        __reduce_min_sync(0xffffffffu, bits == wmax ? (unsigned)bi : 0xffffffffu);
    if (lane == 0) slot[it & 1][warp] = make_uint2(wmax, wmin);
    __syncthreads();
    // every thread folds the warps' candidates; the other buffer is written
    // next step, and this one again only after the next barrier
    uint2 best = slot[it & 1][0];
#pragma unroll
    for (int w = 1; w < kRegWarps; ++w) {
      const uint2 s = slot[it & 1][w];
      if (s.x > best.x || (s.x == best.x && s.y < best.y)) best = s;
    }
    farthest = (int)best.y;
  }
}

// ----------------------------------------------------------- generic route
// (d, i) beats (bd, bi): a larger distance, or an equal one at a lower index
__device__ __forceinline__ bool beats(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& bd, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_down_sync(0xffffffffu, bd, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (beats(od, oi, bd, bi)) {
      bd = od;
      bi = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int N, int npoint) {
  extern __shared__ float smem[];
  float* xs = smem;          // [N] coordinates, one plane each
  float* ys = xs + N;
  float* zs = ys + N;
  float* dist = zs + N;      // [N] running minimum distance
  __shared__ float warp_d[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int farthest_s;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src = xyz + (size_t)blockIdx.x * N * 3;
  for (int e = threadIdx.x; e < N; e += kThreads) {
    xs[e] = src[3 * e];
    ys[e] = src[3 * e + 1];
    zs[e] = src[3 * e + 2];
    dist[e] = 1e10f;
  }
  int32_t* o = out + (size_t)blockIdx.x * npoint;
  int farthest = 0;
  __syncthreads();

  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) o[it] = farthest;
    const float cx = xs[farthest], cy = ys[farthest], cz = zs[farthest];
    // distances are >= 0, so (-1, N) loses to every real point
    float bd = -1.f;
    int bi = N;
    for (int e = threadIdx.x; e < N; e += kThreads) {
      const float dx = __fsub_rn(xs[e], cx);
      const float dy = __fsub_rn(ys[e], cy);
      const float dz = __fsub_rn(zs[e], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float nd = fminf(dist[e], d);
      dist[e] = nd;
      if (nd > bd) {           // e ascends: a tie keeps the lower index
        bd = nd;
        bi = e;
      }
    }
    warp_argmax(bd, bi);
    if (lane == 0) {
      warp_d[warp] = bd;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bd = lane < kWarps ? warp_d[lane] : -1.f;
      bi = lane < kWarps ? warp_i[lane] : N;
      warp_argmax(bd, bi);
      if (lane == 0) farthest_s = bi;
    }
    __syncthreads();
    farthest = farthest_s;
  }
}

// points per thread of the register route for a cloud of N points; 0: generic
int reg_ppt(int N) {
  for (int ppt = 1; ppt <= kMaxPpt; ppt *= 2)
    if (N <= kRegThreads * ppt) return ppt;
  return 0;
}

// the register route's kernel for ppt points a thread, readied for its
// shared memory (the whole carve-out, so that kRegBlocksPerSm blocks fit)
template <int PPT>
cudaError_t ready_reg(void (**kernel)(const float*, int32_t*, int, int)) {
  *kernel = fps_reg_kernel<PPT>;
  return cudaFuncSetAttribute(fps_reg_kernel<PPT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t reg_kernel(int ppt, void (**kernel)(const float*, int32_t*, int, int)) {
  switch (ppt) {
    case 1: return ready_reg<1>(kernel);
    case 2: return ready_reg<2>(kernel);
    case 4: return ready_reg<4>(kernel);
    default: return ready_reg<8>(kernel);
  }
}

}  // namespace

extern "C" {

int iq_fps(const float* xyz, int32_t* out, int B, int N, int npoint, void* stream) {
  if (B <= 0 || npoint <= 0) return cudaSuccess;
  if (N < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int ppt = reg_ppt(N);
  if (ppt > 0) {
    void (*kernel)(const float*, int32_t*, int, int);
    if ((err = reg_kernel(ppt, &kernel)) != cudaSuccess) return err;
    kernel<<<(unsigned)B, kRegThreads, (size_t)3 * N * sizeof(float), s>>>(xyz, out, N,
                                                                            npoint);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)4 * N * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<<<(unsigned)B, kThreads, smem, s>>>(xyz, out, N, npoint);
  return cudaGetLastError();
}

// info[0]: points per thread of the register route (0: the generic route),
// info[1]: threads per block, info[2]: blocks of that kernel one SM holds at
// this N, info[3]: SMs of the current device.
int iq_fps_occupancy(int N, int* info) {
  if (N < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&info[3], cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  info[0] = reg_ppt(N);
  if (info[0] > 0) {
    void (*kernel)(const float*, int32_t*, int, int);
    if ((err = reg_kernel(info[0], &kernel)) != cudaSuccess) return err;
    info[1] = kRegThreads;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, kRegThreads,
                                                         (size_t)3 * N * sizeof(float));
  }
  const size_t smem = (size_t)4 * N * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  info[1] = kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], fps_kernel, kThreads, smem);
}

}  // extern "C"
