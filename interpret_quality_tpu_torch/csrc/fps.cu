// Farthest-point sampling for Hopper (sm_90a), one plain C launcher bound
// with ctypes from interpret_quality_tpu_torch/ops/cuda/fps.py:
//
//   iq_fps   (B, N, 3) f32 -> (B, npoint) int32
//            replaces interpret_quality_tpu/ops/pallas/fps.py fps_pallas -> _fps_kernel
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
// What bounds it on H100: neither bytes nor operations but the sequential
// chain of npoint block-wide argmaxes (about 10*N*npoint FLOP per cloud, a
// few hundred microseconds of arithmetic for 1650 clouds).  The design gives
// one block to each cloud and keeps the cloud and its running minimum in
// shared memory for the whole loop, so device memory is read once and each
// step costs two barriers: a warp-shuffle argmax, then one across warps.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for a cloud that
// does not fit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads per block (one block per cloud)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;        // opt-in shared memory of one block

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

}  // namespace

extern "C" {

int iq_fps(const float* xyz, int32_t* out, int B, int N, int npoint, void* stream) {
  if (B <= 0 || npoint <= 0) return cudaSuccess;
  const size_t smem = (size_t)4 * N * sizeof(float);
  if (N < 1 || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<<<(unsigned)B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, out, N, npoint);
  return cudaGetLastError();
}

}  // extern "C"
