// Micro-benchmarks of the two levers for one link of the neural-field
// solve's serial chain (csrc/node_field.cu), at the main path's shape: one
// batch row a block, hidden width 200. Driven by node_field_levers.py.
//
//   bar_block     one block barrier per iteration, 200 floats written to
//                 and read back from the block's own shared memory;
//   bar_cluster   the same exchange across a cluster of 2 blocks: each
//                 block writes its 100 floats to its own and to its peer's
//                 shared memory (distributed shared memory), then one
//                 cluster barrier;
//   layer_reg     relu(h W + b), W 200 x 200, one row, the weights held in
//                 registers (416 threads: 52 groups of 4 columns x 8
//                 slices of the reduction, 100 weights a thread);
//   layer_smem    the same layer with the same thread layout, the weights
//                 read from shared memory with one 16-byte load per 4.
// Each iteration feeds its output back as the next input, so the loop is a
// serial chain like the solve's; the time per iteration is one link.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 200;          // layer width
constexpr int kThreads = 416;    // 13 warps
constexpr int kKS = kN / 8;      // reduction values per slice

__global__ void __launch_bounds__(kThreads, 1)
bar_block(float* __restrict__ out, int iters) {
  __shared__ float buf[2][256];
  const int tid = threadIdx.x;
  float v = (float)tid;
  for (int i = 0; i < iters; ++i) {
    if (tid < kN) buf[i & 1][tid] = v;
    __syncthreads();
    v = buf[i & 1][(tid + 1) % kN] * 0.5f + 1.f;
  }
  if (tid < kN) out[blockIdx.x * kN + tid] = v;
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
bar_cluster(float* __restrict__ out, int iters) {
  __shared__ float buf[2][256];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  float* peer = cl.map_shared_rank(&buf[0][0], rank ^ 1u);
  const int tid = threadIdx.x;
  float v = (float)tid;
  cl.sync();
  for (int i = 0; i < iters; ++i) {
    if (tid < kN / 2) {
      const int idx = (int)rank * (kN / 2) + tid;
      buf[i & 1][idx] = v;
      peer[(i & 1) * 256 + idx] = v;
    }
    cl.sync();
    v = buf[i & 1][(tid + 1) % kN] * 0.5f + 1.f;
  }
  if (tid < kN) out[blockIdx.x * kN + tid] = v;
  cl.sync();   // no block exits while its peer may still write to it
}

template <bool REG>
__global__ void __launch_bounds__(kThreads, 1)
layer(const float* __restrict__ W, const float* __restrict__ b,
      float* __restrict__ out, int iters) {
  extern __shared__ __align__(16) float sm[];
  float* h = sm;                 // 2 x 256
  float* ws = sm + 512;          // kN * kN when !REG
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int slice = lane >> 2;   // 4 column groups a warp, 8 slices
  const int cgp = warp * 4 + (lane & 3);
  const bool live = cgp < kN / 4;
  const int n0 = live ? cgp * 4 : 0;
  float wr[REG ? 4 * kKS : 1];
  if (REG) {
#pragma unroll
    for (int i = 0; i < kKS; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wr[c * kKS + i] = live ? W[(slice + 8 * i) * kN + n0 + c] : 0.f;
  } else {
    for (int e = tid; e < kN * kN; e += blockDim.x) ws[e] = W[e];
  }
  for (int e = tid; e < 512; e += blockDim.x) h[e] = 0.01f * (e & 255);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const float* in = h + (it & 1) * 256;
    float* o = h + ((it + 1) & 1) * 256;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKS; ++i) {
      const int k = slice + 8 * i;
      const float x = in[k];
      if (REG) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(x, wr[c * kKS + i], acc[c]);
      } else {
        const float4 q = *reinterpret_cast<const float4*>(ws + k * kN + n0);
        acc[0] = fmaf(x, q.x, acc[0]);
        acc[1] = fmaf(x, q.y, acc[1]);
        acc[2] = fmaf(x, q.z, acc[2]);
        acc[3] = fmaf(x, q.w, acc[3]);
      }
    }
    // reduce-scatter over the 8 slices (lane bits 2..4): 4 -> 2 -> 1 sums
    const int s0 = slice & 1, s1 = (slice >> 1) & 1;
    {
      const float send0 = s0 ? acc[0] : acc[2], keep0 = s0 ? acc[2] : acc[0];
      const float send1 = s0 ? acc[1] : acc[3], keep1 = s0 ? acc[3] : acc[1];
      acc[0] = keep0 + __shfl_xor_sync(0xffffffffu, send0, 4);
      acc[1] = keep1 + __shfl_xor_sync(0xffffffffu, send1, 4);
    }
    {
      const float send = s1 ? acc[0] : acc[1], keep = s1 ? acc[1] : acc[0];
      acc[0] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 16);
    if (live && slice < 4) {
      const int n = n0 + s0 * 2 + s1;
      o[n] = fmaxf(acc[0] + __ldg(b + n), 0.f) * 0.05f + 0.01f;
    }
    __syncthreads();
  }
  if (tid < kN) out[blockIdx.x * kN + tid] = h[(iters & 1) * 256 + tid];
}

}  // namespace

// which: 0 bar_block, 1 bar_cluster, 2 layer_reg, 3 layer_smem. `blocks`
// blocks of 416 threads (bar_cluster: 2 * blocks). W (200, 200), b (200,),
// out (2 * blocks, 200) on the device. Returns a cudaError_t.
extern "C" int ldq_lever_run(int which, int blocks, int iters, const float* W,
                             const float* b, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (which) {
    case 0:
      bar_block<<<blocks, kThreads, 0, st>>>(out, iters);
      break;
    case 1:
      bar_cluster<<<2 * blocks, kThreads, 0, st>>>(out, iters);
      break;
    case 2:
      layer<true><<<blocks, kThreads, 512 * sizeof(float), st>>>(W, b, out,
                                                                 iters);
      break;
    case 3: {
      const int bytes = (512 + kN * kN) * sizeof(float);
      cudaError_t e = cudaFuncSetAttribute(
          layer<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return (int)e;
      layer<false><<<blocks, kThreads, bytes, st>>>(W, b, out, iters);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
