// GOKU encoder heads: all three recurrent stacks over the whole sequence in
// one kernel.
//
// Replaces the Pallas TPU kernel latentdiffeq/ops/recurrent_pallas.py
// (`pallas_goku_heads`, kernel body `_kernel`). Step t advances the forward
// LSTM stack on x[t] and, on x[T-1-t], the z0 RNN stack and the backward
// LSTM stack. Outputs z0 (B, H) = top RNN state and theta (B, 2H) = top
// forward LSTM state ++ top backward LSTM state.
//
// What bounds it: the T-step dependent chain. Each step is a few hundred
// multiply-adds per thread on data already on the chip, separated by block
// barriers, so the kernel is latency bound; the bytes (xs once, ~48 KB of
// weights per block from L2) and the operations are far below the card's
// rates. Design: one block per tile of R batch rows; all weights are
// copied into shared memory once and h/c states stay in shared memory for
// the whole loop; one thread per (row, gate unit) of the LSTMs (4H threads
// per row), the first H of which also own the RNN unit and the state
// updates. Two barriers per layer per step.
//
// Packed weight layout (ops/recurrent_cuda.py::pack_goku_heads): for each
// stack in (z0 RNN, forward LSTM, backward LSTM), for each layer l:
//   Wi (din, G) row-major, Wh (H, G), b (G), h0 (H), and c0 (H) for LSTMs,
// with din = D for l = 0 else H, and G = H (RNN) or 4H (LSTM, gate order
// i, f, g, o).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 4;

struct Offsets {
  // [stack][layer]; stack 0 = z0 RNN, 1 = forward LSTM, 2 = backward LSTM
  int wi[3][kMaxLayers];
  int wh[3][kMaxLayers];
  int b[3][kMaxLayers];
  int h0[3][kMaxLayers];
  int c0[3][kMaxLayers];
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.0f);  // relu
    case 2: return tanhf(x);
    default: return x;              // identity
  }
}

// gates[j] = (in @ Wi)[j] + (h @ Wh)[j] + b[j], summed in that order as
// the plain version does.
__device__ __forceinline__ float gate(const float* __restrict__ w, int wi,
                                      int wh, int b, const float* in,
                                      int din, const float* h, int H, int G,
                                      int j) {
  float ax = 0.0f;
  for (int k = 0; k < din; ++k) ax += in[k] * w[wi + k * G + j];
  float ah = 0.0f;
  for (int k = 0; k < H; ++k) ah += h[k] * w[wh + k * G + j];
  return (ax + ah) + w[b + j];
}

__global__ void goku_heads_kernel(const float* __restrict__ xs,
                                  const float* __restrict__ wts, int n_w,
                                  Offsets off, float* __restrict__ z0_out,
                                  float* __restrict__ th_out, int B, int T,
                                  int D, int H, int L, int act, int R) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int LH = L * H;
  const int row_floats = 5 * LH + 2 * G + H + 2 * D;

  float* w = smem;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) w[i] = wts[i];

  const int r = threadIdx.x / G;      // row within the tile
  const int j = threadIdx.x % G;      // gate unit
  const int row = blockIdx.x * R + r;
  const bool live = r < R && row < B;

  float* st = w + n_w + r * row_floats;
  float* hz = st;             // (L, H) z0 RNN states
  float* hf = hz + LH;        // (L, H) forward LSTM h
  float* cf = hf + LH;        // (L, H) forward LSTM c
  float* hb = cf + LH;        // (L, H) backward LSTM h
  float* cb = hb + LH;        // (L, H) backward LSTM c
  float* gf = cb + LH;        // (G) forward gates
  float* gb = gf + G;         // (G) backward gates
  float* rz = gb + G;         // (H) RNN pre-activation
  float* xf = rz + H;         // (D) x[t]
  float* xr = xf + D;         // (D) x[T-1-t]
  __syncthreads();

  if (live && j < H) {
    for (int l = 0; l < L; ++l) {
      hz[l * H + j] = w[off.h0[0][l] + j];
      hf[l * H + j] = w[off.h0[1][l] + j];
      cf[l * H + j] = w[off.c0[1][l] + j];
      hb[l * H + j] = w[off.h0[2][l] + j];
      cb[l * H + j] = w[off.c0[2][l] + j];
    }
  }

  const float* xrow = xs + (size_t)row * T * D;
  for (int t = 0; t < T; ++t) {
    if (live) {
      for (int k = j; k < D; k += G) {
        xf[k] = xrow[(size_t)t * D + k];
        xr[k] = xrow[(size_t)(T - 1 - t) * D + k];
      }
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const int din = l == 0 ? D : H;
      if (live) {
        const float* in_f = l == 0 ? xf : hf + (l - 1) * H;
        const float* in_b = l == 0 ? xr : hb + (l - 1) * H;
        gf[j] = gate(w, off.wi[1][l], off.wh[1][l], off.b[1][l], in_f, din,
                     hf + l * H, H, G, j);
        gb[j] = gate(w, off.wi[2][l], off.wh[2][l], off.b[2][l], in_b, din,
                     hb + l * H, H, G, j);
        if (j < H) {
          const float* in_z = l == 0 ? xr : hz + (l - 1) * H;
          rz[j] = gate(w, off.wi[0][l], off.wh[0][l], off.b[0][l], in_z,
                       din, hz + l * H, H, H, j);
        }
      }
      __syncthreads();
      if (live && j < H) {
        const int s = l * H + j;
        float c = sigmoidf_(gf[H + j]) * cf[s]
                  + sigmoidf_(gf[j]) * tanhf(gf[2 * H + j]);
        cf[s] = c;
        hf[s] = sigmoidf_(gf[3 * H + j]) * tanhf(c);
        c = sigmoidf_(gb[H + j]) * cb[s]
            + sigmoidf_(gb[j]) * tanhf(gb[2 * H + j]);
        cb[s] = c;
        hb[s] = sigmoidf_(gb[3 * H + j]) * tanhf(c);
        hz[s] = activate(rz[j], act);
      }
      __syncthreads();
    }
  }

  if (live && j < H) {
    const int top = (L - 1) * H + j;
    z0_out[(size_t)row * H + j] = hz[top];
    th_out[(size_t)row * 2 * H + j] = hf[top];
    th_out[(size_t)row * 2 * H + H + j] = hb[top];
  }
}

}  // namespace

// Number of floats of the packed weight buffer for D inputs, hidden H and
// L layers per stack; fills the offsets when `off` is not null.
static int goku_heads_layout(int D, int H, int L, Offsets* off) {
  int pos = 0;
  for (int s = 0; s < 3; ++s) {
    const int G = s == 0 ? H : 4 * H;
    for (int l = 0; l < L; ++l) {
      const int din = l == 0 ? D : H;
      if (off) off->wi[s][l] = pos;
      pos += din * G;
      if (off) off->wh[s][l] = pos;
      pos += H * G;
      if (off) off->b[s][l] = pos;
      pos += G;
      if (off) off->h0[s][l] = pos;
      pos += H;
      if (s > 0) {
        if (off) off->c0[s][l] = pos;
        pos += H;
      } else if (off) {
        off->c0[s][l] = -1;
      }
    }
  }
  return pos;
}

extern "C" int ldq_goku_heads_n_weights(int D, int H, int L) {
  return goku_heads_layout(D, H, L, nullptr);
}

extern "C" int ldq_goku_heads_max_layers() { return kMaxLayers; }

// Returns a cudaError_t (0 on a successful launch). Does not synchronise.
extern "C" int ldq_goku_heads(const float* xs, const float* wts, int n_w,
                              float* z0_out, float* th_out, int B, int T,
                              int D, int H, int L, int act,
                              int rows_per_block, void* stream) {
  if (L < 1 || L > kMaxLayers || B < 1 || T < 1 || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  Offsets off;
  if (goku_heads_layout(D, H, L, &off) != n_w)
    return (int)cudaErrorInvalidValue;
  const int G = 4 * H;
  const int threads = rows_per_block * G;
  const int row_floats = 5 * L * H + 2 * G + H + 2 * D;
  const size_t smem =
      sizeof(float) * ((size_t)n_w + (size_t)rows_per_block * row_floats);
  cudaError_t e = cudaFuncSetAttribute(
      goku_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  goku_heads_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      xs, wts, n_w, off, z0_out, th_out, B, T, D, H, L, act,
      rows_per_block);
  return (int)cudaGetLastError();
}
