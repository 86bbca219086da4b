// GOKU encoder heads: all three recurrent stacks over the whole sequence in
// one kernel, and the reverse sweep of their gradient in a second.
//
// Replaces the Pallas TPU kernel latentdiffeq/ops/recurrent_pallas.py
// (`pallas_goku_heads`, kernel body `_kernel`; its `custom_vjp` recomputes
// through plain XLA, `_bwd`). Step t advances the forward LSTM stack on x[t]
// and, on x[T-1-t], the z0 RNN stack and the backward LSTM stack. Outputs z0
// (B, H) = top RNN state and theta (B, 2H) = top forward LSTM state ++ top
// backward LSTM state.
//
// What bounds it: the T-step dependent chain of each stack. A step is one
// (din + H)-term product per gate and a cell update, on data already on the
// chip; bytes and operations are far below the card's rates, so the kernel
// is latency bound and the design shortens each link of the chain:
//   - one block per batch row, one warp per (stack, layer): 3 * L warps;
//   - lane j < H owns hidden unit j and computes all four of its gates; lane
//     j + 16 takes the second half of the din + H terms and one
//     __shfl_xor_sync adds the halves, so the cell update is lane-local and
//     no gate exchange is needed;
//   - each lane's weight columns live in registers (96 floats for layer 0 of
//     an LSTM at D 32, H 16; 64 for layer 1); (D, H) are template
//     parameters so every loop unrolls;
//   - layer l + 1 runs one step behind layer l (a wavefront): h_{l,t} passes
//     from warp to warp through a two-slot ring in shared memory, one block
//     barrier per step, so the chain is T + L - 1 layer-steps, not T * L;
//   - the next x row is loaded into a register a step ahead;
//   - a population of S weight sets (train/multiseed.py trains S seeds at
//     once) is one launch on a (B, S) grid: blockIdx.y picks the replica's
//     packed weights, and its rows follow those of replica y - 1 in xs, the
//     outputs and the tape. A block's work is the single-replica block's.
// No tensor cores: each product has one row (M = 1), and TF32 rounding would
// move the float32 gates past the 1e-5 the port holds them to. Accurate
// expf / tanhf, no fast math.
//
// The kernel is compiled for D = 32, H = 16 (the GOKU heads). Narrower heads
// run in the same instance: the wrapper packs the weights with zero rows for
// the missing inputs and zero columns for the missing units (such a unit
// stays at 0 in every cell and feeds nothing), and the kernel reads only the
// D real columns of xs. Wider heads run at their own widths in a second pair
// of kernels (`goku_heads_fwd_any_kernel`, `goku_heads_bwd_any_kernel`) with
// the same warp layout, wavefront and tape, whose widths are read at run
// time: lane u (and u + 32, ...) owns hidden unit u, its weights are read
// through the cache, and the operand slots, the cell state and the sweep's
// carries live in dynamic shared memory. Those serve shapes off the main
// path and are not tuned.
//
// With a tape (a gradient will be taken) the forward also writes, per row
// and step, for each stack and layer: the RNN's h; the LSTM's activated
// gates i, f, g, o, then c and h. The sweep kernel runs backward over t with
// the same warp layout and a reverse wavefront (layer l - 1 one step behind
// layer l), streams each cell's pre-activation cotangents (dgates) out, and
// leaves the carries at t = -1 (dh0, dc0 per row). The weight and input
// gradients are products of the tape and dgates over all rows and steps,
// computed outside (ops/recurrent_cuda.py).
//
// Storage type Store (a template parameter of every kernel): float, or
// __nv_bfloat16 for bfloat16 NN stages (JAX's `pallas_goku_heads` runs in
// xs's dtype, recurrent_pallas.py:105, 121). xs, the outputs, the tape, the
// cotangents, the dgates and dh0 / dc0 are Store in memory (bfloat16 halves
// their bytes); the packed weights stay float32 (every bfloat16 value is
// exact in float32, so the register layout and the wrapper's packing are
// the float32 ones). Arithmetic is float32 in registers. The forward's
// carried states h and c are rounded to Store at every step (`carry`, to
// nearest even as PyTorch rounds), since JAX's bf16 scan carries bf16
// arrays and a float32 carry would compute a more precise recurrence than
// the reference's; the gates are rounded only where they are stored, on
// the tape. The sweep reads the tape into float32, carries dh and dc in
// float32 and rounds what it stores (dgates, dh0, dc0). The float32
// instances are the float32 kernels as they were, bit for bit
// (`carry<float>` is the identity). No pair (__nv_bfloat162) loads: a lane
// owns one unit, so its loads and stores are single values either way.
//
// Packed weight layout (ops/recurrent_cuda.py::pack_goku_heads): for each
// stack in (z0 RNN, forward LSTM, backward LSTM), for each layer l:
//   Wi (din, G) row-major, Wh (H, G), b (G), h0 (H), and c0 (H) for LSTMs,
// with din = D for l = 0 else H, and G = H (RNN) or 4H (LSTM, gate order
// i, f, g, o).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kD = 32;     // compiled input width
constexpr int kH = 16;     // compiled hidden width
constexpr unsigned kFull = 0xffffffffu;

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

// d act / d pre-activation from the output h (relu: 0 at 0, as autograd).
__device__ __forceinline__ float act_grad(float h, int act) {
  switch (act) {
    case 1: return h > 0.0f ? 1.0f : 0.0f;
    case 2: return 1.0f - h * h;
    default: return 1.0f;
  }
}

// Loads and stores of the storage type, through the conversion
// intrinsics; the arithmetic is float32.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A carried state as Store holds it: bfloat16 rounds to nearest even.
template <typename Store>
__device__ __forceinline__ float carry(float v) {
  if constexpr (std::is_same<Store, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// One barrier for the block's 3 * L warps. Each warp reaches it from its own
// code path (the warps are specialised by stack and layer), once per step.
__device__ __forceinline__ void step_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Float offsets of one row-step's tape record and dgates record.
__device__ __forceinline__ int tape_off(int s, int l, int L, int H) {
  return s == 0 ? l * H : L * H + (s - 1) * 6 * H * L + l * 6 * H;
}
__device__ __forceinline__ int dg_off(int s, int l, int L, int H) {
  return s == 0 ? l * H : L * H + (s - 1) * 4 * H * L + l * 4 * H;
}

// Per warp: two slots of the layer's operand vector [input (DIN), h (H)].
constexpr int kSlot = kD + kH;

// ---------------------------------------------------------------------------
// Forward: one warp advances one layer of one stack.
template <typename Store, int DIN, bool LSTM, bool TAPE>
__device__ __forceinline__ void fwd_layer(
    const Store* __restrict__ xrow, int Dx, bool reverse,
    const float* __restrict__ wts, int wi, int wh, int bo, int h0o, int c0o,
    float* my, float* up, Store* __restrict__ tape_row, int toff, int rec,
    Store* __restrict__ out, int T, int L, int l, int act, int threads) {
  constexpr int H = kH;
  constexpr int G = LSTM ? 4 : 1;
  constexpr int GH = G * H;
  constexpr int K = DIN + H;
  constexpr int K0 = K / 2;           // terms per half warp
  static_assert(K0 % 8 == 0, "half a layer's terms: whole float4 pairs");
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int j = lane & 15;
  const bool first = l == 0;

  float w[G][K0];
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int kk = 0; kk < K0; ++kk) {
      const int k = half * K0 + kk;
      w[q][kk] = k < DIN ? wts[wi + k * GH + q * H + j]
                         : wts[wh + (k - DIN) * GH + q * H + j];
    }
  }
  float bq[G];
#pragma unroll
  for (int q = 0; q < G; ++q) bq[q] = wts[bo + q * H + j];
  float h = wts[h0o + j];
  float c = LSTM ? wts[c0o + j] : 0.0f;

  // slot 0: x at step 0 (layer 0) and h0
  if (half == 0) my[DIN + j] = h;
  if (first) {
    const int tx = reverse ? T - 1 : 0;
    my[lane] = lane < Dx ? ld(xrow + (size_t)tx * Dx + lane) : 0.0f;
  }
  step_barrier(threads);

  for (int i = 0; i < T + L - 1; ++i) {
    const int t = i - l;
    if (t >= 0 && t < T) {
      float xn = 0.0f;
      if (first && t + 1 < T && lane < Dx) {
        const int tx = reverse ? T - 2 - t : t + 1;
        xn = ldg(xrow + (size_t)tx * Dx + lane);
      }
      const float* v = my + (t & 1) * kSlot + half * K0;
      float acc[G][2];
#pragma unroll
      for (int q = 0; q < G; ++q) acc[q][0] = acc[q][1] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < K0; kk += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(v + kk);
        const int p = (kk >> 2) & 1;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          acc[q][p] = fmaf(v4.x, w[q][kk], acc[q][p]);
          acc[q][p] = fmaf(v4.y, w[q][kk + 1], acc[q][p]);
          acc[q][p] = fmaf(v4.z, w[q][kk + 2], acc[q][p]);
          acc[q][p] = fmaf(v4.w, w[q][kk + 3], acc[q][p]);
        }
      }
      float z[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float a = acc[q][0] + acc[q][1];
        z[q] = (a + __shfl_xor_sync(kFull, a, 16)) + bq[q];
      }
      float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f;
      if constexpr (LSTM) {
        gi = sigmoidf_(z[0]);
        gf = sigmoidf_(z[1]);
        gg = tanhf(z[2]);
        go = sigmoidf_(z[3]);
        c = carry<Store>(gf * c + gi * gg);
        h = carry<Store>(go * tanhf(c));
      } else {
        h = carry<Store>(activate(z[0], act));
      }
      if (half == 0) {
        my[((t + 1) & 1) * kSlot + DIN + j] = h;
        if (up != nullptr) up[(t & 1) * kSlot + j] = h;
        if constexpr (TAPE) {
          Store* r = tape_row + (size_t)t * rec + toff;
          if constexpr (LSTM) {
            st(r + j, gi);
            st(r + H + j, gf);
            st(r + 2 * H + j, gg);
            st(r + 3 * H + j, go);
            st(r + 4 * H + j, c);
            st(r + 5 * H + j, h);
          } else {
            st(r + j, h);
          }
        }
      }
      if (first && t + 1 < T) my[((t + 1) & 1) * kSlot + lane] = xn;
    }
    step_barrier(threads);
  }
  if (out != nullptr && half == 0) st(out + j, h);
}

template <typename Store, bool TAPE>
__global__ void __launch_bounds__(3 * kMaxLayers * 32)
    goku_heads_fwd_kernel(const Store* __restrict__ xs,
                          const float* __restrict__ wts, Offsets off,
                          Store* __restrict__ z0_out,
                          Store* __restrict__ th_out,
                          Store* __restrict__ tape, int T, int Dx, int L,
                          int act, int n_w) {
  __shared__ __align__(16) float vin[3 * kMaxLayers][2 * kSlot];
  const int warp = threadIdx.x >> 5;
  const int s = warp / L;
  const int l = warp % L;
  // grid (B, S): blockIdx.y is the replica, whose weights start at
  // wts + y * n_w and whose rows follow the rows of replica y - 1
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  wts += (size_t)blockIdx.y * n_w;
  const int threads = blockDim.x;
  const int rec = 13 * kH * L;
  const Store* xrow = xs + (size_t)row * T * Dx;
  float* my = vin[warp];
  float* up = l + 1 < L ? vin[warp + 1] : nullptr;
  Store* tape_row = TAPE ? tape + (size_t)row * T * rec : nullptr;
  const int toff = tape_off(s, l, L, kH);
  Store* out = nullptr;
  if (l == L - 1) {
    out = s == 0 ? z0_out + (size_t)row * kH
                 : th_out + (size_t)row * 2 * kH + (s - 1) * kH;
  }
  const bool rev = s != 1;
#define LDQ_FWD(DIN, LSTM)                                                   \
  fwd_layer<Store, DIN, LSTM, TAPE>(                                         \
      xrow, Dx, rev, wts, off.wi[s][l], off.wh[s][l], off.b[s][l],            \
      off.h0[s][l], off.c0[s][l], my, up, tape_row, toff, rec, out, T, L, l,  \
      act, threads)
  if (s == 0) {
    if (l == 0) LDQ_FWD(kD, false); else LDQ_FWD(kH, false);
  } else {
    if (l == 0) LDQ_FWD(kD, true); else LDQ_FWD(kH, true);
  }
#undef LDQ_FWD
}

// ---------------------------------------------------------------------------
// Reverse sweep: one warp takes one layer of one stack back over t.
//
// Per step, with dh = the cotangent of h_{l,t} (the carry from step t + 1
// plus, below the top, layer l + 1's dgates_{l+1,t} Wi_{l+1}^T):
//   LSTM: dc = dc_carry + dh o (1 - tanh(c)^2); dz_i = dc g i (1 - i);
//         dz_f = dc c_{t-1} f (1 - f); dz_g = dc i (1 - g^2);
//         dz_o = dh tanh(c) o (1 - o); dc_carry = dc f;
//   RNN:  dz = dh act'(h);
// then dh_carry = dz Wh^T and, for l > 0, dz Wi^T goes to layer l - 1.
// Lane j < 16 sums the first half of the G gate terms for unit j, lane
// j + 16 the second half, from transposed weight rows held in registers.
template <int G>
__device__ __forceinline__ int dg_pos(int m) {
  return m + (m >= G * kH / 2 ? 4 : 0);   // halves in other banks
}
constexpr int kDgSlot = 4 * kH + 4;

template <typename Store, bool LSTM, bool WI>
__device__ __forceinline__ void bwd_layer(
    const float* __restrict__ wts, int wi, int wh, int c0o,
    const Store* __restrict__ tape_row, int toff, int rec,
    Store* __restrict__ dg_row, int goff, int grec, float g_top,
    float* dgs, float* ring_in, float* ring_down, Store* dh0, Store* dc0,
    int T, int L, int l, int act, int threads) {
  constexpr int H = kH;
  constexpr int G = LSTM ? 4 : 1;
  constexpr int GH = G * H;
  constexpr int M0 = GH / 2;
  static_assert(M0 % 4 == 0, "half a layer's gate terms: whole float4s");
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int j = lane & 15;

  float whT[M0], wiT[WI ? M0 : 1];
#pragma unroll
  for (int kk = 0; kk < M0; ++kk) {
    whT[kk] = wts[wh + j * GH + half * M0 + kk];
    if constexpr (WI) wiT[kk] = wts[wi + j * GH + half * M0 + kk];
  }
  const float c0 = LSTM ? wts[c0o + j] : 0.0f;
  float dh = g_top, dc = 0.0f;

  // the tape of the current step, loaded one step ahead
  auto load = [&](int t, float* r) {
    const Store* p = tape_row + (size_t)t * rec + toff;
    if constexpr (LSTM) {
      r[0] = ld(p + j);
      r[1] = ld(p + H + j);
      r[2] = ld(p + 2 * H + j);
      r[3] = ld(p + 3 * H + j);
      r[4] = ld(p + 4 * H + j);
      r[5] = t > 0 ? ld(p + 4 * H + j - rec) : c0;   // c_{t-1}
    } else {
      r[0] = ld(p + j);
    }
  };
  float cur[LSTM ? 6 : 1], nxt[LSTM ? 6 : 1];
  load(T - 1, cur);

  for (int i = 0; i < T + L - 1; ++i) {
    const int t = T - 1 - (i - (L - 1 - l));
    if (t >= 0 && t < T) {
      if (t > 0) load(t - 1, nxt);
      if (ring_in != nullptr) dh += ring_in[(t & 1) * H + j];
      float dz[G];
      if constexpr (LSTM) {
        const float gi = cur[0], gf = cur[1], gg = cur[2], go = cur[3];
        const float tc = tanhf(cur[4]);
        const float dct = dc + dh * go * (1.0f - tc * tc);
        dz[0] = dct * gg * gi * (1.0f - gi);
        dz[1] = dct * cur[5] * gf * (1.0f - gf);
        dz[2] = dct * gi * (1.0f - gg * gg);
        dz[3] = dh * tc * go * (1.0f - go);
        dc = dct * gf;
      } else {
        dz[0] = dh * act_grad(cur[0], act);
      }
      if (half == 0) {
        Store* o = dg_row + (size_t)t * grec + goff;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          dgs[dg_pos<G>(q * H + j)] = dz[q];
          st(o + q * H + j, dz[q]);
        }
      }
      __syncwarp();
      float ah[2] = {0.0f, 0.0f}, ai[2] = {0.0f, 0.0f};
      const float* d = dgs + dg_pos<G>(half * M0);
#pragma unroll
      for (int kk = 0; kk < M0; kk += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(d + kk);
        const int p = (kk >> 2) & 1;
        ah[p] = fmaf(d4.x, whT[kk], ah[p]);
        ah[p] = fmaf(d4.y, whT[kk + 1], ah[p]);
        ah[p] = fmaf(d4.z, whT[kk + 2], ah[p]);
        ah[p] = fmaf(d4.w, whT[kk + 3], ah[p]);
        if constexpr (WI) {
          ai[p] = fmaf(d4.x, wiT[kk], ai[p]);
          ai[p] = fmaf(d4.y, wiT[kk + 1], ai[p]);
          ai[p] = fmaf(d4.z, wiT[kk + 2], ai[p]);
          ai[p] = fmaf(d4.w, wiT[kk + 3], ai[p]);
        }
      }
      const float a = ah[0] + ah[1];
      dh = a + __shfl_xor_sync(kFull, a, 16);
      if constexpr (WI) {
        const float b = ai[0] + ai[1];
        const float down = b + __shfl_xor_sync(kFull, b, 16);
        if (half == 0) ring_down[(t & 1) * H + j] = down;
      }
      if constexpr (LSTM) {
#pragma unroll
        for (int r = 0; r < 6; ++r) cur[r] = nxt[r];
      } else {
        cur[0] = nxt[0];
      }
    }
    step_barrier(threads);
  }
  if (half == 0) {
    st(dh0 + j, dh);
    st(dc0 + j, dc);
  }
}

template <typename Store>
__global__ void __launch_bounds__(3 * kMaxLayers * 32)
    goku_heads_bwd_kernel(const float* __restrict__ wts, Offsets off,
                          const Store* __restrict__ tape,
                          const Store* __restrict__ g_z0,
                          const Store* __restrict__ g_th,
                          Store* __restrict__ dgates,
                          Store* __restrict__ dh0, Store* __restrict__ dc0,
                          int T, int L, int act, int n_w) {
  __shared__ __align__(16) float dgs[3 * kMaxLayers][kDgSlot];
  __shared__ __align__(16) float ring[3 * kMaxLayers][2 * kH];
  const int warp = threadIdx.x >> 5;
  const int s = warp / L;
  const int l = warp % L;
  // grid (B, S): blockIdx.y is the replica, whose weights start at
  // wts + y * n_w and whose rows follow the rows of replica y - 1
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  wts += (size_t)blockIdx.y * n_w;
  const int threads = blockDim.x;
  const int j = threadIdx.x & 15;
  const int rec = 13 * kH * L;
  const int grec = 9 * kH * L;
  float g_top = 0.0f;
  if (l == L - 1) {
    g_top = s == 0 ? ld(g_z0 + (size_t)row * kH + j)
                   : ld(g_th + (size_t)row * 2 * kH + (s - 1) * kH + j);
  }
  const Store* tape_row = tape + (size_t)row * T * rec;
  Store* dg_row = dgates + (size_t)row * T * grec;
  float* ring_in = l + 1 < L ? ring[warp] : nullptr;
  float* ring_down = l > 0 ? ring[warp - 1] : nullptr;
  const size_t so = (((size_t)row * 3 + s) * L + l) * kH;
  const int toff = tape_off(s, l, L, kH);
  const int goff = dg_off(s, l, L, kH);
#define LDQ_BWD(LSTM, WI)                                                     \
  bwd_layer<Store, LSTM, WI>(wts, off.wi[s][l], off.wh[s][l], off.c0[s][l],   \
                             tape_row, toff, rec, dg_row, goff, grec, g_top, \
                             dgs[warp], ring_in, ring_down, dh0 + so,        \
                             dc0 + so, T, L, l, act, threads)
  if (s == 0) {
    if (l == 0) LDQ_BWD(false, false); else LDQ_BWD(false, true);
  } else {
    if (l == 0) LDQ_BWD(true, false); else LDQ_BWD(true, true);
  }
#undef LDQ_BWD
}

// ---------------------------------------------------------------------------
// Any widths (D, H), read at run time. Floats of dynamic shared memory per
// warp: forward, two operand slots [input (D), h (H)] and the cell state
// (H); sweep, dgates (4H), the two-slot ring from the layer above (2H), and
// the dh and dc carries (H each).
__host__ __device__ inline int any_fwd_floats(int D, int H) {
  return 2 * (D + H) + H;
}
__host__ __device__ inline int any_bwd_floats(int H) { return 8 * H; }

template <typename Store, bool LSTM, bool TAPE>
__device__ __forceinline__ void fwd_layer_any(
    const Store* __restrict__ xrow, int D, int H, int din, bool reverse,
    const float* __restrict__ wts, int wi, int wh, int bo, int h0o, int c0o,
    float* my, float* up, float* cst, Store* __restrict__ tape_row,
    int toff, int rec, Store* __restrict__ out, int T, int L, int l,
    int act, int threads) {
  constexpr int G = LSTM ? 4 : 1;
  const int GH = G * H;
  const int S = D + H;                   // slot stride of every warp
  const int lane = threadIdx.x & 31;
  for (int u = lane; u < H; u += 32) {
    my[din + u] = wts[h0o + u];
    if constexpr (LSTM) cst[u] = wts[c0o + u];
  }
  if (l == 0) {
    const int tx = reverse ? T - 1 : 0;
    for (int k = lane; k < D; k += 32) my[k] = ld(xrow + (size_t)tx * D + k);
  }
  step_barrier(threads);

  for (int i = 0; i < T + L - 1; ++i) {
    const int t = i - l;
    if (t >= 0 && t < T) {
      const float* v = my + (t & 1) * S;
      float* nx = my + ((t + 1) & 1) * S;
      for (int u = lane; u < H; u += 32) {
        float z[G];
#pragma unroll
        for (int q = 0; q < G; ++q) z[q] = 0.0f;
        for (int k = 0; k < din; ++k) {
          const float a = v[k];
          const float* w = wts + wi + k * GH + u;
#pragma unroll
          for (int q = 0; q < G; ++q) z[q] = fmaf(a, __ldg(w + q * H), z[q]);
        }
        for (int k = 0; k < H; ++k) {
          const float a = v[din + k];
          const float* w = wts + wh + k * GH + u;
#pragma unroll
          for (int q = 0; q < G; ++q) z[q] = fmaf(a, __ldg(w + q * H), z[q]);
        }
#pragma unroll
        for (int q = 0; q < G; ++q) z[q] += __ldg(wts + bo + q * H + u);
        float h;
        Store* r = TAPE ? tape_row + (size_t)t * rec + toff : nullptr;
        if constexpr (LSTM) {
          const float gi = sigmoidf_(z[0]), gf = sigmoidf_(z[1]);
          const float gg = tanhf(z[2]), go = sigmoidf_(z[3]);
          const float c = carry<Store>(gf * cst[u] + gi * gg);
          cst[u] = c;
          h = carry<Store>(go * tanhf(c));
          if constexpr (TAPE) {
            st(r + u, gi);
            st(r + H + u, gf);
            st(r + 2 * H + u, gg);
            st(r + 3 * H + u, go);
            st(r + 4 * H + u, c);
            st(r + 5 * H + u, h);
          }
        } else {
          h = carry<Store>(activate(z[0], act));
          if constexpr (TAPE) st(r + u, h);
        }
        nx[din + u] = h;
        if (up != nullptr) up[(t & 1) * S + u] = h;
      }
      if (l == 0 && t + 1 < T) {
        const int tx = reverse ? T - 2 - t : t + 1;
        for (int k = lane; k < D; k += 32) {
          nx[k] = ld(xrow + (size_t)tx * D + k);
        }
      }
    }
    step_barrier(threads);
  }
  if (out != nullptr) {
    for (int u = lane; u < H; u += 32) {
      st(out + u, my[(T & 1) * S + din + u]);
    }
  }
}

template <typename Store, bool TAPE>
__global__ void __launch_bounds__(3 * kMaxLayers * 32)
    goku_heads_fwd_any_kernel(const Store* __restrict__ xs,
                              const float* __restrict__ wts, Offsets off,
                              Store* __restrict__ z0_out,
                              Store* __restrict__ th_out,
                              Store* __restrict__ tape, int T, int D, int H,
                              int L, int act, int n_w) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5;
  const int s = warp / L;
  const int l = warp % L;
  // grid (B, S): blockIdx.y is the replica, whose weights start at
  // wts + y * n_w and whose rows follow the rows of replica y - 1
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  wts += (size_t)blockIdx.y * n_w;
  const int per = any_fwd_floats(D, H);
  const int rec = 13 * H * L;
  float* my = dyn + warp * per;
  float* up = l + 1 < L ? dyn + (warp + 1) * per : nullptr;
  Store* out = nullptr;
  if (l == L - 1) {
    out = s == 0 ? z0_out + (size_t)row * H
                 : th_out + (size_t)row * 2 * H + (s - 1) * H;
  }
#define LDQ_FWD_ANY(LSTM)                                                     \
  fwd_layer_any<Store, LSTM, TAPE>(                                           \
      xs + (size_t)row * T * D, D, H, l == 0 ? D : H, s != 1, wts,            \
      off.wi[s][l], off.wh[s][l], off.b[s][l], off.h0[s][l], off.c0[s][l],    \
      my, up, my + 2 * (D + H), TAPE ? tape + (size_t)row * T * rec : nullptr,\
      tape_off(s, l, L, H), rec, out, T, L, l, act, blockDim.x)
  if (s == 0) LDQ_FWD_ANY(false); else LDQ_FWD_ANY(true);
#undef LDQ_FWD_ANY
}

template <typename Store, bool LSTM>
__device__ __forceinline__ void bwd_layer_any(
    const float* __restrict__ wts, int wi, int wh, int c0o,
    const Store* __restrict__ tape_row, int toff, int rec,
    Store* __restrict__ dg_row, int goff, int grec,
    const Store* __restrict__ g_top, float* dgs, float* dhc, float* dcc,
    float* ring_in, float* ring_down, Store* dh0, Store* dc0, int T, int L,
    int l, int H, int act, int threads) {
  constexpr int G = LSTM ? 4 : 1;
  const int GH = G * H;
  const int lane = threadIdx.x & 31;
  for (int u = lane; u < H; u += 32) {
    dhc[u] = g_top != nullptr ? ld(g_top + u) : 0.0f;
    dcc[u] = 0.0f;
  }
  for (int i = 0; i < T + L - 1; ++i) {
    const int t = T - 1 - (i - (L - 1 - l));
    if (t >= 0 && t < T) {
      const Store* p = tape_row + (size_t)t * rec + toff;
      Store* o = dg_row + (size_t)t * grec + goff;
      for (int u = lane; u < H; u += 32) {
        float dh = dhc[u];
        if (ring_in != nullptr) dh += ring_in[(t & 1) * H + u];
        float dz[G];
        if constexpr (LSTM) {
          const float gi = ld(p + u), gf = ld(p + H + u);
          const float gg = ld(p + 2 * H + u), go = ld(p + 3 * H + u);
          const float cp = t > 0 ? ld(p + 4 * H + u - rec) : wts[c0o + u];
          const float tc = tanhf(ld(p + 4 * H + u));
          const float dct = dcc[u] + dh * go * (1.0f - tc * tc);
          dz[0] = dct * gg * gi * (1.0f - gi);
          dz[1] = dct * cp * gf * (1.0f - gf);
          dz[2] = dct * gi * (1.0f - gg * gg);
          dz[3] = dh * tc * go * (1.0f - go);
          dcc[u] = dct * gf;
        } else {
          dz[0] = dh * act_grad(ld(p + u), act);
        }
#pragma unroll
        for (int q = 0; q < G; ++q) {
          dgs[q * H + u] = dz[q];
          st(o + q * H + u, dz[q]);
        }
      }
      __syncwarp();
      for (int u = lane; u < H; u += 32) {
        const float* whr = wts + wh + (size_t)u * GH;
        const float* wir = wts + wi + (size_t)u * GH;
        float a = 0.0f, b = 0.0f;
        for (int m = 0; m < GH; ++m) {
          a = fmaf(dgs[m], __ldg(whr + m), a);
          if (ring_down != nullptr) b = fmaf(dgs[m], __ldg(wir + m), b);
        }
        dhc[u] = a;
        if (ring_down != nullptr) ring_down[(t & 1) * H + u] = b;
      }
    }
    step_barrier(threads);
  }
  for (int u = lane; u < H; u += 32) {
    st(dh0 + u, dhc[u]);
    st(dc0 + u, dcc[u]);
  }
}

template <typename Store>
__global__ void __launch_bounds__(3 * kMaxLayers * 32)
    goku_heads_bwd_any_kernel(const float* __restrict__ wts, Offsets off,
                              const Store* __restrict__ tape,
                              const Store* __restrict__ g_z0,
                              const Store* __restrict__ g_th,
                              Store* __restrict__ dgates,
                              Store* __restrict__ dh0,
                              Store* __restrict__ dc0, int T, int H, int L,
                              int act, int n_w) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5;
  const int s = warp / L;
  const int l = warp % L;
  // grid (B, S): blockIdx.y is the replica, whose weights start at
  // wts + y * n_w and whose rows follow the rows of replica y - 1
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  wts += (size_t)blockIdx.y * n_w;
  const int per = any_bwd_floats(H);
  const int rec = 13 * H * L;
  const int grec = 9 * H * L;
  float* base = dyn + warp * per;
  const Store* g_top = nullptr;
  if (l == L - 1) {
    g_top = s == 0 ? g_z0 + (size_t)row * H
                   : g_th + (size_t)row * 2 * H + (s - 1) * H;
  }
  float* ring_in = l + 1 < L ? base + 4 * H : nullptr;
  float* ring_down = l > 0 ? base - per + 4 * H : nullptr;
  const size_t so = (((size_t)row * 3 + s) * L + l) * H;
#define LDQ_BWD_ANY(LSTM)                                                     \
  bwd_layer_any<Store, LSTM>(                                                 \
      wts, off.wi[s][l], off.wh[s][l], off.c0[s][l],                          \
      tape + (size_t)row * T * rec, tape_off(s, l, L, H), rec,                \
      dgates + (size_t)row * T * grec, dg_off(s, l, L, H), grec, g_top, base, \
      base + 6 * H, base + 7 * H, ring_in, ring_down, dh0 + so, dc0 + so, T,  \
      L, l, H, act, blockDim.x)
  if (s == 0) LDQ_BWD_ANY(false); else LDQ_BWD_ANY(true);
#undef LDQ_BWD_ANY
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

// The compiled widths (kD, kH): heads that fit run there, packed at them.
extern "C" int ldq_goku_heads_dims(int* D, int* H, int* max_layers) {
  *D = kD;
  *H = kH;
  *max_layers = kMaxLayers;
  return 0;
}

extern "C" int ldq_goku_heads_n_weights(int D, int H, int L) {
  return goku_heads_layout(D, H, L, nullptr);
}

// Bytes of dynamic shared memory the any-width kernels take at (D, H, L).
extern "C" int ldq_goku_heads_smem(int D, int H, int L) {
  const int per = any_fwd_floats(D, H) > any_bwd_floats(H)
                      ? any_fwd_floats(D, H) : any_bwd_floats(H);
  return (int)sizeof(float) * 3 * L * per;
}

static cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One launch of the forward on S replicas of B rows (the C entry points
// below, one per storage type).
template <typename Store>
static int launch_fwd(const Store* xs, const float* wts, int n_w,
                      Store* z0_out, Store* th_out, Store* tape, int S, int B,
                      int T, int Dx, int D, int H, int L, int act,
                      void* stream) {
  if (L < 1 || L > kMaxLayers || S < 1 || S > 65535 || B < 1 || T < 1 ||
      Dx < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const bool compiled = D == kD && H == kH;
  if (compiled ? Dx > kD : Dx != D) return (int)cudaErrorInvalidValue;
  Offsets off;
  if (goku_heads_layout(D, H, L, &off) != n_w)
    return (int)cudaErrorInvalidValue;
  const int threads = 3 * L * 32;
  const dim3 grid(B, S);
  const cudaStream_t st_ = (cudaStream_t)stream;
  if (!compiled) {
    const int smem = (int)sizeof(float) * 3 * L * any_fwd_floats(D, H);
    const void* k =
        tape != nullptr
            ? (const void*)goku_heads_fwd_any_kernel<Store, true>
            : (const void*)goku_heads_fwd_any_kernel<Store, false>;
    cudaError_t e = allow_smem(k, smem);
    if (e != cudaSuccess) return (int)e;
    if (tape != nullptr) {
      goku_heads_fwd_any_kernel<Store, true><<<grid, threads, smem, st_>>>(
          xs, wts, off, z0_out, th_out, tape, T, D, H, L, act, n_w);
    } else {
      goku_heads_fwd_any_kernel<Store, false><<<grid, threads, smem, st_>>>(
          xs, wts, off, z0_out, th_out, nullptr, T, D, H, L, act, n_w);
    }
  } else if (tape != nullptr) {
    goku_heads_fwd_kernel<Store, true><<<grid, threads, 0, st_>>>(
        xs, wts, off, z0_out, th_out, tape, T, Dx, L, act, n_w);
  } else {
    goku_heads_fwd_kernel<Store, false><<<grid, threads, 0, st_>>>(
        xs, wts, off, z0_out, th_out, nullptr, T, Dx, L, act, n_w);
  }
  return (int)cudaGetLastError();
}

// One launch of the sweep on S replicas of B rows.
template <typename Store>
static int launch_bwd(const float* wts, int n_w, const Store* tape,
                      const Store* g_z0, const Store* g_th, Store* dgates,
                      Store* dh0, Store* dc0, int S, int B, int T, int D,
                      int H, int L, int act, void* stream) {
  if (L < 1 || L > kMaxLayers || S < 1 || S > 65535 || B < 1 || T < 1 ||
      H < 1)
    return (int)cudaErrorInvalidValue;
  Offsets off;
  if (goku_heads_layout(D, H, L, &off) != n_w)
    return (int)cudaErrorInvalidValue;
  const int threads = 3 * L * 32;
  const dim3 grid(B, S);
  const cudaStream_t st_ = (cudaStream_t)stream;
  if (D == kD && H == kH) {
    goku_heads_bwd_kernel<Store><<<grid, threads, 0, st_>>>(
        wts, off, tape, g_z0, g_th, dgates, dh0, dc0, T, L, act, n_w);
  } else {
    const int smem = (int)sizeof(float) * 3 * L * any_bwd_floats(H);
    cudaError_t e =
        allow_smem((const void*)goku_heads_bwd_any_kernel<Store>, smem);
    if (e != cudaSuccess) return (int)e;
    goku_heads_bwd_any_kernel<Store><<<grid, threads, smem, st_>>>(
        wts, off, tape, g_z0, g_th, dgates, dh0, dc0, T, H, L, act, n_w);
  }
  return (int)cudaGetLastError();
}

// xs (S, B, T, Dx) float32: S replicas of B rows each; wts (S, n_w), each
// replica's weights packed at (D, H): (kD, kH) with Dx <= kD runs the
// compiled instance, any other (D, H) with Dx == D the any-width one; tape
// null or (S, B, T, 13 H L); z0_out (S, B, H), th_out (S, B, 2 H). One
// launch on a (B, S) grid; S = 1 is the single-replica launch. Returns a
// cudaError_t (0 on a successful launch). Does not synchronise.
extern "C" int ldq_goku_heads(const float* xs, const float* wts, int n_w,
                              float* z0_out, float* th_out, float* tape,
                              int S, int B, int T, int Dx, int D, int H,
                              int L, int act, void* stream) {
  return launch_fwd<float>(xs, wts, n_w, z0_out, th_out, tape, S, B, T, Dx,
                           D, H, L, act, stream);
}

// The same with xs, z0_out, th_out and the tape in bfloat16 (the weights
// float32, packed from the bfloat16 parameters).
extern "C" int ldq_goku_heads_bf16(const void* xs, const float* wts, int n_w,
                                   void* z0_out, void* th_out, void* tape,
                                   int S, int B, int T, int Dx, int D, int H,
                                   int L, int act, void* stream) {
  using bf = __nv_bfloat16;
  return launch_fwd<bf>(static_cast<const bf*>(xs), wts, n_w,
                        static_cast<bf*>(z0_out), static_cast<bf*>(th_out),
                        static_cast<bf*>(tape), S, B, T, Dx, D, H, L, act,
                        stream);
}

// wts (S, n_w) packed at (D, H) as for the forward; tape (S, B, T, 13 H L)
// from the forward; g_z0 (S, B, H), g_th (S, B, 2 H); writes dgates (S, B,
// T, 9 H L), dh0 and dc0 (S, B, 3, L, H; dc0 of the RNN is 0). One launch
// on a (B, S) grid. Returns a cudaError_t. Does not synchronise.
extern "C" int ldq_goku_heads_bwd(const float* wts, int n_w,
                                  const float* tape, const float* g_z0,
                                  const float* g_th, float* dgates,
                                  float* dh0, float* dc0, int S, int B,
                                  int T, int D, int H, int L, int act,
                                  void* stream) {
  return launch_bwd<float>(wts, n_w, tape, g_z0, g_th, dgates, dh0, dc0, S,
                           B, T, D, H, L, act, stream);
}

// The same with the tape, the cotangents, dgates, dh0 and dc0 in bfloat16.
extern "C" int ldq_goku_heads_bwd_bf16(const float* wts, int n_w,
                                       const void* tape, const void* g_z0,
                                       const void* g_th, void* dgates,
                                       void* dh0, void* dc0, int S, int B,
                                       int T, int D, int H, int L, int act,
                                       void* stream) {
  using bf = __nv_bfloat16;
  return launch_bwd<bf>(wts, n_w, static_cast<const bf*>(tape),
                        static_cast<const bf*>(g_z0),
                        static_cast<const bf*>(g_th),
                        static_cast<bf*>(dgates), static_cast<bf*>(dh0),
                        static_cast<bf*>(dc0), S, B, T, D, H, L, act, stream);
}
