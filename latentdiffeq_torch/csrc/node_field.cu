// Batched fixed-grid explicit Runge-Kutta solve of dy/dt = MLP(y) for a
// Chain-of-Dense vector field, and its gradient, each as one kernel.
//
// Replaces the Pallas TPU kernel latentdiffeq/ops/node_pallas.py
// (`pallas_solve_neural_field`: forward `_node_kernel`, backward
// `_node_bwd_kernel`). The field ignores t. Success flags and counters are
// computed outside, as in the JAX package.
//
// What bounds it: a serial chain of (T-1) * substeps * stages field
// evaluations, each a chain of L small dense layers separated by block
// barriers; at the main path's sizes (64 or 45 rows, widths 16-200-200-16)
// the bytes (one trajectory in, one out) and the float32 operations are
// worth microseconds, so the kernels are bound by the latency of that chain
// and by how many multiply-adds one SM issues per clock. Design:
//   * one block per tile of TB batch rows (TB = 8, 4, 2 or 1, chosen on the
//     host so the block's shared memory fits); the state y, the stage slopes
//     k_s and every activation of the tile stay in shared memory for the
//     whole integration, stored feature-major ([feature][row]) so a thread
//     reads all TB rows of one feature with one or two 16-byte loads;
//   * in a dense layer a thread owns 4 adjacent output columns and one of
//     8 (or, for a layer with few columns, 32) slices of the reduction
//     dimension, with 4 x TB accumulators in registers, so one 16-byte
//     weight load feeds 4 x TB multiply-adds; the partial sums of a column
//     sit in one warp and are added by a shuffle butterfly in a fixed order
//     (no atomics, no scratch memory, one block barrier a layer), so
//     results do not depend on timing;
//   * as few rows per block as still put the whole batch on the card in one
//     wave of blocks (1 row at the main path's 64 and 45): the chain is
//     serial within a tile, so spreading rows over SMs is what shortens it;
//   * forward: the weights are staged in shared memory when they fit beside
//     the tile (they do at 16-200-200-16: 187 KB of the 227 KB a block may
//     use) and are read through the read-only cache from global memory when
//     they do not (128-256-256-128 is 524 KB);
//   * backward: a reverse sweep over the saved trajectory. Each RK step is
//     recomputed from ys[:, i] with every layer output of every stage kept
//     in shared memory (activation derivatives are taken from the outputs),
//     then the cotangent is pulled back stage by stage: for
//     u_s = y + dt sum_q a_sq k_q, k_s = F(u_s), y1 = y + dt sum_s b_s k_s,
//     start kbar_s = dt b_s lambda, ybar = lambda, and for s = S-1..0:
//     ubar_s = J_F(u_s)^T kbar_s, ybar += ubar_s, kbar_q += dt a_sq ubar_s.
//     The MLP's backward uses transposed weight copies (made by the caller)
//     so both products read weights along rows. Weight gradients accumulate
//     into a per-block slice of a global buffer in which every element is
//     owned by one thread (no atomics across or inside blocks); the caller
//     sums the slices over blocks. Rows past the batch end carry zero
//     state and zero cotangent and so add nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 7;
constexpr int kMaxLayers = 8;
constexpr int kMaxThreads = 512;    // the kernels' launch bound
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kWaveBlocks = 132;    // SMs of an H100: blocks in one wave

// Error codes of the C interface besides cudaError_t (which is positive).
constexpr int kErrDepth = -1;   // more than kMaxLayers layers (or none)
constexpr int kErrFit = -2;     // the tile does not fit in shared memory
constexpr int kErrArgs = -3;    // any other invalid argument

struct Tableau {
  float a[kMaxStages][kMaxStages];
  float b[kMaxStages];
  int ns;
};

// The field: L dense layers h <- act(h W_l + b_l), W_l (w[l], w[l+1])
// row-major. w_off / b_off: offsets of W_l and b_l in the packed layout
// [W_0, b_0, W_1, b_1, ...] (each piece padded to a multiple of 4 floats,
// so every piece is 16-byte aligned) used for the staged weights and for
// the gradient buffer. h_off[l]: offset (in features) of layer l's input in a
// stage's tape, h_off[L] that of the field's output.
struct Field {
  int L;
  int w[kMaxLayers + 1];
  int act[kMaxLayers];
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int h_off[kMaxLayers + 1];
  int total;   // packed size in floats
  int maxw;    // widest layer boundary
  int sumw;    // sum of w[0..L]
  const float* W[kMaxLayers];
  const float* Wt[kMaxLayers];   // W_l transposed, (w[l+1], w[l]); backward
  const float* b[kMaxLayers];
};

// Activation codes: 0 identity, 1 relu, 2 tanh, 3 sigmoid, 4 softplus.
__device__ __forceinline__ float act_fn(int code, float v) {
  // identity and relu without a branch; relu keeps NaN, as torch does
  if (code <= 1) return (code == 1 && v <= 0.f) ? 0.f : v;
  switch (code) {
    case 2: return tanhf(v);
    case 3: return 1.f / (1.f + expf(-v));
    case 4: return v > 20.f ? v : log1pf(expf(v));
    default: return v;
  }
}

// d act / d pre-activation, from the activation's OUTPUT h. relu has
// derivative 0 at 0 (h == 0 exactly when the pre-activation is <= 0).
__device__ __forceinline__ float act_grad(int code, float h) {
  if (code <= 1) return (code == 1 && !(h > 0.f)) ? 0.f : 1.f;
  switch (code) {
    case 2: return 1.f - h * h;
    case 3: return h * (1.f - h);
    case 4: return -expm1f(-h);     // sigmoid(z) where h = softplus(z)
    default: return 1.f;
  }
}

template <int TB>
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          float (&v)[TB]) {
  if constexpr (TB % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TB / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i + 0] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else if constexpr (TB == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

enum Epilogue { kBiasAct = 0, kActGrad = 1, kNone = 2 };

__device__ __forceinline__ float epilogue(int epi, int code, float v,
                                          const float* __restrict__ aux,
                                          int n, int idx) {
  if (epi == kBiasAct) return act_fn(code, v + aux[n]);
  if (epi == kActGrad) return v * act_grad(code, aux[idx]);
  return v;
}

// acc[c * TB + r] += sum_{k = k0, k0 + STRIDE, ... < in_dim} in[k][r] *
// W[k][n0 + c], c < CT. With CT == 4 the four weights come in one 16-byte
// load (n0 and out_dim are multiples of 4 then, and W is 16-byte aligned).
template <int TB, int CT, bool GW, int STRIDE>
__device__ __forceinline__ void mac_slice(const float* __restrict__ in,
                                          const float* __restrict__ W,
                                          int in_dim, int out_dim, int n0,
                                          int k0, float (&acc)[CT * TB]) {
#pragma unroll 4
  for (int k = k0; k < in_dim; k += STRIDE) {
    const float* wp = W + (size_t)k * out_dim + n0;
    float w[CT];
    if constexpr (CT == 4) {
      const float4 q = GW ? __ldg(reinterpret_cast<const float4*>(wp))
                          : *reinterpret_cast<const float4*>(wp);
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    } else {
      w[0] = GW ? __ldg(wp) : *wp;
    }
    float h[TB];
    load_rows<TB>(in + k * TB, h);
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int r = 0; r < TB; ++r)
        acc[c * TB + r] = fmaf(h[r], w[c], acc[c * TB + r]);
  }
}

// Adds the N partial sums v[0..N) of the 2^STEPS lanes that differ in the
// bits `mask`, 2 * mask, ... of the lane number, as a butterfly that also
// scatters: at each step a lane keeps half of its values and hands the
// other half to its partner, so after the call v[0..max(1, N >> STEPS))
// hold complete sums, those of the original indices base, base + 1, ...
// with `base` the return value. Once one value is left the remaining steps
// add it across lanes, which then hold copies. `slice` is the lane's
// number among the 2^STEPS. The order of additions is fixed by the lane
// numbers.
template <int N, int STEPS>
__device__ __forceinline__ int reduce_scatter(float* v, int slice,
                                              int mask) {
  if constexpr (STEPS == 0) {
    return 0;
  } else {
    const int bit = slice & 1;
    if constexpr (N >= 2) {
      constexpr int H = N / 2;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = bit ? v[i] : v[i + H];
        const float keep = bit ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
      return bit * H +
             reduce_scatter<H, STEPS - 1>(v, slice >> 1, mask << 1);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], mask);
      return reduce_scatter<1, STEPS - 1>(v, slice >> 1, mask << 1);
    }
  }
}

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// out[n][r] = epilogue(sum_k in[k][r] * W[k][n]) for the tile's TB rows.
// `in` and `out` are shared memory ([feature][row]); W is (in_dim, out_dim)
// row-major in global (GW) or shared memory. `aux` is the bias (kBiasAct)
// or the tape holding this product's activation outputs (kActGrad).
// A warp's 32 lanes are 2^SB slices of the reduction dimension
// (k = slice, slice + 2^SB, ...) x 32 >> SB groups of CT adjacent columns;
// the partial sums of a group are added and dealt out over its lanes by
// `reduce_scatter`, and each lane finishes and stores its share. Ends with
// a block barrier.
template <int TB, int CT, bool GW, int SB>
__device__ __forceinline__ void dense_sb(const float* __restrict__ in,
                                         const float* __restrict__ W,
                                         int in_dim, int out_dim,
                                         float* __restrict__ out, int epi,
                                         int code,
                                         const float* __restrict__ aux) {
  constexpr int N = CT * TB;               // sums per column group
  constexpr int G = 32 >> SB;              // column groups per warp
  constexpr int SCATTER = ilog2(N) < SB ? ilog2(N) : SB;
  constexpr int MINE = N >> SCATTER;       // finished sums per lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int slice = lane / G;
  const int ncg = out_dim / CT;
  for (int cg0 = warp * G; cg0 < ncg; cg0 += nwarps * G) {
    const int cg = cg0 + (lane % G);
    const bool live = cg < ncg;
    const int n0 = cg * CT;
    float acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = 0.f;
    if (live)
      mac_slice<TB, CT, GW, (1 << SB)>(in, W, in_dim, out_dim, n0, slice,
                                       acc);
    const int base = reduce_scatter<N, SB>(acc, slice, G);
    // lanes that differ only in slice bits above the scatter hold copies
    if (live && (slice >> SCATTER) == 0) {
#pragma unroll
      for (int i = 0; i < MINE; ++i) {
        const int j = base + i;            // = c * TB + r
        const int idx = n0 * TB + j;
        out[idx] = epilogue(epi, code, acc[i], aux, n0 + j / TB, idx);
      }
    }
  }
  __syncthreads();
}

// A layer with no more column groups than the block has warps gives every
// group a whole warp (32 slices); otherwise a warp takes 4 groups of 8
// slices.
template <int TB, bool GW>
__device__ __forceinline__ void dense(const float* __restrict__ in,
                                      const float* __restrict__ W,
                                      int in_dim, int out_dim,
                                      float* __restrict__ out, int epi,
                                      int code,
                                      const float* __restrict__ aux) {
  const int nwarps = blockDim.x >> 5;
  if (out_dim % 4 == 0) {
    if (out_dim / 4 <= nwarps)
      dense_sb<TB, 4, GW, 5>(in, W, in_dim, out_dim, out, epi, code, aux);
    else
      dense_sb<TB, 4, GW, 3>(in, W, in_dim, out_dim, out, epi, code, aux);
  } else {
    if (out_dim <= nwarps)
      dense_sb<TB, 1, GW, 5>(in, W, in_dim, out_dim, out, epi, code, aux);
    else
      dense_sb<TB, 1, GW, 3>(in, W, in_dim, out_dim, out, epi, code, aux);
  }
}

// dW[k][n] += sum_r h[k][r] * d[n][r]; dW is (in_dim, out_dim) row-major
// in shared or global memory, 16-byte aligned. Every element is owned by
// one thread of the block: row k by warp k mod nwarps, column group cg by
// lane cg mod 32.
template <int TB, int CT>
__device__ __forceinline__ void accum_dw_ct(const float* __restrict__ h,
                                            const float* __restrict__ d,
                                            float* __restrict__ dW,
                                            int in_dim, int out_dim) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ncg = out_dim / CT;
  for (int cg = lane; cg < ncg; cg += 32) {
    float dv[CT][TB];
#pragma unroll
    for (int c = 0; c < CT; ++c) load_rows<TB>(d + (cg * CT + c) * TB, dv[c]);
#pragma unroll 2
    for (int k = warp; k < in_dim; k += nwarps) {
      float hv[TB];
      load_rows<TB>(h + k * TB, hv);
      float acc[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        float a = 0.f;
#pragma unroll
        for (int r = 0; r < TB; ++r) a = fmaf(hv[r], dv[c][r], a);
        acc[c] = a;
      }
      float* p = dW + (size_t)k * out_dim + cg * CT;
      if constexpr (CT == 4) {
        float4 q = *reinterpret_cast<float4*>(p);
        q.x += acc[0];
        q.y += acc[1];
        q.z += acc[2];
        q.w += acc[3];
        *reinterpret_cast<float4*>(p) = q;
      } else {
        p[0] += acc[0];
      }
    }
  }
}

template <int TB>
__device__ __forceinline__ void accum_dw(const float* __restrict__ h,
                                         const float* __restrict__ d,
                                         float* __restrict__ dW, int in_dim,
                                         int out_dim) {
  if (out_dim % 4 == 0)
    accum_dw_ct<TB, 4>(h, d, dW, in_dim, out_dim);
  else
    accum_dw_ct<TB, 1>(h, d, dW, in_dim, out_dim);
}

template <int TB>
__device__ void accum_db(const float* __restrict__ d, float* __restrict__ db,
                         int out_dim) {
  for (int n = threadIdx.x; n < out_dim; n += blockDim.x) {
    float dv[TB];
    load_rows<TB>(d + n * TB, dv);
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < TB; ++r) acc += dv[r];
    db[n] += acc;
  }
}

// u[e] = y[e] + sum_{q < s, a_sq != 0} (dt a_sq) k_q[e]; k_q = kbase +
// q * kstride. No barrier.
__device__ __forceinline__ void stage_input(const Tableau& tab, int s,
                                            float dt,
                                            const float* __restrict__ y,
                                            const float* __restrict__ kbase,
                                            int kstride,
                                            float* __restrict__ u,
                                            int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    float v = y[e];
    for (int q = 0; q < s; ++q) {
      const float a = tab.a[s][q];
      if (a != 0.f) v = v + (dt * a) * kbase[q * kstride + e];
    }
    u[e] = v;
  }
}

// ---------------------------------------------------------------------------
// Forward: ys[b, 0] = u0s[b]; ys[b, i + 1] = `substeps` RK steps from
// ys[b, i]. WS: weights and biases staged in shared memory.
template <int TB, bool WS>
__global__ void __launch_bounds__(kMaxThreads)
node_field_fwd_kernel(Tableau tab, Field f,
                      const float* __restrict__ saveat,
                      const float* __restrict__ u0s, float* __restrict__ ys,
                      int B, int T, int substeps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dim = f.w[0];
  const int tile = dim * TB;
  const int row0 = blockIdx.x * TB;
  float* y = smem;
  float* u = y + tile;
  float* ks = u + tile;                       // ns slopes
  float* h0 = ks + tab.ns * tile;
  float* h1 = h0 + f.maxw * TB;
  // f.total floats when WS, 16-byte aligned
  float* wsm = smem + (((int)(h1 - smem) + f.maxw * TB + 3) & ~3);

  if (WS) {
    for (int l = 0; l < f.L; ++l) {
      const int nw = f.w[l] * f.w[l + 1];
      for (int e = tid; e < nw; e += nt) wsm[f.w_off[l] + e] = f.W[l][e];
      for (int e = tid; e < f.w[l + 1]; e += nt)
        wsm[f.b_off[l] + e] = f.b[l][e];
    }
  }
  for (int e = tid; e < tile; e += nt) {
    const int r = e / dim, d = e - r * dim;
    const int row = row0 + r;
    float v = 0.f;
    if (row < B) {
      v = u0s[(size_t)row * dim + d];
      ys[(size_t)row * T * dim + d] = v;
    }
    y[d * TB + r] = v;
  }
  __syncthreads();

  for (int i = 0; i < T - 1; ++i) {
    const float dt = (saveat[i + 1] - saveat[i]) / (float)substeps;
    for (int j = 0; j < substeps; ++j) {
      for (int s = 0; s < tab.ns; ++s) {
        stage_input(tab, s, dt, y, ks, tile, u, tile);
        __syncthreads();
        const float* in = u;
        for (int l = 0; l < f.L; ++l) {
          float* out = (l == f.L - 1) ? ks + s * tile : ((l & 1) ? h1 : h0);
          const float* W = WS ? wsm + f.w_off[l] : f.W[l];
          const float* b = WS ? wsm + f.b_off[l] : f.b[l];
          dense<TB, !WS>(in, W, f.w[l], f.w[l + 1], out, kBiasAct, f.act[l],
                         b);
          in = out;
        }
      }
      // y <- y + sum_s (dt b_s) k_s, and the interval's end state to ys
      const bool save = (j == substeps - 1);
      for (int e = tid; e < tile; e += nt) {
        const int r = e / dim, d = e - r * dim;
        const int idx = d * TB + r;
        float v = y[idx];
        for (int s = 0; s < tab.ns; ++s) {
          const float bs = tab.b[s];
          if (bs != 0.f) v = v + (dt * bs) * ks[s * tile + idx];
        }
        y[idx] = v;
        const int row = row0 + r;
        if (save && row < B)
          ys[((size_t)row * T + (i + 1)) * dim + d] = v;
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: lambda <- g[:, T-1]; for i = T-2..0: pull lambda back through
// the interval's RK steps (recomputed from ys[:, i]), add g[:, i], and
// accumulate the weight gradients into this block's slice of `dwb`: in
// shared memory for the whole sweep when they fit beside the tape (DS),
// written out once at the end, else in the slice itself.
// `ysub` (n_blocks, substeps, dim * TB) holds the sub-step start states of
// the current interval when substeps > 1.

// One RK step's stages from y, every layer output kept in the tape.
template <int TB>
__device__ __forceinline__ void taped_stages(const Tableau& tab,
                                             const Field& f, float dt,
                                             const float* __restrict__ y,
                                             float* __restrict__ tape) {
  const int tile = f.w[0] * TB;
  const int stride = f.sumw * TB;               // one stage's tape
  const float* kbase = tape + f.h_off[f.L] * TB;
  for (int s = 0; s < tab.ns; ++s) {
    float* ts = tape + s * stride;
    stage_input(tab, s, dt, y, kbase, stride, ts, tile);
    __syncthreads();
    for (int l = 0; l < f.L; ++l)
      dense<TB, true>(ts + f.h_off[l] * TB, f.W[l], f.w[l], f.w[l + 1],
                      ts + f.h_off[l + 1] * TB, kBiasAct, f.act[l], f.b[l]);
  }
}

template <int TB, bool DS>
__global__ void __launch_bounds__(kMaxThreads)
node_field_bwd_kernel(Tableau tab, Field f,
                      const float* __restrict__ saveat,
                      const float* __restrict__ ys,
                      const float* __restrict__ g, float* __restrict__ du0,
                      float* __restrict__ dwb, float* __restrict__ ysub,
                      int B, int T, int substeps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dim = f.w[0];
  const int tile = dim * TB;
  const int row0 = blockIdx.x * TB;
  const int stride = f.sumw * TB;
  float* lam = smem;
  float* ybar = lam + tile;
  float* y = ybar + tile;
  float* kbar = y + tile;                     // ns cotangents of the slopes
  float* tape = kbar + tab.ns * tile;         // ns * sumw * TB
  float* d0 = tape + tab.ns * stride;
  float* d1 = d0 + f.maxw * TB;
  // f.total floats when DS, 16-byte aligned
  float* dws = smem + (((int)(d1 - smem) + f.maxw * TB + 3) & ~3);
  float* slice = dwb + (size_t)blockIdx.x * f.total;
  float* mydw = DS ? dws : slice;
  float* mysub = ysub ? ysub + (size_t)blockIdx.x * substeps * tile : nullptr;

  for (int e = tid; e < tile; e += nt) {
    const int r = e / dim, d = e - r * dim;
    const int row = row0 + r;
    lam[d * TB + r] =
        row < B ? g[((size_t)row * T + (T - 1)) * dim + d] : 0.f;
  }
  if (DS)
    for (int e = tid; e < f.total; e += nt) dws[e] = 0.f;
  __syncthreads();

  for (int i = T - 2; i >= 0; --i) {
    const float dt = (saveat[i + 1] - saveat[i]) / (float)substeps;
    for (int e = tid; e < tile; e += nt) {
      const int r = e / dim, d = e - r * dim;
      const int row = row0 + r;
      y[d * TB + r] = row < B ? ys[((size_t)row * T + i) * dim + d] : 0.f;
    }
    __syncthreads();
    if (substeps > 1) {
      // forward through the interval, keeping each sub-step's start state;
      // a thread reads back only the elements it wrote itself
      for (int j = 0; j < substeps; ++j) {
        for (int e = tid; e < tile; e += nt) mysub[j * tile + e] = y[e];
        if (j == substeps - 1) break;
        taped_stages<TB>(tab, f, dt, y, tape);
        const float* kbase = tape + f.h_off[f.L] * TB;
        for (int e = tid; e < tile; e += nt) {
          float v = y[e];
          for (int s = 0; s < tab.ns; ++s) {
            const float bs = tab.b[s];
            if (bs != 0.f) v = v + (dt * bs) * kbase[s * stride + e];
          }
          y[e] = v;
        }
        __syncthreads();
      }
    }
    for (int j = substeps - 1; j >= 0; --j) {
      if (substeps > 1) {
        for (int e = tid; e < tile; e += nt) y[e] = mysub[j * tile + e];
        __syncthreads();
      }
      taped_stages<TB>(tab, f, dt, y, tape);

      for (int e = tid; e < tile; e += nt) {
        const float l = lam[e];
        ybar[e] = l;
        for (int s = 0; s < tab.ns; ++s) {
          const float bs = tab.b[s];
          kbar[s * tile + e] = bs != 0.f ? (dt * bs) * l : 0.f;
        }
      }
      __syncthreads();
      for (int s = tab.ns - 1; s >= 0; --s) {
        const float* ts = tape + s * stride;
        float* cur = d0;
        {
          const float* hL = ts + f.h_off[f.L] * TB;
          const int code = f.act[f.L - 1];
          for (int e = tid; e < tile; e += nt)
            cur[e] = kbar[s * tile + e] * act_grad(code, hL[e]);
        }
        __syncthreads();
        for (int l = f.L - 1; l >= 0; --l) {
          const float* hin = ts + f.h_off[l] * TB;
          accum_dw<TB>(hin, cur, mydw + f.w_off[l], f.w[l], f.w[l + 1]);
          accum_db<TB>(cur, mydw + f.b_off[l], f.w[l + 1]);
          float* nxt = (cur == d0) ? d1 : d0;
          // delta_in = (delta W_l^T) * act'_{l-1}(h_l); the field's input
          // (l == 0) has no activation
          dense<TB, true>(cur, f.Wt[l], f.w[l + 1], f.w[l], nxt,
                          l > 0 ? kActGrad : kNone, l > 0 ? f.act[l - 1] : 0,
                          hin);
          cur = nxt;
        }
        // cur = ubar_s
        for (int e = tid; e < tile; e += nt) {
          const float ub = cur[e];
          ybar[e] += ub;
          for (int q = 0; q < s; ++q) {
            const float a = tab.a[s][q];
            if (a != 0.f) kbar[q * tile + e] += (dt * a) * ub;
          }
        }
        __syncthreads();
      }
      for (int e = tid; e < tile; e += nt) lam[e] = ybar[e];
      __syncthreads();
    }
    for (int e = tid; e < tile; e += nt) {
      const int r = e / dim, d = e - r * dim;
      const int row = row0 + r;
      if (row < B) lam[d * TB + r] += g[((size_t)row * T + i) * dim + d];
    }
    __syncthreads();
  }
  for (int e = tid; e < tile; e += nt) {
    const int r = e / dim, d = e - r * dim;
    const int row = row0 + r;
    if (row < B) du0[(size_t)row * dim + d] = lam[d * TB + r];
  }
  if (DS)
    for (int e = tid; e < f.total; e += nt) slice[e] = dws[e];
}

// ---------------------------------------------------------------------------
// Host side.

int build_field(int n_layers, const int* widths, const int* acts,
                const void* const* Ws, const void* const* Wts,
                const void* const* bs, Field* f) {
  if (n_layers < 1 || n_layers > kMaxLayers) return kErrDepth;
  if (widths == nullptr) return kErrArgs;
  *f = Field{};
  f->L = n_layers;
  int off = 0, hoff = 0;
  for (int l = 0; l <= n_layers; ++l) {
    const int w = widths[l];
    if (w < 1) return kErrArgs;
    f->w[l] = w;
    f->h_off[l] = hoff;
    hoff += w;
    if (w > f->maxw) f->maxw = w;
  }
  f->sumw = hoff;
  if (f->w[0] != f->w[n_layers]) return kErrArgs;   // dy/dt has y's shape
  for (int l = 0; l < n_layers; ++l) {
    if (acts != nullptr) {
      if (acts[l] < 0 || acts[l] > 4) return kErrArgs;
      f->act[l] = acts[l];
    }
    f->w_off[l] = off;
    off += (f->w[l] * f->w[l + 1] + 3) & ~3;
    f->b_off[l] = off;
    off += (f->w[l + 1] + 3) & ~3;
    f->W[l] = Ws ? (const float*)Ws[l] : nullptr;
    f->Wt[l] = Wts ? (const float*)Wts[l] : nullptr;
    f->b[l] = bs ? (const float*)bs[l] : nullptr;
  }
  f->total = off;
  return 0;
}

size_t fwd_smem(const Field& f, int ns, int tb, bool ws) {
  const size_t tile = (size_t)f.w[0] * tb;
  return sizeof(float) * ((2 + ns) * tile + 2 * (size_t)f.maxw * tb +
                          (ws ? f.total + 3 : 0));
}

size_t bwd_smem(const Field& f, int ns, int tb, bool ds) {
  const size_t tile = (size_t)f.w[0] * tb;
  return sizeof(float) * ((3 + ns) * tile + (size_t)ns * f.sumw * tb +
                          2 * (size_t)f.maxw * tb + (ds ? f.total + 3 : 0));
}

bool valid_rows(int rows) {
  return rows == 1 || rows == 2 || rows == 4 || rows == 8;
}

// Picks the rows per block and whether the big array of the pass lives in
// shared memory (forward: the weights; backward: the weight-gradient
// accumulators). *rows == 0 asks for the default. With the big array in
// shared memory (tried first) that is the fewest rows that still put the
// batch on the card in one wave of blocks (one block per SM): a tile's
// chain of stages is serial, so more blocks shorten it. Without, every
// block streams the array from L2 once per stage whatever its rows, so the
// default is the most rows that fit.
int plan(const Field& f, int ns, int nt, bool backward, int B, int* rows,
         bool* in_smem, size_t* bytes) {
  if (ns < 1 || ns > kMaxStages || nt < 32 || nt > kMaxThreads ||
      nt % 32 != 0 || B < 1)
    return kErrArgs;
  const int asked = *rows;
  if (asked != 0 && !valid_rows(asked)) return kErrArgs;
  int wave = 1;
  while (wave < 8 && (B + wave - 1) / wave > kWaveBlocks) wave *= 2;
  for (int pass = 0; pass < 2; ++pass) {
    const bool big = (pass == 0);
    for (int r = asked != 0 ? asked : (big ? wave : 8); r >= 1; r /= 2) {
      const size_t need = backward ? bwd_smem(f, ns, r, big)
                                   : fwd_smem(f, ns, r, big);
      if (need <= (size_t)kSmemLimit) {
        *rows = r;
        *in_smem = big;
        *bytes = need;
        return 0;
      }
      if (asked != 0) break;   // a requested tile is taken or refused
    }
  }
  return kErrFit;
}

int fill_tableau(int n_stages, const float* a, const float* b, Tableau* tab) {
  if (n_stages < 1 || n_stages > kMaxStages || a == nullptr || b == nullptr)
    return kErrArgs;
  *tab = Tableau{};
  tab->ns = n_stages;
  for (int s = 0; s < n_stages; ++s) {
    for (int q = 0; q < n_stages; ++q) tab->a[s][q] = a[s * n_stages + q];
    tab->b[s] = b[s];
  }
  return 0;
}

template <int TB, bool WS>
cudaError_t launch_fwd(const Tableau& tab, const Field& f,
                       const float* saveat, const float* u0s, float* ys,
                       int B, int T, int substeps, int nt, size_t bytes,
                       cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      node_field_fwd_kernel<TB, WS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (B + TB - 1) / TB;
  node_field_fwd_kernel<TB, WS><<<blocks, nt, bytes, st>>>(
      tab, f, saveat, u0s, ys, B, T, substeps);
  return cudaGetLastError();
}

template <int TB, bool DS>
cudaError_t launch_bwd(const Tableau& tab, const Field& f,
                       const float* saveat, const float* ys, const float* g,
                       float* du0, float* dwb, float* ysub, int B, int T,
                       int substeps, int nt, size_t bytes, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      node_field_bwd_kernel<TB, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (B + TB - 1) / TB;
  node_field_bwd_kernel<TB, DS><<<blocks, nt, bytes, st>>>(
      tab, f, saveat, ys, g, du0, dwb, ysub, B, T, substeps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ldq_node_field_max_layers() { return kMaxLayers; }

// Floats in the packed [W_0, b_0, W_1, b_1, ...] layout, or an error code.
extern "C" int ldq_node_field_packed_size(int n_layers, const int* widths) {
  Field f;
  const int rc = build_field(n_layers, widths, nullptr, nullptr, nullptr,
                             nullptr, &f);
  return rc != 0 ? rc : f.total;
}

// The launch configuration for a field and a batch of B rows: rows per
// block (*rows in: 0 = the default, else a request; out: the choice),
// whether the pass keeps its big array in shared memory (forward: the
// weights; backward: the weight-gradient accumulators), and the block's
// dynamic shared memory. Returns 0, or kErrDepth / kErrFit / kErrArgs.
extern "C" int ldq_node_field_plan(int n_layers, const int* widths,
                                   int n_stages, int threads, int backward,
                                   int B, int* rows, int* in_smem,
                                   int* smem_bytes) {
  Field f;
  int rc = build_field(n_layers, widths, nullptr, nullptr, nullptr, nullptr,
                       &f);
  if (rc != 0) return rc;
  if (rows == nullptr) return kErrArgs;
  bool ws = false;
  size_t bytes = 0;
  rc = plan(f, n_stages, threads, backward != 0, B, rows, &ws, &bytes);
  if (rc != 0) return rc;
  if (in_smem) *in_smem = ws ? 1 : 0;
  if (smem_bytes) *smem_bytes = (int)bytes;
  return 0;
}

// Forward solve. widths: n_layers + 1 ints; acts: n_layers activation
// codes; Ws / bs: n_layers device pointers (float32, W_l row-major
// (widths[l], widths[l+1])); a: n_stages x n_stages row-major, b: n_stages,
// both float32 on the host; saveat (T,), u0s (B, dim), ys (B, T, dim) on
// the device. rows: 0 = default. Returns 0 on a successful launch, a
// cudaError_t (> 0) or a negative code above. Does not synchronise.
extern "C" int ldq_node_field_fwd(int n_layers, const int* widths,
                                  const int* acts, const void* const* Ws,
                                  const void* const* bs, int n_stages,
                                  const float* a, const float* b,
                                  const float* saveat, const float* u0s,
                                  float* ys, int B, int T, int substeps,
                                  int rows, int threads, void* stream) {
  if (B < 1 || T < 1 || substeps < 1 || acts == nullptr || Ws == nullptr ||
      bs == nullptr || saveat == nullptr || u0s == nullptr || ys == nullptr)
    return kErrArgs;
  Field f;
  int rc = build_field(n_layers, widths, acts, Ws, nullptr, bs, &f);
  if (rc != 0) return rc;
  Tableau tab;
  rc = fill_tableau(n_stages, a, b, &tab);
  if (rc != 0) return rc;
  bool ws = false;
  size_t bytes = 0;
  rc = plan(f, n_stages, threads, false, B, &rows, &ws, &bytes);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
#define LDQ_FWD_CASE(TB)                                                    \
  case TB:                                                                  \
    e = ws ? launch_fwd<TB, true>(tab, f, saveat, u0s, ys, B, T, substeps,  \
                                  threads, bytes, st)                       \
           : launch_fwd<TB, false>(tab, f, saveat, u0s, ys, B, T, substeps, \
                                   threads, bytes, st);                     \
    break;
  switch (rows) {
    LDQ_FWD_CASE(8)
    LDQ_FWD_CASE(4)
    LDQ_FWD_CASE(2)
    LDQ_FWD_CASE(1)
  }
#undef LDQ_FWD_CASE
  return (int)e;
}

// Backward sweep. Wts: W_l transposed (widths[l+1], widths[l]) row-major.
// ys, g (B, T, dim); du0 (B, dim); dwb (n_blocks, packed size), zeroed by
// the caller on this stream, n_blocks = ceil(B / rows); ysub (n_blocks,
// substeps, dim * rows) scratch, may be null when substeps == 1. `rows`
// must be the value ldq_node_field_plan gave for this B (it sizes dwb).
extern "C" int ldq_node_field_bwd(int n_layers, const int* widths,
                                  const int* acts, const void* const* Ws,
                                  const void* const* Wts,
                                  const void* const* bs, int n_stages,
                                  const float* a, const float* b,
                                  const float* saveat, const float* ys,
                                  const float* g, float* du0, float* dwb,
                                  float* ysub, int B, int T, int substeps,
                                  int rows, int threads, void* stream) {
  if (B < 1 || T < 1 || substeps < 1 || acts == nullptr || Ws == nullptr ||
      Wts == nullptr || bs == nullptr || saveat == nullptr ||
      ys == nullptr || g == nullptr || du0 == nullptr || dwb == nullptr ||
      (substeps > 1 && ysub == nullptr) || !valid_rows(rows))
    return kErrArgs;
  Field f;
  int rc = build_field(n_layers, widths, acts, Ws, Wts, bs, &f);
  if (rc != 0) return rc;
  Tableau tab;
  rc = fill_tableau(n_stages, a, b, &tab);
  if (rc != 0) return rc;
  bool ds = false;
  size_t bytes = 0;
  rc = plan(f, n_stages, threads, true, B, &rows, &ds, &bytes);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
#define LDQ_BWD_CASE(TB)                                                   \
  case TB:                                                                 \
    e = ds ? launch_bwd<TB, true>(tab, f, saveat, ys, g, du0, dwb, ysub,   \
                                  B, T, substeps, threads, bytes, st)      \
           : launch_bwd<TB, false>(tab, f, saveat, ys, g, du0, dwb, ysub,  \
                                   B, T, substeps, threads, bytes, st);    \
    break;
  switch (rows) {
    LDQ_BWD_CASE(8)
    LDQ_BWD_CASE(4)
    LDQ_BWD_CASE(2)
    LDQ_BWD_CASE(1)
  }
#undef LDQ_BWD_CASE
  return (int)e;
}
