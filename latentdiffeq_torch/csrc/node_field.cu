// Batched fixed-grid explicit Runge-Kutta solve of dy/dt = MLP(y) for a
// Chain-of-Dense vector field, and its gradient, as three kernels:
//   node_field_fwd_kernel  the solve; optionally writes a tape of every
//                          layer output of every stage of every step;
//   node_field_bwd_kernel  the reverse sweep over that tape: the cotangent
//                          of the state and, for every stage and layer, the
//                          cotangent of the layer's pre-activation (Delta);
//   node_field_dw_kernel   the weight gradients dW_l = H_l^T Delta_l and
//                          db_l = sum Delta_l over all rows, steps and stages.
//
// Replaces the Pallas TPU kernel latentdiffeq/ops/node_pallas.py
// (`pallas_solve_neural_field`: forward `_node_kernel`, backward
// `_node_bwd_kernel`). The field ignores t. Success flags and counters are
// computed outside, as in the JAX package. The TPU backward recomputes each
// interval's stages from ys so that nothing goes to device memory; on an
// 80 GB card the tape (64 rows x 294 stages x 432 floats = 32.5 MB at the
// main path's training shape) is cheap, and keeping it takes a whole
// product off the backward's serial chain.
//
// What bounds it: a serial chain of (T-1) * substeps * stages field
// evaluations, each a chain of L small dense layers separated by block
// barriers; at the main path's sizes (64 or 45 rows, widths 16-200-200-16)
// the bytes and the float32 operations are worth microseconds, so the
// solve and the sweep are bound by the latency of one link of that chain.
// Design:
//   * one block per tile of TB = 1 or 2 batch rows (as few as still put
//     the rows on the card in one wave): the chain is serial within a
//     tile, so spreading rows over SMs is what shortens it. State, slopes,
//     activations and cotangents of the tile stay in shared memory,
//     feature-major ([feature][row]);
//   * a population of S fields (a vmapped population's replicas) is one
//     launch: grid (tiles of B rows, 1, S), z the replica, each block
//     reading its replica's weights and rows. TB counts the S * B rows
//     against the SMs, and a tile never spans two replicas, so a replica
//     is computed as its own launch at the same TB computes it;
//   * the largest layer with at most 208 outputs, a multiple of 4, keeps
//     rows 0..159 of its weights in registers for the whole solve: 416
//     threads = 52 groups of 4 columns x 8 slices of the reduction, 80
//     weights a thread (its further rows, 40 of a 200 x 200 layer, stay in
//     shared memory: 13 warps may have 128 registers a thread, and 100
//     weights a thread spilled). A 200 x 200 layer at one row with all its
//     weights in registers takes 455 ns against 1628 ns streamed from
//     shared memory (scripts/node_field_levers.py, H100). The other layers
//     sit in shared memory, or are read through the read-only cache when
//     they do not fit (the 128-256-256-128 field);
//   * in a dense layer a thread owns 4 adjacent output columns (1 for a
//     width that is no multiple of 4) and one slice of the reduction; the
//     partial sums of a column sit in one warp and are added by a shuffle
//     butterfly in a fixed order (no atomics), then one block barrier. A
//     block barrier costs 62 ns, a cluster barrier with a distributed
//     shared-memory exchange 692 ns (same script), so no clusters;
//   * one barrier per layer and nothing else: the stage inputs and the
//     solution update are accumulated as each slope comes, in the last
//     layer's epilogue, by the thread that owns the column (the same thread
//     at every stage); the sweep's ybar / kbar updates likewise inside its
//     last product's epilogue;
//   * the sweep runs only the input-gradient products, with transposed
//     weights and the activation derivatives taken from the tape. The next
//     step's tape slice and g row come into shared memory by cp.async while
//     the current step computes; Delta is streamed out as it is produced;
//   * the weight gradient is a product over all the records (B x steps x
//     stages: 18,816 at the train shape, whose tape and Delta, 32.5 + 31.3
//     MB, exceed the 50 MB L2 together), so it is bound by their bytes:
//     tiles shaped to the layers (a whole input width plus the bias row a
//     tile), a cp.async ring, 3xTF32 on the tensor cores, split-K over the
//     SMs with the splits added inside the kernel in a fixed order (thread
//     block clusters, then an integer semaphore), and a replica axis (see
//     node_field_dw_kernel).
// The reverse recursion, for u_s = y + dt sum_q a_sq k_q, k_s = F(u_s),
// y1 = y + dt sum_s b_s k_s: kbar_s = dt b_s lambda, ybar = lambda, and for
// s = S-1..0: ubar_s = J_F(u_s)^T kbar_s, ybar += ubar_s, kbar_q += dt a_sq
// ubar_s. Rows past the batch end carry zero state and zero cotangent and
// are never stored.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxStages = 7;
constexpr int kMaxLayers = 8;
constexpr int kThreads = 512;        // the launch bound without a register layer
constexpr int kRegThreads = 416;     // with one: 13 warps
constexpr int kRegKS = 20;           // reduction values a slice holds in
                                     // registers: rows 0..159 of W
constexpr int kRegRows = 8 * kRegKS;
constexpr int kRegMaxOut = 4 * 4 * (kRegThreads / 32);   // 208
constexpr int kSmemLimit = 232448;   // bytes a block may use on sm_90

// Error codes of the C interface besides cudaError_t (which is positive).
constexpr int kErrDepth = -1;   // more than kMaxLayers layers (or none)
constexpr int kErrFit = -2;     // the tile does not fit in shared memory
constexpr int kErrArgs = -3;    // any other invalid argument
constexpr int kErrTiles = -4;   // the weight-gradient plan needs more tiles
                                // than the kernel's table holds

// Where a pass keeps its weights.
enum Place { kReg = 0, kSmem = 1, kGlobal = 2 };

struct Tableau {
  float a[kMaxStages][kMaxStages];
  float b[kMaxStages];
  int ns;
};

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// The field: L dense layers h <- act(h W_l + b_l), W_l (w[l], w[l+1])
// row-major. w_off / b_off: offsets of W_l and b_l in the packed layout
// [W_0, b_0, W_1, b_1, ...] (each piece padded to a multiple of 4 floats)
// of the weight gradient. A tape record (one row, step and stage) holds
// h_0 = the stage input, h_1, ..., h_L = the slope at hp_off[l], each
// padded to 4 floats, sumw4 in all; a Delta record holds the cotangent of
// layer l's pre-activation at dp_off[l], dsum4 in all. reg: the layer whose
// weights the pass keeps in registers (-1: none); sw_off / sb_off: offsets
// of the weights / biases in the pass's shared-memory copy (-1: not there).
struct Field {
  int L;
  int w[kMaxLayers + 1];
  int act[kMaxLayers];
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int hp_off[kMaxLayers + 1];
  int dp_off[kMaxLayers];
  int total;   // packed size in floats
  int sumw4;
  int dsum4;
  int maxw;
  int reg;
  int sw_off[kMaxLayers];
  int sb_off[kMaxLayers];
  int sw_total;
  const float* W[kMaxLayers];    // forward: W_l; sweep: W_l transposed
  const float* b[kMaxLayers];
};

// The weights of the block's replica (grid z): the replicas' W_l, and
// their b_l, lie one after another, w[l] * w[l + 1] (w[l + 1]) floats
// apart; the sweep's transposed W_l have the same size.
__device__ __forceinline__ const float* replica_w(const Field& f, int l) {
  return f.W[l] + (size_t)blockIdx.z * f.w[l] * f.w[l + 1];
}

__device__ __forceinline__ const float* replica_b(const Field& f, int l) {
  return f.b[l] + (size_t)blockIdx.z * f.w[l + 1];
}

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
  if constexpr (TB == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
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

// ---------------------------------------------------------------------------
// Operands of a dense layer, row values of input feature k for the tile.

// A feature-major buffer in shared memory.
template <int TB>
struct RowsIn {
  const float* p;
  __device__ __forceinline__ void load(int k, float (&h)[TB]) const {
    load_rows<TB>(p + k * TB, h);
  }
};

// The sweep's first product input: kbar_s * act'(h_L), h_L in the tape
// buffer ([row][feature], rows `rstride` apart).
template <int TB>
struct CotIn {
  const float* kbar;
  const float* hL;
  int rstride;
  int code;
  __device__ __forceinline__ void load(int k, float (&h)[TB]) const {
#pragma unroll
    for (int r = 0; r < TB; ++r)
      h[r] = kbar[k * TB + r] * act_grad(code, hL[r * rstride + k]);
  }
};

// ---------------------------------------------------------------------------
// Dense layers. out[n][r] = epi(sum_k in[k][r] * W[k][n]); the thread that
// finishes (n, r) stores it and then calls post(n, r, idx, value).

enum Epilogue { kBiasAct = 0, kActGrad = 1, kNone = 2 };

// `aux`: the bias (kBiasAct) or the activation outputs, [row][feature]
// with rows `arow` apart (kActGrad).
__device__ __forceinline__ float epilogue(int epi, int code, float v,
                                          const float* __restrict__ aux,
                                          int arow, int n, int r) {
  if (epi == kBiasAct) return act_fn(code, v + aux[n]);
  if (epi == kActGrad) return v * act_grad(code, aux[r * arow + n]);
  return v;
}

// acc[c * TB + r] += sum_{k = k0, k0 + STRIDE, ... < in_dim} in[k][r] *
// W[k][n0 + c], c < CT. With CT == 4 the four weights come in one 16-byte
// load (n0 and out_dim are multiples of 4 then, and W is 16-byte aligned).
template <int TB, int CT, bool GW, int STRIDE, int UNROLL, class In>
__device__ __forceinline__ void mac_slice(const In& in,
                                          const float* __restrict__ W,
                                          int in_dim, int out_dim, int n0,
                                          int k0, float (&acc)[CT * TB]) {
#pragma unroll UNROLL
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
    in.load(k, h);
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int r = 0; r < TB; ++r)
        acc[c * TB + r] = fmaf(h[r], w[c], acc[c * TB + r]);
  }
}

// A warp's 32 lanes are 2^SB slices of the reduction dimension
// (k = slice, slice + 2^SB, ...) x 32 >> SB groups of CT adjacent columns;
// the partial sums of a group are added and dealt out over its lanes by
// `reduce_scatter`, and each lane finishes and stores its share. Ends with
// a block barrier.
template <int TB, int CT, bool GW, int SB, int UNROLL, class In, class Post>
__device__ __forceinline__ void dense_sb(const In& in,
                                         const float* __restrict__ W,
                                         int in_dim, int out_dim,
                                         float* __restrict__ out, int epi,
                                         int code,
                                         const float* __restrict__ aux,
                                         int arow, const Post& post) {
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
      mac_slice<TB, CT, GW, (1 << SB), UNROLL>(in, W, in_dim, out_dim, n0,
                                               slice, acc);
    const int base = reduce_scatter<N, SB>(acc, slice, G);
    // lanes that differ only in slice bits above the scatter hold copies
    if (live && (slice >> SCATTER) == 0) {
#pragma unroll
      for (int i = 0; i < MINE; ++i) {
        const int j = base + i;            // = c * TB + r
        const int n = n0 + j / TB, r = j % TB;
        const int idx = n0 * TB + j;
        const float v = epilogue(epi, code, acc[i], aux, arow, n, r);
        out[idx] = v;
        post(n, r, idx, v);
      }
    }
  }
  __syncthreads();
}

// A layer with no more column groups than the block has warps gives every
// group a whole warp (32 slices); otherwise a warp takes 4 groups of 8
// slices. UNROLL: of the reduction loop (1 where registers are scarce).
template <int TB, bool GW, int UNROLL, class In, class Post>
__device__ __forceinline__ void dense(const In& in,
                                      const float* __restrict__ W,
                                      int in_dim, int out_dim,
                                      float* __restrict__ out, int epi,
                                      int code,
                                      const float* __restrict__ aux,
                                      int arow, const Post& post) {
  const int nwarps = blockDim.x >> 5;
  if (out_dim % 4 == 0) {
    if (out_dim / 4 <= nwarps)
      dense_sb<TB, 4, GW, 5, UNROLL>(in, W, in_dim, out_dim, out, epi, code, aux,
                             arow, post);
    else
      dense_sb<TB, 4, GW, 3, UNROLL>(in, W, in_dim, out_dim, out, epi, code, aux,
                             arow, post);
  } else {
    if (out_dim <= nwarps)
      dense_sb<TB, 1, GW, 5, UNROLL>(in, W, in_dim, out_dim, out, epi, code, aux,
                             arow, post);
    else
      dense_sb<TB, 1, GW, 3, UNROLL>(in, W, in_dim, out_dim, out, epi, code, aux,
                             arow, post);
  }
}

// The register layer's weights: group cg = warp * 4 + lane % 4 owns columns
// 4 cg .. 4 cg + 3, slice = lane / 4 owns k = slice + 8 i; for i < kRegKS
// wr[c * kRegKS + i] = W[k][4 cg + c], zero past the layer's edges. Rows
// from kRegRows on stay in shared memory: 100 weights a thread for a
// 200 x 200 layer would leave too few of the 128 registers a thread of 13
// warps may have (4 warps share a quarter of the register file) for the
// rest of the solve, and the compiler would spill.
__device__ __forceinline__ void load_reg_weights(
    const float* __restrict__ W, int in_dim, int out_dim,
    float (&wr)[4 * kRegKS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = lane >> 2;
  const int cg = warp * 4 + (lane & 3);
  const bool live = cg < out_dim / 4;
#pragma unroll
  for (int i = 0; i < kRegKS; ++i) {
    const int k = slice + 8 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wr[c * kRegKS + i] =
          (live && k < in_dim) ? W[(size_t)k * out_dim + cg * 4 + c] : 0.f;
  }
}

// The same product as dense_sb<TB, 4, *, 3> (same slices, same order of
// additions) with rows 0..kRegRows-1 of the weights in registers and the
// rest (`tail`, (in_dim - kRegRows) x out_dim) in shared memory; every
// group is live at once.
template <int TB, class In, class Post>
__device__ __forceinline__ void dense_reg(const In& in,
                                          const float (&wr)[4 * kRegKS],
                                          const float* __restrict__ tail,
                                          int in_dim, int out_dim,
                                          float* __restrict__ out, int epi,
                                          int code,
                                          const float* __restrict__ aux,
                                          int arow, const Post& post) {
  constexpr int N = 4 * TB;
  constexpr int SCATTER = ilog2(N) < 3 ? ilog2(N) : 3;
  constexpr int MINE = N >> SCATTER;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = lane >> 2;
  const int cg = warp * 4 + (lane & 3);
  const bool live = cg < out_dim / 4;
  const int n0 = cg * 4;
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kRegKS; ++i) {
    const int k = slice + 8 * i;
    if (k < in_dim) {
      float h[TB];
      in.load(k, h);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < TB; ++r)
          acc[c * TB + r] = fmaf(h[r], wr[c * kRegKS + i], acc[c * TB + r]);
    }
  }
  if (live) {
#pragma unroll 1
    for (int k = kRegRows + slice; k < in_dim; k += 8) {
      const float4 q = *reinterpret_cast<const float4*>(
          tail + (size_t)(k - kRegRows) * out_dim + n0);
      const float w[4] = {q.x, q.y, q.z, q.w};
      float h[TB];
      in.load(k, h);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < TB; ++r)
          acc[c * TB + r] = fmaf(h[r], w[c], acc[c * TB + r]);
    }
  }
  const int base = reduce_scatter<N, 3>(acc, slice, 4);
  if (live && (slice >> SCATTER) == 0) {
#pragma unroll
    for (int i = 0; i < MINE; ++i) {
      const int j = base + i;
      const int n = n0 + j / TB, r = j % TB;
      const int idx = n0 * TB + j;
      const float v = epilogue(epi, code, acc[i], aux, arow, n, r);
      out[idx] = v;
      post(n, r, idx, v);
    }
  }
  __syncthreads();
}

// Layer l of a pass: from registers, shared memory or global memory.
template <int TB, int PL, class In, class Post>
__device__ __forceinline__ void layer(const Field& f, int l,
                                      const float (&wr)[4 * kRegKS],
                                      const float* __restrict__ wsm,
                                      const In& in, int in_dim, int out_dim,
                                      float* __restrict__ out, int epi,
                                      int code,
                                      const float* __restrict__ aux,
                                      int arow, const Post& post) {
  if constexpr (PL == kReg) {
    if (l == f.reg) {
      dense_reg<TB>(in, wr, wsm + f.sw_off[l], in_dim, out_dim, out, epi,
                    code, aux, arow, post);
      return;
    }
    dense<TB, false, 1>(in, wsm + f.sw_off[l], in_dim, out_dim, out, epi,
                        code, aux, arow, post);
  } else if constexpr (PL == kGlobal) {
    dense<TB, true, 4>(in, replica_w(f, l), in_dim, out_dim, out, epi, code,
                       aux, arow, post);
  } else {
    dense<TB, false, 4>(in, wsm + f.sw_off[l], in_dim, out_dim, out, epi,
                        code, aux, arow, post);
  }
}

// The tableau in shared memory: a at [s * kMaxStages + q], b after it.
__device__ __forceinline__ void stage_tableau(const Tableau& tab,
                                              float* tabsm) {
  for (int e = threadIdx.x; e < kMaxStages * (kMaxStages + 1);
       e += blockDim.x) {
    const int s = e / kMaxStages, q = e % kMaxStages;
    tabsm[e] = s < kMaxStages ? tab.a[s][q] : tab.b[q];
  }
}

// Copies the pass's shared-memory weights (the register layer's rows from
// kRegRows on only) and, forward, biases. `backward`: the pass's layer l
// is W_l transposed, (w[l+1], w[l]).
__device__ __forceinline__ void stage_weights(const Field& f, float* wsm,
                                              bool backward) {
  const bool biases = !backward;
  for (int l = 0; l < f.L; ++l) {
    const int in = backward ? f.w[l + 1] : f.w[l];
    const int out = backward ? f.w[l] : f.w[l + 1];
    const int skip = l == f.reg ? kRegRows * out : 0;
    const int nw = in * out - skip;
    if (f.sw_off[l] >= 0)
      for (int e = threadIdx.x; e < nw; e += blockDim.x)
        wsm[f.sw_off[l] + e] = replica_w(f, l)[skip + e];
    if (biases && f.sb_off[l] >= 0)
      for (int e = threadIdx.x; e < f.w[l + 1]; e += blockDim.x)
        wsm[f.sb_off[l] + e] = replica_b(f, l)[e];
  }
}

// ---------------------------------------------------------------------------
// Forward: ys[b, 0] = u0s[b]; ys[b, i + 1] = `substeps` RK steps from
// ys[b, i]. With `tape`, every layer output of every stage of every step
// goes to tape[((b * nsteps + step) * ns + s) * sumw4 + hp_off[l] + n].

// The stage inputs are accumulated as the slopes come: u_s = y + sum_{q <
// s} (dt a_sq) k_q and y1 = y + sum_s (dt b_s) k_s, both in the order of q
// (the order of `rk_step`), by the thread that finishes column n of the
// last layer, which is the same thread at every stage. So a stage's first
// layer reads its input ready-made and nothing waits for a separate pass.
// The last layer's epilogue: the slope to the tape; k_s into every later
// stage input and into y; the next stage input (complete now) to the tape;
// after the last stage the save point and every stage input reset to the
// new y (unless `reset` is false: with one layer the operands read them,
// so that waits for the layer's barrier).
template <int TB>
struct FwdPost {
  float* rec;          // the tape record of row 0 at this stage, or null
  size_t rstride;      // tape floats between rows
  int hoff;            // where this layer's output goes in a record
  int nvalid;          // rows of the tile inside the batch
  bool last;           // the field's last layer: the rest applies
  float* uacc;         // ns stage inputs, `tile` apart
  float* yacc;
  const float* tabsm;  // a at [s * kMaxStages + q], b after it
  int s, ns, tile;
  float dt;
  bool more;           // a later stage input exists (this step or next)
  int h0off, sumw4;
  float* ysave;        // &ys[row0, i + 1, 0] after the last stage, or null
  size_t ystride;
  bool reset;          // after the last stage: reset the stage inputs
  __device__ __forceinline__ void operator()(int n, int r, int idx,
                                             float v) const {
    const bool store = rec != nullptr && r < nvalid;
    if (store) rec[r * rstride + hoff + n] = v;
    if (!last) return;
    for (int q = s + 1; q < ns; ++q) {
      const float a = tabsm[q * kMaxStages + s];
      if (a != 0.f) uacc[q * tile + idx] += (dt * a) * v;
    }
    const float bs = tabsm[kMaxStages * kMaxStages + s];
    float yv = yacc[idx];
    if (bs != 0.f) yv = yv + (dt * bs) * v;
    yacc[idx] = yv;
    if (s < ns - 1) {
      if (store && more)
        rec[r * rstride + sumw4 + h0off + n] = uacc[(s + 1) * tile + idx];
      return;
    }
    if (ysave != nullptr && r < nvalid) ysave[r * ystride + n] = yv;
    if (!reset) return;
    for (int q = 0; q < ns; ++q) uacc[q * tile + idx] = yv;
    if (store && more) rec[r * rstride + sumw4 + h0off + n] = yv;
  }
};

template <int TB, int PL>
__global__ void __launch_bounds__(PL == kReg ? kRegThreads : kThreads, 1)
node_field_fwd_kernel(Tableau tab, Field f,
                      const float* __restrict__ saveat,
                      const float* __restrict__ u0s, float* __restrict__ ys,
                      float* __restrict__ tape, int B, int T,
                      int substeps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dim = f.w[0];
  const int tile = dim * TB;
  const int row0 = blockIdx.x * TB;
  const int nvalid = min(TB, B - row0);
  const int ns = tab.ns;
  const int nsteps = (T - 1) * substeps;
  const size_t rstride = (size_t)nsteps * ns * f.sumw4;
  // the block's replica (grid z): its B rows of u0s, ys and the tape
  const size_t rep = blockIdx.z;
  u0s += rep * B * dim;
  ys += rep * B * T * dim;
  if (tape != nullptr) tape += rep * B * rstride;
  float* tabsm = smem;                            // kMaxStages * 8
  float* yacc = tabsm + kMaxStages * (kMaxStages + 1);
  float* uacc = yacc + pad4(tile);                // ns stage inputs
  float* h0 = uacc + pad4(ns * tile);
  float* h1 = h0 + pad4(f.maxw * TB);
  float* wsm = h1 + pad4(f.maxw * TB);            // f.sw_total floats

  float wr[4 * kRegKS];
  if constexpr (PL == kReg)
    load_reg_weights(replica_w(f, f.reg), f.w[f.reg], f.w[f.reg + 1], wr);
  stage_tableau(tab, tabsm);
  if (PL != kGlobal) stage_weights(f, wsm, false);
  float* tape0 = tape == nullptr ? nullptr : tape + (size_t)row0 * rstride;
  for (int e = tid; e < tile; e += nt) {
    const int r = e / dim, d = e - r * dim;
    float v = 0.f;
    if (r < nvalid) {
      v = u0s[(size_t)(row0 + r) * dim + d];
      ys[(size_t)(row0 + r) * T * dim + d] = v;
      if (tape0 != nullptr && nsteps > 0)
        tape0[r * rstride + f.hp_off[0] + d] = v;
    }
    yacc[d * TB + r] = v;
    for (int q = 0; q < ns; ++q) uacc[q * tile + d * TB + r] = v;
  }
  __syncthreads();

  const int L = f.L;
  for (int i = 0; i < T - 1; ++i) {
    const float dt = (saveat[i + 1] - saveat[i]) / (float)substeps;
    for (int j = 0; j < substeps; ++j) {
      const int step = i * substeps + j;
      for (int s = 0; s < ns; ++s) {
        const size_t at = (size_t)step * ns + s;
        float* rec = tape0 == nullptr ? nullptr : tape0 + at * f.sumw4;
        const bool last_stage = (s == ns - 1);
        for (int l = 0; l < L; ++l) {
          const bool last = (l == L - 1);
          float* out = (l & 1) ? h1 : h0;
          const float* in = l == 0 ? uacc + s * tile : ((l & 1) ? h0 : h1);
          const float* bias =
              PL == kGlobal ? replica_b(f, l) : wsm + f.sb_off[l];
          const FwdPost<TB> post{
              rec, rstride, f.hp_off[l + 1], nvalid, last, uacc, yacc,
              tabsm, s, ns, tile, dt, at + 1 < (size_t)nsteps * ns,
              f.hp_off[0], f.sumw4,
              last_stage && j == substeps - 1
                  ? ys + ((size_t)row0 * T + i + 1) * dim
                  : nullptr,
              (size_t)T * dim, L > 1};
          layer<TB, PL>(f, l, wr, wsm, RowsIn<TB>{in}, f.w[l], f.w[l + 1],
                        out, kBiasAct, f.act[l], bias, 0, post);
        }
      }
      if (L == 1) {
        for (int e = tid; e < tile; e += nt) {
          const int d = e / TB, r = e - d * TB;
          for (int q = 0; q < ns; ++q) uacc[q * tile + e] = yacc[e];
          if (tape0 != nullptr && r < nvalid && step + 1 < nsteps)
            tape0[r * rstride + (size_t)(step + 1) * ns * f.sumw4 +
                  f.hp_off[0] + d] = yacc[e];
        }
        __syncthreads();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Reverse sweep over the tape: lambda <- g[:, T-1]; for every step from
// the last: pull lambda back through its stages, adding g[:, i] at the
// start of interval i; Delta of every stage and layer to
// delta[((b * nsteps + step) * ns + s) * dsum4 + dp_off[l] + n].

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Products for layers l >= 1: Delta_{l-1} to device memory.
struct DeltaPost {
  float* rec;          // the Delta record of row 0 at this stage
  size_t rstride;
  int doff;
  int nvalid;
  __device__ __forceinline__ void operator()(int n, int r, int, float v)
      const {
    if (r < nvalid) rec[r * rstride + doff + n] = v;
  }
};

// The product for layer 0 gives ubar_s: ybar += ubar_s, kbar_q += dt a_sq
// ubar_s; after stage 0 the step is done: lambda = ybar (+ g at the start
// of an interval), then the next (earlier) step's kbar_q = dt' b_q lambda
// and ybar = lambda (unless `init_next` is false: with one layer the
// product's operands read kbar, so that waits for its barrier), or du0 =
// lambda after the first step.
template <int TB>
struct UbarPost {
  float* ybar;
  float* kbar;
  const float* arow;    // a_s. in shared memory
  const float* bsm;
  int s, tile;
  float dt;
  bool step_end;
  const float* gadd;    // g[:, i] in shared memory, or null
  float dt_next;        // the next step's dt (step_end)
  bool init_next;
  float* du0;           // &du0[row0, 0] after the first step, else null
  int dim, nvalid;
  int ns;
  __device__ __forceinline__ void operator()(int n, int r, int idx,
                                             float v) const {
    float yb = ybar[idx] + v;
    for (int q = 0; q < s; ++q) {
      const float a = arow[q];
      if (a != 0.f) kbar[q * tile + idx] += (dt * a) * v;
    }
    if (!step_end) {
      ybar[idx] = yb;
      return;
    }
    if (gadd != nullptr) yb += gadd[idx];
    ybar[idx] = yb;
    if (du0 != nullptr) {
      if (r < nvalid) du0[r * dim + n] = yb;
      return;
    }
    if (!init_next) return;
    for (int q = 0; q < ns; ++q) {
      const float bq = bsm[q];
      kbar[q * tile + idx] = bq != 0.f ? (dt_next * bq) * yb : 0.f;
    }
  }
};

template <int TB, int PL>
__global__ void __launch_bounds__(PL == kReg ? kRegThreads : kThreads, 1)
node_field_bwd_kernel(Tableau tab, Field f,
                      const float* __restrict__ saveat,
                      const float* __restrict__ tape,
                      const float* __restrict__ g, float* __restrict__ du0,
                      float* __restrict__ delta, int B, int T,
                      int substeps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dim = f.w[0];
  const int tile = dim * TB;
  const int row0 = blockIdx.x * TB;
  const int nvalid = min(TB, B - row0);
  const int ns = tab.ns;
  const int L = f.L;
  const int rec4 = f.sumw4;
  float* tabsm = smem;
  float* ybar = tabsm + kMaxStages * (kMaxStages + 1);
  float* kbar = ybar + pad4(tile);               // ns cotangents
  float* d0 = kbar + pad4(ns * tile);
  float* d1 = d0 + pad4(f.maxw * TB);
  float* gbuf = d1 + pad4(f.maxw * TB);          // 2 x tile
  float* tbuf = gbuf + 2 * pad4(tile);           // 2 x ns x TB x rec4
  float* wsm = tbuf + 2 * ns * TB * rec4;        // f.sw_total floats
  const float* bsm = tabsm + kMaxStages * kMaxStages;
  const int nsteps = (T - 1) * substeps;
  const size_t rstride = (size_t)nsteps * ns * rec4;
  const size_t drstride = (size_t)nsteps * ns * f.dsum4;
  // the block's replica (grid z): its B rows of the tape, g, du0 and Delta
  const size_t rep = blockIdx.z;
  tape += rep * B * rstride;
  g += rep * B * T * dim;
  du0 += rep * B * dim;
  delta += rep * B * drstride;

  float wr[4 * kRegKS];
  if constexpr (PL == kReg)
    load_reg_weights(replica_w(f, f.reg), f.w[f.reg + 1], f.w[f.reg], wr);
  stage_tableau(tab, tabsm);
  if (PL != kGlobal) stage_weights(f, wsm, true);
  for (int e = tid; e < 2 * ns * TB * rec4; e += nt) tbuf[e] = 0.f;
  for (int e = tid; e < 2 * pad4(tile); e += nt) gbuf[e] = 0.f;
  __syncthreads();

  // step `step`'s tape slice (and g[:, i] at the start of interval i) to
  // buffer `slot`, asynchronously; [stage][row][feature]
  auto prefetch = [&](int step, int slot) {
    float* tb = tbuf + slot * ns * TB * rec4;
    const int chunks = rec4 / 4;
    for (int e = tid; e < ns * nvalid * chunks; e += nt) {
      const int c = e % chunks, sr = e / chunks;
      const int r = sr % nvalid, s = sr / nvalid;
      cp_async16(tb + (s * TB + r) * rec4 + 4 * c,
                 tape + (size_t)(row0 + r) * rstride +
                     ((size_t)step * ns + s) * rec4 + 4 * c);
    }
    if (step % substeps == 0) {
      const int i = step / substeps;
      float* gb = gbuf + slot * pad4(tile);
      for (int e = tid; e < nvalid * dim; e += nt) {
        const int r = e / dim, d = e - r * dim;
        cp_async4(gb + d * TB + r, g + ((size_t)(row0 + r) * T + i) * dim + d);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // lambda = g[:, T-1]: ybar = lambda, kbar_q = dt b_q lambda
  {
    const float dt_last =
        T > 1 ? (saveat[T - 1] - saveat[T - 2]) / (float)substeps : 0.f;
    for (int e = tid; e < tile; e += nt) {
      const int d = e / TB, r = e - d * TB;
      const float lam =
          r < nvalid ? g[((size_t)(row0 + r) * T + (T - 1)) * dim + d] : 0.f;
      ybar[e] = lam;
      for (int q = 0; q < ns; ++q) {
        const float bq = tab.b[q];
        kbar[q * tile + e] = bq != 0.f ? (dt_last * bq) * lam : 0.f;
      }
      if (nsteps == 0 && r < nvalid) du0[(size_t)(row0 + r) * dim + d] = lam;
    }
  }
  if (nsteps > 0) prefetch(nsteps - 1, (nsteps - 1) & 1);
  cp_async_wait_all();
  __syncthreads();

  for (int step = nsteps - 1; step >= 0; --step) {
    const int slot = step & 1;
    if (step > 0) prefetch(step - 1, slot ^ 1);
    const int i = step / substeps;
    const float dt = (saveat[i + 1] - saveat[i]) / (float)substeps;
    const int ip = (step - 1) / substeps;
    const float dt_next =
        step > 0 ? (saveat[ip + 1] - saveat[ip]) / (float)substeps : 0.f;
    const float* tb = tbuf + slot * ns * TB * rec4;
    for (int s = ns - 1; s >= 0; --s) {
      const float* ts = tb + s * TB * rec4;      // [row][feature]
      float* drec = delta + (size_t)row0 * drstride +
                    ((size_t)step * ns + s) * f.dsum4;
      const CotIn<TB> cin{kbar + s * tile, ts + f.hp_off[L], rec4,
                          f.act[L - 1]};
      // Delta_{L-1} = kbar_s * act'(h_L)
      for (int e = tid; e < tile; e += nt) {
        const int d = e / TB, r = e - d * TB;
        if (r < nvalid) {
          float h[TB];
          cin.load(d, h);
          drec[r * drstride + f.dp_off[L - 1] + d] = h[r];
        }
      }
      float* cur = d0;
      for (int l = L - 1; l >= 0; --l) {
        float* nxt = (cur == d0) ? d1 : d0;
        // in: w[l + 1] features, out: w[l]
        if (l > 0) {
          const DeltaPost post{drec, drstride, f.dp_off[l - 1], nvalid};
          if (l == L - 1)
            layer<TB, PL>(f, l, wr, wsm, cin, f.w[l + 1], f.w[l], nxt,
                          kActGrad, f.act[l - 1], ts + f.hp_off[l], rec4,
                          post);
          else
            layer<TB, PL>(f, l, wr, wsm, RowsIn<TB>{cur}, f.w[l + 1], f.w[l],
                          nxt, kActGrad, f.act[l - 1], ts + f.hp_off[l],
                          rec4, post);
        } else {
          const bool step_end = (s == 0);
          if (step_end) cp_async_wait_all();   // the next slot, before the
                                               // product's closing barrier
          const UbarPost<TB> post{
              ybar, kbar, tabsm + s * kMaxStages, bsm, s, tile, dt,
              step_end,
              step_end && step % substeps == 0 ? gbuf + slot * pad4(tile)
                                               : nullptr,
              dt_next, L > 1,
              step_end && step == 0 ? du0 + (size_t)row0 * dim : nullptr,
              dim, nvalid, ns};
          if (L == 1)
            layer<TB, PL>(f, l, wr, wsm, cin, f.w[1], f.w[0], nxt, kNone, 0,
                          nullptr, 0, post);
          else
            layer<TB, PL>(f, l, wr, wsm, RowsIn<TB>{cur}, f.w[1], f.w[0],
                          nxt, kNone, 0, nullptr, 0, post);
        }
        cur = nxt;
      }
    }
    if (L == 1 && step > 0) {
      for (int e = tid; e < tile; e += nt)
        for (int q = 0; q < ns; ++q) {
          const float bq = bsm[q];
          kbar[q * tile + e] = bq != 0.f ? (dt_next * bq) * ybar[e] : 0.f;
        }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradients: for layer l, dW_l = [H_l, 1]^T Delta_l over the R
// records of a replica (the row w[l] of the result being the bias), as a
// product on the tensor cores in float32 accuracy (3xTF32). Replaces the
// weight-gradient products of the TPU kernel's backward
// (latentdiffeq/ops/node_pallas.py:215-218). At the train shape (R =
// 18,816) it moves 62.6 MB for 1.76 GFLOP: bound by its bytes.
//
// The product runs in one of two orientations, whichever pads less at the
// instruction's 16 x 8 granularity (mma.sync m16n8k8): its M side ("P") is
// the layer's input plus the bias row and its N side ("Q") the outputs, or
// the other way round ("swap"; layer 0 of the 16-200-200-16 field: 200 x 17
// pads to 208 x 24, 17 x 200 to 32 x 200). A tile covers a whole P side of
// up to kDwPT m16 tiles (256 rows: 201 for the train field's layers 1 and
// 2, the bias row included) and a group of up to kDwNT n8 tiles of Q
// (64 columns; a 200-wide Q side is four groups of 56, 48, 48, 48): each
// record's Q slice is read once in all, its P slice once a tile, and the
// tiles of one P side stream the same records at the same time, so the L2
// serves the repeats. One block an SM: eight warps multiply, warp w owning
// m16 tiles w and w + 8 and every n8 tile of the group (its loops over
// them compiled for each count, dw_tile<MT, NT>; 64 sums a thread), and
// eight more warps load.
//
// Both operands lie MN-major in memory (a record's features are
// contiguous, the reduction runs over records). wgmma takes tf32 operands
// K-major only and ldmatrix transposes 16-bit types only, so the records
// come into shared memory as they lie ([record][feature], rows padded to 8
// mod 32 floats) and each thread loads its mma.sync fragments with plain
// 32-bit shared loads, which that padding makes free of bank conflicts. A
// ring of kDwStages stages of kDwKC records is filled by cp.async from the
// loading warps while the others multiply: on the H100 a warp issues a
// 16-byte cp.async only about every 250 cycles, so warps that also
// multiplied would stall on their loads. mbarriers pace the ring (a stage
// is full when its copies are in, empty when every warp that multiplies is
// done with it); records past a split's end are zero-filled. (TMA bulk
// copies of each record's slices, 64 to 800 bytes, measured slower.)
//
// 3xTF32: each operand x is split into big (x with its mantissa cut to 10
// bits) and small = x - big, and a k8 step adds small*big + big*small +
// big*big into a fresh accumulator (the tensor cores' own accumulation
// truncates, so it never runs over more than three products), which is
// then added to the float32 sums with a round-to-nearest add.
//
// Split-K over the records fills the card: a tile's records are cut into
// nsplit = C * ncl contiguous splits (C blocks a thread block cluster, ncl
// clusters), as many clusters in all as the card runs at once, shared out
// by each tile's cost a record, independent of the number of replicas.
// The splits of a tile meet inside the kernel, in a fixed order: the
// blocks of a cluster put their sums into shared memory and block r adds
// slice r of the tile over the cluster's ranks 0..C-1 through distributed
// shared memory; with ncl > 1 clusters each writes its slice to a
// workspace and the last cluster to arrive at the slice (counted by an
// integer semaphore, which it resets) adds the ncl partials in cluster
// order. No float atomics: two launches are bit for bit equal, and a
// replica's result does not depend on how many others share the launch
// (grid z is the replica).
// Levers of scripts/node_dw_levers.py (the defaults are the design).
#ifndef LDQ_DW_STAGES
#define LDQ_DW_STAGES 4
#endif
#ifndef LDQ_DW_MAX_CLUSTER
#define LDQ_DW_MAX_CLUSTER 2
#endif
constexpr int kDwWarps = 8;                      // warps that multiply
#ifndef LDQ_DW_LOADERS
#define LDQ_DW_LOADERS 256
#endif
constexpr int kDwLoaders = LDQ_DW_LOADERS;       // threads that load: two
                                                 // warps on each scheduler
constexpr int kDwThreads = 32 * kDwWarps + kDwLoaders;
constexpr int kDwMT = 2;                       // m16 tiles a warp
constexpr int kDwPT = kDwWarps * kDwMT;        // m16 tiles a tile: 256 rows
constexpr int kDwNT = 8;                       // n8 tiles a tile: 64 columns
#ifndef LDQ_DW_KC
#define LDQ_DW_KC 32
#endif
constexpr int kDwKC = LDQ_DW_KC;               // records a stage
constexpr int kDwStages = LDQ_DW_STAGES;
constexpr int kDwLDP = kDwPT * 16 + 8;         // 264 = 8 mod 32 floats
constexpr int kDwLDQ = kDwNT * 8 + 8;          // 72 = 8 mod 32 floats
constexpr int kDwStage = kDwKC * (kDwLDP + kDwLDQ);
constexpr int kDwTileFloats = kDwPT * 16 * kDwNT * 8;   // a tile's sums
constexpr size_t kDwSmem =
    sizeof(float) * (kDwStages * kDwStage > kDwTileFloats
                         ? kDwStages * kDwStage : kDwTileFloats);
constexpr int kDwMaxTiles = 64;
constexpr int kDwMaxCluster = LDQ_DW_MAX_CLUSTER;
constexpr int kDwMinRecords = 4 * kDwKC;       // records a split at least
// A record's cost to a block besides its products, in m16 x n8 products:
// bringing it in and passing a stage barrier, whatever its width (the
// light tiles of layers 0 and 2 would otherwise get too few splits).
constexpr int kDwRecordCost = 128;

// A tile of layer `layer`: P features [p0, p0 + np), Q features [q0, q0 +
// nq) (the bias is feature w[l] of the input side), cut into nsplit splits
// of the records; blocks [first, first + nsplit) of the grid's x; its
// cluster partials at ws_off (ncl > 1) and its slices' semaphores at
// sem_off.
struct DwTile {
  int layer, swap, p0, np, q0, nq, nsplit, first, ws_off, sem_off;
};

struct DwPlan {
  int ntiles, cluster, blocks, ws, sems;
  DwTile t[kDwMaxTiles];
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// An arrive on `bar` once every cp.async this thread has issued is done.
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// x = big + small exactly, big = x with its mantissa cut to TF32's 10
// bits (a mask: full-rate integer work, where cvt.rna runs at the
// conversion units' quarter rate); the tensor cores read small's top 10
// mantissa bits, so x is carried to about 2^-21 of its size.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1, const float* c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

#ifdef LDQ_DW_LEVER_STAMPS
// scripts/node_dw_levers.py's timeline: each block's global timer at its
// start, after its main loop, after the cluster's sums and at its end.
__device__ unsigned long long g_dw_stamps[4096][4];
// block 0's global timer before and after each stage's wait (the first
// 256 stages)
__device__ unsigned long long g_dw_chunks[256][2];
__device__ __forceinline__ unsigned long long dw_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void dw_stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x < 4096 && blockIdx.z == 0)
    g_dw_stamps[blockIdx.x][k] = dw_now();
}
__device__ __forceinline__ void dw_chunk_stamp(int c, int k) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.z == 0 && c < 256)
    g_dw_chunks[c][k] = dw_now();
}
#else
__device__ __forceinline__ void dw_stamp(int) {}
__device__ __forceinline__ void dw_chunk_stamp(int, int) {}
#endif

// What one block of the weight-gradient kernel works on: its replica's
// P and Q slices (P features [p0, p0 + np) of each record of Pg, Q
// features [q0, q0 + nq) of Qg), its records [r0, r1), and the local index
// of the bias row (no swap) or column (swap) of ones.
struct DwBlock {
  const float* Pg;
  const float* Qg;
  int ldp, ldq, cp4, cq4, r0, r1, np, nq, one;
  bool swap;
};

// Issues, from the loading threads, the cp.async copies of records [rb,
// rb + kDwKC) of the block's P and Q slices into ring stage `buf`; records
// past r1 are zero-filled.
__device__ __forceinline__ void dw_load(const DwBlock& b, float* dsm,
                                        int buf, int rb) {
#ifdef LDQ_DW_LEVER_NO_LOAD
  return;   // timing only: the products of whatever the ring holds
#endif
  float* Ps = dsm + buf * kDwStage;
  float* Qs = Ps + kDwKC * kDwLDP;
  const int c4 = b.cp4 + b.cq4;
  const int tid = threadIdx.x - 32 * kDwWarps;   // among the loaders
  int k = tid / c4, c = tid - k * c4;
  const int dk = kDwLoaders / c4, dc = kDwLoaders - dk * c4;
  for (; k < kDwKC; k += dk, c += dc) {
    if (c >= c4) {
      c -= c4;
      if (++k >= kDwKC) break;
    }
    const int rec = rb + k;
    const bool ok = rec < b.r1;
    const size_t row = ok ? (size_t)rec : (size_t)b.r0;
    if (c < b.cp4)
      cp_async16_zfill(Ps + k * kDwLDP + 4 * c, b.Pg + row * b.ldp + 4 * c,
                       ok);
    else
      cp_async16_zfill(Qs + k * kDwLDQ + 4 * (c - b.cp4),
                       b.Qg + row * b.ldq + 4 * (c - b.cp4), ok);
  }
}

// The loading warps: fill the ring stage by stage, each stage once every
// warp that multiplies is done with it (its `empty` barrier); a stage's
// `full` barrier completes when its copies are in. Loads issue slowly (on
// the H100 a warp's 16-byte cp.async every ~250 cycles), so they get warps
// of their own, two on each scheduler, and overlap the products.
__device__ __noinline__ void dw_produce(const DwBlock& b, float* dsm,
                                        unsigned long long* full,
                                        unsigned long long* empty) {
  const int nchunks = (b.r1 - b.r0 + kDwKC - 1) / kDwKC;
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % kDwStages;
    if (c >= kDwStages)
      mbar_wait(empty + st, (unsigned)(c / kDwStages - 1) & 1u);
    dw_load(b, dsm, st, b.r0 + c * kDwKC);
#ifdef LDQ_DW_LEVER_NO_LOAD
    mbar_arrive(full + st);
#else
    mbar_arrive_copies(full + st);
#endif
  }
  __syncthreads();   // with the warps that multiply: the ring is free
}

// The main loop of a warp that multiplies, owning MT m16 tiles (warp,
// warp + 8) and a tile group of NT n8 tiles (compile-time counts, so the
// products of a stage are straight-line code the compiler interleaves):
// each stage's 3xTF32 products, a k8 step's three into a fresh
// accumulator added to the float32 sums; then the warp's sums into tsum
// [np][nq]. A warp with MT = 0 still keeps the ring's pace.
template <int MT, int NT>
__device__ __noinline__ void dw_tile(const DwBlock& b, float* dsm,
                                     unsigned long long* full,
                                     unsigned long long* empty) {
  constexpr int MA = MT > 0 ? MT : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[MA][NT][4];
#pragma unroll
  for (int i = 0; i < MA; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nchunks = (b.r1 - b.r0 + kDwKC - 1) / kDwKC;
  for (int c = 0; c < nchunks; ++c) {
    dw_chunk_stamp(c, 0);
    mbar_wait(full + c % kDwStages, (unsigned)(c / kDwStages) & 1u);
    dw_chunk_stamp(c, 1);
#ifndef LDQ_DW_LEVER_NO_MMA
    if constexpr (MT > 0) {
      const float* Ps = dsm + (c % kDwStages) * kDwStage;
      const float* Qs = Ps + kDwKC * kDwLDP;
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kDwKC / 8; ++ks) {
        const float* Pk = Ps + ks * 8 * kDwLDP;
        const float* Qk = Qs + ks * 8 * kDwLDQ;
        unsigned ab[MT][4], as[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int m = (warp + kDwWarps * i) * 16 + g;
          float v[4] = {Pk[t4 * kDwLDP + m], Pk[t4 * kDwLDP + m + 8],
                        Pk[(t4 + 4) * kDwLDP + m],
                        Pk[(t4 + 4) * kDwLDP + m + 8]};
          if (!b.swap) {
            if (m == b.one) v[0] = v[2] = 1.f;
            if (m + 8 == b.one) v[1] = v[3] = 1.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(v[e], ab[i][e], as[i][e]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = j * 8 + g;
          float v0 = Qk[t4 * kDwLDQ + n], v1 = Qk[(t4 + 4) * kDwLDQ + n];
          if (b.swap && n == b.one) v0 = v1 = 1.f;
          unsigned bb0, bs0, bb1, bs1;
          split_tf32(v0, bb0, bs0);
          split_tf32(v1, bb1, bs1);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float d[4];
#ifdef LDQ_DW_LEVER_ONE_PASS
            mma_tf32(d, ab[i], bb0, bb1, zero);   // timing only
#else
            mma_tf32(d, as[i], bb0, bb1, zero);
            mma_tf32(d, ab[i], bs0, bs1, d);
            mma_tf32(d, ab[i], bb0, bb1, d);
#endif
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
          }
        }
      }
    }
#endif
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + c % kDwStages);
  }
  __syncthreads();   // the ring's memory is free: it takes the tile's sums
  if constexpr (MT > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = (warp + kDwWarps * i) * 16 + g;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m + (e >> 1) * 8, col = j * 8 + 2 * t4 + (e & 1);
          if (row < b.np && col < b.nq) dsm[row * b.nq + col] = acc[i][j][e];
        }
    }
  }
}

template <int MT>
__device__ __forceinline__ void dw_tile_nt(const DwBlock& b, float* dsm,
                                           unsigned long long* full,
                                           unsigned long long* empty,
                                           int nt) {
  switch (nt) {
    case 1: dw_tile<MT, 1>(b, dsm, full, empty); break;
    case 2: dw_tile<MT, 2>(b, dsm, full, empty); break;
    case 3: dw_tile<MT, 3>(b, dsm, full, empty); break;
    case 4: dw_tile<MT, 4>(b, dsm, full, empty); break;
    case 5: dw_tile<MT, 5>(b, dsm, full, empty); break;
    case 6: dw_tile<MT, 6>(b, dsm, full, empty); break;
    case 7: dw_tile<MT, 7>(b, dsm, full, empty); break;
    default: dw_tile<MT, 8>(b, dsm, full, empty); break;
  }
}

__global__ void __launch_bounds__(kDwThreads, 1)
node_field_dw_kernel(const __grid_constant__ Field f,
                     const __grid_constant__ DwPlan plan,
                     const float* __restrict__ tape,
                     const float* __restrict__ delta, float* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ sem, int R) {
  extern __shared__ __align__(16) float dsm[];
  dw_stamp(0);
  const int s = blockIdx.z;
  int ti = 0;
  while (ti + 1 < plan.ntiles && (int)blockIdx.x >= plan.t[ti + 1].first)
    ++ti;
  const DwTile& tl = plan.t[ti];
  const int split = blockIdx.x - tl.first;
  const int l = tl.layer, M = f.w[l], N = f.w[l + 1];
  const bool swap = tl.swap != 0;
  const int p0 = tl.p0, np = tl.np, q0 = tl.q0, nq = tl.nq;

  DwBlock b;
  const float* H = tape + (size_t)s * R * f.sumw4 + f.hp_off[l];
  const float* D = delta + (size_t)s * R * f.dsum4 + f.dp_off[l];
  b.Pg = (swap ? D : H) + p0;
  b.Qg = (swap ? H : D) + q0;
  b.ldp = swap ? f.dsum4 : f.sumw4;
  b.ldq = swap ? f.sumw4 : f.dsum4;
  // float4 columns of a record to copy: the features in memory (the bias
  // is not), up to the piece's padding to 4 floats
  b.cp4 = max(0, (min(p0 + np, swap ? N : M) - p0 + 3) / 4);
  b.cq4 = max(0, (min(q0 + nq, swap ? M : N) - q0 + 3) / 4);
  b.r0 = (int)((long long)split * R / tl.nsplit);
  b.r1 = (int)((long long)(split + 1) * R / tl.nsplit);
  b.np = np;
  b.nq = nq;
  b.one = swap ? M - q0 : M - p0;
  b.swap = swap;

  const int warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int mtiles = (np + 15) / 16, ntiles = (nq + 7) / 8;
  // the ring's barriers: a stage is full once its copies are in, empty
  // once every warp that multiplies has read it
  __shared__ unsigned long long full[kDwStages], empty[kDwStages];
  if (tid == 0) {
    for (int st = 0; st < kDwStages; ++st) {
      mbar_init(full + st, kDwLoaders);
      mbar_init(empty + st, kDwWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int mine = (warp + kDwWarps < mtiles) ? 2 : (warp < mtiles ? 1 : 0);
  if (warp >= kDwWarps)
    dw_produce(b, dsm, full, empty);
  else if (mine == 2)
    dw_tile_nt<2>(b, dsm, full, empty, ntiles);
  else if (mine == 1)
    dw_tile_nt<1>(b, dsm, full, empty, ntiles);
  else
    dw_tile_nt<0>(b, dsm, full, empty, ntiles);

  dw_stamp(1);
  float* tsum = dsm;   // [np][nq]
  const int C = plan.cluster;
  const int ncl = tl.nsplit / C;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
  const int E = np * nq;
  const int e0 = (int)((long long)rank * E / C);
  const int e1 = (int)((long long)(rank + 1) * E / C);
  float* o = out + (size_t)s * f.total;
  auto store = [&](int e, float v) {
    const int row = e / nq, col = e - row * nq;
    const int hi = swap ? q0 + col : p0 + row;   // input feature (M: bias)
    const int ni = swap ? p0 + row : q0 + col;   // output feature
    o[hi < M ? f.w_off[l] + (size_t)hi * N + ni : f.b_off[l] + ni] = v;
  };
  float* part = ws + (size_t)s * plan.ws + tl.ws_off;
  // the ranks' sums in rank order; every load of an element is issued
  // before the first add (the adds wait on the loads' latency once)
  const float* rs[kDwMaxCluster];
#pragma unroll
  for (int r = 0; r < kDwMaxCluster; ++r)
    rs[r] = r < C ? (C > 1 ? cluster.map_shared_rank(tsum, r) : tsum)
                  : tsum;
  for (int e = e0 + tid; e < e1; e += kDwThreads) {
    float t[kDwMaxCluster];
#pragma unroll
    for (int r = 0; r < kDwMaxCluster; ++r) t[r] = r < C ? rs[r][e] : 0.f;
    float v = t[0];
#pragma unroll
    for (int r = 1; r < kDwMaxCluster; ++r)
      if (r < C) v += t[r];
    if (ncl == 1)
      store(e, v);
    else
      part[(size_t)(split / C) * E + e] = v;
  }
  if (C > 1) cluster.sync();   // no block leaves while its sums are read
  dw_stamp(2);
  if (ncl == 1) {
    dw_stamp(3);
    return;
  }

  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* sm = sem + (size_t)s * plan.sems + tl.sem_off + rank;
  if (tid == 0) last = atomicAdd(sm, 1) == ncl - 1;
  __syncthreads();
  if (!last) {
    dw_stamp(3);
    return;
  }
  __threadfence();
  // the clusters' partials in cluster order, eight loads in flight
  for (int e = e0 + tid; e < e1; e += kDwThreads) {
    float v = __ldcg(part + e);
    int c = 1;
    for (; c + 8 <= ncl; c += 8) {
      float t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        t[k] = __ldcg(part + (size_t)(c + k) * E + e);
#pragma unroll
      for (int k = 0; k < 8; ++k) v += t[k];
    }
    for (; c < ncl; ++c) v += __ldcg(part + (size_t)c * E + e);
    store(e, v);
  }
  if (tid == 0) *sm = 0;   // ready for the next launch
  dw_stamp(3);
}

// ---------------------------------------------------------------------------
// Host side.

int build_field(int n_layers, const int* widths, const int* acts,
                const void* const* Ws, const void* const* bs, Field* f) {
  if (n_layers < 1 || n_layers > kMaxLayers) return kErrDepth;
  if (widths == nullptr) return kErrArgs;
  *f = Field{};
  f->L = n_layers;
  f->reg = -1;
  int hoff = 0;
  for (int l = 0; l <= n_layers; ++l) {
    const int w = widths[l];
    if (w < 1) return kErrArgs;
    f->w[l] = w;
    f->hp_off[l] = hoff;
    hoff += pad4(w);
    if (w > f->maxw) f->maxw = w;
  }
  f->sumw4 = hoff;
  if (f->w[0] != f->w[n_layers]) return kErrArgs;   // dy/dt has y's shape
  int off = 0, doff = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (acts != nullptr) {
      if (acts[l] < 0 || acts[l] > 4) return kErrArgs;
      f->act[l] = acts[l];
    }
    f->w_off[l] = off;
    off += pad4(f->w[l] * f->w[l + 1]);
    f->b_off[l] = off;
    off += pad4(f->w[l + 1]);
    f->dp_off[l] = doff;
    doff += pad4(f->w[l + 1]);
    f->W[l] = Ws ? (const float*)Ws[l] : nullptr;
    f->b[l] = bs ? (const float*)bs[l] : nullptr;
    f->sw_off[l] = f->sb_off[l] = -1;
  }
  f->total = off;
  f->dsum4 = doff;
  return 0;
}

// The layer a pass keeps in registers (-1: none): the largest whose
// outputs (with the sweep's transposed product) fit the register layout.
int reg_layer(const Field& f, bool backward) {
  int best = -1, most = 0;
  for (int l = 0; l < f.L; ++l) {
    const int in = backward ? f.w[l + 1] : f.w[l];
    const int out = backward ? f.w[l] : f.w[l + 1];
    if (out <= kRegMaxOut && out % 4 == 0 && in * out > most) {
      best = l;
      most = in * out;
    }
  }
  return best;
}

// Lays out the pass's shared-memory weights for a placement; returns their
// floats.
int place_weights(Field* f, int pl, bool backward) {
  int off = 0;
  for (int l = 0; l < f->L; ++l) {
    f->sw_off[l] = f->sb_off[l] = -1;
    if (pl == kGlobal) continue;
    const int in = backward ? f->w[l + 1] : f->w[l];
    const int out = backward ? f->w[l] : f->w[l + 1];
    const int rows = (pl == kReg && l == f->reg) ? in - kRegRows : in;
    f->sw_off[l] = off;
    if (rows > 0) off += pad4(rows * out);
    if (!backward) {
      f->sb_off[l] = off;
      off += pad4(f->w[l + 1]);
    }
  }
  f->sw_total = off;
  return off;
}

size_t pass_smem(const Field& f, int ns, int tb, bool backward) {
  const size_t tile = pad4(f.w[0] * tb);
  size_t fl = kMaxStages * (kMaxStages + 1) + tile + pad4(ns * f.w[0] * tb) +
              2 * (size_t)pad4(f.maxw * tb) + f.sw_total;
  if (backward) fl += 2 * tile + 2 * (size_t)ns * tb * f.sumw4;
  return sizeof(float) * fl;
}

// The current device's SMs: the blocks of one wave (0 if it cannot be
// read).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// Picks the rows per block (1 or 2; *rows == 0 asks for the default: 1
// when the S replicas' S * B rows fit one wave of blocks on the current
// device, else 2) and where the pass keeps its weights (*place: the first
// that fits of one layer in registers and the rest in shared memory, all
// in shared memory, all read through the read-only cache). Fills f's
// placement fields.
int plan(Field* f, int ns, bool backward, int B, int S, int* rows,
         int* place, int* threads, size_t* bytes) {
  if (ns < 1 || ns > kMaxStages || B < 1 || S < 1 || S > 65535)
    return kErrArgs;
  const int asked = *rows;
  if (asked != 0 && asked != 1 && asked != 2) return kErrArgs;
  int tb = asked;
  if (tb == 0) {
    const int wave = sm_count();
    if (wave < 1) return kErrArgs;
    tb = (long long)S * B > wave ? 2 : 1;
  }
  const int reg = reg_layer(*f, backward);
  for (int pl = kReg; pl <= kGlobal; ++pl) {
    if (pl == kReg && reg < 0) continue;
    f->reg = pl == kReg ? reg : -1;
    place_weights(f, pl, backward);
    const size_t need = pass_smem(*f, ns, tb, backward);
    if (need <= (size_t)kSmemLimit) {
      *rows = tb;
      *place = pl;
      *threads = pl == kReg ? kRegThreads : kThreads;
      *bytes = need;
      return 0;
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

template <class K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The grid: x the tiles of one replica's B rows, z the S replicas.
template <int TB, int PL>
cudaError_t launch_fwd(const Tableau& tab, const Field& f,
                       const float* saveat, const float* u0s, float* ys,
                       float* tape, int B, int S, int T, int substeps,
                       int nt, size_t bytes, cudaStream_t st) {
  cudaError_t e = set_smem(node_field_fwd_kernel<TB, PL>, bytes);
  if (e != cudaSuccess) return e;
  node_field_fwd_kernel<TB, PL>
      <<<dim3((B + TB - 1) / TB, 1, S), nt, bytes, st>>>(
          tab, f, saveat, u0s, ys, tape, B, T, substeps);
  return cudaGetLastError();
}

template <int TB, int PL>
cudaError_t launch_bwd(const Tableau& tab, const Field& f,
                       const float* saveat, const float* tape,
                       const float* g, float* du0, float* delta, int B,
                       int S, int T, int substeps, int nt, size_t bytes,
                       cudaStream_t st) {
  cudaError_t e = set_smem(node_field_bwd_kernel<TB, PL>, bytes);
  if (e != cudaSuccess) return e;
  node_field_bwd_kernel<TB, PL>
      <<<dim3((B + TB - 1) / TB, 1, S), nt, bytes, st>>>(
          tab, f, saveat, tape, g, du0, delta, B, T, substeps);
  return cudaGetLastError();
}

// Thread block clusters of C blocks (or, with C = 1, blocks) of the
// weight-gradient kernel that the current device runs at once; 0 if it
// cannot say.
int dw_active(int C) {
  static int cache[16][kDwMaxCluster + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int* hit = dev < 16 ? &cache[dev][C] : nullptr;
  if (hit != nullptr && *hit > 0) return *hit;
  if (set_smem(node_field_dw_kernel, kDwSmem) != cudaSuccess) return 0;
  int n = 0;
  if (C > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(kDwThreads);
    cfg.dynamicSmemBytes = kDwSmem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&n, node_field_dw_kernel, &cfg) !=
        cudaSuccess)
      n = 0;
  } else {
    int per = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, node_field_dw_kernel, kDwThreads, kDwSmem) == cudaSuccess)
      n = per * sm_count();
  }
  (void)cudaGetLastError();
  if (hit != nullptr) *hit = n;
  return n;
}

// The weight-gradient plan for R records a replica on the current device
// (see node_field_dw_kernel): the tiles of every layer, each in the
// orientation that pads less, and their splits: as many clusters in all as
// the card runs at once, shared out in proportion to each tile's work (at
// least one a tile). It does not depend on the number of replicas. Returns
// 0, kErrTiles or kErrArgs.
int dw_plan(const Field& f, int R, DwPlan* p) {
  *p = DwPlan{};
  if (R < 1) return kErrArgs;
  long long work[kDwMaxTiles], total = 0;
  int n = 0;
  for (int l = 0; l < f.L; ++l) {
    const int hin = f.w[l] + 1, nout = f.w[l + 1];
    const long long keep = (long long)((hin + 15) / 16) * ((nout + 7) / 8);
    const long long turn = (long long)((nout + 15) / 16) * ((hin + 7) / 8);
    const int swap = turn < keep;
    const int pn = swap ? nout : hin, qn = swap ? hin : nout;
    const int mt = (pn + 15) / 16, nt = (qn + 7) / 8;
    const int gp = (mt + kDwPT - 1) / kDwPT, gq = (nt + kDwNT - 1) / kDwNT;
    for (int i = 0; i < gp; ++i)
      for (int j = 0; j < gq; ++j) {
        if (n == kDwMaxTiles) return kErrTiles;
        const int ma = mt * i / gp, mb = mt * (i + 1) / gp;
        const int na = nt * j / gq, nb = nt * (j + 1) / gq;
        DwTile& t = p->t[n];
        t.layer = l;
        t.swap = swap;
        t.p0 = 16 * ma;
        t.np = std::min(16 * mb, pn) - t.p0;
        t.q0 = 8 * na;
        t.nq = std::min(8 * nb, qn) - t.q0;
        work[n] = (long long)(mb - ma) * (nb - na) + kDwRecordCost;
        total += work[n++];
      }
  }
  const int C = std::min(kDwMaxCluster, std::max(1, R / kDwMinRecords));
  const int active = dw_active(C);
  if (active < 1) return kErrArgs;
  const int most = std::max(1, R / (kDwMinRecords * C));
  // clusters a tile: the whole share's floor, then one more to the largest
  // remainders while the card has room
  const long long K = std::max(active, n);
  // the tiles of one layer and P group (its Q groups) read the same P
  // slices: they get the same splits, so their blocks stream the same
  // records at the same time and the L2 serves the repeats
  long long fam[kDwMaxTiles];
  for (int i = 0; i < n; ++i) {
    int cnt = 0;
    fam[i] = 0;
    for (int j = 0; j < n; ++j)
      if (p->t[j].layer == p->t[i].layer && p->t[j].p0 == p->t[i].p0) {
        fam[i] += work[j];
        ++cnt;
      }
    fam[i] /= cnt;
  }
  int ncl[kDwMaxTiles], given = 0;
  double rest[kDwMaxTiles];
  for (int i = 0; i < n; ++i) {
    const double share = (double)K * fam[i] / (double)total;
    ncl[i] = std::max(1, std::min((int)share, most));
    rest[i] = share - (int)share;
    given += ncl[i];
  }
  while (true) {   // one more to each tile of the family with the largest
                   // remainder that still fits
    int best = -1, cnt = 0;
    for (int i = 0; i < n; ++i)
      if (ncl[i] < most && (best < 0 || rest[i] > rest[best])) best = i;
    if (best < 0) break;
    for (int j = 0; j < n; ++j)
      cnt += p->t[j].layer == p->t[best].layer && p->t[j].p0 == p->t[best].p0;
    if (given + cnt > K) break;
    for (int j = 0; j < n; ++j)
      if (p->t[j].layer == p->t[best].layer && p->t[j].p0 == p->t[best].p0) {
        ++ncl[j];
        rest[j] -= 1.0;
      }
    given += cnt;
  }
  int first = 0, ws = 0, sems = 0;
  for (int i = 0; i < n; ++i) {
    DwTile& t = p->t[i];
    t.nsplit = C * ncl[i];
    t.first = first;
    first += t.nsplit;
    t.ws_off = t.sem_off = 0;
    if (ncl[i] > 1) {
      t.ws_off = ws;
      ws += ncl[i] * t.np * t.nq;
      t.sem_off = sems;
      sems += C;
    }
  }
  p->ntiles = n;
  p->cluster = C;
  p->blocks = first;
  p->ws = ws;
  p->sems = sems;
  return 0;
}

}  // namespace

extern "C" int ldq_node_field_max_layers() { return kMaxLayers; }

// Floats in the packed [W_0, b_0, W_1, b_1, ...] layout, or an error code.
extern "C" int ldq_node_field_packed_size(int n_layers, const int* widths) {
  Field f;
  const int rc = build_field(n_layers, widths, nullptr, nullptr, nullptr,
                             &f);
  return rc != 0 ? rc : f.total;
}

// Floats in one tape record and in one Delta record (0 or an error code).
extern "C" int ldq_node_field_records(int n_layers, const int* widths,
                                      int* tape_floats, int* delta_floats) {
  Field f;
  const int rc = build_field(n_layers, widths, nullptr, nullptr, nullptr,
                             &f);
  if (rc != 0) return rc;
  if (tape_floats == nullptr || delta_floats == nullptr) return kErrArgs;
  *tape_floats = f.sumw4;
  *delta_floats = f.dsum4;
  return 0;
}

// The launch configuration of a pass (backward: the sweep) for S replicas
// of a batch of B rows on the current device: rows per block (*rows in: 0
// = the default, else 1 or 2; out: the choice), where the weights live
// (*place out: 0 one layer in registers, 1 shared memory, 2 global), that
// layer (-1: none), threads per block and dynamic shared memory. Returns
// 0, or kErrDepth / kErrFit / kErrArgs.
extern "C" int ldq_node_field_plan(int n_layers, const int* widths,
                                   int n_stages, int backward, int B, int S,
                                   int* rows, int* place, int* reg,
                                   int* threads, int* smem_bytes) {
  Field f;
  int rc = build_field(n_layers, widths, nullptr, nullptr, nullptr, &f);
  if (rc != 0) return rc;
  if (rows == nullptr || place == nullptr) return kErrArgs;
  int nt = 0;
  size_t bytes = 0;
  rc = plan(&f, n_stages, backward != 0, B, S, rows, place, &nt, &bytes);
  if (rc != 0) return rc;
  if (reg) *reg = f.reg;
  if (threads) *threads = nt;
  if (smem_bytes) *smem_bytes = (int)bytes;
  return 0;
}

// Forward solve of S replicas in one launch. widths: n_layers + 1 ints;
// acts: n_layers activation codes; Ws / bs: n_layers device pointers
// (float32, W_l (S, widths[l], widths[l+1]) and b_l (S, widths[l+1]),
// contiguous); a: n_stages x n_stages row-major, b: n_stages, both float32
// on the host; saveat (T,), u0s (S, B, dim), ys (S, B, T, dim) on the
// device; tape (S, B, (T-1) * substeps, n_stages, tape record) or null.
// rows: 0 = default (see ldq_node_field_plan). A replica's rows are
// computed as its own launch at the same rows a block would compute them.
// Returns 0 on a successful launch, a cudaError_t (> 0) or a negative code
// above. Does not synchronise.
extern "C" int ldq_node_field_fwd(int n_layers, const int* widths,
                                  const int* acts, const void* const* Ws,
                                  const void* const* bs, int n_stages,
                                  const float* a, const float* b,
                                  const float* saveat, const float* u0s,
                                  float* ys, float* tape, int B, int S,
                                  int T, int substeps, int rows,
                                  void* stream) {
  if (B < 1 || S < 1 || T < 1 || substeps < 1 || acts == nullptr ||
      Ws == nullptr || bs == nullptr || saveat == nullptr ||
      u0s == nullptr || ys == nullptr)
    return kErrArgs;
  Field f;
  int rc = build_field(n_layers, widths, acts, Ws, bs, &f);
  if (rc != 0) return rc;
  Tableau tab;
  rc = fill_tableau(n_stages, a, b, &tab);
  if (rc != 0) return rc;
  int pl = 0, nt = 0;
  size_t bytes = 0;
  rc = plan(&f, n_stages, false, B, S, &rows, &pl, &nt, &bytes);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
#define LDQ_FWD(TB, PL)                                                    \
  e = launch_fwd<TB, PL>(tab, f, saveat, u0s, ys, tape, B, S, T, substeps, \
                         nt, bytes, st)
  if (rows == 1) {
    if (pl == kReg) LDQ_FWD(1, kReg);
    else if (pl == kSmem) LDQ_FWD(1, kSmem);
    else LDQ_FWD(1, kGlobal);
  } else {
    if (pl == kReg) LDQ_FWD(2, kReg);
    else if (pl == kSmem) LDQ_FWD(2, kSmem);
    else LDQ_FWD(2, kGlobal);
  }
#undef LDQ_FWD
  return (int)e;
}

// Reverse sweep of S replicas in one launch. Wts: W_l transposed (S,
// widths[l+1], widths[l]), contiguous. tape: as the forward wrote it; g
// (S, B, T, dim); du0 (S, B, dim); delta (S, B, (T-1) * substeps,
// n_stages, Delta record). rows: as the forward's.
extern "C" int ldq_node_field_bwd(int n_layers, const int* widths,
                                  const int* acts, const void* const* Wts,
                                  int n_stages, const float* a,
                                  const float* b, const float* saveat,
                                  const float* tape, const float* g,
                                  float* du0, float* delta, int B, int S,
                                  int T, int substeps, int rows,
                                  void* stream) {
  if (B < 1 || S < 1 || T < 1 || substeps < 1 || acts == nullptr ||
      Wts == nullptr || saveat == nullptr || tape == nullptr ||
      g == nullptr || du0 == nullptr || delta == nullptr)
    return kErrArgs;
  Field f;
  int rc = build_field(n_layers, widths, acts, Wts, nullptr, &f);
  if (rc != 0) return rc;
  Tableau tab;
  rc = fill_tableau(n_stages, a, b, &tab);
  if (rc != 0) return rc;
  int pl = 0, nt = 0;
  size_t bytes = 0;
  rc = plan(&f, n_stages, true, B, S, &rows, &pl, &nt, &bytes);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
#define LDQ_BWD(TB, PL)                                                  \
  e = launch_bwd<TB, PL>(tab, f, saveat, tape, g, du0, delta, B, S, T,   \
                         substeps, nt, bytes, st)
  if (rows == 1) {
    if (pl == kReg) LDQ_BWD(1, kReg);
    else if (pl == kSmem) LDQ_BWD(1, kSmem);
    else LDQ_BWD(1, kGlobal);
  } else {
    if (pl == kReg) LDQ_BWD(2, kReg);
    else if (pl == kSmem) LDQ_BWD(2, kSmem);
    else LDQ_BWD(2, kGlobal);
  }
#undef LDQ_BWD
  return (int)e;
}

// The weight-gradient plan for R = B * steps * stages records a replica:
// blocks of a replica, the cluster size, workspace floats and semaphore
// ints a replica (see dw_plan). Returns 0, kErrTiles or kErrArgs.
extern "C" int ldq_node_field_dw_plan(int n_layers, const int* widths, int R,
                                      int* blocks, int* cluster,
                                      int* ws_floats, int* sem_ints) {
  Field f;
  int rc = build_field(n_layers, widths, nullptr, nullptr, nullptr, &f);
  if (rc != 0) return rc;
  if (blocks == nullptr || cluster == nullptr || ws_floats == nullptr ||
      sem_ints == nullptr)
    return kErrArgs;
  DwPlan p;
  rc = dw_plan(f, R, &p);
  if (rc != 0) return rc;
  *blocks = p.blocks;
  *cluster = p.cluster;
  *ws_floats = p.ws;
  *sem_ints = p.sems;
  return 0;
}

// Weight gradients of S replicas in one launch, from the tape (S, R, tape
// record) and Delta (S, R, Delta record): out (S, packed size), every
// element of the packed layout written once (the padding is not). ws: S x
// the plan's workspace floats (unused when it has none); sem: S x the
// plan's semaphore ints, zero before the launch and left zero by it.
extern "C" int ldq_node_field_dw(int n_layers, const int* widths,
                                 const float* tape, const float* delta,
                                 float* out, float* ws, int* sem, int R,
                                 int S, void* stream) {
  if (tape == nullptr || delta == nullptr || out == nullptr || R < 1 ||
      S < 1 || S > 65535)
    return kErrArgs;
  Field f;
  int rc = build_field(n_layers, widths, nullptr, nullptr, nullptr, &f);
  if (rc != 0) return rc;
  DwPlan p;
  rc = dw_plan(f, R, &p);
  if (rc != 0) return rc;
  if ((p.ws > 0 && ws == nullptr) || (p.sems > 0 && sem == nullptr))
    return kErrArgs;
  cudaError_t e = set_smem(node_field_dw_kernel, kDwSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks, 1, S);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = kDwSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.cluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, node_field_dw_kernel, f, p, tape, delta, out,
                         ws, sem, R);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef LDQ_DW_LEVER_STAMPS
// The timeline of the last launch's first 4096 blocks of replica 0:
// (block, [start, main loop done, cluster sums done, end]) in ns.
extern "C" int ldq_node_field_dw_stamps(unsigned long long* host,
                                        unsigned long long* chunks) {
  cudaError_t e =
      cudaMemcpyFromSymbol(host, g_dw_stamps, sizeof(g_dw_stamps));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(chunks, g_dw_chunks, sizeof(g_dw_chunks));
  return (int)e;
}
#endif
