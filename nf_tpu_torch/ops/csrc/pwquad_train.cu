// Fused frozen-statistics training pass for coupling-cell flows: a forward
// kernel (optionally with the BatchNorm batch sums) and its hand-derived
// backward.
//
// Replaces the Pallas TPU kernels of nf_tpu/ops/pwquad_train.py::
// build_train_kernels: `fwd_kernel` (forward, `with_stats` variant) and
// `bwd_kernel` (closed-form VJP).  The plain PyTorch versions are
// folded_forward_ref / forward_stats_ref and the autograd of
// folded_forward_ref in nf_tpu_torch/ops/pwquad_train.py, which also holds
// the wrappers.  The plan and the folded weights arrive as for the sampler
// (flow_plan.cuh): an int32 descriptor and one flat f32 buffer.
//
// Forward, per tile of samples (one block, one thread per sample): walk the
// plan's cells, write every cell's input into `stage` [n_cells, n_flow, n]
// (the only residual the backward reads), then x [n, n_flow] and the
// Jacobian.  Each sample's state lives in feature-major shared-memory tiles
// sized to the plan (a row of blockDim.x + 1 floats per feature): X, the
// running state; A and B, the conditioner's ping-pong layers, B also holding
// one transformed dimension's logits.  The permutations move no data: the
// wrapper gives, per cell, the X row that holds each logical dimension.  The
// stats variant sums, over the valid samples, y and y^2 of every xA column
// and every pre-ReLU folded activation: rows cell-major, 2 per xA column,
// then 2 per hidden unit, layer after layer (the layout stats_to_bn_state
// reads).
//
// Backward, per sample: walk the plan in reverse.  A permutation sends the
// cotangent back through its inverse.  A cell recomputes its conditioner from
// `stage`, keeping every layer's input, then streams the last layer one
// transformed dimension at a time: that dimension's logits, its closed-form
// VJP (pbar = jbar * jac / p), and its share of the last hidden layer's
// cotangent.  The whole last-layer cotangent (136 wide in the widest cell of
// the 10-D flagship) is never held.  Then the hidden layers backward, with
// their ReLU masks.
//
// Accumulation across samples, without float atomics.  A block's threads run
// a block-uniform grid-stride loop over tiles (a lane past n computes on
// dummy inputs and contributes zero).  The statistics as block sums
// (block_stats): after a barrier, each waiting row of the tiles is summed
// over the valid samples, split at most STATS_MAX_SPLIT ways with a
// fixed-order merge, into one double accumulator per block; each block
// writes it to row `block` of a [n_blocks, rows] scratch.  The weight
// gradient, one layer at a time, as a block product (block_dw): every thread stages its
// sample's layer input and output cotangent in shared-memory tiles, and
// after a barrier the block adds H^T G over its samples into one
// accumulator of n_weights floats, each entry summed by one thread in a
// fixed order; each block writes its accumulator to its row of the scratch.
// The wrapper sums the scratch over blocks.  Each kernel's grid depends on n
// and the plan's launch configuration alone, so two launches on the same
// inputs give bit-identical gradients and statistics.  Statistics
// accumulate in double (E[y^2] - E[y]^2 at a batch of 2^20 would lose digits
// in f32); weight gradients in f32, which the trainer averages and Adamax
// normalises.
//
// What bounds it on an H100.  The backward: latency.  Its per-sample work
// (the recompute from `stage`, the transform VJPs, the cotangent through the
// MLP) reads every weight from shared memory or L1 and keeps its per-thread
// arrays (~3 KB of stack) in local memory, which misses L1 once several
// blocks share an SM; the dW products add about one FMA and one
// shared-memory load per weight per sample, and two barriers per layer
// (ptxas, sm_90a: 64 registers, 3120 B stack, no spills, for either weight
// placement).  So what helps is more warps per SM and fewer barriers per
// sample: the wrapper picks the block size (128 to 512 samples) and whether
// the weights sit in shared memory or are read through L1 per plan, to keep
// the most threads resident with at least two blocks per SM (the 10-D
// flagship: two blocks of 512 with the weights through L1; camel: blocks of
// 512 with the weights in shared memory).  The forward: the shared-memory
// pipe and latency.  It keeps no per-thread array: every activation, logit
// and state value is a conflict-free shared-memory access to the thread's
// own column (a warp's 32 columns are consecutive).  Each thread computes a
// layer's outputs four at a time, so one activation load feeds four FMAs,
// and their weights arrive as one broadcast float4 from a copy in shared
// memory padded to multiples of four (or, where no launch leaves room for
// it, four scalar loads through L1): two shared-memory loads per four FMAs.
// The pwquad transform adds ~15 shared-memory accesses and one expf per
// logit.  The statistics add a barrier pair per block sum, deferred as long
// as the tiles allow (the tiles keep pre-ReLU values, and the next layer
// applies the ReLU as it reads them): once per cell on the 10-D flagship.
// Capped at 64 registers (__launch_bounds__(FWD_MAX_BLOCK, 2)) an SM holds
// 32 warps; at the ~110 registers it would take it held 16, and each
// barrier idled it.  The wrapper chooses the block size (128 to 512
// samples) and the weights' place per plan, the weights in shared memory
// first (train_fwd_config).  On an NVIDIA H100 (PERF.md section 6): the
// flagship at 7% of its bound (0.78 ms per 2^18); camel's stats variant is
// bound by its block sums' barriers and serial merges.

#include "flow_plan.cuh"

#define MAX_ACTS 256  // inputs of all of a cell's layers, per thread (backward)
#define MAX_OPS 256
#define FWD_MAX_BLOCK 512    // threads (samples) per forward block
#define STATS_MAX_SPLIT 8    // ways a statistics row's samples are split

__device__ __forceinline__ float positivity_grad(float z, int act) {
  return act == ACT_EXP ? expf(z) : 0.5f * (1.0f + z / sqrtf(z * z + 4.0f));
}

// ---------------------------------------------------------------------------
// The forward of one transformed dimension, with the quantities its VJP
// reads, for the training forward and the backward's recompute: the
// operations of flow_plan.cuh's apply_cell, in the same order, so bins and
// pdfs are the sampler's own.  These are the twins of apply_cell's inline
// transform maths, so an edit to either, the bin selection or the clamp
// above all, is made in both; the kernel-vs-plain checks of the three
// kernels keep them in step.  Z is the logits' accessor: a local array in
// the backward (float*), a column of a shared-memory tile in the forward
// (TileCol).
// ---------------------------------------------------------------------------

// Column t of a feature-major tile: element k is k rows down.
struct TileCol {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int k) const { return p[k * stride]; }
  __device__ __forceinline__ TileCol operator+(int k) const { return {p + k * stride, stride}; }
};

// One pwquad dimension.  z holds n_bins + 1 vertex logits, then n_bins width
// logits; they are replaced in place by the normalised heights v and widths u.
struct PwquadDim {
  float p;            // pdf
  float a, w_b;       // position inside the bin, width of the bin
  float v_lo, v_hi;   // normalised heights at the bin's edges
  float vw_b;         // the trapezoid area left of the bin
  float wtot, vnorm;  // the two normalisers: sum of widths, trapezoid area
  int bin;
};

template <class Z>
__device__ __forceinline__ PwquadDim pwquad_dim(Z z, int nb, int act, float x_raw) {
  Z v = z;            // nb + 1 vertex heights
  Z wd = z + nb + 1;  // nb bin widths
  float wtot = 0.0f;
  for (int k = 0; k < nb; ++k) {
    wd[k] = positivity(wd[k], act);
    wtot += wd[k];
  }
  for (int k = 0; k < nb; ++k) wd[k] = wd[k] / wtot;
  for (int k = 0; k <= nb; ++k) v[k] = positivity(v[k], act);
  float vnorm = 0.0f;
  for (int k = 0; k < nb; ++k) vnorm += (v[k] + v[k + 1]) * 0.5f * wd[k];
  for (int k = 0; k <= nb; ++k) v[k] = v[k] / vnorm;
  const float xB = fminf(x_raw, CLAMP_HI);
  // the bin: the last k whose left edge is <= xB (the last bin's upper
  // bound is open)
  float edge = 0.0f, vw = 0.0f;
  float w_b = wd[0], edge_b = 0.0f, vw_b = 0.0f, v_lo = v[0], v_hi = v[1];
  int bin = 0;
  for (int k = 0; k < nb; ++k) {
    const bool in = xB >= edge;
    bin = in ? k : bin;
    w_b = in ? wd[k] : w_b;
    edge_b = in ? edge : edge_b;
    vw_b = in ? vw : vw_b;
    v_lo = in ? v[k] : v_lo;
    v_hi = in ? v[k + 1] : v_hi;
    vw += (v[k] + v[k + 1]) * 0.5f * wd[k];
    edge += wd[k];
  }
  PwquadDim q;
  q.a = (xB - edge_b) / w_b;
  q.p = v_lo + (v_hi - v_lo) * q.a;
  q.w_b = w_b;
  q.v_lo = v_lo;
  q.v_hi = v_hi;
  q.vw_b = vw_b;
  q.wtot = wtot;
  q.vnorm = vnorm;
  q.bin = bin;
  return q;
}

// One pwlin dimension from its n_bins positive heights q.
struct PwlinDim {
  float p, alpha, qtot;
  int bin;
};

template <class Z>
__device__ __forceinline__ PwlinDim pwlin_dim(Z q, int nb, float x) {
  float qtot = 0.0f;
  for (int k = 0; k < nb; ++k) qtot += q[k];
  const float a = x * (float)nb;
  // clamp the bin before alpha: x == 1.0 maps to the right edge
  int bin = (int)floorf(a);
  bin = bin < 0 ? 0 : (bin > nb - 1 ? nb - 1 : bin);
  PwlinDim r;
  r.p = q[bin] / (qtot / (float)nb);
  r.alpha = (a - (float)bin) / (float)nb;
  r.qtot = qtot;
  r.bin = bin;
  return r;
}

// One affine dimension; p leaves out the 2/pi the cell applies once.
struct AffineDim {
  float p, s0, u, diff;
};

__device__ __forceinline__ AffineDim affine_dim(float z_s, float z_t, float x) {
  AffineDim q;
  q.s0 = expf(z_s);
  q.u = x * (20.0f * q.s0) + fmaxf(z_t, 0.0f);
  q.diff = 1.0f / (q.u * q.u + 1.0f);
  q.p = (20.0f * q.s0) * q.diff;
  return q;
}

// The logits of one transformed dimension: 2 n_bins + 1 for pwquad, n_bins
// for pwlin, (scale, shift) for affine.
__device__ __forceinline__ int logit_width(int kind, int nb) {
  return kind == KIND_PWQUAD ? 2 * nb + 1 : (kind == KIND_PWLIN ? nb : 2);
}

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// ---------------------------------------------------------------------------
// The training forward, one tile of blockDim.x samples at a time.  Thread t
// owns sample t of the tile and column t of every tile in shared memory
// (rows S1 = blockDim.x + 1 floats apart: odd, so that a warp's accesses to
// one row, or to rows of its own columns, fall in distinct banks).
// ---------------------------------------------------------------------------

// Four outputs' weights or biases at p: a float4 of the padded copy in
// shared memory, or four loads through L1 of the flat buffer at p, p + j1,
// p + j2, p + j3 (a column past the layer's last reads that one again; its
// output is not stored).
template <bool W_SMEM>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int j1, int j2, int j3) {
  if (W_SMEM) return *reinterpret_cast<const float4*>(p);
  return make_float4(__ldg(p), __ldg(p + j1), __ldg(p + j2), __ldg(p + j3));
}

// out[j] = b[j] + sum_k in[k] w[k][j] for j < n_out, in this thread's
// column, four outputs at a time: one activation load feeds four FMAs.  Each
// output is summed as apply_cell and the backward's recompute sum it (bias
// first, then k ascending, fmaf), so bins and ReLU masks are theirs.  Input
// row k is X's row xmap[k] where MAPPED, else in's row k, through a ReLU
// where RELU_IN (the stats variant keeps pre-ReLU values in the tiles).
// Row k of w starts k * ld floats in, and output j sits j * step floats
// along it (step 1 in the padded copy).
template <bool W_SMEM, bool MAPPED, bool RELU_IN>
__device__ __forceinline__ void dense(const float* __restrict__ w, const float* __restrict__ b,
                                      int ld, int step, int fan_in, int n_out, const float* in,
                                      const int* xmap, float* out, int S1, bool relu) {
  for (int j0 = 0; j0 < n_out; j0 += 4) {
    const int left = n_out - j0;
    const int j1 = min(1, left - 1) * step, j2 = min(2, left - 1) * step;
    const int j3 = min(3, left - 1) * step;
    const float* wj = w + j0 * step;
    const float4 bias = load4<W_SMEM>(b + j0 * step, j1, j2, j3);
    float a0 = bias.x, a1 = bias.y, a2 = bias.z, a3 = bias.w;
#pragma unroll 1
    for (int k = 0; k < fan_in; ++k) {
      const float h_raw = in[(MAPPED ? xmap[k] : k) * S1];
      const float h = RELU_IN ? fmaxf(h_raw, 0.0f) : h_raw;
      const float4 wk = load4<W_SMEM>(wj + k * ld, j1, j2, j3);
      a0 = fmaf(h, wk.x, a0);
      a1 = fmaf(h, wk.y, a1);
      a2 = fmaf(h, wk.z, a2);
      a3 = fmaf(h, wk.w, a3);
    }
    out[j0 * S1] = relu ? fmaxf(a0, 0.0f) : a0;
    if (left > 1) out[(j0 + 1) * S1] = relu ? fmaxf(a1, 0.0f) : a1;
    if (left > 2) out[(j0 + 2) * S1] = relu ? fmaxf(a2, 0.0f) : a2;
    if (left > 3) out[(j0 + 3) * S1] = relu ? fmaxf(a3, 0.0f) : a3;
  }
}

// The layer's input: X's rows through xmap (mapped), or a tile's rows,
// through a ReLU where relu_in.
template <bool W_SMEM>
__device__ __forceinline__ void dense_from(bool mapped, bool relu_in,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, int ld, int step,
                                           int fan_in, int n_out, const float* in,
                                           const int* xmap, float* out, int S1, bool relu) {
  if (mapped)
    dense<W_SMEM, true, false>(w, b, ld, step, fan_in, n_out, in, xmap, out, S1, relu);
  else if (relu_in)
    dense<W_SMEM, false, true>(w, b, ld, step, fan_in, n_out, in, xmap, out, S1, relu);
  else
    dense<W_SMEM, false, false>(w, b, ld, step, fan_in, n_out, in, xmap, out, S1, relu);
}

// The rows whose statistics wait for the next block sum: n_x of X's rows
// (through the cell's row map), then up to two tiles' first rows, in the
// order of their rows in the accumulator.
struct StatRows {
  int n_x = 0, n0 = 0, n1 = 0;
  const float* tile0 = nullptr;
  const float* tile1 = nullptr;
  __device__ __forceinline__ int count() const { return n_x + n0 + n1; }
  __device__ __forceinline__ bool holds(const float* t) const {
    return (n0 && tile0 == t) || (n1 && tile1 == t);
  }
  __device__ __forceinline__ void add(const float* t, int rows) {
    if (n0) {
      tile1 = t;
      n1 = rows;
    } else {
      tile0 = t;
      n0 = rows;
    }
  }
};

// acc[2r] += sum_s y_r[s] and acc[2r + 1] += sum_s y_r[s]^2 over the tile's
// nv valid samples for each waiting row r (at most blockDim.x of them).
// Every thread of the block calls it after writing its column of those
// rows.  Each task sums one row over the samples s = q, q + k, ... in four
// float running sums taken in turn (the squares formed in float, as the
// plain version forms them), added in a fixed order; a row's k partial sums
// then meet in a fixed order in double.  No atomics and no shuffles: two
// launches on the same inputs give the same bits.  Its second barrier ends
// every read of the tiles, so they may be written again when it returns.
__device__ __forceinline__ void block_stats(StatRows& st, const float* X, const int* xmap,
                                            int S1, int nv, double* acc, double* part) {
  const int B = blockDim.x, R = st.count();
  const int k = max(1, min(B / R, STATS_MAX_SPLIT));
  __syncthreads();
  for (int task = threadIdx.x; task < R * k; task += B) {
    const int r = task % R, q = task / R;
    const int r1 = r - st.n_x, r2 = r1 - st.n0;
    const float* y = r < st.n_x ? X + xmap[r] * S1
                                : (r2 < 0 ? st.tile0 + r1 * S1 : st.tile1 + r2 * S1);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, q3 = 0.0f;
    int j = q;
    for (; j + 3 * k < nv; j += 4 * k) {
      const float v0 = y[j], v1 = y[j + k], v2 = y[j + 2 * k], v3 = y[j + 3 * k];
      s0 += v0;
      s1 += v1;
      s2 += v2;
      s3 += v3;
      q0 += v0 * v0;
      q1 += v1 * v1;
      q2 += v2 * v2;
      q3 += v3 * v3;
    }
    for (; j < nv; j += k) {
      const float v = y[j];
      s0 += v;
      q0 += v * v;
    }
    part[2 * task] = (double)((s0 + s1) + (s2 + s3));
    part[2 * task + 1] = (double)((q0 + q1) + (q2 + q3));
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += B) {
    double s = 0.0, sq = 0.0;
    for (int q = 0; q < k; ++q) {
      s += part[2 * (q * R + r)];
      sq += part[2 * (q * R + r) + 1];
    }
    acc[2 * r] += s;
    acc[2 * r + 1] += sq;
  }
  st = StatRows();
}

// The wrapper's table (pwquad_train.fwd_table): [n_cells, each cell's
// position in the descriptor, then for each cell and once more for the end
// of the flow the X row of each of the n_flow logical dimensions].
//
// W_SMEM: the weights are copied into shared memory, every row of a layer
// padded to a multiple of four floats (the last layer's per transformed
// dimension, so each dimension's logits start on a float4); otherwise every
// thread reads the flat buffer through L1, which leaves the shared memory to
// more resident blocks.
template <bool STATS, bool W_SMEM>
__global__ void __launch_bounds__(FWD_MAX_BLOCK, 2)
train_fwd_kernel(const int* __restrict__ desc, int desc_len, const int* __restrict__ tab,
                 int tab_len, const float* __restrict__ weights, int n_wpad,
                 const float* __restrict__ latents, float* __restrict__ x_out,
                 float* __restrict__ jac_out, float* __restrict__ stage,
                 double* __restrict__ stats_partial, int n_stat_rows, long long n, int n_flow,
                 int rows_a, int rows_b) {
  extern __shared__ double smem_d[];
  const int S = blockDim.x, S1 = S + 1, t = threadIdx.x;
  double* acc = smem_d;                            // [n_stat_rows] with STATS
  double* part = acc + (STATS ? n_stat_rows : 0);  // [2 S] with STATS
  int* D = reinterpret_cast<int*>(part + (STATS ? 2 * S : 0));
  int* T = D + desc_len;
  float* W_s = reinterpret_cast<float*>(D + round4(desc_len + tab_len));  // [n_wpad]
  float* X = W_s + (W_SMEM ? n_wpad : 0);  // [n_flow][S1]: the state
  float* A = X + n_flow * S1;              // [rows_a][S1]
  float* B = A + rows_a * S1;              // [rows_b][S1]: also the logits
  for (int i = t; i < desc_len; i += S) D[i] = desc[i];
  for (int i = t; i < tab_len; i += S) T[i] = tab[i];
  if (STATS)
    for (int i = t; i < n_stat_rows; i += S) acc[i] = 0.0;
  __syncthreads();
  const int n_cells = T[0];
  const int* cell_pos = T + 1;
  const int* maps = T + 1 + n_cells;

  if (t == 0) {  // the table, the tiles and the counts must fit the plan
    bool bad = D[0] != n_flow || tab_len != 1 + n_cells + (n_cells + 1) * n_flow;
    int wq = 0, rows = 0;
    for (int c = 0; c < n_cells && !bad; ++c) {
      const int p = cell_pos[c];
      if (p < 2 || p + 6 > desc_len || D[p] != OP_CELL) {
        bad = true;
        break;
      }
      const int pt = D[p + 2], n_layers = D[p + 5];
      const int width = logit_width(D[p + 1], D[p + 3]);
      rows += 2 * pt;
      for (int l = 0; l < n_layers; ++l) {
        const int* L = D + p + 6 + 5 * l;
        if (l < n_layers - 1) {
          bad |= L[1] > (((n_layers - 2 - l) & 1) ? rows_b : rows_a);
          wq += (L[0] + 1) * round4(L[1]);
          rows += L[2] ? 2 * L[1] : 0;
        } else {
          bad |= width > rows_b;
          wq += (L[0] + 1) * (n_flow - pt) * round4(width);
        }
      }
    }
    if (bad || (W_SMEM && wq != n_wpad) || (STATS && rows != n_stat_rows)) __trap();
  }
  if (W_SMEM) {  // the padded copy, layer after layer in plan order
    int wp = 0;
    for (int c = 0; c < n_cells; ++c) {
      const int p = cell_pos[c];
      const int kind = D[p + 1], t_dims = n_flow - D[p + 2], n_layers = D[p + 5];
      const int width = logit_width(kind, D[p + 3]), width4 = round4(width);
      for (int l = 0; l < n_layers; ++l) {
        const int* L = D + p + 6 + 5 * l;
        const int fan_in = L[0], fan_out = L[1];
        const bool last = l == n_layers - 1;
        const int ld = last ? t_dims * width4 : round4(fan_out);
        for (int e = t; e < (fan_in + 1) * ld; e += S) {
          const int r = e / ld, pc = e - r * ld;
          int col = pc;
          bool pad = pc >= fan_out;
          if (last) {  // column pc is logit j of dimension ti
            const int ti = pc / width4, j = pc - ti * width4;
            pad = j >= width;
            col = kind == KIND_AFFINE ? ti + j * t_dims : ti * width + j;
          }
          W_s[wp + e] = pad ? 0.0f : weights[(r < fan_in ? L[3] + r * fan_out : L[4]) + col];
        }
        wp += (fan_in + 1) * ld;
      }
    }
  }

  const int* map_end = maps + n_cells * n_flow;
  const bool io4 = ((reinterpret_cast<size_t>(latents) | reinterpret_cast<size_t>(x_out)) & 15) == 0;
  float* Xc = X + t;
  float* Bc = B + t;
  const long long stride = (long long)gridDim.x * S;
  for (long long base = (long long)blockIdx.x * S; base < n; base += stride) {
    const int nv = (int)min((long long)S, n - base);
    const long long i = base + t;
    const bool valid = t < nv;
    // the tile's latents, one contiguous run, into X (a lane past n: 0.5)
    const float* src = latents + base * n_flow;
    __syncthreads();  // the weights are copied; the last tile's x is read out
    if (io4 && nv == S) {
      for (int e4 = t; e4 < S * n_flow / 4; e4 += S) {
        const float4 v = reinterpret_cast<const float4*>(src)[e4];
        const float vs[4] = {v.x, v.y, v.z, v.w};
        for (int c = 0; c < 4; ++c) {
          const int e = 4 * e4 + c, s = e / n_flow;
          X[(e - s * n_flow) * S1 + s] = vs[c];
        }
      }
    } else {
      for (int e = t; e < S * n_flow; e += S) {
        const int s = e / n_flow;
        X[(e - s * n_flow) * S1 + s] = s < nv ? src[e] : 0.5f;
      }
    }
    __syncthreads();

    float jac = 1.0f;
    int wp = 0, row = 0;
    for (int c = 0; c < n_cells; ++c) {
      const int p = cell_pos[c];
      const int* m = maps + c * n_flow;  // logical dimension d is X's row m[d]
      const int kind = D[p + 1], pt = D[p + 2], nb = D[p + 3], act = D[p + 4];
      const int n_hidden = D[p + 5] - 1;
      const int* L = D + p + 6;
      if (valid) {
        for (int d = 0; d < n_flow; ++d)
          stage[((long long)c * n_flow + d) * n + i] = Xc[m[d] * S1];
      }
      // every layer but the last, in full; the last hidden output lands in
      // A.  With STATS the tiles keep the pre-ReLU values, the next layer
      // applies the ReLU as it reads them, and the rows are summed as late
      // as possible: before a layer overwrites a tile whose rows wait, and
      // before the last layer.
      StatRows st;
      st.n_x = STATS ? pt : 0;
      auto flush = [&]() {
        const int rows = st.count();
        block_stats(st, X, m, S1, nv, acc + row, part);
        row += 2 * rows;
      };
      const float* h = Xc;
      bool mapped = true, relu_in = false;
      for (int l = 0; l < n_hidden; ++l, L += 5) {
        const int fan_in = L[0], fan_out = L[1], relu = L[2];
        float* o = ((n_hidden - 1 - l) & 1) ? B : A;
        if (STATS && st.holds(o)) flush();
        if (W_SMEM) {
          const int ld = round4(fan_out);
          dense_from<true>(mapped, relu_in, W_s + wp, W_s + wp + fan_in * ld, ld, 1, fan_in,
                           fan_out, h, m, o + t, S1, relu && !STATS);
          wp += (fan_in + 1) * ld;
        } else {
          dense_from<false>(mapped, relu_in, weights + L[3], weights + L[4], fan_out, 1,
                            fan_in, fan_out, h, m, o + t, S1, relu && !STATS);
        }
        if (STATS && relu) {  // this layer's rows wait for the next block sum
          if (st.count() + fan_out > S) flush();
          st.add(o, fan_out);
        }
        h = o + t;
        mapped = false;
        relu_in = STATS && relu;
      }
      if (STATS && st.count() > 0) flush();

      // the last layer, one transformed dimension's logits at a time into B
      const int fin = L[0], fout = L[1];
      const int t_dims = n_flow - pt, width = logit_width(kind, nb);
      const int ld = t_dims * round4(width);
      for (int ti = 0; ti < t_dims; ++ti) {
        if (W_SMEM) {
          const float* w = W_s + wp + ti * round4(width);
          dense_from<true>(mapped, relu_in, w, w + fin * ld, ld, 1, fin, width, h, m, Bc, S1,
                           false);
        } else {
          // this dimension's logit columns: a contiguous run, or (ti, t + ti)
          const int col0 = kind == KIND_AFFINE ? ti : ti * width;
          dense_from<false>(mapped, relu_in, weights + L[3] + col0, weights + L[4] + col0,
                            fout, kind == KIND_AFFINE ? t_dims : 1, fin, width, h, m, Bc, S1,
                            false);
        }
        float* xo = Xc + m[pt + ti] * S1;
        const float x_raw = *xo;
        const TileCol z = {Bc, S1};
        float y;
        if (kind == KIND_PWQUAD) {
          const PwquadDim q = pwquad_dim(z, nb, act, x_raw);
          y = 0.5f * q.a * q.a * (q.v_hi - q.v_lo) * q.w_b + q.a * q.v_lo * q.w_b + q.vw_b;
          jac *= q.p;
        } else if (kind == KIND_PWLIN) {
          for (int k = 0; k < nb; ++k) z[k] = positivity(z[k], act);
          const PwlinDim r = pwlin_dim(z, nb, x_raw);
          float below = 0.0f;
          for (int k = 0; k < r.bin; ++k) below += z[k];
          y = r.p * r.alpha + below / r.qtot;
          jac *= r.p;
        } else {
          const AffineDim q = affine_dim(z[0], z[1], x_raw);
          y = atanf(q.u) / 1.57079632679489662f;
          jac *= q.p;
        }
        *xo = y;
      }
      if (kind == KIND_AFFINE) jac *= TWO_OVER_PI;  // 2/pi once per cell (reference quirk)
      if (W_SMEM) wp += (fin + 1) * ld;
    }
    if (valid) jac_out[i] = jac;

    // x, one contiguous run, out of X
    __syncthreads();
    float* dst = x_out + base * n_flow;
    if (io4 && nv == S) {
      for (int e4 = t; e4 < S * n_flow / 4; e4 += S) {
        float vs[4];
        for (int c = 0; c < 4; ++c) {
          const int e = 4 * e4 + c, s = e / n_flow;
          vs[c] = X[map_end[e - s * n_flow] * S1 + s];
        }
        reinterpret_cast<float4*>(dst)[e4] = make_float4(vs[0], vs[1], vs[2], vs[3]);
      }
    } else {
      for (int e = t; e < nv * n_flow; e += S) {
        const int s = e / n_flow;
        dst[e] = X[map_end[e - s * n_flow] * S1 + s];
      }
    }
  }
  if (STATS) {
    __syncthreads();
    for (int r = t; r < n_stat_rows; r += S)
      stats_partial[(long long)blockIdx.x * n_stat_rows + r] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// Closed-form VJPs of one transformed dimension (nf_tpu/ops/pwquad_train.py
// _pwquad_dim_bwd, _pwlin_dim_bwd, _affine_dim_bwd), from the recomputes
// above.  jj = jbar * jac, so pbar = jj / p is the cotangent of this
// dimension's pdf.  They write the logits' cotangent to zbar and return x's.
// ---------------------------------------------------------------------------

__device__ float pwquad_dim_vjp(const float* z, int nb, int act, float x_raw,
                                float ybar, float jj, float* zbar) {
  float vu[2 * MAX_BINS + 1];
  for (int k = 0; k < 2 * nb + 1; ++k) vu[k] = z[k];
  const PwquadDim q = pwquad_dim(vu, nb, act, x_raw);
  const float* v = vu;
  const float* u = vu + nb + 1;
  const int b = q.bin;
  const float pbar = jj / q.p;
  const float a = q.a, dv = q.v_hi - q.v_lo, inv_wb = 1.0f / q.w_b;

  // through y = a^2/2 dv w_b + a v_lo w_b + S_b and p = v_lo + dv a
  const float abar = ybar * q.p * q.w_b + pbar * dv;
  const float c_vlo = ybar * q.w_b * (a - 0.5f * a * a) + pbar * (1.0f - a);
  const float c_vhi = ybar * q.w_b * (0.5f * a * a) + pbar * a;
  const float c_ub_sel = ybar * (0.5f * a * a * dv + a * q.v_lo) - abar * a * inv_wb;
  const float c_u_pre = -abar * inv_wb;  // through the left edge sum_{j<b} u_j
  float vbar[MAX_BINS + 1], ubar[MAX_BINS], g[MAX_BINS + 1];
  for (int k = 0; k <= nb; ++k) vbar[k] = 0.0f;
  for (int k = 0; k < nb; ++k) {
    const float trap = k < b ? ybar * 0.5f * u[k] : 0.0f;  // through S_b
    vbar[k] += (k == b ? c_vlo : 0.0f) + trap;
    vbar[k + 1] += (k == b ? c_vhi : 0.0f) + trap;
    ubar[k] = k == b ? c_ub_sel
                     : (k < b ? c_u_pre + ybar * 0.5f * (v[k] + v[k + 1]) : 0.0f);
  }

  // trapezoid normalisation v_k = g_k / T, T = sum_k (g_k + g_{k+1}) / 2 u_k
  const float inv_T = 1.0f / q.vnorm;
  float svv = 0.0f;
  for (int k = 0; k <= nb; ++k) svv += vbar[k] * v[k];
  const float Tbar = -svv * inv_T;
  for (int k = 0; k <= nb; ++k) {
    g[k] = positivity(z[k], act);
    float gbar = vbar[k] * inv_T;
    if (k > 0) gbar += Tbar * 0.5f * u[k - 1];
    if (k < nb) gbar += Tbar * 0.5f * u[k];
    zbar[k] = gbar * positivity_grad(z[k], act);
  }
  for (int k = 0; k < nb; ++k) ubar[k] += Tbar * 0.5f * (g[k] + g[k + 1]);

  // width normalisation u_k = e_k / W
  float suu = 0.0f;
  for (int k = 0; k < nb; ++k) suu += ubar[k] * u[k];
  for (int k = 0; k < nb; ++k)
    zbar[nb + 1 + k] = (ubar[k] - suu) * positivity_grad(z[nb + 1 + k], act) / q.wtot;

  // x is clamped to CLAMP_HI: no cotangent above it
  return x_raw < CLAMP_HI ? ybar * q.p + pbar * dv * inv_wb : 0.0f;
}

__device__ float pwlin_dim_vjp(const float* z, int nb, int act, float x,
                               float ybar, float jj, float* zbar) {
  float q[MAX_BINS], pdfbar[MAX_BINS];
  for (int k = 0; k < nb; ++k) q[k] = positivity(z[k], act);
  const PwlinDim r = pwlin_dim(q, nb, x);
  const float pbar = jj / r.p;
  // y = pdf_b alpha + sum_{j<b} pdf_j / n, p = pdf_b, pdf_k = n q_k / Q
  float s = 0.0f;
  for (int k = 0; k < nb; ++k) {
    pdfbar[k] = k == r.bin ? ybar * r.alpha + pbar : (k < r.bin ? ybar / (float)nb : 0.0f);
    s += pdfbar[k] * (q[k] / (r.qtot / (float)nb));
  }
  s /= (float)nb;
  for (int k = 0; k < nb; ++k)
    zbar[k] = (pdfbar[k] - s) * (float)nb * positivity_grad(z[k], act) / r.qtot;
  return ybar * r.p;  // dy/dx = pdf_b
}

__device__ float affine_dim_vjp(float z_s, float z_t, float x, float ybar,
                                float jj, float* zbar) {
  const AffineDim q = affine_dim(z_s, z_t, x);
  const float pbar = jj / q.p;  // jac carries the cell's 2/pi, jac / p keeps it
  // the true derivative of atan, 1 / (1 + u^2)
  const float ubar = ybar * TWO_OVER_PI * q.diff
                     + pbar * (20.0f * q.s0) * (-2.0f * q.u) * q.diff * q.diff;
  zbar[0] = ubar * 20.0f * x * q.s0 + pbar * q.p;
  zbar[1] = z_t > 0.0f ? ubar : 0.0f;
  return ubar * 20.0f * q.s0;
}

// ---------------------------------------------------------------------------
// The backward's weight gradient, one layer at a time, as a block product.
// Each thread writes its sample's column of two tiles in shared memory,
// feature-major with a row stride of blockDim.x + 1 floats (odd, so that a
// warp's loads from distinct rows fall in distinct banks): H, the layer's
// input and a last row of ones (for the bias), and G, the cotangent of the
// layer's output.  Lanes past n write zeros.  After a barrier, block_dw adds
// H^T G over the block's samples to the layer's rows of the accumulator.
// ---------------------------------------------------------------------------

#define BWD_MAX_BLOCK 512  // threads (samples) per backward block
#define BWD_MAX_SPLIT 32   // ways a layer's samples are split in block_dw

// The block's shared tiles: H [h_rows][stride], G [g_rows][stride], and
// block_dw's partial sums [4 * blockDim.x].
struct BwdTiles {
  float* H;
  float* G;
  float* part;
  int stride;
};

// acc[entry(r, c)] += sum_s H[r][s] G[c][s] for r < rows, c < cols, where
// H's row rows - 1 is the bias (entry b_off + col) and row r < rows - 1 is
// the weight w_off + r * ld + col, with col = col0 + c * step.  Every thread
// of the block calls it after the barrier that follows the tile writes; it
// holds one barrier, after which the tiles may be written again.
//
// Each task owns a 2 x 2 tile of entries (one loaded H or G value feeds two
// FMAs), summed over the samples s = q, q + k, ... in order.  A layer with
// fewer tiles than threads splits its samples k ways (at most
// BWD_MAX_SPLIT), so that more threads work; the k partial sums then meet in
// a fixed order.  No atomics and no shuffles: each entry's sum has one owner
// and one order.
__device__ void block_dw(const BwdTiles& tl, int rows, int cols, float* acc, int w_off,
                         int b_off, int ld, int col0, int step) {
  const int B = blockDim.x, S = tl.stride;
  const int nc = (cols + 1) >> 1;
  const int n_tiles = ((rows + 1) >> 1) * nc;
  const int k = n_tiles >= B ? 1 : min(B / n_tiles, BWD_MAX_SPLIT);
  for (int task = threadIdx.x; task < n_tiles * k; task += B) {
    const int tile = task % n_tiles, q = task / n_tiles;
    const int r0 = 2 * (tile / nc), c0 = 2 * (tile % nc);
    // an odd edge reads its last row or column twice and stores it once
    const float* h0 = tl.H + r0 * S;
    const float* h1 = tl.H + min(r0 + 1, rows - 1) * S;
    const float* g0 = tl.G + c0 * S;
    const float* g1 = tl.G + min(c0 + 1, cols - 1) * S;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = q; s < B; s += k) {
      const float x0 = h0[s], x1 = h1[s], y0 = g0[s], y1 = g1[s];
      a[0] = fmaf(x0, y0, a[0]);
      a[1] = fmaf(x0, y1, a[1]);
      a[2] = fmaf(x1, y0, a[2]);
      a[3] = fmaf(x1, y1, a[3]);
    }
    if (k == 1) {
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1), c = c0 + (e & 1);
        if (r < rows && c < cols)
          acc[(r < rows - 1 ? w_off + r * ld : b_off) + col0 + c * step] += a[e];
      }
    } else {
      for (int e = 0; e < 4; ++e) tl.part[4 * task + e] = a[e];
    }
  }
  __syncthreads();
  if (k == 1) return;
  for (int e = threadIdx.x; e < 4 * n_tiles; e += B) {
    const int tile = e >> 2;
    const int r = 2 * (tile / nc) + ((e >> 1) & 1), c = 2 * (tile % nc) + (e & 1);
    float s = 0.0f;
    for (int q = 0; q < k; ++q) s += tl.part[4 * (q * n_tiles + tile) + (e & 3)];
    if (r < rows && c < cols)
      acc[(r < rows - 1 ? w_off + r * ld : b_off) + col0 + c * step] += s;
  }
}

// Backward through the cell whose descriptor starts at D[p]: xin is the
// cell's input (from `stage`), xbar the cotangent of its output, replaced by
// that of its input.  Every thread of the block calls it (block_dw's
// barriers); a lane past n has valid false and writes zeros to the tiles.
__device__ void cell_vjp(const int* D, int p, const float* __restrict__ W,
                         const float* xin, float* xbar, float jj, float* acc,
                         const BwdTiles& tl, bool valid, int n_flow) {
  const int kind = D[p + 1], pt = D[p + 2], nb = D[p + 3], act = D[p + 4];
  const int n_layers = D[p + 5];
  const int* L = D + p + 6;

  // forward through every layer but the last, keeping each layer's input
  float acts[MAX_ACTS];
  for (int k = 0; k < pt; ++k) acts[k] = xin[k];
  int off = 0;
  for (int l = 0; l < n_layers - 1; ++l, L += 5) {
    const int fan_in = L[0], fan_out = L[1], relu = L[2];
    const float* w = W + L[3];
    const float* b = W + L[4];
    const float* h = acts + off;
    float* o = acts + off + fan_in;
    for (int j = 0; j < fan_out; ++j) {
      float s = b[j];
      for (int k = 0; k < fan_in; ++k) s = fmaf(h[k], w[k * fan_out + j], s);
      o[j] = relu ? fmaxf(s, 0.0f) : s;
    }
    off += fan_in;
  }

  // the last layer, one transformed dimension at a time: its input, and the
  // ones row of the bias, stay in H for every dimension's product
  const int tid = threadIdx.x;
  const float* h = acts + off;
  const int fin = L[0], fout = L[1];
  const float* wl = W + L[3];
  for (int i = 0; i < fin; ++i) tl.H[i * tl.stride + tid] = valid ? h[i] : 0.0f;
  tl.H[fin * tl.stride + tid] = valid ? 1.0f : 0.0f;
  float ra[MAX_HIDDEN], rb[MAX_HIDDEN];
  float* r = ra;  // cotangent of the last layer's input
  for (int k = 0; k < fin; ++k) r[k] = 0.0f;
  const int t = n_flow - pt;
  const int width = logit_width(kind, nb);
  float z[2 * MAX_BINS + 1], zbar[2 * MAX_BINS + 1];
  for (int ti = 0; ti < t; ++ti) {
    // this dimension's logit columns: a contiguous run, or (ti, t + ti)
    const int col0 = kind == KIND_AFFINE ? ti : ti * width;
    const int step = kind == KIND_AFFINE ? t : 1;
    for (int k = 0; k < width; ++k) z[k] = last_logit(W, L, h, col0 + k * step);
    const float ybar = xbar[pt + ti];
    float xb;
    if (kind == KIND_PWQUAD) {
      xb = pwquad_dim_vjp(z, nb, act, xin[pt + ti], ybar, jj, zbar);
    } else if (kind == KIND_PWLIN) {
      xb = pwlin_dim_vjp(z, nb, act, xin[pt + ti], ybar, jj, zbar);
    } else {
      xb = affine_dim_vjp(z[0], z[1], xin[pt + ti], ybar, jj, zbar);
    }
    xbar[pt + ti] = xb;
    for (int k = 0; k < width; ++k) {
      const int col = col0 + k * step;
      const float gk = zbar[k];
      tl.G[k * tl.stride + tid] = valid ? gk : 0.0f;
      for (int i = 0; i < fin; ++i) r[i] = fmaf(wl[i * fout + col], gk, r[i]);
    }
    __syncthreads();
    block_dw(tl, fin + 1, width, acc, L[3], L[4], fout, col0, step);
  }

  // the layers before it, last first
  float* r_in = rb;
  for (int l = n_layers - 2; l >= 0; --l) {
    L -= 5;
    const int fan_in = L[0], fan_out = L[1], relu = L[2];
    const float* w = W + L[3];
    off -= fan_in;
    const float* h_in = acts + off;
    const float* h_out = acts + off + fan_in;
    for (int o = 0; o < fan_out; ++o) {
      if (relu && !(h_out[o] > 0.0f)) r[o] = 0.0f;
      tl.G[o * tl.stride + tid] = valid ? r[o] : 0.0f;
    }
    for (int i = 0; i < fan_in; ++i) {
      float s = 0.0f;
      for (int o = 0; o < fan_out; ++o) s = fmaf(w[i * fan_out + o], r[o], s);
      r_in[i] = s;
      tl.H[i * tl.stride + tid] = valid ? h_in[i] : 0.0f;
    }
    tl.H[fan_in * tl.stride + tid] = valid ? 1.0f : 0.0f;
    __syncthreads();
    block_dw(tl, fan_in + 1, fan_out, acc, L[3], L[4], fan_out, 0, 1);
    float* tmp = r;
    r = r_in;
    r_in = tmp;
  }
  // the pass-through dims: their own cotangent plus the conditioner's
  for (int k = 0; k < pt; ++k) xbar[k] += r[k];
}

// W_SMEM: the weights are copied into shared memory; otherwise every thread
// reads them from device memory through L1, which leaves the shared memory
// to more resident blocks.
template <bool W_SMEM>
__global__ void __launch_bounds__(BWD_MAX_BLOCK)
train_bwd_kernel(const int* __restrict__ desc, int desc_len,
                 const float* __restrict__ weights, int n_weights,
                 const float* __restrict__ stage, const float* __restrict__ jac_in,
                 const float* __restrict__ jbar_in, const float* __restrict__ xbar0,
                 float* __restrict__ grad_partial, float* __restrict__ wbar, long long n,
                 int n_ops, int h_rows, int g_rows) {
  extern __shared__ double smem_d[];
  float* acc = reinterpret_cast<float*>(smem_d);  // [n_weights]
  float* W_s = acc + n_weights;                   // [n_weights] with W_SMEM
  const float* __restrict__ W = W_SMEM ? W_s : weights;
  int* D = reinterpret_cast<int*>(W_s + (W_SMEM ? n_weights : 0));
  int* op_pos = D + desc_len;     // [n_ops]: where each op starts
  int* n_cells = op_pos + n_ops;  // [1]
  BwdTiles tl;
  tl.stride = blockDim.x + 1;
  tl.H = reinterpret_cast<float*>(n_cells + 1);
  tl.G = tl.H + h_rows * tl.stride;
  tl.part = tl.G + g_rows * tl.stride;
  if (W_SMEM)
    for (int i = threadIdx.x; i < n_weights; i += blockDim.x) W_s[i] = weights[i];
  for (int i = threadIdx.x; i < desc_len; i += blockDim.x) D[i] = desc[i];
  for (int i = threadIdx.x; i < n_weights; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x == 0) {  // where each op starts, to walk them backwards
    if (D[1] != n_ops) __trap();
    int p = 2, nc = 0;
    for (int op = 0; op < n_ops; ++op) {
      op_pos[op] = p;
      if (D[p] == OP_PERM) {
        p += 1 + D[0];
        continue;
      }
      // the tiles must hold every layer's input and ones row, and every
      // hidden layer's output or transformed dimension's logits
      const int kind = D[p + 1], nb = D[p + 3], n_layers = D[p + 5];
      const int width = logit_width(kind, nb);
      for (int l = 0; l < n_layers; ++l) {
        const int* L = D + p + 6 + 5 * l;
        if (L[0] + 1 > h_rows || (l < n_layers - 1 ? L[1] : width) > g_rows) __trap();
      }
      p += 6 + 5 * n_layers;
      ++nc;
    }
    *n_cells = nc;
  }
  __syncthreads();

  const int n_flow = D[0];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    float xbar[MAX_FLOW], xin[MAX_FLOW];
    for (int d = 0; d < n_flow; ++d) xbar[d] = valid ? xbar0[i * n_flow + d] : 0.0f;
    const float jj = valid ? jbar_in[i] * jac_in[i] : 0.0f;
    int cell = *n_cells;
    for (int op = n_ops - 1; op >= 0; --op) {
      const int p = op_pos[op];
      if (D[p] == OP_PERM) {  // x_new[d] = x[src[d]]: xbar[src[d]] = xbar_new[d]
        float tmp[MAX_FLOW];
        for (int d = 0; d < n_flow; ++d) tmp[D[p + 1 + d]] = xbar[d];
        for (int d = 0; d < n_flow; ++d) xbar[d] = tmp[d];
        continue;
      }
      --cell;
      for (int d = 0; d < n_flow; ++d)
        xin[d] = valid ? stage[((long long)cell * n_flow + d) * n + i] : 0.5f;
      cell_vjp(D, p, W, xin, xbar, jj, acc, tl, valid, n_flow);
    }
    if (valid) {
      for (int d = 0; d < n_flow; ++d) wbar[i * n_flow + d] = xbar[d];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_weights; r += blockDim.x)
    grad_partial[(long long)blockIdx.x * n_weights + r] = acc[r];
}

static int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <bool STATS, bool W_SMEM>
static int launch_fwd(int n_blocks, int block, size_t smem, cudaStream_t stream,
                      const int* desc, int desc_len, const int* tab, int tab_len,
                      const float* weights, int n_wpad, const float* latents, float* x,
                      float* jac, float* stage, double* stats_partial, int n_stat_rows,
                      long long n, int n_flow, int rows_a, int rows_b) {
  const int e = set_smem((const void*)train_fwd_kernel<STATS, W_SMEM>, smem);
  if (e) return e;
  train_fwd_kernel<STATS, W_SMEM><<<n_blocks, block, smem, stream>>>(
      desc, desc_len, tab, tab_len, weights, n_wpad, latents, x, jac, stage, stats_partial,
      n_stat_rows, n, n_flow, rows_a, rows_b);
  return (int)cudaGetLastError();
}

extern "C" {

// The compiled caps and launch shape, so the wrapper can check its copy.
int nf_pwquad_train_limits(int* out) {
  out[0] = MAX_FLOW;
  out[1] = MAX_HIDDEN;
  out[2] = MAX_BINS;
  out[3] = MAX_ACTS;
  out[4] = MAX_OPS;
  out[5] = FWD_MAX_BLOCK;
  out[6] = BWD_MAX_BLOCK;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// latents [n, n_flow] f32 -> x [n, n_flow], jac [n], stage [n_cells, n_flow, n];
// with stats_partial non-null, also the [n_blocks, n_stat_rows] double sums.
// tab is the wrapper's table (pwquad_train.fwd_table), in blocks of `block`
// threads (a multiple of 32, from 128 to FWD_MAX_BLOCK), with the weights
// padded into shared memory (n_wpad floats) if w_smem is non-zero.  rows_a /
// rows_b are the rows of the A and B tiles the plan needs, and smem the
// block's bytes as the wrapper computed them
// (pwquad_train.train_fwd_smem_bytes); a mismatch is refused.
int nf_pwquad_train_fwd(const int* desc, int desc_len, const int* tab, int tab_len,
                        const float* weights, int n_wpad, const float* latents, float* x,
                        float* jac, float* stage, double* stats_partial, int n_stat_rows,
                        long long n, int n_flow, int n_blocks, int block, int w_smem,
                        int rows_a, int rows_b, long long smem, void* stream) {
  if (n <= 0) return 0;
  const bool stats = stats_partial != nullptr;
  const size_t need = sizeof(double) * (stats ? (size_t)n_stat_rows + 2 * (size_t)block : 0)
                      + sizeof(float) * ((((size_t)desc_len + tab_len + 3) & ~(size_t)3)
                                         + (w_smem ? (size_t)n_wpad : 0)
                                         + (size_t)(n_flow + rows_a + rows_b) * (block + 1));
  if ((size_t)smem != need || block % 32 || block < 128 || block > FWD_MAX_BLOCK
      || n_flow < 1 || n_flow > MAX_FLOW || rows_a < 0 || rows_b < 1
      || (stats && n_stat_rows % 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stats && w_smem)
    return launch_fwd<true, true>(n_blocks, block, need, s, desc, desc_len, tab, tab_len,
                                  weights, n_wpad, latents, x, jac, stage, stats_partial,
                                  n_stat_rows, n, n_flow, rows_a, rows_b);
  if (stats)
    return launch_fwd<true, false>(n_blocks, block, need, s, desc, desc_len, tab, tab_len,
                                   weights, n_wpad, latents, x, jac, stage, stats_partial,
                                   n_stat_rows, n, n_flow, rows_a, rows_b);
  if (w_smem)
    return launch_fwd<false, true>(n_blocks, block, need, s, desc, desc_len, tab, tab_len,
                                   weights, n_wpad, latents, x, jac, stage, nullptr, 0, n,
                                   n_flow, rows_a, rows_b);
  return launch_fwd<false, false>(n_blocks, block, need, s, desc, desc_len, tab, tab_len,
                                  weights, n_wpad, latents, x, jac, stage, nullptr, 0, n,
                                  n_flow, rows_a, rows_b);
}

// stage, jac [n], jbar [n], xbar0 [n, n_flow] -> grad_partial [n_blocks,
// n_weights] (summed over blocks by the caller) and wbar [n, n_flow], in
// blocks of `block` threads (a multiple of 32, at most BWD_MAX_BLOCK), with
// the weights in shared memory if w_smem is non-zero.  n_ops is the plan's
// op count, h_rows / g_rows the rows of the H and G tiles it needs, and smem
// the block's bytes as the wrapper computed them
// (pwquad_train.train_bwd_smem_bytes); a mismatch is refused.
int nf_pwquad_train_bwd(const int* desc, int desc_len, const float* weights,
                        int n_weights, const float* stage, const float* jac,
                        const float* jbar, const float* xbar0, float* grad_partial,
                        float* wbar, long long n, int n_blocks, int block, int w_smem,
                        int n_ops, int h_rows, int g_rows, long long smem, void* stream) {
  if (n <= 0) return 0;
  const size_t need = sizeof(float) * ((w_smem ? 2 : 1) * (size_t)n_weights
                                       + (size_t)desc_len + (size_t)n_ops + 1
                                       + (size_t)(h_rows + g_rows) * (block + 1)
                                       + 4 * (size_t)block);
  if ((size_t)smem != need || h_rows < 1 || g_rows < 1 || block % 32 || block < 32
      || block > BWD_MAX_BLOCK)
    return (int)cudaErrorInvalidValue;
  const void* kernel = w_smem ? (const void*)train_bwd_kernel<true>
                              : (const void*)train_bwd_kernel<false>;
  const int e = set_smem(kernel, need);
  if (e) return e;
  if (w_smem) {
    train_bwd_kernel<true><<<n_blocks, block, need, (cudaStream_t)stream>>>(
        desc, desc_len, weights, n_weights, stage, jac, jbar, xbar0, grad_partial,
        wbar, n, n_ops, h_rows, g_rows);
  } else {
    train_bwd_kernel<false><<<n_blocks, block, need, (cudaStream_t)stream>>>(
        desc, desc_len, weights, n_weights, stage, jac, jbar, xbar0, grad_partial,
        wbar, n, n_ops, h_rows, g_rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
