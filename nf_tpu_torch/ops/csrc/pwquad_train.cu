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
// shared-memory load per weight per sample, and two barriers per layer.  A
// plan beyond the local arrays' sizes (MAX_* below) runs the workspace
// kernel, whose arrays are plan-sized slices of a device buffer
// (train_bwd_ws_kernel): the same arithmetic, more device-memory traffic.  So
// what helps is more warps per SM and fewer barriers per sample: the
// wrapper picks the block size (128 to 512 samples, 64 or 32 where none of
// those fits) and whether the weights sit in shared memory or are read
// through L1 per plan, to keep the most threads resident with at least two
// blocks per SM (the 10-D flagship: blocks of 256 with the weights through
// L1; camel: blocks of 512 with the weights in shared memory).  The
// dW accumulator is the block's own row of the partial-gradient scratch in
// device memory, so it takes no shared memory and caps no plan's width
// (held in shared memory it refused plans beyond about 56k weights).  The
// forward: the shared-memory pipe and latency.  It keeps no per-thread array: every activation, logit
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
// samples, or 64 or 32) and the weights' place per plan, the weights in
// shared memory first (train_fwd_config).  On an NVIDIA H100 (PERF.md section 6): the
// flagship at 7% of its bound (0.78 ms per 2^18); camel's stats variant is
// bound by its block sums' barriers and serial merges.

#include "flow_plan.cuh"

// The backward's per-thread arrays at these sizes are local arrays; a plan
// beyond any of them runs the workspace kernel (train_bwd_ws_kernel below).
#define MAX_FLOW 32    // latent dims
#define MAX_HIDDEN 64  // any layer's fan_in
#define MAX_BINS 32    // bins of a pwquad / pwlin cell
#define MAX_ACTS 256   // inputs of all of a cell's layers
#define FWD_MAX_BLOCK 512    // threads (samples) per forward block
#define STATS_MAX_SPLIT 8    // ways a statistics row's samples are split

__device__ __forceinline__ float positivity_grad(float z, int act) {
  return act == ACT_EXP ? expf(z) : 0.5f * (1.0f + z / sqrtf(z * z + 4.0f));
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

// The wrapper's table (pwquad_train.fwd_table, flow_plan.cuh's row table).
//
// W_SMEM: the weights are copied into shared memory, padded
// (copy_padded_weights); otherwise every thread reads the flat buffer
// through L1, which leaves the shared memory to more resident blocks.
template <bool STATS, bool W_SMEM>
__global__ void __launch_bounds__(FWD_MAX_BLOCK, 2)
train_fwd_kernel(const int* __restrict__ desc, int desc_len, const int* __restrict__ tab,
                 int tab_len, const float* __restrict__ weights, int n_wpad,
                 const float* __restrict__ latents, float* __restrict__ x_out,
                 float* __restrict__ jac_out, float* __restrict__ stage,
                 double* __restrict__ stats_partial, int n_stat_rows, int part_rows,
                 long long n, int n_flow, int rows_a, int rows_b) {
  extern __shared__ double smem_d[];
  const int S = blockDim.x, S1 = S + 1, t = threadIdx.x;
  double* acc = smem_d;                            // [n_stat_rows] with STATS
  double* part = acc + (STATS ? n_stat_rows : 0);  // [2 part_rows] with STATS
  int* D = reinterpret_cast<int*>(part + (STATS ? 2 * part_rows : 0));
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
    int wq, rows, max_rows;
    const bool fit = tiles_fit(D, desc_len, tab_len, cell_pos, n_cells, n_flow, rows_a, rows_b,
                               &wq, &rows, &max_rows);
    // a block sum's rows, and at least S, fit block_stats' partial sums
    if (!fit || (W_SMEM && wq != n_wpad)
        || (STATS && (rows != n_stat_rows || max_rows > part_rows || part_rows < S)))
      __trap();
  }
  if (W_SMEM) copy_padded_weights(D, cell_pos, n_cells, n_flow, weights, W_s);

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
    __syncthreads();  // the weights are copied; the last tile's x is read out
    load_tile(X, latents + base * n_flow, nv, n_flow, S1, io4);
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

      // the last layer and the transform, one dimension at a time
      const int used = last_layer<W_SMEM>(L, kind, pt, nb, act, n_flow, mapped, relu_in, h, m,
                                          Xc, Bc, S1, W_s + wp, weights, jac);
      if (W_SMEM) wp += used;
    }
    if (valid) jac_out[i] = jac;

    // x, one contiguous run, out of X
    __syncthreads();
    store_tile(x_out + base * n_flow, X, map_end, nv, n_flow, S1, io4);
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

// The workspace kernel's per-thread arrays: plan-sized slices of a device
// workspace the wrapper allocates, element k of grid thread g at k * G + g
// (G the grid's threads), so that a warp's accesses coalesce as local
// memory's do.  Its VJPs, cell walk and kernel repeat the local-array ones
// above with the arrays as WsCol columns: written as one template over
// both, the local-array instantiation spilled 116 B and ran the camel
// backward 20% slower (PERF.md section 6).
enum BwdArray {
  ARR_XBAR, ARR_XIN, ARR_TMP, ARR_ACTS, ARR_RA, ARR_RB, ARR_Z, ARR_ZBAR,
  ARR_VU, ARR_VBAR, ARR_UBAR, ARR_G, ARR_Q, ARR_PDFBAR
};

struct BwdLayout {  // the slice's sizes: a cell's layer inputs, a fan_in, logits, bins
  int n_flow, acts, hidden, width, bins;
};

// Where each array starts in a thread's slice (floats): xbar, xin and the
// permutation's tmp [n_flow], a cell's layer inputs [acts], the two hidden
// cotangents [hidden], one dimension's logits and their cotangent [width],
// then the VJPs' arrays, pwquad's vu [2 bins + 1], vbar [bins + 1], ubar
// [bins], g [bins + 1], or pwlin's q and pdfbar [bins].  The wrapper counts
// the same (pwquad_train.bwd_workspace_floats).
__host__ __device__ __forceinline__ long long bwd_offset(const BwdLayout& o, BwdArray which) {
  const long long vjp = 3LL * o.n_flow + o.acts + 2LL * o.hidden + 2LL * o.width;
  switch (which) {
    case ARR_XBAR: return 0;
    case ARR_XIN: return o.n_flow;
    case ARR_TMP: return 2LL * o.n_flow;
    case ARR_ACTS: return 3LL * o.n_flow;
    case ARR_RA: return 3LL * o.n_flow + o.acts;
    case ARR_RB: return 3LL * o.n_flow + o.acts + o.hidden;
    case ARR_Z: return 3LL * o.n_flow + o.acts + 2LL * o.hidden;
    case ARR_ZBAR: return 3LL * o.n_flow + o.acts + 2LL * o.hidden + o.width;
    case ARR_VU: case ARR_Q: return vjp;
    case ARR_VBAR: return vjp + 2LL * o.bins + 1;
    case ARR_UBAR: return vjp + 3LL * o.bins + 2;
    case ARR_G: return vjp + 4LL * o.bins + 2;
    case ARR_PDFBAR: return vjp + o.bins;
  }
  return 0;
}

// Floats of one thread's slice.
__host__ __device__ __forceinline__ long long bwd_slice_floats(const BwdLayout& o) {
  return bwd_offset(o, ARR_VU) + 5LL * o.bins + 3;
}

// A thread's slice of the workspace: element k of array `which` at
// base + (offset + k) * G.
struct BwdWorkspace {
  BwdLayout o;
  float* base;  // the workspace, at this thread's column
  long long G;  // the grid's threads
  __device__ __forceinline__ WsCol col(BwdArray which) const {
    return {base + bwd_offset(o, which) * G, G};
  }
};

#define SCRATCH(name, which) const WsCol name = sc.col(which)

__device__ float pwquad_dim_vjp_ws(WsCol z, int nb, int act, float x_raw, float ybar,
                                   float jj, WsCol zbar, const BwdWorkspace& sc) {
  SCRATCH(vu, ARR_VU);
  for (int k = 0; k < 2 * nb + 1; ++k) vu[k] = z[k];
  const PwquadDim q = pwquad_dim(vu, nb, act, x_raw);
  const auto v = vu;
  const auto u = vu + nb + 1;
  const int b = q.bin;
  const float pbar = jj / q.p;
  const float a = q.a, dv = q.v_hi - q.v_lo, inv_wb = 1.0f / q.w_b;

  // through y = a^2/2 dv w_b + a v_lo w_b + S_b and p = v_lo + dv a
  const float abar = ybar * q.p * q.w_b + pbar * dv;
  const float c_vlo = ybar * q.w_b * (a - 0.5f * a * a) + pbar * (1.0f - a);
  const float c_vhi = ybar * q.w_b * (0.5f * a * a) + pbar * a;
  const float c_ub_sel = ybar * (0.5f * a * a * dv + a * q.v_lo) - abar * a * inv_wb;
  const float c_u_pre = -abar * inv_wb;  // through the left edge sum_{j<b} u_j
  SCRATCH(vbar, ARR_VBAR);
  SCRATCH(ubar, ARR_UBAR);
  SCRATCH(g, ARR_G);
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

__device__ float pwlin_dim_vjp_ws(WsCol z, int nb, int act, float x, float ybar, float jj,
                                  WsCol zbar, const BwdWorkspace& sc) {
  SCRATCH(q, ARR_Q);
  SCRATCH(pdfbar, ARR_PDFBAR);
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

__device__ float affine_dim_vjp_ws(float z_s, float z_t, float x, float ybar, float jj,
                                   WsCol zbar) {
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
  // the dW accumulator [n_weights]: the block's own row of grad_partial
  float* acc = grad_partial + (long long)blockIdx.x * n_weights;
  float* W_s = reinterpret_cast<float*>(smem_d);  // [n_weights] with W_SMEM
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
}

// Backward through the cell whose descriptor starts at D[p]: xin is the
// cell's input (from `stage`), xbar the cotangent of its output, replaced by
// that of its input.  Every thread of the block calls it (block_dw's
// barriers); a lane past n has valid false and writes zeros to the tiles.
__device__ void cell_vjp_ws(const int* D, int p, const float* __restrict__ W, WsCol xin,
                            WsCol xbar, float jj, float* acc, const BwdTiles& tl, bool valid,
                            int n_flow, const BwdWorkspace& sc) {
  const int kind = D[p + 1], pt = D[p + 2], nb = D[p + 3], act = D[p + 4];
  const int n_layers = D[p + 5];
  const int* L = D + p + 6;

  // forward through every layer but the last, keeping each layer's input
  SCRATCH(acts, ARR_ACTS);
  for (int k = 0; k < pt; ++k) acts[k] = xin[k];
  int off = 0;
  for (int l = 0; l < n_layers - 1; ++l, L += 5) {
    const int fan_in = L[0], fan_out = L[1], relu = L[2];
    const float* w = W + L[3];
    const float* b = W + L[4];
    const auto h = acts + off;
    const auto o = acts + off + fan_in;
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
  const auto h = acts + off;
  const int fin = L[0], fout = L[1];
  const float* wl = W + L[3];
  for (int i = 0; i < fin; ++i) tl.H[i * tl.stride + tid] = valid ? h[i] : 0.0f;
  tl.H[fin * tl.stride + tid] = valid ? 1.0f : 0.0f;
  SCRATCH(ra, ARR_RA);
  SCRATCH(rb, ARR_RB);
  auto r = ra;  // cotangent of the last layer's input
  for (int k = 0; k < fin; ++k) r[k] = 0.0f;
  const int t = n_flow - pt;
  const int width = logit_width(kind, nb);
  SCRATCH(z, ARR_Z);
  SCRATCH(zbar, ARR_ZBAR);
  for (int ti = 0; ti < t; ++ti) {
    // this dimension's logit columns: a contiguous run, or (ti, t + ti)
    const int col0 = kind == KIND_AFFINE ? ti : ti * width;
    const int step = kind == KIND_AFFINE ? t : 1;
    for (int k = 0; k < width; ++k) z[k] = last_logit(W, L, h, col0 + k * step);
    const float ybar = xbar[pt + ti];
    float xb;
    if (kind == KIND_PWQUAD) {
      xb = pwquad_dim_vjp_ws(z, nb, act, xin[pt + ti], ybar, jj, zbar, sc);
    } else if (kind == KIND_PWLIN) {
      xb = pwlin_dim_vjp_ws(z, nb, act, xin[pt + ti], ybar, jj, zbar, sc);
    } else {
      xb = affine_dim_vjp_ws(z[0], z[1], xin[pt + ti], ybar, jj, zbar);
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
  auto r_in = rb;
  for (int l = n_layers - 2; l >= 0; --l) {
    L -= 5;
    const int fan_in = L[0], fan_out = L[1], relu = L[2];
    const float* w = W + L[3];
    off -= fan_in;
    const auto h_in = acts + off;
    const auto h_out = acts + off + fan_in;
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
    const auto tmp = r;
    r = r_in;
    r_in = tmp;
  }
  // the pass-through dims: their own cotangent plus the conditioner's
  for (int k = 0; k < pt; ++k) xbar[k] += r[k];
}

// train_bwd_kernel with the per-thread arrays as slices of `ws`, laid out
// for (n_flow, ws_acts, ws_hidden, ws_width, ws_bins): for plans beyond the
// local arrays' sizes.
template <bool W_SMEM>
__global__ void __launch_bounds__(BWD_MAX_BLOCK)
train_bwd_ws_kernel(const int* __restrict__ desc, int desc_len,
                 const float* __restrict__ weights, int n_weights,
                 const float* __restrict__ stage, const float* __restrict__ jac_in,
                 const float* __restrict__ jbar_in, const float* __restrict__ xbar0,
                 float* __restrict__ grad_partial, float* __restrict__ wbar, long long n,
                 int n_ops, int h_rows, int g_rows, float* __restrict__ ws, int ws_acts,
                 int ws_hidden, int ws_width, int ws_bins) {
  extern __shared__ double smem_d[];
  // the dW accumulator [n_weights]: the block's own row of grad_partial
  float* acc = grad_partial + (long long)blockIdx.x * n_weights;
  float* W_s = reinterpret_cast<float*>(smem_d);  // [n_weights] with W_SMEM
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
      // hidden layer's output or transformed dimension's logits; the
      // per-thread arrays every layer input and one dimension's logits
      const int kind = D[p + 1], nb = D[p + 3], n_layers = D[p + 5];
      const int width = logit_width(kind, nb);
      int acts = 0;
      for (int l = 0; l < n_layers; ++l) {
        const int* L = D + p + 6 + 5 * l;
        if (L[0] + 1 > h_rows || (l < n_layers - 1 ? L[1] : width) > g_rows) __trap();
        if (L[0] > ws_hidden) __trap();
        acts += L[0];
      }
      if (acts > ws_acts || width > ws_width || (kind != KIND_AFFINE && nb > ws_bins))
        __trap();
      p += 6 + 5 * n_layers;
      ++nc;
    }
    *n_cells = nc;
  }
  __syncthreads();

  const int n_flow = D[0];
  BwdWorkspace sc;
  sc.o = {n_flow, ws_acts, ws_hidden, ws_width, ws_bins};
  sc.base = ws + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  sc.G = (long long)gridDim.x * blockDim.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    SCRATCH(xbar, ARR_XBAR);
    SCRATCH(xin, ARR_XIN);
    for (int d = 0; d < n_flow; ++d) xbar[d] = valid ? xbar0[i * n_flow + d] : 0.0f;
    const float jj = valid ? jbar_in[i] * jac_in[i] : 0.0f;
    int cell = *n_cells;
    for (int op = n_ops - 1; op >= 0; --op) {
      const int p = op_pos[op];
      if (D[p] == OP_PERM) {  // x_new[d] = x[src[d]]: xbar[src[d]] = xbar_new[d]
        SCRATCH(tmp, ARR_TMP);
        for (int d = 0; d < n_flow; ++d) tmp[D[p + 1 + d]] = xbar[d];
        for (int d = 0; d < n_flow; ++d) xbar[d] = tmp[d];
        continue;
      }
      --cell;
      for (int d = 0; d < n_flow; ++d)
        xin[d] = valid ? stage[((long long)cell * n_flow + d) * n + i] : 0.5f;
      cell_vjp_ws(D, p, W, xin, xbar, jj, acc, tl, valid, n_flow, sc);
    }
    if (valid) {
      for (int d = 0; d < n_flow; ++d) wbar[i * n_flow + d] = xbar[d];
    }
  }
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
                      int part_rows, long long n, int n_flow, int rows_a, int rows_b) {
  const int e = set_smem((const void*)train_fwd_kernel<STATS, W_SMEM>, smem);
  if (e) return e;
  train_fwd_kernel<STATS, W_SMEM><<<n_blocks, block, smem, stream>>>(
      desc, desc_len, tab, tab_len, weights, n_wpad, latents, x, jac, stage, stats_partial,
      n_stat_rows, part_rows, n, n_flow, rows_a, rows_b);
  return (int)cudaGetLastError();
}

template <bool W_SMEM, bool WS>
static int launch_bwd(int n_blocks, int block, size_t smem, cudaStream_t stream,
                      const int* desc, int desc_len, const float* weights, int n_weights,
                      const float* stage, const float* jac, const float* jbar,
                      const float* xbar0, float* grad_partial, float* wbar, long long n,
                      int n_ops, int h_rows, int g_rows, float* ws, const int* ws_sizes) {
  if constexpr (WS) {
    const int e = set_smem((const void*)train_bwd_ws_kernel<W_SMEM>, smem);
    if (e) return e;
    train_bwd_ws_kernel<W_SMEM><<<n_blocks, block, smem, stream>>>(
        desc, desc_len, weights, n_weights, stage, jac, jbar, xbar0, grad_partial, wbar, n,
        n_ops, h_rows, g_rows, ws, ws_sizes[0], ws_sizes[1], ws_sizes[2], ws_sizes[3]);
  } else {
    const int e = set_smem((const void*)train_bwd_kernel<W_SMEM>, smem);
    if (e) return e;
    train_bwd_kernel<W_SMEM><<<n_blocks, block, smem, stream>>>(
        desc, desc_len, weights, n_weights, stage, jac, jbar, xbar0, grad_partial, wbar, n,
        n_ops, h_rows, g_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// The backward's local-array sizes and the launch shapes, so the wrapper
// can check its copy.
int nf_pwquad_train_limits(int* out) {
  out[0] = MAX_FLOW;
  out[1] = MAX_HIDDEN;
  out[2] = MAX_BINS;
  out[3] = MAX_ACTS;
  out[4] = FWD_MAX_BLOCK;
  out[5] = BWD_MAX_BLOCK;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// latents [n, n_flow] f32 -> x [n, n_flow], jac [n], stage [n_cells, n_flow, n];
// with stats_partial non-null, also the [n_blocks, n_stat_rows] double sums,
// the block sums' partial pairs taking 2 part_rows doubles (at least 2 block:
// the most rows one block sum takes, or block if more).
// tab is the wrapper's table (pwquad_train.fwd_table), in blocks of `block`
// threads (a multiple of 32, at most FWD_MAX_BLOCK), with the weights
// padded into shared memory (n_wpad floats) if w_smem is non-zero.  rows_a /
// rows_b are the rows of the A and B tiles the plan needs, and smem the
// block's bytes as the wrapper computed them
// (pwquad_train.train_fwd_smem_bytes); a mismatch is refused.
int nf_pwquad_train_fwd(const int* desc, int desc_len, const int* tab, int tab_len,
                        const float* weights, int n_wpad, const float* latents, float* x,
                        float* jac, float* stage, double* stats_partial, int n_stat_rows,
                        int part_rows, long long n, int n_flow, int n_blocks, int block,
                        int w_smem, int rows_a, int rows_b, long long smem, void* stream) {
  if (n <= 0) return 0;
  const bool stats = stats_partial != nullptr;
  const size_t need = sizeof(double) * (stats ? (size_t)n_stat_rows + 2 * (size_t)part_rows : 0)
                      + sizeof(float) * ((((size_t)desc_len + tab_len + 3) & ~(size_t)3)
                                         + (w_smem ? (size_t)n_wpad : 0)
                                         + (size_t)(n_flow + rows_a + rows_b) * (block + 1));
  if ((size_t)smem != need || block % 32 || block < 32 || block > FWD_MAX_BLOCK
      || n_flow < 1 || rows_a < 0 || rows_b < 1
      || (stats && (n_stat_rows % 2 || part_rows < block)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stats && w_smem)
    return launch_fwd<true, true>(n_blocks, block, need, s, desc, desc_len, tab, tab_len,
                                  weights, n_wpad, latents, x, jac, stage, stats_partial,
                                  n_stat_rows, part_rows, n, n_flow, rows_a, rows_b);
  if (stats)
    return launch_fwd<true, false>(n_blocks, block, need, s, desc, desc_len, tab, tab_len,
                                   weights, n_wpad, latents, x, jac, stage, stats_partial,
                                   n_stat_rows, part_rows, n, n_flow, rows_a, rows_b);
  if (w_smem)
    return launch_fwd<false, true>(n_blocks, block, need, s, desc, desc_len, tab, tab_len,
                                   weights, n_wpad, latents, x, jac, stage, nullptr, 0, 0, n,
                                   n_flow, rows_a, rows_b);
  return launch_fwd<false, false>(n_blocks, block, need, s, desc, desc_len, tab, tab_len,
                                  weights, n_wpad, latents, x, jac, stage, nullptr, 0, 0, n,
                                  n_flow, rows_a, rows_b);
}

// stage, jac [n], jbar [n], xbar0 [n, n_flow] -> grad_partial [n_blocks,
// n_weights] (summed over blocks by the caller) and wbar [n, n_flow], in
// blocks of `block` threads (a multiple of 32, at most BWD_MAX_BLOCK), with
// the weights in shared memory if w_smem is non-zero.  n_ops is the plan's
// op count, h_rows / g_rows the rows of the H and G tiles it needs, and smem
// the block's bytes as the wrapper computed them
// (pwquad_train.train_bwd_smem_bytes); a mismatch is refused.  With ws
// non-null the per-thread arrays live in ws, ws_len floats, laid out for
// ws_sizes = (acts, hidden, width, bins) (pwquad_train.train_bwd_workspace);
// a workspace smaller than the grid needs is refused, and so is a null ws
// for n_flow beyond the local arrays.
int nf_pwquad_train_bwd(const int* desc, int desc_len, const float* weights,
                        int n_weights, const float* stage, const float* jac,
                        const float* jbar, const float* xbar0, float* grad_partial,
                        float* wbar, long long n, int n_blocks, int block, int w_smem,
                        int n_ops, int h_rows, int g_rows, long long smem, float* ws,
                        long long ws_len, int n_flow, const int* ws_sizes, void* stream) {
  if (n <= 0) return 0;
  const size_t need = sizeof(float) * ((w_smem ? (size_t)n_weights : 0)
                                       + (size_t)desc_len + (size_t)n_ops + 1
                                       + (size_t)(h_rows + g_rows) * (block + 1)
                                       + 4 * (size_t)block);
  if ((size_t)smem != need || h_rows < 1 || g_rows < 1 || block % 32 || block < 32
      || block > BWD_MAX_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (ws != nullptr) {
    const BwdLayout o = {n_flow, ws_sizes[0], ws_sizes[1], ws_sizes[2], ws_sizes[3]};
    const long long per_thread = bwd_slice_floats(o);
    if (ws_sizes[0] < 1 || ws_sizes[1] < 1 || ws_sizes[2] < 1 || ws_sizes[3] < 0
        || ws_len < per_thread * n_blocks * block)
      return (int)cudaErrorInvalidValue;
  } else if (n_flow > MAX_FLOW) {  // the local arrays' sizes; the wrapper checks the rest
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int none[4] = {0, 0, 0, 0};
  const int* sz = ws != nullptr ? ws_sizes : none;
  if (w_smem && ws)
    return launch_bwd<true, true>(n_blocks, block, need, s, desc, desc_len, weights, n_weights,
                                  stage, jac, jbar, xbar0, grad_partial, wbar, n, n_ops,
                                  h_rows, g_rows, ws, sz);
  if (ws)
    return launch_bwd<false, true>(n_blocks, block, need, s, desc, desc_len, weights,
                                   n_weights, stage, jac, jbar, xbar0, grad_partial, wbar, n,
                                   n_ops, h_rows, g_rows, ws, sz);
  if (w_smem)
    return launch_bwd<true, false>(n_blocks, block, need, s, desc, desc_len, weights,
                                   n_weights, stage, jac, jbar, xbar0, grad_partial, wbar, n,
                                   n_ops, h_rows, g_rows, nullptr, sz);
  return launch_bwd<false, false>(n_blocks, block, need, s, desc, desc_len, weights, n_weights,
                                  stage, jac, jbar, xbar0, grad_partial, wbar, n, n_ops,
                                  h_rows, g_rows, nullptr, sz);
}

}  // extern "C"
