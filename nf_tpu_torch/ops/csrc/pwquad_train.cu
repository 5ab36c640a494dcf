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
// Forward, per sample: walk the plan as the sampler does, write every cell's
// input into `stage` [n_cells, n_flow, n] (the only residual the backward
// reads), then x [n, n_flow] and the Jacobian.  The stats variant sums, over
// the valid samples, y and y^2 of every xA column and every pre-ReLU folded
// activation: rows cell-major, 2 per xA column, then 2 per hidden unit,
// layer after layer (the layout stats_to_bn_state reads).
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
// Accumulation across samples, without float atomics.  The statistics: a
// block's threads run a block-uniform grid-stride loop (a lane past n
// computes on dummy inputs and contributes zero), each value is summed over
// the warp with shuffles in a fixed order, lane 0 adds it into its warp's
// slice of shared memory, and each block writes the sum of its warps' slices
// to row `block` of a [n_blocks, rows] scratch.  The weight gradient, one
// layer at a time, as a block product (block_dw): every thread stages its
// sample's layer input and output cotangent in shared-memory tiles, and
// after a barrier the block adds H^T G over its samples into one
// accumulator of n_weights floats, each entry summed by one thread in a
// fixed order; each block writes its accumulator to its row of the scratch.
// The wrapper sums the scratch over blocks.  The grid depends on n alone (and
// the backward's on the plan's launch configuration), so two launches on the
// same inputs give bit-identical gradients and statistics.  Statistics
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
// 512 with the weights in shared memory).  The forward: local memory.  The
// per-thread arrays are indexed at run time and live in local memory, as in
// the sampler, and compete for L1 with the shared memory the resident blocks
// take; on the flagship the variant without stats, which fits more blocks
// per SM, is the slower one.  The levers for later work: per-plan
// specialisation to keep the per-thread arrays in registers, and an
// occupancy chosen per plan for the forward.

#include "flow_plan.cuh"

#define TRAIN_BLOCK 128
#define TRAIN_WARPS (TRAIN_BLOCK / 32)
#define TRAIN_MAX_BLOCKS 1024
#define MAX_ACTS 256  // inputs of all of a cell's layers, per thread
#define MAX_OPS 256

// Sum over the warp; lane 0 holds the result.  Every lane must call it.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float positivity_grad(float z, int act) {
  return act == ACT_EXP ? expf(z) : 0.5f * (1.0f + z / sqrtf(z * z + 4.0f));
}

// (sum y, sum y^2) of each value it is given, over the valid samples of the
// warp, into consecutive row pairs of the warp's double accumulator.
struct StatSink {
  double* acc;
  int row, lane;
  bool valid;
  __device__ StatSink(double* a, int l, bool v) : acc(a), row(0), lane(l), valid(v) {}
  __device__ __forceinline__ void operator()(float y) {
    const float v = valid ? y : 0.0f;
    const float s = warp_sum(v), sq = warp_sum(v * v);
    if (lane == 0) {
      acc[row] += (double)s;
      acc[row + 1] += (double)sq;
    }
    row += 2;
  }
};

// Sampler-style forward that also fills `stage` and, with STATS, the
// per-block statistics.
template <bool STATS>
__global__ void __launch_bounds__(TRAIN_BLOCK)
train_fwd_kernel(const int* __restrict__ desc, int desc_len,
                 const float* __restrict__ weights, int n_weights,
                 const float* __restrict__ latents, float* __restrict__ x_out,
                 float* __restrict__ jac_out, float* __restrict__ stage,
                 double* __restrict__ stats_partial, int n_stat_rows, long long n) {
  extern __shared__ double smem_d[];
  const int n_acc = STATS ? TRAIN_WARPS * n_stat_rows : 0;
  double* acc = smem_d;
  float* W = reinterpret_cast<float*>(smem_d + n_acc);
  int* D = reinterpret_cast<int*>(W + n_weights);
  for (int i = threadIdx.x; i < n_weights; i += blockDim.x) W[i] = weights[i];
  for (int i = threadIdx.x; i < desc_len; i += blockDim.x) D[i] = desc[i];
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_flow = D[0], n_ops = D[1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    float xs[MAX_FLOW];
    for (int d = 0; d < n_flow; ++d) xs[d] = valid ? latents[i * n_flow + d] : 0.5f;
    float jac = 1.0f;
    StatSink stats(acc + warp * n_stat_rows, lane, valid);
    NoSink no_sink;
    int p = 2, cell = 0;
    for (int op = 0; op < n_ops; ++op) {
      if (D[p] == OP_PERM) {
        apply_perm(D + p + 1, xs, n_flow);
        p += 1 + n_flow;
        continue;
      }
      if (valid) {
        for (int d = 0; d < n_flow; ++d)
          stage[((long long)cell * n_flow + d) * n + i] = xs[d];
      }
      if (STATS) {
        for (int k = 0; k < D[p + 2]; ++k) stats(xs[k]);  // the xA columns
        p = apply_cell(D, p, W, xs, jac, n_flow, stats);
      } else {
        p = apply_cell(D, p, W, xs, jac, n_flow, no_sink);
      }
      ++cell;
    }
    if (valid) {
      for (int d = 0; d < n_flow; ++d) x_out[i * n_flow + d] = xs[d];
      jac_out[i] = jac;
    }
  }
  if (STATS) {
    __syncthreads();
    for (int r = threadIdx.x; r < n_stat_rows; r += blockDim.x) {
      double s = 0.0;
      for (int w = 0; w < TRAIN_WARPS; ++w) s += acc[w * n_stat_rows + r];
      stats_partial[(long long)blockIdx.x * n_stat_rows + r] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// The forward of one transformed dimension, with the quantities its VJP
// reads: the operations of flow_plan.cuh's apply_cell, in the same order, so
// bins and pdfs are the forward's own.  These are the twins of apply_cell's
// inline transform maths, so an edit to either, the bin selection or the
// clamp above all, is made in both; the kernel-vs-plain checks of both
// kernels keep the two in step.
// ---------------------------------------------------------------------------

// One pwquad dimension.  z holds n_bins + 1 vertex logits, then n_bins width
// logits; they are replaced in place by the normalised heights v and widths u.
struct PwquadDim {
  float p;            // pdf
  float a, w_b;       // position inside the bin, width of the bin
  float v_lo, v_hi;   // normalised heights at the bin's edges
  float wtot, vnorm;  // the two normalisers: sum of widths, trapezoid area
  int bin;
};

__device__ __forceinline__ PwquadDim pwquad_dim(float* z, int nb, int act,
                                                float x_raw) {
  float* v = z;            // nb + 1 vertex heights
  float* wd = z + nb + 1;  // nb bin widths
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
  float edge = 0.0f, w_b = wd[0], edge_b = 0.0f, v_lo = v[0], v_hi = v[1];
  int bin = 0;
  for (int k = 0; k < nb; ++k) {
    const bool in = xB >= edge;
    bin = in ? k : bin;
    w_b = in ? wd[k] : w_b;
    edge_b = in ? edge : edge_b;
    v_lo = in ? v[k] : v_lo;
    v_hi = in ? v[k + 1] : v_hi;
    edge += wd[k];
  }
  PwquadDim q;
  q.a = (xB - edge_b) / w_b;
  q.p = v_lo + (v_hi - v_lo) * q.a;
  q.w_b = w_b;
  q.v_lo = v_lo;
  q.v_hi = v_hi;
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

__device__ __forceinline__ PwlinDim pwlin_dim(const float* q, int nb, float x) {
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
  const int width = kind == KIND_PWQUAD ? 2 * nb + 1 : (kind == KIND_PWLIN ? nb : 2);
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
      const int width = kind == KIND_PWQUAD ? 2 * nb + 1 : (kind == KIND_PWLIN ? nb : 2);
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

extern "C" {

// The compiled caps and launch shape, so the wrapper can check its copy.
int nf_pwquad_train_limits(int* out) {
  out[0] = MAX_FLOW;
  out[1] = MAX_HIDDEN;
  out[2] = MAX_BINS;
  out[3] = MAX_ACTS;
  out[4] = MAX_OPS;
  out[5] = TRAIN_BLOCK;
  out[6] = TRAIN_MAX_BLOCKS;
  out[7] = BWD_MAX_BLOCK;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// latents [n, n_flow] f32 -> x [n, n_flow], jac [n], stage [n_cells, n_flow, n];
// with stats_partial non-null, also the [n_blocks, n_stat_rows] double sums.
int nf_pwquad_train_fwd(const int* desc, int desc_len, const float* weights,
                        int n_weights, const float* latents, float* x, float* jac,
                        float* stage, double* stats_partial, int n_stat_rows,
                        long long n, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  const bool stats = stats_partial != nullptr;
  const size_t smem = sizeof(double) * (stats ? (size_t)TRAIN_WARPS * n_stat_rows : 0)
                      + sizeof(float) * ((size_t)n_weights + (size_t)desc_len);
  int e;
  if (stats) {
    e = set_smem((const void*)train_fwd_kernel<true>, smem);
    if (e) return e;
    train_fwd_kernel<true><<<n_blocks, TRAIN_BLOCK, smem, (cudaStream_t)stream>>>(
        desc, desc_len, weights, n_weights, latents, x, jac, stage, stats_partial,
        n_stat_rows, n);
  } else {
    e = set_smem((const void*)train_fwd_kernel<false>, smem);
    if (e) return e;
    train_fwd_kernel<false><<<n_blocks, TRAIN_BLOCK, smem, (cudaStream_t)stream>>>(
        desc, desc_len, weights, n_weights, latents, x, jac, stage, nullptr, 0, n);
  }
  return (int)cudaGetLastError();
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
