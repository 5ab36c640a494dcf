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
// VJP (pbar = jbar * jac / p), its rows of dW and db, and its share of the
// last hidden layer's cotangent.  The whole last-layer cotangent (85 wide on
// the 10-D flagship) is never held.  Then the hidden layers backward, with
// their ReLU masks.
//
// Accumulation across samples, without float atomics: a block's threads run
// a block-uniform grid-stride loop (a lane past n computes on dummy inputs
// and contributes zero), so every lane of a warp reaches each reduction.
// Each contribution is summed over the warp with shuffles in a fixed order,
// lane 0 adds it into its warp's slice of shared memory, and at the end each
// block writes the sum of its warps' slices, in warp order, to row `block` of
// a [n_blocks, rows] scratch.  The wrapper sums that scratch over blocks.
// The grid depends on n alone, so two launches on the same inputs give
// bit-identical gradients and statistics.  Statistics accumulate in double
// (E[y^2] - E[y]^2 at a batch of 2^20 would lose digits in f32); weight
// gradients in f32, which the trainer averages and Adamax normalises.
//
// What bounds it on an H100.  The backward: instruction issue and latency.
// Its dW rows cost one five-step warp reduction each per 32 samples, which
// is about as much work as the per-thread recompute and backward of the MLP.
// The per-warp dW slices and the weights take shared memory (5 * P floats
// for P folded weights: ~140 KB on the 10-D flagship), so the flagship's
// backward runs one block of four warps per SM and hides little latency.
// The forward: local memory.  The per-thread arrays are indexed at run time
// and live in local memory, as in the sampler, and compete for L1 with the
// shared memory the resident blocks take; on the flagship the variant
// without stats, which fits more blocks per SM, is the slower one.  The
// levers for later work: a per-block dW product over staged activations
// instead of per-entry shuffles, weights read through L1 to free shared
// memory for more warps, an occupancy chosen per plan, and per-plan
// specialisation to keep the arrays in registers.

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

// Adds v, summed over the warp's valid lanes, to row `row` of the warp's
// gradient slice.  Every lane must call it.
__device__ __forceinline__ void accumulate(float* acc, int row, float v, int lane,
                                           bool valid) {
  const float s = warp_sum(valid ? v : 0.0f);
  if (lane == 0) acc[row] += s;
}

// Backward through the cell whose descriptor starts at D[p]: xin is the
// cell's input (from `stage`), xbar the cotangent of its output, replaced by
// that of its input.
__device__ void cell_vjp(const int* D, int p, const float* __restrict__ W,
                         const float* xin, float* xbar, float jj, float* acc,
                         int lane, bool valid, int n_flow) {
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

  // the last layer, one transformed dimension at a time
  const float* h = acts + off;
  const int fin = L[0], fout = L[1];
  const float* wl = W + L[3];
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
      accumulate(acc, L[4] + col, gk, lane, valid);
      for (int i = 0; i < fin; ++i) {
        accumulate(acc, L[3] + i * fout + col, h[i] * gk, lane, valid);
        r[i] = fmaf(wl[i * fout + col], gk, r[i]);
      }
    }
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
      accumulate(acc, L[4] + o, r[o], lane, valid);
    }
    for (int i = 0; i < fan_in; ++i) {
      float s = 0.0f;
      for (int o = 0; o < fan_out; ++o) {
        accumulate(acc, L[3] + i * fan_out + o, h_in[i] * r[o], lane, valid);
        s = fmaf(w[i * fan_out + o], r[o], s);
      }
      r_in[i] = s;
    }
    float* tmp = r;
    r = r_in;
    r_in = tmp;
  }
  // the pass-through dims: their own cotangent plus the conditioner's
  for (int k = 0; k < pt; ++k) xbar[k] += r[k];
}

__global__ void __launch_bounds__(TRAIN_BLOCK)
train_bwd_kernel(const int* __restrict__ desc, int desc_len,
                 const float* __restrict__ weights, int n_weights,
                 const float* __restrict__ stage, const float* __restrict__ jac_in,
                 const float* __restrict__ jbar_in, const float* __restrict__ xbar0,
                 float* __restrict__ grad_partial, float* __restrict__ wbar, long long n) {
  extern __shared__ double smem_d[];
  float* acc = reinterpret_cast<float*>(smem_d);  // [TRAIN_WARPS][n_weights]
  float* W = acc + TRAIN_WARPS * n_weights;
  int* D = reinterpret_cast<int*>(W + n_weights);
  __shared__ int op_pos[MAX_OPS];
  __shared__ int n_cells;
  for (int i = threadIdx.x; i < n_weights; i += blockDim.x) W[i] = weights[i];
  for (int i = threadIdx.x; i < desc_len; i += blockDim.x) D[i] = desc[i];
  for (int i = threadIdx.x; i < TRAIN_WARPS * n_weights; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x == 0) {  // where each op starts, to walk them backwards
    int p = 2, nc = 0;
    for (int op = 0; op < D[1]; ++op) {
      op_pos[op] = p;
      if (D[p] == OP_PERM) {
        p += 1 + D[0];
      } else {
        p += 6 + 5 * D[p + 5];
        ++nc;
      }
    }
    n_cells = nc;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_flow = D[0], n_ops = D[1];
  float* acc_w = acc + warp * n_weights;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    float xbar[MAX_FLOW], xin[MAX_FLOW];
    for (int d = 0; d < n_flow; ++d) xbar[d] = valid ? xbar0[i * n_flow + d] : 0.0f;
    const float jj = valid ? jbar_in[i] * jac_in[i] : 0.0f;
    int cell = n_cells;
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
      cell_vjp(D, p, W, xin, xbar, jj, acc_w, lane, valid, n_flow);
    }
    if (valid) {
      for (int d = 0; d < n_flow; ++d) wbar[i * n_flow + d] = xbar[d];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_weights; r += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < TRAIN_WARPS; ++w) s += acc[w * n_weights + r];
    grad_partial[(long long)blockIdx.x * n_weights + r] = s;
  }
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
// n_weights] (summed over blocks by the caller) and wbar [n, n_flow].
int nf_pwquad_train_bwd(const int* desc, int desc_len, const float* weights,
                        int n_weights, const float* stage, const float* jac,
                        const float* jbar, const float* xbar0, float* grad_partial,
                        float* wbar, long long n, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)(TRAIN_WARPS + 1) * n_weights
                                       + (size_t)desc_len);
  const int e = set_smem((const void*)train_bwd_kernel, smem);
  if (e) return e;
  train_bwd_kernel<<<n_blocks, TRAIN_BLOCK, smem, (cudaStream_t)stream>>>(
      desc, desc_len, weights, n_weights, stage, jac, jbar, xbar0, grad_partial,
      wbar, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
