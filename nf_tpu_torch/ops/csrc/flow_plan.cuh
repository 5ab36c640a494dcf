// The flow plan as the kernels walk it, and the maths all three kernels
// share: the forward of one conditioner layer over a shared-memory tile, and
// the forward of one transformed dimension.
//
// The plan is shared by pwquad_sampler.cu (eval-mode sampler) and
// pwquad_train.cu (training forward and backward).  It is an int32
// descriptor built by nf_tpu_torch/ops/pwquad_sampler.py::plan_descriptor,
//
//   desc = [n_flow, n_ops, op...]
//   op   = [OP_PERM, src_0 .. src_{n_flow-1}]                 x_new[d] = x[src_d]
//        | [OP_CELL, kind, pass_through, n_bins, act, n_layers,
//           (fan_in, fan_out, relu, w_offset, b_offset) * n_layers]
//
// with offsets in floats into one flat f32 buffer of folded weights (W
// row-major [fan_in, fan_out], then b).  The training kernels use the same
// offsets as rows of their weight gradient.
//
// The sampler and the training forward walk the plan through a row table
// (pwquad_sampler.py::op_table): [n_cells, each cell op's position in the
// descriptor, then for each cell op and once more for the end of the flow
// the X row of each of the n_flow logical dimensions].  Their permutations
// move no data: each one only changes which row holds which dimension.
//
// One copy of the transform maths serves the three kernels: pwquad_dim,
// pwlin_dim and affine_dim (a dimension's bin, pdf and the quantities its
// VJP reads), and apply_dim (its output), so bins and pdfs agree across the
// sampler, the training forward and the backward's recompute.  On an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6) the three kernels kept
// their output bits when they moved onto these helpers, and the sampler on
// its shared-memory tiles reads 5.25 ms per 2^21 flagship samples, where the
// per-thread sampler with its own copy of this maths read 12.08 ms.  The
// block products in register tiles (tile_dense) serve the tiled backward
// and the tiled sampler: on the 2 -> 4 plan the sampler's products went from
// four L1 loads and one shared-memory load per four FMAs (dense, weights
// through L1) to two shared-memory float4 loads per 16, 111.1-111.7 ->
// 36.1 ms per 2^21, with the same bits.
//
// Precision: expf / sqrtf / atanf and IEEE division; nothing here may be
// built with --use_fast_math, since reduced-precision maths diverges through
// trained sharp CDFs.

#pragma once

#include <cuda_runtime.h>

#define OP_PERM 0
#define OP_CELL 1
#define KIND_PWQUAD 0
#define KIND_PWLIN 1
#define KIND_AFFINE 2
#define ACT_EXP 0

#define CLAMP_HI (1.0f - 1e-6f)  // pwquad stability clamp (reference coupling_cells.py:167)
#define TWO_OVER_PI 0.636619772367581343f

__device__ __forceinline__ float positivity(float z, int act) {
  return act == ACT_EXP ? expf(z) : 0.5f * (z + sqrtf(z * z + 4.0f));
}

// One output of the last (linear) layer: b[j] + sum_k h[k] W[k, j].
template <class H>
__device__ __forceinline__ float last_logit(const float* __restrict__ W, const int* L, H h,
                                            int j) {
  const int fan_in = L[0], fan_out = L[1];
  const float* w = W + L[3];
  float acc = W[L[4] + j];
  for (int k = 0; k < fan_in; ++k) acc = fmaf(h[k], w[k * fan_out + j], acc);
  return acc;
}

// Column of a feature-major array: element k is k strides down.  With an
// int stride, a column of a shared-memory tile (rows of blockDim.x + 1
// floats, or + 4 in the tiled kernels); with a long long stride, a
// thread's slice of a device workspace (element k of grid thread g at
// k * G + g).
template <class I>
struct Col {
  float* p;
  I stride;
  __device__ __forceinline__ float& operator[](int k) const { return p[k * stride]; }
  __device__ __forceinline__ Col operator+(int k) const { return {p + k * stride, stride}; }
};
using TileCol = Col<int>;
using WsCol = Col<long long>;

// ---------------------------------------------------------------------------
// The forward of one transformed dimension, with the quantities its VJP
// reads.  Z is the logits' accessor: a local array (float*), a column of a
// shared-memory tile (TileCol) or of a workspace (WsCol).
// ---------------------------------------------------------------------------

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

// The output of one transformed dimension of a cell of `kind` from its
// logits z (replaced in place, as pwquad_dim says); multiplies jac by its
// pdf (affine: without the 2/pi the cell applies once).
template <class Z>
__device__ __forceinline__ float apply_dim(int kind, Z z, int nb, int act, float x_raw,
                                           float& jac) {
  if (kind == KIND_PWQUAD) {
    const PwquadDim q = pwquad_dim(z, nb, act, x_raw);
    jac *= q.p;
    return 0.5f * q.a * q.a * (q.v_hi - q.v_lo) * q.w_b + q.a * q.v_lo * q.w_b + q.vw_b;
  }
  if (kind == KIND_PWLIN) {
    for (int k = 0; k < nb; ++k) z[k] = positivity(z[k], act);
    const PwlinDim r = pwlin_dim(z, nb, x_raw);
    float below = 0.0f;
    for (int k = 0; k < r.bin; ++k) below += z[k];
    jac *= r.p;
    return r.p * r.alpha + below / r.qtot;
  }
  const AffineDim q = affine_dim(z[0], z[1], x_raw);
  jac *= q.p;
  return atanf(q.u) / 1.57079632679489662f;
}

// The logits of one transformed dimension: 2 n_bins + 1 for pwquad, n_bins
// for pwlin, (scale, shift) for affine.
__device__ __forceinline__ int logit_width(int kind, int nb) {
  return kind == KIND_PWQUAD ? 2 * nb + 1 : (kind == KIND_PWLIN ? nb : 2);
}

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// ---------------------------------------------------------------------------
// A tile of blockDim.x samples, for the sampler and the training forward.
// Thread t owns sample t of the tile and column t of every tile in shared
// memory (rows S1 = blockDim.x + 1 floats apart: odd, so that a warp's
// accesses to one row, or to rows of its own columns, fall in distinct
// banks).  X holds the state, n_flow rows; A and B the conditioner's
// ping-pong layers, B also one transformed dimension's logits.
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
// output is summed as the backward's recompute sums it (bias first, then k
// ascending, fmaf), so bins and ReLU masks are its own.  Input row k is X's
// row xmap[k] where MAPPED, else in's row k, through a ReLU where RELU_IN
// (the stats variant keeps pre-ReLU values in the tiles).  Row k of w starts
// k * ld floats in, and output j sits j * step floats along it (step 1 in
// the padded copy).
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

// ---------------------------------------------------------------------------
// Block products in register tiles, for the tiled sampler and the tiled
// backward, and the padded copies of the weights they read.  Their tiles
// are feature-major, a row of S floats per feature (S a multiple of four,
// so four samples of a row are one float4), and a thread's task is four
// rows by four samples: one float4 of a tile and four weights feed 16
// FMAs.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c[i][e] = fmaf(a[i], b[e], c[i][e])
__device__ __forceinline__ void outer4(float (&c)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = fmaf(av[i], bv[e], c[i][e]);
}

// out[r][s] = b[r] + sum_k in[k][s] w[k ld + r step] for r < n_out and the
// tile's samples, through a ReLU where relu: bias first, k ascending, as
// the forward sums it.  With W_SMEM, w is a copy padded to rows of ld, a
// multiple of four, and step is 1.  A task is four rows by four samples.
// Input row k is in's row xmap[k] where MAPPED (the sampler's first layer
// reads the state tile through its row table).
template <bool W_SMEM, bool MAPPED = false>
__device__ __forceinline__ void tile_dense(const float* __restrict__ w,
                                           const float* __restrict__ b, int ld, int step,
                                           int fan_in, int n_out, const float* in, float* out,
                                           int S, bool relu, const int* xmap = nullptr) {
  const int B = blockDim.x, SG = B >> 2;
  const int n_tasks = ((n_out + 3) >> 2) * SG;
  for (int task = threadIdx.x; task < n_tasks; task += B) {
    const int rg = task / SG, r0 = rg << 2, s0 = (task - rg * SG) << 2;
    const int left = n_out - r0;
    const int j1 = min(1, left - 1) * step, j2 = min(2, left - 1) * step;
    const int j3 = min(3, left - 1) * step;
    const float4 bias = load4<W_SMEM>(b + r0 * step, j1, j2, j3);
    const float bv[4] = {bias.x, bias.y, bias.z, bias.w};
    float a[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[c][e] = bv[c];
    const float* wr = w + r0 * step;
#pragma unroll 2
    for (int k = 0; k < fan_in; ++k)
      outer4(a, load4<W_SMEM>(wr + k * ld, j1, j2, j3),
             ld4(in + (MAPPED ? xmap[k] : k) * S + s0));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < left) {
        float4 o = make_float4(a[c][0], a[c][1], a[c][2], a[c][3]);
        if (relu)
          o = make_float4(fmaxf(o.x, 0.0f), fmaxf(o.y, 0.0f), fmaxf(o.z, 0.0f), fmaxf(o.w, 0.0f));
        *reinterpret_cast<float4*>(out + (r0 + c) * S + s0) = o;
      }
    }
  }
}

// A padded copy of n_rows rows of ld floats into dst: row r < n_rows - 1 is
// the flat weights' row at w_off + r * fan_out, the last row the bias at
// b_off; column j < width is the flat layer's column col0 + j * step, the
// rest 0.  Every thread of the block calls it; a barrier must follow.
__device__ __forceinline__ void copy_layer(float* dst, const float* __restrict__ weights,
                                           int n_rows, int ld, int width, int w_off, int b_off,
                                           int fan_out, int col0, int step) {
  for (int e = threadIdx.x; e < n_rows * ld; e += blockDim.x) {
    const int r = e / ld, j = e - r * ld;
    dst[e] = j < width ? __ldg(weights + (r < n_rows - 1 ? w_off + r * fan_out : b_off) + col0
                               + j * step)
                       : 0.0f;
  }
}

// The last layer of a cell (L: its descriptor entry) and the cell's
// transform, one transformed dimension ti at a time: that dimension's
// logits into this thread's column of B (Bc), then its output written over
// its input, X's row m[pt + ti] (Xc: this thread's column of X); jac takes
// the cell's pdfs.  The layer's input is h, as dense_from reads it.  With
// W_SMEM the weights are the layer's padded copy at w_pad; otherwise the
// flat buffer's columns of each dimension: a contiguous run, or (ti, t +
// ti) for affine.  Returns the floats of the padded copy the layer took.
template <bool W_SMEM>
__device__ __forceinline__ int last_layer(const int* L, int kind, int pt, int nb, int act,
                                          int n_flow, bool mapped, bool relu_in,
                                          const float* h, const int* m, float* Xc, float* Bc,
                                          int S1, const float* __restrict__ w_pad,
                                          const float* __restrict__ weights, float& jac) {
  const int fin = L[0], fout = L[1];
  const int t_dims = n_flow - pt, width = logit_width(kind, nb);
  const int ld = t_dims * round4(width);
  for (int ti = 0; ti < t_dims; ++ti) {
    if (W_SMEM) {
      const float* w = w_pad + ti * round4(width);
      dense_from<true>(mapped, relu_in, w, w + fin * ld, ld, 1, fin, width, h, m, Bc, S1,
                       false);
    } else {
      const int col0 = kind == KIND_AFFINE ? ti : ti * width;
      dense_from<false>(mapped, relu_in, weights + L[3] + col0, weights + L[4] + col0, fout,
                        kind == KIND_AFFINE ? t_dims : 1, fin, width, h, m, Bc, S1, false);
    }
    float* xo = Xc + m[pt + ti] * S1;
    *xo = apply_dim(kind, TileCol{Bc, S1}, nb, act, *xo, jac);
  }
  if (kind == KIND_AFFINE) jac *= TWO_OVER_PI;  // 2/pi once per cell (reference quirk)
  return (fin + 1) * ld;
}

// The table, the tiles and the padded weights against the plan, by thread 0
// before the walk: false where the table does not fit the descriptor, a
// hidden layer's output does not fit its tile (the last hidden layer writes
// A, the one before it B, and so on back) or the logits do not fit B.
// *wq counts the padded copy's floats, *stat_rows the statistics rows (2
// per xA column, 2 per ReLU unit), *max_rows the most of those rows one
// block sum takes (a cell's xA columns, or one ReLU layer's units).
__device__ __forceinline__ bool tiles_fit(const int* D, int desc_len, int tab_len,
                                          const int* cell_pos, int n_cells, int n_flow,
                                          int rows_a, int rows_b, int* wq, int* stat_rows,
                                          int* max_rows) {
  bool bad = D[0] != n_flow || tab_len != 1 + n_cells + (n_cells + 1) * n_flow;
  *wq = *stat_rows = *max_rows = 0;
  for (int c = 0; c < n_cells && !bad; ++c) {
    const int p = cell_pos[c];
    if (p < 2 || p + 6 > desc_len || D[p] != OP_CELL) return false;
    const int pt = D[p + 2], n_layers = D[p + 5];
    const int width = logit_width(D[p + 1], D[p + 3]);
    *stat_rows += 2 * pt;
    *max_rows = max(*max_rows, pt);
    for (int l = 0; l < n_layers; ++l) {
      const int* L = D + p + 6 + 5 * l;
      if (l < n_layers - 1) {
        bad |= L[1] > (((n_layers - 2 - l) & 1) ? rows_b : rows_a);
        *wq += (L[0] + 1) * round4(L[1]);
        *stat_rows += L[2] ? 2 * L[1] : 0;
        *max_rows = max(*max_rows, L[2] ? L[1] : 0);
      } else {
        bad |= width > rows_b;
        *wq += (L[0] + 1) * (n_flow - pt) * round4(width);
      }
    }
  }
  return !bad;
}

// The padded copy of the weights in shared memory, layer after layer in the
// table's cell order: every row of a layer (its bias too) padded to a
// multiple of four floats, the last layer's per transformed dimension, so
// each dimension's logits start on a float4.  Every thread of the block
// calls it; a barrier must follow before the copy is read.
__device__ __forceinline__ void copy_padded_weights(const int* D, const int* cell_pos,
                                                    int n_cells, int n_flow,
                                                    const float* __restrict__ weights,
                                                    float* W_s) {
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
      for (int e = threadIdx.x; e < (fan_in + 1) * ld; e += blockDim.x) {
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

// The tile's nv samples of a [n, n_flow] array starting at src, one
// contiguous run, into X's rows (a lane past n: 0.5); float4 loads where
// io4 (src 16-byte aligned) and the tile is whole.  Every thread of the
// block calls it between two barriers.
__device__ __forceinline__ void load_tile(float* X, const float* __restrict__ src, int nv,
                                          int n_flow, int S1, bool io4) {
  const int S = blockDim.x, t = threadIdx.x;
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
}

// The tile's nv samples, logical dimension d from X's row map_end[d], into
// a [n, n_flow] array at dst, one contiguous run; float4 stores where io4.
// Every thread of the block calls it after a barrier.
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* X,
                                           const int* map_end, int nv, int n_flow, int S1,
                                           bool io4) {
  const int S = blockDim.x, t = threadIdx.x;
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
