// The flow plan as the kernels walk it, and the forward of one cell.
//
// Shared by pwquad_sampler.cu (eval-mode sampler) and pwquad_train.cu
// (training forward and backward).  The plan is an int32 descriptor built by
// nf_tpu_torch/ops/pwquad_sampler.py::plan_descriptor,
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
// apply_cell keeps each transform's maths inline.  Written as calls to
// per-dimension helpers that return a struct (as the backward's recomputes in
// pwquad_train.cu are), the sampler took 16.5 ms instead of 12.1 ms per 2^21
// samples on the 10-D rank-4 flagship (ptxas: 40 registers with spills
// instead of 48 without; NVIDIA H100 80GB HBM3, 700 W).
//
// Precision: expf / sqrtf / atanf and IEEE division; nothing here may be
// built with --use_fast_math, since reduced-precision maths diverges through
// trained sharp CDFs.

#pragma once

#include <cuda_runtime.h>

#define MAX_FLOW 32
#define MAX_HIDDEN 64
#define MAX_BINS 32

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
__device__ __forceinline__ float last_logit(const float* __restrict__ W,
                                            const int* L, const float* h,
                                            int j) {
  const int fan_in = L[0], fan_out = L[1];
  const float* w = W + L[3];
  float acc = W[L[4] + j];
  for (int k = 0; k < fan_in; ++k) acc = fmaf(h[k], w[k * fan_out + j], acc);
  return acc;
}

// x_new[d] = x[src[d]] for the permutation op whose sources start at src.
__device__ __forceinline__ void apply_perm(const int* src, float* xs, int n_flow) {
  float tmp[MAX_FLOW];
  for (int d = 0; d < n_flow; ++d) tmp[d] = xs[src[d]];
  for (int d = 0; d < n_flow; ++d) xs[d] = tmp[d];
}

// Receives every pre-ReLU hidden activation of a cell, layer after layer;
// the sampler ignores them, the training forward sums them.
struct NoSink {
  __device__ __forceinline__ void operator()(float) {}
};

// Applies the cell whose descriptor starts at D[p] to xs; returns the index
// just past it.
template <class Sink>
__device__ int apply_cell(const int* D, int p, const float* __restrict__ W,
                          float* xs, float& jac, int n_flow, Sink& sink) {
  const int kind = D[p + 1], pt = D[p + 2], nb = D[p + 3], act = D[p + 4];
  const int n_layers = D[p + 5];
  const int* L = D + p + 6;
  float ha[MAX_HIDDEN], hb[MAX_HIDDEN];
  float* h = ha;
  float* o = hb;
  for (int k = 0; k < pt; ++k) h[k] = xs[k];
  // every layer but the last, in full
  for (int l = 0; l < n_layers - 1; ++l, L += 5) {
    const int fan_in = L[0], fan_out = L[1], relu = L[2];
    const float* w = W + L[3];
    const float* b = W + L[4];
    for (int j = 0; j < fan_out; ++j) {
      float acc = b[j];
      for (int k = 0; k < fan_in; ++k) acc = fmaf(h[k], w[k * fan_out + j], acc);
      if (relu) {
        sink(acc);
        acc = fmaxf(acc, 0.0f);
      }
      o[j] = acc;
    }
    float* tmp = h;
    h = o;
    o = tmp;
  }
  // L now points at the last layer, streamed per transformed dimension.
  // The transform maths below have a twin in pwquad_train.cu (pwquad_dim,
  // pwlin_dim, affine_dim: the backward's recompute), so an edit to either,
  // the bin selection or the clamp above all, is made in both.  They are
  // written out inline here because helpers returning structs cost the
  // sampler 37% on the flagship (PERF.md).  The kernel-vs-plain checks of
  // both kernels, against the same plain version, keep the two in step.
  const int t = n_flow - pt;
  if (kind == KIND_AFFINE) {
    for (int ti = 0; ti < t; ++ti) {
      const float s0 = expf(last_logit(W, L, h, ti));
      const float s1 = fmaxf(last_logit(W, L, h, t + ti), 0.0f);
      const float u = xs[pt + ti] * (20.0f * s0) + s1;
      const float diff = 1.0f / (u * u + 1.0f);
      xs[pt + ti] = atanf(u) / 1.57079632679489662f;
      jac *= (20.0f * s0) * diff;
    }
    jac *= TWO_OVER_PI;  // 2/pi once per cell (reference quirk)
  } else if (kind == KIND_PWQUAD) {
    const int width = 2 * nb + 1;
    float z[2 * MAX_BINS + 1];
    for (int ti = 0; ti < t; ++ti) {
      for (int j = 0; j < width; ++j) z[j] = last_logit(W, L, h, ti * width + j);
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
      const float xB = fminf(xs[pt + ti], CLAMP_HI);
      // the bin: the last k whose left edge is <= xB (the last bin's upper
      // bound is open)
      float edge = 0.0f, vw = 0.0f;
      float w_b = wd[0], edge_b = 0.0f, vw_b = 0.0f, v_lo = v[0], v_hi = v[1];
      for (int k = 0; k < nb; ++k) {
        const bool in = xB >= edge;
        w_b = in ? wd[k] : w_b;
        edge_b = in ? edge : edge_b;
        vw_b = in ? vw : vw_b;
        v_lo = in ? v[k] : v_lo;
        v_hi = in ? v[k + 1] : v_hi;
        vw += (v[k] + v[k + 1]) * 0.5f * wd[k];
        edge += wd[k];
      }
      const float alpha = (xB - edge_b) / w_b;
      xs[pt + ti] = 0.5f * alpha * alpha * (v_hi - v_lo) * w_b + alpha * v_lo * w_b + vw_b;
      jac *= v_lo + (v_hi - v_lo) * alpha;
    }
  } else {  // KIND_PWLIN
    float q[MAX_BINS];
    for (int ti = 0; ti < t; ++ti) {
      float qtot = 0.0f;
      for (int k = 0; k < nb; ++k) {
        q[k] = positivity(last_logit(W, L, h, ti * nb + k), act);
        qtot += q[k];
      }
      const float a = xs[pt + ti] * (float)nb;
      // clamp the bin before alpha: x == 1.0 maps to the right edge
      int bin = (int)floorf(a);
      bin = bin < 0 ? 0 : (bin > nb - 1 ? nb - 1 : bin);
      float below = 0.0f;
      for (int k = 0; k < bin; ++k) below += q[k];
      const float pdf = q[bin] / (qtot / (float)nb);
      xs[pt + ti] = pdf * ((a - (float)bin) / (float)nb) + below / qtot;
      jac *= pdf;
    }
  }
  return p + 6 + 5 * n_layers;
}
