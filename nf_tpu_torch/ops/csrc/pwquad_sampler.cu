// Fused eval-mode sampler for coupling-cell flows (pwquad, pwlin, affine).
//
// Replaces the Pallas TPU kernel nf_tpu/ops/pwquad_sampler.py::build_sampler
// (body `kernel`).  Per sample it takes the latents -- read from an operand,
// or drawn here with Philox4x32-10 -- walks the flow plan (permutations and
// cells; per cell the BatchNorm-folded conditioner MLP, then the per-dimension
// transform) and writes x and the Jacobian product once.  The plain PyTorch
// version is nf_tpu_torch/flows/fast_eval.py::make_folded_forward; the plan,
// its row table and the launch are nf_tpu_torch/ops/pwquad_sampler.py's
// (SamplerPlan).  The tiles, the MLP layer and the transform maths are
// flow_plan.cuh's, shared with the training forward in pwquad_train.cu.
//
// Design.  Each block owns a tile of S samples at a time (a block-uniform
// grid-stride loop; a lane past n computes on 0.5 and writes nothing).  A
// sample's state lives in feature-major shared-memory tiles sized to the
// plan: X [n_flow] rows, and A and B for the conditioner's ping-pong layers,
// B also holding one transformed dimension's logits; each row is S + 1
// floats, so a warp's accesses fall in distinct banks.  Thread t owns column
// t of every tile, so the walk needs no barrier.  Each layer computes four
// outputs per activation load, their weights one broadcast float4 from a
// copy in shared memory padded to fours, or four loads through L1 where the
// launch leaves no room for it.  The permutations move no data: the row
// table gives each cell op the X row of each logical dimension, so the
// sampler takes any op order the descriptor holds.  Latents: the Philox
// draws go straight into the thread's X column (no barrier), or the operand
// comes in as one contiguous run of the tile.  Output: dim-major writes each
// logical dimension's row of the tile as one coalesced run (no barrier);
// batch-major writes the tile's [S, n_flow] block as one contiguous run.
// The launch (block size, the weights' place) is chosen per plan by
// pwquad_sampler.sampler_config, which counts the shared memory
// (sampler_smem_bytes); this entry point refuses a count that differs.
// Plans with a layer 32 wide or more run the tiled kernel below instead
// (pwquad_sampler_kernel_tiled, chosen by pwquad_sampler.sampler_kernel_for),
// whose products are block products in register tiles.
//
// Bits: each output is summed in the order of the backward's recompute
// (bias, then k ascending, fmaf) and the transforms are the training
// kernels' own (flow_plan.cuh), so x and jac equal the per-thread sampler's
// that this kernel replaced, bit for bit.  expf / sqrtf / atanf and IEEE
// division; no --use_fast_math.
//
// What bounds it on an H100: the issue of instructions, not memory.  The
// camel-2D model (2 cells, hidden 3x3x3, 4 bins) does ~330 FLOP, 18 expf and
// ~20 IEEE divisions a sample against 12 bytes written; the 10-D rank-4
// flagship ~16,400 FLOP against 44 bytes.  The per-thread sampler this
// kernel replaced kept ~1 KB of dynamically indexed arrays per thread in
// local memory, so every conditioner FMA also loaded its activation from
// there.  Here every activation, logit and state value is a conflict-free
// shared-memory access and one activation load feeds four FMAs; capped at
// 64 registers (__launch_bounds__(SAMPLER_MAX_BLOCK, 2)) an SM keeps up to
// 32 warps resident.  On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
// 6): the flagship in 5.25 ms of device time per 2^21 samples (the
// per-thread kernel: 12.08 ms), 10% of its FLOP bound; camel in 0.204 ms
// (0.204-0.208 ms): with an MLP of 3 x 3 units, tiles save few loads there.
// On wide plans the loads set the pace: the 2 -> 4 plan's last layer (32
// inputs by 65 logits, ~90% of its ~92.7k FMAs a sample) reads its ~400 KB
// of weights through L1, four scalar loads and one activation load for
// every four FMAs, at 64 registers: 111.7 ms per 2^21, 5.6% of its bound.
// The tiled kernel takes two shared-memory float4 loads per 16 FMAs there
// and runs it in 36.1 ms (3.1x), the ZZ/Z' plan in 5.84-5.88 ms per 2^20
// against 10.01-10.07, create_model(2, 4, [128, 128]) in 16.2-16.3 ms per
// 2^21 against 106.9-107.5; on camel and the flagship its barriers cost
// more than its products save (1.47x and 1.045x slower), so they keep this
// kernel.

#include <stdint.h>

#include "flow_plan.cuh"

#define SAMPLER_MAX_BLOCK 512  // threads (samples) per block

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// top 24 bits -> [0, 1 - 2^-24]: never 1.0
__device__ __forceinline__ float u01(unsigned bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// W_SMEM: the weights are copied into shared memory, padded
// (copy_padded_weights); otherwise every thread reads the flat buffer
// through L1, which leaves the shared memory to the tiles.
template <bool W_SMEM>
__global__ void __launch_bounds__(SAMPLER_MAX_BLOCK, 2)
pwquad_sampler_kernel(const int* __restrict__ desc, int desc_len, const int* __restrict__ tab,
                      int tab_len, const float* __restrict__ weights, int n_wpad,
                      const float* __restrict__ latents, uint64_t seed, uint64_t offset,
                      float* __restrict__ x_out, float* __restrict__ jac_out, long long n,
                      int n_flow, int rows_a, int rows_b, int dim_major) {
  extern __shared__ float4 smem4[];
  const int S = blockDim.x, S1 = S + 1, t = threadIdx.x;
  int* D = reinterpret_cast<int*>(smem4);
  int* T = D + desc_len;
  float* W_s = reinterpret_cast<float*>(D + round4(desc_len + tab_len));  // [n_wpad]
  float* X = W_s + (W_SMEM ? n_wpad : 0);  // [n_flow][S1]: the state
  float* A = X + n_flow * S1;              // [rows_a][S1]
  float* B = A + rows_a * S1;              // [rows_b][S1]: also the logits
  for (int i = t; i < desc_len; i += S) D[i] = desc[i];
  for (int i = t; i < tab_len; i += S) T[i] = tab[i];
  __syncthreads();
  const int n_cells = T[0];
  const int* cell_pos = T + 1;
  const int* maps = T + 1 + n_cells;
  if (t == 0) {  // the table, the tiles and the padded copy must fit the plan
    int wq, rows, max_rows;
    if (!tiles_fit(D, desc_len, tab_len, cell_pos, n_cells, n_flow, rows_a, rows_b, &wq, &rows,
                   &max_rows)
        || (W_SMEM && wq != n_wpad))
      __trap();
  }
  if (W_SMEM) copy_padded_weights(D, cell_pos, n_cells, n_flow, weights, W_s);
  __syncthreads();

  const int* map_end = maps + n_cells * n_flow;
  // the operand in, or batch-major out, cross the tile's columns: barriers
  const bool in4 = (reinterpret_cast<size_t>(latents) & 15) == 0;
  const bool out4 = (reinterpret_cast<size_t>(x_out) & 15) == 0;
  const uint2 key = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
  float* Xc = X + t;
  float* Bc = B + t;
  const long long stride = (long long)gridDim.x * S;
  for (long long base = (long long)blockIdx.x * S; base < n; base += stride) {
    const int nv = (int)min((long long)S, n - base);
    const long long i = base + t;
    const bool valid = t < nv;
    if (latents != nullptr) {
      __syncthreads();  // the last tile's X is read out
      load_tile(X, latents + base * n_flow, nv, n_flow, S1, in4);
      __syncthreads();
    } else {
      if (!dim_major) __syncthreads();  // the last tile's X is read out
      const uint64_t ctr = (uint64_t)i + offset;
      for (int d0 = 0; d0 < n_flow; d0 += 4) {
        const uint4 r = valid ? philox4x32_10(make_uint4((unsigned)ctr, (unsigned)(ctr >> 32),
                                                         (unsigned)(d0 >> 2), 0u),
                                              key)
                              : make_uint4(0u, 0u, 0u, 0u);
        const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d0 + j < n_flow) Xc[(d0 + j) * S1] = valid ? u01(words[j]) : 0.5f;
      }
    }

    float jac = 1.0f;
    int wp = 0;
    for (int c = 0; c < n_cells; ++c) {
      const int p = cell_pos[c];
      const int* m = maps + c * n_flow;  // logical dimension d is X's row m[d]
      const int kind = D[p + 1], pt = D[p + 2], nb = D[p + 3], act = D[p + 4];
      const int n_hidden = D[p + 5] - 1;
      const int* L = D + p + 6;
      // every layer but the last, in full; the last hidden output lands in A
      const float* h = Xc;
      bool mapped = true;
      for (int l = 0; l < n_hidden; ++l, L += 5) {
        const int fan_in = L[0], fan_out = L[1], relu = L[2];
        float* o = ((n_hidden - 1 - l) & 1) ? B : A;
        if (W_SMEM) {
          const int ld = round4(fan_out);
          dense_from<true>(mapped, false, W_s + wp, W_s + wp + fan_in * ld, ld, 1, fan_in,
                           fan_out, h, m, o + t, S1, relu);
          wp += (fan_in + 1) * ld;
        } else {
          dense_from<false>(mapped, false, weights + L[3], weights + L[4], fan_out, 1, fan_in,
                            fan_out, h, m, o + t, S1, relu);
        }
        h = o + t;
        mapped = false;
      }
      const int used = last_layer<W_SMEM>(L, kind, pt, nb, act, n_flow, mapped, false, h, m,
                                          Xc, Bc, S1, W_s + wp, weights, jac);
      if (W_SMEM) wp += used;
    }

    if (dim_major) {  // each logical dimension's row, coalesced
      if (valid)
        for (int d = 0; d < n_flow; ++d) x_out[(long long)d * n + i] = Xc[map_end[d] * S1];
    } else {
      __syncthreads();
      store_tile(x_out + base * n_flow, X, map_end, nv, n_flow, S1, out4);
    }
    if (valid) jac_out[i] = jac;
  }
}

// ---------------------------------------------------------------------------
// The tiled sampler, pwquad_sampler_kernel_tiled, for plans with a layer
// pwquad_sampler.SAMPLER_TILED_MIN_WIDTH wide or more
// (pwquad_sampler.sampler_kernel_for).  The same walk, with the conditioner's
// products as block products: each block takes tiles of B = blockDim.x
// samples, its tiles rows of S = B + 4 floats (flow_plan.cuh's tile_dense),
// and each thread owns register tiles of four outputs by four samples, so
// one float4 of activations and one of weights feed 16 FMAs.  Per cell, the
// hidden layers run one block product each (the first reads X through the
// cell's row map), then the last layer one transformed dimension at a time:
// its logits as one block product into Z, a barrier, the transform a thread
// a sample on Z's column (apply_dim, writing X's row m[pt + ti]), a barrier.
// With W_SMEM the weights the next products read are copied into shared
// memory while the transform runs: the cell's next dimension's columns of
// the last layer (Wl), or the next cell's hidden layers (Wh) and first
// dimension; otherwise every thread reads them through L1.  Each output is
// summed as dense sums it (bias, then k ascending, fmaf), and the transform
// is the same apply_dim, so x and jac equal the per-thread kernel's.
//
// What bounds it on an H100: on the 2 -> 4 plan, per sample ~92.7k FMAs in
// 4 x 4 tiles (two LDS.128 per 16 FMAs, five shared-memory wavefronts a
// warp step against four cycles of FMA issue) and the transforms' 2,600
// expf and 2,640 IEEE divisions, a thread a sample on Z's columns; two
// barriers a dimension.  At 96-111 registers (no spills) and ~72 KB of
// shared memory three blocks of 128 share an SM: 36.1 ms per 2^21, 17.5% of
// the FLOP bound (PERF.md section 6).
// ---------------------------------------------------------------------------

#define SAMPLER_TILED_BLOCK 128  // threads (samples) per block of the tiled sampler
// Blocks of SAMPLER_TILED_BLOCK an SM holds by registers
// (pwquad_sampler.SAMPLER_TILED_MIN_BLOCKS): ptxas caps a thread at 128.
#define SAMPLER_TILED_MIN_BLOCKS 4

// The copies the products of transformed dimension ti of the cell op at
// D[p] read: that dimension's columns of the last layer into Wl and, at ti
// 0, the cell's hidden layers into Wh (each row padded to a multiple of four
// floats, the bias a last row: flow_plan.cuh's copy_layer).  Every thread
// of the block calls it.
__device__ __forceinline__ void copy_for(const int* D, int p, int ti, int n_flow,
                                         const float* __restrict__ weights, float* Wh,
                                         float* Wl) {
  const int kind = D[p + 1], t_dims = n_flow - D[p + 2], n_hidden = D[p + 5] - 1;
  const int width = logit_width(kind, D[p + 3]);
  const int* L = D + p + 6;
  for (int l = 0, w_off = 0; l < n_hidden; ++l, L += 5) {
    const int ld = round4(L[1]);
    if (ti == 0) copy_layer(Wh + w_off, weights, L[0] + 1, ld, L[1], L[3], L[4], L[1], 0, 1);
    w_off += (L[0] + 1) * ld;
  }
  if (ti < t_dims)
    copy_layer(Wl, weights, L[0] + 1, round4(width), width, L[3], L[4], L[1],
               kind == KIND_AFFINE ? ti : ti * width, kind == KIND_AFFINE ? t_dims : 1);
}

// The largest copies, in floats: of one cell op's hidden layers (*wh) and of
// one transformed dimension's last-layer columns (*wl).  The cell ops'
// positions must have passed tiles_fit.
__device__ __forceinline__ void tiled_copies(const int* D, const int* cell_pos, int n_cells,
                                             int* wh, int* wl) {
  *wh = *wl = 0;
  for (int c = 0; c < n_cells; ++c) {
    const int p = cell_pos[c], n_hidden = D[p + 5] - 1;
    const int* L = D + p + 6;
    int h = 0;
    for (int l = 0; l < n_hidden; ++l, L += 5) h += (L[0] + 1) * round4(L[1]);
    *wh = max(*wh, h);
    *wl = max(*wl, (L[0] + 1) * round4(logit_width(D[p + 1], D[p + 3])));
  }
}

// tile_dense with input row k X's row xmap[k] where mapped (a cell's first
// layer), else in's row k.
template <bool W_SMEM>
__device__ __forceinline__ void tile_dense_from(bool mapped, const float* __restrict__ w,
                                                const float* __restrict__ b, int ld, int step,
                                                int fan_in, int n_out, const float* in,
                                                const int* xmap, float* out, int S, bool relu) {
  if (mapped)
    tile_dense<W_SMEM, true>(w, b, ld, step, fan_in, n_out, in, out, S, relu, xmap);
  else
    tile_dense<W_SMEM>(w, b, ld, step, fan_in, n_out, in, out, S, relu);
}

// W_SMEM: the weights the products read are copied into shared memory (Wh,
// wh_floats, and Wl, wl_floats: tiled_copies); otherwise every thread reads
// the flat buffer through L1.  The tiles: X [n_flow] rows, the state; A
// [rows_a] and Z [rows_b], the hidden layers' ping-pong tiles as the
// per-thread kernel's A and B, Z also one transformed dimension's logits.
template <bool W_SMEM>
__global__ void __launch_bounds__(SAMPLER_TILED_BLOCK, SAMPLER_TILED_MIN_BLOCKS)
pwquad_sampler_kernel_tiled(const int* __restrict__ desc, int desc_len,
                            const int* __restrict__ tab, int tab_len,
                            const float* __restrict__ weights,
                            const float* __restrict__ latents, uint64_t seed, uint64_t offset,
                            float* __restrict__ x_out, float* __restrict__ jac_out, long long n,
                            int n_flow, int rows_a, int rows_b, int wh_floats, int wl_floats,
                            int dim_major) {
  extern __shared__ float4 smem4[];
  const int B = blockDim.x, S = B + 4, t = threadIdx.x;
  int* D = reinterpret_cast<int*>(smem4);
  int* T = D + desc_len;
  float* Wh = reinterpret_cast<float*>(D + round4(desc_len + tab_len));  // [wh_floats]
  float* Wl = Wh + (W_SMEM ? wh_floats : 0);                              // [wl_floats]
  float* X = Wl + (W_SMEM ? wl_floats : 0);  // [n_flow][S]: the state
  float* A = X + n_flow * S;                 // [rows_a][S]
  float* Z = A + rows_a * S;                 // [rows_b][S]: also the logits
  for (int i = t; i < desc_len; i += B) D[i] = desc[i];
  for (int i = t; i < tab_len; i += B) T[i] = tab[i];
  __syncthreads();
  const int n_cells = T[0];
  const int* cell_pos = T + 1;
  const int* maps = T + 1 + n_cells;
  const int* map_end = maps + n_cells * n_flow;
  if (t == 0) {  // the table, the tiles and the copies must fit the plan
    int wq, rows, max_rows, wh, wl;
    if (!tiles_fit(D, desc_len, tab_len, cell_pos, n_cells, n_flow, rows_a, rows_b, &wq, &rows,
                   &max_rows))
      __trap();
    tiled_copies(D, cell_pos, n_cells, &wh, &wl);
    if (W_SMEM && (wh > wh_floats || wl > wl_floats)) __trap();
  }
  // the first products' weights; the tile's first barrier ends the copy
  if (W_SMEM && n_cells > 0) copy_for(D, cell_pos[0], 0, n_flow, weights, Wh, Wl);

  const bool in4 = (reinterpret_cast<size_t>(latents) & 15) == 0;
  const bool out4 = (reinterpret_cast<size_t>(x_out) & 15) == 0;
  const uint2 key = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
  float* Xc = X + t;
  const long long stride = (long long)gridDim.x * B;
  for (long long base = (long long)blockIdx.x * B; base < n; base += stride) {
    const int nv = (int)min((long long)B, n - base);
    const long long i = base + t;
    const bool valid = t < nv;
    if (latents != nullptr) {
      __syncthreads();  // the last tile's X is read out
      load_tile(X, latents + base * n_flow, nv, n_flow, S, in4);
    } else {
      if (!dim_major) __syncthreads();  // the last tile's X is read out
      const uint64_t ctr = (uint64_t)i + offset;
      for (int d0 = 0; d0 < n_flow; d0 += 4) {
        const uint4 r = valid ? philox4x32_10(make_uint4((unsigned)ctr, (unsigned)(ctr >> 32),
                                                         (unsigned)(d0 >> 2), 0u),
                                              key)
                              : make_uint4(0u, 0u, 0u, 0u);
        const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d0 + j < n_flow) Xc[(d0 + j) * S] = valid ? u01(words[j]) : 0.5f;
      }
    }
    __syncthreads();  // X holds the tile; the first products' weights are copied

    float jac = 1.0f;
    for (int c = 0; c < n_cells; ++c) {
      const int p = cell_pos[c];
      const int* m = maps + c * n_flow;  // logical dimension d is X's row m[d]
      const int kind = D[p + 1], pt = D[p + 2], nb = D[p + 3], act = D[p + 4];
      const int n_hidden = D[p + 5] - 1;
      const int* L = D + p + 6;
      // every layer but the last, a block product each; the last hidden
      // output lands in A
      const float* h = X;
      for (int l = 0, w_off = 0; l < n_hidden; ++l, L += 5) {
        const int fan_in = L[0], fan_out = L[1], relu = L[2];
        float* o = ((n_hidden - 1 - l) & 1) ? Z : A;
        if (W_SMEM) {
          const int ld = round4(fan_out);
          tile_dense_from<true>(l == 0, Wh + w_off, Wh + w_off + fan_in * ld, ld, 1, fan_in,
                                fan_out, h, m, o, S, relu);
          w_off += (fan_in + 1) * ld;
        } else {
          tile_dense_from<false>(l == 0, weights + L[3], weights + L[4], fan_out, 1, fan_in,
                                 fan_out, h, m, o, S, relu);
        }
        __syncthreads();
        h = o;
      }
      // the last layer and the transform, one transformed dimension at a time
      const int fin = L[0], fout = L[1], t_dims = n_flow - pt;
      const int width = logit_width(kind, nb), ldw = round4(width);
      // after this cell's last dimension the copies are the next cell op's,
      // or the first's for the block's next tile
      const bool copy_next = W_SMEM && (c + 1 < n_cells || base + stride < n);
      const int p_next = cell_pos[c + 1 < n_cells ? c + 1 : 0];
      for (int ti = 0; ti < t_dims; ++ti) {
        if (W_SMEM) {
          tile_dense_from<true>(n_hidden == 0, Wl, Wl + fin * ldw, ldw, 1, fin, width, h, m, Z, S,
                                false);
        } else {
          const int col0 = kind == KIND_AFFINE ? ti : ti * width;
          tile_dense_from<false>(n_hidden == 0, weights + L[3] + col0, weights + L[4] + col0,
                                 fout, kind == KIND_AFFINE ? t_dims : 1, fin, width, h, m, Z, S,
                                 false);
        }
        __syncthreads();  // the logits are whole, and the copies free
        if (ti + 1 < t_dims) {
          if (W_SMEM) copy_for(D, p, ti + 1, n_flow, weights, Wh, Wl);
        } else if (copy_next) {
          copy_for(D, p_next, 0, n_flow, weights, Wh, Wl);
        }
        float* xo = Xc + m[pt + ti] * S;
        *xo = apply_dim(kind, TileCol{Z + t, S}, nb, act, *xo, jac);
        __syncthreads();  // X's row and the copies are whole, and Z free
      }
      if (t_dims == 0) {  // nothing to transform: only the next copies
        if (copy_next) copy_for(D, p_next, 0, n_flow, weights, Wh, Wl);
        __syncthreads();
      }
      if (kind == KIND_AFFINE) jac *= TWO_OVER_PI;  // 2/pi once per cell (reference quirk)
    }

    if (dim_major) {  // each logical dimension's row, coalesced
      if (valid)
        for (int d = 0; d < n_flow; ++d) x_out[(long long)d * n + i] = Xc[map_end[d] * S];
    } else {
      store_tile(x_out + base * n_flow, X, map_end, nv, n_flow, S, out4);
    }
    if (valid) jac_out[i] = jac;
  }
}

static int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <bool W_SMEM>
static int launch_tiled(int n_blocks, int block, size_t smem, cudaStream_t stream,
                        const int* desc, int desc_len, const int* tab, int tab_len,
                        const float* weights, const float* latents, uint64_t seed,
                        uint64_t offset, float* x, float* jac, long long n, int n_flow,
                        int rows_a, int rows_b, int wh_floats, int wl_floats, int dim_major) {
  const int e = set_smem((const void*)pwquad_sampler_kernel_tiled<W_SMEM>, smem);
  if (e) return e;
  pwquad_sampler_kernel_tiled<W_SMEM><<<n_blocks, block, smem, stream>>>(
      desc, desc_len, tab, tab_len, weights, latents, seed, offset, x, jac, n, n_flow, rows_a,
      rows_b, wh_floats, wl_floats, dim_major);
  return (int)cudaGetLastError();
}

template <bool W_SMEM>
static int launch(int n_blocks, int block, size_t smem, cudaStream_t stream, const int* desc,
                  int desc_len, const int* tab, int tab_len, const float* weights, int n_wpad,
                  const float* latents, uint64_t seed, uint64_t offset, float* x, float* jac,
                  long long n, int n_flow, int rows_a, int rows_b, int dim_major) {
  const int e = set_smem((const void*)pwquad_sampler_kernel<W_SMEM>, smem);
  if (e) return e;
  pwquad_sampler_kernel<W_SMEM><<<n_blocks, block, smem, stream>>>(
      desc, desc_len, tab, tab_len, weights, n_wpad, latents, seed, offset, x, jac, n, n_flow,
      rows_a, rows_b, dim_major);
  return (int)cudaGetLastError();
}

extern "C" {

// The launch shapes compiled in and the tiled sampler's blocks an SM by
// registers, so the wrapper can check its copy.
int nf_pwquad_sampler_limits(int* out) {
  out[0] = SAMPLER_MAX_BLOCK;
  out[1] = SAMPLER_TILED_BLOCK;
  out[2] = SAMPLER_TILED_MIN_BLOCKS;
  return 0;
}

const char* nf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `latents` is [n, n_flow] f32, or null for the seeded variant (Philox,
// sample i at counter i + offset); x is [n, n_flow], or [n_flow, n] with
// dim_major.  tab is the plan's row table (pwquad_sampler.op_table), in
// blocks of `block` threads (a multiple of 32, at most SAMPLER_MAX_BLOCK),
// with the weights padded into shared memory (n_wpad floats) if w_smem is
// non-zero.  rows_a / rows_b are the rows of the A and B tiles the plan
// needs, and smem the block's bytes as the wrapper computed them
// (pwquad_sampler.sampler_smem_bytes); a mismatch is refused.
int nf_pwquad_sampler(const int* desc, int desc_len, const int* tab, int tab_len,
                      const float* weights, int n_wpad, const float* latents, uint64_t seed,
                      uint64_t offset, float* x, float* jac, long long n, int n_flow,
                      int n_blocks, int block, int w_smem, int rows_a, int rows_b,
                      long long smem, int dim_major, void* stream) {
  if (n <= 0) return 0;
  const size_t need = sizeof(float) * ((((size_t)desc_len + tab_len + 3) & ~(size_t)3)
                                       + (w_smem ? (size_t)n_wpad : 0)
                                       + (size_t)(n_flow + rows_a + rows_b) * (block + 1));
  if ((size_t)smem != need || block % 32 || block < 32 || block > SAMPLER_MAX_BLOCK
      || n_flow < 1 || rows_a < 0 || rows_b < 1 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (w_smem)
    return launch<true>(n_blocks, block, need, s, desc, desc_len, tab, tab_len, weights, n_wpad,
                        latents, seed, offset, x, jac, n, n_flow, rows_a, rows_b, dim_major);
  return launch<false>(n_blocks, block, need, s, desc, desc_len, tab, tab_len, weights, n_wpad,
                       latents, seed, offset, x, jac, n, n_flow, rows_a, rows_b, dim_major);
}


// The tiled sampler (pwquad_sampler_kernel_tiled), as nf_pwquad_sampler, in
// blocks of `block` threads (a multiple of 32, at most SAMPLER_TILED_BLOCK),
// each a tile of `block` samples; wh_floats / wl_floats the copies of the
// weights (pwquad_sampler.tiled_copies), in shared memory if w_smem is
// non-zero; smem the block's bytes as the wrapper computed them
// (pwquad_sampler.sampler_tiled_smem_bytes).  A mismatch is refused.
int nf_pwquad_sampler_tiled(const int* desc, int desc_len, const int* tab, int tab_len,
                            const float* weights, const float* latents, uint64_t seed,
                            uint64_t offset, float* x, float* jac, long long n, int n_flow,
                            int n_blocks, int block, int w_smem, int rows_a, int rows_b,
                            int wh_floats, int wl_floats, long long smem, int dim_major,
                            void* stream) {
  if (n <= 0) return 0;
  const size_t need = sizeof(float) * ((((size_t)desc_len + tab_len + 3) & ~(size_t)3)
                                       + (w_smem ? (size_t)wh_floats + wl_floats : 0)
                                       + (size_t)(n_flow + rows_a + rows_b) * (block + 4));
  if ((size_t)smem != need || block % 32 || block < 32 || block > SAMPLER_TILED_BLOCK
      || n_flow < 1 || rows_a < 0 || rows_b < 1 || wh_floats < 0 || wl_floats < 0
      || wh_floats % 4 || wl_floats % 4 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (w_smem)
    return launch_tiled<true>(n_blocks, block, need, s, desc, desc_len, tab, tab_len, weights,
                              latents, seed, offset, x, jac, n, n_flow, rows_a, rows_b,
                              wh_floats, wl_floats, dim_major);
  return launch_tiled<false>(n_blocks, block, need, s, desc, desc_len, tab, tab_len, weights,
                             latents, seed, offset, x, jac, n, n_flow, rows_a, rows_b,
                             wh_floats, wl_floats, dim_major);
}

// Blocks of the tiled sampler (weights' copies in shared memory if w_smem)
// of `block` threads and `smem` bytes an SM holds, by the CUDA occupancy
// calculator, into *out; returns the CUDA error.
int nf_pwquad_sampler_tiled_occupancy(int w_smem, int block, long long smem, int* out) {
  const void* k = w_smem ? (const void*)pwquad_sampler_kernel_tiled<true>
                         : (const void*)pwquad_sampler_kernel_tiled<false>;
  const int e = set_smem(k, (size_t)smem);
  return e ? e : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, block, (size_t)smem);
}

}  // extern "C"
