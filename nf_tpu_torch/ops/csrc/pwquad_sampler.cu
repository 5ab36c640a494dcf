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

template <bool W_SMEM>
static int launch(int n_blocks, int block, size_t smem, cudaStream_t stream, const int* desc,
                  int desc_len, const int* tab, int tab_len, const float* weights, int n_wpad,
                  const float* latents, uint64_t seed, uint64_t offset, float* x, float* jac,
                  long long n, int n_flow, int rows_a, int rows_b, int dim_major) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute((const void*)pwquad_sampler_kernel<W_SMEM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pwquad_sampler_kernel<W_SMEM><<<n_blocks, block, smem, stream>>>(
      desc, desc_len, tab, tab_len, weights, n_wpad, latents, seed, offset, x, jac, n, n_flow,
      rows_a, rows_b, dim_major);
  return (int)cudaGetLastError();
}

extern "C" {

// The launch shape compiled in, so the wrapper can check its copy.
int nf_pwquad_sampler_limits(int* out) {
  out[0] = SAMPLER_MAX_BLOCK;
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

}  // extern "C"
