// Fused eval-mode sampler for coupling-cell flows (pwquad, pwlin, affine).
//
// Replaces the Pallas TPU kernel nf_tpu/ops/pwquad_sampler.py::build_sampler
// (body `kernel`).  Per sample it takes the latents -- read from an operand,
// or drawn here with Philox4x32-10 -- walks the flow plan (permutations and
// cells; per cell the BatchNorm-folded conditioner MLP, then the per-dimension
// transform) and writes x and the Jacobian product once.  The plain PyTorch
// version is nf_tpu_torch/flows/fast_eval.py::make_folded_forward; the plan
// encoding is nf_tpu_torch/ops/pwquad_sampler.py::encode_plan.  The plan walk
// and the per-kind maths live in flow_plan.cuh, shared with pwquad_train.cu.
//
// Design, for a first kernel that is simple and right:
//   * one thread per sample, grid-stride loop, ragged tail masked by the loop
//     bound; nothing carries between blocks;
//   * each block copies the int32 plan descriptor and the flat f32 folded
//     weights into shared memory once.  Every thread of a warp reads the same
//     weight at the same time, so the reads are broadcasts without bank
//     conflicts.  Plans above 48 KB use the opt-in dynamic shared memory;
//   * per-thread state is x[MAX_FLOW], two hidden-activation buffers of
//     MAX_HIDDEN and one transformed dimension's logits (2*MAX_BINS+1).  The
//     last conditioner layer is streamed: each transformed dimension computes
//     only its own logits from the last hidden layer (or the rank-r factor),
//     then transforms;
//   * expf / sqrtf / atanf and IEEE division; the build does not use
//     --use_fast_math, since reduced-precision maths diverges through trained
//     sharp CDFs.
//
// What bounds it on an H100: arithmetic, not memory.  For the camel-2D model
// (2 cells, hidden 3x3x3, 4 bins) a sample costs ~18 expf, a few divisions
// and ~100 FMAs against 12 bytes written; at the rate PERF.md records, the
// writes use a few percent of the 3.35 TB/s HBM bandwidth.  The 10-D rank-4
// flagship spends most of its ~7k FLOPs per sample in the conditioner MLP
// against 44 bytes written.  The plan is runtime data, so the per-thread
// arrays are indexed dynamically and live in local memory (L1-cached), and
// every conditioner FMA also loads its activation from there; specialising
// the kernel per plan to keep them in registers is the first lever for
// later work.

#include <stdint.h>

#include "flow_plan.cuh"

#define BLOCK 128
#define MAX_BLOCKS 8192

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

__global__ void __launch_bounds__(BLOCK)
pwquad_sampler_kernel(const int* __restrict__ desc, int desc_len,
                      const float* __restrict__ weights, int n_weights,
                      const float* __restrict__ latents, uint64_t seed,
                      uint64_t offset, float* __restrict__ x_out,
                      float* __restrict__ jac_out, long long n, int dim_major) {
  extern __shared__ float smem[];
  float* W = smem;
  int* D = reinterpret_cast<int*>(smem + n_weights);
  for (int i = threadIdx.x; i < n_weights; i += blockDim.x) W[i] = weights[i];
  for (int i = threadIdx.x; i < desc_len; i += blockDim.x) D[i] = desc[i];
  __syncthreads();

  const int n_flow = D[0], n_ops = D[1];
  const uint2 key = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float xs[MAX_FLOW];
    if (latents != nullptr) {
      for (int d = 0; d < n_flow; ++d) xs[d] = latents[i * n_flow + d];
    } else {
      const uint64_t ctr = (uint64_t)i + offset;
      for (int d0 = 0; d0 < n_flow; d0 += 4) {
        const uint4 r = philox4x32_10(
            make_uint4((unsigned)ctr, (unsigned)(ctr >> 32), (unsigned)(d0 >> 2), 0u),
            key);
        const unsigned words[4] = {r.x, r.y, r.z, r.w};
        for (int j = 0; j < 4 && d0 + j < n_flow; ++j) xs[d0 + j] = u01(words[j]);
      }
    }
    float jac = 1.0f;
    NoSink no_sink;
    int p = 2;
    for (int op = 0; op < n_ops; ++op) {
      if (D[p] == OP_PERM) {
        apply_perm(D + p + 1, xs, n_flow);
        p += 1 + n_flow;
      } else {
        p = apply_cell(D, p, W, xs, jac, n_flow, no_sink);
      }
    }
    if (dim_major) {
      for (int d = 0; d < n_flow; ++d) x_out[(long long)d * n + i] = xs[d];
    } else {
      for (int d = 0; d < n_flow; ++d) x_out[i * n_flow + d] = xs[d];
    }
    jac_out[i] = jac;
  }
}

extern "C" {

// The compiled caps, so the wrapper can check its own copy of them.
int nf_pwquad_sampler_limits(int* out) {
  out[0] = MAX_FLOW;
  out[1] = MAX_HIDDEN;
  out[2] = MAX_BINS;
  return 0;
}

const char* nf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `latents` is [n, n_flow] f32 or null for the seeded variant.
int nf_pwquad_sampler(const int* desc, int desc_len, const float* weights,
                      int n_weights, const float* latents, uint64_t seed,
                      uint64_t offset, float* x, float* jac, long long n,
                      int dim_major, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)n_weights + (size_t)desc_len);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pwquad_sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  pwquad_sampler_kernel<<<(unsigned)blocks, BLOCK, smem, (cudaStream_t)stream>>>(
      desc, desc_len, weights, n_weights, latents, seed, offset, x, jac, n,
      dim_major);
  return (int)cudaGetLastError();
}

}  // extern "C"
