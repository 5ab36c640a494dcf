// The op-chain kernel of the per-op cost calibration: what one float32
// elementwise op costs on this card, as nvcc lowers it, in units of one FMA.
//
// Replaces tools/calibrate_vpu_ops.py:62 `build_chain_kernel` -> `kernel`
// (pallas_call :80), which measures the same on a TPU's VPU.  It computes
// what that kernel computes: for each grid step i in 0..grid-1, a [32, 128]
// float32 tile
//
//     y = lane / 128 + 0.5 + 1e-6 * i + seed * 1e-6
//
// (rounded in that order), one of ten chain steps applied K times, and the
// [32, 128] sum over i of the results.  The steps are the Pallas tool's
// CHAINS (:46-58), each with an attracting fixed point so that no value
// leaves a healthy float32 range:
//
//     0 fma     fma(y, 0.9990234375, 0.001)   one FFMA
//     1 mul     y * 0.9999
//     2 add     y + 0.001                     (the tool's `* 1.0` folds away)
//     3 exp     expf(y * 2^-10)
//     4 sqrt    sqrtf(y + 1)                  correctly rounded
//     5 rsqrt   rsqrtf(y + 1)
//     6 div     2 / (y + 1)                   IEEE division
//     7 log     logf(y + 2)
//     8 tanh    tanhf(y) + 0.5
//     9 select  y > 1 ? y * 0.9 : y * 1.05 + 0.01
//
// Built with the port's flags (no --use_fast_math): expf, sqrtf, rsqrtf,
// logf, tanhf and the division are the forms csrc/flow_plan.cuh requires of
// the flow kernels, so the costs price the port's own transforms.  Every
// add and multiply around them is written with its rounding (__fadd_rn,
// __fmul_rn), which nvcc neither contracts into an FMA nor reorders, so a
// step rounds as the plain version's torch operations do
// (nf_tpu_torch/ops/op_chain.py `chain_ref`); fma is the one step that is a
// fused multiply-add, and its plain version rounds once too.
//
// What bounds it on an H100: operations.  The fma, mul, add and select
// chains run on the FP32 pipe (128 lanes an SM; a step's result feeds the
// next, 4 cycles of latency, so an SM sub-partition needs four warps in
// flight to issue one a cycle).  exp, sqrt, rsqrt, log and tanh go through
// the special-function unit (MUFU, 16 lanes an SM) and a few FP32
// operations around it; the IEEE division is a MUFU.RCP and a Newton
// sequence with a slow path for edge cases.  Per element the kernel reads
// nothing and writes one float per 32 grid steps.
//
// Design.  One element (grid step i, tile row s, lane l) per thread, so
// 4096 x grid elements fill every SM and the K-difference of two launches
// measures throughput, not one chain's latency.  The chain is a template
// on K, unrolled in full at compile time (as Pallas unrolls its Python
// loop), so no loop counter enters the slope.  A warp holds 32 consecutive
// grid steps of one tile element; its lane 0 adds their chains' results in
// order of i through shuffles into one partial row per 32 grid steps (no
// atomics), and a second kernel adds the partial rows in order.  The sum
// is therefore a fixed order, the same on every launch, and the plain
// version repeats it; up to 32 grid steps it is the Pallas kernel's own
// order (out += y, i = 0, 1, ...).

#include <cuda_runtime.h>

#define OC_LANE 128
#define OC_SUB 32
#define OC_TILE (OC_LANE * OC_SUB)   // elements of one grid step's tile
#define OC_CHUNK 32                  // grid steps a warp sums: one partial row
#define OC_BLOCK 256                 // threads: 8 warps, 8 tile elements
#define OC_OPS 10

template <int OP>
__device__ __forceinline__ float chain_step(float y) {
  if constexpr (OP == 0) return __fmaf_rn(y, 0.9990234375f, 0.001f);
  if constexpr (OP == 1) return __fmul_rn(y, 0.9999f);
  if constexpr (OP == 2) return __fadd_rn(y, 0.001f);
  if constexpr (OP == 3) return expf(__fmul_rn(y, 0.0009765625f));
  if constexpr (OP == 4) return sqrtf(__fadd_rn(y, 1.0f));
  if constexpr (OP == 5) return rsqrtf(__fadd_rn(y, 1.0f));
  if constexpr (OP == 6) return __fdiv_rn(2.0f, __fadd_rn(y, 1.0f));
  if constexpr (OP == 7) return logf(__fadd_rn(y, 2.0f));
  if constexpr (OP == 8) return __fadd_rn(tanhf(y), 0.5f);
  if constexpr (OP == 9)
    return y > 1.0f ? __fmul_rn(y, 0.9f) : __fadd_rn(__fmul_rn(y, 1.05f), 0.01f);
  return y;
}

// partial[c * OC_TILE + e] = sum over i in [32c, min(32c + 32, grid)) of
// the chain at tile element e, added in order of i from 0.
// Grid: (ceil(grid / 32), OC_TILE / 8) blocks of OC_BLOCK threads.
template <int OP, int K>
__global__ void __launch_bounds__(OC_BLOCK)
    op_chain_kernel(float* __restrict__ partial, int grid, int seed) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.y * (OC_BLOCK / 32) + (threadIdx.x >> 5);
  const int i0 = blockIdx.x * OC_CHUNK;
  const int i = i0 + lane;
  float y = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn((float)(e % OC_LANE), 1.0f / OC_LANE), 0.5f),
                                __fmul_rn(1e-6f, (float)i)),
                      __fmul_rn((float)seed, 1e-6f));
#pragma unroll
  for (int k = 0; k < K; ++k) y = chain_step<OP>(y);
  const int n = min(OC_CHUNK, grid - i0);
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, y, j));
  if (lane == 0) partial[(long long)blockIdx.x * OC_TILE + e] = acc;
}

// out[e] = the partial rows added in order, from 0.
__global__ void __launch_bounds__(OC_BLOCK)
    op_chain_sum(const float* __restrict__ partial, int n_rows, float* __restrict__ out) {
  const int e = blockIdx.x * OC_BLOCK + threadIdx.x;
  float acc = 0.0f;
  for (int r = 0; r < n_rows; ++r) acc = __fadd_rn(acc, partial[(long long)r * OC_TILE + e]);
  out[e] = acc;
}

template <int OP, int K>
static cudaError_t launch(float* partial, float* out, int grid, int seed, cudaStream_t st) {
  const int rows = (grid + OC_CHUNK - 1) / OC_CHUNK;
  op_chain_kernel<OP, K><<<dim3(rows, OC_TILE / (OC_BLOCK / 32)), OC_BLOCK, 0, st>>>(partial,
                                                                                   grid, seed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  op_chain_sum<<<OC_TILE / OC_BLOCK, OC_BLOCK, 0, st>>>(partial, rows, out);
  return cudaGetLastError();
}

typedef cudaError_t (*LaunchFn)(float*, float*, int, int, cudaStream_t);

template <int K>
static LaunchFn pick(int op) {
  switch (op) {
    case 0: return launch<0, K>;
    case 1: return launch<1, K>;
    case 2: return launch<2, K>;
    case 3: return launch<3, K>;
    case 4: return launch<4, K>;
    case 5: return launch<5, K>;
    case 6: return launch<6, K>;
    case 7: return launch<7, K>;
    case 8: return launch<8, K>;
    case 9: return launch<9, K>;
  }
  return nullptr;
}

extern "C" {

// The chain of op `op` (0-9, the order above) at K steps (64 or 320, the
// unrolled instantiations) over `grid` grid steps with `seed`, launched
// `repeats` times back to back on `stream`, each launch writing the same
// [32, 128] sum into `out`.  `partial` is device scratch of
// ceil(grid / 32) * 4096 floats.  Returns the CUDA error of the launches.
int nf_op_chain(int op, int k, int grid, int seed, int repeats, float* partial, float* out,
                void* stream) {
  if (op < 0 || op >= OC_OPS || grid < 1 || grid > (1 << 24) || repeats < 1)
    return (int)cudaErrorInvalidValue;
  LaunchFn fn = k == 64 ? pick<64>(op) : k == 320 ? pick<320>(op) : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int r = 0; r < repeats; ++r) {
    cudaError_t err = fn(partial, out, grid, seed, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
