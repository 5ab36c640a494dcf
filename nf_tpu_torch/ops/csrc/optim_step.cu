// The Adamax / Adam update of the chunked trainer: torch.optim's foreach
// step, as the per-epoch trainer runs it on the card, in one kernel.
//
// Replaces no Pallas kernel: nf_tpu runs optax.adamax / optax.adam inside
// its jitted chunk (nf_tpu/training/optimizers.py), and the port's
// per-epoch trainer runs torch.optim.Adamax / Adam, whose non-capturable
// foreach step (torch/optim/adamax.py _multi_tensor_adamax, adam.py
// _multi_tensor_adam, the branch without `capturable`) takes its bias
// correction from the host as float64 scalars.  A CUDA graph cannot hold
// those host scalars, and torch's capturable step computes them on the
// device in the parameters' dtype, which rounds otherwise.  This kernel
// reads them from float64 tables indexed by a step count on the device,
// which it advances, so a replayed graph takes each epoch's scalar; the
// wrapper, the tables and the plain version are
// nf_tpu_torch/ops/optim_step.py.
//
// Bits.  Every operation is the one torch's foreach kernels do, in the
// order they do it, with the rounding written out (__fmaf_rn, __fmul_rn,
// ...), so nvcc can neither contract nor split one:
//   weight decay   g' = fma(wd, p, g)                 (_foreach_add, alpha)
//   first moment   m  = fma(w, g' - m, m) for |w| < 0.5, else
//                       fma(-(g' - m), 1 - w, g')      (_foreach_lerp_, w = 1 - b1)
//   Adamax         u  = max(u * b2, |g'| + eps)        (_foreach_mul_, abs, add_, maximum_)
//   Adam           v  = fma(1 - b2, g' * g', v * b2)   (_foreach_mul_, _foreach_addcmul_)
//                  d  = sqrt(v) / c2 + eps             (_foreach_sqrt, div_, add_)
//   update         p  = fma(s, m / u, p)               (_foreach_addcdiv_, a scalar list)
// with s = (lr / (1 - b1**t)) * -1 and c2 = (1 - b2**t)**0.5 computed on the
// host in float64 as torch computes them, and rounded to the parameters'
// dtype here as ATen rounds a scalar argument (to nearest).  Every scalar
// argument (w, b2, 1 - b2, eps, wd) comes as the double the Python code
// hands ATen and is rounded the same way.  No --use_fast_math: IEEE
// division and square root, subnormals kept.
//
// Design.  One launch covers up to OPT_MAX_TENSORS parameters, their
// pointers passed by value (a CUDA graph keeps them); each block takes
// OPT_CHUNK elements of one tensor, a thread every OPT_BLOCK-th of them.
// The step count is read once per block, and advanced by a one-thread
// kernel after the update's launches, so every block of a step reads the
// same t.  A step outside the tables (t < 1 or t >= their length, a graph
// replayed more often than its tables were sized for) traps: the launch
// fails and the next synchronisation raises, rather than reading past the
// tables and writing wrong parameters.
//
// What bounds it on an H100: bytes.  Per element it reads p, g and both
// moments and writes p and both moments: 28 bytes in float32, against ~10
// floating-point operations.  A camel-2D model holds a few hundred
// parameters, so there one launch costs what any launch costs.

#include <cuda_runtime.h>
#include <stdint.h>

#define OPT_MAX_TENSORS 48
#define OPT_BLOCK 256
#define OPT_CHUNK (OPT_BLOCK * 4)

struct OptList {
  void* p[OPT_MAX_TENSORS];
  const void* g[OPT_MAX_TENSORS];
  void* m[OPT_MAX_TENSORS];
  void* u[OPT_MAX_TENSORS];
  long long n[OPT_MAX_TENSORS];
  int block0[OPT_MAX_TENSORS + 1];  // a tensor's first block; block0[count] = the grid
  int count;
};

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float scalar(double a) { return __double2float_rn(a); }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double scalar(double a) { return a; }
};

struct OptScalars {
  double w1;     // 1 - beta1, the lerp weight
  double b2;     // beta2
  double a2;     // 1 - beta2 (Adam)
  double eps;
  double wd;     // weight decay, applied where decay != 0
  int decay;
};

template <typename T, bool ADAM>
__global__ void __launch_bounds__(OPT_BLOCK)
    optim_step_kernel(OptList list, const long long* __restrict__ step,
                      const double* __restrict__ step_size, const double* __restrict__ bc2_sqrt,
                      long long n_table, OptScalars sc) {
  using O = Ops<T>;
  const int b = blockIdx.x;
  int k = 0;
  while (k + 1 < list.count && list.block0[k + 1] <= b) ++k;
  const long long t = *step + 1;
  if (t < 1 || t >= n_table) __trap();
  const T s = O::scalar(step_size[t]);
  const T w = O::scalar(sc.w1);
  const T b2 = O::scalar(sc.b2);
  const T eps = O::scalar(sc.eps);
  const T wd = O::scalar(sc.wd);
  const bool small = O::abs(w) < T(0.5);
  const T w_c = O::sub(T(1), w);
  T a2 = T(0), c2 = T(1);
  if (ADAM) {
    a2 = O::scalar(sc.a2);
    c2 = O::scalar(bc2_sqrt[t]);
  }
  T* __restrict__ P = static_cast<T*>(list.p[k]);
  const T* __restrict__ G = static_cast<const T*>(list.g[k]);
  T* __restrict__ M = static_cast<T*>(list.m[k]);
  T* __restrict__ U = static_cast<T*>(list.u[k]);
  const long long start = (long long)(b - list.block0[k]) * OPT_CHUNK;
  const long long end = min(start + (long long)OPT_CHUNK, list.n[k]);
  for (long long i = start + threadIdx.x; i < end; i += OPT_BLOCK) {
    T p = P[i], g = G[i], m = M[i], u = U[i];
    if (sc.decay) g = O::fma(wd, p, g);
    const T d = O::sub(g, m);
    m = small ? O::fma(w, d, m) : O::fma(-d, w_c, g);
    T den;
    if (ADAM) {
      u = O::fma(a2, O::mul(g, g), O::mul(u, b2));
      den = O::add(O::div(O::sqrt(u), c2), eps);
    } else {
      const T a = O::mul(u, b2);
      const T c = O::add(O::abs(g), eps);
      u = (isnan(a) || a > c) ? a : c;  // ATen's maximum: NaN wins
      den = u;
    }
    P[i] = O::fma(s, O::div(m, den), p);
    M[i] = m;
    U[i] = u;
  }
}

__global__ void optim_step_advance(long long* step) { *step += 1; }

template <typename T, bool ADAM>
static int launch_all(int count, void* const* p, void* const* g, void* const* m,
                      void* const* u, const long long* n, long long* step,
                      const double* step_size, const double* bc2_sqrt, long long n_table,
                      OptScalars sc, cudaStream_t stream) {
  for (int first = 0; first < count; first += OPT_MAX_TENSORS) {
    OptList list;
    list.count = count - first < OPT_MAX_TENSORS ? count - first : OPT_MAX_TENSORS;
    long long blocks = 0;
    for (int j = 0; j < list.count; ++j) {
      list.p[j] = p[first + j];
      list.g[j] = g[first + j];
      list.m[j] = m[first + j];
      list.u[j] = u[first + j];
      list.n[j] = n[first + j];
      list.block0[j] = (int)blocks;
      blocks += (n[first + j] + OPT_CHUNK - 1) / OPT_CHUNK;
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    }
    list.block0[list.count] = (int)blocks;
    optim_step_kernel<T, ADAM><<<(unsigned)blocks, OPT_BLOCK, 0, stream>>>(
        list, step, step_size, bc2_sqrt, n_table, sc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  optim_step_advance<<<1, 1, 0, stream>>>(step);
  return (int)cudaGetLastError();
}

extern "C" {

// One optimizer step over `count` parameters: dtype 0 float32, 1 float64;
// adam 0 Adamax (u = exp_inf), 1 Adam (u = exp_avg_sq).  The pointer and
// size arrays are host memory; step, step_size and bc2_sqrt device memory
// (bc2_sqrt may be null for Adamax), the tables `n_table` entries long.
// Returns the CUDA error of the launches.
int nf_optim_step(int dtype, int adam, int count, void* const* p, void* const* g,
                  void* const* m, void* const* u, const long long* n, long long* step,
                  const double* step_size, const double* bc2_sqrt, long long n_table, double w1,
                  double b2, double a2, double eps, double wd, int decay, void* stream) {
  if (count <= 0 || n_table < 2) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < count; ++j)
    if (n[j] <= 0) return (int)cudaErrorInvalidValue;
  OptScalars sc{w1, b2, a2, eps, wd, decay};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_OPT_LAUNCH(T, ADAM) \
  launch_all<T, ADAM>(count, p, g, m, u, n, step, step_size, bc2_sqrt, n_table, sc, st)
  if (dtype == 0) return adam ? NF_OPT_LAUNCH(float, true) : NF_OPT_LAUNCH(float, false);
  if (dtype == 1) return adam ? NF_OPT_LAUNCH(double, true) : NF_OPT_LAUNCH(double, false);
#undef NF_OPT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
