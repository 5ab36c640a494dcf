// The bin-axis scan: an inclusive prefix sum along the last axis of a
// contiguous [rows, n] tensor, left to right or right to left, in float32
// or float64.  The coupling cells' cumulative sums over their bins
// (nf_tpu_torch/bijectors/coupling.py: the piecewise-linear CDF, the
// piecewise-quadratic bin edges and trapezoid CDF) and, right to left,
// their gradients; the wrapper, its autograd rule and the plain version are
// nf_tpu_torch/ops/bin_scan.py.
//
// Replaces no TPU kernel: nf_tpu leaves its bin-axis jnp.cumsum to XLA.  It
// was added because torch's own kernel for a cumsum over a short last axis
// (at::native::tensor_kernel_scan_innermost_dim) took ~1.9 ms for a
// [2^16 x 5, 16] float32 tensor on an H100, ~150x what its bytes take, and
// was 75% of the learned multi-channel trainer's device time (PERF.md).
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once, 2 x rows x n x itemsize bytes at 3.35 TB/s (12.5 us for
// [327680, 16] float32), against one add an element.
//
// Design.  A block of R threads takes R consecutive rows, one row a thread.
// Where a row fits the staged width (n <= BS_CHUNK), the block's rows are
// one contiguous span of memory: it is loaded with 16-byte loads (a scalar
// head and tail around the aligned body), neighbouring threads on
// neighbouring addresses, into shared memory padded to an odd row stride
// (C | 1 elements), so that the threads' walks along their own rows touch
// distinct banks.  Each thread then adds its row in place, in order, in the
// tensor's own type (as torch.cumsum accumulates on the card), and the
// block writes the span back with 16-byte stores.  A longer row is staged
// BS_CHUNK columns at a time, each chunk row by row (a warp on one row's
// consecutive columns), and its thread carries the running sum from chunk
// to chunk.  R is 256 rows in float32 and 128 in float64 (at most 33 KB of
// shared memory a block), halved down to 32 while fewer than two blocks an
// SM would run, so a small tensor still spreads over the SMs.  The
// geometry comes from n, the row count, the type and the current card's
// SMs alone.  It launches on the caller's stream (on the current device,
// which the wrapper sets to the tensor's), allocates nothing and does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#define BS_CHUNK 32          // columns staged at a time
#define BS_MIN_ROWS 32       // the fewest rows a block takes

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  typedef float4 type;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  typedef double2 type;
  static constexpr int n = 2;
};

// element e of a span of rows n wide -> its place in the padded tile
template <typename T>
__device__ __forceinline__ T& slot(T* tile, int ld, int n, int e) {
  const int r = e / n;
  return tile[r * ld + (e - r * n)];
}

// Between `span` (count elements of whole rows in device memory) and the
// tile, 16-byte accesses where the span is aligned.  load: span -> tile.
template <typename T, bool LOAD>
__device__ __forceinline__ void move_span(T* span, int count, int n, T* tile, int ld) {
  typedef typename Vec16<T>::type V;
  constexpr int VN = Vec16<T>::n;
  const int mis = (int)((reinterpret_cast<uintptr_t>(span) & 15) / sizeof(T));
  const int head = min(count, mis == 0 ? 0 : VN - mis);
  const int body = (count - head) / VN;
  const int tail = head + body * VN;
  for (int e = threadIdx.x; e < head; e += blockDim.x) {
    if (LOAD) slot(tile, ld, n, e) = span[e];
    else span[e] = slot(tile, ld, n, e);
  }
  V* vspan = reinterpret_cast<V*>(span + head);
  for (int i = threadIdx.x; i < body; i += blockDim.x) {
    const int e = head + i * VN;
    if (LOAD) {
      const V v = vspan[i];
      const T* p = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int q = 0; q < VN; ++q) slot(tile, ld, n, e + q) = p[q];
    } else {
      V v;
      T* p = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int q = 0; q < VN; ++q) p[q] = slot(tile, ld, n, e + q);
      vspan[i] = v;
    }
  }
  for (int e = tail + threadIdx.x; e < count; e += blockDim.x) {
    if (LOAD) slot(tile, ld, n, e) = span[e];
    else span[e] = slot(tile, ld, n, e);
  }
}

// Columns [c0, c0 + w) of `nr` rows n wide starting at `rows0`, row by row.
template <typename T, bool LOAD>
__device__ __forceinline__ void move_chunk(T* rows0, int nr, int n, int c0, int w, T* tile,
                                           int ld) {
  for (int i = threadIdx.x; i < nr * w; i += blockDim.x) {
    const int r = i / w, c = i - r * w;
    T* g = rows0 + (long long)r * n + c0 + c;
    if (LOAD) tile[r * ld + c] = *g;
    else *g = tile[r * ld + c];
  }
}

template <typename T>
__global__ void bin_scan_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows,
                                int n, int reverse) {
  extern __shared__ __align__(16) unsigned char bs_smem[];
  T* tile = reinterpret_cast<T*>(bs_smem);
  const long long r0 = (long long)blockIdx.x * blockDim.x;
  const int nr = (int)min((long long)blockDim.x, rows - r0);
  const int C = min(n, BS_CHUNK);
  const int ld = C | 1;
  const int chunks = (n + C - 1) / C;
  T* src = const_cast<T*>(x) + r0 * n;
  T* dst = y + r0 * n;
  T* row = tile + threadIdx.x * ld;
  T acc = T(0);
  for (int k = 0; k < chunks; ++k) {
    const int c0 = (reverse ? chunks - 1 - k : k) * C;
    const int w = min(C, n - c0);
    if (chunks == 1) move_span<T, true>(src, nr * n, n, tile, ld);
    else move_chunk<T, true>(src, nr, n, c0, w, tile, ld);
    __syncthreads();
    if ((int)threadIdx.x < nr) {
      if (reverse) {
        for (int j = w - 1; j >= 0; --j) {
          acc += row[j];
          row[j] = acc;
        }
      } else {
        for (int j = 0; j < w; ++j) {
          acc += row[j];
          row[j] = acc;
        }
      }
    }
    __syncthreads();
    if (chunks == 1) move_span<T, false>(dst, nr * n, n, tile, ld);
    else move_chunk<T, false>(dst, nr, n, c0, w, tile, ld);
    if (k + 1 < chunks) __syncthreads();
  }
}

// the current device's SMs, read at each launch, so a launch on another
// card sizes its grid for that card (a failed read leaves 0, and its error
// is the launch's cudaGetLastError)
static int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T>
static int launch(const void* x, void* y, long long rows, int n, int reverse, cudaStream_t st) {
  int R = 1024 / (int)sizeof(T);
  while (R > BS_MIN_ROWS && (rows + R - 1) / R < 2LL * sm_count()) R /= 2;
  const long long blocks = (rows + R - 1) / R;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * ((n < BS_CHUNK ? n : BS_CHUNK) | 1) * sizeof(T);
  bin_scan_kernel<T><<<(unsigned)blocks, R, smem, st>>>(static_cast<const T*>(x),
                                                        static_cast<T*>(y), rows, n, reverse);
  return (int)cudaGetLastError();
}

extern "C" {

// y = the inclusive prefix sum of x along its last axis (right to left for
// reverse != 0); x and y contiguous [rows, n], float32 (dtype 0) or float64
// (dtype 1), rows >= 1, n >= 1; launched on `stream`.  Returns the CUDA
// error of the launch (cudaGetLastError).
int nf_bin_scan(const void* x, void* y, long long rows, int n, int dtype, int reverse,
                void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, rows, n, reverse, st);
  if (dtype == 1) return launch<double>(x, y, rows, n, reverse, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
