// ELL sparse-times-dense product: Y = A @ X + shift * X.
//
// Replaces the TPU kernel of the JAX package
//   enspara_tpu/ops/spmm_pallas.py :: ell_spmm_pallas (_spmm_fn): 8 ELL
//     rows per grid step, their cols/vals in SMEM, double-buffered DMAs
//     of the (8, 128) X row group that holds each gathered row;
// and serves the role of its XLA twin enspara_tpu/ops/sparse.py ::
// ell_spmm, the sparse product of the Chebyshev-filtered eigensolver.
//
// Layout: cols (n, w) int32 and vals (n, w) fp32, row-major; every
// column index in [0, n), pad slots index their own row and hold 0.
// X and Y (n, k) fp32, row-major. Any n >= 1, w >= 0, k >= 1.
//
// Arithmetic: acc = shift * x (or 0 when has_shift is 0), then
// acc = acc + v_j * X[c_j] for j = 0 .. w-1, every product and every sum
// rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction). That
// is the order and rounding of the plain PyTorch version
// (ops/ell_spmm.py :: ell_spmm_plain), which the kernel equals bit for
// bit. A padded row stays exactly 0: 0 + 0 * x.
//
// What bounds it on an H100: memory. Per row it reads w (col, val)
// pairs and w rows of X and writes one row of Y, with 2 flops per
// gathered element. The bound counts cols + vals + X once + Y once at
// the HBM rate; X of the 100,000-state MSM at k = 64 is 27 MB and sits
// in the 50 MB L2, so the gathers mostly hit L2 and the speed depends
// on its hit rate. What the design does about it:
//   * one warp per row; each lane owns the columns lane, lane+32, ...
//     of the row, as float4 when k is a multiple of 128 and float2 when
//     a multiple of 64 (the solver's k = 64 .. 512), so every gathered
//     X row is read by the whole warp in one coalesced pass;
//   * the warp loads 32 (col, val) pairs at a time, one per lane,
//     coalesced, and broadcasts each with __shfl_sync;
//   * w is a runtime loop bound (not unrolled): it varies per matrix;
//   * row offsets are 64-bit.
// Making it faster (the Chebyshev update fused into the epilogue, the
// sweep in a CUDA graph) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;               // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 4;               // vectors of columns per lane per pass
constexpr unsigned kFull = 0xffffffffu;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ float2 vzero(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ float4 vzero(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float vmul(float s, float x) { return __fmul_rn(s, x); }
__device__ __forceinline__ float2 vmul(float s, float2 x) {
  return make_float2(__fmul_rn(s, x.x), __fmul_rn(s, x.y));
}
__device__ __forceinline__ float4 vmul(float s, float4 x) {
  return make_float4(__fmul_rn(s, x.x), __fmul_rn(s, x.y), __fmul_rn(s, x.z),
                     __fmul_rn(s, x.w));
}

__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                const float* __restrict__ X, float* __restrict__ Y,
                long long n, int w, int k, float shift, int has_shift) {
  using T = typename Vec<V>::T;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // the whole warp leaves together
  const int kv = k / V;  // vectors per row
  const int* crow = cols + row * w;
  const float* vrow = vals + row * w;
  const T* __restrict__ Xv = reinterpret_cast<const T*>(X);
  T* __restrict__ Yv = reinterpret_cast<T*>(Y);

  for (int base = 0; base < kv; base += 32 * kChunk) {
    T acc[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int c = base + lane + 32 * q;
      acc[q] = (has_shift && c < kv) ? vmul(shift, __ldg(Xv + row * kv + c))
                                     : vzero(T());
    }
    for (int j0 = 0; j0 < w; j0 += 32) {
      const int j = j0 + lane;
      int cj = 0;
      float vj = 0.0f;
      if (j < w) {
        cj = __ldg(crow + j);
        vj = __ldg(vrow + j);
        if (static_cast<unsigned long long>(static_cast<unsigned>(cj)) >=
            static_cast<unsigned long long>(n))
          __trap();  // a column index outside [0, n)
      }
      const int m = min(32, w - j0);
      for (int t = 0; t < m; ++t) {
        const long long ct = __shfl_sync(kFull, cj, t);
        const float vt = __shfl_sync(kFull, vj, t);
        const T* xr = Xv + ct * kv;
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          const int c = base + lane + 32 * q;
          if (c < kv) acc[q] = vadd(acc[q], vmul(vt, __ldg(xr + c)));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int c = base + lane + 32 * q;
      if (c < kv) Yv[row * kv + c] = acc[q];
    }
  }
}

}  // namespace

extern "C" {

// Y = A @ X + shift * X on `stream`: one launch of ceil(n / 8) blocks of
// 8 warps. `vec` (1, 2 or 4) is the number of columns a lane loads at
// once; k must be a multiple of it and X, Y aligned to 4 * vec bytes.
// Allocates nothing and does not synchronise. Returns the cudaError_t
// of the launch (0 = ok).
int ell_spmm(const int* cols, const float* vals, const float* X, float* Y,
             long long n, int w, int k, float shift, int has_shift, int vec,
             void* stream) {
  if (n <= 0 || w < 0 || k <= 0 || (vec != 1 && vec != 2 && vec != 4) ||
      k % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    ell_spmm_kernel<4><<<blocks, kThreads, 0, s>>>(cols, vals, X, Y, n, w, k,
                                                   shift, has_shift);
  else if (vec == 2)
    ell_spmm_kernel<2><<<blocks, kThreads, 0, s>>>(cols, vals, X, Y, n, w, k,
                                                   shift, has_shift);
  else
    ell_spmm_kernel<1><<<blocks, kThreads, 0, s>>>(cols, vals, X, Y, n, w, k,
                                                   shift, has_shift);
  return static_cast<int>(cudaGetLastError());
}

const char* ell_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
