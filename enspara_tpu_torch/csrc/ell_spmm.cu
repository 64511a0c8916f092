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
// acc = acc + v_j * X[c_j] for the slots j = 0 .. w-1 with v_j != 0, in
// ascending order, every product and every sum rounded on its own
// (__fmul_rn, __fadd_rn: no FMA contraction). That is the order and
// rounding of the plain PyTorch version (ops/ell_spmm.py ::
// ell_spmm_plain), which adds every slot: for finite X a skipped slot
// adds +-0 there, which changes at most the sign of an exact zero, so
// the two are equal under torch.equal. A NaN or inf in an X row that a
// row reaches only through a zero slot gives NaN in the plain version
// and is skipped here (a deliberate difference, ROADMAP queue 3).
//
// What bounds it on an H100: memory. Per row it reads w (col, val)
// pairs and the X rows of its nonzero slots and writes one row of Y,
// with 2 flops per gathered element. The bound counts cols + vals + X
// once + Y once at the HBM rate; X of the 100,000-state MSM at k = 64
// is 27 MB and sits in the 50 MB L2, so the gathers mostly hit L2 and
// the speed depends on how many of them are in flight. The design:
//   * a group of G lanes serves a row (G = 16 when the row is at most
//     16 vectors wide, so a warp serves 2 rows at k = 64; else G = 32);
//     each lane owns the vectors gl, gl + G, ... of the row, float4 when
//     k is a multiple of 4 and the pointers allow it, so every gathered
//     X row is one coalesced 16-byte-a-lane read;
//   * the group loads G (col, val) pairs at a time, one per lane,
//     coalesced, checks every column (pad slots too) and takes the
//     ballot of val != 0: only those slots are gathered, walked in
//     ascending order with __ffs (2/3 of the scale point's w = 40 slots
//     are padding);
//   * the gathers of up to kDepth slots are issued into registers before
//     their adds, which then run in slot order: the L2 round trips
//     overlap instead of queueing behind each add;
//   * the trip count of the gather loop is the largest over the warp's
//     groups, so the warp stays converged for its shuffles;
//   * row offsets are 64-bit.
// Fusing the Chebyshev update into the epilogue and the sweep in a CUDA
// graph change the solver, not this function, and are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 8;               // gathers in flight per lane
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

// V floats a lane loads at once, G lanes a row
template <int V, int G>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                const float* __restrict__ X, float* __restrict__ Y,
                long long n, int w, int k, float shift, int has_shift) {
  using T = typename Vec<V>::T;
  constexpr int kRows = 32 / G;  // rows per warp
  constexpr unsigned kGroupMask = static_cast<unsigned>((1ull << G) - 1);
  const int lane = threadIdx.x & 31;
  const int sub = lane / G, gl = lane % G;
  const long long row0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row0 >= n) return;  // the whole warp leaves together
  const long long row = row0 + sub;
  const bool live = row < n;
  const int kv = k / V;  // vectors per row
  const int* crow = cols + row * w;
  const float* vrow = vals + row * w;
  const T* __restrict__ Xv = reinterpret_cast<const T*>(X);
  T* __restrict__ Yv = reinterpret_cast<T*>(Y);

  for (int c = gl; c - gl < kv; c += G) {  // a pass per G vectors
    const bool mine = live && c < kv;
    T acc = (has_shift && mine) ? vmul(shift, __ldg(Xv + row * kv + c))
                                : vzero(T());
    for (int j0 = 0; j0 < w; j0 += G) {
      const int j = j0 + gl;
      int cj = 0;
      float vj = 0.0f;
      if (live && j < w) {
        cj = __ldg(crow + j);
        vj = __ldg(vrow + j);
        if (static_cast<unsigned long long>(static_cast<unsigned>(cj)) >=
            static_cast<unsigned long long>(n))
          __trap();  // a column index outside [0, n)
      }
      const unsigned nz = __ballot_sync(kFull, vj != 0.0f);
      unsigned bits = (nz >> (sub * G)) & kGroupMask;
      int trips = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        trips = max(trips, __popc((nz >> (r * G)) & kGroupMask));
      for (int t0 = 0; t0 < trips; t0 += kDepth) {
        T xs[kDepth];
        float vs[kDepth];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int src = __ffs(bits) - 1;  // -1 once the bits run out
          bits &= bits - 1;
          const long long ct = __shfl_sync(kFull, cj, max(src, 0), G);
          vs[u] = __shfl_sync(kFull, vj, max(src, 0), G);
          xs[u] = (src >= 0 && mine) ? __ldg(Xv + ct * kv + c) : vzero(T());
          if (src < 0) vs[u] = 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u)
          if (vs[u] != 0.0f) acc = vadd(acc, vmul(vs[u], xs[u]));
      }
    }
    if (mine) Yv[row * kv + c] = acc;
  }
}

template <int V, int G>
void launch(const int* cols, const float* vals, const float* X, float* Y,
            long long n, int w, int k, float shift, int has_shift,
            cudaStream_t s) {
  constexpr long long kRowsPerBlock = kWarps * (32 / G);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  ell_spmm_kernel<V, G><<<blocks, kThreads, 0, s>>>(cols, vals, X, Y, n, w,
                                                    k, shift, has_shift);
}

}  // namespace

extern "C" {

// Y = A @ X + shift * X on `stream`: one launch of 8-warp blocks, a group
// of `group` lanes (16 or 32) per row. `vec` (1, 2 or 4) is the number
// of columns a lane loads at once; k must be a multiple of it and X, Y
// aligned to 4 * vec bytes. Allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 = ok).
int ell_spmm(const int* cols, const float* vals, const float* X, float* Y,
             long long n, int w, int k, float shift, int has_shift, int vec,
             int group, void* stream) {
  if (n <= 0 || w < 0 || k <= 0 || (vec != 1 && vec != 2 && vec != 4) ||
      k % vec != 0 || (group != 16 && group != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 16) {
    if (vec == 4)
      launch<4, 16>(cols, vals, X, Y, n, w, k, shift, has_shift, s);
    else if (vec == 2)
      launch<2, 16>(cols, vals, X, Y, n, w, k, shift, has_shift, s);
    else
      launch<1, 16>(cols, vals, X, Y, n, w, k, shift, has_shift, s);
  } else {
    if (vec == 4)
      launch<4, 32>(cols, vals, X, Y, n, w, k, shift, has_shift, s);
    else if (vec == 2)
      launch<2, 32>(cols, vals, X, Y, n, w, k, shift, has_shift, s);
    else
      launch<1, 32>(cols, vals, X, Y, n, w, k, shift, has_shift, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ell_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
