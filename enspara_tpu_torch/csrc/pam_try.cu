// One tried PAM proposal of the device sweeps
// (cluster/engine_kmedoids.py :: _pam_sweeps), over one shard's frames:
// pam_try_eval scores the swap of medoid cid for the proposal, and
// pam_try_commit applies it in place.
//
// Replaces no TPU kernel: the JAX sweep runs each try as one lax.cond
// body that XLA fuses. Run as eager torch ops, a try was about a
// hundred launches of 1-4 MB each; these are two.
//
// Layout: d1, d2 (n,) fp32, the nearest and second-nearest medoid
// distances; a1, a2 (n,) int32, their medoid ids; dnew (n,) fp32, each
// frame's distance to the proposal; stale (n,) bool (one byte), the
// points whose (d2, a2) is an upper bound until the next repair. The
// first n_valid frames are real, the rest padding (inf, -1, not stale).
//
// What bounds it on an H100: bytes. eval reads 21 B a frame (6.75 MB
// at 321,500 frames, ~2.0 us at 3.35 TB/s); commit reads 20 (d1, a1,
// d2, a2, dnew) and writes 16 (d1, a1, d2, a2), and one byte of stale
// where a point becomes stale (~3.5 us). At that size both are latency-bound: one launch each,
// one thread a frame, and eval's reduction across blocks in the same
// launch (the last block to finish, by atomic ticket and
// __threadfence, sums the blocks' partials), in a fixed order so that
// a sweep's decisions repeat from run to run. No float atomics.
//
// min / max follow torch.minimum / torch.maximum (NaN propagates), and
// the square is one rounded fp32 product summed in fp64, as the plain
// version's where(valid, c * c, 0).sum(dtype=float64) is.

#include <cuda_runtime.h>
#include <math.h>

#include "kcenters_common.cuh"

namespace {

struct SumDoubleOp {
  __device__ double operator()(double a, double b) const { return a + b; }
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// partials holds 3 * gridDim.x doubles, [quantity][block]; out the
// three sums (members & stale, stale | unc, sum of squares of the
// post-swap nearest distances). ticket is zero between launches.
__global__ void pam_eval_kernel(const float* __restrict__ d1,
                                const int* __restrict__ a1,
                                const float* __restrict__ d2,
                                const int* __restrict__ a2,
                                const float* __restrict__ dnew,
                                const unsigned char* __restrict__ stale,
                                int cid, long long n_valid, double* partials,
                                double* out, unsigned int* ticket) {
  __shared__ int iscratch[kMaxWarps];
  __shared__ double dscratch[kMaxWarps];
  __shared__ int s_last;
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int ms = 0, su = 0;
  double sq = 0.0;
  if (f < n_valid) {
    const float x1 = d1[f], x2 = d2[f], xn = dnew[f];
    const bool member = a1[f] == cid;
    const bool unc = (member || a2[f] == cid) && xn > x2;
    const bool st = stale[f] != 0;
    ms = member && st;
    su = st || unc;
    const float c = member ? nan_min(x2, xn) : nan_min(x1, xn);
    sq = (double)__fmul_rn(c, c);
  }
  const int nb = gridDim.x;
  ms = block_reduce(ms, 0, SumIntOp(), iscratch);
  su = block_reduce(su, 0, SumIntOp(), iscratch);
  sq = block_reduce(sq, 0.0, SumDoubleOp(), dscratch);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = ms;
    partials[nb + blockIdx.x] = su;
    partials[2 * nb + blockIdx.x] = sq;
  }
  if (!last_block(ticket, &s_last)) return;
  // thread t adds blocks t, t + blockDim.x, ... in order, then the fixed
  // tree of block_reduce: the same order on every run
  for (int q = 0; q < 3; ++q) {
    double v = 0.0;
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
      v += __ldcg(partials + q * nb + j);
    v = block_reduce(v, 0.0, SumDoubleOp(), dscratch);
    if (threadIdx.x == 0) out[q] = v;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// The commit: d1/a1 exact in every case; d2/a2 exact unless the point
// becomes stale.
__global__ void pam_commit_kernel(float* d1, int* a1, float* d2, int* a2,
                                  const float* __restrict__ dnew,
                                  unsigned char* stale, int cid, long long n,
                                  long long n_valid) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  if (f >= n_valid) {
    d1[f] = INFINITY;
    a1[f] = -1;
    d2[f] = INFINITY;
    a2[f] = -1;
    return;
  }
  const float x1 = d1[f], x2 = d2[f], xn = dnew[f];
  const int b1 = a1[f], b2 = a2[f];
  const bool in1 = xn < x1, in2 = xn < x2;
  const bool case_b = b1 == cid;  // nearest displaced
  const bool case_c = b2 == cid;  // second-nearest displaced
  d1[f] = case_b ? nan_min(x2, xn) : nan_min(x1, xn);
  a1[f] = case_b ? (in2 ? cid : b2) : (in1 ? cid : b1);
  d2[f] = case_b   ? nan_max(xn, x2)
          : case_c ? nan_max(xn, x1)
                   : (in1 ? x1 : (in2 ? xn : x2));
  a2[f] = case_b   ? (in2 ? b2 : cid)
          : case_c ? (in1 ? b1 : cid)
                   : (in1 ? b1 : (in2 ? cid : b2));
  if ((case_b || case_c) && xn > x2) stale[f] = 1;
}

constexpr int kThreads = 256;

int n_blocks(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Frames a block: the wrapper sizes partials (3 doubles a block) by it.
int pt_threads() { return kThreads; }

// One launch on `stream`; allocates nothing, does not synchronise;
// returns the launch's cudaError_t (0 = ok). n >= 1.
int pt_eval(const float* d1, const int* a1, const float* d2, const int* a2,
            const float* dnew, const unsigned char* stale, int cid,
            long long n, long long n_valid, double* partials, double* out,
            unsigned int* ticket, void* stream) {
  pam_eval_kernel<<<n_blocks(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      d1, a1, d2, a2, dnew, stale, cid, n_valid, partials, out, ticket);
  return static_cast<int>(cudaGetLastError());
}

int pt_commit(float* d1, int* a1, float* d2, int* a2, const float* dnew,
              unsigned char* stale, int cid, long long n, long long n_valid,
              void* stream) {
  pam_commit_kernel<<<n_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      d1, a1, d2, a2, dnew, stale, cid, n, n_valid);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
