// Tri-skip k-centers step: Gonzalez farthest-point iterations by QCP
// RMSD over frames stored frame-minor, one launch per iteration.
//
// Replaces two TPU kernels of the JAX package:
//   enspara_tpu/ops/kcenters_skip_pallas.py :: kcenters_chunk_skip_pallas
//   enspara_tpu/ops/kcenters_chunk_pallas.py :: kcenters_chunk_pallas
//     (the same loop without skipping; here the skip=0 switch)
//
// Layout (the JAX package's, unchanged): frames (3*a_pad, n_pad) fp32,
// row i*a_pad + a holds coordinate i of atom a, the frame axis is the
// minor one. g, dist: (n_pad,) fp32; assig: (n_pad,) int32; tmax:
// (n_tiles,) fp32, the max of dist over each tile of `tile` frames.
// Padding frames carry g = 1 and dist = -inf, so the strict-< update
// never touches them and they never win the argmax.
//
// What bounds it on an H100: each iteration streams the whole frame
// array once. At 1M frames x 64 atoms that is 768 MB, about 0.23 ms at
// 3.35 TB/s, against about 0.7 GFLOP of fp32 FMA (9 multiply-adds per
// atom row plus a ~300-flop Newton epilogue per frame), about 0.01 ms
// at 67 TFLOP/s. So the kernel is bound by device-memory bandwidth.
// What the design does about it:
//   * one thread per frame and one block per tile: every row load is
//     a coalesced 4-byte-per-lane read, and the 9 S sums stay in
//     registers; nothing but the distance state is written back;
//   * the center column sits in shared memory (3*a_pad floats), copied
//     once per block from a contiguous buffer that the previous
//     iteration's last block filled, so no block does a strided gather;
//   * tri-skip: a block whose tile max is <= md/2 (md finite) reads no
//     frames at all. Every existing center is >= md from the new one
//     (md is the global max distance that chose it), so by the triangle
//     inequality no frame of such a tile can move; its tmax entry stays
//     exact because its distances do not change;
//   * the iteration boundary (global first-max argmax, column copy,
//     G = sum(col^2), stop test) runs in the last block to finish,
//     found with a __threadfence + atomic ticket, so an iteration is one
//     launch and the host syncs once per chunk, not once per center.
// Making it faster (a persistent kernel, a CUDA graph over a chunk, a
// bf16 frame stream) is later work.
//
// The QCP epilogue (qcp_rmsd.cuh) divides exactly; build without
// --use_fast_math.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "qcp_rmsd.cuh"

namespace {

// The scalar block shared by every launch of a chunk: int32[8] on the
// device, laid out as in enspara_tpu_torch/ops/kcenters_step.py.
struct KcState {
  int gidx;              // frame index of the current center candidate
  float md;              // its distance: the global max of dist
  float gc;              // G (sum of squares) of the placed center
  int i;                 // global ordinal of the center being placed
  int n_total;           // center budget
  float cutoff;          // stop once md <= cutoff
  int stopped;
  unsigned int ticket;   // blocks finished in this launch
};

constexpr int kMaxWarps = 32;

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinIntOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct SumIntOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Reduce over the whole block; every thread gets the result. blockDim
// is a multiple of 32. The leading __syncthreads lets calls follow
// each other on the same scratch.
template <typename T, typename Op>
__device__ T block_reduce(T v, T identity, Op op, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < n_warps ? scratch[lane] : identity;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Iteration boundary, run by one whole block: stop test for the center
// (gidx, md) as ordinal i; if it is placed, copy its column, its G and
// the iteration's skippable-tile count. ctr and skipcnt come in filled
// with -1, which is what a stopped slot keeps.
__device__ void place_center(const float* __restrict__ frames, long long n_pad,
                             int rows, const float* tmax, int n_tiles,
                             float* col, KcState* st, int* ctr, int* skipcnt,
                             int ik, int gidx, float md, int i,
                             float* fscratch, int* iscratch) {
  const bool stop = (md <= st->cutoff) || (i >= st->n_total);
  if (stop) {
    if (threadIdx.x == 0) st->stopped = 1;
    return;
  }
  float gsq = 0.0f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float v = frames[(long long)r * n_pad + gidx];
    col[r] = v;
    gsq += v * v;
  }
  gsq = block_reduce(gsq, 0.0f, SumOp(), fscratch);
  // the same rule the blocks apply, counted over every tile
  const bool finite = isfinite(md);
  int cnt = 0;
  for (int j = threadIdx.x; j < n_tiles; j += blockDim.x)
    cnt += (finite && __ldcg(tmax + j) <= 0.5f * md) ? 1 : 0;
  cnt = block_reduce(cnt, 0, SumIntOp(), iscratch);
  if (threadIdx.x == 0) {
    st->gc = gsq;
    ctr[ik] = gidx;
    skipcnt[ik] = cnt;
  }
}

// Chunk start: clear the stop flag and place the chunk's first center,
// the (gidx, md) the caller or the previous chunk left in the state.
__global__ void kc_begin_kernel(const float* __restrict__ frames, long long n_pad,
                                int rows, const float* tmax, int n_tiles,
                                float* col, KcState* st, int* ctr,
                                int* skipcnt) {
  __shared__ float fscratch[kMaxWarps];
  __shared__ int iscratch[kMaxWarps];
  const int gidx = st->gidx;
  const float md = st->md;
  const int i = st->i;
  __syncthreads();
  if (threadIdx.x == 0) {
    st->stopped = 0;
    st->ticket = 0u;
  }
  place_center(frames, n_pad, rows, tmax, n_tiles, col, st, ctr, skipcnt, 0,
               gidx, md, i, fscratch, iscratch);
}

// One k-centers iteration over all tiles against the placed center.
// The last block to finish picks the next center and places it as
// iteration ik + 1 of the chunk.
__global__ void kc_iter_kernel(const float* __restrict__ frames,
                               const float* __restrict__ g, float* dist,
                               int* assig, float* tmax, float* col,
                               KcState* st,
                               int* ctr, int* skipcnt, int ik, int n_iters,
                               long long n_pad, int a_pad, int n_tiles,
                               float n_atoms, int skip) {
  extern __shared__ float s_col[];  // 3 * a_pad floats
  __shared__ float fscratch[kMaxWarps];
  __shared__ int iscratch[kMaxWarps];
  __shared__ int s_last;

  if (st->stopped) return;  // the same value for every block
  const float md = st->md;
  const float gc = st->gc;
  const int cid = st->i;
  const int tile = blockIdx.x;
  const int rows = 3 * a_pad;
  const long long f = (long long)tile * blockDim.x + threadIdx.x;

  const bool skipped = skip && md < INFINITY && tmax[tile] <= 0.5f * md;
  if (!skipped) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) s_col[r] = col[r];
    __syncthreads();
    float S[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = 0.0f;
    const float* px = frames + f;
    const float* py = px + (long long)a_pad * n_pad;
    const float* pz = py + (long long)a_pad * n_pad;
#pragma unroll 4
    for (int a = 0; a < a_pad; ++a) {
      const long long off = (long long)a * n_pad;
      const float x = __ldg(px + off), y = __ldg(py + off), z = __ldg(pz + off);
      const float cx = s_col[a], cy = s_col[a_pad + a], cz = s_col[2 * a_pad + a];
      S[0] += x * cx; S[1] += x * cy; S[2] += x * cz;
      S[3] += y * cx; S[4] += y * cy; S[5] += y * cz;
      S[6] += z * cx; S[7] += z * cy; S[8] += z * cz;
    }
    const float d_new = qcp_rmsd(S, __ldg(g + f) + gc, n_atoms);
    float nd = dist[f];
    if (d_new < nd) {  // strict <: ties keep the older center
      nd = d_new;
      dist[f] = d_new;
      assig[f] = cid;
    }
    const float m = block_reduce(nd, -INFINITY, MaxOp(), fscratch);
    if (threadIdx.x == 0) tmax[tile] = m;
  }

  // last-block ticket: publish this block's writes, then count it in
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&st->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // global first-max argmax, the np.argmax tie-break: the max over the
  // tile maxima, the smallest tile holding it, then the smallest lane
  // of that tile (kcenters_skip_pallas.py:81-92). __ldcg reads through
  // L2, where the other blocks' writes are.
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n_tiles; j += blockDim.x)
    m = fmaxf(m, __ldcg(tmax + j));
  m = block_reduce(m, -INFINITY, MaxOp(), fscratch);
  int win = INT_MAX;
  for (int j = threadIdx.x; j < n_tiles; j += blockDim.x)
    if (__ldcg(tmax + j) == m) { win = j; break; }
  win = block_reduce(win, INT_MAX, MinIntOp(), iscratch);
  if (win == INT_MAX) win = 0;  // only when every distance is NaN
  const long long base = (long long)win * blockDim.x;
  int lane = __ldcg(dist + base + threadIdx.x) == m ? (int)threadIdx.x : INT_MAX;
  lane = block_reduce(lane, INT_MAX, MinIntOp(), iscratch);
  if (lane == INT_MAX) lane = 0;
  const int gidx = (int)(base + lane);

  if (threadIdx.x == 0) {
    st->gidx = gidx;
    st->md = m;
    st->i = cid + 1;
    st->ticket = 0u;
  }
  if (ik + 1 < n_iters)
    place_center(frames, n_pad, rows, tmax, n_tiles, col, st, ctr,
                 skipcnt, ik + 1, gidx, m, cid + 1, fscratch, iscratch);
}

}  // namespace

extern "C" {

// Run n_iters k-centers iterations: one begin launch, then one launch
// per iteration, all on `stream`. Allocates nothing and does not
// synchronise. Returns the first cudaError_t of the launches (0 = ok).
int kc_chunk(const float* frames, const float* g, float* dist, int* assig,
             float* tmax, float* col, int* state, int* ctr, int* skipcnt,
             long long n_pad, int a_pad, int tile, int n_iters, float n_atoms,
             int skip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KcState* st = reinterpret_cast<KcState*>(state);
  const int rows = 3 * a_pad;
  const int n_tiles = static_cast<int>(n_pad / tile);
  const size_t smem = static_cast<size_t>(rows) * sizeof(float);
  kc_begin_kernel<<<1, tile, 0, s>>>(frames, n_pad, rows, tmax, n_tiles, col,
                                     st, ctr, skipcnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int ik = 0; ik < n_iters; ++ik) {
    kc_iter_kernel<<<n_tiles, tile, smem, s>>>(frames, g, dist, assig, tmax,
                                               col, st, ctr, skipcnt, ik,
                                               n_iters, n_pad, a_pad, n_tiles,
                                               n_atoms, skip);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* kc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
