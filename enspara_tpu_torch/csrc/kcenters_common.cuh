// Device code shared by the k-centers kernels (kcenters_step.cu and
// qcp_update.cu): the block reductions, the per-frame RMSD to a center
// staged in shared memory, and the first-max argmax that the last block
// of a launch takes over the per-tile maxima.
//
// All three k-centers kernels compute a frame's distance with
// frame_rmsd, so they do the same arithmetic in the same order: the
// kernels of qcp_update.cu and the per-iteration kernel of
// kcenters_step.cu agree bit for bit when no tile is skipped.
//
// Frames are float or __nv_bfloat16 (the bf16 frame stream of the TPU
// kernels: half the bytes cross device memory). A bf16 coordinate is
// upconverted with __bfloat162float where it is loaded; S, G, the
// Newton epilogue and the distance state stay fp32, so the two types
// run the same arithmetic on the same (rounded) values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "qcp_rmsd.cuh"

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

// A frame coordinate as fp32: a read-only load through the texture
// path, bf16 upconverted (exactly) at load.
__device__ __forceinline__ float load_coord(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_coord(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// RMSD of frame f to the center column s_col (3 * a_pad floats, row
// i*a_pad + a, in shared memory); gsum = G(frame) + G(center). The nine
// S sums run over the atoms in order, each step one fused multiply-add,
// so every kernel that calls this rounds the same way. T is float or
// __nv_bfloat16.
template <typename T>
__device__ __forceinline__ float frame_rmsd(const T* __restrict__ frames,
                                            long long f, long long n_pad,
                                            int a_pad, const float* s_col,
                                            float gsum, float n_atoms) {
  float S[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k] = 0.0f;
  const T* px = frames + f;
  const T* py = px + (long long)a_pad * n_pad;
  const T* pz = py + (long long)a_pad * n_pad;
#pragma unroll 4
  for (int a = 0; a < a_pad; ++a) {
    const long long off = (long long)a * n_pad;
    const float x = load_coord(px + off), y = load_coord(py + off),
                z = load_coord(pz + off);
    const float cx = s_col[a], cy = s_col[a_pad + a], cz = s_col[2 * a_pad + a];
    S[0] = __fmaf_rn(x, cx, S[0]); S[1] = __fmaf_rn(x, cy, S[1]);
    S[2] = __fmaf_rn(x, cz, S[2]); S[3] = __fmaf_rn(y, cx, S[3]);
    S[4] = __fmaf_rn(y, cy, S[4]); S[5] = __fmaf_rn(y, cz, S[5]);
    S[6] = __fmaf_rn(z, cx, S[6]); S[7] = __fmaf_rn(z, cy, S[7]);
    S[8] = __fmaf_rn(z, cz, S[8]);
  }
  return qcp_rmsd(S, gsum, n_atoms);
}

// The first-max argmax of dist, run by one whole block after every
// other block's tmax and dist writes are visible: the max over the
// n_tiles tile maxima, the smallest tile holding it, then the smallest
// lane of that tile (the np.argmax tie-break). __ldcg reads through L2,
// where the other blocks' writes are. Returns the frame index and puts
// the max in *m_out (every thread).
__device__ int first_argmax(const float* tmax, const float* dist, int n_tiles,
                            float* fscratch, int* iscratch, float* m_out) {
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
  *m_out = m;
  return (int)(base + lane);
}

// Count this block in: publish its writes, then take a ticket. Returns
// true (in every thread) in the last block of the launch to finish.
__device__ bool last_block(unsigned int* ticket, int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_flag = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}
