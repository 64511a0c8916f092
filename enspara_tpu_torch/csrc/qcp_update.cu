// One k-centers iteration against a given center: the RMSD of every
// frame to the center by QCP, the strict-< min update of (dist, assig),
// and optionally the (max, first argmax) of the updated distances.
//
// Replaces the TPU kernel
//   enspara_tpu/ops/qcp_update_pallas.py :: kcenters_iteration_pallas
// which serves the sharded k-centers loop with tri_skip=False.
//
// Layout (the JAX package's): frames (3*a_pad, n_pad) fp32 or bf16 (the
// TPU kernel's bf16 frame stream: qu_iteration_bf16), row i*a_pad + a
// holds coordinate i of atom a, the frame axis minor; g,
// dist (n_pad,) fp32; assig (n_pad,) int32; cvec (a_pad, 3) fp32, the
// center's coordinates; g_center, center_id and stop are one-element
// device buffers, so an iteration needs no host value.
//
// What bounds it on an H100: like the k-centers step, each call streams
// the whole frame array once (192 MB for one 250,112-frame shard of
// 64 atoms, about 0.057 ms at 3.35 TB/s; half of it in bf16) against
// ~0.1 GFLOP of fp32 FMA, so it is bound by device-memory bandwidth.
// What the design does about it: one thread per frame and one block per
// tile, coalesced row loads (4 bytes a lane, 2 in bf16, upconverted at
// load), the nine S sums in registers, the center staged once per block
// in shared memory. The TPU kernel carries a running per-lane
// max in VMEM across its sequential grid; blocks on Hopper run in no
// order, so here each block writes its tile max to a scratch row and the
// last block to finish (__threadfence + atomic ticket) takes the
// first-max argmax over the tiles, as the k-centers step does. The
// per-frame arithmetic is frame_rmsd of kcenters_common.cuh, shared with
// kcenters_step.cu, so this kernel and kc_iter_skip agree bit for bit
// when nothing is skipped.
//
// The QCP epilogue divides exactly (the TPU kernel uses an approximate
// reciprocal); build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#include "kcenters_common.cuh"

namespace {

// counters is int32[1], the ticket, zero between launches. With
// *stop != 0 nothing is read or written but, with_argmax, lmax = -inf
// and largmax = 0.
template <typename T>
__global__ void qu_iter_kernel(const T* __restrict__ frames,
                               const float* __restrict__ g, float* dist,
                               int* assig, const float* __restrict__ cvec,
                               const float* g_center, const int* center_id,
                               const int* stop, float* tmax, float* lmax,
                               int* largmax, int* counters, long long n_pad,
                               int a_pad, int n_tiles, float n_atoms,
                               int with_argmax) {
  extern __shared__ float s_col[];  // 3 * a_pad floats, row j*a_pad + a
  __shared__ float fscratch[kMaxWarps];
  __shared__ int iscratch[kMaxWarps];
  __shared__ int s_last;

  if (*stop) {
    if (with_argmax && blockIdx.x == 0 && threadIdx.x == 0) {
      *lmax = -INFINITY;
      *largmax = 0;
    }
    return;
  }
  const float gc = *g_center;
  const int cid = *center_id;
  const int tile = blockIdx.x;
  const int rows = 3 * a_pad;
  const long long f = (long long)tile * blockDim.x + threadIdx.x;

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int j = r / a_pad, a = r - j * a_pad;
    s_col[r] = cvec[a * 3 + j];
  }
  __syncthreads();
  const float d_new = frame_rmsd(frames, f, n_pad, a_pad, s_col,
                                 __ldg(g + f) + gc, n_atoms);
  float nd = dist[f];
  if (d_new < nd) {  // strict <: ties keep the older center
    nd = d_new;
    dist[f] = d_new;
    assig[f] = cid;
  }
  if (!with_argmax) return;
  const float m = block_reduce(nd, -INFINITY, MaxOp(), fscratch);
  if (threadIdx.x == 0) tmax[tile] = m;

  if (!last_block(reinterpret_cast<unsigned int*>(counters), &s_last)) return;
  float mx;
  const int gidx = first_argmax(tmax, dist, n_tiles, fscratch, iscratch, &mx);
  if (threadIdx.x == 0) {
    *lmax = mx;
    *largmax = gidx;
    counters[0] = 0;
  }
}

// One iteration: one launch on `stream`, one block of `tile` threads per
// tile. tmax is an n_pad / tile float scratch row (unused without
// argmax). Allocates nothing, does not synchronise; returns the launch's
// cudaError_t (0 = ok).
template <typename T>
int iteration(const T* frames, const float* g, float* dist, int* assig,
              const float* cvec, const float* g_center, const int* center_id,
              const int* stop, float* tmax, float* lmax, int* largmax,
              int* counters, long long n_pad, int a_pad, int tile,
              float n_atoms, int with_argmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>(n_pad / tile);
  const size_t smem = static_cast<size_t>(3 * a_pad) * sizeof(float);
  qu_iter_kernel<T><<<n_tiles, tile, smem, s>>>(
      frames, g, dist, assig, cvec, g_center, center_id, stop, tmax, lmax,
      largmax, counters, n_pad, a_pad, n_tiles, n_atoms, with_argmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qu_iteration reads fp32 frames, qu_iteration_bf16 bf16 frames; every
// other argument is the same.
int qu_iteration(const float* frames, const float* g, float* dist, int* assig,
                 const float* cvec, const float* g_center, const int* center_id,
                 const int* stop, float* tmax, float* lmax, int* largmax,
                 int* counters, long long n_pad, int a_pad, int tile,
                 float n_atoms, int with_argmax, void* stream) {
  return iteration(frames, g, dist, assig, cvec, g_center, center_id, stop,
                   tmax, lmax, largmax, counters, n_pad, a_pad, tile, n_atoms,
                   with_argmax, stream);
}

int qu_iteration_bf16(const __nv_bfloat16* frames, const float* g,
                      float* dist, int* assig, const float* cvec,
                      const float* g_center, const int* center_id,
                      const int* stop, float* tmax, float* lmax, int* largmax,
                      int* counters, long long n_pad, int a_pad, int tile,
                      float n_atoms, int with_argmax, void* stream) {
  return iteration(frames, g, dist, assig, cvec, g_center, center_id, stop,
                   tmax, lmax, largmax, counters, n_pad, a_pad, tile, n_atoms,
                   with_argmax, stream);
}

const char* qu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
