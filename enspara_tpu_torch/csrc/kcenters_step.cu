// Tri-skip k-centers step: Gonzalez farthest-point iterations by QCP
// RMSD over frames stored frame-minor, one launch per iteration.
//
// Replaces three TPU kernels of the JAX package:
//   enspara_tpu/ops/kcenters_skip_pallas.py :: kcenters_chunk_skip_pallas
//   enspara_tpu/ops/kcenters_chunk_pallas.py :: kcenters_chunk_pallas
//     (the same loop without skipping; here the skip=0 switch)
//   enspara_tpu/ops/kcenters_skip_pallas.py :: kcenters_iteration_skip_pallas
//     (kc_iter_skip: one iteration of one shard of the sharded loop,
//     against a center chosen across the shards; the TPU kernel's
//     sequential grid and hand double-buffered frame DMA become one
//     block per tile, and its in-kernel argmax the last block's)
//
// Layout (the JAX package's, unchanged): frames (3*a_pad, n_pad) fp32
// or bf16, row i*a_pad + a holds coordinate i of atom a, the frame axis
// is the minor one. g, dist: (n_pad,) fp32; assig: (n_pad,) int32; tmax:
// (n_tiles,) fp32, the max of dist over each tile of `tile` frames.
// Padding frames carry g = 1 and dist = -inf, so the strict-< update
// never touches them and they never win the argmax.
//
// What bounds it on an H100: each iteration streams the whole frame
// array once. At 1M frames x 64 atoms that is 768 MB in fp32, about
// 0.23 ms at 3.35 TB/s (384 MB in bf16, about 0.12 ms), against about
// 0.7 GFLOP of fp32 FMA (9 multiply-adds per atom row plus a ~300-flop
// Newton epilogue per frame), about 0.01 ms at 67 TFLOP/s. So the
// kernel is bound by device-memory bandwidth. What the design does
// about it:
//   * one thread per frame and one block per tile: every row load is
//     a coalesced read (4 bytes a lane in fp32, 2 in bf16, upconverted
//     at load), and the 9 S sums stay in registers; nothing but the
//     distance state is written back;
//   * the bf16 frame stream (the TPU kernels' bf16 mode) halves the
//     frame bytes; every kernel here is a template on the frame type,
//     with a float and a bf16 entry point, and all arithmetic stays
//     fp32, so skip and no-skip stay bit-identical in either type;
//   * the center column sits in shared memory (3*a_pad floats), copied
//     once per block from a contiguous buffer that the previous
//     iteration's last block filled, so no block does a strided gather;
//   * tri-skip: a block whose tile max is <= md/2 (md finite) reads no
//     frames at all. Every existing center is >= md from the new one
//     (md is the global max distance that chose it), so by the triangle
//     inequality no frame of such a tile can move; its tmax entry stays
//     exact because its distances do not change;
//   * the iteration boundary (global first-max argmax, column copy,
//     G = sum(col^2) in the ingest's order, stop test) runs in the last
//     block to finish,
//     found with a __threadfence + atomic ticket, so an iteration is one
//     launch and the host syncs once per chunk, not once per center.
// kc_iter_skip streams one shard the same way, with the same skip rule
// and the same last-block argmax; the per-frame arithmetic and the
// argmax are kcenters_common.cuh's, shared with qcp_update.cu. Making
// it faster (a persistent kernel, a CUDA graph over a chunk, two frames
// a thread in bf16) is later work.
//
// The QCP epilogue (qcp_rmsd.cuh) divides exactly; build without
// --use_fast_math.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "kcenters_common.cuh"

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

// Iteration boundary, run by one whole block: stop test for the center
// (gidx, md) as ordinal i; if it is placed, copy its column (upconverted
// to fp32), its G = sum(col^2) of that column and the iteration's
// skippable-tile count. ctr and skipcnt come in filled with -1, which is
// what a stopped slot keeps.
//
// G adds the squares atom by atom, x y z, each product and sum rounded
// on its own: the order in which the ingest sums a frame's G
// (cluster/engine.py :: _ingest). So the center's G here is its prepared
// G bit for bit, the number the sharded loop reads, and the two loops
// measure every frame against the same gsum.
template <typename T>
__device__ void place_center(const T* __restrict__ frames, long long n_pad,
                             int rows, const float* tmax, int n_tiles,
                             float* col, KcState* st, int* ctr, int* skipcnt,
                             int ik, int gidx, float md, int i,
                             int* iscratch) {
  const bool stop = (md <= st->cutoff) || (i >= st->n_total);
  if (stop) {
    if (threadIdx.x == 0) st->stopped = 1;
    return;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    col[r] = to_float(frames[(long long)r * n_pad + gidx]);
  __syncthreads();
  float gsq = 0.0f;
  if (threadIdx.x == 0) {
    const int a_pad = rows / 3;
    for (int a = 0; a < a_pad; ++a)
      for (int j = 0; j < 3; ++j) {
        const float v = col[j * a_pad + a];
        gsq = __fadd_rn(gsq, __fmul_rn(v, v));
      }
  }
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
template <typename T>
__global__ void kc_begin_kernel(const T* __restrict__ frames, long long n_pad,
                                int rows, const float* tmax, int n_tiles,
                                float* col, KcState* st, int* ctr,
                                int* skipcnt) {
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
               gidx, md, i, iscratch);
}

// One k-centers iteration over all tiles against the placed center.
// The last block to finish picks the next center and places it as
// iteration ik + 1 of the chunk.
template <typename T>
__global__ void kc_iter_kernel(const T* __restrict__ frames,
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
    const float d_new = frame_rmsd(frames, f, n_pad, a_pad, s_col,
                                   __ldg(g + f) + gc, n_atoms);
    float nd = dist[f];
    if (d_new < nd) {  // strict <: ties keep the older center
      nd = d_new;
      dist[f] = d_new;
      assig[f] = cid;
    }
    const float m = block_reduce(nd, -INFINITY, MaxOp(), fscratch);
    if (threadIdx.x == 0) tmax[tile] = m;
  }

  if (!last_block(&st->ticket, &s_last)) return;
  // the global first-max argmax (kcenters_skip_pallas.py:81-92)
  float m;
  const int gidx = first_argmax(tmax, dist, n_tiles, fscratch, iscratch, &m);
  if (threadIdx.x == 0) {
    st->gidx = gidx;
    st->md = m;
    st->i = cid + 1;
    st->ticket = 0u;
  }
  if (ik + 1 < n_iters)
    place_center(frames, n_pad, rows, tmax, n_tiles, col, st, ctr,
                 skipcnt, ik + 1, gidx, m, cid + 1, iscratch);
}

// One k-centers iteration of one shard against a center chosen across
// the shards (the sharded loop's building block). The center's column,
// G, ordinal and the global max distance md that chose it arrive in
// device memory. A tile whose max is <= md/2 (md finite) reads no
// frames and keeps its tmax: every existing center is >= md from the
// new one, wherever it lies, so no frame of such a tile can move. The
// last block to finish writes the shard's (max, first argmax) of the
// updated distances and the count of tiles skipped. counters is
// int32[2], {ticket, skipped}, zero between launches. With *stop != 0
// nothing is read or written but lmax = -inf, largmax = 0, skipcnt = 0.
template <typename T>
__global__ void kc_iter_skip_kernel(
    const T* __restrict__ frames, const float* __restrict__ g,
    float* dist, int* assig, float* tmax, const float* __restrict__ col,
    const float* g_center, const int* center_id, const float* md_p,
    const int* stop, float* lmax, int* largmax, int* skipcnt, int* counters,
    long long n_pad, int a_pad, int n_tiles, float n_atoms) {
  extern __shared__ float s_col[];  // 3 * a_pad floats
  __shared__ float fscratch[kMaxWarps];
  __shared__ int iscratch[kMaxWarps];
  __shared__ int s_last;

  if (*stop) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *lmax = -INFINITY;
      *largmax = 0;
      *skipcnt = 0;
    }
    return;
  }
  const float md = *md_p;
  const int tile = blockIdx.x;
  const int rows = 3 * a_pad;
  const long long f = (long long)tile * blockDim.x + threadIdx.x;

  const bool skipped = isfinite(md) && tmax[tile] <= 0.5f * md;
  if (!skipped) {
    const float gc = *g_center;
    const int cid = *center_id;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) s_col[r] = col[r];
    __syncthreads();
    const float d_new = frame_rmsd(frames, f, n_pad, a_pad, s_col,
                                   __ldg(g + f) + gc, n_atoms);
    float nd = dist[f];
    if (d_new < nd) {  // strict <: ties keep the older center
      nd = d_new;
      dist[f] = d_new;
      assig[f] = cid;
    }
    const float m = block_reduce(nd, -INFINITY, MaxOp(), fscratch);
    if (threadIdx.x == 0) tmax[tile] = m;
  } else if (threadIdx.x == 0) {
    atomicAdd(counters + 1, 1);  // ordered before the ticket by its fence
  }

  if (!last_block(reinterpret_cast<unsigned int*>(counters), &s_last)) return;
  float m;
  const int gidx = first_argmax(tmax, dist, n_tiles, fscratch, iscratch, &m);
  if (threadIdx.x == 0) {
    *lmax = m;
    *largmax = gidx;
    *skipcnt = atomicExch(counters + 1, 0);
    counters[0] = 0;
  }
}

// Run n_iters k-centers iterations: one begin launch, then one launch
// per iteration, all on `stream`. Allocates nothing and does not
// synchronise. Returns the first cudaError_t of the launches (0 = ok).
template <typename T>
int chunk(const T* frames, const float* g, float* dist, int* assig,
          float* tmax, float* col, int* state, int* ctr, int* skipcnt,
          long long n_pad, int a_pad, int tile, int n_iters, float n_atoms,
          int skip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KcState* st = reinterpret_cast<KcState*>(state);
  const int rows = 3 * a_pad;
  const int n_tiles = static_cast<int>(n_pad / tile);
  const size_t smem = static_cast<size_t>(rows) * sizeof(float);
  kc_begin_kernel<T><<<1, tile, 0, s>>>(frames, n_pad, rows, tmax, n_tiles,
                                        col, st, ctr, skipcnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int ik = 0; ik < n_iters; ++ik) {
    kc_iter_kernel<T><<<n_tiles, tile, smem, s>>>(
        frames, g, dist, assig, tmax, col, st, ctr, skipcnt, ik, n_iters,
        n_pad, a_pad, n_tiles, n_atoms, skip);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One sharded-loop iteration of one shard (kc_iter_skip_kernel): one
// launch on `stream`, one block of `tile` threads per tile. Allocates
// nothing, does not synchronise; returns the launch's cudaError_t.
template <typename T>
int iter_skip(const T* frames, const float* g, float* dist, int* assig,
              float* tmax, const float* col, const float* g_center,
              const int* center_id, const float* md, const int* stop,
              float* lmax, int* largmax, int* skipcnt, int* counters,
              long long n_pad, int a_pad, int tile, float n_atoms,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>(n_pad / tile);
  const size_t smem = static_cast<size_t>(3 * a_pad) * sizeof(float);
  kc_iter_skip_kernel<T><<<n_tiles, tile, smem, s>>>(
      frames, g, dist, assig, tmax, col, g_center, center_id, md, stop, lmax,
      largmax, skipcnt, counters, n_pad, a_pad, n_tiles, n_atoms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The entry points: kc_chunk and kc_iter_skip read fp32 frames, the
// _bf16 twins bf16 frames; every other argument is the same.
int kc_chunk(const float* frames, const float* g, float* dist, int* assig,
             float* tmax, float* col, int* state, int* ctr, int* skipcnt,
             long long n_pad, int a_pad, int tile, int n_iters, float n_atoms,
             int skip, void* stream) {
  return chunk(frames, g, dist, assig, tmax, col, state, ctr, skipcnt, n_pad,
               a_pad, tile, n_iters, n_atoms, skip, stream);
}

int kc_chunk_bf16(const __nv_bfloat16* frames, const float* g, float* dist,
                  int* assig, float* tmax, float* col, int* state, int* ctr,
                  int* skipcnt, long long n_pad, int a_pad, int tile,
                  int n_iters, float n_atoms, int skip, void* stream) {
  return chunk(frames, g, dist, assig, tmax, col, state, ctr, skipcnt, n_pad,
               a_pad, tile, n_iters, n_atoms, skip, stream);
}

int kc_iter_skip(const float* frames, const float* g, float* dist, int* assig,
                 float* tmax, const float* col, const float* g_center,
                 const int* center_id, const float* md, const int* stop,
                 float* lmax, int* largmax, int* skipcnt, int* counters,
                 long long n_pad, int a_pad, int tile, float n_atoms,
                 void* stream) {
  return iter_skip(frames, g, dist, assig, tmax, col, g_center, center_id,
                   md, stop, lmax, largmax, skipcnt, counters, n_pad, a_pad,
                   tile, n_atoms, stream);
}

int kc_iter_skip_bf16(const __nv_bfloat16* frames, const float* g,
                      float* dist, int* assig, float* tmax, const float* col,
                      const float* g_center, const int* center_id,
                      const float* md, const int* stop, float* lmax,
                      int* largmax, int* skipcnt, int* counters,
                      long long n_pad, int a_pad, int tile, float n_atoms,
                      void* stream) {
  return iter_skip(frames, g, dist, assig, tmax, col, g_center, center_id,
                   md, stop, lmax, largmax, skipcnt, counters, n_pad, a_pad,
                   tile, n_atoms, stream);
}

const char* kc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
