// All-pairs minimum RMSD block by QCP: out[f, c] = RMSD of frame f to
// center c, both pre-centered, for every pair of an (F, C) block.
//
// Replaces the TPU kernel of the JAX package
//   enspara_tpu/ops/qcp_pallas.py :: qcp_rmsd_matrix_pallas
//     (_call_pallas, _kernel): nine (TF, N) x (N, TC) contractions for
//     the S components on the matrix unit at Precision.HIGHEST, the
//     Newton epilogue, only the (TF, TC) block written back.
//
// Out: the RMSD; where the root lies near a double root of the quartic
// (~5e-5 of unit-normal pairs) the kernel stores it negated and a second
// kernel, qcp_matrix_kernel_finish, computes the pair again in double
// (its name extends the first's: a profile that counts kernel 5's time
// by name counts both).
//
// Layout: frames (3*a_pad, f_pad) and centers (3*a_pad, c_pad) fp32,
// row i*a_pad + a holds coordinate i of atom a, the structure axis is
// the minor one (the k-centers layout of this package); gf (f_pad,),
// gc (c_pad,) the G values (sum of squares); out (f_pad, c_pad) fp32,
// row-major. a_pad is a multiple of 8, f_pad and c_pad multiples of 64.
// Padding atoms are zero; padding structures carry G = 1, so lam0 > 0,
// and their rows and columns are sliced away by the caller.
//
// What bounds it on an H100: arithmetic. Per pair the nine contractions
// are 18 * a_pad flops, and the Newton epilogue (qcp_rmsd.cuh) 355 fp32
// operations (chip_smoke.py :: QCP_EPILOGUE_OPS) with 14 exact divisions
// and two square roots; it reads
// 3 * a_pad floats per structure once per tile of the other side. At 1M
// frames x 256 centers x 64 atoms the epilogue alone is 8.9e10 fp32
// operations against 0.8 GB read. The design:
//   * the contraction runs on the tensor cores, as the TPU kernel runs
//     it on the matrix unit: S_ij[f, c] = sum_a F_i[a, f] C_j[a, c] as
//     mma.m16n8k8 TF32 products in 3xTF32 (mma_tf32.cuh), each operand
//     split into hi + lo as it leaves shared memory, which keeps about
//     2^-21 of each product (a single TF32 or bf16 pass does not);
//   * a tile is 64 frames x 32 centers for a group of 8 warps, 16 x 16
//     pairs a warp; a warp runs all nine (i, j) products on its pairs,
//     so the nine accumulators of a pair share one fragment position and
//     each thread holds all nine S components of its own 8 pairs (72
//     registers): the epilogue needs no shuffle and no shared memory;
//   * a group stages frames and centers 16 atoms (two k-steps) at a time
//     with cp.async into its own 3-stage ring, one named barrier a step;
//     the row pitch (tile + 8 words) makes every fragment load
//     conflict-free; a last chunk past a_pad is zero-filled;
//   * a persistent block of two groups (512 threads, 128 registers, no
//     spills) per SM. The groups take turns on the tensor cores, so one
//     group's Newton epilogue runs beside the other's contraction; the
//     hand-over also fences a group's ring between its tiles. The turns
//     gain at most 2% over groups that run freely (chip_ablate_qcp.py);
//     one tile a 256-thread block, two blocks an SM, spilled and ran
//     slower;
//   * tiles are numbered center tile first, so the tiles of one frame
//     tile run together and its frames come from HBM once;
//   * each thread stores its results as 8-byte pairs of neighbouring
//     centers; a warp's store fills whole 32-byte sectors.
// The narrow 64-center blocks of PAM are two center tiles, not padded.
// Next for speed: wgmma (the contraction is ~3/5 of the time, mma.sync
// reaching about half the TF32 peak), PERF.md.
//
// The QCP epilogue (qcp_rmsd.cuh) divides exactly; build without
// --use_fast_math.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "qcp_rmsd.cuh"

namespace {

constexpr int kTileF = 64;      // frames per tile
constexpr int kTileC = 32;      // centers per tile
constexpr int kChunkA = 16;     // atoms per stage: two mma k-steps
constexpr int kStages = 3;
constexpr int kWarpsF = 4;      // warps along the frames of a tile
constexpr int kGroupThreads = 32 * kWarpsF * (kTileC / 16);  // a tile's
constexpr int kThreads = 2 * kGroupThreads;                  // two groups
// named barriers: 1 + group for a group's staging ring, 3 + group for
// the hand-over of the tensor cores to that group
constexpr int kRingBar = 1, kTokenBar = 3;
// row pitch of a staged tile: = 8 mod 32 words, so the 32 lanes of a
// fragment load (atom t or t + 4 of a k-step, structure g) hit 32 banks
constexpr int kPitchF = kTileF + 8;
constexpr int kPitchC = kTileC + 8;

struct Stage {
  float F[3][kChunkA][kPitchF];
  float C[3][kChunkA][kPitchC];
};
constexpr int kSmemBytes = 2 * kStages * sizeof(Stage);
constexpr int kFinishThreads = 256;  // a block of qcp_matrix_kernel_finish

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Issue the copies of rows i*a_pad + a0 .. a0 + kChunkA - 1 (i = 0, 1,
// 2), columns col0 .. col0 + width - 1, of a (3*a_pad, ld) array into
// dst[3 * kChunkA][pitch], 16 bytes a copy, by the group's threads.
template <int width, int pitch>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long ld, int a_pad, int a0,
                                      long long col0, float* dst, int tid) {
  constexpr int kQuads = width / 4;
  for (int e = tid; e < 3 * kChunkA * kQuads; e += kGroupThreads) {
    const int r = e / kQuads, q = e % kQuads;
    const int i = r / kChunkA, a = a0 + r % kChunkA;
    // atoms past a_pad (the last chunk when kChunkA does not divide it)
    // are filled with zeros, which add nothing to S
    cp_async16(dst + r * pitch + 4 * q,
               src + (long long)(i * a_pad + min(a, a_pad - 1)) * ld + col0 +
                   4 * q,
               a < a_pad);
  }
}

__device__ __forceinline__ void stage_step(
    const float* __restrict__ frames, long long f_pad,
    const float* __restrict__ centers, int c_pad, int a_pad, int s,
    long long f0, long long c0, Stage& st, int tid) {
  stage<kTileF, kPitchF>(frames, f_pad, a_pad, s * kChunkA, f0,
                         &st.F[0][0][0], tid);
  stage<kTileC, kPitchC>(centers, c_pad, a_pad, s * kChunkA, c0,
                         &st.C[0][0][0], tid);
}

// acc[3i + j][n-tile][fragment element] = S_ij of the thread's 8 pairs
// in the tile at (f0, c0): the warp's 16 frames wf.. and 16 centers wc..
__device__ __forceinline__ void contract(
    const float* __restrict__ frames, long long f_pad,
    const float* __restrict__ centers, int c_pad, int a_pad, long long f0,
    long long c0, Stage* ring, int tid, int ring_bar, int wf, int wc,
    int g, int t, float (&acc)[9][2][4]) {
#pragma unroll
  for (int q = 0; q < 9; ++q)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.0f;

  const int steps = (a_pad + kChunkA - 1) / kChunkA;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      stage_step(frames, f_pad, centers, c_pad, a_pad, s, f0, c0, ring[s],
                 tid);
    cp_async_commit();  // empty groups too: the wait count stays uniform
  }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step s landed
    bar_sync(ring_bar, kGroupThreads);  // the group's; and step s - 1's
                                        // readers are done
    const int next = s + kStages - 1;
    if (next < steps)
      stage_step(frames, f_pad, centers, c_pad, a_pad, next, f0, c0,
                 ring[next % kStages], tid);
    cp_async_commit();

    const Stage& st = ring[s % kStages];
#pragma unroll
    for (int k0 = 0; k0 < kChunkA; k0 += 8) {  // the chunk's k-steps
      uint32_t b_hi[3][2][2], b_lo[3][2][2];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = wc + 8 * nt + g;
          split_tf32(st.C[j][k0 + t][c], b_hi[j][nt][0], b_lo[j][nt][0]);
          split_tf32(st.C[j][k0 + t + 4][c], b_hi[j][nt][1],
                     b_lo[j][nt][1]);
        }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        uint32_t a_hi[4], a_lo[4];
        split_tf32(st.F[i][k0 + t][wf + g], a_hi[0], a_lo[0]);
        split_tf32(st.F[i][k0 + t][wf + g + 8], a_hi[1], a_lo[1]);
        split_tf32(st.F[i][k0 + t + 4][wf + g], a_hi[2], a_lo[2]);
        split_tf32(st.F[i][k0 + t + 4][wf + g + 8], a_hi[3], a_lo[3]);
        // 3xTF32, the small terms first; the six products of a pass are
        // independent, so no mma waits on the one before it
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_tf32(acc[3 * i + j][nt], a_lo, b_hi[j][nt]);
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_tf32(acc[3 * i + j][nt], a_hi, b_lo[j][nt]);
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_tf32(acc[3 * i + j][nt], a_hi, b_hi[j][nt]);
      }
    }
  }
}

// The Newton epilogue of the thread's 8 pairs and their stores: element
// e of n-tile nt is frame wf + g + 8 * (e / 2), center
// wc + 8 * nt + 2 * t + e % 2 of the tile. A pair near a double root of
// the quartic is stored negated (qcp_rmsd.cuh).
__device__ __forceinline__ void finish(const float (&acc)[9][2][4],
                                       const float* __restrict__ gf,
                                       const float* __restrict__ gc,
                                       int c_pad, float n_atoms,
                                       float* __restrict__ out, long long fr,
                                       long long cw, int t) {
  const float gfr[2] = {__ldg(gf + fr), __ldg(gf + fr + 8)};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const long long cc = cw + 8 * nt + 2 * t;
    const float2 gcv = __ldg(reinterpret_cast<const float2*>(gc + cc));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float S[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) S[q] = acc[q][nt][2 * h + e2];
        bool near;
        d[e2] = qcp_rmsd_flagged(S, gfr[h] + (e2 ? gcv.y : gcv.x), n_atoms,
                                 near);
        d[e2] = near ? -d[e2] : d[e2];  // for the caller to finish
      }
      *reinterpret_cast<float2*>(out + (fr + 8 * h) * c_pad + cc) =
          make_float2(d[0], d[1]);
    }
  }
}

// A persistent block of two groups of 8 warps; each group computes one
// 64 x 32 tile at a time, group 0 the even tiles of the block's tile
// pairs and group 1 the odd ones. The groups take turns on the tensor
// cores: a group contracts only after the other has finished its
// contraction (the token barriers), so one group's Newton epilogue runs
// beside the other's contraction. Waiting for the token also holds a
// group's next copies until all its warps have left the previous tile.
__global__ void __launch_bounds__(kThreads, 1)
qcp_matrix_kernel(const float* __restrict__ frames,
                  const float* __restrict__ gf, long long f_pad,
                  const float* __restrict__ centers,
                  const float* __restrict__ gc, int c_pad, int a_pad,
                  float n_atoms, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;
  Stage* ring = reinterpret_cast<Stage*>(smem) + group * kStages;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wf = (warp % kWarpsF) * 16;  // the warp's frames in the tile
  const int wc = (warp / kWarpsF) * 16;  // its centers: two n-tiles of 8
  const int n_ct = c_pad / kTileC;
  const int n_tiles = static_cast<int>(f_pad / kTileF) * n_ct;
  const int n_pairs = (n_tiles + 1) / 2;

  int it = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, ++it) {
    // tiles numbered center tile first: the tiles of one frame tile run
    // together and its frames come from HBM once
    const int tile = 2 * p + group;
    const long long f0 = (long long)(tile / n_ct) * kTileF;
    const long long c0 = (long long)(tile % n_ct) * kTileC;
    if (group == 1 || it > 0)
      bar_sync(kTokenBar + group, kThreads);  // my turn on the tensor cores
    float acc[9][2][4];
    if (tile < n_tiles)
      contract(frames, f_pad, centers, c_pad, a_pad, f0, c0, ring, tid,
               kRingBar + group, wf, wc, g, t, acc);
    bar_arrive(kTokenBar + 1 - group, kThreads);  // the other group's turn
    if (tile < n_tiles)
      finish(acc, gf, gc, c_pad, n_atoms, out, f0 + wf + g, c0 + wc, t);
  }
  if (group == 0 && it > 0)
    bar_sync(kTokenBar, kThreads);  // group 1's last hand-over
}

// The pairs qcp_matrix_kernel stored negated, whose root lies near a
// double root of the QCP quartic (~5e-5 of unit-normal pairs), again in
// double: S summed in double from the layouts, then qcp_rmsd_double. A
// thread takes a float4 of out at a time; one without a negative entry
// costs its load.
__global__ void qcp_matrix_kernel_finish(const float* __restrict__ frames,
                                         const float* __restrict__ gf,
                                         long long f_pad,
                                         const float* __restrict__ centers,
                                         const float* __restrict__ gc,
                                         int c_pad, int a_pad, float n_atoms,
                                         float* __restrict__ out) {
  const long long n4 = f_pad * c_pad / 4;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < n4; k += (long long)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(out)[k];
    if (!(v.x < 0.0f || v.y < 0.0f || v.z < 0.0f || v.w < 0.0f)) continue;
    const float w[4] = {v.x, v.y, v.z, v.w};
    for (int e = 0; e < 4; ++e) {
      if (!(w[e] < 0.0f)) continue;
      const long long idx = 4 * k + e;
      const long long f = idx / c_pad, c = idx % c_pad;
      double S[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int a = 0; a < a_pad; ++a)
        for (int i = 0; i < 3; ++i) {
          const double x = frames[(long long)(i * a_pad + a) * f_pad + f];
          for (int j = 0; j < 3; ++j)
            S[3 * i + j] +=
                x * double(centers[(long long)(j * a_pad + a) * c_pad + c]);
        }
      out[idx] = qcp_rmsd_double(S, double(gf[f] + gc[c]), double(n_atoms));
    }
  }
}

}  // namespace

extern "C" {

// Write the (f_pad, c_pad) RMSD block on `stream`: one launch of at most
// one 512-thread block per SM, each looping over pairs of 64 x 32 tiles,
// then the finish of the pairs near a double root (one pass over the
// block). Allocates nothing and does not synchronise. Returns the
// cudaError_t of the launches (0 = ok).
int qcp_matrix(const float* frames, const float* gf, long long f_pad,
               const float* centers, const float* gc, int c_pad, int a_pad,
               float n_atoms, float* out, void* stream) {
  if (f_pad <= 0 || c_pad <= 0 || a_pad <= 0 || f_pad % 64 || c_pad % 64 ||
      a_pad % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qcp_matrix_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (f_pad / kTileF) * (c_pad / kTileC);
  if (tiles >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = (tiles + 1) / 2;
  const unsigned int blocks =
      static_cast<unsigned int>(pairs < sms ? pairs : sms);
  qcp_matrix_kernel<<<blocks, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      frames, gf, f_pad, centers, gc, c_pad, a_pad, n_atoms, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = f_pad * c_pad / 4;
  const long long want = (n4 + kFinishThreads - 1) / kFinishThreads;
  const unsigned int finish_blocks = static_cast<unsigned int>(
      want < 8LL * sms ? want : 8LL * sms);
  qcp_matrix_kernel_finish<<<finish_blocks, kFinishThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      frames, gf, f_pad, centers, gc, c_pad, a_pad, n_atoms, out);
  return static_cast<int>(cudaGetLastError());
}

const char* qcp_matrix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
