// All-pairs minimum RMSD block by QCP: out[f, c] = RMSD of frame f to
// center c, both pre-centered, for every pair of an (F, C) block.
//
// Replaces the TPU kernel of the JAX package
//   enspara_tpu/ops/qcp_pallas.py :: qcp_rmsd_matrix_pallas
//     (_call_pallas, _kernel): nine (TF, N) x (N, TC) contractions for
//     the S components, the Newton epilogue, only the (TF, TC) block
//     written back.
//
// Layout: frames (3*a_pad, f_pad) and centers (3*a_pad, c_pad) fp32,
// row i*a_pad + a holds coordinate i of atom a, the structure axis is
// the minor one (the k-centers layout of this package); gf (f_pad,),
// gc (c_pad,) the G values (sum of squares); out (f_pad, c_pad) fp32,
// row-major. a_pad is a multiple of 8, f_pad and c_pad multiples of 64.
// Padding atoms are zero; padding structures carry G = 1, so lam0 > 0,
// and their rows and columns are sliced away by the caller.
//
// What bounds it on an H100: arithmetic, not memory. Per pair it does
// 9 * a_pad fused multiply-adds plus a ~400-instruction Newton epilogue
// with 12 exact divisions, and it reads 3 * a_pad floats per structure
// once per 64-wide tile of the other side. At 1M frames x 256 centers x
// 64 atoms that is 3.0e11 flops of FMA against 0.8 GB read. Every
// product is an fp32 FMA (no TF32: reduced-precision passes were wrong
// by 8.6e-2, docs/performance.md:42). What the design does about it:
//   * a block owns 64 frames x 64 centers; 256 threads, each a 4 x 4
//     register tile of pairs, 9 accumulators per pair (144 registers);
//   * both tiles' coordinates are staged through shared memory 8 atoms
//     at a time with coalesced float4 loads of whole rows; per atom a
//     thread reads 6 float4 from shared memory for 144 FMAs;
//   * the epilogue runs in registers and each thread writes its 4 x 4
//     block as four float4 stores.
// Making it faster (double-buffered staging, a larger register tile, a
// persistent grid) is later work.
//
// The QCP epilogue (qcp_rmsd.cuh) divides exactly; build without
// --use_fast_math.

#include <cuda_runtime.h>

#include "qcp_rmsd.cuh"

namespace {

constexpr int kTileF = 64;     // frames per block
constexpr int kTileC = 64;     // centers per block
constexpr int kChunkA = 8;     // atoms staged per step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kR = 4;          // pairs per thread along each axis

// Stage rows i*a_pad + a0 .. a0+7 (i = 0, 1, 2), columns col0 .. col0+63
// of a (3*a_pad, ld) array into s[3][8][64], as float4.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long ld, int a_pad, int a0,
                                      long long col0,
                                      float (*s)[kChunkA][kTileF]) {
  constexpr int kQuads = kTileF / 4;
  for (int e = threadIdx.x; e < 3 * kChunkA * kQuads; e += kThreads) {
    const int row = e / kQuads, q = e % kQuads;
    const int i = row / kChunkA, a = row % kChunkA;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        src + (long long)(i * a_pad + a0 + a) * ld + col0) + q);
    reinterpret_cast<float4*>(&s[i][a][0])[q] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
qcp_matrix_kernel(const float* __restrict__ frames,
                  const float* __restrict__ gf, long long f_pad,
                  const float* __restrict__ centers,
                  const float* __restrict__ gc, int c_pad, int a_pad,
                  float n_atoms, float* __restrict__ out) {
  __shared__ __align__(16) float sF[3][kChunkA][kTileF];
  __shared__ __align__(16) float sC[3][kChunkA][kTileC];
  const int tx = threadIdx.x & 15;  // center group: centers 4*tx .. +3
  const int ty = threadIdx.x >> 4;  // frame group: frames 4*ty .. +3
  const long long f0 = (long long)blockIdx.x * kTileF;
  const long long c0 = (long long)blockIdx.y * kTileC;

  float acc[kR][kR][9];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kR; ++c)
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[r][c][k] = 0.0f;

  for (int a0 = 0; a0 < a_pad; a0 += kChunkA) {
    stage(frames, f_pad, a_pad, a0, f0, sF);
    stage(centers, c_pad, a_pad, a0, c0, sC);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kChunkA; ++a) {
      const float4 fx = reinterpret_cast<const float4*>(&sF[0][a][0])[ty];
      const float4 fy = reinterpret_cast<const float4*>(&sF[1][a][0])[ty];
      const float4 fz = reinterpret_cast<const float4*>(&sF[2][a][0])[ty];
      const float4 cx = reinterpret_cast<const float4*>(&sC[0][a][0])[tx];
      const float4 cy = reinterpret_cast<const float4*>(&sC[1][a][0])[tx];
      const float4 cz = reinterpret_cast<const float4*>(&sC[2][a][0])[tx];
      const float f[3][kR] = {{fx.x, fx.y, fx.z, fx.w},
                              {fy.x, fy.y, fy.z, fy.w},
                              {fz.x, fz.y, fz.z, fz.w}};
      const float g[3][kR] = {{cx.x, cx.y, cx.z, cx.w},
                              {cy.x, cy.y, cy.z, cy.w},
                              {cz.x, cz.y, cz.z, cz.w}};
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kR; ++c)
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              acc[r][c][3 * i + j] =
                  fmaf(f[i][r], g[j][c], acc[r][c][3 * i + j]);
    }
    __syncthreads();
  }

  const float4 gcv = __ldg(reinterpret_cast<const float4*>(gc + c0) + tx);
  const float gcs[kR] = {gcv.x, gcv.y, gcv.z, gcv.w};
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long fr = f0 + kR * ty + r;
    const float gfr = __ldg(gf + fr);
    float d[kR];
#pragma unroll
    for (int c = 0; c < kR; ++c)
      d[c] = qcp_rmsd(acc[r][c], gfr + gcs[c], n_atoms);
    reinterpret_cast<float4*>(out + fr * c_pad + c0)[tx] =
        make_float4(d[0], d[1], d[2], d[3]);
  }
}

}  // namespace

extern "C" {

// Write the (f_pad, c_pad) RMSD block on `stream`: one launch of
// (f_pad / 64) x (c_pad / 64) blocks. Allocates nothing and does not
// synchronise. Returns the cudaError_t of the launch (0 = ok).
int qcp_matrix(const float* frames, const float* gf, long long f_pad,
               const float* centers, const float* gc, int c_pad, int a_pad,
               float n_atoms, float* out, void* stream) {
  const dim3 grid(static_cast<unsigned int>(f_pad / kTileF),
                  static_cast<unsigned int>(c_pad / kTileC));
  qcp_matrix_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, gf, f_pad, centers, gc, c_pad, a_pad, n_atoms, out);
  return static_cast<int>(cudaGetLastError());
}

const char* qcp_matrix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
