// Uniform-lattice SIPG stencil apply (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel hpdg_tpu/ops/pallas_uniform.py::
// pallas_uniform_sipg_operator.  It computes, for every element e of a
// full uniform 2D/3D lattice of one degree (C element order, last axis
// fastest):
//
//   y[e] = Tdiag[vid[e]] u[e]
//        + sum_ax ( has_p[ax,e] M12_ax u[e + s_ax] + has_m[ax,e] M21_ax u[e - s_ax] )
//
// with bs = (p+1)^dim values per element, u and y [n, bs] f32 row-major
// (no padding), and every matrix stored transposed (Mt[j][i] = M[i][j],
// so y[e] = u[e] @ Mt) as [bs][bs] f32.
//
// What bounds it on this card.  At p=4 in 3D (bs=125) each output value
// takes ~7*bs = 875 FMAs over 7 input rows that are shared by the whole
// tile, so the kernel is bound by FP32 FMA issue and by the shared-memory
// loads that feed it (one 32^3 apply is ~7.2 GFLOP on 16.4 MB of u).  At
// p=1 (bs=8) an output value takes only ~56 FMAs and the kernel is bound
// by the bytes it moves (7 neighbour rows read per row written).
//
// What the design does about it.
// * The host groups the elements by diagonal variant (which neighbours
//   exist; at most 3^dim variants) and cuts each group into tiles of
//   TE elements.  All elements of a tile share Tdiag and the neighbour
//   masks, so a tile runs exactly 1 + (present neighbours) block
//   products with no masked-out work: 7 at an interior element in 3D,
//   where the TPU kernel ran 13 masked GEMMs for every element.
// * Per product, the block stages the [bs, bs] matrix (62.5 KB at p=4)
//   and the TE source rows into shared memory, padded to multiples of 4
//   with zeros, so every inner-loop load is a 16-byte vector load.
// * Each thread owns a 4x4 register tile (4 elements x 4 output
//   columns): per 4 inner indices it loads 4 float4 matrix rows and 4
//   float4 input rows from shared memory for 64 FMAs.
// * Sums stay in f32 registers, IEEE FMAs on the CUDA cores; no TF32.
// * Every output row belongs to exactly one tile: no atomics and no
//   zero-fill of y, and the result does not depend on the launch order.
//
// Interface: a plain C function, bound with ctypes; it launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kRowsPerThread = 4;  // elements per thread
constexpr int kColsPerThread = 4;  // output columns per thread

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Elements per tile for block size bs; the host builds tiles of this size.
__host__ __device__ inline int tile_elems(int bs) {
  const int col_groups = round4(bs) / kColsPerThread;
  return (kThreads / col_groups) * kRowsPerThread;
}

__host__ inline size_t smem_bytes(int bs) {
  const int jp = round4(bs);
  const int te = tile_elems(bs);
  return sizeof(float) * ((size_t)jp * jp + (size_t)te * jp) + sizeof(int) * te;
}

__global__ void __launch_bounds__(kThreads)
uniform_stencil_kernel(const float* __restrict__ u, float* __restrict__ y,
                       const float* __restrict__ tdiag,
                       const float* __restrict__ mplus,
                       const float* __restrict__ mminus,
                       const int* __restrict__ tiles,
                       const int* __restrict__ elems,
                       const int* __restrict__ var_mask,
                       int bs, int dim, int s0, int s1, int s2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int jp = round4(bs);
  const int te = tile_elems(bs);
  float* ms = smem;                                  // [jp][jp] matrix
  float* us = ms + jp * jp;                          // [te][jp] source rows
  int* es = reinterpret_cast<int*>(us + te * jp);   // [te] element ids

  const int vid = tiles[3 * blockIdx.x];
  const int start = tiles[3 * blockIdx.x + 1];
  const int count = tiles[3 * blockIdx.x + 2];
  const int mask = var_mask[vid];  // bit 2*ax: +ax neighbour, 2*ax+1: -ax
  const int t = threadIdx.x;
  const int col_groups = jp / kColsPerThread;
  const int row_groups = kThreads / col_groups;
  const int tx = t % col_groups;  // output columns 4*tx .. 4*tx+3
  const int ty = t / col_groups;  // tile rows ty + r*row_groups
  const bool active = ty < row_groups;

  // zero padding once; the staging loops below only write the [bs] parts
  for (int i = t; i < jp * jp + te * jp; i += kThreads) smem[i] = 0.f;
  for (int r = t; r < te; r += kThreads) es[r] = r < count ? elems[start + r] : 0;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;

  const int nprod = 1 + 2 * dim;
  for (int k = 0; k < nprod; ++k) {
    const float* m;
    int shift;
    if (k == 0) {
      m = tdiag + (size_t)vid * bs * bs;
      shift = 0;
    } else {
      const int ax = (k - 1) >> 1;
      const int minus = (k - 1) & 1;
      // the mask is uniform over the tile: the whole block skips together
      if (!((mask >> (2 * ax + minus)) & 1)) continue;
      const int s = ax == 0 ? s0 : (ax == 1 ? s1 : s2);
      m = (minus ? mminus : mplus) + (size_t)ax * bs * bs;
      shift = minus ? -s : s;
    }
    __syncthreads();  // the previous product is done with ms/us
    for (int i = t; i < bs * bs; i += kThreads) {
      const int j = i / bs;
      ms[j * jp + (i - j * bs)] = m[i];
    }
    for (int i = t; i < count * bs; i += kThreads) {
      const int r = i / bs;
      us[r * jp + (i - r * bs)] = u[(size_t)(es[r] + shift) * bs + (i - r * bs)];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < jp; j += 4) {
        float4 mv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mv[q] = *reinterpret_cast<const float4*>(&ms[(j + q) * jp + kColsPerThread * tx]);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float4 uv =
              *reinterpret_cast<const float4*>(&us[(ty + r * row_groups) * jp + j]);
          acc[r][0] = fmaf(uv.x, mv[0].x, acc[r][0]);
          acc[r][1] = fmaf(uv.x, mv[0].y, acc[r][1]);
          acc[r][2] = fmaf(uv.x, mv[0].z, acc[r][2]);
          acc[r][3] = fmaf(uv.x, mv[0].w, acc[r][3]);
          acc[r][0] = fmaf(uv.y, mv[1].x, acc[r][0]);
          acc[r][1] = fmaf(uv.y, mv[1].y, acc[r][1]);
          acc[r][2] = fmaf(uv.y, mv[1].z, acc[r][2]);
          acc[r][3] = fmaf(uv.y, mv[1].w, acc[r][3]);
          acc[r][0] = fmaf(uv.z, mv[2].x, acc[r][0]);
          acc[r][1] = fmaf(uv.z, mv[2].y, acc[r][1]);
          acc[r][2] = fmaf(uv.z, mv[2].z, acc[r][2]);
          acc[r][3] = fmaf(uv.z, mv[2].w, acc[r][3]);
          acc[r][0] = fmaf(uv.w, mv[3].x, acc[r][0]);
          acc[r][1] = fmaf(uv.w, mv[3].y, acc[r][1]);
          acc[r][2] = fmaf(uv.w, mv[3].z, acc[r][2]);
          acc[r][3] = fmaf(uv.w, mv[3].w, acc[r][3]);
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = ty + r * row_groups;
    if (row >= count) continue;
    float* yr = y + (size_t)es[row] * bs;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = kColsPerThread * tx + c;
      if (col < bs) yr[col] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

// Elements per tile that the launcher expects for block size bs.
int hpdg_uniform_stencil_tile_elems(int bs) { return tile_elems(bs); }

// y = A u on `stream`.  tiles: [ntiles][3] (variant, start, count) into
// elems; elems: the element ids grouped by variant; var_mask[variant]:
// bit 2*ax = +ax neighbour present, bit 2*ax+1 = -ax neighbour present.
int hpdg_uniform_stencil_f32(const float* u, float* y, const float* tdiag,
                             const float* mplus, const float* mminus,
                             const int* tiles, const int* elems,
                             const int* var_mask, int ntiles, int bs, int dim,
                             int s0, int s1, int s2, void* stream) {
  if (bs < 1 || bs > 128 || dim < 1 || dim > 3 || ntiles < 0)
    return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(bs);
  cudaError_t err = cudaFuncSetAttribute(
      uniform_stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  uniform_stencil_kernel<<<ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      u, y, tdiag, mplus, mminus, tiles, elems, var_mask, bs, dim, s0, s1, s2);
  return (int)cudaGetLastError();
}

}  // extern "C"
