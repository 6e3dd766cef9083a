// K1: the uniform-lattice SIPG stencil apply for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel hpdg_tpu/ops/pallas_uniform.py::
// pallas_uniform_sipg_operator (pl.pallas_call at :230).  For every
// element e of a full uniform 2D/3D lattice of one degree (C element
// order, last axis fastest) it computes
//
//   y[e] = Tdiag[vid[e]] u[e]
//        + sum_ax ( has_p[ax,e] M12_ax u[e + s_ax] + has_m[ax,e] M21_ax u[e - s_ax] )
//
// with bs = (p+1)^dim values per element and u, y f32 [n, bs] row-major
// without padding.  Every matrix is stored transposed (Mt[j][i] = M[i][j],
// so y[e] = u[e] @ Mt) and zero-padded by the host (see kernel_layout).
//
// What bounds it on this card.  An element costs (1 + present
// neighbours) bs^2 FMAs on 2 bs floats of u and y.  A 32^3 apply is
//   bs = 125 (3D p=4): 6.98 GFLOP on 35 MB, FP32-FMA bound (104 us at
//                      67 TFLOP/s against 10 us of HBM traffic);
//   bs = 27  (p=2):    0.33 GFLOP on 7 MB, FMA 4.9 us against HBM 2.1 us;
//   bs = 8   (p=1):    2.1 MB, HBM 0.6 us: launch latency in practice.
//
// What the design does about it.
// * The host groups the elements by diagonal variant and cuts each group
//   into tiles.  All elements of a tile share Tdiag and the neighbour
//   set, so a tile is one GEMM
//     y_tile = [u(e) | u(e+s0) | u(e-s0) | ...] . [Tdiag_v; M12_0; M21_0; ...]
//   with K = (1 + present neighbours) bs.  Every output row belongs to
//   one tile: no atomics, no zero-fill of y, and the result does not
//   depend on the launch order.
// * bs = 125, and every bs <= 128 but 27 and 8 (stencil_gemm_kernel): a
//   register-tiled f32 GEMM of 128 elements x 128 columns per block of
//   256 threads.  K streams in chunks of 32 through a 3-stage ring of
//   shared memory filled by cp.async, one barrier per chunk, so the next
//   chunks are in flight while one is multiplied.  B, the stored matrices
//   (zero-padded on the host to K = 128 rows and 128 columns, never in u),
//   is copied in 16-byte pieces and read once per 128 elements.  A goes
//   straight to its k-major place by 4-byte cp.async: one copy
//   instruction reads 32 contiguous bytes of each of 4 rows and writes 32
//   distinct banks, so u's unaligned rows (500 B at p=4) need neither a
//   per-element division nor an aligned staging copy and a transpose (on
//   the card that staging was the slower of the two).  A thread holds an
//   8x8 register tile; a k-step is 2 + 2 LDS.128 for 64 FMAs, and A's are
//   quarter-warp uniform, the cheap case of the shared-memory pipe.  A
//   persistent grid of the resident blocks (two per SM) takes the tiles
//   round-robin.  Short tiles (32 elements or fewer: edges, corners) come
//   first, and split K over the four warp rows instead of idling three,
//   adding the partial sums in a fixed order.
// * bs = 27 and 8 (stencil_small_kernel): a variant's 1 + 2 dim matrices
//   fit in shared memory, so one thread computes one element.  A block
//   loads the neighbour couplings once, walks a contiguous range of
//   tiles, reloads Tdiag only where the variant changes, and reads each
//   neighbour row through L1 and L2 as its aligned 16-byte cover.
// * Sums stay in f32 registers, IEEE FMAs on the CUDA cores; no TF32.
//
// Interface: plain C functions, bound with ctypes; the apply launches on
// the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxProducts = 7;  // 1 + 2 dim, dim <= 3

// Instantiations; ops/uniform_stencil.py mirrors these numbers.
enum Kind { kGemm125 = 0, kSmall27 = 1, kSmall8 = 2, kGemmGeneric = 3 };

constexpr int kGemmTile = 128;    // elements (GEMM rows) per tile
constexpr int kGemmN = 128;       // output columns, bs padded
constexpr int kGemmKC = 32;       // K chunk
constexpr int kGemmStages = 3;    // depth of the cp.async ring
constexpr int kGemmThreads = 256;
// k-major A rows: 132 floats keep the 16-byte loads aligned and make the
// 4-byte copies of 4 rows x 8 k land in 32 distinct banks
constexpr int kAStride = kGemmTile + 4;
constexpr int kSmallTile = 128;   // elements (= threads) per small tile

struct GemmSmem {
  float b[kGemmStages][kGemmKC][kGemmN];    // matrix chunks
  float a[kGemmStages][kGemmKC][kAStride];  // k-major A chunks
  int row_off[kGemmTile];  // u offset of each row's element; -1 past count
  int pmat[kMaxProducts];
  int pshift[kMaxProducts];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// 4-byte copy; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// u[f .. f+3] (16-byte aligned f), zeros past the end of u
__device__ __forceinline__ float4 load4(const float* __restrict__ u, int f,
                                        int nfloats) {
  if (f + 4 <= nfloats) return __ldg(reinterpret_cast<const float4*>(u + f));
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (f < nfloats) x.x = __ldg(u + f);
  if (f + 1 < nfloats) x.y = __ldg(u + f + 1);
  if (f + 2 < nfloats) x.z = __ldg(u + f + 2);
  return x;
}

// One tile: the y rows of `count` elements of variant `vid` listed from
// elems[start].  BS > 0: compile-time block size; BS == 0: generic.
// SPLIT: a short tile (count <= 32), see below.
template <int BS, bool SPLIT>
__device__ __forceinline__ void gemm_tile(
    GemmSmem& s, const float* __restrict__ u, float* __restrict__ y,
    const float* __restrict__ mats, const int* __restrict__ elems,
    const int* __restrict__ prod_mat, const int* __restrict__ prod_shift,
    const int* __restrict__ prod_count, int bs, int vid, int start,
    int count) {
  const int kchunks = (bs + kGemmKC - 1) / kGemmKC;
  const int kp = kchunks * kGemmKC;  // rows of each stored matrix
  const int tid = threadIdx.x;
  const int nchunks = prod_count[vid] * kchunks;
  __syncthreads();  // the previous tile is done with s
  if (tid < kGemmTile) s.row_off[tid] = tid < count ? elems[start + tid] * bs : -1;
  if (tid < kMaxProducts) {
    s.pmat[tid] = prod_mat[vid * kMaxProducts + tid];
    s.pshift[tid] = prod_shift[vid * kMaxProducts + tid];
  }
  __syncthreads();

  // A: lane (kk, rr) = (lane % 8, lane / 8) of warp w copies u values
  // k = 8 kb + kk of rows rr + 4 (w + 8 m), m, kb = 0..3: every copy
  // instruction reads 4 rows x 32 contiguous bytes of u and writes 32
  // distinct banks; values past bs are written as zeros.  The launcher
  // takes n bs < 2^31, so offsets are 32-bit.
  const int lane = tid % 32;
  const int w = tid / 32;
  const int kk = lane % 8;

  // chunk c -> stage c % kGemmStages; always commits one group
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int q = c / kchunks;
      const int k0 = (c - q * kchunks) * kGemmKC;
      const int buf = c % kGemmStages;
      const float* bsrc = mats + ((size_t)s.pmat[q] * kp + k0) * kGemmN;
      float* bdst = &s.b[buf][0][0];
#pragma unroll
      for (int i = 0; i < kGemmKC * kGemmN / 4 / kGemmThreads; ++i) {
        const int o = 4 * (tid + i * kGemmThreads);
        cp_async16(bdst + o, bsrc + o);
      }
      const int add = s.pshift[q] * bs + k0 + kk;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int row = lane / 8 + 4 * (w + 8 * m);
        const int off = s.row_off[row];
        if (off < 0) continue;
        float* adst = &s.a[buf][kk][row];
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          const bool in = k0 + 8 * kb + kk < bs;
          cp_async4(adst + 8 * kb * kAStride, in ? u + off + add + 8 * kb : u,
                    in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // compute: a thread owns rows 8 ty + {0..7} and columns 4 tx + {0..3},
  // 64 + 4 tx + {0..3}; the lanes of a quarter warp share their rows, so
  // A's LDS.128 are quarter-uniform.  A short tile (count <= 32, one warp
  // row) splits K instead: warp row wr takes rows 8 (lane / 8) + {0..7}
  // and k = 8 wr .. 8 wr + 7 of every chunk, and the four partial sums
  // are added in a fixed order at the end.
  const int wr = w / 2;
  const int ty = SPLIT ? lane / 8 : 4 * wr + lane / 8;
  const int tx = (w % 2) * 8 + lane % 8;
  const bool warp_live = SPLIT || 32 * wr < count;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto mma = [&](const float* A, const float* B, auto ksteps) {
#pragma unroll
    for (int k = 0; k < decltype(ksteps)::value; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + k * kAStride);
      const float4 a1 = *reinterpret_cast<const float4*>(A + k * kAStride + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(B + k * kGemmN);
      const float4 b1 = *reinterpret_cast<const float4*>(B + k * kGemmN + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };

#pragma unroll 1
  for (int c = 0; c < kGemmStages - 1; ++c) issue(c);

#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kGemmStages - 2>();  // own copies of chunk c
    // every thread's copies of chunk c visible; stage (c - 1) % S free
    __syncthreads();
    issue(c + kGemmStages - 1);
    const float* A = &s.a[c % kGemmStages][0][8 * ty];
    const float* B = &s.b[c % kGemmStages][0][4 * tx];
    if constexpr (SPLIT)
      mma(A + 8 * wr * kAStride, B + 8 * wr * kGemmN,
          std::integral_constant<int, kGemmKC / 4>());
    else if (warp_live)
      mma(A, B, std::integral_constant<int, kGemmKC>());
  }
  cp_async_wait<0>();

  if constexpr (SPLIT) {
    // partial sums -> red[wr][row][col] over the (now idle) operand
    // buffers, then every thread adds the four of its outputs in order
    float* red = &s.b[0][0][0];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* r = red + (wr * 32 + 8 * ty + i) * kGemmN;
      *reinterpret_cast<float4*>(r + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(r + 64 + 4 * tx) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    const int col = tid % kGemmN;
    for (int row = tid / kGemmN; row < count; row += kGemmThreads / kGemmN) {
      const float* r = red + row * kGemmN + col;
      if (col < bs)
        y[s.row_off[row] + col] =
            ((r[0] + r[32 * kGemmN]) + r[64 * kGemmN]) + r[96 * kGemmN];
    }
    return;
  }
  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 8 * ty + i;
    if (row < count) {
      float* yr = y + s.row_off[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * tx + j < bs) yr[4 * tx + j] = acc[i][j];
        if (64 + 4 * tx + j < bs) yr[64 + 4 * tx + j] = acc[i][4 + j];
      }
    }
  }
}

// A persistent grid of exactly the resident blocks walks the tiles
// round-robin: block b takes tiles b, b + G, b + 2G, ...  The host puts
// the short tiles first, so the tiles past the first round go to the
// blocks that drew a short one.  Two resident blocks per SM for bs = 125;
// the generic instantiation needs more than the 128 registers that two
// blocks leave it.
template <int BS>
__global__ void __launch_bounds__(kGemmThreads, BS > 0 ? 2 : 1)
stencil_gemm_kernel(const float* __restrict__ u, float* __restrict__ y,
                    const float* __restrict__ mats,
                    const int* __restrict__ tiles,
                    const int* __restrict__ elems,
                    const int* __restrict__ prod_mat,
                    const int* __restrict__ prod_shift,
                    const int* __restrict__ prod_count, int ntiles,
                    int bs_rt) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  GemmSmem& s = *reinterpret_cast<GemmSmem*>(smem_bytes);
  const int bs = BS > 0 ? BS : bs_rt;
  const int G = gridDim.x;
  for (int r = 0;; ++r) {
    const int ti = r * G + (int)blockIdx.x;
    if (ti >= ntiles) break;
    const int count = tiles[3 * ti + 2];
    if (count <= 32)
      gemm_tile<BS, true>(s, u, y, mats, elems, prod_mat, prod_shift, prod_count,
                          bs, tiles[3 * ti], tiles[3 * ti + 1], count);
    else
      gemm_tile<BS, false>(s, u, y, mats, elems, prod_mat, prod_shift, prod_count,
                           bs, tiles[3 * ti], tiles[3 * ti + 1], count);
  }
}

// bs = 27 and 8: one thread per element of a tile.
template <int BS>
__global__ void __launch_bounds__(kSmallTile)
stencil_small_kernel(const float* __restrict__ u, float* __restrict__ y,
                     const float* __restrict__ mats,
                     const int* __restrict__ tiles,
                     const int* __restrict__ elems,
                     const int* __restrict__ prod_mat,
                     const int* __restrict__ prod_shift,
                     const int* __restrict__ prod_count, int nfloats,
                     int ntiles, int nvar, int nnbr, int tiles_per_block) {
  constexpr int BSP = (BS + 3) & ~3;  // stored row length
  constexpr int MSZ = BS * BSP;       // floats per stored matrix
  constexpr int NV = BS % 4 == 0 ? BS / 4 : (BS + 6) / 4;  // float4 per row
  // slot 0: the current variant's Tdiag; slots 1..nnbr: the couplings
  __shared__ __align__(16) float m[kMaxProducts][MSZ];
  const int tid = threadIdx.x;
  const float4* nsrc = reinterpret_cast<const float4*>(mats + (size_t)nvar * MSZ);
  for (int i = tid; i < nnbr * MSZ / 4; i += kSmallTile)
    reinterpret_cast<float4*>(&m[1][0])[i] = nsrc[i];

  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, ntiles);
  int cur = -1;
  for (int ti = t0; ti < t1; ++ti) {
    const int vid = tiles[3 * ti];
    const int start = tiles[3 * ti + 1];
    const int count = tiles[3 * ti + 2];
    if (vid != cur) {  // uniform over the block
      __syncthreads();
      const float4* dsrc = reinterpret_cast<const float4*>(mats + (size_t)vid * MSZ);
      for (int i = tid; i < MSZ / 4; i += kSmallTile)
        reinterpret_cast<float4*>(&m[0][0])[i] = dsrc[i];
      __syncthreads();
      cur = vid;
    }
    if (tid >= count) continue;
    const int e = elems[start + tid];
    const int nprod = prod_count[vid];
    float acc[BSP];
#pragma unroll
    for (int i = 0; i < BSP; ++i) acc[i] = 0.f;
    for (int q = 0; q < nprod; ++q) {
      const int mat = prod_mat[vid * kMaxProducts + q];
      const float* M = &m[q == 0 ? 0 : 1 + mat - nvar][0];
      // the row's aligned 16-byte cover: NV float4 loads, no scalars
      const int g = (e + prod_shift[vid * kMaxProducts + q]) * BS;
      const int mis = g & 3;
      float r[4 * NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 x = load4(u, (g & ~3) + 4 * v, nfloats);
        r[4 * v] = x.x;
        r[4 * v + 1] = x.y;
        r[4 * v + 2] = x.z;
        r[4 * v + 3] = x.w;
      }
      float ur[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j)
        ur[j] = BS % 4 == 0 ? r[j]
                : mis == 0  ? r[j]
                : mis == 1  ? r[j + 1]
                : mis == 2  ? r[j + 2]
                            : r[j + 3];
#pragma unroll
      for (int j = 0; j < BS; ++j) {
#pragma unroll
        for (int i = 0; i < BSP; i += 4) {
          const float4 mv = *reinterpret_cast<const float4*>(M + j * BSP + i);
          acc[i] = fmaf(ur[j], mv.x, acc[i]);
          acc[i + 1] = fmaf(ur[j], mv.y, acc[i + 1]);
          acc[i + 2] = fmaf(ur[j], mv.z, acc[i + 2]);
          acc[i + 3] = fmaf(ur[j], mv.w, acc[i + 3]);
        }
      }
    }
    float* dst = y + (size_t)e * BS;
    if constexpr (BS % 4 == 0) {
#pragma unroll
      for (int i = 0; i < BS; i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < BS; ++i) dst[i] = acc[i];
    }
  }
}

int layout(int bs, int* out) {
  if (bs < 1 || bs > kGemmN) return (int)cudaErrorInvalidValue;
  if (bs == 27 || bs == 8) {
    out[0] = bs == 27 ? kSmall27 : kSmall8;
    out[1] = kSmallTile;
    out[2] = bs;
    out[3] = (bs + 3) & ~3;
  } else {
    out[0] = bs == 125 ? kGemm125 : kGemmGeneric;
    out[1] = kGemmTile;
    out[2] = (bs + kGemmKC - 1) / kGemmKC * kGemmKC;
    out[3] = kGemmN;
  }
  return 0;
}

// Resident blocks of stencil_gemm_kernel<BS> on `device` (the grid of
// the persistent launch), worked out once per instantiation and device
// after opting in to > 48 KB of dynamic shared memory and the largest
// carveout; 0 on error.
template <int BS>
int gemm_slots(int device) {
  static int slots[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (slots[device] > 0) return slots[device];
  auto fn = stencil_gemm_kernel<BS>;
  int per_sm = 0, nsm = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(GemmSmem)) != cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fn, kGemmThreads, sizeof(GemmSmem)) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  slots[device] = per_sm * nsm;
  return slots[device];
}

}  // namespace

extern "C" {

// out[4] = (instantiation, tile elements, K rows, N columns of each
// stored matrix) for block size bs; nonzero where the kernel refuses bs.
int hpdg_uniform_stencil_layout(int bs, int* out) { return layout(bs, out); }

// Resident blocks per SM of the instantiation that takes block size bs,
// on the current device; negative on error.
int hpdg_uniform_stencil_occupancy(int bs) {
  int lay[4], blocks = 0, device = 0, nsm = 0;
  if (layout(bs, lay) != 0 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return -1;
  cudaError_t err;
  if (lay[0] == kGemm125 || lay[0] == kGemmGeneric) {
    const int slots = lay[0] == kGemm125 ? gemm_slots<125>(device) : gemm_slots<0>(device);
    return slots > 0 ? slots / nsm : -1;
  } else if (lay[0] == kSmall27) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, stencil_small_kernel<27>, kSmallTile, 0);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, stencil_small_kernel<8>, kSmallTile, 0);
  }
  return err == cudaSuccess ? blocks : -1;
}

// y = A u on `stream`.  mats: [nvar + nnbr][K][N] stored matrices (the
// variants' Tdiag, then M12_0, M21_0, M12_1, ...); tiles: [ntiles][3]
// (variant, start, count) into elems, the element ids grouped by
// variant; prod_mat / prod_shift: [nvar][7] each variant's products
// (stored matrix, row shift), prod_count: [nvar] how many.
int hpdg_uniform_stencil_f32(const float* u, float* y, const float* mats,
                             const int* tiles, const int* elems,
                             const int* prod_mat, const int* prod_shift,
                             const int* prod_count, int ntiles, int n, int bs,
                             int nvar, int nnbr, void* stream) {
  int lay[4];
  if (layout(bs, lay) != 0 || ntiles < 0 || n < 0 || nvar < 1 || nnbr < 0 ||
      nnbr > kMaxProducts - 1)
    return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)n * bs >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int nfloats = n * bs;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (lay[0] == kGemm125 || lay[0] == kGemmGeneric) {
    const int slots = lay[0] == kGemm125 ? gemm_slots<125>(device) : gemm_slots<0>(device);
    if (slots <= 0) return (int)cudaErrorInvalidConfiguration;
    const int grid = ntiles < slots ? ntiles : slots;
    if (lay[0] == kGemm125)
      stencil_gemm_kernel<125><<<grid, kGemmThreads, sizeof(GemmSmem), st>>>(
          u, y, mats, tiles, elems, prod_mat, prod_shift, prod_count, ntiles,
          bs);
    else
      stencil_gemm_kernel<0><<<grid, kGemmThreads, sizeof(GemmSmem), st>>>(
          u, y, mats, tiles, elems, prod_mat, prod_shift, prod_count, ntiles,
          bs);
  } else {
    int nsm = 0;
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int cap = 4 * nsm;
    const int per = (ntiles + cap - 1) / cap;
    const int grid = (ntiles + per - 1) / per;
    if (lay[0] == kSmall27)
      stencil_small_kernel<27><<<grid, kSmallTile, 0, st>>>(
          u, y, mats, tiles, elems, prod_mat, prod_shift, prod_count, nfloats,
          ntiles, nvar, nnbr, per);
    else
      stencil_small_kernel<8><<<grid, kSmallTile, 0, st>>>(
          u, y, mats, tiles, elems, prod_mat, prod_shift, prod_count, nfloats,
          ntiles, nvar, nnbr, per);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
