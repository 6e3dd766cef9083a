// K2: the block-sparse matrix-vector product of one (pr, pc) bucket of
// hpdg_tpu_torch.linalg.blockmatrix on an NVIDIA Hopper card (sm_90a),
// f32 and f64:
//
//     y[r] (+)= sum over the blocks s of block row r of vals[s] @ x[col[s]]
//
// with vals [nnz, br, bc] in the pattern's slot order, x [n_cols, bc] and
// y [n_rows, br]; br, bc <= 375 (3 (p+1)^3 at p = 4 elasticity), blocks
// may be rectangular (mixed degrees).
//
// What it replaces.  No TPU kernel: the reference computes this product
// in XLA (hpdg_tpu/linalg/blockmatrix.py, matvec: einsum("nij,nj->ni")
// and segment_sum).  The port's plain route (a gather of x, a batched
// GEMV, a zero fill and an atomic index_add_ per bucket) took most of
// the device time of the assembled V-cycle, at about half of the HBM
// rate, so the product became a kernel of its own.
//
// What bounds it.  HBM bytes.  Every block is read once per apply, and a
// level's blocks are far larger than the 50 MB L2 (2.45 GB of f32 at 24^3
// p=2 elasticity); each value read (4 or 8 bytes) feeds one FMA, far
// below the card's FP32 and FP64 rates.  x and y are a few MB.
//
// What the design does about it.
// * The host sorts the bucket's slots by block row once per pattern
//   (row_ptr, slot, col; stable), so the values stay where they are and
//   each block row's blocks are found without a search.
// * A block row goes to a thread block, or to one warp when the block
//   has at most 16 (vector loads) rows of work for a warp, eight block
//   rows to a thread block.  Its x blocks are staged in shared memory
//   (in chunks when a row has many blocks).
// * A group of GW lanes (8, 16 or 32, the narrowest that spans a row's
//   loads) takes one matrix row at a time, its lanes on consecutive
//   columns: a warp's loads of a row are coalesced.  Each lane carries
//   the sums of RPG rows in registers across all the blocks of its block
//   row, and issues the loads of those RPG rows for one block before
//   their FMAs, so that enough bytes are in flight to cover the memory
//   latency.  After the last block the group reduces each sum with
//   shuffles and writes it once: no contrib tensor, no gather, no zero
//   fill, no atomics.  Later buckets of the same row bucket add to y.
// * The values are read once, with the streaming cache hint (evict
//   first), so that x stays in L2 for the block rows that share it.
// * Where every row of the blocks is 16-byte aligned (bc a multiple of
//   16 / sizeof(T), values 16-byte aligned: bc = 24 or 8 in f32, any
//   even bc in f64) a lane loads 16 bytes at a time.  A block of odd
//   width (81 = 3 x 27, 125, 375) has rows at every alignment; there a
//   lane loads one value, a row of 81 f32 is three coalesced warp loads
//   of 128, 128 and 68 bytes, and it needs no head or tail of its own.
//   The loads per byte stay far below what an SM can issue, so the
//   width of a load does not bound the kernel; the bytes in flight do.
// * Each row is summed in f64 registers, from products that are exact
//   for f32 values, and rounded once when it is written.  The summation
//   order is fixed (lanes by column, shuffle tree, blocks in slot
//   order), so repeated applies are bitwise equal.  With an f32 sum that
//   fixed order repeats one rounding error in every row of a uniform
//   region, where the plain route's atomics scatter it: on the 128^2
//   p=3 obstacle problem it shifted the f32 energy 0.5 x.Ax - b.x of the
//   converged iterate by 3.5e-6 of 6.6e-3, against 3e-8 for the plain
//   route.  The f32 -> f64 conversions and f64 FMAs cost a small share
//   of their rates at the HBM rate (about 4 per SM clock against 16
//   and 64).
//
// Interface: plain C, bound with ctypes (hpdg_tpu_torch/ops/block_spmv.py).
// The launch is asynchronous on the caller's stream, allocates nothing
// (the wrapper allocates y) and is capturable in a CUDA graph.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int MAX_BLOCK = 375;
constexpr int SMEM_BYTES = 48 * 1024;  // x staging; no opt-in needed
constexpr int CTA_THREADS = 256;
constexpr int SHAPES = 8;  // (GW, CPL) instantiations, see kShape
constexpr int kShape[SHAPES][2] = {{8, 1}, {16, 1}, {32, 1}, {32, 2},
                                   {32, 3}, {32, 4}, {32, 8}, {32, 12}};

// rows a lane group carries per pass: fewer where a row needs many loads
__host__ __device__ constexpr int rows_per_group(int cpl) {
  return cpl >= 8 ? 1 : cpl >= 4 ? 2 : 4;
}

template <typename T> struct Vec;
template <> struct Vec<float> { typedef float4 type; };
template <> struct Vec<double> { typedef double2 type; };

// W consecutive values, streamed (read once: evict first)
template <typename T, int W>
__device__ __forceinline__ void load_values(const T* p, T (&out)[W]) {
  if constexpr (W == 1) {
    out[0] = __ldcs(p);
  } else {
    typedef typename Vec<T>::type V;
    const V q = __ldcs(reinterpret_cast<const V*>(p));
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = e[w];
  }
}

template <typename T, int W>
__device__ __forceinline__ void load_shared(const T* p, double (&out)[W]) {
  if constexpr (W == 1) {
    out[0] = *p;
  } else {
    typedef typename Vec<T>::type V;
    const V q = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = e[w];
  }
}

// the threads of one block row: a warp, or the whole thread block
__device__ __forceinline__ void sync_row(int nwr) {
  if (nwr == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// nwr warps per block row; blockDim.x / (32 nwr) block rows per thread
// block (1 unless nwr == 1); chunk x blocks staged per block row
template <typename T, bool VEC, int GW, int CPL>
__global__ void __launch_bounds__(CTA_THREADS)
block_spmv_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                  T* __restrict__ y, const int* __restrict__ row_ptr,
                  const int* __restrict__ slot, const int* __restrict__ col,
                  int n_rows, int br, int bc, int nwr, int chunk,
                  int accumulate) {
  constexpr int W = VEC ? 16 / sizeof(T) : 1;
  constexpr int RPG = rows_per_group(CPL);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = warp / nwr;  // block row within the thread block
  const int wr = warp - rb * nwr;  // warp within the block row
  const int row = blockIdx.x * (blockDim.x / (32 * nwr)) + rb;
  const int tid = wr * 32 + lane, nthr = nwr * 32;
  const int groups = nwr * (32 / GW);
  const int g = wr * (32 / GW) + lane / GW, gl = lane % GW;
  T* xs = smem + static_cast<size_t>(rb) * chunk * bc;

  const bool live = row < n_rows;
  const int beg = live ? row_ptr[row] : 0;
  const int nnz = live ? row_ptr[row + 1] - beg : 0;
  const int nchunks = (nnz + chunk - 1) / chunk;
  const int passes = ((br + groups - 1) / groups + RPG - 1) / RPG;
  const size_t block_elems = static_cast<size_t>(br) * bc;

  int staged = -1;
  for (int pass = 0; pass < passes; ++pass) {
    double acc[RPG];
#pragma unroll
    for (int q = 0; q < RPG; ++q) acc[q] = 0.0;
    for (int c0 = 0; c0 < nchunks; ++c0) {
      const int k0 = c0 * chunk;
      const int kn = min(chunk, nnz - k0);
      if (c0 != staged) {  // uniform over the block row
        sync_row(nwr);
        for (int e = tid; e < kn * bc; e += nthr) {
          const int k = e / bc, j = e - k * bc;
          xs[e] = __ldg(x + static_cast<size_t>(col[beg + k0 + k]) * bc + j);
        }
        sync_row(nwr);
        staged = c0;
      }
      for (int k = 0; k < kn; ++k) {
        const T* blk = vals + static_cast<size_t>(slot[beg + k0 + k]) *
                                  block_elems;
        double xr[CPL][W];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j0 = W * (gl + GW * c);
          if (j0 < bc) {
            load_shared<T, W>(xs + k * bc + j0, xr[c]);
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) xr[c][w] = 0.0;
          }
        }
        // all loads of the RPG rows first, then their FMAs
        T a[RPG][CPL][W];
#pragma unroll
        for (int q = 0; q < RPG; ++q) {
          const int i = g + groups * (pass * RPG + q);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int j0 = W * (gl + GW * c);
            if (i < br && j0 < bc) {
              load_values<T, W>(blk + static_cast<size_t>(i) * bc + j0,
                                a[q][c]);
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) a[q][c][w] = T(0);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RPG; ++q)
#pragma unroll
          for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int w = 0; w < W; ++w)
              acc[q] = fma(static_cast<double>(a[q][c][w]), xr[c][w], acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < RPG; ++q) {
      double v = acc[q];
#pragma unroll
      for (int off = GW / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int i = g + groups * (pass * RPG + q);
      if (live && gl == 0 && i < br) {
        T* yp = y + static_cast<size_t>(row) * br + i;
        *yp = static_cast<T>(accumulate ? static_cast<double>(*yp) + v : v);
      }
    }
  }
}

struct Layout {
  int vec, shape, nwr, rows_per_cta, chunk, threads;
  size_t smem;
};

// -1 where the kernel does not take (dtype, br, bc)
int make_layout(int dtype, int br, int bc, bool aligned, int max_row_nnz,
                Layout* L) {
  if ((dtype != 0 && dtype != 1) || br < 1 || bc < 1 || br > MAX_BLOCK ||
      bc > MAX_BLOCK)
    return -1;
  const int size = dtype == 0 ? 4 : 8, wide = 16 / size;
  L->vec = aligned && bc % wide == 0;
  const int units = (bc + (L->vec ? wide : 1) - 1) / (L->vec ? wide : 1);
  const int gw = units <= 8 ? 8 : units <= 16 ? 16 : 32;
  const int need = (units + gw - 1) / gw;
  L->shape = -1;
  for (int s = 0; s < SHAPES && L->shape < 0; ++s)
    if (kShape[s][0] == gw && kShape[s][1] >= need) L->shape = s;
  if (L->shape < 0) return -1;
  const int per_warp = (32 / gw) * rows_per_group(kShape[L->shape][1]);
  L->nwr = std::min(CTA_THREADS / 32,
                    std::max(1, (br + per_warp - 1) / per_warp));
  L->rows_per_cta = L->nwr == 1 ? CTA_THREADS / 32 : 1;
  L->threads = 32 * L->nwr * L->rows_per_cta;
  const int fit = SMEM_BYTES / (L->rows_per_cta * bc * size);
  L->chunk = std::max(1, std::min(std::max(1, max_row_nnz), fit));
  L->smem = static_cast<size_t>(L->rows_per_cta) * L->chunk * bc * size;
  return 0;
}

template <typename T, bool VEC>
cudaError_t launch(const Layout& L, const T* vals, const T* x, T* y,
                   const int* row_ptr, const int* slot, const int* col,
                   int n_rows, int br, int bc, int accumulate,
                   cudaStream_t stream) {
  const dim3 grid((n_rows + L.rows_per_cta - 1) / L.rows_per_cta);
#define HPDG_K2_CASE(S, GW, CPL)                                          \
  case S:                                                                 \
    block_spmv_kernel<T, VEC, GW, CPL><<<grid, L.threads, L.smem, stream>>>( \
        vals, x, y, row_ptr, slot, col, n_rows, br, bc, L.nwr, L.chunk,   \
        accumulate);                                                      \
    break;
  switch (L.shape) {
    HPDG_K2_CASE(0, 8, 1)
    HPDG_K2_CASE(1, 16, 1)
    HPDG_K2_CASE(2, 32, 1)
    HPDG_K2_CASE(3, 32, 2)
    HPDG_K2_CASE(4, 32, 3)
    HPDG_K2_CASE(5, 32, 4)
    HPDG_K2_CASE(6, 32, 8)
    HPDG_K2_CASE(7, 32, 12)
    default:
      return cudaErrorInvalidValue;
  }
#undef HPDG_K2_CASE
  return cudaGetLastError();
}

// the attributes of one instantiation (getting them loads it)
template <typename T, bool VEC>
cudaError_t attributes(int shape, cudaFuncAttributes* a) {
  switch (shape) {
    case 0: return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, 8, 1>);
    case 1: return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, 16, 1>);
    case 2: return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, 32, 1>);
    case 3: return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, 32, 2>);
    case 4: return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, 32, 3>);
    case 5: return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, 32, 4>);
    case 6: return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, 32, 8>);
    case 7: return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, 32, 12>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Loads every instantiation, so that none loads first under a CUDA
// graph capture.  Returns a CUDA error code.
int hpdg_block_spmv_prepare() {
  cudaFuncAttributes a;
  for (int s = 0; s < SHAPES; ++s) {
    const cudaError_t e[4] = {attributes<float, false>(s, &a),
                              attributes<float, true>(s, &a),
                              attributes<double, false>(s, &a),
                              attributes<double, true>(s, &a)};
    for (cudaError_t v : e)
      if (v != cudaSuccess) return static_cast<int>(v);
  }
  return 0;
}

// y (+)= A x for one bucket; -1 where the kernel does not take (dtype,
// br, bc), else the CUDA error code of the launch (0 on success)
int hpdg_block_spmv(int dtype, const void* vals, const void* x, void* y,
                    const int* row_ptr, const int* slot, const int* col,
                    int n_rows, int br, int bc, int max_row_nnz,
                    int accumulate, void* stream) {
  Layout L;
  const bool aligned = reinterpret_cast<size_t>(vals) % 16 == 0;
  if (make_layout(dtype, br, bc, aligned, max_row_nnz, &L) != 0) return -1;
  if (n_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    const float* v = static_cast<const float*>(vals);
    const float* xx = static_cast<const float*>(x);
    float* yy = static_cast<float*>(y);
    e = L.vec ? launch<float, true>(L, v, xx, yy, row_ptr, slot, col, n_rows,
                                    br, bc, accumulate, st)
              : launch<float, false>(L, v, xx, yy, row_ptr, slot, col,
                                     n_rows, br, bc, accumulate, st);
  } else {
    const double* v = static_cast<const double*>(vals);
    const double* xx = static_cast<const double*>(x);
    double* yy = static_cast<double*>(y);
    e = L.vec ? launch<double, true>(L, v, xx, yy, row_ptr, slot, col,
                                     n_rows, br, bc, accumulate, st)
              : launch<double, false>(L, v, xx, yy, row_ptr, slot, col,
                                      n_rows, br, bc, accumulate, st);
  }
  return static_cast<int>(e);
}

}  // extern "C"
