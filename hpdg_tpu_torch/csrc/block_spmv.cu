// K2: the block-sparse matrix-vector product of one (pr, pc) bucket of
// hpdg_tpu_torch.linalg.blockmatrix on an NVIDIA Hopper card (sm_90a),
// f32 and f64:
//
//     y[r] (+)= sum over the blocks s of block row r of vals[s] @ x[col[s]]
//
// with vals [nnz, br, bc] in the pattern's slot order, x [n_cols, bc] and
// y [n_rows, br]; br, bc <= 6144 (one block's x, 48 KB of f64, fits the
// shared memory), blocks may be rectangular (mixed degrees).
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
// What the design does about it.  Two kernels, chosen per bucket by the
// width of a block's row, and one summation order for every matrix row
// whichever kernel sums it (below).
// * The host sorts the bucket's slots by block row once per pattern
//   (row_ptr, slot, col; stable), so the values stay where they are and
//   each block row's blocks are found without a search.
// * A lane group of GW lanes (a power of two) sums one matrix row, its
//   lanes on consecutive columns (a load unit each: 16 bytes where every
//   row of the blocks is 16-byte aligned, else one value), so a warp's
//   loads of a row are coalesced.
// * Narrow rows, 64 bytes or less (f32 up to 16 wide, f64 up to 8:
//   config 5's 4 x 4 and 16 x 16 f32 levels, 3D Poisson at p = 1), take
//   block_spmv_narrow.  GW is the row's load units rounded up to a power
//   of two (1 to 16), so a warp holds 32 / GW matrix rows of one or more
//   block rows (at 4 x 4 f32 one lane a row, eight block rows a warp) and
//   no lane of a group idles.  A group reads its block row's slot and
//   col once, then issues the value and x loads of NB = 5 blocks before
//   their FMAs: a row of 2D DG (the block and its four face neighbours)
//   is one round of loads, not five dependent ones.  x comes through the
//   read-only path, from L1 and L2 (a level's x is at most a few MB and
//   stays in L2): no staging, no division per element, no barrier.
// * Wider rows take block_spmv_kernel.  A block row goes to a thread
//   block, or to one warp when the block has at most 16 (vector loads)
//   rows of work for a warp, eight block rows to a thread block.  Its x
//   blocks are staged in shared memory (in chunks when a row has many
//   blocks).  Each lane carries the sums of RPG rows in registers across
//   all the blocks of its block row, and issues the loads of those RPG
//   rows for one block before their FMAs.  Where a thread block holds one
//   block row and the bucket has fewer block rows than two thread blocks
//   per SM (2^3 elasticity at p = 4, 5: 4 block rows of 375 or 648 rows),
//   each block row is split over several thread blocks by slices of its
//   passes over the matrix rows, each staging its own x: a row is still
//   summed by one group of one thread block, so there are no atomics and
//   no second pass.  After the last block a group reduces each sum with
//   shuffles and writes it once: no contrib tensor, no gather, no zero
//   fill.  Later buckets of the same row bucket add to y.
// * A row wider than one group's loads (32 lanes x 12 loads: 384 values
//   unvectorized, 3D Poisson at p = 8 (729) or elasticity at p = 6
//   (1029), or more vector loads) takes the tiled instantiation: the
//   group loops over column tiles of 384 loads within each block, and
//   the row's sum stays in its f64 registers across the tiles.  Every
//   narrower block takes an instantiation without the loop.
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
//   for f32 values, and rounded once when it is written.  The order is
//   fixed: each lane adds its columns' products block by block in slot
//   order, within a block tile by tile, then its columns in order; then
//   the group's shuffle tree (XOR pairs, offsets GW / 2 down to 1).  A
//   lane whose columns lie past the row adds zeros, so the narrow
//   kernel's groups, narrower than the wide kernel's 8 lanes at least,
//   give the same bits as the wide kernel would, and a split moves no
//   row's order: every bucket's f32 output is bitwise what one group of
//   max(8, GW) lanes gives (ops/block_spmv.py: emulate, in numpy), and
//   repeated applies are bitwise equal.  With an f32 sum that fixed
//   order repeats one rounding error in every row of a uniform region,
//   where the plain route's atomics scatter it: on the 128^2 p=3
//   obstacle problem it shifted the f32 energy 0.5 x.Ax - b.x of the
//   converged iterate by 3.5e-6 of 6.6e-3, against 3e-8 for the plain
//   route.  The f32 -> f64 conversions and f64 FMAs cost a small share
//   of their rates at the HBM rate (about 4 per SM clock against 16
//   and 64).
//
// Interface: plain C, bound with ctypes (hpdg_tpu_torch/ops/block_spmv.py).
// The launch is asynchronous on the caller's stream, allocates nothing
// (the wrapper allocates y) and is capturable in a CUDA graph.
// hpdg_block_spmv_layout reports the launch geometry, which the wrapper
// mirrors in Python (block_spmv.layout) for the tests.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int SMEM_BYTES = 48 * 1024;  // x staging; no opt-in needed
constexpr int MAX_BLOCK = SMEM_BYTES / 8;  // one f64 x block: 6144
constexpr int CTA_THREADS = 256;
constexpr int NARROW_THREADS = 128;
constexpr int NARROW_BYTES = 64;  // the widest row of the narrow kernel
// blocks whose loads a narrow group issues together: a 2D row's face
// neighbours and the block itself, at 64 registers a lane (8 thread blocks
// per SM); a 3D row (7 blocks) takes two rounds, which measured faster
// than one round of 8 at 96 registers
constexpr int NB = 5;
constexpr int CTAS_PER_SM = 2;  // split wide block rows up to this many
constexpr int SHAPES = 9;  // (GW, CPL, TILED) instantiations
constexpr int kShape[SHAPES][3] = {{8, 1, 0},  {16, 1, 0}, {32, 1, 0},
                                   {32, 2, 0}, {32, 3, 0}, {32, 4, 0},
                                   {32, 8, 0}, {32, 12, 0}, {32, 12, 1}};
constexpr int NARROW_GW = 5;  // narrow instantiations: GW = 1, 2, 4, 8, 16

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

// W consecutive values of x through the read-only path; one vector load
// where x is 16-byte aligned (xvec), else W single ones
template <typename T, int W>
__device__ __forceinline__ void load_x(const T* p, int xvec, T (&out)[W]) {
  if constexpr (W == 1) {
    out[0] = __ldg(p);
  } else {
    if (xvec) {
      typedef typename Vec<T>::type V;
      const V q = __ldg(reinterpret_cast<const V*>(p));
      const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
      for (int w = 0; w < W; ++w) out[w] = e[w];
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) out[w] = __ldg(p + w);
    }
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

// the group's shuffle tree and the write of its row (lane 0)
template <typename T, int GW>
__device__ __forceinline__ void reduce_store(double v, bool store, T* yp,
                                             int accumulate) {
#pragma unroll
  for (int off = GW / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (store)
    *yp = static_cast<T>(accumulate ? static_cast<double>(*yp) + v : v);
}

// Rows of at most NARROW_BYTES: one group of GW lanes per (block row,
// matrix row), groups numbered along y; lane gl holds columns W gl ..
// W gl + W - 1.
template <typename T, bool VEC, int GW>
__global__ void __launch_bounds__(NARROW_THREADS)
block_spmv_narrow(const T* __restrict__ vals, const T* __restrict__ x,
                  T* __restrict__ y, const int* __restrict__ row_ptr,
                  const int* __restrict__ slot, const int* __restrict__ col,
                  int n_rows, int br, int bc, int xvec, int accumulate) {
  constexpr int W = VEC ? 16 / sizeof(T) : 1;
  const long long gid =
      (static_cast<long long>(blockIdx.x) * NARROW_THREADS + threadIdx.x) /
      GW;
  const int gl = threadIdx.x % GW;
  const long long row_ll = gid / br;
  const bool live = row_ll < n_rows;
  const int row = live ? static_cast<int>(row_ll) : 0;
  const int i = static_cast<int>(gid - row_ll * br);
  const int beg = live ? row_ptr[row] : 0;
  const int nnz = live ? row_ptr[row + 1] - beg : 0;
  const int j0 = W * gl;
  const bool on = j0 < bc;  // else the lane adds zeros
  const size_t block_elems = static_cast<size_t>(br) * bc;
  const T* vrow = vals + static_cast<size_t>(i) * bc + j0;

  double acc = 0.0;
  for (int k0 = 0; k0 < nnz; k0 += NB) {
    int s[NB], c[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const bool in = k0 + b < nnz;
      s[b] = in ? slot[beg + k0 + b] : 0;
      c[b] = in ? col[beg + k0 + b] : 0;
    }
    // the loads of NB blocks first, then their FMAs in slot order
    T a[NB][W], xv[NB][W];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (on && k0 + b < nnz) {
        load_values<T, W>(vrow + static_cast<size_t>(s[b]) * block_elems,
                          a[b]);
        load_x<T, W>(x + static_cast<size_t>(c[b]) * bc + j0, xvec, xv[b]);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) a[b][w] = xv[b][w] = T(0);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (k0 + b < nnz)
#pragma unroll
        for (int w = 0; w < W; ++w)
          acc = fma(static_cast<double>(a[b][w]),
                    static_cast<double>(xv[b][w]), acc);
  }
  reduce_store<T, GW>(acc, live && gl == 0,
                      y + static_cast<size_t>(row) * br + i, accumulate);
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
// block (1 unless nwr == 1); chunk x blocks staged per block row; TILED:
// the group loops over column tiles of W GW CPL values.  A block row
// takes `slices` consecutive thread blocks, slice s doing passes
// s pp .. s pp + pp - 1 over its matrix rows (one slice unless split).
template <typename T, bool VEC, int GW, int CPL, bool TILED>
__global__ void __launch_bounds__(CTA_THREADS)
block_spmv_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                  T* __restrict__ y, const int* __restrict__ row_ptr,
                  const int* __restrict__ slot, const int* __restrict__ col,
                  int n_rows, int br, int bc, int nwr, int chunk,
                  int slices, int pp, int accumulate) {
  constexpr int W = VEC ? 16 / sizeof(T) : 1;
  constexpr int RPG = rows_per_group(CPL);
  constexpr int TILE = W * GW * CPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = warp / nwr;  // block row within the thread block
  const int wr = warp - rb * nwr;  // warp within the block row
  const int cta_row = blockIdx.x / slices;
  const int slice = blockIdx.x - cta_row * slices;
  const int row = cta_row * (blockDim.x / (32 * nwr)) + rb;
  const int tid = wr * 32 + lane, nthr = nwr * 32;
  const int groups = nwr * (32 / GW);
  const int g = wr * (32 / GW) + lane / GW, gl = lane % GW;
  T* xs = smem + static_cast<size_t>(rb) * chunk * bc;

  const bool live = row < n_rows;
  const int beg = live ? row_ptr[row] : 0;
  const int nnz = live ? row_ptr[row + 1] - beg : 0;
  const int nchunks = (nnz + chunk - 1) / chunk;
  const int passes = ((br + groups - 1) / groups + RPG - 1) / RPG;
  const int p_end = min(passes, (slice + 1) * pp);
  const size_t block_elems = static_cast<size_t>(br) * bc;

  int staged = -1;
  for (int pass = slice * pp; pass < p_end; ++pass) {
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
        // one pass without TILED (the block fits one tile)
        for (int t0 = 0; t0 < (TILED ? bc : 1); t0 += TILE) {
          double xr[CPL][W];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int j0 = t0 + W * (gl + GW * c);
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
              const int j0 = t0 + W * (gl + GW * c);
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
                acc[q] = fma(static_cast<double>(a[q][c][w]), xr[c][w],
                             acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RPG; ++q) {
      const int i = g + groups * (pass * RPG + q);
      reduce_store<T, GW>(acc[q], live && gl == 0 && i < br,
                          y + static_cast<size_t>(row) * br + i, accumulate);
    }
  }
}

// The launch geometry; ops/block_spmv.py: layout mirrors it field by
// field (LAYOUT_FIELDS).  narrow: block_spmv_narrow with gw lanes a
// group, else block_spmv_kernel's instantiation `shape`.
struct Layout {
  int narrow, vec, gw, shape, nwr, rows_per_cta, threads, chunk, smem,
      passes, pp, slices, grid;
};

// -1 where the kernel does not take (dtype, br, bc)
int make_layout(int dtype, int br, int bc, bool aligned, int n_rows,
                int max_row_nnz, int sms, Layout* L) {
  if ((dtype != 0 && dtype != 1) || br < 1 || bc < 1 || br > MAX_BLOCK ||
      bc > MAX_BLOCK || n_rows < 0 || sms < 1)
    return -1;
  *L = Layout{};
  const int size = dtype == 0 ? 4 : 8, wide = 16 / size;
  L->vec = aligned && bc % wide == 0;
  const int units = (bc + (L->vec ? wide : 1) - 1) / (L->vec ? wide : 1);
  L->slices = 1;
  if (bc * size <= NARROW_BYTES) {
    L->narrow = 1;
    L->gw = 1;
    while (L->gw < units) L->gw <<= 1;
    L->shape = -1;
    L->threads = NARROW_THREADS;
    const long long lanes = static_cast<long long>(n_rows) * br * L->gw;
    L->grid = static_cast<int>((lanes + NARROW_THREADS - 1) / NARROW_THREADS);
    return 0;
  }
  L->gw = units <= 8 ? 8 : units <= 16 ? 16 : 32;
  const int need = (units + L->gw - 1) / L->gw;
  L->shape = SHAPES - 1;  // the tiled one, where no untiled one spans
  for (int s = 0; s < SHAPES - 1; ++s)
    if (kShape[s][0] == L->gw && kShape[s][1] >= need) {
      L->shape = s;
      break;
    }
  const int rpg = rows_per_group(kShape[L->shape][1]);
  const int per_warp = (32 / L->gw) * rpg;
  L->nwr = std::min(CTA_THREADS / 32,
                    std::max(1, (br + per_warp - 1) / per_warp));
  L->rows_per_cta = L->nwr == 1 ? CTA_THREADS / 32 : 1;
  L->threads = 32 * L->nwr * L->rows_per_cta;
  const int fit = SMEM_BYTES / (L->rows_per_cta * bc * size);
  L->chunk = std::max(1, std::min(std::max(1, max_row_nnz), fit));
  L->smem = L->rows_per_cta * L->chunk * bc * size;
  const int groups = L->nwr * (32 / L->gw);
  L->passes = ((br + groups - 1) / groups + rpg - 1) / rpg;
  L->pp = L->passes;
  const int ctas = (n_rows + L->rows_per_cta - 1) / L->rows_per_cta;
  if (L->rows_per_cta == 1 && ctas > 0 && ctas < CTAS_PER_SM * sms) {
    const int want = std::min(
        L->passes, (CTAS_PER_SM * sms + ctas - 1) / ctas);
    L->pp = std::max(1, L->passes / want);
    L->slices = (L->passes + L->pp - 1) / L->pp;
  }
  L->grid = ctas * L->slices;
  return 0;
}

template <typename T, bool VEC>
cudaError_t launch_narrow(const Layout& L, const T* vals, const T* x, T* y,
                          const int* row_ptr, const int* slot,
                          const int* col, int n_rows, int br, int bc,
                          int xvec, int accumulate, cudaStream_t stream) {
#define HPDG_K2_NARROW(GW)                                                 \
  case GW:                                                                 \
    block_spmv_narrow<T, VEC, GW><<<L.grid, L.threads, 0, stream>>>(       \
        vals, x, y, row_ptr, slot, col, n_rows, br, bc, xvec, accumulate); \
    break;
  switch (L.gw) {
    HPDG_K2_NARROW(1)
    HPDG_K2_NARROW(2)
    HPDG_K2_NARROW(4)
    HPDG_K2_NARROW(8)
    HPDG_K2_NARROW(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef HPDG_K2_NARROW
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch(const Layout& L, const T* vals, const T* x, T* y,
                   const int* row_ptr, const int* slot, const int* col,
                   int n_rows, int br, int bc, int accumulate,
                   cudaStream_t stream) {
#define HPDG_K2_CASE(S, GW, CPL, TILED)                                     \
  case S:                                                                   \
    block_spmv_kernel<T, VEC, GW, CPL, TILED>                               \
        <<<L.grid, L.threads, L.smem, stream>>>(                            \
            vals, x, y, row_ptr, slot, col, n_rows, br, bc, L.nwr, L.chunk, \
            L.slices, L.pp, accumulate);                                    \
    break;
  switch (L.shape) {
    HPDG_K2_CASE(0, 8, 1, false)
    HPDG_K2_CASE(1, 16, 1, false)
    HPDG_K2_CASE(2, 32, 1, false)
    HPDG_K2_CASE(3, 32, 2, false)
    HPDG_K2_CASE(4, 32, 3, false)
    HPDG_K2_CASE(5, 32, 4, false)
    HPDG_K2_CASE(6, 32, 8, false)
    HPDG_K2_CASE(7, 32, 12, false)
    HPDG_K2_CASE(8, 32, 12, true)
    default:
      return cudaErrorInvalidValue;
  }
#undef HPDG_K2_CASE
  return cudaGetLastError();
}

// the attributes of one instantiation (getting them loads it)
template <typename T, bool VEC>
cudaError_t attributes(int shape, cudaFuncAttributes* a) {
#define HPDG_K2_ATTR(S, GW, CPL, TILED) \
  case S:                               \
    return cudaFuncGetAttributes(a, block_spmv_kernel<T, VEC, GW, CPL, TILED>);
  switch (shape) {
    HPDG_K2_ATTR(0, 8, 1, false)
    HPDG_K2_ATTR(1, 16, 1, false)
    HPDG_K2_ATTR(2, 32, 1, false)
    HPDG_K2_ATTR(3, 32, 2, false)
    HPDG_K2_ATTR(4, 32, 3, false)
    HPDG_K2_ATTR(5, 32, 4, false)
    HPDG_K2_ATTR(6, 32, 8, false)
    HPDG_K2_ATTR(7, 32, 12, false)
    HPDG_K2_ATTR(8, 32, 12, true)
    default: return cudaErrorInvalidValue;
  }
#undef HPDG_K2_ATTR
}

template <typename T, bool VEC>
cudaError_t narrow_attributes(int k, cudaFuncAttributes* a) {
  switch (k) {
    case 0: return cudaFuncGetAttributes(a, block_spmv_narrow<T, VEC, 1>);
    case 1: return cudaFuncGetAttributes(a, block_spmv_narrow<T, VEC, 2>);
    case 2: return cudaFuncGetAttributes(a, block_spmv_narrow<T, VEC, 4>);
    case 3: return cudaFuncGetAttributes(a, block_spmv_narrow<T, VEC, 8>);
    case 4: return cudaFuncGetAttributes(a, block_spmv_narrow<T, VEC, 16>);
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
  for (int k = 0; k < NARROW_GW; ++k) {
    const cudaError_t e[4] = {narrow_attributes<float, false>(k, &a),
                              narrow_attributes<float, true>(k, &a),
                              narrow_attributes<double, false>(k, &a),
                              narrow_attributes<double, true>(k, &a)};
    for (cudaError_t v : e)
      if (v != cudaSuccess) return static_cast<int>(v);
  }
  return 0;
}

// The geometry of a launch into out[0..12], in Layout's field order; -1
// where the kernel does not take (dtype, br, bc)
int hpdg_block_spmv_layout(int dtype, int br, int bc, int aligned,
                           int n_rows, int max_row_nnz, int sms, int* out) {
  Layout L;
  if (make_layout(dtype, br, bc, aligned != 0, n_rows, max_row_nnz, sms,
                  &L) != 0)
    return -1;
  const int f[13] = {L.narrow,  L.vec,   L.gw,     L.shape, L.nwr,
                     L.rows_per_cta,    L.threads, L.chunk, L.smem,
                     L.passes,  L.pp,    L.slices, L.grid};
  std::copy(f, f + 13, out);
  return 0;
}

// y (+)= A x for one bucket on a card of `sms` SMs; -1 where the kernel
// does not take (dtype, br, bc), else the CUDA error code of the launch
// (0 on success)
int hpdg_block_spmv(int dtype, const void* vals, const void* x, void* y,
                    const int* row_ptr, const int* slot, const int* col,
                    int n_rows, int br, int bc, int max_row_nnz,
                    int accumulate, int sms, void* stream) {
  Layout L;
  const bool aligned = reinterpret_cast<size_t>(vals) % 16 == 0;
  if (make_layout(dtype, br, bc, aligned, n_rows, max_row_nnz, sms, &L) !=
      0)
    return -1;
  if (n_rows == 0) return 0;
  const int xvec = reinterpret_cast<size_t>(x) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    const float* v = static_cast<const float*>(vals);
    const float* xx = static_cast<const float*>(x);
    float* yy = static_cast<float*>(y);
    if (L.narrow)
      e = L.vec ? launch_narrow<float, true>(L, v, xx, yy, row_ptr, slot, col,
                                             n_rows, br, bc, xvec,
                                             accumulate, st)
                : launch_narrow<float, false>(L, v, xx, yy, row_ptr, slot,
                                              col, n_rows, br, bc, xvec,
                                              accumulate, st);
    else
      e = L.vec ? launch<float, true>(L, v, xx, yy, row_ptr, slot, col,
                                      n_rows, br, bc, accumulate, st)
                : launch<float, false>(L, v, xx, yy, row_ptr, slot, col,
                                       n_rows, br, bc, accumulate, st);
  } else {
    const double* v = static_cast<const double*>(vals);
    const double* xx = static_cast<const double*>(x);
    double* yy = static_cast<double*>(y);
    if (L.narrow)
      e = L.vec ? launch_narrow<double, true>(L, v, xx, yy, row_ptr, slot,
                                              col, n_rows, br, bc, xvec,
                                              accumulate, st)
                : launch_narrow<double, false>(L, v, xx, yy, row_ptr, slot,
                                               col, n_rows, br, bc, xvec,
                                               accumulate, st);
    else
      e = L.vec ? launch<double, true>(L, v, xx, yy, row_ptr, slot, col,
                                       n_rows, br, bc, accumulate, st)
                : launch<double, false>(L, v, xx, yy, row_ptr, slot, col,
                                        n_rows, br, bc, accumulate, st);
  }
  return static_cast<int>(e);
}

}  // extern "C"
