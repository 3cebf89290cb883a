// Variable-coefficient 3^d-point stencil matvec on the CG-1 node grid,
// flattened to (gx, M) with M = prod(grid[1:]); one thread per output.
//
// Replaces fem_glass_tempering_tpu/ops/pallas_stencil.py:stencil_matvec_pallas.
//   y[i, m] = sum_{o < 3^d} vals[o, i, m] * x[i + dx_o - 1, m + s_o]
// with the lattice offsets o in lexicographic order (dx, dy[, dz]) and the
// flat column shift s_o = (dy - 1) gz + (dz - 1) in 3D, dy - 1 in 2D
// (ops/cuda_stencil.py flat_shifts). A row outside [0, gx) or a flat column
// outside [0, M) reads 0, as the zero padding of the plain version does;
// a column that wraps into the next y-row inside [0, M) is read and
// multiplied by the assembled zero stored for the missing neighbour.
//
// Bound: device-memory bytes. A call streams the 3^d value tables once
// (27 n values in 3D) plus x and y: 2 flops per 8 (f64) or 4 (f32) table
// bytes, far under the card's flop rate per byte. Design: consecutive
// threads take consecutive flat columns, so each of the 27 table reads of
// a warp is one contiguous, fully used segment; the 27 neighbour reads of
// x are as contiguous and hit L1/L2 (x is 1/27 of the traffic). No
// shared-memory tile: at this arithmetic intensity the table stream is the
// whole cost, and a halo tile cannot shrink it.
//
// The 27 products are summed in the plain version's order and, with the
// library built with -fmad=false, with its roundings, so the two agree
// bit for bit.
//
// Table type. The value tables may stream in bfloat16 under an f32 or f64
// vector (the multigrid V-cycle's `table_dtype`, JAX
// ops/grid.py GridHeatOperator._mv_flat with stream_dtype): each value is
// widened to the vector's type with __bfloat162float, which is exact, and
// multiplied and summed in that type, as PyTorch's promotion of
// bf16 * f32 (or f64) does in the plain version, so the two still agree
// bit for bit. The tables are then 2 of the 4 (f32 vector) or 8 (f64)
// bytes per value: 27 x 2 + 2 x 4 = 62 bytes per point with an f32
// vector, against 116 with f32 tables.
//
// The bf16-table instantiation has a kernel of its own. One point a thread
// left it at half its byte bound: its 27 table loads are 2 bytes a lane
// (64 B a warp instruction), each point reads 27 x values through L1 and
// pays a 64-bit division and nine bounds tests, so instructions and L1
// set the pace before the bytes do. Here a thread takes V = 4 consecutive
// flat columns: each table arrives as one 8-byte vector (a warp reads 256
// contiguous bytes), x as a sliding window of V + 2 values per (dx, dy)
// row, read as aligned 16-byte vectors (the window's offset into them is
// the same in every thread), the division and the bounds tests come once
// per vector, and the stores are 16-byte vectors. A vector that meets a
// row end, or the end of the grid, takes the one-point path. Measured on
// an H100 (700 W) at the 161 x 161 x 41 fine level (chip_ab.py kernels):
// 4 points a thread beat 8 (0.0341 against 0.0357 ms with an f32 vector,
// 0.0416 against 0.0484 with f64), where 8 points' x windows spread each
// warp's 16-byte loads over twice the lines. The vector loads need every
// table to start on 8 bytes and y on 16: the tables are pitched, table o
// at o * pitch with pitch a multiple of 8 values (ops/cuda_stencil.py
// pitched_tables; the fine level's n = 161 x 161 x 41 is odd). Each point
// still sums its 27 products in offset order with the plain version's
// roundings: bit-equal to it, as the one-point kernel.

// The halo form (fgt_stencil_matvec_halo; HALO = true in the f32 / f64
// kernel): the rows of one rank's planes of a grid split along axis 0
// (parallel/grid_shard.py), with x carrying one plane of each neighbour
// rank above and below its own, zeros where there is none. The rows of x
// need no test then; every output sums the products of the whole-grid
// kernel's row in its order, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A bf16 table value as a float: exact.
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// HALO = false: the whole grid, gx rows of x and y. HALO = true: a slab
// of gx rows of a grid split along axis 0 (one rank's planes); x holds
// gx + 2 rows, the first and the last the neighbours' planes (zeros where
// there is none), so every row x read lies in x and takes no test.
template <typename T, int D, bool HALO>
__global__ void stencil_matvec_kernel(const T* __restrict__ vals,
                                      const T* __restrict__ x,
                                      T* __restrict__ y, int64_t gx,
                                      int64_t m_cols, int64_t gz) {
  const int64_t n = gx * m_cols;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const int64_t i = idx / m_cols;
    const int64_t m = idx - i * m_cols;
    T acc = T(0);
    int o = 0;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int64_t r = HALO ? i + dx : i + dx - 1;
      const bool row_ok = HALO || (r >= 0 && r < gx);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dz = 0; dz < (D == 3 ? 3 : 1); ++dz) {
          const int64_t s = D == 3 ? (dy - 1) * gz + (dz - 1) : (dy - 1);
          const int64_t c = m + s;
          const T xv = (row_ok && c >= 0 && c < m_cols) ? x[r * m_cols + c]
                                                        : T(0);
          acc = acc + vals[(int64_t)o * n + idx] * xv;
          ++o;
        }
      }
    }
    y[idx] = acc;
  }
}

// ---------------------------------------------- bf16 tables, V points
constexpr int kBf16Points = 4;
// two bf16 of a 32-bit word, widened as __bfloat162float does (the bf16
// bits are the float's upper half); the lower address is the low half
__device__ __forceinline__ void widen2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// V bf16 table values from 2 V-byte aligned memory, widened to float
template <int V>
__device__ __forceinline__ void load_widened(const __nv_bfloat16* p,
                                             float* f);
template <>
__device__ __forceinline__ void load_widened<4>(const __nv_bfloat16* p,
                                                float* f) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  widen2(a.x, f);
  widen2(a.y, f + 2);
}

// V values of T to 16-byte aligned memory, 16 bytes a store
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const T* v) {
  constexpr int kPer = 16 / (int)sizeof(T);
  static_assert(V % kPer == 0, "whole 16-byte stores");
#pragma unroll
  for (int k = 0; k < V; k += kPer) store16(p + k, v + k);
}

// 16 bytes of x from 16-byte aligned memory
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = a.x; v[1] = a.y;
}

// w[j] = xv[OFF + j]: the window at a compile-time offset into the
// aligned vectors (registers, never indexed at run time)
template <typename T, int N, int OFF>
__device__ __forceinline__ void pick(const T* xv, T* w) {
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = xv[OFF + j];
}

template <typename T, int D, int V>
__global__ void __launch_bounds__(256) stencil_matvec_bf16_kernel(
    const __nv_bfloat16* __restrict__ vals, const T* __restrict__ x,
    T* __restrict__ y, int64_t gx, int64_t m_cols, int64_t gz,
    int64_t pitch, int x_aligned) {
  constexpr int kRowsA = D == 3 ? 3 : 1;   // dy rows of a dx plane (3D)
  constexpr int kv = 16 / (int)sizeof(T);  // x values a 16-byte vector
  // vectors that hold a window of V + 2 at any offset below kv
  constexpr int kNV = (V + 2 + 2 * (kv - 1)) / kv;
  const int64_t n = gx * m_cols;
  const int64_t n_vec = (n + V - 1) / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_vec; t += stride) {
    const int64_t idx0 = t * V;
    const int64_t i = idx0 / m_cols;
    const int64_t m0 = idx0 - i * m_cols;
    if (m0 + V <= m_cols) {
      // the V points share row i: one window per (dx, dy)
      T acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = T(0);
      int o = 0;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int64_t r = i + dx - 1;
        const bool row_ok = r >= 0 && r < gx;
        const T* xr = x + (row_ok ? r : 0) * m_cols;
#pragma unroll
        for (int a = 0; a < kRowsA; ++a) {
          const int64_t cb = m0 + (D == 3 ? (a - 1) * gz : 0) - 1;
          T w[V + 2];
          // the window's first flat index; its offset into a 16-byte
          // vector, (dx - 1) M + (dy - 1) gz - 1 mod kv, is the same in
          // every thread (idx0 is a multiple of V): a branch, not a
          // divergence
          const int64_t base = (row_ok ? r : 0) * m_cols + cb;
          const int64_t a0 = base - (base & (kv - 1));
          if (row_ok && cb >= 0 && cb + V + 1 < m_cols && x_aligned &&
              a0 + kNV * kv <= n) {
            T xv[kNV * kv];
#pragma unroll
            for (int k = 0; k < kNV; ++k) load16(x + a0 + k * kv, xv + k * kv);
            switch ((int)(base - a0)) {
              case 0: pick<T, V + 2, 0>(xv, w); break;
              case 1: pick<T, V + 2, 1>(xv, w); break;
              case 2: pick<T, V + 2, (kv > 2 ? 2 : 0)>(xv, w); break;
              default: pick<T, V + 2, (kv > 2 ? 3 : 0)>(xv, w); break;
            }
          } else if (row_ok && cb >= 0 && cb + V + 1 < m_cols) {
            // in the row, x off 16 bytes: no bounds tests (folding this
            // into the next branch measured 2-5% slower, PERF.md)
#pragma unroll
            for (int j = 0; j < V + 2; ++j) w[j] = xr[cb + j];
          } else {
#pragma unroll
            for (int j = 0; j < V + 2; ++j) {
              const int64_t c = cb + j;
              w[j] = (row_ok && c >= 0 && c < m_cols) ? xr[c] : T(0);
            }
          }
#pragma unroll
          for (int k = 0; k < 3; ++k, ++o) {
            float tv[V];
            load_widened<V>(vals + o * pitch + idx0, tv);
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = acc[v] + static_cast<T>(tv[v]) * w[v + k];
          }
        }
      }
      store_vec<T, V>(y + idx0, acc);
    } else {
      // a vector across a row end or past the grid: point by point (a
      // device function shared with the one-point kernel, unrolled,
      // measured 2-9% slower, PERF.md)
      for (int v = 0; v < V; ++v) {
        const int64_t idx = idx0 + v;
        if (idx >= n) break;
        const int64_t ip = idx / m_cols;
        const int64_t m = idx - ip * m_cols;
        T acc = T(0);
        int o = 0;
        for (int dx = 0; dx < 3; ++dx) {
          const int64_t r = ip + dx - 1;
          const bool row_ok = r >= 0 && r < gx;
          for (int dy = 0; dy < 3; ++dy) {
            for (int dz = 0; dz < (D == 3 ? 3 : 1); ++dz, ++o) {
              const int64_t s = D == 3 ? (dy - 1) * gz + (dz - 1) : (dy - 1);
              const int64_t c = m + s;
              const T xv = (row_ok && c >= 0 && c < m_cols)
                               ? x[r * m_cols + c] : T(0);
              acc = acc + static_cast<T>(widen(vals[o * pitch + idx])) * xv;
            }
          }
        }
        y[idx] = acc;
      }
    }
  }
}

template <typename T>
int launch_bf16(int d, const void* vals, const void* x, void* y,
                int64_t gx, int64_t m_cols, int64_t gz, int64_t pitch,
                void* stream) {
  const int64_t n = gx * m_cols;
  if (pitch % 8 != 0 || pitch < n || ((uintptr_t)vals & 15) != 0 ||
      ((uintptr_t)y & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int x_aligned = ((uintptr_t)x & 15) == 0;
  const int threads = 256;
  constexpr int V = kBf16Points;
  int64_t blocks = ((n + V - 1) / V + threads - 1) / threads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* v = (const __nv_bfloat16*)vals;
  if (d == 3)
    stencil_matvec_bf16_kernel<T, 3, V><<<(unsigned)blocks, threads, 0, s>>>(
        v, (const T*)x, (T*)y, gx, m_cols, gz, pitch, x_aligned);
  else if (d == 2)
    stencil_matvec_bf16_kernel<T, 2, V><<<(unsigned)blocks, threads, 0, s>>>(
        v, (const T*)x, (T*)y, gx, m_cols, gz, pitch, x_aligned);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T, bool HALO>
int launch(int d, const void* vals, const void* x, void* y, int64_t gx,
           int64_t m_cols, int64_t gz, void* stream) {
  const int64_t n = gx * m_cols;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 3)
    stencil_matvec_kernel<T, 3, HALO><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)vals, (const T*)x, (T*)y, gx, m_cols, gz);
  else if (d == 2)
    stencil_matvec_kernel<T, 2, HALO><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)vals, (const T*)x, (T*)y, gx, m_cols, gz);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code (x, y and the sums): 0 = float32, 1 = float64; table_code
// (vals): the same code, or 2 = bfloat16; d = 2 or 3; gz = grid[d-1].
// pitch: elements from one table to the next, gx * m_cols for f32 / f64
// tables; for bf16 tables a multiple of 8, the tables on 16 bytes.
// Returns cudaGetLastError().
extern "C" int fgt_stencil_matvec(int dtype_code, int table_code, int d,
                                  const void* vals, const void* x, void* y,
                                  int64_t gx, int64_t m_cols, int64_t gz,
                                  int64_t pitch, void* stream) {
  if (gx * m_cols <= 0) return 0;
  if (table_code != 2 && pitch != gx * m_cols)
    return (int)cudaErrorInvalidValue;
  if (dtype_code == 0 && table_code == 0)
    return launch<float, false>(d, vals, x, y, gx, m_cols, gz, stream);
  if (dtype_code == 1 && table_code == 1)
    return launch<double, false>(d, vals, x, y, gx, m_cols, gz, stream);
  if (dtype_code == 0 && table_code == 2)
    return launch_bf16<float>(d, vals, x, y, gx, m_cols, gz, pitch, stream);
  if (dtype_code == 1 && table_code == 2)
    return launch_bf16<double>(d, vals, x, y, gx, m_cols, gz, pitch,
                               stream);
  return (int)cudaErrorInvalidValue;
}

// The halo form: y (gx, m_cols) over a rank's gx planes, from its tables
// vals (3^d, gx, m_cols) and x_ext (gx + 2, m_cols), whose first and last
// rows are the neighbour ranks' planes (zeros where there is none). Each
// output sums the same products in the same order as the whole-grid
// kernel's row, whose zero rows the halo's zeros stand for: bit-equal to
// it. dtype_code as above (the tables in the vector's type); d = 2 or 3.
extern "C" int fgt_stencil_matvec_halo(int dtype_code, int d,
                                       const void* vals, const void* x_ext,
                                       void* y, int64_t gx, int64_t m_cols,
                                       int64_t gz, void* stream) {
  if (gx * m_cols <= 0) return 0;
  if (dtype_code == 0)
    return launch<float, true>(d, vals, x_ext, y, gx, m_cols, gz, stream);
  if (dtype_code == 1)
    return launch<double, true>(d, vals, x_ext, y, gx, m_cols, gz, stream);
  return (int)cudaErrorInvalidValue;
}
