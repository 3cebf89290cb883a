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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A table value in the arithmetic's type: exact for every pair taken.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename V, int D>
__global__ void stencil_matvec_kernel(const V* __restrict__ vals,
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
      const int64_t r = i + dx - 1;
      const bool row_ok = r >= 0 && r < gx;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dz = 0; dz < (D == 3 ? 3 : 1); ++dz) {
          const int64_t s = D == 3 ? (dy - 1) * gz + (dz - 1) : (dy - 1);
          const int64_t c = m + s;
          const T xv = (row_ok && c >= 0 && c < m_cols) ? x[r * m_cols + c]
                                                        : T(0);
          acc = acc + static_cast<T>(widen(vals[(int64_t)o * n + idx])) * xv;
          ++o;
        }
      }
    }
    y[idx] = acc;
  }
}

template <typename T, typename V>
int launch(int d, const void* vals, const void* x, void* y, int64_t gx,
           int64_t m_cols, int64_t gz, void* stream) {
  const int64_t n = gx * m_cols;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 3)
    stencil_matvec_kernel<T, V, 3><<<(unsigned)blocks, threads, 0, s>>>(
        (const V*)vals, (const T*)x, (T*)y, gx, m_cols, gz);
  else if (d == 2)
    stencil_matvec_kernel<T, V, 2><<<(unsigned)blocks, threads, 0, s>>>(
        (const V*)vals, (const T*)x, (T*)y, gx, m_cols, gz);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code (x, y and the sums): 0 = float32, 1 = float64; table_code
// (vals): the same code, or 2 = bfloat16; d = 2 or 3; gz = grid[d-1].
// Returns cudaGetLastError().
extern "C" int fgt_stencil_matvec(int dtype_code, int table_code, int d,
                                  const void* vals, const void* x, void* y,
                                  int64_t gx, int64_t m_cols, int64_t gz,
                                  void* stream) {
  if (gx * m_cols <= 0) return 0;
  if (dtype_code == 0 && table_code == 0)
    return launch<float, float>(d, vals, x, y, gx, m_cols, gz, stream);
  if (dtype_code == 1 && table_code == 1)
    return launch<double, double>(d, vals, x, y, gx, m_cols, gz, stream);
  if (dtype_code == 0 && table_code == 2)
    return launch<float, __nv_bfloat16>(d, vals, x, y, gx, m_cols, gz,
                                        stream);
  if (dtype_code == 1 && table_code == 2)
    return launch<double, __nv_bfloat16>(d, vals, x, y, gx, m_cols, gz,
                                         stream);
  return (int)cudaErrorInvalidValue;
}
