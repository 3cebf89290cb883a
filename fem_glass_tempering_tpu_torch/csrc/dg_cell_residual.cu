// Fused cell term of the heat residual (mass + source + diffusion).
//
// Replaces fem_glass_tempering_tpu/ops/pallas_kernels.py:make_dg_cell_residual
// (body _dg_cell_kernel). Per cell c and local dof l:
//   Tq[q]   = sum_m Tc[c,m] phi[q,m],   Tpq[q] likewise from Tpc
//   gT[q,g] = sum_m Tc[c,m] gphi[c,q,m,g]
//   r[c,l]  = sum_q qw[c,q] (c_mass (Tq - Tpq) - dt (f + src[c,q])) phi[q,l]
//           + dt c_diff sum_{q,g} qw[c,q] gT[q,g] gphi[c,q,l,g]
// The map is linear in (Tc, Tpc): its tangent is the same kernel on the
// tangents with f = 0 and src absent (ops/cuda_dg_cell.py).
//
// Layouts are the public ones: Tc, Tpc, out (cells, nloc); phi (q, nloc);
// per-cell tables qw (cells, q), gphi (cells, q, nloc, g); uniform tables
// (all cells congruent) qw (q,), gphi (q, nloc, g), never expanded to
// O(cells). No padding, no transposed copy: the TPU kernel's
// (nloc, g, cells, q) layout and 512-cell blocks served its vector tiles,
// not the arithmetic.
//
// What bounds it on this card. With per-cell tables: device-memory bytes
// (a hex DG-1 cell moves 224 values, 192 of them gphi, for ~1.2 kflop).
// With uniform tables a hex cell moves 24 values for the same 1,232
// operations, and the FP64 units, not bytes, are what the kernel waits for:
// without contraction those are 1,232 FP64 instructions, which take longer
// than the bytes at the card's rate. Two kernels follow from that.
//
// 1. Row kernel (uniform tables by value). One thread per cell; phi, qw
//    and gphi arrive in the kernel's parameter struct, so every table
//    value is an operand from the constant bank, read at one address per
//    warp: the inner loops are arithmetic alone, with no table load, no
//    fill loop and no block-wide barrier. This needs the table index to be
//    the same in every lane, which is why this form keeps one thread per
//    cell: with a cell spread over lanes the index differs from lane to
//    lane and constant reads serialise. A warp's 32 rows of Tc, Tpc and
//    out are one contiguous run, moved with coalesced accesses through a
//    padded shared tile that the warp alone owns (__syncwarp only).
//    Taken when the packed tables fit kParamTableBytes and the cell shape
//    has an instantiation; packed per point q as
//    [phi[q,:], qw[q], gphi[q,:,:]] (ops/cuda_dg_cell.py).
// 2. Split kernel (tables in device memory: per-cell tables, and uniform
//    tables too large or too oddly shaped for the parameters). One thread
//    per (cell, local dof), so a warp reads and writes Tc, Tpc and out as
//    contiguous runs and a thread holds a handful of values instead of
//    four arrays of nloc. Lane q of a cell forms Tq, Tpq and gT[q,:] of
//    quadrature point q (looping where q outnumbers the lanes) and leaves
//    qw * (...) in shared memory; then lane l sums over q in order into
//    its own entry. A cell's lanes read neighbouring runs of its gphi.
//    phi, and uniform tables when given, are staged in shared memory once
//    per block; blocks are persistent and walk the cell tiles with a grid
//    stride, sized to the blocks the card keeps resident.
//
// Every output sums over m, then q, then g in the plain version's order in
// both kernels: the work is split across threads, never a sum, so the
// result does not depend on the kernel taken (on the card the two agree
// bit for bit).
//
// Contraction. This source alone is built without -fmad=false
// (ops/kernel_lib.py SOURCE_FLAGS): a fused multiply-add rounds once where
// the plain version's separate multiply and add round twice, so the kernel
// no longer repeats the plain version's roundings; it is held to it at
// 1e-12 (f64) / 1e-5 (f32) of the sum of the terms' magnitudes, which it
// meets with room (the plain version's matrix products fuse too). Measured
// on an H100 before the flag went: the default 1D run keeps Newton 1501 and
// CG 5,962, the CPU's counts, with and without contraction, and the row
// kernel's time at 65,536 hex cells falls from 0.0090 to 0.0065 ms.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxNloc = 32;          // runtime-shape instantiation
constexpr int kMaxG = 3;
constexpr int kRowThreads = 64;       // row kernel: cells of a block
constexpr int kSplitThreads = 256;    // split kernel: most threads of a block
constexpr int kParamTableBytes = 3584;  // of the 4 KB of kernel parameters
constexpr int kXchWidth = 4;          // ms, gT[0..3) of one quadrature point

template <typename T>
struct Scalars {
  T dt, c_mass, dt_cdiff, f_src, dt_f;
};

// scalars are formed in double and rounded once, as the plain version's
// Python floats are when they meet a tensor
template <typename T>
Scalars<T> make_scalars(double dt, double c_mass, double c_diff,
                        double f_src) {
  return {(T)dt, (T)c_mass, (T)(dt * c_diff), (T)f_src, (T)(dt * f_src)};
}

// ---------------------------------------------------------------- row kernel
template <typename T>
struct ParamTables {
  T v[kParamTableBytes / sizeof(T)];
};

template <typename T, int NLOC, int G, int NQ>
__global__ void __launch_bounds__(kRowThreads) dg_cell_row_kernel(
    const T* __restrict__ Tc, const T* __restrict__ Tpc,
    const T* __restrict__ src, T* __restrict__ out, int64_t n_cells,
    int nq_rt, const Scalars<T> s,
    const __grid_constant__ ParamTables<T> tab) {
  constexpr int kRow = NLOC + 1;            // odd stride: no bank conflicts
  constexpr int kRecord = NLOC * (1 + G) + 1;
  const int nq = NQ > 0 ? NQ : nq_rt;
  __shared__ T s_rows[2 * kRowThreads * kRow];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* s_tc = s_rows + warp * 32 * kRow;
  T* s_tp = s_rows + (kRowThreads + warp * 32) * kRow;

  const int64_t c0 = (int64_t)blockIdx.x * kRowThreads + warp * 32;
  if (c0 >= n_cells) return;                // the whole warp leaves
  const int64_t e0 = c0 * NLOC;
  const int64_t left = (n_cells - c0) * NLOC;
#pragma unroll
  for (int i = 0; i < NLOC; ++i) {
    const int j = i * 32 + lane;
    if (j < left) {
      const int at = (j / NLOC) * kRow + j % NLOC;
      s_tc[at] = Tc[e0 + j];
      s_tp[at] = Tpc[e0 + j];
    }
  }
  __syncwarp();

  const int64_t c = c0 + lane;
  if (c < n_cells) {
    T tc[NLOC], tpc[NLOC], acc_m[NLOC], acc_d[NLOC];
#pragma unroll
    for (int l = 0; l < NLOC; ++l) {
      tc[l] = s_tc[lane * kRow + l];
      tpc[l] = s_tp[lane * kRow + l];
      acc_m[l] = T(0);
      acc_d[l] = T(0);
    }
    const T* src_c = src ? src + c * nq : nullptr;
#pragma unroll
    for (int q = 0; q < nq; ++q) {
      // indexed, never through a pointer: with q unrolled every table
      // value is a constant-bank operand of the instruction that uses it
      const int ph = q * kRecord;             // phi[q, :]
      const int gp = ph + NLOC + 1;           // gphi[q, :, :]
      T tq = T(0), tpq = T(0);
      T gt[G];
#pragma unroll
      for (int g = 0; g < G; ++g) gt[g] = T(0);
#pragma unroll
      for (int l = 0; l < NLOC; ++l) {
        tq = tq + tc[l] * tab.v[ph + l];
        tpq = tpq + tpc[l] * tab.v[ph + l];
#pragma unroll
        for (int g = 0; g < G; ++g)
          gt[g] = gt[g] + tc[l] * tab.v[gp + l * G + g];
      }
      const T w = tab.v[ph + NLOC];
      const T dtf = src_c ? s.dt * (s.f_src + src_c[q]) : s.dt_f;
      const T ms = w * (s.c_mass * (tq - tpq) - dtf);
#pragma unroll
      for (int g = 0; g < G; ++g) gt[g] = w * gt[g];
#pragma unroll
      for (int l = 0; l < NLOC; ++l) {
        acc_m[l] = acc_m[l] + ms * tab.v[ph + l];
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc_d[l] = acc_d[l] + gt[g] * tab.v[gp + l * G + g];
      }
    }
#pragma unroll
    for (int l = 0; l < NLOC; ++l)
      s_tc[lane * kRow + l] = acc_m[l] + s.dt_cdiff * acc_d[l];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NLOC; ++i) {
    const int j = i * 32 + lane;
    if (j < left) out[e0 + j] = s_tc[(j / NLOC) * kRow + j % NLOC];
  }
}

template <typename T, int NLOC, int G, int NQ>
int launch_row(const void* Tc, const void* Tpc, const void* tables,
               const void* src, void* out, int64_t n_cells, int nq,
               const Scalars<T>& s, void* stream) {
  const int64_t blocks = (n_cells + kRowThreads - 1) / kRowThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)nq * (NLOC * (1 + G) + 1) * sizeof(T);
  if (bytes > sizeof(ParamTables<T>)) return (int)cudaErrorInvalidValue;
  ParamTables<T> tab;
  memcpy(tab.v, tables, bytes);
  dg_cell_row_kernel<T, NLOC, G, NQ>
      <<<(unsigned)blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
          (const T*)Tc, (const T*)Tpc, (const T*)src, (T*)out, n_cells, nq,
          s, tab);
  return (int)cudaGetLastError();
}

// the tensor-product cells of the uniform boxes; NQ is unrolled for the
// default quadrature (2 points an axis) and a runtime bound otherwise
template <typename T>
int launch_param(const void* Tc, const void* Tpc, const void* tables,
                 const void* src, void* out, int64_t n_cells, int nloc,
                 int nq, int g, double dt, double c_mass, double c_diff,
                 double f_src, void* stream) {
  const Scalars<T> s = make_scalars<T>(dt, c_mass, c_diff, f_src);
#define FGT_ROW(NLOC, G, NQ) \
  launch_row<T, NLOC, G, NQ>(Tc, Tpc, tables, src, out, n_cells, nq, s, stream)
  if (nloc == 2 && g == 1) return nq == 2 ? FGT_ROW(2, 1, 2) : FGT_ROW(2, 1, 0);
  if (nloc == 4 && g == 2) return nq == 4 ? FGT_ROW(4, 2, 4) : FGT_ROW(4, 2, 0);
  if (nloc == 8 && g == 3) return nq == 8 ? FGT_ROW(8, 3, 8) : FGT_ROW(8, 3, 0);
#undef FGT_ROW
  return (int)cudaErrorInvalidValue;
}

// -------------------------------------------------------------- split kernel
template <typename T>
struct alignas(16) Xch {
  T v[kXchWidth];
};

// Shared memory of a block, in elements of T: the exchange records first
// (16-byte aligned), then the cells' Tc|Tpc, then the staged tables. Rows
// carry one element (cells: one record, one 16-byte unit) of padding so
// that lanes a whole row apart do not meet in a bank.
struct SplitLayout {
  int x_stride, t_stride, phi_stride, gphi_stride;
  int off_t, off_phi, off_qw, off_gphi, total;
  __host__ __device__ SplitLayout(int nloc, int nq, int ng, int uniform,
                                  int cpb, int elem_bytes) {
    x_stride = nq + 1;
    t_stride = 2 * nloc + 16 / elem_bytes;
    phi_stride = nloc + 1;
    gphi_stride = nloc * ng + 1;
    off_t = cpb * x_stride * kXchWidth;
    off_phi = off_t + cpb * t_stride;
    off_qw = off_phi + nq * phi_stride;
    off_gphi = off_qw + (uniform ? nq : 0);
    total = off_gphi + (uniform ? nq * gphi_stride : 0);
  }
};

template <typename T, int NLOC, int G>
__global__ void __launch_bounds__(kSplitThreads) dg_cell_split_kernel(
    const T* __restrict__ Tc, const T* __restrict__ Tpc,
    const T* __restrict__ qw, const T* __restrict__ gphi,
    const T* __restrict__ phi, const T* __restrict__ src,
    T* __restrict__ out, int64_t n_cells, int nloc_rt, int nq, int g_rt,
    int uniform, int cpb, const Scalars<T> s) {
  constexpr int NG = NLOC > 0 ? G : kMaxG;
  // a cell's lanes lie in one warp when nloc divides 32: the exchange then
  // needs the warp's barrier only
  constexpr bool kWarpLocal = NLOC > 0 && 32 % (NLOC > 0 ? NLOC : 1) == 0;
  const int nloc = NLOC > 0 ? NLOC : nloc_rt;
  const int ng = NLOC > 0 ? G : g_rt;
  const SplitLayout L(nloc, nq, ng, uniform, cpb, (int)sizeof(T));

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  Xch<T>* s_x = reinterpret_cast<Xch<T>*>(smem_raw);
  T* s_t = smem + L.off_t;
  T* s_phi = smem + L.off_phi;
  T* s_qw = smem + L.off_qw;
  T* s_gphi = smem + L.off_gphi;

  const int gstride = nloc * ng;
  for (int i = threadIdx.x; i < nq * nloc; i += blockDim.x)
    s_phi[(i / nloc) * L.phi_stride + i % nloc] = phi[i];
  if (uniform) {
    for (int i = threadIdx.x; i < nq; i += blockDim.x) s_qw[i] = qw[i];
    for (int i = threadIdx.x; i < nq * gstride; i += blockDim.x)
      s_gphi[(i / gstride) * L.gphi_stride + i % gstride] = gphi[i];
  }
  __syncthreads();

  const int cl = threadIdx.x / nloc;        // cell of the tile
  const int l = threadIdx.x - cl * nloc;    // local dof, and first point
  T* t_c = s_t + cl * L.t_stride;
  Xch<T>* x_c = s_x + cl * L.x_stride;
  const int64_t n_tiles = (n_cells + cpb - 1) / cpb;

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t c = tile * cpb + cl;
    const bool valid = c < n_cells;
    if (valid) {
      t_c[l] = Tc[c * nloc + l];
      t_c[nloc + l] = Tpc[c * nloc + l];
    }
    if (kWarpLocal) __syncwarp(); else __syncthreads();

    const T* gphi_c = gphi + (uniform ? 0 : c * (int64_t)nq * gstride);
    if (valid) {
      for (int q = l; q < nq; q += nloc) {
        const T* ph = s_phi + q * L.phi_stride;
        const T* gp = uniform ? s_gphi + q * L.gphi_stride
                              : gphi_c + q * gstride;
        T tq = T(0), tpq = T(0);
        T gt[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) gt[g] = T(0);
#pragma unroll
        for (int m = 0; m < nloc; ++m) {
          const T a = t_c[m];
          tq = tq + a * ph[m];
          tpq = tpq + t_c[nloc + m] * ph[m];
#pragma unroll
          for (int g = 0; g < NG; ++g)
            if (g < ng) gt[g] = gt[g] + a * gp[m * ng + g];
        }
        const T w = uniform ? s_qw[q] : qw[c * nq + q];
        const T dtf = src ? s.dt * (s.f_src + src[c * nq + q]) : s.dt_f;
        Xch<T> x;
        x.v[0] = w * (s.c_mass * (tq - tpq) - dtf);
#pragma unroll
        for (int g = 0; g < kXchWidth - 1; ++g)
          x.v[1 + g] = g < NG ? w * gt[g < NG ? g : 0] : T(0);
        x_c[q] = x;
      }
    }
    if (kWarpLocal) __syncwarp(); else __syncthreads();

    if (valid) {
      T acc_m = T(0), acc_d = T(0);
#pragma unroll 4
      for (int q = 0; q < nq; ++q) {
        const Xch<T> x = x_c[q];
        const T* gp = (uniform ? s_gphi + q * L.gphi_stride
                               : gphi_c + q * gstride) + l * ng;
        acc_m = acc_m + x.v[0] * s_phi[q * L.phi_stride + l];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (g < ng) acc_d = acc_d + x.v[1 + g] * gp[g];
      }
      out[c * nloc + l] = acc_m + s.dt_cdiff * acc_d;
    }
    // the next tile's Tc|Tpc overwrite rows that no lane reads after the
    // barrier above, and its records are written after the next barrier
  }
}

// blocks the card keeps resident for this kernel and launch shape (the
// kernels of one T share a function type, so the kernel is in the key)
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  static int key_threads = 0, cached = 0;
  static size_t key_smem = 0;
  static K key_kernel = nullptr;
  if (cached == 0 || key_kernel != kernel || key_threads != threads ||
      key_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, smem) != cudaSuccess)
      return 0;
    key_kernel = kernel;
    key_threads = threads;
    key_smem = smem;
    cached = sms * per_sm;
  }
  return cached;
}

template <typename T, int NLOC, int G>
int launch_split(const void* Tc, const void* Tpc, const void* qw,
                 const void* gphi, const void* phi, const void* src,
                 void* out, int64_t n_cells, int nloc, int nq, int g,
                 int uniform, const Scalars<T>& s, void* stream) {
  const int cpb = kSplitThreads / nloc;
  const int threads = cpb * nloc;
  const SplitLayout L(nloc, nq, g, uniform, cpb, (int)sizeof(T));
  const size_t smem = (size_t)L.total * sizeof(T);
  auto kernel = dg_cell_split_kernel<T, NLOC, G>;
  if (smem > 48 * 1024) {
    // above the default 48 KB a block's dynamic shared memory must be
    // asked for (the degree-2 tetrahedron in f64: 64 points, 62 KB)
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int resident = resident_blocks(kernel, threads, smem);
  if (resident <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (n_cells + cpb - 1) / cpb;
  const int64_t blocks = n_tiles < resident ? n_tiles : resident;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)Tc, (const T*)Tpc, (const T*)qw, (const T*)gphi,
      (const T*)phi, (const T*)src, (T*)out, n_cells, nloc, nq, g, uniform,
      cpb, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tables(const void* Tc, const void* Tpc, const void* qw,
                  const void* gphi, const void* phi, const void* src,
                  void* out, int64_t n_cells, int nloc, int nq, int g,
                  int uniform, double dt, double c_mass, double c_diff,
                  double f_src, void* stream) {
  const Scalars<T> s = make_scalars<T>(dt, c_mass, c_diff, f_src);
#define FGT_SPLIT(NLOC, G)                                                  \
  launch_split<T, NLOC, G>(Tc, Tpc, qw, gphi, phi, src, out, n_cells, nloc, \
                           nq, g, uniform, s, stream)
  // the degree-1 cells get unrolled instantiations; any other shape up to
  // (kMaxNloc, kMaxG) runs the runtime-bound one
  if (nloc == 2 && g == 1) return FGT_SPLIT(2, 1);
  if (nloc == 3 && g == 2) return FGT_SPLIT(3, 2);
  if (nloc == 4 && g == 2) return FGT_SPLIT(4, 2);
  if (nloc == 4 && g == 3) return FGT_SPLIT(4, 3);
  if (nloc == 8 && g == 3) return FGT_SPLIT(8, 3);
  if (nloc >= 1 && nloc <= kMaxNloc && g >= 1 && g <= kMaxG)
    return FGT_SPLIT(0, 0);
#undef FGT_SPLIT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype_code: 0 = float32, 1 = float64. Tables in device memory;
// `uniform` != 0: qw is (nq,) and gphi (nq, nloc, g), shared by every
// cell. `src` may be null (no per-point source). Returns
// cudaGetLastError().
extern "C" int fgt_dg_cell_residual(
    int dtype_code, const void* Tc, const void* Tpc, const void* qw,
    const void* gphi, const void* phi, const void* src, void* out,
    int64_t n_cells, int nloc, int nq, int g, int uniform, double dt,
    double c_mass, double c_diff, double f_src, void* stream) {
  if (n_cells <= 0) return 0;
  if (nq < 1) return (int)cudaErrorInvalidValue;
  if (dtype_code == 0)
    return launch_tables<float>(Tc, Tpc, qw, gphi, phi, src, out, n_cells,
                                nloc, nq, g, uniform, dt, c_mass, c_diff,
                                f_src, stream);
  if (dtype_code == 1)
    return launch_tables<double>(Tc, Tpc, qw, gphi, phi, src, out, n_cells,
                                 nloc, nq, g, uniform, dt, c_mass, c_diff,
                                 f_src, stream);
  return (int)cudaErrorInvalidValue;
}

// Uniform tables by value: `tables` points to HOST memory holding, for each
// quadrature point q, [phi[q, 0..nloc), qw[q], gphi[q, 0..nloc, 0..g)] in
// the launch's dtype; they travel in the kernel's parameters.
extern "C" int fgt_dg_cell_residual_param(
    int dtype_code, const void* Tc, const void* Tpc, const void* tables,
    const void* src, void* out, int64_t n_cells, int nloc, int nq, int g,
    double dt, double c_mass, double c_diff, double f_src, void* stream) {
  if (n_cells <= 0) return 0;
  if (nq < 1 || tables == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype_code == 0)
    return launch_param<float>(Tc, Tpc, tables, src, out, n_cells, nloc, nq,
                               g, dt, c_mass, c_diff, f_src, stream);
  if (dtype_code == 1)
    return launch_param<double>(Tc, Tpc, tables, src, out, n_cells, nloc, nq,
                                g, dt, c_mass, c_diff, f_src, stream);
  return (int)cudaErrorInvalidValue;
}

// bytes of uniform tables the parameter struct holds
extern "C" int fgt_dg_cell_param_table_bytes() { return kParamTableBytes; }
