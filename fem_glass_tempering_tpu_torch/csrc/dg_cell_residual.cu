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

// ------------------------------------------------------------ element form
// The degree-2 cells (nloc, g) = (3, 1), (6, 2), (9, 2), (10, 3), (27, 3).
// The cell term is linear in (Tc, Tpc) with per-call scalar coefficients,
// so with the element matrices M = sum_q qw phi_q phi_q^T, K = sum_q qw
// sum_g d_g phi_q d_g phi_q^T and b = sum_q qw phi_q, baked once from the
// tables (ops/cuda_dg_cell.py), and s = sum_q qw src_q phi_q:
//   r = c_mass M (Tc - Tpc) - dt (f b + s) + dt c_diff K Tc.
// That is the function above with a fraction of its work: at nloc 27 two
// 27 x 27 products (2,916 operations a cell) against 13,392 of the
// quadrature form; with per-cell tables at nloc 10, the two symmetric
// matrices (110 values a cell) against 1,984 table values.
//
// What bounds it: device-memory bytes. Uniform tables: Tc, Tpc and r
// alone (81 values a cell at nloc 27); the FP32 / FP64 units could do the
// products in half the time the bytes take, if their operands come cheap.
// So one thread takes one cell and holds its nloc mass and nloc diffusion
// sums in registers; M^T and K^T sit in shared memory, and the thread
// reads row m of each (column m of M and K) as 16-byte vectors at the
// same address in every lane (a broadcast): per m, 2 lane-own loads of
// Tc[m] and Tc[m] - Tpc[m] and 2 nloc / (16 / sizeof(T)) broadcast loads
// feed 2 nloc multiply-adds. Per-cell tables: the upper triangles of M and
// K, entry-major (entry, cell), so a warp's 32 cells read each entry as one
// coalesced run; every value is read once. A warp's Tc, Tpc and r rows are
// one contiguous run each, moved with coalesced accesses through a shared
// tile of odd row stride (no bank conflicts), as in the row kernel.
// Measured on an H100 (700 W; PERF.md): nloc 27 at 65,536 cells 0.0128 ms
// in f32 and 0.0271 in f64, about half the byte bound: each warp loads its
// tile, then computes it, and nothing overlaps the two within a warp; f64
// takes 180 registers a thread and 68 KB of shared memory a block (8
// warps an SM). A persistent form that kept the next tile in flight
// (cp.async into a second buffer) measured slower (0.0147 / 0.0298 ms):
// its second buffer halves the warps an SM holds.
//
// K Tc cancels: K's rows sum to ~0 (the basis gradients do) while Tc is
// ~700 K, so the products sum to a residual far below their size and
// their rounding is noise that an rtol 1e-12 Newton solve sees (phase
// 10a's CG-2 SA-AMG plate stopped a Newton iteration early). So the
// diffusion sum runs on Tc - t0, t0 = Tc[c, 0], and adds t0 (K 1)
// after: K Tc = K (Tc - t0) + t0 K 1, the same function for any tables.
// K 1 is summed in f64 from K before K is rounded: the rows of the
// rounded K sum to its rounding (in f32 ~1e-7 of K's entries), which t0
// ~ 600 K turns into a spurious flux, ~4e-4 of the cell term on phase
// 10b's thin plate. With K 1 so, the f32 form computes the function of
// its tables there to ~3e-7 of the cell term, where the quadrature form
// misses it by ~5e-4 (tests/test_torch_k3_element.py).
//
// Every output sums over m in ascending order, the mass and diffusion
// sums apart, combined in the epilogue as the plain version combines its
// two terms (with the packed triangle too: entry (l, m), l <= m, adds to
// row l at column m and to row m at column l, so each row meets its
// columns in ascending order). Built with contraction, like the kernels
// above; held to the quadrature plain version at 1e-12 (f64) / 1e-5 (f32)
// of the sum of the terms' magnitudes.
constexpr int kElemThreads = 128;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void get(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ static void put(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void get(const double* p, double* v) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
  __device__ static void put(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// odd row stride of the staged Tc and Tc - Tpc rows
template <int NLOC>
__host__ __device__ constexpr int elem_row() {
  return NLOC % 2 ? NLOC : NLOC + 1;
}
// row pitch of the staged uniform matrices: rows start on 16 bytes
template <typename T, int NLOC>
__host__ __device__ constexpr int elem_pitch() {
  return (NLOC + Vec16<T>::n - 1) / Vec16<T>::n * Vec16<T>::n;
}
// shared memory of a block, in elements of T: uniform M^T, K^T, b, K 1,
// then each warp's 32 rows of Tc and 32 of Tc - Tpc
template <typename T, int NLOC, bool PER_CELL>
__host__ __device__ constexpr int elem_smem_elems() {
  return (PER_CELL ? 0 : (2 * NLOC + 2) * elem_pitch<T, NLOC>()) +
         kElemThreads * 2 * elem_row<NLOC>();
}

template <typename T, int NLOC, bool PER_CELL>
__global__ void __launch_bounds__(kElemThreads) dg_cell_element_kernel(
    const T* __restrict__ Tc, const T* __restrict__ Tpc,
    const T* __restrict__ Mg, const T* __restrict__ Kg,
    const T* __restrict__ bg, const T* __restrict__ k1g,
    const T* __restrict__ sg, T* __restrict__ out, int64_t n_cells,
    const Scalars<T> s, int aligned) {
  constexpr int kRow = elem_row<NLOC>();
  constexpr int kPitch = elem_pitch<T, NLOC>();
  constexpr int kV = Vec16<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_M = reinterpret_cast<T*>(smem_raw);       // M^T, rows of kPitch
  T* s_K = s_M + (PER_CELL ? 0 : NLOC * kPitch);  // K^T
  T* s_b = s_K + (PER_CELL ? 0 : NLOC * kPitch);
  T* s_k1 = s_b + (PER_CELL ? 0 : kPitch);        // K 1
  T* s_rows = s_k1 + (PER_CELL ? 0 : kPitch);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* s_tc = s_rows + warp * 64 * kRow;
  T* s_du = s_tc + 32 * kRow;
  const bool has_b = bg != nullptr;

  if (!PER_CELL) {
    for (int i = threadIdx.x; i < NLOC * NLOC; i += kElemThreads) {
      const int l = i / NLOC, m = i - l * NLOC;
      s_M[m * kPitch + l] = Mg[i];
      s_K[m * kPitch + l] = Kg[i];
    }
    if (threadIdx.x < NLOC) {
      s_b[threadIdx.x] = has_b ? bg[threadIdx.x] : T(0);
      s_k1[threadIdx.x] = k1g[threadIdx.x];
    }
    __syncthreads();
  }

  const int64_t c0 = (int64_t)blockIdx.x * kElemThreads + warp * 32;
  if (c0 >= n_cells) return;                // after the block's one barrier
  const int64_t e0 = c0 * NLOC;
  const int64_t left = (n_cells - c0) * NLOC;
  // Per-cell tables: a whole tile of 16-byte aligned rows moves as
  // 16-byte vectors (a warp's tile, 32 NLOC values, is a whole number of
  // them), stored as vectors too where the tile's rows are unpadded (odd
  // NLOC). Measured on an H100 (700 W; PERF.md): per-cell nloc 27 at
  // 27,648 cells 0.0498 -> 0.0343 ms in f32 (255 registers with spills
  // -> 168 without) and 0.1155 -> 0.0656 in f64; the uniform kernel
  // took 7% longer so (0.0126 -> 0.0135 ms at nloc 27 f32), and keeps
  // the element-wise moves.
  constexpr int kTile = 32 * NLOC;
  const bool whole = PER_CELL && aligned && left >= kTile;
  if (whole) {
#pragma unroll
    for (int i = 0; i < (kTile / kV + 31) / 32; ++i) {
      const int k = (i * 32 + lane) * kV;
      if (k < kTile) {
        T a[kV], p[kV];
        Vec16<T>::get(Tc + e0 + k, a);
        Vec16<T>::get(Tpc + e0 + k, p);
#pragma unroll
        for (int v = 0; v < kV; ++v) p[v] = a[v] - p[v];
        if (kRow == NLOC) {
          Vec16<T>::put(s_tc + k, a);
          Vec16<T>::put(s_du + k, p);
        } else {
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const int at = ((k + v) / NLOC) * kRow + (k + v) % NLOC;
            s_tc[at] = a[v];
            s_du[at] = p[v];
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NLOC; ++i) {
      const int j = i * 32 + lane;
      if (j < left) {
        const int at = (j / NLOC) * kRow + j % NLOC;
        const T a = Tc[e0 + j];
        s_tc[at] = a;
        s_du[at] = a - Tpc[e0 + j];
      }
    }
  }
  __syncwarp();

  const int64_t c = c0 + lane;
  if (c < n_cells) {
    const T* tc = s_tc + lane * kRow;
    const T* du = s_du + lane * kRow;
    const T t0 = tc[0];
    T am[NLOC], ad[NLOC];
#pragma unroll
    for (int l = 0; l < NLOC; ++l) {
      am[l] = T(0);
      ad[l] = T(0);
    }
    if (PER_CELL) {
      int e = 0;
#pragma unroll
      for (int l = 0; l < NLOC; ++l) {
#pragma unroll
        for (int m = l; m < NLOC; ++m, ++e) {
          const T mv = Mg[(int64_t)e * n_cells + c];
          const T kv = Kg[(int64_t)e * n_cells + c];
          am[l] = am[l] + mv * du[m];
          ad[l] = ad[l] + kv * (tc[m] - t0);
          if (m != l) {
            am[m] = am[m] + mv * du[l];
            ad[m] = ad[m] + kv * (tc[l] - t0);
          }
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < NLOC; ++m) {
        const T u = du[m], t = tc[m] - t0;
#pragma unroll
        for (int l0 = 0; l0 < NLOC; l0 += kV) {
          T mv[kV], kv[kV];
          Vec16<T>::get(s_M + m * kPitch + l0, mv);
          Vec16<T>::get(s_K + m * kPitch + l0, kv);
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            if (l0 + v < NLOC) {
              am[l0 + v] = am[l0 + v] + mv[v] * u;
              ad[l0 + v] = ad[l0 + v] + kv[v] * t;
            }
          }
        }
      }
    }
    T* r = s_du + lane * kRow;      // this lane's row: read above, now free
#pragma unroll
    for (int l = 0; l < NLOC; ++l) {
      T src = T(0);
      if (has_b)
        src = s.dt_f * (PER_CELL ? bg[(int64_t)l * n_cells + c] : s_b[l]);
      if (sg != nullptr) src = src + s.dt * sg[(int64_t)l * n_cells + c];
      const T k1 = PER_CELL ? k1g[(int64_t)l * n_cells + c] : s_k1[l];
      r[l] = (s.c_mass * am[l] - src) + s.dt_cdiff * (ad[l] + t0 * k1);
    }
  }
  __syncwarp();
  if (whole) {
#pragma unroll
    for (int i = 0; i < (kTile / kV + 31) / 32; ++i) {
      const int k = (i * 32 + lane) * kV;
      if (k < kTile) {
        T a[kV];
        if (kRow == NLOC) {
          Vec16<T>::get(s_du + k, a);
        } else {
#pragma unroll
          for (int v = 0; v < kV; ++v)
            a[v] = s_du[((k + v) / NLOC) * kRow + (k + v) % NLOC];
        }
        Vec16<T>::put(out + e0 + k, a);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NLOC; ++i) {
      const int j = i * 32 + lane;
      if (j < left) out[e0 + j] = s_du[(j / NLOC) * kRow + j % NLOC];
    }
  }
}

template <typename T, int NLOC, bool PER_CELL>
int launch_element(const void* Tc, const void* Tpc, const void* M,
                   const void* K, const void* b, const void* k1,
                   const void* src, void* out, int64_t n_cells,
                   const Scalars<T>& s, void* stream) {
  const size_t smem = (size_t)elem_smem_elems<T, NLOC, PER_CELL>() * sizeof(T);
  auto kernel = dg_cell_element_kernel<T, NLOC, PER_CELL>;
  // above 48 KB (nloc 27 in f64: 67.6 KB) the block's dynamic shared
  // memory is asked for once per process
  static bool opted = false;
  if (smem > 48 * 1024 && !opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const int64_t blocks = (n_cells + kElemThreads - 1) / kElemThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int aligned =
      (((uintptr_t)Tc | (uintptr_t)Tpc | (uintptr_t)out) & 15) == 0;
  kernel<<<(unsigned)blocks, kElemThreads, smem, (cudaStream_t)stream>>>(
      (const T*)Tc, (const T*)Tpc, (const T*)M, (const T*)K, (const T*)b,
      (const T*)k1, (const T*)src, (T*)out, n_cells, s, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_element_shapes(const void* Tc, const void* Tpc, const void* M,
                          const void* K, const void* b, const void* k1,
                          const void* src, void* out, int64_t n_cells,
                          int nloc, int per_cell, double dt, double c_mass,
                          double c_diff, double f_src, void* stream) {
  const Scalars<T> s = make_scalars<T>(dt, c_mass, c_diff, f_src);
#define FGT_ELEM(NLOC)                                                   \
  (per_cell ? launch_element<T, NLOC, true>(Tc, Tpc, M, K, b, k1, src,  \
                                            out, n_cells, s, stream)    \
            : launch_element<T, NLOC, false>(Tc, Tpc, M, K, b, k1, src, \
                                             out, n_cells, s, stream))
  switch (nloc) {
    case 3: return FGT_ELEM(3);
    case 6: return FGT_ELEM(6);
    case 9: return FGT_ELEM(9);
    case 10: return FGT_ELEM(10);
    case 27: return FGT_ELEM(27);
  }
#undef FGT_ELEM
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

// The element form (degree-2 cells, nloc 3, 6, 9, 10, 27). per_cell == 0:
// M and K are (nloc, nloc) row-major and b (nloc,); per_cell != 0: M and K
// hold the upper triangles (l <= m, row-major order of the pairs) as
// (nloc (nloc + 1) / 2, cells) and b is (nloc, cells). k1 = K 1, formed
// before K was rounded, is shaped as b. b may be null (no f term); src,
// the baked source sum_q qw src_q phi_q, is (nloc, cells) or null.
// Returns cudaGetLastError().
extern "C" int fgt_dg_cell_element(
    int dtype_code, const void* Tc, const void* Tpc, const void* M,
    const void* K, const void* b, const void* k1, const void* src, void* out,
    int64_t n_cells, int nloc, int per_cell, double dt, double c_mass,
    double c_diff, double f_src, void* stream) {
  if (n_cells <= 0) return 0;
  if (M == nullptr || K == nullptr || k1 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype_code == 0)
    return launch_element_shapes<float>(Tc, Tpc, M, K, b, k1, src, out,
                                        n_cells, nloc, per_cell, dt, c_mass,
                                        c_diff, f_src, stream);
  if (dtype_code == 1)
    return launch_element_shapes<double>(Tc, Tpc, M, K, b, k1, src, out,
                                         n_cells, nloc, per_cell, dt, c_mass,
                                         c_diff, f_src, stream);
  return (int)cudaErrorInvalidValue;
}
