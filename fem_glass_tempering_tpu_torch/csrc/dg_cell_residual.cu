// Fused cell term of the heat residual (mass + source + diffusion), one
// thread per cell.
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
// (all cells congruent) qw (q,), gphi (q, nloc, g), selected by `uniform`
// and never expanded to O(cells). No padding, no transposed copy: the TPU
// kernel's (nloc, g, cells, q) layout and 512-cell blocks served its
// vector tiles, not the arithmetic.
//
// Bound: device-memory bytes. A hex DG-1 cell moves 224 values with
// per-cell tables (192 of them gphi) and 32 with uniform tables, for about
// 1.2 kflop: far under the card's flop rate per byte. Design: phi, and the
// uniform tables when given, sit in shared memory, so a uniform-mesh call
// streams only Tc, Tpc and out; each thread keeps its cell's Tc, Tpc and
// the nloc partial sums in registers and walks the quadrature points once.
// Per-cell tables are read straight from device memory, each thread its
// own contiguous q*nloc*g run (not coalesced across the warp; L1 holds the
// lines between a thread's consecutive reads).
//
// Sums run over m, then q, then g in the plain version's order, and the
// library is built with -fmad=false, so the two differ only where the
// plain version's matrix products reorder a sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNloc = 32;   // runtime-shape instantiation (NLOC == 0)
constexpr int kMaxG = 3;

template <typename T, int NLOC, int G>
__global__ void dg_cell_residual_kernel(
    const T* __restrict__ Tc, const T* __restrict__ Tpc,
    const T* __restrict__ qw, const T* __restrict__ gphi,
    const T* __restrict__ phi, const T* __restrict__ src,
    T* __restrict__ out, int64_t n_cells, int nloc_rt, int nq, int g_rt,
    int uniform, T dt, T c_mass, T dt_cdiff, T f_src, T dt_f) {
  constexpr int NL = NLOC > 0 ? NLOC : kMaxNloc;
  constexpr int NG = NLOC > 0 ? G : kMaxG;
  const int nloc = NLOC > 0 ? NLOC : nloc_rt;
  const int ng = NLOC > 0 ? G : g_rt;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_phi = reinterpret_cast<T*>(smem_raw);          // (nq, nloc)
  T* s_qw = s_phi + nq * nloc;                        // (nq,)       uniform
  T* s_gphi = s_qw + nq;                              // (nq,nloc,ng) uniform
  for (int i = threadIdx.x; i < nq * nloc; i += blockDim.x) s_phi[i] = phi[i];
  if (uniform) {
    for (int i = threadIdx.x; i < nq; i += blockDim.x) s_qw[i] = qw[i];
    for (int i = threadIdx.x; i < nq * nloc * ng; i += blockDim.x)
      s_gphi[i] = gphi[i];
  }
  __syncthreads();

  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;

  T tc[NL], tpc[NL], acc_m[NL], acc_d[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (l < nloc) {
      tc[l] = Tc[c * nloc + l];
      tpc[l] = Tpc[c * nloc + l];
      acc_m[l] = T(0);
      acc_d[l] = T(0);
    }
  }
  const int gstride = nloc * ng;
  const T* qw_c = uniform ? s_qw : qw + c * nq;
  const T* gphi_c = uniform ? s_gphi : gphi + c * (int64_t)nq * gstride;
  const T* src_c = src ? src + c * nq : nullptr;

  for (int q = 0; q < nq; ++q) {
    const T* ph = s_phi + q * nloc;
    const T* gp = gphi_c + q * gstride;
    T tq = T(0), tpq = T(0);
    T gt[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) gt[g] = T(0);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (l < nloc) {
        tq = tq + tc[l] * ph[l];
        tpq = tpq + tpc[l] * ph[l];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (g < ng) gt[g] = gt[g] + tc[l] * gp[l * ng + g];
      }
    }
    const T w = qw_c[q];
    const T dtf = src_c ? dt * (f_src + src_c[q]) : dt_f;
    const T ms = w * (c_mass * (tq - tpq) - dtf);
#pragma unroll
    for (int g = 0; g < NG; ++g) gt[g] = w * gt[g];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (l < nloc) {
        acc_m[l] = acc_m[l] + ms * ph[l];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (g < ng) acc_d[l] = acc_d[l] + gt[g] * gp[l * ng + g];
      }
    }
  }
#pragma unroll
  for (int l = 0; l < NL; ++l)
    if (l < nloc) out[c * nloc + l] = acc_m[l] + dt_cdiff * acc_d[l];
}

template <typename T, int NLOC, int G>
int launch_shape(const void* Tc, const void* Tpc, const void* qw,
                 const void* gphi, const void* phi, const void* src,
                 void* out, int64_t n_cells, int nloc, int nq, int g,
                 int uniform, double dt, double c_mass, double c_diff,
                 double f_src, void* stream) {
  const int threads = 128;
  const int64_t blocks = (n_cells + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)nq * nloc;
  if (uniform) smem += (size_t)nq + (size_t)nq * nloc * g;
  smem *= sizeof(T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  // scalars are formed in double and rounded once, as the plain version's
  // Python floats are when they meet a tensor
  dg_cell_residual_kernel<T, NLOC, G>
      <<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
          (const T*)Tc, (const T*)Tpc, (const T*)qw, (const T*)gphi,
          (const T*)phi, (const T*)src, (T*)out, n_cells, nloc, nq, g,
          uniform, (T)dt, (T)c_mass, (T)(dt * c_diff), (T)f_src,
          (T)(dt * f_src));
  return (int)cudaGetLastError();
}

#define FGT_DG_ARGS                                                         \
  Tc, Tpc, qw, gphi, phi, src, out, n_cells, nloc, nq, g, uniform, dt,      \
      c_mass, c_diff, f_src, stream

template <typename T>
int launch(const void* Tc, const void* Tpc, const void* qw, const void* gphi,
           const void* phi, const void* src, void* out, int64_t n_cells,
           int nloc, int nq, int g, int uniform, double dt, double c_mass,
           double c_diff, double f_src, void* stream) {
  // the degree-1 cells get unrolled instantiations; any other shape up to
  // (kMaxNloc, kMaxG) runs the runtime-bound one
  if (nloc == 2 && g == 1) return launch_shape<T, 2, 1>(FGT_DG_ARGS);
  if (nloc == 3 && g == 2) return launch_shape<T, 3, 2>(FGT_DG_ARGS);
  if (nloc == 4 && g == 2) return launch_shape<T, 4, 2>(FGT_DG_ARGS);
  if (nloc == 4 && g == 3) return launch_shape<T, 4, 3>(FGT_DG_ARGS);
  if (nloc == 8 && g == 3) return launch_shape<T, 8, 3>(FGT_DG_ARGS);
  if (nloc >= 1 && nloc <= kMaxNloc && g >= 1 && g <= kMaxG)
    return launch_shape<T, 0, 0>(FGT_DG_ARGS);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype_code: 0 = float32, 1 = float64. `uniform` != 0: qw is (nq,) and
// gphi (nq, nloc, g), shared by every cell. `src` may be null (no
// per-point source). Returns cudaGetLastError().
extern "C" int fgt_dg_cell_residual(
    int dtype_code, const void* Tc, const void* Tpc, const void* qw,
    const void* gphi, const void* phi, const void* src, void* out,
    int64_t n_cells, int nloc, int nq, int g, int uniform, double dt,
    double c_mass, double c_diff, double f_src, void* stream) {
  if (n_cells <= 0) return 0;
  if (nq < 1) return (int)cudaErrorInvalidValue;
  if (dtype_code == 0) return launch<float>(FGT_DG_ARGS);
  if (dtype_code == 1) return launch<double>(FGT_DG_ARGS);
  return (int)cudaErrorInvalidValue;
}
