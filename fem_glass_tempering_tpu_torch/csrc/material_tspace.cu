// Fused T-space Tool-Narayanaswamy chain, one thread per temperature dof.
//
// Replaces fem_glass_tempering_tpu/ops/pallas_kernels.py:material_tspace_pallas
// (body _material_kernel). Per dof:
//   phi      = exp(H/Rg (1/Tb - 1/T))
//   Tf_p[k]  = (lam_k Tf_p_prev[k] + T dt phi) / (lam_k + dt phi),  k < 6
//   Tf       = sum_k m_k Tf_p[k]
//   phi_next = phi(2 T - T_prev)
//   xi       = dt/2 (phi_next - phi)
//
// Bound: device-memory bytes. Each dof reads 8 values (T, T_prev, six
// Tf_p_prev) and writes 9 (phi, Tf, xi, six Tf_p) and does ~40 flops and
// two exps, far below the card's flop rate per byte. Design: one pass over
// the arrays, grid-stride loop, the six-term tableau unrolled with its
// constants passed by value as a kernel argument. The public (n, 6)
// Tf_partial layout is kept: a warp's 32 rows of six values are 192
// contiguous elements, so every fetched sector is used in full, and the
// Pallas kernel's tableau-major transpose (a TPU tile constraint) would
// only add two passes here.
//
// The operations run in the order of the plain PyTorch version
// (ops/cuda_kernels.py:material_tspace_reference); the library is built
// with -fmad=false so that no multiply-add is contracted and the two agree
// to the rounding of exp and of the plain version's 6-term dot product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Tableau {
  T m[6];
  T lam[6];
};

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

template <typename T>
__global__ void material_tspace_kernel(
    const T* __restrict__ t_new, const T* __restrict__ t_prev,
    const T* __restrict__ tfp_in, T* __restrict__ phi_out,
    T* __restrict__ tfp_out, T* __restrict__ tf_out, T* __restrict__ xi_out,
    int64_t n, T dt, T h_over_rg, T inv_tb, T half_dt, Tableau<T> tab) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T t = t_new[i];
    const T phi = exp_t(h_over_rg * (inv_tb - T(1) / t));
    const T dtphi = dt * phi;
    const T tdtphi = (t * dt) * phi;
    T tf = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const T v = (tab.lam[k] * tfp_in[6 * i + k] + tdtphi) /
                  (tab.lam[k] + dtphi);
      tfp_out[6 * i + k] = v;
      tf = tf + tab.m[k] * v;
    }
    const T t_next = T(2) * t - t_prev[i];
    const T phi_next = exp_t(h_over_rg * (inv_tb - T(1) / t_next));
    phi_out[i] = phi;
    tf_out[i] = tf;
    xi_out[i] = half_dt * (phi_next - phi);
  }
}

template <typename T>
int launch(const void* t_new, const void* t_prev, const void* tfp_in,
           void* phi, void* tfp_out, void* tf, void* xi, int64_t n,
           double dt, double h_over_rg, double inv_tb, double half_dt,
           const double* m_n, const double* lambda_m_n, void* stream) {
  Tableau<T> tab;
  for (int k = 0; k < 6; ++k) {
    tab.m[k] = (T)m_n[k];
    tab.lam[k] = (T)lambda_m_n[k];
  }
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  if (blocks < 1) blocks = 1;
  material_tspace_kernel<T><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const T*)t_new, (const T*)t_prev, (const T*)tfp_in, (T*)phi,
      (T*)tfp_out, (T*)tf, (T*)xi, n, (T)dt, (T)h_over_rg, (T)inv_tb,
      (T)half_dt, tab);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = float64. Returns cudaGetLastError().
extern "C" int fgt_material_tspace(int dtype_code, const void* t_new,
                                   const void* t_prev, const void* tfp_in,
                                   void* phi, void* tfp_out, void* tf,
                                   void* xi, int64_t n, double dt,
                                   double h_over_rg, double inv_tb,
                                   double half_dt, const double* m_n,
                                   const double* lambda_m_n, void* stream) {
  if (n <= 0) return 0;
  if (dtype_code == 0)
    return launch<float>(t_new, t_prev, tfp_in, phi, tfp_out, tf, xi, n, dt,
                         h_over_rg, inv_tb, half_dt, m_n, lambda_m_n, stream);
  if (dtype_code == 1)
    return launch<double>(t_new, t_prev, tfp_in, phi, tfp_out, tf, xi, n, dt,
                          h_over_rg, inv_tb, half_dt, m_n, lambda_m_n,
                          stream);
  return (int)cudaErrorInvalidValue;
}
