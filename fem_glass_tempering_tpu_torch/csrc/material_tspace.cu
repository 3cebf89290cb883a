// Fused T-space Tool-Narayanaswamy chain.
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
// Tf_p_prev) and writes 9 (phi, Tf, xi, six Tf_p) for ~50 operations, two
// exps and six divisions. 12 of the 17 values lie in the two (n, 6)
// Tf_partial arrays, and a thread that walks its own row of six touches
// them with lanes 24 (f32) or 48 (f64) bytes apart: every load and store
// instruction then spans six to twelve times the sectors it uses, and the
// stores reach the L2 as partial sectors. Design: a block of kTile dofs
// owns kTile x 6 contiguous values of each array. It brings the input run
// into shared memory with coalesced 16-byte loads, each thread computes
// its dof's six terms from its row of the tile and writes them back into
// the same row, and the block stores the tile with coalesced 16-byte
// writes. Rows are padded to a stride of 7 in shared memory, so lanes six
// values apart do not meet in a bank. T, T_prev, phi, Tf and xi are one
// value per dof and coalesced as they are. The public (n, 6) layout is
// kept; the Pallas kernel's tableau-major transpose (a TPU tile
// constraint) would add two passes here.
//
// The last block of a call (n no multiple of kTile) and a call whose
// Tf_partial base pointers are not 16-byte aligned (a view into a larger
// tensor) copy their tile one element at a time, still coalesced and never
// past the end. The tableau's constants travel by value as a kernel
// argument.
//
// The operations run in the order of the plain PyTorch version
// (ops/cuda_kernels.py:material_tspace_reference); the library is built
// with -fmad=false so that no multiply-add is contracted and the two agree
// to the rounding of exp and of the plain version's 6-term dot product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;        // dofs, and threads, of a block
constexpr int kTerms = 6;
constexpr int kRowStride = 7;     // padded row of the shared tile

template <typename T>
struct Tableau {
  T m[kTerms];
  T lam[kTerms];
};

template <typename T> struct Vec16;
template <> struct Vec16<float> { typedef float4 type; };
template <> struct Vec16<double> { typedef double2 type; };

__device__ __forceinline__ void unpack(const float4& x, float* e) {
  e[0] = x.x; e[1] = x.y; e[2] = x.z; e[3] = x.w;
}
__device__ __forceinline__ void unpack(const double2& x, double* e) {
  e[0] = x.x; e[1] = x.y;
}
__device__ __forceinline__ float4 pack(const float* e) {
  return make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ double2 pack(const double* e) {
  return make_double2(e[0], e[1]);
}

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

// flat index j of the (dofs, 6) run -> its place in the padded tile
__device__ __forceinline__ int tile_at(int j) {
  return (j / kTerms) * kRowStride + j % kTerms;
}

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kTile) material_tspace_kernel(
    const T* __restrict__ t_new, const T* __restrict__ t_prev,
    const T* __restrict__ tfp_in, T* __restrict__ phi_out,
    T* __restrict__ tfp_out, T* __restrict__ tf_out, T* __restrict__ xi_out,
    int64_t n, T dt, T h_over_rg, T inv_tb, T half_dt,
    const Tableau<T> tab) {
  typedef typename Vec16<T>::type V;
  constexpr int kPerVec = 16 / sizeof(T);
  constexpr int kVecs = kTile * kTerms / kPerVec;
  constexpr int kVecTrips = (kVecs + kTile - 1) / kTile;
  __shared__ T tile[kTile * kRowStride];

  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int64_t left = n - base;
  const int dofs = left < kTile ? (int)left : kTile;
  const bool by16 = ALIGNED && dofs == kTile;   // one branch per block
  const T* in = tfp_in + base * kTerms;
  T* outp = tfp_out + base * kTerms;

  if (by16) {
    const V* in16 = reinterpret_cast<const V*>(in);
    V x[kVecTrips];
#pragma unroll
    for (int i = 0; i < kVecTrips; ++i) {       // all loads first
      const int v = i * kTile + threadIdx.x;
      if (v < kVecs) x[i] = in16[v];
    }
#pragma unroll
    for (int i = 0; i < kVecTrips; ++i) {
      const int v = i * kTile + threadIdx.x;
      if (v < kVecs) {
        T e[kPerVec];
        unpack(x[i], e);
#pragma unroll
        for (int k = 0; k < kPerVec; ++k)
          tile[tile_at(v * kPerVec + k)] = e[k];
      }
    }
  } else {
    for (int j = threadIdx.x; j < dofs * kTerms; j += kTile)
      tile[tile_at(j)] = in[j];
  }
  __syncthreads();

  if (threadIdx.x < dofs) {
    const int64_t i = base + threadIdx.x;
    T* row = tile + threadIdx.x * kRowStride;
    const T t = t_new[i];
    const T phi = exp_t(h_over_rg * (inv_tb - T(1) / t));
    const T dtphi = dt * phi;
    const T tdtphi = (t * dt) * phi;
    T tf = T(0);
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      const T v = (tab.lam[k] * row[k] + tdtphi) / (tab.lam[k] + dtphi);
      row[k] = v;
      tf = tf + tab.m[k] * v;
    }
    const T t_next = T(2) * t - t_prev[i];
    const T phi_next = exp_t(h_over_rg * (inv_tb - T(1) / t_next));
    phi_out[i] = phi;
    tf_out[i] = tf;
    xi_out[i] = half_dt * (phi_next - phi);
  }
  __syncthreads();

  if (by16) {
    V* out16 = reinterpret_cast<V*>(outp);
#pragma unroll
    for (int i = 0; i < kVecTrips; ++i) {
      const int v = i * kTile + threadIdx.x;
      if (v < kVecs) {
        T e[kPerVec];
#pragma unroll
        for (int k = 0; k < kPerVec; ++k)
          e[k] = tile[tile_at(v * kPerVec + k)];
        out16[v] = pack(e);
      }
    }
  } else {
    for (int j = threadIdx.x; j < dofs * kTerms; j += kTile)
      outp[j] = tile[tile_at(j)];
  }
}

template <typename T>
int launch(const void* t_new, const void* t_prev, const void* tfp_in,
           void* phi, void* tfp_out, void* tf, void* xi, int64_t n,
           double dt, double h_over_rg, double inv_tb, double half_dt,
           const double* m_n, const double* lambda_m_n, void* stream) {
  Tableau<T> tab;
  for (int k = 0; k < kTerms; ++k) {
    tab.m[k] = (T)m_n[k];
    tab.lam[k] = (T)lambda_m_n[k];
  }
  const int64_t blocks = (n + kTile - 1) / kTile;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  // a block's run starts kTile * 6 elements (a multiple of 16 bytes) after
  // the base, so the base pointers decide the alignment of every tile
  const bool aligned =
      (((uintptr_t)tfp_in | (uintptr_t)tfp_out) & (uintptr_t)15) == 0;
  auto kernel = aligned ? material_tspace_kernel<T, true>
                        : material_tspace_kernel<T, false>;
  kernel<<<(unsigned)blocks, kTile, 0, (cudaStream_t)stream>>>(
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
