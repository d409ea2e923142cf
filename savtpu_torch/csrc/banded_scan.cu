// K4: the comm-free scan on the banded (block-tridiagonal) layout.
//
// Replaces savtpu/ops/pallas_banded.py:55 (_kernel, via
// pallas_scan_comm_free_banded): num_steps central-difference steps of
// every part with no exchange, no prediction overwrite, no recording and
// no compensation (the sweep's sync-avoiding mode). It is the online
// kernel (online_banded.cu) without those duties and without the
// translation mean, and shares its band matvec (common.cuh).
//
// Design: one persistent block per part (the TPU grid over parts, with the
// time loop inside) walks all steps; the state d0, dn, the matvec result
// and the per-DOF coefficients live in shared memory, in the fitted
// (nc*Bk) layout whose pad slots carry lM = 1 and bc = 0. Each step is the
// band matvec, then the update.
//
// What bounds it: the band. One part's Kd and Kl (2 nc Bk^2 values, 3.7 MB
// at nc=7, Bk=256, float32) are far above the 227 KB a block may hold, so
// every step re-reads them; only P of the 132 SMs are busy, and each step
// is bound by what those SMs can stream. Spreading a part over several SMs
// is the redesign a later PR makes.
//
// Rounding: built with -fmad=false; the update rounds like the plain
// version in ops/banded_scan.py (t = t0 + i dt, coefficients from t0, dt,
// alpha in the state dtype, as the TPU kernel forms them). Only the band
// matvec's sum order differs.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int NT = 1024;

template <typename T>
__global__ void __launch_bounds__(NT) banded_scan_kernel(
    const T* __restrict__ Kd, const T* __restrict__ Kl,
    const T* __restrict__ d0_in, const T* __restrict__ dn_in,
    const T* __restrict__ Fp_in, const T* __restrict__ lM_in,
    const T* __restrict__ bc_in, T* __restrict__ d0_out,
    T* __restrict__ dn_out, int nc, int Bk, int num_steps, int ramped, T t0,
    T dt, T alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = blockIdx.x, tid = threadIdx.x;
  const int DLB = nc * Bk;

  T* d0 = reinterpret_cast<T*>(smem_raw);
  T* dn = d0 + DLB;
  T* y = dn + DLB;
  T* Fp = y + DLB;
  T* lM = Fp + DLB;
  T* bc = lM + DLB;

  const size_t vo = (size_t)p * DLB;
  for (int j = tid; j < DLB; j += NT) {
    d0[j] = d0_in[vo + j];
    dn[j] = dn_in[vo + j];
    Fp[j] = Fp_in[vo + j];
    lM[j] = lM_in[vo + j];
    bc[j] = bc_in[vo + j];
  }
  __syncthreads();

  const T* Kd_p = Kd + (size_t)p * nc * Bk * Bk;
  const T* Kl_p = Kl + (size_t)p * nc * Bk * Bk;
  const savtpu::StepCoeffs<T> coef(dt, alpha);

  for (int t = 0; t < num_steps; ++t) {
    savtpu::band_matvec<T, NT>(Kd_p, Kl_p, d0, y, nc, Bk);
    const T ramp = savtpu::ramp_at(t0, dt, t, ramped);
    for (int j = tid; j < DLB; j += NT) {
      const T a = d0[j];
      const T d1 = savtpu::central_difference(coef, y[j], a, dn[j], Fp[j],
                                              lM[j], bc[j], ramp);
      dn[j] = a;
      d0[j] = d1;
    }
    __syncthreads();
  }

  for (int j = tid; j < DLB; j += NT) {
    d0_out[vo + j] = d0[j];
    dn_out[vo + j] = dn[j];
  }
}

template <typename T>
int launch(const void* Kd, const void* Kl, const void* d0, const void* dn,
           const void* Fp, const void* lM, const void* bc, void* d0_out,
           void* dn_out, void* stream, int P, int nc, int Bk, int num_steps,
           int ramped, double t0, double dt, double alpha) {
  if (P <= 0 || nc <= 0 || Bk <= 0 || num_steps <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 6 * (size_t)nc * Bk * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_scan_kernel<T><<<P, NT, smem, (cudaStream_t)stream>>>(
      (const T*)Kd, (const T*)Kl, (const T*)d0, (const T*)dn, (const T*)Fp,
      (const T*)lM, (const T*)bc, (T*)d0_out, (T*)dn_out, nc, Bk, num_steps,
      ramped, (T)t0, (T)dt, (T)alpha);
  return (int)cudaGetLastError();
}

}  // namespace

#define SAVTPU_BANDED_ARGS                                                  \
  const void *Kd, const void *Kl, const void *d0, const void *dn,           \
      const void *Fp, const void *lM, const void *bc, void *d0_out,         \
      void *dn_out, void *stream, int P, int nc, int Bk, int num_steps,     \
      int ramped, double t0, double dt, double alpha
#define SAVTPU_BANDED_CALL                                                  \
  Kd, Kl, d0, dn, Fp, lM, bc, d0_out, dn_out, stream, P, nc, Bk, num_steps, \
      ramped, t0, dt, alpha

extern "C" int savtpu_banded_scan_f32(SAVTPU_BANDED_ARGS) {
  return launch<float>(SAVTPU_BANDED_CALL);
}

extern "C" int savtpu_banded_scan_f64(SAVTPU_BANDED_ARGS) {
  return launch<double>(SAVTPU_BANDED_CALL);
}

extern "C" const char* savtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
