// The dense local-K step kernels, K1 and K2.
//
// K1 (fint_matvec) replaces savtpu/ops/pallas_step.py:59 (_matvec_kernel,
// via batched_fint_matvec): one step's F_int = K d for every part, K
// (P, DL, DL) symmetric and row-major. One warp per row: the lanes walk
// the row with consecutive addresses, so K is read coalesced, and sum it
// with shuffles. Eight rows per block, grid (DL/8, P). It is bound by
// reading K once (P DL^2 values per call); at the sweep's sizes a call is
// short enough that its launch weighs as much.
//
// K2 (scan_comm_free) replaces savtpu/ops/pallas_step.py:97 (_scan_kernel,
// via pallas_scan_comm_free): the whole comm-free scan, num_steps
// central-difference steps of every part, with optional prediction
// overwrite of the shared slots and per-step recording of the shared rows.
// One persistent block per part walks all steps (parts are independent
// without the exchange); the state d0, dn, the matvec result and the
// per-DOF coefficients live in shared memory. Each step is a matvec (a warp
// per row) and, after a block barrier, the update. Where one part's K fits
// in shared memory beside the state (DL <= ~230 in float32, the sweep's
// 25x1x1/2) it is loaded once and stays there, the counterpart of the
// TPU's VMEM-resident K; otherwise every step re-reads it from global
// memory: from L2 while all parts' K fits its 50 MB (48x4x4/8, 8.9 MB),
// from HBM beyond (96x8x8/8, 320 MB). Only P of the 132 SMs are busy; the
// bound is how much of K those SMs can stream per step. The shared-slot
// overwrite and recording go through a slot map (slot[j] = the shared slot
// of local DOF j, or -1) instead of the TPU's one-hot matmuls, which were
// exact: the values are the same.
//
// Rounding: built with -fmad=false; the update (common.cuh) rounds like the
// plain versions in ops/dense_step.py, which form t = t0 + i dt and the
// coefficients from t0, dt, alpha cast to the state dtype, as the TPU
// kernel does. Only the matvec's sum order differs.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using savtpu::Rn;
using savtpu::warp_sum;

constexpr int MV_ROWS = 8;       // K1: rows (warps) per block
constexpr int NT = 1024;         // K2: threads per block
constexpr int NW = NT / 32;

template <typename T>
__global__ void __launch_bounds__(MV_ROWS * 32) fint_matvec_kernel(
    const T* __restrict__ K, const T* __restrict__ d, T* __restrict__ out,
    int DL) {
  const int p = blockIdx.y;
  const int row = blockIdx.x * MV_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= DL) return;  // whole warps only
  const T* k = K + ((size_t)p * DL + row) * DL;
  const T* x = d + (size_t)p * DL;
  T acc = 0;
#pragma unroll 4
  for (int j = lane; j < DL; j += 32) acc += k[j] * x[j];
  acc = warp_sum(acc);
  if (lane == 0) out[(size_t)p * DL + row] = acc;
}

template <typename T, bool K_SHARED>
__global__ void __launch_bounds__(NT) scan_kernel(
    const T* __restrict__ K, const T* __restrict__ d0_in,
    const T* __restrict__ dn_in, const T* __restrict__ Fp_in,
    const T* __restrict__ lM_in, const T* __restrict__ bc_in,
    const int* __restrict__ slot_in, const T* __restrict__ preds,
    T* __restrict__ d0_out, T* __restrict__ dn_out,
    T* __restrict__ shared_out, int DL, int S3, int num_steps,
    int use_preds, int record_shared, int ramped, T t0, T dt, T alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  T* d0 = reinterpret_cast<T*>(smem_raw);
  T* dn = d0 + DL;
  T* y = dn + DL;
  T* Fp = y + DL;
  T* lM = Fp + DL;
  T* bc = lM + DL;
  T* Ks = bc + DL;                                 // DL * DL if K_SHARED
  int* slot = reinterpret_cast<int*>(Ks + (K_SHARED ? (size_t)DL * DL : 0));

  const size_t vo = (size_t)p * DL;
  for (int j = tid; j < DL; j += NT) {
    d0[j] = d0_in[vo + j];
    dn[j] = dn_in[vo + j];
    Fp[j] = Fp_in[vo + j];
    lM[j] = lM_in[vo + j];
    bc[j] = bc_in[vo + j];
    slot[j] = slot_in[vo + j];
  }
  const T* Kg = K + (size_t)p * DL * DL;
  if (K_SHARED) {
    for (size_t j = tid; j < (size_t)DL * DL; j += NT) Ks[j] = Kg[j];
  }
  __syncthreads();
  const T* Kp = K_SHARED ? Ks : Kg;

  const savtpu::StepCoeffs<T> coef(dt, alpha);
  const T* preds_p = use_preds ? preds + (size_t)p * num_steps * S3 : nullptr;
  T* shared_p =
      record_shared ? shared_out + (size_t)p * num_steps * S3 : nullptr;

  for (int t = 0; t < num_steps; ++t) {
    // y = K d0, a warp per row
    for (int i = warp; i < DL; i += NW) {
      const T* k = Kp + (size_t)i * DL;
      T acc = 0;
#pragma unroll 4
      for (int j = lane; j < DL; j += 32) acc += k[j] * d0[j];
      acc = warp_sum(acc);
      if (lane == 0) y[i] = acc;
    }
    __syncthreads();

    const T ramp = savtpu::ramp_at(t0, dt, t, ramped);
    for (int j = tid; j < DL; j += NT) {
      const T a = d0[j];
      T d1 = savtpu::central_difference(coef, y[j], a, dn[j], Fp[j], lM[j],
                                        bc[j], ramp);
      const int s = slot[j];
      if (use_preds && s >= 0) d1 = preds_p[(size_t)t * S3 + s];
      dn[j] = a;
      d0[j] = d1;
      if (record_shared && s >= 0) shared_p[(size_t)t * S3 + s] = d1;
    }
    __syncthreads();
  }

  for (int j = tid; j < DL; j += NT) {
    d0_out[vo + j] = d0[j];
    dn_out[vo + j] = dn[j];
  }
}

template <typename T>
int launch_matvec(const void* K, const void* d, void* out, void* stream,
                  int P, int DL) {
  if (P <= 0 || DL <= 0 || P > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((DL + MV_ROWS - 1) / MV_ROWS, P);
  fint_matvec_kernel<T><<<grid, MV_ROWS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)K, (const T*)d, (T*)out, DL);
  return (int)cudaGetLastError();
}

template <typename T, bool K_SHARED>
int launch_scan_as(size_t smem, const void* K, const void* d0,
                   const void* dn, const void* Fp, const void* lM,
                   const void* bc, const void* slot, const void* preds,
                   void* d0_out, void* dn_out, void* shared, void* stream,
                   int P, int DL, int S3, int num_steps, int use_preds,
                   int record_shared, int ramped, double t0, double dt,
                   double alpha) {
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T, K_SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<T, K_SHARED><<<P, NT, smem, (cudaStream_t)stream>>>(
      (const T*)K, (const T*)d0, (const T*)dn, (const T*)Fp, (const T*)lM,
      (const T*)bc, (const int*)slot, (const T*)preds, (T*)d0_out,
      (T*)dn_out, (T*)shared, DL, S3, num_steps, use_preds, record_shared,
      ramped, (T)t0, (T)dt, (T)alpha);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scan(const void* K, const void* d0, const void* dn,
                const void* Fp, const void* lM, const void* bc,
                const void* slot, const void* preds, void* d0_out,
                void* dn_out, void* shared, void* stream, int P, int DL,
                int S3, int num_steps, int use_preds, int record_shared,
                int ramped, double t0, double dt, double alpha) {
  if (P <= 0 || DL <= 0 || S3 <= 0 || num_steps <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t state = 6 * (size_t)DL * sizeof(T) + (size_t)DL * sizeof(int);
  const size_t with_k = state + (size_t)DL * DL * sizeof(T);
  if (with_k <= (size_t)smem_max)
    return launch_scan_as<T, true>(
        with_k, K, d0, dn, Fp, lM, bc, slot, preds, d0_out, dn_out, shared,
        stream, P, DL, S3, num_steps, use_preds, record_shared, ramped, t0,
        dt, alpha);
  return launch_scan_as<T, false>(
      state, K, d0, dn, Fp, lM, bc, slot, preds, d0_out, dn_out, shared,
      stream, P, DL, S3, num_steps, use_preds, record_shared, ramped, t0, dt,
      alpha);
}

}  // namespace

extern "C" int savtpu_fint_matvec_f32(const void* K, const void* d,
                                      void* out, void* stream, int P,
                                      int DL) {
  return launch_matvec<float>(K, d, out, stream, P, DL);
}

extern "C" int savtpu_fint_matvec_f64(const void* K, const void* d,
                                      void* out, void* stream, int P,
                                      int DL) {
  return launch_matvec<double>(K, d, out, stream, P, DL);
}

#define SAVTPU_SCAN_ARGS                                                   \
  const void *K, const void *d0, const void *dn, const void *Fp,           \
      const void *lM, const void *bc, const void *slot, const void *preds, \
      void *d0_out, void *dn_out, void *shared, void *stream, int P,       \
      int DL, int S3, int num_steps, int use_preds, int record_shared,     \
      int ramped, double t0, double dt, double alpha
#define SAVTPU_SCAN_CALL                                                   \
  K, d0, dn, Fp, lM, bc, slot, preds, d0_out, dn_out, shared, stream, P,   \
      DL, S3, num_steps, use_preds, record_shared, ramped, t0, dt, alpha

extern "C" int savtpu_scan_comm_free_f32(SAVTPU_SCAN_ARGS) {
  return launch_scan<float>(SAVTPU_SCAN_CALL);
}

extern "C" int savtpu_scan_comm_free_f64(SAVTPU_SCAN_ARGS) {
  return launch_scan<double>(SAVTPU_SCAN_CALL);
}

extern "C" const char* savtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
