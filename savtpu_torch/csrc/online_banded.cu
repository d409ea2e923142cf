// The comm-free online block on the banded layout (compensated state,
// per-step prediction overwrite, recording) for all parts at once.
//
// Replaces savtpu/ops/pallas_banded.py:234 (_online_kernel). The plain
// PyTorch version with the same op order is online_chunk_plain in
// ops/online_banded.py; the wrapper online_chunk launches this kernel.
//
// Design: one persistent thread block per part (grid = P) walks all Tc
// steps, the counterpart of the TPU's grid over parts with an in-kernel
// loop. The state hi, lo, v, the matvec operand x and result y and the
// per-DOF coefficients (F, M, Dirichlet mask, real-DOF mask) live in
// shared memory; the shared-slot overwrite and gather go through a slot
// map (slot[j] = shared slot of local DOF j, or -1).
//
// What bounds it: the band. One part's Kd and Kl (2*nc*Bk*Bk values,
// 3.7 MB at nc=7, Bk=256, float32) are far above the 227 KB a block may
// hold, so every step re-reads them from global memory, and all parts'
// band (58.7 MB at 16 parts) is just over the 50 MB L2. Only P of the 132
// SMs are busy (16 at the 16-part slice). The band matvec (common.cuh,
// shared with the banded scan) reads the band coalesced: the row products
// Kd_c x_c + Kl_c x_{c-1} with one warp per row, the transposed term
// Kl_{c+1}^T x_{c+1} with one thread per column.
//
// Rounding: built with -fmad=false, and the update and the TwoSum use
// explicitly rounded intrinsics, so they round exactly like the plain
// version. Only the sum order of the band matvec and of the
// translation-mean sums differs from it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using savtpu::Rn;
using savtpu::warp_sum;

constexpr int NT = 1024;         // threads per block
constexpr int NW = NT / 32;      // warps per block

// Sum three per-thread values over the block; every thread gets the sums.
template <typename T>
__device__ void block_sum3(T& a, T& b, T& c, T* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a); b = warp_sum(b); c = warp_sum(c);
  if (lane == 0) { red[warp] = a; red[NW + warp] = b; red[2 * NW + warp] = c; }
  __syncthreads();
  if (warp == 0) {
    a = lane < NW ? red[lane] : T(0);
    b = lane < NW ? red[NW + lane] : T(0);
    c = lane < NW ? red[2 * NW + lane] : T(0);
    a = warp_sum(a); b = warp_sum(b); c = warp_sum(c);
    if (lane == 0) { red[0] = a; red[NW] = b; red[2 * NW] = c; }
  }
  __syncthreads();
  a = red[0]; b = red[NW]; c = red[2 * NW];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT) online_banded_kernel(
    const T* __restrict__ Kd, const T* __restrict__ Kl,
    const T* __restrict__ hi_in, const T* __restrict__ lo_in,
    const T* __restrict__ v_in, const T* __restrict__ Fp_in,
    const T* __restrict__ lM_in, const T* __restrict__ bc_in,
    const T* __restrict__ dm_in, const int* __restrict__ slot_in,
    const T* __restrict__ preds,
    T* __restrict__ hi_out, T* __restrict__ lo_out, T* __restrict__ v_out,
    T* __restrict__ shared_out, T* __restrict__ traj_out,
    int nc, int Bk, int S3, int Tc, int save_every, int ramped,
    T t0, T i0, T dt, T c1, T c2) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int DLB = nc * Bk;
  const int n_rec = Tc / save_every;

  T* hi = reinterpret_cast<T*>(smem_raw);
  T* lo = hi + DLB;
  T* v = lo + DLB;
  T* x = v + DLB;
  T* y = x + DLB;
  T* Fp = y + DLB;
  T* lM = Fp + DLB;
  T* bc = lM + DLB;
  T* dm = bc + DLB;
  T* red = dm + DLB;                               // 3 * NW
  int* slot = reinterpret_cast<int*>(red + 3 * NW);

  const size_t vo = (size_t)p * DLB;
  for (int j = tid; j < DLB; j += NT) {
    hi[j] = hi_in[vo + j];
    lo[j] = lo_in[vo + j];
    v[j] = v_in[vo + j];
    Fp[j] = Fp_in[vo + j];
    lM[j] = lM_in[vo + j];
    bc[j] = bc_in[vo + j];
    dm[j] = dm_in[vo + j];
    slot[j] = slot_in[vo + j];
  }
  __syncthreads();

  // real-DOF count per component (the translation-mean denominators)
  T n0 = 0, n1 = 0, n2 = 0;
  for (int j = tid; j < DLB; j += NT) {
    const int c = j % 3;
    if (c == 0) n0 += dm[j]; else if (c == 1) n1 += dm[j]; else n2 += dm[j];
  }
  block_sum3(n0, n1, n2, red);
  n0 = n0 > T(1) ? n0 : T(1);
  n1 = n1 > T(1) ? n1 : T(1);
  n2 = n2 > T(1) ? n2 : T(1);

  const T* Kd_p = Kd + (size_t)p * nc * Bk * Bk;
  const T* Kl_p = Kl + (size_t)p * nc * Bk * Bk;
  const T* preds_p = preds + (size_t)p * Tc * S3;
  T* shared_p = shared_out + (size_t)p * Tc * S3;
  T* traj_p = traj_out + (size_t)p * n_rec * DLB;

  for (int t = 0; t < Tc; ++t) {
    // translation-mean centering: x = hi - mean_c(hi) on real DOFs
    T s0 = 0, s1 = 0, s2 = 0;
    for (int j = tid; j < DLB; j += NT) {
      const T w = R::mul(hi[j], dm[j]);
      const int c = j % 3;
      if (c == 0) s0 += w; else if (c == 1) s1 += w; else s2 += w;
    }
    block_sum3(s0, s1, s2, red);
    const T m0 = R::div(s0, n0), m1 = R::div(s1, n1), m2 = R::div(s2, n2);
    for (int j = tid; j < DLB; j += NT) {
      const int c = j % 3;
      const T m = c == 0 ? m0 : (c == 1 ? m1 : m2);
      x[j] = R::sub(hi[j], R::mul(m, dm[j]));
    }
    __syncthreads();

    // y = Kd_c x_c + Kl_c x_{c-1} + Kl_{c+1}^T x_{c+1} (common.cuh)
    savtpu::band_matvec<T, NT>(Kd_p, Kl_p, x, y, nc, Bk);

    // increment, shared-slot overwrite, TwoSum, recording
    const T tn = R::add(t0, R::mul(dt, R::add(i0, T(t))));
    const T ramp = ramped ? (tn < T(1) ? tn : T(1)) : T(1);
    const bool rec = (t % save_every) == 0;
    for (int j = tid; j < DLB; j += NT) {
      const T h = hi[j], l = lo[j];
      T delta = R::mul(
          R::add(R::mul(c1, v[j]),
                 R::mul(c2, R::div(R::sub(R::mul(Fp[j], ramp), y[j]), lM[j]))),
          bc[j]);
      const int s = slot[j];
      if (s >= 0) delta = R::sub(preds_p[(size_t)t * S3 + s], R::add(h, l));
      const T sm = R::add(h, delta);
      const T z = R::sub(sm, h);
      const T e = R::add(R::sub(h, R::sub(sm, z)), R::sub(delta, z));
      const T lo1 = R::add(l, e);
      const T h2 = R::add(sm, lo1);
      hi[j] = h2;
      lo[j] = R::sub(lo1, R::sub(h2, sm));
      v[j] = delta;
      if (rec) traj_p[(size_t)(t / save_every) * DLB + j] = h2;
      if (s >= 0) shared_p[(size_t)t * S3 + s] = h2;
    }
    __syncthreads();
  }

  for (int j = tid; j < DLB; j += NT) {
    hi_out[vo + j] = hi[j];
    lo_out[vo + j] = lo[j];
    v_out[vo + j] = v[j];
  }
}

template <typename T>
int launch(const void* Kd, const void* Kl, const void* hi, const void* lo,
           const void* v, const void* Fp, const void* lM, const void* bc,
           const void* dm, const void* slot, const void* preds,
           void* hi_out, void* lo_out, void* v_out, void* shared, void* traj,
           void* stream, int P, int nc, int Bk, int S3, int Tc,
           int save_every, int ramped, double t0, double i0, double dt,
           double c1, double c2) {
  if (P <= 0 || nc <= 0 || Bk <= 0 || Tc <= 0 || save_every <= 0 ||
      Tc % save_every != 0)
    return (int)cudaErrorInvalidValue;
  const size_t DLB = (size_t)nc * Bk;
  const size_t smem = (9 * DLB + 3 * NW) * sizeof(T) + DLB * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      online_banded_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  online_banded_kernel<T><<<P, NT, smem, (cudaStream_t)stream>>>(
      (const T*)Kd, (const T*)Kl, (const T*)hi, (const T*)lo, (const T*)v,
      (const T*)Fp, (const T*)lM, (const T*)bc, (const T*)dm,
      (const int*)slot, (const T*)preds, (T*)hi_out, (T*)lo_out, (T*)v_out,
      (T*)shared, (T*)traj, nc, Bk, S3, Tc, save_every, ramped, (T)t0,
      (T)i0, (T)dt, (T)c1, (T)c2);
  return (int)cudaGetLastError();
}

}  // namespace

#define SAVTPU_ONLINE_ARGS                                                  \
  const void *Kd, const void *Kl, const void *hi, const void *lo,           \
      const void *v, const void *Fp, const void *lM, const void *bc,        \
      const void *dm, const void *slot, const void *preds, void *hi_out,    \
      void *lo_out, void *v_out, void *shared, void *traj, void *stream,    \
      int P, int nc, int Bk, int S3, int Tc, int save_every, int ramped,    \
      double t0, double i0, double dt, double c1, double c2
#define SAVTPU_ONLINE_CALL                                                  \
  Kd, Kl, hi, lo, v, Fp, lM, bc, dm, slot, preds, hi_out, lo_out, v_out,    \
      shared, traj, stream, P, nc, Bk, S3, Tc, save_every, ramped, t0, i0, \
      dt, c1, c2

extern "C" int savtpu_online_banded_f32(SAVTPU_ONLINE_ARGS) {
  return launch<float>(SAVTPU_ONLINE_CALL);
}

extern "C" int savtpu_online_banded_f64(SAVTPU_ONLINE_ARGS) {
  return launch<double>(SAVTPU_ONLINE_CALL);
}

extern "C" const char* savtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
