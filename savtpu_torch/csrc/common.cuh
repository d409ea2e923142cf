// Device code shared by the port's kernels: explicitly rounded
// arithmetic, warp sums, the block-tridiagonal band matvec and the
// central-difference update.
//
// Every kernel is built with -fmad=false and writes its elementwise
// arithmetic with the _rn intrinsics below, so it rounds exactly like its
// plain PyTorch version; only the order of the sums inside a matvec or a
// reduction differs.

#pragma once

#include <cuda_runtime.h>

namespace savtpu {

template <typename T> struct Rn;
template <> struct Rn<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
};
template <> struct Rn<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
};

template <typename T>
__device__ T warp_sum(T a) {
  for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
  return a;
}

// y = K x for one part's block-tridiagonal K, by a whole block of NT
// threads: diagonal blocks Kd_p and sub-diagonal blocks Kl_p (nc, Bk, Bk)
// in global memory, the super-diagonal Kl_{c+1}^T by symmetry; x and y
// (nc*Bk) in shared memory. The row products Kd_c x_c + Kl_c x_{c-1} go
// one warp per row, the transposed term Kl_{c+1}^T x_{c+1} one thread per
// column, so both read the band coalesced. Ends on a block barrier.
template <typename T, int NT>
__device__ void band_matvec(const T* __restrict__ Kd_p,
                            const T* __restrict__ Kl_p, const T* x, T* y,
                            int nc, int Bk) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int DLB = nc * Bk;
  for (int i = warp; i < DLB; i += NW) {
    const int c = i / Bk, r = i - c * Bk;
    const T* kd = Kd_p + ((size_t)c * Bk + r) * Bk;
    const T* xc = x + c * Bk;
    T acc = 0;
#pragma unroll 4
    for (int k = lane; k < Bk; k += 32) acc += kd[k] * xc[k];
    if (c > 0) {
      const T* kl = Kl_p + ((size_t)c * Bk + r) * Bk;
      const T* xm = x + (c - 1) * Bk;
#pragma unroll 4
      for (int k = lane; k < Bk; k += 32) acc += kl[k] * xm[k];
    }
    acc = warp_sum(acc);
    if (lane == 0) y[i] = acc;
  }
  __syncthreads();

  for (int j = tid; j < (nc - 1) * Bk; j += NT) {
    const int c = j / Bk, r = j - c * Bk;
    const T* kl = Kl_p + (size_t)(c + 1) * Bk * Bk + r;
    const T* xp = x + (c + 1) * Bk;
    T acc = 0;
#pragma unroll 8
    for (int k = 0; k < Bk; ++k) acc += kl[(size_t)k * Bk] * xp[k];
    y[j] += acc;
  }
  __syncthreads();
}

// The step's scalars in the state dtype, formed as the TPU kernels form
// them from t0, dt and alpha already cast to that dtype.
template <typename T>
struct StepCoeffs {
  T dt2;   // dt * dt
  T hda;   // 0.5 * dt * alpha      (the update's damping term)
  T had;   // 0.5 * alpha * dt      (the denominator's)
  __device__ StepCoeffs(T dt, T alpha) {
    using R = Rn<T>;
    dt2 = R::mul(dt, dt);
    hda = R::mul(R::mul(T(0.5), dt), alpha);
    had = R::mul(R::mul(T(0.5), alpha), dt);
  }
};

// One DOF's central-difference step with mass-proportional damping,
//   d1 = (dt^2 (F ramp - f) + 2 M d0 - M dn + 0.5 dt alpha M dn)
//        / (M + 0.5 alpha dt M) * bc,
// in the TPU kernels' evaluation order.
template <typename T>
__device__ T central_difference(const StepCoeffs<T>& k, T f, T d0, T dn,
                                T Fp, T lM, T bc, T ramp) {
  using R = Rn<T>;
  const T a = R::mul(k.dt2, R::sub(R::mul(Fp, ramp), f));
  const T b = R::mul(R::mul(T(2), lM), d0);
  const T c = R::mul(lM, dn);
  const T e = R::mul(R::mul(k.hda, lM), dn);
  const T num = R::add(R::sub(R::add(a, b), c), e);
  const T denom = R::add(lM, R::mul(k.had, lM));
  return R::mul(R::div(num, denom), bc);
}

// t = t0 + i dt and the load ramp min(t, 1) (1 when unramped).
template <typename T>
__device__ T ramp_at(T t0, T dt, int i, int ramped) {
  using R = Rn<T>;
  const T tn = R::add(t0, R::mul(T(i), dt));
  return ramped ? (tn < T(1) ? tn : T(1)) : T(1);
}

}  // namespace savtpu
