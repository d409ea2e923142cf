// K4: the comm-free scan on the banded (block-tridiagonal) layout.
//
// Replaces savtpu/ops/pallas_banded.py:55 (_kernel, via
// pallas_scan_comm_free_banded): num_steps central-difference steps of
// every part with no exchange, no prediction overwrite, no recording and
// no compensation (the sweep's sync-avoiding mode). It is the online
// kernel (online_banded.cu) without those duties and without the
// translation mean, and shares its layout, band matvec, gather and launch
// (common.cuh).
//
// Design: one part per thread block cluster of B blocks (the TPU grid over
// parts, with the time loop inside every block). Block b owns rows
// [b R, b R + R) of the part's DLB = nc Bk (the last may own fewer, or
// none): their band matvec, their update, their d0 and dn in shared
// memory. A step is two cluster barriers (common.cuh):
//
// 1. each block reads its rows' Kd and Kl rows once: the row products
//    Kd_c x_c + Kl_c x_{c-1}, and from the same Kl rows its share of the
//    transposed term Kl_c^T x_c, which belongs to the rows of chunk c - 1
//    and is published in the block's shared memory; barrier;
// 2. each block adds the transposed-term shares of the blocks owning the
//    next chunk's rows (distributed shared memory, in rank order), updates
//    its rows and writes the new d0 into a double-buffered exchange slot;
//    barrier; it gathers the operand over its window (its rows' chunks and
//    the one before) from the owners' slots.
//
// No sum crosses blocks through atomics, so a run gives the same bits
// every time. The plan (ops/band_plan.py) picks B, up to 16, so that all P
// clusters run at once where the card can hold them; B = 1 (a cluster of
// one block per part, clusters in waves) where it cannot.
//
// What bounds it: the band, read every step. Each block keeps as many of
// its Kd rows in shared memory as fit beside its state (the plan's
// resident rows) and streams the rest and its Kl rows from L2 or HBM,
// each value once a step. At 96x8x8/16 float32 (B = 6, 299 rows a block)
// that is about 36 MB a step over 96 SMs, under the 58.7 MB the band
// floor re-reads; at 96x8x8/8 (Bk 512, a 117 MB band) it is HBM.
//
// Rounding: built with -fmad=false; the update rounds like the plain
// version in ops/banded_scan.py (t = t0 + i dt, coefficients from t0, dt,
// alpha in the state dtype, as the TPU kernel forms them). Only the band
// matvec's sum order differs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using savtpu::BAND_NT;

template <typename T>
__global__ void __launch_bounds__(BAND_NT, 1) banded_scan_kernel(
    const T* __restrict__ Kd, const T* __restrict__ Kl,
    const T* __restrict__ d0_in, const T* __restrict__ dn_in,
    const T* __restrict__ Fp_in, const T* __restrict__ lM_in,
    const T* __restrict__ bc_in, T* __restrict__ d0_out,
    T* __restrict__ dn_out, int nc, int Bk, int num_steps, int ramped,
    int B, int res_rows, T t0, T dt, T alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank(), p = blockIdx.x / B;
  const int tid = threadIdx.x, DLB = nc * Bk;
  const savtpu::BandLayout L = savtpu::band_layout<T>(nc, Bk, B, res_rows);
  const savtpu::BandRows rows(b, L.R, nc, Bk);
  const int r0 = rows.r0, n = rows.n, ws = rows.ws, we = rows.we;
  const int n_res = res_rows < n ? res_rows : n;

  T* smem = reinterpret_cast<T*>(smem_raw);
  T* res = smem;
  T* xw = smem + L.x;
  T* ex = smem + L.ex;
  T* d0 = smem + L.own;
  T* dn = d0 + L.own_stride;
  T* Fp = dn + L.own_stride;
  T* lM = Fp + L.own_stride;
  T* bc = lM + L.own_stride;
  T* rp = smem + L.rp;
  T* cp = smem + L.cp;
  T* pub = smem + L.pub;

  const T* Kd_p = Kd + (size_t)p * nc * Bk * Bk;
  const T* Kl_p = Kl + (size_t)p * nc * Bk * Bk;
  const size_t vo = (size_t)p * DLB + r0;
  for (int li = tid; li < n; li += BAND_NT) {
    d0[li] = d0_in[vo + li];
    dn[li] = dn_in[vo + li];
    Fp[li] = Fp_in[vo + li];
    lM[li] = lM_in[vo + li];
    bc[li] = bc_in[vo + li];
    ex[li] = d0[li];
  }
  savtpu::load_resident(Kd_p, res, r0, n_res, Bk);
  const auto same = [](int, T h) { return h; };
  cluster.sync();
  savtpu::gather_window(ex, 0, L.R, ws, we, xw, same);
  __syncthreads();

  const savtpu::StepCoeffs<T> coef(dt, alpha);
  for (int t = 0; t < num_steps; ++t) {
    savtpu::band_rows_partial(Kd_p, Kl_p, res, n_res, xw, ws, rp, cp, pub, L,
                              r0, n, Bk);
    cluster.sync();
    const T ramp = savtpu::ramp_at(t0, dt, t, ramped);
    const int par = ((t + 1) & 1) * L.ex_stride;
    for (int li = tid; li < n; li += BAND_NT) {
      const T f = savtpu::band_row_sum(rp, pub, L, r0, li, nc, Bk);
      const T a = d0[li];
      const T d1 = savtpu::central_difference(coef, f, a, dn[li], Fp[li],
                                              lM[li], bc[li], ramp);
      dn[li] = a;
      d0[li] = d1;
      ex[par + li] = d1;
    }
    cluster.sync();
    savtpu::gather_window(ex, par, L.R, ws, we, xw, same);
    __syncthreads();
  }

  for (int li = tid; li < n; li += BAND_NT) {
    d0_out[vo + li] = d0[li];
    dn_out[vo + li] = dn[li];
  }
  // no block leaves while a neighbour may still read its exchange slot
  cluster.sync();
}

template <typename T>
int launch(const void* Kd, const void* Kl, const void* d0, const void* dn,
           const void* Fp, const void* lM, const void* bc, void* d0_out,
           void* dn_out, void* stream, int P, int nc, int Bk, int num_steps,
           int ramped, int B, int res_rows, int smem, double t0, double dt,
           double alpha) {
  if (P <= 0 || nc <= 0 || Bk <= 0 || Bk % 128 != 0 || Bk > 2048 || num_steps <= 0 ||
      B < 1 || B > savtpu::BAND_MAX_CLUSTER || res_rows < 0)
    return (int)cudaErrorInvalidValue;
  const savtpu::BandLayout L = savtpu::band_layout<T>(nc, Bk, B, res_rows);
  if (res_rows > L.R || (size_t)smem != L.bytes)
    return (int)cudaErrorInvalidValue;
  return (int)savtpu::launch_band(
      banded_scan_kernel<T>, P, B, L.bytes, (cudaStream_t)stream,
      (const T*)Kd, (const T*)Kl, (const T*)d0, (const T*)dn, (const T*)Fp,
      (const T*)lM, (const T*)bc, (T*)d0_out, (T*)dn_out, nc, Bk, num_steps,
      ramped, B, res_rows, (T)t0, (T)dt, (T)alpha);
}

}  // namespace

#define SAVTPU_BANDED_ARGS                                                  \
  const void *Kd, const void *Kl, const void *d0, const void *dn,           \
      const void *Fp, const void *lM, const void *bc, void *d0_out,         \
      void *dn_out, void *stream, int P, int nc, int Bk, int num_steps,     \
      int ramped, int B, int res_rows, int smem, double t0, double dt,      \
      double alpha
#define SAVTPU_BANDED_CALL                                                  \
  Kd, Kl, d0, dn, Fp, lM, bc, d0_out, dn_out, stream, P, nc, Bk, num_steps, \
      ramped, B, res_rows, smem, t0, dt, alpha

extern "C" int savtpu_banded_scan_f32(SAVTPU_BANDED_ARGS) {
  return launch<float>(SAVTPU_BANDED_CALL);
}

extern "C" int savtpu_banded_scan_f64(SAVTPU_BANDED_ARGS) {
  return launch<double>(SAVTPU_BANDED_CALL);
}

// The most clusters of B blocks, smem bytes each, that run at once.
extern "C" int savtpu_banded_scan_max_clusters_f32(int B, int smem,
                                                    int* out) {
  return (int)savtpu::band_max_clusters(banded_scan_kernel<float>, B,
                                        (size_t)smem, out);
}

extern "C" int savtpu_banded_scan_max_clusters_f64(int B, int smem,
                                                    int* out) {
  return (int)savtpu::band_max_clusters(banded_scan_kernel<double>, B,
                                        (size_t)smem, out);
}

extern "C" const char* savtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
