// K3: the comm-free online block on the banded layout (compensated state,
// per-step prediction overwrite, recording) for all parts at once.
//
// Replaces savtpu/ops/pallas_banded.py:234 (_online_kernel). The plain
// PyTorch version with the same op order is online_chunk_plain in
// ops/online_banded.py; the wrapper online_chunk launches this kernel.
//
// Design: one part per thread block cluster of B blocks, every block
// walking all Tc steps (the TPU grid over parts with an in-kernel loop).
// Block b owns rows [b R, b R + R) of the part's DLB = nc Bk (the last may
// own fewer, or none): their band matvec, increment, shared-slot
// overwrite, TwoSum and recording, all row-local, with hi, lo, v and the
// coefficients of its rows in shared memory. The shared-slot overwrite and
// gather go through a slot map (slot[j] = shared slot of local DOF j, or
// -1); a slot is written by the block that owns its row, so the blocks'
// rows cover every trajectory row and shared slot once.
//
// The state crosses blocks through distributed shared memory, with two
// cluster barriers a step. Each block reads its rows' Kd and Kl rows once:
// the row products, and from the same Kl rows its share of the transposed
// term of the chunk before, which it publishes in its shared memory
// (common.cuh); barrier; each block adds the shares of the blocks owning
// the next chunk's rows in rank order, updates its rows, and writes its new
// hi rows and its three partial sums of hi * dm (one per component, for
// the translation mean) into a double-buffered exchange slot; barrier;
// every block adds the B partials in the same order (so all use the
// identical mean) and gathers x = hi - mean * dm over its window (its rows'
// chunks and the one before) from the owners' slots. No sum crosses blocks
// through atomics, so a run gives the same bits every time. The plan
// (ops/band_plan.py) picks B, up to 16, so that all P clusters run at once
// where the card can hold them; B = 1 (clusters in waves) where it cannot.
//
// What bounds it: the band, read every step. Each block keeps as many of
// its Kd rows in shared memory as fit beside its state and streams the
// rest and its Kl rows, each value once a step. At the 16-part slice
// (nc 7, Bk 256, float32, B = 6) that is about 36 MB a step over 96 SMs,
// where one block per part had 16 SMs pull 5.5 MB each (Kl twice).
//
// Rounding: built with -fmad=false, and the update and the TwoSum use
// explicitly rounded intrinsics, so they round exactly like the plain
// version. Only the sum order of the band matvec and of the
// translation-mean sums differs from it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using savtpu::BAND_NT;
using savtpu::BAND_NW;
using savtpu::Rn;
using savtpu::warp_sum;

// Sum three per-thread values over the block; every thread gets the sums.
template <typename T>
__device__ void block_sum3(T& a, T& b, T& c, T* red) {
  constexpr int NW = BAND_NW;
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
__global__ void __launch_bounds__(BAND_NT, 1) online_banded_kernel(
    const T* __restrict__ Kd, const T* __restrict__ Kl,
    const T* __restrict__ hi_in, const T* __restrict__ lo_in,
    const T* __restrict__ v_in, const T* __restrict__ Fp_in,
    const T* __restrict__ lM_in, const T* __restrict__ bc_in,
    const T* __restrict__ dm_in, const int* __restrict__ slot_in,
    const T* __restrict__ preds,
    T* __restrict__ hi_out, T* __restrict__ lo_out, T* __restrict__ v_out,
    T* __restrict__ shared_out, T* __restrict__ traj_out,
    int nc, int Bk, int S3, int Tc, int save_every, int ramped, int B,
    int res_rows, T t0, T i0, T dt, T c1, T c2) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank(), p = blockIdx.x / B;
  const int tid = threadIdx.x, DLB = nc * Bk;
  const int n_rec = Tc / save_every;
  const savtpu::BandLayout L = savtpu::band_layout<T>(nc, Bk, B, res_rows);
  const savtpu::BandRows rows(b, L.R, nc, Bk);
  const int r0 = rows.r0, n = rows.n, ws = rows.ws, we = rows.we;
  const int n_res = res_rows < n ? res_rows : n;

  T* smem = reinterpret_cast<T*>(smem_raw);
  T* res = smem;
  T* xw = smem + L.x;
  T* dmw = smem + L.dm;
  T* ex = smem + L.ex;
  T* hi = smem + L.own;
  T* lo = hi + L.own_stride;
  T* v = lo + L.own_stride;
  T* Fp = v + L.own_stride;
  T* lM = Fp + L.own_stride;
  T* bc = lM + L.own_stride;
  T* rp = smem + L.rp;
  T* cp = smem + L.cp;
  T* pub = smem + L.pub;
  T* red = smem + L.red;              // 3 NW block sums, then 3 means
  T* mean = red + 3 * BAND_NW;
  int* slot = reinterpret_cast<int*>(smem_raw + L.slot);

  const T* Kd_p = Kd + (size_t)p * nc * Bk * Bk;
  const T* Kl_p = Kl + (size_t)p * nc * Bk * Bk;
  const size_t vo = (size_t)p * DLB + r0;
  for (int li = tid; li < n; li += BAND_NT) {
    hi[li] = hi_in[vo + li];
    lo[li] = lo_in[vo + li];
    v[li] = v_in[vo + li];
    Fp[li] = Fp_in[vo + li];
    lM[li] = lM_in[vo + li];
    bc[li] = bc_in[vo + li];
    slot[li] = slot_in[vo + li];
  }
  for (int w = tid; w < we - ws; w += BAND_NT)
    dmw[w] = dm_in[(size_t)p * DLB + ws + w];
  savtpu::load_resident(Kd_p, res, r0, n_res, Bk);

  // real-DOF count per component over the whole part (the translation-mean
  // denominators); every block of the cluster sums the same values in the
  // same order
  T n0 = 0, n1 = 0, n2 = 0;
  for (int j = tid; j < DLB; j += BAND_NT) {
    const T d = dm_in[(size_t)p * DLB + j];
    const int c = j % 3;
    if (c == 0) n0 += d; else if (c == 1) n1 += d; else n2 += d;
  }
  block_sum3(n0, n1, n2, red);
  n0 = n0 > T(1) ? n0 : T(1);
  n1 = n1 > T(1) ? n1 : T(1);
  n2 = n2 > T(1) ? n2 : T(1);

  // Publish the block's rows of hi and its partial sums of hi * dm into
  // exchange slot par; after the cluster barrier every block forms the
  // means from the B partials in rank order and gathers its window's
  // x = hi - mean * dm.
  const auto exchange = [&](int par, T s0, T s1, T s2) {
    block_sum3(s0, s1, s2, red);
    if (tid == 0) {
      ex[par + L.R] = s0;
      ex[par + L.R + 1] = s1;
      ex[par + L.R + 2] = s2;
    }
    cluster.sync();
    if (tid < 3) {
      T s = 0;
      for (int k = 0; k < B; ++k)
        s = R::add(s, cluster.map_shared_rank(ex, k)[par + L.R + tid]);
      mean[tid] = R::div(s, tid == 0 ? n0 : (tid == 1 ? n1 : n2));
    }
    __syncthreads();
    savtpu::gather_window(ex, par, L.R, ws, we, xw, [&](int pos, T h) {
      return R::sub(h, R::mul(mean[pos % 3], dmw[pos - ws]));
    });
    __syncthreads();
  };

  {
    T s0 = 0, s1 = 0, s2 = 0;
    for (int li = tid; li < n; li += BAND_NT) {
      const int j = r0 + li;
      const T w = R::mul(hi[li], dmw[j - ws]);
      const int c = j % 3;
      if (c == 0) s0 += w; else if (c == 1) s1 += w; else s2 += w;
      ex[li] = hi[li];
    }
    exchange(0, s0, s1, s2);
  }

  const T* preds_p = preds + (size_t)p * Tc * S3;
  T* shared_p = shared_out + (size_t)p * Tc * S3;
  T* traj_p = traj_out + (size_t)p * n_rec * DLB;

  for (int t = 0; t < Tc; ++t) {
    // y = Kd_c x_c + Kl_c x_{c-1} + Kl_{c+1}^T x_{c+1} on the block's rows:
    // the partial sums, then the other blocks' transposed-term sums after
    // the cluster barrier
    savtpu::band_rows_partial(Kd_p, Kl_p, res, n_res, xw, ws, rp, cp, pub, L,
                              r0, n, Bk);
    cluster.sync();

    // increment, shared-slot overwrite, TwoSum, recording
    const T tn = R::add(t0, R::mul(dt, R::add(i0, T(t))));
    const T ramp = ramped ? (tn < T(1) ? tn : T(1)) : T(1);
    const bool rec = (t % save_every) == 0;
    const int par = ((t + 1) & 1) * L.ex_stride;
    T s0 = 0, s1 = 0, s2 = 0;
    for (int li = tid; li < n; li += BAND_NT) {
      const int j = r0 + li;
      const T h = hi[li], l = lo[li];
      const T f = savtpu::band_row_sum(rp, pub, L, r0, li, nc, Bk);
      T delta = R::mul(
          R::add(R::mul(c1, v[li]),
                 R::mul(c2, R::div(R::sub(R::mul(Fp[li], ramp), f), lM[li]))),
          bc[li]);
      const int s = slot[li];
      if (s >= 0) delta = R::sub(preds_p[(size_t)t * S3 + s], R::add(h, l));
      const T sm = R::add(h, delta);
      const T z = R::sub(sm, h);
      const T e = R::add(R::sub(h, R::sub(sm, z)), R::sub(delta, z));
      const T lo1 = R::add(l, e);
      const T h2 = R::add(sm, lo1);
      hi[li] = h2;
      lo[li] = R::sub(lo1, R::sub(h2, sm));
      v[li] = delta;
      ex[par + li] = h2;
      const T w = R::mul(h2, dmw[j - ws]);
      const int c = j % 3;
      if (c == 0) s0 += w; else if (c == 1) s1 += w; else s2 += w;
      if (rec) traj_p[(size_t)(t / save_every) * DLB + j] = h2;
      if (s >= 0) shared_p[(size_t)t * S3 + s] = h2;
    }
    exchange(par, s0, s1, s2);
  }

  for (int li = tid; li < n; li += BAND_NT) {
    hi_out[vo + li] = hi[li];
    lo_out[vo + li] = lo[li];
    v_out[vo + li] = v[li];
  }
  // no block leaves while a neighbour may still read its exchange slot
  cluster.sync();
}

template <typename T>
int launch(const void* Kd, const void* Kl, const void* hi, const void* lo,
           const void* v, const void* Fp, const void* lM, const void* bc,
           const void* dm, const void* slot, const void* preds,
           void* hi_out, void* lo_out, void* v_out, void* shared, void* traj,
           void* stream, int P, int nc, int Bk, int S3, int Tc,
           int save_every, int ramped, int B, int res_rows, int smem,
           double t0, double i0, double dt, double c1, double c2) {
  if (P <= 0 || nc <= 0 || Bk <= 0 || Bk % 128 != 0 || Bk > 2048 || Tc <= 0 ||
      save_every <= 0 || Tc % save_every != 0 || B < 1 ||
      B > savtpu::BAND_MAX_CLUSTER || res_rows < 0)
    return (int)cudaErrorInvalidValue;
  const savtpu::BandLayout L = savtpu::band_layout<T>(nc, Bk, B, res_rows);
  if (res_rows > L.R || (size_t)smem != L.bytes)
    return (int)cudaErrorInvalidValue;
  return (int)savtpu::launch_band(
      online_banded_kernel<T>, P, B, L.bytes, (cudaStream_t)stream,
      (const T*)Kd, (const T*)Kl, (const T*)hi, (const T*)lo, (const T*)v,
      (const T*)Fp, (const T*)lM, (const T*)bc, (const T*)dm,
      (const int*)slot, (const T*)preds, (T*)hi_out, (T*)lo_out, (T*)v_out,
      (T*)shared, (T*)traj, nc, Bk, S3, Tc, save_every, ramped, B, res_rows,
      (T)t0, (T)i0, (T)dt, (T)c1, (T)c2);
}

}  // namespace

#define SAVTPU_ONLINE_ARGS                                                  \
  const void *Kd, const void *Kl, const void *hi, const void *lo,           \
      const void *v, const void *Fp, const void *lM, const void *bc,        \
      const void *dm, const void *slot, const void *preds, void *hi_out,    \
      void *lo_out, void *v_out, void *shared, void *traj, void *stream,    \
      int P, int nc, int Bk, int S3, int Tc, int save_every, int ramped,    \
      int B, int res_rows, int smem, double t0, double i0, double dt,       \
      double c1, double c2
#define SAVTPU_ONLINE_CALL                                                  \
  Kd, Kl, hi, lo, v, Fp, lM, bc, dm, slot, preds, hi_out, lo_out, v_out,    \
      shared, traj, stream, P, nc, Bk, S3, Tc, save_every, ramped, B,       \
      res_rows, smem, t0, i0, dt, c1, c2

extern "C" int savtpu_online_banded_f32(SAVTPU_ONLINE_ARGS) {
  return launch<float>(SAVTPU_ONLINE_CALL);
}

extern "C" int savtpu_online_banded_f64(SAVTPU_ONLINE_ARGS) {
  return launch<double>(SAVTPU_ONLINE_CALL);
}

// The most clusters of B blocks, smem bytes each, that run at once.
extern "C" int savtpu_online_banded_max_clusters_f32(int B, int smem,
                                                      int* out) {
  return (int)savtpu::band_max_clusters(online_banded_kernel<float>, B,
                                        (size_t)smem, out);
}

extern "C" int savtpu_online_banded_max_clusters_f64(int B, int smem,
                                                      int* out) {
  return (int)savtpu::band_max_clusters(online_banded_kernel<double>, B,
                                        (size_t)smem, out);
}

extern "C" const char* savtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
