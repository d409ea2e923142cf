// Device code shared by the port's kernels: explicitly rounded
// arithmetic, warp sums, 16-byte vector loads, the central-difference
// update, and what the two banded kernels share: their shared-memory
// layout, their split band matvec, the gather of the operand through
// distributed shared memory, and their cluster launch.
//
// Every kernel is built with -fmad=false and writes its elementwise
// arithmetic with the _rn intrinsics below, so it rounds exactly like its
// plain PyTorch version; only the order of the sums inside a matvec or a
// reduction differs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace savtpu {

namespace cg = cooperative_groups;

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

// 16-byte vectors of the two state types
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
  __device__ static float dot(const float4& a, const float4& b) {
    return ((a.x * b.x + a.y * b.y) + a.z * b.z) + a.w * b.w;
  }
  __device__ static float dot(const float4& a, const float* b) {
    return ((a.x * b[0] + a.y * b[1]) + a.z * b[2]) + a.w * b[3];
  }
  // acc[e] += a_e x
  __device__ static void axpy(float* acc, const float4& a, float x) {
    acc[0] += a.x * x; acc[1] += a.y * x; acc[2] += a.z * x; acc[3] += a.w * x;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
  __device__ static double dot(const double2& a, const double2& b) {
    return a.x * b.x + a.y * b.y;
  }
  __device__ static double dot(const double2& a, const double* b) {
    return a.x * b[0] + a.y * b[1];
  }
  __device__ static void axpy(double* acc, const double2& a, double x) {
    acc[0] += a.x * x; acc[1] += a.y * x;
  }
};

// A 16-byte load from global memory as a read-only stream that does not
// allocate in L1 and asks L2 for whole 256-byte sectors.
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0,%1,%2,%3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ double2 ld_stream(const double2* p) {
  double2 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.f64 {%0,%1}, [%2];"
               : "=d"(v.x), "=d"(v.y) : "l"(p));
  return v;
}

// ---- the banded kernels (K3 online_banded.cu, K4 banded_scan.cu) ----
//
// One part's block-tridiagonal K (diagonal blocks Kd_p, sub-diagonal
// blocks Kl_p, (nc, Bk, Bk) each; the super-diagonal is Kl_{c+1}^T by
// symmetry) and its DLB = nc Bk rows run on a cluster of B blocks. Block b
// owns rows [b R, min((b+1) R, DLB)), R = ceil(DLB / B) (it may own none),
// and gathers the matvec operand over its window: its rows' chunks and the
// chunk before them. The host plan (ops/band_plan.py) mirrors band_layout
// and passes B, the resident row count and the byte size it computed; the
// launch refuses a size that differs.

constexpr int BAND_NT = 1024;          // threads per block
constexpr int BAND_NW = BAND_NT / 32;  // warps per block
constexpr int BAND_MAX_CLUSTER = 16;   // H100, non-portable cluster size

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// The dynamic shared memory of one block, in elements of T from its start
// (every array starts on a multiple of 4 elements, so on 16 bytes):
//   res   resident Kd rows, res x Bk (the block's first rows)
//   x     operand window, W
//   dm    real-DOF mask over the window, W (K3)
//   ex    the exchange, 2 x ex_stride: the operand of the block's rows and
//         3 partial sums (K3's translation mean), double buffered
//   own   6 x own_stride: the state and coefficients of the block's rows
//   rp    the row products' partial sums, one per column group, GC x
//         own_stride (GC = Bk / (32 x the vector width))
//   cp    the transposed term's partial sums, one row of Bk per row slice
//         (NW / GC of them): NW x 32 vectors of 16 bytes
//   pub   the block's transposed-term sums, one row of Bk per chunk its
//         rows span (nseg), read by the blocks owning the chunk before
//   red   block reductions and the 3 means, 3 NW + 3
//   slot  (int) the shared-slot map of the block's rows (K3), own_stride
struct BandLayout {
  int R, W, nseg, res, ex_stride, own_stride;
  size_t x, dm, ex, own, rp, cp, pub, red, slot, bytes;
};

template <typename T>
__host__ __device__ inline BandLayout band_layout(int nc, int Bk, int B,
                                                  int res) {
  BandLayout L;
  const int DLB = nc * Bk;
  L.R = (DLB + B - 1) / B;
  L.W = 0;
  L.nseg = 0;
  for (int b = 0; b < B; ++b) {
    const int r0 = b * L.R;
    const int r1 = DLB < r0 + L.R ? DLB : r0 + L.R;
    if (r0 >= r1) break;
    const int lo = r0 / Bk > 0 ? r0 / Bk - 1 : 0;
    const int hi = (r1 - 1) / Bk + 1;
    if ((hi - lo) * Bk > L.W) L.W = (hi - lo) * Bk;
    if (hi - r0 / Bk > L.nseg) L.nseg = hi - r0 / Bk;
  }
  L.res = res;
  L.ex_stride = pad4(L.R + 3);
  L.own_stride = pad4(L.R);
  constexpr int VW = 16 / (int)sizeof(T);
  size_t n = (size_t)res * Bk;
  L.x = n;    n += pad4(L.W);
  L.dm = n;   n += pad4(L.W);
  L.ex = n;   n += 2 * (size_t)L.ex_stride;
  L.own = n;  n += 6 * (size_t)L.own_stride;
  L.rp = n;   n += (size_t)(Bk / (32 * VW)) * L.own_stride;
  L.cp = n;   n += (size_t)BAND_NW * 32 * VW;
  L.pub = n;  n += (size_t)L.nseg * Bk;
  L.red = n;  n += pad4(3 * BAND_NW + 3);
  L.slot = n * sizeof(T);
  L.bytes = L.slot + sizeof(int) * (size_t)L.own_stride;
  return L;
}

// The rows a block owns and its operand window [ws, we).
struct BandRows {
  int r0, n, ws, we;
  __device__ BandRows(int b, int R, int nc, int Bk) {
    const int DLB = nc * Bk;
    r0 = b * R;
    n = DLB - r0 < R ? DLB - r0 : R;
    if (n <= 0) {
      n = 0; ws = 0; we = 0;
      return;
    }
    ws = (r0 / Bk > 0 ? r0 / Bk - 1 : 0) * Bk;
    we = ((r0 + n - 1) / Bk + 1) * Bk;
  }
};

// The band matvec's first half on the block's rows [r0, r0 + n), from the
// operand xw over the window starting at ws. Each row i (chunk c, row r)
// reads its Kd row and, for c > 0, its Kl row once:
//
// - the row products Kd_c[r] x_c + Kl_c[r] x_{c-1}, one partial sum per
//   column group into rp;
// - from the same Kl rows, the transposed term's share of the block's
//   rows: pub[c - c0][r'] = sum over the block's rows r of chunk c of
//   Kl_c[r][r'] x_c[r], which belongs to row r' of chunk c - 1, owned by
//   this block or the one before (band_row_sum adds it there).
//
// The warps form a grid over each chunk's rows: GC column groups (a lane
// holds one 16-byte vector of a row, a warp 32 of them) by S = NW / GC row
// slices. Each warp walks its slice two rows at a time, the first n_res Kd
// rows from shared memory, the rest and the Kl rows streamed; the slices'
// transposed sums (cp) are added in slice order. Ends on a block barrier.
template <typename T>
__device__ void band_rows_partial(const T* __restrict__ Kd_p,
                                  const T* __restrict__ Kl_p, const T* res,
                                  int n_res, const T* xw, int ws, T* rp,
                                  T* cp, T* pub, const BandLayout& L, int r0,
                                  int n, int Bk) {
  using VT = typename Vec<T>::type;
  constexpr int VW = Vec<T>::N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nv = Bk / VW, GC = nv / 32, S = BAND_NW / GC;
  const int g = warp % GC, s = warp / GC, v = g * 32 + lane;
  const VT vz = {};
  if (n <= 0) return;
  const bool slice = s < S;   // warps past S slices (GC not dividing NW)
  const int c0 = r0 / Bk, c1 = (r0 + n - 1) / Bk;
  for (int c = c0; c <= c1; ++c) {
    const int a = r0 > c * Bk ? r0 : c * Bk;
    const int b = r0 + n < (c + 1) * Bk ? r0 + n : (c + 1) * Bk;
    const int q = (b - a + S - 1) / S;
    const int ra = slice ? a + s * q : b, rb = ra + q < b ? ra + q : b;
    const VT xc = reinterpret_cast<const VT*>(xw + (c * Bk - ws))[v];
    const VT xm =
        c > 0 ? reinterpret_cast<const VT*>(xw + (c * Bk - ws))[v - nv] : vz;
    T tacc[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) tacc[e] = T(0);
#pragma unroll 2
    for (int i = ra; i < rb; i += 2) {
      const int j = i + 1 < rb ? i + 1 : i;
      const int l0 = i - r0, l1 = j - r0;
      const VT* kd0 = reinterpret_cast<const VT*>(
          l0 < n_res ? res + (size_t)l0 * Bk : Kd_p + (size_t)i * Bk);
      const VT* kd1 = reinterpret_cast<const VT*>(
          l1 < n_res ? res + (size_t)l1 * Bk : Kd_p + (size_t)j * Bk);
      const VT d0 = kd0[v], d1 = kd1[v];
      const VT e0 = c > 0 ? ld_stream(
          reinterpret_cast<const VT*>(Kl_p + (size_t)i * Bk) + v) : vz;
      const VT e1 = c > 0 ? ld_stream(
          reinterpret_cast<const VT*>(Kl_p + (size_t)j * Bk) + v) : vz;
      T p0 = Vec<T>::dot(d0, xc), p1 = Vec<T>::dot(d1, xc);
      p0 += Vec<T>::dot(e0, xm);
      p1 += Vec<T>::dot(e1, xm);
      p0 = warp_sum(p0);
      p1 = warp_sum(p1);
      if (lane == 0) {
        rp[g * L.own_stride + l0] = p0;
        if (j != i) rp[g * L.own_stride + l1] = p1;
      }
      Vec<T>::axpy(tacc, e0, xw[i - ws]);
      if (j != i) Vec<T>::axpy(tacc, e1, xw[j - ws]);
    }
    if (c > 0 && slice) {
#pragma unroll
      for (int e = 0; e < VW; ++e) cp[s * Bk + v * VW + e] = tacc[e];
    }
    __syncthreads();
    if (c > 0) {
      for (int col = tid; col < Bk; col += BAND_NT) {
        T acc = cp[col];
        for (int k = 1; k < S; ++k) acc += cp[k * Bk + col];
        pub[(c - c0) * Bk + col] = acc;
      }
    }
    __syncthreads();
  }
}

// After a cluster barrier that follows band_rows_partial in every block:
// y for the block's row li, the row products' column groups in order, then
// the transposed term Kl_{c+1}^T x_{c+1} of its row, summed over the blocks
// owning rows of chunk c + 1, in rank order (distributed shared memory).
template <typename T>
__device__ T band_row_sum(const T* rp, T* pub, const BandLayout& L, int r0,
                          int li, int nc, int Bk) {
  const int GC = Bk / (32 * Vec<T>::N);
  T y = rp[li];
  for (int g = 1; g < GC; ++g) y += rp[g * L.own_stride + li];
  const int i = r0 + li, c = i / Bk;
  if (c + 1 < nc) {
    cg::cluster_group cluster = cg::this_cluster();
    const int DLB = nc * Bk;
    const int last = ((c + 2) * Bk < DLB ? (c + 2) * Bk : DLB) - 1;
    for (int b = (c + 1) * Bk / L.R; b <= last / L.R; ++b) {
      const int seg = c + 1 - b * L.R / Bk;
      y += cluster.map_shared_rank(pub, b)[seg * Bk + (i - c * Bk)];
    }
  }
  return y;
}

// Copy the first n_res rows of the block's Kd rows (contiguous from row
// r0) into shared memory.
template <typename T>
__device__ void load_resident(const T* __restrict__ Kd_p, T* res, int r0,
                              int n_res, int Bk) {
  using VT = typename Vec<T>::type;
  const VT* src = reinterpret_cast<const VT*>(Kd_p + (size_t)r0 * Bk);
  VT* dst = reinterpret_cast<VT*>(res);
  const size_t nv = (size_t)n_res * Bk / Vec<T>::N;
  for (size_t v = threadIdx.x; v < nv; v += BAND_NT) dst[v] = ld_stream(src + v);
}

// After a cluster barrier: xw[pos - ws] = f(pos, h) over the window, h the
// operand value of row pos in its owner's exchange buffer at offset par
// (distributed shared memory).
template <typename T, typename F>
__device__ void gather_window(T* ex, int par, int R, int ws, int we, T* xw,
                              F f) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int pos = ws + (int)threadIdx.x; pos < we; pos += BAND_NT) {
    const int owner = pos / R;
    const T* src = cluster.map_shared_rank(ex, owner);
    xw[pos - ws] = f(pos, src[par + pos - owner * R]);
  }
}

// Launch kernel over P clusters of B blocks of BAND_NT threads with smem
// bytes of dynamic shared memory each (cudaLaunchKernelEx with a cluster
// dimension; above 8 blocks, non-portable cluster sizes allowed).
template <typename... KArgs>
inline cudaError_t band_config(void (*kernel)(KArgs...), int grid, int B,
                               size_t smem, cudaStream_t stream,
                               cudaLaunchConfig_t* cfg,
                               cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (B > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(BAND_NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = B;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename... KArgs, typename... Args>
inline cudaError_t launch_band(void (*kernel)(KArgs...), int P, int B,
                               size_t smem, cudaStream_t stream,
                               Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = band_config(kernel, P * B, B, smem, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of B blocks with smem bytes each the card runs at once
// (cudaOccupancyMaxActiveClusters).
template <typename... KArgs>
inline cudaError_t band_max_clusters(void (*kernel)(KArgs...), int B,
                                     size_t smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = band_config(kernel, B, B, smem, 0, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
  if (err != cudaSuccess) cudaGetLastError();  // a refused size is no fault
  return err;
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
