// The dense local-K step kernels, K1 and K2.
//
// K1 (fint_matvec) replaces savtpu/ops/pallas_step.py:59 (_matvec_kernel,
// via batched_fint_matvec): one step's F_int = K d for every part, K
// (P, DL, DL) symmetric and row-major. It is bound by reading K once
// (P DL^2 values per call). One warp per row, eight rows per block, grid
// (DL/8, P): the lanes walk the row in 16-byte loads (float4 / double2),
// four in flight per lane, so a full card holds some 128 KB of K in flight
// per SM. A row whose start is not 16-byte aligned (DL = 526: every other
// row) takes a scalar head up to the first aligned element and a scalar
// tail; d is read as vectors where its offset is aligned too, else element
// by element. At 96x8x8/8 it reads K at 89% of the HBM peak (PERF.md).
//
// K2 (scan_comm_free) replaces savtpu/ops/pallas_step.py:97 (_scan_kernel,
// via pallas_scan_comm_free): the whole comm-free scan, num_steps
// central-difference steps of every part, with optional prediction
// overwrite of the shared slots and per-step recording of the shared rows.
// Parts are independent without the exchange. The host-side plan
// (ops/dense_step.scan_plan) picks one of two kernels:
//
// - scan_kernel, one persistent block per part, where one part's K fits in
//   a block's shared memory beside the state (the sweep's 25x1x1/2), the
//   counterpart of the TPU's VMEM-resident K; also the fallback shape when
//   the parts leave no room for a second block each (more parts than half
//   the SMs), K then re-read from global memory every step.
// - scan_split_kernel, everywhere else: the rows of a part split over B
//   blocks, P B <= the SM count, one block per SM, all co-resident under a
//   cooperative launch. Each block owns a contiguous range of R rows: their
//   matvec (a warp per row), the update, the overwrite and the recording,
//   all row-local. Where the block's R rows of K fit in its shared memory
//   (48x4x4/8: 33 rows, 69 KB in float32) they are loaded once and stay
//   there, pitch padded to 16 bytes; else (96x8x8/8: 320 MB of K, far
//   beyond 50 MB of L2 and 132 x 227 KB) they stream from HBM every step
//   in K1's 16-byte loads, four per lane in flight, so that every
//   SM reads K and the step is bound by the card's HBM rate (95 us for
//   320 MB). The new state crosses blocks through a double-buffered copy
//   of d in global memory (read back through L2 with ld.global.cg) and one
//   barrier per part and step: each block adds one to its part's counter
//   and waits until all B have arrived. The counter counts arrivals; no
//   sum of values uses atomics, so a run gives the same bits every time.
//
// The shared-slot overwrite and recording go through a slot map (slot[j] =
// the shared slot of local DOF j, or -1) instead of the TPU's one-hot
// matmuls, which were exact: the values are the same.
//
// Rounding: built with -fmad=false; the update (common.cuh) rounds like the
// plain versions in ops/dense_step.py, which form t = t0 + i dt and the
// coefficients from t0, dt, alpha cast to the state dtype, as the TPU
// kernel does. Only the matvec's sum order differs.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using savtpu::Rn;
using savtpu::Vec;
using savtpu::ld_stream;
using savtpu::warp_sum;

constexpr int MV_ROWS = 8;       // K1: rows (warps) per block
constexpr int NT = 1024;         // K2: threads per block
constexpr int NW = NT / 32;

// How a row of K is read: from global memory as a read-only stream that
// does not allocate in L1 and asks L2 for whole 256-byte sectors (K1 and
// K2 streamed; at 96x8x8/8 K1 reads K 1.6% faster than with __ldg), or
// plainly (K in shared memory).
enum class KLoad { global, shared };

template <KLoad M, typename V>
__device__ __forceinline__ V load_k(const V* p) {
  if constexpr (M == KLoad::global) return ld_stream(p);
  else return *p;
}

// One lane's share of the dot product of row k (n values) with x, in
// 16-byte loads of k, four in flight: a scalar head up to k's first
// 16-byte boundary, the vector body, a scalar tail. x is read as vectors
// where x + head is 16-byte aligned too, else element by element. The
// caller sums the lanes (warp_sum).
template <typename T, KLoad M, bool XV>
__device__ __forceinline__ T row_body(const typename Vec<T>::type* kv,
                                      const T* xh, int nv, int lane) {
  using VT = typename Vec<T>::type;
  constexpr int W = Vec<T>::N;
  const VT* xv = reinterpret_cast<const VT*>(xh);
  T acc = T(0);
  int v = lane;
  for (; v + 96 < nv; v += 128) {
    const VT a0 = load_k<M>(kv + v), a1 = load_k<M>(kv + v + 32);
    const VT a2 = load_k<M>(kv + v + 64), a3 = load_k<M>(kv + v + 96);
    if constexpr (XV) {
      acc += Vec<T>::dot(a0, xv[v]);
      acc += Vec<T>::dot(a1, xv[v + 32]);
      acc += Vec<T>::dot(a2, xv[v + 64]);
      acc += Vec<T>::dot(a3, xv[v + 96]);
    } else {
      acc += Vec<T>::dot(a0, xh + W * v);
      acc += Vec<T>::dot(a1, xh + W * (v + 32));
      acc += Vec<T>::dot(a2, xh + W * (v + 64));
      acc += Vec<T>::dot(a3, xh + W * (v + 96));
    }
  }
  for (; v < nv; v += 32) {
    const VT a = load_k<M>(kv + v);
    if constexpr (XV) acc += Vec<T>::dot(a, xv[v]);
    else acc += Vec<T>::dot(a, xh + W * v);
  }
  return acc;
}

template <typename T, KLoad M>
__device__ __forceinline__ T row_dot(const T* __restrict__ k, const T* x,
                                     int n, int lane) {
  using VT = typename Vec<T>::type;
  constexpr int W = Vec<T>::N;
  int head = (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(k) & 15u))
                    & 15u) / sizeof(T));
  if (head > n) head = n;
  T acc = T(0);
  if (lane < head) acc = k[lane] * x[lane];
  const int nv = (n - head) / W;
  const VT* kv = reinterpret_cast<const VT*>(k + head);
  const T* xh = x + head;
  if ((reinterpret_cast<uintptr_t>(xh) & 15u) == 0)
    acc += row_body<T, M, true>(kv, xh, nv, lane);
  else
    acc += row_body<T, M, false>(kv, xh, nv, lane);
  for (int j = head + nv * W + lane; j < n; j += 32) acc += k[j] * x[j];
  return warp_sum(acc);
}

template <typename T>
__global__ void __launch_bounds__(MV_ROWS * 32) fint_matvec_kernel(
    const T* __restrict__ K, const T* __restrict__ d, T* __restrict__ out,
    int DL) {
  const int p = blockIdx.y;
  const int row = blockIdx.x * MV_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= DL) return;  // whole warps only
  const T* k = K + ((size_t)p * DL + row) * DL;
  const T acc = row_dot<T, KLoad::global>(k, d + (size_t)p * DL, DL, lane);
  if (lane == 0) out[(size_t)p * DL + row] = acc;
}

// ---- K2, one block per part -------------------------------------------

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

// ---- K2, B blocks per part ----------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Barrier of the B blocks of one part: every block's writes before it are
// visible to every block of the part after it. ctr counts arrivals since
// the launch; the n-th barrier waits for B n of them. A wait of 10 s means
// a block of the part is gone: trap (the launch then fails) rather than
// hang the card.
__device__ __forceinline__ void part_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    if (ld_acquire(ctr) < target) {
      const unsigned long long start = globaltimer_ns();
      while (ld_acquire(ctr) < target) {
        if (globaltimer_ns() - start > 10000000000ull) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Shared memory of a split block (offsets in T; DLp = DL rounded up to a
// 16-byte multiple): Ks (R DLp, resident only), x (DLp), y, dn, Fp, lM,
// bc (R each), slot (R ints). ops/dense_step.scan_plan sizes it the same.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(NT, 1) scan_split_kernel(
    const T* __restrict__ K, const T* __restrict__ d0_in,
    const T* __restrict__ dn_in, const T* __restrict__ Fp_in,
    const T* __restrict__ lM_in, const T* __restrict__ bc_in,
    const int* __restrict__ slot_in, const T* __restrict__ preds,
    T* __restrict__ d0_out, T* __restrict__ dn_out,
    T* __restrict__ shared_out, T* buf, unsigned* ctr, int P, int DL,
    int S3, int num_steps, int use_preds, int record_shared, int ramped,
    int B, int R, T t0, T dt, T alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int W = Vec<T>::N;
  const int DLp = (DL + W - 1) / W * W;
  const int p = blockIdx.x / B, b = blockIdx.x - p * B;
  const int r0 = b * R;
  const int nr = min(R, DL - r0);  // rows of this block (> 0 by the plan)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* x = Ks + (RESIDENT ? (size_t)R * DLp : 0);
  T* y = x + DLp;
  T* dn = y + R;
  T* Fp = dn + R;
  T* lM = Fp + R;
  T* bc = lM + R;
  int* slot = reinterpret_cast<int*>(bc + R);

  const size_t vo = (size_t)p * DL;
  for (int i = tid; i < nr; i += NT) {
    dn[i] = dn_in[vo + r0 + i];
    Fp[i] = Fp_in[vo + r0 + i];
    lM[i] = lM_in[vo + r0 + i];
    bc[i] = bc_in[vo + r0 + i];
    slot[i] = slot_in[vo + r0 + i];
  }
  for (int j = DL + tid; j < DLp; j += NT) x[j] = T(0);
  const T* Kb = K + (vo + r0) * DL;  // this block's first row
  if (RESIDENT) {
    for (size_t e = tid; e < (size_t)nr * DLp; e += NT) {
      const int i = (int)(e / DLp), j = (int)(e - (size_t)i * DLp);
      Ks[e] = j < DL ? Kb[(size_t)i * DL + j] : T(0);
    }
  }

  const savtpu::StepCoeffs<T> coef(dt, alpha);
  const T* preds_p = use_preds ? preds + (size_t)p * num_steps * S3 : nullptr;
  T* shared_p =
      record_shared ? shared_out + (size_t)p * num_steps * S3 : nullptr;
  const size_t half = (size_t)P * DL;

  for (int t = 0; t < num_steps; ++t) {
    // the part's whole d: the input at step 0, then the buffer the
    // previous step wrote (through L2: other SMs wrote it)
    if (t == 0) {
      for (int j = tid; j < DL; j += NT) x[j] = d0_in[vo + j];
    } else {
      const T* src = buf + (t & 1) * half + vo;
      for (int j = tid; j < DL; j += NT) x[j] = __ldcg(src + j);
    }
    __syncthreads();

    // y = K x for this block's rows, a warp per row
    for (int i = warp; i < nr; i += NW) {
      const T acc =
          RESIDENT ? row_dot<T, KLoad::shared>(Ks + (size_t)i * DLp, x, DLp,
                                               lane)
                   : row_dot<T, KLoad::global>(Kb + (size_t)i * DL, x, DL,
                                               lane);
      if (lane == 0) y[i] = acc;
    }
    __syncthreads();

    const T ramp = savtpu::ramp_at(t0, dt, t, ramped);
    T* dst = buf + ((t + 1) & 1) * half + vo;
    const bool last = t == num_steps - 1;
    for (int i = tid; i < nr; i += NT) {
      const int j = r0 + i;
      const T a = x[j];
      T d1 = savtpu::central_difference(coef, y[i], a, dn[i], Fp[i], lM[i],
                                        bc[i], ramp);
      const int s = slot[i];
      if (use_preds && s >= 0) d1 = preds_p[(size_t)t * S3 + s];
      dn[i] = a;
      if (record_shared && s >= 0) shared_p[(size_t)t * S3 + s] = d1;
      if (last) {
        d0_out[vo + j] = d1;
        dn_out[vo + j] = a;
      } else {
        __stcg(dst + j, d1);
      }
    }
    if (!last) part_barrier(ctr + p, (unsigned)B * (unsigned)(t + 1));
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

#define SAVTPU_SCAN_ARGS                                                   \
  const void *K, const void *d0, const void *dn, const void *Fp,           \
      const void *lM, const void *bc, const void *slot, const void *preds, \
      void *d0_out, void *dn_out, void *shared, void *buf, void *ctr,      \
      void *stream, int P, int DL, int S3, int num_steps, int use_preds,   \
      int record_shared, int ramped, int blocks, int rows, int resident,   \
      int smem, double t0, double dt, double alpha
#define SAVTPU_SCAN_CALL                                                   \
  K, d0, dn, Fp, lM, bc, slot, preds, d0_out, dn_out, shared, buf, ctr,    \
      stream, P, DL, S3, num_steps, use_preds, record_shared, ramped,      \
      blocks, rows, resident, smem, t0, dt, alpha

template <typename T, bool K_SHARED>
int launch_one(SAVTPU_SCAN_ARGS) {
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T, K_SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<T, K_SHARED><<<P, NT, smem, (cudaStream_t)stream>>>(
      (const T*)K, (const T*)d0, (const T*)dn, (const T*)Fp, (const T*)lM,
      (const T*)bc, (const int*)slot, (const T*)preds, (T*)d0_out,
      (T*)dn_out, (T*)shared, DL, S3, num_steps, use_preds, record_shared,
      ramped, (T)t0, (T)dt, (T)alpha);
  return (int)cudaGetLastError();
}

// B blocks per part under a cooperative launch, which guarantees that all
// P B blocks are resident at once (the part barrier needs it) or refuses.
template <typename T, bool RESIDENT>
int launch_split(SAVTPU_SCAN_ARGS) {
  auto kernel = scan_split_kernel<T, RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  T t0c = (T)t0, dtc = (T)dt, alc = (T)alpha;
  void* args[] = {(void*)&K,      (void*)&d0,        (void*)&dn,
                  (void*)&Fp,     (void*)&lM,        (void*)&bc,
                  (void*)&slot,   (void*)&preds,     (void*)&d0_out,
                  (void*)&dn_out, (void*)&shared,    (void*)&buf,
                  (void*)&ctr,    (void*)&P,         (void*)&DL,
                  (void*)&S3,     (void*)&num_steps, (void*)&use_preds,
                  (void*)&record_shared, (void*)&ramped, (void*)&blocks,
                  (void*)&rows,   (void*)&t0c,       (void*)&dtc,
                  (void*)&alc};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(P * blocks),
                                    dim3(NT), args, (size_t)smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scan(SAVTPU_SCAN_ARGS) {
  if (P <= 0 || DL <= 0 || S3 <= 0 || num_steps <= 0 || blocks <= 0 ||
      rows <= 0 || smem <= 0 || (size_t)blocks * rows < (size_t)DL ||
      (size_t)(blocks - 1) * rows >= (size_t)DL)
    return (int)cudaErrorInvalidValue;
  if (blocks == 1)
    return resident ? launch_one<T, true>(SAVTPU_SCAN_CALL)
                    : launch_one<T, false>(SAVTPU_SCAN_CALL);
  return resident ? launch_split<T, true>(SAVTPU_SCAN_CALL)
                  : launch_split<T, false>(SAVTPU_SCAN_CALL);
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

extern "C" int savtpu_scan_comm_free_f32(SAVTPU_SCAN_ARGS) {
  return launch_scan<float>(SAVTPU_SCAN_CALL);
}

extern "C" int savtpu_scan_comm_free_f64(SAVTPU_SCAN_ARGS) {
  return launch_scan<double>(SAVTPU_SCAN_CALL);
}

extern "C" const char* savtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
