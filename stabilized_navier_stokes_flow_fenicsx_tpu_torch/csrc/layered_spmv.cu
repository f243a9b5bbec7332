// K1: the layered SpMV y = A x on the plane-block-tridiagonal operator,
// written by hand for Hopper (sm_90a), with the Dirichlet (BC)
// projection optionally fused in.
//
// Replaces the TPU kernel
//   stabilized_navier_stokes_flow_fenicsx_tpu/assemble/pallas_spmv.py::
//   _spmv_kernel (launched by layered_matvec_pallas)
// and computes what it computes:
//
//   y[l, i, c] = sum_{e: row(e) = i} sum_{j, d}
//                V[c, j, d, e, l] * x[l + d - 1, col(e), j]
//
// with x[-1] = x[Lp] = 0 and x, y plane-major (Lp, n2d, bs), bs = 4.
// With a mask m (0/1 per dof, x's type) it computes in the same pass
//   y = m * A (m * x) + (1 - m) * x,
// reading values into which the wrapper has folded the projection
// (P A P, exact for a 0/1 mask), so the mask is read only for y.
// The pairs e are sorted by row: row(e) = i for e in
// [row_ptr[i], row_ptr[i + 1]).
//
// Value layout (built once per values tensor by the wrapper): pair-major
// (E, 48, Lp_pad), row r = (c * 4 + j) * 3 + d, planes contiguous and
// zero-padded from Lp to Lp_pad (a multiple of 16 bytes).  This is the
// TPU kernel's ell_values layout without its ELL row padding and its
// 128-lane plane padding.
//
// What bounds it: bytes.  Each call streams the 48 * E * Lp values once;
// x, the mask and y are 48x smaller.  Two FLOP per value is 0.25 FLOP/B
// in f64 and 1 FLOP/B in bf16, far below the ~295 FLOP/B at which the
// H100's tensor cores would become the limit, so wgmma buys nothing; the
// design spends its effort on the value stream and on keeping x reads
// out of the way:
//   * one block per 2D row i (749 at lc=0.04: one wave on 132 SMs, so no
//     persistent grid), so no warp straddles a row boundary; the
//     block's threads form teams of 4 * Lp_pad / PPT threads, one thread
//     per (c, run of PPT planes), accumulating its PPT outputs in
//     registers; team g takes the row's pairs g, g + G, ...;
//   * each thread reads its 12 value rows (j, d) of a pair as 12 vector
//     loads of PPT contiguous values (8 bytes by default: PPT = 4 in bf16,
//     1 in f64; the wrapper's launch_shape), and neighbouring threads read
//     neighbouring vectors of the same contiguous 48 x Lp_pad tile;
//   * a team's first pair of values is requested before x is staged, so
//     the value stream starts while the row's pair list and x arrive, and
//     each load of a pair asks L2 for the team's next one;
//   * x[:, col(e), :] of up to PAIRS pairs is staged in shared memory
//     (rounded to the value type as it is staged), with zero halo planes
//     at -1 and >= Lp, so each x value is read from L2 once per pair and
//     not 12 times;
//   * the teams' partial sums meet in shared memory, and the block writes
//     each y value once, thread -> (l, c) with c fastest, so a plane's 4
//     outputs are one coalesced store; no atomics.
//
// On the H100 (PERF.md) this reaches about three quarters of the byte
// bound with f64 values and under half with bf16 values: there a row's
// work is a short chain of dependent loads (row_ptr, cols, x, values)
// and the launch's fixed cost is a third of the whole.
//
// Types: the value type VT is double, float or bf16; the accumulator AT
// (= the type of x, y and the mask) is double or float.  With VT narrower
// than AT, x is first rounded to VT (as the JAX layered_matvec casts x to
// the value dtype), then each product and the sum are taken in AT.
//
// Interface: plain C, loaded with ctypes.  The launch goes onto the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// What a launch needs besides x, y and the mask: fixed per prepared
// operand, so the wrapper builds it once and passes its address.
struct Params {
  const void* vals;          // (E, 48, Lp_pad) in the value type
  const int64_t* cols;       // (E,) column node of each pair
  const int64_t* row_ptr;    // (n2d + 1,) pairs of row i
  int vtype;                 // 0 = double, 1 = float, 2 = bf16
  int n2d, Lp, Lp_pad;
  int ppt;                   // planes per thread: 1, 2, 4 or 8
  int teams;                 // teams per block, 1 .. PAIRS (12)
};

namespace {

constexpr int BS = 4;
constexpr int NROW = BS * BS * 3;   // value rows of one pair
constexpr int PAIRS = 12;           // pairs staged per block-wide sync
constexpr int MAX_THREADS = 512;

template <typename VT, typename AT>
struct Conv;

template <typename AT>
struct Conv<double, AT> {
  static __device__ __forceinline__ AT val(double v) { return AT(v); }
  static __device__ __forceinline__ AT x(AT v) { return v; }
};

template <typename AT>
struct Conv<float, AT> {
  static __device__ __forceinline__ AT val(float v) { return AT(v); }
  static __device__ __forceinline__ AT x(AT v) { return AT(float(v)); }
};

template <>
struct Conv<__nv_bfloat16, float> {
  static __device__ __forceinline__ float val(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float x(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

template <>
struct Conv<__nv_bfloat16, double> {
  static __device__ __forceinline__ double val(__nv_bfloat16 v) {
    return double(__bfloat162float(v));
  }
  static __device__ __forceinline__ double x(double v) {
    return double(__bfloat162float(__double2bfloat16(v)));
  }
};

// N contiguous values, loaded as one (or, above 16 bytes, a few) vector
// loads.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

template <typename AT>
__device__ __forceinline__ void prefetch_l2(const AT* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// A thread's 12 value rows of pair p (vectors of PPT planes), and an L2
// prefetch of the same rows of the team's next pair p + teams.
template <typename VT, int PPT>
__device__ __forceinline__ void load_pair(Vec<VT, PPT> (&v)[BS * 3],
                                          const VT* vbase, int p, int teams,
                                          int n, int64_t vpair, int Lp_pad) {
  const VT* vp = vbase + p * vpair;
#pragma unroll
  for (int r = 0; r < BS * 3; ++r)
    v[r] = *reinterpret_cast<const Vec<VT, PPT>*>(vp + r * Lp_pad);
  if (p + teams < n) {
#pragma unroll
    for (int r = 0; r < BS * 3; ++r)
      prefetch_l2(vp + teams * vpair + r * Lp_pad);
  }
}

// acc[u] += sum_{j, d} V[c, j, d, l0 + u] * x[l0 + u + d - 1, j] for one
// pair: xp[j * S + k] holds x[l0 + k - 1, j].
template <typename VT, typename AT, int PPT>
__device__ __forceinline__ void accumulate(AT (&acc)[PPT],
                                           const Vec<VT, PPT> (&v)[BS * 3],
                                           const AT* xp, int S) {
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    AT xr[PPT + 2];
#pragma unroll
    for (int k = 0; k < PPT + 2; ++k) xr[k] = xp[j * S + k];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int u = 0; u < PPT; ++u)
        acc[u] += Conv<VT, AT>::val(v[j * 3 + d].v[u]) * xr[u + d];
    }
  }
}

template <typename VT, typename AT, int PPT>
__global__ void __launch_bounds__(MAX_THREADS)
layered_spmv_kernel(const VT* __restrict__ vals, const AT* __restrict__ x,
                    const AT* __restrict__ mask,
                    const int64_t* __restrict__ cols,
                    const int64_t* __restrict__ row_ptr,
                    AT* __restrict__ y, int n2d, int Lp, int Lp_pad,
                    int teams) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AT* xs = reinterpret_cast<AT*>(smem_raw);    // (PAIRS, BS, S)
  const int S = Lp_pad + 2;                    // planes -1 .. Lp_pad
  const int nch = Lp_pad / PPT;                // plane runs of a team
  const int team = BS * nch;
  const int tid = threadIdx.x;
  const int g = tid / team;
  const bool busy = g < teams;
  const int lt = tid - g * team;
  const int c = lt / nch;
  const int l0 = (lt - c * nch) * PPT;
  const int i = blockIdx.x;
  const int64_t plane = int64_t(n2d) * BS;
  // the epilogue's x and mask rows of this block's row i: ask L2 for
  // them now, off the critical path
  for (int l = tid; l < Lp; l += blockDim.x) {
    const int64_t off = int64_t(l) * plane + int64_t(i) * BS;
    if (mask != nullptr) {
      prefetch_l2(x + off);
      prefetch_l2(mask + off);
    }
  }
  const int64_t e0 = row_ptr[i];
  const int64_t e1 = row_ptr[i + 1];

  AT acc[PPT];
#pragma unroll
  for (int u = 0; u < PPT; ++u) acc[u] = AT(0);

  for (int64_t base = e0; base < e1; base += PAIRS) {
    const int n = int(e1 - base < PAIRS ? e1 - base : PAIRS);
    const VT* vbase = vals + (base * NROW + c * (BS * 3)) * Lp_pad + l0;
    const int64_t vpair = int64_t(NROW) * Lp_pad;
    // the team's first pair streams in while x is staged; each load of a
    // pair asks L2 for the team's next one (one pair ahead only: the
    // f64 values are 3x the size of L2)
    Vec<VT, PPT> v[BS * 3];
    int p = g;
    if (busy && p < n)
      load_pair<VT, PPT>(v, vbase, p, teams, n, vpair, Lp_pad);
    // stage x[l, col(e), :] at xs[p][j][l + 1], rounded to VT; zero at
    // l = -1 and l >= Lp (the mask is in the values: P A P)
    for (int k = tid; k < n * S; k += blockDim.x) {
      const int q_p = k / S;
      const int lp = k - q_p * S;
      const int l = lp - 1;
      Vec<AT, BS> q;
#pragma unroll
      for (int j = 0; j < BS; ++j) q.v[j] = AT(0);
      if (l >= 0 && l < Lp)
        q = *reinterpret_cast<const Vec<AT, BS>*>(
            x + int64_t(l) * plane + cols[base + q_p] * BS);
      AT* dst = xs + q_p * BS * S + lp;
#pragma unroll
      for (int j = 0; j < BS; ++j) dst[j * S] = Conv<VT, AT>::x(q.v[j]);
    }
    __syncthreads();
    if (busy) {
      while (p < n) {
        accumulate<VT, AT, PPT>(acc, v, xs + p * BS * S + l0, S);
        p += teams;
        if (p < n) load_pair<VT, PPT>(v, vbase, p, teams, n, vpair, Lp_pad);
      }
    }
    __syncthreads();
  }

  // the teams' partial sums meet in shared memory (over the x stage,
  // which every thread has finished reading): red[g][l][c]
  AT* red = xs;
  if (busy) {
#pragma unroll
    for (int u = 0; u < PPT; ++u)
      red[(g * Lp_pad + l0 + u) * BS + c] = acc[u];
  }
  __syncthreads();
  // y, thread -> (l, c) with c fastest (x and mask are in L2: prefetched
  // above)
  for (int o = tid; o < Lp * BS; o += blockDim.x) {
    AT s = AT(0);
    for (int gg = 0; gg < teams; ++gg) s += red[gg * Lp_pad * BS + o];
    const int l = o / BS;
    const int64_t off = int64_t(l) * plane + int64_t(i) * BS + (o - l * BS);
    if (mask != nullptr) {
      const AT m = mask[off];
      s = m * s + (AT(1) - m) * x[off];
    }
    y[off] = s;
  }
}

template <typename VT, typename AT, int PPT>
int launch(const void* x, void* y, cudaStream_t stream, const void* mask,
           const Params& P) {
  const int team = BS * (P.Lp_pad / PPT);
  const int threads = (team * P.teams + 31) / 32 * 32;
  const size_t stage = size_t(PAIRS) * BS * (P.Lp_pad + 2);
  const size_t reduce = size_t(P.teams) * P.Lp_pad * BS;
  const size_t smem = (stage > reduce ? stage : reduce) * sizeof(AT);
  if (threads > MAX_THREADS || smem > 232448) return int(cudaErrorInvalidValue);
  auto kernel = layered_spmv_kernel<VT, AT, PPT>;
  if (smem > 49152) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<P.n2d, threads, smem, stream>>>(
      static_cast<const VT*>(P.vals), static_cast<const AT*>(x),
      static_cast<const AT*>(mask), P.cols, P.row_ptr, static_cast<AT*>(y),
      P.n2d, P.Lp, P.Lp_pad, P.teams);
  return int(cudaGetLastError());
}

template <typename VT, typename AT>
int launch_ppt(const void* x, void* y, cudaStream_t s, const void* mask,
               const Params& P) {
  switch (P.ppt) {
    case 1: return launch<VT, AT, 1>(x, y, s, mask, P);
    case 2: return launch<VT, AT, 2>(x, y, s, mask, P);
    case 4: return launch<VT, AT, 4>(x, y, s, mask, P);
    case 8: return launch<VT, AT, 8>(x, y, s, mask, P);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename AT>
int launch_vt(const void* x, void* y, cudaStream_t s, const void* mask,
              const Params& P) {
  switch (P.vtype) {
    case 0: return launch_ppt<double, AT>(x, y, s, mask, P);
    case 1: return launch_ppt<float, AT>(x, y, s, mask, P);
    case 2: return launch_ppt<__nv_bfloat16, AT>(x, y, s, mask, P);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch of K1 on `stream`.  atype (x, y, mask): 0 = double,
// 1 = float; mask is null for the plain product; P holds the prepared
// operand (see Params).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take (nothing is
// launched then).
extern "C" int layered_spmv(const void* x, void* y, void* stream, int atype,
                            const void* mask, const Params* P) {
  if (P == nullptr || P->Lp <= 0 || P->Lp_pad < P->Lp || P->ppt <= 0
      || P->Lp_pad % P->ppt != 0 || P->teams < 1 || P->teams > PAIRS
      || P->n2d <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (atype == 0) return launch_vt<double>(x, y, s, mask, *P);
  if (atype == 1) return launch_vt<float>(x, y, s, mask, *P);
  return int(cudaErrorInvalidValue);
}
