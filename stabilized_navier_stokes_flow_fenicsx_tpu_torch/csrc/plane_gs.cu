// K2: the plane Gauss-Seidel sweep of the layered operator, written by
// hand for Hopper (sm_90a); both sweep directions in one launch.
//
// Replaces the lax.scans of
//   stabilized_navier_stokes_flow_fenicsx_tpu/solve/precond.py:251-341
//   (plane_gs_layered; jnp code, not a Pallas kernel)
// and computes what they compute, for plane-major vectors (Lp, n2d, bs),
// bs = 4.  Downstream, for each plane l in order:
//
//   rhs = m * (r_l - Vm_l x_{l-1}) + (1 - m) * r_l        (x_{-1} = 0)
//   x_l = Dinv_l rhs
//   inner_sweeps times:
//     x_l += Dinv_l [(rhs - V0_l (m * x_l)) * m + (1 - m) * (rhs - x_l)]
//
// where (V x)[i, c] = sum_{e: row(e) = i} sum_j V[e, c, j] x[col(e), j] is
// the plane's 2D product with one value slice, m the plane's 0/1 mask and
// Dinv_l its projected diagonal blocks' inverses.  With `symmetric` the
// upstream sweep follows, l = Lp-1 .. 0, with Vp and x_{l+1} (x_{Lp} = 0)
// of the upstream sweep, starting each plane's relaxation from its
// downstream x_l instead of Dinv_l rhs.  The pairs e are sorted by row:
// row(e) = i for e in [row_ptr[i], row_ptr[i + 1]).
//
// Layout (built once per values tensor by the wrapper, solve/plane_gs.py):
// values (3, Lp, E, 4, 4), slice 0 = Vm (couples x_{l-1}), 1 = V0, 2 = Vp,
// so one plane's pairs are one contiguous block; Dinv (Lp, n2d, 4, 4) in
// the value type; the mask (Lp, n2d, 4) in the iterate's.
//
// Design, simple first: one thread block walks the planes in order, its
// threads striding over the plane's (row i, component c) pairs, one
// __syncthreads() between the stages of a plane (the coupling, each inner
// pass).  The four threads of a row are neighbouring lanes of one warp,
// so the 4x4 block inverse gathers the row's residual by warp shuffles.
// The iterate, the plane's rhs and the inner passes' second buffer live
// in global memory: within one block that memory is coherent across
// __syncthreads(), so the kernel takes any n2d; the inner passes swap
// the two buffers instead of copying.
//
// What bounds it: one SM's share of the memory bandwidth (every value
// slice passes through the one SM; V0 is read 2 * inner_sweeps times),
// plus a block barrier per stage, (1 + inner_sweeps) per plane and
// direction, with the dependent loads of a stage (row_ptr, cols, x) in
// between.  The card's byte bound for the same work is far lower: the
// redesign is a later PR's work (a thread-block cluster sharing the
// iterate in distributed shared memory, or one block per group of planes).
//
// Types: values and inverses VT in double, float or bf16; the iterate,
// rhs, mask and every sum in AT = double for double values, else float.
// The JAX package rounds its whole bf16 sweep to bf16 (iterate included);
// this kernel keeps the float32 iterate, so the two agree only to bf16
// accuracy while the kernel and its plain version agree to float32's.
//
// Interface: plain C, loaded with ctypes.  The launch goes onto the
// caller's stream, allocates nothing (the caller passes 2 * n2d * 4
// iterate-typed scratch values), and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The prepared operand, fixed per values tensor.
struct Params {
  const void* vals;          // (3, Lp, E, 4, 4) in the value type
  const void* dinv;          // (Lp, n2d, 4, 4) in the value type
  const void* mask;          // (Lp, n2d, 4) in the iterate type
  const int64_t* cols;       // (E,) column node of each pair
  const int64_t* row_ptr;    // (n2d + 1,) pairs of row i
  int vtype;                 // 0 = double, 1 = float, 2 = bf16
  int n2d, Lp, E;
  int inner_sweeps;          // >= 0
  int symmetric;             // 0 or 1
};

namespace {

constexpr int BS = 4;
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double val(double v) { return v; }
__device__ __forceinline__ float val(float v) { return v; }
__device__ __forceinline__ float val(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// sum_{e in row} sum_j V[e, c, j] * x[col(e), j] (* m[col(e), j] when
// masked), for the plane slice V (E, 4, 4).
template <typename VT, typename AT, bool MASKED>
__device__ __forceinline__ AT row_product(const VT* __restrict__ V,
                                          const AT* xp, const AT* mp,
                                          const int64_t* __restrict__ cols,
                                          int64_t e0, int64_t e1, int c) {
  AT acc = AT(0);
  for (int64_t e = e0; e < e1; ++e) {
    const int64_t j0 = cols[e] * BS;
    const VT* v = V + e * (BS * BS) + c * BS;
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      AT xj = xp[j0 + j];
      if (MASKED) xj *= mp[j0 + j];
      acc += AT(val(v[j])) * xj;
    }
  }
  return acc;
}

// (Dinv_i w_i)[c]: w of the row's four components from the row's four
// neighbouring lanes.  Every lane of the warp calls it.
template <typename VT, typename AT>
__device__ __forceinline__ AT block_inverse(const VT* __restrict__ Di,
                                            AT w, bool ok, int c) {
  const int lane0 = (threadIdx.x & 31) & ~(BS - 1);
  AT s = AT(0);
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    const AT wj = __shfl_sync(FULL, w, lane0 + j);
    if (ok) s += AT(val(Di[c * BS + j])) * wj;
  }
  return s;
}

template <typename VT, typename AT>
__global__ void __launch_bounds__(MAX_THREADS)
plane_gs_kernel(const VT* __restrict__ vals, const VT* __restrict__ dinv,
                const AT* __restrict__ mask,
                const int64_t* __restrict__ cols,
                const int64_t* __restrict__ row_ptr,
                const AT* __restrict__ r, AT* x, AT* scratch, int n2d,
                int Lp, int E, int inner_sweeps, int symmetric) {
  const int n = n2d * BS;                 // dofs of one plane
  const int64_t slice = int64_t(E) * BS * BS;
  AT* rhs = scratch;                      // (n,) the plane's rhs
  AT* other = scratch + n;                // (n,) the inner passes' buffer
  const int ndir = symmetric ? 2 : 1;
  for (int dir = 0; dir < ndir; ++dir) {
    const bool down = dir == 0;
    for (int s = 0; s < Lp; ++s) {
      const int l = down ? s : Lp - 1 - s;
      const int nb = down ? l - 1 : l + 1;   // the neighbour plane
      const bool has_nb = nb >= 0 && nb < Lp;
      const VT* Vc = vals + (int64_t(down ? 0 : 2) * Lp + l) * slice;
      const VT* V0 = vals + (int64_t(Lp) + l) * slice;
      const VT* Dl = dinv + int64_t(l) * n * BS;
      const AT* ml = mask + int64_t(l) * n;
      const AT* rl = r + int64_t(l) * n;
      AT* xl = x + int64_t(l) * n;
      const AT* xnb = has_nb ? x + int64_t(nb) * n : x;
      // the coupling: rhs, and downstream the first x_l = Dinv_l rhs
      for (int base = 0; base < n; base += blockDim.x) {
        const int t = base + threadIdx.x;
        const bool ok = t < n;
        const int i = t / BS, c = t - (t / BS) * BS;
        AT rh = AT(0);
        if (ok) {
          AT acc = AT(0);
          if (has_nb)
            acc = row_product<VT, AT, false>(Vc, xnb, nullptr, cols,
                                             row_ptr[i], row_ptr[i + 1], c);
          const AT m = ml[t];
          rh = m * (rl[t] - acc) + (AT(1) - m) * rl[t];
          rhs[t] = rh;
        }
        if (down) {
          const AT x0 = block_inverse<VT, AT>(Dl + int64_t(ok ? i : 0) * BS
                                              * BS, rh, ok, c);
          if (ok) xl[t] = x0;
        }
      }
      __syncthreads();
      // the inner passes, from xl into the other buffer and back
      const AT* src = xl;
      AT* dst = other;
      for (int k = 0; k < inner_sweeps; ++k) {
        for (int base = 0; base < n; base += blockDim.x) {
          const int t = base + threadIdx.x;
          const bool ok = t < n;
          const int i = t / BS, c = t - (t / BS) * BS;
          AT res = AT(0), xi = AT(0);
          if (ok) {
            const AT acc = row_product<VT, AT, true>(
                V0, src, ml, cols, row_ptr[i], row_ptr[i + 1], c);
            const AT m = ml[t], rh = rhs[t];
            xi = src[t];
            res = (rh - acc) * m + (AT(1) - m) * (rh - xi);
          }
          const AT dx = block_inverse<VT, AT>(Dl + int64_t(ok ? i : 0) * BS
                                              * BS, res, ok, c);
          if (ok) dst[t] = xi + dx;
        }
        __syncthreads();
        AT* next = const_cast<AT*>(src);
        src = dst;
        dst = next;
      }
      if (src != xl) {      // an odd number of passes ends in the other
        for (int t = threadIdx.x; t < n; t += blockDim.x) xl[t] = src[t];
        __syncthreads();
      }
    }
  }
}

template <typename VT, typename AT>
int launch(const void* r, void* x, void* scratch, cudaStream_t stream,
           const Params& P) {
  const int n = P.n2d * BS;
  const int threads = n < MAX_THREADS ? (n + 31) / 32 * 32 : MAX_THREADS;
  plane_gs_kernel<VT, AT><<<1, threads, 0, stream>>>(
      static_cast<const VT*>(P.vals), static_cast<const VT*>(P.dinv),
      static_cast<const AT*>(P.mask), P.cols, P.row_ptr,
      static_cast<const AT*>(r), static_cast<AT*>(x),
      static_cast<AT*>(scratch), P.n2d, P.Lp, P.E, P.inner_sweeps,
      P.symmetric);
  return int(cudaGetLastError());
}

}  // namespace

// One launch of K2 on `stream`: x = the sweep applied to r, both in the
// iterate type (double for double values, float for float and bf16
// values), scratch 2 * n2d * 4 values of it.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not
// take (nothing is launched then).
extern "C" int plane_gs(const void* r, void* x, void* scratch, void* stream,
                        const Params* P) {
  if (P == nullptr || P->n2d <= 0 || P->Lp <= 0 || P->E <= 0
      || P->inner_sweeps < 0 || P->n2d > (1 << 28))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P->vtype) {
    case 0: return launch<double, double>(r, x, scratch, s, *P);
    case 1: return launch<float, float>(r, x, scratch, s, *P);
    case 2: return launch<__nv_bfloat16, float>(r, x, scratch, s, *P);
    default: return int(cudaErrorInvalidValue);
  }
}
