// K1: the layered SpMV y = A x on the plane-block-tridiagonal operator,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   stabilized_navier_stokes_flow_fenicsx_tpu/assemble/pallas_spmv.py::
//   _spmv_kernel (launched by layered_matvec_pallas)
// and computes what it computes:
//
//   y[l, i, c] = sum_{e: row(e) = i} sum_{j, d}
//                V[c, j, d, e, l] * x[l + d - 1, col(e), j]
//
// with x[-1] = x[Lp] = 0, V laid out (bs, bs, 3, E, Lp) and x, y
// plane-major (Lp, n2d, bs), bs = 4.  The pairs e are sorted by row, so
// row(e) = i exactly for e in [row_ptr[i], row_ptr[i + 1]).
//
// What bounds it: the value stream.  Every call reads all 48 * E * Lp
// values once (x and y are 48x smaller and stay in L2); at the lc = 0.04
// channel (E ~ 5.0k pairs, Lp = 77) that is ~149 MB in f64 or ~37 MB in
// bf16.  So the kernel is memory bound, and the design spends its effort
// on streaming V:
//   * one thread per (2D row i, plane l), with l fastest across threads,
//     so a warp's loads of V[c, j, d, e, l .. l + 31] are contiguous and
//     coalesced for every (c, j, d, e) it visits;
//   * the thread walks its row's pairs, d and j, keeps the bs outputs in
//     registers and writes them once: no atomics, no intermediate in
//     device memory (the TPU kernel's in-VMEM reduction, here in
//     registers);
//   * the TPU kernel's ELL padding and 128-lane plane padding existed for
//     its static tiles; this kernel reads the COO pair form directly, so
//     it streams exactly the 48 * E * Lp real values.
// The x gathers x[l + d - 1, col(e), :] are bs-component rows (16 bytes
// in f32, 32 in f64), each reused by the bs * bs values of its (e, d).
//
// Types: the value type VT is double, float or bf16; the accumulator AT
// (= the type of x and y) is double or float.  With VT narrower than AT,
// x is first rounded to VT (as the JAX layered_matvec casts x to the
// value dtype), then each product and the sum are taken in AT.
//
// Interface: plain C, loaded with ctypes.  The launch goes onto the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BS = 4;

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

template <typename VT, typename AT>
__global__ void __launch_bounds__(256)
layered_spmv_kernel(const VT* __restrict__ vals, const AT* __restrict__ x,
                    const int64_t* __restrict__ cols,
                    const int64_t* __restrict__ row_ptr,
                    AT* __restrict__ y, int n2d, int E, int Lp) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= int64_t(n2d) * Lp) return;
  const int i = int(t / Lp);
  const int l = int(t - int64_t(i) * Lp);
  const int64_t plane = int64_t(n2d) * BS;      // x/y stride of one plane
  const int64_t dstride = int64_t(E) * Lp;      // V stride of one d
  const int64_t jstride = 3 * dstride;          // V stride of one j
  const int64_t cstride = BS * jstride;         // V stride of one c

  AT acc[BS] = {AT(0), AT(0), AT(0), AT(0)};
  const int64_t e_end = row_ptr[i + 1];
  for (int64_t e = row_ptr[i]; e < e_end; ++e) {
    const int64_t col = cols[e];
    const VT* ve = vals + e * Lp + l;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int lc = l + d - 1;
      if (lc < 0 || lc >= Lp) continue;
      const AT* xp = x + lc * plane + col * BS;
      AT xv[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j) xv[j] = Conv<VT, AT>::x(xp[j]);
#pragma unroll
      for (int c = 0; c < BS; ++c) {
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          acc[c] += Conv<VT, AT>::val(ve[c * cstride + j * jstride
                                         + d * dstride]) * xv[j];
        }
      }
    }
  }
  AT* yp = y + int64_t(l) * plane + int64_t(i) * BS;
#pragma unroll
  for (int c = 0; c < BS; ++c) yp[c] = acc[c];
}

template <typename VT, typename AT>
void launch(const void* vals, const void* x, const int64_t* cols,
            const int64_t* row_ptr, void* y, int n2d, int E, int Lp,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = int64_t(n2d) * Lp;
  const unsigned blocks = unsigned((n + threads - 1) / threads);
  layered_spmv_kernel<VT, AT><<<blocks, threads, 0, stream>>>(
      static_cast<const VT*>(vals), static_cast<const AT*>(x), cols,
      row_ptr, static_cast<AT*>(y), n2d, E, Lp);
}

}  // namespace

// vtype: 0 = double, 1 = float, 2 = bf16; atype: 0 = double, 1 = float.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a type pair it does not take).
extern "C" int layered_spmv(int vtype, int atype, const void* vals,
                            const void* x, const int64_t* cols,
                            const int64_t* row_ptr, void* y, int n2d,
                            int E, int Lp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (atype == 0) {
    if (vtype == 0) launch<double, double>(vals, x, cols, row_ptr, y, n2d, E, Lp, s);
    else if (vtype == 1) launch<float, double>(vals, x, cols, row_ptr, y, n2d, E, Lp, s);
    else if (vtype == 2) launch<__nv_bfloat16, double>(vals, x, cols, row_ptr, y, n2d, E, Lp, s);
    else return int(cudaErrorInvalidValue);
  } else if (atype == 1) {
    if (vtype == 0) launch<double, float>(vals, x, cols, row_ptr, y, n2d, E, Lp, s);
    else if (vtype == 1) launch<float, float>(vals, x, cols, row_ptr, y, n2d, E, Lp, s);
    else if (vtype == 2) launch<__nv_bfloat16, float>(vals, x, cols, row_ptr, y, n2d, E, Lp, s);
    else return int(cudaErrorInvalidValue);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
