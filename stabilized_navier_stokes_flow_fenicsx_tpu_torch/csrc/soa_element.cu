// K4: the SUPS/LSIC (and UGN) element Jacobian and residual of the whole
// structured mesh, one launch each, written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package evaluates these element forms
// with jnp code (stabilized_navier_stokes_flow_fenicsx_tpu/forms/soa.py::
// make_sups_soa, make_ugn_soa), not with Pallas.  K4 was added because
// the port's torch-op version of that code (its twin, forms/soa.py's
// res_soa / jac_soa under the chunk loops of assemble/structured.py: a
// torch.func.vmap over 16 jvps a quadrature point, then the E^T A E
// contractions) issues some 1,800 small launches a chunk of cells, and
// streams 16 x C and 16 x 16 x C intermediates through device memory,
// so the card sat idle through most of each Jacobian.
//
// What it computes, per cell (column col, layer l; cell = col * nl + l):
//   * the affine tet geometry of forms/soa.py::_geometry_soa on the
//     transposed coordinates coordsT (12, M3p * nl), converted to T first;
//     the constant P1 gradients g[a][j] (_basis_grads), the metric G,
//     tr G and G:G (make_sups_soa) or the diameter h (make_ugn_soa);
//   * the cell's 16 local dofs gathered in place from w2 = w viewed as
//     (Lp, n2d * bs): dof d of cell (col, l) is w2[l + wolay[col, d],
//     wdof[col, d]] (assemble/structured.py::gather_wT, not built here);
//   * per quadrature point q the state s_q = (u_i, du_i/dx_j, p, dp/dx_j)
//     and the pointwise flux f(s_q) of forms/soa.py (_sups_flux with
//     transposed_stab true or false, or _ugn_flux);
//   * the residual: r[a*4 + alpha] = sum_q w_q E_q^T f(s_q), times |detJ|;
//   * the Jacobian, column (b, beta) by column: E_q e_(b, beta) is the
//     tangent with phi_q[b] in the value slot of component beta and g[b][j]
//     in its three gradient slots, so (df/ds)_q E_q e_(b, beta) is ONE
//     forward-mode derivative of the flux along it (dual numbers); E_q^T
//     of it gives the column's 16 rows, summed over q and times |detJ|.
// Dead cells (alive == 0) and the padding columns up to M3p get exact
// zeros, as the twin's multiply by alive gives; every entry is written.
// The sums keep the twin's order (q outermost, each E^T row as
// phi * F + g0 * F + g1 * F + g2 * F, |detJ| last); the flux derivative
// is taken along the column's tangent, not combined from the 16 unit
// tangents, and nvcc fuses multiply-adds, so entries differ from the
// twin's in their last bits.
//
// Output layout: the layer-minor buffers the structured reduction reads.
//   Jacobian: buf (M3p * 256, nl), row col * 256 + (a*4 + alpha) * 16 +
//     (b*4 + beta) (matrix_values_structured_soa's buf);
//   residual: rbuf (M3p * 16 + 1, nl), row col * 16 + a*4 + alpha, and the
//     appended row M3p * 16 zero (residual_structured's rbufz).
//
// What bounds it, and the design.  The Jacobian writes 256 entries a
// cell (2 KB in f64: 3.2 GB at the bench problem's 1.51M padded cells,
// 0.97 ms at 3.35 TB/s) and computes ~37 kFLOP a live cell (the
// wrapper's count, flops_per_cell: geometry and primal flux again for
// each of the 16 columns, the dual flux and the contractions), 1.57 ms
// at the H100's 34 TFLOP/s of f64 vector math: the operations bound it,
// the bytes not far below.  The residual is bound by its bytes.  So:
//   * one thread a (cell, column b*4 + beta), 16 accumulators and no
//     16 x 16 per thread; the geometry and the primal flux are computed
//     again by each of a cell's 16 threads (cheaper than sharing them
//     through shared memory with a barrier);
//   * consecutive threads take consecutive layers l of one column, then
//     the next column (b, beta): the 16 stores of a thread land, warp by
//     warp, on contiguous runs of a buffer row, and the coordinate reads
//     are contiguous over l (w's rows sit one plane apart: L2 hits);
//   * the residual takes one thread a cell, 16 accumulators;
//   * nothing is indexed by a thread's own (b, beta) but the constant
//     tables: the tangent's g[b] is selected in registers, so that no
//     per-cell array falls to local memory (ptxas: 0 bytes of stack).
//
// Types: T (double or float) is the working dtype of w, the coordinates
// and the outputs; the quadrature tables and the parameters are rounded
// to T, as the twin's Python floats are when they meet a tensor of T.
// The flux is a template argument: FLUX_SUPS_T (SUPS with transposed_stab,
// the channel), FLUX_SUPS (the textbook form, the pillar), FLUX_UGN.
//
// Interface: plain C, loaded with ctypes.  A launch goes onto the
// caller's stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype or flux code it does not take.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int NQ = 4;
constexpr int FLUX_SUPS_T = 0;
constexpr int FLUX_SUPS = 1;
constexpr int FLUX_UGN = 2;

// forms/soa.py::_p1_tables("tetrahedron", 2): phi (nq, 4), the constant
// basis gradients dphi (4, 3) and the weights (nq,)
__constant__ double K4_PHI[NQ][4] = {
    {0.5854101966249684, 0.1381966011250105, 0.1381966011250105,
     0.1381966011250105},
    {0.13819660112501045, 0.5854101966249685, 0.1381966011250105,
     0.1381966011250105},
    {0.13819660112501045, 0.1381966011250105, 0.5854101966249685,
     0.1381966011250105},
    {0.13819660112501042, 0.1381966011250105, 0.1381966011250105,
     0.5854101966249685}};
__constant__ double K4_DPHI[4][3] = {
    {-1.0, -1.0, -1.0}, {1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};
__constant__ double K4_WQ[NQ] = {
    0.041666666666666664, 0.041666666666666664, 0.041666666666666664,
    0.041666666666666664};

// ---- scalars and dual numbers -------------------------------------------

__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }
__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double sqr_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sqr_t(float x) { return sqrtf(x); }
template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ double tiny<double>() {
  return DBL_MIN;
}
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }

// v + eps d: a value and its derivative along one tangent
template <typename T>
struct Dual {
  T v, d;
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) {
  return {a * b.v, a * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) {
  return {a.v * b, a.d * b};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) {
  return {a.v / b, a.d / b};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) {
  return {a.v + b, a.d};
}
// 1 / x
template <typename T>
__device__ __forceinline__ T recip(T x) { return T(1) / x; }
template <typename T>
__device__ __forceinline__ Dual<T> recip(Dual<T> x) {
  T r = T(1) / x.v;
  return {r, -x.d * (r * r)};
}
template <typename T>
__device__ __forceinline__ Dual<T> rsq(Dual<T> x) {
  T r = rsq(x.v);
  return {r, T(-0.5) * x.d * (r * r * r)};
}
template <typename T>
__device__ __forceinline__ Dual<T> sqr_t(Dual<T> x) {
  T s = sqr_t(x.v);
  return {s, x.d / (T(2) * s)};
}
// torch.where(x.v <= eps, 0, y)
template <typename T>
__device__ __forceinline__ T zero_at_or_below(T x, T eps, T y) {
  return x <= eps ? T(0) : y;
}
template <typename T>
__device__ __forceinline__ Dual<T> zero_at_or_below(Dual<T> x, T eps,
                                                    Dual<T> y) {
  return x.v <= eps ? Dual<T>{T(0), T(0)} : y;
}
// torch.minimum(x, 1): at a tie half of the tangent, as torch's forward
// derivative of minimum takes it
template <typename T>
__device__ __forceinline__ T min_one(T x) { return fmin(x, T(1)); }
template <typename T>
__device__ __forceinline__ Dual<T> min_one(Dual<T> x) {
  if (x.v < T(1)) return x;
  return {T(1), x.v == T(1) ? T(0.5) * x.d : T(0)};
}

// ---- the cell ------------------------------------------------------------

// What the flux needs besides the state: the metric (SUPS) or the
// diameter (UGN), and the parameters rounded to T
template <typename T>
struct CellConst {
  T G[3][3], trG, GdG, h;
  T nu, c_i, u_eps;
};

template <typename T>
struct Cell {
  T g[4][3];     // basis gradients
  T absdet;
  T wv[4][4];    // local dofs: wv[a][c] = dof a*4 + c
  T Gu[3][3];    // du_i/dx_j (constant on the cell)
  T gp[3];       // dp/dx_j
  CellConst<T> k;
};

template <int FLUX, typename T>
__device__ __forceinline__ void load_cell(
    const T* __restrict__ coordsT, long long stride,
    long long cell, int col, int l, const long long* __restrict__ wdof,
    const long long* __restrict__ wolay, const T* __restrict__ w,
    long long n2dbs, T nu, T c_i, T u_eps, Cell<T>& c) {
  T x[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      x[a][i] = __ldg(coordsT + (a * 3 + i) * stride + cell);
  T J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) J[i][k] = x[k + 1][i] - x[0][i];
  T c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
  T c01 = J[1][0] * J[2][2] - J[1][2] * J[2][0];
  T c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
  T det = J[0][0] * c00 - J[0][1] * c01 + J[0][2] * c02;
  T inv_det = T(1) / det;
  T invJ[3][3] = {
      {c00 * inv_det, -(J[0][1] * J[2][2] - J[0][2] * J[2][1]) * inv_det,
       (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * inv_det},
      {-c01 * inv_det, (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * inv_det,
       -(J[0][0] * J[1][2] - J[0][2] * J[1][0]) * inv_det},
      {c02 * inv_det, -(J[0][0] * J[2][1] - J[0][1] * J[2][0]) * inv_det,
       (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * inv_det}};
  c.absdet = fabs(det);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) s = s + T(K4_DPHI[a][k]) * invJ[k][j];
      c.g[a][j] = s;
    }
  c.k.nu = nu;
  c.k.c_i = c_i;
  c.k.u_eps = u_eps;
  if (FLUX == FLUX_UGN) {
    T h2 = T(0);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a + 1; b < 4; ++b) {
        T d = T(0);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          d = d + (x[a][i] - x[b][i]) * (x[a][i] - x[b][i]);
        h2 = (a == 0 && b == 1) ? d : fmax(h2, d);
      }
    c.k.h = sqr_t(h2);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < 3; ++k) s = s + invJ[k][i] * invJ[k][j];
        c.k.G[i][j] = s;
        c.k.G[j][i] = s;     // the same products, commuted
      }
    c.k.trG = c.k.G[0][0] + c.k.G[1][1] + c.k.G[2][2];
    T s = T(0);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) s = s + c.k.G[i][j] * c.k.G[i][j];
    c.k.GdG = s;
  }
  // the gather: dof d of the cell sits on plane l + wolay[col, d]
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    long long row = l + __ldg(wolay + col * 16 + d);
    c.wv[d >> 2][d & 3] = __ldg(w + row * n2dbs + __ldg(wdof + col * 16 + d));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = T(0);
#pragma unroll
      for (int a = 0; a < 4; ++a) s = s + c.g[a][j] * c.wv[a][i];
      c.Gu[i][j] = s;
    }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    T s = T(0);
#pragma unroll
    for (int a = 0; a < 4; ++a) s = s + c.g[a][j] * c.wv[a][3];
    c.gp[j] = s;
  }
}

// u_q and p_q: the values at quadrature point q
template <typename T>
__device__ __forceinline__ void values_at(const Cell<T>& c, int q, T u[3],
                                          T& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T s = T(0);
#pragma unroll
    for (int a = 0; a < 4; ++a) s = s + T(K4_PHI[q][a]) * c.wv[a][i];
    if (i < 3) u[i] = s; else p = s;
  }
}

// ---- the pointwise fluxes (forms/soa.py) ----------------------------------

// f : R^16 -> R^16 over S (T, or Dual<T> for a derivative); state and
// flux ids: 0..2 u_i, 3 + 3i + j du_i/dx_j, 12 p, 13..15 dp/dx_j
template <int FLUX, typename T, typename S>
__device__ __forceinline__ void flux_fn(const CellConst<T>& k,
                                        const S s[16], S f[16]) {
  const S* u = s;
  const S* gp = s + 13;
  S p = s[12];
  auto Gu = [&](int i, int j) { return s[3 + 3 * i + j]; };
  S adv[3], res[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    adv[i] = Gu(i, 0) * u[0] + Gu(i, 1) * u[1] + Gu(i, 2) * u[2];
  if (FLUX == FLUX_SUPS_T) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      res[j] = Gu(0, j) * u[0] + Gu(1, j) * u[1] + Gu(2, j) * u[2] + gp[j];
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) res[j] = adv[j] + gp[j];
  }
  S div = Gu(0, 0) + Gu(1, 1) + Gu(2, 2);
  S tau, tau_l;      // SUPS and LSIC coefficients
  if (FLUX == FLUX_UGN) {
    S u_sq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
    S u_norm = sqr_t(u_sq + tiny<T>());
    S inv_tau1_sq = zero_at_or_below(
        u_norm, k.u_eps, (T(4) * u_sq) / (k.h * k.h));
    T tau3 = k.h * k.h / (T(4) * k.nu);
    tau = rsq(inv_tau1_sq + T(1) / (tau3 * tau3));
    S re = (u_norm * k.h) / (T(2) * k.nu);
    S z = min_one(re / T(3));
    tau_l = ((T(0.5) * k.h) * u_norm) * z;
  } else {
    S uGu = u[0] * k.G[0][0] * u[0];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (i + j > 0) uGu = uGu + u[i] * k.G[i][j] * u[j];
    tau = rsq(uGu + k.c_i * k.nu * k.nu * k.GdG);
    tau_l = recip(k.trG * tau);
  }
  S lsic = tau_l * div - p;
#pragma unroll
  for (int i = 0; i < 3; ++i) f[i] = adv[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S stab = FLUX == FLUX_SUPS_T ? tau * u[i] * res[j]
                                   : tau * res[i] * u[j];
      S fg = k.nu * Gu(i, j) + stab;
      f[3 + 3 * i + j] = i == j ? fg + lsic : fg;
    }
  f[12] = div;
#pragma unroll
  for (int j = 0; j < 3; ++j) f[13 + j] = tau * res[j];
}

// E^T row (a, alpha) of a flux vector F: phi_a F[value] + g_a . F[grad]
template <typename T>
__device__ __forceinline__ T et_dot(T phi_a, const T g_a[3], const T F[16],
                                    int alpha) {
  int v = alpha < 3 ? alpha : 12;
  int gr = alpha < 3 ? 3 + 3 * alpha : 13;
  T out = phi_a * F[v];
  out = out + g_a[0] * F[gr];
  out = out + g_a[1] * F[gr + 1];
  out = out + g_a[2] * F[gr + 2];
  return out;
}

template <int FLUX, typename T>
__global__ void __launch_bounds__(THREADS) soa_residual_kernel(
    const T* __restrict__ coordsT, const float* __restrict__ alive,
    const long long* __restrict__ wdof, const long long* __restrict__ wolay,
    const T* __restrict__ w, T* __restrict__ out, int M3p, int nl,
    long long n2dbs, T nu, T c_i, T u_eps) {
  long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long ncell = (long long)M3p * nl;
  if (t < nl) out[ncell * 16 + t] = T(0);     // the appended zero row
  if (t >= ncell) return;
  int col = int(t / nl), l = int(t % nl);
  T* o = out + (long long)col * 16 * nl + l;
  if (__ldg(alive + t) == 0.0f) {
#pragma unroll
    for (int r = 0; r < 16; ++r) o[(long long)r * nl] = T(0);
    return;
  }
  Cell<T> c;
  load_cell<FLUX, T>(coordsT, ncell, t, col, l, wdof, wolay, w, n2dbs,
                  nu, c_i, u_eps, c);
  T r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) r[i] = T(0);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    T s[16], f[16];
    T p;
    values_at(c, q, s, p);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) s[3 + 3 * i + j] = c.Gu[i][j];
    s[12] = p;
#pragma unroll
    for (int j = 0; j < 3; ++j) s[13 + j] = c.gp[j];
    flux_fn<FLUX, T, T>(c.k, s, f);
    T wq = T(K4_WQ[q]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int alpha = 0; alpha < 4; ++alpha)
        r[a * 4 + alpha] = r[a * 4 + alpha]
            + wq * et_dot(T(K4_PHI[q][a]), c.g[a], f, alpha);
  }
  T m = T(__ldg(alive + t));
#pragma unroll
  for (int i = 0; i < 16; ++i) o[(long long)i * nl] = r[i] * c.absdet * m;
}

template <int FLUX, typename T>
__global__ void __launch_bounds__(THREADS) soa_jacobian_kernel(
    const T* __restrict__ coordsT, const float* __restrict__ alive,
    const long long* __restrict__ wdof, const long long* __restrict__ wolay,
    const T* __restrict__ w, T* __restrict__ out, int M3p, int nl,
    long long n2dbs, T nu, T c_i, T u_eps) {
  long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long ncell = (long long)M3p * nl;
  if (t >= ncell * 16) return;
  long long per_col = 16LL * nl;
  int col = int(t / per_col);
  int rem = int(t - col * per_col);
  int cb = rem / nl, l = rem - cb * nl;       // column b*4 + beta, layer
  long long cell = (long long)col * nl + l;
  // entry row (a*4 + alpha) * 16 + cb of the column's 256: the thread's
  // 16 stores step by 16 rows
  T* o = out + (long long)col * 256 * nl + rem;
  if (__ldg(alive + cell) == 0.0f) {
#pragma unroll
    for (int r = 0; r < 16; ++r) o[(long long)r * per_col] = T(0);
    return;
  }
  Cell<T> c;
  load_cell<FLUX, T>(coordsT, ncell, cell, col, l, wdof, wolay, w,
                  n2dbs, nu, c_i, u_eps, c);
  int b = cb >> 2, beta = cb & 3;
  int vslot = beta < 3 ? beta : 12;           // the tangent's value slot
  int gslot = beta < 3 ? 3 + 3 * beta : 13;   // and its gradient slots
  // g[b] by selection: an index into the cell would put it in local memory
  T gb[3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (a == b) gb[j] = c.g[a][j];
  T acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = T(0);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    T u[3], p;
    values_at(c, q, u, p);
    Dual<T> s[16];
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i] = {u[i], T(0)};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) s[3 + 3 * i + j] = {c.Gu[i][j], T(0)};
    s[12] = {p, T(0)};
#pragma unroll
    for (int j = 0; j < 3; ++j) s[13 + j] = {c.gp[j], T(0)};
    // the tangent E_q e_(b, beta)
    T phi_b = T(K4_PHI[q][b]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i == vslot) s[i].d = phi_b;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (i == gslot + j) s[i].d = gb[j];
    }
    Dual<T> f[16];
    flux_fn<FLUX, T, Dual<T>>(c.k, s, f);
    T D[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) D[i] = f[i].d;
    T wq = T(K4_WQ[q]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int alpha = 0; alpha < 4; ++alpha)
        acc[a * 4 + alpha] = acc[a * 4 + alpha]
            + wq * et_dot(T(K4_PHI[q][a]), c.g[a], D, alpha);
  }
  T m = T(__ldg(alive + cell));
#pragma unroll
  for (int r = 0; r < 16; ++r)
    o[(long long)r * per_col] = acc[r] * c.absdet * m;
}

template <typename T>
cudaError_t launch(int entry, int flux, const void* coordsT,
                   const float* alive, const long long* wdof,
                   const long long* wolay, const void* w, void* out,
                   int M3p, int nl, long long n2dbs, double nu, double c_i,
                   double u_eps, cudaStream_t stream) {
  long long n = (long long)M3p * nl * (entry == 0 ? 16 : 1);
  if (entry != 0) n = n > nl ? n : nl;        // the zero row
  unsigned blocks = unsigned((n + THREADS - 1) / THREADS);
  const T* cT = static_cast<const T*>(coordsT);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
#define K4_ARGS cT, alive, wdof, wolay, wt, o, M3p, nl, n2dbs, T(nu), \
    T(c_i), T(u_eps)
#define K4_CASE(F)                                                     \
  case F:                                                              \
    if (entry == 0)                                                    \
      soa_jacobian_kernel<F, T><<<blocks, THREADS, 0, stream>>>(    \
          K4_ARGS);                                                    \
    else                                                               \
      soa_residual_kernel<F, T><<<blocks, THREADS, 0, stream>>>(    \
          K4_ARGS);                                                    \
    break;
  switch (flux) {
    K4_CASE(FLUX_SUPS_T)
    K4_CASE(FLUX_SUPS)
    K4_CASE(FLUX_UGN)
    default:
      return cudaErrorInvalidValue;
  }
#undef K4_CASE
#undef K4_ARGS
  return cudaGetLastError();
}

}  // namespace

// entry: 0 the Jacobian into buf (M3p * 256, nl), 1 the residual into
// rbuf (M3p * 16 + 1, nl); dtype: 0 double, 1 float (w, the coordinates
// and the output alike); flux: FLUX_SUPS_T, FLUX_SUPS or FLUX_UGN.
// coordsT (12, M3p * nl), alive (M3p * nl,) float, wdof and wolay
// (M3p, 16) int64, w (Lp * n2dbs,).  nu, c_i and u_eps are rounded to
// the dtype (c_i is read by SUPS, u_eps by UGN).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int soa_element(int entry, int dtype, int flux,
                           const void* coordsT, const float* alive,
                           const long long* wdof, const long long* wolay,
                           const void* w, void* out, int M3p, int nl,
                           long long n2dbs, double nu, double c_i,
                           double u_eps, cudaStream_t stream) {
  if (M3p <= 0 || nl <= 0 || (entry != 0 && entry != 1)) {
    return int(cudaErrorInvalidValue);
  }
  if (dtype == 0)
    return int(launch<double>(entry, flux, coordsT, alive, wdof, wolay, w,
                              out, M3p, nl, n2dbs, nu, c_i, u_eps, stream));
  if (dtype == 1)
    return int(launch<float>(entry, flux, coordsT, alive, wdof, wolay, w,
                             out, M3p, nl, n2dbs, nu, c_i, u_eps, stream));
  return int(cudaErrorInvalidValue);
}
