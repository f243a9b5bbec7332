// K3: the streamtrace's RK45, one launch per direction, written by hand
// for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package traces with jnp code
// (stabilized_navier_stokes_flow_fenicsx_tpu/trace/streamtrace.py::
// trace_segment, a while_loop under vmap), not with Pallas.  K3 was
// added because the port's torch-op version of that loop (its twin,
// trace/streamtrace.py::trace_segment driven by the compacted
// trace_particles) issues some 750 small launches per masked RK
// iteration, so the card sat idle through nearly all of the trace.
//
// What it computes, per seed (a lane, one thread): the FSAL
// Dormand-Prince RK45 integration of trace_segment, from the seed at
// t = 0 with dt = max_step, looping while (!done && steps < max_steps):
//   * h = min(dt, t_max - t); six velocity evaluations (stage 0 is the
//     carried f(x), evaluated once at the seed); x5, x4 and the RMS error
//     over the three components, scale = atol + rtol * max(|x|, |x5|);
//   * the speed stop on the carried v (|v| < speed_eps);
//   * the plane event: g = (x[0] - x_stop) * direction, a hit when g goes
//     from < 0 to >= 0 on an accepted step; 16 bisection steps on the
//     power form of the FSAL Hermite cubic, then the Hermite endpoint;
//   * t, dt (factor 0.9 err^-0.2 clamped to [0.2, 5], step clamped to
//     [1e-6, max_step]) and done updated as the twin does.
// Each lane writes its endpoint, its step count (int64) and its done
// flag once, in seed order.  The tableau, the bisection count, the
// step controller's constants and the locator's tolerance come from the
// wrapper (Params), which reads them from trace/streamtrace.py and
// fem/interpolate.py, the twin's own sources.
//
// The velocity at a point is the layered locator's
// (fem/interpolate.py::locate_device_layered) and the P1 evaluation of
// trace/streamtrace.py::_velocity: the x-layer by a binary search in the
// planes (searchsorted(right=True) - 1, clamped; the planes sit in shared
// memory), the 2D bin by truncation and clamping (_grid_bin), the first
// of the bin row's K2 triangles whose barycentrics pass -tol, then
// prism_base, then the first of the prism's three tets that passes,
// and the barycentric sum over the cell's packed nodal row times the
// direction's sign; zero outside the domain.  The arithmetic keeps the
// twin's order of operations, unfused (__dmul_rn / __dadd_rn), so that
// nvcc makes no FMAs of it.
//
// What bounds it: latency.  A launch lasts as long as its longest lane:
// its steps x 6 evaluations x a chain of four dependent loads (the bin's
// tab2 row, prism_base, the prism's geometry row, the cell's nodal row),
// each an L2 (or, for the bench problem's 140 MB of prism geometry, a
// device-memory) round trip.  The tables are read a few hundred bytes a
// load, far under the card's bandwidth.  So the design keeps every lane
// resident at once and spends no cycles on lanes that are done:
//   * one thread per lane, 128 threads a block, at most 168 registers a
//     thread (__launch_bounds__(128, 3)): the 200 x 200 reverse grid's
//     313 blocks fit on the 132 SMs at once, with the seven stages in
//     registers;
//   * a lane leaves its loop when it is done; there is no masked
//     iteration, no compaction and no host read inside the integration;
//   * the tables are read through the read-only path (__ldg), and
//     neighbouring seeds of the reverse grid are neighbouring threads, so
//     a warp's gathers land on nearby cells.
//
// Types: T is double or float for every table, the seeds and the
// endpoints; the constants are rounded to T, as the twin's Python floats
// are when they meet a tensor of T.
//
// Interface: plain C, loaded with ctypes.  The launch goes onto the
// caller's stream, allocates nothing, and returns cudaGetLastError().
// streamtrace_chase is the yardstick of the latency bound: one thread
// following a chain of dependent loads.

#include <cuda_runtime.h>

// What a launch needs besides the seeds and the outputs: the layered
// locator's tables, the packed field and the trace's parameters.
struct Params {
  const void* x_planes;        // (Lp,)
  const void* lo2;             // (2,) 2D grid origin
  const void* inv_h2;          // (2,)
  const void* tab2;            // (n_bins, K2, 7): [tri, x0(2), Tinv(4)]
  const long long* prism_base; // (nt * nl,) int64: 3 * prism or -1
  const void* prism_geom;      // (n_prisms, 36): 3 x [x0(3), Tinv(9)]
  const void* u_cell;          // (nc, 12): the cell's nodal velocities
  int Lp, nl, K2, s0, s1;      // planes, layers, candidates, 2D bins
  int n_bisect;
  long long max_steps;
  double t_max, t_end;         // t_end: t_max - 1e-12, the finish test
  double max_step, speed_eps, x_stop, direction, rtol, atol, sign, tol;
  double safety, exponent, fac_min, fac_max, dt_min;
  double a[7][7], b5[7], b4[7];
};

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 3;       // blocks an SM keeps resident
constexpr int NV = 4;               // nodes of a tet

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.minimum / torch.maximum: a NaN in either operand is the result
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
// torch.clamp: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (v cast to int64, truncating toward zero) clamped to [0, n - 1], for a
// v whose cast is out of range too (the twin's clamp after its cast)
template <typename T>
__device__ __forceinline__ long long bin_index(T v, int n) {
  if (!(v >= T(1))) return 0;
  if (v >= T(n - 1)) return n - 1;
  return static_cast<long long>(v);
}

template <typename T>
struct Field {
  const T* xp;                 // the planes, in shared memory
  const T* tab2;
  const long long* prism_base;
  const T* geom;
  const T* u_cell;
  int Lp, nl, K2, s0, s1;
  T lo0, lo1, ih0, ih1, ntol, sign, x_lo, x_hi;
};

// the velocity at q: locate_device_layered + _velocity
template <typename T>
__device__ __forceinline__ void velocity(const Field<T>& F, T q0, T q1,
                                         T q2, T& v0, T& v1, T& v2) {
  v0 = v1 = v2 = T(0);
  if (!(q0 >= F.x_lo && q0 <= F.x_hi)) return;
  int lo = 0, hi = F.Lp;                 // planes <= q0
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (F.xp[mid] <= q0) lo = mid + 1; else hi = mid;
  }
  const long long lay = min(max(lo - 1, 0), F.nl - 1);
  const long long bin =
      bin_index(mul(sub(q1, F.lo0), F.ih0), F.s0) * F.s1
      + bin_index(mul(sub(q2, F.lo1), F.ih1), F.s1);
  const T* row = F.tab2 + bin * F.K2 * 7;
  long long tri = -1;
  for (int k = 0; k < F.K2; ++k) {
    const T* c = row + 7 * k;
    const T id = __ldg(c);
    const T r0 = sub(q1, __ldg(c + 1)), r1 = sub(q2, __ldg(c + 2));
    const T l1 = add(mul(__ldg(c + 3), r0), mul(__ldg(c + 4), r1));
    const T l2 = add(mul(__ldg(c + 5), r0), mul(__ldg(c + 6), r1));
    const T l0 = sub(sub(T(1), l1), l2);
    if (id >= T(0) && l0 >= F.ntol && l1 >= F.ntol && l2 >= F.ntol) {
      tri = static_cast<long long>(id);
      break;
    }
  }
  if (tri < 0) return;
  const long long base = __ldg(F.prism_base + tri * F.nl + lay);
  if (base < 0) return;
  const T* g = F.geom + (base / 3) * 36;
#pragma unroll 1
  for (int s = 0; s < 3; ++s) {
    const T* gs = g + 12 * s;
    const T r0 = sub(q0, __ldg(gs)), r1 = sub(q1, __ldg(gs + 1)),
            r2 = sub(q2, __ldg(gs + 2));
    T lam[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      lam[i] = add(add(mul(__ldg(gs + 3 + 3 * i), r0),
                       mul(__ldg(gs + 4 + 3 * i), r1)),
                   mul(__ldg(gs + 5 + 3 * i), r2));
    const T bar0 = sub(T(1), add(add(lam[0], lam[1]), lam[2]));
    if (bar0 >= F.ntol && lam[0] >= F.ntol && lam[1] >= F.ntol
        && lam[2] >= F.ntol) {
      const T b[NV] = {bar0, lam[0], lam[1], lam[2]};
      const T* u = F.u_cell + (base + s) * (NV * 3);
      T w[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        w[c] = mul(b[0], __ldg(u + c));
#pragma unroll
        for (int n = 1; n < NV; ++n)
          w[c] = add(w[c], mul(b[n], __ldg(u + 3 * n + c)));
      }
      v0 = mul(F.sign, w[0]);
      v1 = mul(F.sign, w[1]);
      v2 = mul(F.sign, w[2]);
      return;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
streamtrace_kernel(const T* __restrict__ seeds, T* __restrict__ x_out,
                   long long* __restrict__ steps_out,
                   bool* __restrict__ done_out, int n, const Params P) {
  extern __shared__ unsigned char smem_raw[];
  T* xp = reinterpret_cast<T*>(smem_raw);
  const T* xp_g = static_cast<const T*>(P.x_planes);
  for (int i = threadIdx.x; i < P.Lp; i += blockDim.x) xp[i] = xp_g[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  Field<T> F;
  F.xp = xp;
  F.tab2 = static_cast<const T*>(P.tab2);
  F.prism_base = P.prism_base;
  F.geom = static_cast<const T*>(P.prism_geom);
  F.u_cell = static_cast<const T*>(P.u_cell);
  F.Lp = P.Lp; F.nl = P.nl; F.K2 = P.K2; F.s0 = P.s0; F.s1 = P.s1;
  const T* lo2 = static_cast<const T*>(P.lo2);
  const T* ih2 = static_cast<const T*>(P.inv_h2);
  F.lo0 = __ldg(lo2); F.lo1 = __ldg(lo2 + 1);
  F.ih0 = __ldg(ih2); F.ih1 = __ldg(ih2 + 1);
  const T tol = T(P.tol);
  F.ntol = T(-P.tol);
  F.sign = T(P.sign);
  F.x_lo = sub(xp[0], tol);
  F.x_hi = add(xp[P.Lp - 1], tol);

  const T t_max = T(P.t_max), t_end = T(P.t_end);
  const T max_step = T(P.max_step), speed_eps = T(P.speed_eps);
  const T plane = T(P.x_stop), dir = T(P.direction);
  const T rtol = T(P.rtol), atol = T(P.atol);
  const T safety = T(P.safety), expo = T(P.exponent);
  const T fac_min = T(P.fac_min), fac_max = T(P.fac_max);
  const T dt_min = T(P.dt_min);

  T x[3] = {seeds[3 * lane], seeds[3 * lane + 1], seeds[3 * lane + 2]};
  T v[3];
  velocity(F, x[0], x[1], x[2], v[0], v[1], v[2]);   // the FSAL carry
  T t = T(0), dt = max_step;
  bool done = false;
  long long steps = 0;
  while (!done && steps < P.max_steps) {
    const T h = tmin(dt, sub(t_max, t));
    T k[7][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) k[0][c] = v[c];
#pragma unroll
    for (int i = 1; i < 7; ++i) {
      T y[3] = {x[0], x[1], x[2]};
#pragma unroll
      for (int j = 0; j < i; ++j) {
        if (P.a[i][j] != 0.0) {
          const T ha = mul(h, T(P.a[i][j]));
#pragma unroll
          for (int c = 0; c < 3; ++c) y[c] = add(y[c], mul(ha, k[j][c]));
        }
      }
      velocity(F, y[0], y[1], y[2], k[i][0], k[i][1], k[i][2]);
    }
    T xn[3], sq = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T s5 = mul(T(P.b5[0]), k[0][c]), s4 = mul(T(P.b4[0]), k[0][c]);
#pragma unroll
      for (int j = 1; j < 7; ++j) {
        s5 = add(s5, mul(T(P.b5[j]), k[j][c]));
        s4 = add(s4, mul(T(P.b4[j]), k[j][c]));
      }
      xn[c] = add(x[c], mul(h, s5));
      const T x4 = add(x[c], mul(h, s4));
      const T scale = add(atol, mul(rtol, tmax(fabs(x[c]), fabs(xn[c]))));
      const T e = sub(xn[c], x4) / scale;
      sq = add(sq, mul(e, e));
    }
    const T err = sqrt(sq / T(3));
    const bool accept = err <= T(1);
    const bool speed_stop =
        sqrt(add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2])))
        < speed_eps;
    const T g0 = mul(sub(x[0], plane), dir);
    const T g1 = mul(sub(xn[0], plane), dir);
    const bool hit = g0 < T(0) && g1 >= T(0) && accept;
    // the event on the FSAL Hermite cubic, bisected in its power form
    const T hv0 = mul(h, v[0]), hv6 = mul(h, k[6][0]);
    const T c1 = mul(hv0, dir);
    const T c2 = mul(sub(sub(mul(T(3), sub(xn[0], x[0])), mul(T(2), hv0)),
                         hv6), dir);
    const T c3 = mul(add(add(mul(T(2), sub(x[0], xn[0])), hv0), hv6), dir);
    T lo = T(0), step = T(1);
    for (int b = 0; b < P.n_bisect; ++b) {
      step = mul(step, T(0.5));
      const T mid = add(lo, step);
      const T gm = add(mul(add(mul(add(mul(c3, mid), c2), mid), c1), mid),
                       g0);
      if (gm < T(0)) lo = mid;
    }
    const T frac = hit ? add(lo, step) : T(1);
    T x_acc[3];
    if (hit) {
      const T t2 = mul(frac, frac), t3 = mul(t2, frac);
      const T h00 = add(sub(mul(T(2), t3), mul(T(3), t2)), T(1));
      const T h10 = mul(add(sub(t3, mul(T(2), t2)), frac), h);
      const T h01 = add(mul(T(-2), t3), mul(T(3), t2));
      const T h11 = mul(sub(t3, t2), h);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        x_acc[c] = add(add(add(mul(h00, x[c]), mul(h10, v[c])),
                           mul(h01, xn[c])),
                       mul(h11, k[6][c]));
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) x_acc[c] = xn[c];
    }
    const T t_new = accept ? add(t, mul(h, frac)) : t;
    T fac = mul(safety, pow(err, expo));
    fac = clamp(fac, fac_min, fac_max);
    dt = clamp(mul(dt, fac), dt_min, max_step);
    if (accept) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[c] = x_acc[c];
        v[c] = k[6][c];
      }
    }
    t = t_new;
    done = (accept && (speed_stop || hit || t_new >= t_end)) || speed_stop;
    ++steps;
  }
  x_out[3 * lane] = x[0];
  x_out[3 * lane + 1] = x[1];
  x_out[3 * lane + 2] = x[2];
  steps_out[lane] = steps;
  done_out[lane] = done;
}

__global__ void chase_kernel(const long long* __restrict__ next,
                             long long n_loads, long long* out) {
  long long i = 0;
  for (long long k = 0; k < n_loads; ++k) i = __ldg(next + i);
  *out = i;
}

template <typename T>
int launch(const void* seeds, void* x, void* steps, void* done, int n,
           cudaStream_t s, const Params& P) {
  const size_t smem = size_t(P.Lp) * sizeof(T);
  if (smem > 49152) return int(cudaErrorInvalidValue);
  streamtrace_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, smem, s>>>(
      static_cast<const T*>(seeds), static_cast<T*>(x),
      static_cast<long long*>(steps), static_cast<bool*>(done), n, P);
  return int(cudaGetLastError());
}

}  // namespace

// One launch of K3 on `stream`: n lanes from seeds (n, 3) to x (n, 3),
// steps (n,) int64 and done (n,) bool.  dtype: 0 = double, 1 = float,
// for seeds, x and every floating table of P.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take (nothing is launched then).
extern "C" int streamtrace(const void* seeds, void* x, void* steps,
                           void* done, int n, int dtype, void* stream,
                           const Params* P) {
  if (P == nullptr || n <= 0 || P->Lp < 2 || P->nl != P->Lp - 1
      || P->K2 < 1 || P->s0 < 1 || P->s1 < 1 || P->n_bisect < 1
      || P->n_bisect > 60)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<double>(seeds, x, steps, done, n, s, *P);
  if (dtype == 1) return launch<float>(seeds, x, steps, done, n, s, *P);
  return int(cudaErrorInvalidValue);
}

// One thread loads next[next[...next[0]]], n_loads dependent loads, and
// writes the last index to out: the time of a launch over n_loads is
// the latency of one load in the chain.
extern "C" int streamtrace_chase(const void* next, long long n_loads,
                                 void* out, void* stream) {
  if (n_loads < 1) return int(cudaErrorInvalidValue);
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(next), n_loads,
      static_cast<long long*>(out));
  return int(cudaGetLastError());
}
