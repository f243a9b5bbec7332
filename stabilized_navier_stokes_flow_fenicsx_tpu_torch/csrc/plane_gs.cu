// K2: the plane Gauss-Seidel sweep of the layered operator, written by
// hand for Hopper (sm_90a); both sweep directions in one launch of one
// thread-block cluster.
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
// downstream x_l instead of Dinv_l rhs.  The pairs e are sorted by row.
//
// Layout (built once per values tensor by the wrapper, solve/plane_gs.py):
// values (3, Lp, E, 4, 4), slice 0 = Vm (couples x_{l-1}), 1 = V0, 2 = Vp;
// Dinv (Lp, n2d, 4, 4) in the value type; the mask (Lp, n2d, 4) in the
// iterate's.  The wrapper's plan cuts the 2D rows into `cluster`
// contiguous ranges balanced by pairs, one per block, and codes each
// pair's column as (owner block, row within the owner): colcode = owner |
// local_row << 4.  So a block's slice of any plane's values, inverses,
// mask and r is one contiguous range of device memory.
//
// What bounds it.  The sweep is a chain of 2 * Lp * (1 + inner_sweeps)
// dependent stages (462 at level 0 of the lc=0.04 channel); each reads
// the previous stage's iterate of neighbouring rows.  The device-memory
// bytes (the byte bound) are far below what the chain costs: the time is
// the stage count times one stage's latency, its barrier plus the loads
// and the 4x4 inverse between two barriers.  The design keeps every one
// of those loads on chip:
//
// - One cluster of `cluster` blocks (up to 16, on neighbouring SMs) runs
//   the whole sweep; the stage barrier is cluster.sync() (barrier.cluster
//   arrive.release / wait.acquire).
// - The iterate lives in shared memory: each block holds its rows of the
//   previous plane's x, of the current x in two buffers (the Jacobi
//   passes' source and destination, swapped), of m * x (what the passes'
//   product reads) and of the rhs.  A column another block owns is read
//   from that block's shared memory (distributed shared memory,
//   cluster.map_shared_rank).  Only each plane's finished x goes to
//   device memory, one stage later (so that the stores do not hold up
//   the barrier's release); the upstream sweep reads back its block's own
//   rows, loaded a plane ahead.
// - No value, inverse, mask or r depends on the iterate, so the stream is
//   fetched ahead by bulk asynchronous copies (cp.async.bulk, completing
//   on an mbarrier), issued by one thread: the block's inverses, mask
//   and r one plane ahead in a 2-slot ring, and its value slices (the
//   coupling slice, then V0) in a ring of `slots` (2-4) slices, each
//   issued as soon as the slice `slots` - 1 earlier is released.  V0 and
//   the inverses are then read from device memory once per plane and
//   direction.  Where the ring does not fit the 227 KB a block may take
//   (`slots` = 0), the value slices are read from device memory instead,
//   prefetched into L2 one plane ahead (cp.async.bulk.prefetch.L2).
// - A stage gives each (row, component) `split` (1, 2 or 4) threads that
//   share the row's pairs and add their sums by warp shuffles; the four
//   components of a row are in one warp, so the 4x4 block inverse
//   gathers them by shuffles too.
//
// Types: values and inverses VT in double, float or bf16; the iterate,
// rhs, mask and every sum in AT = double for double values, else float.
// The JAX package rounds its whole bf16 sweep to bf16 (iterate included);
// this kernel keeps the float32 iterate, so the two agree only to bf16
// accuracy while the kernel and its plain version agree to float32's.
//
// Interface: plain C, loaded with ctypes.  plane_gs() launches onto the
// caller's stream, allocates nothing and returns the launch's error
// (cudaLaunchKernelEx, then cudaGetLastError()); a cluster that cannot be
// scheduled is refused there.  plane_gs_max_clusters() is the occupancy
// query the wrapper asks before it takes a plan; plane_gs_barrier_chain()
// launches the same cluster running only the stage barriers (a
// measurement of the chain's floor, not part of the sweep).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// The prepared operand and its plan, fixed per values tensor.
struct Params {
  const void* vals;          // (3, Lp, E, 4, 4) in the value type
  const void* dinv;          // (Lp, n2d, 4, 4) in the value type
  const void* mask;          // (Lp, n2d, 4) in the iterate type
  const int32_t* blocks;     // (cluster, 4): row0, row1, pair0, pair1
  const int32_t* row_ptr;    // (n2d + 1,) pairs of row i
  const int32_t* colcode;    // (E,) owner block | row within it << 4
  int vtype;                 // 0 = double, 1 = float, 2 = bf16
  int n2d, Lp, E;
  int inner_sweeps;          // >= 0
  int symmetric;             // 0 or 1
  int cluster;               // blocks in the cluster, 1..16
  int split;                 // threads per (row, component): 1, 2 or 4
  int threads;               // per block, a multiple of 32, <= 512
  int max_rows, max_pairs;   // the largest block's rows and pairs
  int slots;                 // value ring depth 2..4; 0 = read from memory
};

namespace {

constexpr int BS = 4;
constexpr int MAX_THREADS = 512;
constexpr int BATCH = 4;             // pairs whose loads are issued together
constexpr int MAX_SLOTS = 4;
constexpr int MAX_CLUSTER = 16;
constexpr int SMEM_LIMIT = 232448;   // what one block may take on sm_90
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout of one block, in bytes (solve/plane_gs.py's
// smem_bytes() computes the same total to choose `slots`): the mbarriers
// (MAX_SLOTS for the value ring, 2 for the plane ring), the block's
// colcode and row pointers, six iterate buffers of 4 * max_rows (x three
// times: previous plane, source, destination; m * x twice; the rhs), the
// plane ring (2 slots of inverses, mask and r) and the value ring.
struct Layout {
  uint32_t colcode, rowptr, iter, plane, vals, plane_slot, val_slot, total;
};

__host__ __device__ inline uint32_t up16(uint32_t b) {
  return (b + 15u) & ~15u;
}

__host__ __device__ inline Layout layout(const Params& P, uint32_t vsize,
                                         uint32_t asize) {
  Layout L;
  L.colcode = (MAX_SLOTS + 2) * 8;
  L.rowptr = L.colcode + up16(4u * uint32_t(P.max_pairs));
  L.iter = L.rowptr + up16(4u * uint32_t(P.max_rows + 1));
  L.plane = L.iter + 6u * 4u * uint32_t(P.max_rows) * asize;
  L.plane_slot = uint32_t(P.max_rows) * (16u * vsize + 8u * asize);
  L.vals = L.plane + 2u * L.plane_slot;
  L.val_slot = 16u * vsize * uint32_t(P.max_pairs);
  L.total = L.vals + uint32_t(P.slots) * L.val_slot;
  return L;
}

// the dynamic shared memory of one block of the plan
inline uint32_t smem_total(const Params& P) {
  return layout(P, P.vtype == 0 ? 8 : P.vtype == 1 ? 4 : 2,
                P.vtype == 0 ? 8 : 4).total;
}

// ---- 4-vectors from shared, distributed shared or device memory ----
__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// ---- mbarriers and bulk asynchronous copies (PTX) ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(src), "r"(bytes) : "memory");
}

// sum_{e in row, e = e0 + part (mod split)} sum_j V[e, c, j] * xb[col(e), j]
// where xb is the buffer at the same offset of every block's shared
// memory and V the block's pairs of one slice.  The pairs go in batches
// of BATCH whose loads are all issued before the first is used, so the
// latencies of the distributed-shared reads overlap.
template <typename VT, typename AT>
__device__ __forceinline__ AT row_product(const VT* V, const AT* xb,
                                          const int32_t* colcode, int e0,
                                          int e1, int c, int part, int split,
                                          unsigned rank,
                                          const cg::cluster_group& cluster) {
  AT acc = AT(0);
  for (int e = e0 + part; e < e1; e += BATCH * split) {
    int32_t code[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
      code[q] = e + q * split < e1 ? colcode[e + q * split] : -1;
    AT xv[BATCH][4], v[BATCH][4];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (code[q] >= 0) {
        const unsigned owner = unsigned(code[q]) & (MAX_CLUSTER - 1);
        const AT* xl = xb + (code[q] >> 4) * BS;
        load4(owner == rank ? xl : cluster.map_shared_rank(xl, owner),
              xv[q]);
        load4(V + int64_t(e + q * split) * (BS * BS) + c * BS, v[q]);
      } else {
#pragma unroll
        for (int j = 0; j < BS; ++j) xv[q][j] = v[q][j] = AT(0);
      }
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
      acc += v[q][0] * xv[q][0] + v[q][1] * xv[q][1] + v[q][2] * xv[q][2]
             + v[q][3] * xv[q][3];
  }
  return acc;
}

// the sum over the `split` lanes of one (row, component)
template <typename AT>
__device__ __forceinline__ AT add_parts(AT acc, int split) {
  for (int o = split >> 1; o > 0; o >>= 1)
    acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

// (Dinv_i w_i)[c]: w of the row's four components from the row's lanes
// (component j at lane0 + j * split).  Every lane of the warp calls it.
template <typename VT, typename AT>
__device__ __forceinline__ AT block_inverse(const VT* Di, AT w, bool ok,
                                            int c, int split) {
  const int lane = threadIdx.x & 31;
  const int lane0 = lane - lane % (BS * split);
  AT d[4];
  if (ok) load4(Di + c * BS, d);
  AT s = AT(0);
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    const AT wj = __shfl_sync(FULL, w, lane0 + j * split);
    if (ok) s += d[j] * wj;
  }
  return s;
}

template <typename VT, typename AT>
__global__ void __launch_bounds__(MAX_THREADS)
plane_gs_kernel(const Params P, const AT* __restrict__ r, AT* __restrict__ x) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const Layout L = layout(P, sizeof(VT), sizeof(AT));
  const int row0 = P.blocks[4 * rank], row1 = P.blocks[4 * rank + 1];
  const int pair0 = P.blocks[4 * rank + 2], pair1 = P.blocks[4 * rank + 3];
  const int R = row1 - row0, NP = pair1 - pair0;
  const int n = P.n2d * BS;                        // dofs of one plane
  const int nbuf = BS * P.max_rows;                // one iterate buffer
  const int split = P.split, S = P.slots;
  const bool staged = S > 0;
  const int Lp = P.Lp, inner = P.inner_sweeps;
  const int G = (P.symmetric ? 2 : 1) * Lp;        // planes to sweep
  const int U = inner > 0 ? 2 : 1;                 // value slices a plane
  const int NU = G * U;
  const int ahead = staged ? S - 1 : U;            // slices issued ahead
  const VT* vals = static_cast<const VT*>(P.vals);
  const VT* dinv = static_cast<const VT*>(P.dinv);
  const AT* mask = static_cast<const AT*>(P.mask);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [slots] + [2]
  int32_t* colcode = reinterpret_cast<int32_t*>(smem + L.colcode);
  int32_t* rowptr = reinterpret_cast<int32_t*>(smem + L.rowptr);
  AT* iter = reinterpret_cast<AT*>(smem + L.iter);
  AT* const mx0 = iter + 3 * nbuf;                 // m * x, two buffers
  AT* const rhs = iter + 5 * nbuf;
  const uint32_t dinv_bytes = uint32_t(R) * 16u * sizeof(VT);
  const uint32_t vec_bytes = uint32_t(R) * 4u * sizeof(AT);

  auto plane_slot = [&](int k) { return smem + L.plane + k * L.plane_slot; };
  auto val_slot = [&](int k) {
    return reinterpret_cast<const VT*>(smem + L.vals + k * L.val_slot);
  };
  // plane g of the sweep: downstream g = l, upstream g = 2 Lp - 1 - l
  auto plane_of = [&](int g) { return g < Lp ? g : 2 * Lp - 1 - g; };
  // value slice v: plane v / U, its coupling slice (0) or V0 (1)
  auto slice_ptr = [&](int v) {
    const int g = v / U;
    const int d = v % U ? 1 : (g < Lp ? 0 : 2);
    return vals + ((int64_t(d) * Lp + plane_of(g)) * P.E + pair0) * 16;
  };
  // one thread issues the copies: plane g's inverses, mask and r ...
  auto issue_plane = [&](int g) {
    if (g >= G) return;
    uint64_t* bar = bars + MAX_SLOTS + (g & 1);
    mbar_expect(bar, dinv_bytes + 2u * vec_bytes);
    if (R == 0) return;
    const int64_t l = plane_of(g);
    unsigned char* dst = plane_slot(g & 1);
    bulk_copy(dst, dinv + (l * P.n2d + row0) * 16, dinv_bytes, bar);
    bulk_copy(dst + dinv_bytes, mask + l * n + row0 * BS, vec_bytes, bar);
    bulk_copy(dst + dinv_bytes + vec_bytes, r + l * n + row0 * BS,
              vec_bytes, bar);
  };
  // ... and value slice v, into the ring or (slots = 0) into L2
  auto issue_slice = [&](int v) {
    if (v >= NU) return;
    const uint32_t bytes = uint32_t(NP) * 16u * sizeof(VT);
    if (staged) {
      uint64_t* bar = bars + v % S;
      mbar_expect(bar, bytes);
      if (bytes) bulk_copy(smem + L.vals + (v % S) * L.val_slot,
                           slice_ptr(v), bytes, bar);
    } else if (bytes) {
      prefetch_l2(slice_ptr(v), bytes);
    }
  };
  // slice v, once it has arrived
  auto slice = [&](int v) {
    if (!staged) return slice_ptr(v);
    mbar_wait(bars + v % S, (v / S) & 1);
    return val_slot(v % S);
  };
  // the block's rows of plane g's finished x (in buffer b) to device
  // memory; issued one stage after the plane ends, so the stores overlap
  // that stage's work instead of holding up the release of a barrier
  auto store_plane = [&](int g, int b) {
    AT* dst = x + int64_t(plane_of(g)) * n + row0 * BS;
    const AT* src = iter + b * nbuf;
    for (int t = threadIdx.x; t < BS * R; t += blockDim.x) dst[t] = src[t];
  };

  for (int e = threadIdx.x; e < NP; e += blockDim.x)
    colcode[e] = P.colcode[pair0 + e];
  for (int i = threadIdx.x; i <= R; i += blockDim.x)
    rowptr[i] = P.row_ptr[row0 + i] - pair0;
  if (threadIdx.x == 0) {
    for (int k = 0; k < S; ++k) mbar_init(bars + k, 1);
    mbar_init(bars + MAX_SLOTS, 1);
    mbar_init(bars + MAX_SLOTS + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue_plane(0);
    for (int v = 0; v < ahead; ++v) issue_slice(v);
  }
  // every block of the cluster has started and set up its shared memory
  // before any block reads another's
  cluster.sync();

  const int items = BS * R * split;                // lanes of one stage
  int prev = 0, cur = 1, oth = 2;                  // x buffers
  AT x_down = AT(0);   // the downstream x_l of the next upstream plane
  for (int g = 0; g < G; ++g) {
    const bool down = g < Lp;
    const bool has_nb = g != 0 && g != Lp;
    const int l = plane_of(g);
    const int u = g * U;
    if (threadIdx.x == 0) {
      issue_plane(g + 1);
      issue_slice(u + ahead);
    }
    // the previous plane's x, but not the last downstream one: the
    // upstream sweep reads it from shared memory and then replaces it
    if (g != 0 && g != Lp) store_plane(g - 1, prev);
    // the upstream sweep starts plane l from the downstream x_l, stored
    // long before: this stage's first lanes load it now, a plane ahead
    const AT* xg = x + int64_t(l) * n + row0 * BS;
    const AT x_down_here = x_down;
    if (g + 1 > Lp && g + 1 < G && threadIdx.x < items)
      x_down = x[int64_t(plane_of(g + 1)) * n + row0 * BS
                 + threadIdx.x / split];
    mbar_wait(bars + MAX_SLOTS + (g & 1), (g >> 1) & 1);
    const unsigned char* ps = plane_slot(g & 1);
    const VT* Dl = reinterpret_cast<const VT*>(ps);
    const AT* ml = reinterpret_cast<const AT*>(ps + dinv_bytes);
    const AT* rl = reinterpret_cast<const AT*>(ps + dinv_bytes + vec_bytes);
    const VT* Vc = slice(u);

    // the coupling: rhs, and the relaxation's first x
    AT* xs = iter + cur * nbuf;
    const AT* xp = iter + prev * nbuf;
    for (int base = 0; base < items; base += blockDim.x) {
      const int t = base + threadIdx.x;
      const bool ok = t < items;
      const int tc = t / split, part = t % split;
      const int i = tc >> 2, c = tc & 3;
      AT acc = AT(0);
      if (ok && has_nb)
        acc = row_product<VT, AT>(Vc, xp, colcode, rowptr[i], rowptr[i + 1],
                                  c, part, split, rank, cluster);
      acc = add_parts(acc, split);
      AT m = AT(0), rh = AT(0), x0 = AT(0);
      if (ok) {
        m = ml[tc];
        const AT rr = rl[tc];
        rh = m * (rr - acc) + (AT(1) - m) * rr;
      }
      if (down)
        x0 = block_inverse<VT, AT>(Dl + (ok ? i : 0) * 16, rh, ok, c, split);
      else if (ok)                                  // the downstream x_l
        x0 = g == Lp ? xp[tc] : base == 0 ? x_down_here : xg[tc];
      if (ok && part == 0) {
        rhs[tc] = rh;
        xs[tc] = x0;
        mx0[tc] = m * x0;
      }
    }
    cluster.sync();

    // the inner Jacobi passes, from one x buffer into the other
    int src = cur, dst = oth;
    for (int k = 0; k < inner; ++k) {
      if (k == 0 && threadIdx.x == 0) issue_slice(u + 1 + ahead);
      const VT* V0 = slice(u + 1);
      const AT* xsrc = iter + src * nbuf;
      AT* xdst = iter + dst * nbuf;
      const AT* msrc = mx0 + (k & 1) * nbuf;
      AT* mdst = mx0 + ((k + 1) & 1) * nbuf;
      for (int base = 0; base < items; base += blockDim.x) {
        const int t = base + threadIdx.x;
        const bool ok = t < items;
        const int tc = t / split, part = t % split;
        const int i = tc >> 2, c = tc & 3;
        AT acc = AT(0);
        if (ok)
          acc = row_product<VT, AT>(V0, msrc, colcode, rowptr[i],
                                    rowptr[i + 1], c, part, split, rank,
                                    cluster);
        acc = add_parts(acc, split);
        AT m = AT(0), res = AT(0), xi = AT(0);
        if (ok) {
          m = ml[tc];
          const AT rh = rhs[tc];
          xi = xsrc[tc];
          res = (rh - acc) * m + (AT(1) - m) * (rh - xi);
        }
        const AT dx = block_inverse<VT, AT>(Dl + (ok ? i : 0) * 16, res, ok,
                                            c, split);
        if (ok && part == 0) {
          const AT xn = xi + dx;
          xdst[tc] = xn;
          mdst[tc] = m * xn;
        }
      }
      cluster.sync();
      const int tmp = src;
      src = dst;
      dst = tmp;
    }
    // the plane's x (in src) is the next plane's neighbour
    const int rest = src == cur ? oth : cur;
    cur = prev;
    prev = src;
    oth = rest;
  }
  store_plane(G - 1, prev);
  // the last stage's cluster.sync() above keeps every block resident
  // until every remote read of the sweep is done
}

// The stage barriers of a sweep alone, on the same cluster: the chain's
// floor, for measurement.
__global__ void __launch_bounds__(MAX_THREADS)
barrier_chain_kernel(int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int s = 0; s < stages; ++s) cluster.sync();
}

template <typename Kernel>
cudaError_t configure(Kernel kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// once per kernel instantiation and device
template <typename Kernel>
cudaError_t configure_once(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = configure(kernel);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(const Params& P, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3(P.cluster, 1, 1);
    cfg.blockDim = dim3(P.threads, 1, 1);
    cfg.dynamicSmemBytes = smem_total(P);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename VT, typename AT>
int launch(const void* r, void* x, cudaStream_t stream, const Params& P) {
  static bool done[64] = {};
  cudaError_t e = configure_once(plane_gs_kernel<VT, AT>, done);
  if (e != cudaSuccess) return int(e);
  Launch L(P, stream);
  e = cudaLaunchKernelEx(&L.cfg, plane_gs_kernel<VT, AT>, P,
                         static_cast<const AT*>(r), static_cast<AT*>(x));
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

template <typename VT, typename AT>
int max_clusters(const Params& P) {
  static bool done[64] = {};
  cudaError_t e = configure_once(plane_gs_kernel<VT, AT>, done);
  if (e != cudaSuccess) return -int(e);
  Launch L(P, nullptr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, plane_gs_kernel<VT, AT>, &L.cfg);
  return e == cudaSuccess ? count : -int(e);
}

int check(const Params* P) {
  if (P == nullptr || P->n2d <= 0 || P->Lp <= 0 || P->E <= 0
      || P->inner_sweeps < 0 || P->n2d > (1 << 26) || P->cluster < 1
      || P->cluster > MAX_CLUSTER || P->threads < 32
      || P->threads > MAX_THREADS || P->threads % 32 != 0
      || !(P->split == 1 || P->split == 2 || P->split == 4)
      || P->slots < 0 || P->slots == 1 || P->slots > MAX_SLOTS
      || P->max_rows < 0 || P->max_pairs < 0 || P->max_rows > (1 << 20)
      || P->max_pairs > (1 << 20) || P->vtype < 0
      || P->vtype > 2 || smem_total(*P) > SMEM_LIMIT)
    return int(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// One launch of K2 on `stream`: x = the sweep applied to r, both in the
// iterate type (double for double values, float for float and bf16
// values); r 16-byte aligned.  Returns the launch's cudaError, or
// cudaErrorInvalidValue for arguments it does not take (nothing is
// launched then).
extern "C" int plane_gs(const void* r, void* x, void* stream,
                        const Params* P) {
  if (const int bad = check(P)) return bad;
  if (reinterpret_cast<uintptr_t>(r) % 16 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P->vtype) {
    case 0: return launch<double, double>(r, x, s, *P);
    case 1: return launch<float, float>(r, x, s, *P);
    default: return launch<__nv_bfloat16, float>(r, x, s, *P);
  }
}

// How many clusters of the plan's shape the card can run at once (>= 1:
// schedulable), or -cudaError.
extern "C" int plane_gs_max_clusters(const Params* P) {
  if (const int bad = check(P)) return -bad;
  switch (P->vtype) {
    case 0: return max_clusters<double, double>(*P);
    case 1: return max_clusters<float, float>(*P);
    default: return max_clusters<__nv_bfloat16, float>(*P);
  }
}

// The plan's cluster running `stages` cluster barriers and nothing else.
extern "C" int plane_gs_barrier_chain(void* stream, const Params* P,
                                      int stages) {
  if (const int bad = check(P)) return bad;
  static bool done[64] = {};
  cudaError_t e = configure_once(barrier_chain_kernel, done);
  if (e != cudaSuccess) return int(e);
  Launch L(*P, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&L.cfg, barrier_chain_kernel, stages);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}
