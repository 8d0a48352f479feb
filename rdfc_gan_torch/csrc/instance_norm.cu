// Instance norm forward and its output-residual backward, for sm_90a; and
// the forward split in two (moments, apply) for a width-sharded plane.
//
// Replaces attic/norm_kernel.py:_in_fwd_kernel (instance_norm_fwd_pallas)
// and :_in_bwd_kernel (instance_norm_bwd_pallas), which compute the JAX
// package's instance norm, rdfc_gan_tpu/models/layers.py:219-281:
//
//   forward, per (b, c) plane of n = H * W values x:
//     m = sum(x) / n, m2 = sum(x * x) / n                  (one pass)
//     var = max(m2 - m * m, 0), a = rsqrt(var + eps), b = -m * a    (f32)
//     y = x * T(a) + T(b)          in x's type T, multiply and add rounded
//     af[b, c] = a                 (f32, the backward's residual)
//   backward, from dy and the forward's output y:
//     m1 = sum(dy) / n, m2 = sum(dy * y) / n                 (one pass)
//     dx = T(af) * ((dy - T(m1)) - y * T(m2))   in dy's type T
//
// The statistics m, m2, m1 are f32, as in the JAX package, but the sums
// and the division by n run in f64 and are rounded to f32 once: the JAX
// package sums in f32 in XLA's order, which no kernel can follow, and the
// f32 train step amplifies a last-bit change of these statistics far
// beyond rounding (PERF.md), so the kernels compute the value that every
// summation order approximates. The plain versions
// (ops/kernels/norm_kernel.py) repeat each kernel's order of summation and
// take a correctly rounded rsqrt, so kernel and plain agree bit for bit.
// The elementwise passes keep the multiply and the add separately rounded
// (__fmul_rn, __fadd_rn): FMA contraction would change the result.
//
// T is f32 or bf16. The TPU kernels also take ``pack``, a lane-packed
// layout of the TPU's (8, 128) tiling; the port runs NCHW and has no such
// layout, so it has no ``pack`` argument.
//
// What bounds it on an H100: bytes. The forward reads x once and writes y
// once (two operations per element for the sums, two for y), the backward
// reads dy and y once and writes dx once; both far below the ridge.
//
// Design. One rule, plan() below, cuts a plane for both directions from n,
// the element size and the number of arrays a block stages (1 for the
// forward: x; 2 for the backward: dy and y); fwd_plan and bwd_plan are its
// two uses, and the plain versions' _fwd_sum and _bwd_sum follow them:
//   * vec: the widest vector (up to 16 bytes) whose width divides n, so
//     every plane starts on a vector boundary and every access is a vector
//     (the 14x19 W-AdaIN planes take 8-byte f32 or 4-byte bf16 vectors; an
//     odd n takes scalars);
//   * cluster: a plane whose staged arrays pass kStageBytes is split over a
//     thread block cluster of 2, 4 or 8 blocks, or 16 (a size the card
//     must be asked to allow) where 8 blocks' stages cannot hold it
//     (planes past 1.6 MB of staged arrays; the forward's 136 KB bf16
//     G_B2A planes: 4 blocks of 34 KB; the backward's 272 KB of dy and y:
//     8), each staging its contiguous chunk of cvec vectors of every array
//     in shared memory; the blocks' partial sums meet through distributed
//     shared memory, added in rank order by every block, so every input is
//     read once from HBM and the output written from the stage at every
//     shape;
//   * team: the threads that share one plane (or one chunk): about kSteps
//     vectors a thread, 32 to 512 threads; planes that fit one block put
//     several teams in a block (a warp or a few a plane), so a small plane
//     pays for shuffles and a short pass over its warps, not for a
//     512-thread block reduction.
// Each thread copies its vectors v = t, t + team, ... of the chunk into
// shared memory with cp.async (all in flight at once), sums them in f64
// with one accumulator pair per vector lane (independent add chains), adds
// the lanes in order, then the warp adds by xor shuffles over 16, 8, 4, 2,
// 1 lanes, the team adds its warps in order and the cluster its ranks in
// order (plan_sum). The forward sums x and x * x, the backward dy and
// dy * y; each product of two f32 values is exact in f64, so the fused
// multiply-add equals a multiply and an add. The second pass reads the
// stage and writes whole vectors. In bf16 the backward rounds each value
// four times (dy - m1, y m2, their difference, dx) and converts dy and y
// to f64; an SM converts 16 values a clock, a quarter of its f64 add rate,
// so the conversions weigh more than the bytes: the second pass rounds two
// values a conversion (__floats2bfloat162_rn, round to nearest even as
// each single rounding).
//
// The split (a plane sharded over ranks by width, parallel/spatial.py).
// moments: the forward's sums of the rank's columns, f64 out; the ranks
// all-reduce them; apply: the forward's finalize from the added sums
// (mean_f32, fmaxf, __frsqrt_rn, -m a), the scale af, and y. Both keep
// fwd_plan's partition, its stage and moments keeps the forward's order of
// summation (plan_sum, the cluster's ranks through DSMEM), so at one rank
// the two are the forward bit for bit. Both are bound by bytes too (moments
// reads x; apply reads x and writes y), so both put a block's whole chunk
// in flight before they touch it: where the plane's vector is 16 bytes
// (every chunk then starts and ends on 16 bytes; bulk_copy) the team's first
// thread issues one TMA bulk copy of the team's chunk
// (cp.async.bulk...mbarrier::complete_tx::bytes), armed on the team's
// mbarrier with expect_tx, and the team waits on it; elsewhere (the 14x19
// and odd planes) each thread copies its vectors with cp.async, as the
// forward. apply needs no sum across blocks: a clustered plane's chunks run
// as independent blocks, each finalizing from the sums while its copy is in
// flight, the plane and the chunk from blockIdx (no division a vector), and
// y leaves as whole vectors from registers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// the plan (norm_kernel.py:_plan repeats these numbers)
constexpr int kStageBytes = 40 * 1024;  // a block's share of a plane
constexpr int kMaxStageBytes = 200 * 1024;
constexpr int kMaxCluster = 8;  // the portable cluster size
// past it, for a plane that 8 blocks cannot stage: an H100's GPCs hold 16
// SMs or more
constexpr int kWideCluster = 16;
constexpr int kBlockThreads = 256;
constexpr int kMaxTeam = 512;
constexpr int kSteps = 8;  // vectors a thread, about

// sum / n in f64, rounded to f32
__device__ __forceinline__ float mean_f32(double sum, int n) {
  return __double2float_rn(__ddiv_rn(sum, (double)n));
}

// The kernels work on the elements' bits: bf16 <-> f32 is a shift.
__device__ __forceinline__ float bits_f32(unsigned int b) {
  return __uint_as_float(b);
}
__device__ __forceinline__ float bits_f32(unsigned short b) {
  return __uint_as_float((unsigned int)b << 16);
}
template <typename B>
__device__ __forceinline__ B f32_bits(float v);
template <>
__device__ __forceinline__ unsigned int f32_bits<unsigned int>(float v) {
  return __float_as_uint(v);
}
template <>
__device__ __forceinline__ unsigned short f32_bits<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// v rounded to the element type B and back: an f32 statistic cast to T
template <typename B>
__device__ __forceinline__ float round_to(float v) {
  return bits_f32(f32_bits<B>(v));
}

// two f32 values rounded to bf16 by one conversion (round to nearest
// even, as __float2bfloat16_rn each): their bits, the first in the low half
__device__ __forceinline__ unsigned bf16_pair_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// the pair rounded to bf16 and back to f32
__device__ __forceinline__ void round_pair(float lo, float hi,
                                           float (&out)[2]) {
  const unsigned bits = bf16_pair_bits(lo, hi);
  out[0] = __uint_as_float(bits << 16);
  out[1] = __uint_as_float(bits & 0xffff0000u);
}

// VEC elements of bits B, loaded and stored as one access
template <typename B, int VEC>
struct alignas(sizeof(B) * VEC) Pack {
  B e[VEC];
};

// global -> shared copy of one Pack: cp.async for 4, 8 and 16 bytes
template <int VB>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (VB == 2) {
    *static_cast<unsigned short*>(dst) =
        __ldg(static_cast<const unsigned short*>(src));
  } else {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (VB == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                   "l"(src), "n"(VB));
  }
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Plan {
  int vec;      // elements a vector
  int cluster;  // blocks a plane
  int cvec;     // vectors a block's chunk
  int team;     // threads a plane (a chunk)
  int teams;    // planes a block
};

// The one rule for the partition of a plane of n elements of size bytes, of
// which a block stages `arrays` arrays; norm_kernel.py:_plan is its mirror,
// and the order of the sums follows from it.
Plan plan(int n, int size, int arrays) {
  Plan p;
  p.vec = 16 / size;
  while (n % p.vec) p.vec >>= 1;
  const long long bytes = (long long)n * size * arrays;
  p.cluster = 1;
  while (p.cluster < kMaxCluster &&
         bytes > (long long)p.cluster * kStageBytes)
    p.cluster <<= 1;
  const int nvec = n / p.vec;
  p.cvec = (nvec + p.cluster - 1) / p.cluster;
  if ((long long)arrays * p.cvec * p.vec * size > kMaxStageBytes &&
      p.cluster == kMaxCluster) {
    p.cluster = kWideCluster;
    p.cvec = (nvec + p.cluster - 1) / p.cluster;
  }
  p.team = 32;
  while (p.team < kMaxTeam && 2 * p.team * kSteps <= p.cvec) p.team <<= 1;
  p.teams = p.cluster > 1 ? 1 : kBlockThreads / p.team;
  if (p.teams < 1) p.teams = 1;
  return p;
}

Plan fwd_plan(int n, int size) { return plan(n, size, 1); }
Plan bwd_plan(int n, int size) { return plan(n, size, 2); }

// Where a thread of a planned launch works: its team (plane of the block),
// its index in the team, its cluster rank and plane, and its run of
// vectors [v0, v0 + nv) of the plane.
struct Place {
  int teams, tm, t, rank, plane, v0, nv;
  bool live;
  long long base;  // the plane's first element
};

template <int VEC>
__device__ __forceinline__ Place place(int planes, int n, int cluster,
                                       int cvec, int team) {
  Place q;
  q.teams = blockDim.x / team;
  q.tm = threadIdx.x / team;
  q.t = threadIdx.x - q.tm * team;
  q.rank = cluster > 1 ? (int)(blockIdx.x % cluster) : 0;
  q.plane = (int)(blockIdx.x / cluster) * q.teams + q.tm;
  q.live = q.plane < planes;
  q.v0 = q.rank * cvec;
  q.nv = q.live ? n / VEC - q.v0 : 0;
  if (q.nv > cvec) q.nv = cvec;
  q.base = (long long)(q.live ? q.plane : 0) * n;
  return q;
}

// The lane accumulators (a1, a2) of every thread of a team summed in the
// plan's order: lanes in order, the warp's xor tree over 16, 8, 4, 2, 1
// lanes, the team's warps in order, the cluster's ranks in order. Every
// thread of the team gets the pair. Every thread of the block must call it
// (it holds block and cluster barriers). red holds
// 2 * teams * (team / 32) + 4 doubles.
template <int VEC>
__device__ __forceinline__ double2 plan_sum(const double (&a1)[VEC],
                                            const double (&a2)[VEC],
                                            const Place& q, int team,
                                            int cluster, double* red) {
  double s1 = a1[0], s2 = a2[0];
#pragma unroll
  for (int l = 1; l < VEC; ++l) {
    s1 = __dadd_rn(s1, a1[l]);
    s2 = __dadd_rn(s2, a2[l]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    s1 = __dadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
    s2 = __dadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
  }
  // [teams][team / 32] warp sums, then the rank's partial and the total
  const int wpt = team >> 5;
  double* part = red + 2 * q.teams * wpt;
  double* total = part + 2;
  if ((q.t & 31) == 0) {
    red[2 * (q.tm * wpt + (q.t >> 5))] = s1;
    red[2 * (q.tm * wpt + (q.t >> 5)) + 1] = s2;
  }
  __syncthreads();
  const double* w = red + 2 * q.tm * wpt;
  s1 = w[0];
  s2 = w[1];
  for (int k = 1; k < wpt; ++k) {
    s1 = __dadd_rn(s1, w[2 * k]);
    s2 = __dadd_rn(s2, w[2 * k + 1]);
  }
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    if (threadIdx.x == 0) {
      part[0] = s1;
      part[1] = s2;
    }
    cl.sync();
    if (threadIdx.x == 0) {
      const double* p0 = cl.map_shared_rank(part, 0);
      double t1 = p0[0], t2 = p0[1];
      for (int r = 1; r < cluster; ++r) {
        const double* pr = cl.map_shared_rank(part, r);
        t1 = __dadd_rn(t1, pr[0]);
        t2 = __dadd_rn(t2, pr[1]);
      }
      total[0] = t1;
      total[1] = t2;
    }
    // no block leaves while another reads its partial; total is visible
    cl.sync();
    s1 = total[0];
    s2 = total[1];
  }
  return make_double2(s1, s2);
}

// ------------------------------------------------------------- forward --

template <typename B, int VEC>
__global__ void __launch_bounds__(kMaxTeam)
    instance_norm_fwd_kernel(const B* __restrict__ x, B* __restrict__ y,
                             float* __restrict__ af, int planes, int n,
                             float eps, int cluster, int cvec, int team,
                             size_t stage_bytes) {
  using P = Pack<B, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Place q = place<VEC>(planes, n, cluster, cvec, team);
  P* stage = reinterpret_cast<P*>(smem) + (size_t)q.tm * cvec;
  const P* src = reinterpret_cast<const P*>(x + q.base) + q.v0;
  for (int v = q.t; v < q.nv; v += team)
    copy_async<(int)sizeof(P)>(stage + v, src + v);
  copy_wait_all();  // each thread reads back only what it copied

  double a1[VEC], a2[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) a1[l] = a2[l] = 0.0;
  for (int v = q.t; v < q.nv; v += team) {
    const P p = stage[v];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const double f = (double)bits_f32(p.e[l]);
      a1[l] = __dadd_rn(a1[l], f);
      a2[l] = __fma_rn(f, f, a2[l]);
    }
  }
  const double2 s = plan_sum<VEC>(
      a1, a2, q, team, cluster,
      reinterpret_cast<double*>(smem + stage_bytes));
  if (!q.live) return;
  const float m = mean_f32(s.x, n);
  const float var = fmaxf(__fsub_rn(mean_f32(s.y, n), __fmul_rn(m, m)), 0.f);
  const float a = __frsqrt_rn(__fadd_rn(var, eps));
  const float b = -__fmul_rn(m, a);
  if (q.rank == 0 && q.t == 0) af[q.plane] = a;
  const float at = round_to<B>(a);
  const float bt = round_to<B>(b);
  P* dst = reinterpret_cast<P*>(y + q.base) + q.v0;
  for (int v = q.t; v < q.nv; v += team) {
    const P p = stage[v];
    P o;
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const float prod = round_to<B>(__fmul_rn(bits_f32(p.e[l]), at));
      o.e[l] = f32_bits<B>(__fadd_rn(prod, bt));
    }
    dst[v] = o;
  }
}

// ------------------------------------------------ forward, split in two --
//
// For a plane whose width is sharded over ranks (parallel/spatial.py): the
// forward's sums of the rank's columns (moments), then, once the ranks'
// sums are added, the forward's finalize and y (apply). Over a whole plane
// the two equal the forward bit for bit (the header says how they stage x).

// The rule for which chunks take the TMA: every chunk of a plane of n
// elements of size bytes whose vector is 16 bytes. Such a plane, and every
// chunk of it, starts and ends on 16 bytes (x itself starting on 16);
// norm_kernel.py:bulk_copy is its mirror.
bool bulk_copy(int n, int size) { return fwd_plan(n, size).vec * size == 16; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The block's `teams` mbarriers, one arrival each (the team's first
// thread, which also arms it with the chunk's bytes). Every thread of the
// block calls it.
__device__ __forceinline__ void init_bars(unsigned long long* bars,
                                          int teams) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < teams; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(bars + k)),
                   "r"(1u)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Start the copy of the team's chunk, vectors [0, nv) of src, into stage:
// the TMA's bulk copy where VB is 16 (armed and issued by the team's first
// thread), else each thread's vectors v = t, t + team, ... by copy_async.
template <int VB, typename P>
__device__ __forceinline__ void stage_issue(P* stage, const P* src,
                                            const Place& q, int team,
                                            unsigned long long* bar) {
  if constexpr (VB == 16) {
    if (q.t == 0 && q.nv > 0) {
      const unsigned bytes = (unsigned)q.nv * 16u;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar)),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(stage)),
          "l"(src), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
  } else {
    for (int v = q.t; v < q.nv; v += team) copy_async<VB>(stage + v, src + v);
  }
}

// Wait for the chunk: the whole of it (the TMA) or the thread's own
// vectors (copy_async), which are all a thread reads back.
template <int VB>
__device__ __forceinline__ void stage_wait(const Place& q,
                                           unsigned long long* bar) {
  if constexpr (VB == 16) {
    if (q.nv <= 0) return;
    const unsigned a = smem_addr(bar);
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(0u)
          : "memory");
  } else {
    copy_wait_all();
  }
}

// plan_sum's doubles for a block of `teams` teams of `team` threads
__host__ __device__ __forceinline__ int red_doubles(int teams, int team) {
  return 2 * teams * (team / 32) + 4;
}

// sums[plane] = {sum x, sum x * x} in f64, in the forward's order: its
// plan, its stage, its per-thread vectors and plan_sum (the cluster's ranks
// through distributed shared memory where the plan makes a cluster).
template <typename B, int VEC>
__global__ void __launch_bounds__(kMaxTeam)
    instance_norm_moments_kernel(const B* __restrict__ x,
                                 double* __restrict__ sums, int planes, int n,
                                 int cluster, int cvec, int team,
                                 size_t stage_bytes) {
  using P = Pack<B, VEC>;
  constexpr int VB = (int)sizeof(P);
  extern __shared__ __align__(16) unsigned char smem[];
  const Place q = place<VEC>(planes, n, cluster, cvec, team);
  double* red = reinterpret_cast<double*>(smem + stage_bytes);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
                                red + red_doubles(q.teams, team)) + q.tm;
  if constexpr (VB == 16) init_bars(bar - q.tm, q.teams);
  P* stage = reinterpret_cast<P*>(smem) + (size_t)q.tm * cvec;
  stage_issue<VB>(stage, reinterpret_cast<const P*>(x + q.base) + q.v0, q,
                  team, bar);
  stage_wait<VB>(q, bar);

  double a1[VEC], a2[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) a1[l] = a2[l] = 0.0;
  for (int v = q.t; v < q.nv; v += team) {
    const P p = stage[v];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const double f = (double)bits_f32(p.e[l]);
      a1[l] = __dadd_rn(a1[l], f);
      a2[l] = __fma_rn(f, f, a2[l]);
    }
  }
  const double2 s = plan_sum<VEC>(a1, a2, q, team, cluster, red);
  if (!q.live || q.rank != 0 || q.t != 0) return;
  sums[2 * (long long)q.plane] = s.x;
  sums[2 * (long long)q.plane + 1] = s.y;
}

// From the ranks' added sums over planes of total elements: the forward's
// finalize (a, b), af[plane] = a from the chunk that holds the plane's
// first vector, and y = x * T(a) + T(b) in T, the forward's rounding. The
// plan's chunks are independent blocks here (no sum crosses them), each
// staging its chunk and finalizing while the copy is in flight.
template <typename B, int VEC>
__global__ void __launch_bounds__(kMaxTeam)
    instance_norm_apply_kernel(const B* __restrict__ x,
                               const double* __restrict__ sums,
                               B* __restrict__ y, float* __restrict__ af,
                               int planes, int n, int total, float eps,
                               int cluster, int cvec, int team,
                               size_t stage_bytes) {
  using P = Pack<B, VEC>;
  constexpr int VB = (int)sizeof(P);
  extern __shared__ __align__(16) unsigned char smem[];
  const Place q = place<VEC>(planes, n, cluster, cvec, team);
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(smem + stage_bytes) + q.tm;
  if constexpr (VB == 16) init_bars(bar - q.tm, q.teams);
  if (!q.live) return;
  P* stage = reinterpret_cast<P*>(smem) + (size_t)q.tm * cvec;
  stage_issue<VB>(stage, reinterpret_cast<const P*>(x + q.base) + q.v0, q,
                  team, bar);
  const float m = mean_f32(sums[2 * (long long)q.plane], total);
  const float var = fmaxf(
      __fsub_rn(mean_f32(sums[2 * (long long)q.plane + 1], total),
                __fmul_rn(m, m)),
      0.f);
  const float a = __frsqrt_rn(__fadd_rn(var, eps));
  const float b = -__fmul_rn(m, a);
  if (q.rank == 0 && q.t == 0) af[q.plane] = a;
  const float at = round_to<B>(a);
  const float bt = round_to<B>(b);
  stage_wait<VB>(q, bar);
  P* dst = reinterpret_cast<P*>(y + q.base) + q.v0;
  for (int v = q.t; v < q.nv; v += team) {
    const P p = stage[v];
    P o;
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const float prod = round_to<B>(__fmul_rn(bits_f32(p.e[l]), at));
      o.e[l] = f32_bits<B>(__fadd_rn(prod, bt));
    }
    dst[v] = o;
  }
}

// ------------------------------------------------------------ backward --

// dx = T(a) ((dy - T(m1)) - y T(m2)) in T, each step rounded to T, from
// dy and y staged side by side: [teams][cvec] vectors of dy, then of y.
template <typename B, int VEC>
__global__ void __launch_bounds__(kMaxTeam)
    instance_norm_bwd_kernel(const B* __restrict__ dy, const B* __restrict__ y,
                             const float* __restrict__ af, B* __restrict__ dx,
                             int planes, int n, int cluster, int cvec,
                             int team, size_t stage_bytes) {
  using P = Pack<B, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Place q = place<VEC>(planes, n, cluster, cvec, team);
  P* gst = reinterpret_cast<P*>(smem) + (size_t)q.tm * cvec;
  P* yst = gst + (size_t)q.teams * cvec;
  const P* gsrc = reinterpret_cast<const P*>(dy + q.base) + q.v0;
  const P* ysrc = reinterpret_cast<const P*>(y + q.base) + q.v0;
  for (int v = q.t; v < q.nv; v += team) {
    copy_async<(int)sizeof(P)>(gst + v, gsrc + v);
    copy_async<(int)sizeof(P)>(yst + v, ysrc + v);
  }
  copy_wait_all();  // each thread reads back only what it copied

  double a1[VEC], a2[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) a1[l] = a2[l] = 0.0;
  for (int v = q.t; v < q.nv; v += team) {
    const P g = gst[v];
    const P p = yst[v];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const double f = (double)bits_f32(g.e[l]);
      a1[l] = __dadd_rn(a1[l], f);
      a2[l] = __fma_rn(f, (double)bits_f32(p.e[l]), a2[l]);
    }
  }
  const double2 s = plan_sum<VEC>(
      a1, a2, q, team, cluster,
      reinterpret_cast<double*>(smem + stage_bytes));
  if (!q.live) return;
  const float m1 = round_to<B>(mean_f32(s.x, n));
  const float m2 = round_to<B>(mean_f32(s.y, n));
  const float at = round_to<B>(af[q.plane]);
  P* dst = reinterpret_cast<P*>(dx + q.base) + q.v0;
  for (int v = q.t; v < q.nv; v += team) {
    const P g = gst[v];
    const P p = yst[v];
    P o;
    if constexpr (sizeof(B) == 2 && VEC % 2 == 0) {
      // bf16 in pairs: one conversion rounds two values
#pragma unroll
      for (int l = 0; l < VEC; l += 2) {
        float d[2], e[2], c[2];
        round_pair(__fsub_rn(bits_f32(g.e[l]), m1),
                   __fsub_rn(bits_f32(g.e[l + 1]), m1), d);
        round_pair(__fmul_rn(bits_f32(p.e[l]), m2),
                   __fmul_rn(bits_f32(p.e[l + 1]), m2), e);
        round_pair(__fsub_rn(d[0], e[0]), __fsub_rn(d[1], e[1]), c);
        const unsigned bits =
            bf16_pair_bits(__fmul_rn(at, c[0]), __fmul_rn(at, c[1]));
        o.e[l] = (unsigned short)(bits & 0xffffu);
        o.e[l + 1] = (unsigned short)(bits >> 16);
      }
    } else {
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const float d = round_to<B>(__fsub_rn(bits_f32(g.e[l]), m1));
        const float e = round_to<B>(__fmul_rn(bits_f32(p.e[l]), m2));
        const float c = round_to<B>(__fsub_rn(d, e));
        o.e[l] = f32_bits<B>(__fmul_rn(at, c));
      }
    }
    dst[v] = o;
  }
}

// ------------------------------------------------------------- launches --

// The launch of a planned kernel k whose block stages `arrays` arrays of
// [teams][cvec] vectors of VB bytes: the grid, the cluster (where
// `clusters` and the plan makes one; else a plane's chunks are independent
// blocks), the dynamic shared memory (the stage, then `tail` bytes). No
// fallback: a refused launch (too much shared memory, a cluster the card
// will not schedule) is returned to the wrapper.
template <typename K, typename... Args>
int launch_planned(K k, const Plan& p, int arrays, int vb, int planes,
                   size_t tail, bool clusters, cudaStream_t stream,
                   Args... args) {
  const size_t stage =
      ((size_t)arrays * p.teams * p.cvec * vb + 15) / 16 * 16;
  if (stage > (size_t)kMaxStageBytes) return (int)cudaErrorInvalidValue;
  const size_t smem = stage + tail;
  const bool cl = clusters && p.cluster > 1;
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != 0) return e;
  }
  if (cl && p.cluster > kMaxCluster) {
    const int e = (int)cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != 0) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster > 1 ? (unsigned)planes * p.cluster
                                   : (unsigned)((planes + p.teams - 1) /
                                                p.teams));
  cfg.blockDim = dim3(p.team * p.teams);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl ? 1 : 0;
  const int e = (int)cudaLaunchKernelEx(&cfg, k, args..., p.cluster, p.cvec,
                                        p.team, stage);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// plan_sum's doubles after the stage
size_t red_bytes(const Plan& p) {
  return (size_t)red_doubles(p.teams, p.team) * sizeof(double);
}

template <typename B, int VEC>
int launch_fwd_vec(const void* x, void* y, float* af, int planes, int n,
                   float eps, const Plan& p, cudaStream_t stream) {
  return launch_planned(instance_norm_fwd_kernel<B, VEC>, p, 1,
                        (int)sizeof(B) * VEC, planes, red_bytes(p), true,
                        stream, static_cast<const B*>(x),
                        static_cast<B*>(y), af, planes, n, eps);
}

template <typename B, int VEC>
int launch_bwd_vec(const void* dy, const void* y, const float* af, void* dx,
                   int planes, int n, const Plan& p, cudaStream_t stream) {
  return launch_planned(instance_norm_bwd_kernel<B, VEC>, p, 2,
                        (int)sizeof(B) * VEC, planes, red_bytes(p), true,
                        stream, static_cast<const B*>(dy),
                        static_cast<const B*>(y), af, static_cast<B*>(dx),
                        planes, n);
}

template <typename B>
int launch_fwd(const void* x, void* y, float* af, int planes, int n,
               float eps, cudaStream_t stream) {
  const Plan p = fwd_plan(n, (int)sizeof(B));
  switch (p.vec) {
    case 1: return launch_fwd_vec<B, 1>(x, y, af, planes, n, eps, p, stream);
    case 2: return launch_fwd_vec<B, 2>(x, y, af, planes, n, eps, p, stream);
    case 4: return launch_fwd_vec<B, 4>(x, y, af, planes, n, eps, p, stream);
  }
  if constexpr (sizeof(B) == 2)
    return launch_fwd_vec<B, 8>(x, y, af, planes, n, eps, p, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename B>
int launch_bwd(const void* dy, const void* y, const float* af, void* dx,
               int planes, int n, cudaStream_t stream) {
  const Plan p = bwd_plan(n, (int)sizeof(B));
  switch (p.vec) {
    case 1: return launch_bwd_vec<B, 1>(dy, y, af, dx, planes, n, p, stream);
    case 2: return launch_bwd_vec<B, 2>(dy, y, af, dx, planes, n, p, stream);
    case 4: return launch_bwd_vec<B, 4>(dy, y, af, dx, planes, n, p, stream);
  }
  if constexpr (sizeof(B) == 2)
    return launch_bwd_vec<B, 8>(dy, y, af, dx, planes, n, p, stream);
  return (int)cudaErrorInvalidValue;
}

// The split's launches: the forward's plan and stage; the TMA's chunks
// after the stage (and plan_sum's doubles) one mbarrier a team. A TMA copy
// needs x on 16 bytes: a tensor that is not is refused.
template <typename B, int VEC>
size_t bar_bytes(const Plan& p, const void* x, int* e) {
  if (sizeof(B) * VEC != 16) return 0;
  if ((size_t)x % 16) *e = (int)cudaErrorMisalignedAddress;
  return (size_t)p.teams * sizeof(unsigned long long);
}

template <typename B, int VEC>
int launch_moments_vec(const void* x, double* sums, int planes, int n,
                       const Plan& p, cudaStream_t stream) {
  int e = 0;
  const size_t bars = bar_bytes<B, VEC>(p, x, &e);
  if (e != 0) return e;
  return launch_planned(instance_norm_moments_kernel<B, VEC>, p, 1,
                        (int)sizeof(B) * VEC, planes, red_bytes(p) + bars,
                        true, stream, static_cast<const B*>(x), sums, planes,
                        n);
}

template <typename B>
int launch_moments(const void* x, double* sums, int planes, int n,
                   cudaStream_t stream) {
  const Plan p = fwd_plan(n, (int)sizeof(B));
  switch (p.vec) {
    case 1: return launch_moments_vec<B, 1>(x, sums, planes, n, p, stream);
    case 2: return launch_moments_vec<B, 2>(x, sums, planes, n, p, stream);
    case 4: return launch_moments_vec<B, 4>(x, sums, planes, n, p, stream);
  }
  if constexpr (sizeof(B) == 2)
    return launch_moments_vec<B, 8>(x, sums, planes, n, p, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename B, int VEC>
int launch_apply_vec(const void* x, const double* sums, void* y, float* af,
                     int planes, int n, int total, float eps, const Plan& p,
                     cudaStream_t stream) {
  int e = 0;
  const size_t bars = bar_bytes<B, VEC>(p, x, &e);
  if (e != 0) return e;
  return launch_planned(instance_norm_apply_kernel<B, VEC>, p, 1,
                        (int)sizeof(B) * VEC, planes, bars, false, stream,
                        static_cast<const B*>(x), sums, static_cast<B*>(y),
                        af, planes, n, total, eps);
}

template <typename B>
int launch_apply(const void* x, const double* sums, void* y, float* af,
                 int planes, int n, int total, float eps,
                 cudaStream_t stream) {
  if ((long long)planes * n == 0) return 0;
  const Plan p = fwd_plan(n, (int)sizeof(B));
  switch (p.vec) {
    case 1:
      return launch_apply_vec<B, 1>(x, sums, y, af, planes, n, total, eps, p,
                                    stream);
    case 2:
      return launch_apply_vec<B, 2>(x, sums, y, af, planes, n, total, eps, p,
                                    stream);
    case 4:
      return launch_apply_vec<B, 4>(x, sums, y, af, planes, n, total, eps, p,
                                    stream);
  }
  if constexpr (sizeof(B) == 2)
    return launch_apply_vec<B, 8>(x, sums, y, af, planes, n, total, eps, p,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

void put_plan(const Plan& p, int* out) {
  out[0] = p.vec;
  out[1] = p.cluster;
  out[2] = p.cvec;
  out[3] = p.team;
  out[4] = p.teams;
}

}  // namespace

// x, y: (planes, n) contiguous, x 16-byte aligned, f32 (bf16 = 0) or bf16;
// af: (planes,) f32. Returns the cudaError_t of the launch.
extern "C" int instance_norm_fwd(const void* x, void* y, void* af, int planes,
                                 int n, float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(af);
  return bf16 ? launch_fwd<unsigned short>(x, y, a, planes, n, eps, st)
              : launch_fwd<unsigned int>(x, y, a, planes, n, eps, st);
}

// x: (planes, n) contiguous, 16-byte aligned, f32 (bf16 = 0) or bf16;
// sums: (planes, 2) f64, each plane's {sum x, sum x * x} in the forward's
// order. Returns the cudaError_t of the launch.
extern "C" int instance_norm_moments(const void* x, void* sums, int planes,
                                     int n, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* s = static_cast<double*>(sums);
  return bf16 ? launch_moments<unsigned short>(x, s, planes, n, st)
              : launch_moments<unsigned int>(x, s, planes, n, st);
}

// x, y: (planes, n) contiguous, x 16-byte aligned, one type; sums:
// (planes, 2) f64, the ranks' added moments of planes of total elements;
// af: (planes,) f32. The forward's finalize, af = a, and y = x * T(a) +
// T(b) as the forward writes it. Returns the cudaError_t of the launch.
extern "C" int instance_norm_apply(const void* x, const void* sums, void* y,
                                   void* af, int planes, int n, int total,
                                   float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* s = static_cast<const double*>(sums);
  float* a = static_cast<float*>(af);
  return bf16 ? launch_apply<unsigned short>(x, s, y, a, planes, n, total,
                                             eps, st)
              : launch_apply<unsigned int>(x, s, y, a, planes, n, total, eps,
                                           st);
}

// 1 where the split's kernels copy a chunk of a plane of n elements of size
// bytes with the TMA, else 0 (norm_kernel.py checks its mirror against it
// on the card).
extern "C" int instance_norm_bulk_copy(int n, int size) {
  return bulk_copy(n, size) ? 1 : 0;
}

// The forward's and the backward's plans for a plane of n elements of size
// bytes: out = {vec, cluster, cvec, team, teams} (norm_kernel.py checks its
// mirror against them on the card). Return 0.
extern "C" int instance_norm_fwd_plan(int n, int size, int* out) {
  put_plan(fwd_plan(n, size), out);
  return 0;
}

extern "C" int instance_norm_bwd_plan(int n, int size, int* out) {
  put_plan(bwd_plan(n, size), out);
  return 0;
}

// dy, y, dx: (planes, n) contiguous, one type, f32 (bf16 = 0) or bf16, dy
// and y 16-byte aligned; af: (planes,) f32. Returns the cudaError_t of the
// launch.
extern "C" int instance_norm_bwd(const void* dy, const void* y,
                                 const void* af, void* dx, int planes, int n,
                                 int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(af);
  return bf16 ? launch_bwd<unsigned short>(dy, y, a, dx, planes, n, st)
              : launch_bwd<unsigned int>(dy, y, a, dx, planes, n, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
