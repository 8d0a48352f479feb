// Instance norm forward and its output-residual backward, for sm_90a.
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
// Forward design. fwd_plan below picks, from n and the element size alone,
// how a plane is cut; the plain version's _fwd_sum follows the same plan:
//   * vec: the widest vector (up to 16 bytes) whose width divides n, so
//     every plane starts on a vector boundary and every access is a vector
//     (the 14x19 W-AdaIN planes take 8-byte f32 or 4-byte bf16 vectors; an
//     odd n takes scalars);
//   * cluster: a plane of more than kFwdStageBytes is split over a thread
//     block cluster of 2, 4 or 8 blocks (136 KB bf16 G_B2A planes: 4 blocks
//     of 34 KB; 272 KB f32: 8), each staging its contiguous chunk of cvec
//     vectors in shared memory; the blocks' partial sums meet through
//     distributed shared memory, added in rank order by every block, so x
//     is read once from HBM and y written from the stage at every shape;
//   * team: the threads that share one plane (or one chunk): about
//     kFwdSteps vectors a thread, 32 to 512 threads; planes that fit one
//     block put several teams in a block (a warp or a few a plane), so a
//     small plane pays for shuffles and a short pass over its warps, not
//     for a 512-thread block reduction.
// Each thread copies its vectors v = t, t + team, ... of the chunk into
// shared memory with cp.async (all in flight at once), sums them in f64
// with one accumulator pair per vector lane (independent add chains), adds
// the lanes in order, then the warp adds by xor shuffles over 16, 8, 4, 2,
// 1 lanes, the team adds its warps in order and the cluster its ranks in
// order. x * x of an f32 value is exact in f64, so the fused multiply-add
// of the second sum equals a multiply and an add.
// Backward design: one block per (b, c) plane; a thread sums its strided
// elements in order in f64, then the block reduces by warp shuffles and
// one pass over the warp sums in shared memory (the order of
// norm_kernel.py:_block_sum with the thread count of threads_for); it
// stages dy and y when both fit in kStageBytes, and otherwise reads them a
// second time, from L2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// the backward's staging above this leaves one block per SM; re-reading
// from L2 is cheaper
constexpr int kStageBytes = 112 * 1024;

// the forward's plan (norm_kernel.py:fwd_plan repeats these numbers)
constexpr int kFwdStageBytes = 40 * 1024;  // a block's share of a plane
constexpr int kFwdMaxStageBytes = 200 * 1024;
constexpr int kFwdMaxCluster = 8;  // the portable cluster size
constexpr int kFwdBlockThreads = 256;
constexpr int kFwdMaxTeam = 512;
constexpr int kFwdSteps = 8;  // vectors a thread, about

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round v to T and back: the value of an f32 statistic once cast to T
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Sum of (s1, s2) over the block; every thread gets the result. scratch
// holds 2 * (blockDim.x / 32) doubles.
__device__ __forceinline__ double2 block_sum(double s1, double s2,
                                             double* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    scratch[warp] = s1;
    scratch[nwarps + warp] = s2;
  }
  __syncthreads();
  double t1 = 0.0, t2 = 0.0;
  for (int i = 0; i < nwarps; ++i) {
    t1 += scratch[i];
    t2 += scratch[nwarps + i];
  }
  return make_double2(t1, t2);
}

// sum / n in f64, rounded to f32
__device__ __forceinline__ float mean_f32(double sum, int n) {
  return __double2float_rn(__ddiv_rn(sum, (double)n));
}

// ------------------------------------------------------------- forward --

// The forward works on the elements' bits: bf16 <-> f32 is a shift.
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

struct FwdPlan {
  int vec;      // elements a vector
  int cluster;  // blocks a plane
  int cvec;     // vectors a block's chunk
  int team;     // threads a plane (a chunk)
  int teams;    // planes a block
};

// The one rule for the forward's partition; norm_kernel.py:fwd_plan is its
// mirror, and the order of the sums follows from it.
FwdPlan fwd_plan(int n, int size) {
  FwdPlan p;
  p.vec = 16 / size;
  while (n % p.vec) p.vec >>= 1;
  const long long bytes = (long long)n * size;
  p.cluster = 1;
  while (p.cluster < kFwdMaxCluster &&
         bytes > (long long)p.cluster * kFwdStageBytes)
    p.cluster <<= 1;
  const int nvec = n / p.vec;
  p.cvec = (nvec + p.cluster - 1) / p.cluster;
  p.team = 32;
  while (p.team < kFwdMaxTeam && 2 * p.team * kFwdSteps <= p.cvec)
    p.team <<= 1;
  p.teams = p.cluster > 1 ? 1 : kFwdBlockThreads / p.team;
  if (p.teams < 1) p.teams = 1;
  return p;
}

template <typename B, int VEC>
__global__ void __launch_bounds__(kFwdMaxTeam)
    instance_norm_fwd_kernel(const B* __restrict__ x, B* __restrict__ y,
                             float* __restrict__ af, int planes, int n,
                             int cluster, int cvec, int team,
                             size_t stage_bytes, float eps) {
  using P = Pack<B, VEC>;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int teams = blockDim.x / team;
  const int tm = threadIdx.x / team;
  const int t = threadIdx.x - tm * team;
  const int rank = cluster > 1 ? (int)(blockIdx.x % cluster) : 0;
  const int plane = (int)(blockIdx.x / cluster) * teams + tm;
  const bool live = plane < planes;
  const int v0 = rank * cvec;
  int nv = live ? n / VEC - v0 : 0;
  if (nv > cvec) nv = cvec;
  const long long base = (long long)(live ? plane : 0) * n;
  P* stage = reinterpret_cast<P*>(fwd_smem) + (size_t)tm * cvec;
  const P* src = reinterpret_cast<const P*>(x + base) + v0;
  for (int v = t; v < nv; v += team)
    copy_async<(int)sizeof(P)>(stage + v, src + v);
  copy_wait_all();  // each thread reads back only what it copied

  double a1[VEC], a2[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) a1[l] = a2[l] = 0.0;
  for (int v = t; v < nv; v += team) {
    const P p = stage[v];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const double f = (double)bits_f32(p.e[l]);
      a1[l] = __dadd_rn(a1[l], f);
      a2[l] = __fma_rn(f, f, a2[l]);
    }
  }
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
  double* wsum = reinterpret_cast<double*>(fwd_smem + stage_bytes);
  double* part = wsum + 2 * teams * wpt;
  double* total = part + 2;
  if ((t & 31) == 0) {
    wsum[2 * (tm * wpt + (t >> 5))] = s1;
    wsum[2 * (tm * wpt + (t >> 5)) + 1] = s2;
  }
  __syncthreads();
  const double* w = wsum + 2 * tm * wpt;
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
  if (!live) return;
  const float m = mean_f32(s1, n);
  const float var = fmaxf(__fsub_rn(mean_f32(s2, n), __fmul_rn(m, m)), 0.f);
  const float a = __frsqrt_rn(__fadd_rn(var, eps));
  const float b = -__fmul_rn(m, a);
  if (rank == 0 && t == 0) af[plane] = a;
  const float at = bits_f32(f32_bits<B>(a));
  const float bt = bits_f32(f32_bits<B>(b));
  P* dst = reinterpret_cast<P*>(y + base) + v0;
  for (int v = t; v < nv; v += team) {
    const P p = stage[v];
    P q;
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const float prod =
          bits_f32(f32_bits<B>(__fmul_rn(bits_f32(p.e[l]), at)));
      q.e[l] = f32_bits<B>(__fadd_rn(prod, bt));
    }
    dst[v] = q;
  }
}

template <typename T, bool kStage>
__global__ void instance_norm_bwd_kernel(const T* __restrict__ dy,
                                         const T* __restrict__ y,
                                         const float* __restrict__ af,
                                         T* __restrict__ dx, int n) {
  extern __shared__ double smem[];
  double* scratch = smem;
  T* gplane = reinterpret_cast<T*>(smem + 32);
  T* yplane = gplane + n;
  const long long base = (long long)blockIdx.x * n;
  const T* gp = dy + base;
  const T* yp = y + base;
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T g = gp[i];
    const T v = yp[i];
    if (kStage) {
      gplane[i] = g;
      yplane[i] = v;
    }
    const double gf = (double)to_f32(g);
    s1 = __dadd_rn(s1, gf);
    s2 = __dadd_rn(s2, __dmul_rn(gf, (double)to_f32(v)));
  }
  const double2 s = block_sum(s1, s2, scratch);
  const float m1 = round_to<T>(mean_f32(s.x, n));
  const float m2 = round_to<T>(mean_f32(s.y, n));
  const float at = round_to<T>(af[blockIdx.x]);
  T* dp = dx + base;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float gf = to_f32(kStage ? gplane[i] : gp[i]);
    const float vf = to_f32(kStage ? yplane[i] : yp[i]);
    const float d = round_to<T>(__fsub_rn(gf, m1));
    const float e = round_to<T>(__fmul_rn(vf, m2));
    const float c = round_to<T>(__fsub_rn(d, e));
    dp[i] = from_f32<T>(__fmul_rn(at, c));
  }
}

// the backward's block; bwd_block_threads in ops/kernels/norm_kernel.py
// repeats this rule
int threads_for(int n) {
  if (n <= 1024) return 128;
  if (n <= 4096) return 256;
  return 512;
}

// the dynamic shared memory of a launch; above 48 KB the kernel must be
// allowed it first
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename B, int VEC>
int launch_fwd_vec(const void* x, void* y, float* af, int planes, int n,
                   float eps, const FwdPlan& p, cudaStream_t stream) {
  auto k = instance_norm_fwd_kernel<B, VEC>;
  const size_t stage =
      ((size_t)p.teams * p.cvec * VEC * sizeof(B) + 15) / 16 * 16;
  if (stage > (size_t)kFwdMaxStageBytes) return (int)cudaErrorInvalidValue;
  const size_t smem =
      stage + (2 * (size_t)p.teams * (p.team / 32) + 4) * sizeof(double);
  int e = allow_smem(k, smem);
  if (e != 0) return e;
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
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  // no fallback: a refused cluster launch is returned to the wrapper
  e = (int)cudaLaunchKernelEx(&cfg, k, static_cast<const B*>(x),
                              static_cast<B*>(y), af, planes, n, p.cluster,
                              p.cvec, p.team, stage, eps);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

template <typename B>
int launch_fwd(const void* x, void* y, float* af, int planes, int n,
               float eps, cudaStream_t stream) {
  const FwdPlan p = fwd_plan(n, (int)sizeof(B));
  switch (p.vec) {
    case 1: return launch_fwd_vec<B, 1>(x, y, af, planes, n, eps, p, stream);
    case 2: return launch_fwd_vec<B, 2>(x, y, af, planes, n, eps, p, stream);
    case 4: return launch_fwd_vec<B, 4>(x, y, af, planes, n, eps, p, stream);
  }
  if constexpr (sizeof(B) == 2)
    return launch_fwd_vec<B, 8>(x, y, af, planes, n, eps, p, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_bwd(const void* dy, const void* y, const float* af, void* dx,
               int planes, int n, cudaStream_t stream) {
  const int threads = threads_for(n);
  const size_t scratch = 32 * sizeof(double);
  const size_t staged = scratch + 2 * (size_t)n * sizeof(T);
  const T* g = static_cast<const T*>(dy);
  const T* v = static_cast<const T*>(y);
  T* d = static_cast<T*>(dx);
  if (staged <= (size_t)kStageBytes) {
    auto k = instance_norm_bwd_kernel<T, true>;
    const int e = allow_smem(k, staged);
    if (e != 0) return e;
    k<<<planes, threads, staged, stream>>>(g, v, af, d, n);
  } else {
    instance_norm_bwd_kernel<T, false><<<planes, threads, scratch, stream>>>(
        g, v, af, d, n);
  }
  return (int)cudaGetLastError();
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

// The forward's plan for a plane of n elements of size bytes:
// out = {vec, cluster, cvec, team, teams} (norm_kernel.py checks its
// mirror against it on the card). Returns 0.
extern "C" int instance_norm_fwd_plan(int n, int size, int* out) {
  const FwdPlan p = fwd_plan(n, size);
  out[0] = p.vec;
  out[1] = p.cluster;
  out[2] = p.cvec;
  out[3] = p.team;
  out[4] = p.teams;
  return 0;
}

// dy, y, dx: (planes, n) contiguous, one type, f32 (bf16 = 0) or bf16;
// af: (planes,) f32. Returns the cudaError_t of the launch.
extern "C" int instance_norm_bwd(const void* dy, const void* y,
                                 const void* af, void* dx, int planes, int n,
                                 int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(af);
  return bf16 ? launch_bwd<__nv_bfloat16>(dy, y, a, dx, planes, n, st)
              : launch_bwd<float>(dy, y, a, dx, planes, n, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
