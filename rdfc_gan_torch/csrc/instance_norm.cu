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
// summation order approximates.
//
// T is f32 or bf16. The TPU kernels also take ``pack``, a lane-packed
// layout of the TPU's (8, 128) tiling; the port runs NCHW and has no such
// layout, so it has no ``pack`` argument.
//
// What bounds it on an H100: bytes. The forward reads x once and writes y
// once (two operations per element for the sums, two for y), the backward
// reads dy and y once and writes dx once; both far below the ridge.
//
// Design: one block per (b, c) plane, so the statistics need no second
// launch and no atomics. A thread sums its strided elements in order in
// f64, then the block reduces by warp shuffles and one pass over the warp
// sums in shared memory: a fixed order, which the plain version
// (ops/kernels/norm_kernel.py:_block_sum, with the thread count of
// threads_for below) repeats, and a correctly rounded rsqrt, so the two
// agree bit for bit. The f64 adds (three an element) stay far below the
// card's f64 rate. The elementwise pass keeps the multiply and the add
// separately rounded (__fmul_rn, __fadd_rn): FMA contraction would change
// the result.
// As the TPU kernel reads its plane once, the forward stages the plane in
// shared memory while summing (at most 68 KB at the served shapes, f32
// 112x152) and writes y from there; the backward stages dy and y when both
// fit in kStageBytes, and otherwise reads them a second time, from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// staging above this leaves one block per SM; re-reading from L2 is cheaper
constexpr int kStageBytes = 112 * 1024;

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

template <typename T, bool kStage>
__global__ void instance_norm_fwd_kernel(const T* __restrict__ x,
                                         T* __restrict__ y,
                                         float* __restrict__ af, int n,
                                         float eps) {
  extern __shared__ double smem[];
  double* scratch = smem;  // 2 * 16 doubles
  T* plane = reinterpret_cast<T*>(smem + 32);
  const long long base = (long long)blockIdx.x * n;
  const T* xp = x + base;
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T v = xp[i];
    if (kStage) plane[i] = v;
    const double f = (double)to_f32(v);
    s1 = __dadd_rn(s1, f);
    s2 = __dadd_rn(s2, __dmul_rn(f, f));
  }
  const double2 s = block_sum(s1, s2, scratch);
  const float m = mean_f32(s.x, n);
  const float var = fmaxf(__fsub_rn(mean_f32(s.y, n), __fmul_rn(m, m)), 0.f);
  const float a = __frsqrt_rn(__fadd_rn(var, eps));
  const float b = -__fmul_rn(m, a);
  if (threadIdx.x == 0) af[blockIdx.x] = a;
  const float at = round_to<T>(a);
  const float bt = round_to<T>(b);
  T* yp = y + base;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float f = to_f32(kStage ? plane[i] : xp[i]);
    const T p = from_f32<T>(__fmul_rn(f, at));
    yp[i] = from_f32<T>(__fadd_rn(to_f32(p), bt));
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

// block_threads in ops/kernels/norm_kernel.py repeats this rule
int threads_for(int n) {
  if (n <= 1024) return 128;
  if (n <= 4096) return 256;
  return 512;
}

// the dynamic shared memory of a staged launch; above 48 KB the kernel must
// be allowed it first
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const void* x, void* y, float* af, int planes, int n,
               float eps, cudaStream_t stream) {
  const int threads = threads_for(n);
  const size_t scratch = 32 * sizeof(double);
  const size_t staged = scratch + (size_t)n * sizeof(T);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (staged <= (size_t)kStageBytes) {
    auto k = instance_norm_fwd_kernel<T, true>;
    const int e = allow_smem(k, staged);
    if (e != 0) return e;
    k<<<planes, threads, staged, stream>>>(xs, ys, af, n, eps);
  } else {
    instance_norm_fwd_kernel<T, false><<<planes, threads, scratch, stream>>>(
        xs, ys, af, n, eps);
  }
  return (int)cudaGetLastError();
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

// x, y: (planes, n) contiguous, f32 (bf16 = 0) or bf16; af: (planes,) f32.
// Returns the cudaError_t of the launch.
extern "C" int instance_norm_fwd(const void* x, void* y, void* af, int planes,
                                 int n, float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(af);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, y, a, planes, n, eps, st)
              : launch_fwd<float>(x, y, a, planes, n, eps, st);
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
