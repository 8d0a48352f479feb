// Fused 3x3 conv block kernels, forward and backward, for sm_90a: the f32
// case, exact.
//
// Replaces attic/conv_block_kernel.py:_fwd_kernel (fused_conv3x3_fwd) and
// :_bwd_kernel (fused_conv3x3_bwd), the two halves of the train-mode ResNet
// BasicBlock (conv3x3 -> BN -> ReLU -> conv3x3 -> BN -> + x -> ReLU) that
// attic/fused_block.py chains, for f32 tensors; bf16 tensors (the train
// steps' compute type) go to conv3x3_bf16.cu, on the tensor cores. NCHW;
// T is f32 (the code is written for a type T, instantiated for float
// only); C the input and Co the output channels; stride 1; the zero
// padding applies to the tensor after the prologue.
//
//   forward (conv3x3_fwd):
//     z = act(T(T(u * T(a)) + T(b)))     the prologue (or z = u), in T
//     y = T(sum over (ci, kh, kw) of z * w)          the conv, f64 sums
//     mom[b, 0, c] = sum y, mom[b, 1, c] = sum y * y  per (b, c), f64
//   backward (conv3x3_bwd), for one such op, from the gradient g of its
//   output y (or of the BN that follows it, with the finalize rows
//   A, C1, C2, MU, IS of that BN):
//     dy = T((A * g - C1) - ((y - MU) * IS) * C2)     (or dy = g)
//     gm = [pre-activation of the prologue > 0] * convT(dy, w)   (f32)
//     gout = T(gm + carry)
//     dW = sum over (b, h, w) of z * dy               (f32, f64 sums)
//     sums[b, 0, c] = sum gm, sums[b, 1, c] = sum gm * ((u - mu) * is)
//
// Every sum runs in f64 in a fixed order and is rounded once. A product of
// two f32 (or bf16) values is exact in f64, so each term is exact and only
// the order of the adds can change a sum; the plain versions
// (ops/kernels/conv_block_kernel.py) add in the same order, so the two agree
// bit for bit:
//   conv: for each output, over ci, then kh, then kw, in turn;
//   dW: over w along each image row (b, h), rows added in turn within
//       groups of kRowGroup rows, the groups added in turn;
//   moments and sums: the instance-norm kernels' block order (strided
//       thread sums, xor-shuffle warp trees, warp sums in order).
// The elementwise parts round every multiply and add separately
// (__fmul_rn, __fadd_rn): FMA contraction would change the result.
//
// What bounds it on an H100: operations. The conv does 2 * 9 * C * Co
// operations a pixel, in f64 on the CUDA cores (34 TFLOP/s). It serves the
// f32 step comparisons, whose exactness rests on it, not the train steps.
// A direct convolution: a block computes a 16 x 32 pixel tile of 16
// output channels, stages 4 input channels of the tile (with its halo,
// after the prologue) and their weights in shared memory as f64, and each
// thread keeps 4 pixels x 8 channels of f64 sums in registers. The weight
// gradient stages one row strip of 16 input and 16 output channels and
// each thread sums the 9 taps of one (co, ci) pair.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// prologue modes
constexpr int kIdentity = 0;   // z = u
constexpr int kAffine = 1;     // z = T(T(u * at) + bt)
constexpr int kAffineRelu = 2; // z = relu(T(T(u * at) + bt))

// the prologue's value before its activation (the identity: u itself)
template <typename T>
__device__ __forceinline__ float pre_act(float u, float at, float bt,
                                         int mode) {
  if (mode == kIdentity) return u;
  const float p = round_to<T>(__fmul_rn(u, at));
  return round_to<T>(__fadd_rn(p, bt));
}

template <typename T>
__device__ __forceinline__ float prologue(float u, float at, float bt,
                                          int mode) {
  const float n = pre_act<T>(u, at, bt, mode);
  return mode == kAffineRelu ? fmaxf(n, 0.f) : n;
}

// ------------------------------------------------------------------ conv
constexpr int kTH = 16, kTW = 32;   // output tile: rows, columns
constexpr int kPX = 4;              // columns a thread computes
constexpr int kCoT = 16, kCoPT = 8; // output channels: a block, a thread
constexpr int kCiT = 4;             // input channels staged at a time
constexpr int kThreads = 256;       // (kTW / kPX) x kTH x (kCoT / kCoPT)

// out[b, co, h, w] = sum_{ci, kh, kw} z[b, ci, h + kh - 1, w + kw - 1] *
// wt[ci, kh * 3 + kw, co], f64 sums in that order, rounded to f32 then OutT.
// z = prologue(in) with the per-channel at, bt (f32 values already in T).
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ in, const double* __restrict__ wt,
                   const float* __restrict__ pa, const float* __restrict__ pb,
                   int mode, OutT* __restrict__ out, int C, int Co, int H,
                   int W, int tiles_w) {
  __shared__ double zs[kCiT][kTH + 2][kTW + 2];
  __shared__ double ws[kCiT][9][kCoT];
  const int th0 = (blockIdx.x / tiles_w) * kTH;
  const int tw0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * kCoT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int half = tid >> 7;          // which 8 of the 16 output channels
  const int r = (tid & 127) >> 3;     // tile row
  const int cq = tid & 7;             // column quad
  double acc[kPX][kCoPT];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int o = 0; o < kCoPT; ++o) acc[p][o] = 0.0;

  const long long plane = (long long)H * W;
  for (int ci0 = 0; ci0 < C; ci0 += kCiT) {
    __syncthreads();
    for (int i = tid; i < kCiT * (kTH + 2) * (kTW + 2); i += kThreads) {
      const int c = i / ((kTH + 2) * (kTW + 2));
      const int rem = i % ((kTH + 2) * (kTW + 2));
      const int rr = rem / (kTW + 2), cc = rem % (kTW + 2);
      const int ci = ci0 + c, h = th0 + rr - 1, w = tw0 + cc - 1;
      double v = 0.0;
      if (ci < C && h >= 0 && h < H && w >= 0 && w < W) {
        const float u = to_f32(in[((long long)b * C + ci) * plane +
                                  (long long)h * W + w]);
        v = (double)prologue<T>(u, mode ? pa[ci] : 0.f,
                                mode ? pb[ci] : 0.f, mode);
      }
      zs[c][rr][cc] = v;
    }
    for (int i = tid; i < kCiT * 9 * kCoT; i += kThreads) {
      const int c = i / (9 * kCoT), k = (i / kCoT) % 9, o = i % kCoT;
      const int ci = ci0 + c, co = co0 + o;
      ws[c][k][o] =
          (ci < C && co < Co) ? wt[((long long)ci * 9 + k) * Co + co] : 0.0;
    }
    __syncthreads();
    const int cn = min(kCiT, C - ci0);
    for (int c = 0; c < cn; ++c) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        double zr[kPX + 2];
#pragma unroll
        for (int j = 0; j < kPX + 2; ++j) zr[j] = zs[c][r + kh][cq * kPX + j];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          double wv[kCoPT];
#pragma unroll
          for (int o = 0; o < kCoPT; ++o)
            wv[o] = ws[c][kh * 3 + kw][half * kCoPT + o];
#pragma unroll
          for (int p = 0; p < kPX; ++p)
#pragma unroll
            for (int o = 0; o < kCoPT; ++o)
              // the product of two f32 values is exact in f64: the fma
              // rounds once, as the plain version's add does
              acc[p][o] = fma(zr[p + kw], wv[o], acc[p][o]);
        }
      }
    }
  }
  const int h = th0 + r;
  if (h >= H) return;
#pragma unroll
  for (int o = 0; o < kCoPT; ++o) {
    const int co = co0 + half * kCoPT + o;
    if (co >= Co) continue;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int w = tw0 + cq * kPX + p;
      if (w < W)
        out[((long long)b * Co + co) * plane + (long long)h * W + w] =
            from_f32<OutT>(__double2float_rn(acc[p][o]));
    }
  }
}

// ------------------------------------------------------ block reductions
// Sum of (s1, s2) over the block; every thread gets the result. scratch
// holds 2 * (blockDim.x / 32) doubles. The order of instance_norm.cu.
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

// threads of a reduction block over a plane of n values; the plain
// versions take it from ops/kernels/norm_kernel.py:block_threads
int threads_for(int n) {
  if (n <= 1024) return 128;
  if (n <= 4096) return 256;
  return 512;
}

// mom[b, 0, c] = sum y, mom[b, 1, c] = sum y * y over each (b, c) plane;
// one block a plane, blockIdx.x = b * C + c
template <typename T>
__global__ void moments_kernel(const T* __restrict__ y,
                               double* __restrict__ mom, int C, int n) {
  __shared__ double scratch[32];
  const long long base = (long long)blockIdx.x * n;
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double f = (double)to_f32(y[base + i]);
    s1 = __dadd_rn(s1, f);
    s2 = __dadd_rn(s2, __dmul_rn(f, f));
  }
  const double2 s = block_sum(s1, s2, scratch);
  if (threadIdx.x == 0) {
    const int b = blockIdx.x / C, c = blockIdx.x % C;
    mom[((long long)b * 2) * C + c] = s.x;
    mom[((long long)b * 2 + 1) * C + c] = s.y;
  }
}

// sums[b, 0, c] = sum gm, sums[b, 1, c] = sum gm * ((u - mu[c]) * is[c])
template <typename T>
__global__ void bn_sums_kernel(const float* __restrict__ gm,
                               const T* __restrict__ u,
                               const float* __restrict__ mu,
                               const float* __restrict__ is,
                               double* __restrict__ sums, int C, int n) {
  __shared__ double scratch[32];
  const long long base = (long long)blockIdx.x * n;
  const int b = blockIdx.x / C, c = blockIdx.x % C;
  const float m = mu[c], s = is[c];
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float g = gm[base + i];
    const float xh = __fmul_rn(__fsub_rn(to_f32(u[base + i]), m), s);
    s1 = __dadd_rn(s1, (double)g);
    s2 = __dadd_rn(s2, __dmul_rn((double)g, (double)xh));
  }
  const double2 t = block_sum(s1, s2, scratch);
  if (threadIdx.x == 0) {
    sums[((long long)b * 2) * C + c] = t.x;
    sums[((long long)b * 2 + 1) * C + c] = t.y;
  }
}

// ---------------------------------------------------------- elementwise
// dy = T((A * g - C1) - ((y - MU) * IS) * C2) with fin = rows A, C1, C2, MU,
// IS of Co values each (the BN-backward finalize of the downstream norm)
template <typename T>
__global__ void finalize_kernel(const T* __restrict__ g,
                                const T* __restrict__ y,
                                const float* __restrict__ fin,
                                T* __restrict__ dy, int Co, long long plane,
                                long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)((i / plane) % Co);
    const float A = fin[c], C1 = fin[Co + c], C2 = fin[2 * Co + c];
    const float MU = fin[3 * Co + c], IS = fin[4 * Co + c];
    const float xh = __fmul_rn(__fsub_rn(to_f32(y[i]), MU), IS);
    const float t = __fsub_rn(__fmul_rn(A, to_f32(g[i])), C1);
    dy[i] = from_f32<T>(__fsub_rn(t, __fmul_rn(xh, C2)));
  }
}

// gm = [pre-activation of the prologue > 0] * gm (for a ReLU prologue),
// in place; gout = T(gm + carry) (or T(gm))
template <typename T>
__global__ void dgrad_epilogue_kernel(float* __restrict__ gm,
                                      const T* __restrict__ u,
                                      const float* __restrict__ pa,
                                      const float* __restrict__ pb, int mode,
                                      const T* __restrict__ carry,
                                      T* __restrict__ gout, int C,
                                      long long plane, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = gm[i];
    if (mode == kAffineRelu) {
      const int c = (int)((i / plane) % C);
      if (!(pre_act<T>(to_f32(u[i]), pa[c], pb[c], mode) > 0.f)) v = 0.f;
      gm[i] = v;
    }
    gout[i] = from_f32<T>(carry ? __fadd_rn(v, to_f32(carry[i])) : v);
  }
}

// -------------------------------------------------------- weight gradient
// image rows a block sums in turn (conv_block_kernel.py:ROW_GROUP)
constexpr int kRowGroup = 8;
constexpr int kWC = 64;       // columns staged at a time
constexpr int kPairT = 16;    // output and input channels of a block

// part[g, (co * C + ci) * 9 + k] = sum over the rows r of group g, in turn,
// of (sum over w, in turn, of z[b, ci, h + kh - 1, w + kw - 1] *
// dy[b, co, h, w]) with r = b * H + h and k = kh * 3 + kw
template <typename T>
__global__ void __launch_bounds__(kPairT * kPairT)
    wgrad_partial_kernel(const T* __restrict__ u,
                         const float* __restrict__ pa,
                         const float* __restrict__ pb, int mode,
                         const T* __restrict__ dy, double* __restrict__ part,
                         int B, int C, int Co, int H, int W) {
  __shared__ double zs[kPairT][3][kWC + 2];
  __shared__ double ds[kPairT][kWC];
  const int g = blockIdx.x;
  const int co0 = blockIdx.y * kPairT;
  const int ci0 = blockIdx.z * kPairT;
  const int tid = threadIdx.x;
  const int o = tid >> 4, c = tid & 15;
  const int co = co0 + o, ci = ci0 + c;
  const long long plane = (long long)H * W;
  const int rows = B * H;
  const int r1 = min(rows, (g + 1) * kRowGroup);
  double acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.0;
  for (int r = g * kRowGroup; r < r1; ++r) {
    const int b = r / H, h = r % H;
    double s[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] = 0.0;
    for (int w0 = 0; w0 < W; w0 += kWC) {
      __syncthreads();
      for (int i = tid; i < kPairT * 3 * (kWC + 2); i += kPairT * kPairT) {
        const int cc = i / (3 * (kWC + 2));
        const int rem = i % (3 * (kWC + 2));
        const int kh = rem / (kWC + 2), j = rem % (kWC + 2);
        const int cj = ci0 + cc, hh = h + kh - 1, ww = w0 + j - 1;
        double v = 0.0;
        if (cj < C && hh >= 0 && hh < H && ww >= 0 && ww < W) {
          const float x = to_f32(u[((long long)b * C + cj) * plane +
                                   (long long)hh * W + ww]);
          v = (double)prologue<T>(x, mode ? pa[cj] : 0.f,
                                  mode ? pb[cj] : 0.f, mode);
        }
        zs[cc][kh][j] = v;
      }
      for (int i = tid; i < kPairT * kWC; i += kPairT * kPairT) {
        const int oo = i / kWC, j = i % kWC;
        const int cq = co0 + oo, ww = w0 + j;
        ds[oo][j] = (cq < Co && ww < W)
                        ? (double)to_f32(dy[((long long)b * Co + cq) * plane +
                                            (long long)h * W + ww])
                        : 0.0;
      }
      __syncthreads();
      const int wn = min(kWC, W - w0);
      for (int j = 0; j < wn; ++j) {
        const double d = ds[o][j];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            s[kh * 3 + kw] = fma(zs[c][kh][j + kw], d, s[kh * 3 + kw]);
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = __dadd_rn(acc[k], s[k]);
  }
  if (co < Co && ci < C) {
    double* dst = part + (long long)g * Co * C * 9 + ((long long)co * C + ci) * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k] = acc[k];
  }
}

// dW[i] = f32(sum over the groups, in turn, of part[g, i])
__global__ void wgrad_reduce_kernel(const double* __restrict__ part,
                                    float* __restrict__ dw, int groups,
                                    long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  double t = 0.0;
  for (int g = 0; g < groups; ++g) t = __dadd_rn(t, part[(long long)g * n + i]);
  dw[i] = __double2float_rn(t);
}

int elementwise_blocks(long long total) {
  const long long b = (total + 255) / 256;
  return (int)(b < 65536 ? b : 65536);
}

template <typename T>
int launch_fwd(const void* u, const double* wt, const float* pa,
               const float* pb, int mode, void* y, double* mom, int B, int C,
               int Co, int H, int W, cudaStream_t st) {
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  dim3 grid(tiles_h * tiles_w, (Co + kCoT - 1) / kCoT, B);
  conv3x3_kernel<T, T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(u), wt, pa, pb, mode, static_cast<T*>(y), C, Co,
      H, W, tiles_w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  moments_kernel<T><<<B * Co, threads_for(H * W), 0, st>>>(
      static_cast<const T*>(y), mom, Co, H * W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* y, const float* fin, void* dy,
               const void* u, const float* pa, const float* pb, int mode,
               const double* wtf, float* gm, const float* mu,
               const float* is, double* sums, const void* carry, void* gout,
               double* part, float* dw, int B, int C, int Co, int H, int W,
               cudaStream_t st) {
  const long long plane = (long long)H * W;
  const T* dys = static_cast<const T*>(g);
  if (fin) {
    const long long total = (long long)B * Co * plane;
    finalize_kernel<T><<<elementwise_blocks(total), 256, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(y), fin,
        static_cast<T*>(dy), Co, plane, total);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dys = static_cast<const T*>(dy);
  }
  // the transposed conv: a conv of dy (Co channels) with the flipped,
  // transposed kernel wtf[co, k, ci], into gm (f32)
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  dim3 grid(tiles_h * tiles_w, (C + kCoT - 1) / kCoT, B);
  conv3x3_kernel<T, float><<<grid, kThreads, 0, st>>>(
      dys, wtf, nullptr, nullptr, kIdentity, gm, Co, C, H, W, tiles_w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)B * C * plane;
  dgrad_epilogue_kernel<T><<<elementwise_blocks(total), 256, 0, st>>>(
      gm, static_cast<const T*>(u), pa, pb, mode,
      static_cast<const T*>(carry), static_cast<T*>(gout), C, plane, total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (sums) {
    bn_sums_kernel<T><<<B * C, threads_for((int)plane), 0, st>>>(
        gm, static_cast<const T*>(u), mu, is, sums, C, (int)plane);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (B * H + kRowGroup - 1) / kRowGroup;
  dim3 wgrid(groups, (Co + kPairT - 1) / kPairT, (C + kPairT - 1) / kPairT);
  wgrad_partial_kernel<T><<<wgrid, kPairT * kPairT, 0, st>>>(
      static_cast<const T*>(u), pa, pb, mode, dys, part, B, C, Co, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)Co * C * 9;
  wgrad_reduce_kernel<<<(int)((n + 255) / 256), 256, 0, st>>>(part, dw,
                                                              groups, n);
  return (int)cudaGetLastError();
}

}  // namespace

// u: (B, C, H, W) f32; wt: (C, 9, Co) f64, the kernel's values; pa, pb:
// (C,) f32 prologue scale and shift (ignored for mode 0); mode 0
// identity, 1 affine, 2 affine + ReLU. Writes y (B, Co, H, W) f32 and mom
// (B, 2, Co) f64. Returns the cudaError_t of the launches.
extern "C" int conv3x3_fwd(const void* u, const void* wt, const void* pa,
                           const void* pb, int mode, void* y, void* mom,
                           int B, int C, int Co, int H, int W,
                           void* stream) {
  return launch_fwd<float>(u, static_cast<const double*>(wt),
                           static_cast<const float*>(pa),
                           static_cast<const float*>(pb), mode, y,
                           static_cast<double*>(mom), B, C, Co, H, W,
                           static_cast<cudaStream_t>(stream));
}

// g, y, dy: (B, Co, H, W) f32; fin: (5, Co) f32 or null (then dy is unused
// and g is the conv's output gradient); u, carry, gout: (B, C, H, W) f32
// (carry may be null); pa, pb, mode: the forward's prologue; wtf: (Co, 9,
// C) f64, the flipped, transposed kernel; gm: (B, C, H, W) f32 scratch
// that ends as the masked pre-carry gradient; mu, is: (C,) f32 and sums
// (B, 2, C) f64, or all null; part: (ceil(B * H / kRowGroup), Co * C * 9)
// f64 scratch; dw: (Co, C, 3, 3) f32.
extern "C" int conv3x3_bwd(const void* g, const void* y, const void* fin,
                           void* dy, const void* u, const void* pa,
                           const void* pb, int mode, const void* wtf,
                           void* gm, const void* mu, const void* is,
                           void* sums, const void* carry, void* gout,
                           void* part, void* dw, int B, int C, int Co, int H,
                           int W, void* stream) {
  return launch_bwd<float>(
      g, y, static_cast<const float*>(fin), dy, u,
      static_cast<const float*>(pa), static_cast<const float*>(pb), mode,
      static_cast<const double*>(wtf), static_cast<float*>(gm),
      static_cast<const float*>(mu), static_cast<const float*>(is),
      static_cast<double*>(sums), carry, gout, static_cast<double*>(part),
      static_cast<float*>(dw), B, C, Co, H, W,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
