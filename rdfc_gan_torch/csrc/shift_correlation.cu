// Shift correlation of the NLSPN backward (the mask gradient), for sm_90a.
//
// Replaces rdfc_gan_tpu/ops/pallas/mask_kernel.py:_corr_kernel (reached
// through shift_correlation, phase 2 of the two-phase O(T) backward):
//
//     dM[b, iy * S + ix, h, w] = sum_t G[t, b, h, w] * X[t, b, h + lo + iy,
//                                                       w + lo + ix]
//
// with X zero outside the image. G and X are f32 or bf16 (one type for
// both); the sum is f32, in order t = 0 .. T-1, and dM is stored in f32.
//
// What bounds it on an H100: bytes. It reads the two (T, B, H, W) stacks
// and writes S^2 f32 planes, doing 2 T operations per output: with T = 18
// about one operation per byte moved, far below the ridge.
//
// Design: one thread per (b, s, pixel), 32x8 blocks over the pixels and one
// grid layer per (b, s). Each thread walks t in order, reading its own G
// entry and its shifted X entry, so the 64 layers of one image read the
// same G and X rows from L2 (the TPU kernel instead keeps a row tile of
// both stacks and the 64-plane accumulator in VMEM). The multiply and add
// are rounded separately, as the plain version's, so the two agree bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename TS>
__global__ void shift_correlation_kernel(const TS* __restrict__ G,
                                         const TS* __restrict__ X,
                                         float* __restrict__ dM, int T,
                                         int B, int H, int W, int S,
                                         int lo) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (h >= H || w >= W) return;
  const int SS = S * S;
  const long long b = blockIdx.z / SS;
  const int s = blockIdx.z % SS;
  const int yy = h + lo + s / S;
  const int xx = w + lo + s % S;
  const bool in = (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W;
  const long long HW = (long long)H * W;
  const long long plane = (long long)B * HW;
  const long long pg = b * HW + (long long)h * W + w;
  const long long px = b * HW + (long long)yy * W + xx;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    const float x = in ? load_f32(X + t * plane + px) : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(load_f32(G + t * plane + pg), x));
  }
  dM[(b * SS + s) * HW + (long long)h * W + w] = acc;
}

template <typename TS>
int launch(const void* G, const void* X, void* dM, int T, int B, int H,
           int W, int S, int lo, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B * S * S);
  shift_correlation_kernel<TS><<<grid, block, 0, stream>>>(
      static_cast<const TS*>(G), static_cast<const TS*>(X),
      static_cast<float*>(dM), T, B, H, W, S, lo);
  return (int)cudaGetLastError();
}

}  // namespace

// G, X: (T, B, H, W), f32 (is_bf16 = 0) or bf16; dM: (B, S*S, H, W) f32;
// all contiguous. Returns the cudaError_t of the launch.
extern "C" int shift_correlation(const void* G, const void* X, void* dM,
                                 int T, int B, int H, int W, int S, int lo,
                                 int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(G, X, dM, T, B, H, W, S, lo, st);
  return launch<float>(G, X, dM, T, B, H, W, S, lo, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
