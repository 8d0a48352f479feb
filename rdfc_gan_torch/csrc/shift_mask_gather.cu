// Gather backward of the shift-mask scatter, for sm_90a.
//
// Replaces rdfc_gan_tpu/ops/pallas/mask_kernel.py:_gather_kernel (reached
// through the VJP of scatter_shift_masks, _scatter_bwd):
//
//     dw[b, k, p] = dM[b, sy[b, k, p] * S + sx[b, k, p], p]
//
// and 0 where sy or sx lies outside [0, S): the transpose of the scatter,
// which drops such weights. dM is f32 or bf16; dw takes the type of the
// scatter's w (f32 or bf16). The value passes through f32, so a bf16 -> bf16
// or f32 -> f32 gather is an exact copy.
//
// What bounds it on an H100: bytes. Each output reads two indices and one
// plane value and does no arithmetic.
//
// Design: one thread per (b, k, p) with p fastest, so the index reads and
// the dw writes are coalesced; the dM read is coalesced wherever
// neighbouring pixels pick the same plane, which the smooth learned offsets
// make the common case. No shared memory, no atomics, deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TI, typename TO>
__global__ void shift_mask_gather_kernel(const TI* __restrict__ dM,
                                         const int* __restrict__ sy,
                                         const int* __restrict__ sx,
                                         TO* __restrict__ dw, int K,
                                         long long HW, int S,
                                         long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long p = i % HW;
  const long long b = i / HW / K;
  const int y = sy[i];
  const int x = sx[i];
  float v = 0.f;
  if ((unsigned)y < (unsigned)S && (unsigned)x < (unsigned)S)
    v = load_f32(dM + (b * S * S + y * S + x) * HW + p);
  store_f32(dw + i, v);
}

template <typename TI, typename TO>
int launch(const void* dM, const void* sy, const void* sx, void* dw, int B,
           int K, long long HW, int S, cudaStream_t stream) {
  const long long total = (long long)B * K * HW;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  shift_mask_gather_kernel<TI, TO><<<blocks, threads, 0, stream>>>(
      static_cast<const TI*>(dM), static_cast<const int*>(sy),
      static_cast<const int*>(sx), static_cast<TO*>(dw), K, HW, S, total);
  return (int)cudaGetLastError();
}

}  // namespace

// dM: (B, S*S, HW), f32 (dm_bf16 = 0) or bf16; sy, sx: (B, K, HW) int32;
// dw: (B, K, HW), f32 (dw_bf16 = 0) or bf16; all contiguous.
// Returns the cudaError_t of the launch.
extern "C" int shift_mask_gather(const void* dM, const void* sy,
                                 const void* sx, void* dw, int B, int K,
                                 long long HW, int S, int dm_bf16,
                                 int dw_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (dm_bf16)
    return dw_bf16 ? launch<bf, bf>(dM, sy, sx, dw, B, K, HW, S, st)
                   : launch<bf, float>(dM, sy, sx, dw, B, K, HW, S, st);
  return dw_bf16 ? launch<float, bf>(dM, sy, sx, dw, B, K, HW, S, st)
                 : launch<float, float>(dM, sy, sx, dw, B, K, HW, S, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
