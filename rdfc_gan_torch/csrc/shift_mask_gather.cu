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
// plane value and does no arithmetic; the bound counts the dM stack once.
//
// Design: a block takes a tile of tp pixels (256, fewer where the tile of
// every plane would pass kStageBytes) of one image b and stages the whole
// stack dM[b, :, tile] in shared memory, each plane row with 16-byte
// cp.async copies: every dM byte is read once, in full sectors, where a
// read a pixel would fetch a 32-byte sector for each 2 or 4 bytes it uses
// (the planes of neighbouring pixels differ). Then thread t takes the 8
// consecutive pixels of group t % (tp / 8) and the rows k = t / (tp / 8),
// + 8, ... of the image: two 16-byte loads each of sy and sx, with the
// streaming hint (read once: they should not push dM out of L2), 8 reads
// from shared memory and one 16-byte store of bf16 dw (two of f32); a warp
// covers 256 or 128 contiguous pixels of a row. Where HW is not a multiple
// of 8 or a pointer is not 16-byte aligned, staging and gather run as
// scalars (a thread's pixels stop at the row's end). Offsets are 64-bit
// products, and the only divisions are by the powers of two tp and 8, as
// shifts. No atomics, deterministic: an exact copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStageBytes = 96 * 1024;  // a block's tile of the stack

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <typename TO>
__device__ __forceinline__ void store8(TO* p, const float (&v)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// tp = 1 << lg pixels a tile; blockDim.x = tp
template <typename TI, typename TO>
__global__ void shift_mask_gather_kernel(const TI* __restrict__ dM,
                                         const int* __restrict__ sy,
                                         const int* __restrict__ sx,
                                         TO* __restrict__ dw, int K,
                                         long long HW, int S, int lg,
                                         bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  TI* stage = reinterpret_cast<TI*>(smem);  // [S * S][tp]
  const int tp = 1 << lg;
  const int b = blockIdx.y;
  const long long tile0 = (long long)blockIdx.x << lg;
  const int valid = HW - tile0 < tp ? (int)(HW - tile0) : tp;
  const int n_planes = S * S;
  const TI* src = dM + (long long)b * n_planes * HW + tile0;
  if (vec) {  // valid is a multiple of 8: whole 16-byte chunks
    constexpr int E = 16 / sizeof(TI);
    const int lc = lg - (E == 8 ? 3 : 2);  // log2 of chunks a row
    const int row_chunks = valid / E;
    for (int c = threadIdx.x; c < (n_planes << lc); c += blockDim.x) {
      const int s = c >> lc, j = c & ((1 << lc) - 1);
      if (j < row_chunks)
        copy16_async(stage + ((long long)s << lg) + j * E,
                     src + s * HW + j * E);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int c = threadIdx.x; c < (n_planes << lg); c += blockDim.x) {
      const int s = c >> lg, j = c & (tp - 1);
      if (j < valid) stage[c] = src[s * HW + j];
    }
  }
  __syncthreads();

  const int groups = tp >> 3;
  const int g = threadIdx.x & (groups - 1);
  const int p0 = g * 8;
  if (p0 >= valid) return;
  const TI* col = stage + p0;
  for (int k = threadIdx.x >> (lg - 3); k < K; k += 8) {
    const long long row = ((long long)b * K + k) * HW + tile0 + p0;
    if (vec) {  // all 8 pixels are in the row
      const int4* y4 = reinterpret_cast<const int4*>(sy + row);
      const int4* x4 = reinterpret_cast<const int4*>(sx + row);
      const int4 ya = __ldcs(y4), yb = __ldcs(y4 + 1);
      const int4 xa = __ldcs(x4), xb = __ldcs(x4 + 1);
      const int ys[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
      const int xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float v[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        v[l] = 0.f;
        if ((unsigned)ys[l] < (unsigned)S && (unsigned)xs[l] < (unsigned)S)
          v[l] = to_f32(col[((ys[l] * S + xs[l]) << lg) + l]);
      }
      store8(dw + row, v);
    } else {
      const int m = valid - p0 < 8 ? valid - p0 : 8;
      for (int l = 0; l < m; ++l) {
        const int y = __ldcs(sy + row + l);
        const int x = __ldcs(sx + row + l);
        float v = 0.f;
        if ((unsigned)y < (unsigned)S && (unsigned)x < (unsigned)S)
          v = to_f32(col[((y * S + x) << lg) + l]);
        store_f32(dw + row + l, v);
      }
    }
  }
}

template <typename TI, typename TO>
int launch(const void* dM, const void* sy, const void* sx, void* dw, int B,
           int K, long long HW, int S, cudaStream_t stream) {
  int lg = 8;  // 256 pixels a tile
  while (lg > 3 && ((size_t)S * S * sizeof(TI) << lg) > kStageBytes) --lg;
  const size_t smem = (size_t)S * S * sizeof(TI) << lg;
  if (smem > (size_t)kStageBytes) return (int)cudaErrorInvalidValue;
  auto k = shift_mask_gather_kernel<TI, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((HW + (1 << lg) - 1) >> lg), B);
  const bool aligned = (((uintptr_t)dM | (uintptr_t)sy | (uintptr_t)sx |
                         (uintptr_t)dw) & 15) == 0;
  k<<<grid, 1 << lg, smem, stream>>>(
      static_cast<const TI*>(dM), static_cast<const int*>(sy),
      static_cast<const int*>(sx), static_cast<TO*>(dw), K, HW, S, lg,
      aligned && HW % 8 == 0);
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
