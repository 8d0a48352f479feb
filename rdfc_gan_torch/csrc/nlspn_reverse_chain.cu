// Reverse gradient chain of the NLSPN propagation, for sm_90a.
//
// Replaces rdfc_gan_tpu/ops/pallas/nlspn_kernel.py:_chain_kernel (reached
// through the VJP of nlspn_stencil_propagate_pallas, _bwd ->
// _pallas_reverse_chain). Phase 1 of the two-phase O(T) backward: for
// t = T-1 .. 0,
//
//     G[t] = gg                            (gradient of step t's output)
//     dx   = sum_{iy, ix} M_s(p - s) * gg(p - s),  s = (lo + iy, lo + ix)
//     preserve: dfix += (fix > 0) ? dx : 0;  dx = (fix > 0) ? 0 : dx
//     gg   = dx
//
// with M_s and gg read as zero outside the image: the transpose of the
// forward's zero-padded shifted read. The last gg is dfeat. M is bf16, as
// the forward holds it; the chain is f32; the G stack is stored in f32 or
// bf16 (the type of the X stack it is contracted with).
//
// What bounds it on an H100: bytes, as the forward chain: one step reads
// the S^2 mask planes once and does S^2 multiply-adds on them.
//
// Design: the TPU kernel writes the transpose as a scatter into a padded
// accumulator. Written as a gather, each output pixel sums its own S^2
// contributions, so it needs no atomics and no second pass, and it is
// deterministic. One launch per step, one thread per pixel, 32x8 blocks, a
// ping-pong of two f32 planes, as the forward chain; each thread also
// stores its own G[t] entry and updates its own dfix entry. The sum runs in
// the plain version's order (iy outer, ix inner) with separately rounded
// multiply and add, so the kernel and the plain version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void chain_step_kernel(const float* __restrict__ gg,
                                  const __nv_bfloat16* __restrict__ M,
                                  const float* __restrict__ fix,
                                  float* __restrict__ out,
                                  float* __restrict__ dfix,
                                  void* __restrict__ gt, int g_bf16, int H,
                                  int W, int S, int lo) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (h >= H || w >= W) return;
  const long long b = blockIdx.z;
  const long long HW = (long long)H * W;
  const float* gb = gg + b * HW;
  const __nv_bfloat16* mb = M + b * S * S * HW;

  float acc = 0.f;
  for (int iy = 0; iy < S; ++iy) {
    const int yy = h - (lo + iy);
    const bool row_in = (unsigned)yy < (unsigned)H;
    for (int ix = 0; ix < S; ++ix) {
      const int xx = w - (lo + ix);
      float v = 0.f;
      if (row_in && (unsigned)xx < (unsigned)W) {
        const long long q = (long long)yy * W + xx;
        v = __fmul_rn(__bfloat162float(mb[(long long)(iy * S + ix) * HW + q]),
                      gb[q]);
      }
      acc = __fadd_rn(acc, v);
    }
  }
  // the stores come after the sum, and the offset is computed here, not
  // ahead of the loop, as in the forward chain
  const long long c = b * HW + (long long)h * W + w;
  if (g_bf16)
    static_cast<__nv_bfloat16*>(gt)[c] = __float2bfloat16_rn(gg[c]);
  else
    static_cast<float*>(gt)[c] = gg[c];
  if (fix && fix[c] > 0.f) {
    dfix[c] = __fadd_rn(dfix[c], acc);
    acc = 0.f;
  }
  out[c] = acc;
}

}  // namespace

// g0, dfeat, tmp: (B, H, W) f32; M: (B, S, S, H, W) bf16; G: (T, B, H, W),
// f32 (g_bf16 = 0) or bf16; fix, dfix: (B, H, W) f32, both null without
// preserve, dfix zeroed by the caller; all contiguous. Runs T >= 1 steps,
// the last one writing dfeat (tmp is the other plane of the ping-pong).
// Returns the first failing launch's cudaError_t, else 0.
extern "C" int nlspn_reverse_chain(const void* g0, const void* M,
                                   const void* fix, void* G, void* dfeat,
                                   void* dfix, void* tmp, int g_bf16, int B,
                                   int H, int W, int S, int lo, int T,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  const long long plane = (long long)B * H * W * (g_bf16 ? 2 : 4);
  const float* src = static_cast<const float*>(g0);
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    float* dst = static_cast<float*>(((T - 1 - i) % 2 == 0) ? dfeat : tmp);
    chain_step_kernel<<<grid, block, 0, st>>>(
        src, static_cast<const __nv_bfloat16*>(M),
        static_cast<const float*>(fix), dst, static_cast<float*>(dfix),
        static_cast<char*>(G) + t * plane, g_bf16, H, W, S, lo);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
