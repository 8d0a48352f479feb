// NLSPN propagation chain over the shift-mask stencil, for sm_90a.
//
// Replaces rdfc_gan_tpu/ops/pallas/nlspn_kernel.py:_kernel in both of its
// variants: emit_x=False (reached through propagate_auto ->
// nlspn_stencil_propagate_pallas -> _pallas_forward) and emit_x=True
// (_pallas_forward_x, the forward of the differentiated chain). T times:
//
//     x    = preserve ? (fix > 0 ? fix : feat) : feat      (whole map)
//     X[t] = x                                   (emit-X variant only)
//     feat = sum_{iy, ix} M[b, iy, ix] * x(h + lo + iy, w + lo + ix)
//
// with x zero outside the image (the CUDA zero-pad boundary of the
// reference's deformable conv). M is bf16, as the TPU kernel holds it; the
// sum is f32. The result is the last step's sum, not substituted. X, the
// (T, B, H, W) stack of substituted step inputs that the backward's
// mask-gradient contraction reads, is stored in f32 or bf16.
//
// What bounds it on an H100: bytes. One step reads the S^2 mask planes once
// (S^2 * 2 bytes a pixel) and does S^2 multiply-adds on them, about one
// operation per byte, far below the ridge. X adds one plane write a step.
//
// Design: one launch per step, one thread per pixel, ping-ponging two f32
// planes; 32x8 blocks keep a warp on one row so mask reads, neighbour reads
// and the store are coalesced. The TPU kernel kept an image's whole mask
// stack (8.3 MiB at S=8, 224x304) on chip across all T steps; an H100 block
// has 227 KB of shared memory, so here every step reads the stack again and
// relies on the 50 MB L2 holding it (35 MB at B=4). The preserve
// substitution is made where a neighbour is read, since a thread cannot see
// its neighbours' substituted values otherwise without a pre-pass. Both
// variants share one step body, as the TPU kernel shares one, so the
// differentiated forward cannot drift from the served one: the emit-X
// instantiation only adds, after the sum, the store of the thread's own
// substituted input. Keep the address arithmetic as it is written: a
// version that hoisted the pixel offset into a variable took a 32nd
// register and ran the served chain about a quarter slower on the H100
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <bool kEmitX>
__global__ void nlspn_step_kernel(const float* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ M,
                                  const float* __restrict__ fix,
                                  float* __restrict__ out,
                                  void* __restrict__ xt, int x_bf16, int H,
                                  int W, int S, int lo) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (h >= H || w >= W) return;
  const long long b = blockIdx.z;
  const long long HW = (long long)H * W;
  const float* xb = x + b * HW;
  const float* fb = fix ? fix + b * HW : nullptr;
  const __nv_bfloat16* mb = M + b * S * S * HW + (long long)h * W + w;

  float acc = 0.f;
  for (int iy = 0; iy < S; ++iy) {
    const int yy = h + lo + iy;
    const bool row_in = (unsigned)yy < (unsigned)H;
    for (int ix = 0; ix < S; ++ix) {
      const int xx = w + lo + ix;
      float v = 0.f;
      if (row_in && (unsigned)xx < (unsigned)W) {
        const long long q = (long long)yy * W + xx;
        v = xb[q];
        if (fb) {
          const float f = fb[q];
          if (f > 0.f) v = f;
        }
      }
      // separately rounded multiply and add, in the plain version's order:
      // the two agree bit for bit on the card
      acc = __fadd_rn(acc, __fmul_rn(
          __bfloat162float(mb[(long long)(iy * S + ix) * HW]), v));
    }
  }
  if constexpr (kEmitX) {  // this step's substituted input at the pixel
    const long long c = (long long)h * W + w;
    float v = xb[c];
    if (fb && fb[c] > 0.f) v = fb[c];
    if (x_bf16)
      static_cast<__nv_bfloat16*>(xt)[b * HW + c] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(xt)[b * HW + c] = v;
  }
  out[b * HW + (long long)h * W + w] = acc;
}

}  // namespace

// feat0, fix, out, tmp: (B, H, W) f32, contiguous; fix may be null (no
// preserve substitution). M: (B, S, S, H, W) bf16. X: null (served
// forward) or the (T, B, H, W) stack, f32 (x_bf16 = 0) or bf16. Runs T >= 1
// steps, the last one writing to out (tmp is the other plane of the
// ping-pong). Returns the first failing launch's cudaError_t, else 0.
extern "C" int nlspn_propagate(const void* feat0, const void* M,
                               const void* fix, void* out, void* tmp,
                               void* X, int x_bf16, int B, int H, int W,
                               int S, int lo, int T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  const float* src = static_cast<const float*>(feat0);
  const long long plane = (long long)B * H * W * (x_bf16 ? 2 : 4);
  for (int t = 0; t < T; ++t) {
    float* dst = static_cast<float*>(((T - 1 - t) % 2 == 0) ? out : tmp);
    const __nv_bfloat16* m = static_cast<const __nv_bfloat16*>(M);
    const float* f = static_cast<const float*>(fix);
    if (X)
      nlspn_step_kernel<true><<<grid, block, 0, st>>>(
          src, m, f, dst, static_cast<char*>(X) + t * plane, x_bf16, H, W,
          S, lo);
    else
      nlspn_step_kernel<false><<<grid, block, 0, st>>>(
          src, m, f, dst, nullptr, 0, H, W, S, lo);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
