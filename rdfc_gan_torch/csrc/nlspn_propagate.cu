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
// sum is f32, in the plain version's order (iy outer, ix inner) with a
// separately rounded multiply and add, so the kernel and ops/
// nlspn_stencil.py (stencil_propagate, propagate_x_plain) agree bit for
// bit. The result is the last step's sum, not substituted. X, the
// (T, B, H, W) stack of substituted step inputs that the backward's
// mask-gradient contraction reads, is stored in f32 or bf16 (rounded to
// nearest even).
//
// What bounds it on an H100: bytes. The chain needs the S^2 mask planes
// (35 MB at 4 x 224 x 304, S = 8) once and T steps of S^2 multiply-adds a
// pixel, about one operation per byte, far below the ridge; a launch a
// step, as the TPU kernel runs, reads the whole stack T times.
//
// Design, as the reverse chain (nlspn_reverse_chain.cu): one cooperative
// launch for the whole chain, one block an SM, a grid barrier between
// steps. The pixels are cut into runs of 8 along a row (a row padded to a
// multiple of 8), and each block owns a contiguous range of runs for every
// step, a thread a run (or several). The forward reads M_s(p) at the
// pixel's own address, so a run's weights for shift s are already 8
// consecutive bf16, one aligned 16-byte vector (M's rows are padded with
// zeros to a multiple of 8 by the wrapper where W is not one): no
// pre-shift and no scratch stack. At the start a block copies as many of
// its runs' S^2 vectors as fit beside its x tile into shared memory with
// cp.async, shift-major (a warp's 16-byte reads are conflict-free); the
// other runs load theirs from M every step, a window row ahead of use,
// from L2. One load path for both (a generic pointer and a stride), with
// no scalar path beside it, keeps the unrolled sums free of spills: a
// first version, with scalar mask loads for odd widths in the same loop,
// spilled and ran markedly slower (PERF.md). Every step a block
// stages the rows of x that its runs read (its rows, -lo halo rows above
// and hi below, 8 zero columns each side), making the preserve
// substitution as it stages, so each value is read and substituted once a
// step; a thread then loads, for each iy, the 8 + S - 1 values its run
// reads as 16-byte vectors and sums its 8 pixels into 8 f32 accumulators.
// Its stores (the next plane; X[t] of its run, from the staged tile) are
// 16 or 32 bytes a run where W is a multiple of 8, else scalars. Where a
// block's rows and halo would pass its shared memory, it takes its runs in
// bands within a step: bands of whole rows, or, where not even one row and
// its halo fit, one row cut into chunks of runs (chain_plan; a band is
// staged, summed, and the block synchronised before the next). So no
// plane is refused. The plan and the staging are shared with the reverse
// chain (nlspn_chain.cuh).
//
// Where the time goes (PERF.md): about 7 us a step at 4 x 224 x 304,
// S = 8, on the H100: the chain is bound by its T dependent steps (a grid
// barrier, the staging of x and a run's S^2 sequential sums each), not by
// bytes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nlspn_chain.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float lo_bf16(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the 8 values of a run, as 16- or 32-byte stores (vec) or nvalid scalars
__device__ __forceinline__ void store_run(float* p, const float (&v)[kRun],
                                          bool vec, int nvalid) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < nvalid) p[k] = v[k];
  }
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p,
                                          const float (&v)[kRun], bool vec,
                                          int nvalid) {
  if (vec) {
    uint4 q;
    q.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    q.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    q.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
    q.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < nvalid) p[k] = __float2bfloat16_rn(v[k]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// The sums of a run's 8 pixels, acc[k] = sum_{iy, ix} M_s[k] * x, in the
// plain version's order: wrow is the run's window in the staged tile
// (row iy at wrow + iy * Wt, zero where row h + lo + iy leaves the image),
// mask(s) the run's 16-byte vector of shift s; a window row's vectors are
// loaded ahead of the previous row's sums.
template <int S, typename MaskFn>
__device__ __forceinline__ void sum_run(float (&acc)[kRun], const float* wrow,
                                        int Wt, int h, int H, MaskFn mask) {
  constexpr int LO = 1 - S / 2;
  // pixel k, shift ix reads window element SKIP + k + ix of NV float4
  constexpr int SKIP = (kLeft + LO) & 3;
  constexpr int NV = (SKIP + kRun + S - 1 + 3) / 4;
#pragma unroll
  for (int k = 0; k < kRun; ++k) acc[k] = 0.f;
  uint4 mv[S];
#pragma unroll
  for (int ix = 0; ix < S; ++ix) mv[ix] = mask(ix);
#pragma unroll
  for (int iy = 0; iy < S; ++iy) {
    float win[4 * NV];
    if ((unsigned)(h + LO + iy) < (unsigned)H) {
      const float4* wp = reinterpret_cast<const float4*>(wrow + iy * Wt);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 f = wp[v];
        win[4 * v] = f.x;
        win[4 * v + 1] = f.y;
        win[4 * v + 2] = f.z;
        win[4 * v + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < 4 * NV; ++v) win[v] = 0.f;
    }
    uint4 nx[S];
    if (iy + 1 < S) {
#pragma unroll
      for (int ix = 0; ix < S; ++ix) nx[ix] = mask((iy + 1) * S + ix);
    }
#pragma unroll
    for (int ix = 0; ix < S; ++ix) {
      const float m[kRun] = {lo_bf16(mv[ix].x), hi_bf16(mv[ix].x),
                             lo_bf16(mv[ix].y), hi_bf16(mv[ix].y),
                             lo_bf16(mv[ix].z), hi_bf16(mv[ix].z),
                             lo_bf16(mv[ix].w), hi_bf16(mv[ix].w)};
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(m[k], win[SKIP + k + ix]));
    }
    if (iy + 1 < S) {
#pragma unroll
      for (int ix = 0; ix < S; ++ix) mv[ix] = nx[ix];
    }
  }
}

struct ChainArgs {
  const float* feat0;
  const unsigned short* M;  // (B, S, S, H, Wm) bf16 bits
  const float* fix;         // null: no preserve
  float* out;
  float* tmp;
  void* X;  // (T, B, H, W) f32 or bf16; null in the served chain
  int B, H, W, T;
  int Rr;    // runs a row
  int Wm;    // M's row stride: Rr * kRun
  int runs;  // B * H * Rr
  Plan p;
  int Wt;  // tile row stride, floats: kLeft + band_runs * kRun + kRight
};

// S: the shift window's side (lo = 1 - S / 2); kEmitX: also store X[t],
// in XT.
template <int S, bool kEmitX, typename XT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    propagate_chain_kernel(const ChainArgs a) {
  constexpr int LO = 1 - S / 2;
  constexpr int SS = S * S;
  // the window of a run's row iy: tile columns from (w0 - c0) + OFF on,
  // loaded as aligned float4 from (w0 - c0) + A0 (sum_run)
  constexpr int OFF = kLeft + LO;
  constexpr int A0 = OFF & ~3;
  static_assert(OFF >= 0 &&
                    A0 + 4 * ((OFF - A0 + kRun + S - 1 + 3) / 4) <=
                        kLeft + kRun + kRight,
                "the tile's margins are too narrow for S");

  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const Plan& p = a.p;
  const int r0 = blockIdx.x * p.rpb;
  const int r1 = min(r0 + p.rpb, a.runs);
  const int gr0 = r0 / a.Rr;
  const int grL = (r1 - 1) / a.Rr;
  // the resident runs' vectors, [SS][p.nres], after the tile (Wt floats
  // is a multiple of 32 bytes)
  uint4* Ms = reinterpret_cast<uint4*>(
      tile + (size_t)(p.band_rows + S - 1) * a.Wt);
  const int nres = min(p.nres, r1 - r0);
  const long long HW = (long long)a.H * a.W;
  const long long HWm = (long long)a.H * a.Wm;
  const bool vec = (a.W % kRun) == 0;

  // the resident runs' masks, a shift plane's vectors of consecutive runs
  // by consecutive threads; awaited before the first step's sums
  for (int i = threadIdx.x; i < SS * nres; i += blockDim.x) {
    const int s = i / nres;
    const int j = i - s * nres;
    const int r = r0 + j;
    const int gr = r / a.Rr;
    const int b = gr / a.H;
    const int w0 = (r - gr * a.Rr) * kRun;
    cp_async16(Ms + s * p.nres + j,
               a.M + ((long long)b * SS + s) * HWm +
                   (long long)(gr - b * a.H) * a.Wm + w0);
  }

  cg::grid_group grid = cg::this_grid();
  const long long plane = (long long)a.B * HW;
  const float* src = a.feat0;
  for (int t = 0; t < a.T; ++t) {
    float* dst = ((a.T - 1 - t) % 2 == 0) ? a.out : a.tmp;
    XT* Xt = nullptr;
    if constexpr (kEmitX) Xt = static_cast<XT*>(a.X) + (long long)t * plane;
    bool staged = false;
    for (int ra = gr0; ra <= grL; ra += p.band_rows) {
      const int rb = min(ra + p.band_rows, grL + 1);
      for (int ca = 0; ca < a.Rr; ca += p.band_runs) {
        // the band's runs: whole rows ra .. rb - 1, or (rb == ra + 1) the
        // runs ca .. ca + nc - 1 of row ra; contiguous either way
        const int nc = min(p.band_runs, a.Rr - ca);
        const int fa = max(r0, ra * a.Rr + ca);
        const int fb = min(r1, (rb - 1) * a.Rr + ca + nc);
        if (fa >= fb) continue;
        if (staged) __syncthreads();  // the tile is free
        const int c0 = ca * kRun;
        stage_rows(src, a.fix, tile, a.W, a.B * a.H, a.Wt, ra + LO,
                   rb - ra + S - 1, c0 - kLeft);
        if (!staged && t == 0)  // the resident masks have landed
          asm volatile("cp.async.wait_all;\n" ::: "memory");
        staged = true;
        __syncthreads();
        for (int r = fa + threadIdx.x; r < fb; r += blockDim.x) {
          const int j = r - r0;
          const int gr = r / a.Rr;
          const int b = gr / a.H;
          const int h = gr - b * a.H;
          const int w0 = (r - gr * a.Rr) * kRun;
          const int nvalid = min(kRun, a.W - w0);
          const float* wrow = tile + (gr - ra) * a.Wt + (w0 - c0) + A0;
          // the run's vector of shift s is mv0[s * ms]: in shared memory
          // where resident, else in M, read from L2
          const uint4* mv0 =
              j < nres ? Ms + j
                       : reinterpret_cast<const uint4*>(
                             a.M + (long long)b * SS * HWm +
                             (long long)h * a.Wm + w0);
          const long long ms = j < nres ? p.nres : HWm / kRun;
          float acc[kRun];
          sum_run<S>(acc, wrow, a.Wt, h, a.H,
                     [=](int s) { return mv0[s * ms]; });
          const long long c = (long long)gr * a.W + w0;
          if constexpr (kEmitX) {  // the run's substituted input
            const float* own =
                tile + (gr - ra - LO) * a.Wt + (w0 - c0) + kLeft;
            float x[kRun];
#pragma unroll
            for (int k = 0; k < kRun; ++k) x[k] = own[k];
            store_run(Xt + c, x, vec, nvalid);
          }
          store_run(dst + c, acc, vec, nvalid);
        }
      }
    }
    if (t + 1 < a.T) grid.sync();  // the plane is whole; the tile is free
    src = dst;
  }
}

// One cooperative launch of the chain on plan a.p.
template <int S, bool kEmitX, typename XT>
int launch_chain(const ChainArgs& a, cudaStream_t stream) {
  auto k = propagate_chain_kernel<S, kEmitX, XT>;
  if (a.p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.blocks);
  cfg.blockDim = dim3(a.p.threads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // no fallback: a grid the card cannot hold at once is refused here
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool kEmitX, typename XT>
int launch_s(const ChainArgs& a, int S, cudaStream_t stream) {
  switch (S) {
    case 4: return launch_chain<4, kEmitX, XT>(a, stream);
    case 6: return launch_chain<6, kEmitX, XT>(a, stream);
    case 8: return launch_chain<8, kEmitX, XT>(a, stream);
    case 10: return launch_chain<10, kEmitX, XT>(a, stream);
    case 12: return launch_chain<12, kEmitX, XT>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// feat0, fix, out, tmp: (B, H, W) f32, contiguous, 16-byte aligned; fix
// may be null (no preserve substitution). M: (B, S, S, H, Wm) bf16,
// 16-byte aligned, Wm = W rounded up to a multiple of 8 (the padding
// zero). X: null (served forward) or the (T, B, H, W) stack, f32
// (x_bf16 = 0) or bf16. S is 4, 6, 8, 10 or 12 and lo = 1 - S / 2 (the
// shift window of a clamp radius R = S / 2 - 2). Runs T >= 1 steps in one
// cooperative launch, the last writing out (tmp is the other plane of the
// ping-pong). Returns the launch's cudaError_t.
extern "C" int nlspn_propagate(const void* feat0, const void* M,
                               const void* fix, void* out, void* tmp,
                               void* X, int x_bf16, int B, int H, int W,
                               int S, int lo, int T, void* stream) {
  if (T < 1 || lo != 1 - S / 2 || S % 2) return (int)cudaErrorInvalidValue;
  int sms = 0, smem_max = 0;
  const int e = card(&sms, &smem_max);
  if (e != 0) return e;
  ChainArgs a = {};
  if (!chain_plan(B, H, W, S - 1, S * S * 16, sms, smem_max, &a.p))
    return (int)cudaErrorInvalidValue;
  a.feat0 = static_cast<const float*>(feat0);
  a.M = static_cast<const unsigned short*>(M);
  a.fix = static_cast<const float*>(fix);
  a.out = static_cast<float*>(out);
  a.tmp = static_cast<float*>(tmp);
  a.X = X;
  a.B = B;
  a.H = H;
  a.W = W;
  a.T = T;
  a.Rr = (W + kRun - 1) / kRun;
  a.Wm = a.Rr * kRun;
  a.runs = B * H * a.Rr;
  a.Wt = kLeft + a.p.band_runs * kRun + kRight;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!X) return launch_s<false, float>(a, S, st);
  return x_bf16 ? launch_s<true, __nv_bfloat16>(a, S, st)
                : launch_s<true, float>(a, S, st);
}

// The plan of a (B, H, W) chain with an S x S window on a card of `sms`
// SMs and `smem_max` bytes of shared memory a block, as nlspn_propagate
// takes it: out = (blocks, threads, runs a block, resident runs, band
// rows, band runs, shared bytes). Returns 0, or cudaErrorInvalidValue
// where no plan fits.
extern "C" int nlspn_chain_plan(int B, int H, int W, int S, int sms,
                                int smem_max, int* out) {
  Plan p;
  if (!chain_plan(B, H, W, S - 1, S * S * 16, sms, smem_max, &p))
    return (int)cudaErrorInvalidValue;
  const int v[7] = {p.blocks, p.threads, p.rpb, p.nres, p.band_rows,
                    p.band_runs, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
