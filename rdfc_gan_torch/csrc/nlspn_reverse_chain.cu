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
// bf16 (the type of the X stack it is contracted with). The sum runs in the
// plain version's order (iy outer, ix inner) with separately rounded
// multiply and add, so the kernel and ops/nlspn_stencil.py:
// reverse_chain_plain agree bit for bit.
//
// What bounds it on an H100: bytes. The chain needs the S^2 mask planes
// (35 MB at 4 x 224 x 304, S = 8) once, and T steps of S^2 multiply-adds
// a pixel; a launch a step, as the TPU kernel runs, reads the whole stack
// T times.
//
// Design: one cooperative launch for the whole chain, one block an SM, a
// grid barrier between steps. The pixels are cut into runs of 8 along a
// row (a row padded to a multiple of 8), and each block owns a contiguous
// range of runs for every step, a thread a run (or several). At the start
// the owner of a run writes its pre-shifted masks M'_s(p) = M_s(p - s)
// (zero outside the image): a run's weights for shift s are then 8
// consecutive bf16 values, one aligned 16-byte vector. Where W is a
// multiple of 8 each is cut from two aligned 16-byte loads of M, all 2S of
// a window row in flight at once (else 8 scalar loads). As many runs as
// fit keep their vectors in shared memory for the whole chain, shift-major
// (a warp's 16-byte reads are conflict-free); the rest go to a global
// scratch stack, also shift-major, and are read back every step from L2,
// a window row ahead of their use. So M is read from HBM once a chain,
// and at 4 x 224 x 304, S = 8, four fifths of the stack never leave the
// SMs. Every step a block copies the rows of gg that its runs read (its
// rows and S - 1 of halo, with zero columns, 8 left and 8 right) from the
// previous step's plane into shared memory, a few 16-byte loads in flight
// a thread; a thread loads, for each iy, the 8 + S - 1 values its run
// reads as 16-byte vectors, and sums its 8 pixels' products into 8 f32
// accumulators. Its stores (G[t], the next plane, dfix) are 16 or 32 bytes
// a run where W is a multiple of 8, else scalars. Where a block's rows
// and halo would pass its shared memory, it takes its runs in bands within
// a step, as the forward chains do: bands of whole rows, or, where not even
// one row and its halo fit, one row cut into chunks of runs; a band is
// staged, summed, and the block synchronised before the next. The plan
// (chain_plan) and the staging are the forward chains' own
// (nlspn_chain.cuh), so no plane is refused.
//
// Where the time goes (PERF.md): the layout pass, then a few us a step:
// the chain is bound by its T dependent steps (a grid barrier, the staging
// of gg and a run's 64 sequential sums each), not by bytes.

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
    for (int k = 0; k < nvalid; ++k) p[k] = v[k];
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
    for (int k = 0; k < nvalid; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

struct ChainArgs {
  const float* g0;
  const unsigned short* M;  // (B, S, S, H, W) bf16 bits
  const float* fix;         // null: no preserve
  void* G;                  // (T, B, H, W) f32 or bf16
  float* dfeat;
  float* dfix;
  float* tmp;
  uint4* scratch;  // (S * S, runs) runs' vectors past the resident ones
  int B, H, W, T;
  int Rr;    // runs a row
  int runs;  // B * H * Rr
  Plan p;
  int Wt;  // tile row stride, floats: kLeft + band_runs * kRun + kRight
};

// 8 bf16 (one 16-byte vector) of a row from element `first` on, zero
// outside [0, W): scalar loads
__device__ __forceinline__ uint4 row8_scalar(const unsigned short* row,
                                             int first, int W) {
  unsigned e[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int ww = first + k;
    e[k] = (unsigned)ww < (unsigned)W ? __ldg(row + ww) : 0u;
  }
  return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                    e[4] | (e[5] << 16), e[6] | (e[7] << 16));
}

// the aligned 16-byte vector of a row at element c (a multiple of 8), zero
// outside [0, W) (W a multiple of 8: a vector is all in or all out)
__device__ __forceinline__ uint4 vec8(const unsigned short* row, int c,
                                      int W) {
  return (unsigned)c < (unsigned)W
             ? __ldg(reinterpret_cast<const uint4*>(row + c))
             : make_uint4(0u, 0u, 0u, 0u);
}

// the 8 bf16 from half OFF8 on of the 16 halves of (v0, v1)
template <int OFF8>
__device__ __forceinline__ uint4 halves8(const uint4& v0, const uint4& v1) {
  const unsigned w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  unsigned o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    constexpr int j = OFF8 / 2;
    o[i] = (OFF8 % 2 == 0) ? w[j + i]
                           : __funnelshift_r(w[j + i], w[j + i + 1], 16);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The pre-shifted masks of a run (pixels w0 .. w0 + 7 of a row) for row iy
// of the window: M'_s = M_s(h - sy, w0 + k - sx), zero outside the image,
// for ix = 0 .. S-1, into q; row0 is row h - sy of the plane s = iy * S,
// the plane of ix lies ix * HW further on. Where W is a multiple of 8
// (vec), each vector is cut from two aligned 16-byte loads (the
// neighbouring runs of a warp share them in L1), all 2S issued before the
// first is used; else 8 scalar loads a vector.
template <int S, int IX>
__device__ __forceinline__ void preshift_cut(const uint4 (&v)[2 * S],
                                             uint4 (&q)[S]) {
  if constexpr (IX < S) {
    constexpr int SX = 1 - S / 2 + IX;
    constexpr int OFF8 = ((-SX) % 8 + 8) % 8;  // -SX = F + OFF8, 8 | F
    q[IX] = halves8<OFF8>(v[2 * IX], v[2 * IX + 1]);
    preshift_cut<S, IX + 1>(v, q);
  }
}

template <int S>
__device__ __forceinline__ void preshift_row(const unsigned short* row0,
                                             long long HW, int w0, int W,
                                             bool vec, uint4 (&q)[S]) {
  if (vec) {
    uint4 v[2 * S];
#pragma unroll
    for (int ix = 0; ix < S; ++ix) {
      const int sx = 1 - S / 2 + ix;
      const int off8 = ((-sx) % 8 + 8) % 8;
      const int c = w0 - sx - off8;  // a multiple of 8
      v[2 * ix] = vec8(row0 + ix * HW, c, W);
      v[2 * ix + 1] = vec8(row0 + ix * HW, c + 8, W);
    }
    preshift_cut<S, 0>(v, q);
  } else {
#pragma unroll
    for (int ix = 0; ix < S; ++ix)
      q[ix] = row8_scalar(row0 + ix * HW, w0 - (1 - S / 2 + ix), W);
  }
}

// Stages global rows row0 .. row0 + trows - 1 of the plane's image columns
// into tile columns kLeft .. kLeft + W - 1 (tile row i is row row0 + i),
// leaving the margins as they are; rows outside the B * H rows are left too
// (a run never reads them). A few loads in flight a thread.
__device__ __forceinline__ void stage_image_rows(const float* src,
                                                 float* tile, int W, int BH,
                                                 int Wt, int row0,
                                                 int trows) {
  if ((W & 3) == 0) {
    const int W4 = W >> 2;
    const int total = trows * W4;
    for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
      float4 v[4];
      int to[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
        const int row = idx / W4;
        const int gr = row0 + row;
        to[u] = -1;
        if (idx < total && gr >= 0 && gr < BH) {
          const int c4 = idx - row * W4;
          v[u] = __ldcg(reinterpret_cast<const float4*>(
                            src + (long long)gr * W) + c4);
          to[u] = row * Wt + kLeft + 4 * c4;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (to[u] >= 0) *reinterpret_cast<float4*>(tile + to[u]) = v[u];
    }
  } else {
    const int total = trows * W;
    for (int base = threadIdx.x; base < total; base += 8 * blockDim.x) {
      float v[8];
      int to[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * blockDim.x;
        const int row = idx / W;
        const int gr = row0 + row;
        to[u] = -1;
        if (idx < total && gr >= 0 && gr < BH) {
          const int c = idx - row * W;
          v[u] = __ldcg(src + (long long)gr * W + c);
          to[u] = row * Wt + kLeft + c;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (to[u] >= 0) tile[to[u]] = v[u];
    }
  }
}

// S: the shift window's side (lo = 1 - S / 2); GT: the G stack's type;
// kChunks: the plan cuts a row into chunks of runs (band_runs < Rr). Bands
// of whole rows keep their margins outside the image in every band, so
// they are zeroed once and only the image columns are staged; chunks stage
// their margins' neighbouring columns too (stage_rows).
template <int S, typename GT, bool kChunks>
__global__ void __launch_bounds__(kMaxThreads, 1)
    reverse_chain_kernel(const ChainArgs a) {
  constexpr int LO = 1 - S / 2;
  constexpr int HI = LO + S - 1;
  constexpr int SS = S * S;
  // the window of a run's row iy: tile columns from (w0 - c0) + OFF on,
  // loaded as NV aligned float4 from (w0 - c0) + A0 (c0: the band's first
  // column); pixel k, shift ix reads window element SKIP + k - ix + S - 1
  constexpr int OFF = kLeft - HI;
  constexpr int A0 = OFF & ~3;
  constexpr int SKIP = OFF - A0;
  constexpr int NV = (SKIP + kRun + S - 1 + 3) / 4;
  static_assert(OFF >= 0 && A0 + 4 * NV <= kLeft + kRun + kRight,
                "the tile's margins are too narrow for S");

  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const Plan& p = a.p;
  const int r0 = blockIdx.x * p.rpb;
  const int r1 = min(r0 + p.rpb, a.runs);
  const int nrun = r1 - r0;
  const int gr0 = r0 / a.Rr;
  const int grL = (r1 - 1) / a.Rr;
  // the resident runs' vectors, [SS][p.nres], after the tile (Wt floats is
  // a multiple of 32 bytes)
  uint4* Ms = reinterpret_cast<uint4*>(
      tile + (size_t)(p.band_rows + S - 1) * a.Wt);
  const int BH = a.B * a.H;
  const long long HW = (long long)a.H * a.W;
  const bool vec = (a.W % kRun) == 0;

  if constexpr (!kChunks) {  // the margins, zero in every band
    const int rows = min(p.band_rows, grL - gr0 + 1) + S - 1;
    const int margin = a.Wt - a.W;
    for (int i = threadIdx.x; i < rows * margin; i += blockDim.x) {
      const int row = i / margin;
      const int c = i - row * margin;
      tile[row * a.Wt + (c < kLeft ? c : a.W + c)] = 0.f;
    }
  }

  // the pre-shifted masks of the owned runs
  for (int j = threadIdx.x; j < nrun; j += blockDim.x) {
    const int r = r0 + j;
    const int gr = r / a.Rr;
    const int b = gr / a.H;
    const int h = gr - b * a.H;
    const int w0 = (r - gr * a.Rr) * kRun;
#pragma unroll 1
    for (int iy = 0; iy < S; ++iy) {
      const int hh = h - (LO + iy);
      const int s0 = iy * S;
      uint4 q[S];
      if ((unsigned)hh < (unsigned)a.H) {
        preshift_row<S>(
            a.M + ((long long)b * SS + s0) * HW + (long long)hh * a.W, HW, w0,
            a.W, vec, q);
      } else {
#pragma unroll
        for (int ix = 0; ix < S; ++ix) q[ix] = make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int ix = 0; ix < S; ++ix) {
        if (j < p.nres)
          Ms[(s0 + ix) * p.nres + j] = q[ix];
        else
          a.scratch[(size_t)(s0 + ix) * a.runs + r] = q[ix];
      }
    }
  }

  cg::grid_group grid = cg::this_grid();
  const long long plane = (long long)BH * a.W;
  const float* src = a.g0;
  for (int i = 0; i < a.T; ++i) {
    const int t = a.T - 1 - i;
    float* dst = ((a.T - 1 - i) % 2 == 0) ? a.dfeat : a.tmp;
    GT* Gt = static_cast<GT*>(a.G) + (long long)t * plane;
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
        // this step's gg rows ra - HI .. rb - 1 - LO (tile row 0 is row
        // ra - HI), from L2: other blocks wrote them
        if constexpr (kChunks)
          stage_rows(src, nullptr, tile, a.W, BH, a.Wt, ra - HI,
                     rb - ra + S - 1, c0 - kLeft);
        else
          stage_image_rows(src, tile, a.W, BH, a.Wt, ra - HI,
                           rb - ra + S - 1);
        staged = true;
        __syncthreads();
        // the tile's place of global row 0, image column 0
        const float* band = tile + (HI - ra) * a.Wt - c0;
        for (int r = fa + threadIdx.x; r < fb; r += blockDim.x) {
          const int j = r - r0;
          const int gr = r / a.Rr;
          const int b = gr / a.H;
          const int h = gr - b * a.H;
          const int w0 = (r - gr * a.Rr) * kRun;
          float acc[kRun];
#pragma unroll
          for (int k = 0; k < kRun; ++k) acc[k] = 0.f;
          const float* wrow = band + (gr - LO) * a.Wt + w0 + A0;
          // the run's vectors of shift s: resident ones in shared memory,
          // the rest from the scratch stack (written in the layout pass,
          // read back from L2); the next window row's vectors are loaded
          // ahead of the sums
          const uint4* mv0 = j < p.nres ? Ms + j : a.scratch + r;
          const size_t mstride =
              j < p.nres ? (size_t)p.nres : (size_t)a.runs;
          uint4 mv[S];
#pragma unroll
          for (int ix = 0; ix < S; ++ix) mv[ix] = mv0[ix * mstride];
#pragma unroll
          for (int iy = 0; iy < S; ++iy) {
            float win[4 * NV];
            if ((unsigned)(h - (LO + iy)) < (unsigned)a.H) {
              const float4* wp =
                  reinterpret_cast<const float4*>(wrow - iy * a.Wt);
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
              for (int ix = 0; ix < S; ++ix)
                nx[ix] = mv0[((iy + 1) * S + ix) * mstride];
            }
#pragma unroll
            for (int ix = 0; ix < S; ++ix) {
              const float m[kRun] = {lo_bf16(mv[ix].x), hi_bf16(mv[ix].x),
                                     lo_bf16(mv[ix].y), hi_bf16(mv[ix].y),
                                     lo_bf16(mv[ix].z), hi_bf16(mv[ix].z),
                                     lo_bf16(mv[ix].w), hi_bf16(mv[ix].w)};
#pragma unroll
              for (int k = 0; k < kRun; ++k)
                acc[k] = __fadd_rn(
                    acc[k], __fmul_rn(m[k], win[SKIP + k - ix + S - 1]));
            }
            if (iy + 1 < S) {
#pragma unroll
              for (int ix = 0; ix < S; ++ix) mv[ix] = nx[ix];
            }
          }
          const int nvalid = min(kRun, a.W - w0);
          const long long c = (long long)gr * a.W + w0;
          const float* own = band + gr * a.Wt + w0 + kLeft;
          float g[kRun];
#pragma unroll
          for (int k = 0; k < kRun; ++k) g[k] = own[k];
          store_run(Gt + c, g, vec, nvalid);
          if (a.fix) {
            for (int k = 0; k < nvalid; ++k) {
              if (a.fix[c + k] > 0.f) {
                a.dfix[c + k] = __fadd_rn(a.dfix[c + k], acc[k]);
                acc[k] = 0.f;
              }
            }
          }
          store_run(dst + c, acc, vec, nvalid);
        }
      }
    }
    if (i + 1 < a.T) grid.sync();  // the plane is whole; the tile is free
    src = dst;
  }
}

// One cooperative launch of the chain on plan a.p.
template <int S, typename GT>
int launch_chain(const ChainArgs& a, cudaStream_t stream) {
  auto k = a.p.band_runs < a.Rr ? reverse_chain_kernel<S, GT, true>
                                : reverse_chain_kernel<S, GT, false>;
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

// the plan of the reverse chain: a band stages S - 1 halo rows (above
// its rows: hi of them, below: -lo), a resident run keeps S * S
// pre-shifted 16-byte vectors
bool reverse_plan(int B, int H, int W, int S, int sms, int smem_max,
                  Plan* p) {
  return chain_plan(B, H, W, S - 1, S * S * 16, sms, smem_max, p);
}

template <typename GT>
int launch_s(const ChainArgs& a, int S, cudaStream_t stream) {
  switch (S) {
    case 4: return launch_chain<4, GT>(a, stream);
    case 6: return launch_chain<6, GT>(a, stream);
    case 8: return launch_chain<8, GT>(a, stream);
    case 10: return launch_chain<10, GT>(a, stream);
    case 12: return launch_chain<12, GT>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// g0, dfeat, tmp: (B, H, W) f32; M: (B, S, S, H, W) bf16; G: (T, B, H, W),
// f32 (g_bf16 = 0) or bf16; fix, dfix: (B, H, W) f32, both null without
// preserve, dfix zeroed by the caller; scratch: S * S * B * H * ceil(W / 8)
// 16-byte vectors, 16-byte aligned; all contiguous. S is 4, 6, 8, 10 or 12 and
// lo = 1 - S / 2 (the shift window of a clamp radius R = S / 2 - 2).
// Runs T >= 1 steps in one cooperative launch, the last writing dfeat (tmp
// is the other plane of the ping-pong). Returns the launch's cudaError_t.
extern "C" int nlspn_reverse_chain(const void* g0, const void* M,
                                   const void* fix, void* G, void* dfeat,
                                   void* dfix, void* tmp, void* scratch,
                                   int g_bf16, int B, int H, int W, int S,
                                   int lo, int T, void* stream) {
  if (T < 1 || lo != 1 - S / 2 || S % 2) return (int)cudaErrorInvalidValue;
  int sms = 0, smem_max = 0;
  const int e = card(&sms, &smem_max);
  if (e != 0) return e;
  ChainArgs a = {};
  if (!reverse_plan(B, H, W, S, sms, smem_max, &a.p))
    return (int)cudaErrorInvalidValue;
  a.g0 = static_cast<const float*>(g0);
  a.M = static_cast<const unsigned short*>(M);
  a.fix = static_cast<const float*>(fix);
  a.G = G;
  a.dfeat = static_cast<float*>(dfeat);
  a.dfix = static_cast<float*>(dfix);
  a.tmp = static_cast<float*>(tmp);
  a.scratch = static_cast<uint4*>(scratch);
  a.B = B;
  a.H = H;
  a.W = W;
  a.T = T;
  a.Rr = (W + kRun - 1) / kRun;
  a.runs = B * H * a.Rr;
  a.Wt = kLeft + a.p.band_runs * kRun + kRight;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return g_bf16 ? launch_s<__nv_bfloat16>(a, S, st)
                : launch_s<float>(a, S, st);
}

// The plan of a (B, H, W) reverse chain with an S x S window on a card of
// `sms` SMs and `smem_max` bytes of shared memory a block, as
// nlspn_reverse_chain takes it: out = (blocks, threads, runs a block,
// resident runs, band rows, band runs, shared bytes). Returns 0, or
// cudaErrorInvalidValue where no plan fits.
extern "C" int nlspn_reverse_chain_plan(int B, int H, int W, int S, int sms,
                                        int smem_max, int* out) {
  Plan p;
  if (!reverse_plan(B, H, W, S, sms, smem_max, &p))
    return (int)cudaErrorInvalidValue;
  const int v[7] = {p.blocks, p.threads, p.rpb, p.nres, p.band_rows,
                    p.band_runs, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
