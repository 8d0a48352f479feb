// What the two NLSPN chain kernels share (nlspn_propagate.cu, the forward
// chains; nlspn_reverse_chain.cu, the reverse chain): the runs of 8 pixels
// a block owns, the plan that cuts a (B, H, W) chain into blocks and bands
// (nlspn_kernel.py:chain_plan is its Python mirror), and the staging of a
// band's rows of the previous step's plane into shared memory.
//
// Both chains keep, for every step, a tile of the plane: a band's rows and
// S - 1 halo rows, 8 zero columns each side. The forward reads rows
// h + lo .. h + hi of a run's row h, the reverse chain (the transpose)
// rows h - hi .. h - lo; which side the halo lies on is the kernel's
// business, the plan counts its rows. A run's masks, resident in shared
// memory where they fit, take S * S 16-byte vectors in both chains.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kRun = 8;           // pixels a run
constexpr int kLeft = 8;          // zero columns left of a band (>= the halo)
constexpr int kRight = 8;         // zero columns right of a band's runs
constexpr int kMinRuns = 32;      // runs a block, at least
constexpr int kMaxThreads = 384;  // 170 registers a thread

// How a chain is cut: `blocks` blocks of `threads` threads, `rpb` runs a
// block, the first `nres` of them with their masks resident in shared
// memory; a block takes its runs in bands of `band_rows` rows of
// `band_runs` runs (band_runs < runs a row only with band_rows == 1);
// `smem` bytes of shared memory a block.
struct Plan {
  int blocks, threads, rpb, nres, band_rows, band_runs, smem;
};

// The plan of a (B, H, W) chain on a card of `sms` SMs whose blocks may
// have `smem_max` bytes of shared memory: a band stages `halo` rows beside
// its own, and a resident run's masks take `run_bytes`. Whole rows where
// they fit, else bands of rows, else one row in chunks of runs. False for
// an empty plane, or where not even a band of one run fits (a card with
// under 1 KB a block).
inline bool chain_plan(int B, int H, int W, int halo, int run_bytes, int sms,
                       int smem_max, Plan* p) {
  const int Rr = (W + kRun - 1) / kRun;
  const long long runs = (long long)B * H * Rr;
  if (runs < 1 || sms < 1) return false;
  long long blocks = (runs + kMinRuns - 1) / kMinRuns;
  if (blocks > sms) blocks = sms;
  const long long rpb = (runs + blocks - 1) / blocks;
  p->blocks = (int)((runs + rpb - 1) / rpb);
  p->rpb = (int)rpb;
  p->threads = (int)((rpb + 31) / 32 * 32);
  if (p->threads > kMaxThreads) p->threads = kMaxThreads;
  // rows that rpb consecutive runs can span
  long long rows = (rpb + Rr - 2) / Rr + 1;
  if (rows > (long long)B * H) rows = (long long)B * H;
  const long long row_bytes = (long long)(kLeft + Rr * kRun + kRight) * 4;
  const long long fit = smem_max / row_bytes;  // tile rows at full width
  if (fit >= rows + halo) {
    p->band_rows = (int)rows;
    p->band_runs = Rr;
  } else if (fit >= halo + 1) {
    p->band_rows = (int)(fit - halo);
    p->band_runs = Rr;
  } else {
    p->band_rows = 1;
    p->band_runs = (smem_max / ((halo + 1) * 4) - kLeft - kRight) / kRun;
    if (p->band_runs < 1) return false;
  }
  const long long tile = (long long)(p->band_rows + halo) *
                         (kLeft + p->band_runs * kRun + kRight) * 4;
  long long nres = (smem_max - tile) / run_bytes;
  if (nres > rpb) nres = rpb;
  p->nres = (int)nres;
  p->smem = (int)(tile + nres * run_bytes);
  return true;
}

// The card's SM count and the shared memory a block may opt in to.
inline int card(int* sms, int* smem_max) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

__device__ __forceinline__ float substitute(float v, float f) {
  return f > 0.f ? f : v;
}

// Stages `trows` rows of the (B * H, W) plane src from global row `row0` on
// (tile row i is row row0 + i), image columns from tc0 on, Wt of them, into
// the tile (row stride Wt); zero outside the image's columns and outside
// the B * H rows (a row of another image is read but never used: a run
// checks that each window row lies in its own image). With fix (the
// forward's preserve substitution) a value is substituted as it is staged.
// A few loads in flight a thread.
__device__ __forceinline__ void stage_rows(const float* src, const float* fix,
                                           float* tile, int W, int BH,
                                           int Wt, int row0, int trows,
                                           int tc0) {
  if ((W & 3) == 0) {  // a float4 is all inside the image or all out
    const int Wt4 = Wt >> 2;
    const int total = trows * Wt4;
    for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
      float4 v[4];
      int to[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
        to[u] = -1;
        if (idx < total) {
          const int row = idx / Wt4;
          const int q = idx - row * Wt4;
          const int gr = row0 + row;
          const int col = tc0 + 4 * q;
          to[u] = row * Wt + 4 * q;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if ((unsigned)gr < (unsigned)BH && (unsigned)col < (unsigned)W) {
            const long long o = (long long)gr * W + col;
            v[u] = __ldcg(reinterpret_cast<const float4*>(src + o));
            if (fix) {
              const float4 f = __ldg(reinterpret_cast<const float4*>(
                  fix + o));
              v[u] = make_float4(substitute(v[u].x, f.x),
                                 substitute(v[u].y, f.y),
                                 substitute(v[u].z, f.z),
                                 substitute(v[u].w, f.w));
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (to[u] >= 0) *reinterpret_cast<float4*>(tile + to[u]) = v[u];
    }
  } else {
    const int total = trows * Wt;
    for (int base = threadIdx.x; base < total; base += 8 * blockDim.x) {
      float v[8];
      int to[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * blockDim.x;
        to[u] = -1;
        if (idx < total) {
          const int row = idx / Wt;
          const int c = idx - row * Wt;
          const int gr = row0 + row;
          const int col = tc0 + c;
          to[u] = idx;
          v[u] = 0.f;
          if ((unsigned)gr < (unsigned)BH && (unsigned)col < (unsigned)W) {
            const long long o = (long long)gr * W + col;
            v[u] = __ldcg(src + o);
            if (fix) v[u] = substitute(v[u], __ldg(fix + o));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (to[u] >= 0) tile[to[u]] = v[u];
    }
  }
}

}  // namespace
