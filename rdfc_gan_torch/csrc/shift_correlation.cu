// Shift correlation of the NLSPN backward (the mask gradient), for sm_90a.
//
// Replaces rdfc_gan_tpu/ops/pallas/mask_kernel.py:_corr_kernel (reached
// through shift_correlation, phase 2 of the two-phase O(T) backward):
//
//     dM[b, iy * S + ix, h, w] = sum_t G[t, b, h, w] * X[t, b, h + lo + iy,
//                                                       w + lo + ix]
//
// with X zero outside the image and lo = 1 - S / 2. G and X are f32 or bf16
// (one type for both); the sum is f32, in order t = 0 .. T-1, with the
// multiply and the add rounded separately, as the plain version's, so the
// two agree bit for bit. dM is stored in the type the caller asks for, f32
// or bf16 (the f32 sum rounded once, to nearest even, as a cast would).
//
// What bounds it on an H100: bytes, with the f32 pipe close behind. It has
// to read the two (T, B, H, W) stacks once and write S^2 planes: at
// 4 x 224 x 304, T = 18, S = 8 with bf16 stacks, 19.6 MB in and 69.7 MB out
// in f32 (34.9 MB in bf16), 27 (16) us at 3.35 TB/s. The sums are a
// multiply and an add (no FMA: the plain version rounds both) for each of
// T S^2 terms a pixel, 628 M instructions, about 19 us of the card's f32
// issue rate.
//
// Design: a block owns a tile of 8 rows x 32 columns of one image and all
// S^2 shifts. For each t in order it stages G[t]'s tile and X[t]'s tile
// with its S - 1 halo rows and columns (zeros outside the image) in shared
// memory, in the stacks' own type, through a ring of nine cp.async slots of
// 16-byte copies, and sums three steps between two barriers: the copies of
// the next six steps are in flight while three are summed. So G and X are
// read from HBM about once; only the halo is read again, from L2. A
// thread's copies are the same every step but for the plane, so their
// addresses are worked out once. A thread owns a run of 4 consecutive
// pixels of a row and 2 window rows iy, 4 x S x 2 f32 accumulators held in
// registers for all T steps. For each of its iy it reads the 4 + S - 1
// values of X its run needs once (16-byte vectors in f32, 8-byte in bf16,
// widened at the read; a warp's reads are conflict-free) and forms all
// 4 x S products from registers. At the end it writes its 2 S runs of dM,
// 16 bytes (f32) or 8 bytes (bf16) a run where W is a multiple of 4, else
// value by value; a warp's stores cover four rows of 128 (64) contiguous
// bytes. An X outside the image is a staged zero that is still multiplied,
// so a non-finite G gives a NaN there, as in the plain version. A copy
// starts at a multiple of 4 (f32) or 8 (bf16) values, so the X tile starts
// up to 7 columns before the window's first; stacks whose W is not such a
// multiple (rows not 16-byte aligned) are staged value by value.
//
// Where the time goes (PERF.md): instruction issue. The sums' separately
// rounded multiplies and adds share the issue slots with the shared-memory
// reads, the bf16 widening, the copies and the barriers; the copies are
// 16 bytes, their addresses worked out once and the barriers one in three
// steps so that the copies' latency stays hidden.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;    // output rows a block
constexpr int kTileW = 32;   // output columns a block
constexpr int kRun = 4;      // consecutive pixels of a row a thread
constexpr int kRows = 2;     // window rows iy a thread
constexpr int kStages = 9;   // slots of the cp.async ring over t, a step each
constexpr int kBatch = 3;    // steps summed between two barriers
constexpr int kAhead = kStages - kBatch;  // steps in flight ahead
constexpr int kRunsRow = kTileW / kRun;

__host__ __device__ constexpr int threads_of(int S) {
  return kRunsRow * kTileH * (S / kRows);
}

// values of a 16-byte copy
template <typename TS>
__host__ __device__ constexpr int chunk() {
  return 16 / (int)sizeof(TS);
}

// The X tile starts e_of columns before the window's first column
// w0 + lo, at a multiple of a copy (w0 is a multiple of 32).
template <int S, typename TS>
__host__ __device__ constexpr int e_of() {
  return ((1 - S / 2) % chunk<TS>() + chunk<TS>()) % chunk<TS>();
}

// columns of an X tile row: e_of, the tile's 32 and S - 1 of halo, rounded
// up to whole copies
template <int S, typename TS>
__host__ __device__ constexpr int x_cols() {
  return (e_of<S, TS>() + kTileW + S - 1 + chunk<TS>() - 1) / chunk<TS>() *
         chunk<TS>();
}

// row stride of the X tile, values. bf16: 96, so the two rows that a
// half-warp's 8-byte reads touch lie 64 bytes apart on the banks
template <int S, typename TS>
__host__ __device__ constexpr int x_stride() {
  return sizeof(TS) == 4 ? x_cols<S, TS>() : 96;
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 4 consecutive values of a shared row, widened to f32: one aligned 16-byte
// (f32) or 8-byte (bf16 bits) read
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(const unsigned short* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// a run's 4 values: one 16-byte (f32) or 8-byte (bf16) store (vec), else n
// scalars
__device__ __forceinline__ void store_run(float* p, const float (&v)[kRun],
                                          bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < n) p[k] = v[k];
  }
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p,
                                          const float (&v)[kRun], bool vec,
                                          int n) {
  if (vec) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                   bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < n) p[k] = __float2bfloat16_rn(v[k]);
  }
}

// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A ring slot holds a step's G tile (rows h0 .. h0 + 7, columns w0 ..
// w0 + 31, row stride kTileW) and then its X tile (rows from h0 + lo,
// columns from x0, row stride x_stride); zero outside the image.
template <int S, typename TS>
__host__ __device__ constexpr int slot_size() {
  return kTileH * kTileW + (kTileH + S - 1) * x_stride<S, TS>();
}

// A thread's 16-byte copies of a step into a slot, where W is a multiple of
// a copy (rows 16-byte aligned; x0 is a multiple of one). They are the same
// for every step but for the step's plane, so they are worked out once.
template <int S, typename TS>
struct Copies {
  static constexpr int V = chunk<TS>();      // values a copy
  static constexpr int NG = kTileH * kTileW / V;  // copies of a G tile
  static constexpr int XU = x_cols<S, TS>() / V;  // copies of an X row
  static constexpr int NC = NG + (kTileH + S - 1) * XU;
  static constexpr int N = (NC + threads_of(S) - 1) / threads_of(S);
  const TS* src[N];  // the copy's source in step 0; zeros: the stack
  int dst[N];        // its place in a slot; -1: none
  int bytes[N];      // 16, or 0 for zeros (outside the image)

  __device__ __forceinline__ Copies(const TS* G, const TS* X, long long off,
                                    int H, int W, int h0, int w0, int x0) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * threads_of(S);
      const bool is_g = i < NG;
      const int j = is_g ? i : i - NG;
      const int per_row = is_g ? kTileW / V : XU;
      const int r = j / per_row;
      const int c = (j - r * per_row) * V;
      const int y = is_g ? h0 + r : h0 + 1 - S / 2 + r;
      const int x = is_g ? w0 + c : x0 + c;
      const bool in = (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W;
      const TS* base = is_g ? G : X;
      src[u] = in ? base + off + (long long)y * W + x : base;
      bytes[u] = in ? 16 : 0;
      dst[u] = i >= NC ? -1
               : is_g  ? r * kTileW + c
                       : kTileH * kTileW + r * x_stride<S, TS>() + c;
    }
  }

  // step t's copies into `slot`; `plane` values a step
  __device__ __forceinline__ void issue(TS* slot, int t,
                                        long long plane) const {
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (dst[u] >= 0)
        cp_async16(slot + dst[u], bytes[u] ? src[u] + t * plane : src[u],
                   bytes[u]);
  }
};

// Stages step t's tiles into a slot value by value (W not a multiple of a
// copy); `off` is the offset of image b in the step's plane.
template <int S, typename TS>
__device__ __forceinline__ void stage_values(const TS* __restrict__ G,
                                             const TS* __restrict__ X,
                                             long long off, int H, int W,
                                             int h0, int w0, int x0,
                                             TS* slot) {
  constexpr int NT = threads_of(S);
  constexpr int XR = kTileH + S - 1;
  constexpr int XC = x_cols<S, TS>();
  constexpr int XS = x_stride<S, TS>();
  TS* xs = slot + kTileH * kTileW;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += NT) {
    const int r = i / kTileW;
    const int c = i - r * kTileW;
    const int h = h0 + r;
    const int w = w0 + c;
    slot[i] = h < H && w < W ? G[off + (long long)h * W + w] : TS(0);
  }
  for (int i = threadIdx.x; i < XR * XC; i += NT) {
    const int r = i / XC;
    const int c = i - r * XC;
    const int y = h0 + 1 - S / 2 + r;
    const int x = x0 + c;
    xs[r * XS + c] = (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W
                         ? X[off + (long long)y * W + x]
                         : TS(0);
  }
}

// One step's sums of a thread: its run (tile row hl, columns wl .. wl + 3)
// and window rows iy0, iy0 + 1. X tile column E + wl + k + ix holds the
// value that pixel k, shift ix reads.
template <int S, typename TS>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][S][kRun],
                                           const TS* gs, const TS* xs, int hl,
                                           int wl, int iy0) {
  constexpr int E = e_of<S, TS>();
  constexpr int XS = x_stride<S, TS>();
  constexpr int NV = (E + kRun + S - 1 + 3) / 4;
  static_assert(kTileW - kRun + 4 * NV <= x_cols<S, TS>(),
                "a run's window passes the X tile");
  float g[kRun];
  load4(gs + hl * kTileW + wl, g);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const TS* row = xs + (hl + iy0 + j) * XS + wl;
    float win[4 * NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) load4(row + 4 * v, win + 4 * v);
#pragma unroll
    for (int ix = 0; ix < S; ++ix) {
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        acc[j][ix][k] =
            __fadd_rn(acc[j][ix][k], __fmul_rn(g[k], win[E + k + ix]));
    }
  }
}

// S: the window's side (lo = 1 - S / 2); TS: the stacks' storage (float,
// or unsigned short for bf16 bits); OT: dM's type.
template <int S, typename TS, typename OT>
__global__ void __launch_bounds__(threads_of(S), S <= 8 ? 2 : 1)
    corr_kernel(const TS* __restrict__ G, const TS* __restrict__ X,
                OT* __restrict__ dM, int T, int B, int H, int W, bool async) {
  constexpr int LO = 1 - S / 2;
  constexpr int E = e_of<S, TS>();
  __shared__ __align__(16) TS ring[kStages][slot_size<S, TS>()];
  const int wl = threadIdx.x % kRunsRow * kRun;
  const int hl = threadIdx.x / kRunsRow % kTileH;
  const int iy0 = threadIdx.x / (kRunsRow * kTileH) * kRows;
  const int w0 = blockIdx.x * kTileW;
  const int h0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const int x0 = w0 + LO - E;
  const long long HW = (long long)H * W;
  const long long plane = (long long)B * HW;
  const Copies<S, TS> copies(G, X, b * HW, H, W, h0, w0, x0);
  // step t into its slot, or nothing past the last step; one group a call
  auto stage = [&](int t) {
    if (t < T) {
      if (async)
        copies.issue(ring[t % kStages], t, plane);
      else
        stage_values<S>(G, X, t * plane + b * HW, H, W, h0, w0, x0,
                        ring[t % kStages]);
    }
    cp_async_commit();
  };
  float acc[kRows][S][kRun];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int ix = 0; ix < S; ++ix)
#pragma unroll
      for (int k = 0; k < kRun; ++k) acc[j][ix][k] = 0.f;

#pragma unroll
  for (int t = 0; t < kAhead; ++t) stage(t);
  for (int t0 = 0; t0 < T; t0 += kBatch) {
    cp_async_wait<kAhead - kBatch>();  // steps t0 .. t0 + kBatch - 1 landed
    __syncthreads();  // ... for every thread; the previous batch was read
#pragma unroll
    for (int u = 0; u < kBatch; ++u) stage(t0 + kAhead + u);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u;
      if (t < T) {
        const TS* slot = ring[t % kStages];
        accumulate<S>(acc, slot, slot + kTileH * kTileW, hl, wl, iy0);
      }
    }
  }

  const int h = h0 + hl;
  const int w = w0 + wl;
  if (h >= H || w >= W) return;
  const bool vec = W % kRun == 0;
  const int n = min(kRun, W - w);
  OT* out = dM + ((long long)b * S * S + iy0 * S) * HW + (long long)h * W + w;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int ix = 0; ix < S; ++ix)
      store_run(out + (j * S + ix) * HW, acc[j][ix], vec, n);
}

template <int S, typename TS, typename OT>
int launch(const void* G, const void* X, void* dM, int T, int B, int H,
           int W, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const bool async = W % chunk<TS>() == 0;
  corr_kernel<S, TS, OT><<<grid, threads_of(S), 0, stream>>>(
      static_cast<const TS*>(G), static_cast<const TS*>(X),
      static_cast<OT*>(dM), T, B, H, W, async);
  return (int)cudaGetLastError();
}

template <typename TS, typename OT>
int launch_s(const void* G, const void* X, void* dM, int T, int B, int H,
             int W, int S, cudaStream_t stream) {
  switch (S) {
    case 4: return launch<4, TS, OT>(G, X, dM, T, B, H, W, stream);
    case 6: return launch<6, TS, OT>(G, X, dM, T, B, H, W, stream);
    case 8: return launch<8, TS, OT>(G, X, dM, T, B, H, W, stream);
    case 10: return launch<10, TS, OT>(G, X, dM, T, B, H, W, stream);
    case 12: return launch<12, TS, OT>(G, X, dM, T, B, H, W, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool valid(int B, int H, int W, int S) {
  return B >= 1 && B <= 65535 && H >= 1 && W >= 1 &&
         (H + kTileH - 1) / kTileH <= 65535 && S >= 4 && S <= 12 &&
         S % 2 == 0;
}

}  // namespace

// G, X: (T, B, H, W), f32 (in_bf16 = 0) or bf16, 16-byte aligned; dM:
// (B, S * S, H, W), f32 (out_bf16 = 0) or bf16, 16-byte aligned; all
// contiguous. S is 4, 6, 8, 10 or 12 and lo = 1 - S / 2 (the shift window
// of a clamp radius R = S / 2 - 2); T >= 1. Returns the launch's
// cudaError_t.
extern "C" int shift_correlation(const void* G, const void* X, void* dM,
                                 int T, int B, int H, int W, int S, int lo,
                                 int in_bf16, int out_bf16, void* stream) {
  if (T < 1 || lo != 1 - S / 2 || !valid(B, H, W, S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16
               ? launch_s<unsigned short, __nv_bfloat16>(G, X, dM, T, B, H,
                                                         W, S, st)
               : launch_s<unsigned short, float>(G, X, dM, T, B, H, W, S, st);
  return out_bf16
             ? launch_s<float, __nv_bfloat16>(G, X, dM, T, B, H, W, S, st)
             : launch_s<float, float>(G, X, dM, T, B, H, W, S, st);
}

// How shift_correlation cuts a (B, H, W) plane with an S x S window: out =
// (blocks along W, blocks along H, blocks along B, threads a block, tile
// rows, tile columns, pixels a thread's run, window rows a thread). Returns
// 0, or cudaErrorInvalidValue where the kernel takes no such plane.
extern "C" int shift_correlation_plan(int B, int H, int W, int S, int* out) {
  if (!valid(B, H, W, S)) return (int)cudaErrorInvalidValue;
  const int v[8] = {(W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B,
                    threads_of(S), kTileH, kTileW, kRun, kRows};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
