// Fused 3x3 conv block kernels in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces attic/conv_block_kernel.py:_fwd_kernel (fused_conv3x3_fwd) and
// :_bwd_kernel (fused_conv3x3_bwd) for bf16 tensors; conv_block.cu keeps
// the f32 case. NCHW bf16 at the interface; C the input and Co the output
// channels; stride 1; the zero padding applies to the tensor after the
// prologue.
//
//   forward (conv3x3_bf16_fwd):
//     z = act(bf16(bf16(u * a) + b))       the prologue (or z = u)
//     y = bf16(sum over (ci, kh, kw) of z * w)       f32 sums
//     mom[b, 0, c] = sum y, mom[b, 1, c] = sum y * y  of y as stored, f64
//   backward (conv3x3_bf16_bwd), from the gradient g of y (or of the BN
//   that follows it, with that BN's finalize rows A, C1, C2, MU, IS):
//     dy = bf16((A * g - C1) - ((y - MU) * IS) * C2)  (or dy = g)
//     gm = [pre-activation of the prologue > 0] * convT(dy, w)   (f32)
//     gout = bf16(gm + carry)
//     dW = sum over (b, h, w) of z * dy                (f32)
//     sums[b, 0, c] = sum gm, sums[b, 1, c] = sum gm * ((u - mu) * is)
//
// What bounds it on an H100: operations. The conv does 2 * 9 * C * Co
// operations a pixel; the TPU kernel ran them as nine shifted bf16 MXU
// matmuls with f32 accumulation, and so does this one, on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 sums). The products are exact in f32;
// only the order of the f32 adds differs from the plain versions (which
// sum in f64), so the results agree with them to a stated tolerance, not
// bit for bit (ops/kernels/conv_block_kernel.py: Y_ULPS, Y_SUM_RTOL,
// MOM_RTOL, SUM_RTOL).
//
// Design.
//   A first pass writes the conv's input channels-last (NHWC, channels
// zero-padded to a multiple of 64) with the prologue applied: z for the
// forward and the weight gradient, dy (the BN finalize applied) for the
// data and weight gradients. The prologue is then computed once an element
// and not once a block of output channels, and the conv kernels stage
// their tiles with plain cp.async copies of 16 bytes (8 channels of a
// pixel). Outside the image cp.async fills zeros, which is right because
// the prologue has already been applied: prologue(0) = relu(b) is not 0,
// so the zero padding belongs to z, not to u.
//   Both convolutions (the forward and the data gradient, the same kernel
// on the flipped weights) are implicit GEMMs: a block computes M = 256
// output pixels (a 16 x 16 tile) by N = 64 output channels, over K = 9
// taps x C walked in chunks of 16 input channels through a ring of three
// cp.async stages. A chunk holds one halo tile of z (18 x 18 pixels) as
// [pixel][channel] and the chunk's weights K-major ([tap][co][ci], packed
// once a call from the f32 weights by pack_kernel). The nine taps read the
// halo as shifted windows: an ldmatrix row address may point at any pixel,
// so the A fragments come from the window without an im2col copy. A warp
// computes four tile rows by 32 channels; for each column shift it loads
// the B fragments of the three row taps, then each of the six halo rows
// once (the next while the tensor cores work on this one), which serves
// every tap that reads it. The halo's rows are padded by 16 bytes and the
// weights XOR-swizzled by 16-byte piece, so that the eight rows of an
// ldmatrix land in eight different bank groups for any window shift, and
// every ldmatrix address is a per-lane base plus a constant.
//   Why mma.sync and not wgmma: wgmma takes A from shared memory only
// through a descriptor of a canonical layout, which a shifted window is
// not, so A would come from registers in either case; mma.sync with
// ldmatrix does that in the simplest form, and it meets the target: the
// two kernels take about 1.5x and 1.6x cuDNN's bf16 time on an H100
// (PERF.md), at 14-15% of the card's bf16 peak.
//   The epilogue stages the f32 tile in shared memory as [channel][pixel]
// and a warp walks one channel row at a time, two pixels a lane: the
// forward rounds to bf16, stores y (NCHW) and sums y and y * y of the
// stored values in f64; the data gradient applies act' (from u, a, b),
// adds the carry, stores gout and sums BN1's gm and gm * xhat(u). Each
// block writes its per-(b, c) partials, and a second kernel adds them over
// the tiles in a fixed order: no float atomics, the same result on every
// run. No f32 gm tensor is written.
//   The weight gradient is a GEMM with M = Co (64 a block), N = 9 taps x
// 32 input channels, K = the pixels, split over ranges of 8 x 16 pixel
// tiles so that about two blocks an SM run; each tile stages dy as
// [pixel][co] and the halo of z as above (three cp.async stages), and the
// taps read shifted windows of z through ldmatrix.trans. Each split writes
// f32 partials, which a second kernel adds in a fixed order (in f64,
// rounded once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
// forward and data gradient: a 16 x 16 output pixel tile (M = 256) of 64
// output channels (N), input channels staged 16 at a time (one k16 step)
constexpr int kTH = 16, kTW = 16;
constexpr int kKC = 16;
constexpr int kBN = 64;
constexpr int kStages = 3;
constexpr int kStg = kTH * kTW + 4;            // epilogue row (floats)
// weight gradient: an 8 x 16 pixel tile (K = 128), 64 co x 32 ci
constexpr int kWTH = 8, kWTW = 16;
constexpr int kWKC = 32;
constexpr int kWPix = kWTH * kWTW;

// The halo tile of z that a TH x TW output tile reads, KC channels deep,
// as [pixel][channel] rows padded by 16 bytes: a row of 48 or 80 bytes is
// an odd number of 16-byte bank groups, so the eight rows of an ldmatrix
// (eight consecutive pixels, any window shift) fall in eight different
// groups, and every ldmatrix address is a per-thread base plus a constant.
template <int TH, int TW, int KC>
struct Halo {
  static constexpr int kCols = TW + 2;
  static constexpr int kPixels = (TH + 2) * kCols;
  static constexpr int kRow = KC + 8;
  static constexpr int kElems = kPixels * kRow;
};
typedef Halo<kTH, kTW, kKC> ConvHalo;
typedef Halo<kWTH, kWTW, kWKC> WgradHalo;

constexpr int kWElems = 9 * kBN * kKC;         // bf16 of a weight stage
constexpr int kConvStages = kStages * (ConvHalo::kElems + kWElems) * 2;
constexpr int kConvSmem =
    kConvStages > kBN * kStg * 4 ? kConvStages : kBN * kStg * 4;
constexpr int kDRow = kBN + 8;                 // dy rows: 144 bytes
constexpr int kDElems = kWPix * kDRow;         // bf16 of a dy stage
constexpr int kWgradSmem = kStages * (WgradHalo::kElems + kDElems) * 2;

// prologue modes (1, affine without ReLU: z = bf16(bf16(u * at) + bt))
constexpr int kIdentity = 0;   // z = u
constexpr int kAffineRelu = 2; // z = relu(bf16(bf16(u * at) + bt))

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float pre_act(float u, float at, float bt,
                                         int mode) {
  if (mode == kIdentity) return u;
  return round_bf16(__fadd_rn(round_bf16(__fmul_rn(u, at)), bt));
}

// Offset (in bf16) of the 16-byte piece q (0 or 1) of row `row` of the
// [tap * kBN + co][16] weight stage, swizzled so that the eight rows of an
// ldmatrix (eight consecutive rows from a multiple of 8) land in eight
// different 16-byte bank groups: the piece flips every 4 rows.
__device__ __forceinline__ int sw16(int row, int q) {
  return row * 16 + ((q ^ ((row >> 2) & 1)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(const void* p, uint32_t& r0,
                                          uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p)));
}

// d += a * b: one m16n8k16 tensor-core product, bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory; zeros when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------ channels-last --
// f(x) of one element (b, c, p) of the channels-last pass
template <bool kFinalize>
__device__ __forceinline__ float nhwc_value(float x, const bf16* y,
                                            long long idx, const float* rows,
                                            const float* pa, const float* pb,
                                            int mode, int c, int C) {
  if (kFinalize) {
    if (!rows) return x;
    const float xh = __fmul_rn(__fsub_rn(bf2f(y[idx]), rows[3 * C + c]),
                               rows[4 * C + c]);
    const float s = __fsub_rn(__fmul_rn(rows[c], x), rows[C + c]);
    return round_bf16(__fsub_rn(s, __fmul_rn(xh, rows[2 * C + c])));
  }
  const float v = pre_act(x, mode ? round_bf16(pa[c]) : 0.f,
                          mode ? round_bf16(pb[c]) : 0.f, mode);
  return mode == kAffineRelu ? fmaxf(v, 0.f) : v;
}

// out[b, p, c] (p = h W + w, channel stride CP) = f(b, c, p) for c < C and
// 0 for C <= c < CP: the prologue of in (u), or with kFinalize the BN
// finalize of in (g) and y with rows = (A, C1, C2, MU, IS), or in itself
// without rows. A block transposes 64 channels x 64 pixels through shared
// memory, reading 8 pixels of a channel and writing 8 channels of a pixel
// at a time (16 bytes; the reads one by one where HW is not a multiple of
// 8).
template <bool kFinalize>
__global__ void __launch_bounds__(kThreads)
    to_nhwc_kernel(const bf16* __restrict__ in, const bf16* __restrict__ y,
                   const float* __restrict__ rows,
                   const float* __restrict__ pa,
                   const float* __restrict__ pb, int mode,
                   bf16* __restrict__ out, int C, int CP, int HW) {
  __shared__ __align__(16) unsigned short t[64][72];
  const int p0 = blockIdx.x * 64, c0 = blockIdx.y * 64, b = blockIdx.z;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(in);
  const bool vec = (HW & 7) == 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int cc = i >> 3, pp = (i & 7) * 8, c = c0 + cc, p = p0 + pp;
    const long long idx = ((long long)b * C + c) * HW + p;
    uint32_t raw[4] = {0, 0, 0, 0};
    if (c < C && vec && p < HW) {
      const uint4 x = *reinterpret_cast<const uint4*>(src + idx);
      raw[0] = x.x;
      raw[1] = x.y;
      raw[2] = x.z;
      raw[3] = x.w;
    } else if (c < C) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (p + j < HW)
          raw[j >> 1] |= (uint32_t)src[idx + j] << (16 * (j & 1));
    }
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pair = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = 2 * j + e;
        float v = 0.f;
        if (c < C && p + jj < HW)
          v = nhwc_value<kFinalize>(__uint_as_float(
                                        ((raw[j] >> (16 * e)) & 0xffffu)
                                        << 16),
                                    y, idx + jj, rows, pa, pb, mode, c, C);
        pair |= (__float_as_uint(v) >> 16) << (16 * e);  // a bf16 value
      }
      o[j] = pair;
    }
    *reinterpret_cast<uint4*>(&t[cc][pp]) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int cq = i >> 6, pp = i & 63, p = p0 + pp;
    if (p >= HW) continue;
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = t[8 * cq + 2 * j][pp] |
             ((uint32_t)t[8 * cq + 2 * j + 1][pp] << 16);
    *reinterpret_cast<uint4*>(out + ((long long)b * HW + p) * CP + c0 +
                              8 * cq) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// -------------------------------------------- forward and data gradient --
struct ConvArgs {
  const bf16* in;    // (B, H, W, CinP) channels-last, zero past Cin
  const bf16* wk;    // (9, Cout, CinP) packed weights, zero past Cin
  int B, CinP, Cout, H, W, tiles_w;
  bf16* out;         // (B, Cout, H, W): y, or gout
  double* part;      // (B * tiles, 2, Cout) per-tile partials, or null
  // the data gradient's epilogue (the forward's op, Cout = its C)
  const bf16* u;     // its input (NCHW)
  const float* ua;   // its prologue rows and mode: act' comes from them
  const float* ub;
  int umode;
  const bf16* carry; // or null
  const float* mu;   // (Cout,) BN1's mean and inverse std, for the sums
  const float* is;
};

// kDgrad = false: y = bf16(acc), partials of (sum y, sum y * y);
// kDgrad = true: gm = act'(u) * acc, gout = bf16(gm + carry), partials of
// (sum gm, sum gm * xhat(u)).
template <bool kDgrad>
__global__ void __launch_bounds__(kThreads, 2) conv_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* zs = reinterpret_cast<bf16*>(smem);   // [kStages][ConvHalo::kElems]
  bf16* ws = zs + kStages * ConvHalo::kElems;  // [kStages][kWElems]
  float* stg = reinterpret_cast<float*>(smem);  // the epilogue's tile
  const int tile = blockIdx.x, n0 = blockIdx.y * kBN, b = blockIdx.z;
  const int th0 = (tile / a.tiles_w) * kTH, tw0 = (tile % a.tiles_w) * kTW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3;   // tile rows 4 wm .. 4 wm + 3
  const int wn = warp >> 2;  // output channels 32 wn .. 32 wn + 31
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row and matrix
  // this lane's ldmatrix row addresses, less constant offsets: A rows are
  // pixel lr (+ 8 for matrices 1, 3) of the warp's first halo row, piece
  // lm / 2; B rows are co 32 wn + 8 (lm / 2) + lr (+ 16 jj), piece lm % 2
  // (the swizzle of sw16 depends on lr alone)
  const int a_base =
      (4 * wm * ConvHalo::kCols + lr + ((lm & 1) << 3)) * ConvHalo::kRow +
      ((lm >> 1) << 3);
  const int w_base = (wn * 32 + ((lm >> 1) << 3) + lr) * kKC +
                     (((lm & 1) ^ ((lr >> 2) & 1)) << 3);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // chunk kc (input channels 16 kc ..) into stage kc % kStages: the halo
  // (2 pieces a pixel) and the weights (9 * kBN rows of 2 pieces)
  auto issue = [&](int kc) {
    const int s = kc % kStages;
    bf16* zd = zs + s * ConvHalo::kElems;
    bf16* wd = ws + s * kWElems;
    const int c0 = kc * kKC;
    for (int i = tid; i < ConvHalo::kPixels * 2; i += kThreads) {
      const int p = i >> 1, q = i & 1;
      const int h = th0 - 1 + p / ConvHalo::kCols;
      const int w = tw0 - 1 + p % ConvHalo::kCols;
      const bool ok = h >= 0 && h < a.H && w >= 0 && w < a.W;
      const bf16* src =
          a.in + (((long long)b * a.H + (ok ? h : 0)) * a.W + (ok ? w : 0)) *
                     a.CinP + c0 + q * 8;
      cp_async16(zd + p * ConvHalo::kRow + q * 8, src, ok);
    }
    for (int i = tid; i < 9 * kBN * 2; i += kThreads) {
      const int q = i & 1, row = i >> 1;  // row = tap * kBN + n
      const int tap = row / kBN, n = n0 + row % kBN;
      const bool ok = n < a.Cout;
      const bf16* src = a.wk + ((long long)tap * a.Cout + (ok ? n : 0)) *
                                   a.CinP + c0 + q * 8;
      cp_async16(wd + sw16(row, q), src, ok);
    }
  };

  const int nk = a.CinP / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<kStages - 2>();
    __syncthreads();  // chunk kc arrived; the stage of kc - 1 is free
    if (kc + kStages - 1 < nk) issue(kc + kStages - 1);
    cp_commit();
    const int s = kc % kStages;
    const bf16* z = zs + s * ConvHalo::kElems;
    const bf16* wt = ws + s * kWElems;
    // for each column shift kw: the B fragments of the three taps (kh, kw),
    // then each of the six halo rows a warp's four tile rows reach, loaded
    // once (the next one while the tensor cores work on this one) and used
    // by every tap that reads it (output row 4 wm + i reads halo row
    // 4 wm + i + kh)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      uint32_t bfr[3][4][2];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t t4[4];
          ldsm_x4(wt + w_base + ((kh * 3 + kw) * kBN + 16 * jj) * kKC, t4);
          bfr[kh][2 * jj][0] = t4[0];
          bfr[kh][2 * jj][1] = t4[1];
          bfr[kh][2 * jj + 1][0] = t4[2];
          bfr[kh][2 * jj + 1][1] = t4[3];
        }
      uint32_t af[2][4];
      ldsm_x4(z + a_base + kw * ConvHalo::kRow, af[0]);
#pragma unroll
      for (int hr = 0; hr < 6; ++hr) {
        // A rows: the 16 pixels of halo row 4 wm + hr from column kw
        if (hr + 1 < 6)
          ldsm_x4(z + a_base + ((hr + 1) * ConvHalo::kCols + kw) *
                                   ConvHalo::kRow,
                  af[(hr + 1) & 1]);
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int i = hr - kh;
          if (i < 0 || i >= 4) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma(acc[i][j], af[hr & 1], bfr[kh][j][0], bfr[kh][j][1]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the stages become the epilogue's tile

  // stg[n][pixel]: an accumulator row is a pixel (the column lane / 4,
  // and + 8), a column an output channel (2 (lane % 4), and + 1)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pix = (4 * wm + i) * kTW + (lane >> 2);
      const int n = wn * 32 + j * 8 + (lane & 3) * 2;
      stg[n * kStg + pix] = acc[i][j][0];
      stg[(n + 1) * kStg + pix] = acc[i][j][1];
      stg[n * kStg + pix + 8] = acc[i][j][2];
      stg[(n + 1) * kStg + pix + 8] = acc[i][j][3];
    }
  __syncthreads();

  // a warp walks one output channel row at a time, a lane two pixels
  const long long plane = (long long)a.H * a.W;
  const int tiles = gridDim.x;
  const bool pairs = (a.W & 1) == 0;  // two pixels make an aligned bf16x2
  for (int nn = warp; nn < kBN; nn += kThreads / 32) {
    const int c = n0 + nn;
    if (c >= a.Cout) break;
    float ua = 0.f, ub = 0.f, mu = 0.f, is = 0.f;
    if (kDgrad) {
      if (a.umode != kIdentity) {
        ua = round_bf16(a.ua[c]);
        ub = round_bf16(a.ub[c]);
      }
      if (a.part) {
        mu = a.mu[c];
        is = a.is[c];
      }
    }
    const long long base = ((long long)b * a.Cout + c) * plane;
    constexpr int kQ = kTH * kTW / 64;
    // the data gradient's u and carry of the row, all loads in flight at
    // once before the arithmetic that needs them
    float uv[kQ][2], cv[kQ][2];
    if (kDgrad) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int pix = q * 64 + 2 * lane;
        const int h = th0 + pix / kTW, w = tw0 + pix % kTW;
        const long long off = base + (long long)h * a.W + w;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = h < a.H && w + e < a.W;
          uv[q][e] = in ? bf2f(a.u[off + e]) : 0.f;
          cv[q][e] = in && a.carry ? bf2f(a.carry[off + e]) : 0.f;
        }
      }
    }
    double s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int pix = q * 64 + 2 * lane;
      const int h = th0 + pix / kTW, w = tw0 + pix % kTW;
      if (h >= a.H || w >= a.W) continue;
      const float2 v2 =
          *reinterpret_cast<const float2*>(stg + nn * kStg + pix);
      const long long off = base + (long long)h * a.W + w;
      const int cnt = w + 1 < a.W ? 2 : 1;
      const float v[2] = {v2.x, v2.y};
      bf16 o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e >= cnt) break;
        if (!kDgrad) {
          o[e] = __float2bfloat16_rn(v[e]);
          const double f = (double)bf2f(o[e]);
          s1 = __dadd_rn(s1, f);
          s2 = __dadd_rn(s2, __dmul_rn(f, f));
        } else {
          const float u = uv[q][e];
          float g = v[e];
          if (a.umode == kAffineRelu &&
              !(pre_act(u, ua, ub, a.umode) > 0.f))
            g = 0.f;
          o[e] = __float2bfloat16_rn(a.carry ? __fadd_rn(g, cv[q][e]) : g);
          if (a.part) {
            const float xh = __fmul_rn(__fsub_rn(u, mu), is);
            s1 = __dadd_rn(s1, (double)g);
            s2 = __dadd_rn(s2, __dmul_rn((double)g, (double)xh));
          }
        }
      }
      if (cnt == 2 && pairs) {
        __nv_bfloat162 o2;
        o2.x = o[0];
        o2.y = o[1];
        *reinterpret_cast<__nv_bfloat162*>(a.out + off) = o2;
      } else {
        a.out[off] = o[0];
        if (cnt == 2) a.out[off + 1] = o[1];
      }
    }
    if (a.part) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 = __dadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
        s2 = __dadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
      }
      if (lane == 0) {
        double* dst = a.part + ((long long)b * tiles + tile) * 2 * a.Cout;
        dst[c] = s1;
        dst[a.Cout + c] = s2;
      }
    }
  }
}

// out[b, k, c] = the sum over the tiles t of part[b * tiles + t, k, c]: a
// warp an output, lane l adding tiles l, l + 32, ... in turn, then the
// lanes by xor shuffles; lane 0's sum, the same on every run
__global__ void reduce_tiles_kernel(const double* __restrict__ part,
                                    double* __restrict__ out, int B,
                                    int tiles, int C) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= B * 2 * C) return;
  const int b = i / (2 * C), kc = i % (2 * C);
  const double* src = part + (long long)b * tiles * 2 * C + kc;
  double t = 0.0;
  for (int s = lane; s < tiles; s += 32)
    t = __dadd_rn(t, src[(long long)s * 2 * C]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    t = __dadd_rn(t, __shfl_xor_sync(0xffffffffu, t, o));
  if (lane == 0) out[i] = t;
}

// ------------------------------------------------------- weight gradient --
struct WgradArgs {
  const bf16* z;     // (B, H, W, CP) channels-last, after the prologue
  const bf16* dy;    // (B, H, W, CoP) channels-last
  float* part;       // (splits, 9, Co, C) f32 partials
  int B, C, CP, Co, CoP, H, W, tiles_w, tiles, per;
};

// the halo pixel offset of tap (kh, kw) = (t / 3, t % 3) in the weight
// gradient's halo
__device__ __forceinline__ constexpr int tap_offset(int t) {
  return (t / 3) * WgradHalo::kCols + t % 3;
}

// One split: the pixel tiles [split * per, (split + 1) * per) of the
// B * tiles, for 64 output channels (co) and 32 input channels (ci).
__global__ void __launch_bounds__(kThreads, 2) wgrad_kernel(WgradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* zs = reinterpret_cast<bf16*>(smem);    // [kStages][halo][32 ci]
  bf16* ds = zs + kStages * WgradHalo::kElems;  // [kStages][pixel][64 co]
  const int co_tiles = (a.Co + kBN - 1) / kBN;
  const int co0 = (blockIdx.x % co_tiles) * kBN;
  const int ci0 = (blockIdx.x / co_tiles) * kWKC;
  const int split = blockIdx.y;
  const int t0 = split * a.per;
  const int nt = min(a.B * a.tiles, t0 + a.per) - t0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1;   // co 32 wm .. 32 wm + 31
  const int wn = warp >> 1;  // ci 8 wn .. 8 wn + 7
  const int lr = lane & 7, lm = lane >> 3;
  // this lane's ldmatrix row addresses, less constant offsets: dy rows
  // are pixel lr (+ 8 for matrices 2, 3), piece 4 wm + lm % 2 (+ 2 i); z
  // rows pixel lr (+ 8 for matrices 1, 3) of the halo, piece wn
  const int d_base =
      (((lm >> 1) << 3) + lr) * kDRow + ((wm * 4 + (lm & 1)) << 3);
  const int z_base = (((lm & 1) << 3) + lr) * WgradHalo::kRow + (wn << 3);

  float acc[2][9][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // pixel tile t0 + k into stage k % kStages: the halo of z (4 pieces a
  // pixel) and dy (8 pieces a pixel)
  auto issue = [&](int k) {
    const int s = k % kStages, t = t0 + k;
    const int b = t / a.tiles, tt = t % a.tiles;
    const int th0 = (tt / a.tiles_w) * kWTH, tw0 = (tt % a.tiles_w) * kWTW;
    bf16* zd = zs + s * WgradHalo::kElems;
    bf16* dd = ds + s * kDElems;
    for (int i = tid; i < WgradHalo::kPixels * 4; i += kThreads) {
      const int p = i >> 2, q = i & 3;
      const int h = th0 - 1 + p / WgradHalo::kCols;
      const int w = tw0 - 1 + p % WgradHalo::kCols;
      const bool ok = h >= 0 && h < a.H && w >= 0 && w < a.W;
      const bf16* src =
          a.z + (((long long)b * a.H + (ok ? h : 0)) * a.W + (ok ? w : 0)) *
                    a.CP + ci0 + q * 8;
      cp_async16(zd + p * WgradHalo::kRow + q * 8, src, ok);
    }
    for (int i = tid; i < kWPix * 8; i += kThreads) {
      const int p = i >> 3, q = i & 7;
      const int h = th0 + p / kWTW, w = tw0 + p % kWTW;
      const bool ok = h < a.H && w < a.W;
      const bf16* src =
          a.dy + (((long long)b * a.H + (ok ? h : 0)) * a.W + (ok ? w : 0)) *
                     a.CoP + co0 + q * 8;
      cp_async16(dd + p * kDRow + q * 8, src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) issue(s);
    cp_commit();
  }
  for (int k = 0; k < nt; ++k) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile k arrived; the stage of k - 1 is free
    if (k + kStages - 1 < nt) issue(k + kStages - 1);
    cp_commit();
    const int s = k % kStages;
    const bf16* z = zs + s * WgradHalo::kElems;
    const bf16* d = ds + s * kDElems;
#pragma unroll 2
    for (int r = 0; r < kWTH; ++r) {
      // k: the 16 pixels of tile row r. A = dy[co][pixel] from the
      // [pixel][co] tile through ldmatrix.trans: matrices (co half, pixel
      // half) = (lm % 2, lm / 2)
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(d + d_base + r * kWTW * kDRow + i * 16, af[i]);
#pragma unroll
      for (int tp = 0; tp < 4; ++tp) {
        // taps 2 tp and 2 tp + 1: matrices (tap, pixel half) = lm / 2,
        // lm % 2
        const int off =
            (lm >> 1) ? tap_offset(2 * tp + 1) : tap_offset(2 * tp);
        uint32_t t4[4];
        ldsm_x4_t(z + z_base + (r * WgradHalo::kCols + off) * WgradHalo::kRow,
                  t4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][2 * tp], af[i], t4[0], t4[1]);
          mma(acc[i][2 * tp + 1], af[i], t4[2], t4[3]);
        }
      }
      {
        uint32_t b0, b1;
        ldsm_x2_t(z + z_base + (r * WgradHalo::kCols + tap_offset(8)) *
                                   WgradHalo::kRow,
                  b0, b1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma(acc[i][8], af[i], b0, b1);
      }
    }
  }
  cp_wait<0>();

  // acc[i][tap]: rows co (lane / 4, and + 8), columns ci (2 (lane % 4),
  // and + 1)
  const long long n = 9LL * a.Co * a.C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + wm * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
        const int ci = ci0 + wn * 8 + (lane & 3) * 2 + (e & 1);
        if (co < a.Co && ci < a.C)
          a.part[split * n + ((long long)tap * a.Co + co) * a.C + ci] =
              acc[i][tap][e];
      }
}

// dW[co, ci, tap] = f32(sum over the splits, in turn, of part[s, tap, co,
// ci]), the sum in f64. A block: one co, 32 ci, the 9 taps; the reads run
// along ci, the writes along dW's (ci, tap) through shared memory.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ dw, int splits,
                                    int Co, int C) {
  __shared__ float t[32][10];
  const int co = blockIdx.y, ci0 = blockIdx.x * 32;
  const int ci = ci0 + threadIdx.x, tap = threadIdx.y;
  const long long n = 9LL * Co * C;
  if (ci < C) {
    const float* src = part + ((long long)tap * Co + co) * C + ci;
    double s = 0.0;
    for (int sp = 0; sp < splits; ++sp)
      s = __dadd_rn(s, (double)src[(long long)sp * n]);
    t[threadIdx.x][tap] = __double2float_rn(s);
  }
  __syncthreads();
  const int k = threadIdx.y * 32 + threadIdx.x;  // (ci - ci0) * 9 + tap
  if (ci0 + k / 9 < C)
    dw[((long long)co * C + ci0) * 9 + k] = t[k / 9][k % 9];
}

// wk[tap, n, k] = bf16(w[n, k, tap]) (flip 0: w is (N, K, 3, 3)) or
// bf16(w[k, n, 8 - tap]) (flip 1: w is (K, N, 3, 3), packed as the
// transposed conv's kernel), 0 for K <= k < KP
__global__ void pack_kernel(const float* __restrict__ w,
                            bf16* __restrict__ wk, int N, int K, int KP,
                            int flip) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= 9LL * N * KP) return;
  const int k = (int)(i % KP), n = (int)((i / KP) % N);
  const int tap = (int)(i / ((long long)KP * N));
  float v = 0.f;
  if (k < K)
    v = flip ? w[((long long)k * N + n) * 9 + 8 - tap]
             : w[((long long)n * K + k) * 9 + tap];
  wk[i] = __float2bfloat16_rn(v);
}

int set_smem() {
  static bool done = false;
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      conv_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kConvSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kConvSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgradSmem);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

// the channels-last pass of a (B, C, H, W) tensor into (B, H, W, CP)
template <bool kFinalize>
cudaError_t to_nhwc(const void* in, const void* y, const float* rows,
                    const float* pa, const float* pb, int mode, void* out,
                    int B, int C, int CP, int HW, cudaStream_t st) {
  dim3 grid((HW + 63) / 64, CP / 64, B);
  to_nhwc_kernel<kFinalize><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(in), static_cast<const bf16*>(y), rows, pa,
      pb, mode, static_cast<bf16*>(out), C, CP, HW);
  return cudaGetLastError();
}

}  // namespace

// w: the f32 weights, (N, K, 3, 3) (flip 0) or (K, N, 3, 3) (flip 1);
// writes wk (9, N, KP) bf16 (pack_kernel).
extern "C" int conv3x3_bf16_pack(const void* w, void* wk, int N, int K,
                                 int KP, int flip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (int)((9LL * N * KP + 255) / 256);
  pack_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(w),
                                      static_cast<bf16*>(wk), N, K, KP, flip);
  return (int)cudaGetLastError();
}

// u: (B, C, H, W) bf16; wk: (9, Co, CP) bf16, the packed weights with
// CP = C rounded up to 64 and zeros past C; pa, pb: (C,) f32 prologue rows
// (rounded to bf16 here; ignored for mode 0); mode 0 identity, 1 affine,
// 2 affine + ReLU. Writes y (B, Co, H, W) bf16 and mom (B, 2, Co) f64.
// Scratch: zn (B, H, W, CP) bf16, part (B * ceil(H / 16) * ceil(W / 16),
// 2, Co) f64. Returns the cudaError_t of the launches.
extern "C" int conv3x3_bf16_fwd(const void* u, const void* wk,
                                const void* pa, const void* pb, int mode,
                                void* zn, void* y, void* part, void* mom,
                                int B, int C, int CP, int Co, int H, int W,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = set_smem();
  if (rc) return rc;
  cudaError_t e = to_nhwc<false>(u, nullptr, nullptr,
                                 static_cast<const float*>(pa),
                                 static_cast<const float*>(pb), mode, zn, B,
                                 C, CP, H * W, st);
  if (e != cudaSuccess) return (int)e;
  ConvArgs a = {};
  a.in = static_cast<const bf16*>(zn);
  a.wk = static_cast<const bf16*>(wk);
  a.B = B;
  a.CinP = CP;
  a.Cout = Co;
  a.H = H;
  a.W = W;
  a.tiles_w = (W + kTW - 1) / kTW;
  a.out = static_cast<bf16*>(y);
  a.part = static_cast<double*>(part);
  const int tiles = a.tiles_w * ((H + kTH - 1) / kTH);
  dim3 grid(tiles, (Co + kBN - 1) / kBN, B);
  conv_kernel<false><<<grid, kThreads, kConvSmem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_tiles_kernel<<<(B * 2 * Co * 32 + 255) / 256, 256, 0, st>>>(
      a.part, static_cast<double*>(mom), B, tiles, Co);
  return (int)cudaGetLastError();
}

// g, y: (B, Co, H, W) bf16; fin: (5, Co) f32 or null (then y is unused and
// g is the conv's output gradient); u, carry, gout: (B, C, H, W) bf16
// (carry may be null); pa, pb, mode: the forward's prologue; wkf: (9, C,
// CoP) bf16, the flipped, transposed kernel packed (CoP = Co rounded up to
// 64, zeros past Co); mu, is: (C,) f32, sums (B, 2, C) f64 and tpart
// (B * tiles, 2, C) f64 scratch (tiles of 16 x 16), or all null; dw:
// (Co, C, 3, 3) f32. Scratch: dyn (B, H, W, CoP) and zn (B, H, W, CP)
// bf16 (CP = C rounded up to 64); wpart (splits, 9, Co, C) f32, per pixel
// tiles (of 8 x 16) a split.
extern "C" int conv3x3_bf16_bwd(const void* g, const void* y, const void* fin,
                                void* dyn, const void* u, const void* pa,
                                const void* pb, int mode, void* zn,
                                const void* wkf, const void* mu,
                                const void* is, void* sums, void* tpart,
                                const void* carry, void* gout, void* wpart,
                                void* dw, int B, int C, int CP, int Co,
                                int CoP, int H, int W, int splits, int per,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = set_smem();
  if (rc) return rc;
  cudaError_t e = to_nhwc<true>(g, y, static_cast<const float*>(fin),
                                nullptr, nullptr, 0, dyn, B, Co, CoP, H * W,
                                st);
  if (e != cudaSuccess) return (int)e;
  e = to_nhwc<false>(u, nullptr, nullptr, static_cast<const float*>(pa),
                     static_cast<const float*>(pb), mode, zn, B, C, CP,
                     H * W, st);
  if (e != cudaSuccess) return (int)e;
  // the data gradient: a conv of dy (Co channels) with the flipped kernel
  ConvArgs a = {};
  a.in = static_cast<const bf16*>(dyn);
  a.wk = static_cast<const bf16*>(wkf);
  a.B = B;
  a.CinP = CoP;
  a.Cout = C;
  a.H = H;
  a.W = W;
  a.tiles_w = (W + kTW - 1) / kTW;
  a.out = static_cast<bf16*>(gout);
  a.part = static_cast<double*>(tpart);
  a.u = static_cast<const bf16*>(u);
  a.ua = static_cast<const float*>(pa);
  a.ub = static_cast<const float*>(pb);
  a.umode = mode;
  a.carry = static_cast<const bf16*>(carry);
  a.mu = static_cast<const float*>(mu);
  a.is = static_cast<const float*>(is);
  const int tiles = a.tiles_w * ((H + kTH - 1) / kTH);
  dim3 grid(tiles, (C + kBN - 1) / kBN, B);
  conv_kernel<true><<<grid, kThreads, kConvSmem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (tpart) {
    reduce_tiles_kernel<<<(B * 2 * C * 32 + 255) / 256, 256, 0, st>>>(
        a.part, static_cast<double*>(sums), B, tiles, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  WgradArgs wa = {};
  wa.z = static_cast<const bf16*>(zn);
  wa.dy = static_cast<const bf16*>(dyn);
  wa.part = static_cast<float*>(wpart);
  wa.B = B;
  wa.C = C;
  wa.CP = CP;
  wa.Co = Co;
  wa.CoP = CoP;
  wa.H = H;
  wa.W = W;
  wa.tiles_w = (W + kWTW - 1) / kWTW;
  wa.tiles = wa.tiles_w * ((H + kWTH - 1) / kWTH);
  wa.per = per;
  dim3 wgrid(((Co + kBN - 1) / kBN) * ((C + kWKC - 1) / kWKC), splits);
  wgrad_kernel<<<wgrid, kThreads, kWgradSmem, st>>>(wa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wgrad_reduce_kernel<<<dim3((C + 31) / 32, Co), dim3(32, 9), 0, st>>>(
      wa.part, static_cast<float*>(dw), splits, Co, C);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
