// 3x3 depthwise convolution, NHWC, torch padding=1, stride 1 or 2:
// the forward (depthwise3x3_fwd) and the backward (depthwise3x3_bwd).
//
// The forward replaces the Pallas TPU kernel
// tpunet/ops/depthwise.py:_kernel (launched by _pallas_forward). Same
// function: x [N,H,W,C] and
// w [3,3,C] give y [N,Ho,Wo,C] with Ho = (H-1)/s + 1, Wo = (W-1)/s + 1;
// the 9 taps are accumulated in float32 and the sum is cast back to the
// input type (float32 or bfloat16).
//
// Bound: bytes. Each output element costs 9 multiply-adds against at
// least 2 bytes read and 2 written in bf16, about 4.5 operations a
// byte, far below the roughly 20 float32 operations a byte at which an
// H100's CUDA cores (67 TFLOP/s against 3.35 TB/s) would be the limit.
// The least time is each input read once plus each output written once
// over the memory rate.
//
// Design against that bound:
// - one thread per output pixel (n, ho, wo) and group of 8 channels;
//   channels are the fastest index of the thread id, so neighbouring
//   threads read neighbouring 16-byte vectors (bf16) and each warp's
//   loads and stores are coalesced;
// - the halo is handled by index bounds, so no padded copy of x is ever
//   written to device memory (the TPU version pads on the host side);
// - the rows a thread reads again for its neighbours' taps come from
//   L1/L2, not from device memory;
// - any C: the vector path needs C % 8 == 0 and 16-byte aligned
//   pointers (the wrapper checks), the scalar path takes the rest.
// The arithmetic is that of the plain PyTorch version
// (tpunet_torch/ops/depthwise.py:depthwise_conv3x3_reference): taps in
// the order (dy, dx), each product rounded, then added, with no fused
// multiply-add, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;       // channels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 values of T as whole 16-byte words: one for bf16, two for float32.
template <typename T>
struct alignas(16) Pack {
  T v[kVec];
};

template <typename T, bool kVectorised>
__global__ void __launch_bounds__(kThreads)
    depthwise3x3_fwd(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int n_img, int h, int wd, int c,
                     int ho, int wo, int stride, int groups) {
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t total = int64_t(n_img) * ho * wo * groups;
  if (idx >= total) return;
  const int g = int(idx % groups);
  int64_t r = idx / groups;
  const int oj = int(r % wo);
  r /= wo;
  const int oi = int(r % ho);
  const int n = int(r / ho);
  const int c0 = g * kVec;

  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;

#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ii = oi * stride - 1 + dy;
    if (ii < 0 || ii >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int jj = oj * stride - 1 + dx;
      if (jj < 0 || jj >= wd) continue;
      const T* xp = x + ((int64_t(n) * h + ii) * wd + jj) * c + c0;
      const T* wp = w + int64_t(dy * 3 + dx) * c + c0;
      if (kVectorised) {
        const Pack<T> xv = *reinterpret_cast<const Pack<T>*>(xp);
        const Pack<T> wv = *reinterpret_cast<const Pack<T>*>(wp);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          acc[j] = __fadd_rn(acc[j],
                             __fmul_rn(to_f32(xv.v[j]), to_f32(wv.v[j])));
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (c0 + j < c)
            acc[j] = __fadd_rn(acc[j],
                               __fmul_rn(to_f32(xp[j]), to_f32(wp[j])));
      }
    }
  }

  T* yp = y + ((int64_t(n) * ho + oi) * wo + oj) * c + c0;
  if (kVectorised) {
    Pack<T> out;
#pragma unroll
    for (int j = 0; j < kVec; ++j) out.v[j] = from_f32<T>(acc[j]);
    *reinterpret_cast<Pack<T>*>(yp) = out;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (c0 + j < c) yp[j] = from_f32<T>(acc[j]);
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int n, int h, int wd,
            int c, int stride, int vectorised, cudaStream_t stream) {
  const int ho = (h - 1) / stride + 1;
  const int wo = (wd - 1) / stride + 1;
  const int groups = (c + kVec - 1) / kVec;
  const int64_t total = int64_t(n) * ho * wo * groups;
  const unsigned blocks = unsigned((total + kThreads - 1) / kThreads);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vectorised)
    depthwise3x3_fwd<T, true><<<blocks, kThreads, 0, stream>>>(
        xt, wt, yt, n, h, wd, c, ho, wo, stride, groups);
  else
    depthwise3x3_fwd<T, false><<<blocks, kThreads, 0, stream>>>(
        xt, wt, yt, n, h, wd, c, ho, wo, stride, groups);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vectorised: 1 only when c % 8 == 0
// and x, w, y are 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int tpunet_depthwise3x3_fwd(const void* x, const void* w, void* y,
                                       int n, int h, int wd, int c,
                                       int stride, int dtype, int vectorised,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, w, y, n, h, wd, c, stride, vectorised, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w, y, n, h, wd, c, stride, vectorised, s);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward: replaces the Pallas TPU kernel tpunet/ops/depthwise.py:_bwd_kernel
// (launched by _pallas_backward). From x [N,H,W,C], w [3,3,C] and the
// output gradient g [N,Ho,Wo,C] it computes
//   dx[n,p,q,c] = sum over taps (dy,dx) with i = (p+1-dy)/s and
//                 j = (q+1-dx)/s whole and in range of g[n,i,j,c]*w[dy,dx,c]
//   dw[dy,dx,c] = sum over n,i,j of xpad[n,s*i+dy,s*j+dx,c]*g[n,i,j,c]
// where xpad is x padded by one pixel. dx is written in the input type,
// dw in w's type after a float32 sum.
//
// Bound: bytes. Per input pixel and channel 9 multiply-adds for dx and 9
// for dw (stride 1) against x and g read and dx written (6 bytes in
// bf16): about 6 operations a byte, far below the ~20 float32 operations
// a byte at which the CUDA cores would bound it. The least time is x, g
// and w read once and dx and dw written once over the memory rate.
//
// Design against that bound (depthwise3x3_bwd, then depthwise3x3_dw_sum):
// - a block owns a band of `rows` input rows of one image (the whole
//   width) and a chunk of `cc` channels (8 to 64). It stages the band's x
//   rows and the gradient rows that the band's taps reach, with a
//   one-pixel halo, into shared memory by 16-byte cp.async, all at once,
//   so that the whole tile is in flight together (a thread that loaded
//   its own x pixel by pixel kept too few bytes in flight to approach
//   the memory rate); rows and columns outside x and g are zero there.
//   The chunk is the fastest index of the grid, so the blocks that read
//   the neighbouring chunks of the same pixels run together and the
//   blocks of neighbouring bands find the halo rows in L2;
// - a thread owns two channels (one bf16x2 or float2 word) and walks its
//   columns down the band. At stride 1 it keeps the 3x3 gradient window
//   in registers and reads one new row of it a step (3 of the 9 taps); at
//   stride 2 the columns are taken by parity class (all even columns,
//   then all odd), and the row loop by parity too, so a warp's lanes take
//   the same 1, 2 or 4 taps; each thread writes dx of its own pixels;
// - every (x pixel, g pixel, tap) triple of dx is one of dw's, so dw[tap]
//   += x * g is summed from the same registers: x and g are read from
//   device memory once (g's halo rows twice, from L2);
// - the threads that share a channel pair reduce their dw by warp
//   shuffles, then across warps in shared memory in warp order: one
//   float32 [9, cc] partial a block, [N * bands, 9, C] in all. A second
//   kernel sums the partials of each (tap, channel) in a fixed order and
//   casts to w's type. No atomics anywhere, so two runs give the same dw
//   bit for bit; the wrapper launches nothing else;
// - dx repeats the plain version's arithmetic
//   (tpunet_torch/ops/depthwise.py:depthwise_conv3x3_backward_reference):
//   taps in the order (dy, dx), products rounded, then added, no fused
//   multiply-add, so the two agree bit for bit on finite inputs (a tap
//   that falls in the zero halo adds a product of 0, which leaves the
//   sum as it is). dw sums in another order than the plain version and
//   agrees to rounding.
// The plan (cc, rows, threads) is chosen by the wrapper
// (tpunet_torch/ops/depthwise.py:backward_plan).
// ---------------------------------------------------------------------------

namespace {

constexpr int kMaxBwdThreads = 128;

template <typename T>
struct Pair2;
template <>
struct Pair2<float> {
  using type = float2;
};
template <>
struct Pair2<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float2 to_f32x2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T>
__device__ __forceinline__ typename Pair2<T>::type from_f32x2(float2 v);
template <>
__device__ __forceinline__ float2 from_f32x2<float>(float2 v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat162 from_f32x2<__nv_bfloat16>(
    float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);
}

// Channels ch, ch + 1 of the element at p (the pair's word when
// vectorised; else one by one, 0 at or past c).
template <typename T, bool kVectorised>
__device__ __forceinline__ float2 load2(const T* p, int ch, int c) {
  if (kVectorised)
    return to_f32x2(*reinterpret_cast<const typename Pair2<T>::type*>(p));
  return make_float2(ch < c ? to_f32(p[0]) : 0.f,
                     ch + 1 < c ? to_f32(p[1]) : 0.f);
}

template <typename T, bool kVectorised>
__device__ __forceinline__ void store2(T* p, float2 v, int ch, int c) {
  if (kVectorised) {
    *reinterpret_cast<typename Pair2<T>::type*>(p) = from_f32x2<T>(v);
  } else {
    if (ch < c) p[0] = from_f32<T>(v.x);
    if (ch + 1 < c) p[1] = from_f32<T>(v.y);
  }
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 16-byte chunks, or single elements in the scalar path, of `rows` rows
// of an NHWC tensor [.., rows_total, cols_total, c] into dst [rows][gw][cc]
// (tile row r, column col holds the tensor's row r0 + r, column col - c0l,
// channels ch0..): zero outside the tensor and at or past channel c.
template <typename T, bool kVectorised>
__device__ __forceinline__ void stage(T* dst, const T* src, int rows,
                                      int gw, int cc, int r0, int c0l,
                                      int rows_total, int cols_total, int c,
                                      int ch0) {
  if (kVectorised) {
    constexpr int kPer = 16 / sizeof(T);  // channels a 16-byte chunk
    const int chunks = cc / kPer, total = rows * gw * chunks;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int k = i % chunks, cell = i / chunks;
      const int col = cell % gw, r = cell / gw;
      const int gi = r0 + r, gj = col - c0l, ch = ch0 + k * kPer;
      const bool ok =
          gi >= 0 && gi < rows_total && gj >= 0 && gj < cols_total && ch < c;
      const T* from =
          ok ? src + (int64_t(gi) * cols_total + gj) * c + ch : src;
      cp_async16_zfill(dst + cell * cc + k * kPer, from, ok);
    }
  } else {
    const int total = rows * gw * cc;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int k = i % cc, cell = i / cc;
      const int col = cell % gw, r = cell / gw;
      const int gi = r0 + r, gj = col - c0l, ch = ch0 + k;
      const bool ok =
          gi >= 0 && gi < rows_total && gj >= 0 && gj < cols_total && ch < c;
      dst[i] = ok ? src[(int64_t(gi) * cols_total + gj) * c + ch]
                  : from_f32<T>(0.f);
    }
  }
}

struct BwdArgs {
  int n, h, w, c, ho, wo, stride;
  int cc, rows, bands;  // the plan: channel chunk, band height, bands an image
  int grows, gw;        // staged gradient rows and columns (wo + 2)
};

// One step of dx and dw at one pixel from the taps (dy, dx) of tap list
// order: acc += g * w, each product rounded, then added; dw[tap] += x * g.
__device__ __forceinline__ void tap(float2& acc, float2 (&dw)[9], int t,
                                    float2 g, float2 w, float2 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(g.x, w.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(g.y, w.y));
  dw[t].x = fmaf(x.x, g.x, dw[t].x);
  dw[t].y = fmaf(x.y, g.y, dw[t].y);
}

// Stride 2, one input pixel of row parity kOddRow and column parity
// kOddCol: its 1, 2 or 4 taps in (dy, dx) order. lp: the pixel's row in
// the band (the band starts on an even row, so lp has p's parity); the
// staged gradient row of g row i is i - p0 / 2, its column j + 1.
template <bool kOddRow, bool kOddCol, typename T>
__device__ __forceinline__ void pixel_s2(const T* sg, int gw, int cc,
                                         int lp, int q, const float2 (&w)[9],
                                         float2 (&dw)[9], float2 x,
                                         float2& acc) {
  using P = typename Pair2<T>::type;
#pragma unroll
  for (int a = 0; a < (kOddRow ? 2 : 1); ++a) {
    const int dy = kOddRow ? 2 * a : 1;
    const int sr = kOddRow ? (lp + 1) / 2 - a : lp / 2;
#pragma unroll
    for (int b = 0; b < (kOddCol ? 2 : 1); ++b) {
      const int dx = kOddCol ? 2 * b : 1;
      const int sc = kOddCol ? (q + 1) / 2 - b + 1 : q / 2 + 1;
      const float2 g =
          to_f32x2(*reinterpret_cast<const P*>(sg + (sr * gw + sc) * cc));
      tap(acc, dw, dy * 3 + dx, g, w[dy * 3 + dx], x);
    }
  }
}

template <typename T, bool kVectorised>
__global__ void __launch_bounds__(kMaxBwdThreads, 4)
    depthwise3x3_bwd(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ g, T* __restrict__ dx,
                     float* __restrict__ part, BwdArgs a) {
  using P = typename Pair2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cc = a.cc, gw = a.gw;
  T* sg = reinterpret_cast<T*>(smem_raw);  // [grows][gw][cc] gradient rows
  T* sx = sg + a.grows * gw * cc;          // [rows][w][cc] the band's x
  const int n = blockIdx.y / a.bands, band = blockIdx.y % a.bands;
  const int p0 = band * a.rows;
  const int c0 = blockIdx.x * cc;
  // The first staged gradient row: the row above the band at stride 1,
  // the one the band's first (even) row reaches at stride 2.
  const int gi0 = a.stride == 1 ? p0 - 1 : p0 / 2;

  // Gradient rows gi0.. and columns -1..wo, and x rows p0.., chunk c0..
  stage<T, kVectorised>(sg, g + int64_t(n) * a.ho * a.wo * a.c, a.grows, gw,
                        cc, gi0, 1, a.ho, a.wo, a.c, c0);
  stage<T, kVectorised>(sx, x + int64_t(n) * a.h * a.w * a.c, a.rows, a.w,
                        cc, p0, 0, a.h, a.w, a.c, c0);
  if (kVectorised) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // This thread's channel pair, the same for every column it takes
  // (blockDim.x is a multiple of the pairs a chunk holds).
  const int pairs = cc / 2, k = threadIdx.x % pairs, ch = c0 + 2 * k;
  float2 wv[9], dw[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    wv[t] = load2<T, kVectorised>(w + int64_t(t) * a.c + ch, ch, a.c);
    dw[t] = make_float2(0.f, 0.f);
  }
  const T* sgk = sg + 2 * k;
  const int rows = min(a.rows, a.h - p0);
  const int items = a.w * pairs;
  const int64_t row_step = int64_t(a.w) * a.c;
  for (int item = threadIdx.x; item < items && ch < a.c;
       item += blockDim.x) {
    int q;
    bool odd_col = false;
    if (a.stride == 1) {
      q = item / pairs;
    } else {
      // Even columns first, then odd ones: a warp's lanes share a parity
      // (but in the one warp that straddles the two classes).
      const int even = (a.w + 1) / 2 * pairs;
      odd_col = item >= even;
      q = odd_col ? 2 * ((item - even) / pairs) + 1 : 2 * (item / pairs);
    }
    const T* xs = sx + q * cc + 2 * k;  // x of (p0 + lp, q): xs[lp w cc]
    T* dxp = dx + ((int64_t(n) * a.h + p0) * a.w + q) * a.c + ch;
    auto xat = [&](int lp) {
      return to_f32x2(*reinterpret_cast<const P*>(xs + lp * a.w * cc));
    };
    if (a.stride == 1) {
      // The gradient window of pixel (p0 + lp, q): staged rows lp..lp+2,
      // columns q..q+2; tap (dy, dx) is win[2 - dy][2 - dx].
      float2 win[3][3];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int cx = 0; cx < 3; ++cx)
          win[r][cx] = to_f32x2(
              *reinterpret_cast<const P*>(sgk + (r * gw + q + cx) * cc));
      for (int lp = 0; lp < rows; ++lp) {
#pragma unroll
        for (int cx = 0; cx < 3; ++cx)
          win[2][cx] = to_f32x2(*reinterpret_cast<const P*>(
              sgk + ((lp + 2) * gw + q + cx) * cc));
        const float2 xv = xat(lp);
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dxx = 0; dxx < 3; ++dxx)
            tap(acc, dw, dy * 3 + dxx, win[2 - dy][2 - dxx], wv[dy * 3 + dxx],
                xv);
        store2<T, kVectorised>(dxp, acc, ch, a.c);
#pragma unroll
        for (int cx = 0; cx < 3; ++cx) {
          win[0][cx] = win[1][cx];
          win[1][cx] = win[2][cx];
        }
        dxp += row_step;
      }
    } else {
      for (int lp = 0; lp < rows; lp += 2) {
        float2 acc = make_float2(0.f, 0.f);
        if (odd_col)
          pixel_s2<false, true>(sgk, gw, cc, lp, q, wv, dw, xat(lp), acc);
        else
          pixel_s2<false, false>(sgk, gw, cc, lp, q, wv, dw, xat(lp), acc);
        store2<T, kVectorised>(dxp, acc, ch, a.c);
        if (lp + 1 < rows) {
          acc = make_float2(0.f, 0.f);
          if (odd_col)
            pixel_s2<true, true>(sgk, gw, cc, lp + 1, q, wv, dw, xat(lp + 1),
                                 acc);
          else
            pixel_s2<true, false>(sgk, gw, cc, lp + 1, q, wv, dw,
                                  xat(lp + 1), acc);
          store2<T, kVectorised>(dxp + row_step, acc, ch, a.c);
        }
        dxp += 2 * row_step;
      }
    }
  }

  // dw: lanes l and l ^ o (o = pairs, 2 pairs, .. 16) share a channel
  // pair; after the shuffles lane k < pairs holds its warp's sum. Then
  // warp by warp, in order, through shared memory (the staged rows are no
  // longer read once every thread has passed the barrier).
#pragma unroll
  for (int t = 0; t < 9; ++t)
    for (int o = pairs; o < 32; o *= 2) {
      dw[t].x += __shfl_xor_sync(0xffffffffu, dw[t].x, o);
      dw[t].y += __shfl_xor_sync(0xffffffffu, dw[t].y, o);
    }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [warps][9][cc]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < pairs)
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      red[(warp * 9 + t) * cc + 2 * lane] = dw[t].x;
      red[(warp * 9 + t) * cc + 2 * lane + 1] = dw[t].y;
    }
  __syncthreads();
  const int warps = blockDim.x / 32;
  for (int i = threadIdx.x; i < 9 * cc; i += blockDim.x) {
    const int t = i / cc, cj = i % cc;
    if (c0 + cj >= a.c) continue;
    float s = red[t * cc + cj];
    for (int v = 1; v < warps; ++v) s += red[(v * 9 + t) * cc + cj];
    part[(int64_t(blockIdx.y) * 9 + t) * a.c + c0 + cj] = s;
  }
}

constexpr int kSumX = 32, kSumY = 16;

// dw[t] = the float32 sum of part[0..np)[t], in w's type; t indexes the
// 9 * C (tap, channel) entries. Thread (x, y) sums partials y, y + kSumY,
// .. in order, then thread (x, 0) the kSumY sums in order: the same
// order on every run.
template <typename T>
__global__ void __launch_bounds__(kSumX * kSumY)
    depthwise3x3_dw_sum(const float* __restrict__ part, T* __restrict__ dw,
                        int np, int n9c) {
  __shared__ float red[kSumY][kSumX];
  const int t = blockIdx.x * kSumX + threadIdx.x;
  float s = 0.f;
  if (t < n9c)
    for (int i = threadIdx.y; i < np; i += kSumY)
      s += part[int64_t(i) * n9c + t];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && t < n9c) {
    float total = red[0][threadIdx.x];
    for (int y = 1; y < kSumY; ++y) total += red[y][threadIdx.x];
    dw[t] = from_f32<T>(total);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* g, void* dx,
               void* part, void* dw, BwdArgs a, int threads, int vectorised,
               cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  float* pt = static_cast<float*>(part);
  const size_t tile =
      (size_t(a.grows) * a.gw + size_t(a.rows) * a.w) * a.cc * sizeof(T);
  const size_t red = size_t(threads / 32) * 9 * a.cc * sizeof(float);
  const size_t smem = tile > red ? tile : red;
  const dim3 grid((a.c + a.cc - 1) / a.cc, a.n * a.bands);
  void (*kern)(const T*, const T*, const T*, T*, float*, BwdArgs) =
      vectorised ? depthwise3x3_bwd<T, true> : depthwise3x3_bwd<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<grid, threads, smem, stream>>>(xt, wt, gt, dxt, pt, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n9c = 9 * a.c;
  depthwise3x3_dw_sum<T><<<(n9c + kSumX - 1) / kSumX, dim3(kSumX, kSumY), 0,
                           stream>>>(pt, static_cast<T*>(dw),
                                     a.n * a.bands, n9c);
  return int(cudaGetLastError());
}

}  // namespace

// cc: channels a block takes (8, 16, 32 or 64; a multiple of 8 that
// 16-byte copies fill); rows: input rows a block takes (even at stride
// 2); threads: a multiple of 32, at most 128, that cc / 2 divides. part:
// float32 scratch [N * ceil(H / rows), 9, C] for the blocks' dw partials;
// dw: [3,3,C] in the input type. dtype and vectorised as for the forward
// (vectorised also needs g and dx 16-byte aligned). Returns
// cudaGetLastError() after the launches, or the error that prevented one.
extern "C" int tpunet_depthwise3x3_bwd(const void* x, const void* w,
                                       const void* g, void* dx, void* part,
                                       void* dw, int n, int h, int wd, int c,
                                       int stride, int cc, int rows,
                                       int threads, int dtype, int vectorised,
                                       void* stream) {
  if (cc < 8 || cc > 64 || cc % 8 || (cc & (cc - 1)) || rows < 1 ||
      (stride == 2 && rows % 2) || threads < 32 || threads > kMaxBwdThreads ||
      threads % 32 || (stride != 1 && stride != 2))
    return int(cudaErrorInvalidValue);
  BwdArgs a;
  a.n = n;
  a.h = h;
  a.w = wd;
  a.c = c;
  a.stride = stride;
  a.ho = (h - 1) / stride + 1;
  a.wo = (wd - 1) / stride + 1;
  a.cc = cc;
  a.rows = rows;
  a.bands = (h + rows - 1) / rows;
  a.grows = stride == 1 ? rows + 2 : rows / 2 + 1;
  a.gw = a.wo + 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, w, g, dx, part, dw, a, threads, vectorised,
                             s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w, g, dx, part, dw, a, threads,
                                     vectorised, s);
  return int(cudaErrorInvalidValue);
}
