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
// where xpad is x padded by one pixel. dx is written in the input type;
// dw leaves as float32 partials [P,3,3,C], one per block row of the
// grid, which the caller sums (torch.sum, fixed order) and casts.
//
// Bound: bytes. Per input pixel and channel 9 multiply-adds for dx and 9
// for dw against x and g read and dx written (6 bytes in bf16): about 6
// operations a byte, far below the ~20 float32 operations a byte at
// which the CUDA cores would bound it. The least time is x, g and w
// read once and dx and dw written once over the memory rate.
//
// Design against that bound:
// - dx is a gather per INPUT pixel: a thread owns one input pixel and 8
//   channels and sums the (at most 9) gradient taps that reach it. The
//   TPU kernel's zero-dilated gradient for stride 2, its padded copies
//   of x and g and its phantom rows for odd H/W do not exist here: a
//   tap whose quotient is not a whole, in-range index is skipped.
// - Every (x pixel, g pixel, tap) triple of dw is one of those same
//   taps, so the thread adds x[p,q]*g[i,j] into 9x8 float32 registers
//   as it goes: dx and dw come from one read of x and g.
// - A block is a tile of channel groups (threadIdx.x) by pixel lanes
//   (threadIdx.y) and walks a fixed span of pixels, so the number of
//   dw partials is the grid's row count, not the pixel count. The
//   lanes' registers are reduced in shared memory, one tap at a time,
//   in a fixed order: the result does not depend on scheduling.
// - dx repeats the plain version's arithmetic
//   (tpunet_torch/ops/depthwise.py:depthwise_conv3x3_backward_reference):
//   taps in the order (dy, dx), products rounded, then added, no fused
//   multiply-add, so the two agree bit for bit. dw sums in another
//   order than the plain version and agrees to rounding.
// ---------------------------------------------------------------------------

namespace {

template <typename T, bool kVectorised>
__device__ __forceinline__ void load8(const T* p, int c0, int c, float* out) {
  if (kVectorised) {
    const Pack<T> v = *reinterpret_cast<const Pack<T>*>(p);
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = to_f32(v.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = c0 + j < c ? to_f32(p[j]) : 0.f;
  }
}

template <typename T, bool kVectorised>
__global__ void __launch_bounds__(kThreads)
    depthwise3x3_bwd(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ g, T* __restrict__ dx,
                     float* __restrict__ dwp, int n_img, int h, int wd,
                     int c, int ho, int wo, int stride, int groups,
                     int64_t pixels_per_block) {
  __shared__ float red[kThreads * kVec];
  const int tg = blockDim.x, ty_n = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int grp = blockIdx.x * tg + tx;
  const bool live = grp < groups;
  const int c0 = grp * kVec;
  const int64_t total = int64_t(n_img) * h * wd;
  const int64_t p_begin = int64_t(blockIdx.y) * pixels_per_block;
  const int64_t p_end = p_begin + pixels_per_block < total
                            ? p_begin + pixels_per_block : total;

  float dwacc[9][kVec];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < kVec; ++j) dwacc[t][j] = 0.f;

  if (live) {
    for (int64_t p = p_begin + ty; p < p_end; p += ty_n) {
      const int q = int(p % wd);
      const int64_t r = p / wd;
      const int pi = int(r % h);
      const int n = int(r / h);
      float xv[kVec], acc[kVec];
      load8<T, kVectorised>(x + p * c + c0, c0, c, xv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int iy = pi + 1 - dy;
        if (iy < 0 || iy % stride) continue;
        const int i = iy / stride;
        if (i >= ho) continue;
#pragma unroll
        for (int dxx = 0; dxx < 3; ++dxx) {
          const int jx = q + 1 - dxx;
          if (jx < 0 || jx % stride) continue;
          const int jj = jx / stride;
          if (jj >= wo) continue;
          float gv[kVec], wv[kVec];
          load8<T, kVectorised>(
              g + ((int64_t(n) * ho + i) * wo + jj) * c + c0, c0, c, gv);
          load8<T, kVectorised>(w + int64_t(dy * 3 + dxx) * c + c0, c0, c,
                                wv);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            acc[j] = __fadd_rn(acc[j], __fmul_rn(gv[j], wv[j]));
            dwacc[dy * 3 + dxx][j] += xv[j] * gv[j];
          }
        }
      }
      T* dp = dx + p * c + c0;
      if (kVectorised) {
        Pack<T> out;
#pragma unroll
        for (int j = 0; j < kVec; ++j) out.v[j] = from_f32<T>(acc[j]);
        *reinterpret_cast<Pack<T>*>(dp) = out;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (c0 + j < c) dp[j] = from_f32<T>(acc[j]);
      }
    }
  }

  // Tree-reduce each tap's registers over the pixel lanes (threadIdx.y);
  // lane 0 writes the block's partial. Every thread takes part in the
  // barriers, live or not.
  // Unrolled, so that dwacc stays in registers (a tap index known only
  // at run time would put it in local memory).
  const int slot = (ty * tg + tx) * kVec;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[slot + j] = dwacc[t][j];
    __syncthreads();
    for (int s = 1; s < ty_n; s *= 2) {
      if (ty % (2 * s) == 0 && ty + s < ty_n) {
        const int other = ((ty + s) * tg + tx) * kVec;
#pragma unroll
        for (int j = 0; j < kVec; ++j) red[slot + j] += red[other + j];
      }
      __syncthreads();
    }
    if (ty == 0 && live) {
      float* out = dwp + (int64_t(blockIdx.y) * 9 + t) * c + c0;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (c0 + j < c) out[j] = red[slot + j];
    }
    __syncthreads();
  }
}

template <typename T>
void launch_bwd(const void* x, const void* w, const void* g, void* dx,
                void* dwp, int n, int h, int wd, int c, int stride, int tg,
                int p, int64_t pixels_per_block, int vectorised,
                cudaStream_t stream) {
  const int ho = (h - 1) / stride + 1;
  const int wo = (wd - 1) / stride + 1;
  const int groups = (c + kVec - 1) / kVec;
  const dim3 block(tg, kThreads / tg);
  const dim3 grid((groups + tg - 1) / tg, p);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  float* dwpt = static_cast<float*>(dwp);
  if (vectorised)
    depthwise3x3_bwd<T, true><<<grid, block, 0, stream>>>(
        xt, wt, gt, dxt, dwpt, n, h, wd, c, ho, wo, stride, groups,
        pixels_per_block);
  else
    depthwise3x3_bwd<T, false><<<grid, block, 0, stream>>>(
        xt, wt, gt, dxt, dwpt, n, h, wd, c, ho, wo, stride, groups,
        pixels_per_block);
}

}  // namespace

// tg: channel groups (of 8) per block, 1..32, which divides the block's
// 256 threads into tg x (256 / tg); p: blocks along the pixels, each
// taking pixels_per_block input pixels and writing one [3,3,C] float32
// partial to dwp [p,3,3,C]. dtype and vectorised as for the forward
// (vectorised also needs g and dx 16-byte aligned). Returns
// cudaGetLastError() after the launch.
extern "C" int tpunet_depthwise3x3_bwd(const void* x, const void* w,
                                       const void* g, void* dx, void* dwp,
                                       int n, int h, int wd, int c,
                                       int stride, int tg, int p,
                                       int64_t pixels_per_block, int dtype,
                                       int vectorised, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tg < 1 || tg > 32 || p < 1 || pixels_per_block < 1)
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_bwd<float>(x, w, g, dx, dwp, n, h, wd, c, stride, tg, p,
                      pixels_per_block, vectorised, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(x, w, g, dx, dwp, n, h, wd, c, stride, tg, p,
                              pixels_per_block, vectorised, s);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}
