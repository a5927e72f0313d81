// 3x3 depthwise convolution forward, NHWC, torch padding=1, stride 1 or 2.
//
// Replaces the Pallas TPU kernel tpunet/ops/depthwise.py:_kernel
// (launched by _pallas_forward). Same function: x [N,H,W,C] and
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
