// Fused inverted-residual 1x1 convolution with train-mode BatchNorm:
// the forward (fused_ir_fwd) and the backward (fused_ir_bwd_dx and
// fused_ir_bwd_dw, launched together by one C entry).
//
// Forward: replaces the Pallas TPU kernel tpunet/ops/fused_ir.py:_fwd_kernel
// (launched by _pallas_forward). x [M,Ci] and w [Ci,Co] (M = N*H*W, the
// NHWC activation as a matrix) give y = x.w, accumulated in float32 and
// stored in the input type, and the column sums of the ROUNDED y and of
// its square, sum(y) and sum(y*y), in float32 as per-block partials
// [P,2,Co] that the caller sums. The caller forms mean, var and the
// scale/shift/ReLU6 epilogue in plain torch, as tpunet's
// _fused_fwd_impl does in XLA.
//
// Backward: replaces the Pallas TPU kernel tpunet/ops/fused_ir.py:_bwd_kernel
// (launched by _pallas_backward). From the saved x, y, w, the output
// gradient g and chan [6,Co] = [inv, shift, r, mr, r1/n, r2/n] it
// recomputes, per element,
//   gm = g * (0 < y*inv + shift < 6)   (g itself without the ReLU6)
//   yh = y*r - mr
//   t  = inv * (gm - r1/n - yh * r2/n)      the gradient of the conv output
// and computes dx = t.w^T [M,Ci] in the input type and dw = x^T.t as
// float32 partials [P,Ci,Co] over spans of rows, which the caller sums.
// t never goes to device memory: both launches rebuild it from g and y
// as they load their tiles.
//
// Bound: at MobileNetV2's widths (Ci, Co from 16 to 960) the product has
// 2*Ci*Co/(2*(Ci+Co)) ~ 8..240 operations per byte of x and y in bf16,
// below the ~295 at which the tensor cores would bound a bf16 product:
// the bound is bytes for the small layers and close to balanced for the
// 7 px tail. This first version does not reach either: it multiplies on
// the CUDA cores in float32 (67 TFLOP/s), not on the tensor cores.
//
// Design:
// - one tiled product, 64x64 outputs per block of 256 threads, 4x4 per
//   thread, k in steps of 16 through shared memory; the operands come
//   through loader functors, so the three products (x.w, t.w^T, x^T.t)
//   share it, and t is made inside the loader from g, y and chan;
// - the loads of each tile walk the operand's contiguous dimension with
//   neighbouring threads (the template flags say which one that is);
//   shared rows are padded by one word against bank conflicts;
// - column sums: each thread sums its 4 columns over the row tiles its
//   block walks (a fixed span, so the number of partials is the grid's
//   row count), then the 16 thread rows are summed in shared memory in
//   a fixed order;
// - dw: a split over rows (blockIdx.z) into spans; the caller bounds the
//   number of spans, and so the float32 scratch P*Ci*Co*4 bytes, to a
//   quarter of the bytes of x and g;
// - the mask and t repeat the plain version's arithmetic
//   (tpunet_torch/ops/fused_ir.py) with rounded multiplies and adds, so
//   an element at the ReLU6 edge gets the same mask on both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

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

// Element (r, c) of a row-major [rows, cols] matrix.
template <typename T>
struct RowMajor {
  const T* p;
  int64_t rows, cols;
  __device__ __forceinline__ float operator()(int64_t r, int64_t c) const {
    return (r < rows && c < cols) ? to_f32(p[r * cols + c]) : 0.f;
  }
};

// Element (r, c) of the transpose of a row-major [cols, rows] matrix.
template <typename T>
struct Transposed {
  const T* p;
  int64_t rows, cols;
  __device__ __forceinline__ float operator()(int64_t r, int64_t c) const {
    return (r < rows && c < cols) ? to_f32(p[c * rows + r]) : 0.f;
  }
};

// t(m, co), the gradient of the conv output, rebuilt from g, y and chan.
template <typename T>
struct GradT {
  const T* g;
  const T* y;
  const float* chan;
  int64_t rows, cols;
  int act;
  __device__ __forceinline__ float operator()(int64_t m, int64_t c) const {
    if (m >= rows || c >= cols) return 0.f;
    const int64_t o = m * cols + c;
    const float yf = to_f32(y[o]), gf = to_f32(g[o]);
    const float inv = chan[c], shift = chan[cols + c];
    const float r = chan[2 * cols + c], mr = chan[3 * cols + c];
    const float e = chan[4 * cols + c], f = chan[5 * cols + c];
    float gm = gf;
    if (act) {
      const float yn = __fadd_rn(__fmul_rn(yf, inv), shift);
      gm = (yn > 0.f && yn < 6.f) ? gf : 0.f;
    }
    const float yh = __fsub_rn(__fmul_rn(yf, r), mr);
    return __fmul_rn(inv, __fsub_rn(__fsub_rn(gm, e), __fmul_rn(yh, f)));
  }
};

struct Tile {
  float a[BK][BM + 1];
  float b[BK][BN + 1];
};

// acc += A[row0:row0+64, k0:k1) . B[k0:k1, col0:col0+64). Thread
// (tx, ty) = (tid % 16, tid / 16) owns rows ty + 16*i and columns
// tx + 16*j. kAKFast: A's contiguous dimension is k (else its rows);
// kBNFast: B's contiguous dimension is its columns (else k).
template <bool kAKFast, bool kBNFast, typename LoadA, typename LoadB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], Tile& s,
                                         int64_t row0, int64_t col0,
                                         int64_t k0, int64_t k1,
                                         const LoadA& load_a,
                                         const LoadB& load_b) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int64_t kb = k0; kb < k1; kb += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int am = kAKFast ? e / BK : e % BM;
      const int ak = kAKFast ? e % BK : e / BM;
      s.a[ak][am] = kb + ak < k1 ? load_a(row0 + am, kb + ak) : 0.f;
      const int bn = kBNFast ? e % BN : e / BK;
      const int bk = kBNFast ? e / BN : e % BK;
      s.b[bk][bn] = kb + bk < k1 ? load_b(kb + bk, col0 + bn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// y = x.w and the partial column sums of the rounded y and y*y. Block
// (bx, by) takes columns bx*64.. and the row tiles by, by + gridDim.y, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ir_fwd(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, float* __restrict__ part, int64_t m,
                 int ci, int co) {
  __shared__ Tile s;
  __shared__ float red[2][16][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t col0 = int64_t(blockIdx.x) * BN;
  const RowMajor<T> load_x{x, m, ci};
  const RowMajor<T> load_w{w, ci, co};
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, cq[4] = {0.f, 0.f, 0.f, 0.f};
  const int64_t tiles = (m + BM - 1) / BM;
  for (int64_t t = blockIdx.y; t < tiles; t += gridDim.y) {
    float acc[4][4];
    zero(acc);
    const int64_t row0 = t * BM;
    mma_tile<true, true>(acc, s, row0, col0, 0, ci, load_x, load_w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t c = col0 + tx + 16 * j;
        if (r < m && c < co) {
          const T v = from_f32<T>(acc[i][j]);
          y[r * co + c] = v;
          const float b = to_f32(v);
          cs[j] += b;
          cq[j] += b * b;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = cs[j];
    red[1][ty][tx + 16 * j] = cq[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * BN) {
    const int which = threadIdx.x / BN, col = threadIdx.x % BN;
    float sum = 0.f;
    for (int r = 0; r < 16; ++r) sum += red[which][r][col];
    if (col0 + col < co)
      part[(int64_t(blockIdx.y) * 2 + which) * co + col0 + col] = sum;
  }
}

// dx = t.w^T: block (bx, by) writes dx[by*64.., bx*64..].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ir_bwd_dx(const T* __restrict__ g, const T* __restrict__ y,
                    const T* __restrict__ w, const float* __restrict__ chan,
                    T* __restrict__ dx, int64_t m, int ci, int co, int act) {
  __shared__ Tile s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = int64_t(blockIdx.y) * BM;
  const int64_t col0 = int64_t(blockIdx.x) * BN;
  const GradT<T> load_t{g, y, chan, m, co, act};
  const Transposed<T> load_wt{w, co, ci};
  float acc[4][4];
  zero(acc);
  mma_tile<true, false>(acc, s, row0, col0, 0, co, load_t, load_wt);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = col0 + tx + 16 * j;
      if (r < m && c < ci) dx[r * ci + c] = from_f32<T>(acc[i][j]);
    }
  }
}

// dw partial z = x[rows of span z]^T . t[rows of span z]: block
// (bx, by, z) writes dwp[z, by*64.., bx*64..].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ir_bwd_dw(const T* __restrict__ x, const T* __restrict__ g,
                    const T* __restrict__ y, const float* __restrict__ chan,
                    float* __restrict__ dwp, int64_t m, int ci, int co,
                    int act, int64_t span) {
  __shared__ Tile s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = int64_t(blockIdx.y) * BM;
  const int64_t col0 = int64_t(blockIdx.x) * BN;
  const int64_t k0 = int64_t(blockIdx.z) * span;
  const int64_t k1 = k0 + span < m ? k0 + span : m;
  const Transposed<T> load_xt{x, ci, m};
  const GradT<T> load_t{g, y, chan, m, co, act};
  float acc[4][4];
  zero(acc);
  mma_tile<false, true>(acc, s, row0, col0, k0, k1, load_xt, load_t);
  float* out = dwp + int64_t(blockIdx.z) * ci * co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = col0 + tx + 16 * j;
      if (r < ci && c < co) out[r * co + c] = acc[i][j];
    }
  }
}

template <typename T>
void launch_fwd(const void* x, const void* w, void* y, void* part, int64_t m,
                int ci, int co, int p, cudaStream_t stream) {
  const dim3 grid((co + BN - 1) / BN, p);
  fused_ir_fwd<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      static_cast<float*>(part), m, ci, co);
}

template <typename T>
void launch_bwd(const void* x, const void* g, const void* y, const void* w,
                const void* chan, void* dx, void* dwp, int64_t m, int ci,
                int co, int act, int p, int64_t span, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  const float* ct = static_cast<const float*>(chan);
  const dim3 grid_dx((ci + BN - 1) / BN, unsigned((m + BM - 1) / BM));
  fused_ir_bwd_dx<T><<<grid_dx, kThreads, 0, stream>>>(
      gt, yt, static_cast<const T*>(w), ct, static_cast<T*>(dx), m, ci, co,
      act);
  const dim3 grid_dw((co + BN - 1) / BN, (ci + BM - 1) / BM, p);
  fused_ir_bwd_dw<T><<<grid_dw, kThreads, 0, stream>>>(
      xt, gt, yt, ct, static_cast<float*>(dwp), m, ci, co, act, span);
}

}  // namespace

// x [m,ci], w [ci,co] -> y [m,co] and part [p,2,co] float32, with
// 1 <= p <= ceil(m/64). dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tpunet_fused_ir_fwd(const void* x, const void* w, void* y,
                                   void* part, int64_t m, int ci, int co,
                                   int p, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || ci < 1 || co < 1 || p < 1 || p > (m + BM - 1) / BM)
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_fwd<float>(x, w, y, part, m, ci, co, p, s);
  else if (dtype == 1)
    launch_fwd<__nv_bfloat16>(x, w, y, part, m, ci, co, p, s);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// x [m,ci], g and y [m,co], w [ci,co], chan [6,co] float32 -> dx [m,ci]
// and dwp [p,ci,co] float32, span z covering rows [z*span, (z+1)*span),
// p = ceil(m/span). act: 1 when the epilogue had the ReLU6. Launches
// both kernels; returns cudaGetLastError() after them.
extern "C" int tpunet_fused_ir_bwd(const void* x, const void* g,
                                   const void* y, const void* w,
                                   const void* chan, void* dx, void* dwp,
                                   int64_t m, int ci, int co, int act, int p,
                                   int64_t span, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || ci < 1 || co < 1 || p < 1 || span < 1 ||
      (m + span - 1) / span != p || (m + BM - 1) / BM > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_bwd<float>(x, g, y, w, chan, dx, dwp, m, ci, co, act, p, span, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(x, g, y, w, chan, dx, dwp, m, ci, co, act, p,
                              span, s);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}
