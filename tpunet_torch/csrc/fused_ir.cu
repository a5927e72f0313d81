// Fused inverted-residual 1x1 convolution with train-mode BatchNorm: the
// forward and the backward, each behind one C entry.
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
// in float32, and computes dx = t.w^T [M,Ci] in the input type and
// dw = x^T.t as float32 partials [P,Ci,Co], which the caller sums in a
// fixed order. t never goes to device memory: it is rebuilt from g and y
// where the tiles are loaded. The mask and t repeat the plain version's
// arithmetic (tpunet_torch/ops/fused_ir.py) with rounded multiplies and
// adds, so an element at the ReLU6 edge gets the same mask on both.
//
// Which kernel serves which type (by type alone, inside the C entries;
// among the bf16 kernels the caller's plan, ops/fused_ir.py
// forward_plan and backward_plan, picks by shape; no route leads to
// torch):
// - bfloat16: the tensor-core kernels, mma.sync m16n8k16 with float32
//   accumulators, ldmatrix and 16-byte cp.async:
//   - forward: fused_ir_fwd_mma;
//   - backward, narrow channels (dw fits a block's registers and two
//     blocks an SM: MobileNetV2's 112, 56 and 28 px layers but the 28 px
//     expand): fused_ir_bwd_one_pass;
//   - backward, wide channels: fused_ir_bwd_dx_mma and
//     fused_ir_bwd_dw_mma, which rebuild t themselves where Ci is at most
//     128 (the 14 px expands, the 28 px expand), else read t_hi and t_lo
//     that fused_ir_bwd_t wrote first (the 14 px projects, the 7 px
//     layers);
// - float32: the SIMT kernels fused_ir_fwd, fused_ir_bwd_dx and
//   fused_ir_bwd_dw (64x64 output tiles, fmaf on the CUDA cores).
//
// Bound: at MobileNetV2's widths (Ci, Co from 16 to 960) a product has
// 2*Ci*Co/(2*(Ci+Co)) ~ 8..240 operations per byte of x and y in bf16,
// below the ~295 at which the tensor cores would bound a bf16 product:
// bytes bound every layer, the narrow ones, which carry most of the
// bytes, by far.
//
// Design of the tensor-core kernels against that bound:
// - 4 warps a block, each owning 16 rows of a 64-row tile; products are
//   mma.sync m16n8k16 on bf16 fragments loaded by ldmatrix from shared
//   tiles whose rows are padded by 16 bytes (conflict-free ldmatrix);
// - copies are 16-byte cp.async through kStages stages, each thread
//   walking its cells with no division (Walk); results go through shared
//   memory to 16-byte stores, so a warp writes whole rows;
// - n8 output blocks: a forward block covers a strip of up to 96 columns
//   in n8 blocks (Co = 16, 24 or 32 computes no padding column), and Ci
//   is padded only to the next multiple of 16 by zero-filled copies;
// - the forward's blocks are persistent: each walks row tiles with a
//   grid stride, and the threads that store an n8 block of y keep its
//   column sums in registers, one [2, Co] partial a block; w stays in
//   shared memory where all of Ci is one step, else it is staged with x
//   in equal chunks;
// - t is float32 in the reference; x and w are exact in bf16, so only t
//   is split: t = t_hi + t_lo, both bf16, and every product of t is two
//   mma.sync into the same float32 accumulator. The products are exact
//   in float32, and |t - t_hi - t_lo| <= 2^-17 |t|: inside the gate of
//   1e-5 of the sum of the products' magnitudes, where one bf16 or TF32
//   rounding of t (2^-9, 2^-11) would not be;
// - one pass for narrow channels: a block stages x, g and y of a tile
//   once, builds t_hi and t_lo in place of g and y, adds x^T.t (x through
//   ldmatrix.trans) to a dw accumulator it keeps in registers over its
//   tiles, and computes that tile's dx = t.w^T (w resident); so x, g and
//   y are read once and t never leaves shared memory;
// - wide channels: dx by row tiles x 64-column Ci strips (k over Co in
//   chunks of 32), dw by 64x64 Ci x Co tiles with split-K over spans of
//   rows. Each kernel rebuilding t would repeat it once per 64 columns of
//   Ci, which on the card cost more than writing t once where Ci > 128;
// - no float atomics: every sum is taken in a fixed order, so two
//   launches give the same bits;
// - odd shapes (Ci or Co off a multiple of 8) and views not 16-byte
//   aligned load element by element into the same zero-padded tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// t(m, c) from y, g and the channel's six terms, in the plain version's
// order of rounded operations.
__device__ __forceinline__ float grad_t(float yf, float gf, float inv,
                                        float shift, float r, float mr,
                                        float e, float f, int act) {
  float gm = gf;
  if (act) {
    const float yn = __fadd_rn(__fmul_rn(yf, inv), shift);
    gm = (yn > 0.f && yn < 6.f) ? gf : 0.f;
  }
  const float yh = __fsub_rn(__fmul_rn(yf, r), mr);
  return __fmul_rn(inv, __fsub_rn(__fsub_rn(gm, e), __fmul_rn(yh, f)));
}

// ---------------------------------------------------------------------------
// SIMT kernels: the float32 forward and backward
// ---------------------------------------------------------------------------
//
// One tiled product, 64x64 outputs per block of 256 threads, 4x4 per
// thread, k in steps of 16 through shared memory; the operands come
// through loader functors, so the three products (x.w, t.w^T, x^T.t)
// share it, and t is made inside the loader from g, y and chan. The
// loads of each tile walk the operand's contiguous dimension with
// neighbouring threads; shared rows are padded by one word. dw is split
// over rows (blockIdx.z) into spans.

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

// Element (r, c) of a row-major [rows, cols] matrix.
struct RowMajor {
  const float* p;
  int64_t rows, cols;
  __device__ __forceinline__ float operator()(int64_t r, int64_t c) const {
    return (r < rows && c < cols) ? p[r * cols + c] : 0.f;
  }
};

// Element (r, c) of the transpose of a row-major [cols, rows] matrix.
struct Transposed {
  const float* p;
  int64_t rows, cols;
  __device__ __forceinline__ float operator()(int64_t r, int64_t c) const {
    return (r < rows && c < cols) ? p[c * rows + r] : 0.f;
  }
};

// t(m, co), the gradient of the conv output, rebuilt from g, y and chan.
struct GradT {
  const float* g;
  const float* y;
  const float* chan;
  int64_t rows, cols;
  int act;
  __device__ __forceinline__ float operator()(int64_t m, int64_t c) const {
    if (m >= rows || c >= cols) return 0.f;
    const int64_t o = m * cols + c;
    return grad_t(y[o], g[o], chan[c], chan[cols + c], chan[2 * cols + c],
                  chan[3 * cols + c], chan[4 * cols + c], chan[5 * cols + c],
                  act);
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

// y = x.w and the partial column sums of y and y*y. Block (bx, by) takes
// columns bx*64.. and the row tiles by, by + gridDim.y, ...
__global__ void __launch_bounds__(kThreads)
    fused_ir_fwd(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, float* __restrict__ part, int64_t m,
                 int ci, int co) {
  __shared__ Tile s;
  __shared__ float red[2][16][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t col0 = int64_t(blockIdx.x) * BN;
  const RowMajor load_x{x, m, ci};
  const RowMajor load_w{w, ci, co};
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
          const float b = acc[i][j];
          y[r * co + c] = b;
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
__global__ void __launch_bounds__(kThreads)
    fused_ir_bwd_dx(const float* __restrict__ g, const float* __restrict__ y,
                    const float* __restrict__ w,
                    const float* __restrict__ chan, float* __restrict__ dx,
                    int64_t m, int ci, int co, int act) {
  __shared__ Tile s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = int64_t(blockIdx.y) * BM;
  const int64_t col0 = int64_t(blockIdx.x) * BN;
  const GradT load_t{g, y, chan, m, co, act};
  const Transposed load_wt{w, co, ci};
  float acc[4][4];
  zero(acc);
  mma_tile<true, false>(acc, s, row0, col0, 0, co, load_t, load_wt);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = col0 + tx + 16 * j;
      if (r < m && c < ci) dx[r * ci + c] = acc[i][j];
    }
  }
}

// dw partial z = x[rows of span z]^T . t[rows of span z]: block
// (bx, by, z) writes dwp[z, by*64.., bx*64..].
__global__ void __launch_bounds__(kThreads)
    fused_ir_bwd_dw(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ y,
                    const float* __restrict__ chan, float* __restrict__ dwp,
                    int64_t m, int ci, int co, int act, int64_t span) {
  __shared__ Tile s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = int64_t(blockIdx.y) * BM;
  const int64_t col0 = int64_t(blockIdx.x) * BN;
  const int64_t k0 = int64_t(blockIdx.z) * span;
  const int64_t k1 = k0 + span < m ? k0 + span : m;
  const Transposed load_xt{x, ci, m};
  const GradT load_t{g, y, chan, m, co, act};
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

// ---------------------------------------------------------------------------
// Tensor-core kernels: the bf16 forward and backward
// ---------------------------------------------------------------------------

constexpr int kRows = 64;          // rows of a tile: 4 warps x 16
constexpr int kMmaThreads = 128;
constexpr int kStages = 3;         // cp.async stages of the pipelined loops
constexpr int kMaxStrip = 96;      // widest forward strip: 12 n8 blocks
constexpr int kOnePassTiles = 12;  // one-pass: dw m16 x n8 tiles a warp
constexpr int kDxChunk = 32;       // wide dx: Co a stage
constexpr int kDwRows = 32;        // wide dw: rows a stage
constexpr int kTile = 64;          // wide: dx Ci strip, dw Ci x Co tile
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may take

__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) / 16 * 16;
}

// A thread's walk over the cells of a tile `span` cells wide: it starts
// at cell threadIdx.x and steps kMmaThreads cells at a time, so a loop
// over the tile divides once, when the walk is made.
struct Walk {
  int r, c, rstep, cstep, span;
  __device__ __forceinline__ explicit Walk(int span_) : span(span_) {
    rstep = kMmaThreads / span;
    cstep = kMmaThreads - rstep * span;
    r = threadIdx.x / span;
    c = threadIdx.x - r * span;
  }
  __device__ __forceinline__ void next(int& rr, int& cc) const {
    rr += rstep;
    cc += cstep;
    if (cc >= span) {
      cc -= span;
      ++rr;
    }
  }
};

// The walk of a tile `width` elements wide for stage_rows and copy_out:
// cells of 8 elements where vec, else single elements.
__device__ __forceinline__ Walk tile_walk(int width, bool vec) {
  return Walk(vec ? width / 8 : width);
}

// Rows [r0, r0 + rows) and columns [c0, c0 + width) of a row-major bf16
// [nr, nc] matrix into dst (row stride ld), zero outside the matrix, with
// wk = tile_walk(width, vec). vec (nc % 8 == 0, src 16-byte aligned): one
// 16-byte cp.async per 8 elements; else plain element loads.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           int64_t nr, int nc, int64_t r0,
                                           int c0, int rows, const Walk& wk,
                                           bool vec) {
  const int unit = vec ? 8 : 1;
  int r = wk.r, c = wk.c;
  while (r < rows) {
    const int col = c0 + c * unit;
    const bool ok = r0 + r < nr && col < nc;
    const bf16* s = src + (r0 + r) * nc + col;
    if (vec)
      cp_async16(dst + r * ld + c * 8, ok ? s : src, ok);
    else
      dst[r * ld + c] = ok ? *s : __float2bfloat16_rn(0.f);
    wk.next(r, c);
  }
}

// Rows [0, rows) of a bf16 shared tile (row stride ld) to rows r0.. and
// columns c0.. of a row-major bf16 [nr, nc] matrix, inside its bounds,
// with wk = tile_walk(width, vec): 16 bytes a thread where vec (nc % 8 ==
// 0 and dst 16-byte aligned), so a warp writes whole rows.
__device__ __forceinline__ void copy_out(bf16* dst, int64_t nr, int nc,
                                         int64_t r0, int c0, const bf16* src,
                                         int ld, int rows, const Walk& wk,
                                         bool vec) {
  const int unit = vec ? 8 : 1;
  int r = wk.r, c = wk.c;
  while (r < rows && r0 + r < nr) {
    const int col = c0 + c * unit;
    if (col < nc) {
      bf16* d = dst + (r0 + r) * nc + col;
      if (vec)
        *reinterpret_cast<uint4*>(d) =
            *reinterpret_cast<const uint4*>(src + r * ld + c * 8);
      else
        *d = src[r * ld + c];
    }
    wk.next(r, c);
  }
}

// chan[k][c0 .. c0 + width) for the six rows k into dst[6][width], zero
// at or past co.
__device__ __forceinline__ void stage_chan(float* dst, const float* chan,
                                           int co, int c0, int width) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    for (int c = threadIdx.x; c < width; c += kMmaThreads) {
      const bool ok = c0 + c < co;
      cp_async4(dst + k * width + c, ok ? chan + k * co + c0 + c : chan, ok);
    }
  }
}

// t of a staged [rows][width] tile of g (gs) and y (ys), built in place:
// t rounded to bf16 (t_hi) over g and t - t_hi rounded to bf16 (t_lo)
// over y. ch holds the six chan rows of the tile's columns, [6][width].
// t is 0 at rows at or past rows_left and columns at or past cols_left,
// which the products' zero padding needs. wk = Walk(width / 4): a thread
// keeps four columns (and their chan terms) and walks the rows; the
// threads past the last whole row of quads wait.
__device__ __forceinline__ void build_t(bf16* gs, bf16* ys, int ld,
                                        const float* ch, int rows, int width,
                                        const Walk& wk, int64_t rows_left,
                                        int cols_left, int act) {
  if (wk.r >= wk.rstep) return;
  const int c = 4 * wk.c;
  float k[6][4];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(ch + j * width + c);
    k[j][0] = v.x;
    k[j][1] = v.y;
    k[j][2] = v.z;
    k[j][3] = v.w;
  }
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ok[i] = c + i < cols_left;
  const int last = rows_left < rows ? int(rows_left) : rows;
  for (int r = wk.r; r < rows; r += wk.rstep) {
    uint2* gp = reinterpret_cast<uint2*>(gs + r * ld + c);
    uint2* yp = reinterpret_cast<uint2*>(ys + r * ld + c);
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < last) {
      const uint2 gu = *gp, yu = *yp;
      const bf16* gv = reinterpret_cast<const bf16*>(&gu);
      const bf16* yv = reinterpret_cast<const bf16*>(&yu);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ok[i])
          t[i] = grad_t(__bfloat162float(yv[i]), __bfloat162float(gv[i]),
                        k[0][i], k[1][i], k[2][i], k[3][i], k[4][i], k[5][i],
                        act);
    }
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(t[0], t[1]);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(t[2], t[3]);
    const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
    const __nv_bfloat162 l0 = __floats2bfloat162_rn(__fsub_rn(t[0], f0.x),
                                                    __fsub_rn(t[1], f0.y));
    const __nv_bfloat162 l1 = __floats2bfloat162_rn(__fsub_rn(t[2], f1.x),
                                                    __fsub_rn(t[3], f1.y));
    uint2 hu, lu;
    hu.x = *reinterpret_cast<const uint32_t*>(&h0);
    hu.y = *reinterpret_cast<const uint32_t*>(&h1);
    lu.x = *reinterpret_cast<const uint32_t*>(&l0);
    lu.y = *reinterpret_cast<const uint32_t*>(&l1);
    *gp = hu;
    *yp = lu;
  }
}

// Two neighbouring bf16 values (c, c + 1) into row r of a shared tile.
__device__ __forceinline__ void put_pair(bf16* tile, int ld, int r, int c,
                                         float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + r * ld + c) =
      __floats2bfloat162_rn(v0, v1);
}

// Shared memory of the forward for Ci padded to 16 (cip), strips of
// 8*ns columns and k chunks of kc (dividing cip): kStages x tiles, w
// (resident when Ci is one chunk, else kStages chunks), the y tile and
// the column sums.
__host__ __device__ __forceinline__ int fwd_smem(int cip, int ns, int kc) {
  const int ldw = (ns + 1) / 2 * 16 + 8;
  const int wrows = kc >= cip ? cip : kStages * kc;
  return (kStages * kRows * (kc + 8) + wrows * ldw + kRows * (8 * ns + 8)) *
             2 + kMmaThreads * 16 * 4;
}

// y = x.w and the column sums of the rounded y and y*y. Block (bx, by)
// takes the strip of 8*ns columns bx*8*ns.. and the row tiles by,
// by + gridDim.y, ...; k (Ci, padded to 16) in chunks of kc. The steps
// (tile, chunk) run in one sequence through kStages stages, so the next
// steps' copies are in flight during this one's products. A finished
// tile goes through shared memory to whole-row 16-byte stores; the
// threads that store an n8 block of it add its columns to their sums.
__global__ void __launch_bounds__(kMmaThreads)
    fused_ir_fwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     bf16* __restrict__ y, float* __restrict__ part,
                     int64_t m, int ci, int co, int ns, int kc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int strip = 8 * ns, col0 = blockIdx.x * strip;
  const int wcols = (ns + 1) / 2 * 16, ldw = wcols + 8, ldx = kc + 8;
  const int ldy = strip + 8;
  const int cip = round16(ci), nk = cip / kc;
  const bool resident = nk == 1;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kStages][kRows][ldx]
  bf16* ws = xs + kStages * kRows * ldx;     // [cip | kStages*kc][ldw]
  bf16* yst = ws + (resident ? cip : kStages * kc) * ldw;  // [kRows][ldy]
  float* red = reinterpret_cast<float*>(yst + kRows * ldy);  // [128][16]
  const int64_t tiles = (m + kRows - 1) / kRows;
  const Walk xw = tile_walk(kc, vec), ww = tile_walk(wcols, vec);

  auto load = [&](int st, int64_t tile, int kci) {
    const int k0 = kci * kc;
    stage_rows(xs + st * kRows * ldx, ldx, x, m, ci, tile * kRows, k0, kRows,
               xw, vec);
    if (!resident)
      stage_rows(ws + st * kc * ldw, ldw, w, ci, co, k0, col0, kc, ww, vec);
  };
  // (tile, chunk, stage) of the next step to load and to compute.
  auto advance = [&](int64_t& tile, int& kci, int& st) {
    if (++kci == nk) {
      kci = 0;
      tile += gridDim.y;
    }
    if (++st == kStages) st = 0;
  };
  if (resident) stage_rows(ws, ldw, w, ci, co, 0, col0, cip, ww, vec);
  int64_t ptile = blockIdx.y;
  int pkc = 0, pst = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ptile < tiles) {
      load(pst, ptile, pkc);
      advance(ptile, pkc, pst);
    }
    cp_async_commit();
  }

  // The thread that stores n8 block cj of rows cr, cr + rstep, ...
  const int rstep = kMmaThreads / ns, cj = threadIdx.x % ns;
  const int cr = threadIdx.x / ns;
  const int c = col0 + 8 * cj;
  const bool vec_out = co % 8 == 0;
  float acc[12][4], cs[8], cq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cs[i] = cq[i] = 0.f;

  int64_t tile = blockIdx.y;
  int kci = 0, st = 0;
  while (tile < tiles) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ptile < tiles) {
      load(pst, ptile, pkc);
      advance(ptile, pkc, pst);
    }
    cp_async_commit();
    if (kci == 0) {
#pragma unroll
      for (int j = 0; j < 12; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    const bf16* xt = xs + st * kRows * ldx + (warp * 16 + lane % 16) * ldx +
                     (lane / 16) * 8;
    const bf16* wt = (resident ? ws : ws + st * kc * ldw) +
                     (((lane / 8) % 2) * 8 + lane % 8) * ldw + (lane / 16) * 8;
    for (int kk = 0; kk < kc / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, xt + kk * 16);
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        if (2 * jj < ns) {
          uint32_t b[4];
          ldsm_x4_t(b, wt + kk * 16 * ldw + jj * 16);
          mma_bf16(acc[2 * jj], a, b[0], b[1]);
          if (2 * jj + 1 < ns) mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
        }
      }
    }
    if (kci == nk - 1) {
      const int r = warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        if (j < ns) {
          const int cc = 8 * j + 2 * (lane % 4);
          put_pair(yst, ldy, r, cc, acc[j][0], acc[j][1]);
          put_pair(yst, ldy, r + 8, cc, acc[j][2], acc[j][3]);
        }
      }
      __syncthreads();
      const int64_t row0 = tile * kRows;
      if (cr < rstep) {
        for (int r2 = cr; r2 < kRows && row0 + r2 < m; r2 += rstep) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(yst + r2 * ldy + 8 * cj);
          bf16* d = y + (row0 + r2) * co + c;
          const bf16* e = reinterpret_cast<const bf16*>(&v);
          if (vec_out && c < co) {
            *reinterpret_cast<uint4*>(d) = v;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (c + i < co) d[i] = e[i];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float f = c + i < co ? __bfloat162float(e[i]) : 0.f;
            cs[i] += f;
            cq[i] = fmaf(f, f, cq[i]);
          }
        }
      }
    }
    advance(tile, kci, st);
  }
  // Column sums: the storing threads of each n8 block, in order.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[threadIdx.x * 16 + i] = cs[i];
    red[threadIdx.x * 16 + 8 + i] = cq[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * strip; e += kMmaThreads) {
    const int which = e >= strip, col = e - which * strip;
    const int j = col / 8, i = col % 8;
    float sum = 0.f;
    for (int rr = 0; rr < rstep; ++rr)
      sum += red[(rr * ns + j) * 16 + which * 8 + i];
    if (col0 + col < co)
      part[(int64_t(blockIdx.y) * 2 + which) * co + col0 + col] = sum;
  }
}

// Shared memory of the one-pass backward for Ci, Co padded to 16: two
// stages of x, g and y tiles, w, the dx tile, chan, the warps' dw tiles.
__host__ __device__ __forceinline__ int one_pass_smem(int cip, int cop) {
  return (3 * kRows * (cip + 8) + 4 * kRows * (cop + 8) + cip * (cop + 8)) *
             2 + 6 * cop * 4 + 4 * kOnePassTiles * 2 * 4;
}

// dx and a dw partial in one pass over x, g and y (narrow channels):
// block b walks the row tiles b, b + gridDim.x, ...; for each it stages
// x, g and y once, builds t_hi and t_lo, adds x^T.t to its dw, held in
// registers as (Ci/16)*(Co/8) m16 x n8 tiles, 12 at most a warp (the
// tiles' offsets in a table made once), and computes that tile's
// dx = t.w^T (w resident, Ci in strips of 64), stored through shared
// memory; at the end it writes dwp[b].
__global__ void __launch_bounds__(kMmaThreads)
    fused_ir_bwd_one_pass(const bf16* __restrict__ x,
                          const bf16* __restrict__ g,
                          const bf16* __restrict__ y,
                          const bf16* __restrict__ w,
                          const float* __restrict__ chan,
                          bf16* __restrict__ dx, float* __restrict__ dwp,
                          int64_t m, int ci, int co, int act, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, q = lane / 8;
  const int cip = round16(ci), cop = round16(co);
  const int ldx = cip + 8, ldg = cop + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [2][kRows][ldx]
  bf16* gs = xs + 2 * kRows * ldx;           // [2][kRows][ldg]
  bf16* ys = gs + 2 * kRows * ldg;           // [2][kRows][ldg]
  bf16* ws = ys + 2 * kRows * ldg;           // [cip][ldg]
  bf16* dxs = ws + cip * ldg;                // [kRows][ldx]
  float* ch = reinterpret_cast<float*>(dxs + kRows * ldx);  // [6][cop]
  int2* slots = reinterpret_cast<int2*>(ch + 6 * cop);      // [4][12]
  const int64_t tiles = (m + kRows - 1) / kRows;
  const int nb8 = cop / 8, ntiles = (cip / 16) * nb8;
  const int nt = (ntiles + 3) / 4;
  const bool vec_out = ci % 8 == 0;
  const Walk xw = tile_walk(cip, vec), gw = tile_walk(cop, vec);
  const Walk ow = tile_walk(cip, vec_out), tw(cop / 4);
  if (threadIdx.x < 4 * kOnePassTiles) {
    // Slot i of warp v: dw tile min(4i + v, last) as (x column, t column).
    const int v = threadIdx.x / kOnePassTiles, i = threadIdx.x % kOnePassTiles;
    const int idx = min(i * 4 + v, ntiles - 1), mi = idx / nb8;
    slots[threadIdx.x] = make_int2(mi * 16, (idx - mi * nb8) * 8);
  }

  auto load = [&](int st, int64_t tile) {
    const int64_t r0 = tile * kRows;
    stage_rows(xs + st * kRows * ldx, ldx, x, m, ci, r0, 0, kRows, xw, vec);
    stage_rows(gs + st * kRows * ldg, ldg, g, m, co, r0, 0, kRows, gw, vec);
    stage_rows(ys + st * kRows * ldg, ldg, y, m, co, r0, 0, kRows, gw, vec);
  };

  float dw[kOnePassTiles][4];
#pragma unroll
  for (int i = 0; i < kOnePassTiles; ++i)
    dw[i][0] = dw[i][1] = dw[i][2] = dw[i][3] = 0.f;

  // Per-lane parts of the ldmatrix addresses.
  const int xa = ((q >> 1) * 8 + lane % 8) * ldx + (q & 1) * 8;
  const int tb = ((q & 1) * 8 + lane % 8) * ldg + ((q >> 1) ? 2 * kRows * ldg : 0);
  const int ta = (warp * 16 + lane % 16) * ldg + (lane / 16) * 8;
  const int wb = ((lane / 16) * 8 + lane % 8) * ldg + ((lane / 8) % 2) * 8;
  const int r = warp * 16 + lane / 4;

  int64_t tile = blockIdx.x;
  int st = 0;
  stage_rows(ws, ldg, w, ci, co, 0, 0, cip, gw, vec);
  stage_chan(ch, chan, co, 0, cop);
  load(0, tile);
  cp_async_commit();
  for (;;) {
    cp_async_wait<0>();
    __syncthreads();
    const int64_t next = tile + gridDim.x;
    const bool more = next < tiles;
    if (more) load(st ^ 1, next);
    cp_async_commit();
    const bf16* xt = xs + st * kRows * ldx;
    bf16* th = gs + st * kRows * ldg;
    build_t(th, ys + st * kRows * ldg, ldg, ch, kRows, cop, tw,
            m - tile * kRows, co, act);
    __syncthreads();

    // dw += x^T.t over this tile's 64 rows (4 k16 steps).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < kOnePassTiles; ++i) {
        if (i < nt) {
          const int2 o = slots[warp * kOnePassTiles + i];
          uint32_t a[4], b[4];
          ldsm_x4_t(a, xt + kk * 16 * ldx + xa + o.x);
          ldsm_x4_t(b, th + kk * 16 * ldg + tb + o.y);
          mma_bf16(dw[i], a, b[0], b[1]);
          mma_bf16(dw[i], a, b[2], b[3]);
        }
      }
    }

    // dx = t.w^T for this tile, Ci in strips of 64 columns.
    for (int s0 = 0; s0 < cip; s0 += 64) {
      const int nb = min(64, cip - s0) / 8;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kk = 0; kk < cop / 16; ++kk) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, th + ta + kk * 16);
        ldsm_x4(al, th + 2 * kRows * ldg + ta + kk * 16);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (2 * jj < nb) {
            uint32_t b[4];
            ldsm_x4(b, ws + (s0 + jj * 16) * ldg + wb + kk * 16);
            mma_bf16(acc[2 * jj], ah, b[0], b[1]);
            mma_bf16(acc[2 * jj + 1], ah, b[2], b[3]);
            mma_bf16(acc[2 * jj], al, b[0], b[1]);
            mma_bf16(acc[2 * jj + 1], al, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nb) {
          const int c = s0 + 8 * j + 2 * (lane % 4);
          put_pair(dxs, ldx, r, c, acc[j][0], acc[j][1]);
          put_pair(dxs, ldx, r + 8, c, acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();
    copy_out(dx, m, ci, tile * kRows, 0, dxs, ldx, kRows, ow, vec_out);
    if (!more) break;
    tile = next;
    st ^= 1;
  }

  float* out = dwp + int64_t(blockIdx.x) * ci * co;
#pragma unroll
  for (int i = 0; i < kOnePassTiles; ++i) {
    if (i < nt && i * 4 + warp < ntiles) {
      const int2 o = slots[warp * kOnePassTiles + i];
      const int rr = o.x + lane / 4, c = o.y + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rr + 8 * h < ci) {
          if (c < co) out[(rr + 8 * h) * co + c] = dw[i][2 * h];
          if (c + 1 < co) out[(rr + 8 * h) * co + c + 1] = dw[i][2 * h + 1];
        }
      }
    }
  }
}

// t_hi and t_lo [m, co] bf16 of the whole gradient, for the wide kernels
// where a rebuild in each of them would repeat t once per 64 columns of
// Ci. Thread i of the grid keeps the column chunk i % (co / kUnit), with
// its chan terms, and walks the rows i / (co / kUnit), + rows, ... where
// the grid holds rows * (co / kUnit) threads. kVec (co % 8 == 0, 16-byte
// aligned): chunks of 8 elements.
template <bool kVec>
__global__ void __launch_bounds__(256)
    fused_ir_bwd_t(const bf16* __restrict__ g, const bf16* __restrict__ y,
                   const float* __restrict__ chan, bf16* __restrict__ th,
                   bf16* __restrict__ tl, int64_t m, int co, int rows,
                   int act) {
  constexpr int kUnit = kVec ? 8 : 1;
  const int chunks = co / kUnit;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * chunks) return;
  const int r0 = t / chunks, c = (t - r0 * chunks) * kUnit;
  float k[6][kUnit];
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int i = 0; i < kUnit; ++i) k[j][i] = chan[j * co + c + i];
  for (int64_t r = r0; r < m; r += rows) {
    const int64_t e = r * co + c;
    alignas(16) bf16 gv[kUnit], yv[kUnit], hv[kUnit], lv[kUnit];
    if (kVec) {
      *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(g + e);
      *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(y + e);
    } else {
      gv[0] = g[e];
      yv[0] = y[e];
    }
#pragma unroll
    for (int i = 0; i < kUnit; ++i) {
      const float tv = grad_t(__bfloat162float(yv[i]), __bfloat162float(gv[i]),
                              k[0][i], k[1][i], k[2][i], k[3][i], k[4][i],
                              k[5][i], act);
      hv[i] = __float2bfloat16_rn(tv);
      lv[i] = __float2bfloat16_rn(__fsub_rn(tv, __bfloat162float(hv[i])));
    }
    if (kVec) {
      *reinterpret_cast<uint4*>(th + e) = *reinterpret_cast<const uint4*>(hv);
      *reinterpret_cast<uint4*>(tl + e) = *reinterpret_cast<const uint4*>(lv);
    } else {
      th[e] = hv[0];
      tl[e] = lv[0];
    }
  }
}

// Shared memory of the wide dx kernel: kStages stages of the g (t_hi), y
// (t_lo) and w chunks, chan when it rebuilds t, the dx tile.
__host__ __device__ __forceinline__ int dx_smem(bool build) {
  return (3 * kStages * kRows * (kDxChunk + 8) + kRows * (kTile + 8)) * 2 +
         (build ? kStages * 6 * kDxChunk * 4 : 0);
}

// dx = t.w^T for wide channels: block (bx, by) writes dx[by*64.., bx*64..]
// through shared memory; k (Co, padded to 16) in chunks of kw (32, or 16
// where 32 does not divide it) through kStages stages. kBuild: a and b
// are g and y, and t is rebuilt from them; else they are t_hi and t_lo.
template <bool kBuild>
__global__ void __launch_bounds__(kMmaThreads)
    fused_ir_bwd_dx_mma(const bf16* __restrict__ a, const bf16* __restrict__ b,
                        const bf16* __restrict__ w,
                        const float* __restrict__ chan, bf16* __restrict__ dx,
                        int64_t m, int ci, int co, int act, int vec) {
  constexpr int ld = kDxChunk + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* gs = reinterpret_cast<bf16*>(smem);  // [kStages][kRows][ld]
  bf16* ys = gs + kStages * kRows * ld;      // [kStages][kRows][ld]
  bf16* ws = ys + kStages * kRows * ld;      // [kStages][kTile][ld]
  bf16* dxs = ws + kStages * kTile * ld;     // [kRows][kTile + 8]
  float* ch = reinterpret_cast<float*>(dxs + kRows * (kTile + 8));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int s0 = blockIdx.x * kTile;
  const int64_t row0 = int64_t(blockIdx.y) * kRows;
  const int cip = round16(ci), cop = round16(co);
  const int nb = min(kTile, cip - s0) / 8;
  const int kw = cop % kDxChunk ? 16 : kDxChunk, nk = cop / kw;
  const Walk cw = tile_walk(kw, vec), tw(kw / 4);

  auto load = [&](int kc) {
    const int st = kc % kStages, k0 = kc * kw;
    stage_rows(gs + st * kRows * ld, ld, a, m, co, row0, k0, kRows, cw, vec);
    stage_rows(ys + st * kRows * ld, ld, b, m, co, row0, k0, kRows, cw, vec);
    stage_rows(ws + st * kTile * ld, ld, w, ci, co, s0, k0, kTile, cw, vec);
    if (kBuild) stage_chan(ch + st * 6 * kw, chan, co, k0, kw);
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int ta = (warp * 16 + lane % 16) * ld + (lane / 16) * 8;
  const int wb = ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < nk) load(kc + kStages - 1);
    cp_async_commit();
    bf16* th = gs + st * kRows * ld;
    bf16* tl = ys + st * kRows * ld;
    if (kBuild) {
      build_t(th, tl, ld, ch + st * 6 * kw, kRows, kw, tw, m - row0,
              co - kc * kw, act);
      __syncthreads();
    }
    const bf16* wt = ws + st * kTile * ld + wb;
    for (int kk = 0; kk < kw / 16; ++kk) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, th + ta + kk * 16);
      ldsm_x4(al, tl + ta + kk * 16);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (2 * jj < nb) {
          uint32_t bb[4];
          ldsm_x4(bb, wt + jj * 16 * ld + kk * 16);
          mma_bf16(acc[2 * jj], ah, bb[0], bb[1]);
          mma_bf16(acc[2 * jj + 1], ah, bb[2], bb[3]);
          mma_bf16(acc[2 * jj], al, bb[0], bb[1]);
          mma_bf16(acc[2 * jj + 1], al, bb[2], bb[3]);
        }
      }
    }
  }
  const int r = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nb) {
      const int c = 8 * j + 2 * (lane % 4);
      put_pair(dxs, kTile + 8, r, c, acc[j][0], acc[j][1]);
      put_pair(dxs, kTile + 8, r + 8, c, acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  const bool vec_out = ci % 8 == 0;
  copy_out(dx, m, ci, row0, s0, dxs, kTile + 8, kRows,
           tile_walk(nb * 8, vec_out), vec_out);
}

// Shared memory of the wide dw kernel: kStages stages of the x, g (t_hi)
// and y (t_lo) chunks, chan when it rebuilds t.
__host__ __device__ __forceinline__ int dw_smem(bool build) {
  return 3 * kStages * kDwRows * (kTile + 8) * 2 +
         (build ? 6 * kTile * 4 : 0);
}

// dw partial z = x[rows of span z]^T . t[rows of span z] for wide
// channels: block (bx, by, z) writes dwp[z, by*64.., bx*64..]; warp
// (wm, wn) owns 32 x 32 of it; the span's rows in chunks of 32 through
// kStages stages. kBuild as for the dx kernel.
template <bool kBuild>
__global__ void __launch_bounds__(kMmaThreads)
    fused_ir_bwd_dw_mma(const bf16* __restrict__ x, const bf16* __restrict__ a,
                        const bf16* __restrict__ b,
                        const float* __restrict__ chan,
                        float* __restrict__ dwp, int64_t m, int ci, int co,
                        int act, int64_t span, int vec) {
  constexpr int ld = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kStages][kDwRows][ld]
  bf16* gs = xs + kStages * kDwRows * ld;
  bf16* ys = gs + kStages * kDwRows * ld;
  float* ch = reinterpret_cast<float*>(ys + kStages * kDwRows * ld);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, q = lane / 8;
  const int wm = warp / 2, wn = warp % 2;
  const int c0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const int64_t k0 = int64_t(blockIdx.z) * span;
  const int64_t k1 = k0 + span < m ? k0 + span : m;
  const int nk = int((k1 - k0 + kDwRows - 1) / kDwRows);
  const Walk cw = tile_walk(kTile, vec), tw(kTile / 4);

  auto load = [&](int kc) {
    const int st = kc % kStages;
    const int64_t r0 = k0 + int64_t(kc) * kDwRows;
    stage_rows(xs + st * kDwRows * ld, ld, x, k1, ci, r0, i0, kDwRows, cw,
               vec);
    stage_rows(gs + st * kDwRows * ld, ld, a, k1, co, r0, c0, kDwRows, cw,
               vec);
    stage_rows(ys + st * kDwRows * ld, ld, b, k1, co, r0, c0, kDwRows, cw,
               vec);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  if (kBuild) stage_chan(ch, chan, co, c0, kTile);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int xa = ((q >> 1) * 8 + lane % 8) * ld + wm * 32 + (q & 1) * 8;
  const int tb = ((q & 1) * 8 + lane % 8) * ld + wn * 32 +
                 ((q >> 1) ? kStages * kDwRows * ld : 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < nk) load(kc + kStages - 1);
    cp_async_commit();
    const bf16* xt = xs + st * kDwRows * ld;
    bf16* th = gs + st * kDwRows * ld;
    if (kBuild) {
      build_t(th, ys + st * kDwRows * ld, ld, ch, kDwRows, kTile, tw,
              k1 - (k0 + int64_t(kc) * kDwRows), co - c0, act);
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < kDwRows / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(af[i], xt + kk * 16 * ld + xa + i * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        ldsm_x4_t(bf, th + kk * 16 * ld + tb + j * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][j], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  float* out = dwp + int64_t(blockIdx.z) * ci * co;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i0 + wm * 32 + i * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + wn * 32 + j * 8 + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h < ci) {
          float* o = out + (r + 8 * h) * co + c;
          if (co % 2 == 0 && c < co) {
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          } else {
            if (c < co) o[0] = acc[i][j][2 * h];
            if (c + 1 < co) o[1] = acc[i][j][2 * h + 1];
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches a kernel with `bytes` of dynamic shared memory, raising its
// limit first where it is above the default 48 KB.
template <typename Kernel, typename... Args>
cudaError_t launch_smem(Kernel kernel, dim3 grid, int bytes, cudaStream_t s,
                        Args... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kMmaThreads, bytes, s>>>(args...);
  return cudaSuccess;
}

}  // namespace

// x [m,ci], w [ci,co] -> y [m,co] and part [p,2,co] float32, from p blocks
// along the rows, each covering strips of `strip` columns. float32
// (dtype 0): the SIMT kernel, strip 64, kc 16. bfloat16 (dtype 1): the
// tensor-core kernel, strip a multiple of 8 up to 96, k chunks of kc (a
// multiple of 16 that divides Ci padded to 16). 1 <= p <= min(ceil(m/64), 65535). Returns
// cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue on a plan it cannot run.
extern "C" int tpunet_fused_ir_fwd(const void* x, const void* w, void* y,
                                   void* part, int64_t m, int ci, int co,
                                   int p, int strip, int kc, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || ci < 1 || co < 1 || p < 1 || p > (m + kRows - 1) / kRows ||
      p > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && strip == BN && kc == BK) {
    const dim3 grid((co + BN - 1) / BN, p);
    fused_ir_fwd<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), static_cast<float*>(part), m, ci, co);
  } else if (dtype == 1 && strip >= 8 && strip <= kMaxStrip &&
             strip % 8 == 0 && kc >= 16 && kc % 16 == 0 &&
             round16(ci) % kc == 0 &&
             fwd_smem(round16(ci), strip / 8, kc) <= kMaxSmem) {
    const int vec = ci % 8 == 0 && co % 8 == 0 && aligned16(x) && aligned16(w);
    const cudaError_t err = launch_smem(
        fused_ir_fwd_mma, dim3((co + strip - 1) / strip, p),
        fwd_smem(round16(ci), strip / 8, kc), s, static_cast<const bf16*>(x),
        static_cast<const bf16*>(w), static_cast<bf16*>(y),
        static_cast<float*>(part), m, ci, co, strip / 8, kc, vec);
    if (err != cudaSuccess) return int(err);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// x [m,ci], g and y [m,co], w [ci,co], chan [6,co] float32 -> dx [m,ci]
// and dwp [p,ci,co] float32. act: 1 when the epilogue had the ReLU6.
// design 0 (float32, dtype 0): the SIMT kernels, span z covering rows
//   [z*span, (z+1)*span), p = ceil(m/span);
// design 1 (bfloat16): the one-pass tensor-core kernel, p blocks walking
//   64-row tiles p apart (span 64), p <= ceil(m/64), for
//   ceil16(ci)/16 * ceil16(co)/8 <= 48;
// design 2 (bfloat16): the tensor-core dx and dw kernels, each rebuilding
//   t; span a multiple of 32, p = ceil(m/span) <= 65535;
// design 3 (bfloat16): t_hi and t_lo first into tbuf [2,m,co] bf16, by a
//   grid that takes rows_t rows at a time, then the dx and dw kernels on
//   them; p and span as design 2.
// Returns cudaGetLastError() after the launches, cudaErrorInvalidValue on
// a plan it cannot run.
extern "C" int tpunet_fused_ir_bwd(const void* x, const void* g,
                                   const void* y, const void* w,
                                   const void* chan, void* dx, void* dwp,
                                   void* tbuf, int64_t m, int ci, int co,
                                   int act, int design, int p, int64_t span,
                                   int rows_t, int64_t dx_rows, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (m + kRows - 1) / kRows;
  if (m < 1 || ci < 1 || co < 1 || p < 1 || span < 1)
    return int(cudaErrorInvalidValue);
  // The tile-indexed dx kernels take row tiles on grid y (at most 65535
  // a launch): they run over row ranges of dx_rows rows, a whole number
  // of tiles, each launch on pointers offset to its range. The one-pass
  // kernel's persistent blocks walk any number of tiles.
  const bool dx_ok = design == 1 || (dx_rows >= kRows &&
                                     dx_rows % kRows == 0 &&
                                     dx_rows / kRows <= 65535);
  if (!dx_ok) return int(cudaErrorInvalidValue);
  const int cip = round16(ci), cop = round16(co);
  const int vec = ci % 8 == 0 && co % 8 == 0 && aligned16(x) &&
                  aligned16(g) && aligned16(y) && aligned16(w);
  const float* ct = static_cast<const float*>(chan);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* yb = static_cast<const bf16*>(y);
  const bf16* wb = static_cast<const bf16*>(w);
  cudaError_t err = cudaSuccess;
  if (design == 0 && dtype == 0 && (m + span - 1) / span == p && p <= 65535) {
    const float* gt = static_cast<const float*>(g);
    const float* yt = static_cast<const float*>(y);
    for (int64_t r0 = 0; r0 < m; r0 += dx_rows) {
      const int64_t rows = m - r0 < dx_rows ? m - r0 : dx_rows;
      const dim3 grid_dx((ci + BN - 1) / BN, unsigned((rows + BM - 1) / BM));
      fused_ir_bwd_dx<<<grid_dx, kThreads, 0, s>>>(
          gt + r0 * co, yt + r0 * co, static_cast<const float*>(w), ct,
          static_cast<float*>(dx) + r0 * ci, rows, ci, co, act);
    }
    const dim3 grid_dw((co + BN - 1) / BN, (ci + BM - 1) / BM, p);
    fused_ir_bwd_dw<<<grid_dw, kThreads, 0, s>>>(
        static_cast<const float*>(x), gt, yt, ct, static_cast<float*>(dwp), m,
        ci, co, act, span);
  } else if (design == 1 && dtype == 1 && span == kRows && p <= tiles &&
             (cip / 16) * (cop / 8) <= 4 * kOnePassTiles && cop <= 256 &&
             one_pass_smem(cip, cop) <= kMaxSmem) {
    err = launch_smem(fused_ir_bwd_one_pass, dim3(p), one_pass_smem(cip, cop),
                      s, xb, gb, yb, wb, ct, static_cast<bf16*>(dx),
                      static_cast<float*>(dwp), m, ci, co, act, vec);
  } else if ((design == 2 || design == 3) && dtype == 1 &&
             span % kDwRows == 0 && (m + span - 1) / span == p &&
             p <= 65535 &&
             (design == 2 || (tbuf && rows_t >= 1 && rows_t <= m &&
                              int64_t(rows_t) * co < (int64_t(1) << 31)))) {
    const bool build = design == 2;
    const bf16* ta = gb;
    const bf16* tb = yb;
    int tvec = vec;
    if (!build) {
      bf16* th = static_cast<bf16*>(tbuf);
      bf16* tl = th + m * co;
      // rows_t rows at a time, each co / 8 (or co) threads wide.
      if (co % 8 == 0 && aligned16(g) && aligned16(y) && aligned16(tbuf))
        fused_ir_bwd_t<true><<<(rows_t * (co / 8) + 255) / 256, 256, 0, s>>>(
            gb, yb, ct, th, tl, m, co, rows_t, act);
      else
        fused_ir_bwd_t<false><<<(rows_t * co + 255) / 256, 256, 0, s>>>(
            gb, yb, ct, th, tl, m, co, rows_t, act);
      ta = th;
      tb = tl;
      tvec = ci % 8 == 0 && co % 8 == 0 && aligned16(x) && aligned16(w) &&
             aligned16(th) && aligned16(tl);
    }
    const dim3 grid_dw((co + kTile - 1) / kTile, (ci + kTile - 1) / kTile, p);
    // Offsets of whole tiles keep the 16-byte alignment tvec checked.
    for (int64_t r0 = 0; r0 < m && err == cudaSuccess; r0 += dx_rows) {
      const int64_t rows = m - r0 < dx_rows ? m - r0 : dx_rows;
      const dim3 grid_dx((cip + kTile - 1) / kTile,
                         unsigned((rows + kRows - 1) / kRows));
      err = build ? launch_smem(fused_ir_bwd_dx_mma<true>, grid_dx,
                                dx_smem(true), s, ta + r0 * co, tb + r0 * co,
                                wb, ct, static_cast<bf16*>(dx) + r0 * ci,
                                rows, ci, co, act, tvec)
                  : launch_smem(fused_ir_bwd_dx_mma<false>, grid_dx,
                                dx_smem(false), s, ta + r0 * co, tb + r0 * co,
                                wb, ct, static_cast<bf16*>(dx) + r0 * ci,
                                rows, ci, co, act, tvec);
    }
    if (err == cudaSuccess)
      err = build ? launch_smem(fused_ir_bwd_dw_mma<true>, grid_dw,
                                dw_smem(true), s, xb, ta, tb, ct,
                                static_cast<float*>(dwp), m, ci, co, act, span,
                                tvec)
                  : launch_smem(fused_ir_bwd_dw_mma<false>, grid_dw,
                                dw_smem(false), s, xb, ta, tb, ct,
                                static_cast<float*>(dwp), m, ci, co, act, span,
                                tvec);
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
