// Flash attention, BTHD layout: the forward with an optional lse
// (flash_fwd), dQ (flash_bwd_dq) and dK/dV (flash_bwd_dkv).
//
// They replace the Pallas TPU kernels of tpunet/ops/flash.py:
// - flash_fwd: _kernel (launched by _forward_impl through
//   _pallas_forward, _pallas_forward_res and their segment variants);
// - flash_bwd_dq: _dq_kernel (launched by _pallas_backward);
// - flash_bwd_dkv: _dkv_kernel (launched by _pallas_backward).
// Same functions: q [B,Tq,H,D] against k, v [B,Tk,H,D]; scores
// s = (q . k) * scale formed in float32 from the input-type operands;
// optional causal mask qpos + (tk - tq) >= kpos and optional segment
// mask qseg[b,qpos] == kseg[b,kpos]; masked scores are -1e30 and their
// probabilities are set to 0, so a query with no key gives 0 and
// lse = -1e30. The backward recomputes p = exp(s - lse) per tile and
// forms ds = p * (dO.v - delta + glse) * scale with delta = rowsum(dO*O)
// computed outside (in torch) and glse the optional cotangent of lse.
// p is rounded to v's type before p.V, and p and ds to the operand type
// before dV = p^T.dO, dK = ds^T.Q and dQ = ds.K, as the TPU kernels do;
// every accumulator is float32.
//
// Which kernel serves which type:
// - bfloat16: flash_fwd_mma, flash_bwd_dq_mma and flash_bwd_dkv_mma,
//   tensor-core kernels (mma.sync m16n8k16, ldmatrix, cp.async), below;
// - float32: the SIMT kernels flash_fwd, flash_bwd_dq and flash_bwd_dkv.
//   They sum in the plain versions' order, so dQ and dK/dV equal them bit
//   for bit wherever cuBLAS sums those products in order too (every shape
//   checked on the card but T = 1).
// The choice is by type alone, inside launch(): two hand-written kernels,
// not a fallback.
//
// Bound: at ViT-B/16's shapes (T = 196, D = 64) each kernel must at
// least read its inputs and write its outputs once: in bf16 at batch
// 128 about 154 MB (forward), 195 MB (dQ) and 233 MB (dK/dV), so bytes
// bound them at 3.35 TB/s (0.046, 0.058, 0.070 ms) ahead of the tensor
// cores (15 GFLOP in the forward take 0.015 ms at 989 TFLOP/s).
//
// Design of the tensor-core kernels, against that byte bound: read each
// operand once, keep p and ds in registers, keep the next tile's loads in
// flight, and compute no more of the ragged last tile than it holds.
// - 4 warps a block, each owning 16 rows (queries in the forward and dQ,
//   keys in dK/dV) of a 64-row tile; the forward holds its Q tile in
//   registers as mma A fragments for the whole loop; dQ and dK/dV read
//   theirs (Q and dO; K and V) from shared memory for each product, which
//   leaves room for four (dQ) and three (dK/dV) blocks an SM at D = 64;
// - the tiles it loops over (K, V of 64 keys; Q, dO of 32 queries at
//   D >= 64, 64 below) arrive by 16-byte cp.async in two stages, rows
//   padded by 16 bytes so that ldmatrix is free of bank conflicts; rows
//   past T are zero-filled by the copy;
// - the probabilities (and ds) are formed on the float32 accumulators of
//   the first product and rounded to bf16 straight into the A fragments
//   of the next (FlashAttention-2's register reuse); dQ is not summed into
//   by the dK/dV blocks with float atomics, as FlashAttention-2 does, but
//   by its own kernel in a fixed order, so that two runs give the same
//   bits;
// - at T = 196 the last tile holds 4 rows: warps whose rows lie wholly
//   past T skip the products, and n8 blocks and k16 steps of keys (or
//   queries) wholly past T, or wholly hidden by the causal mask, are not
//   computed; the last tile then costs 16 x 8-16 instead of 64 x 64;
// - the card measured them issue-bound (instructions, not bytes or tensor
//   cores), so the elementwise work is kept lean: masks are evaluated only
//   on tiles that a mask touches, exp is 2^(x log2 e) on the special
//   function unit, O is scaled by 1/l, the branches around mma.sync are
//   on bounds the whole block shares (a branch the compiler cannot prove
//   uniform puts a warp barrier before every mma.sync and ldmatrix), and
//   the copies advance 64-bit pointers.
// mma.sync runs at about 2/3 of wgmma's rate, still far under the byte
// bound at D = 64.
//
// Design of the SIMT kernels, right and simple first:
// - one block of 256 threads per (query tile of 64 rows, head, batch)
//   for the forward and dQ, looping over key tiles of 64; one block per
//   (key tile, head, batch) for dK/dV, looping over query tiles. A loop
//   inside the block takes the place of the TPU's sequential grid axis,
//   so nothing is summed across blocks: no atomics, no partials (the
//   tensor-core kernels keep this grid);
// - tiles are staged in shared memory as float32, transposed with a row
//   stride of 65 floats so that every access below is free of bank
//   conflicts; each thread owns a 4 x 4 micro tile of the 64 x 64 score
//   tile (rows ty + 16i, columns tx + 16j) and 4 rows x D/16 columns of
//   the output tile. The products run on the float32 CUDA cores (about
//   one shared-memory load per two fused multiply-adds), far above the
//   byte bound;
// - the row max and row sum of the online softmax are butterfly
//   reductions over the 16 lanes that share a row, so every lane holds
//   the same bits;
// - any T: rows and keys past the end are masked by bounds (T = 196 is
//   three full tiles and one of 4 rows); a causal block stops at the
//   last key tile its queries can see (dK/dV starts at the first query
//   tile that can see its keys), so tiles wholly in the future are
//   never visited.
// Both: q, k, v and dO are read through explicit batch/token/head strides
// (the head dim is contiguous; in bf16 every stride and base is a
// multiple of 16 bytes, for cp.async), so they may be the views
// qkv[:, :, 0..2] of a fused projection without copies; o, dq, dk, dv
// are written contiguous [B,T,H,D]; lse, delta and glse are [B,H,Tq]
// float32.
// The plain PyTorch versions (tpunet_torch/ops/flash.py) step through
// the same 64-key tiles and round at the same places; the scale product
// and the running-sum update are written as separate rounded operations
// (__fmul_rn, __fadd_rn) so that the compiler does not fuse them into
// a multiply-add that the plain versions do not make. The tensor cores
// sum the products in their own order and the bf16 kernels take exp and
// 1/l to within 2 ulp, so the bf16 kernels differ from the plain versions
// by float32 rounding before p, ds and the outputs are rounded to bf16 at
// the same places.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kBlock = 64;        // rows of a query tile and of a key tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kPad = kBlock + 1;  // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;

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

// v rounded to T and back: what .astype(T) does to a float32 value.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

struct Strides {
  long long b, t, h;  // element strides of a BTHD tensor; d is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B,H,Tq], backward input
  const float* delta;  // [B,H,Tq]
  const float* glse;   // [B,H,Tq] or null
  const int* qseg;     // [B,Tq] or null
  const int* kseg;     // [B,Tk] or null (set with qseg)
  void* o;             // [B,Tq,H,D]
  float* lse_out;      // [B,H,Tq] or null
  void* dq;            // [B,Tq,H,D]
  void* dk;            // [B,Tk,H,D]
  void* dv;            // [B,Tk,H,D]
  Strides sq, sk, sv, sdo;
  int b, h, tq, tk;
  float scale;
  int causal;
};

// Rows [r0, r0 + 64) of head hi, batch bi of a BTHD tensor into dst as
// float32, transposed: dst[d * kPad + r]; rows past n are 0. Threads
// walk d fastest, so the global reads of a row are coalesced and the
// shared-memory writes fall in distinct banks.
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src,
                                            Strides s, int bi, int hi,
                                            int r0, int n) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    float x = 0.f;
    if (row < n)
      x = to_f32(src[bi * s.b + row * s.t + hi * s.h + d]);
    dst[d * kPad + r] = x;
  }
}

// The same rows untransposed: dst[r * D + d].
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          Strides s, int bi, int hi, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    float x = 0.f;
    if (row < n)
      x = to_f32(src[bi * s.b + row * s.t + hi * s.h + d]);
    dst[r * D + d] = x;
  }
}

// 64 entries of a per-row vector (lse, delta, glse: [B,H,T] rows of
// (bi, hi); segment ids: [B,T] rows of bi) starting at r0; 0 past n.
template <typename V>
__device__ __forceinline__ void load_vec(V* dst, const V* src, int r0,
                                         int n) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads)
    dst[r] = (src != nullptr && r0 + r < n) ? src[r0 + r] : V(0);
}

// Whether query qpos may attend to key kpos; qi, kj index the tiles'
// segment ids.
__device__ __forceinline__ bool keep(const Params& p, int qpos, int kpos,
                                     const int* qs, const int* ks, int qi,
                                     int kj) {
  if (qpos >= p.tq || kpos >= p.tk) return false;
  if (p.causal && qpos + (p.tk - p.tq) < kpos) return false;
  if (p.qseg != nullptr && qs[qi] != ks[kj]) return false;
  return true;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Exclusive end of the keys that a causal query tile [q0, q0 + 64) can
// see: the last query's position plus the tk - tq offset.
__device__ __forceinline__ int key_end(const Params& p, int q0) {
  if (!p.causal) return p.tk;
  return min(p.tk, max(0, q0 + kBlock + (p.tk - p.tq)));
}

template <int D>
__host__ __device__ constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * kPad + kBlock * D + kBlock * kPad) +
         sizeof(int) * 2 * kBlock;
}

template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * kPad + kBlock * kPad + 3 * kBlock) +
         sizeof(int) * 2 * kBlock;
}

template <int D>
__host__ __device__ constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * D * kPad + 2 * kBlock * kPad + 3 * kBlock) +
         sizeof(int) * 2 * kBlock;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;                 // [D][kPad] queries, transposed
  float* kt = qt + D * kPad;        // [D][kPad] keys, transposed
  float* vs = kt + D * kPad;        // [kBlock][D] values
  float* ps = vs + kBlock * D;      // [kBlock][kPad] p of (row r, key j) at j * kPad + r
  int* qs = reinterpret_cast<int*>(ps + kBlock * kPad);  // [kBlock]
  int* ks = qs + kBlock;                                  // [kBlock]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBlock, hi = blockIdx.y, bi = blockIdx.z;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  load_tile_t<T, D>(qt, q, p.sq, bi, hi, q0, p.tq);
  if (p.qseg != nullptr) load_vec(qs, p.qseg + int64_t(bi) * p.tq, q0, p.tq);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int k_end = key_end(p, q0);
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // the previous tile's reads are done
    load_tile_t<T, D>(kt, k, p.sk, bi, hi, k0, p.tk);
    load_tile<T, D>(vs, v, p.sv, bi, hi, k0, p.tk);
    if (p.qseg != nullptr)
      load_vec(ks, p.kseg + int64_t(bi) * p.tk, k0, p.tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[d * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kt[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = keep(p, q0 + r, k0 + c, qs, ks, r, c);
        s[i][j] = ok[j] ? __fmul_rn(s[i][j], p.scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += e;
        ps[(tx + 16 * j) * kPad + r] = round_to<T>(e);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), row_sum(sum));
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    const int kn = min(kBlock, p.tk - k0);
    for (int j = 0; j < kn; ++j) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[j * kPad + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.tq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((int64_t(bi) * p.tq + row) * p.h + hi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
    if (p.lse_out != nullptr && tx == 0)
      p.lse_out[(int64_t(bi) * p.h + hi) * p.tq + row] =
          l[i] == 0.f ? kNegInf : m[i] + logf(l_safe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Params p) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;                 // [D][kPad] queries
  float* dot = qt + D * kPad;       // [D][kPad] output gradients
  float* kt = dot + D * kPad;       // [D][kPad] keys
  float* vt = kt + D * kPad;        // [D][kPad] values
  float* dss = vt + D * kPad;       // [kBlock][kPad] ds of (row r, key j) at j * kPad + r
  float* lse = dss + kBlock * kPad; // [kBlock] each
  float* delta = lse + kBlock;
  float* glse = delta + kBlock;
  int* qs = reinterpret_cast<int*>(glse + kBlock);
  int* ks = qs + kBlock;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBlock, hi = blockIdx.y, bi = blockIdx.z;
  const int64_t rows = (int64_t(bi) * p.h + hi) * p.tq;

  load_tile_t<T, D>(qt, static_cast<const T*>(p.q), p.sq, bi, hi, q0, p.tq);
  load_tile_t<T, D>(dot, static_cast<const T*>(p.dout), p.sdo, bi, hi, q0,
                    p.tq);
  load_vec(lse, p.lse + rows, q0, p.tq);
  load_vec(delta, p.delta + rows, q0, p.tq);
  load_vec(glse, p.glse == nullptr ? nullptr : p.glse + rows, q0, p.tq);
  if (p.qseg != nullptr) load_vec(qs, p.qseg + int64_t(bi) * p.tq, q0, p.tq);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int k_end = key_end(p, q0);
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();
    load_tile_t<T, D>(kt, static_cast<const T*>(p.k), p.sk, bi, hi, k0, p.tk);
    load_tile_t<T, D>(vt, static_cast<const T*>(p.v), p.sv, bi, hi, k0, p.tk);
    if (p.qseg != nullptr)
      load_vec(ks, p.kseg + int64_t(bi) * p.tk, k0, p.tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], g[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qt[d * kPad + ty + 16 * i];
        g[i] = dot[d * kPad + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = kt[d * kPad + tx + 16 * j];
        w[j] = vt[d * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (keep(p, q0 + r, k0 + c, qs, ks, r, c)) {
          const float pr = expf(__fmul_rn(s[i][j], p.scale) - lse[r]);
          ds = pr * (dp[i][j] - delta[r] + glse[r]) * p.scale;
        }
        dss[c * kPad + r] = round_to<T>(ds);
      }
    }
    __syncthreads();

    const int kn = min(kBlock, p.tk - k0);
    for (int j = 0; j < kn; ++j) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[j * kPad + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = kt[(tx + 16 * c) * kPad + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.tq) continue;
    T* out = dq + ((int64_t(bi) * p.tq + row) * p.h + hi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(Params p) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* kt = smem;                 // [D][kPad] keys of this block
  float* vt = kt + D * kPad;        // [D][kPad] values of this block
  float* qt = vt + D * kPad;        // [D][kPad] queries of the current tile
  float* dot = qt + D * kPad;       // [D][kPad] their output gradients
  float* pss = dot + D * kPad;      // [kBlock][kPad] p of (key r, query c) at c * kPad + r
  float* dss = pss + kBlock * kPad; // [kBlock][kPad] ds, same layout
  float* lse = dss + kBlock * kPad; // [kBlock] of the query tile, each
  float* delta = lse + kBlock;
  float* glse = delta + kBlock;
  int* qs = reinterpret_cast<int*>(glse + kBlock);
  int* ks = qs + kBlock;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBlock, hi = blockIdx.y, bi = blockIdx.z;
  const int64_t rows = (int64_t(bi) * p.h + hi) * p.tq;

  load_tile_t<T, D>(kt, static_cast<const T*>(p.k), p.sk, bi, hi, k0, p.tk);
  load_tile_t<T, D>(vt, static_cast<const T*>(p.v), p.sv, bi, hi, k0, p.tk);
  if (p.qseg != nullptr) load_vec(ks, p.kseg + int64_t(bi) * p.tk, k0, p.tk);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  // A causal key tile is first seen by the queries at k0 - (tk - tq).
  int q_begin = 0;
  if (p.causal) q_begin = max(0, k0 - (p.tk - p.tq)) / kBlock * kBlock;
  for (int q0 = q_begin; q0 < p.tq; q0 += kBlock) {
    __syncthreads();
    load_tile_t<T, D>(qt, static_cast<const T*>(p.q), p.sq, bi, hi, q0, p.tq);
    load_tile_t<T, D>(dot, static_cast<const T*>(p.dout), p.sdo, bi, hi, q0,
                      p.tq);
    load_vec(lse, p.lse + rows, q0, p.tq);
    load_vec(delta, p.delta + rows, q0, p.tq);
    load_vec(glse, p.glse == nullptr ? nullptr : p.glse + rows, q0, p.tq);
    if (p.qseg != nullptr)
      load_vec(qs, p.qseg + int64_t(bi) * p.tq, q0, p.tq);
    __syncthreads();

    // s and dp of (key ty + 16i, query tx + 16j), summed over d in the
    // order of the forward and dQ, so s has the same bits there.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], g[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[i] = kt[d * kPad + ty + 16 * i];
        w[i] = vt[d * kPad + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = qt[d * kPad + tx + 16 * j];
        g[j] = dot[d * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[j], b[i], s[i][j]);
          dp[i][j] = fmaf(g[j], w[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float pr = 0.f, ds = 0.f;
        if (keep(p, q0 + c, k0 + r, qs, ks, c, r)) {
          pr = expf(__fmul_rn(s[i][j], p.scale) - lse[c]);
          ds = pr * (dp[i][j] - delta[c] + glse[c]) * p.scale;
        }
        pss[c * kPad + r] = round_to<T>(pr);
        dss[c * kPad + r] = round_to<T>(ds);
      }
    }
    __syncthreads();

    const int qn = min(kBlock, p.tq - q0);
    for (int c = 0; c < qn; ++c) {
      float pv[4], dsv[4], gv[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pss[c * kPad + ty + 16 * i];
        dsv[i] = dss[c * kPad + ty + 16 * i];
      }
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        gv[m] = dot[(tx + 16 * m) * kPad + c];
        qv[m] = qt[(tx + 16 * m) * kPad + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
          dv[i][m] = fmaf(pv[i], gv[m], dv[i][m]);
          dk[i][m] = fmaf(dsv[i], qv[m], dk[i][m]);
        }
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.tk) continue;
    const int64_t off = ((int64_t(bi) * p.tk + row) * p.h + hi) * D;
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      dkp[off + tx + 16 * m] = from_f32<T>(dk[i][m]);
      dvp[off + tx + 16 * m] = from_f32<T>(dv[i][m]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: the bf16 forward, dQ and dK/dV
// ---------------------------------------------------------------------------
//
// Four warps a block, each owning 16 rows of the block's 64-row tile:
// query rows in the forward and dQ, key rows in dK/dV. Every product is an
// mma.sync m16n8k16 (bf16 operands, float32 accumulators). The tiles the
// block loops over (K, V; Q, dO) come in by 16-byte cp.async into two
// stages of shared memory, so that the next tile is in flight while this
// one is used. Shared-memory rows are
// padded by 8 elements (16 bytes), so the 8 row addresses of one
// ldmatrix fall in 8 distinct groups of 4 banks. The probabilities (and
// ds) are formed on the accumulators of the first product and repacked
// in registers into the A fragments of the second: they never touch
// shared memory.

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows each

// A fragments (16 rows x 16 columns from column 16kk) of the 16 rows
// starting at rows of a [.][D + 8] shared-memory tile.
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* rows,
                                       int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, rows + (lane % 16) * (D + 8) + kk * 16 + (lane / 16) * 8);
}

// B fragments of two n8 blocks (rows n0.. and n0 + 8.. of the tile, each
// a column of B) over the k16 step kk: {b0, b1} of block n0 in r[0..1],
// of block n0 + 8 in r[2..3]. For S = Q.K^T with K [key][d] in shared
// memory.
template <int D>
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], const bf16* tile,
                                       int n0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, tile + (n0 + (lane / 16) * 8 + lane % 8) * (D + 8) + kk * 16 +
                 ((lane / 8) % 2) * 8);
}

// B fragments over the k16 step of tile rows k0.. (the k index) for the
// two n8 blocks of columns 16nn.. (the n index): for P.V with V [key][d]
// in shared memory.
template <int D>
__device__ __forceinline__ void ldsm_bt(uint32_t (&r)[4], const bf16* tile,
                                        int k0, int nn) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(r, tile + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * (D + 8) +
                   nn * 16 + (lane / 16) * 8);
}

// Rows [r0, r0 + ROWS) of one head of a bf16 BTHD tensor (src at its
// row 0, rows tstride elements apart) into dst [ROWS][D + 8] by 16-byte
// cp.async; rows at or past n are zero. Thread i copies chunk i % (D/8)
// of rows i / (D/8) + k kMmaThreads / (D/8): a fixed count, unrolled,
// one 64-bit add apart.
template <int D, int ROWS>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src,
                                           long long tstride, int r0, int n) {
  constexpr int kChunks = D / 8, kStep = kMmaThreads / kChunks;
  static_assert(ROWS % kStep == 0, "rows must fill whole passes");
  const int c = threadIdx.x % kChunks, r = threadIdx.x / kChunks;
  const long long step = kStep * tstride;
  const bf16* g = src + (r0 + r) * tstride + c * 8;
  bf16* d = dst + r * (D + 8) + c * 8;
#pragma unroll
  for (int i = 0; i < ROWS / kStep; ++i, g += step) {
    const bool ok = r0 + r + i * kStep < n;
    cp_async16(d + i * kStep * (D + 8), ok ? g : src, ok);
  }
}

// ROWS (<= kMmaThreads) 4-byte entries src[r0..] of a per-row vector; 0
// at or past n, and everywhere when !live (src must still be a global
// address).
template <int ROWS, typename V>
__device__ __forceinline__ void vec_async(V* dst, const V* src, int r0,
                                          int n, bool live) {
  const int r = threadIdx.x;
  if (r < ROWS) {
    const bool ok = live && r0 + r < n;
    cp_async4(dst + r, ok ? src + r0 + r : src, ok);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special function unit: within 2 ulp, 0 at -inf. exp(x) is
// taken as exp2_approx(x log2 e), the product fused into the argument's
// last operation.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum of row r (0: lane / 4, 1: lane / 4 + 8) over a thread's J
// n8 blocks of accumulators, as trees.
template <int J>
__device__ __forceinline__ float tile_max(const float (&s)[J][4], int r) {
  float v[J];
#pragma unroll
  for (int j = 0; j < J; ++j) v[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
  for (int w = J / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] = fmaxf(v[i], v[i + w]);
  return v[0];
}

template <int J>
__device__ __forceinline__ float tile_sum(const float (&s)[J][4], int r) {
  float v[J];
#pragma unroll
  for (int j = 0; j < J; ++j) v[j] = s[j][2 * r] + s[j][2 * r + 1];
#pragma unroll
  for (int w = J / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] += v[i + w];
  return v[0];
}

// Sum or max over the 4 lanes that share a row of an accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A warp's 16 rows x D of float32 accumulators (n8 block n at acc[n]),
// rounded to bf16 into its rows of a [.][D + 8] shared tile, then copied
// by 16-byte stores to rows row0.. of a contiguous [B,T,H,D] tensor (rows
// at or past n are not written).
template <int D>
__device__ __forceinline__ void store_rows(bf16* stage,
                                           const float (&acc)[D / 8][4],
                                           bf16* dst,
                                           int bi, int hi, int h, int t,
                                           int row0, int n) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * (D + 8) + 8 * c +
                                   2 * t4) =
          pack_bf16(acc[c][2 * r], acc[c][2 * r + 1]);
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks, row = row0 + r;
    if (row < n)
      *reinterpret_cast<uint4*>(dst + ((int64_t(bi) * t + row) * h + hi) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * (D + 8) + c * 8);
  }
}

template <int D>
__host__ __device__ constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * 5 * kBlock * (D + 8) + sizeof(int) * 2 * kBlock;
}

// The bf16 forward. Grid (query tiles of 64, heads, batch). Per key tile
// of 64: S = Q.K^T (16 x 64 a warp), the scale product, masks, the
// online-softmax update on the accumulators, p rounded to bf16 straight
// into the A fragments of O += P.V. A warp whose rows all lie past Tq,
// or whose causal rows see no key of the tile, skips the products; the
// n8 blocks of S and the k16 steps of P.V that lie wholly past the keys
// the block can see are not computed (they would be masked to p = 0).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 4 : 1)
    flash_fwd_mma(Params p) {
  constexpr int kS = D + 8, kK = D / 16, kN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);  // [64][kS] queries
  bf16* ksm = qsm + kBlock * kS;                  // [2][64][kS] keys
  bf16* vsm = ksm + 2 * kBlock * kS;              // [2][64][kS] values
  int* kseg = reinterpret_cast<int*>(vsm + 2 * kBlock * kS);  // [2][64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * kBlock, hi = blockIdx.y, bi = blockIdx.z;
  const int w0 = q0 + 16 * warp;  // the warp's first query row
  // Row 0 of head hi, batch bi of q, k and v.
  const bf16* q = static_cast<const bf16*>(p.q) + bi * p.sq.b + hi * p.sq.h;
  const bf16* k = static_cast<const bf16*>(p.k) + bi * p.sk.b + hi * p.sk.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bi * p.sv.b + hi * p.sv.h;
  const int* kseg_g =
      p.kseg == nullptr ? nullptr : p.kseg + int64_t(bi) * p.tk;

  const int k_end = key_end(p, q0);
  const int n_tiles = (k_end + kBlock - 1) / kBlock;
  // Exclusive end of the keys this warp's rows can see.
  const int wk_end =
      p.causal ? min(p.tk, max(0, w0 + 16 + (p.tk - p.tq))) : p.tk;
  const bool active = w0 < p.tq;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * kBlock;
    tile_async<D, kBlock>(ksm + st * kBlock * kS, k, p.sk.t, k0, p.tk);
    tile_async<D, kBlock>(vsm + st * kBlock * kS, v, p.sv.t, k0, p.tk);
    if (kseg_g != nullptr)
      vec_async<kBlock>(kseg + st * kBlock, kseg_g, k0, p.tk, true);
  };
  tile_async<D, kBlock>(qsm, q, p.sq.t, q0, p.tq);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  int qs[2] = {0, 0};  // segment ids of rows g and g + 8
  if (p.qseg != nullptr)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      if (row < p.tq) qs[r] = p.qseg[int64_t(bi) * p.tq + row];
    }

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) ldsm_a<D>(qf[kk], qsm + 16 * warp * kS, kk);

  float o[kN][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlock, st = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();

    // Keys of this tile before the block's end (a bound the whole block
    // shares, so that the branches on it stay uniform around mma.sync).
    const int kn = min(kBlock, k_end - k0);
    if (active && wk_end > k0) {
      const bf16* kt = ksm + st * kBlock * kS;
      const bf16* vt = vsm + st * kBlock * kS;
      const int* ks = kseg + st * kBlock;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (16 * jj >= kn) continue;
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
          uint32_t b[4];
          ldsm_b<D>(b, kt, 16 * jj, kk);
          mma_bf16(s[2 * jj], qf[kk], b[0], b[1]);
          if (16 * jj + 8 < kn) mma_bf16(s[2 * jj + 1], qf[kk], b[2], b[3]);
        }
      }

      // Scale, mask, max and p = exp(s - m_new), on a tile that a mask
      // touches (kMasked: key c of row r is kept where c < cend[r], for
      // bounds and causality, and the segment ids agree; n8 blocks past
      // the block's keys are skipped) or on one of 64 keys that none
      // does. Masked scores are -1e30, so p is 0 against a finite max; a
      // row that has seen no key keeps m = -1e30 and subtracts +inf.
      float m_new[2], sum[2];
      auto softmax = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
        int cend[2] = {kBlock, kBlock};
        if constexpr (kMasked) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int lim =
                p.causal ? w0 + g + 8 * r + (p.tk - p.tq) - k0 + 1 : kBlock;
            cend[r] = min(kn, lim) - 2 * t4;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          int2 kseg2 = make_int2(0, 0);
          if (kMasked && p.qseg != nullptr)
            kseg2 = *reinterpret_cast<const int2*>(ks + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = __fmul_rn(s[j][e], p.scale);
            if constexpr (kMasked) {
              const int r = e / 2, c = 8 * j + (e & 1);
              const bool keep =
                  c < cend[r] && (p.qseg == nullptr ||
                                  qs[r] == (e & 1 ? kseg2.y : kseg2.x));
              s[j][e] = keep ? x : kNegInf;
            } else {
              s[j][e] = x;
            }
          }
        }
        float ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_new[r] = fmaxf(m[r], quad_max(tile_max(s, r)));
          ms[r] = (m_new[r] == kNegInf ? INFINITY : m_new[r]) * kLog2e;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = kMasked && 8 * j >= kn
                          ? 0.f
                          : exp2_approx(fmaf(s[j][e], kLog2e, -ms[e / 2]));
#pragma unroll
        for (int r = 0; r < 2; ++r) sum[r] = tile_sum(s, r);
      };
      if (p.causal || p.qseg != nullptr || kn < kBlock)
        softmax(std::true_type{});
      else
        softmax(std::false_type{});
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = expf(m[r] - m_new[r]);
        l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), quad_sum(sum[r]));
        m[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e / 2];

      // O += P.V, P rounded to bf16 in the A fragments.
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (16 * jj >= kn) continue;
        uint32_t pa[4];
        repack(pa, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
        for (int nn = 0; nn < kN / 2; ++nn) {
          uint32_t b[4];
          ldsm_bt<D>(b, vt, 16 * jj, nn);
          mma_bf16(o[2 * nn], pa, b[0], b[1]);
          mma_bf16(o[2 * nn + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for tile it + 2
  }
  cp_async_wait<0>();

  // O times 1/l in bf16 through this warp's rows of the query tile (read
  // only into qf above); lse = m + log l, or -1e30 on a row with no key.
  float inv[2], ol[kN][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = __frcp_rn(l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ol[n][e] = o[n][e] * inv[e / 2];
  store_rows<D>(qsm + 16 * warp * kS, ol, static_cast<bf16*>(p.o), bi,
                hi, p.h, p.tq, w0, p.tq);
  if (p.lse_out != nullptr && t4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      if (row < p.tq)
        p.lse_out[(int64_t(bi) * p.h + hi) * p.tq + row] =
            l[r] == 0.f ? kNegInf : m[r] + logf(l[r]);
    }
}

// The query tile of the tensor-core dK/dV: 32 at D >= 64, where dK and dV
// take D registers a thread, so that S^T and dP^T take 32 more and three
// blocks fit an SM at D = 64 without spills; 64 below.
template <int D>
__host__ __device__ constexpr int dkv_qtile() {
  return D >= 64 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr size_t dkv_mma_smem() {
  constexpr int qt = dkv_qtile<D>();
  return sizeof(bf16) * (2 * kBlock + 4 * qt) * (D + 8) +
         sizeof(float) * 2 * 4 * qt;
}

// The bf16 dK/dV. Grid (key tiles of 64, heads, batch); each warp owns 16
// keys, whose K and V A fragments it reads from shared memory for each
// product (held in registers they would leave room for two blocks an SM
// instead of three at D = 64). Per query tile (from the first that
// can see the block's keys): S^T = K.Q^T and dP^T = V.dO^T, then p^T =
// exp(s^T scale - lse) and ds^T = p^T (dp^T - delta + glse) scale on the
// accumulators, masked, rounded to bf16 into A fragments for dV += P^T.dO
// and dK += dS^T.Q. One block owns its dK/dV rows: no atomics. A warp
// whose keys all lie past Tk skips the products; the n8 blocks of the
// first products and the k16 steps of the second that lie wholly past Tq
// (or wholly before the first query that sees the block's keys) are not
// computed.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 3 : 1)
    flash_bwd_dkv_mma(Params p) {
  constexpr int kS = D + 8, kK = D / 16, kN = D / 8;
  constexpr int kQ = dkv_qtile<D>(), kJ = kQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ksm = reinterpret_cast<bf16*>(smem_raw);  // [64][kS] keys
  bf16* vsm = ksm + kBlock * kS;                  // [64][kS] values
  bf16* qsm = vsm + kBlock * kS;                  // [2][kQ][kS] queries
  bf16* dsm = qsm + 2 * kQ * kS;                  // [2][kQ][kS] dO
  float* rsm = reinterpret_cast<float*>(dsm + 2 * kQ * kS);
  // rsm: [2][4][kQ] lse, delta, glse and (as int) segment ids of a tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * kBlock, hi = blockIdx.y, bi = blockIdx.z;
  const int w0 = k0 + 16 * warp;  // the warp's first key
  const int64_t rows = (int64_t(bi) * p.h + hi) * p.tq;
  // Row 0 of head hi, batch bi of q and dO.
  const bf16* q = static_cast<const bf16*>(p.q) + bi * p.sq.b + hi * p.sq.h;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + bi * p.sdo.b + hi * p.sdo.h;
  const int off = p.tk - p.tq;
  const bool active = w0 < p.tk;
  // The first query that sees any of this warp's keys.
  const int qlo = p.causal ? w0 - off : 0;

  int q_begin = 0;
  if (p.causal) q_begin = max(0, k0 - off) / kQ * kQ;
  const int n_tiles = (p.tq - q_begin + kQ - 1) / kQ;

  auto load_q = [&](int tile, int st) {
    const int q0 = q_begin + tile * kQ;
    tile_async<D, kQ>(qsm + st * kQ * kS, q, p.sq.t, q0, p.tq);
    tile_async<D, kQ>(dsm + st * kQ * kS, dout, p.sdo.t, q0, p.tq);
    float* r = rsm + st * 4 * kQ;
    vec_async<kQ>(r, p.lse + rows, q0, p.tq, true);
    vec_async<kQ>(r + kQ, p.delta + rows, q0, p.tq, true);
    vec_async<kQ>(r + 2 * kQ, p.glse == nullptr ? p.lse + rows : p.glse + rows,
                  q0, p.tq, p.glse != nullptr);
    if (p.qseg != nullptr)
      vec_async<kQ>(reinterpret_cast<int*>(r + 3 * kQ),
                    p.qseg + int64_t(bi) * p.tq, q0, p.tq, true);
  };
  tile_async<D, kBlock>(
      ksm, static_cast<const bf16*>(p.k) + bi * p.sk.b + hi * p.sk.h, p.sk.t,
      k0, p.tk);
  tile_async<D, kBlock>(
      vsm, static_cast<const bf16*>(p.v) + bi * p.sv.b + hi * p.sv.h, p.sv.t,
      k0, p.tk);
  cp_async_commit();
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();

  int ks[2] = {0, 0};  // segment ids of keys g and g + 8
  if (p.kseg != nullptr)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = w0 + g + 8 * r;
      if (key < p.tk) ks[r] = p.kseg[int64_t(bi) * p.tk + key];
    }

  cp_async_wait<1>();
  __syncthreads();
  const bf16* kw = ksm + 16 * warp * kS;
  const bf16* vw = vsm + 16 * warp * kS;

  float dk[kN][4], dv[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kQ, st = it & 1;
    if (it + 1 < n_tiles) load_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int qn = min(kQ, p.tq - q0);  // queries in this tile
    if (active && qlo < q0 + qn) {
      const bf16* qt = qsm + st * kQ * kS;
      const bf16* dt = dsm + st * kQ * kS;
      const float* lse = rsm + st * 4 * kQ;
      const float* delta = lse + kQ;
      const float* glse = lse + 2 * kQ;
      const int* qs = reinterpret_cast<const int*>(lse + 3 * kQ);
      // n8 block j (queries q0 + 8j..) is computed when some of its
      // queries lie before Tq and, if causal, see the block's first key (a
      // bound the whole block shares, so that the branches on it stay
      // uniform around mma.sync).
      auto live = [&](int j) {
        return 8 * j < qn && (!p.causal || q0 + 8 * j + 8 > k0 - off);
      };

      float s[kJ][4], dp[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_a<D>(ka, kw, kk);
        ldsm_a<D>(va, vw, kk);
#pragma unroll
        for (int jj = 0; jj < kJ / 2; ++jj) {
          const bool l0 = live(2 * jj), l1 = live(2 * jj + 1);
          if (!l0 && !l1) continue;
          uint32_t bq[4], bd[4];
          ldsm_b<D>(bq, qt, 16 * jj, kk);
          ldsm_b<D>(bd, dt, 16 * jj, kk);
          if (l0) {
            mma_bf16(s[2 * jj], ka, bq[0], bq[1]);
            mma_bf16(dp[2 * jj], va, bd[0], bd[1]);
          }
          if (l1) {
            mma_bf16(s[2 * jj + 1], ka, bq[2], bq[3]);
            mma_bf16(dp[2 * jj + 1], va, bd[2], bd[3]);
          }
        }
      }

      // p^T = exp(s^T scale - lse) and ds^T = p^T (dp^T - delta + glse)
      // scale in place, on a tile that a mask touches (kMasked: query c of
      // key row r is kept where cbeg[r] <= c < cend[r], for causality and
      // bounds, and the segment ids agree; n8 blocks that were not computed
      // are skipped) or on a full tile that none does.
      auto grads = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
        int cbeg[2] = {0, 0}, cend[2] = {kQ, kQ};
        if constexpr (kMasked) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = w0 + g + 8 * r;
            cbeg[r] = (p.causal ? key - (p.tk - p.tq) - q0 : 0) - 2 * t4;
            cend[r] = (key < p.tk ? qn : 0) - 2 * t4;
          }
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (kMasked && !live(j)) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            continue;
          }
          const int c0 = 8 * j + 2 * t4;
          const float2 ls = *reinterpret_cast<const float2*>(lse + c0);
          const float2 de = *reinterpret_cast<const float2*>(delta + c0);
          const float2 gl = *reinterpret_cast<const float2*>(glse + c0);
          const float ll[2] = {ls.x * kLog2e, ls.y * kLog2e};
          int2 qseg2 = make_int2(0, 0);
          if (kMasked && p.qseg != nullptr)
            qseg2 = *reinterpret_cast<const int2*>(qs + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e & 1;
            float pr = exp2_approx(
                fmaf(__fmul_rn(s[j][e], p.scale), kLog2e, -ll[h]));
            if constexpr (kMasked) {
              const int r = e / 2, c = 8 * j + h;
              const bool keep =
                  c >= cbeg[r] && c < cend[r] &&
                  (p.qseg == nullptr || (h ? qseg2.y : qseg2.x) == ks[r]);
              pr = keep ? pr : 0.f;
            }
            dp[j][e] = pr * (dp[j][e] - (h ? de.y : de.x) + (h ? gl.y : gl.x)) *
                       p.scale;
            s[j][e] = pr;
          }
        }
      };
      if (p.causal || p.qseg != nullptr || qn < kQ || w0 + 16 > p.tk)
        grads(std::true_type{});
      else
        grads(std::false_type{});

      // dV += P^T.dO and dK += dS^T.Q over the k16 steps of queries.
#pragma unroll
      for (int jj = 0; jj < kJ / 2; ++jj) {
        if (!live(2 * jj) && !live(2 * jj + 1)) continue;
        uint32_t pa[4], da[4];
        repack(pa, s[2 * jj], s[2 * jj + 1]);
        repack(da, dp[2 * jj], dp[2 * jj + 1]);
#pragma unroll
        for (int nn = 0; nn < kN / 2; ++nn) {
          uint32_t b[4];
          ldsm_bt<D>(b, dt, 16 * jj, nn);
          mma_bf16(dv[2 * nn], pa, b[0], b[1]);
          mma_bf16(dv[2 * nn + 1], pa, b[2], b[3]);
          ldsm_bt<D>(b, qt, 16 * jj, nn);
          mma_bf16(dk[2 * nn], da, b[0], b[1]);
          mma_bf16(dk[2 * nn + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for tile it + 2
  }
  cp_async_wait<0>();

  // Each warp's rows of the K and V tiles are its own: stage dK, dV there.
  store_rows<D>(ksm + 16 * warp * kS, dk, static_cast<bf16*>(p.dk), bi,
                hi, p.h, p.tk, w0, p.tk);
  store_rows<D>(vsm + 16 * warp * kS, dv, static_cast<bf16*>(p.dv), bi,
                hi, p.h, p.tk, w0, p.tk);
}

template <int D>
__host__ __device__ constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * 6 * kBlock * (D + 8) + sizeof(int) * 2 * kBlock;
}

// The bf16 dQ. Grid (query tiles of 64, heads, batch); each warp owns 16
// query rows, whose Q and dO rows stay in shared memory with their lse,
// delta and glse in registers. Per key tile of 64 (K, V and the key
// segment ids in two cp.async stages, as in the forward): S = Q.K^T and
// dP = dO.V^T (16 x 64 a warp each), then on the accumulators p =
// exp(s scale - lse), masked, and ds = p (dp - delta + glse) scale,
// rounded to bf16 straight into the A fragments of dQ += dS.K, with K read
// through ldmatrix.trans as V is in the forward's P.V. One block owns its
// dQ rows and walks the keys in order: no atomics, and the same sums in
// the same order on every run. A warp whose rows all lie past Tq, or
// whose causal rows see no key of the tile, skips the products; n8 blocks
// and k16 steps wholly past the keys the block can see are not computed.
// The A fragments of Q and dO are read from shared memory for each key
// tile: at 128 registers four blocks fit an SM at D = 64, which the card
// ran faster than holding them in registers at three blocks.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 4 : 1)
    flash_bwd_dq_mma(Params p) {
  constexpr int kS = D + 8, kK = D / 16, kN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);  // [64][kS] queries
  bf16* dsm = qsm + kBlock * kS;                  // [64][kS] dO
  bf16* ksm = dsm + kBlock * kS;                  // [2][64][kS] keys
  bf16* vsm = ksm + 2 * kBlock * kS;              // [2][64][kS] values
  int* kseg = reinterpret_cast<int*>(vsm + 2 * kBlock * kS);  // [2][64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * kBlock, hi = blockIdx.y, bi = blockIdx.z;
  const int w0 = q0 + 16 * warp;  // the warp's first query row
  const int off = p.tk - p.tq;
  // Row 0 of head hi, batch bi of q, dO, k and v.
  const bf16* q = static_cast<const bf16*>(p.q) + bi * p.sq.b + hi * p.sq.h;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + bi * p.sdo.b + hi * p.sdo.h;
  const bf16* k = static_cast<const bf16*>(p.k) + bi * p.sk.b + hi * p.sk.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bi * p.sv.b + hi * p.sv.h;
  const int* kseg_g =
      p.kseg == nullptr ? nullptr : p.kseg + int64_t(bi) * p.tk;

  const int k_end = key_end(p, q0);
  const int n_tiles = (k_end + kBlock - 1) / kBlock;
  // Exclusive end of the keys this warp's rows can see.
  const int wk_end = p.causal ? min(p.tk, max(0, w0 + 16 + off)) : p.tk;
  const bool active = w0 < p.tq;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * kBlock;
    tile_async<D, kBlock>(ksm + st * kBlock * kS, k, p.sk.t, k0, p.tk);
    tile_async<D, kBlock>(vsm + st * kBlock * kS, v, p.sv.t, k0, p.tk);
    if (kseg_g != nullptr)
      vec_async<kBlock>(kseg + st * kBlock, kseg_g, k0, p.tk, true);
  };
  tile_async<D, kBlock>(qsm, q, p.sq.t, q0, p.tq);
  tile_async<D, kBlock>(dsm, dout, p.sdo.t, q0, p.tq);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // lse log2 e, delta, glse and the segment id of rows g and g + 8.
  float ll[2] = {0.f, 0.f}, de[2] = {0.f, 0.f}, gl[2] = {0.f, 0.f};
  int qs[2] = {0, 0};
  const int64_t rows = (int64_t(bi) * p.h + hi) * p.tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < p.tq) {
      ll[r] = p.lse[rows + row] * kLog2e;
      de[r] = p.delta[rows + row];
      if (p.glse != nullptr) gl[r] = p.glse[rows + row];
      if (p.qseg != nullptr) qs[r] = p.qseg[int64_t(bi) * p.tq + row];
    }
  }

  cp_async_wait<1>();
  __syncthreads();
  const bf16* qw = qsm + 16 * warp * kS;
  const bf16* dw = dsm + 16 * warp * kS;

  float dq[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlock, st = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();

    // Keys of this tile before the block's end (a bound the whole block
    // shares, so that the branches on it stay uniform around mma.sync).
    const int kn = min(kBlock, k_end - k0);
    if (active && wk_end > k0) {
      const bf16* kt = ksm + st * kBlock * kS;
      const bf16* vt = vsm + st * kBlock * kS;
      const int* ks = kseg + st * kBlock;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_a<D>(qa, qw, kk);
        ldsm_a<D>(da, dw, kk);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (16 * jj >= kn) continue;
          uint32_t bk[4], bv[4];
          ldsm_b<D>(bk, kt, 16 * jj, kk);
          ldsm_b<D>(bv, vt, 16 * jj, kk);
          mma_bf16(s[2 * jj], qa, bk[0], bk[1]);
          mma_bf16(dp[2 * jj], da, bv[0], bv[1]);
          if (16 * jj + 8 < kn) {
            mma_bf16(s[2 * jj + 1], qa, bk[2], bk[3]);
            mma_bf16(dp[2 * jj + 1], da, bv[2], bv[3]);
          }
        }
      }

      // ds = p (dp - delta + glse) scale in place of s, with p = exp(s
      // scale - lse), on a tile that a mask touches (kMasked: key c of row
      // r is kept where c < cend[r], for bounds and causality, and the
      // segment ids agree; n8 blocks past the block's keys give ds = 0)
      // or on one of 64 keys that none does. The scale product is its own
      // rounded operation and (dp - delta) + glse is summed in the plain
      // version's order.
      auto grads = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
        int cend[2] = {kBlock, kBlock};
        if constexpr (kMasked) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int lim = p.causal ? w0 + g + 8 * r + off - k0 + 1 : kBlock;
            cend[r] = min(kn, lim) - 2 * t4;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kMasked && 8 * j >= kn) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
            continue;
          }
          int2 kseg2 = make_int2(0, 0);
          if (kMasked && p.qseg != nullptr)
            kseg2 = *reinterpret_cast<const int2*>(ks + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2, h = e & 1;
            float pr = exp2_approx(
                fmaf(__fmul_rn(s[j][e], p.scale), kLog2e, -ll[r]));
            if constexpr (kMasked) {
              const bool keep =
                  8 * j + h < cend[r] &&
                  (p.qseg == nullptr || qs[r] == (h ? kseg2.y : kseg2.x));
              pr = keep ? pr : 0.f;
            }
            s[j][e] = pr * ((dp[j][e] - de[r]) + gl[r]) * p.scale;
          }
        }
      };
      if (p.causal || p.qseg != nullptr || kn < kBlock)
        grads(std::true_type{});
      else
        grads(std::false_type{});

      // dQ += dS.K, dS rounded to bf16 in the A fragments.
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (16 * jj >= kn) continue;
        uint32_t dsa[4];
        repack(dsa, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
        for (int nn = 0; nn < kN / 2; ++nn) {
          uint32_t b[4];
          ldsm_bt<D>(b, kt, 16 * jj, nn);
          mma_bf16(dq[2 * nn], dsa, b[0], b[1]);
          mma_bf16(dq[2 * nn + 1], dsa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for tile it + 2
  }
  cp_async_wait<0>();

  // This warp's rows of the query tile are read only by it: stage dQ there.
  store_rows<D>(qsm + 16 * warp * kS, dq, static_cast<bf16*>(p.dq), bi, hi,
                p.h, p.tq, w0, p.tq);
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// bfloat16 launches the tensor-core kernels, float32 the SIMT kernels.
template <typename T, int D>
int launch(Kind kind, const Params& p, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  void (*kern)(Params);
  size_t smem;
  int threads = kThreads;
  int tiles = (p.tq + kBlock - 1) / kBlock;
  if (kind == kFwd) {
    if constexpr (kMma) {
      kern = flash_fwd_mma<D>;
      smem = fwd_mma_smem<D>();
      threads = kMmaThreads;
    } else {
      kern = flash_fwd<T, D>;
      smem = fwd_smem<D>();
    }
  } else if (kind == kDq) {
    if constexpr (kMma) {
      kern = flash_bwd_dq_mma<D>;
      smem = dq_mma_smem<D>();
      threads = kMmaThreads;
    } else {
      kern = flash_bwd_dq<T, D>;
      smem = dq_smem<D>();
    }
  } else {
    tiles = (p.tk + kBlock - 1) / kBlock;
    if constexpr (kMma) {
      kern = flash_bwd_dkv_mma<D>;
      smem = dkv_mma_smem<D>();
      threads = kMmaThreads;
    } else {
      kern = flash_bwd_dkv<T, D>;
      smem = dkv_smem<D>();
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(tiles, p.h, p.b);
  kern<<<grid, threads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(Kind kind, int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(kind, p, stream);
    case 32: return launch<T, 32>(kind, p, stream);
    case 64: return launch<T, 64>(kind, p, stream);
    case 128: return launch<T, 128>(kind, p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

int run(Kind kind, Params& p, const long long* strides, int b, int h,
        int tq, int tk, int d, float scale, int causal, int dtype,
        void* stream) {
  if (b < 1 || h < 1 || tq < 1 || tk < 1 || b > 65535 || h > 65535)
    return int(cudaErrorInvalidValue);
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.sdo = {strides[9], strides[10], strides[11]};
  p.b = b;
  p.h = h;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(kind, d, p, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(kind, d, p, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Every entry: q, k, v (and dout) BTHD tensors of dtype 0 (float32) or
// 1 (bfloat16) with a contiguous head dim d in {16, 32, 64, 128};
// strides: 12 element strides (batch, token, head) of q, k, v and dout
// (the last three unused by the forward); qseg [B,Tq] and kseg [B,Tk]
// int32 or both null. Outputs are contiguous. Returns
// cudaGetLastError() after the launch, or the error that prevented it.

// o [B,Tq,H,D]; lse [B,H,Tq] float32 or null (then not written).
extern "C" int tpunet_flash_fwd(const void* q, const void* k, const void* v,
                                const int* qseg, const int* kseg, void* o,
                                float* lse, const long long* strides, int b,
                                int h, int tq, int tk, int d, float scale,
                                int causal, int dtype, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.qseg = qseg;
  p.kseg = kseg;
  p.o = o;
  p.lse_out = lse;
  return run(kFwd, p, strides, b, h, tq, tk, d, scale, causal, dtype, stream);
}

// dq [B,Tq,H,D] from lse, delta [B,H,Tq] float32 and glse [B,H,Tq]
// float32 or null (a zero cotangent).
extern "C" int tpunet_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   const float* glse, const int* qseg,
                                   const int* kseg, void* dq,
                                   const long long* strides, int b, int h,
                                   int tq, int tk, int d, float scale,
                                   int causal, int dtype, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.glse = glse;
  p.qseg = qseg;
  p.kseg = kseg;
  p.dq = dq;
  return run(kDq, p, strides, b, h, tq, tk, d, scale, causal, dtype, stream);
}

// dk, dv [B,Tk,H,D], from the same inputs as the dQ entry.
extern "C" int tpunet_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    const float* glse, const int* qseg,
                                    const int* kseg, void* dk, void* dv,
                                    const long long* strides, int b, int h,
                                    int tq, int tk, int d, float scale,
                                    int causal, int dtype, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.glse = glse;
  p.qseg = qseg;
  p.kseg = kseg;
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, p, strides, b, h, tq, tk, d, scale, causal, dtype, stream);
}
