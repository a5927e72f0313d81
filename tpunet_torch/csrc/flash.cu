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
// Bound: at ViT-B/16's shapes (T = 196, D = 64) each kernel must at
// least read its inputs and write its outputs once: in bf16 at batch
// 128 about 154 MB (forward), 195 MB (dQ) and 233 MB (dK/dV), so bytes
// bound them at 3.35 TB/s (0.046, 0.058, 0.070 ms) ahead of the tensor
// cores (15 GFLOP in the forward take 0.015 ms at 989 TFLOP/s).
//
// Design, right and simple first:
// - one block of 256 threads per (query tile of 64 rows, head, batch)
//   for the forward and dQ, looping over key tiles of 64; one block per
//   (key tile, head, batch) for dK/dV, looping over query tiles. A loop
//   inside the block takes the place of the TPU's sequential grid axis,
//   so nothing is summed across blocks: no atomics, no partials;
// - tiles are staged in shared memory as float32, transposed with a row
//   stride of 65 floats so that every access below is free of bank
//   conflicts; each thread owns a 4 x 4 micro tile of the 64 x 64 score
//   tile (rows ty + 16i, columns tx + 16j) and 4 rows x D/16 columns of
//   the output tile. The products run on the float32 CUDA cores (about
//   one shared-memory load per two fused multiply-adds), far above the
//   byte bound; tensor cores (mma/wgmma) are the next step;
// - the row max and row sum of the online softmax are butterfly
//   reductions over the 16 lanes that share a row, so every lane holds
//   the same bits;
// - any T: rows and keys past the end are masked by bounds (T = 196 is
//   three full tiles and one of 4 rows); a causal block stops at the
//   last key tile its queries can see (dK/dV starts at the first query
//   tile that can see its keys), so tiles wholly in the future are
//   never visited;
// - q, k, v and dO are read through explicit batch/token/head strides
//   (the head dim is contiguous), so they may be the views
//   qkv[:, :, 0..2] of a fused projection without copies; o, dq, dk, dv
//   are written contiguous [B,T,H,D]; lse, delta and glse are [B,H,Tq]
//   float32.
// The plain PyTorch versions (tpunet_torch/ops/flash.py) step through
// the same key tiles and round at the same places; the scale product and
// the running-sum update are written as separate rounded operations
// (__fmul_rn, __fadd_rn) so that the compiler does not fuse them into
// a multiply-add that the plain versions do not make.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kern)(Params);
  size_t smem;
  int tiles;
  if (kind == kFwd) {
    kern = flash_fwd<T, D>;
    smem = fwd_smem<D>();
    tiles = (p.tq + kBlock - 1) / kBlock;
  } else if (kind == kDq) {
    kern = flash_bwd_dq<T, D>;
    smem = dq_smem<D>();
    tiles = (p.tq + kBlock - 1) / kBlock;
  } else {
    kern = flash_bwd_dkv<T, D>;
    smem = dkv_smem<D>();
    tiles = (p.tk + kBlock - 1) / kBlock;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(tiles, p.h, p.b);
  kern<<<grid, kThreads, smem, stream>>>(p);
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
