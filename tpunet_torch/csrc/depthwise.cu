// 3x3 depthwise convolution, NHWC, torch padding=1, stride 1 or 2:
// the forward (depthwise3x3_fwd) and the backward (depthwise3x3_bwd).
// Both stage a band of rows of one image and a chunk of channels in
// shared memory (the forward by the Tensor Memory Accelerator, the
// backward by 16-byte cp.async) and walk it with a 3x3 window in
// registers.

#include <cuda.h>  // CUtensorMap and its enums (no driver library linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// ---------------------------------------------------------------------------
// Forward: replaces the Pallas TPU kernel tpunet/ops/depthwise.py:_kernel
// (launched by _pallas_forward). Same function: x [N,H,W,C] and w [3,3,C]
// give y [N,Ho,Wo,C] with Ho = (H-1)/s + 1, Wo = (W-1)/s + 1; the 9 taps
// are accumulated in float32 and the sum is cast back to the input type
// (float32 or bfloat16).
//
// Bound: bytes. Each output element costs 9 multiply-adds against at
// least 2 bytes read and 2 written in bf16, about 4.5 operations a byte,
// far below the roughly 20 float32 operations a byte at which an H100's
// CUDA cores (67 TFLOP/s against 3.35 TB/s) would be the limit. The least
// time is each input read once plus each output written once over the
// memory rate. But the plain version's arithmetic allows no fused
// multiply-add, so each output element takes 18 float32 instructions,
// and the instructions around them decide whether the kernel keeps up
// with the memory.
//
// Design against that bound (depthwise3x3_fwd):
// - the work is cut into tiles: a band of `rows` output rows of one image
//   (the whole width) by a chunk of `cc` channels (a multiple of 8). A
//   tile's input rows, with a one-pixel halo, are one box of a 4-D tensor
//   map of x (channels, columns, rows, images), which one thread hands to
//   the Tensor Memory Accelerator (cp.async.bulk.tensor); it lands in
//   shared memory densely, with zeros wherever the box lies outside x (the
//   halo), and completes an mbarrier. So each x element is read from
//   device memory once (a halo row between two bands twice, the second
//   time from L2: the chunk is the fastest index of the tiles, then the
//   band), and no thread spends instructions on addresses. The 16-byte
//   cp.async walk of the backward's stage() kept too few bytes in flight
//   here: with it, staging and writing alone took longer than the whole
//   kernel does now;
// - the blocks are persistent: two or three an SM, each walking the tiles
//   with the grid's stride, with two buffers, so that the next tile is on
//   its way while this one is computed. The grid is a multiple of the
//   chunks, so a block keeps one chunk throughout;
// - a thread owns two channels (one bf16x2 or float2 word) for the whole
//   block and loads their 9 weights into registers once. It takes two
//   neighbouring output columns and walks them down the band with their
//   3 x 4 (stride 2: 3 x 5) window of x in registers, read from shared
//   memory one new row a step (stride 2: two) and converted to float32
//   once for both columns; the rows rotate through the registers, so
//   nothing is copied from step to step, and in bf16 the next step's rows
//   are loaded before this step's sums. The four sums of a step (two
//   columns, two channels) are independent, so their additions interleave;
// - the window reuses loaded x values, never partial sums: each output
//   repeats the plain version's arithmetic
//   (tpunet_torch/ops/depthwise.py:depthwise_conv3x3_reference): from +0,
//   the taps in the order (dy, dx), each product rounded (__fmul_rn), then
//   added (__fadd_rn), with no fused multiply-add, so the two agree bit
//   for bit. A tap in the zero halo adds 0 * w, as the plain version's
//   zero padding does;
// - any C: the vector path needs C % 8 == 0, a chunk that divides C,
//   16-byte aligned x, w and y and at most 256 staged columns (a box's
//   limit; W <= 254); the scalar path stages element by element with
//   stage() and loads and stores channel by channel.
// The plan (cc, rows, threads, blocks) is chosen by the wrapper
// (tpunet_torch/ops/depthwise.py:forward_plan).
// ---------------------------------------------------------------------------

namespace {

// Three blocks of up to 256 threads an SM: at most 85 registers a thread.
constexpr int kMaxFwdThreads = 256;
constexpr int kFwdBlocksPerSM = 3;
constexpr int kMaxSmemBytes = 227 * 1024;  // a block's shared memory on sm_90

struct FwdArgs {
  int n, h, w, c, ho, wo, stride;
  int cc, rows, bands, chunks, tiles;  // the plan's tiles
  int srows, sw;  // a tile's staged input rows (with the halo) and columns
  int pairs2;     // column pairs a band row: ceil(wo / 2)
  int tile_bytes, buf_elems;  // a staged tile, and a buffer (128-byte units)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The tile of `bytes` bytes that bar waits for is on its way.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One box of the 4-D tensor map (channels, columns, rows, images) from
// the coordinates (c, col, row, n) into shared memory at dst, densely;
// the Tensor Memory Accelerator fills what lies outside the tensor with
// zeros and completes bar's phase when all of the box's bytes are in.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map,
                                             int c, int col, int row, int n,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(col), "r"(row),
      "r"(n), "r"(smem_addr(bar))
      : "memory");
}

// One window row as loaded: the channel pair at staged columns 0 ..
// kCols - 1, and the same converted to float32.
template <int kCols, typename T>
__device__ __forceinline__ void load_row(typename Pair2<T>::type (&r)[kCols],
                                         const T* p, int cc) {
  using P = typename Pair2<T>::type;
#pragma unroll
  for (int i = 0; i < kCols; ++i) r[i] = *reinterpret_cast<const P*>(p + i * cc);
}

template <int kCols, typename P>
__device__ __forceinline__ void to_f32_row(float2 (&f)[kCols],
                                           const P (&r)[kCols]) {
#pragma unroll
  for (int i = 0; i < kCols; ++i) f[i] = to_f32x2(r[i]);
}

// acc += the taps (dy, 0..2) of the output whose tap (dy, 0) is column j0
// of window row r, in order, each product rounded, then added.
template <int kCols>
__device__ __forceinline__ void add_row(float2& acc, const float2 (&r)[kCols],
                                        int j0, const float2 (&wv)[9],
                                        int dy) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(r[j0 + dx].x, wv[dy * 3 + dx].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(r[j0 + dx].y, wv[dy * 3 + dx].y));
  }
}

// The output whose tap (0, 0) is column j0 of window row a: from +0, the
// taps in the order (dy, dx).
template <int kCols>
__device__ __forceinline__ float2 taps(const float2 (&a)[kCols],
                                       const float2 (&b)[kCols],
                                       const float2 (&c)[kCols], int j0,
                                       const float2 (&wv)[9]) {
  float2 acc = make_float2(0.f, 0.f);
  add_row<kCols>(acc, a, j0, wv, 0);
  add_row<kCols>(acc, b, j0, wv, 1);
  add_row<kCols>(acc, c, j0, wv, 2);
  return acc;
}

// One output row of the thread's two columns (the second only if it lies
// in the image) from window rows a, b, c, stored at yp and yp + nc.
template <int kStride, typename T, bool kVectorised>
__device__ __forceinline__ void emit2(const float2 (&a)[kStride + 3],
                                      const float2 (&b)[kStride + 3],
                                      const float2 (&c)[kStride + 3],
                                      const float2 (&wv)[9], T* yp,
                                      bool second, int ch, int nc) {
  const float2 o0 = taps<kStride + 3>(a, b, c, 0, wv);
  const float2 o1 = taps<kStride + 3>(a, b, c, kStride, wv);
  // Both outputs are computed whether or not the second lies in the
  // image (its taps are staged, zero past the edge), so that the
  // compiler interleaves the four sums; a second column past the edge
  // is stored over the first, which its own store then overwrites.
  store2<T, kVectorised>(second ? yp + nc : yp, o1, ch, nc);
  store2<T, kVectorised>(yp, o0, ch, nc);
}

// The next staged row at p into dst as float32. With kAhead (bf16) the
// row was loaded into n by the step before, and the row after it (if
// `more`) is loaded now, so that its latency hides behind this step's
// sums; float32 has no registers to spare for that and loads it now.
template <bool kAhead, int kCols, typename T, typename P>
__device__ __forceinline__ void advance(float2 (&dst)[kCols], P (&n)[kCols],
                                        const T* p, bool more, int cc) {
  if (kAhead) {
    to_f32_row<kCols>(dst, n);
    if (more) load_row<kCols>(n, p, cc);
  } else {
    load_row<kCols>(n, p, cc);
    to_f32_row<kCols>(dst, n);
  }
}

// A band of `rows` output rows, columns q and q + 1, one channel pair: xs
// is the staged tile at the pair's channels and column kStride * q, yp the
// output at (first row, q). The window rows rotate through three
// register arrays (stride 2: the last row of one step is the first of
// the next), so no value moves between registers from step to step.
template <int kStride, typename T, bool kVectorised>
__device__ __forceinline__ void walk(const T* xs, int rs, int cc, T* yp,
                                     int64_t ystep, int rows, bool second,
                                     const float2 (&wv)[9], int ch, int nc) {
  using P = typename Pair2<T>::type;
  constexpr int kCols = kStride + 3;
  constexpr bool kAhead = sizeof(T) == 2;
  float2 r0[kCols], r1[kCols], r2[kCols];
  P n1[kCols], n2[kCols];  // rows as loaded
  load_row<kCols>(n1, xs, cc);
  to_f32_row<kCols>(r0, n1);
  xs += rs;
  if (kStride == 1) {
    load_row<kCols>(n1, xs, cc);
    to_f32_row<kCols>(r1, n1);
    xs += rs;
  }
  if (kAhead) {  // the first step's new rows
    load_row<kCols>(n1, xs, cc);
    if (kStride == 2) load_row<kCols>(n2, xs + rs, cc);
    xs += kStride * rs;
  }
  if (kStride == 1) {
    for (int i = 0;;) {
      advance<kAhead>(r2, n1, xs, i + 1 < rows, cc);
      emit2<kStride, T, kVectorised>(r0, r1, r2, wv, yp, second, ch, nc);
      xs += rs;
      yp += ystep;
      if (++i == rows) break;
      advance<kAhead>(r0, n1, xs, i + 1 < rows, cc);
      emit2<kStride, T, kVectorised>(r1, r2, r0, wv, yp, second, ch, nc);
      xs += rs;
      yp += ystep;
      if (++i == rows) break;
      advance<kAhead>(r1, n1, xs, i + 1 < rows, cc);
      emit2<kStride, T, kVectorised>(r2, r0, r1, wv, yp, second, ch, nc);
      xs += rs;
      yp += ystep;
      if (++i == rows) break;
    }
  } else {
    for (int i = 0;;) {
      advance<kAhead>(r1, n1, xs, i + 1 < rows, cc);
      advance<kAhead>(r2, n2, xs + rs, i + 1 < rows, cc);
      emit2<kStride, T, kVectorised>(r0, r1, r2, wv, yp, second, ch, nc);
      xs += 2 * rs;
      yp += ystep;
      if (++i == rows) break;
      advance<kAhead>(r1, n1, xs, i + 1 < rows, cc);
      advance<kAhead>(r0, n2, xs + rs, i + 1 < rows, cc);
      emit2<kStride, T, kVectorised>(r2, r1, r0, wv, yp, second, ch, nc);
      xs += 2 * rs;
      yp += ystep;
      if (++i == rows) break;
    }
  }
}

template <typename T, bool kVectorised>
__global__ void __launch_bounds__(kMaxFwdThreads, kFwdBlocksPerSM)
    depthwise3x3_fwd(const __grid_constant__ CUtensorMap xmap,
                     const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t landed[2];  // a buffer's tile is in (16-byte path)
  const int cc = a.cc;
  T* const bufs = reinterpret_cast<T*>(smem_raw);  // 2 x [srows][sw][cc]
  // The chunk: the same for every tile of this block (the grid is a
  // multiple of the chunks).
  const int c0 = (blockIdx.x % a.chunks) * cc;

  // Stage tile t (band, then image, above the chunk) into buffer b: one
  // box of the tensor map, issued by one thread, on the 16-byte path;
  // element by element by every thread on the scalar path.
  auto stage_tile = [&](int t, int b) {
    const int nb = t / a.chunks, band = nb % a.bands, n = nb / a.bands;
    const int r0 = band * a.rows * a.stride - 1;
    if (kVectorised) {
      if (threadIdx.x == 0) {
        // The buffer's last readers passed a barrier since; order their
        // reads before the copy engine's writes.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(&landed[b], a.tile_bytes);
        tma_load_box(bufs + b * a.buf_elems, &xmap, c0, -1, r0, n,
                     &landed[b]);
      }
    } else {
      stage<T, false>(bufs + b * a.buf_elems,
                      x + int64_t(n) * a.h * a.w * a.c, a.srows, a.sw, cc,
                      r0, 1, a.h, a.w, a.c, c0);
    }
  };
  if (kVectorised && threadIdx.x == 0) {
    mbar_init(&landed[0]);
    mbar_init(&landed[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int t = blockIdx.x;
  if (t < a.tiles) stage_tile(t, 0);

  // This thread's channel pair, the same for every column and tile it
  // takes (blockDim.x is a multiple of the pairs a chunk holds), and its
  // 9 weights, loaded while the first tile is in flight.
  const int pairs = cc / 2, k = threadIdx.x % pairs, ch = c0 + 2 * k;
  const bool active = ch < a.c;
  float2 wv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    wv[i] = active ? load2<T, kVectorised>(w + i * a.c + ch, ch, a.c)
                   : make_float2(0.f, 0.f);
  const int rs = a.sw * cc;  // one staged row
  const int64_t ystep = int64_t(a.wo) * a.c;

  uint32_t parity = 0;  // bit b: the phase of landed[b] to wait for
  for (int b = 0; t < a.tiles; t += gridDim.x, b ^= 1) {
    // The next tile into the other buffer (the barrier at the end of the
    // last step let every thread finish reading it), then wait for this
    // one.
    if (t + int(gridDim.x) < a.tiles) stage_tile(t + gridDim.x, b ^ 1);
    if (kVectorised) {
      mbar_wait(&landed[b], (parity >> b) & 1);
      parity ^= 1u << b;
    } else {
      __syncthreads();
    }
    const int nb = t / a.chunks, band = nb % a.bands, n = nb / a.bands;
    const int o0 = band * a.rows, rows = min(a.rows, a.ho - o0);
    const T* tile = bufs + b * a.buf_elems + 2 * k;
    for (int j = threadIdx.x / pairs; active && j < a.pairs2;
         j += blockDim.x / pairs) {
      const int q = 2 * j;  // the first of the thread's two columns
      T* yp = y + ((int64_t(n) * a.ho + o0) * a.wo + q) * a.c + ch;
      if (a.stride == 1)
        walk<1, T, kVectorised>(tile + q * cc, rs, cc, yp, ystep, rows,
                                q + 1 < a.wo, wv, ch, a.c);
      else
        walk<2, T, kVectorised>(tile + 2 * q * cc, rs, cc, yp, ystep, rows,
                                q + 1 < a.wo, wv, ch, a.c);
    }
    __syncthreads();
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library links no driver library); null if the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of x [n, h, w, c] as (c, w, h, n), innermost first; a
// box is one tile: cc channels, sw columns from -1, srows rows, one image.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* x, const FwdArgs& a) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {cuuint64_t(a.c), cuuint64_t(a.w),
                              cuuint64_t(a.h), cuuint64_t(a.n)};
  const cuuint64_t strides[3] = {a.c * e, cuuint64_t(a.w) * a.c * e,
                                 cuuint64_t(a.h) * a.w * a.c * e};
  const cuuint32_t box[4] = {cuuint32_t(a.cc), cuuint32_t(a.sw),
                             cuuint32_t(a.srows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, FwdArgs a,
               int threads, int blocks, int vectorised,
               cudaStream_t stream) {
  a.tile_bytes = a.srows * a.sw * a.cc * int(sizeof(T));
  a.buf_elems = (a.tile_bytes + 127) / 128 * 128 / int(sizeof(T));
  const size_t smem = 2 * size_t(a.buf_elems) * sizeof(T);
  if (smem > size_t(kMaxSmemBytes)) return int(cudaErrorInvalidValue);
  CUtensorMap map{};
  if (vectorised && !tensor_map<T>(&map, x, a))
    return int(cudaErrorInvalidValue);
  void (*kern)(const CUtensorMap, const T*, const T*, T*, FwdArgs) =
      vectorised ? depthwise3x3_fwd<T, true> : depthwise3x3_fwd<T, false>;
  if (smem > 48 * 1024) {  // above the default limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kern<<<blocks, threads, smem, stream>>>(
      map, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(y), a);
  return int(cudaGetLastError());
}

}  // namespace

// One call's shape and plan. cc: channels a tile takes, a multiple of 8;
// rows: output rows a tile takes; threads: a multiple of 32 and of cc / 2,
// at most 256; blocks: the persistent grid, a multiple of the chunks
// ceil(c / cc), at most the tiles n * ceil(Ho / rows) * chunks. dtype: 0 =
// float32, 1 = bfloat16. (One struct, not a dozen arguments: each argument
// of a foreign call costs the caller host time.)
struct FwdCall {
  int n, h, w, c, stride, cc, rows, threads, blocks, dtype;
};

// vectorised: 1 only when c % 8 == 0, cc divides c, x, w and y are
// 16-byte aligned and a tile's staged columns (W + 2 rounded up to a
// whole column pair) number at most 256, a box of the tensor map.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan it cannot run; the caller raises on
// anything but 0.
extern "C" int tpunet_depthwise3x3_fwd(const void* x, const void* w, void* y,
                                       const FwdCall* call, int vectorised,
                                       void* stream) {
  const FwdCall& p = *call;
  const int n = p.n, h = p.h, wd = p.w, c = p.c, stride = p.stride;
  const int cc = p.cc, rows = p.rows, threads = p.threads;
  if (n < 1 || h < 1 || wd < 1 || c < 1 || (stride != 1 && stride != 2) ||
      cc < 8 || cc % 8 || rows < 1 || threads < 32 ||
      threads > kMaxFwdThreads || threads % 32 || threads % (cc / 2) ||
      (vectorised && c % cc))
    return int(cudaErrorInvalidValue);
  FwdArgs a;
  a.n = n;
  a.h = h;
  a.w = wd;
  a.c = c;
  a.stride = stride;
  a.ho = (h - 1) / stride + 1;
  a.wo = (wd - 1) / stride + 1;
  a.cc = cc;
  a.rows = rows;
  a.bands = (a.ho + rows - 1) / rows;
  a.chunks = (c + cc - 1) / cc;
  const int64_t tiles = int64_t(n) * a.bands * a.chunks;
  a.pairs2 = (a.wo + 1) / 2;
  a.srows = stride == 1 ? rows + 2 : 2 * rows + 1;
  // Two output columns a thread: the staged columns reach a whole pair.
  a.sw = stride * 2 * a.pairs2 + 3 - stride;
  if (tiles > INT32_MAX || p.blocks < 1 || p.blocks > tiles ||
      p.blocks % a.chunks || a.srows > 256 || (vectorised && a.sw > 256))
    return int(cudaErrorInvalidValue);
  a.tiles = int(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0)
    return launch_fwd<float>(x, w, y, a, threads, p.blocks, vectorised, s);
  if (p.dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, y, a, threads, p.blocks,
                                     vectorised, s);
  return int(cudaErrorInvalidValue);
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
