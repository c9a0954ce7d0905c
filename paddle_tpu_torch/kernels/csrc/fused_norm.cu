// Fused RMSNorm and LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of paddle_tpu/kernels/fused_norm.py:
//   _rms_fwd_kernel (:22, launched at :57)   y = x rstd w, saves rstd
//   _rms_bwd_kernel (:30, launched at :85)   dx = rstd (g w - xhat mean(g w xhat)),
//                                            dw = sum_rows g xhat
//   _ln_fwd_kernel  (:167, launched at :211) y = (x - mu) rstd w + b, saves mu, rstd
//   _ln_bwd_kernel  (:179, launched at :242) dx = rstd (g w - mean(g w)
//                                            - xhat mean(g w xhat)),
//                                            dw = sum_rows g xhat, db = sum_rows g
// Every statistic and the affine are f32; each output is cast once.  x is
// [rows, h] row-major (f32, f16 or bf16); w (and b) are [h] in x's dtype or
// f32; the saved statistics are f32 [rows].
//
// What bounds them on an H100: a few flops per element against the bytes
// of x, g, y, dx (2 bytes each in bf16): bytes, at 3.35 TB/s.  What the
// design does about that:
//   * each thread takes 16-byte groups of the row (8 bf16 / 4 f32), so a
//     warp reads 512 contiguous bytes per access.  A row whose length or
//     pointers do not allow 16-byte groups takes the scalar instantiation
//     (N = 1) of the same code;
//   * LayerNorm forward (ln_fwd_rows_kernel): each row is read from device
//     memory once, into registers, by a segment of 1-128 threads sized
//     from h; a block of 128 threads holds w and b in registers and walks
//     many rows, the next row's loads in flight while the current one is
//     reduced; a row too long for registers (more than 1024 groups) takes
//     ln_fwd_kernel, which re-reads it;
//   * RMSNorm forward: one block of up to 256 threads per row; device
//     memory is read once: the second pass re-reads the row from L1/L2;
//   * both backwards (norm_bwd_rows_kernel): as the LayerNorm forward's
//     walk, x and g read once into packed registers by segments of up to
//     512 threads, w held, the next row in flight; dw / db summed in f32
//     registers, the same columns on every row of the walk; a row too
//     long for registers takes norm_bwd_long_kernel;
//   * row sums are warp shuffles, then one shared-memory step across the
//     row's warps, summed by every thread in the same order.
// The TPU kernels carry dw / db in one output block across their
// sequential grid.  CUDA blocks run in parallel, so the backward is two
// launches with no atomics (the sums are deterministic): the row kernel
// writes one f32 partial row of dw (and db) a block, [blocks, h], and
// norm_bwd_sum_kernel sums them per column in a fixed order and casts to
// w's dtype.

// The affine and dx expressions use explicitly rounded f32 operations
// (__fmul_rn, __fadd_rn, __fsub_rn) in the reference's order, so the
// compiler does not contract them into FMAs: the kernels then differ from
// the plain PyTorch versions only in the order of the row and column sums
// (the backward's sums of g w xhat and g xhat are explicit __fmaf_rn).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N elements of T moved as one access: 16 bytes (two for 8 f32 weights),
// or one element in the scalar instantiation
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

// group i of N elements of p, as f32
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, long long i,
                                     float (&out)[N]) {
  const Vec<T, N> v = reinterpret_cast<const Vec<T, N>*>(p)[i];
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = to_float(v.v[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, long long i,
                                      const float (&in)[N]) {
  Vec<T, N> v;
#pragma unroll
  for (int j = 0; j < N; ++j) v.v[j] = from_float<T>(in[j]);
  reinterpret_cast<Vec<T, N>*>(p)[i] = v;
}

// Sum each of v[0..K) over the block; every thread gets the same sums.
// blockDim.x is a multiple of 32; red holds kMaxWarps * K floats.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[w * K + k];
    v[k] = s;
  }
}

// ------------------------------------------------------------ forward
// one block per row
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kMaxThreads)
rms_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ y, float* __restrict__ rstd_out, int h,
               float eps) {
  __shared__ float red[kMaxWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  const int groups = h / N;
  float ss[1] = {0.f};
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
    float a[N];
    load<T, N>(xr, i, a);
#pragma unroll
    for (int j = 0; j < N; ++j) ss[0] += a[j] * a[j];
  }
  block_sum<1>(ss, red);
  const float rstd = rsqrtf(ss[0] / (float)h + eps);
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
    float a[N], wv[N], o[N];
    load<T, N>(xr, i, a);
    load<W, N>(w, i, wv);
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = __fmul_rn(__fmul_rn(a[j], rstd), wv[j]);
    store<T, N>(yr, i, o);
  }
  if (threadIdx.x == 0) rstd_out[row] = rstd;
}

// LayerNorm forward with each row read once, into registers.  A block of
// kLnThreads threads takes rows in segments of tpr = 1 << tpr_log2
// threads a row (R = kLnThreads / tpr rows at a time, several where h is
// small); thread t of a segment holds the row's 16-byte groups t, t + tpr,
// ... (VPT of them, those below h / N).  Two regimes, by what bounds the
// call:
//  * one wave (kWalk false: every row's block fits on the card at once,
//    the decode and prefill-chunk rows): latency.  A segment loads its
//    row, takes the statistics, then loads w and b (so that x's loads go
//    out alone) and stores y.  x converts to f32 as loaded;
//  * a walk (kWalk true: more rows than fit at once, the train rows):
//    bytes in flight.  As many blocks as fit walk the rows, each holding
//    w and b in registers for all of its rows and loading its next row
//    while the current one is reduced and stored.  16-bit rows stay packed
//    as 32-bit words and each of their three uses (sum, variance, affine)
//    converts them again (group_float), so a thread holds 16 registers of
//    x, not 32 floats, and 8 blocks fit on an SM.
// 16-bit w and b stay packed in both regimes (converted at the affine).
// Row sums: each thread adds its groups in order, then an xor shuffle
// tree over the segment's lanes, then (tpr > 32) the row's warps in order
// through shared memory: the same order in both regimes and on every run.
constexpr int kLnThreads = 128;
constexpr int kLnWarps = kLnThreads / 32;

// how the walk keeps a group: 8 16-bit values as four 32-bit words; other
// groups as their elements
template <typename T, int N> struct Packed { using type = Vec<T, N>; };
template <> struct Packed<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Packed<__half, 8> { using type = uint4; };

// element e of a group as f32
template <typename T, int N>
__device__ __forceinline__ float group_float(const Vec<T, N>& g, int e) {
  return to_float(g.v[e]);
}

// element e of 8 16-bit values kept as words: the inline asm is volatile,
// so the compiler neither merges two conversions of one element nor keeps
// the converted row alive across the row's three passes
template <typename T>
__device__ __forceinline__ float group_float(const uint4& g, int e) {
  const uint32_t word = e < 2 ? g.x : e < 4 ? g.y : e < 6 ? g.z : g.w;
  if constexpr (std::is_same<T, __half>::value) {
    float f;
    if (e & 1)
      asm volatile("{\n.reg .b16 lo, hi;\nmov.b32 {lo, hi}, %1;\n"
                   "cvt.f32.f16 %0, hi;\n}" : "=f"(f) : "r"(word));
    else
      asm volatile("{\n.reg .b16 lo, hi;\nmov.b32 {lo, hi}, %1;\n"
                   "cvt.f32.f16 %0, lo;\n}" : "=f"(f) : "r"(word));
    return f;
  } else {
    uint32_t o;
    if (e & 1)
      asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(o) : "r"(word));
    else
      asm volatile("shl.b32 %0, %1, 16;" : "=r"(o) : "r"(word));
    return __uint_as_float(o);
  }
}

// the row sum of each segment's v, in every thread of the segment; red
// holds kLnWarps floats (the mean and the variance use their own, so one
// block barrier each keeps a row's readers ahead of the next writer)
__device__ __forceinline__ float ln_row_sum(float v, int tpr, float* red) {
  for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, per_row = tpr >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int w0 = warp / per_row * per_row;
    v = 0.f;
    for (int w = 0; w < per_row; ++w) v += red[w0 + w];
  }
  return v;
}

// Mean and rstd of the row that segment thread t holds, in every thread
// of the segment (two-pass: the variance about the mean)
template <typename T, int VPT, int N, typename G>
__device__ __forceinline__ void ln_stats(const G (&xa)[VPT], int t, int tpr,
                                         int groups, int h, float eps,
                                         float (&red)[2][kLnWarps],
                                         float& mu, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (t + j * tpr < groups) {
#pragma unroll
      for (int e = 0; e < N; ++e) s += group_float<T>(xa[j], e);
    }
  }
  mu = ln_row_sum(s, tpr, red[0]) / (float)h;
  float vs = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (t + j * tpr < groups) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = group_float<T>(xa[j], e) - mu;
        vs += d * d;
      }
    }
  }
  rstd = rsqrtf(ln_row_sum(vs, tpr, red[1]) / (float)h + eps);
}

// y = (x - mu) rstd w + b of that row, one cast, and its statistics
template <typename T, typename W, int VPT, int N, typename G, typename WG>
__device__ __forceinline__ void ln_store(const G (&xa)[VPT],
                                         const WG (&wr)[VPT],
                                         const WG (&br)[VPT], int t, int tpr,
                                         int groups, float mu, float rstd,
                                         T* __restrict__ yr, float* mean_row,
                                         float* rstd_row) {
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int gi = t + j * tpr;
    if (gi < groups) {
      Vec<T, N> o;
#pragma unroll
      for (int e = 0; e < N; ++e)
        o.v[e] = from_float<T>(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(group_float<T>(xa[j], e), mu),
                                rstd),
                      group_float<W>(wr[j], e)),
            group_float<W>(br[j], e)));
      reinterpret_cast<Vec<T, N>*>(yr)[gi] = o;
    }
  }
  if (t == 0) {
    *mean_row = mu;
    *rstd_row = rstd;
  }
}

template <typename T, typename W, int N, int VPT, bool kWalk>
__global__ void __launch_bounds__(kLnThreads)
ln_fwd_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const W* __restrict__ b, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int rows, int h, int tpr_log2, float eps) {
  using XG = typename std::conditional<kWalk, typename Packed<T, N>::type,
                                       Vec<T, N>>::type;
  using WG = typename Packed<W, N>::type;
  __shared__ float red[2][kLnWarps];
  const int tpr = 1 << tpr_log2, per_block = kLnThreads >> tpr_log2;
  const int t = threadIdx.x & (tpr - 1), seg = threadIdx.x >> tpr_log2;
  const int groups = h / N;
  auto load_row = [&](int row, XG (&dst)[VPT]) {
    const XG* xr = reinterpret_cast<const XG*>(x + (long long)row * h);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int gi = t + j * tpr;
      if (row < rows && gi < groups) dst[j] = xr[gi];
    }
  };
  WG wr[VPT], br[VPT];
  auto load_wb = [&] {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int gi = t + j * tpr;
      if (gi < groups) {
        wr[j] = reinterpret_cast<const WG*>(w)[gi];
        br[j] = reinterpret_cast<const WG*>(b)[gi];
      }
    }
  };
  int row = blockIdx.x * per_block + seg;
  XG xa[VPT];
  float mu, rstd;
  load_row(row, xa);
  if constexpr (!kWalk) {
    ln_stats<T, VPT, N>(xa, t, tpr, groups, h, eps, red, mu, rstd);
    load_wb();
    if (row < rows)
      ln_store<T, W, VPT, N>(xa, wr, br, t, tpr, groups, mu, rstd,
                             y + (long long)row * h, mean_out + row,
                             rstd_out + row);
  } else {
    load_wb();
    // uniform over the block (shuffles and barriers inside); the grid
    // never exceeds the rows
    const int stride = gridDim.x * per_block;
    for (int base = blockIdx.x * per_block; base < rows;
         base += stride, row += stride) {
      XG xn[VPT];
      load_row(row + stride, xn);
      ln_stats<T, VPT, N>(xa, t, tpr, groups, h, eps, red, mu, rstd);
      if (row < rows)
        ln_store<T, W, VPT, N>(xa, wr, br, t, tpr, groups, mu, rstd,
                               y + (long long)row * h, mean_out + row,
                               rstd_out + row);
#pragma unroll
      for (int j = 0; j < VPT; ++j) xa[j] = xn[j];
    }
  }
}

// A row of more than kLnThreads * 8 groups: one block per row, three
// passes over it (the second and third re-read it from L1/L2); two-pass
// statistics (mean, then the variance about it), as the reference
// computes them
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kMaxThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const W* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int h, float eps) {
  __shared__ float red[kMaxWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  const int groups = h / N;
  float s[1] = {0.f};
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
    float a[N];
    load<T, N>(xr, i, a);
#pragma unroll
    for (int j = 0; j < N; ++j) s[0] += a[j];
  }
  block_sum<1>(s, red);
  const float mu = s[0] / (float)h;
  float vs[1] = {0.f};
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
    float a[N];
    load<T, N>(xr, i, a);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float d = a[j] - mu;
      vs[0] += d * d;
    }
  }
  block_sum<1>(vs, red);
  const float rstd = rsqrtf(vs[0] / (float)h + eps);
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
    float a[N], wv[N], bv[N], o[N];
    load<T, N>(xr, i, a);
    load<W, N>(w, i, wv);
    load<W, N>(b, i, bv);
#pragma unroll
    for (int j = 0; j < N; ++j)
      o[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a[j], mu), rstd), wv[j]),
                       bv[j]);
    store<T, N>(yr, i, o);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// ------------------------------------------------------------ backward
// Each row read from device memory once, into registers; dw / db summed in
// registers; then one column sum over the blocks' partial rows.
//
// norm_bwd_rows_kernel: a block of kBwdThreads threads walks rows in
// segments of tpr = 1 << tpr_log2 threads (R = kBwdThreads / tpr rows at
// a time); thread t of a segment holds the row's 16-byte groups t, t +
// tpr, ... (VPT of them, those below h / N) of x and g, packed as loaded
// (group_float converts at each use, so the compiler keeps no converted
// row alive), and of w for the whole walk.  Blocks number what fits on
// the card at once (the wrapper's plan), each walking rows blockIdx.x * R
// + segment, + gridDim.x * R, ...; the next row's x, g and statistics are
// loaded while the current row is reduced and its dx stored.  A thread
// adds g xhat (and g) of its own columns, the same on every row, into f32
// registers; at the end the block's segments add theirs in segment order
// through shared memory and the block writes one partial row of dw (and
// one of db).
// norm_bwd_long_kernel: a row of more than kBwdThreads * VPT groups, one
// row a block at a time, re-read from L1/L2 for dx; each thread adds its
// own columns straight into its block's partial row in device memory.
// norm_bwd_sum_kernel: dw (and db, the same launch) = the partial rows
// summed per column: 32 columns a block, warp k adding rows k, k + 16,
// ... in order (their loads issued together), then the 16 warps in order.
// No atomics: two runs, and a CUDA graph's replay, give the same bits.
// Sums in both row kernels: each thread adds its groups' elements in
// order (fmaf for g w xhat), an xor shuffle tree over the segment's
// lanes, then (tpr > 32) the segment's warps in order.
// The row kernels declare a minimum of one block an SM: left free, ptxas
// held the scalar instantiations to 64 registers (two blocks an SM) and
// spilled a few bytes.
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdCols = 16;  // most columns a thread holds (VPT x N)
constexpr int kSumWarps = 16;

// groups a thread holds: 2 of 16 bytes, or 8 scalars
template <int N> constexpr int kBwdVpt = N > 1 ? 2 : 8;

// v[0..K) summed over each segment's tpr threads, in every thread of the
// segment; red holds K x kBwdWarps floats.  Callers alternate two red
// buffers, so one barrier a call keeps a row's readers ahead of the next
// row's writers.  Every thread of the block calls it.
template <int K>
__device__ __forceinline__ void seg_sum(float (&v)[K], int tpr, float* red) {
  for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, per_row = tpr >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[k * kBwdWarps + warp] = v[k];
    }
    __syncthreads();
    const int w0 = warp / per_row * per_row;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int w = 0; w < per_row; ++w) s += red[k * kBwdWarps + w0 + w];
      v[k] = s;
    }
  }
}

template <bool RMS>
__device__ __forceinline__ float bwd_xhat(float x, float mu, float rs) {
  return RMS ? __fmul_rn(x, rs) : __fmul_rn(__fsub_rn(x, mu), rs);
}

// dx of one element: rstd (g w - xhat mean(g w xhat)) for RMSNorm,
// rstd (g w - mean(g w) - xhat mean(g w xhat)) for LayerNorm
template <bool RMS>
__device__ __forceinline__ float bwd_dx(float gw, float xhat, float rs,
                                        float mean_gx, float mean_gw) {
  const float inner =
      RMS ? __fsub_rn(gw, __fmul_rn(xhat, mean_gx))
          : __fsub_rn(__fsub_rn(gw, mean_gw), __fmul_rn(xhat, mean_gx));
  return __fmul_rn(rs, inner);
}

template <typename T, typename W, int N, int VPT, bool RMS>
__global__ void __launch_bounds__(kBwdThreads, 1)
norm_bwd_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd, const T* __restrict__ g,
                     T* __restrict__ dx, float* __restrict__ part, int rows,
                     int h, int tpr_log2) {
  using XG = typename Packed<T, N>::type;
  using WG = typename Packed<W, N>::type;
  constexpr int K = RMS ? 1 : 2;
  __shared__ float red[2][K * kBwdWarps];
  __shared__ float cols[kBwdThreads * kBwdCols];
  const int tpr = 1 << tpr_log2, per_block = kBwdThreads >> tpr_log2;
  const int t = threadIdx.x & (tpr - 1), seg = threadIdx.x >> tpr_log2;
  const int groups = h / N;
  auto load_row = [&](int row, XG (&xd)[VPT], XG (&gd)[VPT], float& mu,
                      float& rs) {
    if (row < rows) {
      const long long off = (long long)row * h;
      const XG* xr = reinterpret_cast<const XG*>(x + off);
      const XG* gr = reinterpret_cast<const XG*>(g + off);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int gi = t + j * tpr;
        if (gi < groups) {
          xd[j] = xr[gi];
          gd[j] = gr[gi];
        }
      }
      rs = rstd[row];
      if (!RMS) mu = mean[row];
    }
  };
  WG wr[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int gi = t + j * tpr;
    if (gi < groups) wr[j] = reinterpret_cast<const WG*>(w)[gi];
  }
  float aw[VPT][N], ab[VPT][N];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
#pragma unroll
    for (int e = 0; e < N; ++e) aw[j][e] = ab[j][e] = 0.f;
  }
  int row = blockIdx.x * per_block + seg;
  XG xa[VPT], ga[VPT];
  float mu = 0.f, rs = 0.f;
  load_row(row, xa, ga, mu, rs);
  // uniform over the block (shuffles and barriers inside)
  const int stride = gridDim.x * per_block;
  int parity = 0;
  for (int base = blockIdx.x * per_block; base < rows;
       base += stride, row += stride, parity ^= 1) {
    XG xn[VPT], gn[VPT];
    float mun = 0.f, rsn = 0.f;
    load_row(row + stride, xn, gn, mun, rsn);
    const bool live = row < rows;
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = 0.f;
    if (live) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (t + j * tpr < groups) {
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float xhat = bwd_xhat<RMS>(group_float<T>(xa[j], e), mu, rs);
            const float gw =
                __fmul_rn(group_float<T>(ga[j], e), group_float<W>(wr[j], e));
            s[0] = __fmaf_rn(gw, xhat, s[0]);
            if (!RMS) s[K - 1] = __fadd_rn(s[K - 1], gw);
          }
        }
      }
    }
    seg_sum<K>(s, tpr, red[parity]);
    const float mean_gx = s[0] / (float)h;
    const float mean_gw = RMS ? 0.f : s[K - 1] / (float)h;
    if (live) {
      T* dxr = dx + (long long)row * h;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int gi = t + j * tpr;
        if (gi < groups) {
          Vec<T, N> o;
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float gv = group_float<T>(ga[j], e);
            const float xhat = bwd_xhat<RMS>(group_float<T>(xa[j], e), mu, rs);
            const float gw = __fmul_rn(gv, group_float<W>(wr[j], e));
            o.v[e] = from_float<T>(bwd_dx<RMS>(gw, xhat, rs, mean_gx, mean_gw));
            aw[j][e] = __fmaf_rn(gv, xhat, aw[j][e]);
            if (!RMS) ab[j][e] = __fadd_rn(ab[j][e], gv);
          }
          reinterpret_cast<Vec<T, N>*>(dxr)[gi] = o;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      xa[j] = xn[j];
      ga[j] = gn[j];
    }
    mu = mun;
    rs = rsn;
  }
  // the block's partial rows: column c of segment s at cols[s * h + c]
  // (per_block x h <= kBwdThreads x VPT x N floats), then each column
  // summed in segment order
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k) __syncthreads();  // the dw readers are done with cols
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int gi = t + j * tpr;
      if (gi < groups) {
#pragma unroll
        for (int e = 0; e < N; ++e)
          cols[seg * h + gi * N + e] = k ? ab[j][e] : aw[j][e];
      }
    }
    __syncthreads();
    float* out = part + ((long long)k * gridDim.x + blockIdx.x) * h;
    for (int c = threadIdx.x; c < h; c += kBwdThreads) {
      float v = cols[c];
      for (int s2 = 1; s2 < per_block; ++s2) v += cols[s2 * h + c];
      out[c] = v;
    }
  }
}

template <typename T, typename W, int N, bool RMS>
__global__ void __launch_bounds__(kBwdThreads, 1)
norm_bwd_long_kernel(const T* __restrict__ x, const W* __restrict__ w,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd, const T* __restrict__ g,
                     T* __restrict__ dx, float* __restrict__ part, int rows,
                     int h) {
  constexpr int K = RMS ? 1 : 2;
  __shared__ float red[2][K * kBwdWarps];
  const int groups = h / N;
  float* pw = part + (long long)blockIdx.x * h;
  float* pb = part + ((long long)gridDim.x + blockIdx.x) * h;
  bool first = true;
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const long long off = (long long)row * h;
    const T* xr = x + off;
    const T* gr = g + off;
    const float rs = rstd[row];
    const float mu = RMS ? 0.f : mean[row];
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = 0.f;
    for (int i = threadIdx.x; i < groups; i += kBwdThreads) {
      float a[N], gv[N], wv[N];
      load<T, N>(xr, i, a);
      load<T, N>(gr, i, gv);
      load<W, N>(w, i, wv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float gw = __fmul_rn(gv[e], wv[e]);
        s[0] = __fmaf_rn(gw, bwd_xhat<RMS>(a[e], mu, rs), s[0]);
        if (!RMS) s[K - 1] = __fadd_rn(s[K - 1], gw);
      }
    }
    seg_sum<K>(s, kBwdThreads, red[parity]);
    const float mean_gx = s[0] / (float)h;
    const float mean_gw = RMS ? 0.f : s[K - 1] / (float)h;
    // the second pass re-reads the row from L1/L2
    for (int i = threadIdx.x; i < groups; i += kBwdThreads) {
      float a[N], gv[N], wv[N], o[N], sw[N], sb[N];
      load<T, N>(xr, i, a);
      load<T, N>(gr, i, gv);
      load<W, N>(w, i, wv);
      if (!first) {
        load<float, N>(pw, i, sw);
        if (!RMS) load<float, N>(pb, i, sb);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = bwd_xhat<RMS>(a[e], mu, rs);
        o[e] = bwd_dx<RMS>(__fmul_rn(gv[e], wv[e]), xhat, rs, mean_gx,
                           mean_gw);
        sw[e] = __fmaf_rn(gv[e], xhat, first ? 0.f : sw[e]);
        if (!RMS) sb[e] = __fadd_rn(first ? 0.f : sb[e], gv[e]);
      }
      store<T, N>(dx + off, i, o);
      store<float, N>(pw, i, sw);
      if (!RMS) store<float, N>(pb, i, sb);
    }
    first = false;
  }
  if (first) {  // a block with no row (the plan gives every block one)
    for (int c = threadIdx.x; c < h; c += kBwdThreads) {
      pw[c] = 0.f;
      if (!RMS) pb[c] = 0.f;
    }
  }
}

// dw (blockIdx.y 0) or db (1): part[blockIdx.y] [n_part, h] summed per
// column in a fixed order, cast to W
template <typename W>
__global__ void __launch_bounds__(kSumWarps * 32)
norm_bwd_sum_kernel(const float* __restrict__ part, int n_part, int h,
                    W* __restrict__ dw, W* __restrict__ db) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* p = part + (long long)blockIdx.y * n_part * h + c;
  float s = 0.f;
  if (c < h) {
#pragma unroll 8
    for (int r = warp; r < n_part; r += kSumWarps) s += p[(long long)r * h];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < h) {
    float v = red[0][lane];
#pragma unroll
    for (int k = 1; k < kSumWarps; ++k) v += red[k][lane];
    (blockIdx.y ? db : dw)[c] = from_float<W>(v);
  }
}

int threads_for(int groups) {
  const int t = (groups + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// blocks of `kernel` one SM holds at once (at least 1)
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads = kLnThreads) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, kernel, threads, 0) == cudaSuccess && n > 0 ? n : 1;
}

// ln_fwd_rows_kernel over every row: tpr threads a row, the fewest (a
// power of two) whose VPT groups each cover it.  One block per R rows when
// they all fit on the card at once; else (16-byte groups) the walk, with
// as many blocks as fit.
template <typename T, typename W, int N, int VPT>
cudaError_t ln_rows(const void* x, const void* w, const void* b, void* y,
                    void* mean, void* rstd, int rows, int h, float eps,
                    cudaStream_t stream) {
  int tpr_log2 = 0;
  while ((VPT << tpr_log2) < h / N) ++tpr_log2;
  const long long per_block = kLnThreads >> tpr_log2;
  const long long need = (rows + per_block - 1) / per_block;
  auto one = ln_fwd_rows_kernel<T, W, N, VPT, false>;
  auto launch = [&](auto kernel, long long grid) {
    kernel<<<(int)grid, kLnThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const W*>(b), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, h,
        tpr_log2, eps);
    return cudaGetLastError();
  };
  if constexpr (N > 1) {
    static const int one_per_sm = blocks_per_sm(one);
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (need > (long long)sms * one_per_sm) {
      auto walk = ln_fwd_rows_kernel<T, W, N, VPT, true>;
      static const int walk_per_sm = blocks_per_sm(walk);
      const long long fit = (long long)sms * walk_per_sm;
      return launch(walk, need < fit ? need : fit);
    }
  }
  return launch(one, need);
}

template <typename T, typename W, int N>
cudaError_t fwd(const void* x, const void* w, const void* b, void* y,
                void* mean, void* rstd, int rms, int rows, int h, float eps,
                cudaStream_t stream) {
  const int groups = h / N;
  if (!rms && groups <= kLnThreads * 4)
    return ln_rows<T, W, N, 4>(x, w, b, y, mean, rstd, rows, h, eps, stream);
  if (!rms && groups <= kLnThreads * 8)
    return ln_rows<T, W, N, 8>(x, w, b, y, mean, rstd, rows, h, eps, stream);
  const int threads = threads_for(groups);
  if (rms)
    rms_fwd_kernel<T, W, N><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), static_cast<float*>(rstd), h, eps);
  else
    ln_fwd_kernel<T, W, N><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const W*>(b), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), h, eps);
  return cudaGetLastError();
}

// blocks of the backward's row kernel (long: the long-row one) that fit
// on the current device at once
template <typename T, typename W, int N>
int bwd_blocks(int rms, int long_rows) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  constexpr int VPT = kBwdVpt<N>;
  const int per_sm =
      long_rows ? (rms ? blocks_per_sm(norm_bwd_long_kernel<T, W, N, true>,
                                       kBwdThreads)
                       : blocks_per_sm(norm_bwd_long_kernel<T, W, N, false>,
                                       kBwdThreads))
                : (rms ? blocks_per_sm(
                             norm_bwd_rows_kernel<T, W, N, VPT, true>,
                             kBwdThreads)
                       : blocks_per_sm(
                             norm_bwd_rows_kernel<T, W, N, VPT, false>,
                             kBwdThreads));
  return sms * per_sm;
}

// the row kernel over `blocks` blocks (tpr_log2 < 0: the long-row one),
// then the column sum of its partial rows
template <typename T, typename W, int N, bool RMS>
cudaError_t bwd_launch(const void* x, const void* w, const void* mean,
                       const void* rstd, const void* g, void* dx, void* dw,
                       void* db, float* part, int rows, int h,
                       int tpr_log2, int blocks, cudaStream_t stream) {
  constexpr int VPT = kBwdVpt<N>;
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  const float* mt = static_cast<const float*>(mean);
  const float* rt = static_cast<const float*>(rstd);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  if (tpr_log2 < 0) {
    norm_bwd_long_kernel<T, W, N, RMS><<<blocks, kBwdThreads, 0, stream>>>(
        xt, wt, mt, rt, gt, dxt, part, rows, h);
  } else {
    if ((kBwdThreads >> tpr_log2) < 1 || ((long long)VPT * N << tpr_log2) < h)
      return cudaErrorInvalidValue;
    norm_bwd_rows_kernel<T, W, N, VPT, RMS>
        <<<blocks, kBwdThreads, 0, stream>>>(xt, wt, mt, rt, gt, dxt, part,
                                             rows, h, tpr_log2);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  norm_bwd_sum_kernel<W><<<dim3((h + 31) / 32, RMS ? 1 : 2), kSumWarps * 32,
                           0, stream>>>(part, blocks, h, static_cast<W*>(dw),
                                        static_cast<W*>(db));
  return cudaGetLastError();
}

template <typename T, typename W, int N>
cudaError_t bwd(const void* x, const void* w, const void* mean,
                const void* rstd, const void* g, void* dx, void* dw, void* db,
                void* part, int rms, int rows, int h, int tpr_log2, int blocks,
                cudaStream_t stream) {
  float* p = static_cast<float*>(part);
  return rms ? bwd_launch<T, W, N, true>(x, w, mean, rstd, g, dx, dw, db, p,
                                         rows, h, tpr_log2, blocks, stream)
             : bwd_launch<T, W, N, false>(x, w, mean, rstd, g, dx, dw, db, p,
                                          rows, h, tpr_log2, blocks, stream);
}

// dtype codes: 0 float32, 1 float16, 2 bfloat16; w (and b) is x's dtype
// or float32.  vec: every row is a whole number of 16-byte groups and
// every pointer is 16-byte aligned.
#define NORM_DISPATCH(FN, ...)                                              \
  do {                                                                      \
    if (x_dtype == 0 && w_dtype == 0)                                       \
      return vec ? FN<float, float, 4>(__VA_ARGS__)                         \
                 : FN<float, float, 1>(__VA_ARGS__);                        \
    if (x_dtype == 1 && w_dtype == 1)                                       \
      return vec ? FN<__half, __half, 8>(__VA_ARGS__)                       \
                 : FN<__half, __half, 1>(__VA_ARGS__);                      \
    if (x_dtype == 1 && w_dtype == 0)                                       \
      return vec ? FN<__half, float, 8>(__VA_ARGS__)                        \
                 : FN<__half, float, 1>(__VA_ARGS__);                       \
    if (x_dtype == 2 && w_dtype == 2)                                       \
      return vec ? FN<__nv_bfloat16, __nv_bfloat16, 8>(__VA_ARGS__)         \
                 : FN<__nv_bfloat16, __nv_bfloat16, 1>(__VA_ARGS__);        \
    if (x_dtype == 2 && w_dtype == 0)                                       \
      return vec ? FN<__nv_bfloat16, float, 8>(__VA_ARGS__)                 \
                 : FN<__nv_bfloat16, float, 1>(__VA_ARGS__);                \
    return cudaErrorInvalidValue;                                           \
  } while (0)

}  // namespace

// y = norm(x) w (+ b); saves rstd (and mean) [rows] f32.  rms: 1 RMSNorm
// (b and mean unused), 0 LayerNorm.  Returns the CUDA error of the launch.
extern "C" int fused_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mean, void* rstd, int rms,
                              int x_dtype, int w_dtype, int rows, int h,
                              float eps, int vec, void* stream) {
  if (rows < 1 || h < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  NORM_DISPATCH(fwd, x, w, b, y, mean, rstd, rms, rows, h, eps, s);
}

// dx (x's dtype), dw (and db) in w's dtype, through part: f32 scratch of
// [blocks, h] (RMSNorm) or [2, blocks, h] (LayerNorm).  The launch plan
// (kernels/fused_norm.py, bwd_plan): tpr_log2 the log2 of the threads a
// row of norm_bwd_rows_kernel, or -1 for norm_bwd_long_kernel; blocks at
// most what fits on the card at once (fused_norm_bwd_blocks).  Returns the
// first CUDA error of the launches.
extern "C" int fused_norm_bwd(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* g, void* dx,
                              void* dw, void* db, void* part, int rms,
                              int x_dtype, int w_dtype, int rows, int h,
                              int tpr_log2, int blocks, int vec,
                              void* stream) {
  if (rows < 1 || h < 1 || blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  NORM_DISPATCH(bwd, x, w, mean, rstd, g, dx, dw, db, part, rms, rows, h,
                tpr_log2, blocks, s);
}

// blocks of the backward's row kernel for these dtypes (long_rows: the
// long-row kernel's) that fit on the current device at once; 0 on error
extern "C" int fused_norm_bwd_blocks(int rms, int x_dtype, int w_dtype,
                                     int vec, int long_rows) {
  if (x_dtype < 0 || x_dtype > 2 || (w_dtype != 0 && w_dtype != x_dtype))
    return 0;
  NORM_DISPATCH(bwd_blocks, rms, long_rows);
}
