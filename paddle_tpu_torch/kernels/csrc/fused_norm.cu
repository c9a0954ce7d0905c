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
//   * RMSNorm forward and both backwards: one block of up to 256 threads
//     per row (forward) or per run of rows (backward); device memory is
//     read once: the passes over a row after the first re-read it from
//     L1/L2, where the first pass left it;
//   * row sums are warp shuffles, then one shared-memory step across the
//     row's warps, summed by every thread in the same order.
// The TPU kernels carry dw / db in one output block across their
// sequential grid.  CUDA blocks run in parallel, so the backward is two
// passes with no atomics (the sums are deterministic): pass 1 writes each
// block's f32 column partials [n_blocks, h] (each thread accumulates its
// own columns in shared memory across the block's rows); pass 2 sums them
// per column in block order and casts to w's dtype.
//
// The affine and dx expressions use explicitly rounded f32 operations
// (__fmul_rn, __fadd_rn, __fsub_rn) in the reference's order, so the
// compiler does not contract them into FMAs: the kernels then differ from
// the plain PyTorch versions only in the order of the row and column sums.

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

// ------------------------------------------------------ backward pass 1
// rows [blockIdx.x * rows_per_block, +rows_per_block) of one block: dx for
// each row, and the block's dw (and db) column partials, accumulated by
// each thread for its own columns in shared memory laid out [N][groups]
// (column i*N + j at j*groups + i: neighbouring threads, neighbouring
// banks), then written to part[blockIdx.x, :] (and part[n_blocks + .., :]).
template <typename T, typename W, int N, bool RMS>
__global__ void __launch_bounds__(kMaxThreads)
norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                const T* __restrict__ g, T* __restrict__ dx,
                float* __restrict__ part, int rows, int h,
                int rows_per_block) {
  __shared__ float red[kMaxWarps * 2];
  extern __shared__ float acc[];  // h floats (dw), then h more (db, LN)
  float* acc_w = acc;
  float* acc_b = acc + h;
  const int groups = h / N;
  for (int c = threadIdx.x; c < (RMS ? h : 2 * h); c += blockDim.x)
    acc[c] = 0.f;
  __syncthreads();  // from here each thread touches only its own columns
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const long long off = (long long)r * h;
    const T* xr = x + off;
    const T* gr = g + off;
    T* dxr = dx + off;
    const float rs = rstd[r];
    const float mu = RMS ? 0.f : mean[r];
    // pass over the row: sum(g w xhat) (and sum(g w))
    float s[2] = {0.f, 0.f};
    for (int i = threadIdx.x; i < groups; i += blockDim.x) {
      float a[N], gv[N], wv[N];
      load<T, N>(xr, i, a);
      load<T, N>(gr, i, gv);
      load<W, N>(w, i, wv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xhat = RMS ? __fmul_rn(a[j], rs)
                               : __fmul_rn(__fsub_rn(a[j], mu), rs);
        const float gw = __fmul_rn(gv[j], wv[j]);
        s[0] += gw * xhat;
        s[1] += gw;
      }
    }
    if (RMS) {
      float s1[1] = {s[0]};
      block_sum<1>(s1, red);
      s[0] = s1[0];
    } else {
      block_sum<2>(s, red);
    }
    const float mean_gx = s[0] / (float)h;
    const float mean_gw = s[1] / (float)h;
    // second pass (the row is in L1/L2): dx and the column partials
    for (int i = threadIdx.x; i < groups; i += blockDim.x) {
      float a[N], gv[N], wv[N], o[N];
      load<T, N>(xr, i, a);
      load<T, N>(gr, i, gv);
      load<W, N>(w, i, wv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xhat = RMS ? __fmul_rn(a[j], rs)
                               : __fmul_rn(__fsub_rn(a[j], mu), rs);
        const float gw = __fmul_rn(gv[j], wv[j]);
        const float inner =
            RMS ? __fsub_rn(gw, __fmul_rn(xhat, mean_gx))
                : __fsub_rn(__fsub_rn(gw, mean_gw), __fmul_rn(xhat, mean_gx));
        o[j] = __fmul_rn(rs, inner);
        acc_w[j * groups + i] += gv[j] * xhat;
        if (!RMS) acc_b[j * groups + i] += gv[j];
      }
      store<T, N>(dxr, i, o);
    }
  }
  // each thread reads back only the entries it accumulated
  float* pw = part + (long long)blockIdx.x * h;
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < N; ++j) pw[i * N + j] = acc_w[j * groups + i];
  }
  if (!RMS) {
    float* pb = part + ((long long)gridDim.x + blockIdx.x) * h;
    for (int i = threadIdx.x; i < groups; i += blockDim.x) {
#pragma unroll
      for (int j = 0; j < N; ++j) pb[i * N + j] = acc_b[j * groups + i];
    }
  }
}

// ------------------------------------------------------ backward pass 2
// out[c] = sum over b of part[b, c], in block order, cast to W
template <typename W>
__global__ void column_sum_kernel(const float* __restrict__ part,
                                  int n_blocks, int h, W* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[(long long)b * h + c];
  out[c] = from_float<W>(s);
}

int threads_for(int groups) {
  const int t = (groups + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// blocks of `kernel` one SM holds at once (at least 1)
template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, kernel, kLnThreads, 0) == cudaSuccess && n > 0 ? n : 1;
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

template <typename T, typename W, int N, bool RMS>
cudaError_t bwd_rows(const void* x, const void* w, const void* mean,
                     const void* rstd, const void* g, void* dx, float* part,
                     int rows, int h, int rows_per_block, int n_blocks,
                     cudaStream_t stream) {
  const int threads = threads_for(h / N);
  const size_t smem = sizeof(float) * (RMS ? 1 : 2) * (size_t)h;
  auto kernel = norm_bwd_kernel<T, W, N, RMS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(g), static_cast<T*>(dx), part, rows, h,
      rows_per_block);
  return cudaGetLastError();
}

template <typename T, typename W, int N>
cudaError_t bwd(const void* x, const void* w, const void* mean,
                const void* rstd, const void* g, void* dx, void* dw, void* db,
                void* part, int rms, int rows, int h, int rows_per_block,
                cudaStream_t stream) {
  const int n_blocks = (rows + rows_per_block - 1) / rows_per_block;
  float* p = static_cast<float*>(part);
  cudaError_t e =
      rms ? bwd_rows<T, W, N, true>(x, w, mean, rstd, g, dx, p, rows, h,
                                    rows_per_block, n_blocks, stream)
          : bwd_rows<T, W, N, false>(x, w, mean, rstd, g, dx, p, rows, h,
                                     rows_per_block, n_blocks, stream);
  if (e != cudaSuccess) return e;
  const int cols = (h + kMaxThreads - 1) / kMaxThreads;
  column_sum_kernel<W><<<cols, kMaxThreads, 0, stream>>>(p, n_blocks, h,
                                                         static_cast<W*>(dw));
  e = cudaGetLastError();
  if (e != cudaSuccess || rms) return e;
  column_sum_kernel<W><<<cols, kMaxThreads, 0, stream>>>(
      p + (long long)n_blocks * h, n_blocks, h, static_cast<W*>(db));
  return cudaGetLastError();
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
// [n_blocks, h] (RMSNorm) or [2, n_blocks, h] (LayerNorm), n_blocks =
// ceil(rows / rows_per_block).  Returns the first CUDA error of the
// launches.
extern "C" int fused_norm_bwd(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* g, void* dx,
                              void* dw, void* db, void* part, int rms,
                              int x_dtype, int w_dtype, int rows, int h,
                              int rows_per_block, int vec, void* stream) {
  if (rows < 1 || h < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  NORM_DISPATCH(bwd, x, w, mean, rstd, g, dx, dw, db, part, rms, rows, h,
                rows_per_block, s);
}
