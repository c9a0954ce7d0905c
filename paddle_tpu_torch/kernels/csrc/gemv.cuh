// Split-K GEMV core for Hopper (sm_90a), shared by decode_block.cu (the
// projections of the decode block) and decode_block_tp.cu (the ring hops
// of the sharded decode block).
//
// out[r, n] = epilogue(sum_k in'(r, k) * W[k, n]) for n < N and up to 8
// batch rows per block, where in' is the input with a transform applied as
// it is staged (none, a norm with the row statistics, silu(gate) * up in
// either half order, or a GeLU) and never written back to device memory,
// and the epilogue adds the residual and the bias and applies an activation.
//
// What bounds it on an H100: at decode the product has B <= 16 rows, a few
// operations per weight byte against the ~295 the card needs to be
// compute-bound, so it is bound by the weight bytes (3.35 TB/s).  Tensor
// cores buy nothing here; f32 FMA on the CUDA cores keeps up.
//
// What the design does about that.  One launch covers column tiles of the
// output (256 columns in bf16, 128 in f32) for up to 8 batch rows at once,
// so each weight byte is read from device memory exactly once for all
// rows.  A thread owns 16 bytes of columns and every 8th weight row of its
// block's K slice, keeps 4 (bf16) or 8 (f32) 16-byte loads in flight, and
// multiplies by the block's input rows, which are staged in shared memory
// as f32 in chunks of `kc` rows (the K slice) with their transform applied
// on the way in.  The 8 warps' sums meet in shared memory in a fixed order,
// each K slice writes its partial, and the last block of a column tile adds
// the slices in slice order (deterministic, no atomics on the data) and
// applies the epilogue.  The grid is sized to one wave of the card (2
// blocks per SM): a second, mostly empty wave nearly doubles a
// projection's time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// The argument block of a GEMV launch, mirrored field for field by the
// ctypes structure _GemvArgs in paddle_tpu_torch/kernels/decode_block.py.
// The output columns come from up to three weight segments (q | k | v, or
// up | gate), each [K, ld_w] with its own optional bias.
struct GemvArgs {
  const void* in;       // [rows, ld_in], T or f32 (in_f32)
  const float* stats;   // [rows, 2] for in_mode 1
  const void* nw;       // [K] T, in_mode 1
  const void* nb;       // [K] T or null, in_mode 1
  const void* w[3];     // [K, ld_w[s]] T
  const void* bias[3];  // [width of segment s] T or null
  const void* res;      // [rows, ld_res], T or f32 (res_f32), or null
  void* out;            // [rows, ld_out], T or f32 (out_f32)
  float* part;          // [ksplit, rows, N] f32: one partial sum per K slice
  unsigned int* counters;  // one per (column tile, row group); zero between
                           // launches (the last block resets its own)
  long long ld_in;
  long long ld_w[3];
  long long ld_res;
  long long ld_out;
  int rows, K, N;
  int seg_end[3];       // cumulative column ends; unused segments end at N
  int in_mode;          // 0 in, 1 (in - mean) * rstd * nw + nb,
                        // 2 silu(in[r, K + k]) * in[r, k],
                        // 3 silu(in[r, k]) * in[r, K + k],
                        // 4 gelu_tanh(in), 5 gelu(in) (erf form)
  int in_f32, res_f32, out_f32;
  int act;              // epilogue: 0 none, 1 gelu (tanh form), 2 gelu (erf)
  int kc;               // input rows per block: the K slice
  int ksplit;           // blocks along K: ceil(K / kc)
  int dtype;            // 0 float32, 2 bfloat16 (weights, nw/nb, biases)
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // batch rows per gemv block
constexpr int kStageIn = 8;       // gemv input loads in flight per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* ptr) {
  return *reinterpret_cast<const Vec<T>*>(ptr);
}

template <typename T>
__device__ __forceinline__ Vec<T> zero_vec() {
  Vec<T> x;
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) x.v[e] = from_float<T>(0.f);
  return x;
}

template <typename T>
__device__ __forceinline__ float read_as_float(const void* p, long long i,
                                               int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : to_float(static_cast<const T*>(p)[i]);
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c0 = 0.7978845608028654f;     // sqrt(2 / pi)
  return v * (0.5f * (1.f + tanhf(c0 * (v + 0.044715f * (v * v * v)))));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return v * (erff(v * 0.7071067811865476f) + 1.f) * 0.5f;
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// stage input rows [r0, r0 + nrows) x [k0, k0 + kn) of the gemv into
// in_s[k][r] as f32 with the input transform applied; each thread first
// issues kStageIn independent loads, then transforms and stores them
template <typename T>
__device__ __forceinline__ void gemv_stage(const GemvArgs& a, float* in_s,
                                           const float (*st)[2], int r0,
                                           int nrows, int k0, int kn) {
  const int n = kn * kRows;
  const bool halves = a.in_mode == 2 || a.in_mode == 3;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kStageIn) {
    float x[kStageIn], p[kStageIn], q[kStageIn];
#pragma unroll
    for (int u = 0; u < kStageIn; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / kn, k = k0 + i % kn;   // k fastest: coalesced reads
      x[u] = p[u] = q[u] = 0.f;
      if (i < n && r < nrows) {
        const long long off = (long long)(r0 + r) * a.ld_in + k;
        x[u] = read_as_float<T>(a.in, off, a.in_f32);
        if (halves) {
          p[u] = read_as_float<T>(a.in, off + a.K, a.in_f32);
        } else if (a.in_mode == 1) {
          p[u] = to_float(static_cast<const T*>(a.nw)[k]);
          if (a.nb) q[u] = to_float(static_cast<const T*>(a.nb)[k]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageIn; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n) continue;
      const int r = i / kn, k = i % kn;
      float v = x[u];
      if (r >= nrows) {
        v = 0.f;
      } else if (a.in_mode == 1) {           // (x - mean) * rstd * w + b
        v = (v - st[r][0]) * st[r][1] * p[u];
        if (a.nb) v = v + q[u];
      } else if (a.in_mode == 2) {           // [up | gate]
        v = silu(p[u]) * v;
      } else if (a.in_mode == 3) {           // [gate | up]
        v = silu(v) * p[u];
      } else if (a.in_mode == 4) {
        v = gelu_tanh(v);
      } else if (a.in_mode == 5) {
        v = gelu_erf(v);
      }
      in_s[k * kRows + r] = v;
    }
  }
}

__device__ __forceinline__ int segment_of(const GemvArgs& a, int col) {
  int s = 0;
  while (s < 2 && col >= a.seg_end[s]) ++s;
  return s;
}

// the epilogue of one output: residual, bias of its segment, activation
template <typename T>
__device__ __forceinline__ void gemv_store(const GemvArgs& a, int row, int n,
                                           float v) {
  if (a.res) v = read_as_float<T>(a.res, (long long)row * a.ld_res + n,
                                  a.res_f32) + v;
  const int s = segment_of(a, n);
  const T* bp = static_cast<const T*>(a.bias[s]);
  if (bp) v = v + to_float(bp[n - (s == 0 ? 0 : a.seg_end[s - 1])]);
  if (a.act == 1) {
    v = gelu_tanh(v);
  } else if (a.act == 2) {
    v = gelu_erf(v);
  }
  const long long o = (long long)row * a.ld_out + n;
  if (a.out_f32) static_cast<float*>(a.out)[o] = v;
  else static_cast<T*>(a.out)[o] = from_float<T>(v);
}

// Block (column tile x, K slice y, row group z): a warp's 32 lanes read 16
// bytes each of one weight row (512 contiguous bytes in bf16), the 8 warps
// take every 8th row of the slice with U rows in flight, each lane
// accumulates its 16 bytes of columns for the 8 batch rows.  The warps'
// sums meet in shared memory and land as this slice's partial; the last
// block of the column tile to finish adds the slices in slice order and
// applies the epilogue.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) gemv_kernel(const GemvArgs a) {
  constexpr int V = Vec<T>::N;            // columns per lane
  constexpr int NC = 32 * V;              // columns per block
  // weight rows in flight per warp: 8 in f32, 4 in bf16, where the 64
  // accumulators leave no registers for more without spilling
  constexpr int U = 32 / V;
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;                     // [kc][kRows], then
  float* red = smem;                      // [kWarps][kRows][NC]
  __shared__ float st_s[kRows][2];
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.z * kRows;
  const int nrows = min(kRows, a.rows - r0);
  const int k0 = blockIdx.y * a.kc;
  const int kn = min(a.kc, a.K - k0);
  const int col = blockIdx.x * NC + lane * V;
  const bool col_ok = col < a.N;
  const int seg = segment_of(a, col);
  const int seg0 = seg == 0 ? 0 : a.seg_end[seg - 1];
  const T* wp = static_cast<const T*>(a.w[seg]) + (col - seg0) +
                (long long)k0 * a.ld_w[seg];
  const long long ldw = a.ld_w[seg];

  if (tid < 2 * kRows) {
    const int r = tid / 2;
    st_s[r][tid % 2] = (a.in_mode == 1 && r < nrows)
                           ? a.stats[2 * (r0 + r) + tid % 2] : 0.f;
  }
  __syncthreads();
  gemv_stage<T>(a, in_s, st_s, r0, nrows, k0, kn);
  __syncthreads();

  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  for (int kk = warp; kk < kn; kk += kWarps * U) {
    Vec<T> wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = kk + u * kWarps;
      wv[u] = (col_ok && k < kn) ? load_vec<T>(wp + (long long)k * ldw)
                                 : zero_vec<T>();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = kk + u * kWarps;
      if (k < kn) {
        const float4 x0 = *reinterpret_cast<const float4*>(&in_s[k * kRows]);
        const float4 x1 =
            *reinterpret_cast<const float4*>(&in_s[k * kRows + 4]);
        const float xr[kRows] = {x0.x, x0.y, x0.z, x0.w,
                                 x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float we = to_float(wv[u].v[e]);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][e] = fmaf(xr[r], we, acc[r][e]);
        }
      }
    }
  }

  __syncthreads();  // in_s is consumed: its space takes the warps' sums
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(&red[(warp * kRows + r) * NC + lane * V + e]) =
          make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
  __syncthreads();
  float* part = a.part + (long long)blockIdx.y * a.rows * a.N;
  for (int i = tid; i < kRows * NC; i += kThreads) {
    const int r = i / NC, c = i % NC;
    const int n = blockIdx.x * NC + c;
    if (r >= nrows || n >= a.N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[(w * kRows + r) * NC + c];
    part[(long long)(r0 + r) * a.N + n] = v;
  }

  // the last block of this (column tile, row group) sums the K slices
  __threadfence();
  __syncthreads();
  unsigned int* cnt = a.counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(cnt, 1u) == (unsigned int)(a.ksplit - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < kRows * NC; i += kThreads) {
    const int r = i / NC, c = i % NC;
    const int n = blockIdx.x * NC + c;
    if (r >= nrows || n >= a.N) continue;
    float v = 0.f;
    for (int sl = 0; sl < a.ksplit; ++sl)
      v += __ldcg(a.part + ((long long)sl * a.rows + r0 + r) * a.N + n);
    gemv_store<T>(a, r0 + r, n, v);
  }
  if (tid == 0) *cnt = 0u;
}

// raise the dynamic shared-memory cap of `kernel` to `bytes` when needed
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_gemv(const GemvArgs& a, cudaStream_t stream) {
  constexpr int NC = 32 * Vec<T>::N;
  const size_t stage = (size_t)a.kc * kRows, reduce = (size_t)kWarps * kRows * NC;
  const size_t smem = sizeof(float) * (stage > reduce ? stage : reduce);
  cudaError_t err = allow_smem(gemv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + NC - 1) / NC, a.ksplit, (a.rows + kRows - 1) / kRows);
  gemv_kernel<T><<<grid, dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

// validate a GemvArgs block and launch it on `stream`; 0 on success, else
// the cudaError_t
inline int gemv_entry(const GemvArgs& a, void* stream) {
  if (a.rows <= 0 || a.N <= 0) return cudaSuccess;
  if (a.K <= 0 || a.kc <= 0 || a.ksplit != (a.K + a.kc - 1) / a.kc ||
      a.in_mode < 0 || a.in_mode > 5 || a.act < 0 || a.act > 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.dtype) {
    case 0: return launch_gemv<float>(a, s);
    case 2: return launch_gemv<__nv_bfloat16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
