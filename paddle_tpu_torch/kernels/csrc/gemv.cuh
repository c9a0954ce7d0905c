// GEMV core for Hopper (sm_90a), shared by decode_block.cu (the
// projections of the decode block) and decode_block_tp.cu (the ring hops
// of the sharded decode block).
//
// out[r, n] = epilogue(sum_k in'(r, k) * W[k, n]) for n < N over the batch
// rows, where in' is the input with a transform applied as it is read
// (none, a norm with the row statistics, silu(gate) * up in either half
// order, or a GeLU) and never written back to device memory, and the
// epilogue adds the residual and the bias and applies an activation.
// Sums are f32, with one cast at the end.
//
// What bounds it on an H100: at decode the product has B <= 16 rows, a few
// operations per weight byte against the ~295 the card needs to be
// compute-bound, so it is bound by the weight bytes (3.35 TB/s).
//
// bf16 weights: gemv_stream_kernel.  The earlier split-K kernel ran at
// ~1.6-1.7 TB/s because of latency, not bandwidth: each block staged its
// input before requesting its first weight byte, each warp kept 2 KB of
// loads in flight and issued the next batch only after its FMAs, and every
// K slice wrote an f32 partial that the last block re-read after the
// stream ended.  This kernel keeps the bytes in flight instead:
//  * at most one block per SM, each taking column strips (128 columns) over
//    one K split: grid column groups x K splits, picked per shape by
//    kernels/decode_block.py (plan_gemv) so that the blocks of a split read
//    the same weight rows side by side and K is split only where the
//    strips alone leave SMs idle;
//  * a producer warp streams each 64-row x 128-column weight tile by TMA
//    (two 64-column boxes with the 128-byte swizzle; the maps are encoded
//    once per weight and cached) with the tile's inputs (a TMA box of the
//    input rows, bulk copies of the norm's w and b) into a ring of up to
//    12 stages on mbarriers with bounded waits, the first stages requested
//    before any input is read: up to ~190 KB in flight per SM;
//  * three input warps apply the transform to each landed stage in f32 and
//    split every value into up to three bf16 terms, hi + mid + lo = the f32
//    value (one term for a bf16 input without a transform);
//  * eight consumer warps multiply on the tensor cores (mma.sync m16n8k16:
//    the batch rows as M, padded to 16 with zeros; the weights through
//    ldmatrix), each term against the tile, into a fresh f32 sum per 16
//    weight rows that is added to the strip's in f32, so the products are
//    exact and the tensor cores' own accumulation spans one step.  FMA on
//    the CUDA cores kept up with the bytes only at ~40 % of the card's FMA
//    rate and with 8 warps could not hide its latency;
//  * a strip's sums are finished by its block (epilogue, one cast) or,
//    where K is split, merged by the deterministic last-block rule: each
//    split writes its partial into a fixed workspace slot, and the last to
//    count itself done on the strip's counter adds the partials in split
//    order (the same bits whichever split is last), applies the epilogue
//    and resets the counter.
//    Nothing is allocated per call and no host reads device data, so the
//    launch can be captured by a CUDA graph.
// f32 weights keep gemv_kernel below unchanged: a split-K launch over
// column tiles of 128 columns for up to 8 batch rows, each thread 16 bytes
// of columns and every 8th weight row of its block's K slice with 8 loads
// in flight, the input slice staged in shared memory as f32 first; the 8
// warps' sums meet in shared memory, each K slice writes its partial, and
// the last block of a column tile adds the slices in slice order and
// applies the epilogue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <cstring>
#include <functional>

#include "hopper.cuh"

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
  float* part;          // f32 partials: [ksplit, rows, N] (f32 weights);
                        // [row groups, grid, 2, 8, 128] (bf16 weights)
  unsigned int* counters;  // one per (column tile or strip, row group);
                           // zero between launches (the last block resets
                           // its own)
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
  int kc;               // f32: input rows per block, the K slice
  int ksplit;           // f32: blocks along K, ceil(K / kc)
  int dtype;            // 0 float32, 2 bfloat16 (weights, nw/nb, biases)
  int stages;           // bf16: ring stages of the stream kernel
  int grid;             // bf16: blocks per row group (their shares of work)
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

// the shared memory a block may take on an H100 (227 KB)
constexpr size_t kSmemCap = 232448;

// The most dynamic shared memory `kernel` may take beside its static
// shared memory: the attribute each kernel of these sources is given, once
// per device (hopper::allow_smem).
template <typename Kernel>
size_t dynamic_cap(Kernel kernel) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return 48 * 1024;
  return kSmemCap - fa.sharedSizeBytes;
}

template <typename T>
cudaError_t launch_gemv(const GemvArgs& a, cudaStream_t stream) {
  constexpr int NC = 32 * Vec<T>::N;
  const size_t stage = (size_t)a.kc * kRows, reduce = (size_t)kWarps * kRows * NC;
  const size_t smem = sizeof(float) * (stage > reduce ? stage : reduce);
  static std::atomic<unsigned long long> smem_set{0};
  static const size_t cap = dynamic_cap(gemv_kernel<T>);
  cudaError_t err = hopper::allow_smem(gemv_kernel<T>, cap, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + NC - 1) / NC, a.ksplit, (a.rows + kRows - 1) / kRows);
  gemv_kernel<T><<<grid, dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------- the bf16 stream kernel
constexpr int kStripCols = 128;      // output columns of a strip
constexpr int kTileRows = 64;        // weight rows of a unit (a ring stage)
constexpr int kStreamRows = 16;      // batch rows of a block: one MMA's M
constexpr int kStreamConsumers = 8;  // consumer warps: 16 columns each
constexpr int kStreamInputWarps = 3;
constexpr int kStreamThreads =
    (kStreamConsumers + 1 + kStreamInputWarps) * 32;   // 384
constexpr int kStreamMaxStages = 12;
constexpr uint32_t kStageBytes = kTileRows * kStripCols * 2;  // 16 KB
constexpr uint32_t kBoxBytes = kTileRows * 64 * 2;  // a 64-column box, 8 KB
constexpr int kPartSlot = kStreamRows * kStripCols;  // floats of a slot
constexpr int kConsumerBar = 1;      // named barrier of the consumer warps
// the transformed inputs of a stage are the MMA's A operand: f32 split
// into up to three bf16 terms (hi + mid + lo = the f32 value), each a
// [rows][72] plane (64 columns and 8 of padding, so that a fragment's loads
// hit 32 banks)
constexpr int kSplits = 3;
constexpr int kSplitPitch = kTileRows + 8;
constexpr int kMaxSplitK = 8;        // K splits a merge reads at most
// the launch returns this + the CUresult of a refused tensor map
constexpr int kTmaRefused = 2000;

struct alignas(64) StreamParams {
  CUtensorMap maps[3];  // weight segment s as (width_s, K): 64 x 64 boxes,
                        // 128-byte swizzle
  CUtensorMap x_map;    // the input as (K or 2 K, rows): 64 x 8 or 16 boxes
  GemvArgs a;
};

struct StreamShared {
  // full: the stage's bytes landed; ready: its inputs are transformed;
  // empty: the consumers are done with it
  uint64_t full[kStreamMaxStages], ready[kStreamMaxStages];
  uint64_t empty[kStreamMaxStages];
  float stats[kStreamRows][2];  // the rows' mean and rstd (in_mode 1)
  int last;
  int pad;
};

// What a ring stage holds besides its weight tile, from the launch's
// shapes (kernels/decode_block.py mirrors it): the raw inputs (a box of
// `rows` rows x 64 columns, a second one for the SwiGLU modes' other half,
// then the norm's w and b [2][64] bf16) and the split planes.
struct StreamLayout {
  int rows;          // input rows a stage holds: 8, or 16 above 8 rows
  int es;            // bytes of an input element
  int halves;        // input boxes a stage
  int splits;        // bf16 terms of the A operand (1: a bf16 input as is)
  uint32_t in_box;   // bytes of one input box
  uint32_t raw;      // raw input bytes a stage, 128-byte multiple
  uint32_t plane;    // bytes of one split plane
  uint32_t stage;    // bytes a stage beyond the weight tile
};

__host__ __device__ inline StreamLayout stream_layout(const GemvArgs& a) {
  StreamLayout l;
  l.rows = a.rows > 8 ? kStreamRows : 8;
  l.es = a.in_f32 ? 4 : 2;
  l.halves = (a.in_mode == 2 || a.in_mode == 3) ? 2 : 1;
  l.splits = a.in_f32 || a.in_mode != 0 ? kSplits : 1;
  l.in_box = l.rows * kTileRows * l.es;
  l.raw = (l.halves * l.in_box + 2 * kTileRows * 2 + 127) / 128 * 128;
  l.plane = l.rows * kSplitPitch * 2;
  l.stage = l.raw + l.splits * l.plane;
  return l;
}

// bytes of dynamic shared memory at a.stages ring stages: the 1024-byte
// alignment slack, the weight tiles, the stages' inputs and the barriers
__host__ __device__ inline size_t stream_smem(const GemvArgs& a) {
  return 1024 + (size_t)a.stages * (kStageBytes + stream_layout(a).stage) +
         sizeof(StreamShared);
}

__host__ __device__ __forceinline__ int seg_width(const GemvArgs& a, int s) {
  return a.seg_end[s] - (s == 0 ? 0 : a.seg_end[s - 1]);
}

__host__ __device__ __forceinline__ int stream_strips(const GemvArgs& a) {
  int n = 0;
  for (int s = 0; s < 3; ++s)
    n += (seg_width(a, s) + kStripCols - 1) / kStripCols;
  return n;
}

// segment and first column (within the segment) of strip `strip`
__device__ __forceinline__ void strip_at(const GemvArgs& a, int strip,
                                         int& seg, int& c0) {
  seg = 0;
  c0 = 0;
  int first = 0;
  for (int s = 0; s < 3; ++s) {
    const int n = (seg_width(a, s) + kStripCols - 1) / kStripCols;
    if (strip < first + n) {
      seg = s;
      c0 = (strip - first) * kStripCols;
      return;
    }
    first += n;
  }
}

// silu with the hardware exponential and divide (a few ulps of f32, far
// below the bf16 output's): the SwiGLU transform is the input warps'
// heaviest
__device__ __forceinline__ float silu_fast(float g) {
  return __fdividef(g, 1.f + __expf(-g));
}

// four 8 x 8 b16 matrices, transposed, from the rows the lanes address
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b for one m16n8k16 tile, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  // registers only: the compiler may schedule it among its neighbours
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (column group c, K split q) = (x % Gc, x / Gc), row group y: its
// strips are c, c + Gc, c + 2 Gc, ..., each over the K split's units; the
// producer warp streams the tiles and inputs, the input warps transform
// each unit's inputs, the consumer warps multiply on the tensor cores and
// finish each strip (see the note above).
__global__ void __launch_bounds__(kStreamThreads, 1)
    gemv_stream_kernel(const __grid_constant__ StreamParams p) {
  const GemvArgs& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned by an offset from the shared array itself, so that
  // the compiler keeps every access below in the shared space (LDS / STS)
  unsigned char* w_s =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int S = a.stages;
  const StreamLayout L = stream_layout(a);
  unsigned char* in_s = w_s + (size_t)S * kStageBytes;  // stage st at
                                                        // + st * L.stage
  StreamShared& sh =
      *reinterpret_cast<StreamShared*>(in_s + (size_t)S * L.stage);

  const int strips = stream_strips(a);
  const int kT = (a.K + kTileRows - 1) / kTileRows;   // units of a strip
  const int Gc = a.grid, Gk = a.ksplit;
  const int c = blockIdx.x % Gc, q = blockIdx.x / Gc;
  const int kt0 = q * kT / Gk, nk = (q + 1) * kT / Gk - kt0;
  const int n = (strips - c + Gc - 1) / Gc * nk;      // units of the block
  const int r0 = blockIdx.y * kStreamRows;
  const int nrows = min(kStreamRows, a.rows - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the A operand's rows past the batch stay zero in every stage
  for (int i = threadIdx.x;
       i < S * L.splits * (L.rows - nrows) * (kSplitPitch / 2);
       i += kStreamThreads) {
    const int w = i % (kSplitPitch / 2), rest = i / (kSplitPitch / 2);
    const int r = nrows + rest % (L.rows - nrows);
    const int plane = rest / (L.rows - nrows);
    reinterpret_cast<uint32_t*>(in_s + (size_t)(plane / L.splits) * L.stage +
                                L.raw + (plane % L.splits) * L.plane)
        [r * (kSplitPitch / 2) + w] = 0u;
  }

  if (threadIdx.x < 2 * kStreamRows) {
    const int r = threadIdx.x / 2;
    sh.stats[r][threadIdx.x % 2] =
        a.in_mode == 1 && r < nrows ? a.stats[2 * (r0 + r) + threadIdx.x % 2]
                                    : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      hopper::mbar_init(&sh.full[st], 1);
      hopper::mbar_init(&sh.ready[st], kStreamInputWarps * 32);
      hopper::mbar_init(&sh.empty[st], kStreamConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kStreamConsumers) {
    // ---------------------------------------------------------- producer
    // a stage: the weight tile (two 64-column boxes), the 64 inputs of
    // each row (a box of the input, a second one for the SwiGLU modes'
    // other half) and the norm's w and b (bulk copies)
    if (lane != 0) return;
    for (int s = 0; s < 3; ++s)
      if (seg_width(a, s) > 0) hopper::prefetch_tensor_map(&p.maps[s]);
    hopper::prefetch_tensor_map(&p.x_map);
    int strip = c, kt = 0, seg, c0;
    strip_at(a, strip, seg, c0);
    for (int i = 0; i < n; ++i) {
      const int st = i % S;
      const int k0 = (kt0 + kt) * kTileRows;
      const uint32_t len = min(kTileRows, a.K - k0);
      const uint32_t bytes = kStageBytes + L.halves * L.in_box +
                             (a.in_mode == 1 ? (a.nb ? 4 : 2) * len : 0);
      hopper::mbar_wait(&sh.empty[st], ((i / S) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&sh.full[st], bytes);
      unsigned char* wt = w_s + (size_t)st * kStageBytes;
      hopper::tma_load_2d(wt, &p.maps[seg], &sh.full[st], c0, k0);
      hopper::tma_load_2d(wt + kBoxBytes, &p.maps[seg], &sh.full[st],
                          c0 + 64, k0);
      unsigned char* raw = in_s + (size_t)st * L.stage;
      for (int hh = 0; hh < L.halves; ++hh)
        hopper::tma_load_2d(raw + hh * L.in_box, &p.x_map, &sh.full[st],
                            k0 + hh * a.K, r0);
      if (a.in_mode == 1) {
        unsigned char* nwb = raw + L.halves * L.in_box;
        hopper::bulk_load(nwb, static_cast<const __nv_bfloat16*>(a.nw) + k0,
                          len * 2, &sh.full[st]);
        if (a.nb)
          hopper::bulk_load(nwb + kTileRows * 2,
                            static_cast<const __nv_bfloat16*>(a.nb) + k0,
                            len * 2, &sh.full[st]);
      }
      if (++kt == nk) {
        kt = 0;
        strip += Gc;
        if (i + 1 < n) strip_at(a, strip, seg, c0);
      }
    }
    return;
  }

  if (warp > kStreamConsumers) {
    // ------------------------------------------------------------ inputs
    // each landed stage's raw inputs, transformed in f32 and split into
    // the bf16 terms of the A operand, two columns a thread at a time;
    // only the rows that exist (the others stay zero)
    const int t = threadIdx.x - (kStreamConsumers + 1) * 32;
    for (int i = 0; i < n; ++i) {
      const int st = i % S;
      const int k0 = (kt0 + i % nk) * kTileRows;
      hopper::mbar_wait(&sh.full[st], (i / S) & 1);
      unsigned char* raw = in_s + (size_t)st * L.stage;
      const __nv_bfloat16* nwb = reinterpret_cast<const __nv_bfloat16*>(
          raw + L.halves * L.in_box);
      uint32_t* xs = reinterpret_cast<uint32_t*>(raw + L.raw);
      // all of a thread's tasks unrolled, so that their loads and
      // arithmetic overlap
      constexpr int kTasks =
          (kStreamRows * kTileRows / 2 + kStreamInputWarps * 32 - 1) /
          (kStreamInputWarps * 32);
#pragma unroll
      for (int j = 0; j < kTasks; ++j) {
        const int task = t + j * kStreamInputWarps * 32;
        if (task >= nrows * (kTileRows / 2)) break;
        const int r = task / (kTileRows / 2), kk = task % (kTileRows / 2) * 2;
        const int e = r * kTileRows + kk;
        float v[2];
        if (L.es == 4) {
          const float2 x2 = *reinterpret_cast<const float2*>(raw + 4 * e);
          v[0] = x2.x;
          v[1] = x2.y;
        } else {
          const __nv_bfloat162 x2 =
              *reinterpret_cast<const __nv_bfloat162*>(raw + 2 * e);
          v[0] = __low2float(x2);
          v[1] = __high2float(x2);
        }
        if (a.in_mode == 1) {              // (x - mean) * rstd * w + b
          const float mean = sh.stats[r][0], rstd = sh.stats[r][1];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            v[u] = (v[u] - mean) * rstd * to_float(nwb[kk + u]);
            if (a.nb) v[u] = v[u] + to_float(nwb[kTileRows + kk + u]);
          }
        } else if (a.in_mode == 2 || a.in_mode == 3) {
          const unsigned char* half2 = raw + L.in_box;
          float gt[2];
          if (L.es == 4) {
            const float2 g2 = *reinterpret_cast<const float2*>(half2 + 4 * e);
            gt[0] = g2.x;
            gt[1] = g2.y;
          } else {
            const __nv_bfloat162 g2 =
                *reinterpret_cast<const __nv_bfloat162*>(half2 + 2 * e);
            gt[0] = __low2float(g2);
            gt[1] = __high2float(g2);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
            v[u] = a.in_mode == 2 ? silu_fast(gt[u]) * v[u]  // [up | gate]
                                  : silu_fast(v[u]) * gt[u]; // [gate | up]
        } else if (a.in_mode == 4) {
          v[0] = gelu_tanh(v[0]);
          v[1] = gelu_tanh(v[1]);
        } else if (a.in_mode == 5) {
          v[0] = gelu_erf(v[0]);
          v[1] = gelu_erf(v[1]);
        }
        if (k0 + kk >= a.K) v[0] = 0.f;
        if (k0 + kk + 1 >= a.K) v[1] = 0.f;
        // v = hi + mid + lo, each term bf16 (exact for a finite f32)
        const int o = (r * kSplitPitch + kk) / 2;
#pragma unroll
        for (int s = 0; s < kSplits; ++s) {
          if (s == L.splits) break;
          const __nv_bfloat162 term = __floats2bfloat162_rn(v[0], v[1]);
          xs[s * (L.plane / 4) + o] =
              *reinterpret_cast<const uint32_t*>(&term);
          v[0] -= __low2float(term);
          v[1] -= __high2float(term);
        }
      }
      hopper::mbar_arrive(&sh.ready[st]);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  // warp w owns the strip's columns [16 w, 16 w + 16) as two n8 tiles; a
  // lane holds rows g and g + 8, columns 2 t and 2 t + 1 of each
  const int tid = threadIdx.x, g = lane / 4, t4 = lane % 4;
  // this lane's row address for ldmatrix: matrix lane / 8 (k 0-7 or 8-15
  // of a k16 step, n-tile 0 or 1), its row lane % 8
  const int mcol = 16 * warp + (lane / 16) * 8;
  const int mbox = mcol / 64, mchunk = mcol % 64 / 8;
  const int mk = (lane / 8 % 2) * 8 + lane % 8;
  float acc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  int strip = c, kt = 0;
  for (int i = 0; i < n; ++i) {
    const int st = i % S;
    hopper::mbar_wait(&sh.full[st], (i / S) & 1);
    hopper::mbar_wait(&sh.ready[st], (i / S) & 1);
    const uint32_t wt = hopper::smem_u32(w_s + (size_t)st * kStageBytes) +
                        mbox * kBoxBytes;
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(
        in_s + (size_t)st * L.stage + L.raw);
    // the unit's fragments first (the weights by ldmatrix of the swizzled
    // tile, the input terms by 32-bit loads), so that their latencies
    // overlap; then per k16 step the MMAs into a fresh sum added to the
    // strip's in f32 (round to nearest), so the tensor cores' own
    // accumulation never spans more than one step
    constexpr int J = kTileRows / 16;
    uint32_t b[J][4], af[J][kSplits][4];
#pragma unroll
    for (int kk = 0; kk < J; ++kk) {
      const int k = kk * 16 + mk;    // the 128-byte swizzle: chunk ^ row % 8
      ldmatrix_x4_trans(b[kk], wt + k * 128 + ((mchunk ^ (k & 7)) << 4));
    }
#pragma unroll
    for (int kk = 0; kk < J; ++kk)
#pragma unroll
      for (int s = 0; s < kSplits; ++s) {
        if (s >= L.splits) break;
        const uint32_t* x = xs + s * (L.plane / 4);
        const int w0 = (g * kSplitPitch + kk * 16) / 2 + t4;
        af[kk][s][0] = x[w0];
        af[kk][s][2] = x[w0 + 4];
        af[kk][s][1] = nrows > 8 ? x[w0 + 8 * kSplitPitch / 2] : 0u;
        af[kk][s][3] = nrows > 8 ? x[w0 + 8 * kSplitPitch / 2 + 4] : 0u;
      }
#pragma unroll
    for (int kk = 0; kk < J; ++kk) {
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int s = kSplits - 1; s >= 0; --s) {   // lo, mid, hi
        if (s >= L.splits) continue;
        mma_bf16(part[0], af[kk][s], b[kk][0], b[kk][1]);
        mma_bf16(part[1], af[kk][s], b[kk][2], b[kk][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sh.empty[st]);
    if (++kt < nk) continue;

    // ------------------------------------------ the strip ends in this block
    int seg, c0;
    strip_at(a, strip, seg, c0);
    const int width = seg_width(a, seg);
    const int n0 = (seg == 0 ? 0 : a.seg_end[seg - 1]) + c0;
    if (Gk == 1) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e / 2) * 8;
          const int cl = 16 * warp + 8 * nt + 2 * t4 + e % 2;
          if (r < nrows && c0 + cl < width)
            gemv_store<__nv_bfloat16>(a, r0 + r, n0 + cl, acc[nt][e]);
        }
    } else {
      // the K splits' partials of this strip: slot (y, split, strip)
      const long long slots = (long long)blockIdx.y * Gk;
      float* ws = a.part + ((slots + q) * strips + strip) * kPartSlot;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (g + (e / 2) * 8 < nrows)
            ws[(g + (e / 2) * 8) * kStripCols + 16 * warp + 8 * nt + 2 * t4 +
               e % 2] = acc[nt][e];
      __threadfence();
      hopper::named_sync(kConsumerBar, kStreamConsumers * 32);
      unsigned int* cnt = a.counters + blockIdx.y * strips + strip;
      if (tid == 0) sh.last = atomicAdd(cnt, 1u) == (unsigned int)(Gk - 1);
      hopper::named_sync(kConsumerBar, kStreamConsumers * 32);
      if (sh.last) {
        __threadfence();
        // every split's partial of this lane's elements in flight at once,
        // then each sum in split order
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + (e / 2) * 8;
            const int cl = 16 * warp + 8 * nt + 2 * t4 + e % 2;
            if (r >= nrows) continue;
            const float* slot0 = a.part + (slots * strips + strip) *
                                              kPartSlot + r * kStripCols + cl;
            float part[kMaxSplitK];
#pragma unroll
            for (int qq = 0; qq < kMaxSplitK; ++qq)
              part[qq] = qq < Gk && qq != q
                  ? __ldcg(slot0 + (long long)qq * strips * kPartSlot) : 0.f;
            float sum = 0.f;
#pragma unroll
            for (int qq = 0; qq < kMaxSplitK; ++qq) {
              if (qq == Gk) break;
              const float v = qq == q ? acc[nt][e] : part[qq];
              sum = qq == 0 ? v : sum + v;
            }
            if (c0 + cl < width)
              gemv_store<__nv_bfloat16>(a, r0 + r, n0 + cl, sum);
          }
        if (tid == 0) *cnt = 0u;
      }
      // sh.last is free for the next strip
      hopper::named_sync(kConsumerBar, kStreamConsumers * 32);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    kt = 0;
    strip += Gc;
  }
}

// A 2-D tensor map of a [rows, cols] operand (row stride `ld` elements)
// as (cols, rows), boxes of box_cols x box_rows, with the 128-byte swizzle
// (the weights, read by ldmatrix) or without (the inputs), out-of-range
// elements zero.  A weight
// does not move, and an activation comes back at the same address step
// after step, so each map is encoded once and kept, keyed by what it
// encodes (a reused address with the same layout encodes the same map).
struct MapKey {
  const void* ptr;
  long long cols, rows, ld;
  int type, box_cols, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && cols == o.cols && rows == o.rows && ld == o.ld &&
           type == o.type && box_cols == o.box_cols && box_rows == o.box_rows;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (long long x : {k.cols, k.rows, k.ld, (long long)k.type,
                        (long long)k.box_cols, (long long)k.box_rows})
      h = h * 1000003u ^ std::hash<long long>()(x);
    return h;
  }
};

inline CUresult cached_map(CUtensorMap* map, const void* ptr, bool f32,
                           long long cols, long long rows, long long ld,
                           int box_cols, int box_rows, bool swizzle) {
  const MapKey key{ptr, cols, rows, ld, (f32 ? 1 : 0) + (swizzle ? 2 : 0),
                   box_cols, box_rows};
  return hopper::cached_map<MapKey, MapKeyHash>(
      map, key, [&](CUtensorMap* m) -> CUresult {
    const hopper::EncodeTiled fn = hopper::encoder();
    if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * (f32 ? 4 : 2)};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t ones[2] = {1, 1};
    return fn(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              2, const_cast<void*>(ptr), dims, strides, box, ones,
              CU_TENSOR_MAP_INTERLEAVE_NONE,
              swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  });
}

inline int launch_stream(const GemvArgs& a, cudaStream_t stream) {
  StreamParams p;
  std::memset(&p, 0, sizeof(p));
  p.a = a;
  for (int s = 0; s < 3; ++s) {
    const int width = seg_width(a, s);
    if (width <= 0) continue;
    const CUresult r = cached_map(&p.maps[s], a.w[s], false, width, a.K,
                                  a.ld_w[s], 64, kTileRows, true);
    if (r != CUDA_SUCCESS) return kTmaRefused + (int)r;
  }
  const int halves = (a.in_mode == 2 || a.in_mode == 3) ? 2 : 1;
  const CUresult r = cached_map(&p.x_map, a.in, a.in_f32 != 0,
                                (long long)halves * a.K, a.rows, a.ld_in,
                                kTileRows, stream_layout(a).rows, false);
  if (r != CUDA_SUCCESS) return kTmaRefused + (int)r;
  const size_t smem = stream_smem(a);
  if (smem > kSmemCap) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  static const size_t cap = dynamic_cap(gemv_stream_kernel);
  const cudaError_t attr = hopper::allow_smem(gemv_stream_kernel, cap,
                                              smem_set);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.grid * a.ksplit,
                  (a.rows + kStreamRows - 1) / kStreamRows);
  gemv_stream_kernel<<<grid, dim3(kStreamThreads), smem, stream>>>(p);
  return cudaGetLastError();
}

// validate a GemvArgs block and launch it on `stream`; 0 on success, else
// the cudaError_t (or kTmaRefused + the CUresult of a refused tensor map)
inline int gemv_entry(const GemvArgs& a, void* stream) {
  if (a.rows <= 0 || a.N <= 0) return cudaSuccess;
  if (a.K <= 0 || a.in_mode < 0 || a.in_mode > 5 || a.act < 0 || a.act > 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.dtype) {
    case 0:
      if (a.kc <= 0 || a.ksplit != (a.K + a.kc - 1) / a.kc)
        return cudaErrorInvalidValue;
      return launch_gemv<float>(a, s);
    case 2:
      if (a.stages < 2 || a.stages > kStreamMaxStages || a.grid < 1 ||
          a.grid > stream_strips(a) || a.ksplit < 1 ||
          a.ksplit > kMaxSplitK ||
          a.ksplit > (a.K + kTileRows - 1) / kTileRows)
        return cudaErrorInvalidValue;
      return launch_stream(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
