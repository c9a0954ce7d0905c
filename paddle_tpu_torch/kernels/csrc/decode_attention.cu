// Decode attention for Hopper (sm_90a): a short block of fresh queries
// against a KV cache with per-row valid lengths.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/decode_attention.py
// (_kernel, launched by decode_attention through pl.pallas_call).  Same
// function: masked online-softmax attention of q [B, sq, H, D] over
// k/v [B, S_max, KVH, D]; key kpos of row b is visible to query t when
// kpos < seq_lens[b] and, with the causal tail, kpos <= seq_len - sq + t.
// Softmax statistics and the accumulator stay in f32, the output is cast
// once, and a query with no visible key yields zeros.
//
// What bounds it on an H100: at decode (sq = 1) every cached K/V byte is
// read once for two flops per element, far below the ~295 flop/byte the
// card needs to be compute-bound, so it is bound by the bytes of K and V
// (3.35 TB/s).  Long prefill chunks (sq in the hundreds) reuse each K/V
// row across many queries and become bound by operations.
//
// What the design does about that — three kernels, each with a grid over
// (batch * head [, query tile]) and the KV walk as a loop inside the block,
// so blocks share no state (the TPU grid's sequential scratch carry does
// not exist here), and each stopping the walk at the last row any of its
// queries can see, min(S_max, seq_len, seq_len - sq + last + 1):
//  * sq == 1 (decode_sq1_kernel): bytes.  Eight warps split the block's
//    KV rows; each lane holds D/32 elements of q and of the accumulator,
//    reads its slice of 8 K rows and 8 V rows with vector loads before
//    using any (many bytes in flight per SM, rows read exactly once, no
//    shared-memory staging), reduces each dot product across the warp
//    with shuffles and keeps its own online softmax; the eight partial
//    softmaxes merge once through shared memory at the end.
//  * sq > 1, bf16/f16 (decode_mma_kernel): operations, on the tensor
//    cores.  A block owns 64 queries (16 per warp); 64-row K/V tiles are
//    staged once in shared memory (16-byte loads, padded rows for
//    conflict-free fragment reads) and reused by all 64 queries; S = Q K^T
//    and O += P V run as mma.sync m16n8k16 with f32 accumulation, with Q,
//    S, P and O held in registers (P is rounded to the input type for
//    the second product, as FlashAttention-2 does).
//  * sq > 1, f32 (decode_tile_kernel): the same walk on plain FMA loops
//    over 16-query tiles, each shared-memory read feeding several FMAs.
//  * GQA reads KV head h / (H / KVH) directly instead of repeating heads.
// Later work: wgmma and TMA loads (Hopper's asynchronous tensor-core path)
// and a split of long KV walks across blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

// N consecutive elements read with one vector load (the wrapper checks
// that rows are 16-byte aligned; N * sizeof(T) is at most 16)
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* ptr) {
  return *reinterpret_cast<const Vec<T, N>*>(ptr);
}

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> zero_vec() {
  Vec<T, N> x;
#pragma unroll
  for (int e = 0; e < N; ++e) x.v[e] = from_float<T>(0.f);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seq_lens;
  void* out;  // contiguous [B, SQ, H, D]
  int B, SQ, H, KVH, S;
  long long q_sb, q_ss, q_sh;  // element strides; the D stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

// one past the last cache row any query in [q_first, q_last] may see
__device__ __forceinline__ long long visible_end(const Params& p,
                                                 int seq_len, int q_last) {
  long long end = min((long long)p.S, (long long)seq_len);
  if (p.causal) end = min(end, (long long)seq_len - p.SQ + q_last + 1);
  return end;
}

// ------------------------------------------------------------------ sq == 1
constexpr int kDecodeWarps = 8;
constexpr int kDecodeRows = 8;  // K and V rows each lane has in flight

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_sq1_kernel(const Params p) {
  constexpr int E = D / 32;  // elements of a row per lane
  __shared__ float m_w[kDecodeWarps], l_w[kDecodeWarps];
  __shared__ float acc_w[kDecodeWarps][D];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const long long kv_end = visible_end(p, p.seq_lens[b], 0);

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh +
                lane * E;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh +
                lane * E;

  float q[E], acc[E];
  {
    const Vec<T, E> qv = load_vec<T, E>(qp + lane * E);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      q[e] = to_float(qv.v[e]) * p.scale;
      acc[e] = 0.f;
    }
  }
  float m = -INFINITY, l = 0.f;

  for (long long r0 = (long long)warp * kDecodeRows; r0 < kv_end;
       r0 += kDecodeWarps * kDecodeRows) {
    Vec<T, E> kr[kDecodeRows], vr[kDecodeRows];
#pragma unroll
    for (int j = 0; j < kDecodeRows; ++j) {
      const long long row = r0 + j;
      if (row < kv_end) {
        kr[j] = load_vec<T, E>(kp + row * p.k_ss);
        vr[j] = load_vec<T, E>(vp + row * p.v_ss);
      } else {
        kr[j] = zero_vec<T, E>();
        vr[j] = zero_vec<T, E>();
      }
    }
    float s[kDecodeRows];
#pragma unroll
    for (int j = 0; j < kDecodeRows; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(q[e], to_float(kr[j].v[e]), dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      s[j] = r0 + j < kv_end ? dot : -INFINITY;
    }
    float mx = s[0];
#pragma unroll
    for (int j = 1; j < kDecodeRows; ++j) mx = fmaxf(mx, s[j]);
    const float m_next = fmaxf(m, mx);
    const float m_safe = m_next == -INFINITY ? 0.f : m_next;
    const float alpha = expf(m - m_safe);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kDecodeRows; ++j) {
      const float pr = expf(s[j] - m_safe);
      l += pr;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = fmaf(pr, to_float(vr[j].v[e]), acc[e]);
    }
    m = m_next;
  }

  // merge the warps' partial softmaxes
  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) acc_w[warp][lane * E + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) m_all = fmaxf(m_all, m_w[w]);
    const float m_safe = m_all == -INFINITY ? 0.f : m_all;
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float f = expf(m_w[w] - m_safe);
      l_all = fmaf(l_w[w], f, l_all);
      a_all = fmaf(acc_w[w][d], f, a_all);
    }
    T* op = static_cast<T*>(p.out);
    op[((long long)b * p.H + h) * D + d] =
        from_float<T>(a_all / (l_all == 0.f ? 1.f : l_all));
  }
}

// ------------------------------------------------------------------- sq > 1
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 32;    // keys per shared-memory tile (one per lane)
constexpr int kTileQ = 16;     // queries per block

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_tile_kernel(const Params p) {
  constexpr int QT = kTileQ;
  constexpr int QPW = QT / kWarps;        // queries per warp (4)
  constexpr int DPL = D / 32;             // P V columns per lane
  constexpr int VE = 16 / sizeof(T);      // elements per 16-byte load
  __shared__ float q_s[QT][D];
  __shared__ float k_s[kBlockK][D + 1];   // +1: conflict-free row reads
  __shared__ float v_s[kBlockK][D];
  __shared__ float p_s[QT][kBlockK];
  __shared__ float m_s[QT], l_s[QT], alpha_s[QT];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.y * QT;
  const int seq_len = p.seq_lens[b];
  const long long kv_end = visible_end(p, seq_len, min(q0 + QT, p.SQ) - 1);

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < QT * D; i += kThreads) {
    const int qi = i / D, d = i % D, t = q0 + qi;
    q_s[qi][d] = t < p.SQ ? to_float(qp[t * p.q_ss + d]) * p.scale : 0.f;
  }
  for (int i = tid; i < QT; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  // this thread's queries are warp + kWarps * i, its columns lane + 32 * e
  float acc[QPW][DPL];
#pragma unroll
  for (int i = 0; i < QPW; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  __syncthreads();

  for (long long k0 = 0; k0 < kv_end; k0 += kBlockK) {
    for (int i = tid; i < kBlockK * (D / VE); i += kThreads) {
      const int r = i / (D / VE), c = (i % (D / VE)) * VE;
      const long long row = k0 + r;
      Vec<T, VE> kx = zero_vec<T, VE>(), vx = zero_vec<T, VE>();
      if (row < kv_end) {
        kx = load_vec<T, VE>(kp + row * p.k_ss + c);
        vx = load_vec<T, VE>(vp + row * p.v_ss + c);
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        k_s[r][c + e] = to_float(kx.v[e]);
        v_s[r][c + e] = to_float(vx.v[e]);
      }
    }
    __syncthreads();

    // scores: lane = key, 4 queries per thread
    {
      float dot[QPW];
#pragma unroll
      for (int i = 0; i < QPW; ++i) dot[i] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kx = k_s[lane][d];
#pragma unroll
        for (int i = 0; i < QPW; ++i)
          dot[i] = fmaf(q_s[warp + kWarps * i][d], kx, dot[i]);
      }
      const long long row = k0 + lane;
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const int qi = warp + kWarps * i, t = q0 + qi;
        const bool valid =
            t < p.SQ && row < kv_end && row < seq_len &&
            (!p.causal || row <= (long long)seq_len - p.SQ + t);
        p_s[qi][lane] = valid ? dot[i] : -INFINITY;
      }
    }
    __syncthreads();

    // online-softmax update: one warp per query row, one key per lane
    for (int qi = warp; qi < QT; qi += kWarps) {
      const float s = p_s[qi][lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = m_s[qi];
      const float m_next = fmaxf(m_prev, mx);
      const float m_safe = m_next == -INFINITY ? 0.f : m_next;
      const float pr = expf(s - m_safe);
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      p_s[qi][lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_safe);
        l_s[qi] = alpha * l_s[qi] + sum;
        m_s[qi] = m_next;
        alpha_s[qi] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const float alpha = alpha_s[warp + kWarps * i];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
    }
#pragma unroll 4
    for (int r = 0; r < kBlockK; ++r) {
      float vx[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vx[e] = v_s[r][lane + 32 * e];
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float pr = p_s[warp + kWarps * i][r];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pr, vx[e], acc[i][e]);
      }
    }
    __syncthreads();
  }

  T* op = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int qi = warp + kWarps * i, t = q0 + qi;
    if (t < p.SQ) {
      const float l = l_s[qi];
      const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        op[(((long long)b * p.SQ + t) * p.H + h) * D + lane + 32 * e] =
            from_float<T>(acc[i][e] * inv);
    }
  }
}

// ---------------------------------------------- sq > 1, 16-bit, tensor cores
// mma.sync m16n8k16 with f32 accumulation.  A warp owns 16 queries: its Q
// fragments stay in registers, S = Q K^T lands in registers, the online
// softmax runs on those registers (row max/sum across the 4 lanes of a
// quad), and P (rounded to the input type) feeds the P V product straight
// from the S accumulators — the FlashAttention-2 register layout.
constexpr int kMmaWarps = 4;
constexpr int kMmaQ = 16 * kMmaWarps;  // queries per block
constexpr int kMmaK = 64;              // keys per shared-memory tile
constexpr int kMmaPad = 8;             // row pad: conflict-free fragments

template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type make(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type make(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  typename Pair<T>::type v = Pair<T>::make(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_elems(T lo, T hi) {
  typename Pair<T>::type v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
decode_mma_kernel(const Params p) {
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NS = kMmaK / 8;    // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;        // n-tiles of O (8 columns each)
  constexpr int VE = 8;            // 16-bit elements per 16-byte load
  constexpr int LD = D + kMmaPad;  // shared-memory row length
  __shared__ __align__(16) T k_s[kMmaK][LD];
  __shared__ __align__(16) T v_s[kMmaK][LD];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;  // mma group / lane in group
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.y * kMmaQ;
  const int seq_len = p.seq_lens[b];
  const long long kv_end = visible_end(p, seq_len,
                                       min(q0 + kMmaQ, p.SQ) - 1);

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // this lane's query rows: r0 = g and r1 = g + 8 of the warp's 16
  const int t0 = q0 + warp * 16 + g, t1 = t0 + 8;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * tq;
    qa[kk][0] = t0 < p.SQ ? *reinterpret_cast<const uint32_t*>(
                                qp + t0 * p.q_ss + c) : 0u;
    qa[kk][1] = t1 < p.SQ ? *reinterpret_cast<const uint32_t*>(
                                qp + t1 * p.q_ss + c) : 0u;
    qa[kk][2] = t0 < p.SQ ? *reinterpret_cast<const uint32_t*>(
                                qp + t0 * p.q_ss + c + 8) : 0u;
    qa[kk][3] = t1 < p.SQ ? *reinterpret_cast<const uint32_t*>(
                                qp + t1 * p.q_ss + c + 8) : 0u;
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (long long k0 = 0; k0 < kv_end; k0 += kMmaK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kMmaK * (D / VE); i += kMmaWarps * 32) {
      const int r = i / (D / VE), c = (i % (D / VE)) * VE;
      const long long row = k0 + r;
      Vec<T, VE> kx = zero_vec<T, VE>(), vx = zero_vec<T, VE>();
      if (row < kv_end) {
        kx = load_vec<T, VE>(kp + row * p.k_ss + c);
        vx = load_vec<T, VE>(vp + row * p.v_ss + c);
      }
      *reinterpret_cast<Vec<T, VE>*>(&k_s[r][c]) = kx;
      *reinterpret_cast<Vec<T, VE>*>(&v_s[r][c]) = vx;
    }
    __syncthreads();

    // S = Q K^T for 16 queries x 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const T* kr = &k_s[n * 8 + g][kk * 16 + 2 * tq];
        mma16816<T>(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // scale, mask, and the online-softmax update of rows g and g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long key = k0 + n * 8 + 2 * tq + (c & 1);
        const int t = c < 2 ? t0 : t1;
        const bool valid =
            t < p.SQ && key < kv_end && key < seq_len &&
            (!p.causal || key <= (long long)seq_len - p.SQ + t);
        s[n][c] = valid ? s[n][c] * p.scale : -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_next = fmaxf(m[r], mx[r]);
      m_safe[r] = m_next == -INFINITY ? 0.f : m_next;
      alpha[r] = expf(m[r] - m_safe[r]);
      l[r] *= alpha[r];
      m[r] = m_next;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = expf(s[n][c] - m_safe[c >> 1]);
        l[c >> 1] += s[n][c];
      }
    // O += P V; P's A fragments are S n-tiles 2j and 2j + 1
#pragma unroll
    for (int j = 0; j < kMmaK / 16; ++j) {
      const uint32_t pa[4] = {
          pack_floats<T>(s[2 * j][0], s[2 * j][1]),
          pack_floats<T>(s[2 * j][2], s[2 * j][3]),
          pack_floats<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_floats<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int kr = j * 16 + 2 * tq;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int d = n * 8 + g;
        mma16816<T>(o[n], pa, pack_elems<T>(v_s[kr][d], v_s[kr + 1][d]),
                    pack_elems<T>(v_s[kr + 8][d], v_s[kr + 9][d]));
      }
    }
  }

  T* op = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int t = r == 0 ? t0 : t1;
    if (t < p.SQ) {
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      T* row = op + (((long long)b * p.SQ + t) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tq) =
            pack_floats<T>(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.SQ == 1) {
    decode_sq1_kernel<T, D>
        <<<dim3(p.B * p.H), dim3(kDecodeWarps * 32), 0, stream>>>(p);
  } else if constexpr (sizeof(T) == 2) {
    const dim3 grid(p.B * p.H, (p.SQ + kMmaQ - 1) / kMmaQ);
    decode_mma_kernel<T, D><<<grid, dim3(kMmaWarps * 32), 0, stream>>>(p);
  } else {
    const dim3 grid(p.B * p.H, (p.SQ + kTileQ - 1) / kTileQ);
    decode_tile_kernel<T, D><<<grid, dim3(kThreads), 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_d<T, 64>(p, stream);
    case 128: return launch_d<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  Returns the cudaError_t of the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* seq_lens,
    void* out, int dtype, int batch, int sq, int heads, int kv_heads,
    int s_max, int head_dim, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, void* stream) {
  if (batch <= 0 || sq <= 0 || heads <= 0) return cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0) return cudaErrorInvalidValue;
  Params p{q,    k,    v,    seq_lens, out,  batch, sq,    heads,
           kv_heads, s_max, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<float>(p, head_dim, s);
    case 1: return launch_t<__half>(p, head_dim, s);
    case 2: return launch_t<__nv_bfloat16>(p, head_dim, s);
    default: return cudaErrorInvalidValue;
  }
}
