// Decode attention for Hopper (sm_90a): a short block of fresh queries
// against a KV cache with per-row valid lengths.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/decode_attention.py
// (_kernel :42, launched by decode_attention through pl.pallas_call at
// :135).  Same function: masked online-softmax attention of q [B, sq, H, D]
// over k/v [B, S_max, KVH, D]; key kpos of row b is visible to query t when
// kpos < seq_lens[b] and, with the causal tail, kpos <= seq_len - sq + t.
// Softmax statistics and the accumulator stay in f32, the output is cast
// once, and a query with no visible key yields zeros.  Grouped-query heads
// read kv head h / (H / KVH) directly instead of repeating heads.
//
// What bounds it on an H100: at decode (sq = 1) every cached K/V byte is
// read once for two flops per element, far below the ~295 flop/byte the
// card needs to be compute-bound, so it is bound by the bytes of K and V
// (3.35 TB/s).  Prefill chunks (sq in the hundreds) reuse each K/V row
// across many queries and are bound by operations (989 TFLOP/s bf16 on the
// tensor cores, reached only through wgmma).
//
// Four kernels, by regime.  Each stops its walk at the last row any of its
// queries can see, min(S_max, seq_len, seq_len - sq + last + 1) (the
// causal tail), reads seq_lens on the device (the host never does, so a
// call needs no synchronisation and can be captured in a CUDA graph), and
// shares no state with other blocks except through the split workspace:
//  * sq == 1, bf16/f16 (decode_split_kernel): bytes.  The grid is (batch x
//    kv head x head group, split): each block walks one run of split_rows
//    cache rows (the wrapper's choice, sized from S_max: no host read of
//    the lengths), and blocks whose run starts past the last visible row
//    exit at once, so a short slot costs no more than its rows.  One block
//    serves 4 query heads of a kv head where the group is a multiple of 4
//    (else one), so each K/V byte is read once per 4 heads.  A producer
//    warp keeps a 3-stage ring of 32-row K and V tiles in flight through
//    TMA (128-byte swizzled boxes of the cache's (D, KVH, S_max, B) map,
//    one mbarrier per stage for the copies and one for the four consumer
//    warps' release), while each consumer warp reduces 8 rows a tile from
//    shared memory:
//    each lane holds D/32 columns of q and of the accumulator, dot products
//    close with warp shuffles, the online softmax runs in exp2.  The warps'
//    partials merge in warp order; a block whose split is the only one
//    writes the output, otherwise it writes (m, l, acc[D]) in f32 to the
//    workspace and counts itself done on an integer counter; the block
//    that counts last merges every split's partial in split order (no
//    float atomics: the result does not depend on which block is last) and
//    resets the counter to 0 for the next call.  One launch, deterministic.
//    The walk lives in decode_split.cuh, which the tensor-parallel shard
//    attention (decode_block_tp.cu) runs too, with an append policy.
//  * sq > 1, bf16/f16 (chunk_wgmma_kernel): operations.  The flash
//    forward's shape (flash_attention.cu fwd_wgmma_kernel) for a chunk
//    over a cache: 384 threads own 128 queries of one (batch, head); a
//    producer warp copies Q once and each 128-key K/V tile into a 2-stage
//    ring by TMA (q and the cache read in place through their strides);
//    two consumer warpgroups of 64 rows compute S = Q K^T and O += P V on
//    wgmma (P from registers, rounded to the input type as FlashAttention-2
//    does) and take turns at issuing S.  The query offset seq_len - sq and
//    the walk's end are computed on the device from seq_lens; keys past
//    seq_len, and past the causal tail inside a tile, are masked in
//    registers (TMA zero-fills only past S_max).  Like the reference, a
//    masked key's P of 0 still multiplies its V row, so the cache rows
//    below S_max must hold finite values (the serving pool is zeroed).
//  * f32 (decode_sq1_kernel, decode_tile_kernel): the earlier FMA kernels.
//    sq == 1: eight warps split the block's rows, 8 rows a lane in flight
//    with vector loads, and merge through shared memory; sq > 1: 16-query
//    tiles on plain FMA loops over 32-key shared-memory tiles.
// Still open: the split kernel's dot products close with 5 shuffles a row
// and head; the chunk kernel keeps the flash forward's 2-stage ring and
// one block per SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "decode_split.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------ sq == 1, 16-bit, split
// The walk of decode_split.cuh with no append policy: one block walks one
// run of cache rows for G (1 or 4) query heads of one kv head.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kSplitThreads)
    decode_split_kernel(const __grid_constant__ SplitParams p) {
  split_walk<T, D, G>(p, NoAppend());
}

// ------------------------------------------------- sq > 1, 16-bit, wgmma
// One block owns 128 queries of one (batch, head): 384 threads, three
// warpgroups.  Warpgroup 0 is the producer: its first warp loads Q once
// and walks the key tiles, one lane issuing the TMA copies of each
// [128, D] K and V tile into a ring of kChunkStages stages; the group gives
// up registers.  Warpgroups 1 and 2 are the consumers, 64 query rows each:
// S = Q K^T on wgmma from shared memory, the online softmax in registers,
// O += P V on wgmma with P from registers.  Each stage has a "full"
// barrier for K and one for V (the copies complete them) and an "empty"
// barrier (each consumer warp arrives once it is done with the stage).
constexpr int kChunkBQ = 128;     // queries per block
constexpr int kChunkBK = 128;     // keys per tile
constexpr int kChunkStages = 2;   // K/V ring
constexpr int kChunkThreads = 384;
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kConsumerWarps = 8;
constexpr uint32_t kBox = 128 * 128;  // one box: 128 rows x 128 bytes

struct ChunkParams {
  CUtensorMap q_map;         // (D, H, SQ, B), boxes 64 x 1 x 128 x 1
  CUtensorMap k_map, v_map;  // (D, KVH, S, B), the same boxes
  const int* seq_lens;
  void* out;                 // contiguous [B, SQ, H, D]
  int H, KVH, SQ, S;
  float scale_log2;          // scale * log2(e)
  int causal;
};

struct ChunkShared {
  uint64_t q_full, k_full[kChunkStages], v_full[kChunkStages],
      empty[kChunkStages];
};

// Q and the K/V ring, 1024-byte aligned, then the barriers.  One block an
// SM: ptxas gives the 384 threads 168 registers each at launch.
template <int D>
constexpr size_t chunk_smem() {
  return 1024 + (1 + 2 * kChunkStages) * (D / 64) * kBox +
         sizeof(ChunkShared);
}

// one past the last cache row that the queries up to t_last see: `lim`
// rows hold keys, query t sits at cache row off + t
__device__ __forceinline__ int rows_seen(int lim, int off, int t_last,
                                         int causal) {
  return causal ? max(0, min(lim, off + t_last + 1)) : lim;
}

// 2^x on the special-function unit (2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kChunkThreads, 1)
    chunk_wgmma_kernel(const __grid_constant__ ChunkParams p) {
  constexpr int BQ = kChunkBQ, BK = kChunkBK, S = kChunkStages;
  constexpr uint32_t kTile = (D / 64) * kBox;  // one [128, D] tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + kTile;  // stage st at + st * kTile
  unsigned char* v_s = k_s + S * kTile;
  ChunkShared& sh = *reinterpret_cast<ChunkShared*>(v_s + S * kTile);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // most keys first
  const int seq_len = p.seq_lens[b];
  const int lim = max(0, min(p.S, seq_len));  // cache rows holding keys
  const int off = seq_len - p.SQ;  // query t sits at cache row off + t
  const int kend = rows_seen(lim, off, min(q0 + BQ, p.SQ) - 1, p.causal);
  const int n_tiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sh.q_full, 1);
#pragma unroll
    for (int st = 0; st < S; ++st) {
      hopper::mbar_init(&sh.k_full[st], 1);
      hopper::mbar_init(&sh.v_full[st], 1);
      hopper::mbar_init(&sh.empty[st], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    hopper::prefetch_tensor_map(&p.k_map);
    hopper::prefetch_tensor_map(&p.v_map);
    hopper::mbar_arrive_expect_tx(&sh.q_full, kTile);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      hopper::tma_load_4d(q_s + c * kBox, &p.q_map, &sh.q_full, c * 64, h,
                          q0, b);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S;
      hopper::mbar_wait(&sh.empty[st], ((j / S) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&sh.k_full[st], kTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(k_s + st * kTile + c * kBox, &p.k_map,
                            &sh.k_full[st], c * 64, kvh, j * BK, b);
      hopper::mbar_arrive_expect_tx(&sh.v_full[st], kTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(v_s + st * kTile + c * kBox, &p.v_map,
                            &sh.v_full[st], c * 64, kvh, j * BK, b);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  hopper::regs_inc<kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup, 0 or 1
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int w0 = q0 + cw * 64;  // the group's first query row
  const int t0 = w0 + warp * 16 + g, t1 = t0 + 8;
  // one past the last key the group's rows see
  const int wend =
      w0 < p.SQ ? rows_seen(lim, off, min(w0 + 63, p.SQ - 1), p.causal) : 0;
  const float c = p.scale_log2;

  const uint32_t q_addr = hopper::smem_u32(q_s) + cw * 64 * 128;
  const uint32_t k_addr = hopper::smem_u32(k_s);
  const uint32_t v_addr = hopper::smem_u32(v_s);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // The groups take turns at issuing S = Q K^T (FlashAttention-3's
  // ping-pong): group cw waits at barrier 1 + cw for the other to have
  // issued its own, so one group's softmax runs beside the other's
  // products.  Both groups take a turn at every tile, computed or not;
  // group 0 goes first.
  constexpr int kTurn = 1, kPair = 256;
  if (cw == 1) hopper::named_arrive(kTurn, kPair);
  hopper::mbar_wait(&sh.q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % S;
    const uint32_t ph = (i / S) & 1;
    hopper::mbar_wait(&sh.k_full[st], ph);
    const int k0 = i * BK;
    const bool skip = k0 >= wend;  // no key of the tile is seen by the group
    hopper::named_sync(kTurn + cw, kPair);
    if (skip) hopper::named_arrive(kTurn + 1 - cw, kPair);
    if (!skip) {
      float s[BK / 2];
      const uint32_t kt = k_addr + st * kTile;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, BK>(
            s, hopper::desc_k(q_addr + (kk / 4) * kBox + (kk % 4) * 32),
            hopper::desc_k(kt + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
      hopper::wgmma_commit();
      hopper::named_arrive(kTurn + 1 - cw, kPair);
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);

      // a per-element test only where the tile crosses seq_len (or S_max)
      // or the causal diagonal of the group's rows
      if (k0 + BK > lim || (p.causal && k0 + BK - 1 > w0 + off)) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + 2 * tq + (e & 1);
            const int t = e < 2 ? t0 : t1;
            if (!(key < lim && (!p.causal || key <= t + off)))
              s[4 * n + e] = -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      float m_safe[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        // m and the exponents in log2 units: s * scale * log2(e)
        const float m_next = fmaxf(m[r], mx[r] * c);
        // a row that has seen no key keeps m = -inf: subtract 0 instead
        m_safe[r] = m_next == -INFINITY ? 0.f : m_next;
        alpha[r] = fast_exp2(m[r] - m_safe[r]);
        l[r] *= alpha[r];
        m[r] = m_next;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fast_exp2(fmaf(s[4 * n + e], c, -m_safe[e >> 1]));
          s[4 * n + e] = x;
          l[e >> 1] += x;
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      // P's A fragment for keys 16 kk .. 16 kk + 15: S column groups 2 kk
      // and 2 kk + 1
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_floats<T>(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_floats<T>(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_floats<T>(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_floats<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
      hopper::mbar_wait(&sh.v_full[st], ph);
      const uint32_t vt = v_addr + st * kTile;
      hopper::fence_operand(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_rs<T, D>(o, pa[kk],
                               hopper::desc_mn(vt + kk * 16 * 128, kBox), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(o);
    } else {
      // the stage is released only once its copies have landed
      hopper::mbar_wait(&sh.v_full[st], ph);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sh.empty[st]);
  }
  if (cw == 0) hopper::named_sync(kTurn, kPair);  // group 1's last turn

  T* op = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int t = r == 0 ? t0 : t1;
    if (t < p.SQ) {
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      T* dst = op + (((long long)b * p.SQ + t) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * tq) =
            pack_floats<T>(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

// ------------------------------------------------------------- launches
template <int D>
cudaError_t launch_f32_d(const Params& p, cudaStream_t stream) {
  if (p.SQ == 1) {
    decode_sq1_kernel<float, D>
        <<<dim3(p.B * p.H), dim3(kDecodeWarps * 32), 0, stream>>>(p);
  } else {
    const dim3 grid(p.B * p.H, (p.SQ + kTileQ - 1) / kTileQ);
    decode_tile_kernel<float, D><<<grid, dim3(kThreads), 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, int D, int G>
cudaError_t launch_split(const SplitParams& sp, int rows, cudaStream_t s) {
  auto kernel = decode_split_kernel<T, D, G>;
  constexpr size_t smem = split_smem<G, D>();
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t attr = hopper::allow_smem(kernel, smem, smem_set);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(rows, sp.n_splits), dim3(kSplitThreads), smem, s>>>(sp);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_chunk(const ChunkParams& cp, int B, cudaStream_t s) {
  auto kernel = chunk_wgmma_kernel<T, D>;
  constexpr size_t smem = chunk_smem<D>();
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t attr = hopper::allow_smem(kernel, smem, smem_set);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * cp.H, (cp.SQ + kChunkBQ - 1) / kChunkBQ);
  kernel<<<grid, dim3(kChunkThreads), smem, s>>>(cp);
  return cudaGetLastError();
}

// query heads a split block serves: all 4 of a group of 4 (or 8), else 1
template <typename T, int D>
cudaError_t launch_split_g(const SplitParams& sp, int B, cudaStream_t s) {
  const int rep = sp.H / sp.KVH;
  return rep % 4 == 0 ? launch_split<T, D, 4>(sp, B * sp.KVH * rep / 4, s)
                      : launch_split<T, D, 1>(sp, B * sp.KVH * rep, s);
}

// 2000 + the CUresult of a tensor map cuTensorMapEncodeTiled refuses (the
// wrapper names TMA in its error)
constexpr int kTmaRefused = 2000;

template <typename T>
int run16(CUtensorMapDataType type, const void* q, const void* k,
          const void* v, const int* seq_lens, void* out, float* part,
          int* count, int B, int SQ, int H, int KVH, int S, int D,
          long long q_sb, long long q_ss, long long q_sh, long long k_sb,
          long long k_ss, long long k_sh, long long v_sb, long long v_ss,
          long long v_sh, float scale, int causal, int split_rows,
          cudaStream_t s) {
  const int rows = SQ == 1 ? kSplitTile : kChunkBK;
  CUtensorMap k_map, v_map;
  // with an empty cache nothing is loaded: q's map stands in for k's and v's
  CUresult r =
      S > 0 ? hopper::operand_map(&k_map, type, k, D, KVH, S, B, k_sh, k_ss,
                                  k_sb, rows)
            : hopper::operand_map(&k_map, type, q, D, H, SQ, B, q_sh, q_ss,
                                  q_sb, rows);
  if (r == CUDA_SUCCESS)
    r = S > 0 ? hopper::operand_map(&v_map, type, v, D, KVH, S, B, v_sh,
                                    v_ss, v_sb, rows)
              : hopper::operand_map(&v_map, type, q, D, H, SQ, B, q_sh, q_ss,
                                    q_sb, rows);
  if (SQ == 1) {
    if (r != CUDA_SUCCESS) return kTmaRefused + (int)r;
    if (split_rows <= 0 || split_rows % kSplitTile ||
        part == nullptr || count == nullptr)
      return cudaErrorInvalidValue;
    SplitParams sp = {};
    sp.k_map = k_map;
    sp.v_map = v_map;
    sp.q = q;
    sp.seq_lens = seq_lens;
    sp.out = out;
    sp.part = part;
    sp.count = count;
    sp.q_sb = q_sb;
    sp.q_sh = q_sh;
    sp.H = H;
    sp.KVH = KVH;
    sp.S = S;
    sp.split_rows = split_rows;
    sp.n_splits = max(1, (S + split_rows - 1) / split_rows);
    sp.scale_log2 = scale * 1.4426950408889634f;
    return D == 64 ? launch_split_g<T, 64>(sp, B, s)
                   : launch_split_g<T, 128>(sp, B, s);
  }
  ChunkParams cp = {};
  if (r == CUDA_SUCCESS)
    r = hopper::operand_map(&cp.q_map, type, q, D, H, SQ, B, q_sh, q_ss, q_sb,
                            kChunkBQ);
  if (r != CUDA_SUCCESS) return kTmaRefused + (int)r;
  cp.k_map = k_map;
  cp.v_map = v_map;
  cp.seq_lens = seq_lens;
  cp.out = out;
  cp.H = H;
  cp.KVH = KVH;
  cp.SQ = SQ;
  cp.S = S;
  cp.scale_log2 = scale * 1.4426950408889634f;
  cp.causal = causal;
  return D == 64 ? launch_chunk<T, 64>(cp, B, s)
                 : launch_chunk<T, 128>(cp, B, s);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  part / count: the 16-bit
// sq == 1 kernel's workspace, f32 [B * H * ceil(S_max / split_rows) *
// (2 + head_dim)] and int32 [B * H] zeros (the kernel leaves them 0), or
// null for the other kernels.  Returns the cudaError_t of the launch (0 on
// success), or 2000 + the CUresult of a tensor map cuTensorMapEncodeTiled
// refuses; the Python wrapper raises on anything else.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* seq_lens,
    void* out, float* part, int* count, int dtype, int batch, int sq,
    int heads, int kv_heads, int s_max, int head_dim, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, int split_rows, void* stream) {
  if (batch <= 0 || sq <= 0 || heads <= 0) return cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0) return cudaErrorInvalidValue;
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const Params p{q,    k,    v,    seq_lens, out,  batch, sq,   heads,
                     kv_heads, s_max, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                     v_sb, v_ss, v_sh, scale, causal};
      return head_dim == 64 ? launch_f32_d<64>(p, s)
                            : launch_f32_d<128>(p, s);
    }
    case 1:
      return run16<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v,
                           seq_lens, out, part, count, batch, sq, heads,
                           kv_heads, s_max, head_dim, q_sb, q_ss, q_sh, k_sb,
                           k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                           split_rows, s);
    case 2:
      return run16<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v,
                                  seq_lens, out, part, count, batch, sq,
                                  heads, kv_heads, s_max, head_dim, q_sb,
                                  q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                  v_sh, scale, causal, split_rows, s);
    default: return cudaErrorInvalidValue;
  }
}
