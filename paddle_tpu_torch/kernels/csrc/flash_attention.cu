// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/flash_attention.py,
// with and without segment ids (seg=True, reached through _flash_core_seg):
//   * _fwd_kernel (:77, launched at :170)     -> flash_attention_fwd
//   * _bwd_dq_kernel (:199, launched at :345) -> flash_attention_bwd_dq
//   * _bwd_dkv_kernel (:248, launched at :373) -> flash_attention_bwd_dkv
// Same functions: f32 scores, softmax and accumulation, one final cast;
// the bottom-right causal mask kpos <= qpos + (Sk - Sq); with segment ids a
// query sees only keys of its own segment (:108-110, :231, :281), on top of
// the causal mask; a query row that sees no key gives out = 0 and
// lse = -inf, and the backward takes lse_safe = 0 for it, so its dq and the
// dk / dv of a key no query sees come out exactly 0.  delta = rowsum(dO *
// out) comes from the caller, as in the reference (:311).
//
// Layouts: q/k/v/dO are read in place through their (batch, seq, head)
// element strides, so views of a fused [b, s, 3, H, D] QKV projection need
// no copy; the D stride is 1.  out/dq are contiguous [B, Sq, H, D], dk/dv
// contiguous [B, Sk, KVH, D], lse/delta [B, H, Sq] f32, segment ids
// contiguous [B, Sq] / [B, Sk] int32 (the reference repeats them over the
// heads; every head reads the same row here).  Grouped-query heads read kv
// head h / (H / KVH); the dk/dv block of a kv head sums over the query heads
// of its group in a loop, so no atomics are needed and every result is
// deterministic.
//
// What bounds it on an H100: at the train shape ([2, 2048, 32, 128] bf16,
// causal) each kernel does ~70-140 GFLOP of matrix products over ~50 MB of
// operands, far above the ~295 flop/byte the card needs to be
// compute-bound: operations bound them (989 TFLOP/s bf16 on the tensor
// cores, reached only through wgmma).  With segment ids the work is the
// visible pairs only, so the kernels skip every tile whose q-id range
// [min, max] and k-id range do not overlap (disjoint ranges hold no equal
// pair, for any ids, monotone or not; a skipped tile would have added p = 0
// with alpha = 1, so the result is bit-identical).  The segment variant is
// a template flag, and its fields sit at the end of the kernel parameters:
// the code without it is the same.  The sequential grid axis of the TPU
// kernels (the carried m/l/acc scratch) becomes a loop inside one block;
// blocks share nothing.  Causal query tiles are issued longest first.
//
// The 16-bit forward (fwd_wgmma_kernel) is built for Hopper (hopper.cuh):
// a block of 384 threads owns 128 queries; a producer warp issues TMA
// copies of Q once and of each 128-key K/V tile into a 2-stage ring of
// 128-byte-swizzled shared memory, tracked by mbarriers, while two
// consumer warpgroups (64 rows each, registers moved to them with
// setmaxnreg) compute S = Q K^T and O += P V with wgmma (P from
// registers), the online softmax in f32 registers with exp2 and log2(e)
// folded into the scale, and a per-element mask only on tiles that cross
// the causal diagonal, the Sk edge or a segment boundary.  With segment
// ids the producer reads each tile's ids, with no block barrier, and
// loads only the tiles whose range meets a consumer group's, handing the
// ids over in the stage; a group computes only the tiles its own rows can
// see.  One block an SM (160 KB of shared memory at D = 128).
//
// The backward and the float32 kernels use the earlier design: the
// products on the tensor cores through mma.sync m16n8k16 (f32
// accumulation, the FlashAttention-2 register layout: a warp owns 16 rows,
// its score tile lives in registers and is re-packed in place as the A
// operand of the next product), K/V (or Q/dO) tiles staged through
// registers into padded shared memory, 4 warps a block:
//   * dq: a block owns 64 queries and walks 32-key tiles; p = exp(s - lse)
//     is recomputed, ds = p (dO V^T - delta), dq += ds K.
//   * dkv: a block owns 64 keys of one (batch, kv head) and walks 32-query
//     tiles from the first query that sees them, over every query head of
//     its group: dv += p^T dO, dk += ds^T Q, with s^T = K Q^T computed
//     transposed so both sums accumulate in registers.
// With segment ids one warp stages each tile's ids a tile ahead and the
// block reads their ranges after a barrier.  P and dS are rounded to the
// input type for their second product, as FlashAttention-2 does.  float32
// inputs take plain FMA tiles (16 queries or 32 keys per block).
// Later work: the backward on wgmma and TMA (hopper.cuh's building blocks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // 16-bit row pad: conflict-free fragment reads

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
__device__ __forceinline__ uint32_t u32(const T* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
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

// 2^x on the special-function unit (2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, SQ] (backward input)
  const float* delta;  // [B, H, SQ]
  void* out;           // [B, SQ, H, D]
  float* lse_out;      // [B, H, SQ]
  void* dq;            // [B, SQ, H, D]
  void* dk;            // [B, SK, KVH, D]
  void* dv;
  int B, H, KVH, SQ, SK;
  long long q_sb, q_ss, q_sh;  // element strides; the D stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  float scale;
  int causal;
  const int* q_seg;  // [B, SQ] int32, or null: no segment ids
  const int* k_seg;  // [B, SK] int32
};

// one past the last key any query in [0, t_last] sees
__device__ __forceinline__ int key_end(const Params& p, int t_last) {
  if (!p.causal) return p.SK;
  return max(0, min(p.SK, t_last + (p.SK - p.SQ) + 1));
}

// the first query that sees key `key`
__device__ __forceinline__ int query_begin(const Params& p, int key) {
  if (!p.causal) return 0;
  return max(0, key - (p.SK - p.SQ));
}

// query t sees key `key`; with segment ids qs and ks are their ids
template <bool Seg>
__device__ __forceinline__ bool visible(const Params& p, int t, int key,
                                        int qs, int ks) {
  return t < p.SQ && key < p.SK &&
         (!p.causal || key <= t + (p.SK - p.SQ)) && (!Seg || qs == ks);
}

// The segment ids of one tile of N rows, held by warp 0 (N / 32 a lane):
// load() issues the reads of rows [r0, r0 + N) below `limit`, put()
// writes them to shared memory (0 past the limit: those rows are never
// visible) with their [min, max].  A walk loads the next tile's ids right
// after putting this one's, so their latency hides behind this tile's
// work.  The caller synchronises before reading what put() wrote.
template <int N>
struct IdTile {
  static constexpr int kPer = (N + 31) / 32;
  int x[kPer];
  int rows;  // rows below the limit

  __device__ __forceinline__ void load(const int* ids, int r0, int limit) {
    rows = max(0, min(N, limit - r0));
    if (threadIdx.x >= 32) return;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + 32 * e;
      x[e] = i < rows ? ids[r0 + i] : 0;
    }
  }

  __device__ __forceinline__ void put(int* dst, int* rng) const {
    if (threadIdx.x >= 32) return;
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + 32 * e;
      if (i < N) dst[i] = x[e];
      if (i < rows) {
        lo = min(lo, x[e]);
        hi = max(hi, x[e]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, off));
      hi = max(hi, __shfl_xor_sync(kFull, hi, off));
    }
    if (threadIdx.x == 0) {
      rng[0] = lo;
      rng[1] = hi;
    }
  }
};

// warp 0 stages the ids of a block's own rows [r0, r0 + N) at once
template <int N>
__device__ __forceinline__ void stage_ids(int* dst, int* rng, const int* ids,
                                          int r0, int limit) {
  IdTile<N> t;
  t.load(ids, r0, limit);
  t.put(dst, rng);
}

// two id ranges [alo, ahi], [blo, bhi] hold no equal pair
__device__ __forceinline__ bool apart(int alo, int ahi, int blo, int bhi) {
  return ahi < blo || bhi < alo;
}
__device__ __forceinline__ bool disjoint(const int* a, const int* b) {
  return apart(a[0], a[1], b[0], b[1]);
}

__device__ __forceinline__ long long row_stat(const Params& p, int b, int h,
                                              int t) {
  return ((long long)b * p.H + h) * p.SQ + t;
}

// stage `rows` rows of a [.., D] operand starting at row r0 into shared
// memory rows of length LD (16-byte loads; rows >= limit are zero)
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(T (*dst)[LD], const T* base,
                                           long long row_stride, int r0,
                                           int rows, int limit) {
  constexpr int VE = 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * (D / VE); i += kThreads) {
    const int r = i / (D / VE), c = (i % (D / VE)) * VE;
    const int row = r0 + r;
    Vec<T, VE> x = zero_vec<T, VE>();
    if (row < limit) x = load_vec<T, VE>(base + row * row_stride + c);
    *reinterpret_cast<Vec<T, VE>*>(&dst[r][c]) = x;
  }
}

// ------------------------------------------------- forward, Hopper wgmma
// One block owns 128 queries of one (batch, head): 384 threads, three
// warpgroups.  Warpgroup 0 is the producer: its first warp loads Q once
// and walks the key tiles, one elected lane issuing the TMA copies of each
// [128, D] K and V tile into a ring of kFwdStages stages; the group gives
// up registers.  Warpgroups 1 and 2 are the consumers, 64 query rows each:
// S = Q K^T on wgmma from shared memory, the online softmax in registers,
// O += P V on wgmma with P from registers.  Each stage has a "full"
// barrier for K and one for V (the copies complete them) and an "empty"
// barrier (each consumer warp arrives once it is done with the stage).
constexpr int kFwdBQ = 128;      // queries per block
constexpr int kFwdBK = 128;      // keys per tile
constexpr int kFwdStages = 2;    // K/V ring
constexpr int kFwdThreads = 384;
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kConsumerWarps = 8;
constexpr uint32_t kBox = 128 * 128;  // one box: 128 rows x 128 bytes

// The forward's kernel parameters (the backward's Params are unchanged).
struct FwdParams {
  CUtensorMap q_map, k_map, v_map;  // (D, heads, S, B), boxes 64 x 1 x 128 x 1
  void* out;                        // [B, SQ, H, D]
  float* lse;                       // [B, H, SQ]
  const int* q_seg;                 // [B, SQ] int32 (Seg only)
  const int* k_seg;                 // [B, SK] int32
  int B, H, KVH, SQ, SK;
  float scale_log2;                 // scale * log2(e)
  int causal;
};

// the block's barriers and, with segment ids, what the producer hands the
// consumers: each stage's key tile (-1: the walk ended), its id range and,
// where the tile is not one segment with the block's queries, its ids
template <int S>
struct FwdShared {
  uint64_t q_full, k_full[S], v_full[S], empty[S];
  int tile[S], klo[S], khi[S];
  int qlo[2], qhi[2];  // each consumer warpgroup's query-id range
  int qid[kFwdBQ];
  int kid[S][kFwdBK];
};

// Q and the K/V ring, 1024-byte aligned, then the barriers.  One block
// an SM: ptxas gives the 384 threads 168 registers each at launch.
template <int D>
constexpr size_t fwd_smem() {
  return 1024 + (1 + 2 * kFwdStages) * (D / 64) * kBox +
         sizeof(FwdShared<kFwdStages>);
}

template <typename T, int D, bool Seg>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ FwdParams p) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK, S = kFwdStages;
  constexpr uint32_t kTile = (D / 64) * kBox;  // one [128, D] tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + kTile;  // stage st at + st * kTile
  unsigned char* v_s = k_s + S * kTile;
  FwdShared<S>& sh = *reinterpret_cast<FwdShared<S>*>(v_s + S * kTile);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int off = p.SK - p.SQ;
  const int q_last = min(q0 + BQ, p.SQ) - 1;
  const int kend = p.causal ? max(0, min(p.SK, q_last + off + 1)) : p.SK;
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
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int qlo = 0, qhi = 0;  // the block's query-id range
    int wlo[2] = {0, 0}, whi[2] = {0, 0};
    if constexpr (Seg) {
      // lane l holds rows l + 32 e: e 0-1 are warpgroup 1's, 2-3 group 2's
      const int* qseg = p.q_seg + (long long)b * p.SQ;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
        for (int e = 2 * w; e < 2 * w + 2; ++e) {
          const int t = q0 + lane + 32 * e;
          const int id = t < p.SQ ? qseg[t] : INT_MIN;
          sh.qid[lane + 32 * e] = id;
          if (t < p.SQ) {
            lo = min(lo, id);
            hi = max(hi, id);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo = min(lo, __shfl_xor_sync(kFull, lo, o));
          hi = max(hi, __shfl_xor_sync(kFull, hi, o));
        }
        wlo[w] = lo;
        whi[w] = hi;
      }
      qlo = min(wlo[0], wlo[1]);
      qhi = max(whi[0], whi[1]);
      if (lane == 0) {
        sh.qlo[0] = wlo[0];
        sh.qhi[0] = whi[0];
        sh.qlo[1] = wlo[1];
        sh.qhi[1] = whi[1];
      }
      __syncwarp();
    }
    if (lane == 0) {
      hopper::prefetch_tensor_map(&p.k_map);
      hopper::prefetch_tensor_map(&p.v_map);
      hopper::mbar_arrive_expect_tx(&sh.q_full, kTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(q_s + c * kBox, &p.q_map, &sh.q_full, c * 64, h,
                            q0, b);
    }
    // the copies of key tile j into stage `issued % S`
    int issued = 0;
    auto load_kv = [&](int j) {
      const int st = issued % S;
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          if (c == 0) hopper::mbar_arrive_expect_tx(&sh.k_full[st], kTile);
          hopper::tma_load_4d(k_s + st * kTile + c * kBox, &p.k_map,
                              &sh.k_full[st], c * 64, kvh, j * BK, b);
        }
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          if (c == 0) hopper::mbar_arrive_expect_tx(&sh.v_full[st], kTile);
          hopper::tma_load_4d(v_s + st * kTile + c * kBox, &p.v_map,
                              &sh.v_full[st], c * 64, kvh, j * BK, b);
        }
      }
      ++issued;
    };
    if constexpr (!Seg) {
      for (int j = 0; j < n_tiles; ++j) {
        if (lane == 0)
          hopper::mbar_wait(&sh.empty[issued % S], ((issued / S) & 1) ^ 1);
        load_kv(j);
      }
    } else {
      // Each tile's key ids [min, max] over the keys below kend, 8 tiles
      // a pass (their 32 loads in flight together); a tile is loaded only
      // where its range meets a consumer group's query range.
      const int* kseg = p.k_seg + (long long)b * p.SK;
      for (int j0 = 0; j0 < n_tiles; j0 += 8) {
        int lo[8], hi[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          lo[u] = INT_MAX;
          hi[u] = INT_MIN;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = (j0 + u) * BK + lane + 32 * e;
            if (key < kend) {
              const int id = kseg[key];
              lo[u] = min(lo[u], id);
              hi[u] = max(hi[u], id);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            lo[u] = min(lo[u], __shfl_xor_sync(kFull, lo[u], o));
            hi[u] = max(hi[u], __shfl_xor_sync(kFull, hi[u], o));
          }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u;
          if (j >= n_tiles || (apart(lo[u], hi[u], wlo[0], whi[0]) &&
                               apart(lo[u], hi[u], wlo[1], whi[1])))
            continue;
          const int st = issued % S;
          hopper::mbar_wait(&sh.empty[st], ((issued / S) & 1) ^ 1);
          if (!(lo[u] == hi[u] && qlo == qhi && lo[u] == qlo)) {
            // not one segment with the block's queries: hand over the ids
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = j * BK + lane + 32 * e;
              sh.kid[st][lane + 32 * e] = key < kend ? kseg[key] : INT_MIN;
            }
          }
          if (lane == 0) {
            sh.tile[st] = j;
            sh.klo[st] = lo[u];
            sh.khi[st] = hi[u];
          }
          __syncwarp();
          load_kv(j);
        }
      }
      // the end of the walk: a stage with no copy and tile -1
      const int st = issued % S;
      hopper::mbar_wait(&sh.empty[st], ((issued / S) & 1) ^ 1);
      if (lane == 0) {
        sh.tile[st] = -1;
        hopper::mbar_arrive(&sh.k_full[st]);
      }
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
  // products.  Both groups take a turn at every tile they visit, computed
  // or not; group 0 goes first.
  constexpr int kTurn = 1, kPair = 256;
  if (cw == 1) hopper::named_arrive(kTurn, kPair);
  hopper::mbar_wait(&sh.q_full, 0);
  int qs0 = 0, qs1 = 0, wqlo = 0, wqhi = 0;
  if constexpr (Seg) {
    qs0 = sh.qid[t0 - q0];
    qs1 = sh.qid[t1 - q0];
    wqlo = sh.qlo[cw];
    wqhi = sh.qhi[cw];
  }

  for (int i = 0;; ++i) {
    const int st = i % S;
    const uint32_t ph = (i / S) & 1;
    int j = i, klo = 0, khi = 0;
    if constexpr (Seg) {
      hopper::mbar_wait(&sh.k_full[st], ph);
      j = sh.tile[st];
      if (j < 0) break;
      klo = sh.klo[st];
      khi = sh.khi[st];
    } else {
      if (i >= n_tiles) break;
      hopper::mbar_wait(&sh.k_full[st], ph);
    }
    const int k0 = j * BK;
    // nothing of this tile is visible to the group's rows
    const bool skip = w0 >= p.SQ || (p.causal && k0 > w0 + 63 + off) ||
                      (Seg && apart(klo, khi, wqlo, wqhi));
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

      // a per-element test only where the tile crosses the causal
      // diagonal of the group's rows, the Sk edge or a segment boundary
      const bool uniform = !Seg || (klo == khi && wqlo == wqhi && klo == wqlo);
      if (k0 + BK > p.SK || (p.causal && k0 + BK - 1 > w0 + off) ||
          !uniform) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = n * 8 + 2 * tq + (e & 1), key = k0 + kc;
            const int t = e < 2 ? t0 : t1;
            bool vis = key < p.SK && (!p.causal || key <= t + off);
            if constexpr (Seg)
              vis = vis && (uniform || sh.kid[st][kc] == (e < 2 ? qs0 : qs1));
            if (!vis) s[4 * n + e] = -INFINITY;
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
      T* row = op + (((long long)b * p.SQ + t) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tq) =
            pack_floats<T>(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      if (tq == 0)
        p.lse[((long long)b * p.H + h) * p.SQ + t] =
            l[r] == 0.f ? -INFINITY
                        : m[r] * 0.69314718055994531f + logf(l[r]);
    }
  }
}

// ------------------------------------------------------ dq, tensor cores
template <typename T, int D, bool Seg>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(const Params p) {
  constexpr int BQ = 16 * kWarps, BK = 32;
  constexpr int KS = D / 16, NS = BK / 8, NO = D / 8, LD = D + kPad;
  __shared__ __align__(16) T k_s[BK][LD];
  __shared__ __align__(16) T v_s[BK][LD];
  __shared__ int qid_s[Seg ? BQ : 1], kid_s[Seg ? BK : 1], rng_s[4];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kend = key_end(p, min(q0 + BQ, p.SQ) - 1);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  const int t0 = q0 + warp * 16 + g, t1 = t0 + 8;
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * tq;
    qa[kk][0] = t0 < p.SQ ? u32(qp + t0 * p.q_ss + c) : 0u;
    qa[kk][1] = t1 < p.SQ ? u32(qp + t1 * p.q_ss + c) : 0u;
    qa[kk][2] = t0 < p.SQ ? u32(qp + t0 * p.q_ss + c + 8) : 0u;
    qa[kk][3] = t1 < p.SQ ? u32(qp + t1 * p.q_ss + c + 8) : 0u;
    da[kk][0] = t0 < p.SQ ? u32(dop + t0 * p.do_ss + c) : 0u;
    da[kk][1] = t1 < p.SQ ? u32(dop + t1 * p.do_ss + c) : 0u;
    da[kk][2] = t0 < p.SQ ? u32(dop + t0 * p.do_ss + c + 8) : 0u;
    da[kk][3] = t1 < p.SQ ? u32(dop + t1 * p.do_ss + c + 8) : 0u;
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r == 0 ? t0 : t1;
    lse_r[r] = dl_r[r] = 0.f;
    if (t < p.SQ) {
      const float x = p.lse[row_stat(p, b, h, t)];
      lse_r[r] = x == -INFINITY ? 0.f : x;  // lse_safe
      dl_r[r] = p.delta[row_stat(p, b, h, t)];
    }
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  int qs0 = 0, qs1 = 0;
  if constexpr (Seg) {
    stage_ids<BQ>(qid_s, rng_s, p.q_seg + (long long)b * p.SQ, q0, p.SQ);
    __syncthreads();
    qs0 = qid_s[warp * 16 + g];
    qs1 = qid_s[warp * 16 + g + 8];
  }

  const int* kseg = Seg ? p.k_seg + (long long)b * p.SK : nullptr;
  IdTile<Seg ? BK : 1> kids;
  if constexpr (Seg) kids.load(kseg, 0, kend);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    if constexpr (Seg) {
      kids.put(kid_s, rng_s + 2);
      kids.load(kseg, k0 + BK, kend);
      __syncthreads();
      if (disjoint(rng_s, rng_s + 2)) continue;
    }
    stage_rows<T, D, LD>(k_s, kp, p.k_ss, k0, BK, kend);
    stage_rows<T, D, LD>(v_s, vp, p.v_ss, k0, BK, kend);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for 16 queries x 32 keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const T* kr = &k_s[n * 8 + g][kk * 16 + 2 * tq];
        const T* vr = &v_s[n * 8 + g][kk * 16 + 2 * tq];
        mma16816<T>(s[n], qa[kk], u32(kr), u32(kr + 8));
        mma16816<T>(dp[n], da[kk], u32(vr), u32(vr + 8));
      }
    }
    // dS = P (dP - delta), P = exp(s * scale - lse)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + n * 8 + 2 * tq + (c & 1), r = c >> 1;
        const int ks = Seg ? kid_s[key - k0] : 0;
        const float pr =
            visible<Seg>(p, r == 0 ? t0 : t1, key, r == 0 ? qs0 : qs1, ks)
                ? expf(s[n][c] * p.scale - lse_r[r])
                : 0.f;
        s[n][c] = pr * (dp[n][c] - dl_r[r]);
      }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {
          pack_floats<T>(s[2 * j][0], s[2 * j][1]),
          pack_floats<T>(s[2 * j][2], s[2 * j][3]),
          pack_floats<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_floats<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int kr = j * 16 + 2 * tq;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int d = n * 8 + g;
        mma16816<T>(acc[n], pa, pack_elems<T>(k_s[kr][d], k_s[kr + 1][d]),
                    pack_elems<T>(k_s[kr + 8][d], k_s[kr + 9][d]));
      }
    }
  }

  T* dqp = static_cast<T*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r == 0 ? t0 : t1;
    if (t < p.SQ) {
      T* row = dqp + (((long long)b * p.SQ + t) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tq) = pack_floats<T>(
            acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
    }
  }
}

// ----------------------------------------------------- dkv, tensor cores
constexpr int kDkvKeys = 16 * kWarps;  // keys per block
constexpr int kDkvQ = 32;              // queries per tile

template <typename T, int D>
constexpr size_t dkv_mma_smem() {
  return (size_t)(2 * kDkvKeys + 2 * kDkvQ) * (D + kPad) * sizeof(T) +
         2 * kDkvQ * sizeof(float);
}

template <typename T, int D, bool Seg>
__global__ void __launch_bounds__(kThreads) dkv_mma_kernel(const Params p) {
  constexpr int BKEY = kDkvKeys, BQ = kDkvQ;
  constexpr int KS = D / 16, NQ = BQ / 8, NO = D / 8, LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T(*k_s)[LD] = reinterpret_cast<T(*)[LD]>(smem);
  T(*v_s)[LD] = k_s + BKEY;
  T(*q_s)[LD] = v_s + BKEY;
  T(*do_s)[LD] = q_s + BQ;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ);
  float* dl_s = lse_s + BQ;
  // segment ids of the block's keys and the tile's queries; k, q ranges
  __shared__ int kid_s[Seg ? BKEY : 1], qid_s[Seg ? BQ : 1], rng_s[4];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / p.KVH, kvh = blockIdx.x % p.KVH;
  const int rep = p.H / p.KVH;
  const int k0 = blockIdx.y * BKEY;  // early keys (most queries) first
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  stage_rows<T, D, LD>(k_s, kp, p.k_ss, k0, BKEY, p.SK);
  stage_rows<T, D, LD>(v_s, vp, p.v_ss, k0, BKEY, p.SK);

  // this lane's key rows: w = warp * 16 + g and w + 8
  const int w = warp * 16 + g;
  const int key0 = k0 + w, key1 = key0 + 8;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;
  const int qb = query_begin(p, k0) / BQ * BQ;
  int ks0 = 0, ks1 = 0;
  if constexpr (Seg) {
    stage_ids<BKEY>(kid_s, rng_s, p.k_seg + (long long)b * p.SK, k0, p.SK);
    __syncthreads();
    ks0 = kid_s[w];
    ks1 = kid_s[w + 8];
  }

  const int* qseg = Seg ? p.q_seg + (long long)b * p.SQ : nullptr;
  IdTile<Seg ? BQ : 1> qids;
  if constexpr (Seg) qids.load(qseg, qb, p.SQ);

  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = qb; q0 < p.SQ; q0 += BQ) {
      __syncthreads();  // the previous tile is consumed (K/V are staged)
      if constexpr (Seg) {
        // the next tile: the following one, or the first of the next head
        qids.put(qid_s, rng_s + 2);
        qids.load(qseg, q0 + BQ < p.SQ ? q0 + BQ : qb, p.SQ);
        __syncthreads();
        if (disjoint(rng_s, rng_s + 2)) continue;
      }
      stage_rows<T, D, LD>(q_s, qp, p.q_ss, q0, BQ, p.SQ);
      stage_rows<T, D, LD>(do_s, dop, p.do_ss, q0, BQ, p.SQ);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const int t = q0 + i;
        float x = 0.f, dl = 0.f;
        if (t < p.SQ) {
          x = p.lse[row_stat(p, b, h, t)];
          x = x == -INFINITY ? 0.f : x;
          dl = p.delta[row_stat(p, b, h, t)];
        }
        lse_s[i] = x;
        dl_s[i] = dl;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 queries
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const T* kr = &k_s[w][kk * 16 + 2 * tq];
        const T* vr = &v_s[w][kk * 16 + 2 * tq];
        const uint32_t ka[4] = {u32(kr), u32(kr + 8 * LD), u32(kr + 8),
                                u32(kr + 8 * LD + 8)};
        const uint32_t va[4] = {u32(vr), u32(vr + 8 * LD), u32(vr + 8),
                                u32(vr + 8 * LD + 8)};
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const T* qr = &q_s[n * 8 + g][kk * 16 + 2 * tq];
          const T* dr = &do_s[n * 8 + g][kk * 16 + 2 * tq];
          mma16816<T>(st[n], ka, u32(qr), u32(qr + 8));
          mma16816<T>(dpt[n], va, u32(dr), u32(dr + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = n * 8 + 2 * tq + (c & 1);
          const int qs = Seg ? qid_s[qi] : 0;
          const float pt = visible<Seg>(p, q0 + qi, c < 2 ? key0 : key1, qs,
                                        c < 2 ? ks0 : ks1)
                               ? expf(st[n][c] * p.scale - lse_s[qi])
                               : 0.f;
          dpt[n][c] = pt * (dpt[n][c] - dl_s[qi]);
          st[n][c] = pt;
        }
      // dV += P^T dO and dK += dS^T Q (k = the tile's queries)
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        const uint32_t pa[4] = {
            pack_floats<T>(st[2 * j][0], st[2 * j][1]),
            pack_floats<T>(st[2 * j][2], st[2 * j][3]),
            pack_floats<T>(st[2 * j + 1][0], st[2 * j + 1][1]),
            pack_floats<T>(st[2 * j + 1][2], st[2 * j + 1][3])};
        const uint32_t sa[4] = {
            pack_floats<T>(dpt[2 * j][0], dpt[2 * j][1]),
            pack_floats<T>(dpt[2 * j][2], dpt[2 * j][3]),
            pack_floats<T>(dpt[2 * j + 1][0], dpt[2 * j + 1][1]),
            pack_floats<T>(dpt[2 * j + 1][2], dpt[2 * j + 1][3])};
        const int qr = j * 16 + 2 * tq;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int d = n * 8 + g;
          mma16816<T>(dv[n], pa,
                      pack_elems<T>(do_s[qr][d], do_s[qr + 1][d]),
                      pack_elems<T>(do_s[qr + 8][d], do_s[qr + 9][d]));
          mma16816<T>(dk[n], sa, pack_elems<T>(q_s[qr][d], q_s[qr + 1][d]),
                      pack_elems<T>(q_s[qr + 8][d], q_s[qr + 9][d]));
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key0 : key1;
    if (key < p.SK) {
      const long long off = (((long long)b * p.SK + key) * p.KVH + kvh) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(dkp + off + c) = pack_floats<T>(
            dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvp + off + c) =
            pack_floats<T>(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// --------------------------------------------------- float32, FMA tiles
constexpr int kFQ = 16;  // queries per tile
constexpr int kFK = 32;  // keys per tile (one per lane)

template <int D>
__device__ __forceinline__ void stage_f32(float* dst, int ld,
                                          const float* base,
                                          long long row_stride, int r0,
                                          int rows, int limit) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const int row = r0 + r;
    Vec<float, 4> x = zero_vec<float, 4>();
    if (row < limit) x = load_vec<float, 4>(base + row * row_stride + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * ld + c + e] = x.v[e];
  }
}

template <int D>
constexpr size_t fwd_f32_smem() {
  return sizeof(float) * (kFQ * D + kFK * (D + 1) + kFK * D + kFQ * kFK +
                          3 * kFQ);
}

template <int D, bool Seg>
__global__ void __launch_bounds__(kThreads) fwd_f32_kernel(const Params p) {
  constexpr int QPW = kFQ / kWarps, DPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int qid_s[Seg ? kFQ : 1], kid_s[Seg ? kFK : 1], rng_s[4];
  float* q_s = reinterpret_cast<float*>(smem);  // [kFQ][D], scaled
  float* k_s = q_s + kFQ * D;                   // [kFK][D + 1]
  float* v_s = k_s + kFK * (D + 1);             // [kFK][D]
  float* p_s = v_s + kFK * D;                   // [kFQ][kFK]
  float* m_s = p_s + kFQ * kFK;
  float* l_s = m_s + kFQ;
  float* alpha_s = l_s + kFQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFQ;
  const int kend = key_end(p, min(q0 + kFQ, p.SQ) - 1);
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vp =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  stage_f32<D>(q_s, D, qp, p.q_ss, q0, kFQ, p.SQ);
  for (int i = tid; i < kFQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  if constexpr (Seg)
    stage_ids<kFQ>(qid_s, rng_s, p.q_seg + (long long)b * p.SQ, q0, p.SQ);
  __syncthreads();
  // the reference scales q before the product (flash_attention.py:97)
  for (int i = tid; i < kFQ * D; i += kThreads) q_s[i] *= p.scale;
  float acc[QPW][DPL];
#pragma unroll
  for (int i = 0; i < QPW; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;

  const int* kseg = Seg ? p.k_seg + (long long)b * p.SK : nullptr;
  IdTile<Seg ? kFK : 1> kids;
  if constexpr (Seg) kids.load(kseg, 0, kend);

  for (int k0 = 0; k0 < kend; k0 += kFK) {
    __syncthreads();
    if constexpr (Seg) {
      kids.put(kid_s, rng_s + 2);
      kids.load(kseg, k0 + kFK, kend);
      __syncthreads();
      if (disjoint(rng_s, rng_s + 2)) continue;
    }
    stage_f32<D>(k_s, D + 1, kp, p.k_ss, k0, kFK, kend);
    stage_f32<D>(v_s, D, vp, p.v_ss, k0, kFK, kend);
    __syncthreads();
    {
      float dot[QPW];
#pragma unroll
      for (int i = 0; i < QPW; ++i) dot[i] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kx = k_s[lane * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < QPW; ++i)
          dot[i] = fmaf(q_s[(warp + kWarps * i) * D + d], kx, dot[i]);
      }
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const int qi = warp + kWarps * i;
        p_s[qi * kFK + lane] =
            visible<Seg>(p, q0 + qi, k0 + lane, Seg ? qid_s[qi] : 0,
                         Seg ? kid_s[lane] : 0)
                ? dot[i]
                : -INFINITY;
      }
    }
    __syncthreads();
    for (int qi = warp; qi < kFQ; qi += kWarps) {
      const float s = p_s[qi * kFK + lane];
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
      p_s[qi * kFK + lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_safe);
        l_s[qi] = alpha * l_s[qi] + sum;
        m_s[qi] = m_next;
        alpha_s[qi] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const float alpha = alpha_s[warp + kWarps * i];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
    }
#pragma unroll 4
    for (int r = 0; r < kFK; ++r) {
      float vx[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vx[e] = v_s[r * D + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float pr = p_s[(warp + kWarps * i) * kFK + r];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pr, vx[e], acc[i][e]);
      }
    }
  }
  __syncthreads();

  float* op = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int qi = warp + kWarps * i, t = q0 + qi;
    if (t < p.SQ) {
      const float l = l_s[qi];
      const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        op[(((long long)b * p.SQ + t) * p.H + h) * D + lane + 32 * e] =
            acc[i][e] * inv;
      if (lane == 0)
        p.lse_out[row_stat(p, b, h, t)] =
            l == 0.f ? -INFINITY : m_s[qi] + logf(l);
    }
  }
}

template <int D>
constexpr size_t dq_f32_smem() {
  return sizeof(float) *
         (2 * kFQ * D + 2 * kFK * (D + 1) + kFQ * kFK + 2 * kFQ);
}

template <int D, bool Seg>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(const Params p) {
  constexpr int QPW = kFQ / kWarps, DPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int qid_s[Seg ? kFQ : 1], kid_s[Seg ? kFK : 1], rng_s[4];
  float* q_s = reinterpret_cast<float*>(smem);  // [kFQ][D]
  float* do_s = q_s + kFQ * D;                  // [kFQ][D]
  float* k_s = do_s + kFQ * D;                  // [kFK][D + 1]
  float* v_s = k_s + kFK * (D + 1);             // [kFK][D + 1]
  float* ds_s = v_s + kFK * (D + 1);            // [kFQ][kFK]
  float* lse_s = ds_s + kFQ * kFK;
  float* dl_s = lse_s + kFQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFQ;
  const int kend = key_end(p, min(q0 + kFQ, p.SQ) - 1);
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dop =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kp =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vp =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  stage_f32<D>(q_s, D, qp, p.q_ss, q0, kFQ, p.SQ);
  stage_f32<D>(do_s, D, dop, p.do_ss, q0, kFQ, p.SQ);
  for (int i = tid; i < kFQ; i += kThreads) {
    const int t = q0 + i;
    float x = 0.f, dl = 0.f;
    if (t < p.SQ) {
      x = p.lse[row_stat(p, b, h, t)];
      x = x == -INFINITY ? 0.f : x;
      dl = p.delta[row_stat(p, b, h, t)];
    }
    lse_s[i] = x;
    dl_s[i] = dl;
  }
  if constexpr (Seg)
    stage_ids<kFQ>(qid_s, rng_s, p.q_seg + (long long)b * p.SQ, q0, p.SQ);
  float acc[QPW][DPL];
#pragma unroll
  for (int i = 0; i < QPW; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;

  const int* kseg = Seg ? p.k_seg + (long long)b * p.SK : nullptr;
  IdTile<Seg ? kFK : 1> kids;
  if constexpr (Seg) kids.load(kseg, 0, kend);

  for (int k0 = 0; k0 < kend; k0 += kFK) {
    __syncthreads();
    if constexpr (Seg) {
      kids.put(kid_s, rng_s + 2);
      kids.load(kseg, k0 + kFK, kend);
      __syncthreads();
      if (disjoint(rng_s, rng_s + 2)) continue;
    }
    stage_f32<D>(k_s, D + 1, kp, p.k_ss, k0, kFK, kend);
    stage_f32<D>(v_s, D + 1, vp, p.v_ss, k0, kFK, kend);
    __syncthreads();
    {
      float ds[QPW], dp[QPW];
#pragma unroll
      for (int i = 0; i < QPW; ++i) ds[i] = dp[i] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kx = k_s[lane * (D + 1) + d];
        const float vx = v_s[lane * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < QPW; ++i) {
          const int qi = warp + kWarps * i;
          ds[i] = fmaf(q_s[qi * D + d], kx, ds[i]);
          dp[i] = fmaf(do_s[qi * D + d], vx, dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const int qi = warp + kWarps * i;
        const float pr = visible<Seg>(p, q0 + qi, k0 + lane,
                                      Seg ? qid_s[qi] : 0,
                                      Seg ? kid_s[lane] : 0)
                             ? expf(ds[i] * p.scale - lse_s[qi])
                             : 0.f;
        ds_s[qi * kFK + lane] = pr * (dp[i] - dl_s[qi]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kFK; ++r) {
      float kx[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) kx[e] = k_s[r * (D + 1) + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float dsr = ds_s[(warp + kWarps * i) * kFK + r];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(dsr, kx[e], acc[i][e]);
      }
    }
  }

  float* dqp = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int t = q0 + warp + kWarps * i;
    if (t < p.SQ) {
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        dqp[(((long long)b * p.SQ + t) * p.H + h) * D + lane + 32 * e] =
            acc[i][e] * p.scale;
    }
  }
}

template <int D>
constexpr size_t dkv_f32_smem() {
  return sizeof(float) *
         (2 * kFK * (D + 1) + 2 * kFQ * D + 2 * kFQ * kFK + 2 * kFQ);
}

template <int D, bool Seg>
__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(const Params p) {
  constexpr int QPW = kFQ / kWarps, KPW = kFK / kWarps, DPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int kid_s[Seg ? kFK : 1], qid_s[Seg ? kFQ : 1], rng_s[4];
  float* k_s = reinterpret_cast<float*>(smem);  // [kFK][D + 1]
  float* v_s = k_s + kFK * (D + 1);             // [kFK][D + 1]
  float* q_s = v_s + kFK * (D + 1);             // [kFQ][D]
  float* do_s = q_s + kFQ * D;                  // [kFQ][D]
  float* p_s = do_s + kFQ * D;                  // [kFQ][kFK]
  float* ds_s = p_s + kFQ * kFK;                // [kFQ][kFK]
  float* lse_s = ds_s + kFQ * kFK;
  float* dl_s = lse_s + kFQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.KVH, kvh = blockIdx.x % p.KVH;
  const int rep = p.H / p.KVH;
  const int k0 = blockIdx.y * kFK;
  const float* kp =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vp =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  stage_f32<D>(k_s, D + 1, kp, p.k_ss, k0, kFK, p.SK);
  stage_f32<D>(v_s, D + 1, vp, p.v_ss, k0, kFK, p.SK);

  // accumulators: keys warp + kWarps * i, columns lane + 32 * e
  float dk[KPW][DPL], dv[KPW][DPL];
#pragma unroll
  for (int i = 0; i < KPW; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int qb = query_begin(p, k0) / kFQ * kFQ;
  if constexpr (Seg)
    stage_ids<kFK>(kid_s, rng_s, p.k_seg + (long long)b * p.SK, k0, p.SK);

  const int* qseg = Seg ? p.q_seg + (long long)b * p.SQ : nullptr;
  IdTile<Seg ? kFQ : 1> qids;
  if constexpr (Seg) qids.load(qseg, qb, p.SQ);

  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const float* qp =
        static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dop =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = qb; q0 < p.SQ; q0 += kFQ) {
      __syncthreads();
      if constexpr (Seg) {
        qids.put(qid_s, rng_s + 2);
        qids.load(qseg, q0 + kFQ < p.SQ ? q0 + kFQ : qb, p.SQ);
        __syncthreads();
        if (disjoint(rng_s, rng_s + 2)) continue;
      }
      stage_f32<D>(q_s, D, qp, p.q_ss, q0, kFQ, p.SQ);
      stage_f32<D>(do_s, D, dop, p.do_ss, q0, kFQ, p.SQ);
      for (int i = tid; i < kFQ; i += kThreads) {
        const int t = q0 + i;
        float x = 0.f, dl = 0.f;
        if (t < p.SQ) {
          x = p.lse[row_stat(p, b, h, t)];
          x = x == -INFINITY ? 0.f : x;
          dl = p.delta[row_stat(p, b, h, t)];
        }
        lse_s[i] = x;
        dl_s[i] = dl;
      }
      __syncthreads();
      {
        float s[QPW], dp[QPW];
#pragma unroll
        for (int i = 0; i < QPW; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float kx = k_s[lane * (D + 1) + d];
          const float vx = v_s[lane * (D + 1) + d];
#pragma unroll
          for (int i = 0; i < QPW; ++i) {
            const int qi = warp + kWarps * i;
            s[i] = fmaf(q_s[qi * D + d], kx, s[i]);
            dp[i] = fmaf(do_s[qi * D + d], vx, dp[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < QPW; ++i) {
          const int qi = warp + kWarps * i;
          const float pt = visible<Seg>(p, q0 + qi, k0 + lane,
                                        Seg ? qid_s[qi] : 0,
                                        Seg ? kid_s[lane] : 0)
                               ? expf(s[i] * p.scale - lse_s[qi])
                               : 0.f;
          p_s[qi * kFK + lane] = pt;
          ds_s[qi * kFK + lane] = pt * (dp[i] - dl_s[qi]);
        }
      }
      __syncthreads();
      for (int qi = 0; qi < kFQ; ++qi) {
        float qx[DPL], dx[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          qx[e] = q_s[qi * D + lane + 32 * e];
          dx[e] = do_s[qi * D + lane + 32 * e];
        }
#pragma unroll
        for (int i = 0; i < KPW; ++i) {
          const int kj = warp + kWarps * i;
          const float pt = p_s[qi * kFK + kj], dst = ds_s[qi * kFK + kj];
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            dv[i][e] = fmaf(pt, dx[e], dv[i][e]);
            dk[i][e] = fmaf(dst, qx[e], dk[i][e]);
          }
        }
      }
    }
  }

  float* dkp = static_cast<float*>(p.dk);
  float* dvp = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    const int key = k0 + warp + kWarps * i;
    if (key < p.SK) {
      const long long off = (((long long)b * p.SK + key) * p.KVH + kvh) * D;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        dkp[off + lane + 32 * e] = dk[i][e] * p.scale;
        dvp[off + lane + 32 * e] = dv[i][e];
      }
    }
  }
}

// ------------------------------------------------------------- launches
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                   const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, dim3(kThreads), smem, s>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv };

template <typename T, int D, bool Seg>
cudaError_t launch_d(Which which, const Params& p, cudaStream_t s) {
  const dim3 by_q(p.B * p.H, (p.SQ + 16 * kWarps - 1) / (16 * kWarps));
  if constexpr (sizeof(T) == 2) {
    switch (which) {
      case kFwd: break;  // fwd_wgmma_kernel: run_fwd16
      case kDq: return launch(dq_mma_kernel<T, D, Seg>, by_q, 0, s, p);
      case kDkv:
        return launch(dkv_mma_kernel<T, D, Seg>,
                      dim3(p.B * p.KVH, (p.SK + kDkvKeys - 1) / kDkvKeys),
                      dkv_mma_smem<T, D>(), s, p);
    }
  } else {
    const dim3 by_fq(p.B * p.H, (p.SQ + kFQ - 1) / kFQ);
    switch (which) {
      case kFwd:
        return launch(fwd_f32_kernel<D, Seg>, by_fq, fwd_f32_smem<D>(), s,
                      p);
      case kDq:
        return launch(dq_f32_kernel<D, Seg>, by_fq, dq_f32_smem<D>(), s, p);
      case kDkv:
        return launch(dkv_f32_kernel<D, Seg>,
                      dim3(p.B * p.KVH, (p.SK + kFK - 1) / kFK),
                      dkv_f32_smem<D>(), s, p);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool Seg>
cudaError_t launch_t(Which which, const Params& p, int head_dim,
                     cudaStream_t s) {
  switch (head_dim) {
    case 64: return launch_d<T, 64, Seg>(which, p, s);
    case 128: return launch_d<T, 128, Seg>(which, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool Seg>
cudaError_t launch_seg(Which which, const Params& p, int dtype, int head_dim,
                       cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_t<float, Seg>(which, p, head_dim, s);
    case 1: return launch_t<__half, Seg>(which, p, head_dim, s);
    case 2: return launch_t<__nv_bfloat16, Seg>(which, p, head_dim, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, Params& p, int dtype, int head_dim, void* stream) {
  if (p.B <= 0 || p.H <= 0) return cudaSuccess;
  if (p.KVH <= 0 || p.H % p.KVH != 0) return cudaErrorInvalidValue;
  if ((p.q_seg == nullptr) != (p.k_seg == nullptr))
    return cudaErrorInvalidValue;
  if (which == kDkv ? p.SK <= 0 : p.SQ <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.q_seg ? launch_seg<true>(which, p, dtype, head_dim, s)
                 : launch_seg<false>(which, p, dtype, head_dim, s);
}

Params make_params(const void* q, const void* k, const void* v,
                   const int* q_seg, const int* k_seg, int B, int SQ, int SK,
                   int H, int KVH, long long q_sb, long long q_ss,
                   long long q_sh, long long k_sb, long long k_ss,
                   long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, float scale, int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_seg = q_seg;
  p.k_seg = k_seg;
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.SQ = SQ;
  p.SK = SK;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  p.causal = causal;
  return p;
}

// ------------------------------------------------- forward launches (16-bit)
// 2000 + the CUresult of a tensor map the driver refuses (the wrapper names
// TMA in its error)
constexpr int kTmaRefused = 2000;

template <typename T, int D, bool Seg>
cudaError_t launch_fwd(const FwdParams& fp, cudaStream_t s) {
  auto kernel = fwd_wgmma_kernel<T, D, Seg>;
  constexpr size_t smem = fwd_smem<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(fp.B * fp.H, (fp.SQ + kFwdBQ - 1) / kFwdBQ);
  kernel<<<grid, dim3(kFwdThreads), smem, s>>>(fp);
  return cudaGetLastError();
}

template <typename T, bool Seg>
cudaError_t launch_fwd_t(const FwdParams& fp, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 64: return launch_fwd<T, 64, Seg>(fp, s);
    case 128: return launch_fwd<T, 128, Seg>(fp, s);
    default: return cudaErrorInvalidValue;
  }
}

// The map of one [B, S, heads, D] operand as (D, heads, S, B), element
// strides (sh, ss, sb); boxes of 64 columns x 1 head x 128 rows x 1 batch.
// A dim of size one is never stepped over: it gets the packed stride.
CUresult operand_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, int d, int heads, int seq, int batch,
                     long long sh, long long ss, long long sb) {
  const long long es = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)(sh * es), (cuuint64_t)(ss * es),
                           (cuuint64_t)(sb * es)};
  if (heads == 1) strides[0] = d * es;
  if (seq == 1) strides[1] = strides[0] * heads;
  if (batch == 1) strides[2] = strides[1] * seq;
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kFwdBQ, 1};
  return hopper::encode_tensor_map(map, type, 4, base, dims, strides, box);
}

int run_fwd16(const void* q, const void* k, const void* v, void* out,
              float* lse, const int* q_seg, const int* k_seg, int dtype,
              int B, int SQ, int SK, int H, int KVH, int D, long long q_sb,
              long long q_ss, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              float scale, int causal, cudaStream_t s) {
  if (B <= 0 || H <= 0 || SQ <= 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0 || (q_seg == nullptr) != (k_seg == nullptr))
    return cudaErrorInvalidValue;
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  static_assert(kFwdBK == kFwdBQ, "one box shape serves q, k and v");
  FwdParams fp = {};
  const CUtensorMapDataType type = dtype == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUresult r = operand_map(&fp.q_map, type, q, D, H, SQ, B, q_sh, q_ss, q_sb);
  // with no keys nothing is loaded: q's map stands in for k's and v's
  if (r == CUDA_SUCCESS)
    r = SK > 0 ? operand_map(&fp.k_map, type, k, D, KVH, SK, B, k_sh, k_ss,
                             k_sb)
               : operand_map(&fp.k_map, type, q, D, H, SQ, B, q_sh, q_ss,
                             q_sb);
  if (r == CUDA_SUCCESS)
    r = SK > 0 ? operand_map(&fp.v_map, type, v, D, KVH, SK, B, v_sh, v_ss,
                             v_sb)
               : operand_map(&fp.v_map, type, q, D, H, SQ, B, q_sh, q_ss,
                             q_sb);
  if (r != CUDA_SUCCESS) return kTmaRefused + (int)r;
  fp.out = out;
  fp.lse = lse;
  fp.q_seg = q_seg;
  fp.k_seg = k_seg;
  fp.B = B;
  fp.H = H;
  fp.KVH = KVH;
  fp.SQ = SQ;
  fp.SK = SK;
  fp.scale_log2 = scale * 1.4426950408889634f;
  fp.causal = causal;
  const bool seg = q_seg != nullptr;
  switch (dtype) {
    case 1:
      return seg ? launch_fwd_t<__half, true>(fp, D, s)
                 : launch_fwd_t<__half, false>(fp, D, s);
    case 2:
      return seg ? launch_fwd_t<__nv_bfloat16, true>(fp, D, s)
                 : launch_fwd_t<__nv_bfloat16, false>(fp, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  q_seg / k_seg: contiguous
// [B, Sq] / [B, Sk] int32 segment ids, or both null (no segments).  Each
// entry returns the cudaError_t of its launch (0 on success), or for the
// 16-bit forward 2000 + the CUresult of a tensor map the driver refuses;
// the Python wrapper raises on anything else.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* q_seg, const int* k_seg, int dtype, int batch, int sq, int sk,
    int heads, int kv_heads, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    void* stream) {
  if (dtype == 1 || dtype == 2)
    return run_fwd16(q, k, v, out, lse, q_seg, k_seg, dtype, batch, sq, sk,
                     heads, kv_heads, head_dim, q_sb, q_ss, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, scale, causal,
                     static_cast<cudaStream_t>(stream));
  Params p = make_params(q, k, v, q_seg, k_seg, batch, sq, sk, heads,
                         kv_heads, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                         v_ss, v_sh, scale, causal);
  p.out = out;
  p.lse_out = lse;
  return run(kFwd, p, dtype, head_dim, stream);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* q_seg,
    const int* k_seg, int dtype, int batch, int sq, int sk, int heads,
    int kv_heads, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, int causal, void* stream) {
  Params p = make_params(q, k, v, q_seg, k_seg, batch, sq, sk, heads,
                         kv_heads, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                         v_ss, v_sh, scale, causal);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.dq = dq;
  return run(kDq, p, dtype, head_dim, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* q_seg, const int* k_seg, int dtype, int batch, int sq, int sk,
    int heads, int kv_heads, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, int causal, void* stream) {
  Params p = make_params(q, k, v, q_seg, k_seg, batch, sq, sk, heads,
                         kv_heads, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                         v_ss, v_sh, scale, causal);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, p, dtype, head_dim, stream);
}
