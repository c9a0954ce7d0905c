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
// The 16-bit kernels are built for Hopper (hopper.cuh): TMA copies into
// 128-byte-swizzled shared memory tracked by mbarriers, products on wgmma
// with f32 accumulators in registers, exp2 with log2(e) folded into the
// scale (and into lse in the backward), and a per-element mask only on
// tiles that cross the causal diagonal, the Sq / Sk edge or a segment
// boundary.  With segment ids the walk loads only the tiles whose id
// range meets a consumer group's, with no block barrier per tile, and
// hands each stage its tile (-1 ends the walk) and, where the tile is not
// one segment with the group's rows, its ids.
//   * forward (fwd_wgmma_kernel): 384 threads own 128 queries; a producer
//     warp copies Q once and each 128-key K/V tile into a 2-stage ring;
//     two consumer warpgroups (64 rows each, registers moved to them with
//     setmaxnreg) compute S = Q K^T and O += P V (P from registers) and
//     take turns at issuing S (named barriers).  160 KB of shared memory
//     at D = 128.
//   * dq (dq_wgmma_kernel): 288 threads own 128 queries: warps 0-7 are two
//     consumer warpgroups of 64 rows, warp 8 the producer, which copies Q
//     and dO once and each 64-key K/V tile into a 2-stage ring (and with
//     segment ids reads each tile's ids, as the forward's does).  S = Q K^T
//     and dP = dO V^T from shared memory, dS = P (dP - delta) in
//     registers, dQ += dS K with dS re-packed in place as the A operand and
//     K read MN-major (as V is in the forward's P V).
//   * dkv (dkv_wgmma_kernel): 256 threads own 128 keys of one (batch, kv
//     head), K and V resident; each of two consumer warpgroups owns 64
//     keys and computes the products transposed, keys as wgmma's rows:
//     S^T = K Q^T and dP^T = V dO^T from shared memory, then dV += P^T dO
//     and dK += dS^T Q with P^T / dS^T from registers and the Q / dO tile
//     read MN-major (the same swizzled bytes serve both descriptors).  The
//     block walks the 64-query tiles from the first that sees its keys,
//     over every query head of the group, in a 2-stage ring.  It has no
//     producer warp: a 288- or 384-thread block leaves ptxas 168 registers
//     a thread, too few for dK and dV beside S^T and dP^T, and 256 threads
//     leave 255.  The last warp to be done with a stage refills it (TMA
//     copies of Q and dO, cp.async copies of the tile's lse and delta rows
//     and, with segment ids, its query ids), so no warp waits for another;
//     with segment ids the block first marks, in bitmasks, the query tiles
//     whose id range meets each group's keys, and the walk visits only
//     those.
// One writer per result and no atomics: dq and dk / dv stay two kernels,
// deterministic.  P and dS are rounded to the input type for their second
// product, as FlashAttention-2 does.
//
// float32 inputs take plain FMA tiles (16 queries or 32 keys per block, 4
// warps), with segment ids staged by one warp a tile ahead and read after
// a block barrier.

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

// ------------------------------------------------ backward, Hopper wgmma
// Each stage of a ring has a "full" barrier, which its copies complete.
// dq: 288 threads, warps 0-7 two consumer warpgroups and warp 8 the
// producer (its lane 0 issues the TMA copies); each stage also has an
// "empty" barrier, at which each consumer warp arrives once it is done
// with the stage, computed or skipped.
constexpr int kDqThreads = 288;
constexpr int kBwdStages = 2;
constexpr int kDqBQ = 128, kDqBK = 64;    // dq: queries a block, keys a tile
constexpr int kDkvBK = 128, kDkvBQ = 64;  // dkv: keys a block, queries a tile
constexpr uint32_t kBox64 = 64 * 128;     // one box: 64 rows x 128 bytes
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  CUtensorMap q_map, k_map, v_map, do_map;  // (D, heads, S, B)
  const float* lse;                         // [B, H, SQ]
  const float* delta;                       // [B, H, SQ]
  void* dq;                                 // [B, SQ, H, D]
  void* dk;                                 // [B, SK, KVH, D]
  void* dv;
  const int* q_seg;                         // [B, SQ] int32 (Seg only)
  const int* k_seg;                         // [B, SK] int32
  int B, H, KVH, SQ, SK;
  float scale;                              // dq and dk are scaled by it
  float scale_log2;                         // scale * log2(e)
  int causal;
};

// dq's barriers and what the producer hands the consumers (as the
// forward's FwdShared, over 64-key tiles)
template <int S>
struct DqShared {
  uint64_t qd_full, full[S], empty[S];
  int tile[S], klo[S], khi[S];
  int qlo[2], qhi[2];  // each consumer warpgroup's query-id range
  int qid[kDqBQ];
  int kid[S][kDqBK];
};

// Q and dO ([128, D] each), the K/V ring ([64, D] tiles), the barriers
template <int D>
constexpr size_t dq_smem() {
  return 1024 + 2 * (D / 64) * kBox + 2 * kBwdStages * (D / 64) * kBox64 +
         sizeof(DqShared<kBwdStages>);
}

template <typename T, int D, bool Seg>
__global__ void __launch_bounds__(kDqThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ BwdParams p) {
  constexpr int BQ = kDqBQ, BK = kDqBK, S = kBwdStages;
  constexpr uint32_t kQTile = (D / 64) * kBox;    // one [128, D] tile
  constexpr uint32_t kKTile = (D / 64) * kBox64;  // one [64, D] tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* do_s = q_s + kQTile;
  unsigned char* k_s = do_s + kQTile;  // stage st at + st * kKTile
  unsigned char* v_s = k_s + S * kKTile;
  DqShared<S>& sh = *reinterpret_cast<DqShared<S>*>(v_s + S * kKTile);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int off = p.SK - p.SQ;
  const int q_last = min(q0 + BQ, p.SQ) - 1;
  const int kend = p.causal ? max(0, min(p.SK, q_last + off + 1)) : p.SK;
  const int n_tiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sh.qd_full, 1);
#pragma unroll
    for (int st = 0; st < S; ++st) {
      hopper::mbar_init(&sh.full[st], 1);
      hopper::mbar_init(&sh.empty[st], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------- producer (warp 8)
    const int lane = threadIdx.x % 32;
    int qlo = 0, qhi = 0;  // the block's query-id range
    int wlo[2] = {0, 0}, whi[2] = {0, 0};
    if constexpr (Seg) {
      // lane l holds rows l + 32 e: e 0-1 are warpgroup 0's, 2-3 group 1's
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
      hopper::mbar_arrive_expect_tx(&sh.qd_full, 2 * kQTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(q_s + c * kBox, &p.q_map, &sh.qd_full, c * 64, h,
                            q0, b);
        hopper::tma_load_4d(do_s + c * kBox, &p.do_map, &sh.qd_full, c * 64,
                            h, q0, b);
      }
    }
    // the copies of key tile j into stage `issued % S`
    int issued = 0;
    auto load_kv = [&](int j) {
      const int st = issued % S;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&sh.full[st], 2 * kKTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(k_s + st * kKTile + c * kBox64, &p.k_map,
                              &sh.full[st], c * 64, kvh, j * BK, b);
          hopper::tma_load_4d(v_s + st * kKTile + c * kBox64, &p.v_map,
                              &sh.full[st], c * 64, kvh, j * BK, b);
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
      // a pass (their 16 loads in flight together); a tile is loaded only
      // where its range meets a consumer group's query range.
      const int* kseg = p.k_seg + (long long)b * p.SK;
      for (int j0 = 0; j0 < n_tiles; j0 += 8) {
        int lo[8], hi[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          lo[u] = INT_MAX;
          hi[u] = INT_MIN;
#pragma unroll
          for (int e = 0; e < BK / 32; ++e) {
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
            for (int e = 0; e < BK / 32; ++e) {
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
        hopper::mbar_arrive(&sh.full[st]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int cw = threadIdx.x / 128;  // consumer warpgroup, 0 or 1
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int w0 = q0 + cw * 64;  // the group's first query row
  const int t0 = w0 + warp * 16 + g, t1 = t0 + 8;
  const float c = p.scale_log2;
  // each row's lse_safe * log2(e) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r == 0 ? t0 : t1;
    lse2[r] = dl[r] = 0.f;
    if (t < p.SQ) {
      const long long row = ((long long)b * p.H + h) * p.SQ + t;
      const float x = p.lse[row];
      lse2[r] = x == -INFINITY ? 0.f : x * kLog2e;
      dl[r] = p.delta[row];
    }
  }

  const uint32_t q_addr = hopper::smem_u32(q_s) + cw * 64 * 128;
  const uint32_t do_addr = hopper::smem_u32(do_s) + cw * 64 * 128;
  const uint32_t k_addr = hopper::smem_u32(k_s);
  const uint32_t v_addr = hopper::smem_u32(v_s);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(&sh.qd_full, 0);
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
      hopper::mbar_wait(&sh.full[st], ph);
      j = sh.tile[st];
      if (j < 0) break;
      klo = sh.klo[st];
      khi = sh.khi[st];
    } else {
      if (i >= n_tiles) break;
      hopper::mbar_wait(&sh.full[st], ph);
    }
    const int k0 = j * BK;
    // nothing of this tile is visible to the group's rows
    const bool skip = w0 >= p.SQ || (p.causal && k0 > w0 + 63 + off) ||
                      (Seg && apart(klo, khi, wqlo, wqhi));
    if (!skip) {
      float s[BK / 2], dp[BK / 2];
      const uint32_t kt = k_addr + st * kKTile, vt = v_addr + st * kKTile;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, BK>(
            s, hopper::desc_k(q_addr + (kk / 4) * kBox + (kk % 4) * 32),
            hopper::desc_k(kt + (kk / 4) * kBox64 + (kk % 4) * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, BK>(
            dp, hopper::desc_k(do_addr + (kk / 4) * kBox + (kk % 4) * 32),
            hopper::desc_k(vt + (kk / 4) * kBox64 + (kk % 4) * 32), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);
      hopper::fence_operand(dp);

      // dS = P (dP - delta), P = 2^(s scale log2(e) - lse log2(e)); a
      // per-element test only where the tile crosses the causal diagonal
      // of the group's rows, the Sk edge or a segment boundary
      const bool uniform = !Seg || (klo == khi && wqlo == wqhi && klo == wqlo);
      const bool edge = k0 + BK > p.SK ||
                        (p.causal && k0 + BK - 1 > w0 + off) || !uniform;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = fast_exp2(fmaf(s[4 * n + e], c, -lse2[r]));
          if (edge) {
            const int kc = n * 8 + 2 * tq + (e & 1), key = k0 + kc;
            bool vis = key < p.SK && (!p.causal || key <= (r ? t1 : t0) + off);
            if constexpr (Seg)
              vis = vis && (uniform || sh.kid[st][kc] == (r ? qs1 : qs0));
            if (!vis) x = 0.f;
          }
          s[4 * n + e] = x * (dp[4 * n + e] - dl[r]);
        }
      // dS's A fragment for keys 16 kk .. 16 kk + 15
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        da[kk][0] = pack_floats<T>(s[8 * kk], s[8 * kk + 1]);
        da[kk][1] = pack_floats<T>(s[8 * kk + 2], s[8 * kk + 3]);
        da[kk][2] = pack_floats<T>(s[8 * kk + 4], s[8 * kk + 5]);
        da[kk][3] = pack_floats<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // dQ += dS K, K read MN-major: keys are the reduction
      hopper::fence_operand(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_rs<T, D>(acc, da[kk],
                               hopper::desc_mn(kt + kk * 16 * 128, kBox64), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sh.empty[st]);
  }

  T* dqp = static_cast<T*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r == 0 ? t0 : t1;
    if (t < p.SQ) {
      T* row = dqp + (((long long)b * p.SQ + t) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tq) = pack_floats<T>(
            acc[4 * n + 2 * r] * p.scale, acc[4 * n + 2 * r + 1] * p.scale);
    }
  }
}

// dkv: 256 threads, the two consumer warpgroups and no producer warp (a
// 288-thread block would leave ptxas 168 registers a thread, too few for
// dK and dV beside S^T and dP^T; 256 threads leave 255).  The producer's
// work goes to the consumer warps without blocking any: thread 0 copies K
// and V once, warp 0 fills the first stages, and the last warp to be done
// with a stage (a shared-memory count) refills it with the walk's next
// tile: the TMA copies of Q and dO, and cp.async copies of the tile's lse
// and delta rows (and, with segment ids, its query ids), all completing on
// the stage's "full" barrier.
constexpr int kDkvThreads = 256;
constexpr int kDkvWarps = kDkvThreads / 32;

// dkv's barriers and what a refill hands the consumers: each stage's walk
// element (hh * n_qt + query tile, -1: the walk ended), with segment ids
// its flags (bit g: the tile's id range meets consumer group g's; bit 2 +
// g: the tile and group g are one segment) and its query ids; each
// query's lse (as given) and delta.  With segment ids four bitmasks of
// the query tiles follow (dynamic): meets group 0, meets group 1, one
// segment with group 0, with group 1.
template <int S>
struct DkvShared {
  uint64_t kv_full, full[S];
  int released[S];  // consumer warps done with the stage
  int tile[S], flags[S];
  int n_hit;        // query tiles a head that meet a group's key range
  int klo[2], khi[2];  // each consumer warpgroup's key-id range
  int kid[kDkvBK];
  int qid[S][kDkvBQ];
  alignas(16) float lse[S][kDkvBQ];
  alignas(16) float dl[S][kDkvBQ];
};

// K and V ([128, D] each), the Q/dO ring ([64, D] tiles), the barriers
template <int D>
constexpr size_t dkv_smem() {
  return 1024 + 2 * (D / 64) * kBox + 2 * kBwdStages * (D / 64) * kBox64 +
         sizeof(DkvShared<kBwdStages>);
}

// the words of one bitmask of a key block's query tiles
__host__ __device__ __forceinline__ int dkv_mask_words(int n_qt) {
  return (n_qt + 31) / 32;
}

// the tile of the k-th set bit of `mask0 | mask1` (n words), or -1; a
// warp-collective select: each lane counts one word of a 32-word chunk
__device__ __forceinline__ int nth_tile(const uint32_t* mask0,
                                        const uint32_t* mask1, int n, int k) {
  const int lane = threadIdx.x % 32;
  for (int w0 = 0; w0 < n; w0 += 32) {
    const uint32_t word =
        w0 + lane < n ? mask0[w0 + lane] | mask1[w0 + lane] : 0u;
    const int c = __popc(word);
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += x;
    }
    const int total = __shfl_sync(kFull, inc, 31);
    if (k < total) {
      const int src = __ffs(__ballot_sync(kFull, inc > k)) - 1;
      uint32_t bits = __shfl_sync(kFull, word, src);
      for (int r = k - __shfl_sync(kFull, inc - c, src); r > 0; --r)
        bits &= bits - 1;
      return (w0 + src) * 32 + __ffs(bits) - 1;
    }
    k -= total;
  }
  return -1;
}

template <typename T, int D, bool Seg>
__global__ void __launch_bounds__(kDkvThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ BwdParams p) {
  constexpr int BKEY = kDkvBK, BQ = kDkvBQ, S = kBwdStages;
  constexpr uint32_t kKTile = (D / 64) * kBox;    // one [128, D] tile
  constexpr uint32_t kQTile = (D / 64) * kBox64;  // one [64, D] tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + kKTile;
  unsigned char* q_s = v_s + kKTile;  // stage st at + st * kQTile
  unsigned char* do_s = q_s + S * kQTile;
  DkvShared<S>& sh = *reinterpret_cast<DkvShared<S>*>(do_s + S * kQTile);

  const int b = blockIdx.x / p.KVH, kvh = blockIdx.x % p.KVH;
  const int rep = p.H / p.KVH;
  const int k0 = blockIdx.y * BKEY;  // early keys (most queries) first
  const int off = p.SK - p.SQ;
  // each head's query tiles: from the one holding the first query that
  // sees key k0
  const int qb = (p.causal ? max(0, k0 - off) : 0) / BQ * BQ;
  const int n_qt = qb < p.SQ ? (p.SQ - qb + BQ - 1) / BQ : 0;
  const int n_tiles = rep * n_qt;
  const int n_words = dkv_mask_words(n_qt);
  uint32_t* masks = reinterpret_cast<uint32_t*>(&sh + 1);  // Seg only
  const int* qseg = Seg ? p.q_seg + (long long)b * p.SQ : nullptr;

  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&sh.kv_full, 1);
#pragma unroll
    for (int st = 0; st < S; ++st) {
      // the TMA copies (one arrival) and each lane's cp.async copies
      hopper::mbar_init(&sh.full[st], 33);
      sh.released[st] = 0;
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::prefetch_tensor_map(&p.q_map);
    hopper::prefetch_tensor_map(&p.do_map);
    hopper::mbar_arrive_expect_tx(&sh.kv_full, 2 * kKTile);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hopper::tma_load_4d(k_s + c * kBox, &p.k_map, &sh.kv_full, c * 64, kvh,
                          k0, b);
      hopper::tma_load_4d(v_s + c * kBox, &p.v_map, &sh.kv_full, c * 64, kvh,
                          k0, b);
    }
  }

  if constexpr (Seg) {
    // the block's key ids and each group's range (warp 0: lane l holds
    // keys l + 32 e, e 0-1 group 0's, 2-3 group 1's), then the four
    // bitmasks of the query tiles, each warp taking 4 tiles a pass
    if (warp_id == 0) {
      const int* kseg = p.k_seg + (long long)b * p.SK;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
        for (int e = 2 * w; e < 2 * w + 2; ++e) {
          const int key = k0 + lane + 32 * e;
          const int id = key < p.SK ? kseg[key] : INT_MIN;
          sh.kid[lane + 32 * e] = id;
          if (key < p.SK) {
            lo = min(lo, id);
            hi = max(hi, id);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo = min(lo, __shfl_xor_sync(kFull, lo, o));
          hi = max(hi, __shfl_xor_sync(kFull, hi, o));
        }
        if (lane == 0) {
          sh.klo[w] = lo;
          sh.khi[w] = hi;
        }
      }
    }
    for (int i = threadIdx.x; i < 4 * n_words; i += kDkvThreads) masks[i] = 0;
    __syncthreads();
    const int wlo0 = sh.klo[0], whi0 = sh.khi[0];
    const int wlo1 = sh.klo[1], whi1 = sh.khi[1];
    for (int j0 = 4 * warp_id; j0 < n_qt; j0 += 4 * kDkvWarps) {
      int lo[4], hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        lo[u] = INT_MAX;
        hi[u] = INT_MIN;
#pragma unroll
        for (int e = 0; e < BQ / 32; ++e) {
          const int t = qb + (j0 + u) * BQ + lane + 32 * e;
          if (t < p.SQ) {
            const int id = qseg[t];
            lo[u] = min(lo[u], id);
            hi[u] = max(hi[u], id);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo[u] = min(lo[u], __shfl_xor_sync(kFull, lo[u], o));
          hi[u] = max(hi[u], __shfl_xor_sync(kFull, hi[u], o));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jt = j0 + u;
          if (jt >= n_qt) break;
          const uint32_t bit = 1u << (jt % 32);
          uint32_t* word = masks + jt / 32;
          if (!apart(lo[u], hi[u], wlo0, whi0)) atomicOr(word, bit);
          if (!apart(lo[u], hi[u], wlo1, whi1)) atomicOr(word + n_words, bit);
          if (lo[u] == hi[u] && wlo0 == whi0 && lo[u] == wlo0)
            atomicOr(word + 2 * n_words, bit);
          if (lo[u] == hi[u] && wlo1 == whi1 && lo[u] == wlo1)
            atomicOr(word + 3 * n_words, bit);
        }
      }
    }
    __syncthreads();
    if (warp_id == 0) {
      int hits = 0;
      for (int w = lane; w < n_words; w += 32)
        hits += __popc(masks[w] | masks[n_words + w]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        hits += __shfl_xor_sync(kFull, hits, o);
      if (lane == 0) sh.n_hit = hits;
      __syncwarp();
    }
  }

  // Fill stage st with the walk's element w (warp-collective): head w /
  // n_qt's query tile w % n_qt, or with segment ids head w / n_hit's
  // (w % n_hit)-th tile that meets a group's keys, and one past the last
  // element a stage with no copy and tile -1.
  auto refill = [&](int st, int w) {
    int hh, jt, flags = 0;
    if constexpr (Seg) {
      const int n_hit = sh.n_hit;
      if (w >= rep * n_hit) {
        if (w == rep * n_hit) {
          if (lane == 0) {
            sh.tile[st] = -1;
            hopper::mbar_arrive(&sh.full[st]);
          }
          hopper::cp_async_arrive(&sh.full[st]);
        }
        return;
      }
      hh = w / n_hit;
      jt = nth_tile(masks, masks + n_words, n_words, w % n_hit);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        flags |= (int)((masks[m * n_words + jt / 32] >> (jt % 32)) & 1u) << m;
    } else {
      if (w >= n_tiles) return;
      hh = w / n_qt;
      jt = w % n_qt;
    }
    const int h = kvh * rep + hh, q0 = qb + jt * BQ;
    if (lane == 0) {
      sh.tile[st] = hh * n_qt + jt;
      sh.flags[st] = flags;
      hopper::mbar_arrive_expect_tx(&sh.full[st], 2 * kQTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(q_s + st * kQTile + c * kBox64, &p.q_map,
                            &sh.full[st], c * 64, h, q0, b);
        hopper::tma_load_4d(do_s + st * kQTile + c * kBox64, &p.do_map,
                            &sh.full[st], c * 64, h, q0, b);
      }
    }
    const long long rows = ((long long)b * p.H + h) * p.SQ;
#pragma unroll
    for (int e = 0; e < BQ / 32; ++e) {
      const int i = lane + 32 * e, t = q0 + i;
      const bool in = t < p.SQ;
      const long long row = rows + (in ? t : 0);
      hopper::cp_async_4(&sh.lse[st][i], p.lse + row, in);
      hopper::cp_async_4(&sh.dl[st][i], p.delta + row, in);
      if constexpr (Seg)
        if ((flags & 12) != 12)  // the ids of a tile not one segment
          hopper::cp_async_4(&sh.qid[st][i], qseg + (in ? t : 0), in);
    }
    hopper::cp_async_arrive(&sh.full[st]);
  };
  if (warp_id == 0)
    for (int w = 0; w < S; ++w) refill(w, w);

  // ------------------------------------------------------------ consumers
  const int cw = threadIdx.x / 128;  // consumer warpgroup, 0 or 1
  const int warp = warp_id % 4;
  const int g = lane >> 2, tq = lane & 3;
  const int wk0 = k0 + cw * 64;  // the group's first key
  const int key0 = wk0 + warp * 16 + g, key1 = key0 + 8;
  const float c = p.scale_log2;

  const uint32_t k_addr = hopper::smem_u32(k_s) + cw * 64 * 128;
  const uint32_t v_addr = hopper::smem_u32(v_s) + cw * 64 * 128;
  const uint32_t q_addr = hopper::smem_u32(q_s);
  const uint32_t do_addr = hopper::smem_u32(do_s);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  hopper::mbar_wait(&sh.kv_full, 0);
  int ks0 = 0, ks1 = 0;
  if constexpr (Seg) {
    ks0 = sh.kid[key0 - k0];
    ks1 = sh.kid[key1 - k0];
  }

  for (int i = 0;; ++i) {
    const int st = i % S;
    if (!Seg && i >= n_tiles) break;
    hopper::mbar_wait(&sh.full[st], (i / S) & 1);
    const int j = sh.tile[st];
    if (Seg && j < 0) break;
    const int flags = sh.flags[st];
    const int q0 = qb + (j % n_qt) * BQ;
    // nothing of this tile is visible to the group's keys
    const bool skip = wk0 >= p.SK || (p.causal && q0 + BQ - 1 + off < wk0) ||
                      (Seg && !((flags >> cw) & 1));
    if (!skip) {
      float s[BQ / 2], dp[BQ / 2];
      const uint32_t qt = q_addr + st * kQTile, dt = do_addr + st * kQTile;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, BQ>(
            s, hopper::desc_k(k_addr + (kk / 4) * kBox + (kk % 4) * 32),
            hopper::desc_k(qt + (kk / 4) * kBox64 + (kk % 4) * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, BQ>(
            dp, hopper::desc_k(v_addr + (kk / 4) * kBox + (kk % 4) * 32),
            hopper::desc_k(dt + (kk / 4) * kBox64 + (kk % 4) * 32), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);
      hopper::fence_operand(dp);

      // P^T and dS^T = P^T (dP^T - delta); a per-element test only where
      // the tile crosses the causal diagonal of the group's keys, the Sq
      // edge or a segment boundary
      const bool uniform = !Seg || ((flags >> (2 + cw)) & 1);
      const bool edge = q0 + BQ > p.SQ ||
                        (p.causal && wk0 + 63 > q0 + off) || !uniform;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const int qc = n * 8 + 2 * tq;  // this lane's two query columns
        const float2 l2 = *reinterpret_cast<const float2*>(&sh.lse[st][qc]);
        const float2 d2 = *reinterpret_cast<const float2*>(&sh.dl[st][qc]);
        // lse_safe * log2(e): a row that sees nothing has lse -inf
        const float m0 = l2.x == -INFINITY ? 0.f : l2.x * kLog2e;
        const float m1 = l2.y == -INFINITY ? 0.f : l2.y * kLog2e;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = e & 1;
          float x = fast_exp2(fmaf(s[4 * n + e], c, col ? -m1 : -m0));
          if (edge) {
            const int t = q0 + qc + col, key = e < 2 ? key0 : key1;
            bool vis = t < p.SQ && (!p.causal || key <= t + off);
            if constexpr (Seg)
              vis = vis &&
                    (uniform || sh.qid[st][qc + col] == (e < 2 ? ks0 : ks1));
            if (!vis) x = 0.f;
          }
          s[4 * n + e] = x;
          dp[4 * n + e] = x * (dp[4 * n + e] - (col ? d2.y : d2.x));
        }
      }
      // P^T's and dS^T's A fragments for queries 16 kk .. 16 kk + 15
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[kk][x] = pack_floats<T>(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
          da[kk][x] =
              pack_floats<T>(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
        }
      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major: the
      // queries are the reduction
      hopper::fence_operand(dv);
      hopper::fence_operand(dk);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hopper::wgmma_rs<T, D>(dv, pa[kk],
                               hopper::desc_mn(dt + kk * 16 * 128, kBox64), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hopper::wgmma_rs<T, D>(dk, da[kk],
                               hopper::desc_mn(qt + kk * 16 * 128, kBox64), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dv);
      hopper::fence_operand(dk);
    }
    // the last of the 8 warps to be done with the stage refills it
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&sh.released[st], 1) == kDkvWarps - 1;
      if (last) {
        sh.released[st] = 0;
        __threadfence_block();
      }
    }
    if (__shfl_sync(kFull, last, 0)) refill(st, i + S);
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key0 : key1;
    if (key < p.SK) {
      const long long o = (((long long)b * p.SK + key) * p.KVH + kvh) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(dkp + o + col) = pack_floats<T>(
            dk[4 * n + 2 * r] * p.scale, dk[4 * n + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvp + o + col) =
            pack_floats<T>(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
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

// the float32 kernels (16-bit inputs take run_fwd16 / run_bwd16)
template <int D, bool Seg>
cudaError_t launch_f32(Which which, const Params& p, cudaStream_t s) {
  const dim3 by_fq(p.B * p.H, (p.SQ + kFQ - 1) / kFQ);
  switch (which) {
    case kFwd:
      return launch(fwd_f32_kernel<D, Seg>, by_fq, fwd_f32_smem<D>(), s, p);
    case kDq:
      return launch(dq_f32_kernel<D, Seg>, by_fq, dq_f32_smem<D>(), s, p);
    case kDkv:
      return launch(dkv_f32_kernel<D, Seg>,
                    dim3(p.B * p.KVH, (p.SK + kFK - 1) / kFK),
                    dkv_f32_smem<D>(), s, p);
  }
  return cudaErrorInvalidValue;
}

template <bool Seg>
cudaError_t launch_seg(Which which, const Params& p, int head_dim,
                       cudaStream_t s) {
  switch (head_dim) {
    case 64: return launch_f32<64, Seg>(which, p, s);
    case 128: return launch_f32<128, Seg>(which, p, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, Params& p, int dtype, int head_dim, void* stream) {
  if (p.B <= 0 || p.H <= 0) return cudaSuccess;
  if (p.KVH <= 0 || p.H % p.KVH != 0) return cudaErrorInvalidValue;
  if ((p.q_seg == nullptr) != (p.k_seg == nullptr))
    return cudaErrorInvalidValue;
  if (dtype != 0) return cudaErrorInvalidValue;
  if (which == kDkv ? p.SK <= 0 : p.SQ <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.q_seg ? launch_seg<true>(which, p, head_dim, s)
                 : launch_seg<false>(which, p, head_dim, s);
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
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t attr = hopper::allow_smem(kernel, smem, smem_set);
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

// the map of one operand (hopper.cuh)
using hopper::operand_map;

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
  FwdParams fp = {};
  const CUtensorMapDataType type = dtype == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUresult r = operand_map(&fp.q_map, type, q, D, H, SQ, B, q_sh, q_ss, q_sb,
                           kFwdBQ);
  // with no keys nothing is loaded: q's map stands in for k's and v's
  if (r == CUDA_SUCCESS)
    r = SK > 0 ? operand_map(&fp.k_map, type, k, D, KVH, SK, B, k_sh, k_ss,
                             k_sb, kFwdBK)
               : operand_map(&fp.k_map, type, q, D, H, SQ, B, q_sh, q_ss,
                             q_sb, kFwdBK);
  if (r == CUDA_SUCCESS)
    r = SK > 0 ? operand_map(&fp.v_map, type, v, D, KVH, SK, B, v_sh, v_ss,
                             v_sb, kFwdBK)
               : operand_map(&fp.v_map, type, q, D, H, SQ, B, q_sh, q_ss,
                             q_sb, kFwdBK);
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
  fp.scale_log2 = scale * kLog2e;
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

// ------------------------------------------------ backward launches (16-bit)
constexpr int kMaxSmem = 232448;  // the most shared memory a block may use

template <typename T, int D, bool Seg>
cudaError_t launch_bwd(Which which, const BwdParams& bp, cudaStream_t s) {
  if (which == kDq) {
    auto kernel = dq_wgmma_kernel<T, D, Seg>;
    constexpr size_t smem = dq_smem<D>();
    static std::atomic<unsigned long long> smem_set{0};
    const cudaError_t attr = hopper::allow_smem(kernel, smem, smem_set);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(bp.B * bp.H, (bp.SQ + kDqBQ - 1) / kDqBQ);
    kernel<<<grid, dim3(kDqThreads), smem, s>>>(bp);
  } else {
    auto kernel = dkv_wgmma_kernel<T, D, Seg>;
    // with segment ids, the four bitmasks of the longest walk's query tiles
    const size_t smem =
        dkv_smem<D>() +
        (Seg ? 4 * sizeof(uint32_t) *
                   dkv_mask_words((bp.SQ + kDkvBQ - 1) / kDkvBQ)
             : 0);
    static std::atomic<unsigned long long> smem_set{0};
    const cudaError_t attr = hopper::allow_smem(kernel, kMaxSmem, smem_set);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(bp.B * bp.KVH, (bp.SK + kDkvBK - 1) / kDkvBK);
    kernel<<<grid, dim3(kDkvThreads), smem, s>>>(bp);
  }
  return cudaGetLastError();
}

template <typename T, bool Seg>
cudaError_t launch_bwd_t(Which which, const BwdParams& bp, int head_dim,
                         cudaStream_t s) {
  switch (head_dim) {
    case 64: return launch_bwd<T, 64, Seg>(which, bp, s);
    case 128: return launch_bwd<T, 128, Seg>(which, bp, s);
    default: return cudaErrorInvalidValue;
  }
}

int run_bwd16(Which which, const Params& p, int dtype, int D,
              cudaStream_t s) {
  if (p.B <= 0 || p.H <= 0 || (which == kDkv ? p.SK <= 0 : p.SQ <= 0))
    return cudaSuccess;
  if (p.KVH <= 0 || p.H % p.KVH != 0 ||
      (p.q_seg == nullptr) != (p.k_seg == nullptr))
    return cudaErrorInvalidValue;
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  BwdParams bp = {};
  const CUtensorMapDataType type = dtype == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // dq: boxes of 128 query rows and 64 key rows; dkv the other way round
  const int qrows = which == kDq ? kDqBQ : kDkvBQ;
  const int krows = which == kDq ? kDqBK : kDkvBK;
  CUresult r = CUDA_SUCCESS;
  if (p.SQ > 0) {
    r = operand_map(&bp.q_map, type, p.q, D, p.H, p.SQ, p.B, p.q_sh, p.q_ss,
                    p.q_sb, qrows);
    if (r == CUDA_SUCCESS)
      r = operand_map(&bp.do_map, type, p.dout, D, p.H, p.SQ, p.B, p.do_sh,
                      p.do_ss, p.do_sb, qrows);
  } else {
    // dkv with no queries loads nothing: k's map stands in
    r = operand_map(&bp.q_map, type, p.k, D, p.KVH, p.SK, p.B, p.k_sh,
                    p.k_ss, p.k_sb, qrows);
    bp.do_map = bp.q_map;
  }
  if (r == CUDA_SUCCESS) {
    if (p.SK > 0) {
      r = operand_map(&bp.k_map, type, p.k, D, p.KVH, p.SK, p.B, p.k_sh,
                      p.k_ss, p.k_sb, krows);
      if (r == CUDA_SUCCESS)
        r = operand_map(&bp.v_map, type, p.v, D, p.KVH, p.SK, p.B, p.v_sh,
                        p.v_ss, p.v_sb, krows);
    } else {
      // dq with no keys loads nothing: q's map stands in
      r = operand_map(&bp.k_map, type, p.q, D, p.H, p.SQ, p.B, p.q_sh,
                      p.q_ss, p.q_sb, krows);
      bp.v_map = bp.k_map;
    }
  }
  if (r != CUDA_SUCCESS) return kTmaRefused + (int)r;
  bp.lse = p.lse;
  bp.delta = p.delta;
  bp.dq = p.dq;
  bp.dk = p.dk;
  bp.dv = p.dv;
  bp.q_seg = p.q_seg;
  bp.k_seg = p.k_seg;
  bp.B = p.B;
  bp.H = p.H;
  bp.KVH = p.KVH;
  bp.SQ = p.SQ;
  bp.SK = p.SK;
  bp.scale = p.scale;
  bp.scale_log2 = p.scale * kLog2e;
  bp.causal = p.causal;
  const bool seg = p.q_seg != nullptr;
  switch (dtype) {
    case 1:
      return seg ? launch_bwd_t<__half, true>(which, bp, D, s)
                 : launch_bwd_t<__half, false>(which, bp, D, s);
    case 2:
      return seg ? launch_bwd_t<__nv_bfloat16, true>(which, bp, D, s)
                 : launch_bwd_t<__nv_bfloat16, false>(which, bp, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  q_seg / k_seg: contiguous
// [B, Sq] / [B, Sk] int32 segment ids, or both null (no segments).  Each
// entry returns the cudaError_t of its launch (0 on success), or for the
// 16-bit kernels 2000 + the CUresult of a tensor map the driver refuses;
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
  if (dtype == 1 || dtype == 2)
    return run_bwd16(kDq, p, dtype, head_dim,
                     static_cast<cudaStream_t>(stream));
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
  if (dtype == 1 || dtype == 2)
    return run_bwd16(kDkv, p, dtype, head_dim,
                     static_cast<cudaStream_t>(stream));
  return run(kDkv, p, dtype, head_dim, stream);
}
