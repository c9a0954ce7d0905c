// The split-KV walk of one 16-bit decode query (sq == 1) over a KV cache,
// for Hopper (sm_90a): the body of two kernels.
//
//  * decode_attention.cu decode_split_kernel (decode_attention, sq == 1)
//    runs it with NoAppend: the visible rows are kpos < seq_lens[b];
//  * decode_block_tp.cu attn_tp_split_kernel (decode_block_attn_tp, one
//    tensor-parallel shard) runs it with an append policy: rotary on the
//    queries, the fresh K/V row stored at posw = min(pos, S - 1), the
//    visible rows kpos < posw, and the fresh row folded in after the
//    merge.
//
// One block walks one run of split_rows cache rows for G (1 or 4) query
// heads of one kv head.  Warps 0-3 consume, warp 4's first lane produces:
// it issues the TMA copies of each 32-row K and V tile (D / 64 boxes of 32
// rows x 128 bytes each, 128-byte swizzled: row r's 16-byte chunk c lands
// at chunk c ^ (r % 8)) into a ring of kSplitStages stages.  Each stage has
// a "full" barrier (the copies complete it) and an "empty" one (each
// consumer warp arrives once it has read its rows).  A tile may cover rows
// past the visible end (stale rows, or the row this call is writing):
// their scores are -inf and their V rows are skipped, never multiplied by
// 0.  The warps' partials merge in warp order; a block whose split is the
// only one writes the output, otherwise it writes (m, l, acc[D]) in f32 to
// the workspace and counts itself done on an integer counter; the block
// that counts last merges every split's partial in split order (no float
// atomics: the result does not depend on which block is last) and resets
// the counter to 0 for the next call.
//
// An append policy is a struct with
//   static constexpr bool kOn;                       // true
//   int end(const SplitParams&, int b) const;        // visible rows
//   void load_q(const SplitParams&, ..., q) const;   // the block's queries
//   void prologue(const SplitParams&, ..., q) const; // store + fresh score
//   float fold(g, d, mx, ls, as) const;              // the output value
// (see decode_block_tp.cu); NoAppend below compiles to the walk alone.
// Everything here lives in the translation unit's anonymous namespace and
// uses its own helper names, so it can sit beside gemv.cuh's.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kSplitWarps = 4;                         // consumer warps
constexpr int kSplitThreads = (kSplitWarps + 1) * 32;  // + the producer
constexpr int kSplitTile = 32;                         // cache rows a stage
constexpr int kSplitStages = 3;
constexpr int kSplitRows = kSplitTile / kSplitWarps;   // a warp's rows a tile
constexpr uint32_t kSplitBox = kSplitTile * 128;       // 32 rows x 128 bytes
constexpr int kMergeBar = 1;  // named barrier of the consumer warps
constexpr unsigned kSplitFull = 0xffffffffu;

__device__ __forceinline__ float split_float(__half x) {
  return __half2float(x);
}
__device__ __forceinline__ float split_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T split_cast(float x);
template <> __device__ __forceinline__ __half split_cast<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 split_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// E consecutive elements read with one vector load (E * sizeof(T) <= 16)
template <typename T, int E>
struct alignas(sizeof(T) * E) SplitVec {
  T v[E];
};

struct SplitParams {
  CUtensorMap k_map, v_map;  // (D, KVH, S, B), boxes 64 x 1 x 32 x 1
  const void* q;             // [B, 1, H, D] through its strides
  const int* seq_lens;
  void* out;                 // contiguous [B, 1, H, D]
  float* part;               // [rows, n_splits, G, 2 + D]: m, l, acc
  int* count;                // [rows]: splits done; 0 between calls
  long long q_sb, q_sh;
  int H, KVH, S, split_rows, n_splits;
  float scale_log2;          // scale * log2(e)
};

template <int G, int D>
struct SplitShared {
  uint64_t full[kSplitStages], empty[kSplitStages];
  float m[kSplitWarps][G], l[kSplitWarps][G];
  float acc[kSplitWarps][G][D];
  int last;
};

// the ring (1024-byte aligned) and SplitShared; an append policy's shared
// state follows
template <int G, int D>
constexpr size_t split_smem() {
  return 1024 + 2 * kSplitStages * (D / 64) * kSplitBox +
         sizeof(SplitShared<G, D>);
}

// the walk alone: decode_attention's visible rows, queries and output
struct NoAppend {
  static constexpr bool kOn = false;
};

template <typename T, int D, int G, typename Policy>
__device__ __forceinline__ void split_walk(const SplitParams& p,
                                           const Policy& pol) {
  constexpr int E = D / 32;                         // columns a lane holds
  constexpr uint32_t kTile = (D / 64) * kSplitBox;  // one K or V tile
  constexpr int NS = kSplitStages, RW = kSplitRows;
  constexpr int kConsumers = kSplitWarps * 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = smem;  // stage st at + st * kTile
  unsigned char* v_s = k_s + NS * kTile;
  SplitShared<G, D>& sh =
      *reinterpret_cast<SplitShared<G, D>*>(v_s + NS * kTile);

  const int groups = p.H / p.KVH / G;  // blocks a kv head's heads take
  const int row = blockIdx.x;          // (batch, kv head, head group)
  const int b = row / (p.KVH * groups);
  const int kvh = row / groups % p.KVH;
  const int h0 = kvh * (p.H / p.KVH) + row % groups * G;
  int end;  // rows the query sees
  if constexpr (Policy::kOn)
    end = pol.end(p, b);
  else
    end = min(p.S, max(p.seq_lens[b], 0));
  const int n_vis = (end + p.split_rows - 1) / p.split_rows;
  const int r0 = blockIdx.y * p.split_rows;
  T* op = static_cast<T*>(p.out) + ((long long)b * p.H + h0) * D;
  if ((int)blockIdx.y >= max(n_vis, 1)) return;  // no visible row here
  if constexpr (!Policy::kOn) {
    if (n_vis == 0) {  // the query sees no row: zeros
      for (int i = threadIdx.x; i < G * D; i += kSplitThreads)
        op[i] = split_cast<T>(0.f);
      return;
    }
  }
  const int r1 = min(end, r0 + p.split_rows);
  const int n_tiles = (r1 - r0 + kSplitTile - 1) / kSplitTile;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      hopper::mbar_init(&sh.full[st], 1);
      hopper::mbar_init(&sh.empty[st], kSplitWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x != kConsumers) return;
    hopper::prefetch_tensor_map(&p.k_map);
    hopper::prefetch_tensor_map(&p.v_map);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % NS;
      hopper::mbar_wait(&sh.empty[st], ((t / NS) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&sh.full[st], 2 * kTile);
      const int y = r0 + t * kSplitTile;
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(k_s + st * kTile + c * kSplitBox, &p.k_map,
                            &sh.full[st], c * 64, kvh, y, b);
        hopper::tma_load_4d(v_s + st * kTile + c * kSplitBox, &p.v_map,
                            &sh.full[st], c * 64, kvh, y, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = lane * E;  // this lane's first column
  // its bytes in a swizzled row: box, 16-byte chunk, offset in the chunk
  const int box = col / 64, chunk = col % 64 / 8, within = col % 8 * 2;
  float q[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if constexpr (Policy::kOn) {
      pol.load_q(p, b, h0 + g, col, q[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    } else {
      const SplitVec<T, E> qv = *reinterpret_cast<const SplitVec<T, E>*>(
          static_cast<const T*>(p.q) + b * p.q_sb + (h0 + g) * p.q_sh + col);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        q[g][e] = split_float(qv.v[e]) * p.scale_log2;
        acc[g][e] = 0.f;
      }
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  if constexpr (Policy::kOn) pol.prologue(p, b, kvh, row % groups, col, q);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % NS;
    hopper::mbar_wait(&sh.full[st], (t / NS) & 1);
    const unsigned char* kt = k_s + st * kTile + box * kSplitBox;
    const unsigned char* vt = v_s + st * kTile + box * kSplitBox;
    SplitVec<T, E> kx[RW], vx[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const int r = warp * RW + j;
      const int off = r * 128 + ((chunk ^ (r & 7)) << 4) + within;
      kx[j] = *reinterpret_cast<const SplitVec<T, E>*>(kt + off);
      vx[j] = *reinterpret_cast<const SplitVec<T, E>*>(vt + off);
    }
    // the rows are in registers: the stage may be refilled
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sh.empty[st]);

    const int first = r0 + t * kSplitTile + warp * RW;  // row of j = 0
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[RW];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          dot = fmaf(q[g][e], split_float(kx[j].v[e]), dot);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kSplitFull, dot, o);
        s[j] = first + j < r1 ? dot : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_next = fmaxf(m[g], mx);
      // a warp that has seen no row keeps m = -inf: subtract 0 instead
      const float m_safe = m_next == -INFINITY ? 0.f : m_next;
      const float alpha = exp2f(m[g] - m_safe);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        // a row past the split's end is skipped, not multiplied by 0: it
        // may hold anything
        if (first + j < r1) {
          const float pr = exp2f(s[j] - m_safe);
          l[g] += pr;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][e] = fmaf(pr, split_float(vx[j].v[e]), acc[g][e]);
        }
      }
      m[g] = m_next;
    }
  }

  // the warps' partials, merged in warp order
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sh.m[warp][g] = m[g];
      sh.l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sh.acc[warp][g][col + e] = acc[g][e];
  }
  hopper::named_sync(kMergeBar, kConsumers);
  // with the append policy a block at posw = 0 walks no row: its partial
  // is empty and the fresh row alone makes the output
  const bool alone = Policy::kOn ? n_vis <= 1 : n_vis == 1;
  float* part =
      p.part + ((long long)row * p.n_splits + blockIdx.y) * G * (2 + D);
  for (int i = threadIdx.x; i < G * D; i += kConsumers) {
    const int g = i / D, d = i % D;
    // finite where the split holds a visible row
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, sh.m[w][g]);
    float ls = 0.f, as = 0.f;
    if constexpr (Policy::kOn) {
      const float m_safe = mx == -INFINITY ? 0.f : mx;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        const float f = exp2f(sh.m[w][g] - m_safe);
        ls = fmaf(sh.l[w][g], f, ls);
        as = fmaf(sh.acc[w][g][d], f, as);
      }
    } else {
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        const float f = exp2f(sh.m[w][g] - mx);
        ls = fmaf(sh.l[w][g], f, ls);
        as = fmaf(sh.acc[w][g][d], f, as);
      }
    }
    if (alone) {
      if constexpr (Policy::kOn)
        op[i] = split_cast<T>(pol.fold(g, d, mx, ls, as));
      else
        op[i] = split_cast<T>(as / ls);
    } else {
      float* pg = part + g * (2 + D);
      if (d == 0) {
        pg[0] = mx;
        pg[1] = ls;
      }
      pg[2 + d] = as;
    }
  }
  if (alone) return;

  // count this split done; the last of the row's splits merges them all
  __threadfence();
  hopper::named_sync(kMergeBar, kConsumers);
  if (threadIdx.x == 0)
    sh.last = atomicAdd(&p.count[row], 1) == n_vis - 1;
  hopper::named_sync(kMergeBar, kConsumers);
  if (!sh.last) return;
  __threadfence();
  const float* rp = p.part + (long long)row * p.n_splits * G * (2 + D);
  for (int i = threadIdx.x; i < G * D; i += kConsumers) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
    for (int s = 0; s < n_vis; ++s)
      mx = fmaxf(mx, __ldcg(rp + (s * G + g) * (2 + D)));
    float ls = 0.f, as = 0.f;
    for (int s = 0; s < n_vis; ++s) {
      const float* ps = rp + (s * G + g) * (2 + D);
      const float f = exp2f(__ldcg(ps) - mx);
      ls = fmaf(__ldcg(ps + 1), f, ls);
      as = fmaf(__ldcg(ps + 2 + d), f, as);
    }
    if constexpr (Policy::kOn)
      op[i] = split_cast<T>(pol.fold(g, d, mx, ls, as));
    else
      op[i] = split_cast<T>(as / ls);
  }
  if (threadIdx.x == 0) p.count[row] = 0;  // ready for the next call
}

}  // namespace
