// Sharded decode block for Hopper (sm_90a): the per-shard work of one
// transformer layer's decode step under tensor parallelism, between the
// ring hops (copies between shards) that the Python ring drivers issue.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/kernels/decode_block_tp.py:
//  * _entry_kernel (one hop of ring_entry_matmul): out = x[B/tp, K] @
//    w_l[K, N_l] + b_l, f32 contraction, output cast once to x's dtype;
//  * _exit_kernel (one hop of ring_exit_matmul): part = act(y)[B/tp, K_l] @
//    w_l[K_l, N], act in {none, gelu_tanh, gelu, swiglu} applied as the
//    chunk is read (swiglu: silu(gate) * up with the gate in the chunk's
//    FIRST half), f32 accumulation, the partial cast once to y's dtype;
//    the arriving accumulator is added by the caller, in y's dtype;
//  * _attn_tp_kernel (decode_block_attn_tp): one shard's attention over
//    its kv-head group: rotary in f32 from full-width cos/sin tables, the
//    scale, the fresh K/V row stored in the slab dtype at
//    posw = min(pos, S - 1), online softmax over the live rows kpos < posw,
//    then the fresh row folded in last as stored.
//
// What bounds them on an H100.  A hop is a product of B/tp <= 8 rows (4
// at num_slots 8, tp 2) against a weight block streamed once: ~2 flops per
// weight byte against the ~295 the card needs to be compute-bound, so a
// hop is bound by its weight bytes at 3.35 TB/s (gpt3_6_7b at tp 2: the
// QKV hop streams 4096 x 6144 bf16 = 50.3 MB, 0.0150 ms; the down hop
// 8192 x 4096, 0.0200 ms).  The attention block is bound by the live K/V
// bytes of the shard's heads.
//
// What the design does about that.
//  * decode_block_tp_hop: both hops are one launch of the GEMV of
//    gemv.cuh, the kernel of the unsharded block's projections (bf16: the
//    TMA weight ring into the tensor cores, its column strips and K splits
//    planned per hop; f32: the split-K kernel); the exit activation is the
//    GEMV's input transform (in_mode 3 gate-first SwiGLU, 4 / 5 GeLU),
//    applied as the chunk lands, so act(y) never lands in device memory;
//    the bias (entry) and one cast come in its epilogue.
//  * attn_tp_kernel: one block per (slot, local kv head) with its rep
//    query heads (GQA reads kv head h / rep; nothing is repeated).  The
//    live rows stream in tiles of block_k rows through two shared-memory
//    stages filled by cp.async, the next tile in flight while the current
//    one is scored.  Each block reads only rows below posw and writes only
//    row posw of its own (slot, kv head), so blocks never race on a slab.
// Later work: the attention on a TMA ring, and the hops' copies overlapped
// with the next hop's product on a second stream.

#include "decode_split.cuh"
#include "gemv.cuh"

// Argument block of the attention entry point below, mirrored field for
// field by a ctypes structure in paddle_tpu_torch/kernels/decode_block_tp.py
// (the hops take gemv.cuh's GemvArgs).

struct TpAttnArgs {
  const void* q;        // [B, ld_q] T: the shard's H = KH * rep query heads
  const void* k;        // [B, ld_k] T: the shard's KH fresh k heads
  const void* v;        // [B, ld_v] T
  const float* cos;     // [B, Dh] f32, or null (no rotary)
  const float* sin;
  void* k_slab;         // [B, S, KH, Dh] T, element strides below
  void* v_slab;
  const int* pos;       // pos[b * pos_stride]: cache length before the step
  void* out;            // [B, H Dh] T, contiguous
  long long ld_q, ld_k, ld_v;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, H, KH, Dh, S, block_k, pos_stride, dtype;
  float scale;
  // the split kernel's (bf16, Dh 64 / 128): f32 partials [B KH groups,
  // ceil(S / split_rows), G, 2 + Dh] and int32 counters [B KH groups], 0
  // between calls (the kernel leaves them 0); null for the other kernel
  float* part;
  int* count;
  int split_rows;
};

namespace {

// ------------------------------------------------------------ attention
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One online-softmax step of the block's rep query heads over nr keys at
// kp and values at vp (rows of Dh elements of type KT).
template <typename KT>
__device__ void attn_step(int rep, int Dh, int BK, const float* q_s,
                          const KT* kp, const KT* vp, int nr, float* p_s,
                          float* acc_s, float* m_s, float* l_s,
                          float* al_s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // scores: a warp per key, its lanes splitting the dot over d
  for (int j = warp; j < nr; j += kWarps) {
    const KT* kj = kp + (long long)j * Dh;
    for (int h = 0; h < rep; ++h) {
      const float* qh = q_s + h * Dh;
      float s = 0.f;
      for (int d = lane; d < Dh; d += 32) s = fmaf(qh[d], to_float(kj[d]), s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) p_s[h * BK + j] = s;
    }
  }
  __syncthreads();
  for (int h = warp; h < rep; h += kWarps) {
    float* ph = p_s + h * BK;
    float mx = -INFINITY;
    for (int j = lane; j < nr; j += 32) mx = fmaxf(mx, ph[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float m_prev = m_s[h];
    const float m_next = fmaxf(m_prev, mx);
    const float m_safe = m_next == -INFINITY ? 0.f : m_next;
    float sum = 0.f;
    for (int j = lane; j < nr; j += 32) {
      const float p = expf(ph[j] - m_safe);
      ph[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    __syncwarp();
    if (lane == 0) {
      const float alpha = expf(m_prev - m_safe);
      l_s[h] = alpha * l_s[h] + sum;
      m_s[h] = m_next;
      al_s[h] = alpha;
    }
  }
  __syncthreads();
  // acc = acc * alpha + P V: a thread per output element
  for (int i = tid; i < rep * Dh; i += kThreads) {
    const int h = i / Dh, d = i % Dh;
    const float* ph = p_s + h * BK;
    float o = 0.f;
    for (int j = 0; j < nr; ++j) o = fmaf(ph[j], to_float(vp[(long long)j * Dh + d]), o);
    acc_s[i] = acc_s[i] * al_s[h] + o;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_tp_kernel(const TpAttnArgs a) {
  constexpr int VE = Vec<T>::N;           // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dh = a.Dh, BK = a.block_k, rep = a.H / a.KH, half = a.Dh / 2;
  T* kbuf = reinterpret_cast<T*>(smem_raw);            // [2][BK][Dh]
  T* vbuf = kbuf + 2 * BK * Dh;                        // [2][BK][Dh]
  float* q_s = reinterpret_cast<float*>(vbuf + 2 * BK * Dh);  // [rep][Dh]
  float* acc_s = q_s + rep * Dh;          // [rep][Dh]
  float* p_s = acc_s + rep * Dh;          // [rep][BK]
  float* kn_s = p_s + rep * BK;           // [Dh]
  float* vn_s = kn_s + Dh;                // [Dh]
  float* m_s = vn_s + Dh;                 // [rep]
  float* l_s = m_s + rep;                 // [rep]
  float* al_s = l_s + rep;                // [rep]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.KH, kvh = blockIdx.x % a.KH;
  const int pos = a.pos[(long long)b * a.pos_stride];
  const int posw = max(0, min(pos, a.S - 1));
  const float* cs = a.cos ? a.cos + (long long)b * Dh : nullptr;
  const float* sn = a.sin ? a.sin + (long long)b * Dh : nullptr;

  // the group's query heads: rotary, then the scale
  const T* qg = static_cast<const T*>(a.q) + b * a.ld_q +
                (long long)kvh * rep * Dh;
  for (int i = tid; i < rep * Dh; i += kThreads) {
    const int h = i / Dh, d = i % Dh;
    const T* qh = qg + h * Dh;
    float v = to_float(qh[d]);
    if (cs) {
      const float r = d < half ? -to_float(qh[d + half])
                               : to_float(qh[d - half]);
      v = v * cs[d] + r * sn[d];
    }
    q_s[i] = v * a.scale;
    acc_s[i] = 0.f;
  }
  for (int h = tid; h < rep; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  // the fresh k (rotary) and v, stored at posw in the slab dtype and kept
  // as stored for the fold
  const T* kf = static_cast<const T*>(a.k) + b * a.ld_k + (long long)kvh * Dh;
  const T* vf = static_cast<const T*>(a.v) + b * a.ld_v + (long long)kvh * Dh;
  T* kdst = static_cast<T*>(a.k_slab) + b * a.k_sb + posw * a.k_ss +
            kvh * a.k_sh;
  T* vdst = static_cast<T*>(a.v_slab) + b * a.v_sb + posw * a.v_ss +
            kvh * a.v_sh;
  for (int d = tid; d < Dh; d += kThreads) {
    float kv = to_float(kf[d]);
    if (cs) {
      const float r = d < half ? -to_float(kf[d + half])
                               : to_float(kf[d - half]);
      kv = kv * cs[d] + r * sn[d];
    }
    const T kt = from_float<T>(kv), vt = vf[d];
    kdst[d] = kt;
    vdst[d] = vt;
    kn_s[d] = to_float(kt);
    vn_s[d] = to_float(vt);
  }

  // stream the live rows kpos < posw in tiles of BK, double-buffered
  const T* kb = static_cast<const T*>(a.k_slab) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v_slab) + b * a.v_sb + kvh * a.v_sh;
  const int vpr = Dh / VE;                // 16-byte copies per row
  const int ntiles = (posw + BK - 1) / BK;
  auto load_tile = [&](int t) {
    const int r0 = t * BK, nr = min(BK, posw - r0), st = t & 1;
    for (int i = tid; i < nr * vpr; i += kThreads) {
      const int r = i / vpr, c = (i % vpr) * VE;
      cp_async16(kbuf + ((long long)st * BK + r) * Dh + c,
                 kb + (long long)(r0 + r) * a.k_ss + c);
      cp_async16(vbuf + ((long long)st * BK + r) * Dh + c,
                 vb + (long long)(r0 + r) * a.v_ss + c);
    }
    cp_async_commit();
  };
  if (ntiles > 0) load_tile(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long st = t & 1;
    attn_step<T>(rep, Dh, BK, q_s, kbuf + st * BK * Dh, vbuf + st * BK * Dh,
                 min(BK, posw - t * BK), p_s, acc_s, m_s, l_s, al_s);
  }
  // the fresh token folds in last, always valid, from its stored row
  attn_step<float>(rep, Dh, BK, q_s, kn_s, vn_s, 1, p_s, acc_s, m_s, l_s,
                   al_s);

  T* op = static_cast<T*>(a.out) + (long long)b * a.H * Dh +
          (long long)kvh * rep * Dh;
  for (int i = tid; i < rep * Dh; i += kThreads) {
    const float l = l_s[i / Dh];
    op[i] = from_float<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

// attn_tp_kernel's dynamic shared memory at the launch `a`
size_t attn_tp_kernel_smem(const TpAttnArgs& a) {
  const int rep = a.H / a.KH;
  const size_t es = a.dtype == 0 ? 4 : 2;
  return 2 * 2 * (size_t)a.block_k * a.Dh * es +
         sizeof(float) * (2 * (size_t)rep * a.Dh + (size_t)rep * a.block_k +
                          2 * (size_t)a.Dh + 3 * (size_t)rep);
}

template <typename T>
cudaError_t launch_attn_tp(const TpAttnArgs& a, cudaStream_t stream) {
  const size_t smem = attn_tp_kernel_smem(a);
  static std::atomic<unsigned long long> smem_set{0};
  static const size_t cap = dynamic_cap(attn_tp_kernel<T>);
  cudaError_t err = hopper::allow_smem(attn_tp_kernel<T>, cap, smem_set);
  if (err != cudaSuccess) return err;
  attn_tp_kernel<T><<<dim3(a.B * a.KH), dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}


// ------------------------------------------- attention, bf16, split KV
// decode_split.cuh's walk with the shard's append policy.  Grid (B x KH x
// head groups, ceil(S / split_rows)): sized from shapes, never from pos.
struct TpSplitParams {
  SplitParams s;          // slab maps, q, out, workspace (seq_lens unused)
  const void* k;          // [B, ld_k] T: the fresh k heads
  const void* v;          // [B, ld_v] T
  const float* cos;       // [B, Dh] f32, or null (no rotary)
  const float* sin;
  void* k_slab;           // [B, S, KH, Dh] T, element strides below
  void* v_slab;
  const int* pos;         // pos[b * pos_stride]
  long long ld_k, ld_v;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int pos_stride;
};

// the fresh row as stored (f32 of the slab dtype) and its score against
// each of the block's query heads (log2 units)
template <int G, int D>
struct TpShared {
  float k[D], v[D], s[G];
};

template <int G, int D>
constexpr size_t tp_split_smem() {
  return split_smem<G, D>() + sizeof(TpShared<G, D>);
}

template <typename T, int D, int G>
struct TpAppend {
  static constexpr bool kOn = true;
  static constexpr int E = D / 32;
  const TpSplitParams& a;
  TpShared<G, D>& sh;

  // the live rows kpos < posw, posw = min(pos, S - 1)
  __device__ __forceinline__ int end(const SplitParams& p, int b) const {
    return max(0, min(a.pos[(long long)b * a.pos_stride], p.S - 1));
  }

  // element d of row x after rotary (rotate_half by direct indexing), in
  // f32 rounded as the plain version rounds it: x cos + rot(x) sin
  __device__ __forceinline__ float rope(const T* x, int d, int b) const {
    const float v = split_float(x[d]);
    if (a.cos == nullptr) return v;
    const float r = d < D / 2 ? -split_float(x[d + D / 2])
                              : split_float(x[d - D / 2]);
    return __fadd_rn(__fmul_rn(v, a.cos[(long long)b * D + d]),
                     __fmul_rn(r, a.sin[(long long)b * D + d]));
  }

  // query head h's columns col .. col + E - 1: rotary, then the scale
  // (times log2 e: the walk's softmax runs in exp2)
  __device__ __forceinline__ void load_q(const SplitParams& p, int b, int h,
                                         int col, float (&q)[E]) const {
    const T* qh = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
#pragma unroll
    for (int e = 0; e < E; ++e) q[e] = rope(qh, col + e, b) * p.scale_log2;
  }

  // the fresh k (rotary) and v cast to the slab dtype: stored at posw by
  // the one writer of the (slot, kv head), split 0's first head group,
  // and kept as stored by every block; then each head's score of it
  __device__ __forceinline__ void prologue(const SplitParams& p, int b,
                                           int kvh, int group, int col,
                                           const float (&q)[G][E]) const {
    const bool writer = blockIdx.y == 0 && group == 0;
    const long long posw = end(p, b);
    const T* kf = static_cast<const T*>(a.k) + b * a.ld_k + (long long)kvh * D;
    const T* vf = static_cast<const T*>(a.v) + b * a.ld_v + (long long)kvh * D;
    for (int d = threadIdx.x; d < D; d += kSplitWarps * 32) {
      const T kt = split_cast<T>(rope(kf, d, b)), vt = vf[d];
      if (writer) {
        static_cast<T*>(a.k_slab)[b * a.k_sb + posw * a.k_ss + kvh * a.k_sh +
                                  d] = kt;
        static_cast<T*>(a.v_slab)[b * a.v_sb + posw * a.v_ss + kvh * a.v_sh +
                                  d] = vt;
      }
      sh.k[d] = split_float(kt);
      sh.v[d] = split_float(vt);
    }
    hopper::named_sync(kMergeBar, kSplitWarps * 32);
    if (threadIdx.x < 32) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(q[g][e], sh.k[col + e], dot);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kSplitFull, dot, o);
        if (threadIdx.x == 0) sh.s[g] = dot;
      }
    }
  }

  // the merged live rows (max mx, sum ls, output column as; mx = -inf
  // where there are none) with the fresh row folded in last
  __device__ __forceinline__ float fold(int g, int d, float mx, float ls,
                                        float as) const {
    const float sn = sh.s[g];
    const float mf = fmaxf(mx, sn);
    const float f = exp2f(mx - mf), pn = exp2f(sn - mf);
    return fmaf(pn, sh.v[d], as * f) / fmaf(ls, f, pn);
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kSplitThreads)
    attn_tp_split_kernel(const __grid_constant__ TpSplitParams a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  TpShared<G, D>& ts = *reinterpret_cast<TpShared<G, D>*>(
      smem + 2 * kSplitStages * (D / 64) * kSplitBox +
      sizeof(SplitShared<G, D>));
  const TpAppend<T, D, G> pol{a, ts};
  split_walk<T, D, G>(a.s, pol);
}

// The 4-D map of a [B, S, KH, Dh] bf16 slab (hopper::operand_map, 32-row
// boxes), encoded once per (pointer, shape, strides) and kept: the slabs
// of a serving pool come back at the same addresses every step.
struct SlabKey {
  const void* ptr;
  long long d, heads, seq, batch, sh, ss, sb;
  bool operator==(const SlabKey& o) const {
    return ptr == o.ptr && d == o.d && heads == o.heads && seq == o.seq &&
           batch == o.batch && sh == o.sh && ss == o.ss && sb == o.sb;
  }
};

struct SlabKeyHash {
  size_t operator()(const SlabKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (long long x : {k.d, k.heads, k.seq, k.batch, k.sh, k.ss, k.sb})
      h = h * 1000003u ^ std::hash<long long>()(x);
    return h;
  }
};

inline CUresult slab_map(CUtensorMap* map, const void* ptr, int d,
                         int heads, int seq, int batch, long long sh,
                         long long ss, long long sb) {
  const SlabKey key{ptr, d, heads, seq, batch, sh, ss, sb};
  return hopper::cached_map<SlabKey, SlabKeyHash>(
      map, key, [&](CUtensorMap* m) -> CUresult {
    return hopper::operand_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, d,
                               heads, seq, batch, sh, ss, sb, kSplitTile);
  });
}

template <int D, int G>
int launch_attn_tp_split(const TpAttnArgs& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  TpSplitParams p;
  std::memset(&p, 0, sizeof(p));
  CUresult r = slab_map(&p.s.k_map, a.k_slab, D, a.KH, a.S, a.B, a.k_sh,
                        a.k_ss, a.k_sb);
  if (r == CUDA_SUCCESS)
    r = slab_map(&p.s.v_map, a.v_slab, D, a.KH, a.S, a.B, a.v_sh, a.v_ss,
                 a.v_sb);
  if (r != CUDA_SUCCESS) return kTmaRefused + (int)r;
  p.s.q = a.q;
  p.s.out = a.out;
  p.s.part = a.part;
  p.s.count = a.count;
  p.s.q_sb = a.ld_q;
  p.s.q_sh = D;
  p.s.H = a.H;
  p.s.KVH = a.KH;
  p.s.S = a.S;
  p.s.split_rows = a.split_rows;
  p.s.n_splits = (a.S + a.split_rows - 1) / a.split_rows;
  p.s.scale_log2 = a.scale * 1.4426950408889634f;
  p.k = a.k;
  p.v = a.v;
  p.cos = a.cos;
  p.sin = a.sin;
  p.k_slab = a.k_slab;
  p.v_slab = a.v_slab;
  p.pos = a.pos;
  p.ld_k = a.ld_k;
  p.ld_v = a.ld_v;
  p.k_sb = a.k_sb;
  p.k_ss = a.k_ss;
  p.k_sh = a.k_sh;
  p.v_sb = a.v_sb;
  p.v_ss = a.v_ss;
  p.v_sh = a.v_sh;
  p.pos_stride = a.pos_stride;
  auto kernel = attn_tp_split_kernel<T, D, G>;
  constexpr size_t smem = tp_split_smem<G, D>();
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t attr = hopper::allow_smem(kernel, smem, smem_set);
  if (attr != cudaSuccess) return attr;
  const int rows = a.B * a.KH * (a.H / a.KH / G);
  kernel<<<dim3(rows, p.s.n_splits), dim3(kSplitThreads), smem, stream>>>(p);
  return cudaGetLastError();
}

// the split kernel's query heads a block: all 4 of a group of 4 (or 8),
// else 1, as decode_split_kernel's
template <int D>
int launch_attn_tp_split_g(const TpAttnArgs& a, cudaStream_t stream) {
  return (a.H / a.KH) % 4 == 0 ? launch_attn_tp_split<D, 4>(a, stream)
                               : launch_attn_tp_split<D, 1>(a, stream);
}

// bf16 rows of head_dim 64 or 128 take the split kernel; the rest (f32,
// other head dims: the slab is updated in place, so it is not padded)
// attn_tp_kernel
bool split_launch(const TpAttnArgs& a) {
  return a.dtype == 2 && (a.Dh == 64 || a.Dh == 128);
}

// dynamic shared memory of the launch `a` asks for
size_t attn_tp_smem(const TpAttnArgs& a) {
  if (!split_launch(a)) return attn_tp_kernel_smem(a);
  if ((a.H / a.KH) % 4 == 0)
    return a.Dh == 64 ? tp_split_smem<4, 64>() : tp_split_smem<4, 128>();
  return a.Dh == 64 ? tp_split_smem<1, 64>() : tp_split_smem<1, 128>();
}
}  // namespace

// Each entry point launches one kernel on `stream` and returns the
// cudaError_t of the launch (0 on success); the Python wrapper raises on
// anything else.
// dtype: 0 float32, 2 bfloat16.

extern "C" int decode_block_tp_hop(const GemvArgs* args, void* stream) {
  return gemv_entry(*args, stream);
}

extern "C" int decode_block_tp_attention(const TpAttnArgs* args,
                                         void* stream) {
  const TpAttnArgs& a = *args;
  if (a.B <= 0) return cudaSuccess;
  if (a.KH <= 0 || a.H % a.KH || a.Dh <= 0 || a.Dh % 8 || a.Dh > 256 ||
      a.S <= 0 || a.block_k <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_launch(a)) {
    if (a.part == nullptr || a.count == nullptr || a.split_rows <= 0 ||
        a.split_rows % kSplitTile)
      return cudaErrorInvalidValue;
    return a.Dh == 64 ? launch_attn_tp_split_g<64>(a, s)
                      : launch_attn_tp_split_g<128>(a, s);
  }
  switch (a.dtype) {
    case 0: return launch_attn_tp<float>(a, s);
    case 2: return launch_attn_tp<__nv_bfloat16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory the launch `args` would take (what
// kernels/decode_block_tp.py's plan must approve).
extern "C" long long decode_block_tp_attention_smem(const TpAttnArgs* args) {
  return (long long)attn_tp_smem(*args);
}
