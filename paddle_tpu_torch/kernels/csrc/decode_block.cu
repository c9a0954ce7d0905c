// Decode block for Hopper (sm_90a): one transformer layer's decode step
// (one token per batch slot) as a short chain of fused kernels.
//
// Replaces the two Pallas TPU kernels of paddle_tpu/kernels/decode_block.py:
//  * _attn_kernel (decode_block_attn): norm1 -> q/k/v projection -> bias ->
//    rotary -> q * scale -> the fresh K/V row stored in the slab dtype at
//    posw = min(pos, S - 1) -> online-softmax attention over the rows
//    kpos < posw, the fresh row (read back in the storage dtype) last;
//  * _mlp_kernel (decode_block_mlp): xm = x + attn wo + bo -> h = norm2(xm)
//    -> t = h w1 + b1 -> gelu_tanh(t) | gelu(t) | silu(h wg) * t ->
//    y = xm + act w2 + b2, cast once.
// Every projection multiplies in f32 with the weights upcast; xn, h and
// the activations stay f32 (never rounded to bf16), as on the TPU.
//
// What bounds it on an H100: at decode every product is a stream of
// matrix-vector work over B <= 16 rows, a few operations per weight byte
// against the ~295 the card needs to be compute-bound, so both halves are
// bound by the bytes of the weights and of the live K/V rows (3.35 TB/s).
//
// What the design does about that.  The TPU grid runs in order on one core
// and carries the attention group's weights and the MLP accumulator in VMEM
// from step to step; CUDA blocks run at once and share nothing.  So:
//  * the GEMV of gemv.cuh (shared with the sharded block's ring hops):
//    every projection is one launch over column strips of the output for
//    up to 16 batch rows, each weight byte read once for all rows; the
//    input transform (norm with the row statistics, or silu(g) * t)
//    applied as the inputs land, sums in f32 with one cast, the merge of
//    K splits in split order by the last of them (deterministic), and an
//    epilogue that adds the residual and the bias and applies the
//    activation.  bf16 weights stream through a ring of TMA stages into
//    the tensor cores (gemv_stream_kernel: the bound is the weight bytes,
//    and the ring keeps them in flight); f32 weights take the split-K
//    gemv_kernel.
//  * row_stats_kernel: the two-pass mean / variance (or mean square) of
//    each row that a norm needs, once per layer input, so that each
//    projection block does not reread the whole row.
//  * attn_kernel: one block per (slot, kv head) with the rep = H / KH
//    query heads of the group; it applies rotary to q and the fresh k,
//    stores the fresh row, then streams the live rows in tiles of block_k
//    through shared memory.  The slot's position is read on the device.
//    A block reads only rows below posw and writes only row posw of its own
//    (slot, kv head), so blocks never race on the slab.
// decode_block_attn launches stats -> qkv gemv -> attention, and
// decode_block_mlp launches out-proj gemv -> stats -> up gemv -> down gemv,
// in stream order; every sum is deterministic (no atomics on data).
// Later work: the attention's split of long KV walks across blocks on a
// TMA ring (as decode_attention.cu's decode_split_kernel), and one
// persistent launch per half.

#include "gemv.cuh"

// Argument block of the attention entry point below, mirrored field for
// field by a ctypes structure in paddle_tpu_torch/kernels/decode_block.py
// (GemvArgs, the projections' block, is in gemv.cuh).

struct AttnArgs {
  const float* qkv;     // [B, ld_qkv] f32: q (H Dh) | k (KH Dh) | v (KH Dh),
                        // biases added, before rotary
  const float* cos;     // [B, Dh] f32, or null (no rotary)
  const float* sin;
  void* k_slab;         // [B, S, KH, Dh] T, element strides below
  void* v_slab;
  const int* pos;       // pos[b * pos_stride]: cache length before the step
  void* out;            // [B, H Dh] T, contiguous
  long long ld_qkv;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, H, KH, Dh, S, block_k, pos_stride, dtype;
  float scale;
};

namespace {

constexpr int kStage = 4;         // K/V vectors in flight per thread

// sum over the block, the same order in every thread (red: kWarps floats)
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();  // an earlier call's readers are done with red
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// ------------------------------------------------------------ row stats
// stats[2 r] = mean (0 for RMS), stats[2 r + 1] = rsqrt(var + eps), with the
// variance taken about the mean in a second pass (RMS: the mean square).
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const Tin* in, float* stats, long long ld, int K, int rms,
                 float eps) {
  __shared__ float red[kWarps];
  const Tin* x = in + blockIdx.x * ld;
  float mu = 0.f;
  if (!rms) {
    float s = 0.f;
    for (int k = threadIdx.x; k < K; k += kThreads) s += to_float(x[k]);
    mu = block_sum(s, red) / K;
  }
  float s2 = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float d = to_float(x[k]) - mu;
    s2 = fmaf(d, d, s2);
  }
  s2 = block_sum(s2, red) / K;
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = mu;
    stats[2 * blockIdx.x + 1] = rsqrtf(s2 + eps);
  }
}

// ------------------------------------------------------------ attention
// the largest power-of-two team (<= 32 lanes) that keeps `items` work
// items x team within the block, so short loops still use every thread
__device__ __forceinline__ int team_size(int items) {
  int team = 1;
  while (team < 32 && items * team * 2 <= kThreads) team *= 2;
  return team;
}

// sum over the `team` consecutive lanes of a team (all lanes take part)
__device__ __forceinline__ float team_sum(float v, int team) {
  for (int off = 1; off < team; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// one online-softmax step over nr keys at kp (row stride ldk) and values
// at vp (row stride ldv) for the block's rep query heads
__device__ void attn_update(const AttnArgs& a, int rep, const float* q_s,
                            const float* kp, int ldk, const float* vp,
                            int ldv, int nr, float* p_s, float* acc_s,
                            float* m_s, float* l_s, float* al_s) {
  const int Dh = a.Dh, BK = a.block_k;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // scores: a team of lanes per (head, key), splitting the dot over d
  {
    const int team = team_size(rep * BK), m = tid % team;
    const int per = kThreads / team;
    for (int base = 0; base < rep * nr; base += per) {
      const int i = base + tid / team;
      float s = 0.f;
      if (i < rep * nr) {
        const float* qh = q_s + (i / nr) * Dh;
        const float* kj = kp + (i % nr) * ldk;
        for (int d = m; d < Dh; d += team) s = fmaf(qh[d], kj[d], s);
      }
      s = team_sum(s, team);
      if (i < rep * nr && m == 0) p_s[(i / nr) * BK + i % nr] = s;
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
  // acc = acc * alpha + P V: a team of lanes per output, splitting the keys
  {
    const int team = team_size(rep * Dh), m = tid % team;
    const int per = kThreads / team;
    for (int base = 0; base < rep * Dh; base += per) {
      const int i = base + tid / team;
      float o = 0.f;
      if (i < rep * Dh) {
        const float* ph = p_s + (i / Dh) * BK;
        const int d = i % Dh;
        for (int j = m; j < nr; j += team) o = fmaf(ph[j], vp[j * ldv + d], o);
      }
      o = team_sum(o, team);
      if (i < rep * Dh && m == 0) acc_s[i] = acc_s[i] * al_s[i / Dh] + o;
    }
  }
  __syncthreads();
}

// The work every attention block starts with, for block (slot b, kv head
// kvh): the group's rep query heads with rotary (rotate_half by direct
// indexing) and the scale into q_s [rep][Dh]; the fresh k (rotary) and v
// stored into the slabs in the slab dtype at posw = min(pos, S - 1), and
// kept as stored in kn_s / vn_s so that the fold sees the storage rounding.
// Returns posw.  Ends before a barrier the caller places.
template <typename T>
__device__ int attn_prologue(const AttnArgs& a, int rep, float* q_s,
                             float* kn_s, float* vn_s) {
  const int Dh = a.Dh, half = a.Dh / 2, tid = threadIdx.x;
  const int b = blockIdx.x / a.KH, kvh = blockIdx.x % a.KH;
  const int pos = a.pos[(long long)b * a.pos_stride];
  const int posw = max(0, min(pos, a.S - 1));
  const float* qkv = a.qkv + b * a.ld_qkv;
  const float* cs = a.cos ? a.cos + (long long)b * Dh : nullptr;
  const float* sn = a.sin ? a.sin + (long long)b * Dh : nullptr;
  for (int i = tid; i < rep * Dh; i += kThreads) {
    const int h = i / Dh, d = i % Dh;
    const float* qh = qkv + (kvh * rep + h) * Dh;
    float v = qh[d];
    if (cs) {
      const float r = d < half ? -qh[d + half] : qh[d - half];
      v = v * cs[d] + r * sn[d];
    }
    q_s[i] = v * a.scale;
  }
  const float* kf = qkv + a.H * Dh + kvh * Dh;
  const float* vf = qkv + (a.H + a.KH) * Dh + kvh * Dh;
  T* kdst = static_cast<T*>(a.k_slab) + b * a.k_sb + posw * a.k_ss +
            kvh * a.k_sh;
  T* vdst = static_cast<T*>(a.v_slab) + b * a.v_sb + posw * a.v_ss +
            kvh * a.v_sh;
  for (int d = tid; d < Dh; d += kThreads) {
    float kv = kf[d];
    if (cs) {
      const float r = d < half ? -kf[d + half] : kf[d - half];
      kv = kv * cs[d] + r * sn[d];
    }
    const T kt = from_float<T>(kv), vt = from_float<T>(vf[d]);
    kdst[d] = kt;
    vdst[d] = vt;
    kn_s[d] = to_float(kt);
    vn_s[d] = to_float(vt);
  }
  return posw;
}

// Head dims 64 and 128, up to 8 query heads per kv head, block_k = 64: the
// live rows stream through registers, not shared memory.  Each warp takes
// every 8th group of kFastRows rows; a lane holds D / 32 elements of each
// query head, of the accumulators and of kFastRows K and V rows, which it
// loads before using any (many bytes in flight per SM, each row read once).
// Dot products reduce across the warp by shuffles, each warp keeps its own
// online softmax per head, warp 0 folds in the fresh row, and the eight
// partial softmaxes merge once through shared memory.
constexpr int kFastRows = 8;
constexpr int kFastBlockK = kWarps * kFastRows;   // rows per block per pass

template <typename T, int N>
struct alignas(sizeof(T) * N) VecN {
  T v[N];
};

template <typename T, int D, int REP>
__global__ void __launch_bounds__(kThreads) attn_fast_kernel(const AttnArgs a) {
  constexpr int E = D / 32;               // elements of a row per lane
  using RowV = VecN<T, E>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [REP][D]
  float* kn_s = q_s + REP * D;            // [D]
  float* vn_s = kn_s + D;                 // [D]
  float* acc_w = vn_s + D;                // [kWarps][REP][D]
  float* m_w = acc_w + kWarps * REP * D;  // [kWarps][REP]
  float* l_w = m_w + kWarps * REP;        // [kWarps][REP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / a.KH, kvh = blockIdx.x % a.KH;
  const int posw = attn_prologue<T>(a, REP, q_s, kn_s, vn_s);
  __syncthreads();

  float q[REP][E], acc[REP][E], m[REP], l[REP];
#pragma unroll
  for (int h = 0; h < REP; ++h) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      q[h][e] = q_s[h * D + lane * E + e];
      acc[h][e] = 0.f;
    }
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
  const T* kb = static_cast<const T*>(a.k_slab) + b * a.k_sb + kvh * a.k_sh +
                lane * E;
  const T* vb = static_cast<const T*>(a.v_slab) + b * a.v_sb + kvh * a.v_sh +
                lane * E;

  for (long long r0 = (long long)warp * kFastRows; r0 < posw;
       r0 += kFastBlockK) {
    RowV kr[kFastRows], vr[kFastRows];
#pragma unroll
    for (int j = 0; j < kFastRows; ++j) {
      const long long row = r0 + j;
      if (row < posw) {
        kr[j] = *reinterpret_cast<const RowV*>(kb + row * a.k_ss);
        vr[j] = *reinterpret_cast<const RowV*>(vb + row * a.v_ss);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kr[j].v[e] = from_float<T>(0.f);
          vr[j].v[e] = from_float<T>(0.f);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < REP; ++h) {
      float s[kFastRows];
#pragma unroll
      for (int j = 0; j < kFastRows; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(q[h][e], to_float(kr[j].v[e]), dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(kFull, dot, off);
        s[j] = r0 + j < posw ? dot : -INFINITY;
      }
      float mx = s[0];
#pragma unroll
      for (int j = 1; j < kFastRows; ++j) mx = fmaxf(mx, s[j]);
      const float m_next = fmaxf(m[h], mx);
      const float m_safe = m_next == -INFINITY ? 0.f : m_next;
      const float alpha = expf(m[h] - m_safe);
      float ps = 0.f, pv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) pv[e] = 0.f;
#pragma unroll
      for (int j = 0; j < kFastRows; ++j) {
        const float p = expf(s[j] - m_safe);
        ps += p;
#pragma unroll
        for (int e = 0; e < E; ++e) pv[e] = fmaf(p, to_float(vr[j].v[e]), pv[e]);
      }
      l[h] = alpha * l[h] + ps;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] = acc[h][e] * alpha + pv[e];
      m[h] = m_next;
    }
  }
  if (warp == 0) {                        // the fresh row, always valid
#pragma unroll
    for (int h = 0; h < REP; ++h) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(q[h][e], kn_s[lane * E + e], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      const float m_next = fmaxf(m[h], dot);
      const float alpha = expf(m[h] - m_next);
      const float p = expf(dot - m_next);
      l[h] = alpha * l[h] + p;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[h][e] = acc[h][e] * alpha + p * vn_s[lane * E + e];
      m[h] = m_next;
    }
  }
#pragma unroll
  for (int h = 0; h < REP; ++h) {
    if (lane == 0) {
      m_w[warp * REP + h] = m[h];
      l_w[warp * REP + h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc_w[(warp * REP + h) * D + lane * E + e] = acc[h][e];
  }
  __syncthreads();
  T* op = static_cast<T*>(a.out) + (long long)b * a.H * D + kvh * REP * D;
  for (int i = tid; i < REP * D; i += kThreads) {
    const int h = i / D;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_w[w * REP + h]);
    const float m_safe = m_all == -INFINITY ? 0.f : m_all;
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w * REP + h] - m_safe);
      l_all = fmaf(l_w[w * REP + h], f, l_all);
      a_all = fmaf(acc_w[(w * REP + h) * D + i % D], f, a_all);
    }
    op[i] = from_float<T>(a_all / (l_all == 0.f ? 1.f : l_all));
  }
}

// Any head dim that is a multiple of 8 up to 256, any rep and block_k: the
// live rows stream through shared memory in tiles of block_k.
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_kernel(const AttnArgs a) {
  constexpr int VE = Vec<T>::N;
  extern __shared__ __align__(16) float smem[];
  const int Dh = a.Dh, BK = a.block_k, rep = a.H / a.KH;
  float* q_s = smem;                      // [rep][Dh]
  float* acc_s = q_s + rep * Dh;          // [rep][Dh]
  float* k_s = acc_s + rep * Dh;          // [BK][Dh + 1]
  float* v_s = k_s + BK * (Dh + 1);       // [BK][Dh]
  float* p_s = v_s + BK * Dh;             // [rep][BK]
  float* kn_s = p_s + rep * BK;           // [Dh]
  float* vn_s = kn_s + Dh;                // [Dh]
  float* m_s = vn_s + Dh;                 // [rep]
  float* l_s = m_s + rep;                 // [rep]
  float* al_s = l_s + rep;                // [rep]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.KH, kvh = blockIdx.x % a.KH;
  const int posw = attn_prologue<T>(a, rep, q_s, kn_s, vn_s);
  for (int i = tid; i < rep * Dh; i += kThreads) acc_s[i] = 0.f;
  for (int h = tid; h < rep; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  __syncthreads();

  // stream the live rows kpos < posw in tiles of BK, never the dead tail
  const T* kb = static_cast<const T*>(a.k_slab) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v_slab) + b * a.v_sb + kvh * a.v_sh;
  const int vpr = Dh / VE;                // 16-byte vectors per row
  for (int t0 = 0; t0 < posw; t0 += BK) {
    const int nr = min(BK, posw - t0);
    const int nv = nr * vpr;
    for (int i0 = tid; i0 < nv; i0 += kThreads * kStage) {
      Vec<T> kx[kStage], vx[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nv) {
          const long long row = t0 + i / vpr;
          const int c = (i % vpr) * VE;
          kx[u] = load_vec<T>(kb + row * a.k_ss + c);
          vx[u] = load_vec<T>(vb + row * a.v_ss + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nv) {
          const int r = i / vpr, c = (i % vpr) * VE;
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            k_s[r * (Dh + 1) + c + e] = to_float(kx[u].v[e]);
            v_s[r * Dh + c + e] = to_float(vx[u].v[e]);
          }
        }
      }
    }
    __syncthreads();
    attn_update(a, rep, q_s, k_s, Dh + 1, v_s, Dh, nr, p_s, acc_s, m_s, l_s,
                al_s);
  }
  // the fresh token folds in last, always valid
  attn_update(a, rep, q_s, kn_s, Dh, vn_s, Dh, 1, p_s, acc_s, m_s, l_s,
              al_s);

  T* op = static_cast<T*>(a.out) + (long long)b * a.H * Dh + kvh * rep * Dh;
  for (int i = tid; i < rep * Dh; i += kThreads) {
    const float l = l_s[i / Dh];
    op[i] = from_float<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D, int REP>
cudaError_t launch_attn_fast(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)REP * D + 2 * D +
                                       (size_t)kWarps * REP * D +
                                       2 * (size_t)kWarps * REP);
  static std::atomic<unsigned long long> smem_set{0};
  static const size_t cap = dynamic_cap(attn_fast_kernel<T, D, REP>);
  cudaError_t err =
      hopper::allow_smem(attn_fast_kernel<T, D, REP>, cap, smem_set);
  if (err != cudaSuccess) return err;
  attn_fast_kernel<T, D, REP>
      <<<dim3(a.B * a.KH), dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_attn_rep(const AttnArgs& a, int rep, cudaStream_t stream) {
  switch (rep) {
    case 1: return launch_attn_fast<T, D, 1>(a, stream);
    case 2: return launch_attn_fast<T, D, 2>(a, stream);
    case 4: return launch_attn_fast<T, D, 4>(a, stream);
    case 8: return launch_attn_fast<T, D, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_attn(const AttnArgs& a, cudaStream_t stream) {
  const int rep = a.H / a.KH;
  if (a.block_k == kFastBlockK && (a.Dh == 64 || a.Dh == 128) &&
      (rep == 1 || rep == 2 || rep == 4 || rep == 8))
    return a.Dh == 64 ? launch_attn_rep<T, 64>(a, rep, stream)
                      : launch_attn_rep<T, 128>(a, rep, stream);
  const size_t smem =
      sizeof(float) * ((size_t)2 * rep * a.Dh + (size_t)a.block_k * (a.Dh + 1) +
                       (size_t)a.block_k * a.Dh + (size_t)rep * a.block_k +
                       2 * (size_t)a.Dh + 3 * (size_t)rep);
  static std::atomic<unsigned long long> smem_set{0};
  static const size_t cap = dynamic_cap(attn_kernel<T>);
  cudaError_t err = hopper::allow_smem(attn_kernel<T>, cap, smem_set);
  if (err != cudaSuccess) return err;
  attn_kernel<T><<<dim3(a.B * a.KH), dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the
// cudaError_t of the launch (0 on success); the Python wrapper raises on
// anything else.  dtype: 0 float32, 2 bfloat16.

extern "C" int decode_block_row_stats(const void* in, float* stats,
                                      long long ld, int rows, int K,
                                      int dtype, int rms, float eps,
                                      void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      row_stats_kernel<float><<<rows, kThreads, 0, s>>>(
          static_cast<const float*>(in), stats, ld, K, rms, eps);
      break;
    case 2:
      row_stats_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(in), stats, ld, K, rms, eps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int decode_block_gemv(const GemvArgs* args, void* stream) {
  return gemv_entry(*args, stream);
}
extern "C" int decode_block_attention(const AttnArgs* args, void* stream) {
  const AttnArgs& a = *args;
  if (a.B <= 0) return cudaSuccess;
  if (a.KH <= 0 || a.H % a.KH || a.Dh <= 0 || a.Dh % 8 || a.Dh > 256 ||
      a.S <= 0 || a.block_k <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.dtype) {
    case 0: return launch_attn<float>(a, s);
    case 2: return launch_attn<__nv_bfloat16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
