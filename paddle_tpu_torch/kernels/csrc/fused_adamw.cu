// Fused AdamW update for Hopper (sm_90a): one elementwise pass over one
// parameter tensor, in place.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/fused_adamw.py
// (_adamw_kernel :25, launched by fused_adamw_update at :114).  Same
// function, in f32:
//   m = beta1 m + (1 - beta1) g
//   v = beta2 v + (1 - beta2) g g
//   p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)
// with bc1 = 1 - beta1^t and bc2 = 1 - beta2^t computed by the caller.
// p is the f32 master or the parameter itself (f32, bf16 or f16); g comes
// in its own dtype and is cast inside; m and v are f32.  With a master,
// the low-precision parameter is written in the same pass (`low`), as the
// reference's cast back (optimizer.py:117-118).
//
// What bounds it on an H100: a few flops per element against 26-28 bytes
// moved (read p, g, m, v; write p, m, v and the low copy): bytes, at
// 3.35 TB/s.  What the design does about that: every byte is touched
// once; each thread moves 4 elements per iteration with 16-byte loads
// and stores of m and v (8 or 16 bytes of p and g), in a grid-stride loop
// sized to a few waves of the card; a tail shorter than 4 elements, or a
// tensor whose pointers are not 16-byte aligned, takes the scalar loop.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

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

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

struct Scalars {
  float lr, beta1, beta2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Scalars& s) {
  m = s.beta1 * m + (1.f - s.beta1) * g;
  v = s.beta2 * v + (1.f - s.beta2) * g * g;
  const float mhat = m / s.bc1;
  const float vhat = v / s.bc2;
  p = p - s.lr * (mhat / (sqrtf(vhat) + s.eps) + s.wd * p);
}

// low: 0 none, 1 float16, 2 bfloat16
__device__ __forceinline__ void store_low(void* low, int low_dtype,
                                          long long i, float x) {
  if (low_dtype == 1)
    static_cast<__half*>(low)[i] = __float2half_rn(x);
  else if (low_dtype == 2)
    static_cast<__nv_bfloat16*>(low)[i] = __float2bfloat16_rn(x);
}

template <typename L>
__device__ __forceinline__ void store_low4(void* low, long long i,
                                           const float x[4]) {
  Vec<L, 4> o;
#pragma unroll
  for (int e = 0; e < 4; ++e) o.v[e] = from_float<L>(x[e]);
  reinterpret_cast<Vec<L, 4>*>(low)[i] = o;
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v, void* low,
             int low_dtype, long long n, Scalars s, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = first; i < n4; i += stride) {
    Vec<P, 4> pv = reinterpret_cast<const Vec<P, 4>*>(p)[i];
    const Vec<G, 4> gv = reinterpret_cast<const Vec<G, 4>*>(g)[i];
    float4 mv = reinterpret_cast<const float4*>(m)[i];
    float4 vv = reinterpret_cast<const float4*>(v)[i];
    float pf[4], mf[4] = {mv.x, mv.y, mv.z, mv.w},
                 vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pf[e] = to_float(pv.v[e]);
      adamw(pf[e], to_float(gv.v[e]), mf[e], vf[e], s);
      pv.v[e] = from_float<P>(pf[e]);
    }
    reinterpret_cast<Vec<P, 4>*>(p)[i] = pv;
    reinterpret_cast<float4*>(m)[i] = make_float4(mf[0], mf[1], mf[2], mf[3]);
    reinterpret_cast<float4*>(v)[i] = make_float4(vf[0], vf[1], vf[2], vf[3]);
    if (low_dtype == 1)
      store_low4<__half>(low, i, pf);
    else if (low_dtype == 2)
      store_low4<__nv_bfloat16>(low, i, pf);
  }
  for (long long i = n4 * 4 + first; i < n; i += stride) {
    float pf = to_float(p[i]), mf = m[i], vf = v[i];
    adamw(pf, to_float(g[i]), mf, vf, s);
    p[i] = from_float<P>(pf);
    m[i] = mf;
    v[i] = vf;
    store_low(low, low_dtype, i, pf);
  }
}

template <typename P, typename G>
cudaError_t launch(void* p, const void* g, float* m, float* v, void* low,
                   int low_dtype, long long n, const Scalars& s, int vec,
                   cudaStream_t stream) {
  const long long work = vec ? (n + 3) / 4 : n;
  const long long blocks =
      std::min<long long>((work + kThreads - 1) / kThreads, 132LL * 16);
  adamw_kernel<P, G><<<dim3((unsigned)blocks), dim3(kThreads), 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m, v, low, low_dtype, n,
      s, vec);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_g(int g_dtype, void* p, const void* g, float* m, float* v,
                     void* low, int low_dtype, long long n, const Scalars& s,
                     int vec, cudaStream_t stream) {
  switch (g_dtype) {
    case 0: return launch<P, float>(p, g, m, v, low, low_dtype, n, s, vec,
                                    stream);
    case 1: return launch<P, __half>(p, g, m, v, low, low_dtype, n, s, vec,
                                     stream);
    case 2: return launch<P, __nv_bfloat16>(p, g, m, v, low, low_dtype, n, s,
                                            vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16; low_dtype 0 means no
// low-precision copy (low may then be null).  vec = 1 when p, g, m, v and
// low all start on 16-byte boundaries.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fused_adamw_launch(void* p, const void* g, float* m, float* v,
                                  void* low, int p_dtype, int g_dtype,
                                  int low_dtype, long long n, float lr,
                                  float beta1, float beta2, float eps,
                                  float wd, float bc1, float bc2, int vec,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  if (low_dtype < 0 || low_dtype > 2) return cudaErrorInvalidValue;
  const Scalars s{lr, beta1, beta2, eps, wd, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p_dtype) {
    case 0: return launch_g<float>(g_dtype, p, g, m, v, low, low_dtype, n, s,
                                   vec, st);
    case 1: return launch_g<__half>(g_dtype, p, g, m, v, low, low_dtype, n,
                                    s, vec, st);
    case 2: return launch_g<__nv_bfloat16>(g_dtype, p, g, m, v, low,
                                           low_dtype, n, s, vec, st);
    default: return cudaErrorInvalidValue;
  }
}
