// Elementwise issue-rate probe for Hopper (sm_90a): K chained operations per
// element of a large array, float32 or packed bfloat16.
//
// Replaces the TPU kernel tools/probe_vpu.py:21 (make_kernel, launched by
// pl.pallas_call at :89), which asks whether the scan kernels' time is an
// issue-rate wall or an implementation gap. Per element x, with the
// multiplier m, the addend a and the scale s passed in at run time (so that
// nvcc cannot fold a chain away, in bfloat16 where m rounds to 1.0 least of
// all), and K a compile-time count:
//
//   chain: K times x = x * m + a                 (one FMA each)
//   mul:   K times x = x * m
//   mul8:  c_q = x + q for q < 8; K/8 times c_q *= m; x = c_0 + ... + c_7
//   par4:  c_q = x + q for q < 4 (c_0 = x); K/4 times c_q = c_q * m + a;
//          x = c_0 + c_1 + c_2 + c_3
//   exp:   K times x = exp(x * s)
//   mix:   (float32 only) K/15 iterations of the scan kernel's mix of
//          multiplies, a clip, two exponentials, a select on the column
//          (column < 64) and a window of six live values, as the TPU probe
//          writes it
//
// Each product and sum rounds once, in the operands' type; chain and par4
// fuse the multiply-add, which the plain version rounds twice (at most one
// unit in the last place per step). float32 takes one element per thread;
// bfloat16 takes two adjacent elements per thread as __nv_bfloat162 and
// issues the packed instructions (HFMA2/HMUL2/HADD2 on bf16x2), except exp,
// which each element takes in float32 (expf) and rounds back.
//
// What bounds it on an H100: at the probe's size (16384 x 512) the array is
// 32 MiB in float32 each way, about 20 us at 3.35 TB/s. K = 64 float32 FMAs
// per element take about 16 us at 67 TFLOP/s, so chain, mul, mul8 and par4
// sit near the crossover of bytes and issue; exp (the special-function
// units, 16 per clock per SM) and mix at K = 150 are issue-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
enum Mode { kChain = 0, kMul = 1, kMul8 = 2, kPar4 = 3, kExp = 4, kMix = 5 };

struct F32 {
  using T = float;
  static __device__ __forceinline__ T splat(float v) { return v; }
  static __device__ __forceinline__ T add(T x, T y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ T mul(T x, T y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ T fma(T x, T y, T z) {
    return __fmaf_rn(x, y, z);
  }
  static __device__ __forceinline__ T exp(T x) { return expf(x); }
};

struct Bf16x2 {
  using T = __nv_bfloat162;
  static __device__ __forceinline__ T splat(float v) {
    return __float2bfloat162_rn(v);
  }
  static __device__ __forceinline__ T add(T x, T y) { return __hadd2(x, y); }
  static __device__ __forceinline__ T mul(T x, T y) { return __hmul2(x, y); }
  static __device__ __forceinline__ T fma(T x, T y, T z) {
    return __hfma2(x, y, z);
  }
  static __device__ __forceinline__ T exp(T x) {
    const float2 f = __bfloat1622float2(x);
    return __floats2bfloat162_rn(expf(f.x), expf(f.y));
  }
};

template <class V, int MODE, int K>
__global__ void __launch_bounds__(kThreads)
probe_vpu_kernel(const typename V::T* __restrict__ x,
                 typename V::T* __restrict__ out, size_t n, float m_in,
                 float a_in, float s_in) {
  using T = typename V::T;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const T m = V::splat(m_in), a = V::splat(a_in), s = V::splat(s_in);
  T v = x[i];
  if constexpr (MODE == kChain) {
#pragma unroll
    for (int j = 0; j < K; ++j) v = V::fma(v, m, a);
  } else if constexpr (MODE == kMul) {
#pragma unroll
    for (int j = 0; j < K; ++j) v = V::mul(v, m);
  } else if constexpr (MODE == kMul8) {
    T c[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) c[q] = V::add(v, V::splat((float)q));
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) c[q] = V::mul(c[q], m);
    }
    v = c[0];
#pragma unroll
    for (int q = 1; q < 8; ++q) v = V::add(v, c[q]);
  } else if constexpr (MODE == kPar4) {
    T c0 = v, c1 = V::add(v, V::splat(1.f)), c2 = V::add(v, V::splat(2.f)),
      c3 = V::add(v, V::splat(3.f));
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      c0 = V::fma(c0, m, a);
      c1 = V::fma(c1, m, a);
      c2 = V::fma(c2, m, a);
      c3 = V::fma(c3, m, a);
    }
    v = V::add(V::add(V::add(c0, c1), c2), c3);
  } else if constexpr (MODE == kExp) {
#pragma unroll
    for (int j = 0; j < K; ++j) v = V::exp(V::mul(v, s));
  }
  out[i] = v;
}

// The TPU probe's "mix" (tools/probe_vpu.py:55-81), float32. lane is the
// element's column; the TPU block spans every column, so it is the lane
// index there too.
template <int K>
__global__ void __launch_bounds__(kThreads)
probe_mix_kernel(const float* __restrict__ x, float* __restrict__ out,
                 size_t n, int cols, float m, float a, float s) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  const bool low_lane = (int)(i % (size_t)cols) < 64;
  float av = xv;
  float bv = __fadd_rn(__fmul_rn(xv, 1.1f), 1.0f);
  float live[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) live[q] = __fadd_rn(xv, (float)(q * 0.1));
#pragma unroll
  for (int it = 0; it < K / 15; ++it) {
    float g = __fmul_rn(av, bv);
    g = fminf(fmaxf(g, -80.f), 80.f);
    const float e = expf(__fmul_rn(g, s));
    const float f = expf(__fmul_rn(-s, g));
    const float w = __fmul_rn(f, live[0]);
    const float gg = __fadd_rn(w, live[1]);
    const float h = __fmul_rn(e, __fmaf_rn(f, live[2], gg));
    const float sel = low_lane ? h : e;
    av = __fmaf_rn(sel, m, a);
    bv = __fmul_rn(bv, 0.999999f);
#pragma unroll
    for (int q = 0; q < 5; ++q) live[q] = live[q + 1];
    live[5] = __fmul_rn(h, 1e-3f);
  }
  float acc = __fadd_rn(av, bv);
#pragma unroll
  for (int q = 0; q < 6; ++q) acc = __fmaf_rn(live[q], s, acc);
  out[i] = acc;
}

template <class V, int MODE, int K>
cudaError_t launch(const void* src, void* dst, size_t n, float m, float a,
                   float s, cudaStream_t stream) {
  const size_t blocks = (n + kThreads - 1) / kThreads;
  probe_vpu_kernel<V, MODE, K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const typename V::T*>(src),
      static_cast<typename V::T*>(dst), n, m, a, s);
  return cudaGetLastError();
}

template <class V>
cudaError_t dispatch(int mode, int k, const void* src, void* dst, size_t n,
                     float m, float a, float s, cudaStream_t stream) {
#define PROBE_CASE(MODE, K) \
  if (mode == MODE && k == K) return launch<V, MODE, K>(src, dst, n, m, a, s, stream);
  PROBE_CASE(kChain, 16) PROBE_CASE(kChain, 64)
  PROBE_CASE(kMul, 16) PROBE_CASE(kMul, 64)
  PROBE_CASE(kMul8, 16) PROBE_CASE(kMul8, 64)
  PROBE_CASE(kPar4, 16) PROBE_CASE(kPar4, 64)
  PROBE_CASE(kExp, 16) PROBE_CASE(kExp, 64)
#undef PROBE_CASE
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_mix(int k, const void* src, void* dst, size_t n,
                         int cols, float m, float a, float s,
                         cudaStream_t stream) {
  const size_t blocks = (n + kThreads - 1) / kThreads;
  const float* in = static_cast<const float*>(src);
  float* o = static_cast<float*>(dst);
  if (k == 60) {
    probe_mix_kernel<60><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, o, n, cols, m, a, s);
  } else if (k == 150) {
    probe_mix_kernel<150><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, o, n, cols, m, a, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// `iters` chained calls, each reading the previous one's output: call j
// reads buf0 when j is even and buf1 when it is odd, and writes the other
// (the TPU probe's fori_loop). rows x cols elements, float32 (dtype 0) or
// bfloat16 (dtype 1, cols even); mode as enum Mode; k one of 16 and 64, or
// 60 and 150 for mix (float32 only). Returns cudaGetLastError() after the
// launches (0 when they were accepted), or cudaErrorInvalidValue for
// arguments the kernel does not take. Launches on `stream` and does not
// synchronise.
extern "C" int medmamba_probe_vpu(void* buf0, void* buf1, long long rows,
                                  int cols, int mode, int dtype, int k,
                                  float m, float a, float s, int iters,
                                  void* stream) {
  if (rows < 1 || cols < 1 || iters < 1 || (dtype == 1 && cols % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elems = (size_t)rows * cols;
  const size_t n = dtype == 1 ? elems / 2 : elems;
  if ((n + kThreads - 1) / kThreads > 0x7fffffffu) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int j = 0; j < iters; ++j) {
    const void* src = j % 2 ? buf1 : buf0;
    void* dst = j % 2 ? buf0 : buf1;
    cudaError_t rc;
    if (mode == kMix) {
      rc = dtype == 0 ? dispatch_mix(k, src, dst, n, cols, m, a, s, st)
                      : cudaErrorInvalidValue;
    } else if (dtype == 0) {
      rc = dispatch<F32>(mode, k, src, dst, n, m, a, s, st);
    } else if (dtype == 1) {
      rc = dispatch<Bf16x2>(mode, k, src, dst, n, m, a, s, st);
    } else {
      rc = cudaErrorInvalidValue;
    }
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaSuccess;
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
