// Selective-scan (S6) forward for Hopper (sm_90a) by parallel doubling over
// time inside 128-step chunks: the MEDMAMBA_SCAN_KERNEL=hillis forward.
//
// Replaces the TPU kernel medmamba_tpu/ops/pallas_scan.py:877 (_fwd_kernel,
// launched by _fwd_pallas, its within-chunk scan _fwd_chunk_scan). Per batch b,
// channel d (group g = d / dpg) and state n, left to right:
//
//   dt_t = softplus(delta_t + bias_d)      (delta_t + bias_d without softplus)
//   a_t  = exp(dt_t * A_dn),  b_t = dt_t * u_t * B_{g,n,t}
//                             (a_t = 1 and b_t = 0 at t >= valid_len)
//   h_t  = a_t * h_{t-1} + b_t
//   y_t  = sum_n C_{g,n,t} * h_t + D_d * u_t          (y always float32)
//
// It also writes the float32 state entering every 128-step chunk,
// (b, G*dpg, ceil(L/128), 16), which the backward (selective_scan_hillis_bwd.cu)
// recomputes each chunk from, and the state after the last step (b, G*dpg, 16).
// The scan itself runs in one direction only; the wrapper flips reverse groups.
//
// What bounds it on an H100. For medmamba_t at 224^2, batch 64 (one forward is
// 20 launches, G = 2, N = 16, D = 192/384/768/1536, L = 3136/784/196/49):
// u, delta and y in fp32 (B, D, L) plus B and C (B, G, N, L) come to about
// 4.2 GB, about 1.26 ms at 3.35 TB/s, the same bytes as the sequential forward;
// one exp per (b, d, n, t) is about 1.3 ms on the special-function units. The
// doubling itself costs work the sequential form does not: 7 levels of one
// multiply-add and one multiply for each (b, d, n, t), against one step, so
// about 28 fp32 operations per (b, d, n, t) where the recurrence needs 7.
// chip_smoke.py prints both counts beside the bound.
//
// Design (simple first). A block of 512 threads owns 4 channels of one group;
// each channel has 128 threads, one per time step of a chunk, and each thread
// holds the 16 states of its channel at its step in registers, so y_t is
// reduced over n inside the thread with no shuffles. The block walks the
// chunks in order. Per chunk it stages its group's B and C in shared memory
// (coalesced over t, shared by the 4 channels), forms (a_t, b_t) for the 16
// states, and composes them by Kogge-Stone doubling, x_t += acc_t * x_{t-s},
// acc_t *= acc_{t-s} for s = 1..16, with __shfl_up_sync inside each warp. The
// four warps of a channel are then joined through shared memory: each warp's
// last lane posts its (acc, x), and each thread folds the chunk's entry state
// through the earlier warps' pairs (at most three multiply-adds per state)
// and applies the result, h_t = x_t + acc_t * H. The state after the chunk
// (the last thread's h, exact through the identity pads of a short chunk) is
// carried to the next chunk in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kN = 16;                 // state size
constexpr int kT = 128;                // chunk: one thread per time step
constexpr int kCh = 4;                 // channels per block
constexpr int kThreads = kT * kCh;
constexpr int kWarps = kT / 32;        // warps per channel
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const void* u;
  const void* delta;
  const float* A;
  const void* B;
  const void* C;
  const float* D;       // may be null
  const float* bias;    // may be null
  float* y;             // (b, G*dpg, L)
  float* states;        // (b, G*dpg, n_chunks, 16): state entering each chunk
  float* last;          // (b, G*dpg, 16)
  int groups;
  int dpg;
  int L;
  int valid_len;
  int softplus;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
hillis_fwd_kernel(const Params p) {
  __shared__ float s_B[kN][kT];
  __shared__ float s_C[kN][kT];
  __shared__ float s_A[kCh][kN];
  __shared__ float s_h[kCh][kN];             // state entering the chunk
  __shared__ float s_acc[kCh][kWarps][kN];   // each warp's composed decay
  __shared__ float s_x[kCh][kWarps][kN];     // each warp's composed input

  const int tid = threadIdx.x;
  const int ch = tid / kT;              // the thread's channel in the block
  const int t = tid % kT;               // its step in the chunk
  const int lane = tid % 32;
  const int w = t / 32;                 // its warp in the channel
  const int c0 = blockIdx.x * kCh;      // first channel of the block in its group
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_ch = min(kCh, p.dpg - c0);
  const bool active = ch < n_ch;
  const int L = p.L;
  const int d_all = p.groups * p.dpg;
  const int d = g * p.dpg + c0 + ch;    // the thread's channel overall
  const int n_chunks = (L + kT - 1) / kT;

  const size_t row = ((size_t)b * d_all + d) * L;
  const Tin* u_row = static_cast<const Tin*>(p.u) + row;
  const Tin* dl_row = static_cast<const Tin*>(p.delta) + row;
  const size_t bc_off = ((size_t)b * p.groups + g) * kN * L;
  const Tin* B_base = static_cast<const Tin*>(p.B) + bc_off;
  const Tin* C_base = static_cast<const Tin*>(p.C) + bc_off;
  float* y_row = p.y + row;
  float* st_base = p.states + ((size_t)b * d_all + d) * n_chunks * kN;

  if (tid < kCh * kN) {
    const int cc = tid / kN;
    const int nn = tid % kN;
    s_A[cc][nn] = cc < n_ch ? p.A[(size_t)(g * p.dpg + c0 + cc) * kN + nn]
                            : 0.f;
    s_h[cc][nn] = 0.f;
  }
  const float d_skip = (active && p.D != nullptr) ? p.D[d] : 0.f;
  const float bias = (active && p.bias != nullptr) ? p.bias[d] : 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kT;
    const int pos = t0 + t;
    for (int i = tid; i < kN * kT; i += kThreads) {
      const int nn = i / kT;
      const int tt = i % kT;
      float bv = 0.f;
      float cv = 0.f;
      if (t0 + tt < L) {
        const size_t off = (size_t)nn * L + t0 + tt;
        bv = to_f(B_base[off]);
        cv = to_f(C_base[off]);
      }
      s_B[nn][tt] = bv;
      s_C[nn][tt] = cv;
    }
    float uv = 0.f;
    float dtv = 0.f;
    if (active && pos < L) {
      uv = to_f(u_row[pos]);
      float xv = to_f(dl_row[pos]) + bias;
      // torch's softplus (threshold 20), with the accurate expf/log1pf
      if (p.softplus) xv = xv > 20.f ? xv : log1pf(expf(xv));
      dtv = xv;
    }
    const bool live = active && pos < p.valid_len;   // valid_len <= L
    __syncthreads();   // (1) B, C staged; s_h holds the chunk's entry state

    if (active && t < kN) st_base[(size_t)c * kN + t] = s_h[ch][t];

    float x[kN];
    float acc[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc[n] = live ? expf(dtv * s_A[ch][n]) : 1.f;
      x[n] = live ? dtv * uv * s_B[n][t] : 0.f;
    }
    // Kogge-Stone inside the warp: afterwards (acc, x) composes the steps
    // from the warp's first lane to this one
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float xs = __shfl_up_sync(kAll, x[n], s);
        const float as = __shfl_up_sync(kAll, acc[n], s);
        if (lane >= s) {
          x[n] = fmaf(acc[n], xs, x[n]);
          acc[n] *= as;
        }
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        s_acc[ch][w][n] = acc[n];
        s_x[ch][w][n] = x[n];
      }
    }
    __syncthreads();   // (2) every warp's composition posted

    float yv = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      // the state entering this warp: the chunk's entry state carried
      // through the earlier warps of the channel
      float hin = s_h[ch][n];
#pragma unroll
      for (int v = 0; v < kWarps - 1; ++v) {
        if (v < w) hin = fmaf(s_acc[ch][v][n], hin, s_x[ch][v][n]);
      }
      x[n] = fmaf(acc[n], hin, x[n]);            // h_t
      yv = fmaf(s_C[n][t], x[n], yv);
    }
    if (active && pos < L) y_row[pos] = yv + d_skip * uv;
    __syncthreads();   // (3) s_h, s_acc, s_x, s_B, s_C read by all

    if (active && t == kT - 1) {
      // past the last step every (a, b) is the identity, so the last
      // thread's state is the state after the chunk's last real step
#pragma unroll
      for (int n = 0; n < kN; ++n) s_h[ch][n] = x[n];
      if (c == n_chunks - 1) {
        float* last = p.last + ((size_t)b * d_all + d) * kN;
#pragma unroll
        for (int n = 0; n < kN; ++n) last[n] = x[n];
      }
    }
  }
}

template <typename Tin>
void launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.dpg + kCh - 1) / kCh, p.groups, batch);
  hillis_fwd_kernel<Tin><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for u, delta, B and C; y, states and
// last are float32. Returns cudaGetLastError() after the launch (0 when it was
// accepted), or cudaErrorInvalidValue for arguments the kernel does not take.
// Launches on `stream` and does not synchronise.
extern "C" int medmamba_selective_scan_hillis_fwd(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* bias, void* y, void* states,
    void* last, int batch, int groups, int dpg, int n_state, int L,
    int valid_len, int softplus, int in_dtype, void* stream) {
  if (n_state != kN || batch < 1 || batch > 65535 || groups < 1 ||
      groups > 65535 || dpg < 1 || L < 1 || valid_len < 0 || valid_len > L ||
      in_dtype < 0 || in_dtype > 1 || y == nullptr || states == nullptr ||
      last == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.u = u;
  p.delta = delta;
  p.A = static_cast<const float*>(A);
  p.B = B;
  p.C = C;
  p.D = static_cast<const float*>(D);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.states = static_cast<float*>(states);
  p.last = static_cast<float*>(last);
  p.groups = groups;
  p.dpg = dpg;
  p.L = L;
  p.valid_len = valid_len;
  p.softplus = softplus;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    launch<float>(p, batch, s);
  } else {
    launch<__nv_bfloat16>(p, batch, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
