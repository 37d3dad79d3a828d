// Selective-scan (S6) forward for Hopper (sm_90a), exact fp32 recurrence.
//
// Replaces the TPU kernel medmamba_tpu/ops/pallas_scan.py:787 (_fwd_kernel_ssd,
// launched by _fwd_pallas). Per batch b, channel d (group g = d / dpg) and
// state n, walking L in the group's direction:
//
//   dt_t = softplus(delta_t + bias_d)          (0 at t >= valid_len)
//   h_t  = exp(dt_t * A_dn) * h_{t-1} + dt_t * u_t * B_{g,n,t}
//   y_t  = sum_n C_{g,n,t} * h_t + D_d * u_t
//
// The TPU kernel's tau segments, exponent clip, short-L batch packing, chunk
// size and n-split answer TPU constraints (a sequential grid, the MXU) and are
// not carried over: this kernel computes the recurrence step by step, exactly
// as medmamba_tpu/ops/selective_scan.py:selective_scan_seq does.
//
// What bounds it on an H100. For medmamba_t at 224^2, batch 64 (one forward is
// 20 launches, G = 2, N = 16, D = 192/384/768/1536, L = 3136/784/196/49):
//   * bytes: u, delta and y in fp32 (B, D, L) plus B and C (B, G, N, L) come to
//     about 4.2 GB, about 1.25 ms at 3.35 TB/s;
//   * exponentials: one exp(dt * A) per (b, d, n, t), about 5.3e9, about
//     1.3 ms on the special-function units (132 SMs x 16 per clock).
// So the kernel is bound by memory and by exponentials in about equal measure.
//
// Design (simple first). One thread per (b, d, n): the N = 16 lanes of one
// channel hold its state in a register and reduce y over n with
// __shfl_xor_sync, so every input byte is read from device memory once and
// every exp is computed once. A block of 128 threads owns 8 channels of one
// group. It stages a tile of 64 time steps of u and dt (softplus computed once
// per (d, t) while staging, not once per lane) and of its group's B and C in
// shared memory with coalesced loads, walks the tile in the group's direction,
// collects y in shared memory and writes it back coalesced. A loop over tiles
// inside the block takes the place of the TPU's sequential grid axis. Shared
// rows are padded to 65 floats so that the 16 lanes reading B[n][t] and
// C[n][t] hit 16 different banks.
//
// With a non-null `states` the kernel also writes the float32 state at the
// entry of every 64-step tile, (b, G*dpg, n_tiles, 16) in processing order
// (tile k is the k-th tile the group's direction visits), as the TPU forward
// writes its chunk states for the backward. The backward kernel
// (selective_scan_bwd.cu) recomputes each tile's states from them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kN = 16;                 // state size = lanes per channel
constexpr int kThreads = 128;
constexpr int kCh = kThreads / kN;     // channels per block
constexpr int kT = 64;                 // time steps per tile
constexpr int kP = kT + 1;             // padded shared-memory pitch

struct Params {
  const void* u;
  const void* delta;
  const float* A;
  const void* B;
  const void* C;
  const float* D;       // may be null
  const float* bias;    // may be null
  void* y;
  float* last;          // may be null
  float* states;        // may be null: (b, G*dpg, n_tiles, 16) tile entries
  int groups;
  int u_groups;
  int dpg;
  int L;
  int valid_len;
  int softplus;
  int rev_mask;         // bit g set: group g scans right to left
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const Params p) {
  __shared__ float s_u[kCh][kP];
  __shared__ float s_dt[kCh][kP];
  __shared__ float s_B[kN][kP];
  __shared__ float s_C[kN][kP];
  __shared__ float s_y[kCh][kP];

  const int c0 = blockIdx.x * kCh;      // first channel of the block in its group
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lc = tid / kN;              // the thread's channel in the block
  const int n = tid % kN;               // the thread's state index
  const int n_ch = min(kCh, p.dpg - c0);
  const bool active = lc < n_ch;
  const int L = p.L;
  const int d_all = p.groups * p.dpg;
  const int d0 = g * p.dpg + c0;        // first channel of the block overall
  const bool rev = (p.rev_mask >> g) & 1;

  // group g reads u group g mod u_groups (u_tile: no duplicated u buffer)
  const Tin* u_base = static_cast<const Tin*>(p.u) +
      ((size_t)(b * p.u_groups + g % p.u_groups) * p.dpg + c0) * L;
  const Tin* dl_base = static_cast<const Tin*>(p.delta) +
      ((size_t)b * d_all + d0) * L;
  const Tin* B_base = static_cast<const Tin*>(p.B) +
      ((size_t)b * p.groups + g) * kN * L;
  const Tin* C_base = static_cast<const Tin*>(p.C) +
      ((size_t)b * p.groups + g) * kN * L;
  Tout* y_base = static_cast<Tout*>(p.y) + ((size_t)b * d_all + d0) * L;

  const float a_n = active ? p.A[(size_t)(d0 + lc) * kN + n] : 0.f;
  const float d_skip = (active && p.D != nullptr) ? p.D[d0 + lc] : 0.f;
  float h = 0.f;

  const int n_tiles = (L + kT - 1) / kT;
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = (rev ? n_tiles - 1 - k : k) * kT;
    const int len = min(kT, L - t0);
    if (p.states != nullptr && active) {
      p.states[(((size_t)b * d_all + d0 + lc) * n_tiles + k) * kN + n] = h;
    }

    for (int i = tid; i < kCh * kT; i += kThreads) {
      const int cc = i / kT;
      const int tt = i % kT;
      float uv = 0.f;
      float dv = 0.f;
      if (cc < n_ch && tt < len) {
        const size_t off = (size_t)cc * L + t0 + tt;
        uv = to_f(u_base[off]);
        dv = to_f(dl_base[off]);
        if (p.bias != nullptr) dv += p.bias[d0 + cc];
        // torch's softplus (threshold 20), with the accurate expf/log1pf
        if (p.softplus) dv = dv > 20.f ? dv : log1pf(expf(dv));
        if (t0 + tt >= p.valid_len) dv = 0.f;   // pad: decay 1, inject 0
      }
      s_u[cc][tt] = uv;
      s_dt[cc][tt] = dv;
    }
    for (int i = tid; i < kN * kT; i += kThreads) {
      const int nn = i / kT;
      const int tt = i % kT;
      float bv = 0.f;
      float cv = 0.f;
      if (tt < len) {
        const size_t off = (size_t)nn * L + t0 + tt;
        bv = to_f(B_base[off]);
        cv = to_f(C_base[off]);
      }
      s_B[nn][tt] = bv;
      s_C[nn][tt] = cv;
    }
    __syncthreads();

    // len is the same for the whole block, so every lane reaches each shuffle
    for (int j = 0; j < len; ++j) {
      const int tt = rev ? len - 1 - j : j;
      const float dt = s_dt[lc][tt];
      const float uv = s_u[lc][tt];
      h = expf(dt * a_n) * h + dt * uv * s_B[n][tt];
      float v = h * s_C[n][tt];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (n == 0) s_y[lc][tt] = v + d_skip * uv;
    }
    __syncthreads();

    for (int i = tid; i < kCh * kT; i += kThreads) {
      const int cc = i / kT;
      const int tt = i % kT;
      if (cc < n_ch && tt < len) {
        y_base[(size_t)cc * L + t0 + tt] = from_f<Tout>(s_y[cc][tt]);
      }
    }
    // the next tile's staging overwrites s_u/s_dt/s_B/s_C only after every
    // thread passed the barrier above, and s_y only after the next barrier
  }

  if (p.last != nullptr && active) {
    p.last[((size_t)b * d_all + d0 + lc) * kN + n] = h;
  }
}

template <typename Tin, typename Tout>
void launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.dpg + kCh - 1) / kCh, p.groups, batch);
  scan_fwd_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 when it was accepted), or cudaErrorInvalidValue for arguments the
// kernel does not take. Launches on `stream` and does not synchronise.
extern "C" int medmamba_selective_scan_fwd(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* bias, void* y, void* last,
    void* states, int batch, int groups, int u_groups, int dpg, int n_state, int L,
    int valid_len, int softplus, int rev_mask, int in_dtype, int out_dtype,
    void* stream) {
  if (n_state != kN || batch < 1 || groups < 1 || groups > 30 ||
      u_groups < 1 || groups % u_groups != 0 || dpg < 1 || L < 1 ||
      batch > 65535 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1) {
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
  p.y = y;
  p.last = static_cast<float*>(last);
  p.states = static_cast<float*>(states);
  p.groups = groups;
  p.u_groups = u_groups;
  p.dpg = dpg;
  p.L = L;
  p.valid_len = valid_len;
  p.softplus = softplus;
  p.rev_mask = rev_mask;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) {
    launch<float, float>(p, batch, s);
  } else if (in_dtype == 0) {
    launch<float, __nv_bfloat16>(p, batch, s);
  } else if (out_dtype == 0) {
    launch<__nv_bfloat16, float>(p, batch, s);
  } else {
    launch<__nv_bfloat16, __nv_bfloat16>(p, batch, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
