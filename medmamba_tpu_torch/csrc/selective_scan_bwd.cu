// Selective-scan (S6) backward for Hopper (sm_90a), the exact fp32 adjoint.
//
// Replaces the TPU kernel medmamba_tpu/ops/pallas_scan.py:1139
// (_bwd_kernel_ssd, launched by _bwd_pallas). The forward it differentiates is
// selective_scan_fwd.cu (K1): per batch b, channel d (group g = d / dpg) and
// state n, walking L in the group's direction,
//
//   x_t  = delta_t + bias_d,   dt_t = softplus(x_t)   (0 at t >= valid_len)
//   a_t  = exp(dt_t * A_dn)
//   h_t  = a_t * h_{t-1} + dt_t * u_t * B_{g,n,t}
//   y_t  = sum_n C_{g,n,t} * h_t + D_d * u_t.
//
// Given gy, the adjoint of h, walked against the scan direction, is
//
//   dh_t = C_t * gy_t + a_{t+1} * dh_{t+1}
//
// and the gradients are
//
//   du_t     = sum_n dh_t * dt_t * B_t + D * gy_t
//   ddt_t    = sum_n dh_t * (h_{t-1} * a_t * A + u_t * B_t)
//   ddelta_t = ddt_t * softplus'(x_t)            (0 at t >= valid_len)
//   dB_t[n]  = sum_{d in g} dh_t * dt_t * u_t,   dC_t[n] = sum_{d in g} h_t * gy_t
//   dA[d,n]  = sum_{b,t} dh_t * h_{t-1} * a_t * dt_t
//   dD[d]    = sum_{b,t} gy_t * u_t,             dbias[d] = sum_{b,t} ddelta_t.
//
// softplus' is torch's: sigmoid(x) below the threshold 20, 1 above it. The
// TPU kernel's tau-segment factorisation and exponent clip (_part_bwd) are
// TPU workarounds and are not carried over: this is the exact adjoint.
//
// What bounds it on an H100. For medmamba_t at 224^2, batch 64 (one training
// step is 20 launches): reading u, delta and gy and writing du and ddelta,
// five fp32 (B, D, L) arrays, plus B, C, dB and dC, four (B, G, N, L), come
// to about 7.5 GB per step, about 2.2 ms at 3.35 TB/s. The adjoint needs
// about 19 fp32 operations (an FMA counted as 2) and one exponential per
// (b, d, n, t): about 1.5 ms at 67 TFLOP/s, and about 1.25 ms of
// exponentials on the special-function units. So the bytes bound it. This
// kernel computes the exponential twice (to recompute h, and again in the
// walk) and sums du, ddt, dB and dC through shuffle trees, work beyond that
// need (chip_smoke.py's k2_costs counts only the need).
//
// Design (simple first), mirroring K1. One thread per (b, d, n); a block of
// 128 threads owns 8 channels of one group. The block walks the 64-step tiles
// opposite to the scan direction. For each tile it stages u, dt, softplus',
// gy, B and C in shared memory (softplus computed once per (d, t)), loads the
// tile's entry state that K1 wrote, and recomputes the 64 states of the tile
// into registers (a fully unrolled loop, so the array stays in registers).
// It then walks the tile backwards with dh carried in a register from tile to
// tile. du and ddt are reduced over the 16 lanes of a channel with shuffles.
// dB and dC are reduced over the block's 8 channels in shared memory (a
// shuffle over the two channels of a warp, then shared-memory atomics over
// the four warps) and added to a zeroed fp32 buffer with one global atomic per
// (n, t) and block. dA, dD and dbias are summed over the block's tiles in
// registers and added with one global atomic per (d, n) or d and block. The
// atomics make the order of those sums vary from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kN = 16;                 // state size = lanes per channel
constexpr int kThreads = 128;
constexpr int kCh = kThreads / kN;     // channels per block
constexpr int kT = 64;                 // time steps per tile: K1's tile
constexpr int kP = kT + 1;             // padded shared-memory pitch
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const void* u;
  const void* delta;
  const float* A;
  const void* B;
  const void* C;
  const float* D;       // may be null
  const float* bias;    // may be null
  const float* states;  // (b, G*dpg, n_tiles, 16), from K1
  const void* gy;
  void* du;             // (b, G*dpg, L): per scan group, in the input type
  void* ddelta;         // (b, G*dpg, L), in the input type
  float* dA;            // (G*dpg, 16), zeroed
  float* dB;            // (b, G, 16, L), zeroed
  float* dC;            // (b, G, 16, L), zeroed
  float* dD;            // (G*dpg,), zeroed; may be null
  float* dbias;         // (G*dpg,), zeroed; may be null
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

// Tin: u, delta, B, C and the gradients du, ddelta. Tg: gy (y's type).
template <typename Tin, typename Tg>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const Params p) {
  __shared__ float s_u[kCh][kP];
  __shared__ float s_dt[kCh][kP];
  __shared__ float s_sig[kCh][kP];     // softplus'(x); 0 at t >= valid_len
  __shared__ float s_gy[kCh][kP];
  __shared__ float s_B[kN][kP];
  __shared__ float s_C[kN][kP];
  __shared__ float s_du[kCh][kP];
  __shared__ float s_ddt[kCh][kP];
  __shared__ float s_dB[kT][kN + 1];
  __shared__ float s_dC[kT][kN + 1];

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
  const int n_tiles = (L + kT - 1) / kT;

  const size_t d_off = ((size_t)b * d_all + d0) * L;
  const size_t bc_off = ((size_t)b * p.groups + g) * kN * L;
  const Tin* u_base = static_cast<const Tin*>(p.u) +
      ((size_t)(b * p.u_groups + g % p.u_groups) * p.dpg + c0) * L;
  const Tin* dl_base = static_cast<const Tin*>(p.delta) + d_off;
  const Tg* gy_base = static_cast<const Tg*>(p.gy) + d_off;
  const Tin* B_base = static_cast<const Tin*>(p.B) + bc_off;
  const Tin* C_base = static_cast<const Tin*>(p.C) + bc_off;
  Tin* du_base = static_cast<Tin*>(p.du) + d_off;
  Tin* ddl_base = static_cast<Tin*>(p.ddelta) + d_off;
  float* dB_base = p.dB + bc_off;
  float* dC_base = p.dC + bc_off;
  const float* st_base =
      p.states + ((size_t)b * d_all + d0 + lc) * n_tiles * kN + n;

  const float a_n = active ? p.A[(size_t)(d0 + lc) * kN + n] : 0.f;
  const float d_skip = (active && p.D != nullptr) ? p.D[d0 + lc] : 0.f;

  float hp[kT];          // h before each step of the tile, in processing order
  float carry = 0.f;     // a_{t+1} * dh_{t+1}, carried from tile to tile
  float acc_dA = 0.f;
  float acc_dD = 0.f;    // lane n == 0 only
  float acc_db = 0.f;    // lane n == 0 only

  for (int i = tid; i < kT * (kN + 1); i += kThreads) {
    (&s_dB[0][0])[i] = 0.f;
    (&s_dC[0][0])[i] = 0.f;
  }

  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = (rev ? n_tiles - 1 - k : k) * kT;
    const int len = min(kT, L - t0);

    for (int i = tid; i < kCh * kT; i += kThreads) {
      const int cc = i / kT;
      const int tt = i % kT;
      float uv = 0.f;
      float dv = 0.f;
      float sg = 0.f;
      float gv = 0.f;
      if (cc < n_ch && tt < len) {
        const size_t off = (size_t)cc * L + t0 + tt;
        uv = to_f(u_base[off]);
        gv = to_f(gy_base[off]);
        float x = to_f(dl_base[off]);
        if (p.bias != nullptr) x += p.bias[d0 + cc];
        if (p.softplus) {
          // torch's softplus (threshold 20) and its derivative
          dv = x > 20.f ? x : log1pf(expf(x));
          sg = x > 20.f ? 1.f : 1.f / (1.f + expf(-x));
        } else {
          dv = x;
          sg = 1.f;
        }
        if (t0 + tt >= p.valid_len) {   // pad: dt is the constant 0
          dv = 0.f;
          sg = 0.f;
        }
      }
      s_u[cc][tt] = uv;
      s_dt[cc][tt] = dv;
      s_sig[cc][tt] = sg;
      s_gy[cc][tt] = gv;
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

    // recompute the tile's states from its entry state (K1's arithmetic)
    float h = active ? st_base[(size_t)k * kN] : 0.f;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < len) {
        const int tt = rev ? len - 1 - j : j;
        hp[j] = h;
        const float dt = s_dt[lc][tt];
        h = expf(dt * a_n) * h + dt * s_u[lc][tt] * s_B[n][tt];
      }
    }

    // walk the tile backwards; len is the same for the whole block, so
    // every lane reaches each shuffle
#pragma unroll
    for (int j = kT - 1; j >= 0; --j) {
      if (j < len) {
        const int tt = rev ? len - 1 - j : j;
        const float dt = s_dt[lc][tt];
        const float uv = s_u[lc][tt];
        const float gv = s_gy[lc][tt];
        const float bv = s_B[n][tt];
        const float cv = s_C[n][tt];
        const float a = expf(dt * a_n);
        const float h_prev = hp[j];
        const float h_t = a * h_prev + dt * uv * bv;
        const float dh = cv * gv + carry;
        carry = a * dh;
        const float ha = h_prev * a;
        acc_dA += dh * ha * dt;
        float v_du = dh * dt * bv;
        float v_ddt = dh * (ha * a_n + uv * bv);
        float v_dB = dh * dt * uv;
        float v_dC = h_t * gv;
#pragma unroll
        for (int m = kN / 2; m >= 1; m >>= 1) {
          v_du += __shfl_xor_sync(kAll, v_du, m);
          v_ddt += __shfl_xor_sync(kAll, v_ddt, m);
        }
        // the warp's two channels, then the block's four warps
        v_dB += __shfl_xor_sync(kAll, v_dB, kN);
        v_dC += __shfl_xor_sync(kAll, v_dC, kN);
        if ((lc & 1) == 0) {
          atomicAdd(&s_dB[tt][n], v_dB);
          atomicAdd(&s_dC[tt][n], v_dC);
        }
        if (n == 0) {
          const float ddl = v_ddt * s_sig[lc][tt];
          s_du[lc][tt] = v_du + d_skip * gv;
          s_ddt[lc][tt] = ddl;
          acc_dD += gv * uv;
          acc_db += ddl;
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < kCh * kT; i += kThreads) {
      const int cc = i / kT;
      const int tt = i % kT;
      if (cc < n_ch && tt < len) {
        const size_t off = (size_t)cc * L + t0 + tt;
        du_base[off] = from_f<Tin>(s_du[cc][tt]);
        ddl_base[off] = from_f<Tin>(s_ddt[cc][tt]);
      }
    }
    for (int i = tid; i < kN * kT; i += kThreads) {
      const int nn = i / kT;
      const int tt = i % kT;
      if (tt < len) {
        const size_t off = (size_t)nn * L + t0 + tt;
        atomicAdd(dB_base + off, s_dB[tt][nn]);
        atomicAdd(dC_base + off, s_dC[tt][nn]);
      }
      s_dB[tt][nn] = 0.f;
      s_dC[tt][nn] = 0.f;
    }
    // the next tile's staging writes only s_u/s_dt/s_sig/s_gy/s_B/s_C, which
    // nothing above reads; s_du/s_ddt/s_dB/s_dC are written again only after
    // the next staging barrier
  }

  if (active) {
    atomicAdd(p.dA + (size_t)(d0 + lc) * kN + n, acc_dA);
    if (n == 0) {
      if (p.dD != nullptr) atomicAdd(p.dD + d0 + lc, acc_dD);
      if (p.dbias != nullptr) atomicAdd(p.dbias + d0 + lc, acc_db);
    }
  }
}

template <typename Tin, typename Tg>
void launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.dpg + kCh - 1) / kCh, p.groups, batch);
  scan_bwd_kernel<Tin, Tg><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; in_dtype is that of u, delta, B, C
// (and of du and ddelta), gy_dtype that of gy. dA, dB, dC, dD and dbias are
// float32 buffers the caller zeroed. Returns cudaGetLastError() after the
// launch (0 when it was accepted), or cudaErrorInvalidValue for arguments the
// kernel does not take. Launches on `stream` and does not synchronise.
extern "C" int medmamba_selective_scan_bwd(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* bias, const void* states,
    const void* gy, void* du, void* ddelta, void* dA, void* dB, void* dC,
    void* dD, void* dbias, int batch, int groups, int u_groups, int dpg,
    int n_state, int L, int valid_len, int softplus, int rev_mask,
    int in_dtype, int gy_dtype, void* stream) {
  if (n_state != kN || batch < 1 || groups < 1 || groups > 30 ||
      u_groups < 1 || groups % u_groups != 0 || dpg < 1 || L < 1 ||
      batch > 65535 || in_dtype < 0 || in_dtype > 1 || gy_dtype < 0 ||
      gy_dtype > 1 || states == nullptr) {
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
  p.states = static_cast<const float*>(states);
  p.gy = gy;
  p.du = du;
  p.ddelta = ddelta;
  p.dA = static_cast<float*>(dA);
  p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC);
  p.dD = static_cast<float*>(dD);
  p.dbias = static_cast<float*>(dbias);
  p.groups = groups;
  p.u_groups = u_groups;
  p.dpg = dpg;
  p.L = L;
  p.valid_len = valid_len;
  p.softplus = softplus;
  p.rev_mask = rev_mask;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && gy_dtype == 0) {
    launch<float, float>(p, batch, s);
  } else if (in_dtype == 0) {
    launch<float, __nv_bfloat16>(p, batch, s);
  } else if (gy_dtype == 0) {
    launch<__nv_bfloat16, float>(p, batch, s);
  } else {
    launch<__nv_bfloat16, __nv_bfloat16>(p, batch, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
