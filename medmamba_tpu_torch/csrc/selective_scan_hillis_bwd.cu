// Selective-scan (S6) backward for Hopper (sm_90a) by parallel doubling over
// time inside 128-step chunks: the MEDMAMBA_SCAN_KERNEL=hillis backward.
//
// Replaces the TPU kernel medmamba_tpu/ops/pallas_scan.py:1275 (_bwd_kernel,
// launched by _bwd_pallas, its within-chunk scans _fwd_chunk_scan and
// _bwd_chunk_scan). The forward it differentiates is
// selective_scan_hillis_fwd.cu (K3):
//
//   x_t = delta_t + bias_d,  dt_t = softplus(x_t)  (x_t without softplus)
//   a_t = exp(dt_t * A_dn),  h_t = a_t * h_{t-1} + dt_t * u_t * B_{g,n,t}
//   y_t = sum_n C_{g,n,t} * h_t + D_d * u_t
//
// with a_t = 1 and b_t = 0 at t >= valid_len, where gy is taken as 0 and du
// and ddelta are 0, as the TPU kernel masks its last chunk. Given gy (float32,
// as y is), the adjoint of h solves, against the scan direction,
//
//   dh_t = C_t * gy_t + a_{t+1} * dh_{t+1}
//
// and the gradients are
//
//   du_t     = dt_t * sum_n dh_t B_t + D * gy_t
//   ddelta_t = (u_t * sum_n dh_t B_t + sum_n dh_t h_{t-1} a_t A) * softplus'(x_t)
//   dB_t[n]  = sum_{d in g} dh_t dt_t u_t,      dC_t[n] = sum_{d in g} h_t gy_t
//   dA[d,n]  = sum_{b,t} dh_t h_{t-1} a_t dt_t
//   dD[d]    = sum_{b,t} gy_t u_t,              dbias[d] = sum_{b,t} ddelta_t
//
// with softplus'(x) = sigmoid(x) (1 without softplus), as the TPU kernel has.
//
// What bounds it on an H100. For medmamba_t at 224^2, batch 64 (one training
// step is 20 launches): reading u, delta and gy and writing du and ddelta, five
// fp32 (B, D, L) arrays, plus B, C, dB and dC, four (B, G, N, L), come to about
// 7.5 GB per step, about 2.2 ms at 3.35 TB/s; the adjoint needs about 19 fp32
// operations per (b, d, n, t), about 1.5 ms at 67 TFLOP/s. So the bytes bound
// it. The two doublings (recompute and adjoint) cost 7 levels each of a
// multiply-add and a multiply per (b, d, n, t), work the sequential adjoint
// does not do.
//
// Design (simple first), the layout of K3. A block of 512 threads owns 4
// channels of one group, 128 threads per channel, one per time step of a
// chunk, each with its channel's 16 states in registers. The block walks the
// chunks from last to first. Per chunk it stages B and C in shared memory,
// recomputes h from the chunk's entry state that K3 saved (K3's doubling:
// Kogge-Stone with __shfl_up_sync inside each warp, the warps joined through
// shared memory), takes h_{t-1} from the neighbouring lane (the previous
// warp's last state through shared memory at a warp's first lane), and solves
// the adjoint by a suffix Kogge-Stone (X_t += P_t * X_{t+s}, P_t *= P_{t+s},
// __shfl_down_sync) on q_t = C_t gy_t and P_t = a_{t+1}, the warps joined
// from the right and the carry a_0 * dh_0 of the chunk after folded in last.
// du and ddelta are summed over n inside the thread. dB and dC are summed
// over the block's 4 channels with shared-memory atomics and added to zeroed
// float32 buffers with one global atomic per (n, t) and block. dA, dD and
// dbias stay in registers over the whole L and are reduced over the block
// (shuffles, then the four warps through shared memory) into one global
// atomic per (d, n) or d and block. The atomics make the order of those sums
// vary from run to run.

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
  const float* states;  // (b, G*dpg, n_chunks, 16), from K3
  const float* gy;      // (b, G*dpg, L)
  void* du;             // (b, G*dpg, L), in the input type
  void* ddelta;         // (b, G*dpg, L), in the input type
  float* dA;            // (G*dpg, 16), zeroed
  float* dB;            // (b, G, 16, L), zeroed
  float* dC;            // (b, G, 16, L), zeroed
  float* dD;            // (G*dpg,), zeroed; may be null
  float* dbias;         // (G*dpg,), zeroed; may be null
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

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
hillis_bwd_kernel(const Params p) {
  __shared__ float s_B[kN][kT];
  __shared__ float s_C[kN][kT];
  __shared__ float s_dB[kN][kT];             // summed over the block's channels
  __shared__ float s_dC[kN][kT];
  __shared__ float s_A[kCh][kN];
  __shared__ float s_carry[kCh][kN];         // a_0 * dh_0 of the chunk after
  __shared__ float s_pa[kCh][kWarps][kN];    // each warp's composed decay
  __shared__ float s_px[kCh][kWarps][kN];    // each warp's composed value
  __shared__ float s_hend[kCh][kWarps][kN];  // h at each warp's last lane
  __shared__ float s_a0[kCh][kWarps][kN];    // a at each warp's first lane
  __shared__ float s_red[kCh][kWarps][kN + 2];

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
  const float* gy_row = p.gy + row;
  Tin* du_row = static_cast<Tin*>(p.du) + row;
  Tin* ddl_row = static_cast<Tin*>(p.ddelta) + row;
  const size_t bc_off = ((size_t)b * p.groups + g) * kN * L;
  const Tin* B_base = static_cast<const Tin*>(p.B) + bc_off;
  const Tin* C_base = static_cast<const Tin*>(p.C) + bc_off;
  float* dB_base = p.dB + bc_off;
  float* dC_base = p.dC + bc_off;
  const float* st_base = p.states + ((size_t)b * d_all + d) * n_chunks * kN;

  if (tid < kCh * kN) {
    const int cc = tid / kN;
    const int nn = tid % kN;
    s_A[cc][nn] = cc < n_ch ? p.A[(size_t)(g * p.dpg + c0 + cc) * kN + nn]
                            : 0.f;
    s_carry[cc][nn] = 0.f;
  }
  for (int i = tid; i < kN * kT; i += kThreads) {
    (&s_dB[0][0])[i] = 0.f;
    (&s_dC[0][0])[i] = 0.f;
  }
  const float d_skip = (active && p.D != nullptr) ? p.D[d] : 0.f;
  const float bias = (active && p.bias != nullptr) ? p.bias[d] : 0.f;

  float acc_dA[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc_dA[n] = 0.f;
  float acc_dD = 0.f;
  float acc_db = 0.f;

  for (int c = n_chunks - 1; c >= 0; --c) {
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
    // past valid_len (and L) the step is the identity: dt, softplus' and
    // gy are taken as 0 there
    const bool live = active && pos < p.valid_len;   // valid_len <= L
    float uv = 0.f;
    float dtv = 0.f;
    float sig = 0.f;
    float gv = 0.f;
    if (live) {
      uv = to_f(u_row[pos]);
      gv = gy_row[pos];
      const float xv = to_f(dl_row[pos]) + bias;
      if (p.softplus) {
        // torch's softplus (threshold 20); sigmoid as the TPU kernel has
        dtv = xv > 20.f ? xv : log1pf(expf(xv));
        sig = 1.f / (1.f + expf(-xv));
      } else {
        dtv = xv;
        sig = 1.f;
      }
    }
    __syncthreads();   // (1) B, C staged; s_carry holds the chunk after's carry

    // recompute h_t from the chunk's entry state (K3's doubling)
    float a[kN];
    float x[kN];
    float acc[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      a[n] = live ? expf(dtv * s_A[ch][n]) : 1.f;
      acc[n] = a[n];
      x[n] = live ? dtv * uv * s_B[n][t] : 0.f;
    }
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
        s_pa[ch][w][n] = acc[n];
        s_px[ch][w][n] = x[n];
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < kN; ++n) s_a0[ch][w][n] = a[n];
    }
    __syncthreads();   // (2)

    const float* h0 = st_base + (size_t)c * kN;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      float hin = active ? h0[n] : 0.f;
#pragma unroll
      for (int v = 0; v < kWarps - 1; ++v) {
        if (v < w) hin = fmaf(s_pa[ch][v][n], hin, s_px[ch][v][n]);
      }
      x[n] = fmaf(acc[n], hin, x[n]);            // h_t
    }
    if (lane == 31) {
#pragma unroll
      for (int n = 0; n < kN; ++n) s_hend[ch][w][n] = x[n];
    }
    if (active) {
#pragma unroll
      for (int n = 0; n < kN; ++n) atomicAdd(&s_dC[n][t], x[n] * gv);
    }
    __syncthreads();   // (3) s_pa, s_px read; s_hend posted

    // ha = h_{t-1} * a_t, and P = a_{t+1} (1 past the chunk's end: the
    // chunk after enters through the carry)
    float ha[kN];
    float P[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      float hp = __shfl_up_sync(kAll, x[n], 1);
      if (lane == 0) {
        hp = w > 0 ? s_hend[ch][w - 1][n] : (active ? h0[n] : 0.f);
      }
      ha[n] = hp * a[n];
      float pn = __shfl_down_sync(kAll, a[n], 1);
      if (lane == 31) pn = w < kWarps - 1 ? s_a0[ch][w + 1][n] : 1.f;
      P[n] = pn;
    }
    // the adjoint: suffix Kogge-Stone on X_t = q_t + P_t X_{t+1}
    float X[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) X[n] = s_C[n][t] * gv;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float xs = __shfl_down_sync(kAll, X[n], s);
        const float ps = __shfl_down_sync(kAll, P[n], s);
        if (lane + s < 32) {
          X[n] = fmaf(P[n], xs, X[n]);
          P[n] *= ps;
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        s_pa[ch][w][n] = P[n];
        s_px[ch][w][n] = X[n];
      }
    }
    __syncthreads();   // (4)

    float dhB = 0.f;
    float dadt = 0.f;
    const float dtu = dtv * uv;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      // dh entering from the right: the chunk after's carry through the
      // later warps of the channel
      float xin = s_carry[ch][n];
#pragma unroll
      for (int v = kWarps - 1; v > 0; --v) {
        if (v > w) xin = fmaf(s_pa[ch][v][n], xin, s_px[ch][v][n]);
      }
      const float dh = fmaf(P[n], xin, X[n]);
      X[n] = dh;
      const float q = dh * ha[n];
      dhB = fmaf(dh, s_B[n][t], dhB);
      dadt = fmaf(q, s_A[ch][n], dadt);
      acc_dA[n] = fmaf(q, dtv, acc_dA[n]);
      if (active) atomicAdd(&s_dB[n][t], dh * dtu);
    }
    if (live) {
      du_row[pos] = from_f<Tin>(fmaf(dtv, dhB, d_skip * gv));
      const float ddl = fmaf(uv, dhB, dadt) * sig;
      ddl_row[pos] = from_f<Tin>(ddl);
      acc_db += ddl;
      acc_dD = fmaf(gv, uv, acc_dD);
    } else if (active && pos < L) {
      du_row[pos] = from_f<Tin>(0.f);
      ddl_row[pos] = from_f<Tin>(0.f);
    }
    __syncthreads();   // (5) s_carry, s_a0 read; s_dB, s_dC complete

    if (active && t == 0) {
#pragma unroll
      for (int n = 0; n < kN; ++n) s_carry[ch][n] = s_a0[ch][0][n] * X[n];
    }
    for (int i = tid; i < kN * kT; i += kThreads) {
      const int nn = i / kT;
      const int tt = i % kT;
      if (t0 + tt < L) {
        const size_t off = (size_t)nn * L + t0 + tt;
        atomicAdd(dB_base + off, s_dB[nn][tt]);
        atomicAdd(dC_base + off, s_dC[nn][tt]);
      }
      s_dB[nn][tt] = 0.f;
      s_dC[nn][tt] = 0.f;
    }
    // the next chunk's first barrier orders these writes before their reads
  }

  // dA, dD and dbias: over the channel's 128 threads, then one atomic each
  float sums[kN + 2];
#pragma unroll
  for (int n = 0; n < kN; ++n) sums[n] = acc_dA[n];
  sums[kN] = acc_dD;
  sums[kN + 1] = acc_db;
#pragma unroll
  for (int n = 0; n < kN + 2; ++n) {
    float v = sums[n];
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(kAll, v, m);
    if (lane == 0) s_red[ch][w][n] = v;
  }
  __syncthreads();
  if (active && t < kN + 2) {
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) v += s_red[ch][ww][t];
    if (t < kN) {
      atomicAdd(p.dA + (size_t)d * kN + t, v);
    } else if (t == kN) {
      if (p.dD != nullptr) atomicAdd(p.dD + d, v);
    } else if (p.dbias != nullptr) {
      atomicAdd(p.dbias + d, v);
    }
  }
}

template <typename Tin>
void launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.dpg + kCh - 1) / kCh, p.groups, batch);
  hillis_bwd_kernel<Tin><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for u, delta, B, C, du and ddelta;
// gy is float32, as K3's y is. dA, dB, dC, dD and dbias are float32 buffers
// the caller zeroed. Returns cudaGetLastError() after the launch (0 when it
// was accepted), or cudaErrorInvalidValue for arguments the kernel does not
// take. Launches on `stream` and does not synchronise.
extern "C" int medmamba_selective_scan_hillis_bwd(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* bias, const void* states,
    const void* gy, void* du, void* ddelta, void* dA, void* dB, void* dC,
    void* dD, void* dbias, int batch, int groups, int dpg, int n_state, int L,
    int valid_len, int softplus, int in_dtype, void* stream) {
  if (n_state != kN || batch < 1 || batch > 65535 || groups < 1 ||
      groups > 65535 || dpg < 1 || L < 1 || valid_len < 0 || valid_len > L ||
      in_dtype < 0 || in_dtype > 1 || states == nullptr || gy == nullptr) {
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
  p.gy = static_cast<const float*>(gy);
  p.du = du;
  p.ddelta = ddelta;
  p.dA = static_cast<float*>(dA);
  p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC);
  p.dD = static_cast<float*>(dD);
  p.dbias = static_cast<float*>(dbias);
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
