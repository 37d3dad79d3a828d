// Selective-scan (S6) backward for Hopper (sm_90a) from the 128-step chunk
// states of K3: the MEDMAMBA_SCAN_KERNEL=hillis backward.
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
// it, as they bound K2, which computes the same adjoint from K1's states.
//
// Design. The TPU kernel solves each chunk's recompute and adjoint by
// doubling, the TPU's way around a sequential loop; on this card that cost
// 42 operations per (b, d, n, t) more than the sequential adjoint, plus
// float atomics for dB, dC, dA, dD and dbias. This kernel runs K2's
// sequential adjoint instead (scan_bwd_walk.cuh: 32-channel blocks, 4 lanes a
// channel with 4 states each, a two-level recompute, dB/dC reduce-scattered
// into partials that a second kernel adds in a fixed order). That walk starts
// each 64-step tile from its entry state, and K3 saves one state per 128-step
// chunk, so three kernels run in order:
//
//  1. hillis_bwd_states_kernel: the 64-step tile-entry states. A chunk's
//     first tile enters with the chunk's state, copied; its second tile's
//     entry is that state walked 64 steps forward (K1's arithmetic, without
//     y or C). One block per (32 channels, group, chunk, batch row), the
//     64 steps' (dt, dt u) and B staged in shared memory, each lane walking
//     its 4 states: half an exponential per element over the whole L.
//  2. hillis_bwd_kernel: the walk, left to right scans only (the wrapper has
//     flipped reverse groups), gy masked past valid_len.
//  3. hillis_bwd_reduce_kernel: the partials added in a fixed order.
//
// The bfloat16 compute mode (MEDMAMBA_SCAN_COMPUTE=bfloat16; the TPU kernel's
// _bwd_kernel recomputes its bf16 h and scans a bf16 dh from a bf16 q): the
// expansion kernel and the walk recompute the states exactly as K3's mode
// computed them (the decay and input rounded, the state rounded each step),
// q is rounded from C and gy rounded, and dh is carried rounded each step;
// the carry a dh that leaves a tile and every sum stay float32
// (scan_bwd_walk.cuh, kBf16State). The float32 instantiations are the code
// the kernels had before the mode. On an NVIDIA H100 80GB HBM3, 700.00 W,
// the mode ran 26.69 ms a step against 21.04 in float32, in turns (PERF.md
// section 6 names the script).
//
// No output is written with an atomic, so every output is the same bits on
// every run.

#include "scan_bwd_walk.cuh"

namespace {

constexpr int kChunk = 128;            // K3's chunk: one saved state each
static_assert(kChunk == 2 * kT, "a chunk is two of the walk's tiles");

template <typename Tin, int kMode>
__global__ void __launch_bounds__(kThreads)
hillis_bwd_states_kernel(const Params p, const float* chunk_states,
                         float* tile_states) {
  __shared__ float2 s_x[kCh][kT + 1];  // (dt, dt * u); pitch against conflicts
  __shared__ float4 s_B[kT][kQ];

  const int cb = blockIdx.x % p.n_cb;
  const int c = blockIdx.x / p.n_cb;    // the chunk
  const int c0 = cb * kCh;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int q = lane % kQ;
  const int lc = tid / 32 * (32 / kQ) + lane / kQ;
  const int n_ch = min(kCh, p.dpg - c0);
  const bool active = lc < n_ch;
  const int L = p.L;
  const int d_all = p.groups * p.dpg;
  const int d0 = g * p.dpg + c0;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const int n_tiles = (L + kT - 1) / kT;
  const size_t dd = (size_t)b * d_all + d0 + lc;

  float4 h4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    h4 = reinterpret_cast<const float4*>(
        chunk_states + (dd * n_chunks + c) * kN)[q];
    reinterpret_cast<float4*>(tile_states + (dd * n_tiles + 2 * c) * kN)[q] =
        h4;
  }
  if (2 * c + 1 >= n_tiles) return;     // the chunk holds one tile: done

  // the chunk's first 64 steps, all inside L (a second tile follows)
  const int t0 = c * kChunk;
  const size_t row0 = ((size_t)b * d_all + d0) * L + t0;
  const Tin* u_base = static_cast<const Tin*>(p.u) + row0;
  const Tin* dl_base = static_cast<const Tin*>(p.delta) + row0;
  const Tin* B_base = static_cast<const Tin*>(p.B) +
      ((size_t)b * p.groups + g) * kN * L + t0;
  for (int i = tid; i < kCh * kT; i += kThreads) {
    const int cc = i / kT;
    const int tt = i % kT;
    float dv = 0.f;
    float uv = 0.f;
    if (cc < n_ch && t0 + tt < p.valid_len) {
      const size_t off = (size_t)cc * L + tt;
      uv = to_f(u_base[off]);
      float x = to_f(dl_base[off]);
      if (p.bias != nullptr) x += p.bias[d0 + cc];
      dv = p.softplus ? (x > 20.f ? x : log1pf(expf(x))) : x;
    }
    // dt u rounded in the bfloat16 mode, as K3's walk stages it
    s_x[cc][tt] = make_float2(dv, kMode == kFp32 ? dv * uv : bf16r(dv * uv));
  }
  for (int i = tid; i < kQ * kT; i += kThreads) {
    const int qq = i / kT;
    const int tt = i % kT;
    float bv[kNS];
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      bv[j] = to_f(B_base[(size_t)(kNS * qq + j) * L + tt]);
    }
    if constexpr (sizeof(Tin) == 4 && kMode != kFp32) bf16r4(bv);
    s_B[tt][qq] = make_float4(bv[0], bv[1], bv[2], bv[3]);
  }
  __syncthreads();
  if (!active) return;

  float a_n[kNS];
  float h[kNS] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
  for (int i = 0; i < kNS; ++i) a_n[i] = p.A[(size_t)(d0 + lc) * kN + kNS * q + i];
#pragma unroll 8
  for (int tt = 0; tt < kT; ++tt) {
    const float2 xv = s_x[lc][tt];
    const float4 bq = s_B[tt][q];
    if constexpr (kMode == kFp32) {
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        h[i] = expf(xv.x * a_n[i]) * h[i] + xv.y * get(bq, i);
      }
    } else {
      float a[kNS];
      step_bf16<kMode>(h, a, xv.x, xv.y, bq, a_n);
    }
  }
  reinterpret_cast<float4*>(tile_states + (dd * n_tiles + 2 * c + 1) * kN)[q] =
      make_float4(h[0], h[1], h[2], h[3]);
}

// At most 168 registers, so that 3 blocks fit an SM, as K2's walk.
template <typename Tin, int kMode>
__global__ void __launch_bounds__(kThreads, 3)
hillis_bwd_kernel(const Params p) {
  walk<Tin, float, kMode>(p);
}

__global__ void __launch_bounds__(kReduceThreads)
hillis_bwd_reduce_kernel(const Params p, int batch, float* dA, float* dB,
                         float* dC, float* dD, float* dbias) {
  reduce_partials(p, batch, dA, dB, dC, dD, dbias);
}

// The one workspace the entry point takes, in floats: the tile-entry
// states (b, G*dpg, n_tiles, 16) first, then the walk's four partials, each
// starting on 16 bytes.
struct Workspace {
  long long tiles, parts[4], total;
  Workspace(int batch, int groups, int dpg, int L) {
    tiles = (long long)batch * groups * dpg * ((L + kT - 1) / kT) * kN;
    walk_workspace(batch, groups, dpg, L, parts);
    total = tiles;
    for (long long& n : parts) {
      const long long size = n;
      n = total;                       // now the part's offset
      total += (size + 3) / 4 * 4;
    }
  }
};

template <typename Tin, int kMode>
cudaError_t launch(const Params& p, const float* chunk_states,
                   float* tile_states, int batch, cudaStream_t stream) {
  const int n_chunks = (p.L + kChunk - 1) / kChunk;
  hillis_bwd_states_kernel<Tin, kMode>
      <<<dim3(p.n_cb * n_chunks, p.groups, batch), kThreads, 0, stream>>>(
          p, chunk_states, tile_states);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(hillis_bwd_kernel<Tin, kMode>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem));
  if (e != cudaSuccess) return e;
  hillis_bwd_kernel<Tin, kMode><<<dim3(p.n_cb, p.groups, batch), kThreads,
                                  sizeof(Smem), stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch(const Params& p, const float* chunk_states,
                   float* tile_states, int batch, int compute,
                   cudaStream_t stream) {
  return compute == 0
             ? launch<Tin, kFp32>(p, chunk_states, tile_states, batch, stream)
             : launch<Tin, kBf16State>(p, chunk_states, tile_states, batch,
                                       stream);
}

}  // namespace

// Size in floats of the float32 workspace the entry point takes.
extern "C" long long medmamba_selective_scan_hillis_bwd_workspace(
    int batch, int groups, int dpg, int L) {
  return Workspace(batch, groups, dpg, L).total;
}

// dtype codes: 0 = float32, 1 = bfloat16, for u, delta, B, C, du and ddelta;
// gy is float32, as K3's y is; states are K3's chunk-entry states; compute:
// 0 = float32, 1 = the bfloat16 mode of the forward. dA, dB,
// dC, dD and dbias are float32 outputs (dD and dbias may be null), each
// written whole, as is the workspace of the size
// medmamba_selective_scan_hillis_bwd_workspace gives (16-byte aligned).
// Launches the three kernels on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launches (0 when all were accepted), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int medmamba_selective_scan_hillis_bwd(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* bias, const void* states,
    const void* gy, void* du, void* ddelta, void* dA, void* dB, void* dC,
    void* dD, void* dbias, void* workspace, int batch, int groups, int dpg,
    int n_state, int L, int valid_len, int softplus, int in_dtype,
    int compute, void* stream) {
  if (n_state != kN || batch < 1 || batch > 65535 || groups < 1 ||
      groups > 65535 || dpg < 1 || L < 1 || valid_len < 0 || valid_len > L ||
      in_dtype < 0 || in_dtype > 1 || compute < 0 || compute > 1 ||
      states == nullptr || gy == nullptr || workspace == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Workspace ws(batch, groups, dpg, L);
  float* w = static_cast<float*>(workspace);
  Params p;
  p.u = u;
  p.delta = delta;
  p.A = static_cast<const float*>(A);
  p.B = B;
  p.C = C;
  p.D = static_cast<const float*>(D);
  p.bias = static_cast<const float*>(bias);
  p.states = w;                         // the tile-entry states
  p.gy = gy;
  p.du = du;
  p.ddelta = ddelta;
  p.ws_bc = w + ws.parts[0];
  p.ws_a = w + ws.parts[1];
  p.ws_d = w + ws.parts[2];
  p.ws_bias = w + ws.parts[3];
  p.groups = groups;
  p.u_groups = groups;
  p.dpg = dpg;
  p.n_cb = (dpg + kCh - 1) / kCh;
  p.L = L;
  p.valid_len = valid_len;
  p.softplus = softplus;
  p.rev_mask = 0;
  p.mask_gy = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* chunk_states = static_cast<const float*>(states);
  const cudaError_t e =
      in_dtype == 0
          ? launch<float>(p, chunk_states, w, batch, compute, s)
          : launch<__nv_bfloat16>(p, chunk_states, w, batch, compute, s);
  if (e != cudaSuccess) return (int)e;
  hillis_bwd_reduce_kernel<<<reduce_blocks(batch, groups, dpg, L),
                             kReduceThreads, 0, s>>>(
      p, batch, static_cast<float*>(dA), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dD),
      static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
