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
// exponentials on the special-function units. So the bytes bound it; what
// the work costs in issued instructions (shuffles, shared-memory traffic,
// the recompute's second exponential) decides how close the kernel comes.
// chip_smoke.py's k2_costs counts only the need.
//
// Design: the sequential adjoint over K1's 64-step tiles, from K1's
// tile-entry states, in scan_bwd_walk.cuh (which K4 shares): 32-channel
// blocks of 128 threads, 4 lanes a channel with 4 states each, a two-level
// recompute with 8-step sub-tiles, dB/dC reduce-scattered by shuffles into
// per-block partials. A second kernel, scan_bwd_reduce_kernel, launched
// right after by the same entry point, adds the partials in a fixed order.
//
// The bfloat16 compute mode (MEDMAMBA_SCAN_COMPUTE=bfloat16; the TPU kernel
// reads it in _part_bwd, which recomputes the forward's bf16 cubes and
// forms q = C gy in bfloat16): the walk recomputes the states as K1's mode
// computed them and rounds q from C and gy rounded; B and C are read
// rounded; dh, the carry and every sum stay float32 (scan_bwd_walk.cuh,
// kBf16). Each kernel is compiled for both modes; the float32
// instantiations are the code the kernel had before the mode. On an NVIDIA
// H100 80GB HBM3, 700.00 W, the mode ran 22.18 ms a step against 19.04 in
// float32, in turns (PERF.md section 6 names the script), at 167 registers.
//
// No output is written with an atomic, so every output is the same bits on
// every run.

#include "scan_bwd_walk.cuh"

namespace {

// At most 168 registers, so that 3 blocks fit an SM: medmamba_t's first
// stage (384 blocks) then runs in one wave of 396 slots.
template <typename Tin, typename Tg, int kMode>
__global__ void __launch_bounds__(kThreads, 3)
scan_bwd_kernel(const Params p) {
  walk<Tin, Tg, kMode>(p);
}

__global__ void __launch_bounds__(kReduceThreads)
scan_bwd_reduce_kernel(const Params p, int batch, float* dA, float* dB,
                       float* dC, float* dD, float* dbias) {
  reduce_partials(p, batch, dA, dB, dC, dD, dbias);
}

template <typename Tin, typename Tg, int kMode>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      scan_bwd_kernel<Tin, Tg, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(p.n_cb, p.groups, batch);
  scan_bwd_kernel<Tin, Tg, kMode><<<grid, kThreads, sizeof(Smem), stream>>>(
      p);
  return cudaGetLastError();
}

template <typename Tin, typename Tg>
cudaError_t launch(const Params& p, int batch, int compute,
                   cudaStream_t stream) {
  return compute == 0 ? launch<Tin, Tg, kFp32>(p, batch, stream)
                      : launch<Tin, Tg, kBf16>(p, batch, stream);
}

}  // namespace

// Sizes in floats of the four workspaces the entry point takes, for the
// given shape: the dB/dC partials, then the dA, dD and dbias partials.
extern "C" void medmamba_selective_scan_bwd_workspace(
    int batch, int groups, int dpg, int L, long long* sizes) {
  walk_workspace(batch, groups, dpg, L, sizes);
}

// dtype codes: 0 = float32, 1 = bfloat16; in_dtype is that of u, delta, B, C
// (and of du and ddelta), gy_dtype that of gy; compute: 0 = float32, 1 = the
// bfloat16 mode of the forward. dA, dB, dC, dD and dbias are
// float32 outputs (dD and dbias may be null), each written whole, as are
// the four float32 workspaces of the sizes
// medmamba_selective_scan_bwd_workspace gives. Launches the scan kernel and
// then the reduce kernel on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launches (0 when both were accepted), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int medmamba_selective_scan_bwd(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* bias, const void* states,
    const void* gy, void* du, void* ddelta, void* dA, void* dB, void* dC,
    void* dD, void* dbias, void* ws_bc, void* ws_a, void* ws_d,
    void* ws_bias, int batch, int groups, int u_groups, int dpg, int n_state,
    int L, int valid_len, int softplus, int rev_mask, int in_dtype,
    int gy_dtype, int compute, void* stream) {
  if (n_state != kN || batch < 1 || groups < 1 || groups > 30 ||
      u_groups < 1 || groups % u_groups != 0 || dpg < 1 || L < 1 ||
      batch > 65535 || in_dtype < 0 || in_dtype > 1 || gy_dtype < 0 ||
      gy_dtype > 1 || compute < 0 || compute > 1 || states == nullptr || ws_bc == nullptr ||
      ws_a == nullptr || ws_d == nullptr || ws_bias == nullptr) {
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
  p.ws_bc = static_cast<float*>(ws_bc);
  p.ws_a = static_cast<float*>(ws_a);
  p.ws_d = static_cast<float*>(ws_d);
  p.ws_bias = static_cast<float*>(ws_bias);
  p.groups = groups;
  p.u_groups = u_groups;
  p.dpg = dpg;
  p.n_cb = (dpg + kCh - 1) / kCh;
  p.L = L;
  p.valid_len = valid_len;
  p.softplus = softplus;
  p.rev_mask = rev_mask;
  p.mask_gy = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_dtype == 0 && gy_dtype == 0) {
    e = launch<float, float>(p, batch, compute, s);
  } else if (in_dtype == 0) {
    e = launch<float, __nv_bfloat16>(p, batch, compute, s);
  } else if (gy_dtype == 0) {
    e = launch<__nv_bfloat16, float>(p, batch, compute, s);
  } else {
    e = launch<__nv_bfloat16, __nv_bfloat16>(p, batch, compute, s);
  }
  if (e != cudaSuccess) return (int)e;
  scan_bwd_reduce_kernel<<<reduce_blocks(batch, groups, dpg, L),
                           kReduceThreads, 0, s>>>(
      p, batch, static_cast<float*>(dA), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dD),
      static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
