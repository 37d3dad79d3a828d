// Selective-scan (S6) forward for Hopper (sm_90a) that saves the state
// entering every 128-step chunk: the MEDMAMBA_SCAN_KERNEL=hillis forward.
//
// Replaces the TPU kernel medmamba_tpu/ops/pallas_scan.py:877 (_fwd_kernel,
// launched by _fwd_pallas, its pallas_call at :1002, its within-chunk scan
// _fwd_chunk_scan). Per batch b, channel d (group g = d / dpg) and state n,
// left to right:
//
//   dt_t = softplus(delta_t + bias_d)      (delta_t + bias_d without softplus)
//   a_t  = exp(dt_t * A_dn),  b_t = dt_t * u_t * B_{g,n,t}
//                             (a_t = 1 and b_t = 0 at t >= valid_len)
//   h_t  = a_t * h_{t-1} + b_t
//   y_t  = sum_n C_{g,n,t} * h_t + D_d * u_t          (y always float32)
//
// It also writes the float32 state entering every 128-step chunk,
// (b, G*dpg, ceil(L/128), 16), which the backward (selective_scan_hillis_bwd.cu)
// expands to the entry states of its 64-step tiles, and the state after the
// last step (b, G*dpg, 16). The scan runs left to right only; the wrapper
// flips reverse groups, as the JAX package's wrapper does.
//
// What bounds it on an H100. For medmamba_t at 224^2, batch 64 (one forward is
// 20 launches, G = 2, N = 16, D = 192/384/768/1536, L = 3136/784/196/49):
// K1's bytes plus the chunk states, about 4.5 GB, 1.34 ms at 3.35 TB/s; one
// exp per (b, d, n, t), about 1.25 ms on the special-function units; the
// walk's issue, about 20 instructions per (b, d, n, t), about 3.1 ms (K1's
// header counts them). So issue bounds it, as it bounds K1.
//
// Design. The TPU kernel composes each chunk by Hillis-Steele doubling, the
// TPU's way around a sequential loop. The earlier kernel here carried that
// over (one thread per step of a 128-step chunk, 7 Kogge-Stone levels of
// shuffles, the warps of a chunk joined through shared memory): about 28
// fp32 operations per (b, d, n, t) where the recurrence needs 7, and 35 ms a
// forward on an H100, instruction-bound. This kernel runs K1's sequential
// walk instead (scan_fwd_walk.cuh: 32-channel blocks, 4 lanes a channel and 4
// states a lane, the next 64-step tile staged by cp.async while one is
// walked, y reduce-scattered over a channel's lanes; 8-channel blocks of one
// state a lane where fewer than 132 wide blocks would fill the card), with
// one u group per scan group, no reverse groups and y in float32, and saves
// the state entering every other tile: a chunk is two of the walk's tiles.
// It rounds as the sequential scan does, not as the doubling does; exact
// expf; no output is written with an atomic, so every output is the same
// bits on every launch.
//
// The bfloat16 compute mode (MEDMAMBA_SCAN_COMPUTE=bfloat16, read by the TPU
// kernel's _fwd_kernel, which scans its bf16 a and dbu into a bf16 h and
// sums bf16 h C in float32): the walk rounds each step's decay and input as
// K1's mode does, carries the state rounded to bfloat16 each step (one
// rounding a fused step), and sums y in float32 from h C rounded, C rounded
// (scan_fwd_walk.cuh, kBf16State). The saved chunk states and the last
// state are those bfloat16 values, stored as float32. On an NVIDIA H100
// 80GB HBM3, 700.00 W, the mode ran 7.30 ms a forward against 5.30 in
// float32, in turns (PERF.md section 6 names the script).
//
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi), float32,
// batch 64, in one call beside the doubling kernel (PERF.md section 6 names
// the script), ms per launch at stages 0-3: 0.5743 0.2967 0.1766 0.1096,
// 5.34 ms a forward (doubling 3.5624 1.9359 1.1088 1.1188, 35.34 ms); K1
// in the same call 5.29 ms.

#include "scan_fwd_walk.cuh"

namespace {

constexpr int kChunk = 128;            // one saved state each: K4 reads them
static_assert(kChunk == 2 * kT, "a chunk is two of the walk's tiles");

// Tin: u, delta, B, C; y is float32. kQ lanes per channel (4 or 16).
// kMode: kFp32 or kBf16State.
template <typename Tin, int kQ, int kMode>
__global__ void __launch_bounds__(kThreads, kQ == kWideQ ? kMinBlocksWide
                                                         : kMinBlocksNarrow)
hillis_fwd_kernel(const Params p) {
  walk<Tin, float, kQ, kChunk / kT, kMode>(p);
}

template <typename Tin, int kMode>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (use_wide(batch, p.groups, p.dpg)) {
    return launch_walk<Tin, kWideQ>(hillis_fwd_kernel<Tin, kWideQ, kMode>, p,
                                    batch, stream);
  }
  return launch_walk<Tin, kNarrowQ>(hillis_fwd_kernel<Tin, kNarrowQ, kMode>,
                                    p, batch, stream);
}

template <typename Tin>
cudaError_t dispatch(const Params& p, int batch, int compute,
                     cudaStream_t stream) {
  return compute == 0 ? dispatch<Tin, kFp32>(p, batch, stream)
                      : dispatch<Tin, kBf16State>(p, batch, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for u, delta, B and C; y, states and
// last are float32. compute: 0 = float32, 1 = the bfloat16 mode. Returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for arguments the kernel does not take. Launches on
// `stream` and does not synchronise.
extern "C" int medmamba_selective_scan_hillis_fwd(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* bias, void* y, void* states,
    void* last, int batch, int groups, int dpg, int n_state, int L,
    int valid_len, int softplus, int in_dtype, int compute, void* stream) {
  if (n_state != kN || batch < 1 || batch > 65535 || groups < 1 ||
      groups > 65535 || dpg < 1 || L < 1 || valid_len < 0 || valid_len > L ||
      in_dtype < 0 || in_dtype > 1 || compute < 0 || compute > 1 ||
      y == nullptr || states == nullptr || last == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  // one u group per scan group, every group left to right
  const Params p = make_params(u, delta, A, B, C, D, bias, y, last, states,
                               groups, groups, dpg, L, valid_len, softplus, 0,
                               in_dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      in_dtype == 0 ? dispatch<float>(p, batch, compute, s)
                    : dispatch<__nv_bfloat16>(p, batch, compute, s);
  return (int)e;
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
