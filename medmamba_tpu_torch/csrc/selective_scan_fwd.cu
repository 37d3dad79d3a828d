// Selective-scan (S6) forward for Hopper (sm_90a), exact fp32 recurrence.
//
// Replaces the TPU kernel medmamba_tpu/ops/pallas_scan.py:787 (_fwd_kernel_ssd,
// launched by _fwd_pallas, its pallas_call at :1002). Per batch b, channel d
// (group g = d / dpg) and state n, walking L in the group's direction:
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
//     about 4.2 GB, 1.26 ms at 3.35 TB/s;
//   * exponentials: one exp(dt * A) per (b, d, n, t), 5.2e9 a forward, 1.25 ms
//     on the special-function units (132 SMs x 16 per clock at 1.98 GHz);
//   * issue: the walk issues about 15 instructions per (b, d, n, t), 9 of
//     them expf's, and the softplus of each (d, t) about 77 more, about 20
//     per element in all: about 3.1 ms a forward at one warp instruction a
//     clock on each of the 528 schedulers.
// So issue, not the bytes, bounds it; the walk's latency at the 12 warps an
// SM that stage 0 fills (384 blocks of 4 warps) decides how close it comes.
//
// Design. The earlier design (one thread per (b, d, n), 8-channel blocks, a
// 4-level shuffle tree per step for y, synchronous staging) issued about 25
// instructions per element and ran 11.1 ms a forward. This one, whose walk
// lives in scan_fwd_walk.cuh (K3, selective_scan_hillis_fwd.cu, runs it too):
//
//  * Layout. A block of 128 threads owns kCh = 128 / kQ channels of one
//    group; kQ lanes share a channel, each holding 16 / kQ states in
//    registers, so each lane runs 16 / kQ independent chains and reads its
//    (dt, dt*u), B and C with one 8-byte and two vector shared loads a step.
//  * y without a shuffle tree per step. A lane keeps its states' share of y
//    for kG steps in registers; then the channel's kQ lanes reduce-scatter
//    them (kQ - 1 shuffles per kQ steps per lane), which leaves each lane the
//    whole sum of one step, added into the tile's y row. y has rows of its
//    own: written into the (dt, dt*u) rows the walk reads, it kept the
//    compiler from overlapping one group's loads with the last group's
//    stores, and every stage ran 1.3-2x slower.
//  * Staging. While tile k is walked, cp.async brings the raw rows of tile
//    k + 1 (u and delta of the block's channels, B and C of its group: 24 KB
//    in float32) into a raw buffer, zero-filled past L: 16 bytes a copy, or,
//    where a row is not 16-byte aligned (float32 at L = 49, bf16 at L = 196
//    and 49), the 4-byte words that cover it. A pass between two barriers
//    turns them into what the walk reads: (dt, dt * u) per (channel, step)
//    with softplus taken once per (d, t), B and C as [t][16] rows, and y's
//    row set to D * u. B and C are read from device memory once per kCh
//    channels.
//  * The walk is inline and without a branch per step: the steps past a
//    tile's length are identity steps on zero-filled slots (dt = 0, so decay
//    1 and inject 0), whose y lands in slots that are never copied out.
//  * Width by size. With at least kWideMinBlocks blocks of 32 channels
//    (kQ = 4, 4 states a lane, 3 blocks an SM by shared memory and
//    registers) the card is full and issue decides: that layout is launched.
//    Below it (batch 1: 6 to 48 blocks at medmamba_t's stages) the step's
//    latency decides, and the entry point launches 8-channel blocks (kQ =
//    16, one state a lane): four times as many blocks, a quarter of the
//    chain per lane. medmamba_selective_scan_fwd_config says which.
//
// The bfloat16 compute mode (MEDMAMBA_SCAN_COMPUTE=bfloat16; the TPU kernel
// reads it in _ssd_core_compact and _ssd_forward_core, which compute their
// decay and input cubes E, F, dub and w in bfloat16): the walk rounds each
// step's decay exp(dt A) and input (dt u) B to bfloat16, from dt u and B
// rounded, and keeps the state, y's sum and the saved states float32
// (scan_fwd_walk.cuh). Each kernel is compiled for both modes; the float32
// instantiations are the code the kernel had before the mode. The mode only
// adds work (a conversion and an unpack a rounding): on an NVIDIA H100 80GB
// HBM3, 700.00 W, 6.51 ms a forward against 5.59 in float32, in turns
// (PERF.md section 6 names the script).
//
// With a non-null `states` the kernel also writes the float32 state at the
// entry of every 64-step tile, (b, G*dpg, n_tiles, 16) in processing order
// (tile k is the k-th tile the group's direction visits), as the TPU forward
// writes its chunk states for the backward. The backward kernel
// (selective_scan_bwd.cu) recomputes each tile's states from them, so kT is
// the same there. No output is written with an atomic: every output is the
// same bits on every run.
//
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi), float32, in
// one call beside the earlier design (PERF.md section 6 names the script),
// ms per launch at stages 0-3:
//   batch 64:  0.5694 0.2972 0.1753 0.1080, 5.30 ms a forward
//              (earlier design 1.4487 0.5978 0.2939 0.1595, 11.1 ms);
//   batch 1, device time: 0.1330 0.0370 0.0122 0.0055
//              (earlier design 0.6268 0.1586 0.0375 0.0102).
// Copies wrong on purpose at stage 0, batch 64: expf replaced by a
// multiply-add 0.4259 ms (25% off), staging loads replaced by constants
// 0.5557 (2%), y stores never taken 0.5588 (2%). exp2 of dt times A scaled
// by log2(e) (one multiply and the special-function unit's approximate
// exp2) ran 0.4745 ms (17% off, 4.5e-6 from the plain scan): not taken,
// the kernel keeps expf's accuracy, as K2's recompute does.

#include "scan_fwd_walk.cuh"

namespace {

// Tin: u, delta, B, C. Tout: y. kQ lanes per channel (4 or 16). kMode:
// kFp32 or kBf16. Every tile's entry state is saved.
template <typename Tin, typename Tout, int kQ, int kMode>
__global__ void __launch_bounds__(kThreads, kQ == kWideQ ? kMinBlocksWide
                                                         : kMinBlocksNarrow)
scan_fwd_kernel(const Params p) {
  walk<Tin, Tout, kQ, 1, kMode>(p);
}

template <typename Tin, typename Tout, int kMode>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (use_wide(batch, p.groups, p.dpg)) {
    return launch_walk<Tin, kWideQ>(
        scan_fwd_kernel<Tin, Tout, kWideQ, kMode>, p, batch, stream);
  }
  return launch_walk<Tin, kNarrowQ>(
      scan_fwd_kernel<Tin, Tout, kNarrowQ, kMode>, p, batch, stream);
}

template <typename Tin, typename Tout>
cudaError_t dispatch(const Params& p, int batch, int compute,
                     cudaStream_t stream) {
  return compute == 0 ? dispatch<Tin, Tout, kFp32>(p, batch, stream)
                      : dispatch<Tin, Tout, kBf16>(p, batch, stream);
}

// channels per block, dynamic shared memory, registers per thread and
// resident blocks an SM of one instantiation
template <typename Tin, typename Tout, int kQ, int kMode>
cudaError_t config(int* info) {
  constexpr int kCh = kThreads / kQ;
  const int smem = (int)sizeof(Smem<Tin, kCh>);
  cudaError_t e = cudaFuncSetAttribute(
      scan_fwd_kernel<Tin, Tout, kQ, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&attr, scan_fwd_kernel<Tin, Tout, kQ, kMode>);
  }
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, scan_fwd_kernel<Tin, Tout, kQ, kMode>, kThreads, smem);
  }
  info[0] = kCh;
  info[1] = smem;
  info[2] = e == cudaSuccess ? attr.numRegs : 0;
  info[3] = blocks;
  return e;
}

template <typename Tin, typename Tout>
cudaError_t config(bool wide, int compute, int* info) {
  if (compute == 0) {
    return wide ? config<Tin, Tout, kWideQ, kFp32>(info)
                : config<Tin, Tout, kNarrowQ, kFp32>(info);
  }
  return wide ? config<Tin, Tout, kWideQ, kBf16>(info)
              : config<Tin, Tout, kNarrowQ, kBf16>(info);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; compute: 0 = float32, 1 = the
// bfloat16 mode. Returns cudaGetLastError() after the launch (0 when it was
// accepted), or cudaErrorInvalidValue for arguments the kernel does not take.
// Launches on `stream` and does not synchronise.
extern "C" int medmamba_selective_scan_fwd(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* bias, void* y, void* last,
    void* states, int batch, int groups, int u_groups, int dpg, int n_state, int L,
    int valid_len, int softplus, int rev_mask, int in_dtype, int out_dtype,
    int compute, void* stream) {
  if (n_state != kN || batch < 1 || groups < 1 || groups > 30 ||
      u_groups < 1 || groups % u_groups != 0 || dpg < 1 || L < 1 ||
      batch > 65535 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || compute < 0 || compute > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p = make_params(u, delta, A, B, C, D, bias, y, last, states,
                               groups, u_groups, dpg, L, valid_len, softplus,
                               rev_mask, in_dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_dtype == 0 && out_dtype == 0) {
    e = dispatch<float, float>(p, batch, compute, s);
  } else if (in_dtype == 0) {
    e = dispatch<float, __nv_bfloat16>(p, batch, compute, s);
  } else if (out_dtype == 0) {
    e = dispatch<__nv_bfloat16, float>(p, batch, compute, s);
  } else {
    e = dispatch<__nv_bfloat16, __nv_bfloat16>(p, batch, compute, s);
  }
  return (int)e;
}

// What the entry point launches for these sizes: info[0] channels per block,
// info[1] bytes of dynamic shared memory a block, info[2] registers a thread,
// info[3] blocks an SM can hold. Returns a CUDA error code (0 on success).
extern "C" int medmamba_selective_scan_fwd_config(
    int batch, int groups, int dpg, int in_dtype, int out_dtype, int compute,
    int* info) {
  if (batch < 1 || groups < 1 || dpg < 1 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || compute < 0 || compute > 1 ||
      info == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = use_wide(batch, groups, dpg);
  if (in_dtype == 0 && out_dtype == 0) {
    return config<float, float>(wide, compute, info);
  }
  if (in_dtype == 0) return config<float, __nv_bfloat16>(wide, compute, info);
  if (out_dtype == 0) return config<__nv_bfloat16, float>(wide, compute, info);
  return config<__nv_bfloat16, __nv_bfloat16>(wide, compute, info);
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
