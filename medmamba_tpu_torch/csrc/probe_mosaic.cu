// The relayout and contraction probes of tools/probe_mosaic.py on Hopper
// (sm_90a), float32, exact.
//
// Replaces the TPU kernels that tools/probe_mosaic.py:20 (run) hands to
// pl.pallas_call at :22, its bodies at :43-143. On the TPU they asked which
// small-tensor relayouts the Mosaic compiler accepts; here each computes the
// same function, so the probe ids below follow the TPU tool's order. With x
// (B, D, N, R) = (8, 16, 16, 8) row-major (the (B, D, N*R) input has the
// same flat layout) and bdn = (b * D + d) * N + n:
//
//   0 merge, 1 split, 3 and 4 the leading collapses: out[i] = x[i]
//   2 swapaxes (B, D, R, N):       out[bd, r, n]   = x[bd, n, r]
//   5 matmul with the 0/1 matrix p[r, j] = (j % R == r), (B, D, N, N*R):
//                                  out[bdn, j] = sum_r x[bdn, r] p[r, j]
//   6 strided lane slice (B, D, N): out[bdn] = x[bdn, R - 1]
//   7 slice + index (B, D, N):      out[bdn] = x[bdn, 0]
//   8 pltpu.repeat, a tile of x[..., 0] R times (B, D, N*R):
//                                  out[bd, j] = x[bd, j % N, 0]
//   9 broadcast + merge (B, D, N*R): out[bd, j] = x[bd, j / R, 0]
//  10 moveaxis (R, B, D, N):        out[r, bdn] = x[bdn, r]
//  11 dot_general with pick[r, t] = (r == t / 16), (B, D, N, 16*R):
//                                  out[bdn, t] = sum_r x[bdn, r] pick[r, t]
//  12 minor-index slices + stack (R, B, D, N):
//                                  out[r, bdn] = x[bdn, r] * (r + 1)
//  13 sequential recurrence (R, B, D, N): h_0 = x[bdn, 0],
//                                  h_r = 0.5 h_(r-1) + x[bdn, r]
//
// One kernel per probe, its shapes fixed at compile time (divisions are
// shifts, and no switch runs on the card), in one of three layouts, by the
// index map: where 4 adjacent outputs read 4 adjacent or nearby inputs (0-5,
// 8, 9, 11), a thread writes them with one 16-byte store; where the outputs
// are x's rows turned into planes (10, 12, 13), a thread reads its row of R
// with two 16-byte loads and writes one value to each plane, adjacent
// threads on adjacent addresses; the strided slices (6, 7) take one output a
// thread. The selection products 5 and 11 add one x and R - 1 exact zeros,
// so each output is that x, and the kernel copies it. 0.5 h is exact, and
// the recurrence rounds its sum once, unfused, as the plain version does. So
// each output equals the plain PyTorch version's bit for bit. At the probe's
// size (64 KiB in) each kernel is bound by its launch and its loads'
// latency, so the last two layouts keep a thread per row or output: with 4
// outputs a thread their grids were a quarter as large and slower.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kB = 8, kD = 16, kN = 16, kR = 8;
constexpr int kBD = kB * kD;
constexpr int kBDN = kBD * kN;         // 2048
constexpr int kThreads = 256;

// outputs of probe P
__host__ __device__ constexpr int out_size(int probe) {
  return probe == 5 ? kBDN * kN * kR
       : probe == 11 ? kBDN * 16 * kR
       : probe == 6 || probe == 7 ? kBDN
       : kBDN * kR;
}

// output o of probe P (0-9, 11): its value
template <int P>
__device__ __forceinline__ float probe_value(const float* __restrict__ x,
                                             int o) {
  if constexpr (P == 2) {
    const int n = o % kN, r = o / kN % kR, bd = o / (kN * kR);
    return x[(bd * kN + n) * kR + r];
  } else if constexpr (P == 6) {
    return x[o * kR + kR - 1];
  } else if constexpr (P == 7) {
    return x[o * kR];
  } else if constexpr (P == 8) {
    const int j = o % (kN * kR), bd = o / (kN * kR);
    return x[(bd * kN + j % kN) * kR];
  } else if constexpr (P == 9) {
    const int j = o % (kN * kR), bd = o / (kN * kR);
    return x[(bd * kN + j / kR) * kR];
  } else {                               // 11: the selected x
    return x[o / (16 * kR) * kR + o % (16 * kR) / 16];
  }
}

// 4 adjacent outputs a thread, one 16-byte store (0-5, 8, 9, 11)
template <int P>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int o = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (o >= out_size(P)) return;
  float4 v;
  if constexpr (P == 0 || P == 1 || P == 3 || P == 4 || P == 5) {
    // x read 16 bytes at a time: for 5, outputs 4k..4k+3 of a row select
    // x[bdn, 0..3] or x[bdn, 4..7]
    v = reinterpret_cast<const float4*>(x)[
        (P == 5 ? o / (kN * kR) * kR + o % kR : o) / 4];
  } else {
    v = make_float4(probe_value<P>(x, o), probe_value<P>(x, o + 1),
                    probe_value<P>(x, o + 2), probe_value<P>(x, o + 3));
  }
  reinterpret_cast<float4*>(out)[o / 4] = v;
}

// one output a thread (the strided slices 6, 7)
template <int P>
__global__ void __launch_bounds__(kThreads)
slice_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o < kBDN) out[o] = probe_value<P>(x, o);
}

// one row x[bdn, 0:R] a thread, turned into the planes out[r, bdn]: 10 as
// it is, 12 scaled by r + 1, 13 the recurrence along r
template <int P>
__global__ void __launch_bounds__(kThreads)
planes_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int bdn = blockIdx.x * kThreads + threadIdx.x;
  if (bdn >= kBDN) return;
  const float4* xr = reinterpret_cast<const float4*>(x + bdn * kR);
  const float4 lo = xr[0], hi = xr[1];
  const float row[kR] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  float h = row[0];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float v = row[r];
    if constexpr (P == 12) {
      v = __fmul_rn(v, (float)(r + 1));
    } else if constexpr (P == 13) {
      if (r > 0) h = __fadd_rn(__fmul_rn(h, 0.5f), v);
      v = h;
    }
    out[r * kBDN + bdn] = v;
  }
}

constexpr unsigned blocks_for(int threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <int P>
void launch(const float* x, float* out, cudaStream_t st) {
  if constexpr (P == 6 || P == 7) {
    slice_kernel<P><<<blocks_for(kBDN), kThreads, 0, st>>>(x, out);
  } else if constexpr (P == 10 || P == 12 || P == 13) {
    planes_kernel<P><<<blocks_for(kBDN), kThreads, 0, st>>>(x, out);
  } else {
    probe_kernel<P><<<blocks_for(out_size(P) / 4), kThreads, 0, st>>>(x,
                                                                      out);
  }
}

}  // namespace

// Probe `probe` (0-13, as above) of x, (8, 16, 16, 8) or (8, 16, 128)
// float32 and 16-byte aligned, into out, which holds the probe's output.
// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a probe id outside 0-13. Launches on `stream`
// and does not synchronise.
extern "C" int medmamba_probe_mosaic(int probe, const void* x, void* out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  switch (probe) {
    case 0: launch<0>(in, o, st); break;
    case 1: launch<1>(in, o, st); break;
    case 2: launch<2>(in, o, st); break;
    case 3: launch<3>(in, o, st); break;
    case 4: launch<4>(in, o, st); break;
    case 5: launch<5>(in, o, st); break;
    case 6: launch<6>(in, o, st); break;
    case 7: launch<7>(in, o, st); break;
    case 8: launch<8>(in, o, st); break;
    case 9: launch<9>(in, o, st); break;
    case 10: launch<10>(in, o, st); break;
    case 11: launch<11>(in, o, st); break;
    case 12: launch<12>(in, o, st); break;
    case 13: launch<13>(in, o, st); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched through the same path: the floor of a launch
// through ctypes, which tools/probe_mosaic.py times beside the probes.
__global__ void empty_kernel() {}

extern "C" int medmamba_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
