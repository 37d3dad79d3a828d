// The relayout and contraction probes of tools/probe_mosaic.py on Hopper
// (sm_90a), float32, exact.
//
// Replaces the TPU kernels that tools/probe_mosaic.py:20 (run) hands to
// pl.pallas_call at :22, its bodies at :43-143. On the TPU they asked which
// small-tensor relayouts the Mosaic compiler accepts; here each computes the
// same function, so the probe ids below follow the TPU tool's order. With x
// (B, D, N, R) row-major (the (B, D, N*R) input has the same flat layout)
// and bdn = (b * D + d) * N + n:
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
// Three kernels: one gather (the index maps 0-4, 6-10 and 12), one product
// with the selection matrix built in its own loop (5, 11; each output sums
// one x and R - 1 exact zeros, so it equals x exactly), one thread per bdn
// for the recurrence (0.5 h is exact). Every product and sum rounds once
// and none is fused, so each output equals the plain PyTorch version's bit
// for bit. At the probe's size (64 KiB in) each is bound by its launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(int probe, const float* __restrict__ x, float* __restrict__ out,
              int total, int nb, int nd, int nn, int nr) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  int src = o;
  float scale = 1.f;
  switch (probe) {
    case 2: {
      const int n = o % nn, r = (o / nn) % nr, bd = o / (nn * nr);
      src = (bd * nn + n) * nr + r;
      break;
    }
    case 6:
      src = o * nr + nr - 1;
      break;
    case 7:
      src = o * nr;
      break;
    case 8: {
      const int j = o % (nn * nr), bd = o / (nn * nr);
      src = (bd * nn + j % nn) * nr;
      break;
    }
    case 9: {
      const int j = o % (nn * nr), bd = o / (nn * nr);
      src = (bd * nn + j / nr) * nr;
      break;
    }
    case 10:
    case 12: {
      const int bdn_total = nb * nd * nn;
      const int r = o / bdn_total, bdn = o % bdn_total;
      src = bdn * nr + r;
      if (probe == 12) scale = (float)(r + 1);
      break;
    }
    default:  // 0, 1, 3, 4: the same flat order
      break;
  }
  out[o] = probe == 12 ? __fmul_rn(x[src], scale) : x[src];
}

__global__ void __launch_bounds__(kThreads)
select_product_kernel(int probe, const float* __restrict__ x,
                      float* __restrict__ out, int rows, int cols, int nr) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= rows * cols) return;
  const int row = o / cols, j = o % cols;
  const float* xr = x + (size_t)row * nr;
  float acc = 0.f;
  for (int r = 0; r < nr; ++r) {
    const bool on = probe == 5 ? j % nr == r : r == j / 16;
    acc = __fadd_rn(acc, __fmul_rn(xr[r], on ? 1.f : 0.f));
  }
  out[o] = acc;
}

__global__ void __launch_bounds__(kThreads)
recurrence_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int bdn_total, int nr) {
  const int bdn = blockIdx.x * kThreads + threadIdx.x;
  if (bdn >= bdn_total) return;
  const float* xr = x + (size_t)bdn * nr;
  float h = xr[0];
  out[bdn] = h;
  for (int r = 1; r < nr; ++r) {
    h = __fadd_rn(__fmul_rn(h, 0.5f), xr[r]);
    out[(size_t)r * bdn_total + bdn] = h;
  }
}

unsigned blocks_for(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// Probe `probe` (0-13, as above) of x with dims (nb, nd, nn, nr) into out,
// which holds the probe's output. Returns cudaGetLastError() after the
// launch (0 when it was accepted), or cudaErrorInvalidValue for arguments
// the kernels do not take. Launches on `stream` and does not synchronise.
extern "C" int medmamba_probe_mosaic(int probe, const void* x, void* out,
                                     int nb, int nd, int nn, int nr,
                                     void* stream) {
  if (nb < 1 || nd < 1 || nn < 1 || nr < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const int bdn = nb * nd * nn;
  if (probe == 5 || probe == 11) {
    const int cols = probe == 5 ? nn * nr : 16 * nr;
    select_product_kernel<<<blocks_for(bdn * cols), kThreads, 0, st>>>(
        probe, in, o, bdn, cols, nr);
  } else if (probe == 13) {
    recurrence_kernel<<<blocks_for(bdn), kThreads, 0, st>>>(in, o, bdn, nr);
  } else if (probe >= 0 && probe <= 12) {
    const int total = probe == 6 || probe == 7 ? bdn : bdn * nr;
    gather_kernel<<<blocks_for(total), kThreads, 0, st>>>(probe, in, o, total,
                                                         nb, nd, nn, nr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
