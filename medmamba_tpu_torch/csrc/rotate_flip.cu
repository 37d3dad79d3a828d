// Per-image horizontal flip, then nearest-neighbour rotation with zero fill,
// for Hopper (sm_90a): the training augmentation.
//
// Replaces the TPU kernel medmamba_tpu/ops/rotate_pallas.py:65 (_rot_kernel,
// launched by rotate_flip_pallas). That kernel approximates the rotation with
// two passes of masked rolls because a per-pixel gather is slow on a TPU, and
// lets up to about 4% of pixels take a horizontally adjacent source. The
// function it stands for is medmamba_tpu/data/transforms.py:_rotate_nearest
// applied after the flip, and that is what this kernel computes: for output
// pixel (i, j) of image b, with cy = (H - 1) / 2 and cx = (W - 1) / 2,
//
//   ys = cos * (i - cy) + sin * (j - cx) + cy
//   xs = -sin * (i - cy) + cos * (j - cx) + cx
//   out[b, i, j, :] = x[b, rint(ys), flip ? W - 1 - rint(xs) : rint(xs), :]
//
// and 0 where rint(ys), rint(xs) fall outside the image. rint rounds half to
// even, as jnp.round does, and the products and sums are rounded one by one
// (__fmul_rn, __fadd_rn: no fused multiply-add), so the kernel gives exactly
// the plain PyTorch version's pixels. sin and cos come from the caller,
// computed once per image, so both versions see the same values.
//
// What bounds it on an H100: bytes. Each input pixel is read about once and
// each output pixel written once; at 224^2, batch 64, 3 channels that is
// 77 MB, about 23 us at 3.35 TB/s, against about 10 float operations per
// output pixel. Design: one thread per output pixel, which gathers its 3
// channels directly; neighbouring threads take neighbouring output pixels, so
// the writes are coalesced and the reads, along a slightly tilted row, mostly
// share cache lines.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rotate_flip_kernel(const float* __restrict__ x, const float* __restrict__ sin_a,
                   const float* __restrict__ cos_a,
                   const int* __restrict__ flip, float* __restrict__ out,
                   int batch, int h, int w, int ch) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)batch * h * w) return;
  const int j = (int)(idx % w);
  const int i = (int)((idx / w) % h);
  const int b = (int)(idx / ((size_t)w * h));
  const float cy = (float)(h - 1) * 0.5f;
  const float cx = (float)(w - 1) * 0.5f;
  const float yy = (float)i - cy;
  const float xx = (float)j - cx;
  const float s = sin_a[b];
  const float c = cos_a[b];
  const float ys = __fadd_rn(__fadd_rn(__fmul_rn(c, yy), __fmul_rn(s, xx)), cy);
  const float xs =
      __fadd_rn(__fadd_rn(__fmul_rn(-s, yy), __fmul_rn(c, xx)), cx);
  const int yi = (int)rintf(ys);
  const int xi = (int)rintf(xs);
  float* o = out + idx * ch;
  if (yi < 0 || yi >= h || xi < 0 || xi >= w) {
    for (int cc = 0; cc < ch; ++cc) o[cc] = 0.f;
    return;
  }
  const int src_j = flip[b] ? w - 1 - xi : xi;
  const float* src = x + (((size_t)b * h + yi) * w + src_j) * ch;
  for (int cc = 0; cc < ch; ++cc) o[cc] = src[cc];
}

}  // namespace

// x and out (batch, h, w, ch) float32 NHWC, sin and cos (batch,) float32,
// flip (batch,) int32. Returns cudaGetLastError() after the launch (0 when it
// was accepted), or cudaErrorInvalidValue for arguments the kernel does not
// take. Launches on `stream` and does not synchronise.
extern "C" int medmamba_rotate_flip(const void* x, const void* sin_a,
                                    const void* cos_a, const void* flip,
                                    void* out, int batch, int h, int w,
                                    int ch, void* stream) {
  if (batch < 1 || h < 1 || w < 1 || ch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t pixels = (size_t)batch * h * w;
  const size_t blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  rotate_flip_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(sin_a),
      static_cast<const float*>(cos_a), static_cast<const int*>(flip),
      static_cast<float*>(out), batch, h, w, ch);
  return (int)cudaGetLastError();
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
