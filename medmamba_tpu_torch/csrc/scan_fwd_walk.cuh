// The selective-scan (S6) forward walked over 64-step tiles: the body of K1
// (selective_scan_fwd.cu) and of K3 (selective_scan_hillis_fwd.cu). Each of
// them wraps walk() in a kernel of its own name, so a profile tells them
// apart; the recurrence, what bounds it and the design are in K1's header.
//
// Saved states. With a non-null `states` the walk writes the float32 state
// entering every kSpan-th 64-step tile of the group's processing order
// (tiles 0, kSpan, 2 kSpan, ...), (b, G*dpg, ceil(n_tiles / kSpan), 16):
// K1 every tile's (kSpan 1: K2 recomputes each tile from its entry), K3
// every other tile's (kSpan 2: its 128-step chunks, which K4 reads).
//
// The walk is written inline in one function that the kernels call with
// __forceinline__, taking the kernel's parameters: a walk split into a
// function taking a struct of its state ran 2.4x slower on an H100 (K2's).
//
// Compute modes (MEDMAMBA_SCAN_COMPUTE, a template parameter of the walk;
// the TPU kernels read it in pallas_scan.py:85-95):
//  * kFp32: the exact float32 recurrence;
//  * kBf16 (K1's bfloat16 mode): the decay a = exp(dt A) and the input
//    b = (dt u) B rounded to bfloat16, from dt u and B rounded; the state h
//    and y's sum float32 (as _ssd_forward_core's bf16 E and dub);
//  * kBf16State (K3's): as kBf16, and the state rounded to bfloat16 each
//    step, y summed in float32 from h C rounded, C rounded (as _fwd_kernel's
//    bf16 a, dbu, h and h C).
// Exponents, softplus, D u and every sum stay float32. A rounding is
// float32 arithmetic followed by one round-to-nearest-even to bfloat16;
// where both factors of a product are bfloat16 values (a h, h C) the
// product is exact in float32, so a fused multiply-add and a multiply then
// an add round alike, and the plain versions can repeat the kernel's bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;                 // state size
constexpr int kThreads = 128;
constexpr int kT = 64;                 // time steps per tile: K2's tile
constexpr int kXP = kT + 1;            // pitch of the (dt, dt*u) rows, float2s
constexpr int kYP = kT + 4;            // pitch of the y rows, floats
constexpr int kBP = kN + 4;            // pitch of the B[t] and C[t] rows, floats
constexpr int kRP = kT + 8;            // pitch of the raw rows, elements
constexpr unsigned kAll = 0xffffffffu;
// the least number of 32-channel blocks at which they are launched; below
// it, 8-channel blocks
constexpr long long kWideMinBlocks = 132;
constexpr int kWideQ = 4;              // lanes per channel, wide blocks
constexpr int kNarrowQ = 16;           // lanes per channel, 8-channel blocks
constexpr int kMinBlocksWide = 3;      // blocks an SM the registers leave room for
constexpr int kMinBlocksNarrow = 4;
constexpr int kWalkSteps = 8;          // steps per group of the walk (wide)

// compute modes, the C entry points' `compute` argument (0 or 1) picks one
enum Compute { kFp32 = 0, kBf16 = 1, kBf16State = 2 };

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
  float* states;        // may be null: saved tile entries (see the header)
  int groups;
  int u_groups;
  int dpg;
  int L;
  int valid_len;
  int softplus;
  int rev_mask;         // bit g set: group g scans right to left
  int vec;              // every row 16-byte aligned: 16-byte copies
};

template <typename Tin, int kCh>
struct Smem {
  alignas(16) Tin raw_u[kCh][kRP];     // the next tile's rows as they arrive
  alignas(16) Tin raw_dl[kCh][kRP];
  alignas(16) Tin raw_B[kN][kRP];
  alignas(16) Tin raw_C[kN][kRP];
  alignas(16) float2 x[kCh][kXP];      // (dt, dt * u) of the tile walked
  alignas(16) float B[kT][kBP];        // B[t][n] of the tile walked
  alignas(16) float C[kT][kBP];
  alignas(16) float y[kCh][kYP];       // D * u, then + sum_n C * h
  float d_skip[kCh];
  float bias[kCh];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the nearest bfloat16 (ties to even), back in a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// v[0, kNS) rounded to bfloat16 in place, two values a conversion
template <int kNS>
__device__ __forceinline__ void bf16r_all(float* v) {
#pragma unroll
  for (int i = 0; i + 1 < kNS; i += 2) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[i], v[i + 1]);
    v[i] = __low2float(p);
    v[i + 1] = __high2float(p);
  }
  if constexpr (kNS % 2 == 1) v[kNS - 1] = bf16r(v[kNS - 1]);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// kNS consecutive floats from a 4 * kNS-byte aligned address, and back
template <int kNS> struct Vec;
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    o[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The shared-memory slot of processing step j of a tile of len steps. Steps
// j >= len take slot j, which the staging filled with dt = dt*u = 0: identity
// steps, so the walk needs no branch per step.
__device__ __forceinline__ int step_slot(int j, int len, bool rev) {
  return j >= len ? j : rev ? len - 1 - j : j;
}

// One level of the reduce-scatter over a channel's lanes: lanes kHalf apart
// pair up, each keeps the half of v[0, 2 kHalf) its lane bit selects, sends
// the other half and adds its partner's; the sums land in v[0, kHalf).
template <int kHalf>
__device__ __forceinline__ void halve(float* v, int q) {
  const bool hi = q & kHalf;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = hi ? v[kHalf + i] : v[i];
    const float send = hi ? v[i] : v[kHalf + i];
    v[i] = keep + __shfl_xor_sync(kAll, send, kHalf);
  }
}

// v[0, kQ) of the kQ lanes of a channel summed over the lanes: lane q is
// left with the sum of v[q], in v[0].
template <int kQ>
__device__ __forceinline__ float reduce_scatter(float* v, int q) {
  if constexpr (kQ >= 16) halve<8>(v, q);
  if constexpr (kQ >= 8) halve<4>(v, q);
  if constexpr (kQ >= 4) halve<2>(v, q);
  if constexpr (kQ >= 2) halve<1>(v, q);
  return v[0];
}

// Where element 0 of a tile's row lies in its raw row: 0, or 1 for a bf16
// row that starts in the upper half of a 4-byte word.
template <typename Tin>
__device__ __forceinline__ int row_shift(const Tin* row) {
  return sizeof(Tin) == 2 ? (int)((reinterpret_cast<uintptr_t>(row) >> 1) & 1)
                          : 0;
}

// Copy byte range [at, at + size) of a tile's row, whose element 0 is at
// `from`, into its raw row `to` (size 16 or 4). Bytes at or past `valid`,
// the end of the row's part, are zero-filled; a copy wholly past it reads
// nothing.
template <int kSize>
__device__ __forceinline__ void copy_part(void* to, const void* from, int at,
                                          int valid) {
  const int n = min(max(valid - at, 0), kSize);
  const char* src = static_cast<const char*>(from) + (n > 0 ? at : 0);
  if (kSize == 16) {
    cp_async16(static_cast<char*>(to) + at, src, n);
  } else {
    cp_async4(static_cast<char*>(to) + at, src, n);
  }
}

// Start copying the raw rows of the tile at t0 (len steps) into the raw
// buffer with cp.async: u and delta of the block's channels, B and C of its
// group. 16 bytes a copy when every row is 16-byte aligned, else the 4-byte
// words that cover each row's part, from the word that holds its first
// element (row_shift says where that element lands). Zeros past len; the
// caller waits before it reads them.
template <typename Tin, int kCh>
__device__ __forceinline__ void stage_tile(
    Smem<Tin, kCh>& s, const Tin* u_base, const Tin* dl_base,
    const Tin* B_base, const Tin* C_base, int L, bool vec, int t0, int len,
    int n_ch, int tid) {
  const int len_bytes = len * (int)sizeof(Tin);
  if (vec) {
    constexpr int kCpr = kT * sizeof(Tin) / 16;   // copies per row
    for (int i = tid; i < n_ch * kCpr; i += kThreads) {
      const int r = i / kCpr;
      const int at = 16 * (i % kCpr);
      const size_t off = (size_t)r * L + t0;
      copy_part<16>(s.raw_u[r], u_base + off, at, len_bytes);
      copy_part<16>(s.raw_dl[r], dl_base + off, at, len_bytes);
    }
    for (int i = tid; i < kN * kCpr; i += kThreads) {
      const int r = i / kCpr;
      const int at = 16 * (i % kCpr);
      const size_t off = (size_t)r * L + t0;
      copy_part<16>(s.raw_B[r], B_base + off, at, len_bytes);
      copy_part<16>(s.raw_C[r], C_base + off, at, len_bytes);
    }
  } else {
    constexpr int kWpr = kT * sizeof(Tin) / 4 + (sizeof(Tin) == 2);
    for (int i = tid; i < n_ch * kWpr; i += kThreads) {
      const int r = i / kWpr;
      const int at = 4 * (i % kWpr);
      const size_t off = (size_t)r * L + t0;
      const int lu = row_shift(u_base + off) * (int)sizeof(Tin);
      const int ld = row_shift(dl_base + off) * (int)sizeof(Tin);
      copy_part<4>(s.raw_u[r], reinterpret_cast<const char*>(u_base + off) -
                   lu, at, lu + len_bytes);
      copy_part<4>(s.raw_dl[r], reinterpret_cast<const char*>(dl_base + off) -
                   ld, at, ld + len_bytes);
    }
    for (int i = tid; i < kN * kWpr; i += kThreads) {
      const int r = i / kWpr;
      const int at = 4 * (i % kWpr);
      const size_t off = (size_t)r * L + t0;
      const int lb = row_shift(B_base + off) * (int)sizeof(Tin);
      const int lc = row_shift(C_base + off) * (int)sizeof(Tin);
      copy_part<4>(s.raw_B[r], reinterpret_cast<const char*>(B_base + off) -
                   lb, at, lb + len_bytes);
      copy_part<4>(s.raw_C[r], reinterpret_cast<const char*>(C_base + off) -
                   lc, at, lc + len_bytes);
    }
  }
  cp_async_commit();
}

// The walk of one block (grid: channel blocks of kThreads / kQ channels,
// groups, batch; kThreads threads; a dynamic Smem<Tin, kThreads / kQ>). Tin:
// u, delta, B, C. Tout: y. kQ lanes per channel (4 or 16). kSpan: tiles per
// saved state. kMode: the compute mode.
template <typename Tin, typename Tout, int kQ, int kSpan, int kMode>
__device__ __forceinline__ void walk(const Params& p) {
  constexpr int kCh = kThreads / kQ;   // channels per block
  constexpr int kNS = kN / kQ;         // states per lane
  constexpr int kG = kQ < kWalkSteps ? kWalkSteps : kQ;  // steps per group
  extern __shared__ float4 smem_raw[];
  Smem<Tin, kCh>& s = *reinterpret_cast<Smem<Tin, kCh>*>(smem_raw);

  const int c0 = blockIdx.x * kCh;     // first channel of the block in its group
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int q = lane % kQ;             // the lane's share of the states
  const int lc = (tid / 32) * (32 / kQ) + lane / kQ;  // its channel
  const int n_ch = min(kCh, p.dpg - c0);
  const bool active = lc < n_ch;
  const int L = p.L;
  const int d_all = p.groups * p.dpg;
  const int d0 = g * p.dpg + c0;       // first channel of the block overall
  const bool rev = (p.rev_mask >> g) & 1;
  const int n_tiles = (L + kT - 1) / kT;
  const int n_states = (n_tiles + kSpan - 1) / kSpan;
  const bool vec = p.vec;

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

  if (tid < kCh) {
    const bool on = tid < n_ch;
    s.d_skip[tid] = (on && p.D != nullptr) ? p.D[d0 + tid] : 0.f;
    s.bias[tid] = (on && p.bias != nullptr) ? p.bias[d0 + tid] : 0.f;
  }
  float a_n[kNS], h[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    a_n[i] = active ? p.A[(size_t)(d0 + lc) * kN + kNS * q + i] : 0.f;
    h[i] = 0.f;
  }

  {
    const int t0 = (rev ? n_tiles - 1 : 0) * kT;
    stage_tile(s, u_base, dl_base, B_base, C_base, L, vec, t0,
               min(kT, L - t0), n_ch, tid);
  }
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = (rev ? n_tiles - 1 - k : k) * kT;
    const int len = min(kT, L - t0);
    cp_async_wait_all();
    // the raw rows of tile k are in; the last tile's walk and copy-out are
    // done with x, B, C and y
    __syncthreads();

    for (int i = tid; i < kCh * kT; i += kThreads) {
      const int cc = i / kT;
      const int tt = i % kT;
      float dt = 0.f;
      float dtu = 0.f;
      float y0 = 0.f;
      if (cc < n_ch && tt < len) {
        const int sh = row_shift(u_base + (size_t)cc * L + t0);
        const float uv = to_f(s.raw_u[cc][sh + tt]);
        float dv = to_f(s.raw_dl[cc][row_shift(dl_base + (size_t)cc * L + t0) +
                                    tt]) + s.bias[cc];
        // torch's softplus (threshold 20), with the accurate expf/log1pf
        if (p.softplus) dv = dv > 20.f ? dv : log1pf(expf(dv));
        if (t0 + tt < p.valid_len) {   // else pad: decay 1, inject 0
          dt = dv;
          dtu = dv * uv;
          if constexpr (kMode != kFp32) dtu = bf16r(dtu);
        }
        y0 = s.d_skip[cc] * uv;
      }
      s.x[cc][tt] = make_float2(dt, dtu);
      s.y[cc][tt] = y0;
    }
    // B and C as [t][16] rows, 4 states a thread
    for (int i = tid; i < 2 * (kN / 4) * kT; i += kThreads) {
      const int tt = i % kT;
      const int nq = (i / kT) % (kN / 4);
      const bool is_c = i >= (kN / 4) * kT;
      const Tin* base = (is_c ? C_base : B_base) + (size_t)4 * nq * L + t0;
      const Tin* src = is_c ? &s.raw_C[4 * nq][tt] : &s.raw_B[4 * nq][tt];
      float* dst = is_c ? &s.C[tt][4 * nq] : &s.B[tt][4 * nq];
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = to_f(src[j * kRP + row_shift(base + (size_t)j * L)]);
      }
      // B in both bfloat16 modes, C where y sums h C rounded
      if constexpr (sizeof(Tin) == 4 && kMode != kFp32) {
        if (kMode == kBf16State || !is_c) bf16r_all<4>(v);
      }
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
    // the raw buffer is free once every thread has passed this barrier
    __syncthreads();
    if (k + 1 < n_tiles) {
      const int t1 = (rev ? n_tiles - 2 - k : k + 1) * kT;
      stage_tile(s, u_base, dl_base, B_base, C_base, L, vec, t1,
                 min(kT, L - t1), n_ch, tid);
    }
    if (p.states != nullptr && active && k % kSpan == 0) {
      Vec<kNS>::store(p.states + ((size_t)(b * d_all + d0 + lc) * n_states +
                                  k / kSpan) * kN + kNS * q, h);
    }

    // every lane of a channel walks the same steps, so each reaches every
    // shuffle of the reduce-scatter
    for (int j0 = 0; j0 < len; j0 += kG) {
      float v[kG];   // the lane's states' share of y, per step of the group
#pragma unroll
      for (int jj = 0; jj < kG; ++jj) {
        const int tt = step_slot(j0 + jj, len, rev);
        const float2 xv = s.x[lc][tt];
        float bq[kNS], cq[kNS];
        Vec<kNS>::load(&s.B[tt][kNS * q], bq);
        Vec<kNS>::load(&s.C[tt][kNS * q], cq);
        float acc = 0.f;
        if constexpr (kMode == kFp32) {
#pragma unroll
          for (int i = 0; i < kNS; ++i) {
            h[i] = expf(xv.x * a_n[i]) * h[i] + xv.y * bq[i];
            acc += h[i] * cq[i];
          }
        } else {
          float a[kNS], in[kNS];
#pragma unroll
          for (int i = 0; i < kNS; ++i) {
            a[i] = expf(xv.x * a_n[i]);
            in[i] = xv.y * bq[i];
          }
          bf16r_all<kNS>(a);
          bf16r_all<kNS>(in);
#pragma unroll
          for (int i = 0; i < kNS; ++i) h[i] = a[i] * h[i] + in[i];
          if constexpr (kMode == kBf16State) {
            float hc[kNS];
            bf16r_all<kNS>(h);
#pragma unroll
            for (int i = 0; i < kNS; ++i) hc[i] = h[i] * cq[i];
            bf16r_all<kNS>(hc);
#pragma unroll
            for (int i = 0; i < kNS; ++i) acc += hc[i];
          } else {
#pragma unroll
            for (int i = 0; i < kNS; ++i) acc += h[i] * cq[i];
          }
        }
        v[jj] = acc;
      }
#pragma unroll
      for (int r = 0; r < kG; r += kQ) {
        const float yv = reduce_scatter<kQ>(v + r, q);
        s.y[lc][step_slot(j0 + r + q, len, rev)] += yv;
      }
    }
    __syncthreads();

    for (int i = tid; i < kCh * kT; i += kThreads) {
      const int cc = i / kT;
      const int tt = i % kT;
      if (cc < n_ch && tt < len) {
        y_base[(size_t)cc * L + t0 + tt] = from_f<Tout>(s.y[cc][tt]);
      }
    }
  }

  if (p.last != nullptr && active) {
    Vec<kNS>::store(p.last + (size_t)(b * d_all + d0 + lc) * kN + kNS * q, h);
  }
}

// Wide blocks when there are enough of them to fill the card, else 8-channel
// blocks (see K1's header)
inline bool use_wide(int batch, int groups, int dpg) {
  constexpr int kWideCh = kThreads / kWideQ;
  return (long long)batch * groups * ((dpg + kWideCh - 1) / kWideCh) >=
         kWideMinBlocks;
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The walk's parameters from an entry point's arguments (in_dtype 0 =
// float32, 1 = bfloat16): 16-byte copies when every row is 16-byte aligned.
inline Params make_params(const void* u, const void* delta, const void* A,
                          const void* B, const void* C, const void* D,
                          const void* bias, void* y, void* last,
                          void* states, int groups, int u_groups, int dpg,
                          int L, int valid_len, int softplus, int rev_mask,
                          int in_dtype) {
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
  const size_t row_bytes = (size_t)L * (in_dtype == 0 ? 4 : 2);
  p.vec = row_bytes % 16 == 0 && aligned16(u) && aligned16(delta) &&
          aligned16(B) && aligned16(C);
  return p;
}

// Launch `kernel`, a wrapper of walk<Tin, ., kQ, .>, over batch rows on
// `stream`; returns cudaGetLastError() after the launch.
template <typename Tin, int kQ>
cudaError_t launch_walk(void (*kernel)(Params), const Params& p, int batch,
                        cudaStream_t stream) {
  constexpr int kCh = kThreads / kQ;
  const int smem = (int)sizeof(Smem<Tin, kCh>);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.dpg + kCh - 1) / kCh, p.groups, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
