// The exact fp32 adjoint of the selective scan (S6), walked over 64-step
// tiles from their entry states: the body of K2 (selective_scan_bwd.cu) and
// of K4 (selective_scan_hillis_bwd.cu). Each of them wraps walk() and
// reduce_partials() in kernels of its own name, so a profile tells them
// apart; the formulas are in K2's header.
//
// The walk. A block of 128 threads owns 32 channels of one group: each warp
// owns 8 channels, four lanes per channel, each lane four of the 16 states.
// The block walks the 64-step tiles opposite to the scan direction:
//
//  * Staging. u, softplus(x), softplus'(x) and gy of the tile are packed per
//    (channel, step) into one float4 in shared memory, B and C per step as
//    16 floats, so a lane reads its channel's operands and its four B and C
//    with three 16-byte loads a step. The staging is not double-buffered:
//    three resident blocks an SM overlap one block's loads with the
//    others' walks.
//  * Recompute in two levels. From the tile's entry state a first pass keeps
//    the state at each 8-step sub-tile's entry (in shared memory); then,
//    sub-tile by sub-tile from the last, a second pass keeps h_{t-1} and a_t
//    of 8 steps x 4 states in registers, and the walk reuses a_t: 1.875
//    exponentials per element in all (the first pass skips the last
//    sub-tile). With 16-step sub-tiles the kernel took 251 registers, 2
//    blocks an SM, and was 1.3-1.7x slower on an H100.
//  * du and ddelta: a lane sums its four states in registers; the channel's
//    four lanes meet in two shuffles (each lane sends the sum it does not
//    keep, then the pairs add), so lane 0 holds du and lane 1 ddt. They are
//    written into the step's shared slot (whose operands every lane of the
//    channel has read before the shuffle) and copied out once per tile.
//  * dB and dC without atomics. A lane's 8 values of a step (dB, dC of its
//    4 states) are summed over the warp's 8 channels by a reduce-scatter of
//    4 + 2 + 1 shuffles, which leaves each lane one of the step's 32 sums;
//    the warps write their rows to shared memory, and after each sub-tile
//    the block adds the 4 rows in a fixed order and writes one partial per
//    (b, g, 32-channel block, which, n, t) to a workspace. reduce_partials,
//    run by a second kernel right after, adds the channel blocks' partials
//    in order into dB and dC.
//  * dA, dD and dbias: summed over the block's tiles in registers, written
//    as one partial per (b, d) and added over b by reduce_partials.
//
// Compute modes (MEDMAMBA_SCAN_COMPUTE, a template parameter of the walk;
// the TPU kernels read it in pallas_scan.py:85-95). The recompute rounds as
// the forward's mode did (scan_fwd_walk.cuh): in kBf16 (K2's) the decay and
// the input rounded to bfloat16, from dt u and B rounded; in kBf16State
// (K4's) the state h too, each step. B and C are read rounded everywhere
// in both modes, and q = C gy is rounded from gy rounded (as _part_bwd's
// and _bwd_kernel's bf16 q); in kBf16State the adjoint dh is rounded each
// step as well (as _bwd_kernel's bf16 dh). The carry a dh, which leaves a
// tile and a chunk, every sum and every gradient stay float32.
//
// No output is written with an atomic, so every output is the same bits on
// every run. The walk is written inline in one function that the kernels
// call with __forceinline__: a walk split into a function taking a struct
// of its state ran 2.4x slower on an H100.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kN = 16;                  // state size
constexpr int kQ = 4;                   // lanes per channel
constexpr int kNS = kN / kQ;            // states per lane
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCh = kWarps * 32 / kQ;   // channels per block: 32
constexpr int kT = 64;                  // time steps per tile: K1's tile
constexpr int kS = 8;                   // steps per sub-tile
constexpr int kSub = kT / kS;
constexpr int kXP = kT + 1;             // pitch of the per-channel float4s
constexpr int kW = 2 * kN;              // dB and dC sums of one step: 32
constexpr int kRP = kW + 1;             // padded pitch of a reduction row
constexpr unsigned kAll = 0xffffffffu;

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
  const float* states;  // (b, G*dpg, n_tiles, 16): each tile's entry state
  const void* gy;
  void* du;             // (b, G*dpg, L): per scan group, in the input type
  void* ddelta;         // (b, G*dpg, L), in the input type
  float* ws_bc;         // (b, G, n_cb, 32, L): dB/dC partials per channel block
  float* ws_a;          // (b, G*dpg, 16): dA partials per batch
  float* ws_d;          // (b, G*dpg): dD partials per batch
  float* ws_bias;       // (b, G*dpg): dbias partials per batch
  int groups;
  int u_groups;
  int dpg;
  int n_cb;             // channel blocks per group
  int L;
  int valid_len;
  int softplus;
  int rev_mask;         // bit g set: group g scans right to left
  int mask_gy;          // 1: gy counts as 0 at steps >= valid_len (K4)
};

struct Smem {
  float4 x[kCh][kXP];            // (dt, u, gy, softplus'); after the walk
                                 // passes a step: (du, ddelta, ., .)
  float4 B[kT][kQ];              // B[t][n] as 4 quarters of 4 states
  float4 C[kT][kQ];
  float red[2][kWarps][kS][kRP]; // per warp and step: the 32 dB/dC sums
  float4 ck[kSub][kThreads];     // each sub-tile's entry state, per thread
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the nearest bfloat16 (ties to even), back in a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// v[0, 4) rounded to bfloat16 in place, two values a conversion
__device__ __forceinline__ void bf16r4(float* v) {
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[i], v[i + 1]);
    v[i] = __low2float(p);
    v[i + 1] = __high2float(p);
  }
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One step of a lane's kNS states in a bfloat16 mode: a = exp(dt A) and
// b = dtu_r B rounded (dtu_r is dt u rounded, bq the step's rounded B), then
// h = a h + b, rounded too in kBf16State; a is left in `a`.
template <int kMode>
__device__ __forceinline__ void step_bf16(float* h, float* a, float dt,
                                          float dtu_r, const float4& bq,
                                          const float* a_n) {
  float in[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    a[i] = expf(dt * a_n[i]);
    in[i] = dtu_r * get(bq, i);
  }
  bf16r4(a);
  bf16r4(in);
#pragma unroll
  for (int i = 0; i < kNS; ++i) h[i] = a[i] * h[i] + in[i];
  if constexpr (kMode == kBf16State) bf16r4(h);
}

// One level of the reduce-scatter over a warp's channels: lanes kHalf * 4
// apart pair up, each keeps the half of v[0, 2 kHalf) its lane bit selects,
// sends the other half and adds its partner's; the sums land in v[0, kHalf).
template <int kHalf>
__device__ __forceinline__ void scatter_level(float* v, int lane) {
  const bool hi = lane & (kHalf * kQ);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = hi ? v[kHalf + i] : v[i];
    const float send = hi ? v[i] : v[kHalf + i];
    v[i] = keep + __shfl_xor_sync(kAll, send, kHalf * kQ);
  }
}

// The shared-memory slot of processing step j of a tile of len steps. Steps
// j >= len (the tile's last sub-tile, when len is no multiple of kS) take
// slot j, which the staging filled with zeros: dt = 0 makes a = 1 and adds
// nothing to h, and gy = C = B = softplus' = 0 leave the carry as it is
// and add nothing to any gradient; their du, ddelta and dB/dC rows land in
// slots that are never copied out. So the walk needs no branch per step.
__device__ __forceinline__ int step_slot(int j, int len, bool rev) {
  return j >= len ? j : rev ? len - 1 - j : j;
}

// The walk of one block (grid: n_cb, groups, batch; kThreads threads; a
// dynamic Smem). Tin: u, delta, B, C and the gradients du, ddelta. Tg: gy.
// kMode: the compute mode.
template <typename Tin, typename Tg, int kMode>
__device__ __forceinline__ void walk(const Params& p) {
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int cb = blockIdx.x;
  const int c0 = cb * kCh;              // first channel of the block in its group
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q = lane % kQ;              // the lane's quarter of the states
  const int cw = lane / kQ;             // the lane's channel in the warp
  const int lc = warp * (32 / kQ) + cw; // the lane's channel in the block
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
  float* ws_base =
      p.ws_bc + (((size_t)b * p.groups + g) * p.n_cb + cb) * kW * L;
  const float4* st_base = reinterpret_cast<const float4*>(
      p.states + ((size_t)b * d_all + d0 + lc) * n_tiles * kN) + q;

  float a_n[kNS], carry[kNS], acc_dA[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    a_n[i] = active ? p.A[(size_t)(d0 + lc) * kN + kNS * q + i] : 0.f;
    carry[i] = 0.f;                   // a_{t+1} * dh_{t+1}, across tiles
    acc_dA[i] = 0.f;
  }
  const float d_skip = (active && p.D != nullptr) ? p.D[d0 + lc] : 0.f;
  float acc_dD = 0.f;                 // lane q == 0 only
  float acc_db = 0.f;                 // lane q == 1 only
  int buf = 0;

  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = (rev ? n_tiles - 1 - k : k) * kT;
    const int len = min(kT, L - t0);
    const int n_sub = (len + kS - 1) / kS;

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
          // torch's softplus (threshold 20), as K1 and K3 take it, and its
          // derivative
          const float e = expf(x);
          dv = x > 20.f ? x : log1pf(e);
          sg = x > 20.f ? 1.f : e / (1.f + e);
        } else {
          dv = x;
          sg = 1.f;
        }
        if (t0 + tt >= p.valid_len) {   // pad: dt is the constant 0
          dv = 0.f;
          sg = 0.f;
          if (p.mask_gy) gv = 0.f;
        }
      }
      s.x[cc][tt] = make_float4(dv, uv, gv, sg);
    }
    for (int i = tid; i < kQ * kT; i += kThreads) {
      const int qq = i / kT;
      const int tt = i % kT;
      float bv[kNS], cv[kNS];
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        bv[j] = 0.f;
        cv[j] = 0.f;
        if (tt < len) {
          const size_t off = (size_t)(kNS * qq + j) * L + t0 + tt;
          bv[j] = to_f(B_base[off]);
          cv[j] = to_f(C_base[off]);
        }
      }
      if constexpr (sizeof(Tin) == 4 && kMode != kFp32) {
        bf16r4(bv);
        bf16r4(cv);
      }
      s.B[tt][qq] = make_float4(bv[0], bv[1], bv[2], bv[3]);
      s.C[tt][qq] = make_float4(cv[0], cv[1], cv[2], cv[3]);
    }
    __syncthreads();

    // first level: the state at each sub-tile's entry (K1's arithmetic)
    float4 h4 = active ? st_base[(size_t)k * kQ] : make_float4(0, 0, 0, 0);
    s.ck[0][tid] = h4;
    for (int sb = 0; sb + 1 < n_sub; ++sb) {
      float h[kNS] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int jj = 0; jj < kS; ++jj) {
        const int j = sb * kS + jj;   // below len: not the last sub-tile
        const int tt = rev ? len - 1 - j : j;
        const float4 xv = s.x[lc][tt];
        const float4 bq = s.B[tt][q];
        const float dtu = xv.x * xv.y;
        if constexpr (kMode == kFp32) {
#pragma unroll
          for (int i = 0; i < kNS; ++i) {
            h[i] = expf(xv.x * a_n[i]) * h[i] + dtu * get(bq, i);
          }
        } else {
          float a[kNS];
          step_bf16<kMode>(h, a, xv.x, bf16r(dtu), bq, a_n);
        }
      }
      h4 = make_float4(h[0], h[1], h[2], h[3]);
      s.ck[sb + 1][tid] = h4;
    }

    // second level and the walk, sub-tile by sub-tile from the last, every
    // step without a branch (past len they are identity steps, see
    // step_slot), so every lane reaches each shuffle
    for (int sb = n_sub - 1; sb >= 0; --sb) {
      float hp[kS][kNS];   // h before each step, in processing order
      float ap[kS][kNS];   // a_t of each step
      {
        const float4 e4 = s.ck[sb][tid];
        float h[kNS] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
        for (int jj = 0; jj < kS; ++jj) {
          const int tt = step_slot(sb * kS + jj, len, rev);
          const float4 xv = s.x[lc][tt];
          const float4 bq = s.B[tt][q];
          const float dtu = xv.x * xv.y;
          if constexpr (kMode == kFp32) {
#pragma unroll
            for (int i = 0; i < kNS; ++i) {
              const float a = expf(xv.x * a_n[i]);
              hp[jj][i] = h[i];
              ap[jj][i] = a;
              h[i] = a * h[i] + dtu * get(bq, i);
            }
          } else {
#pragma unroll
            for (int i = 0; i < kNS; ++i) hp[jj][i] = h[i];
            step_bf16<kMode>(h, ap[jj], xv.x, bf16r(dtu), bq, a_n);
          }
        }
      }

#pragma unroll
      for (int jj = kS - 1; jj >= 0; --jj) {
        const int tt = step_slot(sb * kS + jj, len, rev);
        const float4 xv = s.x[lc][tt];
        const float4 bq = s.B[tt][q];
        const float4 cq = s.C[tt][q];
        const float dt = xv.x;
        const float uv = xv.y;
        const float gv = xv.z;
        const float dtu = dt * uv;
        float sum_b = 0.f;   // sum over the lane's states of dh * B
        float sum_q = 0.f;   // ... of dh * h_{t-1} * a_t * A
        float v[2 * kNS];    // dB, dC of the lane's states
        // dt u and gy rounded, for the modes' b and q
        const float dtu_r = kMode == kFp32 ? 0.f : bf16r(dtu);
        const float gv_r = kMode == kFp32 ? 0.f : bf16r(gv);
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const float a = ap[jj][i];
          const float bv = get(bq, i);
          const float ha = hp[jj][i] * a;
          float h_t, dh;
          if constexpr (kMode == kFp32) {
            h_t = ha + dtu * bv;
            dh = get(cq, i) * gv + carry[i];
          } else {
            h_t = ha + bf16r(dtu_r * bv);
            dh = bf16r(get(cq, i) * gv_r) + carry[i];
            if constexpr (kMode == kBf16State) {
              h_t = bf16r(h_t);
              dh = bf16r(dh);
            }
          }
          carry[i] = a * dh;
          const float qd = dh * ha;
          acc_dA[i] += qd * dt;
          sum_q += qd * a_n[i];
          sum_b += dh * bv;
          v[i] = dh * dtu;
          v[kNS + i] = h_t * gv;
        }
        // du (without D * gy) and ddt over the channel's four lanes: odd
        // lanes keep ddt, even lanes du, and send the other
        const float p_du = dt * sum_b;
        const float p_dt = sum_q + uv * sum_b;
        const bool odd = q & 1;
        float r = odd ? p_dt : p_du;
        r += __shfl_xor_sync(kAll, odd ? p_du : p_dt, 1);
        r += __shfl_xor_sync(kAll, r, 2);
        if (q == 0) {
          s.x[lc][tt].x = r + d_skip * gv;
          acc_dD += gv * uv;
        } else if (q == 1) {
          const float ddl = r * xv.w;
          s.x[lc][tt].y = ddl;
          acc_db += ddl;
        }
        // dB and dC over the warp's 8 channels
        scatter_level<4>(v, lane);
        scatter_level<2>(v, lane);
        scatter_level<1>(v, lane);
        // lane (cw, q) now holds the sum for which = cw / 4 and
        // n = 4 q + cw % 4
        s.red[buf][warp][jj][(cw / kNS) * kN + kNS * q + cw % kNS] = v[0];
      }
      __syncthreads();

      // the block's partial: the 4 warps' rows added in a fixed order
      for (int i = tid; i < kW * kS; i += kThreads) {
        const int w = i / kS;
        const int jj = i % kS;
        const int j = sb * kS + jj;
        if (j < len) {
          const int tt = rev ? len - 1 - j : j;
          float sum = s.red[buf][0][jj][w];
#pragma unroll
          for (int r = 1; r < kWarps; ++r) sum += s.red[buf][r][jj][w];
          ws_base[(size_t)w * L + t0 + tt] = sum;
        }
      }
      buf ^= 1;
      // the next sub-tile writes the other buffer; the barrier after its
      // walk orders this one's reads before the buffer's next writes
    }

    for (int i = tid; i < kCh * kT; i += kThreads) {
      const int cc = i / kT;
      const int tt = i % kT;
      if (cc < n_ch && tt < len) {
        const size_t off = (size_t)cc * L + t0 + tt;
        const float4 o = s.x[cc][tt];
        du_base[off] = from_f<Tin>(o.x);
        ddl_base[off] = from_f<Tin>(o.y);
      }
    }
    __syncthreads();   // before the next tile's staging overwrites s.x
  }

  if (active) {
    const size_t dd = (size_t)b * d_all + d0 + lc;
    reinterpret_cast<float4*>(p.ws_a + dd * kN)[q] =
        make_float4(acc_dA[0], acc_dA[1], acc_dA[2], acc_dA[3]);
    if (q == 0) p.ws_d[dd] = acc_dD;
    if (q == 1) p.ws_bias[dd] = acc_db;
  }
}

// Adds the walk's partials in a fixed order: dB and dC over the channel
// blocks of a group, dA, dD and dbias over the batch. A grid-stride loop
// over every output element; dD and dbias may be null.
__device__ __forceinline__ void reduce_partials(const Params& p, int batch,
                                                float* dA, float* dB,
                                                float* dC, float* dD,
                                                float* dbias) {
  const int L = p.L;
  const int d_all = p.groups * p.dpg;
  const size_t n_bc = (size_t)batch * p.groups * kW * L;
  const size_t n_a = (size_t)d_all * kN;
  const size_t total = n_bc + n_a + 2 * (size_t)d_all;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      const size_t t = i % L;
      const size_t w = (i / L) % kW;        // which * 16 + n
      const size_t bg = i / ((size_t)L * kW);
      const float* src = p.ws_bc + (bg * p.n_cb * kW + w) * L + t;
      float sum = 0.f;
      for (int c = 0; c < p.n_cb; ++c) sum += src[(size_t)c * kW * L];
      float* dst = w < kN ? dB : dC;
      dst[(bg * kN + w % kN) * L + t] = sum;
    } else if (i < n_bc + n_a) {
      const size_t j = i - n_bc;
      float sum = 0.f;
      for (int bb = 0; bb < batch; ++bb) sum += p.ws_a[(size_t)bb * n_a + j];
      dA[j] = sum;
    } else {
      const size_t j = i - n_bc - n_a;
      const bool is_d = j < (size_t)d_all;
      const size_t dd = is_d ? j : j - d_all;
      float* dst = is_d ? dD : dbias;
      if (dst == nullptr) continue;
      const float* src = is_d ? p.ws_d : p.ws_bias;
      float sum = 0.f;
      for (int bb = 0; bb < batch; ++bb) sum += src[(size_t)bb * d_all + dd];
      dst[dd] = sum;
    }
  }
}

// Threads of the reduce kernel's blocks, and its grid for these sizes: one
// thread per output element, at most 8 blocks an SM of an H100.
constexpr int kReduceThreads = 256;

inline int reduce_blocks(int batch, int groups, int dpg, int L) {
  const size_t total = (size_t)batch * groups * kW * L +
                       (size_t)groups * dpg * (kN + 2);
  const size_t want = (total + kReduceThreads - 1) / kReduceThreads;
  return (int)(want < 1056 ? want : 1056);
}

// Sizes in floats of the walk's four workspaces for these sizes: the dB/dC
// partials, then the dA, dD and dbias partials.
inline void walk_workspace(int batch, int groups, int dpg, int L,
                           long long* sizes) {
  const long long n_cb = (dpg + kCh - 1) / kCh;
  const long long d_all = (long long)groups * dpg;
  sizes[0] = (long long)batch * groups * n_cb * kW * L;
  sizes[1] = (long long)batch * d_all * kN;
  sizes[2] = (long long)batch * d_all;
  sizes[3] = (long long)batch * d_all;
}

}  // namespace
