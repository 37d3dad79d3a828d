"""S6 selective scan: the plain PyTorch version and the public dispatcher.

Counterpart of ``medmamba_tpu/ops/selective_scan.py``, with the same layouts:

    u:      (B, KD, L)      float32 or bfloat16
    delta:  (B, KD, L)      (pre-bias, pre-softplus)
    A:      (KD, N)         float32, = -exp(A_logs)
    B, C:   (B, K, N, L)    grouped: channel d uses group d // (KD // K)
    D:      (KD,)           float32 skip connection
    delta_bias: (KD,)       float32

and the recurrence (per batch, channel d, state n):

    delta'_t = softplus(delta_t + delta_bias)
    h_t      = exp(delta'_t * A) * h_{t-1} + (delta'_t * B_t) * u_t
    y_t      = sum_n C_t[n] * h_t[n] + D * u_t

``selective_scan_ref`` is the plain version: a sequential float32 loop over L,
as ``selective_scan_seq`` is in the JAX package. ``selective_scan`` is the
entry point: on a CUDA tensor it launches the hand-written kernels that
``MEDMAMBA_SCAN_KERNEL`` selects (``ssd``, the default: ``ops/scan_cuda.py``,
K1 forward and K2 as its backward; ``hillis``: ``ops/scan_hillis.py``, K3
forward and K4 as its backward), on a CPU tensor it runs the plain version
and autograd differentiates its loop. Where no gradient is needed, the
forward goes through a graph op of ``ops/scan_op.py``, which
``torch.export`` keeps as one node and which runs the same kernel or plain
version. ``selective_scan_states_ref`` and ``selective_scan_bwd_ref`` are
the plain versions of K1's tile-entry states and of K2;
``selective_scan_hillis_ref`` and ``selective_scan_hillis_bwd_ref`` those of
K3 and K4.

The compute mode. ``MEDMAMBA_SCAN_COMPUTE=bfloat16``, read at each call as
the JAX package reads it (``pallas_scan.py:85-95 _compute_dtype``), runs a
CUDA tensor's scan in the kernels' bfloat16 mode; any other value, or none,
in float32. In the mode the kernels round the scan's per-step factors to
bfloat16: the decay a_t = exp(dt_t A), the input b_t = dt_t u_t B_t (from
dt_t u_t and B_t rounded), and in the backward q_t = C_t gy_t (from C_t and
gy_t rounded); the hillis pair (K3, K4) also carries the state h and the
adjoint dh in bfloat16, and sums y from h C_t rounded (C_t rounded), as the
TPU kernels' ``_fwd_kernel``/``_bwd_kernel`` do. Exponents, softplus,
``D * u``, every sum over states, channels, steps or the batch, and every
saved or carried boundary state stay float32. The plain versions take the
mode as their ``compute`` argument and round at the same points. A CPU
tensor's scan runs in float32 whatever the variable says, as the JAX
package's CPU path runs its float32 ``assoc`` scan
(``medmamba_tpu/ops/selective_scan.py:296-299``).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from medmamba_tpu_torch.ops import scan_cuda, scan_hillis

KERNELS = ("ssd", "hillis")
COMPUTES = ("float32", "bfloat16")


def _rounding(compute: str):
    """The rounding of the compute mode ``compute``: to bfloat16 and back
    in the bfloat16 mode, the identity in float32."""
    if compute not in COMPUTES:
        raise ValueError(f"compute {compute!r}: expected one of {COMPUTES}")
    if compute == "float32":
        return lambda x: x
    return lambda x: x.to(torch.bfloat16).float()


def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       return_last_state: bool = False,
                       compute: str = "float32"):
    """Sequential float32 scan (the numerical reference); with ``compute``
    "bfloat16" the plain version of K1's bfloat16 mode (a_t and b_t
    rounded, see the module's docstring; h and y float32).

    Returns y (B, KD, L) float32 and, optionally, the last state (B, KD, N).
    """
    r = _rounding(compute)
    u = u.float()
    delta = delta.float()
    A = A.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None]
    if delta_softplus:
        delta = F.softplus(delta)
    b, d, l = u.shape
    n = A.shape[1]
    g = B.shape[1]
    dpg = d // g
    # per-group views: the state is (B, G, dpg, N); B_t / C_t broadcast over dpg
    A4 = A.reshape(g, dpg, n)
    dt4 = delta.reshape(b, g, dpg, l)
    dtu4 = r(delta * u).reshape(b, g, dpg, l)
    Bm = r(B.float())
    Cm = C.float()
    h = u.new_zeros((b, g, dpg, n))
    ys = []
    for t in range(l):
        dA = r(torch.exp(dt4[..., t, None] * A4))
        h = dA * h + r(dtu4[..., t, None] * Bm[:, :, None, :, t])
        ys.append((h * Cm[:, :, None, :, t]).sum(-1))
    y = torch.stack(ys, dim=-1).reshape(b, d, l)
    if D is not None:
        y = y + u * D.float()[None, :, None]
    if return_last_state:
        return y, h.reshape(b, d, n)
    return y


def _flip_groups(x: torch.Tensor, g: int, reverse_dirs) -> torch.Tensor:
    """Flip the flagged groups of a (B, G*per, L) or (B, G, N, L) tensor along L."""
    shape = x.shape
    x4 = x.reshape(shape[0], g, -1, shape[-1])
    parts = [x4[:, k:k + 1].flip(-1) if f else x4[:, k:k + 1]
             for k, f in enumerate(reverse_dirs)]
    return torch.cat(parts, dim=1).reshape(shape)


def _tile_starts(l: int, rev: bool) -> list:
    """Processing-order index at which each of K1's 64-step tiles starts.
    Tiles sit at buffer positions [64m, 64m + 64); a reverse group visits
    the last (possibly short) one first."""
    tile = scan_cuda.TILE
    n_tiles = -(-l // tile)
    if not rev:
        return [tile * k for k in range(n_tiles)]
    return [l - min(l, tile * (n_tiles - k)) for k in range(n_tiles)]


def _groups_in_order(u, delta, B, C, delta_bias, delta_softplus,
                     reverse_dirs, u_tile, valid_len, r):
    """Per group, float32 operands in processing order (reverse groups
    flipped along L): a list of dicts with u, dt (b, dpg, L), the derivative
    of dt by delta ``fac`` (0 in the padded tail), B and C (b, N, L) passed
    through the compute mode's rounding ``r``, and the flag ``rev``."""
    b, d, l = delta.shape
    g = B.shape[1]
    dpg = d // g
    x = delta.float()
    if delta_bias is not None:
        x = x + delta_bias.float()[None, :, None]
    if delta_softplus:
        dt = F.softplus(x)
        fac = torch.where(x > 20.0, torch.ones_like(x), torch.sigmoid(x))
    else:
        dt, fac = x, torch.ones_like(x)
    if valid_len is not None and valid_len < l:
        pad = torch.arange(l, device=x.device) >= valid_len
        dt = dt.masked_fill(pad, 0.0)
        fac = fac.masked_fill(pad, 0.0)
    u = u.float()
    if u_tile > 1:
        u = torch.cat([u] * u_tile, dim=1)
    rev = list(reverse_dirs) if reverse_dirs is not None else [False] * g
    out = []
    for k in range(g):
        ch = slice(k * dpg, (k + 1) * dpg)
        grp = dict(u=u[:, ch], dt=dt[:, ch], fac=fac[:, ch],
                   B=r(B[:, k].float()), C=r(C[:, k].float()))
        if rev[k]:
            grp = {name: v.flip(-1) for name, v in grp.items()}
        grp["rev"] = rev[k]
        out.append(grp)
    return out


def selective_scan_states_ref(u: torch.Tensor, delta: torch.Tensor,
                              A: torch.Tensor, B: torch.Tensor,
                              C: torch.Tensor,
                              delta_bias: Optional[torch.Tensor] = None,
                              delta_softplus: bool = False,
                              reverse_dirs: Optional[Sequence[bool]] = None,
                              u_tile: int = 1,
                              valid_len: Optional[int] = None,
                              compute: str = "float32") -> torch.Tensor:
    """The plain version of K1's tile-entry states: the float32 state before
    each 64-step tile, (b, KD, n_tiles, N) in processing order, for the
    call-site contract of :func:`selective_scan`, in the compute mode
    ``compute``."""
    r = _rounding(compute)
    b, d, l = delta.shape
    g = B.shape[1]
    A4 = A.float().reshape(g, d // g, -1)
    per_group = []
    for k, grp in enumerate(_groups_in_order(
            u, delta, B, C, delta_bias, delta_softplus, reverse_dirs, u_tile,
            valid_len, r)):
        starts = set(_tile_starts(l, grp["rev"]))
        h = u.new_zeros((b, d // g, A4.shape[-1]), dtype=torch.float32)
        kept = []
        for j in range(l):
            if j in starts:
                kept.append(h)
            dt = grp["dt"][..., j, None]
            h = r(torch.exp(dt * A4[k])) * h \
                + r(r(dt * grp["u"][..., j, None]) * grp["B"][:, None, :, j])
        per_group.append(torch.stack(kept, dim=2))
    return torch.cat(per_group, dim=1)


def selective_scan_bwd_ref(u: torch.Tensor, delta: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           D: Optional[torch.Tensor],
                           delta_bias: Optional[torch.Tensor],
                           states: torch.Tensor, gy: torch.Tensor, *,
                           delta_softplus: bool = False,
                           reverse_dirs: Optional[Sequence[bool]] = None,
                           u_tile: int = 1,
                           valid_len: Optional[int] = None,
                           compute: str = "float32"):
    """The plain version of K2: the explicit adjoint of the scan.

    From the inputs, the tile-entry ``states`` and gy it recomputes each
    tile's states and walks the tile backwards with
    ``dh_t = C_t gy_t + a_{t+1} dh_{t+1}``, as K2 does. Returns
    ``(du, ddelta, dA, dB, dC, dD, dbias)`` in the dtypes of their primals
    (dD and dbias None where D and delta_bias are); see
    ``csrc/selective_scan_bwd.cu`` for the formulas. With ``compute``
    "bfloat16", K2's bfloat16 mode: the states recomputed as K1's mode
    computes them, B and C rounded wherever they are read, q_t = C_t gy_t
    rounded from gy_t rounded; dh, the carry and every sum float32.
    """
    r = _rounding(compute)
    b, d, l = delta.shape
    g = B.shape[1]
    dpg = d // g
    A4 = A.float().reshape(g, dpg, -1)
    gy = gy.float()
    du, ddt, dA, dB, dC = [], [], [], [], []
    groups = _groups_in_order(u, delta, B, C, delta_bias, delta_softplus,
                              reverse_dirs, u_tile, valid_len, r)
    for k, grp in enumerate(groups):
        uu, dt, Bg, Cg = grp["u"], grp["dt"], grp["B"], grp["C"]
        gyg = gy[:, k * dpg:(k + 1) * dpg]
        if grp["rev"]:
            gyg = gyg.flip(-1)
        a_k = A4[k]
        starts = _tile_starts(l, grp["rev"]) + [l]
        out = {name: [None] * l for name in ("du", "ddt", "dB", "dC")}
        dA_k = torch.zeros_like(a_k)
        carry = torch.zeros_like(states[:, :dpg, 0])
        for t in reversed(range(len(starts) - 1)):
            j0, j1 = starts[t], starts[t + 1]
            h = states[:, k * dpg:(k + 1) * dpg, t].float()
            h_prev, decay = [], []
            for j in range(j0, j1):
                a = r(torch.exp(dt[..., j, None] * a_k))
                h_prev.append(h)
                decay.append(a)
                h = a * h + r(r(dt[..., j, None] * uu[..., j, None])
                              * Bg[:, None, :, j])
            for j in reversed(range(j0, j1)):
                hp, a = h_prev[j - j0], decay[j - j0]
                dtu = dt[..., j, None] * uu[..., j, None]
                h_t = a * hp + r(r(dtu) * Bg[:, None, :, j])
                dh = r(Cg[:, None, :, j] * r(gyg[..., j, None])) + carry
                carry = a * dh
                dA_k = dA_k + (dh * hp * a * dt[..., j, None]).sum(0)
                out["du"][j] = (dh * dt[..., j, None] * Bg[:, None, :, j]
                                ).sum(-1)
                out["ddt"][j] = (dh * (hp * a * a_k + uu[..., j, None]
                                       * Bg[:, None, :, j])).sum(-1)
                out["dB"][j] = (dh * dtu).sum(1)
                out["dC"][j] = (h_t * gyg[..., j, None]).sum(1)
        parts = {name: torch.stack(v, dim=-1) for name, v in out.items()}
        parts["ddt"] = parts["ddt"] * grp["fac"]
        if grp["rev"]:
            parts = {name: v.flip(-1) for name, v in parts.items()}
        du.append(parts["du"])
        ddt.append(parts["ddt"])
        dB.append(parts["dB"])
        dC.append(parts["dC"])
        dA.append(dA_k)
    du = torch.cat(du, dim=1)
    ddelta = torch.cat(ddt, dim=1)
    u_full = u.float() if u_tile == 1 else torch.cat([u.float()] * u_tile, 1)
    dD = None
    if D is not None:
        du = du + gy * D.float()[None, :, None]
        dD = (gy * u_full).sum((0, 2))
    if u_tile > 1:
        du = du.reshape(b, u_tile, d // u_tile, l).sum(1)
    dbias = ddelta.sum((0, 2)) if delta_bias is not None else None
    return (du.to(u.dtype), ddelta.to(delta.dtype), torch.cat(dA, dim=0),
            torch.stack(dB, dim=1).to(B.dtype),
            torch.stack(dC, dim=1).to(C.dtype), dD, dbias)


class _KernelScan(torch.autograd.Function):
    """K1 forward, K2 backward: the counterpart of the JAX package's
    ``custom_vjp`` around its scan kernels (``pallas_scan.py:1585-1648``).
    ``kw`` holds the compute mode too, so the backward runs in the mode of
    the forward that ran, whatever the variable says by then."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, return_last_state,
                kw):
        y, last, states = scan_cuda.selective_scan_fwd(
            u, delta, A, B, C, D, delta_bias,
            return_last_state=return_last_state, return_states=True, **kw)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, states)
        ctx.kw = {k: v for k, v in kw.items() if k != "out_dtype"}
        if return_last_state:
            ctx.mark_non_differentiable(last)
            return y, last
        return y

    @staticmethod
    def backward(ctx, gy, *_):
        u, delta, A, B, C, D, delta_bias, states = ctx.saved_tensors
        grads = scan_cuda.selective_scan_bwd(
            u, delta, A, B, C, D, delta_bias, states, gy.contiguous(),
            **ctx.kw)
        return (*grads, None, None)


def _kernel_impl() -> str:
    """The kernel pair a CUDA tensor's scan runs: ``MEDMAMBA_SCAN_KERNEL``,
    read at each call as the JAX package reads it (``pallas_scan.py:924``):
    ``ssd`` (the default; K1/K2) or ``hillis`` (K3/K4)."""
    impl = os.environ.get("MEDMAMBA_SCAN_KERNEL", "ssd")
    if impl not in KERNELS:
        raise ValueError(f"MEDMAMBA_SCAN_KERNEL={impl!r}: expected one of "
                         f"{KERNELS}")
    return impl


def _compute_mode(x: torch.Tensor) -> str:
    """The compute mode of a scan on ``x``: on a CUDA tensor
    ``MEDMAMBA_SCAN_COMPUTE``, read at each call as the JAX package reads it
    (``pallas_scan.py:94``): ``bfloat16`` selects the kernels' bfloat16
    mode, anything else float32. On a CPU tensor float32 (see the module's
    docstring)."""
    if x.is_cuda and os.environ.get("MEDMAMBA_SCAN_COMPUTE") == "bfloat16":
        return "bfloat16"
    return "float32"


def _pow2ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _shift_r(x: torch.Tensor, step: int, fill: float) -> torch.Tensor:
    pad = torch.full(x.shape[:-1] + (step,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-step]], dim=-1)


def _shift_l(x: torch.Tensor, step: int, fill: float) -> torch.Tensor:
    pad = torch.full(x.shape[:-1] + (step,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x[..., step:], pad], dim=-1)


def _fwd_chunk_scan(a, x, h0):
    """Inclusive scan of h_t = a_t h_{t-1} + x_t over the last axis by
    Hillis-Steele doubling, the entry state h0 folded into the first step:
    ``pallas_scan.py:164 _fwd_chunk_scan``."""
    x = torch.cat([x[..., :1] + a[..., :1] * h0[..., None], x[..., 1:]], -1)
    acc = a
    span = _pow2ceil(x.shape[-1])
    step = 1
    while step < span:
        x = x + acc * _shift_r(x, step, 0.0)
        step *= 2
        if step < span:
            acc = acc * _shift_r(acc, step // 2, 1.0)
    return x


def _seq_chunk_scan(a, x, h0):
    """h_t = bf16(a_t h_{t-1} + x_t) step by step over the last axis from
    h0: K3's walk in the bfloat16 mode, the state rounded once a step (a_t
    and h_{t-1} are bfloat16 values, so a_t h_{t-1} is exact in float32)."""
    r = _rounding("bfloat16")
    hs, h = [], h0
    for t in range(x.shape[-1]):
        h = r(a[..., t] * h + x[..., t])
        hs.append(h)
    return torch.stack(hs, dim=-1)


def _seq_chunk_adjoint(a, q, carry):
    """dh_t = bf16(q_t + a_{t+1} dh_{t+1}) step by step from the last, the
    carry of the chunk after in the place of a_{t+1} dh_{t+1} at the last
    step: K4's walk in the bfloat16 mode. Returns dh and the carry a_0 dh_0
    into the chunk before."""
    r = _rounding("bfloat16")
    dhs = [None] * q.shape[-1]
    for t in reversed(range(q.shape[-1])):
        dhs[t] = r(q[..., t] + carry)
        carry = a[..., t] * dhs[t]
    return torch.stack(dhs, dim=-1), carry


def _bwd_chunk_scan(a, q, carry):
    """Suffix scan X_t = q_t + a_{t+1} X_{t+1} by doubling, the carry of
    the chunk after folded into the last step: ``pallas_scan.py:190
    _bwd_chunk_scan``."""
    q = torch.cat([q[..., :-1], q[..., -1:] + carry[..., None]], -1)
    p = _shift_l(a, 1, 1.0)
    span = _pow2ceil(q.shape[-1])
    step = 1
    while step < span:
        q = q + p * _shift_l(q, step, 0.0)
        step *= 2
        if step < span:
            p = p * _shift_l(p, step // 2, 1.0)
    return q


def _hillis_chunks(u, delta, A, B, C, delta_bias, delta_softplus, valid_len,
                   r):
    """Per 128-step chunk, in order, K3's float32 operands in the grouped
    layout (b, G, dpg, [N,] T): a dict of dt, its derivative ``sig`` by
    delta, u, the decays a, the inputs x = dt u B, B, C and the live mask
    (identity steps past ``valid_len``); a, x, B and C passed through the
    compute mode's rounding ``r`` where the kernels round them."""
    b, d, l = delta.shape
    g = B.shape[1]
    dpg = d // g
    xd = delta.float()
    if delta_bias is not None:
        xd = xd + delta_bias.float()[None, :, None]
    if delta_softplus:
        dt, sig = F.softplus(xd), torch.sigmoid(xd)
    else:
        dt, sig = xd, torch.ones_like(xd)
    live = torch.arange(l, device=xd.device) < (
        l if valid_len is None else valid_len)
    A5 = A.float().reshape(1, g, dpg, -1, 1)
    dt4, sig4 = dt.reshape(b, g, dpg, l), sig.reshape(b, g, dpg, l)
    u4 = u.float().reshape(b, g, dpg, l)
    B5, C5 = r(B.float())[:, :, None], r(C.float())[:, :, None]
    for t0 in range(0, l, scan_hillis.CHUNK):
        sl = slice(t0, min(t0 + scan_hillis.CHUNK, l))
        m = live[sl]
        dtc, uc = dt4[..., sl], u4[..., sl]
        a = torch.where(m, r(torch.exp(dtc[..., None, :] * A5)), 1.0)
        x = torch.where(m, r(r(dtc * uc)[..., None, :] * B5[..., sl]), 0.0)
        yield dict(sl=sl, live=m, dt=dtc, sig=sig4[..., sl], u=uc, a=a, x=x,
                   B=B5[..., sl], C=C5[..., sl])


def selective_scan_hillis_ref(u: torch.Tensor, delta: torch.Tensor,
                              A: torch.Tensor, B: torch.Tensor,
                              C: torch.Tensor,
                              D: Optional[torch.Tensor] = None,
                              delta_bias: Optional[torch.Tensor] = None,
                              delta_softplus: bool = False,
                              valid_len: Optional[int] = None,
                              compute: str = "float32"):
    """The plain version of K3: the chunked doubling scan, left to right,
    vectorized over (b, d, n); the TPU kernel's ``_fwd_kernel`` body. With
    ``compute`` "bfloat16", K3's bfloat16 mode, which no doubling can
    round as the kernel's walk does: each chunk walked step by step, the
    state rounded each step (``_seq_chunk_scan``), y summed in float32 from
    h C_t rounded.

    Operands as K3 takes them (u with all G*dpg channels, no flips).
    Returns ``(y, states, last)`` in float32: y (b, d, L), the state entering
    each 128-step chunk (b, d, n_chunks, N) and the state after the last step
    (b, d, N). Positions >= ``valid_len`` are identity steps.
    """
    r = _rounding(compute)
    scan = _fwd_chunk_scan if compute == "float32" else _seq_chunk_scan
    b, d, l = delta.shape
    g, n = B.shape[1], A.shape[1]
    h = u.new_zeros((b, g, d // g, n), dtype=torch.float32)
    ys, states = [], []
    for ck in _hillis_chunks(u, delta, A, B, C, delta_bias, delta_softplus,
                             valid_len, r):
        states.append(h)
        hc = scan(ck["a"], ck["x"], h)
        ys.append(r(hc * ck["C"]).sum(3))
        h = hc[..., -1]
    y = torch.cat(ys, dim=-1).reshape(b, d, l)
    if D is not None:
        y = y + u.float() * D.float()[None, :, None]
    states = torch.stack(states, dim=3).reshape(b, d, -1, n)
    return y, states, h.reshape(b, d, n)


def selective_scan_hillis_bwd_ref(u: torch.Tensor, delta: torch.Tensor,
                                  A: torch.Tensor, B: torch.Tensor,
                                  C: torch.Tensor, D: Optional[torch.Tensor],
                                  delta_bias: Optional[torch.Tensor],
                                  states: torch.Tensor, gy: torch.Tensor,
                                  delta_softplus: bool = False,
                                  valid_len: Optional[int] = None,
                                  compute: str = "float32"):
    """The plain version of K4: K3's adjoint by reverse doubling, chunks
    walked last to first; the TPU kernel's ``_bwd_kernel`` body. With
    ``compute`` "bfloat16", K4's bfloat16 mode: each chunk's states
    recomputed as K3's mode computes them, q_t = C_t gy_t rounded from
    C_t and gy_t rounded, and dh walked step by step and rounded each step
    (``_seq_chunk_adjoint``); B rounded wherever it is read; the carry
    between chunks and every sum float32.

    Each chunk's states are recomputed from its entry in ``states``;
    ``dh_t = C_t gy_t + a_{t+1} dh_{t+1}`` is solved by a suffix doubling
    with the carry ``a_0 dh_0`` handed to the chunk before. At positions >=
    ``valid_len`` gy counts as 0 and du and ddelta are 0. Returns ``(du,
    ddelta, dA, dB, dC, dD, dbias)`` in the dtypes of their primals (dD and
    dbias None where D and delta_bias are); see
    ``csrc/selective_scan_hillis_bwd.cu`` for the formulas.
    """
    r = _rounding(compute)
    b, d, l = delta.shape
    g, n = B.shape[1], A.shape[1]
    dpg = d // g
    st = states.float().reshape(b, g, dpg, -1, n)
    gy4 = gy.float().reshape(b, g, dpg, l)
    D4 = (D.float() if D is not None else A.new_zeros(d)).reshape(g, dpg, 1)
    A5 = A.float().reshape(1, g, dpg, n, 1)
    chunks = list(_hillis_chunks(u, delta, A, B, C, delta_bias,
                                 delta_softplus, valid_len, r))
    du, ddt, dB, dC = ([None] * len(chunks) for _ in range(4))
    dA = torch.zeros((g, dpg, n), dtype=torch.float32, device=A.device)
    dD = torch.zeros((g, dpg), dtype=torch.float32, device=A.device)
    carry = torch.zeros_like(st[..., 0, :])
    for ci in reversed(range(len(chunks))):
        ck = chunks[ci]
        h0 = st[..., ci, :]
        gyc = torch.where(ck["live"], gy4[..., ck["sl"]], 0.0)
        a = ck["a"]
        q = r(ck["C"] * r(gyc)[..., None, :])
        if compute == "float32":
            hc = _fwd_chunk_scan(a, ck["x"], h0)
            dh = _bwd_chunk_scan(a, q, carry)
            carry = a[..., 0] * dh[..., 0]
        else:
            hc = _seq_chunk_scan(a, ck["x"], h0)
            dh, carry = _seq_chunk_adjoint(a, q, carry)
        hprev = torch.cat([h0[..., None], hc[..., :-1]], dim=-1)
        p2 = dh * hprev * a
        dhB = (dh * ck["B"]).sum(3)
        dadt = (p2 * A5).sum(3)
        zero = torch.zeros_like(dhB)
        du[ci] = torch.where(ck["live"], ck["dt"] * dhB + D4 * gyc, zero)
        ddt[ci] = torch.where(ck["live"],
                              (ck["u"] * dhB + dadt) * ck["sig"], zero)
        dB[ci] = (dh * (ck["dt"] * ck["u"])[..., None, :]).sum(2)
        dC[ci] = (hc * gyc[..., None, :]).sum(2)
        dA = dA + (p2 * ck["dt"][..., None, :]).sum((0, 4))
        dD = dD + (gyc * ck["u"]).sum((0, 3))
    du =torch.cat(du, dim=-1).reshape(b, d, l)
    ddelta = torch.cat(ddt, dim=-1).reshape(b, d, l)
    dD = dD.reshape(d) if D is not None else None
    dbias = ddelta.sum((0, 2)) if delta_bias is not None else None
    return (du.to(u.dtype), ddelta.to(delta.dtype), dA.reshape(d, n),
            torch.cat(dB, dim=-1).to(B.dtype),
            torch.cat(dC, dim=-1).to(C.dtype), dD, dbias)


class _HillisScan(torch.autograd.Function):
    """The doubling scan with its adjoint as the backward: the counterpart
    of the JAX package's ``custom_vjp`` around ``_fwd_kernel`` and
    ``_bwd_kernel`` (``pallas_scan.py:1585-1648``).

    ``fwd`` and ``bwd`` compute the forward and the adjoint: the caller
    passes K3's and K4's launchers (``ops/scan_hillis.py``) or their plain
    versions; nothing here chooses between them. Both run in the compute
    mode ``compute``, the backward in the forward's. Returns ``(y, last)``,
    y in float32, the last state not differentiable; the gradients come
    back in the dtypes of their primals.
    """

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus,
                valid_len, fwd, bwd, compute):
        y, states, last = fwd(u, delta, A, B, C, D, delta_bias,
                              delta_softplus=delta_softplus,
                              valid_len=valid_len, compute=compute)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, states)
        ctx.kw = dict(delta_softplus=delta_softplus, valid_len=valid_len,
                      compute=compute)
        ctx.bwd = bwd
        ctx.mark_non_differentiable(last)
        return y, last

    @staticmethod
    def backward(ctx, gy, _):
        saved = ctx.saved_tensors
        grads = ctx.bwd(*saved, gy.float().contiguous(), **ctx.kw)
        grads = tuple(None if gr is None else gr.to(x.dtype)
                      for gr, x in zip(grads, saved))
        return (*grads, None, None, None, None, None)


def _hillis_scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
                 return_last_state, reverse_dirs, u_tile, valid_len, fwd,
                 bwd, compute="float32"):
    """The JAX package's wrapper around its doubling kernels
    (``pallas_scan.py:1704-1746``): a tiled u is materialized, flagged
    groups are flipped along L into a forward-only scan and y is flipped
    back; with flips, ``valid_len`` becomes delta = -1e4 at the pad
    positions before the flip (softplus gives dt = 0 there exactly) and is
    then dropped, else the scan masks it. y is float32 whatever the caller's
    ``out_dtype``. ``fwd``/``bwd`` and ``compute`` as for
    :class:`_HillisScan`."""
    g = B.shape[1]
    if u_tile > 1:
        u = torch.cat([u] * u_tile, dim=1)
    flip = reverse_dirs is not None and any(reverse_dirs)
    if flip:
        if valid_len is not None and valid_len < delta.shape[-1]:
            pos = torch.arange(delta.shape[-1], device=delta.device)
            delta = torch.where(pos < valid_len, delta,
                                torch.full_like(delta, -1e4))
        valid_len = None
        u, delta, B, C = (_flip_groups(x, g, reverse_dirs)
                          for x in (u, delta, B, C))
    y, last = _HillisScan.apply(u, delta, A, B, C, D, delta_bias,
                                delta_softplus, valid_len, fwd, bwd, compute)
    if flip:
        y = _flip_groups(y, g, reverse_dirs)
    return (y, last) if return_last_state else y


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False,
                   return_last_state: bool = False,
                   impl: str = "auto",
                   reverse_dirs: Optional[Sequence[bool]] = None,
                   tau: Optional[int] = None,
                   u_tile: int = 1,
                   out_dtype=None,
                   valid_len: Optional[int] = None):
    """Selective scan with the JAX package's call-site contract.

    impl: "auto" launches the CUDA kernels on a CUDA tensor and runs the
    plain sequential version on a CPU tensor, through a graph op of
    ``ops/scan_op.py`` where no gradient is needed (the eval forward, and
    what ``torch.export`` traces); "ref" runs the plain version on any
    device, never through an op. On a CUDA tensor the environment variable
    ``MEDMAMBA_SCAN_KERNEL``, read at each call, selects the kernels as it
    does in the JAX package: ``ssd`` (the default) runs K1 and K2 as its
    backward; ``hillis`` runs K3 and K4 as its backward (the JAX package's
    doubling scan, computed by sequential walks on the card),
    with the JAX wrapper's semantics (reverse groups flipped around a
    forward-only scan, y always float32, see :func:`_hillis_scan`); and
    ``MEDMAMBA_SCAN_COMPUTE``, read at each call too, their compute mode
    (``bfloat16`` or float32, see the module's docstring; the backward runs
    in its forward's mode). "ref" and a CPU tensor compute in float32.

    tau: accepted and ignored. It was the TPU kernel's segment length; both
    versions here compute the exact recurrence at any magnitude.

    reverse_dirs: per-group flags; a flagged group scans right to left and
    its y comes back in buffer order (the last state is then the state after
    position 0).

    u_tile: u carries ``G // u_tile`` groups of channels; scan group k reads u
    group ``k % (G // u_tile)``.

    out_dtype: y's dtype (float32 by default; under ``hillis`` y is float32
    whatever it asks, as the TPU kernel stores it); the last state is
    float32.

    valid_len: positions >= valid_len are padding: dt = 0 there (decay 1,
    inject 0), so the state passes through them unchanged in either
    direction. Requires ``delta_softplus``.
    """
    if valid_len is not None and not delta_softplus:
        raise ValueError("valid_len requires delta_softplus semantics")
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown selective-scan impl {impl!r}")
    args = (u, delta, A, B, C, D, delta_bias, delta_softplus)
    auto = impl == "auto"
    hillis = auto and u.is_cuda and _kernel_impl() == "hillis"
    compute = _compute_mode(u) if auto else "float32"
    if auto and not (torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (u, delta, A, B, C, D, delta_bias))):
        op = (scan_op.selective_scan_hillis_fwd if hillis
              else scan_op.selective_scan_fwd)
        out = op(*args, return_last_state, reverse_dirs, u_tile, out_dtype,
                 valid_len, compute)
        return tuple(out) if return_last_state else out[0]
    if hillis:
        return _hillis_scan(*args, return_last_state, reverse_dirs, u_tile,
                            valid_len, scan_hillis.selective_scan_hillis_fwd,
                            scan_hillis.selective_scan_hillis_bwd, compute)
    if auto and u.is_cuda:
        kw = dict(delta_softplus=delta_softplus, reverse_dirs=reverse_dirs,
                  u_tile=u_tile, out_dtype=out_dtype, valid_len=valid_len,
                  compute=compute)
        return _KernelScan.apply(u, delta, A, B, C, D, delta_bias,
                                 return_last_state, kw)
    return _plain_scan(*args, return_last_state, reverse_dirs, u_tile,
                       out_dtype, valid_len)


def _plain_scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
                return_last_state, reverse_dirs, u_tile, out_dtype,
                valid_len, compute="float32"):
    """The plain version with the call-site contract of
    :func:`selective_scan`: the tiled u materialized, the padding made
    identity steps, reverse groups flipped around :func:`selective_scan_ref`
    (in the compute mode ``compute``) and y flipped back; autograd
    differentiates it."""
    g = B.shape[1]
    if u_tile > 1:
        u = torch.cat([u] * u_tile, dim=1)
    if valid_len is not None and valid_len < u.shape[-1]:
        # softplus(-1e4 + bias) == 0 exactly in float32
        pos = torch.arange(u.shape[-1], device=u.device)
        delta = torch.where(pos < valid_len, delta,
                            torch.full_like(delta, -1e4))
    flip = reverse_dirs is not None and any(reverse_dirs)
    if flip:
        u, delta, B, C = (_flip_groups(x, g, reverse_dirs)
                          for x in (u, delta, B, C))
    y, last = selective_scan_ref(u, delta, A, B, C, D, delta_bias,
                                 delta_softplus, return_last_state=True,
                                 compute=compute)
    if flip:
        y = _flip_groups(y, g, reverse_dirs)
    y = y.to(out_dtype or torch.float32)
    return (y, last) if return_last_state else y


# the graph ops run the functions above, so they are registered last
from medmamba_tpu_torch.ops import scan_op  # noqa: E402
