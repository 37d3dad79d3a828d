"""SS2D's low-rank projections timed on the card, GEMM by GEMM.

From the root of a checkout on a CUDA machine:

    python -m medmamba_tpu_torch.tools.proj_timing [OUT.json]

At each stage shape of medmamba_t and medmamba_b (batch 64, 224^2: L =
3136, 784, 196, 49), in bfloat16, and in float32 with TF32 off for the
forward alone, it times each GEMM of ``models/vssm.py:
ss2d_projections`` (forward, data gradient and weight gradient of the
x_proj GEMM and of the dt GEMM) and the whole projection (forward, and
forward with backward), beside the einsum formulation the port ran before
(``einsum``: the two einsums over a (k, B*L, D) transposed copy of the
input) and that formulation with the dt rank padded to a multiple of 8
(``einsum_r8``). Device time per call comes from
``utils/profiling.py: device_ms_per_call``, one profiler session for all;
for each function the kernels the card ran and their share are listed
from a second session. It prints the card's name and power limit and one
line a function, and writes everything to OUT.json when given.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from medmamba_tpu_torch.models.vssm import _bmm_float32, ss2d_projections
from medmamba_tpu_torch.utils.profiling import device_ms_per_call

BATCH = 64
N_STATE = 16
# (model, stage, d_inner, L): d_model = d_inner / 2, dt rank ceil(d_model/16)
STAGES = [("T", i, 96 << i, 3136 >> 2 * i) for i in range(4)] + \
         [("B", i, 128 << i, 3136 >> 2 * i) for i in range(4)]
REPS = 20


def einsum_projections(u, wx, wdt, n, pad_to8=False):
    """The formulation the port ran before ``ss2d_projections``: one einsum
    for x_proj over (batch, pair, direction), one for the dt projection,
    and B, C copied per pair. ``pad_to8`` zero-pads the dt rank first."""
    b, _, l = u.shape
    d, r = wx.shape[-1], wdt.shape[-1]
    if pad_to8 and r % 8:
        r8 = -(-r // 8) * 8
        w_dt, w_bc = wx.split([r, 2 * n], dim=1)
        wx = torch.cat([F.pad(w_dt, (0, 0, 0, r8 - r)), w_bc], 1)
        wdt, r = F.pad(wdt, (0, r8 - r)), r8
    xs = u.reshape(b, 2, d, l)
    x_dbl = torch.einsum("bkdl,jkcd->bjkcl", xs, wx.reshape(2, 2, r + 2 * n, d))
    dts, bs, cs = torch.split(x_dbl, [r, n, n], dim=3)
    dts = torch.einsum("bjkrl,jkdr->bjkdl", dts, wdt.reshape(2, 2, d, r))
    return [(dts[:, j].reshape(b, 2 * d, l), bs[:, j].contiguous(),
             cs[:, j].contiguous()) for j in range(2)]


def stage_calls(d, l, dtype, gen):
    """{name: fn} of one stage shape: each fn takes one ignored argument,
    as ``device_ms_per_call`` passes it."""
    r = -(-(d // 2) // 16)
    r8 = -(-r // 8) * 8
    n = N_STATE

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    u = randn(BATCH, 2 * d, l)
    wx = randn(4, r + 2 * n, d) * d ** -0.5
    wdt = randn(4, d, r) * r ** -0.5
    calls = {}
    for name, fn in (("new", ss2d_projections),
                     ("einsum", einsum_projections),
                     ("einsum_r8", lambda *a: einsum_projections(
                         *a, pad_to8=True))):
        def fwd(_, fn=fn):
            with torch.no_grad():
                fn(u, wx, wdt, n)
        calls[f"{name}.fwd"] = fwd
        if dtype == torch.float32:
            continue
        leaves = [t.clone().requires_grad_() for t in (u, wx, wdt)]
        outs = [t for p in fn(*leaves, n) for t in p]
        cot = [randn(*t.shape) for t in outs]

        def fwd_bwd(_, fn=fn, leaves=leaves, cot=cot):
            outs = [t for p in fn(*leaves, n) for t in p]
            torch.autograd.backward(outs, cot)
        calls[f"{name}.fwd_bwd"] = fwd_bwd
    if dtype == torch.float32:
        return calls
    # the new GEMMs one by one, on operands of their shapes and layouts
    m = 4 * (r8 + 2 * n)
    w_x = randn(m, 2 * d)
    g_x = randn(BATCH, m, l)
    dts = randn(BATCH, m, l)[:, :2 * r8]          # a view, as in the model
    w_dt = randn(2 * d, 2 * r8)
    g_dt = randn(BATCH, 2 * d, l)
    ut = u.transpose(1, 2)
    calls.update({
        "x.fwd": lambda _: torch.bmm(w_x.expand(BATCH, -1, -1), u),
        "x.dgrad": lambda _: torch.bmm(w_x.t().expand(BATCH, -1, -1), g_x),
        "x.wgrad": lambda _: _bmm_float32(g_x, ut).sum(0),
        "x.wgrad_bf16": lambda _: torch.bmm(g_x, ut).sum(0),
        "dt.fwd": lambda _: torch.bmm(w_dt.expand(BATCH, -1, -1), dts),
        "dt.dgrad": lambda _: torch.bmm(w_dt.t().expand(BATCH, -1, -1), g_dt),
        "dt.wgrad": lambda _: _bmm_float32(g_dt, dts.transpose(1, 2)).sum(0),
    })
    return calls


def kernels_by_call(calls):
    """{name: [(kernel, ms a call)]} from one profiler session. A kernel
    belongs to the call whose range holds the start of the operator that
    launched it (the profiler's correlation of the two, and the host's
    clock alone: the card's clock drifts from it over a long session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    names = list(calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k, name in enumerate(names):
            with record_function(f"proj_timing.{k}"):
                for _ in range(REPS):
                    calls[name](None)
                torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end,
                    int(e.name.split(".")[1]))
                   for e in events if e.name.startswith("proj_timing."))
    out = {name: {} for name in names}
    for e in events:
        if not e.kernels or e.name.startswith("proj_timing."):
            continue
        t = e.time_range.start
        k = next((k for lo, hi, k in spans if lo <= t < hi), None)
        if k is not None:
            got = out[names[k]]
            for kernel in e.kernels:
                got[kernel.name] = got.get(kernel.name, 0.0) + \
                    kernel.duration / 1e3 / REPS
    return {n: sorted(v.items(), key=lambda kv: -kv[1])
            for n, v in out.items()}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = {}
    for model, stage, d, l in STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and model == "B":
                continue
            tag = f"{model}{stage}.{str(dtype)[6:]}"
            for name, fn in stage_calls(d, l, dtype, gen).items():
                calls[f"{tag}.{name}"] = fn
    for fn in calls.values():               # warm-up: cuBLAS handles, plans
        fn(None)
    torch.cuda.synchronize()
    # one session for every function (a process's tracer can stop
    # recording after many sessions)
    names = list(calls)
    ms = dict(zip(names, device_ms_per_call([(calls[k], [None])
                                             for k in names])))
    kernels = kernels_by_call(calls)
    for name in names:
        top = "; ".join(f"{k[:110]} {v:.4f}" for k, v in kernels[name][:4])
        print(f"{name}: {ms[name]:.4f} ms | {top}", flush=True)
    result = {"card": card, "torch": torch.__version__, "stages": STAGES,
              "ms": ms, "kernels": {k: v[:8] for k, v in kernels.items()}}
    if argv:
        with open(argv[0], "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
