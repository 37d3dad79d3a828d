"""P1: the elementwise issue-rate probe on Hopper (counterpart of
``tools/probe_vpu.py``).

Measures el-ops/s for K chained elementwise operations per element of a
(16384, 512) array, float32 and bfloat16, through the hand-written kernel
``csrc/probe_vpu.cu``; tells whether a kernel's time is an issue-rate wall
or an implementation gap. Each call feeds the previous call's output (two
buffers in turn), and the time per call is ``(t(520 calls) - t(20 calls))
/ 500`` between CUDA events, as the TPU probe times its fori_loop. El-ops
are counted as the TPU probe counts them: a multiply-add is 2 in ``chain``
and ``par4``, a multiply 1 in ``mul`` and ``mul8``, an exponential 1 in
``exp``, 15 per iteration in ``mix``. Beside each rate stand the card's
bounds for that mode: the bytes (in and out) at 3.35 TB/s, and the issue
of the instructions the mode needs at 67 TFLOP/s float32 (33.5 T lane
instructions/s; packed bfloat16 does two elements per instruction) and,
for exponentials, 16 per clock per SM on the special-function units at the
SM clock ``nvidia-smi --query-gpu=clocks.max.sm`` reports.

On the card (nothing runs at import):

    python -m medmamba_tpu_torch.tools.probe_vpu [mul,mul8,chain,exp,...]

``probe_vpu_ref`` is the plain PyTorch version; ``probe_vpu`` launches the
kernel on a CUDA tensor and runs the plain version on a CPU tensor.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from medmamba_tpu_torch.ops import cuda_build

SOURCE = "probe_vpu.cu"
MODES = ("chain", "mul", "mul8", "par4", "exp", "mix")
MODE_CODE = {m: i for i, m in enumerate(MODES)}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KS = {"mix": (60, 150)}             # every other mode: (16, 64)
# the TPU probe's constants, passed to the kernel at run time
MUL, ADD, SCALE = 1.000001, 1e-7, 1e-6
ROWS, COLS = 8 * 2048, 512
# kernel against plain version: float32 1e-4 of the output's largest entry
# (fused multiply-adds and expf ulps over at most 150 operations); bfloat16
# 2e-2 (a fused multiply-add rounds once where the plain version rounds
# twice, with the multiplier 1.0 in bfloat16 the two agree)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# float32 also: the share of the chain's effect the kernel carries
# (work_share) within 5e-3 of 1. The whole effect of chain, mul, mul8 and
# par4 is 1.5e-5 to 6.1e-5 of the output, below TOL; a kernel that skips
# one step of 64 carries 1 - 1/64 of it. In bfloat16 the multiplier rounds
# to 1.0, so those chains are the identity there by design.
WORK_TOL = 5e-3
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12         # an FMA counts 2
SFU_PER_CLOCK_PER_SM = 16

LAUNCHES = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.medmamba_probe_vpu
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] \
        + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_int,
                                                       ctypes.c_void_p]
    fn.restype = ctypes.c_int


def ks(mode: str) -> tuple:
    return KS.get(mode, (16, 64))


def dtypes(mode: str) -> tuple:
    return (torch.float32,) if mode == "mix" else (torch.float32,
                                                   torch.bfloat16)


def probe_vpu_ref(x: torch.Tensor, k: int, mode: str,
                  const_dtype=None) -> torch.Tensor:
    """Plain version of P1 on a 2-D array (the last axis is the TPU lane
    axis): the TPU kernel's body, op by op. Its Python constants are
    rounded to x's dtype first, as JAX's weakly typed scalars are, or to
    ``const_dtype`` where given (float32 constants in float64 arithmetic
    for ``work_share``)."""
    def c(v):
        return torch.tensor(v, dtype=const_dtype or x.dtype,
                            device=x.device).to(x.dtype)

    if mode == "chain":
        acc = x
        for _ in range(k):
            acc = acc * c(MUL) + c(ADD)
        return acc
    if mode == "mul":
        acc = x
        for _ in range(k):
            acc = acc * c(MUL)
        return acc
    if mode == "mul8":
        chains = [x + c(float(i)) for i in range(8)]
        for _ in range(k // 8):
            chains = [ch * c(MUL) for ch in chains]
        acc = chains[0]
        for ch in chains[1:]:
            acc = acc + ch
        return acc
    if mode == "par4":
        a, b, cc, d = x, x + c(1.0), x + c(2.0), x + c(3.0)
        for _ in range(k // 4):
            a = a * c(MUL) + c(ADD)
            b = b * c(MUL) + c(ADD)
            cc = cc * c(MUL) + c(ADD)
            d = d * c(MUL) + c(ADD)
        return a + b + cc + d
    if mode == "exp":
        acc = x
        for _ in range(k):
            acc = torch.exp(acc * c(SCALE))
        return acc
    if mode == "mix":
        lane = torch.arange(x.shape[-1], device=x.device).expand(x.shape)
        a, b = x, x * c(1.1) + c(1.0)
        live = [x + c(float(i) * 0.1) for i in range(6)]
        for _ in range(k // 15):
            g = a * b
            g = torch.minimum(torch.maximum(g, c(-80.0)), c(80.0))
            e = torch.exp(g * c(SCALE))
            f = torch.exp(c(-SCALE) * g)
            w = f * live[0]
            gg = w + live[1]
            h = e * (gg + f * live[2])
            sel = torch.where(lane < 64, h, e)
            a = sel * c(MUL) + c(ADD)
            b = b * c(0.999999)
            live = live[1:] + [h * c(1e-3)]
        acc = a + b
        for ch in live:
            acc = acc + ch * c(SCALE)
        return acc
    raise ValueError(f"unknown probe mode {mode!r}")


def probe_vpu_cuda(x: torch.Tensor, k: int, mode: str,
                   iters: int = 1) -> torch.Tensor:
    """The kernel, ``iters`` calls chained (each reads the previous one's
    output) on a copy of ``x``; returns the last output. Raises on
    anything the kernel does not take."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"P1 needs a CUDA tensor, got one on {x.device}")
    if (x.dtype not in DTYPE_CODE or x.ndim != 2 or not x.is_contiguous()
            or (x.dtype == torch.bfloat16 and x.shape[1] % 2)):
        raise ValueError(f"x must be a contiguous 2-D float32 or bfloat16 "
                         f"array (an even row for bfloat16), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if mode not in MODE_CODE or k not in ks(mode) \
            or x.dtype not in dtypes(mode):
        raise ValueError(f"no kernel for mode {mode!r}, k {k}, {x.dtype}")
    bufs = [x.clone() if iters > 1 else x, torch.empty_like(x)]
    lib = cuda_build.load(SOURCE, _declare)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.medmamba_probe_vpu(
            bufs[0].data_ptr(), bufs[1].data_ptr(), x.shape[0], x.shape[1],
            MODE_CODE[mode], DTYPE_CODE[x.dtype], k, MUL, ADD, SCALE, iters,
            stream)
    cuda_build.check_launch(lib, rc, "probe_vpu")
    LAUNCHES += iters
    return bufs[iters % 2]


def probe_vpu(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """P1 once: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.is_cuda:
        return probe_vpu_cuda(x, k, mode)
    return probe_vpu_ref(x, k, mode)


def el_ops(mode: str, k: int, n: int) -> int:
    """El-ops of one call on n elements, counted as the TPU probe counts
    them (tools/probe_vpu.py:110-114)."""
    if mode == "mix":
        return n * (k // 15) * 15
    return n * k * (2 if mode in ("chain", "par4") else 1)


def instructions(mode: str, k: int) -> tuple:
    """(arithmetic, special-function) instructions per element that the
    mode needs at least: multiply-adds fused, one exponential on the
    special-function units each. mul8 and par4 count their set-up and
    final sums; mix counts 14 arithmetic operations and 2 exponentials an
    iteration, and 14 around the loop."""
    if mode == "chain" or mode == "mul":
        return k, 0
    if mode == "mul8":
        return k + 15, 0
    if mode == "par4":
        return k + 6, 0
    if mode == "exp":
        return k, k
    return 14 * (k // 15) + 14, 2 * (k // 15)


def bounds(mode: str, k: int, dtype, rows: int, cols: int,
           sm_count: int, sm_clock_hz: float) -> dict:
    """Least times in ms of one call on the card: the bytes in and out at
    3.35 TB/s, the arithmetic at 67 TFLOP/s (packed bfloat16 two elements
    an instruction) and the exponentials on the special-function units."""
    n = rows * cols
    nbytes = 2 * n * torch.tensor([], dtype=dtype).element_size()
    alu, sfu = instructions(mode, k)
    lanes = 2 if dtype == torch.bfloat16 and mode != "exp" else 1
    out = dict(bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
               alu_ms=alu * n / lanes / (PEAK_FP32_OPS_PER_S / 2) * 1e3,
               sfu_ms=sfu * n / (SFU_PER_CLOCK_PER_SM * sm_count
                                 * sm_clock_hz) * 1e3)
    out["issue_ms"] = max(out["alu_ms"], out["sfu_ms"])
    out["bound_ms"] = max(out["bytes_ms"], out["issue_ms"])
    out["bound_by"] = ("bytes" if out["bytes_ms"] >= out["issue_ms"]
                       else "operations")
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    return float(out.splitlines()[0]) * 1e6


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    scale = want.float().abs().max().clamp_min(1e-30)
    return ((got.float() - want.float()).abs().max() / scale).item()


def work_share(got: torch.Tensor, x: torch.Tensor, k: int, mode: str
               ) -> float:
    """The share of the chain's effect that ``got`` carries: the factor
    beta that fits got - base = beta (want - base) in least squares. want
    is the k steps evaluated in float64 on ``x`` with the constants
    rounded to float32 as the kernel takes them, base the same with no
    step (k = 0: the mode's set-up and final sums only). A float32
    kernel that skips s of its k steps gives about 1 - s/k (1 - 8s/k in
    mul8, 1 - 4s/k in par4); float32 rounding, fused or not, keeps one that
    does them all within 1.2e-3 of 1 on a standard normal input (a
    float64 simulation of both roundings at the probe's size). The exp
    chain forgets its input after two steps (every float32 x ends at
    1.000001), so there beta is 1 whatever was skipped; the rate gate of
    ``chip_smoke.py`` stands in, exp being bound by its exponentials."""
    x64 = x.double()
    base = probe_vpu_ref(x64, 0, mode, torch.float32).flatten()
    e = probe_vpu_ref(x64, k, mode, torch.float32).flatten() - base
    g = got.double().flatten() - base
    return (g @ e / (e @ e)).item()


def _events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run(modes=MODES) -> list:
    """Every (mode, dtype, k) of ``modes`` on the card at ROWS x COLS (a
    standard normal array from seed 0): the kernel against its plain
    version (raises beyond TOL) and, in float32, the share of the chain's
    effect it carries (raises beyond WORK_TOL); its time per call, rate
    and bounds. Returns one dict per case."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randn(ROWS, COLS, generator=gen, device="cuda")
    props = torch.cuda.get_device_properties(0)
    clock = sm_clock_hz()
    cases = []
    for mode in modes:
        for dtype in dtypes(mode):
            x = base.to(dtype)
            for k in ks(mode):
                got = probe_vpu_cuda(x, k, mode)
                want = probe_vpu_ref(x, k, mode)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                abs_err = (got.float() - want.float()).abs().max().item()
                if not err <= TOL[dtype]:
                    raise RuntimeError(
                        f"P1 {mode} {dtype} k={k}: {err:.3e} of the largest "
                        f"entry from the plain version (limit {TOL[dtype]})")
                share = (work_share(got, x, k, mode)
                         if dtype == torch.float32 else None)
                if share is not None and not abs(share - 1) <= WORK_TOL:
                    raise RuntimeError(
                        f"P1 {mode} {dtype} k={k} carries {share:.6f} of the "
                        f"chain's effect (limit 1 +- {WORK_TOL})")
                probe_vpu_cuda(x, k, mode, 2)
                torch.cuda.synchronize()
                t20 = _events_ms(lambda: probe_vpu_cuda(x, k, mode, 20))
                t520 = _events_ms(lambda: probe_vpu_cuda(x, k, mode, 520))
                ms = (t520 - t20) / 500
                plain_ms = _events_ms(lambda: probe_vpu_ref(x, k, mode))
                b = bounds(mode, k, dtype, ROWS, COLS,
                           props.multi_processor_count, clock)
                ops = el_ops(mode, k, ROWS * COLS)
                cases.append(dict(
                    mode=mode, dtype=str(dtype).replace("torch.", ""), k=k,
                    ms=ms, plain_ms=plain_ms, tera_el_ops_s=ops / ms / 1e9,
                    issue_tera_el_ops_s=ops / b["issue_ms"] / 1e9,
                    bytes_tera_el_ops_s=ops / b["bytes_ms"] / 1e9,
                    max_rel_err=err, max_abs_err=abs_err, work_share=share,
                    **b))
    return cases


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    modes = argv[0].split(",") if argv else ("mul", "mul8", "chain", "exp")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for r in run(modes):
        print(f"{r['mode']:6s} {r['dtype']:9s} k={r['k']:3d}: "
              f"{r['ms']:7.4f} ms/call  {r['tera_el_ops_s']:6.2f} T el-ops/s"
              f"  (issue bound {r['issue_tera_el_ops_s']:6.2f}, bytes bound "
              f"{r['bytes_tera_el_ops_s']:6.2f}; bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']}; plain {r['plain_ms']:.3f} ms)")


if __name__ == "__main__":
    main()
