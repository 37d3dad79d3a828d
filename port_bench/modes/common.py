"""What the traffic modes share: the card, the seeds, the program's model
with the benchmark's weights, the pool of batches, and the timed and the
traced window."""
from __future__ import annotations

import contextlib
import random
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from port_bench.core import trace as tracing
from port_bench.reference import vssm as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mark(t0: float, what: str) -> None:
    """A set-up milestone on standard error: seconds since the process
    started."""
    print(f"set-up: {what} at {time.time() - t0:.3f} s", file=sys.stderr,
          flush=True)


def card() -> torch.device:
    """The card, with the program's precision fixed as its entry points
    fix it (float32 without TF32)."""
    from medmamba_tpu_torch.utils.device import resolve_device
    device = resolve_device("cuda")
    print(f"card: {torch.cuda.get_device_name(device)}, "
          f"{torch.cuda.device_count()} present", file=sys.stderr,
          flush=True)
    return device


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds for the weights, the data and the draws,
    from any whole-number seed."""
    mask = (1 << 63) - 1
    return {name: (seed * 6364136223846793005 + 1442695040888963407 * k)
            & mask for k, name in enumerate(("weights", "data", "draws"),
                                            start=1)}


def port_model(cfg: dict, block_dtype: str, weights: Dict[str, torch.Tensor],
               device: torch.device) -> torch.nn.Module:
    """The program's VSSM at ``cfg``'s sizes, built without drawing its own
    initialisation, holding the benchmark's weights and fresh BatchNorm
    statistics."""
    from medmamba_tpu_torch.models.vssm import VSSM
    with torch.device("meta"):
        model = VSSM(num_classes=cfg["num_classes"], depths=cfg["depths"],
                     dims=cfg["dims"], d_state=cfg["d_state"],
                     patch_size=cfg["patch_size"],
                     drop_path_rate=cfg["drop_path_rate"],
                     dtype=DTYPES[block_dtype])
    model = model.to_empty(device=device)
    model.load_state_dict({**weights,
                           **ref.batch_norm_buffers(cfg, device)},
                          strict=True)
    return model


def pool(cfg: dict, traffic: dict, seed: int, device: torch.device
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``traffic["pool"]`` distinct batches of uint8 NHWC images at the
    model's size and their labels, drawn on the card from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, b, s = traffic["pool"], traffic["batch"], cfg["image_size"]
    images = torch.randint(0, 256, (n, b, s, s, 3), dtype=torch.uint8,
                           generator=gen, device=device)
    labels = torch.randint(0, cfg["num_classes"], (n, b), generator=gen,
                           device=device)
    return images, labels


def compared_batches(traffic: dict, seeds: Dict[str, int]) -> list:
    """The pool batches whose answers an eval run compares, drawn from the
    seed."""
    return random.Random(seeds["draws"]).sample(range(traffic["pool"]),
                                                traffic["check_batches"])


def timed(one: Callable[[], None], seconds: float,
          device: torch.device) -> Tuple[int, float]:
    """Calls of ``one`` until ``seconds`` have passed on the host clock,
    then a synchronisation: (calls, seconds from the start to the end of
    the synchronisation)."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        one()
        n += 1
    torch.cuda.synchronize(device)
    return n, time.perf_counter() - t0


def traced(one: Callable[[], None], calls: int, device: torch.device
           ) -> Tuple[tracing.Trace, int]:
    """``calls`` calls of ``one`` under ``torch.profiler``, in the window's
    range, each in a step range, ended by a synchronisation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.WINDOW_RANGE):
            for _ in range(calls):
                with record_function(tracing.STEP_RANGE):
                    one()
            torch.cuda.synchronize(device)
    return tracing.Trace.from_profiler(prof, calls), calls


def device_record(device: torch.device, chips: int,
                  tr: Optional[tracing.Trace]) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    if tr is not None:
        out["busy_s"] = tr.busy_s()
        out["window_s"] = tr.window_s
    return out


@contextlib.contextmanager
def tf32(on: bool):
    """Float32 matrix products and convolutions in TF32 or, as the
    reference states, in full float32, whatever the flags were; restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
