"""The graphed train step under tensor parallelism, timed across cards.

On a machine of several cards, from the root of a checkout (one NCCL rank
a card):

    torchrun --standalone --nproc_per_node 4 \\
        -m medmamba_tpu_torch.tools.tp_timing OUT_DIR

The graphed bf16 train step of medmamba_t (augmentation, 224^2, a global
batch of ``chip_smoke.BATCH``, ``chip_smoke.compiled_inputs``' images) on
the data-only mesh (world x 1) and on the TP meshes 2 x 2 and 1 x world
(``partition_params``), each TP graph timed in turns with the data-only
one (data, TP, TP, data; ``chip_smoke.DIST_TIMING_REPS`` replays back to
back a turn), one replay of each profiled (device time by family, the
collectives' among it), its first loss and launches. It takes
``chip_smoke.py``'s inputs, timer and profiler. Each rank writes
``tp_timing_<rank>.json`` into ``OUT_DIR``; rank 0 prints the card's name
and power limit and the results.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from medmamba_tpu_torch.models.registry import create_model
from medmamba_tpu_torch.parallel import mesh
from medmamba_tpu_torch.train import trainer
from medmamba_tpu_torch.utils.device import resolve_device


def graphed(grid, images, labels):
    """The graphed step of a partitioned medmamba_t on ``grid``'s data
    row's slice: (step, a call of it, its first loss and launches)."""
    mesh.set_active_mesh(grid)
    model = create_model("T", cs.NUM_CLASSES, dtype=torch.bfloat16,
                         device="cuda",
                         generator=torch.Generator().manual_seed(cs.SEED))
    mesh.partition_params(model, grid)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    step = trainer.compile_train_step(
        model, opt,
        generator=torch.Generator(device="cuda").manual_seed(cs.SEED + 13))
    index, count = mesh.process_slice(grid)
    part = slice(index * cs.BATCH // count, (index + 1) * cs.BATCH // count)
    im, lb = images[part], labels[part]

    def call(_=None):
        return step(im, lb, augment=True, image_size=cs.IMAGE)
    cs.reset_counts()
    t0 = time.perf_counter()
    first = call().item()
    capture_s = time.perf_counter() - t0
    return step, call, dict(first_loss=first, counts=cs.read_counts(),
                            rows=cs.BATCH // count, capture_s=capture_s,
                            pool_bytes=next(iter(step.graphs.values()))
                            .pool_bytes)


def main(out_dir: str) -> None:
    resolve_device("cuda")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    grids = {f"{world}x1": mesh.make_mesh(device="cuda")}
    for n_model in sorted({2, world} - {1}):
        grids[f"{world // n_model}x{n_model}"] = mesh.make_mesh(
            n_model=n_model, device="cuda")
    _, images, labels = cs.compiled_inputs()
    out = {}
    try:
        data_name = f"{world}x1"
        data_step, data_call, out[data_name] = graphed(grids[data_name],
                                                       images, labels)
        prof = cs.profile_families(data_call, "call", steps=1)
        out[data_name].update(
            collective_ms=prof["family_ms_per_call"].get("collective", 0.0),
            kernel_ms=prof["kernel_ms_per_call"],
            families=prof["family_ms_per_call"])
        for name, grid in grids.items():
            if name == data_name:
                continue
            step, call, out[name] = graphed(grid, images, labels)
            turns = cs.in_turns(data_call, call, cs.DIST_TIMING_REPS)
            prof = cs.profile_families(call, "call", steps=1)
            out[name].update(
                ms=turns["graph_ms"], data_only_ms=turns["eager_ms"],
                in_turns_ms=turns["in_turns_ms"],
                collective_ms=prof["family_ms_per_call"].get("collective",
                                                             0.0),
                kernel_ms=prof["kernel_ms_per_call"],
                families=prof["family_ms_per_call"],
                collective_kernels=sorted({
                    k["name"] for k in prof["top_kernels"]
                    if cs.family(k["name"]) == "collective"}))
            step.free()
        data_step.free()
    finally:
        mesh.destroy_mesh()
    out["device"] = torch.cuda.get_device_name()
    with open(os.path.join(out_dir, f"tp_timing_{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True,
                             capture_output=True, text=True).stdout.strip()
        cs.log(f"nvidia-smi: {smi}")
        cs.log("tp_timing " + json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: torchrun --standalone --nproc_per_node N -m "
                 "medmamba_tpu_torch.tools.tp_timing OUT_DIR")
    main(sys.argv[1])
