"""Training CLI of the PyTorch port.

Counterpart of ``medmamba_tpu/cli/train.py``, with its flag surface (plus
``--device``): NPZ-vs-folder detection and the mode's defaults, augmentation,
the per-epoch validation, early stopping, the best/last checkpoint lifecycle
and ``class_indices.json``. Checkpoints are ``.pth`` files in the reference
schema (``train/checkpoint.py``), which ``cli.evaluate`` reads. Runs on the
card (``--device cuda``, the default; raises without one), where the train
step and the eval step are CUDA graphs (``train/trainer.py:
compile_train_step``, ``compile_eval_step``), or, when asked, eagerly on
the CPU.

Under ``torchrun`` every process runs this CLI as one rank of a
data-parallel group (``parallel/mesh.py``; NCCL on the card, one card a
rank; gloo on the CPU): each builds the same seeded global shuffle and
steps on its slice of every global batch (``--batch_size`` stays the
global batch), the steps compute what one process computes on the whole
batch (``train/trainer.py``), rank 0 alone writes the ``.pth`` files and
``class_indices.json``, every rank loads ``--resume``. Without torchrun no
group is made and nothing changes.

Usage:
    python -m medmamba_tpu_torch.cli.train --train_dir D --val_dir D [options]
    torchrun --nproc_per_node N -m medmamba_tpu_torch.cli.train ... (one
        rank a card)
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import time
from collections import deque

log = logging.getLogger("medmamba_tpu_torch.train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a Medmamba model "
                                            "(PyTorch port).")
    p.add_argument("--medmb_size", type=str, default="T",
                   choices=["T", "S", "B", "Te"])
    p.add_argument("--train_dir", type=str, required=True)
    p.add_argument("--val_dir", type=str, required=True)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--model_name", type=str, default="Medmamba")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="a training .pth written by this CLI")
    p.add_argument("--patience", type=int, default=25)
    p.add_argument("--save_dir", type=str, default=".")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--augmentation", action="store_true", default=False)
    p.add_argument("--use_early_stopping", action="store_true", default=False)
    p.add_argument("--attn_drop_rate", type=float, default=0.0)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--load_size", type=int, default=None,
                   help="folder-mode decode resolution (default: "
                        "image_size); flip and rotation run at this size")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="block dtype; parameters and the scan core stay "
                        "float32")
    p.add_argument("--scan_impl", type=str, default="auto",
                   choices=["auto", "ref"],
                   help="auto: the CUDA kernels on the card, the plain scan "
                        "on the CPU; ref: the plain scan everywhere")
    p.add_argument("--scan_tau", type=str, default="auto",
                   choices=["auto", "16", "32", "64", "128"],
                   help="Accepted for the JAX CLI's flag surface; does "
                        "nothing here (both scans are exact).")
    p.add_argument("--tau_gate", type=str, default="outcome",
                   choices=["outcome", "exact"],
                   help="Accepted for the JAX CLI's flag surface; does "
                        "nothing here.")
    p.add_argument("--fast_decode", action="store_true", default=False,
                   help="DCT-scaled JPEG decode in the native loader "
                        "(folder mode)")
    p.add_argument("--exact_rotate", action="store_true", default=False,
                   help="Accepted for the JAX CLI's flag surface; does "
                        "nothing here (the rotation kernel is exact).")
    p.add_argument("--use_checkpoint", action="store_true", default=False,
                   help="recompute each block's activations in the backward")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 3-5 of the "
                        "first epoch here")
    p.add_argument("--log_every", type=int, default=1,
                   help="per-step progress line frequency (0 disables)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _step_profiler(out_dir: str, device):
    """``torch.profiler`` over steps 3-5 of an epoch (steps 1-2 warm up);
    the trace goes to ``out_dir/trace.json``. Call ``step()`` per step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def save(prof):
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        log.info("profiler trace written to %s", out_dir)
    return profile(activities=acts, on_trace_ready=save,
                   schedule=schedule(wait=1, warmup=1, active=3, repeat=1))


def main(argv=None):
    """Train. Returns a dict: ``best_path`` (None when no epoch improved
    on the starting accuracy), ``last_path`` (None when there was nothing to
    do), ``best_acc``, the last epoch's ``train_loss`` and ``img_s``, and
    ``step_losses``, every step's (global batch's) loss in order."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    import torch.distributed as dist

    from medmamba_tpu_torch.parallel.mesh import (destroy_mesh, make_mesh,
                                                  rank_device)
    from medmamba_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    owned = not dist.is_initialized()
    mesh = make_mesh(device=device)
    try:
        return _train(args, rank_device(mesh) if mesh is not None
                      else device, mesh)
    finally:
        if owned:
            destroy_mesh()


def _train(args, device, mesh):
    import torch
    import torch.distributed as dist

    from medmamba_tpu_torch.data.datasets import is_npz_dir, open_dataset
    from medmamba_tpu_torch.data.loader import BatchLoader, device_prefetch
    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.parallel.mesh import (data_group, process_slice,
                                                  replicate_state,
                                                  shard_batch)
    from medmamba_tpu_torch.train import checkpoint as ckpt
    from medmamba_tpu_torch.train.trainer import (compile_eval_step,
                                                  compile_train_step,
                                                  eval_step,
                                                  make_optimizer, train_step)

    pi, pc = process_slice(mesh)
    group = data_group(mesh)
    main_rank = pi == 0

    def written():
        """Rank 0 has written its files: the others may go on."""
        if group is not None:
            dist.barrier(group=group)

    if group is not None:
        log.info("Rank %d of %d (%s) on %s.", pi, pc,
                 dist.get_backend(group), device)
    os.makedirs(args.save_dir, exist_ok=True)
    if args.fast_decode:
        os.environ["MEDMAMBA_FAST_DECODE"] = "1"

    npz_mode = is_npz_dir(args.train_dir, "train")
    if npz_mode:
        log.info("Detected MedMNIST (NPZ) dataset.")
        epochs = args.epochs or 100
        batch_size = args.batch_size or 100
        lr = args.lr or 1e-3
        lr_decay_epochs = [50, 75]
    else:
        log.info("Detected non-MedMNIST dataset (ImageFolder).")
        epochs = args.epochs or 150
        batch_size = args.batch_size or 64
        lr = args.lr or 1e-4
        lr_decay_epochs = []

    load_size = args.load_size or args.image_size
    train_ds, _ = open_dataset(args.train_dir, "train", load_size=load_size)
    val_ds, _ = open_dataset(args.val_dir, "val", load_size=load_size)
    num_classes = train_ds.get_num_classes()
    class_indices = train_ds.get_class_to_idx()
    if not npz_mode:
        class_indices = {v: k for k, v in class_indices.items()}
    if args.num_classes is not None:
        if npz_mode and args.num_classes != num_classes:
            log.warning("--num_classes (%d) overrides inferred classes (%d).",
                        args.num_classes, num_classes)
        num_classes = args.num_classes
    if main_rank:
        ckpt.save_class_indices(args.save_dir, class_indices)
    written()

    train_loader = BatchLoader(train_ds, batch_size, shuffle=True,
                               seed=args.seed, process_index=pi,
                               process_count=pc)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False,
                             seed=args.seed, process_index=pi,
                             process_count=pc)
    steps_per_epoch = len(train_loader)
    log.info("Using %d train / %d val images, %d classes on %s. Epochs %d, "
             "batch %d, lr %g", len(train_ds), len(val_ds), num_classes,
             device, epochs, batch_size, lr)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = create_model(args.medmb_size, num_classes,
                         attn_drop_rate=args.attn_drop_rate, dtype=dtype,
                         scan_impl=args.scan_impl,
                         use_checkpoint=args.use_checkpoint,
                         generator=torch.Generator().manual_seed(args.seed),
                         device=device)
    log.info('Model size: "%s", blocks in %s', args.medmb_size, args.dtype)
    opt, sched = make_optimizer(model.parameters(), lr, npz_mode,
                                lr_decay_epochs)

    start_epoch, best_acc, best_path = 1, 0.0, None
    if args.resume:
        if os.path.isfile(args.resume):
            meta = ckpt.restore_checkpoint(args.resume, model, opt)
            start_epoch = int(meta.get("epoch", 0)) + 1
            best_acc = float(meta.get("best_acc", 0.0))
            if sched is not None:
                sched.last_epoch = start_epoch - 1
            log.info("Resumed from %s at epoch %d (best_acc %.3f)",
                     args.resume, start_epoch, best_acc)
        else:
            log.error("Checkpoint not found: %s. Starting from scratch.",
                      args.resume)
    replicate_state(model, opt, mesh)

    if epochs < start_epoch:
        log.warning("Target epochs (%d) < start epoch (%d); nothing to do.",
                    epochs, start_epoch)
        print(f"Finished Training (Target Epoch <= Start Epoch). "
              f"Best validation accuracy recorded: {best_acc:.3f}")
        return dict(best_path=None, last_path=None, best_acc=best_acc,
                    train_loss=None, img_s=None, step_losses=[])

    # one generator for every training draw (flips, angles, DropPath), on
    # the device that draws them, seeded anew from --seed and the epoch so
    # that a resumed run draws what the uninterrupted run would have
    generator = torch.Generator(device=device)
    static = dict(image_size=args.image_size)
    if device.type == "cuda":
        # one CUDA graph each for the train and the eval step, captured at
        # their first call (after the resume above: the graphs hold the
        # tensors the model and the optimizer have then)
        compiled_train = compile_train_step(model, opt, generator=generator)
        compiled_eval = compile_eval_step(model)

        def run_train(images, labels):
            return compiled_train(images, labels, augment=args.augmentation,
                                  **static)

        def run_eval(images, labels):
            return compiled_eval(images, labels, **static)
    else:
        def run_train(images, labels):
            return train_step(model, opt, images, labels,
                              generator=generator, augment=args.augmentation,
                              **static)

        def run_eval(images, labels):
            return eval_step(model, images, labels, **static)

    def on_device(loader_epoch):
        """The loader's batches on this rank's device, copied ahead."""
        return device_prefetch(
            loader_epoch,
            lambda im, lb: shard_batch(mesh, im, lb, device=device),
            device=device)
    epochs_without_improvement = 0
    final_epoch = start_epoch - 1
    avg_loss = ips = None
    step_losses = []
    for epoch in range(start_epoch, epochs + 1):
        final_epoch = epoch
        generator.manual_seed((args.seed + 1) * 1_000_003 + epoch)
        t0 = time.time()
        running_loss, nsteps = 0.0, 0
        pending = deque()  # device losses, read two steps late so the host
        # stays ahead of the card
        profiling = (bool(args.profile_dir) and epoch == start_epoch
                     and main_rank)
        prof = (_step_profiler(args.profile_dir, device) if profiling
                else contextlib.nullcontext())
        with prof:
            for images, labels in on_device(train_loader.epoch(epoch)):
                loss = run_train(images, labels)
                # a graph's loss is overwritten by its next replay
                pending.append(loss.clone())
                nsteps += 1
                if profiling:
                    prof.step()
                if len(pending) > 2:
                    lval = float(pending.popleft())
                    running_loss += lval
                    step_losses.append(lval)
                    if (args.log_every and nsteps % args.log_every == 0
                            and main_rank):
                        print(f"\rtrain epoch[{epoch}/{epochs}] "
                              f"step {nsteps}/{steps_per_epoch} "
                              f"loss:{lval:.3f}", end="", flush=True)
        while pending:
            lval = float(pending.popleft())
            running_loss += lval
            step_losses.append(lval)
        if args.log_every and main_rank:
            print()
        if sched is not None:
            sched.step()
        train_time = time.time() - t0

        correct = torch.zeros((), dtype=torch.long, device=device)
        for images, labels in on_device(val_loader.epoch(0)):
            c, _ = run_eval(images, labels)
            correct += c
        val_acc = int(correct) / len(val_ds)
        avg_loss = running_loss / max(nsteps, 1)
        ips = nsteps * batch_size / train_time if train_time > 0 else 0.0
        msg = (f"[Epoch {epoch}/{epochs}] Train Loss: {avg_loss:.3f} | "
               f"Val Accuracy: {val_acc:.3f} | {ips:.1f} img/s")
        log.info(msg)
        if main_rank:
            print(msg)

        if val_acc > best_acc:
            best_acc = val_acc
            epochs_without_improvement = 0
            new_best = os.path.join(
                args.save_dir, f"{args.model_name}_epoch_{epoch}_best.pth")
            if main_rank:
                ckpt.save_checkpoint(new_best, model, opt, epoch=epoch,
                                     best_acc=best_acc,
                                     num_classes=num_classes,
                                     class_indices=class_indices)
                log.info("New best checkpoint saved to %s (acc %.3f)",
                         new_best, best_acc)
                if best_path != new_best:
                    # the old best goes only now that the new one is in
                    # place
                    ckpt.delete_checkpoint(best_path)
            written()
            best_path = new_best
        else:
            epochs_without_improvement += 1
            log.info("No improvement. Patience %d/%d",
                     epochs_without_improvement, args.patience)

        if (args.use_early_stopping
                and epochs_without_improvement >= args.patience):
            log.info("Early stopping triggered after %d epochs without "
                     "improvement at epoch %d/%d.", args.patience, epoch,
                     epochs)
            break

    last_path = os.path.join(args.save_dir,
                             f"{args.model_name}_epoch_{final_epoch}_last.pth")
    if main_rank:
        ckpt.save_checkpoint(last_path, model, opt, epoch=final_epoch,
                             best_acc=best_acc, num_classes=num_classes,
                             class_indices=class_indices)
        log.info("Saved last checkpoint to %s", last_path)
        print(f"Finished Training. Final Epoch Reached: {final_epoch}. "
              f"Best validation accuracy: {best_acc:.3f}")
    written()
    return dict(best_path=best_path, last_path=last_path, best_acc=best_acc,
                train_loss=avg_loss, img_s=ips, step_losses=step_losses)


if __name__ == "__main__":
    main()
