"""Rank processes for the port's data- and sequence-parallel tests.

:func:`spawn` starts ``world`` processes (the ``spawn`` start method), each
joining one gloo group through a ``file://`` rendezvous in the test's
temporary directory (no port to collide on between test workers); each
calls ``fn(rank, world, *args)`` under the port's active mesh and saves
what it returns, which :func:`spawn` hands back in rank order. The ranks
import torch and the port only, never JAX.
"""
import os

import torch

from medmamba_tpu_torch.models.vssm import VSSM
from medmamba_tpu_torch.parallel import mesh
from medmamba_tpu_torch.train import trainer

JOIN_S = 120


def _entry(fn, rank, world, root, device, backend, args):
    torch.set_num_threads(1)
    # a process's first torch.exp can come back up to 1.1e-4 off on the
    # CPU (ROADMAP.md §C, C1); settle it before anything is compared
    torch.exp(torch.linspace(-1.0, 0.0, 64))
    mesh.make_mesh(device=device, rank=rank, world_size=world,
                   init_method=f"file://{os.path.join(root, 'rendezvous')}",
                   backend=backend)
    try:
        result = fn(rank, world, *args)
    finally:
        mesh.destroy_mesh()
    torch.save(result, os.path.join(root, f"rank{rank}.pt"))


def spawn(fn, world: int, root, *args, device: str = "cpu",
          backend: str = "gloo") -> list:
    """``fn(rank, world, *args)`` in ``world`` ranks of a ``backend`` group
    on ``device``: "cpu" or "cuda:0" (every rank on that one), or "cuda"
    (rank i on card i, as NCCL needs)."""
    import multiprocessing as mp

    root = str(root)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, root, device, backend, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} rank(s) still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * world, \
        [p.exitcode for p in procs]
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]


def local(x: torch.Tensor, rank: int, world: int, dim: int = 0):
    """This rank's contiguous slice of ``x`` along ``dim``."""
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


def train_step(rank, world, model_kw, weights, images, labels, augment,
               seed, image_size):
    """One ``trainer.train_step`` on this rank's slice: the loss, the
    gradients AdamW was given, and the state after the step."""
    model = VSSM(**model_kw)
    model.load_state_dict(weights)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in model.named_parameters()}))
    im, lb = mesh.shard_batch(mesh.active_mesh(), local(images, rank, world),
                              local(labels, rank, world))
    loss = trainer.train_step(model, opt, im, lb,
                              generator=torch.Generator().manual_seed(seed),
                              augment=augment, image_size=image_size)
    return dict(loss=loss, grads=grads, state=model.state_dict())


def unused_parameter_step(rank, world, model_kw, weights, images, labels):
    """One ``trainer.train_step`` of a model holding a parameter that no
    loss reaches: that parameter after the step, whether it has a
    gradient, and whether AdamW made state for it."""
    model = VSSM(**model_kw)
    model.load_state_dict(weights)
    model.unused = torch.nn.Parameter(torch.ones(3))
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    trainer.train_step(model, opt, local(images, rank, world),
                       local(labels, rank, world),
                       generator=torch.Generator().manual_seed(0),
                       image_size=images.shape[1])
    return dict(unused=model.unused.detach().clone(),
                has_grad=model.unused.grad is not None,
                has_state=model.unused in opt.state)


def graphed_steps(rank, world, model_kw, weights, images, labels, steps,
                  image_size):
    """On this rank's card: ``steps`` train steps on its slice with
    augmentation, eagerly and then as a CUDA graph captured with the
    group's NCCL collectives (the loss's valid count, BatchNorm's sums and
    their adjoints, the flat gradient sum), from the same weights and
    generator seed; then the eval step's summed count, eager and graphed.
    Returns each run's losses, state and count, on the CPU."""
    device = torch.device("cuda", torch.cuda.current_device())
    im = local(images, rank, world).to(device)
    lb = local(labels, rank, world).to(device)
    out = {}
    for name in ("eager", "graphed"):
        model = VSSM(**model_kw).to(device)
        model.load_state_dict(weights)
        opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
        gen = torch.Generator(device=device).manual_seed(1)
        kw = dict(generator=gen, augment=True, image_size=image_size)
        if name == "graphed":
            step = trainer.compile_train_step(model, opt, generator=gen)
            losses = [step(im, lb, augment=True, image_size=image_size)
                      .clone() for _ in range(steps)]
            step.free()
            correct = trainer.compile_eval_step(model)(
                im, lb, image_size=image_size)[0].clone()
        else:
            losses = [trainer.train_step(model, opt, im, lb, **kw)
                      for _ in range(steps)]
            correct = trainer.eval_step(model, im, lb,
                                        image_size=image_size)[0]
        out[name] = dict(losses=torch.stack(losses).cpu(),
                         correct=correct.cpu(),
                         state={k: v.cpu()
                                for k, v in model.state_dict().items()})
    return out


def eval_step(rank, world, model_kw, weights, images, labels, image_size):
    model = VSSM(**model_kw)
    model.load_state_dict(weights)
    correct, logits = trainer.eval_step(model, local(images, rank, world),
                                        local(labels, rank, world),
                                        image_size=image_size)
    return dict(correct=correct, logits=logits)


def train_cli(rank, world, argv):
    """``cli.train.main(argv)`` in a group, counting the files each rank
    writes."""
    from medmamba_tpu_torch.cli import train as train_cli
    from medmamba_tpu_torch.train import checkpoint as ckpt

    writes = []
    for name in ("save_checkpoint", "save_class_indices"):
        real = getattr(ckpt, name)

        def counted(*a, real=real, name=name, **kw):
            writes.append(name)
            return real(*a, **kw)
        setattr(ckpt, name, counted)
    out = train_cli.main(argv)
    return dict(step_losses=torch.tensor(out["step_losses"],
                                         dtype=torch.float64),
                writes=len(writes), last_path=out["last_path"])


def seq_scan(rank, world, cases):
    """``selective_scan_seq_parallel`` on this rank's slice of L, for each
    case of full-length inputs: y and the final state with impl "ref" and
    "auto", and the gradients of sum(y ** 2) with "ref" (this rank's
    slices of u, delta, B and C; its contributions to A, D and the bias)."""
    from medmamba_tpu_torch.ops.seq_parallel import \
        selective_scan_seq_parallel

    out = []
    for x in cases:
        sl = {k: local(v, rank, world, dim=-1) if k in ("u", "delta", "B", "C")
              else v for k, v in x.items()}
        res = {}
        for impl in ("ref", "auto"):
            with torch.no_grad():
                res[f"y_{impl}"], res[f"h_{impl}"] = \
                    selective_scan_seq_parallel(
                        sl["u"], sl["delta"], sl["A"], sl["B"], sl["C"],
                        sl["D"], sl["bias"], True, mesh=mesh.active_mesh(),
                        impl=impl, return_last_state=True)
        leaves = {k: v.clone().requires_grad_() for k, v in sl.items()}
        y = selective_scan_seq_parallel(
            leaves["u"], leaves["delta"], leaves["A"], leaves["B"],
            leaves["C"], leaves["D"], leaves["bias"], True,
            mesh=mesh.active_mesh(), impl="ref")
        (y ** 2).sum().backward()
        res["grads"] = {k: v.grad for k, v in leaves.items()}
        out.append(res)
    return out


def seq_scan_cuda(rank, world, x):
    """The split scan on the card (impl "auto": K1 on this rank's half of
    L): y, the final state and the K1 launches (on the CPU), and the error
    a backward through it raises."""
    from medmamba_tpu_torch.ops import scan_cuda
    from medmamba_tpu_torch.ops.seq_parallel import \
        selective_scan_seq_parallel

    sl = {k: local(v, rank, world, dim=-1).contiguous().cuda()
          if k in ("u", "delta", "B", "C") else v.cuda()
          for k, v in x.items()}
    scan_cuda.LAUNCHES = 0
    with torch.no_grad():
        y, h = selective_scan_seq_parallel(
            **sl, delta_softplus=True, mesh=mesh.active_mesh(),
            return_last_state=True)
    torch.cuda.synchronize()
    launches = scan_cuda.LAUNCHES
    leaf = sl["u"].clone().requires_grad_()
    try:
        selective_scan_seq_parallel(**dict(sl, u=leaf), delta_softplus=True,
                                    mesh=mesh.active_mesh()).sum().backward()
    except RuntimeError as e:
        raised = str(e)
    else:
        raised = ""
    return dict(y=y.cpu(), h=h.cpu(), launches=launches, raised=raised)
