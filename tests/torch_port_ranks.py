"""Rank processes for the port's data-, tensor- and sequence-parallel tests.

:func:`spawn` starts ``world`` processes (the ``spawn`` start method), each
joining one gloo group through a ``file://`` rendezvous in the test's
temporary directory (no port to collide on between test workers); each
calls ``fn(rank, world, *args)`` under the port's active mesh (``world /
n_model`` data rows of ``n_model`` model ranks) and saves what it
returns, which :func:`spawn` hands back in rank order. The ranks import
torch and the port only, never JAX.
"""
import os

import torch

from medmamba_tpu_torch.models.vssm import VSSM
from medmamba_tpu_torch.parallel import mesh
from medmamba_tpu_torch.train import trainer

JOIN_S = 120


def _entry(fn, rank, world, root, device, backend, n_model, args):
    torch.set_num_threads(1)
    # a process's first torch.exp can come back up to 1.1e-4 off on the
    # CPU (ROADMAP.md §C, C1); settle it before anything is compared
    torch.exp(torch.linspace(-1.0, 0.0, 64))
    mesh.make_mesh(n_model=n_model, device=device, rank=rank,
                   world_size=world,
                   init_method=f"file://{os.path.join(root, 'rendezvous')}",
                   backend=backend)
    try:
        result = fn(rank, world, *args)
    finally:
        mesh.destroy_mesh()
    torch.save(result, os.path.join(root, f"rank{rank}.pt"))


def spawn(fn, world: int, root, *args, device: str = "cpu",
          backend: str = "gloo", n_model: int = 1) -> list:
    """``fn(rank, world, *args)`` in ``world`` ranks of a ``backend`` group
    on ``device``: "cpu" or "cuda:0" (every rank on that one), or "cuda"
    (rank i on card i, as NCCL needs); the mesh has ``n_model`` model
    ranks a data row."""
    return start(fn, world, root, *args, device=device, backend=backend,
                 n_model=n_model).results()


class Ranks:
    """Rank processes that :func:`start` launched; :meth:`results` joins
    them and returns what each saved."""

    def __init__(self, procs, root: str):
        self.procs, self.root = procs, root

    def results(self, join_s: float = JOIN_S) -> list:
        procs = self.procs
        for p in procs:
            p.join(join_s)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        assert not hung, f"{len(hung)} rank(s) still running after {join_s} s"
        assert [p.exitcode for p in procs] == [0] * len(procs), \
            [p.exitcode for p in procs]
        return [torch.load(os.path.join(self.root, f"rank{r}.pt"),
                           weights_only=True) for r in range(len(procs))]


def start(fn, world: int, root, *args, device: str = "cpu",
          backend: str = "gloo", n_model: int = 1) -> Ranks:
    """:func:`spawn` without waiting: the caller works on while the ranks
    run, then calls ``results()``."""
    import multiprocessing as mp

    root = str(root)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, root, device, backend, n_model,
                               args))
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, root)


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


def trajectory(rank, world, model_kw, weights, images, labels, first,
               image_size):
    """The trajectory harness's mesh arm on the active mesh (the 2x1 data
    mesh or the 1x2 model mesh): ``tools/trajectory.py: run_arm`` on the
    uint8 stream ``images``/``labels`` (augmentation off), and the first
    step's whole gradients on the batch ``first``. Returns the losses,
    the final whole state and those gradients."""
    from medmamba_tpu_torch.tools import trajectory as harness

    grid = mesh.active_mesh()
    arm = harness.run_arm(model_kw, weights, images, labels, device="cpu",
                          mesh=grid, image_size=image_size)
    if torch.distributed.get_world_size(mesh.model_group(grid)) == 1:
        step = train_step(rank, world, model_kw, weights, *first, False, 0,
                          image_size)
    else:
        step = tp_step(model_kw, weights, *first, False, 0, image_size)
    return dict(losses=torch.from_numpy(arm["losses"]), state=arm["state"],
                grads=step["grads"])


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


# ---------------------------------------------------------------------------
# Tensor parallelism (the mesh's model axis)
# ---------------------------------------------------------------------------


def data_slice(x: torch.Tensor):
    """This rank's rows of a global batch: its data row's slice (the model
    ranks of one row hold the same rows)."""
    index, count = mesh.process_slice()
    return local(x, index, count)


def tp_model(model_kw, weights):
    """A VSSM loaded from whole ``weights`` and partitioned over the active
    mesh's model axis, and its AdamW."""
    model = VSSM(**model_kw)
    mesh.partition_params(model)
    model.load_state_dict(weights)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    return model, opt


def replicated(model) -> dict:
    """The rank's parameters that are not partitioned, and its buffers."""
    out = {n: p.detach().clone() for n, p in model.named_parameters()
           if mesh.model_shard(p) is None}
    out.update({n: b.clone() for n, b in model.named_buffers()})
    return out


def tp_step(model_kw, weights, images, labels, augment, seed, image_size):
    """One TP ``train_step`` on this rank's data slice: the loss, the
    whole gradients AdamW was given (shards gathered), the whole state
    after the step, and this rank's replicated tensors."""
    model, opt = tp_model(model_kw, weights)
    params = dict(model.named_parameters())
    shards = {}
    opt.register_step_pre_hook(lambda *_: shards.update(
        {n: p.grad.clone() for n, p in params.items()}))
    loss = trainer.train_step(model, opt, data_slice(images),
                              data_slice(labels),
                              generator=torch.Generator().manual_seed(seed),
                              augment=augment, image_size=image_size)
    grads = {n: mesh.unshard(g, mesh.model_shard(params[n]))
             if mesh.model_shard(params[n]) is not None else g
             for n, g in shards.items()}
    return dict(loss=loss, grads=grads, state=mesh.full_state_dict(model),
                replicated=replicated(model), model=model, opt=opt)


def tp_scan(cases):
    """``ops.selective_scan`` on this rank's data slice of each case (the
    plain route on the CPU, with and without ``return_last_state``): y,
    the last state, the gradients of sum(y ** 2) + sum(last), and the
    batch each local scan ran on."""
    from medmamba_tpu_torch.ops import selective_scan as ss

    rows = []
    local_scan = ss._local_scan

    def recording(u, *rest):
        rows.append(u.shape[0])
        return local_scan(u, *rest)
    ss._local_scan = recording
    out = []
    try:
        for x in cases:
            leaves = {k: (data_slice(v) if k in ("u", "delta", "B", "C")
                          else v).clone().requires_grad_()
                      for k, v in x.items()}
            del rows[:]
            y, last = ss.selective_scan(
                leaves["u"], leaves["delta"], leaves["A"], leaves["B"],
                leaves["C"], leaves["D"], leaves["bias"], True,
                return_last_state=True, reverse_dirs=(False, True))
            ((y ** 2).sum() + last.sum()).backward()
            y_only = ss.selective_scan(
                leaves["u"], leaves["delta"], leaves["A"], leaves["B"],
                leaves["C"], leaves["D"], leaves["bias"], True,
                reverse_dirs=(False, True))
            out.append(dict(y=y.detach(), last=last.detach(),
                            y_only=y_only.detach(), rows=list(rows),
                            grads={k: v.grad for k, v in leaves.items()}))
    finally:
        ss._local_scan = local_scan
    return out


def tp_gather_pair(v, a, w, x):
    """The model axis's autograd pair on known values: y = the ranks'
    slices of ``v`` times ``a`` (``to_shards``, ``copy_to_model``), joined
    (``from_shards``), and this rank's shard of ``w`` gathered whole and
    applied to ``x``; the gradients of sum(y ** 2) + sum((w x) ** 2) as
    ``from_shards`` gives them and as the summing ``all_gather`` would."""
    group = mesh.model_group()
    rank, n = torch.distributed.get_rank(group), \
        torch.distributed.get_world_size(group)
    out = {}
    for name in ("from_shards", "all_gather"):
        leaves = dict(v=v.clone().requires_grad_(),
                      a=a.clone().requires_grad_(),
                      w=local(w, rank, n, dim=1).clone().requires_grad_())
        part = mesh.to_shards(leaves["v"], group, 0) \
            * mesh.copy_to_model(leaves["a"], group)
        if name == "from_shards":
            y = mesh.from_shards(part, group, 0)
            whole = mesh.from_shards(leaves["w"], group, 1)
        else:
            y = mesh.all_gather(part, group).flatten(0, 1)
            whole = torch.cat(mesh.all_gather(leaves["w"], group).unbind(0),
                              dim=1)
        ((y ** 2).sum() + ((whole @ x) ** 2).sum()).backward()
        out[name] = {k: t.grad for k, t in leaves.items()}
    return out


def tp_checks(rank, world, model_kw, weights, batches, augment, seed,
              image_size, scan_cases, pair, root):
    """The CPU tensor-parallel checks in one group: the mesh, a TP step on
    each of ``batches``, the scan on ``scan_cases``, the autograd pair on
    ``pair``, and a checkpoint written whole and loaded back."""
    from medmamba_tpu_torch.train import checkpoint as ckpt

    grid = mesh.active_mesh()
    group = mesh.model_group()
    try:
        mesh.make_mesh(n_data=3, n_model=2, device="cpu")
    except ValueError as e:
        uncovered = str(e)
    else:
        uncovered = ""
    out = dict(mesh=dict(names=grid.mesh_dim_names,
                         shape=tuple(grid.shape),
                         model_size=torch.distributed.get_world_size(group),
                         model_rank=torch.distributed.get_rank(group),
                         process_slice=mesh.process_slice(),
                         uncovered=uncovered))
    out["steps"] = [tp_step(model_kw, weights, im, lb, augment, seed,
                            image_size) for im, lb in batches]
    # the first batch again with each block rematerialised in the backward,
    # which runs its forward collectives again there
    remat = tp_step(dict(model_kw, use_checkpoint=True), weights,
                    *batches[0], augment, seed, image_size)
    out["remat"] = {k: remat[k] for k in ("loss", "grads", "state")}
    out["scan"] = tp_scan(scan_cases)
    out["pair"] = tp_gather_pair(**pair)

    # a checkpoint of the partitioned model before and after its step
    fresh, fresh_opt = tp_model(model_kw, weights)
    before = os.path.join(root, "before.pth")
    after = os.path.join(root, "after.pth")
    ckpt.save_checkpoint(before, fresh, fresh_opt, epoch=0, best_acc=0.0,
                         num_classes=model_kw["num_classes"],
                         class_indices={})
    stepped = out["steps"][0]
    ckpt.save_checkpoint(after, stepped["model"], stepped["opt"], epoch=1,
                         best_acc=0.5, num_classes=model_kw["num_classes"],
                         class_indices={})
    torch.distributed.barrier()
    loaded, loaded_opt = tp_model(model_kw, weights)
    ckpt.restore_checkpoint(after, loaded, loaded_opt)
    ref_params = dict(stepped["model"].named_parameters())
    same = all(torch.equal(p, ref_params[n])
               for n, p in loaded.named_parameters())
    ref_state = stepped["opt"].state
    for p, q in zip(loaded.parameters(), stepped["model"].parameters()):
        for k, v in loaded_opt.state[p].items():
            same = same and torch.equal(v.cpu(), ref_state[q][k].cpu())
    out["checkpoint"] = dict(before=before, after=after, loaded_same=same)
    for s in out["steps"]:
        del s["model"], s["opt"]
    return out


def tp_jax_step(rank, world, model_kw, weights, images, labels, image_size):
    """The TP step of ``test_sharding.py``'s TP test (augmentation off,
    draws from seed 0): the loss, the whole gradients AdamW was given and
    the whole state after it."""
    s = tp_step(model_kw, weights, images, labels, False, 0, image_size)
    return dict(loss=s["loss"], grads=s["grads"], state=s["state"])


def tp_graphed_steps(rank, world, images, labels, steps, num_classes):
    """On this rank's card, under the active mesh: medmamba_t from seed 0,
    partitioned, ``steps`` float32 train steps on its data row's slice with
    augmentation under ``cudnn.deterministic``, eagerly and then as a CUDA
    graph captured with the data and model groups' NCCL collectives, from
    the same generator seed. Returns each run's losses and local state on
    the CPU, their launch counts, and the rows of every eager scan launch."""
    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.ops import scan_cuda
    from medmamba_tpu_torch.utils import graphs

    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.deterministic = True
    im, lb = data_slice(images).to(device), data_slice(labels).to(device)
    rows = []
    real = {n: getattr(scan_cuda, n)
            for n in ("selective_scan_fwd", "selective_scan_bwd")}

    def recording(name):
        def call(u, *args, **kw):
            rows.append(int(u.shape[0]))
            return real[name](u, *args, **kw)
        return call
    out = {}
    for name in ("eager", "graphed"):
        model = create_model("T", num_classes, device=device,
                             generator=torch.Generator().manual_seed(0))
        mesh.partition_params(model)
        opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
        gen = torch.Generator(device=device).manual_seed(1)
        kw = dict(augment=True, image_size=images.shape[1])
        if name == "graphed":
            step = trainer.compile_train_step(model, opt, generator=gen)
            before = graphs.read_counts()
            losses = [step(im, lb, **kw).clone() for _ in range(steps)]
            counts = {k: v - before[k] for k, v in graphs.read_counts()
                      .items()}
        else:
            for n in real:
                setattr(scan_cuda, n, recording(n))
            before = graphs.read_counts()
            try:
                losses = [trainer.train_step(model, opt, im, lb,
                                             generator=gen, **kw)
                          for _ in range(steps)]
            finally:
                for n, f in real.items():
                    setattr(scan_cuda, n, f)
            counts = {k: v - before[k] for k, v in graphs.read_counts()
                      .items()}
        out[name] = dict(losses=torch.stack(losses).cpu(), counts=counts,
                         state={k: v.cpu()
                                for k, v in model.state_dict().items()})
        if name == "graphed":
            step.free()
    out["rows"] = rows
    torch.backends.cudnn.deterministic = False
    return out
