"""The port's tensor parallelism (the mesh's ``model`` axis) against one
process, on the CPU.

Gloo ranks (``torch_port_ranks.spawn``, a ``file://`` rendezvous in the
test's directory) on a 1x2 and a 2x2 ("data", "model") mesh run the tiny
VSSM of ``tests/test_sharding.py`` (depths (1, 1), dims (8, 16), d_state 4)
at 16^2, partitioned with ``partition_params``. Each mesh is spawned once
(a module fixture) and every check below reads its ranks' results:

* (b) a TP step equals one process on the whole batch: the loss within
  1e-6 relative, the gradients AdamW is given (shards gathered) and the
  BatchNorm running statistics within 1e-5 of their scale (a gradient
  that is zero in exact arithmetic, as a convolution bias's in front of a
  BatchNorm, is held to 1e-5 of 1e-3 of the largest gradient; the
  statistics' scale is the largest statistic), with augmentation and
  DropPath on, on a full batch of 8 and on 5 real rows padded to 8, and
  on the full batch with every block rematerialised in the backward; the
  model ranks' replicated parameters and buffers the same bits;
* (d) the scan under the model axis equals the plain scan in y, the last
  state and the gradients at 1e-5 of their scale, each model rank
  scanning its half of its rows; a local batch the model ranks do not
  divide runs whole on every rank;
* (e) gradients through the gather pair equal one process's at 1e-6 of
  their scale, where the summing ``all_gather`` gives the model axis's
  size times them;
* (f) a partitioned model's ``.pth`` is one process's state dict bit for
  bit (and its AdamW moments whole), and loads back into the mesh to the
  same bits;
* (g) ``make_mesh(n_model=2)`` builds the 2-D mesh, the data axis slices
  the loader, and a mesh that does not cover the ranks raises.

The checks against the JAX package, (a) the partition rules and (c) the
TP step, are in ``test_torch_port_tensor_parallel_jax.py``.
"""
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from medmamba_tpu_torch.models.vssm import VSSM
from medmamba_tpu_torch.ops.selective_scan import selective_scan
from medmamba_tpu_torch.parallel.mesh import active_mesh
from medmamba_tpu_torch.train import trainer
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

TINY = dict(num_classes=3, depths=(1, 1), dims=(8, 16), d_state=4)
SIZE = 16
# mesh name -> (world, n_model)
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}
SEED = 11


def _batch(seed, real=8, b=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (b,)).astype(np.int64)
    labels[real:] = -1
    return torch.from_numpy(images), torch.from_numpy(labels)


BATCHES = {8: _batch(8, real=8), 5: _batch(5, real=5)}


def _weights():
    return VSSM(**TINY, drop_path_rate=0.5,
                generator=torch.Generator().manual_seed(3)).state_dict()


def _scan_case(b, seed, d=8, g=2, n=4, l=20):
    gen = torch.Generator().manual_seed(seed)
    return dict(u=torch.randn(b, d, l, generator=gen),
                delta=0.3 * torch.randn(b, d, l, generator=gen),
                A=-torch.exp(0.5 * torch.randn(d, n, generator=gen)),
                B=torch.randn(b, g, n, l, generator=gen),
                C=torch.randn(b, g, n, l, generator=gen),
                D=torch.randn(d, generator=gen),
                bias=0.1 * torch.randn(d, generator=gen))


def _scan_cases(n_data):
    """A batch whose data slices the two model ranks divide (4 rows a
    data row) and one they do not (3 rows)."""
    return [_scan_case(4 * n_data, 1), _scan_case(3 * n_data, 2)]


def _pair():
    gen = torch.Generator().manual_seed(7)
    return dict(v=torch.randn(6, 3, generator=gen),
                a=torch.randn(3, generator=gen),
                w=torch.randn(5, 4, generator=gen),
                x=torch.randn(4, 2, generator=gen))


def _one_process_step(weights, images, labels):
    model = VSSM(**TINY, drop_path_rate=0.5)
    model.load_state_dict(weights)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in model.named_parameters()}))
    loss = trainer.train_step(model, opt, images, labels,
                              generator=torch.Generator().manual_seed(SEED),
                              augment=True, image_size=SIZE)
    return dict(loss=loss, grads=grads, state=model.state_dict())


def _rel(got, want, floor: float = 1e-30) -> float:
    scale = max(float(want.abs().max()), floor)
    return float((got - want).abs().max()) / scale


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module", params=sorted(MESHES))
def tp(request, tmp_path_factory, weights):
    """(mesh name, the ranks' results of ``torch_port_ranks.tp_checks``)."""
    assert active_mesh() is None
    world, n_model = MESHES[request.param]
    root = tmp_path_factory.mktemp(f"tp_{request.param}")
    got = ranks.spawn(ranks.tp_checks, world, root,
                      dict(TINY, drop_path_rate=0.5), weights,
                      [BATCHES[8], BATCHES[5]], True, SEED, SIZE,
                      _scan_cases(world // n_model), _pair(), str(root),
                      n_model=n_model)
    return request.param, got


def test_mesh_axes(tp):
    name, got = tp
    world, n_model = MESHES[name]
    n_data = world // n_model
    for r, g in enumerate(got):
        m = g["mesh"]
        assert m["names"] == ("data", "model")
        assert m["shape"] == (n_data, n_model)
        assert (m["model_size"], m["model_rank"]) == (n_model, r % n_model)
        assert m["process_slice"] == (r // n_model, n_data)
        assert "does not cover" in m["uncovered"]


@pytest.fixture(scope="module")
def one_process(weights):
    return {real: _one_process_step(weights, *BATCHES[real])
            for real in BATCHES}


@pytest.mark.parametrize("real,remat", [(8, False), (5, False),
                                        (8, True)])
def test_tp_step_as_one_process(tp, one_process, real, remat):
    """With ``remat`` the model rematerialises each block in the backward,
    running its forward collectives again there."""
    _, got = tp
    want = one_process[real]
    step = [8, 5].index(real)
    floor = 1e-3 * max(float(w.abs().max()) for w in want["grads"].values())
    stats = {k: v for k, v in want["state"].items()
             if k.endswith(("running_mean", "running_var"))}
    stat_scale = max(float(w.abs().max()) for w in stats.values())
    for g in got:
        s = g["remat"] if remat else g["steps"][step]
        assert abs(s["loss"].item() - want["loss"].item()) \
            <= 1e-6 * abs(want["loss"].item())
        assert sorted(s["grads"]) == sorted(want["grads"])
        for name, w in want["grads"].items():
            assert _rel(s["grads"][name], w, floor) <= 1e-5, name
        for name, w in stats.items():
            assert float((s["state"][name] - w).abs().max()) \
                <= 1e-5 * stat_scale, name
        assert s["state"].keys() == want["state"].keys()


def test_model_ranks_hold_the_same_replicated_bits(tp):
    name, got = tp
    n_model = MESHES[name][1]
    for step in range(len(BATCHES)):
        for r, g in enumerate(got):
            first = got[r - r % n_model]["steps"][step]["replicated"]
            mine = g["steps"][step]["replicated"]
            assert mine.keys() == first.keys()
            for k, v in first.items():
                assert torch.equal(mine[k], v), (r, k)
            # the data rows applied the same update too
            for k, v in got[0]["steps"][step]["state"].items():
                assert torch.equal(g["steps"][step]["state"][k], v), (r, k)


def test_scan_reshards_its_batch_over_the_model_axis(tp):
    name, got = tp
    world, n_model = MESHES[name]
    n_data = world // n_model
    for case, x in enumerate(_scan_cases(n_data)):
        leaves = {k: v.clone().requires_grad_() for k, v in x.items()}
        y, last = selective_scan(
            leaves["u"], leaves["delta"], leaves["A"], leaves["B"],
            leaves["C"], leaves["D"], leaves["bias"], True,
            return_last_state=True, reverse_dirs=(False, True))
        ((y ** 2).sum() + last.sum()).backward()
        local_b = x["u"].shape[0] // n_data
        rows = local_b // n_model if local_b % n_model == 0 else local_b
        rows_a_row = [got[d * n_model]["scan"][case] for d in range(n_data)]
        for r, g in enumerate(got):
            s = g["scan"][case]
            # a scan with the last state and one without, on its rows
            assert s["rows"] == [rows, rows], (r, s["rows"])
            torch.testing.assert_close(s["y_only"], s["y"], rtol=0, atol=0)
            mate = rows_a_row[r // n_model]
            for k in ("y", "last"):
                assert torch.equal(s[k], mate[k]), (r, k)
        got_y = torch.cat([s["y"] for s in rows_a_row])
        got_last = torch.cat([s["last"] for s in rows_a_row])
        assert _rel(got_y, y.detach()) <= 1e-5
        assert _rel(got_last, last.detach()) <= 1e-5
        for k, leaf in leaves.items():
            if k in ("u", "delta", "B", "C"):
                grad = torch.cat([s["grads"][k] for s in rows_a_row])
            else:
                grad = sum(s["grads"][k] for s in rows_a_row)
            assert _rel(grad, leaf.grad) <= 1e-5, (case, k)


def test_gather_pair_gradients_are_one_process_s(tp):
    name, got = tp
    n_model = MESHES[name][1]
    x = _pair()
    leaves = {k: x[k].clone().requires_grad_() for k in ("v", "a", "w")}
    y = leaves["v"] * leaves["a"]
    ((y ** 2).sum() + ((leaves["w"] @ x["x"]) ** 2).sum()).backward()
    for r, g in enumerate(got):
        m = r % n_model
        for name_, grads in g["pair"].items():
            times = 1 if name_ == "from_shards" else n_model
            for k, leaf in leaves.items():
                want = leaf.grad
                if k == "w":
                    want = ranks.local(want, m, n_model, dim=1)
                assert _rel(grads[k], times * want) <= 1e-6, (name_, k)


def test_partitioned_checkpoint_is_one_process_s(tp, weights):
    _, got = tp
    ck = got[0]["checkpoint"]
    before = torch.load(ck["before"], weights_only=True)
    assert before["model_state_dict"].keys() == weights.keys()
    for k, v in weights.items():
        assert torch.equal(before["model_state_dict"][k], v), k
    assert before["optimizer_state_dict"]["state"] == {}
    after = torch.load(ck["after"], weights_only=True)
    state = got[0]["steps"][0]["state"]
    for k, v in state.items():
        assert torch.equal(after["model_state_dict"][k], v), k
    # whole moments: one process's optimizer loads them
    model = VSSM(**TINY)
    model.load_state_dict(after["model_state_dict"])
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    opt.load_state_dict(after["optimizer_state_dict"])
    for p in model.parameters():
        assert opt.state[p]["exp_avg"].shape == p.shape
    assert all(g["checkpoint"]["loaded_same"] for g in got)
