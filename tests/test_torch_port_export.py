"""The port's serving export against the JAX package's, on the CPU.

Both sides export a tiny VSSM (``depths=(1, 1), dims=(16, 32),
d_state=4``) with the same weights: JAX variables drawn with numpy, carried
into the port with ``state_dict_from_jax``. The JAX artifact is StableHLO
for the CPU (``platforms=("cpu",)``, its portable associative scan, as
``tests/test_export.py`` runs it); the port's is a ``torch.export`` program
whose scans are ``medmamba::selective_scan_fwd`` nodes, which run the plain
scan on the CPU. Probabilities agree to rtol = atol = 1e-5, the tolerance
of ``test_torch_port_slice.py``'s float32 parity. Also: the ops against
``torch.library.opcheck``, the graph's node counts, and the analytic FLOP
counts, which equal the JAX package's exactly. The export CLI and loading
in a process without JAX: ``test_torch_port_export_cli.py``.
"""
from collections import Counter

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from medmamba_tpu.models import registry as jreg
from medmamba_tpu.models import vssm as jv
from medmamba_tpu.ops import flops as jflops
from medmamba_tpu.utils import export as jexport
from medmamba_tpu.utils import profiling as jprofiling
from medmamba_tpu_torch.models import registry as treg
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.ops import flops as tflops
from medmamba_tpu_torch.ops import scan_op
from medmamba_tpu_torch.utils import export as texport
from medmamba_tpu_torch.utils import profiling as tprofiling
from medmamba_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_model import _init
from test_torch_port_scan import _inputs, _settle_torch_exp  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(num_classes=3, depths=(1, 1), dims=(16, 32), d_state=4)


@pytest.fixture(scope="module")
def tiny():
    """(JAX module, its variables, the port's VSSM with the same weights)."""
    jm = jv.VSSM(**TINY, drop_path_rate=0.0, scan_impl="assoc")
    variables = _init(jm, np.zeros((2, 32, 32, 3), np.float32), 3, True)
    tm = tv.VSSM(**TINY, drop_path_rate=0.0).eval()
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def symbolic(tiny):
    """The port's symbolic-batch artifact of the tiny model at 32^2, and
    the JAX one."""
    jm, variables, tm = tiny
    return (texport.export_forward(tm, image_size=32, device="cpu"),
            jexport.export_forward(jm, variables, image_size=32,
                                   platforms=("cpu",)))


def _frames(seed, b, size):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                                dtype=np.uint8)


def _jax_call(blob, x):
    return np.asarray(jexport.load_exported(blob).call(jnp.asarray(x)))


def _torch_call(exp, x):
    got = exp.call(torch.from_numpy(x))
    assert got.dtype == torch.float32
    return got.numpy()


def test_symbolic_batch_matches_jax(symbolic):
    """One artifact on each side, called at batch 1 and 3."""
    ours, theirs = (texport.load_exported(symbolic[0]),
                    jexport.load_exported(symbolic[1]))
    for b in (1, 3):
        x = _frames(b, b, 32)
        got = _torch_call(ours, x)
        assert got.shape == (b, 3)
        np.testing.assert_allclose(
            got, np.asarray(theirs.call(jnp.asarray(x))), **TOL)


def test_fixed_batch_without_preprocess_matches_jax(tiny):
    jm, variables, tm = tiny
    ours = texport.export_forward(tm, image_size=32, batch=2,
                                  with_preprocess=False, device="cpu")
    theirs = jexport.export_forward(jm, variables, image_size=32, batch=2,
                                    platforms=("cpu",), with_preprocess=False)
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ours = texport.load_exported(ours)
    np.testing.assert_allclose(_torch_call(ours, x), _jax_call(theirs, x),
                               **TOL)
    with pytest.raises((AssertionError, RuntimeError)):   # batch pinned
        _torch_call(ours, x[:1])


def test_raw_frames_are_resized_as_jax_does(tiny):
    """input_size 48 > image_size 32: the resize is baked in (it
    antialiases when it downsamples); without the preprocessing both refuse
    the mismatch."""
    jm, variables, tm = tiny
    ours = texport.export_forward(tm, image_size=32, input_size=48, batch=2,
                                  device="cpu")
    theirs = jexport.export_forward(jm, variables, image_size=32,
                                    input_size=48, batch=2,
                                    platforms=("cpu",))
    x = _frames(6, 2, 48)
    np.testing.assert_allclose(_torch_call(texport.load_exported(ours), x),
                               _jax_call(theirs, x), **TOL)
    with pytest.raises(ValueError):
        texport.export_forward(tm, image_size=32, input_size=48, batch=2,
                               with_preprocess=False, device="cpu")
    with pytest.raises(ValueError):
        jexport.export_forward(jm, variables, image_size=32, input_size=48,
                               batch=2, platforms=("cpu",),
                               with_preprocess=False)


def test_export_leaves_no_traced_constant_for_the_eager_path(tiny):
    """A resize matrix first made while ``torch.export`` traces is a fake
    tensor of that trace; eager calls in the same process after the export
    get a real one (40^2 frames: a size no other test resizes from)."""
    from medmamba_tpu_torch.data.transforms import preprocess

    _, _, tm = tiny
    texport.export_forward(tm, image_size=32, input_size=40, batch=2,
                           device="cpu")
    x = torch.from_numpy(_frames(7, 2, 40))
    got = preprocess(x, size=32)
    assert type(got) is torch.Tensor and got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  preprocess(x, size=32).numpy())


def _call_targets(blob):
    graph = texport.load_exported(blob).program.graph
    return Counter(str(n.target) for n in graph.nodes
                   if n.op == "call_function")


def test_graph_holds_one_op_per_scan(tiny, symbolic):
    """2 scan calls per SS2D block, each one node; the same number of nodes
    at 64^2 (L 256 and 64) as at 32^2 (L 64 and 16): no step of a scan is
    unrolled into the graph."""
    tm = tiny[2]
    small = _call_targets(symbolic[0])
    large = _call_targets(texport.export_forward(tm, image_size=64,
                                                 device="cpu"))
    assert small["medmamba.selective_scan_fwd.default"] == 2 * sum(
        TINY["depths"])
    assert small == large


OPCHECK_CASES = {
    "reverse": dict(reverse_dirs=[True, True]),
    "shared_u_valid_len": dict(reverse_dirs=[False, True], u_tile=2,
                               valid_len=17, return_last_state=True),
    "bf16_out": dict(reverse_dirs=[True, False], out_dtype=torch.bfloat16,
                     valid_len=20, return_last_state=True),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_scan_op_passes_opcheck_and_equals_the_plain_scan(case):
    """The op's schema, its fake kernel against the CPU kernel (shapes,
    dtypes, symbolic sizes) and its registration; and its outputs are the
    plain version's bits."""
    from medmamba_tpu_torch.ops.selective_scan import selective_scan

    kw = dict(reverse_dirs=None, u_tile=1, out_dtype=None, valid_len=None,
              return_last_state=False)
    kw.update(OPCHECK_CASES[case])
    x = {k: torch.from_numpy(v) for k, v in
         _inputs(7, u_tile=kw["u_tile"]).items()}
    args = (x["u"], x["delta"], x["A"], x["B"], x["C"], x["D"],
            x["delta_bias"], True, kw["return_last_state"],
            kw["reverse_dirs"], kw["u_tile"], kw["out_dtype"],
            kw["valid_len"])
    torch.library.opcheck(scan_op.selective_scan_fwd, args)
    got = scan_op.selective_scan_fwd(*args)
    want = selective_scan(**x, delta_softplus=True, impl="ref", **kw)
    want = list(want) if kw["return_last_state"] else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("image_size", [224, 28])
@pytest.mark.parametrize("size", sorted(jreg.MODEL_CONFIGS))
def test_flops_equal_jax(size, image_size):
    cfg = treg.MODEL_CONFIGS[size]
    assert (cfg.depths, cfg.dims) == (jreg.MODEL_CONFIGS[size].depths,
                                      jreg.MODEL_CONFIGS[size].dims)
    for kw in (dict(num_classes=9), dict()):
        assert tprofiling.model_flops_report(
            cfg.depths, cfg.dims, image_size, **kw) == \
            jprofiling.model_flops_report(cfg.depths, cfg.dims, image_size,
                                          **kw)
    l = (image_size // 4) ** 2
    for d in cfg.dims:
        for kw in (dict(), dict(with_D=False, with_Z=True, with_Group=False)):
            assert tflops.flops_selective_scan(3, l, 4 * d, 16, **kw) == \
                jflops.flops_selective_scan(3, l, 4 * d, 16, **kw)
        assert tflops.flops_ss2d(image_size // 4, image_size // 4, d) == \
            jflops.flops_ss2d(image_size // 4, image_size // 4, d)
