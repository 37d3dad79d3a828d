"""The plain versions of the probes P1 (``tools/probe_vpu.py``) and P2
(``tools/probe_mosaic.py``) against the TPU kernels' bodies, on the CPU.

The JAX side runs the TPU tools' own kernels through ``pl.pallas_call`` in
interpret mode: P1's ``make_kernel`` on a (64, 128) array in (32, 128)
blocks; P2's 14 bodies at the tool's shapes, by loading the tool with
``pallas_call`` made to interpret and recording each output (the tool runs
its probes at import). The port's kernels run only on the card
(``tests/test_torch_port_cuda.py``). Tolerances: P1 float32 1e-5 of the
output's largest entry, and the share of the chain's effect that each
carries (``probe_vpu.work_share``; the effect is below 1e-5 of the output
in chain, mul, mul8 and par4); bfloat16 one unit in the last place of each
value (2^-7 of its binade); P2 exact.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from medmamba_tpu_torch.tools import probe_mosaic as tpm
from medmamba_tpu_torch.tools import probe_vpu as tpv

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _load(name, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       os.environ.get("JAX_COMPILATION_CACHE_DIR", ""))
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_vpu():
    mp = pytest.MonkeyPatch()
    try:
        yield _load("probe_vpu", mp)
    finally:
        mp.undo()


CASES_P1 = [(m, dt, k) for m in tpv.MODES for dt in tpv.dtypes(m)
            for k in tpv.ks(m)]


@pytest.mark.parametrize("mode,dtype,k", CASES_P1,
                         ids=[f"{m}-{str(d)[6:]}-{k}" for m, d, k in CASES_P1])
def test_probe_vpu_plain_version_matches_tpu_kernel(jax_vpu, mode, dtype, k):
    x = np.random.default_rng(k).standard_normal((64, 128)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    want = pl.pallas_call(
        jax_vpu.make_kernel(k, mode), grid=(2,),
        in_specs=[pl.BlockSpec((32, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((32, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jdt), interpret=True)(xj)
    want = np.asarray(want.astype(jnp.float32))
    got = tpv.probe_vpu(torch.from_numpy(x).to(dtype), k, mode)
    assert got.dtype == dtype
    got = got.float().numpy()
    if dtype == torch.float32:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, err
        # the chain's effect: the TPU body's as the float64 evaluation
        # that the card check holds the kernel to, within WORK_TOL; the
        # plain version's within 3e-2 (rounding a product before adding
        # 1e-7 drops the addend where it is below half a unit in the last
        # place; XLA fuses par4's multiply-add as the kernel does)
        xt = torch.from_numpy(x)
        share = tpv.work_share(torch.from_numpy(want), xt, k, mode)
        assert abs(share - 1) <= tpv.WORK_TOL, share
        share = tpv.work_share(torch.from_numpy(got), xt, k, mode)
        assert abs(share - 1) <= 3e-2, share
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_probe_vpu_counts_el_ops_as_the_tpu_probe():
    n = 64 * 128
    assert tpv.el_ops("chain", 16, n) == n * 32
    assert tpv.el_ops("par4", 64, n) == n * 128
    assert tpv.el_ops("mul8", 64, n) == tpv.el_ops("exp", 64, n) == n * 64
    assert tpv.el_ops("mix", 150, n) == n * 150
    assert tpv.el_ops("mix", 60, n) == n * 60
    # the bound: bytes for the cheap modes, the exponential units for exp
    b = tpv.bounds("mul", 16, torch.float32, 16384, 512, 132, 1.98e9)
    assert b["bound_by"] == "bytes"
    b = tpv.bounds("exp", 64, torch.float32, 16384, 512, 132, 1.98e9)
    assert b["bound_by"] == "operations" and b["issue_ms"] == b["sfu_ms"]


@pytest.fixture(scope="module")
def jax_mosaic_outputs():
    """The 14 outputs of the TPU tool's bodies in interpret mode, in its
    order, and the operands it made."""
    mp = pytest.MonkeyPatch()
    real, outs = pl.pallas_call, []

    def interpreting(kernel, **kw):
        fn = real(kernel, interpret=True, **kw)

        def call(x):
            y = fn(x)
            outs.append(np.asarray(y))
            return y
        return call
    mp.setattr(pl, "pallas_call", interpreting)
    try:
        mod = _load("probe_mosaic", mp)
    finally:
        mp.undo()
    return outs, {"x4": np.array(mod.x4), "xw": np.array(mod.xw)}


def test_probe_mosaic_operands_are_the_tpu_tools(jax_mosaic_outputs):
    _, operands = jax_mosaic_outputs
    for name, x in tpm.inputs().items():
        np.testing.assert_array_equal(x.numpy(), operands[name])


@pytest.mark.parametrize("probe", range(len(tpm.PROBES)),
                         ids=[p.name.split(" ")[0] + str(i)
                              for i, p in enumerate(tpm.PROBES)])
def test_probe_mosaic_plain_version_equals_tpu_body(jax_mosaic_outputs,
                                                    probe):
    outs, operands = jax_mosaic_outputs
    assert len(outs) == len(tpm.PROBES)
    p = tpm.PROBES[probe]
    got = tpm.probe_mosaic(probe, torch.from_numpy(operands[p.operand]))
    assert tuple(got.shape) == p.out_shape == outs[probe].shape
    np.testing.assert_array_equal(got.numpy(), outs[probe])
    np.testing.assert_allclose(
        p.library(torch.from_numpy(operands[p.operand])).numpy(),
        outs[probe], rtol=1e-6, atol=1e-6)
