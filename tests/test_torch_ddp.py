"""The port's DDP step and entry points against the JAX package's.

``__graft_entry__.entry()`` and ``ompi_tpu_torch.entry.entry()`` start
from the same seed-0 weights and data; three fused steps (gradients →
ring allreduce over the rank axis → SGD) must agree to rtol 1e-5.  The
gradients come from matrix products that XLA and torch order
differently, so bit equality is not expected across the packages; inside
the port the replicas stay bit-identical, as the ring makes every rank's
gradient sum the same.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

STEPS = 3


@pytest.fixture(scope="module")
def jax_run(devices):
    import __graft_entry__

    step, (params, x, y) = __graft_entry__.entry()
    history = []
    for _ in range(STEPS):
        params = step(params, x, y)
        history.append({k: np.asarray(v) for k, v in params.items()})
    return history


def test_fused_step_matches_reference(jax_run):
    from ompi_tpu_torch.entry import entry

    step, (model, x, y) = entry(device="cpu")
    assert x.device.type == "cpu" and model.nranks == 8
    losses = []
    for want in jax_run:
        losses.append(step(model, x, y).mean().item())
        for name, p in model.named_parameters():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, want[name], rtol=1e-5, atol=1e-6)
            assert torch.equal(p, p[:1].expand_as(p)), name
    assert losses[-1] < losses[0]


def test_params_from_jax_is_the_reference_layout():
    from ddp_training import init_params, replicate

    from ompi_tpu_torch.examples.ddp_training import params_from_jax

    rep = replicate(init_params(np.random.RandomState(1)), 4)
    model = params_from_jax(rep, "cpu")
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.device.type == "cpu"
        np.testing.assert_array_equal(p.detach().numpy(), rep[name])


def test_forward_matches_reference():
    import jax.numpy as jnp
    from ddp_training import _forward, init_params, replicate

    from ompi_tpu_torch.examples.ddp_training import params_from_jax

    params = init_params(np.random.RandomState(2))
    x = np.random.RandomState(3).randn(4, 16, 8).astype(np.float32)
    model = params_from_jax(replicate(params, 4), "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(_forward({k: jnp.asarray(v) for k, v in params.items()},
                                         jnp.asarray(x[r]))) for r in range(4)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_step_rejects_wrong_replica_count():
    from ompi_tpu_torch.entry import entry
    from ompi_tpu_torch.examples.ddp_training import make_fused_step

    _, (model, x, y) = entry(device="cpu", nranks=4)
    with pytest.raises(ValueError):
        make_fused_step(8)(model, x, y)


def test_dryrun_on_cpu(capsys):
    from ompi_tpu_torch.entry import dryrun

    dryrun(8, "cpu")
    dryrun(3, "cpu")
    assert "single-process leg OK" in capsys.readouterr().out


def test_host_step_matches_reference_host_step(devices):
    """``train_step_host`` through ``comm.allreduce`` on an 8-rank CPU
    comm against the reference's ``train_step_host`` on its 8-device CPU
    world: seed-0 weights and data, three steps, parameters within rtol
    1e-5 (XLA and torch order the gradient matmuls differently)."""
    import ompi_tpu.api as rapi
    from ddp_training import init_params, replicate
    from ddp_training import train_step_host as ref_step

    import ompi_tpu_torch.api as papi
    from ompi_tpu_torch.examples.ddp_training import params_from_jax, train_step_host

    rng = np.random.RandomState(0)
    params = init_params(rng)
    x = rng.randn(8, 16, 8).astype(np.float32)
    y = (x.sum(axis=-1, keepdims=True) * 0.1).astype(np.float32)
    rworld = rapi.init()
    papi.finalize()
    pworld = papi.init(device="cpu", nranks=8)
    try:
        model = params_from_jax(replicate(params, 8), "cpu")
        ref = dict(params)
        losses = []
        for _ in range(3):
            ref = ref_step(rworld, ref, x, y)
            losses.append(train_step_host(pworld, model, torch.from_numpy(x),
                                          torch.from_numpy(y)).mean().item())
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), np.broadcast_to(
                    ref[name], p.shape), rtol=1e-5, atol=1e-6)
                assert torch.equal(p, p[:1].expand_as(p)), name
        assert losses[-1] < losses[0]
    finally:
        papi.finalize()
