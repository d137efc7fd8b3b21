"""The port's ring attention against the reference's, after
``tests/test_examples.py``.

The same seeded inputs (``np.random.RandomState``, the reference test's
seeds and shapes) go through ``examples/ring_attention.py`` on the
reference's 8 virtual CPU devices and through
``ompi_tpu_torch.examples.ring_attention`` on 8 rows on the CPU.  Both
must match dense attention at the reference test's tolerance (rtol 2e-4,
atol 2e-5: float32 online softmax against an exact softmax) and each
other at the same tolerance (XLA and torch order the float32 sums of
the two einsums differently, so bits are not expected to agree).  The
rotation must go through the ring hop, 2(n-1) times per call.  The
``cuda`` case repeats the check on the card, where those hops are
kernel launches.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import ompi_tpu.api as rapi
import ompi_tpu_torch.api as papi
from ompi_tpu_torch.examples import ring_attention as pra

N = 8
TOL = {"rtol": 2e-4, "atol": 2e-5}


@pytest.fixture(scope="module")
def worlds(devices):
    papi.finalize()
    pw = papi.init(device="cpu", nranks=N)
    yield rapi.init(), pw
    papi.finalize()


def _qkv(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("seed,shape", [(3, (N, 5, 2, 4)), (9, (N, 32, 1, 8))],
                         ids=["small", "long_sequence"])
def test_ring_attention_matches_reference_and_dense(worlds, seed, shape, monkeypatch):
    from ring_attention import reference_attention, ring_attention

    rw, pw = worlds
    q, k, v = _qkv(seed, shape)
    hops = []
    real = pra.ring_hop

    def counted(*a):
        hops.append(tuple(a[0].shape))
        return real(*a)

    monkeypatch.setattr(pra, "ring_hop", counted)
    got = pra.ring_attention(pw, q, k, v)
    assert isinstance(got, np.ndarray) and got.shape == shape and got.dtype == np.float32
    assert hops == [(N, 1, shape[1] * shape[2] * shape[3])] * (2 * (N - 1))
    np.testing.assert_allclose(got, reference_attention(q, k, v), **TOL)
    np.testing.assert_allclose(got, pra.reference_attention(q, k, v), **TOL)
    np.testing.assert_allclose(got, np.asarray(ring_attention(rw, q, k, v)), **TOL)


def test_ring_attention_keeps_tensors_on_the_comms_device(worlds):
    _rw, pw = worlds
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, (N, 6, 2, 4)))
    out = pra.ring_attention(pw, q, k, v)
    assert isinstance(out, torch.Tensor) and out.device == pw.device
    np.testing.assert_allclose(out.numpy(), pra.reference_attention(q.numpy(), k.numpy(),
                                                                    v.numpy()), **TOL)


def test_ring_attention_single_rank_has_no_rotation():
    from ompi_tpu_torch.api import Comm, Group
    from ompi_tpu_torch.mesh import CommMesh

    one = Comm(Group([0]), CommMesh("cpu", 1), name="one")
    q, k, v = _qkv(5, (1, 7, 2, 4))
    np.testing.assert_allclose(pra.ring_attention(one, q, k, v),
                               pra.reference_attention(q, k, v), **TOL)


@pytest.mark.cuda
def test_ring_attention_on_the_card_launches_the_ring_hop():
    from ompi_tpu_torch.api import Comm, Group
    from ompi_tpu_torch.coll import cuda_kernels as ck
    from ompi_tpu_torch.mesh import CommMesh

    if not torch.cuda.is_available() or not ck.kernel_available():
        pytest.skip("needs an sm_90 CUDA card")
    comm = Comm(Group(range(N)), CommMesh("cuda", N), name="ring_attention")
    q, k, v = _qkv(3, (N, 64, 4, 32))
    before = ck.LAUNCHES["ring_hop"]
    out = pra.ring_attention(comm, *(torch.from_numpy(a).cuda() for a in (q, k, v)))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["ring_hop"] - before == 2 * (N - 1)
    np.testing.assert_allclose(out.cpu().numpy(), pra.reference_attention(q, k, v), **TOL)
