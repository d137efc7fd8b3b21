"""ompi_tpu_torch — the PyTorch/CUDA port of ``ompi_tpu``.

A second package beside the JAX one: the single-process collective
stack (MCA vars and components, ops, the virtual-rank mesh, requests,
the algorithm library, the coll components and the communicator API)
in PyTorch, with the ring hop as hand-written CUDA kernels for Hopper
(``csrc/ring_hop.cu``).  It imports nothing of ``ompi_tpu`` and no JAX.

Entry points: :mod:`ompi_tpu_torch.api` (``init``/``Comm``) and
:mod:`ompi_tpu_torch.entry` (the fused DDP step and the dry run).
"""

__version__ = "0.1.0"
