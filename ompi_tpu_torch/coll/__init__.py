"""Collective framework: importing it registers the coll components
(``cuda``, ``tuned``, ``sync`` and ``basic``; ``monitoring`` registers
from :mod:`ompi_tpu_torch.tool.monitoring`)."""

from . import basic, cuda, sync, tuned  # noqa: F401  (component registration)
