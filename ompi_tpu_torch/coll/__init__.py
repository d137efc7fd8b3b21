"""Collective framework: importing it registers the coll components
(``cuda``, ``tuned``, ``sync``, ``basic`` and ``han``; ``monitoring``
registers from :mod:`ompi_tpu_torch.tool.monitoring`)."""

from . import basic, cuda, han, sync, tuned  # noqa: F401  (component registration)
