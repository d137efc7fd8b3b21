"""Boot layer: rendezvous + launch (≈ PMIx + PRRTE subset, SURVEY.md §2.4)."""

from .kvs import KVSClient, KVSServer  # noqa: F401
from .proc import ProcContext, launched_by_tpurun  # noqa: F401
