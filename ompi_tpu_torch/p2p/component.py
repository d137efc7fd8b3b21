"""``pml/eager`` MCA component — the matching-engine provider.

Port of ``ompi_tpu/p2p/component.py``: one pml is selected per job
(``Framework.select_one``); ``monitoring`` and ``vprotocol`` outbid it
when enabled and stack over the engine it builds.
"""

from __future__ import annotations

from ompi_tpu_torch.core.registry import Component, register_component

from .pml import MatchingEngine


@register_component
class EagerPmlComponent(Component):
    FRAMEWORK = "pml"
    NAME = "eager"
    PRIORITY = 50

    def register_params(self, store) -> None:
        super().register_params(store)
        store.register(
            "pml", "eager", "max_pending", 1 << 20, type="int",
            help="Soft cap on unexpected-queue length before warnings",
        )

    def make_engine(self, comm_size: int, comm_name: str = "?") -> MatchingEngine:
        return MatchingEngine(comm_size)
