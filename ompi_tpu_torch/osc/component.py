"""``osc/arena`` MCA component — the window factory.

Port of ``ompi_tpu/osc/component.py``: one component serves every
window flavor; the framework stays pluggable so a component with real
remote stores (NVLink peer memory) can outbid it.
"""

from __future__ import annotations

from ompi_tpu_torch.core.registry import Component, register_component

from .win import Win


@register_component
class ArenaOscComponent(Component):
    FRAMEWORK = "osc"
    NAME = "arena"
    PRIORITY = 50

    def register_params(self, store) -> None:
        super().register_params(store)
        store.register(
            "osc", "arena", "max_pending", 1 << 20, type="int",
            help="Soft cap on queued RMA descriptors per window",
        )

    # one factory method per MPI window constructor
    def win_create(self, comm, bases, name=""):
        return Win.create(comm, bases, name=name)

    def win_allocate(self, comm, size, dtype, name=""):
        return Win.allocate(comm, size, dtype, name=name)

    def win_allocate_shared(self, comm, size, dtype, name=""):
        return Win.allocate_shared(comm, size, dtype, name=name)

    def win_create_dynamic(self, comm, dtype, name=""):
        return Win.create_dynamic(comm, dtype, name=name)
