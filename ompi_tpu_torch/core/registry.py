"""MCA component architecture — own copy of ``ompi_tpu/core/registry.py``.

Frameworks hold competing components; the framework-level selection var
(``--mca coll cuda,basic``, ``--mca coll ^cuda``) filters them; each
component registers ``<fw>_<comp>_priority``; frameworks either pick one
winner (``select_one``) or stack many (``selectable``, coll-style).
"""

from __future__ import annotations

from typing import Iterable, Type

from .var import (
    VarStore,
    register_device_vars,
    register_observability_vars,
    register_robustness_vars,
    register_schedule_vars,
    register_serving_vars,
    register_transport_vars,
)


class ComponentError(Exception):
    pass


class SelectionError(ComponentError):
    """An include list names no usable component."""


class Component:
    """Base class for all MCA components."""

    FRAMEWORK: str = ""
    NAME: str = ""
    PRIORITY: int = 0
    VERSION = (1, 0, 0)

    def __init__(self) -> None:
        self.priority: int = self.PRIORITY
        self.opened: bool = False

    def register_params(self, store: VarStore) -> None:
        """Register this component's MCA vars (always ``priority``)."""
        var = store.register(
            self.FRAMEWORK,
            self.NAME,
            "priority",
            self.PRIORITY,
            type="int",
            help=f"Selection priority of the {self.FRAMEWORK}/{self.NAME} component",
        )
        self.priority = var.value

    def open(self, store: VarStore) -> bool:
        """True if the component is usable in this process."""
        return True

    def close(self) -> None:
        pass

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{self.FRAMEWORK}/{self.NAME} prio={self.priority}>"


def parse_selection(value: str | None) -> tuple[bool, list[str]]:
    """Parse a framework selection string → (is_exclude, names)."""
    if not value:
        return True, []
    value = value.strip()
    exclude = value.startswith("^")
    if exclude:
        value = value[1:]
    names = [n.strip() for n in value.split(",") if n.strip()]
    for n in names:
        if n.startswith("^"):
            raise ComponentError(
                f"selection list may not mix include and exclude: {value!r}"
            )
    return exclude, names


class Framework:
    """One MCA framework: a named slot holding competing components."""

    def __init__(self, name: str, store: VarStore, description: str = ""):
        self.name = name
        self.description = description
        self.store = store
        self._component_classes: dict[str, Type[Component]] = {}
        self.components: dict[str, Component] = {}
        self._opened = False

    def add_component_class(self, cls: Type[Component]) -> None:
        if cls.FRAMEWORK != self.name:
            raise ComponentError(
                f"component {cls.NAME} declares framework {cls.FRAMEWORK!r}, "
                f"registered into {self.name!r}"
            )
        self._component_classes[cls.NAME] = cls

    @property
    def known_component_names(self) -> list[str]:
        return sorted(self._component_classes)

    def open(self) -> None:
        """Apply the selection var, register params, open survivors."""
        if self._opened:
            return
        self._opened = True
        raw = self.store.lookup_unregistered(self.name)
        self.store.register(
            self.name, "", "", raw if raw is not None else "", type="string",
            help=f"Component selection list for the {self.name} framework "
            f'("a,b" include list, "^a,b" exclude list)',
        )
        from . import output as _output

        _output.register_verbose_var(self.store, self.name)
        exclude, names = parse_selection(raw)
        requested = [
            c for c in sorted(self._component_classes)
            if (c not in names if exclude else c in names)
        ]
        if not exclude and not requested and names:
            raise SelectionError(
                f"--mca {self.name} {','.join(names)}: no such component "
                f"(known: {', '.join(self.known_component_names) or 'none'})"
            )
        for comp_name in requested:
            comp = self._component_classes[comp_name]()
            comp.register_params(self.store)
            if comp.open(self.store):
                comp.opened = True
                self.components[comp_name] = comp
            else:
                comp.close()
        if not exclude and names and not self.components:
            raise SelectionError(
                f"--mca {self.name} {','.join(names)}: requested component(s) "
                f"found but not usable in this process"
            )

    def selectable(self) -> list[Component]:
        """Opened components ordered by priority desc, name asc."""
        self.open()
        return sorted(
            self.components.values(), key=lambda c: (-c.priority, c.NAME)
        )

    def select_one(self) -> Component:
        mods = self.selectable()
        if not mods:
            raise SelectionError(f"no usable component in framework {self.name!r}")
        return mods[0]

    def close(self) -> None:
        for comp in self.components.values():
            comp.close()
        self.components.clear()
        self._opened = False


class MCAContext:
    """Top-level MCA state: the var store plus all frameworks."""

    #: every known component class, filled by @register_component
    _global_component_classes: list[Type[Component]] = []

    def __init__(
        self,
        cmdline: dict[str, str] | None = None,
        env: dict[str, str] | None = None,
        param_files: Iterable[str] | None = None,
    ):
        self.store = VarStore(cmdline=cmdline, env=env, param_files=param_files)
        register_device_vars(self.store)
        register_observability_vars(self.store)
        register_robustness_vars(self.store)
        register_schedule_vars(self.store)
        register_serving_vars(self.store)
        register_transport_vars(self.store)
        self.frameworks: dict[str, Framework] = {}
        self.refresh_components()

    def framework(self, name: str, description: str = "") -> Framework:
        fw = self.frameworks.get(name)
        if fw is None:
            fw = Framework(name, self.store, description)
            self.frameworks[name] = fw
        return fw

    def refresh_components(self) -> None:
        """Pick up component classes registered after this context was
        built (import-order independence)."""
        for cls in MCAContext._global_component_classes:
            fw = self.framework(cls.FRAMEWORK)
            if cls.NAME not in fw._component_classes:
                fw.add_component_class(cls)

    def open_all(self) -> None:
        self.refresh_components()
        for fw in self.frameworks.values():
            fw.open()

    def close_all(self) -> None:
        for fw in self.frameworks.values():
            fw.close()


def register_component(cls: Type[Component]) -> Type[Component]:
    """Class decorator: make a Component class known to every context."""
    if not cls.FRAMEWORK or not cls.NAME:
        raise ComponentError(f"{cls.__name__} must set FRAMEWORK and NAME")
    MCAContext._global_component_classes[:] = [
        c for c in MCAContext._global_component_classes
        if not (c.FRAMEWORK == cls.FRAMEWORK and c.NAME == cls.NAME)
    ]
    MCAContext._global_component_classes.append(cls)
    return cls

