"""Plugin loading: external modules extend the engine without edits.

The counterpart of ``presto_tpu/plugin.py`` (the reference's plugin
system, presto-spi/.../spi/Plugin.java:33-78, getConnectorFactories,
getFunctions, getEventListenerFactories, loaded by
server/PluginManager.java:121 loadPlugins / installPlugin:165). Each
plugin is an importable module (or a file or package in a plugin
directory added to ``sys.path``), named by ``plugin.modules`` /
``plugin.dir`` in etc/config.properties or installed programmatically.

A plugin writes its connectors and functions against this package's
``Batch`` and ``expr.functions.Val``, which hold torch tensors: a
function receives its arguments as ``Val``s on the query's device and
returns one, like every builtin. A plugin written for ``presto_tpu``
(jnp arrays) does not load here.

A plugin module exposes its contributions one of three ways (checked in
order):

1. a module-level ``PLUGIN`` object,
2. a module-level ``get_plugin()`` factory,
3. module-level ``Plugin`` subclasses (instantiated with no args).
"""
from __future__ import annotations

import importlib
import os
import sys
from typing import Callable, Iterable, List, Optional, Tuple


class Plugin:
    """Contribution surface (reference spi/Plugin.java).

    Subclasses override any subset; every getter returns an iterable.
    """

    def get_connector_factories(self) -> Iterable[Tuple[str, Callable]]:
        """[(connector.name value, factory(props) -> Connector), ...]"""
        return ()

    def get_scalar_functions(self) -> Iterable[Tuple[str, Callable,
                                                     Callable]]:
        """[(name, impl(args, out_type) -> Val,
            infer(arg_types) -> Type), ...]"""
        return ()

    def get_event_listeners(self) -> Iterable[Callable]:
        """[listener factories invoked with no args, ...]"""
        return ()


class PluginManager:
    """Discovers and installs plugins (reference
    server/PluginManager.java:121)."""

    def __init__(self):
        self.installed: List[str] = []

    def load_module(self, module_name: str) -> List[Plugin]:
        mod = importlib.import_module(module_name)
        plugins = self._discover(mod)
        if not plugins:
            raise ValueError(
                f"module {module_name!r} exposes no plugin (expected "
                "PLUGIN, get_plugin(), or a Plugin subclass)")
        for p in plugins:
            self.install(p, origin=module_name)
        return plugins

    def load_dir(self, plugin_dir: str) -> List[Plugin]:
        """Each subdirectory (or .py file) of ``plugin_dir`` is one
        plugin module — the etc/plugin/ drop-in layout of the reference's
        plugin/ directory of jars."""
        out: List[Plugin] = []
        if not os.path.isdir(plugin_dir):
            return out
        if plugin_dir not in sys.path:
            sys.path.insert(0, plugin_dir)
        for entry in sorted(os.listdir(plugin_dir)):
            path = os.path.join(plugin_dir, entry)
            if entry.endswith(".py") and not entry.startswith("_"):
                out.extend(self.load_module(entry[:-3]))
            elif os.path.isdir(path) and os.path.isfile(
                    os.path.join(path, "__init__.py")):
                out.extend(self.load_module(entry))
        return out

    @staticmethod
    def _discover(mod) -> List[Plugin]:
        if hasattr(mod, "PLUGIN"):
            return [mod.PLUGIN]
        if hasattr(mod, "get_plugin"):
            return [mod.get_plugin()]
        found = []
        for v in vars(mod).values():
            if (isinstance(v, type) and issubclass(v, Plugin)
                    and v is not Plugin):
                found.append(v())
        return found

    def install(self, plugin: Plugin, origin: str = "<direct>") -> None:
        """Register every contribution (reference installPlugin:165)."""
        from .config import register_connector_factory
        from .expr.functions import register_external
        for name, factory in plugin.get_connector_factories():
            register_connector_factory(name, factory)
        for name, impl, infer in plugin.get_scalar_functions():
            register_external(name, impl, infer)
        self.installed.append(
            f"{origin}:{type(plugin).__name__}")


GLOBAL = PluginManager()


def load_plugins_from_config(props: dict) -> List[Plugin]:
    """Boot-time loading driven by etc/config.properties:
    ``plugin.modules=pkg1,pkg2`` and/or ``plugin.dir=etc/plugin``
    (reference PluginManager reads plugin.dir/plugin.bundles)."""
    out: List[Plugin] = []
    mods = props.get("plugin.modules", "")
    for m in [s.strip() for s in mods.split(",") if s.strip()]:
        out.extend(GLOBAL.load_module(m))
    pdir = props.get("plugin.dir")
    if pdir:
        out.extend(GLOBAL.load_dir(pdir))
    return out
