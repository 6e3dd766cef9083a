"""Hierarchical config + command-line overrides.

Port of ``hpdg_tpu.utils.config`` (the reference's Dune::ParameterTree
command-line glue): ``--key=value``, ``--key value`` and
boolean ``--flag`` forms populate a dotted-key tree; ``--help`` prints a
message and exits.  Values are parsed into int/float/bool when possible.
"""

from __future__ import annotations

import sys


class ParameterTree(dict):
    """Nested dict with dotted-path get/set and typed access."""

    def set(self, key: str, value):
        node = self
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, ParameterTree())
        node[parts[-1]] = value

    def get_path(self, key: str, default=None):
        node = self
        for p in key.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node

    def sub(self, key: str) -> "ParameterTree":
        v = self.get_path(key)
        return v if isinstance(v, ParameterTree) else ParameterTree()


def _convert(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "yes", "on"):
        return True
    if s.lower() in ("false", "no", "off"):
        return False
    return s


def parse_cli(argv=None, tree: ParameterTree | None = None,
              help_text: str | None = None) -> ParameterTree:
    """Parse ``argv`` into ``tree`` (insertKeysFromCommandLine analog)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    tree = tree if tree is not None else ParameterTree()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--help", "-h"):
            print(help_text or "usage: --key=value | --key value | --flag")
            sys.exit(0)
        if not arg.startswith("--"):
            raise ValueError(f"unexpected positional argument {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            tree.set(key, _convert(val))
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            tree.set(key, _convert(argv[i + 1]))
            i += 1
        else:
            tree.set(key, True)  # bare flag
        i += 1
    return tree
