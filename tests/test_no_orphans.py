"""Every module in the package must have an importer (or be a known entry
point) — dead kernels rot."""
import os
import re

import pytest

PKG = os.path.join(os.path.dirname(__file__), "..", "plasticinelab_tpu")

# modules legitimately reached from outside the package (CLI entry points,
# driver hooks) rather than by intra-package imports
ENTRY_POINTS = {
    "algorithms.solve",
}


def _modules():
    out = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py") or f == "__init__.py":
                continue
            rel = os.path.relpath(os.path.join(root, f), PKG)
            out.append(rel[:-3].replace(os.sep, "."))
    return sorted(out)


def test_no_orphan_modules():
    sources = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    sources.append(fh.read())
    # tests/tools/benchmarks also count as importers
    for extra in ("tests", "tools", "benchmarks"):
        d = os.path.join(os.path.dirname(PKG), extra)
        if not os.path.isdir(d):
            continue
        for root, _, files in os.walk(d):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(root, f)) as fh:
                        sources.append(fh.read())
    blob = "\n".join(sources)

    orphans = []
    for mod in _modules():
        if mod in ENTRY_POINTS:
            continue
        leaf = mod.rsplit(".", 1)[-1]
        # an import of the module by its leaf name anywhere counts
        pat = re.compile(
            r"(?:from\s+[\w.]*\.?%s\s+import|import\s+[\w.]*\b%s\b|"
            r"from\s+[\w.]+\s+import\s+[^\n]*\b%s\b)" % (leaf, leaf, leaf)
        )
        if not pat.search(blob):
            orphans.append(mod)
    assert not orphans, f"orphan modules (no importer anywhere): {orphans}"
