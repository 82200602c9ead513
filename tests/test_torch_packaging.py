"""Packaging of dampr_tpu_torch: an installed port must carry every
subpackage it imports and every C++/CUDA source it compiles on first use.

``pyproject.toml`` is read with ``tomllib``, as ``tests/test_packaging.py``
reads it for the JAX package: every directory under ``dampr_tpu_torch/``
with an ``__init__.py`` is listed in ``[tool.setuptools] packages``, every
``.cpp``/``.cu``/``.cuh`` under it matches a package-data glob of its
package, and ``torch`` is named (as an optional extra, so installing the
JAX package alone does not pull it in).
"""

import fnmatch
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dampr_tpu_torch")
SOURCES = (".cpp", ".cu", ".cuh")


@pytest.fixture(scope="module")
def meta():
    tomllib = pytest.importorskip("tomllib")
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def _walk(root):
    for d, dirs, files in os.walk(root):
        # build outputs are not sources
        dirs[:] = [x for x in dirs if not x.startswith(("_build", "__"))]
        yield d, files


def _package_dirs():
    return sorted(
        os.path.relpath(d, ROOT).replace(os.sep, ".")
        for d, files in _walk(PKG) if "__init__.py" in files)


def _source_files():
    return sorted(
        os.path.relpath(os.path.join(d, f), ROOT)
        for d, files in _walk(PKG) for f in files if f.endswith(SOURCES))


def test_the_tree_has_what_the_checks_read():
    pkgs = _package_dirs()
    assert "dampr_tpu_torch.analyze" in pkgs
    assert "dampr_tpu_torch.serve" in pkgs
    srcs = _source_files()
    assert os.path.join("dampr_tpu_torch", "native", "tokenizer.cpp") in srcs
    assert any(s.endswith(".cu") for s in srcs)
    assert any(s.endswith(".cuh") for s in srcs)


@pytest.mark.parametrize("pkg", _package_dirs())
def test_every_subpackage_is_listed(meta, pkg):
    assert pkg in meta["tool"]["setuptools"]["packages"], pkg


@pytest.mark.parametrize("path", _source_files())
def test_every_native_source_ships(meta, path):
    data = meta["tool"]["setuptools"].get("package-data", {})
    pkg = os.path.dirname(path).replace(os.sep, ".")
    globs = data.get(pkg, [])
    assert any(fnmatch.fnmatch(os.path.basename(path), g) for g in globs), \
        (path, globs)


def test_torch_is_named_as_an_extra(meta):
    project = meta["project"]
    deps = list(project.get("dependencies", []))
    for extra in project.get("optional-dependencies", {}).values():
        deps.extend(extra)
    assert any(d.split("[")[0].split("=")[0].split(">")[0].split("<")[0]
               .strip() == "torch" for d in deps), deps
    # the JAX package installs without it
    assert "torch" not in [d.strip() for d in project["dependencies"]]
