"""The port's packaging: every source the kernel and library builds read
ships with the wheel, every JAX console script has a ``geopurify-torch-*``
twin that resolves to the port's ``main``, the ``torch`` extra names what
the port imports, the build directory falls back to the user cache where the
package's ``_build/`` cannot be written, and the modules of this slice
import without JAX."""

import fnmatch
import importlib
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from geopurify_tpu_torch import native
from geopurify_tpu_torch.utils import cuda_build

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "geopurify_tpu_torch"


@pytest.fixture(scope="module")
def project():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def _shipped(project, path: Path) -> bool:
    rel = path.relative_to(PKG).as_posix()
    return any(fnmatch.fnmatch(rel, pat)
               for pat in project["tool"]["setuptools"]["package-data"]["geopurify_tpu_torch"])


def test_every_source_and_local_include_ships(project):
    sources = [cuda_build.CSRC / f"{name}.cu" for name in cuda_build.SOURCES]
    sources += sorted(cuda_build.CSRC.glob("*.cuh")) + [native.SRC]
    assert native.SRC.exists() and len(sources) >= 4
    for src in sources:
        assert _shipped(project, src), f"{src} is not package data"
    includes = 0
    for src in sorted(cuda_build.CSRC.glob("*.cu*")):
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M):
            includes += 1
            target = src.parent / name
            assert target.exists(), f"{src.name} includes a missing {name}"
            assert _shipped(project, target), f"{src.name} includes {name}, not package data"
    assert includes >= 1


def test_every_jax_console_script_has_a_torch_twin(project):
    scripts = project["project"]["scripts"]
    jax_scripts = {k: v for k, v in scripts.items() if v.startswith("geopurify_tpu.")}
    assert len(jax_scripts) == 8
    for name, target in jax_scripts.items():
        twin = "geopurify-torch-" + name.removeprefix("geopurify-")
        assert twin in scripts, twin
        mod, fn = scripts[twin].split(":")
        assert mod == "geopurify_tpu_torch." + target.split(":")[0].removeprefix("geopurify_tpu.")
        assert callable(getattr(importlib.import_module(mod), fn))


def test_torch_extra_names_what_the_port_imports(project):
    extra = " ".join(project["project"]["optional-dependencies"]["torch"])
    for dep in ("torch", "numpy", "pyyaml", "scipy", "pillow"):
        assert dep in extra, dep
    base = " ".join(project["project"]["dependencies"])
    for dep in ("jax", "flax", "optax", "orbax-checkpoint", "scipy", "pillow"):
        assert dep in base, dep


def test_build_dir_is_the_package_build_when_writable(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "_build_dir", None)
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "_build")
    assert cuda_build.build_dir() == tmp_path / "_build"
    assert (tmp_path / "_build").is_dir()


def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path, caplog):
    blocker = tmp_path / "site-packages"
    blocker.write_text("a file where the package directory would be")
    monkeypatch.setattr(cuda_build, "_build_dir", None)
    monkeypatch.setattr(cuda_build, "BUILD", blocker / "_build")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    with caplog.at_level("WARNING", logger="geopurify.cuda_build"):
        d = cuda_build.build_dir()
    assert d == tmp_path / "cache" / "geopurify_tpu_torch" and d.is_dir()
    assert any(str(d) in r.getMessage() for r in caplog.records)
    # the libraries follow: the kernels' and the host library's
    assert cuda_build._lib_path("infonce").parent == d
    assert native.library_path().parent == d
    # no XDG_CACHE_HOME: ~/.cache
    monkeypatch.setattr(cuda_build, "_build_dir", None)
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cuda_build.build_dir() == tmp_path / "home" / ".cache" / "geopurify_tpu_torch"
    # neither writable: the build raises
    monkeypatch.setattr(cuda_build, "_build_dir", None)
    monkeypatch.setenv("HOME", str(blocker))
    with pytest.raises(RuntimeError, match="no writable build directory"):
        cuda_build.build_dir()


def test_slice_modules_import_without_jax_and_default_to_cuda():
    mods = ("data.preprocess", "native", "ops.voxelize", "data.mappers", "data.registry",
            "data.registry_catalog", "run.parity", "utils.visualization", "utils.profiling",
            "parity.compare", "parity.oracle", "parity.shims", "parity.sonata_oracle")
    code = (
        "import importlib, sys, inspect\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('geopurify_tpu_torch.' + m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'geopurify_tpu'))\n"
        "assert not bad, bad\n"
        "from geopurify_tpu_torch.run import parity\n"
        "print(inspect.signature(parity.run_torch_oracle).parameters['device'].default)\n"
        "print(inspect.signature(parity.run_ours).parameters['device'].default)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["cuda", "cuda"]
