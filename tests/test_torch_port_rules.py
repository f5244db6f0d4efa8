"""Rules the port keeps: it imports neither JAX nor the JAX package, its
clock reads go through ``repro_torch.obs.timer``, and it builds no kernel
and imports no ``triton`` when a module is imported."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _py_files():
    out = []
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out) + [os.path.join(ROOT, "chip_smoke.py")]


def _modules():
    mods = []
    for path in _py_files()[:-1]:
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
        mod = rel.replace(os.sep, ".")
        mods.append(mod[:-len(".__init__")] if mod.endswith("__init__")
                    else mod)
    return mods


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib', 'triton'))\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= len(_modules())


IMPORT_JAX = re.compile(r"^\s*(import\s+(jax|jaxlib)\b|from\s+(jax|jaxlib)\b"
                        r"|import\s+repro\b(?!_)|from\s+repro(\.|\s)"
                        r"|import\s+triton\b|from\s+triton\b)")


@pytest.mark.parametrize("path", _py_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import_in_source(path):
    with open(path, encoding="utf-8") as f:
        bad = [(i, line.rstrip()) for i, line in enumerate(f, 1)
               if IMPORT_JAX.match(line)]
    assert not bad, bad


RAW_CLOCK = re.compile(r"\btime\.(time|perf_counter|perf_counter_ns|monotonic"
                       r"|monotonic_ns|process_time|sleep)\s*\(")


def test_only_obs_timer_reads_the_clock():
    allowed = os.path.join(PKG, "obs", "timer.py")
    hits = []
    for path in _py_files():
        if path == allowed:
            continue
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if RAW_CLOCK.search(line) and not line.lstrip().startswith(
                        "#"):
                    hits.append((os.path.relpath(path, ROOT), i))
    assert not hits, hits


def test_kernel_sources_are_in_the_package():
    from repro_torch.kernels import _build

    for name in _build.ENTRY_POINTS:
        src = _build.CSRC / f"{name}.cu"
        assert src.is_file()
        assert "extern \"C\" int " + _build.ENTRY_POINTS[name][0] in \
            src.read_text()


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result;
    copied alone into an empty directory it fails too."""
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if script != os.path.join(ROOT, "chip_smoke.py"):
            with open(os.path.join(ROOT, "chip_smoke.py")) as f:
                (tmp_path / "chip_smoke.py").write_text(f.read())
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
