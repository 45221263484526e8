"""Platform plumbing: where the compile cache goes, that every module is
plain JAX with no backend gate, and (on a machine with an NVIDIA GPU) the
bring-up run itself."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys
import time

import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import jax, jax.numpy as jnp
import qb3_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + {nonce})(jnp.arange(8)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _cache_probe(env):
    """Compile one fresh function in a child process; return the cache
    directory it reports."""
    env = {k: v for k, v in env.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    code = _PROBE.format(nonce=time.time_ns() % 1_000_003)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def _files(d):
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def test_cache_follows_variable(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    assert _cache_probe(env) == str(tmp_path / "cc")
    assert _files(tmp_path / "cc"), "nothing cached where the variable says"


def test_cache_defaults_to_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    cache = ROOT / ".jax_cache"
    before = _files(cache)
    assert _cache_probe(env) == str(cache)
    assert _files(cache) - before, "nothing cached in <checkout>/.jax_cache"


# an import of an accelerator-specific Pallas dialect, and a branch on
# the backend's name
_ACCEL_DIALECT = re.compile(r"pallas\.tp[u]")
_BACKEND_GATE = re.compile(r"default_backend\(\)\s*[!=]=")


def test_plain_xla_only():
    for path in sorted((ROOT / "qb3_tpu").rglob("*.py")):
        src = path.read_text()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert not any(_ACCEL_DIALECT.search(n) for n in names), path
        assert not _BACKEND_GATE.search(src), path


@pytest.fixture
def gpu():
    """Skip unless JAX finds an NVIDIA GPU.  Asked in a child process:
    this test process is pinned to the CPU (conftest.py)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if r.stdout.strip() != "gpu":
        pytest.skip("no GPU visible to JAX")
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       env=gpu, cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert '"ok": true' in r.stdout.strip().splitlines()[-1]
