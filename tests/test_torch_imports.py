"""whisper_tpu_torch imports neither JAX nor whisper_tpu, directly or not:
the card it runs on has no JAX."""

import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import whisper_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            whisper_tpu_torch.__path__, "whisper_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith(("jax.", "jaxlib"))
                     or k == "whisper_tpu" or k.startswith("whisper_tpu."))
        print(len(names), bad)
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 17, proc.stdout
