"""True multi-process distributed training smoke (kungfu-run analogue):
2 localhost processes, one global 8-device mesh, identical losses."""

import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_multiprocess_training_smoke():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "scripts", "multiprocess_smoke.py")
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, script, "--port", "12579"], env=env, cwd=repo,
        capture_output=True, timeout=580)
    text = out.stdout.decode() + out.stderr.decode()
    assert out.returncode == 0, text
    assert "MULTIPROCESS OK" in text
