"""Guard against re-committing regenerable caches (r4 regression: 19 MB
of seeded bench photos landed in history; the .gitignore added later does
not untrack already-committed files). Seeded caches are regenerable by
construction — tracking them defeats their design."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Regenerable cache trees that must never be tracked.
FORBIDDEN_PREFIXES = (
    ".bench_photos/",
    ".jax_cache/",
    ".ap_bench/",
    "tests/.jax_cache_cpu/",
)
FORBIDDEN_SUFFIXES = (".npz", ".jpg", ".jpeg", ".png")
# Tracked binaries that are deliberate (docs assets etc.) go here.
ALLOWED = frozenset()


def _ls_files():
    try:
        out = subprocess.run(
            ["git", "ls-files"], cwd=REPO, capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("git unavailable")
    if out.returncode != 0:
        pytest.skip("not a git checkout")
    return out.stdout.splitlines()


def test_no_tracked_cache_files():
    files = _ls_files()
    bad = [f for f in files
           if f.startswith(FORBIDDEN_PREFIXES) and f not in ALLOWED]
    assert not bad, f"regenerable cache files are tracked: {bad[:10]}"


def test_no_tracked_binary_artifacts():
    """No weight dumps or image caches anywhere in the tree."""
    files = _ls_files()
    bad = [f for f in files
           if f.lower().endswith(FORBIDDEN_SUFFIXES) and f not in ALLOWED]
    assert not bad, f"binary artifacts are tracked: {bad[:10]}"


def test_main_path_imports_no_flax_orbax_or_mosaic_pallas():
    """Engine, the decoder, the models and the trainer import nothing
    outside jax, numpy, scipy, optax, chex, einops and the standard
    library (in a fresh interpreter, so other tests cannot mask it)."""
    import sys

    code = ("import sys; import openpose_plus.engine, openpose_plus.train, "
            "openpose_plus.postproc, openpose_plus.models; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('flax', 'orbax', 'cv2', 'torch', 'triton') or "
            "m.split('.')[:4] == ['jax', '_src', 'pallas', 'mosaic']]; "
            "print(sorted(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_file_imports_mosaic_pallas():
    """Pallas kernels here take the Triton route; nothing imports the
    Mosaic (non-GPU) Pallas module."""
    import re

    pattern = re.compile(r"pallas(\.| import )[t]pu\b")
    bad = []
    for f in _ls_files():
        if f.endswith(".py"):
            with open(os.path.join(REPO, f)) as fh:
                if pattern.search(fh.read()):
                    bad.append(f)
    assert not bad, bad
