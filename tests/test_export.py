"""jax.export engine artifact round-trip."""

import dataclasses

import numpy as np
import pytest

from openpose_plus import export as E
from openpose_plus.config import default_config
from openpose_plus.engine import Engine


def test_export_roundtrip(tmp_path, rng):
    cfg = default_config("vggtiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    path = str(tmp_path / "artifact")
    E.save_engine(eng, path, batch_size=2)

    loaded = E.load_engine(path)
    assert loaded.manifest["model"] == "vggtiny"
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    a = eng.infer(images)
    b = loaded.infer(images)
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_allclose(np.asarray(a.coords), np.asarray(b.coords),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.score), np.asarray(b.score),
                               atol=1e-5)


@pytest.mark.slow
def test_export_s2d2_layout_roundtrip(tmp_path, rng):
    """Artifacts can bake the space-to-depth-squared input signature; the
    loaded engine then consumes exactly what the host loader emits."""
    from openpose_plus.models.common import space_to_depth

    import jax.numpy as jnp

    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    path = str(tmp_path / "artifact_s2d2")
    E.save_engine(eng, path, batch_size=2, input_layout="s2d2")
    loaded = E.load_engine(path)
    assert loaded.manifest["input_layout"] == "s2d2"
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    images_q2 = np.asarray(space_to_depth(space_to_depth(
        jnp.asarray(images))))
    a = eng.infer(images)
    b = loaded.infer(images_q2)
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_allclose(np.asarray(a.coords), np.asarray(b.coords),
                               atol=1e-5)


def test_export_rejects_unsupported_layout(tmp_path):
    import pytest

    cfg = default_config("vggtiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    with pytest.raises(ValueError, match="not supported"):
        E.save_engine(eng, str(tmp_path / "x"), batch_size=1,
                      input_layout="s2d2")  # VGG stems are level-1 only
    cfg_odd = cfg.replace(model=dataclasses.replace(cfg.model, hin=63))
    with pytest.raises(ValueError, match="not supported"):
        E.save_engine(Engine(cfg_odd), str(tmp_path / "y"), batch_size=1,
                      input_layout="s2d")


@pytest.mark.slow
def test_exported_s2d2_artifact_accepts_plain_images(tmp_path, rng):
    """ExportedEngine permutes plain images to the baked layout on the
    host — the deploy-the-artifact workflow never needs layout code."""
    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    path = str(tmp_path / "a2")
    E.save_engine(eng, path, batch_size=2, input_layout="s2d2")
    loaded = E.load_engine(path)
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    a = eng.infer(images)
    b = loaded.infer(images)  # plain in, permuted internally
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_allclose(np.asarray(a.coords), np.asarray(b.coords),
                               atol=1e-5)


def test_export_needs_no_flatbuffers(tmp_path, rng, monkeypatch):
    """GPU hosts need not have `flatbuffers` (jax.export's own
    serializer): the artifact is the module bytes plus a manifest
    signature, and loading rebuilds the Exported from them."""
    import sys

    monkeypatch.setitem(sys.modules, "flatbuffers", None)
    monkeypatch.setitem(sys.modules, "jax._src.export.serialization", None)
    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=32, win=48, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    path = str(tmp_path / "artifact")
    E.save_engine(eng, path, batch_size=2)
    loaded = E.load_engine(path)
    sig = loaded.manifest["signature"]
    assert sig["in_avals"] == [[[2, 32, 48, 3], "uint8"]]
    assert loaded.manifest["jaxlib_version"]
    images = rng.integers(0, 255, (2, 32, 48, 3), dtype=np.uint8)
    a, b = eng.infer(images), loaded.infer(images)
    for f in E._OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


@pytest.mark.parametrize("triton", [True, False])
def test_load_checks_jaxlib_only_for_triton_artifacts(tmp_path, triton):
    """An artifact that carries the Triton custom call is tied to the
    jaxlib that built it; one without it loads under any jaxlib."""
    import json

    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=32, win=48, n_stages=2, compute_dtype="float32"))
    path = str(tmp_path / "artifact")
    E.save_engine(Engine(cfg), path, batch_size=1)
    manifest_path = tmp_path / "artifact" / "manifest.json"
    manifest = json.loads(manifest_path.read_text())
    assert manifest["triton_call"] is False   # lowered for the CPU
    manifest.update(triton_call=triton, jaxlib_version="0.0.0")
    manifest_path.write_text(json.dumps(manifest))
    if triton:
        with pytest.raises(RuntimeError, match="jaxlib 0.0.0"):
            E.load_engine(path)
    else:
        assert E.load_engine(path).manifest["jaxlib_version"] == "0.0.0"
