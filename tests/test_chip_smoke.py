"""chip_smoke.py: its refusal without a GPU, its comparison functions at
small shapes on the CPU, and the full checks on the card (`-m chip`)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from openpose_plus.config import PostprocConfig  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("k", [16, 32])
def test_kernel_check_interpret(k):
    r = cs.kernel_check(k, m=32, batch=2, seed=k, interpret=True)
    assert r["connections"] > 0 and r["humans"] > 0


def test_oracle_check_on_decoder_scenes():
    """The crowd scene fills K=16 for at least one part."""
    conf, paf = cs.decoder_scenes(46, 82, 4, seed=0)
    cfg = PostprocConfig()
    counts = cs.oracle_check(conf, paf, cfg)
    assert len(counts) == 4 and counts[0] >= cfg.max_peaks


def test_match_humans_rejects_a_moved_part():
    conf, paf = cs.decoder_scenes(46, 82, 1, seed=0)
    batch = cs.decode.build_decoder(PostprocConfig())(conf, paf)
    got = cs._device_humans(batch, 0)
    cs.match_humans(got, got)
    parts, score, n = got[0]
    p = next(iter(parts))
    moved = {**parts, p: (parts[p][0] + 0.01,) + parts[p][1:]}
    with pytest.raises(cs.SmokeFailure):
        cs.match_humans(got, [(moved, score, n)] + got[1:])


def test_cnn_error_small():
    cs_cfg = cs.model_config("vggtiny", hin=32, win=48, n_stages=2)
    eng = cs.Engine(cs_cfg)
    err = cs.cnn_error(cs_cfg, eng.params, cs.frames(cs_cfg, 2, 0))
    assert 0 < err <= cs.CNN_TOL


def test_same_skeletons_rejects_empty_tables():
    conf, paf = cs.decoder_scenes(46, 82, 1, seed=0)
    dec = cs.decode.build_decoder(PostprocConfig())
    assert cs.same_skeletons(dec(conf, paf), dec(conf, paf)) > 0
    empty = dec(0 * conf, 0 * paf)
    with pytest.raises(cs.SmokeFailure, match="no humans"):
        cs.same_skeletons(empty, empty)


def test_random_weight_engine_layouts_and_export_are_not_empty():
    """With random weights the random-weight decoder finds people, the
    two input layouts give bit-equal maps, and the exported artifact
    reproduces the skeletons."""
    cfg = cs.model_config("mobilenet_thin", hin=64, win=96,
                          n_stages=2).replace(
        postproc=cs.RANDOM_WEIGHT_DECODER)
    eng = cs.Engine(cfg)
    images = cs.frames(cfg, 2, 0)
    packed = cs.to_layout(images, cfg.model.preferred_input_layout())
    cs.same_maps(eng.forward(packed), eng.forward(images))
    out = eng.infer(images)
    assert cs.same_skeletons(eng.infer(packed), out) > 0
    manifest, n, share = cs.export_check(eng, images, out)
    assert n > 0 and manifest["triton_call"] is False and share == 1.0


def test_well_formed_rejects_a_miscounted_human():
    import dataclasses

    conf, paf = cs.decoder_scenes(46, 82, 2, seed=0)
    cfg = PostprocConfig()
    batch = cs.decode.build_decoder(cfg)(conf, paf)
    cs.well_formed(batch, cfg)
    bad = dataclasses.replace(batch, n_parts=batch.n_parts * 0 + 1)
    with pytest.raises(cs.SmokeFailure, match="n_parts"):
        cs.well_formed(bad, cfg)
    assert cs.shared_humans(batch, batch) == 1.0


def test_gradient_comparisons():
    import jax.numpy as jnp
    import optax

    g = {"a": jnp.arange(1.0, 5.0), "b": jnp.ones(3)}
    tx = optax.adam(1e-3)
    _, st = tx.update(g, tx.init(g), g)
    mu = cs.adam_mu(st)
    assert cs.worst_leaf_rel(mu, {k: 0.1 * v for k, v in g.items()}) < 1e-6
    off = {"a": g["a"], "b": 0.25 * g["b"]}
    assert cs.worst_leaf_rel(off, g) == pytest.approx(0.75)
    assert 0 < cs.tree_rel(off, g) < 0.75
    with pytest.raises(cs.SmokeFailure, match="one Adam state"):
        cs.adam_mu(optax.sgd(1e-3).init(g))


# ------------------------------------------------------------ on the card --

@pytest.mark.chip
@pytest.mark.parametrize("k", [16, 32])
def test_kernels_bit_exact_on_gpu(gpu, k):
    cs.kernel_check(k, m=32, batch=cs.BATCH, seed=0)


@pytest.mark.chip
def test_decoder_matches_oracle_on_gpu(gpu):
    conf, paf = cs.decoder_scenes(46, 82, cs.BATCH, seed=0)
    cs.oracle_check(conf, paf, PostprocConfig())
    cs.oracle_check(conf, paf, PostprocConfig().fidelity())


@pytest.mark.chip
def test_quality_preset_matches_cpu_on_gpu(gpu):
    conf, paf = cs.decoder_scenes(46, 82, cs.BATCH, seed=1)
    cs.cpu_check(conf, paf, PostprocConfig().quality())


@pytest.mark.chip
def test_mobilenet_maps_match_reference_on_gpu(gpu):
    cfg = cs.model_config("mobilenet_thin")
    eng = cs.Engine(cfg)
    assert cs.cnn_error(cfg, eng.params,
                        cs.frames(cfg, cs.BATCH, 0)) <= cs.CNN_TOL
