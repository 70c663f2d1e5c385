"""Model zoo shape/jit tests (the reference had only build-smoke tests;
SURVEY.md §4 — we additionally check stage counts, dtype policy, and jit)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpose_plus.config import ModelConfig
from openpose_plus.models import get_model, model_names


@pytest.mark.parametrize("name", ["vgg19", "vggtiny", "mobilenet_thin", "hao28"])
def test_model_shapes(name):
    # Small input keeps CPU compile fast; conv nets are resolution-agnostic.
    cfg = ModelConfig(name=name, hin=64, win=96, n_stages=3,
                      compute_dtype="float32")
    model = get_model(cfg)
    x = jnp.zeros((2, cfg.hin, cfg.win, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x)
    out = jax.jit(model.apply)(params, x)
    assert len(out["conf"]) == cfg.n_stages
    assert len(out["paf"]) == cfg.n_stages
    for c, p in zip(out["conf"], out["paf"]):
        assert c.shape == (2, cfg.hout, cfg.wout, cfg.n_heatmaps)
        assert p.shape == (2, cfg.hout, cfg.wout, cfg.n_pafs)
        assert c.dtype == jnp.float32


def test_bf16_compute_f32_params_and_outputs():
    cfg = ModelConfig(name="vggtiny", hin=64, win=64, n_stages=2,
                      compute_dtype="bfloat16")
    model = get_model(cfg)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x)
    leaves = jax.tree_util.tree_leaves(params)
    assert all(l.dtype == jnp.float32 for l in leaves)
    out = model.apply(params, x)
    # final per-stage predictions are float32 for the decoder
    assert out["conf"][-1].dtype == jnp.float32
    assert out["paf"][-1].dtype == jnp.float32


def test_registry_aliases_and_errors():
    assert set(model_names()) >= {"vgg19", "vggtiny", "mobilenet_thin",
                                  "hao28", "vgg", "mobilenet"}
    with pytest.raises(ValueError, match="unknown model"):
        get_model(ModelConfig(name="nope"))


def test_deep_supervision_stages_differ():
    """Later stages must actually refine (different params -> different maps)."""
    cfg = ModelConfig(name="vggtiny", hin=64, win=64, n_stages=2,
                      compute_dtype="float32")
    model = get_model(cfg)
    x = jax.random.uniform(jax.random.PRNGKey(1), (1, 64, 64, 3))
    params = model.init(jax.random.PRNGKey(0), x)
    out = model.apply(params, x)
    assert not np.allclose(np.asarray(out["conf"][0]),
                           np.asarray(out["conf"][1]))


def test_stem_s2d_matches_plain_conv():
    """The space-to-depth stem lowering (common.StemConvRelu) is the SAME
    conv as the plain stride-2 ConvRelu — same params, same output — and
    the pre-transformed (B, H/2, W/2, 12) input layout agrees exactly with
    the plain (B, H, W, 3) one. f32 on CPU: bit-for-bit."""
    from openpose_plus.models.common import space_to_depth

    mk = lambda s2d: ModelConfig(name="mobilenet_thin", hin=64, win=96,
                                 n_stages=2, compute_dtype="float32",
                                 stem_s2d=s2d)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, 64, 96, 3)), jnp.float32)
    m_plain, m_s2d = get_model(mk(False)), get_model(mk(True))
    params = m_plain.init(jax.random.PRNGKey(0), x)
    # identical param trees: one checkpoint serves both lowerings
    params_s2d = m_s2d.init(jax.random.PRNGKey(0), x)
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(params_s2d))
    assert jax.tree.map(jnp.shape, params) == jax.tree.map(
        jnp.shape, params_s2d)
    ref = m_plain.apply(params, x)
    for got in (m_s2d.apply(params, x),
                m_s2d.apply(params, space_to_depth(x)),
                m_s2d.apply(params, space_to_depth(space_to_depth(x)))):
        np.testing.assert_allclose(np.asarray(got["conf"][-1]),
                                   np.asarray(ref["conf"][-1]), rtol=2e-5,
                                   atol=1e-5)


def test_stem_s2d_odd_dims_fall_back():
    cfg = ModelConfig(name="mobilenet_thin", hin=64, win=96, n_stages=2,
                      compute_dtype="float32", stem_s2d=True)
    model = get_model(cfg)
    x = jnp.zeros((1, 63, 95, 3), jnp.float32)  # odd: plain conv path
    params = model.init(jax.random.PRNGKey(0), x)
    model.apply(params, x)  # must trace without shape errors


@pytest.mark.slow
def test_stem_s2d_grads_match_plain_conv():
    """Training through the deep-s2d lowering must produce the SAME
    parameter gradients as the plain lowering (the rearranged kernels are
    linear in the original params, so autodiff scatters grads back
    exactly; f32 CPU)."""
    mk = lambda s2d: ModelConfig(name="mobilenet_thin", hin=64, win=96,
                                 n_stages=2, compute_dtype="float32",
                                 stem_s2d=s2d)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, 64, 96, 3)), jnp.float32)
    m_plain, m_s2d = get_model(mk(False)), get_model(mk(True))
    params = m_plain.init(jax.random.PRNGKey(1), x)

    def loss(model, p):
        out = model.apply(p, x)
        return (jnp.sum(out["conf"][-1] ** 2)
                + jnp.sum(out["paf"][-1] ** 2))

    g_plain = jax.grad(lambda p: loss(m_plain, p))(params)
    g_s2d = jax.grad(lambda p: loss(m_s2d, p))(params)
    flat_a = jax.tree_util.tree_leaves_with_path(g_plain)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(g_s2d))
    # Same param tree; grads equal up to f32 accumulation noise. The
    # noise is AMPLIFIED by downstream ReLU kinks (a ~1e-6 forward
    # difference can flip a mask bit), so the per-leaf normalized
    # tolerance is 5e-4 — a real rearrangement bug shows up as O(1).
    for path, ga in flat_a:
        gb = flat_b[path]
        scale = max(float(jnp.max(jnp.abs(ga))), 1e-6)
        np.testing.assert_allclose(np.asarray(gb) / scale,
                                   np.asarray(ga) / scale, atol=5e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", ["vggtiny", "hao28", "vgg19"])
def test_vgg_family_s2d_stem_matches_plain(name):
    """The VGG-family conv1 block on the space-to-depth grid (dense
    rearranged kernels + channel-max pool) equals the plain lowering,
    from both the plain and the (B, H/2, W/2, 12) input layouts."""
    from openpose_plus.models.common import space_to_depth

    mk = lambda s2d: ModelConfig(name=name, hin=64, win=96, n_stages=2,
                                 compute_dtype="float32", stem_s2d=s2d)
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        (2, 64, 96, 3)), jnp.float32)
    m_plain, m_s2d = get_model(mk(False)), get_model(mk(True))
    params = m_plain.init(jax.random.PRNGKey(0), x)
    assert (jax.tree_util.tree_structure(params) == jax.tree_util.
            tree_structure(m_s2d.init(jax.random.PRNGKey(0), x)))
    ref = m_plain.apply(params, x)
    for got in (m_s2d.apply(params, x),
                m_s2d.apply(params, space_to_depth(x))):
        np.testing.assert_allclose(np.asarray(got["conf"][-1]),
                                   np.asarray(ref["conf"][-1]), rtol=2e-5,
                                   atol=1e-5)


# ------------------------------------------------- recorded fixture -------
# tests/model_fixture.json was recorded from the Flax implementation of the
# model layer. The plain-JAX layer must keep its variable tree (a
# checkpoint format) and its forward numerics.

def _fixture():
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "model_fixture.json")
    with open(path) as f:
        return json.load(f)


def _fixture_cfg(fix, name, **kw):
    g = fix["geometry"]
    return ModelConfig(name=name, hin=g["hin"], win=g["win"],
                       n_stages=g["n_stages"], compute_dtype="float32", **kw)


def _path(p):
    return "/".join(str(getattr(k, "key", k)) for k in p)


@pytest.mark.parametrize("name", ["mobilenet_thin", "vgg19", "vggtiny",
                                  "hao28"])
def test_variable_tree_matches_fixture(name):
    fix = _fixture()
    cfg = _fixture_cfg(fix, name)
    x = jnp.zeros((1, cfg.hin, cfg.win, 3), jnp.float32)
    variables = get_model(cfg).init(jax.random.PRNGKey(0), x)
    tree = {_path(p): list(a.shape) for p, a in
            jax.tree_util.tree_flatten_with_path(variables)[0]}
    assert tree == fix["models"][name]["tree_float32"]


@pytest.mark.parametrize("stem_s2d", [True, False])
@pytest.mark.parametrize("name", ["mobilenet_thin", "vgg19", "vggtiny",
                                  "hao28"])
def test_forward_matches_fixture(name, stem_s2d):
    """Fixed numpy-filled params and input (as the fixture describes):
    every output map's sum and abs-sum within 1e-5 relative."""
    fix = _fixture()
    g = fix["geometry"]
    cfg = _fixture_cfg(fix, name, stem_s2d=stem_s2d)
    model = get_model(cfg)
    x = np.random.default_rng(123).uniform(
        -0.5, 0.5, (g["batch"], g["hin"], g["win"], 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, g["hin"], g["win"], 3))))
    flat, treedef = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(0)
    leaves = []
    for s in flat:
        if len(s.shape) == 4:
            fan = s.shape[0] * s.shape[1] * s.shape[2]
            leaves.append(rng.normal(0, np.sqrt(2.0 / fan), s.shape))
        else:
            leaves.append(rng.normal(0, 0.1, s.shape))
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(v.astype(np.float32)) for v in leaves])
    with jax.default_matmul_precision("highest"):
        out = jax.jit(model.apply)(params, jnp.asarray(x))
    want = fix["models"][name]["out_float32_" + ("s2d" if stem_s2d
                                                 else "plain")]
    got = {f"{k}{i + 1}": out[k][i] for k in ("conf", "paf")
           for i in range(g["n_stages"])}
    got["feature"] = out["feature"].astype(jnp.float32)
    assert set(got) == set(want)
    for key, a in got.items():
        a = np.asarray(a, np.float64)
        ref_sum, ref_abs, shape = want[key]
        assert list(a.shape) == shape, key
        np.testing.assert_allclose(np.abs(a).sum(), ref_abs, rtol=1e-5,
                                   err_msg=key)
        assert abs(a.sum() - ref_sum) <= 1e-5 * ref_abs, key


@pytest.mark.parametrize("name", ["mobilenet_thin", "vgg19", "vggtiny",
                                  "hao28"])
def test_init_matches_fixture(name):
    """A seed gives the same initial weights as the Flax layer did (same
    initializer families, same per-parameter key derivation)."""
    fix = _fixture()
    cfg = _fixture_cfg(fix, name)
    variables = get_model(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.hin, cfg.win, 3)))
    want = fix["models"][name]["init_seed0"]
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert {_path(p) for p, _ in flat} == set(want)
    for p, a in flat:
        a = np.asarray(a, np.float64)
        ref_sum, ref_abs = want[_path(p)]
        assert abs(a.sum() - ref_sum) <= 1e-5 * max(ref_abs, 1e-12), _path(p)
        assert abs(np.abs(a).sum() - ref_abs) <= 1e-5 * max(ref_abs, 1e-12)
