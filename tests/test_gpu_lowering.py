"""The GPU lowering, checked on the CPU: the Triton kernels lower for CUDA
on this host, and the decoder's serial tail follows the platform it is
lowered for (jax.lax.platform_dependent) — kernels for cuda, XLA twins for
cpu. Triton refuses blocks that are not powers of two at lowering time, so
these catch shape faults without a card."""

import functools

import jax
import jax.numpy as jnp
import pytest

from openpose_plus.config import PostprocConfig
from openpose_plus.ops.pallas.greedy import greedy_assign_pallas
from openpose_plus.ops.pallas.merge import assemble_pallas
from openpose_plus.postproc import decode
from openpose_plus.postproc.paf import Connections

TRITON = "__gpu$xla.gpu.triton"


def _lowered_text(fn, *specs, platform):
    return jax.jit(fn).trace(*specs).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("k", [16, 32])
def test_greedy_kernel_lowers_for_cuda(k):
    fn = jax.vmap(functools.partial(greedy_assign_pallas, max_peaks=k))
    txt = _lowered_text(fn, jax.ShapeDtypeStruct((8, 19, k, k), jnp.float32),
                        platform="cuda")
    assert TRITON in txt
    assert "grid_x = 8" in txt          # vmap: one program per image


@pytest.mark.parametrize("k", [16, 32])
def test_merge_kernel_lowers_for_cuda(k):
    fn = jax.vmap(functools.partial(assemble_pallas, max_peaks=k,
                                    max_humans=32))
    i32 = jax.ShapeDtypeStruct((8, 19, k), jnp.int32)
    conns = Connections(slot_a=i32, slot_b=i32,
                        score=jax.ShapeDtypeStruct((8, 19, k), jnp.float32),
                        valid=jax.ShapeDtypeStruct((8, 19, k), jnp.bool_))
    txt = _lowered_text(fn, conns,
                        jax.ShapeDtypeStruct((8, 18, k), jnp.float32),
                        platform="cuda")
    assert TRITON in txt


@pytest.mark.parametrize("platform,kernels", [("cpu", False),
                                              ("cuda", True)])
def test_decoder_tail_follows_lowering_platform(platform, kernels):
    cfg = PostprocConfig()
    maps = (jax.ShapeDtypeStruct((2, 23, 41, 19), jnp.float32),
            jax.ShapeDtypeStruct((2, 23, 41, 38), jnp.float32))
    txt = _lowered_text(functools.partial(decode.decode_maps, cfg=cfg),
                        *maps, platform=platform)
    assert (TRITON in txt) == kernels
