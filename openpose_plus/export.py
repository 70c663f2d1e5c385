"""Serialized engine artifacts via jax.export.

The reference freezes the TF graph and converts to .uff for its C++
TensorRT runtime (scripts/export-uff.py + src/uff-runner.cpp [MED; empty
mount — SURVEY.md §2 "UFF export"]). The analogue here: the whole
end-to-end engine (uint8 preprocess -> CNN -> on-device grouping) is one
jit program, exported as a self-contained StableHLO artifact that reloads
and runs without the model-building Python code — weights baked in, like
a frozen graph.
"""

from __future__ import annotations

import json
import os
import jax
import jax.numpy as jnp
import jaxlib
import numpy as np

from openpose_plus.engine import Engine, _infer_impl
from openpose_plus.postproc import HumanBatch


_MANIFEST = "manifest.json"
_ARTIFACT = "engine.stablehlo.bin"
_TRITON_CALL = "__gpu$xla.gpu.triton"
_OUTPUTS = ("coords", "part_scores", "part_valid", "score", "n_parts",
            "valid")


# jax.export's own serializer needs the optional `flatbuffers` package,
# which GPU hosts need not have. The artifact is the StableHLO module bytes
# plus this signature in the manifest, from which load_engine rebuilds the
# jax.export.Exported. It covers what save_engine exports: one device, one
# array in, a dict of arrays out, no effects.
def _signature(exported) -> dict:
    if (exported.nr_devices != 1 or exported.ordered_effects
            or exported.unordered_effects):
        raise ValueError("engine artifacts are single-device, effect-free")
    avals = lambda xs: [[list(a.shape), str(a.dtype)] for a in xs]
    return {
        "fun_name": exported.fun_name,
        "in_avals": avals(exported.in_avals),
        "out_avals": avals(exported.out_avals),
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }


def _rebuild(sig: dict, platforms, module: bytes):
    from jax import export as jexport

    avals = lambda xs: tuple(jax.core.ShapedArray(tuple(s), np.dtype(d))
                             for s, d in xs)
    n_in, n_out = len(sig["in_avals"]), len(sig["out_avals"])
    return jexport.Exported(
        fun_name=sig["fun_name"],
        in_tree=jax.tree.structure(((0,) * n_in, {})),
        in_avals=avals(sig["in_avals"]),
        out_tree=jax.tree.structure({f: 0 for f in _OUTPUTS}),
        out_avals=avals(sig["out_avals"]),
        _has_named_shardings=False,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        in_shardings_hlo=(None,) * n_in,
        out_shardings_hlo=(None,) * n_out,
        nr_devices=1,
        platforms=tuple(platforms),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(
            jexport.DisabledSafetyCheck.custom_call(_TRITON_CALL),),
        mlir_module_serialized=module,
        calling_convention_version=sig["calling_convention_version"],
        module_kept_var_idx=tuple(sig["module_kept_var_idx"]),
        uses_global_constants=sig["uses_global_constants"],
        _get_vjp=None)


def save_engine(engine: Engine, path: str, batch_size: int = 1,
                input_layout: str = "plain"):
    """Export the engine for a fixed batch size to `path/` (dir).

    input_layout: "plain" (B,hin,win,3), "s2d" (B,hin/2,win/2,12) or
    "s2d2" (B,hin/4,win/4,48) — the space-to-depth layouts the host
    loader emits (Engine.compile docstring); baked into the artifact's
    input signature and recorded in the manifest. Returns the
    jax.export.Exported that was written."""
    from jax import export as jexport

    from openpose_plus.engine import check_input_layout

    m = engine.config.model
    shape = m.input_shape(batch_size, check_input_layout(m, input_layout))
    spec = jax.ShapeDtypeStruct(shape, jnp.uint8)

    # Close over the params so the artifact is self-contained (frozen
    # graph semantics — no Python model code needed at load time). The
    # result is flattened to a plain dict of the HumanBatch fields.
    def infer(images):
        out = _infer_impl(engine.params, images, model=engine.model,
                          postproc_cfg=engine.config.postproc)
        return {f: getattr(out, f) for f in _OUTPUTS}

    # On the GPU the decoder's serial tail runs as Pallas kernels through
    # Triton, a custom call whose serialized form jax.export does not
    # guarantee across jaxlib versions: the artifact is allowed to carry
    # it, and the manifest records the jaxlib it is tied to.
    exported = jexport.export(jax.jit(infer), disabled_checks=[
        jexport.DisabledSafetyCheck.custom_call(_TRITON_CALL)])(spec)
    triton = _TRITON_CALL in exported.mlir_module()
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _ARTIFACT), "wb") as f:
        f.write(exported.mlir_module_serialized)
    with open(os.path.join(path, _MANIFEST), "w") as f:
        import dataclasses as _dc

        json.dump({
            "model": m.name,
            "batch_size": batch_size,
            "hin": m.hin,
            "win": m.win,
            "input_layout": input_layout,
            "format": "jax.export/StableHLO",
            "signature": _signature(exported),
            "platforms": list(exported.platforms),
            # a Triton custom call inside ties the artifact to this jaxlib
            # (load_engine refuses it under another one)
            "triton_call": triton,
            "jaxlib_version": jaxlib.__version__,
            # full config so ExportedEngine.config reports what the
            # artifact was actually built with (stride, dtype, postproc
            # fidelity settings), not defaults
            "model_config": _dc.asdict(m),
            "postproc_config": _dc.asdict(engine.config.postproc),
        }, f, indent=2)
    return exported


class ExportedEngine:
    """Loaded artifact: infer(images u8) -> HumanBatch.

    Duck-types the slice of Engine the CLI apps use (`infer`, `config`), so
    `pose infer --engine-dir ...` can run a frozen artifact with no model
    code — the reference's deploy-the-.uff workflow. Accepts plain
    (B, hin, win, 3) images regardless of the artifact's baked
    input_layout — the host-side space-to-depth permute is applied here
    when the signature needs it — or the already-permuted layout directly.
    """

    def __init__(self, path: str):
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        built = self.manifest["jaxlib_version"]
        if self.manifest["triton_call"] and built != jaxlib.__version__:
            raise RuntimeError(
                f"{path}: the artifact carries a Triton custom call, whose "
                f"serialized form is stable only within one jaxlib; it was "
                f"built with jaxlib {built}, this is {jaxlib.__version__}. "
                f"Export it again with this jaxlib.")
        with open(os.path.join(path, _ARTIFACT), "rb") as f:
            self._exported = _rebuild(self.manifest["signature"],
                                      self.manifest["platforms"], f.read())
        self._call = jax.jit(self._exported.call)

    @property
    def config(self):
        import dataclasses

        from openpose_plus.config import default_config

        cfg = default_config(self.manifest["model"])
        mc = dataclasses.replace(cfg.model, hin=self.manifest["hin"],
                                 win=self.manifest["win"])
        if "model_config" in self.manifest:  # full fidelity (newer artifacts)
            mc = dataclasses.replace(mc, **self.manifest["model_config"])
            cfg = cfg.replace(postproc=dataclasses.replace(
                cfg.postproc, **self.manifest["postproc_config"]))
        return cfg.replace(model=mc)

    @property
    def batch_size(self) -> int:
        return int(self.manifest["batch_size"])

    def infer(self, images: np.ndarray | jax.Array) -> HumanBatch:
        layout = self.manifest.get("input_layout", "plain")
        if layout != "plain" and images.shape[-1] == 3:
            from openpose_plus import native

            pack = native.s2d2_u8 if layout == "s2d2" else native.s2d_u8
            images = np.stack([pack(np.asarray(f, np.uint8))
                               for f in images])
        out = self._call(jnp.asarray(images))
        return HumanBatch(**out)


def load_engine(path: str) -> ExportedEngine:
    return ExportedEngine(path)
