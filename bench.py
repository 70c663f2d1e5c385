"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: multi-person frames/s on one card at 368x656, end-to-end
on-device (uint8 normalize -> CNN -> grouping -> skeletons), bs=8 on the
flagship MobileNet-thin model, on a GPU (no CPU fallback).

Methodology:
  * Input is DEVICE-RESIDENT, matching the reference's fake-input
    benchmarking mode (C++ examples' --fake flag — SURVEY.md §4).
  * The timed unit is ONE jitted `lax.fori_loop` running N end-to-end
    iterations chained through a scalar data dependence (each step
    perturbs the next input) and ending in one tiny D2H fetch. A
    two-point slope — (t(N_large) − t(N_small)) / (N_large − N_small) —
    cancels the fixed dispatch+round-trip cost, so the number is the
    engine's in-program step time.

Every result names the device, the card's power limit and, where the
device kind is in PEAKS, the utilization against its published peak.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import time


# Published dense peaks per device, keyed by exact jax device_kind (NVIDIA
# H100 SXM data sheet, at its 700 W power limit). A kind not listed gets no
# utilization fields: no peak is guessed.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_tbps": 3.35},
}


def program_cost(jitted, *args) -> tuple[float, float]:
    """(flops, bytes) of ONE execution of a jitted program, from XLA's
    own per-op analytic cost model (compiled.cost_analysis()): conv/matmul
    FLOPs are exact for static shapes; 'bytes accessed' counts bytes at
    fusion boundaries — an UPPER BOUND on device-memory traffic, since
    buffers that stay in cache are still counted. mem_pct_est can
    therefore exceed 100; it is a traffic bound for cross-row comparison,
    not a measured rate."""
    compiled = jitted.lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):   # older JAX returned [dict]
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def utilization_row(flops: float, nbytes: float, dt: float,
                    device_kind: str) -> dict:
    """Achieved TFLOP/s and estimated memory GB/s for one program execution
    taking dt seconds, plus their shares of the device's published bf16
    and memory peaks when `device_kind` is in PEAKS (else none)."""
    tflops = flops / dt / 1e12
    gbps = nbytes / dt / 1e9
    row = {"flops_per_exec": flops, "achieved_tflops": tflops,
           "mem_gbps_est": gbps}
    peak = PEAKS.get(device_kind)
    if peak is not None:
        row["mfu_pct"] = 100.0 * tflops / peak["bf16_tflops"]
        row["mem_pct_est"] = 100.0 * gbps / (1e3 * peak["hbm_tbps"])
    return row


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def fori_slope_seconds(loop_fn, carry0, repeats: int = 3,
                       target_seconds: float = 0.4,
                       samples: list | None = None) -> float:
    """Best in-program seconds per iteration of a jitted device loop.

    `loop_fn(n, carry) -> carry` must run n chained iterations of the
    measured step inside ONE jitted `lax.fori_loop` with a DYNAMIC trip
    count (one compilation serves every n; the persistent compile cache
    makes it one-time per config). Chaining through the carry forces the
    device to execute the iterations sequentially, and the single D2H of
    the scalar carry forces completion.

    Per-iteration time is the TWO-POINT SLOPE between a short and a long
    loop: (t(n_large) − t(n_small)) / (n_large − n_small). Both passes pay
    the same fixed cost (dispatch + the round-trip for the final scalar),
    so the slope cancels it exactly instead of estimating it.

    Robustness: slope noise is two-sided — a host stall landing on the
    SMALL pass makes the slope too small or even negative, so
    min-over-repeats is biased and a non-positive clamp would fabricate
    absurd figures. Instead, non-positive slope samples are DISCARDED
    (with bounded retries) and the reported figure is the MEDIAN of the
    valid samples.
    """
    import numpy as np

    def run(n, carry):
        t0 = time.perf_counter()
        carry = loop_fn(n, carry)
        _ = np.asarray(carry)
        return time.perf_counter() - t0, carry

    _, carry = run(5, carry0)           # compile + warmup
    t_est, carry = run(20, carry)       # sizes the timed passes
    est = t_est / 20
    n_large = int(min(1000, max(40, round(target_seconds / est))))
    n_small = max(5, n_large // 8)
    slopes = []
    for _ in range(3 * repeats):        # bounded retries for bad windows
        t_small, carry = run(n_small, carry)
        t_large, carry = run(n_large, carry)
        dt = (t_large - t_small) / (n_large - n_small)
        if dt > 0:
            slopes.append(dt)
            if len(slopes) >= repeats:
                break
    if not slopes:
        raise RuntimeError(
            "fori_slope_seconds: no positive slope sample in "
            f"{3 * repeats} passes — timing too noisy to measure")
    if samples is not None:
        samples.extend(slopes)          # run-to-run spread for the record
    return float(np.median(slopes))


def _device_loop_seconds(engine, images, repeats: int = 3,
                         target_seconds: float = 0.4,
                         samples: list | None = None) -> float:
    """fori_slope_seconds over the full engine step (preprocess -> CNN ->
    decode), each iteration's input perturbed by the previous result."""
    import jax
    import jax.numpy as jnp

    from openpose_plus.engine import infer_step

    model, pcfg = engine.model, engine.config.postproc
    chunk = getattr(engine, "chunk", 0)

    def step(params, images, carry):
        # Chain dependence: the select's predicate depends on the previous
        # result (score sums are finite but XLA cannot prove the branch),
        # so iterations execute sequentially; the benched program is the
        # engine's own infer_step — including its chunked lowering.
        images = jnp.where(jnp.isfinite(carry), images,
                           jnp.zeros_like(images))
        res = infer_step(params, images, model=model, postproc_cfg=pcfg,
                         chunk=chunk)
        return jnp.sum(res.score)

    @jax.jit
    def loop(params, images, n, carry):
        return jax.lax.fori_loop(
            0, n, lambda i, c: step(params, images, c), carry)

    return fori_slope_seconds(
        lambda n, c: loop(engine.params, images, n, c),
        jnp.float32(0.0), repeats=repeats, target_seconds=target_seconds,
        samples=samples)


def main() -> None:
    import jax

    from openpose_plus.utils.compile_cache import configure_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's default backend "
                         f"is {jax.default_backend()!r}")
    configure_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from openpose_plus.config import default_config
    from openpose_plus.engine import Engine

    device = jax.devices()[0]
    rng = np.random.default_rng(0)
    results = {}

    def bench_engine(name, model, hin, win, batch, chunk=0):
        cfg = default_config(model)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, hin=hin,
                                                    win=win))
        eng = Engine(cfg, fast_init=True, chunk=chunk)
        # Engine input layout of record = what the host loader emits for
        # this model (s2d² for the deep-s2d MobileNet stem, s2d for the
        # VGG-family block-grid stems — models/common.py).
        shape = cfg.model.input_shape(batch)
        images = jax.device_put(jnp.asarray(rng.integers(
            0, 255, shape, dtype=np.uint8)))
        samples: list = []
        dt = _device_loop_seconds(eng, images, samples=samples)
        row = {"fps": batch / dt, "batch": batch,
               "spread_pct": 100.0 * (max(samples) - min(samples)) / dt}
        flops, nbytes = program_cost(eng._infer, eng.params, images)
        row.update(utilization_row(flops, nbytes, dt, device.device_kind))
        row["flops_per_image"] = flops / batch
        if chunk:
            # the chunked program is a lax.map whose body the cost model
            # counts ONCE — flops/mfu under-count by ~batch/chunk
            row["cost_note"] = (
                f"lax.map body counted once: flops/mfu/mem are "
                f"~{batch // chunk}x under-counted")
        results[name] = row
        return row

    head = bench_engine("e2e_fps_368x656_bs8", "mobilenet_thin", 368, 656, 8)
    print(json.dumps({
        "metric": "e2e_fps_368x656_bs8",
        "value": head["fps"],
        "unit": "frames/s",
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
        "card": card(),
        "mfu_pct": head.get("mfu_pct"),
        "spread_pct": head["spread_pct"],
    }), flush=True)

    if os.environ.get("BENCH_HEADLINE_ONLY"):
        return
    try:
        bench_engine("e2e_fps_368x432_bs1", "mobilenet_thin", 368, 432, 1)
        bench_engine("e2e_fps_vgg19_368x656_bs1", "vgg19", 368, 656, 1)
        bench_engine("e2e_fps_vgg19_368x656_bs8", "vgg19", 368, 656, 8)
        bench_engine("e2e_fps_368x656_bs32", "mobilenet_thin", 368, 656, 32)
        bench_engine("e2e_fps_368x656_bs32_chunk8", "mobilenet_thin",
                     368, 656, 32, chunk=8)
        bench_engine("e2e_fps_vggtiny_368x656_bs8", "vggtiny", 368, 656, 8)
        bench_engine("e2e_fps_hao28_368x656_bs8", "hao28", 368, 656, 8)
    finally:
        details = os.environ.get("BENCH_DETAILS_PATH")
        if details:
            with open(details, "w") as f:
                json.dump({"device": device.device_kind, "card": card(),
                           "rows": results}, f, indent=2)


if __name__ == "__main__":
    main()
