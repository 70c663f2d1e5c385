"""On-device post-processing: heatmap peaks -> PAF scoring -> skeletons.

This package replaces BOTH of the reference's grouping implementations —
the Python path (openpose_plus/inference/estimator.py) and the C++ path
(src/paf.cpp :: process_conf_paf) — with one vectorized, jit-compiled JAX
implementation that runs on the device (see SURVEY.md §2 "C++ PAF grouping").

`oracle.py` is a straight numpy implementation of the reference algorithm
(dynamic shapes, sequential greedy + subset merge) used as the parity test
oracle for the fixed-shape JAX version.
"""

from openpose_plus.postproc.decode import (
    HumanBatch, build_decoder, decode_maps, merge_dedup)

__all__ = ["HumanBatch", "build_decoder", "decode_maps", "merge_dedup"]
