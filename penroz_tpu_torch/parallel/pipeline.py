"""The stage partition of pipeline-parallel serving (counterpart of
penroz_tpu/parallel/pipeline.py's ``pipeline_block_range`` and
``serve_stage_bounds``; its training pipeline is not ported)."""

from __future__ import annotations

import json


def pipeline_block_range(layers_dsl: list[dict]) -> tuple[int, int]:
    """Longest contiguous run of identical top-level DSL entries (the
    repeated transformer blocks): ``(start, count)``, ``count`` 1 when no
    entry repeats.  Identity is full-config equality, so a heterogeneous
    stack pipelines only its equal sub-runs."""
    keys = [json.dumps(entry, sort_keys=True, default=str)
            for entry in layers_dsl]
    best_start, best_count = 0, 1
    i = 0
    while i < len(keys):
        j = i
        while j + 1 < len(keys) and keys[j + 1] == keys[i]:
            j += 1
        if j - i + 1 > best_count:
            best_start, best_count = i, j - i + 1
        i = j + 1
    return best_start, best_count


def serve_stage_bounds(layers_dsl: list[dict], stages: int) -> list[tuple]:
    """Half-open top-level DSL entry ranges of ``stages`` serving stages:
    the repeated blocks (:func:`pipeline_block_range`) split into
    near-equal contiguous runs, everything before them glued to the first
    stage and everything after them to the last, so the ranges cover the
    whole list.  ValueError when there are fewer repeated blocks than
    stages (a stage would own no attention layer)."""
    stages = int(stages)
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    start, count = pipeline_block_range(layers_dsl)
    if count < stages:
        raise ValueError(
            f"cannot partition {count} repeated block(s) over {stages} "
            f"pipeline stages (need at least one block per stage)")
    sizes = [count // stages + (1 if i < count % stages else 0)
             for i in range(stages)]
    bounds = []
    lo = 0
    hi = start
    for i, size in enumerate(sizes):
        hi += size
        bounds.append((lo, len(layers_dsl) if i == stages - 1 else hi))
        lo = hi
    return bounds
