"""Training diagnostics: per-layer activation/gradient/weight statistics
(copy of penroz_tpu/utils/stats.py; the port keeps its own).

Produces the /stats/ payload the dashboard renders — activation mean/std +
algo-specific saturation fraction + density histograms, activation-gradient
histograms, and 2-D weight data/gradient histograms (reference:
neural_net_model.py:735-777).  All inputs are host numpy arrays; the heavy
lifting (activations + their cost-gradients) happens in the instrumented
pass (models/model.py ``CompiledArch.stats_grads``), not here.  Numpy only,
so either package's document is the other's.
"""

from __future__ import annotations

import numpy as np

HIST_BINS = 100  # torch.histogram's default bin count


def rate(numerator, denominator):
    """``numerator / denominator`` or None when the denominator is zero —
    the serving-stats ratio convention (spec-decode accept rate, tokens
    per decode step, prefix-cache hit rate): None keeps "never ran"
    distinct from "ran and measured 0"."""
    return (numerator / denominator) if denominator else None


def histogram(a: np.ndarray):
    """(bin_left_edges, density) matching torch.histogram(density=True)."""
    a = np.asarray(a, np.float32).ravel()
    if a.size == 0:
        return [], []
    hist, edges = np.histogram(a, bins=HIST_BINS, density=True)
    return edges[:-1].tolist(), hist.tolist()


def saturation_fraction(algo: str, a: np.ndarray) -> float:
    """Fraction of saturated activations under the algo-specific predicate."""
    if algo == "embedding":
        saturated = np.linalg.norm(a, axis=-1) > 5.0
    elif algo == "batchnorm1d":
        saturated = np.abs(a) > 3.0
    elif algo in ("tanh", "sigmoid"):
        saturated = np.abs(a) > 0.97
    elif algo == "relu":
        saturated = a <= 0
    elif algo == "softmax":
        saturated = a.max(axis=-1) > 0.97
    else:
        saturated = np.abs(a) > 5.0
    return float(np.mean(saturated.astype(np.float32)))


def build_stats(algos, activations, act_grads, weights, weight_grads) -> dict:
    """Assemble the /stats/ document.

    ``algos`` has one entry per top-level layer; zips truncate to the shorter
    of algos/activations just as the reference does (neural_net_model.py:764).
    """
    layer_stats = []
    for algo, a, g in zip(algos, activations, act_grads):
        ax, ay = histogram(a)
        entry = {
            "algo": algo,
            "activation": {
                "mean": float(a.mean()),
                "std": float(a.std()),
                "saturated": saturation_fraction(algo, a),
                "histogram": {"x": ax, "y": ay},
            },
            "gradient": None,
        }
        if g is not None:
            gx, gy = histogram(g)
            entry["gradient"] = {
                "mean": float(g.mean()),
                "std": float(g.std()),
                "histogram": {"x": gx, "y": gy},
            }
        layer_stats.append(entry)

    weight_stats = []
    for w, g in zip(weights, weight_grads):
        if w is None:
            weight_stats.append(None)
            continue
        gx, gy = histogram(g) if g is not None else ([], [])
        weight_stats.append({
            "shape": str(tuple(w.shape)),
            "data": {"mean": float(w.mean()), "std": float(w.std())},
            "gradient": {
                "mean": float(g.mean()) if g is not None else 0.0,
                "std": float(g.std()) if g is not None else 0.0,
                "histogram": {"x": gx, "y": gy},
            },
        })
    return {"layers": layer_stats, "weights": weight_stats}
