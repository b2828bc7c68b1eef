"""Post-training quantization calibration: KL / MSE / ADMM scale selection
(the port's own copy of ``mandheling_tpu/utils/calibration.py``, which uses
numpy only; the port imports nothing of the JAX package).

Reference: `tools/quantization/calibration.cpp` (per-tensor activation scale
by KL-divergence threshold search, :542; weight quantization by max-abs or
ADMM, :706) and `demo/quanByMSE.cpp` (the scale that minimizes the
reconstruction MSE). The scales feed the fake-quant layers (nn/qat.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np

NUM_BINS = 2048  # calibration.cpp histogram width
QUANT_LEVELS = 128  # int8 positive range


def collect_histogram(samples: Iterable[np.ndarray], num_bins: int = NUM_BINS):
    """Accumulate |x| histograms over calibration batches -> (hist, max_val)."""
    max_val = 0.0
    arrs = []
    for s in samples:
        a = np.abs(np.asarray(s, np.float32)).ravel()
        arrs.append(a)
        if a.size:
            max_val = max(max_val, float(a.max()))
    hist = np.zeros(num_bins, np.float64)
    if max_val == 0.0:
        return hist, 0.0
    for a in arrs:
        h, _ = np.histogram(a, bins=num_bins, range=(0.0, max_val))
        hist += h
    return hist, max_val


def kl_threshold(hist: np.ndarray, max_val: float) -> float:
    """KL-divergence threshold search (calibration.cpp:542 /
    TensorRT-style): pick the clip point whose quantized distribution has
    minimal KL divergence from the original."""
    if max_val == 0.0:
        return 1.0
    num_bins = len(hist)
    best_kl, best_i = np.inf, num_bins
    total = hist.sum()
    if total == 0:
        return max_val
    for i in range(QUANT_LEVELS, num_bins + 1):
        p = hist[:i].astype(np.float64).copy()
        p[i - 1] += hist[i:].sum()  # clip outliers into the last bin
        p /= p.sum()

        # quantize bins [0, i) into QUANT_LEVELS buckets, then expand back
        factor = i / QUANT_LEVELS
        q = np.zeros(i, np.float64)
        for j in range(QUANT_LEVELS):
            lo, hi = int(j * factor), int((j + 1) * factor)
            hi = max(hi, lo + 1)
            seg = hist[lo:hi]
            nz = seg > 0
            if nz.any():
                q[lo:hi][nz] = seg[nz].sum() / nz.sum()
        qs = q.sum()
        if qs == 0:
            continue
        q /= qs
        mask = p > 0
        kl = float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return (best_i + 0.5) * max_val / num_bins


def mse_scale(samples: Iterable[np.ndarray], num_candidates: int = 100) -> float:
    """Clip threshold minimizing int8 reconstruction MSE (quanByMSE.cpp)."""
    x = np.concatenate([np.asarray(s, np.float32).ravel() for s in samples])
    mx = float(np.abs(x).max()) if x.size else 1.0
    if mx == 0.0:
        return 1.0
    best_t, best_mse = mx, np.inf
    for frac in np.linspace(0.2, 1.0, num_candidates):
        t = mx * frac
        q = np.clip(np.round(x / t * 127.0), -127, 127) * (t / 127.0)
        m = float(np.mean((x - q) ** 2))
        if m < best_mse:
            best_mse, best_t = m, t
    return best_t


def quantize_weight_maxabs(w: np.ndarray, per_channel: bool = True):
    """-> (int8 weights, float scales). Per-output-channel max-abs
    (calibration.cpp _weightQuantizeMethod=="MAX_ABS"). Channel = last dim
    (HWIO)."""
    w = np.asarray(w, np.float32)
    if per_channel:
        flat = w.reshape(-1, w.shape[-1])
        scale = np.maximum(np.abs(flat).max(axis=0), 1e-9) / 127.0
    else:
        scale = np.array([max(float(np.abs(w).max()), 1e-9) / 127.0])
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_weight_admm(w: np.ndarray, iters: int = 25):
    """ADMM-style alternating scale/codes refinement
    (calibration.cpp QuantizeWeightADMM): minimizes ||w - s*q||^2 over
    integer codes q in [-127,127] and per-channel scale s."""
    w = np.asarray(w, np.float32)
    flat = w.reshape(-1, w.shape[-1])
    scale = np.maximum(np.abs(flat).max(axis=0), 1e-9) / 127.0
    for _ in range(iters):
        q = np.clip(np.round(flat / scale), -127, 127)
        denom = np.maximum(np.sum(q * q, axis=0), 1e-9)
        scale = np.sum(flat * q, axis=0) / denom
        scale = np.maximum(np.abs(scale), 1e-12)
    q = np.clip(np.round(flat / scale), -127, 127).astype(np.int8)
    return q.reshape(w.shape), scale


def calibrate_activations(
    activations: Dict[str, List[np.ndarray]], method: str = "KL"
) -> Dict[str, float]:
    """name -> clip scale for each named activation stream.

    method: "KL" (calibration.cpp:542) or "MSE" (quanByMSE.cpp)."""
    out = {}
    for name, batches in activations.items():
        if method == "KL":
            hist, mx = collect_histogram(batches)
            out[name] = kl_threshold(hist, mx)
        elif method == "MSE":
            out[name] = mse_scale(batches)
        else:
            raise ValueError(f"unknown calibration method {method!r}")
    return out
