"""Per-card calibration of the chooser's prices, the counterpart of
``ellspmv_tpu.bench.calibrate``.

The chooser (``formats/auto.py``) prices a format by the bytes it moves
over the card's memory rate, and each K1 launch too short to fill the card
by its rounds of loads at K1's round latency (``bench/traffic.py``).
``config.py`` holds the data-sheet rates of the cards it names and the
round latency measured on one card; on any other card the chooser would
price with that card's numbers. This module measures both on the card at
hand, caches them in a JSON file keyed by ``torch.cuda.get_device_name``,
and serves them to ``config.k1_geometry`` and ``config.pricing_rate``:

    python -m ellspmv_tpu_torch.bench.calibrate        # measure and save

It never runs implicitly: importing it, and pricing, only read the cache
(``utils/calibration.py``, whose `get` and `inject` it serves too).
"""

from __future__ import annotations

import sys

import numpy as np

from ellspmv_tpu_torch.utils import calibration
from ellspmv_tpu_torch.utils.calibration import K1_ROUND, RATE, get, inject

__all__ = ["K1_ROUND", "RATE", "calibrate", "get", "inject", "main",
           "probe_k1_geometry"]

# A measurement outside these bounds is a fault of the timing, not a
# card: it is dropped, and config.py's value stands.
_PLAUSIBLE = {K1_ROUND["float64"]: (1e-8, 1e-4),
              K1_ROUND["float32"]: (1e-8, 1e-4),
              RATE: (1e10, 2e13)}

# Short K1 launches for the round-latency probe: row counts whose blocks of
# 512 rows stay under the card's SMs, and widths (slots a row); columns
# random over a million (wide columns, as in the SELL split's sub-row
# buckets).
K1_PROBE_ROWS = (2048, 16384, 49152)
K1_PROBE_WIDTHS = (4, 16, 32, 64, 128)
K1_PROBE_COLUMNS = 1_000_000


def _apply_plausibility_gate(out: dict, log=None) -> dict:
    for name, (lo_ok, hi_ok) in _PLAUSIBLE.items():
        if name in out and not lo_ok <= out[name] <= hi_ok:
            if log:
                log.write(f"calibration: {name}={out[name]:.3g} outside "
                          f"[{lo_ok:g}, {hi_ok:g}]: implausible, not kept "
                          "(config.py's value stands)\n")
            del out[name]
    return out


def _probe_ell(rows, width, prec, device):
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.ell import ell_from_row_major
    rng = np.random.RandomState(rows + width)
    cols = rng.randint(0, K1_PROBE_COLUMNS, (rows, width)).astype(np.int32)
    vals = rng.rand(rows, width)
    return ell_from_row_major(cols, vals, None, rows, K1_PROBE_COLUMNS,
                              rows * width, value_dtype(prec), device)


def probe_k1_geometry(device="cuda", log=None) -> dict:
    """K1 on short launches (fewer blocks than the card has SMs) at several
    widths, each in a CUDA graph: the time against the rounds of
    ``kSlotBatch`` slots each thread walks, and the least-squares line
    through them. Its slope is one round's latency, the ``L`` of the
    chooser's K1 price. Returns {prec: L in seconds} for fp64 and f32."""
    import torch

    from ellspmv_tpu_torch.bench.traffic import k1_rounds
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.ops import ell_cuda
    from ellspmv_tpu_torch.utils.timing import graph_ms
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fits = {}
    for prec in K1_ROUND:
        points = []
        x = torch.from_numpy(np.random.RandomState(5).rand(
            K1_PROBE_COLUMNS)).to(device).to(value_dtype(prec))
        for rows in K1_PROBE_ROWS:
            blocks = -(-rows // 512)
            if blocks >= sms:
                raise RuntimeError(f"probe rows {rows}: {blocks} blocks "
                                   f"fill the {sms} SMs")
            line = []
            for width in K1_PROBE_WIDTHS:
                ell = _probe_ell(rows, width, prec, device)
                if ell.lcol is not None:
                    raise RuntimeError("the probe's columns must be wide")
                ms = graph_ms(lambda: ell_cuda.ell_spmv(ell, x))
                points.append((k1_rounds(width), ms))
                line.append(f"{width}: {ms:.4f}")
            if log:
                log.write(f"  K1 probe {prec}, {rows:,} rows ({blocks} "
                          f"blocks of {sms} SMs), ms by width: "
                          f"{', '.join(line)}\n")
        r = np.array([p[0] for p in points], np.float64)
        t = np.array([p[1] for p in points], np.float64)
        slope, icept = np.polyfit(r, t, 1)
        resid = np.abs(t - (icept + slope * r)).max()
        fits[prec] = slope * 1e-3
        if log:
            log.write(f"  K1 probe {prec}: t = {icept:.4f} ms + "
                      f"{slope * 1e3:.3f} us x rounds (rounds = ceil(width "
                      f"/ 4)); worst residual {resid * 1e3:.2f} us over "
                      f"{len(points)} launches\n")
    return fits


def calibrate(save: bool = True, log=None, device="cuda") -> dict:
    """Measure K1's round latency (fp64 and f32) and the memory rate (the
    triad of ``bench/stream.py``) on the card `device` names; with `save`,
    cache them under its name. Returns the values that passed the
    plausibility gate. Needs a card."""
    import torch

    from ellspmv_tpu_torch.bench.stream import measure_peak_bandwidth
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"calibrate: needs a CUDA device, got {device}")
    card = torch.cuda.get_device_name(device)
    fits = probe_k1_geometry(device, log)
    out = {K1_ROUND[prec]: seconds for prec, seconds in fits.items()}
    out[RATE] = measure_peak_bandwidth(log=log, device=device)
    _apply_plausibility_gate(out, log)
    if log:
        log.write(f"calibration [{card}]: K1 round "
                  + ", ".join(f"{out[K1_ROUND[p]] * 1e6:.3f} us {p}"
                              for p in K1_ROUND if K1_ROUND[p] in out)
                  + (f"; memory {out[RATE] / 1e9:.1f} GB/s" if RATE in out
                     else "") + "\n")
    if save:
        calibration.save(card, out)
        if log:
            log.write(f"calibration: saved to {calibration.CACHE_PATH}\n")
    return out


def main(argv=None) -> int:
    import torch
    if sys.argv[1:] if argv is None else argv:
        sys.stderr.write("usage: python -m ellspmv_tpu_torch.bench.calibrate"
                         " (no arguments)\n")
        return 1
    if not torch.cuda.is_available():
        sys.stderr.write("calibrate: no CUDA device is available\n")
        return 1
    calibrate(save=True, log=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
