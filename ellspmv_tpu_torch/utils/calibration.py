"""The calibration cache: the chooser's per-card prices that
``bench/calibrate.py`` measures, in a JSON file keyed by
``torch.cuda.get_device_name``.

``config.k1_geometry`` and ``config.pricing_rate`` read it on a card only;
off a card they price by ``config.py``'s constants. Reading never measures.
Tests inject values with `inject({...})` and point `CACHE_PATH` elsewhere.
"""

from __future__ import annotations

import json
import os

from ellspmv_tpu_torch.ops._build import BUILD_DIR

CACHE_PATH = BUILD_DIR / "calibration.json"

#: The cached names: K1's round latency (seconds) by value type, and the
#: card's measured memory rate (bytes/s).
K1_ROUND = {"float64": "k1_round_seconds_float64",
            "float32": "k1_round_seconds_float32"}
RATE = "hbm_bytes_per_s"

_injected: dict | None = None


def inject(values: dict | None) -> None:
    """Test hook: serve `values` before the cache (None restores)."""
    global _injected
    _injected = dict(values) if values is not None else None


def load() -> dict:
    """The whole cache, {card: {name: value}}; empty if there is none."""
    try:
        with open(CACHE_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def get(name: str, card: str, cached: bool = True) -> float | None:
    """The calibrated value `name` for the card named `card`: injected,
    else (with `cached`) cached, else None (config.py's value then
    stands)."""
    if _injected is not None and name in _injected:
        return float(_injected[name])
    value = load().get(card, {}).get(name) if cached else None
    return None if value is None else float(value)


def save(card: str, values: dict) -> None:
    """Cache `values` under `card`, keeping the other cards' entries; the
    file is replaced whole, so a concurrent reader sees all or nothing."""
    cache = load()
    cache[card] = dict(values)
    CACHE_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = CACHE_PATH.with_name(f"{CACHE_PATH.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(cache, indent=1))
    os.replace(tmp, CACHE_PATH)
