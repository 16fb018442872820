"""The one traffic generator: every mix is a data file it reads.

A mix (``traffic/<name>.json``) names a route, a closed loop of
``concurrency`` slots, a ramp, and the distribution of each size a
request has. Every seed gets the same multiset of sizes: a size takes
``concurrency`` fixed values, the quantiles at ``(i + 0.5) /
concurrency``, and each block of ``concurrency`` consecutive requests
holds each value once, in an order drawn from the seed. So a window that
sees a few hundred requests sees nearly the same work on every seed, and
the seed changes the order and the content (words, token ids), not the
amount.

Request ``k`` of slot ``j`` is global request ``k * concurrency + j``.
Everything a request holds is a pure function of (seed, slot, k), so the
client that sends it and the check that judges it build it alike. A
slot's first request asks for a share of its output length drawn from
the seed, so the slots start at the spread of ages a closed loop settles
to, and the ramp is short.

Sizes (``"dist"``): ``lognormal`` (``median``, ``sigma``), ``uniform``
and ``fixed`` (``value``), each clipped to ``[min, max]`` and rounded.
"""

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np

SIZE_KEYS = ("prompt_tokens", "output_tokens", "input_tokens")


def load_mix(root: Path, name: str) -> Dict[str, Any]:
    """``traffic/<name>.json`` under the benchmark directory ``root``."""
    path = root / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


def quantile_values(spec: Dict[str, Any], strata: int) -> List[int]:
    """The ``strata`` fixed values of one size, ascending."""
    kind = spec["dist"]
    values = []
    for i in range(strata):
        q = (i + 0.5) / strata
        if kind == "lognormal":
            v = math.exp(math.log(spec["median"]) + spec["sigma"] * NormalDist().inv_cdf(q))
        elif kind == "uniform":
            v = spec["min"] + q * (spec["max"] - spec["min"])
        elif kind == "fixed":
            v = spec["value"]
        else:
            raise ValueError(f"unknown size distribution {kind!r}")
        lo, hi = spec.get("min", v), spec.get("max", v)
        values.append(int(round(min(max(v, lo), hi))))
    return values


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *keys]))


class Plan:
    """The requests of one mix under one seed."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab_size: int = 0):
        self.mix = mix
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.concurrency = int(mix["concurrency"])
        self._values = {key: quantile_values(mix[key], self.concurrency)
                        for key in SIZE_KEYS if key in mix}

    def size(self, key: str, slot: int, k: int) -> int:
        """The value of size ``key`` for request ``k`` of ``slot``: block
        ``k`` holds each value once, in an order drawn from the seed."""
        order = _rng(self.seed, SIZE_KEYS.index(key) + 1, k).permutation(self.concurrency)
        return self._values[key][order[slot]]

    def request(self, slot: int, k: int) -> Dict[str, Any]:
        """Request ``k`` of ``slot``: its sizes, and its prompt (words) or
        its token ids."""
        out: Dict[str, Any] = {"slot": slot, "k": k}
        content = _rng(self.seed, 0xC0DE, slot, k)
        if "prompt_tokens" in self._values:
            n = self.size("prompt_tokens", slot, k)
            out["prompt"] = " ".join(_words(content, n))
        if "output_tokens" in self._values:
            out["max_tokens"] = self.size("output_tokens", slot, k)
            if k == 0:
                share = _rng(self.seed, 0x57A6, slot).random()
                out["max_tokens"] = max(1, int(round(share * out["max_tokens"])))
        if "input_tokens" in self._values:
            n = self.size("input_tokens", slot, k)
            out["ids"] = content.integers(1, self.vocab_size, n, dtype=np.int32)
        return out


def _words(rng: np.random.Generator, n: int) -> List[str]:
    """``n`` words that no other request shares (64 random bits each)."""
    return [f"w{v:x}" for v in rng.integers(0, 2**63, n, dtype=np.int64)]
