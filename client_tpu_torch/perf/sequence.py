"""Sequence scheduling for stateful-model load generation (the port's own
copy of ``client_tpu/perf/sequence.py``).

The reference's SequenceManager (reference sequence_manager.h:46-218):
collision-free sequence-id assignment, configurable sequence length with
±variation, correct start/end flagging. Used by the load managers when
``--sequence-length``/``--num-of-sequences`` style options are active.
"""

import itertools
import threading
from typing import Dict

import numpy as np


class SequenceManager:
    """Assigns sequence ids and start/end flags per load-generator slot."""

    def __init__(
        self,
        start_id: int = 1,
        length_mean: int = 20,
        length_variation_pct: float = 20.0,
        seed: int = 0,
    ):
        self._next_id = itertools.count(start_id)
        self._length_mean = length_mean
        self._length_variation_pct = length_variation_pct
        self._rng = np.random.default_rng(seed)
        self._states: Dict[int, dict] = {}
        self._lock = threading.Lock()

    def _new_length(self) -> int:
        spread = self._length_mean * self._length_variation_pct / 100.0
        length = int(round(self._rng.uniform(
            self._length_mean - spread, self._length_mean + spread
        )))
        return max(1, length)

    def next_step(self, slot: int) -> dict:
        """Sequence kwargs for the next request issued by ``slot``."""
        with self._lock:
            state = self._states.get(slot)
            if state is None or state["remaining"] == 0:
                state = {
                    "sequence_id": next(self._next_id),
                    "remaining": self._new_length(),
                    "started": False,
                }
                self._states[slot] = state
            start = not state["started"]
            state["started"] = True
            state["remaining"] -= 1
            end = state["remaining"] == 0
            return {
                "sequence_id": state["sequence_id"],
                "sequence_start": start,
                "sequence_end": end,
            }

    def rotate_stream(self, slot: int) -> bool:
        """True when ``slot`` just finished a sequence (callers rotate input
        streams on sequence boundaries)."""
        with self._lock:
            state = self._states.get(slot)
            return state is None or state["remaining"] == 0

    def active_sequences(self) -> int:
        with self._lock:
            return sum(
                1 for s in self._states.values() if s["remaining"] > 0
            )
