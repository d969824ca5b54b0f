"""File-based circuit breaker with timed cooldown and auto-heal.

Matches the reference's breaker exactly (main.py:154-187): state lives
in a JSON file so every worker process sees trips immediately; ``trip``
writes ``{healthy: false, disabled_until: now + cooldown}`` atomically
via ``os.replace``; ``is_healthy`` auto-heals (and persists the healed
state) once the cooldown expires.  On any LLM failure the pipeline trips
the breaker and degrades to a canned answer instead of a 5xx
(main.py:299-302).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEGRADED_ANSWER = "⚠️ LLM unavailable."


class CircuitBreaker:
    def __init__(self, state_path: str, cooldown_s: float = 60.0):
        self.state_path = state_path
        self.cooldown_s = cooldown_s

    def _read(self) -> dict:
        try:
            with open(self.state_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"healthy": True, "disabled_until": 0.0}

    def _write(self, state: dict) -> None:
        d = os.path.dirname(self.state_path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".cb_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self.state_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def trip(self, cooldown_s: float | None = None) -> None:
        cd = self.cooldown_s if cooldown_s is None else cooldown_s
        self._write({"healthy": False, "disabled_until": time.time() + cd})

    def reset(self) -> None:
        self._write({"healthy": True, "disabled_until": 0.0})

    @property
    def is_healthy(self) -> bool:
        state = self._read()
        if state.get("healthy", True):
            return True
        if time.time() >= state.get("disabled_until", 0.0):
            self._write({"healthy": True, "disabled_until": 0.0})
            return True
        return False
