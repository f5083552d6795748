"""HPO seam.

The reference wires NNI directly into ``__main__`` (train.py:487-499:
``nni.get_next_parameter`` -> ``merge_parameter`` -> trial report hooks).
Here the seam is a plain flat-dict override (the same 8 keys the reference
search space exposes, search_space.json:1-10) plus a reporting hook with
NNI / no-op backends, so any sweeper — NNI included — can drive the
trainer without the trainer importing it unconditionally.

A copy of ``mobilenet_yolo_tpu/train/hpo.py``; ``nni`` is imported only
where an NNI trial drives the run.
"""

from __future__ import annotations

from typing import Any, Protocol


class ReportHook(Protocol):
    def intermediate(self, value: float) -> None: ...
    def final(self, value: float) -> None: ...


class NoOpReport:
    def intermediate(self, value: float) -> None:
        pass

    def final(self, value: float) -> None:
        pass


class NNIReport:
    def __init__(self):
        import nni  # gated import: only when an NNI trial drives us
        self._nni = nni

    def intermediate(self, value: float) -> None:
        self._nni.report_intermediate_result(value)

    def final(self, value: float) -> None:
        self._nni.report_final_result(value)


def get_tuner_overrides() -> dict[str, Any]:
    """Fetch tuner parameters if running under NNI, else {}."""
    try:
        import nni
        params = nni.get_next_parameter()
        return dict(params) if params else {}
    except Exception:
        return {}


def make_report_hook() -> ReportHook:
    try:
        return NNIReport()
    except Exception:
        return NoOpReport()
