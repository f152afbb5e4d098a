"""Friendly missing-dependency errors (reference: ``utils/excepthook.py``)."""

from __future__ import annotations

import sys

_original_excepthook = sys.excepthook


def _custom_excepthook(exc_type, exc_value, exc_traceback):
    _original_excepthook(exc_type, exc_value, exc_traceback)
    if issubclass(exc_type, (ModuleNotFoundError, ImportError)):
        message = str(exc_value)
        missing = message.split("'")[-2] if "'" in message else message
        print(f"\nError: the module '{missing}' could not be imported.", file=sys.stderr)
        print(
            "Install the missing dependency (pip install -r requirements.txt) "
            "or gate the optional feature that needs it.",
            file=sys.stderr,
        )


def install_excepthook() -> None:
    sys.excepthook = _custom_excepthook
