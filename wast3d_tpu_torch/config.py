"""Model-directory config: the `cfg_args` reader of `wast3d_tpu/config.py`."""

from __future__ import annotations

import argparse
import os
from typing import Optional


def load_cfg_args(model_path: str) -> Optional[argparse.Namespace]:
    """Read `<model_path>/cfg_args`, a `Namespace(...)` literal (the format
    the reference writes and eval()s), or None when there is none."""
    path = os.path.join(model_path, "cfg_args")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    return eval(text, {"Namespace": argparse.Namespace})  # noqa: S307
