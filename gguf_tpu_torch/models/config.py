"""`LlamaConfig`, reused from `gguf_tpu/models/config.py` without a copy.

That file imports nothing but the standard library, but importing it as
`gguf_tpu.models.config` would run `gguf_tpu/models/__init__.py`, which
imports jax. So the file is loaded by path under a name of this package.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "gguf_tpu", "models", "config.py")
_NAME = "gguf_tpu_torch.models._llama_config"


def _load():
    mod = sys.modules.get(_NAME)
    if mod is None:
        spec = importlib.util.spec_from_file_location(_NAME, _PATH)
        mod = importlib.util.module_from_spec(spec)
        # dataclasses resolves annotations through sys.modules[__module__]
        sys.modules[_NAME] = mod
        spec.loader.exec_module(mod)
    return mod


LlamaConfig = _load().LlamaConfig

__all__ = ["LlamaConfig"]
