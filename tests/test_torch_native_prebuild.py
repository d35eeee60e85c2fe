"""Build the JAX package's C core once, before any test of any worker runs.

`gguf_tpu.quant.native.get_lib` guards its `make -C csrc` with a thread
lock only, and the compiler writes `csrc/build/libgguf_kquant.so` (and
`libgguf_soa.so`) in place: under `pytest -n N` one worker process can
`dlopen` a library another is still writing ("file too short"). Every
xdist worker imports every test module while it collects, before it runs
a test, so this module takes an exclusive `fcntl.flock` on a lock file in
`csrc/build/` at import and loads both libraries under it: the first
worker builds them, the others wait and then find them up to date, and
every later `get_lib()` in any worker only loads a finished file. No test
module calls the C core at import time, so nothing reaches it before this
lock is taken.
"""

import fcntl
import os

from gguf_tpu.quant import native

_BUILD_DIR = os.path.join(native._CSRC_DIR, "build")
os.makedirs(_BUILD_DIR, exist_ok=True)
with open(os.path.join(_BUILD_DIR, ".prebuild.lock"), "w") as _lock:
    fcntl.flock(_lock, fcntl.LOCK_EX)
    try:
        native.get_lib()
        native.get_soa_lib()
    finally:
        fcntl.flock(_lock, fcntl.LOCK_UN)


def test_c_core_is_built_and_loads():
    src = os.path.join(native._CSRC_DIR, "gguf_kquant.c")
    assert os.path.getmtime(native._SO_PATH) >= os.path.getmtime(src)
    lib = native.get_lib()
    assert lib.gq_fp16_to_fp32(0x3C00) == 1.0
    assert native.get_soa_lib() is not None
