"""Where the port's native sources live and where their builds go.

``csrc/`` holds the CUDA kernels (built by ``ops/kernels/_build.py``) and
the host's C++ ray gather (built by ``data/native.py``); both libraries are
built at first use into ``_build/``, which git ignores.
"""

from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
