"""The benchmark's CPU tests (and its card tests, marked ``cuda``). Run
from the repository's root: ``python -m pytest fedbench/tests``."""
import os
import sys

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
