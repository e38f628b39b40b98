"""The benchmark's own CPU tests: ``python3 -m pytest hebench/tests -q``
from the repository root.  No card is used: the program runs on the
CPU at small sizes, and a measuring run refuses to start without one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
