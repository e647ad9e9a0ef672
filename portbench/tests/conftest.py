"""The harness's CPU tests: `python -m pytest portbench/tests` from the
checkout's root.  Tests marked `cuda` decide inside the test whether a
card is there and skip where there is none."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)
