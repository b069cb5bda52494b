"""The benchmark's CPU tests: ``python3 -m pytest hgbench/tests -q`` from
the repository's root. Tests marked ``cuda`` need the card and skip
without one; each decides so inside itself."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
