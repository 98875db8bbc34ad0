"""The benchmark's own tests: on the CPU at small sizes; the ``cuda``
ones run on the card.  Run from the repository's root:

  python -m pytest -q perfbench/tests
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
