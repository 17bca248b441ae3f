"""The benchmark's own tests: ``python -m pytest afcbench/tests -q`` from
the root of the checkout.  Imports no JAX: the card's tests (marked
``cuda``) run here too, on a card."""
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
for p in (str(_REPO), str(_REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
