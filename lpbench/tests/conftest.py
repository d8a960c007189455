"""The harness's CPU tests run from the root of the checkout:
`python -m pytest lpbench/tests`."""

import sys
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
