import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny_cell():
    """tiny_cell(cell) -> (bench, manifest.cell dict) of the cell at CPU
    size: MobileNetV2 at width 0.25 or ResNet-18 at full width, 64 images,
    batch 4 or 2, with the cell's own limits."""
    from h100bench import manifest

    def make(name: str):
        bench = manifest.benchmark()
        c = copy.deepcopy(manifest.cell(bench, name))
        if c["config"]["reference"]["family"] == "mobilenet_v2":
            c["config"]["program"]["kwargs"]["width_mult"] = 0.25
            c["config"]["reference"]["kwargs"]["width_mult"] = 0.25
            c["traffic"]["batch"] = 4
        else:
            c["traffic"]["batch"] = 2
        c["traffic"]["images"] = 64
        c["cell"]["trace_steps"] = 2
        return bench, c

    return make
