import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A CPU-size configuration of each family that no cell runs: the program's
# builder, the keyword arguments of the builder and the reference, the
# input (H, W, C) and the batch; 10 classes padded to 12 logits.
ZOO = {"lenet": ("lenet_niti", {}, (28, 28, 1), 4),
       "squeezenet": ("squeezenet_niti", {"num_classes": 10}, (64, 64, 3), 2),
       "inception_v3": ("inceptionv3_niti", {"num_classes": 10}, (75, 75, 3), 2),
       "resnet50v2": ("resnet50v2_niti", {"num_classes": 10}, (64, 64, 3), 2)}


@pytest.fixture
def tiny_cell():
    """tiny_cell(cell, family=None) -> (bench, manifest.cell dict) of the
    cell at CPU size: MobileNetV2 at width 0.25 or ResNet-18 at full width,
    batch 4 or 2; with `family`, that family's network at its ZOO size in
    place of the cell's configuration. 64 images, the cell's own limits."""
    from h100bench import manifest

    def make(name: str, family=None):
        bench = manifest.benchmark()
        c = copy.deepcopy(manifest.cell(bench, name))
        if family is not None:
            builder, kwargs, shape, batch = ZOO[family]
            c["config"] = {"program": {"builder": builder, "kwargs": kwargs},
                           "reference": {"family": family, "kwargs": kwargs},
                           "margins": None, "input_shape": list(shape), "classes": 10,
                           "logit_width": 12}
            c["traffic"].update(image_shape=list(shape), classes=10, batch=batch)
        elif c["config"]["reference"]["family"] == "mobilenet_v2":
            c["config"]["program"]["kwargs"]["width_mult"] = 0.25
            c["config"]["reference"]["kwargs"]["width_mult"] = 0.25
            c["traffic"]["batch"] = 4
        else:
            c["traffic"]["batch"] = 2
        c["traffic"]["images"] = 64
        c["cell"]["trace_steps"] = 2
        return bench, c

    return make
