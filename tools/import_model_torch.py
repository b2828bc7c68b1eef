#!/usr/bin/env python3
"""Generic graph importer CLI of the PyTorch/CUDA port: any supported model
file -> trainable NITI checkpoint, the counterpart of tools/import_model.py
(the reference's `MNNConvert + transformer.out` pipeline in one command:
converter `tools/converter`, turn-trainable `transformer/Transformer.cpp:69`).
The graph's own topology, residual and concat branches included, becomes
the NITI layer tree through utils/graph_import.RegionWalker.

    python tools/import_model_torch.py model.onnx --input-shape 1,3,32,32 --out m.npz
    python tools/import_model_torch.py model.tflite --out m.npz
    python tools/import_model_torch.py frozen.pb --format tf \\
        --input-shape 1,224,224,3 --out m.npz
    python tools/import_model_torch.py net.caffemodel --out m.npz

Formats: onnx (NCHW), tflite (NHWC), tf frozen GraphDef (NHWC), caffe
binary NetParameter (NCHW). `--check` runs one integer train step on
synthetic data before saving. The flags, printed lines and checkpoint (keys
and arrays) are the JAX CLI's. It runs on the GPU; `--device cpu` runs the
plain versions on the CPU. It imports nothing of JAX or of the JAX package.
"""

import argparse
import copy
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORMATS = ("onnx", "tflite", "tf", "caffe")
EXT = {".onnx": "onnx", ".tflite": "tflite", ".pb": "tf",
       ".caffemodel": "caffe"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("--format", choices=FORMATS, default=None,
                    help="inferred from the extension when omitted")
    ap.add_argument("--input-shape", default=None,
                    help="comma-separated; NCHW for onnx/caffe, NHWC for "
                         "tflite/tf (required for tf; optional elsewhere "
                         "when the file declares it)")
    ap.add_argument("--output", default=None,
                    help="logits tensor/node name (tf/caffe; default: the "
                         "unique graph sink)")
    ap.add_argument("--out", required=True, help="output checkpoint .npz")
    ap.add_argument("--check", action="store_true",
                    help="run one integer train step before saving")
    ap.add_argument("--dw-per-channel", action="store_true",
                    help="upgrade imported depthwise layers to per-channel "
                         "weight exponents (half of the integer-MobileNet "
                         "training recipe; pair with fgrad margins 0/0 when "
                         "fine-tuning integer-only)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (cpu: the plain versions)")
    args = ap.parse_args(argv)

    fmt = args.format or EXT.get(Path(args.input).suffix.lower())
    if fmt is None:
        ap.error(f"cannot infer format from {args.input!r}; pass --format")
    shape = (tuple(int(d) for d in args.input_shape.split(","))
             if args.input_shape else None)

    from mandheling_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if fmt == "onnx":
        from mandheling_tpu_torch.utils.onnx_model import niti_model_from_onnx

        model, _ = niti_model_from_onnx(args.input, input_shape=shape, device=device)
    elif fmt == "tflite":
        from mandheling_tpu_torch.utils.tflite_model import niti_model_from_tflite

        model, _ = niti_model_from_tflite(args.input, input_shape=shape, device=device)
    elif fmt == "tf":
        from mandheling_tpu_torch.utils.tf_model import niti_model_from_graphdef

        model, _ = niti_model_from_graphdef(
            args.input, input_shape=shape, output=args.output, device=device)
    else:
        from mandheling_tpu_torch.utils.caffe_model import niti_model_from_caffemodel

        model, _ = niti_model_from_caffemodel(
            args.input, input_shape=shape, output=args.output, device=device)

    if args.dw_per_channel:
        from mandheling_tpu_torch.nn.transform import dw_to_per_channel

        model = dw_to_per_channel(model)
        n_pc = sum(getattr(l, "per_channel", False) for l in model.layers)
        print(f"dw-per-channel: upgraded {n_pc} depthwise layers")

    kinds = [type(l).__name__ for l in model.layers]
    print(f"imported {len(kinds)} NITI layers: {kinds}")

    from mandheling_tpu_torch.utils.checkpoint import save_checkpoint
    from mandheling_tpu_torch.utils.jax_params import export_jax_params

    # a copy of the imported weights: the check's step updates the model in
    # place, and on the CPU the exported arrays share its memory
    params = copy.deepcopy(export_jax_params(model))
    if args.check:
        import numpy as np
        import torch

        from mandheling_tpu_torch.data import onehot_padded
        from mandheling_tpu_torch.ops.qtensor import QTensor
        from mandheling_tpu_torch.train import make_train_step
        from mandheling_tpu_torch.train.train_step import quantize_batch

        if shape is None:
            raise SystemExit("--check needs --input-shape")
        if fmt in ("onnx", "caffe"):  # NCHW spec -> NHWC batch
            _, c, h, w = shape
        else:
            _, h, w, c = shape
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(0, 1, (8, h, w, c)).astype(np.float32)).to(device)
        # probe the logit width from a forward pass
        d, e = quantize_batch(x)
        logits, _ = model.fwd(QTensor(d, e))
        nlog = logits.data.shape[-1]
        oh = torch.from_numpy(onehot_padded(
            rng.integers(0, min(10, nlog), 8), min(10, nlog), nlog)).to(device)
        loss = make_train_step(model)(x, oh)
        print(f"check: one integer train step OK, loss {float(loss):.4f}")

    save_checkpoint(args.out, params, step=0,
                    extra={"source_format": fmt, "layers": kinds})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
