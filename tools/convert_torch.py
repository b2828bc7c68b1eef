#!/usr/bin/env python3
"""Model converter CLI of the PyTorch/CUDA port, the counterpart of
tools/convert.py: import PyTorch / ONNX / TFLite models.

The analog of the reference's `tools/converter` (MNNConvert: external
framework model -> .mnn) followed by `transformer.out` turn-trainable.
Converts a torch .pt/.pth state_dict, an .onnx file, or a .tflite file of an
architecture-matched model into the fp32 params of the port's float models
and saves a checkpoint; `--quantize` also writes the NITI int8 QTensor tree
(the turnModelToTrainable analog, utils/checkpoint.quantize_params_tree).
The flags, printed lines and checkpoints (keys and arrays) are the JAX
CLI's. It runs on the host and imports nothing of JAX or of the JAX package.

    python tools/convert_torch.py model.pt --arch lenet_fp32 --out lenet.npz
    python tools/convert_torch.py model.onnx --arch lenet_fp32 --out lenet.npz
    python tools/convert_torch.py model.tflite --arch lenet_fp32 --out lenet.npz
    python tools/convert_torch.py mbv2.pth --arch mobilenet_v2_fp32 \\
        --out mbv2.npz --quantize
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input",
                    help="torch .pt/.pth (state_dict or module), .onnx, "
                         "or .tflite")
    ap.add_argument("--arch", required=True,
                    choices=["lenet_fp32", "mobilenet_v1_fp32",
                             "mobilenet_v2_fp32"])
    ap.add_argument("--out", required=True, help="output checkpoint .npz")
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--quantize", action="store_true",
                    help="also save <out>.niti.npz with int8 QTensor weights")
    args = ap.parse_args(argv)

    from mandheling_tpu_torch.models.mobilenet_fp32 import MobileNetV1FP32, MobileNetV2FP32
    from mandheling_tpu_torch.utils.checkpoint import (flatten_tree, quantize_params_tree,
                                                       save_tree)
    from mandheling_tpu_torch.utils.convert import (lenet_fp32_from_modules,
                                                    load_torch_file,
                                                    mobilenet_fp32_from_modules,
                                                    modules_from_state_dict)

    if args.input.endswith(".onnx"):
        from mandheling_tpu_torch.utils.onnx_io import modules_from_onnx

        modules = modules_from_onnx(args.input)
    elif args.input.endswith(".tflite"):
        from mandheling_tpu_torch.utils.tflite_model import modules_from_tflite

        modules = modules_from_tflite(args.input)
    else:
        modules = modules_from_state_dict(load_torch_file(args.input))
    if args.arch == "lenet_fp32":
        params = lenet_fp32_from_modules(modules)
    else:
        model_cls = (MobileNetV1FP32 if args.arch == "mobilenet_v1_fp32"
                     else MobileNetV2FP32)
        params = mobilenet_fp32_from_modules(
            modules, model_cls(num_classes=args.num_classes)
        )

    save_tree(args.out, params)
    n = sum(x.size for x in flatten_tree(params).values())
    print(f"converted {args.input} ({args.arch}, {n} params) -> {args.out}")

    if args.quantize:
        qpath = args.out.removesuffix(".npz") + ".niti.npz"
        save_tree(qpath, quantize_params_tree(params))
        print(f"NITI int8 tree -> {qpath}")


if __name__ == "__main__":
    main()
