#!/usr/bin/env python3
"""run_train_demo_torch: the demo registry of the PyTorch/CUDA port.

The same demo names, arguments and printed lines as tools/run_train_demo.py
(the JAX package's CLI) for every demo whose modules the port has:

    python tools/run_train_demo_torch.py MnistTrain         [mnist_root] [--epochs N]
    python tools/run_train_demo_torch.py NITIInt8Train      [mnist_root] [--epochs N] [--snapshot F]
    python tools/run_train_demo_torch.py NITIDSPInt8Train   [mnist_root] [--epochs N]
    python tools/run_train_demo_torch.py MnistTrainSnapshot [mnist_root] [--epochs N] [--snapshot F]
    python tools/run_train_demo_torch.py MnistInt8Train     [mnist_root] [--epochs N]
    python tools/run_train_demo_torch.py DistillTrainQuant  [mnist_root] [--epochs N]
    python tools/run_train_demo_torch.py MobilenetV2Transfer [img_root --images-txt F] [--epochs N] [--snapshot F]
    python tools/run_train_demo_torch.py QuanByMSE          [mnist_root | image_folder]
    python tools/run_train_demo_torch.py OnnxImportTrain    [mnist_root] [--epochs N]
    python tools/run_train_demo_torch.py TfImportTrain      [mnist_root] [--epochs N]
    python tools/run_train_demo_torch.py CaffeImportTrain   [mnist_root] [--epochs N]
    python tools/run_train_demo_torch.py TFLiteImportTrain  [mnist_root] [--epochs N]
    python tools/run_train_demo_torch.py MobilenetV2Train   [cifar_root] [--epochs N]
    python tools/run_train_demo_torch.py MobilenetV1Train   [cifar_root] [--epochs N]
    python -m torch.distributed.run --nproc-per-node N tools/run_train_demo_torch.py \
        DistributedNITITrain | PipelineNITITrain | GPipeLeNetTrain [mnist_root] [--epochs N] \
        [--params F]
    python tools/run_train_demo_torch.py NnGradTest
    python tools/run_train_demo_torch.py DataLoaderDemo     [mnist_root]
    python tools/run_train_demo_torch.py LinearRegression

Every demo runs on the GPU; `--device cpu` runs it on the CPU with the
kernels' plain versions (for tests). The port has one lowering, so
`NITIInt8Train` and `NITIDSPInt8Train` both run the hand-written kernels.
Without a dataset on disk, the synthetic datasets made from a seed are used.
The image-folder branches of MobilenetV2Transfer (root and --images-txt) and
QuanByMSE (a root of image files) read images with PIL or the native
decoder, on the host. The four import demos build a model file in memory,
import it as a trainable NITI model and train it a few steps. It imports
nothing of JAX or of the JAX package.

The three parallel demos run one rank a process of a `torchrun` launch
(`torch.distributed.run`, gloo; on one GPU every rank shares the card), or
as one process without it, as the JAX demos run on one device; rank 0
prints. `--params F` starts them from a JAX-layout checkpoint (the JAX
demos' `jax.random` draw, which torch cannot repeat); without it the
weights come from torch's generator at seed 0.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEMOS = {}


def demo(name):
    def wrap(fn):
        DEMOS[name] = fn
        return fn

    return wrap


def _data(root, synth_n=8192):
    from mandheling_tpu_torch.data import load_or_synthesize

    train = load_or_synthesize(root, train=True, synth_n=synth_n)
    test = load_or_synthesize(root, train=False, synth_n=synth_n)
    if not train[2]:
        _say("(no MNIST idx files found — using synthetic dataset)")
    return (train[0], train[1]), (test[0], test[1])


def _cifar(root):
    from mandheling_tpu_torch.data import load_or_synthesize_cifar

    xtr, ytr, real = load_or_synthesize_cifar(root, train=True, synth_n=512)
    xte, yte, _ = load_or_synthesize_cifar(root, train=False, synth_n=256)
    if not real:
        print("(no CIFAR-10 bin files found — using synthetic dataset)")
    return (xtr, ytr), (xte, yte), real


@demo("MnistTrain")
def mnist_train(args):
    from mandheling_tpu_torch.train.trainer import train_fp32

    train, test = _data(args.root)
    _, acc = train_fp32(train, test, epochs=args.epochs, device=args.device)
    print(f"final test accuracy: {acc:.4f}")


@demo("NITIInt8Train")
def niti_train(args):
    from mandheling_tpu_torch.train.trainer import train_niti

    train, test = _data(args.root)
    _, acc = train_niti(train, test, epochs=args.epochs, checkpoint_path=args.snapshot,
                        device=args.device)
    print(f"final test accuracy: {acc:.4f}")


@demo("NITIDSPInt8Train")
def niti_dsp_train(args):
    from mandheling_tpu_torch.train.trainer import train_niti

    train, test = _data(args.root)
    _, acc = train_niti(train, test, epochs=args.epochs, backend="cuda", device=args.device)
    print(f"final test accuracy: {acc:.4f}")


@demo("MnistTrainSnapshot")
def mnist_train_snapshot(args):
    """Resume NITI training from mnist.snapshot.npz (the reference's
    MnistTrainSnapshot loads mnist.snapshot.mnn, mnistTrain.cpp:340-360).
    The file is the JAX package's format: either package resumes the other's."""
    from mandheling_tpu_torch.models import lenet_niti
    from mandheling_tpu_torch.train.trainer import train_niti
    from mandheling_tpu_torch.utils.checkpoint import load_checkpoint
    from mandheling_tpu_torch.utils.jax_params import export_jax_params

    snap = args.snapshot or "mnist.snapshot.npz"
    train, test = _data(args.root)
    start_params, start_epoch = None, 0
    if os.path.exists(snap):
        start_params, start_epoch = load_checkpoint(snap, export_jax_params(lenet_niti()))
        print(f"resumed from {snap} at epoch {start_epoch}")
    _, acc = train_niti(
        train, test, epochs=args.epochs, checkpoint_path=snap,
        start_params=start_params, start_epoch=start_epoch, device=args.device,
    )
    print(f"final test accuracy: {acc:.4f}")


@demo("MobilenetV2Train")
def mobilenet_v2_train(args):
    """Full-NITI int8 MobileNetV2 on CIFAR-10 (reference
    MobilenetV2Utils::train, demo/MobilenetV2Utils.cpp:34; CIFAR bin root or
    synthetic fallback), with the r5 recipe (DIVERGENCE_r05.json): both
    per-channel depthwise exponents and filter-grad margins 0/0 are needed
    for it to leave chance accuracy; expect a ~10-epoch plateau first. Batch
    32 on real data, 16 on synthetic; the caller's margins come back
    whatever happens. Every stride-1 depthwise filter grad runs through the
    kernel K5."""
    from mandheling_tpu_torch.models import mobilenet_v2_niti
    from mandheling_tpu_torch.ops.depthwise import recipe_margins
    from mandheling_tpu_torch.train.trainer import train_niti

    with recipe_margins():
        print("(full-NITI MNv2 recipe: per-channel dw exponents + fgrad "
              "margins 0/0 — see DIVERGENCE_r05.json; breakout needs ~10+ "
              "epochs)")
        train, test, real = _cifar(args.root)
        _, acc = train_niti(
            train, test, epochs=args.epochs, batch=32 if real else 16,
            model=mobilenet_v2_niti(dw_per_channel=True), device=args.device)
    print(f"final test accuracy: {acc:.4f}")


@demo("MobilenetV1Train")
def mobilenet_v1_train(args):
    """Full-NITI int8 MobileNetV1 on CIFAR-10 with per-channel depthwise
    exponents (CIFAR bin root or synthetic fallback)."""
    from mandheling_tpu_torch.models import mobilenet_v1_niti
    from mandheling_tpu_torch.train.trainer import train_niti

    train, test, real = _cifar(args.root)
    _, acc = train_niti(
        train, test, epochs=args.epochs, batch=32 if real else 16,
        model=mobilenet_v1_niti(dw_per_channel=True), device=args.device)
    print(f"final test accuracy: {acc:.4f}")


@demo("MnistInt8Train")
def mnist_int8_train(args):
    """Fake-quant QAT training (reference MnistInt8Train): LeNetQAT by
    autograd through the straight-through estimators, float momentum SGD at
    lr_inv(0.01, step), dropout on ip1 (its mask from torch's generator).
    The step and predict are compiled, as the JAX CLI jits them."""
    import numpy as np
    import torch

    from mandheling_tpu_torch.data import DataLoader, onehot_padded
    from mandheling_tpu_torch.device import resolve_device
    from mandheling_tpu_torch.models.lenet_qat import LeNetQAT
    from mandheling_tpu_torch.train.optim import lr_inv
    from mandheling_tpu_torch.train.qat_train import make_predict_step, make_qat_train_step
    from mandheling_tpu_torch.train.step_graph import compile_step

    device = resolve_device(args.device)
    (x, y), (xt, yt) = _data(args.root)
    model = LeNetQAT(bits=8).reset_parameters(torch.Generator().manual_seed(0)).to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    step = compile_step(make_qat_train_step(model, gen), device)
    predict = compile_step(make_predict_step(model), device)
    dl = DataLoader(x, y, 64, seed=0)
    it = 0
    for epoch in range(args.epochs):
        for bx, by in dl.epoch():
            bx = (bx / 255.0 - 0.5) * 2.0
            oh = onehot_padded(by, 10, 10).astype(np.float32)
            loss = step(torch.from_numpy(bx).to(device), torch.from_numpy(oh).to(device),
                        torch.full((), lr_inv(0.01, it), device=device))
            it += 1
        n = (len(xt) // 64) * 64
        correct = 0
        for i in range(0, n, 64):
            bx = (xt[i : i + 64].astype(np.float32) / 255.0 - 0.5) * 2.0
            pred = predict(torch.from_numpy(bx).to(device)).cpu().numpy()
            correct += int(np.sum(pred == yt[i : i + 64]))
        print(f"epoch {epoch}: loss {float(loss):.4f} test_acc {correct/max(n,1):.4f}")


@demo("DistillTrainQuant")
def distill_train_quant(args):
    """Knowledge-distillation QAT (reference demo/distillTrainQuant.cpp:114-139):
    a float teacher's logits guide a fake-quant student through
    distill_loss (T = 20, alpha = 0.9, Loss.cpp:68-84). Teacher = LeNetFP32,
    pre-trained for one epoch of plain SGD; student = LeNetQAT. The teacher
    step, the student step and predict are compiled, as the JAX CLI jits
    them."""
    import numpy as np
    import torch

    from mandheling_tpu_torch.data import DataLoader, onehot_padded
    from mandheling_tpu_torch.device import resolve_device
    from mandheling_tpu_torch.models import LeNetFP32
    from mandheling_tpu_torch.models.lenet_qat import LeNetQAT
    from mandheling_tpu_torch.train.qat_train import (make_distill_step, make_predict_step,
                                                      make_teacher_step)
    from mandheling_tpu_torch.train.step_graph import compile_step

    device = resolve_device(args.device)

    def dev(a):
        return torch.from_numpy(a).to(device)

    (x, y), (xt, yt) = _data(args.root)
    teacher = LeNetFP32().reset_parameters(torch.Generator().manual_seed(0)).to(device)
    tstep = compile_step(make_teacher_step(teacher), device)
    dl = DataLoader(x, y, 64, seed=0)
    for bx, by in dl.epoch():
        tstep(dev(bx), dev(onehot_padded(by, 10, 10).astype(np.float32)))
    print("teacher pre-trained (1 epoch)")

    student = LeNetQAT(bits=8).reset_parameters(torch.Generator().manual_seed(1)).to(device)
    gen = torch.Generator(device=device).manual_seed(2)
    sstep = compile_step(make_distill_step(student, teacher, gen), device)
    predict = compile_step(make_predict_step(student), device)
    for epoch in range(args.epochs):
        loss = None
        for bx, by in dl.epoch():
            loss = sstep(dev(bx), dev(onehot_padded(by, 10, 10).astype(np.float32)))
        n = (len(xt) // 64) * 64
        correct = sum(
            int(np.sum(predict(dev(xt[i:i + 64].astype(np.float32))).cpu().numpy()
                       == yt[i:i + 64]))
            for i in range(0, n, 64)
        )
        print(f"epoch {epoch}: distill_loss {float(loss):.4f} "
              f"student_test_acc {correct / max(n, 1):.4f}")


@demo("MobilenetV2Transfer")
def mobilenet_v2_transfer(args):
    """Transfer learning (reference demo/mobilenetV2Train.cpp:29-53): frozen
    NITI MobileNetV2 features (width 0.25) and a fresh trained classifier
    conv, on synthetic CIFAR-shaped data. `--snapshot` loads pretrained
    feature params (an npz checkpoint of the full model)."""
    import numpy as np
    import torch

    from mandheling_tpu_torch.data import DataLoader, onehot_padded, to_device
    from mandheling_tpu_torch.device import resolve_device
    from mandheling_tpu_torch.models import mobilenet_v2_niti
    from mandheling_tpu_torch.train.step_graph import compile_step
    from mandheling_tpu_torch.train.transfer import (make_transfer_eval_step,
                                                     make_transfer_train_step, transfer_from)
    from mandheling_tpu_torch.utils.checkpoint import load_checkpoint
    from mandheling_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

    device = resolve_device(args.device)
    num_classes = 10
    full = mobilenet_v2_niti(num_classes=num_classes, width_mult=0.25)
    full.reset_parameters(torch.Generator().manual_seed(0))
    if args.snapshot and os.path.exists(args.snapshot):
        load_jax_params(full, load_checkpoint(args.snapshot, export_jax_params(full))[0])
        print(f"loaded pretrained features from {args.snapshot}")
    else:
        print("(no pretrained snapshot — feature extractor is random init)")
    # split after GlobalAvgPool: everything before the classifier conv is
    # frozen (the reference freezes up to MobilenetV2/Logits/AvgPool)
    model = transfer_from(full, num_classes)
    model.reset_parameters(torch.Generator().manual_seed(1)).to(device)
    logit_width = model.head.layers[0].out_channels

    if args.root and args.images_txt:
        from mandheling_tpu_torch.data.image import ImageConfig, ImageDataset

        cfg = ImageConfig(resize_height=32, resize_width=32,
                          crop_fraction=(0.875, 0.875))
        ds = ImageDataset(args.root, args.images_txt, cfg)
        x = np.stack([ds[i][0] for i in range(len(ds))])
        y = np.array([ds[i][1] for i in range(len(ds))], np.int32)
        print(f"ImageDataset: {len(ds)} images from {args.images_txt}")
    else:
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, (512, 32, 32, 3)).astype(np.float32)
        y = (rng.integers(0, num_classes, 512)).astype(np.int32)
        print("(no image folder/txt — synthetic data)")

    # compiled as the JAX demo jits them (step_graph.py; the head's weights
    # are written in place, the JAX step's donated params)
    step = compile_step(make_transfer_train_step(model), device)
    evals = compile_step(make_transfer_eval_step(model, num_classes), device)
    dl = DataLoader(x, y, 64, seed=0)
    for epoch in range(args.epochs):
        loss = None
        for bx, by in dl.epoch():
            oh = onehot_padded(by, num_classes, logit_width)
            loss = step(to_device(bx, device), to_device(oh, device))
        n = (len(x) // 64) * 64
        correct = sum(
            int(evals(to_device(x[i:i + 64], device), to_device(y[i:i + 64], device)))
            for i in range(0, n, 64)
        )
        print(f"epoch {epoch}: loss {float(loss):.4f} "
              f"train_acc {correct / max(n, 1):.4f}")


@demo("QuanByMSE")
def quan_by_mse(args):
    """Post-training quantization by MSE / KL scale search (reference
    demo/quanByMSE.cpp + tools/quantization/calibration.cpp): calibrates a
    float LeNet's activation scales on sample batches (MNIST or synthetic),
    quantizes its weights per channel, and reports the scales and the
    quantized-vs-float agreement."""
    import numpy as np
    import torch

    from mandheling_tpu_torch.device import resolve_device
    from mandheling_tpu_torch.models import LeNetFP32
    from mandheling_tpu_torch.train.trainer import full_float32
    from mandheling_tpu_torch.utils.calibration import (calibrate_activations,
                                                        quantize_weight_admm,
                                                        quantize_weight_maxabs)

    device = resolve_device(args.device)
    if args.root and os.path.isdir(args.root) and any(
        f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
        for f in os.listdir(args.root)
    ):
        from mandheling_tpu_torch.data.image import ImageConfig, ImageNoLabelDataset

        ds = ImageNoLabelDataset(args.root, ImageConfig(28, 28, [1 / 127.5], [127.5]))
        batches = [np.stack([ds[i][..., :1] for i in range(min(len(ds), 64))])]
        print(f"calibrating on {len(ds)} images from {args.root}")
    else:
        (x, _), _ = _data(args.root, synth_n=512)
        batches = [x[i:i + 64].astype(np.float32)[..., None]
                   if x.ndim == 3 else x[i:i + 64].astype(np.float32)
                   for i in range(0, 256, 64)]
        print("calibrating on MNIST/synthetic batches")

    model = LeNetFP32().reset_parameters(torch.Generator().manual_seed(0)).to(device)

    # collect per-layer activations by tapping the forward
    acts = {"input": [], "logits": []}
    with torch.no_grad(), full_float32():
        for b in batches:
            acts["input"].append(b)
            acts["logits"].append(model(torch.from_numpy(b).to(device)).cpu().numpy())

    for method in ("MSE", "KL"):
        scales = calibrate_activations(acts, method)
        print(f"{method} scales: " +
              ", ".join(f"{k}={v:.4f}" for k, v in sorted(scales.items())))

    # weight PTQ: per-channel max-abs vs ADMM reconstruction error
    params = model.params_numpy()
    for name, quant in (("maxabs", quantize_weight_maxabs),
                        ("admm", quantize_weight_admm)):
        errs = []
        for layer in sorted(params):
            for w in (params[layer][key] for key in sorted(params[layer])):
                if w.ndim == 4:
                    q, s = quant(w)
                    errs.append(float(np.abs(q * s - w).mean()))
        print(f"weight PTQ ({name}): mean |recon err| per conv layer: "
              + ", ".join(f"{e:.5f}" for e in errs))


def _seeded(model, seed):
    """`model` with its weights drawn from torch's generator at `seed`."""
    import torch

    return model.reset_parameters(torch.Generator().manual_seed(seed))


def _train_imported(args, model):
    """The import demos' loop: 16 steps an epoch at batch 64 over the MNIST
    (or synthetic) images in order, the loss printed every 16 steps; the
    step compiled as the JAX demos jit it (step_graph.py)."""
    import numpy as np

    from mandheling_tpu_torch.data import onehot_padded, to_device
    from mandheling_tpu_torch.device import resolve_device
    from mandheling_tpu_torch.train import make_train_step
    from mandheling_tpu_torch.train.step_graph import compile_step

    device = resolve_device(args.device)
    step = compile_step(make_train_step(model), device)
    (x, y), _ = _data(args.root)
    for it in range(args.epochs * 16):
        i0 = (it * 64) % (len(x) - 64)
        loss = step(to_device(x[i0 : i0 + 64].astype(np.float32), device),
                    to_device(onehot_padded(y[i0 : i0 + 64], 10, 12), device))
        if it % 16 == 0:
            print(f"iter {it}: loss {float(loss):.4f}")
    print(f"final loss: {float(loss):.4f}")


def onnx_demo_model():
    """OnnxImportTrain's graph (a ModelProto): conv, relu, pool twice, flatten
    and a 400 -> 12 Gemm, at (1, 1, 28, 28), its weights from numpy's
    generator at seed 0."""
    import numpy as np

    from mandheling_tpu_torch.utils.onnx_io import build_onnx_sequential

    rng = np.random.default_rng(0)
    ops = [
        ("Conv", {"w": rng.normal(0, 0.2, (8, 1, 5, 5)).astype(np.float32)}),
        ("Relu", {}),
        ("MaxPool", {"kernel": (2, 2), "strides": (2, 2)}),
        ("Conv", {"w": rng.normal(0, 0.2, (16, 8, 3, 3)).astype(np.float32)}),
        ("Relu", {}),
        ("MaxPool", {"kernel": (2, 2), "strides": (2, 2)}),
        ("Flatten", {}),
        ("Gemm", {"w": rng.normal(0, 0.1, (12, 400)).astype(np.float32)}),
    ]
    return build_onnx_sequential(ops, (1, 1, 28, 28))


def tf_demo_graph() -> bytes:
    """TfImportTrain's frozen GraphDef: conv, relu, a residual conv, a global
    mean, reshape and the logits MatMul (input (1, 28, 28, 1), NHWC)."""
    import numpy as np

    from mandheling_tpu_torch.utils import tf_graphdef as G

    rng = np.random.default_rng(0)
    F = np.float32
    DT = ("dtype", G.DT_FLOAT)

    def const(name, arr):
        return (name, "Const", [], {"dtype": DT, "value": np.asarray(arr, F)})

    return G.build_graphdef([
        ("input", "Placeholder", [], {"dtype": DT}),
        const("w0", rng.normal(0, 0.2, (5, 5, 1, 8)).astype(F)),
        ("conv0", "Conv2D", ["input", "w0"],
         {"strides": [1, 1, 1, 1], "padding": "SAME"}),
        ("relu0", "Relu", ["conv0"], {}),
        const("w1", rng.normal(0, 0.2, (3, 3, 8, 8)).astype(F)),
        ("conv1", "Conv2D", ["relu0", "w1"],
         {"strides": [1, 1, 1, 1], "padding": "SAME"}),
        ("res", "AddV2", ["conv1", "relu0"], {}),
        ("relu1", "Relu", ["res"], {}),
        const("axes", np.asarray([1, 2], np.int32)),
        ("gap", "Mean", ["relu1", "axes"], {"keep_dims": True}),
        const("shape", np.asarray([-1, 8], np.int32)),
        ("flat", "Reshape", ["gap", "shape"], {}),
        const("wf", rng.normal(0, 0.1, (8, 12)).astype(F)),
        ("logits", "MatMul", ["flat", "wf"], {"transpose_b": False}),
    ])


def caffe_demo_net() -> bytes:
    """CaffeImportTrain's binary caffemodel: conv + in-place ReLU, conv + BN +
    Scale, an Eltwise residual, global average pool and the InnerProduct
    logits (input (1, 1, 28, 28), NCHW)."""
    import numpy as np

    from mandheling_tpu_torch.utils.caffe_model import build_caffemodel

    rng = np.random.default_rng(0)
    F = np.float32
    layers = [
        ("conv0", "Convolution", ["data"], ["c0"],
         {"num_output": 8, "kernel_size": 5, "pad": 2},
         [rng.normal(0, 0.2, (8, 1, 5, 5)).astype(F)]),
        ("relu0", "ReLU", ["c0"], ["c0"], {}, []),
        ("conv1", "Convolution", ["c0"], ["c1"],
         {"num_output": 8, "kernel_size": 3, "pad": 1},
         [rng.normal(0, 0.2, (8, 8, 3, 3)).astype(F)]),
        ("bn1", "BatchNorm", ["c1"], ["c1"], {"use_global_stats": 1},
         [np.zeros(8, F), np.ones(8, F), np.ones(1, F)]),
        ("sc1", "Scale", ["c1"], ["c1"], {"axis": 1},
         [rng.uniform(0.5, 1.5, 8).astype(F)]),
        ("res", "Eltwise", ["c1", "c0"], ["r"], {"operation": 1}, []),
        ("relu1", "ReLU", ["r"], ["r"], {}, []),
        ("gap", "Pooling", ["r"], ["g"], {"pool": 1, "global_pooling": 1}, []),
        ("fc", "InnerProduct", ["g"], ["logits"], {"num_output": 12},
         [rng.normal(0, 0.1, (12, 8)).astype(F)]),
    ]
    return build_caffemodel(layers, ["data"], [[1, 1, 28, 28]])


@demo("OnnxImportTrain")
def onnx_import_train(args):
    """turnModelToTrainable from ONNX: build a demo ONNX graph, import it
    as a trainable NITI model (utils/onnx_model.py), train a few steps."""
    from mandheling_tpu_torch.utils.onnx_model import niti_model_from_onnx

    model, _ = niti_model_from_onnx(onnx_demo_model(), device=args.device)
    print(f"imported {len(model.layers)} NITI layers from ONNX")
    _train_imported(args, model)


@demo("TfImportTrain")
def tf_import_train(args):
    """turnModelToTrainable from a TensorFlow frozen graph: build a demo
    GraphDef (residual block included), import it as a trainable NITI
    model (utils/tf_model.py), train a few steps."""
    from mandheling_tpu_torch.utils.tf_model import niti_model_from_graphdef

    model, _ = niti_model_from_graphdef(tf_demo_graph(), input_shape=(1, 28, 28, 1),
                                        device=args.device)
    print(f"imported {len(model.layers)} NITI layers from the frozen graph "
          f"({[type(l).__name__ for l in model.layers]})")
    _train_imported(args, model)


@demo("CaffeImportTrain")
def caffe_import_train(args):
    """turnModelToTrainable from a binary .caffemodel: build a demo net
    (conv+BN+Scale with in-place ReLUs, Eltwise residual), import it as a
    trainable NITI model (utils/caffe_model.py), train a few steps."""
    from mandheling_tpu_torch.utils.caffe_model import niti_model_from_caffemodel

    model, _ = niti_model_from_caffemodel(caffe_demo_net(), device=args.device)
    print(f"imported {len(model.layers)} NITI layers from the caffemodel "
          f"({[type(l).__name__ for l in model.layers]})")
    _train_imported(args, model)


@demo("TFLiteImportTrain")
def tflite_import_train(args):
    """turnModelToTrainable from TFLite: export a NITI LeNet (its weights
    drawn from torch's generator, seed 0) to a .tflite flatbuffer, re-import
    it as a trainable NITI model (utils/tflite_model.py), train a few steps."""
    from mandheling_tpu_torch.models import lenet_niti
    from mandheling_tpu_torch.utils.tflite_model import (niti_model_from_tflite,
                                                         tflite_from_sequential)

    src = _seeded(lenet_niti(), 0)
    buf = tflite_from_sequential(src, None, (64, 28, 28, 1))
    print(f"exported LeNet-NITI as TFLite ({len(buf)} bytes)")
    model, _ = niti_model_from_tflite(buf, device=args.device)
    print(f"imported {len(model.layers)} NITI layers from TFLite")
    _train_imported(args, model)


def _say(*args):
    """print, on rank 0 only."""
    from mandheling_tpu_torch.parallel import distributed

    if distributed.process_index() == 0:
        print(*args, flush=True)


def _start(args, model):
    """`model` on the run's device, from --params or torch's seed 0."""
    from mandheling_tpu_torch.device import resolve_device
    from mandheling_tpu_torch.utils.checkpoint import load_checkpoint
    from mandheling_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

    if args.params:
        load_jax_params(model, load_checkpoint(args.params, export_jax_params(model))[0])
    else:
        _seeded(model, 0)
    device = resolve_device(args.device)
    return model.to(device), device


@demo("DistributedNITITrain")
def distributed_niti_train(args):
    """Data-parallel NITI training over the processes of the launch (JAX:
    over all devices): the global batch is 64 a process."""
    import numpy as np
    import torch

    from mandheling_tpu_torch.data import DataLoader, onehot_padded
    from mandheling_tpu_torch.models import NITI_LOGIT_CHANNELS, lenet_niti
    from mandheling_tpu_torch.parallel import (data_mesh, distributed, make_dp_eval_step,
                                               make_dp_train_step, replicate, shard_batch)

    distributed.initialize()
    n = distributed.process_count()
    mesh = data_mesh(n)
    _say(f"mesh: {n} devices, data-parallel")
    (x, y), (xt, yt) = _data(args.root)
    model, device = _start(args, lenet_niti())
    replicate(mesh, model)
    step = make_dp_train_step(model, mesh)
    evals = make_dp_eval_step(model, mesh)
    batch = 64 * n
    dl = DataLoader(x, y, batch, seed=0)
    for epoch in range(args.epochs):
        loss = None
        for bx, by in dl.epoch():
            oh = onehot_padded(by, 10, NITI_LOGIT_CHANNELS)
            loss = step(*(t.to(device) for t in shard_batch(mesh, bx, oh)))
        nt = (len(xt) // batch) * batch
        correct = 0
        for i in range(0, nt, batch):
            xs, ys = shard_batch(mesh, xt[i:i + batch].astype(np.float32),
                                 yt[i:i + batch].astype(np.int64))
            correct += int(evals(xs.to(device), ys.to(device)))
        _say(f"epoch {epoch}: loss {float(loss):.4f} test_acc {correct / max(nt, 1):.4f}")


def _pipe_stages(n: int) -> int:
    stages = 4 if n >= 4 else (2 if n >= 2 else 1)
    if stages != n:
        raise SystemExit(f"the pipeline demos run on 1, 2 or 4 processes, not {n}")
    return stages


@demo("PipelineNITITrain")
def pipeline_niti_train(args):
    """GPipe NITI training over the processes of the launch (stages 4, 2 or
    1): the homogeneous block stack, 4 microbatches x 64."""
    import numpy as np
    import torch

    from mandheling_tpu_torch.data import onehot_padded
    from mandheling_tpu_torch.parallel import (GPipePlan, distributed, homogeneous_blocks,
                                               make_gpipe_train_step, pipe_mesh,
                                               quantize_microbatches)

    distributed.initialize()
    stages = _pipe_stages(distributed.process_count())
    channels, blocks, micro, mb = 32, 2 * max(stages, 1), 4, 64
    mesh = pipe_mesh(n_stages=stages)
    _say(f"mesh: {stages} pipeline stages, {blocks} blocks, {micro} microbatches x {mb}")
    model, device = _start(args, homogeneous_blocks(blocks, channels))
    plan = GPipePlan(model, (mb, 1, 1, channels), n_stages=stages)
    step = make_gpipe_train_step(plan, mesh, n_microbatches=micro)
    rng = np.random.default_rng(0)
    wstar = rng.normal(0, 1, (channels, 10))
    for it in range(args.epochs * 8):
        xf = rng.normal(0, 1, (micro * mb, 1, 1, channels)).astype(np.float32)
        labels = np.argmax(xf.reshape(-1, channels) @ wstar, axis=1)
        oh = onehot_padded(labels, 10, channels).reshape(micro, mb, channels)
        x_d, x_e = quantize_microbatches(torch.from_numpy(xf).to(device), micro)
        loss = step(x_d, x_e, torch.from_numpy(oh).to(device))
        if it % 8 == 0:
            _say(f"iter {it}: loss {float(loss):.4f}")
    _say(f"final loss: {float(loss):.4f}")


@demo("GPipeLeNetTrain")
def gpipe_lenet_train(args):
    """General pipeline parallelism: the NITI LeNet staged over the
    processes of the launch (heterogeneous stages), 2 microbatches x 32."""
    import numpy as np
    import torch

    from mandheling_tpu_torch.data import onehot_padded
    from mandheling_tpu_torch.models import NITI_LOGIT_CHANNELS, lenet_niti
    from mandheling_tpu_torch.parallel import (GPipePlan, distributed, make_gpipe_train_step,
                                               pipe_mesh, quantize_microbatches)

    distributed.initialize()
    stages = _pipe_stages(distributed.process_count())
    micro, mb = 2, 32
    mesh = pipe_mesh(n_stages=stages)
    model, device = _start(args, lenet_niti())
    plan = GPipePlan(model, (mb, 28, 28, 1), n_stages=stages)
    _say(f"mesh: {stages} stages, layer bounds {plan.bounds}, {micro} microbatches x {mb}")
    step = make_gpipe_train_step(plan, mesh, n_microbatches=micro)
    (x, y), _ = _data(args.root)
    for it in range(args.epochs * 8):
        i0 = (it * micro * mb) % (len(x) - micro * mb)
        xf = torch.from_numpy(x[i0:i0 + micro * mb].astype(np.float32)).to(device)
        oh = onehot_padded(y[i0:i0 + micro * mb], 10, NITI_LOGIT_CHANNELS)
        x_d, x_e = quantize_microbatches(xf, micro)
        loss = step(x_d, x_e, torch.from_numpy(oh).to(device).reshape(micro, mb, -1))
        if it % 8 == 0:
            _say(f"iter {it}: loss {float(loss):.4f}")
    _say(f"final loss: {float(loss):.4f}")


@demo("NnGradTest")
def nn_grad_test(args):
    """Gradient correctness check (reference nnGradTest.cpp / DEBUG_GRAD
    dumps): compares the integer conv gradients' int32 accumulators against
    float64 references and prints max deltas."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mandheling_tpu_torch.device import resolve_device
    from mandheling_tpu_torch.ops import conv as conv_ops

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    x = rng.integers(-30, 30, (4, 12, 12, 8)).astype(np.int8)
    w = rng.integers(-30, 30, (5, 5, 8, 16)).astype(np.int8)
    gy = rng.integers(-30, 30, (4, 8, 8, 16)).astype(np.int8)

    def dev(a):
        return torch.from_numpy(a).to(device)

    acc_dx = conv_ops.conv2d_input_grad_acc(dev(gy), dev(w), (12, 12)).cpu().numpy()
    acc_dw = conv_ops.conv2d_filter_grad_acc(dev(x), dev(gy), (5, 5)).cpu().numpy()

    xf, wf, gyf = (a.astype(np.float64) for a in (x, w, gy))
    # the input grad is the full correlation of gy with the rotated,
    # io-swapped weights: NHWC / HWIO -> NCHW / OIHW for F.conv2d
    w_rot = np.flip(wf, (0, 1)).transpose(0, 1, 3, 2)
    dx_ref = F.conv2d(torch.from_numpy(gyf).permute(0, 3, 1, 2),
                      torch.from_numpy(np.ascontiguousarray(w_rot)).permute(3, 2, 0, 1),
                      padding=4).permute(0, 2, 3, 1).numpy()
    print("input-grad max |delta| vs float conv:", float(np.max(np.abs(acc_dx - dx_ref))))
    dw_direct = np.zeros((5, 5, 8, 16))
    for dy in range(5):
        for dxx in range(5):
            dw_direct[dy, dxx] = np.einsum("bhwi,bhwo->io", xf[:, dy:dy + 8, dxx:dxx + 8, :], gyf)
    delta = float(np.max(np.abs(acc_dw - dw_direct)))
    print("filter-grad max |delta| vs einsum:", delta)
    print("PASS" if delta == 0 else "FAIL")


@demo("DataLoaderDemo")
def dataloader_demo(args):
    from mandheling_tpu_torch.data import DataLoader, load_or_synthesize

    x, y, real = load_or_synthesize(args.root, train=True)
    print(f"dataset: {len(x)} images ({'real MNIST' if real else 'synthetic'})")
    dl = DataLoader(x, y, 64, seed=0)
    for i, (bx, by) in enumerate(dl.epoch()):
        if i < 3:
            print(f"batch {i}: images {bx.shape} {bx.dtype}, "
                  f"labels {by.shape}, first labels {by[:8]}")
    print(f"{len(dl)} batches/epoch")


def linear_regression_data(device):
    """LinearRegression's data, y = 3x + 1.5 + 0.01 noise at 256 points,
    drawn from torch's generator at seed 0, and its (w, b) at 0."""
    import torch

    gen = torch.Generator().manual_seed(0)
    xs = torch.randn((256, 1), generator=gen).to(device)
    ys = 3.0 * xs + 1.5 + 0.01 * torch.randn((256, 1), generator=gen).to(device)
    return xs, ys, torch.zeros((1, 1), device=device), torch.zeros((1,), device=device)


def make_linear_regression_step(w, b):
    """LinearRegression's step, step(xs, ys) -> loss: the mean squared
    error of xs @ w + b against ys and one gradient-descent update of w and
    b in place at rate 0.1 (the JAX CLI's jitted step returns them new)."""
    import torch

    def step(xs, ys):
        with torch.enable_grad():
            wg, bg = w.detach().requires_grad_(), b.detach().requires_grad_()
            loss = torch.mean((xs @ wg + bg - ys) ** 2)
            gw, gb = torch.autograd.grad(loss, (wg, bg))
        with torch.no_grad():
            w.sub_(0.1 * gw)
            b.sub_(0.1 * gb)
        return loss.detach()

    return step


@demo("LinearRegression")
def linear_regression(args):
    """The reference's sanity demo (demo/linearRegression.cpp): fit y=ax+b
    by gradient descent (data drawn from torch's generator, seed 0), the
    step compiled as the JAX CLI jits it."""
    from mandheling_tpu_torch.device import resolve_device
    from mandheling_tpu_torch.train.step_graph import compile_step

    device = resolve_device(args.device)
    xs, ys, w, b = linear_regression_data(device)
    step = compile_step(make_linear_regression_step(w, b), device)
    for _ in range(200):
        loss = step(xs, ys)
    print(f"fit: a={float(w[0, 0]):.3f} b={float(b[0]):.3f} loss={float(loss):.6f}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("demo", choices=sorted(DEMOS), nargs="?")
    parser.add_argument("root", nargs="?", default=None,
                        help="MNIST idx-file (or CIFAR-10 bin) root dir")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--snapshot", default=None)
    parser.add_argument("--images-txt", default=None,
                        help="label txt for MobilenetV2Transfer's ImageDataset")
    parser.add_argument("--device", default=None,
                        help="torch device; default: the GPU (cpu: the plain versions, for tests)")
    parser.add_argument("--params", default=None,
                        help="the parallel demos' start: a JAX-layout checkpoint")
    args = parser.parse_args(argv)
    if not args.demo:
        print("available demos:")
        for name in sorted(DEMOS):
            print(" ", name)
        return
    try:
        DEMOS[args.demo](args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
