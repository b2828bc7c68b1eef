#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mandheling_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each of which
raises on failure (the script then exits non-zero and prints no result):

1. the card's name and power limit (nvidia-smi);
2. build every kernel from csrc/ with nvcc for sm_90a, one process per
   source, all started together;
3. each kernel against its plain PyTorch version on the card, byte for byte,
   at the shapes the training steps give it: K1 (matmul_int8) at the 11
   contractions of a batch-64 LeNet step, each in the operand layout the
   step gives it (K1_SHAPES), K2 (fused_matmul_max / _requant)
   at the fc2 input grad of batch 2048 and at a shape of the JAX package's
   tiled branch (K > 512), K3 (fused_conv_max / _requant) at the MobileNetV2
   stem, LeNet's convs, the seven ResNet18 b256 3x3 shapes its `supports`
   admits and the 17 shapes SqueezeNet b128 and Inception-v3 b32 give it
   under "all" (beside each, the cuDNN fp32 conv and the non-fused route of
   fused mode "matmul_only", whose bytes phase 2 must equal), K4 (fused_dwconv_max / _requant) at the 10
   depthwise shapes of a batch-256 MobileNetV2 step (x unpadded with its
   pads; the strided input grads' gy undilated with the stride as the
   dilation), each per-tensor and with the recipe's per-channel shifts,
   with w as given and rotated; K3 and K4 also at the JAX package's test
   shapes and at ragged ones (K4 at each channel class, C % 16 = 0, C % 4 =
   0 only and ragged, each map class, a row count that is not a multiple of
   a thread's run of rows, dilation 2, shifts 0..12 on all -128 operands,
   and kernel sizes other than 3x3); K5 (fused_dwconv_fgrad) at the 10
   depthwise filter-grad shapes of that step (x unpadded with its pads; 7 at
   stride 1, 3 at stride 2), the JAX test shape, ragged C, strides on ragged
   C and odd maps, 5x5 and 3x1 kernels and cases whose sums wrap past 2^31 at
   strides 1 and 2, each called twice (the second call equal to the first);
   kernel, plain, library and bound times; K7 (requant_int32_absmax /
   _requant) at every non-fused requant site of a train step of the
   benchmark's models (the MobileNetV2 recipe and ResNet-18 at batch 256,
   rehearsed on the meta device), each in its form, mode and activation,
   both phases, beside the plain chain's time, the byte bound and phase 2's
   CUDA-core floor; K8 against its plain versions at every pool and concat
   site of an Inception-v3 train step at 299, batch 32 (rehearsed on the
   meta device), beside the plain chains' time and the byte bound;
4. LeNet's main path at batch 64: `train_niti` on the card with the kernels,
   launch counts reset just before and read just after; then the same steps
   from the same params with the plain versions on the card and on the CPU.
   Params must be byte-identical across the three, losses within 1e-5;
5. the same at batch 2048, where the fc2 input grad takes the fused route
   (K2); then samples/s of the kernel path at both batches;
6. LeNet at batch 64 under fused mode "all" (K3 on conv1, conv2 and the
   conv2 input grad): kernels against plain on the card;
7. MobileNetV2 at full width through `train_niti(model=mobilenet_v2_niti())`
   on synthetic CIFAR: batch 256, kernels against plain on the card; batch
   32, kernels against plain on the CPU; batch 256 under fused mode "all";
   then samples/s at batch 256; then K1, its plain version and
   torch._int_mm (the library yardstick) at every shape and layout K1 takes
   in a batch-256 train step, and K2's two phases, their plain versions and
   bounds (phase 2's also on the CUDA cores) at every shape and layout K2
   takes there (K2_PATH_CASES), each warm and cold (operands rotated over
   more than the L2);
8. the r5 recipe, `mobilenet_v2_niti(dw_per_channel=True)` with filter-grad
   margins 0/0, at full width: batch 256, kernels against plain on the
   card (K4's shapes recorded and held to K4_PATH_CASES); batches 32 and 16
   (`MobilenetV2Train`'s), kernels against plain on the CPU;
9. the demo CLI `tools/run_train_demo_torch.py`: `MobilenetV2Train --epochs
   1` in this process, launches counted and the shapes of K1, K4 and K5 held to
   those of the batch-16 run of phase 8; then as processes of their own
   `MobilenetV2Train`, `NITIDSPInt8Train` and `MnistTrain` (one epoch) and
   `MnistTrainSnapshot` twice, the second resuming from the first's file;
10. the dot probe `tools/probes/dot_probe_torch.py`: K2's phase 1 (int8)
   and K6 (fused_matmul_max_bf16) at (49152, K) x (K, 512), K in {28, 128,
   256}, exactly equal to plain, and their times;
11. the NITI ResNet-18 through `train_niti(model=resnet18_niti())` on
   synthetic CIFAR: batch 256 under "matmul_only", kernels against plain on
   the card (K1's and K2's shapes recorded, K2's held to
   K2_RESNET18_CASES); batch 8 against the CPU; batch 256 under "all",
   against plain on the card, its K3 shapes held to K3_CASES; samples/s of
   batch 256 in both modes in turns; K1 (beside torch._int_mm), K2 and K3
   over one train step, weighted by the recording. ResNet-v2-50 (1000
   classes) at (16, 224, 224, 3): two train steps and one eval step through
   make_train_step / make_eval_step, kernels against plain on the card, and
   K2 at each shape it takes. The float twins ResNet18FP32 and
   MobileNetV2FP32: at batch 8 the card against the CPU (forwards and
   running stats in float32, trainer steps in float64), and samples/s of
   `train_fp32_bn` at batch 256 (TF32 off). Then tools/test_train_torch.py
   on resnet18_niti, batch 64, 50 steps, as a process of its own: its
   record must parse, its PASS or FAIL is reported;
12. the zoo, 1000 classes, through make_train_step / make_eval_step:
   SqueezeNet v1.0 at (128, 224, 224, 3) and Inception-v3 at (32, 299, 299,
   3), two train steps and one eval step in "matmul_only" and in "all",
   kernels against plain on the card (the shapes of K1, K2 and K3
   recorded; under "all" K3's held to K3_CASES, whose zoo shapes phase 3
   checked and timed beside cuDNN fp32 and the non-fused route); each at
   batch 2 and full size under "all" against the CPU; samples/s of batch
   128 / 32 in both modes in turns; K1, K2 and K3 over one train step,
   weighted by the recording, with their bounds. Then SqueezeNet with 10
   classes through `train_niti` on synthetic CIFAR (batch 64, one epoch)
   against the CPU;
13. MobileNetV2 with int16 projection outputs, `mobilenet_v2_niti(
   proj_bits=15)`, at full width through `train_niti`: batch 256 kernels
   against plain on the card (the int16-A route's shapes recorded), batch 32
   against the CPU; K1's int16-A route against its plain version at every
   shape and layout of that step, timed beside K1's int8 route at the same
   shapes, and at the extremes of both types (+-32767, -32768, 127, -128)
   with sums that wrap past 2^31 and 2^32, in both layouts;
14. QAT, distillation and transfer training: the int8 softmax forward and
   grad at LeNet's logits (b64 x 12) at every ascale in -9..15, card against
   CPU byte for byte, and matmul_int8_forward / matmul_int8_grad through K1
   against the plain version on the card at the fc shapes (LeNet's 832->500
   and 500->12 at b64, MobileNetV2's 1280->12 at b256); MnistInt8Train's
   LeNetQAT (3 SGD steps at lr_inv(0.01, step)) and DistillTrainQuant (one
   teacher and 3 student steps) in float64, card against CPU within 1e-9 of
   each tensor's largest magnitude, and LeNetQAT's float32 samples/s at b64;
   MobilenetV2Transfer at full width (mnv2_transfer_model: MobileNetV2
   frozen up to its global pool, a NITIConv2D(1280, 12) head), 3 train steps
   and 1 eval step through make_transfer_train_step / _eval_step at b256 in
   "matmul_only" and "all", kernels against plain on the card, and at b32
   against the CPU: head params byte-identical, the features byte-unchanged
   (the shapes of K1, K2 and K4 recorded); K1, K2 and K4 over one transfer
   step with their bounds; samples/s of the transfer step and the full
   MobileNetV2 train step in turns; the demos MnistInt8Train,
   DistillTrainQuant, MobilenetV2Transfer, QuanByMSE and LinearRegression
   as processes of their own (the first two and the last step through
   compile_step). Phase 12 also times torch._int_mm at the row-major K1 shapes
   of the zoo's steps, beside K1;
15. imported models: full-width NITI ResNet-18 and MobileNetV2 built from
   seeded params, exported by the port's `tflite_from_sequential` at
   (256, 32, 32, 3) and imported by `tools/import_model_torch.py` as a
   process of its own (on the card) into a checkpoint, which must hold the
   built weights; 2 train steps and 1 eval step of the imported model through
   make_train_step / make_eval_step at batch 256 in "matmul_only" and "all",
   kernels against plain on the card and against the built model from the
   same params (params, losses and correct counts byte-identical, the same
   launches, the built model's EXPECTED_PER_STEP rows); the imported model
   at batch 8 (ResNet-18) and 32 (MobileNetV2) against the CPU; samples/s of
   the train step in turns, built and imported; then the demos
   OnnxImportTrain, TfImportTrain, CaffeImportTrain and TFLiteImportTrain as
   processes of their own on the card and with --device cpu (the same
   printed lines), and the ONNX, TF and Caffe demo files through
   `import_model_torch.py --check` on both (the same lines and checkpoints);
16. parallelism (mandheling_tpu_torch/parallel), the ranks gloo processes
   that share cuda:0 (started by `parallel.distributed.run_local`, each
   group with its own timeout; a rank that raises or hangs fails the
   phase): (a) DP LeNet, world 2, global batch 128, 2 train steps and one
   eval step, byte-equal to one process on the card and to the CPU gloo run
   of the plain versions; (b) DP full-width MobileNetV2 under the r5 recipe,
   world 2, global batch 256, 2 steps in "matmul_only" and in "all", equal
   to one process on the card; (c) the int8 wire on (a), equal to the CPU
   gloo run; (d) TP `lenet_niti_tp` on a 2x2 mesh, batch 64, equal to the
   CPU gloo run and to one process; (e) GPipe LeNet, 2 stages, M = 2, equal
   to the CPU gloo run. Each DP rank's launches are one process's at its
   local batch (EXPECTED_PER_STEP); one line a run gives each rank's wall ms
   a step, its collectives a step and their host ms, and its launches;
17. the compiled step (train/step_graph.py): `jit_train_step` /
   `jit_eval_step` (the transfer steps through `compile_step`), each step a
   CUDA graph captured at its first call and replayed, against the eager
   steps at full width: NITI LeNet b64 and b2048, MobileNetV2 b256
   per-tensor and the r5 recipe, ResNet-18 b256 in "matmul_only" and "all",
   Inception-v3 b32 at 299 (1000 classes) in both modes, MobilenetV2Transfer
   b256: 20 train steps and 2 eval steps each way from the same params on
   the same batches, params, losses and counts byte-identical, 2 compiled
   steps byte-identical to 2 of the plain versions on the card, every
   replayed step's launches the EXPECTED_PER_STEP rows, ms per step eager
   and replayed in turns (A B B A); ResNet18FP32 b256 through
   `train_fp32_bn`'s float step (its lr a 0-d tensor), bitwise or within
   1e-5 (printed which); `train_niti` for 2 epochs of LeNet through the
   graphs against the eager loop (its jit steps swapped for the eager
   ones), the same log lines and params. One line a configuration; each one's graphs are freed before the
   next;
18. the rest of the JAX package: (A) MnistInt8Train's step,
   DistillTrainQuant's teacher and student steps, MnistInt8Train's predict
   and LinearRegression's step, 20 calls each through `compile_step`
   (dropout on, its CUDA generator registered with the graph) against 20
   eager calls from the same seeds under `cudnn.deterministic`: outputs and
   state bitwise equal, one graph; ms per step in turns; (B) the per-op profile
   (`utils/profiler.trace_device_events`, `utils/device_trace`) of 3
   replays of the compiled LeNet b64 and MNv2 b256 steps: each launch
   counter's kernels `EXPECTED_PER_STEP` x 3, the rows' device time within
   5% of the traced busy time; `flops_per_step` of the step's eager form
   on the card equal to the meta device's in both fused modes; (C) DP
   LeNet over `make_global_mesh` as 2 hosts x 2 gloo ranks on cuda:0, equal to one process, each rank's step ms;
   (D) `build_native()`, and where it built, its loader's batches against
   the Python DataLoader's (where it did not, printed, no failure);
19. one JSON line listing every kernel, then the result line.

If a phase fails, the script prints `chip_smoke: failed in phase N (...)`
on standard output (phase 0 is the imports) and the exception propagates:
the exit code is 1 and no result line is printed.

Every main-path run asserts its launch counts, per kernel, against the
routes one train step and one eval step take (EXPECTED_PER_STEP). The
shapes of K1's launches in the LeNet batch-64 run and of K1's, K4's and
K5's in the MobileNetV2 batch-256 run (K4's and K5's also in the recipe's)
are recorded, and K2's there with their operand layouts; K4's and K5's must
be the shapes phase 3 checked, K2's those of K2_PATH_CASES, and the
per-step counts weight the timings of K1, K2, K4 and K5 into the sums of
one train step (K4's per-channel timings into the recipe's).

Under "all", ResNet-18's K1 launches are a subset of its "matmul_only"
shapes and are weighted from the same timings.

The last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import importlib.util
import io
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The phase the script is in. An exception that ends the script names it on
# standard output first, then propagates as ever (exit code 1).
PHASE = "0 (imports)"
T_START = time.perf_counter()


def _name_the_phase(exc_type, exc, tb):
    print(f"chip_smoke: failed in phase {PHASE}", flush=True)
    sys.__excepthook__(exc_type, exc, tb)


if __name__ == "__main__":
    sys.excepthook = _name_the_phase

import numpy as np
import torch

from mandheling_tpu_torch.data import (DataLoader, load_or_synthesize_cifar, synthetic_cifar,
                                       synthetic_mnist)
from mandheling_tpu_torch.data import native as native_mod
from mandheling_tpu_torch.models import (NITI_LOGIT_CHANNELS, NUM_CLASSES, LeNetFP32,
                                         MobileNetV2FP32, ResNet18FP32, inceptionv3_niti,
                                         lenet_niti, mobilenet_v2_niti, resnet18_niti,
                                         resnet50v2_niti, squeezenet_niti)
from mandheling_tpu_torch.models.lenet_qat import LeNetQAT
from mandheling_tpu_torch.ops import matmul as matmul_ops
from mandheling_tpu_torch.ops import softmax as softmax_ops
from mandheling_tpu_torch.ops import conv as conv_ops
from mandheling_tpu_torch.ops import depthwise as dw_ops
from mandheling_tpu_torch.ops import numerics
from mandheling_tpu_torch.ops import kernels
from mandheling_tpu_torch.ops.conv import use_fused_conv_mode
from mandheling_tpu_torch.ops.kernels import (build, fused_conv_int8, fused_dwconv_int8,
                                              fused_matmul_int8, matmul_int8, pool_concat_int8,
                                              requant_int32)
from mandheling_tpu_torch.parallel import distributed, quantize_microbatches, tp
from mandheling_tpu_torch.parallel import runs as runs_mod
from mandheling_tpu_torch.data.loader import onehot_padded
from mandheling_tpu_torch.train import (jit_eval_step, jit_train_step, make_eval_step,
                                        make_train_step, step_graph)
from mandheling_tpu_torch.train.optim import lr_inv, sgd_init
from mandheling_tpu_torch.train.qat_train import (make_distill_step, make_predict_step,
                                                  make_qat_train_step, make_teacher_step)
from mandheling_tpu_torch.train import trainer as trainer_mod
from mandheling_tpu_torch.train.trainer import (full_float32, make_float_eval_step,
                                                make_float_step, train_fp32_bn, train_niti)
from mandheling_tpu_torch.train.transfer import (TransferModel, make_transfer_eval_step,
                                                 make_transfer_train_step, transfer_from)
from mandheling_tpu_torch.utils import device_trace, profiler
from mandheling_tpu_torch.utils.checkpoint import load_checkpoint
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params
from mandheling_tpu_torch.utils.tflite_model import niti_model_from_tflite, tflite_from_sequential

ROOT = Path(__file__).resolve().parent


def enter(phase: str, what: str) -> None:
    """Record the phase the script is in and announce it, with the seconds
    since the script started."""
    global PHASE
    PHASE = f"{phase} ({what})"
    print(f"phase {phase}: {what} (at {time.perf_counter() - T_START:.1f} s)", flush=True)
SAME3 = ((1, 1), (1, 1))

# (what, M, K, N, A's layout, B's layout) of every int8 contraction of a
# LeNet train step at batch 64, the layouts as matmul_int8.layout classes
# them: A "k" (k contiguous) or "m" (the filter grads' im2col(x)^T view); B
# "n" (HWIO weights, gy) or "k" (the rot180 / io-swapped weights).
K1_SHAPES = [
    ("conv1 fwd", 36864, 25, 20, "k", "n"),
    ("conv2 fwd", 4096, 500, 52, "k", "n"),
    ("fc1 fwd", 64, 832, 500, "k", "n"),
    ("fc2 fwd", 64, 500, 12, "k", "n"),
    ("fc2 igrad", 64, 12, 500, "k", "k"),
    ("fc2 fgrad", 500, 64, 12, "m", "n"),
    ("fc1 igrad", 64, 500, 832, "k", "k"),
    ("fc1 fgrad", 832, 64, 500, "m", "n"),
    ("conv2 igrad", 9216, 1300, 20, "k", "n"),
    ("conv2 fgrad", 500, 4096, 52, "m", "n"),
    ("conv1 fgrad", 25, 36864, 20, "m", "n"),
]
K2_SHAPE = ("fc2 igrad b2048", 2048, 12, 500)
# K > 512: a shape of the JAX package's tiled branch (matmul_max_pallas /
# matmul_requant_pallas past `_small_max`), which `supports` keeps off the
# main path; timed beside the main path's shape.
K2_TILED_SHAPE = ("tiled branch, fc1 fwd widths b2048", 2048, 832, 500)
# K2's calls in a batch-256 MobileNetV2 train or eval step, (M, K, N, A's
# layout, B's layout): the 1x1 forwards (B "n") and input grads (B "k") that
# `supports` takes. The run records them and holds them to this list.
K2_PATH_CASES = [
    (16384, 64, 192, "k", "k"), (16384, 64, 384, "k", "k"), (16384, 64, 384, "k", "n"),
    (16384, 96, 384, "k", "k"), (16384, 192, 64, "k", "n"), (16384, 384, 64, "k", "k"),
    (16384, 384, 64, "k", "n"), (16384, 384, 96, "k", "n"), (65536, 32, 144, "k", "k"),
    (65536, 32, 192, "k", "k"), (65536, 32, 192, "k", "n"), (65536, 144, 32, "k", "n"),
    (65536, 192, 32, "k", "k"), (65536, 192, 32, "k", "n"), (262144, 16, 32, "k", "k"),
    (262144, 16, 96, "k", "n"), (262144, 24, 96, "k", "k"), (262144, 24, 144, "k", "k"),
    (262144, 24, 144, "k", "n"), (262144, 32, 16, "k", "n"), (262144, 96, 16, "k", "k"),
    (262144, 96, 24, "k", "n"), (262144, 144, 24, "k", "k"), (262144, 144, 24, "k", "n"),
]
# Integer operations of one output of K2's psto epilogue (niti_epilogue.cuh
# psto_round and the int8 cast, the terms that depend only on the shift
# hoisted), counted from the source: phase 2's floor on the CUDA cores.
PSTO_INT_OPS = 25
# Operand copies rotated over more than this many bytes for a time with a
# cold L2 (the H100's is 50 MB).
COLD_BYTES = 64 * 2**20
K1_PER_TRAIN_STEP, K1_PER_EVAL_STEP = 11, 4

# K3: (what, x shape, w shape, stride, pads). The first four are the
# main paths' shapes (the MobileNetV2 stem under fused mode "all"; LeNet's
# conv1, conv2 and conv2 input grad, on the zero-dilated gy with the
# rotated weights, under "all"); then the shapes of the JAX package's
# test_fused_conv_strided_and_1x1_parity, a ragged one, and the shapes
# ResNet18's 3x3 convs will give it under "all".
K3_CASES = [
    ("MNv2 stem fwd b256", (256, 32, 32, 3), (3, 3, 3, 32), (1, 1), ((1, 1), (1, 1))),
    ("LeNet conv1 fwd b64", (64, 28, 28, 1), (5, 5, 1, 20), (1, 1), ((0, 0), (0, 0))),
    ("LeNet conv2 fwd b64", (64, 12, 12, 20), (5, 5, 20, 52), (1, 1), ((0, 0), (0, 0))),
    ("LeNet conv2 igrad b64", (64, 8, 8, 52), (5, 5, 52, 20), (1, 1), ((4, 4), (4, 4))),
    ("JAX test 3x3 s2", (2, 9, 9, 3), (3, 3, 3, 8), (2, 2), ((0, 1), (0, 1))),
    ("JAX test 5x5 s2", (2, 9, 9, 3), (5, 5, 3, 8), (2, 2), ((1, 2), (1, 2))),
    ("JAX test 33x33 s2", (2, 33, 33, 8), (3, 3, 8, 16), (2, 2), ((1, 1), (1, 1))),
    ("ragged 3x2 s(1,2)", (1, 7, 5, 70), (3, 2, 70, 65), (1, 2), ((2, 0), (0, 3))),
] + [  # ResNet18's CIFAR 3x3 convs at b256 that `supports` admits (its 512 -> 512 it refuses)
    (f"ResNet18 {what} b256", xs, ws, st, pads) for what, xs, ws, st, pads in [
        ("stem 3->64", (256, 32, 32, 3), (3, 3, 3, 64), (1, 1), ((1, 1), (1, 1))),
        ("layer1 64->64", (256, 32, 32, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1))),
        ("layer2 s2 64->128", (256, 32, 32, 64), (3, 3, 64, 128), (2, 2), ((0, 1), (0, 1))),
        ("layer2 128->128", (256, 16, 16, 128), (3, 3, 128, 128), (1, 1), ((1, 1), (1, 1))),
        ("layer3 s2 128->256", (256, 16, 16, 128), (3, 3, 128, 256), (2, 2), ((0, 1), (0, 1))),
        ("layer3 256->256", (256, 8, 8, 256), (3, 3, 256, 256), (1, 1), ((1, 1), (1, 1))),
        ("layer4 s2 256->512", (256, 8, 8, 256), (3, 3, 256, 512), (2, 2), ((0, 1), (0, 1))),
    ]
] + [  # the zoo under "all": SqueezeNet v1.0 at b128 (224x224), Inception-v3 at b32 (299x299)
    (f"SqueezeNet {what} b128", xs, ws, st, pads) for what, xs, ws, st, pads in [
        ("stem 7x7 s2 3->96", (128, 224, 224, 3), (7, 7, 3, 96), (2, 2), ((2, 3), (2, 3))),
        ("fire2/3 expand3 16->64", (128, 55, 55, 16), (3, 3, 16, 64), (1, 1), SAME3),
        ("fire4 expand3 32->128", (128, 55, 55, 32), (3, 3, 32, 128), (1, 1), SAME3),
        ("fire5 expand3 32->128", (128, 27, 27, 32), (3, 3, 32, 128), (1, 1), SAME3),
        ("fire6/7 expand3 48->192", (128, 27, 27, 48), (3, 3, 48, 192), (1, 1), SAME3),
        ("fire8 expand3 64->256", (128, 27, 27, 64), (3, 3, 64, 256), (1, 1), SAME3),
        ("fire9 expand3 64->256", (128, 13, 13, 64), (3, 3, 64, 256), (1, 1), SAME3),
    ]
] + [
    (f"Inception-v3 {what} b32", xs, ws, st, pads) for what, xs, ws, st, pads in [
        ("stem 3x3 s2 3->32", (32, 299, 299, 3), (3, 3, 3, 32), (2, 2), ((0, 0), (0, 0))),
        ("A 3x3 64->96", (32, 35, 35, 64), (3, 3, 64, 96), (1, 1), SAME3),
        ("C 1x7 128->128", (32, 17, 17, 128), (1, 7, 128, 128), (1, 1), ((0, 0), (3, 3))),
        ("C 1x7 128->192", (32, 17, 17, 128), (1, 7, 128, 192), (1, 1), ((0, 0), (3, 3))),
        ("C 1x7 160->160", (32, 17, 17, 160), (1, 7, 160, 160), (1, 1), ((0, 0), (3, 3))),
        ("C 1x7 160->192", (32, 17, 17, 160), (1, 7, 160, 192), (1, 1), ((0, 0), (3, 3))),
        ("C/D 1x7 192->192", (32, 17, 17, 192), (1, 7, 192, 192), (1, 1), ((0, 0), (3, 3))),
        ("C 1x7 igrad 192->128", (32, 17, 17, 192), (1, 7, 192, 128), (1, 1), ((0, 0), (3, 3))),
        ("C 1x7 igrad 192->160", (32, 17, 17, 192), (1, 7, 192, 160), (1, 1), ((0, 0), (3, 3))),
        ("E 1x3 384->384", (32, 8, 8, 384), (1, 3, 384, 384), (1, 1), ((0, 0), (1, 1))),
    ]
]
K3_KEYS = {(xs, ws, stride, pads) for _, xs, ws, stride, pads in K3_CASES}
# K2's calls in a batch-256 ResNet-18 train or eval step, (M, K, N, A's
# layout, B's layout): the three strided 1x1 projections (B "n") and their
# input grads (B "k"), whose accumulators `supports` takes from 2 MB on.
K2_RESNET18_CASES = [
    (4096, 256, 512, "k", "n"), (16384, 128, 256, "k", "n"), (16384, 512, 256, "k", "k"),
    (65536, 64, 128, "k", "n"), (65536, 256, 128, "k", "k"), (262144, 128, 64, "k", "k"),
]
# K4: (what, x shape, kernel size, pads, dilation). K4_PATH_CASES are the
# depthwise calls of a batch-256 MobileNetV2 step, per-tensor and under the
# recipe alike (the stride-1 forwards and input grads at SAME pads; the input
# grads of the three stride-2 layers on their undilated gy, dilation 2),
# which the runs record and hold to this list; then the JAX package's test
# shape, each channel class (C % 16 = 0 is the path's; C % 4 = 0 only; ragged
# C, which the untiled byte-wise instance takes), output rows that are not a
# multiple of a thread's run of 16, and kernel sizes other than 3x3 (the
# untiled instance too), with pads and dilations. K4_SATURATED: all -128 operands with per-channel
# shifts 0..12 (the 3x3 cap): |acc| 147456 << 12, the largest the recipe
# allows.
K4_PATH_CASES = [
    ("MNv2 b256 32ch 32x32", (256, 32, 32, 32), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 96ch 32x32", (256, 32, 32, 96), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 144ch 32x32", (256, 32, 32, 144), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 192ch 16x16", (256, 16, 16, 192), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 384ch 8x8", (256, 8, 8, 384), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 576ch 8x8", (256, 8, 8, 576), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 960ch 4x4", (256, 4, 4, 960), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 144ch igrad s2 to 32x32", (256, 16, 16, 144), (3, 3), ((2, 1), (2, 1)), (2, 2)),
    ("MNv2 b256 192ch igrad s2 to 16x16", (256, 8, 8, 192), (3, 3), ((2, 1), (2, 1)), (2, 2)),
    ("MNv2 b256 576ch igrad s2 to 8x8", (256, 4, 4, 576), (3, 3), ((2, 1), (2, 1)), (2, 2)),
]
K4_SATURATED = ("all -128, shifts 0..12", (3, 13, 11, 48), (3, 3), SAME3, (1, 1))
K4_CASES = K4_PATH_CASES + [
    ("JAX test (4,16,16,24)", (4, 16, 16, 24), (3, 3), SAME3, (1, 1)),
    ("C 20 (C % 4 only), 13x11", (3, 13, 11, 20), (3, 3), SAME3, (1, 1)),
    ("ragged C 33, 43 columns", (3, 9, 43, 33), (3, 3), SAME3, (1, 1)),
    ("ragged C 7, SAME s2 igrad pads (0, 1)", (2, 7, 9, 7), (3, 3), ((1, 2), (1, 2)), (2, 2)),
    ("C 36, dilation 2, pads (2, 1)", (2, 5, 6, 36), (3, 3), ((2, 1), (2, 1)), (2, 2)),
    ("C 40, 20x37 rows", (2, 20, 37, 40), (3, 3), ((0, 1), (1, 0)), (1, 1)),
    ("ragged C 7, 5x5", (2, 9, 9, 7), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ("C 24, 5x5, dilation 2", (2, 6, 5, 24), (5, 5), ((3, 2), (2, 3)), (2, 2)),
    ("C 40, 3x1", (2, 12, 40, 40), (3, 1), ((1, 1), (0, 0)), (1, 1)),
    K4_SATURATED,
]
# K5: (what, x shape, kernel size, pads, stride); x is read unpadded with its
# pads, and gy is the VALID strided output of the padded x. K5_PATH_CASES
# are the depthwise filter grads of a batch-256 MobileNetV2 train step,
# per-tensor and under the recipe alike (the 7 stride-1 shapes at SAME pads;
# the 3 stride-2 layers at their SAME pads (0, 1)), recorded and held to
# this list; then the JAX package's test shape, ragged C, kernel sizes other
# than 3x3 (the untiled instance), strides on ragged C and on odd maps, and
# cases whose sums wrap past 2^31 (all -128 and no pads: 147456 products of
# 2^14 per channel), at stride 1 (untiled, C 33) and 2 (packed, C 36).
S2_SAME = ((0, 1), (0, 1))
K5_PATH_CASES = [
    ("MNv2 b256 32ch 32x32", (256, 32, 32, 32), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 96ch 32x32", (256, 32, 32, 96), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 144ch 32x32", (256, 32, 32, 144), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 192ch 16x16", (256, 16, 16, 192), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 384ch 8x8", (256, 8, 8, 384), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 576ch 8x8", (256, 8, 8, 576), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 960ch 4x4", (256, 4, 4, 960), (3, 3), SAME3, (1, 1)),
    ("MNv2 b256 144ch s2 32x32 to 16x16", (256, 32, 32, 144), (3, 3), S2_SAME, (2, 2)),
    ("MNv2 b256 192ch s2 16x16 to 8x8", (256, 16, 16, 192), (3, 3), S2_SAME, (2, 2)),
    ("MNv2 b256 576ch s2 8x8 to 4x4", (256, 8, 8, 576), (3, 3), S2_SAME, (2, 2)),
]
K5_WRAP_CASES = [
    ("wraps: all -128, 147456 products", (9, 130, 130, 33), (3, 3), ((0, 0), (0, 0)), (1, 1)),
    ("wraps at stride 2: all -128, 147456 products", (9, 257, 257, 36), (3, 3),
     ((0, 0), (0, 0)), (2, 2)),
]
K5_CASES = K5_PATH_CASES + [
    ("JAX test (4,16,16,24)", (4, 16, 16, 24), (3, 3), SAME3, (1, 1)),
    ("ragged C 33, 43 columns", (3, 9, 43, 33), (3, 3), SAME3, (1, 1)),
    ("ragged C 7", (5, 10, 10, 7), (3, 3), SAME3, (1, 1)),
    ("C 20, s2 pads (0, 1), 15x13", (3, 15, 13, 20), (3, 3), S2_SAME, (2, 2)),
    ("ragged C 33, s2 pads (1, 1), 17x19", (2, 17, 19, 33), (3, 3), SAME3, (2, 2)),
    ("C 24, 5x5", (2, 9, 9, 24), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ("C 40, 3x1", (2, 10, 40, 40), (3, 1), ((1, 1), (0, 0)), (1, 1)),
] + K5_WRAP_CASES
K5_PATH_KEYS = {(xs, k, pads, stride) for _, xs, k, pads, stride in K5_PATH_CASES}

# Kernel launches of one train step and of one eval step on each main path,
# per kernel family (K2, K3 and K4 count each of their two phases): the
# routes the `supports` rules give (the JAX package's, unchanged), the same
# as the JAX package's Pallas backend takes for K1-K4. K5 takes every
# depthwise filter grad (17 per MobileNetV2 train step, 3 of them at stride
# 2), where the JAX package computes them outside Pallas with the same bytes. "mnv2pc" is the r5 recipe
# (per-channel depthwise exponents, margins 0/0; `MobilenetV2Train`, batch
# 16 on synthetic data), whose per-channel depthwise forms take K4 where
# their per-tensor twins do (with their alignment shifts as K4's operand).
# K7 requantizes every int32 accumulator that no fused kernel takes, both of
# its phases once a site (counted here once a site, as K2-K4 are). K8 takes
# every max pool ("K8mp", its backward "K8mpb"), zero-padded average pool
# ("K8ap", "K8apb") and channel concat ("K8cat"): LeNet's two 2x2 pools,
# ResNet-v2-50's stem pool, SqueezeNet's three 3x3/2 pools and eight Fire
# concats, Inception-v3's four max pools, nine average pools and 15 concats.
EXPECTED_PER_STEP = {
    ("lenet", 64, "matmul_only"): ({"K1": 11, "K7": 11, "K8mp": 2, "K8mpb": 2}, {"K1": 4, "K7": 4, "K8mp": 2}),
    ("lenet", 2048, "matmul_only"): ({"K1": 10, "K2": 1, "K7": 10, "K8mp": 2, "K8mpb": 2},
                                     {"K1": 4, "K7": 4, "K8mp": 2}),
    ("lenet", 64, "all"): ({"K1": 8, "K3": 3, "K7": 8, "K8mp": 2, "K8mpb": 2},
                           {"K1": 2, "K3": 2, "K7": 2, "K8mp": 2}),
    ("mnv2", 256, "matmul_only"): ({"K1": 65, "K2": 42, "K4": 31, "K5": 17, "K7": 95},
                                   {"K1": 15, "K2": 21, "K4": 14, "K7": 28}),
    ("mnv2", 32, "matmul_only"): ({"K1": 81, "K2": 26, "K4": 31, "K5": 17, "K7": 111},
                                  {"K1": 23, "K2": 13, "K4": 14, "K7": 36}),
    ("mnv2", 256, "all"): ({"K1": 64, "K2": 42, "K3": 1, "K4": 31, "K5": 17, "K7": 94},
                           {"K1": 14, "K2": 21, "K3": 1, "K4": 14, "K7": 27}),
    ("mnv2pc", 256, "matmul_only"): ({"K1": 65, "K2": 42, "K4": 31, "K5": 17, "K7": 95},
                                     {"K1": 15, "K2": 21, "K4": 14, "K7": 28}),
    ("mnv2pc", 32, "matmul_only"): ({"K1": 81, "K2": 26, "K4": 31, "K5": 17, "K7": 111},
                                    {"K1": 23, "K2": 13, "K4": 14, "K7": 36}),
    ("mnv2pc", 16, "matmul_only"): ({"K1": 95, "K2": 12, "K4": 31, "K5": 17, "K7": 125},
                                    {"K1": 30, "K2": 6, "K4": 14, "K7": 43}),
    # each rank of phase 16's data-parallel recipe run (global batch 256 over 2)
    ("mnv2pc", 128, "matmul_only"): ({"K1": 65, "K2": 42, "K4": 31, "K5": 17, "K7": 95},
                                     {"K1": 15, "K2": 21, "K4": 14, "K7": 28}),
    ("mnv2pc", 128, "all"): ({"K1": 64, "K2": 42, "K3": 1, "K4": 31, "K5": 17, "K7": 94},
                             {"K1": 14, "K2": 21, "K3": 1, "K4": 14, "K7": 27}),
    # ResNet-18 (CIFAR): K2 takes the strided 1x1 projections and their input
    # grads where the accumulator reaches 2 MB (at batch 8 one input grad);
    # under "all" K3 takes the 3x3 forwards but layer4's 512 -> 512 and the
    # stride-1 input grads of layer1-3. ResNet-v2-50 at 224x224, 1000
    # classes: K2 the bottleneck 1x1s at 55x55 and 28x28, K1 the rest.
    ("resnet18", 256, "matmul_only"): ({"K1": 56, "K2": 6, "K7": 64}, {"K1": 18, "K2": 3, "K7": 26}),
    ("resnet18", 256, "all"): ({"K1": 32, "K2": 6, "K3": 24, "K7": 40}, {"K1": 4, "K2": 3, "K3": 14, "K7": 12}),
    ("resnet18", 8, "matmul_only"): ({"K1": 61, "K2": 1, "K7": 69}, {"K1": 21, "K7": 29}),
    ("resnet50v2", 16, "matmul_only"): ({"K1": 127, "K2": 34, "K7": 143, "K8mp": 1, "K8mpb": 1},
                                        {"K1": 37, "K2": 17, "K7": 53, "K8mp": 1}),
    # The zoo, 1000 classes: SqueezeNet v1.0 at 224x224, Inception-v3 at
    # 299x299; under "all" K3 takes every non-1x1 SqueezeNet conv and 22
    # Inception forwards (its 1x7s, 1x3s, the 35x35 3x3s and the stem) and 17
    # of their input grads. "squeezenet10": 10 classes at 32x32 (CIFAR).
    ("squeezenet", 128, "matmul_only"): ({"K1": 45, "K2": 32, "K7": 45, "K8mp": 3, "K8mpb": 3, "K8cat": 8},
                                         {"K1": 10, "K2": 16, "K7": 10, "K8mp": 3, "K8cat": 8}),
    ("squeezenet", 128, "all"): ({"K1": 36, "K2": 32, "K3": 9, "K7": 36, "K8mp": 3, "K8mpb": 3, "K8cat": 8},
                                 {"K1": 1, "K2": 16, "K3": 9, "K7": 1, "K8mp": 3, "K8cat": 8}),
    ("squeezenet", 2, "all"): ({"K1": 68, "K3": 9, "K7": 68, "K8mp": 3, "K8mpb": 3, "K8cat": 8},
                               {"K1": 17, "K3": 9, "K7": 17, "K8mp": 3, "K8cat": 8}),
    ("squeezenet10", 64, "matmul_only"): ({"K1": 77, "K7": 77, "K8mp": 3, "K8mpb": 3, "K8cat": 8},
                                          {"K1": 26, "K7": 26, "K8mp": 3, "K8cat": 8}),
    ("inceptionv3", 32, "matmul_only"): ({"K1": 256, "K2": 28, "K7": 256, "K8mp": 4, "K8mpb": 4, "K8ap": 9, "K8apb": 9, "K8cat": 15},
                                         {"K1": 81, "K2": 14, "K7": 81, "K8mp": 4, "K8ap": 9, "K8cat": 15}),
    ("inceptionv3", 32, "all"): ({"K1": 217, "K2": 28, "K3": 39, "K7": 217, "K8mp": 4, "K8mpb": 4, "K8ap": 9, "K8apb": 9, "K8cat": 15},
                                 {"K1": 59, "K2": 14, "K3": 22, "K7": 59, "K8mp": 4, "K8ap": 9, "K8cat": 15}),
    ("inceptionv3", 2, "all"): ({"K1": 245, "K3": 39, "K7": 245, "K8mp": 4, "K8mpb": 4, "K8ap": 9, "K8apb": 9, "K8cat": 15},
                                {"K1": 73, "K3": 22, "K7": 73, "K8mp": 4, "K8ap": 9, "K8cat": 15}),
    # MobileNetV2 with int16 projection outputs (proj_bits=15): K1's int16-A
    # route takes the 17 convs that read them (16 expansions and the head),
    # forward and filter grad; no fused kernel takes an int16 operand or
    # output, so K2 keeps only the input grads it took.
    ("mnv2p15", 256, "matmul_only"): ({"K1": 52, "K1i16": 34, "K2": 21, "K4": 31, "K5": 17, "K7": 116},
                                      {"K1": 19, "K1i16": 17, "K4": 14, "K7": 49}),
    ("mnv2p15", 32, "matmul_only"): ({"K1": 60, "K1i16": 34, "K2": 13, "K4": 31, "K5": 17, "K7": 124},
                                     {"K1": 19, "K1i16": 17, "K4": 14, "K7": 49}),
    # MobilenetV2Transfer at full width (mnv2_transfer_model): the frozen
    # features run a MobileNetV2 eval step's forward but its classifier; a
    # train step adds the head's forward and filter grad (K1, K = 1280 > 512
    # and 256), no input grad and no depthwise filter grad.
    ("mnv2_transfer", 256, "matmul_only"): ({"K1": 16, "K2": 21, "K4": 14, "K7": 29},
                                           {"K1": 15, "K2": 21, "K4": 14, "K7": 28}),
    ("mnv2_transfer", 256, "all"): ({"K1": 15, "K2": 21, "K3": 1, "K4": 14, "K7": 28},
                                    {"K1": 14, "K2": 21, "K3": 1, "K4": 14, "K7": 27}),
    ("mnv2_transfer", 32, "matmul_only"): ({"K1": 24, "K2": 13, "K4": 14, "K7": 37},
                                          {"K1": 23, "K2": 13, "K4": 14, "K7": 36}),
}
FAMILIES = {"K1": ("matmul_int8",), "K1i16": ("matmul_int16a",),
            "K2": ("fused_matmul_max", "fused_matmul_requant"),
            "K3": ("fused_conv_max", "fused_conv_requant"),
            "K4": ("fused_dwconv_max", "fused_dwconv_requant"),
            "K5": ("fused_dwconv_fgrad",),
            "K7": ("requant_int32_absmax", "requant_int32_requant"),
            "K8mp": ("pool_concat_maxpool",), "K8mpb": ("pool_concat_maxpool_grad",),
            "K8ap": ("pool_concat_avgpool",), "K8apb": ("pool_concat_avgpool_grad",),
            "K8cat": ("pool_concat_concat",)}


def mnv2_transfer_model() -> TransferModel:
    """MobilenetV2Transfer at full width: mobilenet_v2_niti(num_classes=10,
    width_mult=1.0) (CIFAR plan, 32x32) split after its global pool, the
    features frozen, the head NITIConv2D(1280, 12) + SqueezeLogits; the
    features' weights drawn from seed 0, the head's from seed 1."""
    full = mobilenet_v2_niti(num_classes=NUM_CLASSES, width_mult=1.0)
    full.reset_parameters(torch.Generator().manual_seed(0))
    return transfer_from(full, NUM_CLASSES).reset_parameters(torch.Generator().manual_seed(1))


def peak_rates(name: str):
    """(int8 dense ops/s, device memory bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 1513e12, 2.0e12, "H100 PCIe data sheet"
    if "NVL" in name:
        return 1671e12, 3.9e12, "H100 NVL data sheet"
    return 1979e12, 3.35e12, "H100 SXM data sheet"


def int8_mac_rate() -> float:
    """Multiply-adds/s of int8 operands on the CUDA cores: IDP4A does four
    per instruction and issues at the IMAD rate of 64 per SM and clock
    (CUDA C++ Programming Guide, arithmetic instruction throughput), so
    SMs x 64 x 4 x the card's maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 64 * 4 * mhz * 1e6


def bound(ops: float, nbytes: float, rates):
    """(least time in ms, what bounds it) for `ops` int8 operations that
    must move `nbytes` of device memory."""
    t_ops, t_bytes = ops / rates[0] * 1e3, nbytes / rates[1] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def k1_key(a, b):
    """(M, K, N, A's layout, B's layout) of a K1 or K2 call."""
    m, k = a.shape
    n = b.shape[1]
    return (m, k, n, *matmul_int8.layout(m, k, n, a.stride(), b.stride()))


def operands(m, k, n, a_layout, b_layout, gen, copies=1):
    """[(a, b)] * copies: random int8 operands in the given layouts."""
    out = []
    for _ in range(copies):
        a = rand_int8((k, m), gen).t() if a_layout == "m" else rand_int8((m, k), gen)
        b = rand_int8((n, k), gen).t() if b_layout == "k" else rand_int8((k, n), gen)
        out.append((a, b))
    return out


def cold_copies(m, k, n):
    return min(1000, max(2, -(-COLD_BYTES // (m * k + k * n))))


def k3_key(x, w, pad, stride, **_):
    """(x shape, w shape, stride, pads) of a K3 call, as K3_KEYS has them."""
    return (tuple(x.shape), tuple(w.shape), tuple(stride), tuple(map(tuple, pad)))


def k4_key(x, w, pads=((0, 0), (0, 0)), dilation=(1, 1), **_):
    """(x shape, kernel size, pads, dilation) of a K4 call; the forward and
    the input grad (w rotated) of one shape are one key."""
    return (tuple(x.shape), (w.shape[0], w.shape[1]), tuple(map(tuple, pads)), tuple(dilation))


def k5_key(x, gy, kernel, stride=(1, 1), pads=((0, 0), (0, 0)), **_):
    """(x shape, kernel size, pads, stride) of a K5 call."""
    return (tuple(x.shape), tuple(kernel), tuple(map(tuple, pads)), tuple(stride))


def k4_key_row(row):
    """The k4_key of a check_k4 row."""
    return (row["x"], row["kernel"], row["pads"], row["dilation"])


def k5_row_key(row):
    """The k5_key of a check_k5 row."""
    return (row["x"], row["kernel"], row["pads"], row["stride"])


RECORD_K1 = {"K1": (matmul_int8, "matmul_acc_cuda", k1_key)}
RECORD_K1I16 = {"K1i16": (matmul_int8, "matmul_acc_int16_cuda", k1_key)}
RECORD_K3 = {"K3": (fused_conv_int8, "conv_max_cuda", k3_key)}
RECORD_K2 = {"K2": (fused_matmul_int8, "matmul_max_cuda", k1_key)}
RECORD_K4 = {"K4": (fused_dwconv_int8, "dwconv_max_cuda", k4_key)}
RECORD_K5 = {"K5": (fused_dwconv_int8, "dwconv_fgrad_acc_cuda", k5_key)}


class RecordingHook:
    """The replay hook (train/step_graph.py) of a recording: a capture's
    calls are taken back, and added again at every replay of its graph."""

    def __init__(self, seen):
        self.seen = seen

    def begin(self):
        return {label: collections.Counter(c) for label, c in self.seen.items()}

    def end(self, before):
        made = {label: self.seen[label] - before[label] for label in self.seen}
        for label, c in self.seen.items():
            c.clear()
            c.update(before[label])
        return made

    def replay(self, made):
        for label, c in made.items():
            self.seen[label].update(c)


@contextlib.contextmanager
def recording(spec):
    """Count the calls of each function of `spec` ({label: (module, name,
    key)}) while inside, by key(*args), into one Counter per label; a
    compiled step's replays count the calls of its capture."""
    seen = {label: collections.Counter() for label in spec}
    reals = {label: getattr(mod, name) for label, (mod, name, _) in spec.items()}
    for label, (mod, name, key) in spec.items():
        def counted(*args, _real=reals[label], _seen=seen[label], _key=key, **kwargs):
            _seen[_key(*args, **kwargs)] += 1
            return _real(*args, **kwargs)
        setattr(mod, name, counted)
    try:
        with step_graph.replay_hook(RecordingHook(seen)):
            yield seen
    finally:
        for label, (mod, name, _) in spec.items():
            setattr(mod, name, reals[label])


def time_ms(fn, launches: int = 50, rounds: int = 5, sets=None) -> float:
    """Median over `rounds` of the device time per call of `fn`, for calls
    issued back to back: a sleep kernel holds the stream while the host
    queues them, so host overhead between calls does not reach the clock.
    Given operand `sets`, fn(*set) cycles through them (each call at least
    once a round): with sets over more than the L2, a cold-cache time."""
    sets = sets or [()]
    launches = max(launches, len(sets))
    fn(*sets[0])
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for i in range(launches):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def rand_int8(shape, gen):
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8, device="cuda")


def int_mm_accepts(m: int, k: int, n: int) -> bool:
    """torch._int_mm's shape rule on CUDA: M > 16, K and N multiples of 8."""
    return m > 16 and k > 0 and k % 8 == 0 and n % 8 == 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def check_k1(rates, gen):
    rows = []
    for what, m, k, n, al, bl in K1_SHAPES:
        (a, b), = operands(m, k, n, al, bl, gen)
        got = matmul_int8.matmul_acc_cuda(a, b)
        err = max_abs_err(got, matmul_int8.matmul_acc_plain(a, b))
        if err:
            raise AssertionError(f"K1 {what} ({m}x{k}x{n}) differs from plain by {err}")
        ms = time_ms(lambda: matmul_int8.matmul_acc_cuda(a, b))
        plain_ms = time_ms(lambda: matmul_int8.matmul_acc_plain(a, b))
        # the yardstick only (the port never calls torch._int_mm): timed
        # where its documented shape rule takes the operands
        lib_ms = time_ms(lambda: torch._int_mm(a, b)) if int_mm_accepts(m, k, n) else None
        ops, nbytes = 2.0 * m * n * k, m * k + k * n + 4.0 * m * n
        b_ms, b_by = bound(ops, nbytes, rates)
        route = matmul_int8.plan(m, k, n, a.stride(), b.stride()).route
        rows.append(dict(what=what, m=m, k=k, n=n, a_layout=al, b_layout=bl, route=route,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops=ops,
                         bytes=nbytes, bound_ms=b_ms, bound_by=b_by))
        print(f"  K1 {what:12s} ({m:5d},{k:5d})x({k:5d},{n:3d}) A {al} B {bl} ({route})"
              f" err {err} | kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"_int_mm {'%.4f ms' % lib_ms if lib_ms is not None else 'n/a (K, N not multiples of 8)'}"
              f"  bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
    return rows


def check_k2(rates, gen):
    what, m, k, n = K2_SHAPE
    a, b = rand_int8((m, k), gen), rand_int8((k, n), gen)
    mx = fused_matmul_int8.matmul_max_cuda(a, b)
    err_max = max_abs_err(mx, fused_matmul_int8.matmul_max_plain(a, b))
    shift = numerics.forward_shift(numerics.range_estimate_from_max(mx))
    errs = []
    cases = [(shift, False), (torch.zeros_like(shift), False),
             (numerics.range_estimate_from_max(mx) - 3, True), (shift - 20, True)]
    for s, grad in cases:
        got = fused_matmul_int8.matmul_requant_cuda(a, b, s, grad)
        errs.append(max_abs_err(got, fused_matmul_int8.matmul_requant_plain(a, b, s, grad)))
    # ragged and tiled shapes of the JAX package's own tests
    for mm, kk, nn in [(300, 100, 70), (1024, 24, 144), (2047, 37, 513)]:
        aa, bb = rand_int8((mm, kk), gen), rand_int8((kk, nn), gen)
        mx2 = fused_matmul_int8.matmul_max_cuda(aa, bb)
        errs.append(max_abs_err(mx2, fused_matmul_int8.matmul_max_plain(aa, bb)))
        s2 = numerics.forward_shift(numerics.range_estimate_from_max(mx2))
        errs.append(max_abs_err(fused_matmul_int8.matmul_requant_cuda(aa, bb, s2),
                                fused_matmul_int8.matmul_requant_plain(aa, bb, s2)))
    if err_max or any(errs):
        raise AssertionError(f"K2 differs from plain: max {err_max}, requant {errs}")
    print(f"  K2 {what}: shift {int(shift)}; max and requant (fwd, shift 0, grad, "
          f"grad shift<0) byte-equal to plain, and at 3 ragged shapes", flush=True)
    rows = k2_timings(what, a, b, shift, err_max, max(errs), rates)

    what_t, mt, kt, nt = K2_TILED_SHAPE
    at, bt = rand_int8((mt, kt), gen), rand_int8((kt, nt), gen)
    mx_t = fused_matmul_int8.matmul_max_cuda(at, bt)
    err_max_t = max_abs_err(mx_t, fused_matmul_int8.matmul_max_plain(at, bt))
    shift_t = numerics.forward_shift(numerics.range_estimate_from_max(mx_t))
    err_req_t = max_abs_err(fused_matmul_int8.matmul_requant_cuda(at, bt, shift_t),
                            fused_matmul_int8.matmul_requant_plain(at, bt, shift_t))
    if err_max_t or err_req_t:
        raise AssertionError(f"K2 {what_t} differs from plain: max {err_max_t}, "
                             f"requant {err_req_t}")
    print(f"  K2 {what_t}: shift {int(shift_t)}; max and requant byte-equal to plain",
          flush=True)
    tiled = k2_timings(what_t, at, bt, shift_t, err_max_t, err_req_t, rates)
    for row, row_t in zip(rows, tiled):
        row["tiled_branch"] = {key: row_t[key] for key in
                               ("what", "m", "k", "n", "ms", "plain_ms", "bound_ms", "bound_by")}
    return rows


def k2_timings(what, a, b, shift, err_max, err_requant, rates):
    """Kernel, plain and bound times of K2's two phases on (a, b)."""
    m, k = a.shape
    n = b.shape[1]
    ops = 2.0 * m * n * k
    rows = []
    for name, fn, plain, nbytes, err in [
        ("fused_matmul_max", lambda: fused_matmul_int8.matmul_max_cuda(a, b),
         lambda: fused_matmul_int8.matmul_max_plain(a, b), m * k + k * n + 4.0, err_max),
        ("fused_matmul_requant",
         lambda: fused_matmul_int8.matmul_requant_cuda(a, b, shift),
         lambda: fused_matmul_int8.matmul_requant_plain(a, b, shift),
         m * k + k * n + 4.0 + m * n, err_requant),
    ]:
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, b_by = bound(ops, nbytes, rates)
        rows.append(dict(name=name, what=what, m=m, k=k, n=n, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by))
        print(f"  {name:22s} ({m},{k})x({k},{n}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
    return rows


def check_k3(rates, gen):
    """K3 against its plain version, and its times, at every case. Beside
    each: the cuDNN fp32 conv of the same operands (channels-last, TF32 off,
    on x padded beforehand; a yardstick, inexact past 2^24 and without the
    max or the requant), and the route fused mode "all" replaces there:
    `conv2d_forward` under "matmul_only" (im2col, K1 and the plain requant
    chain), whose bytes must equal phase 2's forward requant. Returns one
    row per case and the largest difference."""
    rows, worst = [], 0
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for what, xs, ws, stride, pad in K3_CASES:
        x, w = rand_int8(xs, gen), rand_int8(ws, gen)
        mx = fused_conv_int8.conv_max_cuda(x, w, pad, stride)
        errs = [max_abs_err(mx, fused_conv_int8.conv_max_plain(x, w, pad, stride))]
        bw = numerics.range_estimate_from_max(mx)
        shift = numerics.forward_shift(bw)
        for s, grad in [(shift, False), (torch.zeros_like(bw), False), (bw - 2, True),
                        (bw - 40, True)]:
            errs.append(max_abs_err(fused_conv_int8.conv_requant_cuda(x, w, s, pad, stride, grad),
                                    fused_conv_int8.conv_requant_plain(x, w, s, pad, stride, grad)))
        if any(errs):
            raise AssertionError(f"K3 {what} differs from plain: {errs}")
        worst = max(worst, *errs)
        oh, ow = fused_conv_int8._out_spatial(x, w, pad, stride)
        m, n, k = xs[0] * oh * ow, ws[3], ws[0] * ws[1] * ws[2]
        ops, in_bytes = 2.0 * m * n * k, x.numel() + w.numel()
        row = dict(what=what, x=xs, w=ws, stride=stride, pads=pad, m=m, n=n, k=k,
                   max_abs_err=max(errs))
        plain_launches = 10 if m * k < 2**26 else 2
        for phase, fn, plain, nbytes in [
            ("max", lambda: fused_conv_int8.conv_max_cuda(x, w, pad, stride),
             lambda: fused_conv_int8.conv_max_plain(x, w, pad, stride), in_bytes + 4.0),
            ("requant", lambda: fused_conv_int8.conv_requant_cuda(x, w, shift, pad, stride),
             lambda: fused_conv_int8.conv_requant_plain(x, w, shift, pad, stride),
             in_bytes + 4.0 + m * n),
        ]:
            b_ms, b_by = bound(ops, nbytes, rates)
            row[phase] = dict(ms=time_ms(fn), plain_ms=time_ms(plain, launches=plain_launches,
                                                                rounds=3),
                              bound_ms=b_ms, bound_by=b_by)
        with use_fused_conv_mode("matmul_only"):
            y_nf, _ = conv_ops.conv2d_forward(x, zero, w, zero, stride, pad)
            if not torch.equal(y_nf, fused_conv_int8.conv_requant_cuda(x, w, shift, pad, stride)):
                raise AssertionError(f"K3 {what}: phase 2 differs from the non-fused route")
            row["nonfused_ms"] = time_ms(
                lambda: conv_ops.conv2d_forward(x, zero, w, zero, stride, pad), launches=10,
                rounds=3)
        (pt, pb), (pl, pr) = pad
        xf = torch.nn.functional.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb)).contiguous(
            memory_format=torch.channels_last)
        wf = w.permute(3, 2, 0, 1).float().contiguous(memory_format=torch.channels_last)
        row["cudnn_fp32_ms"] = time_ms(lambda: torch.nn.functional.conv2d(xf, wf, stride=stride),
                                       launches=20, rounds=3)
        del xf, wf
        rows.append(row)
        print(f"  K3 {what:32s} x {xs} w {ws} stride {stride} pads {pad}: byte-equal "
              f"(fwd, shift 0, grad, grad shift<0) | max {row['max']['ms']:.4f} ms "
              f"(plain {row['max']['plain_ms']:.4f}, bound {row['max']['bound_ms'] * 1e3:.2f} us "
              f"{row['max']['bound_by']}) | requant {row['requant']['ms']:.4f} ms (plain "
              f"{row['requant']['plain_ms']:.4f}, bound {row['requant']['bound_ms'] * 1e3:.2f} us "
              f"{row['requant']['bound_by']}) | non-fused route {row['nonfused_ms']:.4f} ms, "
              f"cuDNN fp32 {row['cudnn_fp32_ms']:.4f} ms", flush=True)
    torch.backends.cudnn.allow_tf32 = tf32
    return rows, worst


def k4_valid_taps(x, kernel, pads, dilation) -> int:
    """Multiply-adds of one channel of a K4 call that this run's data needs:
    the taps that land on x and not on a pad or an inserted zero."""
    kh, kw = kernel
    ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=torch.int8, device=x.device)
    hits = fused_dwconv_int8.dwconv_shifted_acc_plain(
        ones, torch.ones((kh, kw, 1, 1), dtype=torch.int8, device=x.device), pads, dilation)
    return int(hits.sum()) * x.shape[0]


def k4_row_instructions(x, kernel, pads, dilation) -> int:
    """IDP4A and IMAD that K4 runs for a call's taps: in the 3x3 instance on
    C % 4 == 0, one per output, channel and kernel row that lands on x (a
    row's 3 taps of a channel are one IDP4A); elsewhere one per valid tap."""
    kh, kw = kernel
    b, h, w, c = x.shape
    if (kh, kw) != (3, 3) or c % 4:
        return k4_valid_taps(x, kernel, pads, dilation) * c
    ow = (w - 1) * dilation[1] + 1 + sum(pads[1]) - kw + 1
    rows = k4_valid_taps(x[:, :, :1], (kh, 1), (pads[0], (0, 0)), (dilation[0], 1))
    return rows * ow * c


def check_k4(rates, mac_rate, int_rate, gen):
    """K4 against its plain version, byte for byte, at every case: phase 1
    and the forward and gradient requants of phase 2, per-tensor and with
    per-channel shifts in [0, 12], with w as given and rotated by 180
    degrees; and its times, per-tensor and per-channel. Bounds: bytes (x,
    w, the shifts and the output once) against the int8 multiply-adds at
    the CUDA cores' IDP4A rate. Printed beside them, and kept out of the
    kernels line (an estimate of this design's instruction mix, not a
    measurement nor a bound of the function): the CUDA-core floor of the
    kernel's integer instructions (k4_row_instructions for the taps, and
    per output the shift with |.| and max, or with psto_round's and the
    byte pack), in each row's "floor_ms"."""
    rows, worst = [], 0
    for what, xs, (kh, kw), pads, dil in K4_CASES:
        c = xs[3]
        if (what, xs, (kh, kw), pads, dil) == K4_SATURATED:
            x = torch.full(xs, -128, dtype=torch.int8, device="cuda")
            w = torch.full((kh, kw, 1, c), -128, dtype=torch.int8, device="cuda")
            pc = torch.arange(c, dtype=torch.int32, device="cuda") % 13
        else:
            x, w = rand_int8(xs, gen), rand_int8((kh, kw, 1, c), gen)
            pc = torch.randint(0, 13, (c,), generator=gen, dtype=torch.int32, device="cuda")
        errs = []
        for pcs, rot in [(None, False), (None, True), (pc, False), (pc, True)]:
            k4 = dict(pads=pads, dilation=dil, pc_shift=pcs, rot180=rot)
            mx = fused_dwconv_int8.dwconv_max_cuda(x, w, **k4)
            errs.append(max_abs_err(mx, fused_dwconv_int8.dwconv_max_plain(x, w, **k4)))
            bw = numerics.range_estimate_from_max(mx)
            for s, grad in [(numerics.forward_shift(bw), False), (torch.zeros_like(bw), False),
                            (bw - 2, True), (bw - 40, True)]:
                errs.append(max_abs_err(
                    fused_dwconv_int8.dwconv_requant_cuda(x, w, s, grad, **k4),
                    fused_dwconv_int8.dwconv_requant_plain(x, w, s, grad, **k4)))
        if any(errs):
            raise AssertionError(f"K4 {what} differs from plain: {errs}")
        if (what, xs, (kh, kw), pads, dil) == K4_SATURATED:
            mx = fused_dwconv_int8.dwconv_max_cuda(x, w, pads=pads, pc_shift=pc)
            if int(mx) != 9 * 2**14 << 12:
                raise AssertionError(f"K4 {what}: max {int(mx)}, not 147456 << 12")
        worst = max(worst, *errs)
        b = xs[0]
        oh = (xs[1] - 1) * dil[0] + 1 + sum(pads[0]) - kh + 1
        ow = (xs[2] - 1) * dil[1] + 1 + sum(pads[1]) - kw + 1
        outs = b * oh * ow * c
        macs = float(k4_valid_taps(x, (kh, kw), pads, dil) * c)
        tap_instr = float(k4_row_instructions(x, (kh, kw), pads, dil))
        row = dict(what=what, x=xs, kernel=(kh, kw), pads=pads, dilation=dil,
                   max_abs_err=max(errs), outputs=outs, floor_ms={})
        for form, pcs in (("", None), ("pc_", pc)):
            k4 = dict(pads=pads, dilation=dil, pc_shift=pcs)
            shift = numerics.forward_shift(numerics.range_estimate_from_max(
                fused_dwconv_int8.dwconv_max_cuda(x, w, **k4)))
            in_bytes = x.numel() + w.numel() + (0 if pcs is None else 4 * c)
            for phase, fn, plain, nbytes, epi_ops in [
                ("max", lambda: fused_dwconv_int8.dwconv_max_cuda(x, w, **k4),
                 lambda: fused_dwconv_int8.dwconv_max_plain(x, w, **k4), in_bytes + 4.0, 3),
                ("requant", lambda: fused_dwconv_int8.dwconv_requant_cuda(x, w, shift, **k4),
                 lambda: fused_dwconv_int8.dwconv_requant_plain(x, w, shift, **k4),
                 in_bytes + 4.0 + outs, 2 + PSTO_INT_OPS),
            ]:
                b_ms, b_by = bound(macs, nbytes, (mac_rate, rates[1]))
                row[form + phase] = dict(
                    ms=time_ms(fn), plain_ms=time_ms(plain, launches=5, rounds=3),
                    bound_ms=b_ms, bound_by=b_by, macs=macs, bytes=nbytes)
                row["floor_ms"][form + phase] = (tap_instr + outs * epi_ops) / int_rate * 1e3
        rows.append(row)
        print(f"  K4 {what:34s} x {xs} {kh}x{kw} pads {pads} dil {dil}: byte-equal (x4 forms) | "
              + " | ".join(f"{f}{ph} {row[f + ph]['ms']:.4f} ms (plain {row[f + ph]['plain_ms']:.4f},"
                           f" bound {row[f + ph]['bound_ms'] * 1e3:.2f} us {row[f + ph]['bound_by']},"
                           f" floor {row['floor_ms'][f + ph] * 1e3:.2f} us)"
                           for f in ("", "pc_") for ph in ("max", "requant")), flush=True)
    return rows, worst


def k5_valid_macs(x, gy, kernel, pads, stride) -> int:
    """Multiply-adds of a K5 call that this run's data needs: the taps of
    each gy element that land on x and not on a pad, over every channel."""
    ones = lambda t: torch.ones((1,) + tuple(t.shape[1:3]) + (1,), dtype=torch.int8,  # noqa: E731
                                device=t.device)
    hits = fused_dwconv_int8.dwconv_fgrad_acc_plain(ones(x), ones(gy), kernel, stride, pads=pads)
    return int(hits.sum()) * x.shape[0] * x.shape[3]


def check_k5(rates, mac_rate, gen):
    """K5 against its plain version, byte for byte, at every case, with a
    second call on the same operands equal to the first (the scratch and
    tickets reset themselves); and its times. Bound: bytes (x unpadded, gy
    and the int32 output, once each) against the int8 multiply-adds that land
    on x, at the CUDA cores' IDP4A rate."""
    rows, worst = [], 0
    for case in K5_CASES:
        what, xs, (kh, kw), pads, stride = case
        b, _, _, c = xs
        oh, ow = fused_dwconv_int8.fgrad_out_spatial(xs, (kh, kw), pads, stride)
        gys = (b, oh, ow, c)
        wrap = case in K5_WRAP_CASES
        if wrap:
            x = torch.full(xs, -128, dtype=torch.int8, device="cuda")
            gy = torch.full(gys, -128, dtype=torch.int8, device="cuda")
        else:
            x, gy = rand_int8(xs, gen), rand_int8(gys, gen)
        got = fused_dwconv_int8.dwconv_fgrad_acc_cuda(x, gy, (kh, kw), stride, pads=pads)
        again = fused_dwconv_int8.dwconv_fgrad_acc_cuda(x, gy, (kh, kw), stride, pads=pads)
        err = max(max_abs_err(got, fused_dwconv_int8.dwconv_fgrad_acc_plain(
            x, gy, (kh, kw), stride, pads=pads)), max_abs_err(again, got))
        if err:
            raise AssertionError(f"K5 {what} differs from plain (or from its first call) by {err}")
        products = b * oh * ow
        if wrap:
            wrapped = (products * 2**14 + 2**31) % 2**32 - 2**31
            if products * 2**14 < 2**31 or not bool((got == wrapped).all()):
                raise AssertionError(f"K5 {what}: {got.flatten()[:3].tolist()} is not the "
                                     f"int32 wrap {wrapped} of {products} x 2^14")
        worst = max(worst, err)
        macs = float(k5_valid_macs(x, gy, (kh, kw), pads, stride))
        nbytes = x.numel() + gy.numel() + 4.0 * kh * kw * c
        b_ms, b_by = bound(macs, nbytes, (mac_rate, rates[1]))
        row = dict(what=what, x=xs, kernel=(kh, kw), pads=pads, stride=stride, max_abs_err=err,
                   ms=time_ms(lambda: fused_dwconv_int8.dwconv_fgrad_acc_cuda(
                       x, gy, (kh, kw), stride, pads=pads)),
                   plain_ms=time_ms(lambda: fused_dwconv_int8.dwconv_fgrad_acc_plain(
                       x, gy, (kh, kw), stride, pads=pads), launches=10, rounds=3),
                   bound_ms=b_ms, bound_by=b_by, macs=macs, bytes=nbytes)
        rows.append(row)
        print(f"  K5 {what:44s} x {xs} {kh}x{kw} pads {pads} stride {stride}: byte-equal | "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound {b_ms * 1e3:.2f} us "
              f"{b_by})", flush=True)
    return rows, worst


# K7: the benchmark's models, whose non-fused requant sites phase 3 checks
# and times, rehearsed on the meta device: (what, model, batch, the recipe's
# margins).
K7_NETS = [("MNv2 recipe b256", functools.partial(mobilenet_v2_niti, dw_per_channel=True), 256,
            True),
           ("ResNet-18 b256", resnet18_niti, 256, False)]
K7_SUMS = {(torch.int8, torch.int8): "sum", (torch.int16, torch.int16): "sum16",
           (torch.int8, torch.int16): "sum8_16", (torch.int16, torch.int8): "sum16_8"}


def k7_form(v) -> str:
    """The form of K7's values: "acc", "pc_left", "pc_right" or a sum."""
    v = requant_int32._values(v)
    if v.b is not None:
        return K7_SUMS[(v.a.dtype, v.b.dtype)]
    if v.pc_shift is None:
        return "acc"
    return "pc_right" if v.pc_right else "pc_left"


def k7_forward_key(v, m, exps=(), out_bits=7, act=None):
    return (k7_form(v), tuple(requant_int32._values(v).a.shape), len(exps), out_bits, act, None)


def k7_grad_key(v, m, margin):
    return (k7_form(v), tuple(requant_int32._values(v).a.shape), 0, 7, None, margin)


def k7_sites(model_fn, batch, recipe):
    """{(form, shape, exps given, out_bits, act, margin or None): calls} of
    K7's phase 2 in one train step of the model at `batch` on 32x32x3
    inputs, rehearsed on the meta device."""
    model = model_fn().to("meta")
    x = torch.zeros((batch, 32, 32, 3), device="meta")
    oh = torch.zeros((batch, NITI_LOGIT_CHANNELS), dtype=torch.int32, device="meta")
    spec = {"f": (requant_int32, "requant_forward", k7_forward_key),
            "g": (requant_int32, "requant_grad", k7_grad_key)}
    with dw_ops.recipe_margins() if recipe else contextlib.nullcontext(), recording(spec) as seen:
        make_train_step(model)(x, oh)
    return seen["f"] + seen["g"]


def k7_values(form, shape, gen):
    """Random values of a K7 form on the card: accumulators within +-2^22,
    per-channel shifts in [0, 12], int8 / int16 operands over their range
    with exponents in [-12, 2]."""
    if form in ("acc", "pc_left", "pc_right"):
        acc = torch.randint(-(2**22), 2**22, shape, generator=gen, dtype=torch.int32,
                            device="cuda")
        if form == "acc":
            return requant_int32.Values(acc)
        pc = torch.randint(0, 13, (shape[-1],), generator=gen, dtype=torch.int32, device="cuda")
        if form == "pc_right":
            pc = pc.reshape((1,) * (len(shape) - 1) + (-1,))
        return requant_int32.Values(acc, pc_shift=pc, pc_right=form == "pc_right")
    ta, tb = next(k for k, f in K7_SUMS.items() if f == form)
    a, b = (torch.randint(torch.iinfo(t).min, torch.iinfo(t).max + 1, shape, generator=gen,
                          dtype=t, device="cuda") for t in (ta, tb))
    e = torch.randint(-12, 3, (2,), generator=gen, dtype=torch.int32, device="cuda")
    return requant_int32.aligned_sum(a, e[0], b, e[1])


def check_k7(rates, int_rate, gen):
    """K7 against its plain version, byte for byte, at every non-fused
    requant site of a train step of each of K7_NETS (both phases, each
    site's form, mode, exps, out_bits, act and margin, on random values),
    and its times there beside the plain chain's. Bounds: bytes (phase 1
    reads the values and writes 4 bytes; phase 2 reads them and writes the
    output), and for phase 2 also the CUDA cores' floor, PSTO_INT_OPS
    integer operations an output. Returns {net: summary over one train
    step, the sites by shape} and the largest difference (0)."""
    out, worst = {}, 0
    for what, model_fn, batch, recipe in K7_NETS:
        sites = k7_sites(model_fn, batch, recipe)
        rows = []
        for (form, shape, n_exps, out_bits, act, margin), calls in sorted(sites.items(), key=repr):
            v = k7_values(form, shape, gen)
            n = math.prod(shape)
            exps = tuple(torch.randint(-8, 2, (n_exps,), generator=gen, dtype=torch.int32,
                                       device="cuda"))
            m = requant_int32.absmax_cuda(v)
            if margin is None:
                def phase2(m=m, v=v, exps=exps, out_bits=out_bits, act=act):
                    return requant_int32.requant_forward_cuda(v, m, exps, out_bits, act)

                def plain(v=v, exps=exps, out_bits=out_bits, act=act):
                    return requant_int32.requant_forward_plain(
                        v, requant_int32.absmax_plain(v), exps, out_bits, act)
                got, want = phase2(), plain()
            else:
                def phase2(m=m, v=v, margin=margin):
                    return (requant_int32.requant_grad_cuda(v, m, margin),)

                def plain(v=v, margin=margin):
                    return (requant_int32.requant_grad_plain(v, requant_int32.absmax_plain(v),
                                                             margin),)
                got, want = phase2(), plain()
            errs = [max_abs_err(m, requant_int32.absmax_plain(v))]
            errs += [max_abs_err(g, w) for g, w in zip(got, want)]
            if any(errs):
                raise AssertionError(f"K7 {what} {form} {shape}: differs from plain {errs}")
            in_bytes = sum(t.numel() * t.element_size() for t in (v.a, v.b) if t is not None)
            out_bytes = n * got[0].element_size()
            row = dict(form=form, shape=shape, exps=n_exps, out_bits=out_bits, act=act,
                       margin=margin, calls_per_train_step=calls, n=n,
                       absmax_ms=time_ms(lambda v=v: requant_int32.absmax_cuda(v)),
                       requant_ms=time_ms(phase2), plain_ms=time_ms(plain, launches=5, rounds=3),
                       absmax_bound_ms=(in_bytes + 4) / rates[1] * 1e3,
                       requant_bound_ms=(in_bytes + out_bytes) / rates[1] * 1e3,
                       requant_floor_ms=n * PSTO_INT_OPS / int_rate * 1e3)
            rows.append(row)
        total = {key: sum(r["calls_per_train_step"] * r[key] for r in rows)
                 for key in ("absmax_ms", "requant_ms", "plain_ms", "absmax_bound_ms",
                             "requant_bound_ms", "requant_floor_ms")}
        total["sites"] = sum(r["calls_per_train_step"] for r in rows)
        out[what] = dict(total, by_shape=rows)
        print(f"  K7 {what}: byte-equal at {len(rows)} site shapes; over one train step "
              f"({total['sites']} sites): absmax {total['absmax_ms']:.4f} ms (bound "
              f"{total['absmax_bound_ms']:.4f}, bytes), requant {total['requant_ms']:.4f} ms "
              f"(bound {total['requant_bound_ms']:.4f}, bytes; CUDA-core floor "
              f"{total['requant_floor_ms']:.4f}), the plain chain {total['plain_ms']:.4f} ms",
              flush=True)
    return out, worst


# K8's five dispatch functions -> (the counter of its kernel, the key of a
# call: its operands' shapes and the pool's window, stride and pad).
K8_SPEC = {
    "pool_concat_maxpool": (
        "maxpool", lambda x, window=(2, 2), stride=(2, 2): (
            tuple(x.shape), tuple(window), tuple(stride), 0)),
    "pool_concat_maxpool_grad": (
        "maxpool_grad", lambda x, y, gy, window=(2, 2), stride=(2, 2): (
            tuple(x.shape), tuple(window), tuple(stride), 0)),
    "pool_concat_avgpool": (
        "avgpool", lambda x, window, stride, pad=0: (
            tuple(x.shape), tuple(window), tuple(stride), pad)),
    "pool_concat_avgpool_grad": (
        "avgpool_grad", lambda gy, x_spatial, window, stride, pad=0: (
            (gy.shape[0], *x_spatial, gy.shape[3]), tuple(window), tuple(stride), pad)),
    "pool_concat_concat": (
        "concat", lambda datas, exps: tuple(tuple(d.shape) for d in datas)),
}


def k8_sites(batch=32, side=299, classes=1000):
    """{counter: {key: calls}} of K8's dispatch functions in one
    Inception-v3 train step at `batch` on side x side x 3 inputs, rehearsed
    on the meta device."""
    model = inceptionv3_niti(num_classes=classes).to("meta")
    x = torch.zeros((batch, side, side, 3), device="meta")
    oh = torch.zeros((batch, classes), dtype=torch.int32, device="meta")
    spec = {counter: (pool_concat_int8, fn, key) for counter, (fn, key) in K8_SPEC.items()}
    with recording(spec) as seen:
        make_train_step(model)(x, oh)
    return seen


def k8_calls(counter, key, gen):
    """(the kernel's call, its plain version's, bytes it must move) at one
    K8 site on random card operands (exponents in [-8, 1])."""
    pc = pool_concat_int8
    if counter == "pool_concat_concat":
        datas = [rand_int8(s, gen) for s in key]
        exps = [e for e in torch.randint(-8, 2, (len(key),), generator=gen, dtype=torch.int32,
                                         device="cuda")]
        moved = 2 * sum(math.prod(s) for s in key) + 4 * (len(key) + 1)
        return (lambda: pc.concat_cuda(datas, exps)), (lambda: pc.concat_plain(datas, exps)), moved
    shape, window, stride, pad = key
    x = rand_int8(shape, gen)
    y_shape = (shape[0], *pc.pooled(shape[1:3], window, stride, pad), shape[3])
    nx, ny = math.prod(shape), math.prod(y_shape)
    if counter == "pool_concat_maxpool":
        return (lambda: pc.maxpool_cuda(x, window, stride),
                lambda: pc.maxpool_plain(x, window, stride), nx + ny)
    if counter == "pool_concat_avgpool":
        return (lambda: pc.avgpool_cuda(x, window, stride, pad),
                lambda: pc.avgpool_plain(x, window, stride, pad), nx + ny)
    gy = rand_int8(y_shape, gen)
    if counter == "pool_concat_maxpool_grad":
        y = pc.maxpool_plain(x, window, stride)
        return (lambda: pc.maxpool_grad_cuda(x, y, gy, window, stride),
                lambda: pc.maxpool_grad_plain(x, y, gy, window, stride), 2 * nx + 2 * ny)
    return (lambda: pc.avgpool_grad_cuda(gy, shape[1:3], window, stride, pad),
            lambda: pc.avgpool_grad_plain(gy, shape[1:3], window, stride, pad), nx + ny)


def check_k8(rates, gen):
    """K8 against its plain versions, byte for byte, at every pool and
    concat site of an Inception-v3 train step at 299, batch 32, and its
    times there beside the plain chains'. Bound: bytes (each operand read
    and each result written once, int8). Returns {counter: summary over one
    train step, the sites by key} and the largest difference (0)."""
    out, worst = {}, 0
    for counter, sites in k8_sites().items():
        rows = []
        for key, calls in sorted(sites.items(), key=repr):
            kernel, plain, moved = k8_calls(counter, key, gen)
            got, want = kernel(), plain()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            errs = [max_abs_err(g, w) for g, w in zip(got, want)]
            if any(errs):
                raise AssertionError(f"K8 {counter} {key}: differs from plain {errs}")
            rows.append(dict(key=repr(key), calls_per_train_step=calls, bytes=moved,
                             ms=time_ms(kernel), plain_ms=time_ms(plain, launches=5, rounds=3),
                             bound_ms=moved / rates[1] * 1e3))
        total = {k: sum(r["calls_per_train_step"] * r[k] for r in rows)
                 for k in ("ms", "plain_ms", "bound_ms", "bytes")}
        total["sites"] = sum(r["calls_per_train_step"] for r in rows)
        out[counter] = dict(total, by_shape=rows)
        print(f"  K8 {counter}: byte-equal at {len(rows)} site shapes; over one Inception-v3 "
              f"b32 train step ({total['sites']} sites): {total['ms']:.4f} ms (bound "
              f"{total['bound_ms']:.4f}, bytes), the plain chain {total['plain_ms']:.4f} ms",
              flush=True)
    return out, worst


def k1_library_rows(k1_per_step, rates, gen):
    """K1, its plain version and torch._int_mm (the yardstick; the port never
    calls it) at each (M, K, N, A's layout, B's layout) K1 takes in one
    train step, in that layout, with the step's launches of each; K1 also
    cold (operands rotated over more than the L2). _int_mm takes K and N
    multiples of 8 and M > 16; where it refuses the operands as given (a
    strided A^T or B), it is timed on contiguous copies, and the row says
    so."""
    rows = []
    for (m, k, n, al, bl), count in sorted(k1_per_step.items()):
        (a, b), = operands(m, k, n, al, bl, gen)
        want = matmul_int8.matmul_acc_plain(a, b)
        err = max_abs_err(matmul_int8.matmul_acc_cuda(a, b), want)
        if err:
            raise AssertionError(f"K1 ({m},{k})x({k},{n}) differs from plain by {err}")
        lib_ms, note = None, "refused: needs M > 16 and K, N multiples of 8"
        if int_mm_accepts(m, k, n):
            a_lib, b_lib, note = a, b, "as given"
            try:
                torch._int_mm(a_lib, b_lib)
            except RuntimeError:
                a_lib, b_lib = a.contiguous(), b.contiguous()
                note = "on contiguous copies (refuses the operands as given)"
            if not torch.equal(torch._int_mm(a_lib, b_lib), want):
                note += "; its result differs from K1's"
            lib_ms = time_ms(lambda: torch._int_mm(a_lib, b_lib), launches=20, rounds=3)
        ops, nbytes = 2.0 * m * n * k, m * k + k * n + 4.0 * m * n
        b_ms, b_by = bound(ops, nbytes, rates)
        cold = operands(m, k, n, al, bl, gen, cold_copies(m, k, n))
        rows.append(dict(m=m, k=k, n=n, a_layout=al, b_layout=bl,
                         route=matmul_int8.plan(m, k, n, a.stride(), b.stride()).route,
                         launches_per_train_step=count,
                         ms=time_ms(lambda: matmul_int8.matmul_acc_cuda(a, b), launches=20, rounds=3),
                         cold_ms=time_ms(matmul_int8.matmul_acc_cuda, rounds=3, sets=cold),
                         plain_ms=time_ms(lambda: matmul_int8.matmul_acc_plain(a, b), launches=5,
                                          rounds=3),
                         library_ms=lib_ms, library_note=note, bound_ms=b_ms, bound_by=b_by,
                         ops=ops, bytes=nbytes))
        del cold
        r = rows[-1]
        print(f"  K1 ({m:6d},{k:6d})x({k:6d},{n:4d}) A {al} B {bl} x{count}: kernel "
              f"{r['ms']:.4f} ms (cold {r['cold_ms']:.4f})  plain {r['plain_ms']:.4f} ms  _int_mm "
              f"{'%.4f ms' % lib_ms if lib_ms is not None else 'n/a'} ({note})  bound "
              f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
    return rows


def k1_library_summary(rows):
    """Times of one train step's K1 launches, weighted by the recording;
    K1 and _int_mm also over the shapes _int_mm takes, split into A row-major
    ("a": the forwards and input grads) and MN-major ("a_t": the filter
    grads' im2col^T view)."""
    def total(key, subset):
        return sum(r["launches_per_train_step"] * r[key] for r in subset)

    out = {"launches": sum(r["launches_per_train_step"] for r in rows),
           "ms": total("ms", rows), "cold_ms": total("cold_ms", rows),
           "plain_ms": total("plain_ms", rows), "bound_ms": total("bound_ms", rows)}
    taken = [r for r in rows if r["library_ms"] is not None]
    out.update(library_launches=sum(r["launches_per_train_step"] for r in taken),
               ms_where_library_takes=total("ms", taken), library_ms=total("library_ms", taken))
    for label, al in (("a", "k"), ("a_t", "m")):
        sub = [r for r in taken if r["a_layout"] == al]
        every = [r for r in rows if r["a_layout"] == al]
        out[label] = {"launches": sum(r["launches_per_train_step"] for r in sub),
                      "ms": total("ms", sub), "library_ms": total("library_ms", sub),
                      "bound_ms": total("bound_ms", sub),
                      "all_launches": sum(r["launches_per_train_step"] for r in every),
                      "all_ms": total("ms", every), "all_cold_ms": total("cold_ms", every),
                      "all_bound_ms": total("bound_ms", every)}
    return out


def k2_path_rows(k2_per_step, rates, int_rate, gen):
    """K2's two phases at each (M, K, N, A's layout, B's layout) it takes in
    one train step, in that layout: byte-equal to plain (the forward
    requant of the path, with the shift phase 1 gives), warm and cold times,
    the plain versions' times, and the bounds: bytes against the tensor
    cores, and for phase 2 also its psto epilogue on the CUDA cores."""
    rows = []
    for key in sorted(k2_per_step):
        m, k, n, al, bl = key
        (a, b), = operands(m, k, n, al, bl, gen)
        cold = operands(m, k, n, al, bl, gen, cold_copies(m, k, n))
        mx = fused_matmul_int8.matmul_max_cuda(a, b)
        shift = numerics.forward_shift(numerics.range_estimate_from_max(mx))
        err = max(max_abs_err(mx, fused_matmul_int8.matmul_max_plain(a, b)),
                  max_abs_err(fused_matmul_int8.matmul_requant_cuda(a, b, shift),
                              fused_matmul_int8.matmul_requant_plain(a, b, shift)))
        if err:
            raise AssertionError(f"K2 at {key} differs from plain by {err}")
        ops = 2.0 * m * n * k
        row = dict(key=list(key), launches_per_train_step=k2_per_step[key], max_abs_err=err)
        requant = lambda x, y: fused_matmul_int8.matmul_requant_cuda(x, y, shift)  # noqa: E731
        for phase, fn, plain, nbytes in [
            ("max", fused_matmul_int8.matmul_max_cuda, fused_matmul_int8.matmul_max_plain,
             m * k + k * n + 4.0),
            ("requant", requant,
             lambda x, y: fused_matmul_int8.matmul_requant_plain(x, y, shift),
             m * k + k * n + 4.0 + m * n),
        ]:
            b_ms, b_by = bound(ops, nbytes, rates)
            row[phase] = dict(ms=time_ms(fn, launches=20, rounds=3, sets=[(a, b)]),
                              cold_ms=time_ms(fn, rounds=3, sets=cold),
                              plain_ms=time_ms(plain, launches=5, rounds=3, sets=[(a, b)]),
                              bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes)
        row["requant"]["epilogue_floor_ms"] = m * n * PSTO_INT_OPS / int_rate * 1e3
        del cold
        rows.append(row)
        print(f"  K2 {key} x{row['launches_per_train_step']}: byte-equal | max "
              f"{row['max']['ms']:.4f} ms (cold {row['max']['cold_ms']:.4f}, plain "
              f"{row['max']['plain_ms']:.4f}, bound {row['max']['bound_ms'] * 1e3:.2f} us) | "
              f"requant {row['requant']['ms']:.4f} ms (cold {row['requant']['cold_ms']:.4f}, plain "
              f"{row['requant']['plain_ms']:.4f}, bound {row['requant']['bound_ms'] * 1e3:.2f} us, "
              f"psto floor {row['requant']['epilogue_floor_ms'] * 1e3:.2f} us)", flush=True)
    return rows


def k2_path_summary(rows, rates):
    """Each phase over one train step's K2 launches, weighted by the
    recording; the bound of the sum from the summed operations and bytes."""
    out = {"launches": sum(r["launches_per_train_step"] for r in rows)}
    for phase in ("max", "requant"):
        tot = {key: sum(r["launches_per_train_step"] * r[phase][key] for r in rows)
               for key in ("ms", "cold_ms", "plain_ms", "ops", "bytes")}
        tot["bound_ms"], tot["bound_by"] = bound(tot["ops"], tot["bytes"], rates)
        if phase == "requant":
            tot["epilogue_floor_ms"] = sum(r["launches_per_train_step"] * r[phase]["epilogue_floor_ms"]
                                           for r in rows)
        out[phase] = tot
    return out


def load_tool(relpath: str):
    """Import a script of the checkout (tools/...) as a module."""
    spec = importlib.util.spec_from_file_location(Path(relpath).stem, ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cli_in_process(cli, argv, record):
    """The demo CLI's main(argv) in this process -> (printed lines,
    launches by kernel, the calls of `record`), counts reset just before
    and read just after."""
    out = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(out), recording(record) as seen:
        cli.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    return out.getvalue().splitlines(), counts, seen


def cli_subprocesses(jobs, cwd, timeout=600, tool="tools/run_train_demo_torch.py"):
    """Run each {label: argv} of a CLI of the checkout (the demo CLI unless
    `tool` names another) as its own process, all started together; each
    must exit 0. Returns {label: stdout}."""
    script = str(ROOT / tool)
    procs = {label: subprocess.Popen([sys.executable, script, *argv], cwd=cwd, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for label, argv in jobs.items()}
    outs, failed = {}, []
    try:
        for label, proc in procs.items():
            out, err = proc.communicate(timeout=timeout)
            outs[label] = out
            if proc.returncode != 0:
                failed.append(f"{label}: exit {proc.returncode}\n{err[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError("demo CLI runs failed:\n" + "\n".join(failed))
    for label, out in outs.items():
        for ln in out.splitlines():
            print(f"  [{label}] {ln}", flush=True)
    return outs


def params_equal(p, q) -> bool:
    a, b = flat_weights(p), flat_weights(q)
    return len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                    for x, y in zip(a, b))


def train_run(batch, epochs, train, test, start, device, backend, model_fn=lenet_niti,
              mode="matmul_only"):
    lines = []
    with use_fused_conv_mode(mode):
        model, acc = train_niti(train, test, epochs=epochs, batch=batch, seed=0,
                                log=lines.append, start_params=start, device=device,
                                backend=backend, model=model_fn())
    losses = [float(re.search(r"loss (\S+)", ln).group(1)) for ln in lines]
    rate = float(re.search(r"([\d.]+) samples/s", lines[-1]).group(1))
    return dict(params=export_jax_params(model), acc=acc, losses=losses, lines=lines,
                samples_per_s=rate, model=model)


def family_counts(counts):
    """Launches per kernel family (K1..K4); a two-phase kernel must have
    launched both of its phases equally often."""
    out = {}
    for fam, names in FAMILIES.items():
        vals = [counts[n] for n in names]
        if len(set(vals)) != 1:
            raise AssertionError(f"{fam} phases launched {vals} times")
        if vals[0]:
            out[fam] = vals[0]
    return out


def expected_launches(key, train_steps, eval_steps):
    per_train, per_eval = EXPECTED_PER_STEP[key]
    want = {f: train_steps * per_train.get(f, 0) + eval_steps * per_eval.get(f, 0)
            for f in FAMILIES}
    return {f: n for f, n in want.items() if n}


def main_path(label, key, train, test, epochs, start, others, model_fn=lenet_niti,
              record=None):
    """train_niti on the card with the kernels (launches counted from 0,
    the calls of `record` recorded), then from the same params with each
    (device, backend) of `others`: byte-identical params, losses within
    1e-5, equal accuracy, and the launches EXPECTED_PER_STEP gives."""
    _, batch, mode = key
    kernels.reset_launch_counts()
    with recording(record or {}) as seen:
        run = train_run(batch, epochs, train, test, start, "cuda", "cuda", model_fn, mode)
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    for ln in run["lines"]:
        print(f"  [{label} cuda] {ln}", flush=True)
    for device, backend in others:
        other = train_run(batch, epochs, train, test, start, device, backend, model_fn, mode)
        what = f"plain on the {'card' if device == 'cuda' else 'CPU'}"
        if not params_equal(run["params"], other["params"]):
            raise AssertionError(f"{label}: params differ between the kernels and {what}")
        if max(abs(x - y) for x, y in zip(run["losses"], other["losses"])) > 1e-5:
            raise AssertionError(f"{label}: losses {run['losses']} vs {what} {other['losses']}")
        if run["acc"] != other["acc"]:
            raise AssertionError(f"{label}: accuracy {run['acc']} vs {what} {other['acc']}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"plain runs launched kernels: {kernels.launch_counts()}")
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"{label}: non-finite losses {run['losses']}")
    if all(np.array_equal(a, b) for a, b in zip(flat_weights(run["params"]), flat_weights(start))):
        raise AssertionError(f"{label}: training did not change the params")
    want = expected_launches(key, epochs * (len(train[0]) // batch),
                             epochs * (len(test[0]) // min(batch, len(test[0]))))
    if family_counts(counts) != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want} by kernel family")
    print(f"  {label}: params byte-identical across the kernels and "
          f"{', '.join(('plain on the card' if d == 'cuda' else 'plain on the CPU') for d, _ in others)}; "
          f"losses {run['losses']}; launches {family_counts(counts)}", flush=True)
    return run, counts, seen


def per_step_counts(key, model, x, y, n_logits, record=None):
    """Launches by family of one train step and of one eval step, each
    counted alone, against EXPECTED_PER_STEP; and the calls of `record`
    in each."""
    xb = torch.from_numpy(x.astype(np.float32)).cuda()
    oh = torch.from_numpy(onehot_padded(y, NUM_CLASSES, n_logits)).cuda()
    labels = torch.from_numpy(y.astype(np.int64)).cuda()
    out, seen = [], []
    with use_fused_conv_mode(key[2]):
        for fn in (lambda: make_train_step(model)(xb, oh),
                   lambda: make_eval_step(model)(xb, labels)):
            kernels.reset_launch_counts()
            with recording(record or {}) as step_seen:
                fn()
                torch.cuda.synchronize()
            out.append(family_counts(kernels.launch_counts()))
            seen.append(step_seen)
    kernels.reset_launch_counts()
    if tuple(out) != EXPECTED_PER_STEP[key]:
        raise AssertionError(f"{key}: per-step launches {out}, expected {EXPECTED_PER_STEP[key]}")
    print(f"  {key[0]} b{key[1]} {key[2]}: launches per train step {out[0]}, per eval step "
          f"{out[1]}", flush=True)
    return out, seen


def path_step_weights(fam, run_seen, n_train, n_eval, step_seen, keys=None):
    """Launches of kernel family `fam` per train step by key, as recorded:
    checked against the main path's recording (n_train train steps and
    n_eval eval steps) and, given `keys`, against the listed keys whose
    timings they weight."""
    train, evals = step_seen[0][fam], step_seen[1][fam]
    want = collections.Counter({k: n_train * v for k, v in train.items()})
    want.update({k: n_eval * v for k, v in evals.items()})
    if run_seen[fam] != want:
        raise AssertionError(f"{fam} shapes of the main path {dict(run_seen[fam])} are not "
                             f"{n_train} train and {n_eval} eval steps' {dict(want)}")
    if keys is not None:
        if set(train) != set(keys) or not set(evals) <= set(keys):
            raise AssertionError(f"{fam} shapes of a step {sorted(set(train) | set(evals))} "
                                 f"!= checked {sorted(keys)}")
        print(f"  {fam} launches by shape, one train step: {dict(train)}; "
              f"one eval step: {dict(evals)}", flush=True)
    return train


def throughput(batch, steps, start, model_fn=lenet_niti, data=synthetic_mnist,
               mode="matmul_only"):
    """Samples/s of `train_niti` with the kernels: the second of two epochs
    of `steps` steps, as the trainer's StepTimer reports it."""
    x, y = data(batch * steps, seed=11)
    test = data(batch, seed=12)
    run = train_run(batch, 2, (x, y), test, start, "cuda", "cuda", model_fn, mode)
    return run["samples_per_s"], run["lines"][-1]


def k3_step_sum(k3_per_step, k3_rows):
    """K3's two phases over one train step, the per-call times of k3_rows
    weighted by the launches recorded at each shape, beside the cuDNN fp32
    conv and the non-fused route at the same shapes."""
    rows = {(r["x"], r["w"], r["stride"], r["pads"]): r for r in k3_rows}
    out = {"launches": sum(k3_per_step.values()),
           "cudnn_fp32_ms": sum(n * rows[k]["cudnn_fp32_ms"] for k, n in k3_per_step.items()),
           "nonfused_ms": sum(n * rows[k]["nonfused_ms"] for k, n in k3_per_step.items()),
           "by_shape": [dict(what=rows[k]["what"], launches_per_train_step=n)
                        for k, n in sorted(k3_per_step.items())]}
    for phase in ("max", "requant"):
        out[phase] = {key: sum(n * rows[k][phase][key] for k, n in k3_per_step.items())
                      for key in ("ms", "plain_ms", "bound_ms")}
    return out


def class_steps(build, start, device, backend, mode, xs, ohs, xe, ye, record=None):
    """model_steps of a 1000-class model (ResNet-v2-50, the zoo) built by
    `build` from the params `start`."""
    return model_steps(lambda: load_jax_params(build(num_classes=1000), start), 1000, device,
                       backend, mode, xs, ohs, xe, ye, record)


def model_steps(make, num_classes, device, backend, mode, xs, ohs, xe, ye, record=None):
    """Train steps on (xs, ohs) and one eval step of the model make()
    returns, through make_train_step / make_eval_step on `device` ->
    (params, losses, correct, the calls of `record` in the train steps, in
    the eval step)."""
    model = make().to(device)
    step, evals = make_train_step(model), make_eval_step(model, num_classes=num_classes)
    with kernels.use_backend(backend), use_fused_conv_mode(mode):
        with recording(record or {}) as seen_train:
            losses = [float(step(x.to(device), oh.to(device))) for x, oh in zip(xs, ohs)]
        with recording(record or {}) as seen_eval:
            correct = int(evals(xe.to(device), ye.to(device)))
    return export_jax_params(model), losses, correct, seen_train, seen_eval


def class_batches(batch, side, seed, n=3, classes=1000, logits=1000):
    """n seeded batches of integer pixels at (batch, side, side, 3) on the
    card: the one-hot labels (`classes` in `logits` channels) of the first
    n - 1 for the train steps, the labels of the last for the eval step ->
    (xs, ohs, xe, ye)."""
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.integers(0, 256, (batch, side, side, 3)).astype(np.float32)).cuda()
          for _ in range(n)]
    ys = rng.integers(0, classes, (n, batch))
    ohs = [torch.from_numpy(onehot_padded(y, classes, logits)).cuda() for y in ys[:-1]]
    return xs[:-1], ohs, xs[-1], torch.from_numpy(ys[-1].astype(np.int64)).cuda()


def class_path(label, key, steps, start, data, others, record=None, moves=True):
    """steps(device, backend, mode, *data, record=) (class_steps with its
    model, or transfer_steps) on the card with the kernels (launches counted
    from 0, the calls of `record` recorded), then with each (device,
    backend) of `others`: byte-identical params, losses within 1e-5, equal
    correct counts, and the launches EXPECTED_PER_STEP gives; the params
    move from `start`, or with `moves` False stay as they were -> (the
    kernels' run, its launches)."""
    mode = key[2]
    kernels.reset_launch_counts()
    run = steps("cuda", "cuda", mode, *data, record=record)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    for device, backend in others:
        other = steps(device, backend, mode, *data)
        what = f"plain on the {'card' if device == 'cuda' else 'CPU'}"
        if not params_equal(run[0], other[0]) or run[2] != other[2] or \
                max(abs(a - b) for a, b in zip(run[1], other[1])) > 1e-5:
            raise AssertionError(f"{label}: the kernels and {what} differ (losses {run[1]} vs "
                                 f"{other[1]}, correct {run[2]} vs {other[2]})")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"plain runs launched kernels: {kernels.launch_counts()}")
    if not all(np.isfinite(run[1])) or params_equal(run[0], start) == moves:
        raise AssertionError(f"{label}: losses {run[1]}, or the params "
                             f"{'did not move' if moves else 'moved'}")
    want = expected_launches(key, len(data[0]), 1)
    if family_counts(counts) != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want} by kernel family")
    print(f"  {label}: params byte-identical across the kernels and "
          f"{', '.join(('plain on the card' if d == 'cuda' else 'plain on the CPU') for d, _ in others)}; "
          f"losses {run[1]}; launches {family_counts(counts)}", flush=True)
    return run, counts


def class_step_weights(key, fam, run):
    """Launches of kernel family `fam` per train step and per eval step by
    shape, from a class_path run's recording of its train steps (each the
    same shapes) and eval step, held to EXPECTED_PER_STEP."""
    n_train = len(run[1])
    train, evals = run[3][fam], run[4][fam]
    if any(n % n_train for n in train.values()):
        raise AssertionError(f"{key}: {n_train} train steps gave {fam} {dict(train)}")
    per_train = {k: n // n_train for k, n in train.items()}
    want = EXPECTED_PER_STEP[key]
    if (sum(per_train.values()), sum(evals.values())) != (want[0].get(fam, 0), want[1].get(fam, 0)):
        raise AssertionError(f"{key}: {fam} launches by shape {per_train}, {dict(evals)}")
    return per_train, dict(evals)


def steps_per_s(step, args, batch, steps):
    """Samples/s of `steps` calls of step(*args) back to back after a
    warm-up call, on the host clock, synchronised at both ends."""
    step(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(*args)
    torch.cuda.synchronize()
    return batch * steps / (time.perf_counter() - t0)


def step_rate(build, start, batch, side, mode, steps):
    """Samples/s of make_train_step on the card at (batch, side, side, 3),
    1000 classes (steps_per_s)."""
    model = load_jax_params(build(num_classes=1000), start).to("cuda")
    (x,), (oh,), _, _ = class_batches(batch, side, seed=77, n=2)
    with use_fused_conv_mode(mode):
        return steps_per_s(make_train_step(model), (x, oh), batch, steps)


def rand_int16(shape, gen):
    return torch.randint(-32768, 32768, shape, generator=gen, dtype=torch.int16, device="cuda")


def k1_step_rows(per_step, rates, gen, int16=False):
    """K1 (or, with `int16`, its int16-A route, beside the int8 route at the
    same shape and layouts) at each (M, K, N, A's layout, B's layout) of
    one train step, in that layout, with the step's launches of each:
    byte-equal to the plain version, the kernel's and the plain version's
    times, and the bound (an int16 x int8 product counted as two int8
    products on the tensor cores, which take no 16-bit integers)."""
    rows = []
    for key, count in sorted(per_step.items()):
        m, k, n, al, bl = key
        (a, b), = operands(m, k, n, al, bl, gen)
        fn = matmul_int8.matmul_acc_cuda
        if int16:
            a8 = a
            a = rand_int16((k, m), gen).t() if al == "m" else rand_int16((m, k), gen)
            fn = matmul_int8.matmul_acc_int16_cuda
        err = max_abs_err(fn(a, b), matmul_int8.matmul_acc_plain(a, b))
        if err:
            raise AssertionError(f"K1{' int16-A' if int16 else ''} at {key} differs from plain "
                                 f"by {err}")
        ops = 2.0 * m * n * k * (2 if int16 else 1)
        nbytes = a.element_size() * m * k + k * n + 4.0 * m * n
        b_ms, b_by = bound(ops, nbytes, rates)
        row = dict(key=list(key), launches_per_train_step=count, max_abs_err=err,
                   ms=time_ms(lambda: fn(a, b), launches=10, rounds=3),
                   plain_ms=time_ms(lambda: matmul_int8.matmul_acc_plain(a, b), launches=1,
                                    rounds=1),
                   bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes)
        if int16:
            row["int8_route_ms"] = time_ms(lambda: matmul_int8.matmul_acc_cuda(a8, b),
                                           launches=10, rounds=3)
        rows.append(row)
        print(f"  K1{' int16-A' if int16 else ''} {key} x{count}: byte-equal | kernel "
              f"{row['ms']:.4f} ms" + (f" (int8 route {row['int8_route_ms']:.4f})" if int16
                                       else "")
              + f", plain {row['plain_ms']:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by})",
              flush=True)
    return rows


def step_sum(rows, rates, per_step=None):
    """The rows' times over one train step, weighted by their launches (or
    by `per_step`, {key: launches}, over the rows it names); the bound of
    the sum from the summed operations and bytes."""
    weights = {tuple(r["key"]): r["launches_per_train_step"] for r in rows} \
        if per_step is None else per_step
    sub = [r for r in rows if tuple(r["key"]) in weights]
    out = {"launches": sum(weights.values())}
    for field in ("ms", "plain_ms", "ops", "bytes") + (
            ("int8_route_ms",) if sub and "int8_route_ms" in sub[0] else ()):
        out[field] = sum(weights[tuple(r["key"])] * r[field] for r in sub)
    out["bound_ms"], out["bound_by"] = bound(out["ops"], out["bytes"], rates)
    return out


def fp32_forward_close(tag, cls, x, rtol_train):
    """A float twin's forward, eval and train mode, and its running stats
    after the training forward, on the card against the CPU from the same
    params (TF32 off): within 1e-5 of the CPU's largest magnitude (the
    training forward within `rtol_train`), each batch norm's stats within
    1e-5 of its (mean, var) pair's."""
    cpu = cls().reset_parameters(torch.Generator().manual_seed(3))
    card = cls().load_params(cpu.params_numpy()).to("cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            outs = [(m(x.to(dev)).cpu(), m(x.to(dev), training=True).cpu())
                    for m, dev in ((card, "cuda"), (cpu, "cpu"))]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    errs = []
    for got, want, rtol in zip(outs[0], outs[1], (1e-5, rtol_train)):
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= rtol:
            raise AssertionError(f"{tag}: card forward {err} from the CPU's (> {rtol})")
        errs.append(err)

    def stats(tree):
        if isinstance(tree, list):
            return [s for t in tree for s in stats(t)]
        if "mean" in tree:
            return [(tree["mean"], tree["var"])]
        return [s for v in tree.values() if isinstance(v, dict) for s in stats(v)]

    worst = 0.0
    for (m1, v1), (m2, v2) in zip(stats(card.params_numpy()), stats(cpu.params_numpy())):
        scale = max(np.abs(m2).max(), np.abs(v2).max())
        worst = max(worst, float(max(np.abs(m1 - m2).max(), np.abs(v1 - v2).max()) / scale))
    if not worst <= 1e-5:
        raise AssertionError(f"{tag}: card running stats {worst} from the CPU's")
    return errs + [worst]


def fp32_float64_steps(tag, cls, steps, batch):
    """`train_fp32_bn` in float64 on the card and on the CPU for `steps`
    steps from the same params: each layer entry within 1e-4 of its largest
    magnitude (a float32 step at a small batch is too ill-conditioned to
    compare, tests/test_torch_fp32_cifar_train.py)."""
    start = cls().reset_parameters(torch.Generator().manual_seed(4)).params_numpy()
    train, test = synthetic_cifar(batch * steps, seed=41), synthetic_cifar(batch, seed=42)
    trees = []
    for device in ("cuda", "cpu"):
        model, _ = train_fp32_bn(cls().double(), train, test, epochs=1, batch=batch,
                                 log=lambda ln: None, start_params=start, device=device)
        trees.append(model.params_numpy())

    def entries(tree):
        return [e for t in tree for e in entries(t)] if isinstance(tree, list) else [tree]

    def leaves(entry):
        return [a for k in sorted(entry) for a in
                (leaves(entry[k]) if isinstance(entry[k], dict) else [entry[k]])]

    worst = 0.0
    for a, b in zip(entries(trees[0]), entries(trees[1])):
        scale = max(np.abs(v).max() for v in leaves(b))
        worst = max(worst, float(max(np.abs(u - v).max() for u, v in zip(leaves(a), leaves(b)))
                                 / scale))
    if not worst <= 1e-4:
        raise AssertionError(f"{tag}: float64 params after {steps} steps {worst} apart")
    return worst


def fp32_throughput(cls, batch, steps):
    """Samples/s of `train_fp32_bn` on the card (TF32 off): the second of
    two epochs of `steps` steps, as the trainer's StepTimer reports it."""
    lines = []
    train, test = synthetic_cifar(batch * steps, seed=11), synthetic_cifar(batch, seed=12)
    train_fp32_bn(cls(), train, test, epochs=2, batch=batch, log=lines.append, device="cuda")
    return float(re.search(r"([\d.]+) samples/s", lines[-1]).group(1)), lines[-1]


def run_test_train_gate(config, timeout=600):
    """tools/test_train_torch.py as a process of its own on `config` ->
    its JSON record and exit code; exit 0 (PASS) and 1 (FAIL) are results,
    any other code raises."""
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        path = Path(tmp) / "config.json"
        path.write_text(json.dumps(config))
        proc = subprocess.run([sys.executable, str(ROOT / "tools" / "test_train_torch.py"),
                               str(path)], capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode not in (0, 1) or len(lines) < 2:
        raise AssertionError(f"test_train_torch.py exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    record = json.loads(lines[-2])
    if lines[-1] != ("TEST_TRAIN PASS" if record["pass"] else "TEST_TRAIN FAIL") or \
            proc.returncode != (0 if record["pass"] else 1):
        raise AssertionError(f"test_train_torch.py printed {lines[-2:]}, exit {proc.returncode}")
    return record, proc.returncode



def int_mm_rows(k1_rows, per_step, gen):
    """torch._int_mm (the library yardstick; the port never calls it) at
    the row-major K1 shapes of one train step (A "k") that it takes (M > 16,
    K and N multiples of 8), beside K1's time there from `k1_rows`
    (k1_step_rows), weighted by the step's launches `per_step`. Where it
    refuses the operands as given (B "k", the transposed weights of an
    input grad), it is timed on contiguous copies."""
    rows = {tuple(r["key"]): r for r in k1_rows}
    out = dict(launches=0, k1_ms=0.0, library_ms=0.0, shapes=0, copies=0,
               refused_launches=0, differs=0)
    for key, n in sorted(per_step.items()):
        m, k, nn_, al, bl = key
        if al != "k":
            continue
        if not int_mm_accepts(m, k, nn_):
            out["refused_launches"] += n
            continue
        (a, b), = operands(m, k, nn_, al, bl, gen)
        try:
            torch._int_mm(a, b)
        except RuntimeError:
            a, b = a.contiguous(), b.contiguous()
            out["copies"] += 1
        out["differs"] += int(not torch.equal(torch._int_mm(a, b), matmul_int8.matmul_acc_cuda(a, b)))
        out["library_ms"] += n * time_ms(lambda: torch._int_mm(a, b), launches=10, rounds=3)
        out["k1_ms"] += n * rows[key]["ms"]
        out["launches"] += n
        out["shapes"] += 1
    return out


def transfer_steps(device, backend, mode, xs, ohs, xe, ye, record=None):
    """Train steps on (xs, ohs) and one eval step of mnv2_transfer_model()
    on `device` -> (head params, losses, correct, the calls of `record` in
    the train steps, in the eval step, the features' params)."""
    model = mnv2_transfer_model().to(device)
    step = make_transfer_train_step(model)
    evals = make_transfer_eval_step(model, NUM_CLASSES)
    with kernels.use_backend(backend), use_fused_conv_mode(mode):
        with recording(record or {}) as seen_train:
            losses = [float(step(x.to(device), oh.to(device))) for x, oh in zip(xs, ohs)]
        with recording(record or {}) as seen_eval:
            correct = int(evals(xe.to(device), ye.to(device)))
    return (export_jax_params(model.head), losses, correct, seen_train, seen_eval,
            export_jax_params(model.features))


def rel_diff(got, want):
    """Largest |got - want| over the largest |want|, for tensors or arrays."""
    got, want = (np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64)
                 for v in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def qat_float64_card_vs_cpu(tag, run_steps):
    """run_steps(device) -> {name: tensor} after its steps, on the card and
    the CPU in float64: each tensor within 1e-9 of its largest magnitude on
    the CPU -> the largest relative difference."""
    card, cpu = run_steps("cuda"), run_steps("cpu")
    worst = max(rel_diff(card[k], cpu[k]) for k in cpu)
    if worst > 1e-9:
        raise AssertionError(f"{tag}: card and CPU differ by {worst:.3e} of a tensor's largest "
                             "magnitude")
    print(f"  {tag}, float64, card against the CPU: largest difference {worst:.3e} of a "
          f"tensor's largest magnitude ({len(cpu)} tensors)", flush=True)
    return worst


def qat_state(model):
    """A LeNetQAT's or LeNetFP32's parameters and buffers by name."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def mnist_int8_steps(device, steps=3, batch=64):
    """MnistInt8Train's step, float64, `steps` steps at lr_inv(0.01, step)
    from LeNetQAT seed 0 on normalised synthetic MNIST, dropout from a CPU
    generator (so the card and the CPU draw one mask)."""
    x, y = synthetic_mnist(batch * steps, seed=21)
    model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0)).double().to(device)
    step = make_qat_train_step(model, torch.Generator().manual_seed(1))
    for i in range(steps):
        xb = (x[i * batch:(i + 1) * batch].astype(np.float64) / 255.0 - 0.5) * 2.0
        oh = onehot_padded(y[i * batch:(i + 1) * batch], NUM_CLASSES, NUM_CLASSES)
        step(torch.from_numpy(xb).to(device), torch.from_numpy(oh).to(device, torch.float64),
             lr_inv(0.01, i))
    return qat_state(model)


def distill_steps(device, steps=3, batch=64):
    """DistillTrainQuant, float64: one teacher step (LeNetFP32 seed 0) and
    `steps` student steps (LeNetQAT seed 1) on raw synthetic MNIST pixels,
    dropout from a CPU generator."""
    x, y = synthetic_mnist(batch * (steps + 1), seed=22)
    xs = [torch.from_numpy(x[i * batch:(i + 1) * batch].astype(np.float64)).to(device)
          for i in range(steps + 1)]
    ohs = [torch.from_numpy(onehot_padded(y[i * batch:(i + 1) * batch], NUM_CLASSES,
                                          NUM_CLASSES)).to(device, torch.float64)
           for i in range(steps + 1)]
    teacher = LeNetFP32().reset_parameters(torch.Generator().manual_seed(0)).double().to(device)
    make_teacher_step(teacher)(xs[0], ohs[0])
    student = LeNetQAT().reset_parameters(torch.Generator().manual_seed(1)).double().to(device)
    sstep = make_distill_step(student, teacher, torch.Generator().manual_seed(2))
    for xb, oh in zip(xs[1:], ohs[1:]):
        sstep(xb, oh)
    return {**{f"teacher.{k}": v for k, v in qat_state(teacher).items()},
            **{f"student.{k}": v for k, v in qat_state(student).items()}}


# The batch of each imported model's run against the CPU in phase 15 (an
# EXPECTED_PER_STEP row of the built model).
IMPORTED_NETS_SMALL = (("resnet18", 8), ("mnv2", 32))


def imported_model(net, build_net, start, tmp, name, card):
    """Phase 15 for one full-width model built from the params `start`:
    the port's TFLite export of it at (256, 32, 32, 3), the import by
    tools/import_model_torch.py as a process of its own (on the card) into
    a checkpoint, which must hold `start`'s weights; 2 train steps and 1 eval
    step of the imported model in both fused modes, kernels against plain on
    the card and against the built model from the same params (byte for
    byte, the same launches, EXPECTED_PER_STEP's rows of the built model);
    at a small batch the card against the CPU; samples/s of the train step
    in turns, built and imported. -> (its record, {run: launches})."""
    runs = {}
    built = load_jax_params(build_net(), start)
    t0 = time.perf_counter()
    buf = tflite_from_sequential(built, None, (256, 32, 32, 3))
    export_s = time.perf_counter() - t0
    path, npz = Path(tmp) / f"{net}.tflite", Path(tmp) / f"{net}.npz"
    path.write_bytes(buf)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "import_model_torch.py"),
                           str(path), "--out", str(npz)], cwd=tmp, text=True,
                          capture_output=True, timeout=600)
    import_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"import_model_torch.py {net}: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    template, _ = niti_model_from_tflite(str(path), device="cpu")
    kinds = [type(layer).__name__ for layer in template.layers]
    if proc.stdout.splitlines() != [f"imported {len(kinds)} NITI layers: {kinds}", f"wrote {npz}"]:
        raise AssertionError(f"import_model_torch.py {net} printed {proc.stdout!r}")
    imported, _ = load_checkpoint(str(npz), export_jax_params(template))
    if not params_equal(imported, start):
        raise AssertionError(f"{net}: the imported checkpoint differs from the built weights")
    print(f"  on {name} ({card}): {net} exported as {len(buf)} bytes of TFLite in "
          f"{export_s:.3f} s (host); import_model_torch.py read them into {len(kinds)} layers "
          f"({len(built.layers)} built) in {import_s:.3f} s (a process of its own on the card, "
          "start-up included); the checkpoint holds the built weights byte for byte", flush=True)

    def make_imported():
        return load_jax_params(copy.deepcopy(template), imported)

    def make_built():
        return load_jax_params(build_net(), start)

    imported_steps = functools.partial(model_steps, make_imported, NUM_CLASSES)
    data = class_batches(256, 32, seed=256, classes=NUM_CLASSES, logits=NITI_LOGIT_CHANNELS)
    for mode in ("matmul_only", "all"):
        run, runs[f"imported_{net}_b256_{mode}"] = class_path(
            f"imported {net} b256 {mode}", (net, 256, mode), imported_steps, imported, data,
            [("cuda", "torch")])
        kernels.reset_launch_counts()
        built_run = model_steps(make_built, NUM_CLASSES, "cuda", "cuda", mode, *data)
        torch.cuda.synchronize()
        built_counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        if not params_equal(run[0], built_run[0]) or run[1] != built_run[1] or \
                run[2] != built_run[2] or built_counts != runs[f"imported_{net}_b256_{mode}"]:
            raise AssertionError(f"imported {net} b256 {mode}: differs from the built model "
                                 f"(losses {run[1]} vs {built_run[1]}, launches "
                                 f"{family_counts(built_counts)})")
        print(f"  imported {net} b256 {mode}: params, losses and correct count byte-identical "
              "to the built model's from the same params, the same launches", flush=True)
    small = dict(IMPORTED_NETS_SMALL)[net]
    _, runs[f"imported_{net}_b{small}"] = class_path(
        f"imported {net} b{small}", (net, small, "matmul_only"), imported_steps, imported,
        class_batches(small, 32, seed=small, classes=NUM_CLASSES, logits=NITI_LOGIT_CHANNELS),
        [("cpu", "cuda")])
    (x, ), (oh, ), _, _ = class_batches(256, 32, seed=77, n=2, classes=NUM_CLASSES,
                                       logits=NITI_LOGIT_CHANNELS)
    rates = {"built": [], "imported": []}
    for which in ("built", "imported", "imported", "built"):  # in turns
        model = (make_built if which == "built" else make_imported)().to("cuda")
        rates[which].append(steps_per_s(make_train_step(model), (x, oh), 256, 8))
        del model
        print(f"  throughput on {name} ({card}): {which} {net} b256 {rates[which][-1]:.1f} "
              f"samples/s, {256e3 / rates[which][-1]:.2f} ms a step (make_train_step, 8 steps "
              "back to back)", flush=True)
    torch.cuda.empty_cache()
    return dict(export_s=export_s, import_s=import_s, tflite_bytes=len(buf),
                layers_imported=len(kinds), layers_built=len(built.layers),
                samples_per_s_in_turns=rates,
                step_ms_in_turns={k: [256e3 / r for r in v] for k, v in rates.items()}), runs


def import_demos_and_checks(cli, tmp):
    """The four import demos as processes of their own on the card and with
    --device cpu, one epoch each: the same printed lines; and the demos'
    ONNX, TF and Caffe files through tools/import_model_torch.py --check on
    the card and the CPU: the same printed lines and checkpoints."""
    demos = ("OnnxImportTrain", "TfImportTrain", "CaffeImportTrain", "TFLiteImportTrain")
    jobs = {f"{demo} {dev}": [demo, "--epochs", "1"] + (["--device", "cpu"] if dev == "cpu"
                                                        else [])
            for demo in demos for dev in ("cuda", "cpu")}
    outs = cli_subprocesses(jobs, tmp)
    for demo in demos:
        if outs[f"{demo} cuda"] != outs[f"{demo} cpu"]:
            raise AssertionError(f"{demo}: the card printed {outs[f'{demo} cuda']!r}, the CPU "
                                 f"{outs[f'{demo} cpu']!r}")
    files = {"onnx": ("demo.onnx", cli.onnx_demo_model().SerializeToString(), "1,1,28,28"),
             "tf": ("demo.pb", cli.tf_demo_graph(), "1,28,28,1"),
             "caffe": ("demo.caffemodel", cli.caffe_demo_net(), "1,1,28,28")}
    jobs = {}
    for fmt, (fname, data, shape) in files.items():
        (Path(tmp) / fname).write_bytes(data)
        for dev in ("cuda", "cpu"):
            jobs[f"{fmt} {dev}"] = [fname, "--input-shape", shape, "--check", "--out",
                                    f"{fmt}_{dev}.npz"] + (["--device", "cpu"] if dev == "cpu"
                                                           else [])
    outs = cli_subprocesses(jobs, tmp, tool="tools/import_model_torch.py")
    for fmt in files:
        card_out = outs[f"{fmt} cuda"].replace(f"{fmt}_cuda.npz", "OUT")
        if card_out != outs[f"{fmt} cpu"].replace(f"{fmt}_cpu.npz", "OUT") or \
                "check: one integer train step OK" not in card_out:
            raise AssertionError(f"import_model_torch.py {fmt}: the card and the CPU differ")
        with np.load(Path(tmp) / f"{fmt}_cuda.npz") as a, np.load(Path(tmp) / f"{fmt}_cpu.npz") as b:
            if a.files != b.files or any(not np.array_equal(a[k], b[k]) for k in a.files):
                raise AssertionError(f"import_model_torch.py {fmt}: checkpoints differ")
    print("  the four import demos printed the same lines on the card and the CPU; "
          "import_model_torch.py --check on the ONNX, TF and Caffe demo files gave the same "
          "lines and checkpoints on both", flush=True)


def fused_entries(name_prefix, source, replaces, row, launches, launches_by_run, extra):
    """The kernels-line entries of a two-phase kernel from its timing row."""
    out = []
    for phase in ("max", "requant"):
        name = f"{name_prefix}_{phase}"
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces[phase],
            "launches": launches[name], "launches_by_run": launches_by_run[name],
            "max_abs_err": row["max_abs_err"], "ms": row[phase]["ms"],
            "plain_ms": row[phase]["plain_ms"], "bound_ms": row[phase]["bound_ms"],
            "bound_by": row[phase]["bound_by"], "library_ms": None, **extra[phase]})
    return out


# Phase 16: parallel runs as gloo ranks that share cuda:0 (NCCL refuses two
# ranks on one device). The kernels are built (phase 2) before the ranks start.
PAR_TIMEOUT_S = 300


def run_line(label, results, card):
    """One line a run: each rank's wall ms a step, the collectives a step
    with each rank's host ms in them (each timed from an idle card), those
    of each named site (the residual adds' group max: "add"), and each
    rank's launches by family."""
    sites = [[{k: (n, round(t, 3)) for k, (n, t) in st.items()} for st in r["sites"]]
             for r in results]
    print(f"  [{label}] ({card}): step ms by rank "
          f"{[[round(t, 3) for t in r['step_ms']] for r in results]}; collectives/step "
          f"{results[0]['collectives']} taking, by rank, "
          f"{[[round(t, 3) for t in r['collective_ms']] for r in results]} ms (host timer)"
          + (f", of which by site and rank (count, ms) {sites}" if any(map(any, sites)) else "")
          + f"; launches by rank {[family_counts(r['launches']) for r in results]}", flush=True)


def same_run(label, got, want, what):
    """Byte-identical weights, losses within 1e-5, equal counts."""
    if not params_equal(got["params"], want["params"]):
        raise AssertionError(f"{label}: weights differ from {what}")
    if max(abs(a - b) for a, b in zip(got["losses"], want["losses"])) > 1e-5:
        raise AssertionError(f"{label}: losses {got['losses']} vs {what} {want['losses']}")
    if got.get("correct") != want.get("correct"):
        raise AssertionError(f"{label}: correct {got.get('correct')} vs {what} {want.get('correct')}")


def ranks_agree(label, results):
    for r in results[1:]:
        if not params_equal(r["params"], results[0]["params"]) or r["losses"] != results[0]["losses"]:
            raise AssertionError(f"{label}: the ranks' weights or losses differ")


def parallel_phase(card, lenet_start, recipe_start):
    """The five runs of phase 16; returns their summary and per-run
    launches (summed over the ranks)."""
    x, y = synthetic_mnist(384, seed=160)
    lenet_batches = [(x[i:i + 128].astype(np.float32), onehot_padded(y[i:i + 128], 10, 12))
                     for i in (0, 128)]
    lenet_eval = (x[256:].astype(np.float32), y[256:].astype(np.int64))
    dp_a = dict(model=lenet_niti(), params=lenet_start, batches=lenet_batches, eval=lenet_eval)
    dp_c = dict(dp_a, allreduce="int8")
    xc, yc = synthetic_cifar(512, seed=161)
    mnv2_batches = [(xc[i:i + 256].astype(np.float32), onehot_padded(yc[i:i + 256], 10, 12))
                    for i in (0, 256)]
    dp_b = {mode: dict(model=mobilenet_v2_niti(dw_per_channel=True), params=recipe_start,
                       batches=mnv2_batches, margins=(0, 0), mode=mode)
            for mode in ("matmul_only", "all")}
    xt, yt = synthetic_mnist(128, seed=162)
    tp_model = tp.lenet_niti_tp()
    tp_start = export_jax_params(tp.lenet_niti_tp().reset_parameters(
        torch.Generator().manual_seed(0)))
    tp_d = dict(model=tp_model, params=tp_start, n_data=2, n_model=2,
                batches=[(xt[i:i + 64].astype(np.float32), onehot_padded(yt[i:i + 64], 10, 12))
                         for i in (0, 64)])
    xg, yg = synthetic_mnist(128, seed=163)
    micro = []
    for i in (0, 64):
        x_d, x_e = quantize_microbatches(torch.from_numpy(xg[i:i + 64].astype(np.float32)), 2)
        micro.append((x_d.numpy(), x_e.numpy(), onehot_padded(yg[i:i + 64], 10, 12).reshape(2, 32, 12)))
    pp_e = dict(model=lenet_niti(), params=lenet_start, mb_shape=(32, 28, 28, 1), n_stages=2,
                n_microbatches=2, microbatches=micro)

    cuda, cpu = dict(device="cuda"), dict(device="cpu")
    two = [(runs_mod.dp_steps, dp_a), (runs_mod.dp_steps, dp_c),
           (runs_mod.dp_steps, dp_b["matmul_only"]), (runs_mod.dp_steps, dp_b["all"]),
           (runs_mod.gpipe_steps, pp_e)]
    t0 = time.perf_counter()
    card2 = distributed.run_local(2, runs_mod.sequence, [(f, dict(sp, **cuda)) for f, sp in two],
                                  timeout_s=PAR_TIMEOUT_S, threads=2)
    card4 = distributed.run_local(4, runs_mod.sequence, [(runs_mod.tp_steps, dict(tp_d, **cuda))],
                                  timeout_s=PAR_TIMEOUT_S, threads=2)
    print(f"  ranks on cuda:0 done in {time.perf_counter() - t0:.1f} s", flush=True)
    cpu2 = distributed.run_local(2, runs_mod.sequence,
                                 [(f, dict(sp, **cpu)) for f, sp in (two[0], two[1], two[4])],
                                 timeout_s=PAR_TIMEOUT_S, threads=4)
    cpu4 = distributed.run_local(4, runs_mod.sequence, [(runs_mod.tp_steps, dict(tp_d, **cpu))],
                                 timeout_s=PAR_TIMEOUT_S, threads=2)
    res = {k: [r[i] for r in card2] for i, k in enumerate(("a", "c", "b_mo", "b_all", "e"))}
    res["d"] = [r[0] for r in card4]
    res_cpu = {k: [r[i] for r in cpu2] for i, k in enumerate(("a", "c", "e"))}
    res_cpu["d"] = [r[0] for r in cpu4]

    label = "(a) DP LeNet, world 2, global batch 128, 2 train + 1 eval"
    ranks_agree(label, res["a"])
    single = runs_mod.dp_steps(dict(dp_a, world=0, **cuda))
    same_run(label, res["a"][0], single, what="one process on the card")
    same_run(label, res["a"][0], res_cpu["a"][0], what="the CPU gloo run (plain versions)")
    want = expected_launches(("lenet", 64, "matmul_only"), 2, 1)
    label_c = "(c) the int8 wire on (a)"
    ranks_agree(label_c, res["c"])
    same_run(label_c, res["c"][0], res_cpu["c"][0], what="the CPU gloo run (plain versions)")
    if params_equal(res["c"][0]["params"], res["a"][0]["params"]):
        raise AssertionError("the int8 wire gave the int32 wire's weights")
    for key, tag in ((label, "a"), (label_c, "c")):
        for r in res[tag]:
            if family_counts(r["launches"]) != want:
                raise AssertionError(f"{key}: a rank launched {family_counts(r['launches'])}, "
                                     f"expected {want} (one process at b64)")
    for mode, tag in (("matmul_only", "b_mo"), ("all", "b_all")):
        lb = f"(b) DP MobileNetV2 r5 recipe full width, world 2, global 256, {mode}"
        ranks_agree(lb, res[tag])
        with dw_ops.recipe_margins():
            one = runs_mod.dp_steps(dict(dp_b[mode], world=0, **cuda))
        same_run(lb, res[tag][0], one, what="one process on the card at b256")
        want_b = expected_launches(("mnv2pc", 128, mode), 2, 0)
        for r in res[tag]:
            if family_counts(r["launches"]) != want_b:
                raise AssertionError(f"{lb}: a rank launched {family_counts(r['launches'])}, "
                                     f"expected {want_b} (one process at b128)")
        run_line(lb, res[tag], card)
    run_line(label, res["a"], card)
    run_line(label_c, res["c"], card)
    label_d = "(d) TP lenet_niti_tp on a 2x2 mesh, batch 64, 2 steps"
    full = runs_mod.tp_weights(res["d"], tp_model)
    full_cpu = runs_mod.tp_weights(res_cpu["d"], tp_model)
    tp_single = runs_mod.dp_steps(dict(tp_d, world=0, **cpu))
    for what, other in (("the CPU gloo run", full_cpu), ("one process on the CPU",
                                                        tp_single["params"])):
        if not params_equal(full, other):
            raise AssertionError(f"{label_d}: weights differ from {what}")
    run_line(label_d, res["d"], card)
    label_e = "(e) GPipe LeNet, 2 stages, M = 2, 2 steps"
    if not params_equal(runs_mod.pipeline_weights(res["e"]),
                        runs_mod.pipeline_weights(res_cpu["e"])):
        raise AssertionError(f"{label_e}: weights differ from the CPU gloo run")
    if max(abs(a - b) for a, b in zip(res["e"][0]["losses"], res_cpu["e"][0]["losses"])) > 1e-5:
        raise AssertionError(f"{label_e}: losses differ from the CPU gloo run")
    run_line(label_e, res["e"], card)
    for tag in ("d", "e"):
        for r in res[tag]:
            if not r["launches"]["matmul_int8"]:
                raise AssertionError(f"run ({tag}): a rank launched no K1")
    launches = {f"parallel_{tag}": {n: sum(r["launches"][n] for r in results)
                                     for n in results[0]["launches"]}
                for tag, results in res.items()}
    summary = {tag: {"ranks": len(results),
                     "step_ms": [r["step_ms"] for r in results],
                     "collectives_per_step": results[0]["collectives"],
                     "collective_ms": [r["collective_ms"] for r in results],
                     "collective_sites": [r["sites"] for r in results],
                     "launches_per_rank": [family_counts(r["launches"]) for r in results]}
               for tag, results in res.items()}
    print("  phase 16: (a)-(e) byte-equal to their references; every DP rank launched "
          "K1, K2 (MobileNetV2), K4, K5 and, in 'all', K3", flush=True)
    return summary, launches


GRAPH_STEPS = 20


def graph_data(batch, side, channels, classes, logits, seed, n=GRAPH_STEPS):
    """n seeded batches of integer pixels at (batch, side, side, channels),
    made on the card, their one-hot labels (`classes` in `logits`
    channels), and one more batch and its labels for the eval steps."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randint(0, 256, (batch, side, side, channels), generator=gen, device="cuda")
          .to(torch.float32) for _ in range(n + 1)]
    ys = np.random.default_rng(seed).integers(0, classes, (n + 1, batch))
    ohs = [torch.from_numpy(onehot_padded(y, classes, logits)).cuda() for y in ys[:n]]
    return xs[:n], ohs, xs[n], torch.from_numpy(ys[n].astype(np.int64)).cuda()


def snapshot(model):
    return [t.detach().clone() for t in itertools.chain(model.parameters(), model.buffers())]


def same_bytes(a, b) -> bool:
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def in_turns(calls, steps, args):
    """ms per step of each (name, step) of `calls`, in turns A B B A: the
    step called `steps` times back to back on `args` (cycled), synchronised
    at both ends, on the host clock."""
    out = collections.defaultdict(list)
    for name, step in calls + calls[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(*args[i % len(args)])
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) * 1e3 / steps)
    return dict(out)


def niti_steps(model, classes, compiled, kind):
    """(train step, eval step) of a NITI model or a TransferModel, eager or
    compiled (jit_train_step / jit_eval_step; the transfer steps through
    compile_step, as the JAX demo jits them)."""
    if kind == "transfer":
        steps = (make_transfer_train_step(model), make_transfer_eval_step(model, classes))
        return tuple(step_graph.compile_step(s, "cuda") for s in steps) if compiled else steps
    if compiled:
        return jit_train_step(model), jit_eval_step(model, classes)
    return make_train_step(model), make_eval_step(model, classes)


def compiled_niti(label, key, make_model, data, classes=NUM_CLASSES, kind="niti",
                  recipe=False, timing_steps=10):
    """Phase 17 for one NITI configuration: GRAPH_STEPS train steps and two
    eval steps eager and compiled (the first call of each the warm-up and
    capture, the rest replays) from the same params on the same batches:
    params (all of the model's tensors), losses and correct counts
    byte-identical; the compiled run after 2 steps (one replay) byte-
    identical to 2 steps of the plain versions on the card; every replayed
    step's launches, by family, the EXPECTED_PER_STEP rows; then ms per
    step in turns. -> (the line's dict, the replays' launches)."""
    _, batch, mode = key
    xs, ohs, xe, ye = data
    margins = dw_ops.recipe_margins() if recipe else contextlib.nullcontext()
    with use_fused_conv_mode(mode), margins:
        eager = make_model().to("cuda")
        step_e, eval_e = niti_steps(eager, classes, False, kind)
        losses_e = [float(step_e(x, oh)) for x, oh in zip(xs, ohs)]
        correct_e = [int(eval_e(xe, ye)) for _ in range(2)]

        model = make_model().to("cuda")
        step, evals = niti_steps(model, classes, True, kind)
        kernels.reset_launch_counts()
        losses = []
        for i, (x, oh) in enumerate(zip(xs, ohs)):
            if i == 1:  # the replays from here on
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
            losses.append(step(x, oh))
            if i == 1:
                after_two = snapshot(model)
        torch.cuda.synchronize()
        replays = kernels.launch_counts()
        train_launches = family_counts(replays)
        correct = [int(evals(xe, ye))]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        correct.append(int(evals(xe, ye)))
        torch.cuda.synchronize()
        eval_counts = kernels.launch_counts()
        eval_launches = family_counts(eval_counts)
        kernels.reset_launch_counts()
        losses = [float(v) for v in losses]

        plain = make_model().to("cuda")
        step_p, _ = niti_steps(plain, classes, False, kind)
        with kernels.use_backend("torch"):
            for x, oh in zip(xs[:2], ohs[:2]):
                step_p(x, oh)
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"{label}: the plain versions launched kernels")
        if not same_bytes(snapshot(model), snapshot(eager)) or losses != losses_e \
                or correct != correct_e:
            raise AssertionError(f"{label}: the replayed steps differ from the eager ones "
                                 f"(losses {losses} vs {losses_e}, correct {correct} vs "
                                 f"{correct_e})")
        if not same_bytes(after_two, snapshot(plain)):
            raise AssertionError(f"{label}: 2 compiled steps differ from the plain versions'")
        if not all(np.isfinite(losses)) or same_bytes(snapshot(model),
                                                      snapshot(make_model().to("cuda"))):
            raise AssertionError(f"{label}: losses {losses}, or the params did not move")
        per_train, per_eval = EXPECTED_PER_STEP[key]
        want = {f: (GRAPH_STEPS - 1) * n for f, n in per_train.items()}
        if train_launches != want or eval_launches != per_eval:
            raise AssertionError(f"{label}: launches of {GRAPH_STEPS - 1} replayed train steps "
                                 f"{train_launches} (want {want}), of a replayed eval step "
                                 f"{eval_launches} (want {per_eval})")
        if step.graphs != 1 or evals.graphs != 1:
            raise AssertionError(f"{label}: {step.graphs} train and {evals.graphs} eval graphs")
        ms = in_turns([("eager", step_e), ("replayed", step)], timing_steps,
                      list(zip(xs, ohs)))
    line = dict(config=label, key=list(key), steps=GRAPH_STEPS, byte_identical=True,
                plain_two_steps_byte_identical=True, losses_first_last=[losses[0], losses[-1]],
                correct=correct, launches_per_replayed_train_step={
                    f: n // (GRAPH_STEPS - 1) for f, n in train_launches.items()},
                launches_per_replayed_eval_step=eval_launches,
                ms_per_step_in_turns=ms, timing_steps=timing_steps)
    print(f"  [phase 17] {json.dumps(line)}", flush=True)
    del eager, model, plain, step_e, eval_e, step, evals
    torch.cuda.empty_cache()
    return line, {k: replays[k] + eval_counts[k] for k in replays}


def float_run(cls, data, compiled):
    """GRAPH_STEPS steps of `train_fp32_bn`'s float step (its lr a 0-d
    tensor) and two eval steps of a float twin drawn from seed 0, eager or
    compiled -> (its tensors, losses, correct counts, the train step)."""
    xs, ohs, lrs, xe, ye = data
    model = cls().reset_parameters(torch.Generator().manual_seed(0)).to("cuda")
    params = list(model.parameters())
    step = make_float_step(model, params, sgd_init(params), training=True)
    evals = make_float_eval_step(model)
    if compiled:
        step, evals = (step_graph.compile_step(f, "cuda") for f in (step, evals))
    losses = [float(step(x, oh, lr)) for x, oh, lr in zip(xs, ohs, lrs)]
    return snapshot(model), losses, [int(evals(xe, ye)) for _ in range(2)], step


def max_rel_diff(a, b) -> float:
    """The largest difference of two lists of tensors, each relative to the
    largest magnitude of b's tensor."""
    return max(float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))
               for x, y in zip(a, b))


def compiled_float(label, cls, batch, timing_steps=10):
    """Phase 17 for a float twin, TF32 off: GRAPH_STEPS train steps and two
    eval steps of `train_fp32_bn`'s float step, eager and compiled, from the
    same params on the same batches. With cuDNN's default (heuristic)
    algorithms two eager runs already differ where an algorithm adds in an
    order that varies (reported beside the compiled run's difference); with
    `cudnn.deterministic` the compiled run must equal the eager one bitwise,
    or within 1e-5 of each tensor's largest magnitude (reported which), with
    equal correct counts. Then ms per step in turns, default algorithms."""
    xs, ohs, xe, ye = graph_data(batch, 32, 3, NUM_CLASSES, NUM_CLASSES, seed=batch + 1)
    data = ([x / 127.5 - 1 for x in xs], [oh.to(torch.float32) for oh in ohs],
            [torch.full((), lr_inv(0.01, it), device="cuda") for it in range(GRAPH_STEPS)],
            xe / 127.5 - 1, ye)
    with full_float32():
        eager, again, graph = (float_run(cls, data, c) for c in (False, False, True))
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            det_eager, det_graph = (float_run(cls, data, c)[:3] for c in (False, True))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        bitwise = same_bytes(det_eager[0], det_graph[0]) and det_eager[1] == det_graph[1]
        worst = max_rel_diff(det_graph[0], det_eager[0])
        if not (bitwise or worst <= 1e-5) or det_eager[2] != det_graph[2] \
                or not all(np.isfinite(det_graph[1])):
            raise AssertionError(f"{label}: compiled {worst} from eager under deterministic "
                                 f"cuDNN (losses {det_graph[1]} vs {det_eager[1]}, correct "
                                 f"{det_graph[2]} vs {det_eager[2]})")
        ms = in_turns([("eager", eager[3]), ("replayed", graph[3])], timing_steps,
                      list(zip(*data[:3])))
    line = dict(config=label, steps=GRAPH_STEPS, deterministic_cudnn_bitwise_equal=bitwise,
                deterministic_cudnn_max_rel_diff=worst,
                default_cudnn_eager_vs_eager_max_rel_diff=max_rel_diff(again[0], eager[0]),
                default_cudnn_compiled_vs_eager_max_rel_diff=max_rel_diff(graph[0], eager[0]),
                losses_first_last=[det_graph[1][0], det_graph[1][-1]], correct=det_graph[2],
                ms_per_step_in_turns=ms, timing_steps=timing_steps)
    print(f"  [phase 17] {json.dumps(line)}", flush=True)
    del eager, again, graph
    torch.cuda.empty_cache()
    return line


def compiled_train_niti():
    """`train_niti` for 2 epochs of the NITI LeNet at batch 64 through its
    compiled steps and, its jit steps swapped for the eager ones, through
    the eager loop, from the same params: the same log lines (but for the
    timer) and byte-identical params."""
    train, test = synthetic_mnist(64 * 16, seed=170), synthetic_mnist(64 * 4, seed=171)
    runs = []
    for graphs in (True, False):
        lines = []
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(swapped(trainer_mod, "jit_train_step", make_train_step))
                stack.enter_context(swapped(trainer_mod, "jit_eval_step", make_eval_step))
            model, acc = train_niti(train, test, epochs=2, batch=64, seed=3, log=lines.append,
                                    device="cuda")
        runs.append((snapshot(model), [ln.split(" [")[0] for ln in lines], acc, lines))
    if not same_bytes(runs[0][0], runs[1][0]) or runs[0][1:3] != runs[1][1:3]:
        raise AssertionError(f"train_niti through the graphs {runs[0][3]} != eager {runs[1][3]}")
    for ln, eager_ln in zip(runs[0][3], runs[1][3]):
        print(f"  [phase 17, train_niti LeNet b64] graphs: {ln}\n"
              f"  [phase 17, train_niti LeNet b64] eager:  {eager_ln}", flush=True)
    return dict(config="train_niti lenet b64 2 epochs", log_lines_equal=True,
                params_byte_identical=True, graphs=runs[0][3], eager=runs[1][3])


@contextlib.contextmanager
def swapped(module, name, value):
    """module.name is `value` while inside."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def compiled_phase():
    """Phase 17: the compiled step (train/step_graph.py) at every
    configuration, each one's graphs freed before the next -> (the lines,
    the replays' launches by configuration)."""
    def seeded(build, **kw):
        return lambda: build(**kw).reset_parameters(torch.Generator().manual_seed(0))

    configs = [
        ("lenet b64", ("lenet", 64, "matmul_only"), seeded(lenet_niti), (28, 1), {}),
        ("lenet b2048", ("lenet", 2048, "matmul_only"), seeded(lenet_niti), (28, 1), {}),
        ("mnv2 b256", ("mnv2", 256, "matmul_only"), seeded(mobilenet_v2_niti), (32, 3), {}),
        ("mnv2 recipe b256", ("mnv2pc", 256, "matmul_only"),
         seeded(mobilenet_v2_niti, dw_per_channel=True), (32, 3), dict(recipe=True)),
        ("resnet18 b256 matmul_only", ("resnet18", 256, "matmul_only"), seeded(resnet18_niti),
         (32, 3), {}),
        ("resnet18 b256 all", ("resnet18", 256, "all"), seeded(resnet18_niti), (32, 3), {}),
        ("inceptionv3 b32 299 matmul_only", ("inceptionv3", 32, "matmul_only"),
         seeded(inceptionv3_niti, num_classes=1000), (299, 3),
         dict(classes=1000, timing_steps=5)),
        ("inceptionv3 b32 299 all", ("inceptionv3", 32, "all"),
         seeded(inceptionv3_niti, num_classes=1000), (299, 3),
         dict(classes=1000, timing_steps=5)),
        ("mnv2_transfer b256", ("mnv2_transfer", 256, "matmul_only"), mnv2_transfer_model,
         (32, 3), dict(kind="transfer")),
    ]
    lines, launches = [], {}
    for label, key, make_model, (side, channels), kw in configs:
        classes = kw.get("classes", NUM_CLASSES)
        logits = NITI_LOGIT_CHANNELS if classes == NUM_CLASSES else classes
        data = graph_data(key[1], side, channels, classes, logits, seed=len(lines) + 17)
        line, launches[f"graph_{label.replace(' ', '_')}"] = compiled_niti(
            label, key, make_model, data, **kw)
        lines.append(line)
        del data
    lines.append(compiled_float("ResNet18FP32 b256 (train_fp32_bn's step)", ResNet18FP32, 256))
    lines.append(compiled_train_niti())
    return lines, launches


# Phase 18: the rest of the JAX package. The fine-tuning steps' batch and
# calls, the per-op profile's traced calls and its configurations.
TUNE_BATCH, TUNE_STEPS, PROFILE_ITERS = 64, 20, 3
PROFILED = (("lenet b64", ("lenet", 64, "matmul_only"), lenet_niti, (28, 1)),
            ("mnv2 b256", ("mnv2", 256, "matmul_only"), mobilenet_v2_niti, (32, 3)))


def tune_runs(cli):
    """(name, make) of the fine-tuning and sanity steps: make(compiled)
    -> (step, [args of each call], the state the steps write), each from
    its seeds; the dropout generators on the card. The LeNets take
    TUNE_BATCH samples a call; LinearRegression its 256 points."""
    x, y = synthetic_mnist(TUNE_BATCH * TUNE_STEPS, seed=180)
    raw = [torch.from_numpy(x[i * TUNE_BATCH:(i + 1) * TUNE_BATCH].astype(np.float32)).cuda()
           for i in range(TUNE_STEPS)]
    normed = [(r / 255.0 - 0.5) * 2.0 for r in raw]
    ohs = [torch.from_numpy(onehot_padded(y[i * TUNE_BATCH:(i + 1) * TUNE_BATCH], NUM_CLASSES,
                                          NUM_CLASSES).astype(np.float32)).cuda()
           for i in range(TUNE_STEPS)]
    lrs = [torch.full((), lr_inv(0.01, i), device="cuda") for i in range(TUNE_STEPS)]
    teacher = LeNetFP32().reset_parameters(torch.Generator().manual_seed(0)).cuda()

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def compiled(step, on):
        return step_graph.compile_step(step, "cuda") if on else step

    def qat(on):
        model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0)).cuda()
        return (compiled(make_qat_train_step(model, gen(1)), on), list(zip(normed, ohs, lrs)),
                model)

    def teacher_step(on):
        model = LeNetFP32().reset_parameters(torch.Generator().manual_seed(0)).cuda()
        return compiled(make_teacher_step(model), on), list(zip(raw, ohs)), model

    def distill(on):
        model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(1)).cuda()
        return (compiled(make_distill_step(model, teacher, gen(2)), on), list(zip(raw, ohs)),
                model)

    def linear_regression(on):
        xs, ys, w, b = cli.linear_regression_data("cuda")
        return (compiled(cli.make_linear_regression_step(w, b), on), [(xs, ys)] * TUNE_STEPS,
                [w, b])

    def predict(on):
        model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0)).cuda()
        make_qat_train_step(model)(normed[0], ohs[0], lrs[0])  # observers set, as in training
        step = compiled(make_predict_step(model), on)
        return step, [(n,) for n in normed], model

    return (("MnistInt8Train step (LeNetQAT, dropout)", qat),
            ("DistillTrainQuant teacher step (LeNetFP32)", teacher_step),
            ("DistillTrainQuant student step (LeNetQAT, dropout)", distill),
            ("LinearRegression step", linear_regression),
            ("MnistInt8Train predict", predict))


def state_of(state):
    return snapshot(state) if isinstance(state, torch.nn.Module) else [t.clone() for t in state]


def compiled_tuning(cli):
    """(A): each fine-tuning step TUNE_STEPS times eagerly and through
    compile_step (the first call the warm-up and capture, then replays)
    from the same seeds, dropout on, under cudnn.deterministic: outputs and
    state bitwise equal, one graph; then ms per step in turns (A B B A,
    default cuDNN algorithms, whose graph is captured before the timing)
    -> one line each."""
    lines = []
    for label, build_run in tune_runs(cli):
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            outs = {}
            for on in (False, True):
                step, args, state = build_run(on)
                outs[on] = ([step(*a).clone() for a in args], state_of(state), step, args)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        (eager_out, eager_state, eager, _), (graph_out, graph_state, graph, args) = \
            outs[False], outs[True]
        if not same_bytes(eager_out, graph_out) or not same_bytes(eager_state, graph_state):
            raise AssertionError(f"{label}: {TUNE_STEPS} replayed steps differ from the eager ones")
        if graph.graphs != 1:
            raise AssertionError(f"{label}: {graph.graphs} graphs for one signature")
        graph(*args[0])  # the default algorithms' signature captured before the timing
        ms = in_turns([("eager", eager), ("replayed", graph)], TUNE_STEPS, args)
        line = dict(step=label, steps=TUNE_STEPS, bitwise_equal=True, graphs=1,
                    first_last=[float(graph_out[0].float().mean()),
                                float(graph_out[-1].float().mean())],
                    ms_per_step_in_turns=ms)
        print(f"  [phase 18 (A)] {json.dumps(line)}", flush=True)
        lines.append(line)
    return lines


def profiled_steps(card):
    """(B): per_op_profile's tables (profiler.trace_device_events, then
    device_trace.per_op_rows / by_category) of PROFILE_ITERS replays of the
    compiled LeNet b64 and MNv2 b256 steps: every launch counter's
    occurrences EXPECTED_PER_STEP's row times PROFILE_ITERS; the rows' device
    time within 5% of the traced busy time (on one stream the rows sum to
    the busy union by construction); flops_per_step of the step's eager
    form on the card equal to the meta device's figure in both fused modes
    -> (lines, launches by run)."""
    lines, launches = [], {}
    for label, key, build_model, (side, channels) in PROFILED:
        xs, ohs, _, _ = graph_data(key[1], side, channels, NUM_CLASSES, NITI_LOGIT_CHANNELS,
                                   seed=181, n=1)
        model = build_model().reset_parameters(torch.Generator().manual_seed(0)).cuda()
        step = jit_train_step(model)
        kernels.reset_launch_counts()
        events = profiler.trace_device_events(step, xs[0], ohs[0], iters=PROFILE_ITERS)
        torch.cuda.synchronize()
        launches[f"profiled_{label.replace(' ', '_')}"] = kernels.launch_counts()
        rows = device_trace.per_op_rows(events)
        cats = {c["category"]: c for c in device_trace.by_category(rows)}
        per_train = EXPECTED_PER_STEP[key][0]
        for fam, names in FAMILIES.items():
            for counter in names:
                got = cats.get(counter, {}).get("occurrences", 0)
                if got != per_train.get(fam, 0) * PROFILE_ITERS:
                    raise AssertionError(f"{label}: {got} {counter} kernels in {PROFILE_ITERS} "
                                         f"traced replays, want {per_train.get(fam, 0)} each")
        busy = device_trace.overlap_report(events)["busy_us"]
        summed = sum(r["total_us"] for r in rows)
        if not busy or abs(summed - busy) > 0.05 * busy:
            raise AssertionError(f"{label}: rows sum to {summed} us, the trace was busy {busy} us")
        # the count comes from shapes at each op's entry, so it cannot differ
        # by device or fused mode by construction: one eager step on the
        # card (the compiled step's eager form), the two modes on the meta
        # device
        figure = profiler.flops_per_step(step, xs[0], ohs[0])
        for mode in ("matmul_only", "all"):
            with use_fused_conv_mode(mode):
                m = build_model().reset_parameters(torch.Generator().manual_seed(0)).to("meta")
                n = profiler.flops_per_step(make_train_step(m), xs[0].to("meta"),
                                            ohs[0].to("meta"))
            if n != figure:
                raise AssertionError(f"{label}: flops_per_step {n} on the meta device under "
                                     f"{mode}, {figure} on the card")
        k_flops = sum(c["flops"] for c in cats.values()) / PROFILE_ITERS
        line = dict(config=f"{label} compiled", iters=PROFILE_ITERS, card=card,
                    flops_per_step=figure, host_figure_on="meta",
                    busy_us_per_step=busy / PROFILE_ITERS,
                    rows_us_per_step=summed / PROFILE_ITERS,
                    kernel_row_flops_per_step=k_flops,
                    by_category_per_step={c: (v["occurrences"] / PROFILE_ITERS,
                                              v["total_us"] / PROFILE_ITERS)
                                          for c, v in cats.items()})
        print(f"  [phase 18 (B)] {json.dumps(line)}", flush=True)
        print(device_trace.format_table(device_trace.by_category(rows)), flush=True)
        lines.append(line)
        del model, step
        torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    return lines, launches


def two_hosts_dp(card, lenet_start):
    """(C): DP LeNet over make_global_mesh as 2 hosts x 2 gloo ranks on
    cuda:0 (run_local's local_world), global batch 128, 2 train steps and
    one eval step, each rank feeding its local_batch_slice: equal to one
    process on the card; each rank's step ms (a cost of record)."""
    x, y = synthetic_mnist(384, seed=182)
    spec = dict(model=lenet_niti(), params=lenet_start, device="cuda", global_mesh=True,
                batches=[(x[i:i + 128].astype(np.float32), onehot_padded(y[i:i + 128], 10, 12))
                         for i in (0, 128)],
                eval=(x[256:].astype(np.float32), y[256:].astype(np.int64)))
    label = "(C) DP LeNet over make_global_mesh, 2 hosts x 2 ranks, global batch 128"
    res = [r[0] for r in distributed.run_local(4, runs_mod.sequence, [(runs_mod.dp_steps, spec)],
                                               timeout_s=PAR_TIMEOUT_S, threads=2,
                                               local_world=2)]
    ranks_agree(label, res)
    if [(r["host"], r["local_world"]) for r in res] != [(0, 2), (0, 2), (1, 2), (1, 2)]:
        raise AssertionError(f"{label}: hosts {[(r['host'], r['local_world']) for r in res]}")
    same_run(label, res[0], runs_mod.dp_steps(dict(spec, world=0, global_mesh=False)),
             what="one process on the card")
    run_line(label, res, card)
    return ({"step_ms": [r["step_ms"] for r in res], "hosts": [r["host"] for r in res],
             "launches_per_rank": [family_counts(r["launches"]) for r in res]},
            {"global_mesh_dp": {n: sum(r["launches"][n] for r in res) for n in res[0]["launches"]}})


def native_build():
    """(D): build_native() on this machine; where it built, the built
    library's loader gives the Python DataLoader's batches (unshuffled).
    Where it did not (no compiler or libjpeg), that is printed and is no
    failure, as in the JAX package."""
    print("  build_native (the compiler's output follows):", flush=True)
    built = native_mod.build_native(quiet=False)
    out = {"built": built}
    if built:
        lib = native_mod.load_native(auto_build=False)
        x, y = synthetic_mnist(256, seed=183)
        got = list(native_mod.NativeLoader(x, y, 64, shuffle=False).epoch())
        want = list(DataLoader(x, y, 64, shuffle=False).epoch())
        if len(got) != len(want) or not all(a.tobytes() == c.tobytes() and np.array_equal(b, d)
                                            for (a, b), (c, d) in zip(got, want)):
            raise AssertionError("the built native loader's batches differ from the Python "
                                 "DataLoader's")
        out.update(library=getattr(lib, "_name", None), batches_equal=len(got))
    print(f"  [phase 18 (D)] {json.dumps(out)}", flush=True)
    return out


def rest_phase(card, lenet_start):
    """Phase 18 -> (its summary, its launches by run)."""
    t0 = time.perf_counter()
    cli = load_tool("tools/run_train_demo_torch.py")
    kernels.reset_launch_counts()
    tuning = compiled_tuning(cli)
    profiled, launches = profiled_steps(card)
    dp_summary, dp_launches = two_hosts_dp(card, lenet_start)
    launches.update(dp_launches)
    native = native_build()
    print(f"  phase 18 done in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(compiled_fine_tuning=tuning, per_op_profile=profiled, global_mesh_dp=dp_summary,
                native_build=native), launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs the GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    enter("1", "the card's name and power limit (nvidia-smi)")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rates = peak_rates(name)
    mac_rate = int8_mac_rate()
    int_rate = mac_rate / 4  # 32-bit integer operations on the CUDA cores: 64 per SM and clock
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks from the {rates[2]}: "
          f"{rates[0] / 1e12:.0f} int8 TOP/s, {rates[1] / 1e12:.2f} TB/s; CUDA-core int8 "
          f"multiply-adds {mac_rate / 1e12:.2f} T/s (IDP4A: SMs x 64 x 4 x max SM clock)",
          flush=True)

    t0 = time.perf_counter()
    enter("2", "build every kernel of csrc/ (nvcc, sm_90a, one process per source)")
    logs = build.build_all()
    print(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib, log in logs.items():
        lines = log.splitlines()
        for ln in lines:
            if ("registers" in ln or "spill" in ln) and "C7519" not in ln:
                print(f"  [{lib}] {ln.strip()}", flush=True)
        injected = sum("C7519" in ln for ln in lines)
        if injected:
            print(f"  [{lib}] ptxas injected warpgroup.arrive (C7519, to use registers in GMMA) "
                  f"at {injected} places", flush=True)

    enter("3", "kernels against their plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_rows = check_k1(rates, gen)
    k2_rows = check_k2(rates, gen)
    k3_rows, k3_err = check_k3(rates, gen)
    k4_rows, k4_err = check_k4(rates, mac_rate, int_rate, gen)
    k5_rows, k5_err = check_k5(rates, mac_rate, gen)
    k7_nets, k7_err = check_k7(rates, int_rate, gen)
    k8_step, k8_err = check_k8(rates, gen)

    runs = {}
    start = export_jax_params(lenet_niti().reset_parameters(torch.Generator().manual_seed(0)))
    plain_both = [("cuda", "torch"), ("cpu", "cuda")]
    enter("4", "LeNet main path at batch 64")
    run64, runs["lenet_b64"], seen64 = main_path(
        "lenet b64", ("lenet", 64, "matmul_only"), synthetic_mnist(64, seed=128),
        synthetic_mnist(64, seed=129), 3, start, plain_both, record=RECORD_K1)
    shapes = set(seen64["K1"])
    want_shapes = {tuple(c[1:]) for c in K1_SHAPES}
    if shapes != want_shapes:
        raise AssertionError(f"K1 shapes of the step {sorted(shapes)} != checked {sorted(want_shapes)}")
    x64, y64 = synthetic_mnist(64, seed=7)
    per_step_counts(("lenet", 64, "matmul_only"), run64["model"], x64, y64, NITI_LOGIT_CHANNELS)

    enter("5", "LeNet main path at batch 2048")
    _, runs["lenet_b2048"], _ = main_path(
        "lenet b2048", ("lenet", 2048, "matmul_only"), synthetic_mnist(2048, seed=4096),
        synthetic_mnist(2048, seed=4097), 2, start, plain_both)
    rate64, line64 = throughput(64, 50, start)
    rate2k, line2k = throughput(2048, 10, start)
    print(f"  throughput on {name}: LeNet batch 64 {rate64:.0f} samples/s [{line64}]", flush=True)
    print(f"  throughput on {name}: LeNet batch 2048 {rate2k:.0f} samples/s [{line2k}]", flush=True)

    enter("6", 'LeNet at batch 64 under fused mode "all" (K3)')
    run_all, runs["lenet_all_b64"], _ = main_path(
        "lenet all b64", ("lenet", 64, "all"), synthetic_mnist(128, seed=5),
        synthetic_mnist(64, seed=6), 1, start, [("cuda", "torch")])
    per_step_counts(("lenet", 64, "all"), run_all["model"], x64, y64, NITI_LOGIT_CHANNELS)

    enter("7", "MobileNetV2 (full width, per-tensor depthwise) on synthetic CIFAR")
    mnv2_start = export_jax_params(
        mobilenet_v2_niti().reset_parameters(torch.Generator().manual_seed(0)))
    cifar_train, cifar_test = synthetic_cifar(512, seed=0), synthetic_cifar(256, seed=1)
    record_mn = {**RECORD_K1, **RECORD_K2, **RECORD_K4, **RECORD_K5}
    run_mn, runs["mnv2_b256"], seen_mn = main_path(
        "mnv2 b256", ("mnv2", 256, "matmul_only"), cifar_train, cifar_test, 1, mnv2_start,
        [("cuda", "torch")], model_fn=mobilenet_v2_niti, record=record_mn)
    xc, yc = synthetic_cifar(256, seed=2)
    _, seen_steps = per_step_counts(("mnv2", 256, "matmul_only"), run_mn["model"], xc, yc,
                                    NITI_LOGIT_CHANNELS, record=record_mn)
    n_train, n_eval = len(cifar_train[0]) // 256, len(cifar_test[0]) // 256
    k4_keys = {(xs, k, pads, dil) for _, xs, k, pads, dil in K4_PATH_CASES}
    k4_per_step = path_step_weights("K4", seen_mn, n_train, n_eval, seen_steps, k4_keys)
    k5_per_step = path_step_weights("K5", seen_mn, n_train, n_eval, seen_steps,
                                    K5_PATH_KEYS)
    k1_per_step = path_step_weights("K1", seen_mn, n_train, n_eval, seen_steps)
    k2_per_step = path_step_weights("K2", seen_mn, n_train, n_eval, seen_steps, K2_PATH_CASES)
    _, runs["mnv2_b32"], _ = main_path(
        "mnv2 b32", ("mnv2", 32, "matmul_only"), synthetic_cifar(32, seed=3),
        synthetic_cifar(32, seed=4), 1, mnv2_start, [("cpu", "cuda")],
        model_fn=mobilenet_v2_niti)
    run_mn_all, runs["mnv2_all_b256"], _ = main_path(
        "mnv2 all b256", ("mnv2", 256, "all"), cifar_train, cifar_test, 1, mnv2_start,
        [("cuda", "torch")], model_fn=mobilenet_v2_niti)
    per_step_counts(("mnv2", 256, "all"), run_mn_all["model"], xc, yc, NITI_LOGIT_CHANNELS)
    rate_mn, line_mn = throughput(256, 10, mnv2_start, mobilenet_v2_niti, synthetic_cifar)
    print(f"  throughput on {name} ({card}): MobileNetV2 batch 256 {rate_mn:.1f} samples/s "
          f"[{line_mn}]", flush=True)
    print(f"  K1 at the {len(k1_per_step)} shapes of a MobileNetV2 batch-256 train step, "
          f"against torch._int_mm (the yardstick)", flush=True)
    k1_mn_rows = k1_library_rows(k1_per_step, rates, gen)
    k1_mn = k1_library_summary(k1_mn_rows)
    print(f"  K1 over one train step ({k1_mn['launches']} launches): {k1_mn['ms']:.4f} ms (cold "
          f"{k1_mn['cold_ms']:.4f}), plain {k1_mn['plain_ms']:.4f} ms, bound {k1_mn['bound_ms']:.4f} ms;"
          f" A row-major ({k1_mn['a']['all_launches']} launches) {k1_mn['a']['all_ms']:.4f} ms, A "
          f"MN-major ({k1_mn['a_t']['all_launches']}) {k1_mn['a_t']['all_ms']:.4f} ms; on the "
          f"{k1_mn['library_launches']} launches _int_mm takes: K1 "
          f"{k1_mn['ms_where_library_takes']:.4f} ms, _int_mm {k1_mn['library_ms']:.4f} ms "
          f"(A row-major: {k1_mn['a']['launches']} launches, K1 {k1_mn['a']['ms']:.4f} ms, _int_mm "
          f"{k1_mn['a']['library_ms']:.4f} ms; A MN-major: {k1_mn['a_t']['launches']} launches, K1 "
          f"{k1_mn['a_t']['ms']:.4f} ms, _int_mm {k1_mn['a_t']['library_ms']:.4f} ms)", flush=True)
    print(f"  K2 at the {len(k2_per_step)} shapes of a MobileNetV2 batch-256 train step", flush=True)
    k2_mn_rows = k2_path_rows(k2_per_step, rates, int_rate, gen)
    k2_mn = k2_path_summary(k2_mn_rows, rates)
    for ph in ("max", "requant"):
        t = k2_mn[ph]
        print(f"  K2 {ph} over one train step ({k2_mn['launches']} launches): {t['ms']:.4f} ms "
              f"(cold {t['cold_ms']:.4f}), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})"
              + (f", psto epilogue floor {t['epilogue_floor_ms']:.4f} ms" if ph == "requant" else ""),
              flush=True)

    enter("8", "the r5 recipe (per-channel depthwise exponents, filter-grad margins "
          "0/0) at full width")
    recipe_fn = functools.partial(mobilenet_v2_niti, dw_per_channel=True)
    recipe_start = export_jax_params(recipe_fn().reset_parameters(torch.Generator().manual_seed(0)))
    with dw_ops.recipe_margins():
        run_pc, runs["mnv2pc_b256"], seen_pc = main_path(
            "mnv2pc b256", ("mnv2pc", 256, "matmul_only"), cifar_train, cifar_test, 1,
            recipe_start, [("cuda", "torch")], model_fn=recipe_fn,
            record={**RECORD_K4, **RECORD_K5})
        _, seen_pc_steps = per_step_counts(("mnv2pc", 256, "matmul_only"), run_pc["model"], xc,
                                           yc, NITI_LOGIT_CHANNELS,
                                           record={**RECORD_K4, **RECORD_K5})
        k4_pc_per_step = path_step_weights("K4", seen_pc, n_train, n_eval, seen_pc_steps,
                                           k4_keys)
        path_step_weights("K5", seen_pc, n_train, n_eval, seen_pc_steps,
                          K5_PATH_KEYS)
        _, runs["mnv2pc_b32"], _ = main_path(
            "mnv2pc b32", ("mnv2pc", 32, "matmul_only"), synthetic_cifar(32, seed=3),
            synthetic_cifar(32, seed=4), 1, recipe_start, [("cpu", "cuda")], model_fn=recipe_fn)
        # MobilenetV2Train's batch on synthetic data: K2 turns down contractions
        # it takes at 32 and 256, so K1 and K5 meet shapes of their own here
        _, runs["mnv2pc_b16"], seen_pc16 = main_path(
            "mnv2pc b16", ("mnv2pc", 16, "matmul_only"), synthetic_cifar(32, seed=5),
            synthetic_cifar(16, seed=6), 1, recipe_start, [("cpu", "cuda")], model_fn=recipe_fn,
            record={**RECORD_K1, **RECORD_K4, **RECORD_K5})
    if (conv_ops.get_fgrad_margin(), dw_ops.get_dw_fgrad_margin()) != (2, 2):
        raise AssertionError("the recipe's margins were not restored")

    enter("9", "the demo CLI (tools/run_train_demo_torch.py) on the card")
    cli = load_tool("tools/run_train_demo_torch.py")
    lines, runs["cli_MobilenetV2Train"], seen_cli = cli_in_process(
        cli, ["MobilenetV2Train", "--epochs", "1"], {**RECORD_K1, **RECORD_K4, **RECORD_K5})
    for ln in lines:
        print(f"  [MobilenetV2Train, in this process] {ln}", flush=True)
    if (conv_ops.get_fgrad_margin(), dw_ops.get_dw_fgrad_margin()) != (2, 2):
        raise AssertionError("MobilenetV2Train did not restore the margins")
    for fam in ("K1", "K4", "K5"):  # each shape the CLI's run gave a kernel was held to plain above
        if set(seen_cli[fam]) != set(seen_pc16[fam]):
            raise AssertionError(f"MobilenetV2Train's {fam} shapes {sorted(seen_cli[fam])} != "
                                 f"those of the b16 run checked against the CPU "
                                 f"{sorted(seen_pc16[fam])}")
    print(f"  MobilenetV2Train: its {len(seen_cli['K1'])} K1, {len(seen_cli['K4'])} K4 and "
          f"{len(seen_cli['K5'])} K5 shapes "
          f"are those of mnv2pc b16, byte-identical to the CPU", flush=True)
    loss = float(re.search(r"epoch 0: loss (\S+)", "\n".join(lines)).group(1))
    if not np.isfinite(loss) or not lines[-1].startswith("final test accuracy: "):
        raise AssertionError(f"MobilenetV2Train printed {lines[-2:]}")
    # the steps of the CLI's run: its synthetic CIFAR sets at batch 16
    n_cli_train = len(load_or_synthesize_cifar(None, train=True, synth_n=512)[0])
    n_cli_test = len(load_or_synthesize_cifar(None, train=False, synth_n=256)[0])
    want = expected_launches(("mnv2pc", 16, "matmul_only"), n_cli_train // 16, n_cli_test // 16)
    if family_counts(runs["cli_MobilenetV2Train"]) != want:
        raise AssertionError(f"MobilenetV2Train launches {runs['cli_MobilenetV2Train']}, "
                             f"expected {want} by kernel family")
    print(f"  MobilenetV2Train launches {family_counts(runs['cli_MobilenetV2Train'])}", flush=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        cli_subprocesses({
            "MobilenetV2Train": ["MobilenetV2Train", "--epochs", "1"],
            "NITIDSPInt8Train": ["NITIDSPInt8Train", "--epochs", "1"],
            "MnistTrain": ["MnistTrain", "--epochs", "1"],
            "MnistTrainSnapshot 1": ["MnistTrainSnapshot", "--epochs", "1"],
        }, tmp)
        again = cli_subprocesses({"MnistTrainSnapshot 2": ["MnistTrainSnapshot", "--epochs", "2"]},
                                 tmp)
    if "resumed from mnist.snapshot.npz at epoch 1" not in again["MnistTrainSnapshot 2"]:
        raise AssertionError("the second MnistTrainSnapshot did not resume from the first's file")

    enter("10", "the dot probe (tools/probes/dot_probe_torch.py)")
    dot_probe = load_tool("tools/probes/dot_probe_torch.py")
    kernels.reset_launch_counts()
    probe_rows = dot_probe.probe(log=lambda ln: print(f"  {ln}", flush=True))
    torch.cuda.synchronize()
    probe_counts = kernels.launch_counts()
    kernels.reset_launch_counts()

    enter("11", "ResNet-18 (NITI, CIFAR) and ResNet-v2-50, and the float twins")
    rn_start = export_jax_params(resnet18_niti().reset_parameters(torch.Generator().manual_seed(0)))
    record_rn = {**RECORD_K1, **RECORD_K2}
    run_rn, runs["resnet18_b256"], seen_rn = main_path(
        "resnet18 b256", ("resnet18", 256, "matmul_only"), cifar_train, cifar_test, 1, rn_start,
        [("cuda", "torch")], model_fn=resnet18_niti, record=record_rn)
    _, seen_rn_steps = per_step_counts(("resnet18", 256, "matmul_only"), run_rn["model"], xc, yc,
                                       NITI_LOGIT_CHANNELS, record=record_rn)
    k1_rn_per_step = path_step_weights("K1", seen_rn, n_train, n_eval, seen_rn_steps)
    k2_rn_per_step = path_step_weights("K2", seen_rn, n_train, n_eval, seen_rn_steps,
                                       K2_RESNET18_CASES)
    del run_rn
    _, runs["resnet18_b8"], _ = main_path(
        "resnet18 b8", ("resnet18", 8, "matmul_only"), synthetic_cifar(16, seed=3),
        synthetic_cifar(8, seed=4), 1, rn_start, [("cpu", "cuda")], model_fn=resnet18_niti)
    run_rn_all, runs["resnet18_all_b256"], seen_rn_all = main_path(
        "resnet18 all b256", ("resnet18", 256, "all"), cifar_train, cifar_test, 1, rn_start,
        [("cuda", "torch")], model_fn=resnet18_niti, record={**RECORD_K1, **RECORD_K3})
    _, seen_rn_all_steps = per_step_counts(("resnet18", 256, "all"), run_rn_all["model"], xc, yc,
                                           NITI_LOGIT_CHANNELS, record={**RECORD_K1, **RECORD_K3})
    k3_rn_per_step = path_step_weights("K3", seen_rn_all, n_train, n_eval, seen_rn_all_steps)
    k1_rn_all_per_step = path_step_weights("K1", seen_rn_all, n_train, n_eval, seen_rn_all_steps)
    if not set(seen_rn_all["K3"]) <= K3_KEYS:
        raise AssertionError(f"K3 shapes {sorted(set(seen_rn_all['K3']) - K3_KEYS)} of ResNet-18 "
                             "are not K3_CASES shapes")
    if not set(k1_rn_all_per_step) <= set(k1_rn_per_step):
        raise AssertionError("K1 shapes of ResNet-18 under 'all' that 'matmul_only' lacks")
    print(f"  ResNet-18 b256 'all': its {len(seen_rn_all['K3'])} K3 shapes are K3_CASES shapes, "
          f"checked and timed in phase 3; K3 launches by shape, one train step: "
          f"{ {k[0][1:] + k[1][2:]: n for k, n in k3_rn_per_step.items()} }", flush=True)
    del run_rn_all
    rn_rates = {"matmul_only": [], "all": []}
    for mode in ("matmul_only", "all", "all", "matmul_only"):  # in turns
        rate, line = throughput(256, 8, rn_start, resnet18_niti, synthetic_cifar, mode)
        rn_rates[mode].append(rate)
        print(f"  throughput on {name} ({card}): ResNet-18 batch 256 '{mode}' {rate:.1f} "
              f"samples/s [{line}]", flush=True)
    print(f"  K1 at the {len(k1_rn_per_step)} shapes of a ResNet-18 batch-256 train step, "
          "against torch._int_mm (the yardstick)", flush=True)
    k1_rn_rows = k1_library_rows(k1_rn_per_step, rates, gen)
    k1_rn = k1_library_summary(k1_rn_rows)
    rows_by_key = {(r["m"], r["k"], r["n"], r["a_layout"], r["b_layout"]): r for r in k1_rn_rows}
    k1_rn["all_mode"] = {"launches": sum(k1_rn_all_per_step.values()),
                         **{key: sum(n * rows_by_key[k][key] for k, n in k1_rn_all_per_step.items())
                            for key in ("ms", "cold_ms", "bound_ms")}}
    print(f"  K1 over one ResNet-18 b256 train step ({k1_rn['launches']} launches): "
          f"{k1_rn['ms']:.4f} ms (cold {k1_rn['cold_ms']:.4f}), plain {k1_rn['plain_ms']:.4f} ms, "
          f"bound {k1_rn['bound_ms']:.4f} ms; A row-major ({k1_rn['a']['all_launches']}) "
          f"{k1_rn['a']['all_ms']:.4f} ms, A MN-major ({k1_rn['a_t']['all_launches']}) "
          f"{k1_rn['a_t']['all_ms']:.4f} ms; on the {k1_rn['library_launches']} launches _int_mm "
          f"takes: K1 {k1_rn['ms_where_library_takes']:.4f} ms, _int_mm {k1_rn['library_ms']:.4f} ms;"
          f" under 'all' ({k1_rn['all_mode']['launches']} launches) {k1_rn['all_mode']['ms']:.4f} ms",
          flush=True)
    print(f"  K2 at the {len(k2_rn_per_step)} shapes of a ResNet-18 batch-256 train step", flush=True)
    k2_rn_rows = k2_path_rows(k2_rn_per_step, rates, int_rate, gen)
    k2_rn = k2_path_summary(k2_rn_rows, rates)
    k3_rn = k3_step_sum(k3_rn_per_step, k3_rows)
    for ph in ("max", "requant"):
        print(f"  K2 {ph} over one ResNet-18 b256 train step ({k2_rn['launches']} launches): "
              f"{k2_rn[ph]['ms']:.4f} ms, bound {k2_rn[ph]['bound_ms']:.4f} ms; K3 {ph} "
              f"({k3_rn['launches']} launches, 'all'): {k3_rn[ph]['ms']:.4f} ms, plain "
              f"{k3_rn[ph]['plain_ms']:.4f}, bound {k3_rn[ph]['bound_ms']:.4f} ms", flush=True)
    print(f"  K3's shapes over one ResNet-18 b256 train step: cuDNN fp32 {k3_rn['cudnn_fp32_ms']:.4f}"
          f" ms, the non-fused route {k3_rn['nonfused_ms']:.4f} ms", flush=True)

    v2_start = export_jax_params(
        resnet50v2_niti(num_classes=1000).reset_parameters(torch.Generator().manual_seed(0)))
    v2_key = ("resnet50v2", 16, "matmul_only")
    run_v2, runs["resnet50v2_b16"] = class_path(
        "resnet50v2 b16 224x224", v2_key, functools.partial(class_steps, resnet50v2_niti, v2_start),
        v2_start, class_batches(16, 224, 50),
        [("cuda", "torch")], record=RECORD_K2)
    k2_v2_per_step, _ = class_step_weights(v2_key, "K2", run_v2)
    del run_v2
    print(f"  K2 at the {len(k2_v2_per_step)} shapes of a ResNet-v2-50 b16 train step", flush=True)
    k2_v2_rows = k2_path_rows(k2_v2_per_step, rates, int_rate, gen)
    k2_v2 = k2_path_summary(k2_v2_rows, rates)
    torch.cuda.empty_cache()

    fp32_checks = {
        "resnet18_fp32_b8": fp32_forward_close("ResNet18FP32 b8", ResNet18FP32,
                                               torch.from_numpy(synthetic_cifar(8, seed=9)[0]
                                                                .astype(np.float32) / 127.5 - 1),
                                               1e-5),
        "mnv2_fp32_b8": fp32_forward_close("MobileNetV2FP32 b8", MobileNetV2FP32,
                                           torch.from_numpy(synthetic_cifar(8, seed=9)[0]
                                                            .astype(np.float32) / 127.5 - 1),
                                           5e-5),
        "resnet18_fp32_b8_float64_3_steps": fp32_float64_steps("ResNet18FP32", ResNet18FP32, 3, 8),
        "mnv2_fp32_b8_float64_1_step": fp32_float64_steps("MobileNetV2FP32", MobileNetV2FP32, 1, 8),
    }
    print(f"  fp32 twins at b8, card against the CPU (forward eval / train / running stats; "
          f"float64 trainer steps), largest relative differences: {fp32_checks}", flush=True)
    fp32_rates = {}
    for tag, cls in (("resnet18_fp32_b256", ResNet18FP32), ("mnv2_fp32_b256", MobileNetV2FP32)):
        fp32_rates[tag], line = fp32_throughput(cls, 256, 2)
        print(f"  throughput on {name} ({card}): {tag} (TF32 off) {fp32_rates[tag]:.1f} samples/s "
              f"[{line}]", flush=True)
    gate, gate_code = run_test_train_gate({"model": "resnet18_niti", "batch": 64, "steps": 50})
    if gate["steps"] != 50 or not (np.isfinite(gate["first_loss"]) and
                                   np.isfinite(gate["last_loss"])):
        raise AssertionError(f"test_train_torch.py record {gate}")
    print(f"  tools/test_train_torch.py resnet18_niti b64 x 50 steps on the card: {gate} -> "
          f"TEST_TRAIN {'PASS' if gate['pass'] else 'FAIL'} (exit {gate_code}; reported, "
          "not a check)", flush=True)

    enter("12", "the zoo, SqueezeNet v1.0 (b128, 224x224) and Inception-v3 (b32, "
          "299x299), 1000 classes, through make_train_step / make_eval_step")
    record_zoo = {**RECORD_K1, **RECORD_K2, **RECORD_K3}
    zoo = {}
    for net, build_net, batch, side in (("squeezenet", squeezenet_niti, 128, 224),
                                        ("inceptionv3", inceptionv3_niti, 32, 299)):
        net_start = export_jax_params(build_net(num_classes=1000).reset_parameters(
            torch.Generator().manual_seed(0)))
        net_data = class_batches(batch, side, seed=batch)
        # SqueezeNet at 224 ends in a 13x13 map: the global pool's backward
        # divides every int8 gy by 169, truncating it to 0, so (as in the JAX
        # package) no weight moves; SqueezeNet10 at 32x32 (1x1) does learn
        moves = net != "squeezenet"
        net_steps = functools.partial(class_steps, build_net, net_start)
        per_step = {}
        for mode in ("matmul_only", "all"):
            key = (net, batch, mode)
            run, runs[f"{net}_b{batch}_{mode}"] = class_path(
                f"{net} b{batch} {mode}", key, net_steps, net_start, net_data, [("cuda", "torch")],
                record=record_zoo, moves=moves)
            per_step[mode] = {fam: class_step_weights(key, fam, run)
                              for fam in ("K1", "K2", "K3") if fam in EXPECTED_PER_STEP[key][0]}
            del run
        del net_data
        k3_train, k3_eval = per_step["all"]["K3"]
        if not set(k3_train) | set(k3_eval) <= K3_KEYS:
            raise AssertionError(f"{net}: K3 shapes {sorted((set(k3_train) | set(k3_eval)) - K3_KEYS)}"
                                 " are not K3_CASES shapes")
        # the card against the CPU at batch 2, full size, under "all" (K1 and K3)
        _, runs[f"{net}_b2_all"] = class_path(
            f"{net} b2 all", (net, 2, "all"), net_steps, net_start,
            class_batches(2, side, seed=2), [("cpu", "cuda")], moves=moves)
        rates_zoo = {"matmul_only": [], "all": []}
        for mode in ("matmul_only", "all", "all", "matmul_only"):  # in turns
            rate = step_rate(build_net, net_start, batch, side, mode, 6)
            rates_zoo[mode].append(rate)
            print(f"  throughput on {name} ({card}): {net} b{batch} '{mode}' {rate:.1f} samples/s "
                  "(make_train_step, 6 steps back to back)", flush=True)
        k1_keys = {**per_step["matmul_only"]["K1"][0], **per_step["all"]["K1"][0]}
        print(f"  K1 at the {len(k1_keys)} shapes of a {net} b{batch} train step (both modes)",
              flush=True)
        net_k1_rows = k1_step_rows(k1_keys, rates, gen)
        k1_lib = int_mm_rows(net_k1_rows, per_step["matmul_only"]["K1"][0], gen)
        print(f"  {net} b{batch} 'matmul_only', the {k1_lib['launches']} row-major K1 launches "
              f"(of {sum(per_step['matmul_only']['K1'][0].values())}) that torch._int_mm takes, "
              f"{k1_lib['shapes']} shapes: K1 {k1_lib['k1_ms']:.4f} ms, _int_mm "
              f"{k1_lib['library_ms']:.4f} ms ({k1_lib['copies']} shapes on contiguous copies, "
              f"{k1_lib['refused_launches']} row-major launches refused, {k1_lib['differs']} "
              "results different from K1's)", flush=True)
        net_k2_rows = k2_path_rows(per_step["matmul_only"]["K2"][0], rates, int_rate, gen)
        zoo[net] = dict(
            batch=batch, side=side, samples_per_s_in_turns=rates_zoo,
            k1={mode: step_sum(net_k1_rows, rates, per_step[mode]["K1"][0]) for mode in per_step},
            k1_int_mm=k1_lib,
            k1_by_shape=net_k1_rows, k2=k2_path_summary(net_k2_rows, rates), k2_by_shape=net_k2_rows,
            k3=k3_step_sum(k3_train, k3_rows))
        z = zoo[net]
        print(f"  {net} b{batch} over one train step: K1 'matmul_only' ({z['k1']['matmul_only']['launches']}"
              f" launches) {z['k1']['matmul_only']['ms']:.4f} ms (plain {z['k1']['matmul_only']['plain_ms']:.4f},"
              f" bound {z['k1']['matmul_only']['bound_ms']:.4f}); K1 'all' ({z['k1']['all']['launches']}) "
              f"{z['k1']['all']['ms']:.4f} ms; K2 ({z['k2']['launches']}) max {z['k2']['max']['ms']:.4f} + "
              f"requant {z['k2']['requant']['ms']:.4f} ms (bounds {z['k2']['max']['bound_ms']:.4f} + "
              f"{z['k2']['requant']['bound_ms']:.4f}); K3 'all' ({z['k3']['launches']}) max "
              f"{z['k3']['max']['ms']:.4f} + requant {z['k3']['requant']['ms']:.4f} ms (bounds "
              f"{z['k3']['max']['bound_ms']:.4f} + {z['k3']['requant']['bound_ms']:.4f}; cuDNN fp32 "
              f"{z['k3']['cudnn_fp32_ms']:.4f}, non-fused route {z['k3']['nonfused_ms']:.4f})", flush=True)
        torch.cuda.empty_cache()
    sq10 = functools.partial(squeezenet_niti, num_classes=10)
    sq10_start = export_jax_params(sq10().reset_parameters(torch.Generator().manual_seed(0)))
    _, runs["squeezenet10_b64"], _ = main_path(
        "squeezenet (10 classes) b64, train_niti on CIFAR", ("squeezenet10", 64, "matmul_only"),
        cifar_train, synthetic_cifar(64, seed=1), 1, sq10_start, [("cpu", "cuda")], model_fn=sq10)

    enter("13", "MobileNetV2 with int16 projection outputs (proj_bits=15) and K1's "
          "int16-A route")
    p15 = functools.partial(mobilenet_v2_niti, proj_bits=15)
    p15_start = export_jax_params(p15().reset_parameters(torch.Generator().manual_seed(0)))
    p15_key = ("mnv2p15", 256, "matmul_only")
    run_p15, runs["mnv2p15_b256"], seen_p15 = main_path(
        "mnv2p15 b256", p15_key, cifar_train, cifar_test, 1, p15_start, [("cuda", "torch")],
        model_fn=p15, record={**RECORD_K1I16})
    _, seen_p15_steps = per_step_counts(p15_key, run_p15["model"], xc, yc, NITI_LOGIT_CHANNELS,
                                        record={**RECORD_K1I16})
    i16_per_step = path_step_weights("K1i16", seen_p15, n_train, n_eval, seen_p15_steps)
    del run_p15
    _, runs["mnv2p15_b32"], _ = main_path(
        "mnv2p15 b32", ("mnv2p15", 32, "matmul_only"), synthetic_cifar(32, seed=3),
        synthetic_cifar(32, seed=4), 1, p15_start, [("cpu", "cuda")], model_fn=p15)
    print(f"  K1's int16-A route at the {len(i16_per_step)} shapes of an mnv2p15 b256 train step",
          flush=True)
    i16_rows = k1_step_rows(i16_per_step, rates, gen, int16=True)
    i16 = step_sum(i16_rows, rates)
    extremes = []
    for a_val, b_val, (m, k, n) in ((32767, 127, (300, 517, 70)), (-32768, -128, (70, 600, 33)),
                                    (-32768, 127, (4096, 1030, 96)),
                                    (32767, -128, (16, 262144, 96))):
        for a_t in (False, True):
            a = torch.full((k, m) if a_t else (m, k), a_val, dtype=torch.int16, device="cuda")
            a = a.t() if a_t else a
            b = torch.full((k, n), b_val, dtype=torch.int8, device="cuda")
            got = matmul_int8.matmul_acc_int16_cuda(a, b)
            want = (k * a_val * b_val + 2**31) % 2**32 - 2**31
            if not bool((got == want).all()) or not torch.equal(got, matmul_int8.matmul_acc_plain(a, b)):
                raise AssertionError(f"K1 int16-A at {a_val} x {b_val}, K {k}, A^T {a_t}: wrong")
            extremes.append(dict(a=a_val, b=b_val, m=m, k=k, n=n, a_mn_major=a_t, int32=want))
    print(f"  K1 int16-A at the extremes (+-32767, -32768 against 127, -128; sums past 2^31 and "
          f"2^32, split K), both layouts: equal to the int32 wrap and to plain: {extremes}",
          flush=True)
    print(f"  K1 int16-A over one mnv2p15 b256 train step ({i16['launches']} launches): "
          f"{i16['ms']:.4f} ms (the int8 route at the same shapes {i16['int8_route_ms']:.4f}), plain "
          f"{i16['plain_ms']:.4f} ms, bound {i16['bound_ms']:.4f} ms ({i16['bound_by']})", flush=True)

    enter("14", "QAT, distillation and transfer training (the int8 softmax and matmul "
          "ops, MnistInt8Train, DistillTrainQuant, MobilenetV2Transfer at full width)")
    for a in range(-9, 16):  # every ascale branch, at LeNet's logits (b64 x 12)
        logits = rand_int8((64, NITI_LOGIT_CHANNELS), gen)
        ascale = torch.tensor(a, dtype=torch.int32, device="cuda")
        on_card = softmax_ops.softmax_int8_forward(logits, ascale)
        on_cpu = softmax_ops.softmax_int8_forward(logits.cpu(), ascale.cpu())
        up = torch.randint(-2**31, 2**31 - 1, (64, NITI_LOGIT_CHANNELS), generator=gen,
                           dtype=torch.int32, device="cuda")
        if not torch.equal(on_card.cpu(), on_cpu) or not torch.equal(
                softmax_ops.softmax_grad_int8(up).cpu(), softmax_ops.softmax_grad_int8(up.cpu())):
            raise AssertionError(f"softmax at ascale {a}: the card and the CPU differ")
    matmul_checks = []
    for what, m, k, n in (("LeNet fc1 832->500 b64", 64, 832, 500),
                          ("LeNet fc2 500->12 b64", 64, 500, 12),
                          ("MNv2 head 1280->12 b256", 256, 1280, 12)):
        a, b = rand_int8((m, k), gen), rand_int8((k, n), gen)
        a_exp, b_exp = (torch.tensor(e, dtype=torch.int32, device="cuda") for e in (-7, -6))
        outs = {}
        for backend in ("cuda", "torch"):
            kernels.reset_launch_counts()
            with kernels.use_backend(backend):
                outs[backend] = (*matmul_ops.matmul_int8_forward(a, a_exp, b, b_exp),
                                 matmul_ops.matmul_int8_grad(a, b))
            torch.cuda.synchronize()
            if kernels.launch_counts()["matmul_int8"] != (2 if backend == "cuda" else 0):
                raise AssertionError(f"matmul ops at {what} under {backend}: launches "
                                     f"{kernels.launch_counts()}")
        kernels.reset_launch_counts()
        if not all(torch.equal(x, y) for x, y in zip(outs["cuda"], outs["torch"])):
            raise AssertionError(f"matmul ops at {what}: K1 and the plain version differ")
        matmul_checks.append(what)
    print(f"  softmax_int8_forward / softmax_grad_int8 at b64 x 12, ascale -9..15: card and CPU "
          f"byte-equal; matmul_int8_forward / matmul_int8_grad through K1 and the plain version "
          f"on the card byte-equal at {matmul_checks}", flush=True)

    qat_checks = {"mnist_int8_train_3_steps": qat_float64_card_vs_cpu(
                      "MnistInt8Train, LeNetQAT b64, 3 SGD steps at lr_inv(0.01, step)",
                      mnist_int8_steps),
                  "distill_1_teacher_3_student_steps": qat_float64_card_vs_cpu(
                      "DistillTrainQuant b64, 1 teacher and 3 student steps", distill_steps)}
    qat_model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0)).to("cuda")
    qx, qy = synthetic_mnist(64, seed=23)
    qat_args = (torch.from_numpy((qx.astype(np.float32) / 255.0 - 0.5) * 2.0).cuda(),
                torch.from_numpy(onehot_padded(qy, NUM_CLASSES, NUM_CLASSES)
                                 .astype(np.float32)).cuda(), 0.01)
    qat_rate = steps_per_s(make_qat_train_step(qat_model, torch.Generator(device="cuda")
                                               .manual_seed(1)), qat_args, 64, 30)
    print(f"  throughput on {name} ({card}): MnistInt8Train LeNetQAT b64 float32 (TF32 off) "
          f"{qat_rate:.1f} samples/s (30 steps back to back)", flush=True)

    record_tr = {**RECORD_K1, **RECORD_K2, **RECORD_K4}
    tr_start = mnv2_transfer_model()
    tr_head, tr_features = export_jax_params(tr_start.head), export_jax_params(tr_start.features)
    tr_key = ("mnv2_transfer", 256, "matmul_only")
    tr_data = class_batches(256, 32, seed=256, n=4, classes=NUM_CLASSES, logits=NITI_LOGIT_CHANNELS)
    tr_runs = {}
    for label, key, data, others, record in (
            ("mnv2_transfer b256", tr_key, tr_data, [("cuda", "torch")], record_tr),
            ("mnv2_transfer all b256", ("mnv2_transfer", 256, "all"), tr_data,
             [("cuda", "torch")], None),
            ("mnv2_transfer b32", ("mnv2_transfer", 32, "matmul_only"),
             class_batches(32, 32, seed=32, n=4, classes=NUM_CLASSES, logits=NITI_LOGIT_CHANNELS),
             [("cpu", "cuda")], None)):
        tr_runs[key], runs[label.replace(" ", "_")] = class_path(
            label, key, transfer_steps, tr_head, data, others, record=record)
        if not params_equal(tr_runs[key][5], tr_features):
            raise AssertionError(f"{label}: the frozen features changed")
    print("  the frozen features byte-unchanged in each transfer run", flush=True)
    tr_per_step = {fam: class_step_weights(tr_key, fam, tr_runs[tr_key]) for fam in ("K1", "K2", "K4")}
    del tr_runs, tr_data
    k4_tr_train = tr_per_step["K4"][0]
    if not set(k4_tr_train) <= {k4_key_row(r) for r in k4_rows}:
        raise AssertionError(f"transfer K4 shapes {sorted(k4_tr_train)} are not K4_CASES shapes")
    print(f"  K1 at the {len(tr_per_step['K1'][0])} shapes of a mnv2_transfer b256 train step",
          flush=True)
    tr_k1_rows = k1_step_rows(tr_per_step["K1"][0], rates, gen)
    tr_k2_rows = k2_path_rows(tr_per_step["K2"][0], rates, int_rate, gen)
    transfer = dict(k1=step_sum(tr_k1_rows, rates), k1_by_shape=tr_k1_rows,
                    k2=k2_path_summary(tr_k2_rows, rates), k2_by_shape=tr_k2_rows, k4={})
    for ph in ("max", "requant"):
        k4 = {key: sum(k4_tr_train.get(k4_key_row(r), 0) * r[ph][key] for r in k4_rows)
              for key in ("ms", "plain_ms", "macs", "bytes")}
        k4["bound_ms"], k4["bound_by"] = bound(k4["macs"], k4["bytes"], (mac_rate, rates[1]))
        transfer["k4"][ph] = dict(k4, launches=sum(k4_tr_train.values()))
    mn_model = load_jax_params(mobilenet_v2_niti(), mnv2_start).to("cuda")
    tr_model = mnv2_transfer_model().to("cuda")
    (x_rate,), (oh_rate,), _, _ = class_batches(256, 32, seed=77, n=2, classes=NUM_CLASSES,
                                                logits=NITI_LOGIT_CHANNELS)
    transfer["samples_per_s_in_turns"] = {"transfer": [], "mnv2_train_step": []}
    for which in ("transfer", "mnv2_train_step", "mnv2_train_step", "transfer"):
        step = make_transfer_train_step(tr_model) if which == "transfer" else \
            make_train_step(mn_model)
        rate = steps_per_s(step, (x_rate, oh_rate), 256, 10)
        transfer["samples_per_s_in_turns"][which].append(rate)
        print(f"  throughput on {name} ({card}): {which} b256 {rate:.1f} samples/s (10 steps "
              "back to back)", flush=True)
    del mn_model, tr_model
    t = transfer
    print(f"  mnv2_transfer b256 over one train step: K1 ({t['k1']['launches']} launches) "
          f"{t['k1']['ms']:.4f} ms (plain {t['k1']['plain_ms']:.4f}, bound {t['k1']['bound_ms']:.4f}); "
          f"K2 ({t['k2']['launches']}) max {t['k2']['max']['ms']:.4f} + requant "
          f"{t['k2']['requant']['ms']:.4f} ms (bounds {t['k2']['max']['bound_ms']:.4f} + "
          f"{t['k2']['requant']['bound_ms']:.4f}); K4 ({t['k4']['max']['launches']}) max "
          f"{t['k4']['max']['ms']:.4f} + requant {t['k4']['requant']['ms']:.4f} ms (bounds "
          f"{t['k4']['max']['bound_ms']:.4f} + {t['k4']['requant']['bound_ms']:.4f})", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        outs = cli_subprocesses({demo: [demo, "--epochs", "1"] for demo in (
            "MnistInt8Train", "DistillTrainQuant", "MobilenetV2Transfer", "QuanByMSE",
            "LinearRegression")}, tmp)
    demo_lines = {
        "LinearRegression": [r"fit: a=-?\d+\.\d{3} b=-?\d+\.\d{3} loss=\d+\.\d{6}"],
        "MnistInt8Train": [r"epoch 0: loss \d+\.\d{4} test_acc \d\.\d{4}"],
        "DistillTrainQuant": [r"teacher pre-trained \(1 epoch\)",
                              r"epoch 0: distill_loss \d+\.\d{4} student_test_acc \d\.\d{4}"],
        "MobilenetV2Transfer": [r"\(no pretrained snapshot — feature extractor is random init\)",
                                r"\(no image folder/txt — synthetic data\)",
                                r"epoch 0: loss \d+\.\d{4} train_acc \d\.\d{4}"],
        "QuanByMSE": [r"calibrating on MNIST/synthetic batches",
                      r"MSE scales: input=\d+\.\d{4}, logits=\d+\.\d{4}",
                      r"KL scales: input=\d+\.\d{4}, logits=\d+\.\d{4}",
                      r"weight PTQ \(maxabs\): mean \|recon err\| per conv layer: .*",
                      r"weight PTQ \(admm\): mean \|recon err\| per conv layer: .*"]}
    for demo, patterns in demo_lines.items():
        got = [ln for ln in outs[demo].splitlines() if not ln.startswith("(no MNIST")]
        if len(got) != len(patterns) or not all(re.fullmatch(p_, ln)
                                                for p_, ln in zip(patterns, got)):
            raise AssertionError(f"{demo} printed {got}")
    print("  the five demos exited 0 and printed the JAX CLI's lines", flush=True)

    enter("15", "imported models: full-width ResNet-18 and MobileNetV2 exported to TFLite, "
          "imported by tools/import_model_torch.py and trained through the kernels; the "
          "import demos and --check on the card and the CPU")
    imported = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for net, build_net, net_start in (("resnet18", resnet18_niti, rn_start),
                                          ("mnv2", mobilenet_v2_niti, mnv2_start)):
            imported[net], net_runs = imported_model(net, build_net, net_start, tmp, name, card)
            runs.update(net_runs)
        import_demos_and_checks(cli, tmp)

    enter("16", "parallelism: DP (int32 and int8 wire), TP and GPipe as gloo ranks on cuda:0")
    par_summary, par_launches = parallel_phase(card, start, recipe_start)
    runs.update(par_launches)

    enter("17", "the compiled step: jit_train_step / jit_eval_step (CUDA graphs of the whole "
          "step, replayed) against the eager steps")
    graph_lines, graph_launches = compiled_phase()
    runs.update(graph_launches)

    enter("18", "the rest of the JAX package: the fine-tuning steps compiled, the per-op "
          "profile and flop count, DP over the multi-host mesh, the native build")
    rest_summary, rest_launches = rest_phase(card, start)
    runs.update(rest_launches)

    enter("19", "the kernels line")
    names = list(kernels.launch_counts())
    launches = {n: sum(c[n] for c in runs.values()) for n in names}
    by_run = {n: {r: c[n] for r, c in runs.items()} for n in names}
    k1_ops = sum(r["ops"] for r in k1_rows)
    k1_bytes = sum(r["bytes"] for r in k1_rows)
    k1_bound, k1_by = bound(k1_ops, k1_bytes, rates)
    lib_all = all(r["library_ms"] is not None for r in k1_rows)
    kernels_line = {"kernels": [
        {"name": "matmul_int8", "route": "cuda",
         "source": "mandheling_tpu_torch/csrc/matmul_int8.cu",
         "replaces": "mandheling_tpu/ops/kernels/matmul_int8.py:65",
         "launches": launches["matmul_int8"], "launches_by_run": by_run["matmul_int8"],
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
         "ms": sum(r["ms"] for r in k1_rows), "plain_ms": sum(r["plain_ms"] for r in k1_rows),
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": sum(r["library_ms"] for r in k1_rows) if lib_all else None,
         "shapes": "the 11 contractions of one LeNet batch-64 train step; times are their sum",
         "mnv2_b256_train_step": dict(
             k1_mn, shapes="every K1 launch of one MobileNetV2 batch-256 train step, as "
             "recorded; times weighted by the launches; library_ms is torch._int_mm over "
             "the launches it takes, beside K1's ms_where_library_takes; cold_ms with operands "
             "rotated over more than the L2",
             by_shape=k1_mn_rows),
         "resnet18_b256_train_step": dict(
             k1_rn, shapes="every K1 launch of one ResNet-18 batch-256 train step under "
             "'matmul_only', as recorded (all_mode: the launches 'all' leaves to K1); times "
             "weighted by the launches", by_shape=k1_rn_rows),
         **{f"{name}_b{z['batch']}_train_step": dict(
             z["k1"], shapes=f"every K1 launch of one {name} batch-{z['batch']} train step in "
             "each fused mode, as recorded; times weighted by the launches",
             library=dict(z["k1_int_mm"], what="torch._int_mm against K1 over the row-major "
                          "launches of a 'matmul_only' train step that _int_mm takes"),
             by_shape=z["k1_by_shape"]) for name, z in zoo.items()},
         "mnv2_transfer_b256_train_step": dict(
             transfer["k1"], shapes="every K1 launch of one MobilenetV2Transfer batch-256 "
             "train step (full width), as recorded; times weighted by the launches",
             by_shape=transfer["k1_by_shape"])},
        {"name": "matmul_int16a", "route": "cuda",
         "source": "mandheling_tpu_torch/csrc/matmul_int8.cu",
         "replaces": "mandheling_tpu/ops/kernels/dispatch.py:99",
         "replaces_note": "no Pallas site: the JAX package computes int16 x int8 products in "
                          "XLA (dispatch.matmul_acc / conv_acc); K1's int16-A route",
         "launches": launches["matmul_int16a"], "launches_by_run": by_run["matmul_int16a"],
         "max_abs_err": max(r["max_abs_err"] for r in i16_rows),
         **{key: i16[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "int8_route_ms")},
         "library_ms": None,
         "library_note": "no PyTorch call computes an integer product with int16 operands on "
                         "CUDA (torch._int_mm takes int8 only)",
         "shapes": f"the {i16['launches']} launches of one mnv2p15 (MobileNetV2, proj_bits=15) "
                   "batch-256 train step, as recorded; times are their sum; int8_route_ms is "
                   "K1's int8 route at the same shapes and layouts",
         "by_shape": i16_rows, "extremes": extremes},
    ]}
    for r in k2_rows:
        replaces = {"fused_matmul_max": "mandheling_tpu/ops/kernels/fused_matmul_int8.py:162",
                    "fused_matmul_requant": "mandheling_tpu/ops/kernels/fused_matmul_int8.py:182"}
        phase = "max" if r["name"] == "fused_matmul_max" else "requant"
        kernels_line["kernels"].append({
            "name": r["name"], "route": "cuda",
            "source": "mandheling_tpu_torch/csrc/fused_matmul_int8.cu",
            "replaces": replaces[r["name"]],
            "launches": launches[r["name"]], "launches_by_run": by_run[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "shapes": f"{r['what']}: ({r['m']},{r['k']})x({r['k']},{r['n']})",
            "tiled_branch": r["tiled_branch"],
            "mnv2_b256_train_step": dict(
                k2_mn[phase], launches=k2_mn["launches"],
                shapes="every K2 launch of one MobileNetV2 batch-256 train step, as recorded "
                       "and held to K2_PATH_CASES; times weighted by the launches",
                by_shape=[dict(x[phase], key=x["key"], max_abs_err=x["max_abs_err"],
                               launches_per_train_step=x["launches_per_train_step"])
                          for x in k2_mn_rows]),
            **{f"{tag}_train_step": dict(
                summary[phase], launches=summary["launches"],
                shapes=f"every K2 launch of one {what} train step, as recorded; times weighted "
                       "by the launches",
                by_shape=[dict(x[phase], key=x["key"], max_abs_err=x["max_abs_err"],
                               launches_per_train_step=x["launches_per_train_step"])
                          for x in rows_])
               for tag, what, summary, rows_ in (
                   ("resnet18_b256", "ResNet-18 batch-256", k2_rn, k2_rn_rows),
                   ("resnet50v2_b16", "ResNet-v2-50 batch-16 224x224", k2_v2, k2_v2_rows))
               + tuple((f"{name}_b{z['batch']}", f"{name} batch-{z['batch']}", z["k2"],
                        z["k2_by_shape"]) for name, z in zoo.items())
               + (("mnv2_transfer_b256", "MobilenetV2Transfer batch-256", transfer["k2"],
                   transfer["k2_by_shape"]),)}})
    stem = k3_rows[0]
    stem["max_abs_err"] = k3_err
    kernels_line["kernels"] += fused_entries(
        "fused_conv", "mandheling_tpu_torch/csrc/fused_conv_int8.cu",
        {"max": "mandheling_tpu/ops/kernels/fused_conv_int8.py:250",
         "requant": "mandheling_tpu/ops/kernels/fused_conv_int8.py:287"},
        stem, launches, by_run,
        {ph: {"shapes": f"{stem['what']}: x {stem['x']} w {stem['w']}",
              "nonfused_ms": stem["nonfused_ms"], "cudnn_fp32_ms": stem["cudnn_fp32_ms"],
              "other_shapes": {r["what"]: dict(r[ph], nonfused_ms=r["nonfused_ms"],
                                               cudnn_fp32_ms=r["cudnn_fp32_ms"])
                               for r in k3_rows[1:]},
              "library_note": "no PyTorch call computes an int8 conv on CUDA; cudnn_fp32_ms "
                              "(a float conv, inexact past 2^24) and nonfused_ms (the "
                              "route fused mode 'all' replaces) are yardsticks",
              **{f"{tag}_train_step": dict(
                  k3s[ph], launches=k3s["launches"], cudnn_fp32_ms=k3s["cudnn_fp32_ms"],
                  nonfused_ms=k3s["nonfused_ms"], by_shape=k3s["by_shape"],
                  shapes=f"every K3 launch of one {what} train step under 'all', as "
                         "recorded, at the K3_CASES times; cudnn_fp32_ms and nonfused_ms sum "
                         "both yardsticks over the same launches")
                 for tag, what, k3s in (("resnet18_b256", "ResNet-18 batch-256", k3_rn),) + tuple(
                     (f"{name}_b{z['batch']}", f"{name} batch-{z['batch']}", z["k3"])
                     for name, z in zoo.items())}}
         for ph in ("max", "requant")})
    k4_step = {"max_abs_err": k4_err}
    k4_recipe = {}
    for r in k4_rows:
        key = (r["x"], r["kernel"], r["pads"], r["dilation"])
        r["launches_per_train_step"] = k4_per_step.get(key, 0)
        r["recipe_launches_per_train_step"] = k4_pc_per_step.get(key, 0)
    for ph in ("max", "requant"):
        for out, form, n in ((k4_step, "", "launches_per_train_step"),
                             (k4_recipe, "pc_", "recipe_launches_per_train_step")):
            out[ph] = {key: sum(r[n] * r[form + ph][key] for r in k4_rows)
                       for key in ("ms", "plain_ms", "macs", "bytes")}
            out[ph]["bound_ms"], out[ph]["bound_by"] = bound(
                out[ph]["macs"], out[ph]["bytes"], (mac_rate, rates[1]))
        floor_ms = sum(r["launches_per_train_step"] * r["floor_ms"][ph] for r in k4_rows)
        print(f"  K4 {ph} over one MobileNetV2 b256 train step ({sum(k4_per_step.values())} "
              f"launches): {k4_step[ph]['ms']:.4f} ms, plain {k4_step[ph]['plain_ms']:.4f}, bound "
              f"{k4_step[ph]['bound_ms']:.4f} ({k4_step[ph]['bound_by']}), CUDA-core floor "
              f"{floor_ms:.4f} (estimated from its instructions); the recipe's "
              f"({sum(k4_pc_per_step.values())} launches, per-channel): {k4_recipe[ph]['ms']:.4f} ms,"
              f" plain {k4_recipe[ph]['plain_ms']:.4f}", flush=True)
    kernels_line["kernels"] += fused_entries(
        "fused_dwconv", "mandheling_tpu_torch/csrc/fused_dwconv_int8.cu",
        {"max": "mandheling_tpu/ops/kernels/fused_dwconv_int8.py:150",
         "requant": "mandheling_tpu/ops/kernels/fused_dwconv_int8.py:183"},
        k4_step, launches, by_run,
        {ph: {"shapes": f"the {sum(k4_per_step.values())} launches of one MobileNetV2 "
                        "batch-256 train step, as recorded; times are their sum",
              "recipe_train_step": dict(k4_recipe[ph], launches=sum(k4_pc_per_step.values())),
              "mnv2_transfer_b256_train_step": transfer["k4"][ph],
              "by_shape": {r["what"]: dict(r[ph], pc=r["pc_" + ph], launches_per_train_step=r[
                  "launches_per_train_step"]) for r in k4_rows if r["launches_per_train_step"]},
              "library_note": "no PyTorch call computes an int8 depthwise conv on CUDA"}
         for ph in ("max", "requant")})
    k5_parts = {}
    for part, strides in (("all", {(1, 1), (2, 2)}), ("stride1", {(1, 1)}), ("stride2", {(2, 2)})):
        sub = [r for r in k5_rows if r["stride"] in strides]
        k5_parts[part] = {key: sum(k5_per_step.get(k5_row_key(r), 0) * r[key] for r in sub)
                          for key in ("ms", "plain_ms", "macs", "bytes")}
        k5_parts[part]["launches"] = sum(k5_per_step.get(k5_row_key(r), 0) for r in sub)
        k5_parts[part]["bound_ms"], k5_parts[part]["bound_by"] = bound(
            k5_parts[part]["macs"], k5_parts[part]["bytes"], (mac_rate, rates[1]))
        print(f"  K5 over one MobileNetV2 b256 train step, {part} ({k5_parts[part]['launches']} "
              f"launches): {k5_parts[part]['ms']:.4f} ms, plain {k5_parts[part]['plain_ms']:.4f}, "
              f"bound {k5_parts[part]['bound_ms']:.4f} ({k5_parts[part]['bound_by']})", flush=True)
    k5_step = k5_parts["all"]
    kernels_line["kernels"].append({
        "name": "fused_dwconv_fgrad", "route": "cuda",
        "source": "mandheling_tpu_torch/csrc/fused_dwconv_fgrad_int8.cu",
        "replaces": "mandheling_tpu/ops/kernels/fused_dwconv_int8.py:224",
        "launches": launches["fused_dwconv_fgrad"],
        "launches_by_run": by_run["fused_dwconv_fgrad"], "max_abs_err": k5_err,
        **{key: k5_step[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "library_note": "no PyTorch call computes an int32 depthwise filter grad on CUDA",
        "shapes": f"the {sum(k5_per_step.values())} launches of one MobileNetV2 batch-256 "
                  "train step, as recorded; times are their sum",
        "by_stride": {p: k5_parts[p] for p in ("stride1", "stride2")},
        "by_shape": {r["what"]: dict(r, launches_per_train_step=k5_per_step.get(
            k5_row_key(r), 0)) for r in k5_rows}})
    for phase, counter in (("absmax", "requant_int32_absmax"), ("requant", "requant_int32_requant")):
        net = k7_nets[K7_NETS[0][0]]
        kernels_line["kernels"].append({
            "name": counter, "route": "cuda", "source": "mandheling_tpu_torch/csrc/requant_int32.cu",
            "replaces": "mandheling_tpu/ops/numerics.py:40",
            "replaces_note": "no Pallas site: the JAX package requantizes an accumulator no fused "
                             "kernel takes in XLA (range_estimate, requant_forward_from_bw, "
                             "requant_grad_from_bw); K7's phase " + ("1" if phase == "absmax" else "2"),
            "launches": launches[counter], "launches_by_run": by_run[counter],
            "max_abs_err": k7_err, "ms": net[f"{phase}_ms"], "plain_ms": net["plain_ms"],
            "plain_note": "the whole plain chain of the sites (both phases)",
            "bound_ms": net[f"{phase}_bound_ms"], "bound_by": "bytes",
            **({"cuda_core_floor_ms": net["requant_floor_ms"]} if phase == "requant" else {}),
            "library_ms": None,
            "library_note": "no PyTorch call requantizes an int32 tensor NITI's way",
            "shapes": f"the {net['sites']} non-fused requant sites of one {K7_NETS[0][0]} train "
                      "step, rehearsed on the meta device; times are their sum",
            **{f"{what.replace(' ', '_')}_train_step": {
                key: val for key, val in t.items() if key != "by_shape"}
               for what, t in k7_nets.items()},
            "by_shape": {what: t["by_shape"] for what, t in k7_nets.items()}})
    k8_replaces = {"pool_concat_maxpool": "mandheling_tpu/ops/pool.py:25",
                   "pool_concat_maxpool_grad": "mandheling_tpu/ops/pool.py:53",
                   "pool_concat_avgpool": "mandheling_tpu/ops/depthwise.py:397",
                   "pool_concat_avgpool_grad": "mandheling_tpu/ops/depthwise.py:421",
                   "pool_concat_concat": "mandheling_tpu/ops/eltwise.py:50"}
    for counter, t in k8_step.items():
        kernels_line["kernels"].append({
            "name": counter, "route": "cuda",
            "source": "mandheling_tpu_torch/csrc/pool_concat_int8.cu",
            "replaces": k8_replaces[counter],
            "replaces_note": "no Pallas site: the JAX package pools and concatenates in XLA",
            "launches": launches[counter], "launches_by_run": by_run[counter],
            "max_abs_err": k8_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "library_note": "no PyTorch call pools or concatenates int8 NITI's way",
            "shapes": f"the {t['sites']} sites of one Inception-v3 batch-32 train step at 299, "
                      "rehearsed on the meta device; times are their sum",
            "by_shape": t["by_shape"]})
    for variant, source in (("int8", "fused_matmul_int8.cu"), ("bf16", "matmul_max_bf16.cu")):
        rows = [r for r in probe_rows if r["variant"] == variant]
        top = rows[-1]  # K = 256
        kernels_line["kernels"].append({
            "name": top["kernel"] if variant == "bf16" else "fused_matmul_max (dot probe, int8)",
            "route": "cuda", "source": f"mandheling_tpu_torch/csrc/{source}",
            "replaces": "tools/probes/dot_probe.py:62", "launches": probe_counts[top["kernel"]],
            "launches_by_run": {"dot_probe": probe_counts[top["kernel"]]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{key: top[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "library_note": "no single PyTorch call computes max|A.B| (torch._int_mm or a bf16 "
                            "matmul gives the product only; the bf16 one rounds it to bf16)",
            "shapes": f"({top['rows']},{top['k']})x({top['k']},{top['n']}), {variant} operands",
            "by_k": {r["k"]: r for r in rows}})
    for kern in kernels_line["kernels"]:
        if kern["launches"] <= 0:
            raise AssertionError(f"{kern['name']} was not launched on the main path")
    kernels_line["throughput_samples_per_s"] = {
        "lenet_b64": rate64, "lenet_b2048": rate2k, "mnv2_b256": rate_mn,
        "resnet18_b256_matmul_only_in_turns": rn_rates["matmul_only"],
        "resnet18_b256_all_in_turns": rn_rates["all"], **fp32_rates,
        **{f"{name}_b{z['batch']}_{mode}_in_turns": z["samples_per_s_in_turns"][mode]
           for name, z in zoo.items() for mode in ("matmul_only", "all")}}
    kernels_line["throughput_samples_per_s"].update(
        mnist_int8_train_lenet_qat_b64=qat_rate,
        **{f"{which}_b256_in_turns": v for which, v in transfer["samples_per_s_in_turns"].items()})
    kernels_line["qat_float64_card_vs_cpu"] = qat_checks
    kernels_line["fp32_twins_card_vs_cpu"] = fp32_checks
    kernels_line["test_train_torch_resnet18_b64"] = dict(gate, exit=gate_code)
    kernels_line["imported_tflite_b256"] = imported
    kernels_line["parallel_phase16"] = par_summary
    kernels_line["compiled_step_phase17"] = graph_lines
    kernels_line["rest_phase18"] = rest_summary

    print(f"done in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line())
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
