"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of hnd_ghnd_tpu_torch/csrc from the checkout and
holds each against its plain PyTorch version on the card.  Then the two
paths, at full width with random weights and BN statistics from a seed:

  * serving: seeded batches through the GHND b3ch Faster R-CNN student
    (batch 8 at 832x1344 and 1344x832, batch 1 at 832x1344), compared with
    the CPU on the batch-1 input;
  * the heads: the same batches through the GHND b3ch Mask R-CNN and
    Keypoint R-CNN students, with int8_roi_pool off and then on (the level
    quantizer and the int8 RoIAlign), their heads compared with the CPU's
    on the CPU's FPN maps and detections;
  * distillation: ``mimic_runner.distill`` of the student from the ResNet-50
    teacher, batch 4 on both buckets, with the fused stem switched on
    (HND_TPU_PALLAS_STEM=1), then its per-epoch eval on a batch-8 serving
    batch; the same steps again with the switch off (cuDNN's stem); one
    step compared with a float64 step on the CPU;
  * supervised training: ``coco_runner.train`` of the org Faster R-CNN of
    config/org/faster_rcnn-backbone_resnet50.yaml in bfloat16, batch 2 on
    both buckets with seeded synthetic targets, then its float32 eval on a
    batch-8 serving batch; one float32 step compared with a float64 step on
    the CPU; the same training for the org Mask R-CNN and Keypoint R-CNN
    (config/org/{mask,keypoint}_rcnn-backbone_resnet50.yaml) with seeded
    masks and keypoints, where a step's time goes, and one float32 step of
    each compared with a float64 step on the CPU;
  * the runners (the main path, through the entry points a user calls):
    a COCO fixture of JPEGs written to a temporary directory (16 train and
    8 val images at 480x640 and 640x480, which the loader sends to both
    buckets), the teacher and the student (sharing all but ``layer1``)
    written as checkpoints, the val/test annotations made from the
    teacher's own detections; ``mimic_runner.run`` with the GHND b3ch
    config's blocks, -distill -transform_bottleneck, 2 epochs at batch 4
    with the stem switch on, COCOeval of each epoch's val, the best
    checkpoint, the test evals at batch 1; the same with -test_only from
    that checkpoint; ``coco_runner.run -train`` of the org model for one
    epoch of bfloat16 steps on the fixture's own boxes, and of the org
    Mask R-CNN (on the boxes' polygons) and Keypoint R-CNN (on a
    person-keypoint file of the same boxes), scored by COCOeval's segm and
    keypoints; then ``coco_runner.run``'s test eval of a seeded Mask
    R-CNN and Keypoint R-CNN on val annotations made from their own masks
    and keypoints (near 1 for the host decode; the host postprocess on one
    thread and on the pool, in turns), the Keypoint R-CNN's again with the
    device keypoint decode, itself held on the card against the CPU and the
    host decode.  It needs PIL and cv2 (the loader's decode and resize,
    ``mask_box_crop``);
  * the ext filter (``ext_phase``): ``ext_runner.run -train`` of
    config/ext/keypoint_rcnn-backbone_ext_resnet50-b3ch.yaml on a
    two-class keypoint fixture with the stem switch on, its ROC-AUC each
    epoch and the threshold table, then ``coco_runner.run``'s test eval of
    the gated Keypoint R-CNN, the gate on served batches with the
    bottleneck round trip, the filter's probabilities against the CPU's,
    and its times;
  * the split deployment (``split_phase``), with the stem switch on: the
    serving student's edge head and server tail over the byte wire, at
    batch 1 on each image of a serving batch of each bucket and at batch 8,
    their detections equal to the full forward's with the 8-bit (and the
    16-bit) round trip, the wire's size, the gated Keypoint R-CNN's edge
    stopping a batch of one, ``cost_analyzer`` on the runner fixture (its
    split mAP equal to the round trip eval's) and ``visualizer`` on two of
    its JPEGs, and the head's and tail's times at batch 1 and 8;
  * the ahead-of-time export (``export_phase``, ROADMAP A13), with the
    stem switch on: split/export.py's artifacts of the serving student
    (the bucket set at batch 8, 832x1344 at batch 1) and of the gated
    Keypoint R-CNN with int8_roi_pool on (batch 1), loaded and run by a
    child process that builds no model (``serve_artifacts``): head and
    tail equal to the eager split bit for bit, each kernel launched inside
    the artifact, the exported and eager tails' times; the sharded tail as
    two shards on the one card, each equal to the eager tail on its
    packet; the export CLI once;
  * the int8 server tail (``int8_tail_phase``, ROADMAP A11): the serving
    student calibrated on four served images, head -> bytes -> int8 tail
    at batch 8 on both buckets and batch 1, its detections with the float
    tail's keys and shapes, finite; each stage output's cosine with the
    float folded walk above 0.95; the card's int8 walk and the CPU's on
    the same wire, the codes of all 44 sites identical; the Mask and
    Keypoint students' int8 tails at batch 1; ``cost_analyzer
    --split_model --int8_tail`` on the runner fixture with its mAP delta;
    the float and int8 tails' times at batch 1 and 8.  Each int8 tail runs
    its 46 convolutions through the fused entry (``int8_conv_requant``,
    45 on the wgmma main loop, dec0 on mma.sync) and none through the
    int32 one.  The kernel phase holds the int8 convolution
    (``int8_conv_kernels_phase``) against its plain version, bit for bit
    in int32, on every conv shape of the tail's trunk at batch 8 and three
    odd cases, and times the trunk's 46 launches beside ``torch._int_mm``
    on im2col'd codes; then the fused entry with the walk's epilogues on
    the same shapes and the odd cases in every mode, bit for bit, and the
    46 fused launches in the walk's order beside their bound;
  * multi-process (``multiprocess_phase``, ROADMAP A12), with the stem
    switch on: two ranks on the one card over gloo (NCCL refuses two ranks
    on one device), each ``mimic_runner.run -distill -transform_bottleneck``
    of the GHND b3ch config at batch 4 on its shard of 24 JPEGs of one
    shape, one epoch, its shard of the runner phase's val and test splits
    and the merged COCOeval; both ranks' global losses and merged stats
    equal, their student parameters equal, and within MP_MOVE_TOL of one
    process on the concatenated batch-8 stream from the same weights; the
    stem, quantize/dequantize and f32 RoIAlign kernels launched in each
    rank; then one rank through ``mimic_runner.main`` over NCCL
    (``--dist_url env://``, WORLD_SIZE=1).  Two ranks on one card measure
    the path, not scaling across cards.

The kernel phase holds ``nms_keep`` (csrc/nms.cu) against the NMS fixpoint
on the served batches' problems and on adversarial ones
(``nms_kernels_phase``).  Each path checks that every kernel it runs was
launched, and that no NMS ran the fixpoint's host loop on the card.  Any
failed check raises.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists each kernel's route, launches (on the runners where they run it,
every path's beside), error, times (as its caller sees it, ``ms``, and on
the card alone, ``device_ms``) and bound.  Without a GPU, or without the
package beside it, the script exits nonzero and prints no result.  It
imports nothing of JAX.
"""
from __future__ import annotations

import copy
import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# student_model, teacher_model and train of
# config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml, spelled out because
# yaml may be missing where this runs
STUDENT_MODEL = {
    "name": "faster_rcnn",
    "backbone": {
        "name": "custom_resnet50",
        "params": {
            "pretrained": True,
            "freeze_layers": False,
            "layer1": {"name": "Bottleneck4LargeResNet", "bottleneck_channel": 3},
        },
    },
    "bottleneck_transformer": {
        "order": ["quantizer", "dequantizer"],
        "components": {
            "quantizer": {"params": {"num_bits": 8}},
            "dequantizer": {"params": {"num_bits": 8}},
        },
    },
    "params": {"num_classes": 91, "pretrained": True},
    "distill_backbone_only": True,
    "frozen_modules": ["backbone.body.layer2", "backbone.body.layer3",
                       "backbone.body.layer4", "backbone.fpn", "rpn",
                       "roi_heads"],
    "experiment": "coco2017-faster_rcnn-backbone_custom_resnet50_from_"
                  "faster_rcnn-backbone_resnet50-b3ch",
    "ckpt": "./resource/ckpt/ghnd/coco2017-faster_rcnn-backbone_custom_"
            "resnet50_from_faster_rcnn-backbone_resnet50-b3ch.pt",
}
# student_model of config/ghnd/mask_rcnn-backbone_resnet50-b3ch.yaml and of
# config/ghnd/keypoint_rcnn-backbone_resnet50-b3ch.yaml: the same trunk,
# bottleneck and frozen modules as STUDENT_MODEL, another head
MASK_STUDENT_MODEL = dict(
    STUDENT_MODEL, name="mask_rcnn",
    experiment="coco2017-mask_rcnn-backbone_custom_resnet50_from_mask_rcnn-"
               "backbone_resnet50-b3ch",
    ckpt="./resource/ckpt/ghnd/coco2017-mask_rcnn-backbone_custom_resnet50_"
         "from_mask_rcnn-backbone_resnet50-b3ch.pt")
KEYPOINT_STUDENT_MODEL = dict(
    STUDENT_MODEL, name="keypoint_rcnn",
    params={"num_classes": 2, "pretrained": True, "num_keypoints": 17},
    experiment="coco2017-keypoint_rcnn-backbone_custom_resnet50_from_"
               "keypoint_rcnn-backbone_resnet50-b3ch",
    ckpt="./resource/ckpt/ghnd/coco2017-keypoint_rcnn-backbone_custom_"
         "resnet50_from_keypoint_rcnn-backbone_resnet50-b3ch.pt")
TEACHER_MODEL = {
    "name": "faster_rcnn",
    "backbone": {"name": "resnet50",
                 "params": {"pretrained": True, "freeze_layers": True}},
    "params": {"num_classes": 91, "pretrained": True},
    "experiment": "coco2017-faster_rcnn-backbone_resnet50",
    "ckpt": "./resource/ckpt/org/coco2017-faster_rcnn-backbone_resnet50.pt",
}
TRAIN = {
    "num_epochs": 20,
    "batch_size": 4,
    "log_freq": 1000,
    "optimizer": {"type": "Adam", "params": {"lr": 0.001}},
    "criterion": {
        "type": "general",
        "params": {"org_loss_factor": 0.0},
        "terms": {
            f"layer{i}": {
                "ts_modules": [f"backbone.body.layer{i}"] * 2,
                "criterion": {"type": "MSELoss",
                              "params": {"reduction": "sum"}},
                "factor": 1.0,
            } for i in (1, 2, 3, 4)
        },
    },
    "scheduler": {"type": "MultiStepLR",
                  "params": {"milestones": [5, 15], "gamma": 0.1}},
}
COMPUTE_DTYPE = "float32"      # tpu.compute_dtype of the same config
# model, train and tpu of config/org/faster_rcnn-backbone_resnet50.yaml: its
# model block is the GHND config's teacher_model
ORG_MODEL = TEACHER_MODEL
ORG_TRAIN = {
    "num_epochs": 26,
    "batch_size": 2,
    "log_freq": 1000,
    "optimizer": {"type": "SGD", "params": {"lr": 0.0075, "momentum": 0.9,
                                            "weight_decay": 0.0001}},
    "scheduler": {"type": "MultiStepLR",
                  "params": {"milestones": [16, 22], "gamma": 0.1}},
}
# the model blocks of config/org/mask_rcnn-backbone_resnet50.yaml and
# config/org/keypoint_rcnn-backbone_resnet50.yaml (their train and tpu
# blocks are ORG_TRAIN and ORG_TPU)
ORG_MASK_MODEL = dict(
    ORG_MODEL, name="mask_rcnn",
    experiment="coco2017-mask_rcnn-backbone_resnet50",
    ckpt="./resource/ckpt/org/coco2017-mask_rcnn-backbone_resnet50.pt")
ORG_KEYPOINT_MODEL = dict(
    ORG_MODEL, name="keypoint_rcnn",
    params={"num_classes": 2, "pretrained": True, "num_keypoints": 17},
    experiment="coco2017-keypoint_rcnn-backbone_resnet50",
    ckpt="./resource/ckpt/org/coco2017-keypoint_rcnn-backbone_resnet50.pt")
ORG_TPU = {"buckets": [[832, 1344], [1344, 832]], "compute_dtype": "bfloat16",
           "mesh_axis": "data", "eval_batch_size": 8, "pixel_dtype": "float32"}
# model and train of config/ext/keypoint_rcnn-backbone_ext_resnet50-b3ch.yaml
# (its tpu block is ORG_TPU): the GHND b3ch Keypoint R-CNN student with the
# ext filter in its bottleneck
EXT_MODEL = {
    "name": "keypoint_rcnn",
    "backbone": {
        "name": "custom_resnet50",
        "params": {
            "pretrained": True,
            "freeze_layers": True,
            "layer1": {"name": "Bottleneck4LargeResNet", "bottleneck_channel": 3},
        },
        "ext_config": {
            "backbone_frozen": True,
            "threshold": 0.01,
            "ckpt": "./resource/ckpt/ext/coco2017-keypoint_rcnn-backbone_ext_"
                    "custom_resnet50-b3ch.pt",
        },
    },
    "bottleneck_transformer": STUDENT_MODEL["bottleneck_transformer"],
    "params": {"num_classes": 2, "num_keypoints": 17, "pretrained": True},
    "experiment": "coco2017-keypoint_rcnn-backbone_custom_resnet50_from_"
                  "keypoint_rcnn-backbone_resnet50-b3ch",
    "ckpt": KEYPOINT_STUDENT_MODEL["ckpt"],
}
EXT_TRAIN = {
    "num_epochs": 30,
    "batch_size": 2,
    "log_freq": 10000,
    "optimizer": {"type": "SGD", "params": {"lr": 0.001, "momentum": 0.9,
                                            "weight_decay": 0.0001}},
    "scheduler": {"type": "MultiStepLR",
                  "params": {"milestones": [15, 25], "gamma": 0.1}},
}
# the training phase: batch 2 (train.batch_size), 3 steps on each bucket and
# the first batch again (warmup 6 of 7 steps); 1-8 GT boxes per image,
# padded to the JAX loader's MAX_GT
ORG_BATCH = 2
MAX_GT = 100
# RoI sampling of the train step: 512 per image, P2-P5 of 256 channels;
# the mask and keypoint losses pool the first 128 slots (positives first)
TRAIN_ROIS = 512
MAX_POSITIVES = 128
BUCKETS = ((832, 1344), (1344, 832))
EVAL_BATCH = 8                 # tpu.eval_batch_size
SEED = 0
# fp32 with TF32 off on both sides: only summation order differs (cuDNN vs
# the CPU's convolutions over up to 4608-term dot products through ~60
# layers), so each stage agrees to 1e-4 of its largest magnitude
STAGE_TOL = 1e-4
ROI_TOL = 1e-5                 # RoIAlign: identical arithmetic, order only
# the stem kernels sum in another order than cuDNN: 147-term sums for the
# forward, B x OH x OW-term sums (1.1 M at batch 4) for dW
STEM_FWD_TOL = 1e-5            # x max |plain output|
STEM_DW_TOL = 1e-4             # x max |plain dW|
REPS = 25                      # timed runs per kernel; the median is kept
# ~5 ms of the card's clock: longer than the host takes to enqueue any
# kernel's call with its wrapper's checks (time_ms's device reading)
SPIN_CYCLES = 10_000_000
# the card's peaks for the bound of a kernel (H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12        # float32 outside the tensor cores
PEAK_INT8_PER_S = 1979e12      # dense int8 on the tensor cores
# the distill phase: batch 4 (train.batch_size), pixel_dtype float32; the
# first batch comes back last, so the loss must have fallen on it
TRAIN_BATCH = 4
STEPS_PER_BUCKET = 3
# losses of the switched-off run against the switched-on one: the first
# step differs only in the stem's summation order; after it, Adam's first
# moves of +-lr on near-zero gradients may go either way
LOSS_TOL_FIRST = 1e-5
LOSS_TOL_LATER = 1e-3
# one distill step on the card (float32) against the CPU in float64, at
# batch 1 on a quarter of the 832x1344 bucket (the CPU's time).  The
# gradients reach the stem and encoder through six train-mode BNs whose
# backward cancels: float32 gradients on the CPU land up to 3.6e-4 of a
# leaf's largest element off float64 (tests/test_torch_port_distill.py),
# and cuDNN's float32 convolutions up to 2.3e-3 (this phase on an H100
# 80GB HBM3 at 700 W: an encoder BN bias)
CPU_SHAPE = (416, 672)
CPU_TERM_TOL = 1e-5
CPU_GRAD_TOL = 5e-3
CPU_STATS_TOL = 1e-5
# one supervised float32 step on the card against the CPU in float64, at
# batch 1 on the same quarter bucket, both sides on the CPU's RoI samples
# and the same RPN draws: the four terms, and the gradients of the RoI
# heads and the FPN (through the backward kernel).  On an H100 80GB HBM3
# at 700 W, over two draws of random weights, the terms agreed to 9.1e-7
# and the gradients to 1.65e-3 of a leaf's largest element in the RoI
# heads (fc7's bias: fc6/fc7 pre-activations within float32 noise of 0 flip
# their ReLU between the two sides) and to 1.6e-4 in the FPN
TRAIN_TERM_TOL = 1e-5
TRAIN_HEAD_GRAD_TOL = 5e-3     # x a leaf's largest gradient element
TRAIN_FPN_GRAD_TOL = 1e-3
# the same step of the org Keypoint R-CNN: its head's 8 convs of 512 hold
# pre-activations within float32 noise of 0 at every step, and their ReLUs
# flip between float32 and float64.  The CPU's own float32 step is up to
# 9.1e-3 (keypoint_head.6) and 1.7e-3 (an FPN layer block) off float64 at
# this shape, so the card is held to about three times that; the Mask
# R-CNN's float32 step stays within the Faster R-CNN's tolerances (CPU:
# 7.9e-4, fc6)
TRAIN_GRAD_TOLS = {"faster_rcnn": (TRAIN_HEAD_GRAD_TOL, TRAIN_FPN_GRAD_TOL),
                   "mask_rcnn": (TRAIN_HEAD_GRAD_TOL, TRAIN_FPN_GRAD_TOL),
                   "keypoint_rcnn": (3e-2, 5e-3)}
# a leaf whose float64 gradient is 0 to rounding (the keypoint logits' bias:
# the log-softmax does not see a shift) is held to its tolerance times
# GRAD_FLOOR of the largest gradient element of all compared leaves
GRAD_FLOOR = 1e-3
# the runner phase: a COCO fixture of JPEGs (quality 95, as
# tests/fixtures.py writes them) at 480x640 and 640x480, which the min side
# 800 resize sends to both buckets; 2 epochs of mimic_runner -distill over
# the train split at batch 4, eval batch 8, test batch 1
RUNNER_IMAGES = {"train": 16, "val": 8}
RUNNER_SHAPES = ((480, 640), (640, 480))
RUNNER_EPOCHS = 2
# the teacher's detections that become the val/test ground truth: every one
# it scores at GT_SCORE or more (a cap would leave detections of the same
# scores as false positives: the x300 logits tie many at 1.0).  The teacher
# then scores near 1 on them, the student (a random bottleneck) far below
GT_SCORE = 0.5
TEACHER_MAP_MIN = 0.9
# a Keypoint R-CNN's ground truth keeps its first KP_MAX_DETS detections an
# image by score: COCOeval's keypoints scores no more than 20 an image
KP_MAX_DETS = 20
# the device keypoint decode (grid KP_GRID, kp_decode_grid's default): on
# the card against the CPU, the same grid position for at least KP_SAME_MIN
# of the keypoints and scores within KP_SCORE_TOL of the largest; against
# the host decode, JAX's rule (tests/test_kp_decode.py) on more than
# KP_AGREE_MIN of them: within one heatmap cell and one device-grid cell a
# box axis.  It holds for boxes of at least the heatmap's 56 pixels a side:
# on a smaller box the host samples its surface more coarsely than the
# heatmap's own cells, and its argmax can miss a peak
KP_GRID = 224
KP_SAME_MIN = 0.999
KP_SCORE_TOL = 1e-5
KP_AGREE_MIN = 0.98
# the GHND b3ch config's tpu block
# the ext phase: ext_runner -train at batch 2 (train.batch_size) for
# EXT_EPOCHS on a fixture of RUNNER_IMAGES whose person-keypoint files keep
# the annotations of every second image only (two classes in each split);
# the filter's probabilities on the card against the CPU's (float32, TF32
# off, the trunk's convolutions before it: cuDNN against oneDNN)
EXT_EPOCHS = 2
EXT_PROB_TOL = 1e-5
EXT_YAML = "config/ext/keypoint_rcnn-backbone_ext_resnet50-b3ch.yaml"
GHND_TPU = {"buckets": [[832, 1344], [1344, 832]], "compute_dtype": "float32",
            "mesh_axis": "data", "eval_batch_size": 8, "pixel_dtype": "float32"}
# the split phase: the b3ch student's head and tail over the byte wire at
# batch 1 on each image of a serving batch of each bucket and at batch
# EVAL_BATCH on one; the wire's body is B x (H/4 + 4) x (W/4 + 4) x 3 bytes
SPLIT_TIMED_BATCHES = (1, EVAL_BATCH)
SPLIT_TIMED_REPS = 10          # the exported and eager tails' wall times
VIZ_IMAGES = 2
# the int8 tail (int8_tail_phase): served images it calibrates on; each
# stage output's cosine with the float folded walk must pass
# tests/test_int8.py's bound; the card's walk and the CPU's compared on a
# smaller bucket at full channel width
INT8_CALIB_IMAGES = 4
INT8_COS_MIN = 0.95
INT8_CPU_SHAPE = (256, 384)
# the multi-process phase: MP_WORLD ranks on the one card over gloo, each
# ``mimic_runner.run -distill`` at batch TRAIN_BATCH on its shard of
# MP_TRAIN_IMAGES JPEGs, one epoch; then one process on the concatenated
# batch-8 stream.  MP_PORTRAITS[r] of shard r's images are portrait, the
# last of its epoch order, the rest landscape: the shards fill other
# numbers of batches (4 and 5 with the padded remainders), and every rank
# stops at the loader's length, 3 landscape batches that concatenate.
# The ranks' final student parameters against the one process's: each
# leaf's move |p - p0| within MP_MOVE_TOL of the one process's move (L2
# norms), but the two BN biases whose gradient is zero (the next BN
# subtracts what they add), which Adam moves by float noise, each element
# less than 2 x lr a step.  Adam moves an element whose gradient is near 0
# by about lr whatever its sign, so the ratio follows the card's
# run-to-run float noise: on the card it was at most 1.308e-4 in three runs
# on one shape, and 3.541e-4 and above 8.4e-4 in two runs of this fixture;
# MP_MOVE_TOL is about 6 times the largest.  Adam's moves hardly depend on
# the gradient's scale, so the gradient is held too: each leaf's norm
# after the ranks' reduction, before the first update, within MP_GRAD_TOL
# of the one process's (the card: at most 2.053e-5; a DDP-style average
# would be half of it); the losses as the distill phase holds the card to
# the CPU
GHND_YAML = "config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml"
MP_WORLD = 2
MP_TRAIN_IMAGES = 28
MP_PORTRAITS = (2, 1)
MP_MOVE_TOL = 5e-3
MP_GRAD_TOL = 1e-4
MP_ZERO_GRAD = ("backbone.body.layer1.decoder.3.bias",
                "backbone.body.layer1.decoder.8.bias")
MP_TIMEOUT_S = 600.0


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, spin: bool = False) -> float:
    """Median of REPS CUDA-event timings of ``fn`` after a warm-up.  With
    ``spin`` each timing starts behind a spin of the card (SPIN_CYCLES)
    that outlasts the host's enqueueing of ``fn``, so it reads the card's
    time for ``fn``'s work; without it, the card may wait on the host's
    launching (a wrapper's checks and small torch ops can take longer on
    the host than a fast kernel on the card)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(fn) -> dict:
    """``fn``'s time both ways: ``ms`` as the caller sees it, ``device_ms``
    on the card alone (time_ms)."""
    return {"ms": time_ms(fn), "device_ms": time_ms(fn, spin=True)}


def box_mix(rng: np.random.RandomState, b: int, n: int, h: int, w: int):
    """Square, tall, wide, sub-pixel and partly off-image boxes, [b, n, 4]
    float32: the mix of tests/test_pallas_roi.py, whose sizes are for a
    256x512 image, with the long sides scaled to h x w."""
    sy, sx = h / 256.0, w / 512.0
    out = []
    for i in range(b * n):
        kind = i % 5
        if kind == 0:    # square-ish
            bw, bh = rng.uniform(20, 200) * sx, rng.uniform(20, 200) * sy
        elif kind == 1:  # tall
            bw, bh = rng.uniform(2, 10), rng.uniform(200, 250) * sy
        elif kind == 2:  # wide
            bw, bh = rng.uniform(200, 500) * sx, rng.uniform(2, 10)
        elif kind == 3:  # tiny / sub-pixel
            bw, bh = rng.uniform(0.1, 4), rng.uniform(0.1, 4)
        else:            # large, often partly off-image
            bw, bh = rng.uniform(50, 400) * sx, rng.uniform(50, 200) * sy
        x1 = rng.uniform(-20, w - bw / 2)
        y1 = rng.uniform(-20, h - bh / 2)
        out.append([x1, y1, x1 + bw, y1 + bh])
    return np.array(out, np.float32).reshape(b, n, 4)


def quant_input(seed: int, shape) -> np.ndarray:
    """Seeded float32 input for the quantizer: N(0, 9) around an offset."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 3 + rng.uniform(-2, 2)).astype(np.float32)


def live_norms_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Give every BatchNorm of ``model`` seeded random statistics and
    affines, in place, with the last BN of each residual branch (``bn3``)
    scaled 0.1-0.3 so activations stay bounded.

    The seeded init (like the JAX package's) leaves frozen BNs at identity
    and zeroes each ``bn3``, which multiplies every residual branch of
    layer2-4 by 0: a comparison on those weights cannot see the branches,
    nor how a BN uses its mean, variance and eps."""
    gen = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        if getattr(m, "running_var", None) is None:
            continue
        n = m.running_var.numel()
        lo, hi = (0.1, 0.3) if name.endswith(".bn3") else (0.5, 1.5)
        with torch.no_grad():
            for t, a, b in ((m.weight, lo, hi), (m.bias, -0.1, 0.1),
                            (m.running_mean, -0.1, 0.1),
                            (m.running_var, 0.5, 2.0)):
                t.copy_(torch.empty(n).uniform_(a, b, generator=gen))
    return model


def serving_model(device: torch.device):
    """The b3ch student at full width from seed SEED, with live BNs and the
    class logits spread x300: random weights give near-uniform class
    scores under the 0.05 threshold, and the spread makes the thresholds
    and the per-class NMS select real detections."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    model = live_norms_(get_model(STUDENT_MODEL, seed=SEED, device=device),
                        SEED)
    model.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    return model.requires_grad_(False)  # serving only: no autograd graph


def serving_batches(rng: np.random.RandomState):
    """uint8 batches padded into their bucket, like the loader's."""
    out = []
    for (bh, bw), b in ((BUCKETS[0], EVAL_BATCH), (BUCKETS[1], EVAL_BATCH),
                        (BUCKETS[0], 1)):
        images = np.zeros((b, bh, bw, 3), np.uint8)
        sizes = np.zeros((b, 2), np.int32)
        for i in range(b):
            h = bh if i % 2 == 0 else int(bh * rng.uniform(0.6, 1.0))
            w = bw if i % 3 == 0 else int(bw * rng.uniform(0.6, 1.0))
            images[i, :h, :w] = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            sizes[i] = (h, w)
        original = np.round(sizes * 0.75).astype(np.int32)
        out.append({"images": images, "image_sizes": sizes,
                    "original_sizes": original})
    return out


def rel_err(got, want) -> float:
    want = want.detach().float().cpu()
    got = got.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tapped_bytes(levels, boxes, valid, image_size, pool: int) -> int:
    """The bytes of P2-P5 that a RoIAlign of ``boxes`` reads at least: the
    cells a valid RoI taps with a nonzero weight, times C and the element
    size.  They are the nonzero entries of the plain version's gradient at
    one channel (its weights are >= 0, so they never cancel)."""
    from hnd_ghnd_tpu_torch.ops.roi_align import multiscale_roi_align_batch
    ones = [torch.zeros((f.shape[0], f.shape[1], f.shape[2], 1),
                        device=f.device, requires_grad=True) for f in levels]
    out = multiscale_roi_align_batch(ones, boxes, image_size, pool, 2, valid)
    grads = torch.autograd.grad(out.sum(), ones)
    cells = sum(int((g != 0).sum()) for g in grads)
    return cells * levels[0].shape[-1] * levels[0].element_size()


def roi_bound(levels, boxes, valid, image_size, pool: int, rest: int,
              n_ops: float) -> dict:
    """A RoIAlign forward's bound: the level cells this run's valid RoIs
    tap (``tapped_bytes``) plus ``rest`` bytes (boxes, validity, scales,
    output); ``whole_levels_bound_ms`` beside it counts all of P2-P5
    instead of the tapped cells."""
    out = bound(tapped_bytes(levels, boxes, valid, image_size, pool) + rest,
                n_ops)
    out["whole_levels_bound_ms"] = bound(nbytes(*levels) + rest,
                                         n_ops)["bound_ms"]
    return out


def bound(n_bytes: float, n_ops: float,
          peak_ops_per_s: float = PEAK_FP32_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate (float32
    unless another is given)."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / peak_ops_per_s * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def stem_inputs(gen: torch.Generator, shape, device: torch.device):
    """A normalised-image-like input and a stem conv with the trunk's init
    scale (kaiming-normal, fan out) and a live frozen-BN affine."""
    x = torch.randn(shape, generator=gen, device=device)
    w = torch.randn((64, 3, 7, 7), generator=gen, device=device) \
        * (2.0 / (64 * 49)) ** 0.5
    scale = torch.rand(64, generator=gen, device=device) + 0.5
    bias = torch.randn(64, generator=gen, device=device) * 0.1
    return x, w, scale, bias


def stem_kernels_phase(dev: torch.device, kernels: dict) -> None:
    """The three stem kernels against their plain versions at the distill
    step's shapes (batch 4 on both buckets), on a ragged shape (33 x 50
    outputs: a partial tile in each direction) and on one with W/2 odd
    whose tiles no persistent grid divides (65 x 673 outputs, 594 tiles),
    timed at both buckets."""
    import torch.nn.functional as F
    from hnd_ghnd_tpu_torch.ops import stem as ts
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(TRAIN_BATCH, 3) + BUCKETS[0], (TRAIN_BATCH, 3) + BUCKETS[1],
              (2, 3, 66, 100), (3, 3, 130, 1346)]
    for shape in shapes:
        x, w, scale, bias = stem_inputs(gen, shape, dev)
        want, conv = ts.stem_forward(x, w, scale, bias, with_conv=True)
        got = SK.stem_fwd(x, w, scale, bias)
        got_res, got_conv = SK.stem_fwd_res(x, w, scale, bias)
        g = torch.randn(conv.shape, generator=gen, device=dev)
        dw = SK.stem_dw(x, g)
        want_dw = ts.stem_weight_grad(x, g)
        torch.cuda.synchronize()
        errs = {
            "stem_fwd": (float((got - want).abs().max()),
                         float(want.abs().max()), STEM_FWD_TOL),
            "stem_fwd_res": (max(float((got_res - want).abs().max()),
                                 float((got_conv - conv).abs().max())),
                             float(conv.abs().max()), STEM_FWD_TOL),
            "stem_dw": (float((dw - want_dw).abs().max()),
                        float(want_dw.abs().max()), STEM_DW_TOL),
        }
        check(torch.equal(SK.stem_dw(x, g), dw), "stem_dw is not repeatable")
        for name, (err, scale_, tol) in errs.items():
            log(f"[stem] {name} {shape}: max abs err {err:.3e} (max |plain| "
                f"{scale_:.3e}, bound {tol} x max)")
            check(err <= tol * scale_, f"{name} {shape}: {err} > {tol} x "
                  f"{scale_}")
        if shape in shapes[:2]:
            times = {
                "stem_fwd": (timings(lambda: SK.stem_fwd(x, w, scale, bias)),
                             time_ms(lambda: ts.stem_forward(x, w, scale,
                                                             bias))),
                "stem_fwd_res": (
                    timings(lambda: SK.stem_fwd_res(x, w, scale, bias)),
                    time_ms(lambda: ts.stem_forward(x, w, scale, bias,
                                                    with_conv=True))),
                "stem_dw": (timings(lambda: SK.stem_dw(x, g)),
                            time_ms(lambda: ts.stem_weight_grad(x, g))),
            }
            # one PyTorch call each: the conv alone (no affine, no ReLU)
            # for the forwards, conv2d_weight for dW
            conv_ms = time_ms(lambda: F.conv2d(x, w, stride=2, padding=3))
            dw_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
                x, w.shape, g, stride=2, padding=3))
            for name, (k, p_ms) in times.items():
                lib = dw_ms if name == "stem_dw" else conv_ms
                log(f"[stem] {name} {shape}: {k['ms']:.4f} ms kernel "
                    f"({k['device_ms']:.4f} on the card), {p_ms:.4f} ms plain, "
                    f"{lib:.4f} ms library (median of {REPS})")
        if shape == shapes[0]:
            macs = 2.0 * 147 * conv.numel()
            bounds = {
                "stem_fwd": bound(nbytes(x, w, scale, bias, want),
                                  macs + 3.0 * want.numel()),
                "stem_fwd_res": bound(nbytes(x, w, scale, bias, want, conv),
                                      macs + 3.0 * want.numel()),
                "stem_dw": bound(nbytes(x, g, dw), macs),
            }
            for name, line in (("stem_fwd", 126), ("stem_fwd_res", 132),
                               ("stem_dw", 141)):
                kernels[name] = dict(
                    source="hnd_ghnd_tpu_torch/csrc/stem.cu",
                    replaces=f"hnd_ghnd_tpu/ops/pallas_stem.py:{line}",
                    max_abs_err=errs[name][0], **times[name][0],
                    plain_ms=times[name][1],
                    library_ms=dw_ms if name == "stem_dw" else conv_ms,
                    **bounds[name])


def nms_problem(rng: np.random.RandomState, b: int, n: int, n_cats: int,
                nonfinite: bool, dtype=torch.float32):
    """An adversarial NMS problem: tied scores (a few values, -0.0 and 0.0
    among them), duplicate boxes, zero-area boxes, invalid rows, and with
    ``nonfinite`` NaN and +-inf in coordinates and scores; categories in
    [0, n_cats) or None.  -> (boxes, scores, valid, categories) on the
    CPU."""
    xy = rng.uniform(-10, 200, (b, n, 2))
    wh = rng.uniform(0, 80, (b, n, 2))
    wh[rng.rand(b, n) < 0.1, rng.randint(0, 2)] = 0.0        # zero area
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    dup = rng.rand(b, n) < 0.2
    boxes[dup] = boxes[:, :1].repeat(n, 1)[dup]               # duplicates
    tied = rng.choice(np.float32([0.9, 0.5, 0.5, 0.25, 0.0, -0.0]), (b, n))
    scores = np.where(rng.rand(b, n) < 0.5, tied,
                      rng.rand(b, n)).astype(np.float32)
    if nonfinite:
        for arr, p in ((boxes, 0.03), (scores, 0.05)):
            for v in (np.nan, np.inf, -np.inf):
                arr[rng.rand(*arr.shape) < p] = v
    valid = rng.rand(b, n) < 0.8
    cats = None if n_cats == 0 else torch.from_numpy(
        rng.randint(0, n_cats, (b, n)))
    return (torch.from_numpy(boxes).to(dtype),
            torch.from_numpy(scores.astype(np.float32)).to(dtype),
            torch.from_numpy(valid), cats)


def nms_bound(boxes, scores, valid, categories, keep) -> dict:
    """The NMS kernel's bound: each input read once and the keep mask
    written once; the IoU and its test (13 float operations) of each pair
    of valid boxes of one category, and one compare of each other pair of
    valid boxes (its categories differ), the pairs this run's data needs.
    Integer compares are counted at the float32 rate (the guide's table
    has no integer rate outside the tensor cores)."""
    def pairs(n: torch.Tensor) -> float:
        n = n.double()
        return float((n * (n - 1) / 2).sum())

    every = pairs(valid.sum(dim=1))
    if categories is None:
        return bound(nbytes(boxes, scores, valid, keep), 13.0 * every)
    same = sum(pairs(torch.unique(categories[b][valid[b]],
                                  return_counts=True)[1])
               for b in range(valid.shape[0]))
    return bound(nbytes(boxes, scores, valid, keep, categories),
                 13.0 * same + (every - same))


def nms_kernels_phase(dev: torch.device, kernels: dict, model,
                      batches: list) -> None:
    """``nms_keep`` (csrc/nms.cu) against its plain version, the fixpoint,
    on the card and on the CPU, keep masks equal: on the problems of the
    served batches' forwards (the RPN's five levels, the box head's
    category-aware problem; batch 8 at both buckets and 1) and on
    adversarial problems; its time at the batch-8 box head's shape beside
    the plain version's, the RPN's levels too."""
    from hnd_ghnd_tpu_torch.ops import nms as NMS
    from hnd_ghnd_tpu_torch.runners.common import eval_forward
    seen = []
    op = NMS.nms_keep_op

    def record(boxes, scores, valid, categories, iou_threshold):
        seen.append((boxes.clone(), scores.clone(), valid.clone(),
                     None if categories is None else categories.clone(),
                     iou_threshold))
        return op(boxes, scores, valid, categories, iou_threshold)

    NMS.nms_keep_op = record
    try:
        for batch in batches:
            eval_forward(model, {k: torch.from_numpy(v).to(dev)
                                 for k, v in batch.items()}, True)
    finally:
        NMS.nms_keep_op = op
    rng = np.random.RandomState(SEED + 16)
    cases = [(f"served {tuple(p[0].shape[:2])} iou {p[4]}"
              + ("" if p[3] is None else " categories"), p) for p in seen]
    for n in (1, 63, 64, 65, 1000, 4096):
        for n_cats, nonfinite, dtype, thr in (
                (0, False, torch.float32, 0.7), (3, False, torch.float32, 0.5),
                (90, True, torch.float32, 0.5), (0, True, torch.float32, 0.7),
                (3, True, torch.bfloat16, 0.3007)):
            bx, sc, va, ca = nms_problem(rng, 2, n, n_cats, nonfinite, dtype)
            cases.append((f"adversarial N={n} cats={n_cats} "
                          f"nonfinite={nonfinite} {dtype} iou {thr}",
                          (bx.to(dev), sc.to(dev), va.to(dev),
                           None if ca is None else ca.to(dev), thr)))
    for name, (bx, sc, va, ca, thr) in cases:
        before = NMS.nms_keep.launches
        got = NMS.nms_keep(bx, sc, thr, va, ca)
        check(NMS.nms_keep.launches == before + 1, f"nms_keep launch ({name})")
        want = NMS.nms_plain(bx, sc, va, ca, thr)
        cpu = NMS.nms_plain(bx.cpu(), sc.cpu(), va.cpu(),
                            None if ca is None else ca.cpu(), thr)
        check(torch.equal(got, want), f"nms_keep vs plain on the card ({name})")
        check(torch.equal(got.cpu(), cpu), f"nms_keep vs plain on the CPU "
              f"({name})")
    log(f"[kernels] nms_keep: keep masks equal to the plain fixpoint's (card "
        f"and CPU) on {len(seen)} served problems and {len(cases) - len(seen)}"
        f" adversarial ones")
    # the first forward's: batch 8 at 832x1344
    bx, sc, va, ca, thr = seen[5]
    keep = NMS.nms_keep(bx, sc, thr, va, ca)
    rpn = seen[:5]
    check(ca is not None and all(p[3] is None for p in rpn),
          "the first forward's NMS problems: five RPN levels, the box head")
    kernels["nms_keep"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/nms.cu",
        replaces="hnd_ghnd_tpu/ops/nms.py:94", max_abs_err=0.0,
        shape=f"box head {list(bx.shape[:2])} with categories, "
              f"{int(va.sum())} valid",
        **timings(lambda: NMS.nms_keep(bx, sc, thr, va, ca)),
        plain_ms=time_ms(lambda: NMS.nms_plain(bx, sc, va, ca, thr)),
        library_ms=None, **nms_bound(bx, sc, va, ca, keep),
        rpn_shapes=[list(p[0].shape[:2]) for p in rpn],
        rpn_ms=time_ms(lambda: [NMS.nms_keep(p[0], p[1], p[4], p[2])
                                for p in rpn]),
        rpn_device_ms=time_ms(lambda: [NMS.nms_keep(p[0], p[1], p[4], p[2])
                                       for p in rpn], spin=True),
        rpn_plain_ms=time_ms(lambda: [NMS.nms_plain(p[0], p[1], p[2], None,
                                                    p[4]) for p in rpn]))
    k = kernels["nms_keep"]
    log(f"[kernels] nms_keep {k['shape']}: {k['ms']:.4f} ms "
        f"({k['device_ms']:.4f} on the card), plain {k['plain_ms']:.4f} ms, "
        f"bound {k['bound_ms']:.5f} ms by {k['bound_by']}; the RPN's "
        f"{len(rpn)} levels {k['rpn_shapes']}: {k['rpn_ms']:.4f} ms "
        f"({k['rpn_device_ms']:.4f} on the card), plain "
        f"{k['rpn_plain_ms']:.4f} ms")
    NMS.fixpoint.iterations = 0


def distill_models(device: torch.device):
    """The seeded ResNet-50 teacher with live BNs, and the b3ch student with
    its stem and layer2-4 copied from the teacher (the reference's
    pretrained + frozen_modules setup), its class logits spread as in
    ``serving_model`` for the per-epoch eval."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    teacher = live_norms_(get_model(TEACHER_MODEL, seed=SEED, device=device),
                          SEED)
    student = live_norms_(get_model(STUDENT_MODEL, seed=SEED + 1,
                                    device=device), SEED + 1)
    shared = ("backbone.body.conv1.", "backbone.body.bn1.",
              "backbone.body.layer2.", "backbone.body.layer3.",
              "backbone.body.layer4.")
    student.load_state_dict({k: v for k, v in teacher.state_dict().items()
                             if k.startswith(shared)}, strict=False)
    with torch.no_grad():
        student.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    return teacher, student


def distill_batches(rng: np.random.RandomState, device: torch.device):
    """float32 batches in [0, 1] padded into their bucket like the loader's,
    STEPS_PER_BUCKET on each bucket, then the first batch again."""
    out = []
    for bh, bw in BUCKETS:
        for _ in range(STEPS_PER_BUCKET):
            images = np.zeros((TRAIN_BATCH, bh, bw, 3), np.float32)
            for i in range(TRAIN_BATCH):
                h = bh if i % 2 == 0 else int(bh * rng.uniform(0.6, 1.0))
                w = bw if i % 3 == 0 else int(bw * rng.uniform(0.6, 1.0))
                images[i, :h, :w] = rng.rand(h, w, 3)
            out.append({"images": torch.from_numpy(images).to(device)})
    return out + [out[0]]


def distill_phase(dev: torch.device, eval_batch: dict):
    """mimic_runner.distill with the stem switch on, then the same steps
    from the same start with it off.  Returns (teacher, student at its
    start, the stem kernels' launches in the switched-on run)."""
    from hnd_ghnd_tpu_torch.runners.mimic_runner import distill
    from hnd_ghnd_tpu_torch.utils.params import updatable_param_names
    teacher, student = distill_models(dev)
    start = copy.deepcopy(student.state_dict())
    trainable = set(updatable_param_names(student))
    frozen = [n for n, _ in student.named_parameters() if n not in trainable]
    batches = distill_batches(np.random.RandomState(SEED + 2), dev)
    n = len(batches)
    config = {"train": dict(TRAIN, num_epochs=1),
              "student_model": STUDENT_MODEL,
              "tpu": {"compute_dtype": COMPUTE_DTYPE}}
    counted = ("stem_fwd", "stem_fwd_res", "stem_dw", "quantize",
               "dequantize", "roi_align")
    runs = {}
    for switch in ("1", "0"):
        os.environ["HND_TPU_PALLAS_STEM"] = switch
        student.load_state_dict(start)
        zero_kernel_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        # the -transform_bottleneck run: the eval round-trips the
        # bottleneck through the quantizer kernels
        hist = distill(teacher, student, config, batches,
                       [eval_batch] if switch == "1" else [], n,
                       use_bottleneck_transformer=True)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernel_counts().items() if k in counted}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        tag = "on" if switch == "1" else "off"
        n_eval = sum(len(e) for e in hist["evals"])
        log(f"[distill] switch {tag}: {n} steps + {n_eval} eval batch(es) "
            f"in {wall:.3f} s; launches {launches}; peak memory "
            f"{peak:.2f} GiB")
        for idx, loss, terms, ms in hist["steps"]:
            shape = tuple(batches[idx]["images"].shape)
            log(f"[distill] switch {tag} step {idx} {shape}: {ms:.3f} ms, "
                f"loss {loss:.6e}, terms "
                + " ".join(f"{k} {v:.6e}" for k, v in terms.items()))
        runs[tag] = (hist, launches)
        if switch == "1":
            after = student.state_dict()
            for name in frozen:
                check(torch.equal(after[name], start[name]),
                      f"frozen {name} changed")
            for name in trainable:
                check(not torch.equal(after[name], start[name]),
                      f"trainable {name} did not move")
            stats = [k for k in start if k.startswith("backbone.body.layer1.")
                     and k.endswith(("running_mean", "running_var"))]
            check(len(stats) == 16 and all(
                not torch.equal(after[k], start[k]) for k in stats),
                "a bottleneck BN's running statistics did not change")
            log(f"[distill] {len(frozen)} frozen parameters bit-identical, "
                f"{len(trainable)} trainable ones moved (backbone.body.bn1."
                "weight among them), 16 bottleneck BN statistics changed")
            check(launches["stem_fwd_res"] == n and launches["stem_dw"] == n,
                  "a student stem kernel did not launch once per step")
            check(launches["stem_fwd"] == n + 1,
                  "the teacher's stem kernel did not launch once per step "
                  "and once in the eval")
            for k in ("quantize", "dequantize", "roi_align"):
                check(launches[k] == 1, f"{k} did not launch in the eval")
            (rec,) = hist["evals"][0]
            dets = rec["dets"]
            check(dets["boxes"].shape == (EVAL_BATCH, 100, 4)
                  and bool(np.isfinite(dets["boxes"]).all())
                  and bool(np.isfinite(dets["scores"]).all()), "eval output")
            log(f"[distill] eval of batch {tuple(eval_batch['images'].shape)}:"
                f" {rec['ms']:.2f} ms, {int(dets['valid'].sum())} detections")
        else:
            check(all(launches[k] == 0 for k in
                      ("stem_fwd", "stem_fwd_res", "stem_dw")),
                  "a stem kernel launched with the switch off")
    losses = {tag: [loss for _, loss, _, _ in runs[tag][0]["steps"]]
              for tag in runs}
    on, off = losses["on"], losses["off"]
    check(all(np.isfinite(on)) and all(np.isfinite(off)), "non-finite loss")
    check(on[-1] < on[0], f"loss did not fall on the repeated batch: {on}")
    for i, (a, b) in enumerate(zip(on, off)):
        rel = abs(a - b) / abs(a)
        tol = LOSS_TOL_FIRST if i == 0 else LOSS_TOL_LATER
        check(rel <= tol, f"step {i}: switch on/off losses {a} {b} ({rel})")
    log(f"[distill] losses switch on vs off within {LOSS_TOL_FIRST} (step 0) "
        f"and {LOSS_TOL_LATER}: max rel "
        f"{max(abs(a - b) / abs(a) for a, b in zip(on, off)):.2e}")
    # step times per bucket, leaving out each bucket's first step (cuDNN's
    # first calls at a new shape)
    for tag in runs:
        steps = runs[tag][0]["steps"]
        for bi, bucket in enumerate(BUCKETS):
            first = bi * STEPS_PER_BUCKET
            ms = [s[3] for s in steps
                  if tuple(batches[s[0]]["images"].shape[1:3]) == bucket
                  and s[0] != first]
            log(f"[distill] switch {tag} bucket {bucket}: median step "
                f"{statistics.median(ms):.3f} ms over {len(ms)} steps "
                f"({TRAIN_BATCH / statistics.median(ms) * 1e3:.2f} img/s)")
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    student.load_state_dict(start)
    return teacher, student, runs["on"][1]


def distill_cpu_phase(dev: torch.device, teacher, student) -> None:
    """One distill step (stem switch on) on the card in float32 against the
    same step on the CPU in float64: terms, every trainable gradient, the
    new bottleneck BN statistics."""
    from hnd_ghnd_tpu_torch.distill.box import DistillationBox
    from hnd_ghnd_tpu_torch.models.factory import build_model
    images = torch.from_numpy(np.random.RandomState(SEED + 3).rand(
        1, *CPU_SHAPE, 3).astype(np.float32))
    # the CPU's copies first: the card's step moves the running statistics
    cpu = []
    for model, cfg in ((teacher, TEACHER_MODEL), (student, STUDENT_MODEL)):
        m = build_model(cfg)
        m.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu.append(m.double())
    out = {}
    for where in ("gpu", "cpu"):
        if where == "gpu":
            t, s, x = teacher, student, images.to(dev)
        else:
            (t, s), x = cpu, images.double()
        t.eval()
        s.train()
        s.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        _, terms = DistillationBox(t, s, TRAIN["criterion"]).loss(x)
        sum(terms.values()).backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in s.named_parameters() if p.requires_grad}
        stats = {k: v.double().cpu() for k, v in s.state_dict().items()
                 if k.startswith("backbone.body.layer1.")
                 and k.endswith(("running_mean", "running_var"))}
        out[where] = ({k: float(v.detach()) for k, v in terms.items()},
                      grads, stats)
        log(f"[distill-cpu] {where}: one step at {tuple(x.shape)} in "
            f"{time.perf_counter() - t0:.2f} s")
    (t_g, g_g, s_g), (t_c, g_c, s_c) = out["gpu"], out["cpu"]
    worst = 0.0
    for k in t_c:
        rel = abs(t_g[k] - t_c[k]) / abs(t_c[k])
        worst = max(worst, rel)
        check(rel <= CPU_TERM_TOL, f"term {k}: card {t_g[k]} cpu {t_c[k]}")
    log(f"[distill-cpu] terms within {CPU_TERM_TOL}: max rel {worst:.2e}")
    rels = {}
    for name, c in g_c.items():
        # a BN bias followed by an unpadded conv and a train-mode BN has a
        # zero gradient (the next BN removes it): both give float noise
        # there, held against the BN weight's gradient
        ref = g_c[name[:-len("bias")] + "weight"] if name in (
            "backbone.body.layer1.decoder.3.bias",
            "backbone.body.layer1.decoder.8.bias") else c
        scale = float(ref.abs().max())
        if ref is not c:
            check(float(g_g[name].abs().max()) <= CPU_TERM_TOL * scale,
                  f"{name}: not ~0")
            continue
        rels[name] = float((g_g[name] - c).abs().max()) / scale
    top = sorted(rels.items(), key=lambda kv: -kv[1])[:4]
    log(f"[distill-cpu] {len(g_c)} gradients, largest errors (x their max): "
        + ", ".join(f"{n} {r:.2e}" for n, r in top))
    check(top[0][1] <= CPU_GRAD_TOL, f"gradient {top[0][0]}: {top[0][1]} of "
          f"its max > {CPU_GRAD_TOL}")
    worst = max(float((s_g[k] - v).abs().max() / v.abs().max())
                for k, v in s_c.items())
    check(worst <= CPU_STATS_TOL, f"running statistics: {worst}")
    log(f"[distill-cpu] {len(s_c)} running statistics within {CPU_STATS_TOL}:"
        f" worst {worst:.2e}")


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def roi_train_kernels_phase(dev: torch.device, kernels: dict) -> None:
    """The bf16 RoIAlign forward and the RoIAlign backward (f32 and bf16
    levels) against their plain versions at the train step's shapes: P2-P5
    of one batch-2 832x1344 bucket, C=256; the box loss's 512 RoIs an
    image at 7x7 bins, and the mask or keypoint loss's 128 positive slots
    an image at 14x14 (image 1 without a positive, as happens).  Where the
    backward's time goes: zeroing its float32 workspace, the scatter, and
    the rounding pass (bf16)."""
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops.roi_align import multiscale_roi_align_batch
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    h, w = BUCKETS[0]
    size = (h, w)
    rng = np.random.RandomState(SEED + 5)
    cases = {}
    boxes = torch.from_numpy(box_mix(rng, ORG_BATCH, TRAIN_ROIS, h, w)).to(dev)
    # sel_on: a few slots unsampled, as when an image has too few candidates
    cases[7] = (boxes, torch.from_numpy(
        rng.rand(ORG_BATCH, TRAIN_ROIS) > 0.05).to(dev))
    pos = np.zeros((ORG_BATCH, MAX_POSITIVES), bool)
    pos[0, :40] = True
    cases[14] = (torch.from_numpy(box_mix(rng, ORG_BATCH, MAX_POSITIVES, h,
                                          w)).to(dev),
                 torch.from_numpy(pos).to(dev))
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        levels = [torch.randn((ORG_BATCH, h // s, w // s, 256), generator=gen,
                              device=dev).to(dtype) for s in (4, 8, 16, 32)]
        shapes = [tuple(f.shape[1:3]) for f in levels]
        for pool, (boxes, valid) in cases.items():
            n_valid = int(valid.sum())
            cot = torch.randn(tuple(boxes.shape[:2]) + (pool, pool, 256),
                              generator=gen, device=dev).to(dtype)
            _, level, weight = RK.checked_inputs(levels, boxes, valid)
            got = RK.roi_align(levels, boxes, size, pool, 2, valid)
            want = multiscale_roi_align_batch(levels, boxes, size, pool, 2,
                                              valid)
            fwd_err = float((got.float() - want.float()).abs().max())
            log(f"[roi-train] forward {tag} {tuple(got.shape)}: max abs err "
                f"{fwd_err} (bit-identical: {torch.equal(got, want)})")
            if dtype == torch.bfloat16:
                # the kernel rounds the plain version's float32 bin once
                check(torch.equal(got, want), f"roi_align bf16 {pool}x{pool}"
                      " is not bit-identical to its plain version")
            ref = [f.clone().requires_grad_(True) for f in levels]
            plain_out = multiscale_roi_align_batch(ref, boxes, size, pool, 2,
                                                   valid)
            plain = torch.autograd.grad(plain_out, ref, cot,
                                        retain_graph=True)
            got_g = RK.roi_align_backward(cot, shapes, dtype, boxes, level,
                                          weight, size, 2)
            again = RK.roi_align_backward(cot, shapes, dtype, boxes, level,
                                          weight, size, 2)
            torch.cuda.synchronize()
            top = max(float(g.float().abs().max()) for g in plain)
            bwd_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got_g, plain))
            # float atomics add in another order than the plain scatter:
            # 1e-5 of the largest gradient (f32), one bf16 ulp of it (bf16)
            tol = ROI_TOL * top if dtype == torch.float32 else bf16_ulp(top)
            same = all(torch.equal(a, b) for a, b in zip(got_g, again))
            log(f"[roi-train] backward {tag} {pool}x{pool}: max abs err "
                f"{bwd_err:.3e} (largest |plain grad| {top:.3e}, bound "
                f"{tol:.3e}); two runs {'agree' if same else 'differ'} bit "
                "for bit (float atomics: the order of the adds is not "
                "fixed)")
            check(bwd_err <= tol, f"roi_align_bwd {tag} {pool}x{pool}: "
                  f"{bwd_err} > {tol}")
            bwd_t = timings(lambda: RK.roi_align_backward(
                cot, shapes, dtype, boxes, level, weight, size, 2))
            plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
                plain_out, ref, cot, retain_graph=True))
            # 2 x 2 samples of 4 taps, a multiply and an add each, and the
            # validity weight, per (valid RoI, bin, channel)
            n_ops = 33.0 * n_valid * pool * pool * 256
            fwd_bound = roi_bound(levels, boxes, valid, size, pool,
                                  nbytes(boxes, valid, got), n_ops)
            bwd_bound = bound(nbytes(cot, boxes, valid, *got_g), n_ops)
            fwd_t = timings(lambda: RK.roi_align(levels, boxes, size, pool,
                                                 2, valid))
            plain_fwd_ms = time_ms(lambda: multiscale_roi_align_batch(
                levels, boxes, size, pool, 2, valid))
            # the backward's float32 workspace: its zeroing and, for bf16
            # levels, the rounding pass, each timed alone on the card
            n_ws = sum(f.numel() for f in levels)
            ws = torch.zeros(n_ws, device=dev)
            zero_ms = time_ms(lambda: torch.zeros(n_ws, device=dev),
                              spin=True)
            round_ms = 0.0
            if dtype == torch.bfloat16:
                out = torch.empty(n_ws, dtype=torch.bfloat16, device=dev)
                stream = torch.cuda.current_stream(dev).cuda_stream
                round_ms = time_ms(lambda: _build.check(
                    _build.load().hnd_f32_to_bf16(ws.data_ptr(),
                                                  out.data_ptr(), n_ws,
                                                  stream),
                    "hnd_f32_to_bf16"), spin=True)
                del out
            bwd_t.update(workspace_zero_device_ms=zero_ms,
                         rounding_device_ms=round_ms,
                         workspace_mb=n_ws * 4 / 1e6)
            log(f"[roi-train] {pool}x{pool} forward {tag}: {fwd_t['ms']:.4f} "
                f"ms kernel ({fwd_t['device_ms']:.4f} on the card), "
                f"{plain_fwd_ms:.4f} ms plain; backward {bwd_t['ms']:.4f} ms "
                f"kernel ({bwd_t['device_ms']:.4f} on the card: zeroing the "
                f"{n_ws * 4 / 1e6:.1f} MB workspace {zero_ms:.4f}, rounding "
                f"{round_ms:.4f}, the scatter the rest), {plain_bwd_ms:.4f} "
                f"ms plain autograd (median of {REPS}); bounds "
                f"{fwd_bound['bound_ms']:.4f} (tapped cells; whole levels "
                f"{fwd_bound['whole_levels_bound_ms']:.4f}) / "
                f"{bwd_bound['bound_ms']:.4f} ms by {fwd_bound['bound_by']}")
            # no single PyTorch call computes either function (no
            # torchvision)
            if dtype == torch.bfloat16:
                suffix = "" if pool == 7 else f"_p{pool}"
                kernels["roi_align_bf16" + suffix] = dict(
                    source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
                    replaces="hnd_ghnd_tpu/ops/pallas_roi.py:231",
                    max_abs_err=fwd_err, **fwd_t, plain_ms=plain_fwd_ms,
                    library_ms=None, **fwd_bound)
                kernels["roi_align_bwd" + suffix] = dict(
                    source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
                    replaces="hnd_ghnd_tpu/ops/pallas_roi.py:446",
                    max_abs_err=bwd_err, **bwd_t, plain_ms=plain_bwd_ms,
                    library_ms=None, **bwd_bound)
            del cot, got, want, ref, plain_out, plain, got_g, again, ws
        del levels
    torch.cuda.empty_cache()


def int8_kernels_phase(dev: torch.device, kernels: dict) -> None:
    """The level quantizer and the int8 RoIAlign against their plain
    versions at the eval's shapes: P2-P5 of a batch-8 832x1344 bucket
    (C=256, NCHW maps as the FPN gives them; the quantizer also on copies
    holding NaN and +-inf), 8x1000 RoIs at 7x7 (the box head) and 8x100 at
    14x14 (the mask and keypoint heads); the int8 pool
    against the f32 pool of the same float levels; the f32 kernel at
    14x14; and what the int8 box pool with its quantize costs against the
    f32 box pool with its NHWC copy."""
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops.roi_align import (assign_levels,
                                                  multiscale_roi_align_batch,
                                                  quantize_fpn_levels)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    h, w = BUCKETS[0]
    size = (h, w)
    # levels of different ranges; the last image's lower half is padding
    nchw = []
    for i, s in enumerate((4, 8, 16, 32)):
        f = torch.randn((EVAL_BATCH, 256, h // s, w // s), generator=gen,
                        device=dev) * (1.0 + i)
        f[-1, :, h // s // 2:] = 0.0
        nchw.append(f)
    views = [f.permute(0, 2, 3, 1) for f in nchw]
    nhwc = [v.contiguous() for v in views]
    codes, scales = RK.quantize_levels(views)
    plain_q, plain_s = quantize_fpn_levels(views)
    cpu_q, cpu_s = quantize_fpn_levels([v.cpu() for v in nhwc])
    again_q, again_s = RK.quantize_levels(nhwc)
    for what, (q, s) in (("plain on the card", (plain_q, plain_s)),
                         ("the CPU", (cpu_q, cpu_s)),
                         ("the NHWC route", (again_q, again_s))):
        check(torch.equal(scales.cpu(), s.cpu())
              and all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(codes, q)),
              f"quantize_levels codes or scales differ from {what}")
    log(f"[kernels] quantize_levels P2-P5 of {tuple(views[0].shape)}: codes "
        f"and scales bit-exact vs plain (card and CPU), from NCHW and NHWC; "
        f"scales {[float(v) for v in scales]}")
    del cpu_q, again_q, plain_q
    # non-finite levels (ROADMAP C12): a NaN in P2, +inf in P3, -inf in P4
    # and all three in P5; every code and scale as the plain version's
    odd = [v.clone() for v in views]
    odd[0][1, 5, 7, 3] = float("nan")
    odd[1][2, 3, 4, 5] = float("inf")
    odd[2][3, 4, 5, 6] = float("-inf")
    odd[3][4, 1, 2, 7:10] = torch.tensor([float("nan"), float("inf"),
                                          float("-inf")], device=dev)
    want_q, want_s = quantize_fpn_levels([v.cpu() for v in odd])
    for what, lv in (("NCHW", odd), ("NHWC", [v.contiguous() for v in odd])):
        for side, (q, s) in (("plain on the card", quantize_fpn_levels(lv)),
                             ("the CPU", (want_q, want_s))):
            got_q, got_s = RK.quantize_levels(lv)
            check(torch.equal(got_s.cpu(), s.cpu())
                  and all(torch.equal(a.cpu(), b.cpu())
                          for a, b in zip(got_q, q)),
                  f"quantize_levels on non-finite {what} levels differs from "
                  f"{side}")
    log(f"[kernels] quantize_levels with NaN and +-inf levels: codes and "
        f"scales bit-exact vs plain (card and CPU), from NCHW and NHWC; "
        f"scales {want_s.tolist()}")
    del odd, want_q, lv, got_q
    tables = (codes, scales)
    rng = np.random.RandomState(SEED + 9)
    for n, pool in ((1000, 7), (100, 14)):
        boxes = torch.from_numpy(box_mix(rng, EVAL_BATCH, n, h, w)).to(dev)
        valid = torch.from_numpy(rng.rand(EVAL_BATCH, n) > 0.3).to(dev)
        got = RK.roi_align(views, boxes, size, pool, 2, valid, quant=tables)
        want = multiscale_roi_align_batch(views, boxes, size, pool, 2, valid,
                                          quant=tables)
        err = float((got - want).abs().max())
        log(f"[kernels] roi_align_int8 {tuple(got.shape)}: max abs err {err} "
            f"(bit-identical: {torch.equal(got, want)})")
        # the plain float32 program, the same operations in the same order
        check(torch.equal(got, want), f"roi_align_int8 at {pool}x{pool} is "
              "not bit-identical to its plain version")
        # each bin is a mean (weights summing to at most 1) of values within
        # half a step of their floats: half its level's step, plus rounding
        f32 = RK.roi_align(nhwc, boxes, size, pool, 2, valid)
        step = scales[assign_levels(boxes.reshape(-1, 4)).long()]
        gap = (got - f32).abs().reshape(EVAL_BATCH * n, -1).max(1).values
        limit = 0.5 * step + ROI_TOL * float(f32.abs().max())
        check(bool((gap <= limit).all()), "the int8 pool is farther than "
              "half a quantization step from the f32 pool")
        log(f"[kernels] int8 vs f32 pool {pool}x{pool}: largest gap "
            f"{float(gap.max()):.4e}, {float((gap / limit).max()):.3f} of "
            f"its half step + rounding")
        if pool == 14:
            plain = multiscale_roi_align_batch(nhwc, boxes, size, 14, 2, valid)
            e14 = float((f32 - plain).abs().max())
            log(f"[kernels] roi_align f32 {tuple(f32.shape)}: max abs err "
                f"{e14} (max |plain| {float(plain.abs().max())}, bound "
                f"{ROI_TOL} x max)")
            check(e14 <= ROI_TOL * float(plain.abs().max()),
                  f"roi_align f32 at 14x14: {e14}")
            # the heads' pooling: kernel, plain version and bounds (tapped
            # cells and whole levels) per table
            n_ops = 33.0 * int(valid.sum()) * 196 * 256
            for tag, kernel, plain, levels, rest in (
                    ("f32", lambda: RK.roi_align(nhwc, boxes, size, 14, 2,
                                                 valid),
                     lambda: multiscale_roi_align_batch(nhwc, boxes, size, 14,
                                                        2, valid),
                     nhwc, nbytes(boxes, valid, f32)),
                    ("int8", lambda: RK.roi_align(views, boxes, size, 14, 2,
                                                  valid, quant=tables),
                     lambda: multiscale_roi_align_batch(
                         views, boxes, size, 14, 2, valid, quant=tables),
                     codes, nbytes(scales, boxes, valid, got))):
                t, plain_ms = timings(kernel), time_ms(plain)
                b14 = roi_bound(levels, boxes, valid, size, 14, rest, n_ops)
                log(f"[kernels] roi_align {tag} 8x100 RoIs at 14x14: "
                    f"{t['ms']:.4f} ms kernel ({t['device_ms']:.4f} on the "
                    f"card), {plain_ms:.4f} ms plain (median of {REPS}); "
                    f"bound (tapped cells) {b14['bound_ms']:.4f} ms by "
                    f"{b14['bound_by']}, {b14['bound_ms'] / t['ms']:.1%} of "
                    f"it, {b14['bound_ms'] / t['device_ms']:.1%} of the "
                    f"card's time; whole levels "
                    f"{b14['whole_levels_bound_ms']:.4f} ms")
            continue
        n_valid = int(valid.sum())
        kernels["roi_align_int8"] = dict(
            source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
            replaces="hnd_ghnd_tpu/ops/pallas_roi.py:231", max_abs_err=err,
            **timings(lambda: RK.roi_align(views, boxes, size, 7, 2, valid,
                                           quant=tables)),
            plain_ms=time_ms(lambda: multiscale_roi_align_batch(
                views, boxes, size, 7, 2, valid, quant=tables)),
            library_ms=None,
            **roi_bound(codes, boxes, valid, size, 7,
                        nbytes(scales, boxes, valid, got),
                        33.0 * n_valid * 49 * 256))
        # the box pool from the FPN's NCHW maps, both ways
        f32_way = time_ms(lambda: RK.roi_align(
            [v.contiguous() for v in views], boxes, size, 7, 2, valid))
        int8_way = time_ms(lambda: RK.roi_align(
            views, boxes, size, 7, 2, valid, quant=RK.quantize_levels(views)))
        log(f"[kernels] box pool 8x1000 7x7 from NCHW P2-P5: f32 (NHWC copy "
            f"+ pool) {f32_way:.4f} ms, int8 (quantize + pool) {int8_way:.4f} "
            f"ms (median of {REPS})")
    # abs, max, divide, round and two clamps per element
    n_el = sum(f.numel() for f in views)
    # floor_ms: the levels read twice (the abs-max before the first code)
    kernels["quantize_levels"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/fpn_quant.cu",
        replaces="hnd_ghnd_tpu/ops/roi_align.py:201", max_abs_err=0.0,
        **timings(lambda: RK.quantize_levels(views)),
        plain_ms=time_ms(lambda: quantize_fpn_levels(views)), library_ms=None,
        **bound(nbytes(*views, *codes, scales), 6.0 * n_el),
        floor_ms=bound(2 * nbytes(*views) + nbytes(*codes, scales),
                       6.0 * n_el)["bound_ms"])
    del nchw, views, nhwc, codes, tables, got, want, f32
    torch.cuda.empty_cache()


BOTTLENECK_CHANNEL = \
    STUDENT_MODEL["backbone"]["params"]["layer1"]["bottleneck_channel"]
# the B6 kernel's odd cases: (name, NHWC codes shape, C_out, kernel, stride,
# pad, groups): the byte path of C = 3, groups 2 (JAX's zero-point test),
# a strided padded conv on a ragged tile of M and N
INT8_CONV_ODD = (("cin3", (2, 37, 53, 3), 64, 2, 1, 0, 1),
                 ("groups2", (2, 29, 31, 64), 64, 3, 1, 1, 2),
                 ("s2p1", (3, 41, 27, 32), 48, 3, 2, 1, 1))
# layers 2-4 of the trunk: (planes, blocks); each block's first conv has
# stride 2 in its first block, which also has the downsample
INT8_STAGES = ((128, 4), (256, 6), (512, 3))
# the fused epilogue's cases for the kernel tests: (id, mode, ReLU'd
# unsigned site, unsigned input (zero point 128), identity, features)
INT8_EPILOGUE_CASES = (
    ("site", "site", False, False, None, False),
    ("site_relu_features", "site", True, True, None, True),
    ("float", "float", False, True, None, False),
    ("residual_codes_features", "residual", True, True, "codes", True),
    ("residual_float", "residual", True, True, "float", False))


def int8_trunk_convs(bucket, batch: int) -> list:
    """The int8 tail's 46 convolutions at ``bucket``, in the walk's order
    (split/int8.py ``_trunk_walk``): (site, NHWC codes shape, C_out,
    kernel, stride, pad).  The wire is [B, H/4 + 4, W/4 + 4, 3]; the
    decoder's k2 convs take 1 off each side's length, then layers 2-4 (4,
    6 and 3 blocks, the first of each with stride 2 and a downsample)."""
    h, w = bucket[0] // 4 + 4, bucket[1] // 4 + 4
    c = BOTTLENECK_CHANNEL
    convs = []
    for i, cout in enumerate((64, 128, 256, 256)):
        convs.append((f"dec{i}", (batch, h, w, c), cout, 2, 1, 0))
        h, w, c = h - 1, w - 1, cout
    for s_i, (planes, count) in enumerate(INT8_STAGES):
        for b_i in range(count):
            stride = 2 if b_i == 0 else 1
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            name = f"s{s_i}b{b_i}"
            convs.append((name + "c1", (batch, h, w, c), planes, 1, 1, 0))
            convs.append((name + "c2", (batch, h, w, planes), planes, 3,
                          stride, 1))
            convs.append((name + "c3", (batch, ho, wo, planes), 4 * planes,
                          1, 1, 0))
            if b_i == 0:
                convs.append((name + "ds", (batch, h, w, c), 4 * planes, 1,
                              stride, 0))
            h, w, c = ho, wo, 4 * planes
    return convs


def int8_walk_epilogue(site: str) -> dict:
    """What the int8 walk (split/int8.py ``_trunk_walk``) asks of the
    fused convolution named ``site`` by int8_trunk_convs: its mode, a
    ReLU'd unsigned site, an unsigned input (zero point 128), the
    residual's identity and the NCHW feature of a stage output."""
    if site.startswith("dec"):
        i = int(site[3:])
        return dict(mode="site", relu=i in (1, 3), zp_in=i in (0, 2),
                    identity=None, features=i == 3)
    s_i, b_i, conv = int(site[1]), int(site[3:-2]), site[-2:]
    if conv in ("c1", "c2"):
        return dict(mode="site", relu=True, zp_in=True, identity=None,
                    features=False)
    if conv == "ds":
        return dict(mode="float", relu=False, zp_in=True, identity=None,
                    features=False)
    return dict(mode="residual", relu=True, zp_in=True,
                identity="float" if b_i == 0 else "codes",
                features=b_i == INT8_STAGES[s_i][1] - 1)


def int8_walk_order(convs: list) -> list:
    """int8_trunk_convs' indices in the walk's order: a block's downsample
    runs before its c3, whose residual reads it."""
    order = list(range(len(convs)))
    for i, conv in enumerate(convs):
        if conv[0].endswith("ds"):
            order[i - 1], order[i] = i, i - 1
    return order


def int8_epilogue(gen: torch.Generator, q: torch.Tensor, qw: torch.Tensor,
                  stride: int, pad: int, groups: int, mode: str,
                  relu: bool = False, zp_in: bool = False, identity=None,
                  features: bool = False) -> dict:
    """Seeded epilogue operands for ``int8_conv_requant(q, qw, stride,
    pad, groups, **out)`` on q's device: per-channel scales that put y near
    +-1.3, biases in [-0.5, 0.5], a site step of 2^-6 (2^-7 unsigned); an
    unsigned input's zero point share, 128 x the in-image weight sums (the
    border map [1, Ho, Wo, C_out] with padding); channels 0-2 of the bias
    NaN, +inf and -inf, channels 3-6 with scale 0 and a bias at half-way
    quotients; a residual's identity as unsigned codes (scale 2^-7, zero
    at channels 3-6) or as float32 (zero at channels 3-6, NaN, +inf and
    -inf at channels 7-9)."""
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    dev = q.device
    b, h, w, _ = q.shape
    n, kh, kw, cg = qw.shape
    ho, wo = IC.out_size(h, kh, stride, pad), IC.out_size(w, kw, stride, pad)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    out = dict(mode=mode, relu=relu, unsigned=relu, features=features,
               scale=(0.5 + uniform(n)) * (4.0 / (128 * 128 * float(
                   np.sqrt(kh * kw * cg)))),
               bias=uniform(n) - 0.5)
    step = 2.0 ** -7 if relu or mode == "residual" else 2.0 ** -6
    out["site_scale"] = torch.full((), step, device=dev)
    if zp_in:
        if pad == 0:
            out["zp"] = (IC.ZP * qw.long().sum((1, 2, 3))).float()
        else:
            ones = torch.ones((1, h, w, q.shape[3]), dtype=torch.int8,
                              device=dev)
            out["zp"] = IC.ZP * IC.int8_conv_plain(ones, qw, stride, pad,
                                                   groups).float()
    half = ((2.5, 3.5, 254.5, 0.5) if relu or mode == "residual"
            else (2.5, 3.5, -2.5, -0.5))
    if n >= 10:
        out["bias"][:3] = torch.tensor([float("nan"), float("inf"),
                                        -float("inf")])
        out["scale"][3:7] = 0.0
        out["bias"][3:7] = torch.tensor(half) * step
    if identity == "codes":
        codes = torch.randint(-128, 128, (b, ho, wo, n), generator=gen,
                              device=dev, dtype=torch.int8)
        codes[..., 3:7] = -IC.ZP
        out["identity"] = (codes, torch.full((), 2.0 ** -7, device=dev),
                           IC.ZP)
    elif identity == "float":
        ident = torch.randn((b, ho, wo, n), generator=gen, device=dev)
        ident[..., 3:7] = 0.0
        if n >= 10:
            ident[..., 7:10] = torch.tensor([float("nan"), float("inf"),
                                             -float("inf")])
        out["identity"] = ident
    return out


def int8_outputs_equal(got, want) -> bool:
    """Outputs of int8_conv_requant and its plain version equal bit for
    bit, NaN where NaN (the float mode's), features too."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.is_floating_point:
            nan = torch.isnan(b)
            if not (torch.equal(torch.isnan(a), nan)
                    and torch.equal(a[~nan], b[~nan])):
                return False
        elif not torch.equal(a, b):
            return False
    return len(got) == len(want)


def conv_work(shape, cout: int, k: int, stride: int, pad: int,
              groups: int = 1):
    """(multiply-adds, bytes: codes and weights read once, int32 sums
    written once) of one int8 convolution."""
    b, h, w, c = shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    macs = b * ho * wo * cout * k * k * (c // groups)
    return macs, b * h * w * c + cout * k * k * (c // groups) \
        + 4 * b * ho * wo * cout


def fused_conv_bytes(shape, cout: int, k: int, stride: int, pad: int,
                     epi: dict, groups: int = 1) -> dict:
    """The bytes one fused int8 convolution (``int8_conv_requant`` with the
    walk's epilogue ``epi``, int8_walk_epilogue) must move, each input read
    once and each output written once: codes, weights, the per-channel
    scale, bias and zero point share (or the border map), the output codes
    (float32 for the float mode) and the residual's identity; the NCHW
    float32 feature apart."""
    b, h, w, c = shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    m = b * ho * wo
    n = b * h * w * c + cout * k * k * (c // groups) + 8 * cout + 4
    if epi["zp_in"]:
        n += 4 * cout if pad == 0 else 4 * ho * wo * cout
    n += m * cout * (4 if epi["mode"] == "float" else 1)
    if epi["identity"] is not None:
        n += m * cout * (4 if epi["identity"] == "float" else 1) + 4
    return {"bytes": n, "feature_bytes": 4 * m * cout if epi["features"]
            else 0}


def im2col_int8(q: torch.Tensor, k: int, stride: int, pad: int,
                k_cols: int) -> torch.Tensor:
    """[B Ho Wo, k_cols] int8 rows of each output pixel's taps in the
    weights' (kh, kw, C) order, zero columns past k k C: the A operand of
    ``torch._int_mm`` (the library yardstick of B6, never on the path)."""
    import torch.nn.functional as F
    b, h, w, c = q.shape
    x = F.pad(q, (0, 0, pad, pad, pad, pad)) if pad else q
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    sb, sh, sw, sc = x.stride()
    cols = x.as_strided((b, ho, wo, k, k, c),
                        (sb, sh * stride, sw * stride, sh, sw, sc))
    a = cols.reshape(b * ho * wo, k * k * c)
    if k_cols > a.shape[1]:
        a = F.pad(a, (0, k_cols - a.shape[1]))
    return a.contiguous()


def int8_conv_kernels_phase(dev: torch.device, kernels: dict) -> None:
    """B6, the int8 tail's s8 x s8 -> s32 convolution, against its plain
    version (a float64 convolution on the card, exact) on every distinct
    conv shape of the trunk at batch EVAL_BATCH on the 832x1344 bucket and
    on INT8_CONV_ODD, bit for bit in int32, on seeded codes in [-128, 127]
    and weights in [-127, 127] (sums up to ~2^26, past float32's 2^24).
    Timed: the trunk's 46 launches in the walk's order, and its largest
    conv alone; the library yardstick is ``torch._int_mm`` on im2col'd
    codes built beforehand (the copies timed apart), K padded to a
    multiple of 8."""
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)

    def codes(shape, lo=-128):
        return torch.randint(lo, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    convs = int8_trunk_convs(BUCKETS[0], EVAL_BATCH)
    inputs = {shape: codes(shape) for _, shape, *_ in convs}
    weights = [codes((cout, k, k, shape[3]), lo=-127)
               for _, shape, cout, k, _, _ in convs]
    checked, err = set(), 0

    def compare(what, x, wt, stride, pad, groups=1):
        got = IC.int8_conv(x, wt, stride, pad, groups)
        want = IC.int8_conv_plain(x, wt, stride, pad, groups)
        e = int((got.long() - want.long()).abs().max())
        check(e == 0 and got.dtype == torch.int32, f"int8_conv {what}: "
              f"differs from the plain version by up to {e}")
        return e

    for (name, shape, cout, k, stride, pad), wt in zip(convs, weights):
        key = (shape, cout, k, stride, pad)
        if key not in checked:
            checked.add(key)
            err = max(err, compare(f"{name} {shape} -> {cout} k{k} "
                                   f"s{stride} p{pad}", inputs[shape], wt,
                                   stride, pad))
    for name, shape, cout, k, stride, pad, groups in INT8_CONV_ODD:
        err = max(err, compare(name, codes(shape),
                               codes((cout, k, k, shape[3] // groups),
                                     lo=-127), stride, pad, groups))
    log(f"[kernels] int8_conv: {len(checked)} trunk shapes at batch "
        f"{EVAL_BATCH} on {BUCKETS[0]} and {len(INT8_CONV_ODD)} odd cases "
        "equal the plain version bit for bit (int32)")

    def run(i):
        _, shape, _, _, stride, pad = convs[i]
        return IC.int8_conv(inputs[shape], weights[i], stride, pad)

    def plain(i):
        _, shape, _, _, stride, pad = convs[i]
        return IC.int8_conv_plain(inputs[shape], weights[i], stride, pad)

    # torch._int_mm: A [M, K'] row-major, B [K', N] (the weights' [N, K']
    # transposed), K' the multiple of 8 at or above K
    k_cols = [-(-k * k * shape[3] // 8) * 8 for _, shape, _, k, _, _ in convs]
    lib_args = []
    for (_, shape, cout, k, stride, pad), wt, kc in zip(convs, weights,
                                                        k_cols):
        wm = wt.reshape(cout, -1)
        if kc > wm.shape[1]:
            wm = torch.nn.functional.pad(wm, (0, kc - wm.shape[1]))
        lib_args.append((im2col_int8(inputs[shape], k, stride, pad, kc),
                         wm.t()))
    work = [conv_work(shape, cout, k, stride, pad)
            for _, shape, cout, k, stride, pad in convs]
    big = max(range(len(convs)), key=lambda i: work[i][0])
    a, b = lib_args[big]
    check(torch.equal(torch._int_mm(a, b).view(run(big).shape), run(big)),
          "torch._int_mm disagrees with int8_conv on the largest conv")
    trunk = timings(lambda: [run(i) for i in range(len(convs))])
    alone = timings(lambda: run(big))
    im2col_ms = time_ms(lambda: [
        im2col_int8(inputs[shape], k, stride, pad, kc)
        for (_, shape, _, k, stride, pad), kc in zip(convs, k_cols)])
    macs = sum(m for m, _ in work)
    paths = dict.fromkeys(IC.template_launches, 0)
    for i in range(len(convs)):
        _, shape, _, _, stride, _ = convs[i]
        paths[IC.template_for(inputs[shape], weights[i], stride)] += 1
    kernels["int8_conv"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/int8_conv.cu",
        replaces="hnd_ghnd_tpu/split/int8.py:206",
        max_abs_err=float(err), **trunk,
        tops=2e-9 * sum(m for m, _ in work) / trunk["device_ms"],
        plain_ms=time_ms(lambda: [plain(i) for i in range(len(convs))]),
        library_ms=time_ms(lambda: [torch._int_mm(a, b) for a, b in lib_args]),
        library_im2col_ms=im2col_ms, templates=paths,
        **bound(sum(n for _, n in work), 2.0 * macs, PEAK_INT8_PER_S),
        shape=f"the trunk's {len(convs)} convs at batch {EVAL_BATCH} on "
              f"{BUCKETS[0]}, {macs / 1e9:.3f} G multiply-adds",
        largest={"site": convs[big][0], "macs": work[big][0], **alone,
                 "plain_ms": time_ms(lambda: plain(big)),
                 "library_ms": time_ms(lambda: torch._int_mm(a, b)),
                 **bound(work[big][1], 2.0 * work[big][0], PEAK_INT8_PER_S)})
    k = kernels["int8_conv"]
    log(f"[kernels] int8_conv trunk ({k['shape']}): {k['ms']:.3f} ms "
        f"({k['device_ms']:.3f} on the card), {2e-9 * macs / k['device_ms']:.1f}"
        f" TOPS; plain {k['plain_ms']:.3f} ms; torch._int_mm "
        f"{k['library_ms']:.3f} ms (+ {im2col_ms:.3f} ms of im2col copies, "
        f"not counted); bound {k['bound_ms']:.4f} ms by {k['bound_by']}. "
        f"Largest conv {k['largest']['site']}: {k['largest']['ms']:.4f} ms "
        f"({k['largest']['device_ms']:.4f} on the card), plain "
        f"{k['largest']['plain_ms']:.4f}, torch._int_mm "
        f"{k['largest']['library_ms']:.4f}, bound "
        f"{k['largest']['bound_ms']:.4f} ms by {k['largest']['bound_by']}; "
        f"main loops {paths}")
    del lib_args, a, b
    int8_fused_walk_phase(dev, kernels, gen, convs, inputs, weights, work)


def int8_fused_walk_phase(dev: torch.device, kernels: dict, gen, convs,
                          inputs, weights, work) -> None:
    """B6 with the int8 walk's epilogue in its store
    (``int8_conv_requant``): each of the trunk's 46 convolutions with the
    mode the walk gives it (int8_walk_epilogue) on seeded operands
    (int8_epilogue: NaN, +-inf and half-way quotients in a few channels),
    held to its plain version bit for bit on every distinct shape and mode;
    timed in the walk's order (each downsample before its c3); its bound
    counts the bytes of fused_conv_bytes, with and without the four NCHW
    features; the launches of each main loop in one walk."""
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    epis = [int8_walk_epilogue(c[0]) for c in convs]
    args = [int8_epilogue(gen, inputs[shape], weights[i], stride, pad, 1,
                          **epis[i])
            for i, (_, shape, _, _, stride, pad) in enumerate(convs)]
    order = int8_walk_order(convs)

    def fused(i):
        _, shape, _, _, stride, pad = convs[i]
        return IC.int8_conv_requant(inputs[shape], weights[i], stride, pad,
                                    **args[i])

    def plain(i):
        _, shape, _, _, stride, pad = convs[i]
        return IC.int8_conv_requant_plain(inputs[shape], weights[i], stride,
                                          pad, **args[i])

    checked = set()
    for i, (name, shape, cout, k, stride, pad) in enumerate(convs):
        key = (shape, cout, k, stride, pad, tuple(sorted(epis[i].items())))
        if key not in checked:
            checked.add(key)
            check(int8_outputs_equal(fused(i), plain(i)),
                  f"int8_conv_requant {name} ({epis[i]}) differs from its "
                  "plain version")
    for name, shape, cout, k, stride, pad, groups in INT8_CONV_ODD:
        x = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        wt = torch.randint(-127, 128, (cout, k, k, shape[3] // groups),
                           generator=gen, device=dev, dtype=torch.int8)
        for case, mode, relu, zp_in, identity, features in \
                INT8_EPILOGUE_CASES:
            kw = int8_epilogue(gen, x, wt, stride, pad, groups, mode, relu,
                               zp_in, identity, features)
            check(int8_outputs_equal(
                IC.int8_conv_requant(x, wt, stride, pad, groups, **kw),
                IC.int8_conv_requant_plain(x, wt, stride, pad, groups, **kw)),
                f"int8_conv_requant {name} {case} differs from its plain "
                "version")
    before = dict(IC.template_launches)
    for i in order:
        fused(i)
    paths = {k: v - before[k] for k, v in IC.template_launches.items()}
    check(paths == {"wgmma": len(convs) - 1, "mma_sync": 1},
          f"the fused walk's main loops: {paths}")
    log(f"[kernels] int8_conv_requant: {len(checked)} trunk shapes and modes "
        f"at batch {EVAL_BATCH} on {BUCKETS[0]} and {len(INT8_CONV_ODD)} x "
        f"{len(INT8_EPILOGUE_CASES)} odd cases equal the plain version bit "
        f"for bit; main loops of one walk {paths}")
    nb = [fused_conv_bytes(shape, cout, k, stride, pad, e)
          for (_, shape, cout, k, stride, pad), e in zip(convs, epis)]
    macs = sum(m for m, _ in work)
    feat_bytes = sum(b["feature_bytes"] for b in nb)
    walk = timings(lambda: [fused(i) for i in order])
    kernels["int8_conv_requant"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/int8_conv.cu",
        replaces="hnd_ghnd_tpu/split/int8.py:206", max_abs_err=0.0, **walk,
        plain_ms=time_ms(lambda: [plain(i) for i in order]),
        library_ms=None, templates=paths,
        **bound(sum(b["bytes"] for b in nb) + feat_bytes, 2.0 * macs,
                PEAK_INT8_PER_S),
        bound_without_features_ms=bound(sum(b["bytes"] for b in nb),
                                        2.0 * macs,
                                        PEAK_INT8_PER_S)["bound_ms"],
        tops=2e-9 * macs / walk["device_ms"],
        shape=f"the trunk's {len(convs)} convs at batch {EVAL_BATCH} on "
              f"{BUCKETS[0]} with the walk's epilogues, "
              f"{macs / 1e9:.3f} G multiply-adds, "
              f"{sum(b['bytes'] for b in nb) / 1e9:.3f} GB + "
              f"{feat_bytes / 1e9:.3f} GB of NCHW features")
    k = kernels["int8_conv_requant"]
    log(f"[kernels] int8_conv_requant walk ({k['shape']}): {k['ms']:.3f} ms "
        f"({k['device_ms']:.3f} on the card), {k['tops']:.1f} TOPS; plain "
        f"{k['plain_ms']:.3f} ms; bound {k['bound_ms']:.4f} ms by "
        f"{k['bound_by']} ({k['bound_without_features_ms']:.4f} without the "
        "features)")
    del args, inputs, weights
    torch.cuda.empty_cache()


def heads_phase(dev: torch.device, serving, fpn_cpu, props, pvalid,
                one: dict, served: list) -> dict:
    """The GHND b3ch Mask and Keypoint R-CNN students (the serving model's
    trunk, FPN and RPN, their own seeded heads, live BNs, class logits x300)
    serve ``served`` through ``runners.common.evaluate`` with int8_roi_pool
    off, then on; then card against CPU at batch 1 with the switch on, on
    the CPU's FPN maps and proposals (``fpn_cpu``, ``props``, ``pvalid`` of
    ``one``) and the CPU's detections.  Returns the kernels' launches in
    the switched-on runs."""
    from hnd_ghnd_tpu_torch.models.factory import build_model, get_model
    from hnd_ghnd_tpu_torch.runners.common import evaluate
    shared = {k: v for k, v in serving.state_dict().items()
              if k.startswith(("backbone.", "rpn."))}
    n = len(served)
    total = {"roi_align_int8": 0, "quantize_levels": 0}
    for cfg, head in ((MASK_STUDENT_MODEL, "mask_probs"),
                      (KEYPOINT_STUDENT_MODEL, "keypoint_logits")):
        kind = cfg["name"]
        off = live_norms_(get_model(cfg, seed=SEED, device=dev), SEED)
        off.load_state_dict(shared, strict=False)
        off.roi_heads.box_predictor.cls_score.weight.data.mul_(300.0)
        on_cfg = dict(cfg, params=dict(cfg["params"], int8_roi_pool=True))
        on = build_model(on_cfg)
        on.load_state_dict(off.state_dict())
        models = {"off": off.requires_grad_(False),
                  "on": on.to(dev).requires_grad_(False)}
        dets = {}
        for tag, model in models.items():
            zero_kernel_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            records = evaluate(model, served, use_bottleneck_transformer=True)
            wall = time.perf_counter() - t0
            got = {k: v for k, v in kernel_counts().items()
                   if k in ("quantize", "dequantize", "roi_align",
                            "roi_align_int8", "quantize_levels")}
            want = ({"quantize": n, "dequantize": n, "roi_align": 2 * n,
                     "roi_align_int8": 0, "quantize_levels": 0}
                    if tag == "off" else
                    {"quantize": n, "dequantize": n, "roi_align": 0,
                     "roi_align_int8": 2 * n, "quantize_levels": n})
            log(f"[heads] {kind} int8 {tag}: {n} batches in {wall:.3f} s; "
                f"launches {got}; peak memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            check(got == want, f"{kind} int8 {tag}: launches {got}, want "
                  f"{want}")
            if tag == "on":
                for k in total:
                    total[k] += got[k]
            for i, (batch, rec) in enumerate(zip(served, records)):
                b = batch["images"].shape[0]
                out = rec["dets"][head]
                shape = ((b, 100, 28, 28) if head == "mask_probs"
                         else (b, 100, 56, 56, 17))
                check(out.shape == shape, f"{kind} {head} shape {out.shape}")
                check(bool(np.isfinite(out).all()), f"{kind} non-finite {head}")
                if head == "mask_probs":
                    check(bool(((out >= 0) & (out <= 1)).all()),
                          "mask_probs outside [0, 1]")
                check(bool(np.isfinite(rec["dets"]["boxes"]).all()),
                      "non-finite boxes")
                log(f"[heads] {kind} int8 {tag} batch {i} "
                    f"{tuple(batch['images'].shape)}: {rec['ms']:.2f} ms, "
                    f"{int(rec['dets']['valid'].sum())} detections")
            dets[tag] = [r["dets"] for r in records[-3:]]
        # how many of the f32 tables' detections the int8 tables keep
        kept = total_f32 = 0
        for a, b in zip(dets["off"], dets["on"]):
            for i in range(a["valid"].shape[0]):
                for j in np.flatnonzero(a["valid"][i]):
                    total_f32 += 1
                    kept += bool((b["valid"][i]
                                  & (b["labels"][i] == a["labels"][i, j])
                                  & (np.abs(b["boxes"][i] - a["boxes"][i, j])
                                     .max(1) < 0.5)).any())
        log(f"[heads] {kind}: the int8 forward shares {kept} of the f32 "
            f"forward's {total_f32} detections (label, box within 0.5 px)")
        # card vs CPU, switch on: the CPU's maps, proposals and detections
        cpu = build_model(on_cfg).requires_grad_(False)
        cpu.load_state_dict({k: v.cpu() for k, v in off.state_dict().items()})
        shape_ = BUCKETS[0]
        sizes = torch.from_numpy(one["image_sizes"])
        t0 = time.perf_counter()
        with torch.no_grad():
            det_c = cpu.roi_heads.infer(fpn_cpu, props, pvalid, sizes, shape_)
        cpu_s = time.perf_counter() - t0
        on_gpu = [f.to(dev) for f in fpn_cpu]
        with torch.no_grad():
            tables = on.roi_heads.pool_tables(on_gpu, True)
            cpu_tables = cpu.roi_heads.pool_tables(fpn_cpu, True)
            check(torch.equal(tables[1][1].cpu(), cpu_tables[1][1])
                  and all(torch.equal(a.cpu(), b) for a, b in
                          zip(tables[1][0], cpu_tables[1][0])),
                  "the card's int8 tables differ from the CPU's")
            out_g = on.roi_heads.head_outputs(
                tables, det_c["boxes"].to(dev), det_c["valid"].to(dev),
                det_c["labels"].to(dev), shape_)
        e = rel_err(out_g[head], det_c[head])
        log(f"[heads] {kind} card vs CPU (int8 tables, the CPU's "
            f"{int(det_c['valid'].sum())} detections): {head} rel err "
            f"{e:.2e} (CPU heads forward {cpu_s:.2f} s)")
        check(e <= STAGE_TOL, f"{kind} {head} card vs CPU: {e}")
        del off, on, models, cpu, on_gpu, tables, out_g
        torch.cuda.empty_cache()
    return total


def org_targets(rng: np.random.RandomState, sizes: np.ndarray):
    """1-8 GT boxes per image inside its valid size, labels 1-90, padded to
    MAX_GT with ``boxes_valid``, like the JAX loader's targets."""
    b = len(sizes)
    boxes = np.zeros((b, MAX_GT, 4), np.float32)
    labels = np.zeros((b, MAX_GT), np.int64)
    valid = np.zeros((b, MAX_GT), bool)
    for i, (h, w) in enumerate(sizes):
        g = rng.randint(1, 9)
        bw = rng.uniform(16, 0.6 * w, g)
        bh = rng.uniform(16, 0.6 * h, g)
        x1 = rng.uniform(0, w - bw)
        y1 = rng.uniform(0, h - bh)
        boxes[i, :g] = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
        labels[i, :g] = rng.randint(1, 91, g)
        valid[i, :g] = True
    return {"boxes": boxes, "labels": labels, "boxes_valid": valid}


def org_batch(rng: np.random.RandomState, bucket, b: int):
    """(batch, targets): float32 images in [0, 1] padded into the bucket."""
    bh, bw = bucket
    images = np.zeros((b, bh, bw, 3), np.float32)
    sizes = np.zeros((b, 2), np.int32)
    for i in range(b):
        h = bh if i % 2 == 0 else int(bh * rng.uniform(0.6, 1.0))
        w = bw if i % 3 == 0 else int(bw * rng.uniform(0.6, 1.0))
        images[i, :h, :w] = rng.rand(h, w, 3)
        sizes[i] = (h, w)
    batch = {"images": images, "image_sizes": sizes,
             "original_sizes": np.round(sizes * 0.75).astype(np.int32)}
    return batch, org_targets(rng, sizes)


def train_phase(dev: torch.device, eval_batch: dict) -> dict:
    """coco_runner.train of the org model in bfloat16: batch 2, 3 steps on
    each bucket and the first batch again, then the float32 eval of a
    batch-8 serving batch.  Returns the kernels' launches in that run."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners.coco_runner import train
    from hnd_ghnd_tpu_torch.utils.params import updatable_param_names
    model = live_norms_(get_model(ORG_MODEL, seed=SEED + 6, device=dev),
                        SEED + 6)
    start = copy.deepcopy(model.state_dict())
    trainable = set(updatable_param_names(model))
    frozen = [n for n, _ in model.named_parameters() if n not in trainable]
    rng = np.random.RandomState(SEED + 7)
    batches = [org_batch(rng, bucket, ORG_BATCH) for bucket in BUCKETS
               for _ in range(STEPS_PER_BUCKET)]
    batches.append(batches[0])
    n = len(batches)
    config = {"model": ORG_MODEL, "train": dict(ORG_TRAIN, num_epochs=1),
              "tpu": ORG_TPU}
    zero_kernel_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = train(model, config, batches, [eval_batch], n, seed=SEED)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernel_counts().items()
                if k in ("roi_align", "roi_align_bf16", "roi_align_bwd",
                         "nms_keep")}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[train] {n} bf16 steps + 1 float32 eval batch in {wall:.3f} s; "
        f"launches {launches}; peak memory {peak:.2f} GiB")
    for idx, loss, terms, ms in hist["steps"]:
        shape = tuple(batches[idx][0]["images"].shape)
        check(all(np.isfinite(v) for v in terms.values()),
              f"step {idx}: a non-finite loss term {terms}")
        log(f"[train] step {idx} {shape}: {ms:.3f} ms, loss {loss:.6e}, "
            + " ".join(f"{k} {v:.6e}" for k, v in terms.items()))
    check(len(hist["steps"]) == n, "a step's scalars are missing")
    check(launches["roi_align_bf16"] == n and launches["roi_align_bwd"] == n,
          "the bf16 RoIAlign forward and backward did not launch once per "
          "step")
    check(launches["roi_align"] == 1, "the f32 RoIAlign did not launch once "
          "in the float32 eval")
    after = model.state_dict()
    for name in frozen:
        check(torch.equal(after[name], start[name]), f"frozen {name} changed")
    for name in trainable:
        check(not torch.equal(after[name], start[name]),
              f"trainable {name} did not move")
    check(all(n.startswith(("backbone.body.conv1.", "backbone.body.bn1.",
                            "backbone.body.layer1.")) for n in frozen)
          and len(frozen) > 0, "freeze_layers froze something else")
    log(f"[train] {len(frozen)} frozen parameters (conv1, bn1, layer1) "
        f"bit-identical, {len(trainable)} trainable ones moved")
    (rec,) = hist["evals"][0]
    dets = rec["dets"]
    check(dets["boxes"].shape == (EVAL_BATCH, 100, 4)
          and bool(np.isfinite(dets["boxes"]).all())
          and bool(np.isfinite(dets["scores"]).all()), "eval output")
    log(f"[train] float32 eval of batch {tuple(eval_batch['images'].shape)}:"
        f" {rec['ms']:.2f} ms, {int(dets['valid'].sum())} detections")
    for bi, bucket in enumerate(BUCKETS):
        first = bi * STEPS_PER_BUCKET
        ms = [s[3] for s in hist["steps"]
              if tuple(batches[s[0]][0]["images"].shape[1:3]) == bucket
              and s[0] != first]
        log(f"[train] bucket {bucket}: median step "
            f"{statistics.median(ms):.3f} ms over {len(ms)} steps "
            f"({ORG_BATCH / statistics.median(ms) * 1e3:.2f} img/s)")
    return launches


def heads_targets(rng: np.random.RandomState, sizes: np.ndarray, kind: str,
                  targets: dict) -> dict:
    """``org_targets`` for a Mask or Keypoint R-CNN: each GT's inscribed
    ellipse as its mask, rasterized at the image's size and cropped by the
    loader's ``mask_box_crop`` into masks_crop [B, MAX_GT, 114, 114]
    float16; or 17 visible keypoints inside each GT box, keypoints
    [B, MAX_GT, 17, 3], with every label the person class."""
    from hnd_ghnd_tpu_torch.data.loader import MASK_CROP_SIZE, mask_box_crop
    boxes, valid = targets["boxes"], targets["boxes_valid"]
    b = len(sizes)
    if kind == "mask_rcnn":
        r = MASK_CROP_SIZE + 2
        crops = np.zeros((b, MAX_GT, r, r), np.float16)
        for i, (h, w) in enumerate(sizes):
            yy, xx = np.mgrid[:h, :w] + 0.5
            for j in np.flatnonzero(valid[i]):
                x1, y1, x2, y2 = boxes[i, j]
                inside = ((2 * xx - x1 - x2) / (x2 - x1)) ** 2 \
                    + ((2 * yy - y1 - y2) / (y2 - y1)) ** 2 <= 1.0
                crops[i, j] = mask_box_crop(inside.astype(np.uint8),
                                            boxes[i, j])
        return dict(targets, masks_crop=crops)
    kps = np.zeros((b, MAX_GT, 17, 3), np.float32)
    for i in range(b):
        for j in np.flatnonzero(valid[i]):
            x1, y1, x2, y2 = boxes[i, j]
            kps[i, j] = np.stack([rng.uniform(x1, x2, 17),
                                  rng.uniform(y1, y2, 17), np.full(17, 2.0)],
                                 -1)
    return dict(targets, keypoints=kps,
                labels=np.where(valid, 1, 0).astype(np.int64))


def heads_train_phase(dev: torch.device) -> dict:
    """coco_runner.train of the org Mask R-CNN and Keypoint R-CNN in
    bfloat16 (their configs' dtype): batch 2, STEPS_PER_BUCKET steps on
    each bucket with seeded synthetic targets (masks or keypoints), every
    term finite, the 7x7 and 14x14 RoIAlign kernels launched once each per
    step.  Then where a step goes: three more steps split by CUDA events
    into the forward with the losses, the backward and the update, and
    chip_profile.py's profiler breakdown of a step (the card's busy time,
    idle share, kernel groups).
    Returns {kind: the kernels' launches in the training run}."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute
    from hnd_ghnd_tpu_torch.runners.coco_runner import make_step, train
    from hnd_ghnd_tpu_torch.runners.common import to_device
    out = {}
    for kind, cfg in (("mask_rcnn", ORG_MASK_MODEL),
                      ("keypoint_rcnn", ORG_KEYPOINT_MODEL)):
        model = live_norms_(get_model(cfg, seed=SEED + 12, device=dev),
                            SEED + 12)
        rng = np.random.RandomState(SEED + 13)
        batches = []
        for bucket in BUCKETS:
            for _ in range(STEPS_PER_BUCKET):
                batch, targets = org_batch(rng, bucket, ORG_BATCH)
                batches.append((batch, heads_targets(
                    rng, batch["image_sizes"], kind, targets)))
        n = len(batches)
        # the masks or keypoints reach the card through pinned memory
        # without a host sync of their own
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moved = to_device(batches[0][1], dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        key = "masks_crop" if kind == "mask_rcnn" else "keypoints"
        log(f"[train-{kind}] {key} {tuple(moved[key].shape)} "
            f"{moved[key].dtype} moved to the card with no synchronizing "
            "call (sync debug mode: error)")
        config = {"model": cfg, "train": dict(ORG_TRAIN, num_epochs=1),
                  "tpu": ORG_TPU}
        zero_kernel_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        hist = train(model, config, batches, [], n, seed=SEED)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in kernel_counts().items() if v}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"[train-{kind}] {n} bf16 steps in {wall:.3f} s; launches "
            f"{counts}; peak memory {peak:.2f} GiB")
        extra = "loss_mask" if kind == "mask_rcnn" else "loss_keypoint"
        for idx, loss, terms, ms in hist["steps"]:
            shape = tuple(batches[idx][0]["images"].shape)
            check(len(terms) == 5 and extra in terms
                  and all(np.isfinite(v) for v in terms.values()),
                  f"{kind} step {idx}: terms {terms}")
            log(f"[train-{kind}] step {idx} {shape}: {ms:.3f} ms, loss "
                f"{loss:.6e}, " + " ".join(f"{k} {v:.6e}"
                                          for k, v in terms.items()))
        check(len(hist["steps"]) == n, "a step's scalars are missing")
        # the RPN's five levels: five NMS problems a step
        want = {"roi_align_bf16": n, "roi_align_bf16_p14": n,
                "roi_align_bwd": n, "roi_align_bwd_p14": n, "nms_keep": 5 * n}
        check(counts == want, f"{kind}: launches {counts}, want {want}")
        for bi, bucket in enumerate(BUCKETS):
            first = bi * STEPS_PER_BUCKET
            ms = [st[3] for st in hist["steps"]
                  if tuple(batches[st[0]][0]["images"].shape[1:3]) == bucket
                  and st[0] != first]
            log(f"[train-{kind}] bucket {bucket}: median step "
                f"{statistics.median(ms):.3f} ms over {len(ms)} steps "
                f"({ORG_BATCH / statistics.median(ms) * 1e3:.2f} img/s)")
        # where a step goes, on the first bucket
        step = make_step(model, config, n, SEED)
        dev_batches = [({k: torch.from_numpy(v).to(dev) for k, v in b.items()},
                        {k: torch.from_numpy(v).to(dev) for k, v in t.items()})
                       for b, t in batches[:STEPS_PER_BUCKET]]
        split = []
        for batch, targets in dev_batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            step.optimizer.zero_grad(set_to_none=True)
            ev[0].record()
            images = images_to_compute(batch["images"], torch.bfloat16)
            losses = model(dict(batch, images=images), targets, step.draw)
            ev[1].record()
            sum(losses.values()).backward()
            ev[2].record()
            step.apply_update()
            ev[3].record()
            ev[3].synchronize()
            split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        fwd, bwd, upd = (statistics.median(x) for x in zip(*split))
        log(f"[train-{kind}] step split on {BUCKETS[0]} (median of "
            f"{len(split)}): forward and losses {fwd:.3f} ms, backward "
            f"{bwd:.3f} ms, update {upd:.3f} ms")
        # the card's busy time and idle share in a step (chip_profile.py's
        # profiler breakdown)
        from chip_profile import device_profile
        prof = device_profile(lambda: step(*dev_batches[0]), "step")
        if "groups_ms" in prof:
            log(f"[train-{kind}] profile: {prof['latency_ms']:.3f} ms a step "
                f"unprofiled, the card busy {prof['busy_ms_per_step']:.3f} "
                f"ms (idle share {prof['idle_share']:.4f}), "
                f"{prof['launches_per_step']:.0f} device events; "
                + ", ".join(f"{g} {ms:.3f}"
                            for g, ms in prof["groups_ms"].items()))
            log(f"[train-{kind}] top kernels: " + "; ".join(
                f"{k['ms']:.3f} ms x{k['calls']:.0f} {k['name'][:60]}"
                for k in prof["top_kernels"][:6]))
        out[kind] = counts
        del model, step, dev_batches, hist
        torch.cuda.empty_cache()
    return out


def train_cpu_phase(dev: torch.device, model_cfg: dict = ORG_MODEL) -> None:
    """One supervised float32 step (TF32 off) on the card against the same
    step on the CPU in float64, at batch 1 on a quarter of the 832x1344
    bucket, of the org model ``model_cfg`` (Faster, Mask or Keypoint
    R-CNN: its box loss, and its mask or keypoint loss on seeded targets).
    Top-k, NMS and sampling are discrete: the CPU's RoI samples and the
    same RPN draws go to both sides."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute
    kind = model_cfg["name"]
    model = live_norms_(get_model(model_cfg, seed=SEED + 8, device="cpu"),
                        SEED + 8)
    rng = np.random.RandomState(SEED + 8)
    batch, targets = org_batch(rng, CPU_SHAPE, 1)
    if kind != "faster_rcnn":
        targets = heads_targets(rng, batch["image_sizes"], kind, targets)
    recorded = []  # the CPU's draws, replayed on the card

    def record(shape):
        r = torch.from_numpy(rng.rand(*shape).astype(np.float32))
        recorded.append(r)
        return r

    out, sampled = {}, None
    n_bwd = RK.launch_count(RK.roi_align_backward, torch.float32)
    for where in ("cpu", "gpu"):
        if where == "cpu":
            m, d, dtype = model.double(), torch.device("cpu"), torch.float64
            draw = record
        else:
            m, d, dtype = model.float().to(dev), dev, torch.float32
            replay = iter(list(recorded))
            draw = lambda shape: next(replay).to(dev)  # noqa: E731
        m.train().zero_grad(set_to_none=True)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        t = {k: torch.from_numpy(v).to(d) for k, v in targets.items()}
        for k in ("boxes", "keypoints"):
            if k in t:
                t[k] = t[k].to(dtype)
        t0 = time.perf_counter()
        images = images_to_compute(b["images"], dtype)
        _, feats = m.backbone_features(images)
        props, pvalid, raw = m.rpn.propose(feats, b["image_sizes"], CPU_SHAPE,
                                           training=True)
        losses = m.rpn.loss(raw, t, draw)
        if sampled is None:
            sampled = m.roi_heads.select_training_samples(props, pvalid, t,
                                                          record)
        s = tuple(x.to(d, dtype) if x.is_floating_point() else x.to(d)
                  for x in sampled)
        losses.update(m.roi_losses(feats, CPU_SHAPE, s, t))
        sum(losses.values()).backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in m.named_parameters()
                 if n.startswith(("roi_heads.", "backbone.fpn."))}
        out[where] = ({k: float(v.detach()) for k, v in losses.items()}, grads)
        log(f"[train-cpu] {kind} {where}: one step at {tuple(images.shape)} "
            f"in {time.perf_counter() - t0:.2f} s")
    n_pools = 1 if kind == "faster_rcnn" else 2
    check(RK.launch_count(RK.roi_align_backward, torch.float32)
          == n_bwd + n_pools,
          "the card's step did not run the backward kernel once per pooling")
    (t_g, g_g), (t_c, g_c) = out["gpu"], out["cpu"]
    worst = max(abs(t_g[k] - t_c[k]) / abs(t_c[k]) for k in t_c)
    log(f"[train-cpu] {kind} terms card / cpu: " + ", ".join(
        f"{k} {t_g[k]:.8e} / {t_c[k]:.8e}" for k in t_c)
        + f"; max rel {worst:.2e}")
    check(worst <= TRAIN_TERM_TOL, f"terms: {worst} > {TRAIN_TERM_TOL}")
    top = max(float(c.abs().max()) for c in g_c.values())
    rels = {n: float((g_g[n] - c).abs().max()
                     / max(float(c.abs().max()),
                           GRAD_FLOOR * top if float(c.abs().max())
                           <= 1e-12 * top else 0.0))
            for n, c in g_c.items()}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:4]
    log(f"[train-cpu] {kind}: {len(g_c)} gradients of the RoI heads and the "
        "FPN, largest errors (x their max): "
        + ", ".join(f"{n} {r:.2e}" for n, r in worst))
    head_tol, fpn_tol = TRAIN_GRAD_TOLS[kind]
    for name, rel in rels.items():
        tol = head_tol if name.startswith("roi_heads.") else fpn_tol
        check(rel <= tol, f"gradient {name}: {rel} of its max > {tol}")


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count: the RoIAlign forward by levels'
    dtype (f32 and int8 at any pool size), its bf16 forward and the bf16
    backward by pool size (7x7 box loss, 14x14 mask or keypoint loss)."""
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    from hnd_ghnd_tpu_torch.ops import nms as NMS
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    # every caller reads the counts right after a path on the card
    check(NMS.fixpoint.iterations == 0, f"a path on the card ran the NMS "
          f"fixpoint's host loop ({NMS.fixpoint.iterations} syncs)")
    fwd, bwd = RK.roi_align.launches, RK.roi_align_backward.launches
    return {"quantize": QK.quantize.launches,
            "dequantize": QK.dequantize.launches,
            "roi_align": RK.launch_count(RK.roi_align, torch.float32),
            "roi_align_bf16": fwd[(torch.bfloat16, 7)],
            "roi_align_bf16_p14": fwd[(torch.bfloat16, 14)],
            "roi_align_int8": RK.launch_count(RK.roi_align, torch.int8),
            "roi_align_bwd": bwd[(torch.bfloat16, 7)],
            "roi_align_bwd_p14": bwd[(torch.bfloat16, 14)],
            "quantize_levels": RK.quantize_levels.launches,
            "stem_fwd": SK.stem_fwd.launches,
            "stem_fwd_res": SK.stem_fwd_res.launches,
            "stem_dw": SK.stem_dw.launches,
            "int8_conv": IC.int8_conv.launches,
            "int8_conv_requant": IC.int8_conv_requant.launches,
            # B6's main loops, over both of its entries
            "int8_conv_wgmma": IC.template_launches["wgmma"],
            "int8_conv_mma_sync": IC.template_launches["mma_sync"],
            "nms_keep": NMS.nms_keep.launches}


def zero_kernel_counts() -> None:
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    from hnd_ghnd_tpu_torch.ops import nms as NMS
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    for fn in (QK.quantize, QK.dequantize, RK.quantize_levels, SK.stem_fwd,
               SK.stem_fwd_res, SK.stem_dw, IC.int8_conv,
               IC.int8_conv_requant, NMS.nms_keep):
        fn.launches = 0
    NMS.fixpoint.iterations = 0
    for path in IC.template_launches:
        IC.template_launches[path] = 0
    RK.roi_align.launches.clear()
    RK.roi_align_backward.launches.clear()


def box_polygon(x1: float, y1: float, x2: float, y2: float) -> list:
    """A box as a COCO polygon segmentation."""
    x1, y1, x2, y2 = (float(v) for v in (x1, y1, x2, y2))
    return [[x1, y1, x2, y1, x2, y2, x1, y2]]


def write_keypoint_annotations(ann_file: str, out_file: str,
                               rng: np.random.RandomState) -> int:
    """The person-keypoint file of a fixture split: each of
    ``ann_file``'s rectangles a person with 17 visible keypoints inside it
    (so every image keeps its >= 10 visible keypoints).  Returns the
    number of annotations."""
    with open(ann_file) as f:
        coco = json.load(f)
    for ann in coco["annotations"]:
        x, y, bw, bh = ann["bbox"]
        kps = np.stack([rng.uniform(x, x + bw, 17), rng.uniform(y, y + bh, 17),
                        np.full(17, 2.0)], -1)
        ann.update(category_id=1, keypoints=[float(v) for v in kps.ravel()],
                   num_keypoints=17)
    coco["categories"] = [{"id": 1, "name": "person", "skeleton": [],
                           "keypoints": [f"kp{i}" for i in range(17)]}]
    with open(out_file, "w") as f:
        json.dump(coco, f)
    return len(coco["annotations"])


def write_runner_fixture(root: str, rng: np.random.RandomState,
                         counts: dict = RUNNER_IMAGES,
                         shapes: tuple = RUNNER_SHAPES) -> dict:
    """COCO splits under ``root``: ``counts[split]`` JPEGs each, alternating
    ``shapes``, dark noise with 1-4 bright rectangles, each an annotation
    (box and polygon) of a random COCO category.  Returns {split: (image
    dir, annotation file)}."""
    from PIL import Image
    out = {}
    for split, n in counts.items():
        img_dir = os.path.join(root, split)
        os.makedirs(img_dir, exist_ok=True)
        images, anns = [], []
        for i in range(n):
            h, w = shapes[i % len(shapes)]
            arr = rng.randint(0, 60, (h, w, 3), dtype=np.uint8)
            for _ in range(rng.randint(1, 5)):
                bw, bh = rng.randint(w // 12, w // 2), rng.randint(h // 12, h // 2)
                x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
                arr[y:y + bh, x:x + bw] = rng.randint(120, 255, 3)
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": int(rng.randint(1, 91)),
                             "bbox": [float(x), float(y), float(bw),
                                      float(bh)],
                             "area": float(bw * bh), "iscrowd": 0,
                             "segmentation": box_polygon(x, y, x + bw,
                                                         y + bh)})
            name = f"{i + 1:06d}.jpg"
            Image.fromarray(arr).save(os.path.join(img_dir, name), quality=95)
            images.append({"id": i + 1, "file_name": name, "height": h,
                           "width": w})
        ann_file = os.path.join(root, f"instances_{split}.json")
        with open(ann_file, "w") as f:
            json.dump({"images": images, "annotations": anns, "categories": [
                {"id": c, "name": f"class{c}"} for c in range(1, 91)]}, f)
        out[split] = (img_dir, ann_file)
    return out


def teacher_annotations(teacher, config: dict, out_file: str):
    """The val split with ``teacher``'s own detections as its annotations
    (score >= GT_SCORE), written to ``out_file``: each box with its polygon,
    or with the pasted mask as its RLE (a Mask R-CNN; an empty mask is left
    out), or with its keypoints, all visible (a Keypoint R-CNN; the first
    KP_MAX_DETS an image by score).  Returns (the number of annotations,
    the loader's batches, their eval records)."""
    from hnd_ghnd_tpu_torch.evals import mask_rle
    from hnd_ghnd_tpu_torch.evals.postprocess import finalize_predictions
    from hnd_ghnd_tpu_torch.runners import common
    _, loader, _ = common.loaders_from_config(config, teacher.kind, 1)
    items = list(loader)
    records = common.evaluate(teacher.eval(), [b for b, _, _ in items])
    with open(config["dataset"]["splits"]["val"]["annotations"]) as f:
        coco = json.load(f)
    anns = []
    for (batch, _, host), rec in zip(items, records):
        for i, tgt in enumerate(host):
            if tgt["is_padding"]:
                continue
            pred = finalize_predictions(
                rec["dets"], i, tuple(tgt["original_size"]),
                tuple(int(v) for v in batch["image_sizes"][i]))
            keep = [j for j in np.argsort(-pred["scores"], kind="stable")
                    if pred["scores"][j] >= GT_SCORE]
            if "keypoints" in pred:
                keep = keep[:KP_MAX_DETS]
            for j in keep:
                x1, y1, x2, y2 = (float(v) for v in pred["boxes"][j])
                ann = {"id": len(anns) + 1, "image_id": tgt["image_id"],
                       "category_id": int(pred["labels"][j]),
                       "bbox": [x1, y1, x2 - x1, y2 - y1],
                       "area": (x2 - x1) * (y2 - y1), "iscrowd": 0,
                       "segmentation": box_polygon(x1, y1, x2, y2)}
                if "masks" in pred:
                    if not pred["masks"][j].any():
                        continue
                    ann["segmentation"] = {
                        "size": list(pred["masks"][j].shape),
                        "counts": mask_rle.encode(pred["masks"][j]).tolist()}
                if "keypoints" in pred:
                    kps = pred["keypoints"][j].copy()
                    kps[:, 2] = 2.0
                    ann.update(keypoints=[float(v) for v in kps.ravel()],
                               num_keypoints=len(kps))
                anns.append(ann)
    coco["annotations"] = anns
    with open(out_file, "w") as f:
        json.dump(coco, f)
    return len(anns), items, records


def blob_heatmaps(rng: np.random.RandomState, n: int, s: int = 56,
                  k: int = 17) -> np.ndarray:
    """[n, s, s, k] heatmaps with one Gaussian peak a keypoint and a little
    noise, as a trained head gives them (JAX's tests/test_kp_decode.py)."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    hm = np.zeros((n, s, s, k), np.float32)
    for i in range(n):
        for j in range(k):
            cy, cx = rng.uniform(4, s - 4, 2)
            sig = rng.uniform(1.5, 4.0)
            hm[i, :, :, j] = 8.0 * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
    return hm + rng.randn(n, s, s, k).astype(np.float32) * 0.05


def kp_decode_checks(dev: torch.device, items: list, records: list) -> None:
    """The device keypoint decode (``kp_decode: device``) on the card, on a
    Keypoint R-CNN forward's outputs for one image ([1, 100, 56, 56, 17]
    heatmaps and their boxes): ``device_keypoint_argmax`` on the card
    against the CPU on the same heatmaps; then ``finalize_predictions``
    from the card's decode against the host decode of the same heatmaps.
    The seeded head's heatmaps have many near-equal maxima, so the two
    grids pick far-apart ones often: that share is only logged, and the
    check runs on one-peak heatmaps at the forward's boxes."""
    from hnd_ghnd_tpu_torch.evals.postprocess import finalize_predictions
    from hnd_ghnd_tpu_torch.ops.kp_decode import device_keypoint_argmax
    (batch, _, host), dets = items[0], records[0]["dets"]
    sizes = tuple(host[0]["original_size"]), tuple(
        int(v) for v in batch["image_sizes"][0])
    hm = torch.from_numpy(dets["keypoint_logits"][:1]).to(dev)
    card = [t.cpu() for t in device_keypoint_argmax(hm, KP_GRID)]
    cpu = device_keypoint_argmax(hm.cpu(), KP_GRID)
    same = float(((card[0] == cpu[0]) & (card[1] == cpu[1])).double().mean())
    top = float(cpu[2].abs().max())
    score_err = float((card[2] - cpu[2]).abs().max())
    log(f"[runner] device_keypoint_argmax {tuple(hm.shape)} at grid "
        f"{KP_GRID}, card / CPU: same position {same:.4%} of the keypoints, "
        f"scores max abs err {score_err:.3e} (largest {top:.3e})")
    check(same >= KP_SAME_MIN and score_err <= KP_SCORE_TOL * top,
          f"device_keypoint_argmax on the card: {same} same, score err "
          f"{score_err}")
    oh, ow = sizes[0]
    ih, iw = sizes[1]

    def agreement(heatmaps: np.ndarray) -> tuple:
        u, v, score = device_keypoint_argmax(
            torch.from_numpy(heatmaps).to(dev), KP_GRID)
        base = {k: dets[k][:1] for k in ("boxes", "scores", "labels",
                                         "valid", "boxes_model")}
        want = finalize_predictions(dict(base, keypoint_logits=heatmaps), 0,
                                    *sizes)
        got = finalize_predictions(dict(
            base, kp_u=u.cpu().numpy(), kp_v=v.cpu().numpy(),
            kp_score=score.cpu().numpy()), 0, *sizes)
        bm = dets["boxes_model"][0][dets["valid"][0].astype(bool)]
        side = np.maximum(bm[:, 2:] - bm[:, :2], 1.0)           # [N, 2]
        big = (side >= 56).all(1)
        tol = (side / 56 + side / KP_GRID) * np.array([ow / iw, oh / ih])
        ok = np.abs(got["keypoints"][..., :2] - want["keypoints"][..., :2]) \
            <= tol[:, None, :]                                   # [N, K, 2]
        return (tuple(float(v) for v in ok.mean((0, 1))),
                tuple(float(v) for v in ok[big].mean((0, 1))), int(big.sum()))

    own, _, _ = agreement(dets["keypoint_logits"][:1])
    every, blobs, n_big = agreement(blob_heatmaps(
        np.random.RandomState(SEED + 15), hm.shape[1])[None])
    log(f"[runner] device decode on the card vs the host decode, share of "
        f"keypoints within one heatmap cell and one grid cell (x, y): "
        f"{blobs[0]:.4f}, {blobs[1]:.4f} on one-peak heatmaps at the "
        f"forward's {n_big} boxes of 56 pixels a side or more (bound "
        f"{KP_AGREE_MIN}; {every[0]:.4f}, {every[1]:.4f} at all its boxes); "
        f"{own[0]:.4f}, {own[1]:.4f} on the seeded head's own heatmaps at "
        "all its boxes (logged only)")
    check(n_big > 0 and min(blobs) > KP_AGREE_MIN,
          f"device vs host decode: {blobs} at {n_big} boxes")


def postproc_ab(coco_runner, cfg: dict, args, kind: str, iou: str) -> None:
    """``coco_runner.run``'s test eval at batch EVAL_BATCH (the pool works
    across a batch's images: at the test protocol's batch 1 it has one)
    with the host postprocess on one thread (HND_TPU_POSTPROC_THREADS=1)
    and on the default pool, in turns (one, pool, pool, one): the host's
    time (the images' finalize, COCOeval update, accumulate and summarize)
    each way.  cuDNN runs its deterministic algorithms here, so the stats
    must not move."""
    cfg = dict(cfg, test={"batch_size": EVAL_BATCH})
    runs = {}
    torch.backends.cudnn.deterministic = True
    for threads in ("1", None, None, "1"):
        if threads is None:
            os.environ.pop("HND_TPU_POSTPROC_THREADS", None)
        else:
            os.environ["HND_TPU_POSTPROC_THREADS"] = threads
        res = coco_runner.run(cfg, args)
        runs.setdefault(threads, []).append(res["test"])
    os.environ.pop("HND_TPU_POSTPROC_THREADS", None)
    torch.backends.cudnn.deterministic = False
    one, pool = runs["1"], runs[None]
    for r in one + pool:
        check(r["stats"] == one[0]["stats"], f"{kind}: the postprocess "
              "pool moved the stats")
    log(f"[runner] {kind} test eval at batch {EVAL_BATCH}, host "
        f"postprocess and COCOeval: one "
        f"thread " + " / ".join(f"{r['eval']['cocoeval_s']:.3f}" for r in one)
        + f" s, pool of {os.cpu_count()} threads " + " / ".join(
            f"{r['eval']['cocoeval_s']:.3f}" for r in pool)
        + f" s (in turns one, pool, pool, one); {iou} AP "
        f"{one[0]['stats'][iou][0]:.6f} both ways")


def runner_models(dev: torch.device):
    """The ResNet-50 teacher (seed SEED, live BNs, class logits x300) and
    the b3ch student whose all but ``layer1`` is the teacher's, as the zoo
    weights would give both."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    teacher = live_norms_(get_model(TEACHER_MODEL, seed=SEED, device=dev),
                          SEED)
    with torch.no_grad():
        teacher.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    student = live_norms_(get_model(STUDENT_MODEL, seed=SEED + 1,
                                    device=dev), SEED + 1)
    student.load_state_dict({k: v for k, v in teacher.state_dict().items()
                             if not k.startswith("backbone.body.layer1.")},
                            strict=False)
    return teacher, student


def epoch_report(tag: str, epoch: dict, steps: list) -> None:
    """Where an epoch's time went: the train loop (its loader wait, its
    ``steps`` on the card) and the val eval (its loader wait, forwards on
    the card, COCOeval on the host)."""
    train, ev = epoch["train"], epoch["eval"]
    wall = train["seconds"] + ev["seconds"]
    step_s = sum(s[3] for s in steps) / 1e3
    log(f"[{tag}] epoch: {wall:.3f} s = train loop {train['seconds']:.3f} s "
        f"(loader wait {train['loader_s']:.3f} s, steps on the card "
        f"{step_s:.3f} s) + val eval {ev['seconds']:.3f} s (loader wait "
        f"{ev['loader_s']:.3f} s, {ev['batches']} forwards "
        f"{ev['forward_ms'] / 1e3:.3f} s dispatch to host, COCOeval on the "
        f"host {ev['cocoeval_s']:.3f} s); loader share "
        f"{(train['loader_s'] + ev['loader_s']) / wall:.1%}; val mAP "
        f"{epoch['val_map']:.6f}, saved {epoch['saved']}")


def runner_phase(dev: torch.device, root: str) -> dict:
    """The port's main path through its entry points: ``mimic_runner.run``
    with the GHND b3ch config (its dataset block pointing at a fixture
    written here), -distill -transform_bottleneck, RUNNER_EPOCHS epochs, the
    stem switch on; then ``-test_only`` from the saved checkpoint; then
    ``coco_runner.run -train`` of the org model for one epoch of bfloat16
    steps on the fixture's own boxes; the same for the org Mask R-CNN (on
    the boxes' polygons) and Keypoint R-CNN (on a person-keypoint file of
    the same boxes), scored by COCOeval's segm and keypoints; then the test
    eval of a seeded Mask R-CNN and Keypoint R-CNN on annotations made from
    their own detections, the Keypoint R-CNN's with the host decode and
    with ``kp_decode: device`` (``kp_decode_checks`` on its forward).
    Returns each run's kernel launches ({"mimic", "coco", "mask_rcnn",
    "keypoint_rcnn"})."""
    from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import coco_runner, mimic_runner
    from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util
    t0 = time.perf_counter()
    fx = write_runner_fixture(root, np.random.RandomState(SEED + 10))

    def split(name, ann=None):
        img_dir, own = fx[name]
        return {"images": img_dir, "annotations": ann or own,
                "remove_non_annotated_imgs": name == "train",
                "jpeg_quality": None}

    teacher, student = runner_models(dev)
    ckpts = {}
    for name, model in (("teacher", teacher), ("student", student)):
        ckpts[name] = os.path.join(root, f"{name}.pt")
        params, state = jax_params_from_state_dict(model.state_dict())
        ckpt_util.save_ckpt(ckpts[name], params=params, state=state)
    del teacher, student
    config = {
        "dataset": {"name": "fixture", "num_workers": 4, "splits": {
            "train": split("train"), "val": split("val"),
            "test": split("val")}},
        "teacher_model": dict(TEACHER_MODEL, ckpt=ckpts["teacher"]),
        "student_model": dict(STUDENT_MODEL, ckpt=ckpts["student"]),
        "train": dict(TRAIN, num_epochs=RUNNER_EPOCHS),
        "test": {"batch_size": 1},
        "tpu": GHND_TPU,
    }
    gt = os.path.join(root, "instances_val_teacher.json")
    n_gt, _, _ = teacher_annotations(get_model(
        config["teacher_model"], seed=SEED, device=dev), config, gt)
    for name in ("val", "test"):
        config["dataset"]["splits"][name] = split("val", gt)
    log(f"[runner] fixture of {sum(RUNNER_IMAGES.values())} JPEGs and "
        f"{n_gt} teacher-made val annotations in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # -------------------------------------------- mimic_runner -distill
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    yaml_path = "config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml"
    args = mimic_runner.get_argparser().parse_args(
        ["--config", yaml_path, "--device", str(dev), "-distill",
         "-transform_bottleneck"])
    zero_kernel_counts()
    t0 = time.perf_counter()
    result = mimic_runner.run(config, args)
    wall = time.perf_counter() - t0
    mimic = kernel_counts()
    hist = result["distill"]
    n_steps = len(hist["steps"])
    n_val = sum(e["eval"]["batches"] for e in hist["epochs"])
    n_t, n_s = (result[k]["eval"]["batches"] for k in ("teacher", "student"))
    log(f"[runner] mimic_runner -distill -transform_bottleneck: {n_steps} "
        f"steps, {n_val} val batches, {n_t} + {n_s} test batches in "
        f"{wall:.3f} s; launches {mimic}")
    want = {"stem_fwd": n_steps + n_val + n_t + n_s, "stem_fwd_res": n_steps,
            "stem_dw": n_steps, "quantize": n_val + n_s,
            "dequantize": n_val + n_s, "roi_align": n_val + n_t + n_s}
    for k, n in want.items():
        check(mimic[k] == n, f"runner: {k} launched {mimic[k]} times, want {n}")
    check(n_steps == RUNNER_EPOCHS * RUNNER_IMAGES["train"] // TRAIN_BATCH,
          f"runner: {n_steps} steps")
    for idx, loss, terms, ms in hist["steps"]:
        check(np.isfinite(loss), f"runner step {idx}: loss {loss}")
        log(f"[runner] step {idx}: {ms:.3f} ms, loss {loss:.6e}")
    steady = [s[3] for s in hist["steps"][1:]]
    log(f"[runner] mimic_runner_distill_images_per_sec_per_chip "
        f"{TRAIN_BATCH * len(steady) / sum(steady) * 1e3:.4f} (CUDA events "
        f"of steps 1-{n_steps - 1}, step 0 excluded; median step "
        f"{statistics.median(steady):.3f} ms)")
    best = 0.0
    per_epoch = n_steps // RUNNER_EPOCHS
    for e, epoch in enumerate(hist["epochs"]):
        check(epoch["val_map"] == epoch["stats"]["bbox"][0],
              "the val mAP is not the evaluator's stats['bbox'][0]")
        check(epoch["saved"] == (epoch["val_map"] > best),
              "a checkpoint was written without a rise, or not on one")
        best = max(best, epoch["val_map"])
        epoch_report("runner", epoch,
                     hist["steps"][e * per_epoch:(e + 1) * per_epoch])
    check(any(e["saved"] for e in hist["epochs"]),
          "no epoch raised the val mAP above 0: no checkpoint")
    payload = ckpt_util.load_ckpt(ckpts["student"])
    last_save = max(i for i, e in enumerate(hist["epochs"]) if e["saved"])
    check(payload["best_value"] == best
          and payload["lr_step"] == (last_save + 1) * per_epoch
          and payload["torch_opt_state"]["state"],
          "the checkpoint is not the best epoch's")
    t_map = result["teacher"]["stats"]["bbox"][0]
    s_map = result["student"]["stats"]["bbox"][0]
    for who in ("teacher", "student"):
        ev = result[who]["eval"]
        log(f"[runner] test eval of the {who} (batch 1): "
            f"{ev['seconds']:.3f} s, {ev['batches']} forwards, COCOeval "
            f"{ev['cocoeval_s']:.3f} s; bbox stats "
            + " ".join(f"{v:.6f}" for v in result[who]["stats"]["bbox"]))
    check(t_map >= TEACHER_MAP_MIN, f"teacher test mAP {t_map} < "
          f"{TEACHER_MAP_MIN} on its own detections")
    check(0.0 <= s_map < t_map, f"student test mAP {s_map}")

    # -------------------------------------------- -test_only, same files
    args = mimic_runner.get_argparser().parse_args(
        ["--config", yaml_path, "--device", str(dev), "-test_only",
         "-transform_bottleneck"])
    again = mimic_runner.run(config, args)
    for who in ("teacher", "student"):
        check(again[who]["stats"] == result[who]["stats"],
              f"-test_only {who} stats differ from the distill run's")
    log("[runner] -test_only from the best checkpoint: the teacher's and "
        "the student's stats equal the distill run's (the final eval ran "
        "the reloaded best checkpoint)")
    torch.cuda.empty_cache()

    # -------------------------------------------- coco_runner -train
    os.environ["HND_TPU_PALLAS_STEM"] = "0"  # the stem kernels are f32 only
    own = split("val")
    org_config = {
        "dataset": {"name": "fixture", "num_workers": 4, "splits": {
            "train": own, "val": own, "test": own}},
        "model": dict(ORG_MODEL, ckpt=os.path.join(root, "org.pt")),
        "train": dict(ORG_TRAIN, num_epochs=1), "test": {"batch_size": 1},
        "tpu": ORG_TPU}
    args = coco_runner.get_argparser().parse_args(
        ["--config", "config/org/faster_rcnn-backbone_resnet50.yaml",
         "--device", str(dev), "-train"])
    zero_kernel_counts()
    t0 = time.perf_counter()
    org = coco_runner.run(org_config, args)
    wall = time.perf_counter() - t0
    coco = kernel_counts()
    (epoch,) = org["train"]["epochs"]
    n_steps = len(org["train"]["steps"])
    n_eval = epoch["eval"]["batches"] + org["test"]["eval"]["batches"]
    log(f"[runner] coco_runner -train: {n_steps} bfloat16 steps, {n_eval} "
        f"eval batches in {wall:.3f} s; launches {coco}")
    for idx, loss, terms, ms in org["train"]["steps"]:
        check(all(np.isfinite(v) for v in terms.values()),
              f"coco_runner step {idx}: {terms}")
        log(f"[runner] coco_runner step {idx}: {ms:.3f} ms, loss {loss:.6e}")
    check(n_steps == RUNNER_IMAGES["val"] // ORG_BATCH,
          f"coco_runner: {n_steps} steps")
    check(coco["roi_align_bf16"] == n_steps and coco["roi_align_bwd"] == n_steps
          and coco["roi_align"] == n_eval, f"coco_runner launches {coco}")
    epoch_report("runner coco", epoch, org["train"]["steps"])
    log(f"[runner] coco_runner test eval: bbox stats " + " ".join(
        f"{v:.6f}" for v in org["test"]["stats"]["bbox"]))
    torch.cuda.empty_cache()

    # ------------------------ coco_runner -train, Mask and Keypoint R-CNN
    kp_file = os.path.join(root, "person_keypoints_val.json")
    n_kp = write_keypoint_annotations(own["annotations"], kp_file,
                                      np.random.RandomState(SEED + 11))
    log(f"[runner] person-keypoint file: {n_kp} people with 17 visible "
        "keypoints each")
    heads = {}
    for kind, model_cfg, yaml_path, ann in (
            ("mask_rcnn", ORG_MASK_MODEL,
             "config/org/mask_rcnn-backbone_resnet50.yaml", own),
            ("keypoint_rcnn", ORG_KEYPOINT_MODEL,
             "config/org/keypoint_rcnn-backbone_resnet50.yaml",
             split("val", kp_file))):
        cfg = dict(org_config, dataset={
            "name": "fixture", "num_workers": 4,
            "splits": {"train": ann, "val": ann, "test": ann}},
            model=dict(model_cfg, ckpt=os.path.join(root, f"{kind}.pt")))
        args = coco_runner.get_argparser().parse_args(
            ["--config", yaml_path, "--device", str(dev), "-train"])
        zero_kernel_counts()
        t0 = time.perf_counter()
        res = coco_runner.run(cfg, args)
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        (epoch,) = res["train"]["epochs"]
        steps = res["train"]["steps"]
        n_eval = epoch["eval"]["batches"] + res["test"]["eval"]["batches"]
        iou = "segm" if kind == "mask_rcnn" else "keypoints"
        extra = "loss_mask" if kind == "mask_rcnn" else "loss_keypoint"
        log(f"[runner] coco_runner -train {kind}: {len(steps)} bfloat16 "
            f"steps, {n_eval} eval batches in {wall:.3f} s; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        for idx, loss, terms, ms in steps:
            check(len(terms) == 5 and extra in terms
                  and all(np.isfinite(v) for v in terms.values()),
                  f"coco_runner {kind} step {idx}: {terms}")
            log(f"[runner] coco_runner {kind} step {idx}: {ms:.3f} ms, loss "
                f"{loss:.6e}, {extra} {terms[extra]:.6e}")
        n = len(steps)
        check(n == RUNNER_IMAGES["val"] // ORG_BATCH,
              f"coco_runner {kind}: {n} steps")
        # the float32 eval pools twice a forward: 7x7 boxes, 14x14 heads
        want = {"roi_align_bf16": n, "roi_align_bf16_p14": n,
                "roi_align_bwd": n, "roi_align_bwd_p14": n,
                "roi_align": 2 * n_eval}
        check(all(counts[k] == v for k, v in want.items()),
              f"coco_runner {kind} launches {counts}, want {want}")
        for stats in (epoch["stats"], res["test"]["stats"]):
            check(set(stats) == {"bbox", iou}
                  and all(np.isfinite(v) for v in stats[iou]),
                  f"coco_runner {kind}: stats {stats}")
        epoch_report(f"runner {kind}", epoch, steps)
        ev = res["test"]["eval"]
        log(f"[runner] coco_runner {kind} test eval: {ev['seconds']:.3f} s, "
            f"{ev['batches']} forwards {ev['forward_ms'] / 1e3:.3f} s "
            f"dispatch to host, COCOeval and host postprocess "
            f"{ev['cocoeval_s']:.3f} s; {iou} stats " + " ".join(
                f"{v:.6f}" for v in res["test"]["stats"][iou]))
        heads[kind] = counts
        torch.cuda.empty_cache()

    # ------------- segm and keypoints on annotations the model can score
    # a seeded Mask or Keypoint R-CNN (class logits x300, as the teacher)
    # makes the val split's masks or keypoints; coco_runner's test eval of
    # its checkpoint then scores near 1 on them, and the Keypoint R-CNN's
    # again with kp_decode: device
    for kind, model_cfg, yaml_path, base in (
            ("mask_rcnn", ORG_MASK_MODEL,
             "config/org/mask_rcnn-backbone_resnet50.yaml", own),
            ("keypoint_rcnn", ORG_KEYPOINT_MODEL,
             "config/org/keypoint_rcnn-backbone_resnet50.yaml",
             split("val", kp_file))):
        scorer = live_norms_(get_model(model_cfg, seed=SEED + 14,
                                       device=dev), SEED + 14)
        with torch.no_grad():
            scorer.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
        path = os.path.join(root, f"{kind}_scorer.pt")
        params, state = jax_params_from_state_dict(scorer.state_dict())
        ckpt_util.save_ckpt(path, params=params, state=state)
        cfg = dict(org_config, dataset={
            "name": "fixture", "num_workers": 4,
            "splits": {"train": base, "val": base, "test": base}},
            model=dict(model_cfg, ckpt=path))
        gt = os.path.join(root, f"{kind}_scorer_val.json")
        n_gt, items, records = teacher_annotations(scorer, cfg, gt)
        del scorer
        iou = "segm" if kind == "mask_rcnn" else "keypoints"
        log(f"[runner] {kind}: {n_gt} val annotations from its own "
            f"detections ({iou})")
        if kind == "keypoint_rcnn":
            kp_decode_checks(dev, items, records)
        del items, records
        cfg["dataset"]["splits"] = {"train": base, "val": split("val", gt),
                                    "test": split("val", gt)}
        args = coco_runner.get_argparser().parse_args(
            ["--config", yaml_path, "--device", str(dev)])
        decodes = ("host", "device") if kind == "keypoint_rcnn" else (None,)
        for decode in decodes:
            if decode == "device":
                cfg["model"] = dict(cfg["model"], params=dict(
                    cfg["model"]["params"], kp_decode="device"))
            else:
                postproc_ab(coco_runner, cfg, args, kind, iou)
            res = coco_runner.run(cfg, args)
            ev, stats = res["test"]["eval"], res["test"]["stats"][iou]
            log(f"[runner] coco_runner {kind} test eval on its own "
                f"annotations" + (f", kp_decode {decode}" if decode else "")
                + f": {ev['seconds']:.3f} s, {ev['batches']} forwards "
                f"{ev['forward_ms'] / 1e3:.3f} s dispatch to host, COCOeval "
                f"and host postprocess {ev['cocoeval_s']:.3f} s; {iou} stats "
                + " ".join(f"{v:.6f}" for v in stats))
            # the device decode picks other maxima than the host's where
            # the seeded heatmaps have near-equal ones (kp_decode_checks)
            ok = stats[0] > 0.0 if decode == "device" else \
                stats[0] >= TEACHER_MAP_MIN
            check(np.isfinite(stats).all() and ok,
                  f"coco_runner {kind} ({decode}): {iou} AP {stats[0]}")
        torch.cuda.empty_cache()
    return {"mimic": mimic, "coco": coco, **heads}


def ext_operations(ext: torch.nn.Module, shape) -> float:
    """The filter's arithmetic on an input of ``shape`` [B, C, H, W]: one
    add an input element for the first pool, the convolutions' and the
    linear layer's multiply-adds (the pools' products multiply mostly by
    zero: the function needs only the adds)."""
    b, cin, _, _ = shape
    h, w = 64, 64
    ops = float(np.prod(shape))
    for m in ext.extractor:
        if isinstance(m, torch.nn.Conv2d):
            k, st = m.kernel_size[0], m.stride[0]
            h, w = (h - k) // st + 1, (w - k) // st + 1
            ops += 2.0 * b * m.out_channels * cin * k * k * h * w
            cin = m.out_channels
    return ops + 2.0 * b * ext.linear.in_features * ext.linear.out_features


def drop_every_second_image(ann_file: str, out_file: str) -> tuple:
    """``ann_file`` without the annotations of its even-numbered images,
    written to ``out_file``: (images, images keeping annotations)."""
    with open(ann_file) as f:
        coco = json.load(f)
    coco["annotations"] = [a for a in coco["annotations"]
                           if a["image_id"] % 2 == 1]
    with open(out_file, "w") as f:
        json.dump(coco, f)
    return (len(coco["images"]),
            len({a["image_id"] for a in coco["annotations"]}))


def ext_model_config(root: str) -> dict:
    """EXT_MODEL with the checkpoints ``ext_phase`` writes under
    ``root``/ext: the seeded student and the trained filter."""
    cfg = copy.deepcopy(EXT_MODEL)
    cfg["ckpt"] = os.path.join(root, "ext", "student.pt")
    cfg["backbone"]["ext_config"]["ckpt"] = os.path.join(root, "ext",
                                                         "ext.pt")
    return cfg


def ext_phase(dev: torch.device, root: str, card: str) -> dict:
    """The ext filter (ROADMAP A9) through its entry points: a COCO fixture
    of RUNNER_IMAGES JPEGs with person-keypoint files that keep every
    second image's people (two classes a split); ``ext_runner.run -train``
    of config/ext/keypoint_rcnn-backbone_ext_resnet50-b3ch.yaml's blocks for
    EXT_EPOCHS epochs at batch 2 with the stem switch on, its val ROC-AUC
    each epoch and the test threshold table at --min_recall 0.98; then
    ``coco_runner.run``'s test eval of the gated Keypoint R-CNN (the ext
    checkpoint just written, a seeded student with class logits x300 as
    ``model.ckpt``); then a served batch of 8 at both buckets with the
    bottleneck round trip, the gate at 1.1 (nothing valid, every score 0),
    at 0.0 (the ungated detections, bit for bit) and at the config's 0.01;
    the card's filter probabilities against the CPU's; the filter's time
    alone at batch 8 and 1 against its bound, and the gated forward
    against the ungated one.  Returns the kernels' launches of the two runs
    ({"ext_runner", "coco_ext"}; the latter with the gate checks' serve)."""
    from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
    from hnd_ghnd_tpu_torch.models.factory import build_model, get_model
    from hnd_ghnd_tpu_torch.models.rcnn import RCNN
    from hnd_ghnd_tpu_torch.runners import coco_runner, ext_runner
    from hnd_ghnd_tpu_torch.runners.common import eval_forward, evaluate
    from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util
    model_cfg = ext_model_config(root)
    root = os.path.join(root, "ext")
    fx = write_runner_fixture(root, np.random.RandomState(SEED + 20))
    rng = np.random.RandomState(SEED + 21)
    splits = {}
    for name, (img_dir, ann) in fx.items():
        kp = os.path.join(root, f"person_keypoints_{name}.json")
        write_keypoint_annotations(ann, kp, rng)
        half = os.path.join(root, f"ext_{name}.json")
        n, kept = drop_every_second_image(kp, half)
        log(f"[ext] {name}: {n} images, {kept} with people")
        splits[name] = {"images": img_dir, "annotations": half,
                        "remove_non_annotated_imgs": False,
                        "jpeg_quality": None}
    splits["test"] = splits["val"]
    student = live_norms_(get_model(dict(KEYPOINT_STUDENT_MODEL, ckpt=None),
                                    seed=SEED + 22, device=dev), SEED + 22)
    with torch.no_grad():
        student.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    params, state = jax_params_from_state_dict(student.state_dict())
    ckpt_util.save_ckpt(model_cfg["ckpt"], params=params, state=state)
    del student
    ext_ckpt = model_cfg["backbone"]["ext_config"]["ckpt"]
    config = {"dataset": {"name": "fixture", "num_workers": 4,
                          "splits": splits},
              "model": model_cfg,
              "train": dict(EXT_TRAIN, num_epochs=EXT_EPOCHS),
              "test": {"batch_size": 1}, "tpu": ORG_TPU}
    torch.cuda.empty_cache()

    # ------------------------------------------- ext_runner -train
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    args = ext_runner.get_argparser().parse_args(
        ["--config", EXT_YAML, "--device", str(dev), "-train",
         "--min_recall", "0.98"])
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = ext_runner.run(config, args)
    wall = time.perf_counter() - t0
    ext_launches = kernel_counts()
    hist, test = res["train"], res["test"]
    steps = hist["steps"]
    n_val = sum(e["eval"]["batches"] for e in hist["epochs"])
    log(f"[ext] ext_runner -train: {len(steps)} float32 steps, {n_val} val "
        f"and {test['batches']} test batches in {wall:.3f} s; launches "
        f"{ {k: v for k, v in ext_launches.items() if v} }")
    want = len(steps) + n_val + test["batches"]
    check(ext_launches["stem_fwd"] == want,
          f"ext_runner: stem_fwd launched {ext_launches['stem_fwd']} times, "
          f"want {want}")
    check(len(steps) == EXT_EPOCHS * RUNNER_IMAGES["train"] // EXT_TRAIN[
        "batch_size"], f"ext_runner: {len(steps)} steps")
    for idx, loss, _, ms in steps:
        check(np.isfinite(loss), f"ext step {idx}: loss {loss}")
    per_epoch = len(steps) // EXT_EPOCHS
    for e, epoch in enumerate(hist["epochs"]):
        tr, ev = epoch["train"], epoch["eval"]
        ep_steps = steps[e * per_epoch:(e + 1) * per_epoch]
        step_s = sum(s[3] for s in ep_steps) / 1e3
        acc, recall, spec, auc = epoch["val"]
        wall = tr["seconds"] + ev["seconds"]
        log(f"[ext] {card}: epoch {e}: {wall:.3f} s = train loop "
            f"{tr['seconds']:.3f} s ({tr['batches']} steps; loader wait "
            f"{tr['loader_s']:.3f} s, steps on the card {step_s:.3f} s) + "
            f"val {ev['seconds']:.3f} s ({ev['batches']} batches; loader "
            f"wait {ev['loader_s']:.3f} s); loader share "
            f"{(tr['loader_s'] + ev['loader_s']) / wall:.1%}; val accuracy "
            f"{acc:.4f} recall {recall:.4f} specificity {spec:.4f} ROC-AUC "
            f"{auc:.6f}, saved {epoch['saved']}")
        check(0.0 <= auc <= 1.0, f"epoch {e}: val ROC-AUC {auc} (two "
              "classes: it must be defined)")
    steady = [s[3] for s in steps[1:]]
    log(f"[ext] {card}: train {EXT_TRAIN['batch_size'] * len(steady) / sum(steady) * 1e3:.4f} "
        f"img/s (CUDA events of steps 1-{len(steps) - 1}; median step "
        f"{statistics.median(steady):.3f} ms)")
    check(any(e["saved"] for e in hist["epochs"])
          and ckpt_util.check_if_exists(ext_ckpt), "no ext checkpoint")
    best = max(e["val"][3] for e in hist["epochs"])
    check(ckpt_util.load_ckpt(ext_ckpt)["best_value"] == best,
          "the ext checkpoint is not the best epoch's")
    log(f"[ext] {card}: test (best checkpoint, {test['n']} images): accuracy "
        f"{test['scores'][0]:.4f} recall {test['scores'][1]:.4f} "
        f"specificity {test['scores'][2]:.4f} ROC-AUC "
        f"{test['scores'][3]:.6f}; operating points with recall >= 0.98 "
        "(threshold, tpr, fpr): " + ", ".join(
            f"({t:.6f}, {r:.6f}, {f:.6f})" for t, r, f in test["table"]))
    check(len(test["table"]) > 0, "no threshold table")
    torch.cuda.empty_cache()

    # ------------------------------ the gated Keypoint R-CNN's test eval
    os.environ["HND_TPU_PALLAS_STEM"] = "0"  # the serving path's default
    args = coco_runner.get_argparser().parse_args(
        ["--config", EXT_YAML, "--device", str(dev), "-test_only"])
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = coco_runner.run(config, args)
    wall = time.perf_counter() - t0
    ev, stats = res["test"]["eval"], res["test"]["stats"]
    log(f"[ext] coco_runner -test_only, gated Keypoint R-CNN: {wall:.3f} s, "
        f"{ev['batches']} forwards {ev['forward_ms'] / 1e3:.3f} s dispatch "
        f"to host, COCOeval and host postprocess {ev['cocoeval_s']:.3f} s; "
        "keypoints stats " + " ".join(f"{v:.6f}" for v in stats["keypoints"]))
    check(set(stats) == {"bbox", "keypoints"}
          and all(np.isfinite(v) for v in stats["keypoints"]),
          f"gated eval stats {stats}")

    # ------------------------------------- the gate on served batches
    model = get_model(config["model"], device=dev).requires_grad_(False)
    check(model.ext_threshold == 0.01, "the config's threshold")
    served = serving_batches(np.random.RandomState(SEED + 23))[:2]
    runs = {}
    # cuDNN's transposed convolution (the keypoint predictor) may pick a
    # nondeterministic algorithm: two forwards of the same batch then
    # differ in its logits' last bits, whatever the gate
    torch.backends.cudnn.deterministic = True
    for thr in (None, 1.1, 0.0, 0.01):
        model.ext_threshold = thr
        runs[thr] = [r["dets"] for r in evaluate(model, served, True)]
    torch.backends.cudnn.deterministic = False
    coco_launches = kernel_counts()
    for k in ("roi_align", "quantize", "dequantize"):
        check(coco_launches[k] > 0, f"coco_ext: {k} never launched")
    for batch, gated, ungated, passed in zip(served, runs[1.1], runs[None],
                                             runs[0.01]):
        shape = tuple(batch["images"].shape)
        check(not gated["valid"].any() and gated["scores"].max() == 0.0,
              f"gate 1.1 {shape}: a detection survived")
        probs = passed["ext_logits"][:, 1]
        keep = probs >= 0.01
        check(np.array_equal(passed["valid"], ungated["valid"]
                             & keep[:, None]), f"gate 0.01 {shape}: valid")
        log(f"[ext] gate on {shape}: 1.1 leaves 0 of "
            f"{int(ungated['valid'].sum())} detections; 0.01 passes "
            f"{int(keep.sum())} of {len(keep)} images (P(valid) "
            f"{np.round(probs, 6).tolist()})")
    for zero, ungated in zip(runs[0.0], runs[None]):
        for k, v in ungated.items():
            check(np.array_equal(zero[k], v), f"gate 0.0: {k} differs from "
                  "the ungated forward")
    log("[ext] gate 0.0: detections identical to the ungated forward on "
        "both buckets")

    # ------------------------------------------ card vs CPU, and times
    model.ext_threshold = 0.01
    cpu = build_model(config["model"]).requires_grad_(False).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    images = torch.from_numpy(served[0]["images"]).float() \
        * torch.tensor(1.0 / 255.0)
    with torch.no_grad():
        got = model({"images": images.to(dev)}, ext_training=True).cpu()
        want = cpu({"images": images}, ext_training=True)
    err = float((got - want).abs().max())
    log(f"[ext] filter probabilities {tuple(got.shape)}, card vs CPU: max abs "
        f"err {err:.3e} (bound {EXT_PROB_TOL})")
    check(err <= EXT_PROB_TOL, f"filter probabilities card vs CPU: {err}")
    del cpu
    body = model.backbone.body
    encoder = body.layer1.encoder
    ext = encoder.ext_classifier
    for b in (EVAL_BATCH, 1):
        with torch.no_grad():
            x = body.stem(RCNN.normalize(images[:b].to(dev)))
            t = timings(lambda: ext(x))
        lim = bound(nbytes(x), ext_operations(ext, tuple(x.shape)))
        log(f"[ext] {card}: filter alone at batch {b} on "
            f"{tuple(x.shape)}: {t['ms']:.4f} ms ({t['device_ms']:.4f} on "
            f"the card); bound {lim['bound_ms']:.4f} ms by "
            f"{lim['bound_by']} (its input read once, "
            f"{nbytes(x) / 1e6:.1f} MB)")
    # the ungated forward runs without the filter; in turns
    batch = {k: torch.from_numpy(v).to(dev) for k, v in served[0].items()}
    fwd = {}
    for gated in (False, True, True, False):
        encoder.ext_classifier = ext if gated else None
        model.ext_threshold = 0.01 if gated else None
        fwd.setdefault(gated, []).append(time_ms(
            lambda: eval_forward(model, batch, True)))
    encoder.ext_classifier = ext
    log(f"[ext] {card}: Keypoint R-CNN forward of batch {EVAL_BATCH} at "
        f"{tuple(served[0]['images'].shape[1:3])} with the bottleneck round "
        f"trip, in turns (ungated, gated, gated, ungated): without the "
        f"filter {fwd[False][0]:.3f} / {fwd[False][1]:.3f} ms, gated "
        f"{fwd[True][0]:.3f} / {fwd[True][1]:.3f} ms")
    del model, x, batch
    torch.cuda.empty_cache()
    return {"ext_runner": ext_launches, "coco_ext": coco_launches}


def wire_body(wire: bytes) -> int:
    """Bytes of a split wire's tensor (its header and metadata left out)."""
    from hnd_ghnd_tpu_torch.split.deploy import unpack_wire
    return unpack_wire(wire).tensor.nbytes


def split_phase(dev: torch.device, root: str, card: str) -> dict:
    """The split deployment (ROADMAP A10) at full width, with the stem
    switch on: the serving phase's b3ch student, head -> ``pack_wire`` ->
    bytes -> ``unpack_wire`` -> tail at batch 1 on each image of a serving
    batch of each bucket and at batch EVAL_BATCH on one, the detections
    equal to ``evaluate``'s with the bottleneck round trip (deterministic
    cuDNN), the wire's body B x 212 x 340 x 3 bytes at 832x1344, the 16-bit
    wire twice that and its detections equal to the 16-bit round trip's;
    the gated Keypoint R-CNN of ``ext_phase`` stopping a batch of one at
    threshold 1.1 and sending it at 0.0; ``cost_analyzer.run`` on
    ``runner_phase``'s fixture and distilled student (-model_params
    --modules backbone.body.layer1 --data_size -resized --bottleneck_size
    --split_model), its split mAP equal to ``coco_evaluate``'s with the
    round trip; ``visualizer.run`` on VIZ_IMAGES of its JPEGs; the head's
    and tail's times at the SPLIT_TIMED_BATCHES beside the full
    forward's.  Returns the kernels' launches of the split runs."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import cost_analyzer, visualizer
    from hnd_ghnd_tpu_torch.runners.common import (coco_evaluate,
                                                   eval_forward, evaluate,
                                                   loaders_from_config,
                                                   to_device)
    from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN, unpack_wire
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    model = serving_model(dev)
    served = serving_batches(np.random.RandomState(SEED + 30))[:2]
    split = SplitRCNN(model, 8)
    head, tail, (head_sd, tail_sd) = split.build()
    check(not set(head_sd) & set(tail_sd)
          and set(head_sd) | set(tail_sd) == set(model.state_dict()),
          "the head and tail entries are not a partition of the state_dict")

    def one_image(batch, i):
        return {k: v[i:i + 1] for k, v in batch.items()}

    def serve(sp, head_call, tail_call, batch):
        wire = sp.run_edge(head_call, batch["images"], batch["image_sizes"],
                           batch["original_sizes"])
        return wire, sp.run_server(tail_call, wire,
                                   tuple(batch["images"].shape[1:3]))

    torch.backends.cudnn.deterministic = True
    zero_kernel_counts()
    t0 = time.perf_counter()
    runs = [(one_image(batch, i),
             *serve(split, head, tail, one_image(batch, i)))
            for batch in served for i in range(batch["images"].shape[0])]
    runs.append((served[0], *serve(split, head, tail, served[0])))
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    log(f"[split] {len(runs)} head -> bytes -> tail runs in {wall:.3f} s; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    for k in ("quantize", "dequantize", "roi_align", "stem_fwd"):
        check(launches[k] == len(runs), f"split: {k} launched "
              f"{launches[k]} times for {len(runs)} runs")
    for batch, wire, dets in runs:
        (rec,) = evaluate(model, [batch], use_bottleneck_transformer=True)
        shape = tuple(batch["images"].shape)
        check(set(dets) == set(rec["dets"]), f"split {shape}: keys")
        for k, v in rec["dets"].items():
            check(np.array_equal(dets[k], v), f"split {shape}: {k} differs "
                  "from the full forward with the round trip")
        b, h, w = shape[:3]
        check(wire_body(wire) == b * (h // 4 + 4) * (w // 4 + 4) * 3,
              f"split {shape}: wire body {wire_body(wire)} bytes")
    log(f"[split] detections of all {len(runs)} runs equal the full "
        "forward's with the 8-bit round trip; wire body "
        f"{wire_body(runs[-1][1])} bytes at {tuple(served[0]['images'].shape)}")
    split16 = SplitRCNN(model, 16)
    head16, tail16, _ = split16.build()
    wire16, dets16 = serve(split16, head16, tail16, served[0])
    check(wire_body(wire16) == 2 * wire_body(runs[-1][1]),
          "the 16-bit wire is not twice the 8-bit one")
    check(unpack_wire(wire16).tensor.dtype == np.float16, "16-bit wire dtype")
    model.backbone.body.layer1.quant_bits = 16
    (rec,) = evaluate(model, [served[0]], use_bottleneck_transformer=True)
    model.backbone.body.layer1.quant_bits = 8
    for k, v in rec["dets"].items():
        check(np.array_equal(dets16[k], v), f"16-bit split: {k} differs "
              "from the full forward with the 16-bit round trip")
    log(f"[split] 16-bit wire: {wire_body(wire16)} body bytes, detections "
        "equal the full forward's with the 16-bit round trip")
    torch.backends.cudnn.deterministic = False

    # --------------------------------------------------------- times
    for b in SPLIT_TIMED_BATCHES:
        batch = served[0] if b == EVAL_BATCH else one_image(served[0], 0)
        bucket = tuple(batch["images"].shape[1:3])
        images = torch.from_numpy(batch["images"]).to(dev)
        sizes = torch.from_numpy(batch["image_sizes"]).to(dev)
        head_ms = time_ms(lambda: split.head_fn(images))
        q, scale, zp, _ = split.head_fn(images)
        tail_ms = time_ms(lambda: split.tail_fn(q, scale, zp, sizes, bucket))
        on_dev = to_device(batch, dev)
        full_ms = time_ms(lambda: eval_forward(model, on_dev, True))
        walls = {"head": [], "tail": []}
        for _ in range(REPS):
            t0 = time.perf_counter()
            wire = split.run_edge(head, batch["images"], batch["image_sizes"],
                                  batch["original_sizes"])
            t1 = time.perf_counter()
            split.run_server(tail, wire, bucket)
            walls["head"].append((t1 - t0) * 1e3)
            walls["tail"].append((time.perf_counter() - t1) * 1e3)
        wire16 = split16.run_edge(head16, batch["images"],
                                  batch["image_sizes"],
                                  batch["original_sizes"])
        log(f"[split] {card}: batch {b} at {bucket}: head {head_ms:.3f} ms "
            f"(CUDA events, median of {REPS}), "
            f"{statistics.median(walls['head']):.3f} ms wall from host "
            f"pixels to packed bytes; tail {tail_ms:.3f} ms (CUDA events), "
            f"{statistics.median(walls['tail']):.3f} ms wall from bytes to "
            f"host detections; the full forward with the round trip "
            f"{full_ms:.3f} ms (CUDA events); wire {len(wire) / 1024:.2f} "
            f"KB at 8 bits, {len(wire16) / 1024:.2f} KB at 16 bits")
    del model, runs, q, images, on_dev
    torch.cuda.empty_cache()

    # ------------------------------------ the gated Keypoint R-CNN's edge
    gated = get_model(ext_model_config(root), device=dev).requires_grad_(False)
    ext_split = SplitRCNN(gated, 8)
    ext_head, _, _ = ext_split.build()
    one = one_image(served[0], 0)
    args = (one["images"], one["image_sizes"], one["original_sizes"])
    check(ext_split.run_edge(ext_head, *args, ext_threshold=1.1) is None,
          "the ext filter did not stop a batch of one at 1.1")
    wire = ext_split.run_edge(ext_head, *args, ext_threshold=0.0)
    check(isinstance(wire, bytes)
          and unpack_wire(wire).ext_logits is not None,
          "the ext filter stopped a batch of one at 0.0")
    check(ext_split.run_edge(ext_head, served[0]["images"],
                             served[0]["image_sizes"],
                             served[0]["original_sizes"],
                             ext_threshold=1.1) is not None,
          f"the ext filter stopped a batch of {EVAL_BATCH}")
    log(f"[split] gated Keypoint R-CNN edge: batch 1 stopped at 1.1, sent "
        f"at 0.0 ({len(wire)} bytes, P(something) "
        f"{float(unpack_wire(wire).ext_logits[0, 1]):.6f}); batch "
        f"{EVAL_BATCH} sent at 1.1")
    del gated
    torch.cuda.empty_cache()

    # ------------------------- cost_analyzer and visualizer, the fixture
    val = {"images": os.path.join(root, "val"),
           "annotations": os.path.join(root, "instances_val_teacher.json"),
           "remove_non_annotated_imgs": False, "jpeg_quality": None}
    config = {"dataset": {"name": "fixture", "num_workers": 4,
                          "splits": {k: val for k in ("train", "val",
                                                      "test")}},
              "student_model": dict(STUDENT_MODEL, ckpt=os.path.join(
                  root, "student.pt")),
              "test": {"batch_size": 1}, "tpu": GHND_TPU}
    yaml_path = "config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml"
    args = cost_analyzer.get_argparser().parse_args(
        ["--config", yaml_path, "--device", str(dev), "-model_params",
         "--modules", "backbone.body.layer1", "--data_size", "-resized",
         "--bottleneck_size", "--split_model"])
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    res = cost_analyzer.run(config, args)
    wall = time.perf_counter() - t0
    student = get_model(config["student_model"], device=dev)
    _, _, test_loader = loaders_from_config(config, student.kind, 1)
    ev, _ = coco_evaluate(student, test_loader, True)
    torch.backends.cudnn.deterministic = False
    got = res["split_model"]["evaluator"].stats["bbox"]
    check(np.array_equal(got, ev.stats["bbox"]),
          f"cost_analyzer's split stats {got} differ from the round trip "
          f"eval's {ev.stats['bbox']}")
    counts = res["model_params"]
    check(counts["head"] + counts["tail"] == counts["total"],
          "head and tail parameters do not add up")
    shapes = res["bottleneck_size"].get_data()[3]
    check(shapes and all(s[0] == 3 for s in shapes),
          f"bottleneck shapes {shapes}")
    log(f"[split] cost_analyzer on the fixture in {wall:.3f} s: "
        f"parameters head {counts['head']:,} tail {counts['tail']:,} "
        f"layer1 {counts['backbone.body.layer1']:,}; split mAP "
        f"{got[0]:.6f} = the round trip eval's; head "
        f"{np.median(res['split_model']['head_s']) * 1e3:.3f} ms, tail "
        f"{np.median(res['split_model']['tail_s']) * 1e3:.3f} ms wall "
        f"(medians at batch 1); wire "
        f"{np.mean(res['split_model']['wire_kb']):.2f} KB")
    del student
    images = sorted(os.listdir(val["images"]))[:VIZ_IMAGES]
    out_dir = os.path.join(root, "viz")
    args = visualizer.get_argparser().parse_args(
        ["--config", yaml_path, "--device", str(dev), "--output", out_dir,
         "--score_threshold", "0.5", "--image"]
        + [os.path.join(val["images"], f) for f in images])
    written = visualizer.run(config, args)
    check(sorted(os.listdir(out_dir)) == images
          and len(written) == VIZ_IMAGES, f"visualizer wrote {written}")
    log(f"[split] visualizer wrote {len(written)} overlays")
    torch.cuda.empty_cache()
    os.environ["HND_TPU_PALLAS_STEM"] = "0"
    return launches


def serve_artifacts(spec_path: str) -> int:
    """The child of ``export_phase``: on the JSON spec's "device", loads
    each split artifact of its "items" ({"artifact", "inputs", "outputs",
    "reps"}) with ``load_exported`` and builds no model; runs head and tail on each input
    batch (a saved list of {"images" float32 [B, H, W, 3] in [0, 1],
    "image_sizes"}), saving their outputs; counts the kernels' launches of
    each head -> tail, and with ``reps`` times the tail (CUDA events; wall
    to host detections).  Writes its report to ``spec_path``.out.json."""
    from hnd_ghnd_tpu_torch.runners.common import configure_precision
    from hnd_ghnd_tpu_torch.split.export import (ExportedSplitSet,
                                                 load_exported)
    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    configure_precision(torch.float32)
    torch.backends.cudnn.deterministic = True
    report = []
    for item in spec["items"]:
        t0 = time.perf_counter()
        with open(item["artifact"], "rb") as f:
            art = load_exported(f.read())
        load_s = time.perf_counter() - t0
        outs, runs = [], []
        for batch in torch.load(item["inputs"]):
            images = batch["images"].to(dev)
            sizes = batch["image_sizes"].to(dev)
            bucket = tuple(images.shape[1:3])
            one = (art.for_bucket(bucket) if isinstance(art, ExportedSplitSet)
                   else art)
            zero_kernel_counts()
            head = one.head(images)
            dets = one.tail(*head[:3], sizes)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            run = {"bucket": bucket, "batch": int(images.shape[0]),
                   "launches": {k: v for k, v in kernel_counts().items()
                                if v}}
            outs.append({"head": [t.cpu() for t in head],
                         "tail": {k: v.cpu() for k, v in dets.items()}})
            if item["reps"]:
                run["tail_ms"] = time_ms(lambda: one.tail(*head[:3], sizes))
                walls = []
                for _ in range(item["reps"]):
                    t1 = time.perf_counter()
                    {k: v.cpu() for k, v in one.tail(*head[:3],
                                                     sizes).items()}
                    walls.append((time.perf_counter() - t1) * 1e3)
                run["tail_wall_ms"] = statistics.median(walls)
            runs.append(run)
        torch.save(outs, item["outputs"])
        report.append({"artifact": item["artifact"], "load_s": load_s,
                       "type": type(art).__name__, "runs": runs})
    with open(spec_path + ".out.json", "w") as f:
        json.dump(report, f)
    return 0


def export_phase(dev: torch.device, root: str, card: str) -> dict:
    """Ahead-of-time export of the split (ROADMAP A13), with the stem
    switch on: the serving phase's b3ch Faster student as the bucket set
    of both buckets at batch EVAL_BATCH and as 832x1344 at batch 1; the
    gated Keypoint R-CNN of ``ext_phase`` with int8_roi_pool on at batch 1.
    A child process that builds no model (``serve_artifacts``) loads each
    artifact and runs its head and tail on the serving batches: their
    outputs equal the eager ``SplitRCNN``'s bit for bit (deterministic
    cuDNN), and the kernels launch inside the artifacts.  Then the sharded
    tail as two shards on the one card (each its own edge's scale), equal
    to the eager tail per shard, and one device refused; and the CLI
    (``python -m hnd_ghnd_tpu_torch.split.export``) once, on the runner
    phase's distilled student.  Returns the launches inside the Faster
    artifacts."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute
    from hnd_ghnd_tpu_torch.split import export
    from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    out_dir = os.path.join(root, "export")
    os.makedirs(out_dir, exist_ok=True)
    model = serving_model(dev)
    gated_cfg = ext_model_config(root)
    gated_cfg = dict(gated_cfg, params=dict(gated_cfg["params"],
                                            int8_roi_pool=True))
    gated = get_model(gated_cfg, device=dev).requires_grad_(False)
    served = serving_batches(np.random.RandomState(SEED + 40))

    def inputs(batch):
        return {"images": images_to_compute(torch.from_numpy(
                    batch["images"]), torch.float32),
                "image_sizes": torch.from_numpy(batch["image_sizes"])}

    torch.backends.cudnn.deterministic = True
    cases = (("faster_set", model, "set", served[:2], SPLIT_TIMED_REPS),
             ("faster_b1", model, BUCKETS[0], served[2:], SPLIT_TIMED_REPS),
             ("keypoint_b1", gated, BUCKETS[0], served[2:], 0))
    spec, facts = [], {}
    for name, m, bucket, batches, reps in cases:
        t0 = time.perf_counter()
        blob = (export.export_split_set(m, BUCKETS, EVAL_BATCH)
                if bucket == "set" else
                export.export_split(m, bucket, batches[0]["images"].shape[0]))
        facts[name] = {"export_s": time.perf_counter() - t0,
                       "bytes": len(blob)}
        path = os.path.join(out_dir, f"{name}.hgsplit")
        with open(path, "wb") as f:
            f.write(blob)
        torch.save([inputs(b) for b in batches],
                   os.path.join(out_dir, f"{name}.in.pt"))
        spec.append({"artifact": path, "reps": reps,
                     "inputs": os.path.join(out_dir, f"{name}.in.pt"),
                     "outputs": os.path.join(out_dir, f"{name}.out.pt")})
        log(f"[export] {name}: exported in {facts[name]['export_s']:.1f} s, "
            f"{len(blob):,} bytes")
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"device": str(dev), "items": spec}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.serve_artifacts(sys.argv[1]))", spec_path],
        cwd=here, timeout=600)
    check(child.returncode == 0, f"the artifacts' child process exited "
          f"{child.returncode}")
    with open(spec_path + ".out.json") as f:
        report = json.load(f)
    log(f"[export] the child loaded and ran the artifacts in "
        f"{time.perf_counter() - t0:.1f} s (loads "
        f"{[round(r['load_s'], 1) for r in report]} s)")
    launches = {}
    for (name, m, _, batches, _), item, rep in zip(cases, spec, report):
        split = SplitRCNN(m, 8)
        for batch, got, run in zip(batches, torch.load(item["outputs"]),
                                   rep["runs"]):
            x = inputs(batch)
            images = x["images"].to(dev)
            sizes = x["image_sizes"].to(dev)
            bucket = tuple(images.shape[1:3])
            head = split.head_fn(images)
            dets = split.tail_fn(*head[:3], sizes, bucket)
            for i, (g, w) in enumerate(zip(got["head"], head)):
                check(g.dtype == w.dtype and torch.equal(g, w.cpu()),
                      f"export {name} {bucket}: head output {i} differs "
                      "from the eager head")
            check(set(got["tail"]) == set(dets), f"export {name}: tail keys")
            for k, v in dets.items():
                check(torch.equal(got["tail"][k], v.cpu()),
                      f"export {name} {bucket}: tail {k} differs from the "
                      "eager tail")
            want = ({"quantize": 1, "dequantize": 1, "stem_fwd": 1,
                     "nms_keep": 6}
                    | ({"quantize_levels": 1, "roi_align_int8": 2}
                       if name.startswith("keypoint") else {"roi_align": 1}))
            for k, n in want.items():
                check(run["launches"].get(k) == n, f"export {name}: {k} "
                      f"launched {run['launches'].get(k)} times inside the "
                      f"artifact, not {n}")
            for k, n in run["launches"].items():
                launches[k] = launches.get(k, 0) + n * name.startswith(
                    "faster")
            line = (f"[export] {name} {bucket} batch {run['batch']}: head and "
                    f"tail equal the eager split's; launches inside "
                    f"{run['launches']}")
            if "tail_ms" in run:
                eager_ms = time_ms(lambda: split.tail_fn(*head[:3], sizes,
                                                         bucket))
                walls = []
                for _ in range(SPLIT_TIMED_REPS):
                    t1 = time.perf_counter()
                    {k: v.cpu() for k, v in split.tail_fn(
                        *head[:3], sizes, bucket).items()}
                    walls.append((time.perf_counter() - t1) * 1e3)
                line += (f"; {card}: tail exported {run['tail_ms']:.3f} ms "
                         f"(CUDA events), {run['tail_wall_ms']:.3f} ms wall "
                         f"to host detections; eager {eager_ms:.3f} ms, "
                         f"{statistics.median(walls):.3f} ms wall (medians "
                         f"of {REPS} and {SPLIT_TIMED_REPS})")
            log(line)
        if name.startswith("keypoint"):
            check("keypoint_logits" in got["tail"] and float(
                got["head"][3][0, 1]) == float(head[3][0, 1].cpu()),
                "export keypoint_b1: ext output or keypoints missing")
    del gated
    torch.cuda.empty_cache()

    # ---------------------------- two shards on the one card, and the CLI
    one = served[2]
    images = inputs(served[0])["images"][:2].to(dev)
    sizes = torch.from_numpy(served[0]["image_sizes"][:2]).to(dev)
    split = SplitRCNN(model, 8)
    packets = [split.head_fn(images[i:i + 1]) for i in range(2)]
    t0 = time.perf_counter()
    sharded = export.load_exported(export.export_sharded_tail(
        model, BUCKETS[0], [dev, dev], batch_per_shard=1))
    zero_kernel_counts()
    both = sharded.call([dev, dev], torch.cat([p[0] for p in packets]),
                        torch.stack([p[1] for p in packets]),
                        torch.stack([p[2] for p in packets]), sizes)
    torch.cuda.synchronize()
    shard_launches = {k: v for k, v in kernel_counts().items() if v}
    for i, p in enumerate(packets):
        ref = split.tail_fn(*p[:3], sizes[i:i + 1], BUCKETS[0])
        for k, v in ref.items():
            check(torch.equal(both[k][i:i + 1], v), f"sharded tail shard "
                  f"{i}: {k} differs from the eager tail on its packet")
    try:
        sharded.call([dev], torch.cat([p[0] for p in packets]),
                     torch.stack([p[1] for p in packets]),
                     torch.stack([p[2] for p in packets]), sizes)
        refused = False
    except ValueError as e:
        refused = "exported for 2 devices" in str(e)
    check(refused, "the sharded tail took one device for two shards")
    check(shard_launches.get("nms_keep") == 12
          and shard_launches.get("dequantize") == 2,
          f"sharded tail launches {shard_launches}")
    log(f"[export] sharded tail, 2 shards of 1 image on {dev} (scales "
        f"{float(packets[0][1]):.6g} and {float(packets[1][1]):.6g}): each "
        f"shard equals the eager tail on its packet; one device refused; "
        f"launches {shard_launches}; {time.perf_counter() - t0:.1f} s")
    del model, sharded, both
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False

    if importlib.util.find_spec("yaml") is None:
        log("[export] no yaml here: the CLI's config cannot be read; CLI "
            "not run")
    else:
        cli_out = os.path.join(out_dir, "cli.hgsplit")
        override = json.dumps({"student_model": {
            "ckpt": os.path.join(root, "student.pt")}})
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "hnd_ghnd_tpu_torch.split.export",
             "--config", GHND_YAML, "--json", override, "--out", cli_out,
             "--bucket", ",".join(map(str, BUCKETS[0])), "--batch", "1",
             "--device", str(dev)],
            cwd=here, capture_output=True, text=True, timeout=600)
        check(cli.returncode == 0, f"the export CLI exited {cli.returncode}:"
              f"\n{cli.stdout}\n{cli.stderr}")
        with open(cli_out, "rb") as f:
            art = export.load_exported(f.read())
        x = inputs(one)
        head = art.head(x["images"])
        dets = art.tail(*head[:3], x["image_sizes"])
        check(art.device_type == dev.type and art.fused_stem
              and tuple(dets["boxes"].shape) == (1, 100, 4)
              and bool(torch.isfinite(dets["boxes"]).all()),
              "the CLI's artifact")
        log(f"[export] CLI in {time.perf_counter() - t0:.1f} s: "
            f"{cli.stdout.strip().splitlines()[-1]}; its artifact runs "
            f"({int(dets['valid'].sum())} detections)")
        del art
    torch.cuda.empty_cache()
    os.environ["HND_TPU_PALLAS_STEM"] = "0"
    return launches


def wire_tensor(p, device: torch.device) -> torch.Tensor:
    """A packet's 8-bit wire dequantized on ``device`` (the kernel on the
    card, the plain version on the CPU), NHWC float32."""
    from hnd_ghnd_tpu_torch.codec.quantizer import QuantizedTensor
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    return QK.dequantize(QuantizedTensor(
        torch.from_numpy(p.tensor.copy()).to(device),
        torch.tensor(p.scale, dtype=torch.float32, device=device),
        torch.tensor(p.zero_point, dtype=torch.float32, device=device)))


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def int8_tail_phase(dev: torch.device, root: str, card: str) -> dict:
    """The int8 server tail (ROADMAP A11) at full width on the serving
    phase's b3ch student (live BNs, class logits x300): calibrated on
    INT8_CALIB_IMAGES served images; head -> bytes -> int8 tail at batch
    EVAL_BATCH on a served batch of each bucket and at batch 1 on one image
    of each, its detections with the float tail's keys and shapes, finite;
    each stage output's cosine with the float folded walk above
    INT8_COS_MIN on both batch-8 wires; the same wire (an INT8_CPU_SHAPE
    image) through the card's int8 walk and the CPU's, the codes of all 44
    sites identical; one batch-1 int8 tail each of the Mask and Keypoint
    R-CNN students; ``cost_analyzer --split_model --int8_tail`` on
    ``runner_phase``'s fixture and distilled student, its int8 mAP delta;
    the float and int8 tails' times at batch 1 and 8 (CUDA events and
    wall), and their trunks alone at batch 8.  Returns the kernels'
    launches of the int8 runs and of the cost_analyzer run."""
    from hnd_ghnd_tpu_torch.codec.quantizer import QuantizedTensor
    from hnd_ghnd_tpu_torch.models.factory import build_model, get_model
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.runners import cost_analyzer
    from hnd_ghnd_tpu_torch.split import int8 as qi
    from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN, unpack_wire
    os.environ["HND_TPU_PALLAS_STEM"] = "0"
    model = serving_model(dev)
    served = serving_batches(np.random.RandomState(SEED + 50))[:2]

    def one_image(batch, i):
        return {k: v[i:i + 1] for k, v in batch.items()}

    t0 = time.perf_counter()
    scales = qi.calibrate_from_images(
        model, [served[0]["images"][i:i + 1]
                for i in range(INT8_CALIB_IMAGES)])
    calib_s = time.perf_counter() - t0
    check(len(scales) == 44 and all(np.isfinite(v) and v > 0
                                    for v in scales.values()),
          f"calibration gave {len(scales)} sites: {scales}")
    split = SplitRCNN(model, 8)
    head, tail, _ = split.build()
    int8 = qi.Int8SplitTail(model, scales)
    int8_call = int8.build()
    runs = [served[0], served[1], one_image(served[0], 0),
            one_image(served[1], 0)]
    wires = [split.run_edge(head, b["images"], b["image_sizes"],
                            b["original_sizes"]) for b in runs]
    buckets = [tuple(b["images"].shape[1:3]) for b in runs]
    zero_kernel_counts()
    t0 = time.perf_counter()
    dets8 = [split.run_server(int8_call, w, bk)
             for w, bk in zip(wires, buckets)]
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    log(f"[int8] calibrated on {INT8_CALIB_IMAGES} images in {calib_s:.3f} "
        f"s; {len(runs)} int8 tails in {wall:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for k, n in (("int8_conv_requant", 46), ("int8_conv", 0),
                 ("int8_conv_wgmma", 45), ("int8_conv_mma_sync", 1),
                 ("dequantize", 1), ("roi_align", 1)):
        check(launches[k] == n * len(runs), f"int8 tail: {k} launched "
              f"{launches[k]} times for {len(runs)} runs")
    check(launches["quantize"] == 0, "the int8 tail quantized a wire")
    for b, w, bk, d8 in zip(runs, wires, buckets, dets8):
        dfp = split.run_server(tail, w, bk)
        shape = tuple(b["images"].shape)
        check(set(d8) == set(dfp), f"int8 tail {shape}: keys")
        for k, v in dfp.items():
            check(d8[k].shape == v.shape, f"int8 tail {shape}: {k} shape")
            check(d8[k].dtype.kind != "f" or bool(np.isfinite(d8[k]).all()),
                  f"int8 tail {shape}: non-finite {k}")
        log(f"[int8] {shape}: {int(d8['valid'].sum())} detections (float "
            f"tail {int(dfp['valid'].sum())}), keys and shapes the float "
            "tail's, finite")

    # ------------------------------- stage outputs against the float walk
    for b, w in zip(runs[:2], wires[:2]):
        p = unpack_wire(w)
        z = wire_tensor(p, dev)
        cos = [cosine(f, g) for f, g in zip(qi.trunk_features_fp(model, z),
                                             int8.trunk(z))]
        log(f"[int8] {tuple(b['images'].shape)}: stage cosines with the "
            f"float folded walk {[round(c, 6) for c in cos]}")
        check(min(cos) > INT8_COS_MIN, f"int8 stage cosine {min(cos)}")

    # ------------------------------------------- the card against the CPU
    rng = np.random.RandomState(SEED + 51)
    h, w = INT8_CPU_SHAPE
    small = {"images": rng.randint(0, 256, (1, h, w, 3), dtype=np.uint8),
             "image_sizes": np.array([[h, w]], np.int32),
             "original_sizes": np.array([[h, w]], np.int32)}
    p = unpack_wire(split.run_edge(head, small["images"],
                                   small["image_sizes"],
                                   small["original_sizes"]))
    cpu_model = build_model(STUDENT_MODEL).requires_grad_(False)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    sites = {}
    for side, m in (("gpu", model), ("cpu", cpu_model)):
        tail_q = int8 if side == "gpu" else qi.Int8SplitTail(m, scales)
        z = wire_tensor(p, tail_q.device)
        sites[side] = {}
        t0 = time.perf_counter()
        with torch.no_grad():
            tail_q.trunk(z, sites[side])
        if side == "gpu":
            torch.cuda.synchronize()
        log(f"[int8] {side} walk of the {tuple(p.tensor.shape)} wire: "
            f"{time.perf_counter() - t0:.3f} s")
    check(list(sites["gpu"]) == list(sites["cpu"]) and len(sites["cpu"]) == 44,
          "the card's and the CPU's walks have other sites")
    for name, q in sites["cpu"].items():
        check(torch.equal(sites["gpu"][name].cpu(), q),
              f"int8 site {name}: the card's codes differ from the CPU's")
    log(f"[int8] card vs CPU on the {tuple(p.tensor.shape)} wire: the codes "
        f"of all 44 sites identical "
        f"({sum(q.numel() for q in sites['cpu'].values())} codes)")
    del cpu_model, sites

    # ------------------------------------------ the Mask and Keypoint heads
    for i, cfg in enumerate((MASK_STUDENT_MODEL, KEYPOINT_STUDENT_MODEL)):
        m = live_norms_(get_model(cfg, seed=SEED + 52 + i, device=dev),
                        SEED + 52 + i).requires_grad_(False)
        one = one_image(served[0], 0)
        sp = SplitRCNN(m, 8)
        h_call, t_call, _ = sp.build()
        t8 = qi.Int8SplitTail(m, qi.calibrate_from_images(
            m, [one["images"]])).build()
        wire = sp.run_edge(h_call, one["images"], one["image_sizes"],
                           one["original_sizes"])
        d8 = sp.run_server(t8, wire, BUCKETS[0])
        dfp = sp.run_server(t_call, wire, BUCKETS[0])
        check(set(d8) == set(dfp), f"{cfg['name']} int8 tail: keys")
        for k, v in dfp.items():
            check(d8[k].shape == v.shape, f"{cfg['name']} int8 tail: {k}")
            check(d8[k].dtype.kind != "f" or bool(np.isfinite(d8[k]).all()),
                  f"{cfg['name']} int8 tail: non-finite {k}")
        log(f"[int8] {cfg['name']} batch 1: int8 tail keys and shapes the "
            f"float tail's, finite ({sorted(d8)})")
        del m
    torch.cuda.empty_cache()

    # ----------------------------------- cost_analyzer on the fixture
    val = {"images": os.path.join(root, "val"),
           "annotations": os.path.join(root, "instances_val_teacher.json"),
           "remove_non_annotated_imgs": False, "jpeg_quality": None}
    config = {"dataset": {"name": "fixture", "num_workers": 4,
                          "splits": {k: val for k in ("train", "val",
                                                      "test")}},
              "student_model": dict(STUDENT_MODEL, ckpt=os.path.join(
                  root, "student.pt")),
              "test": {"batch_size": 1}, "tpu": GHND_TPU}
    args = cost_analyzer.get_argparser().parse_args(
        ["--config", "config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml",
         "--device", str(dev), "--split_model", "--int8_tail",
         "--calib_images", str(INT8_CALIB_IMAGES)])
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = cost_analyzer.run(config, args)["split_model"]
    wall = time.perf_counter() - t0
    analyzer = kernel_counts()
    n = len(res["int8_tail_s"])
    check(n == len(res["tail_s"]) and n > 0
          and analyzer["int8_conv_requant"] == 46 * n
          and analyzer["int8_conv"] == 0
          and analyzer["int8_conv_wgmma"] == 45 * n
          and analyzer["int8_conv_mma_sync"] == n,
          f"cost_analyzer --int8_tail: {n} int8 tails, launches "
          f"{ {k: v for k, v in analyzer.items() if 'int8' in k} }")
    delta = res["int8_map_delta"]["bbox"]
    check(bool(np.isfinite(delta)), f"int8 mAP delta {delta}")
    log(f"[int8] cost_analyzer --split_model --int8_tail on the fixture in "
        f"{wall:.3f} s: {n} images, int8 tail mAP delta [bbox] {delta:+.6f} "
        f"(float {res['evaluator'].stats['bbox'][0]:.6f}, int8 "
        f"{res['int8_evaluator'].stats['bbox'][0]:.6f}); tails "
        f"{np.median(res['tail_s']) * 1e3:.3f} / "
        f"{np.median(res['int8_tail_s']) * 1e3:.3f} ms wall (float / int8, "
        "medians at batch 1)")

    # --------------------------------------------------------- times
    times = {}
    for b in SPLIT_TIMED_BATCHES:
        batch = served[0] if b == EVAL_BATCH else one_image(served[0], 0)
        bucket = tuple(batch["images"].shape[1:3])
        images = torch.from_numpy(batch["images"]).to(dev)
        sizes = torch.from_numpy(batch["image_sizes"]).to(dev)
        q, scale, zp, _ = split.head_fn(images)
        fp_ms = time_ms(lambda: split.tail_fn(q, scale, zp, sizes, bucket))
        q8_ms = time_ms(lambda: int8.tail_fn(q, scale, zp, sizes, bucket))
        wire = split.run_edge(head, batch["images"], batch["image_sizes"],
                              batch["original_sizes"])
        walls = {"fp": [], "int8": []}
        for _ in range(REPS):
            for key, call in (("fp", tail), ("int8", int8_call)):
                t0 = time.perf_counter()
                split.run_server(call, wire, bucket)
                walls[key].append((time.perf_counter() - t0) * 1e3)
        times[b] = {"fp_ms": fp_ms, "int8_ms": q8_ms,
                    "fp_wall_ms": statistics.median(walls["fp"]),
                    "int8_wall_ms": statistics.median(walls["int8"])}
        log(f"[int8] {card}: batch {b} at {bucket}: float tail {fp_ms:.3f} "
            f"ms, int8 tail {q8_ms:.3f} ms (CUDA events, median of {REPS}); "
            f"wall from bytes to host detections {times[b]['fp_wall_ms']:.3f}"
            f" / {times[b]['int8_wall_ms']:.3f} ms")
        if b == EVAL_BATCH:
            z = QK.dequantize(QuantizedTensor(q, scale, zp))
            body = model.backbone.body
            zc = z.permute(0, 3, 1, 2).contiguous()

            def float_trunk():
                y = body.layer1.decode(zc)
                for stage in (2, 3, 4):
                    y = getattr(body, f"layer{stage}")(y)
                return y

            with torch.no_grad():
                trunk_fp = time_ms(float_trunk)
                trunk_q8 = time_ms(lambda: int8.trunk(z))
            log(f"[int8] batch {b}: trunk alone (decoder + layers 2-4) "
                f"float {trunk_fp:.3f} ms, int8 {trunk_q8:.3f} ms (CUDA "
                "events)")
    del model, int8, served
    torch.cuda.empty_cache()
    return {"int8_tail": launches, "cost_analyzer_int8": analyzer}


def _card_timed(fn, store: list):
    """``fn`` with the card synchronised before and after it; each call's
    milliseconds appended to ``store``."""
    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        store.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed


def _capture_distill(mimic_runner, into: dict):
    """Wrap ``mimic_runner.distill_coco`` so that ``into`` receives the
    student's trainable parameters when it returns (``run`` then reloads
    the best checkpoint) and the group's backend and size.  Returns the
    original, to put back."""
    import torch.distributed as dist
    original = mimic_runner.distill_coco

    def capture(teacher, student, *args, **kwargs):
        hist = original(teacher, student, *args, **kwargs)
        into["state"] = {n: p.detach().cpu() for n, p in
                         student.named_parameters() if p.requires_grad}
        up = dist.is_initialized()
        into["backend"] = dist.get_backend() if up else None
        into["world"] = dist.get_world_size() if up else 1
        return hist

    mimic_runner.distill_coco = capture
    return original


def _record_grad_norms(step, store: list) -> None:
    """Wrap ``step.apply_update`` (an instance's, or a class's for every
    step made later) so that ``store`` receives each update's gradient
    norms, one per trainable leaf in the optimizer's order, as a device
    tensor (no wait for the card)."""
    original = (step if isinstance(step, type) else type(step)).apply_update

    def apply_update(self):
        store.append(torch.stack([
            torch.linalg.vector_norm(p.grad.float()) for g in
            self.optimizer.param_groups for p in g["params"]]))
        return original(self)

    if isinstance(step, type):
        step.apply_update = apply_update
    else:
        step.apply_update = apply_update.__get__(step)


def two_bucket_shapes(n: int, portraits, landscape: tuple,
                      portrait: tuple) -> list:
    """One (h, w) per image of an ``n``-image train split sharded over
    ``len(portraits)`` ranks: ``portraits[r]`` of shard r's images, the
    last of its epoch-0 order, ``portrait``, the rest ``landscape``."""
    from hnd_ghnd_tpu_torch.data.loader import DetectionLoader
    shapes = [landscape] * n
    for r, k in enumerate(portraits):
        order = DetectionLoader(range(n), 1, training=True, shard_index=r,
                                num_shards=len(portraits))._order()
        for i in order[len(order) - k:]:
            shapes[i] = portrait
    return shapes


def _mp_rank(rank: int, port: int, config: dict, root: str, results) -> None:
    """One rank of ``multiprocess_phase``, in a process of its own: puts
    (rank, its record) on ``results``, or (rank, the traceback) if it
    fails."""
    try:
        results.put((rank, _mp_rank_run(rank, port, config, root)))
    except Exception:
        import traceback
        results.put((rank, traceback.format_exc()))


def _mp_rank_run(rank: int, port: int, config: dict, root: str) -> dict:
    """The rank's gloo group on card 0 (made here, as a caller that sets
    up its own group does), then ``mimic_runner.run -distill
    -transform_bottleneck -skip_teacher_eval --device cuda:0``.  Its
    student's final trainable parameters go to ``root/mp_rank<r>.pt``."""
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.parallel import multihost
    from hnd_ghnd_tpu_torch.parallel.train_step import DistillStep
    from hnd_ghnd_tpu_torch.runners import mimic_runner
    from hnd_ghnd_tpu_torch.runners.common import configure_precision
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    check(_build.load() is not None, "kernel library did not load")
    configure_precision(torch.float32)
    multihost.init_distributed_mode(f"tcp://127.0.0.1:{port}", MP_WORLD,
                                    rank, dev, backend="gloo",
                                    timeout_s=MP_TIMEOUT_S)
    # every cross-rank reduction (the BNs' and the step's), and the step's
    # gradient bucket alone, on the card's clock
    reduce_ms, grads_ms = [], []
    multihost.all_reduce_ = _card_timed(multihost.all_reduce_, reduce_ms)
    multihost.all_reduce_grads = _card_timed(multihost.all_reduce_grads,
                                             grads_ms)
    captured: dict = {}
    _capture_distill(mimic_runner, captured)
    grad_norms: list = []
    _record_grad_norms(DistillStep, grad_norms)
    args = mimic_runner.get_argparser().parse_args(
        ["--config", GHND_YAML, "--device", "cuda:0", "-distill",
         "-transform_bottleneck", "-skip_teacher_eval"])
    zero_kernel_counts()
    t0 = time.perf_counter()
    result = mimic_runner.run(config, args)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    torch.save(captured["state"], os.path.join(root, f"mp_rank{rank}.pt"))
    multihost.destroy()
    hist = result["distill"]
    return {"steps": [tuple(s[:3]) for s in hist["steps"]],
            "step_ms": [s[3] for s in hist["steps"]],
            "epochs": [{"val_map": e["val_map"], "stats": e["stats"],
                        "val_batches": e["eval"]["batches"],
                        "merge_s": e["eval"]["merge_s"]}
                       for e in hist["epochs"]],
            "test_stats": result["student"]["stats"],
            "test_batches": result["student"]["eval"]["batches"],
            "test_merge_s": result["student"]["eval"]["merge_s"],
            "counts": counts, "reduce_ms": reduce_ms, "grads_ms": grads_ms,
            "grad_norms": [g.tolist() for g in grad_norms],
            "backend": captured["backend"], "world": captured["world"],
            "wall": wall}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(target, world: int, args: tuple, timeout_s: float) -> list:
    """``target(rank, *args, results)`` in ``world`` spawned processes;
    their records in rank order.  A rank that reports a failure, exits
    without a record or is not done within ``timeout_s`` fails the phase;
    every process is ended before this returns."""
    import queue
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, *args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    try:
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            try:
                rank, rec = results.get(timeout=5.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                check(not dead, f"rank(s) {dead} exited without a result")
                check(time.monotonic() < deadline,
                      f"ranks not done within {timeout_s} s")
                continue
            check(isinstance(rec, dict), f"rank {rank} failed:\n{rec}")
            out[rank] = rec
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    return [out[r] for r in range(world)]


def subset_annotations(ann_file: str, out_file: str, n: int) -> None:
    """``ann_file`` with its first ``n`` images, written to ``out_file``."""
    with open(ann_file) as f:
        coco = json.load(f)
    coco["images"] = coco["images"][:n]
    keep = {im["id"] for im in coco["images"]}
    coco["annotations"] = [a for a in coco["annotations"]
                           if a["image_id"] in keep]
    with open(out_file, "w") as f:
        json.dump(coco, f)


def multiprocess_phase(dev: torch.device, root: str, card: str) -> dict:
    """ROADMAP A12 on the card, with the stem switch on.  (a) MP_WORLD
    ranks on card 0 over gloo (NCCL refuses two ranks on one device), each
    ``mimic_runner.run -distill -transform_bottleneck`` with the GHND b3ch
    config at batch TRAIN_BATCH on its shard of MP_TRAIN_IMAGES JPEGs in
    two buckets (``two_bucket_shapes``: the shards' raw batch counts
    differ, the ranks' steps do not), one epoch, its shard of the runner
    phase's val split and the merged COCOeval; (b) one process, the same
    weights, on the concatenated batch-8 stream of the shards' first
    ``len(loader)`` batches; (c) one rank through
    ``mimic_runner.main`` over NCCL (``--dist_url env://``, WORLD_SIZE=1),
    one step and the evals.  Two ranks on one card measure the path, not
    scaling across cards.  Returns each run's kernel launches."""
    from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.parallel import multihost
    from hnd_ghnd_tpu_torch.runners import common, mimic_runner
    from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    t0 = time.perf_counter()
    mp_root = os.path.join(root, "mp")
    shapes = two_bucket_shapes(MP_TRAIN_IMAGES, MP_PORTRAITS,
                               *RUNNER_SHAPES)
    fx = write_runner_fixture(mp_root, np.random.RandomState(SEED + 20),
                              {"train": MP_TRAIN_IMAGES}, tuple(shapes))
    teacher, student = runner_models(dev)
    ckpts = {}
    for name, model in (("teacher", teacher), ("student", student),
                        ("student_a", student), ("student_c", student)):
        ckpts[name] = os.path.join(mp_root, f"{name}.pt")
        params, state = jax_params_from_state_dict(model.state_dict())
        ckpt_util.save_ckpt(ckpts[name], params=params, state=state)
    del teacher, student
    torch.cuda.empty_cache()
    img_dir, ann = fx["train"]
    val = {"images": os.path.join(root, "val"),
           "annotations": os.path.join(root, "instances_val_teacher.json"),
           "remove_non_annotated_imgs": False, "jpeg_quality": None}
    train = {"images": img_dir, "annotations": ann,
             "remove_non_annotated_imgs": True, "jpeg_quality": None}
    config = {
        "dataset": {"name": "fixture", "num_workers": 4, "splits": {
            "train": train, "val": val, "test": val}},
        "teacher_model": dict(TEACHER_MODEL, ckpt=ckpts["teacher"]),
        "student_model": dict(STUDENT_MODEL, ckpt=ckpts["student_a"]),
        "train": dict(TRAIN, num_epochs=1), "test": {"batch_size": 1},
        "tpu": GHND_TPU}
    log(f"[multi-process] fixture of {MP_TRAIN_IMAGES} JPEGs at "
        f"{RUNNER_SHAPES[0]}, {sum(MP_PORTRAITS)} of them at "
        f"{RUNNER_SHAPES[1]} ({MP_PORTRAITS} a shard), and the checkpoints "
        f"in {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ (a) two ranks, gloo
    t0 = time.perf_counter()
    ranks = spawn_ranks(_mp_rank, MP_WORLD, (free_port(), config, mp_root),
                        MP_TIMEOUT_S)
    wall_a = time.perf_counter() - t0
    r0 = ranks[0]
    n_steps = len(r0["steps"])
    want_steps = MP_TRAIN_IMAGES // MP_WORLD // TRAIN_BATCH
    check(n_steps == want_steps, f"multi-process: {n_steps} steps a rank, "
          f"want {want_steps}")
    for r, rec in enumerate(ranks):
        check(rec["backend"] == "gloo" and rec["world"] == MP_WORLD,
              f"rank {r}: group {rec['backend']} of {rec['world']}")
        check(rec["steps"] == r0["steps"], f"rank {r} logged other losses "
              f"than rank 0: {rec['steps']} vs {r0['steps']}")
        check(rec["epochs"][0]["stats"] == r0["epochs"][0]["stats"]
              and rec["test_stats"] == r0["test_stats"],
              f"rank {r}: merged COCOeval stats differ from rank 0's")
        n_val, n_test = rec["epochs"][0]["val_batches"], rec["test_batches"]
        want = {"stem_fwd": n_steps + n_val + n_test,
                "stem_fwd_res": n_steps, "stem_dw": n_steps,
                "quantize": n_val + n_test, "dequantize": n_val + n_test,
                "roi_align": n_val + n_test}
        for k, n in want.items():
            check(rec["counts"][k] == n, f"rank {r}: {k} launched "
                  f"{rec['counts'][k]} times, want {n}")
        for idx, loss, _ in rec["steps"]:
            check(np.isfinite(loss), f"rank {r} step {idx}: loss {loss}")
        log(f"[multi-process] (a) rank {r}: run {rec['wall']:.3f} s, steps "
            + " / ".join(f"{ms:.3f}" for ms in rec["step_ms"])
            + f" ms, {n_val} val + {n_test} test batches of its shard; "
            f"launches { {k: v for k, v in rec['counts'].items() if v} }")
    for idx, loss, terms in r0["steps"]:
        log(f"[multi-process] (a) step {idx}: global loss {loss:.6e} on "
            f"both ranks, terms "
            + " ".join(f"{k} {v:.6e}" for k, v in terms.items()))
    log("[multi-process] (a) merged val bbox stats on both ranks: "
        + " ".join(f"{v:.6f}" for v in r0["epochs"][0]["stats"]["bbox"])
        + "; test: " + " ".join(f"{v:.6f}" for v in r0["test_stats"]["bbox"]))
    states = [torch.load(os.path.join(mp_root, f"mp_rank{r}.pt"))
              for r in range(MP_WORLD)]
    for r in range(1, MP_WORLD):
        check(states[r].keys() == states[0].keys() and all(
            torch.equal(states[r][k], states[0][k]) for k in states[0]),
            f"rank {r}'s student parameters are not rank 0's")

    # ------------------------------- (b) one process, the global batch
    teacher = get_model(config["teacher_model"], seed=SEED, device=dev)
    student = get_model(dict(config["student_model"],
                             ckpt=ckpts["student"]), seed=SEED + 1,
                        device=dev)
    loaders = [common.loaders_from_config(
        config, student.kind, TRAIN_BATCH, min_sizes=(800,), shard_index=r,
        num_shards=MP_WORLD)[0] for r in range(MP_WORLD)]
    # the shards' own batch counts differ; a rank stops at len(loader)
    raw = [sum(1 for _ in loader) for loader in loaders]
    check(len(set(raw)) > 1 and min(raw) > len(loaders[0]) == n_steps,
          f"multi-process: the shards yield {raw} batches, len(loader) "
          f"{len(loaders[0])}, the ranks ran {n_steps} steps")
    step = mimic_runner.make_step(teacher, student, config, len(loaders[0]))
    grad_norms: list = []
    _record_grad_norms(step, grad_norms)
    student.train()
    names = [n for n, p in student.named_parameters() if p.requires_grad]
    start = {n: p.detach().cpu().clone() for n, p in
             student.named_parameters() if p.requires_grad}
    one, ms_b = [], []
    for items in zip(*(itertools.islice(loader, len(loader))
                       for loader in loaders)):
        images = np.concatenate([b["images"] for b, _, _ in items])
        x = common.to_device({"images": images}, dev)["images"]
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        loss, terms = step(x)
        end.record()
        end.synchronize()
        ms_b.append(begin.elapsed_time(end))
        one.append((float(loss), {k: float(v) for k, v in terms.items()}))
    final = {n: p.detach().cpu() for n, p in student.named_parameters()
             if p.requires_grad}
    del teacher, student, step
    torch.cuda.empty_cache()
    check(len(one) == n_steps, f"one process: {len(one)} steps")
    for i, ((loss, terms), (_, r_loss, r_terms)) in enumerate(
            zip(one, r0["steps"])):
        tol = LOSS_TOL_FIRST if i == 0 else LOSS_TOL_LATER
        for name, a, b in [("loss", r_loss, loss)] + [
                (k, r_terms[k], terms[k]) for k in terms]:
            check(abs(a - b) <= tol * abs(b), f"step {i} {name}: ranks "
                  f"{a} vs one process {b} (tol {tol})")
    # the gradient of the first step, reduced over the ranks: the one
    # process's on the global batch, not half of it
    grads_a = [rec["grad_norms"][0] for rec in ranks]
    for r in range(MP_WORLD):
        check(grads_a[r] == grads_a[0],
              f"rank {r}'s reduced gradient is not rank 0's")
    grad_ratios = sorted(
        ((abs(got - want) / want, name) for name, got, want in
         zip(names, grads_a[0], grad_norms[0].tolist())
         if name not in MP_ZERO_GRAD), reverse=True)
    lr = float(TRAIN["optimizer"]["params"]["lr"])
    move_ratios = []
    for name, p in final.items():
        moved = p - start[name]
        got = states[0][name] - start[name]
        if name in MP_ZERO_GRAD:
            bound = 2 * lr * n_steps
            check(float((got - moved).abs().max()) <= bound,
                  f"{name}: ranks and one process apart by more than "
                  f"{bound}")
            continue
        move_ratios.append((float((got - moved).norm() / moved.norm()), name))
    move_ratios.sort(reverse=True)

    def worst(ratios):
        return ", ".join(f"{n} {r:.3e}" for r, n in ratios[:3])

    log(f"[multi-process] (b) one process on the concatenated batch-"
        f"{TRAIN_BATCH * MP_WORLD} stream: steps "
        + " / ".join(f"{ms:.3f}" for ms in ms_b) + " ms; losses "
        + " ".join(f"{l:.6e}" for l, _ in one) + f"; the shards' own batch "
        f"counts {raw}, {n_steps} steps a rank; the ranks' first reduced "
        f"gradient against its leaf norms, worst {worst(grad_ratios)} (tol "
        f"{MP_GRAD_TOL}); their student parameters' moves against its, "
        f"worst {worst(move_ratios)} (tol {MP_MOVE_TOL})")
    check(grad_ratios[0][0] <= MP_GRAD_TOL, f"{grad_ratios[0][1]}: the "
          f"ranks' first gradient norm is {grad_ratios[0][0]} of the one "
          f"process's away from it (tol {MP_GRAD_TOL})")
    check(move_ratios[0][0] <= MP_MOVE_TOL, f"{move_ratios[0][1]}: the "
          f"ranks' move is {move_ratios[0][0]} of the one process's away "
          f"from it (tol {MP_MOVE_TOL})")
    global_batch = TRAIN_BATCH * MP_WORLD
    ips_a = global_batch * (n_steps - 1) / sum(r0["step_ms"][1:]) * 1e3
    ips_b = global_batch * (n_steps - 1) / sum(ms_b[1:]) * 1e3
    grads = statistics.median(r0["grads_ms"])
    others = (sum(r0["reduce_ms"]) - sum(r0["grads_ms"])) / n_steps
    log(f"[multi-process] img/s at global batch {global_batch} (CUDA "
        f"events of steps 1-{n_steps - 1}): (a) {MP_WORLD} ranks on one "
        f"card over gloo {ips_a:.4f}, (b) one process {ips_b:.4f}; (a)'s "
        f"spawn to exit {wall_a:.3f} s; on {card}")
    log(f"[multi-process] all-reduce per step (rank 0, the card "
        f"synchronised around each): the gradient bucket {grads:.3f} ms "
        f"(median of {len(r0['grads_ms'])}), the BNs' statistics "
        f"{others:.3f} ms; COCOeval merge {r0['epochs'][0]['merge_s'] * 1e3:.3f}"
        f" ms (val), {r0['test_merge_s'] * 1e3:.3f} ms (test), waits "
        "for the other rank included")

    # --------------------------- (c) one rank through main, over NCCL
    one_ann = os.path.join(mp_root, "instances_train_one_step.json")
    subset_annotations(ann, one_ann, TRAIN_BATCH)
    config_c = dict(config, dataset=dict(config["dataset"], splits=dict(
        config["dataset"]["splits"], train=dict(train, annotations=one_ann))),
        student_model=dict(STUDENT_MODEL, ckpt=ckpts["student_c"]))
    path = os.path.join(mp_root, "nccl.yaml")
    with open(path, "w") as f:
        json.dump(config_c, f)         # JSON is YAML
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    captured: dict = {}
    original = _capture_distill(mimic_runner, captured)
    argv = ["--config", path, "--device", "cuda", "--dist_url", "env://",
            "-distill", "-transform_bottleneck", "-student_only"]
    args = mimic_runner.get_argparser().parse_args(argv)
    zero_kernel_counts()
    t0 = time.perf_counter()
    try:
        if importlib.util.find_spec("yaml") is None:
            log("[multi-process] (c) no yaml here: run() with main's "
                "arguments")
            result = mimic_runner.run(config_c, args)
        else:
            result = mimic_runner.main(args)
    finally:
        mimic_runner.distill_coco = original
        for k, v in saved_env.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    wall_c = time.perf_counter() - t0
    nccl = kernel_counts()
    steps_c = result["distill"]["steps"]
    check(captured.get("backend") == "nccl" and captured["world"] == 1,
          f"(c): group {captured.get('backend')} of {captured.get('world')}")
    check(not multihost.group_up(), "(c): main left its group up")
    check(len(steps_c) == 1 and np.isfinite(steps_c[0][1]),
          f"(c): steps {steps_c}")
    for k in ("stem_fwd", "stem_fwd_res", "stem_dw", "quantize",
              "dequantize", "roi_align"):
        check(nccl[k] > 0, f"(c): {k} never launched")
    stats_c = result["student"]["stats"]["bbox"]
    check(np.isfinite(stats_c).all(), f"(c): stats {stats_c}")
    log(f"[multi-process] (c) mimic_runner.main, one rank over NCCL "
        f"(--dist_url env://, WORLD_SIZE=1): 1 step {steps_c[0][3]:.3f} ms, "
        f"loss {steps_c[0][1]:.6e}, val and test evals, {wall_c:.3f} s; "
        f"launches { {k: v for k, v in nccl.items() if v} }")
    return {"rank0": r0["counts"], "rank1": ranks[1]["counts"],
            "nccl": nccl}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.codec.quantizer import (dequantize_tensor,
                                                    quantize_tensor)
    from hnd_ghnd_tpu_torch.models.factory import build_model
    from hnd_ghnd_tpu_torch.models.rcnn import RCNN
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops.roi_align import multiscale_roi_align_batch
    from hnd_ghnd_tpu_torch.runners.common import (configure_precision,
                                                   eval_forward, evaluate)

    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    # ---------------------------------------------------------- 1. setup
    log(f"[setup] card: {card}")
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    present = {m: importlib.util.find_spec(m) is not None
               for m in ("jax", "yaml", "PIL", "cv2", "triton")}
    log(f"[setup] installed (not imported): {present}")

    # ---------------------------------------------------------- 2. build
    lib = _build.load()
    log(f"[build] {_build.build_info['seconds']:.1f} s "
        f"(cached={_build.build_info['cached']}) {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    check(lib is not None, "kernel library did not load")

    # ---------------------------------------------------------- 3. kernels
    # float32 with TF32 off everywhere, the plain versions included
    configure_precision(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = {}
    # the bottleneck tensor of the serving path (+4 from the k2/p1 convs),
    # as NHWC, as its channels_last NCHW view, a size that is not a
    # multiple of the vector width or the block, batch 32 (past what the
    # quantize grid holds in registers), and a view at storage offset 1
    z = torch.from_numpy(quant_input(SEED, (EVAL_BATCH, 212, 340, 3))).to(dev)
    offset = torch.empty(z.numel() + 1, device=dev)[1:].view(z.shape)
    offset.copy_(z)
    cases = [("nhwc", z), ("channels_last", z.permute(0, 3, 1, 2)),
             ("odd", torch.from_numpy(quant_input(SEED + 1, (3, 101, 77, 5)))
              .to(dev)),
             ("batch 32", torch.from_numpy(quant_input(
                 SEED + 2, (32, 212, 340, 3))).to(dev)),
             ("storage offset 1", offset)]
    for name, x in cases:
        q = QK.quantize(x, 8)
        ref = quantize_tensor(x, 8)
        cpu = quantize_tensor(x.cpu(), 8)
        check(torch.equal(q.tensor, ref.tensor), f"quantize codes ({name})")
        check(torch.equal(q.tensor.cpu(), cpu.tensor), f"codes vs CPU ({name})")
        for a, b in ((q.scale, ref.scale), (q.zero_point, ref.zero_point),
                     (q.scale.cpu(), cpu.scale),
                     (q.zero_point.cpu(), cpu.zero_point)):
            check(torch.equal(a, b), f"scale/zero point ({name})")
        d = QK.dequantize(q)
        check(torch.equal(d, dequantize_tensor(ref)), f"dequantize ({name})")
        log(f"[kernels] quantize/dequantize {name} {tuple(x.shape)}: "
            "bit-exact vs plain (card and CPU)")
    del cases, offset
    q = QK.quantize(z, 8)
    # no single PyTorch call computes the quantizer or RoIAlign: no library
    # time.  Operations per element: min, max, divide, add, 2 clamps and a
    # round to quantize; subtract and multiply to dequantize.
    kernels["quantize"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/quant.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_quant.py:46",
        max_abs_err=float((q.tensor.int() - quantize_tensor(z, 8).tensor.int())
                          .abs().max()),
        **timings(lambda: QK.quantize(z, 8)),
        plain_ms=time_ms(lambda: quantize_tensor(z, 8)), library_ms=None,
        **bound(nbytes(z, q.tensor), 7.0 * z.numel()))
    kernels["dequantize"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/quant.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_quant.py:61",
        max_abs_err=float((QK.dequantize(q) - dequantize_tensor(q))
                          .abs().max()),
        **timings(lambda: QK.dequantize(q)),
        plain_ms=time_ms(lambda: dequantize_tensor(q)), library_ms=None,
        **bound(nbytes(q.tensor, z), 2.0 * z.numel()))
    # what launching costs on the card: an empty cooperative kernel with one
    # grid barrier on quantize's grid, an empty kernel on dequantize's; and
    # torch.aminmax, the yardstick of quantize's reduction (logged only)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, barrier in (("quantize", 1), ("dequantize", 0)):
        kernels[name]["launch_floor_device_ms"] = time_ms(
            lambda: _build.check(_build.load().hnd_launch_floor(
                z.numel(), barrier, stream), "hnd_launch_floor"), spin=True)
    floor_q, floor_d = (kernels[k]["launch_floor_device_ms"]
                        for k in ("quantize", "dequantize"))
    log(f"[kernels] launch floor on the card: quantize's grid "
        f"({(QK._work_floats[dev.index] - 2) // 2} blocks at most) with one "
        f"barrier {floor_q:.4f} ms, dequantize's grid {floor_d:.4f} ms; "
        f"torch.aminmax of {tuple(z.shape)} "
        f"{time_ms(lambda: torch.aminmax(z), spin=True):.4f} ms")

    h, w = BUCKETS[0]
    levels = [torch.randn((EVAL_BATCH, h // s, w // s, 256), generator=gen,
                          device=dev) for s in (4, 8, 16, 32)]
    rng = np.random.RandomState(SEED)
    boxes = torch.from_numpy(box_mix(rng, EVAL_BATCH, 1000, h, w)).to(dev)
    valid = torch.from_numpy(rng.rand(EVAL_BATCH, 1000) > 0.3).to(dev)
    got = RK.roi_align(levels, boxes, (h, w), 7, 2, valid)
    want = multiscale_roi_align_batch(levels, boxes, (h, w), 7, 2, valid)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[kernels] roi_align {tuple(got.shape)}: max abs err {err} "
        f"(max |plain| {scale}, bound {ROI_TOL} x max)")
    check(err <= ROI_TOL * scale, f"roi_align err {err} > {ROI_TOL} x {scale}")
    # each valid RoI's output element: 2 x 2 samples of 4 bilinear taps
    # (a multiply and an add each) and the average
    n_valid = int(valid.sum())
    kernels["roi_align"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_roi.py:231", max_abs_err=err,
        **timings(lambda: RK.roi_align(levels, boxes, (h, w), 7, 2, valid)),
        plain_ms=time_ms(lambda: multiscale_roi_align_batch(
            levels, boxes, (h, w), 7, 2, valid)), library_ms=None,
        **roi_bound(levels, boxes, valid, (h, w), 7,
                    nbytes(boxes, valid, got),
                    33.0 * n_valid * 49 * levels[0].shape[-1]))
    # what the NHWC hand-over costs from the served NCHW maps, and from
    # channels_last ones
    nchw = [f.permute(0, 3, 1, 2).contiguous() for f in levels]
    copy_ms = time_ms(lambda: [f.permute(0, 2, 3, 1).contiguous()
                               for f in nchw])
    cl = [f.permute(0, 3, 1, 2) for f in levels]
    free_ms = time_ms(lambda: [f.permute(0, 2, 3, 1).contiguous()
                               for f in cl])
    log(f"[kernels] NHWC hand-over of P2-P5 (B=8): {copy_ms:.3f} ms from "
        f"NCHW, {free_ms:.3f} ms from channels_last")
    del levels, nchw, cl, got, want, z, q
    stem_kernels_phase(dev, kernels)
    roi_train_kernels_phase(dev, kernels)
    int8_kernels_phase(dev, kernels)
    int8_conv_kernels_phase(dev, kernels)
    for name, k in kernels.items():
        lib = "" if k["library_ms"] is None else \
            f", {k['library_ms']:.4f} ms library"
        whole = "" if "whole_levels_bound_ms" not in k else \
            f" (tapped cells; whole levels " \
            f"{k['whole_levels_bound_ms']:.4f} ms)"
        log(f"[kernels] {name}: {k['ms']:.4f} ms kernel "
            f"({k['device_ms']:.4f} on the card), {k['plain_ms']:.4f} ms "
            f"plain{lib} (median of {REPS}); bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}{whole}, {k['bound_ms'] / k['ms']:.1%} of it, "
            f"{k['bound_ms'] / k['device_ms']:.1%} of the card's time"
            + ("" if "floor_ms" not in k else
               f"; two-pass floor {k['floor_ms']:.4f} ms, "
               f"{k['floor_ms'] / k['device_ms']:.1%} of the card's time")
            + ("" if "launch_floor_device_ms" not in k else
               f"; launch floor {k['launch_floor_device_ms']:.4f} ms on the "
               "card"))

    # ---------------------------------------------------------- 4. serving
    os.environ["HND_TPU_PALLAS_STEM"] = "0"  # the serving path's default
    model = serving_model(dev)
    batches = serving_batches(np.random.RandomState(SEED + 1))
    served = batches * 2  # the first pass includes cuDNN's first calls
    zero_kernel_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    records = evaluate(model, served, use_bottleneck_transformer=True)
    wall = time.perf_counter() - t0
    # kernel_counts checks that no NMS ran the fixpoint's host loop
    launches = {k: v for k, v in kernel_counts().items()
                if k in ("quantize", "dequantize", "roi_align", "nms_keep")}
    log(f"[slice] {len(served)} batches in {wall:.3f} s; launches {launches}; "
        f"NMS fixpoint syncs 0; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for name, n in launches.items():
        # the RPN's five levels and the box head: six NMS problems a forward
        want = len(served) * (6 if name == "nms_keep" else 1)
        check(n == want, f"{name} launched {n} times for {len(served)} "
              f"forwards")
    for i, (batch, rec) in enumerate(zip(served, records)):
        b = batch["images"].shape[0]
        dets = rec["dets"]
        check(dets["boxes"].shape == (b, 100, 4), "boxes shape")
        for key in ("scores", "labels", "valid"):
            check(dets[key].shape == (b, 100), f"{key} shape")
        for key in ("boxes", "boxes_model", "scores"):
            check(bool(np.isfinite(dets[key]).all()), f"non-finite {key}")
        log(f"[slice] batch {i} {tuple(batch['images'].shape)}: "
            f"{rec['ms']:.2f} ms, {int(dets['valid'].sum())} detections")
    _, fpn = model.backbone_features(
        torch.from_numpy(batches[2]["images"]).to(dev).float() / 255.0, True)
    log(f"[slice] P2 contiguous NCHW: {fpn[0].is_contiguous()}")

    nms_kernels_phase(dev, kernels, model, batches)

    # ---------------------------------------------------------- 5. card vs CPU
    cpu_model = build_model(STUDENT_MODEL).requires_grad_(False)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    one = batches[2]
    images = torch.from_numpy(one["images"]).float() * torch.tensor(1.0 / 255.0)
    body = {"cpu": cpu_model.backbone.body, "gpu": model.backbone.body}
    x = {"cpu": RCNN.normalize(images), "gpu": RCNN.normalize(images.to(dev))}
    z = {k: b.layer1.encoder(b.stem(x[k])) for k, b in body.items()}
    check(rel_err(z["gpu"], z["cpu"]) <= STAGE_TOL, "encoder output")
    q_cpu = quantize_tensor(z["cpu"], 8)
    flips = (QK.quantize(z["gpu"], 8).tensor.cpu().int()
             - q_cpu.tensor.int()).abs()
    log(f"[cpu] encoder rel err {rel_err(z['gpu'], z['cpu']):.2e}; "
        f"codes differing from the CPU: {int((flips > 0).sum())} of "
        f"{flips.numel()} (max {int(flips.max())} level)")
    check(int(flips.max()) <= 1, "a code moved by more than one level")
    # rounding is a discrete step: both sides decode the CPU's codes
    zq = dequantize_tensor(q_cpu)
    fpn = {}
    for k, b in body.items():
        y = b.layer1.decoder(zq if k == "cpu" else zq.to(dev))
        feats = [y]
        for stage in (2, 3, 4):
            feats.append(getattr(b, f"layer{stage}")(feats[-1]))
        m = cpu_model if k == "cpu" else model
        fpn[k] = m.backbone.fpn(feats)
    for i, (g, c) in enumerate(zip(fpn["gpu"], fpn["cpu"])):
        e = rel_err(g, c)
        log(f"[cpu] P{i + 2} rel err {e:.2e}")
        check(e <= STAGE_TOL, f"FPN P{i + 2}")
    on_gpu = [f.to(dev) for f in fpn["cpu"]]
    heads = {"cpu": cpu_model.rpn.head(fpn["cpu"]), "gpu": model.rpn.head(on_gpu)}
    for j, what in enumerate(("objectness", "deltas")):
        for lv, (g, c) in enumerate(zip(heads["gpu"][j], heads["cpu"][j])):
            e = rel_err(g, c)
            check(e <= STAGE_TOL, f"RPN {what} P{lv + 2}: {e}")
    log("[cpu] RPN head outputs within tolerance on every level")
    shape = BUCKETS[0]
    sizes = torch.from_numpy(one["image_sizes"])
    props, pvalid, _ = cpu_model.rpn.propose(fpn["cpu"], sizes, shape)
    # the CPU's proposals go to both sides (top-k and NMS are discrete)
    lc = cpu_model.roi_heads.box_logits(fpn["cpu"], props, pvalid, shape)
    lg = model.roi_heads.box_logits(on_gpu, props.to(dev), pvalid.to(dev), shape)
    for what, g, c in zip(("class logits", "box deltas"), lg, lc):
        e = rel_err(g, c)
        log(f"[cpu] box head {what} rel err {e:.2e}")
        check(e <= STAGE_TOL, f"box head {what}")
    det_c = eval_forward(cpu_model, {k: torch.from_numpy(v) for k, v in
                                     one.items()}, True)
    det_g = records[-1]["dets"]
    vc = det_c["valid"][0].numpy()
    matched = 0
    for j in np.flatnonzero(vc):
        same = ((det_g["labels"][0] == int(det_c["labels"][0, j]))
                & (np.abs(det_g["boxes"][0] - det_c["boxes"][0, j].numpy())
                   .max(1) < 0.5)
                & det_g["valid"][0])
        matched += bool(same.any())
    log(f"[cpu] final detections: {matched} of {int(vc.sum())} CPU detections "
        f"found on the card (label and box within 0.5 px); card has "
        f"{int(det_g['valid'][0].sum())}")

    del cpu_model, on_gpu, heads, body, x, z
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 5b. heads
    launches.update(heads_phase(dev, model, fpn["cpu"], props, pvalid, one,
                                served))
    del model, fpn
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 6. distill
    teacher, student, stem_launches = distill_phase(dev, batches[0])
    launches.update({k: stem_launches[k] for k in
                     ("stem_fwd", "stem_fwd_res", "stem_dw")})

    # ---------------------------------------------------------- 7. card vs CPU
    distill_cpu_phase(dev, teacher, student)
    del teacher, student
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 8. training
    os.environ["HND_TPU_PALLAS_STEM"] = "0"  # the stem kernels are f32 only
    train_launches = train_phase(dev, batches[0])
    launches.update({k: train_launches[k] for k in
                     ("roi_align_bf16", "roi_align_bwd")})

    # ---------------------------------------------------------- 9. card vs CPU
    train_cpu_phase(dev)
    torch.cuda.empty_cache()

    # ------------------------------------------- 9b. mask/keypoint training
    heads_train = heads_train_phase(dev)
    for name in ("roi_align_bf16_p14", "roi_align_bwd_p14"):
        launches[name] = sum(c[name] for c in heads_train.values())
    for cfg in (ORG_MASK_MODEL, ORG_KEYPOINT_MODEL):
        train_cpu_phase(dev, cfg)
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- 10. runners
    with tempfile.TemporaryDirectory() as root:
        runner = runner_phase(dev, root)
        # ------------------------------------------------------ 11. ext
        runner.update(ext_phase(dev, root, card))
        # ------------------------------------------------------ 12. split
        split_launches = split_phase(dev, root, card)
        # --------------------------------------------- 12b. the export
        export_launches = export_phase(dev, root, card)
        # --------------------------------------------- 13. the int8 tail
        int8_launches = int8_tail_phase(dev, root, card)
        torch.cuda.empty_cache()
        # ------------------------------------------ 14. multi-process
        mp_launches = multiprocess_phase(dev, root, card)
    # the int8 convolution's launches: cost_analyzer --int8_tail's, the
    # entry point a user calls.  B6 runs there only through its fused entry;
    # the int8_conv row (its int32 mode, the yardstick) counts those
    # launches of the kernel, its own entry's (0) beside them
    analyzer = int8_launches["cost_analyzer_int8"]
    launches["int8_conv_requant"] = analyzer["int8_conv_requant"]
    launches["int8_conv"] = analyzer["int8_conv_requant"]
    for name in ("int8_conv", "int8_conv_requant"):
        kernels[name]["launches_by_template"] = {
            "wgmma": analyzer["int8_conv_wgmma"],
            "mma_sync": analyzer["int8_conv_mma_sync"]}
    kernels["int8_conv"]["int32_entry_launches"] = analyzer["int8_conv"]

    # ---------------------------------------------------------- result
    # launches: the runners' (the main path) where they run the kernel, else
    # the heads phase's (the int8 tables); every path's beside
    paths = {"serving": {k: launches[k] for k in ("quantize", "dequantize",
                                                 "roi_align", "nms_keep")},
             "heads": {k: launches[k] for k in ("roi_align_int8",
                                               "quantize_levels")},
             "distill": {k: stem_launches[k] for k in
                         ("stem_fwd", "stem_fwd_res", "stem_dw")},
             "train": {k: train_launches[k] for k in
                       ("roi_align_bf16", "roi_align_bwd", "nms_keep")},
             **{f"train_{kind}": counts
                for kind, counts in heads_train.items()},
             **{f"{run}_runner": {k: v for k, v in runner[key].items() if v}
                for run, key in (("mimic", "mimic"), ("coco", "coco"),
                                 ("coco_mask", "mask_rcnn"),
                                 ("coco_keypoint", "keypoint_rcnn"))},
             "ext_runner": {"stem_fwd": runner["ext_runner"]["stem_fwd"]},
             "coco_ext": {k: runner["coco_ext"][k] for k in
                          ("roi_align", "quantize", "dequantize", "nms_keep")},
             "split": {k: split_launches[k] for k in
                       ("quantize", "dequantize", "roi_align", "stem_fwd",
                        "nms_keep")},
             "export": {k: export_launches.get(k, 0) for k in
                        ("quantize", "dequantize", "roi_align", "stem_fwd",
                         "nms_keep")},
             **{path: {k: v for k, v in int8_launches[path].items() if v}
                for path in ("int8_tail", "cost_analyzer_int8")},
             **{f"multiprocess_{run}": {k: v for k, v in counts.items() if v}
                for run, counts in mp_launches.items()}}
    out = []
    for name, k in kernels.items():
        by_path = {p: c[name] for p, c in paths.items() if c.get(name)}
        on_runner = sum(c[name] for c in runner.values())
        out.append(dict(name=name, route="cuda",
                        launches=on_runner or launches[name],
                        launches_by_path=by_path, **k))
    for k in out:
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    # every path that runs a detector's eval or training forward runs NMS
    # on the card (kernel_counts checked that none ran the fixpoint)
    for path, counts in paths.items():
        if path not in ("heads", "distill", "ext_runner"):
            check(counts.get("nms_keep", 0) > 0,
                  f"the {path} path never launched nms_keep")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
