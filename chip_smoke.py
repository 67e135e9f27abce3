"""Smoke run of plumekit_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the hand-written CUDA kernels of ``plumekit_torch/csrc`` (one
``nvcc`` per source, all at once), and the host library of
``plumekit_torch/native`` with ``g++``, and drives the port's fifteen
paths:

* megakernel serving: K7 (the whole U-Net forward in one launch) against
  its plain PyTorch version at the flagship U-Net over 128 tiles of 96²,
  one tile and a 64 × 48 depth-3 net, and against the cuDNN forward; stage
  by stage (its debug form keeps every plane) against the plain version of
  each stage at 128 tiles of 96² and of 288²; its fp32 body against the
  plain version in fp32; its per-stage times and busy shares at 128 tiles
  of 96² beside K6 at the same block shapes
  (``experiments/mega_stage_times.py``); then
  the four 2048² granules served through ``predict_model --tile 96
  --overlap 32`` from a checkpoint that says ``use_mega`` (K7 must launch
  once per forward and K6 not at all) and from one that does not; K5 (one
  fused conv) at the net's 18 conv shapes, timed on weights packed once,
  and at ragged and tiny planes for every tile geometry and image grouping
  the tile rule picks, and P1 (the gather probe, both forms) against their
  plain versions;
* serving: K6 (fused double conv) against its plain PyTorch version at
  every U-Net block shape of tile 288 and of tile 96 (timed on weights
  packed once, beside cuDNN, with the tile chosen, its fill and the bound
  per shape) and at ragged and tiny planes (one image, a batch that is no
  multiple of the images per block, planes smaller than a tile); two runs
  of K5 and of K6 must be equal bit for bit; the flagship U-Net (``UNetConfig()``: base 32,
  depth 4, bf16) through the fused and the plain forward, then four
  synthetic 2048² granules served end to end through ``predict_model
  --fused`` and through the plain forward;
* the int8 forward: Q1 (the int8 conv) against its plain version, bit for
  bit, at the 18 convs of the flagship net at 128 tiles of 288² (the
  main path's forward: two granules of 64 tiles), timed
  queued and single beside its plain version and the cuDNN bf16 conv of
  the same shape; Q2 (the transposed conv with its requant) against its
  plain version, bit for bit, at the net's four upsamples at the same
  batch, timed beside its plain version (``torch._int_mm`` and the eager
  glue it replaced) and ``torch._int_mm`` alone
  (``experiments/int8_conv_times.py``); the int8 forward of
  the flagship net on the card against the CPU's on the same quantized
  state, every int8 plane equal; the forward rates of int8, plain bf16 and
  fused at 128 tiles of 288², and the int8 forward's profile by class,
  where ``torch._int_mm`` must take no time; the four 2048² granules served
  through ``predict_model --int8`` (every 3×3 conv one launch of Q1, every
  upsample one of Q2), and the trained checkpoint of the training phase
  served with ``--int8``, whose masks must flip under 1% against the plain
  forward's;
* the serving entry points (after the streams): K6 at the nine blocks, K7
  over the whole forward, Q1 at the 18 convs and Q2 at the 4 upsamples of
  the flagship net at the serving tuner's 256², 384² and 512² tiles, at
  every batch its default grid gives there on a 2048² granule, against
  their plain versions (Q1 and Q2 bit for bit), timed at the largest
  beside their bounds; ``tune --granule 2048`` on the default grid at G = 1,
  2, 4 for the plain forward, a ``use_pallas`` copy (K6 9 launches per
  forward), a ``use_mega`` copy (K7 1, K6 0) and ``--int8`` (Q1 18, Q2 4,
  ``torch._int_mm`` 0), every candidate timed, with its ranked table, peak
  memory and seconds; ``predict_model --tuned`` of each sweep over two of
  the 2048² granules against the winner's flags given explicitly, and ``serve
  --once --tuned`` against it (bit for bit for K6, Q1 and Q2, within the
  serving gate for cuDNN and K7), beside the default geometry's rate;
  ``serve`` resumed after a fifth granule lands, a corrupt upload
  quarantined, an all-null backlog under ``--int8`` deferred, watch mode in
  a child process (seconds from a granule's arrival to its prediction on
  disk) and SIGTERM in the middle of an 8-granule backlog;
* exported serving artifacts (after the serving entry points):
  ``export_model`` of the flagship net at 2048² granules, 4 a program, for
  the plain forward (for the card and the CPU), a ``use_pallas`` copy, a
  ``use_mega`` copy at tile 96 and ``--int8``, with the seconds to trace
  and to load and the kernels' ``plumekit::`` op nodes in each program's
  graph (K6 9, K7 16, Q1 18, Q2 4, no ``aten._int_mm``); each artifact
  served by ``predict_model --exported`` over the four granules (K6 9, K7
  1, Q1 18, Q2 4 launches per forward, ``torch._int_mm`` 0) against what
  the phases above served: bit for bit for K6, K7, Q1 and Q2, within the
  serving gate for cuDNN; each program against the live program on the
  same staged granules (equal, the same launches) and their program rates
  in turns; one ragged group of 3 through the ``use_pallas`` program;
* MAIAC HDF4 granules (``maiac_phase``, after the exported artifacts):
  every committed ``tests/data/maiac`` fixture (written by the HDF4 C
  library, which this machine lacks) read by the port's own reader and
  held bit for bit against its arrays regenerated from seed 0, the broken
  ones failing with their named errors; the full-size 4 × 1200² granule
  through ``build_features --detector rg`` (K1, K3), ``predict_model``
  plain and ``--int8`` (Q1, Q2) and ``verify_real_granule``, its tables,
  masks and probabilities equal bit for bit to the same arrays read from
  ``.npz``; the reader's host time beside the ``.npz``'s;
* the rg weak labeller: K1/K4 (multi-threshold CCL) and K3 (label counts)
  against their plain versions, bit for bit, on the identify benchmark's
  1200² scene, 4096², 8192², a ragged 1201 × 997 scene and a serpentine,
  each timed with 20 launches per pair of CUDA events, K1 also pass by
  pass (local, border, finalize) at 1200² and 8192²; the rg sweep per
  scene at 1200² and 8192² with the kernels and with the plain versions,
  split by phase (K4's launches are K1's in the 8192² sweep); then
  ``build_features --detector rg``
  over four synthetic 1200² granules, one of which must equal a
  ``--device cpu`` run, and ``--batch-scenes 4`` over the same granules,
  which must equal the serial run;
* the basic and gaussian detectors: K2 (mask-stack CCL) against its plain
  version, bit for bit, on the bench scene's opened stack (where it must
  also equal K1 on the raw AOD), a ragged stack at both connectivities,
  independent masks, a fire raster, a serpentine, empty and full levels
  and basic's mask at 8192² (basic's two masks also pass by pass);
  ``basic.identify`` and
  ``gaussian.identify_granule`` at 1200² with the kernels and with the
  plain versions, split by phase; then ``build_features --detector basic``
  and ``--detector gaussian`` over four 1200² granules each, one of which
  must equal a ``--device cpu`` run;
* VIIRS swaths (after the detectors): ``identify_viirs_arrays`` of a
  synthetic IVAOT granule of 768 × 3200 (an 86 s M-band granule; its
  geolocation through float32, as the GMTCO file stores it) resampled to
  its 1803 × 4362 UTM grid, on the card (K2 must launch) against the CPU,
  plume boxes equal and plume images bit for bit, timed by phase (the
  kd-tree plan, host fire prep, K2, host post); K2 on that grid's opened
  mask against its plain version, bit for bit, queued beside its bytes
  bound; ``verify_real_granule --detector rg`` on the bench's 1200²
  granule on the card (K1 and K3 must launch) and with ``--device cpu``,
  equal summaries; and, where h5py is absent (the expected case),
  ``resample_viirs`` refusing by name and writing nothing, else
  ``make_dataset --viirs-aod-pairs 1``, ``resample_viirs`` and
  ``identify_viirs`` against the same scene in memory;
* training (no TPU kernel on the step; K1 and K3 label, K6 and K7 evaluate
  and serve): three steps of ``UNetConfig()`` widths at 8 × 128² on the card
  in fp32 (TF32 off) and bf16 against the CPU in fp32 and float64 from the
  same weights; the step timed at the JAX bench's geometry (16 × 128²,
  device-resident data, 10 steps per chunk) and at ``TrainConfig()``'s
  (16 × 512², host iterator) with MPix/s, TFLOP/s against the H100's 989,
  the host's share and peak memory (``experiments/train_step_times.py``);
  then the quick-start chain ``make_dataset`` (4 × 1200²) → ``build_features
  --detector rg`` → ``train_model --weak-labels`` (40 steps of 16 × 512²,
  then resumed to 60; K1 and K3 must launch while it labels, one weak-label
  granule must equal its ``--device cpu`` labels, the metrics CSV must
  continue) → ``predict_model`` plain, ``--fused`` and ``--int8``, and
  evals of the trained weights through K6 and K7 before and after one more
  step against the plain eval;
* curation and evaluation, on the chain's root and trained checkpoint:
  ``select --decisions`` keeping every plume, ``prepare_model_data``
  (device masks) and the uncurated hull fills; ``evaluate_model`` plain
  with ``--bootstrap``, ``--objects --min-size 100``, ``--sweep-threshold
  obj_f1`` and ``--sweep-threshold --write-threshold`` (the plume
  components labelled by K2, one launch per sample and threshold set, the
  counts held against scipy's labels on the host and, at one threshold,
  K2's plain version); a ``use_mega`` copy evaluated through K7 at tile
  96 against the plain forward; ``train_model --curated --distill-from``
  a ``use_pallas`` copy (K6 relabels) ``--distill-tta --distill-calibrate``
  reading the written ``threshold.json``, one sample's relabelling held
  against the plain teacher's; and ``predict_model`` serving the
  calibrated threshold;
* the streams (after the int8 serving path; its training side after the
  training phase): ``predict_model`` over the four 2048² granules through
  the decode pool and the stager for the plain, ``--fused`` and ``--int8``
  forwards, each bit for bit against the serial split (decode, upload,
  forward, readback, write one after the other), with the host's cores and
  the decode workers; ``--quantize``, ``--quantize-output`` and both
  against the plain stream within the JAX package's bounds, with the
  bytes uploaded and read back per granule (half and a quarter of fp32);
  ``--tta --tile 96`` over the plain, ``--fused``, ``--int8`` and
  ``use_mega`` forwards against the mean of 8 explicit view forwards
  within the serving gate, every kernel launched once per forward as
  without the flag, with peak memory; the 16 × 512² training step through
  the prefetched stream and the serial one; ``quantize_transfer`` on the
  host stream and card-resident against the float runs within the JAX
  package's bounds; ``build_features --detector rg`` on the decode pool
  against the serial decode;
* UNet++ (``UNetConfig(arch="unetpp", deep_supervision=True)``: base 32,
  depth 4, last): Q1 at the 30 convs of its int8 forward (the dense
  concats' first sources joined by one ``torch.cat``, timed too) and Q2 at
  its 10 upsamples against their plain versions, bit for bit, at 128 tiles
  of 288², queued beside their bounds; its int8 forward on the card against
  the CPU's, every int8 plane equal, Q1 30 and Q2 10 launches, timed beside
  the plain bf16 UNet++ forward; ``make_dataset`` then ``train_model --arch
  unetpp --deep-supervision --weak-labels`` for 40 steps of 16 × 512² (K1
  and K3 label; the last 20 steps' rate, TFLOP/s, peak memory, the
  recorded config); the trained checkpoint served over two 2048² granules
  plain, ``--int8`` (masks flip under 1% against plain), ``--prune-level
  4`` (bit for bit the unpruned call), ``--prune-level 2`` and ``--int8
  --prune-level 2`` (Q1 12 and Q2 3 launches per forward), and
  ``--fused``, which must exit 1;
* the host modules (after the streams and the curation phase): the
  native codecs against numpy, bit for bit, on the four 2048² serving
  granules (uint16) and a 512² mask (uint8), each timed per granule, and
  the streams' ``--quantize`` calls on them; ``StageTimes`` around one K6
  forward of 128 × 288² (at least its CUDA-event time) and
  ``profile_trace`` of one, whose trace must hold its 9 K6 kernels; ``checked``
  around a K6 forward of 8 tiles (a NaN pixel raises naming the op);
  ``report`` on the training chain's root (its Training, Predictions,
  Evaluation and Serving calibration sections); ``build_features
  --plot`` (without matplotlib: exit 1 before any launch); ``entry()``
  against ``entry(device="cpu")`` on a seeded batch;
* the mesh (``parallel_phase``, last): a 2-slot data mesh (two distinct
  cards where there are two, else two replicas or ranks on ``cuda:0``):
  ``make_batch_infer_sharded`` of the four 2048² granules at G = 2 a slot
  for the plain, ``use_pallas`` (K6), ``use_mega`` (K7, tile 96) and int8
  (Q1, Q2) forwards against the one-device program (the serving gate; K6
  9, K7 1, Q1 18, Q2 4 launches per forward per replica), each slot's
  share alone; ``make_sharded_infer`` of a 1024² raster on a (1, 2, 2)
  grid against the unsharded forward inside the border's receptive field
  and at the seams; ``batch_identify_sharded`` of three 1200² bench scenes
  (padded to four) against the single-scene sweep (K1 and K3 once a
  scene); two ranks' train steps (gloo on one card, NCCL on two) against
  the one-process step in bf16 at 16 × 512² and in float64 compute at
  16 × 256²; on one card, the device-count refusals of ``predict_model
  --mesh-devices 2`` and ``train_model --data-parallel 2``.

Every kernel's time stands beside its bound: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
or its operations over the card's peak rate for their type, whichever is
larger, at the data sheet's rates and again at the copy rate measured in
this run. Any failed check raises; there is no CPU fallback. The last line
of standard output is ``{"ok": true, "device": {...}}``; the line before it
is the kernel table as JSON. Details also go to ``chip_smoke.json`` in the
output directory that :func:`main` makes.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import importlib.util
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

import torch.nn.functional as F  # noqa: E402

from plumekit_torch import cli, cuda_build  # noqa: E402
from plumekit_torch.config import InferConfig, UNetConfig  # noqa: E402
from plumekit_torch.infer.sliding import (  # noqa: E402
    _effective_batch, make_multi_granule_infer, tile_grid)
from plumekit_torch.infer.streaming import (  # noqa: E402
    decode_granule_channels)
from plumekit_torch.io.granule import (  # noqa: E402
    Granule, load_granule, save_granule)
from plumekit_torch.models import build_model  # noqa: E402
from plumekit_torch.models.fused_forward import make_fused_apply  # noqa: E402
from plumekit_torch.experiments import (  # noqa: E402
    ccl_pass_times, mega_stage_times, scalar_gather_probe)
from plumekit_torch.models.kernels import (  # noqa: E402
    conv_tiles, fused_conv, unet_mega)
from plumekit_torch.train.checkpoint import (  # noqa: E402
    load_model_config, save_model_config, save_weights)
from plumekit_torch.config.identify import (  # noqa: E402
    BasicIdentifyConfig, GaussianIdentifyConfig, RGIdentifyConfig)
from plumekit_torch.geo.sinusoidal import (  # noqa: E402
    grid_from_extent, wgs84_to_sinusoidal)
from plumekit_torch.identify import basic, gaussian, pipeline, rg  # noqa: E402
from plumekit_torch.io.synthetic import (  # noqa: E402
    SyntheticSceneConfig, make_fire_table, make_scene, write_fire_csv)
from plumekit_torch.ops.kernels import ccl_sweep, label_counts  # noqa: E402
from plumekit_torch.ops.morphology import binary_opening_cross  # noqa: E402
from plumekit_torch.config import DataConfig, TrainConfig  # noqa: E402
from plumekit_torch.experiments import train_step_times  # noqa: E402
from plumekit_torch.experiments import int8_conv_times  # noqa: E402
from plumekit_torch.models.kernels import (  # noqa: E402
    int8_conv, int8_upsample)
from plumekit_torch.models.quantized_forward import (  # noqa: E402
    make_quantized_apply, quantize_unet, qvars_to)
from plumekit_torch.train.data import (  # noqa: E402
    make_synthetic_dataset, tile_batches, weak_label_mask, weak_label_scene)
from plumekit_torch.models.flops import model_flops_per_pixel  # noqa
from plumekit_torch.models.losses import dice_bce_loss  # noqa: E402
from plumekit_torch.train.state import create_state, make_schedule  # noqa
from plumekit_torch.train.step import (  # noqa: E402
    make_train_step, step_generator)
from plumekit_torch.infer import streaming, tta  # noqa: E402
from plumekit_torch.infer import tune as tune_mod  # noqa: E402
from plumekit_torch.io import prefetch, viirs_aod  # noqa: E402
from plumekit_torch.infer import export as export_mod  # noqa: E402
from plumekit_torch.train.loop import train as train_loop  # noqa: E402
from plumekit_torch.config import MeshConfig  # noqa: E402
from plumekit_torch.experiments import data_parallel_steps  # noqa: E402
from plumekit_torch.identify.batch import batch_identify_sharded  # noqa
from plumekit_torch.identify.locate import fire_bucket  # noqa: E402
from plumekit_torch.infer import (  # noqa: E402
    choose_halo, make_batch_infer_sharded, make_sharded_infer)
from plumekit_torch.models import receptive_field, replicate_model  # noqa
from plumekit_torch.parallel import make_mesh, shard  # noqa: E402
from plumekit_torch import native  # noqa: E402
from plumekit_torch.entry import entry as port_entry  # noqa: E402
from plumekit_torch.native import build as native_build  # noqa: E402
from plumekit_torch.ops import quant  # noqa: E402
from plumekit_torch.utils import (  # noqa: E402
    StageTimes, checked, profile_trace)
from plumekit_torch.utils import timers  # noqa: E402
from plumekit_torch.viz import matplotlib_present  # noqa: E402

SEED = 0
DEV = torch.device("cuda")
ICFG = InferConfig()                  # tile 288, overlap 32, 64 tiles/batch
GRANULES, GRANULE_PX = 4, 2048
BATCH_GRANULES = 2                    # predict_model's default
# K6 vs plain: |got - ref| <= ATOL + RTOL * |ref|. Both round the conv1
# output and the result to bf16 from fp32 sums taken in another order, so a
# value may land one bf16 step (2^-7 relative) away; 2^-6 allows two.
ATOL = RTOL = 2.0 ** -6
# fused vs plain forward (bf16, BN folded vs not, 18 convs deep): the
# repo's own bound for the fused replay (tests/test_fused_forward.py:68-72)
LOGIT_RTOL, LOGIT_MIN_CORR = 5e-2, 0.999
PROB_ATOL = 5e-2                      # fused vs plain served probabilities
# megakernel serving: the tile the JAX package's megakernel admits at
# UNetConfig() (its larger tiles fall through to XLA there)
MEGA = InferConfig(tile_size=96, overlap=32)
# K7 vs its plain version: both round to bf16 at the same 22 points from
# fp32 sums taken in another order; a flipped rounding spreads through the
# convs after it, so 2% of the largest logit and correlation > 0.999.
# That bound alone would pass a kernel that rounded the last decoder block
# to bf16 before the head (the flips upstream move the logits more than
# that rounding does), so the kernel's distance to the plain version is also
# projected on what that rounding does to the plain version's logits: 0 for
# a head that reads fp32, 1 for one that reads the rounded block, apart from
# the flips' share, which falls with the square root of the logits' count
MEGA_RTOL = 2e-2
MEGA_HEAD_ROUNDING_SHARE = 0.25
# K7's fp32 body vs its plain version in fp32 (TF32 off in both): the same
# arithmetic, sums in another order
MEGA_F32_RTOL, MEGA_F32_MIN_CORR = 1e-3, 0.99999
PROBE_SIZE, PROBE_LOOKUPS = 1024, 1024   # the gather probe's defaults
TRAIN_TIMED_STEPS = 20                # per geometry, after 5 warm-up steps

RG = RGIdentifyConfig()               # T = 20 thresholds 1.0 .. 0.05
THRESHOLDS = np.asarray(RG.thresholds, np.float32)
# the identify benchmark's scene (bench.py:267-271): 1200², 9 plumes
BENCH_SCENE = ccl_pass_times.BENCH_SCENE
# K1, K2 and K3 are timed with this many launches per pair of CUDA events,
# so that the wrapper's host time per call stays out of the reading
QUEUED = ccl_pass_times.QUEUED
FEATURE_GRANULES = 4
# at 8192² only this many plumes carry fires: locating a fire scans the
# whole lat/lon grid on the host (about half a second each there, 80% of a
# run: 64 took 37 s a run, 32 about 21 s)
SWATH_FIRES = 16
# K1 and K3 are integer results: kernel and plain version must be equal.
# build_features on the card vs on the CPU: integer columns and masks
# exact; the in-plume AOD mean and sd are float32 sums taken in another
# order on the two devices, so rtol 1e-5
FLOAT_COLUMNS = ("plume_aod_mean", "plume_aod_sd")
FEATURE_RTOL = 1e-5
BASIC = BasicIdentifyConfig()         # one mask at AOD >= 0.2, win_half 10
GAUSS = GaussianIdentifyConfig()      # 3 sets of 25 thresholds, 64 raw fires
# the basic detector's scenes: the bench scene over a clean background
# (tests/test_identify_basic_parity.py's statistics), since its one mask at
# AOD >= 0.2 percolates over the bench scene's background of 0.2
BASIC_SCENE = ccl_pass_times.BASIC_SCENE
# the gaussian scenes: the bench scene with two orbit layers, null blobs
# and 7-9 fires at every plume (over the detector's 20-fire gate)
GAUSS_SCENE = dict(BENCH_SCENE, n_layers=2, null_blobs=3)
# the data sheet's rates of an H100 SXM at its 700 W limit: device memory,
# dense bf16 in the tensor cores, 32-bit arithmetic outside them (taken
# for K3's integer compares too)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_32BIT_OPS_PER_S = 67e12


def bound(n_bytes, n_ops=0, ops_per_s=PEAK_32BIT_OPS_PER_S):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` or to do ``n_ops`` operations, whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def measured_copy_rate():
    """Bytes per second of a 1 GiB device-to-device copy (read plus
    write): the memory rate this card reaches in this run."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src))
    return 2 * src.numel() / (ms / 1e3)


def block_shapes(cfg: UNetConfig, tile: int):
    """(Cin, Cmid, Cout, H) of the 2·depth + 1 double-conv blocks."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    enc = [((cfg.in_channels if i == 0 else f[i - 1]), f[i], f[i], tile >> i)
           for i in range(cfg.depth)]
    mid = [(f[cfg.depth - 1], f[cfg.depth], f[cfg.depth], tile >> cfg.depth)]
    dec = [(f[i + 1], f[i], f[i], tile >> i)
           for i in reversed(range(cfg.depth))]
    return enc + mid + dec


def time_ms(fn, reps=10, warmup=2, calls=1):
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls, each
    around ``calls`` calls of ``fn`` and divided by them (with many, the
    launches queue up and the host's time per call stays out)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def plain_bf16_double_conv(x, w1, s1, b1, w2, s2, b2):
    """The same block as cuDNN bf16 convs in channels-last layout, as the
    plain forward runs them: the speed reference."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w1, padding=1)
    y = torch.relu(y * s1[:, None, None] + b1[:, None, None])
    y = F.conv2d(y, w2, padding=1)
    return torch.relu(y * s2[:, None, None] + b2[:, None, None]) \
        .permute(0, 2, 3, 1)


def tile_of(tile):
    """What the kernel table says of a tile the rule picked."""
    return {"path": tile.path, "tile": [tile.th, tile.tw, tile.images],
            "fill": tile.fill, "smem": tile.smem}


def block_inputs(rng, b, h, w, cin, cmid, cout):
    """Seeded bf16 inputs of one double-conv block on the card: (x, w1, s1,
    b1, w2, s2, b2), the weights at He scale; x is drawn on the card by a
    generator seeded from ``rng`` (a 256-tile plane takes seconds through
    numpy on the host)."""
    def bf(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(DEV).to(torch.bfloat16)

    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**62)))
    x = torch.randn((b, h, w, cin), generator=gen, device=DEV,
                    dtype=torch.float32).to(torch.bfloat16)
    w1 = bf(3, 3, cin, cmid, scale=(2.0 / (9 * cin)) ** 0.5)
    w2 = bf(3, 3, cmid, cout, scale=(2.0 / (9 * cmid)) ** 0.5)
    s1 = torch.from_numpy(rng.uniform(0.5, 1.5, cmid).astype(np.float32)
                          ).to(DEV).bfloat16()
    s2 = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)
                          ).to(DEV).bfloat16()
    b1, b2 = bf(cmid, scale=0.1), bf(cout, scale=0.1)
    return (x, w1, s1, b1, w2, s2, b2)


def check_kernel(rng, batch):
    """K6 vs its plain version at every block shape of the serving tile
    (288) and of the megakernel's tile (96), timed on weights packed once
    beside cuDNN, and at ragged and tiny planes for every tile geometry and
    image grouping the rule picks: one image, a batch that is no multiple of
    the group, planes smaller than a tile, unaligned and odd channels. Two
    runs of the kernel must be equal bit for bit."""
    cases = [(cin, cmid, cout, h, h, batch, str(tile))
             for tile in (ICFG.tile_size, MEGA.tile_size)
             for cin, cmid, cout, h in block_shapes(UNetConfig(), tile)]
    cases += [(5, 32, 32, 37, 29, 3, "ragged"),        # mma.sync, ragged
              (64, 256, 256, 29, 21, 3, "ragged"),     # wgmma, ragged tiles
              (5, 200, 40, 37, 29, 2, "ragged"),
              (2, 512, 130, 6, 6, 3, "ragged"),        # 2 images a block, B=3
              (512, 512, 37, 3, 5, 1, "ragged"),       # 4 a block, B=1, odd
              (64, 128, 128, 18, 18, 1, "ragged")]
    rows = []
    for cin, cmid, cout, h, w, b, kind in cases:
        args = block_inputs(rng, b, h, w, cin, cmid, cout)
        x, w1, s1, b1, w2, s2, b2 = args
        got = fused_conv.fused_double_conv3x3_bn_relu(*args)
        torch.cuda.synchronize()
        packed = fused_conv.pack_double_conv(*args[1:])
        if not torch.equal(
                fused_conv.fused_double_conv3x3_bn_relu_packed(x, packed),
                got):
            raise AssertionError("K6: two runs differ")
        ref = fused_conv.double_conv3x3_bn_relu_ref(*args)
        err = (got.float() - ref.float()).abs()
        tol = ATOL + RTOL * ref.float().abs()
        worst = float((err / tol).max())
        max_abs = float(err.max())
        tile = conv_tiles.double_conv_tile(h, w, cin, cmid, cout)
        row = {"cin": cin, "cmid": cmid, "cout": cout, "h": h, "w": w,
               "batch": b, "set": kind, "max_abs_err": max_abs,
               "err_over_bound": worst, **tile_of(tile)}
        if b == batch:
            pw1 = w1.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            pw2 = w2.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            # the kernel alone: weights packed once, as the fused forward
            # holds them; beside it the raw-weight entry, which packs per call
            row["ms"] = time_ms(
                lambda: fused_conv.fused_double_conv3x3_bn_relu_packed(
                    x, packed))
            row["wrapper_ms"] = time_ms(
                lambda: fused_conv.fused_double_conv3x3_bn_relu(*args))
            row["plain_ms"] = time_ms(lambda: plain_bf16_double_conv(
                x, pw1, s1, b1, pw2, s2, b2))
            row["ref_fp32_ms"] = time_ms(
                lambda: fused_conv.double_conv3x3_bn_relu_ref(*args), reps=3)
            row["ops"] = 2 * 9 * b * h * w * (cin * cmid + cmid * cout)
            row["bytes"] = sum(a.numel() * a.element_size() for a in args) \
                + got.numel() * got.element_size()
            row["bound_ms"], row["bound_by"] = bound(
                row["bytes"], row["ops"], PEAK_BF16_OPS_PER_S)
            row["tflops"] = row["ops"] / row["ms"] / 1e9
        rows.append(row)
        print(f"K6 {cin:>3}->{cmid:>3}->{cout:>3} {b:>3}x{h}x{w} "
              f"[{tile.path} {tile.th}x{tile.tw}x{tile.images}, fill "
              f"{tile.fill:.2f}]: max|err| {max_abs:.4g} (err/bound "
              f"{worst:.3f})"
              + (f", kernel {row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s; "
                 f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}; with "
                 f"packing {row['wrapper_ms']:.3f}), cuDNN bf16 "
                 f"{row['plain_ms']:.3f} ms, fp32 ref "
                 f"{row['ref_fp32_ms']:.3f} ms" if "ms" in row else ""),
              flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{row}: tolerance {ATOL} + {RTOL}*|ref|")
        del x, got, ref, err, tol, args, packed
    return rows


def seeded_unet(generator, cfg=UNetConfig()):
    """``cfg`` (UNetConfig() by default) with seeded random weights at He
    scale and nontrivial BatchNorm parameters and running statistics."""
    model = build_model(cfg, generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.mul_(2.0 ** 0.5)
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
                m.bias.copy_(0.1 * torch.randn(n, generator=generator))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
                m.running_var.copy_(torch.rand(n, generator=generator) * 1.5
                                    + 0.5)
    return model.to(DEV).eval()


def synthetic_channels(rng, n):
    """n (H, W) float32 AOD planes: a smooth background, noise and a few
    Gaussian plumes."""
    yy, xx = np.mgrid[0:GRANULE_PX, 0:GRANULE_PX].astype(np.float32)
    out = []
    for _ in range(n):
        aod = (0.15 + 0.05 * np.sin(xx / 300.0 + rng.uniform(0, 6))
               + 0.02 * rng.standard_normal(xx.shape, dtype=np.float32))
        for _ in range(4):
            cy, cx = rng.uniform(0.1 * GRANULE_PX, 0.9 * GRANULE_PX, 2)
            sy, sx = rng.uniform(20, 120, 2)
            aod += rng.uniform(0.5, 2.0) * np.exp(
                -((yy - cy) ** 2 / (2 * sy**2) + (xx - cx) ** 2 / (2 * sx**2)))
        out.append(aod.astype(np.float32))
    return out


def check_forward(model, rng):
    """Fused vs plain forward on a 64-tile 288² batch; K6 launches once per
    block."""
    plane = synthetic_channels(rng, 1)[0]
    t = ICFG.tile_size
    starts = tile_grid(GRANULE_PX, t, t - ICFG.overlap)[:8]
    tiles = [plane[y:y + t, x:x + t] for y in starts for x in starts]
    x = np.stack([np.stack([p, np.zeros_like(p)], -1) for p in tiles])
    x = torch.from_numpy(x).to(DEV)
    fused = make_fused_apply(model.cfg)
    with torch.inference_mode():
        before = fused_conv.LAUNCHES
        got = fused(model, x)
        launches = fused_conv.LAUNCHES - before
        ref = model(x)
        fwd_ms = time_ms(lambda: fused(model, x))
        plain_ms = time_ms(lambda: model(x))
    if launches != 2 * model.cfg.depth + 1:
        raise AssertionError(f"fused forward launched K6 {launches} times")
    g, r = got.float().cpu().numpy().ravel(), ref.float().cpu().numpy().ravel()
    if not (np.isfinite(g).all() and got.shape == (len(tiles), t, t, 1)):
        raise AssertionError("fused forward: non-finite or misshapen logits")
    max_diff = float(np.abs(g - r).max())
    corr = float(np.corrcoef(g, r)[0, 1])
    scale = float(np.abs(r).max())
    print(f"forward {len(tiles)}x{t}^2: max|fused - plain| {max_diff:.4g} of max|logit|"
          f" {scale:.4g}, corr {corr:.6f}; fused {fwd_ms:.2f} ms, plain "
          f"{plain_ms:.2f} ms", flush=True)
    if not (max_diff <= LOGIT_RTOL * scale and corr > LOGIT_MIN_CORR):
        raise AssertionError("fused and plain forward disagree")
    return {"max_abs_diff": max_diff, "max_abs_logit": scale, "corr": corr,
            "fused_ms": fwd_ms, "plain_ms": plain_ms, "launches": launches}


def serve(root, *flags):
    argv = ["predict_model", "--root", root, *flags]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"predict_model {argv} exited {rc}")
    out = os.path.join(root, "processed", "predictions")
    preds = {}
    for i in range(len(os.listdir(os.path.join(
            root, "raw", "plume_identification", "maiac")))):
        with np.load(os.path.join(out, f"g{i}_pred.npz")) as d:
            probs, mask, th = d["probs"], d["mask"], float(d["threshold"])
        if probs.shape != (GRANULE_PX, GRANULE_PX) or \
                not np.isfinite(probs).all() or probs.min() < 0 or \
                probs.max() > 1:
            raise AssertionError(f"g{i}: bad probs {probs.shape}")
        if not np.array_equal(mask, probs > th):
            raise AssertionError(f"g{i}: mask != probs > threshold")
        preds[f"g{i}"] = probs
    return secs, preds


def serving_split(root, model, out_dir, apply_fn, icfg, label,
                  variables=None):
    """Seconds per layer of the serving loop of one forward, run serially
    (decode, upload, sliding inference, readback, write, each step
    synchronised so that it is timed on its own); ``variables`` (default
    ``model``) go to ``apply_fn``."""
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    paths = [os.path.join(maiac, f) for f in sorted(os.listdir(maiac))]
    infer = make_multi_granule_infer(apply_fn, icfg)
    split = dict.fromkeys(["decode", "upload", "infer", "readback", "write"],
                          0.0)

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] += time.perf_counter() - t0
        return out

    with torch.inference_mode():
        for i in range(0, len(paths), BATCH_GRANULES):
            group = [timed("decode", lambda p=p: decode_granule_channels(
                p, model.cfg.depth)) for p in paths[i:i + BATCH_GRANULES]]
            x = timed("upload", lambda: torch.from_numpy(
                np.stack([c for _, c, _ in group])).to(DEV))
            probs, _ = timed("infer", lambda: infer(
                model if variables is None else variables, x))
            probs = timed("readback", lambda: probs.cpu().numpy())
            for j, (name, _c, (h, w)) in enumerate(group):
                timed("write", lambda: cli._write_prediction(
                    out_dir, name, probs[j, :h, :w]))
    total = sum(split.values())
    print(f"{label} serving split (s): " + ", ".join(
        f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in split.items()),
        flush=True)
    return split


def serving_root(model, rng, tmp, n=GRANULES):
    """A root of ``n`` synthetic 2048² granules and the model's
    checkpoint."""
    root = os.path.join(tmp, "root")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    lat, lon = np.meshgrid(np.linspace(30, 40, GRANULE_PX, dtype=np.float32),
                           np.linspace(-120, -110, GRANULE_PX,
                                       dtype=np.float32), indexing="ij")
    for i, aod in enumerate(synthetic_channels(rng, n)):
        save_granule(os.path.join(maiac, f"g{i}.npz"),
                     Granule({"2020001A": aod}, lat, lon, name=f"g{i}"))
    ckpt = os.path.join(root, "models", "checkpoints")
    save_model_config(ckpt, model.cfg)
    save_weights(ckpt, model)
    return root


def serving_geometry(icfg, n=GRANULES):
    """(tiles per granule, forwards of one call over ``n`` granules), from
    the serving geometry itself."""
    n_tiles, per_group, _ = geometry_forwards(tune_mod.Geometry(
        icfg.tile_size, icfg.overlap, icfg.batch_tiles, BATCH_GRANULES))
    return n_tiles, -(-n // BATCH_GRANULES) * per_group


def compare_served(got, want):
    """(max |dp|, share of mask flips, flips where the second is sure)."""
    max_dp, flips, confident_flips = 0.0, 0, 0
    for k in got:
        p, q = got[k], want[k]
        max_dp = max(max_dp, float(np.abs(p - q).max()))
        flip = (p > 0.5) != (q > 0.5)
        flips += int(flip.sum())
        confident_flips += int((flip & (np.abs(q - 0.5) > PROB_ATOL)).sum())
    return max_dp, flips / sum(p.size for p in got.values()), \
        confident_flips


def main_path(model, root, tmp):
    """predict_model over 4 granules of 2048², fused then plain."""
    n_tiles, forwards = serving_geometry(ICFG)
    mpix = GRANULES * GRANULE_PX**2 / 1e6

    fused_conv.LAUNCHES = 0
    fused_s, fused_preds = serve(root, "--fused")
    launches = fused_conv.LAUNCHES
    if launches != 9 * forwards or launches == 0:
        raise AssertionError(f"K6 launched {launches} times for {forwards} "
                             "forwards of 9 blocks")
    plain_s, plain_preds = serve(root)

    max_dp, share, confident_flips = compare_served(fused_preds, plain_preds)

    split_dir = os.path.join(tmp, "split")
    os.makedirs(split_dir)
    split = serving_split(root, model, split_dir, make_fused_apply(model.cfg),
                          ICFG, "fused")

    # the forwards alone, at the main path's batch (G granules x tiles)
    x = torch.rand((BATCH_GRANULES * n_tiles, ICFG.tile_size, ICFG.tile_size,
                    2), generator=torch.Generator().manual_seed(SEED)).to(DEV)
    fused = make_fused_apply(model.cfg)
    with torch.inference_mode():
        fused_fwd = time_ms(lambda: fused(model, x), reps=5)
        plain_fwd = time_ms(lambda: model(x), reps=5)
    res = {"granules": GRANULES, "granule_px": GRANULE_PX,
           "forwards": forwards, "k6_launches": launches,
           "fused_s": [fused_s], "plain_s": [plain_s],
           "fused_mpix_s": [mpix / fused_s], "plain_mpix_s": [mpix / plain_s],
           "fused_forward_ms": fused_fwd, "plain_forward_ms": plain_fwd,
           "fused_forward_mpix_s": mpix / (forwards * fused_fwd / 1e3),
           "plain_forward_mpix_s": mpix / (forwards * plain_fwd / 1e3),
           "max_abs_dprobs": max_dp, "mask_flip_share": share,
           "confident_flips": confident_flips, "fused_split_s": split,
           # for the export phase; popped before the JSON record
           "preds": {"plain": plain_preds, "use_pallas": fused_preds}}
    print(f"predict_model {GRANULES}x{GRANULE_PX}^2: K6 launches {launches} "
          f"({forwards} forwards x 9); whole call fused "
          f"{res['fused_mpix_s'][0]:.2f} MPix/s, plain "
          f"{res['plain_mpix_s'][0]:.2f} MPix/s; forwards alone fused "
          f"{res['fused_forward_mpix_s']:.1f}, "
          f"plain {res['plain_forward_mpix_s']:.1f} MPix/s; max|dprobs| "
          f"{max_dp:.4g}, mask flips {share:.3e} ({confident_flips} with "
          f"|p_plain - 0.5| > {PROB_ATOL})", flush=True)
    if max_dp > PROB_ATOL or confident_flips:
        raise AssertionError("fused and plain serving disagree")
    return res


# --------------------------------------------- megakernel serving: K7, K5, P1

def conv_shapes(cfg: UNetConfig, tile: int):
    """(Cin, Cout, H) of the 2·(2·depth + 1) single convs of the net."""
    return [shape for cin, cmid, cout, h in block_shapes(cfg, tile)
            for shape in ((cin, cmid, h), (cmid, cout, h))]


def check_single_conv(rng, batch):
    """K5 vs its plain version at every conv shape of the flagship net at
    the megakernel tile, timed on weights packed once beside one cuDNN bf16
    convolution with scale, shift and ReLU, and at ragged and tiny planes
    for every tile geometry and image grouping the rule picks. Two runs of
    the kernel must be equal bit for bit."""
    cases = [(cin, cout, h, h, batch)
             for cin, cout, h in conv_shapes(UNetConfig(), MEGA.tile_size)]
    cases += [(5, 40, 37, 29, 3),           # mma.sync, ragged
              (64, 96, 21, 29, 3),          # wgmma, ragged tiles
              (512, 512, 6, 6, 3),          # 4 images a block, B = 3
              (2, 129, 3, 5, 1),            # 7 a block, B = 1, odd Cout
              (256, 200, 18, 18, 5)]
    rows = []
    launches = 0
    for cin, cout, h, w, b in cases:
        def bf(*shape, scale=1.0):
            a = rng.standard_normal(shape, dtype=np.float32) * scale
            return torch.from_numpy(a).to(DEV).to(torch.bfloat16)

        x = bf(b, h, w, cin)
        wt = bf(3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        sc = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)
                              ).to(DEV).bfloat16()
        sh = bf(cout, scale=0.1)
        args = (x, wt, sc, sh)
        before = fused_conv.SINGLE_LAUNCHES
        got = fused_conv.fused_conv3x3_bn_relu(*args)
        torch.cuda.synchronize()
        # one launch per call of the entry; the net's shapes are counted
        if fused_conv.SINGLE_LAUNCHES != before + 1:
            raise AssertionError("K5: not one launch per call")
        launches += b == batch
        packed = fused_conv.pack_single_conv(wt, sc, sh)
        if not torch.equal(fused_conv.fused_conv3x3_bn_relu_packed(x, packed),
                           got):
            raise AssertionError("K5: two runs differ")
        ref = fused_conv.conv3x3_bn_relu_ref(*args)
        err = (got.float() - ref.float()).abs()
        tol = ATOL + RTOL * ref.float().abs()
        worst = float((err / tol).max())
        tile = conv_tiles.single_conv_tile(h, w, cin, cout)
        row = {"cin": cin, "cout": cout, "h": h, "w": w, "batch": b,
               "max_abs_err": float(err.max()), "err_over_bound": worst,
               **tile_of(tile)}
        if b == batch:
            pw = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library():
                y = F.conv2d(x.permute(0, 3, 1, 2), pw, padding=1)
                return torch.relu(y * sc[:, None, None] + sh[:, None, None])

            row["ms"] = time_ms(
                lambda: fused_conv.fused_conv3x3_bn_relu_packed(x, packed))
            row["wrapper_ms"] = time_ms(
                lambda: fused_conv.fused_conv3x3_bn_relu(*args))
            row["library_ms"] = time_ms(library)
            row["plain_ms"] = time_ms(
                lambda: fused_conv.conv3x3_bn_relu_ref(*args), reps=3)
            row["ops"] = 2 * 9 * b * h * w * cin * cout
            row["bytes"] = sum(a.numel() * a.element_size() for a in args) \
                + got.numel() * got.element_size()
            row["bound_ms"], row["bound_by"] = bound(
                row["bytes"], row["ops"], PEAK_BF16_OPS_PER_S)
            row["tflops"] = row["ops"] / row["ms"] / 1e9
        rows.append(row)
        print(f"K5 {cin:>3}->{cout:>3} {b:>3}x{h}x{w} [{tile.path} "
              f"{tile.th}x{tile.tw}x{tile.images}, fill {tile.fill:.2f}]: "
              f"max|err| {row['max_abs_err']:.4g} (err/bound {worst:.3f})"
              + (f", kernel {row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s;"
                 f" bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
                 f"with packing {row['wrapper_ms']:.3f}), "
                 f"cuDNN bf16 {row['library_ms']:.3f} ms, fp32 ref "
                 f"{row['plain_ms']:.3f} ms" if "ms" in row else ""),
              flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"{row}: tolerance {ATOL} + {RTOL}*|ref|")
        del x, got, ref, err, tol, args, packed
    return rows, launches


def mega_tiles(rng, n, tile):
    """n (tile, tile, 2) model inputs cut from a synthetic granule on the
    serving stride: AOD and an empty fire channel."""
    plane = synthetic_channels(rng, 1)[0]
    starts = tile_grid(GRANULE_PX, tile, tile - MEGA.overlap)
    side = int(math.ceil(n ** 0.5))
    tiles = [plane[y:y + tile, x:x + tile]
             for y in starts[:side] for x in starts[:side]]
    tiles = (tiles * -(-n // len(tiles)))[:n]     # a coarse grid repeats
    return torch.from_numpy(np.stack(
        [np.stack([p, np.zeros_like(p)], -1) for p in tiles])).to(DEV)


def compare_logits(name, got, ref, rtol, min_corr=LOGIT_MIN_CORR):
    g, r = got.float().cpu().numpy().ravel(), ref.float().cpu().numpy().ravel()
    if not (np.isfinite(g).all() and got.shape == ref.shape):
        raise AssertionError(f"{name}: non-finite or misshapen logits")
    max_diff, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
    corr = float(np.corrcoef(g, r)[0, 1])
    if not (max_diff <= rtol * scale and corr > min_corr):
        raise AssertionError(
            f"{name}: max|diff| {max_diff:.4g} of max|logit| {scale:.4g} "
            f"(allowed {rtol}), corr {corr:.6f}")
    return {"max_abs_diff": max_diff, "max_abs_logit": scale, "corr": corr}


def check_mega(model, rng, batch):
    """K7 vs its plain version and vs the cuDNN forward: the flagship net
    over the main path's batch of 96² tiles and over one tile, the same net
    with the weights of three other seeds over 8 tiles, and a base-8 depth-3
    net over 64 × 48 inputs; timed at the main path's batch beside
    the cuDNN and the K6 forward, and at 288² tiles; stage by stage against
    the plain version of each stage at both tiles; the fp32 body over the
    main path's batch against the plain version in fp32."""
    apply = unet_mega.make_mega_apply(model.cfg)
    fused = make_fused_apply(model.cfg)
    x = mega_tiles(rng, batch, MEGA.tile_size)
    small_cfg = UNetConfig(base_features=8, depth=3)
    small = build_model(small_cfg, torch.Generator().manual_seed(SEED + 1)
                        ).to(DEV).eval()
    t = MEGA.tile_size
    cases = [(f"{batch}x{t}^2", model, apply, x),
             (f"1x{t}^2", model, apply, x[:1]),
             *[(f"8x{t}^2, weights of seed {seed}",
                seeded_unet(torch.Generator().manual_seed(seed)), apply, x[:8])
               for seed in (SEED + 2, SEED + 3, SEED + 4)],
             ("2x64x48 base 8 depth 3", small,
              unet_mega.make_mega_apply(small_cfg), torch.from_numpy(
                  rng.standard_normal((2, 64, 48, 2), dtype=np.float32)
              ).to(DEV))]
    res = {"cases": {}}
    with torch.inference_mode():
        for name, net, fn, inp in cases:
            before = unet_mega.LAUNCHES
            got = fn(net, inp)
            torch.cuda.synchronize()
            if unet_mega.LAUNCHES != before + 1:
                raise AssertionError(f"K7 {name}: not one launch per forward")
            weights = unet_mega.weights_of(net, torch.bfloat16, DEV)
            ref = unet_mega.mega_forward_ref(weights.folded, inp)
            row = compare_logits(f"K7 vs plain version, {name}", got, ref,
                                 MEGA_RTOL)
            rounding = unet_mega.mega_forward_ref(
                weights.folded, inp, head_in_f32=False) - ref
            row["mean_abs_diff"] = float((got - ref).abs().mean())
            row["head_rounding_share"] = float(
                ((got - ref) * rounding).sum() / (rounding * rounding).sum())
            if not abs(row["head_rounding_share"]) <= MEGA_HEAD_ROUNDING_SHARE:
                raise AssertionError(
                    f"K7 {name}: {row['head_rounding_share']:.3f} of the "
                    "last block's rounding to bf16 shows in the logits: the "
                    "kernel's head does not read fp32")
            row["vs_cudnn_forward"] = compare_logits(
                f"K7 vs cuDNN forward, {name}", got, net(inp), LOGIT_RTOL)
            res["cases"][name] = row
            print(f"K7 {name}: max|K7 - plain version| "
                  f"{row['max_abs_diff']:.4g} of max|logit| "
                  f"{row['max_abs_logit']:.4g}, corr {row['corr']:.6f}, "
                  f"mean {row['mean_abs_diff']:.4g}, share of the last "
                  f"block's rounding {row['head_rounding_share']:.4f}; vs "
                  f"cuDNN forward {row['vs_cudnn_forward']['max_abs_diff']:.4g}",
                  flush=True)
            del got, ref, rounding
        weights = unet_mega.weights_of(model, torch.bfloat16, DEV)
        torch.cuda.reset_peak_memory_stats()
        res["ms"] = time_ms(lambda: apply(model, x))
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["cudnn_forward_ms"] = time_ms(lambda: model(x))
        res["k6_forward_ms"] = time_ms(lambda: fused(model, x))
        res["ms_again"] = time_ms(lambda: apply(model, x))
        res["plain_ms"] = time_ms(
            lambda: unet_mega.mega_forward_ref(weights.folded, x), reps=2,
            warmup=1)
        # the default serving tile, which the TPU's megakernel does not admit
        big = mega_tiles(rng, batch, ICFG.tile_size)
        res["ms_288"] = time_ms(lambda: apply(model, big), reps=3, warmup=1)
        res["cudnn_forward_ms_288"] = time_ms(lambda: model(big), reps=3,
                                              warmup=1)
        res["vs_cudnn_forward_288"] = compare_logits(
            "K7 vs cuDNN forward, 288^2", apply(model, big), model(big),
            LOGIT_RTOL)
        res["stage_check"] = {str(t): check_stages(weights, x),
                         str(ICFG.tile_size): check_stages(weights, big)}
        del big
        res["fp32"] = check_mega_fp32(model, x)
    # the forward's own table: planes reused, the bottleneck split
    _plan, scratch_elems = unet_mega._plan(
        weights.stages, *x.shape[:3],
        blocks=torch.cuda.get_device_properties(DEV).multi_processor_count)
    res["scratch_bytes"] = 2 * scratch_elems
    res["weight_bytes"] = weights.blob.numel()
    res["stages"] = len(weights.stages)
    cfg = model.cfg
    res["ops"] = mega_ops(cfg, t) * batch
    # compulsory bytes: the input and the logits once, the weights once
    res["bytes"] = x.numel() * 2 + batch * t * t * cfg.out_channels * 4 \
        + res["weight_bytes"]
    res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["ops"],
                                             PEAK_BF16_OPS_PER_S)
    res["tflops"] = res["ops"] / res["ms"] / 1e9
    print(f"K7 forward {batch}x{t}^2: {res['ms']:.3f} / {res['ms_again']:.3f} "
          f"ms ({res['tflops']:.1f} TFLOP/s; bound {res['bound_ms']:.4f} ms by"
          f" {res['bound_by']}), cuDNN forward {res['cudnn_forward_ms']:.3f} "
          f"ms, K6 forward {res['k6_forward_ms']:.3f} ms, plain version "
          f"{res['plain_ms']:.1f} ms; scratch "
          f"{res['scratch_bytes'] / 1e6:.1f} MB, weights "
          f"{res['weight_bytes'] / 1e6:.1f} MB, peak {res['peak_gb']:.2f} GB;"
          f" at {batch}x288^2 K7 {res['ms_288']:.2f} ms, cuDNN forward "
          f"{res['cudnn_forward_ms_288']:.2f} ms", flush=True)
    return res


def check_stages(weights, x):
    """Each stage of K7 (its debug form: every plane kept) against the
    plain version of that stage fed K7's own input planes, under K6's gate
    (``unet_mega.stage_errors``)."""
    xb = x.to(torch.bfloat16).contiguous()
    logits, scratch, plan = unet_mega.mega_forward_debug(weights, xb)
    torch.cuda.synchronize()
    rows = unet_mega.stage_errors(weights, xb, logits, scratch, plan)
    worst = max(v["ratio"] for r in rows for v in r.values()
                if isinstance(v, dict))
    print(f"K7 stage by stage, {xb.shape[0]}x{xb.shape[1]}^2: worst "
          f"|err| / (2^-6 + 2^-6 |ref|) per stage " + ", ".join(
              f"{r['stage']} {max(v['ratio'] for v in r.values() if isinstance(v, dict)):.3f}"
              for r in rows), flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"K7 disagrees with a stage's plain version: "
                             f"{rows}")
    del logits, scratch
    torch.cuda.empty_cache()
    return rows


def check_mega_fp32(model, x):
    """The fp32 body: ``compute_dtype="float32"`` with ``use_mega`` over the
    main path's batch, one launch, against the plain version in fp32 (TF32
    off); timed beside its operations bound at the fp32 rate."""
    cfg = dataclasses.replace(model.cfg, compute_dtype="float32",
                              use_mega=True)
    net = build_model(cfg).to(DEV).eval()
    net.load_state_dict(model.state_dict())
    before = unet_mega.LAUNCHES
    got = net(x)
    torch.cuda.synchronize()
    if unet_mega.LAUNCHES != before + 1:
        raise AssertionError("K7 fp32: not one launch per forward")
    weights = unet_mega.weights_of(net, torch.float32, DEV)
    ref = unet_mega.mega_forward_ref(weights.folded, x)
    row = compare_logits("K7 fp32 vs plain version", got, ref, MEGA_F32_RTOL,
                         MEGA_F32_MIN_CORR)
    apply = unet_mega.make_mega_apply(cfg)
    row["ms"] = time_ms(lambda: apply(net, x), reps=3, warmup=1)
    row["plain_ms"] = time_ms(
        lambda: unet_mega.mega_forward_ref(weights.folded, x), reps=2,
        warmup=1)
    row["ops"] = mega_ops(cfg, x.shape[1]) * x.shape[0]
    row["bound_ms"], row["bound_by"] = bound(
        x.numel() * 4 + x.shape[0] * x.shape[1] ** 2 * cfg.out_channels * 4
        + weights.blob.numel(), row["ops"], PEAK_32BIT_OPS_PER_S)
    print(f"K7 fp32 {x.shape[0]}x{x.shape[1]}^2: max|K7 - plain version| "
          f"{row['max_abs_diff']:.4g} of max|logit| {row['max_abs_logit']:.4g}"
          f", corr {row['corr']:.7f}; {row['ms']:.2f} ms (bound "
          f"{row['bound_ms']:.3f} ms by {row['bound_by']} at 67 TFLOP/s), "
          f"plain version {row['plain_ms']:.2f} ms", flush=True)
    del got, ref, net
    return row


def mega_ops(cfg, t):
    """Operations of one t² tile of the U-Net: every conv, transposed conv
    and the head, 2 per multiply-add."""
    ops = sum(2 * 9 * h * h * (cin * cmid + cmid * cout)
              for cin, cmid, cout, h in block_shapes(cfg, t))
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    ops += sum(2 * (t >> (i + 1)) ** 2 * f[i + 1] * 4 * f[i]
               for i in range(cfg.depth))
    return ops + 2 * t * t * f[0] * cfg.out_channels


def mega_stage_table(model, rng, batch, kernel_rows):
    """K7 stage by stage at the main path's batch of 96² tiles
    (``experiments/mega_stage_times.py``: queued prefixes and per-block
    stamps; ``--tiles 96 288`` times 288² too), beside K6 at the same block
    shape from ``check_kernel``."""
    weights = unet_mega.weights_of(model, torch.bfloat16, DEV)
    out = {}
    for tile in (MEGA.tile_size,):
        x = mega_tiles(rng, batch, tile).to(torch.bfloat16).contiguous()
        stages = mega_stage_times.stage_split_of(weights, x, reps=3)
        k6 = [r for r in kernel_rows if r["set"] == str(tile)]
        print(f"K7 by stage, {batch}x{tile}^2 (stage kind: items, waves, ms, "
              "busy share; K6 block ms): " + "; ".join(
                  f"{st['stage']} {st['kind']}: {st['items']}, "
                  f"{st['waves']:.2f}, {st['ms']:.3f}, "
                  f"{st['busy_share']:.3f}; {r['ms']:.3f}"
                  for st, r in zip(stages, k6)), flush=True)
        for st, r in zip(stages, k6):
            st["k6_ms"] = r["ms"]
        out[str(tile)] = stages
        del x
    return out


def mega_path(model, root, tmp, forward_ms):
    """The slice's path: ``predict_model --tile 96 --overlap 32
    --batch-granules 2`` over the 4 granules of 2048² from a checkpoint
    whose config says ``use_mega`` (every forward one launch of K7, K6
    never), then from the same weights without the flag (cuDNN)."""
    mega_ckpt = os.path.join(tmp, "mega_checkpoint")
    mega_cfg = dataclasses.replace(model.cfg, use_mega=True)
    save_model_config(mega_ckpt, mega_cfg)
    save_weights(mega_ckpt, model)
    flags = ["--tile", str(MEGA.tile_size), "--overlap", str(MEGA.overlap),
             "--batch-granules", str(BATCH_GRANULES)]
    n_tiles, forwards = serving_geometry(MEGA)
    mpix = GRANULES * GRANULE_PX**2 / 1e6

    unet_mega.LAUNCHES = fused_conv.LAUNCHES = 0
    mega_s, mega_preds = serve(root, *flags, "--checkpoint", mega_ckpt)
    launches = {"k7": unet_mega.LAUNCHES, "k6": fused_conv.LAUNCHES}
    if launches["k7"] != forwards or launches["k7"] == 0 or launches["k6"]:
        raise AssertionError(f"megakernel serving launched {launches} for "
                             f"{forwards} forwards")
    plain_s, plain_preds = serve(root, *flags)
    if unet_mega.LAUNCHES != forwards:
        raise AssertionError("the plain serving run launched K7")
    max_dp, share, confident_flips = compare_served(mega_preds, plain_preds)
    res = {"granules": GRANULES, "granule_px": GRANULE_PX,
           "tile": MEGA.tile_size, "overlap": MEGA.overlap,
           "tiles_per_granule": n_tiles, "forwards": forwards,
           "launches": launches,
           "mega_s": [mega_s], "plain_s": [plain_s],
           "mega_mpix_s": [mpix / mega_s], "plain_mpix_s": [mpix / plain_s],
           "forward_mpix_s": {k: mpix / (forwards * v / 1e3)
                              for k, v in forward_ms.items()},
           "max_abs_dprobs": max_dp, "mask_flip_share": share,
           "confident_flips": confident_flips, "checkpoint": mega_ckpt,
           "preds": mega_preds}
    print(f"predict_model --tile {MEGA.tile_size} --overlap {MEGA.overlap} "
          f"{GRANULES}x{GRANULE_PX}^2: K7 launches {launches['k7']} "
          f"({forwards} forwards of {BATCH_GRANULES * MEGA.batch_tiles} tiles),"
          f" K6 launches {launches['k6']}; whole call use_mega "
          f"{res['mega_mpix_s'][0]:.2f} MPix/s, plain "
          f"{res['plain_mpix_s'][0]:.2f} MPix/s; forwards alone "
          + ", ".join(f"{k} {v:.1f}" for k, v in res["forward_mpix_s"].items())
          + f" MPix/s; max|dprobs| {max_dp:.4g}, mask flips {share:.3e} "
          f"({confident_flips} with |p_plain - 0.5| > {PROB_ATOL})",
          flush=True)
    if max_dp > PROB_ATOL or confident_flips:
        raise AssertionError("megakernel and plain serving disagree")
    return res


def check_probe():
    """P1: both forms of the kernel equal to the probe's loop and to the
    plain version, then the probe's own entry point; ns per lookup."""
    h = w = PROBE_SIZE
    n = PROBE_LOOKUPS
    x_np = np.random.default_rng(SEED).integers(0, h * w, (h, w)) \
        .astype(np.int32)
    x = torch.from_numpy(x_np).to(DEV)
    want = scalar_gather_probe.numpy_loop(x_np, n)
    ref, plain_ms = timed_once(
        lambda: scalar_gather_probe.gather_probe_ref(x, n))
    wrong = int((ref.cpu().numpy() != want).sum())
    for chained in (True, False):
        got = scalar_gather_probe.gather_probe(x, n, chained)
        torch.cuda.synchronize()
        wrong += int((got != ref).sum())
    if wrong:
        raise AssertionError(f"P1: {wrong} positions differ from the loop")
    res = {"h": h, "w": w, "lookups": n, "wrong": wrong,
           "plain_ms": time_ms(
               lambda: scalar_gather_probe.gather_probe_ref(x, n)),
           "ms": time_ms(lambda: scalar_gather_probe.gather_probe(x, n)),
           "chained_lookups_ms": scalar_gather_probe.time_lookups(x, n, True),
           "parallel_lookups_ms": scalar_gather_probe.time_lookups(x, n,
                                                                    False)}
    res["chained_ns_per_lookup"] = res["chained_lookups_ms"] / n * 1e6
    res["parallel_ns_per_lookup"] = res["parallel_lookups_ms"] / n * 1e6
    # the plane read and written once, and per lookup two reads and a write
    res["bound_ms"], res["bound_by"] = bound(4 * (2 * h * w + 3 * n))
    # the probe as its user runs it
    scalar_gather_probe.CHAINED_LAUNCHES = 0
    scalar_gather_probe.PARALLEL_LAUNCHES = 0
    if scalar_gather_probe.main([]) != 0:
        raise AssertionError("the gather probe's entry point failed")
    res["launches"] = scalar_gather_probe.CHAINED_LAUNCHES \
        + scalar_gather_probe.PARALLEL_LAUNCHES
    if not (scalar_gather_probe.CHAINED_LAUNCHES
            and scalar_gather_probe.PARALLEL_LAUNCHES):
        raise AssertionError("the gather probe did not launch both forms")
    print(f"P1 {h}x{w}, {n} lookups: exact in both forms; chained "
          f"{res['chained_ns_per_lookup']:.1f} ns per lookup, parallel "
          f"{res['parallel_ns_per_lookup']:.2f} ns per lookup "
          f"({res['parallel_lookups_ms']:.4f} ms, a launch); whole probe "
          f"{res['ms']:.4f} ms (bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']}), plain {res['plain_ms']:.4f} ms", flush=True)
    return res


# --------------------------------------------- the int8 forward: Q1, Q2

# tiles of 288² per timed int8 conv and forward: the main path's forward,
# which carries BATCH_GRANULES granules' tiles (infer/sliding.py)
INT8_BATCH = BATCH_GRANULES * ICFG.batch_tiles
INT8_CHECK_TILES = 2                  # card against CPU, whole forward
# the card's int8 forward against the CPU's on the same qvars: every int8
# plane equal (Q1 and its plain version round alike; the transposed convs
# and the requants are the same IEEE steps), the fp32 head sums in another
# order
INT8_LOGIT_RTOL = 1e-5
# int8 against the plain forward, served on the trained checkpoint: the
# JAX package's bound under sliding inference
# (tests/test_quantized_forward.py:132)
INT8_MAX_FLIP_SHARE = 1e-2


def check_int8_conv(rng):
    """Q1 against its plain version, bit for bit, at the 18 convs of
    UNetConfig() at the main path's batch of 288² tiles (``INT8_BATCH``)
    in the forward's output modes, timed queued and single beside the plain
    version and the cuDNN bf16 conv of the same shape
    (``experiments/int8_conv_times.py``), and whether ``F.conv2d`` takes
    int8 CUDA tensors at all (the library column)."""
    library = int8_conv_times.int8_library_conv(DEV)
    print(f"F.conv2d on int8 CUDA tensors: {library}", flush=True)
    rows = []
    for case in int8_conv_times.conv_cases(UNetConfig(), ICFG.tile_size):
        rows.append(int8_conv_times.time_case(rng, case, INT8_BATCH, DEV,
                                              library["runs"]))
        print(int8_conv_times.summary(rows[-1]), flush=True)
    torch.cuda.empty_cache()
    return rows, library


def check_int8_upsample(rng):
    """Q2 against its plain version, bit for bit, at the four upsamples of
    UNetConfig() at the main path's batch of 288² tiles, timed queued and
    single beside its plain version (the forward's path before Q2:
    ``torch._int_mm`` and the eager dequant, shuffle and requant) and
    ``torch._int_mm`` of the same product alone."""
    rows = []
    for case in int8_conv_times.upsample_cases(UNetConfig(), ICFG.tile_size):
        rows.append(int8_conv_times.time_upsample(rng, case, INT8_BATCH, DEV))
        print(int8_conv_times.upsample_summary(rows[-1]), flush=True)
    torch.cuda.empty_cache()
    return rows


def int8_card_against_cpu(model, rng, name, want_launches):
    """The int8 forward of ``model`` on the card against the port's int8
    forward on the CPU with the same qvars (calibrated on the card on
    ``INT8_CHECK_TILES`` serving tiles): Q1 and Q2 launched
    ``want_launches`` times, every int8 plane equal, the logits within
    ``INT8_LOGIT_RTOL`` of the largest."""
    apply = make_quantized_apply(model.cfg)
    x = mega_tiles(rng, INT8_CHECK_TILES, ICFG.tile_size)
    qvars = quantize_unet(model, model.cfg, x)
    planes_card, planes_cpu = [], []
    int8_conv.LAUNCHES = int8_upsample.LAUNCHES = 0
    got = apply(qvars, x, planes=planes_card)
    torch.cuda.synchronize()
    launches = (int8_conv.LAUNCHES, int8_upsample.LAUNCHES)
    if launches != want_launches:
        raise AssertionError(f"{name} launched Q1 and Q2 {launches} times, "
                             f"not {want_launches}")
    t0 = time.perf_counter()
    want = apply(qvars_to(qvars, "cpu"), x.cpu(), planes=planes_cpu)
    cpu_s = time.perf_counter() - t0
    if len(planes_card) != len(planes_cpu):
        raise AssertionError(f"{name}: the devices kept different planes")
    unequal = [i for i, (p, q) in enumerate(zip(planes_card, planes_cpu))
               if not torch.equal(p.cpu(), q)]
    if unequal:
        raise AssertionError(f"{name}: planes {unequal} differ between the "
                             "card and the CPU")
    return {"tiles": INT8_CHECK_TILES, "planes": len(planes_card),
            "launches": launches[0], "q2_launches": launches[1],
            "cpu_forward_s": cpu_s,
            **compare_logits(f"{name}, card against CPU", got, want,
                             INT8_LOGIT_RTOL, min_corr=0.999999)}


def check_int8_forward(model, rng):
    """The int8 forward of the flagship net on the card against the port's
    int8 forward on the CPU with the same qvars (calibrated on the card on
    the same tiles), every int8 plane equal; then the forward rates at the
    main path's batch (``INT8_BATCH``), int8 against plain bf16 and fused,
    and the int8 forward's kernel time by class under the profiler, where
    ``torch._int_mm`` must take no time (every product is Q1's or Q2's)."""
    cfg = model.cfg
    apply = make_quantized_apply(cfg)
    check = int8_card_against_cpu(model, rng, "int8 forward",
                                  (2 * (2 * cfg.depth + 1), cfg.depth))
    xb = torch.rand((INT8_BATCH, ICFG.tile_size, ICFG.tile_size, 2),
                    generator=torch.Generator().manual_seed(SEED)).to(DEV)
    qvars_b = quantize_unet(model, cfg, xb[:9])
    fused = make_fused_apply(cfg)
    with torch.inference_mode():
        ms = {"int8": time_ms(lambda: apply(qvars_b, xb), reps=5),
              "plain_bf16": time_ms(lambda: model(xb), reps=5),
              "fused": time_ms(lambda: fused(model, xb), reps=5)}
        profile = int8_conv_times.forward_profile(apply, qvars_b, xb)
    if profile["busy_share"] is None or "unsplit" in profile["device_ms"] \
            or profile["device_ms"].get("int_mm", 0.0) != 0.0 \
            or not profile["device_ms"].get("q2"):
        raise AssertionError(f"int8 forward profile: {profile['device_ms']}"
                             " (torch._int_mm must take no time, Q2 some)")
    mpix = INT8_BATCH * ICFG.tile_size**2 / 1e6
    res = {**check, "batch": INT8_BATCH, "forward_ms": ms,
           "forward_mpix_s": {k: mpix / (v / 1e3) for k, v in ms.items()},
           "profile": profile}
    print(f"int8 forward {INT8_CHECK_TILES}x{ICFG.tile_size}^2 card against "
          f"CPU: {check['planes']} int8 planes equal, max|dlogit| "
          f"{check['max_abs_diff']:.3g} of {check['max_abs_logit']:.4g} "
          f"(CPU {check['cpu_forward_s']:.1f} s); forwards of {INT8_BATCH}x{ICFG.tile_size}^2: "
          + ", ".join(f"{k} {ms[k]:.2f} ms ({res['forward_mpix_s'][k]:.1f} "
                      "MPix/s)" for k in ms)
          + "; int8 " + int8_conv_times.profile_summary(profile), flush=True)
    return res


def int8_path(root, cfg):
    """The slice's path: ``predict_model --int8`` over the 4 granules of
    2048² (calibration on the first, every 3×3 conv of every forward one
    launch of Q1, every upsample one of Q2); ``cfg`` is the served
    checkpoint's."""
    n_tiles, forwards = serving_geometry(ICFG)
    mpix = GRANULES * GRANULE_PX**2 / 1e6
    calib_s = []
    real = cli._int8_quantize_from_paths

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        calib_s.append(time.perf_counter() - t0)
        return out

    cli._int8_quantize_from_paths = timed
    try:
        int8_conv.LAUNCHES = int8_upsample.LAUNCHES = 0
        int8_s, int8_preds = serve(root, "--int8")
        launches = int8_conv.LAUNCHES
        q2_launches = int8_upsample.LAUNCHES
    finally:
        cli._int8_quantize_from_paths = real
    per_forward = 2 * (2 * cfg.depth + 1)
    if (launches != per_forward * forwards or launches == 0
            or q2_launches != cfg.depth * forwards):
        raise AssertionError(f"predict_model --int8 launched Q1 {launches} "
                             f"and Q2 {q2_launches} times for {forwards} "
                             "forwards")
    res = {"granules": GRANULES, "granule_px": GRANULE_PX,
           "forwards": forwards, "q1_launches": launches,
           "q2_launches": q2_launches,
           "int8_s": [int8_s], "int8_mpix_s": [mpix / int8_s],
           "calibration_s": calib_s, "preds": int8_preds}
    print(f"predict_model --int8 {GRANULES}x{GRANULE_PX}^2: Q1 launches "
          f"{launches} ({forwards} forwards x {per_forward}), Q2 launches "
          f"{q2_launches}; whole call {res['int8_mpix_s'][0]:.2f} MPix/s, "
          "calibration " + "/".join(f"{s:.2f}" for s in calib_s) + " s",
          flush=True)
    return res



# --------------------------------------------- streams: pool, stager, flags

# the JAX package's bounds of the quantized streams against the fp32 one
# (tests/test_viz_streaming.py:131-195): the uint16 upload's step through
# the forward, the uint8 readback's half step, and both
QUANT_ATOL = 1e-2
OUT_ATOL = 1 / 510 + 1e-7


def read_split(out_dir):
    """{granule: probs} of the prediction files in ``out_dir``."""
    preds = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith("_pred.npz"):
            with np.load(os.path.join(out_dir, name)) as d:
                preds[name[:-len("_pred.npz")]] = d["probs"]
    return preds


def serve_int8_scales(root, *flags):
    """``serve(root, "--int8", *flags)`` and the int8 variables the CLI
    calibrated for it (its own call, captured)."""
    real, calibrated = cli._int8_quantize_from_paths, []

    def captured(*args, **kw):
        calibrated.append(real(*args, **kw))
        return calibrated[-1]

    cli._int8_quantize_from_paths = captured
    try:
        secs, preds = serve(root, "--int8", *flags)
    finally:
        cli._int8_quantize_from_paths = real
    return secs, preds, calibrated[0][0]


class ByteCounter:
    """Counts the bytes the stream uploads (``streaming.host_payload``) and
    reads back (``streaming.readback``) while installed."""

    def __init__(self):
        self.uploaded = self.read_back = self.granules = 0
        self.payload, self.back = streaming.host_payload, streaming.readback

    def __enter__(self):
        def payload(channels, quantize):
            out = self.payload(channels, quantize)
            self.uploaded += sum(a.nbytes for a in out)
            self.granules += 1
            return out

        def back(probs):
            out = self.back(probs)
            self.read_back += out.nbytes
            return out

        streaming.host_payload, streaming.readback = payload, back
        return self

    def __exit__(self, *exc):
        streaming.host_payload, streaming.readback = self.payload, self.back

    def per_granule(self):
        return {"uploaded": self.uploaded / self.granules,
                "read_back": self.read_back / self.granules}


def stream_serving(model, root, tmp):
    """``predict_model`` over the 4 × 2048² root through the pooled and
    prefetched stream for the plain, ``--fused`` and ``--int8`` forwards,
    each against its serial split (decode, upload, forward, readback and
    write one after the other) bit for bit; then ``--quantize``,
    ``--quantize-output`` and both under the JAX package's bounds against
    the plain stream, with the bytes uploaded and read back per granule."""
    cfg = model.cfg
    mpix = GRANULES * GRANULE_PX**2 / 1e6
    res = {"cores": os.cpu_count(),
           "decode_workers": prefetch.default_decode_workers(),
           "forwards": {}, "quantized": {}}
    pooled = {}
    for label, flags in (("plain", []), ("fused", ["--fused"]),
                         ("int8", ["--int8"])):
        variables = None
        with ByteCounter() as count:
            if label == "int8":
                secs, preds, variables = serve_int8_scales(root)
            else:
                secs, preds = serve(root, *flags)
        pooled[label] = (preds, count.per_granule())
        if label == "int8":
            # the serial split serves the scales the CLI calibrated
            apply_fn = make_quantized_apply(cfg)
        else:
            apply_fn = (make_fused_apply(cfg) if label == "fused"
                        else (lambda m, x: m(x)))
        out = os.path.join(tmp, f"stream_split_{label}")
        os.makedirs(out)
        split = serving_split(root, model, out, apply_fn, ICFG,
                              f"{label} serial", variables=variables)
        serial = read_split(out)
        unequal = [k for k in preds if not np.array_equal(preds[k],
                                                          serial[k])]
        if unequal:
            raise AssertionError(f"{label}: the pooled stream's probs differ "
                                 f"from the serial split's on {unequal}")
        res["forwards"][label] = {
            "call_s": secs, "call_mpix_s": mpix / secs,
            "serial_split_s": split,
            "serial_mpix_s": mpix / sum(split.values())}
        print(f"streams {label}: predict_model {GRANULES}x{GRANULE_PX}^2 "
              f"{secs:.3f} s ({mpix / secs:.3f} MPix/s) on "
              f"{res['cores']} cores, {res['decode_workers']} decode "
              f"workers; serial split {sum(split.values()):.3f} s "
              f"({mpix / sum(split.values()):.3f} MPix/s); probs equal bit "
              "for bit", flush=True)

    ref, fp32_bytes = pooled["plain"]
    for label, flags, atol in (
            ("quantize", ["--quantize"], QUANT_ATOL),
            ("quantize_output", ["--quantize-output"], OUT_ATOL),
            ("both", ["--quantize", "--quantize-output"],
             QUANT_ATOL + 1 / 510)):
        with ByteCounter() as count:
            secs, preds = serve(root, *flags)
        nbytes = count.per_granule()
        max_dp = max(float(np.abs(preds[k] - ref[k]).max()) for k in ref)
        if max_dp > atol:
            raise AssertionError(f"{label}: max|dp| {max_dp} > {atol}")
        if "--quantize" in flags:
            if all(np.array_equal(preds[k], ref[k]) for k in ref):
                raise AssertionError(f"{label}: equal to the fp32 stream: "
                                     "the upload was not quantized")
            # the uint16 code, plus 16 bytes of lo and scale
            if nbytes["uploaded"] != fp32_bytes["uploaded"] / 2 + 16:
                raise AssertionError(f"{label}: uploaded {nbytes} against "
                                     f"fp32 {fp32_bytes}")
        if "--quantize-output" in flags:
            off = max(float(np.abs(p * 255 - np.round(p * 255)).max())
                      for p in preds.values())
            if off > 1e-3 or nbytes["read_back"] != \
                    fp32_bytes["read_back"] / 4:
                raise AssertionError(f"{label}: off the /255 lattice by "
                                     f"{off} or read back {nbytes}")
        res["quantized"][label] = {"call_s": secs,
                                   "call_mpix_s": mpix / secs,
                                   "max_abs_dprobs": max_dp,
                                   "bytes_per_granule": nbytes}
        print(f"streams {label}: {secs:.3f} s ({mpix / secs:.3f} MPix/s), "
              f"max|dp| {max_dp:.4g} (bound {atol:.4g}); per granule "
              f"uploaded {nbytes['uploaded']:.0f} B, read back "
              f"{nbytes['read_back']:.0f} B (fp32: "
              f"{fp32_bytes['uploaded']:.0f}, {fp32_bytes['read_back']:.0f})",
              flush=True)
    res["fp32_bytes_per_granule"] = fp32_bytes
    return res


def explicit_tta(apply_fn):
    """The reference of ``make_tta_apply``: the 8 D4 views as 8 forwards,
    each inverted, their sigmoids averaged, returned as logits."""
    def apply(variables, x):
        probs = []
        for k, f in tta._D4:
            v = torch.flip(x, dims=(2,)) if f else x
            y = apply_fn(variables, torch.rot90(v, k, dims=(1, 2))
                         .contiguous())
            y = torch.rot90(y, -k, dims=(1, 2))
            probs.append(torch.sigmoid(
                (torch.flip(y, dims=(2,)) if f else y).float()))
        p = torch.stack(probs).mean(0).clamp(1e-7, 1.0 - 1e-7)
        return torch.log(p) - torch.log1p(-p)

    return apply


def stream_tta(model, root, mega_ckpt):
    """``predict_model --tta --tile 96 --overlap 32`` over the 4 × 2048²
    root for the plain, ``--fused``, ``--int8`` and ``use_mega`` forwards:
    each kernel launched as often as without ``--tta`` (K6 9, Q1 18 and Q2 4
    per forward, K7 once), the probs against the mean of 8 explicit view
    forwards of the same forward within the serving gate, peak memory per
    call."""
    cfg = model.cfg
    _, forwards = serving_geometry(MEGA)
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    paths = [os.path.join(maiac, f) for f in sorted(os.listdir(maiac))]
    geometry = ["--tile", str(MEGA.tile_size), "--overlap",
                str(MEGA.overlap)]
    mega_model = build_model(dataclasses.replace(cfg, use_mega=True)) \
        .to(DEV).eval()
    mega_model.load_state_dict(model.state_dict())
    res = {}
    for label, flags, want in (
            ("plain", [], {}),
            ("fused", ["--fused"], {"k6": 2 * cfg.depth + 1}),
            ("int8", ["--int8"], {"q1": 2 * (2 * cfg.depth + 1),
                                  "q2": cfg.depth}),
            ("use_mega", ["--checkpoint", mega_ckpt], {"k7": 1})):
        fused_conv.LAUNCHES = unet_mega.LAUNCHES = 0
        int8_conv.LAUNCHES = int8_upsample.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        if label == "int8":
            secs, preds, qvars = serve_int8_scales(root, "--tta", *geometry)
        else:
            secs, preds = serve(root, "--tta", *geometry, *flags)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {"k6": fused_conv.LAUNCHES, "k7": unet_mega.LAUNCHES,
                    "q1": int8_conv.LAUNCHES, "q2": int8_upsample.LAUNCHES}
        expected = {k: want.get(k, 0) * forwards for k in launches}
        if launches != expected:
            raise AssertionError(f"--tta {label}: launches {launches}, "
                                 f"expected {expected}")
        variables, net = model, model
        if label == "int8":
            variables, apply_fn = qvars, make_quantized_apply(cfg)
        elif label == "fused":
            apply_fn = make_fused_apply(cfg)
        else:
            if label == "use_mega":
                variables = net = mega_model
            apply_fn = lambda m, x: m(x)    # noqa: E731
        infer = make_multi_granule_infer(explicit_tta(apply_fn), MEGA)
        want_preds = {}
        with torch.inference_mode():
            for path in paths:
                name, ch, (h, w) = decode_granule_channels(path,
                                                           net.cfg.depth)
                p, _ = infer(variables, torch.from_numpy(ch)[None].to(DEV))
                want_preds[name] = p[0, :h, :w].cpu().numpy()
        max_dp, share, confident = compare_served(preds, want_preds)
        res[label] = {"call_s": secs, "launches": launches,
                      "forwards": forwards, "peak_memory_gb": peak_gb,
                      "max_abs_dprobs": max_dp, "mask_flip_share": share,
                      "confident_flips": confident}
        print(f"streams --tta {label} (tile {MEGA.tile_size}, "
              f"up to {8 * BATCH_GRANULES * MEGA.batch_tiles} tiles per "
              "forward): "
              f"{secs:.3f} s, launches {launches} over {forwards} forwards, "
              f"peak {peak_gb:.2f} GB; against 8 explicit view forwards "
              f"max|dp| {max_dp:.4g}, flips {share:.3e} ({confident} "
              "confident)", flush=True)
        if max_dp > PROB_ATOL or confident:
            raise AssertionError(f"--tta {label} and its explicit views "
                                 "disagree")
    return res


def stream_training(tmp, step_times):
    """The training side of the streams: the 16 × 512² host-stream step
    with the prefetched stream and with the serial ``host_batches`` (from
    ``train_step_times``, timed in turns); the quantized transfers on the
    host stream and card-resident against the float runs within the JAX
    package's bounds (tests/test_quant_transfer.py: loss 5e-3, eval IoU
    0.02), fp32 as there; ``build_features --detector rg`` on the decode
    pool against the serial decode."""
    row = next(r for r in step_times if r["geometry"] == "config2")
    res = {"config2": {k: row[k] for k in (
        "prefetched_loop_ms_per_step", "serial_loop_ms_per_step", "body_ms",
        "draw_ms", "upload_ms")}, "quantize_transfer": {}}
    print("streams train 16x512^2, ms per step in turns: prefetched "
          + "/".join(f"{ms:.3f}" for ms in row["prefetched_loop_ms_per_step"])
          + ", serial host_batches "
          + "/".join(f"{ms:.3f}" for ms in row["serial_loop_ms_per_step"])
          + f"; body {row['body_ms']['median']:.3f} ms", flush=True)

    unet_cfg = UNetConfig(compute_dtype="float32")
    data_cfg = DataConfig(granule_size=256, n_train_granules=2,
                          n_eval_granules=1)
    for resident in (False, True):
        hist = {}
        for quant in (False, True):
            tcfg = TrainConfig(
                batch_size=8, tile_size=128, total_steps=6, warmup_steps=2,
                log_every=3, checkpoint_every=1000, augment=False,
                device_data=resident, quantize_transfer=quant,
                checkpoint_dir=os.path.join(
                    tmp, f"quant_{int(resident)}{int(quant)}"))
            hist[quant] = train_loop(unet_cfg, tcfg, data_cfg, device=DEV)
        d_loss = max(abs(a - b) for a, b in zip(hist[True]["loss"],
                                                 hist[False]["loss"]))
        d_iou = abs(hist[True]["eval_iou"][-1] - hist[False]["eval_iou"][-1])
        key = "card_resident" if resident else "host_stream"
        res["quantize_transfer"][key] = {
            "loss": hist[True]["loss"], "float_loss": hist[False]["loss"],
            "eval_iou": hist[True]["eval_iou"][-1],
            "float_eval_iou": hist[False]["eval_iou"][-1]}
        print(f"streams train --quantize-transfer, {key}: max|dloss| "
              f"{d_loss:.3g}, |d eval IoU| {d_iou:.3g}", flush=True)
        if d_loss > 5e-3 or d_iou > 0.02:
            raise AssertionError(f"quantize_transfer {key} leaves the JAX "
                                 "package's bounds of the float run")

    root, _cpu_root, names = feature_root(tmp, "stream_features", BENCH_SCENE)
    serial_root = os.path.join(tmp, "stream_features_serial")
    shutil.copytree(root, serial_root)
    pooled_s = build_features(root, "--detector", "rg")
    real = prefetch.decode_pool
    prefetch.decode_pool = lambda items, fn, workers, depth: map(fn, items)
    try:
        serial_s = build_features(serial_root, "--detector", "rg")
    finally:
        prefetch.decode_pool = real
    for n in names:
        assert_features_equal(read_features(root, n),
                              read_features(serial_root, n), n)
    res["build_features"] = {"pooled_s": pooled_s, "serial_s": serial_s}
    print(f"streams build_features rg {FEATURE_GRANULES}x"
          f"{BENCH_SCENE['size']}^2: decode pool {pooled_s:.2f} s, serial "
          f"{serial_s:.2f} s, outputs equal", flush=True)
    return res


# ------------------------------------------------------------- rg identify

def timed_once(fn):
    """(result, ms) of one call, timed with CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def device_scene(h, w, seed):
    """An (h, w) AOD plane made on the card with the identify benchmark
    scene's statistics, and its plume origins (``ccl_pass_times``)."""
    return ccl_pass_times.device_scene(h, w, seed, DEV)


def serpentine(h, w, thick=3):
    return ccl_pass_times.serpentine(h, w, DEV, thick)


def pass_split(name, prefix, reps):
    """The queued ms of each of the three CCL passes (``prefix(n)``
    launches the first n), printed; launches made here are not counted."""
    split = ccl_pass_times.pass_split(prefix, reps)
    print(f"{name} per pass: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + " ms", flush=True)
    return split


def check_ccl(name, aod, thresholds, connectivity=2):
    """K1 vs its plain version (opening + connected_components per level):
    equal labels; kernel time over repeated launches, plain time of the
    comparison call. Returns the row and the kernel's labels."""
    th = torch.from_numpy(thresholds).to(DEV)
    got = ccl_sweep.multi_threshold_ccl_fused(aod, th, connectivity)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(
        lambda: ccl_sweep.multi_threshold_ccl_ref(aod, th, connectivity))
    equal = torch.equal(got, ref)
    wrong = 0 if equal else int((got != ref).sum())
    del ref
    t_count, h, w = got.shape
    ids = torch.arange(1, h * w + 1, dtype=torch.int32, device=DEV)
    components = [int((got[t].view(-1) == ids).sum()) for t in range(t_count)]
    fg = [float((got[t] > 0).float().mean()) for t in range(t_count)]
    big = h * w >= 4096**2
    ms = time_ms(lambda: ccl_sweep.multi_threshold_ccl_fused(
        aod, th, connectivity), reps=5 if big else 10, calls=QUEUED)
    bound_ms, bound_by = bound(4 * (aod.numel() + t_count + got.numel()))
    row = {"scene": name, "h": h, "w": w, "levels": t_count,
           "connectivity": connectivity, "equal": equal,
           "wrong_pixels": wrong, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gpix_levels_per_s": t_count * h * w / ms / 1e6,
           "components": components, "foreground_share": fg}
    if name in ("bench_1200", "synthetic_8192"):
        out = torch.empty_like(got)
        row["passes"] = pass_split(f"K1 {name}", lambda n: (
            ccl_pass_times.sweep_prefix(aod, th, out, connectivity, n)),
            3 if big else 5)
        del out
    print(f"K1 {name} {h}x{w} T={t_count} conn={connectivity}: "
          f"{'equal' if equal else f'{wrong} pixels differ'}; kernel "
          f"{ms:.3f} ms (bound {bound_ms:.4f} ms by {bound_by}), plain "
          f"{plain_ms:.1f} ms; components per level "
          f"{components[0]}..{components[-1]}", flush=True)
    if not equal:
        raise AssertionError(f"K1 disagrees with its plain version on {name}")
    return row, got


def check_counts(name, labels, f_count, rng):
    """K3 vs its plain version on real labels, with the not-found 0, a
    duplicate and an absent label among the labs."""
    t_count, h, w = labels.shape
    idx = torch.from_numpy(rng.integers(0, h * w, (t_count, f_count))).to(DEV)
    labs = torch.gather(labels.view(t_count, -1), 1, idx)
    labs[:, 0] = 0
    if f_count > 2:
        labs[:, 1] = labs[:, 2]
        labs[:, -1] = h * w + 7
    labs = labs.contiguous()
    got = label_counts.fire_label_counts(labels, labs)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(
        lambda: label_counts.fire_label_counts_ref(labels, labs))
    err = int((got - ref).abs().max())
    ms = time_ms(lambda: label_counts.fire_label_counts(labels, labs),
                 calls=QUEUED)
    # one compare per pixel, level and lab; labels and labs in, counts out
    bound_ms, bound_by = bound(4 * (labels.numel() + 2 * labs.numel()),
                               labels.numel() * f_count)
    row = {"scene": name, "h": h, "w": w, "levels": t_count, "F": f_count,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gb_per_s": labels.numel() * 4 / ms / 1e6}
    print(f"K3 {name} {h}x{w} T={t_count} F={f_count}: max|err| {err}; "
          f"kernel {ms:.3f} ms ({row['gb_per_s']:.0f} GB/s; bound "
          f"{bound_ms:.4f} ms by {bound_by}), plain {plain_ms:.1f} ms",
          flush=True)
    if err:
        raise AssertionError(f"K3 disagrees with its plain version on {name}"
                             f" at F={f_count}")
    return row


def check_identify_kernels(rng):
    """K1 at the benchmark's 1200² scene, 4096², 8192², a ragged 1201 × 997
    scene (both connectivities) and a serpentine; K3 at the first three
    with F = 16, 64 and 128."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BENCH_SCENE))
    scenes = [("bench_1200", torch.from_numpy(
        bench.granule.first_layer()).to(DEV))]
    scenes += [(f"synthetic_{n}", device_scene(n, n, SEED + n)[0])
               for n in (4096, 8192)]
    ccl_rows, count_rows = [], []
    for name, aod in scenes:
        row, labels = check_ccl(name, aod, THRESHOLDS)
        ccl_rows.append(row)
        for f_count in (16, 64, 128):
            count_rows.append(check_counts(name, labels, f_count, rng))
        del labels, aod
        torch.cuda.empty_cache()
    ragged = device_scene(1201, 997, SEED + 1)[0]
    for conn in (2, 1):
        ccl_rows.append(check_ccl("ragged", ragged, THRESHOLDS, conn)[0])
    ccl_rows.append(check_ccl("serpentine", serpentine(1024, 1024),
                              np.asarray([0.5, 0.25], np.float32))[0])
    torch.cuda.empty_cache()
    return ccl_rows, count_rows


def swath_scene(n):
    """An n² scene for rg.identify: the card-made AOD plane on the host,
    the MODIS sinusoidal lat/lon grid of make_scene at 1 km pixels, and a
    fire table with one fire at each of the first SWATH_FIRES plume
    origins."""
    aod, (rows, cols) = device_scene(n, n, SEED + 2 * n)
    xc, yc = wgs84_to_sinusoidal(-60.0, -10.0)
    half = n / 2.0 * 1000.0
    lat, lon = grid_from_extent(xc - half, yc + half, xc + half, yc - half,
                                n, n)
    rng = np.random.default_rng(SEED)
    rows = rows[:SWATH_FIRES].astype(int)
    cols = cols[:SWATH_FIRES].astype(int)
    fires = make_fire_table(lat, lon, rows, cols,
                            rng.uniform(20.0, 300.0, rows.size),
                            "2017-08-01", rng)
    return aod.cpu().numpy(), lat, lon, fires["date_time"][0], fires


class Patched:
    """Swap module attributes for the length of a ``with`` block."""

    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        self.saved = {key: getattr(*key) for key in self.patches}
        for (mod, attr), fn in self.patches.items():
            setattr(mod, attr, fn)

    def __exit__(self, *exc):
        for (mod, attr), fn in self.saved.items():
            setattr(mod, attr, fn)


def phase_clock(keys):
    """(clock, timed): ``timed(key, fn)`` wraps ``fn`` so that each call,
    synchronised on both sides, adds its seconds to ``clock[key]``."""
    clock = dict.fromkeys(keys, 0.0)

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t0
            return out
        return run
    return clock, timed


def identify_split(scene, plain):
    """One rg.identify on the card, timed by phase: host fire prep
    (subset, clustering, location), K1, K3, the per-fire phase (the rest
    of the sweep: uploads, window lookups, threshold index, per-fire
    assessment, masks) and host post-processing (readback, hulls,
    tables). ``plain`` swaps the plain versions in for K1 and K3."""
    aod, lat, lon, date, fires = scene
    clock, timed = phase_clock(("host_prep", "k1", "k3", "host_post"))
    patches = {
        (pipeline, "multi_threshold_ccl_fused"): timed("k1", (
            ccl_sweep.multi_threshold_ccl_ref if plain
            else ccl_sweep.multi_threshold_ccl_fused)),
        (pipeline, "fire_label_counts"): timed("k3", (
            label_counts.fire_label_counts_ref if plain
            else label_counts.fire_label_counts)),
        (rg, "_prep_fires"): timed("host_prep", rg._prep_fires),
        (rg, "_to_host"): timed("host_post", rg._to_host),
        (rg, "_scene_results"): timed("host_post", rg._scene_results),
    }
    with Patched(patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aod_table, hull_table, out = rg.identify(aod, lat, lon, date, fires,
                                                 RG, device=DEV)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    ms = {k: v * 1e3 for k, v in clock.items()}
    ms["per_fire"] = total * 1e3 - sum(ms.values())
    ms["total"] = total * 1e3
    return ms, (aod_table.rows, hull_table.rows, out["plume_masks"],
                int(out["accepted"].shape[0]))


def same_result(a, b):
    """Equal identify results: table rows, then plume masks."""
    (at, ah, am, _), (bt, bh, bm, _) = a, b
    return at == bt and ah == bh and sorted(am) == sorted(bm) and all(
        np.array_equal(am[k], bm[k]) for k in am)


def sweep_split():
    """ms per scene of the rg sweep at 1200² (the benchmark scene) and
    8192², with the kernels and with the plain versions, in turns; the
    two must give the same tables and masks."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BENCH_SCENE))
    g = bench.granule
    scenes = {"bench_1200": (g.first_layer(), g.lat, g.lon,
                             bench.fires["date_time"][0], bench.fires),
              "synthetic_8192": swath_scene(8192)}
    # a process's first run is a warm-up; at 1200² its first-use cost
    # reaches into the next run of the kernels, so the scene runs on until
    # the last three kernel runs are steady; at 8192² (48 s a run, host
    # fire location 80% of it) one run each, the plain versions first
    orders = {"bench_1200": (False, True, False, True, False, False),
              "synthetic_8192": (True, False)}
    res = {}
    for name, scene in scenes.items():
        runs = {"kernels": [], "plain": []}
        results = {}
        torch.cuda.reset_peak_memory_stats()
        ccl_sweep.LAUNCHES = 0
        for plain in orders[name]:
            ms, result = identify_split(scene, plain)
            runs["plain" if plain else "kernels"].append(ms)
            key = "plain" if plain else "kernels"
            if key in results and not same_result(results[key], result):
                raise AssertionError(f"{name}: {key} runs disagree")
            results[key] = result
            print(f"identify {name} ({'plain' if plain else 'kernels'}): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                  + " ms", flush=True)
        if not same_result(results["kernels"], results["plain"]):
            raise AssertionError(f"{name}: kernels and plain versions give "
                                 "different tables or masks")
        kt, _kh, _km, f_cap = results["kernels"]
        if not kt:
            raise AssertionError(f"{name}: no plume accepted")
        res[name] = {"runs": runs, "plumes": len(kt), "fire_capacity": f_cap,
                     "k1_launches": ccl_sweep.LAUNCHES,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"identify {name}: {len(kt)} plumes, F = {f_cap}, K1 launches "
              f"{ccl_sweep.LAUNCHES}, peak {res[name]['peak_gb']:.2f} GB",
              flush=True)
        del scene, results
        torch.cuda.empty_cache()
    return res


def read_features(root, base):
    """The build_features outputs of one granule: each CSV as a header and
    rows of strings, and the masks npz as a dict."""
    from plumekit_torch.config import PathsConfig

    paths = PathsConfig(root=root)
    out = {}
    for key, sub, suffix in (("aod", "aod_df_dir", "_aod.csv"),
                             ("extent", "hull_df_dir", "_extent.csv")):
        with open(os.path.join(paths.resolve(sub), base + suffix)) as f:
            out[key] = list(csv.reader(f))
    npz = os.path.join(paths.resolve("plume_mask_dir"), base + "_masks.npz")
    out["masks"] = {}
    if os.path.exists(npz):
        with np.load(npz) as d:
            out["masks"] = {k: d[k] for k in d.files}
    return out


def assert_features_equal(got, want, base):
    for key in ("aod", "extent"):
        g, w = got[key], want[key]
        if g[0] != w[0] or len(g) != len(w):
            raise AssertionError(f"{base} {key}: header or row count differ")
        for j, col in enumerate(w[0]):
            gc = np.asarray([float(r[j]) for r in g[1:]])
            wc = np.asarray([float(r[j]) for r in w[1:]])
            if col in FLOAT_COLUMNS:
                ok = np.allclose(gc, wc, rtol=FEATURE_RTOL, atol=0.0)
            else:
                ok = np.array_equal(gc, wc)
            if not ok:
                raise AssertionError(f"{base} {key}.{col}: card {gc} vs CPU "
                                     f"{wc}")
    gm, wm = got["masks"], want["masks"]
    if sorted(gm) != sorted(wm) or not all(np.array_equal(gm[k], wm[k])
                                           for k in wm):
        raise AssertionError(f"{base}: masks differ between card and CPU")


def feature_root(tmp, name, scene_kw):
    """A root of FEATURE_GRANULES synthetic 1200² granules (seeds 0-3,
    centres 15° of longitude apart, so that each sees only its own fires)
    and one fire table; and a second root that holds the first granule
    only, for the ``--device cpu`` run. Returns (root, cpu_root, names)."""
    root = os.path.join(tmp, name)
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    fires_dir = os.path.join(root, "raw", "fires")
    os.makedirs(maiac)
    os.makedirs(fires_dir)
    tables, names = [], []
    for seed in range(FEATURE_GRANULES):
        scene = make_scene(SyntheticSceneConfig(
            seed=SEED + seed, center_lon=-60.0 + 15.0 * seed, **scene_kw))
        save_granule(os.path.join(maiac, scene.granule.name + ".npz"),
                     scene.granule)
        tables.append(scene.fires)
        names.append(scene.granule.name)
    write_fire_csv(os.path.join(fires_dir, "fires.csv"),
                   {k: np.concatenate([t[k] for t in tables])
                    for k in tables[0]})
    cpu_root = os.path.join(tmp, name + "_cpu")
    shutil.copytree(root, cpu_root, ignore=lambda d, files: [
        f for f in files if f.endswith(".npz") and f != names[0] + ".npz"])
    return root, cpu_root, names


def build_features(root, *flags):
    """(seconds, exit code) of one ``build_features`` call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["build_features", "--root", root, *flags])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"build_features {flags} exited {rc}")
    return secs


def features_path(tmp):
    """``build_features --detector rg`` over four synthetic 1200² granules
    and one fire table on the card: K1 and K3 must launch and plumes must
    be accepted; the first granule's CSVs and masks must equal a
    ``--device cpu`` run; ``--batch-scenes 4`` over the same granules must
    write what the serial run wrote."""
    root, cpu_root, names = feature_root(tmp, "features", BENCH_SCENE)
    batch_root = os.path.join(tmp, "features_batch")
    shutil.copytree(root, batch_root)

    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
    secs = build_features(root, "--detector", "rg")
    launches = {"k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}
    if not (launches["k1"] > 0 and launches["k3"] > 0):
        raise AssertionError(f"build_features did not launch K1 and K3: "
                             f"{launches}")
    outputs = {n: read_features(root, n) for n in names}
    plumes = {n: len(o["aod"]) - 1 for n, o in outputs.items()}
    if not sum(plumes.values()):
        raise AssertionError("build_features accepted no plume")

    cpu_s = build_features(cpu_root, "--detector", "rg", "--device", "cpu")
    assert_features_equal(outputs[names[0]], read_features(cpu_root, names[0]),
                          names[0])

    batch_s = build_features(batch_root, "--detector", "rg",
                             "--batch-scenes", str(FEATURE_GRANULES))
    for n in names:
        assert_features_equal(read_features(batch_root, n), outputs[n], n)
    res = {"granules": FEATURE_GRANULES, "granule_px": BENCH_SCENE["size"],
           "seconds": secs, "s_per_granule": secs / FEATURE_GRANULES,
           "launches": launches, "plumes": plumes,
           "cpu_seconds_one_granule": cpu_s, "batch_scenes_seconds": batch_s}
    print(f"build_features {FEATURE_GRANULES}x{BENCH_SCENE['size']}^2 on the "
          f"card: {secs:.2f} s ({secs / FEATURE_GRANULES:.3f} s/granule), "
          f"launches {launches}, plumes {plumes}; {names[0]} equals the "
          f"--device cpu run ({cpu_s:.2f} s); --batch-scenes "
          f"{FEATURE_GRANULES} equals the serial run ({batch_s:.2f} s)",
          flush=True)
    return res


# ----------------------------------------- the basic and gaussian detectors

def check_masks(name, masks, connectivity=2, same_as=None):
    """K2 vs its plain version (connected_components per level): equal
    labels; kernel time over repeated launches, plain time of the
    comparison call. ``same_as``: labels it must also equal."""
    got = ccl_sweep.multi_threshold_ccl(masks, connectivity, nested=False)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(
        lambda: ccl_sweep.multi_threshold_ccl_masks_ref(masks, connectivity))
    equal = torch.equal(got, ref)
    wrong = 0 if equal else int((got != ref).sum())
    del ref
    if same_as is not None and not torch.equal(got, same_as):
        raise AssertionError(f"K2 on {name} differs from K1 on the raw AOD")
    t_count, h, w = got.shape
    ids = torch.arange(1, h * w + 1, dtype=torch.int32, device=DEV)
    components = [int((got[t].view(-1) == ids).sum()) for t in range(t_count)]
    fg = [float(masks[t].float().mean()) for t in range(t_count)]
    big = h * w >= 4096**2
    ms = time_ms(lambda: ccl_sweep.multi_threshold_ccl(
        masks, connectivity, nested=False), reps=5 if big else 10,
        calls=QUEUED)
    bound_ms, bound_by = bound(masks.numel() + got.numel() * 4)
    row = {"scene": name, "h": h, "w": w, "levels": t_count,
           "connectivity": connectivity, "equal": equal,
           "wrong_pixels": wrong, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gpix_levels_per_s": t_count * h * w / ms / 1e6,
           "components": components, "foreground_share": fg}
    if name in ("basic_scene_1200_mask", "basic_mask_8192"):
        out = torch.empty_like(got)
        row["passes"] = pass_split(f"K2 {name}", lambda n: (
            ccl_pass_times.masks_prefix(masks, out, connectivity, n)),
            3 if big else 5)
        del out
    print(f"K2 {name} {h}x{w} T={t_count} conn={connectivity}: "
          f"{'equal' if equal else f'{wrong} pixels differ'}; kernel "
          f"{ms:.3f} ms (bound {bound_ms:.4f} ms by {bound_by}), plain "
          f"{plain_ms:.1f} ms; components per level {components[0]}.."
          f"{components[-1]}, foreground {fg[0]:.3f}..{fg[-1]:.3f}",
          flush=True)
    if not equal:
        raise AssertionError(f"K2 disagrees with its plain version on {name}")
    return row


def opened_stack(aod, thresholds):
    th = torch.from_numpy(np.asarray(thresholds, np.float32)).to(DEV)
    return binary_opening_cross(aod[None] > th[:, None, None]).contiguous()


def check_mask_kernel(rng):
    """K2 on the opened stack of the bench scene (also equal to K1 on the
    raw AOD), basic's mask of its own 1200² scene (sparse) and of the
    bench scene (percolating), a ragged stack at both connectivities,
    independent random masks, a fire raster, a serpentine, an empty and a
    full level, and basic's mask at 8192²."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BENCH_SCENE))
    aod = torch.from_numpy(bench.granule.first_layer()).to(DEV)
    k1 = ccl_sweep.multi_threshold_ccl_fused(
        aod, torch.from_numpy(THRESHOLDS).to(DEV))
    rows = [check_masks("bench_1200_opened", opened_stack(aod, THRESHOLDS),
                        same_as=k1)]
    del k1
    limit = torch.tensor(BASIC.aod_min_limit, device=DEV)
    clean = torch.from_numpy(make_scene(SyntheticSceneConfig(
        seed=SEED, **BASIC_SCENE)).granule.first_layer()).to(DEV)
    for name, plane in (("basic_scene_1200_mask", clean),
                        ("bench_1200_basic_mask", aod)):
        rows.append(check_masks(name, binary_opening_cross(
            plane >= limit)[None].contiguous()))
    ragged = opened_stack(device_scene(1201, 997, SEED + 1)[0], THRESHOLDS)
    for conn in (2, 1):
        rows.append(check_masks("ragged_opened", ragged, conn))
    del ragged
    independent = torch.from_numpy(rng.random((4, 1024, 1024)) < 0.45).to(DEV)
    rows.append(check_masks("independent_1024", independent))
    raster = torch.zeros((1, 1200, 1200), dtype=torch.bool, device=DEV)
    fires = rng.integers(16, 1184, (16, 2))
    for r, c in fires:                       # 16 clusters of 4 fires
        for dr, dc in ((0, 0), (0, 1), (1, 1), (2, 2)):
            raster[0, r + dr, c + dc] = True
    rows.append(check_masks("fire_raster_1200", raster))
    rows.append(check_masks("serpentine_1024",
                            (serpentine(1024, 1024) > 0.5)[None].contiguous()))
    edge = torch.zeros((2, 1200, 1200), dtype=torch.bool, device=DEV)
    edge[1] = True
    rows.append(check_masks("empty_and_full_1200", edge))
    del edge, independent, raster
    swath = device_scene(8192, 8192, SEED + 8192)[0]
    rows.append(check_masks("basic_mask_8192", binary_opening_cross(
        swath >= limit)[None].contiguous()))
    del swath
    torch.cuda.empty_cache()
    return rows


def plain_masks(opened, connectivity=2, nested=True):
    return ccl_sweep.multi_threshold_ccl_masks_ref(opened, connectivity)


def basic_split(scene, plain):
    """One basic.identify on the card, timed by phase: host fire prep, K2,
    the rest of the device program (ratio screen, threshold, opening,
    windows, per-fire compares) and host post-processing. ``plain`` swaps
    the plain version in for K2."""
    aod, lat, lon, date, fires = scene
    clock, timed = phase_clock(("host_prep", "k2", "host_post"))
    patches = {
        (basic, "_prep_fires"): timed("host_prep", basic._prep_fires),
        (basic, "multi_threshold_ccl"): timed("k2", (
            plain_masks if plain else ccl_sweep.multi_threshold_ccl)),
        (basic, "_to_host"): timed("host_post", basic._to_host),
    }
    with Patched(patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plumes, image = basic.identify(aod, lat, lon, date, fires, BASIC,
                                       device=DEV)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    ms = {k: v * 1e3 for k, v in clock.items()}
    ms["device_rest"] = total * 1e3 - sum(ms.values())
    ms["total"] = total * 1e3
    return ms, (plumes, image)


def gaussian_split(scene, plain):
    """One gaussian.identify_granule on the card, timed by phase: host
    fire location, in-painting, clustering (the raster, K2 and the
    per-fire centroid sums), K1, K3, the per-fire phase (the rest of the
    three sweeps per layer) and host post-processing (readback, hulls,
    tables). ``plain`` swaps the plain versions in for K1, K2 and K3."""
    granule, fires, date = scene
    clock, timed = phase_clock(("host_prep", "inpaint", "clustering", "k1",
                                "k3", "host_post"))
    patches = {
        (gaussian, "load_fires"): timed("host_prep", gaussian.load_fires),
        (gaussian, "nearest_fill"): timed("inpaint", gaussian.nearest_fill),
        (gaussian, "cluster_fire_centroids"): timed(
            "clustering", gaussian.cluster_fire_centroids),
        (pipeline, "multi_threshold_ccl_fused"): timed("k1", (
            ccl_sweep.multi_threshold_ccl_ref if plain
            else ccl_sweep.multi_threshold_ccl_fused)),
        (pipeline, "fire_label_counts"): timed("k3", (
            label_counts.fire_label_counts_ref if plain
            else label_counts.fire_label_counts)),
        (gaussian, "_to_host"): timed("host_post", gaussian._to_host),
        (gaussian, "build_scene_dataframes"): timed(
            "host_post", gaussian.build_scene_dataframes),
    }
    if plain:
        # raster_cluster_centroids looks its K2 entry up at call time
        patches[(ccl_sweep, "multi_threshold_ccl")] = plain_masks
    with Patched(patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = gaussian.identify_granule(granule, fires, date, GAUSS,
                                          device=DEV)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    ms = {k: v * 1e3 for k, v in clock.items()}
    ms["per_fire"] = total * 1e3 - sum(ms.values())
    ms["total"] = total * 1e3
    return ms, table.rows


def detector_split():
    """ms per scene of basic.identify (its 1200² scene) and per
    granule of gaussian.identify_granule (1200², two layers, null blobs),
    with the kernels and with the plain versions, in turns; the two must
    give the same plumes."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BASIC_SCENE))
    g = bench.granule
    aod = g.first_layer().copy()
    aod[aod < 0] = 0.0                      # as the api hands it to basic
    gscene = make_scene(SyntheticSceneConfig(seed=SEED, **GAUSS_SCENE))
    located = gaussian.load_fires(gscene.granule.lat, gscene.granule.lon,
                                  gscene.fires,
                                  gscene.fires["date_time"][0], GAUSS)[0]
    if len(located) < GAUSS.min_fires_per_scene:
        raise AssertionError(f"gaussian scene has {len(located)} fires")
    truncated = max(0, len(located) - GAUSS.max_fires)
    print(f"gaussian scene: {len(located)} raw fires located; the detector "
          f"keeps the first {GAUSS.max_fires} (its capacity, unbucketed) and "
          f"drops {truncated} before clustering, as the JAX function does, "
          "so the gaussian times below are of a truncated run", flush=True)
    runs = {
        "basic_1200": (basic_split, (aod, g.lat, g.lon,
                                     bench.fires["date_time"][0],
                                     bench.fires)),
        "gaussian_1200x2": (gaussian_split, (gscene.granule, gscene.fires,
                                             gscene.fires["date_time"][0])),
    }
    res = {}
    for name, (split, scene) in runs.items():
        timings = {"kernels": [], "plain": []}
        results = {}
        before = ccl_sweep.MASK_LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        for plain in (False, True, True, False):
            ms, result = split(scene, plain)
            key = "plain" if plain else "kernels"
            timings[key].append(ms)
            results.setdefault(key, result)
            print(f"identify {name} ({key}): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                  + " ms", flush=True)
        k2_launches = ccl_sweep.MASK_LAUNCHES - before
        if k2_launches <= 0:
            raise AssertionError(f"{name}: K2 was not launched")
        if name == "basic_1200":
            (kd, ki), (pd_, pi) = results["kernels"], results["plain"]
            same = kd == pd_ and np.array_equal(ki, pi)
            found = len(kd)
        else:
            same = results["kernels"] == results["plain"]
            found = len({(r[0], r[-1]) for r in results["kernels"]})
        if not same:
            raise AssertionError(f"{name}: kernels and plain versions give "
                                 "different plumes")
        if not found:
            raise AssertionError(f"{name}: no plume found")
        res[name] = {"runs": timings, "plumes": found,
                     "k2_launches": k2_launches,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name != "basic_1200":
            res[name]["located_fires"] = int(len(located))
            res[name]["fires_dropped_at_capacity"] = truncated
        print(f"identify {name}: {found} plumes, K2 launches {k2_launches}, "
              f"peak {res[name]['peak_gb']:.2f} GB"
              + ("" if name == "basic_1200" else
                 f"; {len(located)} raw fires truncated to {GAUSS.max_fires}"),
              flush=True)
    torch.cuda.empty_cache()
    return res


def read_extent(root, base):
    """The ``<base>_extent.csv`` of a basic or gaussian run: header and
    rows of strings."""
    from plumekit_torch.config import PathsConfig

    path = os.path.join(PathsConfig(root=root).resolve("hull_df_dir"),
                        base + "_extent.csv")
    with open(path) as f:
        return list(csv.reader(f))


def assert_extent_equal(got, want, base):
    """Card and CPU extent CSVs: ids, pixel coordinates, bounding boxes and
    the datetime exact; hull latitudes and longitudes are read from the
    same grid, rtol 1e-5."""
    if got[0] != want[0] or len(got) != len(want):
        raise AssertionError(f"{base}: header or row count differ "
                             f"({len(got)} vs {len(want)} rows)")
    for j, col in enumerate(want[0]):
        g, w = [r[j] for r in got[1:]], [r[j] for r in want[1:]]
        if col == "datetime":
            ok = g == w
        elif col in ("hull_lats", "hull_lons"):
            ok = np.allclose(np.asarray(g, float), np.asarray(w, float),
                             rtol=FEATURE_RTOL, atol=0.0)
        else:
            ok = np.array_equal(np.asarray(g, float), np.asarray(w, float))
        if not ok:
            raise AssertionError(f"{base} {col}: card {g} vs CPU {w}")


def detector_features_path(tmp, detector, scene_kw):
    """``build_features --detector basic|gaussian`` over four synthetic
    1200² granules on the card: the detector's kernels must launch and
    plumes must be found; the first granule's CSV must equal a
    ``--device cpu`` run."""
    root, cpu_root, names = feature_root(tmp, detector, scene_kw)
    ccl_sweep.LAUNCHES = ccl_sweep.MASK_LAUNCHES = label_counts.LAUNCHES = 0
    secs = build_features(root, "--detector", detector)
    launches = {"k1": ccl_sweep.LAUNCHES, "k2": ccl_sweep.MASK_LAUNCHES,
                "k3": label_counts.LAUNCHES}
    needed = ("k2",) if detector == "basic" else ("k1", "k2", "k3")
    if not all(launches[k] > 0 for k in needed):
        raise AssertionError(f"build_features --detector {detector} did not "
                             f"launch {needed}: {launches}")
    outputs = {n: read_extent(root, n) for n in names}
    id_cols = 1 if detector == "basic" else 2      # id, or id and datetime
    plumes = {n: len({(r[0], r[-1])[:id_cols] for r in o[1:]})
              for n, o in outputs.items()}
    if not sum(plumes.values()):
        raise AssertionError(f"build_features --detector {detector} found "
                             "no plume")
    cpu_s = build_features(cpu_root, "--detector", detector, "--device",
                           "cpu")
    assert_extent_equal(outputs[names[0]], read_extent(cpu_root, names[0]),
                        names[0])
    res = {"granules": FEATURE_GRANULES, "granule_px": scene_kw["size"],
           "seconds": secs, "s_per_granule": secs / FEATURE_GRANULES,
           "launches": launches, "plumes": plumes,
           "cpu_seconds_one_granule": cpu_s}
    print(f"build_features --detector {detector} {FEATURE_GRANULES}x"
          f"{scene_kw['size']}^2 on the card: {secs:.2f} s "
          f"({secs / FEATURE_GRANULES:.3f} s/granule), launches {launches}, "
          f"plumes {plumes}; {names[0]} equals the --device cpu run "
          f"({cpu_s:.2f} s)", flush=True)
    return res


# ------------------------------------ VIIRS swaths, the real-granule check
VIIRS_LINES, VIIRS_SAMPLES = 768, 3200   # one 86 s IVAOT M-band granule


def viirs_split(scene, device):
    """``identify_viirs_arrays`` of one scene on ``device``, timed by
    phase: the plan (kd-tree build and query, the resample, the grid's
    coordinates), host fire prep, K2 (on the CPU its plain version), host
    post-processing and the rest of the detector's device program."""
    aod, lat, lon, date, fires = scene
    clock, timed = phase_clock(("plan", "host_prep", "k2", "host_post"))
    patches = {
        (viirs_aod, "resample_viirs_aod"): timed(
            "plan", viirs_aod.resample_viirs_aod),
        (basic, "_prep_fires"): timed("host_prep", basic._prep_fires),
        (basic, "multi_threshold_ccl"): timed(
            "k2", ccl_sweep.multi_threshold_ccl),
        (basic, "_to_host"): timed("host_post", basic._to_host),
    }
    with Patched(patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = viirs_aod.identify_viirs_arrays(aod, lat, lon, date, fires,
                                              device=device)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    ms = {k: v * 1e3 for k, v in clock.items()}
    ms["device_rest"] = total * 1e3 - sum(ms.values())
    ms["total"] = total * 1e3
    return ms, out


class LogCapture(logging.Handler):
    """The messages a logger emits inside a ``with`` block."""

    def __init__(self, name):
        super().__init__()
        self.logger, self.messages = logging.getLogger(name), []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def viirs_files(tmp):
    """The VIIRS file commands. Without h5py (the card's machine has
    none): ``resample_viirs`` on a one-swath root must exit 1 naming h5py
    and leave no ``.h5``. With it: ``make_dataset --viirs-aod-pairs 1``,
    ``resample_viirs`` and ``identify_viirs`` on the card, whose mask must
    equal ``identify_viirs_arrays`` of the same scene in memory."""
    root = os.path.join(tmp, "viirs_root")
    h5_dir = os.path.join(root, "raw", "reprojected_viirs", "h5")
    if importlib.util.find_spec("h5py") is None:
        run_cli("make_dataset", "--root", root, "--n-granules", "1",
                "--size", "64", "--viirs-swaths", "1")
        with LogCapture("plumekit_torch.cli") as log:
            rc = cli.main(["resample_viirs", "--root", root])
        named = any("requires h5py" in m for m in log.messages)
        left = os.listdir(h5_dir) if os.path.isdir(h5_dir) else []
        print(f"VIIRS files without h5py: resample_viirs exit {rc}, "
              f"{log.messages}, .h5 left {left}", flush=True)
        if rc != 1 or not named or left:
            raise AssertionError("resample_viirs without h5py must exit 1 "
                                 "naming h5py and write nothing")
        return {"branch": "no_h5py", "exit": rc, "messages": log.messages}
    stamp, aod, lat, lon, fires, _ = viirs_aod.make_synthetic_ivaot_scene(
        seed=SEED)
    want = viirs_aod.identify_viirs_arrays(
        aod, *(np.asarray(v, np.float32).astype(np.float64)
               for v in (lat, lon)), stamp.date, fires, device=DEV)
    run_cli("make_dataset", "--root", root, "--n-granules", "1", "--size",
            "64", "--seed", str(SEED), "--viirs-swaths", "1",
            "--viirs-aod-pairs", "1")
    run_cli("resample_viirs", "--root", root)
    ccl_sweep.MASK_LAUNCHES = 0
    secs = run_cli("identify_viirs", "--root", root)
    launches = ccl_sweep.MASK_LAUNCHES
    masks = os.path.join(root, "raw", "viirs", "masks")
    [npz] = [f for f in os.listdir(masks) if f.endswith("_mask.npz")]
    with np.load(os.path.join(masks, npz)) as z:
        image, aod = z["plume_image"], z["aod"]
    equal = (image.dtype == want[1].dtype and np.array_equal(image, want[1])
             and np.array_equal(aod, np.nan_to_num(want[2], nan=-999.0)))
    print(f"VIIRS files with h5py: make_dataset, resample_viirs, "
          f"identify_viirs {secs:.2f} s, K2 launches {launches}, mask "
          f"{'equal to' if equal else 'DIFFERS from'} the in-memory run",
          flush=True)
    if not (equal and launches):
        raise AssertionError("identify_viirs' mask differs from "
                             "identify_viirs_arrays' or launched no K2")
    return {"branch": "h5py", "identify_viirs_s": secs, "k2": launches}


def verify_path(tmp):
    """``verify_real_granule --fires --detector rg`` on the bench's 1200²
    ``.npz`` granule on the card (K1 and K3 must launch) and with
    ``--device cpu``: both exit 0 with equal summaries."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BENCH_SCENE))
    gpath = os.path.join(tmp, bench.granule.name + ".npz")
    fpath = os.path.join(tmp, "fires.csv")
    save_granule(gpath, bench.granule)
    write_fire_csv(fpath, bench.fires)
    argv = ("verify_real_granule", gpath, "--fires", fpath, "--detector",
            "rg")
    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
    card_s, card = run_cli_json(*argv)
    launches = {"k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}
    cpu_s, cpu = run_cli_json(*argv, "--device", "cpu")
    print(f"verify_real_granule rg {BENCH_SCENE['size']}^2: card {card_s:.2f}"
          f" s, launches {launches}; --device cpu {cpu_s:.2f} s; summaries "
          f"{'equal' if card == cpu else 'DIFFER'}", flush=True)
    if card != cpu or not card["ok"]:
        raise AssertionError(f"verify_real_granule: card {card}, cpu {cpu}")
    if not (launches["k1"] and launches["k3"]):
        raise AssertionError(f"verify_real_granule launched {launches}")
    return {"summary": card, "card_s": card_s, "cpu_s": cpu_s,
            "launches": launches}


def viirs_phase(tmp):
    """The VIIRS workflow at a real granule's size: ``identify_viirs_arrays``
    of a synthetic 768 × 3200 IVAOT scene (geolocation through float32, as
    the GMTCO file stores it) on the card, timed by phase, against the CPU
    (plume boxes equal, plume images bit for bit); K2 on that UTM grid's
    opened mask against its plain version, bit for bit, queued beside its
    bytes bound; ``verify_real_granule`` (K1, K3); the file commands."""
    t0 = time.perf_counter()
    stamp, aod, lat, lon, fires, _ = viirs_aod.make_synthetic_ivaot_scene(
        lines=VIIRS_LINES, samples=VIIRS_SAMPLES, seed=SEED)
    lat, lon = (np.asarray(v, np.float32).astype(np.float64)
                for v in (lat, lon))
    scene = (aod, lat, lon, np.datetime64(stamp.date, "D"), fires)
    ccl_sweep.MASK_LAUNCHES = 0
    card_ms, card = viirs_split(scene, DEV)
    k2_launches = ccl_sweep.MASK_LAUNCHES
    cpu_ms, cpu = viirs_split(scene, torch.device("cpu"))
    plumes, image, aod_r, rs = card
    same = (plumes == cpu[0] and image.dtype == cpu[1].dtype
            and np.array_equal(image, cpu[1])
            and np.array_equal(aod_r, cpu[2], equal_nan=True))
    grid = f"{rs.y_size}x{rs.x_size}"
    print(f"identify_viirs_arrays {VIIRS_LINES}x{VIIRS_SAMPLES} swath -> "
          f"{grid} UTM grid (zone {rs.zone}{'S' if rs.south else 'N'}, "
          f"{float(rs.valid.mean()):.3f} valid), {len(plumes)} plume(s), "
          f"{int((image > 0).sum())} px, K2 launches {k2_launches}; card ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in card_ms.items())
          + "; cpu ms " + ", ".join(f"{k} {v:.1f}" for k, v in cpu_ms.items())
          + f"; card {'equals' if same else 'DIFFERS from'} the CPU",
          flush=True)
    if not same:
        raise AssertionError("identify_viirs_arrays: card and CPU differ")
    if not (plumes and k2_launches):
        raise AssertionError(f"identify_viirs_arrays found {plumes} with "
                             f"{k2_launches} K2 launches")
    plane = torch.from_numpy(np.nan_to_num(aod_r, nan=-999.0)).to(DEV)
    limit = torch.tensor(BASIC.aod_min_limit, dtype=plane.dtype, device=DEV)
    k2_row = check_masks(f"viirs_utm_{grid}", binary_opening_cross(
        plane >= limit)[None].contiguous())
    del plane
    res = {"swath": [VIIRS_LINES, VIIRS_SAMPLES],
           "grid": [rs.y_size, rs.x_size], "zone": rs.zone,
           "south": rs.south, "valid_share": float(rs.valid.mean()),
           "plumes": plumes, "plume_px": int((image > 0).sum()),
           "card_ms": card_ms, "cpu_ms": cpu_ms,
           "launches": {"k2": k2_launches}, "k2_row": k2_row,
           "verify": verify_path(tmp),
           "files": viirs_files(tmp)}
    res["seconds"] = time.perf_counter() - t0
    print(f"VIIRS phase {res['seconds']:.1f} s", flush=True)
    return res


# ------------------------------------------------------------- training
# step parity: UNetConfig() widths, 8 tiles of 128² from seed 0, three
# steps from the same weights on the card in fp32 (TF32 off) and bf16 and on
# the CPU in fp32 and in float64, the reference; warmup 1, so the first
# update runs at lr 0 (as in optax) and the next two at the peak and down
# the cosine
PARITY_TRAIN = TrainConfig(batch_size=8, tile_size=128, warmup_steps=1,
                           total_steps=4, augment=False)
PARITY_STEPS = 3
# fp32 against fp32: the loss and IoU of the same function, every step
TRAIN_LOSS_RTOL = 1e-4
TRAIN_IOU_ATOL = 1e-3                 # a few pixels at the 0.5 threshold
# Gradients and running statistics of steps 1 and 2, whose forwards see the
# same weights (step 1's lr is 0), against the float64 step's: fp32 is 1-2%
# of a tensor's largest gradient away from it in the deep blocks (batch
# norm's backward over 8 × 8² planes cancels), on the CPU as on the card, so
# the card's largest distance is held to this many times the CPU fp32
# step's, plus a floor of fp32 rounding. After a real update the runs part:
# Adam turns the rounding of near-zero gradients into steps of about lr of
# either sign, so from step 3 only the loss and IoU are compared, and the
# update itself is checked on equal inputs (check_adamw)
TRAIN_F64_FACTOR = 4.0
TRAIN_F64_FLOOR = {"grads": 1e-5, "stats": 1e-6}
# one AdamW update from the same state and gradients: 1e-3 of the peak lr
TRAIN_PARAM_RTOL = 1e-3
# bf16 on the card against the float64 step
TRAIN_BF16_LOSS_RTOL = 2e-2
TRAIN_BF16_MIN_CORR = 0.99            # of all gradients together
# the quick-start chain on the card
CHAIN_GRANULES, CHAIN_PX = 4, 1200
CHAIN_TILE, CHAIN_BATCH = 512, 16
CHAIN_STEPS = (40, 60)                # train_model, then its resume
EVAL_TILE = 128                       # a tile K7 takes at UNetConfig()


def train_parity_batches():
    """PARITY_STEPS batches of 8 × 128² tiles of two synthetic 256²
    granules, drawn from ``default_rng(0)``."""
    samples = make_synthetic_dataset(DataConfig(granule_size=256,
                                                n_train_granules=2))
    stream = tile_batches(samples, PARITY_TRAIN.tile_size,
                          PARITY_TRAIN.batch_size, np.random.default_rng(SEED))
    return [next(stream) for _ in range(PARITY_STEPS)]


def run_train_steps(cfg, device, weights, batches):
    """Per step: loss, IoU, each parameter's gradient, and the parameters
    and buffers after the step, on the CPU."""
    state = create_state(cfg, PARITY_TRAIN, device)
    state.model.load_state_dict(weights)
    step = make_train_step(PARITY_TRAIN.dice_weight, augment=False)
    out = []
    for xs, ys in batches:
        state, m = step(state, torch.from_numpy(xs).to(device),
                        torch.from_numpy(ys).to(device), None)
        out.append({
            "loss": float(m["loss"]), "iou": float(m["iou"]),
            "grads": {n: p.grad.detach().cpu().clone()
                      for n, p in state.model.named_parameters()},
            "state": {n: t.detach().cpu().clone()
                      for n, t in state.model.state_dict().items()}})
    return out


def _distance(run, ref, key, pick):
    """Largest |run - ref| over the tensors of ``run[key]`` that ``pick``
    names, each over its own largest |ref| for gradients (their scales
    differ by orders between blocks) and absolute otherwise."""
    worst = 0.0
    for n, w in ref[key].items():
        if not pick(n):
            continue
        d = float((run[key][n] - w).abs().max())
        if key == "grads":
            d /= max(float(w.abs().max()), 1e-30)
        worst = max(worst, d)
    return worst


def check_adamw(weights, batches):
    """One AdamW update on the card and on the CPU from the same state (the
    CPU fp32 run's after two steps, moments included) and the same
    gradients (the CPU's, of the third batch): the updated parameters."""
    f32 = UNetConfig(compute_dtype="float32")
    cpu = create_state(f32, PARITY_TRAIN, torch.device("cpu"))
    cpu.model.load_state_dict(weights)
    step = make_train_step(PARITY_TRAIN.dice_weight, augment=False)
    for xs, ys in batches[:2]:
        step(cpu, torch.from_numpy(xs), torch.from_numpy(ys), None)
    card = create_state(f32, PARITY_TRAIN, DEV)
    card.load_state_dict(copy.deepcopy(cpu.state_dict()))
    xs, ys = (torch.from_numpy(a) for a in batches[2])
    cpu.optimizer.zero_grad(set_to_none=True)
    dice_bce_loss(cpu.model(xs), ys, PARITY_TRAIN.dice_weight).backward()
    for pc, pg in zip(cpu.model.parameters(), card.model.parameters()):
        pg.grad = pc.grad.to(DEV)
    lr = cpu.optimizer.param_groups[0]["lr"]
    cpu.optimizer.step()
    card.optimizer.step()
    err = max(float((pc.detach() - pg.detach().cpu()).abs().max())
              for pc, pg in zip(cpu.model.parameters(),
                                card.model.parameters()))
    tol = TRAIN_PARAM_RTOL * PARITY_TRAIN.learning_rate
    print(f"AdamW update at lr {lr:.3g} from the same state and gradients: "
          f"card against CPU max|dp| {err:.3g} (allowed {tol:.3g})",
          flush=True)
    if err > tol:
        raise AssertionError(f"AdamW on the card: max|dp| {err} > {tol}")
    return {"lr": lr, "max_abs_dparam": err}


def _distance(run, ref, key, pick):
    """Largest |run - ref| over the tensors of ``run[key]`` that ``pick``
    names, each over its own largest |ref| for gradients (their scales
    differ by orders between blocks) and absolute otherwise."""
    worst = 0.0
    for n, w in ref[key].items():
        if not pick(n):
            continue
        d = float((run[key][n] - w).abs().max())
        if key == "grads":
            d /= max(float(w.abs().max()), 1e-30)
        worst = max(worst, d)
    return worst


def check_train_parity():
    """Three steps on the card in fp32 and bf16 against the CPU in fp32 and
    float64, and one AdamW update on equal inputs (see PARITY_TRAIN)."""
    t0 = time.perf_counter()
    weights = build_model(UNetConfig(compute_dtype="float32"),
                          torch.Generator().manual_seed(SEED)).state_dict()
    batches = train_parity_batches()
    cpu = torch.device("cpu")
    runs = {name: run_train_steps(UNetConfig(compute_dtype=dtype), dev,
                                  weights, batches)
            for name, dtype, dev in (("cpu64", "float64", cpu),
                                     ("cpu32", "float32", cpu),
                                     ("card32", "float32", DEV),
                                     ("bf16", "bfloat16", DEV))}
    schedule = make_schedule(PARITY_TRAIN)

    def params(n):
        return not n.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))

    def stats(n):
        return n.endswith(("running_mean", "running_var"))

    rows = []
    for i in range(PARITY_STEPS):
        ref, c, g, b = (runs[k][i] for k in ("cpu64", "cpu32", "card32",
                                             "bf16"))
        dist = {k: {"grads": _distance(runs[k][i], ref, "grads",
                                       lambda n: True),
                    "stats": _distance(runs[k][i], ref, "state", stats),
                    "params": _distance(runs[k][i], ref, "state", params)}
                for k in ("cpu32", "card32")}
        flat64 = torch.cat([w.ravel() for w in ref["grads"].values()])
        flat16 = torch.cat([b["grads"][n].ravel() for n in ref["grads"]])
        corr = float(np.corrcoef(flat64.numpy(), flat16.numpy())[0, 1])
        same_weights = i < 2          # the forward saw the initial weights
        row = {"step": i + 1, "lr": schedule(i), "same_weights": same_weights,
               **{f"{k}_loss": runs[k][i]["loss"] for k in runs},
               **{f"{k}_iou": runs[k][i]["iou"] for k in runs},
               "distance_to_float64": dist, "bf16_grad_corr": corr}
        rows.append(row)
        print(f"train step {i + 1} (lr {schedule(i):.3g}): loss float64 "
              f"{ref['loss']:.7f}, cpu fp32 {c['loss']:.7f}, card fp32 "
              f"{g['loss']:.7f}, bf16 {b['loss']:.7f}; iou {c['iou']:.5f} / "
              f"{g['iou']:.5f} / {b['iou']:.5f}; distance to float64, cpu "
              f"fp32 / card fp32: gradients {dist['cpu32']['grads']:.3g} / "
              f"{dist['card32']['grads']:.3g} of each tensor's largest, "
              f"running stats {dist['cpu32']['stats']:.3g} / "
              f"{dist['card32']['stats']:.3g}, parameters after the step "
              f"{dist['cpu32']['params']:.3g} / "
              f"{dist['card32']['params']:.3g}; bf16 gradient correlation "
              f"{corr:.5f}", flush=True)
        ok = (abs(g["loss"] - c["loss"]) <= TRAIN_LOSS_RTOL * abs(c["loss"])
              and abs(g["iou"] - c["iou"]) <= TRAIN_IOU_ATOL)
        if same_weights:
            ok = ok and all(
                dist["card32"][k] <= TRAIN_F64_FACTOR * dist["cpu32"][k]
                + floor for k, floor in TRAIN_F64_FLOOR.items())
        if not ok:
            raise AssertionError(f"fp32 train step {i + 1}: the card's step "
                                 f"is off the CPU's: {row}")
        if not (abs(b["loss"] - ref["loss"])
                <= TRAIN_BF16_LOSS_RTOL * abs(ref["loss"])
                and (corr > TRAIN_BF16_MIN_CORR or not same_weights)):
            raise AssertionError(f"bf16 train step {i + 1}: off the float64 "
                                 f"step: {row}")
    return {"steps": rows, "adamw": check_adamw(weights, batches),
            "seconds": time.perf_counter() - t0}


def read_served(root):
    """``{name: probs}`` of every prediction file of ``root``; each must
    be finite probabilities with the mask thresholded from them."""
    out = os.path.join(root, "processed", "predictions")
    preds = {}
    for f in sorted(os.listdir(out)):
        with np.load(os.path.join(out, f)) as d:
            probs, mask, th = d["probs"], d["mask"], float(d["threshold"])
        if probs.shape != (CHAIN_PX, CHAIN_PX) or \
                not np.isfinite(probs).all() or probs.min() < 0 or \
                probs.max() > 1 or not np.array_equal(mask, probs > th):
            raise AssertionError(f"{f}: bad prediction {probs.shape}")
        preds[f] = probs
    if len(preds) != CHAIN_GRANULES:
        raise AssertionError(f"predict_model wrote {sorted(preds)}")
    return preds


def run_cli(*argv):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"{argv[0]} {argv} exited {rc}")
    return time.perf_counter() - t0


def check_eval_routes(weights, samples):
    """The trained weights in a ``use_pallas`` (K6) and a ``use_mega`` (K7)
    model: an eval, one optimizer step, an eval again; each eval against
    the plain eval of the same weights. Both routes cache packed weights
    per model, so the second eval shows that a step refreshes them."""
    xs, ys = (torch.from_numpy(a).to(DEV) for a in next(tile_batches(
        samples, EVAL_TILE, 16, np.random.default_rng(1))))
    plain = build_model(UNetConfig()).to(DEV).eval()
    step = make_train_step()
    res = {}
    for flag, module, rtol in (("use_pallas", fused_conv, LOGIT_RTOL),
                               ("use_mega", unet_mega, MEGA_RTOL)):
        state = create_state(dataclasses.replace(UNetConfig(), **{flag: True}),
                             TrainConfig(batch_size=16, tile_size=EVAL_TILE),
                             DEV)
        state.model.load_state_dict(weights)
        rounds = []
        for r in range(2):
            module.LAUNCHES = 0
            with torch.no_grad():
                got = state.model.eval()(xs)
            launches = module.LAUNCHES
            plain.load_state_dict(state.model.state_dict())
            with torch.no_grad():
                want = plain(xs)
            cmp = compare_logits(f"{flag} eval after {r} steps", got, want,
                                 rtol)
            blocks = 2 * state.model.cfg.depth + 1
            if launches != (blocks if flag == "use_pallas" else 1):
                raise AssertionError(f"{flag} eval launched its kernel "
                                     f"{launches} times")
            rounds.append({**cmp, "launches": launches})
            state, _ = step(state, xs, ys, step_generator(SEED, r, DEV))
        res[flag] = rounds
        print(f"{flag} eval at {xs.shape[0]}x{EVAL_TILE}^2 after training, "
              f"before and after one more step: max|diff| "
              f"{rounds[0]['max_abs_diff']:.4g}, {rounds[1]['max_abs_diff']:.4g}"
              f" of max|logit| {rounds[1]['max_abs_logit']:.4g}, corr "
              f"{rounds[1]['corr']:.6f}, launches {rounds[1]['launches']}",
              flush=True)
    return res


def train_chain(tmp):
    """make_dataset → build_features --detector rg → train_model
    --weak-labels (then resumed) → predict_model plain and --fused, on
    the card, at UNetConfig()."""
    root = os.path.join(tmp, "train_root")
    res = {"seconds": {}}
    res["seconds"]["make_dataset"] = run_cli(
        "make_dataset", "--root", root, "--n-granules", str(CHAIN_GRANULES),
        "--size", str(CHAIN_PX))
    res["seconds"]["build_features"] = run_cli(
        "build_features", "--root", root, "--detector", "rg")

    # the weak labeller on the card and on the CPU: one granule, bit for bit
    scene = weak_label_scene(0, DataConfig(granule_size=CHAIN_PX))
    card_mask = weak_label_mask(scene, device=DEV)
    cpu_mask = weak_label_mask(scene, device="cpu")
    if not card_mask.any() or not np.array_equal(card_mask, cpu_mask):
        raise AssertionError("weak labels on the card differ from the CPU's "
                             f"({int(card_mask.sum())} vs "
                             f"{int(cpu_mask.sum())} px)")

    train_argv = ["train_model", "--root", root, "--weak-labels",
                  "--granule-size", str(CHAIN_PX), "--tile", str(CHAIN_TILE),
                  "--batch-size", str(CHAIN_BATCH)]
    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    res["seconds"]["train_model"] = run_cli(*train_argv, "--steps",
                                            str(CHAIN_STEPS[0]))
    res["launches"] = {"k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}
    res["train_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not (res["launches"]["k1"] > 0 and res["launches"]["k3"] > 0):
        raise AssertionError("train_model --weak-labels did not launch K1 "
                             f"and K3: {res['launches']}")
    ckpt = os.path.join(root, "models", "checkpoints")
    metrics = ckpt + "_metrics.csv"
    with open(metrics) as f:
        first = list(csv.DictReader(f))
    res["seconds"]["train_model_resumed"] = run_cli(
        *train_argv, "--steps", str(CHAIN_STEPS[1]))
    with open(metrics) as f:
        rows = list(csv.DictReader(f))
    want_steps = [str(s) for s in range(20, CHAIN_STEPS[1] + 1, 20)]
    if [r["step"] for r in rows] != want_steps or rows[:len(first)] != first:
        raise AssertionError(f"the resumed run's metrics do not continue the "
                             f"first run's: {rows}")
    res["metrics"] = rows
    if sorted(os.listdir(ckpt)) != ["model_config.json", "step_00000040.pt",
                                    "step_00000060.pt", "weights.pt"]:
        raise AssertionError(f"checkpoints: {sorted(os.listdir(ckpt))}")

    fused_conv.LAUNCHES = 0
    res["seconds"]["predict_fused"] = run_cli("predict_model", "--root", root,
                                              "--fused")
    res["k6_serving_launches"] = fused_conv.LAUNCHES
    fused = read_served(root)
    res["seconds"]["predict_plain"] = run_cli("predict_model", "--root", root)
    plain = read_served(root)
    max_dp, share, confident = compare_served(fused, plain)
    res["served"] = {"max_abs_dprobs": max_dp, "mask_flip_share": share,
                     "confident_flips": confident,
                     "plume_share": float(np.mean([(p > 0.5).mean()
                                                   for p in plain.values()]))}
    if max_dp > PROB_ATOL or confident or not res["k6_serving_launches"]:
        raise AssertionError(f"served trained checkpoint: {res['served']}, "
                             f"K6 launches {res['k6_serving_launches']}")
    int8_conv.LAUNCHES = int8_upsample.LAUNCHES = 0
    res["seconds"]["predict_int8"] = run_cli("predict_model", "--root", root,
                                             "--int8")
    res["q1_serving_launches"] = int8_conv.LAUNCHES
    res["q2_serving_launches"] = int8_upsample.LAUNCHES
    max_dp8, share8, _ = compare_served(read_served(root), plain)
    res["served_int8"] = {"max_abs_dprobs": max_dp8, "mask_flip_share": share8}
    print(f"predict_model --int8 on the trained checkpoint: mask flips "
          f"{share8:.3e} against the plain forward (bound "
          f"{INT8_MAX_FLIP_SHARE}), max|dprobs| {max_dp8:.4g}, Q1 launches "
          f"{res['q1_serving_launches']}, Q2 launches "
          f"{res['q2_serving_launches']}", flush=True)
    if (share8 >= INT8_MAX_FLIP_SHARE or not res["q1_serving_launches"]
            or not res["q2_serving_launches"]):
        raise AssertionError(f"int8 serving of the trained checkpoint: "
                             f"{res['served_int8']}, Q1 launches "
                             f"{res['q1_serving_launches']}, Q2 launches "
                             f"{res['q2_serving_launches']}")

    weights = torch.load(os.path.join(ckpt, "weights.pt"), map_location=DEV)
    samples = make_synthetic_dataset(DataConfig(granule_size=256,
                                                n_eval_granules=1),
                                     train=False)
    res["eval_routes"] = check_eval_routes(weights, samples)
    print(f"train chain on the card: make_dataset {CHAIN_GRANULES}x"
          f"{CHAIN_PX}^2, build_features rg, train_model --weak-labels "
          f"{CHAIN_STEPS[0]} steps of {CHAIN_BATCH}x{CHAIN_TILE}^2 then "
          f"resumed to "
          f"{CHAIN_STEPS[1]} (loss {rows[-1]['loss']}, K1 "
          f"{res['launches']['k1']} and K3 {res['launches']['k3']} launches "
          f"while labelling, peak {res['train_peak_memory_gb']:.2f} GB), "
          f"predict_model --fused against plain max|dprobs| {max_dp:.4g}; "
          "seconds " + ", ".join(f"{k} {v:.2f}"
                                 for k, v in res["seconds"].items()),
          flush=True)
    return res


def train_phase(tmp):
    """Step parity, timed steps at both geometries, and the chain."""
    t0 = time.perf_counter()
    res = {"parity": check_train_parity()}
    torch.cuda.empty_cache()
    res["step_times"] = []
    for name in train_step_times.GEOMETRIES:
        row = train_step_times.time_geometry(name, TRAIN_TIMED_STEPS, DEV)
        res["step_times"].append(row)
        print(train_step_times.summary(row), flush=True)
        torch.cuda.empty_cache()
    res["chain"] = train_chain(tmp)
    res["seconds"] = time.perf_counter() - t0
    print(f"training phase {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------- curation, evaluation

CURATION_MIN_SIZE = 100               # the reference's region floor
CURATION_BOOTSTRAP = 200
DISTILL_STEPS = 20


def run_cli_json(*argv):
    """``run_cli`` of a command that prints one JSON line: (seconds,
    payload)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        seconds = run_cli(*argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    return seconds, json.loads(out.strip().splitlines()[-1])


def host_labels(mask):
    """scipy's 8-connected labels on the host: numbered 1..n in raster
    order of first pixel, as the JAX package's host CCL numbers them."""
    from scipy import ndimage

    labels, n = ndimage.label(mask, structure=np.ones((3, 3)))
    return labels.astype(np.int32), n


def host_object_counts(pred, true, min_size):
    from plumekit_torch.train.evaluate import object_counts_from_labels

    return object_counts_from_labels(*host_labels(pred), *host_labels(true),
                                     0.5, min_size)


def eval_pairs(root, *flags):
    """The (name, probs, true) pairs ``evaluate_model --root root *flags``
    scores, through the same restore and inference."""
    from plumekit_torch.train.evaluate import inference_prob_pairs

    args = cli.build_parser().parse_args(["evaluate_model", "--root", root,
                                          *flags])
    cfg, model = cli._restore_model(args, DEV)
    infer = cli._evaluation_infer(args, cfg, DEV)
    data = os.path.join(root, "processed", "model_data")
    return list(inference_prob_pairs(infer, model, data))


def check_object_counts(pairs):
    """K2's per-sample counts and object sweep (the functions the CLI
    calls) against scipy's labels on the host, and at threshold 0.5
    against K2's plain version on the card."""
    from plumekit_torch.train import evaluate as ev

    th = ev.default_thresholds()
    table = ev.evaluate_objects(iter(pairs), min_size=CURATION_MIN_SIZE,
                                device=DEV)
    sweep = ev.sweep_object_thresholds(iter(pairs),
                                       min_size=CURATION_MIN_SIZE, device=DEV)
    want_rows = [host_object_counts(p > 0.5, t, CURATION_MIN_SIZE)
                 for _n, p, t in pairs]
    got_rows = [np.array(r[-3:]) for r in table.rows[:-1]]
    if any(not np.array_equal(g, w) for g, w in zip(got_rows, want_rows)):
        raise AssertionError(f"object counts: K2 {got_rows}, host "
                             f"{want_rows}")
    pooled = np.zeros((th.size, 3), np.int64)
    for _n, p, t in pairs:
        for i, tv in enumerate(th):
            pooled[i] += host_object_counts(p > tv, t, CURATION_MIN_SIZE)
    want_sweep = [(float(tv),) + tuple(ev.object_metrics_from_counts(c)
                                       .values())
                  for tv, c in zip(th, pooled)]
    if sweep.rows != want_sweep:
        raise AssertionError(f"object sweep: K2 {sweep.rows}, host "
                             f"{want_sweep}")
    real = ccl_sweep.multi_threshold_ccl
    ccl_sweep.multi_threshold_ccl = (
        lambda m, connectivity=2, nested=True:
        ccl_sweep.multi_threshold_ccl_masks_ref(m, connectivity))
    try:
        plain_rows = [ev.object_counts(p > 0.5, t, 0.5, CURATION_MIN_SIZE,
                                       device=DEV) for _n, p, t in pairs]
    finally:
        ccl_sweep.multi_threshold_ccl = real
    if any(not np.array_equal(g, w) for g, w in zip(plain_rows, want_rows)):
        raise AssertionError(f"object counts: K2's plain version "
                             f"{plain_rows}, host {want_rows}")
    return {"per_sample": [r.tolist() for r in got_rows],
            "sweep_obj_f1": [r[-1] for r in sweep.rows]}


def check_mega_eval(root, mega_ckpt):
    """The use_mega checkpoint's probabilities at tile 96 against the plain
    forward's: masks may differ only where the plain probability is within
    PROB_ATOL of 0.5."""
    flags = ["--tile", str(MEGA.tile_size), "--overlap", str(MEGA.overlap)]
    plain = eval_pairs(root, *flags)
    unet_mega.LAUNCHES = 0
    mega = eval_pairs(root, "--checkpoint", mega_ckpt, *flags)
    launches = unet_mega.LAUNCHES
    res = {"launches": launches, "flips": 0, "unexplained_flips": 0,
           "max_abs_dprobs": 0.0}
    for (_n, p, _t), (_m, q, _u) in zip(plain, mega):
        flip = (p > 0.5) != (q > 0.5)
        res["flips"] += int(flip.sum())
        res["unexplained_flips"] += int((flip & (np.abs(p - 0.5)
                                                 > PROB_ATOL)).sum())
        res["max_abs_dprobs"] = max(res["max_abs_dprobs"],
                                    float(np.abs(p - q).max()))
    if not launches or res["unexplained_flips"]:
        raise AssertionError(f"use_mega evaluation: {res}")
    return res


def flagged_copy(ckpt, dst, **flags):
    """A copy of the checkpoint's config and weights with ``flags`` set."""
    os.makedirs(dst)
    shutil.copy(os.path.join(ckpt, "weights.pt"), dst)
    save_model_config(dst, dataclasses.replace(load_model_config(ckpt),
                                               **flags))
    return dst


def curation_phase(tmp):
    """select → prepare_model_data → evaluate_model (K2; K7) → train_model
    --curated --distill-* (K6) → predict_model with the calibrated
    threshold, on train_chain's root and trained checkpoint."""
    import logging

    from plumekit_torch.config import PathsConfig
    from plumekit_torch.io.tables import Table
    from plumekit_torch.train import distill
    from plumekit_torch.train.curated import (build_model_data,
                                              make_curated_dataset)

    t0 = time.perf_counter()
    root = os.path.join(tmp, "train_root")
    paths = PathsConfig(root=root)
    ckpt = os.path.join(root, "models", "checkpoints")
    res = {"seconds": {}}
    secs = res["seconds"]
    rows = []
    hull_dir = paths.resolve("hull_df_dir")
    for f in sorted(os.listdir(hull_dir)):
        ids = Table.read_csv(os.path.join(hull_dir, f)).column("id")
        rows += [(int(i), "layer0", 1) for i in sorted(set(ids))]
    decisions = os.path.join(tmp, "decisions.csv")
    Table(("id", "datetime", "keep"), rows).to_csv(decisions)
    secs["select"] = run_cli("select", "--root", root, "--decisions",
                             decisions)

    def plumes(key):
        d = paths.resolve(key)
        return sum(len(set(Table.read_csv(os.path.join(d, f)).column("id")))
                   for f in os.listdir(d))

    res["plumes"] = {"decided": len(rows),
                     "kept": plumes("reduced_plume_hull_dir"),
                     "auto_rejected": plumes("reduced_not_plume_hull_dir")}
    secs["prepare_model_data"] = run_cli("prepare_model_data", "--root",
                                         root)
    samples = make_curated_dataset(paths.resolve("model_data_dir"))
    os.makedirs(os.path.join(tmp, "uncurated"))
    uncurated = build_model_data(paths, out_dir=os.path.join(tmp,
                                                             "uncurated"),
                                 use_masks=False, uncurated=True)
    res["samples"] = {"curated": len(samples), "uncurated": len(uncurated),
                      "curated_plume_px": [int(s.mask.sum())
                                           for s in samples]}
    print(f"curation: {res['plumes']['kept']} of {len(rows)} plumes kept, "
          f"{res['plumes']['auto_rejected']} auto-rejected; samples "
          f"written: {len(samples)} curated (device masks), "
          f"{len(uncurated)} uncurated (hull fills)", flush=True)
    if not samples or not res["plumes"]["kept"]:
        raise AssertionError(f"curation kept nothing: {res}")

    # evaluate_model on the trained checkpoint; K2 labels the components
    ccl_sweep.MASK_LAUNCHES = 0
    ev = ("evaluate_model", "--root", root)
    secs["evaluate"], res["evaluate"] = run_cli_json(
        *ev, "--bootstrap", str(CURATION_BOOTSTRAP))
    secs["evaluate_objects"], res["objects"] = run_cli_json(
        *ev, "--objects", "--min-size", str(CURATION_MIN_SIZE))
    secs["sweep_obj_f1"], res["sweep_obj_f1"] = run_cli_json(
        *ev, "--sweep-threshold", "obj_f1")
    res["k2_launches"] = ccl_sweep.MASK_LAUNCHES
    secs["sweep_write"], res["calibration"] = run_cli_json(
        *ev, "--sweep-threshold", "--write-threshold")
    with open(os.path.join(root, "models", "threshold.json")) as f:
        calibrated = float(json.load(f)["threshold"])
    # K2 sees len(samples) object tables and one (T + 1)-level stack each
    if res["k2_launches"] != 2 * len(samples):
        raise AssertionError(f"evaluate_model --objects and the object "
                             f"sweep launched K2 {res['k2_launches']} times "
                             f"for {len(samples)} samples")
    # the trained net's maps, and maps that do not hang on its quality:
    # the uncurated hull fills blurred, against the curated device masks
    from scipy import ndimage

    fills = sorted(os.listdir(os.path.join(tmp, "uncurated")))
    blurred = []
    for f, s in zip(fills, samples):
        with np.load(os.path.join(tmp, "uncurated", f)) as d:
            probs = ndimage.gaussian_filter(d["mask"], 3.0)
        blurred.append((f, probs.astype(np.float32), s.mask.astype(bool)))
    res["object_check"] = {"model": check_object_counts(eval_pairs(root)),
                           "hull_fills": check_object_counts(blurred)}
    if not any(r[0] for r in res["object_check"]["hull_fills"]["per_sample"]):
        raise AssertionError(f"the hull-fill maps matched no plume: "
                             f"{res['object_check']}")

    # a use_mega copy through K7 at tile 96, against the plain forward
    mega_ckpt = flagged_copy(ckpt, os.path.join(tmp, "ckpt_mega"),
                             use_mega=True)
    unet_mega.LAUNCHES = 0
    secs["evaluate_mega"] = run_cli_json(
        *ev, "--checkpoint", mega_ckpt, "--tile", str(MEGA.tile_size),
        "--overlap", str(MEGA.overlap))[0]
    res["k7_launches"] = unet_mega.LAUNCHES
    secs["evaluate_plain_tile96"] = run_cli_json(
        *ev, "--tile", str(MEGA.tile_size), "--overlap",
        str(MEGA.overlap))[0]
    res["mega"] = check_mega_eval(root, mega_ckpt)

    # train_model --curated relabelled by a use_pallas teacher (K6), with
    # the threshold evaluate_model wrote, in a root of its own
    pallas_ckpt = flagged_copy(ckpt, os.path.join(tmp, "ckpt_pallas"),
                               use_pallas=True)
    droot = os.path.join(tmp, "distill_root")
    shutil.copytree(paths.resolve("model_data_dir"),
                    PathsConfig(root=droot).resolve("model_data_dir"))
    os.makedirs(os.path.join(droot, "models"))
    shutil.copy(os.path.join(root, "models", "threshold.json"),
                os.path.join(droot, "models"))
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    distill.logger.addHandler(handler)
    fused_conv.LAUNCHES = 0
    try:
        secs["train_distill"] = run_cli(
            "train_model", "--root", droot, "--curated", "--distill-from",
            pallas_ckpt, "--distill-tta", "--distill-calibrate", "--steps",
            str(DISTILL_STEPS), "--tile", str(CHAIN_TILE), "--batch-size",
            str(CHAIN_BATCH))
    finally:
        distill.logger.removeHandler(handler)
    res["k6_launches"] = fused_conv.LAUNCHES
    logged_t = [float(m.split("calibrate=")[1].rstrip(")")) for m in logged
                if "calibrate=" in m]
    res["logged_calibration"] = logged_t
    if not res["k6_launches"] or logged_t != [calibrated]:
        raise AssertionError(f"train_model --distill-from a use_pallas "
                             f"teacher: K6 launches {res['k6_launches']}, "
                             f"logged calibration {logged_t}, threshold.json "
                             f"{calibrated}")
    one = samples[:1]
    got = distill.distill_samples(one, pallas_ckpt, alpha=1.0, device=DEV)
    want = distill.distill_samples(one, ckpt, alpha=1.0, device=DEV)
    res["distill_max_abs_dprobs"] = float(np.abs(got[0].mask
                                                 - want[0].mask).max())
    if res["distill_max_abs_dprobs"] > PROB_ATOL:
        raise AssertionError(f"use_pallas teacher against the plain one: "
                             f"max|dprobs| {res['distill_max_abs_dprobs']}")

    # serving reads the calibrated threshold
    secs["predict"] = run_cli("predict_model", "--root", root)
    served = os.path.join(root, "processed", "predictions")
    thresholds = []
    for f in sorted(os.listdir(served)):
        with np.load(os.path.join(served, f)) as d:
            thresholds.append(float(d["threshold"]))
    read_served(root)
    if set(thresholds) != {float(np.float32(calibrated))}:
        raise AssertionError(f"predict_model served thresholds {thresholds},"
                             f" threshold.json {calibrated}")
    res["seconds_total"] = time.perf_counter() - t0
    print("curation phase: seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items())
        + f"; launches K2 {res['k2_launches']}, K6 {res['k6_launches']}, "
        f"K7 {res['k7_launches']}; micro IoU {res['evaluate']['iou']}, "
        f"obj_f1 {res['objects']['obj_f1']}, calibrated threshold "
        f"{calibrated} (iou {res['calibration']['value']}); hull-fill maps' "
        f"plumes [tp, fp, fn] "
        f"{res['object_check']['hull_fills']['per_sample']}; K7 mask flips "
        f"{res['mega']['flips']}, use_pallas teacher max|dprobs| "
        f"{res['distill_max_abs_dprobs']:.4g}; "
        f"{res['seconds_total']:.1f} s", flush=True)
    return res


# ------------------------------------------------------------------ UNet++

# the UNet++ at full width (base 32, depth 4, bf16) with its side heads
PP_CFG = UNetConfig(arch="unetpp", deep_supervision=True)
PP_PRUNE = 2                          # the pruned level served besides depth
# train_model logs every 20 steps: the second window is the timed one
PP_TRAIN_STEPS = 40
PP_GRANULES = 2                       # 2048² granules the trained net serves


def pp_counts(level):
    """(Q1, Q2) launches of one UNet++ int8 forward at ``level``: two
    convs per node, one upsample per decoder node."""
    nodes = (level + 1) * (level + 2) // 2
    return 2 * nodes, level * (level + 1) // 2


def unetpp_int8_kernels(rng):
    """Q1 at the 30 convs and Q2 at the 10 upsamples of the UNet++ int8
    forward at the main path's batch of 288² tiles (``INT8_BATCH``), each
    bit for bit against its plain version and timed queued beside its
    bound (``experiments/int8_conv_times.py``), and the ``torch.cat`` of
    its dense concats."""
    tile = ICFG.tile_size
    q1 = []
    for case in int8_conv_times.conv_cases(PP_CFG, tile):
        q1.append(int8_conv_times.time_case(rng, case, INT8_BATCH, DEV))
        print("UNet++ " + int8_conv_times.summary(q1[-1]), flush=True)
    torch.cuda.empty_cache()
    q2 = []
    for case in int8_conv_times.upsample_cases(PP_CFG, tile):
        q2.append(int8_conv_times.time_upsample(rng, case, INT8_BATCH, DEV))
        print("UNet++ " + int8_conv_times.upsample_summary(q2[-1]),
              flush=True)
    cats = []
    for case in int8_conv_times.concat_cases(PP_CFG, tile):
        cats.append(int8_conv_times.time_concat(rng, case, INT8_BATCH, DEV))
        print("UNet++ " + int8_conv_times.concat_summary(cats[-1]),
              flush=True)
    torch.cuda.empty_cache()
    want = pp_counts(PP_CFG.depth)
    if (len(q1), len(q2)) != want:
        raise AssertionError(f"UNet++ cases: {len(q1)} convs and {len(q2)} "
                             f"upsamples, not {want}")
    return q1, q2, cats


def check_unetpp_int8_forward(model, rng):
    """The UNet++ int8 forward on the card against the CPU's
    (:func:`int8_card_against_cpu`, Q1 30 and Q2 10 launches); then its
    time at ``INT8_BATCH`` beside the plain bf16 UNet++ forward (cuDNN)."""
    cfg = model.cfg
    apply = make_quantized_apply(cfg)
    check = int8_card_against_cpu(model, rng, "UNet++ int8 forward",
                                  pp_counts(cfg.depth))
    xb = torch.rand((INT8_BATCH, ICFG.tile_size, ICFG.tile_size, 2),
                    generator=torch.Generator().manual_seed(SEED)).to(DEV)
    qvars_b = quantize_unet(model, cfg, xb[:9])
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = {"int8": time_ms(lambda: apply(qvars_b, xb), reps=5),
              "plain_bf16": time_ms(lambda: model(xb), reps=5)}
    mpix = INT8_BATCH * ICFG.tile_size**2 / 1e6
    res = {**check, "batch": INT8_BATCH, "forward_ms": ms,
           "forward_mpix_s": {k: mpix / (v / 1e3) for k, v in ms.items()},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del xb, qvars_b
    torch.cuda.empty_cache()
    print(f"UNet++ int8 forward {INT8_CHECK_TILES}x{ICFG.tile_size}^2 card "
          f"against CPU: {check['planes']} int8 planes equal, Q1 "
          f"{check['launches']} and Q2 {check['q2_launches']} launches, "
          f"max|dlogit| {check['max_abs_diff']:.3g} of "
          f"{check['max_abs_logit']:.4g} (CPU {check['cpu_forward_s']:.1f} "
          f"s); forwards of {INT8_BATCH}x{ICFG.tile_size}^2: "
          + ", ".join(f"{k} {ms[k]:.2f} ms ({res['forward_mpix_s'][k]:.1f} "
                      "MPix/s)" for k in ms)
          + f", peak {res['peak_memory_gb']:.2f} GB", flush=True)
    return res


def unetpp_train(tmp):
    """make_dataset, then ``train_model --arch unetpp --deep-supervision
    --weak-labels`` at the chain's geometry (16 × 512² tiles of 1200²
    granules) for ``PP_TRAIN_STEPS`` steps: K1 and K3 label, the rate of
    the last 20 steps from the loop's own log, TFLOP/s from the ported
    FLOP count, peak memory, and the recorded config. Returns the result
    and the checkpoint directory."""
    root = os.path.join(tmp, "pp_train")
    res = {"seconds": {}}
    res["seconds"]["make_dataset"] = run_cli(
        "make_dataset", "--root", root, "--n-granules", str(CHAIN_GRANULES),
        "--size", str(CHAIN_PX))
    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    res["seconds"]["train_model"] = run_cli(
        "train_model", "--root", root, "--arch", "unetpp",
        "--deep-supervision", "--weak-labels", "--granule-size",
        str(CHAIN_PX), "--tile", str(CHAIN_TILE), "--batch-size",
        str(CHAIN_BATCH), "--steps", str(PP_TRAIN_STEPS))
    res["launches"] = {"k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not (res["launches"]["k1"] > 0 and res["launches"]["k3"] > 0):
        raise AssertionError("UNet++ train_model --weak-labels did not "
                             f"launch K1 and K3: {res['launches']}")
    ckpt = os.path.join(root, "models", "checkpoints")
    recorded = load_model_config(ckpt)
    if recorded != PP_CFG:
        raise AssertionError(f"model_config.json records {recorded}")
    with open(ckpt + "_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    if [r["step"] for r in rows] != ["20", str(PP_TRAIN_STEPS)] or not all(
            math.isfinite(float(r["loss"])) for r in rows):
        raise AssertionError(f"UNet++ training metrics: {rows}")
    mpix_s = float(rows[-1]["mpix_s"])
    flops_px = model_flops_per_pixel(PP_CFG)
    res.update({
        "metrics": rows, "recorded_config": dataclasses.asdict(recorded),
        "timed_steps": PP_TRAIN_STEPS - 20, "mpix_s": mpix_s,
        "ms_per_step": CHAIN_BATCH * CHAIN_TILE**2 / (mpix_s * 1e6) * 1e3,
        "flops_per_px": flops_px,
        "tflops": 3 * flops_px * mpix_s * 1e6 / 1e12})
    res["pct_of_989"] = 100 * res["tflops"] / 989.0
    print(f"UNet++ train_model --arch unetpp --deep-supervision "
          f"--weak-labels {CHAIN_BATCH}x{CHAIN_TILE}^2: steps "
          f"21-{PP_TRAIN_STEPS} {res['ms_per_step']:.2f} ms/step, "
          f"{mpix_s:.2f} MPix/s, {res['tflops']:.1f} TFLOP/s "
          f"({res['pct_of_989']:.2f}% of 989), peak "
          f"{res['peak_memory_gb']:.2f} GB, K1 {res['launches']['k1']} and "
          f"K3 {res['launches']['k3']} launches, loss {rows[-1]['loss']}; "
          "seconds " + ", ".join(f"{k} {v:.2f}"
                                 for k, v in res["seconds"].items()),
          flush=True)
    return res, ckpt


def unetpp_serving(root):
    """The trained UNet++ checkpoint served over ``PP_GRANULES`` 2048²
    granules (one forward; the call is bound by its ``.npz`` writes):
    plain; ``--int8`` (Q1 30 and Q2 10 launches per forward, mask flips
    under ``INT8_MAX_FLIP_SHARE`` against plain); ``--prune-level 4`` (bit
    for bit the unpruned call); ``--prune-level 2`` and ``--int8
    --prune-level 2`` (Q1 12 and Q2 3 per forward); ``--fused``, which
    exits 1."""
    _n_tiles, forwards = serving_geometry(ICFG, PP_GRANULES)
    mpix = PP_GRANULES * GRANULE_PX**2 / 1e6
    res = {"granules": PP_GRANULES, "forwards": forwards, "seconds": {}}
    res["seconds"]["plain"], plain = serve(root)

    def int8_call(label, level, *flags):
        int8_conv.LAUNCHES = int8_upsample.LAUNCHES = 0
        res["seconds"][label], preds = serve(root, "--int8", *flags)
        got = (int8_conv.LAUNCHES, int8_upsample.LAUNCHES)
        want = tuple(n * forwards for n in pp_counts(level))
        res[f"{label}_launches"] = {"q1": got[0], "q2": got[1]}
        if got != want:
            raise AssertionError(f"predict_model --int8 {flags} launched Q1 "
                                 f"and Q2 {got} times, not {want}")
        return preds

    max_dp, share, _ = compare_served(int8_call("int8", PP_CFG.depth), plain)
    res["int8_against_plain"] = {"max_abs_dprobs": max_dp,
                                 "mask_flip_share": share}
    if share >= INT8_MAX_FLIP_SHARE:
        raise AssertionError(f"UNet++ --int8 flips {share:.3e} of the plain "
                             "call's masks")
    int8_pruned = int8_call(f"int8_prune_{PP_PRUNE}", PP_PRUNE,
                            "--prune-level", str(PP_PRUNE))
    res["seconds"]["prune_depth"], full = serve(
        root, "--prune-level", str(PP_CFG.depth))
    if any(not np.array_equal(full[k], plain[k]) for k in plain):
        raise AssertionError("--prune-level at the depth differs from the "
                             "unpruned call")
    res["seconds"][f"prune_{PP_PRUNE}"], pruned = serve(
        root, "--prune-level", str(PP_PRUNE))
    max_dp, share, _ = compare_served(int8_pruned, pruned)
    res[f"int8_prune_{PP_PRUNE}_against_plain"] = {
        "max_abs_dprobs": max_dp, "mask_flip_share": share}
    res[f"prune_{PP_PRUNE}_against_full"] = dict(zip(
        ("max_abs_dprobs", "mask_flip_share"),
        compare_served(pruned, plain)[:2]))
    if cli.main(["predict_model", "--root", root, "--fused"]) != 1:
        raise AssertionError("--fused on a UNet++ checkpoint did not exit 1")
    res["mpix_s"] = {k: mpix / v for k, v in res["seconds"].items()}
    print(f"UNet++ predict_model {PP_GRANULES}x{GRANULE_PX}^2 ({forwards} "
          "forwards): " + ", ".join(f"{k} {v:.2f} s ({res['mpix_s'][k]:.2f}"
                                    " MPix/s)"
                                    for k, v in res["seconds"].items())
          + f"; Q1/Q2 launches --int8 {res['int8_launches']}, --int8 "
          f"--prune-level {PP_PRUNE} {res[f'int8_prune_{PP_PRUNE}_launches']}"
          "; --int8 mask flips "
          f"{res['int8_against_plain']['mask_flip_share']:.3e} against "
          f"plain; --prune-level {PP_CFG.depth} equal to unpruned; "
          "--fused exits 1", flush=True)
    return res


def unetpp_phase(rng, tmp):
    """UNet++ at ``PP_CFG``: its int8 kernels, its int8 forward card
    against CPU, training, and its trained checkpoint served (with the
    plain call's serial split), each part's seconds recorded."""
    parts, t0 = {}, time.perf_counter()

    def done(part):
        nonlocal t0
        parts[part] = time.perf_counter() - t0
        t0 = time.perf_counter()

    q1, q2, cats = unetpp_int8_kernels(rng)
    done("kernels")
    model = seeded_unet(torch.Generator().manual_seed(SEED + 1), PP_CFG)
    forward = check_unetpp_int8_forward(model, rng)
    del model
    torch.cuda.empty_cache()
    done("forward")
    training, ckpt = unetpp_train(tmp)
    done("training")
    trained = build_model(PP_CFG)
    trained.load_state_dict(torch.load(os.path.join(ckpt, "weights.pt")))
    serve_dir = os.path.join(tmp, "pp_serve")
    os.makedirs(serve_dir)
    root = serving_root(trained, rng, serve_dir, PP_GRANULES)
    serving = unetpp_serving(root)
    split_dir = os.path.join(serve_dir, "split")
    os.makedirs(split_dir)
    serving["plain_split_s"] = serving_split(
        root, trained.to(DEV).eval(), split_dir, lambda m, x: m(x), ICFG,
        "UNet++ plain")
    done("serving")
    res = {"config": dataclasses.asdict(PP_CFG), "q1_rows": q1,
           "q2_rows": q2, "concat_rows": cats, "forward": forward,
           "training": training, "serving": serving,
           "seconds_by_part": parts, "seconds": sum(parts.values())}
    print(f"UNet++ phase {res['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + ")", flush=True)
    return res


# ------------------------------------ serving entry points: tune, --tuned, serve

# the tuner's default grid (infer/tune.DEFAULT_CANDIDATES) at G = 1, 2, 4
TUNE_GRANULES = (1, 2, 4)
# the grid's tiles that no earlier path runs (288 is the serving default)
TUNER_TILES = (256, 384, 512)
# the four forwards of the tuning sweeps: the checkpoint's flags, tune's and
# predict_model's flags, serve's flags (``--fused`` on the plain checkpoint
# is the use_pallas forward: the same fused apply)
ENTRY_FORWARDS = (("plain", {}, [], []),
                  ("use_pallas", {"use_pallas": True}, [], ["--fused"]),
                  ("use_mega", {"use_mega": True}, [], []),
                  ("int8", {}, ["--int8"], ["--int8"]))
# watch mode: poll, settle and idle exit of the serve subprocess, and how
# many granules it receives one after the other (after one backlog granule)
WATCH_POLL, WATCH_SETTLE, WATCH_IDLE_EXIT, WATCH_DROPS = 0.5, 0.5, 6, 3
SIGTERM_BACKLOG = 8
SUBPROCESS_TIMEOUT_S = 180


def grid_geometries():
    return tune_mod.parse_candidates(tune_mod.DEFAULT_CANDIDATES,
                                     TUNE_GRANULES)


def geometry_forwards(geom):
    """(tiles per granule, forwards of one call, tiles per forward) of the
    serving program at ``geom`` on a GRANULE_PX² granule: each forward
    carries the G granules' tiles."""
    stride = geom.tile - geom.overlap
    padded = geom.tile + -(-(GRANULE_PX - geom.tile) // stride) * stride
    n = len(tile_grid(padded, geom.tile, stride)) ** 2
    eff = _effective_batch(geom.batch_tiles, n)
    return n, -(-n // eff), geom.granules * eff


def tuner_batches(tile):
    """The forward batches the default grid gives at ``tile``."""
    return sorted({geometry_forwards(g)[2] for g in grid_geometries()
                   if g.tile == tile})


def tile_k6(rng, tile, batches):
    """K6 at the nine blocks of UNetConfig() at ``tile``: against its plain
    version at every batch of ``batches`` (the plain version once, at the
    largest), timed at the largest beside cuDNN and the bound."""
    big = batches[-1]
    rows = []
    for cin, cmid, cout, h in block_shapes(UNetConfig(), tile):
        args = block_inputs(rng, big, h, h, cin, cmid, cout)
        x, w1, s1, b1, w2, s2, b2 = args
        packed = fused_conv.pack_double_conv(*args[1:])
        ref = fused_conv.double_conv3x3_bn_relu_ref(*args).float()
        worst = max_abs = 0.0
        for b in batches:
            got = fused_conv.fused_double_conv3x3_bn_relu_packed(x[:b],
                                                                 packed)
            err = (got.float() - ref[:b]).abs()
            worst = max(worst, float((err / (ATOL + RTOL * ref[:b].abs()))
                                     .max()))
            max_abs = max(max_abs, float(err.max()))
            del got, err
        tile_rule = conv_tiles.double_conv_tile(h, h, cin, cmid, cout)
        pw1 = w1.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        pw2 = w2.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row = {"cin": cin, "cmid": cmid, "cout": cout, "h": h,
               "batches": batches, "max_abs_err": max_abs,
               "err_over_bound": worst, **tile_of(tile_rule),
               "ms": time_ms(lambda: fused_conv
                             .fused_double_conv3x3_bn_relu_packed(x, packed)),
               "library_ms": time_ms(lambda: plain_bf16_double_conv(
                   x, pw1, s1, b1, pw2, s2, b2)),
               "plain_ms": time_ms(
                   lambda: fused_conv.double_conv3x3_bn_relu_ref(*args),
                   reps=3),
               "ops": 2 * 9 * big * h * h * (cin * cmid + cmid * cout),
               "bytes": sum(a.numel() * a.element_size() for a in args)
               + big * h * h * cout * 2}
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"],
                                                 PEAK_BF16_OPS_PER_S)
        rows.append(row)
        if not worst <= 1.0:
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{row}: tolerance {ATOL} + {RTOL}*|ref|")
        del args, x, ref, packed, pw1, pw2
    return rows


def tile_k7(model, rng, tile, batches):
    """One K7 forward of the flagship net per batch of ``batches`` at
    ``tile`` against its plain version (``compare_logits``), timed at the
    largest beside the cuDNN forward and the bound."""
    big = batches[-1]
    apply = unet_mega.make_mega_apply(model.cfg)
    x = mega_tiles(rng, big, tile)
    weights = unet_mega.weights_of(model, torch.bfloat16, DEV)
    with torch.inference_mode():
        ref = unet_mega.mega_forward_ref(weights.folded, x)
        checks = {b: compare_logits(f"K7 {b}x{tile}^2 vs plain version",
                                    apply(model, x[:b]), ref[:b], MEGA_RTOL)
                  for b in batches}
        del ref
        row = {"batches": batches, "checks": checks,
               "max_abs_err": max(c["max_abs_diff"] for c in checks.values()),
               "ms": time_ms(lambda: apply(model, x), reps=5),
               "library_ms": time_ms(lambda: model(x), reps=5),
               "plain_ms": time_ms(
                   lambda: unet_mega.mega_forward_ref(weights.folded, x),
                   reps=2, warmup=1)}
    row["ops"] = mega_ops(model.cfg, tile) * big
    row["bytes"] = x.numel() * 2 + big * tile * tile * \
        model.cfg.out_channels * 4 + weights.blob.numel()
    row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"],
                                             PEAK_BF16_OPS_PER_S)
    del x
    torch.cuda.empty_cache()
    return row


def tile_int8(rng, tile, batches):
    """Q1 at the 18 convs and Q2 at the 4 upsamples of UNetConfig() at
    ``tile``: timed and held bit for bit at the largest batch
    (``int8_conv_times.time_case`` / ``time_upsample``), and bit for bit at
    every other batch of ``batches``."""
    big, others = batches[-1], batches[:-1]
    q1, q2 = [], []
    for case in int8_conv_times.conv_cases(UNetConfig(), tile):
        q1.append(int8_conv_times.time_case(rng, case, big, DEV))
        x, w, a, b, scale, skip = int8_conv_times.case_inputs(
            rng, case, others[-1], DEV)
        ref = int8_conv.int8_conv3x3_ref(x, w, a, b, scale, skip)
        for n in others:
            got = int8_conv.int8_conv3x3(
                x[:n], w, a, b, scale, None if skip is None else skip[:n])
            if not torch.equal(got, ref[:n]):
                raise AssertionError(f"Q1 differs from its plain version at "
                                     f"{case}, batch {n}")
        del x, w, skip, ref, got
    for case in int8_conv_times.upsample_cases(UNetConfig(), tile):
        q2.append(int8_conv_times.time_upsample(rng, case, big, DEV))
        x, kq, sw, bias, scale = int8_conv_times.upsample_inputs(
            rng, case, others[-1], DEV)
        ref = int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias, scale)
        for n in others:
            if not torch.equal(int8_upsample.int8_upsample2x2(
                    x[:n], kq, sw, bias, scale), ref[:n]):
                raise AssertionError(f"Q2 differs from its plain version at "
                                     f"{case}, batch {n}")
        del x, kq, ref
    torch.cuda.empty_cache()
    return q1, q2


def check_tuner_tiles(model, rng):
    """K6, K7, Q1 and Q2 at the tuner's 256², 384² and 512² tiles, at the
    batches the default grid gives there on a 2048² granule; per tile the
    sums over one forward's blocks, convs and upsamples."""
    out = {}
    for tile in TUNER_TILES:
        batches = tuner_batches(tile)
        k6 = tile_k6(rng, tile, batches)
        k7 = tile_k7(model, rng, tile, batches)
        q1, q2 = tile_int8(rng, tile, batches)
        summary = {"batch": batches[-1], "batches": batches}
        for name, rows in (("k6", k6), ("q1", q1), ("q2", q2)):
            share = {kind: sum(r["bound_ms"] for r in rows
                               if r["bound_by"] == kind)
                     for kind in ("bytes", "operations")}
            summary[name] = {
                "ms": sum(r["queued_ms" if name != "k6" else "ms"]
                          for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": max(share, key=share.get),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "library_ms": (sum(r["library_ms"] for r in rows)
                               if name == "k6" else None),
                "max_abs_err": max(r["max_abs_err"] for r in rows)}
        summary["q1"]["bf16_cudnn_ms"] = sum(r["bf16_cudnn_ms"] for r in q1)
        summary["q2"]["int_mm_ms"] = sum(r["int_mm_ms"] for r in q2)
        summary["q2"]["launch_ms"] = sum(r["launch_ms"] for r in q2)
        summary["k7"] = {k: k7[k] for k in ("ms", "bound_ms", "bound_by",
                                              "plain_ms", "library_ms",
                                              "max_abs_err")}
        out[str(tile)] = {"summary": summary, "k6_rows": k6, "k7": k7,
                          "q1_rows": q1, "q2_rows": q2}
        print(f"tuner tile {tile}^2, batches {batches} (timed at "
              f"{batches[-1]}): " + "; ".join(
                  f"{name.upper()} {v['ms']:.3f} ms (bound {v['bound_ms']:.4f}"
                  f" by {v['bound_by']}, plain {v['plain_ms']:.2f}"
                  + (f", library {v['library_ms']:.3f}"
                     if v["library_ms"] is not None else "")
                  + f", max|err| {v['max_abs_err']:.4g})"
                  for name, v in summary.items() if isinstance(v, dict)),
              flush=True)
    return out


class LaunchCount:
    """The kernels' launch counters (and ``torch._int_mm`` calls) over a
    ``with`` block: every counter is set to 0 on entry and read on exit."""

    def __enter__(self):
        fused_conv.LAUNCHES = unet_mega.LAUNCHES = 0
        int8_conv.LAUNCHES = int8_upsample.LAUNCHES = 0
        self.int_mm, self._real = 0, torch._int_mm

        def counted(*args, **kw):
            self.int_mm += 1
            return self._real(*args, **kw)

        torch._int_mm = counted
        return self

    def __exit__(self, *exc):
        torch._int_mm = self._real
        self.counts = {"k6": fused_conv.LAUNCHES, "k7": unet_mega.LAUNCHES,
                       "q1": int8_conv.LAUNCHES, "q2": int8_upsample.LAUNCHES,
                       "int_mm": self.int_mm}
        return False


def expected_launches(label, cfg):
    """Launches of one forward of ``label``'s path."""
    zero = dict.fromkeys(("k6", "k7", "q1", "q2", "int_mm"), 0)
    blocks = 2 * cfg.depth + 1
    return {"plain": zero, "use_pallas": dict(zero, k6=blocks),
            "use_mega": dict(zero, k7=1),
            "int8": dict(zero, q1=2 * blocks, q2=cfg.depth)}[label]


def tune_sweep(label, ckpt, flags, out, cfg):
    """``tune --granule 2048`` on the default grid at G = 1, 2, 4 for one
    forward, every candidate's launches counted (``time_geometry`` wrapped:
    the warm-up call and the repeats) against the forward's per-forward
    count times its forwards."""
    per_candidate = []
    real = tune_mod.time_geometry

    def counted(apply_fn, variables, stack, geom, channels, repeats=3):
        with LaunchCount() as count:
            rate = real(apply_fn, variables, stack, geom, channels, repeats)
        per_candidate.append((geom, repeats, count.counts))
        return rate

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tune_mod.time_geometry = counted
    try:
        rc = cli.main(["tune", "--root", os.path.dirname(out),
                       "--checkpoint", ckpt, "--granule", str(GRANULE_PX),
                       "--out", out, *flags])
    finally:
        tune_mod.time_geometry = real
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"tune {label} exited {rc}")
    payload = tune_mod.load_tuned(out)
    failed = [r for r in payload["results"] if r["mpix_s"] is None]
    if failed or len(payload["results"]) != len(grid_geometries()):
        raise AssertionError(f"tune {label}: failed candidates {failed}")
    per_forward = expected_launches(label, cfg)
    totals = dict.fromkeys(per_forward, 0)
    for geom, repeats, counts in per_candidate:
        calls = (1 + repeats) * geometry_forwards(geom)[1]
        want = {k: v * calls for k, v in per_forward.items()}
        if counts != want:
            raise AssertionError(f"tune {label} at {geom.label()}: launches "
                                 f"{counts}, not {want}")
        for k in totals:
            totals[k] += counts[k]
    res = {"seconds": secs, "peak_gb": peak, "launches": totals,
           "best": payload["best"], "best_blended": payload["best_blended"],
           "results": payload["results"], "device_kind":
           payload["device_kind"], "artifact": out}
    print(f"tune {label} --granule {GRANULE_PX} ({len(per_candidate)} "
          f"candidates, {secs:.1f} s, peak {peak:.2f} GB, launches "
          f"{totals}): ranked " + ", ".join(
              f"{r['tile']}/{r['overlap']}/{r['batch_tiles']} G={r['granules']}"
              f" {r['mpix_s']:.1f}" for r in payload["results"])
          + f" MPix/s; best {payload['best']['tile']}/"
          f"{payload['best']['overlap']}/{payload['best']['batch_tiles']} "
          f"G={payload['best']['granules']}, best blended "
          + (f"{payload['best_blended']['tile']}/"
             f"{payload['best_blended']['overlap']}/"
             f"{payload['best_blended']['batch_tiles']} "
             f"G={payload['best_blended']['granules']}"
             if payload["best_blended"] else "none"), flush=True)
    return res


def read_log(root, name):
    path = os.path.join(root, "processed", "predictions", name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().split()


def serve_once(root, *flags):
    """``serve --once --settle 0`` on ``root``: (exit code, seconds,
    launches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with LaunchCount() as count:
        rc = cli.main(["serve", "--root", root, "--once", "--settle", "0",
                       *flags])
        torch.cuda.synchronize()
    return rc, time.perf_counter() - t0, count.counts


def fresh_predictions(root):
    out = os.path.join(root, "processed", "predictions")
    shutil.rmtree(out, ignore_errors=True)
    return out


def same_probs(label, got, want, exact):
    """Bit for bit where ``exact``, else within ``compare_served``'s gate;
    returns (max |dp|, mask flips)."""
    max_dp, share, confident = compare_served(got, want)
    if exact and not all(np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError(f"{label}: probs differ (max|dp| {max_dp})")
    if max_dp > PROB_ATOL or confident:
        raise AssertionError(f"{label}: max|dp| {max_dp}, {confident} "
                             "confident flips")
    return max_dp, share


def tuned_and_served(root, tmp, sweeps, default_mpix):
    """Per forward: ``predict_model --tuned <its artifact>`` against the
    winner's four flags given explicitly, and ``serve --once --tuned``
    against ``predict_model --tuned``: bit for bit for the hand-kernel
    forwards (K6, Q1 and Q2), within ``compare_served``'s gate for cuDNN
    and K7; the rates beside the default geometry's. ``root`` holds
    ``TUNED_GRANULES`` of the serving granules."""
    names = sorted(f[:-4] for f in os.listdir(os.path.join(
        root, "raw", "plume_identification", "maiac")))
    mpix = len(names) * GRANULE_PX**2 / 1e6
    out = {}
    for label, _cfg_flags, flags, serve_flags in ENTRY_FORWARDS:
        sweep = sweeps[label]
        ckpt = ["--checkpoint", sweep["checkpoint"]]
        best = sweep["best"]
        exact = label in ("use_pallas", "int8")
        tuned_s, tuned = serve(root, "--tuned", sweep["artifact"], *ckpt,
                               *flags)
        explicit_s, explicit = serve(
            root, "--tile", str(best["tile"]), "--overlap",
            str(best["overlap"]), "--batch-tiles", str(best["batch_tiles"]),
            "--batch-granules", str(best["granules"]), *ckpt, *flags)
        tuned_dp, _ = same_probs(f"{label}: --tuned against explicit flags",
                                 tuned, explicit, exact)
        if label in default_mpix:
            default = default_mpix[label]
        else:
            default_s, _ = serve(root, *ckpt, *flags)
            default = mpix / default_s
        serve_ckpt = (["--checkpoint", sweeps["plain"]["checkpoint"]]
                      if label == "use_pallas" else ckpt)
        out_dir = fresh_predictions(root)
        rc, serve_s, launches = serve_once(root, "--tuned", sweep["artifact"],
                                           *serve_ckpt, *serve_flags)
        if rc != 0 or read_log(root, "served_granules.txt") != [
                f"{n}.npz" for n in names]:
            raise AssertionError(f"serve --once {label}: exit {rc}, log "
                                 f"{read_log(root, 'served_granules.txt')}")
        per_forward = expected_launches(label, sweep["cfg"])
        forwards = -(-len(names) // best["granules"]) * geometry_forwards(
            tune_mod.Geometry(best["tile"], best["overlap"],
                              best["batch_tiles"], best["granules"]))[1]
        want = {k: v * forwards for k, v in per_forward.items()}
        if launches != want:
            raise AssertionError(f"serve {label}: launches {launches}, not "
                                 f"{want}")
        served_dp, flips = same_probs(f"serve {label} against predict_model",
                                      read_split(out_dir), tuned, exact)
        out[label] = {"tuned_s": tuned_s, "explicit_s": explicit_s,
                      "tuned_mpix_s": mpix / tuned_s,
                      "explicit_mpix_s": mpix / explicit_s,
                      "default_mpix_s": default,
                      "serve_s": serve_s, "serve_mpix_s": mpix / serve_s,
                      "serve_launches": launches,
                      "tuned_max_abs_dprobs": tuned_dp,
                      "served_max_abs_dprobs": served_dp,
                      "served_flip_share": flips}
        print(f"{label}: predict_model --tuned ({best['tile']}/"
              f"{best['overlap']}/{best['batch_tiles']} G={best['granules']})"
              f" {mpix / tuned_s:.2f} MPix/s, explicit flags "
              f"{mpix / explicit_s:.2f}, default geometry {default:.2f}; "
              f"equal {'bit for bit' if exact else f'within the gate (max|dp| {tuned_dp:.3g})'}"
              f"; serve --once --tuned {mpix / serve_s:.2f} MPix/s, launches "
              f"{launches}, against predict_model max|dp| {served_dp:.3g}",
              flush=True)
    fresh_predictions(root)
    return out


def link_root(src_root, dst, names):
    """A root whose maiac directory links ``names`` of ``src_root``'s and
    whose checkpoint is ``src_root``'s."""
    maiac = os.path.join(dst, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    src = os.path.join(src_root, "raw", "plume_identification", "maiac")
    for name in names:
        os.link(os.path.join(src, f"{name}.npz"),
                os.path.join(maiac, f"{name}.npz"))
    shutil.copytree(os.path.join(src_root, "models"),
                    os.path.join(dst, "models"))
    return maiac


def save_renamed(src_path, dst_path, name):
    """The granule of ``src_path`` saved at ``dst_path`` under ``name``."""
    g = load_granule(src_path)
    save_granule(dst_path, Granule(g.layers, g.lat, g.lon, name=name))


def serve_subprocess(root, log_path, *flags):
    """``python -m plumekit_torch.cli serve`` in a child process, its output
    in ``log_path``."""
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "plumekit_torch.cli", "serve", "--root", root,
         *flags], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def wait_for(path, proc, timeout):
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(f"serve exited {proc.returncode} before "
                                 f"{path} was written")
        if time.time() > deadline:
            raise AssertionError(f"{path} not written in {timeout} s")
        time.sleep(0.01)
    return time.time()


def stop_process(proc, log):
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    log.close()


def serve_behaviour(root, tmp):
    """``serve`` as a deployment meets it, on the plain forward over 2048²
    granules: a second ``--once`` after a fifth granule lands serves only
    it; a corrupt upload is quarantined and ``--once`` exits 1; an all-null
    backlog under ``--int8`` serves and marks nothing; watch mode in a
    child process receives granules one after the other (the seconds from
    each arrival to its prediction on disk), then a backlog, and SIGTERM in
    the middle of it exits 0 and leaves every granule served (prediction
    and log line) or untouched, and no temporary."""
    src = os.path.join(root, "raw", "plume_identification", "maiac")
    names = [f"g{i}" for i in range(GRANULES)]
    res = {}
    entry = os.path.join(tmp, "entry_root")
    maiac = link_root(root, entry, names)
    rc, first_s, _ = serve_once(entry)
    served = read_log(entry, "served_granules.txt")
    if rc != 0 or served != [f"{n}.npz" for n in names]:
        raise AssertionError(f"serve --once: exit {rc}, log {served}")
    out = os.path.join(entry, "processed", "predictions")
    before = {n: os.stat(os.path.join(out, f"{n}_pred.npz")).st_mtime_ns
              for n in names}
    save_renamed(os.path.join(src, "g0.npz"), os.path.join(maiac, "g4.npz"),
                 "g4")
    rc, second_s, _ = serve_once(entry)
    after = {n: os.stat(os.path.join(out, f"{n}_pred.npz")).st_mtime_ns
             for n in names}
    if (rc != 0 or read_log(entry, "served_granules.txt") != served
            + ["g4.npz"] or after != before
            or not os.path.exists(os.path.join(out, "g4_pred.npz"))):
        raise AssertionError("the second serve --once did not serve only the "
                             "new granule")
    with open(os.path.join(maiac, "a_corrupt.npz"), "wb") as f:
        f.write(b"a truncated upload")
    rc, _s, _ = serve_once(entry)
    if rc != 1 or read_log(entry, "failed_granules.txt") != [
            "a_corrupt.npz"] or len(read_log(entry, "served_granules.txt")) \
            != GRANULES + 1:
        raise AssertionError(f"corrupt upload: exit {rc}, failed "
                             f"{read_log(entry, 'failed_granules.txt')}")
    res["resume_s"] = [first_s, second_s]

    null_root = os.path.join(tmp, "null_root")
    null_maiac = link_root(root, null_root, [])
    g = load_granule(os.path.join(src, "g0.npz"))
    save_granule(os.path.join(null_maiac, "ocean.npz"), Granule(
        {k: np.zeros_like(v) for k, v in g.layers.items()}, g.lat, g.lon,
        name="ocean"))
    rc, _s, launches = serve_once(null_root, "--int8")
    null_out = os.path.join(null_root, "processed", "predictions")
    if rc != 0 or [f for f in os.listdir(null_out) if f.endswith(".npz")] \
            or read_log(null_root, "served_granules.txt") \
            or read_log(null_root, "failed_granules.txt") or launches["q1"]:
        raise AssertionError(f"all-null backlog under --int8: exit {rc}, "
                             f"{os.listdir(null_out)}, launches {launches}")

    # one serve child process in watch mode: one granule in its backlog,
    # then WATCH_DROPS arrivals one after the other (the seconds from each
    # arrival to its prediction on disk), then a backlog of
    # SIGTERM_BACKLOG at once and SIGTERM after its first prediction. The
    # arrivals are written beforehand, side by side (zlib releases the
    # interpreter lock), and moved in when they arrive
    watch = os.path.join(tmp, "watch_root")
    watch_maiac = link_root(root, watch, ["g0"])
    staging = os.path.join(tmp, "watch_staging")
    os.makedirs(staging)
    drops = [f"w{i}" for i in range(1, WATCH_DROPS + 1)]
    backlog = [f"s{i}" for i in range(SIGTERM_BACKLOG)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda i_name: save_renamed(
            os.path.join(src, f"g{i_name[0] % GRANULES}.npz"),
            os.path.join(staging, f"{i_name[1]}.npz"), i_name[1]),
            enumerate(drops + backlog, start=1)))

    def arrive(name):
        staged = os.path.join(staging, f"{name}.npz")
        os.utime(staged)                # the upload ends now
        os.replace(staged, os.path.join(watch_maiac, f"{name}.npz"))
        return time.time()

    out = os.path.join(watch, "processed", "predictions")
    proc, log = serve_subprocess(
        watch, os.path.join(tmp, "watch.log"), "--poll", str(WATCH_POLL),
        "--settle", str(WATCH_SETTLE), "--idle-exit", str(WATCH_IDLE_EXIT))
    latencies = []
    try:
        t_start = time.time()
        wait_for(os.path.join(out, "g0_pred.npz"), proc,
                 SUBPROCESS_TIMEOUT_S)
        res["watch_first_s"] = time.time() - t_start
        for name in drops:
            arrived = arrive(name)
            latencies.append(wait_for(os.path.join(out, f"{name}_pred.npz"),
                                      proc, 60) - arrived)
        for name in backlog:
            arrive(name)
        wait_for(os.path.join(out, f"{backlog[0]}_pred.npz"), proc, 60)
        proc.send_signal(signal.SIGTERM)
        t_sig = time.time()
        rc = proc.wait(timeout=60)
        res["sigterm_exit_s"] = time.time() - t_sig
    finally:
        stop_process(proc, log)
    logged = read_log(watch, "served_granules.txt")
    written = {f[:-len("_pred.npz")] for f in os.listdir(out)
               if f.endswith("_pred.npz")}
    temporaries = [f for f in os.listdir(out) if ".tmp" in f]
    untouched = [n for n in backlog if n not in written
                 and f"{n}.npz" not in logged]
    if (rc != 0 or temporaries or len(set(logged)) != len(logged)
            or logged[:1 + WATCH_DROPS] != [f"{n}.npz"
                                            for n in ["g0"] + drops]
            or {f"{n}.npz" for n in written} != set(logged)
            or not untouched):
        raise AssertionError(f"watch mode and SIGTERM: exit {rc}, written "
                             f"{sorted(written)}, logged {logged}, "
                             f"temporaries {temporaries}")
    res["watch_latency_s"] = latencies
    res["watch_median_latency_s"] = float(np.median(latencies))
    written_backlog = len(written) - 1 - WATCH_DROPS
    res["sigterm"] = {"served": written_backlog, "untouched": len(untouched)}
    print(f"serve on {GRANULE_PX}^2 granules: --once {first_s:.2f} s for "
          f"{GRANULES}, then {second_s:.2f} s serving only the fifth; a "
          "corrupt upload quarantined (exit 1); an all-null backlog under "
          "--int8 served and marked nothing; watch mode (poll "
          f"{WATCH_POLL}, settle {WATCH_SETTLE}) first granule "
          f"{res['watch_first_s']:.2f} s after the start, arrival to "
          "prediction " + ", ".join(f"{s:.3f}" for s in latencies)
          + f" s (median {res['watch_median_latency_s']:.3f}); SIGTERM after "
          f"the first of {SIGTERM_BACKLOG}: exit 0 in "
          f"{res['sigterm_exit_s']:.2f} s, {written_backlog} served, "
          f"{len(untouched)} untouched, no temporary", flush=True)
    return res


def entry_phase(model, rng, root, tmp, default_mpix):
    """The serving entry points: the kernels at the tuner's tiles, ``tune``
    of four forwards, ``predict_model --tuned``, ``serve``."""
    t0 = time.perf_counter()
    tiles = check_tuner_tiles(model, rng)
    t_tiles = time.perf_counter() - t0
    ckpt = os.path.join(root, "models", "checkpoints")
    sweeps = {}
    for label, cfg_flags, flags, _serve_flags in ENTRY_FORWARDS:
        path = (flagged_copy(ckpt, os.path.join(tmp, f"{label}_ckpt"),
                             **cfg_flags) if cfg_flags else ckpt)
        sweeps[label] = tune_sweep(
            label, path, flags, os.path.join(tmp, f"tune_{label}",
                                             "tuned_geometry.json"),
            load_model_config(path))
        sweeps[label]["checkpoint"] = path
        sweeps[label]["cfg"] = load_model_config(path)
    t_tune = time.perf_counter() - t0 - t_tiles
    tuned_root = os.path.join(tmp, "tuned_root")
    link_root(root, tuned_root, [f"g{i}" for i in range(TUNED_GRANULES)])
    served = tuned_and_served(tuned_root, tmp, sweeps, default_mpix)
    t_served = time.perf_counter() - t0 - t_tiles - t_tune
    behaviour = serve_behaviour(root, tmp)
    parts = {"tiles": t_tiles, "tune": t_tune, "tuned_and_served": t_served,
             "serve_behaviour": time.perf_counter() - t0 - t_tiles - t_tune
             - t_served}
    for sweep in sweeps.values():
        sweep["cfg"] = dataclasses.asdict(sweep["cfg"])
    res = {"tiles": tiles, "sweeps": sweeps, "served": served,
           "behaviour": behaviour, "seconds_by_part": parts,
           "seconds": sum(parts.values())}
    print(f"serving entry points phase {res['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + ")", flush=True)
    return res


# ------------------------------------------ exported serving artifacts

EXPORT_GRANULES = 4                   # granules per exported program
TUNED_GRANULES = 2                    # granules --tuned and serve serve
#: per forward: the checkpoint's config flags, the geometry, export_model's
#: extra flags and whether its served probabilities must equal the earlier
#: phases' bit for bit (cuDNN's plain forward may pick other algorithms for
#: another batch: the phases served 2 granules a forward, the artifact
#: serves 4, so it is held to compare_served's gate there, and its
#: exactness is reported)
EXPORT_FORWARDS = (("plain", {}, ICFG, ["--platforms", "gpu,cpu"], False),
                   ("use_pallas", {"use_pallas": True}, ICFG, [], True),
                   ("use_mega", {"use_mega": True}, MEGA, [], True),
                   ("int8", {}, ICFG, ["--int8"], True))


def program_rate(fn, variables, stack, repeats=3):
    """MPix/s of ``repeats`` calls of a serving program on staged granules
    between two synchronizes, after one warm-up call."""
    with torch.inference_mode():
        fn(variables, stack)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn(variables, stack)
        torch.cuda.synchronize()
    return repeats * stack.shape[0] * stack.shape[1] * stack.shape[2] / (
        time.perf_counter() - t0) / 1e6


def graph_ops(path):
    """(seconds to load the program, its ``plumekit::`` op nodes by name,
    its ``aten._int_mm`` nodes)."""
    t0 = time.perf_counter()
    program = torch.export.load(path)
    load_s = time.perf_counter() - t0
    ops, int_mm = {}, 0
    for node in program.graph.nodes:
        name = str(node.target)
        if name.startswith("plumekit."):
            ops[name.split(".")[1]] = ops.get(name.split(".")[1], 0) + 1
        int_mm += name.startswith("aten._int_mm")
    return load_s, ops, int_mm


def export_phase(model, root, tmp, live):
    """``export_model`` of the flagship net at the main path's geometry
    (2048² granules, G = 4) for the plain, ``use_pallas``, ``use_mega``
    and ``--int8`` forwards; each artifact served over the four granules
    by ``predict_model --exported`` (launches per forward, the probabilities
    against ``live``, what the earlier phases served) and its program timed
    beside the live program at the same geometry on staged granules, in
    turns, outputs equal; one ragged group of 3 through the G = 4
    program."""
    t0 = time.perf_counter()
    ckpt = os.path.join(root, "models", "checkpoints")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    paths = [os.path.join(maiac, f"g{i}.npz") for i in range(GRANULES)]
    stack = torch.from_numpy(np.stack([
        decode_granule_channels(p, model.cfg.depth)[1]
        for p in paths[:EXPORT_GRANULES]])).to(DEV)
    mpix = GRANULES * GRANULE_PX**2 / 1e6
    out = {}
    for label, cfg_flags, icfg, flags, exact in EXPORT_FORWARDS:
        path = (flagged_copy(ckpt, os.path.join(tmp, f"export_{label}_ckpt"),
                             **cfg_flags) if cfg_flags else ckpt)
        cfg = load_model_config(path)
        art = os.path.join(tmp, f"exported_{label}")
        geometry = ["--tile", str(icfg.tile_size), "--overlap",
                    str(icfg.overlap), "--batch-tiles", str(icfg.batch_tiles)]
        t_export = time.perf_counter()
        rc = cli.main(["export_model", "--root", root, "--checkpoint", path,
                       "--granule", str(GRANULE_PX), "--batch-granules",
                       str(EXPORT_GRANULES), "--platforms", "gpu", "--out",
                       art, *geometry, *flags])
        export_s = time.perf_counter() - t_export
        if rc != 0:
            raise AssertionError(f"export_model {label} exited {rc}")
        with open(os.path.join(art, "meta.json")) as f:
            meta = json.load(f)
        load_s, ops, int_mm = graph_ops(os.path.join(art, "program.gpu.pt2"))
        forwards = geometry_forwards(tune_mod.Geometry(
            icfg.tile_size, icfg.overlap, icfg.batch_tiles,
            EXPORT_GRANULES))[1]
        per_forward = expected_launches(label, cfg)
        want_ops = {name: n * forwards for name, n in (
            ("fused_double_conv3x3", per_forward["k6"]),
            ("unet_mega", per_forward["k7"]),
            ("int8_conv3x3", per_forward["q1"]),
            ("int8_upsample2x2", per_forward["q2"])) if n}
        if ops != want_ops or int_mm:
            raise AssertionError(f"{label}: program ops {ops}, _int_mm "
                                 f"{int_mm}, not {want_ops}")
        with LaunchCount() as count:
            served_s, served = serve(root, "--exported", art,
                                     "--checkpoint", path)
        launches = count.counts
        want = {k: v * forwards for k, v in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{label} --exported: launches {launches}, "
                                 f"not {want}")
        served_dp, flips = same_probs(f"{label} --exported against live",
                                      served, live[label], exact)
        served_exact = all(np.array_equal(served[k], live[label][k])
                           for k in served)

        # the program against the live one at the same geometry
        variables = build_model(cfg).to(DEV).eval()
        variables.load_state_dict(model.state_dict())
        apply_fn = cli._module_forward
        if label == "int8":
            variables, _ = cli._int8_quantize_from_paths(
                paths, icfg.tile_size, cfg, variables)
            apply_fn = make_quantized_apply(cfg)
        live_fn = make_multi_granule_infer(apply_fn, icfg)
        t_load = time.perf_counter()
        fn, meta = export_mod.load_exported(art, DEV)
        tree = export_mod.serving_tree(meta["route"], cfg, variables,
                                       DEV)[0]
        load_exported_s = time.perf_counter() - t_load
        with torch.inference_mode():
            p_live = live_fn(variables, stack)[0]
            with LaunchCount() as count:
                p_exp = fn(tree, stack)[0]
                torch.cuda.synchronize()
        program_exact = torch.equal(p_live, p_exp)
        program_dp = float((p_live - p_exp).abs().max())
        if count.counts != want or (
                (exact or label == "plain") and not program_exact) or \
                program_dp > PROB_ATOL:
            raise AssertionError(f"{label}: program against live max|dp| "
                                 f"{program_dp}, launches {count.counts}")
        rates = {"live": [], "exported": []}
        for kind in ("live", "exported", "exported", "live"):
            rates[kind].append(program_rate(
                *((live_fn, variables) if kind == "live" else (fn, tree)),
                stack))
        del p_live, p_exp
        out[label] = {
            "route": meta["route"], "tile": icfg.tile_size,
            "overlap": icfg.overlap, "granules": EXPORT_GRANULES,
            "forwards_per_program": forwards,
            "platforms": meta["platforms"],
            "export_s": export_s, "program_load_s": load_s,
            "load_exported_s": load_exported_s,
            "program_bytes": os.path.getsize(
                os.path.join(art, "program.gpu.pt2")),
            "graph_ops": ops, "graph_int_mm": int_mm,
            "served_launches": launches,
            "launches_per_forward": {k: v // forwards
                                     for k, v in launches.items()},
            "served_s": served_s, "served_mpix_s": mpix / served_s,
            "served_max_abs_dprobs": served_dp, "served_flip_share": flips,
            "served_exact": served_exact, "program_exact": program_exact,
            "program_max_abs_dprobs": program_dp,
            "live_program_mpix_s": rates["live"],
            "exported_program_mpix_s": rates["exported"]}
        print(f"export {label} ({meta['route']}, {icfg.tile_size}/"
              f"{icfg.overlap}, G={EXPORT_GRANULES}): export_model "
              f"{export_s:.1f} s, load {load_s:.2f} s, "
              f"{out[label]['program_bytes']} bytes, ops {ops}; served "
              f"{mpix / served_s:.2f} MPix/s, launches {launches} "
              f"({forwards} forwards), against the live phase "
              + ("bit for bit" if served_exact else
                 f"max|dp| {served_dp:.3g}, flips {flips:.2e}")
              + "; program against live "
              + ("bit for bit" if program_exact else
                 f"max|dp| {program_dp:.3g}")
              + "; program rate live "
              + "/".join(f"{r:.1f}" for r in rates["live"]) + ", exported "
              + "/".join(f"{r:.1f}" for r in rates["exported"])
              + " MPix/s", flush=True)
        if label == "use_pallas":
            # one ragged group: 3 granules through the G = 4 program, the
            # last repeated and its outputs dropped
            with torch.inference_mode(), LaunchCount() as count:
                ragged = dict(streaming.stream_inference(
                    paths[:3], fn, tree, cfg.depth, DEV,
                    batch_granules=EXPORT_GRANULES, infer_is_batched=True))
            if list(ragged) != ["g0", "g1", "g2"] or count.counts != want \
                    or not all(np.array_equal(ragged[k], served[k])
                               for k in ragged):
                raise AssertionError(f"ragged group: {list(ragged)}, "
                                     f"launches {count.counts}")
            out["ragged_group"] = {"granules": 3, "launches": count.counts}
            print(f"export use_pallas: a ragged group of 3 through the G = "
                  f"{EXPORT_GRANULES} program, launches {count.counts}, "
                  "equal to the served granules", flush=True)
        del variables, tree, fn
        torch.cuda.empty_cache()
    fresh_predictions(root)
    out["seconds"] = time.perf_counter() - t0
    print(f"export phase {out['seconds']:.1f} s", flush=True)
    return out


# ------------------------------------ multi-card serving and training (A.19)

MESH_SLOTS = 2                        # replicas, or cards where there are 2
MESH_SPATIAL_PX = 1024                # the raster of the (1, 2, 2) grid
MESH_SCENES = 3                       # bench scenes over 2 slots: pads to 4
# the spatially sharded raster against the unsharded forward, inside the
# true border's receptive field: the serving gate (PROB_ATOL, no confident
# flip); the seams are the bands of this half-width about y, x = 512
SEAM_BAND = 8
# data-parallel steps against the one-process step
# (experiments/data_parallel_steps.py): in bf16 at 16 x 512², the loss, the
# IoU and the running buffers of the steps whose forwards see the same
# weights; in float64 compute at 16 x 256², where rounding cannot reach a
# gradient's sign, the buffers of every step and the parameters too. In
# bf16 Adam turns the rounding of near-zero gradients into steps of about
# lr of either sign (the training phase's finding), and the later forwards
# part with them: those distances are recorded, not gated
DP_LOSS_RTOL = DP_IOU_RTOL = DP_STATS_RTOL = 1e-3
DP_PARAM_LR_SHARE = 0.1
MESH_FORWARDS = (("plain", {}, ICFG, None),
                 ("use_pallas", {"use_pallas": True}, ICFG, "k6"),
                 ("use_mega", {"use_mega": True}, MEGA, "k7"),
                 ("int8", {}, ICFG, "q"))


def mesh_devices(n):
    """(devices, how): n distinct cards where the machine has them, else n
    replicas on cuda:0, the rehearsal of an n-card mesh on one card."""
    if torch.cuda.device_count() >= n:
        return ([torch.device("cuda", i) for i in range(n)],
                f"{n} distinct cards")
    return [torch.device("cuda", 0)] * n, f"{n} replicas on cuda:0"


def mesh_counts():
    return {"k6": fused_conv.LAUNCHES, "k7": unet_mega.LAUNCHES,
            "q1": int8_conv.LAUNCHES, "q2": int8_upsample.LAUNCHES,
            "k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}


def reset_mesh_counts():
    fused_conv.LAUNCHES = unet_mega.LAUNCHES = 0
    int8_conv.LAUNCHES = int8_upsample.LAUNCHES = 0
    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0


def timed_call(fn):
    """(result, ms) of one call between two synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mesh_serving(model, rng, devices):
    """``make_batch_infer_sharded`` over a 2-slot data mesh on 4 granules
    of 2048² (G = 2 a slot), for the plain, ``use_pallas`` (K6),
    ``use_mega`` (K7 at tile 96) and int8 (Q1, Q2) forwards, each slot with
    its own replica built from the state dict: served against the
    one-device program on the same granules (the serving gate), the
    launches per forward per replica, the sharded call's time, each
    replica's share alone and the one-device call's."""
    mesh = make_mesh(MeshConfig(data=MESH_SLOTS), devices)
    images = np.stack([np.stack([a, np.zeros_like(a)], -1)
                       for a in synthetic_channels(rng, GRANULES)])
    # the CLI's calibration: a 3 x 3 grid of tiles of the first granule
    t = ICFG.tile_size
    starts = [int(v) for v in np.linspace(0, GRANULE_PX - t, 3)]
    calib = np.stack([images[0, y:y + t, x:x + t]
                      for y in starts for x in starts])
    whole = torch.from_numpy(images).to(DEV)
    per_slot = GRANULES // MESH_SLOTS
    rows = {}
    for label, flags, icfg, counter in MESH_FORWARDS:
        if label == "int8":
            apply_fn = make_quantized_apply(model.cfg)
            variables = quantize_unet(model, model.cfg, calib)
            replicas = [qvars_to(variables, d) for d in devices]
        else:
            apply_fn = cli._module_forward
            variables = build_model(dataclasses.replace(model.cfg, **flags))
            variables.load_state_dict(model.state_dict())
            variables = variables.to(DEV).eval()
            replicas = replicate_model(variables, devices)
        sharded = make_batch_infer_sharded(apply_fn, mesh, icfg)
        local = make_multi_granule_infer(apply_fn, icfg)
        parts = shard(images, devices)
        with torch.inference_mode():
            sharded(replicas, parts)                  # packs each replica
            reset_mesh_counts()
            (probs, _), ms = timed_call(lambda: sharded(replicas, parts))
            launches = mesh_counts()
            slot_ms = [timed_call(lambda i=i: local(replicas[i],
                                                    parts[i]))[1]
                       for i in range(MESH_SLOTS)]
            (want, _), one_ms = timed_call(lambda: local(variables, whole))
        n_tiles, per_group, _ = geometry_forwards(tune_mod.Geometry(
            icfg.tile_size, icfg.overlap, icfg.batch_tiles, per_slot))
        forwards = MESH_SLOTS * per_group
        got = {i: p for i, p in enumerate(probs.float().cpu().numpy())}
        ref = {i: p for i, p in enumerate(want.float().cpu().numpy())}
        max_dp, flip_share, confident = compare_served(got, ref)
        per_forward = {k: launches[k] / forwards
                       for k in ("k6", "k7", "q1", "q2")}
        # one K6 a block, K7 a forward, Q1 a conv, Q2 an upsample: 9, 1,
        # 18 and 4 at UNetConfig()
        blocks = 2 * model.cfg.depth + 1
        expect = {"k6": blocks if counter == "k6" else 0,
                  "k7": 1 if counter == "k7" else 0,
                  "q1": 2 * blocks if counter == "q" else 0,
                  "q2": model.cfg.depth if counter == "q" else 0}
        rows[label] = {"forwards": forwards, "tiles_per_granule": n_tiles,
                       "launches": launches, "per_forward": per_forward,
                       "max_abs_dprobs": max_dp, "mask_flip_share":
                       flip_share, "confident_flips": confident,
                       "sharded_ms": ms, "slot_ms": slot_ms,
                       "one_device_ms": one_ms}
        print(f"mesh serving {label} ({GRANULES} x {GRANULE_PX}^2, tile "
              f"{icfg.tile_size}/{icfg.overlap}, {MESH_SLOTS} slots x G = "
              f"{per_slot}): {forwards} forwards, launches {launches}; "
              f"sharded {ms:.1f} ms, slots alone "
              f"{', '.join(f'{t:.1f}' for t in slot_ms)} ms, one device "
              f"{one_ms:.1f} ms; against one device max|dp| {max_dp:.4g}, "
              f"flips {flip_share:.3e} ({confident} confident)", flush=True)
        if max_dp > PROB_ATOL or confident:
            raise AssertionError(f"mesh serving {label}: off the one-device "
                                 f"program: {rows[label]}")
        if per_forward != {k: float(v) for k, v in expect.items()}:
            raise AssertionError(f"mesh serving {label}: launches per "
                                 f"forward per replica {per_forward}, want "
                                 f"{expect}")
        del replicas, variables, probs, want
        torch.cuda.empty_cache()
    return rows


def mesh_spatial(model, rng):
    """``make_sharded_infer`` on a (1, 2, 2) grid (four cards where there
    are four, else four slots of cuda:0) on a 1024² raster at full width:
    inside the true border's receptive field against the unsharded
    forward, and in the bands about the seams."""
    devices, how = mesh_devices(4)
    mesh = make_mesh(MeshConfig(data=1, y=2, x=2), devices)
    plane = synthetic_channels(rng, 1)[0][:MESH_SPATIAL_PX,
                                          :MESH_SPATIAL_PX]
    image = np.stack([plane, np.zeros_like(plane)], -1)
    r = receptive_field(model.cfg.depth)
    halo = choose_halo(r, MESH_SPATIAL_PX // 2, model.cfg.depth)
    infer = make_sharded_infer(cli._module_forward, mesh, halo)
    replicas = replicate_model(model, devices)
    with torch.inference_mode():
        infer(replicas, image)
        (probs, _), ms = timed_call(lambda: infer(replicas, image))
        x = torch.from_numpy(image)[None].to(DEV)
        direct, direct_ms = timed_call(
            lambda: torch.sigmoid(model(x)[0, ..., 0].float()))
    p, d = probs.cpu().numpy(), direct.cpu().numpy()
    inner = (slice(r, -r), slice(r, -r))
    mid = MESH_SPATIAL_PX // 2
    seams = np.zeros(p.shape, bool)
    seams[mid - SEAM_BAND:mid + SEAM_BAND] = True
    seams[:, mid - SEAM_BAND:mid + SEAM_BAND] = True
    inside = np.zeros(p.shape, bool)
    inside[inner] = True
    max_dp, _, confident = compare_served({0: p[inner]}, {0: d[inner]})
    seam_dp = float(np.abs(p - d)[seams & inside].max())
    res = {"devices": how, "halo": halo, "receptive_field": r,
           "max_abs_dprobs_interior": max_dp, "confident_flips": confident,
           "max_abs_dprobs_seams": seam_dp, "sharded_ms": ms,
           "direct_ms": direct_ms}
    print(f"spatial sharding {MESH_SPATIAL_PX}^2 on a (1, 2, 2) grid "
          f"({how}), halo {halo}: interior max|dp| {max_dp:.4g} "
          f"({confident} confident flips), seams max|dp| {seam_dp:.4g}; "
          f"sharded {ms:.1f} ms, unsharded {direct_ms:.1f} ms", flush=True)
    if not (np.isfinite(p).all() and max_dp <= PROB_ATOL and not confident
            and seam_dp <= PROB_ATOL):
        raise AssertionError(f"spatial sharding off the unsharded forward: "
                             f"{res}")
    return res


def mesh_identify(devices):
    """``batch_identify_sharded`` over a 2-slot mesh on 3 bench scenes
    (padded to 4): every output equal to the single-scene sweep on the card
    (the in-plume AOD sums within FEATURE_RTOL), K1 and K3 once a scene."""
    scenes = [make_scene(SyntheticSceneConfig(seed=SEED + i, **BENCH_SCENE))
              for i in range(MESH_SCENES)]
    preps = [rg._prep_fires(s.granule.lat, s.granule.lon,
                            s.fires["date_time"][0], s.fires, RG,
                            capacity=RG.max_fires) for s in scenes]
    shared = fire_bucket(max(int(p[2].sum()) for p in preps), RG.max_fires)
    aods = np.stack([s.granule.first_layer() for s in scenes])
    fires = [np.stack([p[k][:shared] for p in preps]) for k in range(3)]
    mesh = make_mesh(MeshConfig(data=MESH_SLOTS), devices)
    statics = rg._statics(RG)
    batch_identify_sharded(aods[:1], statics, RG.thresholds,
                           *(f[:1] for f in fires), mesh)   # warm-up
    reset_mesh_counts()
    got, ms = timed_call(lambda: batch_identify_sharded(
        aods, statics, RG.thresholds, *fires, mesh))
    launches = mesh_counts()
    padded = MESH_SCENES + (-MESH_SCENES) % MESH_SLOTS
    sweep = pipeline.make_sweep_identifier(statics)
    th = torch.from_numpy(THRESHOLDS).to(DEV)
    worst = 0.0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(MESH_SCENES):
            a = torch.from_numpy(aods[i]).to(DEV)
            ref = sweep(a, a, torch.zeros(a.shape, dtype=torch.bool,
                                          device=DEV), th,
                        *(torch.from_numpy(f[i]).to(DEV) for f in fires))
            for k, v in ref.items():
                want = v.cpu().numpy()
                if k in ("aod_mean", "aod_sd"):
                    err = float(np.abs(got[k][i] - want).max(initial=0.0)
                                / max(float(np.abs(want).max(initial=0.0)),
                                      1e-30))
                    worst = max(worst, err)
                    if err > FEATURE_RTOL:
                        raise AssertionError(f"batch identify scene {i}: "
                                             f"{k} off by {err}")
                elif not np.array_equal(got[k][i], want):
                    raise AssertionError(f"batch identify scene {i}: {k} "
                                         "differs from the sweep")
    torch.cuda.synchronize()
    serial_ms = (time.perf_counter() - t0) * 1e3
    res = {"scenes": MESH_SCENES, "padded": padded, "fires": shared,
           "launches": launches, "accepted": int(got["accepted"].sum()),
           "batch_ms": ms, "serial_check_ms": serial_ms,
           "max_rel_aod_stat_diff": worst}
    print(f"batch identify {MESH_SCENES} x 1200^2 over {MESH_SLOTS} slots "
          f"(F = {shared}): {res['accepted']} plumes, K1 {launches['k1']}, "
          f"K3 {launches['k3']} launches ({padded} scenes with the pad), "
          f"{ms:.1f} ms; equal to the single-scene sweeps (AOD statistics "
          f"within {worst:.3g})", flush=True)
    if launches["k1"] != padded or launches["k3"] != padded:
        raise AssertionError(f"batch identify launches {launches}, want K1 "
                             f"and K3 {padded} each")
    return res


def mesh_training(devices):
    """Two ranks (``parallel/launch.launch``: gloo on one card, NCCL on two)
    against the one-process step, in bf16 at 16 x 512² and in float64
    compute at 16 x 256², both in one launch
    (experiments/data_parallel_steps.py). Gated: every step's loss and IoU;
    the running buffers after the steps whose forwards see the initial
    weights (the first runs at lr 0), and in float64 after every step; the
    parameters in float64; equal parameters and buffers on every rank."""
    cards = len({d.index for d in devices}) == len(devices)
    backend = "nccl" if cards else "gloo"
    torch.cuda.empty_cache()
    # what the ranks share the card and the host with: this process's
    # reserved card memory and the host's load as they start
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    load = os.getloadavg()[0]
    out = data_parallel_steps.run(devices, backend=backend)
    out.update(backend=backend, parent_reserved_gb=reserved_gb,
               host_load_1min=load)
    for label in data_parallel_steps.CASES:
        case = out[label]
        pairs = list(zip(case["dp_metrics"], case["one_metrics"]))
        case["loss_rel_err"] = max(abs(a[0] - b[0]) / abs(b[0])
                                   for a, b in pairs)
        case["iou_rel_err"] = max(abs(a[1] - b[1]) / max(abs(b[1]), 1e-30)
                                  for a, b in pairs)
        gated = case["rel_dbuffers"] if label == "float64" else \
            case["rel_dbuffers"][:2]
        print(f"data-parallel steps {label} ({backend}, {out['ranks']} "
              f"ranks on {', '.join(out['devices'])}, {case['batch']} x "
              f"{case['tile']}^2): losses {[a[0] for a, _ in pairs]} / one "
              f"process {[b[0] for _, b in pairs]}, ious "
              f"{[a[1] for a, _ in pairs]} / {[b[1] for _, b in pairs]}; "
              f"rel err loss {case['loss_rel_err']:.3g}, iou "
              f"{case['iou_rel_err']:.3g}; running buffers per step "
              f"{[f'{d:.3g}' for d in case['rel_dbuffers']]}; max|dparam| "
              f"{case['max_abs_dparam']:.3g} "
              f"({case['max_abs_dparam_over_lr']:.3g} lr); rank step ms "
              f"{case['dp_step_ms']}, one process {case['one_step_ms']}; "
              f"equal on every rank {case['same_on_every_rank']}",
              flush=True)
        ok = (case["same_on_every_rank"]
              and case["loss_rel_err"] <= DP_LOSS_RTOL
              and case["iou_rel_err"] <= DP_IOU_RTOL
              and max(gated) <= DP_STATS_RTOL)
        if label == "float64":
            ok = ok and case["max_abs_dparam_over_lr"] <= DP_PARAM_LR_SHARE
        if not ok:
            raise AssertionError(f"data-parallel steps {label} off the "
                                 f"one-process step: {case}")
    print(f"data-parallel launch (both cases) {out['launch_s']:.1f} s; "
          f"this process held {reserved_gb:.2f} GB of the card and the "
          f"host's 1-minute load was {load:.2f} as the ranks started",
          flush=True)
    return out


def mesh_cli_refusals(tmp):
    """On one card: ``predict_model --mesh-devices 2`` and ``train_model
    --data-parallel 2`` exit 1 with the JAX CLI's device-count messages and
    write nothing."""
    root = os.path.join(tmp, "refusals")
    os.makedirs(root)
    msgs = []
    handler = logging.Handler()
    handler.emit = lambda record: msgs.append(record.getMessage())
    handler.setLevel(logging.ERROR)
    cli_logger = logging.getLogger("plumekit_torch.cli")
    cli_logger.addHandler(handler)
    try:
        rc_predict = cli.main(["predict_model", "--root", root,
                               "--mesh-devices", "2"])
        rc_train = cli.main(["train_model", "--root", root,
                             "--data-parallel", "2"])
    finally:
        cli_logger.removeHandler(handler)
    want = ["--mesh-devices 2 requested but only 1 device(s) visible (gpu)",
            "mesh needs 2 devices, have 1"]
    written = sorted(os.listdir(root))
    print(f"CLI on one card: predict_model --mesh-devices 2 exit "
          f"{rc_predict}, train_model --data-parallel 2 exit {rc_train}: "
          f"{msgs}; written {written}", flush=True)
    if (rc_predict, rc_train) != (1, 1) or msgs != want or written:
        raise AssertionError(f"mesh refusals: {rc_predict}, {rc_train}, "
                             f"{msgs}, {written}")
    return {"messages": msgs}


def parallel_phase(rng, tmp):
    """Multi-card serving, batch identify and data-parallel training (the
    mesh paths, ROADMAP A.19) on the card's mesh: two distinct cards where
    there are two, else two replicas (or ranks) on cuda:0."""
    t0 = time.perf_counter()
    devices, how = mesh_devices(MESH_SLOTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()
    print(f"parallel phase: {torch.cuda.device_count()} visible card(s) "
          f"({'; '.join(smi)}); the mesh is {how}", flush=True)
    model = seeded_unet(torch.Generator().manual_seed(SEED))
    res = {"devices": how, "visible_cards": torch.cuda.device_count(),
           "serving": mesh_serving(model, rng, devices),
           "spatial": mesh_spatial(model, rng)}
    del model
    torch.cuda.empty_cache()
    res["identify"] = mesh_identify(devices)
    res["training"] = mesh_training(devices)
    if torch.cuda.device_count() < MESH_SLOTS:
        res["cli"] = mesh_cli_refusals(tmp)
    res["seconds"] = time.perf_counter() - t0
    print(f"parallel phase {res['seconds']:.1f} s", flush=True)
    return res


# ------------------------------------------------- the host modules (PR 18)

CODEC_REPEATS = 5                     # codec timings: median of 5 per granule
MASK_PX = 512                         # the uint8 mask codec's plane
TIMER_TILES = 128                     # the K6 forward under StageTimes
CHECKED_TILES = 8                     # the K6 forward under checked
PLOT_PX = 256                         # build_features --plot's small root
REPORT_SECTIONS = ("## Training", "## Predictions", "## Evaluation",
                   "## Serving calibration")
FIGURE_LINE = "* ![training curves](figures/training.png)"
# entry()'s bf16 logits on the card against the CPU's: the repo's bound
# for a bf16 forward against its reference (tests/test_torch_unet.py)
ENTRY_TOL = 5e-2


def native_library():
    """Build (g++) and load the host library; fails where it is
    unavailable, so that every codec reading below is the library's."""
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host library did not build "
                             "(plumekit_torch/native, g++)")
    res = {"build_s": native_build.BUILD_SECONDS,
           "load_s": time.perf_counter() - t0,
           "library": os.path.basename(native_build.lib_path())}
    built = ("g++ build {:.2f} s".format(res["build_s"])
             if res["build_s"] is not None else "already built")
    print(f"native host library {res['library']}: {built}, available",
          flush=True)
    return res


def host_median_ms(fn, reps=CODEC_REPEATS):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def codec_check(root, depth, streams_serving):
    """The native codecs against the numpy ones, bit for bit: uint16 on the
    four serving granules' channels (what ``--quantize`` encodes), the
    uint8 mask codec on a 512² soft mask; host ms per granule, median of
    5; and the whole ``predict_model --quantize`` calls that the streams
    phase made, now on the native codec."""
    t0 = time.perf_counter()
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    res = {"granules": []}
    for f in sorted(os.listdir(maiac)):
        _name, ch, _hw = decode_granule_channels(os.path.join(maiac, f),
                                                 depth)
        got = native.quantize_uint16(ch)
        want = quant.quantize_uint16_numpy(ch)
        for g, w, what in zip(got, want, ("q", "lo", "scale")):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(f"native uint16 codec {what} differs "
                                     f"from numpy on {f}")
        res["granules"].append({
            "granule": f, "shape": list(ch.shape),
            "native_ms": host_median_ms(lambda: native.quantize_uint16(ch)),
            "numpy_ms": host_median_ms(
                lambda: quant.quantize_uint16_numpy(ch))})
    mask = np.random.default_rng(SEED + 18).random(
        (MASK_PX, MASK_PX)).astype(np.float32)
    mask[0, :3] = (-0.5, 1.5, 0.5)
    got = native.quantize_mask_uint8(mask)
    want = np.rint(np.clip(mask, 0.0, 1.0) * 255.0).astype(np.uint8)
    if not np.array_equal(got, want):
        raise AssertionError("native uint8 mask codec differs from numpy")
    res["mask"] = {
        "px": MASK_PX,
        "native_ms": host_median_ms(lambda: native.quantize_mask_uint8(mask)),
        "numpy_ms": host_median_ms(lambda: np.rint(
            np.clip(mask, 0.0, 1.0) * 255.0).astype(np.uint8))}
    for g in res["granules"]:
        print(f"codec uint16 {g['granule']} {tuple(g['shape'])}: native "
              f"{g['native_ms']:.3f} ms, numpy {g['numpy_ms']:.3f} ms; bit "
              "for bit", flush=True)
    print(f"codec uint8 mask {MASK_PX}^2: native "
          f"{res['mask']['native_ms']:.3f} ms, numpy "
          f"{res['mask']['numpy_ms']:.3f} ms; bit for bit", flush=True)
    res["stream_quantize_mpix_s"] = {
        k: streams_serving["quantized"][k]["call_mpix_s"]
        for k in ("quantize", "both")}
    res["stream_plain_mpix_s"] = \
        streams_serving["forwards"]["plain"]["call_mpix_s"]
    print("streams on the native codec: predict_model --quantize "
          f"{res['stream_quantize_mpix_s']['quantize']:.3f} MPix/s, "
          "--quantize --quantize-output "
          f"{res['stream_quantize_mpix_s']['both']:.3f}, plain "
          f"{res['stream_plain_mpix_s']:.3f} (whole calls, "
          f"{GRANULES}x{GRANULE_PX}^2)", flush=True)
    res["seconds"] = time.perf_counter() - t0
    return res


def timers_and_guard(tmp):
    """``StageTimes`` around one K6 forward of 128 × 288² against CUDA
    events of the same forward; ``profile_trace`` of one forward, whose
    trace must hold its 9 K6 kernels; ``checked`` around a K6 forward of 8
    tiles: a clean input passes (equal to the unguarded forward), one NaN
    pixel raises naming the op."""
    model = seeded_unet(torch.Generator().manual_seed(SEED))
    apply_fn = make_fused_apply(model.cfg)
    x = torch.rand((TIMER_TILES, ICFG.tile_size, ICFG.tile_size,
                    model.cfg.in_channels),
                   generator=torch.Generator().manual_seed(SEED + 18)).to(DEV)
    res = {}
    with torch.inference_mode():
        apply_fn(model, x)                               # packs the blocks
        torch.cuda.synchronize()
        st = StageTimes()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before = fused_conv.LAUNCHES
        with st.stage("k6_forward") as handle:
            a.record()
            y = apply_fn(model, x)
            b.record()
            handle.sync(y)
        b.synchronize()
        res["stage_ms"] = 1e3 * st.totals["k6_forward"]
        res["event_ms"] = a.elapsed_time(b)
        res["k6_launches"] = fused_conv.LAUNCHES - before
        # one launch per double-conv block: 9 at depth 4
        blocks = 2 * model.cfg.depth + 1
        if res["stage_ms"] < res["event_ms"] or res["k6_launches"] != blocks:
            raise AssertionError(f"StageTimes: {res}")
        print(f"StageTimes K6 forward {TIMER_TILES}x{ICFG.tile_size}^2: "
              f"stage {res['stage_ms']:.3f} ms >= CUDA events "
              f"{res['event_ms']:.3f} ms; K6 {res['k6_launches']} launches",
              flush=True)

        # the gate reads this process's own trace, late in the script,
        # where a session loses the records of its first tens of kernels
        # (profile_trace opens with empty kernels for that)
        with profile_trace(os.path.join(tmp, "trace_here")) as trace:
            apply_fn(model, x)
            torch.cuda.synchronize()
        res["trace"] = trace_kernels(trace.path)
        res["trace"]["card_events"] = trace.card_events
        res["trace"]["warmup_kernels"] = timers._warmup_kernels()
        # every K6 launch of the forward is in the trace, one per block
        if res["trace"]["k6_kernels"] != blocks:
            raise AssertionError(f"profile_trace in this process: "
                                 f"{res['trace']['k6_kernels']} of {blocks} "
                                 f"K6 kernels: {res['trace']}")
        print(f"profile_trace in this process: {res['trace']['events']} "
              f"events, {res['trace']['kernels']} kernels, "
              f"{res['trace']['bytes']} bytes, {res['trace']['k6_kernels']} K6 "
              f"kernels (warm-up about {res['trace']['warmup_kernels']}); K6 "
              f"symbols {res['trace']['k6_symbols']}", flush=True)

        small = x[:CHECKED_TILES].contiguous()
        guarded = checked(lambda t: apply_fn(model, t))
        clean = guarded(small)
        plain = apply_fn(model, small)
        if not torch.equal(clean, plain):
            raise AssertionError("checked: the guarded K6 forward differs "
                                 "from the unguarded one")
        bad = small.clone()
        bad[-1, small.shape[1] // 3, small.shape[2] // 2, 0] = float("nan")
        try:
            guarded(bad)
        except FloatingPointError as e:
            res["checked_error"] = str(e)
        else:
            raise AssertionError("checked: a NaN pixel raised nothing")
        print(f"checked K6 forward {CHECKED_TILES} tiles: clean input "
              f"passes, NaN pixel raises: {res['checked_error']}",
              flush=True)
    del model, x, y
    torch.cuda.empty_cache()
    return res


def trace_kernels(path):
    """Events, kernels and K6's kernel symbols of a Chrome trace (the
    card's kernels only, not the op's host events, which carry the op's
    name too)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"path": path, "bytes": os.path.getsize(path),
            "events": len(events), "kernels": len(kernels),
            "k6_symbols": sorted({e["name"] for e in kernels
                                  if "fused_double_conv" in e["name"]}),
            "k6_kernels": sum("fused_double_conv" in e["name"]
                              for e in kernels)}


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.ERROR)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def plot_branch(tmp):
    """``build_features --plot`` on a small root: without matplotlib (the
    expected case) it must exit 1 naming matplotlib before any device work
    (no launch, no file); with it, it must write the PNGs."""
    root = os.path.join(tmp, "plot_root")
    run_cli("make_dataset", "--root", root, "--n-granules", "1", "--size",
            str(PLOT_PX), "--plumes", "2", "--seed", str(SEED))
    plots = os.path.join(root, "raw", "plume_identification", "plots")
    aod_dir = os.path.join(root, "raw", "plume_identification",
                           "dataframes", "full", "aod")
    present = matplotlib_present()
    launches = (ccl_sweep.LAUNCHES, label_counts.LAUNCHES)
    messages = _Messages()
    logging.getLogger("plumekit_torch.cli").addHandler(messages)
    try:
        t0 = time.perf_counter()
        rc = cli.main(["build_features", "--root", root, "--plot"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        logging.getLogger("plumekit_torch.cli").removeHandler(messages)
    pngs = sorted(os.listdir(plots)) if os.path.isdir(plots) else []
    res = {"matplotlib": present, "rc": rc, "seconds": secs, "pngs": pngs,
           "launches": [a - b for a, b in zip(
               (ccl_sweep.LAUNCHES, label_counts.LAUNCHES), launches)],
           "messages": messages.lines}
    if present:
        rows = sum(len(open(os.path.join(aod_dir, f)).read().splitlines()) - 1
                   for f in os.listdir(aod_dir))
        if rc != 0 or (rows and not pngs):
            raise AssertionError(f"build_features --plot: {res}")
        branch = f"matplotlib present: {len(pngs)} PNGs written"
    else:
        if (rc != 1 or pngs or any(res["launches"])
                or os.path.exists(aod_dir)
                or not any("matplotlib" in m for m in messages.lines)):
            raise AssertionError(f"build_features --plot without "
                                 f"matplotlib: {res}")
        branch = ("matplotlib absent: exit 1 before any device work ("
                  f"{messages.lines[-1]})")
    print(f"build_features --plot: {branch}", flush=True)
    return res


def host_phase(tmp, codec):
    """The modules of PR 18 on the card's machine, after the curation
    phase, on the training chain's root: the timers and the NaN guard
    around K6, ``report``, ``build_features --plot`` and ``entry()``;
    ``codec`` is the native codec's check, made beside the serving
    root."""
    t0 = time.perf_counter()
    res = {"codec": codec, "timers": timers_and_guard(tmp)}

    root = os.path.join(tmp, "train_root")
    t1 = time.perf_counter()
    rc = cli.main(["report", "--root", root])
    secs = time.perf_counter() - t1
    with open(os.path.join(root, "reports", "report.md")) as f:
        text = f.read()
    missing = [s for s in REPORT_SECTIONS if s not in text.split("\n")]
    res["report"] = {"rc": rc, "seconds": secs, "missing": missing,
                     "figure": FIGURE_LINE in text,
                     "lines": len(text.split("\n"))}
    if rc != 0 or missing:
        raise AssertionError(f"report: {res['report']}")
    print(f"report --root: {secs:.3f} s, {res['report']['lines']} lines, "
          f"sections {', '.join(s[3:] for s in REPORT_SECTIONS)} present; "
          f"figure drawn: {res['report']['figure']}", flush=True)

    res["plot"] = plot_branch(tmp)

    # entry() on the card against entry(device="cpu"), the same seeded
    # weights, on a seeded batch of the example's shape
    fn, args = port_entry()
    cpu_fn, (cpu_model, _zeros) = port_entry(device="cpu")
    x = torch.rand(tuple(args[1].shape),
                   generator=torch.Generator().manual_seed(SEED + 18))
    with torch.inference_mode():
        out = fn(args[0], x.to(DEV))
        ref = cpu_fn(cpu_model, x)
    diff = float((out.float().cpu() - ref.float()).abs().max())
    res["entry"] = {"shape": list(out.shape), "dtype": str(out.dtype),
                    "max_abs_diff_cpu": diff}
    if (tuple(out.shape) != (*args[1].shape[:3], 1)
            or not torch.isfinite(out).all() or diff > ENTRY_TOL):
        raise AssertionError(f"entry(): {res['entry']}")
    print(f"entry(): fn(*args) {tuple(out.shape)} {out.dtype}, max|diff| "
          f"{diff:.3g} against entry(device='cpu') on the same batch "
          f"(tolerance {ENTRY_TOL})", flush=True)
    del fn, args, out, ref, cpu_model
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0 + codec["seconds"]
    print(f"host modules phase {res['seconds']:.1f} s", flush=True)
    return res



# ------------------------------------------------ MAIAC HDF4 granules (.hdf)
# the committed fixtures of tests/data/maiac, written by the HDF4 C library
# (tools/make_maiac_fixtures.py), read by the port's own reader
# (plumekit_torch/io/hdf4.py); their contents regenerated from seed 0

MAIAC_READS = 5                       # host timings: median of 5


def maiac_fixtures():
    """``tools/make_maiac_fixtures.py``, numpy only: the fixtures'
    contents from seed 0 and the full-size granule's scene."""
    from tools import make_maiac_fixtures

    return make_maiac_fixtures


def maiac_root(tmp, name, fx_mod, fx, ckpt, scene, npz):
    """A root holding the full-size granule, as the committed ``.hdf`` or
    as an ``.npz`` of its regenerated arrays, its fire table and a copy of
    the serving checkpoint. Returns (root, granule path, fires path)."""
    root = os.path.join(tmp, name)
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    fires_dir = os.path.join(root, "raw", "fires")
    os.makedirs(maiac)
    os.makedirs(fires_dir)
    if npz:
        gpath = os.path.join(maiac, fx.name + ".npz")
        save_granule(gpath, fx_mod.expected_granule(fx))
    else:
        gpath = os.path.join(maiac, fx.file)
        shutil.copy(os.path.join(fx_mod.OUT_DIR, fx.file), gpath)
    fpath = os.path.join(fires_dir, "fires.csv")
    write_fire_csv(fpath, scene.fires)
    shutil.copytree(ckpt, os.path.join(root, "models", "checkpoints"))
    return root, gpath, fpath


def served_probs(root, base, *flags):
    """``predict_model --root root *flags``: (seconds, probs, mask)."""
    secs = run_cli("predict_model", "--root", root, *flags)
    with np.load(os.path.join(root, "processed", "predictions",
                              base + "_pred.npz")) as d:
        return secs, d["probs"], d["mask"]


def maiac_phase(root, tmp, smi, cfg):
    """The MAIAC HDF4 reader on the card's machine, which has no pyhdf and
    no HDF4 library: (a) every committed fixture read and held bit for bit
    against the arrays regenerated from seed 0, the broken ones failing
    with their named errors; (b) ``build_features --detector rg`` on the
    full-size ``.hdf`` granule and on an ``.npz`` of the same arrays, masks
    and tables equal bit for bit, K1 and K3 launched; (c) ``predict_model``
    plain and ``--int8`` over both with the serving checkpoint
    (``cfg``), probabilities bit for bit, Q1 2(2·depth+1) and Q2 depth
    launches per forward, no K6 or K7; (d) ``verify_real_granule
    --detector rg`` on the ``.hdf``, every check passing; (e) the reader's
    host time for the full-size granule beside ``load_granule`` of the
    ``.npz``."""
    t0 = time.perf_counter()
    fx_mod = maiac_fixtures()
    fixtures = fx_mod.fixtures()
    full = fixtures[fx_mod.FULL_NAME + ".hdf"]
    res = {"fixtures": {}}
    for name, fx in fixtures.items():
        path = os.path.join(fx_mod.OUT_DIR, name)
        if fx.error is None:
            got, want = load_granule(path), fx_mod.expected_granule(fx)
            same = (got.name == want.name
                    and list(got.layers) == list(want.layers)
                    and all(got.layers[k].dtype == want.layers[k].dtype
                            and np.array_equal(got.layers[k], want.layers[k])
                            for k in want.layers)
                    and np.array_equal(got.lat, want.lat)
                    and np.array_equal(got.lon, want.lon))
            res["fixtures"][name] = "equal" if same else "DIFFERS"
        else:
            try:
                load_granule(path)
                res["fixtures"][name] = "read (no error)"
            except ValueError as e:
                res["fixtures"][name] = ("named error" if re.search(
                    fx.error, str(e)) else f"wrong error: {e}")
    bad = {k: v for k, v in res["fixtures"].items()
           if v not in ("equal", "named error")}
    print(f"MAIAC fixtures: {len(fixtures)} read, "
          f"{sum(v == 'equal' for v in res['fixtures'].values())} equal to "
          f"seed 0's arrays, "
          f"{sum(v == 'named error' for v in res['fixtures'].values())} "
          f"named errors; wrong: {bad}", flush=True)
    if bad:
        raise AssertionError(f"MAIAC fixtures: {bad}")

    scene = fx_mod.full_scene()
    ckpt = os.path.join(root, "models", "checkpoints")
    roots = {ext: maiac_root(tmp, f"maiac_{ext}", fx_mod, full, ckpt, scene,
                             ext == "npz") for ext in ("hdf", "npz")}

    # (b) the rg weak labeller
    launches = {}
    for ext, (r, _, _) in roots.items():
        ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
        build_features(r, "--detector", "rg")
        launches[ext] = {"k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}
    features = {ext: read_features(r, full.name)
                for ext, (r, _, _) in roots.items()}
    got, want = features["hdf"], features["npz"]
    plumes = len(got["aod"]) - 1
    if (got["aod"] != want["aod"] or got["extent"] != want["extent"]
            or sorted(got["masks"]) != sorted(want["masks"])
            or not all(np.array_equal(got["masks"][k], want["masks"][k])
                       for k in want["masks"])):
        raise AssertionError("build_features: .hdf and .npz differ")
    if not (plumes and launches["hdf"]["k1"] and launches["hdf"]["k3"]):
        raise AssertionError(f"build_features on the .hdf: {plumes} plumes, "
                             f"launches {launches['hdf']}")
    res["build_features"] = {"plumes": plumes, "launches": launches}
    print(f"build_features rg on {full.file}: {plumes} plume(s), launches "
          f"{launches['hdf']}; tables and masks equal the .npz's bit for "
          "bit", flush=True)

    # (c) serving, plain and int8
    stride = ICFG.tile_size - ICFG.overlap
    px = full.sds_shape[1]
    padded = ICFG.tile_size + -(-(px - ICFG.tile_size) // stride) * stride
    n_tiles = len(tile_grid(padded, ICFG.tile_size, stride)) ** 2
    forwards = -(-n_tiles // _effective_batch(ICFG.batch_tiles, n_tiles))
    res["serving"] = {"forwards": forwards}
    for label, flags in (("plain", ()), ("int8", ("--int8",))):
        probs, counts = {}, {}
        for ext, (r, _, _) in roots.items():
            fused_conv.LAUNCHES = unet_mega.LAUNCHES = 0
            int8_conv.LAUNCHES = int8_upsample.LAUNCHES = 0
            secs, p, m = served_probs(r, full.name, *flags)
            counts[ext] = {"k6": fused_conv.LAUNCHES,
                           "k7": unet_mega.LAUNCHES,
                           "q1": int8_conv.LAUNCHES,
                           "q2": int8_upsample.LAUNCHES, "seconds": secs}
            if p.shape != (px, px) or not np.isfinite(p).all():
                raise AssertionError(f"{label} {ext}: probs {p.shape}")
            probs[ext] = (p, m)
        want_q = ({"q1": 2 * (2 * cfg.depth + 1) * forwards,
                   "q2": cfg.depth * forwards} if label == "int8"
                  else {"q1": 0, "q2": 0})
        for ext, c in counts.items():
            if c["k6"] or c["k7"] or any(c[k] != v for k, v in
                                         want_q.items()):
                raise AssertionError(f"predict_model {label} {ext} launched "
                                     f"{c}, not {want_q}")
        same = (np.array_equal(probs["hdf"][0], probs["npz"][0])
                and np.array_equal(probs["hdf"][1], probs["npz"][1]))
        res["serving"][label] = {"launches": counts, "equal": same}
        print(f"predict_model {label} on {full.file}: launches "
              f"{counts['hdf']} ({forwards} forward(s)); probs "
              f"{'equal' if same else 'DIFFER from'} the .npz's bit for bit",
              flush=True)
        if not same:
            raise AssertionError(f"predict_model {label}: .hdf and .npz "
                                 "differ")

    # (d) the real-data contract register on the .hdf
    r, gpath, fpath = roots["hdf"]
    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
    verify_s, summary = run_cli_json("verify_real_granule", gpath, "--fires",
                                     fpath, "--detector", "rg")
    verify_launches = {"k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}
    if not summary["ok"] or summary["failed"] or summary["skipped"] \
            or not verify_launches["k1"]:
        raise AssertionError(f"verify_real_granule on the .hdf: {summary}, "
                             f"launches {verify_launches}")
    res["verify"] = {"summary": summary, "seconds": verify_s,
                     "launches": verify_launches}

    # (e) the reader's host time beside the .npz's
    reads = {ext: host_median_ms(lambda g=g: load_granule(g), MAIAC_READS)
             for ext, (_, g, _) in roots.items()}
    res["read_ms"] = {"hdf": reads["hdf"], "npz": reads["npz"],
                      "granule": list(full.sds_shape), "device": smi}
    print(f"MAIAC reader: load_granule of {full.file} "
          f"({'x'.join(map(str, full.sds_shape))} int16, deflate) "
          f"{reads['hdf']:.1f} ms on the host, of the same arrays as .npz "
          f"{reads['npz']:.1f} ms (median of {MAIAC_READS}; {smi})",
          flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"MAIAC HDF4 phase {res['seconds']:.1f} s", flush=True)
    return res


def main() -> int:
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)

    sources = ["unet_mega.cu", "fused_double_conv.cu", "fused_conv.cu",
               "scalar_gather_probe.cu", "ccl_sweep.cu", "label_counts.cu",
               "int8_conv.cu", "int8_upsample.cu"]
    t0 = time.perf_counter()
    cuda_build.load_libraries(sources)
    build_s = time.perf_counter() - t0
    print(f"kernel builds + loads {build_s:.2f} s (one nvcc per source, "
          "side by side)")
    for source in sources:
        log = cuda_build.BUILD_LOG.get(source, {})
        print(f"{source}: nvcc {log.get('seconds', 0.0):.2f} s")
        for line in log.get("ptxas", "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Performance Loss" in line):
                print(line[:240])
    native_lib = native_library()

    # megakernel serving (K7), then K5 and P1, then serving with K6
    batch = BATCH_GRANULES * ICFG.batch_tiles
    model = seeded_unet(torch.Generator().manual_seed(SEED))
    mega = check_mega(model, rng, batch)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        root = serving_root(model, rng, tmp)
        mega_served = mega_path(model, root, tmp, {
            "k7": mega["ms"], "cudnn": mega["cudnn_forward_ms"],
            "k6": mega["k6_forward_ms"]})
        torch.cuda.empty_cache()
        single_rows, single_launches = check_single_conv(rng, batch)
        probe = check_probe()
        kernel_rows = check_kernel(rng, batch)
        mega["by_stage"] = mega_stage_table(model, rng, batch, kernel_rows)
        forward = check_forward(model, rng)
        served = main_path(model, root, tmp)
        # the int8 forward (Q1, Q2)
        t_int8 = time.perf_counter()
        q1_rows, q1_library = check_int8_conv(rng)
        q2_rows = check_int8_upsample(rng)
        int8_forward = check_int8_forward(model, rng)
        int8_served = int8_path(root, model.cfg)
        int8_phase_s = time.perf_counter() - t_int8
        print(f"int8 phase {int8_phase_s:.1f} s", flush=True)
        # the streams: decode pool, stager, quantized transfers, --tta
        t_streams = time.perf_counter()
        streams = {"serving": stream_serving(model, root, tmp),
                   "tta": stream_tta(model, root,
                                     mega_served["checkpoint"])}
        streams_s = time.perf_counter() - t_streams
        # the native codecs against numpy on the serving granules
        codec = codec_check(root, model.cfg.depth, streams["serving"])
        # the serving entry points: K6, K7, Q1, Q2 at the tuner's tiles,
        # tune of four forwards, predict_model --tuned, serve (its own
        # random stream, so that the later phases draw what they drew)
        torch.cuda.empty_cache()
        entry = entry_phase(model, np.random.default_rng(SEED + 14), root,
                            tmp, {"plain": served["plain_mpix_s"][0],
                                  "use_pallas": served["fused_mpix_s"][0],
                                  "int8": int8_served["int8_mpix_s"][0]})
        # exported serving artifacts of the four forwards, held against
        # what the phases above served
        torch.cuda.empty_cache()
        exported = export_phase(model, root, tmp, {
            **served.pop("preds"), "use_mega": mega_served.pop("preds"),
            "int8": int8_served.pop("preds")})
        # MAIAC HDF4 granules: the committed fixtures read on the card's
        # machine, the full-size .hdf through build_features (K1, K3),
        # predict_model plain and --int8 (Q1, Q2) and verify_real_granule
        torch.cuda.empty_cache()
        maiac = maiac_phase(root, tmp, smi, model.cfg)
    del model
    torch.cuda.empty_cache()

    # the rg weak labeller: K1/K4 and K3
    ccl_rows, count_rows = check_identify_kernels(rng)
    sweeps = sweep_split()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        features = features_path(tmp)

    # the basic and gaussian detectors: K2
    mask_rows = check_mask_kernel(rng)
    detectors = detector_split()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        basic_features = detector_features_path(tmp, "basic", BASIC_SCENE)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        gaussian_features = detector_features_path(tmp, "gaussian",
                                                   GAUSS_SCENE)

    # VIIRS swaths at a real granule's size (K2 on its UTM grid) and the
    # real-granule check (K1, K3)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        viirs = viirs_phase(tmp)
    torch.cuda.empty_cache()

    # training: step parity, timed steps, the quick-start chain (K1 and K3
    # label, K6 and K7 evaluate and serve)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        training = train_phase(tmp)
        # curation and evaluation on the chain's root (K2, K6, K7)
        torch.cuda.empty_cache()
        curation = curation_phase(tmp)
        # the host modules: timers and the NaN guard around K6, report on
        # the chain's root, build_features --plot, entry()
        torch.cuda.empty_cache()
        host = host_phase(tmp, codec)
    chain = training["chain"]
    # the streams' training side, after the step times it reads
    t_streams = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        streams["training"] = stream_training(tmp, training["step_times"])
    streams["seconds"] = streams_s + time.perf_counter() - t_streams
    print(f"streams phase {streams['seconds']:.1f} s", flush=True)
    # UNet++: Q1 and Q2 at its shapes, its int8 forward card against CPU,
    # train_model --arch unetpp --deep-supervision, its checkpoint served
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        unetpp = unetpp_phase(rng, tmp)
    pp_q1, pp_q2 = unetpp["q1_rows"], unetpp["q2_rows"]
    # multi-card serving, batch identify and data-parallel training on the
    # card's mesh (two replicas or ranks on cuda:0 with one card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        parallel = parallel_phase(rng, tmp)
    mesh_launches = {
        k: sum(r["launches"][k] for r in parallel["serving"].values())
        for k in ("k6", "k7", "q1", "q2")}
    mesh_launches.update({k: parallel["identify"]["launches"][k]
                          for k in ("k1", "k3")})
    pp_fwd, pp_served = unetpp["forward"], unetpp["serving"]
    pp_train = unetpp["training"]["launches"]
    tta_launches = {k: streams["tta"][label]["launches"][k] for k, label in
                    (("k6", "fused"), ("k7", "use_mega"), ("q1", "int8"),
                     ("q2", "int8"))}

    timed = [r for r in kernel_rows if r["set"] == str(ICFG.tile_size)]
    timed_mega = [r for r in kernel_rows if r["set"] == str(MEGA.tile_size)]
    single = [r for r in single_rows if "ms" in r]
    single_share = {kind: sum(r["bound_ms"] for r in single
                              if r["bound_by"] == kind)
                    for kind in ("bytes", "operations")}
    # each block has its own bound; the forward's is their sum, named by
    # whichever kind bounds the larger share of it
    k6_bound = [(r["bound_ms"], r["bound_by"]) for r in timed]
    k6_share = {kind: sum(b for b, by in k6_bound if by == kind)
                for kind in ("bytes", "operations")}
    q1_share = {kind: sum(r["bound_ms"] for r in q1_rows
                          if r["bound_by"] == kind)
                for kind in ("bytes", "operations")}
    q2_share = {kind: sum(r["bound_ms"] for r in q2_rows
                          if r["bound_by"] == kind)
                for kind in ("bytes", "operations")}
    bench_ccl = next(r for r in ccl_rows if r["scene"] == "bench_1200")
    swath_ccl = next(r for r in ccl_rows if r["scene"] == "synthetic_8192")
    bench_counts = next(r for r in count_rows
                        if r["scene"] == "bench_1200" and r["F"] == 16)
    basic_mask = next(r for r in mask_rows
                      if r["scene"] == "basic_scene_1200_mask")

    def ccl_entry(name, replaces, row, launches, errors, **extra):
        return {"name": name, "route": "cuda",
                "source": "plumekit_torch/csrc/ccl_sweep.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["wrong_pixels"] for r in errors),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None,
                "at": f"{row['h']}x{row['w']}, T={row['levels']}", **extra}

    kernels = [{
        "name": "fused_double_conv3x3_bn_relu", "route": "cuda",
        "source": "plumekit_torch/csrc/fused_double_conv.cu",
        "replaces": "plumekit/models/pallas/fused_conv.py:180",
        "launches": served["k6_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": sum(r["ms"] for r in timed),
        # the fp32-accumulated version the kernel is held against
        "plain_ms": sum(r["ref_fp32_ms"] for r in timed),
        "bound_ms": sum(b for b, _ in k6_bound),
        "bound_by": max(k6_share, key=k6_share.get),
        # two cuDNN bf16 convolutions with scale, shift and ReLU per block
        "library_ms": sum(r["plain_ms"] for r in timed),
        "at": f"the 9 blocks of one forward, batch {batch}",
        # the same with the per-call packing of the raw-weight entry, and
        # the nine blocks at the megakernel's tile beside cuDNN
        "ms_with_packing": sum(r["wrapper_ms"] for r in timed),
        "ms_tile_96": sum(r["ms"] for r in timed_mega),
        "library_ms_tile_96": sum(r["plain_ms"] for r in timed_mega),
        # the trained checkpoint served with --fused, and use_pallas evals
        "train_launches": chain["k6_serving_launches"] + sum(
            r["launches"] for r in chain["eval_routes"]["use_pallas"]),
        # predict_model --tta --fused at tile 96: one launch per block at
        # 8x the tiles
        "tta_launches": tta_launches["k6"],
        # the use_pallas teacher of train_model --distill-from
        "distill_launches": curation["k6_launches"]},
        ccl_entry("multi_threshold_ccl_fused",
                  "plumekit/ops/pallas/ccl_sweep.py:544", bench_ccl,
                  features["launches"]["k1"]
                  + gaussian_features["launches"]["k1"], ccl_rows,
                  # train_model --weak-labels, labelling its granules,
                  # for the U-Net and for the UNet++
                  train_launches=chain["launches"]["k1"],
                  unetpp_train_launches=pp_train["k1"],
                  # verify_real_granule --detector rg on the 1200² granule
                  verify_launches=viirs["verify"]["launches"]["k1"],
                  # build_features rg on the full-size MAIAC .hdf granule
                  maiac_launches=maiac["build_features"]["launches"]["hdf"][
                      "k1"]),
        ccl_entry("multi_threshold_ccl",
                  "plumekit/ops/pallas/ccl_sweep.py:468", basic_mask,
                  basic_features["launches"]["k2"]
                  + gaussian_features["launches"]["k2"],
                  mask_rows + [viirs["k2_row"]],
                  # evaluate_model --objects and the object sweep
                  evaluate_launches=curation["k2_launches"],
                  # identify_viirs_arrays on the 768 x 3200 granule, and
                  # the kernel on that UTM grid's opened mask
                  viirs_launches=viirs["launches"]["k2"],
                  at_viirs_grid={k: viirs["k2_row"][k] for k in (
                      "h", "w", "ms", "plain_ms", "bound_ms", "bound_by",
                      "wrong_pixels")}), {
        "name": "fire_label_counts", "route": "cuda",
        "source": "plumekit_torch/csrc/label_counts.cu",
        "replaces": "plumekit/ops/pallas/label_counts.py:83",
        "launches": features["launches"]["k3"]
        + gaussian_features["launches"]["k3"],
        "train_launches": chain["launches"]["k3"],
        "unetpp_train_launches": pp_train["k3"],
        "verify_launches": viirs["verify"]["launches"]["k3"],
        "maiac_launches": maiac["build_features"]["launches"]["hdf"]["k3"],
        "max_abs_err": max(r["max_abs_err"] for r in count_rows),
        "ms": bench_counts["ms"], "plain_ms": bench_counts["plain_ms"],
        "bound_ms": bench_counts["bound_ms"],
        "bound_by": bench_counts["bound_by"], "library_ms": None,
        "at": "1200x1200, T=20, F=16"},
        # K4 is K1's kernel under its other entry name, timed where the TPU
        # needs the banded kernel; its launches are K1's at 8192² in the
        # rg sweep (rg.identify on the swath scene)
        ccl_entry("multi_threshold_ccl_banded",
                  "plumekit/ops/pallas/ccl_banded.py:321", swath_ccl,
                  sweeps["synthetic_8192"]["k1_launches"], ccl_rows,
                  same_kernel_as="multi_threshold_ccl_fused"), {
        "name": "fused_conv3x3_bn_relu", "route": "cuda",
        "source": "plumekit_torch/csrc/fused_conv.cu",
        "replaces": "plumekit/models/pallas/fused_conv.py:259",
        # a library entry that no command calls, as in the JAX package:
        # this run's calls of the entry at the net's shapes, one launch each
        "launches": single_launches,
        "max_abs_err": max(r["max_abs_err"] for r in single_rows),
        "ms": sum(r["ms"] for r in single),
        "plain_ms": sum(r["plain_ms"] for r in single),
        "bound_ms": sum(r["bound_ms"] for r in single),
        "bound_by": max(single_share, key=single_share.get),
        # one cuDNN bf16 convolution with scale, shift and ReLU per shape
        "library_ms": sum(r["library_ms"] for r in single),
        "at": f"the 18 convs of one forward at tile {MEGA.tile_size}, "
              f"batch {batch}",
        "ms_with_packing": sum(r["wrapper_ms"] for r in single)}, {
        "name": "mega_forward", "route": "cuda",
        "source": "plumekit_torch/csrc/unet_mega.cu",
        "replaces": "plumekit/models/pallas/unet_mega.py:364",
        "launches": mega_served["launches"]["k7"],
        "max_abs_err": max(c["max_abs_diff"] for c in mega["cases"].values()),
        "ms": mega["ms"], "plain_ms": mega["plain_ms"],
        "bound_ms": mega["bound_ms"], "bound_by": mega["bound_by"],
        # the plain forward: cuDNN bf16 convolutions, BatchNorm not folded
        "library_ms": mega["cudnn_forward_ms"],
        # the fp32 body over the same batch, its bound at the fp32 rate
        "fp32_ms": mega["fp32"]["ms"], "fp32_bound_ms": mega["fp32"]["bound_ms"],
        "fp32_max_abs_err": mega["fp32"]["max_abs_diff"],
        "train_launches": sum(r["launches"]
                              for r in chain["eval_routes"]["use_mega"]),
        "tta_launches": tta_launches["k7"],
        # evaluate_model of a use_mega checkpoint at tile 96
        "evaluate_launches": curation["k7_launches"],
        "at": f"one forward of UNetConfig(), {batch} tiles of "
              f"{MEGA.tile_size}x{MEGA.tile_size}"}, {
        "name": "scalar_gather_probe", "route": "cuda",
        "source": "plumekit_torch/csrc/scalar_gather_probe.cu",
        "replaces": "experiments/scalar_dma_probe.py:85",
        # launches of the probe's own entry point (python -m
        # plumekit_torch.experiments.scalar_gather_probe), both forms
        "launches": probe["launches"],
        "max_abs_err": probe["wrong"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        # the bytes' time is below a kernel launch (about 0.003 ms), which
        # is what bounds the probe at this size
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": None,
        "chained_ns_per_lookup": probe["chained_ns_per_lookup"],
        "parallel_ns_per_lookup": probe["parallel_ns_per_lookup"],
        "at": f"{PROBE_SIZE}x{PROBE_SIZE}, {PROBE_LOOKUPS} lookups, copy "
              "plus the parallel form"}, {
        "name": "int8_conv3x3", "route": "cuda",
        "source": "plumekit_torch/csrc/int8_conv.cu",
        "replaces": "plumekit/models/quantized_forward.py:133 (XLA s8 conv, "
                    "no Pallas)",
        "launches": int8_served["q1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in q1_rows + pp_q1),
        # queued: 20 launches per event pair
        "ms": sum(r["queued_ms"] for r in q1_rows),
        "plain_ms": sum(r["plain_ms"] for r in q1_rows),
        "bound_ms": sum(r["bound_ms"] for r in q1_rows),
        "bound_by": max(q1_share, key=q1_share.get),
        # F.conv2d does not take int8 CUDA tensors where this is None
        "library_ms": (sum(r["library_ms"] for r in q1_rows)
                       if q1_library["runs"] else None),
        "library_error": q1_library["error"],
        # the cuDNN bf16 conv of the same shapes, for context
        "bf16_cudnn_ms": sum(r["bf16_cudnn_ms"] for r in q1_rows),
        "single_ms": sum(r["single_ms"] for r in q1_rows),
        # the trained checkpoint served with --int8
        "train_launches": chain["q1_serving_launches"],
        # predict_model --int8 over the full-size MAIAC .hdf granule
        "maiac_launches": maiac["serving"]["int8"]["launches"]["hdf"]["q1"],
        "tta_launches": tta_launches["q1"],
        "at": f"the 18 convs of one int8 forward of UNetConfig(), "
              f"{INT8_BATCH} tiles of {ICFG.tile_size}x{ICFG.tile_size}",
        # the UNet++ int8 forward: launches per forward and served with
        # --int8, its 30 convs queued at the same batch, and the torch.cat
        # that joins each node's same-scale planes into Q1's first source
        "unetpp_launches": pp_fwd["launches"],
        "unetpp_serving_launches": pp_served["int8_launches"]["q1"],
        "unetpp_ms": sum(r["queued_ms"] for r in pp_q1),
        "unetpp_bound_ms": sum(r["bound_ms"] for r in pp_q1),
        "unetpp_plain_ms": sum(r["plain_ms"] for r in pp_q1),
        "unetpp_bf16_cudnn_ms": sum(r["bf16_cudnn_ms"] for r in pp_q1),
        "unetpp_cat_ms": sum(r["queued_ms"] for r in unetpp["concat_rows"]),
        "unetpp_cat_bound_ms": sum(r["bound_ms"]
                                   for r in unetpp["concat_rows"]),
        "unetpp_at": f"the 30 convs of one int8 forward of {PP_CFG}, "
                     f"{INT8_BATCH} tiles of {ICFG.tile_size}x"
                     f"{ICFG.tile_size}"}, {
        "name": "int8_upsample2x2", "route": "cuda",
        "source": "plumekit_torch/csrc/int8_upsample.cu",
        "replaces": "plumekit/models/quantized_forward.py:145 (XLA s8 "
                    "einsum with its dequant, shuffle and requant, no "
                    "Pallas)",
        "launches": int8_served["q2_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in q2_rows + pp_q2),
        # queued: 20 launches per event pair
        "ms": sum(r["queued_ms"] for r in q2_rows),
        # the plain version is the forward's path before Q2:
        # torch._int_mm and the eager dequant, shuffle and requant
        "plain_ms": sum(r["plain_ms"] for r in q2_rows),
        "bound_ms": sum(r["bound_ms"] for r in q2_rows),
        "bound_by": max(q2_share, key=q2_share.get),
        # no one PyTorch call computes the product with its requant and
        # shuffle; torch._int_mm of the same product alone beside it
        "library_ms": None,
        "int_mm_ms": sum(r["int_mm_ms"] for r in q2_rows),
        "single_ms": sum(r["single_ms"] for r in q2_rows),
        # queued launches without the op's dispatch (host-bound below
        # about 0.1 ms a call)
        "launch_ms": sum(r["launch_ms"] for r in q2_rows),
        # the trained checkpoint served with --int8
        "train_launches": chain["q2_serving_launches"],
        "maiac_launches": maiac["serving"]["int8"]["launches"]["hdf"]["q2"],
        "tta_launches": tta_launches["q2"],
        "at": f"the 4 upsamples of one int8 forward of UNetConfig(), "
              f"{INT8_BATCH} tiles of {ICFG.tile_size}x{ICFG.tile_size}",
        "unetpp_launches": pp_fwd["q2_launches"],
        "unetpp_serving_launches": pp_served["int8_launches"]["q2"],
        "unetpp_ms": sum(r["queued_ms"] for r in pp_q2),
        "unetpp_bound_ms": sum(r["bound_ms"] for r in pp_q2),
        "unetpp_plain_ms": sum(r["plain_ms"] for r in pp_q2),
        "unetpp_int_mm_ms": sum(r["int_mm_ms"] for r in pp_q2),
        "unetpp_launch_ms": sum(r["launch_ms"] for r in pp_q2),
        "unetpp_at": f"the 10 upsamples of one int8 forward of {PP_CFG}, "
                     f"{INT8_BATCH} tiles of {ICFG.tile_size}x"
                     f"{ICFG.tile_size}"}]
    # the serving entry points: launches of tune's sweep and of serve
    # --once for the kernel's forward, and the kernel at the tuner's tiles
    entry_of = {"fused_double_conv3x3_bn_relu": ("k6", "use_pallas"),
                "mega_forward": ("k7", "use_mega"),
                "int8_conv3x3": ("q1", "int8"),
                "int8_upsample2x2": ("q2", "int8")}
    for k in kernels:
        if k["name"] in entry_of:
            key, label = entry_of[k["name"]]
            k["tune_launches"] = entry["sweeps"][label]["launches"][key]
            k["serve_launches"] = \
                entry["served"][label]["serve_launches"][key]
            k["at_tuner_tiles"] = {
                t: {"batch": v["summary"]["batch"], **v["summary"][key]}
                for t, v in entry["tiles"].items()}
            # predict_model --exported over the 4 granules, and the op's
            # nodes in the exported program's graph
            k["exported_launches"] = \
                exported[label]["served_launches"][key]
            k["exported_graph_nodes"] = exported[label]["graph_ops"][
                {"k6": "fused_double_conv3x3", "k7": "unet_mega",
                 "q1": "int8_conv3x3", "q2": "int8_upsample2x2"}[key]]
    # the mesh paths: launches of the sharded serving calls (both replicas)
    # and of batch identify over the 2-slot mesh
    mesh_key = {"fused_double_conv3x3_bn_relu": "k6", "mega_forward": "k7",
                "int8_conv3x3": "q1", "int8_upsample2x2": "q2",
                "multi_threshold_ccl_fused": "k1", "fire_label_counts": "k3"}
    for k in kernels:
        if k["name"] in mesh_key:
            k["mesh_launches"] = mesh_launches[mesh_key[k["name"]]]
    copy_rate = measured_copy_rate()
    for k in kernels:
        k["bound_at_copy_rate_ms"] = k["bound_ms"] * (
            PEAK_BYTES_PER_S / copy_rate if k["bound_by"] == "bytes" else 1.0)
    print(f"device-to-device copy rate {copy_rate / 1e9:.1f} GB/s "
          f"({100 * copy_rate / PEAK_BYTES_PER_S:.1f}% of the data sheet's "
          f"{PEAK_BYTES_PER_S / 1e9:.0f} GB/s)")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "build_s": build_s,
                   "builds": {k: v["seconds"]
                              for k, v in cuda_build.BUILD_LOG.items()},
                   "mega": mega, "mega_serving": mega_served,
                   "single_conv_rows": single_rows, "probe": probe,
                   "kernel_rows": kernel_rows, "forward": forward,
                   "serving": served, "int8_conv_rows": q1_rows,
                   "int8_upsample_rows": q2_rows,
                   "int8_library": q1_library, "int8_forward": int8_forward,
                   "int8_serving": int8_served, "int8_phase_s": int8_phase_s,
                   "ccl_rows": ccl_rows,
                   "count_rows": count_rows, "identify": sweeps,
                   "build_features": features, "mask_rows": mask_rows,
                   "detectors": detectors,
                   "build_features_basic": basic_features,
                   "build_features_gaussian": gaussian_features,
                   "viirs": viirs, "maiac_hdf4": maiac,
                   "training": training, "curation": curation,
                   "streams": streams,
                   "unetpp": unetpp, "entry_points": entry,
                   "parallel": parallel,
                   "exported": exported,
                   "native": native_lib, "host_modules": host,
                   "copy_rate_gb_per_s": copy_rate / 1e9,
                   "seconds": time.perf_counter() - t_start,
                   "kernels": kernels},
                  f, indent=1)
    print(f"chip_smoke took {time.perf_counter() - t_start:.0f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
