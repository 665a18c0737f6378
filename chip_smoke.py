#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits nonzero).
Each kernel's tolerance against its plain version is defined once, in
torch_tools/kernel_checks.py; tests/test_torch_gpu.py holds each kernel to
it at its shapes and checks the rasterizer's gradients (there is no phase
3). Here the kernels are held to their plain versions at the shapes phase
2 times, and whole models and trainers run with the kernels against the
same inside `ops.plain()`.

1. the card's name and power limit (nvidia-smi), the builds of the three
   kernels and of the host library (csrc/host.cpp, g++; not a device
   kernel), all started together, and which of PIL, pandas, cv2 and
   imageio import here (information; phase 12 decodes GIFs with PIL);
2. the box-rasterizer kernel against its plain version (BF16_TOL), then
   its, its plain version's, the library's (torch.bmm) and a fill_'s times
   at the dense generator's shape (c), at the discriminator's shape (disc)
   and at the layout-conditioned MultiscaleDiscriminator's shape (msd), in
   turns (`time_shape`), beside the kernel's bound; then the fused SPADE
   denormalization (csrc/denorm.cu) bit-equal to its plain chain and timed
   beside its bound and the plain chain at DENORM_TIMED (`phase_denorm`);
   then the fused factorized frontend conv (csrc/objconv.cu) against its
   plain chain (`hold_objconv`) and timed beside its bound, the plain
   chain and the library products (cuBLAS bmm + cuDNN conv) at
   OBJCONV_TIMED (`phase_objconv`);
4. a small fp32 model at 64x64 built on the card (the default device) and
   on the CPU from one seed: the same weights; run with the kernels, inside
   `ops.plain()` on the card, and on the CPU: the frames must agree;
5. CATER 256x256 (the JAX package's Config defaults), dense frontend, bf16,
   B=2, T=8: one untimed `generate` call with the kernels (the rasterizer
   launched once, no plain call, 18 denorm launches a generated frame, no
   objconv launch) against the same call inside `ops.plain()` (no kernel
   launch; the boxes equal, the frames within GEN_REL_L2); the benchmark's
   generation cells time full-width generation;
6. at 64x64 / 32x32 in fp32 on the card: (a) the factorized-frontend
   generator agrees with the dense one given the same frontend kernels
   (spectral norm off); (b) a `GenerationSession` loaded from
   torch_tools/data/reference_factorized_32.npz reproduces the JAX
   package's outputs stored in that file;
7. phase 5 with the factorized frontend (the default config): no
   rasterizer launch and no plain call, two objconv launches a generated
   frame;
8. a small fp32 trainer at 64x64 (TF32 off), per frontend: `train.Trainer`
   on the card, on the CPU, and on the card inside `ops.plain()`, from
   one seed; two `train_step`s and one `graph_step` each: the losses, the
   parameters after the steps and the first `train_step`'s gradients (per
   parameter) must agree;
9. the training iteration at full width, the JAX package's Config defaults
   for CATER-256x256 (B=3 clips of 4 frames, graph clips of 16, factorized
   frontend, bf16, num_D=2, n_layers_D=4, ndf=64, feature matching and
   the VGG loss on, seeded random weights): 2 warm-up and 5 timed
   iterations (`train_step` + `graph_step`): finite losses, no skipped
   step, exactly 2 rasterizer kernel launches and no plain call per
   `train_step`, ms per iteration, training samples/s, peak memory and the
   device's busy share (the kernel time of one profiled iteration over the
   timed iterations' mean);
10. the training run at full width: `python -m ag2video_torch.scripts.train`
   (`main`) on the synthetic dataset at 256x256 with the Config defaults
   (phase 9's configuration on the synthetic vocabulary, the fidelity
   score from assets/synthetic_backbone.npz), cut to 6 iterations, a save
   every 3 (full, light, full), validation on 6 clips: the metrics stream,
   the validation metrics, the checkpoints and the run directory, 2
   rasterizer kernel launches per `train_step` and no plain call, the
   newest checkpoint restored exactly into a fresh Trainer that then takes
   the same step as the live one, and a `GenerationSession` of the run
   directory that renders what the live trainer renders; `fit`'s ms per
   iteration over the run's window (saves and validation included) and
   its p50 beside phase 9's, samples/s, `fit` with no save and no
   validation against fixed batches in turns, peak memory, the seconds of
   each validation pass, each save's size, fetch and write (and an async
   full save with the Adam moments after the loop), and the loaders' own
   ms per batch;
11. a CATER training run at full width: a CATER max2action tree fabricated
   with no PIL and no cv2 (torch_tools/cater_tree.py: 6 videos of 301
   frames at 320x240, PNG caches written by data/png.py), then
   `scripts.train.main` with --dataset cater at 256x256 and the Config
   defaults, cut to 4 iterations with saves at 0/2/4 and validation on 3
   clips: finite losses, no skipped step, a finite validation IoU, the
   checkpoints, 2 rasterizer kernel launches per `train_step` and no plain
   call; `--cache_data 1` on the same tree returns and touches no file;
   `fit`'s ms per iteration (window and p50) and the loaders' ms per batch
   beside phase 10's, `read_png`'s ms per frame, `clip_transform`'s ms per
   clip, peak memory and the phase's seconds;
12. the CLIs on phase 10's run directory: `scripts.generate` (every
   test/<id>.pkl finite, the first equal to the session's frames),
   `scripts.eval_fidelity` (every checkpoint's finite FID, into a directory
   that did not exist, real-vs-real under noise-vs-real) and
   `scripts.summarize_metrics` (the G, D and Graph losses); every GIF of
   the generate CLI and of phase 10's validation passes written by the
   port's encoder (utils/gif.py; no imageio) and decoded by PIL to exactly
   the encoder's quantized frames; torch_tools/sigma_audit.py on the run's
   newest checkpoint on the card (every SpectralWeight of the full-width G
   and D audited, every value finite; the count, mean and max relative
   error printed, with no bound on the error after 6 power iterations
   from a random `u`); torch_tools/jsonl_to_tfevents.py on a copy of the
   run's metrics.jsonl (the records read back equal its rows; a second
   conversion skips);
13. the evaluation stack: seeded state dicts in the pretrained layouts of
   InceptionV3, AlexNet/LPIPS, TSM-ResNet50 and ResNeXt3D-101
   (torch_tools/eval_assets.py) turned into assets in a temporary
   directory by `scripts.port_torch_weights.main`; each network from its
   asset on the card and on the CPU in fp32 (InceptionV3 at 299x299, LPIPS
   at 64x64, both video backbones at full depth on 16x112x112 clips, B=8):
   their rel-L2 (bound 1e-4), images/s or clips/s and peak memory on the
   card; `scripts.evaluate.main` in all six modes on the card (its
   default) on the renders of phase 10's run at itr_3 and itr_6 (.pkl
   clips, and PNGs of their last frames written by data/png.py), with no
   assets so on seeded random networks: every value finite, A against
   itself 0 (LPIPS) or ~0 (FID), the seconds of each call; `check_model`
   (use_gt) on phase 10's trainer, restored from the run's newest
   checkpoint, with an InceptionScore from the fabricated asset: a finite
   `inception_mean` / `inception_std`. The rasterizer is not on this path
   (0 launches);
14. the training modes of the Config at full width: phase 9's
   configuration three times, with `bp_prev` (the autoregressive loop in
   train mode), with `flow_deconv` (the transposed-conv flow decoder) and
   with `param_dtype="bfloat16"` (bf16 params, fp32 masters in the Adams):
   2 warm-up and 3 timed iterations each: finite losses, no skipped step,
   exactly 2 rasterizer kernel launches and no plain call per
   `train_step`, the BN statistics moved (bp_prev), live == bf16(master)
   bit for bit in all three Adams (bf16); ms per iteration, peak memory
   and the device's busy share (one profiled iteration) beside phase 9's;
   then one `train_step` at 64x64 in bf16 compute, with fp32 and with bf16
   params, from the port's seeded weights, held to the JAX package's step
   stored in torch_tools/data/reference_train_bf16_64.npz
   (torch_tools/make_reference_npz.py);
15. the last two CLIs: `scripts.train_backbone` into a temporary `--out`
   (cut in scale: 1,000 videos, 400 steps, 128 held-out videos): the loss
   falls, the held-out accuracies, the asset loads into the port's
   `FidelityScore` on the card; `scripts.eval_iou` on phase 10's run
   directory in its plain mode and both sweeps: every value finite; no
   rasterizer call of either kind;
16. the latent modules (models/discriminator_variants.py, models/encoder.py,
   MaskNet, ops/crop.py, ops/sampling.py, masks_to_layout) at the Config
   defaults for CATER-256x256 (B=3, T=4, O=12, bf16, ndf=64, num_D=2,
   n_layers_D=4, embedding_dim=128, crop_size=32): (a) one D step (forward
   on real and on fake clips, hinge loss, backward, Adam) of
   MultiscaleDiscriminator, MultiscaleDiscriminatorT and
   AcCropDiscriminator: finite loss and gradients, exactly 1 rasterizer
   kernel launch and no plain call per MultiscaleDiscriminator forward
   (none for the other two), ms per step, peak memory and the busy share
   of one profiled step; the real clips are seeded synthetic clips
   (`make_inputs`), the fake ones the seeded generator's; (b) at 64x64 in
   fp32, every variant, ConvEncoder, MaskNet, masks_to_layout (both modes)
   and crop_bbox_batch on the card against the CPU from one seed, outputs
   and gradients, and MultiscaleDiscriminator with the kernel against the
   same inside `ops.plain()` on the card; (c) ConvEncoder at full width
   (nf=64, z_dim=256) on the 12 frames with reparameterize and kld_loss,
   forward and backward; (d) MaskNet (mask_size 16) on create_mask_vecs of the
   layout model's object vectors, then masks_to_layout to 256x256 per
   sample in both modes: finite, and the test mode a composite; (e) the
   kernel at the msd shape, from phase 2;
17. data parallel (`ag2video_torch.parallel`): (a) two ranks that share the
   card over gloo (`init_distributed(backend="gloo")`; NCCL refuses two
   ranks on one device), each `Trainer(mesh=...)` at phase 9's
   configuration (CATER vocabulary; B=3 per rank, global 6, each rank's
   clips seeded synthetic clips from its own seed, `make_inputs`): 1 warm-up
   and 3 iterations, finite losses, no skipped step, every parameter,
   buffer and Adam state bit-equal across the ranks after every step
   (checksums all-reduced), 2 rasterizer kernel launches and no plain call
   per `train_step` on each rank; ms per iteration, ms and bytes of
   `allreduce_grads` per step and peak memory, per rank; (b) phase 8's
   small fp32 trainer at 64x64 on two ranks against one process on the
   card over the global batch (rank 0's slice, then rank 1's): the
   losses, each parameter's first-step gradient, the BN running statistics
   after one `train_step` + `graph_step`, beside one process against
   itself with its batch permuted; and the two-rank step with the kernels
   against the two-rank step inside `ops.plain()`; (c)
   `scripts.train.main` under torchrun's variables at world 1 (NCCL), 3
   iterations at 64x64 with a save at 2; (d) peak memory at 512x512: the
   default `generate` at B=2, T=8 and one `train_step` at B=1, beside the
   card's memory;
18. the training trajectory: the 8 iterations (`train_step` +
   `graph_step`, 64x64, an LR schedule that decays over the second half)
   of torch_tools/data/reference_trajectory_64.npz on the card, in fp32
   (TF32 off) and bf16 compute, from the port's seeded reference weights
   with the kernel on: exactly 2 rasterizer kernel launches and no plain
   call per `train_step`; every metric, learning rate, norm-state leaf,
   parameter update and spectral kernel held to the JAX package's under
   torch_tools/trajectory.py's bounds (each the larger of 4x the
   reference's own spread and the one-step floor; a quantity whose bound
   is 1 or more is unpinned and counted, not held; the quantities of its
   KNOWN_GAPS are reported, not held), the worst and median of each
   category beside their bounds; the sigma audit of the final state, the
   port's and the JAX run's (from the file); the same iterations run again
   on the card, against the first run (the card's own spread). cuDNN runs
   its deterministic algorithms for the phase.

Then a JSON line describing each kernel and, last, the device line.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import glob
import io
import json
import os
import pickle
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from ag2video_torch import Config, get_vocab
from ag2video_torch.flax_npz import COLLECTIONS, unflatten_variables
from ag2video_torch.data.png import read_png, write_png
from ag2video_torch.eval.backbone import FidelityScore, load_backbone
from ag2video_torch.data.transforms import clip_transform, denormalize
from ag2video_torch.eval.inception import (InceptionScore, inception_v3,
                                           load_inception_params)
from ag2video_torch.eval.layers import load_variables
from ag2video_torch.eval.lpips import LPIPS
from ag2video_torch.eval.video_backbones import (BACKBONES,
                                                 load_backbone_params)
from ag2video_torch.inference import GenerationSession, generate, make_inputs
from ag2video_torch.losses.gan import multiscale_gan_loss
from ag2video_torch.losses.perceptual import kld_loss
from ag2video_torch.models import AG2VideoModel
from ag2video_torch.models.discriminator_variants import (
    AcCropDiscriminator, MultiscaleDiscriminator, MultiscaleDiscriminatorT)
from ag2video_torch.models.encoder import ConvEncoder, reparameterize
from ag2video_torch.models.factorized import shifted_stack
from ag2video_torch.models.generator import (Layout2VidGenerator,
                                             remove_dummy_objects_mask)
from ag2video_torch.models.layout_model import MaskNet, create_mask_vecs
from ag2video_torch.models.layers import conv2d_nhwc
from ag2video_torch.models.normalization import BatchNorm
from ag2video_torch import ops
from ag2video_torch.ops import crop_bbox_batch, masks_to_layout
from ag2video_torch.ops import denorm as denorm_ops
from ag2video_torch.ops import objconv as objconv_ops
from ag2video_torch.ops._kernels import host_library, load
from ag2video_torch.ops.rasterize import (KERNEL_LAUNCHES, PLAIN_CALLS,
                                          box_coverage,
                                          boxes_to_layout_batch)
from ag2video_torch.parallel import init_distributed, make_mesh
from ag2video_torch.parallel.mesh import (LAUNCH_VARS, replicas_differ,
                                          state_tensors)
from ag2video_torch.scripts.eval_fidelity import main as eval_fidelity_main
from ag2video_torch.scripts.evaluate import _inception_pool3, _load_images
from ag2video_torch.scripts.eval_iou import main as eval_iou_main
from ag2video_torch.scripts.evaluate import main as evaluate_main
from ag2video_torch.scripts.generate import main as generate_main
from ag2video_torch.scripts.summarize_metrics import main as summarize_main
from ag2video_torch.scripts.train import main as train_main
from ag2video_torch.scripts.train_backbone import main as train_backbone_main
from ag2video_torch.train import Trainer
from ag2video_torch.train import checkpoint as ckpt_lib
from ag2video_torch.train.state import reset_optimizers
from ag2video_torch.utils import gif as gif_lib
from ag2video_torch.utils import vis as vis_lib
from ag2video_torch.utils.vis import save_video_pickle
from ag2video_torch.weights import (flax_to_state_dict, init_params,
                                    transposed_keys)
from torch_tools.cater_tree import make_tree
from torch_tools.eval_assets import write_assets
from torch_tools import jsonl_to_tfevents, sigma_audit, trajectory
from torch_tools.kernel_checks import BF16_TOL, hold_objconv, same_bits

SMALL = dict(image_size=(64, 64), frames_per_action=3, max_objects=5,
             max_triplets=6, max_actions=2, embedding_dim=16, gconv_dim=16,
             gconv_hidden_dim=32, gconv_num_layers=2, ngf=4, nff=4,
             n_blocks_F=1, n_downsample_F=2, compute_dtype="float32")
FULL = dict(image_size=(256, 256), frames_per_action=8, max_objects=11,
            max_triplets=11, max_actions=2, compute_dtype="bfloat16")
# The 64x64 model in fp32 (TF32 off): kernel vs plain seg differ by fp32
# rounding only; the card vs the CPU also differ in conv summation order.
MODEL_TOL_CARD = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL_CPU = dict(rtol=1e-3, atol=1e-3)
# Full-width bf16 generation (phases 5 and 7): the kernels against the same
# call inside `ops.plain()`. The predicted boxes do not meet a kernel and
# must be equal; the frames differ where a kernel rounds an fp32 sum taken
# in another order (the rasterizer, objconv: one bf16 rounding of an
# element now and then), carried through the 7 frames the loop feeds back:
# about 7.5e-3 relative L2 on an H100, a couple of bf16 roundings (2^-8
# each); a kernel that is wrong gives O(1).
GEN_REL_L2 = 2e-2
# The generator pair of phase 6a (the JAX package's
# tests/test_factorized_generator.py): spectral norm off, so the two
# frontends share their kernels exactly.
PAIR_GEN = dict(semantic_nc=64, ngf=4, nff=8, n_blocks_F=1, n_downsample_F=1,
                norm_F="syncbatch", norm_G="spadesyncbatch3x3")
# That test's own bound: the two frontends sum 9*1027 products in other
# orders, and the SPADE stack and the frame loop carry the difference on.
PAIR_TOL = dict(rtol=1e-3, atol=1e-4)
# Phase 8: SMALL with the discriminator widths of the JAX package's
# tests/test_train.py::tiny_config, 3-frame clips and 4-frame graph clips.
# lr 1e-5: Adam's first update is ~lr * sign(g), so a gradient element at
# rounding level that flips sign moves its parameter by 2 * lr per step.
TRAIN_SMALL = dict(SMALL, batch_size=2, frames_per_action_graph=1, num_D=2,
                   n_layers_D=2, learning_rate=1e-5)
# First step from identical weights: summation order only (the CPU tests
# see <= 1e-6 between the port and the JAX package). The second step and
# the graph step follow an update that rounding may have flipped in sign
# (the card vs the CPU: 1.2e-3 in the second step's loss_F_Warp, whose
# flows are 20x the flow net's output).
STEP1_TOL = dict(rtol=1e-4, atol=1e-6)
STEP2_TOL = dict(rtol=1e-2, atol=1e-6)
# Parameters after two Adam steps: each update is at most ~1.15 * lr, so a
# flipped element moves by at most ~4.3 * lr over the two.
PARAM_ATOL = 5 * TRAIN_SMALL["learning_rate"]
# Those parameters cannot see a wrong gradient: Adam moves each by about
# lr whatever the gradient's size. So the first train_step's gradients (the
# G step's and the D step's, from identical weights) are held per
# parameter by rel-L2, the worst parameter and the median of all. A
# gradient that is zero but for rounding (a bias before a train-mode norm)
# is held against ZERO_GRAD_REL of its network's largest instead of its own
# norm. Rounding-level differences of the forward grow in the gradients
# (grid_sample's gradient w.r.t. the flow grid is piecewise in the image;
# ReLU kinks; train-mode BN at B=2): measured on the H100, the card
# against the CPU <= 2.2e-2 per parameter (median <= 4.7e-3), and the same
# spread between the kernel and the plain rasterizer on the card on the
# dense frontend (1.6e-2, median 4.5e-3). The channels_last avg-pool
# backward fault gave 0.58 and a median of 0.24 against the CPU.
TRAIN_GRAD_REL_L2 = 1e-1
TRAIN_GRAD_MEDIAN = 2e-2
ZERO_GRAD_REL = 1e-5
# Phase 9: the JAX package's Config defaults at CATER-256x256 (batch 3,
# 4-frame clips, 4 * 4-frame graph clips, 12 objects / triplets, 4
# actions, factorized frontend, D and losses as configured), in bf16.
TRAIN_FULL = dict(image_size=(256, 256), compute_dtype="bfloat16")
# Phase 10: the training CLI with the Config defaults on the synthetic
# dataset at 256x256, cut in length only.
FIT_ARGS = ["--dataset", "synthetic", "--image_size", "256,256",
            "--num_iterations", "6", "--checkpoint_every", "3",
            "--full_checkpoint_every_n", "2", "--num_val_samples", "6",
            "--print_every", "3", "--timing", "1"]
# Phase 11: the training CLI with the Config defaults on a fabricated CATER
# tree at 256x256, cut in length only.
CATER_ARGS = ["--dataset", "cater", "--image_size", "256,256",
              "--num_iterations", "4", "--checkpoint_every", "2",
              "--num_val_samples", "3", "--print_every", "2", "--timing", "1"]
CATER_VIDEOS, CATER_OBJECTS = 6, 5
CATER_ENV = ("CATER_DATA_ROOT", "CATER_SPLITS_DIR", "CATER_NFRAMES")
OPTIONAL_PACKAGES = ("PIL", "pandas", "cv2", "imageio")
# The run's session against the live trainer: the same weights through the
# same forward on one card.
SESSION_TOL = dict(rtol=1e-5, atol=1e-5)
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_tools", "data", "reference_factorized_32.npz")
# Phase 14: phase 9's configuration in each training mode of the Config.
TRAIN_MODES = {"bp_prev": dict(bp_prev=True),
               "flow_deconv": dict(flow_deconv=True),
               "bf16_params": dict(param_dtype="bfloat16")}
TRAIN_REFERENCE = os.path.join(os.path.dirname(REFERENCE),
                               "reference_train_bf16_64.npz")
# The port's bf16 step against the JAX package's (one train_step, bf16
# compute, same weights and batch): both round every conv, norm and warp
# to bf16, in other orders. Each loss within REF_LOSS_RTOL of max(|JAX
# loss|, 1) (GAN_Img is a mean of logits near 0, so it is held absolutely),
# the norm state within REF_STATE_REL_L2 relative L2. Measured on the CPU:
# 2.7e-3 relative on the losses >= 1, 1.9e-3 absolute on GAN_Img, the
# state 6.5e-3; the port's own bf16 step against its fp32-compute step
# differs by 1.5e-2 / 1.1e-2.
REF_LOSS_RTOL = 1e-2
REF_STATE_REL_L2 = 3e-2
# Phase 15: scripts.train_backbone cut in scale (its defaults: 4,000
# videos, 2,000 steps, 256 held-out videos).
BACKBONE_ARGS = ["--n_videos", "1000", "--steps", "400",
                 "--n_val_videos", "128"]
# Phase 17: two ranks on the card; (a) 3 timed iterations after 1 warm-up.
DP_WORLD, DP_RUNS = 2, 3
# (b) Two ranks against one process over the global batch, fp32: the sums
# of the ranks' BatchNorm statistics against one pass's means, rounding
# only, which the train-mode norms of the small trainer amplify (its SPADE
# head normalises 2x2 maps of 4 clips). Bounds: the losses within
# DP_LOSS_RTOL of max(|loss|, 1); the first step's gradients per parameter
# as phase 8 holds them (compare_grads), the worst within DP_GRAD_WORST and
# the median within DP_GRAD_MEDIAN; the BN running statistics within
# DP_STATE_ATOL. Measured on the H100: losses 1.5e-7, gradients 3.5e-2
# (the SPADE head's mlp_beta bias) and median 2.6e-3, BN statistics
# 2.9e-6; one process against itself with its batch permuted 7.5e-8,
# 4.1e-3 / 1.4e-3, 1.4e-6; the card against the CPU in phase 8 up to
# 2.2e-2 per parameter.
DP_LOSS_RTOL = 1e-5
DP_GRAD_WORST, DP_GRAD_MEDIAN = 1e-1, 1e-2
DP_STATE_ATOL = 1e-5
# (c) the training CLI at world 1 over NCCL, phase 8's widths at 64x64.
DP_CLI_ARGS = ["--dataset", "synthetic", "--num_iterations", "3",
               "--checkpoint_every", "2", "--print_every", "1",
               "--num_val_samples", "2"] + [
    a for k, v in SMALL.items()
    for a in (f"--{k}", ",".join(map(str, v)) if k == "image_size"
              else str(v))]


def check_close(name, got, ref, tol):
    err = (got.float() - ref.float()).abs()
    bound = tol["atol"] + tol["rtol"] * ref.float().abs()
    worst = float(err.max()) if err.numel() else 0.0
    if not bool(torch.isfinite(got).all() & torch.isfinite(ref).all()) or \
            bool((err > bound).any()):
        raise AssertionError(f"{name}: max |diff| {worst:.3e} exceeds "
                             f"rtol={tol['rtol']} atol={tol['atol']}")
    return worst


def rel_l2(got, ref, name="output"):
    """||got - ref|| / ||ref||, in float64; raises on a non-finite value on
    either side (so a max over readings never drops a NaN)."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    if not bool(torch.isfinite(got).all() & torch.isfinite(ref).all()):
        raise AssertionError(f"{name}: non-finite values")
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def raster_inputs(N, O, D, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    vecs = torch.randn(N, O, D, generator=g).to(dtype)
    lo = torch.rand(N, O, 2, generator=g) * 1.1 - 0.2
    ext = torch.rand(N, O, 2, generator=g) * 0.65 + 0.05
    boxes = torch.cat([lo, ext], -1)
    mask = (torch.rand(N, O, generator=g) > 0.25).float()
    return vecs.cuda(), boxes.cuda(), mask.cuda()


def optional_packages():
    """{package: whether it imports}, tried in a child process so that this
    one never holds them."""
    code = ("import importlib, json\nok = {}\nfor m in %r:\n    try:\n"
            "        importlib.import_module(m)\n        ok[m] = True\n"
            "    except Exception:\n        ok[m] = False\n"
            "print(json.dumps(ok))" % (OPTIONAL_PACKAGES,))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, check=True, timeout=120)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    with ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(load, "rasterize"), pool.submit(host_library),
                  pool.submit(load, "denorm"), pool.submit(load, "objconv")]
        built, host, denorm, objconv = (b.result() for b in builds)

    def ptxas(lib):
        return " | ".join(ln.strip() for ln in lib.build_log.splitlines()
                          if "registers" in ln or "spill" in ln)

    found = optional_packages()
    print(f"phase 1 build: csrc/rasterize.cu -> {built.path.name} in "
          f"{built.build_seconds:.2f} s; ptxas: {ptxas(built)}; "
          f"csrc/denorm.cu -> {denorm.path.name} in "
          f"{denorm.build_seconds:.2f} s; ptxas: {ptxas(denorm)}; "
          f"csrc/objconv.cu -> {objconv.path.name} in "
          f"{objconv.build_seconds:.2f} s; ptxas: {ptxas(objconv)}; "
          f"csrc/host.cpp (host code, g++) -> {host.path.name} in "
          f"{host.build_seconds:.2f} s; optional packages: "
          + ", ".join(f"{m} {'imports' if ok else 'missing'}"
                      for m, ok in found.items()))
    return found


# The rasterizer's shapes timed in phase 2 (its checks against the plain
# version are tests/test_torch_gpu.py's).
SHAPE_C = (16, 11, 512, 256, 256)  # (N, O, D, H, W) of the generator
# The discriminator's call in training: N = B * (T - 1) = 9 frames of the
# full-width config, O = 12, D = 2 * gconv_dim = 256.
SHAPE_DISC = (9, 12, 256, 256, 256)
# The layout-conditioned MultiscaleDiscriminator's call (phase 16): N = B * T
# = 12 frames, O = 12, D = 4 families * embedding_dim 128 = 512.
SHAPE_MSD = (12, 12, 512, 256, 256)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak, same source


def interleaved_ms(fns, rounds=15, reps=10, warmup=2):
    """Median ms per launch of each of `fns`, by CUDA events, in turns.

    Each sample is `reps` launches queued back to back behind one untimed
    launch, so the card is busy from the first event to the last and the
    host's launch overhead stays outside the time."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            fn()
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b) / reps)
    return {k: statistics.median(v) for k, v in times.items()}


def time_shape(vecs, boxes, mask, H, W, extra=None):
    """Median ms per launch, timed in turns, of the kernel, its plain
    version, the library yardstick (torch.bmm of the precomputed
    (N, H*W, O) bf16 coverage with the vecs: the same contraction writing
    the same bytes, never called by the port), a fill_ of the output's
    bytes (the write rate the card reaches in practice) and `extra`."""
    N, O, _ = vecs.shape
    filled = torch.empty(N, H, W, vecs.shape[-1], dtype=vecs.dtype,
                         device=vecs.device)
    cov_t = box_coverage(boxes, H, W, mask).to(vecs.dtype) \
        .reshape(N, O, H * W).transpose(1, 2).contiguous()

    def plain():
        with ops.plain():
            return boxes_to_layout_batch(vecs, boxes, H, W, mask=mask)

    return interleaved_ms({
        "kernel": lambda: boxes_to_layout_batch(vecs, boxes, H, W, mask=mask),
        "plain": plain,
        "library": lambda: torch.bmm(cov_t, vecs),
        "fill": lambda: filled.fill_(1.0),
        **(extra or {}),
    })


def phase_kernel():
    """Phase 2, the rasterizer at (c), (disc) and (msd): held to its plain
    version (BF16_TOL), then timed in turns against its bound, its plain
    version and the library yardstick."""
    timing, lines = {}, []
    for name, shape, seed in (("c", SHAPE_C, 3), ("disc", SHAPE_DISC, 5),
                              ("msd", SHAPE_MSD, 7)):
        N, O, D, H, W = shape
        vecs, boxes, mask = raster_inputs(N, O, D, H, torch.bfloat16, seed)
        k = boxes_to_layout_batch(vecs, boxes, H, W, mask=mask)
        with ops.plain():
            p = boxes_to_layout_batch(vecs, boxes, H, W, mask=mask)
        err = check_close(f"rasterizer ({name})", k, p, BF16_TOL)
        del k, p
        ms = time_shape(vecs, boxes, mask, H, W)
        written = N * H * W * D * 2
        read = vecs.numel() * 2 + boxes.numel() * 4 + mask.numel() * 4
        bytes_ms = (written + read) / HBM_BYTES_PER_S * 1e3
        flops_ms = 2 * N * H * W * O * D / BF16_FLOPS * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        lines.append(
            f"at ({name}) N={N} O={O} D={D} {H}x{W} kernel "
            f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, library "
            f"torch.bmm {ms['library']:.4f} ms, fill_ of the same bytes "
            f"{ms['fill']:.4f} ms; bound {bound_ms:.4f} ms (bytes "
            f"{bytes_ms:.4f}, bf16 flops {flops_ms:.4f}); kernel at "
            f"{100 * bound_ms / ms['kernel']:.1f}% of its bound, "
            f"{written / ms['kernel'] / 1e6:.1f} GB/s written")
        timing[name] = dict(
            max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
            bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= flops_ms else "operations",
            library_ms=ms["library"])
    print("phase 2 kernel vs plain max|diff|: " + " ".join(
        f"({k}) {t['max_abs_err']:.3e}" for k, t in timing.items())
        + "; medians of 15 samples of 10 launches in turns, CUDA events; "
        + "; ".join(lines))
    return timing


# (name, B, H = W, C): SPADE norms of the B=16 cells' generator (ngf 64,
# 256x256) timed in phase 2: up_3's norm_0, the largest, and head_0's, the
# smallest level.
DENORM_TIMED = [("up_3.norm_0", 16, 256, 128), ("head_0.norm_0", 16, 8, 1024)]


def phase_denorm():
    """Phase 2, the fused SPADE denormalization (csrc/denorm.cu): bit-equal
    to its plain chain, leaky ReLU on and off, then timed in turns against
    its bound (x, gamma, beta read and y written once: 8 bytes per bf16
    element at 3.35 TB/s) and the plain chain."""
    timing, lines = {}, []
    for i, (name, B, H, C) in enumerate(DENORM_TIMED):
        g = torch.Generator(device="cuda").manual_seed(11 + i)
        x = torch.randn(B, H, H, C, generator=g, device="cuda").bfloat16()
        gb = torch.randn(B, H, H, 2 * C, generator=g, device="cuda") \
            .bfloat16()
        mean = torch.randn(C, generator=g, device="cuda")
        mul = torch.rsqrt(torch.rand(C, generator=g, device="cuda") + 1e-5)
        for act in (True, False):
            same_bits(denorm_ops.denorm_fused(x, gb, mean, mul, act),
                      denorm_ops.denorm_plain(x, gb, mean, mul, act))
        ms = interleaved_ms({
            "kernel": lambda: denorm_ops.denorm_fused(x, gb, mean, mul, True),
            "plain": lambda: denorm_ops.denorm_plain(x, gb, mean, mul, True),
        })
        moved = 4 * x.numel() * x.element_size()
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        lines.append(
            f"at {name} {B}x{H}x{H}x{C} bf16 kernel {ms['kernel']:.4f} ms, "
            f"plain chain {ms['plain']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({moved / 1e9:.3f} GB); kernel at "
            f"{100 * bound_ms / ms['kernel']:.1f}% of its bound, "
            f"{moved / ms['kernel'] / 1e6:.1f} GB/s")
        timing[name] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                            bound_ms=bound_ms, bound_by="bytes")
    print("phase 2 (denorm) bit-equal to the plain chain, leaky ReLU on and "
          "off; medians of 15 samples of 10 launches in turns, CUDA events; "
          + "; ".join(lines))
    return timing


# Launches of the fused SPADE denormalization on each main path that
# generates frames in eval mode, keyed by path; the kernels line reports
# them as `launches_<path>`.
DENORM_LAUNCHES = {}
DENORM_NORMS = 18  # SPADE norms in the generator: one launch each a frame


def denorm_launches(path, frames=None):
    """Record the denorm kernel's launches since its counter was last reset
    as `path`'s, and reset it. With `frames` (generated frames, each a
    `netG` call) they must be exactly 18 a frame; otherwise a positive
    multiple of 18: every eval-mode norm on the card launches the kernel."""
    n = denorm_ops.KERNEL_LAUNCHES.n
    denorm_ops.KERNEL_LAUNCHES.reset()
    ok = (n == DENORM_NORMS * frames if frames is not None
          else n > 0 and n % DENORM_NORMS == 0)
    if not ok:
        raise AssertionError(f"{path}: {n} denorm kernel launches, want "
                             + (f"{DENORM_NORMS} x {frames}" if frames
                                is not None else f"a multiple of "
                                f"{DENORM_NORMS}"))
    DENORM_LAUNCHES[path] = n
    return n


# (name, B, nF, O, H, W, F, C): the B=16 cell's two factorized frontend
# convs (generator.py's conv_dim_in and flow_down_0), timed in phase 2.
OBJCONV_TIMED = [("conv_dim_in", 16, 2, 11, 256, 256, 512, 3),
                 ("flow_down_0", 16, 2, 11, 256, 256, 32, 3)]


def objconv_inputs(B, nF, O, H, W, F, C, seed):
    """The frame loop's window (box coverage sliced from a T=8 clip, bf16),
    projected kernels, image and image kernel, and a BatchNorm with
    running statistics, on the card; seeded."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    boxes = torch.cat([torch.rand(B, 8, O, 2, generator=g, device="cuda")
                       * 0.8, 0.05 + torch.rand(B, 8, O, 2, generator=g,
                                                device="cuda") * 0.5], -1)
    mask = (torch.rand(B, 8, O, generator=g, device="cuda") > 0.2).float()
    cov = box_coverage(boxes, H, W, mask).to(torch.bfloat16)[:, 3:3 + nF]
    wk = (torch.randn(B, nF * O, 9, F, generator=g, device="cuda")
          * 0.3).bfloat16()
    img = torch.rand(B, H, W, C, generator=g, device="cuda").bfloat16()
    w_img = (torch.randn(F, C, 3, 3, generator=g, device="cuda")
             * 0.3).bfloat16()
    bn = BatchNorm(F, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        bn.running_mean.normal_(0.0, 0.3, generator=g)
        bn.running_var.uniform_(0.3, 3.0, generator=g)
        bn.weight.normal_(1.0, 0.3, generator=g)
        bn.bias.normal_(0.0, 0.3, generator=g)
    return cov, wk, img, w_img, bn


def phase_objconv():
    """Phase 2, the fused factorized frontend conv (csrc/objconv.cu) with
    its BatchNorm: held to its plain chain (the share of elements that
    differ and the relative L2, `hold_objconv`), then timed in turns
    against its bound (coverage and image
    read, the bf16 output written once; 2 * 9 * (K + C) FLOPs an output
    element), the plain chain and the library products alone (torch.bmm
    of the precomputed bf16 shifted coverage and cuDNN's bf16 image conv:
    no norm, no activation; the port never calls them so)."""
    timing, lines = {}, []
    for i, (name, B, nF, O, H, W, F, C) in enumerate(OBJCONV_TIMED):
        cov, wk, img, w_img, bn = objconv_inputs(B, nF, O, H, W, F, C,
                                                 21 + i)
        K = nF * O
        cov4 = cov.reshape(B, K, H, W)
        mean, mul, shift = bn.eval_affine()
        with torch.no_grad():
            share, rel = hold_objconv(
                objconv_ops.objconv_fused(cov, wk, img, w_img, mean, mul,
                                          shift),
                objconv_ops.objconv_plain(cov4, wk, img, w_img, bn, None,
                                          False), name)
            cs = shifted_stack(cov4, 3).reshape(
                B, K * 9, H * W).transpose(1, 2).contiguous()
            wk3 = wk.reshape(B, K * 9, F)
            ms = interleaved_ms({
                "kernel": lambda: objconv_ops.objconv_fused(
                    cov, wk, img, w_img, mean, mul, shift),
                "plain": lambda: objconv_ops.objconv_plain(
                    cov4, wk, img, w_img, bn, None, False),
                "library": lambda: (torch.bmm(cs, wk3), conv2d_nhwc(
                    img, w_img, None, dtype=torch.bfloat16)),
            }, rounds=7, reps=5)
            del cs
        moved = (cov.numel() + img.numel() + B * H * W * F) * 2
        flops = 2 * B * H * W * F * 9 * (K + C)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOPS * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        lines.append(
            f"at {name} B={B} {H}x{W} nF*O={K} F={F} C={C} bf16: "
            f"kernel {ms['kernel']:.4f} ms, plain chain "
            f"{ms['plain']:.4f} ms, library (bmm + cuDNN conv) "
            f"{ms['library']:.4f} ms, bound {bound_ms:.4f} ms (bytes "
            f"{moved / 1e9:.3f} GB = {bytes_ms:.4f} ms, {flops / 1e9:.1f} "
            f"GFLOP = {flops_ms:.4f} ms); kernel at "
            f"{100 * bound_ms / ms['kernel']:.1f}% of its bound, "
            f"{moved / ms['kernel'] / 1e6:.1f} GB/s, "
            f"{flops / ms['kernel'] / 1e9:.1f} TFLOP/s; against the plain "
            f"chain {100 * share:.4f}% of the elements differ, relative L2 "
            f"{rel:.3e}")
        timing[name] = dict(differ=share, rel_l2=rel,
                            ms=ms["kernel"], plain_ms=ms["plain"],
                            library_ms=ms["library"], bound_ms=bound_ms,
                            bound_by="bytes" if bytes_ms >= flops_ms
                            else "flops")
        del cov, wk, img, w_img, cov4
        torch.cuda.empty_cache()
    print("phase 2 (objconv) medians of 7 samples of 5 launches in turns, "
          "CUDA events; " + "; ".join(lines))
    return timing


# Launches of the fused factorized frontend conv on each main path, keyed
# by path; the kernels line reports them as `launches_<path>`.
OBJCONV_LAUNCHES = {}


def objconv_launches(path, want=None):
    """Record the objconv kernel's launches since its counter was last
    reset as `path`'s, reset it, and hold them to `want`; by default to 2
    a generated frame (flow_down_0 and conv_dim_in of a factorized
    generator), counted from the denorm kernel's 18 a frame on `path`."""
    if want is None:
        want = 2 * DENORM_LAUNCHES[path] // DENORM_NORMS
    n = objconv_ops.KERNEL_LAUNCHES.n
    objconv_ops.KERNEL_LAUNCHES.reset()
    if n != want:
        raise AssertionError(f"{path}: {n} objconv kernel launches, want "
                             f"{want}")
    OBJCONV_LAUNCHES[path] = n
    return n


def phase_small_model():
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", factorized_frontend=False,
                 **SMALL).derive(vocab)
    batch = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    cpu_model = AG2VideoModel(cfg, vocab, device="cpu")
    cpu_imgs, _ = generate(cpu_model, batch)
    model = AG2VideoModel(cfg, vocab)  # on the card by default
    cpu_state = cpu_model.state_dict()
    for k, v in model.state_dict().items():
        if v.device.type != "cuda" or not torch.equal(v.cpu(), cpu_state[k]):
            raise AssertionError(f"seeded weight {k} differs on the card")
    KERNEL_LAUNCHES.reset()
    denorm_ops.KERNEL_LAUNCHES.reset()
    k_imgs, _ = generate(model, batch)
    torch.cuda.synchronize()
    denorm_launches("per_generate_small_fp32",
                    cfg.frames_per_action - cfg.n_frames_G + 1)
    if KERNEL_LAUNCHES.n == 0:
        raise AssertionError("the small model did not launch the kernel")
    with ops.plain():
        p_imgs, _ = generate(model, batch)
    e_card = check_close("64x64 kernel vs plain on the card", k_imgs, p_imgs,
                         MODEL_TOL_CARD)
    e_cpu = check_close("64x64 card vs CPU", k_imgs.cpu(), cpu_imgs,
                        MODEL_TOL_CPU)
    print(f"phase 4 small fp32 model 64x64: imgs_pred kernels vs plain on "
          f"the card {e_card:.3e}, card vs CPU {e_cpu:.3e}")


def phase_full(factorized):
    """Phase 5 (dense frontend) or 7 (factorized, the default config): one
    untimed B=2 T=8 256x256 bf16 `generate` call, each kernel's launches
    counted, against the same call inside `ops.plain()`, in which no
    kernel launches. The generation cells of the benchmark time it."""
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", factorized_frontend=factorized,
                 **FULL).derive(vocab)
    B, T = 2, cfg.frames_per_action
    H, W = cfg.image_size
    batch = make_inputs(cfg, vocab, B, T, seed=0)
    model = AG2VideoModel(cfg, vocab)
    counts = (KERNEL_LAUNCHES, PLAIN_CALLS, denorm_ops.KERNEL_LAUNCHES,
              objconv_ops.KERNEL_LAUNCHES)
    for c in counts:
        c.reset()
    imgs, boxes = generate(model, batch)
    torch.cuda.synchronize()
    launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
    path = f"per_generate_{'factorized' if factorized else 'dense'}"
    frames = T - cfg.n_frames_G + 1
    denorm = denorm_launches(path, frames)
    # flow_down_0 and conv_dim_in of each generated frame, factorized only.
    objconv = objconv_launches(path, 2 * frames if factorized else 0)
    if tuple(imgs.shape) != (B, T, H, W, 3):
        raise AssertionError(f"imgs_pred shape {tuple(imgs.shape)}")
    # The dense path rasterizes with the kernel only; the factorized path
    # never rasterizes, so any call there means the dense path ran.
    if plain != 0 or (launches != 0 if factorized else launches == 0):
        raise AssertionError(f"rasterizer kernel launches {launches}, "
                             f"plain calls {plain}")
    for c in counts:
        c.reset()
    with ops.plain():
        p_imgs, p_boxes = generate(model, batch)
    torch.cuda.synchronize()
    inside = (KERNEL_LAUNCHES.n, denorm_ops.KERNEL_LAUNCHES.n,
              objconv_ops.KERNEL_LAUNCHES.n)
    if inside != (0, 0, 0):
        raise AssertionError(f"kernel launches inside ops.plain(): {inside}")
    if not torch.equal(boxes, p_boxes):
        raise AssertionError("boxes_pred differ inside ops.plain()")
    rel = rel_l2(imgs, p_imgs, "imgs_pred")
    worst = float((imgs.float() - p_imgs.float()).abs().max())
    if rel > GEN_REL_L2:
        raise AssertionError(f"imgs_pred kernels vs plain: relative L2 "
                             f"{rel:.3e} > {GEN_REL_L2}")
    print(f"phase {7 if factorized else 5} CATER 256x256 "
          f"{'factorized' if factorized else 'dense'} frontend B={B} T={T} "
          f"bf16, untimed: rasterizer kernel launches {launches}, plain "
          f"calls {plain}; denorm kernel launches {denorm}; objconv kernel "
          f"launches {objconv}; none inside ops.plain(); imgs_pred kernels "
          f"vs plain relative L2 {rel:.3e} (max |diff| {worst:.3e}), "
          f"boxes_pred equal")
    return launches


def factorized_state_from_dense(state):
    """A dense-frontend generator's state dict in the factorized layout:
    flows_network.down_0 -> flow_down_0, conv_dim_in.conv -> conv_dim_in."""
    renames = (("frame_step.flows_network.down_0.conv.weight",
                "frame_step.flow_down_0.weight"),
               ("frame_step.flows_network.down_0.norm.",
                "frame_step.flow_down_0.norm."),
               ("frame_step.conv_dim_in.conv.weight",
                "frame_step.conv_dim_in.weight"))
    out = {}
    for k, v in state.items():
        for old, new in renames:
            k = k.replace(old, new)
        out[k] = v
    return out


def dense_and_factorized(device, H, seed=0):
    """Phase 6a's pair on `device`: the dense generator with seeded weights
    and the factorized one loaded with the same kernels, run on one seeded
    batch (B=2, T=3, O=4) -> {False: outputs, True: outputs}."""
    vocab = get_vocab("cater")
    dense = init_params(Layout2VidGenerator(vocab, **PAIR_GEN), seed)
    fact = Layout2VidGenerator(vocab, factorized_frontend=True, **PAIR_GEN)
    fact.load_state_dict(factorized_state_from_dense(dense.state_dict()),
                         strict=True)
    rng = np.random.RandomState(seed)
    objs = rng.randint(1, 3, (2, 4, 4))
    objs[:, -1] = 0
    args = [torch.from_numpy(a).to(device) for a in (
        rng.randn(2, 3, H, H, 3).astype(np.float32), objs,
        rng.randn(2, 3, 4, 128).astype(np.float32),
        rng.uniform(0.1, 0.5, (2, 3, 4, 4)).astype(np.float32))]
    out = {}
    for factorized, gen in ((False, dense), (True, fact)):
        with torch.no_grad():
            out[factorized] = gen.to(device).eval()(*args)
    return out


def load_reference():
    """(Config, vocab, inputs, JAX outputs, variables as flat arrays) of
    torch_tools/data/reference_factorized_32.npz."""
    with np.load(REFERENCE) as ref:
        arrays = {k: ref[k] for k in ref.files}
    cfg = Config.from_dict(json.loads(str(arrays.pop("config"))))
    part = lambda p: {k.split("/", 1)[1]: v for k, v in arrays.items()
                      if k.split("/", 1)[0] == p}
    flat = {k: v for k, v in arrays.items() if k.split("/")[0] in COLLECTIONS}
    return cfg, get_vocab(cfg.dataset), part("input"), part("output"), flat


def phase_factorized():
    denorm_ops.KERNEL_LAUNCHES.reset()
    objconv_ops.KERNEL_LAUNCHES.reset()
    out = dense_and_factorized("cuda", 64)
    pair = denorm_launches("in_factorized_dense_pair_64")
    # Two generators, the same frames: the factorized one's are half.
    pair_objconv = objconv_launches("in_factorized_dense_pair_64",
                                    pair // DENORM_NORMS)
    e_pair = max(check_close(f"64x64 factorized vs dense {name}",
                             out[True][i], out[False][i], PAIR_TOL)
                 for i, name in ((0, "imgs"), (1, "flows")))
    if not torch.equal(out[True][2], out[False][2]):
        raise AssertionError("factorized vs dense conf maps differ")

    cfg, vocab, inputs, want, flat = load_reference()
    with tempfile.TemporaryDirectory() as run_dir:
        cfg.save_run_args(run_dir, vocab)
        np.savez(os.path.join(run_dir, "itr_0.npz"), **flat)
        session = GenerationSession(run_dir).load()  # on the card
    if next(session.model.parameters()).device.type != "cuda":
        raise AssertionError("the session's model is not on the card")
    denorm_ops.KERNEL_LAUNCHES.reset()
    objconv_ops.KERNEL_LAUNCHES.reset()
    imgs, boxes = session.generate(inputs)
    torch.cuda.synchronize()
    session_32 = denorm_launches(
        "per_session_generate_32",
        np.shape(inputs["imgs"])[1] - cfg.n_frames_G + 1)
    session_32_objconv = objconv_launches("per_session_generate_32")
    t = {k: torch.as_tensor(inputs[k]).cuda() for k in inputs}
    with torch.no_grad():
        got = session.model(t["imgs"], t["objs"].long(), t["triplets"].long(),
                            t["actions"], t["boxes"], test_mode=True)
    errs = {"imgs_pred": check_close("reference imgs_pred (session)",
                                     torch.from_numpy(imgs),
                                     torch.from_numpy(want["imgs_pred"]),
                                     MODEL_TOL_CPU),
            "boxes_pred": check_close("reference boxes_pred (session)",
                                      torch.from_numpy(boxes),
                                      torch.from_numpy(want["boxes_pred"]),
                                      MODEL_TOL_CPU),
            "flows_pred": check_close("reference flows_pred",
                                      got["flows_pred"].cpu(),
                                      torch.from_numpy(want["flows_pred"]),
                                      MODEL_TOL_CPU)}
    # conf is a hard threshold (err < 0.02): a pixel within rounding of it
    # may flip, so at most 0.1% of pixels may differ.
    flipped = float((got["conf_pred"].cpu().numpy() !=
                     want["conf_pred"]).mean())
    if flipped > 1e-3:
        raise AssertionError(f"reference conf_pred: {flipped:.2%} differ")
    print(f"phase 6 (a) 64x64 fp32 factorized vs dense generator, same "
          f"kernels, spectral off: max|diff| {e_pair:.3e}, conf equal; "
          f"(b) GenerationSession on the card from "
          f"torch_tools/data/reference_factorized_32.npz vs the JAX "
          f"package's outputs: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) +
          f", conf_pred {flipped:.2%} differ; denorm kernel launches "
          f"{pair} (a), {session_32} (b: 32x32, a 1x1 latent); objconv "
          f"kernel launches {pair_objconv} (a), {session_32_objconv} (b; "
          f"{cfg.compute_dtype})")


def named_leaves(trainer, attr):
    """{"model.<name>" / "disc.<name>": the parameter's `attr` on the CPU}
    (leaves whose `attr` is None left out)."""
    return {f"{m}.{k}": getattr(p, attr).detach().cpu() for m, mod in
            (("model", trainer.state.model), ("disc", trainer.state.disc))
            for k, p in mod.named_parameters()
            if getattr(p, attr) is not None}


def run_trainer(cfg, vocab, batch, graph, device=None, plain=False):
    """Two train_steps and one graph_step, inside `ops.plain()` if `plain`
    -> (losses of each step as floats, {name: parameter} after them, the
    trainer, {name: gradient} of the first train_step: the G step's in the
    model, the D step's in D, both taken at the initial weights)."""
    with ops.plain() if plain else contextlib.nullcontext():
        trainer = Trainer(cfg, vocab, device=device)
        trainer.init(batch)
        steps = []
        for i in range(2):
            steps.append({k: float(v) for k, v in
                          trainer.train_step(batch).items()})
            if i == 0:
                grads = named_leaves(trainer, "grad")
        steps.append({k: float(v) for k, v in
                      trainer.graph_step(graph).items()})
    return steps, named_leaves(trainer, "data"), trainer, grads


def compare_runs(name, got, want):
    """Losses (step 1 at STEP1_TOL, later ones at STEP2_TOL) and parameters
    (PARAM_ATOL) of two run_trainer runs -> (worst loss rel, worst param)."""
    worst_rel = 0.0
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        tol = STEP1_TOL if i == 0 else STEP2_TOL
        for k in w:
            err = abs(g[k] - w[k])
            if not np.isfinite(g[k]) or \
                    err > tol["atol"] + tol["rtol"] * abs(w[k]):
                raise AssertionError(f"{name}: step {i + 1} {k} {g[k]!r} vs "
                                     f"{w[k]!r}")
            worst_rel = max(worst_rel, err / max(abs(w[k]), 1e-12))
    worst_p = max(float((got[1][k] - w).abs().max())
                  for k, w in want[1].items())
    if worst_p > PARAM_ATOL:
        raise AssertionError(f"{name}: parameters differ by {worst_p:.3e} "
                             f"> {PARAM_ATOL:.1e} after the steps")
    return worst_rel, worst_p


def compare_grads(name, got, want, worst_bound=TRAIN_GRAD_REL_L2,
                  median_bound=TRAIN_GRAD_MEDIAN):
    """The first train_step's gradients of two run_trainer runs, per
    parameter: ||got - want|| / max(||want||, ZERO_GRAD_REL * the largest
    ||want|| of its network), the worst within `worst_bound` and the
    median within `median_bound` -> (worst, its parameter, median)."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: gradients of other parameters: "
                             f"{sorted(set(got) ^ set(want))[:4]}")
    errs = []
    for net in ("model.", "disc."):
        keys = [k for k in want if k.startswith(net)]
        floor = ZERO_GRAD_REL * max(float(want[k].double().norm())
                                    for k in keys)
        for k in keys:
            g, w = got[k].double(), want[k].double()
            if not bool(torch.isfinite(g).all() & torch.isfinite(w).all()):
                raise AssertionError(f"{name}: {k}: non-finite gradient")
            errs.append((float((g - w).norm()) / max(float(w.norm()), floor),
                         k))
    errs.sort()
    worst, median = errs[-1], errs[len(errs) // 2][0]
    if not (worst[0] <= worst_bound and median <= median_bound):
        raise AssertionError(
            f"{name}: gradients differ by {worst[0]:.3e} rel-L2 ({worst[1]};"
            f" bound {worst_bound}), median {median:.3e} (bound "
            f"{median_bound})")
    return worst[0], worst[1], median


def phase_small_trainer():
    vocab = get_vocab("cater")
    out = []
    for factorized in (True, False):
        cfg = Config(dataset="cater", factorized_frontend=factorized,
                     **TRAIN_SMALL).derive(vocab)
        B = cfg.batch_size
        batch = make_inputs(cfg, vocab, B, cfg.frames_per_action, seed=0)
        graph = make_inputs(cfg, vocab, B, 4 * cfg.frames_per_action_graph,
                            seed=1)
        cpu = run_trainer(cfg, vocab, batch, graph, device="cpu")
        KERNEL_LAUNCHES.reset()
        PLAIN_CALLS.reset()
        card = run_trainer(cfg, vocab, batch, graph)  # the card by default
        torch.cuda.synchronize()
        launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
        # Per train_step: the frozen D of the G step and the D step, and on
        # the dense frontend the generator's layouts.
        want = 2 * (2 if factorized else 3)
        if launches != want or plain != 0:
            raise AssertionError(f"small trainer: {launches} kernel launches"
                                 f" (want {want}), {plain} plain calls")
        if next(card[2].state.model.parameters()).device.type != "cuda":
            raise AssertionError("the trainer's model is not on the card")
        KERNEL_LAUNCHES.reset()
        plain_run = run_trainer(cfg, vocab, batch, graph, plain=True)
        if KERNEL_LAUNCHES.n != 0:
            raise AssertionError("the plain run launched the kernel")
        e_cpu = compare_runs("card vs CPU", card, cpu)
        e_plain = compare_runs("kernel vs plain", card, plain_run)
        g_cpu = compare_grads("card vs CPU", card[3], cpu[3])
        g_plain = compare_grads("kernel vs plain", card[3], plain_run[3])
        out.append(f"{'factorized' if factorized else 'dense'}: {launches} "
                   f"kernel launches in 2 train_steps; card vs CPU losses "
                   f"{e_cpu[0]:.2e} rel, params {e_cpu[1]:.2e}, "
                   f"{len(cpu[3])} gradients {g_cpu[0]:.2e} ({g_cpu[1]}), "
                   f"median {g_cpu[2]:.2e}; kernel vs plain losses "
                   f"{e_plain[0]:.2e} rel, params {e_plain[1]:.2e}, "
                   f"gradients {g_plain[0]:.2e} ({g_plain[1]}), median "
                   f"{g_plain[2]:.2e}")
    print("phase 8 small fp32 trainer 64x64 (2 train_steps + 1 graph_step,"
          f" losses within rtol {STEP1_TOL['rtol']:.0e} on the first step "
          f"and {STEP2_TOL['rtol']:.0e} after, params within "
          f"{PARAM_ATOL:.0e}, the first step's gradients within "
          f"{TRAIN_GRAD_REL_L2:.0e} rel-L2 per parameter and "
          f"{TRAIN_GRAD_MEDIAN:.0e} in the median): " + "; ".join(out))


def kernel_ms(fn):
    """Device kernel time (ms) of one call of `fn`, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue  # a host range drawn on the device timeline
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "device_time_total", None)
            us += float(t if t is not None else e.cuda_time_total)
    return us / 1e3


def train_iterations(trainer, batch, graph, runs):
    """2 warm-up and `runs` timed iterations (`train_step` + `graph_step`),
    the rasterizer counts read over the timed ones, then one profiled
    iteration -> {ms, peak, busy, per_step, last}. Raises on a non-finite
    loss, a skipped step, or other than 2 kernel launches and 0 plain
    calls per train_step."""
    def iteration():
        m = trainer.train_step(batch)
        m.update(trainer.graph_step(graph))
        return m

    for _ in range(2):
        iteration()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL_LAUNCHES.reset()
    PLAIN_CALLS.reset()
    metrics = []
    t0 = time.perf_counter()
    for _ in range(runs):
        metrics.append(iteration())
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / runs
    launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
    peak = torch.cuda.max_memory_allocated()
    bad = [k for m in metrics for k, v in m.items()
           if not np.isfinite(float(v))]
    if bad or trainer.skipped_nan != 0:
        raise AssertionError(f"non-finite losses {sorted(set(bad))}, "
                             f"{trainer.skipped_nan} skipped steps")
    if launches != 2 * runs or plain != 0:
        raise AssertionError(f"{launches} rasterizer kernel launches and "
                             f"{plain} plain calls in {runs} train_steps")
    busy = kernel_ms(iteration) / (1e3 * dt)
    return dict(ms=1e3 * dt, peak=peak, busy=busy, per_step=launches // runs,
                last={k: float(v) for k, v in metrics[-1].items()})


def train_full(**kw):
    """Phase 9's trainer (the Config defaults at CATER-256x256, bf16
    compute, with `kw`) and its batches -> (trainer, batch, graph, setup
    seconds)."""
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", **TRAIN_FULL, **kw).derive(vocab)
    B, T = cfg.batch_size, cfg.frames_per_action
    batch = make_inputs(cfg, vocab, B, T, seed=0)
    graph = make_inputs(cfg, vocab, B, 4 * cfg.frames_per_action_graph,
                        seed=1)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, vocab)
    trainer.init(batch)
    return trainer, batch, graph, time.perf_counter() - t0


def phase_train_full():
    trainer, batch, graph, setup_s = train_full()
    cfg = trainer.cfg
    B, T = cfg.batch_size, cfg.frames_per_action
    runs = 5
    res = train_iterations(trainer, batch, graph, runs)
    print(f"phase 9 CATER 256x256 training, default config B={B} T={T} "
          f"(graph T={4 * cfg.frames_per_action_graph}) bf16, VGG and "
          f"feature matching on: {res['ms']:.1f} ms per iteration "
          f"(train_step + graph_step, mean of {runs} after 2 warm-ups), "
          f"{B / res['ms'] * 1e3:.3f} training samples/s; device busy "
          f"{100 * res['busy']:.1f}% (one profiled iteration); rasterizer "
          f"kernel launches {res['per_step']} per train_step, plain calls "
          f"0; skipped steps 0; peak memory {res['peak'] / 2**30:.2f} GiB; "
          f"setup {setup_s:.1f} s; last losses " +
          ", ".join(f"{k} {v:.4f}" for k, v in sorted(res["last"].items())))
    return res


def running_stats(module):
    return {k: v.clone() for k, v in module.named_buffers()
            if k.endswith("running_mean") or k.endswith("running_var")}


def numpy_weights(module, seed):
    """Overwrite the tensors of `module` that its seeded init draws at
    random with numpy draws from `seed`, in state_dict order: each spectral
    `u` N(0, 1), each parameter of rank >= 2 N(0, 1 / (numel / shape[0]));
    the rest (biases, norm scales, running statistics, sigma) keeps its
    init value. torch's generator may draw other numbers under another
    torch version; these are the same on every machine."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for k, t in module.state_dict(keep_vars=True).items():
            if k.rsplit(".", 1)[-1] == "u":
                std = 1.0
            elif isinstance(t, nn.Parameter) and t.dim() >= 2:
                std = (t.shape[0] / t.numel()) ** 0.5
            else:
                continue
            t.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(t.shape)) * std).astype(
                    np.float32)))


def reference_trainer(cfg, vocab, device):
    """The trainer of the training reference file: seeded, its weights
    from `numpy_weights` (the model from cfg.seed, D from cfg.seed + 1),
    its Adams (and fp32 masters) rebuilt over them."""
    trainer = Trainer(cfg, vocab, device=device)
    trainer.init()
    numpy_weights(trainer.state.model, cfg.seed)
    numpy_weights(trainer.state.disc, cfg.seed + 1)
    reset_optimizers(trainer.state, cfg)
    return trainer


def hold_train_reference(device):
    """One `train_step` of the port on `device` at the reference file's
    configuration (reference_trainer), per param dtype, against the JAX
    package's step stored there -> {dtype: (worst loss error over
    max(|loss|, 1), norm state rel-L2)}; raises past REF_LOSS_RTOL /
    REF_STATE_REL_L2."""
    with np.load(TRAIN_REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    base = json.loads(str(ref["config"]))
    vocab = get_vocab(base["dataset"])
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config.from_dict(dict(base, param_dtype=dtype))
        batch = make_inputs(cfg, vocab, cfg.batch_size,
                            cfg.frames_per_action, seed=0)
        trainer = reference_trainer(cfg, vocab, device)
        got = {k: float(v) for k, v in trainer.train_step(batch).items()}
        loss_rel = 0.0
        for k, v in got.items():
            want = float(ref[f"{dtype}/losses/{k}"])
            if not np.isfinite(v):
                raise AssertionError(f"{dtype} params: {k} {v}")
            loss_rel = max(loss_rel, abs(v - want) / max(abs(want), 1.0))
        num = den = 0.0
        for part, module in (("model_state", trainer.state.model),
                             ("d_state", trainer.state.disc)):
            prefix = f"{dtype}/{part}/"
            want = flax_to_state_dict(unflatten_variables(
                {k[len(prefix):]: v for k, v in ref.items()
                 if k.startswith(prefix)}), transposed_keys(module))
            state = module.state_dict()
            for k, w in want.items():
                num += float(((state[k].float().cpu() - w) ** 2).sum())
                den += float((w ** 2).sum())
        state_rel = (num / den) ** 0.5
        if loss_rel > REF_LOSS_RTOL or state_rel > REF_STATE_REL_L2:
            raise AssertionError(
                f"{dtype} params vs the JAX step: losses {loss_rel:.3e} "
                f"(bound {REF_LOSS_RTOL}), norm state rel-L2 "
                f"{state_rel:.3e} (bound {REF_STATE_REL_L2})")
        out[dtype] = (loss_rel, state_rel)
    return out


def phase_modes(phase9):
    """Phase 14: phase 9's configuration in each training mode, beside
    phase 9's numbers from this run -> {mode: launches per train_step}."""
    t_phase = time.perf_counter()
    runs, per_step = 3, {}
    print(f"phase 14 training modes at phase 9's configuration ({runs} "
          f"timed iterations after 2 warm-ups each; phase 9 in this run: "
          f"{phase9['ms']:.1f} ms per iteration, peak "
          f"{phase9['peak'] / 2**30:.2f} GiB, busy "
          f"{100 * phase9['busy']:.1f}%):", flush=True)
    for name, kw in TRAIN_MODES.items():
        trainer, batch, graph, setup_s = train_full(**kw)
        st, B = trainer.state, trainer.cfg.batch_size
        if name == "flow_deconv" and not transposed_keys(st.model):
            raise AssertionError("flow_deconv built no transposed conv")
        stats0 = running_stats(st.model)
        res = train_iterations(trainer, batch, graph, runs)
        extra = ""
        if name == "bp_prev":
            stats1 = running_stats(st.model)
            moved = sum(not torch.equal(v, stats1[k])
                        for k, v in stats0.items())
            if not moved:
                raise AssertionError("bp_prev: no BN statistic moved")
            extra = f", {moved} of {len(stats0)} BN statistics moved"
        if name == "bf16_params":
            if any(p.dtype != torch.bfloat16 for m in (st.model, st.disc)
                   for p in m.parameters()):
                raise AssertionError("a parameter is not bf16")
            n = 0
            for opt in (st.opt_graph, st.opt_gen, st.opt_d):
                for p, m in zip(opt.live, opt.masters):
                    if not torch.equal(p, m.to(torch.bfloat16)):
                        raise AssertionError("live != bf16(master)")
                    n += 1
            extra = f", live == bf16(master) in all {n} parameters"
        per_step[name] = res["per_step"]
        print(f"phase 14 {name}: {res['ms']:.1f} ms per iteration, "
              f"{B / res['ms'] * 1e3:.3f} training samples/s, peak "
              f"{res['peak'] / 2**30:.2f} GiB, busy "
              f"{100 * res['busy']:.1f}%, {res['per_step']} kernel launches"
              f" per train_step, 0 plain calls, skipped steps 0, setup "
              f"{setup_s:.1f} s, G/total_loss "
              f"{res['last']['G/total_loss']:.4f}{extra}", flush=True)
        del trainer, st
        torch.cuda.empty_cache()
    ref = hold_train_reference("cuda")
    print("phase 14 against the JAX package's bf16 step (64x64, "
          "reference_train_bf16_64.npz): " + ", ".join(
              f"{d} params losses {a:.2e}, norm state {b:.2e} rel-L2"
              for d, (a, b) in ref.items())
          + f" (bounds {REF_LOSS_RTOL}, {REF_STATE_REL_L2}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return per_step


def finite_tree(where, node):
    """Raise unless every number in the nested dict / list is finite."""
    if isinstance(node, dict):
        for k, v in node.items():
            finite_tree(f"{where}/{k}", v)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            finite_tree(f"{where}[{i}]", v)
    elif isinstance(node, (int, float)) and not np.isfinite(node):
        raise AssertionError(f"{where}: {node}")


def phase_backbone_iou(run_dir, tmp):
    """Phase 15: scripts.train_backbone and scripts.eval_iou (all three
    modes, on phase 10's run directory)."""
    t_phase = time.perf_counter()
    KERNEL_LAUNCHES.reset()
    PLAIN_CALLS.reset()
    out = os.path.join(tmp, "backbone.npz")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        result = train_backbone_main(BACKBONE_ARGS + ["--out", out])
    bb_s = time.perf_counter() - t0
    if json.loads(buf.getvalue().strip().splitlines()[-1]) != \
            json.loads(json.dumps(result)):
        raise AssertionError("train_backbone printed another result")
    params, meta = load_backbone(out)
    hist = meta["history"]
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"backbone loss {hist[0]['loss']} -> "
                             f"{hist[-1]['loss']}")
    score = FidelityScore(params)  # the card
    g = torch.Generator().manual_seed(0)
    score.add_fake(torch.randn(8, 256, 256, 3, generator=g).cuda(),
                   presence=np.zeros((8, 18), np.float32))
    score.add_real(torch.randn(8, 256, 256, 3, generator=g).cuda())
    finite_tree("FidelityScore", score.compute())
    iou, iou_s = {}, {}
    for sweep in (None, "composition", "horizon"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            iou[sweep] = eval_iou_main(["--checkpoint", run_dir] + (
                ["--sweep", sweep] if sweep else []))
        iou_s[sweep] = time.perf_counter() - t0
        finite_tree(f"eval_iou {sweep}", iou[sweep])
    if KERNEL_LAUNCHES.n or PLAIN_CALLS.n:
        raise AssertionError(f"{KERNEL_LAUNCHES.n} kernel launches, "
                             f"{PLAIN_CALLS.n} plain calls")
    plain, comp, hor = iou[None], iou["composition"], iou["horizon"]
    print(f"phase 15 train_backbone ({' '.join(BACKBONE_ARGS)}; "
          f"{bb_s:.1f} s): loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}, held-out 128->64 presence "
          f"{result['acc_direct64']['presence_acc']:.4f} grid "
          f"{result['acc_direct64']['grid_acc']:.4f}, 256->64 presence "
          f"{result['acc_runres_resize64']['presence_acc']:.4f} grid "
          f"{result['acc_runres_resize64']['grid_acc']:.4f}, loaded by "
          f"FidelityScore on the card; eval_iou on phase 10's run "
          f"({plain['n_videos']} videos): model avg_iou "
          f"{plain['model']['avg_iou']:.4f}, rule "
          f"{plain['rule']['avg_iou']:.4f} ({iou_s[None]:.1f} s); "
          f"composition original/model_vs_expected "
          f"{comp['original/model_vs_expected']['avg_iou']:.4f}, "
          f"rule_vs_gt {comp['original/rule_vs_gt']['avg_iou']:.4f} "
          f"({iou_s['composition']:.1f} s); horizon hold_4x "
          f"{hor['hold_4x']['avg_iou']:.4f}, slowmo_4x "
          f"{hor['slowmo_4x']['avg_iou']:.4f} ({iou_s['horizon']:.1f} s); "
          f"all finite; rasterizer launches 0, plain calls 0; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def timed_method(cls, name, seconds):
    """Append the seconds of every call of `cls.name` to `seconds`."""
    orig = getattr(cls, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)

    setattr(cls, name, timed)
    try:
        yield seconds
    finally:
        setattr(cls, name, orig)


def read_metrics(run_dir):
    """metrics.jsonl -> {step: merged record}."""
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["step"], {}).update(rec)
    return out


def check_finite(where, rec, keys):
    for k in keys:
        if k not in rec or not np.isfinite(rec[k]):
            raise AssertionError(f"{where}: {k} = {rec.get(k)!r}")


def module_state(trainer):
    """Every parameter and buffer of the trainer's models, by name."""
    st = trainer.state
    return {f"{m}.{k}": v for m, mod in (("model", st.model),
                                         ("disc", st.disc), ("vgg", st.vgg))
            if mod is not None for k, v in mod.state_dict().items()}


def check_restored(live, fresh):
    """The restored trainer equals the live one exactly: every tensor, every
    Adam moment and count, step and skipped_nan -> number of tensors."""
    a, b = module_state(live), module_state(fresh)
    if set(a) != set(b):
        raise AssertionError(f"restored keys differ: {sorted(set(a) ^ set(b))[:5]}")
    for k, v in a.items():
        if not torch.equal(v, b[k]):
            raise AssertionError(f"restored {k} differs")
    n = len(a)
    for name in ckpt_lib.OPTIMIZERS:
        lo, fo = getattr(live.state, name), getattr(fresh.state, name)
        if lo.count != fo.count:
            raise AssertionError(f"{name} count {fo.count} vs {lo.count}")
        lp = [p for g in lo.param_groups for p in g["params"]]
        fp = [p for g in fo.param_groups for p in g["params"]]
        for p, q in zip(lp, fp):
            for k, v in lo.state[p].items():
                if not torch.equal(v, fo.state[q][k]):
                    raise AssertionError(f"{name} state {k} differs")
                n += 1
    for k in ("step", "epoch", "skipped_nan"):
        if getattr(live.state, k) != getattr(fresh.state, k):
            raise AssertionError(f"restored {k} differs")
    return n


LOOP_ROUNDS, LOOP_ITERS = 3, 6


class LastRecord:
    """A metrics writer that keeps the last record it was given."""

    def write(self, step, scalars):
        self.last = scalars


def loop_cost(trainer, batch):
    """What the loop adds to the step, timed in turns on `trainer`: fixed
    batches (phase 9's measure) against `fit` over the training loaders
    with no output_dir and no validation loader, so no save and no
    validation pass (the loaders' threads, the upload, one log step) ->
    {"fixed", "fit"}: median ms per iteration."""
    from ag2video_torch.data.registry import Loader, get_dataset

    cfg = trainer.cfg
    train = Loader(get_dataset("synthetic", "train", cfg), cfg)
    graph = Loader(get_dataset("synthetic", "train_graph", cfg), cfg)
    gbatch = next(graph.epoch(0))

    def fixed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LOOP_ITERS):
            trainer.train_step(batch)
            trainer.graph_step(gbatch)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / LOOP_ITERS

    def fit():
        # One log step, at the end: the StepTimer mean of its intervals.
        end, out = int(trainer.state.step) + LOOP_ITERS, LastRecord()
        trainer.fit(train, graph, None, num_iterations=end, log_every=end,
                    metrics_writer=out, timing=True)
        torch.cuda.synchronize()
        return out.last["step_ms_mean"]

    times = {"fixed": [], "fit": []}
    trainer.cfg = cfg.replace(output_dir="")
    try:
        for r in range(LOOP_ROUNDS):
            for name in (("fixed", "fit") if r % 2 == 0 else ("fit", "fixed")):
                times[name].append({"fixed": fixed, "fit": fit}[name]())
    finally:
        trainer.cfg = cfg
    return {k: statistics.median(v) for k, v in times.items()}


def phase_fit(phase9_ms, out):
    """Phase 10, writing its run directory to `out` (phase 12 reads it) ->
    {"launches": per train_step, "mean", "p50": fit's ms per iteration,
    "loader_ms": {partition: ms per batch}}."""
    from ag2video_torch.data.registry import Loader, get_dataset

    iters, every = 6, 3
    val_s = []
    with timed_method(Trainer, "check_model", val_s):
        del ckpt_lib.SAVE_TIMES[:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        KERNEL_LAUNCHES.reset()
        PLAIN_CALLS.reset()
        denorm_ops.KERNEL_LAUNCHES.reset()
        objconv_ops.KERNEL_LAUNCHES.reset()
        t0 = time.perf_counter()
        gifs = {}
        with recorded_gifs(gifs):  # phase 12 decodes them
            trainer = train_main(FIT_ARGS + ["--output_dir", out])
        torch.cuda.synchronize()
        # train_step runs the eager ops (train=True); the validation
        # passes launch the kernels.
        denorm_launches("in_fit_validation")
        objconv_launches("in_fit_validation")
        run_s = time.perf_counter() - t0
        launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
        peak = torch.cuda.max_memory_allocated()
        cfg, vocab = trainer.cfg, trainer.vocab
        if next(trainer.state.model.parameters()).device.type != "cuda":
            raise AssertionError("the CLI's trainer is not on the card")
        if launches != 2 * iters or plain != 0:
            raise AssertionError(f"fit: {launches} rasterizer kernel launches "
                                 f"and {plain} plain calls in {iters} "
                                 f"train_steps")

        # The metrics stream: losses at t=3 and 6, validation at t=0 and 3.
        recs = read_metrics(out)
        losses = ("G/total_loss", "D/total_img_loss", "Graph/total_loss")
        for t in (every, iters):
            check_finite(f"t={t}", recs.get(t, {}),
                         losses + ("step_ms_mean", "step_ms_p50",
                                   "skipped_nan"))
            if recs[t]["skipped_nan"] != 0:
                raise AssertionError(f"t={t}: skipped steps")
        val_keys = ("no_use_gt/avg_iou", "use_gt/fidelity_fid",
                    "use_gt/fidelity_presence_acc")
        for t in (0, every):
            check_finite(f"validation t={t}", recs.get(t, {}), val_keys)
        if len(val_s) != 4:
            raise AssertionError(f"{len(val_s)} validation passes, want 4")

        # The run directory: itr_0 full, itr_3 light, itr_6 full.
        for t, light in ((0, False), (every, True), (iters, False)):
            path = ckpt_lib.checkpoint_path(out, t)
            if not ckpt_lib.is_port_checkpoint(path) or \
                    ckpt_lib.is_light_checkpoint(path) != light:
                raise AssertionError(f"itr_{t}: want a "
                                     f"{'light' if light else 'full'} "
                                     f"checkpoint")
        for name in ("run_args.json", "counters.json"):
            if not os.path.isfile(os.path.join(out, name)):
                raise AssertionError(f"no {name} in the run directory")
        if not glob.glob(os.path.join(out, "events.out.tfevents.*")):
            raise AssertionError("no TensorBoard event file")
        if ckpt_lib.latest_checkpoint(out) != ckpt_lib.checkpoint_path(
                out, iters):
            raise AssertionError("the newest checkpoint is not itr_6")

        # The run's session renders what the live trainer renders.
        val_batch = next(Loader(get_dataset("synthetic", "val", cfg), cfg,
                                shuffle=False).epoch(0))
        session = GenerationSession(out).load()  # on the card
        s_imgs, s_boxes = session.generate(val_batch)
        l_imgs, l_boxes, _ = trainer.eval_batch(val_batch, use_gt=False)
        e_sess = max(
            check_close("session vs live imgs_pred", torch.from_numpy(s_imgs),
                        l_imgs.float().cpu(), SESSION_TOL),
            check_close("session vs live boxes_pred (clipped as the val "
                        "pass clips them)",
                        torch.from_numpy(s_boxes).clamp(0.0, 1.0),
                        l_boxes.float().cpu(), SESSION_TOL))
        del session

        # itr_6 into a fresh trainer: equal exactly, then the same step.
        fresh = Trainer(cfg, vocab, device=trainer.device)
        fresh.init(val_batch)
        fresh.restore_checkpoint(out)
        n_equal = check_restored(trainer, fresh)
        # The host's data rate alone: batches of the training loaders, each
        # epoch's two threads rendering and collating.
        synthetic_loader_ms = loader_ms("synthetic", cfg, iters)
        # An async full save of the live state with its Adam moments (the
        # in-loop full save at t=0 has none yet), written while the next
        # steps run.
        trainer.save_checkpoint(out, iters + 1, 0, block=False)
        batch = next(Loader(get_dataset("synthetic", "train", cfg), cfg,
                            shuffle=False).epoch(0))
        ml = {k: float(v) for k, v in trainer.train_step(batch).items()}
        mf = {k: float(v) for k, v in fresh.train_step(batch).items()}
        worst = 0.0
        for k, v in ml.items():
            err = abs(mf[k] - v)
            if not np.isfinite(mf[k]) or \
                    err > STEP1_TOL["atol"] + STEP1_TOL["rtol"] * abs(v):
                raise AssertionError(f"restored step: {k} {mf[k]!r} vs {v!r}")
            worst = max(worst, err / max(abs(v), 1e-12))
        ckpt_lib.wait_for_saves()
        del fresh
        loop = loop_cost(trainer, batch)

    B = cfg.batch_size
    # StepTimer ticks after each iteration, so at t=6 its mean is the window
    # from t=1 to t=6, the t=3 save and both validation passes included; its
    # p50 is the steady step without them.
    mean, p50 = recs[iters]["step_ms_mean"], recs[iters]["step_ms_p50"]
    saves = {os.path.basename(r["path"]): r for r in ckpt_lib.SAVE_TIMES}
    first, light, full_sync, full_async = (saves[f"itr_{t}"] for t in (
        0, every, iters, iters + 1))

    def save_line(r):
        return (f"{r['bytes'] / 2**30:.3f} GiB, fetch {r['fetch_s']:.2f} s "
                f"+ write {r['write_s']:.2f} s")

    H, W = cfg.image_size
    print(f"phase 10 training run (scripts.train main, synthetic {H}x{W}, "
          f"Config defaults B={B} T={cfg.frames_per_action} graph "
          f"T={4 * cfg.frames_per_action_graph} {cfg.compute_dtype}, "
          f"{iters} iterations; the discriminator rasterizes N="
          f"{B * (cfg.frames_per_action - 1)} O={cfg.max_objects} "
          f"D={2 * cfg.gconv_dim}): fit {mean:.1f} ms per iteration over "
          f"t=1..{iters} (StepTimer mean: data, logging, the t={every} save "
          f"and both validation passes included; p50 {p50:.1f} ms) against "
          f"phase 9's {phase9_ms:.1f} ms; {B / mean * 1e3:.3f} training "
          f"samples/s; in turns on this trainer ({LOOP_ROUNDS} rounds of "
          f"{LOOP_ITERS}, medians): fixed batches {loop['fixed']:.1f} ms, fit "
          f"over the loaders with no save and no validation "
          f"{loop['fit']:.1f} ms ({loop['fit'] / loop['fixed']:.3f}x); "
          f"whole CLI run {run_s:.1f} s; peak memory {peak / 2**30:.2f} GiB; "
          f"rasterizer kernel launches {launches // iters} per train_step, "
          f"plain calls {plain}; skipped steps 0; validation passes "
          f"(use_gt, no_use_gt at t=0, 3) "
          + ", ".join(f"{s:.2f}" for s in val_s) + " s; t=3 avg_iou "
          f"{recs[every]['no_use_gt/avg_iou']:.4f}, fidelity_fid "
          f"{recs[every]['use_gt/fidelity_fid']:.3f}, presence_acc "
          f"{recs[every]['use_gt/fidelity_presence_acc']:.4f}; saves: "
          f"full sync (itr_{iters}) {save_line(full_sync)}, full async "
          f"(itr_{iters + 1}, after the loop) {save_line(full_async)}, "
          f"light async (itr_{every}) {save_line(light)}, full async at "
          f"t=0 (no Adam moments yet) {save_line(first)}; the loaders "
          f"alone {synthetic_loader_ms['train']:.1f} ms per train batch, "
          f"{synthetic_loader_ms['train_graph']:.1f} ms per graph batch; "
          f"itr_{iters} restored exactly "
          f"({n_equal} tensors), next step losses within {worst:.2e} rel; "
          f"session vs live frames {e_sess:.3e}")
    return {"launches": launches // iters, "mean": mean, "p50": p50,
            "loader_ms": synthetic_loader_ms, "gifs": gifs}


def tree_state(root):
    """{path: mtime} of every file under root."""
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, files in os.walk(root) for f in files}


def loader_ms(dataset, cfg, batches):
    """ms per batch of the training loaders alone, over `batches` batches
    (across epochs, as `fit` takes them) -> {partition: ms}."""
    from ag2video_torch.data.registry import Loader, get_dataset

    out = {}
    for part in ("train", "train_graph"):
        it = Loader(get_dataset(dataset, part, cfg), cfg).forever()
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        out[part] = 1e3 * (time.perf_counter() - t0) / batches
    return out


def phase_cater(tmp, fit):
    """Phase 11 on a CATER tree fabricated under `tmp`, beside phase 10's
    figures `fit` -> rasterizer launches per train_step."""
    t_phase = time.perf_counter()
    iters, every = 4, 2
    t0 = time.perf_counter()
    root, splits, names = make_tree(os.path.join(tmp, "cater"),
                                    CATER_VIDEOS, nframes=301,
                                    n_objects=CATER_OBJECTS)
    fabricate_s = time.perf_counter() - t0
    saved = {k: os.environ.get(k) for k in CATER_ENV}
    os.environ["CATER_DATA_ROOT"], os.environ["CATER_SPLITS_DIR"] = root, \
        splits
    os.environ.pop("CATER_NFRAMES", None)   # the default, 301
    out = os.path.join(tmp, "cater_run")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        KERNEL_LAUNCHES.reset()
        PLAIN_CALLS.reset()
        t0 = time.perf_counter()
        trainer = train_main(CATER_ARGS + ["--output_dir", out])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
        peak = torch.cuda.max_memory_allocated()
        cfg = trainer.cfg
        if next(trainer.state.model.parameters()).device.type != "cuda":
            raise AssertionError("the CLI's trainer is not on the card")
        if launches != 2 * iters or plain != 0:
            raise AssertionError(f"CATER fit: {launches} rasterizer kernel "
                                 f"launches and {plain} plain calls in "
                                 f"{iters} train_steps")
        if trainer.skipped_nan != 0:
            raise AssertionError(f"{trainer.skipped_nan} skipped steps")
        recs = read_metrics(out)
        losses = ("G/total_loss", "D/total_img_loss", "Graph/total_loss")
        for t in (every, iters):
            check_finite(f"CATER t={t}", recs.get(t, {}),
                         losses + ("step_ms_mean", "step_ms_p50",
                                   "skipped_nan"))
            if recs[t]["skipped_nan"] != 0:
                raise AssertionError(f"CATER t={t}: skipped steps")
        for t in (0, every):
            check_finite(f"CATER validation t={t}", recs.get(t, {}),
                         ("no_use_gt/avg_iou",))
        for t in (0, every, iters):
            if not ckpt_lib.is_port_checkpoint(
                    ckpt_lib.checkpoint_path(out, t)):
                raise AssertionError(f"CATER run: no itr_{t}")
        del trainer

        # The cache is complete: the pre-warmer decodes nothing.
        before = tree_state(root)
        if train_main(CATER_ARGS + ["--output_dir", out,
                                    "--cache_data", "1"]) is not None:
            raise AssertionError("--cache_data 1 trained")
        if tree_state(root) != before:
            raise AssertionError("--cache_data 1 changed the frame cache")

        cater_loader_ms = loader_ms("cater", cfg, 6)
        frames = sorted(glob.glob(os.path.join(root, "videos", names[0],
                                               "*.png")))[:60]
        t0 = time.perf_counter()
        decoded = [read_png(p) for p in frames]
        png_ms = 1e3 * (time.perf_counter() - t0) / len(frames)
        clips = [decoded[i:i + cfg.frames_per_action]
                 for i in range(0, 40, cfg.frames_per_action)]
        t0 = time.perf_counter()
        for clip in clips:
            clip_transform(clip, cfg.image_size)
        clip_ms = 1e3 * (time.perf_counter() - t0) / len(clips)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    B, H, W = cfg.batch_size, *cfg.image_size
    mean, p50 = recs[iters]["step_ms_mean"], recs[iters]["step_ms_p50"]
    print(f"phase 11 CATER training run (scripts.train main, --dataset "
          f"cater {H}x{W}, Config defaults B={B} T={cfg.frames_per_action} "
          f"graph T={4 * cfg.frames_per_action_graph} {cfg.compute_dtype}, "
          f"{iters} iterations, saves at 0/{every}/{iters}, validation on "
          f"{cfg.num_val_samples} clips; {CATER_VIDEOS} fabricated videos "
          f"of 301 {decoded[0].shape[1]}x{decoded[0].shape[0]} PNG frames, "
          f"{CATER_OBJECTS} objects, written in {fabricate_s:.1f} s): fit "
          f"{mean:.1f} ms per iteration over t=1..{iters} (StepTimer mean, "
          f"the t={every} save and validation included; p50 {p50:.1f} ms) "
          f"against phase 10's synthetic {fit['mean']:.1f} ms (p50 "
          f"{fit['p50']:.1f} ms); {B / mean * 1e3:.3f} training samples/s; "
          f"rasterizer kernel launches {launches // iters} per train_step, "
          f"plain calls {plain}; skipped steps 0; t={every} losses "
          + ", ".join(f"{k} {recs[every][k]:.4f}" for k in losses)
          + f", avg_iou {recs[every]['no_use_gt/avg_iou']:.4f}; the CATER "
          f"loaders alone {cater_loader_ms['train']:.1f} ms per train batch, "
          f"{cater_loader_ms['train_graph']:.1f} ms per graph batch, "
          f"against the synthetic loaders' {fit['loader_ms']['train']:.1f} / "
          f"{fit['loader_ms']['train_graph']:.1f} ms; read_png "
          f"{png_ms:.3f} ms per frame; clip_transform {clip_ms:.3f} ms per "
          f"{cfg.frames_per_action}-frame clip to {H}x{W}; --cache_data 1 "
          f"returned and left the cache as it was; whole CLI run "
          f"{run_s:.1f} s; peak memory {peak / 2**30:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches // iters


GIF_WRITES = []   # (ms, bytes, pixels) of each GIF recorded_gifs saw


@contextlib.contextmanager
def recorded_gifs(record):
    """Every GIF the port writes in the block (`utils.vis.save_gif`) also
    puts {path: the frames quantized by the encoder's palette} in
    `record`, and its write's ms, bytes and pixels in GIF_WRITES."""
    write = vis_lib.write_gif

    def recording(path, frames, fps=4):
        record[os.path.abspath(path)] = gif_lib.quantize_frames(frames)
        t0 = time.perf_counter()
        out = write(path, frames, fps)
        GIF_WRITES.append(((time.perf_counter() - t0) * 1e3,
                           os.path.getsize(path),
                           record[os.path.abspath(path)].size // 3))
        return out

    vis_lib.write_gif = recording
    try:
        yield record
    finally:
        vis_lib.write_gif = write


def gif_line():
    """The GIF writes so far: ms and bytes a write, bytes a pixel."""
    ms, size, px = (np.array(c, float) for c in zip(*GIF_WRITES))
    return (f"{np.median(ms):.1f} ms median, {ms.min():.1f}-{ms.max():.1f}, "
            f"{np.median(size) / 1e3:.1f} kB median, "
            f"{size.sum() / px.sum():.3f} bytes a pixel")


def check_gifs(record, roots):
    """Every GIF under `roots` was recorded, and PIL decodes each to exactly
    its recorded frames -> the number checked."""
    from PIL import Image

    found = {os.path.abspath(p) for r in roots
             for p in glob.glob(os.path.join(r, "**", "*.gif"),
                                recursive=True)}
    if found != set(record):
        raise AssertionError(f"GIFs on disk and written differ: "
                             f"{sorted(found ^ set(record))[:4]}")
    for path, want in record.items():
        with Image.open(path) as im:
            frames = []
            for i in range(im.n_frames):
                im.seek(i)
                frames.append(np.asarray(im.convert("RGB")))
        if not np.array_equal(np.stack(frames), want):
            raise AssertionError(f"{path}: PIL decodes other frames than "
                                 f"the encoder's")
    return len(record)


def check_sigma_audit(run_dir, device=None):
    """torch_tools/sigma_audit.py on the run's newest checkpoint (on the
    card by default): every SpectralWeight the checkpoint holds audited,
    every value finite -> (checkpoint name, G rows, D rows, its printed
    lines)."""
    itr = ckpt_lib.latest_checkpoint(run_dir)
    data = ckpt_lib.load_state_file(itr)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        g, d = sigma_audit.audit(itr, device)
    for name, rows, net in (("G", g, "model"), ("D", d, "disc")):
        want = sorted(k for k in data[net] if k.endswith(".spectral.sigma"))
        got = sorted(".".join(p.split("/")[:-2]) + ".spectral.sigma"
                     for p, _, _ in rows)
        if got != want or not all(np.isfinite([h, t]).all()
                                  for _, h, t in rows):
            raise AssertionError(f"sigma audit {name}: {len(got)} kernels "
                                 f"of {len(want)}, or non-finite values")
    return os.path.basename(itr), g, d, buf.getvalue()


def check_tfevents_export(run_dir, tmp):
    """torch_tools/jsonl_to_tfevents.py on a copy of the run's
    metrics.jsonl: the records read back equal the rows (the numeric
    columns but step and time, at the row's step and time, in float32);
    a second conversion skips -> the number of records."""
    out = os.path.join(tmp, "tfevents_export")
    os.makedirs(out)
    src = os.path.join(run_dir, "metrics.jsonl")
    with open(src) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    with open(os.path.join(out, "metrics.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    with contextlib.redirect_stdout(io.StringIO()):
        path = jsonl_to_tfevents.convert(out)
        if jsonl_to_tfevents.convert(out) != path or \
                len(glob.glob(os.path.join(out, "events.*"))) != 1:
            raise AssertionError("a second conversion did not skip")
    want = [(int(r["step"]), float(r["time"]), k, float(np.float32(v)))
            for r in rows for k, v in r.items()
            if k not in ("step", "time") and isinstance(v, (int, float))
            and not isinstance(v, bool)]
    got = jsonl_to_tfevents.read_events(path)
    same = len(got) == len(want) and all(
        g[:3] == w[:3] and (g[3] == w[3] or (np.isnan(g[3])
                                             and np.isnan(w[3])))
        for g, w in zip(got, want))
    if not same:
        raise AssertionError(f"tfevents export: {len(got)} records, "
                             f"{len(want)} rows: {got[:3]} vs {want[:3]}")
    return len(got)


def phase_clis(run_dir, tmp, fit_gifs):
    """Phase 12: the generate, eval_fidelity and summarize_metrics CLIs,
    the sigma audit and the tfevents export on phase 10's run directory,
    and every GIF of the generate CLI and of phase 10's validation passes
    (`fit_gifs`, recorded by `recorded_gifs`) decoded."""
    from ag2video_torch.data.registry import Loader, get_dataset

    t_phase = time.perf_counter()
    gen_gifs = {}
    denorm_ops.KERNEL_LAUNCHES.reset()
    objconv_ops.KERNEL_LAUNCHES.reset()
    with recorded_gifs(gen_gifs):
        results = generate_main(["--checkpoint", run_dir, "--num_videos", "2",
                             "--output_dir", os.path.join(tmp, "generated")])
    torch.cuda.synchronize()
    denorm_launches("in_generate_cli")
    objconv_launches("in_generate_cli")
    pkls = sorted(glob.glob(os.path.join(results, "test", "*.pkl")))
    cfg, _ = Config.load_run_args(run_dir)
    # validation GIFs: 4 for each video of the pass's first batch
    n_val_gifs = 4 * min(4, cfg.batch_size)
    cfg = cfg.replace(batch_size=1)
    first = next(Loader(get_dataset(cfg.dataset, "test", cfg), cfg,
                        batch_size=1, shuffle=False,
                        drop_last=False).epoch(0))
    want_shape = (cfg.frames_per_action, *cfg.image_size, 3)
    if len(pkls) != 2:
        raise AssertionError(f"generate wrote {len(pkls)} pkls, want 2")
    for path in pkls:
        with open(path, "rb") as f:
            image = pickle.load(f)["image"]
        if image.shape != want_shape or not np.isfinite(image).all():
            raise AssertionError(f"{path}: image {image.shape}, finite "
                                 f"{np.isfinite(image).all()}")
    with open(os.path.join(results, "test", f"{first.video_ids[0]}.pkl"),
              "rb") as f:
        image = pickle.load(f)["image"]
    session = GenerationSession(run_dir,
                                overrides={"batch_size": 1}).load()
    want, _ = session.generate(first, use_gt=True)
    del session
    e_gen = check_close("generate's pkl vs the session", torch.from_numpy(
        image), torch.from_numpy(want[0]), SESSION_TOL)
    n_gen = check_gifs(gen_gifs, [results])
    n_fit = check_gifs(fit_gifs, [os.path.join(run_dir, "gt_val"),
                                  os.path.join(run_dir, "val")])
    # Each validation pass (use_gt, no_use_gt) at t=0 and t=3; the test
    # GIFs and, per action builder (converge, swap), 4 sweep GIFs.
    if n_fit != n_val_gifs * 2 * 2 or n_gen != len(pkls) + 4 * 2:
        raise AssertionError(f"{n_gen} generate GIFs, {n_fit} validation "
                             f"GIFs")
    t0 = time.perf_counter()
    itr, g_rows, d_rows, audit_lines = check_sigma_audit(run_dir)
    audit_s = time.perf_counter() - t0
    errs = sigma_audit.rel_errors(g_rows + d_rows)
    n_events = check_tfevents_export(run_dir, tmp)

    fid_out = os.path.join(tmp, "new_dir", "fidelity.json")
    if os.path.exists(os.path.dirname(fid_out)):
        raise AssertionError("the output's directory exists beforehand")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fid = eval_fidelity_main(["--run_dir", run_dir, "--checkpoints",
                                  "all", "--num_samples", "6", "--out",
                                  fid_out])
    fid_s = time.perf_counter() - t0
    with open(fid_out) as f:
        if json.load(f) != json.loads(json.dumps(fid)):
            raise AssertionError("fidelity.json differs from the results")
    rows = {r["step"]: r for r in fid["checkpoints"]}
    for t in (0, 3, 6):
        check_finite(f"fidelity itr_{t}", rows.get(t, {}),
                     ("fidelity_fid", "fidelity_presence_acc"))
    rr, nz = (fid["controls"][k]["fidelity_fid"]
              for k in ("real_vs_real", "noise_vs_real"))
    if not rr < nz:
        raise AssertionError(f"real-vs-real {rr} not under noise-vs-real "
                             f"{nz}")

    with contextlib.redirect_stdout(io.StringIO()) as buf:
        summary = summarize_main([run_dir])
    if json.loads(buf.getvalue()) != summary:
        raise AssertionError("summarize_metrics printed another summary")
    keys = ("G/total_loss", "D/total_img_loss", "Graph/total_loss")
    for k in keys:
        if not summary.get(k) or not all(np.isfinite(v)
                                         for v in summary[k].values()):
            raise AssertionError(f"summarize_metrics: {k} {summary.get(k)}")
    print(f"phase 12 sigma audit of {itr} (torch_tools/sigma_audit.py, "
          f"{audit_s:.1f} s): " + " | ".join(
              ln.strip() for ln in audit_lines.splitlines()
              if ln.startswith(("G:", "D:", "ALL:"))))
    print(f"phase 12 CLIs on phase 10's run: generate wrote {len(pkls)} "
          f"pkls of {want_shape} finite frames, the first within "
          f"{e_gen:.3e} of the session's use_gt frames; GIFs written and "
          f"decoded by PIL to the encoder's frames exactly: {n_gen} of "
          f"generate, {n_fit} of fit's validation, 0 skipped (each write "
          f"{gif_line()}); sigma audit "
          f"of {itr}: {len(g_rows)} + {len(d_rows)} SpectralWeights, rel "
          f"err mean {np.mean(errs):.2%} max {np.max(errs):.2%}, all "
          f"finite; tfevents export of metrics.jsonl: {n_events} records "
          f"equal to its rows, a second conversion skipped;"
          f" eval_fidelity ({fid_s:.1f} s) FID " + ", ".join(
              f"itr_{t} {r['fidelity_fid']:.3f}"
              for t, r in sorted(rows.items()))
          + f", real-vs-real {rr:.3f} < noise-vs-real {nz:.3f}, written to "
          f"a new directory; summarize_metrics " + ", ".join(
              f"{k} " + "/".join(f"{v:.4f}" for v in summary[k].values())
              for k in keys) + f"; phase {time.perf_counter() - t_phase:.1f} s")


# Phase 13: the networks at the shapes scripts.evaluate gives them, fp32.
EVAL_NETS = ("inception", "lpips_alex", "tsm", "resnext3d")
EVAL_B = 8
EVAL_CLIP = (16, 112, 112)   # VideoFeatureExtractor's frames and size
EVAL_REL_L2 = 1e-4           # card against CPU, TF32 off
# Clips per directory (renders of phase 10's run): PRD's 20 clusters need
# points; 14 batches of the run's B=3.
EVAL_BATCHES = 14


def eval_net(net, path, device):
    """(forward on seeded inputs -> one flat tensor, what one call counts
    as images or clips) of `net` from its asset at `path` on `device`."""
    g = torch.Generator().manual_seed(13)
    if net == "inception":
        model, random_init = inception_v3(load_inception_params(path),
                                          device)
        x = torch.randn(EVAL_B, 299, 299, 3, generator=g).to(device)
        fn = lambda: torch.cat(model(x), -1)  # noqa: E731
    elif net == "lpips_alex":
        lp = LPIPS(path, device=device)
        random_init = lp.random_init
        x, y = (torch.rand(EVAL_B, 64, 64, 3, generator=g).to(device) * 2 - 1
                for _ in range(2))
        fn = lambda: lp.distance(x, y)  # noqa: E731
    else:
        backbone = "tsm" if net == "tsm" else "resnext"
        model, random_init = load_variables(
            BACKBONES[backbone](), load_backbone_params(backbone, path),
            device)
        x = torch.rand(EVAL_B, *EVAL_CLIP, 3, generator=g).to(device)
        fn = lambda: model(x)  # noqa: E731
    if random_init:
        raise AssertionError(f"{net}: the asset was not loaded")

    def run():
        with torch.no_grad():
            return fn().reshape(-1)
    return run


def time_card(fn, reps=5):
    """(ms per call on the card, host clock around synchronised calls after
    a warm-up call; peak memory over the timed calls)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (1e3 * (time.perf_counter() - t0) / reps,
            torch.cuda.max_memory_allocated())


def render_clips(run_dir, t, out, cfg, vocab):
    """The session of phase 10's itr_<t> renders EVAL_BATCHES seeded batches
    into out/clips/<i>.pkl, and each clip's last frame into
    out/frames/<i>.png -> (clips dir, frames dir)."""
    session = GenerationSession(
        run_dir, checkpoint=ckpt_lib.checkpoint_path(run_dir, t)).load()
    clips, frames = os.path.join(out, "clips"), os.path.join(out, "frames")
    os.makedirs(frames)
    n = 0
    for seed in range(EVAL_BATCHES):
        batch = make_inputs(cfg, vocab, cfg.batch_size,
                            cfg.frames_per_action, seed=100 + seed)
        imgs, boxes = session.generate(batch)
        for video, box in zip(imgs, boxes):
            save_video_pickle(os.path.join(clips, f"{n:03d}.pkl"), video, box)
            write_png(os.path.join(frames, f"{n:03d}.png"),
                      np.round(denormalize(video[-1]) * 255).astype(np.uint8))
            n += 1
    del session
    return clips, frames


def phase_eval(run_dir, tmp):
    """Phase 13 on phase 10's run directory."""
    from ag2video_torch.data.registry import Loader, get_dataset

    t_phase = time.perf_counter()
    assets = write_assets(os.path.join(tmp, "eval_assets"), seed=0,
                          nets=EVAL_NETS)
    asset_s = time.perf_counter() - t_phase
    KERNEL_LAUNCHES.reset()
    PLAIN_CALLS.reset()
    denorm_ops.KERNEL_LAUNCHES.reset()
    objconv_ops.KERNEL_LAUNCHES.reset()
    nets = []
    for net in EVAL_NETS:
        card = eval_net(net, assets[net], torch.device("cuda"))
        cpu = eval_net(net, assets[net], torch.device("cpu"))
        t0 = time.perf_counter()
        want = cpu()
        cpu_s = time.perf_counter() - t0
        err = rel_l2(card(), want, net)
        if not err <= EVAL_REL_L2:
            raise AssertionError(f"{net}: card vs CPU rel-L2 {err:.3e}")
        ms, peak = time_card(card)
        del card, cpu
        torch.cuda.empty_cache()
        unit = "images" if net in ("inception", "lpips_alex") else "clips"
        nets.append(f"{net} rel-L2 {err:.2e}, {EVAL_B / ms * 1e3:.1f} {unit}"
                    f"/s ({ms:.2f} ms per B={EVAL_B} call; CPU "
                    f"{cpu_s:.2f} s), peak {peak / 2**30:.2f} GiB")

    cfg, vocab = Config.load_run_args(run_dir)
    t0 = time.perf_counter()
    gen, gen_png = render_clips(run_dir, 3, os.path.join(tmp, "eval_gen"),
                                cfg, vocab)
    ref, ref_png = render_clips(run_dir, 6, os.path.join(tmp, "eval_ref"),
                                cfg, vocab)
    render_s = time.perf_counter() - t0
    resnext = ("--backbone", "resnext")
    calls = {"image_fid": ("image_fid", gen_png, ref_png),
             "image_fid A,A": ("image_fid", gen_png, gen_png),
             "is": ("is", gen_png),
             "lpips_dirs": ("lpips_dirs", gen_png, ref_png),
             "lpips_dirs A,A": ("lpips_dirs", gen_png, gen_png),
             "video_fid tsm": ("video_fid", gen, ref),
             "video_fid tsm A,A": ("video_fid", gen, gen),
             "video_prd tsm": ("video_prd", gen, ref),
             "video_prd resnext": ("video_prd", gen, ref) + resnext,
             "video_fid resnext": ("video_fid", gen, ref) + resnext,
             "lpips_videos": ("lpips_videos", gen, ref),
             "lpips_videos A,A": ("lpips_videos", gen, gen)}
    results, seconds = {}, {}
    for label, argv in calls.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            r = evaluate_main(list(argv))
        seconds[label] = time.perf_counter() - t0
        if json.loads(buf.getvalue().strip().splitlines()[-1]) != \
                json.loads(json.dumps(r)):
            raise AssertionError(f"{label}: printed another result")
        check_finite(label, r, list(r))
        results[label] = r
    # A against itself: LPIPS 0; FID ~0 against the features' own scale.
    n_clips = len(glob.glob(os.path.join(gen, "*.pkl")))
    feats, _ = _inception_pool3(_load_images(gen_png))
    cached = np.load(os.path.join(gen, "features_tsm.npy"))
    for label, f in (("image_fid A,A", feats), ("video_fid tsm A,A", cached)):
        fid = list(results[label].values())[0]
        scale = 2 * np.trace(np.cov(f, rowvar=False))
        if not abs(fid) <= 1e-3 * scale:
            raise AssertionError(f"{label}: {fid} against scale {scale}")
    for label in ("lpips_dirs A,A", "lpips_videos A,A"):
        if results[label]["lpips"] != 0.0:
            raise AssertionError(f"{label}: {results[label]}")
    if results["lpips_videos"]["n_pairs"] != n_clips or n_clips < 40:
        raise AssertionError(f"{n_clips} clips, lpips_videos paired "
                             f"{results['lpips_videos']['n_pairs']}")

    # Phase 10's trainer, restored from its run's newest checkpoint, scores
    # its use_gt pass with the fabricated InceptionV3.
    val = Loader(get_dataset("synthetic", "val", cfg), cfg, shuffle=False)
    trainer = Trainer(cfg, vocab)
    trainer.init(next(val.epoch(0)))
    trainer.restore_checkpoint(run_dir)
    scorer = InceptionScore(load_inception_params(assets["inception"]))
    t0 = time.perf_counter()
    m, _ = trainer.check_model(val, use_gt=True, inception_score=scorer)
    check_s = time.perf_counter() - t0
    check_finite("check_model", m, ("inception_mean", "inception_std"))
    del trainer, scorer
    if KERNEL_LAUNCHES.n or PLAIN_CALLS.n:
        raise AssertionError("the evaluation stack rasterized")
    torch.cuda.synchronize()
    denorm_launches("in_evaluation_stack")
    objconv_launches("in_evaluation_stack")
    print(f"phase 13 evaluation stack: assets for {', '.join(EVAL_NETS)} "
          f"written by port_torch_weights in {asset_s:.1f} s; card vs CPU, "
          f"fp32, seeded weights from the assets: " + "; ".join(nets)
          + f"; {n_clips} clips of {cfg.frames_per_action} frames per "
          f"directory rendered by phase 10's itr_3 (A) / itr_6 (B) in "
          f"{render_s:.1f} s; scripts.evaluate on the card, seeded random "
          f"networks (no assets): " + ", ".join(
              f"{label} {json.dumps(results[label])} ({seconds[label]:.1f} s)"
              for label in calls)
          + f"; check_model (use_gt, {cfg.num_val_samples} clips) on phase "
          f"10's itr_{ckpt_lib.latest_checkpoint(run_dir).rsplit('_', 1)[1]}"
          f" with the fabricated InceptionV3: {json.dumps(m)} in "
          f"{check_s:.2f} s; rasterizer launches 0; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


# Phase 16: the latent modules. (b) at 64x64 in fp32, the card against the
# CPU: one seed, narrow widths (the CPU side runs each module once forward
# and once backward). Outputs within MODEL_TOL_CPU; the gradients of a
# fixed random weighting of every float output, w.r.t. every parameter (as
# one vector) and the inputs, within LATENT_GRAD_REL_L2 relative L2: fp32
# with TF32 off, convs summed in other orders.
LATENT_SMALL = dict(ndf=16, n_layers_D=4, num_D=2, embedding_dim=16)
LATENT_GRAD_REL_L2 = 1e-4
# A test-mode composite pixel whose sampled mask lies this close to the
# 0.5 threshold may fall on either side of it between the card and the CPU
# (rounding); such pixels are left out of that comparison and counted.
THRESHOLD_BAND = 1e-4


def flat_floats(out):
    """The floating-point tensors of a nested output, in order."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in flat_floats(o)]
    return [out] if torch.is_tensor(out) and out.is_floating_point() else []


def forward_backward(fn, module, args, wrt, seed):
    """fn(*args) with grad on args[wrt] -> (float outputs, gradients of the
    seeded random weighting w.r.t. the module's params (one vector) and
    args[wrt])."""
    args = [a.clone().requires_grad_(True) if i in wrt else a
            for i, a in enumerate(args)]
    outs = flat_floats(fn(*args))
    params = list(module.parameters()) if module is not None else []
    if not params and not wrt:
        return [o.detach() for o in outs], None, ()
    g = torch.Generator().manual_seed(seed)
    total = sum((o.float() * torch.randn(o.shape, generator=g).to(o.device))
                .sum() for o in outs)
    grads = torch.autograd.grad(total, params + [args[i] for i in wrt])
    n = len(params)
    pvec = torch.cat([x.reshape(-1) for x in grads[:n]]) if n else None
    return [o.detach() for o in outs], pvec, grads[n:]


def latent_cases(vocab):
    """Phase 16 (b): name -> (module or None, fn(module, *args), args as
    numpy, indices of args that take a gradient)."""
    rng = np.random.RandomState(16)
    B, T, O, H = 1, 2, 6, 64
    objs = rng.randint(1, 3, (B, O, len(vocab["attributes"])))
    objs[:, -1] = 0
    boxes = np.concatenate([rng.uniform(0.0, 0.6, (B, T, O, 2)),
                            rng.uniform(0.15, 0.45, (B, T, O, 2))],
                           -1).astype(np.float32)
    frames = rng.randn(B, T, H, H, 3).astype(np.float32)
    masks = rng.rand(O, 8, 8).astype(np.float32)
    vecs = rng.randn(O, 16).astype(np.float32)
    obj_mask = (objs[0, :, 0] != 0).astype(np.float32)
    lay = lambda test: (lambda m, v, b, k: masks_to_layout(  # noqa: E731
        v, b, k, H, obj_mask=torch.from_numpy(obj_mask).to(v.device),
        test_mode=test))
    return {
        "MultiscaleDiscriminator": (
            MultiscaleDiscriminator(vocab, **LATENT_SMALL),
            lambda m, *a: m(*a), (frames, objs, boxes), (0,)),
        "MultiscaleDiscriminatorT": (
            MultiscaleDiscriminatorT(T, LATENT_SMALL["num_D"],
                                     LATENT_SMALL["ndf"],
                                     LATENT_SMALL["n_layers_D"]),
            lambda m, *a: m(*a), (frames,), (0,)),
        "AcCropDiscriminator": (
            AcCropDiscriminator(vocab, 16, "C4-16-2,C4-32-2,C4-64-2"),
            lambda m, *a: m(*a), (frames, objs, boxes), (0,)),
        "ConvEncoder": (ConvEncoder(nf=16, z_dim=32),
                        lambda m, *a: m(*a), (frames[0],), (0,)),
        "MaskNet": (MaskNet(32, 16), lambda m, *a: m(*a),
                    (rng.randn(B, O, 32).astype(np.float32),), (0,)),
        "masks_to_layout train": (None, lay(False),
                                  (vecs, boxes[0, 0], masks), (0, 2)),
        # No gradient: a pixel at the threshold (left out below) moves it.
        "masks_to_layout test": (None, lay(True),
                                 (vecs, boxes[0, 0], masks), ()),
        "crop_bbox_batch": (None, lambda m, *a: crop_bbox_batch(
            *a, 16, mask=torch.from_numpy(objs[:, :, 0] != 0).to(
                a[0].device)), (frames, boxes), (0,)),
    }


def undecided_pixels(vecs, boxes, masks, H):
    """The pixels where some object's sampled mask is within THRESHOLD_BAND
    of 0.5 (train mode with one-hot vecs gives the sampled masks)."""
    sampled = masks_to_layout(torch.eye(len(vecs)), boxes, masks, H)
    return ((sampled - 0.5).abs() < THRESHOLD_BAND).any(-1)


def phase_latent_small(vocab):
    """Phase 16 (b) -> printable summary."""
    errs = []
    for i, (name, (module, fn, args, wrt)) in enumerate(
            latent_cases(vocab).items()):
        if module is not None:
            init_params(module, 16 + i)
        runs = {}
        for run in ("cpu", "card", "plain"):
            if run == "plain" and name != "MultiscaleDiscriminator":
                continue
            m = module if run == "cpu" or module is None else \
                copy.deepcopy(module).cuda()
            t_args = [torch.from_numpy(np.asarray(a)) for a in args]
            if run != "cpu":
                t_args = [a.cuda() for a in t_args]
            with ops.plain() if run == "plain" else contextlib.nullcontext():
                runs[run] = forward_backward(lambda *a: fn(m, *a), m, t_args,
                                             wrt, i)
        (c_out, c_p, c_g), (k_out, k_p, k_g) = runs["cpu"], runs["card"]
        skip = None
        if name == "masks_to_layout test":
            skip = undecided_pixels(*(torch.from_numpy(a) for a in args),
                                    64)[..., None]
        worst = 0.0
        for a, b in zip(k_out, c_out):
            a = a.cpu()
            if skip is not None:
                a, b = a.masked_fill(skip, 0.0), b.masked_fill(skip, 0.0)
            worst = max(worst, check_close(f"{name} card vs CPU", a, b,
                                           MODEL_TOL_CPU))
        g_err = max([rel_l2(a, b, f"{name} input gradient")
                     for a, b in zip(k_g, c_g)] +
                    ([rel_l2(k_p, c_p, f"{name} parameter gradient")]
                     if c_p is not None else []), default=0.0)
        if not g_err <= LATENT_GRAD_REL_L2:
            raise AssertionError(f"{name}: card vs CPU gradients rel-L2 "
                                 f"{g_err:.2e}")
        line = f"{name} {worst:.2e}" + (f" / grads {g_err:.2e}"
                                         if c_p is not None or c_g else "")
        if skip is not None:
            line += f" ({int(skip.sum())} undecided pixels left out)"
        if "plain" in runs:
            p_out, p_p, p_g = runs["plain"]
            e = max(check_close("kernel vs plain on the card", a, b,
                                MODEL_TOL_CARD)
                    for a, b in zip(k_out, p_out))
            e_g = max(rel_l2(k_p, p_p, "plain parameter gradient"),
                      *(rel_l2(a, b, "plain input gradient")
                        for a, b in zip(k_g, p_g)))
            if not e_g <= LATENT_GRAD_REL_L2:
                raise AssertionError(f"kernel vs plain gradients {e_g:.2e}")
            line += f", kernel vs plain on the card {e:.2e} / grads {e_g:.2e}"
        errs.append(line)
    return "; ".join(errs)


def d_step_loss(name, disc, real, fake, objs, boxes):
    """The hinge D loss of one variant on a real and a fake batch (plus the
    auxiliary attribute loss on the real crops for the crop D)."""
    if name == "AcCropDiscriminator":
        s_real, ac_real, _, mask = disc(real, objs, boxes, train=True)
        s_fake, _, _, _ = disc(fake, objs, boxes, train=True)
        w = mask.float()[:, None]
        hinge = ((torch.relu(1 - s_real) * w).sum() +
                 (torch.relu(1 + s_fake) * w).sum()) / w.sum().clamp_min(1)
        return hinge + ac_real
    args = (objs, boxes) if name == "MultiscaleDiscriminator" else ()
    return (multiscale_gan_loss(disc(real, *args, train=True), True, True)
            + multiscale_gan_loss(disc(fake, *args, train=True), False,
                                  True))


def phase_latent():
    """Phase 16: the latent modules -> (msd launches per forward, ms per D
    step by variant)."""
    t_phase = time.perf_counter()
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", **TRAIN_FULL).derive(vocab)
    B, T = cfg.batch_size, cfg.frames_per_action
    H, W = cfg.image_size
    dtype = getattr(torch, cfg.compute_dtype)
    batch = make_inputs(cfg, vocab, B, T, seed=16)
    model = AG2VideoModel(cfg, vocab)
    fake, _ = generate(model, batch)  # the seeded generator's clips
    t = {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in batch.items()}
    real, objs, boxes = t["imgs"], t["objs"].long(), t["boxes"]
    with torch.no_grad():
        obj_vecs, _, _ = model.acts_to_objs(objs, t["triplets"].long(),
                                            t["actions"], boxes)
    del model
    torch.cuda.empty_cache()

    # (a) one D step per variant, at the Config's widths.
    variants = {
        "MultiscaleDiscriminator": MultiscaleDiscriminator(
            vocab, cfg.embedding_dim, cfg.num_D, cfg.ndf, cfg.n_layers_D,
            cfg.norm_D, dtype),
        "MultiscaleDiscriminatorT": MultiscaleDiscriminatorT(
            T, cfg.num_D, cfg.ndf, cfg.n_layers_D, cfg.norm_D, dtype),
        "AcCropDiscriminator": AcCropDiscriminator(
            vocab, cfg.crop_size, dtype=dtype),
    }
    lines, step_ms, per_forward, runs = [], {}, {}, 3
    for name, disc in variants.items():
        disc = init_params(disc, 16).cuda()
        opt = torch.optim.Adam(disc.parameters(), lr=cfg.learning_rate,
                               betas=(cfg.beta1, 0.999))

        def step():
            opt.zero_grad(set_to_none=True)
            loss = d_step_loss(name, disc, real, fake, objs, boxes)
            loss.backward()
            opt.step()
            return loss.detach()

        KERNEL_LAUNCHES.reset()
        PLAIN_CALLS.reset()
        loss = step()
        torch.cuda.synchronize()
        launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
        want = 2 if name == "MultiscaleDiscriminator" else 0  # 2 forwards
        if (launches, plain) != (want, 0):
            raise AssertionError(f"{name}: {launches} kernel launches and "
                                 f"{plain} plain calls in one D step")
        bad = [n for n, p in disc.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if not np.isfinite(float(loss)) or bad:
            raise AssertionError(f"{name}: loss {float(loss)}, non-finite "
                                 f"or missing gradients {bad[:4]}")
        per_forward[name] = launches // 2
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(runs):
            loss = step()
        torch.cuda.synchronize()
        step_ms[name] = 1e3 * (time.perf_counter() - t0) / runs
        peak = torch.cuda.max_memory_allocated()
        busy = kernel_ms(step) / step_ms[name]
        lines.append(f"{name} {step_ms[name]:.1f} ms per D step, peak "
                     f"{peak / 2**30:.2f} GiB, busy {100 * busy:.1f}%, loss "
                     f"{float(loss):.4f}, {per_forward[name]} rasterizer "
                     f"kernel launches per forward, 0 plain calls")
        del disc, opt
        torch.cuda.empty_cache()
    print(f"phase 16 (a) D steps at CATER {H}x{W}, the Config's widths "
          f"(B={B} T={T} O={cfg.max_objects}, bf16, ndf={cfg.ndf}, "
          f"num_D={cfg.num_D}, n_layers_D={cfg.n_layers_D}, "
          f"embedding_dim={cfg.embedding_dim}, crop_size={cfg.crop_size}; "
          f"real: seeded synthetic clips, fake: the seeded generator's; "
          f"forward on both, hinge loss, backward, Adam; mean of {runs} "
          f"after one checked step): " + "; ".join(lines), flush=True)

    # (b) the card against the CPU at 64x64 in fp32.
    print(f"phase 16 (b) card vs CPU, 64x64 fp32, max|diff| / rel-L2: "
          f"{phase_latent_small(vocab)}", flush=True)

    # (c) ConvEncoder at full width on the B*T frames.
    enc = init_params(ConvEncoder(64, 256, dtype=dtype), 16).cuda()
    x = fake.reshape(B * T, H, W, 3)

    def encode():
        enc.zero_grad(set_to_none=True)
        mu, logvar = enc(x, train=True)
        z = reparameterize(torch.Generator(mu.device).manual_seed(16), mu,
                           logvar)
        kld = kld_loss(mu.float(), logvar.float())
        (kld + z.float().square().mean()).backward()
        return z.detach(), kld.detach()

    encode()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z, kld = encode()
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t0)
    bad = [n for n, p in enc.named_parameters()
           if not bool(torch.isfinite(p.grad).all())]
    if tuple(z.shape) != (B * T, 256) or not np.isfinite(float(kld)) or bad:
        raise AssertionError(f"ConvEncoder: z {tuple(z.shape)}, KLD "
                             f"{float(kld)}, non-finite gradients {bad[:4]}")
    print(f"phase 16 (c) ConvEncoder nf=64 z_dim=256 bf16 on {B * T} frames "
          f"of {H}x{W}: z {tuple(z.shape)}, KLD {float(kld):.4e}, forward + "
          f"backward {enc_ms:.1f} ms (the second call), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del enc, z

    # (d) MaskNet at mask_size 16 on the layout model's object vectors,
    # then masks_to_layout to 256x256 per sample, both modes.
    vecs = obj_vecs[:, -1].float()  # (B, O, gconv_dim), the last frame
    mask_vecs = create_mask_vecs(
        vecs, torch.Generator(vecs.device).manual_seed(16),
        cfg.mask_noise_dim)
    net = init_params(MaskNet(mask_vecs.shape[-1], 16), 16).cuda()
    masks = net(mask_vecs, train=True)
    obj_mask = remove_dummy_objects_mask(objs)
    covered, total = 0, 0
    with torch.no_grad():
        for b in range(B):
            box = boxes[b, -1]
            args = (box, masks[b].detach(), H, W)
            outs = [masks_to_layout(vecs[b], *args, obj_mask=obj_mask[b],
                                    test_mode=m) for m in (False, True)]
            eye = torch.eye(len(box), device=box.device)
            onehot = masks_to_layout(eye, *args, obj_mask=obj_mask[b],
                                     test_mode=True)
            hard = masks_to_layout(eye, *args, obj_mask=obj_mask[b]) > 0.5
            if not all(bool(torch.isfinite(o).all()) for o in outs) or \
                    any(tuple(o.shape) != (H, W, vecs.shape[-1])
                        for o in outs):
                raise AssertionError("masks_to_layout: non-finite or shape")
            # A composite: each pixel from at most one object, and every
            # pixel some hard mask covers is claimed.
            per_pixel = (onehot != 0).sum(-1)
            if int(per_pixel.max()) > 1 or not torch.equal(
                    per_pixel > 0, hard.any(-1)):
                raise AssertionError("test mode is not a composite")
            covered += int((per_pixel > 0).sum())
            total += H * W
    print(f"phase 16 (d) MaskNet(mask_size=16) on create_mask_vecs of the "
          f"layout model's object vectors ({tuple(mask_vecs.shape)}), "
          f"masks_to_layout to {H}x{W} per sample in train and test mode: "
          f"finite; test mode a composite (each pixel from at most one "
          f"object), {100 * covered / total:.1f}% of pixels claimed",
          flush=True)
    print(f"phase 16 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return per_forward["MultiscaleDiscriminator"], step_ms


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def launch_env(rank, world, port):
    """torchrun's variables for `rank` of `world` in this process."""
    env = dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in LAUNCH_VARS}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def trainer_tensors(trainer):
    """Every tensor of the training state: the models' parameters and
    buffers, the Adams' parameters (fp32 masters) and moments."""
    st = trainer.state
    return [t for obj in (st.model, st.disc, st.opt_graph, st.opt_gen,
                          st.opt_d) for t in state_tensors(obj)]


def check_replicas(trainer, mesh, when):
    differ = replicas_differ(trainer_tensors(trainer), mesh)
    if differ:
        raise AssertionError(f"rank {mesh.rank}: {len(differ)} state tensors "
                             f"differ across the ranks {when}")


@contextlib.contextmanager
def timed_allreduce(record):
    """Time every `allreduce_grads` of the trainer (synchronised on both
    sides) into record["s"] and its bytes into record["bytes"]."""
    import ag2video_torch.train.trainer as trainer_module

    orig = trainer_module.allreduce_grads

    def timed(params, mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = orig(params, mesh)
        torch.cuda.synchronize()
        record["s"] += time.perf_counter() - t0
        record["bytes"] += n
        return n

    trainer_module.allreduce_grads = timed
    try:
        yield record
    finally:
        trainer_module.allreduce_grads = orig


def dp_full(mesh):
    """Phase 17 (a) on this rank -> its figures."""
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", **TRAIN_FULL).derive(vocab)
    B, T = cfg.batch_size, cfg.frames_per_action
    batch = make_inputs(cfg, vocab, B, T, seed=mesh.rank)
    graph = make_inputs(cfg, vocab, B, 4 * cfg.frames_per_action_graph,
                        seed=10 + mesh.rank)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, vocab, device="cuda:0", mesh=mesh)
    trainer.init(batch)
    setup_s = time.perf_counter() - t0
    check_replicas(trainer, mesh, "after init")

    def iteration():
        m = trainer.train_step(batch)
        m.update(trainer.graph_step(graph))
        bad = [k for k, v in m.items() if not np.isfinite(float(v))]
        if bad or trainer.skipped_nan:
            raise AssertionError(f"rank {mesh.rank}: non-finite {bad}, "
                                 f"{trainer.skipped_nan} skipped steps")
        return m

    iteration()
    check_replicas(trainer, mesh, "after the warm-up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL_LAUNCHES.reset()
    PLAIN_CALLS.reset()
    ms, ar = [], {"s": 0.0, "bytes": 0}
    with timed_allreduce(ar):
        for i in range(DP_RUNS):
            t0 = time.perf_counter()
            m = iteration()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            check_replicas(trainer, mesh, f"after step {i + 1}")
    launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
    if launches != 2 * DP_RUNS or plain != 0:
        raise AssertionError(f"rank {mesh.rank}: {launches} kernel launches "
                             f"and {plain} plain calls in {DP_RUNS} "
                             f"train_steps")
    return dict(ms=ms, setup_s=setup_s, per_step=launches // DP_RUNS,
                ar_ms=1e3 * ar["s"] / DP_RUNS,
                ar_bytes=ar["bytes"] // DP_RUNS,
                peak=torch.cuda.max_memory_allocated(),
                last={k: float(v) for k, v in m.items()},
                batch=cfg.batch_size)


def dp_small_inputs(rank):
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", **TRAIN_SMALL).derive(vocab)
    B = cfg.batch_size
    return (cfg, vocab,
            make_inputs(cfg, vocab, B, cfg.frames_per_action, seed=rank),
            make_inputs(cfg, vocab, B, 4 * cfg.frames_per_action_graph,
                        seed=10 + rank))


def dp_small_step(cfg, vocab, batch, graph, mesh=None, plain=False):
    """One train_step + graph_step of the small trainer on the card, inside
    `ops.plain()` if `plain` -> {metrics, grads (the train_step's), stats
    (BN running averages after both), launches, plain}."""
    KERNEL_LAUNCHES.reset()
    PLAIN_CALLS.reset()
    with ops.plain() if plain else contextlib.nullcontext():
        trainer = Trainer(cfg, vocab, mesh=mesh)
        trainer.init(batch)
        m = trainer.train_step(batch)
        grads = named_leaves(trainer, "grad")
        m.update(trainer.graph_step(graph))
    torch.cuda.synchronize()
    return dict(metrics={k: float(v) for k, v in m.items()}, grads=grads,
                stats={k: v.cpu() for k, v in
                       running_stats(trainer.state.model).items()},
                launches=KERNEL_LAUNCHES.n, plain=PLAIN_CALLS.n)


def dp_worker(rank, tmp, port):
    """A rank of phase 17 (a) and (b): two ranks on card 0 over gloo."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with launch_env(rank, DP_WORLD, port):
        init_distributed(device="cuda:0", backend="gloo")
    try:
        mesh = make_mesh()
        out = dict(full=dp_full(mesh))
        gc.collect()
        torch.cuda.empty_cache()
        cfg, vocab, batch, graph = dp_small_inputs(rank)
        out["small"] = {b: dp_small_step(cfg, vocab, batch, graph, mesh,
                                         b == "plain")
                        for b in ("auto", "plain")}
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def dp_compare(name, got, want):
    """Losses, gradients and BN statistics of two dp_small_step runs ->
    printable summary; raises past the DP_* bounds."""
    loss = 0.0
    for k, w in want["metrics"].items():
        g = got["metrics"][k]
        err = abs(g - w) / max(abs(w), 1.0)
        if not np.isfinite(g) or err > DP_LOSS_RTOL:
            raise AssertionError(f"{name}: {k} {g!r} vs {w!r}")
        loss = max(loss, err)
    worst, leaf, median = compare_grads(name, got["grads"], want["grads"],
                                        DP_GRAD_WORST, DP_GRAD_MEDIAN)
    state = max(float((got["stats"][k] - w).abs().max())
                for k, w in want["stats"].items())
    if not state <= DP_STATE_ATOL:
        raise AssertionError(f"{name}: BN statistics differ by {state:.3e}")
    return (f"{name}: losses {loss:.2e}, gradients worst {worst:.2e} "
            f"({leaf}) median {median:.2e}, BN statistics {state:.2e}")


def dp_cli(tmp):
    """Phase 17 (c) -> printable summary."""
    out = os.path.join(tmp, "dp_cli")
    backends = []
    orig_fit = Trainer.fit

    def fit(self, *args, **kwargs):
        backends.append((dist.get_backend(), dist.get_world_size()))
        return orig_fit(self, *args, **kwargs)

    Trainer.fit = fit
    try:
        with launch_env(0, 1, free_port()):
            t0 = time.perf_counter()
            trainer = train_main(DP_CLI_ARGS + ["--output_dir", out])
            run_s = time.perf_counter() - t0
    finally:
        Trainer.fit = orig_fit
    if backends != [("nccl", 1)] or dist.is_initialized():
        raise AssertionError(f"the CLI trained over {backends}; group left "
                             f"open: {dist.is_initialized()}")
    recs = read_metrics(out)
    check_finite("t=3", recs.get(3, {}), ("G/total_loss", "Graph/total_loss"))
    if trainer.state.step != 3 or not all(
            ckpt_lib.is_port_checkpoint(ckpt_lib.checkpoint_path(out, t))
            for t in (0, 2, 3)):
        raise AssertionError(f"step {trainer.state.step}; run directory "
                             f"{sorted(os.listdir(out))}")
    return (f"backend nccl, world 1; step 3, itr_0 / itr_2 / itr_3 and "
            f"metrics.jsonl written; {run_s:.1f} s")


def dp_peaks():
    """Phase 17 (d): peak GiB at 512x512 of the default generate at B=2,
    T=8 and of one train_step at B=1 -> printable summary."""
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", **dict(FULL, image_size=(512, 512))
                 ).derive(vocab)
    B, T = 2, cfg.frames_per_action
    model = AG2VideoModel(cfg, vocab)
    batch = make_inputs(cfg, vocab, B, T, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    imgs, _ = generate(model, batch)
    torch.cuda.synchronize()
    gen_peak = torch.cuda.max_memory_allocated()
    if tuple(imgs.shape) != (B, T, 512, 512, 3) or \
            not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"512x512 generate: {tuple(imgs.shape)}")
    del model, imgs
    gc.collect()
    torch.cuda.empty_cache()
    cfg = Config(dataset="cater", image_size=(512, 512), batch_size=1,
                 compute_dtype="bfloat16").derive(vocab)
    batch = make_inputs(cfg, vocab, 1, cfg.frames_per_action, seed=0)
    trainer = Trainer(cfg, vocab)
    trainer.init(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = trainer.train_step(batch)
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    bad = [k for k, v in m.items() if not np.isfinite(float(v))]
    if bad or trainer.skipped_nan:
        raise AssertionError(f"512x512 train_step: non-finite {bad}")
    total = torch.cuda.get_device_properties(0).total_memory
    return (f"generate (factorized, B={B} T={T}, bf16) peak "
            f"{gen_peak / 2**30:.2f} GiB; train_step (B=1, T="
            f"{cfg.frames_per_action}, bf16) peak {train_peak / 2**30:.2f} "
            f"GiB; the card holds {total / 2**30:.2f} GiB")


def phase_dp():
    """Phase 17 -> kernel launches per train_step on each rank."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks need the card's memory
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(dp_worker, args=(tmp, free_port()),
                                 nprocs=DP_WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 600
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError("phase 17: the ranks hung")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        full = [r["full"] for r in ranks]
        print(f"phase 17 (a) data parallel, {DP_WORLD} gloo ranks on one "
              f"card, phase 9's configuration (CATER vocabulary, B="
              f"{full[0]['batch']} per rank, global "
              f"{DP_WORLD * full[0]['batch']}; 1 warm-up, {DP_RUNS} timed "
              f"iterations; losses finite, no skipped step, every state "
              f"tensor bit-equal across the ranks after init and each step): "
              + "; ".join(
                  f"rank {i}: " + ", ".join(f"{x:.1f}" for x in f["ms"])
                  + f" ms per iteration, allreduce_grads {f['ar_ms']:.1f} ms "
                  f"and {f['ar_bytes'] / 2**20:.1f} MiB per step, peak "
                  f"{f['peak'] / 2**30:.2f} GiB, {f['per_step']} rasterizer "
                  f"kernel launches per train_step, 0 plain calls, setup "
                  f"{f['setup_s']:.1f} s" for i, f in enumerate(full))
              + "; last losses " + ", ".join(
                  f"{k} {v:.4f}" for k, v in sorted(full[0]["last"].items())),
              flush=True)

        cfg, vocab, batch, graph = dp_small_inputs(0)
        parts = [dp_small_inputs(r)[2:] for r in range(DP_WORLD)]

        def single(order):
            b, g = ({k: np.concatenate([parts[o][i][k] for o in order])
                     for k in parts[0][i]} for i in (0, 1))
            return dp_small_step(cfg, vocab, b, g)

        one = single([0, 1])
        permuted = single([1, 0])
        for i, r in enumerate(ranks):
            auto, plain = r["small"]["auto"], r["small"]["plain"]
            if (auto["launches"], auto["plain"]) != (full[i]["per_step"], 0) \
                    or plain["launches"] != 0 or plain["plain"] == 0:
                raise AssertionError(f"rank {i}: kernel / plain calls "
                                     f"{auto['launches']} / {auto['plain']} "
                                     f"and {plain['launches']} / "
                                     f"{plain['plain']}")
        if ranks[0]["small"]["auto"]["metrics"] != \
                ranks[1]["small"]["auto"]["metrics"]:
            raise AssertionError("the ranks report other losses")
        print(f"phase 17 (b) 64x64 fp32 small trainer, one train_step + "
              f"graph_step, B={cfg.batch_size} per rank (bounds: losses "
              f"{DP_LOSS_RTOL}, gradients {DP_GRAD_WORST} / "
              f"{DP_GRAD_MEDIAN}, BN statistics {DP_STATE_ATOL}): "
              + "; ".join([
                  dp_compare("two ranks vs one process",
                             ranks[0]["small"]["auto"], one),
                  dp_compare("one process, permuted batch",
                             permuted, one),
                  dp_compare("two ranks, kernel vs plain",
                             ranks[0]["small"]["auto"],
                             ranks[0]["small"]["plain"])]), flush=True)
        print(f"phase 17 (c) scripts.train.main under torchrun's variables: "
              f"{dp_cli(tmp)}", flush=True)
    print(f"phase 17 (d) 512x512: {dp_peaks()}", flush=True)
    print(f"phase 17 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return full[0]["per_step"]


def audit_line(rows):
    errs = sigma_audit.rel_errors(rows)
    return (f"{len(rows)} kernels, rel err mean {np.mean(errs):.2%} max "
            f"{np.max(errs):.2%}")


def phase_trajectory():
    """Phase 18: the reference file's 8 training iterations on the card
    (the kernel on, TF32 off, cuDNN's deterministic algorithms), per
    compute dtype, held to the JAX package's (torch_tools/trajectory.py),
    then run again to show the card's own spread -> {dtype: kernel
    launches per train_step}."""
    t_phase = time.perf_counter()
    ref = trajectory.load_reference()
    K = len(ref["train_seeds"])
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        per_step = {dtype: _trajectory(ref, K, dtype)
                    for dtype in trajectory.DTYPES}
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = saved
    print(f"phase 18 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return per_step


def _trajectory(ref, K, dtype):
    """Phase 18 for one compute dtype -> kernel launches per train_step."""
    t0 = time.perf_counter()
    KERNEL_LAUNCHES.reset()
    PLAIN_CALLS.reset()
    port = trajectory.run_port(ref, dtype, None)  # the card
    torch.cuda.synchronize()
    launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
    run_s = time.perf_counter() - t0
    if next(port["trainer"].state.model.parameters()).device.type != "cuda":
        raise AssertionError("the trajectory's trainer is not on the card")
    if launches != 2 * K or plain != 0:
        raise AssertionError(f"trajectory {dtype}: {launches} kernel "
                             f"launches, {plain} plain calls in {K} "
                             f"train_steps")
    report = trajectory.check(ref, dtype, port)
    st = port["trainer"].state
    jax_rows = trajectory.reference_sigma_rows(ref, dtype)
    again = trajectory.run_port(ref, dtype, None)
    print(f"phase 18 trajectory, {dtype} compute ({K} iterations of "
          f"train_step + graph_step at 64x64 against "
          f"reference_trajectory_64.npz, {run_s:.1f} s): rasterizer kernel "
          f"launches {launches // K} per train_step, plain calls {plain}; "
          f"bounds max({trajectory.SPREAD_FACTOR:g} x the reference's own "
          f"spread, floor {trajectory.FLOORS[dtype]}): "
          f"{trajectory.format_report(report, dtype)}; sigma audit after "
          f"iteration {K}: port G "
          f"{audit_line(sigma_audit.spectral_rows(st.model))}, D "
          f"{audit_line(sigma_audit.spectral_rows(st.disc))}; JAX G "
          f"{audit_line(jax_rows['G'])}, D {audit_line(jax_rows['D'])}; "
          f"the same iterations again on the card against the first run: "
          f"{trajectory.self_difference(port, again)}", flush=True)
    return launches // K


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs the "
                         "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    timing = phase_kernel()
    denorm_timing = phase_denorm()
    objconv_timing = phase_objconv()
    phase_small_model()
    launches = phase_full(factorized=False)
    phase_factorized()
    phase_full(factorized=True)
    phase_small_trainer()
    phase9 = phase_train_full()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        fit = phase_fit(phase9["ms"], run_dir)
        per_train_step_cater = phase_cater(tmp, fit)
        phase_clis(run_dir, tmp, fit["gifs"])
        phase_eval(run_dir, tmp)
        modes = phase_modes(phase9)
        phase_backbone_iou(run_dir, tmp)
    msd_per_forward, _ = phase_latent()
    msd = timing["msd"]
    print(f"phase 16 (e) the rasterizer at the MultiscaleDiscriminator's "
          f"shape N=12 O=12 D=512 256x256 bf16 (phase 2): kernel "
          f"{msd['ms']:.4f} ms, plain {msd['plain_ms']:.4f} ms, torch.bmm "
          f"{msd['library_ms']:.4f} ms, bound {msd['bound_ms']:.4f} ms; "
          f"{msd_per_forward} launch per forward")
    per_step_dp = phase_dp()
    per_step_trajectory = phase_trajectory()
    disc = timing["disc"]
    print(json.dumps({"kernels": [dict({
        "name": "rasterize",
        "route": "cuda",
        "source": "ag2video_torch/csrc/rasterize.cu",
        "replaces": "ag2video_tpu/ops/pallas/rasterize_kernel.py:33",
        "launches": launches,
    }, **timing["c"],
        library="torch.bmm(coverage (N, H*W, O) bf16, vecs (N, O, D) bf16)",
        launches_per_train_step=phase9["per_step"],
        launches_per_train_step_fit=fit["launches"],
        launches_per_train_step_cater=per_train_step_cater,
        **{f"launches_per_train_step_{k}": v for k, v in modes.items()},
        disc_shape="N=9 O=12 D=256 256x256 bf16",
        **{f"disc_{k}": v for k, v in disc.items()},
        launches_per_msd_forward=msd_per_forward,
        launches_per_train_step_dp=per_step_dp,
        **{f"launches_per_train_step_trajectory_{k}": v
           for k, v in per_step_trajectory.items()},
        msd_shape="N=12 O=12 D=512 256x256 bf16",
        **{f"msd_{k}": v for k, v in msd.items()}), {
        "name": "denorm",
        "route": "cuda",
        "source": "ag2video_torch/csrc/denorm.cu",
        "replaces": None,
        **{f"{shape}_{k}": v for shape, t in denorm_timing.items()
           for k, v in t.items()},
        **{f"launches_{path}": n for path, n in DENORM_LAUNCHES.items()}}, {
        "name": "objconv",
        "route": "cuda",
        "source": "ag2video_torch/csrc/objconv.cu",
        "replaces": None,
        "library": "torch.bmm(bf16 shifted coverage, wk) + cuDNN bf16 conv "
                   "of the image (no norm, no activation)",
        **{f"{shape}_{k}": v for shape, t in objconv_timing.items()
           for k, v in t.items()},
        **{f"launches_{path}": n for path, n in OBJCONV_LAUNCHES.items()}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
