#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (enspara_tpu_torch) on one GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the five kernel sources (csrc/kcenters_step.cu with its fp32
and bf16 entry points, csrc/qcp_update.cu likewise, csrc/qcp_matrix.cu,
csrc/ell_spmm.cu and csrc/pam_try.cu, one nvcc each, in parallel) from
the checkout and drives these paths:

1-3. the k-centers kernel against its plain PyTorch version on the
     card, and the north-star pipeline at full size through the port's
     public functions: 1M frames x 64 atoms (random, seed 42) ->
     prepare_rmsd_frames -> kcenters_device_fused to 1000 centers ->
     lag-10 counts -> transpose-builder top-21 eigenpairs, each checked
     (exact counts against numpy, eigenvalues within 1e-4 of a float64
     host solve); then the clustering again with tri_skip=False (kernel
     2, the twin that skips nothing), bit for bit the same;
4.   the all-pairs QCP kernel against its plain version at the shapes
     its path gives it (a 1M x 256-center assignment block, a 131,072 x
     64 PAM proposal block, a 1,000 x 37 x 61-atom padding shape), then
     on self pairs (centers that are frames: the msd near 0, no argmin
     flip);
5.   the cluster -> reassign workflow through the port's apps: 100 XTC
     trajectories x 10,000 frames of 64 CA atoms (metastable-basin
     data, seed 1) clustered with --algorithm khybrid --cluster-number
     1000 --subsample 10 --random-state 0 (k-centers, then 5 PAM sweeps
     on the QCP kernel), then every one of the 1M frames reassigned to the centers
     (the reassign app, on the QCP kernel). The two .h5 writes of the
     apps (ra.save) are left out: they need h5py; PAM's tries launch
     the try kernels (pam_try_eval, pam_try_commit), counted;
5b.  the PAM try kernels against their plain versions on the same card
     tensors at the main path's shard, 321,536 frames of which 321,500
     are real: counts exact, the sum of squares within 1e-12 relative,
     two evaluations and the commit bit for bit; each timed per call;
6.   the ELL SpMM kernel against its plain version, bit for bit, at the
     shapes its path gives it (the bucketed ELL of the 100,000-state
     scale point's S with 64 and 128 columns, and an odd 1,000 x 5 x 21
     shape), timed beside torch.sparse.mm of the same CSR matrix, with
     its nonzero slots and achieved bytes/s;
7.   the large-MSM eigensolve through the port's entry points: the
     scale point of benchmarks/scale_points.py (100,000 states,
     sparse_metastable_counts with 25 wells, seed 11) through
     builders.transpose and eigenspectrum_reversible(method='auto'),
     which takes the filtered solver on the card, checked against host
     ARPACK (eigenvalues within 1e-10, residuals below 1e-9, pi within
     1e-9); then implied_timescales_device at lags 1, 2, 4 on host KMC
     assignments over 20,000 states, each lag's eigenvalues within 1e-10
     of host ARPACK;
8.   the two one-iteration kernels of the sharded loop (kernel 3,
     qcp_update.cu, and kernel 4, kc_iter_skip of kcenters_step.cu)
     against their plain versions: one 250,112 x 64 shard of phase 9's
     layout and phase 1's basin data cut into 4 shards, each with the
     finite md that chose the center (tiles skip) and with md = inf;
9.   the sharded path through the port's public functions on a 4-shard
     mesh of the card (FrameMesh((cuda:0,) * 4)): phase 2's 1M x 64
     frames -> kcenters(..., mesh=) to 1000 centers ->
     assigns_to_counts_sharded at lag 10 -> transpose_timescales_device
     -> assign_device(..., mesh=) -> implied_timescales_batched at lags
     1, 2, 5, 10 with and without the mesh, held against phase 2's
     single-device run, tri_skip=False (kernel 3) against tri_skip=True
     (kernel 4) bit for bit, numpy counts and float64 host eigenvalues;
10.  the analysis path on phase 5's 1M reassigned labels (1000 states),
     with none of the six kernels: (a) the implied_timescales CLI's run()
     with its default flags (48 lags, one batched fp32 solve on the card;
     exp(-lag/ts) within 1e-4 of a float64 host solve of each lag) and
     with row_normalize (the host fan-out); (b) MSM at lag 10 with the
     transpose builder and with builders.mle_device on the card (trimmed,
     within 5e-4 of the host mle), and a save/load round trip; (c) 10
     bootstrap MSMs and BACE to 25 macrostates; (d) the device KMC, 1000
     chains x 10,000 steps (every step an edge of T, frequencies within
     5 binomial sigma); (e) BASELINE config 4's TPT (a 10,000-state ring
     with shortcuts): committors and mfpts by the fp32 device LU with
     fp64 refinement (no stall; within 1e-10 of a host spsolve),
     net_fluxes and 10 paths equal to those of the float64 host path;
11.  clustering feature vectors, with none of the six kernels: per metric
     (euclidean, manhattan, hamming) k-centers at 65,536 x 64 to 128
     centers against a float64 farthest-point oracle; 1M x 64 blob
     features (the generator of benchmarks/reference_cpu_kcenters.py,
     2,000 blobs) in 100 .npy files through the cluster app's sequence
     (--features --cluster-distance euclidean --algorithm khybrid
     --cluster-number 1000 --subsample 10 --checkpoint, the features
     reassign of every frame, then --algorithm kmedoids warm-started from
     the checkpoint, its cost no higher); then on the full 1M x 64:
     resume_kcenters from a 500-center checkpoint equal to a straight
     1000-center run bit for bit, the loop's per-iteration profile,
     kcenters over a 4-shard mesh of the card against one device,
     manhattan and hamming (1M x 64 three-state labels) k-centers and
     assignment; covering radii and labels against float64, each
     assignment's peak card memory below 16 GB;
12.  the CARDS chain, with none of the six kernels: (a) cards_matrices at
     BASELINE config 3 (the generator of
     benchmarks/reference_configs.py:176-195: 2 trajectories x 250,000
     frames x 150 three-state features), its joint counts' marginals and
     64 feature pairs against np.bincount, the disorder labels against
     the host painter, the four matrices against the port's own CPU run,
     bit for bit, and the joint counts on a 4-shard mesh of the card; (b)
     all_rotamers of a 25-residue LYS peptide (NeRF coordinates of hidden
     2- and 3-basin dihedral chains, 500,000 frames): dihedrals within
     1e-5 rad of float64 numpy, states equal to the host _rotamers on
     every column whose angles stay clear of the gates; (c) `enspara
     cards` and `enspara entropy` through the dispatcher on 20 XTC files
     x 10,000 of those frames, by stage, the pickle equal to cards() of
     the same frames; (d) weighted_mi at 20,000 x 100 boolean features
     within 1e-12 of a float64 host einsum;
13.  structure analysis, with none of the six kernels: (a) shrake_rupley
     over 2,000 centers of a 263-residue LYS globule at protein density
     (2,367 atoms, 960 points, probe 0.28 nm, the neighbor list), cold
     and warm, against the dense path and a float64 oracle on 3 frames
     and a 4-shard mesh of the card, with its operation bound; (b)
     exposons of those SASAs by stage, the MI within 1e-12 of a float64
     host einsum, the labels equal to the CPU run; (c) rmsf_calc within
     1e-6 of float64, the helix functions on a 20-residue ideal helix,
     get_pockets on 8 frames with a planted cavity; (d) the smFRET
     point-cloud route: SF488/SF594 distance distributions over every
     center for 2 residue pairs, 1,000 photon bursts from a 2,000-state
     MSM, the first bursts again host-only (the CPU's distributions,
     equal counts; the FRET efficiencies equal bit for bit);
14.  the bf16 frame stream, the locality sort and the streamed ingest:
     (a) kernels 1, 2 (and 4 on the whole layout) in bf16 at phase 2's
     1M x 64 layout and kernels 3 and 4 at a 250,112 x 64 bf16 shard,
     each against its plain version on the same bf16 frames, timed; (b)
     the north star in bf16 (prepare_rmsd_frames(precision='bf16') ->
     kcenters_device_fused to 1000 centers -> lag-10 counts -> top-21
     eigenpairs) beside phase 2's fp32 seconds, tri_skip=False bit for
     bit, every distance within the rounding bound of RMSD's triangle
     inequality of the fp32 RMSD to the same center, and the 4-shard mesh
     held as phase 9 holds fp32; (c) phase 5's basin frames shuffled
     (seed 7) clustered unsorted and with sort='locality', skipped tiles
     of each, the sorted results in the caller's order; (d) a 1M x 64
     host array ingested streamed and in one copy, in both precisions,
     bit for bit the same; (e) the cluster CLI on 10 of phase 5's XTC
     files with --precision bf16 and with --locality-sort, the outputs
     read back and checked;
15.  the explicit-dye half of smFRET, with none of the six kernels, on a
     synthetic dye library written to a temporary directory (two dyes of
     60 atoms x 500 conformations with 500-state detailed-balance counts,
     seeded; the builtin R0 tables): (a) `enspara smfret-dyes
     calc_lifetimes` on phase 13's 2,000 centers at one residue pair with
     --dye_treatment Monte-carlo-device --n_samples 1000 --dye_lagtime
     0.002 (the clash test and one lockstep loop of every center's photons
     on the card), then static and isotropic, by stage; (J, QD, Td) equal
     to an inline float64 trapezoid of the tables, the kept dye states of
     the first 8 centers equal to the CPU's, the lockstep MC at one center
     with 100,000 photons within 5 standard errors of the exact absorbing
     chain (a float64 fixed point on the card), with the dyes as placed
     and with the acceptor 7.5 nm away, where no outcome dominates; (b) the host per-photon
     walk on 4 centers at 50 samples, within 10 points of the device run
     in each outcome fraction; (c) run_burst, 1,000 bursts over phase 13's
     2,000-state MSM (seed 17), every FRET efficiency in [0, 1];
16.  the PAM sweeps over a 4-shard mesh of the card and the multi-process
     cluster CLI, kernel 5 on every shard: (a) KHybrid at phase 5's scale
     (its 100,000 subsampled frames in memory -> 1000, 5 sweeps,
     random_state 0) over the mesh and on one device, by stage; (b)
     kmedoids_sweeps_device over the mesh on all 1M of phase 5's frames,
     2 sweeps from a kcenters(mesh=) seed, against one device from the
     same seed, the cost below the seed's (the try kernels launched
     once a shard a try in 16a-d); each held as the same medoids
     (then distances on the msd bar, assignments equal but for near
     ties) or, where a swap's gain lay within the float32 rounding of
     the cost sums, final costs within 1e-5; (c) the cluster CLI's
     multi-process sequence in two processes of this script (one shard
     each on cuda:0, joined over gloo through ENSPARA_TPU_COORDINATOR)
     on 10 of phase 5's XTC files, --algorithm khybrid --cluster-number
     1000 --subsample 1 --random-state 0: both processes bit for bit an
     in-process FrameMesh((cuda:0,) * 2) run, rank 0 alone writing the
     center indices and structures (the .h5 write left out), --subsample
     2 refused, stage seconds a process, the loop's ms an iteration;
     (d) with two or more cards, the same sequence on all 100 of phase
     5's files (1M frames) in one process a card (up to 4; process r
     started with CUDA_VISIBLE_DEVICES=r), so that the job joins over
     NCCL: every process reports the nccl backend, mesh.size and
     first_shard, and equals bit for bit the in-process run over
     FrameMesh([cuda:0 .. cuda:P-1]); rank 0 alone writes; stage seconds
     and launches a process, and rank 0's torch.profiler window of 64
     loop iterations (launches, NCCL kernel time, idle share) beside the
     in-process run and 16c (one card: a line says 16d did not run).
     A worker that fails, or runs past JOB_TIMEOUT, ends the job's other
     processes and fails the run;
17.  mesh=None, the JAX package's default mesh: (a) frame_mesh() holds
     every visible card; kcenters on phase 2's frames (from the host),
     assign_device of them to its centers, KHybrid on phase 5's
     subsample and the cluster CLI's fit of phase 5, all on frames of
     fewer than SMALL_JOB_FEATURES features, and the implied CLI on phase 5's labels and
     collect_cards of phase 12 (phase 12's own run), each with no mesh=
     and no device=, bit for bit the same calls pinned to
     device='cuda:0' (with several cards, the last two to as many
     virtual shards of cuda:0), in the order default, pinned, pinned,
     default; kernel 1's launches are phase 2's and no kernel 3 or 4
     runs; with several cards and the rule off, the default kcenters
     runs kernel 4 over them; a 501-frame job stays on the current card;
     (b) with two or more cards, phase 9 and 16a-b over frame_mesh(),
     bit for bit the same on virtual shards of cuda:0 (one card: a line
     says this half did not run);
18.  assign_device of 32M x 64-atom frames (chip_mesh_crossover.py's
     random walk, made on the card a million frames at a time and held
     on the host) to 1000 centers on one card, through the streamed
     ingest: seconds, pairs/s and the peak allocated memory, which stays
     below the frame layout plus 1.25 of its (n_pad, 256) center blocks
     (one block alive at a time), the first 1,048,576 rows bit for bit
     the assignment of those frames alone.

Every time printed was taken on the card's machine (device stages timed
with CUDA events or to a synchronize, host stages on its host), warm
where it says so, and stands beside the card's name and power limit. Any failed check raises
and the exit code is not 0. Without a CUDA device it fails before
printing a result.

Run with ``--job-worker RANK DIR`` it is one process of phase 16c or
16d (the parent starts them all). Phase 16d runs where two or more cards
are visible, for example on a four-card machine:

    python3 chip_smoke.py          # every card visible: 16d on up to 4

Standard output ends with a JSON line of the kernels (each with its
launches on its path, its time, its plain version's, its bound at the
data sheet's rates and, for the ELL SpMM, torch.sparse.mm's), the
nvidia-smi line, and the result line {"ok": true, "device": {...}}.
"""

import contextlib
import importlib
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

import enspara_tpu_torch.geometry as geometry_pkg
import enspara_tpu_torch.io as port_io
from enspara_tpu_torch.apps import cluster as cluster_app
from enspara_tpu_torch.apps import collect_cards as cards_app
from enspara_tpu_torch.apps import implied_timescales as its_app
from enspara_tpu_torch.apps import main as main_app
from enspara_tpu_torch.apps import reassign as reassign_app
from enspara_tpu_torch.cards import cards, cards_matrices, disorder
from enspara_tpu_torch.cluster import (KHybrid, engine, engine_kmedoids,
                                       kcenters)
from enspara_tpu_torch.cluster import util as cluster_util
from enspara_tpu_torch import ra
from enspara_tpu_torch.convert import result_to_numpy
from enspara_tpu_torch.exception import ConvergenceWarning
from enspara_tpu_torch.geometry import (dihedrals, helix, pockets, rmsf,
                                        rotamer)
from enspara_tpu_torch.geometry import sasa as sasa_mod
from enspara_tpu_torch.geometry import dyes_from_expt_dist as dyes
from enspara_tpu_torch.geometry import dye_lifetimes as dl
from enspara_tpu_torch.geometry import explicit_r0_calc as r0c
from enspara_tpu_torch.geometry.sasa import shrake_rupley
from enspara_tpu_torch.info_theory import exposons, libinfo, mutual_info
from enspara_tpu_torch.io import Topology, Trajectory, write_pdb, write_xtc
from enspara_tpu_torch.msm import (MSM, MSMs, assigns_to_counts,
                                   assigns_to_counts_device,
                                   assigns_to_counts_sharded, bace, builders,
                                   eigen_device, eigenspectrum_reversible,
                                   implied_timescales_batched,
                                   implied_timescales_device,
                                   sparse_metastable_counts,
                                   synthetic_trajectory_device,
                                   transpose_timescales_device)
from enspara_tpu_torch.ops import _build
from enspara_tpu_torch.ops.ell_spmm import ell_spmm_kernel, ell_spmm_plain
from enspara_tpu_torch.ops.pam_try import (pam_try_commit,
                                           pam_try_commit_plain, pam_try_eval,
                                           pam_try_eval_plain)
from enspara_tpu_torch.ops.kcenters_step import (
    KCentersState, kcenters_chunk, kcenters_chunk_plain,
    kcenters_iteration_skip, kcenters_iteration_skip_plain, skip_t_pad,
    start_state, tile_summaries)
from enspara_tpu_torch.ops import qcp_matrix
from enspara_tpu_torch.ops.qcp_update import (kcenters_iteration,
                                              kcenters_iteration_plain)
from enspara_tpu_torch.cards.featurizers import RotamerFeaturizer
from enspara_tpu_torch.parallel import FrameMesh, frame_mesh
from enspara_tpu_torch.parallel import mesh as pmesh
from enspara_tpu_torch.ops.qcp import rmsd_from_S_components_unrolled
from enspara_tpu_torch.ops.sparse import dense_on_device
from enspara_tpu_torch.tpt import committors, mfpts, net_fluxes, paths
from enspara_tpu_torch.tpt import core as tpt_core
from enspara_tpu_torch.util.checkpoint import (resume_kcenters,
                                               save_clustering_checkpoint)
from enspara_tpu_torch.util.device import require_cuda

N_FRAMES, N_ATOMS, N_CLUSTERS, LAG, N_EIGS = 1_000_000, 64, 1000, 10, 21
CHECK_FRAMES, CHECK_CENTERS = 65_536, 128
TIMED_ITERS = 64
SOURCE = 'enspara_tpu_torch/csrc/kcenters_step.cu'
REPLACES = 'enspara_tpu/ops/kcenters_skip_pallas.py:274'
NOSKIP_REPLACES = 'enspara_tpu/ops/kcenters_chunk_pallas.py:191'
# the modules, which the packages' hybrid() and cards() functions shadow as
# attributes
hybrid_mod = importlib.import_module('enspara_tpu_torch.cluster.hybrid')
cards_mod = importlib.import_module('enspara_tpu_torch.cards.cards')
QCP_SOURCE = 'enspara_tpu_torch/csrc/qcp_matrix.cu'
QCP_REPLACES = 'enspara_tpu/ops/qcp_pallas.py:111'
# phase 4 shapes (frames, centers, atoms): an assignment block, a PAM
# proposal block, a padding shape
QCP_SHAPES = ((1_048_576, 256, 64), (131_072, 64, 64), (1000, 37, 61))
# phase 5: trajectories x frames each, atoms, centers, subsample
N_TRJ, TRJ_FRAMES, CLUSTER_K, SUBSAMPLE = 100, 10_000, 1000, 10
# phase 5b: the PAM try kernels (they replace no TPU kernel: the JAX
# sweep's lax.cond try bodies, fused by XLA) at the main path's shard,
# the benchmark's 321,500 subsampled frames padded to a tile of 256
PAM_SOURCE = 'enspara_tpu_torch/csrc/pam_try.cu'
PAM_FRAMES, PAM_PAD = 321_500, 321_536
ELL_SOURCE = 'enspara_tpu_torch/csrc/ell_spmm.cu'
ELL_REPLACES = 'enspara_tpu/ops/spmm_pallas.py:125'
# phases 6-7: the scale point of benchmarks/scale_points.py (states,
# wells, seed, modes), the block widths of phase 6, an odd ELL shape
# (n, w, k), and the implied-timescales run: wells x states each, extra
# links between consecutive wells and their counts (so that chains
# cross), KMC chains x steps, lags
SCALE_STATES, SCALE_BLOCKS, SCALE_SEED, SCALE_EIGS = 100_000, 25, 11, 21
ELL_WIDTHS = (64, 128)
ODD_ELL = (1000, 5, 21)
ITS_WELLS, ITS_WELL_STATES, ITS_LINKS, ITS_LINK_COUNTS = 25, 1000, 20, 2.0
ITS_CHAINS, ITS_STEPS, ITS_LAGS, ITS_TIMES = 200, 20_000, (1, 2, 4), 20
# phases 8-9: the sharded path's shards, its lags, and the two
# one-iteration kernels (kernel 3 qcp_update, kernel 4
# kcenters_iteration_skip) with the TPU kernels they replace
N_SHARDS, SHARDED_LAGS = 4, (1, 2, 5, 10)
UPDATE_SOURCE = 'enspara_tpu_torch/csrc/qcp_update.cu'
UPDATE_REPLACES = 'enspara_tpu/ops/qcp_update_pallas.py:134'
SKIP_REPLACES = 'enspara_tpu/ops/kcenters_skip_pallas.py:482'
# the bf16 frame stream of kernels 1-4: where each TPU kernel upconverts
BF16_REPLACES = {'1': 'enspara_tpu/ops/kcenters_skip_pallas.py:203',
                 '2': 'enspara_tpu/ops/kcenters_chunk_pallas.py:126',
                 '3': 'enspara_tpu/ops/qcp_update_pallas.py:79',
                 '4': 'enspara_tpu/ops/kcenters_skip_pallas.py:438'}
ITER_TIMED = 50
# phase 9's profiled window: runs of this many centers and twice as many
CHUNK_CENTERS = 64
# one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s, fp32 flop/s
# outside the tensor cores, dense TF32 flop/s of the tensor cores
HBM_RATE, FP32_RATE, TF32_RATE = 3.35e12, 67e12, 495e12
# fp32 operations of the QCP epilogue a pair (csrc/qcp_rmsd.cuh): each
# add, subtract, multiply, divide, sqrt, min, max, abs and compare-select
# one, an FMA two. Squares 9; fnorm2 8; det 14; C2, C1 2; the eight sums
# and differences 8; D 4; e1 4; e2 4; E 3; F, G, H, I 9 each (36); C0 5;
# lam0 1; inv (max, divide) 2; inv2 1; c2, c1, c0 5; 12 Newton steps of
# 18 (u2 1, p 6, dp 5, den 2, step 3, u 1) = 216; clamp 2; msd and sqrt
# 6: 330 in all
QCP_EPILOGUE_OPS = 330
# phase 4's self-pair block (frames, centers, atoms)
QCP_SELF = (131_072, 64, 64)
# phase 10, the analysis path on phase 5's labels: the flags of the
# implied CLI's batched run (its defaults) and of its host run, the MSM
# lag, bootstrap trials, BACE macrostates and KMC steps; then BASELINE
# config 4's TPT (benchmarks/reference_configs.py:226-265): states, seed,
# sources, sinks, paths
ITS_FLAGS = ('--lag-times', '5:100:2', '--n-eigenvalues', '5',
             '--symmetrization', 'transpose')
HOST_ITS_FLAGS = ('--lag-times', '5:100:10', '--n-eigenvalues', '5',
                  '--symmetrization', 'row_normalize')
MSM_LAG, BOOT_TRIALS, BACE_STATES, KMC_STEPS = 10, 10, 25, 10_000
TPT_STATES, TPT_SEED, TPT_SOURCES, TPT_SINKS = 10_000, 3, [0], [5000]
TPT_PATHS = 10
# phase 11, clustering feature vectors: trajectories x frames each of
# features (phase 5's layout), blobs of the generator of
# benchmarks/reference_cpu_kcenters.py, centers, subsample, the centers of
# the checkpoint resume_kcenters continues, the oracle check's (frames,
# centers), and the bound on an assignment's peak card memory
FEAT_TRJ, FEAT_FRAMES, FEAT_DIM, FEAT_BLOBS = 100, 10_000, 64, 2000
FEAT_K, FEAT_SUBSAMPLE, FEAT_RESUME_FROM = 1000, 10, 500
FEAT_CHECK = (65_536, 128)
FEAT_MEM_LIMIT = 16 * 2 ** 30
# phase 12, the CARDS chain: BASELINE config 3 (trajectories x frames each
# x three-state features, its seed) and the feature pairs held against
# np.bincount; the LYS peptide's residues, frames and seed; the CLI's
# files x frames each (the peptide's first frames); weighted_mi's frames x
# boolean features
CARDS_TRJ, CARDS_FRAMES, CARDS_FEATURES, CARDS_SEED = 2, 250_000, 150, 7
CARDS_PAIRS = 64
CARDS_RES, CARDS_PEP_FRAMES, CARDS_PEP_SEED = 25, 500_000, 8
CARDS_CLI_FILES, CARDS_CLI_FRAMES = 20, 10_000
CARDS_WMI = (20_000, 100)
# phase 13, the structure-analysis path: the globule's LYS residues (9
# heavy atoms each: 2,367 atoms) at protein heavy-atom density (atoms per
# nm^3), its cluster centers, shell points and the exposons' probe; the
# planted groups (groups, residues each, outward swing in nm); the frames
# of the exact SASA checks and the mesh's shards; the pockets' frames and
# cavity radius; the helix's residues; the smFRET route's residue pairs,
# bursts, the bursts run again host-only, photons a burst and MSM steps a
# burst
GLOB_RES, GLOB_DENSITY = 263, 56.0
SASA_FRAMES, SASA_POINTS, SASA_PROBE = 2000, 960, 0.28
PLANTED = (4, 8, 0.8)
SASA_CHECK, SASA_SHARDS = 3, 4
POCKET_FRAMES, POCKET_CAVITY = 8, 0.5
HELIX_RES = 20
FRET_PAIRS, FRET_BURSTS, FRET_HOST_BURSTS = 2, 1000, 2
FRET_PHOTONS, FRET_STEPS = (50, 200), (1_000, 10_000)
# phase 14, the bf16 frame stream, the locality sort and the streamed
# ingest: frames a block of the per-frame RMSD checks, the seed of the
# shuffle of phase 5's frames, the XTC files of phase 5 the CLI clusters
CHECK_BLOCK = 1 << 18
SORT_SEED = 7
BF16_CLI_FILES = 10


def check(ok, what):
    if not ok:
        raise RuntimeError('check failed: ' + what)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def basin_data(rng, n, a, n_basins, noise=0.02, dwell=64):
    """Temporally ordered metastable-basin frames, the generator of
    tests/test_kcenters_skip.py."""
    templates = rng.normal(size=(n_basins, a, 3)).astype(np.float32)
    seg = np.cumsum(rng.random(n) < 1.0 / dwell)
    basin = rng.integers(0, n_basins, size=seg.max() + 1)[seg]
    return (templates[basin]
            + noise * rng.normal(size=(n, a, 3)).astype(np.float32))


def random_walk(device, seed=42):
    """1M frames around one structure with a per-frame scalar drift and
    noise, centered (the bench.py dataset), made on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((N_ATOMS, 3), generator=gen, device=device)
    drift = torch.randn((N_FRAMES, 1, 1), generator=gen, device=device)
    frames = torch.randn((N_FRAMES, N_ATOMS, 3), generator=gen,
                         device=device).mul_(0.1)
    frames += base + 0.3 * drift * base
    return frames - frames.mean(dim=1, keepdim=True)


def fresh_state(prep):
    n_pad = prep.frames_r.shape[1]
    dev = prep.frames_r.device
    dist = torch.full((1, n_pad), float('inf'), device=dev)
    dist[0, prep.n:] = -float('inf')
    assig = torch.full((1, n_pad), -1, dtype=torch.int32, device=dev)
    return start_state(dist, assig, prep.frames_r.shape[0], prep.tile, 0,
                       1 << 30, 0.0)


def clone(state):
    return KCentersState(*(t.clone() for t in state))


def msd_bar(prep):
    """Elementwise bar on |a^2 - b^2| of two RMSDs of these frames:
    rtol 1e-5 on the msd plus 16 ulp of gsum / n_atoms (fp32 QCP takes
    the msd as gsum - 2*lambda_max, so its error scales with gsum)."""
    floor = 16 * np.finfo(np.float32).eps * 2 * float(prep.g.max()) \
        / prep.n_atoms
    return lambda d: 1e-5 * d * d + floor


def rmsd_close(a, b, bar):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    if not np.array_equal(a[~fin], b[~fin]):
        return False
    return bool((np.abs(a[fin] ** 2 - b[fin] ** 2) <= bar(b[fin])).all())


def pair_rmsd(prep, fa, fb):
    """RMSD of frame fa[k] to frame fb[k] by the plain QCP functions,
    read from the prepared layout (float64 host result)."""
    a_pad = prep.frames_r.shape[0] // 3

    def structs(idx):
        cols = prep.frames_r[:, torch.as_tensor(idx, device=prep.g.device)]
        return cols.float().view(3, a_pad, -1).permute(2, 1, 0)
    A, B = structs(fa), structs(fb)
    S = torch.einsum('fni,fnj->ijf', A, B)
    gsum = (A * A).sum((1, 2)) + (B * B).sum((1, 2))
    d = rmsd_from_S_components_unrolled(
        tuple(S[i, j] for i in range(3) for j in range(3)), gsum,
        float(prep.n_atoms))
    return d.cpu().numpy().astype(np.float64)


def compare_chunks(prep, start, kern, plain, n_iters, what):
    """Kernel against plain version over one chunk from ``start``:
    centers, skip counts and the next center exactly equal, distances
    within the msd bar, and assignments equal except for frames whose
    RMSDs to the two centers lie within the msd bar of each other (a
    near tie decided by rounding). Where a pick differs: a near tie of
    the two candidates in the plain run and an equal covering radius to
    1e-5. Returns a one-line verdict."""
    bar = msd_bar(prep)
    if np.array_equal(kern[2], plain[2]):
        for k, name in ((3, 'next center'), (6, 'skip counts')):
            check(np.array_equal(kern[k], plain[k]),
                  '%s: %s differ' % (what, name))
        for k, name in ((0, 'distances'), (4, 'next max'), (5, 'tmax')):
            check(rmsd_close(kern[k], plain[k], bar),
                  '%s: %s outside the msd bar' % (what, name))
        flips = np.flatnonzero(kern[1][0] != plain[1][0])
        if len(flips):
            ctr = kern[2][:, 0]
            ci = start.scalars()[2]
            dk = pair_rmsd(prep, flips, ctr[kern[1][0, flips] - ci])
            dp = pair_rmsd(prep, flips, ctr[plain[1][0, flips] - ci])
            check(bool((np.abs(dk ** 2 - dp ** 2)
                        <= bar(np.maximum(dk, dp))).all()),
                  '%s: assignments differ beyond near ties' % what)
        return ('%s: centers and skip counts equal; distances within the '
                'msd bar; assignments equal but for %d near-tie frames'
                % (what, len(flips)))
    i = int(np.flatnonzero(kern[2][:, 0] != plain[2][:, 0])[0])
    a, b = int(kern[2][i, 0]), int(plain[2][i, 0])
    st = clone(start)
    if i:
        kcenters_chunk_plain(prep, st, i)
    d = st.dist[0].cpu().numpy().astype(np.float64)
    check(abs(d[a] ** 2 - d[b] ** 2) <= bar(max(d[a], d[b])),
          '%s: pick %d differs (%d vs %d) without a near tie: %r vs %r'
          % (what, i, a, b, d[a], d[b]))
    rk, rp = float(kern[4][0, 0]), float(plain[4][0, 0])
    check(abs(rk - rp) <= 1e-5 * abs(rp),
          '%s: covering radius %r vs %r' % (what, rk, rp))
    return ('%s: near tie at pick %d (%d vs %d, %.9g vs %.9g) swapped the '
            'pick; covering radius equal to 1e-5 (%.9g vs %.9g)'
            % (what, i, a, b, d[a], d[b], rk, rp))


def run_chunk(fn, prep, state, n_iters, **kw):
    ctr, skc = fn(prep, state, n_iters, **kw)
    return result_to_numpy(state, ctr, skc)


def timed_chunk(fn, prep, start, n_iters):
    """Device time of one chunk of ``n_iters`` iterations from a copy of
    ``start``, in ms per iteration, and the chunk's outcome."""
    state = clone(start)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ctr, skc = fn(prep, state, n_iters)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n_iters, result_to_numpy(state, ctr, skc)


def host_eigs(counts):
    """float64 transpose builder + numpy eigh: the top eigenvalues and
    the equilibrium populations."""
    C = counts.astype(np.float64)
    sym = C + C.T
    mass = sym.sum(axis=1)
    pi = mass / mass.sum()
    sq = np.sqrt(pi)
    S = sq[:, None] * (sym / mass[:, None]) / sq[None, :]
    w = np.linalg.eigvalsh((S + S.T) * 0.5)[::-1][:N_EIGS]
    return w, pi


def pipeline(frames, device):
    """The north-star main path through the port's public functions,
    each stage timed to a synchronize."""
    torch.cuda.synchronize()
    tp = time.perf_counter()
    prep = engine.prepare_rmsd_frames(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.kcenters_device_fused(prep, n_clusters=N_CLUSTERS)
    t1 = time.perf_counter()
    assigns = res.assignments.reshape(100, -1)
    counts = assigns_to_counts_device(assigns, np.ones_like(assigns, bool),
                                      LAG, N_CLUSTERS, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, vals, vecs = transpose_timescales_device(counts, N_EIGS,
                                                lag_time=LAG)
    t3 = time.perf_counter()
    return prep, res, counts, vals, vecs, (t0 - tp, t1 - t0, t2 - t1,
                                           t3 - t2)


def bar_from(gsum_max, n_atoms):
    """The msd bar of msd_bar, from a bound on gsum and the atom
    count."""
    floor = 16 * np.finfo(np.float32).eps * gsum_max / n_atoms
    return lambda d: 1e-5 * d * d + floor


def events_ms(fn):
    """Device time of one call of ``fn`` in ms (CUDA events)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def qcp_shape(device, F, C, A, seed):
    """Kernel 5 against its plain version at one (F, C, A) shape, on
    random centered frames and centers near some of them: every entry
    within the msd bar, argmins equal but for near ties, the launch
    counter grown by the launches made; then timed in turns plain,
    kernel, kernel, plain. Returns ``(max |kernel - plain|, kernel ms,
    plain ms, line)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((F, A, 3), generator=gen, device=device)
    Y = X[torch.randint(0, F, (C,), generator=gen, device=device)] \
        + 0.01 * torch.randn((C, A, 3), generator=gen, device=device)
    X = X - X.mean(dim=1, keepdim=True)
    Y = Y - Y.mean(dim=1, keepdim=True)
    a_pad = -(-A // 8) * 8
    fr, gf = qcp_matrix.to_layout(X, qcp_matrix.pad_frames(F), a_pad)
    cr, gc = qcp_matrix.to_layout(Y, qcp_matrix.pad_centers(C), a_pad)
    del X, Y
    args = (fr, gf, cr, gc, A)
    n0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    k = qcp_matrix.qcp_rmsd_matrix_kernel(*args)
    torch.cuda.synchronize()
    check(qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == n0 + 1,
          'qcp launch count did not grow by 1')
    p = qcp_matrix.qcp_rmsd_matrix_plain(*args)
    k, p = k[:F, :C].double(), p[:F, :C].double()
    check(bool(torch.isfinite(k).all()), 'qcp kernel: non-finite values')
    bar = bar_from(2 * float(max(gf.max(), gc.max())), A)
    check(bool(((k * k - p * p).abs() <= bar(p)).all()),
          '%d x %d x %d: qcp kernel outside the msd bar' % (F, C, A))
    max_abs_err = float((k - p).abs().max())
    ak, ap = k.argmin(dim=1), p.argmin(dim=1)
    flips = torch.nonzero(ak != ap).flatten()
    if len(flips):
        dk = p[flips, ak[flips]]
        dp = p[flips, ap[flips]]
        check(bool(((dk * dk - dp * dp).abs()
                    <= bar(torch.maximum(dk, dp))).all()),
              '%d x %d x %d: argmins differ beyond near ties' % (F, C, A))
    del k, p
    fns = {'kernel': qcp_matrix.qcp_rmsd_matrix_kernel,
           'plain': qcp_matrix.qcp_rmsd_matrix_plain}
    for fn in fns.values():
        fn(*args)                                  # warm-up
    times = []
    for name in ('plain', 'kernel', 'kernel', 'plain'):
        times.append(events_ms(lambda: fns[name](*args))[0])
    check(qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == n0 + 4,
          'qcp launch count did not grow by the launches made')
    ms, plain_ms = min(times[1:3]), min(times[0], times[3])
    line = ('%d x %d x %d kernel vs plain: within the msd bar, argmins '
            'equal but for %d near ties, max |kernel - plain| %.3g; ms '
            'per block kernel %.4f, plain %.4f (turns plain, kernel, '
            'kernel, plain: %s)' % (F, C, A, len(flips), max_abs_err, ms,
                                    plain_ms,
                                    ', '.join('%.4f' % t for t in times)))
    return max_abs_err, ms, plain_ms, line


def qcp_self_pairs(device, F, C, A, seed):
    """Kernel 5 on self pairs: F centered frames, each a copy of one of C
    random structures plus noise 0.01, and as centers the first C frames
    themselves, so a center's own frame has msd ``gsum - 2 lambda`` that
    cancels to near 0. Every entry within the msd bar of the plain
    version, no argmin flip, each center frame within the bar's floor of
    0 and its argmin its own center. Returns a line."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((C, A, 3), generator=gen, device=device)
    X = base[torch.arange(F, device=device) % C] \
        + 0.01 * torch.randn((F, A, 3), generator=gen, device=device)
    X = X - X.mean(dim=1, keepdim=True)
    a_pad = -(-A // 8) * 8
    fr, gf = qcp_matrix.to_layout(X, qcp_matrix.pad_frames(F), a_pad)
    cr, gc = qcp_matrix.to_layout(X[:C], qcp_matrix.pad_centers(C), a_pad)
    del X, base
    n0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    k = qcp_matrix.qcp_rmsd_matrix_kernel(fr, gf, cr, gc, A)
    torch.cuda.synchronize()
    check(qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == n0 + 1,
          'qcp launch count did not grow by 1')
    p = qcp_matrix.qcp_rmsd_matrix_plain(fr, gf, cr, gc, A)
    k, p = k[:F, :C].double(), p[:F, :C].double()
    bar = bar_from(2 * float(max(gf.max(), gc.max())), A)
    check(bool(torch.isfinite(k).all()), 'self pairs: non-finite values')
    check(bool(((k * k - p * p).abs() <= bar(p)).all()),
          'self pairs: kernel outside the msd bar')
    own = k.diagonal()
    check(bool((own * own <= bar(0.0)).all()),
          'self pairs: a center frame lies %g from its own center'
          % float(own.max()))
    flips = int((k.argmin(dim=1) != p.argmin(dim=1)).sum())
    check(flips == 0, 'self pairs: %d argmin flips' % flips)
    ids = torch.arange(F, device=device) % C
    check(bool((k.argmin(dim=1) == ids).all()),
          'self pairs: a frame took another center than its own')
    return ('%d x %d x %d self pairs: within the msd bar, 0 argmin flips; '
            'center frames at most %.3g from their own center (msd floor '
            '%.3g), plain %.3g; max |kernel - plain| %.3g'
            % (F, C, A, float(own.max()), bar(0.0), float(p.diagonal().max()),
               float((k - p).abs().max())))


def phase5_data():
    """Phase 5's frames: N_TRJ * TRJ_FRAMES basin frames of N_ATOMS
    atoms (seed 1, 2,000 basins, noise 0.02 nm), trajectory by
    trajectory."""
    return basin_data(np.random.default_rng(1), N_TRJ * TRJ_FRAMES,
                      N_ATOMS, n_basins=2000)


def write_trajectories(d, n_trj=N_TRJ):
    """The phase-5 data set under ``d``: a PDB of 64 CA atoms and the
    first ``n_trj`` of its N_TRJ XTC trajectories of TRJ_FRAMES basin
    frames each. Returns ``(pdb, xtc paths, an upper bound on the frame
    pairs' G sum)``."""
    X = phase5_data()[:n_trj * TRJ_FRAMES]
    top = Topology()
    chain = top.add_chain()
    for i in range(N_ATOMS):
        top.add_atom('CA', 'C', top.add_residue('ALA', chain, i + 1))
    pdb = os.path.join(d, 'ca.pdb')
    write_pdb(pdb, Trajectory(X[:1], top))
    paths = [os.path.join(d, 'trj%03d.xtc' % t) for t in range(n_trj)]
    cluster_util.load_xtc_codec(paths)   # before the writer threads

    def one(t):
        write_xtc(paths[t], Trajectory(
            X[t * TRJ_FRAMES:(t + 1) * TRJ_FRAMES], top))
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(one, range(n_trj)))
    Xc = X - X.mean(axis=1, keepdims=True)
    # xtc stores 1e-3 nm: 1% covers its change of G
    return pdb, paths, 2.02 * float(np.einsum('nai,nai->n', Xc, Xc).max())


class Stage:
    """Wrap ``module.name`` for one run: device-synchronised wall time
    and the kernel launches made inside it, summed over its calls, and
    its last result."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.seconds, self.calls, self.qcp, self.kc = 0.0, 0, 0, 0
        self.k4 = self.pe = self.pc = 0

    def __enter__(self):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            q0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
            k0 = kcenters_chunk.n_launches
            s0 = kcenters_iteration_skip.n_launches
            e0, c0 = pam_try_eval.n_launches, pam_try_commit.n_launches
            t = time.perf_counter()
            self.result = self.fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t
            self.calls += 1
            self.qcp += qcp_matrix.qcp_rmsd_matrix_kernel.n_launches - q0
            self.kc += kcenters_chunk.n_launches - k0
            self.k4 += kcenters_iteration_skip.n_launches - s0
            self.pe += pam_try_eval.n_launches - e0
            self.pc += pam_try_commit.n_launches - c0
            return self.result
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def reassign_path(device, card):
    """Phase 5: the cluster -> reassign workflow through the port's
    apps at 1M frames x 64 atoms -> 1000 centers, with its checks.
    Returns the launches of both kernels in the run and the reassigned
    labels (N_TRJ, TRJ_FRAMES)."""
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        pdb, trjs, gsum = write_trajectories(d)
        print('wrote %d XTC trajectories x %d frames x %d atoms in %.1f s'
              % (N_TRJ, TRJ_FRAMES, N_ATOMS, time.perf_counter() - t),
              flush=True)
        bar = bar_from(gsum, N_ATOMS)
        out = {k: os.path.join(d, v) for k, v in (
            ('--distances', 'dist.h5'), ('--assignments', 'assig.h5'),
            ('--center-features', 'centers.pkl'),
            ('--center-indices', 'inds.npy'))}
        argv = ['cluster', '--trajectories', *trjs, '--topology', pdb,
                '--atoms', 'name CA', '--algorithm', 'khybrid',
                '--cluster-number', str(CLUSTER_K), '--subsample',
                str(SUBSAMPLE), '--random-state', '0']
        for k, v in out.items():
            argv += [k, v]

        reset_launches()
        engine_kmedoids._pam_sweeps.n_host_syncs = 0
        # the sequence of apps/cluster.py :: main, but for its .h5 write
        args = cluster_app.process_command_line(argv)
        t = time.perf_counter()
        lengths, data = cluster_util.load_trjs_or_features(args)
        t_load = time.perf_counter() - t
        with Stage(hybrid_mod, '_kcenters') as kc, \
                Stage(hybrid_mod, '_kmedoids_iterations') as pam:
            # the CLI's own placement: the library's default (phase 17)
            clustering = cluster_app.fit(args, data)
        syncs = engine_kmedoids._pam_sweeps.n_host_syncs
        res = clustering.result_
        result = res.partition(lengths)
        t = time.perf_counter()
        cluster_util.write_centers_indices(
            args.center_indices, cluster_app.center_indices(result, args))
        cluster_util.write_centers(result, args)
        t_write = time.perf_counter() - t

        # the sequence of apps/reassign.py :: main, but for its .h5 writes
        rargv = ['reassign', '--centers', out['--center-features'],
                 '--trajectories', *trjs, '--topology', pdb, '--atoms',
                 'name CA', '--distances', os.path.join(d, 'rd.h5'),
                 '--assignments', os.path.join(d, 'ra.h5')]
        rargs = reassign_app.process_command_line(rargv)
        t = time.perf_counter()
        with Stage(engine, 'assign_device') as asg:
            r_assig, r_dist = reassign_app.run(
                rargs, reassign_app.load_centers(rargs))
        t_reassign = time.perf_counter() - t
        launches = {'qcp_matrix': qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                    'kcenters_step': kcenters_chunk.n_launches,
                    'pam_seconds': pam.seconds, 'pam_syncs': syncs,
                    'pam_eval': pam.pe, 'pam_commit': pam.pc,
                    # for phase 17: the fit, its input and its launches
                    'args': args, 'data': data, 'result': res,
                    'fit_s': kc.seconds + pam.seconds,
                    'fit_kc': kc.kc, 'fit_qcp': pam.qcp,
                    'fit_k34': kcenters_iteration_skip.n_launches
                    + kcenters_iteration.n_launches}
        check(ell_spmm_kernel.n_launches == 0,
              'cluster -> reassign launched the ell_spmm kernel')

        # -- checks --
        n_sub = sum(lengths)
        check(n_sub == N_TRJ * TRJ_FRAMES // SUBSAMPLE,
              'loaded %d frames' % n_sub)
        ctr = np.asarray(res.center_indices)
        check(len(ctr) == CLUSTER_K and len(set(ctr.tolist())) == CLUSTER_K,
              '%d distinct centers' % len(set(ctr.tolist())))
        check(bool((bar(0.0) >= res.distances[ctr] ** 2).all()),
              'a center frame lies %g from its own center'
              % res.distances[ctr].max())
        cost_kc = float(np.mean(kc.result.distances ** 2))
        cost = float(np.mean(res.distances ** 2))
        check(cost <= cost_kc, 'PAM cost %r above k-centers cost %r'
              % (cost, cost_kc))
        # kernel 1 on one card; kernel 4 over several (the default mesh)
        check(kc.kc + kc.k4 > 0, 'k-centers launched no kernel')
        check(pam.qcp > 0 and pam.kc == 0,
              'PAM: %d qcp launches, %d k-centers launches'
              % (pam.qcp, pam.kc))
        try_launches_ok(pam, 'PAM')
        check(asg.qcp > 0, 'reassign launched no qcp kernel')
        r_assig, r_dist = np.asarray(r_assig), np.asarray(r_dist)
        check(r_assig.shape == (N_TRJ, TRJ_FRAMES) and
              np.isfinite(r_dist).all(), 'reassign output %s'
              % (r_assig.shape,))
        sub_a = r_assig[:, ::SUBSAMPLE]
        sub_d = r_dist[:, ::SUBSAMPLE]
        clu_a = np.asarray(result.assignments)
        clu_d = np.asarray(result.distances, np.float64)
        check(bool((np.abs(sub_d ** 2 - clu_d ** 2) <= bar(clu_d)).all()),
              'reassigned distances outside the msd bar')
        flips = sub_a != clu_a
        # a flip took another center at the same distance: a near tie
        check(bool((np.abs(sub_d[flips] ** 2 - clu_d[flips] ** 2)
                    <= bar(np.maximum(sub_d[flips], clu_d[flips]))).all()),
              'reassignment differs beyond near ties')
        ctr_full = [(t, f * SUBSAMPLE) for t, f in result.center_indices]
        own = np.array([r_dist[t, f] for t, f in ctr_full])
        check(bool((own ** 2 <= bar(0.0)).all()),
              'a center frame is %g from every center' % own.max())

    pairs = N_TRJ * TRJ_FRAMES * CLUSTER_K
    print('cluster -> reassign: %d of %d frames clustered (--subsample %d)'
          ' to %d centers, PAM cost %.6g <= k-centers cost %.6g; %d of '
          '%d subsampled frames reassigned to another center, each a near'
          ' tie; every center frame within the msd bar of 0'
          % (n_sub, N_TRJ * TRJ_FRAMES, SUBSAMPLE, CLUSTER_K, cost,
             cost_kc, int(flips.sum()), flips.size))
    print('[%s] load %.4f s; k-centers %.4f s (%d launches); PAM %.4f s '
          '(5 sweeps, %d host syncs, %d qcp launches, %d pam_try_eval and '
          '%d pam_try_commit launches); write centers '
          '%.4f s; reassign %.4f s (load + assign), of which assign '
          '%.4f s = %.4g pairs/s (%d qcp launches)'
          % (card, t_load, kc.seconds, kc.kc, pam.seconds, syncs, pam.qcp,
             pam.pe, pam.pc, t_write, t_reassign, asg.seconds, pairs / asg.seconds,
             asg.qcp), flush=True)
    return launches, r_assig


def try_launches_ok(pam, what, n_shards=1):
    """The PAM stage ``pam`` (a Stage) ran the try kernels: evaluations
    and commits launched, at most one commit an evaluation, each a
    launch a shard."""
    check(pam.pe > 0 and pam.pc > 0 and pam.pc <= pam.pe
          and pam.pe % n_shards == 0 and pam.pc % n_shards == 0,
          '%s: %d pam_try_eval and %d pam_try_commit launches on %d shards'
          % (what, pam.pe, pam.pc, n_shards))


def pam_try_kernels(device, card):
    """Phase 5b: the PAM try kernels against their plain versions on the
    same card tensors, at one shard of PAM_PAD frames of which the first
    PAM_FRAMES are real (the rest padding at inf / -1): a state whose
    dnew ties d1 and d2 at a third of the frames each, with a displaced
    medoid that has members and one that has none. Counts exact, the sum
    of squares within 1e-12 relative, a second evaluation bit for bit
    the first, the commit bit for bit; then each timed with its launches
    queued behind a spin of the card. Returns their numbers."""
    g = torch.Generator(device=device).manual_seed(19)
    n, nv, k = PAM_PAD, PAM_FRAMES, CLUSTER_K

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    a1 = torch.randint(0, k, (n,), generator=g, device=device,
                       dtype=torch.int32)
    a2 = (a1 + torch.randint(1, k, (n,), generator=g, device=device,
                             dtype=torch.int32)) % k
    d1 = rand(n)
    d2 = d1 + rand(n)
    t = rand(n)
    dnew = torch.where(t < 1 / 3, d1, torch.where(t < 2 / 3, d2,
                                                  2 * rand(n)))
    stale = rand(n) < 0.1
    for x, fill in ((d1, math.inf), (d2, math.inf), (a1, -1), (a2, -1),
                    (stale, False)):
        x[nv:] = fill
    out = {}
    for what, cid in (('members', int(a1[0])), ('no members', k)):
        e0 = pam_try_eval.n_launches
        got = pam_try_eval(d1, a1, d2, a2, dnew, stale, cid, nv)
        again = pam_try_eval(d1, a1, d2, a2, dnew, stale, cid, nv)
        want = pam_try_eval_plain(d1, a1, d2, a2, dnew, stale, cid, nv)
        torch.cuda.synchronize()
        check(pam_try_eval.n_launches == e0 + 2,
              '5b: pam_try_eval made %d launches for 2 calls'
              % (pam_try_eval.n_launches - e0))
        got_h, want_h = got.tolist(), want.tolist()
        rel = abs(got_h[2] - want_h[2]) / want_h[2]
        check(got_h[:2] == want_h[:2] and rel <= 1e-12,
              '5b (%s): pam_try_eval %r against plain %r'
              % (what, got_h, want_h))
        check(torch.equal(got, again), '5b (%s): two evaluations differ'
              % what)
        mine = [x.clone() for x in (d1, a1, d2, a2, stale)]
        ref = [x.clone() for x in (d1, a1, d2, a2, stale)]
        c0 = pam_try_commit.n_launches
        pam_try_commit(*mine[:4], dnew, mine[4], cid, nv)
        pam_try_commit_plain(*ref[:4], dnew, ref[4], cid, nv)
        torch.cuda.synchronize()
        check(pam_try_commit.n_launches == c0 + 1,
              '5b: pam_try_commit made %d launches for 1 call'
              % (pam_try_commit.n_launches - c0))
        check(all(torch.equal(x, y) for x, y in zip(mine, ref)),
              '5b (%s): pam_try_commit differs from plain' % what)
        # frames that become stale: the commit's one conditional write
        n_new = int((mine[4] & ~stale).sum())
        out[what] = (got_h, rel, n_new)
    cid = int(a1[0])
    work = [x.clone() for x in (d1, a1, d2, a2, stale)]
    ms = {
        'eval': queued_ms(lambda: pam_try_eval(
            d1, a1, d2, a2, dnew, stale, cid, nv), 200),
        'eval_plain': queued_ms(lambda: pam_try_eval_plain(
            d1, a1, d2, a2, dnew, stale, cid, nv), 10),
        'commit': queued_ms(lambda: pam_try_commit(
            *work[:4], dnew, work[4], cid, nv), 200),
        'commit_plain': queued_ms(lambda: pam_try_commit_plain(
            *work[:4], dnew, work[4], cid, nv), 10)}
    # eval reads d1, a1, d2, a2, dnew (4 B each) and stale (1 B) of the
    # real frames; commit reads the first five of the real frames,
    # writes d1, a1, d2, a2 of every frame and stale where a point
    # becomes stale (the members case's count)
    be = bound(21 * nv, 0)
    bc = bound(20 * nv + 16 * n + out['members'][2], 0)
    nums = {'eval': {'max_rel_err': max(v[1] for v in out.values()),
                     'ms': ms['eval'], 'plain_ms': ms['eval_plain'],
                     'bound_ms': be[0], 'bound_by': be[1],
                     'library_ms': None},
            'commit': {'max_abs_err': 0.0, 'ms': ms['commit'],
                       'plain_ms': ms['commit_plain'], 'bound_ms': bc[0],
                       'bound_by': bc[1], 'library_ms': None}}
    print('5b PAM try kernels at %d frames (%d real) against their plain '
          'versions on the card: counts equal, sum of squares within %.3g '
          'relative, two evaluations bit for bit, the commit bit for bit '
          '(a displaced medoid with members: %d frames became stale; one '
          'with none)' % (n, nv, nums['eval']['max_rel_err'],
                          out['members'][2]))
    print('[%s] 5b per call, queued: pam_try_eval %.4f ms (bound %.4f ms, '
          '%s, %.1f%% of it; plain %.4f ms), pam_try_commit %.4f ms (bound '
          '%.4f ms, %.1f%% of it; plain %.4f ms)'
          % (card, ms['eval'], be[0], be[1], 100 * be[0] / ms['eval'],
             ms['eval_plain'], ms['commit'], bc[0],
             100 * bc[0] / ms['commit'], ms['commit_plain']), flush=True)
    return nums


def bound(n_bytes, n_ops):
    """``(bound_ms, bound_by)``: the least time the card could take for
    work that moves ``n_bytes`` and does ``n_ops`` fp32 operations, the
    larger of the two times at the data sheet's rates."""
    t_bytes, t_ops = n_bytes / HBM_RATE, n_ops / FP32_RATE
    return (1e3 * max(t_bytes, t_ops),
            'bytes' if t_bytes >= t_ops else 'operations')


def qcp_bound(F, C, A):
    """Kernel 5's bound at an (F, C, A) block, ``(bound_ms, bound_by,
    term)``: the bytes (frames, centers and their G read once, the block
    written once) at the HBM rate; the nine contractions, 18 * A_pad
    flops a pair, at the TF32 tensor rate (the three passes of 3xTF32
    belong to the design, not to the function); the epilogue's
    QCP_EPILOGUE_OPS a pair at the fp32 rate."""
    fp, cp, ap = (qcp_matrix.pad_frames(F), qcp_matrix.pad_centers(C),
                  -(-A // 8) * 8)
    terms = {'bytes': 4 * (3 * ap * (fp + cp) + fp + cp + fp * cp)
             / HBM_RATE,
             'contraction, TF32': 18 * ap * fp * cp / TF32_RATE,
             'epilogue, fp32': QCP_EPILOGUE_OPS * fp * cp / FP32_RATE}
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], 'bytes' if term == 'bytes' else
            'operations', term)


def reps_ms(fn, reps):
    """Device time of one call of ``fn`` in ms: CUDA events around
    ``reps`` calls."""
    return events_ms(lambda: [fn() for _ in range(reps)])[0] / reps


def reset_launches():
    for fn in (kcenters_chunk, kcenters_iteration, kcenters_iteration_skip):
        fn.n_launches = fn.n_bf16_launches = 0
    qcp_matrix.qcp_rmsd_matrix_kernel.n_launches = 0
    ell_spmm_kernel.n_launches = 0
    pam_try_eval.n_launches = pam_try_commit.n_launches = 0


def scale_point():
    """The 100,000-state scale point (benchmarks/scale_points.py): the
    counts of sparse_metastable_counts, ``(T, pi)`` by the port's
    transpose builder, and the symmetrized ``S = D^1/2 T D^-1/2`` built
    here with scipy for the oracles."""
    C = sparse_metastable_counts(SCALE_STATES, n_blocks=SCALE_BLOCKS,
                                 seed=SCALE_SEED)
    _, T, pi = builders.transpose(C)
    T, pi = scipy.sparse.csr_matrix(T), np.asarray(pi)
    return T, pi, symmetrized(T, pi)


def symmetrized(T, pi):
    sq = np.sqrt(pi)
    S = scipy.sparse.diags(sq) @ T @ scipy.sparse.diags(1.0 / sq)
    return ((S + S.T) * 0.5).tocsr().astype(np.float64)


def oracle_eigs(S, k):
    """Top-``k`` eigenvalues of S by host ARPACK, descending."""
    w = scipy.sparse.linalg.eigsh(S, k=k, which='LA',
                                  return_eigenvectors=False)
    return np.sort(w)[::-1]


def ell_shape(device, cols_h, vals_h, k, seed, what):
    """Kernel 6 against its plain version on the card at one shape:
    ``Y`` equal bit for bit (shift 0 and shift 0.25), the launch counter
    grown by the launches made; then timed in turns plain, kernel,
    kernel, plain, beside ``torch.sparse.mm`` of the same matrix in CSR
    form (held to 2 w eps32 (|A| @ |X|)). Returns a dict of the
    numbers and a line."""
    n, w = cols_h.shape
    cols = torch.as_tensor(cols_h, device=device)
    vals = torch.as_tensor(vals_h, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, k), generator=gen, device=device)
    n0 = ell_spmm_kernel.n_launches
    Yk = ell_spmm_kernel(cols, vals, X)
    Yk2 = ell_spmm_kernel(cols, vals, X, shift=0.25)
    torch.cuda.synchronize()
    check(ell_spmm_kernel.n_launches == n0 + 2,
          'ell_spmm launch count did not grow by 2')
    Yp = ell_spmm_plain(cols, vals, X)
    check(bool(torch.isfinite(Yk).all()), '%s: non-finite values' % what)
    check(torch.equal(Yk, Yp), '%s: kernel differs from plain' % what)
    check(torch.equal(Yk2, ell_spmm_plain(cols, vals, X, shift=0.25)),
          '%s: kernel differs from plain with a shift' % what)
    max_abs_err = float((Yk - Yp).abs().max())

    # copies: eliminate_zeros compacts the arrays it was given in place
    csr = scipy.sparse.csr_matrix(
        (vals_h.ravel().copy(), cols_h.ravel().copy(),
         np.arange(0, n * w + 1, w)), shape=(n, n))
    csr.eliminate_zeros()
    csr.sort_indices()
    A = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int64)),
        torch.as_tensor(csr.indices.astype(np.int64)),
        torch.as_tensor(csr.data), size=(n, n),
        check_invariants=True).to(device)
    Yl = torch.sparse.mm(A, X)
    bar = 2 * w * np.finfo(np.float32).eps * torch.sparse.mm(
        torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(),
                                A.values().abs(), size=(n, n)), X.abs())
    check(bool(((Yl - Yp).abs() <= bar).all()),
          '%s: torch.sparse.mm outside 2 w eps32 (|A| @ |X|)' % what)
    del Yk, Yk2, Yp, Yl, bar

    fns = {'kernel': lambda: ell_spmm_kernel(cols, vals, X),
           'plain': lambda: ell_spmm_plain(cols, vals, X),
           'library': lambda: torch.sparse.mm(A, X)}
    reps = {'kernel': 50, 'plain': 5, 'library': 50}
    for fn in fns.values():
        fn()                                       # warm-up
    n1 = ell_spmm_kernel.n_launches
    times = [reps_ms(fns[name], reps[name])
             for name in ('plain', 'kernel', 'kernel', 'plain')]
    lib_ms = reps_ms(fns['library'], reps['library'])
    check(ell_spmm_kernel.n_launches == n1 + 2 * reps['kernel'],
          'ell_spmm launch count did not grow by the launches made')
    ms, plain_ms = min(times[1:3]), min(times[0], times[3])
    n_bytes = 4 * (2 * n * w + 2 * n * k)
    bound_ms, bound_by = bound(n_bytes, 2 * csr.nnz * k)
    slots = int(np.count_nonzero(vals_h))
    line = ('%s: n %d, w %d, k %d, nnz %d: kernel equal to plain bit for '
            'bit (shift 0 and 0.25); nonzero slots %d of n*w %d (%.1f%%); '
            'ms per product kernel %.4f (%.4g bytes/s of the bound\'s '
            'bytes), plain %.4f, torch.sparse.mm %.4f, bound %.4f (%s) '
            '(turns plain, kernel, kernel, plain: %s)'
            % (what, n, w, k, csr.nnz, slots, n * w, 100.0 * slots / (n * w),
               ms, n_bytes / (ms * 1e-3), plain_ms, lib_ms, bound_ms,
               bound_by, ', '.join('%.4f' % t for t in times)))
    return {'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': lib_ms}, line


def eigensolve_path(T, pi, S, card):
    """Phase 7a: the scale point through eigenspectrum_reversible with
    method 'auto' and no device named, with its checks against host
    ARPACK. Returns the kernel-6 launches of the solve."""
    reset_launches()
    t = time.perf_counter()
    vals, vecs, info = eigenspectrum_reversible(
        T, pi=pi, n_eigs=SCALE_EIGS, method='auto', return_info=True)
    t_solve = time.perf_counter() - t
    launches = ell_spmm_kernel.n_launches
    check(kcenters_chunk.n_launches == 0 and
          qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == 0,
          'the eigensolve launched a clustering kernel')
    check(info['method'] == 'filtered', 'auto took %r' % info['method'])
    check(not info['fallback'], 'the filtered solve fell back')
    check(launches > 0, 'the filtered solve launched no ell_spmm kernel')
    res = float(np.max(info['residuals']))
    check(res < 1e-9, 'max residual %g' % res)
    t = time.perf_counter()
    w_ref = oracle_eigs(S, SCALE_EIGS)
    t_oracle = time.perf_counter() - t
    eig_err = float(np.abs(vals - w_ref).max())
    pi_err = float(np.abs(vecs[:, 0] - pi).max())
    check(eig_err < 1e-10, 'eigenvalues differ from ARPACK by %g' % eig_err)
    check(pi_err < 1e-9, 'vecs[:, 0] differs from pi by %g' % pi_err)
    # a warm solve with stage 1 broken down: the host ELL build, the
    # device sweeps (each ends in a host read of its Ritz values)
    with Stage(eigen_device, 'bucketed_ell') as ell_build, \
            Stage(eigen_device, '_filter_sweep') as sweeps:
        t = time.perf_counter()
        info_w = eigenspectrum_reversible(T, pi=pi, n_eigs=SCALE_EIGS,
                                          method='auto', return_info=True)[2]
        t_warm = time.perf_counter() - t
    print('scale point: %d states, %d nonzeros, top %d modes by %r: max '
          'residual %.3g, eigenvalues within %.3g of host ARPACK, vecs[:, 0]'
          ' within %.3g of pi; %d ell_spmm launches'
          % (T.shape[0], T.nnz, SCALE_EIGS, info['method'], res, eig_err,
             pi_err, launches))
    print('[%s] solve %.4f s (stage 1 on the card %.3f s: %d sweeps, block '
          '%d, grown %d, ELL %d x %d; stage 2 on the host %.3f s: %d '
          'sweeps); host ARPACK oracle %.4f s'
          % (card, t_solve, info['stage1_s'], info['stage1_sweeps'],
             info['stage1_block'], info['stage1_grown'],
             info['stage1_n_padded'], info['stage1_w_padded'],
             info['stage2_s'], info['refine_sweeps'], t_oracle))
    print('[%s] warm solve %.4f s: stage 1 %.3f s, of which host ELL build '
          '%.4f s and %d device sweeps %.4f s (the rest: symmetrizing S, the '
          'random start block, uploads); stage 2 %.3f s'
          % (card, t_warm, info_w['stage1_s'], ell_build.seconds,
             sweeps.calls, sweeps.seconds, info_w['stage2_s']), flush=True)
    return launches


def kmc_assignments(T, rng):
    """ITS_CHAINS kinetic Monte Carlo chains of ITS_STEPS states over the
    sparse row-stochastic T, vectorised over the chains on the host, an
    equal share started in each well."""
    T = T.tocsr()
    cum = np.cumsum(T.data)
    before = np.concatenate([[0.0], cum])[T.indptr[:-1]]
    total = cum[T.indptr[1:] - 1] - before
    well = np.arange(ITS_CHAINS) % ITS_WELLS
    s = well * ITS_WELL_STATES + rng.integers(0, ITS_WELL_STATES,
                                              ITS_CHAINS)
    out = np.empty((ITS_CHAINS, ITS_STEPS), np.int64)
    out[:, 0] = s
    for t in range(1, ITS_STEPS):
        idx = np.searchsorted(cum, before[s] + rng.random(ITS_CHAINS)
                              * total[s], side='right')
        s = T.indices[np.minimum(idx, T.indptr[s + 1] - 1)]
        out[:, t] = s
    return out


def its_counts(rng):
    """The counts behind phase 7b's KMC: sparse_metastable_counts of
    ITS_WELLS wells, plus ITS_LINKS links of ITS_LINK_COUNTS counts
    between each pair of consecutive wells, so that the chains cross
    wells in ITS_STEPS steps and the slowest ITS_WELLS modes stand apart
    from each well's bulk."""
    n = ITS_WELLS * ITS_WELL_STATES
    C = sparse_metastable_counts(n, n_blocks=ITS_WELLS, seed=SCALE_SEED)
    b = np.repeat(np.arange(ITS_WELLS - 1), ITS_LINKS)
    src = b * ITS_WELL_STATES + rng.integers(0, ITS_WELL_STATES, b.size)
    dst = (b + 1) * ITS_WELL_STATES + rng.integers(0, ITS_WELL_STATES,
                                                   b.size)
    links = scipy.sparse.coo_matrix(
        (np.full(b.size, ITS_LINK_COUNTS), (src, dst)), shape=(n, n))
    return (C + links + links.T).tocsr()


def its_path(card):
    """Phase 7b: implied_timescales_device with the transpose builder at
    ITS_LAGS on KMC assignments, every lag on the filtered solver; each
    lag's eigenvalues held to host ARPACK of the same S. Returns the
    kernel-6 launches of the run."""
    n = ITS_WELLS * ITS_WELL_STATES
    rng = np.random.default_rng(SCALE_SEED)
    _, T, _ = builders.transpose(its_counts(rng))
    t = time.perf_counter()
    assigns = kmc_assignments(scipy.sparse.csr_matrix(T), rng)
    t_kmc = time.perf_counter() - t
    n_seen = np.unique(assigns).size
    check(n_seen == n and n > 4096, '%d of %d states visited' % (n_seen, n))

    calls = []
    real = eigen_device.eigenspectrum_reversible

    def recording(T, pi=None, **kw):
        k0 = ell_spmm_kernel.n_launches
        vals, vecs, info = real(T, pi=pi, return_info=True, **kw)
        calls.append((T, pi, vals, info, ell_spmm_kernel.n_launches - k0))
        return vals, vecs

    reset_launches()
    eigen_device.eigenspectrum_reversible = recording
    try:
        t = time.perf_counter()
        ts = implied_timescales_device(assigns, ITS_LAGS, builders.transpose,
                                       n_times=ITS_TIMES)
        t_its = time.perf_counter() - t
    finally:
        eigen_device.eigenspectrum_reversible = real
    launches = ell_spmm_kernel.n_launches
    check(ts.shape == (len(ITS_LAGS), ITS_TIMES), 'timescales %s'
          % (ts.shape,))
    check(len(calls) == len(ITS_LAGS), '%d reversible solves for %d lags'
          % (len(calls), len(ITS_LAGS)))
    errs = []
    for lag, (T_l, pi_l, vals, info, k) in zip(ITS_LAGS, calls):
        check(info['method'] == 'filtered' and not info['fallback'],
              'lag %d: %r, fallback %r' % (lag, info['method'],
                                           info['fallback']))
        check(k > 0, 'lag %d launched no ell_spmm kernel' % lag)
        check(float(np.max(info['residuals'])) < 1e-9,
              'lag %d: residual %g' % (lag, np.max(info['residuals'])))
        w_ref = oracle_eigs(symmetrized(scipy.sparse.csr_matrix(T_l),
                                        np.asarray(pi_l)), ITS_TIMES + 1)
        errs.append(float(np.abs(vals - w_ref).max()))
        check(errs[-1] < 1e-10, 'lag %d: eigenvalues differ from ARPACK '
              'by %g' % (lag, errs[-1]))
    n_unit = [int(np.sum(np.abs(c[2] - 1.0) < 1e-12)) for c in calls]
    print('implied timescales: %d chains x %d steps over %d states (%d '
          'wells), lags %s by %s, fallback %s: eigenvalues within %s of '
          'host ARPACK; eigenvalues within 1e-12 of 1 per lag %s; slowest '
          'timescale per lag %s; ell_spmm launches per lag %s'
          % (ITS_CHAINS, ITS_STEPS, n, ITS_WELLS, list(ITS_LAGS),
             [c[3]['method'] for c in calls],
             [c[3]['fallback'] for c in calls],
             ', '.join('%.3g' % e for e in errs), n_unit,
             ', '.join('%.6g' % x for x in ts[:, 0]),
             [c[4] for c in calls]))
    print('[%s] KMC %.3f s (host); implied_timescales_device %.4f s for %d '
          'lags (stage 1 %s s, stage 2 %s s)'
          % (card, t_kmc, t_its, len(ITS_LAGS),
             [c[3]['stage1_s'] for c in calls],
             [c[3]['stage2_s'] for c in calls]), flush=True)
    return launches


def queued_ms(fn, reps):
    """Device time of one call of ``fn`` in ms: CUDA events around
    ``reps`` calls queued behind a spin of the card, so that the host's
    launch overhead leaves no gap in the timeline. Only for functions
    that never wait for the card."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)             # ~25 ms of the card's clock
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase1_data():
    """Phase 1's basin data: 65,536 frames x 64 atoms, 256 basins, seed
    0."""
    return basin_data(np.random.default_rng(0), CHECK_FRAMES, N_ATOMS,
                      n_basins=256)


def one(v, dtype, device):
    return torch.full((1, 1), v, dtype=dtype, device=device)


def iteration_case(sh, state, col, gc, cid, md, bar):
    """Kernels 3 and 4 against their plain versions, each from a copy of
    one shard state ``(dist, assig, tmax)``, against the center with
    column ``col``, G ``gc`` and id ``cid`` chosen at the global max
    ``md``. Distances on the msd bar; assignments equal but for near
    ties (one side took the new center, the other kept its own, at
    distances within the msd bar); each kernel's tmax, (lmax, largmax)
    and skipcnt exactly what its own output distances and the skip rule
    give; with md = inf, kernel 3 and kernel 4 bit for bit. Returns the
    numbers of the case."""
    cvec = col.view(3, -1).t().contiguous()
    n_tiles = sh.frames_r.shape[1] // sh.tile
    out = {}
    for name, fn in (('k4', kcenters_iteration_skip),
                     ('p4', kcenters_iteration_skip_plain)):
        d, a, t = (x.clone() for x in state)
        out[name] = [x.cpu().numpy() for x in fn(
            sh.frames_r, sh.g, d, a, t, col, gc, cid, md, sh.n_atoms,
            tile=sh.tile)]
    for name, fn in (('k3', kcenters_iteration),
                     ('p3', kcenters_iteration_plain)):
        d, a = state[0].clone(), state[1].clone()
        out[name] = [x.cpu().numpy() for x in fn(
            sh.frames_r, sh.g, d, a, cvec, gc, cid, sh.n_atoms,
            tile=sh.tile, with_argmax=True)]
    cid_h, md_h = int(cid), float(md)
    flips, errs = 0, []
    for k, p in (('k4', 'p4'), ('k3', 'p3')):
        check(rmsd_close(out[k][0], out[p][0], bar),
              'kernel %s: distances outside the msd bar' % k[1])
        f = out[k][1] != out[p][1]
        check(bool(((out[k][1][f] == cid_h) | (out[p][1][f] == cid_h))
                   .all()), 'kernel %s: assignments differ beyond near '
              'ties' % k[1])
        flips += int(f.sum())
        fin = np.isfinite(out[p][0])
        errs.append(float(np.abs(out[k][0][fin] - out[p][0][fin]).max()))
    for k, (lm, la) in (('k4', (3, 4)), ('k3', (2, 3))):
        dk = out[k][0][0]
        check(out[k][lm][0, 0] == dk.max() and
              int(out[k][la][0, 0]) == int(np.argmax(dk)),
              'kernel %s: (lmax, largmax) differ from its distances' % k[1])
    check(np.array_equal(out['k4'][2][0, :n_tiles],
                         out['k4'][0][0].reshape(n_tiles, -1).max(1)),
          'kernel 4: tmax differs from its distances')
    tm_in = state[2][0, :n_tiles].cpu().numpy()
    rule = int(((tm_in <= 0.5 * md_h) & np.isfinite(md_h)).sum())
    check(int(out['k4'][5][0, 0]) == rule == int(out['p4'][5][0, 0]),
          'skipcnt %d / plain %d, the rule gives %d'
          % (out['k4'][5][0, 0], out['p4'][5][0, 0], rule))
    same = all(np.array_equal(out['k4'][j], out['k3'][k])
               for j, k in ((0, 0), (1, 1), (3, 2), (4, 3)))
    check(same or np.isfinite(md_h), 'kernels 3 and 4 differ with md = inf')
    return {'skipped': rule, 'tiles': n_tiles, 'flips': flips,
            'same': same, 'err4': errs[0], 'err3': errs[1]}


def shard_kernels(sh, device, card, what=''):
    """Kernels 3 and 4 against their plain versions at one shard ``sh``
    (from the state 8 plain iterations leave, against this shard's
    farthest frame), with the finite md that chose the center and with
    md = inf; then timed in turns at md = inf. ``what`` names the frame
    type in the printed lines. Returns the kernels' numbers."""
    n_local, tile = sh.frames_r.shape[1], sh.tile
    rows = sh.frames_r.shape[0]
    bar = bar_from(2 * float(sh.g.max()), N_ATOMS)
    dist = torch.full((1, n_local), float('inf'), device=device)
    dist[0, sh.n:] = -float('inf')
    assig = torch.full((1, n_local), -1, dtype=torch.int32, device=device)
    tmax = tile_summaries(dist, tile, skip_t_pad(n_local // tile))

    def center(k):
        gi = int(torch.argmax(dist[0]))
        return (sh.frames_r[:, gi:gi + 1].float().contiguous(),
                sh.g[:, gi:gi + 1].contiguous(), one(k, torch.int32, device),
                one(float(dist[0, gi]), torch.float32, device))
    for k in range(8):
        kcenters_iteration_skip_plain(sh.frames_r, sh.g, dist, assig, tmax,
                                      *center(k), N_ATOMS, tile=tile)
    col, gc, cid, md = center(8)
    md_inf = one(float('inf'), torch.float32, device)
    state = (dist, assig, tmax)
    n4, n3 = kcenters_iteration_skip.n_launches, kcenters_iteration.n_launches
    fin = iteration_case(sh, state, col, gc, cid, md, bar)
    inf = iteration_case(sh, state, col, gc, cid, md_inf, bar)
    torch.cuda.synchronize()
    check(kcenters_iteration_skip.n_launches == n4 + 2 and
          kcenters_iteration.n_launches == n3 + 2,
          'phase 8 launch counts did not grow by the launches made')
    print('%s%d x %d shard, center %d at md %.6g: kernels vs plain within '
          'the msd bar, near-tie flips %d / %d (md finite / inf), tiles '
          'skipped %d / %d of %d, kernel 3 == kernel 4 bit for bit: %s / %s;'
          ' max |kernel - plain| kernel 4 %.3g, kernel 3 %.3g'
          % (what, n_local, N_ATOMS, int(torch.argmax(dist[0])), float(md),
             fin['flips'], inf['flips'], fin['skipped'], inf['skipped'],
             fin['tiles'], fin['same'], inf['same'], inf['err4'],
             inf['err3']), flush=True)

    # timed at md = inf (every tile read), the full stream of a shard
    cvec = col.view(3, -1).t().contiguous()
    work = [x.clone() for x in state]
    fns = {
        'k4': lambda: kcenters_iteration_skip(
            sh.frames_r, sh.g, *work, col, gc, cid, md_inf, N_ATOMS,
            tile=tile),
        'p4': lambda: kcenters_iteration_skip_plain(
            sh.frames_r, sh.g, *work, col, gc, cid, md_inf, N_ATOMS,
            tile=tile),
        'k3': lambda: kcenters_iteration(
            sh.frames_r, sh.g, work[0], work[1], cvec, gc, cid, N_ATOMS,
            tile=tile, with_argmax=True),
        'p3': lambda: kcenters_iteration_plain(
            sh.frames_r, sh.g, work[0], work[1], cvec, gc, cid, N_ATOMS,
            tile=tile, with_argmax=True)}
    for fn in fns.values():
        fn()                                       # warm-up
    times = {}
    for k in ('4', '3'):
        times[k] = [reps_ms(fns['p' + k], 5) if turn == 'plain'
                    else queued_ms(fns['k' + k], ITER_TIMED)
                    for turn in ('plain', 'kernel', 'kernel', 'plain')]
    work = [x.clone() for x in state]
    ms_fin = queued_ms(lambda: kcenters_iteration_skip(
        sh.frames_r, sh.g, *work, col, gc, cid, md, N_ATOMS, tile=tile),
        ITER_TIMED)
    # per call: the frames (2 or 4 bytes a coordinate), G, and dist and
    # assig read and written; 9 fp32 FMAs per frame and atom row triple
    it_bound = bound(sh.frames_r.element_size() * rows * n_local
                     + 4 * 5 * n_local, 2 * 3 * rows * n_local)
    nums = {}
    for k, name in (('4', 'kernel 4'), ('3', 'kernel 3')):
        t = times[k]
        nums[k] = {'max_abs_err': inf['err' + k], 'ms': min(t[1:3]),
                   'plain_ms': min(t[0], t[3]), 'bound_ms': it_bound[0],
                   'bound_by': it_bound[1], 'library_ms': None}
        print('[%s] %s%s per call at %d x %d, md = inf: kernel %.4f ms, '
              'plain %.4f ms, bound %.4f ms (%s) (turns plain, kernel, '
              'kernel, plain: %s)' % (card, what, name, n_local, N_ATOMS,
                                      nums[k]['ms'], nums[k]['plain_ms'],
                                      it_bound[0], it_bound[1],
                                      ', '.join('%.4f' % x for x in t)),
              flush=True)
    print('[%s] %skernel 4 per call at the finite md, %d calls from the '
          'same state: %.4f ms' % (card, what, ITER_TIMED, ms_fin),
          flush=True)
    return nums


def iteration_kernels(device, X, card):
    """Phase 8: kernels 3 and 4 against their plain versions at one
    250,112 x 64 shard of phase 9's layout (:func:`shard_kernels`) and at
    phase 1's basin data cut into 4 shards (from the state 128 chunk
    iterations leave, against the next center), each with the finite md
    that chose the center and with md = inf. Returns the kernels'
    numbers."""
    mesh = FrameMesh((device,) * N_SHARDS)
    prep = engine.prepare_rmsd_frames(X, mesh=mesh)
    nums = shard_kernels(prep.shards[0], device, card)
    del prep

    # phase 1's basin data in 4 shards, against the 129th center
    Xb = phase1_data()
    prep = engine.prepare_rmsd_frames(Xb, device=device)
    st = fresh_state(prep)
    kcenters_chunk(prep, st, CHECK_CENTERS)
    gidx, md_b, i = st.scalars()
    bar = msd_bar(prep)
    col = prep.frames_r[:, gidx:gidx + 1].contiguous()
    gc = prep.g[:, gidx:gidx + 1].contiguous()
    n_loc = CHECK_FRAMES // N_SHARDS
    t_pad = skip_t_pad(n_loc // prep.tile)
    skipped, flips, tiles = {}, 0, 0
    for mdv in (md_b, float('inf')):
        skipped[mdv] = 0
        for s in range(N_SHARDS):
            lo, hi = s * n_loc, (s + 1) * n_loc
            shs = engine.PreparedRMSDFrames(
                prep.frames_r[:, lo:hi].contiguous(),
                prep.g[:, lo:hi].contiguous(), n_loc, N_ATOMS, prep.tile)
            d = st.dist[:, lo:hi].contiguous()
            c = iteration_case(
                shs, (d, st.assig[:, lo:hi].contiguous(),
                      tile_summaries(d, prep.tile, t_pad)),
                col, gc, one(i, torch.int32, device),
                one(mdv, torch.float32, device), bar)
            skipped[mdv] += c['skipped']
            flips += c['flips']
            tiles += c['tiles']
    check(skipped[md_b] > 0 and skipped[float('inf')] == 0,
          'basin shards: %d tiles skipped at md %r' % (skipped[md_b], md_b))
    print('%d x %d basin data in %d shards, center %d (the %dth) at md '
          '%.6g: kernels vs plain within the msd bar in every shard, %d '
          'near-tie flips; %d of %d tiles skipped at the finite md, 0 at '
          'md = inf' % (CHECK_FRAMES, N_ATOMS, N_SHARDS, gidx, i + 1, md_b,
                        flips, skipped[md_b], tiles // 2), flush=True)
    return nums


def loop_profile(X, mesh, card, report=True):
    """Where an iteration of the sharded loop goes on the card: two runs
    of 64 and 128 centers from the same prepared frames under
    torch.profiler (CUDA activity), each after a warm-up, and their
    difference over 64 iterations: the launches and device ms of kernel 4
    and of everything else (the collectives' torch ops), the wall ms,
    and the share of it that no compute kernel runs (idle). NCCL's
    kernels spin while they wait for the other processes, so their
    device time varies from run to run: theirs is the 128-center run's
    over its iterations, apart from the rest. Over a mesh that spans
    processes every process runs the same loops and only the one with
    ``report`` profiles them. Returns the figures (None when not
    measured)."""
    from torch.profiler import ProfilerActivity, profile

    def window():
        return profile(activities=[ProfilerActivity.CUDA]) if report \
            else contextlib.nullcontext()
    prep = engine.prepare_rmsd_frames(X, mesh=mesh)
    # one profiled run first: the profiler's first window costs extra
    # host time, which made the shorter run the slower one
    with window():
        engine.kcenters_device_fused(prep, n_clusters=CHUNK_CENTERS,
                                     mesh=mesh)
        torch.cuda.synchronize()
    runs = {}
    for k in (CHUNK_CENTERS, 2 * CHUNK_CENTERS):
        engine.kcenters_device_fused(prep, n_clusters=k, mesh=mesh)
        torch.cuda.synchronize()
        with window() as prof:
            t = time.perf_counter()
            engine.kcenters_device_fused(prep, n_clusters=k, mesh=mesh)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        if not report:
            continue
        parts = {'kern': [0, 0.0], 'nccl': [0, 0.0], 'other': [0, 0.0]}
        for e in prof.key_averages():
            us = getattr(e, 'device_time_total', None)
            if us is None:
                us = getattr(e, 'cuda_time_total', 0.0)
            if us > 0:
                part = parts['kern' if 'kc_iter_skip' in e.key else
                             'nccl' if 'nccl' in e.key.lower() else 'other']
                part[0] += e.count
                part[1] += us / 1e3
        runs[k] = [wall] + [v for p in parts.values() for v in p]
    if not report:
        return None
    a, b = runs.values()
    per = dict(zip(('wall_ms', 'k4_launches', 'k4_ms', 'nccl_launches',
                    'nccl_ms', 'other_launches', 'other_ms'),
                   ((y - x) / CHUNK_CENTERS for x, y in zip(a, b))))
    per['nccl_launches'], per['nccl_ms'] = (v / (2 * CHUNK_CENTERS)
                                            for v in b[3:5])
    busy = per['k4_ms'] + per['other_ms']
    if per['k4_ms'] <= 0:
        print('[%s] sharded loop profile: the profiler saw no device time '
              '(not measured)' % card, flush=True)
        return None
    if per['wall_ms'] < busy:
        print('[%s] sharded loop profile: wall %.4f ms an iteration below '
              'its device time %.4f ms, the two runs\' host times too noisy '
              '(idle share not measured)' % (card, per['wall_ms'], busy),
              flush=True)
        return None
    per['idle'] = 1 - busy / per['wall_ms']
    print('[%s] sharded loop per iteration (torch.profiler, %d-center '
          'runs minus %d-center runs): wall %.4f ms; kernel 4 %.2f launches, '
          '%.4f ms on the card; other ops (the collectives) %.2f launches, '
          '%.4f ms on the card; card idle %.1f%%; NCCL kernels (the '
          '128-center run, waits included) %.2f launches, %.4f ms'
          % (card, 2 * CHUNK_CENTERS, CHUNK_CENTERS, per['wall_ms'],
             per['k4_launches'], per['k4_ms'], per['other_launches'],
             per['other_ms'], 100 * per['idle'], per['nccl_launches'],
             per['nccl_ms']), flush=True)
    return per


def sharded_path(device, X, single, t_single, card, mesh=None):
    """Phase 9: the sharded path through the public entry points on
    ``mesh`` (default: a 4-shard mesh of the card), with its checks
    against phase 2's single-device result ``single`` (cluster seconds
    ``t_single``). Returns the launches of kernels 3 and 4 on their
    paths and, under 'result', the mesh's outputs: center indices,
    assignments, distances, assign_device's labels and distances, the
    batched timescales, and the basin data's center indices."""
    mesh = mesh or FrameMesh((device,) * N_SHARDS)
    Xc2 = (X * X).sum(dim=(1, 2))
    bar = bar_from(2 * float(Xc2.max()), N_ATOMS)
    del Xc2

    # kernel 3's path: the sharded loop with tri_skip=False (the warm-up)
    reset_launches()
    t = time.perf_counter()
    off = engine.kcenters_device_fused(X, n_clusters=N_CLUSTERS, mesh=mesh,
                                       tri_skip=False)
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t
    k3_launches = kcenters_iteration.n_launches
    check(k3_launches > 0 and kcenters_iteration_skip.n_launches == 0,
          'tri_skip=False: %d kernel 3 and %d kernel 4 launches'
          % (k3_launches, kcenters_iteration_skip.n_launches))

    # the main path
    reset_launches()
    with Stage(engine, 'prepare_rmsd_frames') as prep_st, \
            Stage(engine, 'kcenters_device_fused') as clu:
        res = kcenters(X, 'rmsd', n_clusters=N_CLUSTERS, mesh=mesh)
    a = np.asarray(res.assignments).reshape(100, -1)
    t = time.perf_counter()
    counts = assigns_to_counts_sharded(a, np.ones_like(a, bool), LAG,
                                       N_CLUSTERS, mesh=mesh)
    torch.cuda.synchronize()
    t_co = time.perf_counter() - t
    t = time.perf_counter()
    _, vals, vecs = transpose_timescales_device(counts, N_EIGS, lag_time=LAG)
    t_eig = time.perf_counter() - t
    centers = np.stack(res.centers)
    with Stage(engine, 'assign_device') as asg:
        a_m, d_m = engine.assign_device(X, centers, 'rmsd', mesh=mesh)
    t = time.perf_counter()
    its_m = implied_timescales_batched(a, SHARDED_LAGS, n_times=N_EIGS - 1,
                                       mesh=mesh)
    t_its = time.perf_counter() - t
    k4_launches = kcenters_iteration_skip.n_launches
    qcp_launches = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    check(k4_launches > 0 and kcenters_iteration.n_launches == 0 and
          kcenters_chunk.n_launches == 0 and ell_spmm_kernel.n_launches == 0,
          'sharded path: kernel 4 %d, kernel 3 %d, kernel 1 %d, kernel 6 %d '
          'launches' % (k4_launches, kcenters_iteration.n_launches,
                        kcenters_chunk.n_launches,
                        ell_spmm_kernel.n_launches))
    check(asg.qcp > 0, 'the sharded assignment launched no qcp kernel')

    # -- checks --
    ctr = np.asarray(res.center_indices)
    check(len(ctr) == N_CLUSTERS and clu.result.n_found == N_CLUSTERS and
          off.n_found == N_CLUSTERS, 'n_found %d' % clu.result.n_found)
    check(np.array_equal(off.center_indices, ctr) and
          np.array_equal(off.assignments, res.assignments) and
          np.array_equal(off.distances, res.distances),
          'tri_skip=False (kernel 3) differs from tri_skip=True (kernel 4)')
    diff = np.flatnonzero(ctr != single.center_indices)
    if len(diff) == 0:
        check(rmsd_close(res.distances, single.distances, bar),
              'sharded distances outside the msd bar of phase 2')
        flips = int((res.assignments != single.assignments).sum())
        verdict = ('first divergence from phase 2: none; distances within '
                   'the msd bar, %d near-tie assignment flips' % flips)
    else:
        i = int(diff[0])
        ca, cb = int(ctr[i]), int(single.center_indices[i])
        before = engine.kcenters_device_fused(X, n_clusters=i, mesh=mesh)
        da, db = before.distances[ca], before.distances[cb]
        check(abs(da * da - db * db) <= bar(max(da, db)),
              'pick %d differs from phase 2 (%d vs %d) without a near tie: '
              '%r vs %r' % (i, ca, cb, da, db))
        verdict = ('first divergence from phase 2: pick %d (%d vs %d, '
                   '%.9g vs %.9g, a near tie)' % (i, ca, cb, da, db))
    rs, r1 = float(res.distances.max()), float(single.distances.max())
    check(abs(rs - r1) <= 1e-5 * r1, 'covering radius %r vs phase 2 %r'
          % (rs, r1))
    ref_counts = np.bincount(
        (a[:, :-LAG] * N_CLUSTERS + a[:, LAG:]).ravel(),
        minlength=N_CLUSTERS ** 2).reshape(N_CLUSTERS, N_CLUSTERS)
    counts_h = counts.cpu().numpy()
    check(np.array_equal(counts_h, ref_counts),
          'sharded counts differ from numpy')
    w_ref, pi_ref = host_eigs(counts_h)
    eig_err = float(np.abs(vals - w_ref).max())
    check(eig_err < 1e-4, 'eigenvalues differ by %g' % eig_err)
    a_1, d_1 = engine.assign_device(X, centers, 'rmsd')
    check(np.array_equal(a_m, a_1) and np.array_equal(d_m, d_1),
          'assign_device(mesh=) differs from one device')
    its_1 = implied_timescales_batched(a, SHARDED_LAGS, n_times=N_EIGS - 1)
    check(its_m.shape == (len(SHARDED_LAGS), N_EIGS - 1) and
          np.array_equal(its_m, its_1, equal_nan=True),
          'batched timescales with the mesh differ from those without')
    its_err = 0.0
    for k, lag in enumerate(SHARDED_LAGS):
        c = assigns_to_counts_device(a, np.ones_like(a, bool), lag,
                                     N_CLUSTERS, device=device)
        w = transpose_timescales_device(c, N_EIGS, lag_time=lag)[1][1:]
        # a NaN timescale stands for an eigenvalue at or below 0
        nan = np.isnan(its_m[k])
        check(bool((w[nan] <= 1e-4).all()), 'lag %d: NaN timescales for '
              'eigenvalues %s' % (lag, w[nan]))
        its_err = max(its_err, float(np.abs(
            np.exp(-lag / its_m[k][~nan]) - w[~nan]).max(initial=0.0)))
    check(its_err < 1e-4, 'batched eigenvalues differ from the per-lag '
          'solve by %g' % its_err)
    check(kcenters_chunk.n_launches == 0, 'phase 9 launched kernel 1')

    # phase 1's basin data: tri_skip on and off, with the skipped visits
    Xb = phase1_data()
    with Stage(engine, '_kcenters_loop_fused_sharded') as loop:
        on_b = engine.kcenters_device_fused(Xb, n_clusters=N_CLUSTERS,
                                            mesh=mesh)
        skipped = int(loop.result[0].skipped)
        n_local = loop.result[0].dist[0].shape[1]
    off_b = engine.kcenters_device_fused(Xb, n_clusters=N_CLUSTERS,
                                         mesh=mesh, tri_skip=False)
    check(all(np.array_equal(x, y) for x, y in zip(on_b, off_b)),
          'basin data: tri_skip on and off differ')
    check(skipped > 0, 'basin data: no tile visit skipped')
    visits = on_b.n_found * mesh.size * (n_local // engine.TILE)
    check(kcenters_chunk.n_launches == 0, 'phase 9 launched kernel 1')

    print('sharded path: %d frames x %d atoms on %d shards -> %d centers; '
          'tri_skip on and off bit-identical; %s; covering radius %.9g vs '
          '%.9g; lag-%d counts equal numpy; top-%d eigenvalues within %.2e of '
          'float64 numpy; assign_device(mesh=) equal to one device; batched '
          'timescales at lags %s with the mesh equal to those without, '
          'eigenvalues within %.2e of the per-lag solve'
          % (N_FRAMES, N_ATOMS, mesh.size, len(ctr), verdict, rs, r1, LAG,
             N_EIGS, eig_err, list(SHARDED_LAGS), its_err))
    print('basin data %d x %d on %d shards -> %d centers: tri_skip on and '
          'off bit-identical, %d of %d tile visits skipped'
          % (CHECK_FRAMES, N_ATOMS, mesh.size, on_b.n_found, skipped, visits))
    print('[%s] sharded: prepare %.4f s; cluster %.4f s (phase 2 single '
          'device %.4f s), tri_skip=False run %.4f s (prepare included); '
          'counts %.4f s; eigsolve %.4f s; assign_device %.4f s (%d qcp '
          'launches); batched timescales %.4f s; kernel 4 launches %d = %.2f '
          'per iteration, kernel 3 launches %d (tri_skip=False)'
          % (card, prep_st.seconds, clu.seconds, t_single, t_off, t_co,
             t_eig, asg.seconds, asg.qcp, t_its, k4_launches,
             k4_launches / N_CLUSTERS, k3_launches), flush=True)
    loop_profile(X, mesh, card)
    return {'qcp_update': k3_launches, 'kcenters_iteration_skip': k4_launches,
            'result': (ctr, res.assignments, res.distances, a_m, d_m, its_m,
                       on_b.center_indices)}


@contextlib.contextmanager
def on_the_host():
    """Host input runs on the CPU inside (``$ENSPARA_TPU_PLATFORM=cpu``):
    the float64 host references of phase 10."""
    old = os.environ.get('ENSPARA_TPU_PLATFORM')
    os.environ['ENSPARA_TPU_PLATFORM'] = 'cpu'
    try:
        yield
    finally:
        if old is None:
            del os.environ['ENSPARA_TPU_PLATFORM']
        else:
            os.environ['ENSPARA_TPU_PLATFORM'] = old


def host_transpose_eigs(labels, lag, n_states, k):
    """The top ``k`` eigenvalues of the transpose builder's T at ``lag``,
    in float64 on the host: numpy lag-pair counts, ``C + C^T``, and
    ``eigvalsh`` of its ``D^-1/2 (C + C^T) D^-1/2`` (the symmetrized T)."""
    pairs = labels[:, :-lag].astype(np.int64) * n_states + labels[:, lag:]
    C = np.bincount(pairs.ravel(), minlength=n_states ** 2).reshape(
        n_states, n_states).astype(np.float64)
    sym = C + C.T
    mass = sym.sum(axis=1)
    inv = np.where(mass > 0, 1.0 / np.sqrt(np.where(mass > 0, mass, 1.0)),
                   0.0)
    return np.linalg.eigvalsh(inv[:, None] * sym * inv[None, :])[::-1][:k]


def dense(M):
    return M.toarray() if scipy.sparse.issparse(M) else np.asarray(M)


def its_cli(labels, card):
    """Phase 10a: the implied CLI's ``run`` on the labels, once with its
    default flags (the batched path on the card), once with
    ``row_normalize`` (the host fan-out); the batched eigenvalues
    ``exp(-lag / ts)`` within 1e-4 of a float64 host solve of each lag.
    Returns a summary dict."""
    n_states = int(labels.max()) + 1
    argv = ['implied', '--assignments', '(phase 5, in memory)']
    args = its_app.process_command_line(argv + list(ITS_FLAGS))
    times = []
    for _ in range(2):                          # cold, then warm
        with Stage(its_app, 'implied_timescales_batched') as batched, \
                Stage(its_app, 'implied_timescales') as fanout:
            t = time.perf_counter()
            ts = its_app.run(labels, args)
            times.append(time.perf_counter() - t)
        check(batched.calls == 1 and fanout.calls == 0,
              'the implied CLI took %d batched and %d host runs'
              % (batched.calls, fanout.calls))
    lags = np.asarray(args.lag_times, np.float64)
    k = args.n_eigenvalues
    check(ts.shape == (len(lags), k) and bool(np.isfinite(ts).all())
          and bool((ts > 0).all()), 'batched timescales %s, not all finite '
          'and positive' % (ts.shape,))
    t = time.perf_counter()
    ref = np.array([host_transpose_eigs(labels, int(lag), n_states, k + 1)[1:]
                    for lag in lags])
    t_ref = time.perf_counter() - t
    eig_err = float(np.abs(np.exp(-lags[:, None] / ts) - ref).max())
    check(eig_err < 1e-4, 'batched eigenvalues differ from float64 by %g'
          % eig_err)

    hargs = its_app.process_command_line(argv + list(HOST_ITS_FLAGS))
    with Stage(its_app, 'implied_timescales_batched') as batched, \
            Stage(its_app, 'implied_timescales') as fanout:
        t = time.perf_counter()
        ts_h = its_app.run(labels, hargs)
        t_host = time.perf_counter() - t
    check(batched.calls == 0 and fanout.calls == 1,
          'row_normalize took %d batched and %d host runs'
          % (batched.calls, fanout.calls))
    check(ts_h.shape == (len(hargs.lag_times), k)
          and bool(np.isfinite(ts_h[:, 0]).all()),
          'host-path timescales %s' % (ts_h.shape,))
    print('implied CLI: %d lags (%s) x %d timescales over %d states by one '
          'batched solve on the card; eigenvalues within %.3g of float64; '
          'slowest timescale %.6g at lag %d, %.6g at lag %d; row_normalize '
          '(%d lags) on the host fan-out'
          % (len(lags), ITS_FLAGS[1], k, n_states, eig_err, ts[0, 0],
             lags[0], ts[-1, 0], lags[-1], len(hargs.lag_times)))
    print('[%s] implied CLI batched %.4f s cold, %.4f s warm; host '
          'row_normalize %.4f s; float64 host reference %.3f s'
          % (card, times[0], times[1], t_host, t_ref), flush=True)
    return {'its_s': times[1], 'its_host_s': t_host, 'its_err': eig_err}


def estimator(labels, card):
    """Phase 10b: ``MSM`` with the transpose builder and with
    ``builders.mle_device`` (trimmed, on the card) held to the host
    ``builders.mle`` at atol 5e-4; a save/load round trip, directory and
    zip. Returns the transpose MSM and a summary dict."""
    t = time.perf_counter()
    m = MSM(lag_time=MSM_LAG, method='transpose').fit(labels)
    t_fit = time.perf_counter() - t
    check(m.n_states_ == int(labels.max()) + 1 and
          bool(np.isfinite(m.eq_probs_).all()), 'transpose MSM')
    with Stage(builders, '_jacobi_mle') as sweeps, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        t = time.perf_counter()
        m_dev = MSM(lag_time=MSM_LAG, method=builders.mle_device,
                    trim=True).fit(labels)
        t_dev = time.perf_counter() - t
    warned = any(issubclass(w.category, ConvergenceWarning) for w in caught)
    check(sweeps.calls == 1, 'mle_device ran %d sweep loops' % sweeps.calls)
    n_sweeps = sweeps.result[1]
    t = time.perf_counter()
    m_host = MSM(lag_time=MSM_LAG, method='mle', trim=True).fit(labels)
    t_host = time.perf_counter() - t
    check(m_dev.mapping_ == m_host.mapping_, 'trim mappings differ')
    T_err = float(np.abs(dense(m_dev.tprobs_) - dense(m_host.tprobs_)).max())
    pi_err = float(np.abs(m_dev.eq_probs_ - m_host.eq_probs_).max())
    check(T_err <= 5e-4 and pi_err <= 5e-4, 'mle_device differs from the '
          'host mle by %g (T), %g (pi)' % (T_err, pi_err))
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        for name, zipped in (('msm', False), ('msm.zip', True)):
            m.save(os.path.join(d, name), zipfile=zipped)
            check(MSM.load(os.path.join(d, name)) == m,
                  'the %s round trip differs' % name)
        t_io = time.perf_counter() - t
    print('MSM at lag %d: transpose over %d states; mle_device (trim: %d '
          'states) %d sweeps%s, within %.3g (T) and %.3g (pi) of the host '
          'mle; save/load (directory and zip) equal'
          % (MSM_LAG, m.n_states_, m_dev.n_states_, n_sweeps,
             ', warned' if warned else ', no warning', T_err, pi_err))
    print('[%s] MSM transpose fit %.4f s; mle_device fit %.4f s, of which '
          'the sweeps %.4f s on the card; host mle fit %.4f s; save + load '
          'twice %.4f s' % (card, t_fit, t_dev, sweeps.seconds, t_host, t_io),
          flush=True)
    return m, {'mle_sweeps': n_sweeps, 'mle_warned': warned,
               'mle_s': t_dev, 'mle_T_err': T_err}


def bootstrap_bace(labels, card):
    """Phase 10c: MSMs(..., n_trials=BOOT_TRIALS, random_state=0) with
    replicate 0 held to a recount of its rows (fast=False), and BACE of
    the lag-MSM_LAG counts to BACE_STATES macrostates. Returns a summary
    dict."""
    kw = dict(lag_time=MSM_LAG, method='transpose', random_state=0)
    t = time.perf_counter()
    msms = MSMs(labels, n_trials=BOOT_TRIALS, **kw)
    t_boot = time.perf_counter() - t
    check(len(msms) == BOOT_TRIALS and all(
        bool(np.isfinite(x.eq_probs_).all()) for x in msms), 'bootstrap')
    first = MSMs(labels, n_trials=1, fast=False, **kw)[0]
    mismatch = (scipy.sparse.csr_matrix(first.tcounts_)
                != scipy.sparse.csr_matrix(msms[0].tcounts_))
    check(first.tcounts_.shape == msms[0].tcounts_.shape and not mismatch.nnz,
          'replicate 0 differs from a recount of its rows')
    C = assigns_to_counts(labels, lag_time=MSM_LAG)
    t = time.perf_counter()
    bf, macro = bace.bace(C, n_macrostates=BACE_STATES)
    t_bace = time.perf_counter() - t
    # the states pruned for too few counts are absorbed first and count
    # among the merges, as in the reference (enspara/msm/bace.py:45)
    n_pruned = C.shape[0] - bace.baysean_prune(C)[2].size
    kept = np.unique(macro[BACE_STATES][macro[BACE_STATES] >= 0])
    check(kept.size == BACE_STATES - n_pruned and bool(np.isfinite(
        list(bf.values())).all()), 'BACE left %d macrostates, %d states '
        'pruned' % (kept.size, n_pruned))
    print('bootstrap: %d MSMs at lag %d, replicate 0 equal to a recount of '
          'its rows; BACE %d -> %d macrostates (%d states pruned first), '
          'last Bayes factor %.6g'
          % (BOOT_TRIALS, MSM_LAG, C.shape[0], kept.size, n_pruned,
             bf[BACE_STATES]))
    print('[%s] bootstrap %.4f s (host); BACE %.4f s (host)'
          % (card, t_boot, t_bace), flush=True)
    return {'boot_s': t_boot, 'bace_s': t_bace}


def kmc(T, card):
    """Phase 10d: synthetic_trajectory_device from every state of T for
    KMC_STEPS steps on the card; the start column, every step an edge
    with T > 0, and, for each row visited at least 1,000 times, the
    empirical frequencies within 5 binomial sigma of T. The normal 5
    sigma bound holds for the entries whose expected count is at least
    100; the row's other entries are pooled into one bin (where the
    expected count is a few, the binomial's skew puts ~0.15 entries of
    this T beyond 5 sigma in a run of a correct sampler). Returns a
    summary dict."""
    Td = dense(T)
    n = Td.shape[0]
    start = np.arange(n)
    torch.cuda.synchronize()
    t = time.perf_counter()
    chains = synthetic_trajectory_device(T, start, KMC_STEPS)
    t_kmc = time.perf_counter() - t
    check(chains.shape == (n, KMC_STEPS) and chains.dtype == np.int32
          and np.array_equal(chains[:, 0], start), 'KMC chains %s %s'
          % (chains.shape, chains.dtype))
    src = chains[:, :-1].ravel().astype(np.int64)
    dst = chains[:, 1:].ravel()
    check(bool((Td[src, dst] > 0).all()), 'a KMC step took an edge with '
          'T = 0')
    freq = np.bincount(src * n + dst, minlength=n * n).reshape(n, n)
    visits = freq.sum(axis=1)
    rows = visits >= 1000
    v = visits[rows, None].astype(np.float64)
    big = v * Td[rows] >= 100
    # per row: the entries with large expected counts, then the rest pooled
    P = np.concatenate([np.where(big, Td[rows], 0.0), np.where(
        big, 0.0, Td[rows]).sum(axis=1, keepdims=True)], axis=1)
    F = np.concatenate([np.where(big, freq[rows], 0), np.where(
        big, 0, freq[rows]).sum(axis=1, keepdims=True)], axis=1)
    dev = np.abs(F / v - P)
    sigma = np.sqrt(P * (1 - P) / v)
    check(bool((dev <= 5 * sigma + 1e-12).all()),
          'KMC frequencies beyond 5 sigma of T')
    worst = float((dev[sigma > 0] / sigma[sigma > 0]).max())
    print('KMC: %d chains x %d steps on the card; every step an edge of T; '
          '%d rows visited >= 1,000 times: %d entries with >= 100 expected '
          'counts and each row\'s pooled rest within %.3g sigma of T (bar 5)'
          % (n, KMC_STEPS, int(rows.sum()), int(big.sum()), worst))
    print('[%s] KMC %.4f s (%.4g steps/s)'
          % (card, t_kmc, n * (KMC_STEPS - 1) / t_kmc), flush=True)
    return {'kmc_s': t_kmc}


def tpt_msm():
    """BASELINE config 4's MSM (benchmarks/reference_configs.py:226-245):
    a ring of TPT_STATES states with random shortcuts from
    RandomState(TPT_SEED) and a self count, row-normalized (not
    reversible)."""
    n = TPT_STATES
    rng = np.random.RandomState(TPT_SEED)
    rows = np.concatenate([np.arange(n), np.arange(n), np.arange(n)])
    cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n,
                           rng.randint(0, n, n)])
    vals = np.concatenate([np.full(n, 0.45), np.full(n, 0.45),
                           np.full(n, 0.10)])
    C = scipy.sparse.coo_matrix((vals, (rows, cols)), (n, n)).tocsr()
    C = C + scipy.sparse.eye(n) * 0.05
    return (scipy.sparse.diags(1.0 / np.asarray(C.sum(axis=1)).ravel())
            @ C).tocsr()


def tpt_path(device, card):
    """Phase 10e: committors and mfpts of BASELINE config 4 through the
    device LU with refinement (no stall), each within 1e-10 of a host
    sparse LU of the same absorbing system; net_fluxes and 10 paths equal
    to those of the float64 host path, fluxes to 1e-9 relative; the LU
    factorization timed on its own. Returns a summary dict."""
    T = tpt_msm()
    src, snk = np.array(TPT_SOURCES), np.array(TPT_SINKS)
    with Stage(tpt_core, '_refined_solve') as lu, \
            Stage(tpt_core, '_large_sparse_absorbing_solve') as host:
        committors(T, src, snk)                      # warm-up
        t = time.perf_counter()
        q = committors(T, src, snk)
        t_q = time.perf_counter() - t
        mfpts(T, sinks=snk)
        t = time.perf_counter()
        m = mfpts(T, sinks=snk)
        t_m = time.perf_counter() - t
    check(lu.calls == 4 and host.calls == 0, 'committors/mfpts: %d device '
          'LU solves, %d host solves (a stall)' % (lu.calls, host.calls))

    A, b = tpt_core._absorbing_csr_system(T, snk, src, np.append(src, snk))
    t = time.perf_counter()
    q_ref = scipy.sparse.linalg.spsolve(A.tocsc(), b,
                                        permc_spec='MMD_AT_PLUS_A')
    t_ref = time.perf_counter() - t
    q_ref[snk] = 1.0
    q_err = float(np.abs(q - q_ref).max())
    check(q_err <= 1e-10, 'committors differ from spsolve by %g' % q_err)
    A2, _ = tpt_core._absorbing_csr_system(T, snk, np.empty(0, int), snk)
    c = np.ones(TPT_STATES)
    c[snk] = 0.0
    m_ref = scipy.sparse.linalg.spsolve(A2.tocsc(), c,
                                        permc_spec='MMD_AT_PLUS_A')
    m_ref[snk] = 0.0
    m_err = float(np.abs(m - m_ref).max() / np.abs(m_ref).max())
    check(m_err <= 1e-10, 'mfpts differ from spsolve by %g relative' % m_err)

    t = time.perf_counter()
    dense_A = dense_on_device(A, device=device)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t
    torch.linalg.lu_factor(dense_A)                  # warm-up
    lu_ms = min(events_ms(lambda: torch.linalg.lu_factor(dense_A))[0]
                for _ in range(3))
    del dense_A

    t = time.perf_counter()
    nf = net_fluxes(T, src, snk)
    t_nf = time.perf_counter() - t
    t = time.perf_counter()
    found, fluxes = paths(src, snk, nf, remove_path='subtract',
                          num_paths=TPT_PATHS)
    t_paths = time.perf_counter() - t
    with on_the_host():
        t = time.perf_counter()
        nf_ref = net_fluxes(T, src, snk)
        t_nf_host = time.perf_counter() - t
    found_ref, fluxes_ref = paths(src, snk, nf_ref, remove_path='subtract',
                                  num_paths=TPT_PATHS)
    check(len(found) == len(found_ref) == TPT_PATHS and all(
        np.array_equal(a, b) for a, b in zip(found, found_ref)),
        'the %d paths differ from the float64 host paths' % TPT_PATHS)
    f_err = float(np.abs(fluxes - fluxes_ref).max()
                  / np.abs(fluxes_ref).max())
    check(f_err <= 1e-9, 'path fluxes differ by %g relative' % f_err)
    print('TPT (BASELINE config 4): %d states, %d nonzeros, %s -> %s: '
          'committors and mfpts by the device LU with refinement, no stall '
          '(%d solves), within %.3g of spsolve (mfpts %.3g relative); %d '
          'paths equal to the float64 host paths, fluxes within %.3g '
          'relative; top path flux %.6g over %d states'
          % (TPT_STATES, T.nnz, TPT_SOURCES, TPT_SINKS, lu.calls, q_err,
             m_err, len(found), f_err, fluxes[0], len(found[0])))
    print('[%s] TPT warm: committors %.4f s, mfpts %.4f s (each densify + '
          'fp32 lu_factor + refinement); densify %.4f s; lu_factor %.3f ms '
          'at %d x %d fp32; net_fluxes %.4f s (host %.4f s); %d paths '
          '%.4f s; host spsolve of the committor system %.4f s'
          % (card, t_q, t_m, t_dense, lu_ms, TPT_STATES, TPT_STATES, t_nf,
             t_nf_host, TPT_PATHS, t_paths, t_ref), flush=True)
    return {'committors_s': t_q, 'lu_ms': lu_ms, 'net_fluxes_s': t_nf}


def analysis_path(labels, device, card):
    """Phase 10: the analysis path on phase 5's labels and BASELINE
    config 4, with none of the six kernels launched."""
    reset_launches()
    out = its_cli(labels, card)
    m, nums = estimator(labels, card)
    out.update(nums)
    out.update(bootstrap_bace(labels, card))
    out.update(kmc(m.tprobs_, card))
    out.update(tpt_path(device, card))
    launched = (kcenters_chunk.n_launches,
                qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                ell_spmm_kernel.n_launches, kcenters_iteration.n_launches,
                kcenters_iteration_skip.n_launches)
    check(not any(launched), 'the analysis path launched a kernel: %s'
          % (launched,))
    print('[%s] phase 10 (analysis path) passed: %s'
          % (card, json.dumps({k: (float('%.6g' % v) if isinstance(v, float)
                                   else v) for k, v in out.items()})),
          flush=True)


def feature_data(n, seed=4):
    """Blob features: the generator of benchmarks/reference_cpu_kcenters.py
    (RandomState, centers at scale 4, unit noise) with FEAT_BLOBS blobs."""
    rng = np.random.RandomState(seed)
    centers = rng.normal(scale=4.0, size=(FEAT_BLOBS, FEAT_DIM))
    labels = rng.randint(0, FEAT_BLOBS, n)
    return (centers[labels]
            + rng.normal(size=(n, FEAT_DIM))).astype(np.float32)


def rotamer_labels(n, seed=5):
    """Three-state int32 labels (rotamer-like): FEAT_BLOBS templates,
    each position redrawn with probability 0.2."""
    rng = np.random.RandomState(seed)
    tmpl = rng.randint(0, 3, size=(FEAT_BLOBS, FEAT_DIM)).astype(np.int32)
    X = tmpl[rng.randint(0, FEAT_BLOBS, n)]
    flip = rng.random_sample(X.shape) < 0.2
    X[flip] = rng.randint(0, 3, size=int(flip.sum()))
    return X


def dist64_np(X, C, metric):
    """float64 distances (n, k) on the host."""
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    if metric == 'euclidean':
        return np.sqrt(((X[:, None] - C[None]) ** 2).sum(-1))
    if metric == 'manhattan':
        return np.abs(X[:, None] - C[None]).sum(-1)
    return (X[:, None] != C[None]).mean(-1)


def farthest_point64(X, metric, k):
    """The float64 farthest-point oracle on the host: first-max picks,
    ``(center indices, distances)``."""
    X64 = np.asarray(X, np.float64)
    dist = np.full(len(X), np.inf)
    ctr = []
    for _ in range(k):
        ctr.append(int(np.argmax(dist)))
        dist = np.minimum(dist, dist64_np(X64, X64[ctr[-1]][None],
                                          metric)[:, 0])
    return np.array(ctr), dist


def nearest64(X, C, metric, chunk=4):
    """``(min distance, first argmin)`` of every row of ``X`` to the rows
    of ``C``, in float64 on X's device, a few centers at a time."""
    X64, C64 = X.double(), torch.as_tensor(C, device=X.device).double()
    best_d = torch.full((len(X),), float('inf'), dtype=torch.float64,
                        device=X.device)
    best_i = torch.zeros(len(X), dtype=torch.long, device=X.device)
    for lo in range(0, len(C64), chunk):
        c = C64[lo:lo + chunk]
        if metric == 'hamming':
            d = (X64[:, None] != c[None]).double().mean(-1)
        else:
            diff = X64[:, None] - c[None]
            d = diff.square_().sum(-1).sqrt_() if metric == 'euclidean' \
                else diff.abs_().sum(-1)
        m, a = d.min(1)
        upd = m < best_d
        best_d = torch.where(upd, m, best_d)
        best_i = torch.where(upd, a + lo, best_i)
    return best_d.cpu().numpy(), best_i.cpu().numpy()


def same_covering(ctr, radius, ref_ctr, ref_radius, X, metric):
    """Centers equal up to the first near tie (both frames equally far,
    within 1e-5, from the centers before it), covering radii within 1e-5.
    Returns a verdict string."""
    ctr, ref_ctr = np.asarray(ctr), np.asarray(ref_ctr)
    check(len(ctr) == len(ref_ctr), '%d vs %d centers' % (len(ctr),
                                                         len(ref_ctr)))
    diff = np.flatnonzero(ctr != ref_ctr)
    verdict = 'centers equal'
    if len(diff):
        i = int(diff[0])
        d = dist64_np(X[[ctr[i], ref_ctr[i]]], X[ctr[:i]], metric).min(1)
        check(abs(d[0] - d[1]) <= 1e-5 * d.max(),
              '%s pick %d differs (%d vs %d) without a near tie: %r'
              % (metric, i, ctr[i], ref_ctr[i], d))
        verdict = 'first divergence at pick %d (a near tie, %.9g vs %.9g)' \
            % (i, d[0], d[1])
    check(abs(radius - ref_radius) <= 1e-5 * ref_radius,
          '%s covering radius %r vs %r' % (metric, radius, ref_radius))
    return verdict


def labels_vs_float64(X_dev, X_host, C, a, d, metric):
    """Assignments ``(a, d)`` of the frames to centers ``C`` against the
    float64 nearest center: labels equal but for near ties (euclidean:
    within 16 ulp of ``|x|^2 + |c|^2`` on d^2; manhattan: within 1e-5;
    hamming: none), distances on the same bars. Returns ``(flips,
    float64 covering radius)``."""
    d64, a64 = nearest64(X_dev, C, metric)
    flips = np.flatnonzero(a != a64)
    eps = np.finfo(np.float32).eps
    C64 = np.asarray(C, np.float64)
    if metric == 'hamming':
        check(len(flips) == 0 and np.array_equal(d, d64),
              'hamming labels differ from float64 at %d frames' % len(flips))
        return 0, float(d64.max())
    if metric == 'euclidean':
        xx = (np.asarray(X_host, np.float64) ** 2).sum(1)
        scale = xx + (C64 ** 2).sum(1).max()
        check(bool((np.abs(d ** 2 - d64 ** 2)
                    <= 1e-5 * d64 ** 2 + 16 * eps * scale).all()),
              'euclidean distances outside the d^2 bar')
    else:
        check(bool((np.abs(d - d64) <= 1e-5 * d64).all()),
              'manhattan distances beyond rtol 1e-5 of float64')
    took = dist64_np(X_host[flips], C64, metric)[np.arange(len(flips)),
                                                   a[flips]]
    gap = np.abs(took - d64[flips])
    bar = 16 * eps * scale[flips] / np.maximum(took + d64[flips], 1e-30) \
        if metric == 'euclidean' else 1e-5 * d64[flips]
    check(bool((gap <= bar).all()), '%s: %d label flips, some beyond a '
          'near tie' % (metric, len(flips)))
    return len(flips), float(d64.max())


def feature_loop_profile(prep, card):
    """Where an iteration of the feature k-centers loop goes: runs of 64
    and 128 centers under torch.profiler (CUDA activity), after a
    warm-up, and their difference over 64 iterations: launches, device
    ms, wall ms and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        engine.kcenters_device(prep, prep.metric, n_clusters=CHUNK_CENTERS)
        torch.cuda.synchronize()
    runs = []
    for k in (CHUNK_CENTERS, 2 * CHUNK_CENTERS):
        engine.kcenters_device(prep, prep.metric, n_clusters=k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            engine.kcenters_device(prep, prep.metric, n_clusters=k)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        n, ms = 0, 0.0
        for e in prof.key_averages():
            us = getattr(e, 'device_time_total', None)
            if us is None:
                us = getattr(e, 'cuda_time_total', 0.0)
            if us > 0:
                n += e.count
                ms += us / 1e3
        runs.append((wall, n, ms))
    wall, n, ms = [(b - a) / CHUNK_CENTERS for a, b in zip(*runs)]
    if ms <= 0 or wall < ms:
        print('[%s] feature loop profile: device time %.4f ms, wall %.4f '
              'ms an iteration (launches and idle share not measured)'
              % (card, ms, wall), flush=True)
        return None
    print('[%s] feature loop per iteration (%s, torch.profiler, %d-center '
          'runs minus %d-center runs): wall %.4f ms, %.2f launches, %.4f ms '
          'on the card, card idle %.1f%%'
          % (card, prep.metric, 2 * CHUNK_CENTERS, CHUNK_CENTERS, wall, n,
             ms, 100 * (1 - ms / wall)), flush=True)
    return n


def feature_checks(device, card):
    """Phase 11's oracle check: per metric, k-centers at FEAT_CHECK
    against the float64 farthest-point oracle."""
    n, k = FEAT_CHECK
    out = []
    for metric in ('euclidean', 'manhattan', 'hamming'):
        X = rotamer_labels(n, seed=7) if metric == 'hamming' \
            else feature_data(n, seed=6)
        res = engine.kcenters_device(X, metric, n_clusters=k, device=device)
        ctr64, d64 = farthest_point64(X, metric, k)
        out.append('%s: %s' % (metric, same_covering(
            res.center_indices, res.distances.max(), ctr64, d64.max(), X,
            metric)))
    print('[%s] feature k-centers at %d x %d to %d centers against the '
          'float64 oracle: %s' % (card, n, FEAT_DIM, k, '; '.join(out)),
          flush=True)


def timed_s(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def assign_peak(fn):
    """``fn()`` with the card's peak allocation inside it, checked below
    FEAT_MEM_LIMIT: ``(result, seconds, peak bytes)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, s = timed_s(fn)
    peak = torch.cuda.max_memory_allocated()
    check(peak < FEAT_MEM_LIMIT, 'assignment peak %.2f GB' % (peak / 2 ** 30))
    return out, s, peak


def feature_path(device, card):
    """Phase 11: clustering feature vectors at 1M x 64 on the card, the
    CLI sequence of apps/cluster.py :: main (--features, khybrid,
    --checkpoint, the features reassign, a kmedoids warm start) and the
    library calls (resume_kcenters, manhattan, hamming, a 4-shard mesh),
    with none of the six kernels launched."""
    feature_checks(device, card)
    n = FEAT_TRJ * FEAT_FRAMES
    t = time.perf_counter()
    X = feature_data(n)
    print('made %d x %d blob features (%d blobs) in %.1f s'
          % (n, FEAT_DIM, FEAT_BLOBS, time.perf_counter() - t), flush=True)
    reset_launches()
    engine_kmedoids._pam_sweeps.n_host_syncs = 0
    with tempfile.TemporaryDirectory() as d:
        files = []
        for i in range(FEAT_TRJ):
            files.append(os.path.join(d, 'f%03d.npy' % i))
            np.save(files[-1], X[i * FEAT_FRAMES:(i + 1) * FEAT_FRAMES])
        ck = os.path.join(d, 'ckpt')
        out = {k: os.path.join(d, v) for k, v in (
            ('--distances', 'dist.h5'), ('--assignments', 'assig.h5'),
            ('--center-features', 'centers.npy'),
            ('--center-indices', 'inds.npy'))}
        base = ['cluster', '--features', *files, '--cluster-distance',
                'euclidean', '--cluster-number', str(FEAT_K), '--subsample',
                str(FEAT_SUBSAMPLE), '--random-state', '0', '--checkpoint',
                ck]
        for k, v in out.items():
            base += [k, v]

        # 1. khybrid with --checkpoint: the sequence of main, but for the
        # .h5 writes (no h5py on the card machine)
        args = cluster_app.process_command_line(base + ['--algorithm',
                                                        'khybrid'])
        t = time.perf_counter()
        lengths, data = cluster_util.load_trjs_or_features(args)
        t_load = time.perf_counter() - t
        with Stage(hybrid_mod, '_kcenters') as kc, \
                Stage(hybrid_mod, '_kmedoids_iterations') as pam:
            clustering = cluster_app.fit(args, data, device)
        syncs = engine_kmedoids._pam_sweeps.n_host_syncs
        cluster_app.save_checkpoint(args, clustering)
        res = clustering.result_
        result = res.partition(lengths)
        t = time.perf_counter()
        cluster_util.write_centers_indices(
            args.center_indices, cluster_app.center_indices(result, args))
        cluster_util.write_centers(result, args)
        t_write = time.perf_counter() - t
        check(np.load(args.center_features).shape == (FEAT_K, FEAT_DIM),
              'center features %s' % (np.load(args.center_features).shape,))
        cost_kc = float(np.mean(kc.result.distances ** 2))
        cost = float(np.mean(res.distances ** 2))
        check(cost <= cost_kc, 'PAM cost %r above k-centers cost %r'
              % (cost, cost_kc))
        ctr = np.asarray(res.center_indices)
        check(len(set(ctr.tolist())) == FEAT_K, 'duplicate centers')

        # 2. the features reassign of every frame
        with Stage(engine, 'assign_device') as asg:
            (r_assig, r_dist), t_reassign, peak_r = assign_peak(
                lambda: cluster_util.reassign_features(result, args, device))
        r_assig, r_dist = r_assig._data, r_dist._data
        check(len(r_assig) == n and np.isfinite(r_dist).all(),
              'reassign output %d' % len(r_assig))
        X_dev = torch.from_numpy(X).to(device)
        C = np.asarray(result.centers)
        flips_r, _ = labels_vs_float64(X_dev, X, C, r_assig, r_dist,
                                       'euclidean')

        # 3. kmedoids warm-started from the checkpoint
        before = np.load(os.path.join(ck, 'distances.npy'))
        args2 = cluster_app.process_command_line(
            base + ['--algorithm', 'kmedoids', '--cluster-iterations', '1'])
        (warm, t_warm) = timed_s(lambda: cluster_app.fit(args2, data, device))
        cost_ck = float(np.mean(before.astype(np.float64) ** 2))
        cost_warm = float(np.mean(warm.result_.distances ** 2))
        check(cost_warm <= cost_ck, 'kmedoids warm start cost %r above the '
              "checkpoint's %r" % (cost_warm, cost_ck))
        del data
    launched = (kcenters_chunk.n_launches,
                qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                ell_spmm_kernel.n_launches, kcenters_iteration.n_launches,
                kcenters_iteration_skip.n_launches)
    check(not any(launched), 'the feature CLI launched a kernel: %s'
          % (launched,))
    pairs = n * FEAT_K
    print('features CLI: %d of %d frames clustered (--subsample %d) to %d '
          'centers by euclidean, PAM cost %.6g <= k-centers cost %.6g; '
          'checkpoint saved; reassign of every frame: %d label flips from '
          'float64, each a near tie; kmedoids warm start from the '
          'checkpoint: cost %.6g <= %.6g'
          % (sum(lengths), n, FEAT_SUBSAMPLE, FEAT_K, cost, cost_kc, flips_r,
             cost_warm, cost_ck))
    print('[%s] features CLI: load %.4f s; k-centers %.4f s; PAM %.4f s (5 '
          'sweeps, %d host syncs); write centers %.4f s; reassign %.4f s '
          '(load + assign), of which assign %.4f s = %.4g pairs/s, peak %.2f '
          'GB; kmedoids warm start %.4f s'
          % (card, t_load, kc.seconds, pam.seconds, syncs, t_write,
             t_reassign, asg.seconds, pairs / asg.seconds, peak_r / 2 ** 30,
             t_warm), flush=True)

    # 4. the library calls on the full 1M x 64
    prep = engine.prepare_sharded(X_dev, 'euclidean')
    full, t_full = timed_s(lambda: engine.kcenters_device(
        prep, 'euclidean', n_clusters=FEAT_K))
    d64, _ = nearest64(X_dev, X[full.center_indices], 'euclidean')
    check(abs(full.distances.max() - d64.max()) <= 1e-5 * d64.max(),
          'euclidean covering radius %r vs float64 %r'
          % (full.distances.max(), d64.max()))
    launches_it = feature_loop_profile(prep, card)
    with tempfile.TemporaryDirectory() as d:
        half = engine.kcenters_device(prep, 'euclidean',
                                      n_clusters=FEAT_RESUME_FROM)
        save_clustering_checkpoint(d, half.distances, half.assignments,
                                   half.center_indices)
        resumed, t_resume = timed_s(lambda: resume_kcenters(
            d, X_dev, 'euclidean', n_clusters=FEAT_K))
    check(np.array_equal(resumed.center_indices, full.center_indices) and
          np.array_equal(resumed.assignments, full.assignments) and
          np.array_equal(resumed.distances, full.distances),
          'resume_kcenters from %d centers differs from a straight run'
          % FEAT_RESUME_FROM)
    mesh = FrameMesh((device,) * N_SHARDS)
    sharded, t_mesh = timed_s(lambda: kcenters(
        X_dev, 'euclidean', n_clusters=FEAT_K, mesh=mesh))
    mesh_verdict = same_covering(sharded.center_indices,
                                 sharded.distances.max(), full.center_indices,
                                 full.distances.max(), X, 'euclidean')
    lines = []
    for metric in ('manhattan', 'hamming'):
        Xm = X if metric == 'manhattan' else rotamer_labels(n)
        Xm_dev = torch.from_numpy(Xm).to(device)
        kres, t_k = timed_s(lambda: kcenters(Xm_dev, metric,
                                             n_clusters=FEAT_K))
        C = Xm[np.asarray(kres.center_indices)]
        (a, dd), t_a, peak = assign_peak(
            lambda: engine.assign_device(Xm_dev, C, metric))
        flips, r64 = labels_vs_float64(Xm_dev, Xm, C, a, dd, metric)
        r = float(np.max(kres.distances))
        check(abs(r - r64) <= 1e-5 * r64, '%s covering radius %r vs float64 '
              '%r' % (metric, r, r64))
        lines.append('%s k-centers %.4f s (%.4f ms per iteration), assign '
                     '%.4f s = %.4g pairs/s (peak %.2f GB, %d label flips '
                     'from float64)' % (metric, t_k, 1e3 * t_k / FEAT_K, t_a,
                                        pairs / t_a, peak / 2 ** 30, flips))
        del Xm_dev
    launched = (kcenters_chunk.n_launches,
                qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                ell_spmm_kernel.n_launches, kcenters_iteration.n_launches,
                kcenters_iteration_skip.n_launches)
    check(not any(launched), 'phase 11 launched a kernel: %s' % (launched,))
    bound_ms = 1e3 * (n * FEAT_DIM * 4 + 8 * n) / HBM_RATE
    ms_it = 1e3 * t_full / FEAT_K
    print('[%s] feature k-centers %d x %d -> %d by euclidean: %.4f s, %.4f '
          'ms per iteration, %s launches per iteration, bytes bound %.4f ms '
          '(%.1f%% of it); covering radius within 1e-5 of float64; resume '
          'from %d centers %.4f s, equal to the straight run bit for bit; '
          '4-shard mesh %.4f s, %s; %s; none of the six kernels launched'
          % (card, n, FEAT_DIM, FEAT_K, t_full, ms_it,
             'not measured' if launches_it is None else '%.2f' % launches_it,
             bound_ms, 100 * bound_ms / ms_it, FEAT_RESUME_FROM, t_resume,
             t_mesh, mesh_verdict, '; '.join(lines)), flush=True)


def config3_trajs():
    """BASELINE config 3's rotamer trajectories: the generator of
    benchmarks/reference_configs.py:176-195 (RandomState(7), 64 dwells a
    feature of geometric length, mean 200 frames, the last state held to
    the end), CARDS_TRJ x (CARDS_FRAMES, CARDS_FEATURES) int16."""
    rng = np.random.RandomState(CARDS_SEED)
    n, F = CARDS_FRAMES, CARDS_FEATURES
    trajs = []
    for _ in range(CARDS_TRJ):
        flips = rng.geometric(1 / 200.0, size=(F, 64))
        states = rng.randint(0, 3, size=(F, 64))
        traj = np.empty((n, F), dtype=np.int16)
        for f in range(F):
            reps = np.repeat(states[f], np.minimum(flips[f], n))
            traj[:, f] = reps[:n] if reps.size >= n else np.pad(
                reps, (0, n - reps.size), mode='edge')
        trajs.append(traj)
    return trajs


# a LYS residue's heavy atoms in order, and the NeRF placement of its side
# chain: (atom, offsets in the residue of the reference atoms a, b, c,
# bond in nm, angle b-c-atom in degrees, torsion: a chi of lys_torsions or
# a constant in degrees)
LYS_ATOMS = ('N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'CE', 'NZ')
LYS_SIDE = (('CB', (2, 0, 1), 0.1530, 110.5, -122.6),
            ('CG', (0, 1, 4), 0.1520, 114.1, 'chi1'),
            ('CD', (1, 4, 5), 0.1520, 111.3, 'chi2'),
            ('CE', (4, 5, 6), 0.1520, 111.3, 'chi3'),
            ('NZ', (5, 6, 7), 0.1489, 111.9, 'chi4'))
# the hidden basins' centers in degrees: phi [0, 180) and [180, 360); psi's
# shifted basins [0, 160) and [160, 360) hold 180 and 0; chi's three
PEP_CENTERS = {'phi': (90.0, 270.0), 'psi': (180.0, 0.0),
               'chi': (60.0, 180.0, 300.0)}


def lys_topology(topology_cls, n_res):
    """A one-chain poly-LYS topology of ``topology_cls`` (the port's or the
    JAX package's Topology), 9 heavy atoms a residue."""
    top = topology_cls()
    chain = top.add_chain()
    for i in range(n_res):
        res = top.add_residue('LYS', chain, i + 1)
        for name in LYS_ATOMS:
            top.add_atom(name, name[0], res)
    return top


def lys_torsions(n_frames, n_res, seed, dwell=200, noise=10.0):
    """Torsions in degrees of a poly-LYS peptide, float32 (n_frames,
    6 * n_res): phi of every residue, psi of every residue, then chi1-4 of
    each residue in turn. Each follows a hidden Markov chain over its
    basins (2 for phi and psi, 3 for chi) that leaves its basin with
    probability 1/dwell a frame, plus Gaussian noise of ``noise``
    degrees, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    kinds = ['phi'] * n_res + ['psi'] * n_res + ['chi'] * (4 * n_res)
    n_basins = np.array([len(PEP_CENTERS[k]) for k in kinds])
    centers = np.zeros((len(kinds), 3))
    for j, k in enumerate(kinds):
        centers[j, :n_basins[j]] = PEP_CENTERS[k]
    step = rng.random((n_frames, len(kinds)), dtype=np.float32) < 1 / dwell
    jump = np.where(n_basins == 2, 1, rng.integers(1, 3, size=step.shape))
    hidden = (rng.integers(0, 2, size=len(kinds))
              + np.cumsum(step * jump, axis=0)) % n_basins
    ang = centers[np.arange(len(kinds)), hidden]
    return (ang + noise * rng.standard_normal(ang.shape, dtype=np.float32)
            ).astype(np.float32)


def _place(a, b, c, bond, angle, torsion):
    """NeRF: the atom bonded to ``c`` at ``bond`` nm, angle b-c-d
    ``angle`` and torsion a-b-c-d ``torsion`` (radians, per frame)."""
    bc = c - b
    bc = bc / bc.norm(dim=-1, keepdim=True)
    n = torch.linalg.cross(b - a, bc)
    n = n / n.norm(dim=-1, keepdim=True)
    m = torch.linalg.cross(n, bc)
    sin_a = bond * np.sin(np.deg2rad(angle))
    return (c - bond * np.cos(np.deg2rad(angle)) * bc
            + (sin_a * torch.cos(torsion))[:, None] * m
            + (sin_a * torch.sin(torsion))[:, None] * n)


def lys_peptide(torsions, device):
    """Coordinates (n_frames, 9 * n_res, 3) in nm, float32 numpy, centered
    a frame, of the poly-LYS peptide with the torsions of
    :func:`lys_torsions`: NeRF placement in float64 on ``device`` (omega
    180 degrees)."""
    tor = torch.as_tensor(torsions, device=device).double().deg2rad()
    T, n_res = tor.shape[0], tor.shape[1] // 6
    col = {'phi': lambda i: tor[:, i], 'psi': lambda i: tor[:, n_res + i]}
    for k in range(4):
        col['chi%d' % (k + 1)] = \
            lambda i, k=k: tor[:, 2 * n_res + 4 * i + k]
    xyz = torch.zeros((T, 9 * n_res, 3), dtype=torch.float64, device=device)
    n_ca, ca_c, c_n = 0.1458, 0.1525, 0.1329
    xyz[:, 1, 0] = n_ca
    t = np.deg2rad(111.2)
    xyz[:, 2, 0] = n_ca - ca_c * np.cos(t)
    xyz[:, 2, 1] = ca_c * np.sin(t)

    def const(degrees):
        return torch.full((T,), np.deg2rad(degrees), dtype=torch.float64,
                          device=device)
    for i in range(n_res):
        r = 9 * i
        N, CA, C = xyz[:, r], xyz[:, r + 1], xyz[:, r + 2]
        xyz[:, r + 3] = _place(N, CA, C, 0.1231, 120.5, col['psi'](i) + np.pi)
        for name, (a, b, c), bond, angle, tors in LYS_SIDE:
            tors = col[tors](i) if isinstance(tors, str) else const(tors)
            xyz[:, r + LYS_ATOMS.index(name)] = _place(
                xyz[:, r + a], xyz[:, r + b], xyz[:, r + c], bond, angle,
                tors)
        if i + 1 < n_res:
            xyz[:, r + 9] = _place(N, CA, C, c_n, 116.2, col['psi'](i))
            xyz[:, r + 10] = _place(CA, C, xyz[:, r + 9], n_ca, 121.7,
                                    const(180.0))
            xyz[:, r + 11] = _place(C, xyz[:, r + 9], xyz[:, r + 10], ca_c,
                                    111.2, col['phi'](i + 1))
    xyz -= xyz.mean(dim=1, keepdim=True)
    return xyz.float().cpu().numpy()


def _cross(u, v):
    return np.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                     u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                     u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def dihedrals64(xyz, quartets, chunk=1 << 14):
    """Dihedral angles in radians by the arctan2 form, float64 numpy, a
    chunk of frames a thread."""
    out = np.empty((len(xyz), len(quartets)))

    def one(lo):
        x = xyz[lo:lo + chunk].astype(np.float64)
        p0, p1, p2, p3 = (x[:, quartets[:, k]] for k in range(4))
        b1, b2, b3 = p1 - p0, p2 - p1, p3 - p2
        c1, c2 = _cross(b2, b3), _cross(b1, b2)
        out[lo:lo + chunk] = np.arctan2(
            (b1 * c1).sum(-1) * np.sqrt((b2 * b2).sum(-1)),
            (c1 * c2).sum(-1))
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(one, range(0, len(xyz), chunk)))
    return out


def states_vs_host(traj, states, device, buffer_width=15):
    """``all_rotamers``' states against the host ``_rotamers`` of the same
    float64 angles, column by column, on every column whose angles stay
    more than 1e-3 degrees from its family's gates and boundaries (where
    float32 and float64 compares agree). Returns ``(columns compared,
    columns)``."""
    compared, col = 0, 0
    for kinds, hb, shift in (rotamer.PHI, rotamer.PSI, rotamer.CHI):
        _, deg = rotamer._degrees(traj, kinds, device)
        if shift:
            deg = torch.remainder(deg - shift, 360.0)
        deg = deg.cpu().numpy()
        marks = sorted({g for s in range(len(hb) - 1)
                        for g in rotamer.get_gates(s, hb, buffer_width)}
                       | set(hb[1:-1]))
        clear = np.full(deg.shape[1], np.inf)
        for g in marks:
            clear = np.minimum(clear, np.abs(deg - g).min(axis=0))
        for j in range(deg.shape[1]):
            if clear[j] > 1e-3:
                host = rotamer._rotamers(deg[:, j], hb, buffer_width)
                check(np.array_equal(states[:, col + j], host),
                      'rotamer states of column %d differ from _rotamers'
                      % (col + j))
                compared += 1
        col += deg.shape[1]
    return compared, col


def cards_library(device, card):
    """Phase 12a: cards_matrices at BASELINE config 3 on the card, its
    joint counts, disorder labels and matrices checked, the joint-count
    product timed."""
    t = time.perf_counter()
    trajs = config3_trajs()
    print('made BASELINE config 3: %d x %d frames x %d features in %.1f s'
          % (CARDS_TRJ, CARDS_FRAMES, CARDS_FEATURES,
             time.perf_counter() - t), flush=True)
    n_states = np.full(CARDS_FEATURES, 3, dtype=np.int16)
    _, t_cold = timed_s(lambda: cards_matrices(trajs, n_states))
    mats, t_warm = timed_s(lambda: cards_matrices(trajs, n_states))
    cpu, t_cpu = timed_s(lambda: cards_matrices(trajs, n_states,
                                                device='cpu'))
    check(all(np.array_equal(m, c) for m, c in zip(mats, cpu)),
          'CARDS matrices on the card differ from the CPU run')
    check(all(m.shape == (CARDS_FEATURES,) * 2 and np.isfinite(m).all()
              for m in mats), 'CARDS matrices not finite (F, F)')

    X = trajs[0]
    X_dev = torch.from_numpy(X).to(device)
    jc, t_jc = timed_s(lambda: libinfo.matrix_bincount2d(X_dev, X_dev, 3, 3))
    hist = np.stack([np.bincount(X[:, f], minlength=3)
                     for f in range(CARDS_FEATURES)])
    check(np.array_equal(jc.sum(-1), np.broadcast_to(
        hist[:, None], jc.shape[:3])) and np.array_equal(
        jc.sum(-2), np.broadcast_to(hist[None], jc.shape[:3])),
        'joint-count marginals differ from np.bincount')
    rng = np.random.default_rng(0)
    for fa, fb in rng.integers(0, CARDS_FEATURES, size=(CARDS_PAIRS, 2)):
        check(np.array_equal(jc[fa, fb], libinfo.bincount2d(
            X[:, fa], X[:, fb], 3, 3)),
            'joint counts of features %d, %d differ from np.bincount'
            % (fa, fb))
    mesh = FrameMesh((device,) * N_SHARDS)
    check(np.array_equal(libinfo.matrix_bincount2d(X_dev, X_dev, 3, 3,
                                                   mesh=mesh), jc),
          'joint counts on a %d-shard mesh differ' % N_SHARDS)
    # the transitions found on the card, the labels painted there
    labels, _ = cards_mod._disorder_labels(
        [torch.from_numpy(x).to(device) for x in trajs], device)
    host, _ = disorder.assign_order_disorder(trajs)
    check(all(np.array_equal(a.cpu().numpy(), b)
              for a, b in zip(labels, host)),
          'disorder labels differ from the host painter')

    # the product alone: one-hot and matmul of one trajectory
    reps = 5
    ms = reps_ms(lambda: libinfo._count(X_dev, X_dev, 3, 3, True), reps)
    width = 3 * CARDS_FEATURES
    flops = 2.0 * CARDS_FRAMES * width * width
    b = bound(2 * X.size + 8 * width * width, flops)
    print('[%s] cards_matrices at %d x %d x %d: cold %.4f s, warm %.4f s '
          '(CPU %.4f s), the four matrices equal to the CPU run bit for bit; '
          'matrix_bincount2d %.4f s; the joint-count product (one-hot + '
          'fp32 matmul, TF32 %s) %.4f ms = %.4g TFLOP/s against its bound '
          '%.4f ms (%s, fp32 %.0f TFLOP/s): %.1f%%; marginals and %d pairs '
          'equal np.bincount, %d-shard mesh equal, disorder labels equal '
          'the host painter'
          % (card, CARDS_TRJ, CARDS_FRAMES, CARDS_FEATURES, t_cold, t_warm,
             t_cpu, t_jc, torch.backends.cuda.matmul.allow_tf32, ms,
             flops / ms / 1e9, b[0], b[1], FP32_RATE / 1e12,
             100 * b[0] / ms, CARDS_PAIRS, N_SHARDS), flush=True)
    return {'cards_matrices_s': t_warm, 'product_ms': ms}


def cards_featurize(device, card):
    """Phase 12b: all_rotamers of the LYS peptide on the card, checked
    against float64 dihedrals and the host _rotamers. Returns the
    peptide's topology and coordinates."""
    t = time.perf_counter()
    tors = lys_torsions(CARDS_PEP_FRAMES, CARDS_RES, CARDS_PEP_SEED)
    xyz = lys_peptide(tors, device)
    top = lys_topology(Topology, CARDS_RES)
    traj = Trajectory(xyz, top)
    print('made a %d-residue LYS peptide: %d frames x %d atoms in %.1f s'
          % (CARDS_RES, CARDS_PEP_FRAMES, xyz.shape[1],
             time.perf_counter() - t), flush=True)
    geometry_pkg.all_rotamers(traj[:1000])                 # warm-up
    (states, inds, ns), t_rot = timed_s(lambda: geometry_pkg.all_rotamers(
        traj))
    n_dih = 2 * (CARDS_RES - 1) + 4 * CARDS_RES
    check(states.shape == (CARDS_PEP_FRAMES, n_dih) and
          states.dtype == np.int16 and len(inds) == n_dih,
          'all_rotamers gave %s states, %d dihedrals' % (states.shape,
                                                         len(inds)))
    rad, t_dih = timed_s(lambda: dihedrals.dihedrals_tensor(xyz, inds,
                                                            device))
    diff = rad.cpu().numpy() - dihedrals64(xyz, inds)
    err = float(np.abs(np.remainder(diff + np.pi, 2 * np.pi) - np.pi).max())
    check(err < 1e-5, 'dihedrals differ from float64 by %g rad' % err)
    compared, n_cols = states_vs_host(traj, states, device)
    check(compared > 0, 'no column clear of the gates')
    moves = int((np.diff(states, axis=0) != 0).sum())
    print('[%s] all_rotamers at %d frames x %d dihedrals: %.4f s (dihedrals '
          'alone %.4f s), %d state changes; dihedrals within %.3g rad of '
          'float64; states equal _rotamers on %d of %d columns (those clear '
          'of the gates by 1e-3 degrees)'
          % (card, CARDS_PEP_FRAMES, n_dih, t_rot, t_dih, moves, err,
             compared, n_cols), flush=True)
    return top, xyz


def weighted_mi_check(device, card):
    """Phase 12d: weighted_mi on the card against the float64 host einsum
    of its joint distribution."""
    n, d = CARDS_WMI
    rng = np.random.default_rng(9)
    base = rng.random((n, 10)) < 0.5
    X = base[:, rng.integers(0, 10, d)] ^ (rng.random((n, d)) < 0.1)
    w = rng.random(n)
    mi, t_dev = timed_s(lambda: mutual_info.weighted_mi(X, w))
    t = time.perf_counter()
    wn = w / np.linalg.norm(w, ord=1)
    onehot = np.stack([X == u for u in range(2)], axis=-1)
    P = np.einsum('tiu,t,tjv->uvij', onehot, wn, onehot)
    # int16 alphabet sizes, as weighted_mi's default (its capacity log is
    # then float32, as in the JAX package)
    ref = mutual_info.weighted_mi_from_joint(P, X, wn,
                                             np.full(d, 2, dtype='int16'))
    t_host = time.perf_counter() - t
    err = float(np.abs(mi - ref).max())
    check(err <= 1e-12, 'weighted_mi differs from the host einsum by %g'
          % err)
    print('[%s] weighted_mi at %d x %d boolean features: card %.4f s, host '
          'einsum %.4f s, within %.3g' % (card, n, d, t_dev, t_host, err),
          flush=True)


def cards_cli(top, xyz, card):
    """Phase 12c: `enspara cards` and `enspara entropy` through the
    dispatcher on the peptide's first frames, by stage. Returns the
    matrices `enspara cards` saved and the trajectories it read (for
    phase 17)."""
    n_files = CARDS_CLI_FILES
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        pdb = os.path.join(d, 'lys.pdb')
        write_pdb(pdb, Trajectory(xyz[:1], top))
        files = [os.path.join(d, 'pep%02d.xtc' % i) for i in range(n_files)]
        cluster_util.load_xtc_codec(files)   # before the writer threads

        def write(i):
            lo = i * CARDS_CLI_FRAMES
            write_xtc(files[i], Trajectory(xyz[lo:lo + CARDS_CLI_FRAMES],
                                           top))
        with ThreadPoolExecutor(8) as ex:
            list(ex.map(write, range(n_files)))
        print('wrote %d XTC files x %d frames x %d atoms in %.1f s'
              % (n_files, CARDS_CLI_FRAMES, xyz.shape[1],
                 time.perf_counter() - t), flush=True)
        pkl, csv = os.path.join(d, 'cards.pkl'), os.path.join(d, 'inds.csv')
        ent = os.path.join(d, 'ent.csv')
        stages = ((port_io, 'load'), (geometry_pkg, 'all_rotamers'),
                  (cards_mod, '_disorder_labels'), (mutual_info, 'mi_matrix'),
                  (cards_app, 'save_cards'))
        with contextlib.ExitStack() as stack:
            st = [stack.enter_context(Stage(m, n)) for m, n in stages]
            _, t_cards = timed_s(lambda: main_app.main(
                ['enspara', 'cards', '--trajectories', *files, '--topology',
                 pdb, '--matrices', pkl, '--indices', csv]))
        secs = [s.seconds for s in st]
        with Stage(port_io, 'load') as ld, \
                Stage(geometry_pkg, 'all_rotamers') as ft:
            _, t_ent = timed_s(lambda: main_app.main(
                ['enspara', 'entropy', '--trajectories', *files,
                 '--topology', pdb, '--entropies', ent]))
        with ThreadPoolExecutor(8) as ex:
            loaded = list(ex.map(lambda f: port_io.load(f, top=top), files))
        lib, t_lib = timed_s(lambda: cards(loaded))
        with open(pkl, 'rb') as f:
            saved = pickle.load(f)
        inds = np.loadtxt(csv, delimiter=',')
        table = np.loadtxt(ent, delimiter=',')
    keys = ('Struc_struc_MI', 'Disorder_disorder_MI', 'Struc_disorder_MI',
            'Disorder_struc_MI')
    check(all(type(saved[k]) is np.ndarray and np.array_equal(saved[k], m)
              for k, m in zip(keys, lib[:4])),
          "the pickle's matrices differ from cards() of the same frames")
    check(np.array_equal(inds, lib[4]), 'the indices CSV differs')
    check(table.shape == (CARDS_RES, 2) and
          np.array_equal(table[:, 0], np.arange(1, CARDS_RES + 1)) and
          bool(((table[:, 1] >= 0) & (table[:, 1] <= 1)).all()),
          'entropies %s outside [0, 1]' % (table[:, 1],))
    print('[%s] enspara cards on %d x %d frames: %.4f s = load %.4f s, '
          'featurize %.4f s, disorder %.4f s, the four MI matrices %.4f s, '
          'write %.4f s, other %.4f s; the pickle (numpy, four keys) equal '
          'to cards() of the same frames (%.4f s); enspara entropy %.4f s '
          '(load %.4f s, featurize %.4f s), %d residues, entropies %.4f - '
          '%.4f' % ((card, n_files, CARDS_CLI_FRAMES, t_cards) + tuple(secs)
                    + (t_cards - sum(secs), t_lib, t_ent, ld.seconds,
                       ft.seconds, len(table), table[:, 1].min(),
                       table[:, 1].max())), flush=True)
    return [saved[k] for k in keys], loaded, t_cards


def cards_path(device, card):
    """Phase 12: the CARDS chain on the card, with none of the six kernels
    launched. Returns what :func:`cards_cli` returns."""
    reset_launches()
    cards_library(device, card)
    top, xyz = cards_featurize(device, card)
    cli = cards_cli(top, xyz[:CARDS_CLI_FILES * CARDS_CLI_FRAMES], card)
    del xyz
    weighted_mi_check(device, card)
    launched = (kcenters_chunk.n_launches,
                qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                ell_spmm_kernel.n_launches, kcenters_iteration.n_launches,
                kcenters_iteration_skip.n_launches)
    check(not any(launched), 'phase 12 launched a kernel: %s' % (launched,))
    print('[%s] phase 12 (CARDS) passed; none of the six kernels launched'
          % card, flush=True)
    return cli


def globule(n_res, seed=13, density=GLOB_DENSITY):
    """Coordinates (9 * n_res, 3) in nm, float64, of a compact globule: the
    9 * n_res points of a cubic lattice at ``density`` atoms per nm^3
    nearest its center, jittered by 0.03 nm (seeded), ordered along a
    Z-order curve so that each run of 9 (a LYS residue of
    :func:`lys_topology`) lies together. A real protein's heavy-atom
    density gives its SASA neighbor counts; a NeRF chain would give an
    extended peptide with almost no burial."""
    n = 9 * n_res
    a = density ** (-1 / 3)
    m = int(np.ceil((3 * n / (4 * np.pi * density)) ** (1 / 3) / a)) + 2
    g = np.arange(-m, m + 1)
    ijk = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    ijk = ijk[np.argsort((ijk ** 2).sum(1), kind='stable')[:n]]
    u = (ijk + m).astype(np.int64)
    code = np.zeros(n, np.int64)
    for bit in range(8):
        for d in range(3):
            code |= ((u[:, d] >> bit) & 1) << (3 * bit + d)
    ijk = ijk[np.argsort(code, kind='stable')]
    return ijk * a + np.random.default_rng(seed).normal(0, 0.03, (n, 3))


def globule_frames(base, n_frames, seed, planted=PLANTED):
    """Cluster centers of the globule ``base``: float32 (n_frames, atoms,
    3) with 0.02 nm noise, plus ``planted`` = (groups, residues, swing):
    each group, residues of the layer under the surface nearest one
    tetrahedral direction, swings outward by ``swing`` nm along it in the
    frames where its hidden label (a fair coin a frame) is 1. Returns the
    frames, the labels (n_frames, groups) and the groups' residues."""
    n_groups, per, swing = planted
    rng = np.random.default_rng(seed)
    cen = base.reshape(-1, 9, 3).mean(1)
    rad = np.linalg.norm(cen, axis=1)
    layer = np.flatnonzero((rad > 0.6 * rad.max()) & (rad < 0.85 * rad.max()))
    dirs = np.array([(1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)],
                    float)[:n_groups] / np.sqrt(3)
    groups, taken = [], set()
    for d in dirs:
        order = layer[np.argsort(-(cen[layer] @ d) / rad[layer])]
        groups.append(np.array([r for r in order if r not in taken][:per],
                               dtype=int))
        taken.update(groups[-1].tolist())
    labels = rng.random((n_frames, n_groups)) < 0.5
    xyz = np.repeat(base[None], n_frames, axis=0)
    for k, g in enumerate(groups):
        atoms = (9 * g[:, None] + np.arange(9)).ravel()
        xyz[np.ix_(np.flatnonzero(labels[:, k]), atoms)] += swing * dirs[k]
    xyz += rng.normal(0, 0.02, xyz.shape)
    return xyz.astype(np.float32), labels, groups


def sasa64(xyz, radii, n_points, device, block=64):
    """Dense Shrake-Rupley in float64 torch ops on ``device``: the oracle
    of phase 13a."""
    pts = torch.as_tensor(sasa_mod.sphere_points(n_points),
                          dtype=torch.float64, device=device)
    X = torch.as_tensor(xyz, dtype=torch.float64, device=device)
    r = torch.as_tensor(radii, dtype=torch.float64, device=device)
    A = X.shape[1]
    out = torch.empty(X.shape[:2], dtype=torch.float64, device=device)
    for f in range(X.shape[0]):
        for lo in range(0, A, block):
            hi = min(lo + block, A)
            shell = X[f, lo:hi, None, :] + r[lo:hi, None, None] * pts
            d2 = ((shell[:, :, None, :] - X[f][None, None]) ** 2).sum(-1)
            cover = d2 < r ** 2
            cover[torch.arange(hi - lo), :, torch.arange(lo, hi)] = False
            out[f, lo:hi] = ((~cover.any(-1)).double().mean(-1) * 4 * np.pi
                             * r[lo:hi] ** 2)
    return out.cpu().numpy()


def candidate_pairs(xyz, rad, device, block=64):
    """Candidate occluders of every (frame, atom), summed: the work the
    data needs, (atom, point, candidate) tests over the shell points."""
    X = torch.as_tensor(xyz, device=device)
    r = torch.as_tensor(rad, device=device)
    total = 0
    for lo in range(0, X.shape[1], block):
        for f in range(0, X.shape[0], 256):
            _, rel = sasa_mod._block_candidates(X[f:f + 256], r, lo,
                                                min(lo + block, X.shape[1]))
            total += int(rel.sum())
    return total


def sasa_check(device, card):
    """Phase 13a: shrake_rupley over the globule's centers at full size,
    held against the dense path, a float64 oracle and a 4-shard mesh."""
    top = lys_topology(Topology, GLOB_RES)
    base = globule(GLOB_RES)
    xyz, labels, groups = globule_frames(base, SASA_FRAMES, seed=14)
    traj = Trajectory(xyz, top)
    radii = np.array([a.radius for a in top.atoms], np.float32)
    rad = radii + SASA_PROBE

    def run(**kw):
        return shrake_rupley(traj, probe_radius=SASA_PROBE,
                             n_sphere_points=SASA_POINTS, **kw)
    torch.cuda.reset_peak_memory_stats()
    sasa, t_cold = timed_s(run)
    peak = torch.cuda.max_memory_allocated()
    warm, t_warm = timed_s(run)
    check(np.array_equal(warm, sasa), 'two SASA runs differ')
    check(sasa.shape == (SASA_FRAMES, 9 * GLOB_RES)
          and np.isfinite(sasa).all() and (sasa >= 0).all(),
          'SASA of shape %s, finite and >= 0: %s'
          % (sasa.shape, np.isfinite(sasa).all()))
    X = torch.as_tensor(xyz, device=device)
    need = int(sasa_mod._max_neighbor_count(X, torch.as_tensor(rad, device=
                                                                device), 64))
    k = sasa_mod._pick_n_neighbors(need, xyz.shape[1])
    check(k is not None, 'the neighbor-list path was not taken')
    n_tests = SASA_POINTS * candidate_pairs(xyz, rad, device)
    b = bound(4 * (xyz.size + 2 * xyz.shape[1] + sasa.size), 9 * n_tests)

    some = (xyz[:SASA_CHECK], radii)
    dense = shrake_rupley(some, probe_radius=SASA_PROBE,
                          n_sphere_points=SASA_POINTS, n_neighbors=None,
                          device=device)
    check(np.array_equal(dense, sasa[:SASA_CHECK]),
          'the neighbor-list path differs from the dense path')
    oracle = sasa64(xyz[:SASA_CHECK],
                    np.array([a.radius for a in top.atoms]) + SASA_PROBE,
                    SASA_POINTS, device)
    tol = 2 * 4 * np.pi * rad.astype(np.float64) ** 2 / SASA_POINTS
    err = np.abs(sasa[:SASA_CHECK] - oracle)
    total = abs(sasa[:SASA_CHECK].sum(dtype=np.float64) - oracle.sum()) \
        / oracle.sum()
    check((err <= tol).all(), 'an atom is %.3g shell-point areas from the '
          'float64 oracle' % (err / tol * 2).max())
    check(total <= 1e-4, 'total SASA %.3g from the float64 oracle' % total)
    mesh = FrameMesh((device,) * SASA_SHARDS)
    sharded, t_mesh = timed_s(lambda: run(mesh=mesh))
    check(np.array_equal(sharded, sasa), 'the %d-shard mesh differs'
          % SASA_SHARDS)
    print('[%s] shrake_rupley at %d frames x %d atoms x %d points, probe %.2f '
          'nm: cold %.4f s, warm %.4f s, %d-shard mesh %.4f s (equal); K = %d '
          '(max candidates %d); %.4g tests the data needs (%.4g at K); bound '
          '%.4f ms (%s: 9 fp32 operations a test at 67 TFLOP/s; bytes %.4f '
          'ms), warm run at %.3f%% of it; peak %.2f GB; neighbor list equal '
          'to the dense path on %d frames; within %.3g shell-point areas of '
          'float64 (total %.3g)'
          % (card, SASA_FRAMES, xyz.shape[1], SASA_POINTS, SASA_PROBE, t_cold,
             t_warm, SASA_SHARDS, t_mesh, k, need, n_tests,
             float(SASA_FRAMES) * xyz.shape[1] * SASA_POINTS * k, b[0], b[1],
             1e3 * 4 * (xyz.size + 2 * xyz.shape[1] + sasa.size) / HBM_RATE,
             100 * b[0] / (1e3 * t_warm), peak / 2 ** 30, SASA_CHECK,
             (err / tol * 2).max(), total), flush=True)
    return top, base, xyz, labels, groups, sasa


def exposons_check(top, sasa, groups, device, card):
    """Phase 13b: exposons from the SASAs, by stage, held against a
    float64 host einsum (the MI) and the CPU run (the labels)."""
    side, t_cond = timed_s(lambda: exposons.condense_sidechain_sasas(sasa,
                                                                     top))
    w = np.full(len(side), 1 / len(side))
    with Stage(exposons, 'weighted_mi') as mi_st, \
            Stage(exposons, 'affinity_propagation') as ap_st:
        (mi, labels), t_all = timed_s(lambda: exposons.exposons_from_sasas(
            side, 0.9, w, 0.02))
    X = side > 0.02
    onehot = np.stack([X == u for u in range(2)], axis=-1)
    P = np.einsum('tiu,t,tjv->uvij', onehot, w, onehot)
    ref = mutual_info.weighted_mi_from_joint(
        P, X, w, np.full(X.shape[1], 2, dtype='int16'))
    err = float(np.abs(mi - ref).max())
    check(err <= 1e-12, 'exposon MI differs from the host einsum by %g' % err)
    _, cpu_labels = exposons.exposons_from_sasas(side, 0.9, w, 0.02,
                                                 device='cpu')
    check(np.array_equal(labels, cpu_labels),
          'exposon labels differ from the CPU run at residues %s'
          % np.flatnonzero(labels != cpu_labels))
    print('[%s] exposons of %d residues x %d centers: %.4f s = condensation '
          '%.4f s, MI %.4f s (within %.3g of float64), affinity propagation '
          '%.4f s, %d exposons; labels equal the CPU run; planted groups -> '
          'labels: %s' % (card, side.shape[1], len(side), t_cond + t_all,
                          t_cond, mi_st.seconds, err, ap_st.seconds,
                          labels.max() + 1,
                          '; '.join(','.join(map(str, labels[g]))
                                    for g in groups)), flush=True)


def kabsch64(xyz):
    """Every frame of float64 ``xyz`` aligned onto frame 0 (Kabsch)."""
    ref = xyz[0] - xyz[0].mean(0)
    mob = xyz - xyz.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd(np.einsum('fai,aj->fij', mob, ref))
    d = np.sign(np.linalg.det(np.einsum('fji,fkj->fik', Vt, U)))
    D = np.ones((len(xyz), 3))
    D[:, 2] = d
    R = np.einsum('fji,fj,fkj->fik', Vt, D, U)
    return np.einsum('faj,fij->fai', mob, R) + xyz[0].mean(0)


def helix_torsions(n_res):
    """The torsions of :func:`lys_torsions` for an ideal alpha helix: phi
    -57, psi -47, chi 180 degrees."""
    tor = np.full((1, 6 * n_res), 180.0, np.float32)
    tor[:, :n_res], tor[:, n_res:2 * n_res] = -57.0, -47.0
    return tor


def screw_axis(x, n_res):
    """Unit axis of the screw that carries each residue's (N, CA, C) frame
    onto the next one's (float64), pointing from the helix's end toward
    its start."""
    def frame(i):
        n, ca, c = x[9 * i], x[9 * i + 1], x[9 * i + 2]
        e1 = (c - ca) / np.linalg.norm(c - ca)
        e2 = (n - ca) - e1 * ((n - ca) @ e1)
        e2 /= np.linalg.norm(e2)
        return np.stack([e1, e2, np.cross(e1, e2)], 1)
    w, v = np.linalg.eig(frame(n_res // 2 + 1) @ frame(n_res // 2).T)
    ax = np.real(v[:, np.argmin(np.abs(w - 1))])
    ax /= np.linalg.norm(ax)
    return -ax if ax @ (x[9 * (n_res - 1) + 1] - x[1]) > 0 else ax


def geometry_check(top, base, xyz, device, card):
    """Phase 13c: rmsf_calc over the centers, the helix functions on an
    ideal helix, get_pockets on a globule with a planted cavity."""
    pops = np.random.default_rng(15).dirichlet(np.ones(len(xyz)))
    traj = Trajectory(xyz, top)
    per_res, t_rmsf = timed_s(lambda: rmsf.rmsf_calc(traj,
                                                     populations=pops))
    per_atom = rmsf.rmsf_calc(traj, populations=pops, per_residue=False)
    al = kabsch64(xyz.astype(np.float64))
    ref = pops @ ((al - al[0]) ** 2).sum(-1)
    ref_res = np.sqrt(ref.reshape(-1, 9).mean(1))
    err = max(float(np.abs(per_atom - np.sqrt(ref)).max()),
              float(np.abs(per_res - ref_res).max()))
    check(per_res.shape == (GLOB_RES,) and err <= 1e-6,
          'rmsf differs from float64 by %g' % err)

    hx = Trajectory(lys_peptide(helix_torsions(HELIX_RES), device),
                    lys_topology(Topology, HELIX_RES))
    (axis, refs, cross, cen), t_hx = timed_s(
        lambda: helix.calculate_summary_helix_vectors(
            hx, [5, 6, 7], helix_start=1, helix_end=HELIX_RES))
    bb = hx.xyz[0].astype(np.float64).reshape(HELIX_RES, 9, 3)[:, :3]
    bb = bb.reshape(-1, 3)
    win = np.stack([bb[i:i + 12].mean(0) for i in range(len(bb) - 13)])
    telescoped = (win[0] - win[-1]) / np.linalg.norm(win[0] - win[-1])
    ax = axis[0].astype(np.float64)

    def angle(u, v):
        return float(np.arctan2(np.linalg.norm(np.cross(u, v)), u @ v))
    arith = angle(ax, telescoped)
    off = angle(ax, screw_axis(hx.xyz[0].astype(np.float64), HELIX_RES))
    ortho = float(max(np.abs(refs[:, 0] @ axis[0]).max(),
                      np.abs(cross[:, 0] @ axis[0]).max(),
                      np.abs((refs[:, 0] * cross[:, 0]).sum(-1)).max()))
    turn, _ = helix.angles_from_plane_projection(refs[1:, 0], refs[0, 0],
                                                 cross[0, 0])
    check(arith <= 1e-5 and ortho <= 1e-5,
          'helix axis %.3g rad from its float64 formula, frames off by %.3g'
          % (arith, ortho))
    check(off <= 0.02, 'helix axis %.3g rad from the screw axis' % off)

    c = np.zeros(3)
    keep = np.flatnonzero(np.linalg.norm(base - c, axis=1) > POCKET_CAVITY)
    cav = Trajectory(
        (base[None, keep] + np.random.default_rng(16).normal(
            0, 0.02, (POCKET_FRAMES, len(keep), 3))).astype(np.float32),
        top.subset(keep))
    found, t_pk = timed_s(lambda: pockets.get_pockets(cav, n_procs=8))
    check(len(found) == POCKET_FRAMES and None not in found,
          'a frame without pockets')
    dist = [float(np.linalg.norm(p.xyz[0][[a.index for a in p.top.atoms
                                            if a.residue.index == 0]]
                                 .mean(0) - c)) for p in found]
    check(max(dist) <= 0.2, 'the largest pocket lies %.3g nm from the cavity'
          % max(dist))
    print('[%s] rmsf_calc over %d centers: %.4f s, within %.3g of float64; '
          'helix frames of a %d-residue ideal helix %.4f s: axis %.3g rad '
          'from its float64 formula, %.4g rad from the screw axis (the '
          'windowed estimate), frames orthogonal to %.3g, residues 6-7 turn '
          '%.2f and %.2f degrees from residue 5; get_pockets on %d frames of '
          '%d atoms: %.4f s (%.4f s a frame), %d-%d cells in the largest '
          'pocket, its centroid %.3g nm from the cavity'
          % (card, len(xyz), t_rmsf, err, HELIX_RES, t_hx, arith, off, ortho,
             turn[0], turn[1], POCKET_FRAMES, len(keep), t_pk,
             t_pk / POCKET_FRAMES,
             min(sum(a.residue.index == 0 for a in p.top.atoms)
                 for p in found),
             max(sum(a.residue.index == 0 for a in p.top.atoms)
                 for p in found), max(dist)), flush=True)


def label_sites(traj, n, exclude):
    """``n`` pairs of residues (resSeq) for dye labels: the outermost
    residues whose CA -> CB direction points most outward, but for the
    residue indices ``exclude``."""
    cb = dyes.calc_cb_coords(traj[0])
    ca = traj.xyz[0][traj.top.select('name CA')]
    out = ((cb - ca) / np.linalg.norm(cb - ca, axis=1)[:, None]
           * ca / np.linalg.norm(ca, axis=1)[:, None]).sum(1)
    score = out + np.linalg.norm(ca, axis=1)
    score[list(exclude)] = -np.inf
    return (np.argsort(-score)[:2 * n] + 1).reshape(2, n).T


def smfret_check(top, xyz, groups, device, card):
    """Phase 13d: the point-cloud route: dye distance distributions over
    every center on the card, photon bursts sampled from a 2,000-state MSM
    (host numpy streams), then the first bursts again host-only: the CPU's
    distributions of the states they visit (counts equal to the card's),
    the rest NaN, so that a read of any other state fails."""
    traj = Trajectory(xyz, top)
    d1, d2 = dyes.load_dye('SF488'), dyes.load_dye('SF594')
    pairs = label_sites(traj, FRET_PAIRS, np.concatenate(groups))
    dist, t_card = [], 0.0
    for pair in pairs:
        pe, t = timed_s(lambda: dyes.dye_distance_distribution(
            traj, d1, d2, pair, n_procs=8))
        dist.append(pe)
        t_card += t
    n = len(xyz)
    C = sparse_metastable_counts(n, n_blocks=min(25, max(1, n // 8)),
                                 seed=17)
    rows = np.asarray(C.sum(1)).ravel()
    T = scipy.sparse.diags(1 / rows) @ C
    pops = rows / rows.sum()
    rng = np.random.default_rng(18)
    times = []
    for _ in range(FRET_BURSTS):
        k = int(rng.integers(*FRET_PHOTONS, endpoint=True))
        # gaps in us; the lag time 1 ps is 1000 MSM steps a us
        times.append(rng.exponential(rng.uniform(*FRET_STEPS) / k / 1000, k))
    frames = dyes.convert_photon_times(times, 1.0, 1)

    def sample(dist_distribution, bursts):
        # one thread: each burst is a Python loop, and more threads only
        # contend for the interpreter lock
        return dyes.sample_FRET_histograms(
            T, pops, dist_distribution, bursts, 5.4, n_procs=1,
            n_photon_std=2, random_state=0)
    (fe, trajs), t_fe = timed_s(lambda: sample(
        dyes.make_distribution(*dist[0]), frames))
    E = np.array(fe[:, 0], dtype=float)
    check(E.shape == (FRET_BURSTS,) and ((E >= 0) & (E <= 1)).all(),
          'FRET efficiencies outside [0, 1]')

    H = FRET_HOST_BURSTS
    seen = np.unique(np.concatenate([t[f] for t, f in zip(trajs[:H],
                                                          frames[:H])]))
    t = time.perf_counter()
    host = [dyes.dye_distance_distribution(Trajectory(xyz[seen], top), d1,
                                           d2, pair, n_procs=8, device='cpu')
            for pair in pairs]
    t_cpu = time.perf_counter() - t
    for (p, e), (hp, he) in zip(dist, host):
        check(all(np.array_equal(p[s], a) and np.array_equal(e[s], b)
                  for s, a, b in zip(seen, hp, he)),
              'the dye distributions differ from the CPU run')
    rows = list(dyes.make_distribution(*dist[0]))
    for r in range(n):
        rows[r] = rows[r].copy()
        rows[r][:, 1] = np.nan
    for s, row in zip(seen, dyes.make_distribution(*host[0])):
        rows[s] = row
    (hfe, htrajs), t_host = timed_s(lambda: sample(ra.RaggedArray(rows),
                                                   frames[:H]))
    check(np.array_equal(np.asarray(hfe, float), np.asarray(fe[:H], float))
          and all(np.array_equal(a, b) for a, b in zip(htrajs, trajs[:H])),
          'the first %d bursts differ from their host-only run' % H)
    print('[%s] dye_distance_distribution (SF488/SF594) over %d centers for '
          'residue pairs %s: card %.4f s; sample_FRET_histograms, %d bursts '
          'of %d-%d photons over %d-%d MSM steps (%d-state T): %.4f s, mean E '
          '%.4f; host-only run of the first %d bursts: the CPU distributions '
          'of the %d states they visit %.4f s (counts equal the card\'s), '
          'sampling %.4f s, equal bit for bit'
          % (card, n, pairs.tolist(), t_card, FRET_BURSTS, FRET_PHOTONS[0],
             FRET_PHOTONS[1], min(f[-1] for f in frames),
             max(f[-1] for f in frames), n, t_fe, E.mean(), H, len(seen),
             t_cpu, t_host), flush=True)


def structure_path(device, card):
    """Phase 13: SASA, exposons, RMSF, helix, pockets and the smFRET
    point-cloud route on the card, with none of the six kernels
    launched."""
    reset_launches()
    top, base, xyz, labels, groups, sasa = sasa_check(device, card)
    exposons_check(top, sasa, groups, device, card)
    geometry_check(top, base, xyz, device, card)
    smfret_check(top, xyz, groups, device, card)
    launched = (kcenters_chunk.n_launches,
                qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                ell_spmm_kernel.n_launches, kcenters_iteration.n_launches,
                kcenters_iteration_skip.n_launches)
    check(not any(launched), 'phase 13 launched a kernel: %s' % (launched,))
    print('[%s] phase 13 (structure analysis) passed; none of the six '
          'kernels launched' % card, flush=True)



def frame_center_rmsd(prep, ctr):
    """The fp32 QCP RMSD of each real frame i of ``prep`` to frame
    ``ctr[i]`` of the same layout, computed in blocks on its device by
    the plain QCP functions (float64 host array)."""
    a_pad = prep.frames_r.shape[0] // 3
    ctr = torch.as_tensor(np.asarray(ctr), dtype=torch.long,
                          device=prep.g.device)
    out = []
    for lo in range(0, prep.n, CHECK_BLOCK):
        hi = min(lo + CHECK_BLOCK, prep.n)
        c = ctr[lo:hi]
        f = prep.frames_r[:, lo:hi].float().view(3, a_pad, -1)
        fc = prep.frames_r[:, c].float().view(3, a_pad, -1)
        S = tuple((f[i] * fc[j]).sum(0) for i in range(3) for j in range(3))
        out.append(rmsd_from_S_components_unrolled(
            S, prep.g[0, lo:hi] + prep.g[0, c], float(prep.n_atoms))
            .double().cpu())
    return torch.cat(out).numpy()


def rounding_rms(p16, p32):
    """rms over the atoms of each frame's bf16 rounding, from its bf16
    and fp32 layouts (float64 host array)."""
    out = []
    for lo in range(0, p32.n, CHECK_BLOCK):
        hi = min(lo + CHECK_BLOCK, p32.n)
        d = (p16.frames_r[:, lo:hi].float() - p32.frames_r[:, lo:hi]).double()
        out.append((d.square().sum(0) / p32.n_atoms).sqrt().cpu())
    return torch.cat(out).numpy()


def rounding_check(res16, p16, p32, what):
    """Every bf16 distance against the fp32 QCP RMSD of the same frame to
    the same center frame, both unrounded: by RMSD's triangle inequality
    |d_bf16 - d_fp32| <= rms(x_bf16 - x) + rms(c_bf16 - c), plus the fp32
    msd bar of each side. Returns a one-line verdict."""
    ctr_of = np.asarray(res16.center_indices)[res16.assignments]
    d32 = frame_center_rmsd(p32, ctr_of)
    e = rounding_rms(p16, p32)
    bar = msd_bar(p32)
    gap = np.abs(res16.distances - d32)
    allowed = e + e[ctr_of] + 2 * np.sqrt(bar(d32))
    check(bool((gap <= allowed).all()), '%s: |d_bf16 - d_fp32| up to %g, '
          'above the rounding bound at %d frames'
          % (what, gap.max(), int((gap > allowed).sum())))
    check(gap.max() > 0, '%s: no bf16 rounding in the distances' % what)
    return ('%s: |d_bf16 - d_fp32| <= rms(x_bf16 - x) + rms(c_bf16 - c) + '
            'the msd bar at all %d frames (max gap %.4g, max rounding rms '
            '%.4g, max gap / allowed %.3f)'
            % (what, len(gap), gap.max(), e.max(), (gap / allowed).max()))


def chunk_kernels(prep, card):
    """Phases 3 and 14a at the main path's layout: kernels 1 and 2 (the
    chunk with and without skipping) against the plain chunk on one
    iteration, then timed in turns over TIMED_ITERS iterations, held
    against the plain run and each other. Returns their numbers."""
    what = 'bf16 ' if prep.frames_r.dtype == torch.bfloat16 else ''
    start = fresh_state(prep)
    bar = msd_bar(prep)

    def noskip(prep, state, n_iters):
        return kcenters_chunk(prep, state, n_iters, skip=False)
    fns = {'plain': kcenters_chunk_plain, 'kernel': kcenters_chunk,
           'noskip': noskip}
    first = {name: run_chunk(fn, prep, clone(start), 1)
             for name, fn in fns.items()}
    fin = np.isfinite(first['plain'][0])
    err = {}
    for name in ('kernel', 'noskip'):
        err[name] = float(np.abs(first[name][0][fin]
                                 - first['plain'][0][fin]).max())
        check(rmsd_close(first[name][0], first['plain'][0], bar),
              '%sone iteration at full size (%s): distances outside the '
              'msd bar' % (what, name))
    times = {name: [] for name in fns}
    outs = {}
    turns = ('plain', 'kernel', 'noskip', 'noskip', 'kernel', 'plain')
    for name in turns:
        ms, outs[name] = timed_chunk(fns[name], prep, start, TIMED_ITERS)
        times[name].append(ms)
    print(compare_chunks(prep, start, outs['kernel'], outs['plain'],
                         TIMED_ITERS, '%s%d x %d x %d kernel vs plain'
                         % (what, N_FRAMES, N_ATOMS, TIMED_ITERS)))
    check(all(np.array_equal(x, y)
              for x, y in zip(outs['noskip'], outs['kernel'])),
          '%sskip=False differs from skip=True at full size' % what)
    rows, n_pad = prep.frames_r.shape
    skc = outs['kernel'][6]
    visited = 1.0 - skc[skc > 0].sum() / (TIMED_ITERS * (n_pad // prep.tile))
    # per iteration: the frames (2 or 4 bytes a coordinate) of the tiles
    # visited, G, dist and assig read and written; 9 * A_pad fp32 FMAs
    # per frame. Kernel 2 visits every tile.
    size = prep.frames_r.element_size()
    b1 = bound(size * rows * n_pad * visited + 4 * 5 * n_pad,
               2 * 3 * rows * n_pad)
    b2 = bound(size * rows * n_pad + 4 * 5 * n_pad, 2 * 3 * rows * n_pad)
    plain_ms = min(times['plain'])
    nums = {'1': {'max_abs_err': err['kernel'], 'ms': min(times['kernel']),
                  'plain_ms': plain_ms, 'bound_ms': b1[0],
                  'bound_by': b1[1], 'library_ms': None},
            '2': {'max_abs_err': err['noskip'], 'ms': min(times['noskip']),
                  'plain_ms': plain_ms, 'bound_ms': b2[0],
                  'bound_by': b2[1], 'library_ms': None}}
    print('[%s] %sper iteration at %d x %d: kernel 1 %.4f ms (bound %.4f '
          'ms, %s, %.1f%% of it), kernel 2 (skip=False) %.4f ms (bound '
          '%.4f ms), plain %.4f ms (turns %s: %s); one-iteration max '
          '|kernel - plain| %.3g, skip=False %.3g; skip=False bit for bit '
          'the same' % (card, what, N_FRAMES, N_ATOMS, nums['1']['ms'],
                        b1[0], b1[1], 100 * b1[0] / nums['1']['ms'],
                        nums['2']['ms'], b2[0], plain_ms, ', '.join(turns),
                        ', '.join('%.4f' % times[n][turns[:i].count(n)]
                                  for i, n in enumerate(turns)),
                        err['kernel'], err['noskip']), flush=True)
    return nums


def whole_layout_iterations(prep16, device):
    """Phase 14a: kernels 4 and 3 in bf16 on the whole 1M layout as one
    shard, from 8 chunk iterations, against their plain versions."""
    bar = msd_bar(prep16)
    st = fresh_state(prep16)
    kcenters_chunk(prep16, st, 8)
    gidx, md, i = st.scalars()
    dev = device
    col = prep16.frames_r[:, gidx:gidx + 1].float().contiguous()
    gc = prep16.g[:, gidx:gidx + 1].contiguous()
    cases = [iteration_case(prep16, (st.dist, st.assig, st.tmax), col, gc,
                            one(i, torch.int32, dev),
                            one(m, torch.float32, dev), bar)
             for m in (md, float('inf'))]
    print('bf16 %d x %d as one shard, center %d at md %.6g: kernels 4 and 3 '
          'vs plain within the msd bar, tiles skipped %d / %d of %d (md '
          'finite / inf), near-tie flips %d / %d'
          % (N_FRAMES, N_ATOMS, gidx, md, cases[0]['skipped'],
             cases[1]['skipped'], cases[0]['tiles'], cases[0]['flips'],
             cases[1]['flips']), flush=True)


def first_divergence(res, ref, bar, rerun):
    """Phase 9's comparison of two coverings: the same centers with
    distances on the msd bar, or a first differing pick that is a near
    tie in the run before it (``rerun(i)`` clusters to i centers), and
    the covering radii equal to 1e-5. Returns a verdict."""
    ctr, ref_ctr = np.asarray(res.center_indices), ref.center_indices
    diff = np.flatnonzero(ctr != ref_ctr)
    if len(diff) == 0:
        check(rmsd_close(res.distances, ref.distances, bar),
              'distances outside the msd bar of one device')
        same = all(np.array_equal(x, y) for x, y in zip(res, ref))
        verdict = ('the same centers, distances within the msd bar, %d '
                   'near-tie assignment flips, bit for bit: %s'
                   % (int((res.assignments != ref.assignments).sum()), same))
    else:
        i = int(diff[0])
        ca, cb = int(ctr[i]), int(ref_ctr[i])
        before = rerun(i)
        da, db = before.distances[ca], before.distances[cb]
        check(abs(da * da - db * db) <= bar(max(da, db)),
              'pick %d differs (%d vs %d) without a near tie: %r vs %r'
              % (i, ca, cb, da, db))
        verdict = ('first divergence at pick %d (%d vs %d, %.9g vs %.9g, a '
                   'near tie)' % (i, ca, cb, da, db))
    rs, r1 = float(res.distances.max()), float(ref.distances.max())
    check(abs(rs - r1) <= 1e-5 * r1, 'covering radius %r vs %r' % (rs, r1))
    return verdict + '; covering radius %.9g vs %.9g' % (rs, r1)


def bf16_north_star(device, single, t_single, card):
    """Phase 14b: the north star in bf16 through the public functions
    (prepare_rmsd_frames(precision='bf16') -> kcenters_device_fused to
    1000 centers -> lag-10 counts -> top-21 eigenpairs), tri_skip=False
    bit for bit, the rounding check against the fp32 frames, the 4-shard
    mesh (kernels 4 and 3 in bf16) held as phase 9 holds fp32, then the
    kernels of 14a at their shapes. Returns launches and numbers."""
    frames = random_walk(device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    prep16 = engine.prepare_rmsd_frames(frames, precision='bf16')
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t
    check(prep16.frames_r.dtype == torch.bfloat16, 'bf16 layout is %s'
          % prep16.frames_r.dtype)
    engine.kcenters_device_fused(prep16, n_clusters=N_CLUSTERS)  # warm-up

    reset_launches()
    t = time.perf_counter()
    res = engine.kcenters_device_fused(prep16, n_clusters=N_CLUSTERS)
    t_cl = time.perf_counter() - t
    a = res.assignments.reshape(100, -1)
    counts = assigns_to_counts_device(a, np.ones_like(a, bool), LAG,
                                      N_CLUSTERS, device=device)
    torch.cuda.synchronize()
    t_co = time.perf_counter() - t - t_cl
    t = time.perf_counter()
    _, vals, vecs = transpose_timescales_device(counts, N_EIGS,
                                                lag_time=LAG)
    t_eig = time.perf_counter() - t
    launches = kcenters_chunk.n_bf16_launches
    check(launches >= N_CLUSTERS and launches == kcenters_chunk.n_launches,
          'bf16 north star: %d bf16 of %d kernel 1 launches'
          % (launches, kcenters_chunk.n_launches))
    check(qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == 0 and
          ell_spmm_kernel.n_launches == 0 and
          kcenters_iteration.n_launches == 0 and
          kcenters_iteration_skip.n_launches == 0,
          'the bf16 north star launched another kernel')
    check(res.n_found == N_CLUSTERS and np.isfinite(res.distances).all(),
          'bf16: n_found %d' % res.n_found)
    ref_counts = np.bincount(
        (a[:, :-LAG] * N_CLUSTERS + a[:, LAG:]).ravel(),
        minlength=N_CLUSTERS ** 2).reshape(N_CLUSTERS, N_CLUSTERS)
    counts_h = counts.cpu().numpy()
    check(np.array_equal(counts_h, ref_counts), 'bf16 counts differ')
    w_ref, pi_ref = host_eigs(counts_h)
    eig_err = float(np.abs(vals - w_ref).max())
    check(eig_err < 1e-4, 'bf16 eigenvalues differ by %g' % eig_err)

    reset_launches()
    off = engine.kcenters_device_fused(prep16, n_clusters=N_CLUSTERS,
                                       tri_skip=False)
    noskip_launches = kcenters_chunk.n_bf16_launches
    check(noskip_launches >= N_CLUSTERS and
          noskip_launches == kcenters_chunk.n_launches,
          'bf16 tri_skip=False: %d bf16 launches' % noskip_launches)
    check(all(np.array_equal(x, y) for x, y in zip(off, res)),
          'bf16: tri_skip=False differs from tri_skip=True')

    prep32 = engine.prepare_rmsd_frames(frames)
    rounding = rounding_check(res, prep16, prep32, 'bf16 north star')
    print('bf16 north star: %d x %d -> %d centers (%d bf16 kernel 1 '
          'launches), max distance %.6f (fp32 %.6f); lag-%d counts equal '
          'numpy; top-%d eigenvalues within %.2e of float64 numpy; '
          'tri_skip=False bit for bit the same (%d launches)'
          % (N_FRAMES, N_ATOMS, res.n_found, launches, res.distances.max(),
             single.distances.max(), LAG, N_EIGS, eig_err, noskip_launches))
    print(rounding)
    print('[%s] bf16 prepare %.4f s; cluster %.4f s (fp32, phase 2: %.4f s; '
          '%.2fx), counts %.4f s, eigsolve %.4f s, north-star %.4f s'
          % (card, t_prep, t_cl, t_single, t_single / t_cl, t_co, t_eig,
             t_cl + t_co + t_eig), flush=True)

    # the 4-shard mesh: kernel 3 (tri_skip=False, the warm-up), kernel 4
    mesh = FrameMesh((device,) * N_SHARDS)
    msh = engine.prepare_rmsd_frames(frames, mesh=mesh, precision='bf16')
    reset_launches()
    t = time.perf_counter()
    m_off = engine.kcenters_device_fused(msh, n_clusters=N_CLUSTERS,
                                         mesh=mesh, tri_skip=False)
    t_off = time.perf_counter() - t
    k3 = kcenters_iteration.n_bf16_launches
    check(k3 > 0 and k3 == kcenters_iteration.n_launches and
          kcenters_iteration_skip.n_launches == 0,
          'bf16 mesh tri_skip=False: %d bf16 kernel 3 launches' % k3)
    reset_launches()
    t = time.perf_counter()
    m_on = engine.kcenters_device_fused(msh, n_clusters=N_CLUSTERS,
                                        mesh=mesh)
    t_on = time.perf_counter() - t
    k4 = kcenters_iteration_skip.n_bf16_launches
    check(k4 > 0 and k4 == kcenters_iteration_skip.n_launches and
          kcenters_iteration.n_launches == 0 and
          kcenters_chunk.n_launches == 0,
          'bf16 mesh: %d bf16 kernel 4 launches' % k4)
    check(all(np.array_equal(x, y) for x, y in zip(m_on, m_off)),
          'bf16 mesh: tri_skip on and off differ')
    verdict = first_divergence(
        m_on, res, msd_bar(prep16),
        lambda i: engine.kcenters_device_fused(msh, n_clusters=i,
                                               mesh=mesh))
    print('bf16 sharded path on %d shards: tri_skip on and off '
          'bit-identical; against one device: %s' % (N_SHARDS, verdict))
    print('[%s] bf16 sharded cluster %.4f s (kernel 4, %d launches), '
          'tri_skip=False %.4f s (kernel 3, %d launches)'
          % (card, t_on, k4, t_off, k3), flush=True)
    del msh, m_on, m_off, off, prep32
    torch.cuda.empty_cache()

    nums = chunk_kernels(prep16, card)
    whole_layout_iterations(prep16, device)
    del prep16
    torch.cuda.empty_cache()
    prep = engine.prepare_rmsd_frames(frames, mesh=mesh, precision='bf16')
    del frames
    shard = shard_kernels(prep.shards[0], device, card, 'bf16 ')
    nums['3'], nums['4'] = shard['3'], shard['4']
    return {'1': launches, '2': noskip_launches, '3': k3, '4': k4}, nums


class SkipCount:
    """Count the tiles kernel 1 skips inside a ``with`` block (the chunk
    wrapper's skip counts, summed after the block)."""

    def __enter__(self):
        self.fn, self.counts = engine.kcenters_chunk, []

        def counted(*a, **kw):
            ctr, skc = self.fn(*a, **kw)
            self.counts.append(skc)
            return ctr, skc
        engine.kcenters_chunk = counted
        return self

    def __exit__(self, *exc):
        engine.kcenters_chunk = self.fn

    @property
    def skipped(self):
        return int(sum(int(c[c > 0].sum()) for c in self.counts))


def locality_check(device, card):
    """Phase 14c: phase 5's basin frames shuffled (seed SORT_SEED), 1M x
    64 -> 1000 centers, unsorted and locality-sorted: skipped tiles of
    each, the sort's cost, the sorted run's results in the caller's order
    (each center its own cluster's, every distance the recomputed RMSD to
    its center on the msd bar)."""
    X = phase5_data()
    Xs = torch.from_numpy(X[np.random.default_rng(SORT_SEED)
                            .permutation(len(X))]).to(device)
    del X
    prep_u = engine.prepare_rmsd_frames(Xs)
    engine.kcenters_device_fused(prep_u, n_clusters=N_CLUSTERS)  # warm-up
    visits = N_CLUSTERS * (prep_u.n_pad // prep_u.tile)
    with SkipCount() as sk_u:
        t = time.perf_counter()
        un = engine.kcenters_device_fused(prep_u, n_clusters=N_CLUSTERS)
        t_u = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    prep_s = engine.prepare_rmsd_frames(Xs, sort='locality')
    torch.cuda.synchronize()
    t_sort = time.perf_counter() - t
    del Xs
    with SkipCount() as sk_s:
        t = time.perf_counter()
        so = engine.kcenters_device_fused(prep_s, n_clusters=N_CLUSTERS)
        t_s = time.perf_counter() - t
    check(so.n_found == N_CLUSTERS, 'sorted n_found %d' % so.n_found)
    check(sorted(prep_s.perm.tolist()) == list(range(prep_s.n)),
          'the layout order is not a permutation')
    ctr = np.asarray(so.center_indices)
    check(np.array_equal(so.assignments[ctr], np.arange(N_CLUSTERS)),
          'a center is not in its own cluster (caller order)')
    bar = msd_bar(prep_u)
    d = frame_center_rmsd(prep_u, ctr[so.assignments])
    check(rmsd_close(so.distances, d, bar), 'sorted distances differ from '
          'the recomputed RMSD to their centers')
    check(sk_s.skipped > sk_u.skipped, 'the sort skipped %d tiles, the '
          'shuffled order %d' % (sk_s.skipped, sk_u.skipped))
    print('locality sort on shuffled basin data, %d x %d -> %d: skipped '
          'tile visits %d unsorted, %d sorted, of %d; the sorted results in '
          'the caller\'s order, every distance the recomputed RMSD on the '
          'msd bar; covering radius %.6f sorted, %.6f unsorted'
          % (N_FRAMES, N_ATOMS, N_CLUSTERS, sk_u.skipped, sk_s.skipped,
             visits, so.distances.max(), un.distances.max()))
    print('[%s] sort (key, argsort, layout) %.4f s; cluster unsorted %.4f s,'
          ' sorted %.4f s' % (card, t_sort, t_u, t_s), flush=True)
    del prep_u, prep_s
    torch.cuda.empty_cache()


def ingest_check(device, card):
    """Phase 14d: a 1M x 64 host array ingested streamed (pinned chunks
    on a side stream) and in one copy, in both precisions, in turns
    (one copy, streamed, streamed, one copy): the same bits."""
    X = random_walk(device).cpu().numpy()
    for precision in ('fp32', 'bf16'):
        times, preps = {'one copy': [], 'streamed': []}, {}
        for turn in ('one copy', 'streamed', 'streamed', 'one copy'):
            torch.cuda.synchronize()
            t = time.perf_counter()
            p = engine.prepare_rmsd_frames(X, precision=precision,
                                           stream=turn == 'streamed')
            torch.cuda.synchronize()
            times[turn].append(time.perf_counter() - t)
            preps.setdefault(turn, p)
            del p
        a, b = preps['one copy'], preps['streamed']
        check(torch.equal(a.frames_r, b.frames_r) and torch.equal(a.g, b.g),
              '%s: the streamed layout differs from the one copy'
              % precision)
        check(a.frames_r.dtype == engine._FRAME_DTYPE[precision],
              '%s layout is %s' % (precision, a.frames_r.dtype))
        print('[%s] ingest of a %d x %d host array, %s: one copy %s s, '
              'streamed (%d MiB chunks) %s s; bit for bit the same'
              % (card, N_FRAMES, N_ATOMS, precision,
                 ' / '.join('%.4f' % x for x in times['one copy']),
                 engine._STREAM_CHUNK_BYTES >> 20,
                 ' / '.join('%.4f' % x for x in times['streamed'])),
              flush=True)
        del preps, a, b
        torch.cuda.empty_cache()


def cli_check(device, card):
    """Phase 14e: `cluster --algorithm kcenters --cluster-number 1000` on
    the first BF16_CLI_FILES of phase 5's XTC files, with --precision
    bf16 and then with --locality-sort (the app's sequence but for its
    .h5 writes); the center indices and structures read back and checked
    against the frames, every distance against its recomputed RMSD."""
    with tempfile.TemporaryDirectory() as d:
        pdb, trjs, gsum = write_trajectories(d, BF16_CLI_FILES)
        bar = bar_from(gsum, N_ATOMS)
        for flag in (['--precision', 'bf16'], ['--locality-sort']):
            out = {k: os.path.join(d, v) for k, v in (
                ('--distances', 'dist.h5'), ('--assignments', 'assig.h5'),
                ('--center-features', 'centers.pkl'),
                ('--center-indices', 'inds.npy'))}
            argv = ['cluster', '--trajectories', *trjs, '--topology', pdb,
                    '--atoms', 'name CA', '--algorithm', 'kcenters',
                    '--cluster-number', str(N_CLUSTERS), *flag]
            for k, v in out.items():
                argv += [k, v]
            reset_launches()
            args = cluster_app.process_command_line(argv)
            t = time.perf_counter()
            lengths, data = cluster_util.load_trjs_or_features(args)
            t_load = time.perf_counter() - t
            t = time.perf_counter()
            clustering = cluster_app.fit(args, data, device)
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t
            bf16 = flag[0] == '--precision'
            n1, n16 = kcenters_chunk.n_launches, kcenters_chunk.n_bf16_launches
            check(n1 > 0 and n16 == (n1 if bf16 else 0),
                  '%s: %d kernel 1 launches, %d on bf16' % (flag[0], n1, n16))
            res = clustering.result_
            result = res.partition(lengths)
            t = time.perf_counter()
            cluster_util.write_centers_indices(
                args.center_indices, cluster_app.center_indices(result, args))
            cluster_util.write_centers(result, args)
            t_write = time.perf_counter() - t

            inds = np.load(out['--center-indices'])
            with open(out['--center-features'], 'rb') as f:
                centers = pickle.load(f)
            xyz = data.xyz
            glob = [t_ * TRJ_FRAMES + f_ for t_, f_ in inds]
            check(len(centers) == N_CLUSTERS and len(set(glob)) == N_CLUSTERS,
                  '%s: %d centers read back' % (flag[0], len(centers)))
            check(all(np.array_equal(c.xyz[0], xyz[g])
                      for c, g in zip(centers, glob)),
                  '%s: a center structure is not its frame' % flag[0])
            check(np.array_equal(res.assignments[glob], np.arange(N_CLUSTERS)),
                  '%s: a center is not in its own cluster' % flag[0])
            p32 = engine.prepare_rmsd_frames(xyz, device=device)
            ctr_of = np.asarray(glob)[res.assignments]
            if bf16:
                p16 = engine.prepare_rmsd_frames(xyz, device=device,
                                                 precision='bf16')
                verdict = rounding_check(res, p16, p32, '--precision bf16')
                del p16
            else:
                check(rmsd_close(res.distances,
                                 frame_center_rmsd(p32, ctr_of), bar),
                      '--locality-sort: distances differ from the '
                      'recomputed RMSD to their centers')
                verdict = ('--locality-sort: every distance the recomputed '
                           'RMSD to its center on the msd bar')
            del p32
            print('cluster CLI, %d XTC files x %d frames, kcenters -> %d, '
                  '%s: %d kernel 1 launches (%d on bf16); centers read back '
                  'equal to their frames; %s'
                  % (BF16_CLI_FILES, TRJ_FRAMES, N_CLUSTERS, ' '.join(flag),
                     n1, n16, verdict))
            print('[%s] cluster CLI %s: load %.4f s, cluster %.4f s, write '
                  'centers %.4f s' % (card, ' '.join(flag), t_load, t_fit,
                                      t_write), flush=True)


def bf16_path(device, single, t_single, card):
    """Phase 14: the bf16 frame stream, the locality sort, the streamed
    ingest and the CLI flags. Returns kernel launches and numbers of the
    bf16 kernels."""
    launches, nums = bf16_north_star(device, single, t_single, card)
    torch.cuda.empty_cache()
    locality_check(device, card)
    ingest_check(device, card)
    cli_check(device, card)
    print('[%s] phase 14 (bf16, locality sort, streamed ingest, CLI flags) '
          'passed' % card, flush=True)
    return launches, nums


# phase 15, the explicit-dye route: the two synthetic dyes (library name,
# file stem, seed), their conformations (= dye MSM states) and the atoms
# of their chromophore; the centers of the host per-photon run, the
# photons of each of its centers and of the device MC's exact checks; the
# centers held against the CPU's clash test; bursts; dye lag time (ns); the
# acceptor's shift (nm) of the second exact check
DYES = (('SimFluor 488D C1R', 'SD488', 21), ('SimFluor 594A C1R', 'SD594',
                                             22))
DYE_FRAMES, DYE_RING = 500, 46
DYE_SAMPLES, DYE_HOST_CENTERS, DYE_HOST_SAMPLES = 1000, 4, 50
DYE_EXACT_PHOTONS, DYE_CPU_CENTERS = 100_000, 8
DYE_BURSTS, DYE_LAG, DYE_FAR = 1000, 0.002, 7.5


def _nerf(a, b, c, bond, angle, torsion):
    """NeRF in float64 numpy: the atom bonded to ``c`` (F, 3) at ``bond`` nm,
    angle b-c-d ``angle`` degrees and torsion a-b-c-d ``torsion`` (radians,
    (F,))."""
    bc = (c - b) / np.linalg.norm(c - b, axis=-1, keepdims=True)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    m = np.cross(n, bc)
    t = np.deg2rad(angle)
    return (c - bond * np.cos(t) * bc
            + (bond * np.sin(t) * np.cos(torsion))[:, None] * m
            + (bond * np.sin(t) * np.sin(torsion))[:, None] * n)


def dye_conformations(topology_cls, n_frames, seed, n_ring=DYE_RING):
    """A synthetic dye of ``topology_cls``: a Cys-like residue (N, CA, C, O,
    CB; 0.005 nm of noise a frame), its SG, an 8-carbon linker of random
    torsions and a planar chromophore of ``n_ring`` carbons (C9...) on a
    hexagonal grid, turned by a random torsion about the last linker bond:
    (topology, float32 (n_frames, 14 + n_ring, 3) in nm)."""
    rng = np.random.default_rng(seed)
    F = n_frames
    N = np.zeros((F, 3))
    CA = np.zeros((F, 3))
    CA[:, 0] = 0.1458
    C = np.zeros((F, 3))
    t = np.deg2rad(111.2)
    C[:, 0] = 0.1458 - 0.1525 * np.cos(t)
    C[:, 1] = 0.1525 * np.sin(t)
    O = _nerf(N, CA, C, 0.1231, 120.5, np.full(F, np.pi))
    CB = _nerf(C, N, CA, 0.153, 110.5, np.full(F, np.deg2rad(-122.6)))
    back = np.stack([N, CA, C, O, CB], 1)
    back += rng.normal(0, 0.005, back.shape)
    N, CA, C, O, CB = back.transpose(1, 0, 2)
    chi1 = np.deg2rad(rng.choice([-60.0, 60.0, 180.0], F)
                      + rng.normal(0, 10, F))
    chain = [CA, CB, _nerf(N, CA, CB, 0.181, 114.0, chi1)]
    for k in range(8):
        chain.append(_nerf(chain[-3], chain[-2], chain[-1],
                           0.181 if k == 0 else 0.153,
                           100.0 if k == 0 else 111.0,
                           rng.uniform(-np.pi, np.pi, F)))
    # the chromophore's plane: along the last bond u, and v turned about u
    u = chain[-1] - chain[-2]
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    w = np.cross(u, chain[-2] - chain[-3])
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    v = np.cross(w, u)
    phi = rng.uniform(-np.pi, np.pi, F)[:, None]
    v = np.cos(phi) * v + np.sin(phi) * w
    cols = -(-n_ring // 4)
    grid = [(0.14 + j * 0.121 + (i % 2) * 0.0605, (i - 1.5) * 0.105)
            for i in range(4) for j in range(cols)][:n_ring]
    ring = np.stack([chain[-1] + x * u + y * v for x, y in grid], 1)
    xyz = np.concatenate([back[:, :4], np.stack(chain[1:], 1), ring], 1)
    top = topology_cls()
    res = top.add_residue('C1R', top.add_chain(), 1)
    names = (['N', 'CA', 'C', 'O', 'CB', 'SG']
             + ['C%d' % k for k in range(1, 9 + n_ring)])
    for name in names:
        top.add_atom(name, name[0], res)
    return top, xyz.astype(np.float32)


def dye_counts(n, seed):
    """Integer transition counts (n, n) that satisfy detailed balance (a
    symmetric matrix): 1-9 counts between every two states, 2,000-3,999 on
    the diagonal. Every pair of states is joined, so the states a clash
    test keeps stay one chain."""
    rng = np.random.default_rng(seed)
    c = np.triu(rng.integers(1, 10, (n, n)), 1)
    return c + c.T + np.diag(rng.integers(2000, 4000, n))


def explicit_dye_library(path, seed, n_frames=DYE_FRAMES, n_ring=DYE_RING):
    """Write a synthetic explicit-dye library under ``path``: for each dye
    of :data:`DYES` its conformations (``trajs/<stem>_cutoff10.dcd``, the
    topology in ``structures/<stem>.pdb``) and its detailed-balance counts
    (``<stem>_tcounts.npy``), the ``libraries.yml`` entries and the builtin
    ``R0/`` tables under the dyes' names. Point $ENSPARA_TPU_DYE_DIR at
    ``path`` to use it. Returns ``{stem: (name, dcd, pdb, counts)}``."""
    import shutil
    from enspara_tpu_torch import data as data_pkg
    for sub in ('trajs', 'structures'):
        os.makedirs(os.path.join(path, sub), exist_ok=True)
    shutil.copytree(os.path.join(os.path.dirname(data_pkg.__file__),
                                 'dyes_builtin', 'R0'),
                    os.path.join(path, 'R0'), dirs_exist_ok=True)
    out, yml = {}, []
    for k, (name, stem, s) in enumerate(DYES):
        top, xyz = dye_conformations(Topology, n_frames, seed + s, n_ring)
        traj = Trajectory(xyz, top)
        dcd = os.path.join(path, 'trajs', stem + '_cutoff10.dcd')
        pdb = os.path.join(path, 'structures', stem + '.pdb')
        port_io.write_dcd(dcd, traj)
        write_pdb(pdb, traj[0])
        counts = os.path.join(path, stem + '_tcounts.npy')
        np.save(counts, dye_counts(n_frames, seed + s))
        yml.append('%s:\n  author: synthetic (chip_smoke.py)\n  citation: '
                   'none\n  filename: %s_cutoff10\n  licence: MIT\n  mu:\n'
                   '  - C9\n  - C%d\n  negative: []\n  positive: []\n  r:\n'
                   '  - C%d\n  CB:\n  - name CB\n'
                   % (name, stem, 8 + n_ring, 9 + n_ring // 2))
        out[stem] = (name, dcd, pdb, counts)
    with open(os.path.join(path, 'libraries.yml'), 'w') as f:
        f.write(''.join(yml))
    return out


def exact_outcomes(probs, d_tprobs, a_tprobs, d_eqs, a_eqs, device,
                   tol=1e-12, check=256):
    """The absorbing chain the lockstep MC samples, solved in float64 on
    ``device``: from (d, a) the photon ends in outcome c with
    ``probs[d, a, c]``, else moves to (d', a') by T_d x T_a. The
    probabilities X_c of ending in c and the mean step count M are the
    fixed points of X_c <- P_c + S o (T_d X_c T_a^T) and M <- 1 + S o (T_d M
    T_a^T) (S = probs[..., 3]), iterated from 0 until no entry changes by
    ``tol`` (relative to the entry where it exceeds 1: a mean of hundreds
    of steps has rounding noise above 1e-12). Returns (fractions (3,) and
    mean steps from pi_0 = eq_d x eq_a, iterations)."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)
    P, Td, Ta = t(probs), t(d_tprobs), t(a_tprobs)
    S = P[..., 3]
    B = torch.cat([P[..., :3].permute(2, 0, 1), torch.ones_like(S)[None]])
    X = torch.zeros_like(B)
    it = 0
    while True:
        for _ in range(check):
            prev, X = X, B + S * (Td @ X @ Ta.T)
            it += 1
        delta = float(((X - prev).abs() / X.abs().clamp_min(1)).max())
        if delta < tol:
            break
    w = (t(d_eqs)[:, None] * t(a_eqs)[None])
    out = (X * w).sum(dim=(1, 2)).cpu().numpy()
    return out[:3], float(out[3]), it


def overlap64(r0_dir, donor, acceptor):
    """(J, QD, Td) of a dye pair from the ``R0/`` tables by a float64 numpy
    trapezoid, read with ``np.loadtxt`` and ``str.split``: the spectra
    paired row by row, the emission and excitation in percent, the
    extinction table without a header."""
    (dfl, dnum), (afl, anum) = (n.split(' ')[:2] for n in (donor, acceptor))
    d = np.loadtxt(os.path.join(r0_dir, dfl + dnum + '.csv'), delimiter=',',
                   skiprows=1)
    a = np.loadtxt(os.path.join(r0_dir, afl + anum + '.csv'), delimiter=',',
                   skiprows=1)
    with open(os.path.join(r0_dir, 'Dyes_extinction_QD.csv')) as f:
        rows = [r.strip().split(',') for r in f if r.strip()]
    qd = np.array([float(r[3]) for r in rows if r[:2] == [dfl, dnum]])
    td = np.array([float(r[4]) for r in rows if r[:2] == [dfl, dnum]])
    ext = [float(r[2]) for r in rows if r[:2] == [afl, anum]][0]
    trapezoid = getattr(np, 'trapezoid', None) or np.trapz
    wl, em = d[:, 0], d[:, 2] / 100
    J = trapezoid(em * (ext * (a[:, 1] / 100)) * wl ** 4, x=wl) \
        / trapezoid(em, x=wl)
    return J, qd, td


class _Stages:
    """Wraps ``dye_lifetimes._calc_lifetimes_all`` to keep each call's
    events, stage info and its start and end on the host clock."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        events, info = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.calls.append((events, dict(info, start=t,
                                        end=time.perf_counter())))
        return events, info


def dye_cli(argv, stages):
    """``enspara smfret-dyes`` through the dispatcher: (its seconds, the
    events and stage info of its calc_lifetimes call or None)."""
    n = len(stages.calls)
    t = time.perf_counter()
    main_app.main(['enspara', 'smfret-dyes'] + argv)
    torch.cuda.synchronize()
    t = (t, time.perf_counter())
    return t, (stages.calls[n] if len(stages.calls) > n else None)


def explicit_dye_path(device, card):
    """Phase 15: the explicit-dye route through `enspara smfret-dyes` on
    phase 13's centers with a synthetic dye library, with none of the six
    kernels launched."""
    reset_launches()
    top = lys_topology(Topology, GLOB_RES)
    xyz, _, groups = globule_frames(globule(GLOB_RES), SASA_FRAMES, seed=14)
    traj = Trajectory(xyz, top)
    n = len(traj)
    saved = os.environ.get('ENSPARA_TPU_DYE_DIR')
    stages = _Stages(dl._calc_lifetimes_all)
    dl._calc_lifetimes_all = stages
    try:
        with tempfile.TemporaryDirectory() as d:
            lib_dir = os.path.join(d, 'dyes')
            t = time.perf_counter()
            lib = explicit_dye_library(lib_dir, 20, n_frames=DYE_FRAMES)
            t_lib = time.perf_counter() - t
            os.environ['ENSPARA_TPU_DYE_DIR'] = lib_dir
            pair = dye_sites(traj, np.concatenate(groups), lib, device)
            explicit_dye_checks(d, lib, traj, pair, device, card, stages,
                                t_lib)
    finally:
        dl._calc_lifetimes_all = stages.fn
        if saved is None:
            os.environ.pop('ENSPARA_TPU_DYE_DIR', None)
        else:
            os.environ['ENSPARA_TPU_DYE_DIR'] = saved
    launched = (kcenters_chunk.n_launches,
                qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                ell_spmm_kernel.n_launches, kcenters_iteration.n_launches,
                kcenters_iteration_skip.n_launches)
    check(not any(launched), 'phase 15 launched a kernel: %s' % (launched,))
    print('[%s] phase 15 (explicit dyes) passed over %d centers; none of '
          'the six kernels launched' % (card, n), flush=True)


def dye_sites(traj, exclude, lib, device, n_sites=8, n_frames=16,
              apart=2.5):
    """The residue pair of phase 15: of the ``n_sites`` residues that
    :func:`label_sites` ranks first, the one where the donor of ``lib``
    keeps the most conformations on the first ``n_frames`` centers, and of
    the others (those whose CA lies ``apart`` nm or more from the donor
    site's on the first center, if any) the one where the acceptor keeps
    the most. (The globule's residues are lattice points: a site that
    faces out by its ideal CB can still bury the dye.)"""
    sites = label_sites(traj, n_sites // 2, exclude).ravel()
    meta = r0c.load_library()
    kept = []
    for name, dcd, pdb, _ in lib.values():
        dye = port_io.load(dcd, top=pdb)
        kept.append([sum(map(len, r0c._place_and_prune(
            traj[:n_frames], dye, int(r), name, meta, n_procs=8,
            device=device)[1])) for r in sites])
    d = int(np.argmax(kept[0]))
    ca = traj.xyz[0][traj.top.select('name CA')][sites - 1]
    far = np.linalg.norm(ca - ca[d], axis=1) >= apart
    others = [k for k in range(len(sites)) if k != d and (far[k]
                                                          or not far.any())]
    a = max(others, key=lambda k: kept[1][k])
    return np.array([sites[d], sites[a]])


def _outcome_fractions(events):
    out = np.concatenate([np.asarray(e[1]) for e in events if len(e[1])])
    return np.array([(out == c).mean() for c in
                     ('radiative', 'non_radiative', 'energy_transfer')])


def _check_events(path, n_centers, n_samples, what):
    events = np.load(path, allow_pickle=True)
    check(len(events) == n_centers, '%s: %d event pairs for %d centers'
          % (what, len(events), n_centers))
    live = 0
    for lt, oc in events:
        lt, oc = np.asarray(lt, float), np.asarray(oc)
        check(len(lt) == len(oc) and len(lt) in (0, n_samples)
              and np.isfinite(lt).all() and (lt >= 0).all(),
              '%s: a center\'s lifetimes' % what)
        check(set(oc.tolist()) <= {'radiative', 'non_radiative',
                                   'energy_transfer'},
              '%s: outcomes outside the three channels' % what)
        live += len(lt) > 0
    check(live > 0, '%s: no center took both dyes' % what)
    return events


def explicit_dye_checks(d, lib, traj, pair, device, card, stages, t_lib):
    """Phase 15's runs and checks in the directory ``d`` (see
    :func:`explicit_dye_path`)."""
    n = len(traj)
    (dname, ddcd, dpdb, dcnt), (aname, adcd, apdb, acnt) = lib.values()
    names = [dname, aname]
    lib_dir = os.environ['ENSPARA_TPU_DYE_DIR']

    # (J, QD, Td) against the inline float64 trapezoid
    got = r0c.get_dye_overlap(dname, aname)
    ref = overlap64(os.path.join(lib_dir, 'R0'), dname, aname)
    check(got[0] == ref[0] and all(np.array_equal(x, y) for x, y in
                                   zip(got[1:], ref[1:])),
          '(J, QD, Td) %s differ from the float64 trapezoid %s' % (got, ref))

    port_io.write_dcd(os.path.join(d, 'centers.dcd'), traj)
    write_pdb(os.path.join(d, 'prot.pdb'), traj[0])
    np.savetxt(os.path.join(d, 'pair.txt'), pair[None], fmt='%d')
    common = ['--donor_name', dname, '--donor_centers', ddcd, '--donor_top',
              dpdb, '--donor_tcounts', dcnt, '--acceptor_name', aname,
              '--acceptor_centers', adcd, '--acceptor_top', apdb,
              '--acceptor_tcounts', acnt, '--dye_lagtime', str(DYE_LAG),
              '--prot_top', os.path.join(d, 'prot.pdb'), '--resid_pairs',
              os.path.join(d, 'pair.txt'), '--n_procs', '8', '--rng_seed',
              '1']
    ev_name = 'events-%d-%d.npy' % tuple(pair)

    # (a) every center on the card, then the static and isotropic dyes
    runs = {}
    for treatment in ('Monte-carlo-device', 'static', 'isotropic'):
        out = os.path.join(d, treatment)
        (t0, t1), (events, info) = dye_cli(
            ['calc_lifetimes'] + common + [
                '--prot_centers', os.path.join(d, 'centers.dcd'),
                '--dye_treatment', treatment, '--n_samples',
                str(DYE_SAMPLES), '--output_dir', out], stages)
        ev = _check_events(os.path.join(out, ev_name), n, DYE_SAMPLES,
                           treatment)
        runs[treatment] = (ev, info)
        kept = [sum(map(len, k)) / (n * DYE_FRAMES) for k in info['kept']]
        mc = ''
        if treatment == 'Monte-carlo-device':
            mc = (' (%d lockstep steps, %d photon-steps, %.4g photon-steps/s)'
                  % (info['lockstep_steps'], info['photon_steps'],
                     info['photon_steps'] / info['treatment']))
        print('[%s] enspara smfret-dyes calc_lifetimes --dye_treatment %s, '
              '%d centers x %d samples, residues %d-%d: %.4f s = load '
              '%.4f s, placement %.4f s, clash test %.4f s (%.4g tests, '
              '%.4g tests/s), dye MSMs %.4f s, %s %.4f s%s, write %.4f s; '
              '%.1f%% / %.1f%% of the dye states kept'
              % (card, treatment, n, DYE_SAMPLES, pair[0], pair[1], t1 - t0,
                 info['start'] - t0, info['placement'], info['clash'],
                 info['tests'], info['tests'] / info['clash'], info['msm'],
                 treatment, info['treatment'], mc, t1 - info['end'],
                 100 * kept[0], 100 * kept[1]), flush=True)
    dev_events, dev_info = runs['Monte-carlo-device']
    for other in ('static', 'isotropic'):
        check([len(e[0]) > 0 for e in runs[other][0]]
              == [len(e[0]) > 0 for e in dev_events],
              '%s labels other centers than the device run' % other)

    # the kept dye states of the first centers against the CPU's
    lib_meta = r0c.load_library()
    t = time.perf_counter()
    for k, (name, dcd, pdb, _) in enumerate(lib.values()):
        dye = port_io.load(dcd, top=pdb)
        _, cpu_kept, _ = r0c._place_and_prune(
            traj[:DYE_CPU_CENTERS], dye, int(pair[k]), name, lib_meta,
            n_procs=8, device='cpu')
        check(all(np.array_equal(a, b) for a, b in
                  zip(cpu_kept, dev_info['kept'][k][:DYE_CPU_CENTERS])),
              'the kept dye states of %s differ from the CPU run' % name)
    t_cpu = time.perf_counter() - t

    # the lockstep MC against the exact absorbing chain at one center: the
    # dyes as the route gives them (energy transfer nearly always), then
    # the acceptor moved DYE_FAR nm, where no outcome dominates
    live = [i for i, e in enumerate(dev_events) if len(e[0])]
    c = live[0]
    msm = [dl.make_dye_msm(port_io.load(dcd, top=pdb), np.load(cnt),
                           traj[c], int(pair[k]), name, lib_meta,
                           device=device)
           for k, (name, dcd, pdb, cnt) in enumerate(lib.values())]
    centers = [port_io.load(dcd, top=pdb) for _, dcd, pdb, _ in lib.values()]
    far = centers[1].copy()
    far.xyz = far.xyz + np.float32([DYE_FAR, 0.0, 0.0])
    params = r0c.get_dye_overlap(dname, aname)
    N = DYE_EXACT_PHOTONS
    exact = []
    for acceptor, seed in ((centers[1], 3), (far, 4)):
        (steps, out), t_mc = timed_s(lambda: dl.resolve_excitations_device(
            dname, aname, msm[0][0], msm[1][0], msm[0][1], msm[1][1],
            centers[0], acceptor, params, DYE_LAG, lib_meta, n_samples=N,
            rng_seed=seed, device=device))
        probs = dl._pair_rate_tables(dname, aname, centers[0], acceptor,
                                     params, DYE_LAG, lib_meta)
        (frac, mean, iters), t_exact = timed_s(lambda: exact_outcomes(
            probs, msm[0][0], msm[1][0], msm[0][1], msm[1][1], device))
        got = np.array([(out == ch).mean() for ch in
                        ('radiative', 'non_radiative', 'energy_transfer')])
        z = np.abs(got - frac) / np.sqrt(
            np.maximum(frac * (1 - frac), 1e-300) / N)
        z_steps = abs(steps.mean() - mean) / (steps.std() / np.sqrt(N))
        check((z < 5).all() and z_steps < 5,
              'the lockstep MC at center %d: fractions %s against exact %s '
              '(%s standard errors), mean steps %.3f against %.3f (%.2f)'
              % (c, got, frac, z, steps.mean(), mean, z_steps))
        exact.append('%.4f s, fractions %s against the exact chain %s (%s '
                     'standard errors), mean steps %.3f against %.3f (%.2f), '
                     'the exact chain %d iterations %.4f s'
                     % (t_mc, np.round(got, 4), np.round(frac, 4),
                        np.round(z, 2), steps.mean(), mean, z_steps, iters,
                        t_exact))
    check((frac > 0.02).all(), 'the acceptor %g nm away: an outcome of the '
          'exact chain dominates %s' % (DYE_FAR, frac))

    # (b) the host per-photon walk on a few centers
    host = live[:DYE_HOST_CENTERS]
    port_io.write_dcd(os.path.join(d, 'few.dcd'), traj[host])
    out = os.path.join(d, 'host')
    (t0, t1), _ = dye_cli(['calc_lifetimes'] + common + [
        '--prot_centers', os.path.join(d, 'few.dcd'), '--dye_treatment',
        'Monte-carlo', '--n_samples', str(DYE_HOST_SAMPLES), '--output_dir',
        out], stages)
    host_ev = _check_events(os.path.join(out, ev_name), len(host),
                            DYE_HOST_SAMPLES, 'Monte-carlo')
    f_host = _outcome_fractions(host_ev)
    f_dev = _outcome_fractions([dev_events[i] for i in host])
    check(np.abs(f_host - f_dev).max() <= 0.10,
          'host walk fractions %s against the device %s' % (f_host, f_dev))
    t_host = t1 - t0

    # (c) bursts over phase 13's 2,000-state MSM
    C = sparse_metastable_counts(n, n_blocks=min(25, max(1, n // 8)),
                                 seed=17)
    rows = np.asarray(C.sum(1)).ravel()
    np.save(os.path.join(d, 'prot_counts.npy'), C.toarray())
    np.save(os.path.join(d, 'prot_eqs.npy'), rows / rows.sum())
    rng = np.random.default_rng(18)
    times = []
    for _ in range(DYE_BURSTS):
        k = int(rng.integers(*FRET_PHOTONS, endpoint=True))
        times.append(rng.exponential(rng.uniform(*FRET_STEPS) / k / 1000, k))
    np.save(os.path.join(d, 'photons.npy'), np.array(times, dtype=object),
            allow_pickle=True)
    out = os.path.join(d, 'bursts')
    (t0, t1), _ = dye_cli([
        'run_burst', '--eq_probs', os.path.join(d, 'prot_eqs.npy'),
        '--t_counts', os.path.join(d, 'prot_counts.npy'), '--lifetimes_dir',
        os.path.join(d, 'Monte-carlo-device'), '--donor_name', dname,
        '--acceptor_name', aname, '--lagtime', '1', '--resid_pairs',
        os.path.join(d, 'pair.txt'), '--photon_times',
        os.path.join(d, 'photons.npy'), '--correction_factor', '1',
        '--output_dir', out], stages)
    fe = np.load(os.path.join(out, 'FEs', 'FE-%d-%d-1.npy' % tuple(pair)),
                 allow_pickle=True).astype(float)
    check(fe.shape == (DYE_BURSTS,) and ((fe >= 0) & (fe <= 1)).all(),
          'run_burst: FE of shape %s outside [0, 1]' % (fe.shape,))
    print('[%s] explicit dyes: synthetic library (2 dyes x %d conformations '
          'x %d atoms) %.4f s; (J, QD, Td) equal the float64 trapezoid; '
          'the kept dye states of %d centers equal the CPU run (%.4f s); '
          'the lockstep MC at center %d, %d photons: %s; with the acceptor '
          '%g nm away: %s; host walk on %d centers x %d samples %.4f s, '
          'fractions %s against the device run %s; run_burst of %d bursts '
          '%.4f s, mean E %.4f'
          % (card, DYE_FRAMES, centers[0].n_atoms, t_lib, DYE_CPU_CENTERS,
             t_cpu, c, N, exact[0], DYE_FAR, exact[1], len(host),
             DYE_HOST_SAMPLES, t_host, np.round(f_host, 3),
             np.round(f_dev, 3), DYE_BURSTS, t1 - t0, fe.mean()), flush=True)


# phase 16, the PAM sweeps over a frame mesh and the multi-process CLI: the
# sweeps of 16b, the processes and phase 5's XTC files of 16c
MESH_SWEEPS = 2
JOB_PROCS, JOB_FILES = 2, 10
JOB_WORKER_FLAG = '--job-worker'
# phase 16d: at most this many processes, one a card; a job's processes
# are ended after JOB_TIMEOUT seconds
CARD_JOB_PROCS, JOB_TIMEOUT = 4, 600


def pam_cost(d):
    return float(np.mean(np.asarray(d, np.float64) ** 2))


def compare_pam(got, ref, bar, what):
    """Phase 16's check of a mesh run ``got`` against one device ``ref``,
    each ``(medoids, distances, assignments)``: the same medoids, the
    distances within the msd bar and the assignments equal but for near
    ties; or, where the medoids differ, final costs within 1e-5
    relative. Returns the verdict."""
    (gm, gd, ga), (rm, rd, ra) = got, ref
    gm, rm = np.asarray(gm), np.asarray(rm)
    ga, ra = np.asarray(ga), np.asarray(ra)
    gd, rd = np.asarray(gd, np.float64), np.asarray(rd, np.float64)
    n_diff = int((gm != rm).sum())
    cg, cr = pam_cost(gd), pam_cost(rd)
    flips = ga != ra
    if n_diff == 0:
        check(rmsd_close(gd, rd, bar), '%s: distances outside the msd bar'
              % what)
        check(bool((np.abs(gd[flips] ** 2 - rd[flips] ** 2)
                    <= bar(np.maximum(gd[flips], rd[flips]))).all()),
              '%s: assignments differ beyond near ties' % what)
    else:
        check(abs(cg - cr) <= 1e-5 * cr, '%s: %d medoids differ and the '
              'cost %r is not within 1e-5 of %r' % (what, n_diff, cg, cr))
    return ('%d of %d medoids differ, %d assignments (near ties), cost '
            '%.9g vs %.9g one device' % (n_diff, len(gm), int(flips.sum()),
                                         cg, cr))


def khybrid_mesh_check(X, mesh, device, card, phase5):
    """Phase 16a: KHybrid at phase 5's scale over the mesh and on one
    device, by stage. Returns kernel 5's launches over the mesh and the
    mesh's result (medoids, assignments, distances)."""
    bar = bar_from(2.02 * float(np.einsum(
        'nai,nai->n', X - X.mean(1, keepdims=True),
        X - X.mean(1, keepdims=True)).max()), N_ATOMS)
    runs = {}
    for name, kw in (('mesh', dict(mesh=mesh)), ('one', dict(device=device))):
        reset_launches()
        engine_kmedoids._pam_sweeps.n_host_syncs = 0
        with Stage(hybrid_mod, '_kcenters') as kc, \
                Stage(hybrid_mod, '_kmedoids_iterations') as pam:
            res = KHybrid('rmsd', n_clusters=CLUSTER_K, kmedoids_updates=5,
                          random_state=0, **kw).fit(X).result_
        runs[name] = (res, kc, pam, engine_kmedoids._pam_sweeps.n_host_syncs,
                      kcenters_iteration_skip.n_launches,
                      kcenters_chunk.n_launches)
    (res_m, kc_m, pam_m, sy_m, k4_m, k1_m), (res_1, kc_1, pam_1, sy_1, k4_1,
                                             k1_1) = runs.values()
    check(k4_m > 0 and k1_m == 0 and k1_1 > 0 and k4_1 == 0,
          '16a: k-centers launches: mesh kernel 4 %d, kernel 1 %d; one '
          'device kernel 4 %d, kernel 1 %d' % (k4_m, k1_m, k4_1, k1_1))
    check(pam_m.qcp > 0 and pam_m.qcp % mesh.size == 0 and pam_1.qcp > 0,
          '16a: kernel 5 launches in PAM: mesh %d, one device %d'
          % (pam_m.qcp, pam_1.qcp))
    try_launches_ok(pam_m, '16a mesh', mesh.size)
    try_launches_ok(pam_1, '16a one device')
    for r, kc in ((res_m, kc_m), (res_1, kc_1)):
        ctr = np.asarray(r.center_indices)
        check(len(set(ctr.tolist())) == CLUSTER_K, '16a: %d distinct '
              'centers' % len(set(ctr.tolist())))
        check(pam_cost(r.distances) <= pam_cost(kc.result.distances),
              '16a: PAM raised the cost')
    seeds = int((np.asarray(kc_m.result.center_indices)
                 != np.asarray(kc_1.result.center_indices)).sum())
    verdict = compare_pam(
        (res_m.center_indices, res_m.distances, res_m.assignments),
        (res_1.center_indices, res_1.distances, res_1.assignments), bar,
        '16a')
    print('16a KHybrid %d x %d -> %d, 5 sweeps, on %d shards against one '
          'device: k-centers seeds differ at %d centers; PAM %s'
          % (len(X), N_ATOMS, CLUSTER_K, mesh.size, seeds, verdict))
    print('[%s] 16a KHybrid over the mesh: k-centers %.4f s (%d kernel 4 '
          'launches), PAM %.4f s (%d host syncs, %d kernel 5 launches, %d '
          'pam_try_eval, %d pam_try_commit); one device: k-centers %.4f s, '
          'PAM %.4f s (%d host syncs, %d kernel 5 launches, %d pam_try_eval, '
          '%d pam_try_commit); phase 5 in this run: PAM %.4f s, %d host '
          'syncs' % (card, kc_m.seconds, k4_m, pam_m.seconds, sy_m,
                     pam_m.qcp, pam_m.pe, pam_m.pc, kc_1.seconds,
                     pam_1.seconds, sy_1, pam_1.qcp, pam_1.pe, pam_1.pc,
                     phase5['pam_seconds'], phase5['pam_syncs']), flush=True)
    return pam_m.qcp, (pam_m.pe, pam_m.pc), tuple(np.asarray(v) for v in (
        res_m.center_indices, res_m.assignments, res_m.distances))


def sweeps_mesh_check(X, mesh, device, card):
    """Phase 16b: the device sweeps over the mesh at phase 5's full 1M
    frames from a kcenters(mesh=) seed, against one device from the same
    seed. Returns kernel 5's launches over the mesh and the mesh's result
    (the seed's centers, then medoids, distances, assignments)."""
    seed = kcenters(X, 'rmsd', n_clusters=CLUSTER_K, mesh=mesh)
    bar = bar_from(2.02 * float(np.einsum(
        'nai,nai->n', X - X.mean(1, keepdims=True),
        X - X.mean(1, keepdims=True)).max()), N_ATOMS)
    out = {}
    for name, kw in (('mesh', dict(mesh=mesh)), ('one', dict(device=device))):
        prep = engine.prepare_rmsd_frames(X, **kw)
        kw = {'mesh': mesh} if name == 'mesh' else {}
        reset_launches()
        engine_kmedoids._pam_sweeps.n_host_syncs = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = engine_kmedoids.kmedoids_sweeps_device(
            prep, 'rmsd', seed.assignments, seed.distances,
            seed.center_indices, n_sweeps=MESH_SWEEPS, seed=0, **kw)
        torch.cuda.synchronize()
        out[name] = (res, time.perf_counter() - t,
                     engine_kmedoids._pam_sweeps.n_host_syncs,
                     qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                     (pam_try_eval.n_launches, pam_try_commit.n_launches))
        del prep
        torch.cuda.empty_cache()
    (rm, tm, sm, qm, pm), (r1, t1, s1, q1, p1) = out.values()
    check(qm > 0 and qm % mesh.size == 0 and q1 > 0,
          '16b: kernel 5 launches: mesh %d, one device %d' % (qm, q1))
    for (pe, pc), n_shards, what in ((pm, mesh.size, 'mesh'),
                                     (p1, 1, 'one device')):
        check(pe > 0 and 0 < pc <= pe and pe % n_shards == 0
              and pc % n_shards == 0, '16b %s: %d pam_try_eval and %d '
              'pam_try_commit launches' % (what, pe, pc))
    c0 = pam_cost(seed.distances)
    check(pam_cost(rm[1]) <= c0 and pam_cost(r1[1]) <= c0,
          '16b: the sweeps raised the cost above the seed\'s %r' % c0)
    verdict = compare_pam(rm, r1, bar, '16b')
    print('16b kmedoids_sweeps_device %d x %d, %d medoids from '
          'kcenters(mesh=), %d sweeps on %d shards against one device: %s; '
          'seed cost %.9g' % (len(X), N_ATOMS, CLUSTER_K, MESH_SWEEPS,
                              mesh.size, verdict, c0))
    print('[%s] 16b sweeps over the mesh %.4f s (%d host syncs, %d kernel 5 '
          'launches, %d pam_try_eval, %d pam_try_commit); one device %.4f s '
          '(%d host syncs, %d kernel 5 launches, %d pam_try_eval, %d '
          'pam_try_commit)' % (card, tm, sm, qm, *pm, t1, s1, q1, *p1),
          flush=True)
    return qm, pm, (np.asarray(seed.center_indices),) + tuple(rm)


def _free_port():
    import socket
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def job_worker(rank, d):
    """Process ``rank`` of phase 16c or 16d: the cluster CLI's
    multi-process sequence (join_job, the flags, load, fit over the
    job's mesh, rank 0's writes but for the .h5 file, the closing
    barrier) on the job in ``d``, then, where the job asks, the sharded
    loop's profile window (every process runs it, rank 0 profiles); its
    result, stage seconds and a draw of ``sweep_bits`` on its lead card
    are saved for the parent."""
    import torch.distributed as dist
    from enspara_tpu_torch.exception import ImproperlyConfigured

    with open(os.path.join(d, 'job.json')) as f:
        job = json.load(f)
    argv = job['argv%d' % rank]
    t = time.perf_counter()
    mesh = cluster_app.join_job()
    t_join = time.perf_counter() - t
    device = require_cuda()
    check(mesh is not None and mesh.size == job['procs']
          and mesh.process_index == rank and mesh.first_shard == rank,
          'job mesh %r' % (mesh,))
    try:
        cluster_app.check_job(cluster_app.process_command_line(
            argv + ['--subsample', '2']), mesh)
        check(False, '--subsample 2 was not refused')
    except ImproperlyConfigured:
        pass
    args = cluster_app.process_command_line(argv)
    cluster_app.check_job(args, mesh)
    t = time.perf_counter()
    lengths, data = cluster_util.load_trjs_or_features(args)
    t_load = time.perf_counter() - t
    reset_launches()
    engine_kmedoids._pam_sweeps.n_host_syncs = 0
    with Stage(hybrid_mod, '_kcenters') as kc, \
            Stage(engine, '_kcenters_loop_fused_sharded') as loop, \
            Stage(hybrid_mod, '_kmedoids_iterations') as pam:
        clustering = cluster_app.fit(args, data, device, mesh)
    k4, syncs = (kcenters_iteration_skip.n_launches,
                 engine_kmedoids._pam_sweeps.n_host_syncs)
    t = time.perf_counter()
    wrote = cluster_app.write_outputs(args, clustering, lengths, device,
                                      mesh, h5=False)
    t_write = time.perf_counter() - t
    t = time.perf_counter()
    cluster_app.end_job(mesh)
    t_end = time.perf_counter() - t
    bits = next(engine_kmedoids.sweep_bits(0, 1, len(data.xyz), mesh.lead))
    profile = loop_profile(data.xyz, mesh, card_line(), report=rank == 0) \
        if job['profile'] else None
    r = clustering.result_
    np.savez(os.path.join(d, 'res%d.npz' % rank),
             ctr=np.asarray(r.center_indices), assig=r.assignments,
             dist=r.distances, seed=kc.result.distances)
    with open(os.path.join(d, 'stages%d.json' % rank), 'w') as f:
        json.dump({'join': t_join, 'load': t_load, 'kcenters': kc.seconds,
                   'loop': loop.seconds, 'pam': pam.seconds,
                   'write': t_write, 'barrier': t_end, 'wrote': wrote,
                   'syncs': syncs, 'k4': k4, 'qcp': pam.qcp,
                   'pe': pam.pe, 'pc': pam.pc,
                   'backend': dist.get_backend(mesh.group),
                   'bits': [int(bits.sum()), *bits[:3].tolist()],
                   'profile': profile}, f)
    if job['profile']:
        dist.barrier()
    print('JOB WORKER %d OK' % rank, flush=True)
    dist.destroy_process_group()


def _run_workers(d, env_of, n):
    """Start ``n`` ``--job-worker`` processes of this script on the job in
    ``d`` (process ``r`` with the environment ``env_of(r)``, its output
    in ``d/out<r>.txt``) and wait for them all. The first to fail, or
    JOB_TIMEOUT seconds, ends the others: no process waits out a
    collective's own timeout. Returns the exit codes and outputs."""
    procs = []
    with contextlib.ExitStack() as files:
        logs = [files.enter_context(open(os.path.join(d, 'out%d.txt' % r),
                                         'w+')) for r in range(n)]
        try:
            for r in range(n):
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     JOB_WORKER_FLAG, str(r), d], stdout=logs[r],
                    stderr=subprocess.STDOUT, env=env_of(r), text=True))
            deadline = time.monotonic() + JOB_TIMEOUT
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if None not in codes or any(c not in (None, 0)
                                            for c in codes):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
    return [p.returncode for p in procs], outs


def job_check(device, card, label='16c', n_procs=JOB_PROCS,
              n_files=JOB_FILES, own_cards=False):
    """Phase 16c (or 16d): the cluster CLI in ``n_procs`` processes on
    ``n_files`` of phase 5's XTC files, --algorithm khybrid
    --cluster-number 1000 --subsample 1 --random-state 0. 16c: two
    processes that see cuda:0 alone (``CUDA_VISIBLE_DEVICES``), each
    one shard of it (frame_mesh() of the card), so that they stay on
    gloo. 16d (``own_cards``): process ``r`` sees card ``r`` alone, so
    that the job takes NCCL, and rank 0 profiles 64 iterations of the
    sharded loop. Every
    process's results bit for bit an in-process run of the same flags on
    a mesh of as many shards (16c: virtual shards of cuda:0; 16d: the
    cards cuda:0 .. cuda:n-1), rank 0 alone writing. Returns kernel 5's
    launches in one process's PAM, the loop's ms an iteration and PAM's
    seconds."""
    backend = 'nccl' if own_cards else 'gloo'
    visible = os.environ.get('CUDA_VISIBLE_DEVICES')
    visible = visible.split(',') if visible else [str(r) for r in
                                                  range(n_procs)]
    with tempfile.TemporaryDirectory() as d:
        pdb, trjs, gsum = write_trajectories(d, n_files)
        job = {'procs': n_procs, 'profile': own_cards}
        for r in range(n_procs):
            os.makedirs(os.path.join(d, 'r%d' % r))
            argv = ['cluster', '--trajectories', *trjs, '--topology', pdb,
                    '--atoms', 'name CA', '--algorithm', 'khybrid',
                    '--cluster-number', str(CLUSTER_K), '--subsample', '1',
                    '--random-state', '0']
            for k, v in (('--distances', 'dist.h5'),
                         ('--assignments', 'assig.h5'),
                         ('--center-features', 'centers.pkl'),
                         ('--center-indices', 'inds.npy')):
                argv += [k, os.path.join(d, 'r%d' % r, v)]
            job['argv%d' % r] = argv
        with open(os.path.join(d, 'job.json'), 'w') as f:
            json.dump(job, f)
        port = str(_free_port())

        def env_of(r):
            env = dict(os.environ,
                       ENSPARA_TPU_COORDINATOR='localhost:' + port,
                       ENSPARA_TPU_NUM_PROCESSES=str(n_procs),
                       ENSPARA_TPU_PROCESS_ID=str(r))
            env.pop('ENSPARA_TPU_LOCAL_SHARDS', None)
            env['CUDA_VISIBLE_DEVICES'] = visible[r if own_cards else 0]
            return env
        t = time.perf_counter()
        codes, outs = _run_workers(d, env_of, n_procs)
        t_job = time.perf_counter() - t
        for r, (code, out) in enumerate(zip(codes, outs)):
            check(code == 0 and 'JOB WORKER %d OK' % r in out,
                  '%s: job worker %d exited %s:\n%s'
                  % (label, r, code, out[-4000:]))
        written = [sorted(os.listdir(os.path.join(d, 'r%d' % r)))
                   for r in range(n_procs)]
        check(written == [['centers.pkl', 'inds.npy']] + [[]] * (n_procs - 1),
              '%s: the writes by rank: %s' % (label, written))
        stages = []
        for r in range(n_procs):
            with open(os.path.join(d, 'stages%d.json' % r)) as f:
                stages.append(json.load(f))
        check([s['wrote'] for s in stages]
              == [True] + [False] * (n_procs - 1),
              '%s: write_outputs wrote on %s'
              % (label, [s['wrote'] for s in stages]))
        check([s['backend'] for s in stages] == [backend] * n_procs,
              '%s: the processes joined over %s, not %s'
              % (label, [s['backend'] for s in stages], backend))
        check(all(s['bits'] == stages[0]['bits'] for s in stages),
              '%s: sweep_bits differ between the processes\' cards: %s'
              % (label, [s['bits'] for s in stages]))

        # the in-process reference: the same flags on as many shards
        ref_mesh = FrameMesh([torch.device('cuda', r) for r in range(n_procs)]
                             if own_cards else (device,) * n_procs)
        args = cluster_app.process_command_line(job['argv0'])
        lengths, data = cluster_util.load_trjs_or_features(args)
        reset_launches()
        t = time.perf_counter()
        with Stage(engine, '_kcenters_loop_fused_sharded') as ref_loop, \
                Stage(hybrid_mod, '_kmedoids_iterations') as ref_pam:
            ref = cluster_app.fit(args, data, None, ref_mesh).result_
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)
        t_ref = time.perf_counter() - t
        # each process evaluates and commits its one shard of the tries
        # the in-process run makes on all of them
        tries = [(st['pe'], st['pc']) for st in stages]
        check(tries[0][0] > 0 and 0 < tries[0][1] <= tries[0][0]
              and tries == [tries[0]] * n_procs
              and (ref_pam.pe, ref_pam.pc) == (n_procs * tries[0][0],
                                               n_procs * tries[0][1]),
              '%s: pam_try_eval, pam_try_commit launches a process %s, '
              'in-process %d, %d' % (label, tries, ref_pam.pe, ref_pam.pc))
        for r in range(n_procs):
            got = np.load(os.path.join(d, 'res%d.npz' % r))
            check(np.array_equal(got['ctr'], np.asarray(ref.center_indices))
                  and np.array_equal(got['assig'], ref.assignments)
                  and np.array_equal(got['dist'], ref.distances),
                  '%s: process %d differs from the in-process %d-shard run'
                  % (label, r, n_procs))
            check(pam_cost(got['dist']) <= pam_cost(got['seed']),
                  '%s: PAM raised the cost' % label)
        inds = np.load(os.path.join(d, 'r0', 'inds.npy'))
        glob = [t_ * TRJ_FRAMES + f_ for t_, f_ in inds]
        check(np.array_equal(glob, np.asarray(ref.center_indices))
              and len(set(glob)) == CLUSTER_K,
              '%s: the written center indices differ from the result'
              % label)
        with open(os.path.join(d, 'r0', 'centers.pkl'), 'rb') as f:
            centers = pickle.load(f)
        check(len(centers) == CLUSTER_K and all(
            np.array_equal(c.xyz[0], data.xyz[g])
            for c, g in zip(centers, glob)),
            '%s: a written center structure is not its frame' % label)
    where = ('card %s of its own (CUDA_VISIBLE_DEVICES)' % ', '.join(
        visible[:n_procs]) if own_cards else '1 shard of %s each' % device)
    print('%s cluster CLI in %d processes joined over %s, %s, on %d XTC '
          'files x %d frames, khybrid -> %d: every process equals the '
          'in-process %s run bit for bit; rank 0 alone wrote the center '
          'indices and structures; --subsample 2 refused; sweep_bits(0) on '
          'every process\'s lead card the same stream (sum, first values '
          '%s)' % (label, n_procs, stages[0]['backend'], where, n_files,
                   TRJ_FRAMES, CLUSTER_K, ref_mesh, stages[0]['bits']))
    cards = cards_lines() if own_cards else card
    for r, st in enumerate(stages):
        print('[%s] %s process %d: join %.4f s, load %.4f s, k-centers %.4f '
              's (the loop %.4f s, %.4f ms an iteration; %d kernel 4 '
              'launches), PAM %.4f s (%d host syncs, %d kernel 5 launches, '
              '%d pam_try_eval, %d pam_try_commit), write %.4f s, barrier '
              '%.4f s'
              % (cards, label, r, st['join'], st['load'], st['kcenters'],
                 st['loop'], 1e3 * st['loop'] / CLUSTER_K, st['k4'],
                 st['pam'], st['syncs'], st['qcp'], st['pe'], st['pc'],
                 st['write'], st['barrier']))
    print('[%s] %s job %.4f s from launch to exit; in-process %s fit %.4f '
          's: the loop %.4f s (%.4f ms an iteration), PAM %.4f s (%d kernel 5 '
          'launches)' % (cards, label, t_job, ref_mesh, t_ref,
                         ref_loop.seconds, 1e3 * ref_loop.seconds / CLUSTER_K,
                         ref_pam.seconds, ref_pam.qcp), flush=True)
    return {'qcp': stages[0]['qcp'], 'k4': stages[0]['k4'],
            'try': (stages[0]['pe'], stages[0]['pc']),
            'loop_ms': 1e3 * stages[0]['loop'] / CLUSTER_K,
            'pam': stages[0]['pam'], 'profile': stages[0]['profile']}


def subsampled(X):
    """Phase 5's frames at its ``--subsample``: 100,000 of them."""
    return X.reshape(N_TRJ, TRJ_FRAMES, N_ATOMS, 3)[:, ::SUBSAMPLE] \
        .reshape(-1, N_ATOMS, 3)


def mesh_pam_path(device, card, phase5):
    """Phase 16: the PAM sweeps over a 4-shard mesh of the card and the
    multi-process cluster CLI. Returns kernel 5's launches by part and
    the mesh's results of 16a and 16b."""
    mesh = FrameMesh((device,) * N_SHARDS)
    X = phase5_data()
    launches, results = {}, {}
    launches['16a'], launches['16a_try'], results['16a'] = \
        khybrid_mesh_check(subsampled(X), mesh, device, card, phase5)
    torch.cuda.empty_cache()
    launches['16b'], launches['16b_try'], results['16b'] = \
        sweeps_mesh_check(X, mesh, device, card)
    del X
    torch.cuda.empty_cache()
    gloo = job_check(device, card)
    launches['16c'], launches['16c_try'] = gloo['qcp'], gloo['try']
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print('16d: %d CUDA device visible; the cluster CLI in one process '
              'a card over NCCL did not run' % n_cards, flush=True)
    else:
        nccl = job_check(device, card, '16d', min(CARD_JOB_PROCS, n_cards),
                         N_TRJ, own_cards=True)
        launches['16d'], launches['16d_try'] = nccl, nccl['try']
        prof = nccl['profile']
        print('[%s] 16d against 16c (gloo, %d processes on cuda:0, %d '
              'files): the loop %.4f ms an iteration against %.4f ms, PAM '
              '%.4f s against %.4f s; rank 0\'s profile window: %s'
              % (cards_lines(), JOB_PROCS, JOB_FILES, nccl['loop_ms'],
                 gloo['loop_ms'], nccl['pam'], gloo['pam'],
                 'not measured' if prof is None else
                 'wall %.4f ms an iteration, kernel 4 %.2f launches %.4f ms, '
                 'other ops %.2f launches %.4f ms, card idle %.1f%%, NCCL '
                 'kernels %.2f launches %.4f ms (waits included)'
                 % (prof['wall_ms'], prof['k4_launches'], prof['k4_ms'],
                    prof['other_launches'], prof['other_ms'],
                    100 * prof['idle'], prof['nccl_launches'],
                    prof['nccl_ms'])), flush=True)
    print('[%s] phase 16 (PAM over a mesh, the multi-process CLI) passed'
          % card, flush=True)
    return launches, results

# phase 17: the small job (the size of the reference's bundled 501-frame
# system) and its centers
SMALL_FRAMES, SMALL_K = 501, 10


def cards_lines():
    """Every visible card's name and power limit, as nvidia-smi gives
    them, joined by '; '."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().replace('\n', '; ')


def launch_counts():
    return {'k1': kcenters_chunk.n_launches,
            'k3': kcenters_iteration.n_launches,
            'k4': kcenters_iteration_skip.n_launches,
            'k5': qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
            'k6': ell_spmm_kernel.n_launches}


def same_bits(got, ref, what):
    """Every array of ``got`` equal to ``ref``'s, NaN where NaN."""
    check(len(got) == len(ref), '%s: %d results vs %d'
          % (what, len(got), len(ref)))
    for k, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        check(g.shape == r.shape and np.array_equal(
            g, r, equal_nan=g.dtype.kind == 'f'),
            '%s: result %d differs from the pinned run' % (what, k))


def _ctr(r):
    return (np.asarray(r.center_indices), np.asarray(r.assignments),
            np.asarray(r.distances))


def default_mesh_path(device, card, single, t_single, phase2_launches,
                      phase5, labels, cards12, virtual):
    """Phase 17: ``mesh=None`` spans every visible card, as the JAX
    package's default mesh spans every device, but for clustering jobs
    on frames of fewer than ``SMALL_JOB_FEATURES`` features, which stay
    on the current card.

    (a) ``frame_mesh()`` holds every visible card; the public entry
    points with no ``mesh=`` and no ``device=`` (kcenters on phase 2's
    frames from the host, assign_device of them, KHybrid on phase 5's
    subsample, the cluster CLI's fit of phase 5: all below the
    threshold; the implied CLI on phase 10's labels and collect_cards of
    phase 12, which take every card whatever the size) equal, bit for
    bit, the same calls pinned to ``device='cuda:0'`` (with several
    cards, the last two to a mesh of as many virtual shards of cuda:0,
    the same layout). Each pair runs in the order default, pinned,
    pinned, default. The clusterings' launches are the one-device
    phases' (kernel 1's 1040, no kernel 3 or 4) on any count of cards.
    With several cards, the default kcenters with the rule off runs
    over them (kernel 4) and equals the virtual shards. A 501-frame job
    stays on the current card.
    (b) With two or more cards, phase 9's sharded path and phase 16a-b
    over ``frame_mesh()``, each bit for bit the same mesh of virtual
    shards (``virtual``: phase 9's and 16's results on 4 of them)."""
    n_cards = torch.cuda.device_count()
    mesh = frame_mesh()
    check(mesh.size == n_cards and mesh.devices == tuple(
        torch.device('cuda', k) for k in range(n_cards)),
        'frame_mesh() is %s with %d cards visible' % (mesh, n_cards))
    cuda0 = mesh.devices[0]
    one = ({'device': cuda0}, "device='cuda:0'")
    cards = one if n_cards == 1 else (
        {'mesh': FrameMesh((cuda0,) * n_cards)},
        'FrameMesh((cuda:0,) * %d)' % n_cards)
    lines = []

    def launches(c):
        return ', '.join('%s %d' % kv for kv in c.items() if kv[1])

    def both(what, fn, pin, first=None, repeat=True):
        """``fn()`` and ``fn(**pin[0])`` in the order default, pinned,
        pinned, default (``repeat=False``: one pinned run), each timed
        to a synchronize with its launches, after ``first`` (an earlier
        default run's result, seconds and launches) when given; every
        result bit for bit the first pinned one's. Returns the runs by
        placement."""
        runs = {'default': [first] if first is not None else [],
                'pinned': []}
        order = ('default', 'pinned', 'pinned', 'default') if repeat \
            else ('pinned',)
        for name in order:
            kw = {} if name == 'default' else pin[0]
            reset_launches()
            for k in range(n_cards):
                torch.cuda.synchronize(k)
            t = time.perf_counter()
            res = fn(**kw)
            for k in range(n_cards):
                torch.cuda.synchronize(k)
            runs[name].append((res, time.perf_counter() - t,
                               launch_counts()))
        ref = runs['pinned'][0][0]
        for res, _, _ in runs['default'] + runs['pinned'][1:]:
            same_bits(res, ref, what)
        lines.append('%s %s s (%s) = %s %s s (%s)' % (
            what, ' / '.join('%.4f' % r[1] for r in runs['default']),
            launches(runs['default'][-1][2]), pin[1],
            ' / '.join('%.4f' % r[1] for r in runs['pinned']),
            launches(runs['pinned'][0][2])))
        return runs

    # -- (a) --------------------------------------------------------------
    frames = random_walk(device)
    Xh = frames.cpu().numpy()
    kc = both('kcenters 1M x 64 -> %d' % N_CLUSTERS, lambda **kw: _ctr(
        kcenters(Xh, 'rmsd', n_clusters=N_CLUSTERS, **kw)), one)
    ctr = kc['pinned'][0][0][0]
    both('assign_device 1M x 64 to %d centers' % N_CLUSTERS,
         lambda **kw: engine.assign_device(Xh, Xh[ctr], 'rmsd', **kw), one)
    if n_cards > 1:
        # the rule off: the same default over every card
        rule, pmesh.SMALL_JOB_FEATURES = pmesh.SMALL_JOB_FEATURES, 0.0
        try:
            over = both('kcenters 1M x 64 -> %d, SMALL_JOB_FEATURES 0'
                        % N_CLUSTERS, lambda **kw: _ctr(kcenters(
                            Xh, 'rmsd', n_clusters=N_CLUSTERS, **kw)),
                        cards)
        finally:
            pmesh.SMALL_JOB_FEATURES = rule
        k = over['default'][-1][2]
        check(k['k4'] > 0 and k['k1'] == 0, 'default kcenters over %d '
              'cards, the rule off: kernel 4 %d, kernel 1 %d'
              % (n_cards, k['k4'], k['k1']))
    del Xh
    data = phase5['data']
    kh = both('KHybrid %d x %d -> %d' % (len(data.xyz), N_ATOMS, CLUSTER_K),
              lambda **kw: _ctr(KHybrid('rmsd', n_clusters=CLUSTER_K,
                                        random_state=0, **kw)
                                .fit(data).result_), one)
    fit5 = (_ctr(phase5['result']), phase5['fit_s'],
            {'k1': phase5['fit_kc'], 'k34': phase5['fit_k34'],
             'k5': phase5['fit_qcp']})
    cli = both('the cluster CLI\'s fit (first: phase 5\'s run)',
               lambda **kw: _ctr(cluster_app.fit(phase5['args'], data,
                                                 **kw).result_),
               one, first=fit5)
    its_args = its_app.process_command_line(
        ['implied', '--assignments', '(phase 5, in memory)']
        + list(ITS_FLAGS))
    both('the implied CLI on phase 5\'s labels',
         lambda **kw: (its_app.run(labels, its_args, **kw),), cards)
    saved, loaded, cards12_s = cards12
    feat = RotamerFeaturizer(buffer_width=15).fit(loaded)
    both('collect_cards (phase 12\'s whole run; pinned: its matrices)',
         lambda **kw: cards_matrices(
             feat.feature_trajectories_, feat.n_feature_states_, **kw),
         cards, first=(saved, cards12_s, {}), repeat=False)
    del feat, loaded

    k = kc['default'][-1][2]
    check(k['k1'] == phase2_launches and k['k3'] == k['k4'] == 0,
          'default kcenters: kernel 1 %d (phase 2: %d), kernel 3 %d, '
          'kernel 4 %d' % (k['k1'], phase2_launches, k['k3'], k['k4']))
    for what, runs in (('KHybrid', kh), ('the cluster CLI', cli)):
        for d in runs['default']:
            p = runs['pinned'][0][2]
            d = d[2]
            check(d['k1'] == p['k1'] > 0 and d['k5'] == p['k5'] > 0 and
                  not d.get('k3', 0) + d.get('k4', 0) + d.get('k34', 0),
                  '%s: default %s, pinned %s' % (what, d, p))

    # the small job: the current card, whatever the count of cards
    small = data.xyz[:SMALL_FRAMES]
    features = pmesh.job_features(small)
    check(features < pmesh.SMALL_JOB_FEATURES, 'features %g' % features)
    reset_launches()
    with Stage(engine, 'prepare_rmsd_frames') as prep_st:
        kcenters(small, 'rmsd', n_clusters=SMALL_K)
    placed = prep_st.result
    current = torch.device('cuda', torch.cuda.current_device())
    check(isinstance(placed, engine.PreparedRMSDFrames) and
          placed.device == current and kcenters_chunk.n_launches > 0 and
          kcenters_iteration_skip.n_launches == 0,
          'the %d-frame job was laid out on %s (%s), kernel 1 %d, kernel 4 '
          '%d launches' % (SMALL_FRAMES, placed.device, type(placed).__name__,
                           kcenters_chunk.n_launches,
                           kcenters_iteration_skip.n_launches))
    print('17a: frame_mesh() holds %d card(s) of %d visible; with no mesh= '
          'and no device=, each run equals its pinned run bit for bit '
          '(seconds in the order run): %s; a %d-frame job to %d centers '
          '(%d features < SMALL_JOB_FEATURES %g) ran on %s, one device, %d '
          'kernel 1 launches'
          % (mesh.size, n_cards, '; '.join(lines), SMALL_FRAMES, SMALL_K,
             features, pmesh.SMALL_JOB_FEATURES, placed.device,
             kcenters_chunk.n_launches))
    print('[%s] 17a times above: seconds to a synchronize on this machine'
          % cards_lines(), flush=True)

    # -- (b) --------------------------------------------------------------
    if n_cards < 2:
        print('17b: %d CUDA device visible; the multi-card half (phase 9 '
              'and 16a-b over frame_mesh()) did not run' % n_cards,
              flush=True)
        return
    on_cards = {'9': sharded_path(device, frames, single, t_single, card,
                                  mesh=mesh)['result']}
    X = phase5_data()
    on_cards['16a'] = khybrid_mesh_check(subsampled(X), mesh, device, card,
                                         phase5)[-1]
    on_cards['16b'] = sweeps_mesh_check(X, mesh, device, card)[-1]
    if mesh.size != N_SHARDS:
        vmesh = FrameMesh((device,) * mesh.size)
        virtual = {
            '9': sharded_path(device, frames, single, t_single, card,
                              mesh=vmesh)['result'],
            '16a': khybrid_mesh_check(subsampled(X), vmesh, device, card,
                                      phase5)[-1],
            '16b': sweeps_mesh_check(X, vmesh, device, card)[-1]}
    for part in ('9', '16a', '16b'):
        same_bits(on_cards[part], virtual[part],
                  'phase %s over %d cards' % (part, n_cards))
    print('[%s] 17b: phase 9 and 16a-b over frame_mesh(), %d cards, bit for '
          'bit the same on %d virtual shards of cuda:0 (times above)'
          % (cards_lines(), n_cards, mesh.size), flush=True)


# phase 18: one card assigns this many 64-atom frames (the random walk of
# chip_mesh_crossover.py) to CLUSTER_K centers picked with this seed; the
# first ASSIGN_CHECK frames are assigned again alone
ASSIGN_FRAMES, ASSIGN_CHECK, ASSIGN_SEED = 32_000_000, 1 << 20, 18


def big_assign_path(device, card):
    """Phase 18: ``assign_device`` of ASSIGN_FRAMES x 64-atom frames
    from the host to CLUSTER_K centers on one card, through the streamed
    ingest (no raw copy of the coordinates on the card). Its peak
    allocated memory stays below the frame layout plus 1.25 of its
    ``(n_pad, 256)`` center blocks (one block alive at a time), and its
    first ASSIGN_CHECK rows equal, bit for bit, the assignment of those
    frames alone (a frame's row of kernel 5 does not depend on the other
    frames). Returns kernel 5's launches."""
    from chip_mesh_crossover import random_walk as random_walk_host
    t = time.perf_counter()
    X = random_walk_host(ASSIGN_FRAMES, device)
    t_make = time.perf_counter() - t
    rng = np.random.default_rng(ASSIGN_SEED)
    C = X[np.sort(rng.choice(ASSIGN_FRAMES, CLUSTER_K, replace=False))]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t = time.perf_counter()
    a, d = engine.assign_device(X, C, 'rmsd', device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device) - base
    launches = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    n_pad = pmesh.pad_to_multiple(ASSIGN_FRAMES, engine.TILE)
    layout = n_pad * (3 * N_ATOMS * 4 + 4)
    block = n_pad * qcp_matrix.TILE_C * 4
    check(a.shape == d.shape == (ASSIGN_FRAMES,) and np.isfinite(d).all()
          and 0 <= a.min() and a.max() < CLUSTER_K,
          '18: assignments of shape %s in [%d, %d]'
          % (a.shape, a.min(), a.max()))
    check(launches == -(-CLUSTER_K // qcp_matrix.TILE_C),
          '18: %d kernel 5 launches' % launches)
    check(peak < layout + 1.25 * block, '18: peak %d B above the frame '
          'layout %d B plus 1.25 blocks of %d B' % (peak, layout, block))
    a1, d1 = engine.assign_device(X[:ASSIGN_CHECK], C, 'rmsd', device=device)
    check(np.array_equal(a[:ASSIGN_CHECK], a1)
          and np.array_equal(d[:ASSIGN_CHECK], d1),
          '18: the first %d rows differ from their assignment alone'
          % ASSIGN_CHECK)
    print('[%s] 18 assign_device of %d x %d frames from the host to %d '
          'centers on %s: %.4f s (%.4g pairs/s; %d kernel 5 launches); peak '
          'allocated %d B (%.2f GiB) against the frame layout %d B plus one '
          '(n_pad, %d) block %d B = %d B (%.2f GiB); the first %d rows equal '
          'their assignment alone bit for bit; frames made in %.4f s'
          % (card, ASSIGN_FRAMES, N_ATOMS, CLUSTER_K, device, secs,
             ASSIGN_FRAMES * CLUSTER_K / secs, launches, peak, peak / 2 ** 30,
             layout, qcp_matrix.TILE_C, block, layout + block,
             (layout + block) / 2 ** 30, ASSIGN_CHECK, t_make), flush=True)
    return launches


def main():
    card = card_line()
    print('card:', card, flush=True)
    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    sources = ('kcenters_step', 'qcp_update', 'qcp_matrix', 'ell_spmm',
               'pam_try')
    _build.build(*sources)
    for name in sources:
        _build.load_library(name)
    print('built %s, %s, %s, %s and %s in %.3f s (nvcc %s)'
          % (SOURCE, UPDATE_SOURCE, QCP_SOURCE, ELL_SOURCE, PAM_SOURCE,
             time.perf_counter() - t, ' '.join(_build.NVCC_FLAGS)),
          flush=True)

    # -- 1. kernel against plain version on basin data ---------------------
    X = basin_data(np.random.default_rng(0), CHECK_FRAMES, N_ATOMS,
                   n_basins=256)
    prep = engine.prepare_rmsd_frames(X, device=device)
    start = fresh_state(prep)
    n0 = kcenters_chunk.n_launches
    on = run_chunk(kcenters_chunk, prep, clone(start), CHECK_CENTERS)
    off = run_chunk(kcenters_chunk, prep, clone(start), CHECK_CENTERS,
                    skip=False)
    plain = run_chunk(kcenters_chunk_plain, prep, clone(start),
                      CHECK_CENTERS)
    torch.cuda.synchronize()
    check(kcenters_chunk.n_launches == n0 + 2 * (1 + CHECK_CENTERS),
          'launch count did not grow by the launches made')
    check(all(np.array_equal(x, y) for x, y in zip(on, off)),
          'skip on and skip off differ')
    skipped = int(on[6][on[6] > 0].sum())
    check(skipped > 0, 'no tile was skipped on basin data')
    check(int((on[2] >= 0).sum()) == CHECK_CENTERS, 'centers not placed')
    print(compare_chunks(prep, start, on, plain, CHECK_CENTERS,
                         '%d x %d x %d kernel vs plain'
                         % (CHECK_FRAMES, N_ATOMS, CHECK_CENTERS)))
    print('skip on/off bit-identical over %d iterations; %d of %d tile '
          'visits skipped' % (CHECK_CENTERS, skipped,
                              CHECK_CENTERS * (prep.frames_r.shape[1]
                                               // prep.tile)), flush=True)
    del X, prep, start, on, off, plain

    # -- 2. main path at full size ----------------------------------------
    frames = random_walk(device)
    pipeline(frames, device)                      # warm-up
    reset_launches()
    prep, res, counts, vals, vecs, (t_prep, t_cl, t_co, t_eig) = \
        pipeline(frames, device)
    launches = kcenters_chunk.n_launches
    check(qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == 0 and
          ell_spmm_kernel.n_launches == 0,
          'the north star launched the qcp or ell_spmm kernel')
    check(res.n_found == N_CLUSTERS, 'n_found %d' % res.n_found)
    check(int(res.assignments.max()) == N_CLUSTERS - 1,
          'assignments.max() %d' % res.assignments.max())
    check(launches >= N_CLUSTERS, 'only %d kernel launches' % launches)
    check(np.isfinite(res.distances).all(), 'non-finite distances')
    a = res.assignments.reshape(100, -1)
    ref_counts = np.bincount(
        (a[:, :-LAG] * N_CLUSTERS + a[:, LAG:]).ravel(),
        minlength=N_CLUSTERS ** 2).reshape(N_CLUSTERS, N_CLUSTERS)
    counts_h = counts.cpu().numpy()
    check(np.array_equal(counts_h, ref_counts), 'counts differ from numpy')
    w_ref, pi_ref = host_eigs(counts_h)
    eig_err = float(np.abs(vals - w_ref).max())
    pi_err = float(np.abs(vecs[:, 0] - pi_ref).max())
    check(vals.shape == (N_EIGS,) and eig_err < 1e-4,
          'eigenvalues differ by %g' % eig_err)
    check(pi_err < 1e-5, 'equilibrium populations differ by %g' % pi_err)
    # kernel 2's path: the same clustering with tri_skip=False
    reset_launches()
    t = time.perf_counter()
    off = engine.kcenters_device_fused(prep, n_clusters=N_CLUSTERS,
                                       tri_skip=False)
    t_off = time.perf_counter() - t
    noskip_launches = kcenters_chunk.n_launches
    check(noskip_launches >= N_CLUSTERS, 'tri_skip=False: only %d kernel '
          'launches' % noskip_launches)
    check(all(np.array_equal(x, y) for x, y in zip(off, res)),
          'tri_skip=False differs from tri_skip=True on one device')
    print('main path: %d frames x %d atoms -> %d centers (%d kernel '
          'launches), max distance %.6f; lag-%d counts equal numpy; top-%d '
          'eigenvalues within %.2e of float64 numpy, pi within %.2e'
          % (N_FRAMES, N_ATOMS, res.n_found, launches,
             res.distances.max(), LAG, N_EIGS, eig_err, pi_err))
    print('[%s] prepare %.4f s; cluster %.4f s (%.4g pairs/s), counts '
          '%.4f s, eigsolve %.4f s, north-star %.4f s (cluster + counts + '
          'eigsolve); cluster with tri_skip=False %.4f s (%d launches), '
          'bit for bit the same' % (card, t_prep, t_cl,
                                    N_FRAMES * N_CLUSTERS / t_cl, t_co,
                                    t_eig, t_cl + t_co + t_eig, t_off,
                                    noskip_launches), flush=True)

    # -- 3. the kernel and its plain version at the main path's shapes -----
    kc = chunk_kernels(prep, card)

    single, t_single = res, t_cl
    del frames, prep, res, counts, off
    torch.cuda.empty_cache()

    # -- 4. the all-pairs QCP kernel and its plain version -----------------
    qcp_err = qcp_ms = qcp_plain_ms = None
    for i, (F, C, A) in enumerate(QCP_SHAPES):
        err, k_ms, p_ms, line = qcp_shape(device, F, C, A, seed=i)
        print('[%s] %s' % (card, line), flush=True)
        b = qcp_bound(F, C, A)
        print('[%s] bound of the %d x %d x %d block: %.4f ms (%s: %s), '
              'kernel at %.1f%% of it' % ((card, F, C, A) + b
                                          + (100 * b[0] / k_ms,)),
              flush=True)
        if i == 0:
            qcp_err, qcp_ms, qcp_plain_ms, qcp_b = err, k_ms, p_ms, b
        torch.cuda.empty_cache()
    print(qcp_self_pairs(device, *QCP_SELF, seed=len(QCP_SHAPES)),
          flush=True)
    torch.cuda.empty_cache()

    # -- 5. cluster -> reassign through the apps at full size --------------
    path, labels = reassign_path(device, card)
    pam_try_nums = pam_try_kernels(device, card)
    torch.cuda.empty_cache()

    # -- 6. the ELL SpMM kernel and its plain version ----------------------
    T, pi, S = scale_point()
    cols_h, vals_h = eigen_device.bucketed_ell(S)
    ell = None
    for i, k in enumerate(ELL_WIDTHS):
        nums, line = ell_shape(device, cols_h, vals_h, k, seed=i,
                               what='scale-point S')
        print('[%s] %s' % (card, line), flush=True)
        ell = ell or nums
    n, w, k = ODD_ELL
    rng = np.random.default_rng(5)
    # w distinct columns a row, sorted: a valid CSR for torch.sparse.mm
    odd_cols = np.sort(np.argsort(rng.random((n, n)), axis=1)[:, :w], axis=1)
    _, line = ell_shape(device, odd_cols.astype(np.int32),
                        rng.normal(size=(n, w)).astype(np.float32), k,
                        seed=9, what='odd shape')
    print('[%s] %s' % (card, line), flush=True)
    torch.cuda.empty_cache()

    # -- 7. the large-MSM eigensolve and implied timescales ----------------
    ell_launches = eigensolve_path(T, pi, S, card)
    its_launches = its_path(card)
    torch.cuda.empty_cache()

    # -- 8. the one-iteration kernels of the sharded loop ------------------
    frames = random_walk(device)
    it = iteration_kernels(device, frames, card)
    torch.cuda.empty_cache()

    # -- 9. the sharded path at full size ----------------------------------
    sharded = sharded_path(device, frames, single, t_single, card)
    del frames
    torch.cuda.empty_cache()

    # -- 10. the analysis path on phase 5's labels -------------------------
    analysis_path(labels, device, card)
    torch.cuda.empty_cache()

    # -- 11. clustering feature vectors at full size ------------------------
    feature_path(device, card)
    torch.cuda.empty_cache()

    # -- 12. the CARDS chain ------------------------------------------------
    cards12 = cards_path(device, card)
    torch.cuda.empty_cache()

    # -- 13. SASA, exposons, RMSF, helix, pockets, the point-cloud route ---
    structure_path(device, card)
    torch.cuda.empty_cache()

    # -- 14. bf16 frames, the locality sort, streamed ingest, CLI flags ----
    bf16_launches, bf16 = bf16_path(device, single, t_single, card)
    torch.cuda.empty_cache()

    # -- 15. the explicit-dye route of smFRET -------------------------------
    explicit_dye_path(device, card)
    torch.cuda.empty_cache()

    # -- 16. the PAM sweeps over a mesh, the multi-process cluster CLI -----
    mesh_pam, mesh_results = mesh_pam_path(device, card, path)
    torch.cuda.empty_cache()

    # -- 17. mesh=None: every visible card, the small-job card -------------
    default_mesh_path(device, card, single, t_single, launches, path, labels,
                      cards12, dict(mesh_results, **{'9': sharded['result']}))
    del cards12
    torch.cuda.empty_cache()

    # -- 18. one card assigns 32M frames, one center block alive -----------
    big_launches = big_assign_path(device, card)
    torch.cuda.empty_cache()
    print('launches: north star kcenters_step %d; north star tri_skip=False '
          'kcenters_step_noskip %d; cluster -> reassign kcenters_step %d, '
          'qcp_matrix %d; scale-point eigensolve ell_spmm %d; implied '
          'timescales ell_spmm %d; sharded path kcenters_iteration_skip %d; '
          'tri_skip=False qcp_update %d; bf16 north star kcenters_step %d, '
          'tri_skip=False %d; bf16 sharded kcenters_iteration_skip %d, '
          'tri_skip=False qcp_update %d; PAM over the 4-shard mesh '
          'qcp_matrix %d (KHybrid at phase 5\'s scale), %d (1M sweeps); '
          'two-process CLI qcp_matrix %d a process; %s32M assignment '
          'qcp_matrix %d; PAM tries pam_try_eval, pam_try_commit %d, %d '
          '(cluster -> reassign), %d, %d (16a), %d, %d (16b), %d, %d a '
          'process (16c)%s'
          % (launches, noskip_launches, path['kcenters_step'],
             path['qcp_matrix'], ell_launches, its_launches,
             sharded['kcenters_iteration_skip'], sharded['qcp_update'],
             bf16_launches['1'], bf16_launches['2'], bf16_launches['4'],
             bf16_launches['3'], mesh_pam['16a'], mesh_pam['16b'],
             mesh_pam['16c'],
             'one-process-a-card CLI kcenters_iteration_skip %d, qcp_matrix '
             '%d a process; ' % (mesh_pam['16d']['k4'],
                                 mesh_pam['16d']['qcp'])
             if '16d' in mesh_pam else '', big_launches,
             path['pam_eval'], path['pam_commit'], *mesh_pam['16a_try'],
             *mesh_pam['16b_try'], *mesh_pam['16c_try'],
             ', %d, %d a process (16d)' % mesh_pam['16d_try']
             if '16d' in mesh_pam else ''))

    print(json.dumps({'kernels': [{
        'name': 'kcenters_step', 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES, 'launches': launches, **kc['1']}, {
        'name': 'kcenters_step_noskip', 'route': 'cuda', 'source': SOURCE,
        'replaces': NOSKIP_REPLACES, 'launches': noskip_launches,
        **kc['2']}, {
        'name': 'qcp_matrix', 'route': 'cuda', 'source': QCP_SOURCE,
        'replaces': QCP_REPLACES, 'launches': path['qcp_matrix'],
        'max_abs_err': qcp_err, 'ms': qcp_ms, 'plain_ms': qcp_plain_ms,
        'bound_ms': qcp_b[0], 'bound_by': qcp_b[1],
        'library_ms': None}, {
        'name': 'ell_spmm', 'route': 'cuda', 'source': ELL_SOURCE,
        'replaces': ELL_REPLACES, 'launches': ell_launches, **ell}, {
        'name': 'qcp_update', 'route': 'cuda', 'source': UPDATE_SOURCE,
        'replaces': UPDATE_REPLACES, 'launches': sharded['qcp_update'],
        **it['3']}, {
        'name': 'kcenters_iteration_skip', 'route': 'cuda', 'source': SOURCE,
        'replaces': SKIP_REPLACES,
        'launches': sharded['kcenters_iteration_skip'], **it['4']}, {
        'name': 'kcenters_step_bf16', 'route': 'cuda', 'source': SOURCE,
        'replaces': BF16_REPLACES['1'], 'launches': bf16_launches['1'],
        **bf16['1']}, {
        'name': 'kcenters_step_noskip_bf16', 'route': 'cuda',
        'source': SOURCE, 'replaces': BF16_REPLACES['2'],
        'launches': bf16_launches['2'], **bf16['2']}, {
        'name': 'qcp_update_bf16', 'route': 'cuda', 'source': UPDATE_SOURCE,
        'replaces': BF16_REPLACES['3'], 'launches': bf16_launches['3'],
        **bf16['3']}, {
        'name': 'kcenters_iteration_skip_bf16', 'route': 'cuda',
        'source': SOURCE, 'replaces': BF16_REPLACES['4'],
        'launches': bf16_launches['4'], **bf16['4']}, {
        'name': 'pam_try_eval', 'route': 'cuda', 'source': PAM_SOURCE,
        'replaces': None, 'launches': path['pam_eval'],
        **pam_try_nums['eval']}, {
        'name': 'pam_try_commit', 'route': 'cuda', 'source': PAM_SOURCE,
        'replaces': None, 'launches': path['pam_commit'],
        **pam_try_nums['commit']}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == [JOB_WORKER_FLAG]:
        job_worker(int(sys.argv[2]), sys.argv[3])
    else:
        main()
