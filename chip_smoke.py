#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's HOD, P(k), pair-count, prepare_sim, ZCV, power-spectrum and disk paths and its scripts on one GPU and check its kernels.

    python3 chip_smoke.py

Phases, each printing what it measured:

1. device, torch and CUDA versions, the card's name and power limit; build
   the CUDA kernels from ``abacusutils_tpu_torch/csrc`` (nvcc, sm_90a);
2. K1, the TSC deposit, against its plain PyTorch version on ~4e6 points
   placed on cell and brick edges and across the periodic wrap;
3. K2, the P(k) mode binning (the binning kernel of
   ``csrc/mode_bin_pairs.cu`` at one field), against its plain version on
   a 256^3 rfft mesh as cuFFT lays it out (strided); then K4, the cell-pair
   count, and K5, the all-pairs count (``csrc/pair_count.cu``), each in its
   (rp, pi) and (s, mu) modes, auto and cross, against its plain version
   with every bin equal and two launches equal, on clustered catalogs made
   on the device: for K4 2e5 points in the main path's box on its 66^3 grid
   and on the finer 133^3 grid (a reach of 2 cells, pruned rows, items of
   two cells), rp edges that start at 0, dense 13^3 and 26^3 grids (items of
   3 cells), a clump whose cells hold far over 64 points beside empty ones, a 4^3
   grid (the per-pair round), a 5^3 grid walked with a reach of 2 (every
   cell once) and a 4^3 one that such a walk would visit twice (refused), a
   catalog pressed against the z faces (items whose reach wraps), positions
   exactly on cell edges and on lbox; for K5 2e4 points in float32 and
   float64, within one period (the compare form of the round) and spread
   over several (the division); and K4 equal to K5 on one catalog;
4. the step at bench scale (1e7 halos + 5e7 particles, nmesh=256, 16^3
   bricks with a z margin for RSD, 128 k-bins): staging, one warm and 3x5
   timed steps through the kernels
   (both launch counters must rise by 2 and 1 per step), each kernel timed
   against its plain version at the step's shapes, and the whole step held
   against the same step built from the plain versions;
5. ``AbacusHOD.run_hod_pk_fused``, box leg, LRG + ELG + QSO (6 spectra) on
   the same catalog size with live assembly bias: staging cold and warm, one
   cold and 3x5 timed warm calls (host to host, numpy clustering included;
   K1 must launch 6 times and K3 once per call, the bin plan is never
   rebuilt), the spectra held against the same spectra rebuilt from the
   plain versions, and K3 timed against its plain version;
6. the light-cone leg of the same call on the same catalog (3-D
   velocities, an origin outside the box corner): the same, on catalogs
   staged once by brick with a margin on every axis, two K1 launches per
   tracer;
7. the two-step route on the box catalog of phase 5 (with halo and
   particle ids): (a) ``AbacusHOD.run_hod``, timed host to host, each
   tracer's galaxy count equal to phase 5's n_gal; (b) ``compute_power`` at
   the settings of docs/hod.md (550^3 mesh, 128 k-bins to 0.5 h/Mpc, poles
   0, 2, 4), cold (the bin plan built on the device) and warm, against the
   same spectra from the plain versions, with K1, K3's pole form and the
   device plan build timed against their plain versions; (c) at nmesh 256,
   compensated, against phase 5's spectra at rtol 2e-3; (d) TSC and CIC,
   interlaced, compensated, 4 mu bins, against the plain versions and the
   monopole = band-mean invariant; (e) the cold ``run_hod_pk_fused`` at
   nmesh 512, whose bin plan is built on the device once;
8. pair counting on phase 7's ``run_hod`` mock (LRG + ELG + QSO with RSD in
   the (2000 Mpc/h)^3 box): ``compute_xirppi``, ``compute_wp`` and
   ``compute_multipole`` at rp, s < 30 Mpc/h in 8 log bins, pimax 30 and 20
   mu bins (docs/hod.md), each cold from the host mock (upload, one cell
   stage a tracer, six K4 launches a statistic) and warm on device-held
   columns (0 restages required; a tracer is staged once a grid, and the
   dispatch gives the pairs with the sparse QSOs the 66^3 grid and the
   others the 133^3 one); wp = 2 sum_pi xi at unit pi bins; the
   autocorrelation's half walk, doubled, against the full walk on a clone of
   one tracer; the stage alone against its byte bound; K4 at each of the six
   pairs' shapes and both modes against its plain version (every bin equal)
   and its bound; then a QSO sample of 8e4 points, which the dispatch gives
   to K5, as JAX's default does (fewer than 100,000 points, coordinates
   outside [0, lbox)), counted again with ``method='tile'``, the two
   engines equal on the wrapped sample (and the bins counted in which they
   differ on the sample as RSD left it, past the faces), both counts timed
   by the default's engine and by the cell engine, and K5 against its plain
   version and bound at that shape;
9. K6, the nearest-neighbour distance of prepare_sim's ranks, bit-equal to
   its plain version on a 1.2e5-particle slab of scripts/hod/bench_ranks.py
   (seed 17), where its filtered plain mirror (bit-equal too) counts the
   pairs that reach K6's float64 chain, and K7, the annulus mass sums of
   Menv, against its plain version (the 27-cell sum by all pairs; rtol
   1e-12, the same zeros, two launches bit-equal) on 5e4 clumped halos in a
   box, in a light cone and in a box with r_inner past r_outer
   (``csrc/prepare_sim.cu``);
10. the engines at real size: ``rank_fields_device`` on the bench_ranks slab
   (1.2e6 particles) and ten times it, host to host, K6 by CUDA events
   against its float64 bound and its filtered bound (the chains that the
   filtered plain mirror counts on the first slab, their share of the pairs
   carried to the second), alone on the items of halos of at most 64
   particles and on the rest,
   lane occupancy, peak memory, at the first size all five rank fields held
   to the host per-halo loop (tie-aware) and K6 to its plain version, at
   the second K6 to its plain version on 4,000 sampled halos;
   ``do_menv_device`` on 2e6 clumped halos (docs/performance.md:309) in a
   box and an octant light cone, K7 by events against its bound and on
   2,000 sampled centres against its plain version,
   both engines on a 5e5 subset; ``shearmark_from_positions`` on 1e8
   particles at N_dim 1000, R 2 (prepare_sim's defaults), its K1 deposit,
   host Gaussian filter and ``get_shear`` timed, then K1 at nmesh 1000
   against the plain scatter;
11. ``prepare_slab_tables`` on a box slab of 2e5 halos and ~1.2e6 particles
   with ranks, Menv and the shear rank, with the device engines and with the
   'host' engines: every column equal (ranksc tie-aware, Menv rtol 1e-12),
   then K6 and K7 on what the ranks and env engines were handed, K6
   bit-equal to its plain version;
12. K1's multi-weight form (``tsc_deposit_cells_multi``, the gather of
   ``csrc/tsc_gather.cu``) on the 512^3 lattice with a unit column and four
   weight columns against the plain scatter, five single-column K1
   launches and its plain walk (bit-equal), and at one column beside K1; K8
   (``csrc/zcv_window.cu``, the window's mode sums over a row plan, whose
   rows, modes, items and build time it prints) at nmesh 256 and 512
   against its plain version (counts equal, two launches bit-equal), timed
   over rounds of launches and together with its plan's build, the bound
   of the plan's modes and of the full mesh, and one ``torch.bincount``;
13. the ZCV cell: ``zcv_products`` (the IC filter, ``get_fields``, the
   advection and five field FFTs in RSD and real space, 15 P_ij each, the
   window on K8 with its row plan's build timed apart, the ZA templates in a
   host process a core) on a Gaussian IC at 512^3 in the (2000 Mpc/h)^3
   box, then ``apply_zcv`` on a tracer of ~1e7 points drawn from the
   advected lattice, every stage timed;
   outputs finite and rho_tr_ZD >= 0.9 on the monopole's bins 1-5;
14. the rest of the power-spectrum surface on phase 7's ``run_hod`` mock:
   ``StagedPower`` of all tracers at docs/hod.md's settings (550^3, poles)
   staged once on K1's brick stage, one warm ``power()`` and five ``pz``
   overrides (z + s vz f_v) mod lbox, each against ``calc_power`` of the
   same points at rtol 2e-4 and timed host to host beside it, with each
   call's overflow share; a cross of two staged tracers and an interlaced
   stage; ``pk_to_xi`` (apply_zcv_xi's r bins) and ``project_3d_to_poles``
   on |delta_k|^2 of the mock at 512^3 against their plain versions;
   ``bin_kppi`` at 512^3 (64 k_perp x 32 pi bins to k_Nyq): K9
   (``csrc/kppi_bin.cu``) against its plain version (counts equal, sums at
   rtol 1e-11, two launches bit-equal, a full real mesh read through its
   [:, :, :kzlen] view), by CUDA events against its byte bound and one
   ``torch.bincount``; ``expand_poles_to_3d`` and ``get_smoothing`` at
   512^3, timed and finite;
16. the disk path, from CompaSO files the phase writes (the port's
   ``write_asdf``, blsc zstd) into a temporary directory that main removes
   after phase 19, whose scripts read it: a synthetic catalog in the AbacusSummit encodings (int16 radius ratios,
   RVint, the cleaning files' ``clean_dt`` columns, ~5 % of the halos
   merged; a header for ``AbacusSummit_base_c000_ph000`` at z 0.5, the
   metadata's values with an approximate velocity scale) of
   DISK_HALOS halos over DISK_SLABS slabs, DISK_PARTS A and DISK_FIELD
   field particles, a B set of 7/3 as many and packed PIDs for both
   (``testing.synthetic_compaso``); the blsc decode rate; (a)
   ``CompaSOHaloCatalog`` of every slab, cleaned and uncleaned, against the
   encodings' decode formulas on the arrays written (exact; particles to
   the RVint quantum), a cleaned read of slab 0's A + B with
   ``unpack_bits=True`` against the drawn PID words (every field equal),
   and slab 0 with ``fields='all'``, cleaned, and uncleaned with
   ``convert_units=False``, every column bit-equal to the drawn columns'
   decode (``testing.decoded_fields``);
   (b) ``prepare_sim.main`` serial through its command line (``_cli``,
   a JSON config) with ranks, env
   and the shear (1000^3, R 2, every particle) on the device engines
   (read, tables and write timed a slab; K6, K7 and K1 must launch), slab
   0's tables against ``prepare_slab_tables`` on the columns in memory
   (phase 11's rules); (c) ``_cli`` with ``Nparallel_load`` 2 on slabs 0-1,
   bit-equal to the serial run; (d) ``AbacusHOD.from_config`` staging and
   ``run_hod_pk_fused`` cold and warm (K1 and K3 must launch) against the
   same call on ``staged_state_from_numpy`` of the staged tables.
17. the light cone's disk path, from files the phase writes into a
   temporary directory (kept, as phase 16's, for phase 19): a halo light cone of LC_DISK_HALOS
   halos in the octant of the z = 0.5 shell (three observers, the
   AbacusSummit base boxes'), LC_DISK_PER_HALO A particles a halo in
   ``lc_pid_rv.asdf``, and a light-cone particle pair (RVint and packed
   PIDs, OutputType LightCone) of LC_DISK_PARTICLES
   (``testing.synthetic_compaso_lc``, blsc zstd); (1) the readers against
   the drawn arrays (every light-cone column bit-equal to its decode
   formula, and with ``fields='all'`` to ``testing.decoded_fields``, every
   PID field of the drawn words); (2) ``prepare_sim._cli --halo_lc``
   on the device engines (read, tables with the randoms
   loop timed apart, write; K6 and K7 must launch); (3) staging by
   ``AbacusHOD.from_config``; (4) ``run_hod``, each tracer's galaxies as
   many as the fused call's n_gal; (5) ``run_hod_pk_fused`` cold and warm
   (K1 and K3 must launch) against the same call on
   ``staged_state_from_numpy`` of the staged tables.
18. the ZCV chain through disk at 256^3 (``phase_zcv_disk``): the IC
   written as files, then each main through its command line (``_cli``):
   ``ic_fields``, ``advect_fields --want_rsd`` (RSD, then real space),
   ``zenbu_window`` (the window on K8; the templates are
   phase 13's first 128 k columns, written first and skipped),
   ``linear_fields``; ``ZCVProducts.from_dir`` /
   ``LCVProducts.from_dir`` held against the same IC's arrays in memory,
   and ``apply_zcv`` with ``zcv=None`` cold and with
   ``load_presaved=True``; each main's time, the bytes written, the read
   time, and the launches of K1, K1 multi-weight, K3 and K8 on the path.
19. the HOD and emulator scripts of ``scripts/torch/``, each through its
   own ``main`` or ``run`` (``phase_scripts``): (a) ``emulator/generate_cf.py`` on phase
   16's redshift directory at the default ndens (the 8e5 most massive
   halos, one K4 launch), the file read back (npairs, xi = npairs / RR - 1,
   the zname), and K4 equal to its plain version on a 5e4-halo selection;
   (b) ``hod/run_hod.py`` (ntest 2) on phase 16's prepared box with
   xi(rp, pi) at docs/hod.md's bins, its first mock's xirppi written as
   the data vector with an identity covariance, then
   ``hod/run_emcee.py:lnprob`` at the same parameters (exactly 0) and with
   LRG's logM_cut + 0.05 (below 0); (c) ``hod/run_lc_hod.py`` on phase 17's
   light cone, its catalogs written; (d) ``hod/bench_multitracer.py`` at its
   cell (1e7 halos, 5e7 particles, nmesh 256; its JSON line; K1 six times
   and K3 once a call), one warm step under ``utils/profiling.py``'s
   ``device_trace`` (the trace names K1's and K3's kernels) and one under
   ``stage_timer`` (within 20 % of step_seconds); (e)
   ``hod/bench_ranks.py:run`` at 1.2e6 particles with the host loop (0 key
   and 0 NN flips); (f) ``native/pipe_client`` built with gcc under
   ``build/``, fed by ``python -m abacusutils_tpu_torch.io.pipe_asdf``
   with N and x_L2com of a halo_info file: its lines equal the port's read.

Each K4 line ("K4 <mode> <pair>: ...") gives the time by CUDA events, the
grid and the work items, the candidate pairs the walk evaluates and the
in-range pairs with their rates, and the bound. The bound is stated for the
same work whatever grid the kernel walks: the candidates of the 27-cell walk
(14 cells for an autocorrelation) of the grid of lbox // rmax cells, times
their f32 operations up to the reject test (12 or 13 a pair, K4_PAIR_OPS) at
67e12 operations/s, or the bytes at 3.35 TB/s where those take longer. Phase
1 prints ptxas's registers and spills of the 30 pair-count instances and the
FFMA/DFMA count of their SASS: the (rp, pi) forms without a quotient and a
root (K4 with the item-constant wrap, K5 in float32 within one period) must
hold none.

Each K7 line (phases 9-11) gives its time by CUDA events, the bound (the
candidates of the 27-cell walk of the r_outer grid at 9 float64 operations,
K7_PAIR_OPS, at 34e12/s, or the bytes), the candidates the row walk visits,
its items and lane occupancy (the centres over the items' threads).

Each K1 line ("K1 <shape>: ...") gives, at one of the shapes the main
paths run (phases 4, 5, 6, 7 b, 7 d and 10), the time by CUDA events over 5 calls
after a warm-up, the bound (the bytes the deposit must move at 3.35 TB/s)
and its share of the time, the overflow share (galaxies deposited straight
into the grid because they left their brick's tile), the resident blocks an
SM holds, and ptxas's registers and spills. Each binning line (phases 4, 5,
6 and 7: "K2 at step shapes", "K3 at call shapes", "K3 poles ...") gives
the wrapper's time by CUDA events (host work between launches included),
the kernels' own device time by ``torch.profiler`` (the binning kernel and
its fixed-order reduction), the in-bin share of the modes, and the bound:
the bytes of the in-bin modes' seg and fields, the non-empty row groups'
spans, W and the sums, at 3.35 TB/s, with its share of the kernel-only
time. Every main path must leave ``mode_spans.builds`` unchanged: the
binning reads the row spans cached with its plan. The line before the last
is a JSON object describing each kernel; the last line is ``{"ok": true,
"device": {...}}``. Without CUDA, or when any phase fails, the script exits
non-zero before printing either.
"""

import contextlib
import copy
import ctypes.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from abacusutils_tpu_torch import _build
from abacusutils_tpu_torch.convert import position_columns, staged_state_from_numpy
from abacusutils_tpu_torch.io import asdf_file
from abacusutils_tpu_torch.io.asdf_file import open_asdf
from abacusutils_tpu_torch.io.bitpacked import unpack_pids, unpack_rvint
from abacusutils_tpu_torch.io.compaso import CompaSOHaloCatalog
from abacusutils_tpu_torch.io.read_abacus import read_asdf
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD
from abacusutils_tpu_torch.models.pipeline import (
    group_inputs2d_device,
    hod_pk_fused_yb,
    make_bin_plan_arrays,
    make_example_inputs_device,
    populate_lc_multi,
    populate_weights,
    populate_weights_multi,
)
from abacusutils_tpu_torch.ops.grid import (
    BRICK,
    KINDS,
    _f32,
    blocks_per_sm,
    gather_blocks_per_sm,
    gather_deposit_plain,
    overflow_count_plain,
    paint_3d_plain,
    stage_bricks,
    stage_gather,
    tile_bytes,
    tsc_deposit_cells,
    tsc_deposit_cells_multi,
)
from abacusutils_tpu_torch.ops.power import (
    StagedPower,
    _bin_means,
    _interlace_combine,
    _mesh_side,
    _scaled,
    _spectrum,
    bin_pair_modes,
    bin_pair_modes_plain,
    bin_power_modes,
    bin_power_modes_plain,
    bin_kppi,
    bin_kppi_sums,
    bin_kppi_sums_plain,
    calc_power,
    expand_poles_to_3d,
    field_pairs,
    get_field_fft,
    get_k_mu_edges,
    get_kppi_plan,
    get_mode_bin_plan,
    get_smoothing,
    get_W_compensated,
    mode_bin_plan,
    mode_bin_plan_device,
    mode_dup,
    mode_spans,
    pk_to_xi,
    project_3d_to_poles,
    row_spans,
)
from abacusutils_tpu_torch.ops import tpcf
from abacusutils_tpu_torch.ops.tpcf import (
    calc_xirppi_fast,
    candidate_pairs,
    candidate_pairs_coarse,
    count_pairs_all,
    count_pairs_all_plain,
    count_pairs_cells,
    count_pairs_cells_plain,
    edges_f32,
    pair_counts_rppi,
    stage_cells,
)
from abacusutils_tpu_torch.models.hod import menv_device, prepare_sim, ranks_device
from abacusutils_tpu_torch.models.hod import nfw
from abacusutils_tpu_torch.models.hod import population as tpop
from abacusutils_tpu_torch.models.zcv import advect_fields as zcv_adv
from abacusutils_tpu_torch.models.zcv import apply as zcv_apply
from abacusutils_tpu_torch.models.zcv import cosmo as zcv_cosmo
from abacusutils_tpu_torch.models.zcv import ic_fields as zcv_ic
from abacusutils_tpu_torch.models.zcv import linear_fields as zcv_lin
from abacusutils_tpu_torch.models.zcv import precompute as zcv_pre
from abacusutils_tpu_torch.models.zcv import tools_cv as zcv_tools
from abacusutils_tpu_torch.models.zcv import tracer_power as zcv_tp
from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw
from abacusutils_tpu_torch.models.zcv.tools_cv import ZCV_FIELDS
from abacusutils_tpu_torch.models.hod.menv import do_Menv_from_tree
from abacusutils_tpu_torch.ops import grid as tgrid
from abacusutils_tpu_torch.ops import shear as tshear
from abacusutils_tpu_torch.testing import (
    LC_ORIGINS,
    LC_SHELL,
    RV_POS_QUANTUM,
    RV_VEL_QUANTUM,
    decoded_catalog,
    decoded_catalog_lc,
    decoded_fields,
    edge_points,
    menv_ranges,
    nfw_draw,
    smoothing_at_bin_centres,
    synthetic_compaso,
    synthetic_compaso_lc,
    write_compaso_lc,
    write_compaso_sim,
)

N_HALO = 10_000_000
N_PART = 50_000_000
LBOX = 2000.0
NMESH = 256
YB = None  # the y extent of K1's bricks: the default brick
NBINS_K = NMESH // 2
VELZ2KMS = 100.0
SEED = 42
N_EDGE = 4_000_000
WANT = ('LRG', 'ELG', 'QSO')
# the tracers of tests/test_pipeline.py:37-49, with assembly bias switched on
_AB = {'Acent': 0.05, 'Asat': -0.1, 'Bcent': 0.03, 'Bsat': 0.05}
TRACERS = {
    'LRG': {
        'logM_cut': 12.8, 'logM1': 14.0, 'sigma': 0.3, 'alpha': 1.0, 'kappa': 0.4,
        'alpha_c': 0.3, 'alpha_s': 1.0, 'ic': 1.0, **_AB,
    },
    'ELG': {
        'logM_cut': 11.6, 'logM1': 13.5, 'sigma': 0.3, 'alpha': 0.8, 'kappa': 1.0,
        'p_max': 0.1, 'Q': 100.0, 'gamma': 1.2, 'A_s': 1.0, 'alpha_c': 0.1, 'alpha_s': 1.0, **_AB,
    },
    'QSO': {
        'logM_cut': 12.2, 'logM1': 13.8, 'sigma': 0.5, 'alpha': 0.8, 'kappa': 1.0,
        'alpha_c': 0.2, 'alpha_s': 1.0, **_AB,
    },
}
LC_ORIGIN = (-1010.0, -1010.0, -1010.0)  # 10 Mpc/h outside the box corner
# phase 7 (b): compute_power at the settings of docs/hod.md:33-40
DOCS_NMESH = 550
DOCS_NBINS_K = 128
DOCS_KMAX = 0.5
POLES = (0, 2, 4)
# phase 7 (e): the mesh whose plan the port used to build on the host
COLD_NMESH = 512
# the H100 SXM's memory rate (NVIDIA's data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
# ptxas's (registers, spill stores, spill loads) of each K1 instantiation,
# by (kind, flush width)
K1_PTXAS = {}
# {(grids, unit grid first): (registers, spill store bytes, spill load
# bytes)} of the multi-weight gather's instances
GATHER_PTXAS = {}
# (registers, spill stores, spill loads) of K9's two kernels
K9_PTXAS = {}
# pair counting (phase 8): rp and s edges, pimax, the pi bin of xi(rp, pi)
# and the mu bins of docs/hod.md:36-38 and scripts/tpcf/bench.py:46-48
PAIR_BINS = np.logspace(-1, np.log10(30.0), 9)
PIMAX, PI_BIN, NMU = 30, 5, 20
PAIR_RMAX = 30.0
N_K4_CHECK = 200_000
N_K5_CHECK = 20_000
# a QSO sample at survey density in the box: the dispatch gives it to the
# cell engine; method='tile' counts it with the all-pairs engine
N_SPARSE = 80_000
# the H100 SXM's f32 and f64 rates outside the tensor cores (NVIDIA's data
# sheet), operations/s. The data sheet counts an FMA as two operations, so
# unfused _rn adds and products issue at half of these rates; the bounds
# below divide by them all the same, as the published peaks
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# operations a candidate pair costs up to the reject test, counted from
# csrc/pair_count.cu. K4 (item-constant wrap): 3 differences, 3 wrap
# subtractions, the products and sums of r2 (rppi 2 + 1, smu 3 + 2), the
# compares (rppi 3: dz and two edges; smu 2). K5: 3 differences and a
# quotient, a round, a product and a difference an axis, then the same
K4_PAIR_OPS = {'rppi': 12, 'smu': 13}
K5_PAIR_OPS = {'rppi': 21, 'smu': 22}
# ptxas's (registers, spill stores, spill loads) and the SASS FFMA/DFMA count
# of each pair-count kernel instance, by its name in the build log
PAIR_PTXAS = {}
PAIR_FMA = {}
# prepare_sim (phases 9-11): the ranks slab sizes of scripts/hod/bench_ranks.py
# (its default, and ten times it, nearer a base-box slab after prepare_sim's
# halo down-sampling), the K6 check slab; Menv at docs/performance.md:309
# (2e6 halos in 20,000 clumps of sigma 8 Mpc/h in a (2000 Mpc/h)^3 box,
# r_outer 10, r_inner per halo), held to the host tree on a subset, and the
# K7 check catalog; the shear field at prepare_sim's defaults shear_N,
# shear_R and partdown (prepare_sim.py:955-957: a 3 % A subsample of 6912^3
# particles divided by 100); the slab of phase 11
N_RANKS = (1_200_000, 12_000_000)
# launches a K6 time on the small-halo items or the rest is the mean of
K6_SPLIT_REPS = 20
N_RANKS_CHECK = 120_000
N_RANKS_SAMPLE = 4_000  # halos held to K6's plain version past the first size
N_MENV = 2_000_000
N_MENV_CLUMPS = 20_000
MENV_SIGMA = 8.0
MENV_ROUT = 10.0
N_MENV_HOST = 500_000
N_MENV_CHECK = 50_000
N_MENV_SAMPLE = 2_000  # centres held to the plain version at the full size
N_SHEAR = 100_000_000
SHEAR_N = 1000
SHEAR_R = 2.0
N_SLAB_HALOS = 200_000
N_SLAB_PARTS = 1_200_000
MPART = 2.1e9
HUBBLE = 0.6736
# float64 operations a K6 pair (3 differences, 3 products, 2 sums) and a K7
# candidate (the same and the compare) cost, csrc/prepare_sim.cu; K6's
# float32 filter a pair (3 differences, a product, 2 FMAs counted as 2 each,
# the compare)
K6_PAIR_OPS = 8
K7_PAIR_OPS = 9
K6_FILTER_OPS = 9


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def sync_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def timed_stages(specs, steps, calls=None):
    """While the block runs, each function mod.name of `specs` adds its host
    to host seconds (the device synchronised before and after) to
    steps[name], and its calls to calls[name]. Functions with a launch
    counter of their own are not to be wrapped (see the verify notes)."""
    saved = []
    for mod, name in specs:
        fn = getattr(mod, name)

        def run(*a, _fn=fn, _name=name, **k):
            out, sec = sync_seconds(lambda: _fn(*a, **k))
            steps[_name] = steps.get(_name, 0.0) + sec
            if calls is not None:
                calls[_name] = calls.get(_name, 0) + 1
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, run)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def event_ms(fn, reps=5):
    """Mean device time of `fn` over `reps` calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_runs(fn, reps, rounds):
    """:func:`event_ms` of `fn` over `reps` calls, `rounds` times: the
    per-round means, for their spread."""
    return [event_ms(fn, reps) for _ in range(rounds)]


def kernel_ms(fn, name='mode_bin', reps=5):
    """Device time a call of the kernels whose names hold `name` that `fn`
    launches, from torch.profiler's key_averages over `reps` calls after a
    warm-up; None where the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key:
            t = getattr(e, 'self_device_time_total', None)
            us += e.self_cuda_time_total if t is None else t
    return us / reps / 1e3 if us > 0 else None


def binning_bound(seg, nbins, nfields, windowed, out_bytes):
    """The least time (ms) of a binning at 3.35 TB/s and its in-bin share:
    seg and the nfields complex64 values of each mode in a bin read once,
    each non-empty group of four rows' id and [lo, hi) spans, W (when
    `windowed`) and the sums (`out_bytes`) once. Its few flops a mode and
    pair are far below the f32 rate, so bytes bound it."""
    n1d = _mesh_side(seg.numel())
    n_in = int(((seg >= 0) & (seg < nbins)).sum())
    groups = row_spans(seg, nbins).groups.numel()
    nbytes = n_in * (4 + 8 * nfields) + 36 * groups + (4 * n1d if windowed else 0) + out_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3, n_in / seg.numel()


def binning_line(tag, form, wrap_ms, k_ms, plain_ms, err, bound, share, lib_ms):
    """Print one binning line; returns the kernels line's record of it."""
    k_txt = 'not measured' if k_ms is None else f'{k_ms:.4f} ms, bound share {bound / k_ms:.3f}'
    print(f'{tag}: {form} wrapper {wrap_ms:.4f} ms (events), kernel-only {k_txt} (profiler) vs '
          f'plain {plain_ms:.4f} ms, max|d| {err:.3e}; in-bin share {share:.4f}, bound '
          f'{bound:.4f} ms; library (torch.bincount of precomputed weights, the binning only) '
          f'{lib_ms:.4f} ms')
    return dict(ms=wrap_ms, kernel_ms=k_ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound,
                bound_by='bytes', in_bin_share=share, library_ms=lib_ms,
                library_call=LIBRARY_CALL)


CARD = ['']  # nvidia-smi's name and power limit of the card, printed beside times


def phase_build():
    print('torch', torch.__version__, 'cuda', torch.version.cuda, 'python', sys.version.split()[0])
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print('nvidia-smi:', smi)
    CARD[0] = smi
    print('device:', torch.cuda.get_device_name(0), 'count', torch.cuda.device_count())
    # the zstd library the ASDF reader's Blosc decoder loads at first use
    # (io/blosc.py), or None where the card machine has none
    print(f"phase 1 ctypes.util.find_library('zstd'): {ctypes.util.find_library('zstd')!r}")
    path, secs, log = _build.build()
    for line in log.splitlines():
        if line.startswith('nvcc '):
            print('build:', line.strip())
        elif 'registers' in line or 'Compiling entry' in line or 'spill' in line:
            print('ptxas:', line.strip())
    K1_PTXAS.update(ptxas_k1(log))
    GATHER_PTXAS.update(ptxas_gather(log))
    K9_PTXAS.update(ptxas_of(log, lambda m: 'K9 rows' if 'kppi_rows' in m else (
        'K9 reduce' if 'kppi_reduce' in m else None)))
    PAIR_PTXAS.update(ptxas_pairs(log))
    _build.lib()
    print(f'phase 1 build: {path.name} in {secs:.2f} s; K1 (kind, flush width): '
          f'(registers, spill stores, spill loads) {K1_PTXAS}; the multi-weight gather '
          f'(grids, unit grid first): {GATHER_PTXAS}; K9: {K9_PTXAS}')
    require(len(K9_PTXAS) == 2, f'ptxas reported {len(K9_PTXAS)} K9 kernels, not 2')
    # TSC and CIC at three flush widths; the gather of 1 to 5 grids with and
    # without a unit grid
    require(len(K1_PTXAS) == 6, f'ptxas reported {len(K1_PTXAS)} K1 instantiations, not 6')
    require(len(GATHER_PTXAS) == 10, f'ptxas reported {len(GATHER_PTXAS)} gather instances, not 10')
    atomics = sass_atomics(path)
    print(f'phase 1 build: atomic opcodes in the SASS of K1 and its multi-weight gather {atomics}')
    gathers = {k: v for k, v in atomics.items() if k.startswith('gather')}
    require(len(gathers) == 10 and not any(gathers.values()),
            f'the multi-weight gather holds atomics: {atomics}')
    PAIR_FMA.update(sass_fma(path))
    print(f'phase 1 build: K4/K5 (registers, spill stores, spill loads) {PAIR_PTXAS}; '
          f'FFMA + DFMA in their SASS (a quotient or a root expands into some) {PAIR_FMA}')
    # 24 instances that bin by the table and one general instance a mode
    # (K4) or a type and mode (K5) that compares against every edge
    require(len(PAIR_PTXAS) == 30, f'ptxas reported {len(PAIR_PTXAS)} pair-count instances, not 30')
    require(len(PAIR_FMA) == 30, f'the SASS holds {len(PAIR_FMA)} pair-count kernels, not 30')
    # the forms without a quotient and a root (K4's (rp, pi) with the
    # item-constant wrap, the main path's; K5's f32 (rp, pi) within one
    # period): any FMA there would be a contracted product and sum of the
    # pair arithmetic
    for skip in ('pairs', 'self'):
        for name in (f'K4[rppi, wrap, {skip}, table]', f'K5[rppi, f32, period, {skip}, table]'):
            require(PAIR_FMA[name] == 0, f'{name} holds fused multiply-adds: {PAIR_FMA}')


def ptxas_k1(log):
    """{(kind, flush width): (registers, spill store bytes, spill load bytes)}
    of the K1 instantiations in the build's -Xptxas -v log."""
    def name(entry):
        k = re.search(r'tsc_deposit_bricks_kernelILi(\d)ELi(\d)EE', entry)
        return k and (KINDS[int(k.group(1))], int(k.group(2)))

    return ptxas_of(log, name)


def ptxas_gather(log):
    """{(grids, unit grid first): (registers, spill store bytes, spill load
    bytes)} of the multi-weight gather's instances in the build's -Xptxas
    -v log."""

    def name(entry):
        k = re.search(r'tsc_gather_kernelILi(\d)ELb(\d)EE', entry)
        return k and (int(k.group(1)), k.group(2) == '1')

    return ptxas_of(log, name)


def ptxas_of(log, name_of):
    """{name_of(entry): (registers, spill store bytes, spill load bytes)} of
    the kernels of the -Xptxas -v log that name_of names (None: skipped)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = name_of(m.group(1)) or None
            if cur:
                out[cur] = [None, None, None]
            continue
        if cur is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r'Used (\d+) registers', line)
        if m:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def pair_kernel_name(mangled):
    """'K4[rppi, wrap, pairs, table]' / 'K5[smu, f64, period, self, edges]'
    for a pair-count kernel's mangled name ('self': the instance that skips
    the pair of a point with itself by index; 'table': the bin from the table
    over r2's leading bits, 'edges': from a compare against every edge),
    else None."""
    m = re.search(r'pair_count_cells_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)EE', mangled)
    if m:
        return (f'K4[{tpcf.MODES[int(m.group(1))]}, {"wrap" if m.group(2) == "1" else "round"}, '
                f'{"self" if m.group(3) == "1" else "pairs"}, '
                f'{"table" if m.group(4) == "1" else "edges"}]')
    m = re.search(r'pair_count_all_kernelI([fd])Li(\d)ELb(\d)ELb(\d)ELb(\d)EE', mangled)
    if m:
        return (f'K5[{tpcf.MODES[int(m.group(2))]}, {"f32" if m.group(1) == "f" else "f64"}, '
                f'{"period" if m.group(3) == "1" else "round"}, '
                f'{"self" if m.group(4) == "1" else "pairs"}, '
                f'{"table" if m.group(5) == "1" else "edges"}]')
    return None


def ptxas_pairs(log):
    """{instance: (registers, spill store bytes, spill load bytes)} of the
    pair-count kernels in the build's -Xptxas -v log."""
    return ptxas_of(log, pair_kernel_name)


def sass_atomics(lib):
    """{kernel: {opcode: count}} of the atomic and reduction opcodes in the
    SASS (cuobjdump -sass) of K1's instances ('K1[kind, width]') and of the
    multi-weight gather's ('gather[grids, unit 0 or 1]'); a kernel without
    any maps to an empty dict."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([tool, '-sass', str(lib)], capture_output=True, text=True)
    require(res.returncode == 0, f'cuobjdump failed: {res.stderr[-300:]}')
    func, out = None, {}
    for line in res.stdout.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            k = re.search(r'tsc_deposit_bricks_kernelILi(\d)ELi(\d)EE', m.group(1))
            g = re.search(r'tsc_gather_kernelILi(\d)ELb(\d)EE', m.group(1))
            func = (f'K1[{KINDS[int(k.group(1))]}, {k.group(2)}]' if k
                    else f'gather[{g.group(1)}, unit {g.group(2)}]' if g else None)
            if func:
                out[func] = {}
            continue
        m = func and re.search(r'\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Za-z0-9_.]+)', line)
        if m:
            out[func][m.group(1)] = out[func].get(m.group(1), 0) + 1
    return out


def sass_fma(lib):
    """{instance: FFMA + DFMA instructions} of the pair-count kernels in the
    library's SASS (cuobjdump -sass)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([tool, '-sass', str(lib)], capture_output=True, text=True)
    require(res.returncode == 0, f'cuobjdump failed: {res.stderr[-300:]}')
    func, counts = None, {}
    for line in res.stdout.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            func = pair_kernel_name(m.group(1))
            if func:
                counts[func] = 0
            continue
        if func and re.search(r'\b[FD]FMA\b', line):
            counts[func] += 1
    return counts


def k1_bound(launches, ngrids, nmesh):
    """The least time (ms) of K1's work at 3.35 TB/s: per launch the weight
    of every point and x, y, z of the kept ones read once, and each grid
    written once. `launches` is [(points, kept points)]; the stencil's
    27 x 5 flops per kept point are far below the f32 rate, so bytes
    bound it."""
    nbytes = sum(4 * n + 12 * k for n, k in launches) + 4 * ngrids * nmesh**3
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def k1_line(tag, ms, launches, ngrids, nmesh, overflow, plan, kind='tsc'):
    """Print the K1 line of one shape; returns its JSON record."""
    bound, nbytes = k1_bound(launches, ngrids, nmesh)
    kept = sum(k for _, k in launches)
    width = next(v for v in (4, 2, 1) if nmesh % v == 0)
    regs = K1_PTXAS.get((kind, width), (None, None, None))
    rec = {
        'shape': tag, 'ms': ms, 'bound_ms': bound, 'bound_share': bound / ms,
        'overflow_share': overflow / max(kept, 1), 'blocks_per_sm': blocks_per_sm(plan, kind),
        'brick': plan.brick, 'margin': plan.margin, 'tile_bytes': tile_bytes(plan.brick,
                                                                            plan.margin),
        'items': int(plan.work.shape[0]), 'launches': len(launches), 'kept': kept,
        'registers': regs[0], 'spill_stores': regs[1], 'spill_loads': regs[2],
        'flush_width': width,
    }
    print(f'K1 {tag}: {ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), '
          f'share {bound / ms:.3f}; overflow share {rec["overflow_share"]:.3e} ({overflow} of '
          f'{kept}); {rec["blocks_per_sm"]} blocks/SM (tile {rec["tile_bytes"]} B, brick '
          f'{plan.brick}, margin {plan.margin}, {rec["items"]} items a launch); ptxas '
          f'{regs[0]} registers, spill stores {regs[1]} B, loads {regs[2]} B')
    return rec


def phase_k1(dev):
    rng = np.random.default_rng(SEED)
    pos = edge_points(N_EDGE, NMESH, BRICK[1], LBOX, rng)
    w = rng.random(N_EDGE).astype(np.float32)
    w[::5] = 0.0
    cols = [torch.from_numpy(pos[:, i].copy()).to(dev) for i in range(3)]
    wt = torch.from_numpy(w).to(dev)
    (x, y, z, ws), plan = stage_bricks(cols + [wt], NMESH, LBOX)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    grid_k = torch.zeros((NMESH,) * 3, device=dev)
    tsc_deposit_cells(grid_k, x, y, z, ws, plan, LBOX, 0.0, overflow)
    grid_p = paint_3d_plain(torch.zeros_like(grid_k), *cols, wt, NMESH, LBOX)
    torch.cuda.synchronize()
    n_over = int(overflow.item())
    diff = float((grid_k - grid_p).abs().max())
    gmax = float(grid_p.abs().max())
    mass_k, mass_p = float(grid_k.double().sum()), float(grid_p.double().sum())
    print(
        f'phase 2 K1 vs plain: {N_EDGE} edge points, overflow word {n_over}, '
        f'max|d| {diff:.3e} (max|grid| {gmax:.4f}), mass {mass_k:.6f} vs {mass_p:.6f}'
    )
    require(n_over == 0, f'K1 overflow word {n_over}: the staging key and the kernel disagree')
    require(diff <= 1e-5 * gmax, f'K1 max|d| {diff} > 1e-5 * {gmax}')
    require(abs(mass_k - mass_p) <= 1e-6 * abs(mass_p), 'K1 total mass differs')
    return grid_p


def phase_k2(grid, seg, W):
    delta = grid * (grid.numel() / grid.sum()) - 1.0
    dk = torch.fft.rfftn(delta)
    scale = 1.0 / grid.numel()
    got = bin_power_modes(dk, seg, W, scale, NBINS_K)
    again = bin_power_modes(dk, seg, W, scale, NBINS_K)
    ref = bin_power_modes_plain(dk, seg, W, scale, NBINS_K)
    torch.cuda.synchronize()
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    same = bool(torch.equal(got, again))
    print(f'phase 3 K2 vs plain: {dk.numel()} modes (strides {dk.stride()}), {NBINS_K} bins, '
          f'max rel {rel:.3e}; a second launch bit-identical: {same}')
    require(bool(torch.isfinite(got).all()), 'K2 output not finite')
    require(bool(((got - ref).abs() <= 1e-5 * ref.abs()).all()), f'K2 max rel {rel} > 1e-5')
    require(same, 'two K2 launches on the same inputs differ')


def deposit_inputs(halo_g, part_g, sh, sp, params):
    """The step's populate pass, as (x, y, z, weight, brick plan) per
    catalog, in the box frame the deposit takes."""
    inv_v = float(np.float32(1.0) / np.float32(VELZ2KMS))
    half = float(np.float32(LBOX) / 2)
    z_c, keep_c, z_s, keep_s = populate_weights(halo_g, part_g, params, True, inv_v)
    return [
        (halo_g['x'] + half, halo_g['y'] + half, z_c + half, keep_c, sh),
        (part_g['x'] + half, part_g['y'] + half, z_s + half, keep_s, sp),
    ]


def plain_step(dep, seg, W):
    """The step from the plain versions only (no kernel launches)."""
    n_gal = dep[0][3].sum() + dep[1][3].sum()
    grid = torch.zeros((NMESH,) * 3, device=n_gal.device)
    for x, y, z, w, _ in dep:
        paint_3d_plain(grid, x, y, z, w, NMESH, LBOX)
    delta = grid * (grid.numel() / n_gal) - 1.0
    wsum = bin_power_modes_plain(torch.fft.rfftn(delta), seg, W, 1.0 / grid.numel(), NBINS_K)
    return wsum, n_gal


def phase_step(dev, seg, W):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    (halo, part, params), t_in = sync_seconds(
        lambda: make_example_inputs_device(N_HALO, N_PART, LBOX, gen, dev)
    )
    stage = lambda: (  # noqa: E731
        group_inputs2d_device(halo, NMESH, LBOX, YB), group_inputs2d_device(part, NMESH, LBOX, YB)
    )
    t_stage_cold = sync_seconds(stage)[1]  # frees the cold result before the warm run
    ((halo_g, sh), (part_g, sp)), t_stage = sync_seconds(stage)
    del halo, part
    print(f'phase 4 inputs {t_in:.3f} s, staging cold {t_stage_cold:.3f} s warm {t_stage:.3f} s')

    overflow = torch.zeros(1, dtype=torch.int32, device=dev)

    def step():
        return hod_pk_fused_yb(
            halo_g, part_g, params, seg, W, LBOX, VELZ2KMS, NMESH, YB, NBINS_K, sh, sp,
            rsd=True, overflow=overflow,
        )

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    spans = mode_spans.builds
    (wsum, n_gal), t_warm = sync_seconds(step)
    n_iter, best = 5, float('inf')
    for _ in range(3):
        _, dt = sync_seconds(lambda: [step() for _ in range(n_iter)])
        best = min(best, dt / n_iter)
    launches = read_launches()
    n_steps = 1 + 3 * n_iter
    peak = torch.cuda.max_memory_allocated()
    n_gal_v = float(n_gal)
    over_share = int(overflow.item()) / (n_gal_v * n_steps)
    print(
        f'phase 4 step: n_gal {n_gal_v:.0f}, step_seconds {best:.6f} (warm-up {t_warm:.3f} s), '
        f'galaxies/s {n_gal_v / best:.6e}, peak memory {peak / 2**30:.3f} GiB, K1 overflow '
        f'share {over_share:.3e}, launches {launches}'
    )
    require(launches['tsc_deposit_cells'] == 2 * n_steps, f'K1 launches {launches}')
    require(launches['bin_power_modes'] == n_steps, f'K2 launches {launches}')
    require(launches['bin_pair_modes'] == 0, f'K3 launches {launches}')
    require(mode_spans.builds == spans, 'the step built row spans: its seg is not the plan\'s')
    require(bool(torch.isfinite(wsum).all() & (wsum >= 0).all()), 'wsum not finite and >= 0')
    require(float(wsum.sum()) > 0 and n_gal_v > 0, 'empty step')

    # each kernel against its plain version at the step's shapes
    dep = deposit_inputs(halo_g, part_g, sh, sp, params)
    grid_k = torch.zeros((NMESH,) * 3, device=dev)
    grid_p = torch.zeros_like(grid_k)

    k1_ms, p1_ms, k1_err, k1_rec = time_k1(
        'bench step (phase 4), 256^3, 2 launches, 1 grid', [dep], NMESH, 'tsc')
    print(f'phase 4 K1 at step shapes: {k1_ms:.4f} ms vs plain {p1_ms:.4f} ms, max|d| {k1_err:.3e}')

    dk = torch.fft.rfftn(k1_rec.pop('grid') * (NMESH**3 / n_gal) - 1.0)
    scale = 1.0 / NMESH**3
    k2_ms = event_ms(lambda: bin_power_modes(dk, seg, W, scale, NBINS_K))
    k2_kernel = kernel_ms(lambda: bin_power_modes(dk, seg, W, scale, NBINS_K))
    p2_ms = event_ms(lambda: bin_power_modes_plain(dk, seg, W, scale, NBINS_K))
    got = bin_power_modes(dk, seg, W, scale, NBINS_K)
    ref = bin_power_modes_plain(dk, seg, W, scale, NBINS_K)
    k2_err = float((got - ref).abs().max())
    # the binning alone as one library call: bincount of precomputed weights
    wmode = (_scaled(dk, scale, W).abs() ** 2 * mode_dup_t(NMESH, dk.device)).reshape(-1)
    seg_l = seg.reshape(-1).long()
    lib_ms = event_ms(lambda: torch.bincount(seg_l, weights=wmode, minlength=NBINS_K + 1))
    del wmode, seg_l
    k2_bound, share = binning_bound(seg, NBINS_K, 1, True, 4 * NBINS_K)
    k2 = binning_line(f'phase 4 K2 at step shapes (delta_k strides {dk.stride()})', '',
                      k2_ms, k2_kernel, p2_ms, k2_err, k2_bound, share, lib_ms)
    require(bool(((got - ref).abs() <= 1e-5 * ref.abs()).all()), 'K2 disagrees at step shapes')

    # the whole step against the step built from the plain versions
    (wsum_p, n_gal_p), t_plain = sync_seconds(lambda: plain_step(dep, seg, W))
    rel = float(((wsum - wsum_p).abs() / wsum_p.abs().clamp_min(1e-30)).max())
    print(f'phase 4 plain step {t_plain:.3f} s: n_gal {float(n_gal_p):.0f}, wsum max rel {rel:.3e}')
    require(float(n_gal_p) == n_gal_v, 'n_gal differs from the plain step')
    require(bool(((wsum - wsum_p).abs() <= 1e-4 * wsum_p.abs()).all()), f'wsum rel {rel} > 1e-4')

    return launches, {
        'tsc_deposit_cells': dict(ms=k1_ms, plain_ms=p1_ms, max_abs_err=k1_err,
                                  bound_ms=k1_rec['bound_ms'], bound_by='bytes', library_ms=None,
                                  shapes=[k1_rec]),
        'bin_power_modes': k2,
    }


LIBRARY_CALL = ('torch.bincount(seg, weights=w, minlength=nbins + 1) on precomputed per-mode '
                'weights: the binning only')


def mode_dup_t(n1d, device):
    """The Hermitian multiplicity of each rfft mode as a mesh on `device`."""
    return torch.from_numpy(mode_dup(n1d)).to(device).reshape(n1d, n1d, n1d // 2 + 1)


def time_k1(tag, grids, nmesh, kind, check_overflow=None):
    """K1 at one shape of a main path against the plain scatter: `grids` is
    a list, one per grid the path paints, of the (x, y, z, w, plan)
    deposits into it. Times both by CUDA events (5 calls after a warm-up),
    checks the kernel's grids against the plain ones (max|d| <= 1e-5
    max|grid|: float atomics sum in a run-dependent order) and its overflow
    word against the plain count, and prints the K1 line. Returns (ms,
    plain_ms, max|d|, the K1 line's record with the first kernel grid)."""
    dev = grids[0][0][0].device
    gk = [torch.zeros((nmesh,) * 3, device=dev) for _ in grids]
    gp = [torch.zeros((nmesh,) * 3, device=dev) for _ in grids]
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)

    def k1():
        for g, deps in zip(gk, grids):
            g.zero_()
            for x, y, z, w, plan in deps:
                tsc_deposit_cells(g, x, y, z, w, plan, LBOX, 0.0, overflow, kind)

    def p1():
        for g, deps in zip(gp, grids):
            g.zero_()
            for x, y, z, w, _ in deps:
                paint_3d_plain(g, x, y, z, w, nmesh, LBOX, 0.0, kind)

    ms, plain_ms = event_ms(k1), event_ms(p1)
    overflow.zero_()
    k1()
    n_over = int(overflow.item())
    want = sum(int(overflow_count_plain(x, y, z, w, plan, LBOX, 0.0, kind))
               for deps in grids for x, y, z, w, plan in deps)
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    gmax = max(float(b.abs().max()) for b in gp)
    require(n_over == want, f'K1 {tag}: overflow word {n_over} != plain count {want}')
    if check_overflow is not None:
        require(n_over == check_overflow, f'K1 {tag}: overflow word {n_over}')
    require(err <= 1e-5 * gmax, f'K1 {tag} disagrees with the plain scatter ({err:.3e})')
    launches = [(int(w.numel()), int((w != 0).sum())) for deps in grids for _, _, _, w, _ in deps]
    rec = k1_line(tag, ms, launches, len(grids), nmesh, n_over, grids[0][0][4], kind)
    rec.update(plain_ms=plain_ms, max_abs_err=err, grid=gk[0])
    return ms, plain_ms, err, rec


def clustered_points(n, lbox, gen, dev):
    """The clustered sample of scripts/tpcf/bench.py:18-27 drawn on the
    device: n // 8 uniform centres, each point on a shell of radius 0.3 x
    Exp(1) around a random centre, wrapped into the box. Returns x, y, z."""
    n_halo = n // 8
    centres = torch.rand((n_halo, 3), generator=gen, device=dev) * lbox
    parent = torch.randint(0, n_halo, (n,), generator=gen, device=dev)
    r = -0.3 * torch.log1p(-torch.rand(n, generator=gen, device=dev))
    offs = torch.randn((n, 3), generator=gen, device=dev)
    offs = offs * (r / offs.norm(dim=1))[:, None]
    pos = torch.remainder(centres[parent] + offs, lbox)
    return [pos[:, i].contiguous() for i in range(3)]


def pair_modes():
    """(mode, nb2, aux) of the two binnings at the main path's widths."""
    return [('rppi', PIMAX, float(PIMAX)), ('smu', NMU, float(NMU))]


def k4_bound(stage1, stage2, mode, nbins, lbox=None):
    """The least time (ms) of one K4 launch, its limiter and the candidate
    pairs it is stated for: those of the 27-cell walk (14 for an
    autocorrelation) of the grid of lbox // PAIR_RMAX cells on the stages'
    points, whatever grid the kernel walks. The larger of their f32
    operations (K4_PAIR_OPS) at 67 TFLOP/s and the bytes (both sides'
    columns, the cell starts, the work list, the int64 counts) at 3.35 TB/s."""
    cand = candidate_pairs_coarse(stage1, stage2, int((lbox or stage1.lbox) // PAIR_RMAX))
    b = stage1 if stage2 is None else stage2
    nbytes = 12 * stage1.n + 12 * b.n + 4 * b.starts.numel() + 12 * stage1.work.shape[0] + 8 * nbins
    t_ops = cand * K4_PAIR_OPS[mode] / F32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes', cand


def k5_bound(n1, n2, mode, nbins, dtype):
    size, rate = (4, F32_OPS_PER_S) if dtype == torch.float32 else (8, F64_OPS_PER_S)
    t_ops = n1 * n2 * K5_PAIR_OPS[mode] / rate * 1e3
    t_bytes = (3 * size * (n1 + n2) + 8 * nbins) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def check_k4(tag, cols1, cols2, lbox, edges, nc=None, span=None):
    """K4 in both modes on one pair of catalogs (cols2 None: auto) against
    its plain version, bin for bin, and a second launch against the first,
    on the grid the dispatch would take (or of `nc` cells, items of `span`).
    Returns {mode: counts}."""
    if nc is None:
        n2 = cols1[0].numel() if cols2 is None else cols2[0].numel()
        nc, refine = tpcf.cell_grid(lbox, PAIR_RMAX, min(cols1[0].numel(), n2))
        span = tpcf.default_span(nc, refine, cols1[0].numel())
    s1 = stage_cells(*(torch.remainder(c, _f32(lbox)) for c in cols1), lbox, nc, span)
    s2 = None if cols2 is None else stage_cells(
        *(torch.remainder(c, _f32(lbox)) for c in cols2), lbox, nc, span)
    thr = edges_f32(np.asarray(edges, np.float64) ** 2)
    out = {}
    for mode, nb2, aux in pair_modes():
        walk = tpcf.walk_rows(nc, float(lbox), float(thr[-1]), nb2, mode, s2 is None)
        got = count_pairs_cells(s1, s2, thr, nb2, mode, aux)
        again = count_pairs_cells(s1, s2, thr, nb2, mode, aux)
        (ref, t_plain) = sync_seconds(lambda: count_pairs_cells_plain(
            s1, s2, thr, nb2, mode, aux, max_pairs=1 << 24))
        bad = int((got != ref).sum())
        print(f'{tag} {mode}: nc {nc}, span {s1.span}, {len(walk.rows)} rows of reach {walk.reach} '
              f'({"wrap" if walk.use_wrap else "round"}), {s1.n} x {s1.n if s2 is None else s2.n} '
              f'points, {s1.work.shape[0]} items, largest cell {s1.max_occ}, candidates '
              f'{candidate_pairs(s1, s2, thr, nb2, mode)}, in-range pairs {int(got.sum())}, bins '
              f'that differ from plain {bad}, second launch equal '
              f'{bool(torch.equal(got, again))}, plain {t_plain * 1e3:.1f} ms')
        require(bad == 0, f'{tag} {mode}: K4 differs from its plain version in {bad} bins')
        require(bool(torch.equal(got, again)), f'{tag} {mode}: two K4 launches differ')
        require(int(got.sum()) > 0, f'{tag} {mode}: no pair in range')
        out[mode] = got
    return out


def check_k5(tag, cols1, cols2, lbox, edges, dtype, time_it=False):
    """K5 in both modes against its plain version, bin for bin, in `dtype`.
    Returns {mode: (counts, ms, plain_ms, max |kernel - plain|)}."""
    c1 = [c.to(dtype) for c in cols1]
    c2 = None if cols2 is None else [c.to(dtype) for c in cols2]
    e2 = np.asarray(edges, np.float64) ** 2
    thr = edges_f32(e2) if dtype == torch.float32 else e2
    out = {}
    for mode, nb2, aux in pair_modes():
        got = count_pairs_all(c1, c2, thr, nb2, mode, lbox, aux)
        again = count_pairs_all(c1, c2, thr, nb2, mode, lbox, aux)
        ref, t_plain = sync_seconds(lambda: count_pairs_all_plain(
            c1, c2, thr, nb2, mode, lbox, aux, max_pairs=1 << 24))
        bad = int((got != ref).sum())
        ms = event_ms(lambda: count_pairs_all(c1, c2, thr, nb2, mode, lbox, aux)) if time_it else None
        n2 = c1[0].numel() if c2 is None else c2[0].numel()
        print(f'{tag} {mode} {str(dtype).split(".")[1]}: {c1[0].numel()} x {n2} points, in-range '
              f'pairs {int(got.sum())}, bins that differ from plain {bad}, second launch equal '
              f'{bool(torch.equal(got, again))}, plain {t_plain * 1e3:.1f} ms'
              + (f', kernel {ms:.4f} ms' if time_it else ''))
        require(bad == 0, f'{tag} {mode}: K5 differs from its plain version in {bad} bins')
        require(bool(torch.equal(got, again)), f'{tag} {mode}: two K5 launches differ')
        require(int(got.sum()) > 0, f'{tag} {mode}: no pair in range')
        out[mode] = (got, ms, t_plain * 1e3, float((got - ref).abs().max()))
    return out


def phase_pair_kernels(dev):
    """K4 and K5 against their plain versions, exact equality of every bin,
    on clustered catalogs the plain versions can finish."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    # K4 in the 2000 Mpc/h box of the main path, auto and cross: on the grid
    # the dispatch takes for 2e5 points (66^3, a reach of 1) and on the finer
    # one it takes for the main path's dense tracers (133^3, a reach of 2
    # cells), items of two cells
    big = clustered_points(N_K4_CHECK, LBOX, gen, dev)
    other = clustered_points(N_K4_CHECK // 2, LBOX, gen, dev)
    check_k4('phase 3 K4 auto', big, None, LBOX, PAIR_BINS)
    check_k4('phase 3 K4 cross', big, other, LBOX, PAIR_BINS)
    nc = int(LBOX * 2 // PAIR_RMAX)
    check_k4('phase 3 K4 auto, cells of rmax/2', big, None, LBOX, PAIR_BINS, nc, 2)
    check_k4('phase 3 K4 cross, cells of rmax/2', big, other, LBOX, PAIR_BINS, nc, 2)
    # an rp edge list that starts at 0: the pair i == j would fall in bin (0, 0)
    edges0 = np.concatenate([[0.0], PAIR_BINS[1:]])
    check_k4('phase 3 K4 auto, edges from 0', big, None, LBOX, edges0)
    # dense cells cut into several items (400 Mpc/h, 13^3 cells), the same on
    # 26^3 cells, a clump of 6000 points in an almost empty box (cells far
    # over 64 points beside empty ones), and the per-pair round of a 4^3 grid
    # (125 Mpc/h)
    dense = clustered_points(N_K4_CHECK // 2, 400.0, gen, dev)
    dense2 = clustered_points(N_K4_CHECK // 4, 400.0, gen, dev)
    check_k4('phase 3 K4 dense auto', dense, None, 400.0, edges0, 13, 2)
    check_k4('phase 3 K4 dense cross', dense, dense2, 400.0, PAIR_BINS, 13, 2)
    check_k4('phase 3 K4 dense auto, cells of rmax/2', dense, None, 400.0, edges0, 26, 2)
    check_k4('phase 3 K4 dense cross, cells of rmax/2, items of 3 cells', dense, dense2, 400.0,
             PAIR_BINS, 26, 3)
    clump = [torch.remainder(torch.cat([
        200.0 + 3.0 * torch.randn(6_000, generator=gen, device=dev),
        400.0 * torch.rand(500, generator=gen, device=dev)]), 400.0) for _ in range(3)]
    check_k4('phase 3 K4 full cells beside empty ones', clump, None, 400.0, edges0, 26, 2)
    check_k4('phase 3 K4 full cells beside empty ones, cross', clump, dense2, 400.0, PAIR_BINS,
             26, 2)
    small = clustered_points(N_K5_CHECK, 125.0, gen, dev)
    check_k4('phase 3 K4 4^3 cells auto', small, None, 125.0, edges0, 4, 1)
    # 5 cells of 25 for a reach of 2 (2 reach + 1: every cell once, the
    # per-pair round); 4 cells of 31 for rp < 40 would visit a cell twice and
    # are refused
    check_k4('phase 3 K4 5^3 cells, reach 2', small, None, 125.0, edges0, 5, 1)
    st4 = stage_cells(*small, 125.0, 4, 1)
    try:
        count_pairs_cells(st4, None, edges_f32([0.0, 40.0**2]), PIMAX, 'rppi')
        require(False, 'a 4^3 grid with a reach of 2 cells was not refused')
    except ValueError as err:
        print(f'phase 3 K4 4^3 cells, reach 2: refused ({err})')
    # points on the faces: half the catalog within 20 Mpc/h of z = 0 or lbox,
    # items of 3 cells whose reach wraps; then positions exactly on cell edges
    # and on lbox itself
    face = [c.clone() for c in clustered_points(N_K5_CHECK * 2, 400.0, gen, dev)]
    face[2] = torch.where(face[2] < 200.0, face[2] * 0.1, 400.0 - (400.0 - face[2]) * 0.1)
    check_k4('phase 3 K4 items at the box faces', face, None, 400.0, edges0, 26, 3)
    check_k4('phase 3 K4 items at the box faces, cross', face, dense2, 400.0, PAIR_BINS, 26, 2)
    cell = 400.0 / 26
    edge = [torch.round(c / cell) * cell for c in clustered_points(N_K5_CHECK * 2, 400.0, gen, dev)]
    edge[0][:100] = 400.0
    edge[2][100:200] = 400.0
    check_k4('phase 3 K4 points on cell edges and on lbox', edge, None, 400.0, edges0, 26, 2)
    # K5, float32 and float64, auto and cross, on columns within one period
    # (the compare form of the round) and spread over several (the division),
    # and against K4 on one catalog
    cat = clustered_points(N_K5_CHECK, 400.0, gen, dev)
    cat2 = clustered_points(N_K5_CHECK // 2, 400.0, gen, dev)
    shift = [400.0 * torch.randint(-3, 4, (N_K5_CHECK,), generator=gen, device=dev).float()
             for _ in range(3)]
    far = [c + d for c, d in zip(cat, shift)]
    near = [c - 100.0 for c in cat]
    for dtype in (torch.float32, torch.float64):
        before = count_pairs_all.launches, count_pairs_all.launches_one_period
        check_k5('phase 3 K5 auto', cat, None, 400.0, edges0, dtype)
        check_k5('phase 3 K5 cross', cat, cat2, 400.0, PAIR_BINS, dtype)
        check_k5('phase 3 K5 cross, first set around 0', near, cat2, 400.0, PAIR_BINS, dtype)
        n_all, n_one = (count_pairs_all.launches - before[0],
                        count_pairs_all.launches_one_period - before[1])
        require(n_all == n_one == 12, f'K5 took the division on columns in one period: {n_one}')
        check_k5('phase 3 K5 auto, several periods', far, None, 400.0, edges0, dtype)
        check_k5('phase 3 K5 cross, several periods', far, cat2, 400.0, PAIR_BINS, dtype)
        require(count_pairs_all.launches_one_period - before[1] == n_one,
                'K5 took the compare form on columns over several periods')
    k5 = check_k5('phase 3 K5 auto', cat, None, 400.0, PAIR_BINS, torch.float32)
    k5far = check_k5('phase 3 K5 auto, several periods', far, None, 400.0, PAIR_BINS, torch.float32)
    k4 = check_k4('phase 3 K4 on K5\'s catalog', cat, None, 400.0, PAIR_BINS, 26, 2)
    for mode in k5:
        same = bool(torch.equal(k4[mode], k5[mode][0]))
        print(f'phase 3 K4 == K5 on {N_K5_CHECK} points, {mode}: {same}; K5 on the same points '
              f'moved by whole boxes: {int((k5far[mode][0] != k5[mode][0]).sum())} bins differ '
              f'(the differences round otherwise there)')
        require(same, f'K4 and K5 disagree ({mode})')


def pair_record(ms, plain_ms, bound, by, err=0.0, **extra):
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound, bound_by=by,
                library_ms=None, **extra)


def phase_pairs(hod, mock):
    """Phase 8: compute_xirppi / compute_wp / compute_multipole on the
    run_hod mock at full width, and the same on a sparse QSO sample.
    Returns ({path: launches}, {form: timing record})."""
    dev = hod.device
    paths, timing = {}, {}
    tracers = list(mock)
    counts = {tr: len(mock[tr]['x']) for tr in tracers}
    # the grid the dispatch takes for each pair (the sparser side decides)
    grids = {(a, b): tpcf.cell_grid(LBOX, PAIR_RMAX, min(counts[a], counts[b]))
             for i, a in enumerate(tracers) for b in tracers[i:]}
    n_stages = len({(tr, g) for pair, g in grids.items() for tr in pair})
    calls = {
        'compute_xirppi': (lambda m: hod.compute_xirppi(m, PAIR_BINS, PIMAX, PI_BIN),
                           {'pair_count_cells[rppi]': 6}),
        'compute_wp': (lambda m: hod.compute_wp(m, PAIR_BINS, PIMAX),
                       {'pair_count_cells[rppi]': 6}),
        'compute_multipole': (lambda m: hod.compute_multipole(m, PAIR_BINS, PIMAX, PAIR_BINS, NMU),
                              {'pair_count_cells[rppi]': 6, 'pair_count_cells[smu]': 6}),
    }
    # the mock held on the device: uploaded once, staged by the first call
    dmock, t_up = sync_seconds(lambda: {
        tr: dict(zip('xyz', position_columns((d['x'], d['y'], d['z']), dev)))
        for tr, d in mock.items()})
    print(f'phase 8 mock {counts}, box {LBOX}, rp and s < {PAIR_RMAX}, pimax {PIMAX}: (cells a '
          f'side, refinement) {({f"{a}_{b}": g for (a, b), g in grids.items()})}, {n_stages} '
          f'stages; upload of x, y, z {t_up:.3f} s')
    results = {}
    torch.cuda.reset_peak_memory_stats()
    for name, (fn, want) in calls.items():
        tpcf._stage_cache.clear()
        builds = stage_cells.builds
        reset_launches()
        res, t_cold = sync_seconds(lambda: fn(mock))
        launches = read_launches()
        paths[f'AbacusHOD.{name}'] = launches
        cold_builds = stage_cells.builds - builds
        fn(dmock)  # stages the device-held columns
        builds = stage_cells.builds
        res_w, t_warm = sync_seconds(lambda: fn(dmock))
        warm_builds = stage_cells.builds - builds
        print(f'phase 8 {name}: cold {t_cold:.3f} s host to host (upload, {cold_builds} stages, '
              f'count), warm {t_warm:.3f} s ({warm_builds} stages), launches '
              f'{({k: v for k, v in launches.items() if v})}')
        for form, n in want.items():
            require(launches[form] == n, f'{name}: {form} launched {launches[form]} times, not {n}')
        require(launches['pair_count_all[rppi]'] + launches['pair_count_all[smu]'] == 0,
                f'{name} took the all-pairs engine: {launches}')
        require(cold_builds == n_stages, f'{name}: {cold_builds} stages in the cold call')
        require(warm_builds == 0, f'{name}: {warm_builds} restages in the warm call')
        require(set(res) == {f'{a}_{b}' for a in tracers for b in tracers}, f'{name} keys')
        for key, v in res.items():
            require(np.isfinite(v).all(), f'{name} {key} not finite')
            require(np.array_equal(v, res_w[key]), f'{name} {key}: warm differs from cold')
            a, b = key.split('_')
            require(np.array_equal(v, res[f'{b}_{a}']), f'{name} {key} not symmetrised')
        results[name] = res
    peak = torch.cuda.max_memory_allocated()
    nrp = len(PAIR_BINS) - 1
    require(results['compute_xirppi']['LRG_LRG'].shape == (nrp, PIMAX // PI_BIN), 'xirppi shape')
    require(results['compute_multipole']['LRG_ELG'].shape == (3 * nrp,), 'multipole shape')
    print(f'phase 8 peak device memory {peak / 2**30:.3f} GiB (the HOD stages of phases 5 and 7 '
          f'included)')

    # wp = 2 sum_pi xi at pi_bin_size 1, and the auto walk against the cross walk
    t1 = tracers[0]
    p1 = tuple(dmock[t1][a] for a in 'xyz')
    xi1 = calc_xirppi_fast(rpbins=PAIR_BINS, pimax=PIMAX, pi_bin_size=1, lbox=LBOX, pos1=p1)
    wp = results['compute_wp'][f'{t1}_{t1}']
    rel = float(np.max(np.abs(wp - 2 * xi1.sum(axis=1)) / np.abs(wp)))
    auto = pair_counts_rppi(p1, PAIR_BINS, PIMAX, LBOX)
    clone = tuple(c.clone() for c in p1)
    cross, t_cross = sync_seconds(lambda: pair_counts_rppi(p1, PAIR_BINS, PIMAX, LBOX, pos2=clone))
    # (the first edge is above 0, so the clone's i == j pairs fall below every bin)
    same = bool(np.array_equal(auto, cross))
    print(f'phase 8 {t1}: wp vs 2 sum_pi xi(pi_bin_size=1) max rel {rel:.3e} (<= 1e-10); '
          f'14-offset doubled walk == 27-offset walk on a clone: {same} ({int(auto.sum())} '
          f'pairs; cross call {t_cross:.3f} s)')
    require(rel <= 1e-10, 'wp != 2 sum_pi xi')
    require(same, 'the auto walk and the cross walk on a clone differ')
    del clone

    # the stage alone, and K4 at every pair's shape against plain and bound
    big = max(tracers, key=counts.get)
    nc, refine = grids[(big, big)]
    cols = [torch.remainder(c, _f32(LBOX)) for c in (dmock[big][a] for a in 'xyz')]
    span = tpcf.default_span(nc, refine, counts[big])
    st, t_stage = sync_seconds(lambda: stage_cells(*cols, LBOX, nc, span))
    ms_stage = event_ms(lambda: stage_cells(*cols, LBOX, nc, span), reps=3)
    # the stage's bytes: the key pass (12 B read, 4 B written a point), the
    # sort's radix passes over an int32 key and an int64 index (as many passes
    # of 8 bits as the largest key has bytes, 12 B read and written each),
    # three gathers (8 B index, 4 B value read, 4 B written), the count of the
    # keys (4 B a point, 8 B a cell), its running sum and the starts (8 + 4 B
    # a cell)
    n_big, cells = counts[big], nc**3
    passes = -(-(cells - 1).bit_length() // 8)
    stage_bytes = n_big * (16 + passes * 24 + 3 * 16 + 4) + cells * 28
    stage_bound = stage_bytes / HBM_BYTES_PER_S * 1e3
    print(f'phase 8 stage of {big} ({n_big} points, {nc}^3 cells, items of {span} cells): '
          f'{t_stage:.3f} s host to host, {ms_stage:.4f} ms by events, bound {stage_bound:.4f} ms '
          f'by bytes, {passes} radix passes (share {stage_bound / ms_stage:.3f}); '
          f'{st.work.shape[0]} work items, largest '
          f'cell {st.max_occ}, mean {n_big / cells:.1f}')
    timing['stage_cells'] = dict(ms=ms_stage, bound_ms=stage_bound, bound_by='bytes',
                                 points=n_big, cells=cells, items=int(st.work.shape[0]))
    del st, cols
    thr = edges_f32(PAIR_BINS**2)

    def stage_of(tr, grid):
        return tpcf._get_stage(tuple(dmock[tr][a] for a in 'xyz'), LBOX, grid[0],
                               span=tpcf.default_span(*grid, counts[tr]))

    for mode, nb2, aux in pair_modes():
        shapes = []
        for (a, b), grid in grids.items():
            s1, s2 = stage_of(a, grid), (None if a == b else stage_of(b, grid))
            ms = event_ms(lambda: count_pairs_cells(s1, s2, thr, nb2, mode, aux), reps=3)
            got = count_pairs_cells(s1, s2, thr, nb2, mode, aux)
            ref, t_plain = sync_seconds(lambda: count_pairs_cells_plain(
                s1, s2, thr, nb2, mode, aux, max_pairs=1 << 24))
            bad = int((got != ref).sum())
            err = float((got - ref).abs().max())
            bound, by, coarse = k4_bound(s1, s2, mode, nrp * nb2)
            cand = candidate_pairs(s1, s2, thr, nb2, mode)
            inr = int(got.sum())
            print(f'K4 {mode} {a}_{b}: {ms:.4f} ms, {grid[0]}^3 cells, {s1.work.shape[0]} items, '
                  f'candidates {cand} ({cand / ms * 1e3:.4e}/s), in-range pairs {inr} '
                  f'({inr / ms * 1e3:.4e}/s, {inr / cand:.4f} of the candidates); bound '
                  f'{bound:.4f} ms by {by} for the {coarse} candidates of the '
                  f'{int(LBOX // PAIR_RMAX)}^3 grid\'s 27-cell walk (share {bound / ms:.3f}, '
                  f'{inr / coarse:.4f} of those in range); plain {t_plain * 1e3:.1f} ms, bins '
                  f'that differ {bad}')
            require(bad == 0, f'K4 {mode} {a}_{b} differs from its plain version')
            shapes.append(dict(pair=f'{a}_{b}', ms=ms, plain_ms=t_plain * 1e3, err=err,
                               bound_ms=bound, bound_by=by, candidates=cand,
                               coarse_candidates=coarse, in_range=inr, nc=grid[0],
                               items=int(s1.work.shape[0])))
        top = max(shapes, key=lambda r: r['coarse_candidates'])
        regs = PAIR_PTXAS.get(f'K4[{mode}, wrap, pairs, table]', (None,) * 3)
        timing[f'pair_count_cells[{mode}]'] = pair_record(
            top['ms'], top['plain_ms'], top['bound_ms'], top['bound_by'], top['err'],
            shape=top['pair'], total_ms=sum(r['ms'] for r in shapes),
            shapes=shapes, registers=regs[0], spill_stores=regs[1], spill_loads=regs[2])
        print(f'K4 {mode}: the six pairs sum to {sum(r["ms"] for r in shapes):.4f} ms')

    # a QSO sample at survey density: with coordinates outside [0, lbox)
    # (the mock's frame, and RSD past the faces) and under JAX's 100,000
    # points, the dispatch gives it to the all-pairs engine, as JAX's
    # default does; method='cell' counts it with the cell engine
    rng = np.random.default_rng(SEED)
    last = tracers[-1]
    pick = np.sort(rng.choice(counts[last], N_SPARSE, replace=False))
    sparse = {last: {a: mock[last][a][pick] for a in 'xyz'}}
    past = int(sum(((sparse[last][a] < 0) | (sparse[last][a] >= LBOX)).sum() for a in 'xyz'))
    engine, other = ('pair_count_all', 'pair_count_cells') if past else (
        'pair_count_cells', 'pair_count_all')
    reset_launches()
    (wp_s, mp_s), t_sparse = sync_seconds(lambda: (
        hod.compute_wp(sparse, PAIR_BINS, PIMAX),
        hod.compute_multipole(sparse, PAIR_BINS, PIMAX, PAIR_BINS, NMU)))
    launches = read_launches()
    paths[f'AbacusHOD.compute_wp + compute_multipole ({N_SPARSE} {last})'] = launches
    print(f'phase 8 sparse {last} ({N_SPARSE} points): compute_wp + compute_multipole '
          f'{t_sparse:.3f} s host to host, launches {({k: v for k, v in launches.items() if v})}')
    require(launches[f'{engine}[rppi]'] == 2 and launches[f'{engine}[smu]'] == 1,
            f'sparse sample ({past} coordinates outside [0, lbox)): {engine} launches {launches}')
    require(launches[f'{other}[rppi]'] + launches[f'{other}[smu]'] == 0,
            f'sparse sample took {other}: {launches}')
    key = f'{last}_{last}'
    require(np.isfinite(wp_s[key]).all() and np.isfinite(mp_s[key]).all(), 'sparse results')
    require(np.array_equal(mp_s[key][:nrp], wp_s[key]), 'sparse wp differs between the calls')
    cols = position_columns(tuple(sparse[last][a] for a in 'xyz'), dev)
    reset_launches()
    (dd_t, ds_t), t_tile = sync_seconds(lambda: (
        pair_counts_rppi(tuple(cols), PAIR_BINS, PIMAX, LBOX, method='tile'),
        tpcf.pair_counts_smu(tuple(cols), PAIR_BINS, NMU, LBOX, method='tile')))
    launches = read_launches()
    paths[f'pair_counts_rppi + pair_counts_smu, method=tile ({N_SPARSE} {last})'] = launches
    require(launches['pair_count_all[rppi]'] == 1 and launches['pair_count_all[smu]'] == 1,
            f'method=tile: K5 launches {launches}')
    require(dd_t.sum() > 0 and ds_t.sum() > 0, 'method=tile counted no pair')
    # the two engines on one catalog: wrapped into the box first, as the cell
    # engine wraps what it is given (the all-pairs engine takes positions as
    # they are, and a galaxy that RSD moved past a face differences otherwise)
    wrapped = tuple(torch.remainder(torch.remainder(c, _f32(LBOX)), _f32(LBOX)) for c in cols)
    same = bool(
        np.array_equal(pair_counts_rppi(wrapped, PAIR_BINS, PIMAX, LBOX, method='tile'),
                       pair_counts_rppi(wrapped, PAIR_BINS, PIMAX, LBOX))
        and np.array_equal(tpcf.pair_counts_smu(wrapped, PAIR_BINS, NMU, LBOX, method='tile'),
                           tpcf.pair_counts_smu(wrapped, PAIR_BINS, NMU, LBOX)))
    # as RSD left the sample: how far the cell engine lies from the all-pairs
    # engine (the default here) on positions past the faces, and what the
    # default's engine costs against the cell engine's, warm, host to host
    dd_c = pair_counts_rppi(tuple(cols), PAIR_BINS, PIMAX, LBOX, method='cell')
    ds_c = tpcf.pair_counts_smu(tuple(cols), PAIR_BINS, NMU, LBOX, method='cell')
    dd_d = pair_counts_rppi(tuple(cols), PAIR_BINS, PIMAX, LBOX)
    ds_d = tpcf.pair_counts_smu(tuple(cols), PAIR_BINS, NMU, LBOX)
    t_both = {}
    for meth in ('cell', None):
        t_both[meth] = min(sync_seconds(lambda: (
            pair_counts_rppi(tuple(cols), PAIR_BINS, PIMAX, LBOX, method=meth),
            tpcf.pair_counts_smu(tuple(cols), PAIR_BINS, NMU, LBOX, method=meth)))[1]
            for _ in range(3))
    print(f'phase 8 sparse {last}, method=tile: {t_tile:.3f} s for both counts, launches '
          f'{({k: v for k, v in launches.items() if v})}; on the wrapped columns the all-pairs '
          f'and the cell engine count alike: {same}; on the columns as they are ({past} '
          f'coordinates outside [0, lbox)) they differ in {int((dd_c != dd_t).sum())} of '
          f'{dd_t.size} (rp, pi) bins by {int(np.abs(dd_c - dd_t).sum())} of {int(dd_t.sum())} '
          f'pairs and in {int((ds_c != ds_t).sum())} of {ds_t.size} (s, mu) bins by '
          f'{int(np.abs(ds_c - ds_t).sum())} of {int(ds_t.sum())} pairs')
    print(f'phase 8 sparse {last}, the cost of following JAX\'s default: both counts warm, '
          f'host to host, least of 3: default ({engine}) {t_both[None]:.4f} s, method=cell '
          f'{t_both["cell"]:.4f} s')
    require(same, 'the all-pairs and the cell engine disagree on the wrapped sparse sample')
    if past:
        require(np.array_equal(dd_d, dd_t) and np.array_equal(ds_d, ds_t),
                'the default dispatch differs from the all-pairs engine past the faces')
    k5 = check_k5(f'K5 at the sparse {last} shape', cols, None, LBOX, PAIR_BINS, torch.float32,
                  time_it=True)
    for mode, (got, ms, plain_ms, err) in k5.items():
        bound, by = k5_bound(N_SPARSE, N_SPARSE, mode, got.numel(), torch.float32)
        print(f'K5 {mode}: {ms:.4f} ms, {N_SPARSE**2 / ms * 1e3:.4e} pairs/s, bound {bound:.4f} ms '
              f'by {by} (share {bound / ms:.3f})')
        regs = PAIR_PTXAS.get(f'K5[{mode}, f32, period, pairs, table]', (None,) * 3)
        timing[f'pair_count_all[{mode}]'] = pair_record(
            ms, plain_ms, bound, by, err, shape=f'{N_SPARSE} x {N_SPARSE}', registers=regs[0],
            spill_stores=regs[1], spill_loads=regs[2])
    tpcf._stage_cache.clear()
    return paths, timing


# ---------------------------------------------------------------------------
# phases 9-11: prepare_sim's engines
# ---------------------------------------------------------------------------


def torch_script(rel):
    """The script scripts/torch/<rel>.py, imported from its file as the
    module a user runs."""
    import importlib.util

    name = 'chip_smoke_script_' + rel.replace('/', '_')
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(__file__).resolve().parent / 'scripts' / 'torch' / f'{rel}.py')
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


# the ranks slab of scripts/torch/hod/bench_ranks.py (the JAX script's,
# draw for draw), its rank_fields_device arguments and its host loop
synth_slab = torch_script('hod/bench_ranks').synth_slab
rank_args = torch_script('hod/bench_ranks').rank_args
host_rank_loop = torch_script('hod/bench_ranks').host_rank_loop


def k6_inputs(args, dev):
    """K6's tensors for rank_fields_device's arguments: (x, y, z, query,
    work, pstart, pnum, seg) on `dev`."""
    ppos, _, submask, seg, _, ps, pn = args[:7]
    x, y, z = (torch.from_numpy(ppos[:, a].copy()).to(dev) for a in range(3))
    seg_d = torch.from_numpy(seg).to(dev)
    query, work = ranks_device.nn_work(seg_d, torch.from_numpy(submask).to(dev), len(ps))
    ps_d, pn_d = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (ps, pn))
    return x, y, z, query, work, ps_d, pn_d, seg_d


def k6_plain(inp):
    x, y, z, query, _, ps_d, pn_d, seg_d = inp
    return ranks_device.nn_within_halo_plain(x, y, z, query, ps_d, pn_d, seg_d)


def k6_bounds(args, chains=None, chain_share=None, counted_on=None):
    """K6's least times (ms) for rank_fields_device's arguments: every pair
    (each query against its halo's window) on the float64 chain, 8
    operations (K6_PAIR_OPS) at 34e12/s ('f64_ms'); or every pair through
    the float32 filter, 9 operations (K6_FILTER_OPS) at 67e12/s, and the
    float64 chains the walk takes ('filtered_ms'), `chains` as
    nn_within_halo_filtered_plain counts them, or `chain_share` of the
    pairs as counted on the slab `counted_on`; the bytes (x, y, z of every
    particle, each query's index and result) at 3.35 TB/s. The bound is the
    smaller operation bound, or the bytes where they take longer."""
    submask, seg, ps, pn = args[2], args[3], args[5], args[6]
    q = np.bincount(seg[submask & (seg >= 0)], minlength=len(ps))
    pairs = float((q * pn).sum())
    if chains is not None:
        source = 'counted on this slab'
    else:
        chains, source = chain_share * pairs, f'the share counted on {counted_on}'
    f64_ms = pairs * K6_PAIR_OPS / F64_OPS_PER_S * 1e3
    filtered_ms = (pairs * K6_FILTER_OPS / F32_OPS_PER_S
                   + chains * K6_PAIR_OPS / F64_OPS_PER_S) * 1e3
    t_ops = min(f64_ms, filtered_ms)
    t_bytes = (12 * len(seg) + 12 * float(q.sum())) / HBM_BYTES_PER_S * 1e3
    return dict(pairs=pairs, f64_ms=f64_ms, filtered_ms=filtered_ms, chain_share=chains / pairs,
                share_from=source, bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def k6_occupancy(work, pnum, small=64):
    """Busy threads of K6's blocks (queries over K6_QUERIES an item), over all
    items and over the items of halos of at most `small` particles."""
    w = work.long()
    nq = w[:, 2] - w[:, 1]
    real = nq > 0
    size = pnum.long()[w[:, 0]]

    def occ(m):
        return float(nq[m].sum()) / max(int(m.sum()) * ranks_device.K6_QUERIES, 1)

    return occ(real), occ(real & (size <= small))


def check_ranks_host(dev_ranks, host_ranks, args, dev):
    """The five fields against the host loop's, tie-aware: the same ranks a
    halo, and equal wherever the particle's key is shared by no other
    selected particle of its halo (numpy's argsort orders ties as it likes;
    float32 keys tie by chance in halos of thousands, mutual nearest
    neighbours tie always). Returns the number of tied keys of each field."""
    submask, seg = args[2], args[3]
    keys = list(ranks_device._host_rank_keys(*args[:2], *args[7:]))
    keys = [keys[0], keys[1], keys[3], keys[2]]  # ranks, ranksv, ranksp, ranksr
    keys.append(np.sqrt(ranks_device.nn_within_halo(*k6_inputs(args, dev)).cpu().numpy()))
    sel = np.flatnonzero(submask & (seg >= 0))
    n_tied = []
    for name, a, b, key in zip(('ranks', 'ranksv', 'ranksp', 'ranksr', 'ranksc'), dev_ranks,
                               host_ranks, keys):
        o = np.lexsort((key[sel], seg[sel]))
        s_seg, s_key = seg[sel][o], key[sel][o]
        same = (s_seg[1:] == s_seg[:-1]) & (s_key[1:] == s_key[:-1])
        tied = np.zeros(len(sel), bool)
        tied[1:] |= same
        tied[:-1] |= same
        untied = sel[o][~tied]
        bad = int((a[untied] != b[untied]).sum())
        require(bad == 0, f'{name}: {bad} untied ranks differ from the host loop')
        oa = np.lexsort((a[sel], seg[sel]))
        ob = np.lexsort((b[sel], seg[sel]))
        require(np.array_equal(a[sel][oa], b[sel][ob]),
                f'{name}: the rank multisets of a halo differ from the host loop')
        n_tied.append(int(tied.sum()))
    return n_tied


def menv_catalog(n, nclump, lc, seed):
    """Clumped halos for the Menv engine: nclump centres, each halo Gaussian
    (sigma MENV_SIGMA) about one, in the (LBOX)^3 box centred on 0 or, for a
    light cone, in an octant shell 500 to 1500 Mpc/h from the origin; masses
    from 10^10.8 to 10^15 Msun/h with dN/dM ~ M^-2 (mcut 1e11 keeps 63 %),
    r_inner the r98 of such a halo (1 Mpc/h at 10^14)."""
    rng = np.random.default_rng(seed)
    if lc:
        u = np.abs(rng.normal(size=(nclump, 3)))
        cen = u / np.linalg.norm(u, axis=1)[:, None] * rng.uniform(500, 1500, nclump)[:, None]
    else:
        cen = rng.random((nclump, 3)) * LBOX - LBOX / 2
    pos = cen[rng.integers(0, nclump, n)] + rng.normal(0, MENV_SIGMA, (n, 3))
    if not lc:
        pos = np.mod(pos + LBOX / 2, LBOX) - LBOX / 2
    lo, hi = 10.0**10.8, 1e15
    mass = 1.0 / (1.0 / lo - rng.random(n) * (1.0 / lo - 1.0 / hi))
    r_inner = (1.0 * (mass / 1e14) ** (1 / 3)).astype(np.float32)
    return dict(pos=pos.astype(np.float32), mass=mass, r_inner=r_inner, r_outer=MENV_ROUT,
                halo_lc=lc, Lbox=LBOX, mcut=1e11)


def k7_call(st, kw):
    lbox = kw['Lbox'] if st.periodic else 0.0
    return lambda: menv_device.menv_annulus(st, lbox, kw['r_outer'] ** 2)  # noqa: E731


def k7_candidates(st):
    """The halos in the 27 neighbour cells of every centre above mcut (the
    JAX package's cells: wrapped and deduplicated on a periodic axis,
    absent past an open face): the pairs the bound counts."""
    occ = torch.diff(st.starts.long())
    cells = st.cells.long()[:, st.query.long()]
    ncs = st.ncs
    total = 0.0
    for off in np.ndindex(3, 3, 3):
        nb, ok = [], torch.ones(cells.shape[1], dtype=torch.bool, device=cells.device)
        for a, d in enumerate(off):
            c, n = cells[a] + d - 1, ncs[a]
            if st.periodic:
                ok &= n >= 3 or (d == 1 if n == 1 else d >= 1)
                c = torch.remainder(c, n)
            else:
                ok &= (c >= 0) & (c < n)
            nb.append(c.clamp(0, n - 1))
        raw = (nb[0] * ncs[1] + nb[1]) * ncs[2] + nb[2]
        if st.ukeys is not None:
            slot = torch.searchsorted(st.ukeys, raw).clamp_max(st.ukeys.numel() - 1)
            ok &= st.ukeys[slot] == raw
            raw = slot
        total += float(torch.where(ok, occ[raw], 0).sum())
    return total


def k7_walk(st):
    """(the candidates K7's row walk visits: each item's centres times the
    length of its 27 ranges, summed; lane occupancy: the centres over the
    items' threads; the items)."""
    _, length, _ = menv_ranges(st)
    work = st.work.long()
    nq = work[:, 1] - work[:, 0]
    visits = float((nq * length.sum(1)).sum())
    return visits, float(nq.sum()) / max(work.shape[0] * menv_device.K7_CENTRES, 1), work.shape[0]


def k7_bound(cand, n):
    """The least time (ms) of K7's work: its candidates at 9 float64
    operations (K7_PAIR_OPS) at 34 TFLOP/s, or the bytes (x, y, z, m, r_in^2
    of every halo read and its Menv written) at 3.35 TB/s where those take
    longer."""
    t_ops = cand * K7_PAIR_OPS / F64_OPS_PER_S * 1e3
    t_bytes = 48 * n / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def check_k7(tag, kw, dev, centres=None):
    """K7 against its plain version on the catalog `kw` (all centres, or a
    sample of `centres` of them): rtol 1e-12 and the same zeros; two
    launches bit-equal. Prints K7's time, the bound's candidates, those the
    row walk visits, the bound, lane occupancy and items. Returns its
    record."""
    st = menv_device.stage_menv(kw['pos'], kw['mass'], kw['r_inner'], kw['r_outer'],
                                kw['halo_lc'], kw['Lbox'], dev, kw['mcut'])
    k7 = k7_call(st, kw)
    got = k7()
    sample = None
    if centres is not None:
        cand = st.query.long()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        sample = cand[torch.randperm(cand.numel(), generator=gen, device=dev)[:centres]]

    def plain():
        return menv_device.menv_annulus_plain(
            *st.cols, st.cells, st.ncs, st.periodic, kw['Lbox'] if st.periodic else 0.0,
            kw['r_outer'] ** 2, kw['mcut'], centres=sample)

    ref = plain()
    same = bool(torch.equal(got, k7()))
    torch.cuda.synchronize()
    got_c, ref_c = (got, ref) if sample is None else (got[sample], ref[sample])
    err = float((got_c - ref_c).abs().max())
    rel = float(((got_c - ref_c).abs() / ref_c.abs().clamp_min(1e-300)).max())
    zeros = bool(torch.equal(got_c == 0, ref_c == 0))
    ms = event_ms(k7, reps=3)
    plain_ms = event_ms(plain, reps=1)
    cand = k7_candidates(st)
    visits, occ, items = k7_walk(st)
    bound, by = k7_bound(cand, st.cols[0].numel())
    print(f'{tag}: K7 {ms:.4f} ms vs plain {plain_ms:.4f} ms ({got_c.numel()} centres held), '
          f'max|d| {err:.3e}, max rel {rel:.3e}, same zeros {zeros}, two launches equal {same}, '
          f'nonzero {int((got_c != 0).sum())}; bound {bound:.4f} ms by {by} ({cand:.4e} '
          f'candidates in the 27 cells), share {bound / ms:.3f}; the row walk visits '
          f'{visits:.4e} candidates; {items} items of at most {menv_device.K7_CENTRES} '
          f'centres, lane occupancy {occ:.3f}')
    require(zeros and bool(((got_c - ref_c).abs() <= 1e-12 * ref_c.abs()).all()),
            f'{tag}: K7 disagrees with its plain version (max rel {rel:.3e}, zeros {zeros})')
    require(same, f'{tag}: two K7 launches differ')
    rec = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound, bound_by=by,
               bound_share=bound / ms, candidates=cand, walk_candidates=visits,
               lane_occupancy=occ, items=items, centres=int(st.query.numel()))
    return rec


def phase_prep_kernels(dev):
    """Phase 9: K6 and K7 against their plain versions; the share of K6's
    pairs that reach its float64 chain, counted by the filtered plain
    mirror on the check slab. Returns that share."""
    t0 = time.perf_counter()
    slab = synth_slab(N_RANKS_CHECK)
    args = rank_args(slab)
    inp = k6_inputs(args, dev)
    got = ranks_device.nn_within_halo(*inp)
    ref = k6_plain(inp)
    q = inp[3].long()
    same = bool(torch.equal(got[q], ref[q]))
    ms = event_ms(lambda: ranks_device.nn_within_halo(*inp), 3)
    plain_ms = event_ms(lambda: k6_plain(inp), 1)
    x, y, z, query, _, ps_d, pn_d, seg_d = inp
    (mirror, chains), mirror_s = sync_seconds(
        lambda: ranks_device.nn_within_halo_filtered_plain(x, y, z, query, ps_d, pn_d, seg_d))
    mirror_same = bool(torch.equal(mirror[q], ref[q]))
    b = k6_bounds(args, chains=chains)
    print(f'phase 9 K6 vs plain: {slab[2]} particles in {len(slab[0])} halos (seed 17), '
          f'{q.numel()} queries, NN d^2 bit-equal {same}; K6 {ms:.4f} ms, plain {plain_ms:.4f} ms; '
          f'the filtered plain mirror ({mirror_s * 1e3:.1f} ms) bit-equal {mirror_same}, '
          f'{chains} float64 chains of {b["pairs"]:.4e} pairs (share {b["chain_share"]:.5f})')
    require(same, 'K6 and its plain version differ')
    require(mirror_same, "K6's filtered plain mirror and its plain version differ")
    for lc in (False, True):
        kw = menv_catalog(N_MENV_CHECK, N_MENV_CHECK // 100, lc, SEED + 3)
        check_k7(f'phase 9 K7 vs plain, {N_MENV_CHECK} clumped halos, '
                 f'{"light cone" if lc else "box"}', kw, dev)
    # an inner radius past the outer one, past the cell edge: the 27 cells
    # bound the sum, not the ball
    kw = menv_catalog(N_MENV_CHECK, N_MENV_CHECK // 100, False, SEED + 4)
    kw['r_inner'] = np.full(N_MENV_CHECK, 2.5 * MENV_ROUT, np.float32)
    check_k7(f'phase 9 K7 vs plain, {N_MENV_CHECK} clumped halos, box, r_inner '
             f'{2.5 * MENV_ROUT} > r_outer', kw, dev)
    print(f'phase 9 in {time.perf_counter() - t0:.1f} s')
    return b['chain_share']


def phase_ranks(dev, paths, timing, chain_share):
    """Phase 10 (a): rank_fields_device at the bench_ranks slab and ten times
    it, host to host (host keys, upload, K6, five sorts, download), K6 by
    CUDA events against both its bounds (the float64 one, and the filtered
    one: at the first size with the float64 chains that the filtered plain
    mirror counts there, at the second with their share of the first
    size's pairs), and on the items of halos of at most 64 particles alone
    and on the rest alone, peak memory; at the first size all five fields
    held to the host loop and K6 and the mirror to its plain version, at
    the second K6 to its plain version on sampled halos. The mirror runs
    the kernel's filter unfused in float32 (the kernel fuses two FMAs),
    with a threshold that may be an ulp higher, so its count estimates the
    kernel's chains. `chain_share` is phase 9's, printed beside."""
    recs = []
    share = mirror_s = None
    for n_target in N_RANKS:
        slab, t_syn = sync_seconds(lambda: synth_slab(n_target))
        args = rank_args(slab)
        n, nh = slab[2], len(slab[0])
        tag = f'rank_fields_device ({n} particles, {nh} halos)'
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with calls_of(ranks_device, 'seg_rank') as ranked:
            dev_ranks, t_cold = sync_seconds(lambda: ranks_device.rank_fields_device(*args))
        paths[tag] = dict(read_launches(), seg_rank=ranked[0])
        peak = torch.cuda.max_memory_allocated()
        require(paths[tag]['nn_within_halo'] == 1, f'{tag}: K6 launches {paths[tag]}')
        _, t_warm = sync_seconds(lambda: ranks_device.rank_fields_device(*args))
        inp = k6_inputs(args, dev)
        ms = event_ms(lambda: ranks_device.nn_within_halo(*inp), 3)
        mirror = None
        if share is None:
            (mirror, chains), mirror_s = sync_seconds(
                lambda: ranks_device.nn_within_halo_filtered_plain(*inp[:4], *inp[5:]))
            b = k6_bounds(args, chains=chains)
            share, first = b['chain_share'], f'the slab of {n} particles'
        else:
            b = k6_bounds(args, chain_share=share, counted_on=first)
        bound, by, pairs = b['bound_ms'], b['bound_by'], b['pairs']
        work = inp[4]
        small = inp[6].long()[work[:, 0].long()] <= 64
        split = {}
        for part, sub in (('small', work[small].contiguous()), ('rest', work[~small].contiguous())):
            split[part] = event_ms(lambda sub=sub: ranks_device.nn_within_halo(
                *inp[:4], sub, *inp[5:]), K6_SPLIT_REPS)
        occ, occ_small = k6_occupancy(inp[4], inp[6])
        rec = dict(shape=f'{n} particles, {nh} halos', ms=ms, bound_ms=bound, bound_by=by,
                   bound_share=bound / ms, pairs=pairs, f64_bound_ms=b['f64_ms'],
                   filtered_bound_ms=b['filtered_ms'], chain_share=b['chain_share'],
                   chain_share_from=b['share_from'], phase9_chain_share=chain_share,
                   small_halo_items_ms=split['small'], other_items_ms=split['rest'],
                   lane_occupancy=occ, lane_occupancy_small_halos=occ_small,
                   host_to_host_cold_s=t_cold, host_to_host_warm_s=t_warm, peak_bytes=peak)
        line = (f'phase 10 {tag}: host to host cold {t_cold:.3f} s, warm {t_warm:.3f} s '
                f'(slab built in {t_syn:.1f} s); K6 {ms:.4f} ms (items of halos of at most 64 '
                f'particles alone {split["small"]:.4f} ms, the rest alone {split["rest"]:.4f} '
                f'ms), bound {bound:.4f} ms by {by} ({pairs:.4e} pairs; float64 bound '
                f'{b["f64_ms"]:.4f} ms, filtered bound {b["filtered_ms"]:.4f} ms at a chain '
                f'share of {b["chain_share"]:.5f}, {b["share_from"]}; phase 9\'s '
                f'{chain_share:.5f}), share {bound / ms:.3f}; lane occupancy '
                f'{occ:.3f}, on halos of at most 64 particles {occ_small:.3f}; peak memory '
                f'{peak / 2**30:.3f} GiB')
        if n_target == N_RANKS[0]:
            got = ranks_device.nn_within_halo(*inp)
            ref = k6_plain(inp)
            q = inp[3].long()
            require(bool(torch.equal(got[q], ref[q])), f'{tag}: K6 and its plain version differ')
            require(bool(torch.equal(mirror[q], ref[q])),
                    f'{tag}: the filtered plain mirror and the plain version differ')
            line += f'; the filtered plain mirror ({mirror_s:.1f} s) bit-equal to the plain version'
            rec['plain_ms'] = event_ms(lambda: k6_plain(inp), 1)
            rec['max_abs_err'] = 0.0
            # seg_rank (two stable sorts, no kernel) on the NN key: bytes read
            # once (seg 4 B, sel 1 B, key 8 B) and the rank written (8 B)
            sel_d = torch.from_numpy(args[2]).to(dev)
            rec['seg_rank_ms'] = event_ms(lambda: ranks_device.seg_rank(inp[7], sel_d, got), 3)
            rec['seg_rank_bound_ms'] = 21 * n / HBM_BYTES_PER_S * 1e3
            line += (f'; seg_rank {rec["seg_rank_ms"]:.4f} ms (bound '
                     f'{rec["seg_rank_bound_ms"]:.4f} ms by bytes)')
            host, t_host = sync_seconds(lambda: host_rank_loop(slab))
            n_tied = check_ranks_host(dev_ranks, host, args, dev)
            line += (f'; plain K6 {rec["plain_ms"]:.1f} ms; host loop {t_host:.3f} s, all five '
                     f'fields equal (tied keys of each: {n_tied})')
            rec['host_loop_s'] = t_host
        else:
            # the plain version on a sample of the halos (its loop over
            # halos costs ~0.4 ms each)
            got = ranks_device.nn_within_halo(*inp)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            picked = torch.randperm(nh, generator=gen, device=dev)[:N_RANKS_SAMPLE]
            query, seg_d = inp[3], inp[7]
            sub = query[torch.isin(seg_d[query.long()], picked.to(seg_d.dtype))]
            ref = ranks_device.nn_within_halo_plain(*inp[:3], sub, *inp[5:])
            q = sub.long()
            require(bool(torch.equal(got[q], ref[q])),
                    f'{tag}: K6 and its plain version differ on sampled halos')
            line += (f'; K6 bit-equal to its plain version on {q.numel()} queries of '
                     f'{len(picked)} sampled halos')
        print(line)
        recs.append(rec)
    top = recs[0]
    timing['nn_within_halo'] = dict(
        ms=top['ms'], plain_ms=top['plain_ms'], max_abs_err=top['max_abs_err'],
        bound_ms=top['bound_ms'], bound_by=top['bound_by'], library_ms=None, shape=top['shape'],
        shapes=recs, f64_bound_ms=top['f64_bound_ms'], filtered_bound_ms=top['filtered_bound_ms'])


def phase_menv(dev, paths):
    """Phase 10 (b): do_menv_device on 2e6 clumped halos, box and light cone,
    host to host; K7 by CUDA events against its bound and, on sampled
    centres, against its plain version; both engines on a 5e5 subset.
    Returns K7's records, box first."""
    recs = []
    nthread = len(os.sched_getaffinity(0))
    for lc in (False, True):
        form = 'light cone' if lc else 'box'
        kw = menv_catalog(N_MENV, N_MENV_CLUMPS, lc, SEED + 5)
        tag = f'do_menv_device ({N_MENV} clumped halos, {form})'
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        menv, t_cold = sync_seconds(lambda: menv_device.do_menv_device(**kw))
        paths[tag] = read_launches()
        peak = torch.cuda.max_memory_allocated()
        require(paths[tag]['menv_annulus'] == 1, f'{tag}: K7 launches {paths[tag]}')
        require(np.isfinite(menv).all() and (menv != 0).mean() > 0.5, f'{tag}: Menv {menv[:5]}')
        _, t_warm = sync_seconds(lambda: menv_device.do_menv_device(**kw))
        rec = check_k7(f'phase 10 {tag}', kw, dev, centres=N_MENV_SAMPLE)
        sub = dict(kw, pos=kw['pos'][:N_MENV_HOST], mass=kw['mass'][:N_MENV_HOST],
                   r_inner=kw['r_inner'][:N_MENV_HOST])
        d_sub, t_dsub = sync_seconds(lambda: menv_device.do_menv_device(**sub))
        h_sub, t_hsub = sync_seconds(lambda: do_Menv_from_tree(**sub, nthread=nthread))
        rel = float(np.max(np.abs(d_sub - h_sub) / np.maximum(np.abs(h_sub), 1e-300)))
        zeros = bool(np.array_equal(d_sub == 0, h_sub == 0))
        print(f'phase 10 {tag}: host to host cold {t_cold:.3f} s, warm {t_warm:.3f} s; K7 '
              f'{rec["ms"]:.4f} ms, share {rec["bound_share"]:.3f} of its bound; peak memory '
              f'{peak / 2**30:.3f} GiB; {N_MENV_HOST} subset: device {t_dsub:.3f} s, host tree '
              f'({nthread} threads) {t_hsub:.3f} s, max rel {rel:.3e}, same zeros {zeros}')
        require(zeros and rel <= 1e-12, f'{tag}: the subset differs from the host tree')
        recs.append(dict(rec, shape=f'{N_MENV} halos, {form}', sampled_centres=N_MENV_SAMPLE,
                         plain_sample_ms=rec['plain_ms'], host_to_host_cold_s=t_cold,
                         host_to_host_warm_s=t_warm, peak_bytes=peak, subset_device_s=t_dsub,
                         subset_host_tree_s=t_hsub))
    return recs


def phase_shear(dev, paths):
    """Phase 10 (c): the shear field of 1e8 particles at N_dim 1000, R 2 through
    shearmark_from_positions (K1, the host Gaussian filter, get_shear), each
    step timed; then K1 at nmesh 1000 against the plain scatter. Returns
    (the shear field, K1's record)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    pos = torch.rand((N_SHEAR, 3), generator=gen, device=dev) * LBOX - LBOX / 2
    half = N_SHEAR // 2
    cen = torch.rand((N_SHEAR // 1000, 3), generator=gen, device=dev) * LBOX - LBOX / 2
    pick = torch.randint(0, cen.shape[0], (half,), generator=gen, device=dev)
    pos[:half] = cen[pick] + torch.randn((half, 3), generator=gen, device=dev) * 2.0
    del pick, cen
    steps = {}
    tag = f'shearmark_from_positions ({N_SHEAR} particles, {SHEAR_N}^3, R {SHEAR_R})'
    with timed_stages([(tgrid, 'tsc_parallel'), (tshear, 'smooth_density'),
                       (tshear, 'get_shear')], steps):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        shearmark, t_total = sync_seconds(
            lambda: prepare_sim.shearmark_from_positions(pos, SHEAR_N, SHEAR_R, LBOX))
        paths[tag] = read_launches()
        peak = torch.cuda.max_memory_allocated()
    require(paths[tag]['tsc_deposit_cells[tsc]'] == 1, f'{tag}: K1 launches {paths[tag]}')
    require(shearmark.shape == (SHEAR_N,) * 3 and shearmark.dtype == np.float32
            and bool(np.isfinite(shearmark).all()) and shearmark.max() > 0, 'shear field')
    dsmo = torch.randn((SHEAR_N,) * 3, generator=gen, device=dev)
    karr = np.fft.fftfreq(SHEAR_N, d=LBOX / (2 * np.pi * SHEAR_N)).astype(np.float32)
    karr = torch.from_numpy(karr).to(dev)
    shear_ms = event_ms(lambda: tshear.shear_grid(dsmo, karr, SHEAR_N), 1)
    del dsmo
    # one forward and six inverse FFTs, the invariant reading six components
    shear_bound, shear_bytes = fft_bound(SHEAR_N, 7, 6, 1)
    print(f'phase 10 {tag}: {t_total:.3f} s host to host: tsc_parallel (stage, K1, download) '
          f'{steps["tsc_parallel"]:.3f} s, host Gaussian filter {steps["smooth_density"]:.3f} s, '
          f'get_shear (upload, FFTs, download) {steps["get_shear"]:.3f} s; the shear of a grid '
          f'on the card {shear_ms:.1f} ms, bound {shear_bound:.4f} ms ({shear_bytes / 1e9:.2f} GB '
          f'at 3.35 TB/s), share {shear_bound / shear_ms:.3f}; peak memory '
          f'{peak / 2**30:.3f} GiB')
    cols = [pos[:, a].contiguous() for a in range(3)]
    del pos
    w = torch.ones_like(cols[0])
    (x, y, z, ws), plan = stage_bricks(cols + [w], SHEAR_N, LBOX)
    del cols, w
    _, _, _, rec = time_k1(f'shear field (phase 10), {SHEAR_N}^3, 1 launch, 1 grid',
                           [[(x, y, z, ws, plan)]], SHEAR_N, 'tsc')
    rec.pop('grid')
    rec.update(host_filter_s=steps['smooth_density'], get_shear_s=steps['get_shear'],
               tsc_parallel_s=steps['tsc_parallel'], shear_grid_ms=shear_ms,
               shear_grid_bound_ms=shear_bound, peak_bytes=peak)
    return shearmark, rec


def fft_bound(n, ffts, reads, writes):
    """The least time (ms) and bytes of a chain of `ffts` real FFTs of an
    n^3 grid (each reading its input and writing its output once: the n^3
    f32 grid and the n^2 (n/2 + 1) complex64 half spectrum) and elementwise
    passes reading `reads` and writing `writes` f32 grids, at 3.35 TB/s
    (the k-space factors folded into the FFTs' inputs)."""
    real, half = 4 * n**3, 8 * n * n * (n // 2 + 1)
    nbytes = ffts * (real + half) + (reads + writes) * real
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def slab_catalog(seed):
    """A box slab of N_SLAB_HALOS halos (N ~ N^-2 over [20, 1e5] particles of
    MPART) in 20,000 clumps of sigma 8 Mpc/h, with about N_SLAB_PARTS A
    particles (3.5 % of N) laid out halo by halo."""
    rng = np.random.default_rng(seed)
    n = N_SLAB_HALOS
    N = (1.0 / (1 / 20 - rng.random(n) * (1 / 20 - 1e-5))).astype(np.int64)
    cen = rng.random((N_MENV_CLUMPS, 3)) * LBOX - LBOX / 2
    pos = cen[rng.integers(0, N_MENV_CLUMPS, n)] + rng.normal(0, MENV_SIGMA, (n, 3))
    pos = (np.mod(pos + LBOX / 2, LBOX) - LBOX / 2).astype(np.float32)
    npout = np.round(N * 0.035).astype(np.int64)
    halos = {
        'N': N, 'x_L2com': pos, 'v_L2com': rng.normal(0, 300, (n, 3)).astype(np.float32),
        'r90_L2com': rng.uniform(0.1, 0.8, n).astype(np.float32),
        'r25_L2com': rng.uniform(0.03, 0.2, n).astype(np.float32),
        'r98_L2com': rng.uniform(0.3, 1.5, n).astype(np.float32),
        'npstartA': np.concatenate([[0], np.cumsum(npout)[:-1]]), 'npoutA': npout,
        'id': np.arange(n, dtype=np.int64) + 10**9,
        'sigmav3d_L2com': rng.uniform(50, 400, n).astype(np.float32),
    }
    owner = np.repeat(np.arange(n), npout)
    parts = {'pos': (pos[owner] + rng.normal(0, 0.3, (len(owner), 3))).astype(np.float32),
             'vel': rng.normal(0, 200, (len(owner), 3)).astype(np.float32)}
    return halos, parts


def phase_slab(paths, shearmark, dev):
    """Phase 11: prepare_slab_tables on a box slab with ranks, the env and the
    shear rank, with the device engines and with the 'host' engines: the
    same tables (ranksc tie-aware, Menv at rtol 1e-12)."""
    halos, parts = slab_catalog(SEED + 11)
    header = {'BoxSizeHMpc': LBOX, 'ParticleMassHMsun': MPART, 'H0': 100 * HUBBLE}
    kw = dict(i=0, MT=True, want_ranks=True, want_AB=True, want_shear=True, shearmark=shearmark,
              newseed=600, halo_lc=False)
    tag = (f'prepare_slab_tables ({N_SLAB_HALOS} halos, {len(parts["pos"])} particles, box, '
           'device engines)')
    reset_launches()
    menv_calls = []
    do_menv = menv_device.do_menv_device

    def recorded(pos, mass, **args):
        menv_calls.append(dict(args, pos=pos, mass=mass))
        return do_menv(pos, mass, **args)

    rank_calls = []
    ranks = ranks_device.rank_fields_device

    def recorded_ranks(*args, **kwargs):
        rank_calls.append(args)
        return ranks(*args, **kwargs)

    menv_device.do_menv_device = recorded
    ranks_device.rank_fields_device = recorded_ranks
    try:
        with calls_of(ranks_device, 'seg_rank') as ranked:
            dev_out, t_dev = sync_seconds(lambda: prepare_sim.prepare_slab_tables(
                halos, parts, header, **kw))
    finally:
        menv_device.do_menv_device = do_menv
        ranks_device.rank_fields_device = ranks
    paths[tag] = dict(read_launches(), seg_rank=ranked[0])
    require(paths[tag]['nn_within_halo'] == 1 and paths[tag]['menv_annulus'] == 1,
            f'{tag}: launches {paths[tag]}')
    # K6 on the arguments the slab handed the ranks engine
    ppos, _, submask, seg, _, ps, pn = rank_calls[0][:7]
    inp = k6_inputs((np.asarray(ppos, np.float32), None, np.asarray(submask, bool),
                     np.asarray(seg, np.int32), None, np.asarray(ps), np.asarray(pn)), dev)
    q = inp[3].long()
    nn_same = bool(torch.equal(ranks_device.nn_within_halo(*inp)[q], k6_plain(inp)[q]))
    require(nn_same, f'{tag}: K6 and its plain version differ')
    del rank_calls, inp
    host_out, t_host = sync_seconds(lambda: prepare_sim.prepare_slab_tables(
        halos, parts, header, ranks_engine='host', menv_engine='host', **kw))
    for part in ('halos', 'particles'):
        a, b = dev_out[part], host_out[part]
        require(list(a) == list(b), f'{part}: columns differ')
        for k in a:
            if k != 'ranksc':
                require(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
                        f'{part} {k} differs between the engines')
    pa, pb = dev_out['particles'], host_out['particles']
    oa = np.lexsort((pa['ranksc'], pa['halo_id']))
    ob = np.lexsort((pb['ranksc'], pb['halo_id']))
    require(np.array_equal(pa['ranksc'][oa], pb['ranksc'][ob]), 'ranksc multisets differ')
    same_c = float((pa['ranksc'] == pb['ranksc']).mean())
    ea, eb = dev_out['env']['Menv'], host_out['env']['Menv']
    rel = float(np.max(np.abs(ea - eb) / np.maximum(np.abs(eb), 1e-300)))
    require(np.array_equal(ea == 0, eb == 0) and rel <= 1e-12, f'env Menv rel {rel:.3e}')
    print(f'phase 11 {tag}: {t_dev:.3f} s host to host, with the host engines {t_host:.3f} s; '
          f'{len(dev_out["halos"]["id"])} halos and {len(pa["pos"])} particles kept, '
          f'{int((pa["ranks"] > -1).sum())} with ranks; every column equal, ranksc equal at '
          f'{same_c:.4f} of the particles and as multisets a halo; K6 bit-equal to its plain '
          f'version on {q.numel()} queries; Menv max rel {rel:.3e}, '
          f'{int((ea != 0).sum())} nonzero')
    # K7 on the catalog the slab's env engine handed it
    args = dict(menv_calls[0])
    args.pop('device', None)
    check_k7(f'phase 11 K7 on the slab\'s env catalog ({len(args["mass"])} halos)', args, dev,
             centres=N_MENV_SAMPLE)


# ---------------------------------------------------------------------------
# phases 12 and 13: the ZCV kernels and the ZCV cell
# ---------------------------------------------------------------------------

# the ZCV cell (the JAX package's zcv scale, docs/performance.md:56-112)
ZCV_SIM = 'AbacusSummit_base_c000_ph000'
ZCV_Z = 0.5
ZCV_NMESH = 512
ZCV_NTRACER = 10_000_000
K8_NMESH = (256, 512)
# f32 operations of one mode in K8 besides the bin search's compares: |k|
# (2), mu (1), L2 (4), L4 (7), dup (1), the weight rows (7); and its f64 adds
K8_F32_OPS = 22
K8_F64_OPS = 7
# f64 operations of a mode of K8's row plan: the seven weights times the
# row's multiplicity, and the seven sums
K8_PLAN_F64_OPS = 14
# K8's timing: rounds of launches by CUDA events, and the plan's builds
K8_REPS, K8_ROUNDS, K8_BUILDS = 200, 5, 3
K8_LIBRARY_CALL = ('torch.bincount(bin + row * (nkout + 1), weights=w, minlength=7 * (nkout + 1)) '
                   'over the whole mesh, on precomputed per-mode f64 weight rows')


def zcv_config(nmesh=ZCV_NMESH):
    """The ZCV cell's config: poles 0, 2, 4, one mu bin, nmesh / 2 k-bins to
    the Nyquist k, TSC, compensated, interlaced, RSD on, kcut = pi nmesh /
    Lbox / 2."""
    kmax = np.pi * nmesh / LBOX
    return {
        'sim_params': {'sim_name': ZCV_SIM, 'z_mock': ZCV_Z},
        'HOD_params': {'want_rsd': True},
        'zcv_params': {'nmesh': nmesh, 'kcut': kmax / 2, 'fields': list(ZCV_FIELDS)},
        'power_params': {'nbins_k': nmesh // 2, 'nbins_mu': 1, 'poles': [0, 2, 4],
                         'k_hMpc_max': kmax, 'logk': False, 'paste': 'TSC',
                         'compensated': True, 'interlaced': True, 'nmesh': nmesh},
    }


def k1m_bound(n, nfields, nmesh):
    """The least time (ms) of the multi-weight deposit at 3.35 TB/s: x, y, z
    and the nfields - 1 weight columns of every point read once (the first
    column is a unit weight), each of the nfields grids written once."""
    nbytes = n * 4 * (3 + nfields - 1) + 4 * nfields * nmesh**3
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def k8_bounds(nmesh, plan):
    """K8's least times (ms) for a row plan of an nmesh^3 mesh: 'full_ms', a
    walk of the whole mesh (every mode's bin search, 3 + log2 compares, and
    the in-bin modes' K8_F32_OPS - 3 f32 and K8_F64_OPS f64 operations,
    against the bytes of the k tables and edges), and 'plan_ms', the plan's
    in-bin modes (K8_F32_OPS f32 and K8_PLAN_F64_OPS f64 operations each)
    against the bytes of the plan's row tables (kxy2, multiplicity, izlo,
    izhi) and k tables, each read once, and the sums written; the longer
    time of each. The plan's items are this design's own, not the
    function's, and are not counted. Also the mesh's in-bin modes ('n_in')
    and the plan bound's kind."""
    nk = plan.nkout
    nmodes = nmesh * nmesh * (nmesh // 2 + 1)
    n_in = int(((plan.izhi - plan.izlo + 1).double() * plan.mult).sum())
    search = int(np.ceil(np.log2(nk + 2)))
    out_bytes = 8 * 7 * nk
    t32 = (nmodes * (3 + search) + n_in * (K8_F32_OPS - 3)) / F32_OPS_PER_S
    t64 = n_in * K8_F64_OPS / F64_OPS_PER_S
    tb = (4 * (2 * nmesh + nk + 1) + out_bytes) / HBM_BYTES_PER_S
    p_ops = max(plan.modes * K8_F32_OPS / F32_OPS_PER_S,
                plan.modes * K8_PLAN_F64_OPS / F64_OPS_PER_S)
    p_bytes = (20 * plan.kxy2.numel() + 8 * (nmesh // 2 + 1) + 4 * (nk + 1)
               + out_bytes) / HBM_BYTES_PER_S
    return dict(full_ms=max(t32, t64, tb) * 1e3, plan_ms=max(p_ops, p_bytes) * 1e3, n_in=n_in,
                bound_by='operations' if p_ops >= p_bytes else 'bytes')


def k8_blocks(plan):
    """K8's blocks that hold rows (chunks of a bin's prefix) and its grid."""
    per = tzw.K8_ITEM_ROWS
    busy = int(((plan.reach.long() + per - 1) // per).sum())
    return busy, plan.nkout * (-(-plan.kxy2.numel() // per))


def phase_zcv_kernels(dev):
    """Phase 12: K1's multi-weight gather on the 512^3 lattice (moved by up
    to half a cell) with a unit column and four weight columns: its time,
    bound and share, blocks/SM, registers and spills; within 1e-5 of
    max|grid| of the plain scatter once a column and of five single-column
    K1 launches on their own brick stage, bit-equal to its plain walk
    (gather_deposit_plain) and to a second launch; its one-column time
    beside K1's. K8 at nmesh 256 and 512 against its plain version (counts
    equal, other rows within 1e-6 of the bin's count), two launches
    bit-equal; its time as the spread of rounds of launches, its row
    plan's build, and the two together host to host. Returns the kernels
    line's records of both."""
    t0 = time.perf_counter()
    n, nf = ZCV_NMESH, 5
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    h = LBOX / n
    lat = torch.arange(n, device=dev, dtype=torch.float32) * h
    cols = []
    for ax in range(3):
        shape = [1, 1, 1]
        shape[ax] = n
        p = lat.view(shape).expand(n, n, n).reshape(-1)
        p = p + (torch.rand(n**3, generator=gen, device=dev) - 0.5) * h
        cols.append(torch.remainder(p, LBOX))
    ws = [None] + [torch.randn(n**3, generator=gen, device=dev) for _ in range(nf - 1)]
    ones = torch.ones(n**3, device=dev)
    plan, stage_s = sync_seconds(lambda: stage_gather(cols + ws[1:], n, LBOX))
    got = torch.empty((nf,) + (n,) * 3, device=dev)
    ms = event_ms(lambda: tsc_deposit_cells_multi(got, plan))
    unit_plan = stage_gather(cols, n, LBOX)
    one = torch.empty((1,) + (n,) * 3, device=dev)
    ms_one = event_ms(lambda: tsc_deposit_cells_multi(one, unit_plan))
    del one, unit_plan
    again = torch.empty_like(got)
    tsc_deposit_cells_multi(again, plan)
    repeat_equal = bool(torch.equal(got, again))
    walk, walk_s = sync_seconds(lambda: gather_deposit_plain(again, plan))
    walk_equal = bool(torch.equal(got, walk))
    del again, walk, plan
    # K1 once a column on its own brick stage: five launches, and the unit
    # column alone
    staged, bplan = stage_bricks(cols + ws[1:] + [ones], n, LBOX)
    single = torch.zeros_like(got)

    def k1s(nf=nf):
        single[:nf].zero_()
        for f in range(nf):
            tsc_deposit_cells(single[f], *staged[:3], staged[3 + f - 1] if f else staged[-1],
                              bplan, LBOX)

    single_ms = event_ms(k1s, 2)
    single_one_ms = event_ms(lambda: k1s(1), 3)
    k1s()
    del staged, bplan
    err_single = float((got - single).abs().max())
    plain = single
    del single

    def p1():
        plain.zero_()
        for f in range(nf):
            paint_3d_plain(plain[f], *cols, ones if ws[f] is None else ws[f], n, LBOX)

    _, plain_s = sync_seconds(p1)
    err = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    del plain
    bound, nbytes = k1m_bound(n**3, nf, n)
    bps = gather_blocks_per_sm(nf - 1, True)
    regs = GATHER_PTXAS.get((nf, True), (None, None, None))
    print(f'phase 12 K1 multi-weight gather, {n}^3 lattice, {nf} columns (one unit): {ms:.4f} ms '
          f'({bps} blocks/SM, ptxas {regs[0]} registers, spill stores {regs[1]} B, loads '
          f'{regs[2]} B); one column {ms_one:.4f} ms against one single-column K1 launch '
          f'{single_one_ms:.4f} ms; five single-column K1 launches {single_ms:.4f} ms; stage '
          f'{stage_s * 1e3:.1f} ms; bound {bound:.4f} ms ({nbytes / 1e9:.2f} GB at 3.35 TB/s), '
          f'share {bound / ms:.3f}; max|d| vs the plain scatter ({plain_s * 1e3:.1f} ms) '
          f'{err:.3e} ({err / scale:.3e} of max|grid|), vs the single launches {err_single:.3e}; '
          f'bit-equal to its plain walk ({walk_s * 1e3:.1f} ms) {walk_equal}, two launches '
          f'bit-equal {repeat_equal}')
    require(err <= 1e-5 * scale, f'K1 multi-weight disagrees with the plain scatter ({err:.3e})')
    require(err_single <= 1e-5 * scale, f'K1 multi-weight disagrees with single K1 ({err_single})')
    require(walk_equal, 'K1 multi-weight differs from its plain walk')
    require(repeat_equal, 'two K1 multi-weight launches differ')
    k1m_rec = dict(ms=ms, plain_ms=walk_s * 1e3, max_abs_err=0.0, bound_ms=bound,
                   bound_by='bytes', library_ms=None, shape=f'{n}^3 lattice, {nf} columns',
                   plain_shape='gather_deposit_plain, bit-equal', scatter_ms=plain_s * 1e3,
                   scatter_max_abs_err=err, scatter_max_rel_err=err / scale, one_column_ms=ms_one,
                   single_ms=single_ms, single_one_ms=single_one_ms,
                   single_max_abs_err=err_single, blocks_per_sm=bps, stage_ms=stage_s * 1e3,
                   registers=regs[0], spill_stores=regs[1], spill_loads=regs[2])
    del got, cols, ws, ones

    k8_recs = []
    for nm in K8_NMESH:
        kout = np.linspace(0.0, np.pi * nm / LBOX, nm // 2 + 1)
        nk = nm // 2
        kv, kz = (torch.from_numpy(a).to(dev) for a in tzw._mode_kgrids(nm, LBOX))
        edges = torch.from_numpy(tzw._f32_ge_edges(kout)).to(dev)
        builds = [sync_seconds(lambda: tzw.window_plan(kv, kz, edges, nk))
                  for _ in range(K8_BUILDS)]
        plan = builds[0][0]
        builds = [b[1] * 1e3 for b in builds]
        k8 = lambda: tzw.window_mode_sums(plan)  # noqa: E731
        runs8 = event_runs(k8, K8_REPS, K8_ROUNDS)
        ms8 = float(np.median(runs8))
        # the plan's build and K8 together, host to host, as a window call
        # pays them
        both = [sync_seconds(lambda: tzw.window_mode_sums(tzw.window_plan(kv, kz, edges, nk)))[1]
                * 1e3 for _ in range(K8_BUILDS)]
        a, b = k8(), k8()
        ref, p_s = sync_seconds(lambda: tzw.window_mode_sums_plain(kv, kz, edges, nk))
        same = bool(torch.equal(a, b))
        counts_equal = bool(torch.equal(a[0], ref[0]))
        rel = float(((a - ref).abs() / ref[0].clamp_min(1.0)).max())
        # the library call: one bincount of the whole mesh's precomputed rows
        knorm, rows = tzw._mode_rows(kv[:, None, None], kv[None, :, None], kz[None, None, :])
        idx = torch.searchsorted(edges, knorm.reshape(-1), right=True) - 1
        idx = torch.where((idx >= 0) & (idx < nk), idx, nk)
        segs = torch.cat([idx + r * (nk + 1) for r in range(len(rows))])
        wts = torch.cat([w.reshape(-1).double() for w in rows])
        del knorm, rows, idx
        lib_ms = event_ms(lambda: torch.bincount(segs, weights=wts, minlength=7 * (nk + 1)), 3)
        del segs, wts
        bd = k8_bounds(nm, plan)
        nmodes = nm * nm * (nm // 2 + 1)
        nrows = int(plan.kxy2.numel())
        r = dict(shape=f'nmesh {nm}, {nk} bins', ms=ms8, plain_ms=p_s * 1e3, library_ms=lib_ms,
                 max_rel_err=rel, max_abs_err=float((a - ref).abs().max()),
                 bound_ms=bd['plan_ms'], bound_by=bd['bound_by'], full_bound_ms=bd['full_ms'],
                 modes=nmodes, in_bin=bd['n_in'], plan_rows=nrows,
                 plan_distinct=nrows + int(plan.cut_mult.numel()), plan_modes=plan.modes,
                 k8_blocks=k8_blocks(plan), plan_build_ms=builds[0],
                 plan_build_runs_ms=builds, runs_ms=runs8, plan_and_kernel_ms=both,
                 repeat_equal=same)
        k8_recs.append(r)
        print(f'phase 12 K8 nmesh {nm} ({nmodes} modes, {bd["n_in"]} in {nk} bins; the plan: '
              f'{r["plan_distinct"]} distinct kx^2 + ky^2, {nrows} with a mode in a bin, '
              f'{plan.modes} modes; K8 blocks with rows {r["k8_blocks"][0]} of '
              f'{r["k8_blocks"][1]}; built in '
              f'{", ".join(f"{t:.3f}" for t in builds)} ms): {ms8:.4f} ms (median of '
              f'{K8_ROUNDS} rounds of {K8_REPS} launches, rounds {min(runs8):.4f}-'
              f'{max(runs8):.4f} ms); the plan and K8 together host to host '
              f'{", ".join(f"{t:.3f}" for t in both)} ms; plain {p_s * 1e3:.1f} ms; library '
              f'({K8_LIBRARY_CALL}) {lib_ms:.4f} ms; bound of the plan\'s modes '
              f'{bd["plan_ms"]:.4f} ms ({bd["bound_by"]}), share {bd["plan_ms"] / ms8:.3f}; '
              f'full-mesh bound {bd["full_ms"]:.4f} ms, share {bd["full_ms"] / ms8:.3f}; counts '
              f'equal {counts_equal}, max |d| / count {rel:.3e}, two launches equal {same}')
        require(counts_equal, f'K8 counts differ from the plain version at nmesh {nm}')
        require(rel <= 1e-6, f'K8 rows differ from the plain version at nmesh {nm}: {rel:.3e}')
        require(same, f'K8 is not deterministic at nmesh {nm}')
    top = k8_recs[-1]
    k8_rec = dict(ms=top['ms'], plain_ms=top['plain_ms'], max_abs_err=top['max_abs_err'],
                  bound_ms=top['bound_ms'], bound_by=top['bound_by'], library_ms=top['library_ms'],
                  library_call=K8_LIBRARY_CALL, shape=top['shape'], shapes=k8_recs,
                  full_bound_ms=top['full_bound_ms'], plan_build_ms=top['plan_build_ms'],
                  plan_and_kernel_ms=top['plan_and_kernel_ms'])
    print(f'phase 12 in {time.perf_counter() - t0:.1f} s')
    return k1m_rec, k8_rec


def gaussian_ic(nmesh, meta, gen, dev):
    """A Gaussian linear density at the initial redshift with the extract's
    CLASS P(k) (scaled from z = 1 by the growth table), fixed amplitudes
    and seeded phases, and its Zel'dovich displacement in units of the box
    (tests/test_zenbu_native.py:119-160, scripts/power/bench_advect512.py),
    built on the card. Returns (delta, (disp_x, disp_y, disp_z)), f32."""
    kf = 2 * np.pi / LBOX
    i = torch.arange(nmesh, device=dev, dtype=torch.float64)
    kv = torch.where(i < nmesh // 2, i, i - nmesh) * kf
    kz = torch.arange(nmesh // 2 + 1, device=dev, dtype=torch.float64) * kf
    ks = (kv[:, None, None], kv[None, :, None], kz[None, None, :])
    k2 = ks[0] ** 2 + ks[1] ** 2 + ks[2] ** 2
    gt = meta['GrowthTable']
    spec = meta['CLASS_power_spectrum']
    lk = torch.from_numpy(np.log(np.asarray(spec['k (h/Mpc)']))).to(dev)
    lp = torch.from_numpy(np.log(np.asarray(spec['P (Mpc/h)^3']))).to(dev)
    x = 0.5 * torch.log(k2.clamp_min(1e-30))
    j = torch.searchsorted(lk, x).clamp(1, lk.numel() - 1)
    t = (x - lk[j - 1]) / (lk[j] - lk[j - 1])
    pk = torch.exp(lp[j - 1] + t * (lp[j] - lp[j - 1])) * (gt[meta['InitialRedshift']] / gt[1.0]) ** 2
    pk[0, 0, 0] = 0.0
    amp = torch.sqrt(pk * nmesh**6 / LBOX**3)
    del pk, x, j, t
    wk = torch.fft.rfftn(torch.randn((nmesh,) * 3, generator=gen, device=dev))
    dk = (wk / wk.abs().clamp_min(1e-30)) * amp.float()
    del wk, amp
    shape = (nmesh,) * 3
    inv_k2 = torch.where(k2 > 0, 1.0 / k2.clamp_min(1e-30), 0.0).float()
    disp = tuple(torch.fft.irfftn(dk * (1j * ka.float() * inv_k2), s=shape) / LBOX for ka in ks)
    return torch.fft.irfftn(dk, s=shape), disp


class LatticeTracers:
    """The object apply_zcv re-populates from: its run_hod(want_rsd=False)
    returns the tracer at its real-space positions, as AbacusHOD.run_hod
    returns a mock."""

    lbox = LBOX
    tracers = {'LRG': {}}

    def __init__(self, real):
        self.real = real

    def run_hod(self, tracers, want_rsd=True, reseed=None, write_to_disk=False):
        require(not want_rsd and list(tracers) == ['LRG'], 'apply_zcv asked for another mock')
        return {'LRG': dict(self.real)}


def lattice_tracers(dens, disp, n, kcut, meta, gen, n_tracer):
    """Phase 13's tracer: Poisson draws of ~n_tracer points on the lattice
    with weight 1 + 2 delta(z) (delta filtered at kcut), each advected by
    the filtered displacement in RSD and in real space from the same draws.
    Returns ({want_rsd: {'x', 'y', 'z'}: box-centred numpy columns}, the
    count)."""
    dev = dens.device
    D, f_growth = zcv_cosmo.growth_from_meta(meta, ZCV_Z)
    dfilt = zcv_ic.gaussian_filter(dens, n, LBOX, kcut)
    lam = (1.0 + 2.0 * D * dfilt.reshape(-1)).clamp_min_(0.0)
    lam *= n_tracer / float(lam.sum())
    counts = torch.poisson(lam, generator=gen).long()
    del lam, dfilt
    pick = torch.repeat_interleave(torch.arange(n**3, device=dev), counts)
    del counts
    dfl = [zcv_ic.gaussian_filter(d, n, LBOX, kcut) for d in disp]
    mocks = {}
    for rsd in (True, False):
        pos = zcv_adv.advected_positions(dfl, LBOX, n, D, f_growth if rsd else 0.0)
        mocks[rsd] = {c: (p[pick] - LBOX / 2).cpu().numpy() for c, p in zip('xyz', pos)}
        del pos
    return mocks, int(pick.numel())


def phase_zcv(dev, paths, timing):
    """Phase 13: the ZCV cell at full width. A Gaussian IC at 512^3 in the
    (2000 Mpc/h)^3 box; zcv_products (the IC filter, get_fields, the
    advection and five field FFTs in RSD and real space, the 15 P_ij of
    each, the window on K8 and the ZA templates in a host process a
    core); then AbacusHOD-style apply_zcv on a tracer of
    ~1e7 points Poisson-sampled from the advected lattice with weight
    1 + 2 delta (its real-space counterpart from the same draws), which
    measures get_tracer_power twice and runs run_zcv. Every stage is timed
    host to host; the outputs must be finite and rho_tr_ZD >= 0.9 on the
    monopole's five lowest bins above the k = 0 bin."""
    t0 = time.perf_counter()
    n = ZCV_NMESH
    config = zcv_config(n)
    kcut = config['zcv_params']['kcut']
    meta = zcv_cosmo.get_meta(ZCV_SIM, redshift=ZCV_Z)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    (dens, disp), t_ic = sync_seconds(lambda: gaussian_ic(n, meta, gen, dev))
    mocks, n_tr = lattice_tracers(dens, disp, n, kcut, meta, gen, ZCV_NTRACER)

    steps = {}
    tag = f'zcv_products + apply_zcv ({n}^3, {n_tr} tracers)'
    with timed_stages([(zcv_pre, 'gaussian_filter'), (zcv_pre, 'get_fields'),
                       (zcv_pre, 'advected_field_ffts'), (zcv_pre, 'power_ij'),
                       (tzw, 'periodic_window_function'), (tzw, 'get_window_plan'),
                       (tzw, '_templates'), (zcv_apply, 'get_tracer_power'),
                       (zcv_apply, 'run_zcv')], steps):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        zcv, t_pre = sync_seconds(lambda: zcv_pre.zcv_products(
            dens, disp, LBOX, n, config, meta, filter_ic=True, engine='device', device=dev))
        out, t_apply = sync_seconds(lambda: zcv_apply.apply_zcv(
            LatticeTracers(mocks[False]), {'LRG': mocks[True]}, config, zcv))
        paths[tag] = read_launches()
        peak = torch.cuda.max_memory_allocated()
    launches = paths[tag]
    require(launches['tsc_deposit_cells_multi'] == 4, f'{tag}: multi-weight K1 {launches}')
    require(launches['window_mode_sums'] == 1, f'{tag}: K8 launches {launches}')
    require(launches['tsc_deposit_cells[tsc]'] == 4, f'{tag}: tracer K1 launches {launches}')
    require(launches['bin_pair_modes'] == 4, f'{tag}: K3 launches {launches}')
    for k, v in out.items():
        require(bool(np.isfinite(np.asarray(v, np.float64)).all()), f'{tag}: {k} is not finite')
    for d in (*zcv.pk_ij.values(), *zcv.tracer_spectra.values()):
        for k, v in d.items():
            require(bool(np.isfinite(np.asarray(v, np.float64)).all()), f'{tag}: {k} not finite')
    rho = np.asarray(out['rho_tr_ZD'])[0]
    require((rho[1:6] >= 0.9).all(), f'{tag}: rho_tr_ZD {rho[:8]} below 0.9 at low k')
    stages = {
        'IC (Gaussian field, displacement)': t_ic,
        'IC filter (4 fields)': steps['gaussian_filter'],
        'get_fields': steps['get_fields'],
        'advection + 5 field FFTs (RSD and real)': steps['advected_field_ffts'],
        '15 P_ij (RSD and real)': steps['power_ij'],
        'window (K8 and its row plan)': steps['periodic_window_function'],
        'of it the row plan': steps['get_window_plan'],
        f'templates (host, {len(os.sched_getaffinity(0))} cores)': steps['_templates'],
        'get_tracer_power x2': steps['get_tracer_power'],
        'run_zcv': steps['run_zcv'],
        'zcv_products': t_pre,
        'apply_zcv': t_apply,
    }
    print(f'phase 13 {tag}: ' + '; '.join(f'{k} {v:.3f} s' for k, v in stages.items())
          + f'; peak memory {peak / 2**30:.3f} GiB; launches {launches}')
    # get_fields: the forward FFT, six inverse for s_ij and one for nabla^2
    # delta; delta and delta^2 from delta, s^2 from six components. The IC
    # filter: a forward and an inverse FFT a field, four fields
    fields_bound, fields_bytes = fft_bound(n, 8, 7, 3)
    filter_bound, filter_bytes = fft_bound(n, 8, 0, 0)
    print(f'phase 13 bounds at 3.35 TB/s: get_fields {fields_bound:.4f} ms '
          f'({fields_bytes / 1e9:.2f} GB), share {fields_bound / 1e3 / steps["get_fields"]:.3f} '
          f'of its host-to-host time; the IC filter (4 fields) {filter_bound:.4f} ms '
          f'({filter_bytes / 1e9:.2f} GB), share '
          f'{filter_bound / 1e3 / steps["gaussian_filter"]:.3f}')
    print(f'phase 13 rho_tr_ZD (monopole, bins 0-7) {np.round(rho[:8], 4).tolist()}; bias '
          f'{np.round(np.asarray(out["bias"]), 4).tolist()}')
    # K3 at the 15 P_ij's shape, inside the chain
    ffts = list(zcv.field_ffts[True].values())
    W = get_W_compensated(LBOX, n, 'TSC', True)
    kbins, mubins = get_k_mu_edges(LBOX, np.pi * n / LBOX, n // 2, 1, False)
    dk = 2 * np.pi / LBOX
    plan = get_mode_bin_plan(n, ((kbins / dk) ** 2).astype(np.float32),
                             (mubins**2).astype(np.float32), (0, 2, 4), dev)
    pole_w = {p: plan.pole_w[p] for p in (2, 4)}
    args = (ffts, plan.seg, None, 1.0, plan.nk, pole_w, 1)
    k3_ms = event_ms(lambda: bin_pair_modes(*args), 3)
    k3_kernel = kernel_ms(lambda: bin_pair_modes(*args), reps=3)
    print(f'phase 13 K3 at the 15 P_ij ({n}^3, 5 fields, poles 0 2 4): wrapper {k3_ms:.4f} ms, '
          f'kernel-only {"not measured" if k3_kernel is None else f"{k3_kernel:.4f} ms"}')
    timing['bin_pair_modes[poles nmu=1]'].setdefault('shapes', []).append(
        dict(shape=f'15 P_ij at {n}^3, poles 0 2 4', ms=k3_ms, kernel_ms=k3_kernel))
    del ffts, W
    print(f'phase 13 in {time.perf_counter() - t0:.1f} s')
    # what phase 15 runs on: the products, the tracer in both spaces, the
    # k-level result and the IC
    return dict(zcv=zcv, mocks=mocks, out=out, dens=dens, config=config, meta=meta, n_tr=n_tr)


def write_ic(root, sim, dens, disp):
    """The IC as the chain's ``main`` reads it: ``ic_dens_N{n}.asdf``
    ('density') and ``ic_disp_N{n}.asdf`` ('displacements' in Mpc/h, n^3 x
    3, header BoxSize) under root/<sim>/. Returns (the IC as load_dens and
    load_disp give it back, bytes written)."""
    n = dens.shape[0]
    ic = Path(root) / sim
    ic.mkdir(parents=True)
    zcv_ic.compress_asdf(ic / f'ic_dens_N{n}.asdf', {'density': dens}, {'BoxSize': LBOX})
    d = torch.stack([c * LBOX for c in disp], -1)
    zcv_ic.compress_asdf(ic / f'ic_disp_N{n}.asdf', {'displacements': d}, {'BoxSize': LBOX})
    del d
    back = (zcv_ic.load_dens(root, sim, n), zcv_ic.load_disp(root, sim, n))
    return back, sum(f.stat().st_size for f in ic.iterdir())


# phase 18: the ZCV chain on files at 256^3
DISK_ZCV_NMESH = 256
DISK_ZCV_SEED = SEED + 18


def phase_zcv_disk(dev, paths, tpl13):
    """Phase 18: the ZCV chain through disk at 256^3, from a Gaussian IC of
    its own written as ic_dens / ic_disp files: ic_fields.main (the IC
    filter, get_fields), advect_fields.main in RSD and real space (the
    advection, five field FFTs by K1's multi-weight form, the 15 P_ij by
    K3, each written), zenbu_window.main (the window on K8),
    linear_fields.main; ZCVProducts.from_dir and LCVProducts.from_dir read
    the products back, held against the same IC's arrays computed in
    memory (the advected FFTs, P_ij, pk_lin); then AbacusHOD-style
    apply_zcv with zcv=None on ~1e7 tracers Poisson-sampled from the
    advected lattice (phase 13's sampling), cold and with
    load_presaved=True. Every step timed host to host. The cell takes
    phase 13's kcut (the Nyquist k of 256^3) and nmesh / 2 linear k bins
    to its Nyquist k: the first 128 of phase 13's, so its ZA templates are
    phase 13's first 128 columns (each k is computed alone), written into
    zcv_dir before zenbu_window.main, which skips existing files. Phase 13
    stays in memory at 512^3: through disk there it added 148.6 s (the
    first card run of this phase's design), over the 150 s the disk route
    was allowed to add with the rest of the script (PERF.md). tpl13:
    (phase 13's templates by want_rsd, its k_binc, its kcut). The files
    live in a temporary directory, removed at the end."""
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix='chip_smoke_zcv_'))
    try:
        zcv_disk_chain(dev, paths, tpl13, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f'phase 18 in {time.perf_counter() - t0:.1f} s')


def zcv_disk_chain(dev, paths, tpl13, root):
    n = DISK_ZCV_NMESH
    config = zcv_config(n)
    templates13, k_binc13, kcut = tpl13
    config['zcv_params']['kcut'] = kcut
    config['zcv_params'].update(zcv_dir=str(root / 'zcv'), ic_dir=str(root / 'ic'))
    config['lcv_params'] = {'nmesh': n, 'kcut': kcut, 'lcv_dir': str(root / 'zcv'),
                            'ic_dir': str(root / 'ic')}
    cfg = root / 'zcv.json'
    cfg.write_text(json.dumps(config))
    meta = zcv_cosmo.get_meta(ZCV_SIM, redshift=ZCV_Z)
    kb, _ = get_k_mu_edges(LBOX, np.pi * n / LBOX, n // 2, 1, False)
    k_binc = 0.5 * (kb[1:] + kb[:-1])
    require(np.array_equal(k_binc, k_binc13[:n // 2]), 'phase 18: k bins are not phase 13\'s')
    zz = root / 'zcv' / ZCV_SIM / f'z{ZCV_Z:.3f}'
    zz.mkdir(parents=True)
    for rsd, tab in templates13.items():
        np.savez(zz / f'zenbu_pk{"_rsd" if rsd else ""}_ij_lpt_nmesh{n}.npz',
                 pk_ij_zenbu=tab[..., :n // 2], k_binc=k_binc, kcut=kcut)
    gen = torch.Generator(device=dev)
    gen.manual_seed(DISK_ZCV_SEED)
    (dens, disp), t_ic = sync_seconds(lambda: gaussian_ic(n, meta, gen, dev))
    mocks, n_tr = lattice_tracers(dens, disp, n, kcut, meta, gen, ZCV_NTRACER)
    ((dens_np, disp_np), ic_bytes), t_icw = sync_seconds(lambda: write_ic(root / 'ic', ZCV_SIM,
                                                                         dens.cpu().numpy(),
                                                                         disp))
    del disp

    steps, calls, times = {}, {}, {}
    tag = f'ZCV chain from disk + apply_zcv ({n}^3, {n_tr} tracers)'
    with timed_stages([(zcv_ic, 'gaussian_filter'), (zcv_ic, 'get_fields'),
                       (zcv_adv, 'get_field_ffts'), (zcv_adv, 'power_ij'),
                       (tzw, 'periodic_window_function'), (tzw, 'get_window_plan'),
                       (zcv_apply, 'get_tracer_power'),
                       (zcv_apply, 'run_zcv'), (zcv_ic, 'compress_asdf'),
                       (zcv_adv, 'compress_asdf'), (zcv_lin, 'compress_asdf'),
                       (zcv_tp, 'compress_asdf'), (zcv_pre, 'read_fft'),
                       (zcv_pre, 'read_data'), (zcv_adv, 'read_fft')], steps, calls):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        # each main through its command line
        argv = ['--path2config', str(cfg), '--device', str(dev)]
        _, times['ic_fields._cli'] = sync_seconds(lambda: zcv_ic._cli(argv))
        _, times['advect_fields._cli --want_rsd (RSD, then real space)'] = sync_seconds(
            lambda: zcv_adv._cli(argv + ['--want_rsd']))
        # nmesh 256: the window's 'auto' engine is the device's (K8)
        _, times['zenbu_window._cli'] = sync_seconds(lambda: tzw._cli(argv))
        _, times['linear_fields._cli'] = sync_seconds(lambda: zcv_lin._cli(argv))
        written = sum(f.stat().st_size for f in (root / 'zcv').rglob('*') if f.is_file())
        read0 = steps.get('read_fft', 0.0) + steps.get('read_data', 0.0)
        zcv, times['ZCVProducts.from_dir'] = sync_seconds(
            lambda: zcv_pre.ZCVProducts.from_dir(str(cfg), device=dev))
        t_read = steps.get('read_fft', 0.0) + steps.get('read_data', 0.0) - read0
        lcv, times['LCVProducts.from_dir'] = sync_seconds(
            lambda: zcv_pre.LCVProducts.from_dir(str(cfg), device=dev))
        ball = LatticeTracers(mocks[False])
        ball.device = dev
        out, times['apply_zcv (cold, zcv=None)'] = sync_seconds(lambda: zcv_apply.apply_zcv(
            ball, {'LRG': mocks[True]}, copy.deepcopy(config)))
        paths[tag] = read_launches()
        peak = torch.cuda.max_memory_allocated()
    launches = paths[tag]
    # K1 multi-weight: two stages (interlaced) a space; K8: the window (the
    # LCV products read the same file: one k binning); K1: the tracer,
    # interlaced, in both spaces; K3: the P_ij of each space, pk_lin, the
    # tracer spectra of each space
    require(launches['tsc_deposit_cells_multi'] == 4, f'{tag}: multi-weight K1 {launches}')
    require(launches['window_mode_sums'] == 1, f'{tag}: K8 launches {launches}')
    require(launches['tsc_deposit_cells[tsc]'] == 4, f'{tag}: tracer K1 launches {launches}')
    require(launches['bin_pair_modes'] == 5, f'{tag}: K3 launches {launches}')
    again, times['apply_zcv (load_presaved=True)'] = sync_seconds(lambda: zcv_apply.apply_zcv(
        ball, {'LRG': mocks[True]}, copy.deepcopy(config), load_presaved=True))
    for k, v in out.items():
        require(bool(np.isfinite(np.asarray(v, np.float64)).all()), f'{tag}: {k} is not finite')
        require(np.array_equal(np.asarray(again[k]), np.asarray(v)),
                f'{tag}: load_presaved gives another {k}')
    for d in (*zcv.pk_ij.values(), *zcv.tracer_spectra.values()):
        for k, v in d.items():
            require(bool(np.isfinite(np.asarray(v, np.float64)).all()), f'{tag}: {k} not finite')
    rho = np.asarray(out['rho_tr_ZD'])[0]
    require((rho[1:6] >= 0.9).all(), f'{tag}: rho_tr_ZD {rho[:8]} below 0.9 at low k')

    # the same IC in memory: the filter, the fields, the advection and P_ij
    filt = zcv_ic.gaussian_filter(dens_np, n, LBOX, kcut, dev)
    dfl = [zcv_ic.gaussian_filter(d, n, LBOX, kcut, dev) for d in disp_np]
    fields = zcv_ic.get_fields(filt, LBOX, n, dev)
    worst_fft, worst_pk, bit_equal = 0.0, 0.0, True
    for rsd in (True, False):
        D, f = zcv_cosmo.growth_from_meta(meta, ZCV_Z, rsd)
        mem = zcv_adv.advected_field_ffts(dfl, fields, LBOX, n, D, f, config['power_params'], dev)
        for kn, F in mem.items():
            G = zcv.field_ffts[rsd][kn]
            bit_equal &= bool(torch.equal(F, G))
            worst_fft = max(worst_fft, float((F - G).abs().max() / F.abs().max()))
        pk = zcv_adv.power_ij(mem, LBOX, config['power_params'], D)
        del mem
        for k, v in pk.items():
            r, g = np.asarray(v), np.asarray(zcv.pk_ij[rsd][k])
            bit_equal &= bool(np.array_equal(r, g))
            if k.startswith('P_'):
                worst_pk = max(worst_pk, float(np.abs(g - r).max() / np.abs(r).max()))
            elif k.startswith('N_'):
                require(np.array_equal(r, g), f'{tag}: {k} mode counts differ from memory')
    pk_lin_mem, _ = zcv_lin.linear_fields(filt, LBOX, n, config['power_params'], dev)
    worst_lin = max(float(np.abs(np.asarray(lcv.pk_lin[k]) - np.asarray(v)).max()
                          / max(np.abs(np.asarray(v)).max(), 1e-300))
                    for k, v in pk_lin_mem.items() if k.startswith('P_'))
    del filt, dfl, fields, pk_lin_mem
    # the file round trip is exact: any difference is the device arithmetic
    # of two runs; held at 1e-6 of the largest mode / value
    require(worst_fft <= 1e-6 and worst_pk <= 1e-6 and worst_lin <= 1e-6,
            f'{tag}: products from disk differ from memory: FFTs {worst_fft:.3e}, P_ij '
            f'{worst_pk:.3e}, pk_lin {worst_lin:.3e}')
    stages = {
        'IC (Gaussian field, displacement)': t_ic,
        f'IC files written ({ic_bytes} bytes) and read back': t_icw,
        **times,
        'of the mains: IC filter (4 fields)': steps['gaussian_filter'],
        'get_fields': steps['get_fields'],
        'advection + 5 field FFTs (RSD and real)': steps['get_field_ffts'],
        '15 P_ij (RSD and real)': steps['power_ij'],
        'window (K8 and its row plan)': steps['periodic_window_function'],
        'of it the row plan': steps['get_window_plan'],
        f'writes ({calls["compress_asdf"]} files)': steps['compress_asdf'],
        'from_dir reads': t_read,
        'get_tracer_power x2': steps['get_tracer_power'],
        'run_zcv x2': steps['run_zcv'],
    }
    print(f'phase 18 {tag} [{CARD[0]}]: '
          + '; '.join(f'{k} {v:.3f} s' for k, v in stages.items())
          + f'; {written} bytes written under zcv_dir, read back at '
          f'{written / max(t_read, 1e-9) / 1e9:.3f} GB/s (the advected fields, P_ij, window, '
          f'templates); peak memory {peak / 2**30:.3f} GiB; launches {launches}')
    print(f'phase 18 products from disk against memory: the advected FFTs max|d|/max '
          f'{worst_fft:.3e}, P_ij {worst_pk:.3e}, pk_lin {worst_lin:.3e} (held at 1e-6), '
          f'bit-equal {bit_equal}; apply_zcv with load_presaved=True equal to the cold call')
    # get_fields: the forward FFT, six inverse for s_ij and one for nabla^2
    # delta; delta and delta^2 from delta, s^2 from six components. The IC
    # filter: a forward and an inverse FFT a field, four fields
    fields_bound, fields_bytes = fft_bound(n, 8, 7, 3)
    filter_bound, filter_bytes = fft_bound(n, 8, 0, 0)
    print(f'phase 18 bounds at 3.35 TB/s: get_fields {fields_bound:.4f} ms '
          f'({fields_bytes / 1e9:.2f} GB), share {fields_bound / 1e3 / steps["get_fields"]:.3f} '
          f'of its host-to-host time; the IC filter (4 fields) {filter_bound:.4f} ms '
          f'({filter_bytes / 1e9:.2f} GB), share '
          f'{filter_bound / 1e3 / steps["gaussian_filter"]:.3f}')
    print(f'phase 18 rho_tr_ZD (monopole, bins 0-7) {np.round(rho[:8], 4).tolist()}; bias '
          f'{np.round(np.asarray(out["bias"]), 4).tolist()}')
    del lcv, zcv, out, again


# phase 15: the field-level ZCV (apply_zcv_xi) and LCV on phase 13's cell, NFW
# satellites and the ECSV catalogs on phase 5's halos
LCV_R = 10.0  # reciso's smoothing scale, Mpc/h (tests/test_zcv.py:132)
N_NFW_DRAW = 1_000_000
# halos of the write_to_disk round trip: np.savetxt writes ~16 us a galaxy
# (8 columns), so the full catalog's ~2e7 galaxies would take minutes
N_NFW_WRITE = 100_000


XI_SHOW = [10, 20, 50, 100, 150]  # the r bins of xi_0 printed (bin i is [i, i + 1) Mpc/h)


def _rounded(a, digits=4):
    return [round(float(v), digits) for v in a]


def _within(got, ref, rtol, atol_frac):
    """|got - ref| <= rtol |ref| + atol_frac max|ref| everywhere, and the
    largest |got - ref| / |ref| (0 where ref is 0)."""
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.abs(g - r)
    ok = bool((d <= rtol * np.abs(r) + atol_frac * np.abs(r).max()).all())
    return ok, float(np.max(np.where(r != 0, d / np.abs(np.where(r != 0, r, 1)), 0)))


def _worst(got, ref, rtol, atol_frac, k_binc, poles):
    """The (pole, k) stack's element farthest outside rtol |ref| + atol_frac
    max|ref|, relative to that limit: its pole, k, reference value,
    difference and limit, and how many elements lie outside."""
    g = np.asarray(got, np.float64).reshape(len(poles), -1)
    r = np.asarray(ref, np.float64).reshape(len(poles), -1)
    d = np.abs(g - r)
    lim = rtol * np.abs(r) + atol_frac * np.abs(r).max()
    i, j = np.unravel_index(np.argmax(d / lim), d.shape)
    return (f'worst l={poles[i]} k={k_binc[j]:.5f} ref {r[i, j]:.6e} diff {d[i, j]:.3e} '
            f'limit {lim[i, j]:.3e}, {int((d > lim).sum())} of {d.size} outside')


def phase_cv_field(dev, cell, paths):
    """Phase 15 (a) and (b): AbacusHOD.apply_zcv_xi on phase 13's products and
    tracer (the same LatticeTracers ball and config, five fields), every
    stage timed host to host, rho_tr_ZD >= 0.9 on the monopole's bins 1-5,
    every xi finite, its measured poles equal to phase 13's k-level flow's;
    then the field flow (run_zcv_field on this call's tracer fields) against
    the k-level flow (run_zcv on phase 13's tracer spectra) on the same
    inputs with the fields 1cb and delta, at
    tests/test_zcv.py:test_zcv_field_vs_k_level's tolerances (the measured
    poles rtol 2e-4, the model and cross poles 2e-3, each + 1e-4 of the
    largest value; rho 5e-3 + 1e-3; mode counts equal; the bias rtol 1e-3
    but the shot noise, whose ratio between the flows is Lbox^3 within 1e-2;
    the reduced poles rtol 0.05 + 0.02 of the largest value). With all five
    fields the two models differ by design, in the JAX package too: the RSD
    combine_spectra of run_zcv takes the first ten templates, without
    nabla^2 delta, and the field model adds every pair's cube. Then
    lcv_products, get_recon_power of the same tracer, run_lcv and
    run_lcv_field with recsym and with reciso (R 10 Mpc/h), the two flows
    held to each other at test_lcv_field_vs_k_level's tolerances (bias rtol
    1e-3 and the above; the reduced poles, rtol 0.05 + 0.02 of the largest
    value, are printed, not held: on phase 13's cell at 64^3 the JAX
    package's two flows leave that band at the same 11 of 96 low-k elements
    as the port's). reciso's field flow smooths each mode by exp(-k^2 R^2 /
    2) at its own |k|, the k-level flow at the bin's centre, in the JAX
    package too: its model and cross poles are printed with their worst
    element, not held, and a second run_lcv_field with the smoothing taken
    at the bin centres (testing.smoothing_at_bin_centres, outside the launch
    count) is held to every tolerance above. Each part prints before it
    checks. The reduced cube keeps the model's k = 0 mode (the weighted
    fields' k = 0 mode is -1), as the JAX package's does, so xi_ell of
    apply_zcv_xi carries a constant offset."""
    t0 = time.perf_counter()
    zcv, mocks, config, meta = cell['zcv'], cell['mocks'], cell['config'], cell['meta']
    n = config['zcv_params']['nmesh']
    npairs = len(config['zcv_params']['fields']) * (len(config['zcv_params']['fields']) + 1) // 2
    steps = {}
    tag = f'AbacusHOD.apply_zcv_xi ({n}^3, {cell["n_tr"]} tracers)'
    with timed_stages([(zcv_apply, 'get_tracer_power'), (zcv_apply, 'run_zcv_field'),
                       (zcv_apply, 'pk_to_xi'), (zcv_tools, 'field_cube'),
                       (zcv_tools, '_project_monopole'), (zcv_tools, '_fit_zcv_bias'),
                       (zcv_tools, 'combine_field_spectra_k3D'),
                       (zcv_tools, 'combine_field_cross_spectra_k3D'),
                       (zcv_tools, '_field_reduce')], steps):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        xi, t_xi = sync_seconds(lambda: AbacusHOD.apply_zcv_xi(
            LatticeTracers(mocks[False]), {'LRG': mocks[True]}, config, zcv))
        paths[tag] = read_launches()
        peak = torch.cuda.max_memory_allocated()
    launches = paths[tag]
    stages = {
        'tracer FFTs (K1, RSD and real)': steps['get_tracer_power'],
        f'cubes Re(F_i F_j*) built ({1 + npairs} real-space, the RSD ones inside the model '
        'and cross)': steps['field_cube'],
        f'monopole projections ({1 + npairs}, K3)': steps['_project_monopole'],
        'bias fit': steps['_fit_zcv_bias'],
        'RSD model cube (f64)': steps['combine_field_spectra_k3D'],
        'RSD cross cube (f64)': steps['combine_field_cross_spectra_k3D'],
        '_field_reduce': steps['_field_reduce'],
        'run_zcv_field': steps['run_zcv_field'],
        'pk_to_xi x2': steps['pk_to_xi'],
        'apply_zcv_xi': t_xi,
    }
    rho = np.asarray(xi['rho_tr_ZD'])
    out = cell['out']
    ok5, d5 = _within(xi['Pk_tr_tr_ell'], out['Pk_tr_tr_ell'], 2e-4, 1e-4)
    _, dzz5 = _within(xi['Pk_ZD_ZD_ell'], out['Pk_ZD_ZD_ell'], 2e-3, 1e-4)
    print(f'phase 15 {tag}: ' + '; '.join(f'{k} {v:.3f} s' for k, v in stages.items())
          + f'; peak memory {peak / 2**30:.3f} GiB; launches {launches}')
    print(f'phase 15 apply_zcv_xi, five fields: bias {_rounded(xi["bias"], 5)} (phase 13, k '
          f'level: {_rounded(out["bias"], 5)}); rho_tr_ZD (monopole, bins 0-7) '
          f'{_rounded(rho[0][:8])}; measured poles against phase 13 max rel {d5:.3e}, the ZD '
          f'model {dzz5:.3e} (run_zcv\'s RSD model has no nabla^2 delta terms); xi_0 at r = '
          f'{XI_SHOW} Mpc/h: zcv {_rounded(np.asarray(xi["Xi_tr_tr_ell_zcv"])[0][XI_SHOW], 6)}, '
          f'raw {_rounded(np.asarray(xi["Xi_tr_tr_ell"])[0][XI_SHOW], 6)}')
    # K3: the real-space tracer and pair monopoles, _field_reduce's cross,
    # measured, model and reduced poles, and two pk_to_xi
    k3 = 1 + npairs + 4 + 2
    require(launches['tsc_deposit_cells[tsc]'] == 4, f'{tag}: tracer K1 launches {launches}')
    require(launches['bin_pair_modes'] == k3, f'{tag}: K3 launches {launches}, not {k3}')
    require(launches['tsc_deposit_cells_multi'] == 0 and launches['window_mode_sums'] == 0,
            f'{tag}: launches {launches}')
    for k in ('Xi_tr_tr_ell_zcv', 'Xi_tr_tr_ell', 'Pk_tr_tr_ell_zcv', 'rho_tr_ZD'):
        require(bool(np.isfinite(np.asarray(xi[k], np.float64)).all()), f'{tag}: {k} not finite')
    require(bool((rho[0][1:6] >= 0.9).all()), f'{tag}: rho_tr_ZD {rho[0][:8]} below 0.9 at low k')
    require(ok5, f'{tag}: measured poles differ from phase 13\'s beyond rtol 2e-4 ({d5:.3e})')
    del xi

    # the two flows on the same inputs, fields 1cb and delta
    cfg2 = copy.deepcopy(config)
    cfg2['zcv_params']['fields'] = ['1cb', 'delta']
    zk = zcv_tools.run_zcv(zcv.tracer_spectra[('', True)], zcv.pk_ij[True],
                           zcv.tracer_spectra[('', False)], zcv.pk_ij[False], cfg2,
                           window=zcv.window, keff=zcv.keff, pk_ij_zenbu=zcv.templates[True],
                           lbox=LBOX)
    zf = zcv_tools.run_zcv_field(zcv.tracer_ffts, zcv.field_ffts, cfg2,
                                 pk_ij_zenbu=zcv.templates[True], meta=meta)
    diffs, oks = {}, {}
    for key, rtol in (('Pk_tr_tr_ell', 2e-4), ('Pk_ZD_ZD_ell', 2e-3), ('Pk_tr_ZD_ell', 2e-3)):
        oks[key], diffs[key] = _within(zf[key], zk[key], rtol, 1e-4)
    rf, rk = np.asarray(zf['rho_tr_ZD']), np.asarray(zk['rho_tr_ZD'])
    bf, bk = np.asarray(zf['bias'], np.float64), np.asarray(zk['bias'], np.float64)
    ok_b = bool(np.allclose(bf[:-1], bk[:-1], rtol=1e-3, atol=1e-6))
    sn_ratio = float(bk[-1] / bf[-1])  # the k-level shot noise is in units of the volume
    ok_red, _ = _within(zf['Pk_tr_tr_ell_zcv'], zk['Pk_tr_tr_ell_zcv'], 0.05, 0.02)
    worst = {key: _worst(zf[key], zk[key], rtol, atol, zk['k_binc'], zk['poles'])
             for key, rtol, atol in (('Pk_ZD_ZD_ell', 2e-3, 1e-4), ('Pk_tr_ZD_ell', 2e-3, 1e-4),
                                     ('Pk_tr_tr_ell_zcv', 0.05, 0.02))}
    print(f'phase 15 run_zcv_field vs run_zcv (1cb, delta; same inputs): max rel {diffs}, rho '
          f'max |d| {np.abs(rf - rk).max():.3e}; bias field {bf.tolist()} k-level {bk.tolist()} '
          f'(shot-noise ratio / Lbox^3 {sn_ratio / LBOX**3:.6f}); {worst}')
    for key, rtol in (('Pk_tr_tr_ell', 2e-4), ('Pk_ZD_ZD_ell', 2e-3), ('Pk_tr_ZD_ell', 2e-3)):
        require(oks[key], f'phase 15: {key} of the field flow differs from the k-level flow '
                          f'beyond rtol {rtol} (max rel {diffs[key]:.3e})')
    require(ok_b, f'phase 15: bias of the field flow {bf} against the k-level flow {bk}')
    require(abs(sn_ratio / LBOX**3 - 1.0) <= 1e-2,
            f'phase 15: shot-noise ratio {sn_ratio:.6e} is not Lbox^3 within 1e-2')
    require(ok_red, f'phase 15: Pk_tr_tr_ell_zcv of the two flows: {worst["Pk_tr_tr_ell_zcv"]}')
    require(bool((np.abs(rf - rk) <= 5e-3 * np.abs(rk) + 1e-3).all()),
            f'phase 15: rho_tr_ZD of the two flows: {np.abs(rf - rk).max():.3e}')
    require(np.array_equal(np.asarray(zf['Nk_tr_tr_ell']), np.asarray(zk['Nk_tr_tr_ell']).ravel()),
            'phase 15: mode counts differ between the two flows')
    del zf, zk

    # (b) LCV on the same IC and tracer, the tracer shifted into [0, Lbox)
    lcfg = copy.deepcopy(config)
    lcfg['lcv_params'] = {'nmesh': n, 'kcut': config['zcv_params']['kcut']}
    lcfg['HOD_params'].update(rec_algo='recsym', smoothing=LCV_R)
    tag_l = f'lcv_products + get_recon_power + run_lcv_field ({n}^3, recsym and reciso)'
    steps_l = {}
    with timed_stages([(zcv_pre, 'linear_fields'), (zcv_pre, 'periodic_window_function'),
                       (tzw, 'get_window_plan'), (zcv_tools, '_fit_lcv_bias'),
                       (zcv_tools, '_field_reduce')], steps_l):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        lcv, t_prod = sync_seconds(lambda: zcv_pre.lcv_products(
            cell['dens'], LBOX, n, lcfg, meta, filter_ic=True, engine='device', device=dev))
        cols = tuple(torch.remainder(torch.from_numpy(mocks[True][c]).to(dev) + LBOX / 2, LBOX)
                     for c in 'xyz')
        tr_fft, t_paint = sync_seconds(lambda: zcv_tp.get_recon_power(
            cols, None, True, lcfg, meta=meta, save_3D_power=True))
        del cols
        spectra, t_spec = sync_seconds(lambda: zcv_tp.get_recon_power(
            None, None, True, lcfg, lcv.field_ffts, meta, tr_field_fft=tr_fft))
        flows = {}
        for rec in ('recsym', 'reciso'):
            c = copy.deepcopy(lcfg)
            c['HOD_params']['rec_algo'] = rec
            lk, t_k = sync_seconds(lambda: zcv_tools.run_lcv(
                spectra, lcv.pk_lin, c, window=lcv.window, keff=lcv.keff, meta=meta))
            lf, t_f = sync_seconds(lambda: zcv_tools.run_lcv_field(tr_fft, lcv.field_ffts, c,
                                                                   meta=meta))
            flows[rec] = (lk, lf, t_k, t_f)
        paths[tag_l] = read_launches()
        peak_l = torch.cuda.max_memory_allocated()
    launches = paths[tag_l]
    print(f'phase 15 {tag_l}: lcv_products {t_prod:.3f} s (linear fields and their spectra '
          f'{steps_l["linear_fields"]:.3f} s, window {steps_l["periodic_window_function"]:.3f} s, '
          f'of it the row plan {steps_l["get_window_plan"]:.3f} s); tracer field (K1) '
          f'{t_paint:.3f} s; tracer spectra (K3) {t_spec:.3f} s; bias fits '
          f'{steps_l["_fit_lcv_bias"]:.3f} s, _field_reduce x2 {steps_l["_field_reduce"]:.3f} s; '
          f'peak memory {peak_l / 2**30:.3f} GiB; launches {launches}')
    # reciso's field flow again, each mode smoothed at its bin's centre
    # (the k-level flow's arithmetic), outside the launch count
    c = copy.deepcopy(lcfg)
    c['HOD_params']['rec_algo'] = 'reciso'
    k_bins_l, _ = get_k_mu_edges(LBOX, np.pi * n / LBOX, n // 2, 1, False)
    exact_smoothing = zcv_tools.get_smoothing
    zcv_tools.get_smoothing = smoothing_at_bin_centres(k_bins_l)
    try:
        lf_c = zcv_tools.run_lcv_field(tr_fft, lcv.field_ffts, c, meta=meta)
    finally:
        zcv_tools.get_smoothing = exact_smoothing
    runs = [(rec, lk, lf, t_k, t_f) for rec, (lk, lf, t_k, t_f) in flows.items()]
    runs.append(('reciso, smoothed at the bin centres', flows['reciso'][0], lf_c, None, None))
    checks = []
    for rec, lk, lf, t_k, t_f in runs:
        held = rec != 'reciso'
        diffs, worst = {}, {}
        for key, rtol, atol in (('Pk_tr_tr_ell', 2e-4, 1e-4), ('Pk_lf_lf_ell', 2e-3, 1e-4),
                                ('Pk_tr_lf_ell', 2e-3, 1e-4), ('Pk_tr_tr_ell_lcv', 0.05, 0.02)):
            ok, diffs[key] = _within(lf[key], lk[key], rtol, atol)
            worst[key] = _worst(lf[key], lk[key], rtol, atol, lk['k_binc'], lk['poles'])
            # reciso's model and cross poles differ by design: the field
            # flow smooths mode by mode, the k-level flow at the bin centres.
            # The reduced poles leave the band at low k in the JAX package
            # too (the field flow expands beta and the template mode by
            # mode, the k-level flow windows the template): printed
            if key == 'Pk_tr_tr_ell' or (held and key != 'Pk_tr_tr_ell_lcv'):
                checks.append((ok, f'{tag_l} {rec}: {key} field vs k-level: {worst[key]}'))
        rf, rk = np.asarray(lf['rho_tr_lf']), np.asarray(lk['rho_tr_lf'])
        checks.append((bool((np.abs(rf - rk) <= 5e-3 * np.abs(rk) + 1e-3).all()),
                       f'{tag_l} {rec}: rho_tr_lf field vs k-level {np.abs(rf - rk).max():.3e}'))
        checks.append((abs(lf['bias'] - lk['bias']) <= 1e-3 * abs(lk['bias']),
                       f'{tag_l} {rec}: bias field {lf["bias"]} vs k-level {lk["bias"]}'))
        for k in ('Pk_tr_tr_ell_lcv', 'rho_tr_lf'):
            for d in (lk, lf):
                checks.append((bool(np.isfinite(np.asarray(d[k], np.float64)).all()),
                               f'{tag_l} {rec}: {k} not finite'))
        times = '' if t_k is None else f'run_lcv {t_k:.3f} s, run_lcv_field {t_f:.3f} s, '
        print(f'phase 15 LCV {rec}: {times}bias field {lf["bias"]:.5f} k-level {lk["bias"]:.5f}, '
              f'max rel {diffs}, rho_tr_lf (monopole, bins 0-7) field {_rounded(rf[0][:8])} '
              f'k-level {_rounded(rk[0][:8])}; {worst}')
    # K3: the linear pairs, the tracer spectra, and per flow the tracer and
    # three linear monopoles and _field_reduce's four projections
    require(launches['tsc_deposit_cells[tsc]'] == 2, f'{tag_l}: K1 launches {launches}')
    require(launches['bin_pair_modes'] == 2 + 2 * 8, f'{tag_l}: K3 launches {launches}')
    require(launches['window_mode_sums'] == 1, f'{tag_l}: K8 launches {launches}')
    for ok, msg in checks:
        require(ok, msg)
    print(f'phase 15 (a, b) in {time.perf_counter() - t0:.1f} s')


def phase_nfw(dev, halo5):
    """Phase 15 (c): run_hod(want_nfw=True) with LRG, ELG and QSO on phase
    5's 1e7 halos under z_type 'secondary' (no particles), with hc (r98 /
    r25, 2-12), hrvir (r98, 0.2 (M / 1e12 Msun/h)^(1/3) Mpc/h) and hsigma3d
    columns and an NFW_draw of 1e6 seeded host draws: each tracer's
    satellite count within 5 Poisson sigma of the sum of its halos' means,
    every satellite within its halo's hc hrvir of the centre (want_rsd off),
    then write_to_disk and gal_reader on the first N_NFW_WRITE halos, every
    column bit-equal and Ncent equal."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    hd = dict(halo5)
    nh = hd['hmass'].numel()
    hd['hc'] = 2.0 + 10.0 * torch.rand(nh, generator=gen, device=dev)
    hd['hrvir'] = 0.2 * (hd['hmass'] / 1e12) ** (1 / 3)
    hd['hsigma3d'] = 300.0 * (hd['hmass'] / 1e13) ** (1 / 3) * (
        0.8 + 0.4 * torch.rand(nh, generator=gen, device=dev))
    empty = {k: np.empty(0) for k in ('ppos', 'pvel', 'phvel', 'phmass', 'pweights', 'prandoms')}
    empty['pinds'] = np.empty(0, np.int64)
    params = {'z': 0.5, 'Lbox': LBOX, 'velz2kms': VELZ2KMS, 'origin': None, 'chunk': -1}
    draw = nfw_draw(N_NFW_DRAW, float(hd['hc'].max()), SEED + 15)
    hod = AbacusHOD(hd, empty, params, TRACERS, dev, z_type='secondary')
    mock, t_nfw = sync_seconds(lambda: hod.run_hod(want_rsd=False, want_nfw=True,
                                                   NFW_draw=draw))
    tp = tpop.prepare_tracer_params(TRACERS, params['z'])
    halo, _ = hod._flat_stage(particles=False)
    keep = tpop._cent_codes(halo, tpop._tensor_params(tp, WANT, dev), WANT).cpu().numpy()
    host = {k: hd[k].cpu().numpy() for k in ('hpos', 'hmass', 'hc', 'hrvir', 'hdeltac', 'hfenv',
                                             'hid')}
    require(np.array_equal(host['hid'], np.arange(nh)), 'phase 15: halo ids are not 0..N-1')
    counts = {}
    for t in WANT:
        td, nc = mock[t], mock[t]['Ncent']
        nsat = len(td['x']) - nc
        mean = float(nfw.sat_means(host, tp, t, keep).clip(0, None).sum())
        ids = td['id'][nc:]
        pos = np.stack([td[c][nc:] for c in 'xyz'], 1)
        r = np.sqrt(((pos - host['hpos'][ids]) ** 2).sum(1))
        bound = host['hc'][ids].astype(np.float64) * host['hrvir'][ids]
        inside = bool((r <= bound * (1 + 1e-9)).all())
        counts[t] = dict(centrals=nc, satellites=nsat, expected=round(mean, 1),
                         sigmas=round(float((nsat - mean) / np.sqrt(mean)), 3),
                         max_r_over_rvir=float((r / host['hrvir'][ids]).max()))
        require(abs(nsat - mean) <= 5 * np.sqrt(mean),
                f'phase 15 NFW {t}: {nsat} satellites, {mean:.1f} expected')
        require(inside, f'phase 15 NFW {t}: a satellite lies beyond hc hrvir of its halo')
        require(td['x'].dtype == np.float64 and td['id'].dtype == np.int64, f'phase 15 NFW {t}')
    print(f'phase 15 run_hod(want_nfw=True) on {nh} halos, secondary redshift, LRG + ELG + QSO: '
          f'{t_nfw:.3f} s host to host; {counts}')

    sub = {k: v[:N_NFW_WRITE] for k, v in hd.items()}
    with tempfile.TemporaryDirectory() as tmp:
        hod_w = AbacusHOD(sub, empty, params, TRACERS, dev, z_type='secondary',
                          mock_dir=os.path.join(tmp, 'AbacusSummit_base_c000_ph000', 'z0.500'))
        wmock, t_write = sync_seconds(lambda: hod_w.run_hod(want_nfw=True, NFW_draw=draw,
                                                            write_to_disk=True))
        back, t_read = sync_seconds(hod_w.gal_reader)
        rows = 0
        for t in WANT:
            tab, td = back[t], wmock[t]
            require(tab.meta['Ncent'] == td['Ncent'] and tab.meta['Gal_type'] == t,
                    f'phase 15 gal_reader {t}: meta {tab.meta}')
            require(tab.colnames == [k for k in td if k != 'Ncent'], f'phase 15 {t} columns')
            for k in tab.colnames:
                require(tab[k].dtype == td[k].dtype and np.array_equal(tab[k], td[k]),
                        f'phase 15 gal_reader {t}: column {k} differs')
            rows += len(tab)
    print(f'phase 15 write_to_disk + gal_reader on {N_NFW_WRITE} halos ({rows} galaxies): write '
          f'(with its run_hod) {t_write:.3f} s, read {t_read:.3f} s, every column bit-equal')
    print(f'phase 15 (c) in {time.perf_counter() - t0:.1f} s')


# phase 14: StagedPower at docs/hod.md's settings on phase 7's mock; pk_to_xi,
# project_3d_to_poles, bin_kppi, expand_poles_to_3d and get_smoothing at 512^3
PZ_STEPS = (-1.0, -0.5, 0.5, 1.0, 2.0)
SURFACE_NMESH = 512
XI_RBINS = np.linspace(0.0, 200.0, 201)  # apply_zcv_xi's r bins (models/zcv/apply.py)
POLE_NBINS_K = 256
KPPI_NK = 64
KPPI_NPI = 32
SMOOTH_R = 4.0
# f64 sums of up to ~10^5 positive f32 weights in another order: n eps is
# 2e-11, a random walk ~1e-14
K9_RTOL = 1e-11
KPPI_LIBRARY_CALL = ('torch.bincount(bk * npi + bpi, weights=dup * w, minlength=nk * npi + 1) on '
                     'the precomputed flat index and float64 weights of every mode')


def plain_bin_kmu(n1d, dk, edges, weights, poles):
    """bin_kmu's (k, mu) sums of one mu bin with the Legendre rows, from the
    plain pair binning (float64 bincounts) instead of K3: (binned_poles,
    Npoles), the pole means unscaled."""
    kzlen = n1d // 2 + 1
    w = weights[:, :, :kzlen].to(torch.float32)
    zero = torch.zeros_like(w)
    pair = [torch.complex(w, zero), torch.complex(torch.ones_like(w), zero)]
    plan = get_mode_bin_plan(n1d, ((np.asarray(edges) / dk) ** 2).astype(np.float32),
                             np.array([0.0, 1.0], np.float32), poles, w.device)
    pole_w = {p: plan.pole_w[p] for p in poles if p}
    sums, psums = bin_pair_modes_plain(pair, plan.seg, None, 1.0, plan.nk * plan.nmu, pole_w,
                                       plan.nmu)
    del pair, w, zero
    out = _bin_means(plan, dk, sums[1].cpu().numpy().reshape(plan.nk, 1),
                     psums[1].cpu().numpy(), poles)
    return out[2], out[3]


def check_spectrum(tag, got, ref, rtol, scale=None):
    """A staged spectrum against calc_power's: mode counts equal, P within
    rtol |P| (rtol `scale` for a cross spectrum, sqrt(P_ii P_jj)), each pole
    within rtol max|pole|, outside the bins that hold only the k = 0 mode.
    Returns the worst |d| / tolerance scale."""
    require(np.array_equal(got['N_mode'], ref['N_mode']), f'{tag}: mode counts')
    ok = (ref['N_mode'] > 0) & (ref['k_avg'] > 0)
    P = ref['power']
    den = np.abs(P) if scale is None else scale
    rel = float(np.max(np.abs(got['power'] - P)[ok] / np.maximum(den[ok], 1e-300)))
    pw = ref['poles']
    rel = max(rel, float(np.max(np.abs(got['poles'] - pw)) / np.abs(pw).max()))
    require(np.isfinite(got['power']).all() and np.isfinite(got['poles']).all(), f'{tag}: finite')
    require(rel <= rtol, f'{tag}: differs from calc_power by {rel:.3e} (> {rtol})')
    return rel


def phase_surface(mock, dev, paths, timing):
    """Phase 14: the rest of the power-spectrum surface on phase 7's run_hod
    mock (LRG + ELG + QSO, x, y, z, vz as host numpy).

    (a) StagedPower of all tracers at docs/hod.md's settings (550^3, 128
    k-bins to 0.5 h/Mpc, poles 0, 2, 4, compensated, not interlaced): the
    cold stage, one warm power(), then five pz overrides (z + s vz f_v) mod
    lbox, each against calc_power of the moved points at rtol 2e-4 and timed
    host to host beside it, with the overflow share of each call; a cross
    spectrum of two staged tracers; one interlaced stage. (b) pk_to_xi and
    project_3d_to_poles on |delta_k|^2 of the mock at 512^3 (apply_zcv_xi's
    r bins; 256 k-bins), against their plain versions. (c) bin_kppi at 512^3
    (64 k_perp and 32 pi bins to k_Nyq): K9 against its plain version,
    bound and one torch.bincount, also through a full real mesh's view.
    (d) expand_poles_to_3d and get_smoothing at 512^3."""
    t0 = time.perf_counter()
    fv = _f32(1.0 / VELZ2KMS)
    pos = tuple(np.concatenate([mock[tr][a] for tr in WANT]).astype(np.float32) for a in 'xyz')
    vz = np.concatenate([mock[tr]['vz'] for tr in WANT]).astype(np.float32)
    n = len(vz)
    nm = DOCS_NMESH
    kw = dict(kbins=DOCS_NBINS_K, k_max=DOCS_KMAX, poles=POLES)

    def calc(p, **extra):
        return calc_power(p, LBOX, DOCS_NBINS_K, None, DOCS_KMAX, nmesh=nm, poles=POLES,
                          device=dev, **{'interlaced': False, **extra})

    # (a) StagedPower
    staged, t_stage = sync_seconds(lambda: StagedPower(pos, LBOX, nmesh=nm, device=dev))
    staged.power(**kw)
    reset_launches()
    got, t_warm = sync_seconds(lambda: staged.power(**kw))
    launches = read_launches()
    paths[f'StagedPower.power ({nm}^3, warm)'] = launches
    require(launches['tsc_deposit_cells[tsc]'] == 1, f'staged K1 launches {launches}')
    require(launches['bin_pair_modes[poles nmu=1]'] == 1, f'staged K3 launches {launches}')
    ref, t_calc = sync_seconds(lambda: calc(pos))
    worst = check_spectrum('(a) warm', got, ref, 2e-4)
    over = int(staged.overflow)
    print(f'phase 14 (a) StagedPower {n} galaxies at {nm}^3: cold stage {t_stage:.3f} s, warm '
          f'power() {t_warm:.4f} s vs calc_power {t_calc:.4f} s host to host, overflow share '
          f'{over / n:.3e}, worst |d| vs calc_power {worst:.3e} (<= 2e-4)')
    launches = {}
    for s in PZ_STEPS:
        pz = np.mod(pos[2] + np.float32(s) * vz * np.float32(fv), np.float32(LBOX),
                    dtype=np.float32)
        reset_launches()
        got, t_s = sync_seconds(lambda: staged.power(**kw, pz=pz))
        launches = {k: launches.get(k, 0) + v for k, v in read_launches().items()}
        over = int(staged.overflow)
        ref, t_c = sync_seconds(lambda: calc((pos[0], pos[1], pz)))
        rel = check_spectrum(f'(a) pz s={s}', got, ref, 2e-4)
        print(f'phase 14 (a) pz = (z + {s} vz f_v) mod lbox: staged {t_s:.4f} s vs calc_power '
              f'{t_c:.4f} s host to host, overflow share {over / n:.3e}, worst |d| {rel:.3e}')
    paths[f'StagedPower.power ({nm}^3, {len(PZ_STEPS)} pz overrides)'] = launches
    require(launches['tsc_deposit_cells[tsc]'] == len(PZ_STEPS), f'pz K1 launches {launches}')
    del staged
    st = {}
    for tr in ('LRG', 'ELG'):
        cols = tuple(np.asarray(mock[tr][a], np.float32) for a in 'xyz')
        st[tr], t_c = sync_seconds(lambda: StagedPower(cols, LBOX, nmesh=nm, device=dev))
        print(f'phase 14 (a) stage {tr} ({len(cols[0])} galaxies) cold {t_c:.3f} s')
    autos = [st[tr].power(**kw)['power'] for tr in ('LRG', 'ELG')]
    reset_launches()
    got, t_x = sync_seconds(lambda: st['LRG'].power(**kw, cross=st['ELG']))
    paths['StagedPower.power (cross LRG x ELG)'] = read_launches()
    lrg, elg = ((mock[tr]['x'], mock[tr]['y'], mock[tr]['z']) for tr in ('LRG', 'ELG'))
    ref = calc(lrg, pos2=elg)
    rel_x = check_spectrum('(a) cross', got, ref, 2e-4, np.sqrt(np.abs(autos[0] * autos[1])))
    del st
    inter, t_si = sync_seconds(lambda: StagedPower(pos, LBOX, nmesh=nm, interlaced=True,
                                                   device=dev))
    inter.power(**kw)
    reset_launches()
    got, t_i = sync_seconds(lambda: inter.power(**kw))
    paths['StagedPower.power (interlaced)'] = read_launches()
    ref, t_ic = sync_seconds(lambda: calc(pos, interlaced=True))
    rel_i = check_spectrum('(a) interlaced', got, ref, 2e-4)
    print(f'phase 14 (a) cross LRG x ELG {t_x:.4f} s (worst |d| / sqrt(P_ii P_jj) {rel_x:.3e}); '
          f'interlaced: stage {t_si:.3f} s, power() {t_i:.4f} s vs calc_power {t_ic:.4f} s, '
          f'overflow share {int(inter.overflow) / (2 * n):.3e}, worst |d| {rel_i:.3e}')
    del inter

    # (b) pk_to_xi and project_3d_to_poles at 512^3
    N = SURFACE_NMESH
    F = get_field_fft(pos, LBOX, N, 'TSC', None, None, False, False, device=dev)
    # cuFFT lays the rfft mesh out with kz slowest; the cube in the C order
    # of the JAX package's arrays, which K9 reads along kz
    p3d = ((F.real**2 + F.imag**2) * _f32(LBOX**3)).contiguous()
    del F
    reset_launches()
    (r_binc, xi, n_xi), t_xi = sync_seconds(lambda: pk_to_xi(p3d, LBOX, XI_RBINS, POLES))
    paths[f'pk_to_xi ({N}^3)'] = read_launches()
    Xi = torch.fft.irfftn(p3d)
    pxi, pn = plain_bin_kmu(N, LBOX / N, XI_RBINS, Xi, POLES)
    pxi = pxi * N**3
    require(np.isfinite(xi).all() and np.array_equal(n_xi, pn), 'pk_to_xi finite, counts')
    err_xi = max(float(np.abs(xi[i] - pxi[i]).max() / np.abs(pxi[i]).max())
                 for i in range(len(POLES)))
    require(err_xi <= 1e-5, f'pk_to_xi differs from its plain version by {err_xi:.3e}')
    kedges = np.linspace(0.0, np.pi * N / LBOX, POLE_NBINS_K + 1)
    reset_launches()
    (poles3, n_p), t_pp = sync_seconds(lambda: project_3d_to_poles(kedges, p3d, LBOX, POLES))
    paths[f'project_3d_to_poles ({N}^3)'] = read_launches()
    pp, ppn = plain_bin_kmu(N, 2 * np.pi / LBOX, kedges, p3d, POLES)
    pp = pp * LBOX**3
    require(np.isfinite(poles3).all() and np.array_equal(n_p, ppn), 'poles finite, counts')
    err_p = max(float(np.abs(poles3[i] - pp[i]).max() / np.abs(pp[i]).max())
                for i in range(len(POLES)))
    require(err_p <= 1e-5, f'project_3d_to_poles differs from its plain version by {err_p:.3e}')
    print(f'phase 14 (b) at {N}^3: pk_to_xi ({len(XI_RBINS) - 1} r bins, poles {POLES}) '
          f'{t_xi:.4f} s, |d| vs plain {err_xi:.3e} of max|xi_l|; project_3d_to_poles '
          f'({POLE_NBINS_K} k bins) {t_pp:.4f} s, |d| vs plain {err_p:.3e} of max|P_l|')

    # (c) bin_kppi and K9 at 512^3
    knyq = np.pi * N / LBOX
    ke_k = np.linspace(0.0, knyq, KPPI_NK + 1)
    reset_launches()
    (mean, counts), t_kppi = sync_seconds(
        lambda: bin_kppi(N, LBOX, ke_k, knyq, KPPI_NPI, p3d))
    paths[f'bin_kppi ({N}^3)'] = read_launches()
    require(np.isfinite(mean).all(), 'bin_kppi finite')
    dk = 2 * np.pi / LBOX
    plan = get_kppi_plan(N, ((ke_k / dk) ** 2).astype(np.float32),
                         ((np.linspace(0.0, knyq, KPPI_NPI + 1) / dk) ** 2).astype(np.float32),
                         dev)
    got = bin_kppi_sums(p3d, plan)
    again = bin_kppi_sums(p3d, plan)
    ref = bin_kppi_sums_plain(p3d, plan)
    ones = bin_kppi_sums_plain(torch.ones_like(p3d), plan).cpu().numpy()
    counts_equal = bool(np.array_equal(plan.counts, ones.astype(np.int64)))
    same = bool(torch.equal(got, again))
    d = (got - ref).abs()
    err = float(d.max())
    rel = float((d / ref.abs().clamp_min(1e-300)).max())
    # a full real mesh (N, N, N), contiguous, whose first kzlen planes of
    # each row are the weights: K9 reads its [:, :, :kzlen] view in place
    full = torch.zeros((N, N, N), dtype=torch.float32, device=dev)
    view = full[:, :, : N // 2 + 1]
    view.copy_(p3d)
    strided_same = bool(torch.equal(bin_kppi_sums(view, plan), got))
    ms = event_ms(lambda: bin_kppi_sums(p3d, plan))
    ms_full = event_ms(lambda: bin_kppi_sums(view, plan))
    del full, view
    plain_ms = event_ms(lambda: bin_kppi_sums_plain(p3d, plan), reps=2)
    kzlen = N // 2 + 1
    rb, zb = plan.row_bin.long(), plan.z_bin.long()
    okm = (rb[:, None] >= 0) & (zb[None, :] >= 0)
    idx = torch.where(okm, rb[:, None] * plan.npi + zb[None, :], plan.nk * plan.npi).reshape(-1)
    kz = torch.arange(kzlen, device=dev)
    dup = torch.where((kz == 0) | (kz == plan.nyq), 1.0, 2.0).double()
    wd = (p3d.double() * dup).reshape(-1)
    lib_ms = event_ms(lambda: torch.bincount(idx, weights=wd, minlength=plan.nk * plan.npi + 1))
    del idx, wd, okm
    rows_in = int(plan.rows.numel())
    in_bytes = rows_in * plan.kzv * 4 + plan.nk * plan.npi * 8
    bound = in_bytes / HBM_BYTES_PER_S * 1e3
    full_bound = N * N * kzlen * 4 / HBM_BYTES_PER_S * 1e3
    print(f'phase 14 (c) bin_kppi at {N}^3 ({KPPI_NK} k_perp x {KPPI_NPI} pi bins to k_Nyq): '
          f'{t_kppi:.4f} s host to host; K9 {ms:.4f} ms (events), through the full real mesh\'s '
          f'view {ms_full:.4f} ms, plain {plain_ms:.4f} ms, library ({KPPI_LIBRARY_CALL}) '
          f'{lib_ms:.4f} ms; bound {bound:.4f} ms (the {rows_in} in-bin rows x {plan.kzv} kz, '
          f'share {bound / ms:.3f}; the whole mesh read once {full_bound:.4f} ms); counts equal '
          f'{counts_equal} (largest {int(plan.counts.max())}, 2^24 = {2**24}), max|d| {err:.3e} '
          f'(rel {rel:.3e} <= {K9_RTOL}), two launches bit-equal {same}, strided view equal '
          f'{strided_same}')
    require(counts_equal and np.array_equal(counts, plan.counts), 'K9 plan counts')
    require(rel <= K9_RTOL, f'K9 differs from its plain version by {rel:.3e}')
    require(same and strided_same, 'K9 is not deterministic or differs through a strided view')
    timing['bin_kppi_sums'] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound, bound_by='bytes',
        library_ms=lib_ms, library_call=KPPI_LIBRARY_CALL, total_ms=ms_full,
        shape=f'{N}^3 rfft mesh, {KPPI_NK} k_perp x {KPPI_NPI} pi bins to k_Nyq',
        registers=K9_PTXAS.get('K9 rows', (None,))[0])

    # (d) expand_poles_to_3d and get_smoothing at 512^3
    kc = 0.5 * (kedges[1:] + kedges[:-1])
    P3, t_exp = sync_seconds(lambda: expand_poles_to_3d(kc, poles3, N, LBOX, POLES, device=dev))
    require(bool(torch.isfinite(P3).all()) and P3.shape == (N, N, N // 2 + 1), 'expand finite')
    del P3
    S, t_sm = sync_seconds(lambda: get_smoothing(N, LBOX, SMOOTH_R, device=dev))
    require(bool(torch.isfinite(S).all()) and float(S.max()) == 1.0, 'get_smoothing')
    del S, p3d
    print(f'phase 14 (d) at {N}^3: expand_poles_to_3d {t_exp:.4f} s, get_smoothing (R '
          f'{SMOOTH_R}) {t_sm:.4f} s host to host, both finite')
    print(f'phase 14 in {time.perf_counter() - t0:.1f} s')


# ---------------------------------------------------------------------------
# phase 16: the disk path, CompaSO files -> prepare_sim -> staging -> P(k)
# ---------------------------------------------------------------------------

# 2 slabs of 1.25e6 halos (a base box has 34), 5 A particles a halo and
# 2.5e7 field particles (~10^10 a box): the cuts of PERF.md section 4
DISK_SLABS = 2
DISK_HALOS = N_HALO // 4
DISK_PARTS = N_PART // 4
DISK_FIELD = 25_000_000
DISK_SHEAR_N = SHEAR_N
DISK_SEED = SEED + 16
PID_KEYS = ('pid', 'lagr_pos', 'tagged', 'density', 'lagr_idx')  # unpack_pids' fields


def disk_config(root, name, subsample, nparallel=1):
    """The prepare_sim / AbacusHOD config of the phase's simulation: ranks,
    env and shear (DISK_SHEAR_N^3, R 2, every particle) on, the device
    engines, LRG + ELG + QSO with assembly bias."""
    return {
        'sim_params': {'sim_name': name, 'sim_dir': f'{root}/', 'subsample_dir':
                       f'{root}/{subsample}/', 'output_dir': f'{root}/mocks/', 'z_mock': 0.5,
                       'cleaned_halos': True},
        'HOD_params': {'tracer_flags': dict.fromkeys(WANT, True), 'want_ranks': True,
                       'want_AB': True, 'want_shear': True, 'shear_N': DISK_SHEAR_N,
                       'shear_R': 2, 'partdown': 1, 'want_rsd': True,
                       **{f'{t}_params': dict(TRACERS[t]) for t in WANT}},
        'prepare_sim': {'Nparallel_load': nparallel},
    }


def same_tables(got, ref, tag):
    """prepare_sim's tables, structured arrays or env dicts, under phase 11's
    rules: every column exact, ranksc tie-aware, Menv at rtol 1e-12 with the
    same zeros. Returns the share of particles whose ranksc is equal."""
    if isinstance(ref, dict) and 'Menv' in ref:
        for k in ('id', 'mass'):
            require(got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]),
                    f'{tag}: env {k} differs')
        rel = float(np.max(np.abs(got['Menv'] - ref['Menv'])
                           / np.maximum(np.abs(ref['Menv']), 1e-300), initial=0.0))
        require(np.array_equal(got['Menv'] == 0, ref['Menv'] == 0) and rel <= 1e-12,
                f'{tag}: env Menv rel {rel:.3e}')
        return 1.0
    names = ref.dtype.names if hasattr(ref, 'dtype') else list(ref)
    for k in names:
        if k != 'ranksc':
            require(got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]),
                    f'{tag}: {k} differs')
    if 'ranksc' not in names:
        return 1.0
    oa = np.lexsort((got['ranksc'], got['halo_id']))
    ob = np.lexsort((ref['ranksc'], ref['halo_id']))
    require(np.array_equal(got['ranksc'][oa], ref['ranksc'][ob]), f'{tag}: ranksc multisets')
    return float((got['ranksc'] == ref['ranksc']).mean())


def npz_tables(savedir, i):
    """Slab i's (halos, particles, env) as the port's prepare_sim wrote them."""
    fh, fp, fe = prepare_sim.slab_filenames(savedir, i, 600, True, True)
    with np.load(fh) as h, np.load(fp) as p, np.load(fe) as e:
        return h['halos'], p['particles'], {k: e[k] for k in ('id', 'mass', 'Menv')}


def check_disk_catalog(sim, groupdir, cleaned):
    """(a): CompaSOHaloCatalog of every slab against the arrays the phase
    wrote: the halo columns by the encodings' decode formulas exactly, the
    particles to the RVint quantum. Returns the read's seconds."""
    cat, t_read = sync_seconds(lambda: CompaSOHaloCatalog(
        groupdir, fields=prepare_sim.SLAB_FIELDS, subsamples=dict(A=True, rv=True),
        cleaned=cleaned))
    halos, parts = decoded_catalog(sim, range(DISK_SLABS), cleaned)
    for k in prepare_sim.SLAB_FIELDS:
        require(cat.halos[k].dtype == halos[k].dtype and np.array_equal(cat.halos[k], halos[k]),
                f'(a) cleaned={cleaned}: {k} differs from its decode formula')
    box, eps = sim['header']['BoxSize'], float(np.finfo(np.float32).eps)
    dpos = float(np.abs(cat.subsamples['pos'] - parts['pos_true']).max())
    dvel = float(np.abs(cat.subsamples['vel'] - parts['vel_true']).max())
    require(len(cat.subsamples) == len(parts['rvint'])
            and dpos <= RV_POS_QUANTUM * box + box / 2 * eps
            and dvel <= RV_VEL_QUANTUM / 2 + 6000 * eps,
            f'(a) cleaned={cleaned}: particles off by {dpos} Mpc/h, {dvel} km/s')
    print(f'phase 16 (a) CompaSOHaloCatalog cleaned={cleaned}: {len(cat.halos)} halos, '
          f'{len(cat.subsamples)} A particles in {t_read:.3f} s; every halo column equal to its '
          f'decode formula, particles within the RVint quantum (max |d| {dpos:.3e} Mpc/h, '
          f'{dvel:.3f} km/s)')
    return t_read


def phase_disk(dev, paths, root):
    """Phase 16: the disk path on the card, from files it writes itself under
    `root` (a temporary directory that main removes after phase 19, whose
    scripts read this tree). Returns the simulation's name, redshift
    directory and config."""
    t0 = time.perf_counter()
    tree = disk_path(dev, paths, root)
    print(f'phase 16 in {time.perf_counter() - t0:.1f} s')
    return tree


def disk_path(dev, paths, root):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim, t_gen = sync_seconds(lambda: synthetic_compaso(
        DISK_SLABS, DISK_HALOS, DISK_PARTS, DISK_FIELD, seed=DISK_SEED))
    info, t_write = sync_seconds(lambda: write_compaso_sim(root, sim))
    name, groupdir = sim['header']['SimName'], info['groupdir']
    n_halo = sum(len(s['halo_info']['N']) for s in sim['slabs'])
    n_part = sum(len(s['rv_A']) for s in sim['slabs'])
    print(f'phase 16 catalog ({name} header at z 0.5, {DISK_SLABS} slabs, {n_halo} halos, '
          f'{n_part} A particles, {DISK_FIELD} field particles, ~5 % of the halos merged): '
          f'drawn in {t_gen:.3f} s, written (blsc zstd, {len(info["files"])} files) in '
          f'{t_write:.3f} s, {info["raw_bytes"]} bytes raw, {info["disk_bytes"]} on disk '
          f'(ratio {info["disk_bytes"] / info["raw_bytes"]:.3f})')

    # blsc decode rate: every block of every file, the file bytes already read
    nbytes, t_dec = 0, 0.0
    for fn in info['files']:
        with open_asdf(fn) as af:
            t1 = time.perf_counter()
            for i in range(len(af._blocks)):
                nbytes += len(af._read_block(i))
            t_dec += time.perf_counter() - t1
    print(f'phase 16 blsc decode: {nbytes} bytes in {t_dec:.3f} s, {nbytes / t_dec / 1e9:.3f} '
          f'GB/s ({asdf_file._NTHREADS} threads, libzstd through ctypes)')

    # (a) the reader
    t_clean = check_disk_catalog(sim, groupdir, True)
    t_raw = check_disk_catalog(sim, groupdir, False)
    t_pids = check_disk_pids(sim, groupdir)
    t_all = check_all_fields(sim, groupdir)

    # (b) prepare_sim.main, serial, on the device engines, through its
    # command line
    cfg = disk_config(root, name, 'subsamples')
    cfg_fn = root / 'prepare_sim.json'
    cfg_fn.write_text(json.dumps(cfg))
    steps, calls = {}, {}
    tag = f'prepare_sim._cli (disk, {DISK_SLABS} slabs, serial)'
    reset_launches()
    with timed_stages([(prepare_sim, 'read_slab'), (prepare_sim, 'prepare_slab_tables'),
                       (prepare_sim, 'write_slab_tables'), (prepare_sim, 'calc_shearmark')],
                      steps, calls):
        with calls_of(ranks_device, 'seg_rank') as ranked:
            _, t_main = sync_seconds(lambda: prepare_sim._cli(
                ['--path2config', str(cfg_fn), '--device', str(dev)]))
    paths[tag] = dict(read_launches(), seg_rank=ranked[0])
    for k in ('nn_within_halo', 'menv_annulus', 'tsc_deposit_cells[tsc]'):
        require(paths[tag][k] > 0, f'{tag}: no {k} launch ({paths[tag]})')
    per = {k: steps[k] / calls[k] for k in ('read_slab', 'prepare_slab_tables',
                                            'write_slab_tables')}
    print(f'phase 16 (b) {tag}: {t_main:.3f} s host to host; calc_shearmark '
          f'({DISK_FIELD + n_part} particles at {DISK_SHEAR_N}^3) '
          f'{steps["calc_shearmark"]:.3f} s; per slab read '
          f'{per["read_slab"]:.3f} s, tables {per["prepare_slab_tables"]:.3f} s, write '
          f'{per["write_slab_tables"]:.3f} s; launches {paths[tag]}')

    savedir = f'{root}/subsamples/{name}/z0.500'
    shear_fn = f'{savedir}/shear_N{DISK_SHEAR_N}_R2_down1.npy'
    halos0, parts0 = decoded_catalog(sim, [0], True)
    parts0 = dict(zip(('pos', 'vel'), unpack_rvint(parts0['rvint'], sim['header']['BoxSize'])))
    alive = halos0['N'] > 0
    env = []
    for islab, keep in prepare_sim.env_pad_slabs(halos0['x_L2com'][alive, 0], 0, DISK_SLABS,
                                                 LBOX, 10):
        t = decoded_catalog(sim, [islab], True, particles=False)[0]
        t = {k: t[k][t['N'] > 0] for k in ('N', 'x_L2com', 'r98_L2com', 'id')}
        env.append({k: v[keep(t)] for k, v in t.items()})
    mem = prepare_sim.prepare_slab_tables(
        halos0, parts0, sim['header'], i=0, MT=True, want_ranks=True, want_AB=True,
        want_shear=True, shearmark=np.load(shear_fn), newseed=600, halo_lc=False,
        env_halos=env, cleaning=True, device=dev)
    disk = npz_tables(savedir, 0)
    same_tables(disk[0], mem['halos'], '(b) halos')
    same_c = same_tables(disk[1], mem['particles'], '(b) particles')
    same_tables(disk[2], mem['env'], '(b) env')
    menv_bits = bool(np.array_equal(disk[2]['Menv'], mem['env']['Menv']))
    print(f'phase 16 (b) slab 0 from disk equals prepare_slab_tables on the columns in memory '
          f'({len(disk[0])} halos, {len(disk[1])} particles kept; ranksc equal at {same_c:.4f}, '
          f'Menv bit-equal {menv_bits})')
    del mem, halos0, parts0, env

    # (c) the pool on slabs 0-1
    pooled = disk_config(root, name, 'pool', nparallel=2)
    pool_dir = f'{root}/pool/{name}/z0.500'
    os.makedirs(pool_dir)
    os.link(shear_fn, f'{pool_dir}/{os.path.basename(shear_fn)}')
    pooled_fn = root / 'prepare_sim_pool.json'
    pooled_fn.write_text(json.dumps(pooled))
    _, t_pool = sync_seconds(lambda: prepare_sim._cli(
        ['--path2config', str(pooled_fn), '--device', str(dev)]))
    for i in (0, 1):
        for g, r in zip(npz_tables(pool_dir, i), npz_tables(savedir, i)):
            same = (all(np.array_equal(g[k], r[k]) for k in r) if isinstance(r, dict)
                    else g.dtype == r.dtype and g.tobytes() == r.tobytes())
            require(same, f'(c) slab {i}: the pool\'s tables differ from the serial run\'s')
    print(f'phase 16 (c) _cli with Nparallel_load 2 (spawned workers on {dev}) on slabs 0-1: '
          f'{t_pool:.3f} s, tables bit-equal to the serial run')
    del sim

    # (d) staging and P(k)
    tag = 'AbacusHOD.from_config + run_hod_pk_fused (disk)'
    reset_launches()
    hod, t_stage = sync_seconds(lambda: AbacusHOD.from_config(
        cfg['sim_params'], cfg['HOD_params'], device=dev))

    def call(h):
        return h.run_hod_pk_fused(nmesh=NMESH, nbins_k=NBINS_K)

    (cl, n_gal), t_cold = sync_seconds(lambda: call(hod))
    best = min(sync_seconds(lambda: [call(hod) for _ in range(5)])[1] / 5 for _ in range(3))
    paths[tag] = read_launches()
    for k in ('tsc_deposit_cells[tsc]', 'bin_pair_modes[no poles]'):
        require(paths[tag][k] > 0, f'{tag}: no {k} launch ({paths[tag]})')
    flags = dict(want_ranks=True, want_shear=True, want_expvel=False, halo_lc=False,
                 z_type='primary')
    twin = staged_state_from_numpy(hod.halo_data, hod.particle_data, hod.params, hod.tracers,
                                   flags, dev)
    cl2, n_gal2 = call(twin)
    require(n_gal2 == n_gal and all(v > 0 for v in n_gal.values()), f'(d) n_gal {n_gal}')
    worst, bit_equal = 0.0, True
    for t1 in WANT:
        for t2 in WANT:
            a, b = cl[f'{t1}_{t2}'], cl2[f'{t1}_{t2}']
            require(np.isfinite(a).all(), f'(d) {t1}_{t2} not finite')
            scale = np.sqrt(np.abs(cl2[f'{t1}_{t1}'] * cl2[f'{t2}_{t2}']))
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(scale, 1e-300))))
            bit_equal &= bool(np.array_equal(a, b))
    require(worst <= 1e-4, f'(d) run_hod_pk_fused differs from the staged twin by {worst:.3e}')
    peak = torch.cuda.max_memory_allocated()
    print(f'phase 16 (d) {tag}: staging {t_stage:.3f} s ({len(hod.halo_data["hid"])} halos, '
          f'{len(hod.particle_data["pinds"])} particles), run_hod_pk_fused cold {t_cold:.3f} s, '
          f'warm {best:.6f} s (best mean of 3x5), n_gal {n_gal}; against the same call on '
          f'staged_state_from_numpy of those tables: bit-equal {bit_equal}, max |d|/scale '
          f'{worst:.3e}; launches {paths[tag]}; phase peak device memory {peak / 2**30:.3f} GiB')
    print(f'phase 16 reads: cleaned catalog {t_clean:.3f} s, uncleaned {t_raw:.3f} s, slab 0\'s '
          f'A + B with every PID field {t_pids:.3f} s, slab 0 with fields=\'all\' '
          + ', '.join(f'{k} {v:.3f} s' for k, v in t_all.items()))
    return {'name': name, 'groupdir': groupdir, 'config': cfg}


def check_disk_pids(sim, groupdir):
    """(a): CompaSOHaloCatalog of slab 0's A and B particles with their PIDs
    (unpack_bits=True), cleaned, against the words the phase drew: packedpid
    and the npstart / npout of both sets equal, every PID field equal to the
    words' fields, positions and velocities within the RVint quantum.
    Returns the read's seconds."""
    fields = ['N', 'npstartA', 'npoutA', 'npstartB', 'npoutB']
    cat, t_read = sync_seconds(lambda: CompaSOHaloCatalog(
        groupdir / 'halo_info' / 'halo_info_000.asdf', fields=fields, subsamples=True,
        unpack_bits=True, cleaned=True))
    halos, parts = decoded_catalog(sim, [0], True, sets='AB')
    for k in fields:
        require(np.array_equal(cat.halos[k], halos[k]), f'(a) A + B: {k} differs')
    words = parts['packedpid']
    require(np.array_equal(cat.subsamples['packedpid'], words), '(a) A + B: packedpid differs')
    want = unpack_pids(words, box=sim['header']['BoxSize'], ppd=sim['header']['ppd'],
                       **dict.fromkeys(PID_KEYS, True))
    for k in PID_KEYS:
        require(cat.subsamples[k].dtype == want[k].dtype
                and np.array_equal(cat.subsamples[k], want[k]), f'(a) A + B: {k} differs')
    box, eps = sim['header']['BoxSize'], float(np.finfo(np.float32).eps)
    dpos = float(np.abs(cat.subsamples['pos'] - parts['pos_true']).max())
    dvel = float(np.abs(cat.subsamples['vel'] - parts['vel_true']).max())
    require(dpos <= RV_POS_QUANTUM * box + box / 2 * eps
            and dvel <= RV_VEL_QUANTUM / 2 + 6000 * eps,
            f'(a) A + B: particles off by {dpos} Mpc/h, {dvel} km/s')
    n_a, n_b = int(halos['npoutA'].sum()), int(halos['npoutB'].sum())
    print(f'phase 16 (a) CompaSOHaloCatalog of slab 0, A + B, unpack_bits=True, cleaned: {n_a} A '
          f'and {n_b} B particles in {t_read:.3f} s ({len(cat.subsamples.colnames)} columns); '
          f'packedpid, '
          f'{", ".join(PID_KEYS)} equal to the drawn words\' fields, positions and velocities '
          f'within the RVint quantum')
    return t_read


def check_all_fields(sim, groupdir):
    """(a): CompaSOHaloCatalog of slab 0 with fields='all', cleaned, and
    uncleaned with convert_units=False, against the drawn columns decoded
    field by field in numpy (testing.decoded_fields): every column
    bit-equal. Host numpy: no kernel. Returns {read: seconds}."""
    fn = groupdir / 'halo_info' / 'halo_info_000.asdf'
    slab = sim['slabs'][0]
    out = {}
    for cleaned, units in ((True, True), (False, False)):
        tag = f'cleaned={cleaned}' + ('' if units else ', convert_units=False')
        cat, out[tag] = sync_seconds(lambda: CompaSOHaloCatalog(
            fn, fields='all', cleaned=cleaned, convert_units=units))
        names = [c if c != 'N' or not cleaned else 'N_total' for c in cat.halos.colnames]
        want = decoded_fields(slab['halo_info'], slab['clean'] if cleaned else None, cat.header,
                              names, units)
        for c, n in zip(cat.halos.colnames, names):
            require(want[n].dtype == cat.halos[c].dtype
                    and want[n].tobytes() == cat.halos[c].tobytes(),
                    f'(a) fields=all {tag}: {c} differs from its decode')
        print(f'phase 16 (a) [{CARD[0]}] CompaSOHaloCatalog of slab 0, fields=\'all\', {tag}: '
              f'{len(cat.halos)} halos, {len(cat.halos.colnames)} columns in {out[tag]:.3f} s, '
              f'nbytes {cat.nbytes()} ({cat.nbytes(subsamples=False)} of halos); every column '
              f'bit-equal to the drawn columns\' decode')
        del cat, want
    return out


# ---------------------------------------------------------------------------
# phase 17: the light cone's disk path, halo light-cone files -> P(k)
# ---------------------------------------------------------------------------

# 2.5e6 halos of an estimated ~1e7 in the octant of the z = 0.5 shell, 5 A
# particles a halo, a light-cone particle pair of 2e7: the cuts of PERF.md
# section 4
LC_DISK_HALOS = 2_500_000
LC_DISK_PER_HALO = 5
LC_DISK_PARTICLES = 20_000_000
LC_DISK_SEED = SEED + 17


def lc_disk_config(root, name):
    """Phase 16's config on the light cone: ranks and env on, no shear (a
    light cone's shear field reads a box's field particles)."""
    cfg = disk_config(root, name, 'lc_subsamples')
    cfg['sim_params'].update(sim_dir=f'{root}/halo_light_cones/', halo_lc=True)
    cfg['HOD_params']['want_shear'] = False
    return cfg


def check_lc_reads(sim, info):
    """17 (1): the light cone's catalog and particle pair against the arrays
    the phase drew: every halo column and the A particles (PIDs packed) bit-
    equal to the decode formulas, the RVint file equal to the drawn words'
    decode and within the quantum of the values encoded, every PID field of
    the packedpid file equal to the drawn words'."""
    halos, parts = decoded_catalog_lc(sim)
    cat, t_cat = sync_seconds(lambda: CompaSOHaloCatalog(info['groupdir'], fields=list(halos),
                                                         subsamples=True))
    require(cat.halo_lc and cat.subsamples.colnames == ['pid', 'pos', 'vel'],
            f'17 (1) read as a light cone {cat.halo_lc}, {cat.subsamples.colnames}')
    for k in halos:
        require(cat.halos[k].dtype == halos[k].dtype and np.array_equal(cat.halos[k], halos[k]),
                f'17 (1) light-cone column {k} differs from its decode formula')
    for k in parts:
        require(np.array_equal(cat.subsamples[k], parts[k]), f'17 (1) lc_pid_rv {k} differs')
    no_avg = float((~np.any(sim['halos']['pos_avg'], axis=1)).mean())
    del cat, halos, parts
    cat, t_all = sync_seconds(lambda: CompaSOHaloCatalog(info['groupdir'], fields='all'))
    want = decoded_fields(sim['halos'], None, cat.header, cat.halos.colnames)
    for k in cat.halos.colnames:
        require(want[k].dtype == cat.halos[k].dtype and want[k].tobytes() == cat.halos[k].tobytes(),
                f'17 (1) fields=all: {k} differs from its decode')
    n_all, nbytes_all = len(cat.halos.colnames), cat.nbytes()
    del cat, want
    header, drawn = sim['header'], sim['particles']
    box = header['BoxSize']
    rv, t_rv = sync_seconds(lambda: read_asdf(info['particle_files']['rv'], verbose=False))
    p, v = unpack_rvint(drawn['rvint'], box)
    eps = float(np.finfo(np.float32).eps)
    dpos = float(np.abs(rv['pos'] - drawn['pos_true']).max())
    dvel = float(np.abs(rv['vel'] - drawn['vel_true']).max())
    require(np.array_equal(rv['pos'], p) and np.array_equal(rv['vel'], v)
            and dpos <= RV_POS_QUANTUM * box + box / 2 * eps
            and dvel <= RV_VEL_QUANTUM / 2 + 6000 * eps, f'17 (1) RVint file: {dpos}, {dvel}')
    frac = header['ParticleSubsampleA'] + header['ParticleSubsampleB']
    require(rv.meta['SubsampleFraction'] == frac, '17 (1) no SubsampleFraction in the header')
    del rv, p, v
    pid, t_pid = sync_seconds(lambda: read_asdf(info['particle_files']['pid'],
                                                load=PID_KEYS + ('aux',), verbose=False))
    want = unpack_pids(drawn['packedpid'], box=box, ppd=header['ppd'],
                       **dict.fromkeys(PID_KEYS, True))
    for k in PID_KEYS:
        require(pid[k].dtype == want[k].dtype and np.array_equal(pid[k], want[k]),
                f'17 (1) packedpid file: {k} differs')
    require(np.array_equal(pid['aux'], drawn['packedpid']), '17 (1) packedpid file: aux differs')
    print(f'phase 17 (1) reads: CompaSOHaloCatalog(halo_lc) {t_cat:.3f} s, every light-cone '
          f'column bit-equal to its decode formula (pos_avg zero for {no_avg:.3f} of the halos: '
          f'pos_interp / vel_interp as stored there), lc_pid_rv as written; fields=\'all\' '
          f'{t_all:.3f} s ({n_all} columns, nbytes {nbytes_all}, every one bit-equal to its '
          f'decode); read_asdf RVint '
          f'{t_rv:.3f} s (max |d| {dpos:.3e} Mpc/h, {dvel:.3f} km/s, SubsampleFraction {frac}), '
          f'packedpid {t_pid:.3f} s, {", ".join(PID_KEYS)} equal to the drawn words\'')


def phase_lc_disk(dev, paths, root):
    """Phase 17: the light cone's disk path on the card, from files it writes
    itself under `root` (removed by main after phase 19). Returns the
    light cone's config."""
    t0 = time.perf_counter()
    cfg = lc_disk_path(dev, paths, root)
    print(f'phase 17 in {time.perf_counter() - t0:.1f} s')
    return cfg


def lc_disk_path(dev, paths, root):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim, t_gen = sync_seconds(lambda: synthetic_compaso_lc(
        LC_DISK_HALOS, LC_DISK_PER_HALO, LC_DISK_PARTICLES, seed=LC_DISK_SEED))
    info, t_write = sync_seconds(lambda: write_compaso_lc(root, sim))
    name = sim['header']['SimName']
    n_part = len(sim['pid_rv']['pid'])
    print(f'phase 17 light cone ({name} header at z 0.5, observers {LC_ORIGINS}, shell '
          f'{LC_SHELL} Mpc/h): {LC_DISK_HALOS} halos, {n_part} A particles, a particle pair of '
          f'{LC_DISK_PARTICLES}; drawn in {t_gen:.3f} s, written (blsc zstd, '
          f'{len(info["files"])} files) in {t_write:.3f} s, {info["raw_bytes"]} bytes raw, '
          f'{info["disk_bytes"]} on disk')
    check_lc_reads(sim, info)
    del sim

    # (2) prepare_sim.main on the light cone, the device engines, through its
    # command line
    cfg = lc_disk_config(root, name)
    cfg_fn = root / 'prepare_sim_lc.json'
    cfg_fn.write_text(json.dumps(cfg))
    steps, calls = {}, {}
    tag = 'prepare_sim._cli --halo_lc (light cone)'
    reset_launches()
    with timed_stages([(prepare_sim, 'read_slab'), (prepare_sim, 'prepare_slab_tables'),
                       (prepare_sim, 'write_slab_tables'), (prepare_sim, 'lc_randoms_norm')],
                      steps, calls):
        with calls_of(ranks_device, 'seg_rank') as ranked:
            _, t_main = sync_seconds(lambda: prepare_sim._cli(
                ['--path2config', str(cfg_fn), '--halo_lc', '--device', str(dev)]))
    paths[tag] = dict(read_launches(), seg_rank=ranked[0])
    for k in ('nn_within_halo', 'menv_annulus'):
        require(paths[tag][k] > 0, f'{tag}: no {k} launch ({paths[tag]})')
    require(calls.get('lc_randoms_norm') == 1, f'{tag}: randoms loop ran {calls} times')
    savedir = f'{root}/lc_subsamples/{name}/z0.500'
    fh, fp, fe = prepare_sim.slab_filenames(savedir, 0, 600, True, True)
    require(os.path.exists(fh) and os.path.exists(fp) and not os.path.exists(fe),
            f'{tag}: files {sorted(os.listdir(savedir))}')
    with np.load(fh) as h:
        halos = h['halos']
    require(list(halos.dtype.names) == prepare_sim.HALO_ORDER_LC + prepare_sim.HALO_EXTRA
            and np.abs(halos['fenv_rank']).max() > 0.4, f'{tag}: halo table {halos.dtype}')
    print(f'phase 17 (2) {tag}: {t_main:.3f} s host to host; read {steps["read_slab"]:.3f} s, '
          f'tables {steps["prepare_slab_tables"]:.3f} s (of which the randoms loop '
          f'{steps["lc_randoms_norm"]:.3f} s), write {steps["write_slab_tables"]:.3f} s; '
          f'{len(halos)} halos kept; launches {paths[tag]}')
    del halos

    # (3)-(5) staging, run_hod and run_hod_pk_fused
    tag = 'AbacusHOD.from_config + run_hod + run_hod_pk_fused (light cone)'
    reset_launches()
    hod, t_stage = sync_seconds(lambda: AbacusHOD.from_config(
        cfg['sim_params'], cfg['HOD_params'], device=dev))
    require(hod.halo_lc and hod.halo_data['hid'].dtype == np.int64,
            '17 (3) staged ids are not int64')
    mock, t_hod = sync_seconds(lambda: hod.run_hod())

    def call(h):
        return h.run_hod_pk_fused(nmesh=NMESH, nbins_k=NBINS_K)

    (cl, n_gal), t_cold = sync_seconds(lambda: call(hod))
    best = min(sync_seconds(lambda: [call(hod) for _ in range(5)])[1] / 5 for _ in range(3))
    paths[tag] = read_launches()
    for k in ('tsc_deposit_cells[tsc]', 'bin_pair_modes[no poles]'):
        require(paths[tag][k] > 0, f'{tag}: no {k} launch ({paths[tag]})')
    counts = {t: len(mock[t]['x']) for t in mock}
    require(counts == {t: int(v) for t, v in n_gal.items()} and all(counts.values()),
            f'17 (4) run_hod counts {counts}, run_hod_pk_fused n_gal {n_gal}')
    flags = dict(want_ranks=True, want_shear=False, want_expvel=False, halo_lc=True,
                 z_type='lightcone')
    twin = staged_state_from_numpy(hod.halo_data, hod.particle_data, hod.params, hod.tracers,
                                   flags, dev)
    cl2, n_gal2 = call(twin)
    require(n_gal2 == n_gal, f'17 (5) n_gal {n_gal} against the twin\'s {n_gal2}')
    worst, bit_equal = 0.0, True
    for t1 in WANT:
        for t2 in WANT:
            a, b = cl[f'{t1}_{t2}'], cl2[f'{t1}_{t2}']
            require(np.isfinite(a).all(), f'17 (5) {t1}_{t2} not finite')
            scale = np.sqrt(np.abs(cl2[f'{t1}_{t1}'] * cl2[f'{t2}_{t2}']))
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(scale, 1e-300))))
            bit_equal &= bool(np.array_equal(a, b))
    require(worst <= 1e-4, f'17 (5) run_hod_pk_fused differs from the staged twin by {worst:.3e}')
    peak = torch.cuda.max_memory_allocated()
    print(f'phase 17 (3)-(5) {tag}: staging {t_stage:.3f} s ({len(hod.halo_data["hid"])} halos, '
          f'{len(hod.particle_data["pinds"])} particles, origin {hod.params["origin"]}); run_hod '
          f'{t_hod:.3f} s, galaxies {counts} equal to the fused call\'s n_gal; '
          f'run_hod_pk_fused cold {t_cold:.3f} s, warm {best:.6f} s (best mean of 3x5); against '
          f'the same call on staged_state_from_numpy of those tables: bit-equal {bit_equal}, max '
          f'|d|/scale {worst:.3e}; launches {paths[tag]}; phase peak device memory '
          f'{peak / 2**30:.3f} GiB')
    return cfg


# phase 19: the scripts of scripts/torch/hod and emulator on phase 16's and 17's trees
GCF_CHECK_HALOS = 50_000  # generate_cf's selection held against K4's plain version
SCRIPT_CLUSTERING = {'clustering_type': 'xirppi', 'pimax': 30, 'pi_bin_size': 5,
                     'bin_params': {'logmin': -1.0, 'logmax': float(np.log10(30.0)), 'nbins': 8}}
N_BENCH_RANKS = 1_200_000
K1_KERNEL, K3_KERNEL = 'tsc_deposit_bricks_kernel', 'mode_bin_pairs_kernel'


def phase_scripts(dev, paths, disk16, cfg17):
    """Phase 19: each script of scripts/torch/ through its own main or run,
    on the trees phases 16 and 17 left: (a) generate_cf.main at the default
    ndens, (b) run_hod.py's main and run_emcee.lnprob, (c) run_lc_hod.main,
    (d) bench_multitracer.main with a warm step under device_trace and
    stage_timer, (e) bench_ranks.run, (f) pipe_asdf into the C client.
    Scratch files go to a temporary directory, removed at the end."""
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_scripts_'))
    times = {}
    try:
        times['(a) generate_cf'] = sync_seconds(lambda: scripts_cf(dev, paths, disk16, tmp))[1]
        times['(b) run_hod + lnprob'] = sync_seconds(
            lambda: scripts_hod(dev, paths, disk16, tmp))[1]
        times['(c) run_lc_hod'] = sync_seconds(lambda: scripts_lc(dev, paths, cfg17, tmp))[1]
        times['(d) bench_multitracer'] = sync_seconds(
            lambda: scripts_multitracer(dev, paths, tmp))[1]
        times['(e) bench_ranks'] = sync_seconds(lambda: scripts_ranks(dev, paths))[1]
        times['(f) pipe_asdf'] = sync_seconds(lambda: scripts_pipe(disk16, tmp))[1]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f'phase 19 in {time.perf_counter() - t0:.1f} s [{CARD[0]}]: '
          + ', '.join(f'{k} {v:.3f} s' for k, v in times.items()))


def scripts_cf(dev, paths, disk16, tmp):
    """(a) generate_cf.main on phase 16's redshift directory (both slabs) at
    the default ndens, on K4; the file read back; the counts of a
    GCF_CHECK_HALOS selection of the same catalog held against K4's plain
    version."""
    gcf = torch_script('emulator/generate_cf')
    groupdir = disk16['groupdir']
    tag = 'scripts/torch/emulator/generate_cf.py main (ndens 1e-4)'
    reset_launches()
    fn, t_main = sync_seconds(lambda: gcf.main(groupdir, outdir=tmp / 'cf', device=dev))
    paths[tag] = read_launches()
    require(paths[tag]['pair_count_cells[smu]'] == 1 and paths[tag]['count_pairs_all'] == 0,
            f'{tag}: launches {paths[tag]}')
    with open_asdf(fn) as af:
        data = af['data']
        npairs = np.asarray(data['npairs'])
        xi = np.asarray(data['xi'])
        meta = dict(data.meta)
    box = float(meta['BoxSize'])
    n = int(box**3 * gcf.DEFAULT_NDENS)
    rr = n * (n - 1) / box**3 * 4 / 3 * np.pi * np.diff(gcf.RBINS**3)
    require(npairs.dtype == np.uint64 and npairs.shape == (len(gcf.RBINS) - 1,)
            and int(npairs.sum()) > 0, f'{tag}: npairs {npairs}')
    require(np.array_equal(xi, npairs / rr - 1) and meta['zname'] == groupdir.name,
            f'{tag}: xi or zname of {fn.name} ({meta["zname"]})')
    # K4 against its plain version on a smaller selection, on the stage the
    # dispatch builds
    cat = gcf.prepare_cat(groupdir, GCF_CHECK_HALOS / box**3)
    cf = gcf.generate_cf(cat, device=dev)
    soa = tuple(np.ascontiguousarray(cat.halos['x_L2com'][:, i] % box, np.float64)
                for i in range(3))
    nc, refine = tpcf.cell_grid(box, float(gcf.RBINS[-1]), GCF_CHECK_HALOS)
    st = tpcf._get_stage(soa, box, nc, dev, tpcf.default_span(nc, refine, GCF_CHECK_HALOS))
    thr = edges_f32(np.asarray(gcf.RBINS, np.float64) ** 2)
    plain, t_plain = sync_seconds(lambda: count_pairs_cells_plain(
        st, None, thr, 1, 'smu', 1.0, max_pairs=1 << 24))
    plain = plain.cpu().numpy().reshape(-1)
    require(np.array_equal(plain, cf['npairs'].astype(np.int64)),
            f'{tag}: K4 {cf["npairs"]} against plain {plain} on {GCF_CHECK_HALOS} halos')
    print(f'phase 19 (a) {tag}: the {n} most massive halos of both slabs, {t_main:.3f} s host '
          f'to host, {int(npairs.sum())} ordered pairs in {len(npairs)} r bins, xi '
          f'{np.round(xi, 4).tolist()} read back from {fn.name}; on {GCF_CHECK_HALOS} halos K4 '
          f'equal to its plain version ({nc}^3 cells, plain {t_plain:.3f} s); launches '
          f'{paths[tag]}')


def scripts_hod(dev, paths, disk16, tmp):
    """(b) run_hod.py's main (ntest=2) on phase 16's prepared box, xi(rp, pi)
    at the bins of docs/hod.md; its first mock's xirppi as the data vector
    with an identity covariance; run_emcee.lnprob at the config's
    parameters (0 exactly: the pre-attached randoms give the same mock and
    K4's counts are integers), then with LRG's logM_cut + 0.05 (below 0)."""
    cfg = dict(disk16['config'], clustering_params=SCRIPT_CLUSTERING)
    cfg_fn = tmp / 'run_hod.json'
    cfg_fn.write_text(json.dumps(cfg))
    rh = torch_script('hod/run_hod')
    tag = 'scripts/torch/hod/run_hod.py main (ntest=2)'
    reset_launches()
    out, t_main = sync_seconds(lambda: rh.main(str(cfg_fn), ntest=2, device=dev))
    paths[tag] = read_launches()
    require(paths[tag]['pair_count_cells[rppi]'] + paths[tag]['count_pairs_all'] == 18,
            f'{tag}: 3 autos and 3 crosses a round, 3 rounds: launches {paths[tag]}')
    combos = {}
    for combo, xi in out['xirppi'].items():
        np.savez(tmp / f'{combo}_xi.npz', xirppi=xi)
        np.savez(tmp / f'{combo}_cov.npz', cov=np.eye(xi.size))
        combos[combo] = {'path2power': str(tmp / f'{combo}_xi.npz'),
                         'path2cov': str(tmp / f'{combo}_cov.npz')}
    em = torch_script('hod/run_emcee')
    data = em.Data({'tracer_combos': combos}, cfg['HOD_params'])
    ball = AbacusHOD.from_config(cfg['sim_params'], cfg['HOD_params'], cfg['clustering_params'],
                                 device=dev)
    p0 = np.array([cfg['HOD_params']['LRG_params']['logM_cut']])
    tag_l = 'scripts/torch/hod/run_emcee.py lnprob'
    reset_launches()
    l0 = em.lnprob(p0, {'logM_cut': 0}, {'logM_cut': 'LRG'}, data, ball)
    paths[tag_l] = read_launches()
    l1 = em.lnprob(p0 + 0.05, {'logM_cut': 0}, {'logM_cut': 'LRG'}, data, ball)
    require(l0 == 0.0, f'{tag_l}: {l0} at the data\'s own parameters')
    require(l1 < 0.0, f'{tag_l}: {l1} after logM_cut + 0.05')
    counts = {t: len(m['x']) for t, m in out['mock'].items()}
    print(f'phase 19 (b) {tag}: {t_main:.3f} s host to host (staging included), galaxies '
          f'{counts}, first xi {out["xi_first"]:.3f} s, run_hod {np.round(out["run_hod"], 3)} s, '
          f'xi {np.round(out["xi"], 3)} s; lnprob {l0} at the data\'s parameters, {l1:.6g} at '
          f'logM_cut + 0.05; launches {paths[tag]}, lnprob {paths[tag_l]}')


def scripts_lc(dev, paths, cfg17, tmp):
    """(c) run_lc_hod.main on phase 17's light cone, catalogs written (the
    run_lc_hod's default) into the mock directory."""
    cfg = copy.deepcopy(cfg17)
    cfg['sim_params']['output_dir'] = str(tmp / 'lc_mocks') + '/'
    cfg_fn = tmp / 'run_lc_hod.json'
    cfg_fn.write_text(json.dumps(cfg))
    lc = torch_script('hod/run_lc_hod')
    tag = 'scripts/torch/hod/run_lc_hod.py main'
    reset_launches()
    mock, t_main = sync_seconds(lambda: lc.main(str(cfg_fn), device=dev))
    paths[tag] = read_launches()
    counts = {t: len(m['x']) for t, m in mock.items()}
    written = sorted((tmp / 'lc_mocks').rglob('*.dat'))
    require(list(counts) == list(WANT) and all(counts.values()) and len(written) == len(WANT),
            f'{tag}: galaxies {counts}, files {written}')
    print(f'phase 19 (c) {tag}: {t_main:.3f} s host to host (staging and the ECSV writes '
          f'included), galaxies {counts}, {sum(f.stat().st_size for f in written)} bytes in '
          f'{len(written)} catalogs; launches {paths[tag]}')


def scripts_multitracer(dev, paths, tmp):
    """(d) bench_multitracer.main at its cell: K1 six times and K3 once a
    call, six finite spectra; one warm step under profiling.device_trace
    (the trace names K1's and K3's kernels) and one under
    profiling.stage_timer (within 20 % of bench_multitracer's step_seconds)."""
    from abacusutils_tpu_torch.utils import profiling

    bm = torch_script('hod/bench_multitracer')
    tag = 'scripts/torch/hod/bench_multitracer.py main'
    reset_launches()
    record, step, spectra = bm.main(device=dev)
    paths[tag] = read_launches()
    calls = 1 + 5
    require(paths[tag]['tsc_deposit_cells[tsc]'] == 6 * calls
            and paths[tag]['bin_pair_modes[no poles]'] == calls,
            f'{tag}: K1 6 and K3 1 a call over {calls} calls: launches {paths[tag]}')
    require(len(spectra) == 6 and all(bool(torch.isfinite(v).all()) for v in spectra.values()),
            f'{tag}: spectra {list(spectra)}')
    with profiling.device_trace(tmp / 'trace') as fn:
        step()
        torch.cuda.synchronize()
    text = Path(fn).read_text()
    require(K1_KERNEL in text and K3_KERNEL in text,
            f'{tag}: the trace names K1 {K1_KERNEL in text}, K3 {K3_KERNEL in text}')
    timings = profiling.Timings()
    with profiling.stage_timer('step', timings, device=dev):
        step()
    step_s = record['detail']['step_seconds']
    require(abs(timings['step'] - step_s) <= 0.2 * step_s,
            f'{tag}: stage_timer {timings["step"]:.6f} s against step_seconds {step_s:.6f} s')
    print(f'phase 19 (d) {tag}: step {step_s:.6f} s, {record["value"]:.4g} galaxies/s, staging '
          f'{record["detail"]["staging_seconds"]:.3f} s warm, '
          f'{record["detail"]["staging_first_call_seconds"]:.3f} s cold; stage_timer of one warm '
          f'step {timings["step"]:.6f} s; device_trace ({os.path.getsize(fn)} bytes) names '
          f'{K1_KERNEL} and {K3_KERNEL}; launches {paths[tag]}')


def scripts_ranks(dev, paths):
    """(e) bench_ranks.run at 1.2e6 particles with the host loop: 0 key and 0
    NN flips."""
    br = torch_script('hod/bench_ranks')
    tag = 'scripts/torch/hod/bench_ranks.py run'
    reset_launches()
    out = br.run(N_BENCH_RANKS, host=True, verbose=False, device=dev)
    paths[tag] = read_launches()
    require(paths[tag]['nn_within_halo'] == 2, f'{tag}: launches {paths[tag]}')
    require(out['key_flips'] == 0 and out['nn_flips'] == 0, f'{tag}: flips {out}')
    print(f'phase 19 (e) {tag}: {out}; launches {paths[tag]}')


def scripts_pipe(disk16, tmp):
    """(f) native/pipe_client built with gcc, fed by ``python -m
    abacusutils_tpu_torch.io.pipe_asdf`` with N and x_L2com of phase 16's
    first halo_info file: its lines equal the first and last five values
    of the port's own read."""
    repo = Path(__file__).resolve().parent
    client = repo / 'build' / 'pipe_client' / 'client'
    client.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(['gcc', '-O2', '-o', str(client), str(repo / 'native/pipe_client/client.c')],
                   check=True)
    fn = disk16['groupdir'] / 'halo_info' / 'halo_info_000.asdf'
    t0 = time.perf_counter()
    src = subprocess.Popen([sys.executable, '-m', 'abacusutils_tpu_torch.io.pipe_asdf', '-f',
                            'N', '-f', 'x_L2com', str(fn)], cwd=repo, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE)
    try:
        res = subprocess.run([str(client)], stdin=src.stdout, capture_output=True, text=True,
                             timeout=300)
        src.stdout.close()
        err = src.communicate(timeout=300)[1].decode()
    finally:
        if src.poll() is None:
            src.kill()
            src.wait()
    t_pipe = time.perf_counter() - t0
    require(src.returncode == 0 and res.returncode == 0,
            f'(f) pipe_asdf rc {src.returncode}, client rc {res.returncode}: {err} {res.stderr}')
    with open_asdf(fn) as af:
        N = np.asarray(af['data']['N'])
        x = np.asarray(af['data']['x_L2com'])
    want = (['First and last 5 N:'] + [f'{v}' for v in N[:5]] + [f'{v}' for v in N[::-1][:5]]
            + ['First and last 5 x_com:']
            + ['({:f},{:f},{:f})'.format(*map(float, r)) for r in x[:5]]
            + ['({:f},{:f},{:f})'.format(*map(float, r)) for r in x[::-1][:5]])
    require(res.stdout.splitlines() == want, f'(f) the client printed {res.stdout!r}')
    print(f'phase 19 (f) python -m abacusutils_tpu_torch.io.pipe_asdf -f N -f x_L2com '
          f'{fn.name} | client: {len(N)} halos piped in {t_pipe:.3f} s (the interpreter\'s '
          f'start included); the client\'s 22 lines equal the port\'s read; '
          + ' '.join(line for line in err.splitlines() if 'Processed' in line))


KERNELS = {
    'tsc_deposit_cells': (tsc_deposit_cells, 'abacusutils_tpu_torch/csrc/tsc_deposit.cu',
                          'abacusutils_tpu/ops/grid_pallas.py:92'),
    'bin_power_modes': (bin_power_modes, 'abacusutils_tpu_torch/csrc/mode_bin_pairs.cu',
                        'abacusutils_tpu/ops/power.py:396'),
    'bin_pair_modes': (bin_pair_modes, 'abacusutils_tpu_torch/csrc/mode_bin_pairs.cu',
                       'abacusutils_tpu/ops/power.py:451'),
    'count_pairs_cells': (count_pairs_cells, 'abacusutils_tpu_torch/csrc/pair_count.cu',
                          'abacusutils_tpu/ops/tpcf.py:330'),
    'count_pairs_all': (count_pairs_all, 'abacusutils_tpu_torch/csrc/pair_count.cu',
                        'abacusutils_tpu/ops/tpcf.py:39'),
    'nn_within_halo': (ranks_device.nn_within_halo, 'abacusutils_tpu_torch/csrc/prepare_sim.cu',
                       'abacusutils_tpu/models/hod/ranks_device.py:271'),
    'menv_annulus': (menv_device.menv_annulus, 'abacusutils_tpu_torch/csrc/prepare_sim.cu',
                     'abacusutils_tpu/models/hod/menv_device.py:152'),
    'tsc_deposit_cells_multi': (tsc_deposit_cells_multi,
                                'abacusutils_tpu_torch/csrc/tsc_gather.cu',
                                'abacusutils_tpu/ops/grid.py:485'),
    'window_mode_sums': (tzw.window_mode_sums, 'abacusutils_tpu_torch/csrc/zcv_window.cu',
                         'abacusutils_tpu/models/zcv/zenbu_window.py:96'),
    'bin_kppi_sums': (bin_kppi_sums, 'abacusutils_tpu_torch/csrc/kppi_bin.cu',
                      'abacusutils_tpu/ops/power.py:613'),
}
# the kernels line's entries: (kernel, form); a form's launches are its
# wrapper's launches_by_form count (None: the wrapper's whole count)
FORMS = {
    'tsc_deposit_cells[tsc]': ('tsc_deposit_cells', 'tsc', 'abacusutils_tpu/ops/grid_pallas.py:92'),
    'tsc_deposit_cells[cic]': ('tsc_deposit_cells', 'cic', 'abacusutils_tpu/ops/grid.py:94'),
    'bin_power_modes': ('bin_power_modes', None, 'abacusutils_tpu/ops/power.py:396'),
    'bin_pair_modes[no poles]': ('bin_pair_modes', 'no poles', 'abacusutils_tpu/ops/power.py:451'),
    'bin_pair_modes[poles nmu=1]': ('bin_pair_modes', 'poles nmu=1',
                                    'abacusutils_tpu/ops/power.py:451'),
    'bin_pair_modes[poles nmu=4]': ('bin_pair_modes', 'poles nmu=4',
                                    'abacusutils_tpu/ops/power.py:524'),
    'pair_count_cells[rppi]': ('count_pairs_cells', 'rppi', 'abacusutils_tpu/ops/tpcf.py:330'),
    'pair_count_cells[smu]': ('count_pairs_cells', 'smu', 'abacusutils_tpu/ops/tpcf.py:330'),
    'pair_count_all[rppi]': ('count_pairs_all', 'rppi', 'abacusutils_tpu/ops/tpcf.py:39'),
    'pair_count_all[smu]': ('count_pairs_all', 'smu', 'abacusutils_tpu/ops/tpcf.py:84'),
    'nn_within_halo': ('nn_within_halo', None, 'abacusutils_tpu/models/hod/ranks_device.py:271'),
    'menv_annulus': ('menv_annulus', None, 'abacusutils_tpu/models/hod/menv_device.py:152'),
    'tsc_deposit_cells[tsc multi-weight]': ('tsc_deposit_cells_multi', None,
                                            'abacusutils_tpu/ops/grid.py:485'),
    'window_mode_sums': ('window_mode_sums', None,
                         'abacusutils_tpu/models/zcv/zenbu_window.py:96'),
    'bin_kppi_sums': ('bin_kppi_sums', None, 'abacusutils_tpu/ops/power.py:613'),
}


def reset_launches():
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, 'launches_by_form'):
            for k in fn.launches_by_form:
                fn.launches_by_form[k] = 0


@contextlib.contextmanager
def calls_of(mod, name):
    """Count the calls of mod.name (a function without a kernel of its own,
    so without a launch counter) while the block runs: yields a one-element
    list holding the count."""
    fn, count = getattr(mod, name), [0]

    def counted(*a, **k):
        count[0] += 1
        return fn(*a, **k)

    setattr(mod, name, counted)
    try:
        yield count
    finally:
        setattr(mod, name, fn)


def read_launches():
    out = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}
    for form, (name, key, _) in FORMS.items():
        if key is not None:
            out[form] = KERNELS[name][0].launches_by_form.get(key, 0)
    return out


def fused_state(dev):
    """An AbacusHOD staged state at the bench size on the device: the
    catalog of make_example_inputs_device(link=True) with 3-D velocities and
    deltac / fenv drawn in [-0.5, 0.5]."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    halo, part, _ = make_example_inputs_device(N_HALO, N_PART, LBOX, gen, dev, link=True)

    def draw(n, scale):
        return torch.randn(n, generator=gen, device=dev) * scale

    def centred(n):
        return torch.rand(n, generator=gen, device=dev) - 0.5

    hidx = part['hidx'].long()
    hvel = torch.stack([draw(N_HALO, 300.0), draw(N_HALO, 300.0), halo['vz']], 1)
    halo_data = {
        'hid': torch.arange(N_HALO, dtype=torch.int64, device=dev),
        'hpos': torch.stack([halo['x'], halo['y'], halo['z']], 1),
        'hvel': hvel,
        'hveldev': torch.stack([draw(N_HALO, 100.0), draw(N_HALO, 100.0), halo['vdevz']], 1),
        'hmass': halo['mass'], 'hmultis': halo['multis'], 'hrandoms': halo['randoms'],
        'hdeltac': centred(N_HALO), 'hfenv': centred(N_HALO),
    }
    particle_data = {
        'ppos': torch.stack([part['x'], part['y'], part['z']], 1),
        'pvel': torch.stack([draw(N_PART, 300.0), draw(N_PART, 300.0), part['vz']], 1),
        'phvel': hvel[hidx], 'phmass': part['hmass'], 'pweights': part['weights'],
        'prandoms': part['randoms'], 'pdeltac': halo_data['hdeltac'][hidx],
        'pfenv': halo_data['hfenv'][hidx], 'pinds': part['hidx'], 'phid': hidx,
    }
    return halo_data, particle_data


def k3_extras(deltas, seg, nbins, W, pole_w=None, nmu=1):
    """K3's bound (:func:`binning_bound`, the f64 sums of every pair's bins
    and pole rows written once), its in-bin share and the time of one
    library call that bins every pair's (k, mu) rows: torch.bincount over
    precomputed f32 per-mode weights (the binning only; no pole rows)."""
    npairs = len(deltas) * (len(deltas) + 1) // 2
    row = nbins + (len(pole_w) * (nbins // nmu) if pole_w else 0)
    bound, share = binning_bound(seg, nbins, len(deltas), W is not None, 8 * npairs * row)
    dup = mode_dup_t(deltas[0].shape[0], seg.device)
    w = torch.cat([(deltas[i].real * deltas[j].real + deltas[i].imag * deltas[j].imag)
                   .mul_(dup).reshape(-1) for i, j in field_pairs(len(deltas))])
    segs = torch.cat([seg.reshape(-1) + p * (nbins + 1) for p in range(npairs)])
    lib_ms = event_ms(lambda: torch.bincount(segs, weights=w, minlength=npairs * (nbins + 1)))
    return bound, share, lib_ms


def plain_spectra(cats, n_gal, seg, W):
    """Every pair's bin sums from the plain versions only: one plain deposit
    per (x, y, z, w, plan) catalog of each tracer, rfftn, plain pair
    binning."""
    deltas = []
    for tracer in WANT:
        grid = torch.zeros((NMESH,) * 3, device=seg.device)
        for x, y, z, w, *_ in cats[tracer]:
            paint_3d_plain(grid, x, y, z, w, NMESH, LBOX)
        deltas.append(torch.fft.rfftn(grid * (grid.numel() / n_gal[tracer]) - 1.0))
    return deltas, bin_pair_modes_plain(deltas, seg, W, 1.0 / NMESH**3, NBINS_K)


def check_fused(phase, hod, stage_fn, k1_per_call, cats_fn, seg, W):
    """Stage cold and warm, one cold and 3x5 timed warm calls of
    hod.run_hod_pk_fused, launch and plan checks, the spectra against the
    plain rebuild, and K3 against its plain version. Returns (launches, K3's
    timing record, clustering, n_gal, the plain rebuild's deposits)."""
    t_stage_cold = sync_seconds(stage_fn)[1]
    hod._fused_stage = hod._flat_stage_cache = None
    t_stage = sync_seconds(stage_fn)[1]

    def call():
        return hod.run_hod_pk_fused(nmesh=NMESH, nbins_k=NBINS_K, compensated=True)

    torch.cuda.reset_peak_memory_stats()
    builds = make_bin_plan_arrays.builds
    spans = mode_spans.builds
    reset_launches()
    (cl, n_gal), t_cold = sync_seconds(call)
    n_iter, best = 5, float('inf')
    for _ in range(3):
        _, dt = sync_seconds(lambda: [call() for _ in range(n_iter)])
        best = min(best, dt / n_iter)
    launches = read_launches()
    n_calls = 1 + 3 * n_iter
    peak = torch.cuda.max_memory_allocated()
    over = int(hod.deposit_overflow.item())  # of the last call
    print(
        f'phase {phase}: staging cold {t_stage_cold:.3f} s warm {t_stage:.3f} s, '
        f'cold call {t_cold:.3f} s, seconds/call {best:.6f} (best mean of 3x{n_iter}), '
        f'n_gal {n_gal}, peak memory {peak / 2**30:.3f} GiB, K1 overflow share '
        f'{over / sum(n_gal.values()):.3e} ({over} galaxies), '
        f'plan builds {make_bin_plan_arrays.builds - builds}, launches {launches}'
    )
    require(launches['tsc_deposit_cells'] == k1_per_call * n_calls, f'K1 launches {launches}')
    require(launches['bin_pair_modes'] == n_calls, f'K3 launches {launches}')
    require(launches['bin_power_modes'] == 0, f'K2 launches {launches}')
    require(make_bin_plan_arrays.builds == builds, 'the bin plan was rebuilt')
    require(mode_spans.builds == spans, 'the calls built row spans')
    require(all(n > 0 for n in n_gal.values()), f'empty tracer {n_gal}')

    # the same spectra from the plain versions only
    cats, ng_plain = cats_fn(hod)
    deltas, wsum_p = plain_spectra(cats, ng_plain, seg, W)
    seg_counts = make_bin_plan_arrays(NMESH, LBOX, NBINS_K, seg.device)[1]
    P_p = {}
    for (i, j), w in zip(field_pairs(len(WANT)), wsum_p.cpu().numpy()):
        P_p[(WANT[i], WANT[j])] = np.divide(
            w, seg_counts, out=np.zeros_like(w), where=seg_counts != 0) * LBOX**3
    worst = 0.0
    for (t1, t2), ref in P_p.items():
        got = cl[f'{t1}_{t2}']
        require(np.isfinite(got).all(), f'{t1}_{t2} not finite')
        scale = np.abs(ref) if t1 == t2 else np.sqrt(np.abs(P_p[(t1, t1)] * P_p[(t2, t2)]))
        rel = float(np.max(np.abs(got - ref) / np.maximum(scale, 1e-300)))
        worst = max(worst, rel)
        require(rel <= 1e-4, f'{t1}_{t2} differs from the plain rebuild by {rel:.3e} (> 1e-4)')
    for tracer in WANT:
        require(float(ng_plain[tracer]) == n_gal[tracer], f'{tracer} n_gal differs from plain')
    print(f'phase {phase}: plain rebuild agrees, n_gal equal, worst spectrum |d|/scale {worst:.3e}')

    scale = 1.0 / NMESH**3
    k3_ms = event_ms(lambda: bin_pair_modes(deltas, seg, W, scale, NBINS_K))
    k3_kernel = kernel_ms(lambda: bin_pair_modes(deltas, seg, W, scale, NBINS_K))
    p3_ms = event_ms(lambda: bin_pair_modes_plain(deltas, seg, W, scale, NBINS_K))
    got = bin_pair_modes(deltas, seg, W, scale, NBINS_K)
    k3_err = float((got - wsum_p).abs().max())
    # autos at rtol 1e-5, crosses at 1e-5 sqrt(P_ii P_jj): per-block f32
    # histograms summed with f64 atomics in a run-dependent order
    pairs = field_pairs(len(WANT))
    auto = {i: wsum_p[p].abs() for p, (i, j) in enumerate(pairs) if i == j}
    tol = torch.stack([1e-5 * (auto[i] * auto[j]).sqrt() for i, j in pairs])
    k3_bound, share, lib_ms = k3_extras(deltas, seg, NBINS_K, W)
    k3 = binning_line(f'phase {phase} K3 at call shapes', 'no poles, 3 fields,', k3_ms,
                      k3_kernel, p3_ms, k3_err, k3_bound, share, lib_ms)
    require(bool(((got - wsum_p).abs() <= tol).all()), 'K3 disagrees with its plain version')
    return launches, k3, cl, n_gal, cats


def box_cats(hod):
    """Per tracer, the box leg's two deposits (box-frame coordinates and
    the stage's brick plan) from the staged catalogs, and n_gal."""
    halo_g, part_g, plan_h, plan_p = hod._box_stage(NMESH, YB)
    tp = hod._tracer_tensors(TRACERS, WANT)
    inv_v = float(np.float32(1.0) / np.float32(VELZ2KMS))
    tr, _ = populate_weights_multi(halo_g, part_g, tp, WANT, True, inv_v)
    half = float(np.float32(LBOX) / 2)
    cats, n_gal = {}, {}
    for tracer in WANT:
        z_c, w_c, z_s, w_s = tr[tracer]
        cats[tracer] = [
            (halo_g['x'] + half, halo_g['y'] + half, z_c + half, w_c, plan_h),
            (part_g['x'] + half, part_g['y'] + half, z_s + half, w_s, plan_p),
        ]
        n_gal[tracer] = w_c.sum() + w_s.sum()
    return cats, n_gal


def lc_cats(hod):
    """Per tracer, the light-cone leg's two deposits (centrals and
    satellites at their displaced raw coordinates, in the order of the
    leg's brick stage, with its plans), and n_gal."""
    halo, part, plan_h, plan_p = hod._lc_stage(NMESH, YB)
    tp = hod._tracer_tensors(TRACERS, WANT)
    origin = torch.tensor(LC_ORIGIN, dtype=torch.float32, device=halo['x'].device)
    tr, n_gal = populate_lc_multi(halo, part, tp, WANT, True, _f32(1.0 / VELZ2KMS), origin)
    cats = {t: [(*tr[t][:4], plan_h), (*tr[t][4:], plan_p)] for t in WANT}
    return cats, n_gal


def phase_fused(dev, seg, W):
    state, t_in = sync_seconds(lambda: fused_state(dev))
    print(f'phase 5 inputs {t_in:.3f} s: {N_HALO} halos, {N_PART} particles, '
          f'tracers {WANT}, nmesh {NMESH}, {NBINS_K} k-bins, no cut')
    params = {'z': 0.5, 'Lbox': LBOX, 'velz2kms': VELZ2KMS, 'origin': None}
    box_hod = AbacusHOD(*state, params, TRACERS, dev)
    box = check_fused(
        5, box_hod, lambda: box_hod._box_stage(NMESH, YB), 2 * len(WANT), box_cats, seg, W
    )
    *_, k1_rec = time_k1('fused box (phase 5), 256^3, 6 launches, 3 grids',
                         [box[4][tr] for tr in WANT], NMESH, 'tsc')
    k1_rec.pop('grid')
    box = box[:4] + (k1_rec,)
    params_lc = dict(params, origin=np.array(LC_ORIGIN))
    hod = AbacusHOD(*state, params_lc, TRACERS, dev, halo_lc=True, z_type='lightcone')
    del state
    lc = check_fused(6, hod, lambda: hod._lc_stage(NMESH, YB), 2 * len(WANT), lc_cats, seg, W)
    *_, k1_lc = time_k1('fused light cone (phase 6), 256^3, 6 launches, 3 grids',
                        [lc[4][tr] for tr in WANT], NMESH, 'tsc')
    k1_lc.pop('grid')
    require(k1_lc['overflow_share'] < 0.01, 'light cone: over 1 % of the galaxies left their tile')
    del hod
    return box, lc[:4] + (k1_lc,), box_hod


def mock_columns(mock, dev):
    """Each tracer's run_hod positions as float32 device columns."""
    return {
        tr: [torch.from_numpy(np.ascontiguousarray(d[a], np.float32)).to(dev) for a in 'xyz']
        for tr, d in mock.items()
    }


def plain_power(cols, nmesh, nbins_k, nbins_mu, k_max, paste, compensated, interlaced):
    """compute_power's spectra rebuilt from the plain versions only (the
    27-point scatter, rfftn, the float64 bincount pair binning with the
    plan's pole weights). Returns (clustering-like {pair: spectrum dict},
    fields, scale, W, plan)."""
    kind = paste.lower()
    dev = cols[WANT[0]][0].device

    def field(c, off):
        n = c[0].numel()
        grid = paint_3d_plain(
            torch.zeros((nmesh,) * 3, device=dev), *c, torch.ones(n, device=dev), nmesh, LBOX,
            off, kind,
        )
        return torch.fft.rfftn(grid * _f32(grid.numel() / n) - 1.0)

    d = LBOX / nmesh
    ffts = []
    for tr in WANT:
        if interlaced:
            ffts.append(_interlace_combine(field(cols[tr], 0.0), field(cols[tr], 0.5 * d),
                                           nmesh, LBOX, d))
        else:
            ffts.append(field(cols[tr], 0.0))
    scale = 1.0 if interlaced else 1.0 / nmesh**3
    W = None
    if compensated:
        W = torch.from_numpy(
            get_W_compensated(LBOX, nmesh, paste, interlaced).astype(np.float32)).to(dev)
    kbins, mubins = get_k_mu_edges(LBOX, k_max, nbins_k, nbins_mu, False)
    dk = 2 * np.pi / LBOX
    plan = get_mode_bin_plan(nmesh, ((kbins / dk) ** 2).astype(np.float32),
                             (mubins**2).astype(np.float32), POLES, dev)
    pole_w = {p: plan.pole_w[p] for p in POLES if p}
    sums, psums = bin_pair_modes_plain(ffts, plan.seg, W, scale, plan.nk * plan.nmu, pole_w,
                                       plan.nmu)
    sums = sums.cpu().numpy().reshape(-1, plan.nk, plan.nmu)
    psums = psums.cpu().numpy()
    spectra = {}
    for p, (i, j) in enumerate(field_pairs(len(WANT))):
        spectra[f'{WANT[i]}_{WANT[j]}'] = _spectrum(plan, dk, sums[p], psums[p], LBOX, POLES, True)
    return spectra, ffts, scale, W, plan, pole_w


def check_spectra(tag, cl, ref, tol):
    """compute_power's columns against the plain rebuild: mode counts equal,
    P within tol |P| (autos) or tol sqrt(P_ii P_jj) (crosses), each pole l
    within tol (2l+1) sqrt(P0_ii P0_jj). Returns the worst |d|/scale."""
    worst = 0.0
    for key, P in ref.items():
        t1, t2 = key.split('_')
        require(np.array_equal(cl[key + '_modes'], P['N_mode']), f'{tag} {key} mode counts')
        got = cl[key]
        require(np.isfinite(got).all() and np.isfinite(cl[key + '_ell']).all(), f'{tag} {key}')
        auto = [np.abs(ref[f'{t}_{t}']['power']).astype(np.float64) for t in (t1, t2)]
        scale = np.sqrt(auto[0] * auto[1])
        rel = float(np.max(np.abs(got - P['power']) / np.maximum(scale, 1e-300)))
        m0 = [np.abs(ref[f'{t}_{t}']['binned_poles'][0]).astype(np.float64) for t in (t1, t2)]
        for ip, ell in enumerate(POLES):
            s_l = (2 * ell + 1) * np.sqrt(m0[0] * m0[1])
            d = np.abs(cl[key + '_ell'][:, ip] - P['binned_poles'][ip])
            rel = max(rel, float(np.max(d / np.maximum(s_l, 1e-300))))
        worst = max(worst, rel)
        require(rel <= tol, f'{tag} {key} differs from the plain rebuild by {rel:.3e} (> {tol})')
    return worst


def time_kernels(tag, ffts, scale, W, plan, pole_w, cols, nmesh, kind):
    """K3 (pole form) and K1 (`kind`, each tracer into its own grid, as
    compute_power paints) at the call's shapes against their plain
    versions. Returns (K3's timing record, K1's)."""
    nbins, nmu = plan.nk * plan.nmu, plan.nmu
    args = (ffts, plan.seg, W, scale, nbins, pole_w, nmu)
    k3_ms = event_ms(lambda: bin_pair_modes(*args))
    k3_kernel = kernel_ms(lambda: bin_pair_modes(*args))
    p3_ms = event_ms(lambda: bin_pair_modes_plain(*args))
    npairs = len(ffts) * (len(ffts) + 1) // 2
    got = torch.cat([a.reshape(npairs, -1) for a in bin_pair_modes(*args)], 1)
    ref = torch.cat([a.reshape(npairs, -1) for a in bin_pair_modes_plain(*args)], 1)
    k3_err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / ref.abs().amax(1, keepdim=True)).max())
    del got, ref
    k3_bound, share, lib_ms = k3_extras(ffts, plan.seg, nbins, W, pole_w, nmu)
    k3 = binning_line(f'phase 7 {tag}', f'K3 poles nmu={nmu} ({rel:.3e} of its row),', k3_ms,
                      k3_kernel, p3_ms, k3_err, k3_bound, share, lib_ms)
    k3['library_call'] = LIBRARY_CALL + ' of the (k, mu) rows'
    require(rel <= 1e-5, f'K3 poles nmu={nmu} disagrees with its plain version ({rel:.3e})')
    grids = []
    for tr in WANT:
        c = cols[tr]
        staged, bplan = stage_bricks(c + [torch.ones_like(c[0])], nmesh, LBOX, kind=kind)
        grids.append([(*staged, bplan)])
    k1_ms, p1_ms, k1_err, k1_rec = time_k1(
        f'{tag} {kind} {nmesh}^3, {len(WANT)} launches, {len(WANT)} grids', grids, nmesh, kind,
        check_overflow=0)
    k1_rec.pop('grid')
    print(f'phase 7 {tag}: K1 {kind} {k1_ms:.4f} ms vs plain {p1_ms:.4f} ms (max|d| {k1_err:.3e})')
    k1 = dict(ms=k1_ms, plain_ms=p1_ms, max_abs_err=k1_err, bound_ms=k1_rec['bound_ms'],
              bound_by='bytes', library_ms=None, shapes=[k1_rec])
    return k3, k1


def phase_two_step(hod, n_gal5, cl5):
    """Phase 7: run_hod -> compute_power on the phase-5 object (same
    randoms). Returns ({path: launches}, {form: timing record}, the mock)."""
    dev = hod.device
    paths, timing = {}, {}
    spans = mode_spans.builds

    # (a) run_hod
    reset_launches()
    mock, t_cold = sync_seconds(lambda: hod.run_hod(want_rsd=True))
    best = float('inf')
    for _ in range(3):
        mock = None
        mock, dt = sync_seconds(lambda: hod.run_hod(want_rsd=True))
        best = min(best, dt)
    paths['AbacusHOD.run_hod'] = read_launches()
    counts = {tr: len(mock[tr]['x']) for tr in WANT}
    print(f'phase 7 (a) run_hod: cold {t_cold:.3f} s, best of 3 {best:.3f} s host to host, '
          f'galaxies {counts}, centrals {({tr: mock[tr]["Ncent"] for tr in WANT})}')
    for tr in WANT:
        td = mock[tr]
        require(counts[tr] == n_gal5[tr], f'{tr}: run_hod {counts[tr]} != fused n_gal {n_gal5[tr]}')
        require(td['id'].dtype == np.int64 and 0 < td['Ncent'] <= counts[tr], f'{tr} catalog')
        for k in ('x', 'y', 'z', 'vx', 'vy', 'vz', 'mass'):
            require(len(td[k]) == counts[tr] and np.isfinite(td[k]).all(), f'{tr} {k}')
        require(np.abs(td['z']).max() <= LBOX / 2, f'{tr} z outside the box')
    cols = mock_columns(mock, dev)

    # (b) compute_power at the docs/hod.md settings, 550^3
    def docs_call():
        return hod.compute_power(mock, DOCS_NBINS_K, 1, DOCS_KMAX, False, poles=POLES,
                                 num_cells=DOCS_NMESH)

    builds = get_mode_bin_plan.builds
    reset_launches()
    cl_b, t_cold = sync_seconds(docs_call)
    plan_builds = get_mode_bin_plan.builds - builds
    best = float('inf')
    for _ in range(3):
        best = min(best, sync_seconds(docs_call)[1])
    launches = read_launches()
    paths['AbacusHOD.compute_power (docs/hod.md settings)'] = launches
    print(f'phase 7 (b) compute_power nmesh {DOCS_NMESH}, {DOCS_NBINS_K} k-bins to {DOCS_KMAX}, '
          f'poles {POLES}: cold {t_cold:.3f} s ({plan_builds} plan build), warm best of 3 '
          f'{best:.3f} s, launches {launches}, K1 overflow word '
          f'{int(hod.deposit_overflow.item())}')
    require(plan_builds == 1, f'{plan_builds} plan builds in the cold call')
    require(launches['tsc_deposit_cells[tsc]'] == 3 * 4, f'K1 launches {launches}')
    require(launches['bin_pair_modes[poles nmu=1]'] == 4, f'K3 launches {launches}')
    require(int(hod.deposit_overflow.item()) == 0, 'K1 overflow word')
    ref, ffts, scale, W, plan, pole_w = plain_power(
        cols, DOCS_NMESH, DOCS_NBINS_K, 1, DOCS_KMAX, 'TSC', False, False)
    worst = check_spectra('(b)', cl_b, ref, 1e-4)
    print(f'phase 7 (b) plain rebuild agrees: worst |d|/scale {worst:.3e} (<= 1e-4)')
    timing['bin_pair_modes[poles nmu=1]'], k1_550 = time_kernels(
        '(b)', ffts, scale, W, plan, pole_w, cols, DOCS_NMESH, 'tsc')
    timing['k1 shapes'] = k1_550['shapes']
    del ffts

    # the device plan build against the numpy host build, at 550
    ke2 = ((get_k_mu_edges(LBOX, DOCS_KMAX, DOCS_NBINS_K, 1, False)[0]
            / (2 * np.pi / LBOX)) ** 2).astype(np.float32)
    me2 = np.array([0.0, 1.0], np.float32)
    def build():
        return mode_bin_plan_device(DOCS_NMESH, ke2, me2, POLES, dev)

    plan_dev, t_dev = sync_seconds(build)
    t_dev = min(t_dev, sync_seconds(build)[1])
    t0 = time.perf_counter()
    seg_np, counts_np = mode_bin_plan(DOCS_NMESH, ke2, me2)
    t_host = time.perf_counter() - t0
    same = (np.array_equal(plan_dev[0].cpu().numpy(), seg_np)
            and np.array_equal(plan_dev[1].cpu().numpy(), counts_np))
    print(f'phase 7 (b) plan build at {DOCS_NMESH}^3 ({seg_np.size} modes, poles {POLES}): device '
          f'{t_dev:.4f} s, numpy host build (seg, counts) {t_host:.3f} s, bit-equal {same}')
    require(same, 'the device plan differs from the numpy build')
    timing['mode_bin_plan_device'] = dict(ms=t_dev * 1e3, plain_ms=t_host * 1e3)
    del plan_dev, seg_np, counts_np

    # (c) nmesh 256, compensated, against phase 5's fused spectra
    reset_launches()
    kmax = np.pi * NMESH / LBOX
    cl_c, t_c = sync_seconds(lambda: hod.compute_power(
        mock, NBINS_K, 1, kmax, False, num_cells=NMESH, compensated=True))
    launches = read_launches()
    paths['AbacusHOD.compute_power (nmesh 256, compensated)'] = launches
    require(launches['tsc_deposit_cells[tsc]'] == 3, f'K1 launches {launches}')
    require(launches['bin_pair_modes[no poles]'] == 1, f'K3 launches {launches}')
    worst = 0.0
    for i, t1 in enumerate(WANT):
        for t2 in WANT[i:]:
            key = f'{t1}_{t2}'
            good = cl_c[key + '_modes'] > 0
            require(np.array_equal(cl_c[key + '_modes'], cl5[key + '_modes']), f'(c) {key} modes')
            rel = np.abs(cl5[key][good] - cl_c[key][good]) / np.abs(cl_c[key][good])
            worst = max(worst, float(rel.max()))
    print(f'phase 7 (c) compute_power nmesh {NMESH} compensated {t_c:.3f} s vs phase 5 '
          f'run_hod_pk_fused: worst rel {worst:.3e} (<= 2e-3), launches {launches}')
    require(worst <= 2e-3, f'(c) the two routes differ by {worst:.3e}')

    # (d) TSC and CIC, interlaced, compensated, 4 mu bins, poles
    for paste in ('TSC', 'CIC'):
        kind = paste.lower()
        reset_launches()
        cl_d, t_d = sync_seconds(lambda: hod.compute_power(
            mock, NBINS_K, 4, kmax, False, poles=POLES, paste=paste, num_cells=NMESH,
            compensated=True, interlaced=True))
        launches = read_launches()
        paths[f'AbacusHOD.compute_power ({paste}, interlaced, 4 mu bins)'] = launches
        over = int(hod.deposit_overflow.item())
        require(launches[f'tsc_deposit_cells[{kind}]'] == 6, f'K1 launches {launches}')
        require(launches['bin_pair_modes[poles nmu=4]'] == 1, f'K3 launches {launches}')
        require(over == 0, f'K1 overflow word {over}')
        ref, ffts, scale, W, plan, pole_w = plain_power(cols, NMESH, NBINS_K, 4, kmax, paste,
                                                        True, True)
        worst = check_spectra(f'(d) {paste}', cl_d, ref, 1e-4)
        inv = 0.0
        for tr in WANT:
            key = f'{tr}_{tr}'
            P, N = cl_d[key], cl_d[key + '_modes']
            ok = N.sum(axis=1) > 0
            band = (P * N).sum(axis=1)[ok] / N.sum(axis=1)[ok]
            inv = max(inv, float(np.max(np.abs(cl_d[key + '_ell'][ok, 0] - band) / np.abs(band))))
        print(f'phase 7 (d) {paste}: {t_d:.3f} s a call, K1 overflow word {over}, worst '
              f'|d|/scale vs plain {worst:.3e}, monopole vs band mean {inv:.3e} (<= 1e-5), '
              f'launches {launches}')
        require(inv <= 1e-5, f'(d) {paste} monopole != band mean ({inv:.3e})')
        k3, k1 = time_kernels(f'(d) {paste}', ffts, scale, W, plan, pole_w, cols, NMESH, kind)
        timing['bin_pair_modes[poles nmu=4]'] = k3
        if kind == 'cic':
            timing['tsc_deposit_cells[cic]'] = k1
            timing['k1 shapes'] += k1['shapes']
        del ffts

    # (e) the cold run_hod_pk_fused at nmesh 512: its plan on the device, once
    del cols
    builds = make_bin_plan_arrays.builds
    reset_launches()
    _, t_cold = sync_seconds(lambda: hod.run_hod_pk_fused(nmesh=COLD_NMESH))
    b1 = make_bin_plan_arrays.builds - builds
    _, t_warm = sync_seconds(lambda: hod.run_hod_pk_fused(nmesh=COLD_NMESH))
    b2 = make_bin_plan_arrays.builds - builds - b1
    paths['AbacusHOD.run_hod_pk_fused (nmesh 512, cold)'] = read_launches()
    seg512, _ = make_bin_plan_arrays(COLD_NMESH, LBOX, COLD_NMESH // 2, dev)
    ke2 = ((get_k_mu_edges(LBOX, np.pi * COLD_NMESH / LBOX, COLD_NMESH // 2, 1, False)[0]
            / (2 * np.pi / LBOX)) ** 2).astype(np.float32)
    _, t_plan = sync_seconds(lambda: mode_bin_plan_device(COLD_NMESH, ke2, me2, (), dev))
    t0 = time.perf_counter()
    mode_bin_plan(COLD_NMESH, ke2, me2)
    t_host = time.perf_counter() - t0
    print(f'phase 7 (e) run_hod_pk_fused nmesh {COLD_NMESH}: cold {t_cold:.3f} s (restage + '
          f'{b1} plan build on {seg512.device}), second call {t_warm:.3f} s ({b2} builds); plan '
          f'build alone on the device {t_plan:.4f} s, numpy host build {t_host:.3f} s')
    require(b1 == 1 and b2 == 0 and seg512.device == dev, 'plan builds at 512')
    require(mode_spans.builds == spans, 'the two-step route built row spans')
    return paths, timing, mock


def kernel_line(paths, timing):
    """The kernels JSON: per kernel and form its launches on each main path
    (summed in `launches`), its time against its plain version, its bound
    and a library call's time (null where no PyTorch call computes the same
    function)."""
    out = []
    for form, (name, key, replaces) in FORMS.items():
        col = name if key is None else form
        by_path = {path: launches[col] for path, launches in paths.items()}
        t = timing[form]
        require(sum(by_path.values()) > 0, f'no main path launched {form}')
        out.append({
            'name': form, 'route': 'cuda', 'source': KERNELS[name][1], 'replaces': replaces,
            'launches': sum(by_path.values()), 'launches_by_path': by_path,
            'max_abs_err': t['max_abs_err'], 'ms': t['ms'], 'plain_ms': t['plain_ms'],
            'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'], 'library_ms': t['library_ms'],
            **{k: t[k] for k in ('kernel_ms', 'in_bin_share', 'library_call', 'shape', 'shapes',
                                  'plain_shape', 'total_ms', 'registers', 'spill_stores',
                                  'spill_loads', 'f64_bound_ms', 'filtered_bound_ms',
                                  'full_bound_ms', 'plan_build_ms')
               if k in t},
        })
    return {'kernels': out}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    roots = []
    try:
        phase_build()
        seg, _ = make_bin_plan_arrays(NMESH, LBOX, NBINS_K, dev)
        W = get_W_compensated(LBOX, NMESH, 'TSC', False).astype(np.float32)
        W = torch.from_numpy(W).to(dev)
        grid = phase_k1(dev)
        phase_k2(grid, seg, W)
        del grid
        phase_pair_kernels(dev)
        step_launches, timing = phase_step(dev, seg, W)
        timing['tsc_deposit_cells[tsc]'] = timing.pop('tsc_deposit_cells')
        box, lc, hod = phase_fused(dev, seg, W)
        timing['bin_pair_modes[no poles]'] = box[1]
        timing['tsc_deposit_cells[tsc]']['shapes'] += [box[4], lc[4]]
        print(f'K3 at the light-cone call shapes: {lc[1]["ms"]:.4f} ms vs plain '
              f'{lc[1]["plain_ms"]:.4f} ms')
        del seg, W
        paths7, timing7, mock = phase_two_step(hod, box[3], box[2])
        shapes7 = timing7.pop('k1 shapes')
        timing['tsc_deposit_cells[tsc]']['shapes'].append(shapes7[0])
        timing.update(timing7)
        timing['tsc_deposit_cells[cic]']['shapes'] = shapes7[1:]
        paths8, timing8 = phase_pairs(hod, mock)
        timing.update(timing8)
        mock14 = {tr: {a: mock[tr][a] for a in ('x', 'y', 'z', 'vz')} for tr in WANT}
        halo5 = hod.halo_data  # phase 15's NFW catalog
        del hod, mock
        chain_share = phase_prep_kernels(dev)
        paths10 = {}
        t10 = time.perf_counter()
        phase_ranks(dev, paths10, timing, chain_share)
        menv_recs = phase_menv(dev, paths10)
        shearmark, k1_rec = phase_shear(dev, paths10)
        timing['tsc_deposit_cells[tsc]']['shapes'].append(k1_rec)
        print(f'phase 10 in {time.perf_counter() - t10:.1f} s')
        # K7's kernels-line entry: the box's time at its main path's shape,
        # the plain version's on the sampled centres of that shape
        top = menv_recs[0]
        timing['menv_annulus'] = dict(
            ms=top['ms'], plain_ms=top['plain_sample_ms'], max_abs_err=top['max_abs_err'],
            bound_ms=top['bound_ms'], bound_by=top['bound_by'], library_ms=None,
            shape=top['shape'], plain_shape=f'{N_MENV_SAMPLE} sampled centres of {top["shape"]}',
            shapes=menv_recs)
        t11 = time.perf_counter()
        phase_slab(paths10, shearmark, dev)
        print(f'phase 11 in {time.perf_counter() - t11:.1f} s; seg_rank (two stable sorts, no '
              f'kernel) called {sum(p.get("seg_rank", 0) for p in paths10.values())} times on the '
              f'main paths of phases 10-11')
        del shearmark
        timing['tsc_deposit_cells[tsc multi-weight]'], timing['window_mode_sums'] = (
            phase_zcv_kernels(dev))
        paths13 = {}
        cell = phase_zcv(dev, paths13, timing)
        paths14 = {}
        phase_surface(mock14, dev, paths14, timing)
        del mock14
        t15 = time.perf_counter()
        paths15 = {}
        phase_cv_field(dev, cell, paths15)
        tpl13 = (cell['zcv'].templates, cell['zcv'].k_binc, cell['config']['zcv_params']['kcut'])
        del cell
        phase_nfw(dev, halo5)
        del halo5
        print(f'phase 15 in {time.perf_counter() - t15:.1f} s')
        paths16 = {}
        roots.append(Path(tempfile.mkdtemp(prefix='chip_smoke_disk_')))
        disk16 = phase_disk(dev, paths16, roots[-1])
        paths17 = {}
        roots.append(Path(tempfile.mkdtemp(prefix='chip_smoke_lc_')))
        cfg17 = phase_lc_disk(dev, paths17, roots[-1])
        paths18 = {}
        phase_zcv_disk(dev, paths18, tpl13)
        del tpl13
        paths19 = {}
        phase_scripts(dev, paths19, disk16, cfg17)
        kernels = kernel_line({
            'hod_pk_fused_yb': step_launches,
            'AbacusHOD.run_hod_pk_fused': box[0],
            'AbacusHOD.run_hod_pk_fused (light cone)': lc[0],
            **paths7,
            **paths8,
            **paths10,
            **paths13,
            **paths14,
            **paths15,
            **paths16,
            **paths17,
            **paths18,
            **paths19,
        }, timing)
        require(mode_spans.builds == 0, f'{mode_spans.builds} row-span builds outside a plan')
    except PhaseError as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        return 1
    finally:
        # phases 16 and 17 leave their trees for phase 19's scripts
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    print(f'chip_smoke: phases 1-19 in {time.perf_counter() - t_start:.1f} s, row-span builds '
          f'outside a plan {mode_spans.builds}')
    print(json.dumps(kernels))
    print(json.dumps({
        'ok': True,
        'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
