r"""The sharded HOD -> P(k) pipeline, P(k) and pair counts over a device mesh
(the counterpart of abacusutils_tpu/parallel/mesh.py).

JAX runs one controller that places global arrays on a ``Mesh`` and runs
``shard_map``; here each rank is a process with one device (SPMD), and the
mesh is a 1-D ``torch.distributed`` ``DeviceMesh`` over the world
(:func:`make_mesh`): NCCL on the card, gloo for CPU ranks.

- Inputs: every rank calls an entry point with the same global host inputs
  (as every rank of a ``torchrun`` job reads the same files) and uploads
  only its own shard: a contiguous block of rows (:func:`shard_particles`,
  :func:`row_block`), or the points whose x cell lies in its x-slab of the
  grid (:func:`stage_grouped2d_sharded`).
- Outputs: what JAX returns replicated (spectra, counts, n_gal) is the same
  on every rank, bit for bit: the sums meet in one ``all_reduce``, and every
  rank then does the same arithmetic on the same values.
- Collectives: the deposits meet in an ``all_reduce`` (JAX's ``psum``), the
  ELG conformity codes in an int8 ``all_gather``, the slab FFT's transpose is
  one ``all_to_all_single`` and its halo planes go by ring shifts
  (:func:`ring_shift`, ``parallel/fft.py``).

The deposit is K1 (``ops/grid.py:tsc_deposit_cells``, its slab mode for the
x-slab grids), the binning K2 / K3 (``ops/power.py``, over a ky slab for the
sharded spectra), the pair counts K5 with a global row offset
(``ops/tpcf.py:count_pairs_all(row0=)``).
"""

import os
import tempfile
from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.grid import RSD_MARGIN, _cells, _f32, brick_shape, stage_bricks, tsc_deposit_cells

__all__ = [
    'init_world',
    'make_mesh',
    'mesh_size',
    'mesh_rank',
    'mesh_device',
    'all_reduce',
    'all_gather_rows',
    'ring_shift',
    'LocalSlab',
    'row_block',
    'shard_particles',
    'x_stripes',
    'stage_grouped2d_sharded',
    'ShardedStage',
    'group_inputs2d_linked_sharded',
    'sharded_hod_pk',
    'hod_pk_fused_sharded',
    'calc_power_sharded',
    'pair_counts_rppi_sharded',
    'pair_counts_smu_sharded',
]

# how long a collective waits for the other ranks before it raises, so a
# rank that fails does not leave the others hanging
TIMEOUT = timedelta(seconds=300)


def init_world(rank, world_size, init_method, device_type='cuda', local_rank=None):
    """Join the default process group as `rank` of `world_size` (NCCL for
    'cuda', with this process's card set first: ``local_rank``, by default
    rank modulo the cards; gloo for 'cpu'). init_method: 'env://' (torchrun),
    'tcp://host:port' or 'file:///path'. Collectives raise after TIMEOUT."""
    if device_type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('init_world: no CUDA device for an NCCL world')
        local = rank % torch.cuda.device_count() if local_rank is None else int(local_rank)
        torch.cuda.set_device(local)
        backend = 'nccl'
    elif device_type == 'cpu':
        backend = 'gloo'
    else:
        raise ValueError(f'device_type must be cuda or cpu, not {device_type!r}')
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=TIMEOUT)


def make_mesh(device_type='cuda', axis='data'):
    """The 1-D ``DeviceMesh`` of the world along `axis` (the counterpart of
    ``make_mesh``). Joins a process group first where there is none: the
    ``torchrun`` world from its environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR), else a world of this process alone. 'cuda' (the default)
    raises without a card and on a process group that is not NCCL's; 'cpu'
    is a gloo mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('make_mesh: no CUDA device; pass device_type="cpu" for gloo ranks')
    if not dist.is_initialized():
        if 'RANK' in os.environ:
            init_world(int(os.environ['RANK']), int(os.environ['WORLD_SIZE']), 'env://',
                       device_type, os.environ.get('LOCAL_RANK'))
        else:
            store = os.path.join(tempfile.mkdtemp(prefix='abacus_world_'), 'store')
            init_world(0, 1, f'file://{store}', device_type)
    backend = dist.get_backend()
    if (device_type == 'cuda') != (backend == 'nccl'):
        raise RuntimeError(f'a {device_type} mesh needs the '
                           f'{"nccl" if device_type == "cuda" else "gloo"} backend, not {backend}')
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def _group(mesh):
    return mesh.get_group(0)


def mesh_size(mesh):
    """Ranks along the mesh's axis."""
    return mesh.size(0)


def mesh_rank(mesh):
    """This process's rank along the mesh's axis."""
    return mesh.get_local_rank(0)


def mesh_device(mesh):
    """The device this rank computes on: its card, or the CPU."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _check_tensor(t, mesh):
    if t.device.type != mesh.device_type:
        raise ValueError(f'a {t.device.type} tensor on a {mesh.device_type} mesh: nothing is '
                         'staged through the host')


def all_reduce(t, mesh):
    """Sum `t` over the ranks in place (complex through its real view);
    returns `t`, the same on every rank."""
    _check_tensor(t, mesh)
    if mesh_size(mesh) > 1:
        dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t, group=_group(mesh))
    return t


def all_gather_rows(t, mesh):
    """The ranks' equal-shaped tensors `t` concatenated along dim 0 in rank
    order (JAX's ``all_gather(tiled=True)``)."""
    _check_tensor(t, mesh)
    n = mesh_size(mesh)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=_group(mesh))
    return torch.cat(parts, 0)


def ring_shift(t, step, mesh):
    """`t` of the rank `step` places before this one along the ring (rank r
    sends to r + step and receives from r - step): one ``all_to_all_single``
    whose splits are non-zero for one peer only, so no rank sends to itself.
    The ranks' tensors have one shape. Needs two ranks or more."""
    _check_tensor(t, mesh)
    n, r = mesh_size(mesh), mesh_rank(mesh)
    if n < 2 or step % n == 0:
        raise ValueError(f'a ring shift of {step} on {n} ranks sends to itself')
    flat = t.contiguous().reshape(-1)
    real = flat.is_complex()
    src = torch.view_as_real(flat).reshape(-1) if real else flat
    out = torch.empty_like(src)
    send = [0] * n
    recv = [0] * n
    send[(r + step) % n] = src.numel()
    recv[(r - step) % n] = src.numel()
    dist.all_to_all_single(out, src, recv, send, group=_group(mesh))
    if real:
        out = torch.view_as_complex(out.reshape(-1, 2))
    return out.reshape(t.shape)


class LocalSlab(NamedTuple):
    """This rank's piece of a sharded array: `local`, its rows along the
    sharded axis, and `offset`, the global index of the first."""

    local: torch.Tensor
    offset: int


def row_block(n, mesh):
    """(begin, end) of this rank's contiguous block of `n` rows: blocks of
    ceil(n / ranks), the last ones short or empty (JAX pads them)."""
    per = -(-n // mesh_size(mesh))
    r = mesh_rank(mesh)
    return min(r * per, n), min((r + 1) * per, n)


def _cpu_tensor(a):
    """A host column as a CPU tensor (numpy is shared, not copied)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows_to(a, rows, device, dtype=None):
    """Rows `rows` (a CPU int64 index, or a (begin, end) slice) of column `a`
    (numpy or tensor) on `device`: float columns as float32, others as they
    are unless `dtype` is given; only these rows are copied."""
    if isinstance(rows, tuple):
        sel = _cpu_tensor(a)[rows[0]:rows[1]] if isinstance(a, torch.Tensor) else (
            torch.from_numpy(np.ascontiguousarray(np.asarray(a)[rows[0]:rows[1]])))
    elif isinstance(a, torch.Tensor):
        sel = a.index_select(0, rows.to(a.device))
    else:
        sel = torch.from_numpy(np.asarray(a)[rows.cpu().numpy()])
    if dtype is None:
        dtype = torch.float32 if sel.is_floating_point() else sel.dtype
    return sel.to(device=device, dtype=dtype).contiguous()


def shard_particles(mesh, arrays):
    """This rank's block of rows (:func:`row_block`) of each column of
    `arrays` on its device, padded to ceil(n / ranks) rows as JAX pads:
    ``randoms`` with 2.0 (above every marker, so a padded row populates
    nothing), every other column with 0.0. Float columns become float32."""
    dev = mesh_device(mesh)
    out = {}
    for k, v in arrays.items():
        n = len(v)
        per = -(-n // mesh_size(mesh))
        t = _rows_to(v, row_block(n, mesh), dev)
        if t.shape[0] < per:
            fill = 2.0 if k == 'randoms' else 0.0
            pad = torch.full((per - t.shape[0],) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                             device=dev)
            t = torch.cat([t, pad])
        out[k] = t
    return out


def _xl(nmesh, mesh, slab):
    """Planes an x-slab holds; raises as JAX does where the mesh does not
    split nmesh into whole slabs (of two planes or more, for slabs)."""
    n = mesh_size(mesh)
    if nmesh % n:
        raise ValueError(f'nmesh={nmesh} must be divisible by the {n}-rank mesh so shards hold '
                         'whole x-slabs of cells')
    if slab and nmesh < 2 * n:
        raise ValueError(f'slab x-slabs need >= 2 planes per rank (nmesh={nmesh}, ranks={n}) for '
                         'the TSC halo exchange')
    return nmesh // n


def x_stripes(x, nmesh, box, xl, shift=0.0):
    """The x-slab (cell // xl) of each coordinate of `x` (numpy or tensor),
    from K1's f32 cell of x + shift wrapped once (``ops/grid.py:_cells``,
    bit for bit): every point goes to the rank whose planes hold its cell.
    Computed where `x` lies (numpy on the CPU). Returns an int64 tensor."""
    x = _cpu_tensor(x).to(torch.float32)
    return torch.div(_cells(x, nmesh, box, 0.0, shift, True), xl, rounding_mode='floor').long()


def stage_grouped2d_sharded(mesh, cols, nmesh, box, yb=None, shift=0.0, xi=0, yi=1, zi=2,
                            slab=False):
    """Shard-local staging (the counterpart of ``stage_grouped2d_sharded``):
    bucket the rows of `cols` (numpy or tensors, the same on every rank) by
    the x-slab of their cell (:func:`x_stripes` of cols[xi] + shift), upload
    this rank's rows alone and stage them by brick (``ops/grid.py:
    stage_bricks``, a z margin of RSD_MARGIN cells for the RSD move after
    staging, bricks of y extent `yb`). slab=True stages for K1's slab mode: the bricks tile the
    rank's xl + 2 planes (one halo plane a side). Returns (staged columns,
    BrickPlan, rows): rows is the CPU int64 global index of each staged row,
    in the staged order."""
    xl = _xl(nmesh, mesh, slab)
    r = mesh_rank(mesh)
    rows = torch.nonzero(x_stripes(cols[xi], nmesh, box, xl, shift) == r).reshape(-1)
    dev = mesh_device(mesh)
    local = [_rows_to(c, rows, dev) for c in cols]
    margin = (0, 0, RSD_MARGIN)
    staged, plan, order = stage_bricks(
        local, nmesh, box, brick_shape(nmesh, yb, margin), margin, shift=shift, xi=xi, yi=yi,
        zi=zi, return_order=True, slab=(r * xl, 1, xl + 2) if slab else None,
    )
    return staged, plan, rows[order.cpu()]


class ShardedStage(NamedTuple):
    """The shard-local stage of a linked halo and particle catalog: this
    rank's staged halo_g / part_g dicts and BrickPlans; part_g['hkeep_at']
    is each particle's host slot in the concatenation of the ranks' staged
    halos, each padded to `nhalo_max` slots (the int8 conformity gather);
    `slab` tells whether the plans are K1 slab-mode plans."""

    halo_g: dict
    part_g: dict
    plan_h: object
    plan_p: object
    nhalo_max: int
    slab: bool


def group_inputs2d_linked_sharded(halo, part, nmesh, lbox, mesh, yb=None, slab=False):
    """Both catalogs staged shard-locally (:func:`stage_grouped2d_sharded`,
    box-centred: shift lbox / 2) plus the conformity link (the counterpart
    of models/pipeline.py:group_inputs2d_linked_sharded): a global map from
    each halo to its slot, rank x nhalo_max + its staged index, built as
    JAX's build_flat_pos builds it (each rank scatters its halos' slots, the
    map meets in an all_reduce), then read at part['hidx'] for this rank's
    particles. halo / part: dicts of numpy columns or tensors with x, y, z
    (part with 'hidx'), the same on every rank. Returns a
    :class:`ShardedStage`."""
    xl = _xl(nmesh, mesh, slab)
    dev = mesh_device(mesh)
    hkeys = list(halo)
    h_cols, plan_h, h_rows = stage_grouped2d_sharded(
        mesh, [halo[k] for k in hkeys], nmesh, lbox, yb, lbox / 2,
        hkeys.index('x'), hkeys.index('y'), hkeys.index('z'), slab)
    n_halo = len(halo['x'])
    counts = torch.bincount(x_stripes(halo['x'], nmesh, lbox, xl, lbox / 2),
                            minlength=mesh_size(mesh))
    nhalo_max = max(int(counts.max()), 1)
    slots = torch.zeros(n_halo, dtype=torch.int32, device=dev)
    slots[h_rows.to(dev)] = (mesh_rank(mesh) * nhalo_max
                             + torch.arange(len(h_rows), dtype=torch.int32, device=dev))
    all_reduce(slots, mesh)
    pkeys = [k for k in part if k != 'hidx'] + ['hidx']
    p_cols, plan_p, p_rows = stage_grouped2d_sharded(
        mesh, [part[k] for k in pkeys], nmesh, lbox, yb, lbox / 2,
        pkeys.index('x'), pkeys.index('y'), pkeys.index('z'), slab)
    part_g = dict(zip(pkeys, p_cols))
    part_g['hkeep_at'] = slots[part_g.pop('hidx').long()]
    del slots, p_rows
    return ShardedStage(dict(zip(hkeys, h_cols)), part_g, plan_h, plan_p, nhalo_max, slab)


def sharded_hod_pk(mesh, halo, part, params, kedges2, muedges2, lbox, velz2kms, nmesh, nbins_k,
                   rsd=True):
    """The single-tracer (LRG) step with the halos and particles in row
    blocks over the mesh (``sharded_hod_pk``): each rank populates its rows
    (:func:`shard_particles`; padded rows carry randoms 2.0 and populate
    nothing), stages and deposits them into a full grid with K1, the grids
    meet in an all_reduce, and every rank takes the rfftn and bins it with
    K2. params: the LRG parameters as 0-d float32 tensors on the rank's
    device. Returns (wsum (nbins_k,) f32, counts (nbins_k,) f64 numpy, n_gal),
    the same on every rank."""
    from ..ops.power import bin_power_modes, get_mode_bin_plan
    from ..models.pipeline import populate_weights

    dev = mesh_device(mesh)
    plan = get_mode_bin_plan(int(nmesh), kedges2, muedges2, (), dev)
    inv_velz2kms = _f32(np.float32(1.0) / np.float32(velz2kms))
    z_c, keep_c, z_s, keep_s = populate_weights(halo, part, params, rsd, inv_velz2kms)
    n_gal = all_reduce((keep_c.sum() + keep_s.sum()).reshape(1), mesh)[0]
    half = _f32(np.float32(lbox) / 2)
    grid = torch.zeros((nmesh,) * 3, dtype=torch.float32, device=dev)
    for cat, z, keep in ((halo, z_c, keep_c), (part, z_s, keep_s)):
        cols = [cat['x'] + half, cat['y'] + half, z + half, keep]
        (x, y, zz, w), bplan = stage_bricks(cols, int(nmesh), lbox)
        tsc_deposit_cells(grid, x, y, zz, w, bplan, lbox)
    all_reduce(grid, mesh)
    delta_k = torch.fft.rfftn(grid * (grid.numel() / n_gal) - 1.0)
    wsum = bin_power_modes(delta_k, plan.seg, None, 1.0 / grid.numel(), plan.nk * plan.nmu)
    return wsum, plan.counts.reshape(-1), n_gal


def _fused_slab_bins(mesh, nmesh, lbox, nbins_k):
    """This rank's ky-slab monopole plan of the fused slab step (the k edges
    of models/pipeline.py:make_bin_plan_arrays) and the full mesh's mode
    counts, the sum of the ranks' (an all_reduce): (plan, yslab, counts)."""
    from ..ops.power import get_k_mu_edges, get_mode_bin_plan

    dev = mesh_device(mesh)
    kedges, muedges = get_k_mu_edges(lbox, np.pi * nmesh / lbox, nbins_k, 1, False)
    dk = 2 * np.pi / lbox
    yl = nmesh // mesh_size(mesh)
    yslab = (mesh_rank(mesh) * yl, (mesh_rank(mesh) + 1) * yl)
    plan = get_mode_bin_plan(int(nmesh), ((kedges / dk) ** 2).astype(np.float32),
                             (muedges**2).astype(np.float32), (), dev, yslab)
    counts = all_reduce(torch.from_numpy(plan.counts.reshape(-1).copy()).to(dev), mesh)
    return plan, yslab, counts.cpu().numpy()


def hod_pk_fused_sharded(mesh, stage, params, seg, Wcomp, lbox, velz2kms, want, nmesh, nbins_k,
                         rsd=True, overflow=None):
    """The multi-tracer fused step (models/pipeline.py:hod_pk_fused_multi)
    over the mesh (``hod_pk_fused_sharded``), on a :class:`ShardedStage`:
    each rank populates its x-slab of cells, and two collectives a tracer
    cross ranks besides the ELG conformity codes' int8 all_gather.

    stage.slab False: each rank deposits into a full nmesh^3 grid, the grids
    meet in an all_reduce, and every rank takes the rfftn and bins every pair
    with K3 on `seg` (the full plan's). stage.slab True: the grid stays
    sharded: K1's slab mode deposits into the rank's xl + 2 planes (halos
    bucket by their own cell, so one halo plane a side), one-plane ring
    shifts fold the halos (``parallel/fft.py:fold_halos``), the rfftn is the
    all-to-all transpose ``slab_rfftn``, K3 bins the rank's ky rows with the
    window's W[y0 + iy], and the bin sums meet in an all_reduce; `seg` is
    not used. params: tracer -> 0-d float32 parameter tensors on the rank's
    device; Wcomp: the (nmesh,) window or None; overflow: K1's overflow word
    (this rank's galaxies).

    Returns ({(t1, t2): (nbins_k,) f64 wsum}, {tracer: n_gal}, counts), the
    same on every rank; counts is the full mesh's (nbins_k,) mode counts in
    slab mode (the sum of the ranks' ky-slab plans), None otherwise."""
    from ..models.hod.population import _cent_codes, _sat_codes
    from ..models.pipeline import _delta_k, _pair_spectra, _tracer_zw
    from ..ops.power import bin_pair_modes, field_pairs
    from .fft import fold_halos, slab_rfftn

    slab = stage.slab
    xl = _xl(nmesh, mesh, slab)
    dev = mesh_device(mesh)
    halo_g, part_g = stage.halo_g, stage.part_g
    inv_velz2kms = _f32(np.float32(1.0) / np.float32(velz2kms))
    keep_c = _cent_codes(halo_g, params, want)
    # conformity: a particle's host halo may sit in another rank's slab
    glob = torch.zeros(stage.nhalo_max, dtype=torch.int8, device=dev)
    glob[:keep_c.numel()] = keep_c
    glob = all_gather_rows(glob, mesh)
    keep_s = _sat_codes(part_g, params, want, glob, host_at=part_g['hkeep_at'])
    del glob
    tr = _tracer_zw(halo_g, part_g, params, want, rsd, inv_velz2kms, keep_c, keep_s)
    half = _f32(np.float32(lbox) / 2)
    xy = [(halo_g['x'] + half, halo_g['y'] + half, stage.plan_h),
          (part_g['x'] + half, part_g['y'] + half, stage.plan_p)]
    fault = torch.zeros(1, dtype=torch.int32, device=dev) if slab else None
    shape = (xl + 2, nmesh, nmesh) if slab else (nmesh,) * 3
    gsize = _f32(float(nmesh) ** 3)
    ngs = all_reduce(torch.stack([tr[t][1].sum() + tr[t][3].sum() for t in want]), mesh)
    n_gal = dict(zip(want, ngs.unbind(0)))
    deltas = []
    for tracer in want:
        z_c, w_c, z_s, w_s = tr.pop(tracer)
        grid = torch.zeros(shape, dtype=torch.float32, device=dev)
        for (x, y, plan), z, w in zip(xy, (z_c, z_s), (w_c, w_s)):
            tsc_deposit_cells(grid, x, y, z + half, w, plan, lbox, 0.0, overflow, fault=fault)
        if slab:
            core = fold_halos(grid, 1, mesh)
            deltas.append(slab_rfftn(core * (gsize / n_gal[tracer]) - 1.0, mesh))
        else:
            deltas.append(_delta_k(all_reduce(grid, mesh), n_gal[tracer]))
        del grid
    if not slab:
        return _pair_spectra(deltas, want, seg, Wcomp, nmesh, nbins_k), n_gal, None
    if int(fault):
        raise ValueError(f'{int(fault)} galaxies have clouds outside their rank\'s x-slab')
    plan, yslab, counts = _fused_slab_bins(mesh, nmesh, lbox, nbins_k)
    wsum = bin_pair_modes(deltas, plan.seg, Wcomp, 1.0 / nmesh**3, nbins_k, yslab=yslab)
    all_reduce(wsum, mesh)
    pairs = [(want[i], want[j]) for i, j in field_pairs(len(want))]
    return dict(zip(pairs, wsum.unbind(0))), n_gal, counts


def _assemble_power_output(wsum, psums, counts, ksum, kedges, poles, lbox, dk, nbins_k,
                           nbins_mu):
    """Host-side normalization shared by the replicated and slab paths
    (parallel/mesh.py:_assemble_power_output); calc_power's columns."""
    counts = np.asarray(counts, np.float64).reshape(nbins_k, nbins_mu)
    wsum = np.asarray(wsum).reshape(nbins_k, nbins_mu)
    with np.errstate(invalid='ignore', divide='ignore'):
        power = np.where(counts != 0, wsum / counts, 0.0) * lbox**3
        k_avg = np.where(counts != 0, np.asarray(ksum).reshape(counts.shape) * dk / counts, 0.0)
    out = {
        'k_mid': 0.5 * (kedges[1:] + kedges[:-1]),
        'k_avg': k_avg,
        'power': power,
        'N_mode': np.asarray(counts, np.int64),
    }
    if poles:
        counts_k = out['N_mode'].sum(axis=1)
        pole_arr = np.zeros((len(poles), nbins_k))
        psums = np.asarray(psums)
        j = 0
        for i, p in enumerate(poles):
            if p == 0:
                pole_arr[i] = wsum.sum(axis=1)
            else:
                pole_arr[i] = psums[j]
                j += 1
        with np.errstate(invalid='ignore', divide='ignore'):
            out['poles'] = (np.where(
                counts_k[None, :] != 0, pole_arr / counts_k[None, :], 0.0
            ) * lbox**3).T
        out['N_mode_poles'] = counts_k
    return out


def _power_edges(lbox, nmesh, kbins, mubins, k_max, logk, poles):
    """(kedges, muedges, dk, nbins_k, nbins_mu, poles) of calc_power's
    arguments."""
    from ..ops.power import get_k_mu_edges

    if k_max is None:
        k_max = np.pi * nmesh / lbox
    nbins_k = nmesh // 2 if kbins is None else int(kbins)
    nbins_mu = int(mubins)
    kedges, muedges = get_k_mu_edges(lbox, k_max, nbins_k, nbins_mu, logk)
    return kedges, muedges, 2 * np.pi / lbox, nbins_k, nbins_mu, tuple(int(p) for p in poles)


def _bin_sums(ffts, plan, scale, poles, mesh=None, yslab=None):
    """(wsum, psums) of the autocorrelation of ffts[0] (or the cross of two
    fields) through one K3 launch on `plan` (a ky slab with `yslab`), summed
    over the ranks when `mesh` is given, as float64 numpy."""
    from ..ops.power import bin_pair_modes

    nbins = plan.nk * plan.nmu
    pole_w = {p: plan.pole_w[p] for p in poles if p != 0}
    out = bin_pair_modes(ffts, plan.seg, None, scale, nbins, pole_w or None, plan.nmu,
                         yslab=yslab)
    sums, psums = out if pole_w else (out, torch.zeros((len(ffts), 0, plan.nk),
                                                       dtype=torch.float64, device=out.device))
    k = 1 if len(ffts) == 2 else 0  # the cross (0, 1) of two fields, else the auto (0, 0)
    both = torch.cat([sums[k].reshape(-1), psums[k].reshape(-1)])
    if mesh is not None:
        all_reduce(both, mesh)
    both = both.cpu().numpy()
    return both[:nbins], both[nbins:].reshape(-1, plan.nk)


def calc_power_sharded(pos, lbox, mesh, kbins=None, mubins=1, k_max=None, logk=False, nmesh=256,
                       w=None, poles=(), slab=None):
    """P(k, mu) and P_ell with the particles in row blocks over the mesh
    (``calc_power_sharded``): each rank paints its block into a full grid
    with K1, the grids meet in an all_reduce, and every rank takes the rfftn
    and bins it with K3 and the full plan. Normalized by the particle count,
    as JAX's (get_field's quirk). `slab` (None: nmesh >= 512) takes the
    grid-sharded path instead (``parallel/fft.py:calc_power_sharded_slab``).
    Returns calc_power's columns (k_mid, k_avg, power, N_mode; poles and
    N_mode_poles with `poles`) as numpy, the same on every rank."""
    from ..ops.grid import paint_3d
    from ..ops.power import get_mode_bin_plan

    if slab is None:
        slab = nmesh >= 512
    if slab:
        from .fft import calc_power_sharded_slab

        return calc_power_sharded_slab(pos, lbox, mesh, kbins, mubins, k_max, logk, nmesh, w,
                                       poles)
    kedges, muedges, dk, nbins_k, nbins_mu, poles = _power_edges(
        lbox, nmesh, kbins, mubins, k_max, logk, poles)
    dev = mesh_device(mesh)
    pos = np.asarray(pos) if not isinstance(pos, torch.Tensor) else pos
    n_part = len(pos)
    rows = row_block(n_part, mesh)
    cols = [_rows_to(pos[:, i], rows, dev) for i in range(3)]
    wl = None if w is None else _rows_to(w, rows, dev)
    grid = paint_3d(*cols, int(nmesh), lbox, weights=wl)
    all_reduce(grid, mesh)
    delta_k = torch.fft.rfftn(grid * _f32(grid.numel() / n_part) - 1.0)
    del grid
    plan = get_mode_bin_plan(int(nmesh), ((kedges / dk) ** 2).astype(np.float32),
                             (muedges**2).astype(np.float32), poles, dev)
    wsum, psums = _bin_sums([delta_k], plan, 1.0 / nmesh**3, poles)
    return _assemble_power_output(wsum, psums, plan.counts, plan.ksum, kedges, poles, lbox, dk,
                                  nbins_k, nbins_mu)


def _pair_counts_sharded(pos1, pos2, edges, nb2, mode, lbox, aux, mesh, dtype):
    """Ordered pair counts of this rank's row block of pos1 against the whole
    of pos2 (pos1 itself for an autocorrelation, the pair of a point with
    itself excluded by its global index: K5's row offset), summed over the
    ranks in one int64 all_reduce."""
    from ..ops.tpcf import count_pairs_all, edges_f32

    dev = mesh_device(mesh)
    pos1 = pos1 if isinstance(pos1, torch.Tensor) else np.asarray(pos1, np.float64)
    autocorr = pos2 is None
    full = pos1 if autocorr else (pos2 if isinstance(pos2, torch.Tensor)
                                  else np.asarray(pos2, np.float64))
    rows = row_block(len(pos1), mesh)
    cols1 = [_rows_to(pos1[:, i], rows, dev, dtype) for i in range(3)]
    cols2 = [_rows_to(full[:, i], (0, len(full)), dev, dtype) for i in range(3)]
    edges2 = np.asarray(edges).astype(np.float64) ** 2
    thr = edges_f32(edges2) if dtype == torch.float32 else edges2
    counts = count_pairs_all(cols1, cols2, thr, nb2, mode, lbox, aux,
                             row0=rows[0] if autocorr else None)
    all_reduce(counts, mesh)
    return counts.cpu().numpy().reshape(len(edges) - 1, nb2)


def pair_counts_rppi_sharded(pos1, rpbins, pimax, lbox, mesh, pos2=None, dtype=torch.float32):
    """Ordered (rp, unit-pi) pair counts with pos1's rows over the mesh
    (``pair_counts_rppi_sharded``): each rank counts its block against the
    whole of pos2 with K5 in `dtype` (float32, or float64 as JAX's tiled
    engine under x64), and the counts meet in an all_reduce; equal to
    ``ops.tpcf.pair_counts_rppi(..., method='tile')`` on one device. Returns
    the (nrp, int(pimax)) int64 numpy array on every rank."""
    rpbins = np.asarray(rpbins)
    return _pair_counts_sharded(pos1, pos2, rpbins, int(pimax), 'rppi', lbox, float(pimax), mesh,
                                dtype)


def pair_counts_smu_sharded(pos1, sbins, nbins_mu, lbox, mesh, pos2=None, dtype=torch.float32):
    """Ordered (s, mu) pair counts with pos1's rows over the mesh
    (``pair_counts_smu_sharded``); as :func:`pair_counts_rppi_sharded`.
    Returns the (ns, nbins_mu) int64 numpy array on every rank."""
    sbins = np.asarray(sbins)
    return _pair_counts_sharded(pos1, pos2, sbins, int(nbins_mu), 'smu', lbox, float(nbins_mu),
                                mesh, dtype)
