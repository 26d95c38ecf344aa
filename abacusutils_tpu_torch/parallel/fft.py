r"""The slab-decomposed FFT pipeline over a device mesh (the counterpart of
abacusutils_tpu/parallel/fft.py).

``parallel/mesh.py:calc_power_sharded``'s default path keeps a full nmesh^3
grid on every rank; at the ZCV's meshes (512^3 and up) this module keeps
the grid sharded end to end:

- real space: x-slabs. Each rank deposits only the points of its slab
  (:func:`shard_slabs`, bucketed by K1's own f32 cell) into its xl + 2h
  planes with K1's slab mode (``ops/grid.py:tsc_deposit_cells``); the h
  halo planes on each side go to the neighbours by two ring shifts
  (:func:`fold_halos`).
- Fourier space: ky slabs. The 3-D rfft factors into the local rfft along z
  and fft along y (cuFFT through ``torch.fft``), one ``all_to_all_single``
  transpose, and the local fft along x (:func:`slab_rfftn`).
- binning: each rank bins its ky rows with a ky-slab plan
  (``ops/power.py:get_mode_bin_plan(yslab=)``) in one K3 launch that reads
  W at y0 + iy; the bin sums meet in an all_reduce.

A rank's grid memory is ~1/ranks of the replicated path's at every stage.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..ops.grid import _axis_centre, _f32, stage_bricks, tsc_deposit_cells
from .mesh import (
    LocalSlab,
    _assemble_power_output,
    _bin_sums,
    _check_tensor,
    _cpu_tensor,
    _group,
    _power_edges,
    _rows_to,
    _xl,
    all_gather_rows,
    all_reduce,
    mesh_device,
    mesh_rank,
    mesh_size,
    ring_shift,
)

# halo planes a side of a paint_slab deposit: a point bucketed by its
# stencil centre's cell (+-1 plane) plus the slack of a half-cell
# interlacing offset
HALO = 2

__all__ = ['slab_rfftn', 'slab_irfftn', 'paint_slab', 'fold_halos', 'shard_slabs',
           'SlabBins', 'calc_power_sharded_slab', 'field_fft_slab', 'calc_pk_from_deltak_slab',
           'gather_slab']


def _transpose(c, mesh, split, concat):
    """Split complex `c` along dim `split` into one block a rank, send block
    j to rank j, and concatenate what arrives along dim `concat`, in rank
    order: one all_to_all_single over a contiguous tensor whose split axis
    leads."""
    _check_tensor(c, mesh)
    n = mesh_size(mesh)
    if n == 1:
        return c
    blocks = c.movedim(split, 0)
    shape = blocks.shape
    src = torch.view_as_real(blocks.contiguous()).reshape(-1)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=_group(mesh))
    # out holds n blocks of shape[0] / n rows along `split`, rank j's first
    got = torch.view_as_complex(out.reshape(n, shape[0] // n, *shape[1:], 2))
    got = got.movedim(1, split + 1)  # each block back in c's axis order
    return torch.cat(got.unbind(0), concat)


def slab_rfftn(slab, mesh):
    """The 3-D rfft of an x-sharded real grid: `slab` is this rank's (X/n, Y,
    Z) x-slab; returns its (X, Y/n, Z/2+1) complex64 ky rows of the global
    rfftn (``slab_rfftn``). The rfft along z and fft along y are local, one
    all-to-all moves the blocks, the fft along x is local."""
    c = torch.fft.fft(torch.fft.rfft(slab, dim=2), dim=1)
    return torch.fft.fft(_transpose(c, mesh, 1, 0), dim=0)


def slab_irfftn(ck, mesh, n1d):
    """The inverse of :func:`slab_rfftn`: this rank's (X, Y/n, Z/2+1) ky
    rows -> its (X/n, Y, Z) real x-slab, Z = n1d."""
    c = _transpose(torch.fft.ifft(ck, dim=0), mesh, 0, 1)
    return torch.fft.irfft(torch.fft.ifft(c, dim=1), n=n1d, dim=2)


def fold_halos(grid, h, mesh):
    """Fold the h halo planes on each side of this rank's (xl + 2h, Y, Z)
    x-slab into its neighbours' core planes and return its (xl, Y, Z) core:
    the right halo (global planes x0 + xl ..) adds to the next rank's first h
    planes, the left one (x0 - h ..) to the previous rank's last h, each by a
    ring shift (:func:`parallel.mesh.ring_shift`; two calls, so at two ranks
    the two halves stay apart). On one rank the halos fold onto its own slab,
    the periodic wrap, with no send to itself."""
    xl = grid.shape[0] - 2 * h
    if xl < h:
        raise ValueError(f'a slab of {xl} planes cannot take {h} halo planes a side')
    core = grid[h:h + xl]
    right, left = grid[xl + h:], grid[:h]
    if mesh_size(mesh) == 1:
        from_prev, from_next = right, left
    else:
        from_prev = ring_shift(right, 1, mesh)
        from_next = ring_shift(left, -1, mesh)
    core[:h] += from_prev
    core[xl - h:] += from_next
    return core


def _columns(pos):
    """(x, y, z) of an (N, 3) array or tensor, or of a sequence of three
    (N,) columns, each numpy or a tensor."""
    if isinstance(pos, (tuple, list)) and len(pos) == 3 and np.ndim(pos[0]) == 1:
        return list(pos)
    if not isinstance(pos, torch.Tensor):
        pos = np.asarray(pos)
    return [pos[:, i] for i in range(3)]


def shard_slabs(mesh, pos, w, nmesh, lbox, centered=True):
    """This rank's points of an x-slab decomposition (``shard_slabs``):
    each point goes to the slab of its TSC stencil centre, K1's f32 cell of
    x (+ lbox / 2 when `centered`) wrapped once (``ops/grid.py:
    _axis_centre``), and only this rank's points are uploaded. pos: (N, 3)
    or three (N,) columns, numpy or tensors; w: (N,) or None (unit). Returns
    the float32 columns (x, y, z, w) on the rank's device, in input order."""
    xl = _xl(nmesh, mesh, True)
    pos = _columns(pos)
    x = _cpu_tensor(pos[0]).to(torch.float32)
    if centered:
        x = x + _f32(np.float32(lbox) / 2)
    i0, _ = _axis_centre(x, lbox, 0.0, nmesh, True)
    slab = torch.div(torch.remainder(i0.long(), nmesh), xl, rounding_mode='floor')
    rows = torch.nonzero(slab == mesh_rank(mesh)).reshape(-1)
    dev = mesh_device(mesh)
    cols = [_rows_to(c, rows, dev) for c in pos]
    ws = (torch.ones(len(rows), dtype=torch.float32, device=dev) if w is None
          else _rows_to(w, rows, dev))
    return cols + [ws]


def paint_slab(px, py, pz, w, nmesh, lbox, mesh, centered=True, offset=0.0):
    """TSC deposit of this rank's points (:func:`shard_slabs`, within +-1
    cell of its slab) into its x-slab (``paint_slab``): staged by brick and
    deposited by K1's slab mode into xl + 2 HALO planes whose plane 0 is
    global plane x0 - HALO, the halos folded by :func:`fold_halos`. A
    half-cell interlacing `offset` stays within the slack the two-plane halos
    absorb. A point whose cloud leaves the planes raises. Returns the (xl,
    nmesh, nmesh) core slab."""
    xl = _xl(nmesh, mesh, True)
    dev = mesh_device(mesh)
    half = _f32(np.float32(lbox) / 2) if centered else 0.0
    cols = [px + half, py + half, pz + half, w] if half else [px, py, pz, w]
    slab = (mesh_rank(mesh) * xl, HALO, xl + 2 * HALO)
    (x, y, z, ws), plan = stage_bricks(cols, nmesh, lbox, offset=offset, slab=slab)
    grid = torch.zeros(plan.grid_shape, dtype=torch.float32, device=dev)
    fault = torch.zeros(1, dtype=torch.int32, device=dev)
    tsc_deposit_cells(grid, x, y, z, ws, plan, lbox, offset, fault=fault)
    if int(fault):
        raise ValueError(f'{int(fault)} points have clouds outside their rank\'s x-slab: '
                         'bucket them with shard_slabs')
    return fold_halos(grid, HALO, mesh)


class SlabBins:
    """This rank's ky-slab mode-bin plan of a y-sharded rfft spectrum (the
    counterpart of ``_SlabBins``): `plan`, its rows y0 .. y0 + Y/n, and
    `total`, the plan with the full mesh's counts and ksum, the sums of the
    ranks' plans (an all_reduce, the same on every rank), which the host
    tail of ``ops/power.py`` takes as it takes a whole mesh's plan."""

    def __init__(self, nmesh, kedges2, muedges2, poles, mesh):
        from ..ops.power import get_mode_bin_plan

        yl = _xl(nmesh, mesh, False)
        self.yslab = (mesh_rank(mesh) * yl, (mesh_rank(mesh) + 1) * yl)
        self.poles = tuple(int(p) for p in poles)
        self.plan = get_mode_bin_plan(int(nmesh), kedges2, muedges2, self.poles,
                                      mesh_device(mesh), self.yslab)
        both = torch.from_numpy(np.concatenate([self.plan.counts, self.plan.ksum]))
        both = all_reduce(both.to(mesh_device(mesh)), mesh).cpu().numpy()
        counts, ksum = (a.reshape(self.plan.counts.shape) for a in np.split(both, 2))
        self.total = self.plan._replace(counts=counts, ksum=ksum)
        self.mesh = mesh

    def bin_local(self, ffts, scale):
        """(wsum, psums) of ffts[0]'s autocorrelation (or the cross of two
        fields) over this rank's ky rows, summed over the ranks: float64
        numpy, the same on every rank."""
        return _bin_sums(ffts, self.plan, scale, self.poles, self.mesh, self.yslab)


def _slab_bins(nmesh, kedges, muedges, dk, poles, mesh):
    return SlabBins(nmesh, ((np.asarray(kedges) / dk) ** 2).astype(np.float32),
                    (np.asarray(muedges) ** 2).astype(np.float32), poles, mesh)


def calc_power_sharded_slab(pos, lbox, mesh, kbins=None, mubins=1, k_max=None, logk=False,
                            nmesh=256, w=None, poles=()):
    """P(k, mu) and P_ell with the grid sharded end to end
    (``calc_power_sharded_slab``): the x-slab paint, the transpose rfftn and
    the ky-slab binning. Bin for bin equal, up to FFT rounding, to
    ``ops.power.calc_power`` and the replicated ``calc_power_sharded``;
    returns their columns, the same on every rank."""
    kedges, muedges, dk, nbins_k, nbins_mu, poles = _power_edges(
        lbox, nmesh, kbins, mubins, k_max, logk, poles)
    n_part = len(_columns(pos)[0])
    bins = _slab_bins(nmesh, kedges, muedges, dk, poles, mesh)
    core = paint_slab(*shard_slabs(mesh, pos, w, nmesh, lbox), nmesh, lbox, mesh)
    # get_field's quirk: normalized by the particle COUNT, not the weight
    delta = core * _f32(np.float32(nmesh) ** 3 / np.float32(n_part)) - 1.0
    del core
    wsum, psums = bins.bin_local([slab_rfftn(delta, mesh)], 1.0 / nmesh**3)
    return _assemble_power_output(wsum, psums, bins.total.counts, bins.total.ksum, kedges, poles,
                                  lbox, dk, nbins_k, nbins_mu)


def field_fft_slab(pos, lbox, nmesh, mesh, w=None, paste='TSC', compensated=False,
                   interlaced=False):
    """The sharded ``get_field_fft`` (``field_fft_slab``): the x-slab TSC
    paint of raw coordinates (twice, with a half-cell shift, when
    interlacing), the transpose rfftn, then the interlacing phase and the
    TSC compensation on this rank's ky rows. Returns a
    :class:`parallel.mesh.LocalSlab`: the (nmesh, nmesh / n, nmesh/2+1)
    complex64 ky rows of the Fourier overdensity and the first row's global
    index (:func:`gather_slab` gathers the whole)."""
    from ..ops.power import get_W_compensated

    if paste.upper() != 'TSC':
        raise ValueError('field_fft_slab supports TSC paste only')
    yl = _xl(nmesh, mesh, True)
    y0 = mesh_rank(mesh) * yl
    dev = mesh_device(mesh)
    n_part = len(_columns(pos)[0])
    # centered=False: get_field paints raw coordinates (single wrap), and the
    # returned FIELD's phases must match: a half-box shift would flip the
    # sign of every odd mode
    cols = shard_slabs(mesh, pos, w, nmesh, lbox, centered=False)
    norm = _f32(np.float32(nmesh) ** 3 / np.float32(n_part))
    d = lbox / nmesh

    def one(offset):
        core = paint_slab(*cols, nmesh, lbox, mesh, centered=False, offset=offset)
        return slab_rfftn(core * norm - 1.0, mesh)

    fft = one(0.0)
    if interlaced:
        fft_s = one(0.5 * d)
        dk = _f32(2.0 * np.pi / lbox)
        i = torch.arange(nmesh, device=dev)
        kv = torch.where(i < nmesh // 2, i, i - nmesh).to(torch.float32) * dk
        kz = torch.arange(nmesh // 2 + 1, device=dev).to(torch.float32) * dk
        theta = (kv[:, None, None] + kv[None, y0:y0 + yl, None] + kz[None, None, :]) * _f32(
            0.5 * d)
        fft = (fft + fft_s * torch.polar(torch.ones_like(theta), theta)) * 0.5
        del fft_s
    fft = fft * _f32(1.0 / float(nmesh) ** 3)
    if compensated:
        W = torch.from_numpy(get_W_compensated(lbox, nmesh, 'TSC', interlaced)
                             .astype(np.float32)).to(dev)
        fft = fft / (W[:, None, None] * W[None, y0:y0 + yl, None]
                     * W[None, None, :nmesh // 2 + 1])
    return LocalSlab(fft, y0)


def gather_slab(part, mesh, dim=1):
    """The whole array of the ranks' :class:`LocalSlab` pieces `part`
    (sharded along `dim`: 1 for ky rows, 0 for x-slabs), on every rank."""
    full = all_gather_rows(part.local.movedim(dim, 0), mesh)
    return full.movedim(0, dim)


def calc_pk_from_deltak_slab(field_fft, Lbox, k_bin_edges, mu_bin_edges, mesh, field2_fft=None,
                             poles=(), squeeze_mu_axis=True):
    """The sharded ``calc_pk_from_deltak`` (``calc_pk_from_deltak_slab``):
    the auto or cross spectrum of ky-sharded Fourier fields (the
    :class:`parallel.mesh.LocalSlab` of :func:`field_fft_slab`), binned by
    each rank's ky-slab plan in one K3 launch and summed over the ranks.
    Returns calc_pk_from_deltak's dict, the same on every rank."""
    from ..ops.power import _spectrum

    nmesh = field_fft.local.shape[0]
    dk = 2 * np.pi / Lbox
    poles = tuple(int(p) for p in np.asarray(poles).reshape(-1))
    bins = _slab_bins(nmesh, k_bin_edges, mu_bin_edges, dk, poles, mesh)
    if field_fft.offset != bins.yslab[0]:
        raise ValueError(f'the field holds ky rows from {field_fft.offset}, this rank bins '
                         f'{bins.yslab}')
    ffts = [field_fft.local] + ([] if field2_fft is None else [field2_fft.local])
    wsum, psums = bins.bin_local(ffts, 1.0)
    return _spectrum(bins.total, dk, wsum.reshape(bins.total.counts.shape), psums, Lbox, poles,
                     squeeze_mu_axis)
