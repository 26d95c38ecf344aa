"""Gloo ranks for the sharded-path tests (tests/test_torch_parallel.py).

JAX-free: :func:`spawn` starts `world` CPU processes with
torch.multiprocessing, each joins a gloo world through a file store, makes
the port's mesh (``parallel.mesh.make_mesh('cpu')``), runs every case of
CASES on inputs drawn from the seeds of tests/test_parallel.py, and writes
its results to ``rank{r}.npz``. The parent test compares the ranks with
each other, with the JAX package's sharded functions and with the port's
single-device functions.
"""

import os
import traceback
from pathlib import Path

import numpy as np
import torch

# sizes and seeds of tests/test_parallel.py
LBOX_PK, NMESH_PK, N_PK = 500.0, 32, 120_001
NMESH_FFT = 16
LBOX_PAIRS, N_PAIRS, N_PAIRS2 = 300.0, 5001, 3000
RPBINS = np.logspace(-1, np.log10(25), 7)
PIMAX = 20
SBINS = np.linspace(0.1, 25, 7)
NMU = 10
NMESH_ZCV, LBOX_ZCV = 32, 100.0
N_FIELD, NMESH_FIELD, LBOX_FIELD = 60_000, 16, 250.0
FIELD_NK = 8
# the fused box step: the staged state of tests/test_torch_abacus_hod.py
N_HALO, N_PART, LBOX_FUSED, SEED_FUSED = 30_000, 120_000, 500.0, 41
NMESH_FUSED, NBINS_FUSED = 32, 16
# sharded_hod_pk: tests/test_parallel.py:test_sharded_hod_pk_runs
LBOX_HOD, NMESH_HOD, NBINS_HOD = 250.0, 16, 8


def pk_inputs():
    rng = np.random.default_rng(11)
    pos = (rng.random((N_PK, 3)) * LBOX_PK).astype(np.float32)
    return pos, rng.random(N_PK).astype(np.float32)


def clustered_inputs():
    rng = np.random.default_rng(12)
    n = N_PK
    cen = (rng.random((50, 3)) * LBOX_PK).astype(np.float32)
    pos = np.concatenate([
        (cen[rng.integers(0, 50, n // 2)] + rng.normal(0, 8, (n // 2, 3))) % LBOX_PK,
        rng.random((n - n // 2, 3)) * LBOX_PK,
    ]).astype(np.float32)
    return pos, rng.random(n).astype(np.float32)


def fft_grid():
    rng = np.random.default_rng(13)
    return rng.standard_normal((NMESH_FFT,) * 3).astype(np.float32)


def pair_inputs():
    rng = np.random.default_rng(21)
    pos = rng.random((N_PAIRS, 3)) * LBOX_PAIRS
    return pos, rng.random((N_PAIRS2, 3)) * LBOX_PAIRS


def smu_inputs():
    return np.random.default_rng(22).random((N_PAIRS, 3)) * LBOX_PAIRS


def zcv_density():
    return np.random.default_rng(14).standard_normal((NMESH_ZCV,) * 3).astype(np.float32)


def field_inputs():
    rng = np.random.default_rng(15)
    pos = (rng.random((N_FIELD, 3)) * LBOX_FIELD - LBOX_FIELD / 2).astype(np.float32)
    w = rng.random(N_FIELD).astype(np.float32)
    pos2 = (rng.random((N_FIELD, 3)) * LBOX_FIELD - LBOX_FIELD / 2).astype(np.float32)
    return pos, w, pos2


def field_edges():
    from abacusutils_tpu_torch.ops.power import get_k_mu_edges

    return get_k_mu_edges(LBOX_FIELD, np.pi * NMESH_FIELD / LBOX_FIELD, FIELD_NK, 1, False)


def fused_state():
    from torch_helpers import staged_state

    return staged_state(N_HALO, N_PART, LBOX_FUSED, SEED_FUSED)


def fused_tracers():
    """tests/test_torch_abacus_hod.py's tracers: live assembly bias, ELG
    conformity."""
    from torch_helpers import TRACERS

    tr = {k: dict(v) for k, v in TRACERS.items()}
    for p in tr.values():
        p.update(Acent=0.05, Asat=-0.1, Bcent=0.03, Bsat=0.05)
    tr['ELG'].update(Ccent=0.1, Csat=-0.1, logM1_EE=13.1, logM1_EL=13.8)
    return tr


def fused_port(device='cpu'):
    from abacusutils_tpu_torch.convert import staged_state_from_numpy

    halo, part = fused_state()
    params = {'z': 0.5, 'Lbox': LBOX_FUSED, 'velz2kms': 100.0, 'origin': None}
    flags = dict(want_ranks=False, want_shear=False, want_expvel=False, halo_lc=False,
                 z_type='primary')
    return staged_state_from_numpy(halo, part, params, fused_tracers(), flags, device)


def hod_inputs():
    from abacusutils_tpu_torch.models.pipeline import make_example_inputs

    return make_example_inputs(5000, 20000, LBOX_HOD, seed=3)


def hod_edges():
    from abacusutils_tpu_torch.ops.power import get_k_mu_edges

    kedges, muedges = get_k_mu_edges(LBOX_HOD, np.pi * NMESH_HOD / LBOX_HOD, NBINS_HOD, 1, False)
    dk = 2 * np.pi / LBOX_HOD
    return ((kedges / dk) ** 2).astype(np.float32), (muedges**2).astype(np.float32)


def _spectrum(out, tag, res):
    for k, v in res.items():
        out[f'{tag}.{k}'] = np.asarray(v)


def case_calc_power(mesh, out):
    from abacusutils_tpu_torch.parallel.mesh import calc_power_sharded

    pos, w = pk_inputs()
    _spectrum(out, 'pk', calc_power_sharded(pos, LBOX_PK, mesh, nmesh=NMESH_PK, kbins=16, w=w,
                                            poles=(0, 2, 4), slab=False))


def case_calc_power_slab(mesh, out):
    from abacusutils_tpu_torch.parallel import fft as pfft
    from abacusutils_tpu_torch.parallel.mesh import calc_power_sharded

    pos, w = clustered_inputs()
    _spectrum(out, 'pk_slab', calc_power_sharded(pos, LBOX_PK, mesh, nmesh=NMESH_PK, kbins=16,
                                                 w=w, poles=(0, 2, 4), slab=True))
    # the slab's local shapes: xl + 4 deposit planes, Y / n rows after the FFT
    cols = pfft.shard_slabs(mesh, pos, w, NMESH_PK, LBOX_PK)
    core = pfft.paint_slab(*cols, NMESH_PK, LBOX_PK, mesh)
    out['local.paint_core'] = np.array(core.shape)
    out['local.slab_fft'] = np.array(pfft.slab_rfftn(core, mesh).shape)


def case_slab_fft(mesh, out):
    from abacusutils_tpu_torch.parallel import fft as pfft
    from abacusutils_tpu_torch.parallel.mesh import LocalSlab, mesh_rank

    grid = fft_grid()
    xl = NMESH_FFT // int(mesh.size(0))
    x0 = mesh_rank(mesh) * xl
    ck = pfft.slab_rfftn(torch.from_numpy(grid[x0:x0 + xl].copy()), mesh)
    back = pfft.slab_irfftn(ck, mesh, NMESH_FFT)
    out['fft.rfftn'] = pfft.gather_slab(LocalSlab(ck, x0), mesh).numpy()
    out['fft.back'] = pfft.gather_slab(LocalSlab(back, x0), mesh, dim=0).numpy()


def case_pairs(mesh, out):
    from abacusutils_tpu_torch.parallel.mesh import (
        pair_counts_rppi_sharded,
        pair_counts_smu_sharded,
    )

    pos, pos2 = pair_inputs()
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split('.')[-1]
        out[f'pairs.rppi_auto.{tag}'] = pair_counts_rppi_sharded(pos, RPBINS, PIMAX, LBOX_PAIRS,
                                                                 mesh, dtype=dt)
        out[f'pairs.rppi_cross.{tag}'] = pair_counts_rppi_sharded(
            pos, RPBINS, PIMAX, LBOX_PAIRS, mesh, pos2=pos2, dtype=dt)
        out[f'pairs.smu_auto.{tag}'] = pair_counts_smu_sharded(smu_inputs(), SBINS, NMU,
                                                               LBOX_PAIRS, mesh, dtype=dt)


def case_zcv_fields(mesh, out):
    from abacusutils_tpu_torch.models.zcv.ic_fields import get_fields, get_fields_sharded
    from abacusutils_tpu_torch.parallel.fft import gather_slab

    dens = zcv_density()
    pieces = get_fields_sharded(dens, LBOX_ZCV, NMESH_ZCV, mesh)
    out['local.zcv_field'] = np.array(pieces[0].local.shape)
    for name, p, via in zip(('d', 'd2', 's2', 'n2'), pieces,
                            get_fields(dens, LBOX_ZCV, NMESH_ZCV, mesh=mesh)):
        out[f'zcv.{name}'] = gather_slab(p, mesh, dim=0).numpy()
        out[f'zcv_kwarg.{name}'] = via.numpy()


def case_field_fft(mesh, out):
    from abacusutils_tpu_torch.parallel import fft as pfft

    pos, w, pos2 = field_inputs()
    for comp, inter in ((False, False), (True, True)):
        f = pfft.field_fft_slab(pos, LBOX_FIELD, NMESH_FIELD, mesh, w=w, compensated=comp,
                                interlaced=inter)
        out[f'field.{int(comp)}{int(inter)}'] = pfft.gather_slab(f, mesh).numpy()
    f1 = pfft.field_fft_slab(pos, LBOX_FIELD, NMESH_FIELD, mesh, w=w)
    f2 = pfft.field_fft_slab(pos2, LBOX_FIELD, NMESH_FIELD, mesh)
    out['local.field_fft'] = np.array(f1.local.shape)
    kedges, muedges = field_edges()
    _spectrum(out, 'field_pk', pfft.calc_pk_from_deltak_slab(
        f1, LBOX_FIELD, kedges, muedges, mesh, field2_fft=f2, poles=[0, 2]))
    out['field.f1'] = pfft.gather_slab(f1, mesh).numpy()
    out['field.f2'] = pfft.gather_slab(f2, mesh).numpy()


def case_fused(mesh, out):
    port = fused_port()
    for slab in (False, True):
        cl, ng = port.run_hod_pk_fused(nmesh=NMESH_FUSED, nbins_k=NBINS_FUSED, mesh=mesh,
                                       slab=slab)
        tag = f'fused{int(slab)}'
        _spectrum(out, tag, cl)
        for t, n in ng.items():
            out[f'{tag}.ngal.{t}'] = np.float64(n)
        stage = port._fused_stage[1]
        out[f'local.{tag}_grid'] = np.array(stage.plan_h.grid_shape)
        out[f'local.{tag}_halos'] = np.int64(stage.halo_g['x'].numel())
        assert int(port.deposit_overflow) == 0


def case_sharded_hod_pk(mesh, out):
    from abacusutils_tpu_torch.convert import params_to_tensors
    from abacusutils_tpu_torch.parallel.mesh import shard_particles, sharded_hod_pk

    halo, part, params = hod_inputs()
    halo_s, part_s = shard_particles(mesh, halo), shard_particles(mesh, part)
    out['shard.halo_x'] = halo_s['x'].numpy()
    out['shard.part_randoms'] = part_s['randoms'].numpy()
    wsum, counts, n_gal = sharded_hod_pk(mesh, halo_s, part_s, params_to_tensors(params, 'cpu'),
                                         *hod_edges(), LBOX_HOD, 100.0, NMESH_HOD, NBINS_HOD)
    out['hod.wsum'] = wsum.numpy()
    out['hod.counts'] = counts
    out['hod.n_gal'] = np.float64(n_gal)


def case_staging(mesh, out):
    from abacusutils_tpu_torch.parallel.mesh import group_inputs2d_linked_sharded

    halo, part = {}, {}
    st_h, st_p = fused_state()
    for d, src, pre in ((halo, st_h, 'h'), (part, st_p, 'p')):
        for i, a in enumerate('xyz'):
            d[a] = src[f'{pre}pos'][:, i]
    halo['id'] = np.arange(len(halo['x']), dtype=np.int64)
    part['hidx'] = st_p['pinds']
    part['id'] = np.arange(len(part['x']), dtype=np.int64)
    for slab in (False, True):
        st = group_inputs2d_linked_sharded(halo, part, NMESH_FUSED, LBOX_FUSED, mesh, slab=slab)
        tag = f'local.stage{int(slab)}'
        out[f'{tag}.halo_id'] = st.halo_g['id'].numpy()
        out[f'{tag}.part_id'] = st.part_g['id'].numpy()
        out[f'{tag}.hkeep_at'] = st.part_g['hkeep_at'].numpy()
        out[f'{tag}.nhalo_max'] = np.int64(st.nhalo_max)


CASES = {
    'calc_power': case_calc_power,
    'calc_power_slab': case_calc_power_slab,
    'slab_fft': case_slab_fft,
    'pairs': case_pairs,
    'zcv_fields': case_zcv_fields,
    'field_fft': case_field_fft,
    'fused': case_fused,
    'sharded_hod_pk': case_sharded_hod_pk,
    'staging': case_staging,
}


def _rank(rank, world, store, out_dir, threads, cases):
    from abacusutils_tpu_torch.parallel.mesh import init_world, make_mesh
    import torch.distributed as dist

    torch.set_num_threads(threads)
    out = {}
    try:
        init_world(rank, world, f'file://{store}', 'cpu')
        mesh = make_mesh('cpu')
        for name in cases:
            CASES[name](mesh, out)
    except Exception:
        (Path(out_dir) / f'rank{rank}.err').write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    np.savez(Path(out_dir) / f'rank{rank}.npz', **out)


def spawn(world, out_dir, cases=tuple(CASES)):
    """Run the named CASES on `world` gloo ranks; returns each rank's
    results (a list of dicts of numpy arrays). Each rank takes its share of
    this process's cores."""
    import torch.multiprocessing as mp

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    threads = max(1, torch.get_num_threads() // world)
    try:
        mp.spawn(_rank, args=(world, str(out_dir / 'store'), str(out_dir), threads,
                              tuple(cases)), nprocs=world, join=True)
    except Exception as e:
        errs = [p.read_text() for p in sorted(out_dir.glob('rank*.err'))]
        raise RuntimeError('gloo ranks failed:\n' + '\n'.join(errs)) from e
    res = []
    for r in range(world):
        with np.load(out_dir / f'rank{r}.npz') as f:
            res.append({k: f[k] for k in f.files})
    return res


if __name__ == '__main__':
    import sys
    import time

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    t0 = time.perf_counter()
    r = spawn(int(sys.argv[1]), sys.argv[2])
    print(f'{len(r)} ranks, {len(r[0])} results in {time.perf_counter() - t0:.1f} s')
