"""Port parity for the whole fused HOD step: abacusutils_tpu_torch's
hod_pk_fused_yb on the CPU against the JAX bench path hod_pk_fused_yb and the
Pallas path hod_pk_fused_pallas (interpret mode) on the same numpy catalogs,
plus the example inputs, the state conversion and the JAX-free import of
the port."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models import pipeline as jpipe
from abacusutils_tpu.ops.power import get_W_compensated as jax_get_W_compensated
from abacusutils_tpu_torch.convert import inputs_from_numpy, params_to_tensors
from abacusutils_tpu_torch.models import pipeline as tpipe

LBOX = 500.0
NMESH = 32
NBINS_K = 16
REPO = Path(__file__).resolve().parent.parent


def _port_step(halo, part, params, binplan, Wcomp, yb):
    h, p, prm, seg, W = inputs_from_numpy(halo, part, params, binplan, Wcomp, 'cpu')
    h_g, plan_h = tpipe.group_inputs2d_device(h, NMESH, LBOX, yb)
    p_g, plan_p = tpipe.group_inputs2d_device(p, NMESH, LBOX, yb)
    return tpipe.hod_pk_fused_yb(
        h_g, p_g, prm, seg, W, LBOX, 100.0, NMESH, yb, NBINS_K, plan_h, plan_p, rsd=True
    )


def _window(window):
    return jax_get_W_compensated(LBOX, NMESH, 'TSC', False).astype(np.float32) if window else None


@pytest.mark.parametrize('window', [True, False])
def test_step_matches_jax_yb(window):
    """n_gal exactly and wsum at rtol 2e-4, the budget of
    tests/test_pipeline.py for two deposit layouts summing in other orders."""
    halo, part, params = jpipe.make_example_inputs(30_000, 120_000, LBOX, seed=7)
    binplan, _ = jpipe.make_bin_plan_arrays(NMESH, LBOX, NBINS_K)
    Wcomp = _window(window)
    halo_g, plan_h = jpipe.group_inputs2d(halo, NMESH, LBOX, yb=8, chunk=128)
    part_g, plan_p = jpipe.group_inputs2d(part, NMESH, LBOX, yb=8, chunk=128)
    wsum_j, ngal_j = jpipe.hod_pk_fused_yb(
        halo_g, part_g, params, binplan, Wcomp, LBOX, 100.0, NMESH, 8, NBINS_K,
        plan_h.K, plan_p.K, rsd=True, chunk_h=128, chunk_p=128,
    )
    wsum, n_gal = _port_step(halo, part, params, binplan, Wcomp, yb=8)
    assert wsum.dtype == torch.float32 and wsum.shape == (NBINS_K,)
    assert float(n_gal) == float(ngal_j)
    npt.assert_allclose(wsum.numpy(), np.asarray(wsum_j), rtol=2e-4)


def test_step_matches_jax_pallas():
    """The same against the Pallas deposit path, yb=32 (one y-block per
    x-cell column at nmesh=32)."""
    halo, part, params = jpipe.make_example_inputs(8_000, 30_000, LBOX, seed=9)
    binplan, _ = jpipe.make_bin_plan_arrays(NMESH, LBOX, NBINS_K)
    Wcomp = _window(True)
    halo_g, plan_h = jpipe.group_inputs2d(halo, NMESH, LBOX, yb=32, chunk=64)
    part_g, plan_p = jpipe.group_inputs2d(part, NMESH, LBOX, yb=32, chunk=64)
    wsum_j, ngal_j = jpipe.hod_pk_fused_pallas(
        halo_g, part_g, params, binplan, Wcomp, LBOX, 100.0, NMESH, 32, NBINS_K,
        plan_h.K, plan_p.K, rsd=True, chunk=64, interpret=True,
    )
    wsum, n_gal = _port_step(halo, part, params, binplan, Wcomp, yb=32)
    assert float(n_gal) == float(ngal_j)
    npt.assert_allclose(wsum.numpy(), np.asarray(wsum_j), rtol=2e-4)


def test_example_inputs_match_jax():
    for a, b in zip(
        tpipe.make_example_inputs(1000, 3000, LBOX, seed=3),
        jpipe.make_example_inputs(1000, 3000, LBOX, seed=3),
    ):
        assert a.keys() == b.keys()
        for k in a:
            npt.assert_array_equal(a[k], b[k], err_msg=k)


def test_example_inputs_device_distributions():
    """The torch-drawn catalog has the keys, dtypes and ranges of the numpy
    one, and the same generator seed gives the same catalog."""
    n_halo, n_part = 20_000, 50_000

    def draw(seed):
        gen = torch.Generator(device='cpu')
        gen.manual_seed(seed)
        return tpipe.make_example_inputs_device(n_halo, n_part, LBOX, gen, 'cpu')

    halo, part, params = draw(5)
    ref_h, ref_p, ref_params = jpipe.make_example_inputs(10, 10, LBOX)
    assert set(halo) == set(ref_h) and set(part) == set(ref_p)
    assert all(v.dtype == torch.float32 and v.shape == (n_halo,) for v in halo.values())
    assert all(v.dtype == torch.float32 and v.shape == (n_part,) for v in part.values())
    assert set(params) == set(ref_params)
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in params.values())
    for k in ('x', 'y', 'z'):
        assert -LBOX / 2 <= float(halo[k].min()) and float(halo[k].max()) < LBOX / 2
    mass = halo['mass']
    assert 1e11 * 0.9999 <= float(mass.min()) and float(mass.max()) <= 1e15 * 1.0001  # f32
    assert abs(float(halo['vz'].std()) / 300 - 1) < 0.05
    assert float((part['x'] - halo['x'][0]).abs().min()) < 1.0  # sats sit on their halos
    torch.testing.assert_close(draw(5)[1]['x'], part['x'], rtol=0, atol=0)


def test_inputs_from_numpy():
    halo, part, params = jpipe.make_example_inputs(100, 300, LBOX, seed=1)
    binplan, _ = jpipe.make_bin_plan_arrays(NMESH, LBOX, NBINS_K)
    h, p, prm, seg, W = inputs_from_numpy(halo, part, params, binplan, _window(True), 'cpu')
    assert all(v.dtype == torch.float32 for v in (*h.values(), *p.values(), *prm.values()))
    assert float(prm['logM_cut']) == float(np.float32(params['logM_cut']))
    assert seg.dtype == torch.int32 and seg.numel() == NMESH * NMESH * (NMESH // 2 + 1)
    npt.assert_array_equal(seg.numpy(), np.asarray(binplan[0]))
    assert W.dtype == torch.float32 and W.shape == (NMESH,)
    assert inputs_from_numpy(halo, part, params, binplan[0], None, 'cpu')[4] is None
    assert params_to_tensors({'a': 0.1}, 'cpu')['a'].item() == float(np.float32(0.1))


def test_port_imports_without_jax():
    """Every module of the port imports with jax and the JAX package blocked,
    and none imports h5py, yaml, asdf, msgpack or zstandard (the GPU machine
    has none)."""
    mods = sorted(
        '.'.join(f.relative_to(REPO).with_suffix('').parts).removesuffix('.__init__')
        for f in (REPO / 'abacusutils_tpu_torch').rglob('*.py')
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['abacusutils_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'abacusutils_tpu.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
        "assert not any(k in sys.modules for k in ('h5py', 'yaml', 'asdf', 'msgpack', "
        "'zstandard'))\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'ok' and len(mods) >= 10
    for m in ('ops.power', 'ops.grid', 'ops.tpcf', 'ops.shear', 'models.hod.population',
              'models.hod.abacus_hod', 'models.hod.shapes_np', 'models.hod.prepare_sim',
              'models.hod.menv', 'models.hod.ranks_device', 'models.hod.menv_device', 'testing',
              'models.zcv.cosmo', 'models.zcv.ic_fields', 'models.zcv.advect_fields',
              'models.zcv.tracer_power', 'models.zcv.zenbu_native', 'models.zcv.zenbu_window',
              'models.zcv.tools_cv', 'models.zcv.precompute', 'models.zcv.apply',
              'models.zcv.linear_fields', 'models.hod.nfw', 'io.table'):
        assert f'abacusutils_tpu_torch.{m}' in mods
