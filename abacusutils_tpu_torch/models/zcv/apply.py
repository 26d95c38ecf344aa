r"""apply_zcv and apply_zcv_xi: the ZCV-reduced P_ell(k) and xi_ell(r) of an
HOD mock (the counterpart of abacusutils_tpu/models/zcv/apply.py), on the
products of :mod:`precompute`: in memory (:func:`precompute.zcv_products`),
or, with ``zcv=None``, read from the files of the chain's ``main``s under
``zcv_dir`` (``ZCVProducts.from_dir``). Products read from files keep
their config: the tracer's fields, spectra and cubes are then written
under ``tracer_dir`` (default the zcv_dir) with JAX's names, and
``load_presaved`` reads them back from the zcv_dir, as the JAX package
does (so a tracer_dir apart from it must be copied there first)."""

import numpy as np

from ...ops.power import get_k_mu_edges, pk_to_xi
from .files import k_tag, read_data, read_fft, sim_dirs
from .ic_fields import compress_asdf
from .precompute import ZCVProducts, _check_kcut
from .tools_cv import field_cube, run_zcv, run_zcv_field
from .tracer_power import get_tracer_power

__all__ = ['apply_zcv', 'apply_zcv_xi']


def _tracer_cols(tr):
    return tuple(np.asarray(tr[c], np.float32) for c in ('x', 'y', 'z'))


def _device(ball):
    return getattr(ball, 'device', None)


def apply_zcv(ball, mock_dict, config, zcv=None, load_presaved=False):
    """Variance-reduced P_ell(k) via Zel'dovich control variates
    (apply.py:apply_zcv).

    Each tracer's auto spectrum is reduced on its own; with one tracer the
    flat zcv dict is returned, with several a dict keyed by tracer. When
    config's want_rsd is on, the real-space counterparts come from one
    ``ball.run_hod(ball.tracers, want_rsd=False)``. zcv: the
    :class:`precompute.ZCVProducts` of the simulation (None: read from
    zcv_dir, ``ZCVProducts.from_dir``); the tracer spectra this call
    measures are kept in ``zcv.tracer_spectra``, and written as
    ``power{rsd}_tr{_tag}_*`` files under tracer_dir when the products came
    from files. load_presaved: take the tracer spectra from those files in
    zcv_dir, or from ``zcv.tracer_spectra`` for products in memory (raises
    where they are missing)."""
    if zcv is None:
        zcv = ZCVProducts.from_dir(config, device=_device(ball))
    assert len(config['power_params']['poles']) <= 3
    assert config['power_params']['nbins_mu'] == 1
    if 'nmesh' not in config['power_params']:
        config['power_params']['nmesh'] = config['zcv_params']['nmesh']
    assert config['zcv_params']['nmesh'] == config['power_params']['nmesh']

    want_rsd = config['HOD_params']['want_rsd']
    tracers = list(mock_dict)
    pos_rsd = {t: _tracer_cols(mock_dict[t]) for t in tracers}

    pos_real = {}
    if want_rsd and not load_presaved:
        mock_real = ball.run_hod(ball.tracers, want_rsd=False, reseed=None, write_to_disk=False)
        pos_real = {t: _tracer_cols(mock_real[t]) for t in tracers if t in mock_real}
        del mock_real
        missing = [t for t in tracers if t not in pos_real]
        assert not missing, (
            f'tracers {missing} in mock_dict but not in ball.tracers; '
            'cannot repopulate their real-space counterparts'
        )

    single = len(tracers) == 1
    results = {}
    for t in tracers:
        tag = '' if single else t
        results[t] = _apply_zcv_one(ball, pos_rsd.pop(t), pos_real.pop(t, None), config, tag,
                                    zcv, load_presaved)
    return results[tracers[0]] if single else results


def _apply_zcv_one(ball, pos_rsd, pos_real, config, tag, zcv, load_presaved):
    """The ZCV reduction of one tracer's auto spectrum."""
    pp = config['power_params']
    want_rsd = config['HOD_params']['want_rsd']
    k_bin_edges, _ = get_k_mu_edges(ball.lbox, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'],
                                    pp['logk'])
    k_binc = 0.5 * (k_bin_edges[1:] + k_bin_edges[:-1])
    if not np.allclose(k_binc, zcv.k_binc):
        raise ValueError('the ZCV products were made for another k binning')
    if not np.isclose(zcv.kcut, config['zcv_params']['kcut']):
        raise ValueError(f'the ZCV products were made with kcut {zcv.kcut}, not '
                         f'{config["zcv_params"]["kcut"]}')

    spaces = (want_rsd, False) if want_rsd else (False,)
    from_files = zcv.config is not None
    if load_presaved and from_files:
        # the files of an earlier call (apply.py:_apply_zcv_one)
        ktag = k_tag(ball.lbox, config['zcv_params']['nmesh'], pp['k_hMpc_max'], pp['nbins_k'],
                     pp['nbins_mu'], pp['logk'])
        mu_edges = get_k_mu_edges(ball.lbox, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'],
                                  pp['logk'])[1]
        _, save_z_dir = sim_dirs(config['zcv_params']['zcv_dir'], config['sim_params']['sim_name'],
                                 config['sim_params']['z_mock'])
        for rsd in spaces:
            fn = save_z_dir / (f'power{"_rsd" if rsd else ""}_tr{"_" + tag if tag else ""}'
                               f'_{ktag}.asdf')
            _check_kcut(fn, config['zcv_params']['kcut'])
            d = read_data(fn)
            assert np.allclose(k_binc, d['k_binc']), f'Mismatching file: {fn}'
            assert np.allclose(0.5 * (mu_edges[1:] + mu_edges[:-1]), d['mu_binc']), (
                f'Mismatching file: {fn}')
            zcv.tracer_spectra[(tag, rsd)] = d
    elif load_presaved:
        missing = [rsd for rsd in spaces if (tag, rsd) not in zcv.tracer_spectra]
        if missing:
            raise KeyError(f'load_presaved: zcv holds no tracer spectra of {tag or "the tracer"!r} '
                           f'with want_rsd {missing}')
    else:
        for rsd, pos in zip(spaces, (pos_rsd, pos_real)):
            fields = zcv.field_ffts[rsd]
            zcv.tracer_spectra[(tag, rsd)] = get_tracer_power(
                pos, rsd, config, fields, zcv.meta, device=next(iter(fields.values())).device,
                want_save=from_files, tracer_tag=tag)
    pk_rsd_tr_dict = zcv.tracer_spectra[(tag, want_rsd)]
    pk_tr_dict = zcv.tracer_spectra[(tag, False)] if want_rsd else None
    pk_ij_dict = zcv.pk_ij[False] if want_rsd else None
    return run_zcv(pk_rsd_tr_dict, zcv.pk_ij[want_rsd], pk_tr_dict, pk_ij_dict, config,
                   window=zcv.window, keff=zcv.keff, pk_ij_zenbu=zcv.templates[want_rsd],
                   lbox=zcv.meta['BoxSize'])


def apply_zcv_xi(ball, mock_dict, config, zcv=None, load_presaved=False):
    """Variance-reduced xi_ell(r) via field-level ZCV (apply.py:apply_zcv_xi).

    mock_dict holds one tracer, in redshift space; its real-space
    counterpart comes from ``ball.run_hod(ball.tracers, want_rsd=False)``.
    The tracer's Fourier field in both spaces (get_tracer_power,
    save_3D_power) goes into ``zcv.tracer_ffts``; load_presaved takes them
    from there instead (raises where they are missing). run_zcv_field
    reduces the 3-D power on the fields' device, and pk_to_xi turns the
    reduced cube and the tracer's raw RSD cube into xi_ell(r) at r_bins =
    0, 1, ..., 200. Returns run_zcv_field's dict with Xi_tr_tr_ell_zcv,
    Xi_tr_tr_ell, Np_tr_tr_ell and r_binc. zcv=None reads the products of
    zcv_dir (``ZCVProducts.from_dir(field_level=True)``); products from
    files write the tracer's fields (``tr_field{rsd}_fft_nmesh*``) and its
    cubes under tracer_dir and the reduced cube (``power{rsd}_ZCV_tr_nmesh*``)
    under zcv_dir, and load_presaved reads the fields back from zcv_dir."""
    assert config['HOD_params']['want_rsd'], 'want_rsd=False not implemented'
    assert len(mock_dict.keys()) == 1
    assert len(config['power_params']['poles']) <= 3
    assert config['power_params']['nbins_mu'] == 1
    if 'nmesh' not in config['power_params']:
        config['power_params']['nmesh'] = config['zcv_params']['nmesh']
    assert config['zcv_params']['nmesh'] == config['power_params']['nmesh']
    if zcv is None:
        zcv = ZCVProducts.from_dir(config, field_level=True, device=_device(ball))
    if not np.isclose(zcv.kcut, config['zcv_params']['kcut']):
        raise ValueError(f'the ZCV products were made with kcut {zcv.kcut}, not '
                         f'{config["zcv_params"]["kcut"]}')
    nmesh = config['zcv_params']['nmesh']
    from_files = zcv.config is not None
    if from_files:
        save_z_dir = sim_dirs(config['zcv_params']['zcv_dir'], config['sim_params']['sim_name'],
                              config['sim_params']['z_mock'])[1]
    k_bins, _ = get_k_mu_edges(ball.lbox, np.pi * nmesh / ball.lbox, nmesh // 2, 1, False)
    if len(zcv.k_binc) != nmesh // 2 or not np.allclose(zcv.k_binc, 0.5 * (k_bins[1:] + k_bins[:-1])):
        raise ValueError('apply_zcv_xi needs ZCV products of nmesh / 2 linear k bins to the '
                         'Nyquist k (the binning pk_to_xi needs)')

    if load_presaved and from_files:
        device = next(iter(zcv.field_ffts[True].values())).device
        for rsd in (True, False):
            zcv.tracer_ffts[rsd] = read_fft(
                save_z_dir / f'tr_field{"_rsd" if rsd else ""}_fft_nmesh{nmesh:d}.asdf',
                'tr_field_fft', device)
    elif load_presaved:
        missing = [rsd for rsd in (True, False) if rsd not in zcv.tracer_ffts]
        if missing:
            raise KeyError(f'load_presaved: zcv holds no tracer field with want_rsd {missing}')
    else:
        (tr,) = list(mock_dict)
        fields = zcv.field_ffts
        device = next(iter(fields[True].values())).device
        zcv.tracer_ffts[True] = get_tracer_power(
            _tracer_cols(mock_dict[tr]), True, config, fields[True], meta=zcv.meta,
            device=device, save_3D_power=True, want_save=from_files)
        # real-space repopulation of the same tracer for the bias fit
        mock_real = ball.run_hod(ball.tracers, want_rsd=False, reseed=None, write_to_disk=False)
        zcv.tracer_ffts[False] = get_tracer_power(
            _tracer_cols(mock_real[tr]), False, config, fields[False], meta=zcv.meta,
            device=device, save_3D_power=True, want_save=from_files)
        del mock_real

    cubes = {}
    zcv_dict = run_zcv_field(zcv.tracer_ffts, zcv.field_ffts, config,
                             pk_ij_zenbu=zcv.templates[True], meta=zcv.meta, out=cubes)

    if from_files:
        compress_asdf(save_z_dir / f'power_rsd_ZCV_tr_nmesh{nmesh:d}.asdf',
                      {'P_k3D_tr_tr_zcv': cubes['P_k3D_tr_tr_zcv']},
                      {'sim_name': config['sim_params']['sim_name'], 'Lbox': ball.lbox,
                       'nmesh': nmesh, 'kcut': config['zcv_params']['kcut']})
    r_bins = np.linspace(0.0, 200.0, 201)
    poles = config['power_params']['poles']
    r_binc, binned_poles_zcv, Npoles = pk_to_xi(cubes.pop('P_k3D_tr_tr_zcv'), ball.lbox, r_bins,
                                                poles=poles)
    tr_rsd = zcv.tracer_ffts[True]
    r_binc, binned_poles, Npoles = pk_to_xi(field_cube(tr_rsd, tr_rsd), ball.lbox, r_bins,
                                            poles=poles)
    zcv_dict['Xi_tr_tr_ell_zcv'] = binned_poles_zcv
    zcv_dict['Xi_tr_tr_ell'] = binned_poles
    zcv_dict['Np_tr_tr_ell'] = Npoles
    zcv_dict['r_binc'] = r_binc
    return zcv_dict
